"""deepseek-moe-16b [moe]: fine-grained 64 routed experts top-6 + 2 shared experts,
first layer dense. [arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16, head_dim=128,
    d_ff=10944,                       # the single dense layer
    vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, d_ff_expert=1408, n_shared=2,
                  first_k_dense=1),
)

SMOKE = ModelConfig(
    name="deepseek-moe-smoke", family="moe",
    n_layers=3, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=256, vocab_size=256,
    moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=32, n_shared=2,
                  first_k_dense=1, capacity_factor=16.0),
    dtype="float32", remat=False,
)
