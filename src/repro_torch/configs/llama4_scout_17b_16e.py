"""llama4-scout-17b-16e [moe]: 16 experts, top-1 routing + shared expert; text
backbone (early-fusion frontend out of scope per assignment). MoE dispatch offsets
come from the paper's int8 mask scan. [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]"""
from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab_size=202048, rope_theta=500000.0,
    moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192, n_shared=1),
)

SMOKE = ModelConfig(
    name="llama4-scout-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, rope_theta=500000.0,
    moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128, n_shared=1,
                  capacity_factor=16.0),
    dtype="float32", remat=False,
)
