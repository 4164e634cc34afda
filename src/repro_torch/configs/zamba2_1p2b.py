"""zamba2-1.2b [hybrid]: Mamba2 backbone + one *shared* attention block applied
every 6 mamba layers (weights shared across invocations; per-invocation KV cache).
The Mamba2 mixer runs on the chunked matmul scan. [arXiv:2411.15242; hf]"""
from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    n_layers=38, d_model=2048, n_heads=32, n_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    ssm=SSMConfig(d_state=64, n_heads=64, head_dim=64, expand=2,
                  conv_kernel=4, chunk=128, n_groups=1),
    shared_attn_interval=6, supports_long=True,
)

SMOKE = ModelConfig(
    name="zamba2-1.2b-smoke", family="hybrid",
    n_layers=5, d_model=64, n_heads=4, n_kv_heads=4, head_dim=16,
    d_ff=128, vocab_size=256,
    ssm=SSMConfig(d_state=8, n_heads=8, head_dim=16, expand=2,
                  conv_kernel=4, chunk=16, n_groups=1),
    shared_attn_interval=2, supports_long=True, dtype="float32", remat=False,
)
