"""qwen3-4b [dense]: GQA + per-head q/k RMSNorm. [hf:Qwen/Qwen3-8B; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-4b", family="decoder",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab_size=151936, qk_norm=True, rope_theta=1e6,
)

SMOKE = ModelConfig(
    name="qwen3-4b-smoke", family="decoder",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256, qk_norm=True, rope_theta=1e6, dtype="float32", remat=False,
)
