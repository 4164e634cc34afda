"""gemma2-2b [dense]: local+global alternating attention, logit softcaps,
sandwich norms, tied embeddings. [arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-2b", family="decoder",
    n_layers=26, d_model=2304, n_heads=8, n_kv_heads=4, head_dim=256,
    d_ff=9216, vocab_size=256000,
    layer_pattern=("local", "global"), local_window=4096,
    attn_softcap=50.0, final_softcap=30.0, scale_embed=True,
    tie_embeddings=True, act="gelu",
)

SMOKE = ModelConfig(
    name="gemma2-2b-smoke", family="decoder",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
    d_ff=128, vocab_size=256,
    layer_pattern=("local", "global"), local_window=16,
    attn_softcap=50.0, final_softcap=30.0, scale_embed=True,
    tie_embeddings=True, act="gelu", dtype="float32", remat=False,
)
