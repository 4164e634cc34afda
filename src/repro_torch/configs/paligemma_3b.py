"""paligemma-3b [vlm]: SigLIP frontend stubbed as precomputed patch embeddings
(input_specs provides (B, 256, d)); gemma MQA backbone with prefix-LM attention
over the image tokens. [arXiv:2407.07726; hf]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="paligemma-3b", family="vlm",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=257216, act="gelu", scale_embed=True,
    tie_embeddings=True, n_img_tokens=256,
)

SMOKE = ModelConfig(
    name="paligemma-3b-smoke", family="vlm",
    n_layers=2, d_model=64, n_heads=4, n_kv_heads=1, head_dim=16,
    d_ff=128, vocab_size=256, act="gelu", scale_embed=True,
    tie_embeddings=True, n_img_tokens=8, dtype="float32", remat=False,
)
