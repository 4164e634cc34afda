"""whisper-small [audio]: enc-dec, conv frontend stubbed as precomputed frame
embeddings (input_specs provides (B, enc_len, d) — DESIGN.md §4).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-small", family="encdec",
    n_layers=12, n_enc_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab_size=51865, head_dim=64,
    rope=False, act="gelu_nogate", enc_len=1500, tie_embeddings=True,
)

SMOKE = ModelConfig(
    name="whisper-small-smoke", family="encdec",
    n_layers=2, n_enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=128, vocab_size=256, head_dim=16,
    rope=False, act="gelu_nogate", enc_len=32, tie_embeddings=True, dtype="float32", remat=False,
)
