"""xlstm-350m [ssm]: mLSTM (chunked matmul scan) + sLSTM (sequential — the
recurrence is non-associative; matmul-scan inapplicable, DESIGN.md §4) blocks,
3:1 ratio. [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ModelConfig, XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-350m", family="xlstm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=50304,
    xlstm=XLSTMConfig(slstm_every=4, n_heads=4, proj_factor=2.0, conv_kernel=4),
    rope=False, supports_long=True,
)

SMOKE = ModelConfig(
    name="xlstm-350m-smoke", family="xlstm",
    n_layers=4, d_model=64, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab_size=256,
    xlstm=XLSTMConfig(slstm_every=4, n_heads=4, proj_factor=2.0, conv_kernel=4),
    rope=False, supports_long=True, dtype="float32", remat=False,
)
