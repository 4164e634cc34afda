"""Config system: the ``ModelConfig`` dataclass and the input shapes.

The port's own copy of ``repro/configs/base.py`` (that module imports
``jax.numpy``).  The fields and defaults are the same, so a config reads the
same in both packages; the port builds every family of the ten configs.
``ShapeConfig`` names an input shape for ``models.model.input_specs``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_scale: Optional[float] = None


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int
    n_heads: int
    head_dim: int
    expand: int = 2
    conv_kernel: int = 4
    chunk: int = 128
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    slstm_every: int = 4
    n_heads: int = 4
    proj_factor: float = 2.0
    conv_kernel: int = 4


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # decoder | encdec | moe | hybrid | xlstm | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None
    qk_norm: bool = False
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    local_window: Optional[int] = None
    layer_pattern: Optional[Tuple[str, ...]] = None
    rope_theta: float = 10000.0
    rope: bool = True
    tie_embeddings: bool = False
    act: str = "silu"
    norm_eps: float = 1e-6
    scale_embed: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    shared_attn_interval: Optional[int] = None
    n_enc_layers: int = 0
    enc_len: int = 1500
    n_img_tokens: int = 0
    dtype: str = "bfloat16"
    remat: bool = True
    scan_layers: bool = True
    scan_method: str = "auto"
    supports_long: bool = False

    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def padded_vocab(self) -> int:
        """Embedding rows padded to a multiple of 256 (padded logits masked)."""
        return ((self.vocab_size + 255) // 256) * 256


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # "train" | "prefill" | "decode"
