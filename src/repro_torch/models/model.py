"""Model registry: architecture name -> config module -> model, and the input specs."""
from __future__ import annotations

import importlib
from typing import Dict

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models.transformer import _DTYPES, TransformerLM

__all__ = ["ARCHS", "get_config", "build_model", "cell_supported", "input_specs",
           "synth_batch"]

# the JAX package's ten architectures, all ported
ARCHS = {
    "whisper-small": "repro_torch.configs.whisper_small",
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "minicpm3-4b": "repro_torch.configs.minicpm3_4b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "paligemma-3b": "repro_torch.configs.paligemma_3b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "llama4-scout-17b-16e": "repro_torch.configs.llama4_scout_17b_16e",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
    "xlstm-350m": "repro_torch.configs.xlstm_350m",
}

def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    """The full config of ``arch``, or its reduced ``SMOKE`` config."""
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; known: {list(ARCHS)}")
    mod = importlib.import_module(ARCHS[arch])
    return mod.SMOKE if smoke else mod.CONFIG


def build_model(cfg: ModelConfig) -> TransformerLM:
    return TransformerLM(cfg)


def cell_supported(cfg: ModelConfig, shape: ShapeConfig) -> tuple:
    """Whether this (arch × shape) cell runs, and the reason when it is skipped
    (JAX's ``cell_supported``, word for word)."""
    if shape.name == "long_500k" and not cfg.supports_long:
        return False, "long_500k skipped: pure full-attention arch (quadratic)"
    return True, ""


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Every model input of this (config, shape) cell as a ``"meta"`` tensor of
    its shape and dtype: ``tokens`` (a VLM's text is ``seq_len - n_img_tokens``
    long), and the stub ``img_embed`` (VLM) or ``enc_embed`` (enc-dec) in the
    config's dtype.  A decode shape takes one token a row."""
    b, s = shape.global_batch, shape.seq_len

    def spec(*dims, dtype=torch.int32):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        return {"tokens": spec(b, 1)}
    cdt = _DTYPES[cfg.dtype]
    specs = {"tokens": spec(b, s - (cfg.n_img_tokens if cfg.family == "vlm" else 0))}
    if cfg.family == "vlm":
        specs["img_embed"] = spec(b, cfg.n_img_tokens, cfg.d_model, dtype=cdt)
    if cfg.family == "encdec":
        specs["enc_embed"] = spec(b, cfg.enc_len, cfg.d_model, dtype=cdt)
    return specs


def synth_batch(cfg: ModelConfig, shape: ShapeConfig,
                gen: torch.Generator) -> Dict[str, torch.Tensor]:
    """A random batch of :func:`input_specs`, drawn from ``gen`` on its device:
    tokens uniform below ``min(vocab_size, 1000)``, embeddings ``N(0, 0.3²)``."""
    out = {}
    for name, sp in input_specs(cfg, shape).items():
        if sp.dtype == torch.int32:
            out[name] = torch.randint(0, min(cfg.vocab_size, 1000), tuple(sp.shape),
                                      generator=gen, device=gen.device,
                                      dtype=torch.int32)
        else:
            out[name] = (torch.randn(tuple(sp.shape), generator=gen, device=gen.device)
                         * 0.3).to(sp.dtype)
    return out
