"""Model registry: architecture name -> config module -> model."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import TransformerLM

__all__ = ["ARCHS", "get_config", "build_model"]

# the architectures ported so far (the JAX package registers ten)
ARCHS = {
    "gemma2-2b": "repro_torch.configs.gemma2_2b",
    "qwen3-4b": "repro_torch.configs.qwen3_4b",
    "llama3-8b": "repro_torch.configs.llama3_8b",
    "zamba2-1.2b": "repro_torch.configs.zamba2_1p2b",
    "llama4-scout-17b-16e": "repro_torch.configs.llama4_scout_17b_16e",
    "deepseek-moe-16b": "repro_torch.configs.deepseek_moe_16b",
}


def get_config(arch: str, smoke: bool = False) -> ModelConfig:
    """The full config of ``arch``, or its reduced ``SMOKE`` config."""
    if arch not in ARCHS:
        raise ValueError(f"unknown or unported arch {arch!r}; ported: {list(ARCHS)}")
    mod = importlib.import_module(ARCHS[arch])
    return mod.SMOKE if smoke else mod.CONFIG


def build_model(cfg: ModelConfig) -> TransformerLM:
    return TransformerLM(cfg)
