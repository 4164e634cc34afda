"""Serving — the rectangular ``ServeEngine`` with the scan-based top-p sampler."""
from repro_torch.serving.engine import ServeEngine

__all__ = ["ServeEngine"]
