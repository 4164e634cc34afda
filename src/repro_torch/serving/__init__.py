"""Serving — the rectangular ``ServeEngine`` with the scan-based top-p sampler, and
continuous batching (``ContinuousEngine``) over the paged KV cache."""
from repro_torch.serving.engine import ServeEngine
from repro_torch.serving.paged_kv import PageAllocator
from repro_torch.serving.scheduler import (ContinuousEngine, Request, RequestState,
                                           poisson_trace)

__all__ = ["ServeEngine", "ContinuousEngine", "PageAllocator", "Request", "RequestState",
           "poisson_trace"]
