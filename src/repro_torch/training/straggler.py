"""Straggler detection and the policy hook a launcher consumes.

Port of ``repro/training/straggler.py`` (plain Python, the same logic): the
monitor keeps an EWMA and EWVAR of each worker's step times and flags a
worker after ``consecutive`` outliers above ``mean + z·std``; outliers are not
absorbed into the baseline, so a degrading worker builds a streak.  The
trainer feeds it its step times as worker 0.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional

__all__ = ["StragglerConfig", "StragglerMonitor"]


@dataclasses.dataclass
class StragglerConfig:
    alpha: float = 0.1            # EWMA smoothing
    z_threshold: float = 4.0      # flag if step_time > mean + z*std
    min_samples: int = 16
    consecutive: int = 3          # require N consecutive outliers


class StragglerMonitor:
    def __init__(self, cfg: StragglerConfig = StragglerConfig(),
                 on_straggler: Optional[Callable[[int, float], None]] = None):
        self.cfg = cfg
        self.mean: Dict[int, float] = {}
        self.var: Dict[int, float] = {}
        self.count: Dict[int, int] = {}
        self.streak: Dict[int, int] = {}
        self.flagged: List[int] = []
        self.on_straggler = on_straggler

    def record(self, worker: int, step_time: float) -> bool:
        """Record a step time; True when ``worker`` is newly flagged.

        Example:
            >>> mon = StragglerMonitor(StragglerConfig(min_samples=2, consecutive=1))
            >>> [mon.record(0, t) for t in (1.0, 1.0, 9.0)]
            [False, False, True]
        """
        c = self.count.get(worker, 0)
        is_outlier = False
        if c >= self.cfg.min_samples:
            std = math.sqrt(max(self.var[worker], 1e-12))
            is_outlier = step_time > self.mean[worker] + self.cfg.z_threshold * std
        if c == 0:
            self.mean[worker] = step_time
            self.var[worker] = 0.0
        elif not is_outlier:
            a = self.cfg.alpha
            d = step_time - self.mean[worker]
            self.mean[worker] += a * d
            self.var[worker] = (1 - a) * (self.var[worker] + a * d * d)
        self.count[worker] = c + 1
        if c + 1 < self.cfg.min_samples:
            return False
        self.streak[worker] = self.streak.get(worker, 0) + 1 if is_outlier else 0
        if self.streak[worker] >= self.cfg.consecutive and worker not in self.flagged:
            self.flagged.append(worker)
            if self.on_straggler:
                self.on_straggler(worker, step_time)
            return True
        return False

    def healthy_workers(self, all_workers: List[int]) -> List[int]:
        return [w for w in all_workers if w not in self.flagged]
