"""Step timing aggregation (port of the JAX package's ``StepTimer``).

``tick`` once per step; ``summary`` gives the mean, p50, p95 and rate over
the last ``window`` steps. On a CUDA device the caller synchronises before
``tick`` when the step's device work must be inside the interval.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np


class StepTimer:
    def __init__(self, window: int = 200):
        self.window = window
        self.samples: list[float] = []
        self._last: Optional[float] = None

    def tick(self) -> Optional[float]:
        """Call once per step; returns the last step's duration (s)."""
        now = time.perf_counter()
        dt = None
        if self._last is not None:
            dt = now - self._last
            self.samples.append(dt)
            if len(self.samples) > self.window:
                self.samples.pop(0)
        self._last = now
        return dt

    def summary(self) -> dict:
        if not self.samples:
            return {}
        arr = np.asarray(self.samples)
        return {
            "step_time_mean_s": float(arr.mean()),
            "step_time_p50_s": float(np.percentile(arr, 50)),
            "step_time_p95_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / max(arr.mean(), 1e-9)),
        }
