# Frozen copy of sigman_release_torch/utils/timing.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
"""Per-stage wall-clock spans for the inference path.

A ``StageTimer`` accumulates seconds per named stage; on CUDA it
synchronises the device at both ends of a span so the span holds the
stage's device work. ``NULL_TIMER`` is the default everywhere and costs
nothing.
"""

from __future__ import annotations

import contextlib
import time

import torch


class StageTimer:
    def __init__(self, device: torch.device):
        self.sync = torch.device(device).type == "cuda"
        self.seconds: dict[str, float] = {}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if self.sync:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                torch.cuda.synchronize()
            self.seconds[name] = (self.seconds.get(name, 0.0)
                                  + time.perf_counter() - t0)


@contextlib.contextmanager
def _null_span(name: str):
    yield


NULL_TIMER = _null_span
