"""Step tracing and timing (port of the JAX package's ``utils/profiling``).

    with trace_if("/tmp/trace", step, every=500):
        logs = trainer.train_step_g(batch)

writes a TensorBoard-readable trace (``*.pt.trace.json``, one file per rank
and traced step) of every ``every``-th step, and ``StepTimer`` keeps the
step latency with percentile summaries: ``tick`` once per step;
``summary`` gives the mean, p50, p95 and rate over the last ``window``
steps. On a CUDA device the caller synchronises before ``tick`` when the
step's device work must be inside the interval. Batches drawn through
``StepTimer.timed`` add the host's wait for the loader: its mean per step
and its share of the step time.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import numpy as np
import torch


def traced(step: int, every: int) -> bool:
    """Whether ``trace_if`` traces ``step``: every ``every``-th, not 0."""
    return every > 0 and step % every == 0 and step > 0


@contextlib.contextmanager
def trace_if(logdir: Optional[str], step: int, every: int = 500,
             enabled: bool = True):
    """Trace the enclosed step with ``torch.profiler`` (host operators and,
    with a card, its kernels) on the steps where ``traced(step, every)``;
    the trace goes to ``logdir`` as ``rank<r>.<ns>.pt.trace.json``. The
    device is synchronised before the trace closes, so it holds the
    step's kernels (the JAX package blocks on the new state there)."""
    if not (enabled and logdir and traced(step, every)):
        yield
        return
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    rank = (torch.distributed.get_rank()
            if torch.distributed.is_initialized() else 0)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    handler = tensorboard_trace_handler(logdir, worker_name=f"rank{rank}")
    with profile(activities=activities, on_trace_ready=handler):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


class StepTimer:
    def __init__(self, window: int = 200):
        self.window = window
        self.samples: list[float] = []
        self.waits: list[float] = []
        self._last: Optional[float] = None

    def timed(self, batches):
        """Yield from ``batches``, keeping the host's time blocked in each
        ``next()`` (the wait for the loader) for ``summary``."""
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            try:
                batch = next(it)
            except StopIteration:
                return
            self.waits.append(time.perf_counter() - t0)
            if len(self.waits) > self.window:
                self.waits.pop(0)
            yield batch

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
        out = {
            "step_time_mean_s": float(arr.mean()),
            "step_time_p50_s": float(np.percentile(arr, 50)),
            "step_time_p95_s": float(np.percentile(arr, 95)),
            "steps_per_s": float(1.0 / max(arr.mean(), 1e-9)),
        }
        if self.waits:
            waits = self.waits[-len(self.samples):]
            out["data_wait_mean_s"] = float(np.mean(waits))
            out["data_wait_share"] = float(sum(waits)
                                           / max(arr[-len(waits):].sum(),
                                                 1e-9))
        return out
