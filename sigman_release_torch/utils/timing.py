"""Named spans of the port's work: the ``timer=`` hooks of the trainers,
the inference pipeline, the sampler and the models.

``StageTimer(device)`` accumulates seconds per named span. Every span
opens ``torch.profiler.record_function(f"span:{name}")``, so the spans
appear in any ``torch.profiler`` window (``trace_if`` traces, the
benchmark's) on the same clock as the kernels, and ``counts[name]`` says
how often each span was entered. Two modes:

* ``sync=True`` (default): on CUDA a span opened while no other span is
  open synchronises the device at both ends and is timed on the host
  clock, so it holds its stage's device work. A nested span is timed on
  the device clock (a CUDA event pair on the current stream) and adds no
  synchronise.
* ``sync=False``: every span is a CUDA event pair on the current stream
  and nothing synchronises; ``seconds`` resolves the pairs when it is
  read, waiting for the last recorded event (a timer's spans are to be
  opened on one stream).

Events come from a pool that is reused once their pairs are resolved. On
a device that is not CUDA both modes time every span with
``time.perf_counter``. ``NULL_TIMER`` is the default everywhere: it
returns one shared ``contextlib.nullcontext`` and records nothing.
"""

from __future__ import annotations

import contextlib
import time

import torch


class StageTimer:
    def __init__(self, device: torch.device, sync: bool = True):
        self.cuda = torch.device(device).type == "cuda"
        self.sync = sync
        self.counts: dict[str, int] = {}
        self._seconds: dict[str, float] = {}
        self._pending: list = []     # (name, start event, end event)
        self._pool: list = []
        self._depth = 0

    @property
    def seconds(self) -> dict[str, float]:
        """Seconds per span name, the recorded device spans resolved."""
        self._resolve()
        return self._seconds

    def _add(self, name: str, secs: float):
        self._seconds[name] = self._seconds.get(name, 0.0) + secs

    def _resolve(self):
        if not self._pending:
            return
        self._pending[-1][2].synchronize()   # the earlier ones are done
        for name, start, end in self._pending:
            self._add(name, start.elapsed_time(end) / 1e3)
            self._pool.append((start, end))
        self._pending.clear()

    def _events(self):
        if self._pool:
            return self._pool.pop()
        return (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))

    @contextlib.contextmanager
    def __call__(self, name: str):
        self.counts[name] = self.counts.get(name, 0) + 1
        drain = self.cuda and self.sync and self._depth == 0
        self._depth += 1
        try:
            with torch.profiler.record_function(f"span:{name}"):
                if self.cuda and not drain:
                    start, end = self._events()
                    start.record()
                    try:
                        yield
                    finally:
                        end.record()
                        self._pending.append((name, start, end))
                    return
                if drain:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                try:
                    yield
                finally:
                    if drain:
                        torch.cuda.synchronize()
                    self._add(name, time.perf_counter() - t0)
                    if drain:
                        self._resolve()      # the device is drained: free
        finally:
            self._depth -= 1


_NULL_SPAN = contextlib.nullcontext()


def NULL_TIMER(name: str) -> contextlib.nullcontext:
    return _NULL_SPAN
