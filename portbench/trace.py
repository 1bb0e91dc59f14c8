"""The traced run's readings: a ``torch.profiler`` window summarised in
memory (no trace file), the port's ``StageTimer`` spans, and what the
per-layer readers read from them.

``busy_us`` is a frozen copy of ``_busy_us`` of
``sigman_release_torch/training/profile_step.py`` at commit a519890.
"""

from __future__ import annotations

import bisect
import time
from typing import Dict, List, Optional, Tuple

import torch

# H100 SXM data sheet, dense bf16 on the tensor cores
PEAK_BF16_FLOPS = 989e12
TOP = 10
# the longest idle gaps named by the host operation beside them
NAMED_GAPS = 300


def busy_us(kernels, lo=float("-inf"), hi=float("inf")) -> float:
    """Length of the union of the sorted [start, end) kernel intervals,
    clipped to [lo, hi)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in kernels:
        s, e = max(s, lo), min(e, hi)
        if s >= e:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(kernels, lo: float, hi: float) -> List[Tuple[float, float]]:
    """The idle intervals of [lo, hi) between the sorted kernels."""
    out, at = [], lo
    for s, e in kernels:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def host_activity(cpu_events, starts, gap, reach: int = 20000) -> str:
    """The host operation running at the middle of a gap: of those that
    cover it, the one that started last (the innermost)."""
    mid = 0.5 * (gap[0] + gap[1])
    i = bisect.bisect_right(starts, mid) - 1
    for j in range(i, max(i - reach, -1), -1):
        s, e, name = cpu_events[j]
        if e >= mid:
            return name
    return "no host operation"


class Summary:
    """What the readers read: ``spans`` (ms per unit of work), ``kernels``
    ({name: (seconds, launches)} in the profiler window), ``busy_s`` and
    ``window_s`` (of the profiler window), ``units`` and ``clean_s`` (a
    window with nothing on), ``flops_per_unit``, ``bounds_s`` ({kernel key:
    least seconds of its launches in the profiler window}),
    ``breakdown``."""

    def __init__(self):
        self.spans: Dict[str, float] = {}
        self.kernels: Dict[str, Tuple[float, int]] = {}
        self.busy_s = self.window_s = self.clean_s = 0.0
        self.units = self.profiled_units = 0
        self.flops_per_unit: Optional[float] = None
        self.bounds_s: Dict[str, float] = {}
        self.breakdown: Dict[str, list] = {}

    # -- helpers for the readers; None where there is nothing to read
    def span_ms(self, *names: str) -> Optional[float]:
        vals = [self.spans[n] for n in names if n in self.spans]
        return sum(vals) if len(vals) == len(names) else None

    def kernel_s(self, key: str) -> Tuple[float, int]:
        secs = launches = 0
        for name, (s, n) in self.kernels.items():
            if key in name:
                secs += s
                launches += n
        return secs, launches

    def roofline(self, key: str) -> Optional[float]:
        secs, launches = self.kernel_s(key)
        bound = self.bounds_s.get(key)
        if not launches or not bound or secs <= 0:
            return None
        return 100.0 * bound / secs

    def mfu(self) -> Optional[float]:
        if not self.flops_per_unit or self.clean_s <= 0 or not self.units:
            return None
        return (100.0 * self.flops_per_unit * self.units
                / (self.clean_s * PEAK_BF16_FLOPS))

    def idle(self) -> Optional[float]:
        """The device's idle share of an untraced unit: 1 - the profiled
        units' busy time per unit over the untraced units' time per unit
        (the profiler's own host work stretches its window, not the
        device's work)."""
        if (self.busy_s <= 0 or not self.profiled_units or not self.units
                or self.clean_s <= 0):
            return None
        busy = self.busy_s / self.profiled_units
        return 100.0 * (1.0 - busy / (self.clean_s / self.units))


def _profiled(unit, n_units: int, activities):
    """Run ``n_units`` units under the profiler: (window s, units, kernel
    events, host events), times in us."""
    from torch.profiler import profile

    torch.cuda.synchronize()
    with profile(activities=activities) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        units = sum(unit() for _ in range(n_units))
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    cuda = torch.autograd.DeviceType.CUDA
    kern, cpu = [], []
    for e in prof.events():
        tr = e.time_range
        (kern if e.device_type == cuda else cpu).append(
            (tr.start, tr.end, e.name))
    kern.sort()
    cpu.sort()
    return window, units, kern, cpu


def clean_window(summary: Summary, unit, n_units: int):
    """Time ``n_units`` units with nothing on (the mfu's time)."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary.units = sum(unit() for _ in range(n_units))
    torch.cuda.synchronize()
    summary.clean_s = time.perf_counter() - t0


def profile_window(summary: Summary, unit, n_units: int):
    """``n_units`` units under the profiler tracing the device alone (the
    host's operations unrecorded, so the host runs as in an untraced run):
    busy and window seconds, the kernels' times, the top device
    operations."""
    from torch.profiler import ProfilerActivity

    window, units, kern, _ = _profiled(unit, n_units,
                                       [ProfilerActivity.CUDA])
    summary.window_s, summary.profiled_units = window, units
    if not kern:
        return summary
    lo = kern[0][0]
    summary.busy_s = busy_us([(s, e) for s, e, _ in kern], lo,
                             lo + window * 1e6) / 1e6
    by_name: Dict[str, list] = {}
    for s, e, name in kern:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += (e - s) / 1e6
        acc[1] += 1
    summary.kernels = {n: (v[0], v[1]) for n, v in by_name.items()}
    summary.breakdown["device_ops"] = sorted(
        ([n, v[0]] for n, v in by_name.items()), key=lambda x: -x[1])[:TOP]
    return summary


def host_window(summary: Summary, unit, n_units: int = 1):
    """One unit under the profiler tracing host and device: the device's
    idle time by the host operation running beside each gap (the host
    tracing slows the host, so only the breakdown reads it)."""
    from torch.profiler import ProfilerActivity

    window, _, kern, cpu = _profiled(
        unit, n_units, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    if not kern:
        return summary
    lo = min(cpu[0][0], kern[0][0]) if cpu else kern[0][0]
    spans = [(s, e) for s, e, _ in kern]
    starts = [s for s, _, _ in cpu]
    idle: Dict[str, float] = {}
    found = sorted(gaps(spans, lo, lo + window * 1e6),
                   key=lambda g: g[0] - g[1])
    for k, g in enumerate(found):
        what = (host_activity(cpu, starts, g) if k < NAMED_GAPS
                else "shorter gaps")
        idle[what] = idle.get(what, 0.0) + (g[1] - g[0]) / 1e6
    summary.breakdown["idle_gaps"] = sorted(
        ([n, s] for n, s in idle.items()), key=lambda x: -x[1])[:TOP]
    return summary


def span_window(summary: Summary, unit, n_units: int, device):
    """Run ``n_units`` units with the port's ``StageTimer`` (it synchronises
    at both ends of every span) and keep each span's ms per unit."""
    from sigman_release_torch.utils.timing import StageTimer

    timer = StageTimer(device)
    units = 0
    for _ in range(n_units):
        units += unit(timer=timer)
    summary.spans = {n: 1e3 * s / n_units for n, s in timer.seconds.items()}
    return summary
