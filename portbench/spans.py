"""The port's spans on the device clock, the device's idle time by span,
and what the spans cost: readings beside ``portbench/trace.py`` that use
``StageTimer(device, sync=False)``, which never synchronises.

    python3 -m portbench.spans --workload <name> --seed <n> [--cost_units 5]

builds the cell as ``portbench/run.py`` does, then runs ``span_units``
units with the device-clock timer (``device_span_window``), ``cost_units``
pairs of units without a timer and with one, in turn (each timed on the
host clock, the device drained at both ends; the timer's ``seconds`` read
after the unit and timed apart), and one unit with the timer
under a CPU + CUDA profiler (``span_idle_window``). The last line of
standard output is one JSON object: ms per unit of each span, the spans'
entries per unit, the median unit with and without the timer, the idle
time by span and, in a serving cell, the share of "dit_sampling" that the
sampler's and the DiT's spans cover. No reference runs and nothing is
judged.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from typing import Dict, Optional

import torch

from portbench import trace

# the spans inside "dit_sampling" that hold its work between them
SAMPLING_PARTS = ("dit_embed", "dit_adaln", "dit_attention", "dit_ff",
                  "ddim_update")


class SpanSummary(trace.Summary):
    """``trace.Summary`` with ``device_spans`` (device ms per unit) and
    ``span_counts`` (entries per unit)."""

    def __init__(self):
        super().__init__()
        self.device_spans: Dict[str, float] = {}
        self.span_counts: Dict[str, float] = {}

    def device_span_ms(self, *names: str) -> Optional[float]:
        vals = [self.device_spans[n] for n in names if n in self.device_spans]
        return sum(vals) if len(vals) == len(names) else None


def device_span_window(summary: SpanSummary, unit, n_units: int, device):
    """Run ``n_units`` units with ``StageTimer(device, sync=False)`` and no
    profiler; keep each span's device ms and entries per unit."""
    from sigman_release_torch.utils.timing import StageTimer

    timer = StageTimer(device, sync=False)
    for _ in range(n_units):
        unit(timer=timer)
    summary.device_spans = {n: 1e3 * s / n_units
                            for n, s in timer.seconds.items()}
    summary.span_counts = {n: c / n_units for n, c in timer.counts.items()}
    return summary


def innermost(spans, points):
    """For each of the sorted ``points``, the name of the innermost of the
    properly nested ``spans`` ((start, end, name), sorted by start) that
    covers it, or None."""
    out, stack, i = [], [], 0
    for p in points:
        while i < len(spans) and spans[i][0] <= p:
            while stack and stack[-1][1] < spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] < p:
            stack.pop()
        out.append(stack[-1][2] if stack else None)
    return out


def span_idle_window(summary: SpanSummary, unit, device):
    """One unit with ``StageTimer(device, sync=False)`` under a profiler
    tracing host and device: each idle gap of the device is charged to the
    innermost ``span:`` range open on the host at the gap's middle, or to
    "outside spans"; the top ``trace.TOP`` go to
    ``breakdown["idle_by_span"]`` as [name, seconds]. The host tracing
    slows the host and so stretches the gaps, as it does for
    ``trace.host_window``'s ``idle_gaps``: read the shares, not the
    seconds."""
    from torch.profiler import ProfilerActivity

    from sigman_release_torch.utils.timing import StageTimer

    timer = StageTimer(device, sync=False)
    window, _, kern, cpu = trace._profiled(
        lambda: unit(timer=timer), 1,
        [ProfilerActivity.CPU, ProfilerActivity.CUDA])
    # the profiler mirrors each record_function range on the device's
    # timeline as an annotation, which would cover the gaps inside it
    kern = [k for k in kern if not k[2].startswith("span:")]
    if not kern:
        return summary
    lo = min(cpu[0][0], kern[0][0]) if cpu else kern[0][0]
    found = trace.gaps([(s, e) for s, e, _ in kern], lo, lo + window * 1e6)
    spans = [(s, e, n[len("span:"):]) for s, e, n in cpu
             if n.startswith("span:")]
    idle: Dict[str, float] = {}
    for g, name in zip(found, innermost(spans, [0.5 * (s + e)
                                                for s, e in found])):
        name = name or "outside spans"
        idle[name] = idle.get(name, 0.0) + (g[1] - g[0]) / 1e6
    summary.breakdown["idle_by_span"] = sorted(
        ([n, s] for n, s in idle.items()), key=lambda x: -x[1])[:trace.TOP]
    return summary


def unit_costs(unit, n_pairs: int, device):
    """Host seconds of ``n_pairs`` units without a timer and as many with
    ``StageTimer(device, sync=False)``, in turn, the device drained at both
    ends of each; and, apart, the seconds each timed unit's ``seconds``
    took to read after it."""
    from sigman_release_torch.utils.timing import NULL_TIMER, StageTimer

    times = {"null": [], "timed": [], "read": []}
    for _ in range(n_pairs):
        for kind in ("null", "timed"):
            timer = (NULL_TIMER if kind == "null"
                     else StageTimer(device, sync=False))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            unit(timer=timer)
            torch.cuda.synchronize()
            times[kind].append(time.perf_counter() - t0)
            if kind == "timed":
                t0 = time.perf_counter()
                timer.seconds
                times["read"].append(time.perf_counter() - t0)
    return times


def main(argv=None) -> int:
    from portbench import run as R

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--cost_units", type=int, default=5)
    args = ap.parse_args(argv)
    R.setup_environment()
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("portbench.spans: needs a CUDA device", file=sys.stderr)
        return 2
    log = lambda *a: print(*a, file=sys.stderr, flush=True)  # noqa: E731
    manifest = R.load_json("BENCHMARK.json")
    files = R.cell_files(manifest, args.workload)
    conf = R.load_json(files["config"]["file"])
    traffic = R.load_json("portbench", "traffic",
                          f"{files['workload']['traffic']}.json")
    dev = torch.device("cuda")
    driver = R.load_file(os.path.join(
        R.root_dir(), "portbench", "drivers",
        f"{conf['family']}_{traffic['mode']}.py"),
        f"portbench_driver_{conf['family']}_{traffic['mode']}")
    from portbench.reference import config as ref_config
    from sigman_release_torch.config import Config

    cell = driver.Cell(R.make_config(Config, conf["config"]),
                       R.make_config(ref_config.Config, conf["config"]),
                       conf, traffic, args.seed, dev, log)
    summary = SpanSummary()
    device_span_window(summary, cell.unit, traffic["span_units"], dev)
    costs = unit_costs(cell.unit, args.cost_units, dev)
    span_idle_window(summary, cell.unit, dev)
    null = statistics.median(costs["null"])
    timed = statistics.median(costs["timed"])
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "device_span_ms": summary.device_spans,
           "span_counts": summary.span_counts,
           "unit_s": costs, "median_null_s": null, "median_timed_s": timed,
           "on_cost_pct": 100.0 * (timed - null) / null,
           "median_read_s": statistics.median(costs["read"]),
           "idle_by_span": summary.breakdown.get("idle_by_span", [])}
    whole = summary.device_span_ms("dit_sampling")
    parts = summary.device_span_ms(*SAMPLING_PARTS)
    if whole and parts is not None:
        out["sampling_parts_ms"] = parts
        out["sampling_parts_share_pct"] = 100.0 * parts / whole
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
