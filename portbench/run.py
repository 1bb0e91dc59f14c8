"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's configuration, traffic mix, limits
and metrics are found by name from ``BENCHMARK.json``:
``portbench/configs/<config>.json``, ``portbench/traffic/<traffic>.json``,
``portbench/limits/<workload>.json``, ``portbench/endtoend/<metric>.py``,
``portbench/metrics/<metric>.py``; the configuration's ``family`` and the
mix's ``mode`` name the driver, ``portbench/drivers/<family>_<mode>.py``.

A run: set-up (inputs and weights from the seed, the program's objects,
its first steps or requests, which the reference follows), then the
measured window of ``--seconds`` (``--trace 0``; end-to-end metrics) or the
traced units (``--trace 1``; units with the port's spans, untraced units,
a profiler window summarised in memory, then the per-layer metrics), then
the reference, after
the program's state is freed, and the verdict. The last line of standard
output is one JSON object; the numbers compared and their limits close
standard error.

``--control lower`` runs no program: the reference in the configuration's
precision against the reference one precision step below it, on the same
inputs, and prints the numbers that decide ``correct`` (the control's
readings); ``--control half`` likewise against the reference with half of
each batch left out (a training cell's planted fault).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "sigman_release_tpu")


def root_dir() -> str:
    return os.getcwd()


def load_json(*parts):
    with open(os.path.join(root_dir(), *parts)) as f:
        return json.load(f)


def load_file(path: str, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def cell_files(manifest: dict, workload: str) -> dict:
    """Everything one cell is made of, by name."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; one of "
                         f"{sorted(cells)}")
    w = cells[workload]
    conf = next(c for c in manifest["configs"] if c["name"] == w["config"])

    def ours(metrics):
        return [m for m in metrics
                if workload in m.get("workloads", [workload])]

    return {"workload": w, "config": conf,
            "end_to_end": ours(manifest["end_to_end"]),
            "per_layer": ours(manifest["per_layer"])}


def make_config(cls, fields: dict):
    """A ``Config`` of the program or of the reference from the file's
    fields (JSON lists back to tuples)."""
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in fields.items()})


class Run:
    """What the end-to-end readers read."""

    def __init__(self):
        self.units = 0
        self.window_s = 0.0
        self.peak_bytes = 0
        self.setup_s = 0.0


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device: str = "cuda", control=None, conf_override=None,
        traffic_override=None, log=None) -> dict:
    """One run; returns the result object (also used by the tests, on the
    CPU, with small overrides)."""
    import torch

    from portbench import trace as tracing
    from portbench.judge import load_limits, verdict
    from portbench.reference import config as ref_config

    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    manifest = load_json("BENCHMARK.json")
    files = cell_files(manifest, workload)
    conf = conf_override or load_json(files["config"]["file"])
    traffic = traffic_override or load_json(
        "portbench", "traffic", f"{files['workload']['traffic']}.json")
    limits = load_limits(root_dir(), workload)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    driver = load_file(os.path.join(
        root_dir(), "portbench", "drivers",
        f"{conf['family']}_{traffic['mode']}.py"),
        f"portbench_driver_{conf['family']}_{traffic['mode']}")
    ref_cfg = make_config(ref_config.Config, conf["config"])

    if control:
        numbers = driver.control(ref_cfg, conf, traffic, seed, dev, log,
                                 fault=control)
        ok, compared = verdict(numbers, limits)
        return {"control": control, "correct": ok, "compared": compared}

    from sigman_release_torch.config import Config

    cfg = make_config(Config, conf["config"])
    cell = driver.Cell(cfg, ref_cfg, conf, traffic, seed, dev, log)
    if cuda:
        torch.cuda.synchronize()
    r = Run()
    r.setup_s = time.perf_counter() - T_START
    summary = None
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    if not trace:
        t0 = time.perf_counter()
        while True:
            r.units += cell.unit()
            r.window_s = time.perf_counter() - t0
            if r.window_s >= seconds:
                break
    else:
        summary = tracing.Summary()
        n = traffic["profile_units"]
        # the spans' units warm the pool the set-up emptied; the untraced
        # units run before the profiler, which leaves the host slower
        tracing.span_window(summary, cell.unit, traffic["span_units"], dev)
        if cuda:
            tracing.clean_window(summary, cell.unit, n)
        cell.capture(True)
        if cuda:
            tracing.profile_window(summary, cell.unit, n)
        else:
            summary.units = sum(cell.unit() for _ in range(n))
        cell.capture(False)
        if cuda:
            tracing.host_window(summary, cell.unit)
        summary.bounds_s = cell.bounds_s()
        summary.flops_per_unit = cell.flops_per_unit()
    r.peak_bytes = torch.cuda.max_memory_allocated() if cuda else 0
    found = forbidden_modules()

    numbers = cell.judge()
    ok, compared = verdict(numbers, limits)
    if found:
        ok = False
    metrics = {}
    if not trace:
        for m in files["end_to_end"]:
            reader = load_file(os.path.join(root_dir(), "portbench",
                                            "endtoend", f"{m['name']}.py"),
                               f"portbench_e2e_{m['name']}")
            metrics[m["name"]] = {"value": reader.read(r), "unit": m["unit"]}
    else:
        for m in files["per_layer"]:
            reader = load_file(os.path.join(root_dir(), "portbench",
                                            "metrics", f"{m['name']}.py"),
                               f"portbench_metric_{m['name']}")
            value = reader.read(summary)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(ok), "attempted": cell.attempted,
              "failed": 0 if ok else 1, "metrics": metrics,
              "device": device_info(r.peak_bytes, cuda)}
    if trace and summary is not None:
        result["device"]["busy_s"] = summary.busy_s
        result["device"]["window_s"] = summary.window_s
        if summary.breakdown:
            result["breakdown"] = summary.breakdown
    if found:
        result["forbidden_modules"] = found
    result["compared"] = compared
    return result


def device_info(peak_bytes: int, cuda: bool) -> dict:
    import torch

    if not cuda:
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}


def setup_environment():
    """Caches inside the checkout, at fixed paths; no JAX through
    ``transformers``."""
    base = os.path.join(root_dir(), "build", "portbench_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton")):
        os.environ.setdefault(var, os.path.join(base, sub))
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")
    # one launching thread; no CPU pool spinning beside it
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    # the training cells peak at 64-65 GiB of the card's 79 GiB: without
    # expandable segments a fixed-segment pool fragmented (26-28 GiB
    # reserved but free) and a vae_b step at B = 8 ran out of memory
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("lower", "half"), default=None,
                    help="no program: the reference against itself one "
                    "precision step lower, or with half of each batch left "
                    "out (a planted fault)")
    args = ap.parse_args(argv)
    setup_environment()

    import torch

    torch.set_num_threads(1)
    manifest = load_json("BENCHMARK.json")
    chips = cell_files(manifest, args.workload)["workload"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 control=args.control)
    gc.collect()
    found = forbidden_modules()
    if found:
        print(f"portbench: modules loaded that the benchmark forbids: "
              f"{found}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"compared {name} {c['value']} limit {c['limit']}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
