"""Device-time breakdown of ``vae_b`` or ``dit`` training steps on the card.

    python -m sigman_release_torch.training.profile_step [--kind g|d|dit]

``g`` / ``d``: ``VAETrainer`` at the ``vae_b`` preset's full width on one
synthetic item with the 100,000-Gaussian procedural body
(``vae_trainer.synthetic_setup``, the set-up of ``chip_smoke.py`` phase 7),
a generator or discriminator step. ``dit``: ``DiTTrainer`` at the ``dit``
preset's full width on 8 synthetic items, raw path
(``dit_trainer.synthetic_setup``, the set-up of phase 10). Takes one
warm-up step and times it, then records two more with ``torch.profiler``
(CPU and CUDA activities) with the port's ``StageTimer``: each span a
``span:<name>`` range, the device synchronised at both ends of each
outermost span (these steps open no nested one). Prints the wall time per
step, the device-busy share (the union of kernel intervals over the wall
time), each span's wall time and device time (the union of the kernel
intervals inside the span's window, so that the kernels autograd launches
from its own thread count where they run), the 30 kernels and operators
with the most device time, and last the floating-point operations of
each span (one more step under ``torch.utils.flop_counter.FlopCounterMode``,
which counts matmuls, convolutions and attention: forward, recompute and
backward). Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import time

import torch


def _busy_us(kernels, lo=float("-inf"), hi=float("inf")) -> float:
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kind", choices=("g", "d", "dit"), default="g")
    args = ap.parse_args(argv)
    steps = 2

    from torch.profiler import ProfilerActivity, profile

    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.utils.timing import StageTimer

    if args.kind == "dit":
        from sigman_release_torch.training import dit_trainer

        trainer, batch, _ = dit_trainer.synthetic_setup(PRESETS["dit"],
                                                        device="cuda")
        step = trainer.train_step
    else:
        from sigman_release_torch.training import vae_trainer

        trainer, batch = vae_trainer.synthetic_setup(PRESETS["vae_b"],
                                                     device="cuda")
        step = (trainer.train_step_g if args.kind == "g"
                else trainer.train_step_d)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batch)                                      # warm-up
    torch.cuda.synchronize()
    print(f"[profile] warm-up {args.kind} step (profiler off): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    timer = StageTimer(torch.device("cuda"))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch, timer=timer)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    # the device's timeline also carries each span's range as an
    # annotation: not a kernel
    kernels = sorted((e.time_range.start, e.time_range.end) for e in events
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     and not e.name.startswith("span:"))
    busy = _busy_us(kernels)
    print(f"[profile] {steps} {args.kind} steps: "
          f"{wall_us / steps / 1e3:.1f} "
          f"ms per step (profiler on); device busy {busy / wall_us:.1%} of "
          f"the wall time ({torch.cuda.get_device_name(0)})")
    per_span = {}
    for e in events:
        if (e.name.startswith("span:")
                and e.device_type == torch.autograd.DeviceType.CPU):
            lo, hi = e.time_range.start, e.time_range.end
            wall, dev = per_span.get(e.name[5:], (0.0, 0.0))
            per_span[e.name[5:]] = (wall + hi - lo,
                                    dev + _busy_us(kernels, lo, hi))
    for name, (wall, dev) in per_span.items():
        print(f"[profile] {name}: wall {wall / 1e3 / steps:.1f} ms, device "
              f"busy {dev / 1e3 / steps:.1f} ms ({dev / wall:.1%}) per step")
    print(f"[profile] the spans hold "
          f"{sum(d for _, d in per_span.values()) / 1e3 / steps:.1f} of the "
          f"{busy / 1e3 / steps:.1f} ms of device busy time per step")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=30,
                                    max_name_column_width=70))

    # counted last: with this step before the profile, the profile found
    # cuDNN on a 4x slower algorithm for the DiT's frozen 3D-conv encode
    flops = {}

    @contextlib.contextmanager
    def counted(name):
        from torch.utils.flop_counter import FlopCounterMode

        with FlopCounterMode(display=False) as counter:
            yield
        flops[name] = flops.get(name, 0) + counter.get_total_flops()

    step(batch, timer=counted)
    print("[profile] FLOP per step by span: " + ", ".join(
        f"{k} {v:.4e}" for k, v in flops.items()))


if __name__ == "__main__":
    main()
