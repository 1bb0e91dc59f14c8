"""Device-time breakdown of ``vae_b`` training steps on the card.

    python -m sigman_release_torch.training.profile_step [--kind g|d]

Builds ``VAETrainer`` at the ``vae_b`` preset's full width on one synthetic
item with the 100,000-Gaussian procedural body (``synthetic_setup``, the
set-up of ``chip_smoke.py`` phase 7), takes one warm-up step of ``--kind`` (generator or discriminator) and
times it, then records two more with ``torch.profiler`` (CPU and CUDA
activities). Prints the wall time per step, the device-busy share (the
union of kernel intervals over the wall time), the device time of each
forward/backward span, and the 30 kernels and operators with the most
device time. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import time

import torch


def _busy_us(events) -> float:
    """Length of the union of the device kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
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
    ap.add_argument("--kind", choices=("g", "d"), default="g")
    args = ap.parse_args(argv)
    steps = 2

    from torch.profiler import ProfilerActivity, profile, record_function

    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.training.vae_trainer import synthetic_setup

    trainer, batch = synthetic_setup(PRESETS["vae_b"], device="cuda")
    step = trainer.train_step_g if args.kind == "g" else trainer.train_step_d

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step(batch)                                      # warm-up
    torch.cuda.synchronize()
    print(f"[profile] warm-up {args.kind.upper()} step (profiler off): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")

    def span(name):
        return record_function(f"span:{name}")

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            step(batch, timer=span)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = prof.events()
    busy = _busy_us(events)
    print(f"[profile] {steps} {args.kind.upper()} steps: "
          f"{wall_us / steps / 1e3:.1f} "
          f"ms per step (profiler on); device busy {busy / wall_us:.1%} of "
          f"the wall time ({torch.cuda.get_device_name(0)})")
    for e in prof.key_averages():
        if e.key.startswith("span:"):
            print(f"[profile] {e.key[5:]}: device "
                  f"{e.device_time_total / 1e3 / steps:.1f} ms, host "
                  f"{e.cpu_time_total / 1e3 / steps:.1f} ms per step")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=30,
                                    max_name_column_width=70))


if __name__ == "__main__":
    main()
