"""What the VAE trainer and the DiT trainer share: the global-norm clip, the
DDP wrapping and its ``no_sync`` on accumulation micro-steps, and the fit
loop over a loader."""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional, Sequence

import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel as DDP

from sigman_release_torch.parallel import fsdp
from sigman_release_torch.parallel.mesh import prefetch_to_device
from sigman_release_torch.utils.profiling import StepTimer, trace_if


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients by max_norm / norm when their global norm
    reaches ``max_norm`` (the JAX package's optimizer rule, no epsilon).
    Sharded (DTensor) gradients: the norm of the whole gradients, each
    element counted once (``fsdp.global_norm``), and each rank scales its
    pieces. Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    if any(fsdp.is_sharded(g) for g in grads):
        norm = fsdp.global_norm(grads)
        grads = [fsdp.local(g) for g in grads]
    else:
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def wrap_ddp(module: nn.Module, device: torch.device) -> DDP:
    """``module`` under DDP over every rank, its gradients views of the
    all-reduce buckets (no second copy). Every parameter must get a
    gradient in each backward through it."""
    return DDP(module, device_ids=[device] if device.type == "cuda" else None,
               gradient_as_bucket_view=True)


def no_sync(ddp: Optional[DDP], sync: bool):
    """``ddp.no_sync()`` on an accumulation micro-step that is not the
    last; else nothing."""
    return ddp.no_sync() if ddp is not None and not sync \
        else contextlib.nullcontext()


def fit(trainer, loader, step: Callable[[Dict[str, torch.Tensor]], dict], *,
        keys: Callable[[dict], Sequence[str]], head: Callable[[dict], str],
        evaluate: Optional[Callable[[], None]] = None,
        num_steps: Optional[int] = None, log_every: int = 10,
        eval_every: Optional[int] = None, ckpt_path: Optional[str] = None,
        logger=None, profile_dir: Optional[str] = None,
        profile_every: int = 500) -> Dict[str, float]:
    """``trainer``'s steps over ``loader`` epochs until ``num_steps`` (one
    epoch of the shortest rank's loader if None; every rank must be given
    the same ``num_steps``). ``trainer`` has ``step`` (which ``step(batch)``
    advances), ``mesh``, ``device``, ``cfg`` and ``save``.

    Each loader batch is cut to ``keys(batch)`` and reaches the device
    ``prefetch_to_device`` ahead; with ``profile_dir`` every
    ``profile_every``-th step (counted from 0, the first not) is traced
    into it (``utils/profiling.trace_if``). Every ``log_every`` steps rank
    0 prints ``head(logs)`` with the step time and the data wait, and logs
    the logs and the timer's summary to ``logger``. The trainer saves to
    ``ckpt_path`` every ``save_ckpt_steps`` and at the end, and
    ``evaluate()`` runs every ``eval_every`` steps. Returns the last
    step's logs as floats."""
    mesh, lead = trainer.mesh, trainer.mesh.rank == 0
    if num_steps is None:
        num_steps = trainer.step + mesh.min_int(len(loader))
    timer = StepTimer()
    timer.tick()
    logs: Dict[str, float] = {}
    while trainer.step < num_steps:
        host = ({k: b[k] for k in keys(b)} for b in loader)
        taken = 0
        for batch in timer.timed(prefetch_to_device(
                host, mesh, trainer.device)):
            if trainer.step >= num_steps:
                break
            taken += 1
            with trace_if(profile_dir, trainer.step, every=profile_every):
                out = step(batch)
            logs = {n: float(v) for n, v in out.items()}
            timer.tick()
            if trainer.step % log_every == 0 and lead:
                summ = timer.summary()
                print(f"{head(logs)} "
                      f"({summ.get('step_time_mean_s', 0.0):.2f}s/step, "
                      f"data wait {summ.get('data_wait_mean_s', 0.0):.3f}s"
                      f" = {summ.get('data_wait_share', 0.0):.1%})",
                      flush=True)
                if logger is not None:
                    logger.log(trainer.step, {**logs, **summ})
            if ckpt_path and trainer.step % trainer.cfg.save_ckpt_steps == 0:
                trainer.save(ckpt_path)
            if (evaluate is not None and eval_every
                    and trainer.step % eval_every == 0):
                evaluate()
        if not taken and trainer.step < num_steps:
            raise ValueError("fit: the loader yields no batch")
    if ckpt_path:
        trainer.save(ckpt_path)
    return logs
