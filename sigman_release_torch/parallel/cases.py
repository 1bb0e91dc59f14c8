"""Data parallelism held against one process on the whole batch: the runs
that ``chip_smoke.py`` (phase 13, at full width on the card) and
``tests/test_torch_ddp_training.py`` (``test_tiny`` on the CPU) start on
every rank through ``launch.run``.

Each case is given one batch for the whole world (synthetic items by
number) and its random draws. Rank 0 first takes the steps in one process
on the whole batch (a bare trainer, no DDP); then every rank takes them on
its share under DDP (its data rows, its block of views), and rank 0
compares: the loss of each step (relative), the gradient that reaches each
clip, averaged over the ranks (relative L2), and the update, new minus old
weights over all steps, relative to the one-process update and to the
one-process new weights (L2). With ``repeat`` = n, rank 0 takes the
one-process steps n more times and returns as ``floor`` the largest of the
same numbers over those runs: the spread of a step whose backward is not
deterministic (one more run alone can land close to the first by chance).
Weights are seeded alike on every rank (or loaded from ``weights``). Each rank also returns its step times, its peak
device memory and its K1 / K2 launches under DDP.
"""

from __future__ import annotations

import itertools
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from sigman_release_torch.parallel.mesh import Mesh, make_mesh, shard_batch

ONE = Mesh((1,), ("data",), (0,), (None,))      # one process, no group


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _peak_gib(dev) -> Optional[float]:
    return (torch.cuda.max_memory_allocated(dev) / 2**30
            if dev.type == "cuda" else None)


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    """|a - b| / |b| in L2 (f64), for vectors or scalars."""
    a, b = a.double().flatten(), b.double().flatten()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _flat(tensors) -> torch.Tensor:
    return torch.cat([t.detach().float().flatten() for t in tensors])


def _rows(batch: Dict[str, np.ndarray], mesh: Mesh, coords=None):
    """Rank ``coords``' share of a whole batch (numpy): its contiguous block
    of rows along 'data', then its block of views (``shard_batch``)."""
    coords = mesh.coords if coords is None else coords
    d, n = coords[0], mesh.shape[0]
    b = next(iter(batch.values())).shape[0] // n
    rows = {k: v[d * b:(d + 1) * b] for k, v in batch.items()}
    return rows, Mesh(mesh.shape, mesh.axis_names, tuple(coords),
                      (None,) * len(mesh.shape))


def _counters():
    from sigman_release_torch.ops.rasterizer import backward_tiles as k2
    from sigman_release_torch.ops.rasterizer import forward_tiles as k1

    return k1.forward_tiles, k2.backward_tiles


def _compare(run, ref) -> dict:
    """Losses, clips' gradients, update and new weights of ``run`` (the
    first four of a ``_vae_steps`` / ``_dit_steps`` result, and its new
    weights' norm) against ``ref``."""
    (loss, clips, update), (r_loss, r_clips, r_update, r_norm) = run, ref
    return {"loss_rel": [abs(a - b) / max(abs(b), 1e-30)
                         for a, b in zip(loss, r_loss)],
            "grad_rel": [_rel(a, b) for a, b in zip(clips, r_clips)],
            "update_rel": _rel(update, r_update),
            "weights_rel": float((update - r_update).double().norm()) / r_norm,
            "n_clips": (len(clips), len(r_clips))}


def _worst(runs) -> dict:
    """The largest of each number of several ``_compare`` results."""
    out = dict(runs[0])
    for run in runs[1:]:
        for k in ("loss_rel", "grad_rel"):
            out[k] = [max(a, b) for a, b in zip(out[k], run[k])]
        for k in ("update_rel", "weights_rel"):
            out[k] = max(out[k], run[k])
    return out


class _Clips:
    """Records the gradient each clip of ``module`` sees (before it
    scales), flattened."""

    def __init__(self, module):
        self.module, self.seen = module, []
        self.real = module.clip_by_global_norm_

    def __enter__(self):
        def clip(params, max_norm):
            params = list(params)
            self.seen.append(_flat([p.grad for p in params]))
            return self.real(params, max_norm)

        self.module.clip_by_global_norm_ = clip
        return self

    def __exit__(self, *exc):
        self.module.clip_by_global_norm_ = self.real


# ------------------------------------------------------------------- VAE

def _vae_trainer(cfg, mesh, body, template, weights, dev):
    from sigman_release_torch.training.vae_trainer import VAETrainer

    trainer = VAETrainer(cfg, body_model=body, template=template, device=dev,
                         mesh=mesh)
    if weights:
        trainer.load_state_dicts(**weights)
    return trainer


def _vae_steps(trainer, batch, noise, steps, dev):
    """``steps`` ("g" / "d") on a device batch: (losses, logs, grads at
    each clip, update, step ms, norm of the new weights)."""
    from sigman_release_torch.training import vae_trainer

    params = [*trainer.params_g, *trainer.disc.parameters()]
    before = _flat(params)
    losses, logs, ms = [], [], []
    with _Clips(vae_trainer) as clips:
        for kind in steps:
            _sync(dev)
            t0 = time.perf_counter()
            out = (trainer.train_step_g(batch, noise) if kind == "g"
                   else trainer.train_step_d(batch, noise))
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            logs.append({k: float(v) for k, v in out.items()})
            losses.append(logs[-1]["loss" if kind == "g" else "GAN_D"])
    after = _flat(params)
    return (losses, logs, clips.seen, after - before, ms,
            float(after.double().norm()))


def _vae_eval(trainer, items, batch_size):
    from sigman_release_torch.data.loader import DataLoader

    loader = DataLoader(items, batch_size, shuffle=False, num_workers=1,
                        drop_last=False)
    return trainer.evaluate(loader)


def vae_case(cfg, mesh_shape: Sequence[int], mesh_axes: Sequence[str],
             items: Sequence[int], steps: Sequence[str] = ("g",),
             noise: Optional[np.ndarray] = None, noise_seed: int = 0,
             rank_noise: Optional[Sequence[np.ndarray]] = None,
             weights: Optional[dict] = None,
             eval_items: Sequence[int] = (), n_verts: Optional[int] = None,
             split_logs: bool = False, keep_disc: bool = False,
             repeat: int = 0, device="cpu") -> dict:
    """``VAETrainer`` steps ("g" / "d") on the synthetic ``items`` (the
    whole batch; ``cfg.seed`` numbers them) with posterior noise ``noise``
    (or drawn from ``noise_seed``; ``rank_noise[r]``, where given, is rank
    r's own under DDP, to replay draws that differ between view ranks),
    then ``evaluate`` over ``eval_items``
    (the data ranks' shares at batch 1 against one process at batch =
    data size, which pools the same items per eval step). The body is the
    procedural one of ``n_verts`` vertices (default: the trainer's).
    ``split_logs``: rank 0 also steps one process on each rank's share, to
    hold the first step's logs against their mean; ``keep_disc``: each
    rank returns its discriminator's weights after the steps."""
    from sigman_release_torch.body.smplx import synthetic_body_model
    from sigman_release_torch.body.template import synthetic_template
    from sigman_release_torch.data.dataset import SyntheticAvatarDataset
    from sigman_release_torch.training.vae_trainer import BATCH_KEYS

    dev = torch.device(device)
    mesh = make_mesh(mesh_shape, mesh_axes)
    data = SyntheticAvatarDataset(cfg, n_items=max([*items, *eval_items]) + 1,
                                  seed=cfg.seed)
    whole = {k: np.stack([data[i][k] for i in items]) for k in BATCH_KEYS}
    q, c = cfg.uv_query_size, cfg.latent_channels
    if noise is None:
        noise = np.random.default_rng(noise_seed).normal(
            size=(len(items), q, q, c)).astype(np.float32)
    body = synthetic_body_model(**({"n_verts": n_verts} if n_verts else {}),
                                seed=0, device=dev)
    template = synthetic_template(body)
    held = [data[i] for i in eval_items]
    out: dict = {"rank": mesh.rank, "coords": mesh.coords}

    def one_process():
        ref = _vae_trainer(cfg, ONE, body, template, weights, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        run = _vae_steps(ref, ref.to_device(whole),
                         torch.from_numpy(noise).to(dev), steps, dev)
        return ref, run

    if mesh.rank == 0:          # one process on the whole batch
        ref, (r_loss, r_logs, r_clips, r_update, r_ms, r_norm) = one_process()
        first = (r_loss, r_clips, r_update, r_norm)
        out.update(ref_logs=r_logs, ref_step_ms=r_ms,
                   ref_peak_gib=_peak_gib(dev))
        if held:
            out["ref_eval"] = _vae_eval(ref, held, mesh.data_size)
        floors = []
        for _ in range(int(repeat)):
            del ref
            ref, again = one_process()
            floors.append(_compare((again[0], again[2], again[3]), first))
        if floors:
            out["floor"] = _worst(floors)
        if split_logs:
            split = []
            for coords in itertools.product(*map(range, mesh.shape)):
                rows, m = _rows(whole, mesh, coords)
                t = _vae_trainer(cfg, ONE, body, template, weights, dev)
                nz = _rows({"n": noise}, mesh, coords)[0]["n"]
                split.append(_vae_steps(t, shard_batch(rows, m, dev),
                                        torch.from_numpy(nz).to(dev),
                                        steps[:1], dev)[1][0])
                del t
            out["split_logs"] = split
        del ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    trainer = _vae_trainer(cfg, mesh, body, template, weights, dev)
    rows, _ = _rows(whole, mesh)
    share = trainer.to_device(rows)
    nz = torch.from_numpy(_rows({"n": noise}, mesh)[0]["n"]
                          if rank_noise is None
                          else rank_noise[mesh.rank]).to(dev)
    k1, k2 = _counters()
    k1.launches = k2.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loss, logs, clips, update, ms, _ = _vae_steps(trainer, share, nz,
                                                  steps, dev)
    out.update(launches={"forward_tiles": k1.launches,
                         "backward_tiles": k2.launches},
               logs=logs, step_ms=ms, peak_gib=_peak_gib(dev),
               buckets=buckets(trainer.ddp_g))
    if keep_disc:
        out["disc"] = {k: v.detach().cpu()
                       for k, v in trainer.disc.state_dict().items()}
    if held:
        from sigman_release_torch.data.loader import shard_for_host

        out["eval"] = _vae_eval(trainer, shard_for_host(held, mesh=mesh), 1)
    if mesh.rank == 0:
        out.update(_compare((loss, clips, update), first))
    return out


def buckets(ddp) -> Optional[dict]:
    """The all-reduce buckets of a DDP: count and bytes (its logging
    data), or None without DDP."""
    if ddp is None:
        return None
    data = ddp._get_ddp_logging_data()
    sizes = [int(s) for s in str(data.get("bucket_sizes", "")).split(",")
             if s.strip()]
    return {"count": len(sizes), "bytes": sum(sizes)}


# ------------------------------------------------------------------- DiT

def _dit_trainer(cfg, mesh, dev):
    from sigman_release_torch.models.vae import VAEModel
    from sigman_release_torch.training.dit_trainer import (
        DiTTrainer, build_on, make_encoder)
    from sigman_release_torch.training.vae_trainer import init_vae_

    with torch.device(dev):
        vae = VAEModel(cfg).to(dev)
    init_vae_(vae, cfg.seed)
    encoder = build_on(dev, lambda: make_encoder(cfg),
                       torch.Generator(device=dev).manual_seed(cfg.seed + 1))
    return DiTTrainer(cfg, vae, encoder, device=dev, mesh=mesh)


def _dit_steps(trainer, batch, draws, steps, dev):
    from sigman_release_torch.training import dit_trainer

    before = _flat(trainer.model.parameters())
    losses, ms = [], []
    with _Clips(dit_trainer) as clips:
        for _ in range(steps):
            _sync(dev)
            t0 = time.perf_counter()
            losses.append(float(trainer.train_step(batch, draws)["loss"]))
            _sync(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
    after = _flat(trainer.model.parameters())
    return (losses, clips.seen, after - before, ms,
            float(after.double().norm()))


def dit_draws(cfg, b: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """One DiT step's draws for ``b`` items from a numpy seed (the
    dropout draws alternate, so both branches run)."""
    rng = np.random.default_rng(seed)
    q, c = cfg.uv_query_size, cfg.latent_channels
    return {"enc_noise": rng.normal(size=(b, q, q, c)).astype(np.float32),
            "t": rng.integers(0, cfg.num_train_timesteps, b),
            "noise": rng.normal(size=(b, c, q, q)).astype(np.float32),
            "drop": (np.arange(b) % 2 == 1).reshape(b, 1, 1, 1)}


def dit_case(cfg, items: Sequence[int], steps: int = 1, draw_seed: int = 0,
             eval_items: Sequence[int] = (), repeat: int = 0,
             device="cpu") -> dict:
    """``DiTTrainer`` micro-steps over 'data' on the synthetic ``items``
    (raw path) with the draws of ``dit_draws``, then ``eval_loss`` on the
    data ranks' shares of ``eval_items`` (unequal shares allowed) against
    one process on all of them."""
    from sigman_release_torch.data.dataset import SyntheticAvatarDataset
    from sigman_release_torch.training.dit_trainer import RAW_KEYS

    dev = torch.device(device)
    mesh = make_mesh((-1,), ("data",))
    data = SyntheticAvatarDataset(cfg, n_items=max([*items, *eval_items]) + 1,
                                  seed=cfg.seed)
    whole = {k: np.stack([data[i][k] for i in items]) for k in RAW_KEYS}
    draws = dit_draws(cfg, len(items), draw_seed)
    held = {k: np.stack([data[i][k] for i in eval_items]) for k in RAW_KEYS}
    e_noise = dit_draws(cfg, len(eval_items), draw_seed + 1)
    e_noise = {"noise": e_noise["noise"], "enc_noise": e_noise["enc_noise"]}
    out: dict = {"rank": mesh.rank}

    def tensors(d):
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in d.items()}

    def one_process():
        ref = _dit_trainer(cfg, ONE, dev)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        return ref, _dit_steps(ref, ref.to_device(whole), tensors(draws),
                               steps, dev)

    if mesh.rank == 0:
        ref, (r_loss, r_clips, r_update, r_ms, r_norm) = one_process()
        first = (r_loss, r_clips, r_update, r_norm)
        out.update(ref_step_ms=r_ms, ref_peak_gib=_peak_gib(dev))
        if eval_items:
            out["ref_eval_loss"] = float(ref.eval_loss(
                ref.to_device(held), **tensors(e_noise)))
        floors = []
        for _ in range(int(repeat)):
            del ref
            ref, again = one_process()
            floors.append(_compare(again[:3], first))
        if floors:
            out["floor"] = _worst(floors)
        del ref
    trainer = _dit_trainer(cfg, mesh, dev)
    rows, _ = _rows(whole, mesh)
    mine = _rows(draws, mesh)[0]
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    loss, clips, update, ms, _ = _dit_steps(
        trainer, trainer.to_device(rows), tensors(mine), steps, dev)
    out.update(losses=loss, step_ms=ms, peak_gib=_peak_gib(dev),
               buckets=buckets(trainer.ddp))
    if eval_items:
        from sigman_release_torch.data.loader import shard_for_host

        idx = shard_for_host(range(len(eval_items)), mesh=mesh)
        share = {k: v[idx] for k, v in held.items()}
        noise = {k: v[idx] for k, v in e_noise.items()}
        out["eval_loss"] = float(trainer.eval_loss(
            trainer.to_device(share) if idx else None, **tensors(noise)))
    if mesh.rank == 0:
        out.update(_compare((loss, clips, update), first))
    return out


def mesh_case(layouts: Sequence) -> list:
    """``make_mesh`` of each (shape, axes) on this rank: its shape, coords
    and the ranks of its group on each axis."""
    import torch.distributed as dist

    out = []
    for shape, axes in layouts:
        mesh = make_mesh(shape, axes)
        out.append({"shape": mesh.shape, "coords": mesh.coords,
                    "rank": mesh.rank, "groups": [
                        dist.get_process_group_ranks(mesh.group(a))
                        for a in axes]})
    return out


def entry_case(module: str, argv: Sequence[str], resume_argv=None) -> dict:
    """An entry point's ``main(argv)`` on this rank (the process group is
    joined already) and, with ``resume_argv``, a second ``main`` that
    resumes: each run's step, this rank's generator state and what it
    printed."""
    import contextlib
    import importlib
    import io

    main = importlib.import_module(module).main
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        runs = [main(list(argv))]
        if resume_argv is not None:
            runs.append(main(list(resume_argv)))
    return {"steps": [t.step for t in runs],
            "generators": [t.generator.get_state() for t in runs],
            "printed": printed.getvalue()}
