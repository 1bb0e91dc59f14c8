"""Data parallelism held against one process on the whole batch: the runs
that ``chip_smoke.py`` (phases 13 and 16, at full width on the card) and
``tests/test_torch_ddp_training.py`` / ``tests/test_torch_fsdp.py``
(``test_tiny`` on the CPU) start on every rank through ``launch.run``.

Each case is given one batch for the whole world (synthetic items by
number) and its random draws. Rank 0 first takes the steps in one process
on the whole batch (a bare trainer, no DDP); then every rank takes them on
its share under DDP or sharded (its data rows, its block of views), and
rank 0 compares (``_Tap``, ``_compare``; whole tensors one parameter at a
time, the one process's on the host): the loss of each step (relative),
the gradient that reaches each clip, averaged over the ranks (relative L2
over all parameters, and the worst parameter's), and the update, new
minus old weights over all steps, relative to the one-process update and
to the one-process new weights (L2). With ``repeat`` = n, rank 0 takes
the one-process steps n more times and returns as ``floor`` the largest
of the same numbers over those runs: the spread of a step whose backward
is not deterministic (one more run alone can land close to the first by
chance). Weights are seeded alike on every rank (or loaded from
``weights``). Each rank also returns its step times, its peak device
memory and its K1 / K2 / KNN launches.
"""

from __future__ import annotations

import contextlib
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


def _host(tensors) -> list:
    """Host f32 copies, one tensor at a time."""
    return [t.detach().float().to("cpu", copy=True) for t in tensors]


def _sq(t: torch.Tensor, h: torch.Tensor) -> tuple:
    """(sum (t - h)^2, sum h^2) in f64, the host tensor ``h`` moved to
    ``t``'s device."""
    t, h = t.detach().float(), h.to(t.device)
    return (float((t - h).square().sum(dtype=torch.float64)),
            float(h.square().sum(dtype=torch.float64)))


def _ratio(num: float, den: float) -> float:
    return (num / max(den, 1e-300)) ** 0.5


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
    from sigman_release_torch.ops import knn
    from sigman_release_torch.ops.rasterizer import backward_tiles as k2
    from sigman_release_torch.ops.rasterizer import forward_tiles as k1

    return k1.forward_tiles, k2.backward_tiles, knn.mean_knn_dist2


def _names(*modules) -> Dict[int, str]:
    return {id(p): n for m in modules for n, p in m.named_parameters()}


class _Tap:
    """At each clip of ``module``'s optimizer step (its
    ``clip_by_global_norm_``), the gradients whole, one parameter at a time
    (``fsdp.full`` gathers a sharded one on every rank; a plain one is
    itself): kept on the host (``against`` None), held against such copies
    of another run (``against``: one list per clip; the relative L2 over
    all of them, and the largest of any one parameter with its name from
    ``names``), or only gathered (``keep`` False: a rank that joins the
    gathers). Also each clip's global norm, and the seconds the tap took
    after the device had finished the step's backward (``seconds``), which
    the step times leave out."""

    def __init__(self, module, against=None, keep: bool = True,
                 names: Optional[Dict[int, str]] = None):
        self.module, self.against, self.keep = module, against, keep
        self.names = names or {}
        self.real = module.clip_by_global_norm_
        self.host, self.rel, self.leaf, self.norms = [], [], [], []
        self.seconds = 0.0

    def __enter__(self):
        from sigman_release_torch.parallel import fsdp

        def clip(params, max_norm):
            params = list(params)
            _sync(params[0].device)
            t0 = time.perf_counter()
            grads = (fsdp.full(p.grad) for p in params)   # one at a time
            if not self.keep:
                for _ in grads:
                    pass
            elif self.against is None:
                self.host.append(_host(grads))
            else:
                sq = [_sq(g, h) for g, h in zip(
                    grads, self.against[len(self.rel)], strict=True)]
                self.rel.append(_ratio(sum(a for a, _ in sq),
                                       sum(b for _, b in sq)))
                i = max(range(len(sq)), key=lambda j: _ratio(*sq[j]))
                self.leaf.append((_ratio(*sq[i]),
                                  self.names.get(id(params[i]), str(i))))
            self.seconds += time.perf_counter() - t0
            norm = self.real(params, max_norm)
            self.norms.append(float(norm))
            return norm

        self.module.clip_by_global_norm_ = clip
        return self

    def __exit__(self, *exc):
        self.module.clip_by_global_norm_ = self.real


def _compare(losses, tap: _Tap, weights, ref: dict) -> dict:
    """A run against one process from the same weights (``ref``: its
    "losses", and on the host its "clips" (``_Tap.host``) and its weights
    "before" and "after" its steps): each loss (relative), the gradient at
    each clip (``tap``, held against ``ref["clips"]``: relative L2, and its
    worst parameter), and the new ``weights`` (whole, one at a time): the
    relative L2 of the update (new minus old) and of the new weights."""
    d = u = w = 0.0
    for t, a, b in zip(weights, ref["after"], ref["before"], strict=True):
        t = t.detach().float()
        a, b = a.to(t.device), b.to(t.device)
        d += float((t - a).square().sum(dtype=torch.float64))
        u += float((a - b).square().sum(dtype=torch.float64))
        w += float(a.square().sum(dtype=torch.float64))
    return {"loss_rel": [abs(a - b) / max(abs(b), 1e-30)
                         for a, b in zip(losses, ref["losses"])],
            "grad_rel": tap.rel, "grad_leaf": tap.leaf,
            "update_rel": _ratio(d, u), "weights_rel": _ratio(d, w),
            "n_clips": (len(tap.rel), len(ref["clips"]))}


def _worst(runs) -> dict:
    """The largest of each number of several ``_compare`` results."""
    out = dict(runs[0])
    for run in runs[1:]:
        for k in ("loss_rel", "grad_rel", "grad_leaf"):
            out[k] = [max(a, b) for a, b in zip(out[k], run[k])]
        for k in ("update_rel", "weights_rel"):
            out[k] = max(out[k], run[k])
    return out


def _timed(dev, tap: Optional[_Tap], ms: list, fn):
    """``fn()``, its wall ms less the tap's seconds appended to ``ms``."""
    spent = tap.seconds if tap else 0.0
    _sync(dev)
    t0 = time.perf_counter()
    out = fn()
    _sync(dev)
    taken = (tap.seconds if tap else 0.0) - spent
    ms.append((time.perf_counter() - t0 - taken) * 1e3)
    return out


# ------------------------------------------------------------------- VAE

def _vae_trainer(cfg, mesh, body, template, weights, dev):
    from sigman_release_torch.training.vae_trainer import VAETrainer

    trainer = VAETrainer(cfg, body_model=body, template=template, device=dev,
                         mesh=mesh)
    if weights:
        trainer.load_state_dicts(**weights)
    return trainer


def _vae_params(trainer) -> list:
    return [*trainer.params_g, *trainer.disc.parameters()]


def _vae_steps(trainer, batch, noise, steps, dev, tap: _Tap):
    """``steps`` ("g" / "d") on a device batch under ``tap``: (losses,
    logs, step ms)."""
    losses, logs, ms = [], [], []
    with tap:
        for kind in steps:
            out = _timed(dev, tap, ms, lambda: (
                trainer.train_step_g(batch, noise) if kind == "g"
                else trainer.train_step_d(batch, noise)))
            logs.append({k: float(v) for k, v in out.items()})
            losses.append(logs[-1]["loss" if kind == "g" else "GAN_D"])
    return losses, logs, ms


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
    from sigman_release_torch.training import vae_trainer
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

    def one_process(against=None):
        ref = _vae_trainer(cfg, ONE, body, template, weights, dev)
        before = None if against else _host(_vae_params(ref))
        tap = _Tap(vae_trainer, against and against["clips"],
                   names=_names(ref.vae, ref.disc))
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        run = _vae_steps(ref, ref.to_device(whole),
                         torch.from_numpy(noise).to(dev), steps, dev, tap)
        return ref, before, tap, run

    if mesh.rank == 0:          # one process on the whole batch
        ref, before, tap, (r_loss, r_logs, r_ms) = one_process()
        first = {"losses": r_loss, "clips": tap.host, "before": before,
                 "after": _host(_vae_params(ref))}
        out.update(ref_logs=r_logs, ref_step_ms=r_ms,
                   ref_peak_gib=_peak_gib(dev))
        if held:
            out["ref_eval"] = _vae_eval(ref, held, mesh.data_size)
        floors = []
        for _ in range(int(repeat)):
            del ref, tap
            ref, _, tap, (loss, _, _) = one_process(first)
            floors.append(_compare(loss, tap, _vae_params(ref), first))
        if floors:
            out["floor"] = _worst(floors)
        if split_logs:
            split = []
            for coords in itertools.product(*map(range, mesh.shape)):
                rows, m = _rows(whole, mesh, coords)
                t = _vae_trainer(cfg, ONE, body, template, weights, dev)
                nz = _rows({"n": noise}, mesh, coords)[0]["n"]
                split.append(_vae_steps(
                    t, shard_batch(rows, m, dev), torch.from_numpy(nz).to(dev),
                    steps[:1], dev, _Tap(vae_trainer, keep=False))[1][0])
                del t
            out["split_logs"] = split
        del ref, tap
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    trainer = _vae_trainer(cfg, mesh, body, template, weights, dev)
    rows, _ = _rows(whole, mesh)
    share = trainer.to_device(rows)
    nz = torch.from_numpy(_rows({"n": noise}, mesh)[0]["n"]
                          if rank_noise is None
                          else rank_noise[mesh.rank]).to(dev)
    k1, k2, kn = _counters()
    k1.launches = k2.launches = kn.launches = 0
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    tap = _Tap(vae_trainer, first["clips"] if mesh.rank == 0 else None,
               keep=mesh.rank == 0, names=_names(trainer.vae, trainer.disc))
    loss, logs, ms = _vae_steps(trainer, share, nz, steps, dev, tap)
    out.update(launches={"forward_tiles": k1.launches,
                         "backward_tiles": k2.launches,
                         "mean_knn_dist2": kn.launches},
               logs=logs, step_ms=ms, peak_gib=_peak_gib(dev),
               buckets=buckets(trainer.ddp_g))
    if keep_disc:
        out["disc"] = {k: v.detach().cpu()
                       for k, v in trainer.disc.state_dict().items()}
    if held:
        from sigman_release_torch.data.loader import shard_for_host

        out["eval"] = _vae_eval(trainer, shard_for_host(held, mesh=mesh), 1)
    if mesh.rank == 0:
        out.update(_compare(loss, tap, _vae_params(trainer), first))
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

def dit_draws(cfg, b: int, seed: int = 0) -> Dict[str, np.ndarray]:
    """One DiT step's draws for ``b`` items from a numpy seed (the
    dropout draws alternate, so both branches run)."""
    rng = np.random.default_rng(seed)
    q, c = cfg.uv_query_size, cfg.latent_channels
    return {"enc_noise": rng.normal(size=(b, q, q, c)).astype(np.float32),
            "t": rng.integers(0, cfg.num_train_timesteps, b),
            "noise": rng.normal(size=(b, c, q, q)).astype(np.float32),
            "drop": (np.arange(b) % 2 == 1).reshape(b, 1, 1, 1)}


def _dit_parts(cfg, dev, n_verts: Optional[int] = None):
    """The frozen VAE (seeded as the trainer's), its ``LatentRenderer`` on
    the procedural body (of ``n_verts`` vertices; default the renderer's
    own), and the conditioning encoder."""
    from sigman_release_torch.models.init import build_on
    from sigman_release_torch.training.dit_trainer import (
        frozen_vae,
        make_encoder,
    )

    body = template = None
    if n_verts:
        from sigman_release_torch.body.smplx import synthetic_body_model
        from sigman_release_torch.body.template import synthetic_template

        body = synthetic_body_model(n_verts=n_verts, seed=0, device=dev)
        template = synthetic_template(body)
    vae, renderer = frozen_vae(cfg, body, template, device=dev)
    return vae, renderer, build_on(
        dev, lambda: make_encoder(cfg),
        torch.Generator(device=dev).manual_seed(cfg.seed + 1))


def dit_case(cfg, items: Sequence[int], steps: int = 1, draw_seed: int = 0,
             eval_items: Sequence[int] = (), repeat: int = 0,
             mesh_shape: Sequence[int] = (-1,),
             mesh_axes: Sequence[str] = ("data",), sample_steps: int = 0,
             save_path: Optional[str] = None, after_save: int = 0,
             n_verts: Optional[int] = None, timed: int = 0,
             device="cpu") -> dict:
    """``DiTTrainer`` micro-steps (raw path) on the synthetic ``items``
    with the draws of ``dit_draws``, under DDP over 'data', or sharded with
    ``cfg.spmd == "fsdp"`` on a ('data',) or ('data', 'model') mesh,
    against one process on the whole batch; each rank takes its data
    index's rows of the batch and of the draws. Whole tensors are compared
    one parameter at a time (``_Tap``, ``_compare``), so that it runs at
    full width: rank 0 keeps the one-process run's gradient at each clip
    and its weights before and after on the host, and frees that trainer
    before any rank builds its own (every rank builds its frozen VAE and
    encoder once).

    Returns, besides ``_compare``'s numbers (and ``floor``, the worst of
    ``repeat`` more one-process runs): each rank's losses, the global norm
    at each clip, step ms (less the tap's gathers and copies; or of
    ``timed`` more steps without the tap, where given) and peak GiB (the
    one process's likewise), its sharded bytes
    (``fsdp.sharded_state_bytes``), DDP's buckets, and its eval loss on
    its data index's share of ``eval_items`` (unequal shares allowed)
    against one process on all of them, with given noises and, sharded,
    also with the generator's draws (one process on the shares pooled in
    data-index order).

    ``sample_steps``: after the steps every rank runs ``sample_eval`` from
    a fixed noise on the item after ``eval_items`` with that many DDIM
    steps (its PSNR and K1 launches), rendering the procedural body of
    ``n_verts`` vertices (default: the renderer's own). ``save_path``:
    every rank saves the trainer there after the steps, rank 0 returns the
    whole state it saved (and the one process saved its own beside it,
    ``save_path + ".one"``), and the trainer takes ``after_save`` more
    micro-steps on the same batch with the draws of ``dit_draws(draw_seed
    + 2)`` (their losses and, on rank 0, the whole weights after them)."""
    import gc

    from sigman_release_torch.data.dataset import SyntheticAvatarDataset
    from sigman_release_torch.parallel import fsdp
    from sigman_release_torch.training import dit_trainer
    from sigman_release_torch.training.dit_trainer import (
        RAW_KEYS,
        DiTTrainer,
    )

    dev = torch.device(device)
    mesh = make_mesh(mesh_shape, mesh_axes)
    lead = mesh.rank == 0
    sharded = cfg.spmd == "fsdp"
    n_items = max([*items, *eval_items]) + 2
    data = SyntheticAvatarDataset(cfg, n_items=n_items, seed=cfg.seed)
    made = {i: data[i] for i in {*items, *eval_items}}
    whole = {k: np.stack([made[i][k] for i in items]) for k in RAW_KEYS}
    draws = dit_draws(cfg, len(items), draw_seed)
    held = {k: np.stack([made[i][k] for i in eval_items])
            for k in RAW_KEYS} if eval_items else {}
    e_noise = dit_draws(cfg, len(eval_items), draw_seed + 1)
    e_noise = {"noise": e_noise["noise"], "enc_noise": e_noise["enc_noise"]}
    vae, renderer, encoder = _dit_parts(cfg, dev, n_verts)
    out: dict = {"rank": mesh.rank, "coords": mesh.coords}

    def tensors(d):
        return {k: torch.from_numpy(np.asarray(v)).to(dev)
                for k, v in d.items()}

    def wholes(trainer):
        return (fsdp.full(p.detach()) for p in trainer.model.parameters())

    def run(trainer, batch, step_draws, tap, n=steps):
        """``n`` micro-steps under ``tap`` (or none): losses, ms, peak."""
        losses, ms = [], []
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        with tap or contextlib.nullcontext():
            for _ in range(n):
                losses.append(float(_timed(dev, tap, ms, lambda: (
                    trainer.train_step(batch, step_draws)["loss"]))))
        return losses, ms, _peak_gib(dev)

    def untapped(trainer, batch, step_draws, ms, peak):
        """The ms and peak of ``timed`` more steps without the tap (else
        ``ms`` and ``peak``)."""
        if not timed:
            return ms, peak
        return run(trainer, batch, step_draws, None, timed)[1:]

    if lead:
        def one_process(against=None):
            ref = DiTTrainer(cfg, vae, encoder, device=dev, mesh=ONE)
            before = None if against else _host(ref.model.parameters())
            tap = _Tap(dit_trainer, against and against["clips"],
                       names=_names(ref.model))
            return ref, before, tap, run(ref, ref.to_device(whole),
                                         tensors(draws), tap)

        ref, before, tap, (r_loss, r_ms, r_peak) = one_process()
        first = {"losses": r_loss, "clips": tap.host, "before": before,
                 "after": _host(ref.model.parameters())}
        r_ms, r_peak = untapped(ref, ref.to_device(whole), tensors(draws),
                                r_ms, r_peak)
        out.update(ref_losses=r_loss, ref_step_ms=r_ms, ref_peak_gib=r_peak,
                   ref_norms=tap.norms)
        if eval_items:
            out["ref_eval_loss"] = float(ref.eval_loss(
                ref.to_device(held), **tensors(e_noise)))
        if eval_items and sharded:
            # the generator's draws pool the data indices' shares in order
            from sigman_release_torch.data.loader import shard_for_host

            pooled = [i for d in range(mesh.data_size) for i in shard_for_host(
                range(len(eval_items)), rank=d, world_size=mesh.data_size)]
            out["ref_eval_drawn"] = float(ref.eval_loss(ref.to_device(
                {k: v[pooled] for k, v in held.items()})))
        if save_path:
            ref.save(save_path + ".one")
        floors = []
        for _ in range(int(repeat)):
            del ref, tap
            ref, _, tap, (loss, _, _) = one_process(first)
            floors.append(_compare(loss, tap, ref.model.parameters(), first))
        if floors:
            out["floor"] = _worst(floors)
        del ref, tap
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    mesh.barrier()

    trainer = DiTTrainer(cfg, vae, encoder, latent_renderer=renderer,
                         device=dev, mesh=mesh)
    rows, _ = _rows(whole, mesh)
    mine = (trainer.to_device(rows), tensors(_rows(draws, mesh)[0]))
    tap = _Tap(dit_trainer, first["clips"] if lead else None, keep=lead,
               names=_names(trainer.model))
    loss, ms, peak = run(trainer, *mine, tap)
    if lead:
        out.update(_compare(loss, tap, wholes(trainer), first))
        del first
    else:
        for _ in wholes(trainer):
            pass
    ms, peak = untapped(trainer, *mine, ms, peak)
    out.update(losses=loss, step_ms=ms, peak_gib=peak, norms=tap.norms,
               bytes=fsdp.sharded_state_bytes(trainer.model, trainer.opt),
               buckets=buckets(trainer.ddp))
    if sample_steps:
        k1, _, kn = _counters()
        item = data[n_items - 1]
        noise = torch.from_numpy(np.random.default_rng(draw_seed).normal(
            size=(1, cfg.latent_channels, cfg.sample_height,
                  cfg.sample_width)).astype(np.float32)).to(dev)
        k1.launches = kn.launches = 0
        out["sample"] = trainer.sample_eval(
            trainer.to_device({k: v[None] for k, v in item.items()
                               if k != "item"}), noise=noise,
            num_inference_steps=sample_steps)
        out["sample_launches"] = k1.launches
        out["sample_knn_launches"] = kn.launches
    if eval_items:
        from sigman_release_torch.data.loader import shard_for_host

        idx = shard_for_host(range(len(eval_items)), mesh=mesh)
        share = {k: v[idx] for k, v in held.items()}
        noise = {k: v[idx] for k, v in e_noise.items()}
        mine = trainer.to_device(share) if idx else None
        out["eval_loss"] = float(trainer.eval_loss(mine, **tensors(noise)))
        if sharded:
            out["eval_drawn"] = float(trainer.eval_loss(mine))
    if save_path:
        saved = fsdp.full_state_dict(
            trainer.model, trainer.opt, None if trainer._micro
            % cfg.gradient_accumulation_steps == 0 else
            [p.grad for p in trainer.model.parameters()])
        trainer.save(save_path)
        if lead:
            out["saved"] = saved
        more = tensors(_rows(dit_draws(cfg, len(items), draw_seed + 2),
                             mesh)[0])
        out["after_losses"] = [
            float(trainer.train_step(mine[0], more)["loss"])
            for _ in range(after_save)]
        weights = [w.cpu() for w in wholes(trainer)]
        if lead:
            out["after_weights"] = weights
    return out


def fsdp_weights_case(cfg, mesh_shape: Sequence[int],
                      mesh_axes: Sequence[str], vae: dict, encoder: dict,
                      dit: dict, batch: Dict[str, np.ndarray],
                      draws: Dict[str, np.ndarray], device="cpu") -> dict:
    """One ``DiTTrainer(spmd="fsdp")`` step on given weights, batch and
    draws (this rank's rows of the whole world's): ``vae`` / ``dit`` are
    state dicts, ``encoder`` is {"kwargs": ``ViTFeatureEncoder``'s,
    "state": its state dict}. Returns the loss and, on rank 0, the whole
    gradients at the clip and the whole new weights by name."""
    from sigman_release_torch.models.encoders import ViTFeatureEncoder
    from sigman_release_torch.models.vae import VAEModel
    from sigman_release_torch.parallel import fsdp
    from sigman_release_torch.training import dit_trainer
    from sigman_release_torch.training.dit_trainer import DiTTrainer

    dev = torch.device(device)
    mesh = make_mesh(mesh_shape, mesh_axes)
    frozen = VAEModel(cfg)
    frozen.load_state_dict(vae)
    enc = ViTFeatureEncoder(**encoder["kwargs"])
    trainer = DiTTrainer(cfg.replace(spmd="fsdp"), frozen, enc,
                         encoder["state"], device=dev, mesh=mesh)
    fsdp.load_full_state_dict(trainer.model, dit)
    lead = mesh.rank == 0
    rows, _ = _rows(batch, mesh)
    mine = {k: torch.from_numpy(np.asarray(v)).to(dev)
            for k, v in _rows(draws, mesh)[0].items()}
    with _Tap(dit_trainer, keep=lead) as tap:
        loss = float(trainer.train_step(trainer.to_device(rows), mine)["loss"])
    new = {n: fsdp.full(p.detach()).cpu()
           for n, p in trainer.model.named_parameters()}
    return {"loss": loss, "grads": tap.host[0] if lead else None,
            "params": new if lead else None, "rank": mesh.rank,
            "tensor_parallel": sorted(fsdp.tensor_parallel_plan(
                trainer.model, mesh.model_size))}


def series(runs: Sequence, device="cpu") -> list:
    """Several cases one after another on the same ranks, each a (name,
    kwargs) of this module (``device`` passed on): their results in
    order."""
    import gc

    out = []
    for name, kwargs in runs:
        out.append(globals()[name](**kwargs, device=device))
        gc.collect()            # a sharded trainer's state holds cycles
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
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
            "printed": printed.getvalue(),
            "fsdp": [getattr(t, "fsdp", False) for t in runs]}
