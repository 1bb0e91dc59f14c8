"""DiT training entry point (port of the repository's ``train_DiT.py``).

    python -m sigman_release_torch.train_dit dit --train_list items.npy
    python -m sigman_release_torch.train_dit test_tiny --device cpu \
        --num_epochs 1 --synthetic_items 2 --workspace /tmp/ws

A preset (default ``dit``), then ``--flag value`` overrides of any ``Config``
field, and ``--device`` (default ``cuda``; without CUDA it raises unless
``--device cpu``). The trainer reads the HGS-1M item directories of
``--train_list`` (every item but each hundredth for training, each
hundredth for the eval), or procedural avatars with ``--synthetic_data
true``.

* The frozen VAE starts seeded-random; ``--vae_path`` loads a trained one
  from any of the three state-file formats (``training/checkpoint.py``):
  the VAE trainer's own ``vae_state.pt``, the JAX package's msgpack state
  file (a full train state or bare parameters) or the reference's
  ``autoencoder.safetensors``. A missing file warns, as the JAX script does.
* The conditioning encoder is ``sapiens_1b_encoder()`` when
  ``text_embed_dim == 1536``, else a ``ViTFeatureEncoder`` of that width,
  and the trainer applies that same module. ``--sapiens_path`` loads
  Sapiens weights into the Sapiens-geometry encoder: a JAX-converted
  msgpack parameter tree through ``convert.py``'s ViT map, the port's
  ``convert_sapiens`` output (a state file's ``encoder`` entry), or a
  torchscript file or state dict through ``convert.convert_sapiens``; it
  needs ``text_embed_dim`` 1536.
* ``--resume`` restores this trainer's state file
  (``<workspace>/dit_state.pt``, written every ``save_ckpt_steps`` and at
  the end), the JAX package's msgpack state file, or reference weights.

Data parallelism over ``data``, as in ``train_vae.py``: under ``torchrun``
every process joins the process group its environment describes, DDP
averages the DiT's gradients, ``batch_size`` is per process, each rank
trains on its share of the items and every
rank takes the shortest share's steps per epoch; the eval loss pools every
rank's held-out share, and rank 0 alone samples, prints and writes files:

    torchrun --nproc_per_node 4 -m sigman_release_torch.train_dit dit \
        --train_list items.npy

With ``--spmd fsdp`` the DiT's parameters, gradients and AdamW state are
sharded over ``data`` (FSDP2) and, on a ``model`` axis, its blocks split
Megatron-style (tensor parallelism; the ranks of one data index read the
same items); the step equals one process on the whole batch, draws
included, every rank samples in the eval, and the state file is the one a
single process writes:

    torchrun --nproc_per_node 4 -m sigman_release_torch.train_dit dit \
        --train_list items.npy --spmd fsdp --mesh_shape 2,2 \
        --mesh_axes data,model

Models are built on the device. Metrics go to
``<workspace>/dit_metrics.jsonl``; every ``eval_steps`` the eval loss over
the held-out items (up to 4, in order, the last batch kept whole) and a
sampled avatar rendered against the first (``dit_sample_*.png``).
"""

from __future__ import annotations

import os

import torch

from sigman_release_torch.config import parse_cli
from sigman_release_torch.data.dataset import HGSDataset, SyntheticAvatarDataset
from sigman_release_torch.data.loader import DataLoader, shard_for_host
from sigman_release_torch.parallel.mesh import (
    initialize_multihost,
    is_rank0,
    make_mesh,
)
from sigman_release_torch.models.init import build_on
from sigman_release_torch.train_vae import check_train_list, steps_per_epoch
from sigman_release_torch.training import checkpoint
from sigman_release_torch.training.dit_trainer import (
    DiTTrainer,
    frozen_vae,
    make_encoder,
)
from sigman_release_torch.utils.logging import MetricLogger


def load_encoder(cfg, dev):
    """The conditioning encoder with its weights: converted Sapiens weights
    from ``cfg.sapiens_path``, else seeded random."""
    from sigman_release_torch import convert

    gen = torch.Generator(device=dev).manual_seed(cfg.seed + 1)
    encoder = build_on(dev, lambda: make_encoder(cfg), gen)
    if cfg.sapiens_path:
        if cfg.text_embed_dim != 1536:
            raise ValueError(
                f"--sapiens_path needs text_embed_dim 1536 (the Sapiens-1B "
                f"width), not {cfg.text_embed_dim}")
        if (checkpoint.sniff_format(cfg.sapiens_path) == "msgpack"
                or "encoder" in checkpoint.port_entries(cfg.sapiens_path)):
            sd, stats = checkpoint.load_params_any(cfg.sapiens_path, encoder,
                                                   cfg)
            missing, bad = stats["missing"], stats["mismatched"]
        else:
            sd, stats = convert.convert_sapiens(
                convert.load_sapiens_source(cfg.sapiens_path), encoder,
                verbose=True)
            missing, bad = stats["missing"], stats["mismatches"]
        if missing or bad:
            raise ValueError(
                f"{cfg.sapiens_path}: {len(missing)} encoder parameters "
                f"missing, {len(bad)} mismatched (first: "
                f"{(missing + bad)[:3]})")
        encoder.load_state_dict(sd)
        return encoder
    if is_rank0():
        print("[train_dit] WARNING: no --sapiens_path: the conditioning "
              "encoder is seeded-random", flush=True)
    return encoder


def load_vae(cfg, dev, body_model=None, template=None):
    """The frozen VAE and its ``LatentRenderer`` (on ``body_model`` /
    ``template``, default the configured ones): seeded-random, with the
    weights of ``cfg.vae_path`` when that file exists (any of the three
    formats)."""
    vae, latent_renderer = frozen_vae(cfg, body_model, template, device=dev)
    if cfg.vae_path and os.path.exists(cfg.vae_path):
        sd, _ = checkpoint.load_params_any(cfg.vae_path, vae, cfg)
        vae.load_state_dict(sd)
    elif cfg.vae_path and is_rank0():
        print(f"[train_dit] WARNING: vae_path {cfg.vae_path!r} not found: "
              "training against a seeded-random frozen VAE", flush=True)
    return vae, latent_renderer


def loaders(cfg, mesh=None):
    """(training loader, eval loader) over this data rank's share of the
    items (``mesh``; all of them without): the HGS-1M items of
    ``cfg.train_list`` and its held-out ones, or with ``cfg.synthetic_data``
    procedural avatars and up to 4 held-out ones. The eval set is read in
    order with the last partial batch kept."""
    if cfg.synthetic_data:
        dataset = SyntheticAvatarDataset(cfg, n_items=cfg.synthetic_items,
                                         seed=cfg.seed)
        eval_dataset = SyntheticAvatarDataset(
            cfg, n_items=min(4, cfg.synthetic_items), seed=cfg.seed + 999)
    else:
        check_train_list(cfg)
        dataset = HGSDataset(cfg, training=True)
        eval_dataset = HGSDataset(cfg, training=False)
    for d in (dataset, eval_dataset):
        d.items = shard_for_host(d.items, mesh=mesh)
    loader = DataLoader(dataset, cfg.batch_size, num_workers=cfg.num_workers,
                        seed=cfg.seed)
    eval_loader = DataLoader(eval_dataset, cfg.batch_size, shuffle=False,
                             num_workers=cfg.num_workers, drop_last=False)
    return loader, eval_loader


def main(argv=None, *, body_model=None, template=None):
    """``body_model`` / ``template``: built ones for the sampling eval's
    renderer (default: the configured assets, else the procedural body)."""
    cfg, device = parse_cli(argv, default_preset="dit")
    dev = initialize_multihost(device)
    mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axes)
    loader, eval_loader = loaders(cfg, mesh)
    vae, latent_renderer = load_vae(cfg, dev, body_model, template)
    trainer = DiTTrainer(cfg, vae, load_encoder(cfg, dev),
                         latent_renderer=latent_renderer, device=dev,
                         mesh=mesh)
    ckpt = os.path.join(cfg.workspace, "dit_state.pt")
    if cfg.resume:
        trainer.resume(cfg.resume)
    num_steps = cfg.num_epochs * steps_per_epoch(loader, mesh, cfg)
    with MetricLogger(cfg.workspace, name="dit") as logger:
        logs = trainer.fit(loader, num_steps=num_steps,
                           log_every=cfg.log_every, ckpt_path=ckpt,
                           logger=logger, eval_loader=eval_loader,
                           eval_every=cfg.eval_steps,
                           profile_dir=cfg.profile_dir or None,
                           profile_every=cfg.profile_every)
    if mesh.rank == 0:
        print(f"[dit] {trainer.step} steps on {dev} ({mesh.world} "
              f"rank(s)); last {logs}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
