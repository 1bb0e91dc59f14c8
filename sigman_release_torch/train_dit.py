"""DiT training entry point (port of the repository's ``train_DiT.py``).

    python -m sigman_release_torch.train_dit dit --synthetic_data true
    python -m sigman_release_torch.train_dit test_tiny --device cpu \
        --num_epochs 1 --synthetic_items 2 --workspace /tmp/ws

A preset (default ``dit``), then ``--flag value`` overrides of any ``Config``
field, and ``--device`` (default ``cuda``; without CUDA it raises unless
``--device cpu``). Until HGS-1M data is in the repository the trainer needs
``--synthetic_data true``: it trains on procedural avatars.

* The frozen VAE starts seeded-random; ``--vae_path`` names a trained one,
  but its formats (the JAX package's msgpack, the reference's safetensors)
  wait for ``training/checkpoint.py``: an existing file raises, a missing
  one warns, as the JAX script does.
* The conditioning encoder is ``sapiens_1b_encoder()`` when
  ``text_embed_dim == 1536``, else a ``ViTFeatureEncoder`` of that width,
  and the trainer applies that same module. ``--sapiens_path`` loads
  Sapiens weights (torchscript or state dict) into the Sapiens-geometry
  encoder through ``convert.convert_sapiens``; it needs
  ``text_embed_dim`` 1536.
* ``--resume`` restores a state file of this trainer
  (``<workspace>/dit_state.pt``, written every ``save_ckpt_steps`` and at
  the end).

Models are built on the device. Metrics go to
``<workspace>/dit_metrics.jsonl``; every ``eval_steps`` the eval loss and a
sampled avatar rendered against the held-out item (``dit_sample_*.png``).
"""

from __future__ import annotations

import os

import torch

from sigman_release_torch.config import parse_cli
from sigman_release_torch.data.dataset import SyntheticAvatarDataset
from sigman_release_torch.data.loader import DataLoader
from sigman_release_torch.device import resolve_device
from sigman_release_torch.training.dit_trainer import (
    DiTTrainer,
    build_on,
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
        sd, stats = convert.convert_sapiens(
            convert.load_sapiens_source(cfg.sapiens_path), encoder,
            verbose=True)
        if stats["missing"] or stats["mismatches"]:
            raise ValueError(
                f"{cfg.sapiens_path}: {len(stats['missing'])} encoder "
                f"parameters missing, {len(stats['mismatches'])} mismatched "
                f"(first: {(stats['missing'] + stats['mismatches'])[:3]})")
        encoder.load_state_dict(sd)
        return encoder
    print("[train_dit] WARNING: no --sapiens_path: the conditioning encoder "
          "is seeded-random", flush=True)
    return encoder


def main(argv=None):
    cfg, device = parse_cli(argv, default_preset="dit")
    dev = resolve_device(device)
    if not cfg.synthetic_data:
        raise SystemExit(
            "the HGS-1M reader is not ported and no HGS-1M data is in the "
            "repository: pass --synthetic_data true to train on procedural "
            "avatars")
    if cfg.vae_path and os.path.exists(cfg.vae_path):
        raise NotImplementedError(
            f"{cfg.vae_path}: reading VAE checkpoints (msgpack, safetensors) "
            f"waits for the port of training/checkpoint.py")
    if cfg.vae_path:
        print(f"[train_dit] WARNING: vae_path {cfg.vae_path!r} not found: "
              "training against a seeded-random frozen VAE", flush=True)

    vae, latent_renderer = frozen_vae(cfg, device=dev)
    trainer = DiTTrainer(cfg, vae, load_encoder(cfg, dev),
                         latent_renderer=latent_renderer, device=dev)
    ckpt = os.path.join(cfg.workspace, "dit_state.pt")
    if cfg.resume:
        trainer.resume(cfg.resume)

    dataset = SyntheticAvatarDataset(cfg, n_items=cfg.synthetic_items,
                                     seed=cfg.seed)
    eval_dataset = SyntheticAvatarDataset(
        cfg, n_items=min(4, cfg.synthetic_items), seed=cfg.seed + 999)
    loader = DataLoader(dataset, cfg.batch_size, num_workers=cfg.num_workers,
                        seed=cfg.seed)
    eval_loader = DataLoader(eval_dataset, cfg.batch_size,
                             num_workers=cfg.num_workers, seed=cfg.seed)
    num_steps = cfg.num_epochs * max(1, len(loader))
    with MetricLogger(cfg.workspace, name="dit") as logger:
        logs = trainer.fit(loader, num_steps=num_steps,
                           log_every=cfg.log_every, ckpt_path=ckpt,
                           logger=logger, eval_loader=eval_loader,
                           eval_every=cfg.eval_steps)
    print(f"[dit] {trainer.step} steps on {dev}; last {logs}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
