"""VAE training entry point (port of the repository's ``train_vae.py``).

    python -m sigman_release_torch.train_vae vae_b --synthetic_data true
    python -m sigman_release_torch.train_vae test_tiny --device cpu \
        --num_epochs 1 --synthetic_items 2 --workspace /tmp/ws

A preset, then ``--flag value`` overrides of any ``Config`` field, and
``--device`` (default ``cuda``; without CUDA it raises unless ``--device
cpu``). Weights start seeded-random (``--seed``); ``--resume`` restores a
state file first: this trainer's own (everything), the JAX package's
msgpack state file (a full train state, or bare parameters) or the
reference's ``autoencoder.safetensors`` (parameters only). Until HGS-1M
data is in the repository the trainer needs ``--synthetic_data true``: it
trains on procedural avatars (``data/dataset.py``) and evaluates on two
held-out ones every ``eval_steps`` steps. Metrics go to
``<workspace>/vae_metrics.jsonl``, eval images to
``<workspace>/eval_<step>.png``, and the state to
``<workspace>/vae_state.pt`` every ``save_ckpt_steps`` steps and at the end.
"""

from __future__ import annotations

import os

from sigman_release_torch.config import parse_cli
from sigman_release_torch.data.dataset import SyntheticAvatarDataset
from sigman_release_torch.data.loader import DataLoader
from sigman_release_torch.device import resolve_device
from sigman_release_torch.training.vae_trainer import VAETrainer
from sigman_release_torch.utils.logging import MetricLogger


def main(argv=None):
    cfg, device = parse_cli(argv, default_preset="vae_b")
    dev = resolve_device(device)
    if not cfg.synthetic_data:
        raise SystemExit(
            "the HGS-1M reader is not ported and no HGS-1M data is in the "
            "repository: pass --synthetic_data true to train on procedural "
            "avatars")
    trainer = VAETrainer(cfg, device=dev)
    if cfg.resume:
        trainer.resume(cfg.resume)
    loader = DataLoader(SyntheticAvatarDataset(cfg, n_items=cfg.synthetic_items,
                                               seed=cfg.seed),
                        cfg.batch_size, num_workers=cfg.num_workers,
                        seed=cfg.seed)
    eval_loader = DataLoader(SyntheticAvatarDataset(cfg, n_items=2, seed=999),
                             cfg.batch_size, shuffle=False, num_workers=1,
                             drop_last=False)
    num_steps = cfg.num_epochs * max(1, len(loader))
    with MetricLogger(cfg.workspace, name="vae") as logger:
        logs = trainer.fit(loader, num_steps=num_steps,
                           log_every=cfg.log_every,
                           ckpt_path=os.path.join(cfg.workspace,
                                                  "vae_state.pt"),
                           logger=logger, eval_loader=eval_loader,
                           eval_every=cfg.eval_steps)
    print(f"[vae] {trainer.step} steps on {dev}; last {logs}", flush=True)
    return trainer


if __name__ == "__main__":
    main()
