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

Data parallelism: under ``torchrun`` every process joins the process group
its environment describes (``parallel/mesh.py``) and lays the world out by
``--mesh_shape`` / ``--mesh_axes`` (default ``-1`` over ``data``; ``-1,2``
over ``data,view`` renders half the views on each rank of a pair):

    torchrun --nproc_per_node 4 -m sigman_release_torch.train_vae vae_b \
        --synthetic_data true --mesh_shape -1,2 --mesh_axes data,view

``batch_size`` is per process, as under the reference's ``accelerate``.
Each data rank trains on its share of the items (the synthetic ones
included) and evaluates on its share of the held-out ones; every rank takes
``num_epochs`` x the shortest share's batches per epoch. Only rank 0
prints and writes files.
"""

from __future__ import annotations

import os

from sigman_release_torch.config import parse_cli
from sigman_release_torch.data.dataset import SyntheticAvatarDataset
from sigman_release_torch.data.loader import DataLoader, shard_for_host
from sigman_release_torch.parallel.mesh import initialize_multihost, make_mesh
from sigman_release_torch.training.vae_trainer import VAETrainer
from sigman_release_torch.utils.logging import MetricLogger


def main(argv=None):
    cfg, device = parse_cli(argv, default_preset="vae_b")
    dev = initialize_multihost(device)
    if not cfg.synthetic_data:
        raise SystemExit(
            "the HGS-1M reader is not ported and no HGS-1M data is in the "
            "repository: pass --synthetic_data true to train on procedural "
            "avatars")
    mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axes)
    trainer = VAETrainer(cfg, device=dev, mesh=mesh)
    if cfg.resume:
        trainer.resume(cfg.resume)
    dataset = SyntheticAvatarDataset(cfg, n_items=cfg.synthetic_items,
                                     seed=cfg.seed)
    dataset.items = shard_for_host(dataset.items, mesh=mesh)
    eval_dataset = SyntheticAvatarDataset(cfg, n_items=2, seed=999)
    eval_dataset.items = shard_for_host(eval_dataset.items, mesh=mesh)
    loader = DataLoader(dataset, cfg.batch_size, num_workers=cfg.num_workers,
                        seed=cfg.seed)
    eval_loader = DataLoader(eval_dataset, cfg.batch_size, shuffle=False,
                             num_workers=1, drop_last=False)
    num_steps = cfg.num_epochs * steps_per_epoch(loader, mesh, cfg)
    with MetricLogger(cfg.workspace, name="vae") as logger:
        logs = trainer.fit(loader, num_steps=num_steps,
                           log_every=cfg.log_every,
                           ckpt_path=os.path.join(cfg.workspace,
                                                  "vae_state.pt"),
                           logger=logger, eval_loader=eval_loader,
                           eval_every=cfg.eval_steps)
    if mesh.rank == 0:
        print(f"[vae] {trainer.step} steps on {dev} ({mesh.world} "
              f"rank(s)); last {logs}", flush=True)
    return trainer


def steps_per_epoch(loader, mesh, cfg) -> int:
    """The batches of the shortest rank's share: the steps every rank takes
    per epoch, so that none waits in a collective for another."""
    steps = mesh.min_int(len(loader))
    if steps < 1:
        raise SystemExit(
            f"{cfg.synthetic_items} items do not give each of "
            f"{mesh.data_size} data rank(s) a batch of {cfg.batch_size}")
    return steps


if __name__ == "__main__":
    main()
