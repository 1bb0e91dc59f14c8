"""VAE training entry point (port of the repository's ``train_vae.py``).

    python -m sigman_release_torch.train_vae vae_b --train_list items.npy
    python -m sigman_release_torch.train_vae test_tiny --device cpu \
        --num_epochs 1 --synthetic_items 2 --workspace /tmp/ws

A preset, then ``--flag value`` overrides of any ``Config`` field, and
``--device`` (default ``cuda``; without CUDA it raises unless ``--device
cpu``). Weights start seeded-random (``--seed``); ``--resume`` restores a
state file first: this trainer's own (everything), the JAX package's
msgpack state file (a full train state, or bare parameters) or the
reference's ``autoencoder.safetensors`` (parameters only). It reads the
HGS-1M item directories that ``--train_list`` (a ``.npy`` of paths) lists:
every item but each hundredth for training, each hundredth (at most 2000)
for the eval every ``eval_steps`` steps (``data/dataset.py``). With
``--synthetic_data true`` it trains on ``--synthetic_items`` procedural
avatars instead and evaluates on two held-out ones. Metrics go to
``<workspace>/vae_metrics.jsonl``, eval images to
``<workspace>/eval_<step>.png``, and the state to
``<workspace>/vae_state.pt`` every ``save_ckpt_steps`` steps and at the end.

Data parallelism: under ``torchrun`` every process joins the process group
its environment describes (``parallel/mesh.py``) and lays the world out by
``--mesh_shape`` / ``--mesh_axes`` (default ``-1`` over ``data``; ``-1,2``
over ``data,view`` renders half the views on each rank of a pair):

    torchrun --nproc_per_node 4 -m sigman_release_torch.train_vae vae_b \
        --train_list items.npy --mesh_shape -1,2 --mesh_axes data,view

``batch_size`` is per process, as under the reference's ``accelerate``.
Each data rank trains on its share of the items and evaluates on its share
of the held-out ones; every rank takes
``num_epochs`` x the shortest share's batches per epoch. Only rank 0
prints and writes files.
"""

from __future__ import annotations

import os

from sigman_release_torch.config import parse_cli
from sigman_release_torch.data.dataset import HGSDataset, SyntheticAvatarDataset
from sigman_release_torch.data.loader import DataLoader, shard_for_host
from sigman_release_torch.parallel.mesh import initialize_multihost, make_mesh
from sigman_release_torch.training.vae_trainer import VAETrainer
from sigman_release_torch.utils.logging import MetricLogger


def datasets(cfg):
    """(training set, eval set): the HGS-1M items of ``cfg.train_list``, or
    procedural avatars with ``cfg.synthetic_data``."""
    if cfg.synthetic_data:
        return (SyntheticAvatarDataset(cfg, n_items=cfg.synthetic_items,
                                       seed=cfg.seed),
                SyntheticAvatarDataset(cfg, n_items=2, seed=999))
    check_train_list(cfg)
    return HGSDataset(cfg, training=True), HGSDataset(cfg, training=False)


def check_train_list(cfg):
    if not os.path.exists(cfg.train_list):
        raise SystemExit(
            f"no item list at --train_list {cfg.train_list!r}: pass a .npy "
            "of HGS-1M item directories, or --synthetic_data true to train "
            "on procedural avatars")


def main(argv=None, *, body_model=None, template=None):
    """``body_model`` / ``template``: built ones to train on (default: the
    configured assets, else the procedural body)."""
    cfg, device = parse_cli(argv, default_preset="vae_b")
    dev = initialize_multihost(device)
    mesh = make_mesh(cfg.mesh_shape, cfg.mesh_axes)
    dataset, eval_dataset = datasets(cfg)
    for d in (dataset, eval_dataset):
        d.items = shard_for_host(d.items, mesh=mesh)
    trainer = VAETrainer(cfg, body_model=body_model, template=template,
                         device=dev, mesh=mesh)
    if cfg.resume:
        trainer.resume(cfg.resume)
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
                           eval_every=cfg.eval_steps,
                           profile_dir=cfg.profile_dir or None,
                           profile_every=cfg.profile_every)
    if mesh.rank == 0:
        print(f"[vae] {trainer.step} steps on {dev} ({mesh.world} "
              f"rank(s)); last {logs}", flush=True)
    return trainer


def steps_per_epoch(loader, mesh, cfg) -> int:
    """The batches of the shortest rank's share: the steps every rank takes
    per epoch, so that none waits in a collective for another."""
    steps = mesh.min_int(len(loader))
    if steps < 1:
        items = mesh.min_int(len(loader.dataset))
        raise SystemExit(
            f"{items} item(s) in the smallest of {mesh.data_size} data "
            f"rank(s)' shares: less than a batch of {cfg.batch_size}")
    return steps


if __name__ == "__main__":
    main()
