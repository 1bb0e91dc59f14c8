"""VAE evaluation entry point (port of the repository's
``scripts/test_vae.py``): encode -> posterior mean -> decode -> render ->
PSNR, masked PSNR, SSIM, LPIPS against the ground-truth views.

    python -m sigman_release_torch.test_vae vae_b --train_list items.npy \
        --resume vae_state.pt
    python -m sigman_release_torch.test_vae test_tiny --device cpu

A preset (default ``vae_b``), then ``--flag value`` overrides of any
``Config`` field, and ``--device`` (default ``cuda``). ``--resume`` loads a
state file in any format ``training/checkpoint.py`` reads (the VAE
trainer's own, the JAX package's msgpack state, the reference's
safetensors); without it the weights are seeded-random. The items are the
held-out HGS-1M items of ``--train_list``, or 4 procedural avatars with
``--synthetic_data true``. Each batch goes through ``VAETrainer.eval_step``;
the first 4 batches' GT | prediction grids go to
``<workspace>/eval_vis_XX.png``. Prints the mean of each metric over the
batches and their count.
"""

from __future__ import annotations

import os

import numpy as np

from sigman_release_torch.config import parse_cli
from sigman_release_torch.data.dataset import HGSDataset, SyntheticAvatarDataset
from sigman_release_torch.data.loader import DataLoader
from sigman_release_torch.training.vae_trainer import VAETrainer
from sigman_release_torch.utils.visualize import save_visualization


def main(argv=None, *, body_model=None, template=None):
    """Returns {metric: mean over the batches} and the count as
    ``batches``. ``body_model`` / ``template``: built ones to render with
    (default: the configured assets, else the procedural body)."""
    cfg, device = parse_cli(argv, default_preset="vae_b")
    trainer = VAETrainer(cfg, body_model=body_model, template=template,
                         device=device)
    if cfg.resume and os.path.exists(cfg.resume):
        trainer.resume(cfg.resume)
    if cfg.synthetic_data:
        dataset = SyntheticAvatarDataset(cfg, n_items=4)
    else:
        dataset = HGSDataset(cfg, training=False)
    loader = DataLoader(dataset, cfg.batch_size, shuffle=False,
                        num_workers=cfg.num_workers, drop_last=False)
    sums = {}
    for i, batch in enumerate(loader):
        metrics, outputs = trainer.eval_step(trainer.to_device(batch))
        for k, v in metrics.items():
            sums.setdefault(k, []).append(float(v))
        if i < 4:
            save_visualization(
                {k: outputs[k].float().cpu().numpy()
                 for k in ("images_pred", "images_gt")},
                os.path.join(cfg.workspace, f"eval_vis_{i:02d}.png"))
    n = len(next(iter(sums.values()), []))
    means = {k: float(np.mean(v)) for k, v in sums.items()}
    print("  ".join(f"{k} {v:.4f}" for k, v in means.items())
          + f"  ({n} batches)", flush=True)
    return {**means, "batches": n}


if __name__ == "__main__":
    main()
