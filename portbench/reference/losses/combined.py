# Frozen copy of sigman_release_torch/losses/combined.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
"""Combined VAE training loss: L1 + LPIPS + KL + hinge GAN (port of the JAX
package's ``losses/combined.py``).

The GAN gate is a Python branch on the step: before ``disc_start`` the
PatchGAN forward does not run and the term is 0, which equals the JAX
package's ``where`` in value and gradient.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from portbench.reference.config import Config
from portbench.reference.losses.gan import hinge_d_loss, hinge_g_loss
from portbench.reference.models.vae import DiagonalGaussian


def resize_for_lpips(x: torch.Tensor, size: int) -> torch.Tensor:
    """[N,3,H,W] -> [N,3,size,size] bilinear. Antialiased when it shrinks,
    as the JAX package's resize is (vae_b resizes 512 -> 256)."""
    if x.shape[-2:] == (size, size):
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


class VAELoss:
    """Generator and discriminator objectives; the LPIPS net and the
    discriminator are modules the trainer owns."""

    def __init__(self, cfg: Config, lpips=None, discriminator=None):
        self.cfg = cfg
        self.lpips = lpips
        self.disc = discriminator

    def generator(self, outputs: Dict[str, torch.Tensor],
                  posterior: DiagonalGaussian, global_step: int,
                  logvar: torch.Tensor
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        cfg = self.cfg
        pred = outputs["images_pred"]   # [B,V,3,H,W]
        gt = outputs["images_gt"]
        masks = outputs["masks_gt"]     # [B,V,1,H,W]
        pred_f = pred.reshape(-1, *pred.shape[2:])
        gt_f = gt.reshape(-1, *gt.shape[2:])
        m_f = masks.reshape(-1, *masks.shape[2:])

        loss_l1 = torch.mean(torch.abs(pred_f * m_f - gt_f * m_f))
        if cfg.lambda_lpips > 0 and self.lpips is not None:
            loss_lpips = torch.mean(self.lpips(
                resize_for_lpips(gt_f, cfg.lpips_size) * 2.0 - 1.0,
                resize_for_lpips(pred_f, cfg.lpips_size) * 2.0 - 1.0))
        else:
            loss_lpips = pred.new_zeros(())
        loss_rec = loss_l1 + cfg.lambda_lpips * loss_lpips
        nll = loss_rec / torch.exp(logvar) + logvar
        loss_kl = torch.mean(posterior.kl()) * cfg.lambda_kl
        if self.disc is not None and global_step >= cfg.disc_start:
            gan_term = (cfg.disc_weight * cfg.disc_factor
                        * hinge_g_loss(self.disc(pred)))
        else:
            gan_term = pred.new_zeros(())
        loss = nll + loss_kl + gan_term
        logs = {"L1": loss_l1, "lpips": loss_lpips, "kl": loss_kl,
                "GAN_G": gan_term, "loss": loss}
        return loss, logs

    def discriminator(self, outputs: Dict[str, torch.Tensor],
                           global_step: int, disc=None
                           ) -> Tuple[Optional[torch.Tensor],
                                      Dict[str, torch.Tensor]]:
        """Hinge loss on the detached renders through ``disc`` (default the
        loss's discriminator; the trainer passes its DDP); ``None`` (a zero
        loss with zero gradients) before ``disc_start``."""
        cfg = self.cfg
        if global_step < cfg.disc_start:
            return None, {"GAN_D": outputs["images_pred"].new_zeros(())}
        disc = self.disc if disc is None else disc
        logits_real = disc(outputs["images_gt"].detach())
        logits_fake = disc(outputs["images_pred"].detach())
        d_loss = cfg.disc_factor * hinge_d_loss(logits_real, logits_fake)
        return d_loss, {"GAN_D": d_loss}
