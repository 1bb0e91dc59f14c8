# Frozen copy of sigman_release_torch/losses/gan.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
"""PatchGAN discriminator + hinge losses (port of the JAX package's
``losses/gan.py``): 3x3 convs, stride 2, GroupNorm (eps 1e-6) in place of
the reference's BatchNorm, LeakyReLU(0.2); views fold into the batch."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn


def _groups(c: int) -> int:
    return math.gcd(32, c)


def disc_layers(output_size: int) -> int:
    """The discriminator's depth for renders of ``output_size``: 4 layers
    at 512^2 like the reference, fewer for small renders."""
    return max(1, min(4, int(math.log2(output_size)) - 3))


class PatchDiscriminator(nn.Module):
    """images [B,V,3,H,W] or [B,3,H,W] -> patch logits [N,1,h,w].

    ``convs.{k}`` / ``norms.{k}`` are the JAX package's ``Conv_k`` /
    ``GroupNorm_k`` in creation order."""

    def __init__(self, ndf: int = 64, n_layers: int = 4):
        super().__init__()
        chans = [ndf] + [ndf * min(2 ** i, 8) for i in range(1, n_layers + 1)]
        convs = [nn.Conv2d(3, ndf, 3, stride=2, padding=1)]
        for i in range(1, n_layers + 1):
            convs.append(nn.Conv2d(chans[i - 1], chans[i], 3,
                                   stride=2 if i < n_layers else 1, padding=1,
                                   bias=False))
        convs.append(nn.Conv2d(chans[-1], 1, 3, padding=1))
        self.convs = nn.ModuleList(convs)
        self.norms = nn.ModuleList(
            nn.GroupNorm(_groups(c), c, eps=1e-6) for c in chans[1:])

    def forward(self, images):
        x = images
        if x.ndim == 5:
            x = x.reshape(-1, *x.shape[2:])
        x = F.leaky_relu(self.convs[0](x), 0.2)
        for conv, norm in zip(self.convs[1:-1], self.norms):
            x = F.leaky_relu(norm(conv(x)), 0.2)
        return self.convs[-1](x)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor):
    """0.5 * (mean relu(1 - real) + mean relu(1 + fake))."""
    return 0.5 * (torch.mean(F.relu(1.0 - logits_real))
                  + torch.mean(F.relu(1.0 + logits_fake)))


def hinge_g_loss(logits_fake: torch.Tensor):
    return -torch.mean(logits_fake)
