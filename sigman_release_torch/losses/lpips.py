"""LPIPS perceptual loss with a VGG16 backbone (port of the JAX package's
``losses/lpips.py``, training-loss net).

VGG16 relu slices 1_2/2_2/3_3/4_3/5_3, channel unit-normalisation, 1x1
linear heads, spatial mean, sum over the five layers. Inputs are in [-1, 1]
and are normalised with the LPIPS shift/scale constants. No converted
weights are in the repository, so the backbone is seeded-random (as the JAX
package without a checkpoint) and the heads start at 1/C, which keeps the
distance nonnegative and zero only for equal inputs. The AlexNet eval
backbone and weight loading are not ported yet.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

VGG_CHANNELS = (64, 128, 256, 512, 512)
VGG_CONVS = (2, 2, 3, 3, 3)        # convs per slice

SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
SCALE = np.array([0.458, 0.448, 0.450], np.float32)


class VGG16Slices(nn.Module):
    """VGG16 feature extractor returning the five relu slice outputs;
    convs named ``conv{slice}_{i}``, 2x2 max-pool between slices."""

    def __init__(self):
        super().__init__()
        cin = 3
        for bi, (n, ch) in enumerate(zip(VGG_CONVS, VGG_CHANNELS)):
            for ci in range(n):
                self.add_module(f"conv{bi}_{ci}",
                                nn.Conv2d(cin, ch, 3, padding=1))
                cin = ch

    def forward(self, x):  # [B,3,H,W] in lpips-normalised space
        outs = []
        for bi, n in enumerate(VGG_CONVS):
            for ci in range(n):
                x = F.relu(getattr(self, f"conv{bi}_{ci}")(x))
            outs.append(x)
            if bi < len(VGG_CONVS) - 1:
                x = F.max_pool2d(x, 2, 2)
        return outs


class LPIPS(nn.Module):
    """lpips(x, y): x/y [B,3,H,W] in [-1,1] -> [B] distances."""

    def __init__(self):
        super().__init__()
        self.vgg = VGG16Slices()
        self.lins = nn.ModuleList(nn.Conv2d(c, 1, 1, bias=False)
                                  for c in VGG_CHANNELS)
        self.register_buffer("shift", torch.from_numpy(SHIFT)[None, :, None,
                                                                None],
                             persistent=False)
        self.register_buffer("scale", torch.from_numpy(SCALE)[None, :, None,
                                                                None],
                             persistent=False)
        self.init_heads()

    @torch.no_grad()
    def init_heads(self):
        """Heads at 1/C: without converted weights the distance stays
        nonnegative and zero only for equal inputs."""
        for lin, c in zip(self.lins, VGG_CHANNELS):
            lin.weight.fill_(1.0 / c)

    def forward(self, x, y):
        fx = self.vgg((x - self.shift) / self.scale)
        fy = self.vgg((y - self.shift) / self.scale)
        total = 0.0
        for lin, a, b in zip(self.lins, fx, fy):
            a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            total = total + torch.mean(lin((a - b) ** 2), dim=(1, 2, 3))
        return total
