# Frozen copy of sigman_release_torch/losses/lpips.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
"""LPIPS perceptual distance with a VGG16 or AlexNet backbone (port of
the JAX package's ``losses/lpips.py``).

Backbone relu slices (VGG16 1_2/2_2/3_3/4_3/5_3 for the training loss;
AlexNet relu1-5, the reference's eval net, with ``net="alex"``), channel
unit-normalisation, 1x1 linear heads, spatial mean, sum over the five
layers. Inputs are in [-1, 1] and are normalised with the LPIPS shift/scale
constants. No converted weights are in the repository, so the backbone is
seeded-random (as the JAX package without a checkpoint) and the heads start
at 1/C, which keeps the distance nonnegative and zero only for equal
inputs; ``load_lpips_params`` reads a torchvision trunk and the richzhang
heads from files.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

VGG_CHANNELS = (64, 128, 256, 512, 512)
VGG_CONVS = (2, 2, 3, 3, 3)        # convs per slice
ALEX_CHANNELS = (64, 192, 384, 256, 256)
# (kernel, stride, padding) of AlexNet's five convs, one per slice
ALEX_CONVS = ((11, 4, 2), (5, 1, 2), (3, 1, 1), (3, 1, 1), (3, 1, 1))
# the convs' indices in torchvision's ``vgg16().features`` /
# ``alexnet().features``
VGG_FEATURES = (0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28)
ALEX_FEATURES = (0, 3, 6, 8, 10)

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


class AlexSlices(nn.Module):
    """AlexNet feature extractor returning the five relu outputs
    (torchvision ``alexnet().features`` geometry): conv 11x11/4 pad 2,
    3x3/2 max-pool, conv 5x5 pad 2, 3x3/2 max-pool, three 3x3 convs; convs
    named ``conv{i}``."""

    def __init__(self):
        super().__init__()
        cin = 3
        for i, ((k, st, pad), ch) in enumerate(zip(ALEX_CONVS,
                                                   ALEX_CHANNELS)):
            self.add_module(f"conv{i}", nn.Conv2d(cin, ch, k, stride=st,
                                                  padding=pad))
            cin = ch

    def forward(self, x):  # [B,3,H,W] in lpips-normalised space
        outs = []
        for i in range(len(ALEX_CONVS)):
            if i in (1, 2):
                x = F.max_pool2d(x, 3, 2)
            x = F.relu(getattr(self, f"conv{i}")(x))
            outs.append(x)
        return outs


class LPIPS(nn.Module):
    """lpips(x, y): x/y [B,3,H,W] in [-1,1] -> [B] distances; the backbone
    is ``self.vgg`` (``net="vgg"``) or ``self.alex`` (``net="alex"``)."""

    def __init__(self, net: str = "vgg"):
        super().__init__()
        if net not in ("vgg", "alex"):
            raise ValueError(f"LPIPS net {net!r}: 'vgg' or 'alex'")
        self.net = net
        self.channels = VGG_CHANNELS if net == "vgg" else ALEX_CHANNELS
        setattr(self, net, VGG16Slices() if net == "vgg" else AlexSlices())
        self.lins = nn.ModuleList(nn.Conv2d(c, 1, 1, bias=False)
                                  for c in self.channels)
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
        for lin, c in zip(self.lins, self.channels):
            lin.weight.fill_(1.0 / c)

    @property
    def backbone(self) -> nn.Module:
        return getattr(self, self.net)

    def forward(self, x, y):
        fx = self.backbone((x - self.shift) / self.scale)
        fy = self.backbone((y - self.shift) / self.scale)
        total = 0.0
        for lin, a, b in zip(self.lins, fx, fy):
            a = a / torch.sqrt(torch.sum(a * a, dim=1, keepdim=True) + 1e-10)
            b = b / torch.sqrt(torch.sum(b * b, dim=1, keepdim=True) + 1e-10)
            total = total + torch.mean(lin((a - b) ** 2), dim=(1, 2, 3))
        return total


def load_lpips_params(backbone_path: Optional[str] = None,
                      lin_path: Optional[str] = None,
                      net: str = "vgg") -> Optional[Dict[str, torch.Tensor]]:
    """A state dict for ``LPIPS(net)`` from a torchvision ``vgg16`` /
    ``alexnet`` state dict (``features.{i}.weight`` / ``.bias``) and the
    richzhang heads (``lin{i}.model.1.weight``), or None without
    ``backbone_path`` (the caller keeps its seeded weights). Without
    ``lin_path`` every head is 1/C. Port of the JAX package's
    ``load_lpips_params``; the files are read with ``weights_only``."""
    if not backbone_path:
        return None
    if net not in ("vgg", "alex"):
        raise ValueError(f"LPIPS net {net!r}: 'vgg' or 'alex'")
    sd = torch.load(backbone_path, map_location="cpu", weights_only=True)
    if net == "alex":
        names = [f"conv{i}" for i in range(len(ALEX_CONVS))]
        idx, chns = ALEX_FEATURES, ALEX_CHANNELS
    else:
        names = [f"conv{bi}_{ci}" for bi, n in enumerate(VGG_CONVS)
                 for ci in range(n)]
        idx, chns = VGG_FEATURES, VGG_CHANNELS
    out = {}
    for name, i in zip(names, idx):
        out[f"{net}.{name}.weight"] = sd[f"features.{i}.weight"]
        out[f"{net}.{name}.bias"] = sd[f"features.{i}.bias"]
    lin_sd = (torch.load(lin_path, map_location="cpu", weights_only=True)
              if lin_path else None)
    for i, c in enumerate(chns):
        out[f"lins.{i}.weight"] = (
            lin_sd[f"lin{i}.model.1.weight"] if lin_sd is not None
            else torch.full((1, c, 1, 1), 1.0 / c))
    return out
