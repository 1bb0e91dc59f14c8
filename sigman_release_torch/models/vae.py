"""UV-space Gaussian VAE, decode side (port of
the JAX package's ``models/vae.py``).

* decoder: conv_in + 4 UpBlock2D (channels 1024/512/512/256, 4 resnets each,
  x2 nearest upsample between) + GroupNorm/SiLU/conv_out, from the 64x64
  latent to the ``vae_out_channels`` UV feature map,
* heads: 3x3 convs geo (10 ch: opacity 1 + offset 3 + scale 3 + rot 3) and
  rgb (3 ch) with the reference's activations,
* ``sample_gaussian_attrs`` fetches per-Gaussian attributes at the template
  UVs; ``compose_rotations`` builds the deformed Gaussian frames.

Modules compute in NCHW; the public functions keep the JAX package's
channels-last layout (``z [B,h,w,C]`` -> attribute map ``[B,H,W,13]``).
Parameter names follow the reference checkpoint
(``autoencoder.decoder.up_blocks.{i}.resnets.{j}.conv1`` ...). GroupNorm
uses eps 1e-6 and ``gcd(32, C)`` groups, as Flax does here.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from sigman_release_torch.config import Config
from sigman_release_torch.ops.grid_sample import grid_sample_2d
from sigman_release_torch.ops.rotations import rodrigues


def _num_groups(channels: int, cap: int = 32) -> int:
    """Largest divisor of ``channels`` that is <= cap (GroupNorm groups)."""
    return math.gcd(cap, channels)


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(_num_groups(channels), channels, eps=1e-6)


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    """3x3 conv with Flax "SAME" padding (symmetric 1 for an odd kernel)."""
    return nn.Conv2d(cin, cout, 3, padding=1)


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv -> GN -> SiLU -> conv with 1x1 shortcut (2D)."""

    def __init__(self, in_channels: int, out_channels: int):
        super().__init__()
        self.norm1 = group_norm(in_channels)
        self.conv1 = conv3x3(in_channels, out_channels)
        self.norm2 = group_norm(out_channels)
        self.conv2 = conv3x3(out_channels, out_channels)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h


class Upsample2D(nn.Module):
    """x2 nearest upsample + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UpBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_resnets: int,
                 upsample: bool):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels)
            for j in range(n_resnets))
        self.upsamplers = nn.ModuleList(
            [Upsample2D(out_channels)] if upsample else [])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for u in self.upsamplers:
            x = u(x)
        return x


class Decoder2D(nn.Module):
    """conv_in + 4 UpBlock2D + norm/act/conv_out (NCHW)."""

    def __init__(self, in_channels: int, out_channels: int,
                 block_channels: Sequence[int] = (256, 512, 512, 1024),
                 layers_per_block: int = 3):
        super().__init__()
        chans = list(reversed(block_channels))
        self.conv_in = conv3x3(in_channels, chans[0])
        self.up_blocks = nn.ModuleList(
            UpBlock2D(chans[max(i - 1, 0)], ch, layers_per_block + 1,
                      upsample=i < len(chans) - 1)
            for i, ch in enumerate(chans))
        self.norm_out = group_norm(chans[-1])
        self.conv_out = conv3x3(chans[-1], out_channels)

    def forward(self, z):  # [B, latent, h, w]
        x = self.conv_in(z)
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.norm_out(x)))


class ConvVAE(nn.Module):
    """The decode half of the reference's Conv_VAE."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.decoder = Decoder2D(cfg.latent_channels, cfg.vae_out_channels,
                                 cfg.decoder_channels)


class GaussianHeads(nn.Module):
    """UV features -> the 13-channel attribute map (opacity 1, offset 3,
    rgb 3, scale 3, rot 3) before grid sampling, activations applied."""

    def __init__(self, in_channels: int):
        super().__init__()
        self.half = in_channels // 2
        self.decode_gaussian_geo = conv3x3(self.half, 10)
        self.decode_gaussian_rgb = conv3x3(in_channels - self.half, 3)

    def forward(self, feats):  # [B,C,H,W]
        geo = self.decode_gaussian_geo(feats[:, :self.half])
        rgb = torch.sigmoid(self.decode_gaussian_rgb(feats[:, self.half:]))
        return torch.cat([torch.sigmoid(geo[:, 0:1]), geo[:, 1:4],
                          rgb, torch.sigmoid(geo[:, 4:10])], dim=1)


class VAEModel(nn.Module):
    """Decoder + Gaussian heads (the encoder side is not ported yet)."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.autoencoder = ConvVAE(cfg)
        self.heads = GaussianHeads(cfg.vae_out_channels)

    def decode(self, z: torch.Tensor) -> torch.Tensor:
        """z [B,h,w,Cl] -> attribute map [B,H,W,13]."""
        feats = self.autoencoder.decoder(z.permute(0, 3, 1, 2))
        return self.heads(feats).permute(0, 2, 3, 1)


SIGMOID_SATURATION = 0.001


def sample_gaussian_attrs(attr_map: torch.Tensor, uv: torch.Tensor):
    """Fetch per-Gaussian attributes from the UV attribute map.

    attr_map [B,H,W,13]; uv [N,2] in [0,1] (template init_uv): coords scaled
    to [-1,1], y flipped, bilinear, border padding, align_corners=False.
    Returns dict of [B,N,*] attribute tensors with post-sample activations.
    """
    coord = (uv * 2.0 - 1.0) * uv.new_tensor([1.0, -1.0])
    out = torch.stack([grid_sample_2d(m, coord, align_corners=False)
                       for m in attr_map.permute(0, 3, 1, 2)])  # [B,13,N]
    out = out.transpose(1, 2)                                   # [B,N,13]
    return {
        "opacity": out[..., 0:1],
        "offset": out[..., 1:4],
        "rgb": out[..., 4:7] * (1 + SIGMOID_SATURATION * 2)
        - SIGMOID_SATURATION,
        "scale": (out[..., 7:10] - 0.5) * 2.0,
        "rot": (out[..., 10:13] - 0.5) * math.pi,
    }


def compose_rotations(rot_delta: torch.Tensor, init_rot: torch.Tensor,
                      tfs: torch.Tensor) -> torch.Tensor:
    """R_def = tfs[:3,:3] @ init_rot @ rodrigues(rot_delta).

    rot_delta [B,N,3] axis-angle; init_rot [N,3,3]; tfs [B,N,4,4].
    """
    R = torch.einsum("nij,bnjk->bnik", init_rot, rodrigues(rot_delta))
    return torch.einsum("bnij,bnjk->bnik", tfs[..., :3, :3], R)
