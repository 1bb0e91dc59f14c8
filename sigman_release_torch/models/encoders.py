"""Image conditioning encoder (port of the JAX package's ``models/encoders.py``).

``ViTFeatureEncoder`` is the Sapiens stand-in: a patch ViT emitting a
``[B, embed_dim, H/p, W/p]`` feature map (1536 channels at the reference
width), with a fixed 2D sincos position table. As in the JAX package (Flax
defaults): LayerNorm eps 1e-6, exact (erf) GELU, and a head count lowered
until it divides the width (small test widths).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sigman_release_torch.models.dit import sincos_2d


class SelfAttention(nn.Module):
    """Flax ``MultiHeadDotProductAttention`` with q/k/v/out projections."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)

    def forward(self, x):
        b, s, d = x.shape

        def split(t):
            return t.reshape(b, s, self.heads, d // self.heads).transpose(1, 2)

        o = F.scaled_dot_product_attention(
            split(self.query(x)), split(self.key(x)), split(self.value(x)))
        return self.out(o.transpose(1, 2).reshape(b, s, d))


class ViTBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = SelfAttention(dim, heads)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)
        self.ffn1 = nn.Linear(dim, dim * 4)
        self.ffn2 = nn.Linear(dim * 4, dim)

    def forward(self, x):
        x = x + self.attn(self.ln1(x))
        return x + self.ffn2(F.gelu(self.ffn1(self.ln2(x))))


class ViTFeatureEncoder(nn.Module):
    """Patch ViT -> spatial feature map [B, embed_dim, H/p, W/p]."""

    def __init__(self, embed_dim: int = 1536, depth: int = 8, heads: int = 12,
                 patch_size: int = 16):
        super().__init__()
        while embed_dim % heads:
            heads -= 1
        self.patch_proj = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.blocks = nn.ModuleList(ViTBlock(embed_dim, heads)
                                    for _ in range(depth))
        self.norm_out = nn.LayerNorm(embed_dim, eps=1e-6)

    def forward(self, images):  # [B,3,H,W] (ImageNet-normalized)
        x = self.patch_proj(images.to(self.patch_proj.weight.dtype))
        b, d, gh, gw = x.shape
        x = x.flatten(2).transpose(1, 2)
        pos = torch.as_tensor(sincos_2d(d, gh, gw), device=x.device)
        x = x + pos[None].to(x.dtype)
        for block in self.blocks:
            x = block(x)
        x = self.norm_out(x)
        return x.transpose(1, 2).reshape(b, d, gh, gw)
