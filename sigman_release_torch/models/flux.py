"""FLUX.1's rectified-flow transformer (black-forest-labs/flux
``src/flux/model.py`` and ``src/flux/modules/layers.py``) as the second
denoiser of the image -> avatar path.

* stems: ``img_in`` over the latent packed in 2 x 2 patches
  (``b c (h 2) (w 2) -> b (h w) (c 2 2)``: 16 latent channels -> 64),
  ``txt_in`` over the conditioning encoder's tokens (``text_embed_dim``
  wide, every token of its feature map), and
  ``vec = time_in(emb(1000 t)) + guidance_in(emb(1000 g)) + vector_in(y)``
  with ``y`` the mean of the condition tokens;
* ``num_layers`` double-stream blocks (image and condition keep their own
  modulation, QKV, QK-norm, projection and MLP weights; joint attention
  over ``[txt; img]``), then ``num_single_layers`` single-stream blocks over
  the joined sequence (parallel attention and MLP: one ``linear1`` makes
  QKV and the MLP input, one ``linear2`` takes ``[attn; gelu(mlp)]``);
* the last layer: (shift, scale) modulation of a LayerNorm, a linear to 64
  channels, unpacked back to the latent.

LayerNorms have no affine and eps 1e-6; QK RMSNorm rounds to the input's
dtype before its scale (BFL's order); the MLPs use tanh-GELU; RoPE rotates
``axes_dim[i]`` dims of each head per id axis as interleaved pairs, on both
streams. Image tokens have ids (0, row, col), condition tokens (1, row, col)
on their own grid (FLUX.1 Kontext's place for a context image). The RoPE
tables are built once per (grids, device) on the device and kept. QK norm,
RoPE and the join of the two streams' q and k are one op
(``ops/qk_norm_rope.py``: a kernel when serving on the card); so are each
block's LayerNorms with their modulation and the gated residual adds
(``ops/ada_norm.py``: three kernel launches a double block, both streams in
each, and two a single block when serving on the card).

Parameter names follow BFL's checkpoint (``double_blocks.{i}.img_attn.qkv``
...). The model computes in its parameters' dtype; ``forward`` casts its
inputs to it and builds the timestep sinusoids in f32 first.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from sigman_release_torch.config import Config
from sigman_release_torch.models.dit import timestep_sinusoid
from sigman_release_torch.ops.ada_norm import (
    Norm, gated_residual, norm_modulate)
from sigman_release_torch.ops.qk_norm_rope import qk_norm_rope
from sigman_release_torch.utils.timing import NULL_TIMER

# FLUX.1's fixed sizes (util.py configs["flux-dev"])
MLP_RATIO = 4
TIME_DIM = 256
PATCH = 2
EPS = 1e-6          # the QK RMSNorm's
NORM = Norm(None, None, 1e-6)   # the blocks' LayerNorms: no affine


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.in_layer = nn.Linear(in_dim, hidden_dim)
        self.out_layer = nn.Linear(hidden_dim, hidden_dim)

    def forward(self, x):
        return self.out_layer(F.silu(self.in_layer(x)))


class RMSNorm(nn.Module):
    """A QK RMSNorm's scale (BFL's name)."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))


class QKNorm(nn.Module):
    """The query and key norms' scales (applied by ``qk_norm_rope``)."""

    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)

    def stream(self, q, k):
        """``(q, k, q scale, k scale)``: one stream of ``qk_norm_rope``."""
        return q, k, self.query_norm.scale, self.key_norm.scale


class SelfAttention(nn.Module):
    """The double block's per-stream QKV, QK-norm and output projection."""

    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.norm = QKNorm(dim // heads)
        self.proj = nn.Linear(dim, dim)


class Modulation(nn.Module):
    """vec -> (shift, scale, gate) once (single) or twice (double), each
    [B, 1, dim]."""

    def __init__(self, dim: int, double: bool):
        super().__init__()
        self.multiplier = 6 if double else 3
        self.lin = nn.Linear(dim, self.multiplier * dim)

    def forward(self, vec):
        return self.lin(F.silu(vec))[:, None, :].chunk(self.multiplier, -1)


def split_heads(qkv: torch.Tensor, heads: int):
    """[B, L, 3 H D] -> q, k, v [B, L, H, D] (BFL's ``B L (K H D)``)."""
    b, s, _ = qkv.shape
    q, k, v = qkv.reshape(b, s, 3, heads, -1).unbind(2)
    return q, k, v


def qk_rope(streams, rope):
    """Each stream's QK RMSNorm (BFL's order), the streams joined, RoPE on
    every token: q, k [B, L, H, D]."""
    return qk_norm_rope(streams, rope, rope_from=0, eps=EPS,
                        round_before_scale=True)


def attention(q, k, v):
    """SDPA over q, k, v [B, L, H, D] -> [B, L, H D]."""
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
    b, _, s, _ = out.shape
    return out.transpose(1, 2).reshape(b, s, -1)


def modulate(norm: torch.Tensor, shift, scale):
    return (1 + scale) * norm + shift


def _mlp(dim: int):
    return nn.Sequential(nn.Linear(dim, MLP_RATIO * dim),
                         nn.GELU(approximate="tanh"),
                         nn.Linear(MLP_RATIO * dim, dim))


class DoubleStreamBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.img_mod = Modulation(dim, double=True)
        self.img_attn = SelfAttention(dim, heads)
        self.img_mlp = _mlp(dim)
        self.txt_mod = Modulation(dim, double=True)
        self.txt_attn = SelfAttention(dim, heads)
        self.txt_mlp = _mlp(dim)

    def forward(self, img, txt, vec, rope):
        img_mod = self.img_mod(vec)
        txt_mod = self.txt_mod(vec)
        normed = norm_modulate([txt, img], [txt_mod[:2], img_mod[:2]], NORM,
                               join=False)
        streams, vs = [], []
        for x_mod, attn in zip(normed, (self.txt_attn, self.img_attn)):
            q, k, v = split_heads(attn.qkv(x_mod), self.heads)
            streams.append(attn.norm.stream(q, k))
            vs.append(v)
        q, k = qk_rope(streams, rope)
        out = attention(q, k, torch.cat(vs, dim=1))
        s = txt.shape[1]
        (img, txt), normed = gated_residual(
            [img, txt], [img_mod[2], txt_mod[2]],
            [self.img_attn.proj(out[:, s:]), self.txt_attn.proj(out[:, :s])],
            [img_mod[3:5], txt_mod[3:5]], NORM, join=False)
        img, txt = gated_residual(
            [img, txt], [img_mod[5], txt_mod[5]],
            [mlp(x_mod) for mlp, x_mod in zip((self.img_mlp, self.txt_mlp),
                                              normed)])
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads, self.dim = heads, dim
        self.linear1 = nn.Linear(dim, 3 * dim + MLP_RATIO * dim)
        self.linear2 = nn.Linear(dim + MLP_RATIO * dim, dim)
        self.norm = QKNorm(dim // heads)
        self.modulation = Modulation(dim, double=False)

    def forward(self, x, vec, rope):
        shift, scale, gate = self.modulation(vec)
        x_mod = norm_modulate([x], [(shift, scale)], NORM)
        qkv, mlp = torch.split(self.linear1(x_mod),
                               [3 * self.dim, MLP_RATIO * self.dim], dim=-1)
        q, k, v = split_heads(qkv, self.heads)
        q, k = qk_rope([self.norm.stream(q, k)], rope)
        attn = attention(q, k, v)
        out = self.linear2(torch.cat(
            [attn, F.gelu(mlp, approximate="tanh")], dim=2))
        return gated_residual([x], [gate], [out])[0]


class LastLayer(nn.Module):
    def __init__(self, dim: int, out_dim: int):
        super().__init__()
        self.linear = nn.Linear(dim, out_dim)
        self.adaLN_modulation = nn.Sequential(nn.SiLU(),
                                              nn.Linear(dim, 2 * dim))

    def forward(self, x, vec):
        shift, scale = self.adaLN_modulation(vec).chunk(2, dim=1)
        x = modulate(F.layer_norm(x, x.shape[-1:], eps=1e-6),
                     shift[:, None], scale[:, None])
        return self.linear(x)


def rope_ids(offset: int, gh: int, gw: int) -> torch.Tensor:
    """[gh*gw, 3] ids (offset, row, col) of a row-major grid of tokens."""
    rows = torch.arange(gh, dtype=torch.float64)[:, None].expand(gh, gw)
    cols = torch.arange(gw, dtype=torch.float64)[None, :].expand(gh, gw)
    return torch.stack([torch.full((gh, gw), float(offset),
                                   dtype=torch.float64), rows, cols],
                       -1).reshape(-1, 3)


def rope_tables(ids: torch.Tensor, axes_dim, theta: float):
    """(cos, sin) [S, sum(axes_dim)] f32 of ``ids`` [S, n_axes]: axis i
    rotates its ``axes_dim[i]`` dims as interleaved pairs at frequencies
    theta^(-2j / axes_dim[i]) (BFL's ``EmbedND``, each angle repeated for
    the pair as ``ops.qk_norm_rope`` takes it)."""
    cos, sin = [], []
    for i, dim in enumerate(axes_dim):
        scale = torch.arange(0, dim, 2, dtype=torch.float64,
                             device=ids.device) / dim
        ang = ids[:, i, None].to(torch.float64) / theta ** scale
        cos.append(torch.cos(ang).repeat_interleave(2, dim=-1))
        sin.append(torch.sin(ang).repeat_interleave(2, dim=-1))
    return torch.cat(cos, -1).float(), torch.cat(sin, -1).float()


def pack(latent: torch.Tensor) -> torch.Tensor:
    """[B, C, h, w] -> [B, (h/2)(w/2), 4C] (``b c (h 2) (w 2) -> b (h w)
    (c 2 2)``)."""
    b, c, h, w = latent.shape
    x = latent.reshape(b, c, h // PATCH, PATCH, w // PATCH, PATCH)
    return x.permute(0, 2, 4, 1, 3, 5).reshape(
        b, (h // PATCH) * (w // PATCH), c * PATCH * PATCH)


def unpack(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The inverse of ``pack``: [B, (h/2)(w/2), 4C] -> [B, C, h, w]."""
    b, _, d = x.shape
    c = d // (PATCH * PATCH)
    x = x.reshape(b, h // PATCH, w // PATCH, c, PATCH, PATCH)
    return x.permute(0, 3, 1, 4, 2, 5).reshape(b, c, h, w)


class FluxModel(nn.Module):
    """latent + condition feature map + t (+ guidance) -> velocity."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        dim, heads = cfg.hidden_dim, cfg.num_attention_heads
        if sum(cfg.axes_dim) != cfg.attention_head_dim:
            raise ValueError(f"axes_dim {cfg.axes_dim} must sum to the head "
                             f"dim {cfg.attention_head_dim}")
        channels = cfg.latent_channels * PATCH * PATCH
        self.img_in = nn.Linear(channels, dim)
        self.time_in = MLPEmbedder(TIME_DIM, dim)
        self.vector_in = MLPEmbedder(cfg.vec_in_dim, dim)
        self.guidance_in = (MLPEmbedder(TIME_DIM, dim) if cfg.guidance_embed
                            else None)
        self.txt_in = nn.Linear(cfg.text_embed_dim, dim)
        self.double_blocks = nn.ModuleList(
            DoubleStreamBlock(dim, heads) for _ in range(cfg.num_layers))
        self.single_blocks = nn.ModuleList(
            SingleStreamBlock(dim, heads)
            for _ in range(cfg.num_single_layers))
        self.final_layer = LastLayer(dim, channels)
        # (cond grid, image grid, device) -> (cos, sin) on the device
        self._rope: Dict[tuple, Tuple[torch.Tensor, torch.Tensor]] = {}

    def rope(self, cond_grid, img_grid, device):
        """The RoPE tables of ``[txt; img]``, built once per grids and
        device."""
        key = (tuple(cond_grid), tuple(img_grid), str(device))
        if key not in self._rope:
            ids = torch.cat([rope_ids(1, *cond_grid), rope_ids(0, *img_grid)])
            self._rope[key] = rope_tables(ids.to(device), self.cfg.axes_dim,
                                          self.cfg.rope_theta)
        return self._rope[key]

    def forward(self, latent, cond_feats, timestep, guidance=None,
                timer=NULL_TIMER):
        """latent [B,C,h,w], cond_feats [B,Cc,hc,wc], timestep [B] in
        [0, 1], guidance [B] (FLUX.1-dev's embedded guidance) ->
        [B,C,h,w] in the parameters' dtype. ``timer`` receives
        "flux_embed" (stems, embedders, RoPE tables), one "flux_double" a
        double block and one "flux_single" a single block."""
        dtype = self.img_in.weight.dtype
        b, _, h, w = latent.shape
        hc, wc = cond_feats.shape[-2:]
        with timer("flux_embed"):
            img = self.img_in(pack(latent.to(dtype)))
            tokens = cond_feats.flatten(2).transpose(1, 2)     # [B, S_c, Cc]
            txt = self.txt_in(tokens.to(dtype))
            vec = self.time_in(timestep_sinusoid(
                1000.0 * timestep.float(), TIME_DIM).to(dtype))
            if self.guidance_in is not None:
                if guidance is None:
                    raise ValueError("a guidance-distilled model needs "
                                     "guidance")
                vec = vec + self.guidance_in(timestep_sinusoid(
                    1000.0 * guidance.float(), TIME_DIM).to(dtype))
            vec = vec + self.vector_in(tokens.float().mean(1).to(dtype))
            rope = self.rope((hc, wc), (h // PATCH, w // PATCH),
                             latent.device)
        for block in self.double_blocks:
            with timer("flux_double"):
                img, txt = block(img, txt, vec, rope)
        s = txt.shape[1]
        x = torch.cat([txt, img], dim=1)
        for block in self.single_blocks:
            with timer("flux_single"):
                x = block(x, vec, rope)
        return unpack(self.final_layer(x[:, s:], vec), h, w)
