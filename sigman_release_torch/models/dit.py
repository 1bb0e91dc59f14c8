"""CogVideoX-style diffusion transformer (port of
the JAX package's ``models/dit.py``).

* patch embed: conv-patchify the latent (p=2) and conv-4x4-stride-4 project
  the conditioning feature map into conditioning tokens,
* blocks: AdaLN-zero (6-way shift/scale/gate for both streams, one shared
  LayerNorm eps 1e-5; norm, modulation and gated residual adds through
  ``ops/ada_norm.py``: three kernel launches a block when serving on the
  card, writing both streams into one [cond; image] buffer), joint
  self-attention over that buffer with per-head RMS qk-norm (eps 1e-6) and
  2D RoPE on the image slice only (one op, ``ops/qk_norm_rope.py``: a kernel
  when serving on the card), tanh-GELU FFN over the same joined streams,
* final LayerNorm over the joint sequence, AdaLayerNorm (shift/scale) from
  the time embedding, linear projection to p*p*out_channels, unpatchify.

Parameter names follow the reference checkpoint (``transformer_blocks.{i}.
attn1.to_q`` ...). Attention is ``F.scaled_dot_product_attention`` (plain
XLA attention in the JAX package). The model computes in the dtype of its
parameters; ``forward`` casts its inputs to it. With
``cfg.gradient_checkpointing`` each block is recomputed in the backward
(the JAX package's per-block remat) whenever gradients are being recorded;
the blocks draw no random numbers, so the recompute is exact.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from sigman_release_torch.config import Config
from sigman_release_torch.ops.ada_norm import gated_residual, norm_modulate
from sigman_release_torch.ops.qk_norm_rope import qk_norm_rope
from sigman_release_torch.utils.timing import NULL_TIMER


def timestep_sinusoid(t: torch.Tensor, dim: int, flip: bool = True,
                      max_period: float = 10000.0) -> torch.Tensor:
    """diffusers Timesteps: [B] -> [B, dim] f32 (cos|sin order when flipped)."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period)
                      * torch.arange(half, dtype=torch.float32,
                                     device=t.device) / half)
    args = t.to(torch.float32)[:, None] * freqs[None]
    sin, cos = torch.sin(args), torch.cos(args)
    return torch.cat([cos, sin] if flip else [sin, cos], dim=-1)


def sincos_2d(embed_dim: int, grid_h: int, grid_w: int,
              interpolation_scale: float = 1.875,
              base_size: int = 16) -> np.ndarray:
    """2D sincos position table [grid_h*grid_w, embed_dim] (diffusers
    ``get_2d_sincos_pos_embed`` with its base-size rescale): the first half
    of the dim encodes the column, the second the row."""
    if grid_h != grid_w:
        raise ValueError("sincos_2d takes square grids only")

    def one_dim(dim, pos):
        omega = 1.0 / 10000.0 ** (np.arange(dim // 2) / (dim / 2.0))
        out = np.einsum("p,d->pd", pos, omega)
        return np.concatenate([np.sin(out), np.cos(out)], axis=1)

    scale_h = (grid_h / base_size) * interpolation_scale
    scale_w = (grid_w / base_size) * interpolation_scale
    rows = np.arange(grid_h, dtype=np.float64)
    cols = np.arange(grid_w, dtype=np.float64)
    col_of = np.tile(cols, grid_h) / scale_h     # token p -> its column
    row_of = np.repeat(rows, grid_w) / scale_w   # token p -> its row
    emb_col = one_dim(embed_dim // 2, col_of)
    emb_row = one_dim(embed_dim // 2, row_of)
    return np.concatenate([emb_col, emb_row], axis=1).astype(np.float32)


def rope_2d(head_dim: int, grid_h: int, grid_w: int,
            theta: float = 10000.0) -> Tuple[np.ndarray, np.ndarray]:
    """2D axial rotary embedding (diffusers get_2d_rotary_pos_embed layout).

    Returns (cos, sin) [grid_h*grid_w, head_dim] f32: the first half of the
    head dims rotates with the column, the second half with the row.
    """

    def one_dim(dim, pos):
        inv = 1.0 / theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
        ang = np.outer(pos, inv)                    # [S, dim/2]
        return (np.repeat(np.cos(ang), 2, axis=1),
                np.repeat(np.sin(ang), 2, axis=1))

    rows = np.arange(grid_h, dtype=np.float64)
    cols = np.arange(grid_w, dtype=np.float64)
    ch, sh = one_dim(head_dim // 2, rows)           # [H, hd/2]
    cw, sw = one_dim(head_dim // 2, cols)
    cos = np.concatenate([np.tile(cw, (grid_h, 1)),
                          np.repeat(ch, grid_w, axis=0)], axis=1)
    sin = np.concatenate([np.tile(sw, (grid_h, 1)),
                          np.repeat(sh, grid_w, axis=0)], axis=1)
    return cos.astype(np.float32), sin.astype(np.float32)


class RMSNormPerHead(nn.Module):
    """A per-head RMS norm's weight and eps; ``JointAttention`` applies it
    through ``ops.qk_norm_rope`` (weight in f32, one rounding)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))

    def applied_weight(self) -> torch.Tensor:
        """The weight as the norm multiplies by it (``parallel/fsdp.py``
        routes it through a sum of its gradient)."""
        return self.weight


class JointAttention(nn.Module):
    """Self-attention over [cond; image] with RoPE on the image slice."""

    def __init__(self, dim: int, heads: int, head_dim: int):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        self.to_q = nn.Linear(dim, inner)
        self.to_k = nn.Linear(dim, inner)
        self.to_v = nn.Linear(dim, inner)
        self.norm_q = RMSNormPerHead(head_dim)
        self.norm_k = RMSNormPerHead(head_dim)
        self.to_out = nn.ModuleList([nn.Linear(inner, dim)])

    def forward(self, x, s_cond, rope):
        """x [B, S_cond + S_img, D], the joined [cond; image] sequence ->
        the attention's output over it, joined likewise."""
        b, s, _ = x.shape

        def split(t):   # this rank's heads under tensor parallelism
            return t.reshape(b, s, -1, self.head_dim)

        q, k = qk_norm_rope(
            [(split(self.to_q(x)), split(self.to_k(x)),
              self.norm_q.applied_weight(), self.norm_k.applied_weight())],
            rope, rope_from=s_cond, eps=self.norm_q.eps,
            round_before_scale=False)
        v = split(self.to_v(x))
        out = F.scaled_dot_product_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))
        return self.to_out[0](out.transpose(1, 2).reshape(b, s, -1))


class AdaLNZero(nn.Module):
    """temb -> 6-way (shift, scale, gate) x (image, cond), each [B, 1, D],
    and the LayerNorm both streams share (applied by ``ops.ada_norm``)."""

    def __init__(self, dim: int, temb_dim: int):
        super().__init__()
        self.linear = nn.Linear(temb_dim, 6 * dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, temb):
        """(shift, scale, gate, cond shift, cond scale, cond gate): views of
        the linear's output, read in place by the op."""
        return self.linear(F.silu(temb))[:, None].chunk(6, -1)


class _GeluProj(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.proj = nn.Linear(dim_in, dim_out)

    def forward(self, x):
        return F.gelu(self.proj(x), approximate="tanh")


class FeedForward(nn.Module):
    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        # index layout of the reference checkpoint (net.0.proj, net.2)
        self.net = nn.ModuleList([_GeluProj(dim, dim * mult), nn.Identity(),
                                  nn.Linear(dim * mult, dim)])

    def forward(self, x):
        for layer in self.net:
            x = layer(x)
        return x


class DiTBlock(nn.Module):
    def __init__(self, dim: int, heads: int, head_dim: int, temb_dim: int):
        super().__init__()
        self.norm1 = AdaLNZero(dim, temb_dim)
        self.attn1 = JointAttention(dim, heads, head_dim)
        self.norm2 = AdaLNZero(dim, temb_dim)
        self.ff = FeedForward(dim)

    def forward(self, image, cond, temb, rope, timer=NULL_TIMER):
        """``timer`` receives "dit_adaln" (the modulations, norm1, the
        gated add after the attention with norm2, the gated add after the
        feed-forward: three launches of ``ops.ada_norm`` a block when
        serving), "dit_attention" and "dit_ff". Both streams' norms land
        in one joined [cond; image] buffer, which the attention's and the
        feed-forward's linears read."""
        s = cond.shape[1]
        with timer("dit_adaln"):
            sh, sc, gate, esh, esc, egate = self.norm1(temb)
            x = norm_modulate([cond, image], [(esh, esc), (sh, sc)],
                              self.norm1.norm)
        with timer("dit_attention"):
            out = self.attn1(x, s, rope)
        with timer("dit_adaln"):
            sh, sc, gate2, esh, esc, egate2 = self.norm2(temb)
            (cond, image), x = gated_residual(
                [cond, image], [egate, gate], [out[:, :s], out[:, s:]],
                [(esh, esc), (sh, sc)], self.norm2.norm)
        with timer("dit_ff"):
            ff = self.ff(x)
        with timer("dit_adaln"):
            cond, image = gated_residual([cond, image], [egate2, gate2],
                                         [ff[:, :s], ff[:, s:]])
        return image, cond


class PatchEmbed(nn.Module):
    """Latent patchify + conditioning projection (+ sincos when no RoPE)."""

    def __init__(self, cfg: Config):
        super().__init__()
        dim, p = cfg.hidden_dim, cfg.patch_size
        self.use_sincos = not cfg.use_rotary_positional_embeddings
        self.proj = nn.Conv2d(cfg.in_channels, dim, p, stride=p)
        self.cond_proj = nn.Conv2d(cfg.text_embed_dim, dim, 4, stride=4)

    def forward(self, latent, cond_feats):  # NCHW both
        """-> image and cond tokens [B, S, D], contiguous: the layout the
        blocks' ``ops.ada_norm`` kernel reads (a transposed view would keep
        the residual stream channel-major through every block)."""
        img = self.proj(latent)
        b, dim, gh, gw = img.shape
        img = img.flatten(2).transpose(1, 2).contiguous()   # [B, gh*gw, D]
        cond = self.cond_proj(cond_feats).flatten(2).transpose(1, 2)
        cond = cond.contiguous()
        if self.use_sincos:
            pos = torch.as_tensor(sincos_2d(dim, gh, gw), device=img.device)
            img = img + pos[None].to(img.dtype)
        return img, cond


class TimeEmbedding(nn.Module):
    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.linear_1 = nn.Linear(dim_in, dim_out)
        self.linear_2 = nn.Linear(dim_out, dim_out)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class AdaLayerNorm(nn.Module):
    def __init__(self, dim: int, temb_dim: int):
        super().__init__()
        self.linear = nn.Linear(temb_dim, 2 * dim)
        self.norm = nn.LayerNorm(dim, eps=1e-5)

    def forward(self, x, temb):
        shift, scale = self.linear(F.silu(temb)).chunk(2, -1)
        return self.norm(x) * (1 + scale[:, None]) + shift[:, None]


class DiTModel(nn.Module):
    """latent + conditioning features + timestep -> v-prediction."""

    def __init__(self, cfg: Config):
        super().__init__()
        self.cfg = cfg
        dim = cfg.hidden_dim
        self.time_embedding = TimeEmbedding(dim, cfg.time_embed_dim)
        self.patch_embed = PatchEmbed(cfg)
        self.transformer_blocks = nn.ModuleList(
            DiTBlock(dim, cfg.num_attention_heads, cfg.attention_head_dim,
                     cfg.time_embed_dim) for _ in range(cfg.num_layers))
        self.norm_final = nn.LayerNorm(dim, eps=1e-5)
        self.norm_out = AdaLayerNorm(dim, cfg.time_embed_dim)
        self.proj_out = nn.Linear(dim, cfg.patch_size ** 2 * cfg.out_channels)

    def forward(self, latent, cond_feats, timestep, timer=NULL_TIMER):
        """latent [B,C,h,w], cond_feats [B,Cc,hc,wc], timestep [B] ->
        [B,out_channels,h,w] in the parameters' dtype. ``timer`` receives
        "dit_embed" (the time and patch embeddings and the position tables,
        their host-to-device copies included) and, where the blocks are not
        recomputed, each block's spans (``DiTBlock.forward``)."""
        c = self.cfg
        dtype = self.proj_out.weight.dtype
        latent, cond_feats = latent.to(dtype), cond_feats.to(dtype)
        b, _, h, w = latent.shape
        p = c.patch_size
        gh, gw = h // p, w // p

        with timer("dit_embed"):
            temb = self.time_embedding(
                timestep_sinusoid(timestep, c.hidden_dim).to(dtype))
            image, cond = self.patch_embed(latent, cond_feats)
            rope: Optional[tuple] = None
            if c.use_rotary_positional_embeddings:
                rope = tuple(torch.as_tensor(a, device=latent.device)
                             for a in rope_2d(c.attention_head_dim, gh, gw))
        remat = c.gradient_checkpointing and torch.is_grad_enabled()
        for block in self.transformer_blocks:
            if remat:
                image, cond = checkpoint(block, image, cond, temb, rope,
                                         use_reentrant=False)
            else:
                image, cond = block(image, cond, temb, rope, timer=timer)

        joint = self.norm_final(torch.cat([cond, image], dim=1))
        image = self.norm_out(joint[:, cond.shape[1]:], temb)
        out = self.proj_out(image)

        # unpatchify -> [B, C, h, w]
        out = out.reshape(b, gh, gw, c.out_channels, p, p)
        return torch.einsum("bhwcpq->bchpwq", out).reshape(
            b, c.out_channels, gh * p, gw * p)
