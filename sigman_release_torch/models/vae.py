"""UV-space Gaussian VAE (port of the JAX package's ``models/vae.py``).

* encoder: 3D conv stack over (V, H, W) — conv_in + 4 DownBlock3D
  (channels 128/256/256/512, 2 resnets each, stride-2 per-frame downsample
  between blocks) from the 9-channel input (RGB + Plucker) to H/8 x W/8
  tokens per view,
* UV-query bottleneck: a learned 64x64 query grid beside a conv encoding of
  the initial UV albedo, a sincos position table, one cross-attention over
  the encoder tokens, then N conv || self-attention blocks,
* linear projection to 2 x latent channels -> ``DiagonalGaussian``,
* decoder: conv_in + 4 UpBlock2D (channels 1024/512/512/256, 4 resnets each,
  x2 nearest upsample between) + GroupNorm/SiLU/conv_out, from the 64x64
  latent to the ``vae_out_channels`` UV feature map,
* heads: 3x3 convs geo (10 ch: opacity 1 + offset 3 + scale 3 + rot 3) and
  rgb (3 ch) with the reference's activations,
* ``sample_gaussian_attrs`` fetches per-Gaussian attributes at the template
  UVs; ``compose_rotations`` builds the deformed Gaussian frames.

Modules compute in NCHW / NCDHW; the public functions keep the JAX
package's layouts (images ``[B,V,9,H,W]``, ``z [B,h,w,C]`` -> attribute map
``[B,H,W,13]``, posterior ``[B,h,w,C]``). Parameter names follow the
reference checkpoint (``autoencoder.decoder.up_blocks.{i}.resnets.{j}.conv1``
...). GroupNorm uses eps 1e-6 and ``gcd(32, C)`` groups, as Flax does here.

Rematerialisation (``Config.remat_policy``), per resnet block of the conv
stacks: "block" recomputes the whole block in the backward
(``torch.utils.checkpoint``); "conv" keeps its conv outputs (conv1, conv2,
conv_shortcut) and recomputes only GroupNorm and SiLU (a selective
checkpoint whose policy must-saves ``aten.convolution``); "conv_enc" is
"conv" on the 3D encoder and "block" on the 2D decoder; "none" keeps every
activation. The bottleneck attention layers are recomputed under every
policy, as in the JAX package. Attention dropout masks are drawn from an
explicit ``torch.Generator`` before the checkpointed call, so the
recomputation sees the same mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from sigman_release_torch.config import Config
from sigman_release_torch.ops.grid_sample import grid_sample_2d
from sigman_release_torch.ops.rotations import rodrigues
from sigman_release_torch.utils.timing import NULL_TIMER

REMAT_POLICIES = ("block", "conv", "conv_enc", "none")


def _num_groups(channels: int, cap: int = 32) -> int:
    """Largest divisor of ``channels`` that is <= cap (GroupNorm groups)."""
    return math.gcd(cap, channels)


def group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(_num_groups(channels), channels, eps=1e-6)


def conv3x3(cin: int, cout: int) -> nn.Conv2d:
    """3x3 conv with Flax "SAME" padding (symmetric 1 for an odd kernel)."""
    return nn.Conv2d(cin, cout, 3, padding=1)


def _stack_modes(policy: str):
    """``Config.remat_policy`` -> (encoder mode, decoder mode), each
    "block", "conv" or "none"."""
    if policy not in REMAT_POLICIES:
        raise ValueError(f"remat_policy {policy!r}: one of {REMAT_POLICIES}")
    if policy == "conv_enc":
        return "conv", "block"
    return policy, policy


def set_remat_policy(model: nn.Module, policy: str) -> None:
    """Switch a built ``VAEModel`` to another remat policy in place; the
    weights stay."""
    enc_mode, dec_mode = _stack_modes(policy)
    ae = model.autoencoder
    stacks = [(ae.decoder, dec_mode)]
    if hasattr(ae, "encoder"):
        stacks.append((ae.encoder, enc_mode))
    for stack, mode in stacks:
        for m in stack.modules():
            if isinstance(m, ResnetBlock):
                m.remat = mode


def _save_convs(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of "conv": keep every convolution's
    output (autocast's casts run before it and are recomputed), recompute
    the rest."""
    if op == torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _conv_contexts():
    return create_selective_checkpoint_contexts(_save_convs)


def _run(module: nn.Module, mode: str, *args):
    """``module(*args)``: recomputed in the backward under "block",
    recomputed but for its convolutions under "conv"."""
    if mode == "none" or not torch.is_grad_enabled():
        return module(*args)
    if mode == "conv":
        return checkpoint(module, *args, use_reentrant=False,
                          context_fn=_conv_contexts)
    return checkpoint(module, *args, use_reentrant=False)


def _tokens_norm(norm: nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
    """GroupNorm over a token sequence [B,N,D] (channels last)."""
    return norm(x.transpose(1, 2)).transpose(1, 2)


class ResnetBlock(nn.Module):
    """GN -> SiLU -> conv -> GN -> SiLU -> conv with 1x1 shortcut; 2D or 3D
    (3x3x3 over (V, H, W))."""

    def __init__(self, in_channels: int, out_channels: int, dims: int = 2,
                 remat: str = "none"):
        super().__init__()
        conv = nn.Conv2d if dims == 2 else nn.Conv3d
        self.norm1 = group_norm(in_channels)
        self.conv1 = conv(in_channels, out_channels, 3, padding=1)
        self.norm2 = group_norm(out_channels)
        self.conv2 = conv(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (conv(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)
        self.remat = remat

    def _block(self, x):
        h = self.conv1(F.silu(self.norm1(x)))
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h

    def forward(self, x):
        return _run(self._block, self.remat, x)


class Downsample2D(nn.Module):
    """Asymmetric (0,1) pad + stride-2 3x3 conv, per view frame."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, stride=2)

    def forward(self, x):  # [B,C,V,H,W]
        b, c, v, h, w = x.shape
        f = x.transpose(1, 2).reshape(b * v, c, h, w)
        f = self.conv(F.pad(f, (0, 1, 0, 1)))
        return f.reshape(b, v, c, *f.shape[-2:]).transpose(1, 2)


class DownBlock3D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_resnets: int,
                 downsample: bool, remat: str):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels,
                        dims=3, remat=remat)
            for j in range(n_resnets))
        self.downsamplers = nn.ModuleList(
            [Downsample2D(out_channels)] if downsample else [])

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        for d in self.downsamplers:
            x = d(x)
        return x


class Encoder3D(nn.Module):
    """conv_in + 4 DownBlock3D over [B,9,V,H,W] -> [B,C_last,V,H/8,W/8]."""

    def __init__(self, in_channels: int = 9,
                 block_channels: Sequence[int] = (128, 256, 256, 512),
                 layers_per_block: int = 2, remat: str = "block"):
        super().__init__()
        chans = list(block_channels)
        self.conv_in = nn.Conv3d(in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList(
            DownBlock3D(chans[max(i - 1, 0)], ch, layers_per_block,
                        downsample=i < len(chans) - 1, remat=remat)
            for i, ch in enumerate(chans))

    def forward(self, x):
        x = self.conv_in(x)
        for block in self.down_blocks:
            x = block(x)
        return x


class Upsample2D(nn.Module):
    """x2 nearest upsample + 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = conv3x3(channels, channels)

    def forward(self, x):
        return self.conv(F.interpolate(x, scale_factor=2, mode="nearest"))


class UpBlock2D(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, n_resnets: int,
                 upsample: bool, remat: str = "none"):
        super().__init__()
        self.resnets = nn.ModuleList(
            ResnetBlock(in_channels if j == 0 else out_channels, out_channels,
                        remat=remat)
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
                 layers_per_block: int = 3, remat: str = "none"):
        super().__init__()
        chans = list(reversed(block_channels))
        self.conv_in = conv3x3(in_channels, chans[0])
        self.up_blocks = nn.ModuleList(
            UpBlock2D(chans[max(i - 1, 0)], ch, layers_per_block + 1,
                      upsample=i < len(chans) - 1, remat=remat)
            for i, ch in enumerate(chans))
        self.norm_out = group_norm(chans[-1])
        self.conv_out = conv3x3(chans[-1], out_channels)

    def forward(self, z):  # [B, latent, h, w]
        x = self.conv_in(z)
        for block in self.up_blocks:
            x = block(x)
        return self.conv_out(F.silu(self.norm_out(x)))


def dropout_mask(shape, rate: float, generator: torch.Generator, device,
                 dtype=torch.float32) -> torch.Tensor:
    """Inverted-dropout multiplier: 0 with probability ``rate``, else
    1 / (1 - rate) (Flax's ``Dropout``), drawn from ``generator``."""
    keep = 1.0 - rate
    u = torch.rand(shape, generator=generator, device=device)
    return (u < keep).to(dtype) / keep


class MHA(nn.Module):
    """diffusers-``Attention`` parity (the reference bottleneck attention):
    GroupNorm on the query input, bias-free q/k/v to heads x head_dim,
    per-head LayerNorm on q and k, optional LayerNorm (eps 1e-5) on the
    cross-attention context, out projection with bias, dropout after it,
    optional residual add of the raw input. Tokens are [B,N,D]."""

    def __init__(self, dim: int, heads: int, head_dim: int = 64,
                 context_dim: Optional[int] = None, norm_context: bool = False,
                 residual: bool = False, dropout: float = 0.0):
        super().__init__()
        inner = heads * head_dim
        ctx = dim if context_dim is None else context_dim
        self.heads, self.head_dim = heads, head_dim
        self.residual, self.dropout = residual, dropout
        self.norm_cross = nn.LayerNorm(ctx, eps=1e-5) if norm_context else None
        self.group_norm = group_norm(dim)
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.norm_q = nn.LayerNorm(head_dim, eps=1e-6)
        self.norm_k = nn.LayerNorm(head_dim, eps=1e-6)
        self.to_out = nn.Linear(inner, dim)

    def forward(self, x, context=None, drop=None):
        """``drop``: a :func:`dropout_mask` for the output, or None."""
        b, n, _ = x.shape
        ctx = x if context is None else context
        if self.norm_cross is not None and context is not None:
            ctx = self.norm_cross(ctx)
        h = _tokens_norm(self.group_norm, x)

        def heads(t):                        # [B,S,inner] -> [B,heads,S,hd]
            return t.reshape(b, -1, self.heads, self.head_dim).transpose(1, 2)

        v = heads(self.to_v(ctx))
        q = self.norm_q(heads(self.to_q(h))).to(v.dtype)
        k = self.norm_k(heads(self.to_k(ctx))).to(v.dtype)
        out = F.scaled_dot_product_attention(q, k, v)
        out = self.to_out(out.transpose(1, 2).reshape(b, n, -1))
        if drop is not None:
            out = out * drop
        if self.residual:
            out = out + x
        return out


class ConvAttenBlock(nn.Module):
    """x + SiLU(GN(conv2d(x_grid) + attn(x))) on a [B, h*w, D] token grid."""

    def __init__(self, height: int, width: int, dim: int, heads: int,
                 head_dim: int = 64, dropout: float = 0.0):
        super().__init__()
        self.height, self.width = height, width
        self.conv = conv3x3(dim, dim)
        self.attn = MHA(dim, heads, head_dim, dropout=dropout)
        self.norm = group_norm(dim)

    def forward(self, x, drop=None):
        b, _, d = x.shape
        grid = x.reshape(b, self.height, self.width, d).permute(0, 3, 1, 2)
        conv_out = self.conv(grid).permute(0, 2, 3, 1).reshape(b, -1, d)
        out = _tokens_norm(self.norm, conv_out + self.attn(x, drop=drop))
        return x + F.silu(out)


class DiagonalGaussian(NamedTuple):
    mean: torch.Tensor     # [B, h, w, C]
    logvar: torch.Tensor

    def sample(self, noise: torch.Tensor) -> torch.Tensor:
        """mean + std * noise (``noise`` standard normal, mean's shape)."""
        return self.mean + torch.exp(0.5 * self.logvar) * noise

    def mode(self) -> torch.Tensor:
        return self.mean

    def kl(self) -> torch.Tensor:
        var = torch.exp(self.logvar)
        return 0.5 * torch.sum(self.mean ** 2 + var - 1.0 - self.logvar,
                               dim=tuple(range(1, self.mean.ndim)))


def sincos_table(n_pos: int, dim: int) -> np.ndarray:
    """Classic transformer sinusoid table [n_pos, dim]."""
    pos = np.arange(n_pos)[:, None]
    i = np.arange(dim)[None, :]
    angle = pos / np.power(10000.0, 2 * (i // 2) / dim)
    table = np.where(i % 2 == 0, np.sin(angle), np.cos(angle))
    return table.astype(np.float32)


class Bottleneck(nn.Module):
    """One cross-attention over the encoder tokens, then N conv || attention
    blocks (the reference's ``attention`` module)."""

    def __init__(self, cfg: Config):
        super().__init__()
        d = cfg.encoder_channels[-1]
        h = cfg.uv_query_size
        heads, hd = cfg.vae_attention_heads, cfg.vae_attention_head_dim
        self.cross_attn = MHA(2 * d, heads, hd, context_dim=d,
                              norm_context=True, residual=True,
                              dropout=cfg.attn_dropout)
        self.middle_layers = nn.ModuleList(
            ConvAttenBlock(h, h, 2 * d, heads, hd, dropout=cfg.attn_dropout)
            for _ in range(cfg.self_attention_layers))


class ConvVAE(nn.Module):
    """Encoder + UV-query bottleneck + decoder (the reference's Conv_VAE).
    ``with_encoder=False`` builds the decoder alone (serving decodes only)."""

    def __init__(self, cfg: Config, with_encoder: bool = True):
        super().__init__()
        enc_mode, dec_mode = _stack_modes(cfg.remat_policy)
        self.decoder = Decoder2D(cfg.latent_channels, cfg.vae_out_channels,
                                 cfg.decoder_channels, remat=dec_mode)
        if not with_encoder:
            return
        d = cfg.encoder_channels[-1]
        self.h = self.w = cfg.uv_query_size
        self.encoder = Encoder3D(block_channels=cfg.encoder_channels,
                                 remat=enc_mode)
        self.uv_latent = nn.Parameter(torch.empty(1, self.h * self.w, d))
        self.uv_encoding = nn.Sequential(nn.Conv2d(3, d, 8, stride=8),
                                         group_norm(d), nn.SiLU())
        self.register_buffer(
            "pos_embedding",
            torch.from_numpy(sincos_table(self.h * self.w, 2 * d)),
            persistent=False)
        self.attention = Bottleneck(cfg)
        self.projection = nn.Linear(2 * d, 2 * cfg.latent_channels)
        self.attn_dropout = cfg.attn_dropout

    def encode(self, x, initial_uv, train: bool = False,
               generator: Optional[torch.Generator] = None):
        """x [B,9,V,H,W]; initial_uv [B,3,H,W] -> posterior over [B,h,w,Cl].

        ``train`` turns on the bottleneck attention dropout, whose masks
        come from ``generator``."""
        feats = self.encoder(x)                            # [B,D,V,h,w]
        b, d = feats.shape[:2]
        tokens = feats.permute(0, 2, 3, 4, 1).reshape(b, -1, d)
        # reference quirk: the uv tokens are a CHANNEL-MAJOR flatten of the
        # NCHW conv output (``view(bs, -1, d)``), not a per-pixel permute
        uv = self.uv_encoding(initial_uv).reshape(b, -1, d)
        query = torch.cat([self.uv_latent.expand(b, -1, -1).to(uv.dtype), uv],
                          dim=-1) + self.pos_embedding[None]
        layers = [self.attention.cross_attn, *self.attention.middle_layers]
        drops = [None] * len(layers)
        if train and self.attn_dropout > 0.0:
            if generator is None:
                raise ValueError("train=True with dropout needs a generator")
            drops = [dropout_mask(query.shape, self.attn_dropout, generator,
                                  query.device) for _ in layers]
        attn = _run(layers[0], "block", query, tokens, drops[0])
        for layer, drop in zip(layers[1:], drops[1:]):
            attn = _run(layer, "block", attn, drop)
        proj = self.projection(attn).reshape(b, self.h, self.w, -1)
        mean, logvar = proj.chunk(2, dim=-1)
        return DiagonalGaussian(mean, torch.clamp(logvar, -30.0, 20.0))


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
    """ConvVAE + Gaussian heads: images -> UV attribute map
    (``with_encoder=False``: the decode side alone)."""

    def __init__(self, cfg: Config, with_encoder: bool = True):
        super().__init__()
        self.autoencoder = ConvVAE(cfg, with_encoder)
        self.heads = GaussianHeads(cfg.vae_out_channels)

    def forward(self, images, initial_uv, noise=None,
                sample_posterior: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None,
                timer=NULL_TIMER):
        """images [B,V,9,H,W], initial_uv [B,3,H,W] -> (attr_map
        [B,H,W,13], posterior).

        The posterior sample is ``mean + std * noise``; ``noise`` defaults to
        a draw from ``generator``. ``sample_posterior=False`` decodes the
        mean. ``train`` turns on the bottleneck dropout (masks from
        ``generator``). ``timer`` receives the "encoder" (encoder +
        bottleneck) and "decoder" (decoder + heads) spans."""
        with timer("encoder"):
            posterior = self.encode(images, initial_uv, train, generator)
        if not sample_posterior:
            z = posterior.mode()
        else:
            if noise is None:
                noise = torch.randn(posterior.mean.shape, generator=generator,
                                    device=posterior.mean.device)
            z = posterior.sample(noise)
        with timer("decoder"):
            return self.decode(z), posterior

    def encode(self, images, initial_uv, train: bool = False,
               generator: Optional[torch.Generator] = None):
        return self.autoencoder.encode(images.transpose(1, 2), initial_uv,
                                       train, generator)

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
