"""FLUX.1's rectified-flow transformer in plain f32 PyTorch: the
benchmark's reference for the port's ``models/flux.py``.

Written from black-forest-labs/flux ``src/flux/model.py`` (``Flux``) and
``src/flux/modules/layers.py`` (``EmbedND``, ``rope``, ``apply_rope``,
``timestep_embedding``, ``MLPEmbedder``, ``RMSNorm``, ``QKNorm``,
``Modulation``, ``DoubleStreamBlock``, ``SingleStreamBlock``,
``LastLayer``), and the packing of ``src/flux/sampling.py``; ``einops``'
rearranges are written out as reshapes. It imports nothing of the port and
no kernel. Departures from BFL's code:

* ``txt_in`` takes ``context_in_dim`` = 1536 (the conditioning encoder's
  tokens, every one of its 32 x 32 feature map) in place of T5's 4096;
* ``vector_in`` takes ``vec_in_dim`` = 1536, fed with ``y`` = the mean of
  the condition tokens, in place of CLIP's pooled 768;
* the condition tokens' ids are (1, row, col) on their own grid, as FLUX.1
  Kontext places a context image's tokens, where FLUX.1 gives T5's tokens
  (0, 0, 0);
* ``BlockwiseFlux`` builds each block from its weights when it reaches it
  and frees it after, so the whole model is never held.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import Tensor, nn


@dataclass(frozen=True)
class FluxParams:
    in_channels: int
    vec_in_dim: int
    context_in_dim: int
    hidden_size: int
    mlp_ratio: float
    num_heads: int
    depth: int
    depth_single_blocks: int
    axes_dim: Tuple[int, ...]
    theta: float
    qkv_bias: bool
    guidance_embed: bool


def params_of(cfg, flux: dict) -> FluxParams:
    """The params of a configuration file: ``cfg`` (the reference's
    ``Config``) and its ``flux`` group."""
    return FluxParams(
        in_channels=cfg.latent_channels * 4,
        vec_in_dim=flux["vec_in_dim"],
        context_in_dim=cfg.text_embed_dim,
        hidden_size=cfg.num_attention_heads * cfg.attention_head_dim,
        mlp_ratio=4.0,
        num_heads=cfg.num_attention_heads,
        depth=cfg.num_layers,
        depth_single_blocks=flux["num_single_layers"],
        axes_dim=tuple(flux["axes_dim"]),
        theta=float(flux["rope_theta"]),
        qkv_bias=True,
        guidance_embed=bool(flux["guidance_embed"]),
    )


# ------------------------------------------------------------ layers.py


def rope(pos: Tensor, dim: int, theta: float) -> Tensor:
    """[..., n] -> [..., n, dim/2, 2, 2] rotation matrices."""
    scale = torch.arange(0, dim, 2, dtype=torch.float64,
                         device=pos.device) / dim
    omega = 1.0 / (theta ** scale)
    out = torch.einsum("...n,d->...nd", pos.to(torch.float64), omega)
    out = torch.stack([torch.cos(out), -torch.sin(out), torch.sin(out),
                       torch.cos(out)], dim=-1)
    return out.reshape(*out.shape[:-1], 2, 2).float()


def apply_rope(xq: Tensor, xk: Tensor, freqs_cis: Tensor):
    xq_ = xq.float().reshape(*xq.shape[:-1], -1, 1, 2)
    xk_ = xk.float().reshape(*xk.shape[:-1], -1, 1, 2)
    xq_out = freqs_cis[..., 0] * xq_[..., 0] + freqs_cis[..., 1] * xq_[..., 1]
    xk_out = freqs_cis[..., 0] * xk_[..., 0] + freqs_cis[..., 1] * xk_[..., 1]
    return (xq_out.reshape(*xq.shape).type_as(xq),
            xk_out.reshape(*xk.shape).type_as(xk))


def attention(q: Tensor, k: Tensor, v: Tensor, pe: Tensor) -> Tensor:
    """q, k, v [B, H, L, D] -> [B, L, H D]."""
    q, k = apply_rope(q, k, pe)
    x = torch.nn.functional.scaled_dot_product_attention(q, k, v)
    b, h, s, d = x.shape
    return x.transpose(1, 2).reshape(b, s, h * d)


class EmbedND(nn.Module):
    def __init__(self, theta: float, axes_dim):
        super().__init__()
        self.theta, self.axes_dim = theta, list(axes_dim)

    def forward(self, ids: Tensor) -> Tensor:
        n_axes = ids.shape[-1]
        emb = torch.cat([rope(ids[..., i], self.axes_dim[i], self.theta)
                         for i in range(n_axes)], dim=-3)
        return emb.unsqueeze(1)


def timestep_embedding(t: Tensor, dim: int, max_period=10000,
                       time_factor: float = 1000.0) -> Tensor:
    t = time_factor * t
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(
        0, half, dtype=torch.float32, device=t.device) / half)
    args = t[:, None].float() * freqs[None]
    return torch.cat([torch.cos(args), torch.sin(args)], dim=-1)


class MLPEmbedder(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.in_layer = nn.Linear(in_dim, hidden_dim, bias=True)
        self.silu = nn.SiLU()
        self.out_layer = nn.Linear(hidden_dim, hidden_dim, bias=True)

    def forward(self, x: Tensor) -> Tensor:
        return self.out_layer(self.silu(self.in_layer(x)))


class RMSNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))

    def forward(self, x: Tensor):
        x_dtype = x.dtype
        x = x.float()
        rrms = torch.rsqrt(torch.mean(x ** 2, dim=-1, keepdim=True) + 1e-6)
        return (x * rrms).to(dtype=x_dtype) * self.scale


class QKNorm(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.query_norm = RMSNorm(dim)
        self.key_norm = RMSNorm(dim)

    def forward(self, q: Tensor, k: Tensor, v: Tensor):
        return self.query_norm(q).to(v), self.key_norm(k).to(v)


class SelfAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, qkv_bias: bool):
        super().__init__()
        self.num_heads = num_heads
        self.qkv = nn.Linear(dim, dim * 3, bias=qkv_bias)
        self.norm = QKNorm(dim // num_heads)
        self.proj = nn.Linear(dim, dim)


class Modulation(nn.Module):
    def __init__(self, dim: int, double: bool):
        super().__init__()
        self.is_double = double
        self.multiplier = 6 if double else 3
        self.lin = nn.Linear(dim, self.multiplier * dim, bias=True)

    def forward(self, vec: Tensor):
        out = self.lin(nn.functional.silu(vec))[:, None, :].chunk(
            self.multiplier, dim=-1)
        return out[:3], (out[3:] if self.is_double else None)


def heads_first(qkv: Tensor, num_heads: int):
    """``B L (K H D) -> K B H L D``."""
    b, s, _ = qkv.shape
    return qkv.reshape(b, s, 3, num_heads, -1).permute(2, 0, 3, 1, 4)


class DoubleStreamBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float,
                 qkv_bias: bool):
        super().__init__()
        mlp_hidden_dim = int(hidden_size * mlp_ratio)
        self.num_heads = num_heads

        def mlp():
            return nn.Sequential(
                nn.Linear(hidden_size, mlp_hidden_dim, bias=True),
                nn.GELU(approximate="tanh"),
                nn.Linear(mlp_hidden_dim, hidden_size, bias=True))

        self.img_mod = Modulation(hidden_size, double=True)
        self.img_norm1 = nn.LayerNorm(hidden_size, elementwise_affine=False,
                                      eps=1e-6)
        self.img_attn = SelfAttention(hidden_size, num_heads, qkv_bias)
        self.img_norm2 = nn.LayerNorm(hidden_size, elementwise_affine=False,
                                      eps=1e-6)
        self.img_mlp = mlp()
        self.txt_mod = Modulation(hidden_size, double=True)
        self.txt_norm1 = nn.LayerNorm(hidden_size, elementwise_affine=False,
                                      eps=1e-6)
        self.txt_attn = SelfAttention(hidden_size, num_heads, qkv_bias)
        self.txt_norm2 = nn.LayerNorm(hidden_size, elementwise_affine=False,
                                      eps=1e-6)
        self.txt_mlp = mlp()

    def forward(self, img: Tensor, txt: Tensor, vec: Tensor, pe: Tensor):
        (i_sh1, i_sc1, i_g1), (i_sh2, i_sc2, i_g2) = self.img_mod(vec)
        (t_sh1, t_sc1, t_g1), (t_sh2, t_sc2, t_g2) = self.txt_mod(vec)

        img_modulated = (1 + i_sc1) * self.img_norm1(img) + i_sh1
        img_q, img_k, img_v = heads_first(self.img_attn.qkv(img_modulated),
                                          self.num_heads)
        img_q, img_k = self.img_attn.norm(img_q, img_k, img_v)

        txt_modulated = (1 + t_sc1) * self.txt_norm1(txt) + t_sh1
        txt_q, txt_k, txt_v = heads_first(self.txt_attn.qkv(txt_modulated),
                                          self.num_heads)
        txt_q, txt_k = self.txt_attn.norm(txt_q, txt_k, txt_v)

        q = torch.cat((txt_q, img_q), dim=2)
        k = torch.cat((txt_k, img_k), dim=2)
        v = torch.cat((txt_v, img_v), dim=2)
        attn = attention(q, k, v, pe=pe)
        txt_attn, img_attn = attn[:, :txt.shape[1]], attn[:, txt.shape[1]:]

        img = img + i_g1 * self.img_attn.proj(img_attn)
        img = img + i_g2 * self.img_mlp(
            (1 + i_sc2) * self.img_norm2(img) + i_sh2)
        txt = txt + t_g1 * self.txt_attn.proj(txt_attn)
        txt = txt + t_g2 * self.txt_mlp(
            (1 + t_sc2) * self.txt_norm2(txt) + t_sh2)
        return img, txt


class SingleStreamBlock(nn.Module):
    def __init__(self, hidden_size: int, num_heads: int, mlp_ratio: float):
        super().__init__()
        self.hidden_size, self.num_heads = hidden_size, num_heads
        self.mlp_hidden_dim = int(hidden_size * mlp_ratio)
        self.linear1 = nn.Linear(hidden_size,
                                 hidden_size * 3 + self.mlp_hidden_dim)
        self.linear2 = nn.Linear(hidden_size + self.mlp_hidden_dim,
                                 hidden_size)
        self.norm = QKNorm(hidden_size // num_heads)
        self.pre_norm = nn.LayerNorm(hidden_size, elementwise_affine=False,
                                     eps=1e-6)
        self.mlp_act = nn.GELU(approximate="tanh")
        self.modulation = Modulation(hidden_size, double=False)

    def forward(self, x: Tensor, vec: Tensor, pe: Tensor) -> Tensor:
        (shift, scale, gate), _ = self.modulation(vec)
        x_mod = (1 + scale) * self.pre_norm(x) + shift
        qkv, mlp = torch.split(self.linear1(x_mod),
                               [3 * self.hidden_size, self.mlp_hidden_dim],
                               dim=-1)
        q, k, v = heads_first(qkv, self.num_heads)
        q, k = self.norm(q, k, v)
        attn = attention(q, k, v, pe=pe)
        output = self.linear2(torch.cat((attn, self.mlp_act(mlp)), 2))
        return x + gate * output


class LastLayer(nn.Module):
    def __init__(self, hidden_size: int, out_channels: int):
        super().__init__()
        self.norm_final = nn.LayerNorm(hidden_size, elementwise_affine=False,
                                       eps=1e-6)
        self.linear = nn.Linear(hidden_size, out_channels, bias=True)
        self.adaLN_modulation = nn.Sequential(
            nn.SiLU(), nn.Linear(hidden_size, 2 * hidden_size, bias=True))

    def forward(self, x: Tensor, vec: Tensor) -> Tensor:
        shift, scale = self.adaLN_modulation(vec).chunk(2, dim=1)
        x = (1 + scale[:, None, :]) * self.norm_final(x) + shift[:, None, :]
        return self.linear(x)


# ------------------------------------------------------------- model.py


class Stems(nn.Module):
    """Everything of ``Flux`` outside its blocks, under ``Flux``'s names."""

    def __init__(self, p: FluxParams):
        super().__init__()
        self.pe_embedder = EmbedND(p.theta, p.axes_dim)
        self.img_in = nn.Linear(p.in_channels, p.hidden_size, bias=True)
        self.time_in = MLPEmbedder(256, p.hidden_size)
        self.vector_in = MLPEmbedder(p.vec_in_dim, p.hidden_size)
        self.guidance_in = (MLPEmbedder(256, p.hidden_size)
                            if p.guidance_embed else nn.Identity())
        self.txt_in = nn.Linear(p.context_in_dim, p.hidden_size)
        self.final_layer = LastLayer(p.hidden_size, p.in_channels)


def double_block(p: FluxParams) -> DoubleStreamBlock:
    return DoubleStreamBlock(p.hidden_size, p.num_heads, p.mlp_ratio,
                             p.qkv_bias)


def single_block(p: FluxParams) -> SingleStreamBlock:
    return SingleStreamBlock(p.hidden_size, p.num_heads, p.mlp_ratio)


def part_names(p: FluxParams):
    """The parts whose weights come one at a time: "stems", then each
    block."""
    return (["stems"] + [f"double_blocks.{i}" for i in range(p.depth)]
            + [f"single_blocks.{i}" for i in range(p.depth_single_blocks)])


def make_part(p: FluxParams, name: str) -> nn.Module:
    if name == "stems":
        return Stems(p)
    return double_block(p) if name.startswith("double") else single_block(p)


class BlockwiseFlux(nn.Module):
    """``Flux.forward`` with the stems held and each block built from
    ``state_of(part)`` (f32 on the device) when reached, then freed.
    ``prepare(module)`` may change a module once built (the control's
    fp8)."""

    def __init__(self, p: FluxParams, state_of: Callable[[str], Dict],
                 device, prepare: Optional[Callable] = None):
        super().__init__()
        self.p, self.state_of, self.device = p, state_of, device
        self.prepare = prepare or (lambda m: m)
        self.stems = self.build("stems")

    def build(self, name: str) -> nn.Module:
        with torch.device("meta"):
            module = make_part(self.p, name)
        module.load_state_dict(self.state_of(name), assign=True)
        return self.prepare(module.eval())

    def forward(self, img: Tensor, img_ids: Tensor, txt: Tensor,
                txt_ids: Tensor, timesteps: Tensor, y: Tensor,
                guidance: Optional[Tensor] = None) -> Tensor:
        st = self.stems
        img = st.img_in(img)
        vec = st.time_in(timestep_embedding(timesteps, 256))
        if self.p.guidance_embed:
            vec = vec + st.guidance_in(timestep_embedding(guidance, 256))
        vec = vec + st.vector_in(y)
        txt = st.txt_in(txt)
        ids = torch.cat((txt_ids, img_ids), dim=1)
        pe = st.pe_embedder(ids)
        for i in range(self.p.depth):
            block = self.build(f"double_blocks.{i}")
            img, txt = block(img=img, txt=txt, vec=vec, pe=pe)
            del block
        img = torch.cat((txt, img), 1)
        for i in range(self.p.depth_single_blocks):
            block = self.build(f"single_blocks.{i}")
            img = block(img, vec=vec, pe=pe)
            del block
        img = img[:, txt.shape[1]:, ...]
        return st.final_layer(img, vec)


# ---------------------------------------------------------- sampling.py


def pack(x: Tensor) -> Tensor:
    """``b c (h ph) (w pw) -> b (h w) (c ph pw)``, ph = pw = 2."""
    b, c, h, w = x.shape
    x = x.reshape(b, c, h // 2, 2, w // 2, 2).permute(0, 2, 4, 1, 3, 5)
    return x.reshape(b, (h // 2) * (w // 2), c * 4)


def unpack(x: Tensor, h: int, w: int) -> Tensor:
    """``b (h w) (c ph pw) -> b c (h ph) (w pw)``."""
    b, _, d = x.shape
    x = x.reshape(b, h // 2, w // 2, d // 4, 2, 2).permute(0, 3, 1, 4, 2, 5)
    return x.reshape(b, d // 4, h, w)


def grid_ids(first: float, gh: int, gw: int, batch: int, device) -> Tensor:
    """[batch, gh*gw, 3] ids (first, row, col), as ``prepare`` builds
    ``img_ids``."""
    ids = torch.zeros(gh, gw, 3, device=device)
    ids[..., 0] = first
    ids[..., 1] = ids[..., 1] + torch.arange(gh, device=device)[:, None]
    ids[..., 2] = ids[..., 2] + torch.arange(gw, device=device)[None, :]
    return ids.reshape(1, gh * gw, 3).expand(batch, -1, -1)


def velocity(model: nn.Module, latent: Tensor, cond_feats: Tensor,
             t: Tensor, guidance: Tensor) -> Tensor:
    """The model's velocity for a latent [B, C, h, w] and a condition map
    [B, Cc, hc, wc]: image ids (0, row, col), condition ids (1, row, col),
    ``y`` the condition tokens' mean."""
    b, _, h, w = latent.shape
    hc, wc = cond_feats.shape[-2:]
    txt = cond_feats.flatten(2).transpose(1, 2)
    out = model(img=pack(latent),
                img_ids=grid_ids(0.0, h // 2, w // 2, b, latent.device),
                txt=txt, txt_ids=grid_ids(1.0, hc, wc, b, latent.device),
                timesteps=t, y=txt.mean(1), guidance=guidance)
    return unpack(out, h, w)
