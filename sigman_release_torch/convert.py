"""Flax parameter trees -> this package's ``state_dict``s, and Sapiens
weights -> the conditioning encoder.

Takes the JAX package's parameter trees as nested dicts of numpy arrays (for
example ``np.asarray`` mapped over each leaf) and returns ``state_dict``s for
the VAE (decode side alone, or encoder + bottleneck + decoder + heads), the
DiT, the ViT conditioning encoder (sincos or learned positions), LPIPS and
the PatchGAN discriminator:

* conv kernels HWIO -> OIHW, 3D conv kernels DHWIO -> OIDHW,
* Dense kernels ``[in, out]`` -> Linear weights ``[out, in]``,
* Flax multi-head attention kernels ``[d, heads, hd]`` / ``[heads, hd, d]``
  -> Linear weights ``[heads*hd, d]`` / ``[d, heads*hd]``,
* LayerNorm / GroupNorm / RMSNorm ``scale`` -> ``weight``.

Every parameter of the target module must be found with its shape;
anything missing or mismatched raises.

``convert_sapiens`` (the counterpart of ``scripts/convert_sapiens.py``) maps
an mmpretrain-style ViT ``state_dict`` (``patch_embed.projection``,
``pos_embed``, ``layers.{i}.ln1 / attn.qkv / attn.proj / ln2 /
ffn.layers.0.0 / ffn.layers.1``, the final ``ln1``, under any prefix) onto
``models.encoders.sapiens_1b_encoder`` or any learned-position
``ViTFeatureEncoder``; ``load_sapiens_source`` reads a torchscript file or a
saved ``state_dict``.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Tuple

import numpy as np
import torch
from torch import nn

KeyMap = Dict[str, Tuple[Tuple[str, ...], Callable]]


def _conv(w):
    return np.asarray(w).transpose(3, 2, 0, 1)


def _conv3d(w):
    return np.asarray(w).transpose(4, 3, 0, 1, 2)


def _dense(w):
    return np.asarray(w).T


def _same(w):
    return np.asarray(w)


def _heads_in(w):
    """Flax MHA q/k/v kernel [d, h, hd] -> Linear weight [h*hd, d]."""
    w = np.asarray(w)
    return w.reshape(w.shape[0], -1).T


def _heads_out(w):
    """Flax MHA out kernel [h, hd, d] -> Linear weight [d, h*hd]."""
    w = np.asarray(w)
    return w.reshape(-1, w.shape[-1]).T


def _flat(b):
    return np.asarray(b).reshape(-1)


def _conv_entry(m: KeyMap, key: str, path: tuple, bias: bool = True,
                tfm=_conv):
    m[f"{key}.weight"] = (path + ("kernel",), tfm)
    if bias:
        m[f"{key}.bias"] = (path + ("bias",), _same)


def _dense_entry(m: KeyMap, key: str, path: tuple, bias: bool = True):
    m[f"{key}.weight"] = (path + ("kernel",), _dense)
    if bias:
        m[f"{key}.bias"] = (path + ("bias",), _same)


def _norm_entry(m: KeyMap, key: str, path: tuple, bias: bool = True):
    m[f"{key}.weight"] = (path + ("scale",), _same)
    if bias:
        m[f"{key}.bias"] = (path + ("bias",), _same)


def vae_decode_key_map(cfg) -> KeyMap:
    """Port ``VAEModel`` keys -> Flax ``VAEModel`` paths (decode side)."""
    m: KeyMap = {}
    dec = ("params", "autoencoder", "decoder")
    pre = "autoencoder.decoder"
    _conv_entry(m, f"{pre}.conv_in", dec + ("conv_in",))
    chans = list(reversed(cfg.decoder_channels))
    prev = chans[0]
    for i, ch in enumerate(chans):
        for j in range(4):                     # layers_per_block (3) + 1
            t = f"{pre}.up_blocks.{i}.resnets.{j}"
            f = dec + (f"up_blocks_{i}_resnets_{j}",)
            _norm_entry(m, f"{t}.norm1", f + ("norm1",))
            _conv_entry(m, f"{t}.conv1", f + ("conv1",))
            _norm_entry(m, f"{t}.norm2", f + ("norm2",))
            _conv_entry(m, f"{t}.conv2", f + ("conv2",))
            if (prev if j == 0 else ch) != ch:
                _conv_entry(m, f"{t}.conv_shortcut", f + ("conv_shortcut",))
        if i < len(chans) - 1:
            _conv_entry(m, f"{pre}.up_blocks.{i}.upsamplers.0.conv",
                        dec + (f"up_blocks_{i}_upsamplers_0", "conv"))
        prev = ch
    _norm_entry(m, f"{pre}.norm_out", dec + ("norm_out",))
    _conv_entry(m, f"{pre}.conv_out", dec + ("conv_out",))
    for head in ("decode_gaussian_geo", "decode_gaussian_rgb"):
        _conv_entry(m, f"heads.{head}", ("params", "heads", head))
    return m


def _attn_entries(m: KeyMap, key: str, path: tuple, cross: bool):
    _norm_entry(m, f"{key}.group_norm", path + ("group_norm",))
    if cross:
        _norm_entry(m, f"{key}.norm_cross", path + ("norm_cross",))
    for n in ("to_q", "to_k", "to_v"):
        _dense_entry(m, f"{key}.{n}", path + (n,), bias=False)
    for n in ("norm_q", "norm_k"):
        _norm_entry(m, f"{key}.{n}", path + (n,))
    _dense_entry(m, f"{key}.to_out", path + ("to_out",))


def vae_key_map(cfg) -> KeyMap:
    """Port ``VAEModel`` keys -> Flax ``VAEModel`` paths (whole model)."""
    m = vae_decode_key_map(cfg)
    ae = ("params", "autoencoder")
    enc = ae + ("encoder",)
    pre = "autoencoder.encoder"
    _conv_entry(m, f"{pre}.conv_in", enc + ("conv_in",), tfm=_conv3d)
    prev = cfg.encoder_channels[0]
    for i, ch in enumerate(cfg.encoder_channels):
        for j in range(2):                     # layers_per_block
            t = f"{pre}.down_blocks.{i}.resnets.{j}"
            f = enc + (f"down_blocks_{i}_resnets_{j}",)
            _norm_entry(m, f"{t}.norm1", f + ("norm1",))
            _conv_entry(m, f"{t}.conv1", f + ("conv1",), tfm=_conv3d)
            _norm_entry(m, f"{t}.norm2", f + ("norm2",))
            _conv_entry(m, f"{t}.conv2", f + ("conv2",), tfm=_conv3d)
            if (prev if j == 0 else ch) != ch:
                _conv_entry(m, f"{t}.conv_shortcut", f + ("conv_shortcut",),
                            tfm=_conv3d)
        if i < len(cfg.encoder_channels) - 1:
            _conv_entry(m, f"{pre}.down_blocks.{i}.downsamplers.0.conv",
                        enc + (f"down_blocks_{i}_downsamplers_0", "conv"))
        prev = ch
    m["autoencoder.uv_latent"] = (ae + ("uv_latent",), _same)
    _conv_entry(m, "autoencoder.uv_encoding.0", ae + ("uv_encoding_0",))
    _norm_entry(m, "autoencoder.uv_encoding.1", ae + ("uv_encoding_1",))
    _attn_entries(m, "autoencoder.attention.cross_attn",
                  ae + ("attention_cross_attn",), cross=True)
    for i in range(cfg.self_attention_layers):
        t = f"autoencoder.attention.middle_layers.{i}"
        f = ae + (f"attention_middle_layers_{i}",)
        _attn_entries(m, f"{t}.attn", f + ("attn",), cross=False)
        _conv_entry(m, f"{t}.conv", f + ("conv",))
        _norm_entry(m, f"{t}.norm", f + ("norm",))
    _dense_entry(m, "autoencoder.projection", ae + ("projection",))
    return m


def lpips_key_map() -> KeyMap:
    """Port ``LPIPS`` keys -> Flax ``LPIPS`` (VGG) paths."""
    from sigman_release_torch.losses.lpips import VGG_CONVS

    m: KeyMap = {}
    p = ("params",)
    for bi, n in enumerate(VGG_CONVS):
        for ci in range(n):
            _conv_entry(m, f"vgg.conv{bi}_{ci}", p + ("vgg", f"conv{bi}_{ci}"))
    for i in range(len(VGG_CONVS)):
        _conv_entry(m, f"lins.{i}", p + (f"lin{i}",), bias=False)
    return m


def disc_key_map(n_layers: int) -> KeyMap:
    """Port ``PatchDiscriminator`` keys -> Flax auto-named paths."""
    m: KeyMap = {}
    p = ("params",)
    for k in range(n_layers + 2):
        # first and last convs carry a bias; the normed ones do not
        _conv_entry(m, f"convs.{k}", p + (f"Conv_{k}",),
                    bias=k in (0, n_layers + 1))
    for k in range(n_layers):
        _norm_entry(m, f"norms.{k}", p + (f"GroupNorm_{k}",))
    return m


def dit_key_map(n_layers: int) -> KeyMap:
    """Port ``DiTModel`` keys (the reference checkpoint's) -> Flax paths."""
    m: KeyMap = {}
    p = ("params",)
    _conv_entry(m, "patch_embed.proj", p + ("patch_embed", "proj"))
    _conv_entry(m, "patch_embed.cond_proj", p + ("patch_embed", "cond_proj"))
    _dense_entry(m, "time_embedding.linear_1", p + ("time_emb_1",))
    _dense_entry(m, "time_embedding.linear_2", p + ("time_emb_2",))
    _norm_entry(m, "norm_final", p + ("norm_final",))
    _dense_entry(m, "norm_out.linear", p + ("norm_out_proj",))
    _norm_entry(m, "norm_out.norm", p + ("norm_out",))
    _dense_entry(m, "proj_out", p + ("proj_out",))
    for i in range(n_layers):
        t = f"transformer_blocks.{i}"
        f = p + (f"block_{i}",)
        for n in ("norm1", "norm2"):
            _dense_entry(m, f"{t}.{n}.linear", f + (n, "Dense_0"))
            _norm_entry(m, f"{t}.{n}.norm", f + (n, "LayerNorm_0"))
        for n in ("to_q", "to_k", "to_v"):
            _dense_entry(m, f"{t}.attn1.{n}", f + ("attn1", n))
        for n in ("norm_q", "norm_k"):
            _norm_entry(m, f"{t}.attn1.{n}", f + ("attn1", n), bias=False)
        _dense_entry(m, f"{t}.attn1.to_out.0", f + ("attn1", "to_out"))
        _dense_entry(m, f"{t}.ff.net.0.proj", f + ("ff", "Dense_0"))
        _dense_entry(m, f"{t}.ff.net.2", f + ("ff", "Dense_1"))
    return m


def vit_key_map(depth: int) -> KeyMap:
    """Port ``ViTFeatureEncoder`` keys -> Flax ``ViTFeatureEncoder`` paths
    (``pos_embed`` is read only by a learned-position encoder)."""
    m: KeyMap = {}
    p = ("params",)
    _conv_entry(m, "patch_proj", p + ("patch_proj",))
    m["pos_embed"] = (p + ("pos_embed",), _same)
    for i in range(depth):
        t, f = f"blocks.{i}", f"blocks_{i}"
        _norm_entry(m, f"{t}.ln1", p + (f"{f}_ln1",))
        _norm_entry(m, f"{t}.ln2", p + (f"{f}_ln2",))
        for n in ("query", "key", "value"):
            m[f"{t}.attn.{n}.weight"] = (p + (f"{f}_attn", n, "kernel"),
                                         _heads_in)
            m[f"{t}.attn.{n}.bias"] = (p + (f"{f}_attn", n, "bias"), _flat)
        m[f"{t}.attn.out.weight"] = (p + (f"{f}_attn", "out", "kernel"),
                                     _heads_out)
        m[f"{t}.attn.out.bias"] = (p + (f"{f}_attn", "out", "bias"), _same)
        _dense_entry(m, f"{t}.ffn1", p + (f"{f}_ffn1",))
        _dense_entry(m, f"{t}.ffn2", p + (f"{f}_ffn2",))
    _norm_entry(m, "norm_out", p + ("norm_out",))
    return m


def _lookup(tree, path):
    node = tree
    for k in path:
        if not isinstance(node, dict) or k not in node:
            raise KeyError("/".join(path))
        node = node[k]
    return node


def convert(tree, module: nn.Module, key_map: KeyMap) -> Dict[str, torch.Tensor]:
    """Build ``module``'s full state_dict from a Flax tree through
    ``key_map``; raises on any missing, unmapped or mis-shaped parameter."""
    out = {}
    missing, bad = [], []
    for name, ref in module.state_dict().items():
        if name not in key_map:
            missing.append(name)
            continue
        path, tfm = key_map[name]
        try:
            w = tfm(_lookup(tree, path))
        except KeyError as e:
            missing.append(f"{name} <- {e}")
            continue
        if tuple(w.shape) != tuple(ref.shape):
            bad.append(f"{name}: {w.shape} vs {tuple(ref.shape)}")
            continue
        out[name] = torch.tensor(np.ascontiguousarray(w), dtype=ref.dtype)
    if missing or bad:
        raise ValueError("Flax tree does not match the module: "
                         f"missing {missing[:10]}, mismatched {bad[:10]}")
    return out


def convert_vae_decode(tree, module, cfg):
    return convert(tree, module, vae_decode_key_map(cfg))


def convert_dit(tree, module, cfg):
    return convert(tree, module, dit_key_map(cfg.num_layers))


def convert_vit(tree, module):
    return convert(tree, module, vit_key_map(len(module.blocks)))


def convert_vae(tree, module, cfg):
    return convert(tree, module, vae_key_map(cfg))


def convert_lpips(tree, module):
    return convert(tree, module, lpips_key_map())


def convert_disc(tree, module):
    return convert(tree, module, disc_key_map(len(module.norms)))


# mmpretrain ViT key patterns (any prefix): (regex, kind); group 1 is the
# layer index. The layer rules come before the final norm's.
SAPIENS_RULES = [
    (r"patch_embed\.proj(?:ection)?\.(weight|bias)$", "patch"),
    (r"pos_embed$", "pos_embed"),
    (r"layers?\.(\d+)\.(?:ln|norm)1\.(weight|bias)$", "ln1"),
    (r"layers?\.(\d+)\.attn\.qkv\.(weight|bias)$", "qkv"),
    (r"layers?\.(\d+)\.attn\.proj\.(weight|bias)$", "attn.out"),
    (r"layers?\.(\d+)\.(?:ln|norm)2\.(weight|bias)$", "ln2"),
    (r"layers?\.(\d+)\.(?:ffn\.layers\.0\.0|mlp\.fc1)\.(weight|bias)$",
     "ffn1"),
    (r"layers?\.(\d+)\.(?:ffn\.layers\.1|mlp\.fc2)\.(weight|bias)$",
     "ffn2"),
    (r"(?:^|\.)(?:ln1|norm|ln)\.(weight|bias)$", "norm_out"),
]


def load_sapiens_source(path: str) -> Dict[str, np.ndarray]:
    """A Sapiens checkpoint -> {key: array}: a torchscript file (``.pt2``,
    ``.pt``, ``.ts``) through ``torch.jit.load``, else a saved
    ``state_dict`` (or ``{"state_dict": ...}``) through ``torch.load``."""
    if path.endswith((".pt2", ".pt", ".ts")):
        try:
            module = torch.jit.load(path, map_location="cpu")
        except RuntimeError:      # not torchscript: a pickled state_dict
            pass
        else:
            return {k: v.detach().numpy()
                    for k, v in module.state_dict().items()}
    sd = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    return {k: np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)
            for k, v in sd.items()}


def convert_sapiens(sd: Dict[str, np.ndarray], module: nn.Module,
                    verbose: bool = False):
    """An mmpretrain-style ViT ``state_dict`` -> ``module``'s (a
    learned-position ``ViTFeatureEncoder``). ``qkv`` splits into query /
    key / value; a ``pos_embed`` one row longer than the module's loses its
    class-token row. Returns (state_dict, stats): ``stats`` lists the
    source keys no rule matched (``unmatched``), the module's parameters no
    source key filled (``missing``) and shape mismatches (``mismatches``);
    the state_dict holds what was converted."""
    target = module.state_dict()
    out: Dict[str, torch.Tensor] = {}
    mismatches, unmatched = [], []

    def put(name, w):
        w = np.asarray(w, np.float32)
        if name not in target:
            mismatches.append(f"{name}: not a parameter of the module")
        elif tuple(w.shape) != tuple(target[name].shape):
            mismatches.append(f"{name}: {w.shape} vs "
                              f"{tuple(target[name].shape)}")
        else:
            out[name] = torch.from_numpy(np.ascontiguousarray(w))

    for key, w in sd.items():
        for pattern, kind in SAPIENS_RULES:
            m = re.search(pattern, key)
            if m is None:
                continue
            w = np.asarray(w)
            groups = m.groups()
            leaf = groups[-1] if groups else None
            block = f"blocks.{groups[0]}." if len(groups) == 2 else ""
            if kind == "patch":
                put(f"patch_proj.{leaf}", w)
            elif kind == "pos_embed":
                n = target["pos_embed"].shape[1] if "pos_embed" in target \
                    else None
                put("pos_embed", w[:, 1:] if w.shape[1] == (n or 0) + 1
                    else w)
            elif kind == "qkv":
                for name, part in zip(("query", "key", "value"),
                                      np.split(w, 3, axis=0)):
                    put(f"{block}attn.{name}.{leaf}", part)
            else:
                put(f"{block}{kind}.{leaf}", w)
            break
        else:
            unmatched.append(key)
    missing = sorted(k for k in target if k not in out)
    stats = {"converted": len(out), "mismatches": mismatches,
             "unmatched": sorted(unmatched), "missing": missing}
    if verbose:
        print(f"[sapiens] {len(out)} converted, {len(mismatches)} "
              f"mismatches, {len(unmatched)} unmatched source keys, "
              f"{len(missing)} parameters missing", flush=True)
        for line in mismatches[:20]:
            print("  mismatch:", line)
        for line in stats["unmatched"][:40]:
            print("  unmatched (dropped):", line)
        for line in missing[:20]:
            print("  missing:", line)
    return out, stats
