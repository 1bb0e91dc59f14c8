"""The denoisers' AdaLN passes as one op (``models/dit.py::DiTBlock``,
``models/flux.py``'s double- and single-stream blocks).

For each of one or two streams (x [B, S_i, D]): optionally the gated
residual add ``x' = x + gate * y`` (gate [B, 1, D], y [B, S_i, D], any view
with a contiguous last dim, such as a stream's slice of a joined output),
and optionally the LayerNorm over D (with or without an affine weight and
bias) modulated as ``LN(x') * (1 + scale) + shift`` (scale, shift [B, 1, D]),
the streams' results joined along the tokens into one [B, sum S_i, D]
buffer (``join``) or each in its own. Every value is rounded to the
input's dtype where the models' chain of PyTorch ops rounds it.

:func:`norm_modulate` and :func:`gated_residual` launch the kernel
``csrc/ada_norm.cu`` once for all streams (counted in
``ada_norm.launches``) when every tensor is a plain CUDA bf16 tensor with D
of 2048 or 3072, autocast is off and no autograd graph is being recorded
through them. Such tensors with a strided last dim or rows that are not
16-byte aligned raise a ValueError rather than run the plain chain, so no
layout upstream takes the kernel off the serving path unseen. Anything else
(the CPU, f32, autocast, training under autograd, a DTensor, another D)
runs :func:`norm_modulate_plain` / :func:`gated_residual_plain`, the
models' own chain of PyTorch ops.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F
from torch import nn

from sigman_release_torch.utils import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "ada_norm.cu"
DIMS = (2048, 3072)
MAX_STREAMS = 2
_PLAIN = (torch.Tensor, nn.Parameter)   # not a DTensor or another subclass


class Norm(NamedTuple):
    """The LayerNorm before a modulation: its affine weight and bias [D]
    (both None: no affine) and eps. An ``nn.LayerNorm`` serves as well."""
    weight: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    eps: float


Mod = Tuple[torch.Tensor, torch.Tensor]      # (shift, scale), each [B, 1, D]
Normed = Union[torch.Tensor, List[torch.Tensor]]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.ada_norm_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def norm_modulate_plain(xs: Sequence[torch.Tensor], mods: Sequence[Mod], norm,
                        join: bool = True) -> Normed:
    """The plain twin of :func:`norm_modulate`."""
    outs = [F.layer_norm(x, x.shape[-1:], norm.weight, norm.bias, norm.eps)
            * (1 + scale) + shift for x, (shift, scale) in zip(xs, mods)]
    if not join:
        return outs
    return outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)


def gated_residual_plain(xs: Sequence[torch.Tensor],
                         gates: Sequence[torch.Tensor],
                         ys: Sequence[torch.Tensor],
                         mods: Optional[Sequence[Mod]] = None, norm=None,
                         join: bool = True):
    """The plain twin of :func:`gated_residual`."""
    new = [x + gate * y for x, gate, y in zip(xs, gates, ys)]
    if mods is None:
        return new
    return new, norm_modulate_plain(new, mods, norm, join)


def _tensors(xs, gates, ys, mods, norm) -> List[torch.Tensor]:
    out = list(xs)
    if gates is not None:
        out += [*gates, *ys]
    if mods is not None:
        out += [t for mod in mods for t in mod]
        out += [t for t in (norm.weight, norm.bias) if t is not None]
    return out


def engages(tensors: Sequence[torch.Tensor]) -> bool:
    """Whether the op launches the kernel for these inputs: plain CUDA bf16
    tensors with D in ``DIMS``, autocast off, and no autograd graph recorded
    through any. Raises a ValueError where such tensors have a strided last
    dim or rows that are not 16-byte aligned."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    if not tensors[0].is_cuda or torch.is_autocast_enabled("cuda"):
        return False
    if not all(type(t) in _PLAIN and t.is_cuda and t.dtype == torch.bfloat16
               and t.shape[-1] in DIMS for t in tensors):
        return False
    for i, t in enumerate(tensors):
        if not (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
                and all(st % 8 == 0 for st in t.stride()[:-1])):
            raise ValueError(
                f"ada_norm: input {i} of shape {tuple(t.shape)} has strides "
                f"{t.stride()} at byte {t.data_ptr() % 16} of 16; the kernel "
                f"takes a contiguous last dim and 16-byte aligned rows "
                f"(make the tensor contiguous upstream)")
    return True


def norm_modulate(xs: Sequence[torch.Tensor], mods: Sequence[Mod], norm,
                  join: bool = True) -> Normed:
    """``LN(x_i) * (1 + scale_i) + shift_i`` of each stream ``xs[i]`` [B,
    S_i, D], ``mods[i]`` = (shift, scale) [B, 1, D], ``norm`` a
    :class:`Norm` (or ``nn.LayerNorm``): one [B, sum S_i, D] tensor with
    ``join``, else a list. The kernel where :func:`engages`, else
    :func:`norm_modulate_plain`."""
    if not engages(_tensors(xs, None, None, mods, norm)):
        return norm_modulate_plain(xs, mods, norm, join)
    return ada_norm(xs, None, None, mods, norm, join)[1]


def gated_residual(xs: Sequence[torch.Tensor], gates: Sequence[torch.Tensor],
                   ys: Sequence[torch.Tensor],
                   mods: Optional[Sequence[Mod]] = None, norm=None,
                   join: bool = True):
    """``x_i + gate_i * y_i`` of each stream (x, y [B, S_i, D], gate [B, 1,
    D]), new tensors; with ``mods`` and ``norm`` also
    :func:`norm_modulate` of the new streams, in the same launch, returned
    as ``(new xs, normed)``. The kernel where :func:`engages`, else
    :func:`gated_residual_plain`."""
    if not engages(_tensors(xs, gates, ys, mods, norm)):
        return gated_residual_plain(xs, gates, ys, mods, norm, join)
    new, normed = ada_norm(xs, gates, ys, mods, norm, join)
    return new if mods is None else (new, normed)


def ada_norm(xs, gates, ys, mods, norm, join):
    """One launch of the kernel for :func:`norm_modulate` (``gates`` None)
    or :func:`gated_residual`: (the new xs or None, the normed or None).
    Checks shapes and devices only (:func:`engages` has checked the rest)."""
    batch, _, dim = xs[0].shape
    dev = xs[0].device
    if not 1 <= len(xs) <= MAX_STREAMS:
        raise ValueError(f"ada_norm takes 1 to {MAX_STREAMS} streams, got "
                         f"{len(xs)}")
    rows = (batch, 1, dim)
    for i, x in enumerate(xs):
        like = (batch, x.shape[1], dim)
        shaped = [(x, like)]
        if gates is not None:
            shaped += [(gates[i], rows), (ys[i], like)]
        if mods is not None:
            shaped += [(mods[i][0], rows), (mods[i][1], rows)]
        for t, want in shaped:
            if t.shape != want or t.device != dev:
                raise ValueError(f"ada_norm: stream {i} wants {want} "
                                 f"([B, 1, D] for gates and modulation) on "
                                 f"{dev}, got {tuple(t.shape)} on {t.device}")
    weight = bias = None
    if mods is not None and (norm.weight is not None or norm.bias is not None):
        weight, bias = norm.weight, norm.bias
        if weight is None or bias is None or any(
                t.shape != (dim,) or not t.is_contiguous()
                or t.device != dev for t in (weight, bias)):
            raise ValueError(f"ada_norm: the norm takes a weight and a bias "
                             f"of [{dim}], contiguous, or neither")
    tokens = sum(x.shape[1] for x in xs)
    if batch * tokens >= 2 ** 31:
        raise ValueError("ada_norm: past the kernel's 32-bit rows")
    new = normed = None
    if gates is not None:
        new = [torch.empty((batch, x.shape[1], dim), dtype=torch.bfloat16,
                           device=dev) for x in xs]
    if mods is not None:
        if join:
            normed = torch.empty((batch, tokens, dim), dtype=torch.bfloat16,
                                 device=dev)
        else:
            normed = [torch.empty((batch, x.shape[1], dim),
                                  dtype=torch.bfloat16, device=dev)
                      for x in xs]
    desc, at = [], 0
    for i, x in enumerate(xs):
        s = x.shape[1]
        desc += [x.data_ptr(), *x.stride()[:2]]
        if gates is not None:
            desc += [ys[i].data_ptr(), *ys[i].stride()[:2],
                     gates[i].data_ptr(), gates[i].stride(0),
                     new[i].data_ptr(), s * dim, dim]
        else:
            desc += [0] * 8
        if mods is not None:
            shift, scale = mods[i]
            desc += [shift.data_ptr(), shift.stride(0), scale.data_ptr(),
                     scale.stride(0)]
            if join:       # the stream's first token in the joined buffer
                desc += [normed.data_ptr() + 2 * at * dim, tokens * dim, dim]
            else:
                desc += [normed[i].data_ptr(), s * dim, dim]
        else:
            desc += [0] * 7
        desc.append(s)
        at += s
    rc = _library().ada_norm_launch(
        (ctypes.c_longlong * len(desc))(*desc), len(xs), batch, dim,
        int(gates is not None), int(mods is not None),
        None if weight is None else weight.data_ptr(),
        None if bias is None else bias.data_ptr(),
        norm.eps if mods is not None else 0.0,
        torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ada_norm kernel launch failed: cudaError {rc}")
    ada_norm.launches += 1
    return new, normed


ada_norm.launches = 0
