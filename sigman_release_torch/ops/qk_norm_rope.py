"""The denoisers' per-head QK RMSNorm and RoPE as one op
(``models/dit.py::JointAttention``, ``models/flux.py``'s double- and
single-stream blocks).

For each stream (its q and k [B, S_i, H, D] and their norms' weights [D]),
every (token, head) row of q and of k is RMS-normalised; the streams are
joined along the tokens; the joined tokens from ``rope_from`` on are
rotated as interleaved pairs against the f32 RoPE tables (table row =
token - ``rope_from``); q and k come back [B, sum S_i, H, D], contiguous,
in the input's dtype: the layout SDPA reads.

The calling model fixes the norm's rounding (``round_before_scale``): the
DiT multiplies by its weight in f32 and rounds once; FLUX rounds to the
input's dtype first, then multiplies by its scale (BFL's order). RoPE
takes the normalised value as rounded, forms ``x cos`` and ``rot sin`` in
f32, adds them and rounds back.

:func:`qk_norm_rope` launches the kernel ``csrc/qk_norm_rope.cu`` once for
all streams, q and k together (counted in ``qk_norm_rope.launches``), when
q and k are CUDA bf16 tensors with D of 64 or 128 and a contiguous last
dim, and no autograd graph is being recorded through them. Anything else
(the CPU, f32, training under autograd) runs :func:`qk_norm_rope_plain`,
the models' own chain of PyTorch ops.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Sequence, Tuple

import torch

from sigman_release_torch.utils import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "qk_norm_rope.cu"
HEAD_DIMS = (64, 128)
MAX_STREAMS = 2

# (q, k, q's norm weight, k's norm weight)
Stream = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]
Rope = Optional[Tuple[torch.Tensor, torch.Tensor]]


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.qk_norm_rope_launch
    fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int] * 5
                   + [ctypes.c_void_p] * 2 + [ctypes.c_int, ctypes.c_float]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float,
             round_before_scale: bool) -> torch.Tensor:
    """RMS norm over the last dim, in ``x``'s dtype. ``round_before_scale``
    False: ``x * rsqrt(var + eps) * weight`` in f32, rounded once (the
    DiT's ``RMSNormPerHead``); True: rounded to ``x``'s dtype, then times
    the weight (FLUX's ``RMSNorm``)."""
    if round_before_scale:
        xf = x.float()
        rrms = torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
        return ((xf * rrms).to(x.dtype) * weight).to(x.dtype)
    var = x.float().pow(2).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * weight).to(x.dtype)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    """x [B,S,h,d]; cos/sin [S,d]. Interleaved-pair rotation
    ((x0,x1) -> (x0 c - x1 s, x1 c + x0 s))."""
    x2 = x.reshape(*x.shape[:-1], -1, 2)
    rot = torch.stack([-x2[..., 1], x2[..., 0]], dim=-1).reshape(x.shape)
    return x * cos[None, :, None, :] + rot * sin[None, :, None, :]


def _rope_tail(x: torch.Tensor, rope, rope_from: int) -> torch.Tensor:
    cos, sin = rope
    if rope_from == 0:
        return apply_rope(x, cos, sin).to(x.dtype)
    return torch.cat([x[:, :rope_from], apply_rope(x[:, rope_from:], cos, sin)
                      .to(x.dtype)], dim=1)


def qk_norm_rope_plain(streams: Sequence[Stream], rope: Rope, rope_from: int,
                       eps: float, round_before_scale: bool):
    """The plain twin of :func:`qk_norm_rope`: each stream's norms, the
    streams joined, RoPE from ``rope_from`` on, as PyTorch ops."""
    qs = [rms_norm(q, wq, eps, round_before_scale) for q, _, wq, _ in streams]
    ks = [rms_norm(k, wk, eps, round_before_scale) for _, k, _, wk in streams]
    q = qs[0] if len(qs) == 1 else torch.cat(qs, dim=1)
    k = ks[0] if len(ks) == 1 else torch.cat(ks, dim=1)
    if rope is None:
        return q, k
    return _rope_tail(q, rope, rope_from), _rope_tail(k, rope, rope_from)


def engages(streams: Sequence[Stream], rope: Rope) -> bool:
    """Whether :func:`qk_norm_rope` launches the kernel for these inputs:
    CUDA bf16 q and k with D in ``HEAD_DIMS`` and a contiguous last dim,
    and no autograd graph recorded through any input."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for s in streams for t in (*s, *(rope or ()))):
        return False
    return all(x.is_cuda and x.dtype == torch.bfloat16
               and x.shape[-1] in HEAD_DIMS and x.stride(-1) == 1
               for s in streams for x in s[:2])


def qk_norm_rope(streams: Sequence[Stream], rope: Rope, rope_from: int,
                 eps: float, round_before_scale: bool):
    """q, k [B, sum S_i, H, D] of ``streams`` (each ``(q, k, q_weight,
    k_weight)``, q and k [B, S_i, H, D]) normalised, joined and rotated
    from token ``rope_from`` on with ``rope`` = (cos, sin) [S - rope_from,
    D] f32 (None: no rotation). The kernel where :func:`engages`, else
    :func:`qk_norm_rope_plain`."""
    if not engages(streams, rope):
        return qk_norm_rope_plain(streams, rope, rope_from, eps,
                                  round_before_scale)
    return _launch(streams, rope, rope_from, eps, round_before_scale)


qk_norm_rope.launches = 0


def _launch(streams, rope, rope_from, eps, round_before_scale):
    q0 = streams[0][0]
    batch, _, heads, d = q0.shape
    dev = q0.device
    if not 1 <= len(streams) <= MAX_STREAMS:
        raise ValueError(f"qk_norm_rope takes 1 to {MAX_STREAMS} streams, "
                         f"got {len(streams)}")
    w_dtype = streams[0][2].dtype
    align = d // 16                 # bytes a lane loads at once: 4 or 8
    tokens = 0
    for q, k, wq, wk in streams:
        for x in (q, k):
            if (x.ndim != 4 or x.shape[0] != batch or x.shape[2:] != (heads, d)
                    or x.shape[1] != q.shape[1] or x.device != dev):
                raise ValueError(f"qk_norm_rope: q and k must all be [{batch}, "
                                 f"S, {heads}, {d}] on {dev}, got "
                                 f"{tuple(x.shape)} on {x.device}")
            if x.data_ptr() % align or any(st % (align // 2)
                                           for st in x.stride()[:3]):
                raise ValueError(f"qk_norm_rope: the kernel's loads of q and "
                                 f"k must be {align}-byte aligned")
        for w in (wq, wk):
            if (w.shape != (d,) or w.dtype != w_dtype or w.device != dev
                    or w.dtype not in (torch.bfloat16, torch.float32)
                    or not w.is_contiguous()
                    or w.data_ptr() % (2 * w.element_size())):
                raise ValueError(f"qk_norm_rope: weights must be [{d}] bf16 "
                                 f"or f32, one dtype, contiguous on {dev}")
        tokens += q.shape[1]
    if batch * tokens >= 2 ** 31:
        raise ValueError("qk_norm_rope: past the kernel's 32-bit rows")
    cos = sin = None
    if rope is not None and rope_from < tokens:
        cos, sin = rope
        for t in (cos, sin):
            if (t.dtype != torch.float32 or not t.is_contiguous()
                    or t.device != dev or t.ndim != 2 or t.shape[1] != d
                    or t.shape[0] < tokens - rope_from
                    or t.data_ptr() % 8):
                raise ValueError(f"qk_norm_rope: RoPE tables must be f32 "
                                 f"contiguous [{tokens - rope_from}, {d}] "
                                 f"on {dev}, got {t.dtype} "
                                 f"{tuple(t.shape)}")
    else:
        rope_from = tokens
    out_q = torch.empty((batch, tokens, heads, d), dtype=torch.bfloat16,
                        device=dev)
    out_k = torch.empty_like(out_q)
    desc, at = [], 0
    for q, k, wq, wk in streams:
        for x, out, w in ((q, out_q, wq), (k, out_k, wk)):
            desc += [x.data_ptr(), out.data_ptr(), w.data_ptr(),
                     *x.stride()[:3], x.shape[1], at]
        at += q.shape[1]
    words = (ctypes.c_longlong * len(desc))(*desc)
    stream = torch.cuda.current_stream(dev).cuda_stream
    rc = _library().qk_norm_rope_launch(
        words, 2 * len(streams), batch, heads, d, tokens,
        cos.data_ptr() if cos is not None else None,
        sin.data_ptr() if sin is not None else None, rope_from, eps,
        int(round_before_scale), int(w_dtype == torch.float32), stream)
    if rc != 0:
        raise RuntimeError(f"qk_norm_rope kernel launch failed: cudaError "
                           f"{rc}")
    qk_norm_rope.launches += 1
    return out_q, out_k
