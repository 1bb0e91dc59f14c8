"""K1: per-tile front-to-back alpha compositing — CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``ops/rasterizer/pallas_forward.py::
forward_tiles`` of the JAX package. One program per (view, 32x32 tile)
composites the tile's depth-sorted pair segment
``[tile_start, tile_start + tile_count)`` of the row-major ``[budget, 16]``
pair stream. Rules (shared with the JAX package's dense oracle):

* alpha = min(0.99, opa exp(min(power, 0))); 0 where power > POWER_EPS or
  opa exp(min(power, 0)) < 1/255. The exponent is the tile-local expanded
  quadratic (coefficients c0, cx, cy, -a/2, -b, -c/2) in the kernel and the
  plain version alike — see the clamp note in ``_alpha``;
* a pair contributes while T_incl >= 1e-4; Tf multiplies through every pair,
  Tr is the min of T_incl over contributors;
* output ``[n_programs, 8, TILE^2]``: rgb (no background), depth, 1 - Tr, Tr,
  0, 0.

``forward_tiles`` launches the CUDA kernel (``csrc/forward_tiles.cu``) for a
CUDA tensor and takes the plain version only for a CPU tensor.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from sigman_release_torch.ops.rasterizer.binning import (
    ALPHA_MIN, F_CA, F_CB, F_CC, F_DEPTH, F_MX, F_MY, F_OPA, F_R, PAIR_FEATS,
    TILE,
)
from sigman_release_torch.utils import cuda_build

ALPHA_MAX = 0.99
T_EPS = 1e-4
# positive-power tolerance of the expanded-quadratic exponent (f32 rounding
# can leave power at +eps on a pixel sitting on the mean)
POWER_EPS = 1e-3
# elements of one step of the plain version (tiles x chunk x pixels)
PLAIN_STEP_ELEMS = 1 << 25

SOURCE = Path(__file__).resolve().parent / "csrc" / "forward_tiles.cu"


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.forward_tiles_launch
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def forward_tiles(pairs: torch.Tensor, tile_start: torch.Tensor,
                  tile_count: torch.Tensor, *, ntx: int, tiles_per_view: int,
                  chunk: int = 128) -> torch.Tensor:
    """Composite every (view, tile) segment. Returns [n, 8, TILE^2] f32.

    pairs [budget, 16] f32; tile_start / tile_count [n] int32. CUDA tensors
    launch the kernel (counted in ``forward_tiles.launches``); CPU tensors
    run :func:`forward_tiles_plain` (``chunk`` sets its pair grouping).
    """
    if pairs.device.type == "cpu":
        return forward_tiles_plain(pairs, tile_start, tile_count, ntx=ntx,
                                   tiles_per_view=tiles_per_view, chunk=chunk)
    if pairs.device.type != "cuda":
        raise ValueError(f"forward_tiles: unsupported device {pairs.device}")
    n = tile_start.shape[0]
    if pairs.dtype != torch.float32 or pairs.ndim != 2 \
            or pairs.shape[1] != PAIR_FEATS:
        raise ValueError(f"pairs must be [budget, {PAIR_FEATS}] float32, got "
                         f"{tuple(pairs.shape)} {pairs.dtype}")
    for name, x in (("tile_start", tile_start), ("tile_count", tile_count)):
        if x.dtype != torch.int32 or x.shape != (n,) or x.device != pairs.device:
            raise ValueError(f"{name} must be int32 [{n}] on {pairs.device}")
    if not (pairs.is_contiguous() and tile_start.is_contiguous()
            and tile_count.is_contiguous()):
        raise ValueError("forward_tiles needs contiguous inputs")
    if pairs.data_ptr() % 16:
        raise ValueError("pairs must be 16-byte aligned")
    out = torch.empty((n, 8, TILE * TILE), dtype=torch.float32,
                      device=pairs.device)
    lib = _library()
    stream = torch.cuda.current_stream(pairs.device).cuda_stream
    rc = lib.forward_tiles_launch(
        pairs.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
        out.data_ptr(), n, ntx, tiles_per_view, stream)
    if rc != 0:
        raise RuntimeError(f"forward_tiles kernel launch failed: cudaError {rc}")
    forward_tiles.launches += 1
    return out


forward_tiles.launches = 0


def _fma(a, b, c):
    """f32 fused multiply-add: the product is exact in f64, one rounding."""
    return (a.double() * b.double() + c.double()).float()


def _alpha(feats, ox, oy, basis, row_ok):
    """Per-pair, per-pixel alpha and the mask of exponents not cut as
    positive. feats [n,K,16]; ox/oy [n,1]; basis [6,P].

    The exponent is a per-pair quadratic in tile-local pixel coordinates,
    evaluated from its expanded coefficients. Near a tile edge the terms are
    hundreds of times larger than their sum, so the rounding of each step
    shows in alpha: the coefficients and the sum are fused multiply-adds in
    one fixed order, the order the CUDA kernel uses (and the one XLA's CPU
    backend gives the JAX package's kernel). f32 cancellation can leave
    power at +eps exactly where the true quadratic is ~0 (a pixel on the
    mean, where alpha is largest), so the exponent is clamped at 0 and only
    grossly positive power (> POWER_EPS, a broken conic) is dropped.
    """
    ml = feats[..., F_MX] - ox
    nl = feats[..., F_MY] - oy
    ca, cb, cc = feats[..., F_CA], feats[..., F_CB], feats[..., F_CC]
    cbm = cb * ml
    c0 = -0.5 * _fma(ca * ml, ml, (cc * nl) * nl) - cbm * nl
    coeffs = (c0, _fma(cb, nl, ca * ml), _fma(cc, nl, cbm),
              -0.5 * ca, -cb, -0.5 * cc)
    power = coeffs[0][..., None].expand(*c0.shape, basis.shape[1])
    for k in range(1, 6):                                # [n,K,P]
        power = _fma(coeffs[k][..., None], basis[k], power)
    raw = feats[..., F_OPA, None] * torch.exp(torch.clamp(power, max=0.0))
    power_ok = power <= POWER_EPS
    live = row_ok[..., None] & power_ok
    alpha = torch.where(live & (raw >= ALPHA_MIN),
                        torch.clamp(raw, max=ALPHA_MAX), 0.0)
    return alpha, power_ok


def pixel_frame(n, tiles_per_view, ntx, dev):
    """Tile origins ox/oy [n,1] and the tile-local pixel basis
    [6, TILE^2] = (1, X, Y, X^2, XY, Y^2)."""
    tv = torch.arange(n, device=dev) % tiles_per_view
    ox = ((tv % ntx) * TILE).to(torch.float32)[:, None]
    oy = ((tv // ntx) * TILE).to(torch.float32)[:, None]
    pix = torch.arange(TILE * TILE, device=dev)
    X = (pix % TILE).to(torch.float32)
    Y = (pix // TILE).to(torch.float32)
    return ox, oy, torch.stack([torch.ones_like(X), X, Y, X * X, X * Y, Y * Y])


def segment_chunks(tile_start, tile_count, chunk):
    """Each segment on the JAX package's global chunk grid: first chunk,
    offset into it and number of chunks touched (0 for an empty segment)."""
    start = tile_start.to(torch.int64)
    count = tile_count.to(torch.int64)
    off = start % chunk
    n_chunks = torch.where(count > 0, -(-(off + count) // chunk), 0)
    return start // chunk, off, count, n_chunks


def work_counts(row_ok, t_excl, power_ok, alpha, contrib):
    """Per-class counts (``WORK_CLASSES``) of one chunk step's (pair, pixel)
    evaluations at pixels not yet saturated."""
    needed = row_ok[..., None] & (t_excl >= T_EPS)
    hit = needed & (alpha > 0)
    return torch.stack([(needed & ~power_ok).sum(),
                        (needed & power_ok & (alpha == 0)).sum(),
                        (hit & contrib).sum(),
                        (hit & ~contrib).sum()])


# classes of the (pair, pixel) evaluations the kernel makes at pixels not yet
# saturated, by how far down its inner loop each one runs
WORK_CLASSES = ("power_cut", "floor_cut", "contributing", "saturating")


def forward_tiles_plain(pairs, tile_start, tile_count, *, ntx, tiles_per_view,
                        chunk=128, work=None):
    """Plain PyTorch version of :func:`forward_tiles` (same arguments).

    Vectorised over groups of tiles, one chunk step at a time over the
    JAX package's global chunk grid (a tile's first chunk is shared with its
    neighbours and masked), carrying Tf/Tr between steps; inside a chunk the
    transmittance is exp(cumsum(log(1 - alpha))). Tiles whose segment has
    ended drop out of later steps.

    ``work``, if a dict, receives the count of each of ``WORK_CLASSES``: the
    (pair, pixel) evaluations at pixels not yet saturated — the work an
    early-stopping kernel must do on these inputs — split into those cut by
    a positive exponent, those cut by the 1/255 alpha floor, those that
    contribute, and the last one of each pixel that saturates.
    """
    dev = pairs.device
    n = tile_start.shape[0]
    npx = TILE * TILE
    ox, oy, basis = pixel_frame(n, tiles_per_view, ntx, dev)
    chunk0, off, count, n_chunks = segment_chunks(tile_start, tile_count,
                                                  chunk)
    row = torch.arange(chunk, device=dev)
    last = max(pairs.shape[0] - 1, 0)

    Tf = torch.ones((n, 1, npx), device=dev)
    Tr = torch.ones((n, 1, npx), device=dev)
    acc = torch.zeros((n, 4, npx), device=dev)
    counts = torch.zeros(len(WORK_CLASSES), dtype=torch.int64, device=dev)
    # tiles go in groups so one step's [tiles, chunk, pixels] f64 temporaries
    # stay near 256 MB at the full 512^2 x 4-view shape
    group = max(1, PLAIN_STEP_ELEMS // (chunk * npx))
    for g0 in range(0, n, group):
        tiles_g = torch.arange(g0, min(n, g0 + group), device=dev)
        steps = int(n_chunks[tiles_g].max()) if len(tiles_g) else 0
        for c in range(steps):
            act = tiles_g[n_chunks[tiles_g] > c]             # tiles still open
            idx = (chunk0[act, None] + c) * chunk + row      # [a,K]
            pos = c * chunk + row - off[act, None]
            row_ok = (pos >= 0) & (pos < count[act, None])
            feats = pairs[torch.clamp(idx, max=last)]        # [a,K,16]
            alpha, power_ok = _alpha(feats, ox[act], oy[act], basis, row_ok)
            one_m = 1.0 - alpha
            lg = torch.log(one_m)
            excl = torch.cumsum(torch.cat([torch.zeros_like(lg[:, :1]),
                                           lg[:, :-1]], dim=1), dim=1)
            t_excl = Tf[act] * torch.exp(excl)
            t_incl = t_excl * one_m
            contrib = t_incl >= T_EPS
            w = torch.where(contrib, alpha * t_excl, 0.0)
            cols = feats[..., [F_R, F_R + 1, F_R + 2, F_DEPTH]]   # [a,K,4]
            acc[act] += torch.einsum("akf,akp->afp", cols, w)
            if work is not None:
                counts += work_counts(row_ok, t_excl, power_ok, alpha,
                                      contrib)
            Tf[act] = t_incl[:, -1:]
            Tr[act] = torch.minimum(
                Tr[act],
                torch.where(contrib, t_incl, 1.0).amin(dim=1, keepdim=True))
    if work is not None:
        work.update(zip(WORK_CLASSES, counts.tolist()))
    zero = torch.zeros((n, 2, npx), device=dev)
    return torch.cat([acc, 1.0 - Tr, Tr, zero], dim=1)
