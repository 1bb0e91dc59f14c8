"""K1: per-tile front-to-back alpha compositing — CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``ops/rasterizer/pallas_forward.py::
forward_tiles`` of the JAX package. One program per (view, tile) of
``tile`` x ``tile`` pixels (16 or 32, as the JAX kernel's ``tile``)
composites the tile's depth-sorted pair segment
``[tile_start, tile_start + tile_count)`` of the row-major ``[budget, 16]``
pair stream. Rules (shared with the JAX package's dense oracle):

* alpha = min(0.99, opa exp(min(power, 0))); 0 where power > POWER_EPS or
  opa exp(min(power, 0)) < 1/255. The exponent is the tile-local expanded
  quadratic (coefficients c0, cx, cy, -a/2, -b, -c/2) in the kernel and the
  plain version alike — see the clamp note in ``_alpha``;
* a pair contributes while T_incl >= 1e-4; Tf multiplies through every pair,
  Tr is the min of T_incl over contributors;
* output ``[n_programs, 8, tile^2]``: rgb (no background), depth, 1 - Tr, Tr,
  0, 0;
* with ``early_stop`` (the default) a tile stops once every pixel has
  saturated; without it it walks its whole segment. The output is the same
  bit for bit: saturated pixels take nothing more (the JAX package's
  ``early_stop``).

``forward_tiles`` launches the CUDA kernel (``csrc/forward_tiles.cu``) for a
CUDA tensor and takes the plain version only for a CPU tensor. The kernel
skips a pair in a warp's 8 x 4 pixel rectangle only where the pair's alpha
is 0 at every pixel of it (``cull_rects``, its PyTorch copy), so both give
the same compositing; the plain version does not cull.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from sigman_release_torch.ops.rasterizer.binning import (
    ALPHA_MIN, F_CA, F_CB, F_CC, F_DEPTH, F_MX, F_MY, F_OPA, F_R, PAIR_FEATS,
    TILE, check_tile,
)
from sigman_release_torch.utils import cuda_build

ALPHA_MAX = 0.99
T_EPS = 1e-4
# positive-power tolerance of the expanded-quadratic exponent (f32 rounding
# can leave power at +eps on a pixel sitting on the mean)
POWER_EPS = 1e-3
# elements of one step of the plain version (tiles x chunk x pixels)
PLAIN_STEP_ELEMS = 1 << 25
# slack of the kernels' cull (``cull_rects``) on the ellipse's q-threshold:
# absolute, and relative to the magnitude of the exponent's expanded terms
# (their f32 rounding). With no slack or the absolute term alone the rule
# drops hits (tests/test_torch_raster_cull.py); the relative term alone
# holds from 1e-7 on: 1e-5 leaves 100x
CULL_ABS = 1e-2
CULL_REL = 1e-5
# a warp's pixel rectangle in the kernels (csrc/tile_common.cuh): a tile
# of side t has (t / 8) x (t / 4) of them, 32 at 32 and 8 at 16
RECT_W, RECT_H = 8, 4
# the cull tests at most this many candidate rectangles exactly
CULL_EXACT_MAX = 8

SOURCE = Path(__file__).resolve().parent / "csrc" / "forward_tiles.cu"


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.forward_tiles_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.cull_masks_launch
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def launch_order(tile_count: torch.Tensor) -> torch.Tensor:
    """The kernels' block order: tiles by descending segment length, so the
    longest segments start first and do not end the grid alone."""
    return torch.argsort(tile_count, descending=True).to(torch.int32)


def forward_tiles(pairs: torch.Tensor, tile_start: torch.Tensor,
                  tile_count: torch.Tensor, *, ntx: int, tiles_per_view: int,
                  chunk: int = 128, tile: int = TILE,
                  early_stop: bool = True) -> torch.Tensor:
    """Composite every (view, tile) segment. Returns [n, 8, tile^2] f32.

    pairs [budget, 16] f32; tile_start / tile_count [n] int32; ``tile`` 16
    or 32. CUDA tensors launch the kernel of that tile (counted in
    ``forward_tiles.launches``, and by variant in
    ``forward_tiles.launches_by_variant``): 4 blocks per tile at 32, 2 at
    16, longest segment first (``launch_order``); CPU tensors run
    :func:`forward_tiles_plain` (``chunk`` sets its pair grouping).
    """
    check_tile(tile)
    if pairs.device.type == "cpu":
        return forward_tiles_plain(pairs, tile_start, tile_count, ntx=ntx,
                                   tiles_per_view=tiles_per_view, chunk=chunk,
                                   tile=tile, early_stop=early_stop)
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
    out = torch.empty((n, 8, tile * tile), dtype=torch.float32,
                      device=pairs.device)
    order = launch_order(tile_count)
    lib = _library()
    stream = torch.cuda.current_stream(pairs.device).cuda_stream
    rc = lib.forward_tiles_launch(
        pairs.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
        order.data_ptr(), out.data_ptr(), n, ntx, tiles_per_view, tile,
        int(early_stop), stream)
    if rc != 0:
        raise RuntimeError(f"forward_tiles kernel launch failed: cudaError {rc}")
    forward_tiles.launches += 1
    count_variants(forward_tiles.launches_by_variant, tile, early_stop)
    return out


def count_variants(counts: dict, tile: int, early_stop: bool,
                   out_bf16: bool = False):
    """Adds a launch to ``counts`` under each knob it ran off the default
    ("tile16", "early_stop_off", "bf16")."""
    for name, on in (("tile16", tile == 16), ("early_stop_off", not early_stop),
                     ("bf16", out_bf16)):
        if on:
            counts[name] = counts.get(name, 0) + 1


forward_tiles.launches = 0
forward_tiles.launches_by_variant = {}


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


def cull_rects(feats, ox, oy, tile=TILE):
    """The kernels' exact cull: [..., R] bool per pair row and warp
    rectangle of the tile (``rect_view``; R = 32 at tile 32, 8 at 16), False
    where no pixel of the rectangle can get alpha > 0.

    Mirror of ``cull_bits`` in ``csrc/tile_common.cuh``; the kernels skip a
    pair in a warp whose bit is clear (tests and chip_smoke.py's counts use
    this copy). feats [..., 16]; ox / oy broadcast to feats[..., 0].

    alpha >= 1/255 needs q(d) = d^T C d <= 2 ln(255 opa) with d = pixel -
    mean. The candidates are the rectangles that the ellipse's bounding box
    at that threshold touches (widened by 1% + 0.01 px; every rectangle for
    a conic whose determinant f32 does not resolve). Up to CULL_EXACT_MAX
    candidates take the exact test: q's least value over the rectangle, 0
    with the mean inside, else least on an edge at the clamped argmin
    (binning's ``_rect_min_q``); more are all kept. The kernels' exponent
    is the expanded tile-local quadratic, whose f32 terms are up to S =
    a (|ml| + t)^2 + 2 |b| (|ml| + t)(|nl| + t) + c (|nl| + t)^2 (t the
    tile side); its
    rounding (and the test's) stays far below the slack CULL_ABS +
    CULL_REL * S on the threshold. A conic that is not positive-definite
    keeps every rectangle.
    """
    ml = (feats[..., F_MX] - ox)[..., None]
    nl = (feats[..., F_MY] - oy)[..., None]
    ca, cb, cc = (feats[..., f][..., None] for f in (F_CA, F_CB, F_CC))
    det = ca * cc - cb * cb
    pd = (ca > 0) & (cc > 0) & (det > 0)
    qt = 2.0 * torch.log(255.0 * feats[..., F_OPA, None])
    mx, my = ml.abs() + tile, nl.abs() + tile
    scale = ca * mx * mx + 2.0 * cb.abs() * mx * my + cc * my * my
    thresh = qt + CULL_ABS + CULL_REL * scale
    rects_x = tile // RECT_W
    rect = torch.arange(rects_x * (tile // RECT_H), device=feats.device)
    col, row = rect % rects_x, rect // rects_x
    # candidates: the rectangles the widened bounding box touches
    t = thresh / det
    hx = torch.sqrt(t * cc) * 1.01 + 0.01
    hy = torch.sqrt(t * ca) * 1.01 + 0.01
    box = ((col >= torch.ceil((ml - hx - (RECT_W - 1.0)) / RECT_W))
           & (col <= torch.floor((ml + hx) / RECT_W))
           & (row >= torch.ceil((nl - hy - (RECT_H - 1.0)) / RECT_H))
           & (row <= torch.floor((nl + hy) / RECT_H)))
    cand = torch.where(det > 1e-4 * ca * cc, box, True)
    # the exact test
    x0 = (RECT_W * col).to(feats.dtype) - ml
    y0 = (RECT_H * row).to(feats.dtype) - nl
    x1, y1 = x0 + (RECT_W - 1.0), y0 + (RECT_H - 1.0)

    def q(x, y):
        return (ca * x + 2.0 * cb * y) * x + cc * y * y

    def at_x(x):
        return q(x, torch.minimum(torch.maximum(-cb / cc * x, y0), y1))

    def at_y(y):
        return q(torch.minimum(torch.maximum(-cb / ca * y, x0), x1), y)

    qmin = torch.minimum(torch.minimum(at_x(x0), at_x(x1)),
                         torch.minimum(at_y(y0), at_y(y1)))
    inside = (x0 <= 0) & (x1 >= 0) & (y0 <= 0) & (y1 >= 0)
    exact = torch.where(inside, 0.0, qmin) <= thresh
    many = cand.sum(-1, keepdim=True) > CULL_EXACT_MAX
    return ~pd | ((thresh >= 0) & cand & (many | exact))


def rect_view(x, tile=TILE):
    """[..., tile^2] per-pixel values (row-major tile) -> [..., R, 32]:
    (warp rectangle, lane). With q = tile / 8 rectangles a row, rectangle r
    covers columns RECT_W (r % q) + .. and rows RECT_H (r // q) + ..; lane l
    is its pixel (l % 8, l // 8)."""
    y = x.unflatten(-1, (tile // RECT_H, RECT_H, tile // RECT_W, RECT_W))
    return y.transpose(-3, -2).flatten(-4, -3).flatten(-2, -1)


def pixel_frame(n, tiles_per_view, ntx, dev, tile=TILE):
    """Tile origins ox/oy [n,1] and the tile-local pixel basis
    [6, tile^2] = (1, X, Y, X^2, XY, Y^2)."""
    tv = torch.arange(n, device=dev) % tiles_per_view
    ox = ((tv % ntx) * tile).to(torch.float32)[:, None]
    oy = ((tv // ntx) * tile).to(torch.float32)[:, None]
    pix = torch.arange(tile * tile, device=dev)
    X = (pix % tile).to(torch.float32)
    Y = (pix // tile).to(torch.float32)
    return ox, oy, torch.stack([torch.ones_like(X), X, Y, X * X, X * Y, Y * Y])


def open_tiles(tiles_g, n_chunks, c, alive):
    """The tiles of a plain version's group that take chunk step ``c``:
    those whose segment reaches it and that have not stopped."""
    return tiles_g[(n_chunks[tiles_g] > c) & alive[tiles_g]]


def segment_chunks(tile_start, tile_count, chunk):
    """Each segment on the JAX package's global chunk grid: first chunk,
    offset into it and number of chunks touched (0 for an empty segment)."""
    start = tile_start.to(torch.int64)
    count = tile_count.to(torch.int64)
    off = start % chunk
    n_chunks = torch.where(count > 0, -(-(off + count) // chunk), 0)
    return start // chunk, off, count, n_chunks


def work_counts(row_ok, t_excl, power_ok, alpha, contrib, kept, tile=TILE):
    """Counts (``WORK_CLASSES`` then ``WARP_CLASSES``) of one chunk step.
    [a,K,P] masks; ``kept`` [a,K,R] is ``cull_rects``."""
    needed = row_ok[..., None] & (t_excl >= T_EPS)
    hit = needed & (alpha > 0)
    slots = rect_view(needed, tile).any(-1)                 # [a,K,rect]
    empty = slots & rect_view(alpha == 0, tile).all(-1)
    return torch.stack([(needed & ~power_ok).sum(),
                        (needed & power_ok & (alpha == 0)).sum(),
                        (hit & contrib).sum(),
                        (hit & ~contrib).sum(),
                        slots.sum(), empty.sum(), (slots & kept).sum()])


# classes of the (pair, pixel) evaluations a kernel without a cull makes at
# pixels not yet saturated, by how far down its inner loop each one runs
WORK_CLASSES = ("power_cut", "floor_cut", "contributing", "saturating")
# (pair, warp rectangle) slots: those a warp must visit (the pair is in the
# segment and some pixel of the rectangle is not yet saturated), those where
# no pixel of the rectangle gets alpha > 0 (the most an exact per-warp cull
# can skip), and those ``cull_rects`` keeps
WARP_CLASSES = ("warp_slots", "warp_slots_empty", "warp_slots_kept")


def forward_tiles_plain(pairs, tile_start, tile_count, *, ntx, tiles_per_view,
                        chunk=128, tile=TILE, early_stop=True, work=None):
    """Plain PyTorch version of :func:`forward_tiles` (same arguments).

    Vectorised over groups of tiles, one chunk step at a time over the
    JAX package's global chunk grid (a tile's first chunk is shared with its
    neighbours and masked), carrying Tf/Tr between steps; inside a chunk the
    transmittance is exp(cumsum(log(1 - alpha))). Tiles whose segment has
    ended drop out of later steps, and with ``early_stop`` so do tiles
    whose every pixel has saturated.

    ``work``, if a dict, receives the count of each of ``WORK_CLASSES``: the
    (pair, pixel) evaluations at pixels not yet saturated — the work an
    early-stopping kernel without a cull does on these inputs — split into
    those cut by a positive exponent, those cut by the 1/255 alpha floor,
    those that contribute, and the last one of each pixel that saturates;
    and of each of ``WARP_CLASSES``.
    """
    check_tile(tile)
    dev = pairs.device
    n = tile_start.shape[0]
    npx = tile * tile
    ox, oy, basis = pixel_frame(n, tiles_per_view, ntx, dev, tile)
    chunk0, off, count, n_chunks = segment_chunks(tile_start, tile_count,
                                                  chunk)
    row = torch.arange(chunk, device=dev)
    last = max(pairs.shape[0] - 1, 0)

    Tf = torch.ones((n, 1, npx), device=dev)
    Tr = torch.ones((n, 1, npx), device=dev)
    acc = torch.zeros((n, 4, npx), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    classes = WORK_CLASSES + WARP_CLASSES
    counts = torch.zeros(len(classes), dtype=torch.int64, device=dev)
    # tiles go in groups so one step's [tiles, chunk, pixels] f64 temporaries
    # stay near 256 MB at the full 512^2 x 4-view shape
    group = max(1, PLAIN_STEP_ELEMS // (chunk * npx))
    for g0 in range(0, n, group):
        tiles_g = torch.arange(g0, min(n, g0 + group), device=dev)
        steps = int(n_chunks[tiles_g].max()) if len(tiles_g) else 0
        for c in range(steps):
            act = open_tiles(tiles_g, n_chunks, c, alive)
            if not len(act):
                break
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
                                      contrib,
                                      cull_rects(feats, ox[act], oy[act],
                                                 tile), tile)
            Tf[act] = t_incl[:, -1:]
            Tr[act] = torch.minimum(
                Tr[act],
                torch.where(contrib, t_incl, 1.0).amin(dim=1, keepdim=True))
            if early_stop:
                alive[act] = Tf[act].amax(dim=(1, 2)) >= T_EPS
    if work is not None:
        work.update(zip(classes, counts.tolist()))
    zero = torch.zeros((n, 2, npx), device=dev)
    return torch.cat([acc, 1.0 - Tr, Tr, zero], dim=1)
