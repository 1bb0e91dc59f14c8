"""Tile binning for the tile rasterizer: all views, one sort.

Port of the JAX package's ``ops/rasterizer/binning.py`` (``bin_gaussians``
and ``place_pairs``):

1. each (gaussian, view) emits up to ``win^2`` base-window candidates, and
   the K gaussians per view whose tile span most exceeds the base window
   emit their remaining tiles from a second ``big_win^2`` fallback window
   (top-K pool); only spans exceeding the big window or the K pool are
   dropped, and they are counted in ``overflow``,
2. every candidate is culled exactly against its tile (``_rect_min_q``: the
   ellipse's minimum over the tile's pixel rectangle must reach the 1/255
   alpha floor),
3. every surviving candidate carries one key
   ``(view*n_tiles + tile) << 32 | depth_bits``, all 31 bits of its
   positive f32 depth. The JAX package sorts uint32 keys and keeps only the
   top ``32 - ceil(log2(tiles))`` depth bits, so near-equal depths tie and
   fall back to Gaussian order, and where they tie depends on the tile
   count: a 16-px tile keeps two bits fewer than a 32-px one and the two
   images differ by whole swaps of overlapping Gaussians. The port sorts
   int64 keys, so it keeps every bit, and the invalid key ``INVALID``
   (int64's largest) stays above every valid one,
4. segment starts per (view, tile) come from one ``searchsorted``,
5. the dense ``[budget, 16]`` pair stream keeps one global prefix (one view)
   or V fixed chunk-aligned per-view regions, with the JAX package's
   ``overflow`` semantics for either layout.

The stream stays row-major ``[budget, 16]``; the JAX package transposes it to
feats-major ``[NC, 16, chunk]`` only for Mosaic's DMA alignment.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from sigman_release_torch.ops.rasterizer.preprocess import ProjectedGaussians

# pair feature row layout (16 f32 lanes, last 6 padding)
F_MX, F_MY, F_CA, F_CB, F_CC, F_R, F_G, F_B, F_OPA, F_DEPTH = range(10)
PAIR_FEATS = 16
# default pixel tile side: one (view, tile) is one program of
# forward_tiles; the kernels take 16 or 32 (``RasterizeConfig.tile``)
TILE = 32
TILES = (16, 32)

INVALID = torch.iinfo(torch.int64).max
DEPTH_BITS = 32


def check_tile(tile: int) -> int:
    """``tile`` if the kernels have an instantiation for it, else raise."""
    if tile not in TILES:
        raise ValueError(f"tile must be one of {TILES}, got {tile}")
    return tile

# compositing alpha floor (renderCUDA's 1/255 cut) — also the exact-cull rule:
# a (gaussian, tile) pair whose max alpha over the tile is below the floor
# contributes exactly zero, so binning may drop it
ALPHA_MIN = 1.0 / 255.0
# conservative slack on the q-threshold (power margin 5e-3)
_EXACT_MARGIN = 1e-2


def _rect_min_q(mx, my, ca, cb, cc, tx, ty, tile_size):
    """Exact min of the conic quadratic q(d) = d^T C d over a tile's pixel
    rectangle (pixel centers [t*tile, t*tile + tile-1]); d = pixel - mean.

    0 when the mean lies inside the rect, otherwise the min over the 4
    edges, each a 1-D quadratic with a clampable closed-form argmin.
    """
    txf = tx.to(torch.float32) * tile_size
    tyf = ty.to(torch.float32) * tile_size
    rx0 = txf - mx
    rx1 = rx0 + (tile_size - 1.0)
    ry0 = tyf - my
    ry1 = ry0 + (tile_size - 1.0)

    cas = torch.clamp(ca, min=1e-12)
    ccs = torch.clamp(cc, min=1e-12)

    def q(x, y):
        return (ca * x + 2.0 * cb * y) * x + cc * y * y

    def edge_x(x):                        # x fixed, y free in [ry0, ry1]
        y = torch.minimum(torch.maximum(-cb * x / ccs, ry0), ry1)
        return q(x, y)

    def edge_y(y):                        # y fixed, x free in [rx0, rx1]
        x = torch.minimum(torch.maximum(-cb * y / cas, rx0), rx1)
        return q(x, y)

    qmin = torch.minimum(
        torch.minimum(edge_x(rx0), edge_x(rx1)),
        torch.minimum(edge_y(ry0), edge_y(ry1)),
    )
    inside = (rx0 <= 0.0) & (rx1 >= 0.0) & (ry0 <= 0.0) & (ry1 >= 0.0)
    return torch.where(inside, 0.0, qmin)


class TileBinning(NamedTuple):
    """Binning result: per-(view, tile) segments + placement ingredients.

    ``dims`` = (v, n, k_big, a_slots, b_slots, budget, vb); ``vb == 0`` is
    the global-prefix layout, ``vb > 0`` the per-view region layout (view
    v's pairs live in stream rows ``[v*vb, (v+1)*vb)``).
    """

    feats16: torch.Tensor       # [V*N, 16] f32 per-(view, gaussian) pair rows
    feats_big: torch.Tensor     # [V*K, 16] f32 top-K fallback pool rows
    valid_prefix: torch.Tensor  # [budget] bool — dense slot holds a real pair
    pay_prefix: torch.Tensor    # [budget] i64 dense-slot candidate indices
    total_valid: torch.Tensor   # [] i64 valid candidates
    tile_start: torch.Tensor    # [V*n_tiles] i32 absolute pair index
    tile_count: torch.Tensor    # [V*n_tiles] i32 pairs in the segment
    overflow: torch.Tensor      # [] i64 — dropped (gaussian, tile) pairs
    dims: tuple


def place_pairs(src, valid_prefix, pay_prefix, dims):
    """Place the pair rows ``src = cat([feats16, feats_big])`` into the dense
    [budget, 16] stream; empty / clipped slots hold zeros. Returns (pairs,
    slots, rows): the stream, with no autograd history, the stream rows
    that hold a real pair and, for each, its row of ``src``.

    Each slot's candidate index encodes its ``src`` row by construction
    (A-window: ``pay // a_slots``; B-window: ``V*N + (pay - c_a) // b_slots``
    into the appended pool copy). Only the live slots are gathered; the
    renderer's ``render.Composite`` carries the gradient back through them
    (``render.regroup``), so that its backward can keep the gradient stream
    in bf16 and sum only the live rows. Had the empty slots gathered one
    shared zero row, its scatter-add would take ~90% of the budget's
    indices as duplicates, which an accumulate adds one after another (3.2
    s of a 4.0 s ``vae_b`` step on an H100, PERF.md).
    """
    v, n, k_big, a_slots, b_slots, budget, vb = dims
    c_a = v * n * a_slots
    slots = torch.nonzero(valid_prefix).squeeze(1)
    pay = pay_prefix[slots]
    rows = torch.where(pay < c_a, pay // a_slots,
                       v * n + (pay - c_a) // b_slots)
    pairs = src.new_zeros((budget, src.shape[1]))
    return pairs.index_put((slots,), src.detach()[rows]), slots, rows


def bin_gaussians(
    proj: ProjectedGaussians,  # fields [V, N] / [V, N, k]
    colors: torch.Tensor,      # [N,3]
    opacity: torch.Tensor,     # [N]
    img_h: int,
    img_w: int,
    max_tiles_per_gaussian: int = 9,
    chunk: int = 128,
    pair_budget: int | None = None,
    big_win: int = 6,
    big_frac: int = 32,
    exact_radius: bool = True,
    per_view_budget: bool = False,
    tile_size: int = TILE,
) -> TileBinning:
    """``per_view_budget``: split ``pair_budget`` into V fixed chunk-aligned
    regions of the dense stream (one per view) instead of one global prefix;
    a view needing more than its region is clipped and counted.
    ``tile_size``: the pixel tile side (16 or 32); the windows
    ``max_tiles_per_gaussian`` and ``big_win`` count tiles of that side."""
    if proj.mean2d.ndim != 3:
        raise ValueError("bin_gaussians wants view-batched projections")
    # gradients reach only the pair rows (feats16); spans, culling and sort
    # keys work on detached copies, so autograd records none of them
    proj_g, opacity_g = proj, opacity
    proj = ProjectedGaussians(*(x.detach() for x in proj))
    opacity = opacity.detach()
    dev = proj.mean2d.device
    i32, i64 = torch.int32, torch.int64
    v_views, n = proj.mean2d.shape[:2]
    check_tile(tile_size)
    ntx = -(-img_w // tile_size)
    nty = -(-img_h // tile_size)
    n_tiles = ntx * nty
    total_tiles = v_views * n_tiles
    db = DEPTH_BITS                           # depth bits below the tile id
    win = math.isqrt(max_tiles_per_gaussian)
    if win * win != max_tiles_per_gaussian or big_win < win:
        raise ValueError("window must be square and big_win >= its side")
    a_slots = win * win
    b_slots = big_win * big_win
    k_big = min(n, max(-(-n // big_frac), 8))  # fallback pool per view (<= n)
    if pair_budget is None:
        pair_budget = 5 * n * v_views
    if per_view_budget:
        if pair_budget < v_views:
            raise ValueError(
                f"pair_budget={pair_budget} < v_views={v_views}: per-view "
                "regions would get a zero budget")
        vb = max(chunk, -(-(pair_budget // v_views) // chunk) * chunk)
        budget = vb * v_views
    else:
        vb = 0
        budget = -(-pair_budget // chunk) * chunk

    mean_x = proj.mean2d[..., 0]              # [V,N]
    mean_y = proj.mean2d[..., 1]
    radius = proj.radius
    valid = proj.valid
    opa_v = torch.where(valid, opacity[None], 0.0)            # [V,N]
    # exact-cull threshold: keep a (gaussian, tile) pair iff some tile pixel
    # can reach alpha >= ALPHA_MIN, i.e. min_rect q <= 2 log(opa/ALPHA_MIN)
    qt_raw = 2.0 * (torch.log(torch.clamp(opa_v, min=1e-12))
                    - float(np.log(ALPHA_MIN)))
    if exact_radius:
        # opacity-exact cutoff radius instead of the CUDA preprocess's fixed
        # 3 sigma (proj.radius carries ceil(3 sigma))
        radius = radius * (torch.sqrt(torch.clamp(qt_raw, min=1e-4))
                           * (1.0 / 3.0))

    # ---- tile spans ----------------------------------------------------------
    x0 = torch.clamp(torch.floor((mean_x - radius) / tile_size), 0,
                     ntx).to(i64)
    y0 = torch.clamp(torch.floor((mean_y - radius) / tile_size), 0,
                     nty).to(i64)
    x1 = torch.clamp(torch.floor((mean_x + radius) / tile_size) + 1, 0,
                     ntx).to(i64)
    y1 = torch.clamp(torch.floor((mean_y + radius) / tile_size) + 1, 0,
                     nty).to(i64)
    x1a = torch.minimum(x1, x0 + win)
    y1a = torch.minimum(y1, y0 + win)
    span = torch.where(valid, (x1 - x0) * (y1 - y0), 0)
    a_area = (x1a - x0) * (y1a - y0)
    wanted = torch.sum(span)

    # depth > 0.2 for every valid gaussian, so its int32 bit pattern is a
    # positive int whose order matches the float order
    depth_bits = proj.depth.to(torch.float32).contiguous().view(i32).to(i64)
    view_ids = torch.arange(v_views, dtype=i64, device=dev)

    q_thresh = qt_raw + _EXACT_MARGIN
    ca_f = proj.conic[..., 0]
    cb_f = proj.conic[..., 1]
    cc_f = proj.conic[..., 2]

    # ---- base-window candidates (win x win, every gaussian) ------------------
    li = torch.arange(a_slots, dtype=i64, device=dev)
    tx = x0[..., None] + li % win             # [V,N,a_slots]
    ty = y0[..., None] + li // win
    cand_bbox_a = ((tx < x1a[..., None]) & (ty < y1a[..., None])
                   & valid[..., None])
    qmin_a = _rect_min_q(mean_x[..., None], mean_y[..., None],
                         ca_f[..., None], cb_f[..., None], cc_f[..., None],
                         tx, ty, tile_size)
    cand_ok_a = cand_bbox_a & (qmin_a <= q_thresh[..., None])
    tile_id = view_ids[:, None, None] * n_tiles + ty * ntx + tx
    keys_a = torch.where(cand_ok_a, (tile_id << db) | depth_bits[..., None],
                         INVALID).reshape(-1)
    # flat candidate index (v*N + n)*a_slots + w, positionally paired
    payload_a = torch.arange(v_views * n * a_slots, dtype=i64, device=dev)

    # ---- fallback candidates (big_win x big_win, top-K spans per view) -------
    score = torch.where(valid, span - a_area, 0)          # missing tiles
    # top-K per view: one flat sort on (view, descending clamped score)
    skey = (view_ids[:, None] * 1024
            + (1023 - torch.clamp(score, max=1023))).reshape(-1)
    order = torch.sort(skey, stable=True).indices
    sel = (order % n).reshape(v_views, n)[:, :k_big]      # [V,K]
    rowsel = (view_ids[:, None] * n + sel).reshape(-1)    # [V*K]

    def pool(x):
        return x.reshape(v_views * n)[rowsel].reshape(v_views, k_big)

    x0b, y0b, x1b, y1b = pool(x0), pool(y0), pool(x1), pool(y1)
    depth_bits_b, valid_b = pool(depth_bits), pool(valid)
    mxb, myb = pool(mean_x), pool(mean_y)
    cab, cbb, ccb = pool(ca_f), pool(cb_f), pool(cc_f)
    q_thresh_b = pool(q_thresh)
    x1bc = torch.minimum(x1b, x0b + big_win)
    y1bc = torch.minimum(y1b, y0b + big_win)
    lib = torch.arange(b_slots, dtype=i64, device=dev)
    lxb, lyb = lib % big_win, lib // big_win
    txb = x0b[..., None] + lxb                # [V,K,b_slots]
    tyb = y0b[..., None] + lyb
    # exclude the base-window block (emitted by the A set for everyone)
    cand_bbox_b = ((txb < x1bc[..., None]) & (tyb < y1bc[..., None])
                   & valid_b[..., None]
                   & ~((lxb < win) & (lyb < win)))
    qmin_b = _rect_min_q(mxb[..., None], myb[..., None],
                         cab[..., None], cbb[..., None], ccb[..., None],
                         txb, tyb, tile_size)
    cand_ok_b = cand_bbox_b & (qmin_b <= q_thresh_b[..., None])
    tile_id_b = view_ids[:, None, None] * n_tiles + tyb * ntx + txb
    keys_b = torch.where(cand_ok_b,
                         (tile_id_b << db) | depth_bits_b[..., None],
                         INVALID).reshape(-1)
    c_a = v_views * n * a_slots
    payload_b = c_a + torch.arange(v_views * k_big * b_slots, dtype=i64,
                                   device=dev)

    keys = torch.cat([keys_a, keys_b])
    payload = torch.cat([payload_a, payload_b])
    # stable: ties keep candidate order, so a render is reproducible
    keys_s, perm = torch.sort(keys, stable=True)
    pay_s = payload[perm]

    # ---- per-(view, tile) segments -------------------------------------------
    p_total = keys_s.shape[0]
    bounds = torch.arange(total_tiles, dtype=i64, device=dev) << db
    starts = torch.searchsorted(keys_s, bounds, side="left")
    total_valid = torch.sum(cand_ok_a) + torch.sum(cand_ok_b)
    ends = torch.cat([starts[1:], total_valid[None]])
    seg_bounds = torch.cat([starts[0::n_tiles], total_valid[None]])  # [V+1]
    # overflow counts REAL drops only: bbox pairs beyond the emission
    # windows / K-pool, plus budget clipping (exact-culled pairs are provably
    # zero-contribution, not drops)
    emitted_bbox = torch.sum(cand_bbox_a) + torch.sum(cand_bbox_b)
    overflow_base = wanted - emitted_bbox

    if per_view_budget:
        # view v's sorted segment [seg_start, seg_start+seg_len) maps to
        # stream rows [v*vb, v*vb+lim)
        seg_start = seg_bounds[:v_views]
        seg_len = seg_bounds[1:] - seg_bounds[:-1]
        lim = torch.clamp(seg_len, max=vb)
        li_vb = torch.arange(vb, dtype=i64, device=dev)[None, :]     # [1, vb]
        valid_prefix = (li_vb < lim[:, None]).reshape(-1)
        src = torch.clamp(seg_start[:, None] + li_vb, max=p_total - 1)
        pay_pref = pay_s[src.reshape(-1)]                            # [budget]
        overflow = overflow_base + torch.sum(torch.clamp(seg_len - vb, min=0))
        seg_start_t = torch.repeat_interleave(seg_start, n_tiles)
        lim_t = torch.repeat_interleave(lim, n_tiles)
        base_t = torch.repeat_interleave(view_ids * vb, n_tiles)
        ls = torch.minimum(torch.clamp(starts - seg_start_t, min=0), lim_t)
        le = torch.minimum(torch.clamp(ends - seg_start_t, min=0), lim_t)
        tile_start = base_t + ls
        tile_count = le - ls
    else:
        # the budget may exceed the candidate count (small scenes / generous
        # budgets): pad so the dense stream is always exactly `budget` rows
        if budget > p_total:
            pad = budget - p_total
            keys_pref = torch.cat(
                [keys_s, keys_s.new_full((pad,), INVALID)])
            pay_pref = torch.cat([pay_s, pay_s.new_zeros((pad,))])
        else:
            keys_pref = keys_s[:budget]
            pay_pref = pay_s[:budget]
        valid_prefix = keys_pref != INVALID
        overflow = overflow_base + torch.clamp(total_valid - budget, min=0)
        tile_start = torch.clamp(starts, max=budget)
        tile_count = torch.clamp(ends, max=budget) - tile_start

    # ---- pair feature rows (differentiable) ----------------------------------
    opab = torch.where(valid, opacity_g[None], 0.0)
    zero = torch.zeros_like(proj.depth)
    colb = colors[None].expand(v_views, n, 3)
    conic = proj_g.conic
    feats16 = torch.stack(
        [proj_g.mean2d[..., 0], proj_g.mean2d[..., 1],
         conic[..., 0], conic[..., 1], conic[..., 2],
         colb[..., 0], colb[..., 1], colb[..., 2],
         opab, proj_g.depth,
         zero, zero, zero, zero, zero, zero],
        dim=-1,
    ).to(torch.float32).reshape(v_views * n, PAIR_FEATS)    # [V*N,16]

    return TileBinning(
        feats16=feats16,
        feats_big=feats16[rowsel],
        valid_prefix=valid_prefix,
        pay_prefix=pay_pref,
        total_valid=total_valid,
        tile_start=tile_start.to(i32),
        tile_count=tile_count.to(i32),
        overflow=overflow,
        dims=(v_views, n, k_big, a_slots, b_slots, budget, vb),
    )
