"""The benchmark's plain Gaussian renderer: front-to-back alpha compositing
of every Gaussian at every pixel where its alpha reaches the floor.

Written for the benchmark, in plain PyTorch and f32, independent of the
port's binning and kernels. Compositing rules (the 3DGS CUDA rasterizer's,
which the port's K1 / K2 keep): alpha = min(0.99, opacity exp(power)),
power the conic quadratic at the pixel, skipped where power > 1e-3 or alpha
< 1/255; a pixel stops before the Gaussian that would take its
transmittance under 1e-4; the image is clamped to [0, 1] over the
background. Each Gaussian meets the 16-px tiles that the bounding box of
its alpha >= 1/255 ellipse touches; each tile's Gaussians are sorted by
depth (all 32 bits, then by index). Tiles go in chunks of similar length;
a chunk is one ``torch.utils.checkpoint`` call, so the backward holds only
each chunk's gathered rows and recomputes the rest (autograd gives the
gradient).

``work_counts`` counts, for the roofline of the port's kernels, the
(pair, pixel) evaluations that these inputs need (the frozen prices'
classes), the (Gaussian, 32-px tile) rows that hold an evaluation with
alpha > 0, those that contribute, and the 32-px tiles with any.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple

import torch
from torch.utils.checkpoint import checkpoint

from portbench.reference.ops.rasterizer.preprocess import project_gaussians

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4
POWER_EPS = 1e-3
TILE = 16
# (tiles x longest segment x pixels) elements of one chunk
CHUNK_ELEMS = 1 << 24


class Segments(NamedTuple):
    feats: torch.Tensor     # [P, 9] sorted rows: mx, my, a, b, c, r, g, b, opa
    gid: torch.Tensor       # [P] Gaussian index of each row
    start: torch.Tensor     # [n_tiles] first row of each tile
    count: torch.Tensor     # [n_tiles] rows of each tile


def bin_view(proj, colors, opacity, img_h, img_w):
    """One view's rows sorted by (tile, depth), and the tile segments."""
    dev = colors.device
    ntx, nty = -(-img_w // TILE), -(-img_h // TILE)
    a, b, c = proj.conic.unbind(-1)
    det = a * c - b * b
    qt = 2.0 * torch.log(torch.clamp(255.0 * opacity, min=1e-30))
    ok = proj.valid & (opacity >= ALPHA_MIN) & (det > 0) & (a > 0) & (c > 0)
    det_s = torch.where(ok, det, 1.0)
    hx = torch.sqrt(torch.clamp(qt * c / det_s, min=0.0)) + 1.0
    hy = torch.sqrt(torch.clamp(qt * a / det_s, min=0.0)) + 1.0
    mx, my = proj.mean2d.unbind(-1)
    x0 = torch.clamp(torch.floor((mx - hx) / TILE), 0, ntx - 1).long()
    x1 = torch.clamp(torch.floor((mx + hx) / TILE), 0, ntx - 1).long()
    y0 = torch.clamp(torch.floor((my - hy) / TILE), 0, nty - 1).long()
    y1 = torch.clamp(torch.floor((my + hy) / TILE), 0, nty - 1).long()
    ok = ok & (mx + hx >= 0) & (mx - hx <= img_w) & (my + hy >= 0) \
        & (my - hy <= img_h)
    ok = ok & torch.isfinite(hx) & torch.isfinite(hy)
    w = torch.where(ok, x1 - x0 + 1, 0)
    h = torch.where(ok, y1 - y0 + 1, 0)
    n = w * h
    gid = torch.repeat_interleave(torch.arange(n.shape[0], device=dev), n)
    first = torch.cumsum(n, 0) - n
    k = torch.arange(gid.shape[0], device=dev) - first[gid]
    tx = x0[gid] + k % w[gid]
    ty = y0[gid] + k // w[gid]
    tile = ty * ntx + tx
    depth_bits = proj.depth.detach().float().contiguous().view(torch.int32)
    key = (tile << 32) | depth_bits[gid].long()
    key, order = torch.sort(key, stable=True)
    gid = gid[order]
    tile = key >> 32
    count = torch.bincount(tile, minlength=ntx * nty)
    start = torch.cumsum(count, 0) - count
    feats = torch.cat([proj.mean2d, proj.conic, colors, opacity[:, None]],
                      -1)[gid]
    return Segments(feats, gid, start, count), ntx, nty


def _alpha(rows, px, py):
    """rows [T, L, 9]; px / py [T, 1, 256] -> (alpha, power_ok) [T, L, 256]."""
    dx = px - rows[..., 0:1]
    dy = py - rows[..., 1:2]
    power = (-0.5 * (rows[..., 2:3] * dx * dx + rows[..., 4:5] * dy * dy)
             - rows[..., 3:4] * dx * dy)
    raw = rows[..., 8:9] * torch.exp(torch.clamp(power, max=0.0))
    power_ok = power <= POWER_EPS
    alpha = torch.where(power_ok & (raw >= ALPHA_MIN),
                        torch.clamp(raw, max=ALPHA_MAX), 0.0)
    return alpha, power_ok


def _composite(rows, px, py):
    """One chunk: [T, L, 9] rows -> [T, 4, 256] (rgb, final T)."""
    alpha, _ = _alpha(rows, px, py)
    one_m = 1.0 - alpha
    t_incl = torch.cumprod(one_m, dim=1)
    t_excl = torch.cat([torch.ones_like(t_incl[:, :1]), t_incl[:, :-1]], 1)
    contrib = t_incl >= T_EPS
    w = torch.where(contrib, alpha * t_excl, 0.0)
    rgb = torch.einsum("tlp,tlc->tcp", w, rows[..., 5:8])
    t_final = torch.prod(torch.where(contrib, one_m, 1.0), dim=1)
    return torch.cat([rgb, t_final[:, None]], 1)


def _chunks(count: torch.Tensor):
    """Tiles with rows, longest first, in chunks of (tiles, padded length)."""
    order = torch.argsort(count, descending=True)
    lengths = count[order].tolist()
    live = sum(1 for n in lengths if n > 0)
    at = 0
    while at < live:
        L = lengths[at]
        t = max(1, min(live - at, CHUNK_ELEMS // (L * TILE * TILE)))
        yield order[at:at + t], L
        at += t


def _gather(seg: Segments, tiles, L: int, ntx: int):
    dev = seg.feats.device
    pos = torch.arange(L, device=dev)
    idx = seg.start[tiles, None] + pos
    ok = pos < seg.count[tiles, None]
    idx = torch.where(ok, idx, 0)
    rows = seg.feats[idx] * ok[..., None]            # padding: opacity 0
    ty, tx = tiles // ntx, tiles % ntx
    lp = torch.arange(TILE * TILE, device=dev)
    px = (tx[:, None] * TILE + lp % TILE).float()[:, None]
    py = (ty[:, None] * TILE + lp // TILE).float()[:, None]
    return rows, px, py, idx, ok


def render_view(means3d, cov3d, colors, opacity, cam_view, cam_view_proj,
                tan_half_fovx, tan_half_fovy, img_h, img_w, bg_color):
    """One view -> (image [3,H,W], alpha [1,H,W]); differentiable in the
    Gaussians' parameters."""
    proj = project_gaussians(means3d, cov3d, cam_view, cam_view_proj,
                             tan_half_fovx, tan_half_fovy, img_h, img_w)
    seg, ntx, nty = bin_view(proj, colors, opacity, img_h, img_w)
    n_tiles = ntx * nty
    out = colors.new_zeros((n_tiles, 4, TILE * TILE))
    out[:, 3] = 1.0
    grad = torch.is_grad_enabled() and seg.feats.requires_grad
    for tiles, L in _chunks(seg.count):
        rows, px, py, _, _ = _gather(seg, tiles, L, ntx)
        vals = (checkpoint(_composite, rows, px, py, use_reentrant=False)
                if grad else _composite(rows, px, py))
        out = out.index_put((tiles,), vals)
    img = out.reshape(nty, ntx, 4, TILE, TILE).permute(2, 0, 3, 1, 4)
    img = img.reshape(4, nty * TILE, ntx * TILE)[:, :img_h, :img_w]
    rgb, t_final = img[:3], img[3:4]
    image = torch.clamp(rgb + t_final * bg_color[:, None, None], 0.0, 1.0)
    return image, 1.0 - t_final


def build_cov3d(scale, rot):
    """Packed (xx, xy, xz, yy, yz, zz) of R diag(s^2) R^T."""
    m = rot * scale[..., None, :]
    cov = m @ m.transpose(-1, -2)
    return torch.stack([cov[..., 0, 0], cov[..., 0, 1], cov[..., 0, 2],
                        cov[..., 1, 1], cov[..., 1, 2], cov[..., 2, 2]], -1)


def render(means3d, cov3d, colors, opacity, cam_view, cam_view_proj, cfg,
           bg_color=None):
    """[V] views of one Gaussian set -> (image [V,3,H,W], alpha [V,1,H,W])."""
    if bg_color is None:
        bg_color = torch.ones(3, device=means3d.device)
    th_x, th_y = math.tan(0.5 * cfg.fovx), math.tan(0.5 * cfg.fovy)
    outs = [render_view(means3d, cov3d, colors, opacity, cam_view[v],
                        cam_view_proj[v], th_x, th_y, cfg.output_size,
                        cfg.output_size, bg_color)
            for v in range(cam_view.shape[0])]
    return (torch.stack([o[0] for o in outs]),
            torch.stack([o[1] for o in outs]))


@torch.no_grad()
def work_counts(means3d, cov3d, colors, opacity, cam_view, cam_view_proj,
                tan_half_fovx, tan_half_fovy, img_h, img_w,
                kernel_tile: int = 32) -> Dict[str, int]:
    """The evaluations and rows that one render of these views needs:
    ``power_cut``, ``floor_cut``, ``contributing``, ``saturating`` (the
    (pair, pixel) evaluations at pixels not yet saturated, by class),
    ``rows`` and ``rows_contributing`` (the (Gaussian, ``kernel_tile``-px
    tile) rows with an evaluation of alpha > 0, and with a contributing
    one), ``tiles_hit`` (``kernel_tile`` tiles with any) and ``tiles`` (all
    of them)."""
    dev = means3d.device
    tot = torch.zeros(4, dtype=torch.int64, device=dev)
    keys_hit, keys_contrib = [], []
    ratio = kernel_tile // TILE
    nk = 0
    for v in range(cam_view.shape[0]):
        proj = project_gaussians(means3d, cov3d, cam_view[v],
                                 cam_view_proj[v], tan_half_fovx,
                                 tan_half_fovy, img_h, img_w)
        seg, ntx, nty = bin_view(proj, colors, opacity, img_h, img_w)
        ktx = -(-img_w // kernel_tile)
        nk_view = ktx * -(-img_h // kernel_tile)
        for tiles, L in _chunks(seg.count):
            rows, px, py, idx, ok = _gather(seg, tiles, L, ntx)
            alpha, power_ok = _alpha(rows, px, py)
            one_m = 1.0 - alpha
            t_incl = torch.cumprod(one_m, dim=1)
            t_excl = torch.cat([torch.ones_like(t_incl[:, :1]),
                                t_incl[:, :-1]], 1)
            needed = ok[..., None] & (t_excl >= T_EPS)
            hit = needed & (alpha > 0)
            contrib = t_incl >= T_EPS
            tot += torch.stack([(needed & ~power_ok).sum(),
                                (needed & power_ok & (alpha == 0)).sum(),
                                (hit & contrib).sum(),
                                (hit & ~contrib).sum()])
            ty, tx = tiles // ntx, tiles % ntx
            ktile = (ty // ratio) * ktx + tx // ratio + v * nk_view
            key = seg.gid[idx] * (cam_view.shape[0] * nk_view) + ktile[:, None]
            keys_hit.append(key[hit.any(-1)])
            keys_contrib.append(key[(hit & contrib).any(-1)])
        nk += nk_view
    hit_rows = torch.unique(torch.cat(keys_hit))
    n_all = cam_view.shape[0] * nk_view
    return {"power_cut": int(tot[0]), "floor_cut": int(tot[1]),
            "contributing": int(tot[2]), "saturating": int(tot[3]),
            "rows": int(hit_rows.numel()),
            "rows_contributing": int(torch.unique(
                torch.cat(keys_contrib)).numel()),
            "tiles_hit": int(torch.unique(hit_rows % n_all).numel()),
            "tiles": nk}
