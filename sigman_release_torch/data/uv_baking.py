"""Offline UV-texture baking: project multi-view RGB onto the body UV atlas
(port of the JAX package's ``data/uv_baking.py``).

For each calibrated view, rasterize the posed mesh (depth, face id,
barycentrics, |cos| between face normal and view ray), back-project the
pixels whose view cosine passes the threshold into the UV atlas by
bilinear scatter-averaging, fill sparse texels from coarser mips, then
dilate seams. The output feeds the dataset's ``UV/smplxuv_albedo.png``.

The JAX package rasterizes with a numpy loop over faces. Here the work per
(pixel, face) pair runs on the device, vectorised over every pixel of every
face's bounding box, in chunks of ``CANDIDATES_PER_CHUNK``:

* the per-vertex projection and the per-face constants are the JAX
  package's numpy float64 expressions on the host; the barycentrics, the
  inside test and the perspective-correct depth are the same float64
  operations, one elementwise op at a time, so every pair's values are
  bit for bit the JAX package's;
* the z-buffer keeps the JAX package's tie rule: faces are visited in index
  order and a face replaces a pixel's only when strictly nearer, so among
  equal depths the lowest face id wins. Each chunk (a run of consecutive
  faces) takes a per-pixel minimum of depth, then the minimum face id among
  the pairs at that depth; a chunk's winner replaces the buffer's only when
  strictly nearer.

The atlas accumulates in float64 with ``index_add_`` (the JAX package adds
in float32, one sample after another, with ``np.add.at``): atomic adds on
the card come in no fixed order, and in float64 that order moves the sums
far below float32's rounding, so the texture does not change from run to
run; float64 sums are also at least as close to the exact sum.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

CANDIDATES_PER_CHUNK = 1 << 25


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def rasterize_mesh(
    verts,                # [V,3] world space
    faces,                # [F,3]
    w2c,                  # [4,4]
    K,                    # [3,3] intrinsics
    img_h: int,
    img_w: int,
    device=None,
) -> Dict[str, torch.Tensor]:
    """Z-buffer rasterization on ``device`` (default the CPU). Returns
    face_id [H,W] int64 (-1 empty), bary [H,W,3], depth [H,W] and viewcos
    [H,W] (|cos| between face normal and view ray), as tensors."""
    dev = torch.device("cpu" if device is None else device)
    verts, faces = _host(verts), _host(faces).astype(np.int64)
    w2c, K = _host(w2c), _host(K)
    cam = (w2c[:3, :3] @ verts.T + w2c[:3, 3:4]).T        # [V,3]
    z = cam[:, 2]
    uvz = (K @ cam.T).T
    px = uvz[:, 0] / np.maximum(uvz[:, 2], 1e-8)
    py = uvz[:, 1] / np.maximum(uvz[:, 2], 1e-8)

    tri_px, tri_py, tri_z = px[faces], py[faces], z[faces]   # [F,3]
    ax, bx, cx = tri_px.T
    ay, by, cy = tri_py.T
    ix0 = np.maximum(np.floor(tri_px.min(axis=1)), 0)
    ix1 = np.minimum(np.ceil(tri_px.max(axis=1)) + 1, img_w)
    iy0 = np.maximum(np.floor(tri_py.min(axis=1)), 0)
    iy1 = np.minimum(np.ceil(tri_py.max(axis=1)) + 1, img_h)
    det = (by - cy) * (ax - cx) + (cx - bx) * (ay - cy)
    live = np.nonzero((tri_z > 1e-4).all(axis=1) & (ix0 < ix1)
                      & (iy0 < iy1) & ~(np.abs(det) < 1e-12))[0]

    def per_face(*arrays):
        return [torch.from_numpy(np.ascontiguousarray(a[live])).to(dev)
                for a in arrays]

    # per live face: the barycentric numerators' coefficients, the bbox
    A0, B0, A1, B1, CX, CY, DET = per_face(
        by - cy, cx - bx, cy - ay, ax - cx, cx, cy, det)
    Z0, Z1, Z2 = per_face(*tri_z.T)
    X0, Y0 = (t.long() for t in per_face(ix0, iy0))
    BW, BH = (t.long() for t in per_face(ix1 - ix0, iy1 - iy0))
    counts = _host(BW * BH)
    fid = torch.from_numpy(live).to(dev)

    def bary(i, gx, gy):
        """(w0, w1, w2) of live face(s) ``i`` at pixel centres (gx, gy), in
        the JAX package's operation order."""
        dxc, dyc = gx - CX[i], gy - CY[i]
        w0 = (A0[i] * dxc + B0[i] * dyc) / DET[i]
        w1 = (A1[i] * dxc + B1[i] * dyc) / DET[i]
        return w0, w1, 1.0 - w0 - w1

    n_pix = img_h * img_w
    zbuf = torch.full((n_pix,), float("inf"), dtype=torch.float64,
                      device=dev)
    best = torch.full((n_pix,), -1, dtype=torch.long, device=dev)
    none = len(live)
    ends = np.cumsum(counts)
    lo = 0
    while lo < len(live):
        # consecutive faces up to the budget (at least one)
        base = ends[lo - 1] if lo else 0
        hi = max(int(np.searchsorted(ends, base + CANDIDATES_PER_CHUNK,
                                     side="right")), lo + 1)
        cnt = torch.from_numpy(counts[lo:hi]).to(dev)
        i = lo + torch.repeat_interleave(
            torch.arange(hi - lo, device=dev), cnt)
        start = torch.cumsum(cnt, 0) - cnt
        off = torch.arange(i.numel(), device=dev) - start[i - lo]
        ix = X0[i] + off % BW[i]
        iy = Y0[i] + torch.div(off, BW[i], rounding_mode="floor")
        w0, w1, w2 = bary(i, ix.double() + 0.5, iy.double() + 0.5)
        inside = (w0 >= 0) & (w1 >= 0) & (w2 >= 0)
        sel = inside.nonzero()[:, 0]
        i, w0, w1, w2 = i[sel], w0[sel], w1[sel], w2[sel]
        pix = iy[sel] * img_w + ix[sel]
        # perspective-correct depth via barycentric interpolation of 1/z
        zi = 1.0 / (w0 / Z0[i] + w1 / Z1[i] + w2 / Z2[i])
        zc = torch.full_like(zbuf, float("inf"))
        zc.scatter_reduce_(0, pix, zi, "amin")
        tie = zi == zc[pix]
        fc = torch.full_like(best, none)
        fc.scatter_reduce_(0, pix[tie], i[tie], "amin")
        nearer = zc < zbuf
        zbuf = torch.where(nearer, zc, zbuf)
        best = torch.where(nearer, fc, best)
        lo = hi

    covered = best >= 0
    pix = covered.nonzero()[:, 0]
    i = best[pix]
    gx = (pix % img_w).double() + 0.5
    gy = torch.div(pix, img_w, rounding_mode="floor").double() + 0.5
    bary_img = torch.zeros((n_pix, 3), dtype=torch.float32, device=dev)
    bary_img[pix] = torch.stack(bary(i, gx, gy), dim=-1).float()
    face_id = torch.full((n_pix,), -1, dtype=torch.long, device=dev)
    face_id[pix] = fid[i]

    # view cosine per face, as the JAX package computes it per pixel
    v0, v1, v2 = (cam[faces[:, k]] for k in range(3))
    n = np.cross(v1 - v0, v2 - v0)
    n /= np.maximum(np.linalg.norm(n, axis=-1, keepdims=True), 1e-12)
    center = (v0 + v1 + v2) / 3
    ray = center / np.maximum(
        np.linalg.norm(center, axis=-1, keepdims=True), 1e-12)
    cos_face = torch.from_numpy(
        np.abs((n * ray).sum(-1)).astype(np.float32)).to(dev)
    viewcos = torch.zeros(n_pix, dtype=torch.float32, device=dev)
    viewcos[pix] = cos_face[face_id[pix]]

    depth = torch.where(torch.isfinite(zbuf), zbuf, 0.0).float()
    return {"face_id": face_id.reshape(img_h, img_w),
            "bary": bary_img.reshape(img_h, img_w, 3),
            "depth": depth.reshape(img_h, img_w),
            "viewcos": viewcos.reshape(img_h, img_w)}


def scatter_average(
    tex: torch.Tensor,       # [T,T,C] accumulator
    weight: torch.Tensor,    # [T,T]
    uv: torch.Tensor,        # [N,2] in [0,1]
    values: torch.Tensor,    # [N,C]
    w: torch.Tensor,         # [N]
) -> None:
    """Bilinear scatter-add of weighted values into the atlas (in place, in
    the accumulators' dtype); grid_put-style."""
    T = tex.shape[0]
    x = torch.clamp(uv[:, 0] * (T - 1), 0, T - 1)
    y = torch.clamp(uv[:, 1] * (T - 1), 0, T - 1)
    x0 = torch.floor(x).long()
    y0 = torch.floor(y).long()
    x1 = torch.clamp(x0 + 1, max=T - 1)
    y1 = torch.clamp(y0 + 1, max=T - 1)
    # numpy's float32 - int64 is float64: the weights are float64 there too
    fx, fy = x.double() - x0, y.double() - y0
    flat_t = tex.view(T * T, -1)
    flat_w = weight.view(T * T)
    for yi, xi, wi in (
        (y0, x0, (1 - fx) * (1 - fy)), (y0, x1, fx * (1 - fy)),
        (y1, x0, (1 - fx) * fy), (y1, x1, fx * fy),
    ):
        idx = yi * T + xi
        flat_t.index_add_(0, idx, (values * (w * wi)[:, None]).to(tex.dtype))
        flat_w.index_add_(0, idx, (w * wi).to(weight.dtype))


def mip_fill(tex: torch.Tensor, weight: torch.Tensor, uv: torch.Tensor,
             values: torch.Tensor, w: torch.Tensor,
             min_resolution: int = 32) -> None:
    """Fill still-empty texels from progressively coarser scatter grids (in
    place), the reference's mip-mapped fallback: each mip level re-scatters
    every sample at half the previous resolution and bilinearly upsamples
    into texels no finer level covered."""
    T, C = tex.shape[0], tex.shape[2]
    cur = T // 2
    while cur >= min_resolution:
        empty = weight <= 1e-6
        if not bool(empty.any()):
            return
        mip_t = tex.new_zeros((cur, cur, C))
        mip_w = weight.new_zeros((cur, cur))
        scatter_average(mip_t, mip_w, uv, values, w)
        # bilinear upsample (align_corners=False): target texel centres
        # sample the mip at (i + .5) * cur / T - .5
        c = (torch.arange(T, dtype=torch.float32, device=tex.device) + 0.5) \
            * cur / T - 0.5
        c0 = torch.clamp(torch.floor(c).long(), 0, cur - 1)
        c1 = torch.clamp(c0 + 1, max=cur - 1)
        f = torch.clamp(c.double() - c0, 0.0, 1.0)

        def up(a):
            a0, a1 = a[c0][:, c0], a[c0][:, c1]
            a2, a3 = a[c1][:, c0], a[c1][:, c1]
            shape = (-1, 1, 1) if a.ndim == 3 else (-1, 1)
            fy = f.reshape(shape)
            fx = f.reshape((1, -1, 1) if a.ndim == 3 else (1, -1))
            return ((a0 * (1 - fx) + a1 * fx) * (1 - fy)
                    + (a2 * (1 - fx) + a3 * fx) * fy)

        tex[empty] += up(mip_t)[empty].to(tex.dtype)
        weight[empty] += up(mip_w)[empty].to(weight.dtype)
        cur //= 2


def dilate_texture(tex: torch.Tensor, weight: torch.Tensor,
                   iterations: int = 16) -> torch.Tensor:
    """Fill empty texels from covered neighbours (seam dilation as an
    iterative flood; shifts wrap around the atlas)."""
    out = tex.clone()
    cov = weight > 1e-6
    for _ in range(iterations):
        if bool(cov.all()):
            break
        empty = ~cov
        acc = torch.zeros_like(out)
        cnt = torch.zeros(out.shape[:2], dtype=out.dtype, device=out.device)
        for dy, dx in ((1, 0), (-1, 0), (0, 1), (0, -1)):
            shifted = torch.roll(out, (dy, dx), dims=(0, 1))
            m = empty & torch.roll(cov, (dy, dx), dims=(0, 1))
            acc += torch.where(m[..., None], shifted, 0.0)
            cnt += m
        fill = cnt > 0
        out = torch.where(fill[..., None],
                          acc / torch.clamp(cnt, min=1.0)[..., None], out)
        cov = cov | fill
    return out


def bake_uv_texture(
    verts,                      # [V,3] posed mesh
    faces,                      # [F,3]
    vert_uv,                    # [V,2] template UV
    images,                     # [N_views,H,W,3] in [0,1]
    w2cs,                       # [N_views,4,4]
    K,                          # [3,3]
    texture_size: int = 1024,
    viewcos_threshold: float = 0.6,
    device=None,
    stats: Optional[dict] = None,
) -> torch.Tensor:
    """Multi-view back-projection -> UV albedo [T,T,3] float32 in [0,1], on
    ``device`` (default the CPU). ``stats``, when given, receives the
    samples scattered and the shares of texels covered by them
    (``direct``) and after the mip fill (``covered``)."""
    dev = torch.device("cpu" if device is None else device)
    faces = _host(faces).astype(np.int64)
    faces_t = torch.from_numpy(faces).to(dev)
    uv_t = torch.as_tensor(_host(vert_uv), dtype=torch.float32, device=dev)
    tex = torch.zeros((texture_size, texture_size, 3), dtype=torch.float64,
                      device=dev)
    weight = torch.zeros((texture_size, texture_size), dtype=torch.float64,
                         device=dev)
    H, W = images.shape[1:3]

    all_uv, all_vals, all_w = [], [], []
    for img, w2c in zip(images, w2cs):
        r = rasterize_mesh(verts, faces, w2c, K, H, W, device=dev)
        mask = (r["face_id"] >= 0) & (r["viewcos"] > viewcos_threshold)
        if not bool(mask.any()):
            continue
        fid = r["face_id"][mask]
        b = r["bary"][mask]                                  # [N,3]
        uv = (uv_t[faces_t[fid]] * b[..., None]).sum(dim=1)
        vals = torch.as_tensor(img, dtype=torch.float32, device=dev)[mask]
        w = r["viewcos"][mask]
        scatter_average(tex, weight, uv, vals, w)
        all_uv.append(uv)
        all_vals.append(vals)
        all_w.append(w)

    if stats is not None:
        stats["samples"] = sum(int(u.shape[0]) for u in all_uv)
        stats["direct"] = float((weight > 1e-6).double().mean())
    # mip-mapped fallback for sparse-coverage texels
    if all_uv:
        mip_fill(tex, weight, torch.cat(all_uv), torch.cat(all_vals),
                 torch.cat(all_w))

    covered = weight > 1e-6
    if stats is not None:
        stats["covered"] = float(covered.double().mean())
    tex[covered] /= weight[covered][:, None]
    return torch.clamp(dilate_texture(tex, weight), 0.0, 1.0).float()
