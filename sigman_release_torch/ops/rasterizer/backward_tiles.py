"""K2: analytic VJP of the tile compositing pass — CUDA kernel + plain version.

Replaces the Pallas TPU kernel ``ops/rasterizer/pallas_backward.py::
backward_tiles`` of the JAX package. Given K1's pair stream and segments,
its tile buffers ``fwd [n, 8, tile^2]`` and the upstream gradients ``grad``
of the same shape (rows 0-4: rgb, depth, 1 - Tr), returns the gradient of
the row-major ``[budget, 16]`` pair stream: per pair row d(mean x, mean y,
conic a, b, c, r, g, b, opacity, depth), columns 10-15 zero, and zero rows
outside every segment or past the point where a tile saturated. ``tile``
and ``early_stop`` are K1's; with ``out_bf16`` the rows are stored in bf16,
each value rounded to nearest even from the f32 sums (the JAX kernel's
``out_bf16``: half the bytes to fill, write and gather).

Math (the suffix trick of the JAX kernel): per pixel
``TOT = g_rgb . rgb_out + g_d depth_out - g_alpha Tr``; front to back with
``u = g_rgb . c + g_d depth`` and the inclusive prefix of ``u w``,
``d_pow = u w - alpha / (1 - alpha) (TOT - prefix)`` for contributing
pairs below the 0.99 clamp, else 0; per pair the pixel moments of
``d_pow`` about the pair's mean (``dx, dy = mean - pixel``) give the mean
and conic gradients, ``S0 / opa`` the opacity gradient and ``sum w g`` the
colour and depth gradients. (The JAX kernel sums tile-local moments and
expands them, ``-(ml^2 S0 - 2 ml SX + SXX) / 2``; with a mean tens of
pixels off the tile the terms cancel by orders of magnitude, so both the
kernel and this version sum the centred moments instead.) In the band
``0 < power <= POWER_EPS`` the forward clamps the exponent at 0 while the
gradient still differentiates ``opa exp(power)`` (the JAX package's
straight-through derivative).

``backward_tiles`` launches the CUDA kernel (``csrc/backward_tiles.cu``)
for a CUDA tensor and takes the plain version only for a CPU tensor. The
kernel culls as forward_tiles' does (pairs with alpha 0 at every pixel of a
warp's rectangle), which changes no term of the sums.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from sigman_release_torch.ops.rasterizer.binning import (
    F_CA, F_CB, F_CC, F_DEPTH, F_MX, F_MY, F_OPA, F_R, PAIR_FEATS, TILE,
    check_tile,
)
from sigman_release_torch.ops.rasterizer.forward_tiles import (
    ALPHA_MAX, PLAIN_STEP_ELEMS, T_EPS, WARP_CLASSES, WORK_CLASSES, _alpha,
    count_variants, cull_rects, launch_order, open_tiles, pixel_frame,
    segment_chunks, work_counts,
)
from sigman_release_torch.utils import cuda_build

SOURCE = Path(__file__).resolve().parent / "csrc" / "backward_tiles.cu"
# the plain version's steps hold ~3x forward_tiles_plain's temporaries
PLAIN_STEP_ELEMS_BWD = PLAIN_STEP_ELEMS // 2


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.backward_tiles_launch
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def launch(pairs, tile_start, tile_count, order, fwd_tiles, grad_tiles, out,
           *, ntx: int, tiles_per_view: int, tile: int, early_stop: bool):
    """One launch of the kernel into ``out`` (zeros, f32 or bf16) on the
    current stream, uncounted: the wrapper's, and chip_smoke.py's timing of
    the launch alone. Raises on a launch error."""
    rc = _library().backward_tiles_launch(
        pairs.data_ptr(), tile_start.data_ptr(), tile_count.data_ptr(),
        order.data_ptr(), fwd_tiles.data_ptr(), grad_tiles.data_ptr(),
        out.data_ptr(), tile_start.shape[0], ntx, tiles_per_view, tile,
        int(early_stop), int(out.dtype == torch.bfloat16),
        torch.cuda.current_stream(pairs.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"backward_tiles kernel launch failed: cudaError {rc}")


def backward_tiles(pairs: torch.Tensor, tile_start: torch.Tensor,
                   tile_count: torch.Tensor, fwd_tiles: torch.Tensor,
                   grad_tiles: torch.Tensor, *, ntx: int, tiles_per_view: int,
                   chunk: int = 128, tile: int = TILE, early_stop: bool = True,
                   out_bf16: bool = False) -> torch.Tensor:
    """d(pairs) [budget, 16] f32 (bf16 with ``out_bf16``) from the forward
    tile buffers and their upstream gradients (both [n, 8, tile^2] f32).

    CUDA tensors launch the kernel of that tile and output type (counted in
    ``backward_tiles.launches``, and by variant in
    ``backward_tiles.launches_by_variant``) into a zero-filled result; CPU
    tensors run :func:`backward_tiles_plain` (``chunk`` sets its pair
    grouping).
    """
    check_tile(tile)
    if pairs.device.type == "cpu":
        return backward_tiles_plain(pairs, tile_start, tile_count, fwd_tiles,
                                    grad_tiles, ntx=ntx,
                                    tiles_per_view=tiles_per_view, chunk=chunk,
                                    tile=tile, early_stop=early_stop,
                                    out_bf16=out_bf16)
    if pairs.device.type != "cuda":
        raise ValueError(f"backward_tiles: unsupported device {pairs.device}")
    n = tile_start.shape[0]
    if pairs.dtype != torch.float32 or pairs.ndim != 2 \
            or pairs.shape[1] != PAIR_FEATS:
        raise ValueError(f"pairs must be [budget, {PAIR_FEATS}] float32, got "
                         f"{tuple(pairs.shape)} {pairs.dtype}")
    for name, x in (("tile_start", tile_start), ("tile_count", tile_count)):
        if x.dtype != torch.int32 or x.shape != (n,) or x.device != pairs.device:
            raise ValueError(f"{name} must be int32 [{n}] on {pairs.device}")
    for name, x in (("fwd_tiles", fwd_tiles), ("grad_tiles", grad_tiles)):
        if x.dtype != torch.float32 or x.shape != (n, 8, tile * tile) \
                or x.device != pairs.device:
            raise ValueError(f"{name} must be float32 [{n}, 8, {tile * tile}] "
                             f"on {pairs.device}")
    if not all(x.is_contiguous() for x in (pairs, tile_start, tile_count,
                                           fwd_tiles, grad_tiles)):
        raise ValueError("backward_tiles needs contiguous inputs")
    if pairs.data_ptr() % 16:
        raise ValueError("pairs must be 16-byte aligned")
    out = torch.zeros_like(
        pairs, dtype=torch.bfloat16 if out_bf16 else torch.float32)
    launch(pairs, tile_start, tile_count, launch_order(tile_count), fwd_tiles,
           grad_tiles, out, ntx=ntx, tiles_per_view=tiles_per_view, tile=tile,
           early_stop=early_stop)
    backward_tiles.launches += 1
    count_variants(backward_tiles.launches_by_variant, tile, early_stop,
                   out_bf16)
    return out


backward_tiles.launches = 0
backward_tiles.launches_by_variant = {}


def _pair_grads(feats, mom, cd):
    """Per-pair gradient rows [..., 16] from the centred pixel moments
    mom [..., 6] = (S0, Sx, Sy, Sxx, Sxy, Syy) of d_pow and cd [..., 4] =
    sum w g_{r,g,b,d} (the JAX kernel's lines 254-280)."""
    s0, sx, sy, sxx, sxy, syy = mom.unbind(-1)
    ca, cb, cc = feats[..., F_CA], feats[..., F_CB], feats[..., F_CC]
    opa = feats[..., F_OPA]
    zero = torch.zeros_like(s0)
    return torch.stack([
        -(ca * sx + cb * sy),
        -(cc * sy + cb * sx),
        -0.5 * sxx,
        -sxy,
        -0.5 * syy,
        cd[..., 0], cd[..., 1], cd[..., 2],
        torch.where(opa > 0.0, s0 / torch.clamp(opa, min=1e-12), 0.0),
        cd[..., 3],
        zero, zero, zero, zero, zero, zero], dim=-1)


def backward_tiles_plain(pairs, tile_start, tile_count, fwd_tiles,
                         grad_tiles, *, ntx, tiles_per_view, chunk=128,
                         tile=TILE, early_stop=True, out_bf16=False,
                         work=None):
    """Plain PyTorch version of :func:`backward_tiles` (same arguments).

    Vectorised as ``forward_tiles_plain``: groups of tiles step over the
    JAX package's global chunk grid, carrying T and the ``u w`` prefix;
    inside a chunk the exclusive transmittance is exp(cumsum(log(1 -
    alpha))), the prefix a cumsum, the moments sums over the pixel axis.
    Each pair row lies in exactly one segment, so each is written once.
    With ``out_bf16`` the f32 rows are rounded to bf16 at the end.

    ``work``, if a dict, receives the count of each of ``WORK_CLASSES`` and
    ``WARP_CLASSES``, as ``forward_tiles_plain`` counts them.
    """
    check_tile(tile)
    dev = pairs.device
    n = tile_start.shape[0]
    npx = tile * tile
    ox, oy, basis = pixel_frame(n, tiles_per_view, ntx, dev, tile)
    X, Y = basis[1], basis[2]
    chunk0, off, count, n_chunks = segment_chunks(tile_start, tile_count,
                                                  chunk)
    row = torch.arange(chunk, device=dev)
    last = max(pairs.shape[0] - 1, 0)

    g = grad_tiles[:, :4]                                   # [n,4,P] rgb, d
    f = fwd_tiles
    tot = ((grad_tiles[:, 0] * f[:, 0] + grad_tiles[:, 1] * f[:, 1]
            + grad_tiles[:, 2] * f[:, 2] + grad_tiles[:, 3] * f[:, 3]
            - grad_tiles[:, 4] * f[:, 5]))[:, None]          # [n,1,P]
    out = torch.zeros_like(pairs)
    Tf = torch.ones((n, 1, npx), device=dev)
    prefix = torch.zeros((n, 1, npx), device=dev)
    alive = torch.ones(n, dtype=torch.bool, device=dev)
    classes = WORK_CLASSES + WARP_CLASSES
    counts = torch.zeros(len(classes), dtype=torch.int64, device=dev)
    group = max(1, PLAIN_STEP_ELEMS_BWD // (chunk * npx))
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
            ga = g[act]                                      # [a,4,P]
            cols = feats[..., [F_R, F_R + 1, F_R + 2, F_DEPTH]]   # [a,K,4]
            uw = torch.einsum("akf,afp->akp", cols, ga) * w
            pref = prefix[act] + torch.cumsum(uw, dim=1)
            # the 0.99 clamp has no gradient (where alpha > 0, alpha < 0.99
            # is the kernel's opa exp(min(power, 0)) < 0.99)
            d_pow = torch.where(
                alpha < ALPHA_MAX,
                uw - torch.where(contrib, alpha / one_m * (tot[act] - pref),
                                 0.0),
                0.0)
            dx = (feats[..., F_MX] - ox[act])[..., None] - X  # mean - pixel
            dy = (feats[..., F_MY] - oy[act])[..., None] - Y
            px, py = d_pow * dx, d_pow * dy
            mom = torch.stack([d_pow.sum(-1), px.sum(-1), py.sum(-1),
                               (px * dx).sum(-1), (px * dy).sum(-1),
                               (py * dy).sum(-1)], dim=-1)   # [a,K,6]
            cd = torch.einsum("akp,afp->akf", w, ga)         # [a,K,4]
            rows = _pair_grads(feats, mom, cd)
            out[idx[row_ok]] = rows[row_ok]
            if work is not None:
                counts += work_counts(row_ok, t_excl, power_ok, alpha,
                                      contrib,
                                      cull_rects(feats, ox[act], oy[act],
                                                 tile), tile)
            Tf[act] = t_incl[:, -1:]
            prefix[act] = pref[:, -1:]
            if early_stop:
                alive[act] = Tf[act].amax(dim=(1, 2)) >= T_EPS
    if work is not None:
        work.update(zip(classes, counts.tolist()))
    return out.to(torch.bfloat16) if out_bf16 else out
