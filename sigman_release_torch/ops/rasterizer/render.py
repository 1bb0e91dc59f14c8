"""Rasterizer API: projection -> binning -> placement -> K1 -> assembly.

Port of the JAX package's ``ops/rasterizer/render.py``. ``rasterize_single``
renders one Gaussian set from V cameras through one binning of all views and
one ``forward_tiles`` launch over every (view, tile).

Differentiation: projection, binning and placement are plain PyTorch
(autograd); only compositing carries its own rule, :class:`Composite`,
whose forward is K1 and whose backward is K2 (``backward_tiles``). Its
boundary is the dense ``[budget, 16]`` pair stream, so autograd carries
d(stream) back through ``place_pairs``' gather of pair rows: the VJP of that
gather is the pair -> Gaussian scatter-add the JAX package builds by hand
(``regroup_pair_grads``). The gradient stream is f32 (the JAX package's
``grad_stream_bf16=False``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from sigman_release_torch.ops.rasterizer import binning as binning_lib
from sigman_release_torch.ops.rasterizer.backward_tiles import backward_tiles
from sigman_release_torch.ops.rasterizer.forward_tiles import TILE, forward_tiles
from sigman_release_torch.ops.rasterizer.preprocess import project_gaussians
from sigman_release_torch.utils.timing import NULL_TIMER


class RasterizeConfig(NamedTuple):
    """Static rasterizer parameters."""

    img_h: int = 512
    img_w: int = 512
    tan_half_fovx: float = 0.4654
    tan_half_fovy: float = 0.4654
    # pair-stream granularity: the budget rounds up to it, per-view regions
    # align to it, and the plain version composites one chunk per step
    chunk: int = 128
    max_tiles_per_gaussian: int = 9
    pair_budget_factor: int = 5
    # side of the top-K fallback window (tiles)
    big_win: int = 6
    # opacity-exact cutoff radius (binning.bin_gaussians); False reproduces
    # the CUDA preprocess's 3-sigma tile-rect truncation
    exact_radius: bool = True

    @property
    def ntx(self) -> int:
        return -(-self.img_w // TILE)

    @property
    def nty(self) -> int:
        return -(-self.img_h // TILE)

    @property
    def n_tiles(self) -> int:
        return self.ntx * self.nty


class PairStream(NamedTuple):
    """What K1 consumes: the dense pair stream and its tile segments."""

    pairs: torch.Tensor        # [budget, 16] f32
    tile_start: torch.Tensor   # [V*n_tiles] i32
    tile_count: torch.Tensor   # [V*n_tiles] i32
    overflow: torch.Tensor     # [] i64 dropped (gaussian, tile) pairs


def prepare_pairs(means3d, cov3d, colors, opacity, cam_view, cam_view_proj,
                  cfg: RasterizeConfig) -> PairStream:
    """Project, bin and place: the pair stream of one Gaussian set, V views
    (per-view budget regions when V > 1, one global prefix otherwise)."""
    V = cam_view.shape[0]
    proj = project_gaussians(means3d, cov3d, cam_view, cam_view_proj,
                             cfg.tan_half_fovx, cfg.tan_half_fovy,
                             cfg.img_h, cfg.img_w)
    bins = binning_lib.bin_gaussians(
        proj, colors, opacity, cfg.img_h, cfg.img_w,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        chunk=cfg.chunk,
        pair_budget=cfg.pair_budget_factor * means3d.shape[0] * V,
        big_win=cfg.big_win,
        exact_radius=cfg.exact_radius,
        per_view_budget=V > 1,
    )
    pairs = binning_lib.place_pairs(bins.feats16, bins.feats_big,
                                    bins.valid_prefix, bins.pay_prefix,
                                    bins.dims)
    return PairStream(pairs.contiguous(), bins.tile_start, bins.tile_count,
                      bins.overflow)


class Composite(torch.autograd.Function):
    """Tile compositing with its analytic VJP: forward K1, backward K2.

    Takes the pair stream and its segments; saves the stream, the segments
    and the tile buffers; returns d(stream) (segments take no gradient).
    """

    @staticmethod
    def forward(ctx, pairs, tile_start, tile_count, ntx, tiles_per_view,
                chunk):
        tiles = forward_tiles(pairs, tile_start, tile_count, ntx=ntx,
                              tiles_per_view=tiles_per_view, chunk=chunk)
        ctx.save_for_backward(pairs, tile_start, tile_count, tiles)
        ctx.layout = (ntx, tiles_per_view, chunk)
        return tiles

    @staticmethod
    def backward(ctx, g_tiles):
        pairs, tile_start, tile_count, tiles = ctx.saved_tensors
        ntx, tiles_per_view, chunk = ctx.layout
        d_pairs = backward_tiles(pairs, tile_start, tile_count, tiles,
                                 g_tiles.contiguous(), ntx=ntx,
                                 tiles_per_view=tiles_per_view, chunk=chunk)
        return d_pairs, None, None, None, None, None


def composite(stream: PairStream, cfg: RasterizeConfig) -> torch.Tensor:
    """K1 over every (view, tile) of the stream -> [V*n_tiles, 8, TILE^2];
    differentiable w.r.t. ``stream.pairs`` through K2."""
    return Composite.apply(stream.pairs, stream.tile_start, stream.tile_count,
                           cfg.ntx, cfg.n_tiles, cfg.chunk)


def finish(tiles, overflow, V: int, bg_color, cfg: RasterizeConfig):
    """Tile buffers -> image (over ``bg_color``), alpha, depth maps."""
    rgb, depth, alpha = _assemble(tiles, V, cfg)
    image = rgb + (1.0 - alpha) * bg_color[None, :, None, None]
    return {
        "image": torch.clamp(image, 0.0, 1.0),
        "alpha": alpha,
        "depth": depth,
        "overflow": overflow,
    }


def rasterize_single(
    means3d: torch.Tensor,        # [N,3]
    cov3d: torch.Tensor,          # [N,6] packed
    colors: torch.Tensor,         # [N,3]
    opacity: torch.Tensor,        # [N]
    cam_view: torch.Tensor,       # [V,4,4]
    cam_view_proj: torch.Tensor,  # [V,4,4]
    bg_color: torch.Tensor,       # [3]
    cfg: RasterizeConfig,
    timer=NULL_TIMER,
):
    """Render one Gaussian set from V cameras. Returns dict of [V,...] maps.

    ``timer`` receives the "binning" (projection, binning, placement) and
    "forward_tiles" stages (forward only; the backward runs when autograd
    reaches it).
    """
    with timer("binning"):
        stream = prepare_pairs(means3d, cov3d, colors, opacity, cam_view,
                               cam_view_proj, cfg)
    with timer("forward_tiles"):
        tiles = composite(stream, cfg)
    return finish(tiles, stream.overflow, cam_view.shape[0], bg_color, cfg)


def _assemble(tiles: torch.Tensor, V: int, cfg: RasterizeConfig):
    """[V*n_tiles, 8, PX] -> (rgb [V,3,H,W], depth [V,1,H,W], alpha [V,1,H,W])."""
    t = tiles.reshape(V, cfg.nty, cfg.ntx, 8, TILE, TILE)
    t = t.permute(0, 3, 1, 4, 2, 5)  # [V,8,nty,TILE,ntx,TILE]
    t = t.reshape(V, 8, cfg.nty * TILE, cfg.ntx * TILE)
    t = t[:, :, : cfg.img_h, : cfg.img_w]
    return t[:, 0:3], t[:, 3:4], t[:, 4:5]


def rasterize(
    means3d: torch.Tensor,        # [B,N,3]
    cov3d: torch.Tensor,          # [B,N,6]
    colors: torch.Tensor,         # [B,N,3]
    opacity: torch.Tensor,        # [B,N]
    cam_view: torch.Tensor,       # [B,V,4,4]
    cam_view_proj: torch.Tensor,  # [B,V,4,4]
    bg_color: torch.Tensor,       # [3]
    cfg: RasterizeConfig,
    timer=NULL_TIMER,
):
    """Batched render. Returns image [B,V,3,H,W], alpha/depth [B,V,1,H,W]."""
    outs = [
        rasterize_single(means3d[b], cov3d[b], colors[b], opacity[b],
                         cam_view[b], cam_view_proj[b], bg_color, cfg, timer)
        for b in range(cam_view.shape[0])
    ]
    return {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
