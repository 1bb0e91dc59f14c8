"""Rasterizer API: projection -> binning -> placement -> K1 -> assembly.

Port of the JAX package's ``ops/rasterizer/render.py``. ``rasterize_single``
renders one Gaussian set from V cameras through one binning of all views and
one ``forward_tiles`` launch over every (view, tile).

Differentiation: projection and binning are plain PyTorch (autograd); the
placement of pair rows into the dense ``[budget, 16]`` stream and the
compositing carry one rule, :class:`Composite`, whose forward is K1 and
whose backward is K2 (``backward_tiles``) followed by the pair -> Gaussian
scatter-add of the live stream rows (the JAX package's
``regroup_pair_grads``). With ``grad_stream_bf16`` K2 writes the stream's
gradient in bf16 and only its live rows are widened to f32 for the sums, as
the JAX package's one custom VJP over placement and compositing does: a
bf16 gradient that crossed an autograd edge of the f32 stream would be cast
back to a whole f32 copy.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from sigman_release_torch.ops.rasterizer import binning as binning_lib
from sigman_release_torch.ops.rasterizer.backward_tiles import backward_tiles
from sigman_release_torch.ops.rasterizer.forward_tiles import TILE, forward_tiles
from sigman_release_torch.ops.rasterizer.preprocess import project_gaussians
from sigman_release_torch.utils.timing import NULL_TIMER


class RasterizeConfig(NamedTuple):
    """Static rasterizer parameters. The knobs ``tile``,
    ``grad_stream_bf16``, ``early_stop``, ``per_view_budget`` and
    ``cumsum_mode`` carry the JAX package's names and meanings; set one on
    a renderer with ``renderer.raster_cfg = renderer.raster_cfg._replace(
    ...)``. The JAX package's ``regroup_mode``, ``compact_sort`` and
    ``interpret`` choose how its TPU program is lowered and have no
    counterpart here."""

    img_h: int = 512
    img_w: int = 512
    tan_half_fovx: float = 0.4654
    tan_half_fovy: float = 0.4654
    # pair-stream granularity: the budget rounds up to it, per-view regions
    # align to it, and the plain version composites one chunk per step
    chunk: int = 128
    # windows in tiles of side ``tile``: widen them as the tile shrinks
    max_tiles_per_gaussian: int = 9
    pair_budget_factor: int = 5
    # side of the top-K fallback window (tiles)
    big_win: int = 6
    # opacity-exact cutoff radius (binning.bin_gaussians); False reproduces
    # the CUDA preprocess's 3-sigma tile-rect truncation
    exact_radius: bool = True
    # pixel tile side, 16 or 32 (each has its instantiation of K1 and K2)
    tile: int = TILE
    # K2 writes the pair-gradient stream in bf16 (rounded to nearest even;
    # the sums into the Gaussian rows stay f32). The JAX package defaults to
    # True; the port to the f32 stream
    grad_stream_bf16: bool = False
    # a tile stops once every pixel has saturated (T < 1e-4); False walks
    # every segment to its end, with the same output bit for bit
    early_stop: bool = True
    # None: per-view budget regions when V > 1, one global prefix otherwise
    per_view_budget: Optional[bool] = None
    # the JAX kernels' prefix sums are triangular matmuls on the MXU, and
    # "bf16x2" / "bf16" trade passes for rounding; the port's kernels keep
    # a running f32 product, which is the "f32" class, so only it is taken
    cumsum_mode: str = "f32"

    @property
    def ntx(self) -> int:
        return -(-self.img_w // self.tile)

    @property
    def nty(self) -> int:
        return -(-self.img_h // self.tile)

    @property
    def n_tiles(self) -> int:
        return self.ntx * self.nty


def check_config(cfg: RasterizeConfig) -> RasterizeConfig:
    """``cfg`` if the port's kernels can run it, else ValueError."""
    binning_lib.check_tile(cfg.tile)
    if cfg.cumsum_mode != "f32":
        raise ValueError(
            f"cumsum_mode={cfg.cumsum_mode!r}: the JAX package's "
            "'bf16x2' / 'bf16' choose how many MXU passes its triangular-"
            "matmul prefix sums take; the port's kernels keep a running f32 "
            "product (the 'f32' class) and take only 'f32'")
    return cfg


class PairStream(NamedTuple):
    """What K1 consumes: the dense pair stream and its tile segments, and
    where its live rows come from."""

    pairs: torch.Tensor        # [budget, 16] f32, no autograd history
    tile_start: torch.Tensor   # [V*n_tiles] i32
    tile_count: torch.Tensor   # [V*n_tiles] i32
    overflow: torch.Tensor     # [] i64 dropped (gaussian, tile) pairs
    src: torch.Tensor          # [V*N + V*K, 16] pair rows (differentiable)
    slots: torch.Tensor        # [L] i64 stream rows that hold a pair
    rows: torch.Tensor         # [L] i64 their ``src`` rows


def prepare_pairs(means3d, cov3d, colors, opacity, cam_view, cam_view_proj,
                  cfg: RasterizeConfig) -> PairStream:
    """Project, bin and place: the pair stream of one Gaussian set, V views
    (per-view budget regions or one global prefix, ``per_view_budget``)."""
    check_config(cfg)
    V = cam_view.shape[0]
    proj = project_gaussians(means3d, cov3d, cam_view, cam_view_proj,
                             cfg.tan_half_fovx, cfg.tan_half_fovy,
                             cfg.img_h, cfg.img_w)
    pvb = cfg.per_view_budget if cfg.per_view_budget is not None else V > 1
    bins = binning_lib.bin_gaussians(
        proj, colors, opacity, cfg.img_h, cfg.img_w,
        max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
        chunk=cfg.chunk,
        pair_budget=cfg.pair_budget_factor * means3d.shape[0] * V,
        big_win=cfg.big_win,
        exact_radius=cfg.exact_radius,
        per_view_budget=pvb,
        tile_size=cfg.tile,
    )
    src = torch.cat([bins.feats16, bins.feats_big])
    pairs, slots, rows = binning_lib.place_pairs(
        src, bins.valid_prefix, bins.pay_prefix, bins.dims)
    return PairStream(pairs, bins.tile_start, bins.tile_count, bins.overflow,
                      src, slots, rows)


class Composite(torch.autograd.Function):
    """Placement and tile compositing with their analytic VJP: forward K1
    on the placed stream, backward K2 and the scatter-add of the live
    stream rows into the ``src`` rows.

    Takes ``src`` (the only differentiable input), the placed stream, its
    live rows and segments and the config; returns the tile buffers.
    """

    @staticmethod
    def forward(ctx, src, pairs, slots, rows, tile_start, tile_count, cfg):
        tiles = forward_tiles(pairs, tile_start, tile_count, ntx=cfg.ntx,
                              tiles_per_view=cfg.n_tiles, chunk=cfg.chunk,
                              tile=cfg.tile, early_stop=cfg.early_stop)
        ctx.save_for_backward(pairs, slots, rows, tile_start, tile_count,
                              tiles)
        ctx.cfg, ctx.src_rows = cfg, src.shape[0]
        return tiles

    @staticmethod
    def backward(ctx, g_tiles):
        pairs, slots, rows, tile_start, tile_count, tiles = ctx.saved_tensors
        cfg = ctx.cfg
        d_pairs = backward_tiles(pairs, tile_start, tile_count, tiles,
                                 g_tiles.contiguous(), ntx=cfg.ntx,
                                 tiles_per_view=cfg.n_tiles, chunk=cfg.chunk,
                                 tile=cfg.tile, early_stop=cfg.early_stop,
                                 out_bf16=cfg.grad_stream_bf16)
        return (regroup(d_pairs, slots, rows, ctx.src_rows), None, None, None,
                None, None, None)


def regroup(d_pairs, slots, rows, n_rows: int) -> torch.Tensor:
    """The pair -> row scatter-add: d(src) [n_rows, 16] f32 from the
    stream's gradient [budget, 16] (f32 or bf16). Only the live rows are
    gathered and widened to f32; the sums are autograd's VJP of the
    placement gather (a sorted ``index_put`` accumulate)."""
    d_src = torch.zeros((n_rows, d_pairs.shape[1]), dtype=torch.float32,
                        device=d_pairs.device)
    return d_src.index_put_((rows,), d_pairs[slots].float(), accumulate=True)


def composite(stream: PairStream, cfg: RasterizeConfig) -> torch.Tensor:
    """K1 over every (view, tile) of the stream -> [V*n_tiles, 8, tile^2];
    differentiable w.r.t. ``stream.src`` through K2."""
    return Composite.apply(stream.src, stream.pairs, stream.slots,
                           stream.rows, stream.tile_start, stream.tile_count,
                           check_config(cfg))


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
    t = tiles.reshape(V, cfg.nty, cfg.ntx, 8, cfg.tile, cfg.tile)
    t = t.permute(0, 3, 1, 4, 2, 5)  # [V,8,nty,tile,ntx,tile]
    t = t.reshape(V, 8, cfg.nty * cfg.tile, cfg.ntx * cfg.tile)
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
