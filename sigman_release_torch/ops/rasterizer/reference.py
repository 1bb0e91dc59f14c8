"""Dense golden-model renderer: per-pixel alpha compositing over all Gaussians.

Port of the JAX package's ``ops/rasterizer/reference.py``. O(pixels x N):
slow, but differentiable by autograd and faithful to the CUDA tile
rasterizer's compositing rules (alpha clamp at 0.99, 1/255 contribution
floor, T < 1e-4 stop). The synthetic dataset renders with it, and the tests
hold the tile rasterizer's gradients against it.
"""

from __future__ import annotations

import torch

from sigman_release_torch.ops.rasterizer.binning import TILE
from sigman_release_torch.ops.rasterizer.preprocess import project_gaussians

ALPHA_MAX = 0.99
ALPHA_MIN = 1.0 / 255.0
T_EPS = 1e-4


def render_dense(
    means3d: torch.Tensor,        # [N,3]
    cov3d: torch.Tensor,          # [N,6]
    colors: torch.Tensor,         # [N,3]
    opacity: torch.Tensor,        # [N] or [N,1]
    cam_view: torch.Tensor,       # [4,4]
    cam_view_proj: torch.Tensor,  # [4,4]
    tan_half_fovx: float,
    tan_half_fovy: float,
    img_h: int,
    img_w: int,
    bg_color: torch.Tensor,       # [3]
    tile_size: int = TILE,
):
    """Render one view. Returns dict with image [3,H,W], alpha/depth [1,H,W].

    A Gaussian touches exactly the pixels of the ``tile_size``-pixel tiles
    its 3-sigma screen rect overlaps (the CUDA rasterizer's tile-rect
    cutoff; 32 is the JAX oracle's default); ``tile_size=0`` composites every
    Gaussian at every pixel. Rows go in blocks of 16 to bound the
    [rows, W, N] intermediates.
    """
    row_block, tile = 16, tile_size
    opacity = opacity.reshape(-1)
    proj = project_gaussians(means3d, cov3d, cam_view, cam_view_proj,
                             tan_half_fovx, tan_half_fovy, img_h, img_w)
    # global front-to-back order (stable for deterministic tie behaviour)
    key = torch.where(proj.valid, proj.depth,
                      torch.full_like(proj.depth, float("inf")))
    order = torch.sort(key.detach(), stable=True).indices
    mean2d = proj.mean2d[order]
    conic = proj.conic[order]
    depth = proj.depth[order]
    radius = proj.radius[order]
    col = colors[order].to(torch.float32)
    opa = torch.where(proj.valid[order], opacity[order].to(torch.float32), 0.0)
    xs = torch.arange(img_w, dtype=torch.float32, device=means3d.device)
    if tile:
        x0 = torch.floor((mean2d[:, 0] - radius) / tile)
        x1 = torch.floor((mean2d[:, 0] + radius) / tile) + 1
        y0 = torch.floor((mean2d[:, 1] - radius) / tile)
        y1 = torch.floor((mean2d[:, 1] + radius) / tile) + 1

    def block_fn(y_rows):                         # [R] row indices
        px = xs[None, :, None]                    # [1,W,1]
        py = y_rows[:, None, None].to(torch.float32)   # [R,1,1]
        dx = mean2d[None, None, :, 0] - px        # [R,W,N]
        dy = mean2d[None, None, :, 1] - py
        power = (-0.5 * (conic[:, 0] * dx * dx + conic[:, 2] * dy * dy)
                 - conic[:, 1] * dx * dy)
        alpha = torch.clamp(opa * torch.exp(power), max=ALPHA_MAX)
        alpha = torch.where(power > 0.0, 0.0, alpha)     # CUDA skips power>0
        alpha = torch.where(alpha < ALPHA_MIN, 0.0, alpha)
        if tile:
            tx = torch.floor(px / tile)
            ty = torch.floor(py / tile)
            in_rect = (tx >= x0) & (tx < x1) & (ty >= y0) & (ty < y1)
            alpha = torch.where(in_rect, alpha, 0.0)
        one_m = 1.0 - alpha
        t_inc = torch.cumprod(one_m, dim=-1)             # inclusive
        contrib = t_inc >= T_EPS                         # early-stop rule
        t_exc = torch.cat([torch.ones_like(t_inc[..., :1]), t_inc[..., :-1]],
                          dim=-1)
        w = torch.where(contrib, alpha * t_exc, 0.0)     # [R,W,N]
        t_final = torch.prod(torch.where(contrib, one_m, 1.0), dim=-1)
        rgb = torch.einsum("rwn,nc->crw", w, col)
        d = torch.einsum("rwn,n->rw", w, depth)
        rgb = rgb + t_final[None] * bg_color[:, None, None]
        return rgb, d, 1.0 - t_final

    n_blocks = -(-img_h // row_block)
    rows = (torch.arange(n_blocks * row_block, device=means3d.device)
            % img_h).reshape(n_blocks, row_block)
    outs = [block_fn(r) for r in rows]
    rgb = torch.cat([o[0] for o in outs], dim=1)[:, :img_h]
    d = torch.cat([o[1] for o in outs], dim=0)[:img_h]
    a = torch.cat([o[2] for o in outs], dim=0)[:img_h]
    return {"image": torch.clamp(rgb, 0.0, 1.0), "alpha": a[None],
            "depth": d[None]}
