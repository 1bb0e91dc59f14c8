"""High-level Gaussian renderer (port of the JAX package's ``renderer.py``
``GaussianRenderer.render``).

* per-Gaussian base scale from the detached mean 3-NN distance
  (``ops/knn.mean_knn_dist2``, the reference's ``distCUDA2``): only it runs
  under ``torch.no_grad()``, everything else is differentiable,
* ``scale = (pred + 1) * sqrt(dist2)``, covariance R diag(s^2) R^T,
* white background default, [B,V] camera batches, f32 geometry whatever the
  network's dtype,
* compositing through the tile rasterizer (``ops/rasterizer``), whose
  ``forward_tiles`` (K1) and ``backward_tiles`` (K2) are the CUDA kernels
  for CUDA tensors.

``render_free`` renders the free Gaussians of the 14-channel head
(``models/render_head.py``) or of a PLY file (``utils/ply.py``): absolute
scales and quaternion rotations, no KNN base scale.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from sigman_release_torch.config import Config
from sigman_release_torch.models.render_head import RenderHead
from sigman_release_torch.ops.knn import mean_knn_dist2
from sigman_release_torch.ops.rasterizer import (
    RasterizeConfig,
    build_cov3d,
    rasterize,
)
from sigman_release_torch.utils.timing import NULL_TIMER


class GaussianRenderer:
    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.raster_cfg = RasterizeConfig(
            img_h=cfg.output_size,
            img_w=cfg.output_size,
            tan_half_fovx=math.tan(0.5 * cfg.fovx),
            tan_half_fovy=math.tan(0.5 * cfg.fovy),
            max_tiles_per_gaussian=cfg.max_tiles_per_gaussian,
            pair_budget_factor=cfg.pair_budget_factor,
            big_win=max(cfg.render_big_win,
                        math.isqrt(cfg.max_tiles_per_gaussian)),
        )

    def prepare(self, gaussians: Dict[str, torch.Tensor]):
        """Network outputs -> f32 (position, cov3d, rgb, opacity) [B,N,...].

        gaussians: position [B,N,3], opacity [B,N(,1)], scale [B,N,3]
        (pre-activation), rotation matrices [B,N,3,3] under ``cov3d`` (the
        reference's name) or ``rot``, rgb [B,N,3]. The scale is relative to
        the detached mean 3-NN distance.
        """
        f32 = torch.float32
        pos = gaussians["position"].to(f32)
        opacity = gaussians["opacity"].to(f32)
        if opacity.ndim == 3:
            opacity = opacity[..., 0]
        rot = gaussians.get("cov3d", gaussians.get("rot")).to(f32)
        with torch.no_grad():
            dist2 = torch.stack([mean_knn_dist2(p) for p in pos])
        base = torch.sqrt(torch.clamp(dist2, min=1e-7))[..., None]
        cov3d = build_cov3d((gaussians["scale"].to(f32) + 1.0) * base, rot)
        return pos, cov3d, gaussians["rgb"].to(f32), opacity

    def render(
        self,
        gaussians: Dict[str, torch.Tensor],
        cam_view: torch.Tensor,        # [B,V,4,4]
        cam_view_proj: torch.Tensor,   # [B,V,4,4]
        bg_color: Optional[torch.Tensor] = None,
        timer=NULL_TIMER,
    ) -> Dict[str, torch.Tensor]:
        """Render ``gaussians`` (see :meth:`prepare`) from [B,V] cameras.

        Returns image [B,V,3,H,W], alpha/depth [B,V,1,H,W], overflow [B].
        ``timer`` receives the "knn", "binning" and "forward_tiles" stages.
        """
        with timer("knn"):
            pos, cov3d, rgb, opacity = self.prepare(gaussians)
        if bg_color is None:
            bg_color = torch.ones(3, dtype=torch.float32, device=pos.device)
        return rasterize(pos, cov3d, rgb, opacity,
                         cam_view.to(torch.float32),
                         cam_view_proj.to(torch.float32), bg_color,
                         self.raster_cfg, timer)

    def render_free(
        self,
        gaussians: Dict[str, torch.Tensor],
        cam_view: torch.Tensor,        # [B,V,4,4]
        cam_view_proj: torch.Tensor,   # [B,V,4,4]
        bg_color: Optional[torch.Tensor] = None,
        timer=NULL_TIMER,
    ) -> Dict[str, torch.Tensor]:
        """Render free Gaussians: position [B,N,3], opacity [B,N], absolute
        scale [B,N,3], unit quaternion ``rotation`` [B,N,4], rgb [B,N,3].
        Differentiable in all five; returns what :meth:`render` does."""
        f32 = torch.float32
        pos = gaussians["position"].to(f32)
        if bg_color is None:
            bg_color = torch.ones(3, dtype=f32, device=pos.device)
        cov3d = RenderHead.covariances(
            {k: gaussians[k].to(f32) for k in ("scale", "rotation")})
        return rasterize(pos, cov3d, gaussians["rgb"].to(f32),
                         gaussians["opacity"].to(f32), cam_view.to(f32),
                         cam_view_proj.to(f32), bg_color, self.raster_cfg,
                         timer)
