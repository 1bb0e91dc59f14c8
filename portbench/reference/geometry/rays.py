# Frozen copy of sigman_release_torch/geometry/rays.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
"""Pinhole ray generation and the Plucker embedding (port of the JAX
package's ``geometry/rays.py``).

Pixel centres at +0.5, focal = h/2 / tan(fovy/2) with ``fovy`` in radians
(as ``Config`` holds it). ``opengl=True`` looks down -z with y up.
"""

from __future__ import annotations

import math

import torch


def get_rays(c2w: torch.Tensor, h: int, w: int, fovy: float,
             opengl: bool = False):
    """Rays for every pixel. c2w: [4,4]. Returns (rays_o, rays_d): [h,w,3]."""
    dev = c2w.device
    x = torch.arange(w, dtype=torch.float32, device=dev)
    y = torch.arange(h, dtype=torch.float32, device=dev)
    yy, xx = torch.meshgrid(y, x, indexing="ij")
    cx, cy = w * 0.5, h * 0.5
    focal = h * 0.5 / math.tan(0.5 * fovy)
    sign = -1.0 if opengl else 1.0
    dirs = torch.stack([(xx - cx + 0.5) / focal,
                        (yy - cy + 0.5) / focal * sign,
                        torch.full_like(xx, sign)], dim=-1)   # camera space
    rays_d = dirs @ c2w[:3, :3].T
    rays_d = rays_d / torch.clamp(
        torch.linalg.norm(rays_d, dim=-1, keepdim=True), min=1e-20)
    rays_o = torch.broadcast_to(c2w[:3, 3], rays_d.shape)
    return rays_o, rays_d


def plucker_rays(c2w: torch.Tensor, h: int, w: int, fovy: float,
                 opengl: bool = False) -> torch.Tensor:
    """6-channel Plucker embedding [h,w,6] = [o x d, d]."""
    rays_o, rays_d = get_rays(c2w, h, w, fovy, opengl)
    return torch.cat([torch.linalg.cross(rays_o, rays_d), rays_d], dim=-1)
