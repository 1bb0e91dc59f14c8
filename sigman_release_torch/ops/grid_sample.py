"""Bilinear / trilinear grid sampling with border padding.

Port of the JAX package's ``ops/grid_sample.py``: explicit gathers + lerps
with ``F.grid_sample``'s coordinate conventions, in the JAX package's layout
(``inp [C, ...]``, ``grid [..., 2|3]`` -> ``[C, ...]``):

* 2D bilinear, ``align_corners=False`` — per-Gaussian attributes from the
  UV attribute map,
* 3D trilinear, ``align_corners=True`` — the LBS weight voxel.
"""

from __future__ import annotations

import torch


def _unnormalize(coord, size, align_corners):
    """[-1,1] -> pixel coordinates (float)."""
    if align_corners:
        return (coord + 1.0) * 0.5 * (size - 1)
    return ((coord + 1.0) * size - 1.0) * 0.5


def _corners(coord, size):
    """Border-clamped coordinate -> (lower index, upper index, weight). The
    indices are clamped again as integers: a NaN coordinate (a diverged
    Broyden row) gives a NaN weight and in-range indices, as the JAX
    package's clamped gathers do."""
    c = torch.clamp(coord, 0.0, size - 1.0)
    c0 = torch.clamp(torch.floor(c), 0, size - 1)
    c1 = torch.clamp(c0 + 1, 0, size - 1)
    return (c0.long().clamp(0, size - 1), c1.long().clamp(0, size - 1),
            c - c0)


def grid_sample_2d(inp: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = False) -> torch.Tensor:
    """inp [C,H,W], grid [..., 2] (x,y in [-1,1]) -> [C, ...]; border padding."""
    C, H, W = inp.shape
    gshape = grid.shape[:-1]
    g = grid.reshape(-1, 2)
    x0, x1, wx = _corners(_unnormalize(g[:, 0], W, align_corners), W)
    y0, y1, wy = _corners(_unnormalize(g[:, 1], H, align_corners), H)
    v = (inp[:, y0, x0] * (1 - wx) * (1 - wy)
         + inp[:, y0, x1] * wx * (1 - wy)
         + inp[:, y1, x0] * (1 - wx) * wy
         + inp[:, y1, x1] * wx * wy)
    return v.reshape((C,) + tuple(gshape))


def grid_sample_3d(inp: torch.Tensor, grid: torch.Tensor,
                   align_corners: bool = True) -> torch.Tensor:
    """inp [C,D,H,W], grid [..., 3] (x,y,z in [-1,1] indexing W,H,D) -> [C, ...]."""
    C, D, H, W = inp.shape
    gshape = grid.shape[:-1]
    g = grid.reshape(-1, 3)
    x0, x1, wx = _corners(_unnormalize(g[:, 0], W, align_corners), W)
    y0, y1, wy = _corners(_unnormalize(g[:, 1], H, align_corners), H)
    z0, z1, wz = _corners(_unnormalize(g[:, 2], D, align_corners), D)
    v = (
        inp[:, z0, y0, x0] * (1 - wx) * (1 - wy) * (1 - wz)
        + inp[:, z0, y0, x1] * wx * (1 - wy) * (1 - wz)
        + inp[:, z0, y1, x0] * (1 - wx) * wy * (1 - wz)
        + inp[:, z0, y1, x1] * wx * wy * (1 - wz)
        + inp[:, z1, y0, x0] * (1 - wx) * (1 - wy) * wz
        + inp[:, z1, y0, x1] * wx * (1 - wy) * wz
        + inp[:, z1, y1, x0] * (1 - wx) * wy * wz
        + inp[:, z1, y1, x1] * wx * wy * wz
    )
    return v.reshape((C,) + tuple(gshape))
