"""Fast-SNARF inverse skinning: Broyden root finding in canonical space
(port of the JAX package's ``body/snarf.py``).

* ``precompute_voxel`` — blend per-voxel LBS weights with the bone
  transforms into a posed-position voxel ``voxel_d`` and a Jacobian voxel
  ``voxel_J``,
* ``broyden_search`` — for each deformed point x_d and each of the 11
  ``INIT_BONES`` rigid guesses, solve skin(x_c) = x_d by Broyden iterations
  with rank-1 updates of J^-1: a fixed ``MAX_ITERS``-iteration loop over
  [N * I] rows, masked per row, never stopped early (the validity mask
  means what it means in the JAX package),
* ``filter_duplicates`` — drop a converged init that lies within
  ``DUP_EPS`` of a later valid one.

Plain PyTorch on tensors of any device; lookups go through
``ops.grid_sample.grid_sample_3d`` (trilinear, ``align_corners=True``). The
initial inverse Jacobian is an LU inverse (``torch.linalg.inv``), as in the
JAX package.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from sigman_release_torch.ops.grid_sample import grid_sample_3d

# the 11 canonical-init bones of fast-SNARF
INIT_BONES = (0, 1, 2, 4, 5, 12, 15, 16, 17, 18, 19)
MAX_ITERS = 10
CONV_EPS = 1e-5
DIVERGE_DIST = 4.0
DUP_EPS = 1e-4


class SnarfVoxels(NamedTuple):
    voxel_d: torch.Tensor    # [3, D, H, W] blended posed positions
    voxel_J: torch.Tensor    # [9, D, H, W] blended rotation part (row-major)


def precompute_voxel(
    lbs_voxel: torch.Tensor,   # [J, D, H, W] weights
    tfs: torch.Tensor,         # [J, 4, 4] bone transforms
    grid_pts: torch.Tensor,    # [D*H*W, 3] voxel centres (world)
) -> SnarfVoxels:
    """Per-voxel blended transform: d = (sum_j w_j T_j) x, J = sum_j w_j R_j."""
    J, D, H, W = lbs_voxel.shape
    w = lbs_voxel.reshape(J, -1)                           # [J, V]
    T_blend = torch.einsum("jv,jik->vik", w, tfs)          # [V, 4, 4]
    hom = torch.cat([grid_pts, torch.ones_like(grid_pts[:, :1])], dim=-1)
    posed = torch.einsum("vik,vk->vi", T_blend, hom)[:, :3]
    voxel_d = posed.T.reshape(3, D, H, W)
    voxel_J = T_blend[:, :3, :3].reshape(-1, 9).T.reshape(9, D, H, W)
    return SnarfVoxels(voxel_d.contiguous(), voxel_J.contiguous())


def broyden_search(
    x_d: torch.Tensor,         # [N, 3] deformed points
    voxels: SnarfVoxels,
    tfs: torch.Tensor,         # [J, 4, 4] bone transforms
    offset: torch.Tensor,      # [1, 1, 3] voxel normalization offset
    scale: torch.Tensor,       # [] scale
    ratio: float = 4.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve skin(x_c) = x_d from the ``INIT_BONES`` rigid guesses.

    Returns (x_c [N, I, 3], valid [N, I] bool).
    """
    N = x_d.shape[0]
    init_tfs = tfs[list(INIT_BONES)]                       # [I,4,4]
    I = init_tfs.shape[0]
    stretch = x_d.new_tensor([1.0, 1.0, ratio])

    def lookup(xc, jacobian=False):
        p = (xc - offset.reshape(1, 3)) / scale * stretch
        d = grid_sample_3d(voxels.voxel_d, p, align_corners=True).T  # [n,3]
        if not jacobian:
            return d
        Jm = grid_sample_3d(voxels.voxel_J, p, align_corners=True).T
        return d, Jm.reshape(-1, 3, 3)

    # rigid init: x_c = T_b^-1 x_d for each init bone
    R = init_tfs[:, :3, :3]
    t = init_tfs[:, :3, 3]
    xc0 = torch.einsum("iba,nib->nia", R, x_d[:, None] - t[None])  # [N,I,3]
    flat0 = xc0.reshape(N * I, 3)
    target = x_d.repeat_interleave(I, dim=0)               # [N*I,3]

    posed, J0 = lookup(flat0, jacobian=True)
    f = posed - target
    eye = torch.eye(3, dtype=x_d.dtype, device=x_d.device)
    Jinv = torch.linalg.inv(J0 + 1e-6 * eye)
    xc = flat0
    ok = torch.ones(N * I, dtype=torch.bool, device=x_d.device)
    tiny = x_d.new_tensor(1e-12)
    for _ in range(MAX_ITERS):
        dx = -torch.einsum("nab,nb->na", Jinv, f)
        dx = torch.where(ok[:, None], dx, 0.0)
        xc_new = xc + dx
        f_new = lookup(xc_new) - target
        df = f_new - f
        # rank-1 Broyden update of J^-1
        Jdf = torch.einsum("nab,nb->na", Jinv, df)
        denom = torch.sum(dx * Jdf, dim=-1, keepdim=True)
        corr = torch.einsum(
            "na,nb->nab",
            (dx - Jdf) / torch.where(denom.abs() > 1e-12, denom, tiny),
            torch.einsum("na,nab->nb", dx, Jinv))
        Jinv = Jinv + torch.where(ok[:, None, None], corr, 0.0)
        still = torch.linalg.norm(f_new, dim=-1) > CONV_EPS
        xc = torch.where(ok[:, None], xc_new, xc)
        f = torch.where(ok[:, None], f_new, f)
        ok = ok & still

    err = torch.linalg.norm(f, dim=-1)
    dist = torch.linalg.norm(xc - flat0, dim=-1)
    valid = (err < CONV_EPS * 10) & (dist < DIVERGE_DIST)
    return xc.reshape(N, I, 3), valid.reshape(N, I)


def filter_duplicates(x_c: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Keep one solution per cluster: drop init i if a valid init j > i lies
    within ``DUP_EPS``."""
    d = torch.linalg.norm(x_c[:, :, None] - x_c[:, None, :], dim=-1)  # [N,I,I]
    I = x_c.shape[1]
    later = torch.triu(torch.ones((I, I), dtype=torch.bool,
                                  device=x_c.device), diagonal=1)
    dup = (d < DUP_EPS) & later[None] & valid[:, None, :]
    return valid & ~torch.any(dup, dim=-1)


def inverse_skin_points(
    x_d: torch.Tensor,
    lbs_voxel: torch.Tensor,
    tfs: torch.Tensor,
    grid_pts: torch.Tensor,
    offset: torch.Tensor,
    scale: torch.Tensor,
    ratio: float = 4.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Precompute, search, filter. Returns (x_c [N,I,3], valid [N,I])."""
    voxels = precompute_voxel(lbs_voxel, tfs, grid_pts)
    x_c, valid = broyden_search(x_d, voxels, tfs, offset, scale, ratio)
    return x_c, filter_duplicates(x_c, valid)
