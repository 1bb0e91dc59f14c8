# Frozen copy of sigman_release_torch/ops/rasterizer/preprocess.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
"""Gaussian projection / EWA 2D covariance — the per-view preprocessing stage.

Port of the JAX package's ``ops/rasterizer/preprocess.py``. Conventions (see
geometry/cameras.py): row vectors, ``cam_view = w2c.T``, ``cam_view_proj =
w2c.T @ P.T``, view z positive in front of the camera. Cameras may carry a
leading view axis ([V,4,4]); every output then carries it too ([V,N,...]).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def build_cov3d(scale: torch.Tensor, rot: torch.Tensor) -> torch.Tensor:
    """Packed upper-triangular 3D covariance from scales and rotations.

    scale [...,3], rot [...,3,3] -> [...,6] packed (xx, xy, xz, yy, yz, zz),
    Sigma = R diag(s^2) R^T.
    """
    m = rot * (scale[..., None, :] ** 2)         # R @ diag(s^2)
    sigma = m @ rot.transpose(-1, -2)
    return torch.stack(
        [sigma[..., 0, 0], sigma[..., 0, 1], sigma[..., 0, 2],
         sigma[..., 1, 1], sigma[..., 1, 2], sigma[..., 2, 2]],
        dim=-1,
    )


class ProjectedGaussians(NamedTuple):
    mean2d: torch.Tensor   # [...,N,2] pixel coords
    depth: torch.Tensor    # [...,N] view-space z
    conic: torch.Tensor    # [...,N,3] inverse 2D covariance (a, b, c)
    radius: torch.Tensor   # [...,N] screen-space extent (pixels, float)
    valid: torch.Tensor    # [...,N] bool — in frustum and non-degenerate


def project_gaussians(
    means3d: torch.Tensor,        # [N,3]
    cov3d: torch.Tensor,          # [N,6] packed
    cam_view: torch.Tensor,       # [4,4] or [V,4,4] (w2c.T)
    cam_view_proj: torch.Tensor,  # same leading shape as cam_view
    tan_half_fovx: float,
    tan_half_fovy: float,
    img_h: int,
    img_w: int,
) -> ProjectedGaussians:
    """Project 3D Gaussians to screen space for one camera or a view stack."""
    f = torch.float32
    means3d = means3d.to(f)
    cov3d = cov3d.to(f)
    cam_view = cam_view.to(f)
    cam_view_proj = cam_view_proj.to(f)

    ones = torch.ones_like(means3d[:, :1])
    hom = torch.cat([means3d, ones], dim=-1)                  # [N,4]

    p_view = hom @ cam_view                                   # [...,N,4]
    depth = p_view[..., 2]
    in_front = depth > 0.2                                    # CUDA near cull

    p_hom = hom @ cam_view_proj
    # denominators are sanitized BEFORE the division so culled rows stay
    # finite all the way through (every consumer masks them on `valid`)
    p_w = 1.0 / torch.where(in_front, p_hom[..., 3] + 1e-7, 1.0)
    p_proj = p_hom[..., :3] * p_w[..., None]                  # ndc

    # ndc2Pix: ((ndc + 1) * S - 1) / 2
    mean2d = torch.stack(
        [((p_proj[..., 0] + 1.0) * img_w - 1.0) * 0.5,
         ((p_proj[..., 1] + 1.0) * img_h - 1.0) * 0.5],
        dim=-1,
    )

    focal_x = img_w / (2.0 * tan_half_fovx)
    focal_y = img_h / (2.0 * tan_half_fovy)

    # EWA: clamp view-space x/y to 1.3 * fov cone (as the CUDA preprocess does)
    tz = torch.where(in_front, depth, 1.0)
    limx = 1.3 * tan_half_fovx
    limy = 1.3 * tan_half_fovy
    tx = torch.clamp(p_view[..., 0] / tz, -limx, limx) * tz
    ty = torch.clamp(p_view[..., 1] / tz, -limy, limy) * tz

    # J = d(pix)/d(view): 2x3 Jacobian of the perspective projection
    j00 = focal_x / tz
    j02 = -focal_x * tx / (tz * tz)
    j11 = focal_y / tz
    j12 = -focal_y * ty / (tz * tz)

    # w2c rotation W = cam_view[:3,:3]^T, one [..., 1] column per entry so it
    # broadcasts against the [..., N] per-gaussian rows
    Wt = cam_view[..., :3, :3]

    def W(i, k):
        return Wt[..., k, i][..., None]

    # V = W Sigma W^T ; then cov2d = J V J^T (2x2), struct-of-arrays form
    s = [cov3d[:, i] for i in range(6)]     # xx, xy, xz, yy, yz, zz
    sig_rows = ((s[0], s[1], s[2]), (s[1], s[3], s[4]), (s[2], s[4], s[5]))

    def wsig(i, k):                          # (W Sigma)[i,k]
        return (W(i, 0) * sig_rows[0][k] + W(i, 1) * sig_rows[1][k]
                + W(i, 2) * sig_rows[2][k])

    def vcomp(i, l):                         # (W Sigma W^T)[i,l]
        return wsig(i, 0) * W(l, 0) + wsig(i, 1) * W(l, 1) + wsig(i, 2) * W(l, 2)

    v00 = vcomp(0, 0)
    v01 = vcomp(0, 1)
    v02 = vcomp(0, 2)
    v11 = vcomp(1, 1)
    v12 = vcomp(1, 2)
    v22 = vcomp(2, 2)
    c00 = j00 * j00 * v00 + 2 * j00 * j02 * v02 + j02 * j02 * v22 + 0.3
    c11 = j11 * j11 * v11 + 2 * j11 * j12 * v12 + j12 * j12 * v22 + 0.3
    c01 = j00 * j11 * v01 + j00 * j12 * v02 + j02 * j11 * v12 + j02 * j12 * v22

    det = c00 * c11 - c01 * c01
    det_ok = det > 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det, 1.0), 0.0)
    conic = torch.stack([c11 * inv_det, -c01 * inv_det, c00 * inv_det], dim=-1)

    mid = 0.5 * (c00 + c11)
    lam1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radius = torch.ceil(3.0 * torch.sqrt(lam1))

    valid = in_front & det_ok & (radius > 0)
    radius = torch.where(valid, radius, 0.0)
    return ProjectedGaussians(mean2d, depth, conic, radius, valid)
