# Frozen copy of sigman_release_torch/geometry/cameras.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
"""Camera math for the splatting pipeline.

Conventions (matching the reference renderer contract,
the reference's core/dataset/dataloader_VAE.py:207-213 and
the reference's core/gaussians/gs.py:75-106):

* world-to-camera ``w2c`` is OpenCV-style (x right, y down, z forward),
* ``cam_view = w2c.T`` (row-vector convention),
* ``cam_view_proj = w2c.T @ P.T`` so clip = [x y z 1] @ cam_view_proj,
* the projection matrix ``P`` maps view z to [0, zfar/(zfar-znear)] with
  w = +z (z_sign = +1), i.e. the graphdeco-3DGS projection.

All functions are numpy pure functions over arrays (an own copy of
the JAX package's ``geometry/cameras.py``).
"""

from __future__ import annotations

import math

import numpy as np


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float) -> np.ndarray:
    """Perspective projection (4x4, column-vector form) from fov angles."""
    tan_y = math.tan(fovy / 2)
    tan_x = math.tan(fovx / 2)
    top, right = tan_y * znear, tan_x * znear
    bottom, left = -top, -right
    return _frustum(znear, zfar, left, right, bottom, top)


def intrinsics_projection_matrix(
    znear: float, zfar: float, K: np.ndarray, img_h: int, img_w: int
) -> np.ndarray:
    """Projection from pinhole intrinsics (possibly off-center principal point).

    Mirrors the K-branch of the reference's getProjectionMatrix
    (the reference's core/dataset/dataloader_VAE.py:218-246).
    """
    near_fx = znear / K[0, 0]
    near_fy = znear / K[1, 1]
    left = -(img_w - K[0, 2]) * near_fx
    right = K[0, 2] * near_fx
    bottom = (K[1, 2] - img_h) * near_fy
    top = K[1, 2] * near_fy
    return _frustum(znear, zfar, left, right, bottom, top)


def _frustum(znear, zfar, left, right, bottom, top) -> np.ndarray:
    P = np.zeros((4, 4), dtype=np.float64)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def look_at(campos: np.ndarray, target: np.ndarray, up=(0.0, 1.0, 0.0)) -> np.ndarray:
    """c2w matrix (OpenCV convention: z points at target, y down)."""
    campos = np.asarray(campos, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    fwd = target - campos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.asarray(up, dtype=np.float64)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    c2w = np.eye(4)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = fwd
    c2w[:3, 3] = campos
    return c2w


def orbit_camera(elevation_deg: float, azimuth_deg: float, radius: float,
                 target=(0.0, 0.0, 0.0)) -> np.ndarray:
    """c2w for a camera orbiting ``target`` at ``radius`` (OpenCV convention)."""
    el = math.radians(elevation_deg)
    az = math.radians(azimuth_deg)
    target = np.asarray(target, dtype=np.float64)
    campos = target + radius * np.array(
        [math.cos(el) * math.sin(az), math.sin(el), math.cos(el) * math.cos(az)]
    )
    return look_at(campos, target)


def camera_bundle(c2w_stack: np.ndarray, proj: np.ndarray, dtype=np.float32):
    """Pack V c2w matrices into the renderer's (cam_view, cam_view_proj, cam_pos).

    Returns float32 arrays shaped [V,4,4], [V,4,4], [V,3].
    """
    c2w = np.asarray(c2w_stack, dtype=np.float64)
    w2c = np.linalg.inv(c2w)
    cam_view = np.transpose(w2c, (0, 2, 1))
    cam_view_proj = cam_view @ proj.T
    cam_pos = c2w[:, :3, 3]
    return (cam_view.astype(dtype), cam_view_proj.astype(dtype), cam_pos.astype(dtype))
