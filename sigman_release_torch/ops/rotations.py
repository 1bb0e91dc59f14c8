"""Rotation utilities (port of the JAX package's ``ops/rotations.py``)."""

from __future__ import annotations

import torch


def rodrigues(rot_vecs: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Axis-angle [..., 3] -> rotation matrices [..., 3, 3]."""
    angle = torch.linalg.norm(rot_vecs + eps, dim=-1, keepdim=True)  # [...,1]
    axis = rot_vecs / angle
    c = torch.cos(angle)[..., None]
    s = torch.sin(angle)[..., None]
    rx, ry, rz = axis[..., 0], axis[..., 1], axis[..., 2]
    zeros = torch.zeros_like(rx)
    K = torch.stack(
        [zeros, -rz, ry, rz, zeros, -rx, -ry, rx, zeros], dim=-1
    ).reshape(rot_vecs.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=rot_vecs.dtype, device=rot_vecs.device)
    return eye + s * K + (1 - c) * (K @ K)


def quaternion_to_matrix(quat: torch.Tensor,
                         normalize: bool = True) -> torch.Tensor:
    """Quaternions [..., 4] (w, x, y, z) -> rotation matrices [..., 3, 3]."""
    if normalize:
        quat = quat / torch.clamp(torch.linalg.norm(quat, dim=-1,
                                                    keepdim=True), min=1e-12)
    w, x, y, z = quat.unbind(-1)
    m = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1)
    return m.reshape(quat.shape[:-1] + (3, 3))
