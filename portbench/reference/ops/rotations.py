# Frozen copy of sigman_release_torch/ops/rotations.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
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


def matrix_to_quaternion(m: torch.Tensor) -> torch.Tensor:
    """Rotation matrices [..., 3, 3] -> unit quaternions [..., 4] (w, x, y,
    z), the inverse of ``quaternion_to_matrix`` up to the quaternion's sign:
    Shepperd's method without branches. Each candidate is 2 s times the
    quaternion, s = sqrt of its own diagonal term (1 + trace for w,
    1 + m00 - m11 - m22 for x, ...); ``torch.where`` picks the one whose
    term is largest, then it is normalised.

    The JAX package's function puts sqrt(term) where the term itself
    belongs, which is no multiple of the quaternion; it is not the
    reference here."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22
    q0 = torch.stack([1 + tr, m21 - m12, m02 - m20, m10 - m01], -1)
    q1 = torch.stack([m21 - m12, 1 + m00 - m11 - m22, m01 + m10,
                      m02 + m20], -1)
    q2 = torch.stack([m02 - m20, m01 + m10, 1 - m00 + m11 - m22,
                      m12 + m21], -1)
    q3 = torch.stack([m10 - m01, m02 + m20, m12 + m21,
                      1 - m00 - m11 + m22], -1)
    cond0 = (tr > 0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    q = torch.where(cond0, q0,
                    torch.where(cond1, q1, torch.where(cond2, q2, q3)))
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True),
                           min=1e-12)
