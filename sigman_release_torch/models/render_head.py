"""The 14-channel head of free Gaussians (port of the JAX package's
``models/render_head.py``, the reference's ``Render`` module).

Decodes a [B, 14, H, W] feature map into one Gaussian per pixel with the
activations position = clamp(-1, 1), opacity = sigmoid, scale = 0.1 *
softplus, rotation = normalised quaternion, rgb = 0.5 tanh + 0.5. These
Gaussians are free in space (no template): ``covariances`` builds their
covariance from the absolute scale and the quaternion, and
``GaussianRenderer.render_free`` rasterizes them.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from sigman_release_torch.ops.rasterizer.preprocess import build_cov3d
from sigman_release_torch.ops.rotations import quaternion_to_matrix


class RenderHead:
    """Pure functions: no learned parameters."""

    @staticmethod
    def decode(x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x [B,14,H,W] -> per-Gaussian tensors [B,N,*] (N = H W; opacity
        [B,N])."""
        B = x.shape[0]
        x = torch.movedim(x, 1, -1).reshape(B, -1, 14)
        rotation = x[..., 7:11]
        rotation = rotation / torch.clamp(
            torch.linalg.norm(rotation, dim=-1, keepdim=True), min=1e-12)
        return {
            "position": torch.clamp(x[..., 0:3], -1.0, 1.0),
            "opacity": torch.sigmoid(x[..., 3]),
            "scale": 0.1 * F.softplus(x[..., 4:7]),
            "rotation": rotation,
            "rgb": 0.5 * torch.tanh(x[..., 11:14]) + 0.5,
        }

    @staticmethod
    def covariances(gaussians: Dict[str, torch.Tensor]) -> torch.Tensor:
        """[B,N,6] packed covariance from the scale and the (unit)
        quaternion."""
        rots = quaternion_to_matrix(gaussians["rotation"], normalize=False)
        return build_cov3d(gaussians["scale"], rots)
