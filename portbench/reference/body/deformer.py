# Frozen copy of sigman_release_torch/body/deformer.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
"""LBS Gaussian deformer (port of the JAX package's ``body/deformer.py``).

* ``initialize``: canonical T-pose forward -> inverse bone transforms; a
  55-channel LBS-weight voxel (16 x 64 x 64) baked by 10-NN inverse-distance
  interpolation of the body model's skinning weights (blocked brute-force
  KNN, ops/knn.py),
* ``prepare``: SMPL-X forward of the target pose -> bone transforms A;
  per-vertex shape/pose offsets from the template's spdir/podir,
* ``__call__``: trilinear voxel query for weights (template weights override
  the masked points), un-pose from canonical, strip the canonical pose
  offset, add the target shape+pose offsets, re-skin with A; returns posed
  points and the composite per-point transform ``w_tf @ w_tf_inv`` that
  rotates Gaussian frames.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference.body.lbs import rigid_inverse, skinning
from portbench.reference.body.smplx import (
    SMPLXModel,
    SMPLXParams,
    canonical_params,
    smplx_forward,
)
from portbench.reference.ops.grid_sample import grid_sample_3d
from portbench.reference.ops.knn import knn

GLOBAL_SCALE = 1.2
VOXEL_RES = 64        # (d, h, w) = (res/4, res, res)


class DeformerState(NamedTuple):
    """Pose-independent buffers baked once from the canonical pose."""

    tfs_inv_t: torch.Tensor        # [1,J,4,4] inverse canonical bone transforms
    vs_template: torch.Tensor      # [1,V,3] canonical verts
    pose_offset_cano: torch.Tensor  # [1,N,3] canonical per-face pose offset
    lbs_voxel: torch.Tensor        # [J,D,H,W] weight voxel
    offset: torch.Tensor           # [1,1,3] normalization offset
    scale: torch.Tensor            # [] normalization scale
    ratio: float                   # H/D anisotropy


class PosedState(NamedTuple):
    """Per-batch pose-dependent quantities."""

    tfs_A: torch.Tensor            # [B,J,4,4] bone transforms of the target pose
    shape_offset: torch.Tensor     # [B,M,3] per subdivided-mesh vertex
    pose_offset: torch.Tensor      # [B,M,3]


def _face_average(values: torch.Tensor, faces: torch.Tensor) -> torch.Tensor:
    """Average per-vertex values over each face's 3 vertices.

    values [B,V,3], faces [F,3] -> [B,F,3].
    """
    return (values[:, faces[:, 0]] + values[:, faces[:, 1]]
            + values[:, faces[:, 2]]) / 3.0


class GaussianDeformer:
    """Holds the body model and template tensors; pose state is explicit."""

    def __init__(self, model: SMPLXModel, init_faces: np.ndarray,
                 init_spdir: torch.Tensor, init_podir: torch.Tensor,
                 init_lbsw: torch.Tensor, weight_mask: Optional[np.ndarray]):
        """
        init_faces: [N,3] template face vertex ids (subdivided mesh)
        init_spdir: [M,3,20] per-vertex shape dirs (betas+expr)
        init_podir: [486, M*3] per-vertex pose dirs
        init_lbsw:  [N,J] per-face template skinning weights
        weight_mask: [N] bool — points whose voxel weights are overridden
        """
        self.model = model
        dev = model.v_template.device
        self.init_faces = torch.as_tensor(np.asarray(init_faces), device=dev)
        self.init_spdir = init_spdir
        self.init_podir = init_podir
        self.init_lbsw = init_lbsw
        self.weight_mask = (None if weight_mask is None else
                            torch.as_tensor(np.asarray(weight_mask, bool),
                                            device=dev))

    def initialize(self) -> DeformerState:
        """Bake the pose-independent state."""
        model = self.model
        dev = model.v_template.device
        out = smplx_forward(model, canonical_params(1, pca_hands=True,
                                                    device=dev))
        tfs_inv_t = rigid_inverse(out.A)

        # canonical per-vertex pose offset, averaged to face centres
        pose_off = (out.pose_feature @ self.init_podir).reshape(1, -1, 3)
        pose_off = _face_average(pose_off, self.init_faces)

        d, h, w = VOXEL_RES // 4, VOXEL_RES, VOXEL_RES
        verts = out.verts[0]
        lo = verts.amin(dim=0)
        hi = verts.amax(dim=0)
        offset = ((lo + hi) * 0.5)[None, None]
        scale = (hi - lo).max() / 2.0 * GLOBAL_SCALE
        ratio = h / d

        # voxel centres in world space (normalized z compressed by ratio)
        zs = torch.linspace(-1, 1, d, device=dev)
        ys = torch.linspace(-1, 1, h, device=dev)
        xs = torch.linspace(-1, 1, w, device=dev)
        gz, gy, gx = torch.meshgrid(zs, ys, xs, indexing="ij")
        grid = torch.stack([gx, gy, gz / ratio], dim=-1).reshape(-1, 3)
        denorm = grid * scale + offset[0]

        d2, idx = knn(denorm, verts, k=10)
        dist = torch.clamp(torch.sqrt(d2), 3e-5, 0.1)
        wts = 1.0 / dist
        wts = wts / wts.sum(dim=-1, keepdim=True)
        wv = (wts[..., None] * model.lbs_weights[idx]).sum(dim=1)  # [DHW, J]
        lbs_voxel = wv.T.reshape(-1, d, h, w)                      # [J,D,H,W]

        return DeformerState(
            tfs_inv_t=tfs_inv_t,
            vs_template=out.verts,
            pose_offset_cano=pose_off,
            lbs_voxel=lbs_voxel.contiguous(),
            offset=offset,
            scale=scale,
            ratio=float(ratio),
        )

    def prepare(self, params: SMPLXParams) -> PosedState:
        out = smplx_forward(self.model, params)
        shape_comps = torch.cat([params.betas, params.expression], -1)
        shape_offset = torch.einsum("bl,mkl->bmk", shape_comps,
                                    self.init_spdir)
        pose_offset = (out.pose_feature @ self.init_podir).reshape(
            shape_offset.shape)
        return PosedState(out.A, shape_offset, pose_offset)

    def query_weights(self, state: DeformerState, pts: torch.Tensor):
        """Trilinear LBS-weight lookup. pts [B,N,3] -> [B,N,J]."""
        norm = (pts - state.offset) / state.scale
        norm = norm * norm.new_tensor([1.0, 1.0, state.ratio])
        w = torch.stack([grid_sample_3d(state.lbs_voxel, p, align_corners=True)
                         for p in norm])                           # [B,J,N]
        return w.transpose(1, 2)

    def __call__(self, state: DeformerState, posed: PosedState,
                 pts: torch.Tensor):
        """Canonical -> posed. pts [B,N,3] canonical points (face centres).

        Returns (pts_posed [B,N,3], tfs [B,N,4,4]).
        """
        B = pts.shape[0]
        w = self.query_weights(state, pts)
        if self.weight_mask is not None:
            w = torch.where(self.weight_mask[None, :, None],
                            self.init_lbsw[None], w)

        shape_off = _face_average(posed.shape_offset, self.init_faces)
        pose_off = _face_average(posed.pose_offset, self.init_faces)

        tfs_inv = state.tfs_inv_t.expand((B,) + state.tfs_inv_t.shape[1:])
        # un-pose from the canonical pose, strip its pose offset, apply the
        # target shape/pose offsets, then skin with the target bones
        x_cano, w_tf_inv = skinning(pts, w, tfs_inv)
        x_cano = x_cano - state.pose_offset_cano
        x_shaped = x_cano + shape_off + pose_off
        xd, w_tf = skinning(x_shaped, w, posed.tfs_A)
        return xd, w_tf @ w_tf_inv
