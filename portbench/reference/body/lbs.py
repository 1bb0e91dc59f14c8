# Frozen copy of sigman_release_torch/body/lbs.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
"""Linear blend skinning (port of the JAX package's ``body/lbs.py``).

Returns the LBS internals the deformer consumes: per-bone relative
transforms A, per-vertex transforms T, shape/pose offsets and the flattened
pose feature. The kinematic chain is a Python loop over the static
``parents`` array (55 joints of batched 4x4 products).
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from portbench.reference.ops.rotations import rodrigues


class LBSOutput(NamedTuple):
    verts: torch.Tensor          # [B,V,3]
    joints: torch.Tensor         # [B,J,3] posed joints
    A: torch.Tensor              # [B,J,4,4] relative bone transforms
    T: torch.Tensor              # [B,V,4,4] per-vertex skinning transforms
    shape_offset: torch.Tensor   # [B,V,3]
    pose_offset: torch.Tensor    # [B,V,3]
    pose_feature: torch.Tensor   # [B,(J-1)*9]


def blend_shapes(betas: torch.Tensor, shape_dirs: torch.Tensor) -> torch.Tensor:
    """betas [B,S], shape_dirs [V,3,S] -> [B,V,3]."""
    return torch.einsum("bs,vcs->bvc", betas, shape_dirs)


def vertices2joints(J_regressor: torch.Tensor, verts: torch.Tensor) -> torch.Tensor:
    """J_regressor [J,V], verts [B,V,3] -> [B,J,3]."""
    return torch.einsum("jv,bvc->bjc", J_regressor, verts)


def batch_rigid_transform(
    rot_mats: torch.Tensor,       # [B,J,3,3]
    joints: torch.Tensor,         # [B,J,3] rest joints
    parents: Sequence[int],       # static kinematic tree, parents[0] == -1
):
    """Forward kinematics. Returns (posed_joints [B,J,3], A [B,J,4,4])."""
    parents = np.asarray(parents)
    B, J = joints.shape[:2]
    rel = torch.cat([joints[:, :1], joints[:, 1:] - joints[:, parents[1:]]],
                    dim=1)

    top = torch.cat([rot_mats, rel[..., None]], dim=-1)           # [B,J,3,4]
    bottom = rot_mats.new_tensor([0.0, 0.0, 0.0, 1.0]).expand(B, J, 1, 4)
    local = torch.cat([top, bottom], dim=-2)                       # [B,J,4,4]

    chain = [local[:, 0]]
    for j in range(1, J):
        chain.append(chain[parents[j]] @ local[:, j])
    world = torch.stack(chain, dim=1)                              # [B,J,4,4]
    posed_joints = world[:, :, :3, 3]

    # A = world minus the rest-joint offset column (relative transforms)
    jh = torch.cat([joints, torch.zeros_like(joints[..., :1])], dim=-1)
    shift = torch.einsum("bjik,bjk->bji", world, jh)               # [B,J,4]
    A = torch.cat([world[..., :3], (world[..., 3] - shift)[..., None]], dim=-1)
    return posed_joints, A


def lbs(
    betas: torch.Tensor,          # [B,S]
    pose: torch.Tensor,           # [B,J*3] axis-angle
    v_template: torch.Tensor,     # [V,3]
    shapedirs: torch.Tensor,      # [V,3,S]
    posedirs: torch.Tensor,       # [P,V*3] with P = (J-1)*9
    J_regressor: torch.Tensor,    # [J,V]
    parents: Sequence[int],
    lbs_weights: torch.Tensor,    # [V,J]
) -> LBSOutput:
    B = pose.shape[0]
    J = J_regressor.shape[0]

    shape_offset = blend_shapes(betas, shapedirs)
    v_shaped = v_template[None] + shape_offset
    joints = vertices2joints(J_regressor, v_shaped)

    rot_mats = rodrigues(pose.reshape(B, J, 3))                    # [B,J,3,3]
    ident = torch.eye(3, dtype=pose.dtype, device=pose.device)
    pose_feature = (rot_mats[:, 1:] - ident).reshape(B, -1)        # [B,(J-1)*9]
    pose_offset = (pose_feature @ posedirs).reshape(B, -1, 3)

    v_posed = v_shaped + pose_offset
    posed_joints, A = batch_rigid_transform(rot_mats, joints, parents)

    T = torch.einsum("vj,bjik->bvik", lbs_weights, A)              # [B,V,4,4]
    vh = torch.cat([v_posed, torch.ones_like(v_posed[..., :1])], dim=-1)
    verts = torch.einsum("bvik,bvk->bvi", T, vh)[..., :3]
    return LBSOutput(verts, posed_joints, A, T, shape_offset, pose_offset,
                     pose_feature)


def skinning(
    pts: torch.Tensor,        # [B,N,3]
    weights: torch.Tensor,    # [B,N,J]
    tfs: torch.Tensor,        # [B,J,4,4]
):
    """Weighted-transform skinning. Returns (posed [B,N,3], w_tf [B,N,4,4])."""
    w_tf = torch.einsum("bnj,bjik->bnik", weights, tfs)
    ph = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)
    posed = torch.einsum("bnik,bnk->bni", w_tf, ph)[..., :3]
    return posed, w_tf


def rigid_inverse(T: torch.Tensor) -> torch.Tensor:
    """Inverse of rigid 4x4 transforms [...,4,4]."""
    R_inv = T[..., :3, :3].transpose(-1, -2)
    t_inv = -torch.einsum("...ik,...k->...i", R_inv, T[..., :3, 3])
    out = torch.zeros_like(T)
    out[..., :3, :3] = R_inv
    out[..., :3, 3] = t_inv
    out[..., 3, 3] = 1.0
    return out
