"""SMPL-X body model as tensors + functions (port of
the JAX package's ``body/smplx.py``).

* ``SMPLXModel`` holds the model constants (template, blend shapes,
  regressor, skinning weights, PCA hand components, hand means).
* ``load_smplx_npz`` reads the standard SMPL-X release npz layout (licensed,
  user-provided).
* ``synthetic_body_model`` builds a procedural model with the exact SMPL-X
  structure (55 joints, PCA-12 hands, 486 pose dirs) from a numpy RNG; the
  recipe and draw order are the JAX package's, so one seed gives identical
  arrays in both packages.
* ``smplx_forward`` composes PCA hands, the 165-d full pose + hand mean, the
  concatenated shape+expression coefficients and ``transl``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from sigman_release_torch.body.lbs import LBSOutput, lbs

NUM_JOINTS = 55
NUM_BODY_JOINTS = 21

# SMPL-X kinematic tree (kintree_table of the public model):
# 0 pelvis .. 21 R_wrist, 22 jaw, 23/24 eyes, 25-39 left fingers,
# 40-54 right fingers.
SMPLX_PARENTS = np.array(
    [-1, 0, 0, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 12, 13, 14, 16, 17,
     18, 19, 15, 15, 15,
     20, 25, 26, 20, 28, 29, 20, 31, 32, 20, 34, 35, 20, 37, 38,
     21, 40, 41, 21, 43, 44, 21, 46, 47, 21, 49, 50, 21, 52, 53],
    dtype=np.int32,
)

# curled-hand PCA mean used for the canonical pose
HAND_PCA_CANO = np.array(
    [1.4624, -0.1615, 0.1361, 1.3851, -0.2597, 0.0247, -0.0683, -0.4478,
     -0.6652, -0.7290, 0.0084, -0.4818],
    dtype=np.float32,
)


class SMPLXModel(NamedTuple):
    v_template: torch.Tensor       # [V,3]
    shapedirs: torch.Tensor        # [V,3,n_betas]
    expr_dirs: torch.Tensor        # [V,3,n_expr]
    posedirs: torch.Tensor         # [(J-1)*9, V*3]
    J_regressor: torch.Tensor      # [J,V]
    lbs_weights: torch.Tensor      # [V,J]
    parents: np.ndarray            # [J] static
    faces: np.ndarray              # [F,3] static int
    hand_components_l: torch.Tensor  # [n_pca,45]
    hand_components_r: torch.Tensor  # [n_pca,45]
    hand_mean_l: torch.Tensor      # [45]
    hand_mean_r: torch.Tensor      # [45]

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]

    def to(self, device) -> "SMPLXModel":
        return self._replace(**{
            k: v.to(device) for k, v in self._asdict().items()
            if isinstance(v, torch.Tensor)})


class SMPLXParams(NamedTuple):
    """Batched pose/shape parameters; hand poses may be PCA or full 45-d."""

    betas: torch.Tensor            # [B,10]
    expression: torch.Tensor       # [B,10]
    global_orient: torch.Tensor    # [B,3]
    body_pose: torch.Tensor        # [B,63]
    jaw_pose: torch.Tensor         # [B,3]
    leye_pose: torch.Tensor        # [B,3]
    reye_pose: torch.Tensor        # [B,3]
    left_hand_pose: torch.Tensor   # [B,12] (PCA) or [B,45]
    right_hand_pose: torch.Tensor  # [B,12] or [B,45]
    transl: torch.Tensor           # [B,3]
    scale: torch.Tensor            # [B,1]


def _f32(x, device):
    return torch.as_tensor(np.asarray(x, np.float32), device=device)


def load_smplx_npz(path: str, device=None) -> SMPLXModel:
    """Load the standard SMPL-X npz release (first 10 betas, 10 expressions)."""
    d = np.load(path, allow_pickle=True)
    shapedirs_all = np.asarray(d["shapedirs"], np.float32)
    # SMPL-X packs [300 shape | 100 expression] (older releases: 10|10)
    n_shape = 10
    shape = shapedirs_all[..., :n_shape]
    if shapedirs_all.shape[-1] >= 310:
        expr = shapedirs_all[..., 300:310]
    else:
        expr = shapedirs_all[..., n_shape:n_shape + 10]
    posedirs = np.asarray(d["posedirs"], np.float32)
    V = posedirs.shape[0]
    posedirs = posedirs.reshape(V * 3, -1).T                   # [(J-1)*9, V*3]
    parents = np.asarray(d["kintree_table"], np.int64)[0].astype(np.int32)
    parents[0] = -1
    return SMPLXModel(
        v_template=_f32(d["v_template"], device),
        shapedirs=_f32(shape, device),
        expr_dirs=_f32(expr, device),
        posedirs=_f32(posedirs, device),
        J_regressor=_f32(d["J_regressor"], device),
        lbs_weights=_f32(d["weights"], device),
        parents=parents,
        faces=np.asarray(d["f"], np.int64),
        hand_components_l=_f32(d["hands_componentsl"][:12], device),
        hand_components_r=_f32(d["hands_componentsr"][:12], device),
        hand_mean_l=_f32(d["hands_meanl"], device),
        hand_mean_r=_f32(d["hands_meanr"], device),
    )


def save_smplx_npz(model: SMPLXModel, path: str) -> None:
    """Write ``model`` in the SMPL-X release's npz layout (``load_smplx_npz``
    reads it back): shapedirs [V,3,10 shape | 10 expression], posedirs
    [V,3,(J-1)*9], kintree_table [2,J], 12 PCA hand components a side."""
    V = model.v_template.shape[0]

    def host(t):
        return t.detach().cpu().numpy()

    kintree = np.stack([np.asarray(model.parents, np.int64),
                        np.arange(len(model.parents))])
    np.savez(
        path,
        v_template=host(model.v_template),
        shapedirs=np.concatenate([host(model.shapedirs),
                                  host(model.expr_dirs)], axis=-1),
        posedirs=host(model.posedirs).T.reshape(V, 3, -1),
        J_regressor=host(model.J_regressor),
        weights=host(model.lbs_weights),
        kintree_table=kintree,
        f=np.asarray(model.faces, np.int64),
        hands_componentsl=host(model.hand_components_l),
        hands_componentsr=host(model.hand_components_r),
        hands_meanl=host(model.hand_mean_l),
        hands_meanr=host(model.hand_mean_r),
    )


def synthetic_body_model(n_verts: int = 1024, seed: int = 0,
                         device=None) -> SMPLXModel:
    """Procedural SMPL-X-shaped model (see module docstring)."""
    rng = np.random.default_rng(seed)
    J = NUM_JOINTS

    # rest joints: a rough humanoid skeleton — wide in x/y, thin in z
    joints = np.zeros((J, 3), np.float32)
    for j in range(1, J):
        p = SMPLX_PARENTS[j]
        direction = rng.normal(0, 1, 3)
        direction[1] -= 0.5   # bias limbs downward
        direction[2] *= 0.2   # keep the body flat in z
        direction /= np.linalg.norm(direction) + 1e-6
        joints[j] = joints[p] + direction * rng.uniform(0.05, 0.15)
    joints[:, 2] *= 0.25

    # vertices sampled around the bone segments
    seg = rng.integers(1, J, n_verts)
    t = rng.uniform(0, 1, (n_verts, 1)).astype(np.float32)
    base = joints[SMPLX_PARENTS[seg]] * (1 - t) + joints[seg] * t
    verts = (base + rng.normal(0, 0.015, (n_verts, 3))).astype(np.float32)

    # skinning weights: sharp softmax over joint distance, truncated to the
    # 4 nearest joints (real SMPL-X weights are near-sparse)
    d2 = ((verts[:, None, :] - joints[None]) ** 2).sum(-1)
    w = np.exp(-d2 / 0.002)
    top4 = np.argsort(-w, axis=1)[:, :4]
    mask = np.zeros_like(w)
    np.put_along_axis(mask, top4, 1.0, axis=1)
    w = w * mask
    w = (w / w.sum(-1, keepdims=True)).astype(np.float32)

    # J_regressor recovering rest joints approximately: nearest-vertex average
    reg = np.zeros((J, n_verts), np.float32)
    nearest = np.argsort(d2, axis=0)[:8]                      # [8,J]
    for j in range(J):
        reg[j, nearest[:, j]] = 1.0 / 8

    faces = np.stack(
        [np.arange(n_verts - 2), np.arange(1, n_verts - 1),
         np.arange(2, n_verts)], axis=-1,
    ).astype(np.int64)

    return SMPLXModel(
        v_template=_f32(verts, device),
        shapedirs=_f32(rng.normal(0, 0.01, (n_verts, 3, 10)), device),
        expr_dirs=_f32(rng.normal(0, 0.002, (n_verts, 3, 10)), device),
        posedirs=_f32(rng.normal(0, 0.001, ((J - 1) * 9, n_verts * 3)),
                      device),
        J_regressor=_f32(reg, device),
        lbs_weights=_f32(w, device),
        parents=SMPLX_PARENTS.copy(),
        faces=faces,
        hand_components_l=_f32(rng.normal(0, 0.02, (12, 45)), device),
        hand_components_r=_f32(rng.normal(0, 0.02, (12, 45)), device),
        hand_mean_l=torch.zeros(45, device=device),
        hand_mean_r=torch.zeros(45, device=device),
    )


def smplx_forward(model: SMPLXModel, params: SMPLXParams) -> LBSOutput:
    """Full SMPL-X forward pass returning LBS internals (A, T, offsets)."""
    B = params.betas.shape[0]
    lh, rh = params.left_hand_pose, params.right_hand_pose
    if lh.shape[-1] != 45:                                    # PCA hands
        lh = lh @ model.hand_components_l
        rh = rh @ model.hand_components_r

    full_pose = torch.cat(
        [params.global_orient.reshape(B, 3),
         params.body_pose.reshape(B, NUM_BODY_JOINTS * 3),
         params.jaw_pose.reshape(B, 3),
         params.leye_pose.reshape(B, 3),
         params.reye_pose.reshape(B, 3),
         lh.reshape(B, 45), rh.reshape(B, 45)],
        dim=-1,
    )                                                          # [B,165]
    # pose_mean affects only the hands (flat_hand_mean False)
    pose_mean = torch.cat(
        [full_pose.new_zeros(75), model.hand_mean_l, model.hand_mean_r])
    full_pose = full_pose + pose_mean

    shape_comps = torch.cat([params.betas, params.expression], dim=-1)
    shapedirs = torch.cat([model.shapedirs, model.expr_dirs], dim=-1)

    out = lbs(shape_comps, full_pose, model.v_template, shapedirs,
              model.posedirs, model.J_regressor, model.parents,
              model.lbs_weights)

    # transl shifts verts/joints/A/T; params.scale is deliberately ignored,
    # as in the reference's SMPL-X forward
    transl = params.transl.reshape(B, 1, 3)
    A, T = out.A.clone(), out.T.clone()
    A[..., :3, 3] += transl
    T[..., :3, 3] += transl
    return LBSOutput(out.verts + transl, out.joints + transl, A, T,
                     out.shape_offset, out.pose_offset, out.pose_feature)


def canonical_params(B: int = 1, pca_hands: bool = True,
                     device=None) -> SMPLXParams:
    """Canonical-space pose: T-pose with curled-hand PCA mean, y += 0.35."""
    z = torch.zeros((B, 3), device=device)
    hands = (
        torch.as_tensor(HAND_PCA_CANO, device=device).expand(B, 12)
        if pca_hands else torch.zeros((B, 45), device=device)
    )
    return SMPLXParams(
        betas=torch.zeros((B, 10), device=device),
        expression=torch.zeros((B, 10), device=device),
        global_orient=z,
        body_pose=torch.zeros((B, 63), device=device),
        jaw_pose=z, leye_pose=z, reye_pose=z,
        left_hand_pose=hands, right_hand_pose=hands,
        transl=torch.tensor([0.0, 0.35, 0.0], device=device).expand(B, 3),
        scale=torch.ones((B, 1), device=device),
    )


def parse_param_vector(vec: Optional[torch.Tensor], batch: int = 1,
                       device=None) -> SMPLXParams:
    """Parse the reference's flat smpl_params layouts (120/123/175/179/188-d).

    * ``None`` / 120-d — the canonical pose (curled-hand PCA mean, fixed
      transl); a 120-d vector's (orient, body, betas, jaw, eyes, expr) are
      honoured.
    * 175-d — AMASS order (orient, body, lhand45, rhand45, jaw, eyes, betas);
      transl fixed.
    * 179-d / 188-d — (transl, orient, betas, body, expr, hands45[, jaw,
      eyes]); transl and orient overridden to the fixed values.
    * 123-d — (scale, transl, orient, body, betas, lh12, rh12, jaw, eyes,
      expr), everything kept.
    """
    if vec is None or vec.shape[1] == 120:
        B = batch if vec is None else vec.shape[0]
        dev = device if vec is None else vec.device
        base = canonical_params(B, pca_hands=True, device=dev)
        if vec is None:
            return base
        _s, go, body, betas, _lh, _rh, jaw, le, re, expr = _split(
            vec, [1, 3, 63, 10, 12, 12, 3, 3, 3, 10])
        return base._replace(betas=betas, expression=expr, global_orient=go,
                             body_pose=body, jaw_pose=jaw, leye_pose=le,
                             reye_pose=re)

    B, D = vec.shape
    dev = vec.device
    transl_fixed = torch.tensor([0.0, 0.35, 0.0], device=dev).expand(B, 3)
    ones = torch.ones((B, 1), device=dev)
    z3 = torch.zeros((B, 3), device=dev)

    if D == 175:   # AMASS: orient, body, lhand45, rhand45, jaw, eyes, betas
        go, body, lh, rh, jaw, le, re, betas = _split(
            vec, [3, 63, 45, 45, 3, 3, 3, 10])
        return SMPLXParams(betas, torch.zeros((B, 10), device=dev), go, body,
                           jaw, le, re, lh, rh, transl_fixed, ones)
    if D == 179:
        _t, _go, betas, body, expr, lh, rh = _split(
            vec, [3, 3, 10, 63, 10, 45, 45])
        return SMPLXParams(betas, expr, z3, body, z3, z3, z3, lh, rh,
                           transl_fixed, ones)
    if D == 188:
        _t, _go, betas, body, expr, lh, rh, jaw, le, re = _split(
            vec, [3, 3, 10, 63, 10, 45, 45, 3, 3, 3])
        return SMPLXParams(betas, expr, z3, body, jaw, le, re, lh, rh,
                           transl_fixed, ones)
    if D == 123:
        scale, transl, go, body, betas, lh, rh, jaw, le, re, expr = _split(
            vec, [1, 3, 3, 63, 10, 12, 12, 3, 3, 3, 10])
        return SMPLXParams(betas, expr, go, body, jaw, le, re, lh, rh,
                           transl, scale)
    raise ValueError(f"unknown smpl_params layout with {D} dims")


def _split(vec: torch.Tensor, sizes):
    if sum(sizes) != vec.shape[1]:
        raise ValueError(f"expected {sum(sizes)} dims, got {vec.shape[1]}")
    return list(torch.split(vec, sizes, dim=1))
