# Frozen copy of sigman_release_torch/body/template.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
"""Template assets: per-Gaussian anchors on the (subdivided) body mesh
(port of the JAX package's ``body/template.py``).

``init_uv`` (face-centre UV), ``init_pcd`` (face-centre canonical positions),
``init_rot`` (per-face TBN frames), ``init_faces``, ``init_lbsw``,
``init_spdir``/``init_podir`` (per-vertex blend-shape dirs of the subdivided
mesh) and optional region masks. ``load_template_dir`` reads the reference's
baked ``template/*.npy`` layout; ``synthetic_template`` derives a
structurally identical set from any ``SMPLXModel``.
"""

from __future__ import annotations

from pathlib import Path
from typing import NamedTuple, Optional

import numpy as np
import torch

from portbench.reference.body.smplx import (
    SMPLXModel,
    canonical_params,
    smplx_forward,
)


class TemplateAssets(NamedTuple):
    init_uv: torch.Tensor        # [N,2] face-centre UV in [0,1]
    init_pcd: torch.Tensor       # [N,3] face-centre canonical positions
    init_rot: torch.Tensor       # [N,3,3] per-face TBN frames
    init_faces: np.ndarray       # [N,3] subdivided-mesh vertex ids (static)
    init_lbsw: torch.Tensor      # [N,J] per-face-centre skinning weights
    init_spdir: torch.Tensor     # [V,3,20] per-vertex shape(+expr) dirs
    init_podir: torch.Tensor     # [486, V*3] per-vertex pose dirs
    face_mask: Optional[np.ndarray] = None   # [N] bool (face region)
    hands_mask: Optional[np.ndarray] = None  # [N] bool
    outside_mask: Optional[np.ndarray] = None  # [N] bool

    @property
    def num_gaussians(self) -> int:
        return self.init_pcd.shape[0]

    def to(self, device) -> "TemplateAssets":
        return self._replace(**{
            k: v.to(device) for k, v in self._asdict().items()
            if isinstance(v, torch.Tensor)})

    def weight_mask(self) -> Optional[np.ndarray]:
        """Points whose voxel skinning weights the template overrides."""
        masks = [m for m in (self.face_mask, self.hands_mask,
                             self.outside_mask) if m is not None]
        if self.face_mask is None or not masks:
            return None
        return np.logical_or.reduce([m.astype(bool) for m in masks])


def load_template_dir(path: str, suffix: str = "smplx_thu",
                      device=None) -> TemplateAssets:
    """Load the reference's baked template layout (``init_*_{suffix}.npy``)."""
    p = Path(path)

    def arr(name):
        return np.load(p / f"{name}_{suffix}.npy")

    def f32(name):
        return torch.as_tensor(np.asarray(arr(name), np.float32), device=device)

    def opt_mask(name):
        f = p / f"{name}_mask_thu.npy"
        return np.load(f).astype(bool) if f.exists() else None

    return TemplateAssets(
        init_uv=f32("init_uv"),
        init_pcd=f32("init_pcd"),
        init_rot=f32("init_rot"),
        init_faces=np.asarray(arr("init_faces"), np.int64),
        init_lbsw=f32("init_lbsw"),
        init_spdir=f32("init_spdir"),
        init_podir=f32("init_podir"),
        face_mask=opt_mask("face"),
        hands_mask=opt_mask("hands"),
        outside_mask=opt_mask("outside"),
    )


def compute_tbn(verts: np.ndarray, faces: np.ndarray, uv: np.ndarray):
    """Per-face tangent/bitangent/normal frames [F,3,3] (columns T,B,N)."""
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    uv0, uv1, uv2 = (uv[faces[:, i]] for i in range(3))
    e1, e2 = v1 - v0, v2 - v0
    duv1, duv2 = uv1 - uv0, uv2 - uv0
    det = duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0]
    det = np.where(np.abs(det) < 1e-12, 1e-12, det)
    r = 1.0 / det
    tangent = (e1 * duv2[:, 1:2] - e2 * duv1[:, 1:2]) * r[:, None]
    normal = np.cross(e1, e2)

    def norm(x):
        return x / (np.linalg.norm(x, axis=-1, keepdims=True) + 1e-12)

    normal = norm(normal)
    tangent = norm(tangent - normal * (tangent * normal).sum(-1, keepdims=True))
    bitangent = np.cross(normal, tangent)
    return np.stack([tangent, bitangent, normal], axis=-1)


def synthetic_template(model: SMPLXModel) -> TemplateAssets:
    """Bake a template from a body model's canonical pose, on the model's
    device.

    Gaussians anchor at face centres; UVs come from a cylindrical projection
    of the canonical positions (a stand-in for the SMPL-X UV atlas).
    """
    device = model.v_template.device
    out = smplx_forward(model, canonical_params(1, device=device))
    verts = out.verts[0].cpu().numpy()
    faces = np.asarray(model.faces)

    centers = verts[faces].mean(axis=1)

    # cylindrical UV around the vertical axis
    rel = centers - centers.mean(0)
    u = (np.arctan2(rel[:, 0], rel[:, 2]) / (2 * np.pi) + 0.5)
    span = np.ptp(rel[:, 1]) + 1e-6
    v = (rel[:, 1] - rel[:, 1].min()) / span
    uv_faces = np.stack([u, v], axis=-1).astype(np.float32)

    vert_uv = np.zeros((verts.shape[0], 2), np.float32)
    counts = np.zeros(verts.shape[0], np.float32)
    for i in range(3):
        np.add.at(vert_uv, faces[:, i], uv_faces)
        np.add.at(counts, faces[:, i], 1.0)
    vert_uv /= np.maximum(counts[:, None], 1.0)

    rot = compute_tbn(verts, faces, vert_uv)
    face_lbsw = model.lbs_weights.cpu().numpy()[faces].mean(axis=1)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return TemplateAssets(
        init_uv=f32(uv_faces),
        init_pcd=f32(centers),
        init_rot=f32(rot),
        init_faces=faces.astype(np.int64),
        init_lbsw=f32(face_lbsw),
        init_spdir=torch.cat([model.shapedirs, model.expr_dirs], dim=-1),
        init_podir=model.posedirs,
    )
