"""SMPL-family body models: SMPL / SMPL-H / MANO / FLAME (port of the JAX
package's ``body/family.py``).

One loader and one forward cover the family: the LBS math (``body/lbs.py``)
does not depend on the joint count, so SMPL (24 joints), SMPL-H (52), MANO
(16) and FLAME (5) differ only in their asset shapes. The SMPL-X production
path (PCA hands, expressions, pose mean) stays in ``body/smplx.py``.
"""

from __future__ import annotations

import pickle
from typing import NamedTuple, Optional

import numpy as np
import torch

from sigman_release_torch.body.lbs import LBSOutput, lbs


class BodyModel(NamedTuple):
    """Minimal LBS body: any SMPL-family member fits this shape."""

    v_template: torch.Tensor    # [V,3]
    shapedirs: torch.Tensor     # [V,3,S]
    posedirs: torch.Tensor      # [(J-1)*9, V*3]
    J_regressor: torch.Tensor   # [J,V]
    lbs_weights: torch.Tensor   # [V,J]
    parents: np.ndarray         # [J] static
    faces: np.ndarray           # [F,3] static

    @property
    def num_joints(self) -> int:
        return self.J_regressor.shape[0]

    @property
    def num_verts(self) -> int:
        return self.v_template.shape[0]


def _to_array(v):
    # a chumpy array (some .pkl releases) exposes its values as ``.r``
    if hasattr(v, "r"):
        v = v.r
    return np.asarray(v)


def load_body_npz(path: str, num_betas: int = 10, device=None) -> BodyModel:
    """Load any SMPL-family asset (.npz, or .pkl of plain arrays).

    The key layout is shared across the SMPL / SMPL-H / MANO / FLAME
    releases: v_template, shapedirs, posedirs, J_regressor, weights,
    kintree_table, f. A ``.pkl`` may hold posedirs as [V,3,P] and a
    scipy-sparse J_regressor; a chumpy-pickled release needs the chumpy
    package to unpickle.
    """
    if path.endswith(".pkl"):
        with open(path, "rb") as f:
            d = pickle.load(f, encoding="latin1")
    else:
        d = dict(np.load(path, allow_pickle=True))
    shapedirs = _to_array(d["shapedirs"]).astype(np.float32)
    # FLAME packs [300 shape | 100 expression]; keep num_betas
    shapedirs = shapedirs[..., :num_betas]
    posedirs = _to_array(d["posedirs"]).astype(np.float32)
    V = posedirs.shape[0]
    if posedirs.ndim == 3:  # [V,3,P] -> [P, V*3]
        posedirs = posedirs.reshape(V * 3, -1).T
    parents = _to_array(d["kintree_table"]).astype(np.int64)[0].astype(
        np.int32)
    parents[0] = -1
    jr = d["J_regressor"]
    # scipy sparse in some releases (np.asarray would wrap it in an object
    # array, so densify it first)
    jr = np.asarray(jr.todense()) if hasattr(jr, "todense") else _to_array(jr)
    faces = _to_array(d.get("f", d.get("faces"))).astype(np.int64)

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return BodyModel(
        v_template=f32(_to_array(d["v_template"])),
        shapedirs=f32(shapedirs),
        posedirs=f32(np.ascontiguousarray(posedirs)),
        J_regressor=f32(jr),
        lbs_weights=f32(_to_array(d["weights"])),
        parents=parents,
        faces=faces,
    )


def body_forward(model: BodyModel, betas: torch.Tensor, pose: torch.Tensor,
                 transl: Optional[torch.Tensor] = None) -> LBSOutput:
    """Pose any family member: betas [B,S], pose [B,J*3] axis-angle (global
    orient = joint 0), optional transl [B,3]."""
    out = lbs(betas, pose, model.v_template, model.shapedirs,
              model.posedirs, model.J_regressor, model.parents,
              model.lbs_weights)
    if transl is not None:
        out = out._replace(verts=out.verts + transl[:, None],
                           joints=out.joints + transl[:, None])
    return out
