"""Template extraction: selective mesh subdivision and asset baking (port of
the JAX package's ``body/subdivide.py``).

* ``region_faces`` — face mask from vertex-id region lists (the reference's
  segmentation JSONs),
* ``subdivide`` — one level of 4-way midpoint subdivision restricted to a
  face mask (face / ears / eyes / hands in the reference), carrying
  per-vertex attributes (LBS weights, shape dirs, pose dirs) by midpoint
  averaging,
* ``bake_template`` — face centres, face-centre UV, TBN frames, per-face
  LBS weights and the subdivided-face mask -> ``TemplateAssets``,
* ``save_template_dir`` — the reference's ``init_*_{suffix}.npy`` layout,
  which ``body.template.load_template_dir`` reads.

Everything after the canonical body forward is numpy on the host, in the
JAX package's order of operations: midpoints are numbered in the
lexicographic order of their sorted edges (``np.unique``), the output faces
are the kept faces first, then the 4 children of each split face, and the
cylindrical UVs are summed onto the vertices with ``np.add.at`` in face
order. The template's tensors land on the body model's device.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from sigman_release_torch.body.smplx import (
    SMPLXModel,
    canonical_params,
    smplx_forward,
)
from sigman_release_torch.body.template import TemplateAssets, compute_tbn


def region_faces(faces: np.ndarray, region_verts: Sequence[int]) -> np.ndarray:
    """Faces whose three vertices all lie in the region. [F] bool."""
    sel = np.zeros(int(faces.max()) + 1, bool)
    sel[np.asarray(list(region_verts), np.int64)] = True
    return sel[faces].all(axis=1)


def subdivide(
    verts: np.ndarray,                  # [V,3]
    faces: np.ndarray,                  # [F,3]
    face_mask: np.ndarray,              # [F] bool: faces to split 4-way
    vert_attrs: Dict[str, np.ndarray],  # each [V, ...]
) -> Tuple[np.ndarray, np.ndarray, Dict[str, np.ndarray], np.ndarray]:
    """Returns (verts', faces', attrs', new_face_mask): new_face_mask marks
    the faces that came from subdivided originals."""
    face_mask = np.asarray(face_mask, bool)
    split = faces[face_mask]
    keep = faces[~face_mask]

    # one midpoint per undirected edge, numbered in sorted-edge order
    edges = np.concatenate(
        [split[:, [0, 1]], split[:, [1, 2]], split[:, [2, 0]]], axis=0)
    edges = np.sort(edges, axis=1)
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    mid_base = verts.shape[0]

    n = split.shape[0]
    m01 = mid_base + inv[:n]
    m12 = mid_base + inv[n:2 * n]
    m20 = mid_base + inv[2 * n:]
    new_faces = np.concatenate([
        np.stack([split[:, 0], m01, m20], axis=1),
        np.stack([m01, split[:, 1], m12], axis=1),
        np.stack([m20, m12, split[:, 2]], axis=1),
        np.stack([m01, m12, m20], axis=1),
    ])

    def with_midpoints(a):
        return np.concatenate([a, 0.5 * (a[uniq[:, 0]] + a[uniq[:, 1]])])

    new_mask = np.concatenate(
        [np.zeros(keep.shape[0], bool), np.ones(new_faces.shape[0], bool)])
    return (with_midpoints(verts), np.concatenate([keep, new_faces]),
            {k: with_midpoints(a) for k, a in vert_attrs.items()}, new_mask)


def cylindrical_uv(centers: np.ndarray) -> np.ndarray:
    """UV [F,2] float32 of face centres [F,3] by a cylindrical projection
    around the vertical axis (a stand-in for the SMPL-X UV atlas)."""
    rel = centers - centers.mean(0)
    u = np.arctan2(rel[:, 0], rel[:, 2]) / (2 * np.pi) + 0.5
    v = (rel[:, 1] - rel[:, 1].min()) / (np.ptp(rel[:, 1]) + 1e-6)
    return np.stack([u, v], axis=-1).astype(np.float32)


def vertex_average(values: np.ndarray, faces: np.ndarray,
                   n_verts: int) -> np.ndarray:
    """Per-face values [F,C] averaged onto the vertices [n_verts, C] (a
    vertex in no face gets 0)."""
    acc = np.zeros((n_verts, values.shape[1]), np.float32)
    cnt = np.zeros(n_verts, np.float32)
    for i in range(3):
        np.add.at(acc, faces[:, i], values)
        np.add.at(cnt, faces[:, i], 1.0)
    return acc / np.maximum(cnt[:, None], 1.0)


def bake_template(
    model: SMPLXModel,
    subdivide_regions: Optional[Sequence[Sequence[int]]] = None,
    vert_uv: Optional[np.ndarray] = None,
) -> TemplateAssets:
    """Bake template assets, optionally subdividing the given vertex
    regions; the tensors land on the model's device.

    ``vert_uv`` [V,2] supplies a real UV atlas (e.g. from the SMPL-X UV
    obj); without one a cylindrical projection is used.
    """
    dev = model.v_template.device
    out = smplx_forward(model, canonical_params(1, device=dev))
    verts = out.verts[0].cpu().numpy()
    faces = np.asarray(model.faces)

    def host(t):
        return t.detach().cpu().numpy()

    n_pose = model.posedirs.shape[0]
    attrs = {
        "lbsw": host(model.lbs_weights),
        "spdir": np.concatenate([host(model.shapedirs),
                                 host(model.expr_dirs)], axis=-1),
        # posedirs [(J-1)*9, V*3] -> per-vertex [V, 3, P]
        "podir": host(model.posedirs).T.reshape(verts.shape[0], 3, n_pose),
    }
    if vert_uv is not None:
        attrs["uv"] = np.asarray(vert_uv, np.float32)

    sub_mask = np.zeros(faces.shape[0], bool)
    if subdivide_regions:
        for region in subdivide_regions:
            sub_mask |= region_faces(faces, region)
        verts, faces, attrs, from_sub = subdivide(verts, faces, sub_mask,
                                                  attrs)
    else:
        from_sub = np.zeros(faces.shape[0], bool)

    centers = verts[faces].mean(axis=1)
    if "uv" in attrs:
        uv_faces = attrs["uv"][faces].mean(axis=1)
    else:
        uv_faces = cylindrical_uv(centers)
        attrs["uv"] = vertex_average(uv_faces, faces, verts.shape[0])

    rot = compute_tbn(verts, faces, attrs["uv"])
    face_lbsw = attrs["lbsw"][faces].mean(axis=1)
    podir = attrs["podir"].reshape(verts.shape[0] * 3, -1).T  # [(J-1)*9, V*3]

    def f32(x):
        return torch.as_tensor(np.ascontiguousarray(x, np.float32),
                               device=dev)

    return TemplateAssets(
        init_uv=f32(uv_faces),
        init_pcd=f32(centers),
        init_rot=f32(rot),
        init_faces=faces.astype(np.int64),
        init_lbsw=f32(face_lbsw),
        init_spdir=f32(attrs["spdir"]),
        init_podir=f32(podir),
        face_mask=from_sub,
    )


def save_template_dir(template: TemplateAssets, path: str,
                      suffix: str = "smplx_thu") -> None:
    """Write the reference's template npy layout (``load_template_dir``'s
    inverse)."""
    os.makedirs(path, exist_ok=True)
    for name in ("init_uv", "init_pcd", "init_rot", "init_faces",
                 "init_lbsw", "init_spdir", "init_podir"):
        a = getattr(template, name)
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        np.save(os.path.join(path, f"{name}_{suffix}.npy"), a)
    if template.face_mask is not None:
        np.save(os.path.join(path, "face_mask_thu.npy"),
                np.asarray(template.face_mask))
