"""Offline UV-texture baking over a dataset of items (port of the
repository's ``scripts/bake_uv.py``).

    python -m sigman_release_torch.bake_uv --items ./data/items.npy \
        [--smplx SMPLX_NEUTRAL.npz] [--start 0 --end 100] [--device cpu]

For each item directory (calibrated views, optionally a posed mesh),
back-project ``DEFAULT_VIEW_IDS`` into the body's UV atlas and write
``UV/smplxuv_albedo.png``. Views are ``rgb_map/VVVV.jpg`` read at full
resolution by the port's own decoder (``data/native_loader.py``); a view
missing or unreadable is skipped; the cameras are the w2c ``R`` / ``T`` of
``camera_full_calibration.json`` with K = [[1100, 0, 512], [0, 1100, 512]].
The mesh is the item's ``--mesh_name`` OBJ (posed vertices, in the body
model's vertex order) when the item has one, else the body model's
canonical mesh; the UVs are the cylindrical ones of the template bake,
averaged onto the vertices. Items that fail are listed in ``wrong_id.npy``
in the working directory. ``--device`` defaults to ``cuda`` and raises
without it.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Optional

import numpy as np

from sigman_release_torch.body.smplx import (
    canonical_params,
    load_smplx_npz,
    smplx_forward,
    synthetic_body_model,
)
from sigman_release_torch.body.subdivide import bake_template, vertex_average
from sigman_release_torch.data.native_loader import decode_image
from sigman_release_torch.data.uv_baking import bake_uv_texture
from sigman_release_torch.device import resolve_device
from sigman_release_torch.utils.image_io import image_size, write_png

# the reference's 18 baking views
DEFAULT_VIEW_IDS = [30, 37, 45, 53, 65, 85, 0, 8, 82, 60, 15, 22, 70, 75,
                    40, 50, 5, 78]
K_BAKE = np.array([[1100.0, 0, 512.0], [0, 1100.0, 512.0], [0, 0, 1.0]])


def read_obj_vertices(path: str) -> np.ndarray:
    """The ``v x y z`` lines of an OBJ file as [V,3] float32."""
    with open(path) as f:
        rows = [line.split()[1:4] for line in f if line.startswith("v ")]
    return np.asarray(rows, np.float32).reshape(-1, 3)


def read_view(path: str) -> Optional[np.ndarray]:
    """[H,W,3] float32 in [0,1] at the file's own size, or None when the
    file is missing or cannot be decoded."""
    try:
        h, w = image_size(path)
        return decode_image(path, h, w, 3)
    except (OSError, ValueError):
        return None


def bake_item(item_dir: str, vert_uv: np.ndarray, faces: np.ndarray,
              verts: np.ndarray, view_ids, texture_size: int,
              mesh_name: Optional[str] = None, device=None,
              stats: Optional[dict] = None) -> str:
    """Bake one item's ``UV/smplxuv_albedo.png``; returns its path."""
    with open(os.path.join(item_dir, "camera_full_calibration.json")) as f:
        cam = json.load(f)
    images, w2cs = [], []
    for vid in view_ids:
        img = read_view(os.path.join(item_dir, "rgb_map", f"{vid:04d}.jpg"))
        if img is None:
            continue
        images.append(img)
        pose = cam[f"{vid:04d}"]
        w2c = np.eye(4)
        w2c[:3, :3] = np.asarray(pose["R"])
        w2c[:3, 3] = np.asarray(pose["T"])
        w2cs.append(w2c)
    if not images:
        raise FileNotFoundError(f"no views in {item_dir}")
    mesh = os.path.join(item_dir, mesh_name) if mesh_name else None
    if mesh and os.path.exists(mesh):
        verts = read_obj_vertices(mesh)
        if verts.shape[0] != vert_uv.shape[0]:
            raise ValueError(f"{mesh}: {verts.shape[0]} vertices, the body "
                             f"model has {vert_uv.shape[0]}")

    tex = bake_uv_texture(verts, faces, vert_uv, np.stack(images),
                          np.stack(w2cs), K_BAKE, texture_size=texture_size,
                          device=device, stats=stats)
    out_dir = os.path.join(item_dir, "UV")
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "smplxuv_albedo.png")
    write_png(out, (tex.cpu().numpy() * 255).astype(np.uint8))
    return out


def main(argv=None) -> dict:
    """Returns {"baked": [(item, png path, bake stats)], "wrong":
    [item]} (``bake_uv_texture``'s ``stats``)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--items", required=True,
                    help="npy list of item directories")
    ap.add_argument("--smplx", default=None, help="SMPLX model npz")
    ap.add_argument("--mesh_name", default="smplx_posed.obj",
                    help="per-item posed mesh (falls back to the canonical "
                         "body-model mesh when absent)")
    ap.add_argument("--start", type=int, default=0)
    ap.add_argument("--end", type=int, default=-1)
    ap.add_argument("--texture_size", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    model = (load_smplx_npz(args.smplx, device=dev) if args.smplx
             else synthetic_body_model(device=dev))
    template = bake_template(model)
    verts = smplx_forward(model, canonical_params(1, device=dev)).verts[0]
    faces = np.asarray(model.faces)
    # per-vertex UV: the template's face UVs averaged onto the vertices
    vert_uv = vertex_average(template.init_uv.cpu().numpy(),
                             template.init_faces, verts.shape[0])
    verts = verts.cpu().numpy()

    items = [str(p) for p in np.load(args.items, allow_pickle=True)]
    end = len(items) if args.end < 0 else args.end
    baked, wrong = [], []
    for item in items[args.start:end]:
        stats = {}
        try:
            out_path = bake_item(item, vert_uv, faces, verts,
                                 DEFAULT_VIEW_IDS, args.texture_size,
                                 mesh_name=args.mesh_name, device=dev,
                                 stats=stats)
            print(f"[bake_uv] {item} -> {out_path} ({stats['samples']} "
                  f"samples; texels covered {100 * stats['direct']:.2f}%, "
                  f"{100 * stats['covered']:.2f}% after the mip fill)",
                  flush=True)
            baked.append((item, out_path, stats))
        except Exception as e:  # collect failures, as the reference does
            print(f"[bake_uv] FAILED {item}: {e}", flush=True)
            wrong.append(item)
    if wrong:
        np.save("wrong_id.npy", np.asarray(wrong))
        print(f"[bake_uv] {len(wrong)} failures -> wrong_id.npy")
    return {"baked": baked, "wrong": wrong}


if __name__ == "__main__":
    main()
