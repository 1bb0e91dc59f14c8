"""Gaussian PLY import/export, 3DGS-ecosystem compatible (port of the JAX
package's ``utils/ply.py``; the same bytes for the same array).

The reference's conventions: 14-channel layout [xyz(3), opacity(1),
scale(3), rotation-quat(4), rgb(3)]; ``compatible=True`` stores
inverse-activated values (logit opacity, log scale, SH-DC colour) so files
interoperate with standard 3DGS viewers. Written with a self-contained
binary-little-endian PLY writer (no plyfile dependency).
"""

from __future__ import annotations

import numpy as np

C0 = 0.28209479177387814


def _inverse_sigmoid(x):
    x = np.clip(x, 1e-6, 1 - 1e-6)
    return np.log(x / (1 - x))


def save_ply(gaussians: np.ndarray, path: str, compatible: bool = True,
             opacity_prune: float = 0.005) -> int:
    """gaussians [N,14] (activated values). Returns number of points written."""
    g = np.asarray(gaussians, np.float32)
    if g.ndim == 3:
        assert g.shape[0] == 1, "save_ply expects batch size 1"
        g = g[0]
    xyz, opacity, scales, rots, shs = (
        g[:, 0:3], g[:, 3:4], g[:, 4:7], g[:, 7:11], g[:, 11:14]
    )
    mask = opacity[:, 0] >= opacity_prune
    xyz, opacity, scales, rots, shs = (
        a[mask] for a in (xyz, opacity, scales, rots, shs)
    )
    if compatible:
        opacity = _inverse_sigmoid(opacity)
        scales = np.log(scales + 1e-8)
        shs = (shs - 0.5) / C0

    names = (["x", "y", "z"]
             + [f"f_dc_{i}" for i in range(3)]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    data = np.concatenate([xyz, shs, opacity, scales, rots], axis=1)
    n = data.shape[0]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"element vertex {n}\n"
        + "".join(f"property float {name}\n" for name in names)
        + "end_header\n"
    )
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(data.astype("<f4").tobytes())
    return n


def load_ply(path: str, compatible: bool = True) -> np.ndarray:
    """Read a 3DGS PLY -> [N,14] activated gaussian array."""
    with open(path, "rb") as f:
        magic = f.readline().strip()
        assert magic == b"ply", "not a ply file"
        fmt = f.readline().strip()
        names = []
        n = 0
        while True:
            line = f.readline().strip()
            if line == b"end_header":
                break
            parts = line.split()
            if parts[0] == b"element" and parts[1] == b"vertex":
                n = int(parts[2])
            elif parts[0] == b"property":
                names.append(parts[2].decode())
        if b"binary_little_endian" in fmt:
            raw = np.frombuffer(
                f.read(n * len(names) * 4), dtype="<f4"
            ).reshape(n, len(names))
        else:  # ascii
            raw = np.loadtxt(f, max_rows=n).reshape(n, len(names))

    col = {name: raw[:, i] for i, name in enumerate(names)}
    xyz = np.stack([col["x"], col["y"], col["z"]], axis=1)
    opacity = col["opacity"][:, None]
    scales = np.stack(
        [col[f"scale_{i}"] for i in range(3)], axis=1
    )
    rot_names = sorted((k for k in col if k.startswith("rot_")),
                       key=lambda s: int(s.split("_")[-1]))
    rots = np.stack([col[k] for k in rot_names], axis=1)
    shs = np.stack([col[f"f_dc_{i}"] for i in range(3)], axis=1)

    g = np.concatenate([xyz, opacity, scales, rots, shs], axis=1).astype(
        np.float32
    )
    if compatible:
        g[:, 3:4] = 1.0 / (1.0 + np.exp(-g[:, 3:4]))
        g[:, 4:7] = np.exp(g[:, 4:7])
        g[:, 11:14] = C0 * g[:, 11:14] + 0.5
    return g
