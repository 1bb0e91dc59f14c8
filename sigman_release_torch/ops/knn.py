"""K-nearest-neighbour utilities (port of the JAX package's ``ops/knn.py``).

Two functions, two needs, no shared logic:

* :func:`mean_knn_dist2`, the renderer's KNN base scale: for a CUDA tensor
  the kernel ``csrc/knn.cu`` (one launch for a ``[B, N, 3]`` batch, the 4
  smallest distances kept in registers, no distance table), for a CPU
  tensor :func:`mean_knn_dist2_plain` per item. Both keep the expansion
  ``|q|^2 + |p|^2 - 2 q.p`` and the plain version's rounding.
* :func:`knn`, the deformer's voxel bake (``body/deformer.py``): indices
  too, queries that are not the points, one run at set-up, and index ties
  that matter, so it stays plain on every device.

The plain versions are brute force over blocks of queries: ``||a-b||^2 =
|a|^2 + |b|^2 - 2 a.b`` as one matmul per block, then ``topk`` over the
candidate axis. ``block`` bounds the ``[block, N]`` distance table: at the
~1e5-point template scale a 4096-row block is 4096 x 1e5 x 4 B = 1.6 GB,
under the ~2 GB the port allows for one table.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from sigman_release_torch.utils import cuda_build

MAX_TABLE_BYTES = 2 << 30

SOURCE = Path(__file__).resolve().parent / "csrc" / "knn.cu"


def _library() -> ctypes.CDLL:
    lib = cuda_build.load(SOURCE)
    fn = lib.mean_knn_dist2_launch
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _block_rows(n_points: int, block: int) -> int:
    return max(1, min(block, MAX_TABLE_BYTES // (4 * max(n_points, 1))))


def knn(query: torch.Tensor, points: torch.Tensor, k: int = 10,
        block: int = 4096):
    """For each query row return (dist2, idx) of the k nearest ``points``.

    query [Q,3], points [N,3] -> dist2 [Q,k], idx [Q,k] (nearest first).
    """
    p2 = torch.sum(points * points, dim=-1)
    rows = _block_rows(points.shape[0], block)
    d_out, i_out = [], []
    for s in range(0, query.shape[0], rows):
        qb = query[s:s + rows]
        d2 = (torch.sum(qb * qb, dim=-1, keepdim=True)
              - 2.0 * qb @ points.T + p2[None, :])          # [rows, N]
        d, i = torch.topk(d2, k, dim=-1, largest=False, sorted=True)
        d_out.append(d)
        i_out.append(i)
    return torch.clamp(torch.cat(d_out), min=0.0), torch.cat(i_out)


def mean_knn_dist2(points: torch.Tensor, block: int = 4096) -> torch.Tensor:
    """Mean squared distance to the 3 nearest neighbours (excluding self).

    points [N,3] or [B,N,3] float32, N >= 4 -> [N] or [B,N]. Equivalent of
    ``simple_knn.distCUDA2``. A CUDA tensor (contiguous) launches the kernel
    on the current stream, once for the whole batch (counted in
    ``mean_knn_dist2.launches``); a CPU tensor runs
    :func:`mean_knn_dist2_plain` per item (``block`` sets its table rows).
    """
    if points.ndim not in (2, 3) or points.shape[-1] != 3:
        raise ValueError(f"points must be [N, 3] or [B, N, 3], got "
                         f"{tuple(points.shape)}")
    if points.dtype != torch.float32:
        raise ValueError(f"points must be float32, got {points.dtype}")
    n = points.shape[-2]
    if n < 4:
        raise ValueError(f"mean_knn_dist2 needs at least 4 points, got {n}")
    if points.device.type == "cpu":
        if points.ndim == 2:
            return mean_knn_dist2_plain(points, block)
        return torch.stack([mean_knn_dist2_plain(p, block) for p in points])
    if points.device.type != "cuda":
        raise ValueError(f"mean_knn_dist2: unsupported device {points.device}")
    if not points.is_contiguous():
        raise ValueError("mean_knn_dist2 needs a contiguous tensor")
    batch = points.shape[0] if points.ndim == 3 else 1
    if n > (2**31 - 1) // 3 or batch > 65535:
        raise ValueError(f"mean_knn_dist2: [{batch}, {n}, 3] is past the "
                         f"kernel's 32-bit indices or its grid")
    out = torch.empty(points.shape[:-1], dtype=torch.float32,
                      device=points.device)
    stream = torch.cuda.current_stream(points.device).cuda_stream
    rc = _library().mean_knn_dist2_launch(points.data_ptr(), out.data_ptr(),
                                          batch, n, stream)
    if rc != 0:
        raise RuntimeError(f"mean_knn_dist2 kernel launch failed: "
                           f"cudaError {rc}")
    mean_knn_dist2.launches += 1
    return out


mean_knn_dist2.launches = 0


def mean_knn_dist2_plain(points: torch.Tensor,
                         block: int = 4096) -> torch.Tensor:
    """The plain version of :func:`mean_knn_dist2` for one item: points
    [N,3] -> [N], through :func:`knn`'s blocked table and top-k."""
    d2, _ = knn(points, points, k=4, block=block)
    # first column is the point itself (distance ~0) — use columns 1..3
    return torch.mean(d2[:, 1:4], dim=-1)
