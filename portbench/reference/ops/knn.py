# Frozen copy of sigman_release_torch/ops/knn.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
"""K-nearest-neighbour utilities (port of the JAX package's ``ops/knn.py``).

Brute force over blocks of queries: ``||a-b||^2 = |a|^2 + |b|^2 - 2 a.b``
as one matmul per block, then ``topk`` over the candidate axis. ``block``
bounds the ``[block, N]`` distance table: at the ~1e5-point template scale a
4096-row block is 4096 x 1e5 x 4 B = 1.6 GB, under the ~2 GB the port allows
for one table.
"""

from __future__ import annotations

import torch

MAX_TABLE_BYTES = 2 << 30


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

    points [N,3] -> [N]. Equivalent of ``simple_knn.distCUDA2``.
    """
    d2, _ = knn(points, points, k=4, block=block)
    # first column is the point itself (distance ~0) — use columns 1..3
    return torch.mean(d2[:, 1:4], dim=-1)
