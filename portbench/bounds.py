"""The least time of the port's rasterizer kernels on the inputs they were
given: frozen copies of ``chip_smoke.py``'s prices and bound arithmetic
(``H100_*``, ``K1_WORK``, ``K2_WORK``, ``HIT_CLASSES``, ``K1_STAGE_OPS``,
``K2_STAGE_OPS``, ``K1_ROW_BYTES``, ``bound_ms``, ``bounds``, ``k1_bytes``
and ``hold_k2``'s byte count) at commit a519890, fed with the evaluations
that the benchmark's plain renderer counts from the Gaussians and cameras
the kernels rendered (``reference.render.work_counts``), never from the
port's pair stream.

K1 (forward_tiles): the hits (evaluations with alpha > 0 at pixels not yet
saturated) priced by class, one staging pass per (Gaussian, 32-px tile)
row with a hit, and the bytes: those rows read once (40 B), the segment
arrays and the [tiles, 8, 32^2] f32 output written once. K2
(backward_tiles): likewise with K2's prices, the rows with a contributing
hit written once (10 f32), and the forward and gradient rows of the tiles
with a hit read once. The bound is the larger of the priced operations
over the f32 and exp rates and the bytes over HBM's rate.
"""

from __future__ import annotations

from typing import Dict

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
# exp on the special-function units: 16 results per SM per clock against 256
# f32 flops (128 FMA lanes) at the same clock
H100_SFU_PER_S = H100_F32_FLOPS / 16
K1_WORK = {"power_cut": (11, 0), "floor_cut": (14, 1),
           "contributing": (28, 1), "saturating": (19, 1)}
K1_ROW_BYTES = 40               # the 10 live f32 of a pair row
K2_WORK = {"power_cut": (11, 0), "floor_cut": (14, 1),
           "contributing": (55, 1), "saturating": (19, 1)}
HIT_CLASSES = ("contributing", "saturating")
K1_STAGE_OPS = 18
K2_STAGE_OPS = 31
TILE = 32                       # the kernels' default tile side


def bound_ms(work, prices, n_bytes, rows=0, row_ops=0):
    """(bound ms, 'bytes' | 'operations', parts): the larger of the bytes
    over the memory rate and the priced operations (the f32 pipes and the
    special-function units run side by side, so the larger of the two)."""
    f32_ops = sum(work[k] * prices[k][0] for k in prices) + rows * row_ops
    exps = sum(work[k] * prices[k][1] for k in prices)
    f32_ms = f32_ops / H100_F32_FLOPS * 1e3
    sfu_ms = exps / H100_SFU_PER_S * 1e3
    bound = {"bytes": n_bytes / H100_BYTES_PER_S * 1e3,
             "operations": max(f32_ms, sfu_ms)}
    by = max(bound, key=bound.get)
    return bound[by], by, dict(bound, f32_ops=f32_ops, f32_ms=f32_ms,
                               exps=exps, sfu_ms=sfu_ms)


def hit_bound_ms(work, prices, stage_ops, n_rows, n_bytes):
    """The hits plus one staging pass per row (``bounds``' first half)."""
    hits = {k: prices[k] for k in HIT_CLASSES}
    return bound_ms(work, hits, n_bytes, n_rows, stage_ops)[0]


def k1_bytes(n_rows, n_tiles, tile=TILE):
    return n_rows * K1_ROW_BYTES + 8 * n_tiles + n_tiles * 8 * tile * tile * 4


def k2_bytes(n_rows, n_written, tiles_hit, n_tiles, tile=TILE):
    return (n_rows * K1_ROW_BYTES + n_written * 10 * 4
            + tiles_hit * 10 * tile * tile * 4 + 8 * n_tiles)


def launch_bounds_s(w: Dict[str, int]) -> Dict[str, float]:
    """Seconds K1 and K2 need for one launch over the counted views."""
    k1 = hit_bound_ms(w, K1_WORK, K1_STAGE_OPS, w["rows"],
                      k1_bytes(w["rows"], w["tiles"]))
    k2 = hit_bound_ms(w, K2_WORK, K2_STAGE_OPS, w["rows"],
                      k2_bytes(w["rows"], w["rows_contributing"],
                               w["tiles_hit"], w["tiles"]))
    return {"forward_tiles": k1 / 1e3, "backward_tiles": k2 / 1e3}
