"""The kernels' exact per-warp cull, on the CPU.

``forward_tiles.cull_rects`` is the PyTorch copy of the rule both CUDA
kernels apply at staging (``csrc/tile_common.cuh``): a warp skips a pair
whose bit for its 8 x 4 pixel rectangle is clear. The cull is exact only if
every skipped (pair, pixel) has alpha == 0 in the kernels' own arithmetic,
which ``forward_tiles._alpha`` repeats operation for operation (it is what
the plain versions composite). These tests hold the rule to that on seeded
and hypothesis-drawn pair rows and on a binned scene, and show that it
needs its relative slack.
"""

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from chip_smoke import cull_cases
from sigman_release_torch.ops.rasterizer import forward_tiles as k1
from sigman_release_torch.ops.rasterizer import (
    RasterizeConfig,
    build_cov3d,
)
from sigman_release_torch.ops.rasterizer.binning import ALPHA_MIN, TILE
from sigman_release_torch.ops.rasterizer.render import prepare_pairs
from sigman_release_torch.utils import cuda_build

from utils import orbit_rig, random_gaussians, tan_half_fov


def _rows(mx, my, sx, sy, rho, opa):
    """Pair rows [k, 16] f32 from means, standard deviations, correlation
    and opacity (conic = inverse covariance, computed in f64)."""
    mx, my, sx, sy, rho, opa = np.broadcast_arrays(
        *(np.asarray(v, np.float64) for v in (mx, my, sx, sy, rho, opa)))
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    r = np.zeros((mx.size, 16), np.float32)
    r[:, 0], r[:, 1] = mx, my
    r[:, 2], r[:, 3], r[:, 4] = sy ** 2 / det, -rho * sx * sy / det, \
        sx ** 2 / det
    r[:, 5:8] = 0.5
    r[:, 8] = opa
    r[:, 9] = 1.0
    return torch.from_numpy(r)


def _skipped_alpha(feats, ox=0.0, oy=0.0):
    """(kept [k, 32], the kernels' alpha [k, 32, 32] by (warp rectangle,
    lane)) of pair rows feats [k, 16] in the tile at (ox, oy)."""
    oxt, oyt = torch.tensor([[ox]]), torch.tensor([[oy]])
    _, _, basis = k1.pixel_frame(1, 1, 1, "cpu")
    alpha, _ = k1._alpha(feats[None], oxt, oyt, basis,
                         torch.ones((1, feats.shape[0]), dtype=torch.bool))
    kept = k1.cull_rects(feats, ox, oy)
    return kept, k1.rect_view(alpha[0])


def _assert_exact(feats, ox=0.0, oy=0.0):
    """Every (pair, warp rectangle) the cull skips has alpha == 0 at all its
    pixels. Returns the mask."""
    kept, alpha = _skipped_alpha(feats, ox, oy)
    hit = (alpha > 0).any(-1)                                 # [k, rect]
    bad = hit & ~kept
    assert not bad.any(), (feats[bad.any(-1)], bad.nonzero()[:5])
    return kept


def test_cull_is_exact_on_seeded_rows():
    """Means far off the tile and on it, sigmas from 0.2 to 80 px, strong
    anisotropy, opacities from the floor up; the cull also skips most
    rows."""
    rng = np.random.default_rng(0)
    k = 4000
    feats = _rows(rng.uniform(-120, 150, k), rng.uniform(-120, 150, k),
                  np.exp(rng.uniform(np.log(0.2), np.log(80), k)),
                  np.exp(rng.uniform(np.log(0.2), np.log(80), k)),
                  rng.uniform(-0.99, 0.99, k),
                  rng.uniform(ALPHA_MIN, 1.0, k))
    kept = _assert_exact(feats)
    assert kept.float().mean() < 0.5


@pytest.mark.parametrize("case", ["far_off_tile", "anisotropic",
                                  "opacity_at_floor", "mean_on_pixel"])
def test_cull_is_exact_on_edge_cases(case):
    rng = np.random.default_rng(1)
    k = 500
    if case == "far_off_tile":       # large Gaussians hundreds of px away
        ang = rng.uniform(0, 2 * np.pi, k)
        feats = _rows(16 + 400 * np.cos(ang), 16 + 400 * np.sin(ang),
                      rng.uniform(50, 200, k), rng.uniform(50, 200, k),
                      rng.uniform(-0.5, 0.5, k), rng.uniform(0.5, 1.0, k))
    elif case == "anisotropic":      # needles at every angle, rho -> +-1
        feats = _rows(rng.uniform(-40, 72, k), rng.uniform(-40, 72, k),
                      rng.uniform(0.05, 0.3, k), rng.uniform(20, 300, k),
                      rng.choice([-0.9999, -0.999, 0.0, 0.999, 0.9999], k),
                      rng.uniform(0.1, 1.0, k))
    elif case == "opacity_at_floor":  # alpha's peak a hair above 1/255
        feats = _rows(rng.uniform(-4, 36, k), rng.uniform(-4, 36, k),
                      rng.uniform(0.3, 10, k), rng.uniform(0.3, 10, k),
                      rng.uniform(-0.8, 0.8, k),
                      ALPHA_MIN * (1 + np.geomspace(1e-7, 1e-1, k)))
    else:                            # means on pixel centres
        feats = _rows(rng.integers(0, 32, k), rng.integers(0, 32, k),
                      rng.uniform(0.05, 3, k), rng.uniform(0.05, 3, k),
                      rng.uniform(-0.9, 0.9, k), rng.uniform(0.004, 1.0, k))
    kept = _assert_exact(feats)
    if case == "mean_on_pixel":      # the mean's rectangle is never skipped
        rect = feats[:, 1].long() // 4 * 4 + feats[:, 0].long() // 8
        assert kept[torch.arange(k), rect].all()


def _rows_at_the_floor(seed, k=20000):
    """Axis-aligned Gaussians whose smallest q over a warp rectangle lies on
    one of its pixels (the mean beyond that pixel's edge or corner), with
    the opacity set so that pixel's alpha is within 1e-6 of the 1/255
    floor: the slots where the slack decides. Means up to 40 px off the
    rectangle, sigmas 0.05 to 50 px. Returns (rows, that pixel's rectangle
    row-major index, lane)."""
    rng = np.random.default_rng(seed)
    rect = rng.integers(0, 32, k)
    x0, y0 = 8 * (rect % 4), 4 * (rect // 4)
    top = rng.uniform(size=k) < 0.5
    row = np.where(top, y0, y0 + 3)
    my = row + np.where(top, -1, 1) * rng.uniform(0, 4, k)
    side = rng.integers(0, 3, k)          # mean over the rectangle, or off
    col = np.where(side == 0, x0 + rng.integers(0, 8, k),
                   np.where(side == 1, x0, x0 + 7))
    mx = col + np.select([side == 1, side == 2], [-1, 1], 0) \
        * rng.uniform(0, 40, k)
    sx = np.exp(rng.uniform(np.log(0.05), np.log(50), k))
    sy = np.exp(rng.uniform(np.log(0.05), np.log(50), k))
    q = (col - mx) ** 2 / sx ** 2 + (row - my) ** 2 / sy ** 2
    keep = q < 2 * np.log(255.0)
    opa = ALPHA_MIN * np.exp(q[keep] / 2) \
        * (1 + rng.uniform(-1e-6, 1e-6, keep.sum()))
    feats = _rows(mx[keep], my[keep], sx[keep], sy[keep], 0.0, opa)
    r, c = torch.from_numpy(row[keep]), torch.from_numpy(col[keep])
    return feats, r // 4 * 4 + c // 8, r % 4 * 8 + c % 8


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cull_is_exact_at_the_floor(seed):
    """Rows whose peak alpha over a rectangle sits on the 1/255 floor."""
    feats, rect, lane = _rows_at_the_floor(seed)
    _, alpha = _skipped_alpha(feats)
    at_floor = alpha[torch.arange(len(feats)), rect, lane]
    assert 0 < (at_floor > 0).float().mean() < 1   # both sides of the floor
    _assert_exact(feats)


@pytest.mark.parametrize("slack, drops", [
    ((0.0, 0.0), True), ((k1.CULL_ABS, 0.0), True), ((0.0, 1e-7), False)],
    ids=["none", "absolute_only", "relative_1e-7_only"])
def test_cull_slack_on_rows_at_the_floor(monkeypatch, slack, drops):
    """The relative slack is what makes the rule exact: with none, or with
    the absolute term alone, it skips (row, rectangle) slots where the
    kernels' alpha is > 0 on the rows at the floor of the three seeds above
    (with the absolute term alone, one slot of seed 2); a relative term of
    1e-7 alone (100x below CULL_REL) skips none."""
    monkeypatch.setattr(k1, "CULL_ABS", slack[0])
    monkeypatch.setattr(k1, "CULL_REL", slack[1])
    dropped = 0
    for seed in (0, 1, 2):
        kept, alpha = _skipped_alpha(_rows_at_the_floor(seed)[0])
        dropped += int(((alpha > 0).any(-1) & ~kept).sum())
    assert (dropped > 0) == drops


def test_cull_keeps_every_row_of_a_conic_not_positive_definite():
    feats = _rows(np.zeros(4), np.zeros(4), 1.0, 1.0, 0.0, 0.8)
    feats[0, 2] = -1.0                           # a < 0
    feats[1, 4] = 0.0                            # c = 0
    feats[2, 3] = 2.0                            # b^2 > a c
    feats[3, 2:5] = float("nan")
    assert k1.cull_rects(feats, 0.0, 0.0).all()
    _assert_exact(feats[:3])


def test_cull_masks_of_the_hand_made_cases():
    """A Gaussian wider than the tile keeps every warp; the small one of
    ``one_warp`` only warp 13 (columns 8-15, rows 12-15)."""
    cases = cull_cases(np.random.default_rng(0))
    pairs, start = cases["whole_tile"][:2]
    assert k1.cull_rects(torch.from_numpy(pairs[start[0]:start[0] + 1]),
                         0.0, 0.0).all()
    pairs, start = cases["one_warp"][:2]
    kept = _assert_exact(torch.from_numpy(pairs[start[0]:start[0] + 1]))
    assert kept[0].nonzero().flatten().tolist() == [13]


@settings(max_examples=300, deadline=None, derandomize=True, database=None)
@given(mx=st.floats(-300, 330), my=st.floats(-300, 330),
       log_sx=st.floats(np.log(0.03), np.log(400)),
       log_sy=st.floats(np.log(0.03), np.log(400)),
       rho=st.floats(-0.9999, 0.9999),
       opa=st.one_of(st.floats(ALPHA_MIN, 1.0),
                     st.floats(0.0, 1e-5).map(lambda e: ALPHA_MIN * (1 + e))),
       ox=st.sampled_from([0.0, 32.0, 480.0]),
       oy=st.sampled_from([0.0, 64.0, 480.0]))
def test_cull_is_exact_hypothesis(mx, my, log_sx, log_sy, rho, opa, ox, oy):
    """Any Gaussian near a tile anywhere on a 512^2 view."""
    feats = _rows(mx + ox, my + oy, np.exp(log_sx), np.exp(log_sy), rho, opa)
    _assert_exact(feats, ox, oy)


@settings(max_examples=200, deadline=None, derandomize=True, database=None)
@given(a=st.floats(-2.0, 5.0), b=st.floats(-3.0, 3.0), c=st.floats(-2.0, 5.0),
       mx=st.floats(-40, 72), my=st.floats(-40, 72), opa=st.floats(0.0, 1.0))
def test_cull_is_exact_on_raw_conics_hypothesis(a, b, c, mx, my, opa):
    """Conic entries drawn directly, positive-definite or not."""
    feats = _rows(mx, my, 1.0, 1.0, 0.0, opa)
    feats[0, 2:5] = torch.tensor([a, b, c])
    _assert_exact(feats)


def test_cull_drops_no_weighted_pair_of_a_binned_scene():
    """A 2-view, 96-Gaussian scene at 64 px binned by the port: at every
    pixel where the plain version gives a segment's pair alpha > 0, the
    pair's bit for that pixel's warp is set; and the plain version's counts
    agree (every (pair, warp) slot with a hit is kept)."""
    g = random_gaussians(96, seed=0)
    cv, cvp, _ = orbit_rig(2)
    th = tan_half_fov()
    cfg = RasterizeConfig(img_h=64, img_w=64, tan_half_fovx=th,
                          tan_half_fovy=th, chunk=32)
    t = torch.from_numpy
    cov = build_cov3d(t(g["scales"]), t(g["rotations"]))
    s = prepare_pairs(t(g["means3d"]), cov, t(g["colors"]), t(g["opacity"]),
                      t(cv), t(cvp), cfg)
    n_hit = 0
    for i, (s0, c) in enumerate(zip(s.tile_start.tolist(),
                                    s.tile_count.tolist())):
        if c == 0:
            continue
        tv = i % cfg.n_tiles
        ox, oy = float(tv % cfg.ntx * TILE), float(tv // cfg.ntx * TILE)
        kept, alpha = _skipped_alpha(s.pairs[s0:s0 + c], ox, oy)
        hit = (alpha > 0).any(-1)
        assert not (hit & ~kept).any()
        n_hit += int(hit.sum())
    assert n_hit > 100
    work = {}
    k1.forward_tiles_plain(s.pairs, s.tile_start, s.tile_count, ntx=cfg.ntx,
                           tiles_per_view=cfg.n_tiles, chunk=cfg.chunk,
                           work=work)
    assert work["warp_slots_kept"] >= \
        work["warp_slots"] - work["warp_slots_empty"]
    assert work["warp_slots_kept"] < work["warp_slots"]


def test_launch_order_is_longest_first():
    counts = torch.tensor([0, 37, 700, 5, 260, 128, 700], dtype=torch.int32)
    order = k1.launch_order(counts)
    assert order.dtype == torch.int32
    assert sorted(order.tolist()) == list(range(7))
    assert (counts[order.long()].diff() <= 0).all()


def test_build_target_changes_with_a_header(tmp_path):
    """The library's name hashes the headers beside a source, so editing
    the shared ``tile_common.cuh`` rebuilds both kernels."""
    src = tmp_path / "kernel.cu"
    src.write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("constexpr int kA = 1;\n")
    before = cuda_build._target(src)
    (tmp_path / "common.cuh").write_text("constexpr int kA = 2;\n")
    assert cuda_build._target(src) != before
    assert cuda_build._target(k1.SOURCE).parent == cuda_build.BUILD_DIR
