"""PyTorch port of the tile rasterizer held against the JAX package on CPU.

Same numpy inputs (tests/utils.py clouds and rigs, 64 px, 96 gaussians,
chunk 32) go through both packages. The JAX side runs its Pallas kernel in
interpret mode; the port's ``forward_tiles`` takes its plain PyTorch version
for CPU tensors. The CUDA kernel itself is held against the plain version by
tests/test_torch_cuda.py (``cuda``-marked, skipped without a card) and by
chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigman_release_tpu.ops.rasterizer import binning as jbin
from sigman_release_tpu.ops.rasterizer import pallas_forward as jfwd
from sigman_release_tpu.ops.rasterizer import (
    RasterizeConfig as JRasterizeConfig,
    build_cov3d as j_build_cov3d,
    project_gaussians as j_project,
    rasterize_single as j_rasterize_single,
    render_dense,
)
from sigman_release_torch.ops.rasterizer import binning as tbin
from sigman_release_torch.ops.rasterizer import forward_tiles as tfwd
from sigman_release_torch.ops.rasterizer import (
    RasterizeConfig,
    build_cov3d,
    project_gaussians,
    rasterize_single,
)

from chip_smoke import hand_streams
from utils import orbit_rig, random_gaussians, tan_half_fov

TH = tan_half_fov()
# K1 plain version vs the Pallas kernel: both evaluate the exponent as the
# same tile-local expanded quadratic with the same fused multiply-adds, so
# they differ only in the rounding of exp/log and of sums (measured 3.6e-7
# on the streams below).
K1_ATOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(n=96, seed=0, views=2):
    g = random_gaussians(n, seed=seed)
    cv, cvp, _ = orbit_rig(views)
    return g, cv, cvp


def _jcfg(hw=64, chunk=32, **kw):
    return JRasterizeConfig(img_h=hw, img_w=hw, tan_half_fovx=TH,
                            tan_half_fovy=TH, chunk=chunk, interpret=True, **kw)


def _tcfg(hw=64, chunk=32, **kw):
    return RasterizeConfig(img_h=hw, img_w=hw, tan_half_fovx=TH,
                           tan_half_fovy=TH, chunk=chunk, **kw)


def _both_render(g, cv, cvp, jcfg, tcfg):
    jcov = j_build_cov3d(jnp.asarray(g["scales"]), jnp.asarray(g["rotations"]))
    jout = j_rasterize_single(
        jnp.asarray(g["means3d"]), jcov, jnp.asarray(g["colors"]),
        jnp.asarray(g["opacity"]), jnp.asarray(cv), jnp.asarray(cvp),
        jnp.ones(3), jcfg)
    tcov = build_cov3d(_t(g["scales"]), _t(g["rotations"]))
    tout = rasterize_single(
        _t(g["means3d"]), tcov, _t(g["colors"]), _t(g["opacity"]), _t(cv),
        _t(cvp), torch.ones(3), tcfg)
    return jout, tout


def test_build_cov3d_and_project_match_jax():
    """(a) covariance packing and EWA projection, every output field."""
    g, cv, cvp = _inputs(n=96)
    jcov = j_build_cov3d(jnp.asarray(g["scales"]), jnp.asarray(g["rotations"]))
    tcov = build_cov3d(_t(g["scales"]), _t(g["rotations"]))
    np.testing.assert_allclose(tcov.numpy(), np.asarray(jcov), rtol=1e-6,
                               atol=1e-9)
    tproj = project_gaussians(_t(g["means3d"]), tcov, _t(cv), _t(cvp),
                              TH, TH, 64, 64)
    for v in range(cv.shape[0]):
        jproj = j_project(jnp.asarray(g["means3d"]), jcov, jnp.asarray(cv[v]),
                          jnp.asarray(cvp[v]), TH, TH, 64, 64)
        np.testing.assert_array_equal(tproj.valid[v].numpy(),
                                      np.asarray(jproj.valid))
        for name in ("mean2d", "depth", "conic", "radius"):
            np.testing.assert_allclose(
                getattr(tproj, name)[v].numpy(),
                np.asarray(getattr(jproj, name)), rtol=2e-5, atol=1e-5,
                err_msg=name)


def test_project_culled_points_stay_finite():
    """Points on / just behind a camera plane give finite, invalid rows."""
    g, cv, cvp = _inputs(n=16)
    _, _, cam_pos = orbit_rig(2)
    means = g["means3d"].copy()
    means[0] = cam_pos[0]
    means[1] = cam_pos[0] * (1.0 + 1e-4)
    tcov = build_cov3d(_t(g["scales"]), _t(g["rotations"]))
    proj = project_gaussians(_t(means), tcov, _t(cv), _t(cvp), TH, TH, 64, 64)
    for f in proj[:4]:
        assert torch.isfinite(f).all()
    assert not proj.valid[0, 0] and not proj.valid[0, 1]


def _both_bins(g, cv, cvp, per_view, budget_factor=5, mtg=9, big_win=6):
    jcov = j_build_cov3d(jnp.asarray(g["scales"]), jnp.asarray(g["rotations"]))
    jproj = jax.vmap(lambda a, b: j_project(
        jnp.asarray(g["means3d"]), jcov, a, b, TH, TH, 64, 64))(
            jnp.asarray(cv), jnp.asarray(cvp))
    n, V = g["means3d"].shape[0], cv.shape[0]
    kw = dict(max_tiles_per_gaussian=mtg, chunk=32,
              pair_budget=budget_factor * n * V, big_win=big_win,
              per_view_budget=per_view)
    jb = jbin.bin_gaussians(jproj, jnp.asarray(g["colors"]),
                            jnp.asarray(g["opacity"]), 64, 64, tile_size=tbin.TILE,
                            **kw)
    jpairs = np.asarray(jbin.place_pairs(jb.feats16, jb.feats_big,
                                         jb.valid_prefix, jb.pay_prefix,
                                         jb.dims))
    tcov = build_cov3d(_t(g["scales"]), _t(g["rotations"]))
    tproj = project_gaussians(_t(g["means3d"]), tcov, _t(cv), _t(cvp),
                              TH, TH, 64, 64)
    tb = tbin.bin_gaussians(tproj, _t(g["colors"]), _t(g["opacity"]), 64, 64,
                            **kw)
    tpairs, _, _ = tbin.place_pairs(torch.cat([tb.feats16, tb.feats_big]),
                                    tb.valid_prefix, tb.pay_prefix, tb.dims)
    return jb, jpairs, tb, tpairs


def _segment_rows(pairs, start, count):
    seg = pairs[start:start + count, :10]
    return seg[np.lexsort((seg[:, 0], seg[:, 1], seg[:, 9]))]


@pytest.mark.parametrize("per_view", [True, False])
def test_binning_matches_jax(per_view):
    """(b) tile_count / tile_start / overflow equal, per-segment pair sets
    equal (sort ties may order them differently)."""
    g, cv, cvp = _inputs(n=96)
    jb, jpairs, tb, tpairs = _both_bins(g, cv, cvp, per_view)
    assert tb.dims == jb.dims
    np.testing.assert_array_equal(tb.tile_count.numpy(),
                                  np.asarray(jb.tile_count))
    np.testing.assert_array_equal(tb.tile_start.numpy(),
                                  np.asarray(jb.tile_start))
    assert int(tb.overflow) == int(jb.overflow) == 0
    assert int(tb.total_valid) == int(jb.total_valid)
    tp = tpairs.numpy()
    for s, c in zip(np.asarray(jb.tile_start), np.asarray(jb.tile_count)):
        np.testing.assert_allclose(_segment_rows(tp, s, c),
                                   _segment_rows(jpairs, s, c),
                                   rtol=2e-5, atol=1e-5)


@pytest.mark.parametrize("per_view", [True, False])
def test_binning_overflow_matches_jax_when_budget_tiny(per_view):
    """Budget clipping is counted, with the JAX package's count."""
    g, cv, cvp = _inputs(n=512)
    jb, _, tb, _ = _both_bins(g, cv, cvp, per_view, budget_factor=1)
    assert int(tb.overflow) > 0
    assert int(tb.overflow) == int(jb.overflow)
    np.testing.assert_array_equal(tb.tile_count.numpy(),
                                  np.asarray(jb.tile_count))


def _jax_forward(pairs, start, count, n_tiles_view, ntx, chunk=32):
    budget = pairs.shape[0]
    chunked = jnp.swapaxes(
        jnp.asarray(pairs).reshape(budget // chunk, chunk, 16), 1, 2)
    return np.asarray(jfwd.forward_tiles(
        chunked, jnp.asarray(start, jnp.int32), jnp.asarray(count, jnp.int32),
        n_programs=start.shape[0], ntx_per_view=ntx,
        tiles_per_view=n_tiles_view, chunk=chunk, interpret=True,
        tile=tbin.TILE))


def _torch_forward(pairs, start, count, n_tiles_view, ntx, chunk=32):
    return tfwd.forward_tiles(
        _t(pairs).float().contiguous(), _t(start).to(torch.int32),
        _t(count).to(torch.int32), ntx=ntx, tiles_per_view=n_tiles_view,
        chunk=chunk).numpy()


def test_forward_tiles_plain_matches_pallas_on_binned_stream():
    """(c) the plain version against Pallas forward_tiles(interpret=True) on
    the identical JAX-binned pair stream."""
    g, cv, cvp = _inputs(n=96)
    jb, jpairs, _, _ = _both_bins(g, cv, cvp, per_view=True)
    start, count = np.asarray(jb.tile_start), np.asarray(jb.tile_count)
    ref = _jax_forward(jpairs, start, count, 4, 2)
    out = _torch_forward(jpairs, start, count, 4, 2)
    assert np.abs(ref[:, :6]).max() > 0.1
    np.testing.assert_allclose(out, ref, atol=K1_ATOL)


def test_forward_tiles_plain_matches_pallas_on_hand_made_streams():
    """(c) edge cases: empty tile, chunk-straddling segment, saturation,
    a Gaussian centred on a pixel (the power clamp)."""
    pairs, start, count = hand_streams(np.random.default_rng(0), chunk=32)
    ref = _jax_forward(pairs, start, count, 4, 2)
    out = _torch_forward(pairs, start, count, 4, 2)
    np.testing.assert_allclose(out, ref, atol=K1_ATOL)
    assert (out[0, :3] == 0).all() and (out[0, 5] == 1).all()   # empty tile
    assert out[2, 5].max() < 1e-2                               # saturated
    centre = 7 * 32 + 5
    assert out[3, 4, centre] > 0.79                             # kept at mean


def _sequential_work(pairs, start, count, ntx, tiles_per_view):
    """The kernel's per-pixel loop in numpy, front to back with a scalar
    transmittance per pixel: the tiles and the count of each work class."""
    npx = tbin.TILE * tbin.TILE
    pix = torch.arange(npx)
    X, Y = (pix % tbin.TILE).float(), (pix // tbin.TILE).float()
    basis = torch.stack([torch.ones_like(X), X, Y, X * X, X * Y, Y * Y])
    work = dict.fromkeys(tfwd.WORK_CLASSES + tfwd.WARP_CLASSES, 0)
    tiles = np.zeros((len(start), 8, npx), np.float32)
    for t, (s0, c) in enumerate(zip(start, count)):
        tv = t % tiles_per_view
        ox = torch.tensor([[float((tv % ntx) * tbin.TILE)]])
        oy = torch.tensor([[float((tv // ntx) * tbin.TILE)]])
        feats = _t(pairs[s0:s0 + c])[None]
        alpha, power_ok = tfwd._alpha(feats, ox, oy, basis,
                                      torch.ones((1, c), dtype=torch.bool))
        alpha, power_ok = alpha[0].numpy(), power_ok[0].numpy()
        kept = tfwd.cull_rects(feats, ox, oy)[0].numpy()     # [c, rect]
        rect_alpha = tfwd.rect_view(torch.from_numpy(alpha)).numpy()
        Tf = np.ones(npx, np.float32)
        Tr = np.ones(npx, np.float32)
        acc = np.zeros((4, npx), np.float32)
        for j in range(c):
            live = Tf >= tfwd.T_EPS
            a = np.where(live, alpha[j], 0.0).astype(np.float32)
            t_incl = Tf * (np.float32(1.0) - a)
            hit = live & (a > 0)
            contrib = hit & (t_incl >= tfwd.T_EPS)
            work["power_cut"] += int((live & ~power_ok[j]).sum())
            work["floor_cut"] += int((live & power_ok[j] & (a == 0)).sum())
            work["contributing"] += int(contrib.sum())
            work["saturating"] += int((hit & ~contrib).sum())
            slots = tfwd.rect_view(torch.from_numpy(live)).numpy().any(1)
            empty = slots & (rect_alpha[j] == 0).all(1)
            work["warp_slots"] += int(slots.sum())
            work["warp_slots_empty"] += int(empty.sum())
            work["warp_slots_kept"] += int((slots & kept[j]).sum())
            acc += np.where(contrib, a * Tf, 0.0) * pairs[s0 + j, [5, 6, 7, 9],
                                                          None]
            Tr = np.where(contrib, t_incl, Tr)
            Tf = np.where(live, t_incl, Tf)
        tiles[t, :4], tiles[t, 4], tiles[t, 5] = acc, 1.0 - Tr, Tr
    return tiles, work


def test_forward_tiles_plain_work_matches_sequential_loop():
    """The plain version's tiles and its per-class evaluation counts (the
    basis of K1's bound in chip_smoke.py) against the kernel's own
    front-to-back loop, run per pixel in numpy."""
    pairs, start, count = hand_streams(np.random.default_rng(0), chunk=32)
    work = {}
    out = tfwd.forward_tiles_plain(
        _t(pairs), _t(start), _t(count), ntx=2, tiles_per_view=4, chunk=32,
        work=work).numpy()
    ref, ref_work = _sequential_work(pairs, start, count, 2, 4)
    np.testing.assert_allclose(out, ref, atol=K1_ATOL)
    assert work == ref_work
    assert min(work.values()) >= 0 and work["floor_cut"] > 0
    assert work["saturating"] > 0 and work["contributing"] > 0


def _render_case(g, cv, cvp, jcfg, tcfg, img_atol=5e-5, depth_atol=1e-4):
    jout, tout = _both_render(g, cv, cvp, jcfg, tcfg)
    assert int(tout["overflow"]) == int(jout["overflow"])
    np.testing.assert_allclose(tout["image"].numpy(), np.asarray(jout["image"]),
                               atol=img_atol)
    np.testing.assert_allclose(tout["alpha"].numpy(), np.asarray(jout["alpha"]),
                               atol=img_atol)
    np.testing.assert_allclose(tout["depth"].numpy(), np.asarray(jout["depth"]),
                               atol=depth_atol)
    return tout


@pytest.mark.parametrize("seed", [0, 3])
def test_rasterize_single_matches_jax(seed):
    """(d) full forward against JAX rasterize_single (interpret): image
    5e-5, depth 1e-4."""
    g, cv, cvp = _inputs(n=96, seed=seed)
    out = _render_case(g, cv, cvp, _jcfg(), _tcfg())
    assert int(out["overflow"]) == 0


def test_rasterize_single_matches_golden():
    """(d) the committed dense-oracle golden render (3-sigma tile-rect
    truncation, so exact_radius=False), at its fp16-storage tolerance."""
    import os

    golden = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                  "dense_render_96g_64px.npz"))
    g, cv, cvp = _inputs(n=96)
    tcov = build_cov3d(_t(g["scales"]), _t(g["rotations"]))
    out = rasterize_single(_t(g["means3d"]), tcov, _t(g["colors"]),
                           _t(g["opacity"]), _t(cv), _t(cvp), torch.ones(3),
                           _tcfg(exact_radius=False))
    for v in range(2):
        np.testing.assert_allclose(out["image"][v].numpy(),
                                   golden[f"image_{v}"].astype(np.float32),
                                   atol=2e-3)
        np.testing.assert_allclose(out["alpha"][v].numpy(),
                                   golden[f"alpha_{v}"].astype(np.float32),
                                   atol=2e-3)


def test_mean_pixel_not_dropped_by_power_rounding():
    """(d) the pinned inputs of the JAX regression test (160 gaussians,
    seed 1, camera 0 of 3): against JAX rasterize_single and the dense
    oracle (2e-4, the JAX test's tolerance)."""
    g = random_gaussians(160, seed=1)
    cv, cvp, _ = orbit_rig(3)
    out = _render_case(g, cv[0:1], cvp[0:1], _jcfg(), _tcfg())
    jcov = j_build_cov3d(jnp.asarray(g["scales"]), jnp.asarray(g["rotations"]))
    ref = render_dense(jnp.asarray(g["means3d"]), jcov,
                       jnp.asarray(g["colors"]), jnp.asarray(g["opacity"]),
                       jnp.asarray(cv[0]), jnp.asarray(cvp[0]), TH, TH, 64, 64,
                       bg_color=jnp.ones(3), tile_size=0)
    np.testing.assert_allclose(out["image"][0].numpy(), np.asarray(ref["image"]),
                               atol=2e-4, rtol=1e-4)


def test_budget_exceeding_candidates_pads_clean():
    """A budget larger than the candidate count pads with empty rows."""
    g, cv, cvp = _inputs(n=32)
    big = _render_case(g, cv, cvp, _jcfg(hw=32, pair_budget_factor=64),
                       _tcfg(hw=32, pair_budget_factor=64))
    assert int(big["overflow"]) == 0


def test_forward_tiles_rejects_other_devices():
    """The K1 wrapper takes CPU or CUDA tensors and nothing else."""
    pairs = torch.zeros((32, 16), requires_grad=True, device="meta")
    idx = torch.zeros(1, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        tfwd.forward_tiles(pairs, idx, idx, ntx=1, tiles_per_view=1)
