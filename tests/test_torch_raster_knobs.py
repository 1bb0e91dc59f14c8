"""The ``RasterizeConfig`` knobs of the port held against the JAX package.

``tile`` 16, ``grad_stream_bf16``, ``per_view_budget`` and ``early_stop``
at the JAX tests' small shapes (tests/utils.py clouds and orbit rigs, 32-64
px, 64-96 Gaussians, chunk 32): the same numpy inputs go through both
packages, the JAX side with its Pallas kernels in interpret mode, the port
with its kernels' plain versions (CPU tensors). The CUDA kernels at each
knob are held against those plain versions by tests/test_torch_cuda.py
(``cuda``-marked) and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigman_release_tpu.ops.rasterizer import (
    RasterizeConfig as JRasterizeConfig,
    build_cov3d as j_build_cov3d,
    rasterize_single as j_rasterize_single,
    render_dense as j_render_dense,
)
from sigman_release_torch.ops.rasterizer import backward_tiles as k2
from sigman_release_torch.ops.rasterizer import forward_tiles as k1
from sigman_release_torch.ops.rasterizer import (
    RasterizeConfig,
    build_cov3d,
    rasterize_single,
)
from sigman_release_torch.ops.rasterizer.render import prepare_pairs

from chip_smoke import grad_tiles, hand_streams
from utils import orbit_rig, random_gaussians, tan_half_fov

TH = tan_half_fov()
# image against the JAX kernel's: the same expanded-quadratic alpha
# arithmetic on both sides (tests/test_torch_rasterizer.py's tolerance)
IMAGE_TOL = 1e-5
# gradients against the JAX Pallas path with the f32 stream, normalised by
# the reference's max (test_torch_raster_backward.PALLAS_GRAD_TOL)
PALLAS_GRAD_TOL = 1e-4
# the bf16 stream rounds each pair gradient (2^-9 relative) before the f32
# sums: the JAX package's own bound for it against the oracle
BF16_GRAD_TOL = 8e-3
# the windows the JAX tile-16 tests use (in 16-px tiles)
T16 = dict(tile=16, max_tiles_per_gaussian=16, big_win=10,
           pair_budget_factor=8)
NAMES = ("means3d", "cov3d", "colors", "opacity")


def _t(x):
    return torch.from_numpy(np.array(x))


def _scene(n, seed=0):
    g = random_gaussians(n, seed=seed)
    cv, cvp, _ = orbit_rig(2)
    return g, cv, cvp


def _port_render(g, cv, cvp, cfg, g_img=None):
    """The port's maps and, with ``g_img``, d(sum image * g_img) w.r.t.
    (means3d, cov3d, colors, opacity)."""
    x = [_t(g["means3d"]), build_cov3d(_t(g["scales"]), _t(g["rotations"])),
         _t(g["colors"]), _t(g["opacity"])]
    if g_img is not None:
        x = [t.detach().requires_grad_() for t in x]
    out = rasterize_single(*x, _t(cv), _t(cvp), torch.ones(3), cfg)
    if g_img is None:
        return out, None
    (out["image"] * _t(g_img)).sum().backward()
    return out, [t.grad.numpy() for t in x]


def _jax_render(g, cv, cvp, jcfg, g_img):
    """The JAX package's maps and d(sum image * g_img), from one forward
    (``jax.vjp``)."""
    args = (jnp.asarray(g["means3d"]),
            j_build_cov3d(jnp.asarray(g["scales"]),
                          jnp.asarray(g["rotations"])),
            jnp.asarray(g["colors"]), jnp.asarray(g["opacity"]))

    def maps(m, c, col, o):
        out = j_rasterize_single(m, c, col, o, cv, cvp, jnp.ones(3), jcfg)
        return {k: out[k] for k in ("image", "alpha", "depth")}

    out, vjp = jax.vjp(maps, *args)
    grads = vjp({"image": jnp.asarray(g_img),
                 "alpha": jnp.zeros_like(out["alpha"]),
                 "depth": jnp.zeros_like(out["depth"])})
    return out, [np.asarray(a) for a in grads]


def _assert_grads(port, ref, tol):
    for name, a, b in zip(NAMES, port, ref):
        assert np.isfinite(a).all() and np.abs(b).max() > 0, name
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(a / scale, b / scale, atol=tol,
                                   err_msg=name)


def _cfgs(hw, **kw):
    port = RasterizeConfig(img_h=hw, img_w=hw, tan_half_fovx=TH,
                           tan_half_fovy=TH, chunk=32)._replace(**kw)
    jax_ = JRasterizeConfig(img_h=hw, img_w=hw, tan_half_fovx=TH,
                            tan_half_fovy=TH, chunk=32, interpret=True,
                            grad_stream_bf16=False)._replace(**kw)
    return port, jax_


@pytest.fixture(scope="module")
def grad_case():
    """32 px, 64 Gaussians, 2 views (the JAX tile-16 backward test's
    scene) and a seeded upstream image gradient."""
    g, cv, cvp = _scene(64)
    g_img = np.random.default_rng(0).normal(
        size=(2, 3, 32, 32)).astype(np.float32)
    return g, cv, cvp, g_img


@pytest.fixture(scope="module")
def tile16_case(grad_case):
    g, cv, cvp, g_img = grad_case
    cfg, jcfg = _cfgs(32, **T16)
    return (_port_render(g, cv, cvp, cfg, g_img),
            _jax_render(g, cv, cvp, jcfg, g_img))


def test_tile16_image_matches_jax(tile16_case):
    """The image, alpha and depth at tile 16."""
    (out, _), (ref, _) = tile16_case
    assert int(out["overflow"]) == 0
    for k in ("image", "alpha", "depth"):
        np.testing.assert_allclose(out[k].detach().numpy(),
                                   np.asarray(ref[k]), atol=IMAGE_TOL,
                                   rtol=IMAGE_TOL, err_msg=k)


def test_tile16_grads_match_jax(tile16_case):
    (_, port), (_, ref) = tile16_case
    _assert_grads(port, ref, PALLAS_GRAD_TOL)


def test_bf16_stream_grads_match_jax(grad_case):
    """``grad_stream_bf16``: against the JAX package's bf16 stream."""
    g, cv, cvp, g_img = grad_case
    cfg, jcfg = _cfgs(32, grad_stream_bf16=True)
    _, port = _port_render(g, cv, cvp, cfg, g_img)
    _, ref = _jax_render(g, cv, cvp, jcfg, g_img)
    _assert_grads(port, ref, BF16_GRAD_TOL)


@pytest.mark.parametrize("tile", [32, 16])
def test_bf16_stream_is_the_f32_stream_rounded(tile):
    """K2's plain version with ``out_bf16`` is its f32 output rounded to
    nearest even, on the hand-made streams (empty tile, chunk-straddling
    segment, saturating stack, a Gaussian on a pixel and on a 16-px tile
    edge, random segments)."""
    rng = np.random.default_rng(1)
    pairs, start, count = (_t(a) for a in hand_streams(rng, tile=tile))
    kw = dict(ntx=2, tiles_per_view=4, chunk=128, tile=tile)
    fwd = k1.forward_tiles(pairs, start, count, **kw)
    grad = _t(grad_tiles(rng, start.shape[0], tile))
    f32 = k2.backward_tiles(pairs, start, count, fwd, grad, **kw)
    bf16 = k2.backward_tiles(pairs, start, count, fwd, grad, out_bf16=True,
                             **kw)
    assert bf16.dtype == torch.bfloat16 and f32.abs().max() > 0
    assert torch.equal(bf16, f32.to(torch.bfloat16))


def test_per_view_budget_both_ways():
    """Per-view regions and one global prefix give the same image and
    gradients when nothing clips (the JAX test_per_view_regions_match_global:
    region padding moves chunk boundaries, so the plain versions' sums
    associate differently, 1e-4 of the gradient's max)."""
    g, cv, cvp = _scene(96)
    g_img = np.random.default_rng(4).normal(
        size=(2, 3, 64, 64)).astype(np.float32)
    cfg, _ = _cfgs(64)
    outs, grads = zip(*(_port_render(g, cv, cvp,
                                     cfg._replace(per_view_budget=pvb), g_img)
                        for pvb in (True, False)))
    assert int(outs[0]["overflow"]) == int(outs[1]["overflow"]) == 0
    np.testing.assert_allclose(outs[0]["image"].detach().numpy(),
                               outs[1]["image"].detach().numpy(), atol=1e-6)
    _assert_grads(grads[0], grads[1], 1e-4)


@pytest.mark.parametrize("tile", [32, 16])
def test_early_stop_off_is_identical(tile):
    """``early_stop=False``: the same tile buffers and pair gradients bit
    for bit (saturated pixels take nothing more), on the hand-made streams
    whose saturating stack stops a tile early."""
    rng = np.random.default_rng(2)
    pairs, start, count = (_t(a) for a in hand_streams(rng, tile=tile))
    kw = dict(ntx=2, tiles_per_view=4, chunk=128, tile=tile)
    on = k1.forward_tiles(pairs, start, count, **kw)
    off = k1.forward_tiles(pairs, start, count, early_stop=False, **kw)
    assert torch.equal(on, off)
    grad = _t(grad_tiles(rng, start.shape[0], tile))
    work_on, work_off = {}, {}
    d_on = k2.backward_tiles_plain(pairs, start, count, on, grad,
                                   work=work_on, **kw)
    d_off = k2.backward_tiles_plain(pairs, start, count, on, grad,
                                    early_stop=False, work=work_off, **kw)
    assert torch.equal(d_on, d_off) and d_on.abs().max() > 0
    assert work_on == work_off


def test_early_stop_off_renders_the_same_image():
    g, cv, cvp = _scene(96)
    cfg, _ = _cfgs(64)
    on, _ = _port_render(g, cv, cvp, cfg)
    off, _ = _port_render(g, cv, cvp, cfg._replace(early_stop=False))
    for k in ("image", "alpha", "depth"):
        assert torch.equal(on[k], off[k]), k


def _plane(n, rng):
    """n small Gaussians on a plane facing the first camera of the rig, at
    depths within 1e-5 of each other: many overlapping pairs that a
    quantised depth key would tie."""
    cv, cvp, cam_pos = orbit_rig(2)
    fwd = -cam_pos[0] / np.linalg.norm(cam_pos[0])
    up = np.array([0.0, 1.0, 0.0])
    right = np.cross(fwd, up)
    right /= np.linalg.norm(right)
    up = np.cross(right, fwd)
    uv = rng.uniform(-0.5, 0.5, (n, 2))
    means = (uv[:, :1] * right + uv[:, 1:] * up
             + rng.uniform(-1e-5, 1e-5, (n, 1)) * fwd)
    g = {"means3d": means.astype(np.float32),
         "scales": np.full((n, 3), 0.03, np.float32),
         "rotations": np.tile(np.eye(3, dtype=np.float32), (n, 1, 1)),
         "colors": rng.uniform(0, 1, (n, 3)).astype(np.float32),
         "opacity": rng.uniform(0.3, 0.9, n).astype(np.float32)}
    return g, cv, cvp


def test_tile16_and_tile32_render_the_same_near_equal_depths():
    """The sort key keeps every depth bit at either tile, so Gaussians at
    near-equal depths composite in the same order: both tilings give the
    JAX package's dense oracle's image (its sort keeps the whole f32 depth;
    the JAX test_tile16_matches_dense tolerance), and so one image."""
    g, cv, cvp = _plane(400, np.random.default_rng(5))
    cfg, _ = _cfgs(64, max_tiles_per_gaussian=16, big_win=10,
                   pair_budget_factor=8)
    t32, _ = _port_render(g, cv, cvp, cfg)
    t16, _ = _port_render(g, cv, cvp, cfg._replace(tile=16))
    assert int(t32["overflow"]) == int(t16["overflow"]) == 0
    assert t32["alpha"].max() > 0.5
    jcov = j_build_cov3d(jnp.asarray(g["scales"]), jnp.asarray(g["rotations"]))
    for v in range(cv.shape[0]):
        ref = j_render_dense(jnp.asarray(g["means3d"]), jcov,
                             jnp.asarray(g["colors"]),
                             jnp.asarray(g["opacity"]), cv[v], cvp[v], TH, TH,
                             64, 64, bg_color=jnp.ones(3), tile_size=0)
        for out in (t32, t16):
            np.testing.assert_allclose(out["image"][v].numpy(),
                                       np.asarray(ref["image"]), atol=5e-5,
                                       rtol=1e-4)
    np.testing.assert_allclose(t16["image"].numpy(), t32["image"].numpy(),
                               atol=5e-5, rtol=1e-4)


def test_bad_knobs_raise():
    g, cv, cvp = _scene(16)
    cfg, _ = _cfgs(32)
    with pytest.raises(ValueError, match="tile must be one of"):
        _port_render(g, cv, cvp, cfg._replace(tile=24))
    with pytest.raises(ValueError, match="MXU passes"):
        _port_render(g, cv, cvp, cfg._replace(cumsum_mode="bf16"))
    with pytest.raises(ValueError, match="tile must be one of"):
        k1.forward_tiles_plain(torch.zeros(128, 16),
                               torch.zeros(1, dtype=torch.int32),
                               torch.zeros(1, dtype=torch.int32), ntx=1,
                               tiles_per_view=1, tile=8)
    s = prepare_pairs(_t(g["means3d"]),
                      build_cov3d(_t(g["scales"]), _t(g["rotations"])),
                      _t(g["colors"]), _t(g["opacity"]), _t(cv), _t(cvp),
                      cfg._replace(tile=16))
    assert s.tile_start.shape[0] == 2 * 4
