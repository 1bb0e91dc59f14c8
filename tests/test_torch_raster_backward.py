"""The port's rasterizer backward held against the JAX package on CPU.

Same numpy inputs (tests/utils.py clouds and rigs, 32-64 px, 64-96
Gaussians, chunk 32; the hand-made streams of chip_smoke.py at chunk 128)
go through both packages. The JAX side runs its Pallas kernels in interpret
mode; the port's ``backward_tiles`` takes its plain PyTorch version for CPU
tensors. The CUDA kernel is held against the plain version by
tests/test_torch_cuda.py (``cuda``-marked) and by chip_smoke.py.

Pair-gradient streams are compared per output column, normalised by the
reference column's max |value| (the gradients of one column span many
decades; a per-column scale keeps a small column from hiding under a large
one).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigman_release_tpu.ops.rasterizer import pallas_backward as jbwd
from sigman_release_tpu.ops.rasterizer import pallas_forward as jfwd
from sigman_release_tpu.ops.rasterizer import (
    RasterizeConfig as JRasterizeConfig,
    build_cov3d as j_build_cov3d,
    rasterize_single as j_rasterize_single,
    render_dense as j_render_dense,
)
from sigman_release_torch.ops.rasterizer import backward_tiles as tbwd
from sigman_release_torch.ops.rasterizer import forward_tiles as tfwd
from sigman_release_torch.ops.rasterizer import (
    RasterizeConfig,
    build_cov3d,
    rasterize_single,
)
from sigman_release_torch.ops.rasterizer.reference import render_dense
from sigman_release_torch.ops.rasterizer.render import prepare_pairs

from chip_smoke import hand_streams
from utils import orbit_rig, random_gaussians, tan_half_fov

TH = tan_half_fov()
# plain version vs the Pallas kernel: the same alpha arithmetic (shared
# with forward_tiles_plain), transmittance by exp(cumsum(log)) on both
# sides. The conic columns differ most: the JAX kernel expands tile-local
# moments (-(ml^2 S0 - 2 ml SX + SXX) / 2), which cancel for a mean tens of
# pixels off the tile, while the port sums centred moments (measured
# 5.5e-5 of the column max on the binned scene, < 1e-5 elsewhere)
K2_TOL = 1e-4
# rasterize_single's gradients vs the JAX Pallas path (f32 gradient stream):
# the same algorithm; the per-Gaussian sums run in other orders
PALLAS_GRAD_TOL = 1e-4
# vs the dense oracle: the oracle evaluates the exponent in factored form
# and composites in its own order (test_pallas_rasterizer.py holds the JAX
# kernels to the oracle at 5e-4 the same way)
DENSE_GRAD_TOL = 5e-4


def _t(x):
    return torch.from_numpy(np.array(x))


def _col_err(out, ref):
    """Max over columns of max |out - ref| / max |ref| of the column."""
    scale = np.abs(ref).max(axis=0) + 1e-12
    return float((np.abs(out - ref) / scale).max())


def _jax_tiles(pairs, start, count, ntx, tpv, chunk, grad, view_regions):
    """Pallas forward + backward (interpret) on a [budget,16] stream."""
    budget = pairs.shape[0]
    chunked = jnp.swapaxes(
        jnp.asarray(pairs).reshape(budget // chunk, chunk, 16), 1, 2)
    s, c = jnp.asarray(start, jnp.int32), jnp.asarray(count, jnp.int32)
    fwd = jfwd.forward_tiles(chunked, s, c, n_programs=start.shape[0],
                             ntx_per_view=ntx, tiles_per_view=tpv,
                             chunk=chunk, interpret=True, tile=32)
    d = jbwd.backward_tiles(chunked, s, c, fwd, jnp.asarray(grad),
                            ntx_per_view=ntx, tiles_per_view=tpv, chunk=chunk,
                            interpret=True, out_bf16=False, tile=32,
                            view_regions=view_regions)
    d = np.asarray(jnp.swapaxes(d, 1, 2).reshape(budget, 16))
    return np.asarray(fwd), d


def _port_backward(pairs, start, count, fwd, grad, ntx, tpv, chunk,
                   work=None):
    return tbwd.backward_tiles_plain(
        _t(pairs).float().contiguous(), _t(start).to(torch.int32),
        _t(count).to(torch.int32), _t(fwd), _t(grad), ntx=ntx,
        tiles_per_view=tpv, chunk=chunk, work=work).numpy()


def _grad_tiles(rng, n):
    g = rng.normal(size=(n, 8, 1024)).astype(np.float32)
    g[:, 5:] = 0.0
    return g


def test_backward_plain_matches_pallas_on_hand_streams():
    """Empty tile, chunk-straddling segment, saturating stack, a Gaussian
    centred on a pixel, random segments; seeded upstream gradients."""
    rng = np.random.default_rng(1)
    pairs, start, count = hand_streams(rng)
    grad = _grad_tiles(rng, start.shape[0])
    fwd, ref = _jax_tiles(pairs, start, count, 2, 4, 128, grad, False)
    out = _port_backward(pairs, start, count, fwd, grad, 2, 4, 128)
    assert np.abs(ref[:, :10]).max() > 0
    assert _col_err(out, ref) <= K2_TOL
    # the saturating stack: rows past saturation are exact zeros
    assert (out[start[2] + count[2] - 5:start[2] + count[2]] == 0).all()
    assert (out[:, 10:] == 0).all()


def test_backward_plain_matches_pallas_on_binned_scene():
    """A 2-view, 96-Gaussian scene at 64 px binned by the port (per-view
    regions), chunk 32."""
    g = random_gaussians(96, seed=0)
    cv, cvp, _ = orbit_rig(2)
    cfg = RasterizeConfig(img_h=64, img_w=64, tan_half_fovx=TH,
                          tan_half_fovy=TH, chunk=32)
    cov = build_cov3d(_t(g["scales"]), _t(g["rotations"]))
    s = prepare_pairs(_t(g["means3d"]), cov, _t(g["colors"]),
                      _t(g["opacity"]), _t(cv), _t(cvp), cfg)
    pairs, start, count = (s.pairs.numpy(), s.tile_start.numpy(),
                           s.tile_count.numpy())
    grad = _grad_tiles(np.random.default_rng(2), start.shape[0])
    fwd, ref = _jax_tiles(pairs, start, count, 2, 4, 32, grad, True)
    work_b, work_f = {}, {}
    out = _port_backward(pairs, start, count, fwd, grad, 2, 4, 32, work_b)
    assert _col_err(out, ref) <= K2_TOL
    # the backward's needed evaluations are the forward's
    tfwd.forward_tiles_plain(_t(pairs), _t(start), _t(count), ntx=2,
                             tiles_per_view=4, chunk=32, work=work_f)
    assert work_b == work_f and work_b["contributing"] > 0


def _scene(n=64):
    g = random_gaussians(n, seed=0)
    cv, cvp, cam_pos = orbit_rig(2)
    return g, cv, cvp, cam_pos


def _port_grads(g, cv, cvp, g_img, g_alpha, hw, means=None):
    cfg = RasterizeConfig(img_h=hw, img_w=hw, tan_half_fovx=TH,
                          tan_half_fovy=TH, chunk=32)
    x = [_t(means if means is not None else g["means3d"]).requires_grad_(),
         build_cov3d(_t(g["scales"]), _t(g["rotations"])).detach()
         .requires_grad_(),
         _t(g["colors"]).requires_grad_(), _t(g["opacity"]).requires_grad_()]
    out = rasterize_single(*x, _t(cv), _t(cvp), torch.ones(3), cfg)
    loss = (out["image"] * _t(g_img)).sum() + (out["alpha"] * _t(g_alpha)).sum()
    loss.backward()
    return [t.grad.numpy() for t in x], out


@pytest.fixture(scope="module")
def grad_case():
    g, cv, cvp, _ = _scene()
    rng = np.random.default_rng(0)
    g_img = rng.normal(size=(2, 3, 32, 32)).astype(np.float32)
    g_alpha = rng.normal(size=(2, 1, 32, 32)).astype(np.float32)
    port, _ = _port_grads(g, cv, cvp, g_img, g_alpha, 32)
    args = (jnp.asarray(g["means3d"]),
            j_build_cov3d(jnp.asarray(g["scales"]),
                          jnp.asarray(g["rotations"])),
            jnp.asarray(g["colors"]), jnp.asarray(g["opacity"]))
    jcfg = JRasterizeConfig(img_h=32, img_w=32, tan_half_fovx=TH,
                            tan_half_fovy=TH, chunk=32, interpret=True,
                            grad_stream_bf16=False)

    def loss_pallas(m, c, col, o):
        out = j_rasterize_single(m, c, col, o, cv, cvp, jnp.ones(3), jcfg)
        return jnp.sum(out["image"] * g_img) + jnp.sum(out["alpha"] * g_alpha)

    def loss_dense(m, c, col, o):
        tot = 0.0
        for v in range(2):
            ref = j_render_dense(m, c, col, o, cv[v], cvp[v], TH, TH, 32, 32,
                                 bg_color=jnp.ones(3), tile_size=0)
            tot += (jnp.sum(ref["image"] * g_img[v])
                    + jnp.sum(ref["alpha"] * g_alpha[v]))
        return tot

    pallas = jax.grad(loss_pallas, argnums=(0, 1, 2, 3))(*args)
    dense = jax.grad(loss_dense, argnums=(0, 1, 2, 3))(*args)
    return port, [np.asarray(a) for a in pallas], \
        [np.asarray(a) for a in dense]


@pytest.mark.parametrize("i,name", enumerate(["means3d", "cov3d", "colors",
                                               "opacity"]))
@pytest.mark.parametrize("ref,tol", [("pallas", PALLAS_GRAD_TOL),
                                     ("dense", DENSE_GRAD_TOL)])
def test_rasterize_grads_match_jax(grad_case, i, name, ref, tol):
    """d(loss)/d(means, cov3d, colors, opacity) through projection, binning,
    K1/K2 and the gather's scatter-add, normalised by the reference's max."""
    port, pallas, dense = grad_case
    b = pallas[i] if ref == "pallas" else dense[i]
    a = port[i]
    assert np.isfinite(a).all() and np.abs(b).max() > 0
    scale = np.abs(b).max() + 1e-6
    np.testing.assert_allclose(a / scale, b / scale, atol=tol, err_msg=name)


def test_grads_finite_with_culled_gaussians():
    """Points on / just behind a camera plane keep every gradient finite
    (port of test_pallas_rasterizer.py's culled-Gaussian test)."""
    g, cv, cvp, cam_pos = _scene()
    means = g["means3d"].copy()
    means[0] = cam_pos[0]
    means[1] = cam_pos[1]
    means[2] = cam_pos[0] * (1.0 + 1e-4)
    cfg = RasterizeConfig(img_h=32, img_w=32, tan_half_fovx=TH,
                          tan_half_fovy=TH, chunk=32)
    x = [_t(means).requires_grad_(),
         build_cov3d(_t(g["scales"]), _t(g["rotations"])).detach()
         .requires_grad_(),
         _t(g["colors"]).requires_grad_(), _t(g["opacity"]).requires_grad_()]
    out = rasterize_single(*x, _t(cv), _t(cvp), torch.ones(3), cfg)
    ((out["image"] ** 2).sum() + out["alpha"].sum()
     + out["depth"].sum()).backward()
    for name, t in zip(["means3d", "cov3d", "colors", "opacity"], x):
        assert torch.isfinite(t.grad).all(), name
    assert x[0].grad.abs().max() > 0


def test_render_dense_matches_golden_file():
    """The port's dense oracle against the committed golden renders (fp16
    storage sets the tolerance, as in test_dense_renderer.py)."""
    golden = np.load(os.path.join(os.path.dirname(__file__), "golden",
                                  "dense_render_96g_64px.npz"))
    g = random_gaussians(96, seed=0)
    cov = build_cov3d(_t(g["scales"]), _t(g["rotations"]))
    cv, cvp, _ = orbit_rig(2)
    for v in range(2):
        r = render_dense(_t(g["means3d"]), cov, _t(g["colors"]),
                         _t(g["opacity"]), _t(cv[v]), _t(cvp[v]), TH, TH,
                         64, 64, bg_color=torch.ones(3))
        np.testing.assert_allclose(r["image"].numpy(),
                                   golden[f"image_{v}"].astype(np.float32),
                                   atol=2e-3)
        np.testing.assert_allclose(r["alpha"].numpy(),
                                   golden[f"alpha_{v}"].astype(np.float32),
                                   atol=2e-3)


def test_render_dense_grads_match_jax():
    """The dense oracle is differentiable: its gradients against the JAX
    oracle's (same f32 algorithm; 1e-4 of the max for summation order)."""
    g, cv, cvp, _ = _scene(n=32)
    gi = np.random.default_rng(3).normal(size=(3, 32, 32)).astype(np.float32)
    x = [_t(g["means3d"]).requires_grad_(),
         build_cov3d(_t(g["scales"]), _t(g["rotations"])).detach()
         .requires_grad_(),
         _t(g["colors"]).requires_grad_(), _t(g["opacity"]).requires_grad_()]
    r = render_dense(*x, _t(cv[0]), _t(cvp[0]), TH, TH, 32, 32,
                     bg_color=torch.ones(3))
    ((r["image"] * _t(gi)).sum() + r["alpha"].sum()).backward()

    def loss(m, c, col, o):
        out = j_render_dense(m, c, col, o, cv[0], cvp[0], TH, TH, 32, 32,
                             bg_color=jnp.ones(3))
        return jnp.sum(out["image"] * gi) + jnp.sum(out["alpha"])

    ref = jax.grad(loss, argnums=(0, 1, 2, 3))(
        jnp.asarray(g["means3d"]),
        j_build_cov3d(jnp.asarray(g["scales"]), jnp.asarray(g["rotations"])),
        jnp.asarray(g["colors"]), jnp.asarray(g["opacity"]))
    for t, b in zip(x, ref):
        b = np.asarray(b)
        scale = np.abs(b).max() + 1e-6
        np.testing.assert_allclose(t.grad.numpy() / scale, b / scale,
                                   atol=1e-4)
