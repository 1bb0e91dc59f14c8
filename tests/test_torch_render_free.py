"""``render_free`` and the modules under it, held against the JAX package on
the CPU: the rays, ``RenderHead`` and
``GaussianRenderer.render_free`` (forward against the JAX ``render_free``
with its Pallas kernel in interpret mode; gradients against ``jax.grad``
through the dense oracle, since interpret-mode Pallas under grad takes
minutes). The port runs K1 / K2's plain versions on CPU tensors; the
kernels are held against them by tests/test_torch_cuda.py and
chip_smoke.py. ``matrix_to_quaternion`` is held against the quaternions
its rotations come from: the JAX package's function does not invert
``quaternion_to_matrix`` (see ``ops/rotations.py``).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigman_release_tpu.config import PRESETS as JPRESETS
from sigman_release_tpu.geometry import rays as jrays
from sigman_release_tpu.models.render_head import RenderHead as JRenderHead
from sigman_release_tpu.ops import rotations as jrot
from sigman_release_tpu.ops.rasterizer import render_dense as j_render_dense
from sigman_release_tpu.renderer import GaussianRenderer as JRenderer
from sigman_release_torch.config import PRESETS
from sigman_release_torch.geometry import rays as trays
from sigman_release_torch.models.render_head import RenderHead
from sigman_release_torch.ops import rotations as trot
from sigman_release_torch.renderer import GaussianRenderer

from test_torch_raster_backward import DENSE_GRAD_TOL
from utils import orbit_rig

# f32 elementwise arithmetic in the same order
ELEM_ATOL = 1e-6
# a render through the port's rasterizer against the JAX Pallas path:
# tests/test_torch_slice.py's SLICE_ATOL (projection and binning in other
# libraries; with the JAX covariances the forward here still differs by
# 5.1e-5 in the image and 1.1e-4 in the depth)
RENDER_ATOL = {"image": 1e-4, "alpha": 1e-4, "depth": 2e-4}
HW = 64
N = 96


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


def _rotations(n, seed=0):
    """(unit quaternions, their rotations) covering every branch of
    Shepperd's method: generic ones, and turns by 178.9-180 degrees about
    each axis (trace near -1, one diagonal term largest)."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    near = []
    for axis in np.eye(3):
        for angle in (np.pi, np.pi - 1e-3, np.pi - 2e-2):
            v = axis + rng.normal(0, 1e-3, 3)
            v /= np.linalg.norm(v)
            near.append(np.concatenate([[math.cos(angle / 2)],
                                        math.sin(angle / 2) * v]))
    q = np.concatenate([q, np.array(near)]).astype(np.float32)
    return q, np.asarray(jrot.quaternion_to_matrix(jnp.asarray(q)))


def test_matrix_to_quaternion_inverts_the_rotation():
    """On rotations that reach all four branches, including turns near
    180 degrees: the quaternion each came from, up to its sign (1e-6), and
    the rotation back through ``quaternion_to_matrix``."""
    q, m = _rotations(200)
    tr = np.trace(m, axis1=1, axis2=2)
    d = np.diagonal(m, axis1=1, axis2=2)
    branch = np.where(tr > 0, 0, np.where(
        (d[:, 0] > d[:, 1]) & (d[:, 0] > d[:, 2]), 1,
        np.where(d[:, 1] > d[:, 2], 2, 3)))
    assert set(branch.tolist()) == {0, 1, 2, 3}
    out = trot.matrix_to_quaternion(_t(m)).numpy()
    sign = np.sign(np.sum(out * q, axis=1, keepdims=True))
    np.testing.assert_allclose(out * sign, q, atol=ELEM_ATOL, rtol=0)
    back = trot.quaternion_to_matrix(_t(out), normalize=False).numpy()
    np.testing.assert_allclose(back, m, atol=ELEM_ATOL, rtol=0)


@pytest.mark.parametrize("opengl", [False, True])
def test_rays_match_jax(opengl):
    cv, _, _ = orbit_rig(3, elevation=20.0)
    for v in range(3):
        c2w = np.linalg.inv(cv[v].T).astype(np.float32)
        for h, w in ((24, 24), (16, 40)):
            o, d = trays.get_rays(_t(c2w), h, w, 0.8, opengl=opengl)
            jo, jd = jrays.get_rays(jnp.asarray(c2w), h, w, 0.8, opengl)
            np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=0)
            np.testing.assert_allclose(d.numpy(), np.asarray(jd),
                                       atol=ELEM_ATOL, rtol=0)
            p = trays.plucker_rays(_t(c2w), h, w, 0.8, opengl=opengl)
            jp = jrays.plucker_rays(jnp.asarray(c2w), h, w, 0.8, opengl)
            assert p.shape == (h, w, 6)
            np.testing.assert_allclose(p.numpy(), np.asarray(jp),
                                       atol=ELEM_ATOL, rtol=0)


def test_render_head_matches_jax():
    x = np.random.default_rng(0).normal(0, 2, (2, 14, 6, 8)).astype(
        np.float32)
    out = RenderHead.decode(_t(x))
    ref = JRenderHead.decode(jnp.asarray(x))
    assert set(out) == set(ref)
    for k in ref:
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=ELEM_ATOL, rtol=0, err_msg=k)
    np.testing.assert_allclose(RenderHead.covariances(out).numpy(),
                               np.asarray(JRenderHead.covariances(ref)),
                               atol=ELEM_ATOL, rtol=0)


def _free_gaussians(seed=0):
    """96 free Gaussians (absolute scales, unit quaternions), batch 1."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(1, N, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return {"position": rng.normal(0, 0.4, (1, N, 3)),
            "opacity": rng.uniform(0.2, 0.95, (1, N)),
            "scale": rng.uniform(0.02, 0.08, (1, N, 3)),
            "rotation": q,
            "rgb": rng.uniform(0, 1, (1, N, 3))}


def _configs():
    return (JPRESETS["test_tiny"].replace(output_size=HW),
            PRESETS["test_tiny"].replace(output_size=HW))


def test_render_free_matches_jax():
    """Image, alpha and depth at 64^2, 2 views, against the JAX
    ``render_free`` (Pallas ``interpret=True``)."""
    jcfg, tcfg = _configs()
    g = _free_gaussians()
    cv, cvp, _ = orbit_rig(2, elevation=10.0)
    ref = JRenderer(jcfg, interpret=True).render_free(
        {k: jnp.asarray(v, jnp.float32) for k, v in g.items()},
        jnp.asarray(cv)[None], jnp.asarray(cvp)[None])
    out = GaussianRenderer(tcfg).render_free(
        {k: _t(v) for k, v in g.items()}, _t(cv)[None], _t(cvp)[None])
    assert int(out["overflow"].sum()) == int(np.asarray(ref["overflow"]).sum())
    for k, atol in RENDER_ATOL.items():
        assert out[k].shape == ref[k].shape, k
        np.testing.assert_allclose(out[k].numpy(), np.asarray(ref[k]),
                                   atol=atol, rtol=0, err_msg=k)
    assert out["alpha"].max() > 0.5


@pytest.fixture(scope="module")
def free_grads():
    """d(sum(image g_img) + sum(alpha g_alpha)) w.r.t. the five inputs: the
    port through K1 / K2's plain versions, JAX through the dense oracle."""
    jcfg, tcfg = _configs()
    g = _free_gaussians(seed=1)
    cv, cvp, _ = orbit_rig(2, elevation=10.0)
    rng = np.random.default_rng(2)
    g_img = rng.normal(size=(2, 3, HW, HW)).astype(np.float32)
    g_alpha = rng.normal(size=(2, 1, HW, HW)).astype(np.float32)
    names = ("position", "scale", "rotation", "opacity", "rgb")

    x = {k: _t(v).requires_grad_() for k, v in g.items()}
    out = GaussianRenderer(tcfg).render_free(x, _t(cv)[None], _t(cvp)[None])
    loss = ((out["image"][0] * _t(g_img)).sum()
            + (out["alpha"][0] * _t(g_alpha)).sum())
    loss.backward()
    port = [x[k].grad.numpy() for k in names]

    th = math.tan(0.5 * jcfg.fovy)

    def loss_dense(pos, scale, rot, opa, rgb):
        cov = JRenderHead.covariances({"scale": scale, "rotation": rot})[0]
        tot = 0.0
        for v in range(2):
            r = j_render_dense(pos[0], cov, rgb[0], opa[0], jnp.asarray(cv[v]),
                               jnp.asarray(cvp[v]), th, th, HW, HW,
                               bg_color=jnp.ones(3), tile_size=0)
            tot += (jnp.sum(r["image"] * g_img[v])
                    + jnp.sum(r["alpha"] * g_alpha[v]))
        return tot

    dense = jax.grad(loss_dense, argnums=tuple(range(5)))(
        *(jnp.asarray(g[k], jnp.float32) for k in names))
    return names, port, [np.asarray(a) for a in dense]


@pytest.mark.parametrize("i", range(5), ids=["position", "scale", "rotation",
                                             "opacity", "rgb"])
def test_render_free_grads_match_dense(free_grads, i):
    """Each input's gradient, normalised by the reference's max, at
    ``DENSE_GRAD_TOL`` (tests/test_torch_raster_backward.py)."""
    names, port, dense = free_grads
    a, b = port[i], dense[i]
    assert a.shape == b.shape and np.isfinite(a).all()
    assert np.abs(b).max() > 0
    scale = np.abs(b).max() + 1e-6
    np.testing.assert_allclose(a / scale, b / scale, atol=DENSE_GRAD_TOL,
                               err_msg=names[i])
