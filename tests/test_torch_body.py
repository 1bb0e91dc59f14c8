"""Body-model side of the PyTorch port held against the JAX package on CPU:
the procedural SMPL-X model and template, LBS / SMPL-X forward, parameter
parsing, the Gaussian deformer, and the ops it uses (rodrigues, grid
sampling, KNN). Inputs come from numpy seeds and go through both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigman_release_tpu.body import smplx as jsmplx
from sigman_release_tpu.body import template as jtemplate
from sigman_release_tpu.body.deformer import GaussianDeformer as JDeformer
from sigman_release_tpu.body.lbs import rigid_inverse as j_rigid_inverse
from sigman_release_tpu.ops import grid_sample as jgs
from sigman_release_tpu.ops.knn import knn as j_knn
from sigman_release_tpu.ops.knn import mean_knn_dist2 as j_mean_knn_dist2
from sigman_release_tpu.ops.rotations import rodrigues as j_rodrigues
from sigman_release_torch.body import smplx as tsmplx
from sigman_release_torch.body import template as ttemplate
from sigman_release_torch.body.deformer import GaussianDeformer as TDeformer
from sigman_release_torch.body.lbs import rigid_inverse as t_rigid_inverse
from sigman_release_torch.ops import grid_sample as tgs
from sigman_release_torch.ops.knn import knn as t_knn
from sigman_release_torch.ops.knn import mean_knn_dist2 as t_mean_knn_dist2
from sigman_release_torch.ops.rotations import rodrigues as t_rodrigues

N_VERTS = 512
# f32 LBS through a 55-joint chain of 4x4 products, summed in another order
LBS_ATOL = 1e-5


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def models():
    jm = jsmplx.synthetic_body_model(n_verts=N_VERTS, seed=3)
    tm = tsmplx.synthetic_body_model(n_verts=N_VERTS, seed=3)
    return jm, tm


@pytest.fixture(scope="module")
def templates(models):
    jm, tm = models
    return jtemplate.synthetic_template(jm), ttemplate.synthetic_template(tm)


def test_synthetic_body_model_arrays_identical(models):
    """(e) the same numpy recipe gives bit-identical arrays."""
    jm, tm = models
    for name in jm._fields:
        np.testing.assert_array_equal(_np(getattr(tm, name)),
                                      _np(getattr(jm, name)), err_msg=name)


def test_synthetic_template_matches(models, templates):
    """(e) template arrays: faces exact; the rest derive from one f32 SMPL-X
    forward in each package (rounding-level differences)."""
    jt, tt = templates
    np.testing.assert_array_equal(tt.init_faces, jt.init_faces)
    for name in ("init_spdir", "init_podir", "init_lbsw"):
        np.testing.assert_array_equal(_np(getattr(tt, name)),
                                      _np(getattr(jt, name)), err_msg=name)
    for name in ("init_uv", "init_pcd", "init_rot"):
        np.testing.assert_allclose(_np(getattr(tt, name)),
                                   _np(getattr(jt, name)), atol=1e-5,
                                   err_msg=name)


def _pose_vec(dim, seed=0, scale=0.2):
    return np.random.default_rng(seed).normal(0, scale, (2, dim)) \
        .astype(np.float32)


@pytest.mark.parametrize("dim", [120, 123, 175, 179, 188])
def test_parse_and_smplx_forward_match(models, dim):
    """Every flat parameter layout parses to the same params and poses the
    body to the same verts / joints / A / T."""
    jm, tm = models
    vec = _pose_vec(dim, seed=dim)
    jp = jsmplx.parse_param_vector(jnp.asarray(vec))
    tp = tsmplx.parse_param_vector(torch.from_numpy(vec))
    for name in jp._fields:
        np.testing.assert_allclose(_np(getattr(tp, name)),
                                   np.broadcast_to(_np(getattr(jp, name)),
                                                   _np(getattr(tp, name)).shape),
                                   atol=0, err_msg=name)
    jo = jsmplx.smplx_forward(jm, jp)
    to = tsmplx.smplx_forward(tm, tp)
    for name in jo._fields:
        np.testing.assert_allclose(_np(getattr(to, name)),
                                   _np(getattr(jo, name)), atol=LBS_ATOL,
                                   err_msg=name)


def test_rigid_inverse_and_rodrigues_match():
    rng = np.random.default_rng(0)
    rv = rng.normal(0, 1.0, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(_np(t_rodrigues(torch.from_numpy(rv))),
                               _np(j_rodrigues(jnp.asarray(rv))), atol=1e-6)
    T = np.tile(np.eye(4, dtype=np.float32), (64, 1, 1))
    T[:, :3, :3] = _np(j_rodrigues(jnp.asarray(rv)))
    T[:, :3, 3] = rng.normal(0, 1, (64, 3))
    np.testing.assert_allclose(_np(t_rigid_inverse(torch.from_numpy(T))),
                               _np(j_rigid_inverse(jnp.asarray(T))), atol=1e-6)


def test_grid_sample_matches():
    """2D (border, align_corners=False) and 3D (border, align_corners=True)
    sampling, including out-of-range coordinates."""
    rng = np.random.default_rng(1)
    img = rng.normal(size=(5, 7, 9)).astype(np.float32)
    g2 = rng.uniform(-1.3, 1.3, (11, 13, 2)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tgs.grid_sample_2d(torch.from_numpy(img), torch.from_numpy(g2))),
        _np(jgs.grid_sample_2d(jnp.asarray(img), jnp.asarray(g2))), atol=1e-6)
    vol = rng.normal(size=(4, 5, 6, 7)).astype(np.float32)
    g3 = rng.uniform(-1.2, 1.2, (50, 3)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tgs.grid_sample_3d(torch.from_numpy(vol), torch.from_numpy(g3))),
        _np(jgs.grid_sample_3d(jnp.asarray(vol), jnp.asarray(g3))), atol=1e-6)


def test_knn_matches():
    """Blocked KNN: the same neighbour distances (and sets), also across
    query blocks, and the mean 3-NN distance."""
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(300, 3)).astype(np.float32)
    q = rng.normal(size=(70, 3)).astype(np.float32)
    jd, ji = j_knn(jnp.asarray(q), jnp.asarray(pts), k=10, block=32)
    td, ti = t_knn(torch.from_numpy(q), torch.from_numpy(pts), k=10,
                      block=32)
    np.testing.assert_allclose(_np(td), _np(jd), atol=1e-5)
    assert (np.sort(_np(ti), 1) == np.sort(_np(ji), 1)).mean() > 0.99
    np.testing.assert_allclose(
        _np(t_mean_knn_dist2(torch.from_numpy(pts), block=64)),
        _np(j_mean_knn_dist2(jnp.asarray(pts), block=64)), atol=1e-5)


def test_deformer_matches(models, templates):
    """(e) the baked state, then posed points and per-point transforms.

    The voxel bake takes each voxel centre's 10 nearest vertices; where the
    10th and 11th lie within f32 rounding of each other the two packages
    may pick different ones (a few hundred of the 3.6M weights at this
    size). The deformation itself is held at 1e-5 on one shared baked
    state, and end to end (each package's own bake) at the bake's spread.
    """
    jm, tm = models
    jt, tt = templates
    mask = np.zeros(jt.init_faces.shape[0], bool)
    mask[::7] = True                   # template weights override these
    jd = JDeformer(jm, jt.init_faces, jt.init_spdir, jt.init_podir,
                   jt.init_lbsw, weight_mask=mask)
    td = TDeformer(tm, tt.init_faces, tt.init_spdir, tt.init_podir,
                   tt.init_lbsw, weight_mask=mask)
    js = jd.initialize()
    ts = td.initialize()
    np.testing.assert_allclose(_np(ts.tfs_inv_t), _np(js.tfs_inv_t), atol=1e-5)
    np.testing.assert_allclose(_np(ts.pose_offset_cano),
                               _np(js.pose_offset_cano), atol=1e-6)
    dv = np.abs(_np(ts.lbs_voxel) - _np(js.lbs_voxel))
    assert (dv <= 1e-5).mean() > 0.9999 and dv.max() < 5e-4

    vec = _pose_vec(175, seed=5, scale=0.15)[:1]
    offset = np.random.default_rng(6).normal(0, 0.01, (1,) + tuple(
        jt.init_pcd.shape)).astype(np.float32)
    jpts = jt.init_pcd[None] + jnp.asarray(offset)
    tpts = tt.init_pcd[None] + torch.from_numpy(offset)
    jx, jtf = jd(js, jd.prepare(js, jsmplx.parse_param_vector(
        jnp.asarray(vec))), jpts)
    tposed = td.prepare(tsmplx.parse_param_vector(torch.from_numpy(vec)))
    assert np.abs(_np(jx) - _np(tpts)).max() > 1e-3       # the pose moved them
    shared = ts._replace(lbs_voxel=torch.from_numpy(np.array(js.lbs_voxel)))
    tx, ttf = td(shared, tposed, tpts)
    np.testing.assert_allclose(_np(tx), _np(jx), atol=1e-5)
    np.testing.assert_allclose(_np(ttf), _np(jtf), atol=1e-5)
    tx, ttf = td(ts, tposed, tpts)
    np.testing.assert_allclose(_np(tx), _np(jx), atol=1e-5)
    np.testing.assert_allclose(_np(ttf), _np(jtf), atol=5e-5)
