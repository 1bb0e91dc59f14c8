"""Fast-SNARF inverse skinning of the PyTorch port (``body/snarf.py``) held
against the JAX package's ``body/snarf.py`` on the CPU, at voxel res 16:
the same seeded weight voxel, bone transforms and posed points go through
both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigman_release_tpu.body import snarf as jsnarf
from sigman_release_tpu.body.lbs import batch_rigid_transform as j_rigid
from sigman_release_tpu.ops.rotations import rodrigues as j_rodrigues
from sigman_release_torch.body import snarf as tsnarf

J = 55
RES = 16
N_POINTS = 160
# f32 Broyden iterations through trilinear lookups summed in another order:
# solutions that both packages accept agree to this
XC_ATOL = 1e-4
# validity flags are compared on points whose JAX residual and distance
# lie outside these bands around CONV_EPS * 10 and DIVERGE_DIST: inside,
# a rounding-level difference (an LU inverse in another library) may flip
ERR_BAND = (0.5, 2.0)
DIST_BAND = 0.05


def _setup():
    """A smooth seeded weight voxel over 5 bones of a 55-joint chain, bone
    transforms of a moderate seeded pose, the voxel centres, and canonical
    points inside the voxel with their posed images (skinned by the
    trilinear weights)."""
    rng = np.random.default_rng(7)
    d, h, w = RES // 4, RES, RES
    ratio = h / d
    zs, ys, xs = (np.linspace(-1, 1, n) for n in (d, h, w))
    gz, gy, gx = np.meshgrid(zs, ys, xs, indexing="ij")
    grid = np.stack([gx, gy, gz / ratio], -1).reshape(-1, 3).astype(np.float32)
    centres = rng.uniform(-0.8, 0.8, (5, 3)) * [1, 1, 1 / ratio]
    d2 = ((grid[:, None] - centres[None]) ** 2).sum(-1)
    logits = -d2 / 0.15
    wts = np.exp(logits - logits.max(1, keepdims=True))
    wts /= wts.sum(1, keepdims=True)
    lbs = np.zeros((J, d * h * w), np.float32)
    lbs[[0, 1, 2, 4, 5]] = wts.T
    lbs = lbs.reshape(J, d, h, w)
    parents = np.arange(J) - 1
    parents[0] = -1
    joints = rng.uniform(-0.3, 0.3, (1, J, 3)).astype(np.float32)
    pose = rng.normal(0, 0.15, (1, J, 3)).astype(np.float32)
    _, A = j_rigid(j_rodrigues(jnp.asarray(pose)), jnp.asarray(joints),
                   parents)
    tfs = np.asarray(A[0])
    offset = np.zeros((1, 1, 3), np.float32)
    scale = np.float32(1.0)
    xc = rng.uniform(-0.6, 0.6, (N_POINTS, 3)).astype(np.float32)
    xc[:, 2] /= ratio
    # posed images: trilinear weights at xc, blended transforms
    norm = xc * np.array([1, 1, ratio], np.float32)
    from sigman_release_tpu.ops.grid_sample import grid_sample_3d
    wq = np.asarray(grid_sample_3d(jnp.asarray(lbs), jnp.asarray(norm),
                                   align_corners=True)).T         # [N,J]
    T = np.einsum("nj,jik->nik", wq, tfs)
    xd = (np.einsum("nik,nk->ni", T[:, :3, :3], xc) + T[:, :3, 3]) \
        .astype(np.float32)
    return lbs, tfs, grid, offset, scale, ratio, xc, xd


def _both(lbs, tfs, grid, offset, scale, ratio, xd):
    """Each package's (search flags before the filter, x_c, flags after),
    and the JAX search's residual and distance per (point, init)."""
    jargs = [jnp.asarray(a) for a in (lbs, tfs, grid, offset, scale)]
    targs = [torch.from_numpy(np.array(a)) for a in (lbs, tfs, grid, offset,
                                                     scale)]
    jvox = jsnarf.precompute_voxel(*jargs[:3])
    jxc, jraw = jsnarf.broyden_search(jnp.asarray(xd), jvox, jargs[1],
                                      *jargs[3:], ratio)
    tvox = tsnarf.precompute_voxel(*targs[:3])
    txc, traw = tsnarf.broyden_search(torch.from_numpy(xd), tvox, targs[1],
                                      *targs[3:], ratio)
    jxc, txc = np.asarray(jxc), txc.numpy()
    posed, _ = jsnarf._sample_voxels(
        jvox, jnp.asarray(jxc.reshape(-1, 3) * [1.0, 1.0, ratio]))
    err = np.linalg.norm(np.asarray(posed).reshape(jxc.shape)
                         - xd[:, None], axis=-1)
    bones = list(jsnarf.INIT_BONES)
    init = tfs[bones]
    x0 = np.einsum("iba,nib->nia", init[:, :3, :3],
                   xd[:, None] - init[None, :, :3, 3])
    return {"jraw": np.asarray(jraw), "traw": traw.numpy(), "jx": jxc,
            "tx": txc, "err": err, "dist": np.linalg.norm(jxc - x0, axis=-1),
            "jv": np.asarray(jsnarf.filter_duplicates(jnp.asarray(jxc),
                                                      jraw)),
            "tv": tsnarf.filter_duplicates(torch.from_numpy(txc),
                                           traw).numpy()}


@pytest.fixture(scope="module")
def both():
    lbs, tfs, grid, offset, scale, ratio, xc, xd = _setup()
    return _both(lbs, tfs, grid, offset, scale, ratio, xd) | {"xc": xc}


def test_constants_match():
    for name in ("INIT_BONES", "MAX_ITERS", "CONV_EPS", "DIVERGE_DIST",
                 "DUP_EPS"):
        assert getattr(tsnarf, name) == getattr(jsnarf, name), name


def test_precompute_voxel_matches():
    lbs, tfs, grid, *_ = _setup()
    a = jsnarf.precompute_voxel(jnp.asarray(lbs), jnp.asarray(tfs),
                                jnp.asarray(grid))
    b = tsnarf.precompute_voxel(*(torch.from_numpy(np.array(a))
                                  for a in (lbs, tfs, grid)))
    for x, y in zip(a, b):
        np.testing.assert_allclose(y.numpy(), np.asarray(x), atol=1e-6)


def test_inverse_skin_matches_jax(both):
    """x_c within 1e-4 where both packages accept a solution; the search's
    flags (before and after the duplicate filter) equal on every point whose
    residual and distance lie outside the threshold bands; at most 1% of the
    (point, init) flags differ anywhere, and most points are recovered."""
    jx, jv, tx, tv = (both[k] for k in ("jx", "jv", "tx", "tv"))
    err, dist, xc = both["err"], both["dist"], both["xc"]
    both_valid = jv & tv
    assert both_valid.sum() > N_POINTS // 2
    np.testing.assert_allclose(tx[both_valid], jx[both_valid], atol=XC_ATOL)
    thr = jsnarf.CONV_EPS * 10
    clear = (((err < ERR_BAND[0] * thr) | (err > ERR_BAND[1] * thr))
             & (np.abs(dist - jsnarf.DIVERGE_DIST) > DIST_BAND))
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(both["traw"][clear], both["jraw"][clear])
    points_clear = clear.all(axis=1)
    np.testing.assert_array_equal(tv[points_clear], jv[points_clear])
    assert (tv != jv).mean() <= 0.01
    # a valid init recovers the canonical point
    rec = np.linalg.norm(tx - xc[:, None], axis=-1) < 1e-3
    assert (rec & tv).any(axis=1).mean() > 0.5


def test_filter_duplicates_matches():
    rng = np.random.default_rng(3)
    n, i = 64, len(jsnarf.INIT_BONES)
    xc = rng.normal(0, 1, (n, i, 3)).astype(np.float32)
    # clusters: copy some inits onto others, within and outside DUP_EPS
    xc[:, 3] = xc[:, 1] + 5e-5
    xc[:, 7] = xc[:, 2] + 5e-4
    xc[:, 9] = xc[:, 1]
    valid = rng.uniform(size=(n, i)) > 0.3
    a = jsnarf.filter_duplicates(jnp.asarray(xc), jnp.asarray(valid))
    b = tsnarf.filter_duplicates(torch.from_numpy(xc), torch.from_numpy(valid))
    np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_grid_sample_nan_coordinate_gives_nan():
    """A NaN coordinate (a diverged Broyden row) samples NaN in both
    packages; the port's indices stay in range (before, a NaN cast to an
    index out of bounds and raised)."""
    from sigman_release_tpu.ops.grid_sample import grid_sample_3d as jgs
    from sigman_release_torch.ops.grid_sample import grid_sample_3d as tgs

    inp = np.random.default_rng(0).normal(size=(2, 4, 5, 6)).astype(
        np.float32)
    grid = np.array([[0.1, -0.2, 0.3], [np.nan, 0.0, 0.0],
                     [0.0, np.inf, -np.inf]], np.float32)
    a = np.asarray(jgs(jnp.asarray(inp), jnp.asarray(grid)))
    b = tgs(torch.from_numpy(inp), torch.from_numpy(grid)).numpy()
    np.testing.assert_allclose(b, a, atol=1e-6, equal_nan=True)
    assert np.isnan(b[:, 1]).all()
