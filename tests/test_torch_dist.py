"""The port's ``parallel/mesh.py`` against the JAX package's, and its
view-sharded VAE trainer against the JAX trainer on a ('data', 'view')
mesh of (1, 2), on the CPU.

* The rank layout of ``make_mesh`` (two gloo ranks) against the JAX mesh's
  device layout, for meshes (2,) and (1, 2); ``VIEW_SHARDED_KEYS``,
  ``batch_specs`` and the view share of ``shard_batch`` against the JAX
  module's; ``shard_for_host`` against the JAX one with the host given.
* ``prefetch_to_device`` keeps the order and the device; ``initialize_
  multihost`` joins nothing without ``WORLD_SIZE``.
* The port's view-sharded D step and eval (two gloo ranks, one view each)
  against the JAX trainer's on its (1, 2) mesh, to the tolerances the JAX
  package's own test holds its two meshes to (``tests/test_training.py``),
  and the eval to those of ``tests/test_torch_vae_eval.py``, with the GAN
  gate open. The JAX trainer folds the view index into its key, so its two
  view shards render from different posterior draws (the port's view ranks
  share one); here each port rank is handed its JAX shard's draw, so that
  both run the same D step. The draws alone move GAN_D by ~1% at these
  random weights, more than the tolerance.
"""

import jax
import numpy as np
import pytest
import torch

from sigman_release_tpu.config import PRESETS as JPRESETS
from sigman_release_tpu.data import SyntheticAvatarDataset as JDataset
from sigman_release_tpu.data.loader import shard_for_host as jshard_for_host
from sigman_release_tpu.parallel import mesh as jmesh
from sigman_release_tpu.training.vae_trainer import VAETrainer as JTrainer
from sigman_release_torch import convert
from sigman_release_torch.config import PRESETS
from sigman_release_torch.data.loader import shard_for_host
from sigman_release_torch.parallel import launch, mesh
from sigman_release_torch.training.vae_trainer import VAETrainer

OVR = dict(num_views=2, num_input_views=2, attn_dropout=0.0, disc_start=0,
           gradient_clip=1e4)
JCFG = JPRESETS["test_tiny"].replace(**OVR)
TCFG = PRESETS["test_tiny"].replace(**OVR)
LAYOUTS = [((2,), ("data",)), ((1, 2), ("data", "view"))]
# the D step across the two packages' view meshes, as tests/test_training.py
# holds the JAX trainer's two meshes: GAN_D relative, disc weights
GAN_D_RTOL = 2e-3
DISC_ATOL, DISC_RTOL = 1e-5, 1e-3
# eval metrics, as tests/test_torch_vae_eval.py holds eval_step
PSNR_TOL = 1e-3                 # dB, psnr and masked psnr
METRIC_TOL = 1e-4               # ssim, lpips


def _tree(p):
    return jax.tree.map(np.asarray, p)


def _port_mesh(shape, axes, coords):
    return mesh.Mesh(tuple(shape), tuple(axes), tuple(coords),
                     (None,) * len(shape))


def _batch():
    item = JDataset(JCFG, n_items=1)[0]
    return {k: [v] if k == "item" else v[None] for k, v in item.items()}


@pytest.fixture(scope="module")
def port_meshes():
    return launch.run("sigman_release_torch.training.cases:mesh_case", 2,
                      {"layouts": LAYOUTS}, timeout=120)


@pytest.mark.parametrize("i", range(len(LAYOUTS)))
def test_mesh_layout_matches_jax(i, port_meshes):
    """Rank r of two sits where the JAX mesh puts device r (data-major),
    and each axis's group holds the ranks that differ only on it."""
    shape, axes = LAYOUTS[i]
    jm = jmesh.make_mesh(shape, axes, devices=jax.devices()[:2])
    for res in port_meshes:
        got = res[i]
        assert got["shape"] == tuple(jm.devices.shape)
        assert jm.devices[got["coords"]].id == jax.devices()[got["rank"]].id
        for a, ranks in enumerate(got["groups"]):
            line = np.moveaxis(np.arange(2).reshape(shape), a, -1).reshape(
                -1, shape[a])
            assert [list(x) for x in line if got["rank"] in x] == [ranks]


def test_make_mesh_infers_and_rejects():
    """One process: -1 takes the world; a 'model' axis is a layout of its
    own, but not beside 'view', and an unknown axis raises; a shape that
    does not cover the world raises."""
    m = mesh.make_mesh((-1,), ("data",))
    assert (m.shape, m.coords, m.distributed) == ((1,), (0,), False)
    assert mesh.make_mesh((1, -1), ("data", "view")).shape == (1, 1)
    m = mesh.make_mesh((1, -1), ("data", "model"))
    assert (m.shape, m.model_size, m.model_index) == ((1, 1), 1, 0)
    for axes in (("data", "view", "model"), ("data", "pipe")):
        with pytest.raises(ValueError, match="'data' first"):
            mesh.make_mesh((1,) * len(axes), axes)
    with pytest.raises(ValueError, match="does not cover"):
        mesh.make_mesh((2,), ("data",))


@pytest.mark.parametrize("shape,axes", LAYOUTS)
def test_view_keys_and_batch_specs_match_jax(shape, axes):
    batch = _batch()
    assert mesh.VIEW_SHARDED_KEYS == jmesh.VIEW_SHARDED_KEYS
    jm = jmesh.make_mesh(shape, axes, devices=jax.devices()[:2])
    want = {k: tuple(v) for k, v in jmesh.batch_specs(batch, jm).items()}
    assert mesh.batch_specs(batch, _port_mesh(shape, axes, (0,) * len(shape))
                            ) == want


@pytest.mark.parametrize("view", [0, 1])
def test_shard_batch_matches_jax_view_shards(view):
    """On (1, 2), view rank v holds what the JAX mesh puts on device (0,
    v): its view of each view-sharded key, every other array whole; the
    item name is dropped by both."""
    batch = _batch()
    jm = jmesh.make_mesh((1, 2), ("data", "view"), devices=jax.devices()[:2])
    sharded = jmesh.shard_batch(batch, jm)
    dev = jm.devices[0, view]
    got = mesh.shard_batch(batch, _port_mesh((1, 2), ("data", "view"),
                                             (0, view)), "cpu")
    assert set(got) == set(sharded) and "item" not in got
    for k, arr in sharded.items():
        shard = next(s.data for s in arr.addressable_shards if s.device == dev)
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(shard),
                                      err_msg=k)


@pytest.mark.parametrize("host,n", [(0, 2), (1, 2), (2, 3), (0, 1)])
def test_shard_for_host_matches_jax(host, n):
    items = [f"i{k}" for k in range(7)]
    want = jshard_for_host(items, host_id=host, num_hosts=n)
    assert shard_for_host(items, rank=host, world_size=n) == want
    assert shard_for_host(items, mesh=_port_mesh(
        (n, 2), ("data", "view"), (host, 1))) == want


def test_prefetch_to_device_keeps_order_and_device():
    """Batches come out in order, on the device, each rank's views only,
    non-array entries dropped."""
    batches = [{"x": np.full((1, 4, 2), i, np.float32),
                "images_output": np.arange(8, dtype=np.float32).reshape(
                    1, 4, 2) + 10 * i, "item": [f"i{i}"]} for i in range(5)]
    m = _port_mesh((1, 2), ("data", "view"), (0, 1))
    out = list(mesh.prefetch_to_device(iter(batches), m, "cpu", size=2))
    assert [int(b["x"][0, 0, 0]) for b in out] == list(range(5))
    for i, b in enumerate(out):
        assert set(b) == {"x", "images_output"}
        assert b["x"].device.type == "cpu" and b["x"].shape == (1, 4, 2)
        np.testing.assert_array_equal(
            b["images_output"].numpy(), batches[i]["images_output"][:, 2:])


def test_initialize_multihost_is_a_no_op_without_world_size(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert mesh.initialize_multihost("cpu") == torch.device("cpu")
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert mesh.initialize_multihost("cpu") == torch.device("cpu")
    assert not torch.distributed.is_initialized()


def test_rank_seed_folds_the_data_index_only():
    """One process keeps its seed; data indices and steps differ; nothing
    of the view index enters."""
    assert mesh.rank_seed(7) == 7
    seeds = {mesh.rank_seed(7, d, s) for d in range(3) for s in range(3)}
    assert len(seeds) == 9
    assert mesh.rank_seed(7, 1) == mesh.rank_seed(7, 1, 0)


@pytest.fixture(scope="module")
def view_runs():
    """The JAX trainer's eval step and D step on its (1, 2) mesh, and the
    port's two view ranks on the same weights, item and noise."""
    jm = jmesh.make_mesh((1, 2), ("data", "view"), devices=jax.devices()[:2])
    jt = JTrainer(JCFG, interpret=True, mesh=jm)
    key = jax.random.PRNGKey(0)
    state, lp = jt.init_state(key)
    tt = VAETrainer(TCFG, device="cpu")
    weights = {"vae": convert.convert_vae(_tree(state.params), tt.vae, TCFG),
               "disc": convert.convert_disc(_tree(state.disc_params), tt.disc),
               "lpips": convert.convert_lpips(_tree(lp), tt.lpips)}
    sharded = jmesh.shard_batch(_batch(), jm)
    j_eval, _ = jt.eval_step(state, sharded, lp, key)
    # each view shard's posterior draw: the key folded by data 0, view v
    q, c = JCFG.uv_query_size, JCFG.latent_channels
    noise = [np.array(jax.random.normal(jax.random.fold_in(
        jax.random.fold_in(key, 0), v), (1, q, q, c))) for v in range(2)]
    state_d, j_logs = jt.train_step_d(state, sharded, key)   # donates state
    j_disc = convert.convert_disc(_tree(state_d.disc_params), tt.disc)
    port = launch.run(
        "sigman_release_torch.training.cases:vae_case", 2,
        dict(cfg=TCFG, mesh_shape=(1, 2), mesh_axes=("data", "view"),
             items=[0], steps=("d",), noise=noise[0], rank_noise=noise,
             weights=weights,
             eval_items=[0], keep_disc=True), timeout=240)
    return ({k: float(v) for k, v in j_eval.items()},
            float(j_logs["GAN_D"]), j_disc, port)


def test_view_sharded_d_step_matches_jax(view_runs):
    _, j_gan_d, j_disc, port = view_runs
    for r in port:
        assert r["logs"][0]["GAN_D"] == pytest.approx(j_gan_d, rel=GAN_D_RTOL)
        for k, v in j_disc.items():
            np.testing.assert_allclose(r["disc"][k].numpy(), v.numpy(),
                                       atol=DISC_ATOL, rtol=DISC_RTOL,
                                       err_msg=k)


def test_view_sharded_eval_matches_jax(view_runs):
    j_eval, _, _, port = view_runs
    for r in port:
        for k in ("psnr", "masked_psnr"):
            assert abs(r["eval"][f"eval_{k}"] - j_eval[k]) <= PSNR_TOL, k
        for k in ("ssim", "lpips"):
            assert abs(r["eval"][f"eval_{k}"] - j_eval[k]) <= METRIC_TOL, k
