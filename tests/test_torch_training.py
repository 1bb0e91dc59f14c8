"""The port's VAE training slice held against the JAX package on CPU
(``test_tiny``, f32, attention dropout 0).

The JAX package's initialisation is carried over by ``convert.py`` and the
posterior noise is JAX's own draw, handed over as numpy. The JAX trainer
renders with its dense oracle on the CPU (renderer.py); the port renders
through the tile rasterizer's plain versions (K1/K2), which
test_torch_raster_backward.py holds against both the Pallas kernels and the
oracle.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sigman_release_tpu.config import PRESETS as JPRESETS
from sigman_release_tpu.data import SyntheticAvatarDataset as JDataset
from sigman_release_tpu.models.vae import VAEModel as JVAE
from sigman_release_tpu.parallel.mesh import make_mesh, shard_batch
from sigman_release_tpu.training.vae_trainer import VAETrainer as JTrainer
from sigman_release_torch import convert, train_vae
from sigman_release_torch.config import PRESETS
from sigman_release_torch.data.dataset import SyntheticAvatarDataset
from sigman_release_torch.models.vae import VAEModel
from sigman_release_torch.training import vae_trainer
from sigman_release_torch.training.vae_trainer import VAETrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVR = dict(num_views=2, num_input_views=2, attn_dropout=0.0)
JCFG = JPRESETS["test_tiny"].replace(**OVR)
TCFG = PRESETS["test_tiny"].replace(**OVR)
# G-step gradients against JAX's, relative L2 (measured: 5.6e-4 on the
# worst parameter, 1.9e-4 over all, 2e-7 on logvar; the JAX trainer renders
# with its dense oracle, the port with the tile rasterizer). A parameter
# whose gradient is 0 but for rounding (a bias before a norm: < 1e-8 of
# the gradient's norm in both, where the smallest other one is 1.7e-4) is
# held to be as small in the port.
GRAD_LEAF_TOL = 2e-3
GRAD_ALL_TOL = 1e-3
GRAD_ZERO = 1e-6
# disc_start 0 opens the GAN gate; the clip sits above the step's gradient
# norm (~4e3) so that JAX's first Adam moment keeps the gradient's size
STEP_OVR = dict(disc_start=0, gradient_clip=1e4)
TCFG_STEP = TCFG.replace(**STEP_OVR)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tree(p):
    return jax.tree.map(np.asarray, p)


def _vae_inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    s = cfg.input_size
    images = rng.normal(size=(1, cfg.num_input_views, 9, s, s))
    uv = rng.uniform(0, 1, (1, 3, s, s))
    return images.astype(np.float32), uv.astype(np.float32)


@pytest.mark.parametrize("remat", ["block", "none"])
def test_vae_model_matches_jax(remat):
    """Encoder, bottleneck (channel-major UV tokens), posterior sample with
    JAX's noise, decoder and heads: f32 networks summed in other orders
    (1e-4, as tests/test_torch_models.py)."""
    jm = JVAE(JCFG)
    images, uv = _vae_inputs(JCFG)
    key = jax.random.PRNGKey(7)
    jp = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": key},
                          jnp.asarray(images), jnp.asarray(uv), key)
    jmap, jpost = jax.jit(jm.apply)(jp, jnp.asarray(images), jnp.asarray(uv),
                                    key)
    noise = np.array(jax.random.normal(key, jpost.mean.shape))

    tm = VAEModel(TCFG.replace(remat_policy=remat))
    tm.load_state_dict(convert.convert_vae(_tree(jp), tm, TCFG))
    x = [torch.from_numpy(a) for a in (images, uv)]
    tmap, tpost = tm(*x, torch.from_numpy(noise))
    np.testing.assert_allclose(_np(tpost.mean), np.asarray(jpost.mean),
                               atol=1e-4)
    np.testing.assert_allclose(_np(tpost.logvar), np.asarray(jpost.logvar),
                               atol=1e-4)
    np.testing.assert_allclose(_np(tmap), np.asarray(jmap), atol=1e-4)
    # gradients flow through the checkpointed blocks
    tmap.square().mean().backward()
    enc = tm.autoencoder.encoder.conv_in.weight.grad
    assert enc is not None and torch.isfinite(enc).all() and enc.abs().max() > 0


def test_synthetic_dataset_matches_jax():
    """One seed, the same items: the numpy random recipe, the dense-oracle
    renders, the OpenCV-free resizes and warps (1e-4 after the ImageNet
    normalisation's 1/0.225)."""
    cfg_j = JCFG.replace(prob_grid_distortion=1.0, prob_cam_jitter=1.0)
    cfg_t = TCFG.replace(prob_grid_distortion=1.0, prob_cam_jitter=1.0)
    jd = JDataset(cfg_j, n_items=2, seed=3)
    td = SyntheticAvatarDataset(cfg_t, n_items=2, seed=3)
    for idx in (0, 1):
        a, b = jd[idx], td[idx]
        assert a["item"] == b["item"]
        for k in a:
            if k == "item":
                continue
            assert b[k].shape == a[k].shape, k
            np.testing.assert_allclose(b[k], a[k], atol=1e-4, err_msg=k)


@pytest.fixture(scope="module")
def both_trainers():
    mesh = make_mesh((1,), ("data",))
    jt = JTrainer(JCFG.replace(**STEP_OVR), interpret=True, mesh=mesh)
    tt = VAETrainer(TCFG_STEP, device="cpu")
    state, lpips_params = jt.init_state(jax.random.PRNGKey(0))
    tt.load_state_dicts(
        vae=convert.convert_vae(_tree(state.params), tt.vae, TCFG),
        disc=convert.convert_disc(_tree(state.disc_params), tt.disc),
        lpips=convert.convert_lpips(_tree(lpips_params), tt.lpips))
    batch = JDataset(JCFG, n_items=1)[0]
    batch = {k: v[None] for k, v in batch.items() if k != "item"}
    return jt, state, lpips_params, tt, batch, mesh


def _params(tt):
    return [p.detach().clone() for p in tt.params_g]


def _adam_mu(opt_state):
    """The first-moment tree of the JAX trainer's AdamW state."""
    return next(s.mu for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def test_train_steps_match_jax(both_trainers, monkeypatch):
    """One G step (gate open at disc_start=0, so the PatchGAN term is in)
    and one D step from the same state against the JAX trainer: loss at
    1e-4 of the loss's own size (the JAX trainer renders with its dense
    oracle, the port with the tile rasterizer), parameter updates within
    2 lr (Adam's first step is +-lr per element; a gradient whose sign
    differs moves the element the other way) plus f32 rounding, and 99% of
    the elements within 0.1 lr (measured: loss 1.1e-5 relative, carried by
    the 1000-weighted GAN term; L1 1.5e-6).

    Adam's first update carries only the gradient's signs, so the G step's
    gradients are also held against JAX's own: after one step the JAX
    optimizer's first moment is (1 - b1) times the gradient, unclipped
    here. The port's gradients, taken where its clip begins, must match it
    per parameter and over all of them in relative L2."""
    jt, state, lpips_params, tt, batch, mesh = both_trainers
    pre_clip = []
    real_clip = vae_trainer.clip_by_global_norm_

    def capturing_clip(params, max_norm):
        pre_clip[:] = [p.grad.detach().clone() for p in params]
        return real_clip(params, max_norm)

    monkeypatch.setattr(vae_trainer, "clip_by_global_norm_", capturing_clip)
    key = jax.random.PRNGKey(11)
    # the JAX G step folds the mesh index into its key: the posterior draw
    noise = np.asarray(jax.random.normal(
        jax.random.fold_in(key, 0),
        (1, JCFG.uv_query_size, JCFG.uv_query_size, JCFG.latent_channels)))
    p_j0 = [np.asarray(x) for x in jax.tree.leaves(state.params)]
    d_j0 = [np.asarray(x) for x in jax.tree.leaves(state.disc_params)]
    sharded = shard_batch(batch, mesh)
    state_g, jlogs = jt.train_step_g(jax.tree.map(jnp.array, state), sharded,
                                     lpips_params, key)
    state_d, jdlogs = jt.train_step_d(jax.tree.map(jnp.array, state), sharded,
                                      key)

    tb = tt.to_device(batch)
    p0 = _params(tt)
    d0 = [p.detach().clone() for p in tt.disc.parameters()]
    tlogs = tt.train_step_g(tb, torch.from_numpy(noise.copy()))
    loss = float(jlogs["loss"])
    assert abs(tlogs["loss"].item() - loss) <= 1e-4 * abs(loss)
    for k in ("L1", "lpips", "kl"):
        np.testing.assert_allclose(tlogs[k].item(), float(jlogs[k]),
                                   rtol=1e-3, err_msg=k)
    assert tt.step == 1
    lr = TCFG.lr
    t_upd = {n: (p.detach() - q).numpy()
             for (n, p), q in zip(tt.vae.named_parameters(), p0)}
    j_upd = convert.convert_vae(
        jax.tree.map(lambda a, b: np.asarray(a) - b,
                     _tree(state_g.params),
                     jax.tree.unflatten(jax.tree.structure(state.params),
                                        p_j0)), tt.vae, TCFG)
    moved = close = size = 0
    for n, u in t_upd.items():
        ref = j_upd[n].numpy()
        assert np.abs(u - ref).max() <= 2 * lr + 1e-6, n
        moved += int(np.abs(u).max() > 0)
        close += int((np.abs(u - ref) <= 0.1 * lr).sum())
        size += u.size
    assert moved == len(t_upd)
    # only elements whose gradient is near zero may flip (measured 99.95%
    # of the elements within 0.1 lr)
    assert close >= 0.99 * size
    np.testing.assert_allclose(tt.logvar.item(), float(state_g.logvar),
                               atol=2 * lr + 1e-7)
    # gradients: the port's against JAX's first moment / (1 - b1); the
    # clip (1e4) lies above this step's gradient norm, so neither clips
    g_norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g) for g in pre_clip])).item()
    assert g_norm < TCFG_STEP.gradient_clip
    mu_params, mu_logvar = _adam_mu(state_g.opt_state_g)
    j_grad = convert.convert_vae(
        jax.tree.map(lambda m: np.asarray(m) / 0.1, _tree(mu_params)),
        tt.vae, TCFG)
    t_flat, j_flat = [], []
    for (n, _), g in zip(tt.vae.named_parameters(), pre_clip):
        t_g, j_g = g.numpy(), j_grad[n].numpy()
        t_flat.append(t_g.ravel())
        j_flat.append(j_g.ravel())
        j_n = np.linalg.norm(j_g)
        if j_n <= GRAD_ZERO * g_norm:
            # a gradient that is 0 but for rounding (a bias before a norm)
            assert np.linalg.norm(t_g) <= GRAD_ZERO * g_norm, n
        else:
            assert np.linalg.norm(t_g - j_g) <= GRAD_LEAF_TOL * j_n, n
    t_flat, j_flat = np.concatenate(t_flat), np.concatenate(j_flat)
    assert np.linalg.norm(t_flat - j_flat) \
        <= GRAD_ALL_TOL * np.linalg.norm(j_flat)
    np.testing.assert_allclose(pre_clip[-1].item(), float(mu_logvar) / 0.1,
                               rtol=GRAD_LEAF_TOL)
    # the G step leaves the discriminator alone
    for p, q in zip(tt.disc.parameters(), d0):
        assert torch.equal(p, q)

    # D step from the same starting weights
    tt.load_state_dicts(disc=convert.convert_disc(
        jax.tree.unflatten(jax.tree.structure(state.disc_params), d_j0),
        tt.disc))
    with torch.no_grad():
        for p, q in zip(tt.params_g, p0):
            p.copy_(q)
    tdlogs = tt.train_step_d(tb, torch.from_numpy(noise.copy()))
    np.testing.assert_allclose(tdlogs["GAN_D"].item(), float(jdlogs["GAN_D"]),
                               rtol=1e-4)
    for p, q in zip(tt.params_g, p0):
        assert torch.equal(p.detach(), q)           # generator untouched
    t_dupd = {n: (p.detach()).numpy() for n, p in tt.disc.named_parameters()}
    j_d = convert.convert_disc(_tree(state_d.disc_params), tt.disc)
    for n, v in t_dupd.items():
        assert np.abs(v - j_d[n].numpy()).max() <= 2 * lr + 1e-6, n


@pytest.mark.parametrize("kind", ["g", "d"])
def test_optimizers_match_jax_on_identical_grads(both_trainers, kind):
    """Clip-by-global-norm + AdamW, two steps on the same gradients (one
    clipped, one not) as the JAX trainer's optimizer chains: 1e-7."""
    jt, _, _, tt, _, _ = both_trainers
    tt.opt_g.state.clear()
    tt.opt_d.state.clear()
    params = tt.params_g if kind == "g" else list(tt.disc.parameters())
    opt = tt.opt_g if kind == "g" else tt.opt_d
    tx = jt.tx_g if kind == "g" else jt.tx_d
    rng = np.random.default_rng(8)
    vals = [rng.normal(0, 0.1, tuple(p.shape)).astype(np.float32)
            for p in params]
    with torch.no_grad():
        for p, v in zip(params, vals):
            p.copy_(torch.from_numpy(v))
    jp = [jnp.asarray(v) for v in vals]
    opt_state = tx.init(jp)
    update = jax.jit(tx.update)
    clip = TCFG_STEP.gradient_clip
    for scale in (10.0 * clip, 1e-3 * clip):  # norm above the clip, below
        grads = [rng.normal(0, scale / np.sqrt(sum(v.size for v in vals)),
                            v.shape).astype(np.float32) for v in vals]
        for p, g in zip(params, grads):
            p.grad = torch.from_numpy(g.copy())
        tt._micro[kind] = 0
        assert tt._apply(kind, params, opt)
        upd, opt_state = update([jnp.asarray(g) for g in grads],
                                opt_state, jp)
        jp = [a + b for a, b in zip(jp, upd)]
    for p, ref in zip(params, jp):
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(ref),
                                   atol=1e-7, rtol=0)


def test_gradient_accumulation():
    """Two micro-steps at gradient_accumulation_steps=2 on the same batch
    and noise: the parameters hold after the first, and after the second
    equal one step at 1 (the mean of two equal gradients)."""
    cfg = TCFG.replace(lambda_lpips=0.0)
    batch = SyntheticAvatarDataset(cfg, n_items=1)[0]
    batch = {k: v[None] for k, v in batch.items() if k != "item"}
    noise = torch.from_numpy(np.random.default_rng(9).normal(
        size=(1, 8, 8, cfg.latent_channels)).astype(np.float32))
    one = VAETrainer(cfg, device="cpu")
    two = VAETrainer(cfg.replace(gradient_accumulation_steps=2), device="cpu")
    tb = one.to_device(batch)
    p0 = _params(two)
    one.train_step_g(tb, noise)
    two.train_step_g(tb, noise)
    for p, q in zip(two.params_g, p0):
        assert torch.equal(p.detach(), q)
    two.train_step_g(tb, noise)
    for p, q in zip(two.params_g, one.params_g):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=1e-7)
    assert two.step == 2


def test_train_vae_cli_takes_two_steps(tmp_path):
    """``python -m sigman_release_torch.train_vae test_tiny --device cpu``
    trains two steps and logs them."""
    res = subprocess.run(
        [sys.executable, "-m", "sigman_release_torch.train_vae", "test_tiny",
         "--device", "cpu", "--num_epochs", "1", "--synthetic_items", "2",
         "--log_every", "1", "--num_workers", "1",
         "--workspace", str(tmp_path)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "2 steps on cpu" in res.stdout
    rows = (tmp_path / "vae_metrics.jsonl").read_text().splitlines()
    assert len(rows) == 2


def test_train_vae_needs_synthetic_data():
    with pytest.raises(SystemExit, match="synthetic_data"):
        train_vae.main(["vae_b", "--device", "cpu"])


@pytest.mark.parametrize("src,dst", [(32, 64), (256, 512), (37, 20)])
def test_resize_and_remap_match_opencv(src, dst):
    """The OpenCV-free ``_resize`` against ``cv2.resize(INTER_LINEAR)`` (up,
    2x up, down) and the bilinear remap against ``cv2.remap(INTER_LINEAR,
    BORDER_CONSTANT)``: f32 rounding (2e-6)."""
    import cv2

    from sigman_release_torch.data.augment import remap_bilinear
    from sigman_release_torch.data.dataset import _resize

    rng = np.random.default_rng(src)
    img = rng.uniform(0, 1, (3, src, src)).astype(np.float32)
    ref = cv2.resize(img.transpose(1, 2, 0), (dst, dst),
                     interpolation=cv2.INTER_LINEAR).transpose(2, 0, 1)
    np.testing.assert_allclose(_resize(img, dst), ref, atol=2e-6)
    np.testing.assert_allclose(
        _resize(img[0], dst),
        cv2.resize(img[0], (dst, dst), interpolation=cv2.INTER_LINEAR),
        atol=2e-6)
    mx = rng.uniform(-3, src + 3, (dst, dst)).astype(np.float32)
    my = rng.uniform(-3, src + 3, (dst, dst)).astype(np.float32)
    hwc = img.transpose(1, 2, 0).copy()
    np.testing.assert_allclose(
        remap_bilinear(hwc, mx, my),
        cv2.remap(hwc, mx, my, cv2.INTER_LINEAR,
                  borderMode=cv2.BORDER_CONSTANT), atol=2e-6)


def test_loader_batches_shuffles_and_shards():
    """Batches stack items (the item names stay a list), each epoch draws a
    new seeded order, the last partial batch is dropped, and
    ``shard_for_host`` splits items by rank."""
    from sigman_release_torch.data.loader import DataLoader, shard_for_host

    data = [{"x": np.full((2,), i, np.float32), "item": f"i{i}"}
            for i in range(7)]
    loader = DataLoader(data, batch_size=3, num_workers=2, seed=5)
    epochs = [[b for b in loader] for _ in range(2)]
    assert len(loader) == 2 and all(len(e) == 2 for e in epochs)
    b = epochs[0][0]
    assert b["x"].shape == (3, 2) and len(b["item"]) == 3
    orders = [[int(v) for b in e for v in b["x"][:, 0]] for e in epochs]
    assert orders[0] != orders[1] and len(set(orders[0])) == 6
    again = DataLoader(data, batch_size=3, num_workers=1, seed=5)
    assert [int(v) for b in again for v in b["x"][:, 0]] == orders[0]
    assert shard_for_host(range(7), rank=1, world_size=3) == [1, 4]
