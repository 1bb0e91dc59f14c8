"""The port's losses and metrics held against the JAX package on CPU.

The JAX package's seeded initialisations are carried over by ``convert.py``;
inputs are numpy draws handed to both. Everything runs in f32, so the
tolerances (1e-5 unless stated) cover only summation order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigman_release_tpu.config import PRESETS as JPRESETS
from sigman_release_tpu.losses import combined as jcombined
from sigman_release_tpu.losses import gan as jgan
from sigman_release_tpu.losses import metrics as jmetrics
from sigman_release_tpu.losses.lpips import LPIPS as JLPIPS
from sigman_release_tpu.models.vae import DiagonalGaussian as JGaussian
from sigman_release_torch import convert
from sigman_release_torch.config import PRESETS
from sigman_release_torch.losses import combined, gan, metrics
from sigman_release_torch.losses.lpips import LPIPS
from sigman_release_torch.models.vae import DiagonalGaussian

TOL = 1e-5


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(p):
    return jax.tree.map(np.asarray, p)


@pytest.fixture(scope="module")
def lpips_pair():
    jl = JLPIPS()
    x = jnp.zeros((1, 3, 64, 64))
    jp = jl.init(jax.random.PRNGKey(4), x, x)
    tl = LPIPS()
    tl.load_state_dict(convert.convert_lpips(_tree(jp), tl))
    return jl, jp, tl


@pytest.fixture(scope="module")
def disc_pair():
    jd = jgan.PatchDiscriminator(n_layers=2)
    jp = jd.init(jax.random.PRNGKey(3), jnp.zeros((1, 1, 3, 32, 32)))
    td = gan.PatchDiscriminator(n_layers=2)
    td.load_state_dict(convert.convert_disc(_tree(jp), td))
    return jd, jp, td


def test_lpips_matches_jax(lpips_pair):
    jl, jp, tl = lpips_pair
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    ref = np.asarray(jl.apply(jp, jnp.asarray(x), jnp.asarray(y)))
    with torch.no_grad():
        out = tl(_t(x), _t(y)).numpy()
        same = tl(_t(x), _t(x)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    assert (out > 0).all() and np.abs(same).max() < 1e-6


@pytest.mark.parametrize("n_layers,hw", [(2, 32), (4, 64)])
def test_patch_discriminator_matches_jax(n_layers, hw):
    jd = jgan.PatchDiscriminator(n_layers=n_layers)
    jp = jd.init(jax.random.PRNGKey(3), jnp.zeros((1, 1, 3, hw, hw)))
    td = gan.PatchDiscriminator(n_layers=n_layers)
    td.load_state_dict(convert.convert_disc(_tree(jp), td))
    x = np.random.default_rng(1).uniform(0, 1, (1, 2, 3, hw, hw)).astype(
        np.float32)
    ref = np.asarray(jd.apply(jp, jnp.asarray(x)))          # [N,h,w,1]
    with torch.no_grad():
        out = td(_t(x)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=1e-4, atol=TOL)


def test_hinge_losses_match_jax():
    rng = np.random.default_rng(2)
    real = rng.normal(size=(2, 4, 4, 1)).astype(np.float32)
    fake = rng.normal(size=(2, 4, 4, 1)).astype(np.float32)
    np.testing.assert_allclose(
        gan.hinge_d_loss(_t(real), _t(fake)).item(),
        float(jgan.hinge_d_loss(jnp.asarray(real), jnp.asarray(fake))),
        rtol=1e-6)
    np.testing.assert_allclose(gan.hinge_g_loss(_t(fake)).item(),
                               float(jgan.hinge_g_loss(jnp.asarray(fake))),
                               rtol=1e-6)


@pytest.mark.parametrize("src,dst", [(64, 32), (32, 64), (64, 64)])
def test_lpips_resize_matches_jax(src, dst):
    """A 2x downsample must antialias as the JAX resize does; the upsample
    and the identity too."""
    x = np.random.default_rng(3).uniform(0, 1, (2, 3, src, src)).astype(
        np.float32)
    ref = np.asarray(jcombined._resize_for_lpips(jnp.asarray(x), dst))
    out = combined.resize_for_lpips(_t(x), dst).numpy()
    np.testing.assert_allclose(out, ref, atol=1e-6)


def test_metrics_match_jax():
    rng = np.random.default_rng(4)
    a = rng.uniform(0, 1, (2, 3, 32, 32)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    m = (rng.uniform(size=(2, 1, 32, 32)) > 0.3).astype(np.float32)
    np.testing.assert_allclose(metrics.psnr(_t(a), _t(b)).item(),
                               float(jmetrics.psnr(a, b)), rtol=1e-6)
    np.testing.assert_allclose(
        metrics.masked_psnr(_t(a), _t(b), _t(m)).item(),
        float(jmetrics.masked_psnr(a, b, m)), rtol=1e-6)
    np.testing.assert_allclose(metrics.ssim(_t(a), _t(b)).item(),
                               float(jmetrics.ssim(a, b)), rtol=1e-5)
    np.testing.assert_allclose(metrics.ssim(_t(a[0]), _t(b[0])).item(),
                               float(jmetrics.ssim(a[0], b[0])), rtol=1e-5)


def _loss_inputs(seed=5):
    rng = np.random.default_rng(seed)
    shape = (1, 3, 3, 32, 32)
    outputs = {
        "images_pred": rng.uniform(0, 1, shape).astype(np.float32),
        "images_gt": rng.uniform(0, 1, shape).astype(np.float32),
        "masks_gt": (rng.uniform(size=(1, 3, 1, 32, 32)) > 0.5).astype(
            np.float32),
    }
    mean = rng.normal(size=(1, 8, 8, 4)).astype(np.float32)
    logvar = rng.normal(0, 0.5, (1, 8, 8, 4)).astype(np.float32)
    return outputs, mean, logvar


@pytest.mark.parametrize("step", [0, 10])
def test_vae_loss_matches_jax(lpips_pair, disc_pair, step):
    """Generator loss and logs (LPIPS on the 32 -> 64 resize, KL, the
    logvar NLL, the GAN term gated at disc_start=5) and the discriminator
    loss, before and after the gate opens."""
    jl, jlp, tl = lpips_pair
    jd, jdp, td = disc_pair
    jcfg = JPRESETS["test_tiny"].replace(disc_start=5)
    tcfg = PRESETS["test_tiny"].replace(disc_start=5)
    outputs, mean, logvar = _loss_inputs()
    jloss = jcombined.VAELoss(jcfg, lpips_apply=jl.apply, disc_apply=jd.apply)
    jout = {k: jnp.asarray(v) for k, v in outputs.items()}
    jl_val, jlogs = jloss.generator(jout, JGaussian(jnp.asarray(mean),
                                                    jnp.asarray(logvar)),
                                    jnp.int32(step), jnp.float32(0.3),
                                    lpips_params=jlp, disc_params=jdp)
    jd_val, _ = jloss.discriminator(jout, jnp.int32(step), jdp)

    tloss = combined.VAELoss(tcfg, lpips=tl, discriminator=td)
    tout = {k: _t(v) for k, v in outputs.items()}
    with torch.no_grad():
        tl_val, tlogs = tloss.generator(
            tout, DiagonalGaussian(_t(mean), _t(logvar)), step,
            torch.tensor(0.3))
        td_val, _ = tloss.discriminator(tout, step)
    for k in ("L1", "lpips", "kl", "GAN_G", "loss"):
        np.testing.assert_allclose(tlogs[k].item(), float(jlogs[k]),
                                   rtol=TOL, atol=TOL, err_msg=k)
    np.testing.assert_allclose(tl_val.item(), float(jl_val), rtol=TOL)
    if step < 5:
        assert td_val is None and float(jd_val) == 0.0
    else:
        np.testing.assert_allclose(td_val.item(), float(jd_val), rtol=TOL)


def test_diagonal_gaussian_matches_jax():
    _, mean, logvar = _loss_inputs(6)
    noise = np.random.default_rng(7).normal(size=mean.shape).astype(
        np.float32)
    jg = JGaussian(jnp.asarray(mean), jnp.asarray(logvar))
    tg = DiagonalGaussian(_t(mean), _t(logvar))
    np.testing.assert_allclose(tg.kl().numpy(), np.asarray(jg.kl()),
                               rtol=1e-6)
    np.testing.assert_allclose(
        tg.sample(_t(noise)).numpy(),
        mean + np.exp(0.5 * logvar) * noise, rtol=1e-6, atol=1e-6)
