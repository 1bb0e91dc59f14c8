"""Networks and diffusion of the PyTorch port held against the JAX package on
CPU at ``test_tiny``: the VAE decoder + Gaussian heads, the DiT and the ViT
conditioning encoder, each with the JAX package's initialised weights
carried over by ``sigman_release_torch/convert.py``; the attribute sampling
and rotation composition; the DDIM scheduler. f32 throughout
(``mixed_precision="no"``); the networks are held at 1e-4 (f32 convolutions
and matmuls summed in other orders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigman_release_tpu.config import PRESETS as JPRESETS
from sigman_release_tpu.diffusion.ddim import DDIMScheduler as JDDIM
from sigman_release_tpu.models import dit as jdit
from sigman_release_tpu.models import vae as jvae
from sigman_release_tpu.models.encoders import ViTFeatureEncoder as JViT
from sigman_release_torch import convert
from sigman_release_torch.config import PRESETS, Config
from sigman_release_torch.diffusion.ddim import DDIMScheduler
from sigman_release_torch.models import dit as tdit
from sigman_release_torch.models import vae as tvae
from sigman_release_torch.models.encoders import ViTFeatureEncoder

NET_ATOL = 1e-4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def cfgs():
    return JPRESETS["test_tiny"], PRESETS["test_tiny"]


# the port's own fields, for its FLUX denoiser; the JAX package has none
PORT_ONLY = ("denoiser", "num_single_layers", "axes_dim", "rope_theta",
             "guidance_embed", "vec_in_dim", "base_shift", "max_shift")


def test_config_copy_matches(cfgs):
    """Every field of the JAX package's presets is the port's; the port's
    own fields hold their defaults there (the DiT denoiser)."""
    jc, tc = cfgs
    defaults = Config.__dataclass_fields__
    for name in ("dit", "vae_b", "test_tiny"):
        port = dict(PRESETS[name].__dict__)
        for key in PORT_ONLY:
            assert port.pop(key) == defaults[key].default, (name, key)
        assert JPRESETS[name].__dict__ == port


def test_vae_decode_and_heads_match(cfgs):
    """(f) decoder + heads through convert.py, channels-last in and out."""
    jc, tc = cfgs
    rng = np.random.default_rng(0)
    z = rng.normal(size=(2, jc.uv_query_size, jc.uv_query_size,
                         jc.latent_channels)).astype(np.float32)
    jm = jvae.VAEModel(jc)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(z),
                     method=jvae.VAEModel.decode)
    ref = _np(jm.apply(params, jnp.asarray(z), method=jvae.VAEModel.decode))
    tm = tvae.VAEModel(tc, with_encoder=False).eval()
    tm.load_state_dict(convert.convert_vae_decode(_np_tree(params), tm, tc))
    with torch.no_grad():
        out = _np(tm.decode(torch.from_numpy(z)))
    assert out.shape == ref.shape == (2, 64, 64, 13)
    np.testing.assert_allclose(out, ref, atol=NET_ATOL)


def test_sample_attrs_and_compose_rotations_match():
    """(f) UV attribute sampling (y flip, border, align_corners=False) and
    R_def = tfs @ init_rot @ rodrigues(delta)."""
    rng = np.random.default_rng(1)
    amap = rng.uniform(size=(2, 16, 16, 13)).astype(np.float32)
    uv = rng.uniform(-0.05, 1.05, (40, 2)).astype(np.float32)
    ja = jvae.sample_gaussian_attrs(jnp.asarray(amap), jnp.asarray(uv))
    ta = tvae.sample_gaussian_attrs(torch.from_numpy(amap),
                                    torch.from_numpy(uv))
    for k in ja:
        np.testing.assert_allclose(_np(ta[k]), _np(ja[k]), atol=1e-6,
                                   err_msg=k)
    init_rot = rng.normal(size=(40, 3, 3)).astype(np.float32)
    tfs = rng.normal(size=(2, 40, 4, 4)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tvae.compose_rotations(ta["rot"], torch.from_numpy(init_rot),
                                   torch.from_numpy(tfs))),
        _np(jvae.compose_rotations(ja["rot"], jnp.asarray(init_rot),
                                   jnp.asarray(tfs))), atol=1e-5)


@pytest.mark.parametrize("rope", [True, False])
def test_dit_forward_matches(cfgs, rope):
    """(f) DiT forward through convert.py: joint attention with RoPE on the
    image tokens (or the sincos table without it), AdaLN-zero, the
    unpatchify."""
    jc, tc = cfgs
    jc = jc.replace(use_rotary_positional_embeddings=rope)
    tc = tc.replace(use_rotary_positional_embeddings=rope)
    rng = np.random.default_rng(2)
    lat = rng.normal(size=(2, jc.in_channels, jc.sample_height,
                           jc.sample_width)).astype(np.float32)
    cond = rng.normal(size=(2, jc.text_embed_dim, 8, 8)).astype(np.float32)
    t = np.array([999, 17], np.int32)
    jm = jdit.DiTModel(jc)
    params = jm.init(jax.random.PRNGKey(1), jnp.asarray(lat),
                     jnp.asarray(cond), jnp.asarray(t))
    ref = _np(jm.apply(params, jnp.asarray(lat), jnp.asarray(cond),
                       jnp.asarray(t)))
    tm = tdit.DiTModel(tc).eval()
    tm.load_state_dict(convert.convert_dit(_np_tree(params), tm, tc))
    with torch.no_grad():
        out = _np(tm(torch.from_numpy(lat), torch.from_numpy(cond),
                     torch.from_numpy(t)))
    assert out.shape == ref.shape == lat.shape
    np.testing.assert_allclose(out, ref, atol=NET_ATOL)


def test_dit_tables_match():
    """RoPE, sincos and timestep tables are the JAX package's."""
    cj, sj = jdit.rope_2d(16, 4, 4)
    ct, st = tdit.rope_2d(16, 4, 4)
    np.testing.assert_array_equal(ct, _np(cj))
    np.testing.assert_array_equal(st, _np(sj))
    np.testing.assert_array_equal(tdit.sincos_2d(32, 4, 4),
                                  jdit.sincos_2d(32, 4, 4))
    t = np.array([0, 1, 500, 999], np.int32)
    np.testing.assert_allclose(
        _np(tdit.timestep_sinusoid(torch.from_numpy(t), 32)),
        _np(jdit.timestep_sinusoid(jnp.asarray(t), 32)), atol=1e-5)


def test_vit_encoder_matches(cfgs):
    """(f) ViT encoder through convert.py (flax MHA kernels re-laid out;
    the head count drops to 8 at width 32)."""
    jc, tc = cfgs
    rng = np.random.default_rng(3)
    img = rng.normal(size=(2, 3, 64, 64)).astype(np.float32)
    jm = JViT(embed_dim=jc.text_embed_dim)
    params = jm.init(jax.random.PRNGKey(2), jnp.asarray(img))
    ref = _np(jm.apply(params, jnp.asarray(img)))
    tm = ViTFeatureEncoder(embed_dim=tc.text_embed_dim).eval()
    assert tm.blocks[0].attn.heads == 8
    tm.load_state_dict(convert.convert_vit(_np_tree(params), tm))
    with torch.no_grad():
        out = _np(tm(torch.from_numpy(img)))
    assert out.shape == ref.shape == (2, 32, 4, 4)
    np.testing.assert_allclose(out, ref, atol=NET_ATOL)


def test_convert_rejects_a_mismatched_tree(cfgs):
    jc, tc = cfgs
    tm = tvae.VAEModel(tc)
    with pytest.raises(ValueError, match="does not match"):
        convert.convert_vae_decode({"params": {}}, tm, tc)


@pytest.mark.parametrize("spacing", ["trailing", "leading", "linspace"])
@pytest.mark.parametrize("pred", ["v_prediction", "epsilon"])
def test_ddim_matches(spacing, pred):
    """(f) DDIM tables, timesteps and steps (zero-SNR rescale, t_prev = -1
    at the end)."""
    kw = dict(prediction_type=pred, timestep_spacing=spacing)
    js, ts = JDDIM(**kw), DDIMScheduler(**kw)
    np.testing.assert_array_equal(_np(ts.alphas_cumprod),
                                  _np(js.alphas_cumprod))
    steps = ts.timesteps(30)
    assert steps == _np(js.timesteps(30)).tolist()
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    v = rng.normal(size=(2, 4, 8, 8)).astype(np.float32)
    for t, tp in ((steps[0], steps[1]), (steps[-1], -1)):
        np.testing.assert_allclose(
            _np(ts.step(torch.from_numpy(v), t, tp, torch.from_numpy(x))),
            _np(js.step(jnp.asarray(v), jnp.int32(t), jnp.int32(tp),
                        jnp.asarray(x))), atol=1e-6)
