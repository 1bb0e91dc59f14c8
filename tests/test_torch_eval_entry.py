"""The port's evaluation entry points held against the JAX package on the
CPU at ``test_tiny`` (f32).

* ``python -m sigman_release_torch.test_vae`` against ``scripts/test_vae.py``:
  both resume one JAX msgpack state written here and evaluate 4 synthetic
  items; the printed means agree.
* ``inference --eval`` (``inference.run_eval``) against the JAX components
  the JAX ``run_eval`` calls (``DiTTrainer.sample``, ``VAETrainer
  .render_latent``, ``psnr``, ``ssim``, LPIPS) on the same weights and
  noise, with the latents divided by ``vae_scaling_factor`` once: the JAX
  ``run_eval`` itself divides twice (``scripts/test_DiT.py:129``) and is
  not the reference.

Both JAX paths render with the Pallas kernel in interpret mode, the port
with the tile rasterizer's plain versions.
"""

import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigman_release_tpu.config import PRESETS as JPRESETS
from sigman_release_tpu.losses.lpips import LPIPS as JLPIPS
from sigman_release_tpu.losses.metrics import psnr as jpsnr
from sigman_release_tpu.losses.metrics import ssim as jssim
from sigman_release_tpu.models.encoders import ViTFeatureEncoder as JViT
from sigman_release_tpu.models.vae import VAEModel as JVAE
from sigman_release_tpu.parallel.mesh import make_mesh
from sigman_release_tpu.renderer import GaussianRenderer as JRenderer
from sigman_release_tpu.training.checkpoint import save_checkpoint
from sigman_release_tpu.training.dit_trainer import DiTTrainer as JDiTTrainer
from sigman_release_tpu.training.vae_trainer import VAETrainer as JVAETrainer
from sigman_release_torch import convert, inference
from sigman_release_torch import test_vae as ttest_vae
from sigman_release_torch.config import PRESETS
from sigman_release_torch.data.dataset import SyntheticAvatarDataset
from sigman_release_torch.training.vae_trainer import VAETrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the printed means (4 decimals, so half a unit of the last one on top):
# the same f32 networks and metrics, the render through the tile
# rasterizer against the Pallas kernel
MEAN_TOL = 1e-4 + 5e-5
# run_eval's metrics against the JAX components' on the same latents
METRIC_TOL = 1e-4
STEPS = 2


def _tree(p):
    return jax.tree.map(np.asarray, p)


def _printed_means(text):
    """{metric: value} and the batch count of test_vae's last line."""
    line = [ln for ln in text.splitlines() if "batches)" in ln][-1]
    vals = {k: float(v) for k, v in re.findall(r"(\w+) (-?[\d.]+)", line)}
    n = int(re.search(r"\((\d+) batches\)", line).group(1))
    return vals, n


def test_test_vae_matches_the_jax_script(tmp_path, monkeypatch, capsys):
    """Both scripts ``--resume`` one JAX msgpack state (written here by the
    JAX ``save_checkpoint``) and evaluate 4 synthetic items at batch 1; the
    port's LPIPS gets the JAX script's LPIPS weights (they are not in the
    state file). The printed means of psnr, masked psnr, ssim and lpips
    within 1e-4; the first 4 batches' images written."""
    cfg = JPRESETS["test_tiny"]
    jt = JVAETrainer(cfg, interpret=True, mesh=make_mesh((1,), ("data",)))
    state, lpips_params = jt.init_state(jax.random.PRNGKey(0))
    # a state unlike the seeded init of either package
    state = state._replace(params=jax.tree.map(
        lambda p: p * 1.01 + 1e-3, state.params))
    path = str(tmp_path / "vae_state.msgpack")
    save_checkpoint(path, state)
    args = ["test_tiny", "--resume", path, "--num_workers", "1",
            "--mesh_shape", "1"]

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import test_vae as jtest_vae

    monkeypatch.setattr(sys, "argv", ["test_vae.py", *args, "--workspace",
                                      str(tmp_path / "jax")])
    jtest_vae.main()
    ref, n_ref = _printed_means(capsys.readouterr().out)

    lp = _tree(lpips_params)

    class WithJaxLpips(VAETrainer):
        def init(self, seed):
            super().init(seed)
            self.load_state_dicts(lpips=convert.convert_lpips(lp, self.lpips))

    monkeypatch.setattr(ttest_vae, "VAETrainer", WithJaxLpips)
    res = ttest_vae.main([*args, "--device", "cpu", "--workspace",
                          str(tmp_path / "port")])
    out, n = _printed_means(capsys.readouterr().out)
    assert n == n_ref == res["batches"] == 4
    assert set(out) == set(ref) == {"psnr", "masked_psnr", "ssim", "lpips"}
    for k in ref:
        assert abs(out[k] - ref[k]) <= MEAN_TOL, (k, out[k], ref[k])
        assert abs(res[k] - out[k]) <= 5e-5
    for i in range(4):
        assert (tmp_path / "port" / f"eval_vis_{i:02d}.png").exists()


@pytest.fixture(scope="module")
def eval_models():
    """The JAX DiT trainer and VAE trainer on one set of weights, and the
    port's pipeline and LPIPS carrying them (``convert.py``)."""
    jc = JPRESETS["test_tiny"]
    tc = PRESETS["test_tiny"].replace(synthetic_items=2, num_workers=1)
    s, v = jc.input_size, jc.num_input_views
    key = jax.random.PRNGKey(0)
    vae_p = jax.jit(JVAE(jc).init)({"params": key, "sample": key},
                                   jnp.zeros((1, v, 9, s, s)),
                                   jnp.zeros((1, 3, s, s)), key)
    enc_p = jax.jit(JViT(embed_dim=jc.text_embed_dim).init)(
        jax.random.PRNGKey(1), jnp.zeros((1, 3, 64, 64)))
    jdit = JDiTTrainer(jc, vae_params=vae_p, encoder_params=enc_p,
                       mesh=make_mesh((1,), ("data",)))
    dit_state = jdit.init_state(jax.random.PRNGKey(2))
    jvae = JVAETrainer(jc, interpret=True, mesh=make_mesh((1,), ("data",)))
    jvae.renderer = JRenderer(jc, interpret=True, use_dense=False)
    lpips = JLPIPS()
    x = jnp.zeros((1, 3, 32, 32))
    lpips_p = jax.jit(lpips.init)(jax.random.PRNGKey(4), x, x)

    pipe = inference.AvatarPipeline(tc, device="cpu", seed=0)
    pipe.load_state_dicts(
        vae=convert.convert_vae_decode(_tree(vae_p), pipe.vae, tc),
        dit=convert.convert_dit(_tree(dit_state.params), pipe.dit, tc),
        encoder=convert.convert_vit(_tree(enc_p), pipe.encoder))
    tl = inference.seeded_lpips("cpu", 0)
    tl.load_state_dict(convert.convert_lpips(_tree(lpips_p), tl))
    return (jc, jdit, dit_state, jvae, vae_p, lpips, lpips_p), (pipe, tl)


def _jax_noise(jc, i):
    shape = (1, jc.latent_channels, jc.sample_height, jc.sample_width)
    return np.array(jax.random.normal(
        jax.random.fold_in(jax.random.PRNGKey(7), i), shape))


def _jax_eval(models, scale, n=2):
    """The JAX ``run_eval``'s metrics over the port's first ``n`` synthetic
    items, the sampled latents divided by ``scale`` before the decode (1:
    once, as the sampler already divided; ``vae_scaling_factor``: twice)."""
    jc, jdit, dit_state, jvae, vae_p, lpips, lpips_p = models
    data = SyntheticAvatarDataset(PRESETS["test_tiny"], n_items=2)
    out = []
    for i in range(n):
        batch = {k: v[None] for k, v in data[i].items() if k != "item"}
        lat = jdit.sample(dit_state, jnp.asarray(batch["sapiens_input"]),
                          jax.random.fold_in(jax.random.PRNGKey(7), i),
                          num_inference_steps=STEPS)
        z = jnp.moveaxis(lat / scale, 1, -1)
        r = jvae.render_latent(vae_p, z, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        pred, gt = r["images_pred"], r["images_gt"]
        fp = pred.reshape(-1, *pred.shape[2:])
        fg = gt.reshape(-1, *gt.shape[2:])
        out.append({"psnr": float(jpsnr(pred, gt)),
                    "ssim": float(jssim(fp, fg)),
                    "lpips": float(jnp.mean(lpips.apply(
                        lpips_p, fp * 2.0 - 1.0, fg * 2.0 - 1.0)))})
    return out


@pytest.fixture(scope="module")
def jax_once(eval_models):
    return _jax_eval(eval_models[0], 1.0)


def test_run_eval_matches_jax_components(eval_models, jax_once, tmp_path):
    """Per batch (2 synthetic items at batch 1, 2 DDIM steps, JAX's noise):
    PSNR, SSIM and LPIPS within 1e-4 of the JAX components with one
    division; the means and the PNGs of both batches."""
    models, (pipe, tl) = eval_models
    noises = [torch.from_numpy(_jax_noise(models[0], i)) for i in range(2)]
    res = inference.run_eval(pipe, str(tmp_path), eval_batches=2,
                             steps=STEPS, lpips=tl, noises=noises)
    ref = jax_once
    assert len(res["batches"]) == 2 and len(res["ms"]) == 2
    for got, want in zip(res["batches"], ref):
        for k in want:
            assert abs(got[k] - want[k]) <= METRIC_TOL, (k, got[k], want[k])
    for k in ("psnr", "ssim", "lpips"):
        assert res["mean"][k] == pytest.approx(
            np.mean([b[k] for b in res["batches"]]))
    assert (tmp_path / "eval_000.png").exists()
    assert (tmp_path / "eval_001.png").exists()


def test_run_eval_divides_by_the_scaling_factor_once(eval_models, jax_once,
                                                     tmp_path, monkeypatch):
    """The latents reaching the VAE decoder are the sampler's output as it
    is (the sampler divided by ``vae_scaling_factor``): a second division
    would move every metric off the JAX components' one-division values
    and onto their two-division ones."""
    models, (pipe, tl) = eval_models
    noise = torch.from_numpy(_jax_noise(models[0], 0))
    seen = []
    real = pipe.latent_renderer.__call__

    class Spy:
        def __call__(self, z, batch, timer=None):
            seen.append(z.clone())
            return real(z, batch)

    monkeypatch.setattr(pipe, "latent_renderer", Spy())
    res = inference.run_eval(pipe, str(tmp_path), eval_batches=1,
                             steps=STEPS, lpips=tl, noises=[noise])
    cond = torch.from_numpy(
        SyntheticAvatarDataset(PRESETS["test_tiny"], n_items=1)[0]
        ["sapiens_input"][None])
    lat = pipe.sample(cond, noise=noise, steps=STEPS)
    torch.testing.assert_close(seen[0], lat.permute(0, 2, 3, 1), rtol=0,
                               atol=0)
    once = jax_once[0]
    twice = _jax_eval(models, models[0].vae_scaling_factor, n=1)[0]
    got = res["batches"][0]
    assert abs(got["psnr"] - once["psnr"]) <= METRIC_TOL
    assert abs(twice["psnr"] - once["psnr"]) > 100 * METRIC_TOL
