"""The port's VAE trainer state files and eval held against the JAX package
on CPU (``test_tiny``, f32, attention dropout 0 where the JAX trainer is
compared).

* A state file the JAX trainer wrote after one G step resumes in the port:
  weights, logvar, discriminator and both Adam moments as ``convert.py``
  gives them, and the next G step matches the JAX trainer's.
* ``eval_step`` matches the JAX trainer's for the VGG16 and AlexNet eval
  nets on the same weights and batch.
* The port's own state file round-trips bit for bit, and ``train_vae
  --resume`` continues from the step it saved.

The JAX trainer renders with its dense oracle on the CPU, the port with the
tile rasterizer's plain versions (tests/test_torch_training.py).
"""

import json
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
from sigman_release_tpu.losses.lpips import LPIPS as JLPIPS
from sigman_release_tpu.parallel.mesh import make_mesh, shard_batch
from sigman_release_tpu.training.checkpoint import save_checkpoint
from sigman_release_tpu.training.vae_trainer import VAETrainer as JTrainer
from sigman_release_torch import convert, train_vae
from sigman_release_torch.config import PRESETS
from sigman_release_torch.data.dataset import SyntheticAvatarDataset
from sigman_release_torch.training import vae_trainer
from sigman_release_torch.training.vae_trainer import VAETrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVR = dict(num_views=2, num_input_views=2, attn_dropout=0.0,
           disc_start=0, gradient_clip=1e4)
JCFG = JPRESETS["test_tiny"].replace(**OVR)
TCFG = PRESETS["test_tiny"].replace(**OVR)
# the resumed state against convert.py's output of the JAX one
STATE_TOL = 1e-7
# the G step after the resume, as tests/test_torch_training.py holds one
# G step: loss relative, gradient relative L2 per parameter and over all
LOSS_RTOL = 1e-4
GRAD_LEAF_TOL = 2e-3
GRAD_ALL_TOL = 1e-3
GRAD_ZERO = 1e-6
# eval metrics against the JAX eval step (dense oracle vs tile rasterizer)
PSNR_TOL = 1e-3                 # dB, psnr and masked psnr
METRIC_TOL = 1e-4               # ssim, lpips


def _tree(p):
    return jax.tree.map(np.asarray, p)


def _adam(opt_state):
    return next(s for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _noise(key):
    """The JAX G step's posterior draw (1-device mesh: fold_in 0)."""
    return np.array(jax.random.normal(
        jax.random.fold_in(key, 0),
        (1, JCFG.uv_query_size, JCFG.uv_query_size, JCFG.latent_channels)))


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """The JAX trainer's state after one G step, written by its
    ``save_checkpoint``, and the batch."""
    mesh = make_mesh((1,), ("data",))
    jt = JTrainer(JCFG, interpret=True, mesh=mesh)
    state, lpips_params = jt.init_state(jax.random.PRNGKey(0))
    batch = JDataset(JCFG, n_items=1)[0]
    batch = {k: v[None] for k, v in batch.items() if k != "item"}
    sharded = shard_batch(batch, mesh)
    state1, _ = jt.train_step_g(state, sharded, lpips_params,
                                jax.random.PRNGKey(11))
    path = str(tmp_path_factory.mktemp("jax_state") / "vae_state.msgpack")
    save_checkpoint(path, state1)
    return jt, state1, lpips_params, batch, sharded, path


def _port_trainer(jt_lpips, cfg=TCFG):
    tt = VAETrainer(cfg, device="cpu")
    tt.load_state_dicts(lpips=convert.convert_lpips(_tree(jt_lpips), tt.lpips))
    return tt


def test_resume_from_a_jax_state_and_step_on(jax_run, monkeypatch):
    """The port's ``resume`` of the JAX state file: VAE weights, logvar,
    discriminator and both Adam moments equal ``convert.py``'s output of
    the JAX state (1e-7; the maps only transpose), the Adam counts and the
    step carry over. The next G step from that state, given the JAX step's
    posterior noise, matches the JAX step: loss 1e-4 relative, gradients
    against (mu2 - b1 mu1) / (1 - b1) of the JAX first moments, 2e-3
    relative L2 per parameter and 1e-3 over all (the clip, 1e4, lies above
    the step's norm)."""
    jt, state1, lp, batch, sharded, path = jax_run
    tt = _port_trainer(lp)
    tt.resume(path)
    want = convert.convert_vae(_tree(state1.params), tt.vae, TCFG)
    for n, p in tt.vae.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=STATE_TOL, err_msg=n)
    assert tt.logvar.item() == pytest.approx(float(state1.logvar),
                                             abs=STATE_TOL)
    want_d = convert.convert_disc(_tree(state1.disc_params), tt.disc)
    for n, p in tt.disc.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_d[n].numpy(),
                                   atol=STATE_TOL, err_msg=n)
    adam = _adam(state1.opt_state_g)
    mu = convert.convert_vae(_tree(adam.mu[0]), tt.vae, TCFG)
    nu = convert.convert_vae(_tree(adam.nu[0]), tt.vae, TCFG)
    for (n, p) in tt.vae.named_parameters():
        st = tt.opt_g.state[p]
        assert int(st["step"]) == int(adam.count) == 1
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu[n].numpy(),
                                   atol=STATE_TOL, err_msg=n)
        np.testing.assert_allclose(st["exp_avg_sq"].numpy(), nu[n].numpy(),
                                   atol=STATE_TOL, err_msg=n)
    st = tt.opt_g.state[tt.logvar]
    assert st["exp_avg"].item() == pytest.approx(float(adam.mu[1]),
                                                 abs=STATE_TOL)
    adam_d = _adam(state1.opt_state_d)
    mu_d = convert.convert_disc(_tree(adam_d.mu), tt.disc)
    for n, p in tt.disc.named_parameters():
        st = tt.opt_d.state[p]
        assert int(st["step"]) == int(adam_d.count) == 0
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu_d[n].numpy(),
                                   atol=STATE_TOL, err_msg=n)
    assert tt.step == 1 and tt._micro == {"g": 0, "d": 0}

    key = jax.random.PRNGKey(12)
    state2, jlogs = jt.train_step_g(jax.tree.map(jnp.array, state1), sharded,
                                    lp, key)
    pre_clip = []
    real_clip = vae_trainer.clip_by_global_norm_

    def capturing_clip(params, max_norm):
        pre_clip[:] = [p.grad.detach().clone() for p in params]
        return real_clip(params, max_norm)

    monkeypatch.setattr(vae_trainer, "clip_by_global_norm_", capturing_clip)
    tlogs = tt.train_step_g(tt.to_device(batch), torch.from_numpy(_noise(key)))
    loss = float(jlogs["loss"])
    assert abs(tlogs["loss"].item() - loss) <= LOSS_RTOL * abs(loss)
    assert tt.step == 2
    mu2 = _adam(state2.opt_state_g).mu
    g2 = jax.tree.map(lambda a, b: (np.asarray(a, np.float64)
                                    - 0.9 * np.asarray(b, np.float64)) / 0.1,
                      mu2[0], adam.mu[0])
    j_grad = convert.convert_vae(jax.tree.map(np.float32, g2), tt.vae, TCFG)
    g_norm = np.sqrt(sum(float((g.double() ** 2).sum()) for g in pre_clip))
    assert g_norm < TCFG.gradient_clip
    t_all, j_all = [], []
    for (n, _), g in zip(tt.vae.named_parameters(), pre_clip):
        t_g, j_g = g.numpy(), j_grad[n].numpy()
        t_all.append(t_g.ravel())
        j_all.append(j_g.ravel())
        j_n = np.linalg.norm(j_g)
        if j_n <= GRAD_ZERO * g_norm:
            assert np.linalg.norm(t_g) <= GRAD_ZERO * g_norm, n
        else:
            assert np.linalg.norm(t_g - j_g) <= GRAD_LEAF_TOL * j_n, n
    t_all, j_all = np.concatenate(t_all), np.concatenate(j_all)
    assert np.linalg.norm(t_all - j_all) <= GRAD_ALL_TOL * np.linalg.norm(
        j_all)


@pytest.mark.parametrize("net", ["vgg", "alex"])
def test_eval_step_matches_jax(jax_run, net, tmp_path):
    """``eval_step`` on the posterior mean against the JAX trainer's on the
    same weights and batch: psnr and masked psnr within 1e-3 dB, ssim and
    lpips within 1e-4, with the loss's VGG16 or an AlexNet eval net;
    ``evaluate`` averages the batches and writes the PNG."""
    jt, state1, lp, batch, sharded, _ = jax_run
    if net == "alex":
        jt = JTrainer(JCFG.replace(eval_lpips_net="alex"), interpret=True,
                      mesh=jt.mesh)
        x = jnp.zeros((1, 3, 64, 64))
        lp = {"loss": lp,
              "eval": JLPIPS(net="alex").init(jax.random.PRNGKey(5), x, x)}
    j_metrics, j_out = jt.eval_step(state1, sharded, lp,
                                    jax.random.PRNGKey(3))
    tt = VAETrainer(TCFG.replace(eval_lpips_net=net), device="cpu")
    eval_lp = lp["eval"] if net == "alex" else lp
    tt.load_state_dicts(
        vae=convert.convert_vae(_tree(state1.params), tt.vae, TCFG),
        lpips_eval=convert.convert_lpips(_tree(eval_lp), tt.lpips_eval))
    assert (tt.lpips_eval is tt.lpips) == (net == "vgg")
    assert tt.lpips_eval.net == net
    metrics, out = tt.eval_step(tt.to_device(batch))
    for k in ("psnr", "masked_psnr"):
        assert abs(metrics[k].item() - float(j_metrics[k])) <= PSNR_TOL, k
    for k in ("ssim", "lpips"):
        assert abs(metrics[k].item() - float(j_metrics[k])) <= METRIC_TOL, k
    assert metrics["lpips"].item() > 0
    vis = str(tmp_path / "eval.png")
    ev = tt.evaluate([batch, batch], vis_path=vis)
    assert os.path.exists(vis)
    for k, v in metrics.items():
        assert ev[f"eval_{k}"] == pytest.approx(v.item(), rel=1e-6), k


def _trainer_state(t: VAETrainer):
    """Every tensor and count a resume must restore, on the host."""
    tensors = [p.detach().clone() for p in t.params_g]
    tensors += [p.detach().clone() for p in t.disc.parameters()]
    for opt in (t.opt_g, t.opt_d):
        for group in opt.param_groups:
            for p in group["params"]:
                tensors += [v.clone() for _, v in
                            sorted(opt.state.get(p, {}).items())]
    grads = [p.grad.clone() if p.grad is not None else None
             for p in [*t.params_g, *t.disc.parameters()]]
    return tensors, grads, (t.step, dict(t._micro)), t.generator.get_state()


@pytest.mark.parametrize("k", [1, 2])
def test_port_state_file_round_trip(k, tmp_path):
    """The port's own file: save after a G and a D step (with k = 2 both
    accumulations are partial), resume into a fresh trainer, then the same
    G, D, G steps in both: every weight, Adam state, gradient sum, count
    and the generator equal bit for bit on the CPU."""
    cfg = PRESETS["test_tiny"].replace(disc_start=0,
                                       gradient_accumulation_steps=k)
    a = VAETrainer(cfg, device="cpu")
    batch = SyntheticAvatarDataset(cfg, n_items=1, seed=4)[0]
    tb = a.to_device({n: v[None] for n, v in batch.items() if n != "item"})
    a.train_step_g(tb)
    a.train_step_d(tb)
    path = str(tmp_path / "vae_state.pt")
    a.save(path)
    saved = _trainer_state(a)
    b = VAETrainer(cfg, device="cpu")
    b.resume(path)
    for t in (a, b):
        t.train_step_g(tb)
        t.train_step_d(tb)
        t.train_step_g(tb)
    sa, sb = _trainer_state(a), _trainer_state(b)
    assert len(sa[0]) == len(sb[0])
    for x, y in zip(sa[0], sb[0]):
        assert torch.equal(x, y)
    for x, y in zip(sa[1], sb[1]):
        assert (x is None and y is None) or torch.equal(x, y)
    assert sa[2] == sb[2] == (5, {"g": 3, "d": 2})
    assert torch.equal(sa[3], sb[3])
    if k == 2:      # the save held both partial accumulations
        assert all(g is not None for g in saved[1])


def test_train_vae_resumes_from_its_state_file(tmp_path):
    """``train_vae test_tiny --device cpu`` writes ``vae_state.pt`` after
    its two steps (with an eval and its PNG); a second run with
    ``--resume`` and two epochs continues at step 3 and ends at 4."""
    base = ["test_tiny", "--device", "cpu", "--synthetic_items", "2",
            "--log_every", "1", "--num_workers", "1", "--eval_steps", "2",
            "--workspace", str(tmp_path)]
    res = subprocess.run(
        [sys.executable, "-m", "sigman_release_torch.train_vae", *base,
         "--num_epochs", "1"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    state = tmp_path / "vae_state.pt"
    assert state.exists() and (tmp_path / "eval_0000002.png").exists()
    assert "best eval" in res.stdout
    saved = torch.load(state, weights_only=True)
    assert saved["step"] == 2
    trainer = train_vae.main(base + ["--num_epochs", "2", "--resume",
                                     str(state)])
    assert trainer.step == 4
    rows = [json.loads(r) for r in
            (tmp_path / "vae_metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3, 4]
    assert sum("eval_psnr" in r for r in rows) == 2
