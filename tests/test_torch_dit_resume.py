"""The port's DiT trainer state files, the eval loaders and the entry
points' weight flags on CPU, held against the JAX package where it writes
the file (at the small shapes of tests/test_torch_dit_training.py).

* A save in the middle of a gradient accumulation resumes to the same
  weights as a run that was never interrupted.
* A JAX ``DiTTrainer`` state (one step at k = 1, or one micro-step of two
  at k = 2) resumes in the port, and the next step matches the JAX one.
* The eval loaders keep their order and their last partial batch.
* ``inference --vae_ckpt/--dit_ckpt``, ``train_dit --vae_path`` (three
  formats) and ``--sapiens_path`` (a JAX-converted msgpack) load the
  weights ``convert.py`` gives.
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
from safetensors.torch import save_file as save_safetensors

from sigman_release_tpu.config import PRESETS as JPRESETS
from sigman_release_tpu.models.encoders import ViTFeatureEncoder as JViT
from sigman_release_tpu.models.vae import VAEModel as JVAE
from sigman_release_tpu.parallel.mesh import make_mesh, shard_batch
from sigman_release_tpu.training.checkpoint import save_checkpoint
from sigman_release_tpu.training.dit_trainer import DiTTrainer as JTrainer
from sigman_release_torch import convert, inference, train_dit
from sigman_release_torch.config import PRESETS
from sigman_release_torch.data.dataset import SyntheticAvatarDataset
from sigman_release_torch.data.loader import DataLoader
from sigman_release_torch.models.encoders import ViTFeatureEncoder
from sigman_release_torch.models.vae import VAEModel
from sigman_release_torch.training import dit_trainer
from sigman_release_torch.training.dit_trainer import DiTTrainer
from sigman_release_torch.training.vae_trainer import VAETrainer

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_convert import _torch_vae_replica  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OVR = dict(num_views=2, num_input_views=2, batch_size=2,
           num_layers=1, num_attention_heads=2, attention_head_dim=8,
           text_embed_dim=16, time_embed_dim=16,
           sample_height=8, sample_width=8,
           lr_scheduler="constant", lr=1e-3,
           noised_condition_dropout=0.5, gradient_clip=1e4)
JCFG = JPRESETS["test_tiny"].replace(**OVR)
TCFG = PRESETS["test_tiny"].replace(**OVR)
B = 2
# an interrupted accumulation against an uninterrupted one: f32 rounding
RESUME_TOL = 1e-7
# the resumed state against convert.py's output of the JAX one
STATE_TOL = 1e-7
# the step after the resume, as tests/test_torch_dit_training.py holds one
# step: loss relative, gradients relative L2 over all parameters
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
# inference views through the CLI against a pipeline in this process
VIEW_TOL = 1e-6


def _tree(p):
    return jax.tree.map(np.asarray, p)


def _encoded_batch(b, seed):
    rng = np.random.default_rng(seed)
    return {
        "latent": rng.normal(0, 1, (b, TCFG.latent_channels, 8, 8))
        .astype(np.float32),
        "cond": rng.normal(0, 1, (b, TCFG.text_embed_dim, 8, 8))
        .astype(np.float32)}


def _draws(key, b):
    """The JAX train step's draws from its key (1-device mesh)."""
    k_enc, k_t, k_noise, k_drop = jax.random.split(
        jax.random.fold_in(key, 0), 4)
    t = lambda x: torch.from_numpy(np.array(x))  # noqa: E731
    return {
        "t": t(jax.random.randint(k_t, (b,), 0, JCFG.num_train_timesteps)),
        "noise": t(jax.random.normal(k_noise, (b, JCFG.latent_channels, 8, 8))),
        "drop": t(jax.random.bernoulli(k_drop, JCFG.noised_condition_dropout,
                                       (b, 1, 1, 1)))}


def _port(cfg=TCFG):
    return DiTTrainer(cfg, VAEModel(cfg),
                      ViTFeatureEncoder(embed_dim=cfg.text_embed_dim,
                                        depth=1), device="cpu")


def test_resume_keeps_a_partial_accumulation(tmp_path):
    """gradient_accumulation_steps = 2: four micro-steps in one trainer
    against one micro-step, a save, and micro-steps 2-4 in a fresh trainer
    resumed from it (draws from the trainers' generators): every parameter
    within 1e-7, the same counts."""
    cfg = TCFG.replace(gradient_accumulation_steps=2)
    batches = [{n: torch.from_numpy(v) for n, v in
                _encoded_batch(B, s).items()} for s in range(4)]
    whole = _port(cfg)
    for b in batches:
        whole.train_step(b)
    first = _port(cfg)
    first.train_step(batches[0])
    path = str(tmp_path / "dit_state.pt")
    first.save(path)
    resumed = _port(cfg)
    resumed.resume(path)
    for b in batches[1:]:
        resumed.train_step(b)
    assert (resumed.step, resumed.updates, resumed._micro) == \
        (whole.step, whole.updates, whole._micro) == (4, 2, 4)
    for p, q in zip(resumed.model.parameters(), whole.model.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(),
                                   atol=RESUME_TOL, rtol=0)


def test_loader_keeps_order_and_the_last_batch():
    """``shuffle=False, drop_last=False``: the dataset's order every epoch
    and a last batch of the remainder; the length rounds up."""
    data = [{"x": np.full((1,), i, np.float32), "item": f"i{i}"}
            for i in range(7)]
    loader = DataLoader(data, 3, shuffle=False, num_workers=2,
                        drop_last=False)
    assert len(loader) == 3
    for _ in range(2):
        assert [b["item"] for b in loader] == [
            ["i0", "i1", "i2"], ["i3", "i4", "i5"], ["i6"]]


def test_train_dit_eval_loader_keeps_its_four_items():
    """At batch 8 the DiT entry point's eval set of 4 held-out items is one
    batch of 4, in the dataset's order (a dropped partial batch left the
    periodic eval with none)."""
    cfg = PRESETS["test_tiny"].replace(batch_size=8, synthetic_items=8,
                                       num_workers=1)
    _, eval_loader = train_dit.loaders(cfg)
    batches = list(eval_loader)
    held = SyntheticAvatarDataset(cfg, n_items=4, seed=cfg.seed + 999)
    assert len(eval_loader) == 1 and len(batches) == 1
    assert batches[0]["item"] == [held[i]["item"] for i in range(4)]
    np.testing.assert_array_equal(batches[0]["input"][3], held[3]["input"])


@pytest.fixture(scope="module")
def jax_dit():
    """The frozen VAE's parameters of the JAX DiT trainers."""
    key = jax.random.PRNGKey(0)
    s, v = JCFG.input_size, JCFG.num_input_views
    vae_p = jax.jit(JVAE(JCFG).init)({"params": key, "sample": key},
                                     jnp.zeros((1, v, 9, s, s)),
                                     jnp.zeros((1, 3, s, s)), key)
    return vae_p


@pytest.mark.parametrize("k", [1, 2])
def test_resume_from_a_jax_state_and_step_on(jax_dit, k, tmp_path,
                                             monkeypatch):
    """A JAX DiT trainer's state after one (micro-)step, written by its
    ``save_checkpoint`` (at k = 2 the accumulation is partial), resumed by
    the port: weights, Adam moments and count, the accumulated gradient,
    the step counts as ``convert.py`` gives them (1e-7). The next
    (micro-)step with the JAX step's draws: loss 1e-5 relative, the
    gradient of the update against the JAX first moment (k = 1:
    (mu2 - b1 mu1) / (1 - b1); k = 2: mu / (1 - b1) of the first update,
    the mean of both micro-steps), 1e-3 relative L2."""
    cfg, jcfg = (c.replace(gradient_accumulation_steps=k)
                 for c in (TCFG, JCFG))
    jt = JTrainer(jcfg, vae_params=jax_dit, mesh=make_mesh((1,), ("data",)))
    state0 = jt.init_state(jax.random.PRNGKey(2))
    b1, b2 = _encoded_batch(B, 1), _encoded_batch(B, 2)
    key1, key2 = jax.random.PRNGKey(12), jax.random.PRNGKey(13)
    state1, _ = jt.train_step(jax.tree.map(jnp.array, state0),
                              shard_batch(b1, jt.mesh), key1)
    path = str(tmp_path / "dit_state.msgpack")
    save_checkpoint(path, state1)

    tt = _port(cfg)
    tt.resume(path)
    assert (tt.step, tt.updates, tt._micro) == (1, 2 - k, k - 1)
    want = convert.convert_dit(_tree(state1.params), tt.model, cfg)
    for n, p in tt.model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(),
                                   atol=STATE_TOL, rtol=0, err_msg=n)
    leaves = jax.tree.leaves(state1.opt_state,
                             is_leaf=lambda s: isinstance(
                                 s, optax.ScaleByAdamState))
    adam = next(s for s in leaves if isinstance(s, optax.ScaleByAdamState))
    mu1 = convert.convert_dit(_tree(adam.mu), tt.model, cfg)
    for n, p in tt.model.named_parameters():
        st = tt.opt.state[p]
        assert int(st["step"]) == int(adam.count) == 2 - k
        np.testing.assert_allclose(st["exp_avg"].numpy(), mu1[n].numpy(),
                                   atol=STATE_TOL, rtol=0, err_msg=n)
    if k == 2:      # the saved accumulation: the first micro-gradient / 2
        acc = convert.convert_dit(_tree(state1.opt_state.acc_grads),
                                  tt.model, cfg)
        for n, p in tt.model.named_parameters():
            np.testing.assert_allclose(p.grad.numpy(), acc[n].numpy() / 2,
                                       atol=STATE_TOL, rtol=0, err_msg=n)

    state2, jlogs = jt.train_step(jax.tree.map(jnp.array, state1),
                                  shard_batch(b2, jt.mesh), key2)
    pre_clip = []
    real_clip = dit_trainer.clip_by_global_norm_

    def capturing_clip(params, max_norm):
        pre_clip[:] = [p.grad.detach().clone() for p in params]
        return real_clip(params, max_norm)

    monkeypatch.setattr(dit_trainer, "clip_by_global_norm_", capturing_clip)
    logs = tt.train_step(tt.to_device(b2), _draws(key2, B))
    loss = float(jlogs["loss"])
    assert abs(logs["loss"].item() - loss) <= LOSS_RTOL * abs(loss)
    assert tt.updates == 1 + (k == 1) and tt.step == 2
    adam2 = next(s for s in jax.tree.leaves(
        state2.opt_state, is_leaf=lambda s: isinstance(
            s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))
    mu2 = convert.convert_dit(_tree(adam2.mu), tt.model, cfg)
    names = [n for n, _ in tt.model.named_parameters()]
    ref = np.concatenate([
        ((mu2[n].double() - (0.9 * mu1[n].double() if k == 1 else 0.0))
         / 0.1).numpy().ravel() for n in names])
    got = np.concatenate([g.double().numpy().ravel() for g in pre_clip])
    assert np.abs(ref).max() > 0
    assert np.linalg.norm(got - ref) <= GRAD_TOL * np.linalg.norm(ref)


def _jax_vae_vars(cfg):
    key = jax.random.PRNGKey(3)
    s, v = cfg.input_size, cfg.num_input_views
    return _tree(jax.jit(JVAE(cfg).init)({"params": key, "sample": key},
                                         jnp.zeros((1, v, 9, s, s)),
                                         jnp.zeros((1, 3, s, s)), key))


def test_inference_cli_loads_jax_state_files(tmp_path):
    """``python -m sigman_release_torch.inference --device cpu --vae_ckpt
    <msgpack> --dit_ckpt <msgpack>`` (a bare VAE parameter tree and a JAX
    DiT trainer state, both written by the JAX ``save_checkpoint``) renders
    the views of a pipeline loaded through ``convert.py`` with the same
    inputs (1e-6: the same f32 arithmetic in another process)."""
    cfg, jcfg = PRESETS["test_tiny"], JPRESETS["test_tiny"]
    vae_vars = _jax_vae_vars(jcfg)
    jt = JTrainer(jcfg, mesh=make_mesh((1,), ("data",)))
    dit_state = jt.init_state(jax.random.PRNGKey(4))
    vae_ck, dit_ck = str(tmp_path / "vae.msgpack"), str(tmp_path / "dit.msgpack")
    save_checkpoint(vae_ck, vae_vars)
    save_checkpoint(dit_ck, dit_state)
    out = tmp_path / "views"
    steps, seed = 3, 0
    res = subprocess.run(
        [sys.executable, "-m", "sigman_release_torch.inference", "--device",
         "cpu", "--preset", "test_tiny", "--steps", str(steps), "--num_views",
         "2", "--out_dir", str(out), "--vae_ckpt", vae_ck, "--dit_ckpt",
         dit_ck], cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    views = np.load(out / "views.npy")

    pipe = inference.AvatarPipeline(cfg, device="cpu", seed=seed)
    pipe.load_state_dicts(
        vae=convert.convert_vae_decode(vae_vars, pipe.vae, cfg),
        dit=convert.convert_dit(_tree(dit_state.params), pipe.dit, cfg))
    rng = np.random.default_rng(seed)
    image = inference.normalize_image(
        rng.uniform(0, 1, (cfg.input_size, cfg.input_size, 3)),
        cfg.input_size)
    cv, cvp = inference.orbit_rig(cfg, 2)
    gen = torch.Generator().manual_seed(seed + 4)
    ref = pipe(image, None, torch.from_numpy(cv), torch.from_numpy(cvp),
               generator=gen, steps=steps)["render"]["image"][0].numpy()
    assert views.shape == ref.shape
    np.testing.assert_allclose(views, ref, atol=VIEW_TOL, rtol=0)
    assert ref.std() > 0


@pytest.mark.parametrize("fmt", ["port", "msgpack", "safetensors"])
def test_train_dit_vae_path_formats(fmt, tmp_path):
    """``train_dit --vae_path`` reads the VAE trainer's own state file, a
    JAX-written msgpack train state and reference-layout safetensors into
    the frozen VAE: every parameter equal to the file's through
    ``convert.py`` or the reference names."""
    cfg = PRESETS["test_tiny"]
    path = str(tmp_path / f"vae.{fmt}")
    if fmt == "port":
        vt = VAETrainer(cfg.replace(seed=7), device="cpu")
        vt.save(path)
        want = vt.vae.state_dict()
    elif fmt == "msgpack":
        vae_vars = _jax_vae_vars(JPRESETS["test_tiny"])
        save_checkpoint(path, {"params": vae_vars, "logvar": np.zeros(()),
                               "step": 5})
        want = convert.convert_vae(vae_vars, VAEModel(cfg), cfg)
    else:
        torch.manual_seed(5)
        ref = _torch_vae_replica(cfg)
        save_safetensors(dict(ref.state_dict()), path)
        names = convert.reference_key_map(VAEModel(cfg))
        want = {n: ref.state_dict()[r] for n, r in names.items()}
    trainer = train_dit.main(["test_tiny", "--device", "cpu", "--vae_path",
                              path, "--num_epochs", "0", "--synthetic_items",
                              "2", "--num_workers", "1", "--workspace",
                              str(tmp_path / "ws")])
    got = trainer.vae.state_dict()
    assert got.keys() == want.keys()
    for n, t in want.items():
        assert torch.equal(got[n], t), n


def test_sapiens_path_reads_a_msgpack_tree(tmp_path, monkeypatch):
    """``--sapiens_path`` with a JAX-converted msgpack parameter tree of a
    learned-position ViT (a small one in place of Sapiens-1B's 1.1 B
    parameters) loads it through ``convert.py``'s ViT map; a tree missing
    a layer raises."""
    enc = JViT(embed_dim=32, depth=1, heads=4, patch_size=16,
               learned_pos=True, learned_pos_tokens=64)
    variables = _tree(enc.init(jax.random.PRNGKey(0),
                               jnp.zeros((1, 3, 128, 128))))
    monkeypatch.setattr(train_dit, "make_encoder", lambda cfg: (
        ViTFeatureEncoder(embed_dim=32, depth=1, heads=4, patch_size=16,
                          learned_pos=True, learned_pos_tokens=64)))
    path = str(tmp_path / "sapiens.msgpack")
    save_checkpoint(path, variables)
    cfg = TCFG.replace(text_embed_dim=1536, sapiens_path=path)
    got = train_dit.load_encoder(cfg, torch.device("cpu")).state_dict()
    want = convert.convert_vit(variables, train_dit.make_encoder(cfg))
    for n, t in want.items():
        assert torch.equal(got[n], t), n
    del variables["params"]["norm_out"]
    save_checkpoint(path, variables)
    with pytest.raises(ValueError, match="2 encoder parameters missing"):
        train_dit.load_encoder(cfg, torch.device("cpu"))
