"""The port's DiT training slice held against the JAX package on CPU (f32),
at the small shapes of tests/test_dit_training.py.

Weights are the JAX package's initialisation carried over by ``convert.py``;
the JAX train step's random draws are rebuilt here from its key
(``fold_in(key, 0)`` on a 1-device mesh, then split into 4) and handed to
the port as ``draws``. The JAX trainer renders with its dense oracle on the
CPU, the port through the tile rasterizer's plain versions.
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
from sigman_release_tpu.diffusion.ddim import DDIMScheduler as JDDIM
from sigman_release_tpu.diffusion.flow_matching import FlowScheduler as JFlow
from sigman_release_tpu.models.encoders import ViTFeatureEncoder as JViT
from sigman_release_tpu.models.vae import VAEModel as JVAE
from sigman_release_tpu.parallel.mesh import make_mesh, shard_batch
from sigman_release_tpu.training.dit_trainer import DiTTrainer as JTrainer
from sigman_release_tpu.training.vae_trainer import VAETrainer as JVAETrainer
from sigman_release_torch import convert
from sigman_release_torch.config import PRESETS
from sigman_release_torch.data.dataset import SyntheticAvatarDataset
from sigman_release_torch.diffusion.ddim import DDIMScheduler
from sigman_release_torch.diffusion.flow_matching import FlowScheduler
from sigman_release_torch.models.dit import DiTModel
from sigman_release_torch.models.encoders import ViTFeatureEncoder
from sigman_release_torch.models.vae import VAEModel
from sigman_release_torch.training import dit_trainer
from sigman_release_torch.training.dit_trainer import DiTTrainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_dit_training.py's shapes; dropout 0.5 so that the step's two
# items take both branches; the clip (1e4) above the step's gradient norm
OVR = dict(num_views=2, num_input_views=2, batch_size=2,
           num_layers=1, num_attention_heads=2, attention_head_dim=8,
           text_embed_dim=16, time_embed_dim=16,
           sample_height=8, sample_width=8,
           lr_scheduler="constant", lr=1e-3,
           noised_condition_dropout=0.5, gradient_clip=1e4)
JCFG = JPRESETS["test_tiny"].replace(**OVR)
TCFG = PRESETS["test_tiny"].replace(**OVR)
B = 2
STEP_KEY = 12            # its dropout draw is [False, True]
# the step's loss: the same f32 networks summed in other orders
LOSS_RTOL = 1e-5
# gradients against JAX's first Adam moment / (1 - b1), relative L2
GRAD_TOL = 1e-3
# the rendered sample: the port's tile rasterizer against the JAX dense
# oracle (test_torch_raster_backward.py's DENSE tolerance)
RENDER_ATOL = 5e-4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _tree(p):
    return jax.tree.map(np.asarray, p)


def _t(x):
    return torch.from_numpy(np.array(x))


def _jax_draws(key, cfg, b):
    """The JAX train step's draws from its key (1-device mesh)."""
    k_enc, k_t, k_noise, k_drop = jax.random.split(
        jax.random.fold_in(key, 0), 4)
    q = cfg.uv_query_size
    return {
        "enc_noise": _t(jax.random.normal(k_enc, (b, q, q,
                                                  cfg.latent_channels))),
        "t": _t(jax.random.randint(k_t, (b,), 0, cfg.num_train_timesteps)),
        "noise": _t(jax.random.normal(
            k_noise, (b, cfg.latent_channels, cfg.sample_height,
                      cfg.sample_width))),
        "drop": _t(jax.random.bernoulli(k_drop, cfg.noised_condition_dropout,
                                        (b, 1, 1, 1))),
    }


def _adam_mu(opt_state):
    return next(s.mu for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _raw_batch(cfg, b, seed=0):
    rng = np.random.default_rng(seed)
    s, v = cfg.input_size, cfg.num_input_views
    return {
        "input": rng.normal(0, 1, (b, v, 9, s, s)).astype(np.float32),
        "UV_inital": rng.uniform(0, 1, (b, 3, s, s)).astype(np.float32),
        "sapiens_input": rng.normal(0, 1, (b, 3, s, s)).astype(np.float32),
    }


def _encoded_batch(cfg, b, seed=1):
    rng = np.random.default_rng(seed)
    return {
        "latent": rng.normal(0, 1, (b, cfg.latent_channels,
                                    cfg.sample_height, cfg.sample_width))
        .astype(np.float32),
        "cond": rng.normal(0, 1, (b, cfg.text_embed_dim, 8, 8))
        .astype(np.float32),
    }


@pytest.fixture(scope="module")
def both():
    """The JAX DiT trainer and the port's, on one set of weights."""
    key = jax.random.PRNGKey(0)
    s, v = JCFG.input_size, JCFG.num_input_views
    vae_p = jax.jit(JVAE(JCFG).init)({"params": key, "sample": key},
                                     jnp.zeros((1, v, 9, s, s)),
                                     jnp.zeros((1, 3, s, s)), key)
    enc = JViT(embed_dim=JCFG.text_embed_dim, depth=1, heads=2,
               patch_size=16)
    enc_p = jax.jit(enc.init)(jax.random.PRNGKey(1),
                              jnp.zeros((1, 3, 64, 64)))
    jt = JTrainer(JCFG, vae_params=vae_p, encoder_params=enc_p,
                  mesh=make_mesh((1,), ("data",)))
    jt.encoder = enc        # the JAX trainer's own encoder is depth 8
    state = jt.init_state(jax.random.PRNGKey(2))

    vae = VAEModel(TCFG)
    vae.load_state_dict(convert.convert_vae(_tree(vae_p), vae, TCFG))
    tenc = ViTFeatureEncoder(embed_dim=TCFG.text_embed_dim, depth=1,
                             heads=2, patch_size=16)
    tt = DiTTrainer(TCFG, vae, tenc,
                    convert.convert_vit(_tree(enc_p), tenc), device="cpu")
    dit_sd = convert.convert_dit(_tree(state.params), tt.model, TCFG)
    tt.model.load_state_dict(dit_sd)
    return jt, state, tt, vae_p, dit_sd


# ---- schedulers --------------------------------------------------------------

def test_ddim_training_side_matches_jax():
    """add_noise, get_velocity and snr_weights over every timestep of the
    dit preset's schedule (zero-terminal-SNR rescale): 1e-6; the weight is
    1 at the zero-SNR last step and ~1.2e3 at t = 0."""
    cfg = PRESETS["dit"]
    js, ts = JDDIM(**{k: getattr(cfg, k) for k in (
        "num_train_timesteps", "beta_start", "beta_end", "beta_schedule",
        "prediction_type", "rescale_betas_zero_snr", "snr_shift_scale",
        "timestep_spacing")}), DDIMScheduler.from_config(cfg)
    rng = np.random.default_rng(0)
    t = np.arange(1000, dtype=np.int32)
    x0 = rng.normal(size=(1000, 3, 2, 2)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    for name in ("add_noise", "get_velocity"):
        ref = np.asarray(getattr(js, name)(jnp.asarray(x0),
                                           jnp.asarray(noise),
                                           jnp.asarray(t)))
        out = _np(getattr(ts, name)(_t(x0), _t(noise), _t(t).long()))
        np.testing.assert_allclose(out, ref, atol=1e-6, err_msg=name)
    w_ref = np.asarray(js.snr_weights(jnp.asarray(t)))
    w = _np(ts.snr_weights(_t(t).long()))
    np.testing.assert_allclose(w, w_ref, rtol=1e-6)
    assert w[-1] == 1.0 and 1.1e3 < w[0] < 1.3e3


def test_flow_scheduler_matches_jax():
    """shift_t, add_noise, the velocity target, timesteps and the Euler
    step at shift 3 (1e-6); ``sample_t`` with a zero logit spread is the
    shifted sigmoid of the mean on both sides, and else lies in (0, 1)."""
    js, ts = JFlow(shift=3.0), FlowScheduler(shift=3.0)
    rng = np.random.default_rng(1)
    u = rng.uniform(0.01, 0.99, 7).astype(np.float32)
    x0 = rng.normal(size=(7, 2, 3)).astype(np.float32)
    noise = rng.normal(size=x0.shape).astype(np.float32)
    np.testing.assert_allclose(_np(ts.shift_t(_t(u))),
                               np.asarray(js.shift_t(jnp.asarray(u))),
                               atol=1e-6)
    np.testing.assert_allclose(
        _np(ts.add_noise(_t(x0), _t(noise), _t(u))),
        np.asarray(js.add_noise(jnp.asarray(x0), jnp.asarray(noise),
                                jnp.asarray(u))), atol=1e-6)
    np.testing.assert_allclose(
        _np(ts.velocity_target(_t(x0), _t(noise))),
        np.asarray(js.velocity_target(jnp.asarray(x0), jnp.asarray(noise))),
        atol=1e-6)
    np.testing.assert_allclose(_np(ts.timesteps(5)),
                               np.asarray(js.timesteps(5)), atol=1e-6)
    np.testing.assert_allclose(
        _np(ts.step(_t(noise), 0.7, 0.4, _t(x0))),
        np.asarray(js.step(jnp.asarray(noise), 0.7, 0.4, jnp.asarray(x0))),
        atol=1e-6)
    g = torch.Generator().manual_seed(0)
    np.testing.assert_allclose(
        _np(ts.sample_t(4, g, logit_mean=0.3, logit_std=0.0)),
        np.asarray(js.sample_t(jax.random.PRNGKey(0), 4, logit_mean=0.3,
                               logit_std=0.0)), atol=1e-6)
    t = ts.sample_t(1000, g)
    assert t.shape == (1000,) and ((t > 0) & (t < 1)).all()


# ---- encoders ------------------------------------------------------------------

@pytest.mark.parametrize("size", [128, 64, 96])
def test_learned_pos_encoder_matches_jax(size):
    """A learned 8 x 8 position table on its own grid (128^2 / 16) and
    resized to 4 x 4 and 6 x 6 (antialiased bilinear, as
    ``jax.image.resize``): 1e-5."""
    enc = JViT(embed_dim=32, depth=1, heads=4, patch_size=16,
               learned_pos=True, learned_pos_tokens=64)
    p = enc.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 128, 128)))
    x = np.random.default_rng(size).normal(
        size=(2, 3, size, size)).astype(np.float32)
    ref = np.asarray(enc.apply(p, jnp.asarray(x)))
    tm = ViTFeatureEncoder(embed_dim=32, depth=1, heads=4, patch_size=16,
                           learned_pos=True, learned_pos_tokens=64)
    tm.load_state_dict(convert.convert_vit(_tree(p), tm))
    with torch.no_grad():
        out = _np(tm(_t(x)))
    assert out.shape == (2, 32, size // 16, size // 16)
    np.testing.assert_allclose(out, ref, atol=1e-5)


def test_sapiens_1b_geometry():
    """sapiens_1b_encoder: width 1536, depth 40, 24 heads, a 64 x 64
    learned table; 1.14 B parameters (built on the meta device)."""
    from sigman_release_torch.models.encoders import sapiens_1b_encoder

    with torch.device("meta"):
        enc = sapiens_1b_encoder()
    assert len(enc.blocks) == 40 and enc.blocks[0].attn.heads == 24
    assert tuple(enc.pos_embed.shape) == (1, 4096, 1536)
    n = sum(p.numel() for p in enc.parameters())
    assert 1.13e9 < n < 1.15e9


# the mmpretrain-style oracle of tests/test_sapiens_convert.py, copied, with
# mmpretrain's own names (``ffn.layers.0.0``, the final ``ln1``, the
# ``backbone.`` prefix) so that a traced copy carries them too
D, HEADS, DEPTH, P = 32, 4, 2, 16
GRID = 4  # 64^2 input / patch 16


def _torch_vit():
    import torch.nn as tnn
    import torch.nn.functional as tF

    class Block(tnn.Module):
        def __init__(self):
            super().__init__()
            self.ln1 = tnn.LayerNorm(D)
            self.attn = tnn.Module()
            self.attn.qkv = tnn.Linear(D, 3 * D)
            self.attn.proj = tnn.Linear(D, D)
            self.ln2 = tnn.LayerNorm(D)
            self.ffn = tnn.Module()
            self.ffn.layers = tnn.ModuleList(
                [tnn.Sequential(tnn.Linear(D, 4 * D)), tnn.Linear(4 * D, D)])

        def forward(self, x):
            h = self.ln1(x)
            b, n, _ = h.shape
            qkv = self.attn.qkv(h).view(b, n, 3, HEADS, D // HEADS)
            q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
            o = tF.scaled_dot_product_attention(q, k, v)
            o = o.transpose(1, 2).reshape(b, n, D)
            x = x + self.attn.proj(o)
            h = self.ln2(x)
            h = self.ffn.layers[1](tF.gelu(self.ffn.layers[0](h)))
            return x + h

    class ViT(tnn.Module):
        def __init__(self):
            super().__init__()
            self.patch_embed = tnn.Module()
            self.patch_embed.projection = tnn.Conv2d(3, D, P, stride=P)
            self.pos_embed = tnn.Parameter(
                torch.randn(1, GRID * GRID, D) * 0.02)
            self.layers = tnn.ModuleList([Block() for _ in range(DEPTH)])
            self.ln1 = tnn.LayerNorm(D)

        def forward(self, x):
            x = self.patch_embed.projection(x)
            x = x.flatten(2).transpose(1, 2) + self.pos_embed
            for blk in self.layers:
                x = blk(x)
            return self.ln1(x)

    class Model(tnn.Module):
        def __init__(self):
            super().__init__()
            self.backbone = ViT()

        def forward(self, x):
            return self.backbone(x)

    return Model().eval()


@pytest.mark.parametrize("source", ["state_dict", "torchscript"])
def test_sapiens_convert_matches_oracle(source, tmp_path):
    """``convert_sapiens`` maps the mmpretrain-style oracle (read from a
    saved state dict with a class-token position row, or from a traced
    torchscript file) onto a learned-position encoder: every parameter
    filled, the unknown source keys reported, and the oracle's tokens
    reproduced (3e-4: the oracle's LayerNorm eps is 1e-5, the encoder's
    1e-6, as in tests/test_sapiens_convert.py)."""
    torch.manual_seed(0)
    vit = _torch_vit()
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(2, 3, 64, 64)).astype(np.float32))
    if source == "torchscript":
        path = str(tmp_path / "sapiens.pt")
        torch.jit.trace(vit, x).save(path)
        extra = []
    else:
        sd = {k: v.detach() for k, v in vit.state_dict().items()}
        cls = torch.zeros(1, 1, D)
        sd["backbone.pos_embed"] = torch.cat([cls, sd["backbone.pos_embed"]],
                                             dim=1)
        extra = ["backbone.cls_token", "head.fc.weight"]
        sd.update({k: torch.zeros(3) for k in extra})
        path = str(tmp_path / "sapiens.pth")
        torch.save({"state_dict": sd}, path)
    sd = convert.load_sapiens_source(path)
    enc = ViTFeatureEncoder(embed_dim=D, depth=DEPTH, heads=HEADS,
                            patch_size=P, learned_pos=True,
                            learned_pos_tokens=GRID * GRID)
    out, stats = convert.convert_sapiens(sd, enc)
    assert stats["unmatched"] == sorted(extra)
    assert not stats["missing"] and not stats["mismatches"]
    enc.load_state_dict(out)
    with torch.no_grad():
        ref = vit(x).numpy()
        got = enc(x).reshape(2, D, -1).transpose(1, 2).numpy()
    np.testing.assert_allclose(got, ref, atol=3e-4, rtol=1e-3)


def test_sapiens_convert_reports_missing():
    """A source without the final norm and with a wrong-width layer: the
    norm's parameters are reported missing, the layer mismatched."""
    sd = {k: v.detach().numpy() for k, v in _torch_vit().state_dict().items()}
    del sd["backbone.ln1.weight"], sd["backbone.ln1.bias"]
    sd["backbone.layers.1.ln2.weight"] = np.ones(D + 1, np.float32)
    enc = ViTFeatureEncoder(embed_dim=D, depth=DEPTH, heads=HEADS,
                            patch_size=P, learned_pos=True,
                            learned_pos_tokens=GRID * GRID)
    _, stats = convert.convert_sapiens(sd, enc)
    assert "norm_out.weight" in stats["missing"]
    assert "blocks.1.ln2.weight" in stats["missing"]
    assert any(m.startswith("blocks.1.ln2.weight") for m in
               stats["mismatches"])


# ---- the DiT and its step -------------------------------------------------------

def test_dit_checkpointing_keeps_gradients():
    """Per-block checkpointing recomputes the blocks exactly: the same
    gradients with and without it (1e-6)."""
    rng = np.random.default_rng(3)
    lat = _t(rng.normal(size=(2, 4, 8, 8)).astype(np.float32))
    cond = _t(rng.normal(size=(2, 16, 8, 8)).astype(np.float32))
    t = torch.tensor([5, 700])
    grads = []
    for remat in (True, False):
        torch.manual_seed(0)
        m = DiTModel(TCFG.replace(num_layers=2, gradient_checkpointing=remat))
        m(lat, cond, t).square().mean().backward()
        grads.append([p.grad.clone() for p in m.parameters()])
    for a, b in zip(*grads):
        np.testing.assert_allclose(_np(a), _np(b), atol=1e-6)


@pytest.mark.parametrize("path", ["pre_encoded", "raw"])
def test_train_step_matches_jax(both, path, monkeypatch):
    """One step from the same weights, batch and draws: the loss (1e-5
    relative), the gradients against JAX's first Adam moment / (1 - b1)
    (1e-3 relative L2 over all parameters; the clip lies above the norm),
    and the parameters after the step: Adam's first update is +-lr per
    element, so each within 2 lr of JAX's and 99% within 0.1 lr."""
    jt, state, tt, _, dit_sd = both
    tt.model.load_state_dict(dit_sd)
    tt.opt.state.clear()
    updates = tt.updates
    batch = _raw_batch(JCFG, B) if path == "raw" else _encoded_batch(JCFG, B)
    key = jax.random.PRNGKey(STEP_KEY)
    draws = _jax_draws(key, JCFG, B)
    assert draws["drop"].ravel().tolist() == [False, True]
    j_state, j_logs = jt.train_step(jax.tree.map(jnp.array, state),
                                    shard_batch(batch, jt.mesh), key)

    pre_clip = []
    real_clip = dit_trainer.clip_by_global_norm_

    def capturing_clip(params, max_norm):
        pre_clip[:] = [p.grad.detach().clone() for p in params]
        return real_clip(params, max_norm)

    monkeypatch.setattr(dit_trainer, "clip_by_global_norm_", capturing_clip)
    logs = tt.train_step(tt.to_device(batch), draws)
    loss = float(j_logs["loss"])
    assert abs(logs["loss"].item() - loss) <= LOSS_RTOL * abs(loss)
    assert tt.updates == updates + 1

    names = [n for n, _ in tt.model.named_parameters()]
    j_grad = convert.convert_dit(
        jax.tree.map(lambda m: np.asarray(m) / 0.1,
                     _tree(_adam_mu(j_state.opt_state))), tt.model, TCFG)
    t_flat = np.concatenate([_np(g).ravel() for g in pre_clip])
    j_flat = np.concatenate([_np(j_grad[n]).ravel() for n in names])
    assert np.linalg.norm(t_flat) < TCFG.gradient_clip
    assert np.linalg.norm(t_flat - j_flat) <= GRAD_TOL * np.linalg.norm(j_flat)
    assert np.abs(t_flat).max() > 0

    lr = TCFG.lr
    j_new = convert.convert_dit(_tree(j_state.params), tt.model, TCFG)
    close = size = 0
    for n, p in tt.model.named_parameters():
        u = _np(p) - _np(dit_sd[n])
        ref = _np(j_new[n]) - _np(dit_sd[n])
        assert np.abs(u - ref).max() <= 2 * lr + 1e-6, n
        close += int((np.abs(u - ref) <= 0.1 * lr).sum())
        size += u.size
    assert close >= 0.99 * size


def test_bf16_runs_only_the_training_dit_in_bf16(both):
    """With ``mixed_precision="bf16"`` the frozen encodes and ``eval_loss``
    stay f32, bit for bit the f32 trainer's (the JAX trainer applies f32
    parameters there); the train step's DiT runs in bf16, so its loss
    moves off the f32 one by bf16 rounding only."""
    _, _, tt, _, dit_sd = both
    tt.model.load_state_dict(dit_sd)
    bf = DiTTrainer(TCFG.replace(mixed_precision="bf16"), tt.vae, tt.encoder,
                    device="cpu")
    bf.model.load_state_dict(dit_sd)
    batch = tt.to_device(_raw_batch(JCFG, B))
    draws = _jax_draws(jax.random.PRNGKey(STEP_KEY), JCFG, B)
    for a, b in zip(tt.encode_inputs(batch, draws["enc_noise"]),
                    bf.encode_inputs(batch, draws["enc_noise"])):
        assert a.dtype == b.dtype == torch.float32
        assert torch.equal(a, b)
    noise = draws["noise"]
    assert torch.equal(tt.eval_loss(batch, noise, draws["enc_noise"]),
                       bf.eval_loss(batch, noise, draws["enc_noise"]))
    f32 = tt.train_step(batch, draws)["loss"].item()
    half = bf.train_step(batch, draws)["loss"].item()
    assert f32 != half
    assert abs(half - f32) <= 0.05 * abs(f32)


def test_raw_and_pre_encoded_batch_together_raises(both):
    _, _, tt, _, _ = both
    batch = tt.to_device({**_raw_batch(JCFG, B), **_encoded_batch(JCFG, B)})
    with pytest.raises(ValueError, match="pre-encoded"):
        tt.train_step(batch)


def test_schedule_and_accumulation_match_optax(both):
    """The warmup-cosine learning rate over 6 updates (warmup 3) against
    ``optax.warmup_cosine_decay_schedule``, and clip + AdamW on fixed
    gradients against the JAX trainer's optimizer chain: 6 updates at
    ``gradient_accumulation_steps = 1`` and 4 micro-steps at 2 (one
    gradient norm above the clip, the rest below; ``optax.MultiSteps``
    averages, clips and applies on every second): 3e-7, a few f32 ulps at
    the parameters' size (|p| < 0.5) after Adam's arithmetic in another
    order."""
    _, state, _, vae_p, _ = both
    for k, n_micro in ((1, 6), (2, 4)):
        over = dict(lr_scheduler="cosine", lr=1e-2, lr_warmup_steps=3,
                    gradient_clip=1.0, gradient_accumulation_steps=k)
        jt = JTrainer(JCFG.replace(**over), vae_params=vae_p,
                      mesh=make_mesh((1,), ("data",)))
        tt = DiTTrainer(TCFG.replace(**over), VAEModel(TCFG),
                        ViTFeatureEncoder(embed_dim=TCFG.text_embed_dim,
                                          depth=1), device="cpu")
        sched = optax.warmup_cosine_decay_schedule(0.0, 1e-2, 3, 1_000_000)
        for c in range(6):
            np.testing.assert_allclose(tt.lr_at(c), float(sched(c)),
                                       rtol=1e-6, atol=1e-12)
        params = list(tt.model.parameters())
        rng = np.random.default_rng(k)
        vals = [rng.normal(0, 0.1, tuple(p.shape)).astype(np.float32)
                for p in params]
        with torch.no_grad():
            for p, v in zip(params, vals):
                p.copy_(torch.from_numpy(v))
        jp = [jnp.asarray(v) for v in vals]
        opt_state = jt.tx.init(jp)
        update = jax.jit(jt.tx.update)
        size = np.sqrt(sum(v.size for v in vals))
        for i in range(n_micro):
            scale = 10.0 if i == 0 else 1e-2       # first norm above the clip
            grads = [rng.normal(0, scale / size, v.shape).astype(np.float32)
                     for v in vals]
            for p, g in zip(params, grads):
                # the micro-gradient / k, as train_step's backward leaves it
                g_t = torch.from_numpy(g / k)
                p.grad = g_t if p.grad is None else p.grad + g_t
            tt._apply()
            upd, opt_state = update([jnp.asarray(g) for g in grads],
                                    opt_state, jp)
            jp = [a + b for a, b in zip(jp, upd)]
            for p, ref in zip(params, jp):
                np.testing.assert_allclose(_np(p), np.asarray(ref),
                                           atol=3e-7, rtol=0)
        assert tt.updates == n_micro // k


def test_eval_loss_matches_jax(both):
    """The held-out loss at t = T/2 with JAX's posterior and latent noise
    (1e-5 relative)."""
    jt, state, tt, _, dit_sd = both
    tt.model.load_state_dict(dit_sd)
    batch = _raw_batch(JCFG, B, seed=5)
    key = jax.random.PRNGKey(4)
    ref = float(jt.eval_loss(state, batch, key))
    q = JCFG.uv_query_size
    enc_noise = _t(jax.random.normal(key, (B, q, q, JCFG.latent_channels)))
    noise = _t(jax.random.normal(jax.random.fold_in(key, 1),
                                 (B, JCFG.latent_channels, JCFG.sample_height,
                                  JCFG.sample_width)))
    out = tt.eval_loss(tt.to_device(batch), noise, enc_noise).item()
    assert abs(out - ref) <= LOSS_RTOL * abs(ref)


def test_sample_and_render_latent_match_jax(both, tmp_path):
    """CFG sampling over 3 steps from JAX's initial noise (latents 1e-5),
    then the frozen VAE decode -> deform -> render of the latents divided
    by ``vae_scaling_factor`` once, against the JAX ``render_latent`` on
    the same ``z`` (the JAX package's ``sample_eval`` divides twice, so it
    is not the reference); ``sample_eval`` writes its PNG."""
    jt, state, tt, vae_p, dit_sd = both
    tt.model.load_state_dict(dit_sd)
    item = SyntheticAvatarDataset(TCFG, n_items=1, seed=2)[0]
    batch = {k: v[None] for k, v in item.items() if k != "item"}
    key = jax.random.PRNGKey(6)
    j_lat = np.asarray(jt.sample(state, jnp.asarray(batch["sapiens_input"]),
                                 key, num_inference_steps=3))
    shape = (1, JCFG.latent_channels, JCFG.sample_height, JCFG.sample_width)
    noise = _t(jax.random.normal(key, shape))
    t_lat = tt.sample(_t(batch["sapiens_input"]), noise=noise,
                      num_inference_steps=3)
    np.testing.assert_allclose(_np(t_lat), j_lat, atol=1e-5)

    jvt = JVAETrainer(JCFG, interpret=True, mesh=make_mesh((1,), ("data",)))
    z = np.moveaxis(j_lat, 1, -1)
    j_out = jvt.render_latent(vae_p, jnp.asarray(z),
                              {k: jnp.asarray(v) for k, v in batch.items()})
    vae, latent_renderer = dit_trainer.frozen_vae(TCFG, device="cpu")
    vae.load_state_dict(convert.convert_vae(_tree(vae_p), vae, TCFG))
    tt.latent_renderer = latent_renderer
    tb = tt.to_device(batch)
    t_out = latent_renderer(_t(z), tb)
    for name in ("images_pred", "alphas_pred"):
        np.testing.assert_allclose(_np(t_out[name]),
                                   np.asarray(j_out[name]),
                                   atol=RENDER_ATOL, err_msg=name)
    assert _np(t_out["alphas_pred"]).max() > 0.5
    vis = str(tmp_path / "sample.png")
    logs = tt.sample_eval(tb, noise=noise, vis_path=vis,
                          num_inference_steps=3)
    assert np.isfinite(logs["sample_psnr"]) and os.path.exists(vis)


def test_train_dit_cli_trains_and_resumes(tmp_path):
    """``python -m sigman_release_torch.train_dit test_tiny --device cpu``:
    two steps with an eval (loss, sampled render, PNG) and a state file;
    a second run (in this process) resumes from it to step 4."""
    base = [sys.executable, "-m", "sigman_release_torch.train_dit",
            "test_tiny", "--device", "cpu", "--synthetic_items", "2",
            "--log_every", "1", "--num_workers", "1", "--eval_steps", "2",
            "--num_inference_steps", "2", "--workspace", str(tmp_path)]
    state = tmp_path / "dit_state.pt"
    res = subprocess.run(base + ["--num_epochs", "1"], cwd=ROOT,
                         capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-2000:]
    assert "2 steps on cpu" in res.stdout and state.exists()
    assert (tmp_path / "dit_sample_0000002.png").exists()
    from sigman_release_torch import train_dit

    trainer = train_dit.main(base[3:] + ["--num_epochs", "2", "--resume",
                                         str(state)])
    assert trainer.step == 4 and trainer.updates == 4
    import json

    rows = [json.loads(r) for r in
            (tmp_path / "dit_metrics.jsonl").read_text().splitlines()]
    steps = [r["step"] for r in rows if "loss" in r]
    assert steps == [1, 2, 3, 4]
    assert any("sample_psnr" in r for r in rows)


def test_train_dit_guards(tmp_path):
    """Without synthetic data it exits; an existing VAE file it cannot read
    raises, naming the checkpoint module still to port."""
    from sigman_release_torch import train_dit

    with pytest.raises(SystemExit, match="synthetic_data"):
        train_dit.main(["dit", "--device", "cpu"])
    vae = tmp_path / "vae.safetensors"
    vae.write_bytes(b"\0" * 8)
    with pytest.raises(NotImplementedError, match="checkpoint.py"):
        train_dit.main(["test_tiny", "--device", "cpu", "--vae_path",
                        str(vae)])


def test_sapiens_path_needs_the_sapiens_width(tmp_path):
    """``--sapiens_path`` at a conditioning width other than Sapiens-1B's
    1536 raises before any weight is read."""
    from sigman_release_torch import train_dit

    assert TCFG.text_embed_dim != 1536
    src = tmp_path / "sapiens.pth"
    src.write_bytes(b"\0" * 8)
    with pytest.raises(ValueError, match="text_embed_dim 1536"):
        train_dit.main(["test_tiny", "--device", "cpu", "--sapiens_path",
                        str(src), "--text_embed_dim", "16"])
