"""The DiT trainer's FSDP (``spmd="fsdp"`` over 'data') and its 'model' axis
(tensor parallelism) on the CPU: gloo ranks from ``parallel/launch.py``
running ``training/cases.py``, ``test_tiny`` in f32.

* Port against JAX: the JAX ``DiTTrainer(spmd="fsdp")`` step on a (2,)
  'data' mesh and on a (2, 2) ('data', 'model') mesh of the 8 virtual CPU
  devices, against the port's 2-rank FSDP step and its 4-rank data 2 x
  model 2 step on the same weights (``convert.convert_dit``), batch and
  draws. The JAX fsdp step runs with global semantics: its draws are
  ``split(key, 4)``, not folded by the data index, and each port rank is
  handed its rows of them. Tolerances of
  ``test_torch_dit_training.py::test_train_step_matches_jax``.
* Ranks against one port process on the whole batch (``dit_case``):
  data 2 within the DDP tests' limits; data 1 x model 2 and data 2 x
  model 2 (the contraction split over 'model' reassociates sums) within
  ``TP_*``. Also: each rank's sharded bytes against the analytic model,
  the eval loss over an uneven split, ``sample_eval`` on both ranks, a
  save in the middle of an accumulation resumed by one process, and
  ``make_mesh`` layouts with 'model' against the JAX mesh.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from sigman_release_tpu.config import PRESETS as JPRESETS
from sigman_release_tpu.models.encoders import ViTFeatureEncoder as JViT
from sigman_release_tpu.models.vae import VAEModel as JVAE
from sigman_release_tpu.parallel import mesh as jmesh
from sigman_release_tpu.training.dit_trainer import DiTTrainer as JTrainer
from sigman_release_torch import convert
from sigman_release_torch.config import PRESETS
from sigman_release_torch.models.dit import DiTModel
from sigman_release_torch.models.encoders import ViTFeatureEncoder
from sigman_release_torch.models.vae import VAEModel
from sigman_release_torch.parallel import launch
from sigman_release_torch.training import cases
from sigman_release_torch.training.dit_trainer import DiTTrainer

CASES = "sigman_release_torch.training.cases"
TIMEOUT = 240
# test_torch_dit_training.py's shapes and tolerances (one JAX step)
OVR = dict(num_views=2, num_input_views=2, batch_size=2,
           num_layers=1, num_attention_heads=2, attention_head_dim=8,
           text_embed_dim=16, time_embed_dim=16,
           sample_height=8, sample_width=8,
           lr_scheduler="constant", lr=1e-3,
           noised_condition_dropout=0.5, gradient_clip=1e4)
JCFG = JPRESETS["test_tiny"].replace(**OVR)
TCFG = PRESETS["test_tiny"].replace(**OVR)
ENCODER = dict(embed_dim=16, depth=1, heads=2, patch_size=16)
B = 2
STEP_KEY = 10            # its un-folded dropout draw is [False, True]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-3
# ranks against one port process: FSDP at the DDP tests' limits, tensor
# parallelism looser (the split contractions add in another order)
LOSS_TOL, GRAD_REL, WEIGHT_REL = 1e-6, 1e-5, 1e-5
TP_LOSS_TOL, TP_GRAD_REL, TP_WEIGHT_REL = 1e-5, 1e-4, 1e-4
# any one parameter's gradient (10x the whole's: a few elements round
# more), and the update, new minus old weights (Adam's first steps are
# near sign(g) x lr, so an element near 0 can swing by 2 lr)
LEAF_REL, TP_LEAF_REL, UPDATE_REL = 1e-4, 1e-3, 1e-4
DCFG = PRESETS["test_tiny"].replace(gradient_clip=1e4, lr_scheduler="constant",
                                    noised_condition_dropout=0.5, spmd="fsdp")
LAYOUTS = {"data2": ((2,), ("data",)),
           "model2": ((1, 2), ("data", "model")),
           "data2_model2": ((2, 2), ("data", "model"))}


def _tree(p):
    return jax.tree.map(np.asarray, p)


def _world(shape):
    return int(np.prod(shape))


def _adam_mu(opt_state):
    return next(s.mu for s in jax.tree.leaves(
        opt_state, is_leaf=lambda s: isinstance(s, optax.ScaleByAdamState))
        if isinstance(s, optax.ScaleByAdamState))


def _fsdp_draws(key, cfg, b):
    """The JAX fsdp step's draws: its key split into 4, not folded."""
    k_enc, k_t, k_noise, k_drop = jax.random.split(key, 4)
    q, c = cfg.uv_query_size, cfg.latent_channels
    return {
        "enc_noise": np.asarray(jax.random.normal(k_enc, (b, q, q, c))),
        "t": np.asarray(jax.random.randint(k_t, (b,), 0,
                                           cfg.num_train_timesteps)),
        "noise": np.asarray(jax.random.normal(
            k_noise, (b, c, cfg.sample_height, cfg.sample_width))),
        "drop": np.asarray(jax.random.bernoulli(
            k_drop, cfg.noised_condition_dropout, (b, 1, 1, 1))),
    }


@pytest.fixture(scope="module")
def frozen():
    """The JAX frozen VAE and depth-1 encoder parameters, and the port's
    state dicts of them."""
    key = jax.random.PRNGKey(0)
    s, v = JCFG.input_size, JCFG.num_input_views
    vae_p = jax.jit(JVAE(JCFG).init)({"params": key, "sample": key},
                                     jnp.zeros((1, v, 9, s, s)),
                                     jnp.zeros((1, 3, s, s)), key)
    enc = JViT(**ENCODER)
    enc_p = jax.jit(enc.init)(jax.random.PRNGKey(1),
                              jnp.zeros((1, 3, 64, 64)))
    vae = VAEModel(TCFG)
    tenc = ViTFeatureEncoder(**ENCODER)
    return (vae_p, enc, enc_p,
            convert.convert_vae(_tree(vae_p), vae, TCFG),
            convert.convert_vit(_tree(enc_p), tenc))


@pytest.fixture(scope="module")
def jax_steps(frozen):
    """The JAX fsdp step on (2,) 'data' and (2, 2) ('data', 'model') from
    the same weights, batch and key: (weights, batch, draws, {mesh:
    (new state, logs)})."""
    vae_p, enc, enc_p, _, _ = frozen
    rng = np.random.default_rng(0)
    s, v = JCFG.input_size, JCFG.num_input_views
    batch = {
        "input": rng.normal(0, 1, (B, v, 9, s, s)).astype(np.float32),
        "UV_inital": rng.uniform(0, 1, (B, 3, s, s)).astype(np.float32),
        "sapiens_input": rng.normal(0, 1, (B, 3, s, s)).astype(np.float32),
    }
    key = jax.random.PRNGKey(STEP_KEY)
    steps, dit_sd = {}, None
    for layout in ("data2", "data2_model2"):
        shape, axes = LAYOUTS[layout]
        jm = jmesh.make_mesh(shape, axes,
                             devices=jax.devices()[:_world(shape)])
        jt = JTrainer(JCFG, vae_params=vae_p, encoder_params=enc_p, mesh=jm,
                      spmd="fsdp")
        jt.encoder = enc        # the JAX trainer's own encoder is depth 8
        state = jt.init_state(jax.random.PRNGKey(2))
        if "model" in axes:
            q = state.params["params"]["block_0"]["attn1"]["to_q"]["kernel"]
            assert "model" in str(q.sharding.spec)
        else:
            dit_sd = convert.convert_dit(_tree(state.params), DiTModel(TCFG),
                                         TCFG)
        steps[layout] = jt.train_step(jax.tree.map(jnp.array, state),
                                      jmesh.shard_batch(batch, jm), key)
    return dit_sd, batch, _fsdp_draws(key, JCFG, B), steps


@pytest.mark.parametrize("layout", ["data2", "data2_model2"])
def test_fsdp_step_matches_jax(layout, frozen, jax_steps):
    """One step from the same weights, batch and draws against the JAX
    fsdp step on the (2,) 'data' mesh (one global program, as JAX's local
    step): every rank's loss within 1e-5, the whole gradient at the clip
    against JAX's first Adam moment / (1 - b1) within 1e-3 relative L2,
    and each new parameter within 2 lr of JAX's (99% within 0.1 lr). The
    port's data 2 x model 2 step also against the JAX step on the (2, 2)
    mesh, within the 2e-2 of the loss that the JAX package's own test
    allows that mesh (``tests/test_dit_training.py``): there the JAX step
    itself moves off its local program (ROADMAP.md, queue 3)."""
    _, _, _, vae_sd, enc_sd = frozen
    dit_sd, batch, draws, steps = jax_steps
    assert draws["drop"].ravel().tolist() == [False, True]
    j_state, j_logs = steps["data2"]
    shape, axes = LAYOUTS[layout]
    res = launch.run(f"{CASES}:fsdp_weights_case", _world(shape), dict(
        cfg=TCFG, mesh_shape=shape, mesh_axes=axes, vae=vae_sd,
        encoder={"kwargs": ENCODER, "state": enc_sd},
        dit={k: torch.from_numpy(np.array(x)) for k, x in dit_sd.items()},
        batch=batch, draws=draws), timeout=TIMEOUT, threads=1)
    r0 = res[0]
    loss = float(j_logs["loss"])
    for r in res:
        assert abs(r["loss"] - loss) <= LOSS_RTOL * abs(loss), r["rank"]
    if "model" in axes:
        assert "transformer_blocks.0.attn1.to_q" in r0["tensor_parallel"]
        assert "transformer_blocks.0.ff.net.2" in r0["tensor_parallel"]
        tp_loss = float(steps[layout][1]["loss"])
        assert abs(r0["loss"] - tp_loss) <= 2e-2 * abs(tp_loss)

    names = list(r0["params"])
    j_grad = convert.convert_dit(
        jax.tree.map(lambda m: np.asarray(m) / 0.1,
                     _tree(_adam_mu(j_state.opt_state))), DiTModel(TCFG), TCFG)
    t_flat = np.concatenate([g.numpy().ravel() for g in r0["grads"]])
    j_flat = np.concatenate([np.asarray(j_grad[n]).ravel() for n in names])
    assert np.linalg.norm(t_flat) < TCFG.gradient_clip
    assert np.linalg.norm(t_flat - j_flat) <= GRAD_TOL * np.linalg.norm(j_flat)
    assert np.abs(t_flat).max() > 0

    lr = TCFG.lr
    j_new = convert.convert_dit(_tree(j_state.params), DiTModel(TCFG), TCFG)
    close = size = 0
    for n in names:
        start = np.asarray(dit_sd[n])
        u = r0["params"][n].numpy() - start
        ref = np.asarray(j_new[n]) - start
        assert np.abs(u - ref).max() <= 2 * lr + 1e-6, n
        close += int((np.abs(u - ref) <= 0.1 * lr).sum())
        size += u.size
    assert close >= 0.99 * size


@pytest.fixture(scope="module")
def runs():
    """Two micro-steps of each layout against one process on 4 items, the
    eval loss over 3 held-out items (data 2: 2 and 1), and on data 2 a
    2-step ``sample_eval`` on both ranks."""
    out = {}
    for name, (shape, axes) in LAYOUTS.items():
        out[name] = launch.run(f"{CASES}:dit_case", _world(shape), dict(
            cfg=DCFG, mesh_shape=shape, mesh_axes=axes, items=[0, 1, 2, 3],
            steps=2, eval_items=[4, 5, 6],
            sample_steps=2 if name == "data2" else 0),
            timeout=TIMEOUT, threads=1 if _world(shape) > 2 else 2)
    return out


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_fsdp_steps_match_one_process(layout, runs):
    """Loss, whole gradient at each clip (over all parameters and each on
    its own: the q / k norms' weights, whole on every 'model' rank, sum
    the ranks' heads; and the global norm each rank computes from its
    pieces), the update and the new weights of two micro-steps equal one
    process on the whole batch; every rank logs the same loss."""
    res = runs[layout]
    r0 = res[0]
    tp = "model" in LAYOUTS[layout][1]
    assert r0["n_clips"] == (2, 2)
    assert max(r0["loss_rel"]) <= (TP_LOSS_TOL if tp else LOSS_TOL)
    assert max(r0["grad_rel"]) <= (TP_GRAD_REL if tp else GRAD_REL)
    worst, name = max(r0["grad_leaf"])
    assert worst <= (TP_LEAF_REL if tp else LEAF_REL), name
    assert r0["update_rel"] <= UPDATE_REL
    for r in res:
        for a, b in zip(r["norms"], r0["ref_norms"], strict=True):
            assert abs(a - b) <= (TP_GRAD_REL if tp else GRAD_REL) * b
    assert r0["weights_rel"] <= (TP_WEIGHT_REL if tp else WEIGHT_REL)
    assert all(r["losses"] == r0["losses"] for r in res)


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_sharded_bytes_match_the_analytic_model(layout, runs):
    """Each rank holds its pieces of the weights and both AdamW moments:
    over the world they add up to the analytic model's 12 B per element
    per copy exactly (FSDP's uneven last pieces even out), and each rank
    is within 10% of its share (``test_tiny``'s few-row tensors)."""
    res = runs[layout]
    total = sum(r["bytes"]["params"] + r["bytes"]["moments"] for r in res)
    assert total == pytest.approx(sum(r["bytes"]["analytic"] for r in res),
                                  rel=1e-12)
    for r in res:
        mine = r["bytes"]["params"] + r["bytes"]["moments"]
        assert abs(mine - r["bytes"]["analytic"]) <= 0.1 * mine
        assert r["bytes"]["moments"] == 2 * r["bytes"]["params"]


@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_eval_loss_over_an_uneven_split(layout, runs):
    """``eval_loss`` over 3 held-out items split 2 / 1 over the data ranks
    (a rank with none joins with a forward on a zero item) ends on every
    rank at the one-process value, with given noises and with the noises
    drawn from the generator (each rank its rows of the pooled draws)."""
    res = runs[layout]
    tol = TP_LOSS_TOL if "model" in LAYOUTS[layout][1] else LOSS_TOL
    for key in ("eval_loss", "eval_drawn"):
        ref = res[0][f"ref_{key}"]
        for r in res:
            assert abs(r[key] - ref) <= tol * abs(ref), (key, r["rank"])
    assert res[0]["eval_drawn"] != res[0]["eval_loss"]


def test_sample_eval_runs_on_both_ranks(runs):
    """Both ranks sample the same item through the sharded DiT (every
    forward all-gathers) and render it through K1's plain version (no
    launch on the CPU): the same finite PSNR, and no hang."""
    res = runs["data2"]
    psnr = [r["sample"]["sample_psnr"] for r in res]
    assert np.isfinite(psnr[0]) and psnr[0] == psnr[1]
    assert [r["sample_launches"] for r in res] == [0, 0]


def test_save_in_an_accumulation_resumes_in_one_process(tmp_path):
    """Data 2 x model 2 at ``gradient_accumulation_steps`` 2: the sharded
    trainer saves after micro-step 1; its file has the one-process file's
    keys, shapes and dtypes; one process resumes it bit for bit (weights,
    AdamW state, the gradient sums, counts, the shared generator) and its
    micro-step 2, the update, equals the sharded trainer's."""
    cfg = DCFG.replace(gradient_accumulation_steps=2)
    path = str(tmp_path / "dit_state.pt")
    res = launch.run(f"{CASES}:dit_case", 4, dict(
        cfg=cfg, mesh_shape=(2, 2), mesh_axes=("data", "model"),
        items=[0, 1, 2, 3], steps=1, save_path=path, after_save=1),
        timeout=TIMEOUT, threads=1)
    r0 = res[0]
    saved = torch.load(path, weights_only=True)
    one = torch.load(path + ".one", weights_only=True)
    assert list(saved) == list(one)
    assert saved["micro"] == one["micro"] == 1
    for part in ("model", "optimizer"):
        a, b = saved[part], one[part]
        if part == "optimizer":
            assert a["param_groups"] == b["param_groups"]
            a, b = ({f"{i}.{k}": v for i, s in x["state"].items()
                     for k, v in s.items()} for x in (a, b))
        assert list(a) == list(b)
        for k in a:
            assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k
    assert [g.shape for g in saved["grads"]] == [g.shape for g in one["grads"]]
    gens = saved["generators"]
    assert len(gens) == 4 and all(torch.equal(g, gens[0]) for g in gens)

    vae, _, enc = cases._dit_parts(cfg, torch.device("cpu"))
    t = DiTTrainer(cfg.replace(spmd="fsdp"), vae, enc, device="cpu")
    assert not t.fsdp              # no process group: one process
    t.resume(path)
    model, opt, grads = r0["saved"]
    for (n, p), g in zip(t.model.named_parameters(), grads, strict=True):
        assert torch.equal(p.detach(), model[n]), n
        assert torch.equal(p.grad, g), n
    for i, s in t.opt.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(v, opt["state"][i][k]), (i, k)
    assert (t.step, t.updates, t._micro) == (1, 0, 1)
    assert torch.equal(t.generator.get_state(), gens[0])

    from sigman_release_torch.data.dataset import SyntheticAvatarDataset
    from sigman_release_torch.training.dit_trainer import RAW_KEYS

    data = SyntheticAvatarDataset(cfg, n_items=5, seed=cfg.seed)
    batch = t.to_device({k: np.stack([data[i][k] for i in range(4)])
                         for k in RAW_KEYS})
    draws = {k: torch.from_numpy(np.asarray(v)) for k, v in
             cases.dit_draws(cfg, 4, 2).items()}
    loss = float(t.train_step(batch, draws)["loss"])
    assert t.updates == 1
    want = r0["after_losses"][0]
    assert abs(loss - want) <= TP_LOSS_TOL * abs(want)
    num = sum(float((p.detach() - w).double().square().sum())
              for p, w in zip(t.model.parameters(), r0["after_weights"]))
    den = sum(float(w.double().square().sum()) for w in r0["after_weights"])
    assert (num / den) ** 0.5 <= TP_WEIGHT_REL


MESH_LAYOUTS = [((2, 2), ("data", "model")), ((1, 4), ("data", "model")),
                ((4, 1), ("data", "model")), ((-1, 2), ("data", "model"))]


@pytest.fixture(scope="module")
def port_meshes():
    return launch.run(f"{CASES}:mesh_case", 4, {"layouts": MESH_LAYOUTS},
                      timeout=120, threads=1)


@pytest.mark.parametrize("i", range(len(MESH_LAYOUTS)))
def test_model_mesh_layout_matches_jax(i, port_meshes):
    """Rank r of four sits where the JAX mesh puts device r (data-major:
    on (2, 2) ranks 0-1 are data 0), each axis's group holds the ranks
    that differ only on it, and -1 takes what 'model' leaves."""
    shape, axes = MESH_LAYOUTS[i]
    jm = jmesh.make_mesh(shape, axes, devices=jax.devices()[:4])
    full = tuple(jm.devices.shape)
    for res in port_meshes:
        got = res[i]
        assert got["shape"] == full
        assert jm.devices[got["coords"]].id == jax.devices()[got["rank"]].id
        for a, ranks in enumerate(got["groups"]):
            line = np.moveaxis(np.arange(4).reshape(full), a, -1).reshape(
                -1, full[a])
            assert [list(x) for x in line if got["rank"] in x] == [ranks]
