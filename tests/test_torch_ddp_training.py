"""Both trainers and both entry points under DDP on the CPU: two ranks over
gloo (``parallel/launch.py``: a ``file://`` rendezvous in a fresh
directory, one deadline, two threads per rank) against one process on the
whole batch, ``test_tiny`` in f32.

Each case (``training/cases.py``) gives the two ranks the halves of one
batch (or, on a 'view' axis, the halves of its views) and the draws of the
whole batch; rank 0 first takes the same steps in one process on all of
it. Held: each step's loss within ``LOSS_TOL`` relative, the gradient
that reaches each clip (averaged over the ranks) and the new weights
within ``GRAD_TOL`` / ``WEIGHT_TOL`` relative L2, the logs equal to the
mean of the per-rank logs, the eval over an uneven split equal to one
process pooling the same items.

The VAE's G steps run with the GAN gate closed (``disc_start`` 2, the D
steps after it open): with it open, one process's G step on two items
already differs from the mean of the same step on each item alone by more
than ``GRAD_TOL`` (the random discriminator's logits, in the hundreds,
amplify the convolutions' rounding; no DDP in it).
"""

import json
import os

import numpy as np
import pytest
import torch

from sigman_release_torch.config import PRESETS
from sigman_release_torch.parallel import launch
from sigman_release_torch.parallel.mesh import rank_seed
from sigman_release_torch.training.vae_trainer import VAETrainer

LOSS_TOL = 1e-6                 # loss, relative
GRAD_TOL = 1e-5                 # gradient at each clip, relative L2
WEIGHT_TOL = 1e-5               # new weights, relative L2
LOG_TOL = 1e-6                  # logs against the mean of the ranks' logs
EVAL_TOL = 1e-5                 # eval metrics, relative
TIMEOUT = 240                   # seconds for the two ranks of one case

CASES = "sigman_release_torch.training.cases"
VCFG = PRESETS["test_tiny"].replace(gradient_clip=1e4, disc_start=2,
                                    attn_dropout=0.0)
DCFG = PRESETS["test_tiny"].replace(gradient_clip=1e4, lr_scheduler="constant",
                                    noised_condition_dropout=0.5)


def _run(target, **kwargs):
    return launch.run(f"{CASES}:{target}", 2, kwargs, timeout=TIMEOUT)


def _held(r0, n_steps, n_clips):
    assert r0["n_clips"] == (n_clips, n_clips)
    assert len(r0["loss_rel"]) == n_steps
    assert max(r0["loss_rel"]) <= LOSS_TOL, r0["loss_rel"]
    assert max(r0["grad_rel"]) <= GRAD_TOL, r0["grad_rel"]
    assert r0["weights_rel"] <= WEIGHT_TOL, r0["weights_rel"]


@pytest.fixture(scope="module")
def vae_data2():
    """Data 2 x view 1: G, G, D at one micro-step each, the first step's
    logs of one process on each half, and the eval over 3 held-out items
    (2 on rank 0, 1 on rank 1)."""
    return _run("vae_case", cfg=VCFG, mesh_shape=(2,), mesh_axes=("data",),
                items=[0, 1], steps=("g", "g", "d"), eval_items=[2, 3, 4],
                split_logs=True)


@pytest.fixture(scope="module")
def vae_view2():
    """Data 1 x view 2: each rank renders 2 of the 4 views of one item,
    with the bottleneck's dropout on (both ranks draw the same masks)."""
    cfg = VCFG.replace(num_views=4, attn_dropout=0.1)
    return _run("vae_case", cfg=cfg, mesh_shape=(1, 2),
                mesh_axes=("data", "view"), items=[0], steps=("g", "g", "d"),
                eval_items=[2])


@pytest.mark.parametrize("layout", ["data2", "view2"])
def test_vae_steps_match_one_process(layout, vae_data2, vae_view2):
    """Two G steps and one D step: the loss, the averaged gradient at each
    clip and the new weights equal one process on the whole batch; every
    rank logs the same averaged values."""
    res = vae_data2 if layout == "data2" else vae_view2
    _held(res[0], 3, 3)
    assert res[0]["logs"] == res[1]["logs"]
    assert res[0]["buckets"]["count"] >= 1
    n_params = sum(p.numel() for p in
                   VAETrainer(VCFG, device="cpu").params_g)
    assert res[0]["buckets"]["bytes"] == 4 * n_params


def test_vae_logs_are_the_mean_of_the_ranks(vae_data2):
    """The first G step's logs (psnr and overflow included) are the mean of
    one process's logs on each half, as ``pmean`` makes them."""
    r0 = vae_data2[0]
    split = r0["split_logs"]
    for k, v in r0["logs"][0].items():
        want = np.mean([s[k] for s in split])
        assert abs(v - want) <= LOG_TOL * max(abs(want), 1.0), k


@pytest.mark.parametrize("layout", ["data2", "view2"])
def test_vae_eval_matches_one_process(layout, vae_data2, vae_view2):
    """``evaluate`` over an uneven split (data 2: 3 items, rank 1 passes
    None in the second eval step) or over split views ends on both ranks
    with the one-process value."""
    res = vae_data2 if layout == "data2" else vae_view2
    ref = res[0]["ref_eval"]
    assert set(ref) == {"eval_psnr", "eval_masked_psnr", "eval_ssim",
                        "eval_lpips"}
    for r in res:
        for k, v in ref.items():
            assert abs(r["eval"][k] - v) <= EVAL_TOL * abs(v), (k, r["rank"])


def test_vae_accumulation_matches_one_process():
    """``gradient_accumulation_steps`` 2 over data 2: the first micro-step
    of each kind runs under ``no_sync``, the clip sees the gradient averaged
    over both micro-steps and both ranks."""
    res = _run("vae_case", cfg=VCFG.replace(gradient_accumulation_steps=2),
               mesh_shape=(2,), mesh_axes=("data",), items=[0, 1],
               steps=("g", "g", "d", "d"))
    _held(res[0], 4, 2)


@pytest.mark.parametrize("k", [1, 2])
def test_dit_steps_match_one_process(k):
    """Two DiT micro-steps over data 2 (raw path, per-block checkpointing,
    4 items, both dropout branches) at ``gradient_accumulation_steps`` k,
    and the eval loss over 3 held-out items (2 and 1): loss, gradients and
    new weights equal one process, the eval loss weighted by items."""
    res = _run("dit_case", cfg=DCFG.replace(gradient_accumulation_steps=k),
               items=[0, 1, 2, 3], steps=2, eval_items=[4, 5, 6])
    _held(res[0], 2, 2 // k)
    assert res[0]["losses"] == res[1]["losses"]
    ref = res[0]["ref_eval_loss"]
    for r in res:
        assert abs(r["eval_loss"] - ref) <= LOSS_TOL * abs(ref)


def _entry(module, ws, name):
    argv = ["test_tiny", "--device", "cpu", "--num_epochs", "2",
            "--synthetic_items", "3", "--workspace", str(ws),
            "--num_workers", "1", "--log_every", "1", "--eval_steps", "1"]
    if module.endswith("train_dit"):
        argv += ["--num_inference_steps", "2"]
    resume = argv + ["--resume", str(ws / name)]
    return _run("entry_case", module=module, argv=argv, resume_argv=resume)


@pytest.fixture(scope="module")
def vae_entry(tmp_path_factory):
    ws = tmp_path_factory.mktemp("vae_ws")
    return _entry("sigman_release_torch.train_vae", ws, "vae_state.pt"), ws


@pytest.fixture(scope="module")
def dit_entry(tmp_path_factory):
    ws = tmp_path_factory.mktemp("dit_ws")
    return _entry("sigman_release_torch.train_dit", ws, "dit_state.pt"), ws


@pytest.mark.parametrize("tag", ["vae", "dit"])
def test_entry_point_under_two_ranks(tag, request):
    """``main`` on two gloo ranks with 3 synthetic items at batch 1 (2 on
    rank 0, 1 on rank 1): both ranks end at step 2 (2 epochs of the shorter
    share), only rank 0 prints and writes, and a 2-rank ``--resume`` gives
    each rank back its own generator."""
    res, ws = request.getfixturevalue(f"{tag}_entry")
    assert [r["steps"] for r in res] == [[2, 2], [2, 2]]
    assert f"[{tag}] step 1" in res[0]["printed"]
    assert res[1]["printed"] == ""
    for r in res:
        assert torch.equal(r["generators"][0], r["generators"][1])
    assert not torch.equal(res[0]["generators"][0], res[1]["generators"][0])
    state = torch.load(ws / f"{tag}_state.pt", weights_only=False)
    assert [torch.equal(g, r["generators"][0])
            for g, r in zip(state["generators"], res)] == [True, True]
    with open(ws / f"{tag}_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2]
    assert os.path.exists(ws / (f"eval_{2:07d}.png" if tag == "vae"
                                else f"dit_sample_{2:07d}.png"))


def test_resume_on_another_world_size_reseeds(vae_entry, capsys):
    """The 2-rank state file resumed by one process: weights and steps as
    saved, the generator re-seeded from (seed, data index 0, step), and a
    line saying so."""
    _, ws = vae_entry
    t = VAETrainer(PRESETS["test_tiny"], device="cpu")
    t.resume(str(ws / "vae_state.pt"))
    assert t.step == 2
    want = torch.Generator().manual_seed(rank_seed(
        PRESETS["test_tiny"].seed + 5, 0, 2)).get_state()
    assert torch.equal(t.generator.get_state(), want)
    assert "re-seeded" in capsys.readouterr().out
