"""Whole runs of each cell on the CPU at ``test_tiny`` sizes: the
reference agrees with the port, the control (the reference one precision
step lower) does not, and a run whose timed path is broken underneath
comes out not correct under the cell's own limits."""

import dataclasses
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import run as R  # noqa: E402
from portbench.reference.config import PRESETS  # noqa: E402

CELLS = {"vae_b-train": ("vae", "train-pool"),
         "dit-train": ("dit", "train-pool"),
         "dit-serve": ("dit", "serve-batch8")}
SEED = 2 ** 31 + 12345


def tiny(cell):
    family, traffic = CELLS[cell]
    conf = {"name": "tiny", "family": family, "batch": 2, "n_verts": 1024,
            "followed_steps": 3,
            "config": dataclasses.asdict(
                PRESETS["test_tiny"].replace(batch_size=2))}
    with open(os.path.join(ROOT, "portbench", "traffic",
                           f"{traffic}.json")) as f:
        return conf, json.load(f)


def run_tiny(cell, trace=False, control=None):
    conf, traffic = tiny(cell)
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        return R.run(cell, SEED, 0.5, trace, device="cpu", control=control,
                     conf_override=conf, traffic_override=traffic,
                     log=lambda *a: None)
    finally:
        os.chdir(cwd)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reference_agrees_with_the_port(cell):
    res = run_tiny(cell)
    assert res["correct"], res["compared"]
    # f32 on both sides at test_tiny: far under any limit
    for name, c in res["compared"].items():
        assert c["value"] < 1e-3, (name, c)
    assert not set(R.forbidden_modules())


def test_traced_run_reads_the_spans():
    res = run_tiny("vae_b-train", trace=True)
    assert res["correct"]
    assert {"backward_ms.vae_train", "vae_fwd_ms.vae_train",
            "knn_ms.vae_train"} <= set(res["metrics"])


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_the_control_reads_far_above_the_port(cell):
    """At test_tiny the port runs f32; the control one step lower (fp8 for
    bf16 parts, bf16 for f32 parts) reads at least ten times higher on one
    of the cell's numbers."""
    sound = run_tiny(cell)["compared"]
    low = run_tiny(cell, control="lower")["compared"]
    assert any(low[n]["value"] >= 10 * max(sound[n]["value"], 1e-7)
               for n in sound), (sound, low)


def _state_unchanged(monkeypatch):
    from sigman_release_torch.training import dit_trainer, vae_trainer

    def vae_apply(self, kind, params, opt):
        for p in params:
            p.grad = None
        return True

    def dit_apply(self):
        for p in self.model.parameters():
            p.grad = None
        self.updates += 1
        return True

    monkeypatch.setattr(vae_trainer.VAETrainer, "_apply", vae_apply)
    monkeypatch.setattr(dit_trainer.DiTTrainer, "_apply", dit_apply)


def _half_batch(monkeypatch):
    from sigman_release_torch.training import dit_trainer, vae_trainer

    g_step, d_step = (vae_trainer.VAETrainer.train_step_g,
                      dit_trainer.DiTTrainer.train_step)

    def half(batch):
        return {k: v[: max(1, v.shape[0] // 2)] for k, v in batch.items()}

    monkeypatch.setattr(
        vae_trainer.VAETrainer, "train_step_g",
        lambda self, batch, noise=None, timer=None, **kw: g_step(
            self, half(batch), noise[: noise.shape[0] // 2],
            **({"timer": timer} if timer else {})))
    monkeypatch.setattr(
        dit_trainer.DiTTrainer, "train_step",
        lambda self, batch, draws=None, timer=None: d_step(
            self, half(batch), half(draws), **({"timer": timer}
                                               if timer else {})))


def _answer_altered(monkeypatch):
    from sigman_release_torch import inference

    call = inference.AvatarPipeline.__call__

    def altered(self, *args, **kwargs):
        out = call(self, *args, **kwargs)
        img = out["render"]["image"]
        out["render"]["image"] = (img + 0.05).clamp(0, 1)
        return out

    monkeypatch.setattr(inference.AvatarPipeline, "__call__", altered)


@pytest.mark.parametrize("cell, fault", [
    ("vae_b-train", _state_unchanged), ("vae_b-train", _half_batch),
    ("dit-train", _state_unchanged), ("dit-train", _half_batch),
    ("dit-serve", _answer_altered)])
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    fault(monkeypatch)
    res = run_tiny(cell)
    assert not res["correct"], res["compared"]
