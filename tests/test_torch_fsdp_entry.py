"""The entry points under ``--spmd fsdp`` on the CPU.

* ``train_dit.main --spmd fsdp --mesh_shape -1,2 --mesh_axes data,model``
  on two gloo ranks (``parallel/launch.py``, ``cases.entry_case``): the
  DiT sharded over a 'model' axis of 2, both ranks step, sample and save
  together, and one process resumes the state file and trains on.
* ``train_vae.main --spmd fsdp`` trains data-parallel, as the JAX entry
  point does (its ``VAETrainer`` never reads ``cfg.spmd``); a 'model' axis
  is refused by the VAE trainer.
* A DiT trainer with ``spmd="fsdp"`` and no process group runs as one
  process.
"""

import json

import pytest
import torch

from sigman_release_torch import train_dit, train_vae
from sigman_release_torch.config import PRESETS
from sigman_release_torch.parallel import launch
from sigman_release_torch.parallel.mesh import make_mesh
from sigman_release_torch.training import cases
from sigman_release_torch.training.dit_trainer import DiTTrainer
from sigman_release_torch.training.vae_trainer import VAETrainer

ARGV = ["test_tiny", "--device", "cpu", "--synthetic_items", "3",
        "--num_workers", "1", "--log_every", "1", "--eval_steps", "3",
        "--num_inference_steps", "2", "--spmd", "fsdp"]


@pytest.fixture(scope="module")
def dit_entry(tmp_path_factory):
    ws = tmp_path_factory.mktemp("dit_fsdp_ws")
    argv = ARGV + ["--num_epochs", "1", "--workspace", str(ws),
                   "--mesh_shape", "-1,2", "--mesh_axes", "data,model"]
    res = launch.run("sigman_release_torch.training.cases:entry_case", 2,
                     {"module": "sigman_release_torch.train_dit",
                      "argv": argv}, timeout=240)
    return res, ws


def test_train_dit_fsdp_under_two_ranks(dit_entry):
    """Data 1 x model 2: both ranks read the 3 items (one data index),
    take 3 steps sharded, sample at step 3 together; rank 0 alone prints
    and writes; every rank holds one generator stream, saved once per
    rank."""
    res, ws = dit_entry
    assert [r["steps"] for r in res] == [[3], [3]]
    assert [r["fsdp"] for r in res] == [[True], [True]]
    assert "[dit] step 1" in res[0]["printed"]
    assert res[1]["printed"] == ""
    assert torch.equal(res[0]["generators"][0], res[1]["generators"][0])
    state = torch.load(ws / "dit_state.pt", weights_only=False)
    assert state["mesh_shape"] == (1, 2) and state["step"] == 3
    assert all(torch.equal(g, res[0]["generators"][0])
               for g in state["generators"])
    with open(ws / "dit_metrics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    assert [r["step"] for r in rows if "loss" in r] == [1, 2, 3]
    assert any("sample_psnr" in r for r in rows)
    assert (ws / f"dit_sample_{3:07d}.png").exists()


def test_train_dit_resumes_a_sharded_state_in_one_process(dit_entry):
    """The 2-rank state file resumed by one process: its weights, the
    step and the shared generator stream as saved; it trains on to
    step 6."""
    _, ws = dit_entry
    saved = torch.load(ws / "dit_state.pt", weights_only=False)
    t = DiTTrainer(PRESETS["test_tiny"], *_frozen(), device="cpu")
    t.resume(str(ws / "dit_state.pt"))
    assert t.step == 3
    assert torch.equal(t.generator.get_state(), saved["generators"][0])
    for n, p in t.model.named_parameters():
        assert torch.equal(p.detach(), saved["model"][n]), n
    argv = ARGV + ["--num_epochs", "2", "--workspace", str(ws), "--resume",
                   str(ws / "dit_state.pt")]
    trainer = train_dit.main(argv)
    assert trainer.step == 6 and not trainer.fsdp


def _frozen():
    vae, _, encoder = cases._dit_parts(PRESETS["test_tiny"],
                                       torch.device("cpu"))
    return vae, encoder


def test_train_vae_ignores_spmd_fsdp(tmp_path):
    """``--spmd fsdp`` is the DiT's: ``train_vae`` trains as it would
    without it (2 G steps on 2 items), as the JAX entry point does."""
    trainer = train_vae.main(["test_tiny", "--device", "cpu", "--spmd",
                              "fsdp", "--num_epochs", "1",
                              "--synthetic_items", "2", "--workspace",
                              str(tmp_path), "--num_workers", "1"])
    assert trainer.step == 2
    assert (tmp_path / "vae_state.pt").exists()


def test_vae_trainer_refuses_a_model_axis():
    with pytest.raises(ValueError, match="'model' axis"):
        VAETrainer(PRESETS["test_tiny"], device="cpu",
                   mesh=make_mesh((1, 1), ("data", "model")))


def test_dit_fsdp_without_a_process_group_is_one_process():
    t = DiTTrainer(PRESETS["test_tiny"].replace(spmd="fsdp"), *_frozen(),
                   device="cpu")
    assert not t.fsdp and t.ddp is None
    assert not any(type(p).__name__ == "DTensor"
                   for p in t.model.parameters())
