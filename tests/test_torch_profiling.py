"""Step tracing of the port's trainers and their entry points.

``train_vae`` / ``train_dit --profile_dir D --profile_every k`` trace every
k-th step (counted from 0, the first not) into D with ``torch.profiler``,
one ``*.pt.trace.json`` per rank and traced step, as the JAX package's
``fit`` writes one trace per such step (``utils/profiling.trace_if``).
Without ``--profile_dir`` nothing is traced. The entry points run in this
process on the CPU at ``test_tiny`` (3 synthetic items: steps 0, 1, 2).
"""

import glob
import json
import os

import pytest

from sigman_release_torch import train_dit, train_vae
from sigman_release_torch.utils import profiling
from sigman_release_torch.utils.logging import MetricLogger

from sigman_release_tpu.utils.logging import MetricLogger as JMetricLogger


def _run(main, tmp_path, *flags):
    ws = tmp_path / "ws"
    trainer = main(["test_tiny", "--device", "cpu", "--num_epochs", "1",
                    "--synthetic_items", "3", "--num_workers", "1",
                    "--workspace", str(ws), *flags])
    assert trainer.step == 3
    return ws


def _traces(root):
    return sorted(glob.glob(os.path.join(root, "**", "*.pt.trace.json"),
                            recursive=True))


@pytest.mark.parametrize("name,main", [("vae", train_vae.main),
                                       ("dit", train_dit.main)])
def test_profile_dir_traces_every_kth_step(name, main, tmp_path):
    """``--profile_every 1``: steps 1 and 2 are traced (step 0 is not), one
    file each, each a TensorBoard-readable Chrome trace of the step's
    operators."""
    traces = tmp_path / "traces"
    _run(main, tmp_path, "--profile_dir", str(traces), "--profile_every", "1")
    files = _traces(traces)
    assert len(files) == 2, files
    assert all(os.path.basename(f).startswith("rank0.") for f in files)
    for f in files:
        with open(f) as fh:
            events = json.load(fh)["traceEvents"]
        names = {e.get("name", "") for e in events}
        assert any(n.startswith("aten::") for n in names), f


@pytest.mark.parametrize("name,main", [("vae", train_vae.main),
                                       ("dit", train_dit.main)])
def test_no_profile_dir_writes_no_trace(name, main, tmp_path):
    ws = _run(main, tmp_path, "--profile_every", "1")
    assert _traces(tmp_path) == []
    assert os.path.exists(ws / f"{name}_metrics.jsonl")


def test_traced_steps_follow_the_jax_rule():
    assert [s for s in range(7) if profiling.traced(s, 2)] == [2, 4, 6]
    assert not any(profiling.traced(s, 0) for s in range(4))


def test_metric_logger_summary_matches_jax(tmp_path):
    """``summary`` logs its metrics as the row of step -1."""
    rows = []
    for cls, sub in ((MetricLogger, "port"), (JMetricLogger, "jax")):
        logger = cls(str(tmp_path / sub), name="vae")
        logger.log(3, {"loss": 0.5})
        logger.summary({"best_psnr": 21.25, "best_lpips": 0.125})
        logger.close()
        with open(tmp_path / sub / "vae_metrics.jsonl") as f:
            rows.append([{k: v for k, v in json.loads(line).items()
                          if k != "t"} for line in f])
    assert rows[0] == rows[1]
    assert rows[0][-1] == {"step": -1, "best_psnr": 21.25, "best_lpips": 0.125}
