"""One short cell on the card, through the benchmark's command. Skips
without a CUDA device (decided inside the test)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


@pytest.mark.cuda
def test_one_short_serving_run_on_the_card_is_correct():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the benchmark measures the card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "dit-serve",
         "--seed", str(2 ** 31 + 77), "--seconds", "3", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result["correct"], result["compared"]
    assert result["device"]["platform"] == "gpu"
    assert result["metrics"]["avatar_latency_ms"]["value"] > 0
    assert list(result)[-1] == "compared"
