"""Training metrics to ``<workspace>/<name>_metrics.jsonl``, one JSON object
per line with the step and wall-clock seconds (port of the JAX package's
``MetricLogger``, without the optional wandb mirror)."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict


class MetricLogger:
    def __init__(self, workspace: str, name: str = "run"):
        os.makedirs(workspace, exist_ok=True)
        self.path = os.path.join(workspace, f"{name}_metrics.jsonl")
        self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        row = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(row) + "\n")

    def close(self) -> None:
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
