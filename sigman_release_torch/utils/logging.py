"""Training metrics to ``<workspace>/<name>_metrics.jsonl``, one JSON object
per line with the step and wall-clock seconds (port of the JAX package's
``MetricLogger``, without the optional wandb mirror). Under
``torch.distributed`` only rank 0 opens and writes the file; the other
ranks' loggers do nothing."""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict

from sigman_release_torch.parallel.mesh import is_rank0


class MetricLogger:
    def __init__(self, workspace: str, name: str = "run"):
        self.path = os.path.join(workspace, f"{name}_metrics.jsonl")
        self._f = None
        if is_rank0():
            os.makedirs(workspace, exist_ok=True)
            self._f = open(self.path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any]) -> None:
        if self._f is None:
            return
        row = {"step": int(step), "t": round(time.time() - self._t0, 3)}
        row.update({k: float(v) for k, v in metrics.items()})
        self._f.write(json.dumps(row) + "\n")

    def summary(self, metrics: Dict[str, Any]) -> None:
        """A run's summary: one row at step -1."""
        self.log(-1, metrics)

    def close(self) -> None:
        if self._f is not None:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
