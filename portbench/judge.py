"""The numbers that decide ``correct``, and their limits.

Training cells (the reference follows the program's first three steps):

* ``loss``: the largest relative gap of a step's loss, over the steps;
* ``grad``: the first step's gradient as AdamW gets it (the program's from
  its first moment after one step, exp_avg / (1 - beta1)); per leaf the gap
  between the program's norm and the reference's, over the larger of the
  reference's norm of that leaf and of the median leaf; the worst leaf;
* ``update``: the same of the parameters' change after the followed steps,
  over the leaves whose first reference gradient is at least a thousandth
  of the median leaf's (the others move by Adam's rounding alone).

Serving cells (the reference runs again a sample of the answers the
program gave in the window, drawn from the seed):

* ``image``: the relative L2 gap of the rendered views, relative to the
  reference's views less the white background (the avatar's own pixels),
  the mean over the checked answers;
* ``latent``: the relative L2 gap of the sampled latents, likewise.

The mean, not the largest: an answer's image gap swings with how much of
its views the avatar covers (0.21-0.37% over single answers, my chip call
4), and the largest of three sat within 3x of the control's.

A number passes at or under its limit. Limits live in
``portbench/limits/<workload>.json``.
"""

from __future__ import annotations

import json
import os
import statistics
from typing import Dict, List, Optional

EXCLUDE_BELOW = 1e-3


def worst_leaf(prog: List[float], ref: List[float],
               keep: Optional[List[bool]] = None) -> float:
    keep = keep or [True] * len(ref)
    kept = [r for r, k in zip(ref, keep) if k]
    med = statistics.median(kept)
    return max(abs(p - r) / max(r, med, 1e-30)
               for p, r, k in zip(prog, ref, keep) if k)


def train_numbers(prog: Dict[str, list], ref: Dict[str, list]
                  ) -> Dict[str, float]:
    """``prog`` / ``ref``: "loss" (each step), "grad" and "update" (per
    leaf, one order)."""
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for p, r in zip(prog["loss"], ref["loss"]))
    med = statistics.median(ref["grad"])
    keep = [g >= EXCLUDE_BELOW * med for g in ref["grad"]]
    return {"loss": loss,
            "grad": worst_leaf(prog["grad"], ref["grad"]),
            "update": worst_leaf(prog["update"], ref["update"], keep)}


def serve_numbers(prog: List[dict], ref: List[dict]) -> Dict[str, float]:
    """Per checked answer: "images" [V,3,H,W] (over white) and "latents"
    (host); each number is the mean over the answers."""
    image = statistics.fmean(
        float((p["images"] - r["images"]).norm()
              / (r["images"] - 1.0).norm().clamp(min=1e-30))
        for p, r in zip(prog, ref))
    latent = statistics.fmean(
        float((p["latents"] - r["latents"]).norm()
              / r["latents"].norm().clamp(min=1e-30))
        for p, r in zip(prog, ref))
    return {"image": image, "latent": latent}


def load_limits(root: str, workload: str) -> Dict[str, float]:
    with open(os.path.join(root, "portbench", "limits",
                           f"{workload}.json")) as f:
        return {k: float(v) for k, v in json.load(f)["limits"].items()}


def verdict(numbers: Dict[str, float], limits: Dict[str, float]):
    """(correct, {name: {"value", "limit"}}): every number at or under its
    limit, and no number missing or not finite."""
    compared = {n: {"value": numbers.get(n), "limit": lim}
                for n, lim in limits.items()}
    ok = all(c["value"] is not None and c["value"] == c["value"]
             and c["value"] <= c["limit"] for c in compared.values())
    return ok, compared
