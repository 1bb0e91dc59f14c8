"""Training and eval image dumps: one PNG grid of ground truth beside
prediction (port of the JAX package's ``utils/visualize.py``, written with
``utils.image_io.write_png`` instead of OpenCV)."""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from sigman_release_torch.utils.image_io import write_png


def save_visualization(outputs: Dict[str, np.ndarray], path: str,
                       max_views: int = 4) -> str:
    """``images_pred`` / ``images_gt`` [B,V,3,H,W] in [0,1] -> one PNG:
    a row per batch item, and per view (at most ``max_views``) the ground
    truth then the prediction. Returns ``path``."""
    pred = np.asarray(outputs["images_pred"], np.float32)
    gt = np.asarray(outputs["images_gt"], np.float32)
    b, v = pred.shape[:2]
    v = min(v, max_views)
    rows = [np.concatenate([img[i, j].transpose(1, 2, 0)
                            for j in range(v) for img in (gt, pred)], axis=1)
            for i in range(b)]
    grid = np.clip(np.concatenate(rows, axis=0), 0.0, 1.0)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    write_png(path, (grid * 255).astype(np.uint8))
    return path
