"""Host-side data augmentation (numpy): grid distortion + camera jitter.

Port of the JAX package's ``data/augment.py`` without OpenCV: the warp is a
bilinear remap with a constant 0 border written out in numpy (OpenCV's
``remap(INTER_LINEAR, BORDER_CONSTANT)`` on float images, which samples at
the exact map positions).
"""

from __future__ import annotations

import numpy as np
import torch

from sigman_release_torch.ops.rotations import rodrigues


def remap_bilinear(img: np.ndarray, map_x: np.ndarray,
                   map_y: np.ndarray) -> np.ndarray:
    """``cv2.remap(img, map_x, map_y, INTER_LINEAR, BORDER_CONSTANT)``:
    img [H,W,C] float; maps [h,w] float32 source pixel coordinates."""
    H, W = img.shape[:2]
    x0 = np.floor(map_x).astype(np.int64)
    y0 = np.floor(map_y).astype(np.int64)
    ax = (map_x - x0).astype(np.float32)
    ay = (map_y - y0).astype(np.float32)
    out = np.zeros(map_x.shape + img.shape[2:], np.float32)
    for dy, wy in ((0, 1.0 - ay), (1, ay)):
        for dx, wx in ((0, 1.0 - ax), (1, ax)):
            xs, ys = x0 + dx, y0 + dy
            ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
            tap = img[np.clip(ys, 0, H - 1), np.clip(xs, 0, W - 1)]
            wt = np.where(ok, wx * wy, 0.0).astype(np.float32)
            out += tap * wt[..., None]
    return out.astype(img.dtype)


def grid_distortion(images: np.ndarray, rng: np.random.Generator,
                    strength: float = 0.5) -> np.ndarray:
    """Random smooth warp. images [V,C,H,W] float in [0,1]."""
    V, C, H, W = images.shape
    num_steps = int(rng.integers(8, 17))
    out = np.empty_like(images)
    for v in range(V):
        x_steps = np.linspace(0, 1, num_steps)
        x_steps = np.clip(
            x_steps + strength * (rng.random(num_steps) - 0.5) / (num_steps - 1),
            0, 1)
        x_steps = (x_steps * W).astype(np.int64)
        x_steps[0], x_steps[-1] = 0, W
        y_steps = np.linspace(0, 1, num_steps)
        y_steps = np.clip(
            y_steps + strength * (rng.random(num_steps) - 0.5) / (num_steps - 1),
            0, 1)
        y_steps = (y_steps * H).astype(np.int64)
        y_steps[0], y_steps[-1] = 0, H

        grid_steps = np.linspace(-1, 1, num_steps)
        xs = np.concatenate([
            np.linspace(grid_steps[i], grid_steps[i + 1],
                        x_steps[i + 1] - x_steps[i], endpoint=False)
            for i in range(num_steps - 1)])
        ys = np.concatenate([
            np.linspace(grid_steps[i], grid_steps[i + 1],
                        y_steps[i + 1] - y_steps[i], endpoint=False)
            for i in range(num_steps - 1)])
        # normalized [-1,1] -> pixel coords (align_corners=False convention)
        map_x = ((xs + 1) * W - 1) * 0.5
        map_y = ((ys + 1) * H - 1) * 0.5
        mx, my = np.meshgrid(map_x.astype(np.float32),
                             map_y.astype(np.float32))
        out[v] = remap_bilinear(images[v].transpose(1, 2, 0), mx,
                                my).transpose(2, 0, 1)
    return out


def orbit_camera_jitter(poses: np.ndarray, rng: np.random.Generator,
                        strength: float = 0.1,
                        is_w2c: bool = False) -> np.ndarray:
    """Rotate cameras around the subject. poses [V,4,4]."""
    V = poses.shape[0]
    rotvec_x = poses[:, :3, 1] * (
        strength * np.pi * (rng.random((V, 1)) * 2 - 1))
    rotvec_y = poses[:, :3, 0] * (
        strength * np.pi / 2 * (rng.random((V, 1)) * 2 - 1))
    rx = rodrigues(torch.from_numpy(rotvec_x.astype(np.float32))).numpy()
    ry = rodrigues(torch.from_numpy(rotvec_y.astype(np.float32))).numpy()
    rot = rx @ ry
    out = poses.copy()
    if is_w2c:
        rot_inv = rot.transpose(0, 2, 1)
        out[:, :3, :3] = poses[:, :3, :3] @ rot_inv
        out[:, :3, 3:] = -out[:, :3, :3] @ rot @ (-poses[:, :3, 3:])
    else:
        out[:, :3, :3] = rot @ poses[:, :3, :3]
        out[:, :3, 3:] = rot @ poses[:, :3, 3:]
    return out
