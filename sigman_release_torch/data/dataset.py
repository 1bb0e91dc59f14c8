"""Datasets: the shared item packing and the procedural synthetic avatars.

Port of the JAX package's ``data/dataset.py`` without OpenCV. An item is the
dict the trainer consumes: input [V,9,H,W] (ImageNet-normalised RGB +
Plucker rays), UV_inital, images_output, masks_output, cam_view(_proj),
cam_pos, smpl_params, sapiens_input. ``SyntheticAvatarDataset`` renders
random Gaussian avatars with the dense oracle from an orbit rig, with the
JAX package's numpy random recipe, so one seed gives the same items in both
packages. The HGS-1M file reader (JPEG/PNG decoding) is not ported yet.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from sigman_release_torch.config import Config
from sigman_release_torch.data.augment import grid_distortion, orbit_camera_jitter
from sigman_release_torch.geometry.cameras import orbit_camera, projection_matrix

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _plucker_np(c2w: np.ndarray, h: int, w: int, fovy: float) -> np.ndarray:
    """[h,w,6] Plucker rays (OpenCV camera convention)."""
    x, y = np.meshgrid(np.arange(w), np.arange(h), indexing="xy")
    cx, cy = w * 0.5, h * 0.5
    focal = h * 0.5 / math.tan(0.5 * fovy)
    dirs = np.stack(
        [(x - cx + 0.5) / focal, (y - cy + 0.5) / focal, np.ones_like(x)],
        axis=-1).astype(np.float32)
    rays_d = dirs @ c2w[:3, :3].T
    rays_d /= np.maximum(np.linalg.norm(rays_d, axis=-1, keepdims=True), 1e-20)
    rays_o = np.broadcast_to(c2w[:3, 3].astype(np.float32), rays_d.shape)
    return np.concatenate([np.cross(rays_o, rays_d), rays_d], axis=-1)


def _resize(img: np.ndarray, size: int) -> np.ndarray:
    """Bilinear resize [C,H,W] or [H,W] to size x size: OpenCV's
    ``INTER_LINEAR`` (half-pixel centres, edge clamp, no antialiasing)."""
    t = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    t = t[None] if img.ndim == 3 else t[None, None]
    out = F.interpolate(t, size=(size, size), mode="bilinear",
                        align_corners=False)
    return (out[0] if img.ndim == 3 else out[0, 0]).numpy()


class HGSDataset:
    """HGS-1M items. Only the shared tail, ``_pack``, is ported: reading the
    files waits until such data is in the repository."""

    cfg: Config
    rng: np.random.Generator
    training: bool
    proj: np.ndarray

    def _pack(self, images, masks, w2cs, uv, smpl_params, uid):
        cfg = self.cfg
        V = images.shape[0]
        uv = _resize(uv, cfg.input_size)
        images_input = np.stack([_resize(images[v], cfg.input_size)
                                 for v in range(cfg.num_input_views)])
        w2cs_input = w2cs[: cfg.num_input_views].copy()
        if self.training:
            if self.rng.random() < cfg.prob_grid_distortion:
                images_input[1:] = grid_distortion(images_input[1:], self.rng)
            if self.rng.random() < cfg.prob_cam_jitter:
                w2cs_input[1:] = orbit_camera_jitter(w2cs_input[1:], self.rng,
                                                     is_w2c=True)
        images_input = ((images_input.transpose(0, 2, 3, 1) - IMAGENET_MEAN)
                        / IMAGENET_STD).transpose(0, 3, 1, 2)
        rays = np.stack([
            _plucker_np(np.linalg.inv(w2cs_input[v]), cfg.input_size,
                        cfg.input_size, cfg.fovy).transpose(2, 0, 1)
            for v in range(cfg.num_input_views)])
        final_input = np.concatenate([images_input, rays], axis=1)

        images_out = np.stack([_resize(images[v], cfg.output_size)
                               for v in range(V)])
        masks_out = np.stack([_resize(masks[v], cfg.output_size)[None]
                              for v in range(V)])
        cam_view = np.transpose(w2cs, (0, 2, 1)).astype(np.float32)
        cam_view_proj = (cam_view @ self.proj.T).astype(np.float32)
        cam_pos = np.linalg.inv(w2cs)[:, :3, 3].astype(np.float32)

        # DiT conditioning image: one of the first input views, white-bg
        # foreground composite, ImageNet-normalised
        cond_vid = int(self.rng.integers(0, min(4, V))) if self.training else 0
        cond = images[cond_vid] * masks[cond_vid][None] + (
            1.0 - masks[cond_vid][None])
        cond = _resize(cond, cfg.input_size)
        sapiens_input = ((cond.transpose(1, 2, 0) - IMAGENET_MEAN)
                         / IMAGENET_STD).transpose(2, 0, 1)
        return {
            "sapiens_input": sapiens_input.astype(np.float32),
            "input": final_input.astype(np.float32),
            "UV_inital": uv.astype(np.float32),
            "images_output": images_out.astype(np.float32),
            "masks_output": masks_out.astype(np.float32),
            "cam_view": cam_view,
            "cam_view_proj": cam_view_proj,
            "cam_pos": cam_pos,
            "smpl_params": smpl_params.astype(np.float32),
            "item": uid,
        }


class SyntheticAvatarDataset(HGSDataset):
    """Procedural stand-in for HGS-1M: random coloured Gaussian avatars
    rendered with the dense oracle (on the CPU) from an orbit rig. Item i
    is drawn from seed i + 1000; ``items`` lists the item numbers this
    dataset serves (all ``n_items`` until a rank keeps its share)."""

    def __init__(self, cfg: Config, n_items: int = 8, seed: int = 0,
                 n_gauss: int = 256):
        self.cfg = cfg
        self.training = True
        self.rng = np.random.default_rng(seed)
        self.items = list(range(n_items))
        self.n_gauss = n_gauss
        self.proj = projection_matrix(cfg.znear, cfg.zfar, cfg.fovx, cfg.fovy)
        self._cache: Dict[int, Dict[str, np.ndarray]] = {}

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        idx = self.items[i]
        if idx in self._cache:
            return self._cache[idx]
        from sigman_release_torch.ops.rasterizer.preprocess import build_cov3d
        from sigman_release_torch.ops.rasterizer.reference import render_dense
        from sigman_release_torch.ops.rotations import quaternion_to_matrix

        cfg = self.cfg
        rng = np.random.default_rng(idx + 1000)
        n = self.n_gauss
        means = rng.normal(0, 0.35, (n, 3)).astype(np.float32)
        rots = quaternion_to_matrix(
            torch.from_numpy(rng.normal(size=(n, 4)).astype(np.float32)))
        scales = rng.uniform(0.02, 0.06, (n, 3)).astype(np.float32)
        colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
        opacity = rng.uniform(0.5, 1.0, n).astype(np.float32)
        cov3d = build_cov3d(torch.from_numpy(scales), rots)

        V = cfg.num_views
        c2ws = np.stack([
            orbit_camera(rng.uniform(-20, 30), 360 * v / V + rng.uniform(0, 20),
                         cfg.cam_radius)
            for v in range(V)])
        w2cs = np.linalg.inv(c2ws).astype(np.float32)
        th = math.tan(0.5 * cfg.fovy)
        res = 256 if cfg.output_size > 256 else cfg.output_size
        images, masks = [], []
        with torch.no_grad():
            for v in range(V):
                cam_view = w2cs[v].T.astype(np.float32)
                cam_view_proj = (cam_view @ self.proj.T).astype(np.float32)
                out = render_dense(
                    torch.from_numpy(means), cov3d, torch.from_numpy(colors),
                    torch.from_numpy(opacity), torch.from_numpy(cam_view),
                    torch.from_numpy(cam_view_proj), th, th, res, res,
                    bg_color=torch.ones(3))
                images.append(out["image"].numpy())
                masks.append(out["alpha"][0].numpy())
        smpl_params = rng.normal(0, 0.1, 175).astype(np.float32)
        uv = rng.uniform(0, 1, (3, cfg.input_size, cfg.input_size)).astype(
            np.float32)
        item = self._pack(np.stack(images), np.stack(masks), w2cs, uv,
                          smpl_params, f"synthetic/{idx}")
        self._cache[idx] = item
        return item
