"""Datasets: the HGS-1M directory reader and the procedural synthetic avatars.

Port of the JAX package's ``data/dataset.py`` without OpenCV. An item is the
dict the trainers consume: input [V,9,H,W] (ImageNet-normalised RGB +
Plucker rays), UV_inital, images_output, masks_output, cam_view(_proj),
cam_pos, smpl_params, sapiens_input, item.

``HGSDataset`` reads the reference's HGS_1M item directories:
``rgb_map/VVVV.jpg``, ``mask_map/VVVV.png``, ``UV/smplxuv_albedo.png``,
``smplx.npz`` (transl, global_orient, betas, body_pose, expression, left and
right hand poses, jaw, leye, reye) and ``camera_full_calibration.json``
(per-view w2c ``R`` / ``T`` of a rig with K = 1100 f / 512 c at 1024^2),
listed in ``cfg.train_list`` (a ``.npy`` of directory paths). Images decode
through the port's threaded native decoder (``data/native_loader.py``).
``SyntheticAvatarDataset`` renders random Gaussian avatars with the dense
oracle from an orbit rig. Both draw from numpy in the JAX package's order,
so one seed gives the same items in both packages.
"""

from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sigman_release_torch.config import Config
from sigman_release_torch.data.augment import grid_distortion, orbit_camera_jitter
from sigman_release_torch.data.native_loader import decode_batch
from sigman_release_torch.geometry.cameras import (
    intrinsics_projection_matrix,
    orbit_camera,
    projection_matrix,
)

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# the reference's view order: the six front views every training item
# starts with, and the fixed evaluation views
TRAIN_FRONT_VIEWS = [30, 37, 45, 53, 65, 85]
EVAL_VIEWS = [30, 37, 45, 53, 65, 85, 0, 8, 82, 60]
SMPLX_KEYS = ("transl", "global_orient", "betas", "body_pose", "expression",
              "left_hand_pose", "right_hand_pose", "jaw_pose", "leye_pose",
              "reye_pose")


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
    """HGS-1M items from ``items`` (directory paths), or from
    ``cfg.train_list``: every item but each hundredth for training, each
    hundredth (at most 2000) for eval. A training item reads the six front
    views, then the other views in a random order (``num_views`` in all);
    an eval item reads ``EVAL_VIEWS``. Images decode at the larger of
    ``input_size`` and ``output_size``; a missing ``smplx.npz`` gives 179
    zeros (the canonical pose), a view missing from the camera json the
    identity pose, a file that fails to decode a zero frame."""

    def __init__(self, cfg: Config, items: Optional[Sequence[str]] = None,
                 training: bool = True, seed: int = 0,
                 decode_threads: int = 4):
        self.cfg = cfg
        self.training = training
        self.decode_threads = decode_threads
        self.rng = np.random.default_rng(seed)
        if items is None:
            items = [str(p) for p in np.load(cfg.train_list, allow_pickle=True)]
            if training:
                items = [it for i, it in enumerate(items) if i % 100 != 0]
            else:
                items = items[::100][:2000]
        self.items = list(items)
        K = np.array([[1100.0, 0, 512.0], [0, 1100.0, 512.0], [0, 0, 1.0]])
        self.proj = intrinsics_projection_matrix(cfg.znear, cfg.zfar, K,
                                                 1024, 1024)

    def __len__(self):
        return len(self.items)

    def _view_ids(self) -> List[int]:
        if self.training:
            return TRAIN_FRONT_VIEWS + self.rng.permutation(89).tolist()
        return list(EVAL_VIEWS)

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        uid = self.items[idx]
        with open(os.path.join(uid, "camera_full_calibration.json")) as f:
            cam_json = json.load(f)
        try:
            sp = np.load(os.path.join(uid, "smplx.npz"), allow_pickle=True)
            smpl_params = np.concatenate(
                [np.asarray(sp[k], np.float32).reshape(1, -1)
                 for k in SMPLX_KEYS], axis=-1)[0]
        except (FileNotFoundError, KeyError):
            smpl_params = np.zeros(179, np.float32)

        vids = self._view_ids()[: cfg.num_views]
        S = max(cfg.input_size, cfg.output_size)
        rgb = decode_batch(
            [os.path.join(uid, "rgb_map", f"{v:04d}.jpg") for v in vids],
            S, S, 3, n_threads=self.decode_threads)           # [V,S,S,3]
        mk = decode_batch(
            [os.path.join(uid, "mask_map", f"{v:04d}.png") for v in vids],
            S, S, 1, n_threads=self.decode_threads)
        w2cs = []
        for vid in vids:
            w2c = np.eye(4, dtype=np.float32)
            try:
                pose = cam_json[f"{vid:04d}"]
                w2c[:3, :3] = np.asarray(pose["R"], np.float32)
                w2c[:3, 3] = np.asarray(pose["T"], np.float32)
            except Exception:
                w2c = np.eye(4, dtype=np.float32)
            w2cs.append(w2c)
        uv = decode_batch([os.path.join(uid, "UV", "smplxuv_albedo.png")],
                          cfg.input_size, cfg.input_size, 3,
                          n_threads=1)[0].transpose(2, 0, 1)
        return self._pack(rgb.transpose(0, 3, 1, 2), mk[..., 0],
                          np.stack(w2cs), uv, smpl_params, uid)

    # the shared tail (the synthetic dataset's too)
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
