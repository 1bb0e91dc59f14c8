"""Seeded inputs on the device: the procedural body and its template, the
weights of every network, item pools, poses, cameras, images and draws.

Everything here is made from ``--seed`` and handed to both sides: the
program under test (``sigman_release_torch``) and the plain reference
(``portbench/reference``). The same seed gives the same tensors on the same
device. Weights follow the port's conventions (``inference.random_weights_``:
linear / conv weights N(0, 1/fan_in), biases 0, other vectors 1; the VAE's
Gaussian heads at std ``HEAD_INIT_STD`` so that the decoded offsets start
near the template and the avatar covers the views; the UV query grid N(0, 1);
LPIPS heads 1/C), but are drawn in a few large calls per module.

The procedural body is the port's ``body.smplx.synthetic_body_model`` (at
commit a519890) redrawn on the device; its template is the frozen
``reference.body.template.synthetic_template``.
"""

from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.body.smplx import NUM_JOINTS, SMPLX_PARENTS, SMPLXModel
from portbench.reference.body.template import synthetic_template
from portbench.reference.geometry.cameras import (
    camera_bundle,
    orbit_camera,
    projection_matrix,
)
from portbench.reference.geometry.rays import plucker_rays

HEAD_INIT_STD = 1e-3             # sigman_release_torch.inference.HEAD_INIT_STD
IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# elements drawn by one randn call when weights are made
DRAW_ELEMS = 1 << 28


def sub_seed(seed: int, *keys: int) -> int:
    """A 63-bit seed for one stream of draws, from the run's seed and keys."""
    s = int(seed) % (1 << 62)
    for k in keys:
        s = (s * 1_000_003 + int(k) + 1) % (1 << 62)
    return s


def generator(device, seed: int, *keys: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(sub_seed(seed, *keys))


# ---------------------------------------------------------------- weights


def weight_rule(name: str, shape) -> Tuple[str, float]:
    """(kind, value) of one parameter by the port's conventions: ("normal",
    std), ("fill", value)."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith("lins."):                     # LPIPS heads: 1/C
        return "fill", 1.0 / shape[1]
    if name.endswith("uv_latent"):
        return "normal", 1.0
    if len(shape) >= 2:
        if name.startswith("heads."):
            return "normal", HEAD_INIT_STD
        return "normal", 1.0 / math.sqrt(math.prod(shape[1:]))
    if leaf == "bias":
        return "fill", 0.0
    return "fill", 1.0


def seeded_state(named_shapes: Iterable[Tuple[str, tuple]], device,
                 seed: int, key: int) -> Dict[str, torch.Tensor]:
    """A state dict of f32 device tensors: every normal leaf is a slice of
    one of a few large standard-normal draws, scaled in place."""
    named_shapes = list(named_shapes)
    gen = generator(device, seed, key)
    out: Dict[str, torch.Tensor] = {}
    pending, size = [], 0

    def flush():
        nonlocal pending, size
        if not pending:
            return
        buf = torch.randn(size, generator=gen, device=device)
        at = 0
        for name, shape, std in pending:
            n = math.prod(shape)
            out[name] = buf[at:at + n].view(shape).mul_(std)
            at += n
        pending, size = [], 0

    for name, shape in named_shapes:
        kind, value = weight_rule(name, shape)
        if kind == "fill":
            out[name] = torch.full(shape, value, device=device)
            continue
        n = math.prod(shape)
        if size + n > DRAW_ELEMS:
            flush()
        pending.append((name, tuple(shape), value))
        size += n
    flush()
    return {name: out[name] for name, _ in named_shapes}


def module_shapes(module: torch.nn.Module):
    return [(n, tuple(p.shape)) for n, p in module.named_parameters()]


# ------------------------------------------------------------------- body


def body_model(n_verts: int, seed: int, device) -> SMPLXModel:
    """The procedural SMPL-X-shaped body of ``n_verts`` vertices (one
    Gaussian per strip face), drawn on the device."""
    J = NUM_JOINTS
    parents = torch.as_tensor(SMPLX_PARENTS.astype(np.int64))
    g_host = torch.Generator().manual_seed(sub_seed(seed, 100))
    joints = torch.zeros((J, 3), dtype=torch.float64)
    dirs = torch.randn((J, 3), generator=g_host, dtype=torch.float64)
    lengths = torch.rand(J, generator=g_host, dtype=torch.float64) * 0.1 + 0.05
    for j in range(1, J):
        d = dirs[j].clone()
        d[1] -= 0.5
        d[2] *= 0.2
        joints[j] = joints[parents[j]] + d / (d.norm() + 1e-6) * lengths[j]
    joints[:, 2] *= 0.25
    joints = joints.float().to(device)
    par = parents.to(device)

    g = generator(device, seed, 101)
    seg = torch.randint(1, J, (n_verts,), generator=g, device=device)
    t = torch.rand((n_verts, 1), generator=g, device=device)
    base = joints[par[seg]] * (1 - t) + joints[seg] * t
    verts = base + 0.015 * torch.randn((n_verts, 3), generator=g,
                                       device=device)
    d2 = ((verts[:, None, :] - joints[None]) ** 2).sum(-1)     # [n, J]
    w = torch.exp(-d2 / 0.002)
    top4 = torch.topk(w, 4, dim=1).indices
    w = torch.zeros_like(w).scatter_(1, top4, w.gather(1, top4))
    w = w / w.sum(-1, keepdim=True)
    reg = torch.zeros((J, n_verts), device=device)
    nearest = torch.topk(d2, 8, dim=0, largest=False).indices  # [8, J]
    reg.scatter_(1, nearest.T, 1.0 / 8)
    faces = np.stack([np.arange(n_verts - 2), np.arange(1, n_verts - 1),
                      np.arange(2, n_verts)], axis=-1).astype(np.int64)

    def normal(shape, std):
        return std * torch.randn(shape, generator=g, device=device)

    return SMPLXModel(
        v_template=verts.contiguous(),
        shapedirs=normal((n_verts, 3, 10), 0.01),
        expr_dirs=normal((n_verts, 3, 10), 0.002),
        posedirs=normal(((J - 1) * 9, n_verts * 3), 0.001),
        J_regressor=reg,
        lbs_weights=w.contiguous(),
        parents=SMPLX_PARENTS.copy(),
        faces=faces,
        hand_components_l=normal((12, 45), 0.02),
        hand_components_r=normal((12, 45), 0.02),
        hand_mean_l=torch.zeros(45, device=device),
        hand_mean_r=torch.zeros(45, device=device),
    )


def body_and_template(n_verts: int, seed: int, device):
    body = body_model(n_verts, seed, device)
    return body, synthetic_template(body)


# ----------------------------------------------------------------- images


def smooth_images(n: int, size: int, gen: torch.Generator, device,
                  cells: int = 8) -> torch.Tensor:
    """[n, 3, size, size] smooth colour fields in (0, 1)."""
    base = torch.randn((n, 3, cells, cells), generator=gen, device=device)
    up = F.interpolate(base, size=(size, size), mode="bicubic",
                       align_corners=False)
    return torch.sigmoid(1.5 * up)


def silhouettes(n: int, size: int, gen: torch.Generator, device):
    """[n, 1, size, size] ellipse masks, about a body's share of a view."""
    c = 0.5 + 0.06 * (torch.rand((n, 2, 1, 1), generator=gen,
                                 device=device) - 0.5)
    ax = torch.rand((n, 2, 1, 1), generator=gen, device=device)
    ax = torch.stack([0.12 + 0.08 * ax[:, 0], 0.32 + 0.1 * ax[:, 1]], 1)
    ys, xs = torch.meshgrid(
        (torch.arange(size, device=device) + 0.5) / size,
        (torch.arange(size, device=device) + 0.5) / size, indexing="ij")
    q = ((xs - c[:, 0]) / ax[:, 0]) ** 2 + ((ys - c[:, 1]) / ax[:, 1]) ** 2
    return (q <= 1.0).float()[:, None]


def imagenet(x: torch.Tensor) -> torch.Tensor:
    mean = x.new_tensor(IMAGENET_MEAN)[:, None, None]
    std = x.new_tensor(IMAGENET_STD)[:, None, None]
    return (x - mean) / std


def item_pool(cfg, n_items: int, seed: int, device) -> Dict[str, torch.Tensor]:
    """``n_items`` procedural avatar items: V views of a white-background
    composite at the output size, their masks, and the initial UV albedo."""
    g = generator(device, seed, 200)
    V, S = cfg.num_views, cfg.output_size
    colour = smooth_images(n_items * V, S, g, device)
    mask = silhouettes(n_items * V, S, g, device)
    views = colour * mask + (1.0 - mask)
    return {"views": views.reshape(n_items, V, 3, S, S),
            "masks": mask.reshape(n_items, V, 1, S, S),
            "uv": smooth_images(n_items, cfg.input_size, g, device)}


def cameras(cfg, rng: np.random.Generator, num_views: int, jitter: bool):
    """(cam_view [V,4,4], cam_view_proj [V,4,4], c2w [V,4,4]) of an orbit:
    with ``jitter`` the training rig (elevation U(-20, 30), azimuth 360 v / V
    + U(0, 20)), else the serving rig (10 degrees, 360 v / V)."""
    proj = projection_matrix(cfg.znear, cfg.zfar, cfg.fovx, cfg.fovy)
    c2ws = []
    for v in range(num_views):
        el = rng.uniform(-20, 30) if jitter else 10.0
        az = 360.0 * v / num_views + (rng.uniform(0, 20) if jitter else 0.0)
        c2ws.append(orbit_camera(el, az, cfg.cam_radius))
    c2ws = np.stack(c2ws)
    cam_view, cam_view_proj, _ = camera_bundle(c2ws, proj)
    return cam_view, cam_view_proj, c2ws.astype(np.float32)


def resize(x: torch.Tensor, size: int) -> torch.Tensor:
    if x.shape[-1] == size:
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def train_batch(cfg, pool, batch: int, step: int, seed: int, device,
                with_cond: bool = False) -> Dict[str, torch.Tensor]:
    """Step ``step``'s batch: items ``step * batch ...`` of the pool in
    turn, each with its own orbit jitter and SMPL-X draw, so no two steps
    see the same rows. Keys as the port's loader gives them."""
    rng = np.random.default_rng(sub_seed(seed, 300, step))
    n_pool = pool["views"].shape[0]
    ids = [(step * batch + i) % n_pool for i in range(batch)]
    Vin, S_in = cfg.num_input_views, cfg.input_size
    rows = {k: [] for k in ("input", "UV_inital", "images_output",
                            "masks_output", "cam_view", "cam_view_proj",
                            "smpl_params", "sapiens_input")}
    for i in ids:
        cv, cvp, c2w = cameras(cfg, rng, cfg.num_views, jitter=True)
        views = pool["views"][i]
        rays = torch.stack([
            plucker_rays(torch.as_tensor(c2w[v], device=device), S_in, S_in,
                         cfg.fovy).permute(2, 0, 1) for v in range(Vin)])
        images_in = imagenet(resize(views[:Vin], S_in))
        rows["input"].append(torch.cat([images_in, rays], 1))
        rows["UV_inital"].append(pool["uv"][i])
        rows["images_output"].append(views)
        rows["masks_output"].append(pool["masks"][i])
        rows["cam_view"].append(torch.as_tensor(cv, device=device))
        rows["cam_view_proj"].append(torch.as_tensor(cvp, device=device))
        rows["smpl_params"].append(torch.as_tensor(
            rng.normal(0, 0.1, 175).astype(np.float32), device=device))
        if with_cond:
            cond = int(rng.integers(0, min(4, Vin)))
            rows["sapiens_input"].append(imagenet(resize(views[cond:cond + 1],
                                                         S_in))[0])
    return {k: torch.stack(v) for k, v in rows.items() if v}


def vae_noise(cfg, batch: int, seed: int, step: int, device) -> torch.Tensor:
    """The posterior sample's standard normal draw [B, h, w, Cl]."""
    q = cfg.uv_query_size
    return torch.randn((batch, q, q, cfg.latent_channels),
                       generator=generator(device, seed, 400, step),
                       device=device)


def dropout_seed(seed: int, step: int) -> int:
    """Seed of the generator that the VAE's bottleneck dropout masks of
    step ``step`` are drawn from (the trainer's generator is reseeded)."""
    return sub_seed(seed, 500, step)


def dit_draws(cfg, batch: int, seed: int, step: int, device):
    """One DiT step's draws (``DiTTrainer.draw``'s keys)."""
    g = generator(device, seed, 600, step)
    q, c = cfg.uv_query_size, cfg.latent_channels
    return {
        "enc_noise": torch.randn((batch, q, q, c), generator=g, device=device),
        "t": torch.randint(0, cfg.num_train_timesteps, (batch,), generator=g,
                           device=device),
        "noise": torch.randn((batch, c, q, q), generator=g, device=device),
        "drop": torch.rand((batch, 1, 1, 1), generator=g, device=device)
        < cfg.noised_condition_dropout,
    }


def request_pool(cfg, n: int, seed: int, device):
    """Serving requests' pool: ``n`` ImageNet-normalised 512^2 photos (a
    figure on white) and ``n`` SMPL-X vectors (175-d)."""
    g = generator(device, seed, 700)
    S = cfg.input_size
    photo = smooth_images(n, S, g, device)
    mask = silhouettes(n, S, g, device)
    poses = 0.1 * torch.randn((n, 175), generator=g, device=device)
    return {"images": imagenet(photo * mask + (1.0 - mask)), "poses": poses}


def answer(cfg, pool, seed: int, index: int, device):
    """Answer ``index`` (one avatar): (image [1,3,S,S], pose [1,175], noise
    [1,Cl,h,w]), drawn from the seed. Request i of a batch-B mix asks for
    answers iB ... iB + B - 1."""
    n = pool["images"].shape[0]
    rng = np.random.default_rng(sub_seed(seed, 800, index))
    i, p = int(rng.integers(n)), int(rng.integers(n))
    noise = torch.randn((1, cfg.latent_channels, cfg.sample_height,
                         cfg.sample_width),
                        generator=generator(device, seed, 801, index),
                        device=device)
    return pool["images"][i:i + 1], pool["poses"][p:p + 1], noise


def request(cfg, pool, seed: int, index: int, batch: int, device):
    """Request ``index``: its ``batch`` answers stacked."""
    parts = [answer(cfg, pool, seed, index * batch + j, device)
             for j in range(batch)]
    return tuple(torch.cat(x) for x in zip(*parts))
