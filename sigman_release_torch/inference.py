"""Image -> avatar inference: image + pose -> DiT sampling -> VAE decode ->
LBS deform -> tile-rasterizer render.

Port of ``scripts/test_DiT.py`` ``main()`` (single-image path). Run as::

    python -m sigman_release_torch.inference --preset dit --out_dir out/

The models carry seeded random weights (``--seed``); ``--vae_ckpt`` and
``--dit_ckpt`` load trained ones from any of the three state-file formats
(``training/checkpoint.py``: the port's own trainer state, the JAX
package's msgpack state file, the reference's safetensors), and
``AvatarPipeline.load_state_dicts`` takes converted ones (``convert.py``).
Without ``--image_path`` the conditioning image is a seeded random array;
without ``--pose_path`` the body takes the canonical pose.
Views are written as ``view_XX.png`` and ``views.npy``. Runs on CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import math
import os
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from sigman_release_torch.body.deformer import GaussianDeformer
from sigman_release_torch.body.smplx import (
    SMPLXModel,
    load_smplx_npz,
    parse_param_vector,
    synthetic_body_model,
)
from sigman_release_torch.body.template import (
    TemplateAssets,
    load_template_dir,
    synthetic_template,
)
from sigman_release_torch.config import PRESETS, Config
from sigman_release_torch.device import resolve_device
from sigman_release_torch.diffusion.ddim import DDIMScheduler
from sigman_release_torch.diffusion.pipeline import SamplePipeline
from sigman_release_torch.geometry.cameras import (
    camera_bundle,
    intrinsics_projection_matrix,
    orbit_camera,
    projection_matrix,
)
from sigman_release_torch.models.dit import DiTModel
from sigman_release_torch.models.encoders import ViTFeatureEncoder
from sigman_release_torch.models.vae import (
    VAEModel,
    compose_rotations,
    sample_gaussian_attrs,
)
from sigman_release_torch.renderer import GaussianRenderer
from sigman_release_torch.utils.image_io import load_image, write_png
from sigman_release_torch.utils.timing import NULL_TIMER

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# the reference's fixed 20-view evaluation rig
TEST_VIEW_IDS = [30, 37, 45, 53, 65, 85, 0, 6, 15, 24, 34, 41, 49, 57, 60,
                 68, 72, 75, 80, 83]

_SMPLX_KEYS = ("transl", "global_orient", "betas", "body_pose", "expression",
               "left_hand_pose", "right_hand_pose", "jaw_pose", "leye_pose",
               "reye_pose")

# std of the Gaussian heads' random init: keeps decoded offsets near zero, so
# a randomly initialised avatar stays on the template body surface
HEAD_INIT_STD = 1e-3


def load_pose(path: str, frame: int = 0) -> np.ndarray:
    """SMPL-X pose npz -> [1, 188] param vector in the reference's
    (transl, global_orient, betas, body_pose, expression, lhand, rhand,
    jaw, leye, reye) order: single poses, pose sequences (``frame`` selects
    one) and AMASS exports (betas zeroed, as the reference loads them)."""
    d = np.load(path, allow_pickle=True)
    if "pose_body" in d:  # AMASS layout
        T = d["pose_body"].shape[0]
        parts = [d["trans"], d["root_orient"], np.zeros((T, 10)),
                 d["pose_body"], np.zeros((T, 10)),
                 d["pose_hand"][:, :45], d["pose_hand"][:, 45:],
                 d["pose_jaw"], d["pose_eye"][:, :3], d["pose_eye"][:, 3:]]
        vec = np.concatenate(
            [np.asarray(p, np.float32).reshape(T, -1) for p in parts], -1)
        return vec[frame:frame + 1]
    betas = np.asarray(d["betas"])
    if betas.ndim == 2:  # sequence layout: pick one frame
        parts = [np.asarray(d[k], np.float32)[frame].reshape(1, -1)
                 for k in _SMPLX_KEYS]
    else:
        parts = [np.asarray(d[k], np.float32).reshape(1, -1)
                 for k in _SMPLX_KEYS]
    return np.concatenate(parts, axis=-1)


def load_camera_rig(camera_json: str, view_ids, znear, zfar):
    """Calibrated rig (K=1100 @1024^2 intrinsics, w2c R/T per view)."""
    with open(camera_json) as f:
        cams = json.load(f)
    K = np.array([[1100.0, 0, 512.0], [0, 1100.0, 512.0], [0, 0, 1.0]])
    proj = intrinsics_projection_matrix(znear, zfar, K, 1024, 1024)
    w2cs = []
    for vid in view_ids:
        pose = cams[f"{vid:04d}"]
        w2c = np.eye(4, dtype=np.float32)
        w2c[:3, :3] = np.asarray(pose["R"], np.float32)
        w2c[:3, 3] = np.asarray(pose["T"], np.float32)
        w2cs.append(w2c)
    cam_view = np.transpose(np.stack(w2cs), (0, 2, 1)).astype(np.float32)
    cam_view_proj = (cam_view @ proj.T).astype(np.float32)
    return cam_view, cam_view_proj


def orbit_rig(cfg: Config, num_views: int):
    """``num_views`` cameras on a 10-degree-elevation orbit."""
    proj = projection_matrix(cfg.znear, cfg.zfar, cfg.fovx, cfg.fovy)
    c2ws = np.stack([orbit_camera(10.0, 360.0 * v / num_views, cfg.cam_radius)
                     for v in range(num_views)])
    cam_view, cam_view_proj, _ = camera_bundle(c2ws, proj)
    return cam_view, cam_view_proj


def normalize_image(img: np.ndarray, input_size: int) -> torch.Tensor:
    """[H,W,3] RGB in [0,1] -> [1,3,S,S] ImageNet-normalized (bilinear
    resize when the size differs)."""
    x = torch.from_numpy(np.ascontiguousarray(img, np.float32))
    x = x.permute(2, 0, 1)[None]
    if x.shape[-2:] != (input_size, input_size):
        x = F.interpolate(x, size=(input_size, input_size), mode="bilinear",
                          align_corners=False)
    mean = torch.from_numpy(IMAGENET_MEAN)[None, :, None, None]
    std = torch.from_numpy(IMAGENET_STD)[None, :, None, None]
    return (x - mean) / std


def random_weights_(module: nn.Module, generator: torch.Generator,
                    std: Optional[float] = None) -> nn.Module:
    """Seeded init: linear/conv weights N(0, 1/fan_in) (or ``std``), biases
    0, norm weights 1 — drawn from ``generator`` only."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim >= 2:
                fan_in = p[0].numel()
                p.normal_(0.0, std or 1.0 / math.sqrt(fan_in),
                          generator=generator)
            elif leaf == "bias":
                p.zero_()
            else:
                p.fill_(1.0)
    return module


class AvatarPipeline:
    """Encoder + DiT + VAE decoder + deformer + renderer on one device."""

    def __init__(self, cfg: Config, *, device="cuda", seed: int = 0,
                 body_model: Optional[SMPLXModel] = None,
                 template: Optional[TemplateAssets] = None):
        dev = resolve_device(device)
        self.cfg, self.device = cfg, dev

        def build(make, offset):
            with torch.device("meta"):
                module = make()
            module = module.to_empty(device=dev)
            g = torch.Generator(device=dev).manual_seed(seed + offset)
            return random_weights_(module, g).eval()

        self.vae = build(lambda: VAEModel(cfg, with_encoder=False), 0)
        g = torch.Generator(device=dev).manual_seed(seed + 3)
        random_weights_(self.vae.heads, g, std=HEAD_INIT_STD)
        self.encoder = build(
            lambda: ViTFeatureEncoder(embed_dim=cfg.text_embed_dim), 1)
        self.dit = build(lambda: DiTModel(cfg), 2)
        if cfg.mixed_precision == "bf16":
            self.dit = self.dit.to(torch.bfloat16)
        self.sampler = SamplePipeline(
            cfg, DDIMScheduler.from_config(cfg, device=dev))

        if body_model is None:
            body_model = (load_smplx_npz(cfg.smplx_model_path)
                          if cfg.smplx_model_path else synthetic_body_model())
        body_model = body_model.to(dev)
        if template is None:
            try:
                template = load_template_dir(cfg.template_dir)
            except (FileNotFoundError, OSError):
                template = synthetic_template(body_model)
        self.template = template.to(dev)
        t = self.template
        self.deformer = GaussianDeformer(body_model, t.init_faces,
                                         t.init_spdir, t.init_podir,
                                         t.init_lbsw, t.weight_mask())
        with torch.no_grad():
            self.deformer_state = self.deformer.initialize()
        self.renderer = GaussianRenderer(cfg)

    def load_state_dicts(self, vae=None, dit=None, encoder=None):
        """Load converted weights (``convert.py``) into the models."""
        for module, sd in ((self.vae, vae), (self.dit, dit),
                           (self.encoder, encoder)):
            if sd is not None:
                module.load_state_dict(sd)

    def load_checkpoints(self, vae: Optional[str] = None,
                         dit: Optional[str] = None):
        """The decode side of the VAE and the DiT from state files in any
        of the three formats (``checkpoint.load_params_any``)."""
        from sigman_release_torch.training.checkpoint import load_params_any

        for module, path in ((self.vae, vae), (self.dit, dit)):
            if path:
                module.load_state_dict(
                    load_params_any(path, module, self.cfg)[0])

    @torch.no_grad()
    def __call__(self, image: torch.Tensor, smpl_vec: Optional[torch.Tensor],
                 cam_view: torch.Tensor, cam_view_proj: torch.Tensor, *,
                 noise: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None,
                 steps: Optional[int] = None,
                 timer=NULL_TIMER) -> Dict[str, torch.Tensor]:
        """image [B,3,S,S] ImageNet-normalized; smpl_vec [B,D] flat SMPL-X
        parameters or None (canonical pose); cameras [V,4,4].

        Returns latents, attr_map, the per-Gaussian attributes, posed points
        and transforms, and the render (image [B,V,3,H,W], alpha, depth,
        overflow).
        """
        cfg, dev = self.cfg, self.device
        with timer("encoder"):
            cond = self.encoder(image.to(dev))
        with timer("dit_sampling"):
            latents = self.sampler.sample_latents(
                self.dit, cond, generator=generator, noise=noise,
                num_inference_steps=steps or cfg.num_inference_steps,
                guidance_scale=cfg.guidance_scale)
        t = self.template
        with timer("decode"):
            # sample_latents already divided by vae_scaling_factor
            attr_map = self.vae.decode(latents.permute(0, 2, 3, 1))
            attrs = sample_gaussian_attrs(attr_map, t.init_uv)
        with timer("deform"):
            canon = t.init_pcd[None] + attrs["offset"]
            params = parse_param_vector(
                None if smpl_vec is None else smpl_vec.to(dev),
                batch=image.shape[0], device=dev)
            posed = self.deformer.prepare(params)
            points, tfs = self.deformer(self.deformer_state, posed, canon)
            rot = compose_rotations(attrs["rot"], t.init_rot, tfs)
        gaussians = {"position": points, "opacity": attrs["opacity"],
                     "scale": attrs["scale"], "cov3d": rot,
                     "rgb": attrs["rgb"]}
        B = image.shape[0]
        cv = cam_view.to(dev)[None].expand(B, -1, -1, -1)
        cvp = cam_view_proj.to(dev)[None].expand(B, -1, -1, -1)
        render = self.renderer.render(gaussians, cv, cvp, timer=timer)
        return {"latents": latents, "attr_map": attr_map, "attrs": attrs,
                "gaussians": gaussians, "tfs": tfs, "render": render}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="test_tiny", choices=sorted(PRESETS))
    ap.add_argument("--image_path", default=None,
                    help=".npy [H,W,3] or an image file; default: seeded noise")
    ap.add_argument("--pose_path", default=None,
                    help="SMPL-X pose npz; default: canonical pose")
    ap.add_argument("--frame", type=int, default=0,
                    help="frame for sequence/AMASS pose files")
    ap.add_argument("--camera_json", default=None,
                    help="90-camera calibration json; renders the fixed "
                         "20-view test rig instead of an orbit")
    ap.add_argument("--num_views", type=int, default=4)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--out_dir", default="./workspace/inference")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--vae_ckpt", default=None,
                    help="VAE weights: a VAE trainer state (.pt), a msgpack "
                         "state file or autoencoder.safetensors")
    ap.add_argument("--dit_ckpt", default=None,
                    help="DiT weights: a DiT trainer state (.pt), a msgpack "
                         "state file or transformer.safetensors")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    dev = resolve_device(args.device)
    pipe = AvatarPipeline(cfg, device=dev, seed=args.seed)
    pipe.load_checkpoints(vae=args.vae_ckpt, dit=args.dit_ckpt)

    if args.image_path:
        img = load_image(args.image_path)
    else:
        rng = np.random.default_rng(args.seed)
        img = rng.uniform(0, 1, (cfg.input_size, cfg.input_size, 3))
    image = normalize_image(img, cfg.input_size)
    smpl_vec = (torch.from_numpy(load_pose(args.pose_path, args.frame))
                if args.pose_path else None)
    if args.camera_json and os.path.exists(args.camera_json):
        cv, cvp = load_camera_rig(args.camera_json, TEST_VIEW_IDS,
                                  cfg.znear, cfg.zfar)
    else:
        cv, cvp = orbit_rig(cfg, args.num_views)
    gen = torch.Generator(device=dev).manual_seed(args.seed + 4)
    out = pipe(image, smpl_vec, torch.from_numpy(cv), torch.from_numpy(cvp),
               generator=gen, steps=args.steps)

    os.makedirs(args.out_dir, exist_ok=True)
    imgs = out["render"]["image"][0].float().cpu().numpy()   # [V,3,H,W]
    np.save(os.path.join(args.out_dir, "views.npy"), imgs)
    for v in range(imgs.shape[0]):
        write_png(os.path.join(args.out_dir, f"view_{v:02d}.png"),
                  (imgs[v].transpose(1, 2, 0) * 255).astype(np.uint8))
    print(f"wrote {imgs.shape[0]} views to {args.out_dir} "
          f"(overflow {int(out['render']['overflow'].sum())})")


if __name__ == "__main__":
    main()
