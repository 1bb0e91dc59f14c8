"""Image -> avatar inference: image + pose -> DiT sampling -> VAE decode ->
LBS deform -> tile-rasterizer render.

Port of ``scripts/test_DiT.py`` ``main()``. Run as::

    python -m sigman_release_torch.inference --preset dit --out_dir out/
    python -m sigman_release_torch.inference --preset flux1_dev --out_dir out/
    python -m sigman_release_torch.inference --preset dit --eval \
        --train_list items.npy --eval_batches 16

The models carry seeded random weights (``--seed``); ``--vae_ckpt`` and
``--dit_ckpt`` load trained ones from any of the three state-file formats
(``training/checkpoint.py``: the port's own trainer state, the JAX
package's msgpack state file, the reference's safetensors), and
``AvatarPipeline.load_state_dicts`` takes converted ones (``convert.py``).
Without ``--image_path`` the conditioning image is a seeded random array;
without ``--pose_path`` the body takes the canonical pose.
Views are written as ``view_XX.png`` and ``views.npy``, the posed splats as
``avatar.ply`` (``utils/ply.py``). ``--eval`` scores the test set instead
(``run_eval``): the held-out HGS-1M items of ``--train_list``, or
procedural avatars with ``--synthetic_data true``. Runs on CUDA unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from sigman_release_torch.avatar import LatentRenderer
from sigman_release_torch.body.smplx import SMPLXModel, parse_param_vector
from sigman_release_torch.body.template import TemplateAssets
from sigman_release_torch.config import PRESETS, Config
from sigman_release_torch.data.dataset import HGSDataset, SyntheticAvatarDataset
from sigman_release_torch.data.loader import DataLoader
from sigman_release_torch.device import resolve_device
from sigman_release_torch.diffusion.ddim import DDIMScheduler
from sigman_release_torch.diffusion.pipeline import (
    FlowSamplePipeline,
    SamplePipeline,
)
from sigman_release_torch.geometry.cameras import (
    camera_bundle,
    intrinsics_projection_matrix,
    orbit_camera,
    projection_matrix,
)
from sigman_release_torch.losses.lpips import LPIPS
from sigman_release_torch.losses.metrics import psnr, ssim
from sigman_release_torch.models.dit import DiTModel
from sigman_release_torch.models.encoders import ViTFeatureEncoder
from sigman_release_torch.models.flux import FluxModel
from sigman_release_torch.models.init import (
    HEAD_INIT_STD,
    build_on,
    random_weights_,
)
from sigman_release_torch.models.vae import (
    VAEModel,
    compose_rotations,
    sample_gaussian_attrs,
)
from sigman_release_torch.utils.image_io import load_image, write_png
from sigman_release_torch.utils.ply import save_ply
from sigman_release_torch.utils.timing import NULL_TIMER
from sigman_release_torch.utils.visualize import save_visualization

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)

# the reference's fixed 20-view evaluation rig
TEST_VIEW_IDS = [30, 37, 45, 53, 65, 85, 0, 6, 15, 24, 34, 41, 49, 57, 60,
                 68, 72, 75, 80, 83]

_SMPLX_KEYS = ("transl", "global_orient", "betas", "body_pose", "expression",
               "left_hand_pose", "right_hand_pose", "jaw_pose", "leye_pose",
               "reye_pose")


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


class AvatarPipeline:
    """Encoder + denoiser + VAE decoder + deformer + renderer on one device;
    the decoder, deformer and renderer are the VAE's ``LatentRenderer``. The
    denoiser (``self.dit``) and its sampler follow ``cfg.denoiser``: the
    DiT under the CFG DDIM loop, or FLUX under the flow Euler loop."""

    def __init__(self, cfg: Config, *, device="cuda", seed: int = 0,
                 body_model: Optional[SMPLXModel] = None,
                 template: Optional[TemplateAssets] = None):
        dev = resolve_device(device)
        self.cfg, self.device = cfg, dev

        def gen(offset):
            return torch.Generator(device=dev).manual_seed(seed + offset)

        self.vae = build_on(dev, lambda: VAEModel(cfg, with_encoder=False),
                            gen(0)).eval()
        random_weights_(self.vae.heads, gen(3), std=HEAD_INIT_STD)
        self.encoder = build_on(
            dev, lambda: ViTFeatureEncoder(embed_dim=cfg.text_embed_dim),
            gen(1)).eval()
        if cfg.denoiser == "flux":
            # 11.9 B parameters: built in the serving dtype, never whole
            # in f32
            dtype = (torch.bfloat16 if cfg.mixed_precision == "bf16"
                     else torch.float32)
            self.dit = build_on(dev, lambda: FluxModel(cfg).to(dtype),
                                gen(2)).eval()
            self.sampler = FlowSamplePipeline(cfg)
        elif cfg.denoiser == "dit":
            self.dit = build_on(dev, lambda: DiTModel(cfg), gen(2)).eval()
            if cfg.mixed_precision == "bf16":
                self.dit = self.dit.to(torch.bfloat16)
            self.sampler = SamplePipeline(
                cfg, DDIMScheduler.from_config(cfg, device=dev))
        else:
            raise ValueError(f"unknown denoiser {cfg.denoiser!r}; "
                             "'dit' or 'flux'")
        # the configured body model and template unless given, else the
        # procedural body
        self.latent_renderer = lr = LatentRenderer(
            cfg, self.vae, body_model, template, device=dev)
        self.template, self.deformer, self.renderer = (
            lr.template, lr.deformer, lr.renderer)
        self.deformer_state = lr.deformer_state

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
    def sample(self, image: torch.Tensor,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               steps: Optional[int] = None,
               timer=NULL_TIMER) -> torch.Tensor:
        """image [B,3,S,S] ImageNet-normalized -> latents [B,Cl,h,w], divided
        by ``vae_scaling_factor`` (once, in the sampler): the conditioning
        encode ("encoder" span) and the sampling loop ("dit_sampling", and
        within it the sampler's and the denoiser's spans) from ``noise``
        (default: a draw from ``generator``)."""
        cfg = self.cfg
        with timer("encoder"):
            cond = self.encoder(image.to(self.device))
        with timer("dit_sampling"):
            return self.sampler.sample_latents(
                self.dit, cond, generator=generator, noise=noise,
                num_inference_steps=steps or cfg.num_inference_steps,
                guidance_scale=cfg.guidance_scale, timer=timer)

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
        dev = self.device
        latents = self.sample(image, noise, generator, steps, timer)
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


def avatar_gaussians(points: np.ndarray, attrs: Dict[str, np.ndarray],
                     b: int = 0) -> np.ndarray:
    """The [N,14] splats of batch item ``b`` that ``avatar.ply`` holds: the
    posed positions, opacity, |scale| * 0.01 + 0.003 (the renderer's scales
    are relative to a KNN base; a file carries absolute ones), the identity
    quaternion and rgb."""
    n = points.shape[1]
    quat = np.zeros((n, 4), np.float32)
    quat[:, 0] = 1.0
    return np.concatenate(
        [points[b], attrs["opacity"][b],
         np.abs(attrs["scale"][b]) * 0.01 + 0.003, quat, attrs["rgb"][b]],
        axis=1)


def seeded_lpips(device, seed: int) -> LPIPS:
    """The LPIPS (VGG16) of the VAE trainer's loss, with its seeded random
    weights (no pretrained LPIPS weights are in the repository)."""
    with torch.device(device):   # default inits run on the device
        lpips = LPIPS().to(device).requires_grad_(False)
    random_weights_(lpips.vgg, torch.Generator(device=device).manual_seed(
        seed + 3))
    with torch.no_grad():
        lpips.init_heads()
    return lpips.eval()


def eval_dataset(cfg: Config):
    """The test set: the held-out HGS-1M items of ``cfg.train_list``, or
    procedural avatars (at least 2) with ``cfg.synthetic_data``."""
    if cfg.synthetic_data:
        return SyntheticAvatarDataset(cfg, n_items=max(2, cfg.synthetic_items))
    return HGSDataset(cfg, training=False)


@torch.no_grad()
def run_eval(pipe: AvatarPipeline, out_dir: str, eval_batches: int = 16,
             steps: Optional[int] = None, *, lpips: Optional[LPIPS] = None,
             noises: Optional[Sequence[torch.Tensor]] = None,
             seed: int = 0, timer=NULL_TIMER) -> Dict[str, object]:
    """Test-set generation metrics (the reference's ``test_DiT.py`` eval):
    for each of the first ``eval_batches`` batches of ``eval_dataset``,
    CFG-sample latents from ``sapiens_input`` (from ``noises[i]``, else a
    draw seeded with ``seed + 7``), decode them through the VAE's
    ``LatentRenderer`` (divided by ``vae_scaling_factor`` once, by the
    sampler), render the items' own cameras and pose, and score PSNR, SSIM
    and LPIPS (``lpips``, default ``seeded_lpips``; full resolution, [-1,
    1]) against the ground-truth views. Writes ``eval_XXX.png`` for the
    first 4 batches and prints each batch's metrics and the means.
    Returns {"mean": {metric: mean}, "batches": [{metric: value}],
    "ms": [wall ms of each batch, synchronised]}."""
    cfg, dev = pipe.cfg, pipe.device
    loader = DataLoader(eval_dataset(cfg), cfg.batch_size, shuffle=False,
                        num_workers=cfg.num_workers, drop_last=False)
    if lpips is None:
        lpips = seeded_lpips(dev, seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 7)
    os.makedirs(out_dir, exist_ok=True)
    batches, wall = [], []
    for i, batch in enumerate(loader):
        if i >= eval_batches:
            break
        t0 = time.perf_counter()
        tb = {k: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
              for k, v in batch.items() if k != "item"}
        lat = pipe.sample(tb["sapiens_input"],
                          noise=None if noises is None else noises[i],
                          generator=gen, steps=steps, timer=timer)
        out = pipe.latent_renderer(lat.permute(0, 2, 3, 1), tb, timer=timer)
        pred, gt = out["images_pred"], out["images_gt"]
        fp = pred.reshape(-1, *pred.shape[2:])
        fg = gt.reshape(-1, *gt.shape[2:])
        vals = {"psnr": float(psnr(pred, gt)), "ssim": float(ssim(fp, fg)),
                "lpips": float(torch.mean(lpips(fp * 2.0 - 1.0,
                                                fg * 2.0 - 1.0)))}
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        wall.append((time.perf_counter() - t0) * 1e3)
        if i < 4:
            save_visualization(
                {k: out[k].float().cpu().numpy()
                 for k in ("images_pred", "images_gt")},
                os.path.join(out_dir, f"eval_{i:03d}.png"))
        batches.append(vals)
        print(f"[eval] batch {i}: " + "  ".join(
            f"{k} {v:.4f}" for k, v in vals.items())
            + f"  ({wall[-1]:.1f} ms)", flush=True)
    mean = {k: float(np.mean([b[k] for b in batches]))
            for k in (batches[0] if batches else ())}
    print("[eval] mean: " + "  ".join(f"{k} {v:.4f}" for k, v in mean.items())
          + f"  ({len(batches)} batches)", flush=True)
    return {"mean": mean, "batches": batches, "ms": wall}


def _flag(raw: str) -> bool:
    return raw.lower() in ("1", "true", "yes", "on")


def main(argv=None, *, body_model: Optional[SMPLXModel] = None,
         template: Optional[TemplateAssets] = None):
    """The CLI; ``body_model`` / ``template``: built ones to pose and render
    (default: the configured assets, else the procedural body). Returns
    ``run_eval``'s result with ``--eval``, else {"views", "ply",
    "ply_bytes", "ply_write_ms"}."""
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
    ap.add_argument("--steps", type=int, default=None,
                    help="sampling steps (default: the preset's)")
    ap.add_argument("--out_dir", default="./workspace/inference")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--vae_ckpt", default=None,
                    help="VAE weights: a VAE trainer state (.pt), a msgpack "
                         "state file or autoencoder.safetensors")
    ap.add_argument("--dit_ckpt", default=None,
                    help="DiT weights: a DiT trainer state (.pt), a msgpack "
                         "state file or transformer.safetensors")
    ap.add_argument("--eval", action="store_true",
                    help="test-set metrics instead of single-image inference")
    ap.add_argument("--eval_batches", type=int, default=16)
    ap.add_argument("--train_list", default=None,
                    help="--eval: .npy of HGS-1M item directories (default: "
                         "the preset's)")
    ap.add_argument("--synthetic_data", type=_flag, default=None,
                    help="--eval on procedural avatars (true / false; "
                         "default: the preset's)")
    args = ap.parse_args(argv)

    cfg = PRESETS[args.preset]
    if args.train_list is not None:
        cfg = cfg.replace(train_list=args.train_list)
    if args.synthetic_data is not None:
        cfg = cfg.replace(synthetic_data=args.synthetic_data)
    dev = resolve_device(args.device)
    pipe = AvatarPipeline(cfg, device=dev, seed=args.seed,
                          body_model=body_model, template=template)
    pipe.load_checkpoints(vae=args.vae_ckpt, dit=args.dit_ckpt)
    if args.eval:
        return run_eval(pipe, args.out_dir, args.eval_batches, args.steps,
                        seed=args.seed)

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
    t0 = time.perf_counter()
    g14 = avatar_gaussians(
        out["gaussians"]["position"].float().cpu().numpy(),
        {k: out["attrs"][k].float().cpu().numpy()
         for k in ("opacity", "scale", "rgb")})
    ply = os.path.join(args.out_dir, "avatar.ply")
    n = save_ply(g14, ply)
    write_ms = (time.perf_counter() - t0) * 1e3
    print(f"wrote {imgs.shape[0]} views and avatar.ply ({n} Gaussians, "
          f"{os.path.getsize(ply)} bytes, {write_ms:.1f} ms) to "
          f"{args.out_dir} (overflow {int(out['render']['overflow'].sum())})")
    return {"views": imgs, "ply": ply, "ply_bytes": os.path.getsize(ply),
            "ply_write_ms": write_ms}


if __name__ == "__main__":
    main()
