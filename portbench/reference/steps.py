"""The reference's training steps and serving request, in plain PyTorch.

Each takes the benchmark's inputs (weights from ``portbench.inputs``, the
procedural body and template, batches, draws) and works out again whatever
the program derives from them (the deformer's voxel weights, the KNN base
scale, the render). The networks are the frozen copies beside this file;
the renderer is ``render.py``. With ``control=True`` the networks run one
precision step below the configuration (``precision.py``); the deformer,
the KNN and the renderer stay f32.

Training steps follow the port's rules: the VAE's G step (L1 + LPIPS + KL,
clip, AdamW betas (0.9, 0.95), weight decay 0.01, constant lr) and the DiT
step (frozen encodes, v-prediction x0 loss with 1 / (1 - abar) weights,
clip, AdamW betas (0.9, 0.95), weight decay 1e-4, warmup-cosine lr). The
VAE step runs item by item and sums the gradients: every term of its loss
is a mean over items, so the sum is the batch's gradient.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

from portbench.reference import render as plain
from portbench.reference.body.deformer import GaussianDeformer
from portbench.reference.body.smplx import parse_param_vector
from portbench.reference.diffusion.ddim import DDIMScheduler
from portbench.reference.diffusion.pipeline import SamplePipeline
from portbench.reference.losses.lpips import LPIPS
from portbench.reference.models.dit import DiTModel
from portbench.reference.models.encoders import make_encoder
from portbench.reference.models.vae import (
    VAEModel,
    compose_rotations,
    dropout_mask,
    sample_gaussian_attrs,
)
from portbench.reference.ops.knn import mean_knn_dist2
from portbench.reference.ops.rasterizer.preprocess import build_cov3d
from portbench.reference.precision import part, to_fp8

COSINE_UPDATES = 1_000_000


def build(make, state: Dict[str, torch.Tensor], device) -> torch.nn.Module:
    """A reference module holding ``state`` (f32 on ``device``)."""
    with torch.device(device):
        module = make()
    module = module.to(device)          # buffers made from host arrays
    module.load_state_dict(state)
    return module


class Decode:
    """Latent or attribute map -> posed Gaussians -> rendered views (the
    port's ``LatentRenderer`` path, worked out again)."""

    def __init__(self, cfg, body, template):
        self.cfg, self.t = cfg, template
        self.deformer = GaussianDeformer(body, template.init_faces,
                                         template.init_spdir,
                                         template.init_podir,
                                         template.init_lbsw,
                                         template.weight_mask())
        with torch.no_grad():
            self.state = self.deformer.initialize()

    def gaussians(self, attr_map, smpl_vec):
        t = self.t
        attrs = sample_gaussian_attrs(attr_map, t.init_uv)
        canon = t.init_pcd[None] + attrs["offset"]
        posed = self.deformer.prepare(parse_param_vector(
            smpl_vec, batch=attr_map.shape[0], device=attr_map.device))
        points, tfs = self.deformer(self.state, posed, canon)
        rot = compose_rotations(attrs["rot"], t.init_rot, tfs)
        out = []
        for b in range(points.shape[0]):
            with torch.no_grad():
                dist2 = mean_knn_dist2(points[b])
            base = torch.sqrt(torch.clamp(dist2, min=1e-7))[..., None]
            cov3d = build_cov3d((attrs["scale"][b] + 1.0) * base, rot[b])
            out.append((points[b], cov3d, attrs["rgb"][b],
                        attrs["opacity"][b, :, 0]))
        return out

    def render(self, attr_map, smpl_vec, cam_view, cam_view_proj):
        """-> images [B,V,3,H,W]."""
        imgs = []
        for b, g in enumerate(self.gaussians(attr_map, smpl_vec)):
            imgs.append(plain.render(*g, cam_view[b], cam_view_proj[b],
                                     self.cfg)[0])
        return torch.stack(imgs)


def resize_for_lpips(x, size):
    if x.shape[-2:] == (size, size):
        return x
    return F.interpolate(x, size=(size, size), mode="bilinear",
                         align_corners=False, antialias=True)


def leaf_norms(tensors: List[torch.Tensor]) -> List[float]:
    return torch.stack([t.detach().float().norm() for t in tensors]).tolist()


class VAETrain:
    """The VAE's G step (``VAETrainer.train_step_g`` before ``disc_start``),
    from the benchmark's weights."""

    def __init__(self, cfg, body, template, vae_state, lpips_state, device,
                 control=False):
        self.cfg, self.device, self.control = cfg, device, control
        self.vae = build(lambda: VAEModel(cfg), vae_state, device)
        self.lpips = build(LPIPS, lpips_state, device).requires_grad_(False)
        self.logvar = torch.nn.Parameter(torch.zeros((), device=device))
        self.names = [n for n, _ in self.vae.named_parameters()] + ["logvar"]
        self.params = [*self.vae.parameters(), self.logvar]
        self.opt = torch.optim.AdamW(self.params, lr=cfg.lr, betas=(0.9, 0.95),
                                     eps=1e-8, weight_decay=0.01,
                                     foreach=False)
        self.decode = Decode(cfg, body, template)
        if control:
            to_fp8(self.vae)

    def step(self, batch, noise, drop_seed: int):
        """One step; returns (loss, the gradients' norms as AdamW gets them,
        per leaf)."""
        cfg, dev = self.cfg, self.device
        B = batch["input"].shape[0]
        h = cfg.uv_query_size
        gen = torch.Generator(device=dev).manual_seed(drop_seed)
        drops = [dropout_mask((B, h * h, 2 * cfg.encoder_channels[-1]),
                              cfg.attn_dropout, gen, dev)
                 for _ in range(1 + cfg.self_attention_layers)]
        total = 0.0
        for i in range(B):
            sl = slice(i, i + 1)
            post = self.vae.autoencoder.encode(
                batch["input"][sl].transpose(1, 2), batch["UV_inital"][sl],
                drops=[d[sl] for d in drops])
            z = post.mean + torch.exp(0.5 * post.logvar) * noise[sl]
            attr_map = self.vae.decode(z)
            pred = self.decode.render(attr_map.float(),
                                      batch["smpl_params"][sl],
                                      batch["cam_view"][sl],
                                      batch["cam_view_proj"][sl])
            gt, m = batch["images_output"][sl], batch["masks_output"][sl]
            pred_f, gt_f = pred.flatten(0, 1), gt.flatten(0, 1)
            m_f = m.flatten(0, 1)
            l1 = torch.mean(torch.abs(pred_f * m_f - gt_f * m_f))
            with part(self.control, "f32", dev):
                lp = torch.mean(self.lpips(
                    resize_for_lpips(gt_f, cfg.lpips_size) * 2.0 - 1.0,
                    resize_for_lpips(pred_f, cfg.lpips_size) * 2.0 - 1.0))
            rec = l1 + cfg.lambda_lpips * lp
            mean, logvar = post.mean.float(), post.logvar.float()
            kl = 0.5 * torch.sum(mean ** 2 + torch.exp(logvar) - 1.0 - logvar)
            loss = (rec / torch.exp(self.logvar) + self.logvar
                    + cfg.lambda_kl * kl) / B
            loss.backward()
            total += float(loss.detach())
        return total, self._apply()

    def _apply(self):
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.cfg.gradient_clip, 1.0,
                            self.cfg.gradient_clip / norm)
        for g in grads:
            g.mul_(scale)
        norms = leaf_norms(grads)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        return norms


def lr_at(cfg, count: int) -> float:
    """The DiT trainer's learning rate after ``count`` updates."""
    if cfg.lr_scheduler != "cosine":
        return cfg.lr
    warm = cfg.lr_warmup_steps
    if count < warm:
        return (0.0 - cfg.lr) * (1.0 - count / warm) + cfg.lr
    span = max(warm + 1, COSINE_UPDATES) - warm
    frac = min(count - warm, span) / span
    return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * frac))


class DiTTrain:
    """The DiT step (``DiTTrainer.train_step`` on the raw path)."""

    def __init__(self, cfg, vae_state, enc_state, dit_state, device,
                 control=False):
        self.cfg, self.device, self.control = cfg, device, control
        self.vae = build(lambda: VAEModel(cfg), vae_state,
                         device).eval().requires_grad_(False)
        self.encoder = build(lambda: make_encoder(cfg, True), enc_state,
                             device).eval().requires_grad_(False)
        self.dit = build(lambda: DiTModel(cfg), dit_state, device)
        self.names = [n for n, _ in self.dit.named_parameters()]
        self.params = list(self.dit.parameters())
        self.opt = torch.optim.AdamW(self.params, lr=cfg.lr, betas=(0.9, 0.95),
                                     eps=1e-8, weight_decay=1e-4,
                                     foreach=False)
        self.scheduler = DDIMScheduler.from_config(cfg, device=device)
        self.updates = 0
        if control:
            to_fp8(self.dit)

    @torch.no_grad()
    def encode(self, batch, enc_noise):
        """(latent x scaling factor, cond), item by item."""
        cfg, lat, cond = self.cfg, [], []
        with part(self.control, "f32", self.device):
            for i in range(batch["input"].shape[0]):
                sl = slice(i, i + 1)
                post = self.vae.encode(batch["input"][sl],
                                       batch["UV_inital"][sl])
                z = post.mean.float() + torch.exp(
                    0.5 * post.logvar.float()) * enc_noise[sl]
                lat.append(z.permute(0, 3, 1, 2) * cfg.vae_scaling_factor)
                cond.append(self.encoder(batch["sapiens_input"][sl]).float())
        return torch.cat(lat).contiguous(), torch.cat(cond)

    def step(self, batch, draws):
        latent, cond = self.encode(batch, draws["enc_noise"])
        b = latent.shape[0]
        cond = torch.where(draws["drop"].reshape(b, 1, 1, 1), 0.0, cond)
        t = draws["t"].long()
        sch = self.scheduler
        noisy = sch.add_noise(latent, draws["noise"], t)
        v = self.dit(noisy, cond, t).float()
        a = sch.alphas_cumprod[t].reshape(b, 1, 1, 1)
        x0 = torch.sqrt(a) * noisy - torch.sqrt(1.0 - a) * v
        w = sch.snr_weights(t).reshape(b, 1, 1, 1)
        loss = torch.mean(w * (x0 - latent) ** 2)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        for p, g in zip(self.params, grads):
            p.grad = g
        norm = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        scale = torch.where(norm < self.cfg.gradient_clip, 1.0,
                            self.cfg.gradient_clip / norm)
        for g in grads:
            g.mul_(scale)
        norms = leaf_norms(grads)
        for group in self.opt.param_groups:
            group["lr"] = lr_at(self.cfg, self.updates)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.updates += 1
        return float(loss.detach()), norms


class Serve:
    """One image -> avatar request (``AvatarPipeline.__call__``): encoder,
    CFG DDIM loop, decode, deform, render."""

    def __init__(self, cfg, body, template, vae_state, enc_state, dit_state,
                 device, control=False):
        self.cfg, self.device, self.control = cfg, device, control
        dec = {k: v for k, v in vae_state.items()
               if k.startswith(("autoencoder.decoder.", "heads."))}
        self.vae = build(lambda: VAEModel(cfg, with_encoder=False), dec,
                         device).eval()
        self.encoder = build(lambda: make_encoder(cfg, False), enc_state,
                             device).eval()
        if cfg.mixed_precision == "bf16":
            # served in bf16: the reference computes in f32 on its values
            dit_state = {k: v.to(torch.bfloat16).float()
                         for k, v in dit_state.items()}
        self.dit = build(lambda: DiTModel(cfg), dit_state, device).eval()
        if control:
            to_fp8(self.dit)
        self.sampler = SamplePipeline(
            cfg, DDIMScheduler.from_config(cfg, device=device))
        self.decode = Decode(cfg, body, template)

    @torch.no_grad()
    def __call__(self, image, smpl_vec, noise, cam_view, cam_view_proj):
        """-> (latents [1,Cl,h,w], images [1,V,3,H,W])."""
        cfg, dev = self.cfg, self.device
        with part(self.control, "f32", dev):
            cond = self.encoder(image).float()
        latents = self.sampler.sample_latents(
            self.dit, cond, noise=noise,
            num_inference_steps=cfg.num_inference_steps,
            guidance_scale=cfg.guidance_scale)
        with part(self.control, "f32", dev):
            attr_map = self.vae.decode(latents.permute(0, 2, 3, 1)).float()
        images = self.decode.render(attr_map, smpl_vec, cam_view[None],
                                    cam_view_proj[None])
        return latents, images
