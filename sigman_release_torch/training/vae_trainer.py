"""VAE training: L1 + LPIPS + KL (+ gated hinge GAN) through the tile
rasterizer (port of the JAX package's ``training/vae_trainer.py``).

Per generator step: images -> 3D-conv encoder -> UV-query bottleneck ->
posterior sample -> decoder + Gaussian heads -> UV grid-sample -> LBS
deformer -> rotation composition -> rasterizer (K1 forward, K2 backward) ->
losses -> global-norm clipping + AdamW. The discriminator step re-forwards
without gradients and trains the PatchGAN on the detached renders.

* Precision: with ``mixed_precision="bf16"`` the networks run under
  ``torch.autocast(bfloat16)`` with f32 master weights. Autocast runs convs,
  linears and attention in bf16 and keeps GroupNorm, LayerNorm and softmax
  in f32; the JAX package instead casts every parameter to bf16. Renderer
  geometry is f32 in both.
* Optimizers, as the JAX package builds them: G clips the global norm of
  (VAE parameters, logvar) at ``gradient_clip`` then AdamW(lr, betas (0.9,
  0.95), weight decay 0.01, eps 1e-8); D clips then AdamW(lr, betas (0.9,
  0.999), weight decay 1e-4, eps 1e-8). The learning rate is constant.
  Gradients average over ``gradient_accumulation_steps`` micro-steps before
  one optimizer step.
* Randomness: posterior noise and dropout masks come from the trainer's
  ``torch.Generator`` unless the caller passes the noise.
* A D step before ``disc_start`` applies AdamW to zero gradients, which
  still decays the weights, as the JAX package's gated loss does.

``LatentRenderer`` is the decode path (decoder + heads -> deform ->
render) that the trainer renders its attribute maps through; called on a
latent it is the JAX trainer's ``render_latent`` (no gradients), which the
DiT trainer's sampling eval runs.

Not ported yet: ``eval_step``, ``resume`` and checkpoint writing.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np
import torch
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
from sigman_release_torch.config import Config
from sigman_release_torch.device import resolve_device
from sigman_release_torch.inference import HEAD_INIT_STD, random_weights_
from sigman_release_torch.losses.combined import VAELoss
from sigman_release_torch.losses.gan import PatchDiscriminator
from sigman_release_torch.losses.lpips import LPIPS
from sigman_release_torch.losses.metrics import psnr
from sigman_release_torch.models.vae import (
    DiagonalGaussian,
    VAEModel,
    compose_rotations,
    sample_gaussian_attrs,
)
from sigman_release_torch.renderer import GaussianRenderer
from sigman_release_torch.utils.profiling import StepTimer
from sigman_release_torch.utils.timing import NULL_TIMER

BATCH_KEYS = ("input", "UV_inital", "images_output", "masks_output",
              "cam_view", "cam_view_proj", "smpl_params")


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients by max_norm / norm when their global norm
    reaches ``max_norm`` (the JAX package's optimizer rule, no epsilon).
    Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    norm = torch.linalg.vector_norm(
        torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


class LatentRenderer:
    """The VAE's decode path to rendered views: decoder + Gaussian heads ->
    UV grid-sample -> LBS deformer -> rotation composition -> tile
    rasterizer, on one body model and template. ``VAETrainer`` renders its
    attribute maps through it; the DiT trainer's sampling eval calls it on
    sampled latents with a frozen VAE."""

    def __init__(self, cfg: Config, vae: VAEModel,
                 body_model: Optional[SMPLXModel] = None,
                 template: Optional[TemplateAssets] = None, *,
                 device="cuda"):
        dev = resolve_device(device)
        self.device, self.vae = dev, vae
        if body_model is None:
            body_model = (load_smplx_npz(cfg.smplx_model_path)
                          if cfg.smplx_model_path else synthetic_body_model())
        body_model = body_model.to(dev)
        if template is None:
            try:
                template = load_template_dir(cfg.template_dir)
            except (FileNotFoundError, OSError):
                template = synthetic_template(body_model)
        self.template = t = template.to(dev)
        self.deformer = GaussianDeformer(body_model, t.init_faces,
                                         t.init_spdir, t.init_podir,
                                         t.init_lbsw, t.weight_mask())
        with torch.no_grad():
            self.deformer_state = self.deformer.initialize()
        self.renderer = GaussianRenderer(cfg)
        self.autocast = cfg.mixed_precision == "bf16"

    def render_attrs(self, attr_map, batch, timer=NULL_TIMER):
        """UV attribute map -> grid-sample -> deform -> rasterize."""
        t = self.template
        with timer("deform"):
            attrs = sample_gaussian_attrs(attr_map, t.init_uv)
            canon = t.init_pcd[None] + attrs["offset"]
            posed = self.deformer.prepare(
                parse_param_vector(batch["smpl_params"]))
            points, tfs = self.deformer(self.deformer_state, posed, canon)
            rot = compose_rotations(attrs["rot"], t.init_rot, tfs)
        gaussians = {"position": points, "opacity": attrs["opacity"],
                     "scale": attrs["scale"], "cov3d": rot,
                     "rgb": attrs["rgb"]}
        render = self.renderer.render(gaussians, batch["cam_view"],
                                      batch["cam_view_proj"], timer=timer)
        return {"images_pred": render["image"],
                "alphas_pred": render["alpha"],
                "images_gt": batch["images_output"],
                "masks_gt": batch["masks_output"],
                "overflow": render["overflow"]}

    @torch.no_grad()
    def __call__(self, z: torch.Tensor, batch,
                 timer=NULL_TIMER) -> Dict[str, torch.Tensor]:
        """Decode-only path: latent z [B,h,w,Cl] (already divided by
        ``vae_scaling_factor``) -> decoder + heads -> deform -> render, for
        a device batch. The spans "decoder", "deform", "knn", "binning" and
        "forward_tiles" go to ``timer``."""
        with timer("decoder"), torch.autocast(
                self.device.type, dtype=torch.bfloat16,
                enabled=self.autocast):
            attr_map = self.vae.decode(z)
        return self.render_attrs(attr_map.float(), batch, timer)


def init_vae_(vae: VAEModel, seed: int) -> VAEModel:
    """Seeded VAE weights: linear/conv N(0, 1/fan_in), the Gaussian heads at
    std 1e-3 (decoded offsets start near the template surface), the UV
    query grid N(0, 1), norms 1/0."""
    dev = next(vae.parameters()).device

    def gen(offset):
        return torch.Generator(device=dev).manual_seed(seed + offset)

    random_weights_(vae, gen(0))
    random_weights_(vae.heads, gen(1), std=HEAD_INIT_STD)
    with torch.no_grad():
        vae.autoencoder.uv_latent.normal_(0.0, 1.0, generator=gen(4))
    return vae


class VAETrainer:
    def __init__(self, cfg: Config, body_model: Optional[SMPLXModel] = None,
                 template: Optional[TemplateAssets] = None, *,
                 device="cuda"):
        dev = resolve_device(device)
        self.cfg, self.device = cfg, dev

        # 4 layers at 512^2 like the reference; fewer for small renders
        n_layers = max(1, min(4, int(math.log2(cfg.output_size)) - 3))
        with torch.device(dev):   # default inits run on the device
            self.vae = VAEModel(cfg).to(dev)
            self.disc = PatchDiscriminator(n_layers=n_layers).to(dev)
            self.lpips = LPIPS().to(dev).requires_grad_(False)
        self.latent_renderer = LatentRenderer(cfg, self.vae, body_model,
                                              template, device=dev)
        self.logvar = nn.Parameter(torch.zeros((), device=dev))
        self.loss = VAELoss(cfg, lpips=self.lpips, discriminator=self.disc)
        self.autocast = cfg.mixed_precision == "bf16"

        self.params_g = [*self.vae.parameters(), self.logvar]
        self.opt_g = torch.optim.AdamW(self.params_g, lr=cfg.lr,
                                       betas=(0.9, 0.95), eps=1e-8,
                                       weight_decay=0.01)
        self.opt_d = torch.optim.AdamW(self.disc.parameters(), lr=cfg.lr,
                                       betas=(0.9, 0.999), eps=1e-8,
                                       weight_decay=1e-4)
        self.step = 0
        self._micro = {"g": 0, "d": 0}
        self.init(cfg.seed)

    # ------------------------------------------------------------------ init

    def init(self, seed: int):
        """Seeded weights: the VAE's by ``init_vae_``, the discriminator's
        and the LPIPS trunk's linear/conv N(0, 1/fan_in), LPIPS heads 1/C,
        logvar 0; the trainer's generator restarts from ``seed``."""
        dev = self.device

        def gen(offset):
            return torch.Generator(device=dev).manual_seed(seed + offset)

        init_vae_(self.vae, seed)
        random_weights_(self.disc, gen(2))
        random_weights_(self.lpips.vgg, gen(3))
        self.lpips.init_heads()
        with torch.no_grad():
            self.logvar.zero_()
        self.generator = gen(5)

    def load_state_dicts(self, vae=None, disc=None, lpips=None, logvar=None):
        """Load converted weights (``convert.py``)."""
        for module, sd in ((self.vae, vae), (self.disc, disc),
                           (self.lpips, lpips)):
            if sd is not None:
                module.load_state_dict(sd)
        if logvar is not None:
            with torch.no_grad():
                self.logvar.fill_(float(logvar))

    # --------------------------------------------------------------- forward

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        return {k: torch.as_tensor(np.asarray(batch[k])).to(self.device)
                for k in BATCH_KEYS}

    def forward(self, batch, noise: Optional[torch.Tensor] = None,
                train: bool = False, timer=NULL_TIMER):
        """Full differentiable forward: images -> rendered views.

        ``batch``: device tensors (:meth:`to_device`). ``noise`` [B,h,w,Cl]
        is the posterior sample's standard normal draw (default: from the
        trainer's generator); ``train`` turns on the bottleneck dropout.
        Returns (outputs, posterior); the spans "encoder", "decoder",
        "deform", "knn", "binning" and "forward_tiles" go to ``timer``."""
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.autocast):
            attr_map, posterior = self.vae(
                batch["input"], batch["UV_inital"], noise, train=train,
                generator=self.generator, timer=timer)
        posterior = DiagonalGaussian(posterior.mean.float(),
                                     posterior.logvar.float())
        return (self.latent_renderer.render_attrs(attr_map.float(), batch,
                                                  timer), posterior)

    # ------------------------------------------------------------ train steps

    def _apply(self, kind: str, params, opt) -> bool:
        """One optimizer step every ``gradient_accumulation_steps`` calls:
        clip the averaged gradients, AdamW, clear them."""
        self._micro[kind] += 1
        if self._micro[kind] % self.cfg.gradient_accumulation_steps:
            return False
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_(params, self.cfg.gradient_clip)
        opt.step()
        opt.zero_grad(set_to_none=True)
        return True

    def train_step_g(self, batch, noise: Optional[torch.Tensor] = None,
                     timer=NULL_TIMER) -> Dict[str, torch.Tensor]:
        """One generator step on a device batch; returns detached logs
        (L1, lpips, kl, GAN_G, loss, psnr, overflow)."""
        k = self.cfg.gradient_accumulation_steps
        self.disc.requires_grad_(False)
        try:
            outputs, posterior = self.forward(batch, noise, train=True,
                                              timer=timer)
            overflow = outputs.pop("overflow")
            with timer("loss"):
                loss, logs = self.loss.generator(outputs, posterior,
                                                 self.step, self.logvar)
            with timer("backward_optimizer"):
                (loss / k).backward()
                self._apply("g", self.params_g, self.opt_g)
        finally:
            self.disc.requires_grad_(True)
        logs = {n: v.detach() for n, v in logs.items()}
        logs["psnr"] = psnr(outputs["images_pred"].detach(),
                            outputs["images_gt"])
        logs["overflow"] = overflow.sum().float()
        self.step += 1
        return logs

    def train_step_d(self, batch, noise: Optional[torch.Tensor] = None,
                     timer=NULL_TIMER) -> Dict[str, torch.Tensor]:
        """One discriminator step: a train-mode re-forward without
        gradients, then the hinge loss on the detached renders."""
        k = self.cfg.gradient_accumulation_steps
        with torch.no_grad():
            outputs, _ = self.forward(batch, noise, train=True, timer=timer)
        with timer("loss"):
            loss, logs = self.loss.discriminator(outputs, self.step)
        with timer("backward_optimizer"):
            if loss is not None:
                (loss / k).backward()
            self._apply("d", list(self.disc.parameters()), self.opt_d)
        self.step += 1
        return {n: v.detach() for n, v in logs.items()}

    # ------------------------------------------------------------------ fit

    def fit(self, loader, num_steps: Optional[int] = None,
            log_every: int = 10, logger=None) -> Dict[str, float]:
        """Alternate G and D steps by step parity once ``disc_start`` is
        reached, over ``loader`` epochs until ``num_steps`` (one epoch if
        None). Returns the last step's logs as floats."""
        cfg = self.cfg
        timer = StepTimer()
        timer.tick()
        logs: Dict[str, float] = {}
        while True:
            for batch in loader:
                if num_steps is not None and self.step >= num_steps:
                    return logs
                batch = self.to_device(batch)
                use_d = self.step >= cfg.disc_start and self.step % 2 == 1
                out = (self.train_step_d(batch) if use_d
                       else self.train_step_g(batch))
                logs = {n: float(v) for n, v in out.items()}
                timer.tick()
                if self.step % log_every == 0:
                    summ = timer.summary()
                    print(f"[vae] step {self.step} {logs} "
                          f"({summ.get('step_time_mean_s', 0.0):.2f}s/step)",
                          flush=True)
                    if logger is not None:
                        logger.log(self.step, {**logs, **summ})
            if num_steps is None:
                return logs


def synthetic_setup(cfg: Config, *, device="cuda", n_verts: int = 100_002,
                    body_model: Optional[SMPLXModel] = None,
                    template: Optional[TemplateAssets] = None, seed: int = 0):
    """A trainer on the procedural body (``n_verts`` vertices, one Gaussian
    per face; pass ``body_model`` and ``template`` to reuse built ones) and
    one ``SyntheticAvatarDataset`` item as a device batch of 1 — the
    training set-up of ``chip_smoke.py`` and ``training/profile_step.py``.
    Returns (trainer, batch)."""
    from sigman_release_torch.data.dataset import SyntheticAvatarDataset

    dev = resolve_device(device)
    if body_model is None:
        body_model = synthetic_body_model(n_verts=n_verts, seed=seed,
                                          device=dev)
    if template is None:
        template = synthetic_template(body_model)
    trainer = VAETrainer(cfg, body_model=body_model, template=template,
                         device=dev)
    item = SyntheticAvatarDataset(cfg, n_items=1, seed=seed)[0]
    batch = trainer.to_device({k: v[None] for k, v in item.items()
                               if k != "item"})
    return trainer, batch
