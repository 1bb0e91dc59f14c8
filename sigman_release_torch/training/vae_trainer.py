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
  ``torch.Generator`` unless the caller passes the noise. Its seed is
  ``mesh.rank_seed(seed + 5, data_index)``: the view ranks of one item draw
  the same noise and masks, so a view-sharded step is the one-process step.
  (The JAX trainer folds every mesh axis into its key, and its view shards
  render from different latents.)
* Data parallelism (``mesh``, ``parallel/mesh.py``; a process group must
  exist): one DDP wraps the VAE and logvar (the JAX trainer's pmean over
  (params, logvar)), another the discriminator, both with their gradients
  as views of the all-reduce buckets. The G step's forward goes through
  the first, the D step's hinge loss through the second; the D step's
  re-forward without gradients, the GAN_G term and the eval use the bare
  modules. Accumulation micro-steps before the last run under
  ``no_sync``, so the clip sees averaged gradients. Logs are averaged over
  the ranks, as ``pmean`` averages them: ``psnr`` and ``overflow`` are
  per-rank values averaged, not full-batch ones. The eval sums its linear
  statistics with their counts over the ranks (the masked max by MAX)
  before the logarithms, so unequal shares stay exact.
* A D step before ``disc_start`` applies AdamW to zero gradients, which
  still decays the weights, as the JAX package's gated loss does.
* Eval (``eval_step`` / ``evaluate``): the posterior mean, no dropout, no
  gradients; PSNR, masked PSNR, SSIM and LPIPS on the full-resolution
  views, each reduced in linear form (mean squared errors, the masked max)
  before its nonlinear transform. The LPIPS net is the loss's VGG16, or a
  second one of ``cfg.eval_lpips_net`` (``"alex"``: the reference's eval
  net).
* State files (``save`` / ``resume``): the port's own ``torch.save`` file
  holds everything (weights, logvar, both AdamW states, the step and
  micro-step counts, a partial accumulation's gradient sums, the
  generator); ``resume`` also reads the JAX package's msgpack state file
  (a full train state: weights, logvar, both optimizers' moments and
  counts, the step; or bare parameters) and the reference's safetensors
  (parameters only), through ``training/checkpoint.py``.

``LatentRenderer`` is the decode path (decoder + heads -> deform ->
render) that the trainer renders its attribute maps through; called on a
latent it is the JAX trainer's ``render_latent`` (no gradients), which the
DiT trainer's sampling eval runs.
"""

from __future__ import annotations

import contextlib
import itertools
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.nn.parallel import DistributedDataParallel as DDP

from sigman_release_torch import convert
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
from sigman_release_torch.losses.gan import PatchDiscriminator, disc_layers
from sigman_release_torch.losses.lpips import LPIPS, load_lpips_params
from sigman_release_torch.losses.metrics import psnr, ssim
from sigman_release_torch.models.vae import (
    DiagonalGaussian,
    VAEModel,
    compose_rotations,
    sample_gaussian_attrs,
)
from sigman_release_torch.parallel import fsdp
from sigman_release_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    prefetch_to_device,
    rank_seed,
    shard_batch,
)
from sigman_release_torch.renderer import GaussianRenderer
from sigman_release_torch.training import checkpoint
from sigman_release_torch.utils.profiling import StepTimer, trace_if
from sigman_release_torch.utils.timing import NULL_TIMER

BATCH_KEYS = ("input", "UV_inital", "images_output", "masks_output",
              "cam_view", "cam_view_proj", "smpl_params")


def clip_by_global_norm_(params, max_norm: float) -> torch.Tensor:
    """Scale the gradients by max_norm / norm when their global norm
    reaches ``max_norm`` (the JAX package's optimizer rule, no epsilon).
    Sharded (DTensor) gradients: the norm of the whole gradients, each
    element counted once (``fsdp.global_norm``), and each rank scales its
    pieces. Returns the norm before clipping."""
    grads = [p.grad for p in params if p.grad is not None]
    if any(fsdp.is_sharded(g) for g in grads):
        norm = fsdp.global_norm(grads)
        grads = [fsdp.local(g) for g in grads]
    else:
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


def wrap_ddp(module: nn.Module, device: torch.device) -> DDP:
    """``module`` under DDP over every rank, its gradients views of the
    all-reduce buckets (no second copy). Every parameter must get a
    gradient in each backward through it."""
    return DDP(module, device_ids=[device] if device.type == "cuda" else None,
               gradient_as_bucket_view=True)


def no_sync(ddp: Optional[DDP], sync: bool):
    """``ddp.no_sync()`` on an accumulation micro-step that is not the
    last; else nothing."""
    return ddp.no_sync() if ddp is not None and not sync \
        else contextlib.nullcontext()


class GeneratorModule(nn.Module):
    """The VAE and the loss's logvar as one module, so that one DDP averages
    both gradients (logvar is no parameter of the VAE)."""

    def __init__(self, vae: VAEModel, logvar: nn.Parameter):
        super().__init__()
        self.vae, self.logvar = vae, logvar

    def forward(self, *args, **kwargs):
        return self.vae(*args, **kwargs)


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
                 device="cuda", mesh: Optional[Mesh] = None):
        """``mesh``: this rank's place in the data-parallel layout (default
        ``make_mesh(cfg.mesh_shape, cfg.mesh_axes)``; no 'model' axis); with
        a process group the trainer wraps its modules in DDP. ``cfg.spmd``
        is not read: FSDP is the DiT trainer's, and the JAX VAE trainer
        trains data-parallel whatever it says."""
        dev = resolve_device(device)
        self.cfg, self.device = cfg, dev
        self.mesh = mesh or make_mesh(cfg.mesh_shape, cfg.mesh_axes)
        if "model" in self.mesh.axis_names:
            raise ValueError("the VAE trainer shards over 'data' and 'view' "
                             "only; its mesh has a 'model' axis")

        with torch.device(dev):   # default inits run on the device
            self.vae = VAEModel(cfg).to(dev)
            self.disc = PatchDiscriminator(
                n_layers=disc_layers(cfg.output_size)).to(dev)
            self.lpips = LPIPS().to(dev).requires_grad_(False)
            self.lpips_eval = (
                LPIPS(cfg.eval_lpips_net).to(dev).requires_grad_(False)
                if cfg.eval_lpips_net != "vgg" else self.lpips)
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
        self.ddp_g = self.ddp_d = None
        if self.mesh.distributed:
            self.ddp_g = wrap_ddp(GeneratorModule(self.vae, self.logvar), dev)
            self.ddp_d = wrap_ddp(self.disc, dev)

    # ------------------------------------------------------------------ init

    def init(self, seed: int, lpips_ckpt: Optional[str] = None):
        """Seeded weights: the VAE's by ``init_vae_``, the discriminator's
        and the LPIPS trunks' linear/conv N(0, 1/fan_in), LPIPS heads 1/C,
        logvar 0; the trainer's generator restarts from ``seed`` and the
        mesh's data index. ``lpips_ckpt``: a torchvision ``vgg16`` state
        dict for the training LPIPS trunk (heads 1/C,
        ``losses.lpips.load_lpips_params``), as the JAX ``init_state``; the
        eval LPIPS stays seeded."""
        dev = self.device

        def gen(offset):
            return torch.Generator(device=dev).manual_seed(seed + offset)

        init_vae_(self.vae, seed)
        random_weights_(self.disc, gen(2))
        random_weights_(self.lpips.vgg, gen(3))
        self.lpips.init_heads()
        loaded = load_lpips_params(lpips_ckpt)
        if loaded is not None:
            self.lpips.load_state_dict(loaded)
        if self.lpips_eval is not self.lpips:
            random_weights_(self.lpips_eval.backbone, gen(6))
            self.lpips_eval.init_heads()
        with torch.no_grad():
            self.logvar.zero_()
        self.generator = torch.Generator(device=dev).manual_seed(
            rank_seed(seed + 5, self.mesh.data_index))

    def load_state_dicts(self, vae=None, disc=None, lpips=None, logvar=None,
                         lpips_eval=None):
        """Load converted weights (``convert.py``)."""
        for module, sd in ((self.vae, vae), (self.disc, disc),
                           (self.lpips, lpips), (self.lpips_eval, lpips_eval)):
            if sd is not None:
                module.load_state_dict(sd)
        if logvar is not None:
            with torch.no_grad():
                self.logvar.fill_(float(logvar))

    # --------------------------------------------------------------- forward

    def to_device(self, batch) -> Dict[str, torch.Tensor]:
        """This rank's share of a loader batch on the device: the trainer's
        keys, its block of views on a 'view' axis (``shard_batch``)."""
        return shard_batch({k: batch[k] for k in BATCH_KEYS}, self.mesh,
                           self.device)

    def forward(self, batch, noise: Optional[torch.Tensor] = None,
                train: bool = False, timer=NULL_TIMER,
                sample_posterior: bool = True, vae: Optional[nn.Module] = None):
        """Full differentiable forward: images -> rendered views.

        ``batch``: device tensors (:meth:`to_device`). ``noise`` [B,h,w,Cl]
        is the posterior sample's standard normal draw (default: from the
        trainer's generator; ``sample_posterior=False`` decodes the mean);
        ``train`` turns on the bottleneck dropout; ``vae`` is the module
        called (default the bare VAE; the G step passes its DDP). Returns
        (outputs, posterior); the spans "encoder", "decoder", "deform",
        "knn", "binning" and "forward_tiles" go to ``timer``."""
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.autocast):
            attr_map, posterior = (self.vae if vae is None else vae)(
                batch["input"], batch["UV_inital"], noise,
                sample_posterior=sample_posterior, train=train,
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

    def _last_micro(self, kind: str) -> bool:
        """Whether the next ``kind`` micro-step is the last before an
        update (its backward all-reduces)."""
        return (self._micro[kind] + 1) % self.cfg.gradient_accumulation_steps \
            == 0

    def train_step_g(self, batch, noise: Optional[torch.Tensor] = None,
                     timer=NULL_TIMER) -> Dict[str, torch.Tensor]:
        """One generator step on a device batch; returns detached logs
        (L1, lpips, kl, GAN_G, loss, psnr, overflow), averaged over the
        ranks."""
        k = self.cfg.gradient_accumulation_steps
        self.disc.requires_grad_(False)
        try:
            with no_sync(self.ddp_g, self._last_micro("g")):
                outputs, posterior = self.forward(batch, noise, train=True,
                                                  timer=timer, vae=self.ddp_g)
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
        return self.mesh.mean(logs)

    def train_step_d(self, batch, noise: Optional[torch.Tensor] = None,
                     timer=NULL_TIMER) -> Dict[str, torch.Tensor]:
        """One discriminator step: a train-mode re-forward without
        gradients, then the hinge loss on the detached renders."""
        k = self.cfg.gradient_accumulation_steps
        with torch.no_grad():
            outputs, _ = self.forward(batch, noise, train=True, timer=timer)
        with no_sync(self.ddp_d, self._last_micro("d")):
            with timer("loss"):
                loss, logs = self.loss.discriminator(outputs, self.step,
                                                     disc=self.ddp_d)
            with timer("backward_optimizer"):
                if loss is not None:
                    (loss / k).backward()
                self._apply("d", list(self.disc.parameters()), self.opt_d)
        self.step += 1
        return self.mesh.mean({n: v.detach() for n, v in logs.items()})

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def eval_step(self, batch):
        """Posterior-mean eval of a device batch: (metrics, outputs).
        ``metrics``: psnr, masked_psnr (10 log10(max(masked max^2, 1e-12) /
        max(masked mse, 1e-12))), ssim over the views and lpips of the
        full-resolution views in [-1, 1], over the batches of every rank;
        ``outputs``: the render's images_pred / alphas_pred / images_gt /
        masks_gt. A rank without a batch passes None (and gets None
        outputs): it adds nothing to the sums but joins their collectives."""
        # linear statistics: squared errors, masked squared errors, their
        # element count, SSIM and LPIPS summed over images, the image count
        stats = torch.zeros(6, dtype=torch.float64, device=self.device)
        masked_max = torch.full((), -torch.inf, device=self.device)
        outputs = None
        if batch is not None:
            outputs, _ = self.forward(batch, sample_posterior=False)
            outputs.pop("overflow")
            pred, gt = outputs["images_pred"], outputs["images_gt"]
            mask = outputs["masks_gt"]
            flat_p = pred.reshape(-1, *pred.shape[2:])
            flat_g = gt.reshape(-1, *gt.shape[2:])
            n = flat_p.shape[0]
            stats = torch.stack([
                torch.sum((pred - gt) ** 2),
                torch.sum((pred * mask - gt * mask) ** 2),
                torch.tensor(float(pred.numel()), device=self.device),
                ssim(flat_p, flat_g) * n,
                torch.sum(self.lpips_eval(flat_p * 2.0 - 1.0,
                                          flat_g * 2.0 - 1.0)),
                torch.tensor(float(n), device=self.device)]).double()
            masked_max = torch.max(pred * mask)
        sse, msse, count, ssim_sum, lpips_sum, n = \
            self.mesh.all_reduce_(stats).float().unbind()
        masked_max = self.mesh.all_reduce_(masked_max, "max")
        mse, masked_mse = sse / count, msse / count
        metrics = {
            "psnr": -10.0 * torch.log10(torch.clamp(mse, min=1e-12)),
            "masked_psnr": 10.0 * torch.log10(
                torch.clamp(masked_max ** 2, min=1e-12)
                / torch.clamp(masked_mse, min=1e-12)),
            "ssim": ssim_sum / n,
            "lpips": lpips_sum / n,
        }
        return metrics, outputs

    def evaluate(self, eval_loader, max_batches: int = 8,
                 vis_path: Optional[str] = None) -> Dict[str, float]:
        """``eval_step`` over up to ``max_batches`` loader batches: the
        per-batch means as ``eval_*``, and the first batch's GT | pred PNG
        at ``vis_path`` (rank 0). Every rank takes as many eval steps as
        the longest share has batches; a rank whose share is done passes
        None, so batch i pools the i-th batch of every rank."""
        steps = self.mesh.max_int(min(len(eval_loader), max_batches))
        sums: Dict[str, list] = {}
        first = None
        batches = itertools.chain(itertools.islice(eval_loader, steps),
                                  itertools.repeat(None))
        for _, batch in zip(range(steps), batches):
            metrics, outputs = self.eval_step(
                None if batch is None else self.to_device(batch))
            for k, v in metrics.items():
                sums.setdefault(k, []).append(float(v))
            if first is None and outputs is not None:
                first = {k: outputs[k].float().cpu().numpy()
                         for k in ("images_pred", "images_gt")}
        if vis_path and first is not None and self.mesh.rank == 0:
            from sigman_release_torch.utils.visualize import save_visualization

            save_visualization(first, vis_path)
        return {f"eval_{k}": float(np.mean(v)) for k, v in sums.items()}

    # ------------------------------------------------------------------ fit

    def fit(self, loader, num_steps: Optional[int] = None,
            log_every: int = 10, ckpt_path: Optional[str] = None,
            logger=None, eval_loader=None,
            eval_every: Optional[int] = None,
            profile_dir: Optional[str] = None,
            profile_every: int = 500) -> Dict[str, float]:
        """Alternate G and D steps by step parity once ``disc_start`` is
        reached, over ``loader`` epochs until ``num_steps`` (one epoch of
        the shortest rank's loader if None; every rank must be given the
        same ``num_steps``): log every ``log_every`` steps, save to
        ``ckpt_path`` every ``save_ckpt_steps`` and at the end, and every
        ``eval_every`` steps ``evaluate`` on ``eval_loader`` (PNG at
        ``<workspace>/eval_<step>.png``), keeping the best of each metric
        (lowest lpips, highest of the others), logged as ``best_*`` at the
        end. Only rank 0 prints and logs. Batches reach the device
        ``prefetch_to_device`` ahead. With ``profile_dir`` every
        ``profile_every``-th step (counted from 0, the first not) is traced
        into it (``utils/profiling.trace_if``). Returns the last step's logs
        as floats."""
        cfg = self.cfg
        lead = self.mesh.rank == 0
        if num_steps is None:
            num_steps = self.step + self.mesh.min_int(len(loader))
        timer = StepTimer()
        timer.tick()
        logs: Dict[str, float] = {}
        best: Dict[str, float] = {}
        while self.step < num_steps:
            host = ({k: b[k] for k in BATCH_KEYS} for b in loader)
            taken = 0
            for batch in timer.timed(prefetch_to_device(
                    host, self.mesh, self.device)):
                if self.step >= num_steps:
                    break
                taken += 1
                use_d = self.step >= cfg.disc_start and self.step % 2 == 1
                with trace_if(profile_dir, self.step, every=profile_every):
                    out = (self.train_step_d(batch) if use_d
                           else self.train_step_g(batch))
                logs = {n: float(v) for n, v in out.items()}
                timer.tick()
                if self.step % log_every == 0 and lead:
                    summ = timer.summary()
                    print(f"[vae] step {self.step} {logs} "
                          f"({summ.get('step_time_mean_s', 0.0):.2f}s/step, "
                          f"data wait {summ.get('data_wait_mean_s', 0.0):.3f}s"
                          f" = {summ.get('data_wait_share', 0.0):.1%})",
                          flush=True)
                    if logger is not None:
                        logger.log(self.step, {**logs, **summ})
                if ckpt_path and self.step % cfg.save_ckpt_steps == 0:
                    self.save(ckpt_path)
                if (eval_loader is not None and eval_every
                        and self.step % eval_every == 0):
                    ev = self.evaluate(eval_loader, vis_path=os.path.join(
                        cfg.workspace, f"eval_{self.step:07d}.png"))
                    for k, v in ev.items():
                        if k not in best or (v > best[k]) == ("lpips" not in k):
                            best[k] = v
                    if lead:
                        print(f"[vae] eval @ {self.step}: {ev}", flush=True)
                    if logger is not None:
                        logger.log(self.step, ev)
            if not taken and self.step < num_steps:
                raise ValueError("fit: the loader yields no batch")
        if ckpt_path:
            self.save(ckpt_path)
        if best and lead:
            summary = {f"best_{k}": v for k, v in best.items()}
            print(f"[vae] best eval: {summary}", flush=True)
            if logger is not None:
                logger.log(self.step, summary)
        return logs

    # ----------------------------------------------------------- state file

    def save(self, path: str):
        """The port's own state file (``torch.save``, written atomically):
        VAE, discriminator and logvar, both AdamW states, the step and
        micro-step counts, the gradient sums of a partial accumulation
        (averaged over the ranks), and every rank's generator. Every rank
        calls it; rank 0 writes and the others wait for the file."""
        k = self.cfg.gradient_accumulation_steps
        params_d = list(self.disc.parameters())
        grads_g = checkpoint.partial_grads(self.params_g, self._micro["g"], k)
        grads_d = checkpoint.partial_grads(params_d, self._micro["d"], k)
        state = checkpoint.rank_state(self.mesh, self.generator, grads_g,
                                      grads_d)
        if self.mesh.rank == 0:
            checkpoint.save_torch(path, {
                "vae": self.vae.state_dict(), "disc": self.disc.state_dict(),
                "logvar": self.logvar.detach(),
                "opt_g": self.opt_g.state_dict(),
                "opt_d": self.opt_d.state_dict(),
                "step": self.step, "micro": dict(self._micro),
                "grads_g": grads_g, "grads_d": grads_d, **state})
        self.mesh.barrier()

    def resume(self, path: str):
        """Restore a state file in any of the three formats: the port's own
        (everything :meth:`save` wrote); a msgpack full train state
        (weights, logvar, discriminator, both optimizers' moments and
        counts, a partial accumulation, the step); a msgpack parameter tree
        or reference safetensors (the VAE's parameters only)."""
        fmt = checkpoint.sniff_format(path)
        if fmt == "torch":
            self._resume_port(checkpoint.load_torch(path))
            return
        state = checkpoint.read_msgpack(path) if fmt == "msgpack" else None
        if state is None or "step" not in state:
            sd, _ = checkpoint.load_params_any(path, self.vae, self.cfg)
            self.vae.load_state_dict(sd)
            return
        self._resume_msgpack(state)

    def _resume_port(self, state):
        self.vae.load_state_dict(state["vae"])
        self.disc.load_state_dict(state["disc"])
        with torch.no_grad():
            self.logvar.copy_(state["logvar"])
        self.opt_g.load_state_dict(state["opt_g"])
        self.opt_d.load_state_dict(state["opt_d"])
        self.step = int(state["step"])
        self._micro = {kind: int(n) for kind, n in state["micro"].items()}
        checkpoint.restore_grads_(self.params_g, state["grads_g"])
        checkpoint.restore_grads_(self.disc.parameters(), state["grads_d"])
        checkpoint.restore_generator_(self.generator, state, self.mesh,
                                      self.cfg.seed + 5)

    def _resume_msgpack(self, state):
        """A full train state of the JAX package's VAE trainer: ``params``,
        ``logvar``, ``disc_params``, ``opt_state_g`` (over (params,
        logvar)), ``opt_state_d``, ``step``. Moments and accumulated
        gradients go through the same Flax-path maps as the weights."""
        cfg, k = self.cfg, self.cfg.gradient_accumulation_steps
        vae_map = convert.key_map_for(self.vae, cfg)
        disc_map = convert.key_map_for(self.disc, cfg)

        restore, put = checkpoint.tree_params, checkpoint.copy_params_
        put(self.vae.parameters(), restore(self.vae, state["params"],
                                            vae_map, fill="weights"))
        put([self.logvar], [state["logvar"]])
        put(self.disc.parameters(), restore(self.disc, state["disc_params"],
                                             disc_map, fill="weights"))
        adam, mini_g, acc = checkpoint.optimizer_parts(state["opt_state_g"])
        moments = zip(restore(self.vae, adam["mu"]["0"], vae_map)
                      + [adam["mu"]["1"]],
                      restore(self.vae, adam["nu"]["0"], vae_map)
                      + [adam["nu"]["1"]])
        checkpoint.load_adamw_(self.opt_g, moments, int(adam["count"]))
        grads_g = None if acc is None or not mini_g else [
            g * (mini_g / k) for g in restore(self.vae, acc["0"], vae_map)
            + [acc["1"]]]
        adam, mini_d, acc = checkpoint.optimizer_parts(state["opt_state_d"])
        moments = zip(restore(self.disc, adam["mu"], disc_map),
                      restore(self.disc, adam["nu"], disc_map))
        checkpoint.load_adamw_(self.opt_d, moments, int(adam["count"]))
        grads_d = None if acc is None or not mini_d else [
            g * (mini_d / k) for g in restore(self.disc, acc, disc_map)]
        checkpoint.restore_grads_(self.params_g, grads_g)
        checkpoint.restore_grads_(self.disc.parameters(), grads_d)
        self._micro = {"g": mini_g, "d": mini_d}
        self.step = int(state["step"])


def synthetic_setup(cfg: Config, *, device="cuda", n_verts: int = 100_002,
                    body_model: Optional[SMPLXModel] = None,
                    template: Optional[TemplateAssets] = None, seed: int = 0,
                    mesh: Optional[Mesh] = None):
    """A trainer on the procedural body (``n_verts`` vertices, one Gaussian
    per face; pass ``body_model`` and ``template`` to reuse built ones; its
    ``mesh`` as ``VAETrainer`` takes it) and
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
                         device=dev, mesh=mesh)
    item = SyntheticAvatarDataset(cfg, n_items=1, seed=seed)[0]
    batch = trainer.to_device({k: v[None] for k, v in item.items()
                               if k != "item"})
    return trainer, batch
