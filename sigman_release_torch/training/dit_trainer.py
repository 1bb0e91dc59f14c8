"""DiT training: v-prediction diffusion in the frozen VAE's latent space
(port of the JAX package's ``training/dit_trainer.py``).

Per step: frozen VAE encode of the input views (posterior sample x
``vae_scaling_factor``) and frozen conditioning encode of ``sapiens_input``
-> uniform timesteps, noise, ``add_noise`` -> conditioning dropout for CFG
(``cond = 0`` with probability ``noised_condition_dropout``) -> the DiT
predicts v -> x0 = sqrt(abar) x_t - sqrt(1 - abar) v -> loss
mean(w (x0 - latent)^2) with w = 1 / (1 - abar_t) -> backward -> global-norm
clipping + AdamW.

* Frozen models: the trainer applies the VAE and the encoder *module* it is
  given (``eval()``, no gradients), whatever its geometry.
* Precision: with ``mixed_precision="bf16"`` the DiT runs under
  ``torch.autocast(bfloat16)`` with f32 master weights in the train step
  and in sampling; the JAX package casts the DiT's parameters to bf16
  there. The frozen VAE and conditioning encodes, ``eval_loss``, the
  scheduler arithmetic and the loss are f32, as in the JAX package.
* Checkpointing: ``cfg.gradient_checkpointing`` recomputes each DiT block
  in the backward (``models/dit.py``).
* Optimizer, as the JAX package builds it: clip the global norm at
  ``gradient_clip``, then AdamW (betas (0.9, 0.95), weight decay 1e-4, eps
  1e-8) at a learning rate that warms up linearly from 0 over
  ``lr_warmup_steps`` and then follows a cosine over 10^6 updates
  (``lr_scheduler="cosine"``; anything else: constant ``lr``), read at the
  count of updates applied before this one, so the first is 0 under warmup.
  With ``gradient_accumulation_steps = k`` the k micro-gradients are
  averaged, clipped and applied on the k-th micro-step; the schedule counts
  applied updates.
* Randomness: the posterior noise, timesteps, noise and dropout draws come
  from the trainer's ``torch.Generator`` unless the caller hands them over
  (``draws``).
* ``sample_eval`` divides the sampled latents by ``vae_scaling_factor``
  once (inside the sampler), as the single-image serving path does.

The JAX package's FSDP and tensor-parallel modes exist because a TPU chip
could not hold the Adam moments; one H100 holds the ``dit`` preset's state,
and data parallelism over several cards is not ported yet.
"""

from __future__ import annotations

import math
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from sigman_release_torch.config import Config
from sigman_release_torch.device import resolve_device
from sigman_release_torch.diffusion.ddim import DDIMScheduler
from sigman_release_torch.diffusion.pipeline import SamplePipeline
from sigman_release_torch.inference import random_weights_
from sigman_release_torch.losses.metrics import psnr
from sigman_release_torch.models.dit import DiTModel
from sigman_release_torch.models.encoders import (
    ViTFeatureEncoder,
    sapiens_1b_encoder,
)
from sigman_release_torch.models.vae import VAEModel
from sigman_release_torch.training.vae_trainer import (
    LatentRenderer,
    clip_by_global_norm_,
    init_vae_,
)
from sigman_release_torch.utils.profiling import StepTimer
from sigman_release_torch.utils.timing import NULL_TIMER

RAW_KEYS = ("input", "UV_inital", "sapiens_input")
ENCODED_KEYS = ("latent", "cond")
# the cosine runs over max(warmup + 1, COSINE_UPDATES) updates
COSINE_UPDATES = 1_000_000


def make_encoder(cfg: Config) -> ViTFeatureEncoder:
    """The conditioning encoder for ``cfg``: Sapiens-1B geometry at the
    reference's 1536 channels, else a ViT of the configured width."""
    if cfg.text_embed_dim == 1536:
        return sapiens_1b_encoder()
    return ViTFeatureEncoder(embed_dim=cfg.text_embed_dim)


def build_on(device, make, generator: torch.Generator) -> nn.Module:
    """``make()`` built on ``device`` without a host copy, with seeded
    random weights (``inference.random_weights_``). The module may hold no
    buffers: they would stay uninitialised."""
    with torch.device("meta"):
        module = make()
    if next(module.buffers(), None) is not None:
        raise ValueError(f"build_on: {type(module).__name__} holds buffers")
    return random_weights_(module.to_empty(device=device), generator)


class DiTTrainer:
    def __init__(self, cfg: Config, vae: nn.Module, encoder: nn.Module,
                 encoder_state: Optional[Dict[str, torch.Tensor]] = None, *,
                 latent_renderer=None, device="cuda"):
        """``vae``: the frozen ``VAEModel`` (encoder side used here);
        ``encoder``: the frozen conditioning encoder module, with
        ``encoder_state`` loaded into it when given; ``latent_renderer``:
        an optional ``(z [B,h,w,Cl], device batch, timer=) -> outputs``
        decode + deform + render callable (a ``LatentRenderer``) for
        ``sample_eval``. The DiT is built on ``device`` with seeded random
        weights (``init``)."""
        dev = resolve_device(device)
        self.cfg, self.device = cfg, dev
        self.vae = vae.to(dev).eval().requires_grad_(False)
        if encoder_state is not None:
            encoder.load_state_dict(encoder_state)
        self.encoder = encoder.to(dev).eval().requires_grad_(False)
        self.latent_renderer = latent_renderer
        self.scheduler = DDIMScheduler.from_config(cfg, device=dev)
        self.pipeline = SamplePipeline(cfg, self.scheduler)
        self.autocast = cfg.mixed_precision == "bf16"
        self.init(cfg.seed)
        self.opt = torch.optim.AdamW(self.model.parameters(), lr=cfg.lr,
                                     betas=(0.9, 0.95), eps=1e-8,
                                     weight_decay=1e-4,
                                     fused=dev.type == "cuda")
        self.step = 0       # micro-steps taken
        self.updates = 0    # optimizer updates applied
        self._micro = 0

    # ------------------------------------------------------------------ init

    def init(self, seed: int):
        """Seeded DiT weights (linear/conv N(0, 1/fan_in), biases 0, norms
        1); the trainer's generator restarts from ``seed``."""
        dev = self.device
        self.model = build_on(dev, lambda: DiTModel(self.cfg),
                              torch.Generator(device=dev).manual_seed(seed + 2))
        self.generator = torch.Generator(device=dev).manual_seed(seed + 5)

    def lr_at(self, count: int) -> float:
        """The learning rate of the update that follows ``count`` applied
        ones (warmup from 0, then cosine to 0; or constant)."""
        cfg = self.cfg
        if cfg.lr_scheduler != "cosine":
            return cfg.lr
        warm = cfg.lr_warmup_steps
        if count < warm:
            return (0.0 - cfg.lr) * (1.0 - count / warm) + cfg.lr
        span = max(warm + 1, COSINE_UPDATES) - warm
        frac = min(count - warm, span) / span
        return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * frac))

    # --------------------------------------------------------------- encode

    def to_device(self, batch, keys=None) -> Dict[str, torch.Tensor]:
        """The numeric entries of a loader batch (or only ``keys``) as f32
        device tensors."""
        keys = keys or [k for k, v in batch.items()
                        if np.issubdtype(np.asarray(v).dtype, np.number)]
        return {k: torch.as_tensor(np.asarray(batch[k]), dtype=torch.float32,
                                   device=self.device) for k in keys}

    def _dit(self, latent, cond, t) -> torch.Tensor:
        """The DiT's f32 v prediction, under bf16 autocast with
        ``mixed_precision="bf16"`` (the train step's and sampling's)."""
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.autocast):
            return self.model(latent, cond, t).float()

    @torch.no_grad()
    def encode_inputs(self, batch: Dict[str, torch.Tensor],
                      enc_noise: Optional[torch.Tensor] = None,
                      timer=NULL_TIMER):
        """(latent [B,Cl,h,w] x ``vae_scaling_factor``, cond [B,D,h',w']).

        A batch carrying ``latent`` (already scaled) and ``cond`` takes the
        pre-encoded path and may not also carry the raw inputs. Otherwise
        the frozen VAE encodes ``input`` / ``UV_inital`` and its posterior
        is sampled with ``enc_noise`` [B,h,w,Cl] (default: a draw from the
        trainer's generator), and the frozen encoder encodes
        ``sapiens_input``; spans "vae_encode" and "cond_encode"."""
        if "latent" in batch and "cond" in batch:
            raw = [k for k in RAW_KEYS if k in batch]
            if raw:
                raise ValueError(
                    f"batch carries both pre-encoded ('latent'/'cond') and "
                    f"raw {raw} keys; drop one set: the pre-encoded path "
                    f"expects latents already scaled by vae_scaling_factor")
            return batch["latent"].float(), batch["cond"].float()
        with timer("vae_encode"):
            post = self.vae.encode(batch["input"], batch["UV_inital"])
            if enc_noise is None:
                enc_noise = torch.randn(post.mean.shape,
                                        generator=self.generator,
                                        device=self.device)
            z = post.mean + torch.exp(0.5 * post.logvar) \
                * enc_noise.to(self.device)
            latent = z.permute(0, 3, 1, 2) * self.cfg.vae_scaling_factor
        with timer("cond_encode"):
            cond = self.encoder(batch["sapiens_input"])
        return latent.contiguous(), cond

    def draw(self, b: int) -> Dict[str, torch.Tensor]:
        """One step's random draws from the trainer's generator: posterior
        noise, timesteps U{0..T-1}, latent noise, dropout [B,1,1,1]."""
        cfg, g, dev = self.cfg, self.generator, self.device
        q, c = cfg.uv_query_size, cfg.latent_channels
        return {
            "enc_noise": torch.randn((b, q, q, c), generator=g, device=dev),
            "t": torch.randint(0, cfg.num_train_timesteps, (b,), generator=g,
                               device=dev),
            "noise": torch.randn((b, c, q, q), generator=g, device=dev),
            "drop": torch.rand((b, 1, 1, 1), generator=g, device=dev)
            < cfg.noised_condition_dropout,
        }

    def _x0_loss(self, dit, latent, cond, t, noise) -> torch.Tensor:
        """The weighted x0 loss of ``dit``'s v prediction at timesteps t."""
        b = latent.shape[0]
        noisy = self.scheduler.add_noise(latent, noise, t)
        v = dit(noisy, cond, t)
        a = self.scheduler.alphas_cumprod[t].reshape(b, 1, 1, 1)
        x0 = torch.sqrt(a) * noisy - torch.sqrt(1.0 - a) * v
        w = self.scheduler.snr_weights(t).reshape(b, 1, 1, 1)
        return torch.mean(w * (x0 - latent) ** 2)

    # ------------------------------------------------------------ train step

    def _apply(self) -> bool:
        """One optimizer update every ``gradient_accumulation_steps`` calls:
        clip the averaged gradients, AdamW at ``lr_at(updates)``, clear."""
        self._micro += 1
        if self._micro % self.cfg.gradient_accumulation_steps:
            return False
        params = list(self.model.parameters())
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        clip_by_global_norm_(params, self.cfg.gradient_clip)
        for group in self.opt.param_groups:
            group["lr"] = self.lr_at(self.updates)
        self.opt.step()
        self.opt.zero_grad(set_to_none=True)
        self.updates += 1
        return True

    def train_step(self, batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   timer=NULL_TIMER) -> Dict[str, torch.Tensor]:
        """One (micro-)step on a device batch (raw or pre-encoded). ``draws``
        (``enc_noise``, ``t``, ``noise``, ``drop``) replaces the generator's
        draws. Returns {"loss"}; spans "vae_encode", "cond_encode",
        "dit_fwd_bwd", "optimizer"."""
        k = self.cfg.gradient_accumulation_steps
        b = next(iter(batch.values())).shape[0]
        if draws is None:
            draws = self.draw(b)
        latent, cond = self.encode_inputs(batch, draws.get("enc_noise"),
                                          timer)
        t = draws["t"].to(self.device, torch.long)
        drop = draws["drop"].to(self.device, torch.bool).reshape(b, 1, 1, 1)
        cond = torch.where(drop, 0.0, cond)
        with timer("dit_fwd_bwd"):
            loss = self._x0_loss(self._dit, latent, cond, t,
                                 draws["noise"].to(self.device))
            (loss / k).backward()
        with timer("optimizer"):
            self._apply()
        self.step += 1
        return {"loss": loss.detach()}

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def eval_loss(self, batch: Dict[str, torch.Tensor],
                  noise: Optional[torch.Tensor] = None,
                  enc_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Held-out loss at t = T/2 for every item, with ``noise`` (default:
        a draw from the trainer's generator); the DiT runs in f32."""
        latent, cond = self.encode_inputs(batch, enc_noise)
        b = latent.shape[0]
        t = torch.full((b,), self.cfg.num_train_timesteps // 2,
                       dtype=torch.long, device=self.device)
        if noise is None:
            noise = torch.randn(latent.shape, generator=self.generator,
                                device=self.device)
        return self._x0_loss(self.model, latent, cond, t,
                             noise.to(self.device))

    @torch.no_grad()
    def sample(self, cond_images: torch.Tensor,
               noise: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None,
               num_inference_steps: Optional[int] = None) -> torch.Tensor:
        """cond_images [B,3,H,W] -> latents [B,Cl,h,w], already divided by
        ``vae_scaling_factor``: the CFG DDIM loop from ``noise`` (default:
        a draw from ``generator``, else the trainer's)."""
        cfg = self.cfg
        if generator is None:
            generator = self.generator
        cond = self.encoder(cond_images.to(self.device))
        return self.pipeline.sample_latents(
            self._dit, cond, generator=generator, noise=noise,
            num_inference_steps=(num_inference_steps
                                 or cfg.num_inference_steps),
            guidance_scale=cfg.guidance_scale)

    @torch.no_grad()
    def sample_eval(self, batch: Dict[str, torch.Tensor],
                    noise: Optional[torch.Tensor] = None,
                    vis_path: Optional[str] = None,
                    num_inference_steps: Optional[int] = None,
                    timer=NULL_TIMER) -> Dict[str, float]:
        """Held-out conditioning images -> CFG sampling -> frozen VAE decode
        -> deform -> render against the ground truth: PSNR, and a GT |
        sample PNG at ``vis_path``. Spans "sampling" and the renderer's."""
        with timer("sampling"):
            latents = self.sample(batch["sapiens_input"], noise=noise,
                                  num_inference_steps=num_inference_steps)
        outputs = self.latent_renderer(latents.permute(0, 2, 3, 1), batch,
                                       timer=timer)
        logs = {"sample_psnr": float(psnr(outputs["images_pred"],
                                          outputs["images_gt"]))}
        if vis_path is not None:
            from sigman_release_torch.utils.visualize import save_visualization

            save_visualization(
                {k: outputs[k].float().cpu().numpy()
                 for k in ("images_pred", "images_gt")}, vis_path)
        return logs

    # ------------------------------------------------------------------ fit

    def fit(self, loader, num_steps: Optional[int] = None,
            log_every: int = 10, ckpt_path: Optional[str] = None,
            logger=None, eval_loader=None,
            eval_every: Optional[int] = None) -> Dict[str, float]:
        """Train over ``loader`` epochs until ``num_steps`` micro-steps (one
        epoch if None): log every ``log_every``, save to ``ckpt_path`` every
        ``save_ckpt_steps`` and at the end, and every ``eval_every`` steps
        take the eval loss over up to 4 ``eval_loader`` batches and, with a
        ``latent_renderer``, one ``sample_eval`` on the first (its PNG goes
        to ``<workspace>/dit_sample_<step>.png``). Returns the last logs."""
        cfg = self.cfg
        timer = StepTimer()
        timer.tick()
        logs: Dict[str, float] = {}
        done = False
        while not done:
            for batch in loader:
                if num_steps is not None and self.step >= num_steps:
                    done = True
                    break
                keys = ENCODED_KEYS if "latent" in batch else RAW_KEYS
                out = self.train_step(self.to_device(batch, keys))
                logs = {n: float(v) for n, v in out.items()}
                timer.tick()
                if self.step % log_every == 0:
                    summ = timer.summary()
                    print(f"[dit] step {self.step} loss {logs['loss']:.4f} "
                          f"({summ.get('step_time_mean_s', 0.0):.2f}s/step)",
                          flush=True)
                    if logger is not None:
                        logger.log(self.step, {**logs, **summ})
                if ckpt_path and self.step % cfg.save_ckpt_steps == 0:
                    self.save(ckpt_path)
                if (eval_loader is not None and eval_every
                        and self.step % eval_every == 0):
                    self._evaluate(eval_loader, logger)
            if num_steps is None:
                done = True
        if ckpt_path:
            self.save(ckpt_path)
        return logs

    def _evaluate(self, eval_loader, logger=None):
        losses, first = [], None
        for i, eb in enumerate(eval_loader):
            if i >= 4:
                break
            keys = ENCODED_KEYS if "latent" in eb else RAW_KEYS
            losses.append(float(self.eval_loss(self.to_device(eb, keys))))
            if first is None:
                first = eb
        ev: Dict[str, float] = {}
        if losses:
            ev["eval_loss"] = float(np.mean(losses))
        if self.latent_renderer is not None and first is not None:
            ev.update(self.sample_eval(
                self.to_device(first), vis_path=os.path.join(
                    self.cfg.workspace, f"dit_sample_{self.step:07d}.png")))
        if ev:
            print(f"[dit] eval @ {self.step}: {ev}", flush=True)
            if logger is not None:
                logger.log(self.step, ev)

    # ----------------------------------------------------------- state file

    def save(self, path: str):
        """The port's own state file: DiT weights, optimizer state, step
        counts and the generator (``torch.save``, written atomically). A
        partial gradient accumulation is not saved."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        torch.save({"model": self.model.state_dict(),
                    "optimizer": self.opt.state_dict(),
                    "step": self.step, "updates": self.updates,
                    "micro": self._micro,
                    "generator": self.generator.get_state()}, tmp)
        os.replace(tmp, path)

    def resume(self, path: str):
        """Restore a state file written by :meth:`save`."""
        state = torch.load(path, map_location=self.device, weights_only=True)
        self.model.load_state_dict(state["model"])
        self.opt.load_state_dict(state["optimizer"])
        self.step, self.updates = int(state["step"]), int(state["updates"])
        self._micro = int(state["micro"])
        self.generator.set_state(state["generator"].cpu())
        self.opt.zero_grad(set_to_none=True)


def step_flops(cfg: Config, batch: int, cond_tokens: int) -> Dict[str, float]:
    """Floating-point operations of one DiT training step from the shapes
    (a multiply-add is 2): ``forward`` (patch and conditioning projections,
    the blocks' token-wise matmuls, attention scores and values, the AdaLN
    and time-embedding linears, the output projection), ``model`` = 3 x
    forward (forward + backward), ``with_recompute`` = model + the blocks'
    forward again (per-block checkpointing)."""
    d, p, temb = cfg.hidden_dim, cfg.patch_size, cfg.time_embed_dim
    s_img = (cfg.sample_height // p) * (cfg.sample_width // p)
    s = s_img + cond_tokens
    block = (2 * s * 4 * d * d              # q, k, v, out
             + 2 * s * 2 * d * 4 * d        # FFN in and out
             + 2 * 2 * s * s * d            # scores and values
             + 2 * 2 * temb * 6 * d)        # two AdaLN-zero linears
    rest = (2 * s_img * cfg.in_channels * p * p * d
            + 2 * cond_tokens * cfg.text_embed_dim * 16 * d
            + 2 * (d * temb + temb * temb) + 2 * temb * 2 * d
            + 2 * s_img * d * p * p * cfg.out_channels)
    fwd = batch * (cfg.num_layers * block + rest)
    recompute = batch * cfg.num_layers * block \
        if cfg.gradient_checkpointing else 0
    return {"forward": float(fwd), "model": 3.0 * fwd,
            "with_recompute": 3.0 * fwd + recompute}


def frozen_vae(cfg: Config, body_model=None, template=None, *,
               device="cuda"):
    """The VAE the DiT trains against, with seeded weights
    (``vae_trainer.init_vae_``), and its ``LatentRenderer`` on
    ``body_model`` / ``template`` (default: the configured ones, else the
    procedural body). Returns (vae, latent_renderer)."""
    dev = resolve_device(device)
    with torch.device(dev):   # default inits run on the device
        vae = VAEModel(cfg).to(dev)
    init_vae_(vae, cfg.seed)
    return vae, LatentRenderer(cfg, vae, body_model, template, device=dev)


def synthetic_setup(cfg: Config, *, device="cuda", n_items: Optional[int] = None,
                    n_verts: int = 100_002, body_model=None, template=None,
                    seed: int = 0):
    """A ``DiTTrainer`` over the frozen VAE of ``frozen_vae`` (on the
    procedural body of ``n_verts`` vertices; pass ``body_model`` and
    ``template`` to reuse built ones) and the encoder of
    ``make_encoder(cfg)``, all with seeded random weights and built on the
    device; a device batch of ``n_items`` (default ``cfg.batch_size``)
    ``SyntheticAvatarDataset`` items and one held-out item for the sampling
    eval — the set-up of ``chip_smoke.py`` and ``training/profile_step.py``.
    Returns (trainer, batch, eval_batch)."""
    from sigman_release_torch.body.smplx import synthetic_body_model
    from sigman_release_torch.body.template import synthetic_template
    from sigman_release_torch.data.dataset import SyntheticAvatarDataset

    dev = resolve_device(device)
    n_items = n_items or cfg.batch_size
    if body_model is None:
        body_model = synthetic_body_model(n_verts=n_verts, seed=seed,
                                          device=dev)
    if template is None:
        template = synthetic_template(body_model)
    vae, latent_renderer = frozen_vae(cfg, body_model, template, device=dev)
    encoder = build_on(dev, lambda: make_encoder(cfg),
                       torch.Generator(device=dev).manual_seed(seed + 1))
    trainer = DiTTrainer(cfg, vae, encoder, latent_renderer=latent_renderer,
                         device=dev)
    data = SyntheticAvatarDataset(cfg, n_items=n_items + 1, seed=seed)
    items = [data[i] for i in range(n_items + 1)]
    batch = trainer.to_device(
        {k: np.stack([it[k] for it in items[:n_items]]) for k in RAW_KEYS})
    eval_batch = trainer.to_device({k: v[None] for k, v in items[-1].items()
                                    if k != "item"})
    return trainer, batch, eval_batch
