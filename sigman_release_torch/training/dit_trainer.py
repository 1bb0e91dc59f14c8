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
  from the trainer's ``torch.Generator`` (seeded from the seed and the
  mesh's data index) unless the caller hands them over (``draws``).
* Data parallelism over 'data' (``mesh``, ``parallel/mesh.py``; a process
  group must exist): DDP wraps the DiT, its gradients views of the
  all-reduce buckets; the frozen VAE and encoder stay bare. Accumulation
  micro-steps before the last run under ``no_sync``. The loss log and
  ``eval_loss`` are averaged over the ranks weighted by items;
  ``sample_eval`` runs the bare DiT and no collective, on rank 0 in
  ``fit``.
* ``spmd="fsdp"`` with a process group (the JAX package's FSDP, and its
  'model' axis): the DiT is built whole with the seeded weights, then
  sharded in place (``parallel/fsdp.py``: tensor parallelism over 'model',
  FSDP2 over 'data'); AdamW runs on the shards. The step has the JAX fsdp
  step's global semantics: every rank draws the whole world's draws from
  one generator (not folded by the data index) and keeps its rows, so at
  any world size it equals one process on the whole batch. Gradients are
  reduce-scattered after every micro-step and accumulate in their shards,
  as the JAX package's sharded ``acc_grads``. Every DiT forward is
  collective: ``eval_loss`` runs one on a rank without a batch too, and
  ``sample`` / ``sample_eval`` run on every rank with the same batch
  (``fit`` hands every rank rank 0's first eval batch). Without a process
  group the trainer runs as one process.
* ``sample_eval`` divides the sampled latents by ``vae_scaling_factor``
  once (inside the sampler), as the single-image serving path does.
* State files: ``save`` writes the port's own (weights, optimizer, step
  counts, a partial accumulation's gradient sums, the generator);
  ``resume`` also reads the JAX package's msgpack state file (a full train
  state, or bare parameters) and the reference's safetensors (parameters
  only), through ``training/checkpoint.py``. A sharded trainer writes and
  reads whole tensors (``fsdp.full_state_dict``): its file is the one a
  single process writes, and any world size or layout resumes it.
"""

from __future__ import annotations

import itertools
import math
import os
from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from sigman_release_torch import convert
from sigman_release_torch.avatar import LatentRenderer
from sigman_release_torch.config import Config
from sigman_release_torch.device import resolve_device
from sigman_release_torch.diffusion.ddim import DDIMScheduler
from sigman_release_torch.diffusion.pipeline import SamplePipeline
from sigman_release_torch.losses.metrics import psnr
from sigman_release_torch.models.dit import DiTModel
from sigman_release_torch.models.encoders import (
    ViTFeatureEncoder,
    sapiens_1b_encoder,
)
from sigman_release_torch.models.init import build_on, init_vae_
from sigman_release_torch.models.vae import VAEModel
from sigman_release_torch.parallel import fsdp
from sigman_release_torch.parallel.mesh import (
    Mesh,
    make_mesh,
    rank_seed,
    shard_batch,
)
from sigman_release_torch.training import checkpoint, loop

# ``_apply`` looks the clip up in this module: the multi-rank cases
# (``training/cases.py``) and the tests tap it by patching this name
from sigman_release_torch.training.loop import (
    clip_by_global_norm_,
    no_sync,
    wrap_ddp,
)
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


class DiTTrainer:
    def __init__(self, cfg: Config, vae: nn.Module, encoder: nn.Module,
                 encoder_state: Optional[Dict[str, torch.Tensor]] = None, *,
                 latent_renderer=None, device="cuda",
                 mesh: Optional[Mesh] = None):
        """``vae``: the frozen ``VAEModel`` (encoder side used here);
        ``encoder``: the frozen conditioning encoder module, with
        ``encoder_state`` loaded into it when given; ``latent_renderer``:
        an optional ``(z [B,h,w,Cl], device batch, timer=) -> outputs``
        decode + deform + render callable (a ``LatentRenderer``) for
        ``sample_eval``; ``mesh``: this rank's place in the data-parallel
        layout (default ``make_mesh(cfg.mesh_shape, cfg.mesh_axes)``; no
        'view' axis). The DiT is built on ``device`` with seeded random
        weights (``init``); with a process group it runs under DDP, or
        sharded with ``cfg.spmd == "fsdp"``."""
        if cfg.denoiser != "dit":
            raise ValueError(
                f"DiTTrainer trains the DiT denoiser only; this config's "
                f"denoiser is {cfg.denoiser!r} (FLUX is served by "
                "AvatarPipeline, not trained here)")
        dev = resolve_device(device)
        self.cfg, self.device = cfg, dev
        self.mesh = mesh or make_mesh(cfg.mesh_shape, cfg.mesh_axes)
        self.fsdp = cfg.spmd == "fsdp" and self.mesh.distributed
        if self.mesh.view_size > 1:
            raise ValueError("the DiT trainer shards its batch over 'data' "
                             "only; its mesh has a 'view' axis of "
                             f"{self.mesh.view_size}")
        self.vae = vae.to(dev).eval().requires_grad_(False)
        if encoder_state is not None:
            encoder.load_state_dict(encoder_state)
        self.encoder = encoder.to(dev).eval().requires_grad_(False)
        self.latent_renderer = latent_renderer
        self.scheduler = DDIMScheduler.from_config(cfg, device=dev)
        self.pipeline = SamplePipeline(cfg, self.scheduler)
        self.autocast = cfg.mixed_precision == "bf16"
        self.init(cfg.seed)
        self.ddp = None
        if self.fsdp:
            fsdp.shard_dit(self.model, self.mesh)
        elif self.mesh.distributed:
            self.ddp = wrap_ddp(self.model, dev)
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
        1); the trainer's generator restarts from ``seed`` and the mesh's
        data index (under FSDP every rank draws one stream: data index 0)."""
        dev = self.device
        self.model = build_on(dev, lambda: DiTModel(self.cfg),
                              torch.Generator(device=dev).manual_seed(seed + 2))
        self.generator = torch.Generator(device=dev).manual_seed(
            rank_seed(seed + 5, 0 if self.fsdp else self.mesh.data_index))

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
        return {k: v.float() for k, v in shard_batch(
            {k: batch[k] for k in keys}, self.mesh, self.device).items()}

    def _dit(self, latent, cond, t, model: Optional[nn.Module] = None
             ) -> torch.Tensor:
        """The DiT's f32 v prediction, under bf16 autocast with
        ``mixed_precision="bf16"`` (the train step's and sampling's);
        ``model`` is the module called (default the bare DiT; the train
        step passes its DDP)."""
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.autocast):
            return (self.model if model is None else model)(
                latent, cond, t).float()

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

    def _rows(self, b: int):
        """(start, whole) of this rank's b rows among the whole world's
        draws: under FSDP (b x data size rows, this data index's block),
        else (0, b)."""
        if not self.fsdp:
            return 0, b
        return self.mesh.data_index * b, b * self.mesh.data_size

    def draw(self, b: int) -> Dict[str, torch.Tensor]:
        """One step's random draws from the trainer's generator: posterior
        noise, timesteps U{0..T-1}, latent noise, dropout [B,1,1,1]; under
        FSDP this rank's rows of the whole world's draws."""
        cfg, g, dev = self.cfg, self.generator, self.device
        q, c = cfg.uv_query_size, cfg.latent_channels
        start, n = self._rows(b)
        whole = {
            "enc_noise": torch.randn((n, q, q, c), generator=g, device=dev),
            "t": torch.randint(0, cfg.num_train_timesteps, (n,), generator=g,
                               device=dev),
            "noise": torch.randn((n, c, q, q), generator=g, device=dev),
            "drop": torch.rand((n, 1, 1, 1), generator=g, device=dev)
            < cfg.noised_condition_dropout,
        }
        return {k: v[start:start + b] for k, v in whole.items()}

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
        draws. Returns {"loss"}, averaged over the ranks by items; spans
        "vae_encode", "cond_encode", "dit_fwd_bwd", "optimizer"."""
        k = self.cfg.gradient_accumulation_steps
        b = next(iter(batch.values())).shape[0]
        if draws is None:
            draws = self.draw(b)
        latent, cond = self.encode_inputs(batch, draws.get("enc_noise"),
                                          timer)
        t = draws["t"].to(self.device, torch.long)
        drop = draws["drop"].to(self.device, torch.bool).reshape(b, 1, 1, 1)
        cond = torch.where(drop, 0.0, cond)
        last = (self._micro + 1) % k == 0
        with timer("dit_fwd_bwd"), no_sync(self.ddp, last):
            loss = self._x0_loss(
                lambda *a: self._dit(*a, model=self.ddp), latent, cond, t,
                draws["noise"].to(self.device))
            (loss / k).backward()
        with timer("optimizer"):
            self._apply()
        self.step += 1
        return self.mesh.mean({"loss": loss.detach()}, weight=b)

    # ------------------------------------------------------------------ eval

    @torch.no_grad()
    def eval_loss(self, batch: Optional[Dict[str, torch.Tensor]],
                  noise: Optional[torch.Tensor] = None,
                  enc_noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Held-out loss at t = T/2 for every item, with ``noise`` (default:
        a draw from the trainer's generator; under FSDP this rank's rows of
        the draws of every rank's items pooled); the DiT runs in f32.
        Averaged over the ranks' items: a rank without a batch passes None
        and adds nothing but joins the collectives (under FSDP with a DiT
        forward on one zero item)."""
        stats = torch.zeros(2, dtype=torch.float64, device=self.device)
        if self.fsdp and (noise is None or enc_noise is None):
            noise, enc_noise = self._eval_draws(batch, noise, enc_noise)
        if batch is None and self.fsdp:
            self._idle_forward()
        if batch is not None:
            latent, cond = self.encode_inputs(batch, enc_noise)
            b = latent.shape[0]
            t = torch.full((b,), self.cfg.num_train_timesteps // 2,
                           dtype=torch.long, device=self.device)
            if noise is None:
                noise = torch.randn(latent.shape, generator=self.generator,
                                    device=self.device)
            loss = self._x0_loss(self.model, latent, cond, t,
                                 noise.to(self.device))
            if not self.mesh.distributed:
                return loss
            stats = torch.stack([loss.double() * b,
                                 torch.tensor(float(b), dtype=torch.float64,
                                              device=self.device)])
        total, n = self.mesh.all_reduce_(stats).unbind()
        return (total / n).float()

    def _eval_draws(self, batch, noise, enc_noise):
        """(noise, enc_noise), each given or else this rank's rows of the
        draws one process takes on every data index's eval items pooled in
        order: the posterior noise (when a rank encodes raw inputs), then
        the latent noise. Every rank calls it alike."""
        cfg, g, dev = self.cfg, self.generator, self.device
        b = 0 if batch is None else next(iter(batch.values())).shape[0]
        raw = batch is not None and not ("latent" in batch and "cond" in batch)
        shares = dict((d, (n, r)) for d, n, r in self.mesh.gather(
            (self.mesh.data_index, b, raw)))
        start = sum(shares[d][0] for d in range(self.mesh.data_index))
        total = sum(n for n, _ in shares.values())
        q, c = cfg.uv_query_size, cfg.latent_channels
        if enc_noise is None and any(r for _, r in shares.values()):
            enc_noise = torch.randn((total, q, q, c), generator=g,
                                    device=dev)[start:start + b]
        if noise is None:
            noise = torch.randn((total, c, q, q), generator=g,
                                device=dev)[start:start + b]
        return noise, enc_noise

    def _idle_forward(self):
        """One DiT forward on a zero item: a rank without a batch joins the
        sharded DiT's collectives."""
        cfg, dev = self.cfg, self.device
        self.model(torch.zeros((1, cfg.in_channels, cfg.sample_height,
                                cfg.sample_width), device=dev),
                   torch.zeros((1, cfg.text_embed_dim, 4, 4), device=dev),
                   torch.zeros((1,), dtype=torch.long, device=dev))

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
        sample PNG at ``vis_path``. Spans "sampling" and the renderer's.
        Under FSDP every rank calls it with the same batch."""
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
            eval_every: Optional[int] = None,
            profile_dir: Optional[str] = None,
            profile_every: int = 500) -> Dict[str, float]:
        """Train step by step in ``loop.fit`` (its micro-step count,
        cadences, state file, prefetch and tracing) on raw or pre-encoded
        batches. Every ``eval_every`` steps take the eval loss over up to 4
        ``eval_loader`` batches and, with a ``latent_renderer``, one
        ``sample_eval`` on rank 0's first (on every rank under FSDP; its PNG
        goes to ``<workspace>/dit_sample_<step>.png``). Only rank 0 prints
        and logs. Returns the last logs."""
        return loop.fit(
            self, loader,
            lambda batch: self.train_step({k: v.float()
                                           for k, v in batch.items()}),
            keys=lambda b: ENCODED_KEYS if "latent" in b else RAW_KEYS,
            head=lambda logs: (f"[dit] step {self.step} "
                               f"loss {logs['loss']:.4f}"),
            evaluate=None if eval_loader is None
            else lambda: self._evaluate(eval_loader, logger),
            num_steps=num_steps, log_every=log_every, eval_every=eval_every,
            ckpt_path=ckpt_path, logger=logger, profile_dir=profile_dir,
            profile_every=profile_every)

    def _evaluate(self, eval_loader, logger=None) -> Dict[str, float]:
        """The eval loss over up to 4 eval batches (as many on every rank
        as the longest share has; batch i pools the i-th of every rank)
        and one ``sample_eval`` on rank 0's first batch: on rank 0, or
        under FSDP on every rank (rank 0's batch sent to each)."""
        steps = self.mesh.max_int(min(len(eval_loader), 4))
        losses, first = [], None
        batches = itertools.chain(itertools.islice(eval_loader, steps),
                                  itertools.repeat(None))
        for _, eb in zip(range(steps), batches):
            if eb is not None:
                keys = ENCODED_KEYS if "latent" in eb else RAW_KEYS
                first = eb if first is None else first
            losses.append(float(self.eval_loss(
                None if eb is None else self.to_device(eb, keys))))
        ev: Dict[str, float] = {}
        if losses:
            ev["eval_loss"] = float(np.mean(losses))
        lead = self.mesh.rank == 0
        if self.fsdp:
            first = self.mesh.broadcast_object(first)
        if ((lead or self.fsdp) and self.latent_renderer is not None
                and first is not None):
            ev.update(self.sample_eval(
                self.to_device(first), vis_path=os.path.join(
                    self.cfg.workspace, f"dit_sample_{self.step:07d}.png")
                if lead else None))
        if ev and lead:
            print(f"[dit] eval @ {self.step}: {ev}", flush=True)
            if logger is not None:
                logger.log(self.step, ev)
        return ev

    # ----------------------------------------------------------- state file

    def save(self, path: str):
        """The port's own state file: DiT weights, optimizer state, step
        counts, the gradient sums of a partial accumulation (averaged over
        the ranks) and every rank's generator (``torch.save``, written
        atomically). Every rank calls it; rank 0 writes and the others wait
        for the file. A sharded trainer gathers whole tensors: the same
        file as one process's."""
        grads = checkpoint.partial_grads(self.model.parameters(), self._micro,
                                         self.cfg.gradient_accumulation_steps)
        if self.fsdp:
            model_sd, opt_sd, grads = fsdp.full_state_dict(
                self.model, self.opt, grads)
            state = checkpoint.rank_state(self.mesh, self.generator)
        else:
            model_sd, opt_sd = self.model.state_dict(), self.opt.state_dict()
            state = checkpoint.rank_state(self.mesh, self.generator, grads)
        if self.mesh.rank == 0:
            checkpoint.save_torch(path, {
                "model": model_sd,
                "optimizer": opt_sd,
                "step": self.step, "updates": self.updates,
                "micro": self._micro, "grads": grads, **state})
        self.mesh.barrier()

    def resume(self, path: str):
        """Restore a state file in any of the three formats: the port's own
        (everything :meth:`save` wrote); a msgpack full train state
        (weights, AdamW moments and count, a partial accumulation, the
        step); a msgpack parameter tree or reference safetensors (the DiT's
        parameters only)."""
        fmt = checkpoint.sniff_format(path)
        if fmt == "torch":
            state = checkpoint.load_torch(path)
            if self.fsdp:
                fsdp.load_full_state_dict(self.model, state["model"],
                                          self.opt, state["optimizer"])
            else:
                self.model.load_state_dict(state["model"])
                self.opt.load_state_dict(state["optimizer"])
            self.step, self.updates = int(state["step"]), int(state["updates"])
            self._micro = int(state["micro"])
            checkpoint.restore_grads_(self.model.parameters(),
                                      state.get("grads"))
            checkpoint.restore_generator_(self.generator, state, self.mesh,
                                          self.cfg.seed + 5, shared=self.fsdp)
            return
        state = checkpoint.read_msgpack(path) if fmt == "msgpack" else None
        if state is None or "step" not in state:
            sd, _ = checkpoint.load_params_any(path, self.model, self.cfg)
            if self.fsdp:
                fsdp.load_full_state_dict(
                    self.model, {k: fsdp.full(v) for k, v in sd.items()})
            else:
                self.model.load_state_dict(sd)
            return
        # a full train state of the JAX package's DiT trainer: params,
        # opt_state (clip + AdamW over the params), step (micro-steps)
        key_map = convert.key_map_for(self.model, self.cfg)
        restore = checkpoint.tree_params
        checkpoint.copy_params_(self.model.parameters(), restore(
            self.model, state["params"], key_map, fill="weights"))
        adam, mini, acc = checkpoint.optimizer_parts(state["opt_state"])
        checkpoint.load_adamw_(self.opt, zip(
            restore(self.model, adam["mu"], key_map),
            restore(self.model, adam["nu"], key_map)), int(adam["count"]))
        k = self.cfg.gradient_accumulation_steps
        checkpoint.restore_grads_(
            self.model.parameters(), None if acc is None or not mini else
            [g * (mini / k) for g in restore(self.model, acc, key_map)])
        self.step, self.updates = int(state["step"]), int(adam["count"])
        self._micro = mini


def frozen_vae(cfg: Config, body_model=None, template=None, *,
               device="cuda"):
    """The VAE the DiT trains against, with seeded weights
    (``models/init.init_vae_``), and its ``LatentRenderer`` on
    ``body_model`` / ``template`` (default: the configured ones, else the
    procedural body). Returns (vae, latent_renderer)."""
    dev = resolve_device(device)
    with torch.device(dev):   # default inits run on the device
        vae = VAEModel(cfg).to(dev)
    init_vae_(vae, cfg.seed)
    return vae, LatentRenderer(cfg, vae, body_model, template, device=dev)


def synthetic_setup(cfg: Config, *, device="cuda", n_items: Optional[int] = None,
                    n_verts: int = 100_002, body_model=None, template=None,
                    seed: int = 0, mesh: Optional[Mesh] = None):
    """A ``DiTTrainer`` (on ``mesh``, as it takes one) over the frozen VAE
    of ``frozen_vae`` (on the procedural body of ``n_verts`` vertices; pass
    ``body_model`` and ``template`` to reuse built ones) and the encoder of
    ``make_encoder(cfg)``, all with seeded random weights and built on the
    device; a device batch of ``n_items`` (default ``cfg.batch_size``)
    ``SyntheticAvatarDataset`` items and one held-out item for the sampling
    eval — the set-up of ``chip_smoke.py``.
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
                         device=dev, mesh=mesh)
    data = SyntheticAvatarDataset(cfg, n_items=n_items + 1, seed=seed)
    items = [data[i] for i in range(n_items + 1)]
    batch = trainer.to_device(
        {k: np.stack([it[k] for it in items[:n_items]]) for k in RAW_KEYS})
    eval_batch = trainer.to_device({k: v[None] for k, v in items[-1].items()
                                    if k != "item"})
    return trainer, batch, eval_batch
