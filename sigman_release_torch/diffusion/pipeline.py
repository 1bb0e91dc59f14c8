"""Image-conditioned sampling: the CFG DDIM denoise loop (port of
the JAX package's ``diffusion/pipeline.py`` ``SamplePipeline.sample_latents``
with the sampling glue of ``DiTTrainer.sample``), and the flow-matching
Euler loop of a guidance-distilled denoiser (``FlowSamplePipeline``).

Initial latents are N(0,1) x init_noise_sigma, drawn from an explicit
``torch.Generator`` or passed in as ``noise``. Each step runs the DiT once on
a doubled batch (zero conditioning | conditioning), mixes
``v_uncond + g (v_cond - v_uncond)`` and takes an f32 DDIM step; the DiT runs
in its parameters' dtype (bf16 under ``mixed_precision="bf16"``) and its
output is cast back to f32. The result is divided by ``vae_scaling_factor``
once, ready for the VAE decoder.
"""

from __future__ import annotations

import math
from typing import List, Optional

import torch

from sigman_release_torch.config import Config
from sigman_release_torch.diffusion.ddim import DDIMScheduler
from sigman_release_torch.diffusion.flow_matching import FlowScheduler
from sigman_release_torch.utils.timing import NULL_TIMER


class SamplePipeline:
    def __init__(self, cfg: Config, scheduler: Optional[DDIMScheduler] = None):
        self.cfg = cfg
        self.scheduler = scheduler or DDIMScheduler.from_config(cfg)

    @torch.no_grad()
    def sample_latents(
        self,
        dit: torch.nn.Module,          # (latent, cond, t[B]) -> v
        cond_feats: torch.Tensor,      # [B,Cc,hc,wc]
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        num_inference_steps: int = 30,
        guidance_scale: float = 3.5,
        timer=NULL_TIMER,
    ) -> torch.Tensor:
        """Run the CFG DDIM loop. Returns latents [B,C,h,w] / scaling factor.

        ``timer`` receives a "ddim_step" span per step and inside it a
        "ddim_update" span (the CFG combine and the scheduler's step); a
        timer other than ``NULL_TIMER`` is also passed to ``dit`` as its
        ``timer`` keyword."""
        cfg = self.cfg
        b = cond_feats.shape[0]
        shape = (b, cfg.latent_channels, cfg.sample_height, cfg.sample_width)
        if noise is None:
            noise = torch.randn(shape, generator=generator,
                                device=cond_feats.device)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise must be {shape}, got {tuple(noise.shape)}")
        latents = noise.to(cond_feats.device, torch.float32) \
            * self.scheduler.init_noise_sigma
        ts = self.scheduler.timesteps(num_inference_steps)
        ts_prev = ts[1:] + [-1]
        use_cfg = guidance_scale > 1.0
        cond2 = torch.cat([torch.zeros_like(cond_feats), cond_feats]) \
            if use_cfg else cond_feats

        kw = {} if timer is NULL_TIMER else {"timer": timer}
        for t, tp in zip(ts, ts_prev):
            with timer("ddim_step"):
                lat = torch.cat([latents, latents]) if use_cfg else latents
                tb = torch.full((lat.shape[0],), t, dtype=torch.int32,
                                device=latents.device)
                v = dit(lat, cond2, tb, **kw)
                with timer("ddim_update"):
                    v = v.float()
                    if use_cfg:
                        v_uncond, v_cond = v.chunk(2)
                        v = v_uncond + guidance_scale * (v_cond - v_uncond)
                    latents = self.scheduler.step(v, t, tp, latents)
        return latents / cfg.vae_scaling_factor


def flow_shift_mu(cfg: Config, image_tokens: int) -> float:
    """FLUX's resolution shift: mu linear in the image's token count, from
    ``base_shift`` at 256 tokens to ``max_shift`` at 4096."""
    slope = (cfg.max_shift - cfg.base_shift) / (4096 - 256)
    return cfg.base_shift + slope * (image_tokens - 256)


class FlowSamplePipeline:
    """The flow-matching Euler loop of FLUX.1-dev (BFL ``sampling.py``
    ``get_schedule`` and ``denoise``): the seed's noise unscaled, the
    shifted times ``FlowScheduler(shift=e^mu).timesteps(n)`` followed by 0,
    one forward a step with the guidance as an input (no doubled batch),
    ``x <- x + (t_prev - t) v`` in f32. The result is divided by
    ``vae_scaling_factor`` once, ready for the VAE decoder."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        mu = flow_shift_mu(cfg, cfg.num_patches)
        self.scheduler = FlowScheduler(cfg.num_train_timesteps,
                                       shift=math.exp(mu))

    def times(self, num_inference_steps: int) -> List[float]:
        """The n shifted times from 1 down, then 0."""
        return self.scheduler.timesteps(num_inference_steps).tolist() + [0.0]

    @torch.no_grad()
    def sample_latents(
        self,
        model: torch.nn.Module,        # (latent, cond, t[B], guidance[B])
        cond_feats: torch.Tensor,      # [B,Cc,hc,wc]
        *,
        generator: Optional[torch.Generator] = None,
        noise: Optional[torch.Tensor] = None,
        num_inference_steps: int = 28,
        guidance_scale: float = 3.5,
        timer=NULL_TIMER,
    ) -> torch.Tensor:
        """Run the Euler loop. Returns latents [B,C,h,w] / scaling factor.

        ``timer`` receives a "flow_update" span per step (the velocity's
        cast and the Euler step); a timer other than ``NULL_TIMER`` is also
        passed to ``model`` as its ``timer`` keyword."""
        cfg = self.cfg
        b, dev = cond_feats.shape[0], cond_feats.device
        shape = (b, cfg.latent_channels, cfg.sample_height, cfg.sample_width)
        if noise is None:
            noise = torch.randn(shape, generator=generator, device=dev)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise must be {shape}, got {tuple(noise.shape)}")
        latents = noise.to(dev, torch.float32)
        ts = self.times(num_inference_steps)
        guidance = torch.full((b,), guidance_scale, dtype=torch.float32,
                              device=dev)
        kw = {} if timer is NULL_TIMER else {"timer": timer}
        for t, tp in zip(ts[:-1], ts[1:]):
            tb = torch.full((b,), t, dtype=torch.float32, device=dev)
            v = model(latents, cond_feats, tb, guidance, **kw)
            with timer("flow_update"):
                latents = self.scheduler.step(v.float(), t, tp, latents)
        return latents / cfg.vae_scaling_factor
