# Frozen copy of sigman_release_torch/diffusion/pipeline.py at commit a519890 (the
# benchmark's plain reference; imports rewritten to portbench.reference).
"""Image-conditioned sampling: the CFG DDIM denoise loop (port of
the JAX package's ``diffusion/pipeline.py`` ``SamplePipeline.sample_latents``
with the sampling glue of ``DiTTrainer.sample``).

Initial latents are N(0,1) x init_noise_sigma, drawn from an explicit
``torch.Generator`` or passed in as ``noise``. Each step runs the DiT once on
a doubled batch (zero conditioning | conditioning), mixes
``v_uncond + g (v_cond - v_uncond)`` and takes an f32 DDIM step; the DiT runs
in its parameters' dtype (bf16 under ``mixed_precision="bf16"``) and its
output is cast back to f32. The result is divided by ``vae_scaling_factor``
once, ready for the VAE decoder.
"""

from __future__ import annotations

from typing import Optional

import torch

from portbench.reference.config import Config
from portbench.reference.diffusion.ddim import DDIMScheduler


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
    ) -> torch.Tensor:
        """Run the CFG DDIM loop. Returns latents [B,C,h,w] / scaling factor."""
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

        for t, tp in zip(ts, ts_prev):
            lat = torch.cat([latents, latents]) if use_cfg else latents
            tb = torch.full((lat.shape[0],), t, dtype=torch.int32,
                            device=latents.device)
            v = dit(lat, cond2, tb).float()
            if use_cfg:
                v_uncond, v_cond = v.chunk(2)
                v = v_uncond + guidance_scale * (v_cond - v_uncond)
            latents = self.scheduler.step(v, t, tp, latents)
        return latents / cfg.vae_scaling_factor
