"""The reference's image -> avatar request with the FLUX denoiser
(``AvatarPipeline.__call__`` at ``denoiser="flux"``): encoder, the flow
Euler loop over ``models/flux.py::BlockwiseFlux``, decode, deform, render.

As ``steps.Serve`` does for the DiT: f32, on the bf16 values of the
denoiser's weights when the configuration serves it in bf16; with
``control=True`` the denoiser's linears run on fp8 and the encoder and
decoder under bf16 autocast. The denoiser's weights come one part at a time
from ``state_of(part)`` (``models/flux.py::part_names``), so that the 11.9 B
parameters are never held at once in f32.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from portbench.reference.diffusion import flow
from portbench.reference.models import flux
from portbench.reference.models.encoders import make_encoder
from portbench.reference.models.vae import VAEModel
from portbench.reference.precision import part, to_fp8
from portbench.reference.steps import Decode, build


class FluxServe:
    def __init__(self, cfg, flux_fields: dict, body, template, vae_state,
                 enc_state, state_of: Callable[[str], Dict], device,
                 control=False):
        self.cfg, self.device, self.control = cfg, device, control
        dec = {k: v for k, v in vae_state.items()
               if k.startswith(("autoencoder.decoder.", "heads."))}
        self.vae = build(lambda: VAEModel(cfg, with_encoder=False), dec,
                         device).eval()
        self.encoder = build(lambda: make_encoder(cfg, False), enc_state,
                             device).eval()
        bf16 = cfg.mixed_precision == "bf16"

        def served(name):
            sd = state_of(name)
            if bf16:     # served in bf16: the reference computes on its values
                sd = {k: v.to(torch.bfloat16).float() for k, v in sd.items()}
            return sd

        self.fields = flux_fields
        self.model = flux.BlockwiseFlux(
            flux.params_of(cfg, flux_fields), served, device,
            prepare=to_fp8 if control else None)
        self.decode = Decode(cfg, body, template)

    def schedule(self):
        cfg = self.cfg
        tokens = (cfg.sample_height // 2) * (cfg.sample_width // 2)
        return flow.get_schedule(cfg.num_inference_steps, tokens,
                                 self.fields["base_shift"],
                                 self.fields["max_shift"])

    @torch.no_grad()
    def __call__(self, image, smpl_vec, noise, cam_view, cam_view_proj):
        """A batch of answers: image [B,3,S,S], smpl_vec [B,D], noise
        [B,Cl,h,w] -> (latents [B,Cl,h,w], images [B,V,3,H,W])."""
        cfg, dev = self.cfg, self.device
        with part(self.control, "f32", dev):
            cond = self.encoder(image).float()
        latents = flow.denoise(
            lambda x, t, g: flux.velocity(self.model, x, cond, t, g),
            noise.float(), self.schedule(), cfg.guidance_scale)
        latents = latents / cfg.vae_scaling_factor
        images = []
        for b in range(latents.shape[0]):
            with part(self.control, "f32", dev):
                attr_map = self.vae.decode(
                    latents[b:b + 1].permute(0, 2, 3, 1)).float()
            images.append(self.decode.render(
                attr_map, smpl_vec[b:b + 1], cam_view[None],
                cam_view_proj[None])[0])
        return latents, torch.stack(images)
