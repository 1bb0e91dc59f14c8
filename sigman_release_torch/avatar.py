"""``LatentRenderer``: the VAE's decode path to rendered views, which the
VAE trainer, the DiT trainer's sampling eval and the serving pipeline's
test-set eval share.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

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
from sigman_release_torch.models.vae import (
    VAEModel,
    compose_rotations,
    sample_gaussian_attrs,
)
from sigman_release_torch.renderer import GaussianRenderer
from sigman_release_torch.utils.timing import NULL_TIMER


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
