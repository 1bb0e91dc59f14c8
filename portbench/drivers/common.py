"""What the drivers share: building reference modules' shapes, weights,
the program's view of the inputs, readings of the program's optimizer,
freeing the program, and the capture of what the rasterizer rendered."""

from __future__ import annotations

import gc
from typing import Dict, List

import torch

from portbench import inputs
from portbench.bounds import launch_bounds_s
from portbench.reference import render as plain

# weight streams of the seed, one per network
VAE_KEY, LPIPS_KEY, ENC_KEY, DIT_KEY = 1, 2, 3, 4


def meta_shapes(make) -> list:
    with torch.device("meta"):
        return inputs.module_shapes(make())


def vae_state(ref_cfg, seed, dev):
    from portbench.reference.models.vae import VAEModel

    return inputs.seeded_state(meta_shapes(lambda: VAEModel(ref_cfg)), dev,
                               seed, VAE_KEY)


def lpips_state(seed, dev):
    from portbench.reference.losses.lpips import LPIPS

    return inputs.seeded_state(meta_shapes(LPIPS), dev, seed, LPIPS_KEY)


def encoder_state(ref_cfg, seed, dev, sapiens: bool):
    from portbench.reference.models.encoders import make_encoder

    return inputs.seeded_state(meta_shapes(
        lambda: make_encoder(ref_cfg, sapiens)), dev, seed, ENC_KEY)


def dit_state(ref_cfg, seed, dev):
    from portbench.reference.models.dit import DiTModel

    return inputs.seeded_state(meta_shapes(lambda: DiTModel(ref_cfg)), dev,
                               seed, DIT_KEY)


def program_body(body, template):
    """The reference's body model and template as the program's types."""
    from sigman_release_torch.body.smplx import SMPLXModel
    from sigman_release_torch.body.template import TemplateAssets

    return SMPLXModel(*body), TemplateAssets(*template)


def adam_grad_norms(opt, params, beta1: float) -> List[float]:
    """The first step's gradient as AdamW got it, per leaf, from its first
    moment: exp_avg / (1 - beta1); 0 for a leaf it holds no moment of."""
    return [float((opt.state[p]["exp_avg"].float() / (1.0 - beta1)).norm())
            if "exp_avg" in opt.state.get(p, {}) else 0.0 for p in params]


def change_norms(params, names, init: Dict[str, torch.Tensor]) -> List[float]:
    return torch.stack([(p.detach().float() - init[n].float()).norm()
                        for p, n in zip(params, names)]).tolist()


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize()


class Capture:
    """Keeps, while on, a copy of what each call of the program's
    ``rasterize_single`` rendered (Gaussians and cameras), and prices the
    launches with the plain renderer's counts."""

    def __init__(self, ref_cfg):
        from sigman_release_torch.ops.rasterizer import render

        self.render, self.ref_cfg = render, ref_cfg
        self.calls: list = []
        self.on = False
        self._orig = render.rasterize_single

        def wrapped(means3d, cov3d, colors, opacity, cam_view, cam_view_proj,
                    *args, **kwargs):
            if self.on:
                self.calls.append(tuple(t.detach().clone() for t in (
                    means3d, cov3d, colors, opacity, cam_view,
                    cam_view_proj)))
            return self._orig(means3d, cov3d, colors, opacity, cam_view,
                              cam_view_proj, *args, **kwargs)

        render.rasterize_single = wrapped

    def bounds_s(self) -> Dict[str, float]:
        import math

        cfg = self.ref_cfg
        total: Dict[str, float] = {}
        for call in self.calls:
            w = plain.work_counts(*call, math.tan(0.5 * cfg.fovx),
                                  math.tan(0.5 * cfg.fovy), cfg.output_size,
                                  cfg.output_size)
            for k, v in launch_bounds_s(w).items():
                total[k] = total.get(k, 0.0) + v
        self.calls = []
        return total

    def close(self):
        self.render.rasterize_single = self._orig
