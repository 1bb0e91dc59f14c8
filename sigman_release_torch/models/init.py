"""The port's seeded weight conventions: every random weight comes from a
``torch.Generator`` seeded with the run's seed plus a fixed offset per
module, so that a trainer, the serving pipeline and the tests build the
same networks from the same seed."""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from sigman_release_torch.models.vae import VAEModel

# std of the Gaussian heads' random init: keeps decoded offsets near zero, so
# a randomly initialised avatar stays on the template body surface
HEAD_INIT_STD = 1e-3


def random_weights_(module: nn.Module, generator: torch.Generator,
                    std: Optional[float] = None) -> nn.Module:
    """Seeded init: linear/conv weights N(0, 1/fan_in) (or ``std``), biases
    0, norm weights 1 — drawn from ``generator`` only."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if p.ndim >= 2:
                fan_in = p[0].numel()
                p.normal_(0.0, std or 1.0 / math.sqrt(fan_in),
                          generator=generator)
            elif leaf == "bias":
                p.zero_()
            else:
                p.fill_(1.0)
    return module


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


def build_on(device, make, generator: torch.Generator) -> nn.Module:
    """``make()`` built on ``device`` without a host copy, with seeded
    random weights (``random_weights_``). The module may hold no buffers:
    they would stay uninitialised."""
    with torch.device("meta"):
        module = make()
    if next(module.buffers(), None) is not None:
        raise ValueError(f"build_on: {type(module).__name__} holds buffers")
    return random_weights_(module.to_empty(device=device), generator)
