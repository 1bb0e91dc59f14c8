"""FLUX.1's sampling schedule and Euler loop in plain PyTorch (from
black-forest-labs/flux ``src/flux/sampling.py``: ``time_shift``,
``get_lin_function``, ``get_schedule``, ``denoise``): the benchmark's
reference for the port's ``FlowSamplePipeline``.

Departure from BFL's code: the loop runs in f32 on the f32 reference model
(BFL casts the image and the timesteps to the model's dtype).
"""

from __future__ import annotations

import math
from typing import Callable, List

import torch


def time_shift(mu: float, sigma: float, t: torch.Tensor) -> torch.Tensor:
    return math.exp(mu) / (math.exp(mu) + (1 / t - 1) ** sigma)


def get_lin_function(x1: float = 256, y1: float = 0.5, x2: float = 4096,
                     y2: float = 1.15) -> Callable[[float], float]:
    m = (y2 - y1) / (x2 - x1)
    b = y1 - m * x1
    return lambda x: m * x + b


def get_schedule(num_steps: int, image_seq_len: int, base_shift: float = 0.5,
                 max_shift: float = 1.15, shift: bool = True) -> List[float]:
    timesteps = torch.linspace(1, 0, num_steps + 1)
    if shift:
        mu = get_lin_function(y1=base_shift, y2=max_shift)(image_seq_len)
        timesteps = time_shift(mu, 1.0, timesteps)
    return timesteps.tolist()


@torch.no_grad()
def denoise(velocity: Callable, img: torch.Tensor, timesteps: List[float],
            guidance: float) -> torch.Tensor:
    """``velocity(img, t [B], guidance [B])``; Euler steps
    ``img + (t_prev - t_curr) pred``."""
    b = img.shape[0]
    guidance_vec = torch.full((b,), guidance, device=img.device,
                              dtype=img.dtype)
    for t_curr, t_prev in zip(timesteps[:-1], timesteps[1:]):
        t_vec = torch.full((b,), t_curr, dtype=img.dtype, device=img.device)
        pred = velocity(img, t_vec, guidance_vec)
        img = img + (t_prev - t_curr) * pred
    return img
