"""Rectified-flow scheduler with resolution-aware timestep shifting (port of
the JAX package's ``diffusion/flow_matching.py``).

The reference ships it as an unused alternative to DDIM; it is kept for
parity. x_t = (1 - t) x0 + t noise; the model predicts the velocity
noise - x0. Timesteps are float32 in (0, 1); ``sample_t`` draws from an
explicit ``torch.Generator``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class FlowScheduler:
    def __init__(self, num_train_timesteps: int = 1000, shift: float = 1.0):
        self.num_train_timesteps = num_train_timesteps
        self.shift = shift

    def shift_t(self, t: torch.Tensor) -> torch.Tensor:
        """Resolution-aware shift s t / (1 + (s - 1) t) of t in (0, 1)."""
        if self.shift == 1.0:
            return t
        return self.shift * t / (1.0 + (self.shift - 1.0) * t)

    def sample_t(self, batch: int, generator: Optional[torch.Generator] = None,
                 logit_mean: float = 0.0, logit_std: float = 1.0,
                 device=None) -> torch.Tensor:
        """Logit-normal timesteps [batch] (``sigmoid`` of a normal draw)."""
        u = torch.randn((batch,), generator=generator, device=device)
        return self.shift_t(torch.sigmoid(u * logit_std + logit_mean))

    def add_noise(self, x0, noise, t):
        t = t.reshape((-1,) + (1,) * (x0.ndim - 1))
        return (1.0 - t) * x0 + t * noise

    def velocity_target(self, x0, noise):
        return noise - x0

    def timesteps(self, num_inference_steps: int) -> torch.Tensor:
        """num_inference_steps shifted times from 1 down to (not incl.) 0."""
        ts = np.linspace(1.0, 0.0, num_inference_steps + 1)[:-1]
        return self.shift_t(torch.as_tensor(ts, dtype=torch.float32))

    def step(self, velocity, t, t_prev, sample):
        """Euler step along the straight path."""
        return sample + (t_prev - t) * velocity
