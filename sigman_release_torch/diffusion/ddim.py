"""CogVideoX-style DDIM scheduler (port of
the JAX package's ``diffusion/ddim.py``): v-prediction, zero-terminal-SNR
rescale, trailing spacing.

* scaled_linear betas: ``linspace(sqrt(b0), sqrt(b1), T)^2``,
* optional SNR shift: ``a' = a / (s - (s-1) a)``,
* zero-terminal-SNR rescale of ``sqrt(alphas_cumprod)``,
* "trailing" inference timesteps: ``round(arange(T, 0, -T/n)) - 1``,
* deterministic DDIM step (eta = 0) with ``set_alpha_to_one``,
* the training side: ``add_noise`` (q(x_t | x_0)), the v target and the
  DiT trainer's loss weights ``1 / (1 - abar_t)``.

The tables are built in float64 numpy and kept as float32 tensors; the step
and the training side compute in float32.
"""

from __future__ import annotations

import numpy as np
import torch


def _rescale_zero_terminal_snr(alphas_cumprod: np.ndarray) -> np.ndarray:
    """Shift+scale sqrt(abar) so the final timestep has zero SNR."""
    s = np.sqrt(alphas_cumprod)
    s0 = s[0].copy()
    sT = s[-1].copy()
    s = s - sT                        # terminal -> 0
    s = s * s0 / (s0 - sT)            # keep first value
    return s ** 2


class DDIMScheduler:
    def __init__(
        self,
        num_train_timesteps: int = 1000,
        beta_start: float = 0.00085,
        beta_end: float = 0.012,
        beta_schedule: str = "scaled_linear",
        prediction_type: str = "v_prediction",
        rescale_betas_zero_snr: bool = True,
        snr_shift_scale: float = 1.0,
        timestep_spacing: str = "trailing",
        set_alpha_to_one: bool = True,
        steps_offset: int = 0,
        device=None,
    ):
        self.num_train_timesteps = num_train_timesteps
        self.prediction_type = prediction_type
        self.timestep_spacing = timestep_spacing
        self.steps_offset = steps_offset

        if beta_schedule == "scaled_linear":
            betas = np.linspace(beta_start ** 0.5, beta_end ** 0.5,
                                num_train_timesteps) ** 2
        elif beta_schedule == "linear":
            betas = np.linspace(beta_start, beta_end, num_train_timesteps)
        else:
            raise ValueError(beta_schedule)
        alphas_cumprod = np.cumprod(1.0 - betas)

        if snr_shift_scale != 1.0:
            alphas_cumprod = alphas_cumprod / (
                snr_shift_scale - (snr_shift_scale - 1.0) * alphas_cumprod)
        if rescale_betas_zero_snr:
            alphas_cumprod = _rescale_zero_terminal_snr(alphas_cumprod)

        self.alphas_cumprod = torch.as_tensor(
            alphas_cumprod.astype(np.float32), device=device)
        self.final_alpha_cumprod = torch.tensor(
            1.0 if set_alpha_to_one else float(alphas_cumprod[0]),
            dtype=torch.float32, device=device)
        self.init_noise_sigma = 1.0

    @classmethod
    def from_config(cls, cfg, device=None) -> "DDIMScheduler":
        return cls(
            num_train_timesteps=cfg.num_train_timesteps,
            beta_start=cfg.beta_start,
            beta_end=cfg.beta_end,
            beta_schedule=cfg.beta_schedule,
            prediction_type=cfg.prediction_type,
            rescale_betas_zero_snr=cfg.rescale_betas_zero_snr,
            snr_shift_scale=cfg.snr_shift_scale,
            timestep_spacing=cfg.timestep_spacing,
            device=device,
        )

    # ---- training ----------------------------------------------------------

    def _abar(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        """abar_t for int timesteps [B], shaped [B, 1, ...] to ``ndim``."""
        a = self.alphas_cumprod.to(t.device)[t]
        return a.reshape((-1,) + (1,) * (ndim - 1))

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor,
                  t: torch.Tensor) -> torch.Tensor:
        """q(x_t | x_0): sqrt(abar_t) x0 + sqrt(1 - abar_t) noise; t [B] int."""
        a = self._abar(t, x0.ndim)
        return torch.sqrt(a) * x0 + torch.sqrt(1.0 - a) * noise

    def get_velocity(self, x0: torch.Tensor, noise: torch.Tensor,
                     t: torch.Tensor) -> torch.Tensor:
        """v target: sqrt(abar_t) noise - sqrt(1 - abar_t) x0."""
        a = self._abar(t, x0.ndim)
        return torch.sqrt(a) * noise - torch.sqrt(1.0 - a) * x0

    def snr_weights(self, t: torch.Tensor) -> torch.Tensor:
        """The DiT trainer's loss weights 1 / (1 - abar_t), [B] f32 (1 at
        the zero-SNR last step, ~1.2e3 at t = 0)."""
        return 1.0 / (1.0 - self.alphas_cumprod.to(t.device)[t])

    # ---- sampling ----------------------------------------------------------

    def timesteps(self, num_inference_steps: int) -> list:
        """The inference timesteps, high to low, as Python ints."""
        T = self.num_train_timesteps
        if self.timestep_spacing == "trailing":
            ts = np.round(np.arange(T, 0, -T / num_inference_steps)).astype(
                np.int64) - 1
        elif self.timestep_spacing == "leading":
            step = T // num_inference_steps
            ts = (np.arange(num_inference_steps) * step).round()[::-1].astype(
                np.int64) + self.steps_offset
        else:  # linspace
            ts = np.linspace(0, T - 1, num_inference_steps).round()[::-1]
            ts = ts.astype(np.int64)
        return [int(t) for t in ts]

    def step(self, model_output: torch.Tensor, t: int, t_prev: int,
             sample: torch.Tensor) -> torch.Tensor:
        """Deterministic DDIM update x_t -> x_{t_prev} (t_prev < 0 selects
        ``final_alpha_cumprod``)."""
        a_t = self.alphas_cumprod[t]
        a_prev = (self.alphas_cumprod[t_prev] if t_prev >= 0
                  else self.final_alpha_cumprod)
        sqrt_a = torch.sqrt(a_t)
        sqrt_1ma = torch.sqrt(1.0 - a_t)
        if self.prediction_type == "v_prediction":
            x0 = sqrt_a * sample - sqrt_1ma * model_output
            eps = sqrt_a * model_output + sqrt_1ma * sample
        elif self.prediction_type == "epsilon":
            x0 = (sample - sqrt_1ma * model_output) / sqrt_a
            eps = model_output
        else:  # "sample"
            x0 = model_output
            eps = (sample - sqrt_a * x0) / sqrt_1ma
        return torch.sqrt(a_prev) * x0 + torch.sqrt(1.0 - a_prev) * eps
