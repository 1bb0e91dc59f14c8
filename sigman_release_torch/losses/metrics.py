"""Quality metrics: PSNR, masked PSNR, SSIM (port of the JAX package's
``losses/metrics.py``; SSIM with an 11-tap sigma-1.5 Gaussian window as a
depthwise valid convolution)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def psnr(pred: torch.Tensor, gt: torch.Tensor) -> torch.Tensor:
    """-10 log10(mean (pred-gt)^2); inputs in [0,1]."""
    mse = torch.mean((pred - gt) ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def masked_psnr(pred, gt, mask):
    """10 log10(max^2 / mse) over masked pixels (reference convention)."""
    mse = torch.mean((pred * mask - gt * mask) ** 2)
    max_val = torch.max(pred * mask)
    return 10.0 * torch.log10(torch.clamp(max_val ** 2, min=1e-12)
                              / torch.clamp(mse, min=1e-12))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size) - size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    g = g / g.sum()
    return np.outer(g, g).astype(np.float32)


def ssim(img1: torch.Tensor, img2: torch.Tensor,
         window_size: int = 11) -> torch.Tensor:
    """Mean SSIM. img [C,H,W] or [B,C,H,W] in [0,1]."""
    if img1.ndim == 3:
        img1, img2 = img1[None], img2[None]
    c = img1.shape[1]
    win = torch.from_numpy(_gaussian_window(window_size)).to(img1)
    kernel = win[None, None].expand(c, 1, window_size, window_size)

    def filt(x):
        return F.conv2d(x, kernel, groups=c)

    mu1, mu2 = filt(img1), filt(img2)
    mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = filt(img1 * img1) - mu1_sq
    s2 = filt(img2 * img2) - mu2_sq
    s12 = filt(img1 * img2) - mu12
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / (
        (mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return torch.mean(ssim_map)
