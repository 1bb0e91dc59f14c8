"""Precision of the reference: as stated (f32, TF32 off) or the control's,
one step below what the configuration states.

The control's arithmetic: parts stated in bf16 run their linears and
convolutions on fp8 (``to_fp8``: e4m3, one scale per tensor, weights and
inputs rounded, the products summed in f32), parts stated in f32 under bf16
autocast (``part``).
"""

from __future__ import annotations

import contextlib

import torch

FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def strict_f32():
    """Matmuls and convolutions in true f32 (TF32 off)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one scale for the tensor, back in x's dtype;
    the gradient passes unchanged (a cast's backward would round it to
    fp8 unscaled)."""
    with torch.no_grad():
        scale = x.abs().amax().clamp(min=1e-30) / FP8_MAX
        rounded = (x / scale).to(FP8).to(x.dtype) * scale
    return x + (rounded - x).detach()


class _Round(torch.nn.Module):
    def forward(self, w):
        return fp8_round(w)


def _round_input(module, args):
    return (fp8_round(args[0]), *args[1:])


def to_fp8(model: torch.nn.Module) -> torch.nn.Module:
    """Every linear and convolution of ``model`` takes its weight and its
    input rounded to e4m3 (a parametrization and a pre-hook, so that a
    checkpoint's recomputation rounds alike)."""
    from torch.nn.utils import parametrize

    for m in model.modules():
        if isinstance(m, (torch.nn.Linear, torch.nn.Conv1d, torch.nn.Conv2d,
                          torch.nn.Conv3d)):
            parametrize.register_parametrization(m, "weight", _Round())
            m.register_forward_pre_hook(_round_input)
    return model


def part(control: bool, stated: str, device: torch.device):
    """The control's arithmetic for a part whose stated precision is
    ``stated`` ("f32": bf16 autocast); nothing otherwise. Parts stated in
    bf16 take ``to_fp8`` once, when built."""
    if control and stated == "f32":
        return torch.autocast(device.type, dtype=torch.bfloat16)
    return contextlib.nullcontext()
