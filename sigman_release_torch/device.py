"""Device selection for the port's entry points: CUDA unless asked otherwise."""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = "cuda") -> torch.device:
    """Return the device to run on; raise if CUDA is requested and missing.

    ``None`` means CUDA. There is no silent CPU fallback: a caller that
    wants the CPU passes ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    return dev
