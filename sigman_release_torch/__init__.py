"""SIGMAN in PyTorch for NVIDIA Hopper (H100).

A port of the JAX/Pallas package beside it (the reference) to PyTorch and
hand-written CUDA. The layout mirrors the JAX package module for
module:

  config.py     Config + PRESETS (own copy)
  geometry/     camera matrices (own numpy copy)
  ops/          rotations, grid sampling, KNN, and the tile rasterizer:
                projection, binning, the CUDA ``forward_tiles`` kernel
                (``ops/rasterizer/csrc/forward_tiles.cu``) and its plain
                PyTorch version
  body/         SMPL-X, LBS, template assets, Gaussian deformer
  models/       VAE decoder + Gaussian heads, DiT, ViT conditioning encoder
  diffusion/    DDIM scheduler and the CFG sampling loop
  renderer.py   GaussianRenderer (KNN base scale -> covariance -> rasterize)
  convert.py    Flax parameter trees -> this package's state_dicts
  inference.py  image -> avatar entry point (``python -m
                sigman_release_torch.inference``)

The package imports neither JAX nor anything of the JAX package.
Entry points run on CUDA unless the caller passes ``device="cpu"``; they
raise when CUDA is requested and missing. CUDA kernels build with ``nvcc`` at
first use into ``build/kernels/`` (git-ignored); a CUDA tensor always goes
through its kernel, a CPU tensor through the kernel's plain version.
"""

from sigman_release_torch.config import PRESETS, Config  # noqa: F401
from sigman_release_torch.device import resolve_device  # noqa: F401
