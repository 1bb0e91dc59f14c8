"""SIGMAN in PyTorch for NVIDIA Hopper (H100).

A port of the JAX/Pallas package beside it (the reference) to PyTorch and
hand-written CUDA. The layout mirrors the JAX package module for
module:

  config.py     Config + PRESETS (own copy)
  geometry/     camera matrices (own numpy copy)
  ops/          rotations, grid sampling, KNN, and the tile rasterizer:
                projection, binning, the dense oracle, the CUDA kernels
                ``forward_tiles`` and ``backward_tiles``
                (``ops/rasterizer/csrc/*.cu``) with their plain PyTorch
                versions, one autograd Function around them
  body/         SMPL-X, LBS, template assets, Gaussian deformer
  models/       VAE (encoder, bottleneck, decoder, heads), DiT, FLUX, ViT
                encoder (Sapiens-1B geometry with learned positions); the
                seeded weight conventions (``models/init.py``)
  diffusion/    DDIM scheduler, the CFG sampling loop, the flow scheduler
  losses/       L1 + LPIPS + KL + hinge GAN, PSNR / SSIM
  data/         synthetic avatar dataset, augmentation, loader
  parallel/     process group and mesh, FSDP, child-process launcher
  renderer.py   GaussianRenderer (KNN base scale -> covariance -> rasterize)
  avatar.py     LatentRenderer (decode -> deform -> render), shared by the
                trainers and the serving pipeline
  training/     VAETrainer (G/D steps, AdamW), DiTTrainer (frozen VAE and
                encoder, v prediction, warmup-cosine AdamW), the fit loop
                and clip they share (``loop.py``), state files, the
                multi-rank cases held against one process (``cases.py``)
  convert.py    Flax parameter trees -> this package's state_dicts; Sapiens
                weights -> the conditioning encoder
  inference.py  image -> avatar entry point (``python -m
                sigman_release_torch.inference``)
  train_vae.py  VAE training entry point (``python -m
                sigman_release_torch.train_vae``)
  train_dit.py  DiT training entry point (``python -m
                sigman_release_torch.train_dit``)

The package imports neither JAX nor anything of the JAX package.
Entry points run on CUDA unless the caller passes ``device="cpu"``; they
raise when CUDA is requested and missing. CUDA kernels build with ``nvcc`` at
first use into ``build/kernels/`` (git-ignored); a CUDA tensor always goes
through its kernel, a CPU tensor through the kernel's plain version.
"""

from sigman_release_torch.config import PRESETS, Config  # noqa: F401
from sigman_release_torch.device import resolve_device  # noqa: F401
