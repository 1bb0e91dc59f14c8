"""Configuration: the ``Config`` dataclass and named ``PRESETS``.

An own copy of the JAX package's ``config.py`` (the port imports nothing of
the JAX package). Field semantics follow the reference presets: ``vae_b``
(input 512, 10 views / 6 input) and ``dit`` (d=2048, 30 layers, latent
16x64x64, patch 2); ``test_tiny`` is the small configuration the tests use.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class Config:
    # ---- model / image sizes -------------------------------------------------
    # NOTE: the reference also defines splat_size / lambda_face /
    # scale_modifier (inert: cov3D_precomp bypasses it in the CUDA path),
    # condition_mode, timestep_activation_fn, max_text_seq_length and
    # bottleneck_dim, but none is read anywhere in its code (dead config) —
    # deliberately not carried. Every field below has >=1 read site.
    input_size: int = 512           # encoder input resolution (H == W)
    output_size: int = 512          # render / supervision resolution
    latent_channels: int = 16       # VAE latent channels (16 x 64 x 64 latent)
    vae_out_channels: int = 64      # decoder UV feature channels
    self_attention_layers: int = 6  # bottleneck self-attn depth
    vae_attention_heads: int = 8    # bottleneck attention (reference: 8 x 64)
    vae_attention_head_dim: int = 64
    # bottleneck attention dropout, train-mode only (reference trains its
    # VAE_CrossAttention stack with 0.1 — autoencoder.py:119)
    attn_dropout: float = 0.1
    encoder_channels: Tuple[int, ...] = (128, 256, 256, 512)
    decoder_channels: Tuple[int, ...] = (256, 512, 512, 1024)
    uv_query_size: int = 64         # learned UV-query grid (64x64 tokens)

    # ---- DiT -----------------------------------------------------------------
    num_attention_heads: int = 32
    attention_head_dim: int = 64    # d_model = 32 * 64 = 2048
    num_layers: int = 30
    patch_size: int = 2
    sample_height: int = 64         # latent spatial dims
    sample_width: int = 64
    in_channels: int = 16
    out_channels: int = 16
    text_embed_dim: int = 1536      # Sapiens feature channels
    time_embed_dim: int = 512
    vae_scaling_factor: float = 0.6909025648433997
    use_rotary_positional_embeddings: bool = True
    noised_condition_dropout: float = 0.05

    # ---- denoiser kind -------------------------------------------------------
    # "dit": the CogVideoX-style DiTModel under the CFG DDIM sampler;
    # "flux": FLUX.1's double- and single-stream FluxModel under the flow
    # Euler sampler with embedded guidance. For "flux" the DiT fields above
    # keep their meaning: heads x head_dim, num_layers double blocks,
    # text_embed_dim the condition tokens' width (FLUX's context_in_dim),
    # num_inference_steps and guidance_scale (embedded, one forward a step).
    denoiser: str = "dit"
    num_single_layers: int = 38     # FLUX single-stream blocks
    axes_dim: Tuple[int, ...] = (16, 56, 56)   # RoPE dims per id axis
    rope_theta: float = 10000.0
    guidance_embed: bool = True
    vec_in_dim: int = 1536          # pooled condition (FLUX's CLIP vector)
    base_shift: float = 0.5         # resolution shift mu at 256 tokens
    max_shift: float = 1.15         # ... and at 4096 tokens

    # ---- cameras / rendering -------------------------------------------------
    fovy: float = 0.8712626851529752
    fovx: float = 0.8712626851529752
    znear: float = 0.1
    zfar: float = 100.0
    cam_radius: float = 1.5
    num_views: int = 10
    num_input_views: int = 6
    max_tiles_per_gaussian: int = 36
    # Renderer pair capacity: budget = factor * N * V; big_win is the top-K
    # fallback window side (> sqrt(max_tiles_per_gaussian) to be active).
    # DEFAULT CHANGED round 5 (5/6 -> 12/12): at the untrained-splat
    # operating point the 5/6 capacity drops ~2M pairs/step with gradient
    # cosine 0.437 vs the widened point, and the committed default-capacity
    # overfit run collapsed to the empty-render attractor at step ~240 and
    # never recovered, while the identically-seeded widened run finished at
    # PSNR 14.9 / SSIM 0.91 with overflow decayed 525k -> 0 by step ~150
    # (CAPACITY_r05.json, TRAJ_r05.json). Steady-state drops at 12/12 are
    # ZERO; the cost is ~10-15% G-step time while splats are still large.
    # Tighten back per-run once the overflow log reads ~0 if the step time
    # matters more than early-phase exactness.
    pair_budget_factor: int = 12
    render_big_win: int = 12

    # ---- diffusion sampling --------------------------------------------------
    num_train_timesteps: int = 1000
    num_inference_steps: int = 30
    guidance_scale: float = 3.5
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "scaled_linear"
    prediction_type: str = "v_prediction"
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"
    snr_shift_scale: float = 1.0

    # ---- losses --------------------------------------------------------------
    lambda_lpips: float = 1.0
    lpips_size: int = 256        # LPIPS input resize (whole_loss.py:130-140)
    # eval metric backbone: the reference evaluates with LPIPS-alex
    # (core/loss/eval.py:72) while the LOSS uses vgg; "vgg" here reuses the
    # loss net (one set of converted weights), "alex" matches the reference
    # eval exactly once converted alexnet weights are supplied
    eval_lpips_net: str = "vgg"
    lambda_kl: float = 1e-6
    disc_factor: float = 1.0
    disc_weight: float = 1000.0
    disc_start: int = 50_000_000

    # ---- training ------------------------------------------------------------
    workspace: str = "./workspace"
    resume: Optional[str] = None
    batch_size: int = 1
    gradient_accumulation_steps: int = 1
    num_epochs: int = 100
    gradient_clip: float = 1.0
    lr: float = 3e-6
    lr_scheduler: str = "cosine"
    lr_warmup_steps: int = 2000
    mixed_precision: str = "bf16"
    gradient_checkpointing: bool = True
    # VAE conv-stack remat: "block" (per-resnet full remat — reference
    # gradient_checkpointing semantics), "conv" (save conv outputs,
    # recompute only GN/SiLU — skips the conv recompute for ~3x the saved
    # activation bytes; OOMs 16 GB by ~80 MB at vae_b B=1 V=10),
    # "conv_enc" (conv on the 3D encoder / block on the 2D decoder — the
    # single-chip sweet spot, A/B'd in BENCH_r05_train.json),
    # "none" (OOMs 16 GB at vae_b 512^2)
    remat_policy: str = "block"
    seed: int = 0
    save_ckpt_steps: int = 200
    eval_steps: int = 3000
    log_every: int = 10

    # ---- data ----------------------------------------------------------------
    train_list: str = "./data/train_VAE.npy"
    num_workers: int = 8
    prob_grid_distortion: float = 0.5
    prob_cam_jitter: float = 0.5
    synthetic_data: bool = False    # procedural fixture data (no HGS-1M needed)
    synthetic_items: int = 8

    # ---- assets --------------------------------------------------------------
    template_dir: str = "./assets/template"
    smplx_model_path: Optional[str] = None   # SMPLX_NEUTRAL.npz etc.
    vae_path: str = "./ckpt/autoencoder/autoencoder.safetensors"
    sapiens_path: str = ""  # converted Sapiens encoder (convert_sapiens.py)

    # ---- parallelism ---------------------------------------------------------
    # mesh (-1: all devices on the axis). A second 'view' axis shards the
    # RENDER VIEWS (rays/tiles) across chips — Gaussians replicated, each
    # shard rasterizes its views, grads pmean over both axes; e.g.
    # mesh_shape=(-1, 2), mesh_axes=("data", "view").
    mesh_shape: Tuple[int, ...] = (-1,)
    mesh_axes: Tuple[str, ...] = ("data",)
    # SPMD mode: "shard_map" (explicit-pmean DP, the Pallas-friendly
    # default) or "fsdp" (GSPMD with params+optimizer sharded over 'data' —
    # DiT only; the renderer graph must stay under shard_map)
    spmd: str = "shard_map"
    profile_dir: str = ""           # torch.profiler traces (every profile_every)
    profile_every: int = 500

    @property
    def hidden_dim(self) -> int:
        return self.num_attention_heads * self.attention_head_dim

    @property
    def num_patches(self) -> int:
        return (self.sample_height // self.patch_size) * (
            self.sample_width // self.patch_size
        )

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)


# ---- named presets (mirror the reference's subcommands) ----------------------

PRESETS = {
    "vae_s": Config(input_size=256, output_size=512, num_views=8,
                    num_input_views=4, num_epochs=250),
    "vae_b": Config(input_size=512, output_size=512, num_views=10,
                    num_input_views=6, num_epochs=100),
    "dit": Config(input_size=512, output_size=512, num_views=10,
                  num_input_views=6, num_epochs=100, batch_size=8, lr=1e-4),
    # FLUX.1-dev's transformer (black-forest-labs/flux util.py
    # configs["flux-dev"]) as the denoiser over the dit preset's latent:
    # 3072 = 24 x 128, 19 double + 38 single blocks, 28 Euler steps at
    # embedded guidance 3.5
    "flux1_dev": Config(input_size=512, output_size=512, num_views=10,
                        num_input_views=6, num_epochs=100, batch_size=4,
                        denoiser="flux", num_attention_heads=24,
                        attention_head_dim=128, num_layers=19,
                        num_single_layers=38, num_inference_steps=28,
                        guidance_scale=3.5),
    # small configs for tests / CI — not in the reference
    "test_tiny": Config(input_size=64, output_size=32,
                        lpips_size=64, num_views=3,
                        num_input_views=2, latent_channels=4, vae_out_channels=16,
                        self_attention_layers=1, encoder_channels=(8, 16, 16, 32),
                        decoder_channels=(8, 16, 16, 32),
                        uv_query_size=8, num_attention_heads=2,
                        vae_attention_heads=2, vae_attention_head_dim=8,
                        attention_head_dim=16, num_layers=2, sample_height=8,
                        sample_width=8, in_channels=4, out_channels=4,
                        text_embed_dim=32, time_embed_dim=32,
                        batch_size=1, synthetic_data=True,
                        mixed_precision="no"),
}


def parse_cli(argv: Optional[list] = None, default_preset: str = "vae_b",
              device: str = "cuda") -> Tuple[Config, str]:
    """``prog [preset] --flag value ... [--device d]`` -> (Config, device)
    (the reference CLI's shape, ``train_vae.py vae_b --batch_size 8``).
    Values are parsed with the field's type; ``--device`` defaults to
    ``device``."""
    import sys

    argv = list(sys.argv[1:] if argv is None else argv)
    preset = default_preset
    if argv and not argv[0].startswith("-"):
        preset = argv.pop(0)
    if preset not in PRESETS:
        raise SystemExit(f"unknown preset {preset!r}; choose from "
                         f"{sorted(PRESETS)}")
    cfg = PRESETS[preset]
    fields = {f.name: f for f in dataclasses.fields(Config)}
    overrides = {}
    for i in range(0, len(argv), 2):
        arg = argv[i]
        if not arg.startswith("--"):
            raise SystemExit(f"unexpected argument {arg!r}")
        name = arg[2:].replace("-", "_")
        if name != "device" and name not in fields:
            raise SystemExit(f"unknown flag --{name}")
        if i + 1 >= len(argv):
            raise SystemExit(f"--{name} needs a value")
        raw = argv[i + 1]
        if name == "device":
            device = raw
        else:
            overrides[name] = _coerce(raw, fields[name].type,
                                      getattr(cfg, name))
    return cfg.replace(**overrides), device


def _coerce(raw: str, annot, current):
    if isinstance(current, bool) or annot in ("bool", bool):
        return raw.lower() in ("1", "true", "yes", "on")
    if isinstance(current, int) and not isinstance(current, bool):
        return int(raw)
    if isinstance(current, float):
        return float(raw)
    if isinstance(current, tuple):
        elem = type(current[0]) if current else int
        return tuple(elem(x) for x in raw.strip("()").split(","))
    return raw
