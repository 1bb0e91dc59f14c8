"""FLUX.1's double- and single-stream transformer as the port's second
denoiser (``models/flux.py``, ``diffusion/pipeline.FlowSamplePipeline``,
``AvatarPipeline`` at ``denoiser="flux"``), held against the benchmark's
plain reference (``portbench/reference/models/flux.py``,
``portbench/reference/diffusion/flow.py``) on seeded weights at a small
size: hidden 64 = 2 heads x 32, ``axes_dim`` (8, 12, 12), 2 double and 2
single blocks, an 8 x 8 latent. Everything runs in f32 on the CPU.

This file imports neither JAX nor the JAX package."""

import pytest
import torch

from portbench.reference.diffusion import flow as ref_flow
from portbench.reference.models import flux as ref_flux
from sigman_release_torch.config import PRESETS
from sigman_release_torch.diffusion.pipeline import (
    FlowSamplePipeline,
    flow_shift_mu,
)
from sigman_release_torch.inference import AvatarPipeline, orbit_rig
from sigman_release_torch.models import flux
from sigman_release_torch.utils.timing import StageTimer

CFG = PRESETS["test_tiny"].replace(
    denoiser="flux", num_attention_heads=2, attention_head_dim=32,
    num_layers=2, num_single_layers=2, axes_dim=(8, 12, 12), vec_in_dim=32,
    num_inference_steps=3, guidance_scale=3.5)
FIELDS = {"num_single_layers": 2, "axes_dim": [8, 12, 12],
          "rope_theta": 10000.0, "guidance_embed": True, "vec_in_dim": 32,
          "base_shift": 0.5, "max_shift": 1.15}
# f32 on both sides, the same products in another grouping (the RoPE as
# 2 x 2 matrices against pairs, heads-first against heads-last layouts):
# rounding alone, a few ulps of the largest value
FWD_RTOL = 1e-5
# three Euler steps compound the forward's rounding through the latent
LOOP_RTOL = 1e-5


def seeded_model(seed=0) -> flux.FluxModel:
    """Random weights large enough that every block moves the stream
    (biases and norm scales drawn too, so a swapped term shows)."""
    model = flux.FluxModel(CFG).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in model.parameters():
            p.copy_(torch.randn(p.shape, generator=g)
                    * (0.3 if p.ndim >= 2 else 0.2))
    return model


def reference_of(model) -> ref_flux.BlockwiseFlux:
    """The reference built part by part from the model's weights."""
    sd = model.state_dict()

    def state_of(name):
        if name == "stems":
            return {k: v.clone() for k, v in sd.items()
                    if not k.startswith(("double_blocks", "single_blocks"))}
        return {k[len(name) + 1:]: v.clone() for k, v in sd.items()
                if k.startswith(name + ".")}

    return ref_flux.BlockwiseFlux(ref_flux.params_of(CFG, FIELDS), state_of,
                                  torch.device("cpu"))


def inputs(batch=2, seed=1):
    g = torch.Generator().manual_seed(seed)
    side = CFG.input_size // 16
    return (torch.randn(batch, CFG.latent_channels, 8, 8, generator=g),
            torch.randn(batch, CFG.text_embed_dim, side, side, generator=g),
            torch.rand(batch, generator=g),
            torch.full((batch,), CFG.guidance_scale))


def rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_forward_matches_the_reference():
    model = seeded_model()
    lat, cond, t, g = inputs()
    with torch.no_grad():
        got = model(lat, cond, t, g)
        want = ref_flux.velocity(reference_of(model), lat, cond, t, g)
    assert got.shape == lat.shape
    assert rel(got, want) <= FWD_RTOL


def test_forward_depends_on_guidance_and_time():
    model = seeded_model()
    lat, cond, t, g = inputs()
    with torch.no_grad():
        base = model(lat, cond, t, g)
        assert rel(model(lat, cond, t, g + 1.0), base) > 1e-3
        assert rel(model(lat, cond, t * 0.5, g), base) > 1e-3


def test_three_step_sampling_loop_matches_the_reference():
    model = seeded_model()
    lat, cond, _, _ = inputs()
    sampler = FlowSamplePipeline(CFG)
    got = sampler.sample_latents(model, cond, noise=lat,
                                 num_inference_steps=3, guidance_scale=3.5)
    ref = reference_of(model)
    tokens = (CFG.sample_height // 2) * (CFG.sample_width // 2)
    ts = ref_flow.get_schedule(3, tokens, 0.5, 1.15)
    with torch.no_grad():
        want = ref_flow.denoise(
            lambda x, t, g: ref_flux.velocity(ref, x, cond, t, g), lat, ts,
            3.5) / CFG.vae_scaling_factor
    assert rel(got, want) <= LOOP_RTOL


def test_schedule_is_get_schedule_at_1024_tokens():
    cfg = PRESETS["flux1_dev"]
    assert cfg.num_patches == 1024
    assert flow_shift_mu(cfg, 1024) == pytest.approx(0.63, abs=1e-12)
    got = FlowSamplePipeline(cfg).times(28)
    want = ref_flow.get_schedule(28, 1024, 0.5, 1.15)
    assert len(got) == 29 and got[0] == 1.0 and got[-1] == 0.0
    # f32 shift on an f64 linspace against BFL's f32 linspace: one ulp
    assert max(abs(a - b) for a, b in zip(got, want)) <= 3e-7


def test_rope_ids_of_both_streams():
    ids = flux.rope_ids(1, 3, 4)
    assert ids.shape == (12, 3)
    assert torch.all(ids[:, 0] == 1)
    assert ids[:, 1].tolist() == [r for r in range(3) for _ in range(4)]
    assert ids[:, 2].tolist() == list(range(4)) * 3
    assert torch.all(flux.rope_ids(0, 2, 2)[:, 0] == 0)

    model = seeded_model()
    cos, sin = model.rope((4, 4), (4, 4), torch.device("cpu"))
    assert model.rope((4, 4), (4, 4), torch.device("cpu"))[0] is cos
    # the reference's rotation matrices of (1, r, c) then (0, r, c)
    txt = ref_flux.grid_ids(1.0, 4, 4, 1, "cpu")
    img = ref_flux.grid_ids(0.0, 4, 4, 1, "cpu")
    pe = ref_flux.EmbedND(1e4, CFG.axes_dim)(torch.cat([txt, img], 1))[0, 0]
    assert torch.allclose(cos[:, 0::2], pe[..., 0, 0], atol=1e-6)
    assert torch.allclose(sin[:, 0::2], pe[..., 1, 0], atol=1e-6)
    assert torch.equal(cos[:, 0::2], cos[:, 1::2])
    # condition token (row 2, col 3) rotates axis 0 by its id 1
    k = 2 * 4 + 3
    assert cos[k, 0].item() == pytest.approx(torch.cos(torch.tensor(1.0)))


def test_spans_of_one_forward():
    model = seeded_model()
    lat, cond, t, g = inputs()
    timer = StageTimer(torch.device("cpu"))
    with torch.no_grad():
        model(lat, cond, t, g, timer=timer)
    assert timer.counts == {"flux_embed": 1, "flux_double": CFG.num_layers,
                            "flux_single": CFG.num_single_layers}
    timer = StageTimer(torch.device("cpu"))
    FlowSamplePipeline(CFG).sample_latents(model, cond, noise=lat,
                                           num_inference_steps=3,
                                           timer=timer)
    assert timer.counts["flux_double"] == 3 * CFG.num_layers
    assert timer.counts["flux_single"] == 3 * CFG.num_single_layers
    assert timer.counts["flow_update"] == 3


def test_flux1_dev_preset_has_the_published_widths():
    cfg = PRESETS["flux1_dev"]
    assert (cfg.hidden_dim, cfg.num_attention_heads, cfg.attention_head_dim,
            cfg.num_layers, cfg.num_single_layers) == (3072, 24, 128, 19, 38)
    with torch.device("meta"):
        model = flux.FluxModel(cfg)
    assert model.img_in.in_features == 64
    assert sum(p.numel() for p in model.parameters()) == 11_895_903_296


def test_avatar_pipeline_serves_with_the_flux_denoiser():
    pipe = AvatarPipeline(CFG, device="cpu", seed=3)
    assert isinstance(pipe.dit, flux.FluxModel)
    assert isinstance(pipe.sampler, FlowSamplePipeline)
    image = torch.randn(1, 3, CFG.input_size, CFG.input_size)
    noise = torch.randn(1, CFG.latent_channels, 8, 8,
                        generator=torch.Generator().manual_seed(4))
    cv, cvp = (torch.from_numpy(a) for a in orbit_rig(CFG, 2))
    timer = StageTimer(torch.device("cpu"))
    out = pipe(image, None, cv, cvp, noise=noise, timer=timer)
    assert out["render"]["image"].shape == (1, 2, 3, CFG.output_size,
                                            CFG.output_size)
    assert torch.isfinite(out["render"]["image"]).all()
    assert timer.counts["flux_double"] == \
        CFG.num_inference_steps * CFG.num_layers
    # the pipeline's latents are the reference loop's on its weights
    with torch.no_grad():
        cond = pipe.encoder(image)
    ref = reference_of(pipe.dit)
    ts = ref_flow.get_schedule(CFG.num_inference_steps, 16, 0.5, 1.15)
    with torch.no_grad():
        want = ref_flow.denoise(
            lambda x, t, g: ref_flux.velocity(ref, x, cond, t, g), noise,
            ts, CFG.guidance_scale) / CFG.vae_scaling_factor
    assert rel(out["latents"], want) <= LOOP_RTOL


def test_avatar_pipeline_builds_flux_in_bf16():
    pipe = AvatarPipeline(CFG.replace(mixed_precision="bf16"), device="cpu")
    assert {p.dtype for p in pipe.dit.parameters()} == {torch.bfloat16}


def test_unknown_denoiser_is_refused():
    with pytest.raises(ValueError, match="denoiser"):
        AvatarPipeline(CFG.replace(denoiser="unet"), device="cpu")


def test_dit_trainer_refuses_a_flux_config():
    from sigman_release_torch.training.dit_trainer import DiTTrainer

    with pytest.raises(ValueError, match="flux"):
        DiTTrainer(CFG, torch.nn.Identity(), torch.nn.Identity(),
                   device="cpu")
