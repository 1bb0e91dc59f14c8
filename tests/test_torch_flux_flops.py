"""The benchmark's closed-form FLOP count of the FLUX denoiser
(``portbench/flux_flops.py``) against ``FlopCounterMode`` on the reference
model at a small size, and its full-size arithmetic.

This file imports neither JAX nor the JAX package."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import flux_flops
from portbench.reference.config import PRESETS
from portbench.reference.models import flux

FIELDS = {"num_single_layers": 3, "axes_dim": [8, 12, 12],
          "rope_theta": 10000.0, "guidance_embed": True, "vec_in_dim": 24,
          "base_shift": 0.5, "max_shift": 1.15}


@pytest.mark.parametrize("batch, side, cond_side", [(1, 8, 4), (2, 6, 3)])
def test_closed_form_matches_the_flop_counter(batch, side, cond_side):
    """Counted on the meta device, as ``portbench.flops`` counts (the CPU's
    fused attention is not priced by ``FlopCounterMode``)."""
    cfg = PRESETS["test_tiny"].replace(num_attention_heads=2,
                                       attention_head_dim=32, num_layers=2,
                                       text_embed_dim=24)
    p = flux.params_of(cfg, FIELDS)
    meta = torch.device("meta")

    def state_of(name):
        with torch.device(meta):
            return flux.make_part(p, name).state_dict()

    model = flux.BlockwiseFlux(p, state_of, meta)
    lat = torch.empty(batch, cfg.latent_channels, side, side, device=meta)
    cond = torch.empty(batch, 24, cond_side, cond_side, device=meta)
    t = torch.empty(batch, device=meta)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        flux.velocity(model, lat, cond, t, t)
    want = flux_flops.forward(p, batch, (side // 2) ** 2, cond_side ** 2)
    assert counter.get_total_flops() == want


def test_full_size_forward_is_the_sizing_arithmetic():
    """FLUX.1-dev at 1024 image + 1024 condition tokens: 113.25 M MACs a
    token in each of 57 blocks plus attention's 4 S^2 d, 29.4 TFLOP a
    sample a step."""
    cfg = PRESETS["dit"].replace(num_attention_heads=24,
                                 attention_head_dim=128, num_layers=19)
    fields = dict(FIELDS, num_single_layers=38, axes_dim=[16, 56, 56],
                  vec_in_dim=1536)
    p = flux.params_of(cfg, fields)
    total = flux_flops.forward(p, 1, 1024, 1024)
    blocks = 57 * (2 * 113.25e6 * 2048 + 4 * 2048 ** 2 * 3072)
    assert total == pytest.approx(blocks, rel=2e-3)
    assert 29.2e12 < total < 29.6e12
