"""The FLOPs of the FLUX denoiser, closed form from its shapes (a
multiply-add is 2): every linear of the stems, the blocks and the last
layer, and attention's scores and values (4 S^2 d a block), over the joint
sequence of image and condition tokens. Elementwise work (norms, RoPE,
modulation, GELU) is not counted. ``tests/test_torch_flux_flops.py`` holds
it against ``FlopCounterMode`` on the reference model at a small size.
"""

from __future__ import annotations

from portbench import flops
from portbench.reference.models import flux


def forward(p: flux.FluxParams, batch: int, img_tokens: int,
            txt_tokens: int) -> float:
    """One forward of ``batch`` samples."""
    d, m, c = p.hidden_size, int(p.mlp_ratio * p.hidden_size), p.in_channels
    s = img_tokens + txt_tokens
    attn = 2 * 2 * s * s * d
    # per stream: qkv, proj, mlp in and out; modulation once a sample
    double = (2 * s * d * (3 * d + d + 2 * m) + attn
              + 2 * 2 * d * 6 * d)
    single = (2 * s * d * (3 * d + m) + 2 * s * (d + m) * d + attn
              + 2 * d * 3 * d)
    embed = 2 * (256 * d + d * d) * (2 if p.guidance_embed else 1)
    stems = (2 * img_tokens * c * d + 2 * txt_tokens * p.context_in_dim * d
             + embed + 2 * (p.vec_in_dim * d + d * d))
    last = 2 * d * 2 * d + 2 * img_tokens * d * c
    return float(batch * (p.depth * double + p.depth_single_blocks * single
                          + stems + last))


def serve_request(cfg, fields: dict) -> float:
    """One avatar: the conditioning encoder, ``num_inference_steps``
    forwards (one a step, guidance embedded) and the decode."""
    from portbench.reference.models.encoders import make_encoder

    p = flux.params_of(cfg, fields)
    S = cfg.input_size
    side = S // 16
    enc = flops.forward_flops(lambda: make_encoder(cfg, False),
                              flops._meta(1, 3, S, S))
    dec = flops.vae_parts(cfg, 1)["vae_decode"]
    img = (cfg.sample_height // 2) * (cfg.sample_width // 2)
    return float(enc + cfg.num_inference_steps
                 * forward(p, 1, img, side * side) + dec)
