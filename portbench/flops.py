"""The FLOPs each cell's work requires, counted from the shapes.

``FlopCounterMode`` counts the matmuls, convolutions and attention of the
frozen reference networks' forward on the meta device (no data, no
device). A step is priced as: trained modules x3 (forward and backward),
frozen modules on the gradient's path x2 (LPIPS on the prediction),
frozen modules off it x1, recomputation never. Neither the renderer, the
KNN nor elementwise work is counted. A change to the program's remat or
work cannot move these counts.

``dit_step_flops`` is a frozen copy of ``dit_trainer.step_flops`` at commit
a519890 (the DiT alone, from its shapes); ``tests`` hold the meta count
against it.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch
from torch.utils.flop_counter import FlopCounterMode

META = torch.device("meta")


def forward_flops(make, *inputs) -> int:
    with torch.device(META):
        module = make()
    module = module.to(META)
    with torch.no_grad(), FlopCounterMode(display=False) as counter:
        module(*inputs)
    return counter.get_total_flops()


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, device=META, dtype=dtype)


def vae_parts(cfg, batch: int) -> Dict[str, int]:
    from portbench.reference.losses.lpips import LPIPS
    from portbench.reference.models.vae import VAEModel

    S, V, Vin = cfg.input_size, cfg.num_views, cfg.num_input_views

    class Encode(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.vae = VAEModel(cfg)

        def forward(self, x, uv):
            return self.vae.encode(x, uv)

    class Decode(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.vae = VAEModel(cfg, with_encoder=False)

        def forward(self, z):
            return self.vae.decode(z)

    q, L = cfg.uv_query_size, cfg.lpips_size
    return {
        "vae_encode": forward_flops(Encode, _meta(batch, Vin, 9, S, S),
                                    _meta(batch, 3, S, S)),
        "vae_decode": forward_flops(Decode,
                                    _meta(batch, q, q, cfg.latent_channels)),
        # one LPIPS backbone pass over B x V images at the LPIPS size
        "lpips_side": forward_flops(lambda: LPIPS().vgg,
                                    _meta(batch * V, 3, L, L)),
    }


def dit_parts(cfg, batch: int, sapiens: bool) -> Dict[str, int]:
    from portbench.reference.models.dit import DiTModel
    from portbench.reference.models.encoders import make_encoder

    S = cfg.input_size
    enc = functools.partial(make_encoder, cfg, sapiens)
    side = S // 16
    return {
        "encoder": forward_flops(enc, _meta(batch, 3, S, S)),
        "dit": forward_flops(lambda: DiTModel(cfg),
                             _meta(batch, cfg.in_channels, cfg.sample_height,
                                   cfg.sample_width),
                             _meta(batch, cfg.text_embed_dim, side, side),
                             _meta(batch, dtype=torch.long)),
    }


def vae_train_step(cfg, batch: int) -> float:
    """G step: VAE x3, LPIPS on the prediction x2, on the target x1."""
    p = vae_parts(cfg, batch)
    return float(3 * (p["vae_encode"] + p["vae_decode"])
                 + 3 * p["lpips_side"])


def dit_train_step(cfg, batch: int) -> float:
    """DiT x3; the frozen VAE encode and Sapiens-geometry encode x1."""
    p = dit_parts(cfg, batch, sapiens=True)
    enc = vae_parts(cfg, batch)["vae_encode"]
    return float(3 * p["dit"] + p["encoder"] + enc)


def serve_request(cfg) -> float:
    """Encoder, 2 x steps DiT forwards (CFG doubles the batch), decode."""
    p = dit_parts(cfg, 1, sapiens=False)
    dec = vae_parts(cfg, 1)["vae_decode"]
    return float(p["encoder"] + 2 * cfg.num_inference_steps * p["dit"] + dec)


def dit_step_flops(cfg, batch: int, cond_tokens: int) -> Dict[str, float]:
    """Floating-point operations of one DiT training step from the shapes
    (a multiply-add is 2): ``forward`` (patch and conditioning projections,
    the blocks' token-wise matmuls, attention scores and values, the AdaLN
    and time-embedding linears, the output projection), ``model`` = 3 x
    forward (forward + backward), ``with_recompute`` = model + the blocks'
    forward again (per-block checkpointing)."""
    d, p, temb = cfg.hidden_dim, cfg.patch_size, cfg.time_embed_dim
    s_img = (cfg.sample_height // p) * (cfg.sample_width // p)
    s = s_img + cond_tokens
    block = (2 * s * 4 * d * d              # q, k, v, out
             + 2 * s * 2 * d * 4 * d        # FFN in and out
             + 2 * 2 * s * s * d            # scores and values
             + 2 * 2 * temb * 6 * d)        # two AdaLN-zero linears
    rest = (2 * s_img * cfg.in_channels * p * p * d
            + 2 * cond_tokens * cfg.text_embed_dim * 16 * d
            + 2 * (d * temb + temb * temb) + 2 * temb * 2 * d
            + 2 * s_img * d * p * p * cfg.out_channels)
    fwd = batch * (cfg.num_layers * block + rest)
    recompute = batch * cfg.num_layers * block \
        if cfg.gradient_checkpointing else 0
    return {"forward": float(fwd), "model": 3.0 * fwd,
            "with_recompute": 3.0 * fwd + recompute}
