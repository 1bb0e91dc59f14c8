"""Serving cells of the FLUX denoiser: image -> avatar requests through
``AvatarPipeline`` at ``denoiser="flux"`` (encoder, the flow Euler loop
with embedded guidance, decode, deform, render), one client in a closed
loop, as ``dit_serve.py`` drives the DiT: a request asks for ``batch``
avatars, each a photo and an SMPL-X vector from seeded pools and its noise
from the seed, the cameras the serving rig. A unit is one request.

The configuration file's ``config`` holds the fields both ``Config``s
have; its ``flux`` group holds the FLUX-only fields, which this driver
applies to the program's ``Config`` and hands to the reference. The
denoiser's weights are drawn part by part from the seed (the stems, then
each block, one stream each), so that the program can be given them block
by block and the reference can draw a block again when it reaches it.

After the window the reference runs ``check_answers`` of the answers the
program gave, drawn from the seed, as one batch, and compares the rendered
views and the sampled latents."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import flux_flops, inputs
from portbench.drivers import common
from portbench.drivers.dit_serve import rig
from portbench.judge import serve_numbers
from portbench.reference.flux_serve import FluxServe
from portbench.reference.models import flux
from portbench.reference.precision import strict_f32
from portbench.reference.utils.timing import NULL_TIMER

# the denoiser's weight streams: key FLUX_KEY * 1000 + part index
FLUX_KEY = 5


def program_config(cfg, fields: dict):
    return cfg.replace(**{k: tuple(v) if isinstance(v, list) else v
                          for k, v in fields.items()})


def part_states(ref_cfg, fields: dict, seed: int, dev):
    """``state_of(part)``: the f32 weights of one part of the denoiser on
    ``dev``, drawn from the seed alike on every call."""
    p = flux.params_of(ref_cfg, fields)
    index = {name: i for i, name in enumerate(flux.part_names(p))}

    def state_of(name: str) -> Dict[str, torch.Tensor]:
        shapes = common.meta_shapes(lambda: flux.make_part(p, name))
        return inputs.seeded_state(shapes, dev, seed,
                                   FLUX_KEY * 1000 + index[name])

    return p, state_of


def load_denoiser(model: torch.nn.Module, ref_cfg, fields, seed, dev):
    """Give the program's model its weights part by part (each cast to the
    model's dtype as it is copied in)."""
    p, state_of = part_states(ref_cfg, fields, seed, dev)
    loaded = set()
    for name in flux.part_names(p):
        prefix = "" if name == "stems" else name + "."
        sd = {prefix + k: v for k, v in state_of(name).items()}
        bad = model.load_state_dict(sd, strict=False).unexpected_keys
        if bad:
            raise KeyError(f"the program's FLUX has no {bad[:4]}")
        loaded.update(sd)
        del sd
    missing = set(model.state_dict()) - loaded
    if missing:
        raise KeyError(f"no weights drawn for {sorted(missing)[:4]}")


class Cell:
    def __init__(self, cfg, ref_cfg, conf, traffic, seed, dev, log):
        from sigman_release_torch.inference import AvatarPipeline
        from sigman_release_torch.models.flux import FluxModel

        cfg = program_config(cfg, conf["flux"])
        self.cfg, self.ref_cfg, self.conf = cfg, ref_cfg, conf
        self.traffic, self.seed, self.dev, self.log = traffic, seed, dev, log
        self.body, self.template = inputs.body_and_template(
            conf["n_verts"], seed, dev)
        body, template = common.program_body(self.body, self.template)
        self.pipe = AvatarPipeline(cfg, device=dev, body_model=body,
                                   template=template)
        if not isinstance(self.pipe.dit, FluxModel):
            raise TypeError("AvatarPipeline did not build the FLUX denoiser")
        vae = common.vae_state(ref_cfg, seed, dev)
        self.pipe.load_state_dicts(
            vae={k: v for k, v in vae.items()
                 if k.startswith(("autoencoder.decoder.", "heads."))},
            encoder=common.encoder_state(ref_cfg, seed, dev, sapiens=False))
        del vae
        load_denoiser(self.pipe.dit, ref_cfg, conf["flux"], seed, dev)
        common.free(dev)
        self.pool = inputs.request_pool(cfg, traffic["pool"], seed, dev)
        self.cams = rig(cfg, traffic, dev)
        self.capture_ = common.Capture(ref_cfg)
        self.req_i = 0
        self.attempted = 0
        self.kept: Dict[int, dict] = {}
        common.free(dev)
        for _ in range(traffic["warmup"]):
            self.unit(keep=False)

    def unit(self, timer=None, keep=True) -> int:
        i, B = self.req_i, self.traffic["batch"]
        image, pose, noise = inputs.request(self.cfg, self.pool, self.seed, i,
                                            B, self.dev)
        out = self.pipe(image, pose, *self.cams, noise=noise,
                        timer=timer or NULL_TIMER)
        if keep:                             # the client reads its views
            images, latents = (out["render"]["image"].cpu(),
                               out["latents"].cpu())
            for j in range(B):
                self.kept[i * B + j] = {"images": images[j],
                                        "latents": latents[j]}
        else:
            common.sync(self.dev)
        self.req_i += 1
        self.attempted += int(keep)
        return 1

    def capture(self, on: bool):
        self.capture_.on = on

    def bounds_s(self):
        return self.capture_.bounds_s()

    def flops_per_unit(self) -> float:
        return self.traffic["batch"] * flux_flops.serve_request(
            self.ref_cfg, self.conf["flux"])

    def sample(self):
        """``check_answers`` of the answers given, drawn from the seed."""
        done = sorted(self.kept)
        rng = np.random.default_rng(inputs.sub_seed(self.seed, 900))
        n = min(self.traffic["check_answers"], len(done))
        return sorted(rng.choice(done, size=n, replace=False).tolist())

    def judge(self) -> Dict[str, float]:
        chosen = self.sample()
        prog = [self.kept[i] for i in chosen]
        self.capture_.close()
        del self.pipe
        self.kept = {}
        common.free(self.dev)
        ref = answers(self.ref_cfg, self.conf, self.traffic, self.seed,
                      self.dev, self.body, self.template, chosen, False)
        return serve_numbers(prog, ref)


def answers(ref_cfg, conf, traffic, seed, dev, body, template, chosen,
            control):
    """The reference's (or the control's) answers ``chosen``, as one
    batch."""
    strict_f32()
    _, state_of = part_states(ref_cfg, conf["flux"], seed, dev)
    serve = FluxServe(ref_cfg, conf["flux"], body, template,
                      common.vae_state(ref_cfg, seed, dev),
                      common.encoder_state(ref_cfg, seed, dev, False),
                      state_of, dev, control=control)
    common.free(dev)
    pool = inputs.request_pool(ref_cfg, traffic["pool"], seed, dev)
    cams = rig(ref_cfg, traffic, dev)
    image, pose, noise = (torch.cat(x) for x in zip(*[
        inputs.answer(ref_cfg, pool, seed, i, dev) for i in chosen]))
    latents, images = serve(image, pose, noise, *cams)
    out = [{"images": images[j].cpu(), "latents": latents[j].cpu()}
           for j in range(len(chosen))]
    del serve
    common.free(dev)
    return out


def control(ref_cfg, conf, traffic, seed, dev, log, fault="lower"):
    """The control's readings: the reference one precision step below the
    configuration against the reference, on ``check_answers`` answers."""
    if fault != "lower":
        raise ValueError(f"serving plants no {fault!r} fault")
    body, template = inputs.body_and_template(conf["n_verts"], seed, dev)
    first = traffic["warmup"] * traffic["batch"]
    chosen = list(range(first, first + traffic["check_answers"]))
    low = answers(ref_cfg, conf, traffic, seed, dev, body, template, chosen,
                  True)
    ref = answers(ref_cfg, conf, traffic, seed, dev, body, template, chosen,
                  False)
    return serve_numbers(low, ref)
