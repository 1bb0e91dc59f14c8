"""Serving cells: image -> avatar requests through ``AvatarPipeline``
(encoder, CFG DDIM sampling, decode, deform, render), one client in a
closed loop: the next request is sent when the last one's views are back.
A request asks for ``batch`` avatars; each answer takes a photo and an
SMPL-X vector from seeded pools and its initial noise from the seed; the
cameras are the serving rig (``views`` views). A unit is one request.

After the window the reference runs again ``check_answers`` of the
answers the program gave, drawn from the seed, one at a time, and compares
the rendered views and the sampled latents."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench import flops, inputs
from portbench.drivers import common
from portbench.judge import serve_numbers
from portbench.reference import steps
from portbench.reference.precision import strict_f32
from portbench.reference.utils.timing import NULL_TIMER


def rig(cfg, traffic, dev):
    cv, cvp, _ = inputs.cameras(cfg, None, traffic["views"], jitter=False)
    return torch.as_tensor(cv, device=dev), torch.as_tensor(cvp, device=dev)


class Cell:
    def __init__(self, cfg, ref_cfg, conf, traffic, seed, dev, log):
        from sigman_release_torch.inference import AvatarPipeline

        self.cfg, self.ref_cfg, self.conf = cfg, ref_cfg, conf
        self.traffic, self.seed, self.dev, self.log = traffic, seed, dev, log
        self.body, self.template = inputs.body_and_template(
            conf["n_verts"], seed, dev)
        body, template = common.program_body(self.body, self.template)
        self.pipe = AvatarPipeline(cfg, device=dev, body_model=body,
                                   template=template)
        vae = common.vae_state(ref_cfg, seed, dev)
        self.pipe.load_state_dicts(
            vae={k: v for k, v in vae.items()
                 if k.startswith(("autoencoder.decoder.", "heads."))},
            dit=common.dit_state(ref_cfg, seed, dev),
            encoder=common.encoder_state(ref_cfg, seed, dev, sapiens=False))
        del vae
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
        return self.traffic["batch"] * flops.serve_request(self.ref_cfg)

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
    """The reference's (or the control's) answers ``chosen``, one at a
    time."""
    strict_f32()
    serve = steps.Serve(ref_cfg, body, template,
                        common.vae_state(ref_cfg, seed, dev),
                        common.encoder_state(ref_cfg, seed, dev, False),
                        common.dit_state(ref_cfg, seed, dev), dev,
                        control=control)
    common.free(dev)
    pool = inputs.request_pool(ref_cfg, traffic["pool"], seed, dev)
    cams = rig(ref_cfg, traffic, dev)
    out = []
    for i in chosen:
        image, pose, noise = inputs.answer(ref_cfg, pool, seed, i, dev)
        latents, images = serve(image, pose, noise, *cams)
        out.append({"images": images[0].cpu(), "latents": latents[0].cpu()})
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
