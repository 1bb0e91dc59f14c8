"""VAE training cells: G steps through ``VAETrainer.train_step_g``, as
``fit`` runs them before ``disc_start``, on a pool of procedural items with
per-step orbit jitter and SMPL-X draws. A unit is one step of B items.

The reference follows the first ``followed_steps`` steps (the set-up's),
from the same weights, batches, posterior noise and dropout seeds."""

from __future__ import annotations

from typing import Dict, List

import torch

from portbench import flops, inputs
from portbench.drivers import common
from portbench.judge import train_numbers
from portbench.reference import steps
from portbench.reference.precision import strict_f32
from portbench.reference.utils.timing import NULL_TIMER

BETA1 = 0.9


class Cell:
    def __init__(self, cfg, ref_cfg, conf, traffic, seed, dev, log):
        from sigman_release_torch.training.vae_trainer import VAETrainer

        self.cfg, self.ref_cfg, self.conf = cfg, ref_cfg, conf
        self.traffic, self.seed, self.dev, self.log = traffic, seed, dev, log
        self.B = conf["batch"]
        self.body, self.template = inputs.body_and_template(
            conf["n_verts"], seed, dev)
        body, template = common.program_body(self.body, self.template)
        self.trainer = t = VAETrainer(cfg, body_model=body, template=template,
                                      device=dev)
        t.load_state_dicts(vae=common.vae_state(ref_cfg, seed, dev),
                           lpips=common.lpips_state(seed, dev), logvar=0.0)
        self.names = [n for n, _ in t.vae.named_parameters()] + ["logvar"]
        self.pool = inputs.item_pool(cfg, traffic["pool"], seed, dev)
        self.capture_ = common.Capture(ref_cfg)
        self.step_i = 0
        self.attempted = 0
        self.losses: List[float] = []
        self.overflow: List[float] = []
        # hand the program a caching allocator without the set-up's blocks:
        # at B = 8 its G step peaks at 65 GiB of the card's 79 GiB
        common.free(dev)
        for k in range(conf["followed_steps"]):
            self.unit()
            if k == 0:
                self.grad = common.adam_grad_norms(t.opt_g, t.params_g, BETA1)
        init = common.vae_state(ref_cfg, seed, dev)
        init["logvar"] = torch.zeros((), device=dev)
        self.update = common.change_norms(t.params_g, self.names, init)
        del init
        common.free(dev)
        log(f"[vae_train] first steps: loss {self.losses}, overflow "
            f"{self.overflow}")

    def batch(self, k):
        return inputs.train_batch(self.cfg, self.pool, self.B, k, self.seed,
                                  self.dev)

    def unit(self, timer=None) -> int:
        k, t = self.step_i, self.trainer
        batch = self.batch(k)
        noise = inputs.vae_noise(self.cfg, self.B, self.seed, k, self.dev)
        t.generator.manual_seed(inputs.dropout_seed(self.seed, k))
        logs = t.train_step_g(batch, noise=noise, timer=timer or NULL_TIMER)
        loss = float(logs["loss"])          # the host reads it, as fit does
        if k < self.conf["followed_steps"]:
            self.losses.append(loss)
            self.overflow.append(float(logs["overflow"]))
        self.step_i += 1
        self.attempted += 1
        return self.B

    def capture(self, on: bool):
        self.capture_.on = on

    def bounds_s(self) -> Dict[str, float]:
        return self.capture_.bounds_s()

    def flops_per_unit(self) -> float:
        return flops.vae_train_step(self.ref_cfg, self.B) / self.B

    def judge(self) -> Dict[str, float]:
        prog = {"loss": self.losses, "grad": self.grad, "update": self.update}
        self.capture_.close()
        del self.trainer
        common.free(self.dev)
        ref = follow(self.ref_cfg, self.conf, self.traffic, self.seed,
                     self.dev, self.body, self.template, control=False)
        numbers = train_numbers(prog, ref)
        self.log(f"[vae_train] reference loss {ref['loss']}")
        return numbers


def follow(ref_cfg, conf, traffic, seed, dev, body, template, control,
           half=False):
    """The reference's first steps: {"loss", "grad", "update"}; ``half``
    plants a fault: each step leaves out half of the batch and takes the
    mean over the rest."""
    strict_f32()
    B, n = conf["batch"], conf["followed_steps"]
    ref = steps.VAETrain(ref_cfg, body, template,
                         common.vae_state(ref_cfg, seed, dev),
                         common.lpips_state(seed, dev), dev, control=control)
    pool = inputs.item_pool(ref_cfg, traffic["pool"], seed, dev)
    losses, grad = [], None
    for k in range(n):
        batch = inputs.train_batch(ref_cfg, pool, B, k, seed, dev)
        noise = inputs.vae_noise(ref_cfg, B, seed, k, dev)
        if half:
            batch = {key: v[: B // 2] for key, v in batch.items()}
            noise = noise[: B // 2]
        loss, norms = ref.step(batch, noise, inputs.dropout_seed(seed, k))
        losses.append(loss)
        grad = grad or norms
    init = common.vae_state(ref_cfg, seed, dev)
    init["logvar"] = torch.zeros((), device=dev)
    update = common.change_norms(ref.params, ref.names, init)
    return {"loss": losses, "grad": grad, "update": update}


def control(ref_cfg, conf, traffic, seed, dev, log, fault="lower"):
    """The control's readings (``fault="lower"``: the reference one
    precision step below the configuration) or a planted fault's
    (``"half"``), against the reference."""
    body, template = inputs.body_and_template(conf["n_verts"], seed, dev)
    low = follow(ref_cfg, conf, traffic, seed, dev, body, template,
                 fault == "lower", half=fault == "half")
    common.free(dev)
    ref = follow(ref_cfg, conf, traffic, seed, dev, body, template, False)
    log(f"[vae_train] control loss {low['loss']} reference {ref['loss']}")
    return train_numbers(low, ref)
