"""DiT training cells: ``DiTTrainer.train_step`` on the raw path (both
frozen encodes every step), as ``train_DiT.py`` runs it, on a pool of
procedural items with per-step orbit jitter; the draws (posterior noise,
timesteps, noise, conditioning dropout) come from the seed. A unit is one
step of B samples.

The reference follows the first ``followed_steps`` steps (the set-up's),
from the same weights, batches and draws."""

from __future__ import annotations

from typing import Dict, List

from portbench import flops, inputs
from portbench.drivers import common
from portbench.judge import train_numbers
from portbench.reference import steps
from portbench.reference.precision import strict_f32
from portbench.reference.utils.timing import NULL_TIMER

BETA1 = 0.9
RAW_KEYS = ("input", "UV_inital", "sapiens_input")


def batch(cfg, pool, B, k, seed, dev):
    b = inputs.train_batch(cfg, pool, B, k, seed, dev, with_cond=True)
    return {key: b[key] for key in RAW_KEYS}


class Cell:
    def __init__(self, cfg, ref_cfg, conf, traffic, seed, dev, log):
        import torch

        from sigman_release_torch.models.vae import VAEModel
        from sigman_release_torch.training.dit_trainer import (
            DiTTrainer,
            make_encoder,
        )

        self.cfg, self.ref_cfg, self.conf = cfg, ref_cfg, conf
        self.traffic, self.seed, self.dev, self.log = traffic, seed, dev, log
        self.B = conf["batch"]
        with torch.device(dev):
            vae = VAEModel(cfg)
        vae.load_state_dict(common.vae_state(ref_cfg, seed, dev))
        with torch.device("meta"):
            encoder = make_encoder(cfg)
        encoder = encoder.to_empty(device=dev)
        encoder.load_state_dict(common.encoder_state(ref_cfg, seed, dev,
                                                     sapiens=True))
        self.trainer = t = DiTTrainer(cfg, vae, encoder, device=dev)
        t.model.load_state_dict(common.dit_state(ref_cfg, seed, dev))
        common.free(dev)
        self.params = list(t.model.parameters())
        self.names = [n for n, _ in t.model.named_parameters()]
        self.pool = inputs.item_pool(cfg, traffic["pool"], seed, dev)
        self.step_i = 0
        self.attempted = 0
        self.losses: List[float] = []
        common.free(dev)
        for k in range(conf["followed_steps"]):
            self.unit()
            if k == 0:
                self.grad = common.adam_grad_norms(t.opt, self.params, BETA1)
        init = common.dit_state(ref_cfg, seed, dev)
        self.update = common.change_norms(self.params, self.names, init)
        del init
        common.free(dev)
        log(f"[dit_train] first steps: loss {self.losses}")

    def unit(self, timer=None) -> int:
        k = self.step_i
        b = batch(self.cfg, self.pool, self.B, k, self.seed, self.dev)
        draws = inputs.dit_draws(self.cfg, self.B, self.seed, k, self.dev)
        logs = self.trainer.train_step(b, draws=draws,
                                       timer=timer or NULL_TIMER)
        loss = float(logs["loss"])          # the host reads it, as fit does
        if k < self.conf["followed_steps"]:
            self.losses.append(loss)
        self.step_i += 1
        self.attempted += 1
        return self.B

    def capture(self, on: bool):
        pass

    def bounds_s(self) -> Dict[str, float]:
        return {}

    def flops_per_unit(self) -> float:
        return flops.dit_train_step(self.ref_cfg, self.B) / self.B

    def judge(self) -> Dict[str, float]:
        prog = {"loss": self.losses, "grad": self.grad, "update": self.update}
        del self.trainer, self.params
        common.free(self.dev)
        ref = follow(self.ref_cfg, self.conf, self.traffic, self.seed,
                     self.dev, control=False)
        self.log(f"[dit_train] reference loss {ref['loss']}")
        return train_numbers(prog, ref)


def follow(ref_cfg, conf, traffic, seed, dev, control, half=False):
    """The reference's first steps: {"loss", "grad", "update"}; ``half``
    plants a fault: each step leaves out half of the batch and takes the
    mean over the rest."""
    strict_f32()
    B, n = conf["batch"], conf["followed_steps"]
    ref = steps.DiTTrain(ref_cfg, common.vae_state(ref_cfg, seed, dev),
                         common.encoder_state(ref_cfg, seed, dev, True),
                         common.dit_state(ref_cfg, seed, dev), dev,
                         control=control)
    common.free(dev)
    pool = inputs.item_pool(ref_cfg, traffic["pool"], seed, dev)
    losses, grad = [], None
    for k in range(n):
        b = batch(ref_cfg, pool, B, k, seed, dev)
        draws = inputs.dit_draws(ref_cfg, B, seed, k, dev)
        if half:
            b = {key: v[: B // 2] for key, v in b.items()}
            draws = {key: v[: B // 2] for key, v in draws.items()}
        loss, norms = ref.step(b, draws)
        losses.append(loss)
        grad = grad or norms
    init = common.dit_state(ref_cfg, seed, dev)
    update = common.change_norms(ref.params, ref.names, init)
    del ref, init
    common.free(dev)
    return {"loss": losses, "grad": grad, "update": update}


def control(ref_cfg, conf, traffic, seed, dev, log, fault="lower"):
    """As ``vae_train.control``."""
    low = follow(ref_cfg, conf, traffic, seed, dev, fault == "lower",
                 half=fault == "half")
    ref = follow(ref_cfg, conf, traffic, seed, dev, False)
    log(f"[dit_train] control loss {low['loss']} reference {ref['loss']}")
    return train_numbers(low, ref)
