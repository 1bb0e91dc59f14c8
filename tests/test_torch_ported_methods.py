"""What the port carries of the JAX package besides its modules' main paths:
LPIPS weights read from files (``losses/lpips.load_lpips_params``, and
``VAETrainer.init(seed, lpips_ckpt=...)``) and ``DiagonalGaussian.nll``,
each held against the JAX function on the same inputs.

The weight files are written with ``torch.save`` in torchvision's layout
(``features.{i}.weight`` / ``.bias`` of ``vgg16()`` / ``alexnet()``) and
richzhang's (``lin{i}.model.1.weight``) from a seeded numpy generator
(``chip_smoke.lpips_files``, which phase 17 loads on the card).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigman_release_tpu.losses.lpips import LPIPS as JLPIPS
from sigman_release_tpu.losses.lpips import (
    load_lpips_params as j_load_lpips_params,
)
from sigman_release_tpu.models.vae import DiagonalGaussian as JDiagonalGaussian
from sigman_release_torch.config import PRESETS
from sigman_release_torch.losses.lpips import (
    LPIPS, VGG_CHANNELS, VGG_FEATURES, load_lpips_params,
)
from sigman_release_torch.models.vae import DiagonalGaussian
from sigman_release_torch.training.vae_trainer import VAETrainer

from chip_smoke import lpips_files

# the same f32 convolutions on both sides (test_torch_losses.TOL)
TOL = 1e-5


@pytest.mark.parametrize("net", ["vgg", "alex"])
@pytest.mark.parametrize("heads", [False, True])
def test_lpips_from_files_matches_jax(net, heads, tmp_path):
    trunk, head = lpips_files(str(tmp_path), net, np.random.default_rng(3),
                              heads=heads)
    model = LPIPS(net)
    model.load_state_dict(load_lpips_params(trunk, head, net=net))
    jparams = j_load_lpips_params(trunk, head, net=net)
    rng = np.random.default_rng(0)
    x = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    y = rng.uniform(-1, 1, (2, 3, 64, 64)).astype(np.float32)
    ref = np.asarray(JLPIPS(net=net).apply(jparams, jnp.asarray(x),
                                           jnp.asarray(y)))
    with torch.no_grad():
        out = model(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_allclose(out, ref, rtol=TOL, atol=TOL)
    assert (out > 0).all()
    lin0 = model.lins[0].weight
    if heads:
        assert torch.equal(lin0, torch.load(head)["lin0.model.1.weight"])
    else:
        assert torch.all(lin0 == 1.0 / model.channels[0])


def test_no_path_gives_none():
    assert load_lpips_params(None) is None and load_lpips_params("") is None


def test_vae_trainer_init_loads_the_lpips_trunk(tmp_path):
    """``init(seed, lpips_ckpt)``: the training LPIPS trunk from the file
    and heads 1/C, everything else (the ``alex`` eval LPIPS included) as
    ``init(seed)`` seeds it, as the JAX ``init_state``."""
    trunk, _ = lpips_files(str(tmp_path), "vgg", np.random.default_rng(5),
                           heads=False)
    cfg = PRESETS["test_tiny"].replace(eval_lpips_net="alex")
    trainer = VAETrainer(cfg, device="cpu")
    seeded = {n: {k: v.clone() for k, v in m.state_dict().items()}
              for n, m in (("lpips_eval", trainer.lpips_eval),
                           ("vae", trainer.vae))}
    trainer.init(cfg.seed, lpips_ckpt=trunk)
    want = torch.load(trunk)
    for k, i in zip(("conv0_0", "conv0_1", "conv4_2"),
                    (VGG_FEATURES[0], VGG_FEATURES[1], VGG_FEATURES[-1])):
        got = getattr(trainer.lpips.vgg, k)
        assert torch.equal(got.weight, want[f"features.{i}.weight"]), k
        assert torch.equal(got.bias, want[f"features.{i}.bias"]), k
    for lin, c in zip(trainer.lpips.lins, VGG_CHANNELS):
        assert torch.all(lin.weight == 1.0 / c)
    for n, m in (("lpips_eval", trainer.lpips_eval), ("vae", trainer.vae)):
        for k, v in m.state_dict().items():
            assert torch.equal(v, seeded[n][k]), (n, k)


def test_diagonal_gaussian_nll_matches_jax():
    rng = np.random.default_rng(1)
    mean, logvar, sample = (rng.normal(0, s, (2, 4, 4, 3)).astype(np.float32)
                            for s in (1.0, 0.5, 1.0))
    ref = np.asarray(JDiagonalGaussian(jnp.asarray(mean), jnp.asarray(logvar))
                     .nll(jnp.asarray(sample)))
    out = DiagonalGaussian(torch.from_numpy(mean), torch.from_numpy(logvar)) \
        .nll(torch.from_numpy(sample)).numpy()
    assert out.shape == (2,)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
