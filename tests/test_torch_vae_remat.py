"""The VAE's remat policies in the PyTorch port (``models/vae.py``) at
``test_tiny`` on the CPU: "conv", "conv_enc" and "none" against "block",
"conv" against the JAX VAE's "conv", and the convolutions each policy runs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.checkpoint import set_checkpoint_early_stop

from sigman_release_tpu.config import PRESETS as JPRESETS
from sigman_release_tpu.models.vae import VAEModel as JVAE
from sigman_release_torch import convert
from sigman_release_torch.config import PRESETS
from sigman_release_torch.models.init import random_weights_
from sigman_release_torch.models.vae import (
    REMAT_POLICIES,
    ResnetBlock,
    VAEModel,
    set_remat_policy,
)

OVR = dict(num_views=2, num_input_views=2, attn_dropout=0.0)
JCFG = JPRESETS["test_tiny"].replace(**OVR)
TCFG = PRESETS["test_tiny"].replace(**OVR)
# one network, one input: only the recomputation differs between policies
POLICY_TOL = 1e-6
# gradients against the JAX VAE's, relative L2, as tests/test_torch_training.py
# holds the G step's
GRAD_LEAF_TOL = 2e-3
GRAD_ALL_TOL = 1e-3
GRAD_ZERO = 1e-6


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    s = TCFG.input_size
    images = rng.normal(size=(1, TCFG.num_input_views, 9, s, s))
    uv = rng.uniform(0, 1, (1, 3, s, s))
    noise = rng.normal(size=(1, TCFG.sample_height, TCFG.sample_width,
                             TCFG.latent_channels))
    return [torch.from_numpy(a.astype(np.float32)) for a in (images, uv,
                                                              noise)]


def _loss(model, images, uv, noise):
    attr, post = model(images, uv, noise)
    return attr.square().mean() + 1e-3 * post.kl().mean()


def _model(policy):
    model = VAEModel(TCFG.replace(remat_policy=policy))
    return random_weights_(model, torch.Generator().manual_seed(0))


def _loss_and_grads(policy):
    model = _model(policy)
    loss = _loss(model, *_inputs())
    loss.backward()
    return model, loss.item(), {n: p.grad.clone()
                                for n, p in model.named_parameters()}


def test_remat_policies_listed():
    assert set(REMAT_POLICIES) == {"block", "conv", "conv_enc", "none"}
    with pytest.raises(ValueError):
        VAEModel(TCFG.replace(remat_policy="everything"))


@pytest.mark.parametrize("policy", ["conv", "conv_enc", "none"])
def test_policy_matches_block(policy):
    """The loss and every gradient within 1e-6 of "block" on the same
    weights; a "block" model switched by ``set_remat_policy`` runs as one
    built with the policy."""
    _, ref_loss, ref = _loss_and_grads("block")
    _, loss, grads = _loss_and_grads(policy)
    assert np.isfinite(ref_loss) and abs(loss - ref_loss) <= POLICY_TOL
    for n, g in ref.items():
        torch.testing.assert_close(grads[n], g, atol=POLICY_TOL, rtol=0,
                                   msg=n)
    built = _model(policy)
    switched = _model("block")
    set_remat_policy(switched, policy)
    assert [m.remat for m in switched.modules()
            if isinstance(m, ResnetBlock)] == [
        m.remat for m in built.modules() if isinstance(m, ResnetBlock)]


def _rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def test_conv_gradients_match_jax():
    """"conv" in both packages: the same loss of the attribute map and KL
    on the JAX initialisation (``convert.py``) and JAX's posterior noise;
    gradients within the G-step tolerances of test_torch_training.py."""
    jcfg = JCFG.replace(remat_policy="conv")
    jm = JVAE(jcfg)
    images, uv, noise = (t.numpy() for t in _inputs())
    key = jax.random.PRNGKey(7)
    jp = jax.jit(jm.init)({"params": jax.random.PRNGKey(0), "sample": key},
                          jnp.asarray(images), jnp.asarray(uv), key)
    _, jpost = jax.jit(jm.apply)(jp, jnp.asarray(images), jnp.asarray(uv),
                                 key)
    jnoise = np.array(jax.random.normal(key, jpost.mean.shape))

    def jloss(p):
        attr, post = jm.apply(p, jnp.asarray(images), jnp.asarray(uv), key)
        return jnp.mean(attr ** 2) + 1e-3 * jnp.mean(post.kl())

    jl, jg = jax.jit(jax.value_and_grad(jloss))(jp)
    tree = jax.tree.map(np.asarray, jp)
    model = VAEModel(TCFG.replace(remat_policy="conv"))
    model.load_state_dict(convert.convert_vae(tree, model, TCFG))
    loss = _loss(model, torch.from_numpy(images), torch.from_numpy(uv),
                 torch.from_numpy(jnoise))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-4 * abs(float(jl))
    ref = convert.map_tree(jax.tree.map(np.asarray, jg),
                           convert.vae_key_map(TCFG))
    ref = {n: g.numpy() for n, g in ref.items()}
    ours = {n: p.grad.numpy() for n, p in model.named_parameters()}
    assert set(ref) == set(ours)
    norm_all = np.sqrt(sum(float((g ** 2).sum()) for g in ref.values()))
    diff_all = np.sqrt(sum(float(((ours[n] - g) ** 2).sum())
                           for n, g in ref.items()))
    assert diff_all / norm_all <= GRAD_ALL_TOL
    for n, g in ref.items():
        if np.linalg.norm(g) <= GRAD_ZERO * norm_all:
            assert np.linalg.norm(ours[n]) <= GRAD_ZERO * norm_all, n
        else:
            assert _rel(ours[n], g) <= GRAD_LEAF_TOL, (n, _rel(ours[n], g))


class _CountConvs(TorchDispatchMode):
    """Counts ``aten.convolution`` calls (forward and recomputation)."""

    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func == torch.ops.aten.convolution.default:
            self.n += 1
        return func(*args, **(kwargs or {}))


def _convs(policy, early_stop=True):
    model = _model(policy)
    with set_checkpoint_early_stop(early_stop), _CountConvs() as c:
        _loss(model, *_inputs()).backward()
    return model, c.n


def test_conv_runs_each_resnet_conv_once():
    """Over one forward + backward, "conv" runs each resnet convolution
    once (as "none"), "block" twice; "conv_enc" twice on the decoder's
    only. The other convolutions (the attention layers', recomputed under
    every policy, and those outside the blocks) count the same in all.
    "block" is counted with the checkpoint's early stop off, so that it
    recomputes whole blocks; with it on (the default) the recomputation
    stops after the last activation the backward needs, before a block's
    conv2, so it runs fewer, but still more than "conv"."""
    model, none = _convs("none")
    resnets = [m for m in model.modules() if isinstance(m, ResnetBlock)]

    def n_convs(blocks):
        return sum(2 + (b.conv_shortcut is not None) for b in blocks)

    dec = [m for m in model.autoencoder.decoder.modules()
           if isinstance(m, ResnetBlock)]
    assert n_convs(resnets) > n_convs(dec) > 0
    counts = {p: _convs(p, early_stop=False)[1]
              for p in ("conv", "conv_enc", "block")}
    assert counts["conv"] == _convs("conv")[1] == none
    assert counts["block"] == none + n_convs(resnets)
    assert counts["conv_enc"] == none + n_convs(dec)
    assert none + len(resnets) <= _convs("block")[1] < counts["block"]
