"""The port's state-file readers (``sigman_release_torch/training/
checkpoint.py``) held against the JAX package's msgpack serializer and the
``safetensors`` package on CPU: every array read back bit for bit, and
reference-layout files read into the port's modules with no parameter
missing, agreeing with the JAX package's ``load_params_any`` after
``convert.py``."""

import os
import sys

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file as save_numpy
from safetensors.torch import save_file as save_torch_st

from sigman_release_tpu.config import PRESETS as JPRESETS
from sigman_release_tpu.losses.gan import PatchDiscriminator as JDisc
from sigman_release_tpu.models.dit import DiTModel as JDiT
from sigman_release_tpu.models.vae import VAEModel as JVAE
from sigman_release_tpu.training import checkpoint as jckpt
from sigman_release_torch import convert
from sigman_release_torch.config import PRESETS
from sigman_release_torch.losses.gan import PatchDiscriminator
from sigman_release_torch.models.dit import DiTModel
from sigman_release_torch.models.vae import VAEModel
from sigman_release_torch.training import checkpoint

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_convert import _torch_disc_replica, _torch_vae_replica  # noqa: E402

CFG = PRESETS["test_tiny"]
JCFG = JPRESETS["test_tiny"]
DIT_OVR = dict(num_layers=2, num_attention_heads=2, attention_head_dim=8,
               text_embed_dim=16, time_embed_dim=16, sample_height=8,
               sample_width=8)
DISC_LAYERS = 4                 # the reference's discriminator depth


def _bits(x) -> np.ndarray:
    """An array's bits: bf16 as int16 (numpy has no bf16)."""
    if isinstance(x, torch.Tensor):
        return (x.view(torch.int16) if x.dtype == torch.bfloat16
                else x).numpy()
    x = np.asarray(x)
    return x.view(np.int16) if x.dtype == jnp.bfloat16 else x


def _assert_same(port, ref, path="root"):
    """The port's tree equals the serializer's: the same keys, arrays bit
    for bit with the same shape, scalars equal."""
    if isinstance(ref, dict):
        assert isinstance(port, dict) and port.keys() == ref.keys(), path
        for k in ref:
            _assert_same(port[k], ref[k], f"{path}/{k}")
    elif isinstance(ref, (np.ndarray, np.generic)):
        assert isinstance(port, torch.Tensor), path
        assert tuple(port.shape) == np.shape(ref), path
        np.testing.assert_array_equal(_bits(port), _bits(ref), err_msg=path)
    else:
        assert type(port) is type(ref) and port == ref, path


def _tree(rng):
    return {
        "params": {
            "dense": {"kernel": rng.normal(size=(3, 4)).astype(np.float32),
                      "bias": rng.normal(size=(4,)).astype(np.float32)},
            "bf16": jnp.asarray(rng.normal(size=(5, 2)), jnp.bfloat16),
            "index": rng.integers(-9, 9, (6,)).astype(np.int32),
            "empty": np.zeros((0, 3), np.float32),
        },
        # a tuple becomes an indexed dict, as optimizer states do
        "opt": ({}, {"count": np.int32(3), "mu": np.float32(0.25)}),
        "step": 7, "neg": -5, "big": 2 ** 40, "rate": 0.5, "flag": True,
        "nothing": None, "name": "vae",
        "chunked_f32": rng.normal(size=(7, 30)).astype(np.float32),
        "chunked_bf16": jnp.asarray(rng.normal(size=(300,)), jnp.bfloat16),
    }


def test_msgpack_reader_matches_the_serializer(tmp_path, monkeypatch):
    """A state file written by the JAX package's ``save_checkpoint`` (the
    msgpack serializer): f32, bf16, int32 and empty arrays, numpy scalars,
    Python scalars, nested indexed dicts, and leaves above the chunk size
    (lowered to 256 bytes so that two leaves split into chunks)."""
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 256)
    path = str(tmp_path / "state.msgpack")
    jckpt.save_checkpoint(path, _tree(np.random.default_rng(0)))
    with open(path, "rb") as f:
        raw = f.read()
    assert b"__msgpack_chunked_array__" in raw
    ref = fser.msgpack_restore(raw)
    port = checkpoint.read_msgpack(path)
    _assert_same(port, ref)
    assert port["opt"]["1"]["count"].shape == ()
    assert port["chunked_bf16"].dtype == torch.bfloat16


def test_safetensors_reader_matches_the_writers(tmp_path):
    """Files of ``safetensors.numpy`` (F32, F16, I64, I32, U8, BOOL, with
    metadata) and ``safetensors.torch`` (BF16, F32) read back bit for
    bit."""
    rng = np.random.default_rng(1)
    arrays = {"f32": rng.normal(size=(3, 5)).astype(np.float32),
              "f16": rng.normal(size=(4,)).astype(np.float16),
              "i64": rng.integers(-2 ** 40, 2 ** 40, (2, 2)),
              "i32": rng.integers(-9, 9, (3,)).astype(np.int32),
              "u8": rng.integers(0, 255, (7,)).astype(np.uint8),
              "bool": rng.uniform(size=(5,)) > 0.5}
    p1 = str(tmp_path / "a.safetensors")
    save_numpy(arrays, p1, metadata={"format": "np"})
    out = checkpoint.read_safetensors(p1)
    assert out.keys() == arrays.keys()
    for k, v in arrays.items():
        assert out[k].shape == v.shape
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)
    tensors = {"bf16": torch.randn(6, 3, generator=torch.Generator()
                                   .manual_seed(2)).to(torch.bfloat16),
               "f32": torch.arange(10, dtype=torch.float32)}
    p2 = str(tmp_path / "b.safetensors")
    save_torch_st(tensors, p2)
    out = checkpoint.read_safetensors(p2)
    for k, v in tensors.items():
        assert out[k].dtype == v.dtype
        assert torch.equal(out[k].view(torch.int16) if k == "bf16" else out[k],
                           v.view(torch.int16) if k == "bf16" else v)


def test_sniff_format(tmp_path):
    """The port's torch.save file, a safetensors file and a msgpack state
    file each sniff as their own format."""
    files = {"torch": tmp_path / "s.pt", "safetensors": tmp_path / "s.st",
             "msgpack": tmp_path / "s.msgpack"}
    torch.save({"step": 1, "w": torch.ones(2)}, files["torch"])
    save_numpy({"w": np.ones(2, np.float32)}, str(files["safetensors"]))
    jckpt.save_checkpoint(str(files["msgpack"]), {"w": np.ones(2),
                                                  "step": 1})
    for fmt, path in files.items():
        assert checkpoint.sniff_format(str(path)) == fmt
        assert jckpt.sniff_format(str(path)) == (
            "safetensors" if fmt == "safetensors" else "msgpack")


def test_unreadable_files_raise(tmp_path):
    """A file in none of the formats raises naming the module; a
    truncated msgpack file raises."""
    zeros = tmp_path / "zeros.bin"
    zeros.write_bytes(b"\0" * 8)
    with pytest.raises(NotImplementedError, match="checkpoint.py"):
        checkpoint.read_msgpack(str(zeros))
    full = tmp_path / "full.msgpack"
    jckpt.save_checkpoint(str(full), {"w": np.ones(64, np.float32)})
    cut = tmp_path / "cut.msgpack"
    cut.write_bytes(full.read_bytes()[:-10])
    with pytest.raises(ValueError, match="truncated"):
        checkpoint.read_msgpack(str(cut))


def test_tolerant_restore_reports_missing_and_mismatched(capsys):
    """Entries matching by name and shape are copied (cast to the target's
    dtype); a missing key and a shape mismatch keep the target's value and
    print the JAX package's lines; extra entries are listed unused."""
    target = {"a": torch.zeros(2, 3), "b": torch.zeros(4),
              "c": torch.zeros(1, dtype=torch.bfloat16)}
    loaded = {"a": torch.ones(2, 3, dtype=torch.float64),
              "b": torch.ones(5), "c": torch.full((1,), 2.0),
              "extra": torch.ones(1)}
    out, stats = checkpoint.tolerant_restore(target, {**loaded})
    assert torch.equal(out["a"], torch.ones(2, 3))
    assert out["a"].dtype == torch.float32
    assert out["b"] is target["b"]
    assert out["c"].dtype == torch.bfloat16 and out["c"].item() == 2.0
    assert stats == {"restored": 2, "missing": [], "mismatched": ["b"],
                     "unused": ["extra"]}
    del loaded["a"]
    out, stats = checkpoint.tolerant_restore(target, loaded)
    assert stats["missing"] == ["a"] and out["a"] is target["a"]
    printed = capsys.readouterr().out
    assert "[ckpt] missing key a" in printed
    assert "[ckpt] shape mismatch for b: (5,) vs (4,)" in printed


def _jax_vae_params():
    model = JVAE(JCFG)
    s, v = JCFG.input_size, JCFG.num_input_views
    key = jax.random.PRNGKey(0)
    return jax.jit(model.init)({"params": key, "sample": key},
                               jnp.zeros((1, v, 9, s, s)),
                               jnp.zeros((1, 3, s, s)), key)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("family", ["vae", "disc", "dit"])
def test_reference_safetensors_load_into_the_port(family, tmp_path):
    """A reference-layout safetensors file (the torch replicas of
    tests/test_convert.py for the VAE and the reference's 4-layer
    discriminator; the DiT's names are the port's) reads into the port's
    module with no parameter missing, mismatched or unused, each tensor
    equal to the file's; the JAX package's ``load_params_any`` of the same
    file, converted by ``convert.py``, gives the same tensors bit for bit.
    A decode-only VAE takes the decode side of the same file."""
    torch.manual_seed(0)
    if family == "vae":
        ref = _torch_vae_replica(CFG)
        sd = dict(ref.state_dict())
        module = VAEModel(CFG)
        jparams = _jax_vae_params()
    elif family == "disc":
        ref = _torch_disc_replica(DISC_LAYERS, 64)
        # BatchNorm statistics as a trained reference file holds them
        sd = {f"main.{k}": v.clone() for k, v in ref.state_dict().items()}
        for k in sd:
            if k.endswith(("running_mean", "running_var")):
                sd[k].uniform_(0.5, 1.5)
        module = PatchDiscriminator(n_layers=DISC_LAYERS)
        jparams = JDisc(n_layers=DISC_LAYERS).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 1, 3, 64, 64)))
    else:
        cfg = CFG.replace(**DIT_OVR)
        module = DiTModel(cfg)
        sd = {k: torch.randn(v.shape) for k, v in module.state_dict().items()}
        jcfg = JCFG.replace(**DIT_OVR)
        jparams = JDiT(jcfg).init(
            jax.random.PRNGKey(0),
            jnp.zeros((1, jcfg.in_channels, 8, 8)),
            jnp.zeros((1, jcfg.text_embed_dim, 16, 16)),
            jnp.zeros((1,), jnp.int32))
    path = str(tmp_path / f"{family}.safetensors")
    save_torch_st({k: v.contiguous() for k, v in sd.items()}, path)
    cfg = CFG.replace(**DIT_OVR) if family == "dit" else CFG
    loaded, stats = checkpoint.load_params_any(path, module, cfg,
                                               verbose=False)
    assert stats["restored"] == len(module.state_dict())
    assert not stats["missing"] and not stats["mismatched"]
    assert not stats["unused"]
    names = convert.reference_key_map(module)
    for n, t in loaded.items():
        assert torch.equal(t, sd[names[n]]), n

    if family == "disc":
        j_loaded = jckpt.load_params_any(path, jparams, JCFG, verbose=False)
    else:
        j_loaded = jckpt.load_params_any(
            path, jparams, JCFG.replace(**DIT_OVR) if family == "dit"
            else JCFG, verbose=False)
    via_jax = convert.convert(_np_tree(j_loaded), module,
                              convert.key_map_for(module, cfg))
    for n, t in loaded.items():
        assert torch.equal(t, via_jax[n]), n

    if family == "vae":
        decode = VAEModel(CFG, with_encoder=False)
        d_loaded, d_stats = checkpoint.load_params_any(path, decode, CFG,
                                                       verbose=False)
        assert not d_stats["missing"] and not d_stats["mismatched"]
        for n, t in d_loaded.items():
            assert torch.equal(t, loaded[n]), n


def test_msgpack_params_load_into_the_port(tmp_path):
    """A bare parameter tree and a tree wrapped as a train state's
    ``params`` (both written by the JAX ``save_checkpoint``) read into the
    port's VAE equal to ``convert.convert_vae`` of the tree, and a
    reference file of another model raises."""
    jparams = _np_tree(_jax_vae_params())
    want = convert.convert_vae(jparams, VAEModel(CFG), CFG)
    for name, state in (("bare", jparams),
                        ("inner", jparams["params"]),
                        ("train", {"params": jparams, "step": 3})):
        path = str(tmp_path / f"{name}.msgpack")
        jckpt.save_checkpoint(path, state)
        loaded, stats = checkpoint.load_params_any(path, VAEModel(CFG), CFG,
                                                   verbose=False)
        assert stats["restored"] == len(want), name
        for n, t in want.items():
            assert torch.equal(loaded[n], t), (name, n)
    disc = str(tmp_path / "disc.safetensors")
    save_torch_st({"main.0.weight": torch.zeros(4, 3, 3, 3)}, disc)
    with pytest.raises(ValueError, match="disc"):
        checkpoint.load_params_any(disc, VAEModel(CFG), CFG)
