"""The port's converter entry points held against the JAX package's on the
CPU: ``convert_reference_ckpt`` against ``scripts/convert_reference_ckpt.py``
(``main``, on reference safetensors written here) and ``convert_sapiens``
against ``scripts/convert_sapiens.py``'s ``convert`` (its ``main`` builds
the 1B encoder) through a depth-2 encoder, from a ``.pth`` state dict and
from a torchscript file. Each output is read back by the port's
``load_params_any``.
"""

import importlib.util
import os
import re
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import save_file
from torch import nn

from sigman_release_tpu.models.encoders import ViTFeatureEncoder as JViT
from sigman_release_tpu.training.checkpoint import save_checkpoint
from sigman_release_torch import convert, convert_reference_ckpt
from sigman_release_torch import convert_sapiens
from sigman_release_torch.config import PRESETS
from sigman_release_torch.losses.gan import PatchDiscriminator, disc_layers
from sigman_release_torch.models.dit import DiTModel
from sigman_release_torch.models.encoders import ViTFeatureEncoder
from sigman_release_torch.models.vae import VAEModel
from sigman_release_torch.training import checkpoint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = PRESETS["test_tiny"]


def _jax_script(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_script_{name}", os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _dropped(text):
    """The source keys a converter's report names as dropped."""
    return sorted(re.findall(r"unm\w+ \(dropped\): (\S+)", text, re.I))


def _module(family):
    torch.manual_seed(1)
    if family == "vae":
        return VAEModel(CFG)
    if family == "disc":
        return PatchDiscriminator(n_layers=disc_layers(CFG.output_size))
    return DiTModel(CFG)


# names a reference file holds besides the parameters: expected ones (the
# VAE's sincos table and UV coordinates, BatchNorm statistics) and others
EXTRA = {"vae": ["autoencoder.pos_embedding", "smplx_uvcoord",
                 "autoencoder.extra_head.weight"],
         "disc": ["main.3.running_mean", "main.3.running_var",
                  "main.3.num_batches_tracked", "main.99.weight"],
         "dit": ["pos_embed_extra", "transformer_blocks.0.extra.bias"]}


@pytest.mark.parametrize("family", ["vae", "disc", "dit"])
def test_convert_reference_ckpt_matches_the_jax_script(family, tmp_path,
                                                       monkeypatch, capsys):
    """A seeded reference-layout file (every parameter under its reference
    name, plus expected and unexpected extra names) through both scripts
    at ``test_tiny``, the family inferred: the JAX msgpack and the port's
    state file load (``load_params_any``) to equal state dicts, each
    tensor the file's; both reports name the same dropped keys; ``--check``
    writes nothing."""
    module = _module(family)
    names = convert.reference_key_map(module)
    rng = np.random.default_rng(0)
    sd = {names[k]: rng.normal(size=tuple(v.shape)).astype(np.float32)
          for k, v in module.state_dict().items()}
    for k in EXTRA[family]:
        sd[k] = (np.arange(3, dtype=np.int64) if k.endswith("tracked")
                 else rng.normal(size=(4,)).astype(np.float32))
    src = str(tmp_path / f"{family}.safetensors")
    save_file(sd, src)

    monkeypatch.setattr(sys, "argv", [
        "convert_reference_ckpt.py", "--ckpt", src, "--preset", "test_tiny",
        "--out", str(tmp_path / "jax.msgpack")])
    _jax_script("convert_reference_ckpt").main()
    jax_dropped = _dropped(capsys.readouterr().out)
    report = convert_reference_ckpt.main([
        "--ckpt", src, "--preset", "test_tiny", "--out",
        str(tmp_path / "port.pt")])
    port_dropped = _dropped(capsys.readouterr().out)
    unexpected = sorted(k for k in EXTRA[family]
                        if not k.startswith(("autoencoder.pos_embedding",
                                             "smplx_uvcoord"))
                        and not k.endswith(("running_mean", "running_var",
                                            "num_batches_tracked")))
    assert port_dropped == jax_dropped == report["unmapped"] == unexpected
    assert not report["missing"] and not report["mismatches"]
    assert checkpoint.port_entries(str(tmp_path / "port.pt")) == [
        dict(checkpoint.PORT_ENTRIES)[type(module).__name__]]

    a, sa = checkpoint.load_params_any(str(tmp_path / "jax.msgpack"),
                                       module, CFG, verbose=False)
    b, sb = checkpoint.load_params_any(str(tmp_path / "port.pt"), module,
                                       CFG, verbose=False)
    assert not sa["missing"] and not sb["missing"] and not sb["unused"]
    for k in module.state_dict():
        assert torch.equal(a[k], b[k]), k
        assert np.array_equal(b[k].numpy(), sd[names[k]]), k

    check = convert_reference_ckpt.main([
        "--ckpt", src, "--preset", "test_tiny", "--check", "--out",
        str(tmp_path / "none.pt")])
    assert check == report and not (tmp_path / "none.pt").exists()


def test_convert_reference_ckpt_reports_missing_and_mismatched(tmp_path):
    """A VAE file that lacks a parameter and holds one of another shape:
    both are reported, and the state file holds neither."""
    module = _module("vae")
    names = convert.reference_key_map(module)
    sd = {names[k]: v.numpy() for k, v in module.state_dict().items()}
    gone = names["autoencoder.projection.weight"]
    bent = names["autoencoder.decoder.conv_out.bias"]
    del sd[gone]
    sd[bent] = np.zeros(5, np.float32)
    src = str(tmp_path / "vae.safetensors")
    save_file(sd, src)
    out = str(tmp_path / "vae.pt")
    report = convert_reference_ckpt.main(["--ckpt", src, "--preset",
                                          "test_tiny", "--out", out])
    assert report["missing"] == ["autoencoder.projection.weight"]
    assert [m.split(":")[0] for m in report["mismatches"]] == [
        "autoencoder.decoder.conv_out.bias"]
    weights = checkpoint.load_torch(out)["vae"]
    assert "autoencoder.projection.weight" not in weights
    assert "autoencoder.decoder.conv_out.bias" not in weights


# ------------------------------------------------------------------ Sapiens

D, DEPTH, HEADS, GRID = 48, 2, 4, 4


class _Layer(nn.Module):
    """One mmpretrain ``TransformerEncoderLayer``'s parameters."""

    def __init__(self):
        super().__init__()
        self.ln1, self.ln2 = nn.LayerNorm(D), nn.LayerNorm(D)
        self.attn = nn.Module()
        self.attn.qkv, self.attn.proj = nn.Linear(D, 3 * D), nn.Linear(D, D)
        self.ffn = nn.Module()
        self.ffn.layers = nn.Sequential(nn.Sequential(nn.Linear(D, 4 * D)),
                                        nn.Linear(4 * D, D))


class _Backbone(nn.Module):
    """An mmpretrain VisionTransformer's parameter names (under
    ``backbone.``), with a class token and a classifier head the converter
    does not take."""

    def __init__(self):
        super().__init__()
        self.backbone = nn.Module()
        b = self.backbone
        b.patch_embed = nn.Module()
        b.patch_embed.projection = nn.Conv2d(3, D, 16, stride=16)
        b.pos_embed = nn.Parameter(torch.randn(1, GRID * GRID + 1, D))
        b.cls_token = nn.Parameter(torch.randn(1, 1, D))
        b.layers = nn.ModuleList(_Layer() for _ in range(DEPTH))
        b.ln1 = nn.LayerNorm(D)
        self.head = nn.Linear(D, 3)

    def forward(self, x):
        return x


@pytest.fixture(scope="module")
def sapiens_files(tmp_path_factory):
    """The same seeded weights as a ``.pth`` state dict and as a
    torchscript file."""
    d = tmp_path_factory.mktemp("sapiens")
    torch.manual_seed(0)
    src = _Backbone()
    with torch.no_grad():
        for p in src.parameters():
            p.normal_()
    pth, ts = str(d / "sapiens.pth"), str(d / "sapiens.pt2")
    torch.save(src.state_dict(), pth)
    torch.jit.save(torch.jit.script(src), ts)
    return src.state_dict(), pth, ts


def _port_encoder():
    return ViTFeatureEncoder(embed_dim=D, depth=DEPTH, heads=HEADS,
                             patch_size=16, learned_pos=True,
                             learned_pos_tokens=GRID * GRID)


@pytest.mark.parametrize("kind", ["pth", "torchscript"])
def test_convert_sapiens_matches_the_jax_convert(sapiens_files, kind,
                                                 tmp_path, capsys):
    """``convert_sapiens --ckpt --out`` with a depth-2 encoder against the
    JAX script's ``convert`` into the same geometry, saved as msgpack: both
    files load (``load_params_any``) to equal state dicts, each tensor the
    source's (qkv split, the class-token position dropped); both name the
    same unmatched keys; ``--check`` returns the same stats and writes
    nothing; only the port's file is a port state file."""
    sd, pth, ts = sapiens_files
    path = pth if kind == "pth" else ts
    js = _jax_script("convert_sapiens")
    jenc = JViT(embed_dim=D, depth=DEPTH, heads=HEADS, patch_size=16,
                learned_pos=True, learned_pos_tokens=GRID * GRID)
    params = jax.jit(jenc.init)(jax.random.PRNGKey(0),
                                jnp.zeros((1, 3, 64, 64)))
    jtree, jstats = js.convert(js.load_source(path), params, heads=HEADS)
    jax_dropped = _dropped(capsys.readouterr().out)
    save_checkpoint(str(tmp_path / "jax.msgpack"), jtree)

    enc = _port_encoder()
    out = str(tmp_path / "port.pt")
    stats = convert_sapiens.main(["--ckpt", path, "--out", out], encoder=enc)
    port_dropped = _dropped(capsys.readouterr().out)
    assert port_dropped == jax_dropped == stats["unmatched"] == sorted(
        jstats["unmatched"]) == ["backbone.cls_token", "head.bias",
                                 "head.weight"]
    assert not stats["missing"] and not stats["mismatches"]
    assert checkpoint.port_entries(out) == ["encoder"]
    assert checkpoint.port_entries(path) == []
    assert checkpoint.port_entries(str(tmp_path / "jax.msgpack")) == []

    a, sa = checkpoint.load_params_any(str(tmp_path / "jax.msgpack"), enc,
                                       CFG, verbose=False)
    b, sb = checkpoint.load_params_any(out, enc, CFG, verbose=False)
    assert not sa["missing"] and not sb["missing"] and not sb["unused"]
    for k in enc.state_dict():
        assert torch.equal(a[k], b[k]), k
    qkv = sd["backbone.layers.1.attn.qkv.weight"]
    assert torch.equal(b["blocks.1.attn.key.weight"], qkv[D:2 * D])
    assert torch.equal(b["pos_embed"], sd["backbone.pos_embed"][:, 1:])

    check = convert_sapiens.main(["--ckpt", path, "--check", "--out",
                                  str(tmp_path / "none.pt")], encoder=enc)
    assert check == stats and not (tmp_path / "none.pt").exists()


def test_convert_sapiens_defaults_to_the_1b_geometry(sapiens_files):
    """Without ``encoder=`` the target is the Sapiens-1B geometry (on the
    meta device): a depth-2 width-48 source converts nothing and the
    report names every 1B parameter missing."""
    _, pth, _ = sapiens_files
    stats = convert_sapiens.main(["--ckpt", pth, "--check"])
    assert stats["converted"] == 0
    assert len(stats["mismatches"]) > 0
    assert "blocks.39.ffn2.weight" in stats["missing"]
