"""The PyTorch port's image -> avatar slice held against the JAX package on
CPU at ``test_tiny`` (f32), plus the port's import and device rules.

(g) The same weights (the JAX package's initialisation, carried over by
``convert.py``), the same initial noise (JAX's own draw, as numpy), the same
conditioning image, pose and cameras go through the JAX path of
``scripts/test_DiT.py`` (Pallas rasterizer in interpret mode) and through
``sigman_release_torch.inference.AvatarPipeline``.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sigman_release_tpu.body import smplx as jsmplx
from sigman_release_tpu.body import template as jtemplate
from sigman_release_tpu.body.deformer import GaussianDeformer as JDeformer
from sigman_release_tpu.config import PRESETS as JPRESETS
from sigman_release_tpu.diffusion.pipeline import SamplePipeline as JSampler
from sigman_release_tpu.models import vae as jvae
from sigman_release_tpu.models.dit import DiTModel as JDiT
from sigman_release_tpu.models.encoders import ViTFeatureEncoder as JViT
from sigman_release_tpu.renderer import GaussianRenderer as JRenderer
from sigman_release_torch import convert, inference
from sigman_release_torch.body import smplx as tsmplx
from sigman_release_torch.body import template as ttemplate
from sigman_release_torch.config import PRESETS

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 3


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


@pytest.fixture(scope="module")
def both_paths():
    jc, tc = JPRESETS["test_tiny"], PRESETS["test_tiny"]
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 1, (jc.input_size, jc.input_size, 3))
    image = inference.normalize_image(img, tc.input_size)
    vec = np.zeros((1, 188), np.float32)
    vec[0, 16:79] = rng.normal(0, 0.2, 63)
    cv, cvp = inference.orbit_rig(tc, 2)

    # ---- the JAX path (scripts/test_DiT.py main, single image) ------------
    enc = JViT(embed_dim=jc.text_embed_dim)
    enc_p = enc.init(jax.random.PRNGKey(1), jnp.zeros((1, 3, 64, 64)))
    dit = JDiT(jc)
    dit_p = dit.init(jax.random.PRNGKey(2),
                     jnp.zeros((1, jc.in_channels, jc.sample_height,
                                jc.sample_width)),
                     jnp.zeros((1, jc.text_embed_dim, 16, 16)),
                     jnp.zeros((1,), jnp.int32))
    vae = jvae.VAEModel(jc)
    vae_p = vae.init(jax.random.PRNGKey(0),
                     jnp.zeros((1, jc.uv_query_size, jc.uv_query_size,
                                jc.latent_channels)),
                     method=jvae.VAEModel.decode)
    key = jax.random.PRNGKey(3)
    shape = (1, jc.latent_channels, jc.sample_height, jc.sample_width)
    noise = np.array(jax.random.normal(key, shape))
    cond = enc.apply(enc_p, jnp.asarray(_np(image)))
    lat = JSampler(jc).sample_latents(
        lambda p, x, c, t: dit.apply(p, x, c, t), dit_p, cond, key,
        num_inference_steps=STEPS, guidance_scale=jc.guidance_scale)
    amap = vae.apply(vae_p, jnp.moveaxis(lat, 1, -1),
                     method=jvae.VAEModel.decode)
    jm = jsmplx.synthetic_body_model()
    jt = jtemplate.synthetic_template(jm)
    attrs = jvae.sample_gaussian_attrs(amap, jt.init_uv)
    deformer = JDeformer(jm, jt.init_faces, jt.init_spdir, jt.init_podir,
                         jt.init_lbsw, weight_mask=None)
    state = deformer.initialize()
    posed = deformer.prepare(state,
                             jsmplx.parse_param_vector(jnp.asarray(vec)))
    defm, tfs = deformer(state, posed, jt.init_pcd[None] + attrs["offset"])
    rot = jvae.compose_rotations(attrs["rot"], jt.init_rot, tfs)
    jout = JRenderer(jc, interpret=True, use_dense=False).render(
        {"position": defm, "opacity": attrs["opacity"],
         "scale": attrs["scale"], "cov3d": rot, "rgb": attrs["rgb"]},
        jnp.asarray(cv)[None], jnp.asarray(cvp)[None])
    jax_res = {"latents": lat, "attr_map": amap, "points": defm, "tfs": tfs,
               "image": jout["image"], "alpha": jout["alpha"],
               "depth": jout["depth"], "overflow": jout["overflow"]}

    # ---- the port -----------------------------------------------------------
    tm = tsmplx.synthetic_body_model()
    pipe = inference.AvatarPipeline(tc, device="cpu", seed=0, body_model=tm,
                                    template=ttemplate.synthetic_template(tm))
    tree = jax.tree.map(np.asarray, {"vae": vae_p, "dit": dit_p,
                                     "enc": enc_p})
    pipe.load_state_dicts(
        vae=convert.convert_vae_decode(tree["vae"], pipe.vae, tc),
        dit=convert.convert_dit(tree["dit"], pipe.dit, tc),
        encoder=convert.convert_vit(tree["enc"], pipe.encoder))
    out = pipe(image, torch.from_numpy(vec), torch.from_numpy(cv),
               torch.from_numpy(cvp), noise=torch.from_numpy(noise),
               steps=STEPS)
    r = out["render"]
    port_res = {"latents": out["latents"], "attr_map": out["attr_map"],
                "points": out["gaussians"]["position"], "tfs": out["tfs"],
                "image": r["image"], "alpha": r["alpha"],
                "depth": r["depth"], "overflow": r["overflow"]}
    return ({k: _np(v) for k, v in jax_res.items()},
            {k: _np(v) for k, v in port_res.items()})


# f32 networks summed in other orders (1e-4, as the per-module tests); the
# points carry the decoded offsets' 1e-4, the transforms the voxel bake's
# spread (test_torch_body.py), the render the rasterizer's tolerance
# (test_torch_rasterizer.py) with the upstream differences on top
SLICE_ATOL = {"latents": 1e-4, "attr_map": 1e-4, "points": 1e-4,
              "tfs": 5e-5, "image": 1e-4, "alpha": 1e-4, "depth": 2e-4}


@pytest.mark.parametrize("name", sorted(SLICE_ATOL))
def test_slice_matches_jax(both_paths, name):
    """(g) latents, attribute map, posed points, transforms and the views."""
    ref, out = both_paths
    assert out[name].shape == ref[name].shape
    assert np.isfinite(out[name]).all()
    np.testing.assert_allclose(out[name], ref[name], atol=SLICE_ATOL[name])


def test_slice_renders_the_avatar(both_paths):
    ref, out = both_paths
    assert out["overflow"].tolist() == ref["overflow"].tolist()
    assert out["alpha"].max() > 0.5


def test_port_imports_without_jax():
    """(h) the package and every module of it import with jax blocked."""
    code = (
        "import sys, pkgutil, importlib\n"
        "for m in ('jax', 'jaxlib', 'flax', 'optax', 'sigman_release_tpu'):\n"
        "    sys.modules[m] = None\n"
        "import sigman_release_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.strip() == "ok", res.stderr


def test_port_sources_name_no_jax():
    """(h) no file of the port names jax, Flax, optax or the JAX package."""
    files = []
    for d, _, names in os.walk(os.path.join(ROOT, "sigman_release_torch")):
        files += [os.path.join(d, n) for n in names
                  if n.endswith((".py", ".cu", ".cuh"))]
    assert len(files) > 20
    for f in files:
        with open(f) as fh:
            text = fh.read()
        for word in ("jax", "flax", "optax", "sigman_release_tpu"):
            assert word not in text, f"{f} names {word}"


def test_entry_points_raise_without_cuda(monkeypatch):
    """(i) without CUDA, the entry points raise unless told device='cpu'."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.AvatarPipeline(PRESETS["test_tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        inference.main(["--preset", "test_tiny"])
    from sigman_release_torch import train_vae
    from sigman_release_torch.training.vae_trainer import VAETrainer
    with pytest.raises(RuntimeError, match="CUDA"):
        VAETrainer(PRESETS["test_tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        train_vae.main(["test_tiny"])
    from sigman_release_torch import train_dit
    from sigman_release_torch.training.dit_trainer import DiTTrainer
    with pytest.raises(RuntimeError, match="CUDA"):
        train_dit.main(["test_tiny"])
    with pytest.raises(RuntimeError, match="CUDA"):
        DiTTrainer(PRESETS["test_tiny"], torch.nn.Identity(),
                   torch.nn.Identity())
    from sigman_release_torch.device import resolve_device
    assert resolve_device("cpu").type == "cpu"


def test_pose_and_camera_loaders_match_jax_script(tmp_path):
    """The port's copies of ``load_pose`` (single / sequence / AMASS npz) and
    ``load_camera_rig`` give the JAX script's arrays."""
    import json

    sys.path.insert(0, os.path.join(ROOT, "scripts"))
    import test_DiT

    rng = np.random.default_rng(0)
    single = {k: rng.normal(0, 0.1, d).astype(np.float32)
              for k, d in [("transl", 3), ("global_orient", 3), ("betas", 10),
                           ("body_pose", 63), ("expression", 10),
                           ("left_hand_pose", 45), ("right_hand_pose", 45),
                           ("jaw_pose", 3), ("leye_pose", 3),
                           ("reye_pose", 3)]}
    np.savez(tmp_path / "single.npz", **single)
    np.savez(tmp_path / "seq.npz",
             **{k: np.stack([v, v * 0.5]) for k, v in single.items()})
    T = 3
    np.savez(tmp_path / "amass.npz",
             trans=rng.normal(0, 0.1, (T, 3)), root_orient=rng.normal(
                 0, 0.1, (T, 3)), betas=rng.normal(0, 0.1, 16),
             pose_body=rng.normal(0, 0.1, (T, 63)),
             pose_hand=rng.normal(0, 0.1, (T, 90)),
             pose_jaw=rng.normal(0, 0.1, (T, 3)),
             pose_eye=rng.normal(0, 0.1, (T, 6)))
    for name, frame in (("single.npz", 0), ("seq.npz", 1), ("amass.npz", 2)):
        path = str(tmp_path / name)
        np.testing.assert_array_equal(inference.load_pose(path, frame),
                                      test_DiT.load_pose(path, frame))
    cams = {f"{v:04d}": {"R": np.linalg.qr(rng.normal(size=(3, 3)))[0]
                         .tolist(), "T": rng.normal(size=3).tolist()}
            for v in inference.TEST_VIEW_IDS}
    with open(tmp_path / "cams.json", "w") as f:
        json.dump(cams, f)
    for a, b in zip(inference.load_camera_rig(str(tmp_path / "cams.json"),
                                              inference.TEST_VIEW_IDS,
                                              0.1, 100.0),
                    test_DiT.load_camera_rig(str(tmp_path / "cams.json"),
                                             test_DiT.TEST_VIEW_IDS,
                                             0.1, 100.0)):
        np.testing.assert_array_equal(a, b)


def test_inference_cli_writes_views(tmp_path):
    """``python -m sigman_release_torch.inference`` on the CPU with a .npy
    image: one PNG per view whose pixels are the saved views."""
    import struct
    import zlib

    img = np.random.default_rng(0).uniform(0, 1, (80, 80, 3))
    np.save(tmp_path / "img.npy", img.astype(np.float32))
    out = tmp_path / "out"
    inference.main(["--device", "cpu", "--preset", "test_tiny", "--steps",
                    "1", "--num_views", "2", "--image_path",
                    str(tmp_path / "img.npy"), "--out_dir", str(out)])
    views = np.load(out / "views.npy")
    assert views.shape == (2, 3, 32, 32) and np.isfinite(views).all()
    with open(out / "view_01.png", "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    w, h = struct.unpack(">II", data[16:24])
    n = struct.unpack(">I", data[33:37])[0]
    assert data[37:41] == b"IDAT"
    raw = np.frombuffer(zlib.decompress(data[41:41 + n]), np.uint8)
    rows = raw.reshape(h, 1 + 3 * w)
    assert (rows[:, 0] == 0).all()
    np.testing.assert_array_equal(
        rows[:, 1:].reshape(h, w, 3),
        (views[1].transpose(1, 2, 0) * 255).astype(np.uint8))
