"""The port's real-data path held against the JAX package on the CPU.

* The native decoder (``data/native_loader.py``, ``data/csrc/loader.cpp``)
  against the JAX package's native decoder (``native/loader.cpp``): exactly
  equal on JPEG and PNG files written here, at 1 and 4 threads.
* ``HGSDataset`` items against the JAX ones on item directories of the
  reference's layout written here, in both ``training`` modes.
* ``train_vae`` / ``train_dit`` on a 3-item ``train_list``, and
  ``shard_for_host`` over the item list.
* ``save_ply`` / ``load_ply`` and ``avatar.ply`` against the JAX functions
  and the JAX script's construction.
"""

import json
import os
import struct
import zlib
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch

from sigman_release_tpu.config import PRESETS as JPRESETS
from sigman_release_tpu.data import HGSDataset as JHGSDataset
from sigman_release_tpu.data import native_loader as jloader
from sigman_release_tpu.utils import ply as jply
from sigman_release_torch import inference, train_dit, train_vae
from sigman_release_torch.config import PRESETS
from sigman_release_torch.data import HGSDataset, shard_for_host
from sigman_release_torch.data import native_loader as tloader
from sigman_release_torch.utils import ply as tply

FIXTURES = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "torch_fixtures")
# items: float32 arrays from the same decode, the same resizes in other
# libraries (cv2 in the JAX package, PyTorch in the port)
ITEM_ATOL = 1e-6


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _png(w, h, depth, color, raw, extra=b"", interlace=0) -> bytes:
    """A PNG from its (filtered) scanlines, with extra chunks before IDAT."""
    head = struct.pack(">IIBBBBB", w, h, depth, color, 0, 0, interlace)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", head) + extra
            + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b""))


def _pack_bits(values, depth) -> bytes:
    bits = "".join(format(int(v), f"0{depth}b") for v in values)
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


@pytest.fixture(scope="module")
def image_files(tmp_path_factory):
    """JPEG and PNG files: cv2's (RGB, grey, RGBA, 16-bit, grey JPEG) and
    hand-written PNGs (a 4-bit palette with tRNS, 1- and 2-bit grey, an RGB
    colour key, Adam7 interlacing with Sub filters)."""
    d = tmp_path_factory.mktemp("images")
    rng = np.random.default_rng(0)
    smooth = cv2.GaussianBlur(
        rng.uniform(0, 255, (70, 50, 3)).astype(np.uint8), (7, 7), 3)
    files = {
        "rgb.jpg": smooth, "rgb.png": smooth, "grey.png": smooth[..., 0],
        "grey.jpg": smooth[..., 1],
        "rgba.png": np.concatenate(
            [smooth, rng.integers(0, 256, (70, 50, 1), dtype=np.uint8)], -1),
        "grey16.png": rng.uniform(0, 65535, (33, 41)).astype(np.uint16),
        "rgba16.png": rng.uniform(0, 65535, (33, 41, 4)).astype(np.uint16),
    }
    paths = []
    for name, img in files.items():
        paths.append(str(d / name))
        cv2.imwrite(paths[-1], img)
    w, h = 13, 7
    idx = rng.integers(0, 16, (h, w))
    plte = (_chunk(b"PLTE", bytes(rng.integers(0, 256, 48, dtype=np.uint8)))
            + _chunk(b"tRNS", bytes(rng.integers(0, 256, 10,
                                                  dtype=np.uint8))))
    g2, g1 = rng.integers(0, 4, (h, w)), rng.integers(0, 2, (h, w))
    rgb = rng.integers(0, 3, (h, w, 3)).astype(np.uint8)
    hand = {
        "palette4.png": _png(w, h, 4, 3, b"".join(
            b"\0" + _pack_bits(idx[y], 4) for y in range(h)), plte),
        "grey2_trns.png": _png(w, h, 2, 0, b"".join(
            b"\0" + _pack_bits(g2[y], 2) for y in range(h)),
            _chunk(b"tRNS", struct.pack(">H", 2))),
        "grey1.png": _png(w, h, 1, 0, b"".join(
            b"\0" + _pack_bits(g1[y], 1) for y in range(h))),
        "rgb_key.png": _png(w, h, 8, 2, b"".join(
            b"\0" + rgb[y].tobytes() for y in range(h)),
            _chunk(b"tRNS", struct.pack(">HHH", 1, 1, 1))),
    }
    img = rng.integers(0, 256, (h, w, 3)).astype(np.uint8)
    raw = b""
    for x0, y0, dx, dy in [(0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8),
                           (2, 0, 4, 4), (0, 2, 2, 4), (1, 0, 2, 2),
                           (0, 1, 1, 2)]:
        for row in img[y0::dy, x0::dx]:
            b = row.reshape(-1).astype(np.int32)
            f = b.copy()
            f[3:] = (b[3:] - b[:-3]) % 256
            raw += b"\1" + bytes(f.astype(np.uint8))
    hand["adam7.png"] = _png(w, h, 8, 2, raw, interlace=1)
    for name, data in hand.items():
        paths.append(str(d / name))
        with open(paths[-1], "wb") as f:
            f.write(data)
    return paths


def test_decoders_are_native():
    """The reference is the JAX package's native decoder (not its cv2
    path); the port's builds here on libjpeg."""
    assert jloader.native_available()
    assert tloader.native_available()
    assert tloader.jpeg_backend() == "libjpeg"


@pytest.mark.parametrize("h,w,c", [(96, 96, 3), (24, 24, 3), (40, 72, 3),
                                   (32, 32, 4), (50, 70, 1)],
                         ids=["up", "down", "non-square", "rgba", "grey"])
def test_decode_batch_equals_jax_native(image_files, h, w, c):
    """Every file, resized up / down / to a non-square frame, read as 1, 3
    or 4 channels (a grey PNG as 3, RGBA as 4): bit for bit, at 1 and 4
    threads."""
    for n_threads in (1, 4):
        out = tloader.decode_batch(image_files, h, w, c, n_threads=n_threads)
        ref = jloader.decode_batch(image_files, h, w, c, n_threads=n_threads)
        assert out.shape == (len(image_files), h, w, c)
        for p, a, b in zip(image_files, out, ref):
            np.testing.assert_array_equal(a, b, err_msg=p)
        assert out.max() > 0.1


def test_decode_bad_files(image_files, tmp_path):
    """A missing or undecodable file is a zero frame in a batch, and
    ``decode_image`` raises on it; threads do not change a result."""
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8 not a jpeg")
    paths = [image_files[0], str(tmp_path / "missing.png"), str(bad)]
    out = tloader.decode_batch(paths, 8, 8, 3, n_threads=4)
    assert out[0].max() > 0
    np.testing.assert_array_equal(out[1:], 0.0)
    with pytest.raises(IOError):
        tloader.decode_image(str(tmp_path / "missing.png"), 8, 8)
    one = tloader.decode_batch(image_files * 3, 16, 16, 3, n_threads=1)
    four = tloader.decode_batch(image_files * 3, 16, 16, 3, n_threads=4)
    np.testing.assert_array_equal(one, four)


def test_jpeg_fixture_decodes_to_its_committed_decode():
    """The 1024^2 JPEG fixture that ``chip_smoke.py`` decodes on the card
    against its committed CPU decode (libjpeg), and the JAX decoder."""
    path = os.path.join(FIXTURES, "hgs_view_1024.jpg")
    ref = np.load(os.path.join(FIXTURES, "hgs_view_1024_decode.npz"))["rgb"]
    out = tloader.decode_image(path, 1024, 1024, 3)
    np.testing.assert_array_equal(out, ref.astype(np.float32) / 255.0)
    np.testing.assert_array_equal(out, jloader.decode_image(path, 1024, 1024))


def write_item(d, rng, size, n_views=90, smplx=True, drop_view=None):
    """One item directory of the reference's layout
    (tests/test_native_loader.py's, with orbit cameras)."""
    for sub in ("rgb_map", "mask_map", "UV"):
        os.makedirs(os.path.join(d, sub), exist_ok=True)
    cams = {}
    for v in range(n_views):
        img = cv2.GaussianBlur(
            rng.uniform(0, 255, (size, size, 3)).astype(np.uint8), (7, 7), 3)
        cv2.imwrite(os.path.join(d, "rgb_map", f"{v:04d}.jpg"), img)
        cv2.imwrite(os.path.join(d, "mask_map", f"{v:04d}.png"),
                    (img[..., :1] > 100).astype(np.uint8) * 255)
        a = 2 * np.pi * v / n_views
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        if v != drop_view:
            cams[f"{v:04d}"] = {"R": R.tolist(), "T": [0.0, 0.1, 1.5]}
    cv2.imwrite(os.path.join(d, "UV", "smplxuv_albedo.png"),
                rng.uniform(0, 255, (size, size, 3)).astype(np.uint8))
    if smplx:
        np.savez(os.path.join(d, "smplx.npz"), **{
            k: rng.normal(0, 0.1, n) for k, n in [
                ("transl", 3), ("global_orient", 3), ("betas", 10),
                ("body_pose", 63), ("expression", 10),
                ("left_hand_pose", 45), ("right_hand_pose", 45),
                ("jaw_pose", 3), ("leye_pose", 3), ("reye_pose", 3)]})
    with open(os.path.join(d, "camera_full_calibration.json"), "w") as f:
        json.dump(cams, f)
    return d


def write_items(root, n, size, seed=0):
    """``n`` items (the second without ``smplx.npz``, the third without
    view 30 in its camera json) and their ``train_list``."""
    rng = np.random.default_rng(seed)
    dirs = [write_item(os.path.join(root, f"item{i}"), rng, size,
                       smplx=i != 1, drop_view=30 if i == 2 else None)
            for i in range(n)]
    np.save(os.path.join(root, "train_list.npy"), np.array(dirs))
    return dirs


@pytest.fixture(scope="module")
def items_64(tmp_path_factory):
    return write_items(str(tmp_path_factory.mktemp("hgs64")), 3, 64)


@pytest.fixture(scope="module")
def items_256(tmp_path_factory):
    return write_items(str(tmp_path_factory.mktemp("hgs256")), 3, 256,
                       seed=1)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("preset,fixture", [("test_tiny", "items_64"),
                                            ("vae_s", "items_256")])
def test_hgs_items_match_jax(request, preset, fixture, training):
    """Each item of ``HGSDataset`` against the JAX one (the same seed, read
    in order): arrays within 1e-6, the cameras exact, ``item`` equal;
    ``vae_s`` decodes its 256^2 views at 512 (input 256, output 512)."""
    dirs = request.getfixturevalue(fixture)
    ours = HGSDataset(PRESETS[preset], items=dirs, training=training, seed=3)
    ref = JHGSDataset(JPRESETS[preset], items=dirs, training=training, seed=3)
    for i in range(len(dirs)):
        a, b = ours[i], ref[i]
        assert set(a) == set(b) and a["item"] == b["item"] == dirs[i]
        for k in ("cam_view", "cam_view_proj", "cam_pos"):
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        for k in b:
            if k == "item":
                continue
            assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype, k
            np.testing.assert_allclose(a[k], b[k], atol=ITEM_ATOL, rtol=0,
                                       err_msg=f"{preset} item {i} {k}")
    assert np.abs(a["images_output"]).max() > 0.05
    np.testing.assert_array_equal(ours[1]["smpl_params"], 0.0)


def test_item_list_split_and_host_shards(items_64):
    """``train_list``: items 1, 2 train and item 0 is held out (each
    hundredth), as the trainers read them; ``shard_for_host`` gives each of
    two data ranks a disjoint share of the list."""
    cfg = PRESETS["test_tiny"].replace(
        synthetic_data=False,
        train_list=os.path.join(os.path.dirname(items_64[0]),
                                "train_list.npy"))
    train, held = train_vae.datasets(cfg)
    assert train.items == items_64[1:] and held.items == items_64[:1]
    many = [f"item{i}" for i in range(301)]
    shares = [shard_for_host(many, mesh=SimpleNamespace(data_index=r,
                                                        data_size=2))
              for r in range(2)]
    assert not set(shares[0]) & set(shares[1])
    assert sorted(shares[0] + shares[1]) == sorted(many)
    assert abs(len(shares[0]) - len(shares[1])) <= 1


def _metrics(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def test_train_vae_and_train_dit_on_items(items_64, tmp_path):
    """Both trainers at ``test_tiny`` over the 3-item list, one epoch (2
    steps on items 1 and 2), with the eval over item 0 at step 2: finite
    losses, a state file, the eval logged."""
    lst = os.path.join(os.path.dirname(items_64[0]), "train_list.npy")
    common = ["test_tiny", "--device", "cpu", "--synthetic_data", "false",
              "--train_list", lst, "--num_epochs", "1", "--eval_steps", "2",
              "--log_every", "1", "--num_workers", "2",
              "--workspace", str(tmp_path)]
    vae = train_vae.main(common)
    assert vae.step == 2 and (tmp_path / "vae_state.pt").exists()
    rows = _metrics(tmp_path / "vae_metrics.jsonl")
    losses = [r["loss"] for r in rows if "loss" in r]
    assert len(losses) == 2 and np.isfinite(losses).all()
    ev = [r for r in rows if "eval_psnr" in r]
    assert ev and all(np.isfinite(v) for v in ev[0].values())
    assert (tmp_path / "eval_0000002.png").exists()

    dit = train_dit.main(common + ["--num_inference_steps", "2"])
    assert dit.step == 2 and (tmp_path / "dit_state.pt").exists()
    rows = _metrics(tmp_path / "dit_metrics.jsonl")
    assert np.isfinite([r["loss"] for r in rows if "loss" in r]).all()
    ev = [r for r in rows if "eval_loss" in r]
    assert ev and np.isfinite([ev[0]["eval_loss"], ev[0]["sample_psnr"]]).all()


def _splats(n, seed=0):
    """[n,14] activated splats, a fifth of them under the opacity prune."""
    rng = np.random.default_rng(seed)
    g = np.concatenate([
        rng.normal(0, 0.5, (n, 3)), rng.uniform(0, 1, (n, 1)),
        rng.uniform(0.001, 0.05, (n, 3)), rng.normal(size=(n, 4)),
        rng.uniform(0, 1, (n, 3))], axis=1).astype(np.float32)
    g[::5, 3] = 0.001
    return g


def test_save_ply_writes_the_jax_bytes(tmp_path):
    g = _splats(257)
    kept = int((g[:, 3] >= 0.005).sum())
    assert kept < 257 - 50
    for compatible in (True, False):
        a, b = tmp_path / "port.ply", tmp_path / "jax.ply"
        assert (tply.save_ply(g, str(a), compatible=compatible)
                == jply.save_ply(g, str(b), compatible=compatible) == kept)
        assert a.read_bytes() == b.read_bytes()
        out = tply.load_ply(str(a), compatible=compatible)
        np.testing.assert_allclose(
            out, jply.load_ply(str(b), compatible=compatible), atol=1e-6,
            rtol=0)
        assert out.shape == (kept, 14)


def test_avatar_ply_is_the_jax_scripts_construction(tmp_path, monkeypatch):
    """``inference.main`` writes ``avatar.ply`` from the posed Gaussians as
    scripts/test_DiT.py:275-282 builds ``g14``: the same bytes as the JAX
    ``save_ply`` of that construction on the same arrays."""
    seen = {}
    call = inference.AvatarPipeline.__call__

    def keep(self, *a, **kw):
        seen["out"] = call(self, *a, **kw)
        return seen["out"]

    monkeypatch.setattr(inference.AvatarPipeline, "__call__", keep)
    res = inference.main(["--device", "cpu", "--steps", "1", "--num_views",
                          "2", "--out_dir", str(tmp_path)])
    out = seen["out"]
    defm = out["gaussians"]["position"].numpy()
    attrs = {k: v.numpy() for k, v in out["attrs"].items()}
    n = defm.shape[1]
    quat = np.zeros((n, 4), np.float32)
    quat[:, 0] = 1.0
    g14 = np.concatenate(
        [np.asarray(defm[0]), np.asarray(attrs["opacity"][0]),
         np.abs(np.asarray(attrs["scale"][0])) * 0.01 + 0.003,
         quat, np.asarray(attrs["rgb"][0])], axis=1,
    )
    jply.save_ply(g14, str(tmp_path / "ref.ply"))
    assert ((tmp_path / "avatar.ply").read_bytes()
            == (tmp_path / "ref.ply").read_bytes())
    assert res["ply_bytes"] == os.path.getsize(tmp_path / "avatar.ply")
    np.testing.assert_array_equal(
        inference.avatar_gaussians(defm, attrs), g14)
    assert torch.isfinite(torch.from_numpy(res["views"])).all()
