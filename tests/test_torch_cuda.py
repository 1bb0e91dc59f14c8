"""The port's CUDA kernels on the card (``cuda``-marked; skipped without one).

This file imports neither JAX nor the JAX package, so it also runs where
only PyTorch and the CUDA toolkit are installed:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

The CPU tests hold the kernel's plain version against the JAX package; here
the kernels are held against their plain versions.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (DDP_LOSS_TOL, K1_TOL, K2_BF16_TOL, K2_TOL,
                        SMALL_GRAD_TOL, SMALL_LOSS_TOL, WORLD1_TOL, _pair_rows,
                        cull_cases, grad_tiles, hand_streams, k1_diff,
                        k2_bf16_excess, k2_diff, small_dit_step_diff,
                        small_train_step_diff)
from sigman_release_torch.ops.rasterizer import backward_tiles as k2
from sigman_release_torch.ops.rasterizer import forward_tiles as k1
from sigman_release_torch.ops.rasterizer import (
    RasterizeConfig,
    build_cov3d,
    rasterize_single,
)
from sigman_release_torch.ops.rasterizer.binning import ALPHA_MIN

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda.py)")
    return torch.device("cuda")


def test_forward_tiles_kernel_matches_plain(cuda_device):
    """Hand-made streams: empty tile, chunk-straddling segment, saturation,
    a Gaussian centred on a pixel (1e-4), and the launch counter."""
    pairs, start, count = hand_streams(np.random.default_rng(1))
    args = [torch.from_numpy(a).to(cuda_device) for a in (pairs, start, count)]
    kw = dict(ntx=2, tiles_per_view=4, chunk=128)
    before = k1.forward_tiles.launches
    out = k1.forward_tiles(*args, **kw)
    assert k1.forward_tiles.launches == before + 1
    ref = k1.forward_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    assert (out - ref).abs().max().item() <= 1e-4


def test_forward_tiles_rejects_bad_inputs(cuda_device):
    pairs = torch.zeros((128, 16), device=cuda_device)
    idx = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="float32"):
        k1.forward_tiles(pairs.double(), idx, idx, ntx=1, tiles_per_view=1)
    with pytest.raises(ValueError, match="int32"):
        k1.forward_tiles(pairs, idx.long(), idx, ntx=1, tiles_per_view=1)
    with pytest.raises(ValueError, match="contiguous"):
        k1.forward_tiles(torch.zeros((16, 128), device=cuda_device).T, idx,
                         idx, ntx=1, tiles_per_view=1)


def test_rasterize_single_cuda_matches_cpu(cuda_device):
    """A random 300-Gaussian scene, 3 views at 96 px: the CUDA path (kernel)
    against the CPU path (plain version) on the same inputs."""
    rng = np.random.default_rng(0)
    n = 300
    means = rng.normal(0, 0.4, (n, 3)).astype(np.float32)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    rot = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                    2 * (x * z + w * y), 2 * (x * y + w * z),
                    1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
                    2 * (x * z - w * y), 2 * (y * z + w * x),
                    1 - 2 * (x * x + y * y)], -1).reshape(n, 3, 3)
    scales = rng.uniform(0.02, 0.08, (n, 3))
    colors = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    opacity = rng.uniform(0.2, 0.95, n).astype(np.float32)
    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.inference import orbit_rig

    cv, cvp = orbit_rig(PRESETS["test_tiny"], 3)
    cfg = RasterizeConfig(img_h=96, img_w=96)
    outs = []
    for dev in ("cpu", cuda_device):
        def t(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)
        cov = build_cov3d(t(scales), t(rot))
        outs.append(rasterize_single(t(means), cov, t(colors), t(opacity),
                                     t(cv), t(cvp), torch.ones(3, device=dev),
                                     cfg))
    for k in ("image", "alpha", "depth"):
        diff = (outs[1][k].cpu() - outs[0][k]).abs().max().item()
        assert diff <= 1e-4, (k, diff)
    assert outs[1]["alpha"].max().item() > 0.5


def test_backward_tiles_kernel_matches_plain(cuda_device):
    """Hand-made streams with seeded upstream gradients: per-column relative
    1e-4 (chip_smoke.K2_TOL), zero rows past saturation, the counter."""
    rng = np.random.default_rng(1)
    pairs, start, count = hand_streams(rng)
    args = [torch.from_numpy(a).to(cuda_device) for a in (pairs, start, count)]
    kw = dict(ntx=2, tiles_per_view=4, chunk=128)
    fwd = k1.forward_tiles(*args, **kw)
    grad = torch.from_numpy(grad_tiles(rng, start.shape[0])).to(cuda_device)
    before = k2.backward_tiles.launches
    out = k2.backward_tiles(*args, fwd, grad, **kw)
    assert k2.backward_tiles.launches == before + 1
    ref = k2.backward_tiles_plain(*args, fwd, grad, **kw)
    torch.cuda.synchronize()
    assert k2_diff(out, ref)[1] <= K2_TOL
    end = int(start[2] + count[2])
    assert (out[end - 5:end] == 0).all() and (out[:, 10:] == 0).all()
    # bit-for-bit repeatable: fixed reduction order, no atomics
    assert torch.equal(out, k2.backward_tiles(*args, fwd, grad, **kw))


@pytest.mark.parametrize("case", ["staggered_saturation", "whole_tile",
                                  "one_warp", "longest_first"])
def test_kernels_match_plain_on_cull_cases(cuda_device, case):
    """chip_smoke.cull_cases: pixel rows (and so warps) that saturate at
    different depths, a Gaussian over the whole tile (every mask bit set),
    one confined to one warp's rectangle, segments of 0-700 pairs launched
    longest first. K1 within 1e-4 of its plain version, K2 within K2_TOL per
    column and bit for bit repeatable."""
    rng = np.random.default_rng(3)
    pairs, start, count, ntx, tpv = cull_cases(rng)[case]
    args = [torch.from_numpy(a).to(cuda_device) for a in (pairs, start, count)]
    kw = dict(ntx=ntx, tiles_per_view=tpv, chunk=128)
    fwd = k1.forward_tiles(*args, **kw)
    ref = k1.forward_tiles_plain(*args, **kw)
    grad = torch.from_numpy(grad_tiles(rng, start.shape[0])).to(cuda_device)
    out = k2.backward_tiles(*args, fwd, grad, **kw)
    ref2 = k2.backward_tiles_plain(*args, fwd, grad, **kw)
    torch.cuda.synchronize()
    assert k1_diff(fwd, ref) <= K1_TOL
    assert k2_diff(out, ref2)[1] <= K2_TOL
    assert torch.equal(out, k2.backward_tiles(*args, fwd, grad, **kw))
    if case == "staggered_saturation":   # some rows saturate, some not
        assert (ref[0, 5] < 2e-4).any() and (ref[0, 5] > 1e-3).any()
    if case == "one_warp":
        assert out[int(start[0]), :10].abs().max().item() > 0
    if case == "longest_first":
        order = k1.launch_order(args[2]).long().cpu()
        assert (torch.from_numpy(count)[order].diff() <= 0).all()


@pytest.mark.parametrize("tile", [32, 16])
def test_cull_masks_on_the_card_cover_the_mirror(cuda_device, tile):
    """The kernels' cull (``cull_bits`` in csrc/tile_common.cuh, with its
    fast intrinsics and nvcc's contractions), read through the test entry
    point ``cull_masks_launch``, on seeded rows: means on and far off the
    tile, sigmas from 0.2 to 80 px, strong anisotropy, opacities from the
    floor up, 2% of conics not positive-definite. Each kernel mask is a
    superset of the PyTorch mirror's (``cull_rects``, which the CPU tests
    hold exact), every warp rectangle where ``_alpha`` gives a pixel
    alpha > 0 keeps its bit, and most bits are clear; a 16-px tile's masks
    use only its 8 rectangles' bits."""
    rng = np.random.default_rng(4)
    k = 8192
    rows = _pair_rows(rng.uniform(-120, 150, k), rng.uniform(-120, 150, k),
                      np.exp(rng.uniform(np.log(0.2), np.log(80), k)),
                      np.exp(rng.uniform(np.log(0.2), np.log(80), k)),
                      rng.uniform(-0.99, 0.99, k),
                      rng.uniform(ALPHA_MIN, 1.0, k), rng)
    broken = rng.random(k) < 0.02               # mostly not positive-definite
    rows[broken, 2:5] = rng.uniform(-1, 1, (int(broken.sum()), 3))
    origin = (tile * rng.integers(0, 128 // tile, (k, 2))).astype(np.float32)
    feats = torch.from_numpy(rows).to(cuda_device)
    orig = torch.from_numpy(origin).to(cuda_device)
    masks = torch.zeros(k, dtype=torch.int64, device=cuda_device)
    masks32 = torch.zeros(k, dtype=torch.int32, device=cuda_device)
    rc = k1._library().cull_masks_launch(
        feats.data_ptr(), orig.data_ptr(), masks32.data_ptr(), k, tile,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    masks = masks32.long() & 0xFFFFFFFF
    n_rects = (tile // 8) * (tile // 4)
    assert (masks >> n_rects == 0).all()
    bit = torch.arange(n_rects, device=cuda_device)
    kept = ((masks[:, None] >> bit) & 1).bool()             # [k, rect]
    mirror = k1.cull_rects(feats, orig[:, 0], orig[:, 1], tile)
    assert not (mirror & ~kept).any(), (mirror & ~kept).any(-1).nonzero()[:5]
    ox, oy = orig[:, :1], orig[:, 1:]
    _, _, basis = k1.pixel_frame(1, 1, 1, cuda_device, tile)
    alpha, _ = k1._alpha(feats[:, None], ox, oy, basis,
                         torch.ones((k, 1), dtype=torch.bool,
                                    device=cuda_device))
    hit = (k1.rect_view(alpha[:, 0], tile) > 0).any(-1)     # [k, rect]
    assert not (hit & ~kept).any()
    ca, cb, cc = feats[:, 2], feats[:, 3], feats[:, 4]
    not_pd = ~((ca > 0) & (cc > 0) & (ca * cc - cb * cb > 0))
    assert not_pd.sum().item() > 0 and kept[not_pd].all()
    assert kept.float().mean().item() < 0.5


def _streams(tile, rng):
    """The hand-made streams and the four cull cases at ``tile``, each
    (name, pairs, tile_start, tile_count, ntx, tiles_per_view)."""
    yield ("hand",) + hand_streams(rng, tile=tile) + (2, 4)
    for name, case in cull_cases(rng, tile=tile).items():
        yield (name,) + case


def _on_card(dev, *arrays):
    return [torch.from_numpy(a).to(dev) for a in arrays]


@pytest.mark.parametrize("tile", [16, 32])
def test_kernel_knobs_match_plain(cuda_device, tile):
    """K1 and K2 at ``tile`` on the hand-made streams (a segment that
    straddles chunks, a Gaussian on a tile edge) and the cull cases against
    their plain versions (K1_TOL; K2_TOL per column); with
    ``early_stop=False`` both give the same output bit for bit; K2's bf16
    output is its f32 output rounded to nearest even, and within one bf16
    rounding of the plain version (``K2_BF16_TOL``). The launches are
    counted by variant."""
    rng = np.random.default_rng(6)
    for name, pairs, start, count, ntx, tpv in _streams(tile, rng):
        args = _on_card(cuda_device, pairs, start, count)
        kw = dict(ntx=ntx, tiles_per_view=tpv, chunk=128, tile=tile)
        grad = torch.from_numpy(grad_tiles(rng, start.shape[0], tile)).to(
            cuda_device)
        v1 = dict(k1.forward_tiles.launches_by_variant)
        v2 = dict(k2.backward_tiles.launches_by_variant)
        fwd = k1.forward_tiles(*args, **kw)
        fwd_off = k1.forward_tiles(*args, early_stop=False, **kw)
        out = k2.backward_tiles(*args, fwd, grad, **kw)
        out_off = k2.backward_tiles(*args, fwd, grad, early_stop=False, **kw)
        out_bf16 = k2.backward_tiles(*args, fwd, grad, out_bf16=True, **kw)
        ref = k1.forward_tiles_plain(*args, **kw)
        ref2 = k2.backward_tiles_plain(*args, fwd, grad, **kw)
        torch.cuda.synchronize()
        assert k1_diff(fwd, ref) <= K1_TOL, name
        assert k2_diff(out, ref2)[1] <= K2_TOL, name
        assert torch.equal(fwd, fwd_off) and torch.equal(out, out_off), name
        assert out_bf16.dtype == torch.bfloat16
        assert torch.equal(out_bf16, out.to(torch.bfloat16)), name
        assert k2_bf16_excess(out_bf16, ref2) <= K2_BF16_TOL, name
        b1 = k1.forward_tiles.launches_by_variant
        b2 = k2.backward_tiles.launches_by_variant
        assert b1.get("early_stop_off", 0) == v1.get("early_stop_off", 0) + 1
        assert b2.get("bf16", 0) == v2.get("bf16", 0) + 1
        if tile == 16:
            assert b1["tile16"] == v1.get("tile16", 0) + 2
            assert b2["tile16"] == v2.get("tile16", 0) + 3
        if name == "hand":
            end = int(start[2] + count[2])
            assert (out[end - 5:end] == 0).all() and (out[:, 10:] == 0).all()
            # the Gaussian centred on pixel (5, 7) of tile 3
            assert fwd[3, 4, 7 * tile + 5].item() > 0.79


def test_kernels_reject_other_tiles(cuda_device):
    pairs = torch.zeros((128, 16), device=cuda_device)
    idx = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    tiles = torch.zeros((1, 8, 24 * 24), device=cuda_device)
    with pytest.raises(ValueError, match="tile must be one of"):
        k1.forward_tiles(pairs, idx, idx, ntx=1, tiles_per_view=1, tile=24)
    with pytest.raises(ValueError, match="tile must be one of"):
        k2.backward_tiles(pairs, idx, idx, tiles, tiles, ntx=1,
                          tiles_per_view=1, tile=24)


def test_backward_tiles_rejects_bad_inputs(cuda_device):
    pairs = torch.zeros((128, 16), device=cuda_device)
    idx = torch.zeros(1, dtype=torch.int32, device=cuda_device)
    tiles = torch.zeros((1, 8, 1024), device=cuda_device)
    kw = dict(ntx=1, tiles_per_view=1)
    with pytest.raises(ValueError, match="float32"):
        k2.backward_tiles(pairs.double(), idx, idx, tiles, tiles, **kw)
    with pytest.raises(ValueError, match="int32"):
        k2.backward_tiles(pairs, idx.long(), idx, tiles, tiles, **kw)
    with pytest.raises(ValueError, match="grad_tiles"):
        k2.backward_tiles(pairs, idx, idx, tiles, tiles[:, :5], **kw)
    with pytest.raises(ValueError, match="contiguous"):
        k2.backward_tiles(pairs, idx, idx, tiles,
                          tiles.transpose(1, 2).contiguous().transpose(1, 2),
                          **kw)


def test_vae_train_step_cuda_matches_cpu(cuda_device):
    """One test_tiny G step on the card against the CPU (the same weights,
    batch and noise, TF32 off; chip_smoke phase 9): loss 1e-4 relative,
    gradient 1e-3 relative L2; K2 launched."""
    before = k2.backward_tiles.launches
    loss_rel, grad_rel = small_train_step_diff(cuda_device)
    assert k2.backward_tiles.launches == before + 1
    assert loss_rel <= SMALL_LOSS_TOL and grad_rel <= SMALL_GRAD_TOL


def test_dit_train_step_cuda_matches_cpu(cuda_device):
    """One test_tiny DiT step (raw path, two items, one with its condition
    dropped) on the card against the CPU (the same weights, batch and
    draws, TF32 off; chip_smoke phase 11): loss 1e-4 relative, gradient
    1e-3 relative L2."""
    loss_rel, grad_rel = small_dit_step_diff(cuda_device)
    assert loss_rel <= SMALL_LOSS_TOL and grad_rel <= SMALL_GRAD_TOL


def test_ddp_at_world_size_one_matches_the_bare_steps(cuda_device, tmp_path):
    """A ``test_tiny`` VAE trainer under DDP over NCCL at world size 1 takes
    a G step and a D step (the GAN gate open) as a bare trainer does on the
    same weights, item and noise, held as ``chip_smoke.py`` phase 13 holds
    ``vae_b``: the G loss and the new weights within ``WORLD1_TOL`` plus
    twice what a second bare run differs by (the backward is not
    deterministic on the card), the D loss, which follows an update, within
    ``DDP_LOSS_TOL``."""
    import torch.distributed as dist

    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.data.dataset import SyntheticAvatarDataset
    from sigman_release_torch.parallel.mesh import make_mesh
    from sigman_release_torch.training.cases import ONE
    from sigman_release_torch.training.vae_trainer import VAETrainer

    cfg = PRESETS["test_tiny"].replace(disc_start=1, gradient_clip=1e4)
    item = SyntheticAvatarDataset(cfg, n_items=1)[0]
    raw = {k: v[None] for k, v in item.items() if k != "item"}
    noise = torch.from_numpy(np.random.default_rng(3).normal(
        size=(1, cfg.uv_query_size, cfg.uv_query_size,
              cfg.latent_channels)).astype(np.float32)).to(cuda_device)
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/rdv",
                            world_size=1, rank=0)
    try:
        runs = []
        for mesh in (ONE, ONE, make_mesh()):
            t = VAETrainer(cfg, device=cuda_device, mesh=mesh)
            assert (t.ddp_g is not None) == mesh.distributed
            b = t.to_device(raw)
            losses = [t.train_step_g(b, noise)["loss"].item(),
                      t.train_step_d(b, noise)["GAN_D"].item()]
            runs.append((np.array(losses), torch.cat([
                p.detach().flatten()
                for p in [*t.params_g, *t.disc.parameters()]]).double()))
    finally:
        dist.destroy_process_group()
    (bare_l, bare_w), (again_l, again_w), (ddp_l, ddp_w) = runs
    spread = np.abs(again_l - bare_l) / np.abs(bare_l)
    rel = np.abs(ddp_l - bare_l) / np.abs(bare_l)
    assert rel[0] <= WORLD1_TOL + 2 * spread[0]
    assert rel[1] <= DDP_LOSS_TOL
    w_spread = ((again_w - bare_w).norm() / bare_w.norm()).item()
    assert ((ddp_w - bare_w).norm() / bare_w.norm()).item() \
        <= WORLD1_TOL + 2 * w_spread


def test_prefetch_to_device_on_the_card(cuda_device):
    """Pinned host copies on a side stream: the batches arrive in order, on
    the card, equal to the host arrays."""
    from sigman_release_torch.parallel.mesh import prefetch_to_device
    from sigman_release_torch.training.cases import ONE

    batches = [{"x": np.full((2, 3, 64, 64), i, np.float32),
                "item": [f"i{i}"]} for i in range(6)]
    out = list(prefetch_to_device(iter(batches), ONE, cuda_device))
    torch.cuda.synchronize()
    assert len(out) == 6
    for i, b in enumerate(out):
        assert set(b) == {"x"} and b["x"].device.type == "cuda"
        assert torch.equal(b["x"].cpu(), torch.from_numpy(batches[i]["x"]))


def test_decoder_fixture_on_the_card(cuda_device):
    """The port's decoder as it builds on the card's machine (nvJPEG where
    libjpeg is missing) against the committed libjpeg decode of the 1024^2
    JPEG fixture: exactly on libjpeg, within ``NVJPEG_MAX_LEVELS`` (mean
    ``NVJPEG_MEAN_LEVELS``) on nvJPEG; a missing file is a zero frame and
    threads change nothing."""
    from chip_smoke import (FIXTURE_DECODE, FIXTURE_JPEG, NVJPEG_MAX_LEVELS,
                            NVJPEG_MEAN_LEVELS)
    from sigman_release_torch.data import native_loader

    ref = np.load(FIXTURE_DECODE)["rgb"].astype(np.float32)
    got = native_loader.decode_image(FIXTURE_JPEG, 1024, 1024, 3) * 255.0
    diff = np.abs(got - ref)
    if native_loader.jpeg_backend() == "libjpeg":
        assert diff.max() <= 1e-3
    else:
        assert diff.max() <= NVJPEG_MAX_LEVELS + 1e-3
        assert diff.mean() <= NVJPEG_MEAN_LEVELS
    one, four = (native_loader.decode_batch(
        [FIXTURE_JPEG] * 6 + ["/nonexistent.jpg"], 256, 256, 3, n_threads=n)
        for n in (1, 4))
    np.testing.assert_array_equal(one, four)
    assert (one[-1] == 0).all() and one[0].max() > 0.1


def test_render_free_kernels_match_plain(cuda_device, monkeypatch):
    """``render_free`` of 2,000 free Gaussians at 128^2 over 3 views with a
    seeded upstream gradient on the card: K1 once and K2 once, each held
    against its plain version on the stream it was given (``K1_TOL``;
    ``K2_TOL`` of each column's max); the gradients finite."""
    from chip_smoke import orbit_rig_tensors
    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.ops.rasterizer import render as render_lib
    from sigman_release_torch.renderer import GaussianRenderer

    rng = np.random.default_rng(5)
    n, views, hw = 2000, 3, 128
    q = rng.normal(size=(1, n, 4))
    g = {"position": rng.normal(0, 0.3, (1, n, 3)),
         "opacity": rng.uniform(0.2, 0.95, (1, n)),
         "scale": rng.uniform(0.005, 0.03, (1, n, 3)),
         "rotation": q / np.linalg.norm(q, axis=-1, keepdims=True),
         "rgb": rng.uniform(0, 1, (1, n, 3))}
    g = {k: torch.tensor(v, dtype=torch.float32, device=cuda_device,
                         requires_grad=True) for k, v in g.items()}
    cfg = PRESETS["test_tiny"].replace(output_size=hw)
    cv, cvp = orbit_rig_tensors(cfg, views, cuda_device)
    seen = {}
    real_f, real_b = render_lib.forward_tiles, render_lib.backward_tiles

    def fwd(*a, **kw):
        seen["k1"] = (a, kw)
        return real_f(*a, **kw)

    def bwd(*a, **kw):
        seen["k2"] = (a, kw)
        return real_b(*a, **kw)

    monkeypatch.setattr(render_lib, "forward_tiles", fwd)
    monkeypatch.setattr(render_lib, "backward_tiles", bwd)
    before = (k1.forward_tiles.launches, k2.backward_tiles.launches)
    out = GaussianRenderer(cfg).render_free(g, cv, cvp)
    up = torch.from_numpy(rng.normal(size=(1, views, 4, hw, hw)).astype(
        np.float32)).to(cuda_device)
    ((out["image"] * up[:, :, :3]).sum()
     + (out["alpha"] * up[:, :, 3:]).sum()).backward()
    torch.cuda.synchronize()
    assert (k1.forward_tiles.launches - before[0],
            k2.backward_tiles.launches - before[1]) == (1, 1)
    assert out["alpha"].max().item() > 0.5
    assert all(torch.isfinite(t.grad).all() for t in g.values())
    a, kw = seen["k1"]
    assert k1_diff(k1.forward_tiles(*a, **kw),
                   k1.forward_tiles_plain(*a, **kw)) <= K1_TOL
    a, kw = seen["k2"]
    assert k2_diff(k2.backward_tiles(*a, **kw),
                   k2.backward_tiles_plain(*a, **kw))[1] <= K2_TOL
