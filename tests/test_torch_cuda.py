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

from chip_smoke import (K1_TOL, K2_TOL, SMALL_GRAD_TOL, SMALL_LOSS_TOL,
                        _pair_rows, cull_cases, grad_tiles, hand_streams,
                        k1_diff, k2_diff, small_dit_step_diff,
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


def test_cull_masks_on_the_card_cover_the_mirror(cuda_device):
    """The kernels' cull (``cull_bits`` in csrc/tile_common.cuh, with its
    fast intrinsics and nvcc's contractions), read through the test entry
    point ``cull_masks_launch``, on seeded rows: means on and far off the
    tile, sigmas from 0.2 to 80 px, strong anisotropy, opacities from the
    floor up, 2% of conics not positive-definite. Each kernel mask is a
    superset of the PyTorch mirror's (``cull_rects``, which the CPU tests
    hold exact), every warp rectangle where ``_alpha`` gives a pixel
    alpha > 0 keeps its bit, and most bits are clear."""
    rng = np.random.default_rng(4)
    k = 8192
    rows = _pair_rows(rng.uniform(-120, 150, k), rng.uniform(-120, 150, k),
                      np.exp(rng.uniform(np.log(0.2), np.log(80), k)),
                      np.exp(rng.uniform(np.log(0.2), np.log(80), k)),
                      rng.uniform(-0.99, 0.99, k),
                      rng.uniform(ALPHA_MIN, 1.0, k), rng)
    broken = rng.random(k) < 0.02               # mostly not positive-definite
    rows[broken, 2:5] = rng.uniform(-1, 1, (int(broken.sum()), 3))
    origin = (32 * rng.integers(0, 4, (k, 2))).astype(np.float32)
    feats = torch.from_numpy(rows).to(cuda_device)
    orig = torch.from_numpy(origin).to(cuda_device)
    masks = torch.zeros(k, dtype=torch.int32, device=cuda_device)
    rc = k1._library().cull_masks_launch(
        feats.data_ptr(), orig.data_ptr(), masks.data_ptr(), k,
        torch.cuda.current_stream().cuda_stream)
    assert rc == 0
    bit = torch.arange(32, device=cuda_device)
    kept = ((masks[:, None] >> bit) & 1).bool()             # [k, rect]
    mirror = k1.cull_rects(feats, orig[:, 0], orig[:, 1])
    assert not (mirror & ~kept).any(), (mirror & ~kept).any(-1).nonzero()[:5]
    ox, oy = orig[:, :1], orig[:, 1:]
    _, _, basis = k1.pixel_frame(1, 1, 1, cuda_device)
    alpha, _ = k1._alpha(feats[:, None], ox, oy, basis,
                         torch.ones((k, 1), dtype=torch.bool,
                                    device=cuda_device))
    hit = (k1.rect_view(alpha[:, 0]) > 0).any(-1)           # [k, rect]
    assert not (hit & ~kept).any()
    ca, cb, cc = feats[:, 2], feats[:, 3], feats[:, 4]
    not_pd = ~((ca > 0) & (cc > 0) & (ca * cc - cb * cb > 0))
    assert not_pd.sum().item() > 0 and kept[not_pd].all()
    assert kept.float().mean().item() < 0.5


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
