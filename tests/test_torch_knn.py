"""The renderer's KNN base scale, ``ops/knn.mean_knn_dist2``: the plain
version on the CPU, the kernel ``ops/csrc/knn.cu`` on the card.

This file imports neither JAX nor the JAX package; its ``cuda``-marked
tests run on the card with

    python -m pytest --noconftest -m cuda tests/test_torch_knn.py
"""

import numpy as np
import pytest
import torch

from sigman_release_torch.config import PRESETS
from sigman_release_torch.ops.knn import mean_knn_dist2, mean_knn_dist2_plain
from sigman_release_torch.renderer import GaussianRenderer

# f32 unit roundoff: the expansion |q|^2 - 2 q.p + |p|^2 rounds each of its
# steps, so it is off the exact distance by a few units of |q|^2 + |p|^2
U = 2.0 ** -24


def cloud(batch: int, n: int, seed: int) -> torch.Tensor:
    """[batch, n, 3] f32: body-sized clouds away from the origin (so the
    expansion cancels), with exact and near duplicates (ties)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0.0, 1.0, (batch, n, 3)) * [0.15, 0.4, 0.08]
    x += [0.02, 0.3, -0.01]
    m = n // 10
    x[:, :m] = x[:, n - m:]                                 # duplicates
    x[:, m:2 * m] = x[:, n - 2 * m:n - m] + rng.normal(0.0, 1e-6, (batch, m, 3))
    return torch.from_numpy(x.astype(np.float32))


def expansion_bound(points: torch.Tensor) -> torch.Tensor:
    """16 U max(|q|^2 + |p|^2) per item: how far the expansion may sit
    from the exact distance, and so the mean of the 3 nearest (order
    statistics move no more than the values they are taken of)."""
    sq = (points.double() ** 2).sum(-1)
    return 16 * U * 2 * sq.amax(-1)


def exact_mean_knn_dist2(points: torch.Tensor) -> torch.Tensor:
    """f64 brute force over direct differences, [N,3] -> [N]."""
    x = points.double()
    d2 = ((x[:, None, :] - x[None, :, :]) ** 2).sum(-1)
    return torch.sort(d2, dim=-1).values[:, 1:4].mean(-1)


@pytest.mark.parametrize("batch,n,block", [(3, 1000, 4096), (2, 777, 100)])
def test_batched_plain_equals_the_per_item_stack(batch, n, block):
    pts = cloud(batch, n, seed=n)
    got = mean_knn_dist2(pts, block=block)
    assert got.shape == (batch, n)
    want = torch.stack([mean_knn_dist2_plain(p, block) for p in pts])
    assert torch.equal(got, want)
    assert torch.equal(mean_knn_dist2(pts[1], block=block), want[1])


@pytest.mark.parametrize("n", [4, 1500])
def test_plain_agrees_with_f64_within_the_expansion_rounding(n):
    pts = cloud(2, n, seed=7)
    got = mean_knn_dist2(pts).double()
    for b in range(2):
        err = (got[b] - exact_mean_knn_dist2(pts[b])).abs().max()
        assert err <= expansion_bound(pts[b]), err


def test_wrapper_rejects_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="at least 4"):
        mean_knn_dist2(torch.zeros(3, 3))
    with pytest.raises(ValueError, match="at least 4"):
        mean_knn_dist2(torch.zeros(2, 3, 3))
    with pytest.raises(ValueError, match="float32"):
        mean_knn_dist2(torch.zeros(8, 3, dtype=torch.float64))
    for shape in [(8,), (8, 2), (1, 2, 8, 3)]:
        with pytest.raises(ValueError, match=r"\[N, 3\]"):
            mean_knn_dist2(torch.zeros(shape))


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (on the card: python -m pytest "
                    "--noconftest -m cuda tests/test_torch_knn.py)")
    return torch.device("cuda")


def body_items(dev, batch=8, seed=0):
    """``batch`` items of the procedural body's 99,999 Gaussians (one a strip
    face), each moved by a small seeded offset (the network's, in the main
    path)."""
    from sigman_release_torch.body.smplx import synthetic_body_model
    from sigman_release_torch.body.template import synthetic_template

    body = synthetic_body_model(n_verts=100_001, seed=seed, device=dev)
    pcd = synthetic_template(body).init_pcd.to(dev, torch.float32)
    g = torch.Generator(device=dev).manual_seed(seed)
    off = 0.003 * torch.randn((batch, *pcd.shape), generator=g, device=dev)
    return (pcd[None] + off).contiguous()


def hold_kernel(pts: torch.Tensor):
    """The kernel against the plain version on the card, in one launch:
    equal bit for bit, since the kernel repeats the plain version's
    rounding step by step."""
    before = mean_knn_dist2.launches
    got = mean_knn_dist2(pts)
    assert mean_knn_dist2.launches == before + 1
    want = torch.stack([mean_knn_dist2_plain(p) for p in pts])
    torch.cuda.synchronize()
    assert got.shape == want.shape
    err = (got.double() - want.double()).abs().amax(-1)
    share = (got == want).double().mean().item()
    assert torch.equal(got, want), (
        f"{share} of the outputs equal; max |kernel - plain| per item {err}")


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_body(cuda_device):
    hold_kernel(body_items(cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [4, 1000, 4097, 65_537])
def test_kernel_matches_plain_at_ragged_n(cuda_device, n):
    hold_kernel(cloud(3, n, seed=n).to(cuda_device))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(cuda_device):
    pts = torch.zeros((8, 16, 3), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        mean_knn_dist2(pts.transpose(0, 1))
    with pytest.raises(ValueError, match="float32"):
        mean_knn_dist2(pts.half())


@pytest.mark.cuda
def test_one_render_of_eight_items_launches_the_kernel_once(cuda_device):
    from sigman_release_torch.inference import orbit_rig

    cfg = PRESETS["test_tiny"]
    b, n = 8, 2000
    g = torch.Generator(device=cuda_device).manual_seed(0)

    def draw(*shape):
        return torch.rand(shape, generator=g, device=cuda_device)

    gaussians = {
        "position": (draw(b, n, 3) - 0.5) * 0.6,
        "opacity": draw(b, n, 1),
        "scale": draw(b, n, 3) - 0.5,
        "rot": torch.eye(3, device=cuda_device).expand(b, n, 3, 3),
        "rgb": draw(b, n, 3),
    }
    cv, cvp = (torch.as_tensor(np.asarray(m), dtype=torch.float32,
                               device=cuda_device)[None].expand(b, -1, -1, -1)
               for m in orbit_rig(cfg, 2))
    before = mean_knn_dist2.launches
    out = GaussianRenderer(cfg).render(gaussians, cv, cvp)
    torch.cuda.synchronize()
    assert mean_knn_dist2.launches == before + 1
    assert out["image"].shape[:2] == (b, 2)
