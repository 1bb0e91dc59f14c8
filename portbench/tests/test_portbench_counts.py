"""The benchmark's own arithmetic on hand-made inputs: FLOP counts, the
union of kernel intervals, the kernels' least times, the plain renderer's
work counts."""

import math
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from portbench import bounds, flops, trace  # noqa: E402
from portbench.reference.config import PRESETS  # noqa: E402


def test_dit_flops_of_test_tiny_match_the_hand_count():
    """The meta-device count of the DiT's forward equals the shapes' hand
    count (``dit_step_flops``, the port's formula)."""
    cfg = PRESETS["test_tiny"]
    B = 3
    side = cfg.input_size // 16
    cond_tokens = (side // 4) ** 2
    counted = flops.dit_parts(cfg, B, sapiens=False)["dit"]
    hand = flops.dit_step_flops(cfg, B, cond_tokens)["forward"]
    assert counted == pytest.approx(hand, rel=1e-9)


def test_conv_and_linear_flops_are_two_per_multiply_add():
    conv = flops.forward_flops(lambda: torch.nn.Conv2d(3, 8, 3, padding=1),
                               flops._meta(2, 3, 16, 16))
    assert conv == 2 * 2 * 8 * 16 * 16 * 3 * 3 * 3
    lin = flops.forward_flops(lambda: torch.nn.Linear(5, 7),
                              flops._meta(4, 5))
    assert lin == 2 * 4 * 5 * 7


def test_step_prices_count_trained_modules_three_times():
    cfg = PRESETS["test_tiny"]
    p = flops.vae_parts(cfg, 2)
    assert flops.vae_train_step(cfg, 2) == 3 * (
        p["vae_encode"] + p["vae_decode"] + p["lpips_side"])
    d = flops.dit_parts(cfg, 1, sapiens=False)
    dec = flops.vae_parts(cfg, 1)["vae_decode"]
    assert flops.serve_request(cfg) == (
        d["encoder"] + 2 * cfg.num_inference_steps * d["dit"] + dec)


@pytest.mark.parametrize("intervals, lo, hi, busy", [
    ([(0, 10), (5, 15), (20, 30)], float("-inf"), float("inf"), 25),
    ([(0, 10), (10, 12), (40, 50)], float("-inf"), float("inf"), 22),
    ([(0, 10), (5, 15), (20, 30)], 8, 25, 12),
    ([], 0, 10, 0),
    ([(0, 100)], 20, 30, 10),
])
def test_busy_us_is_the_union_of_the_intervals(intervals, lo, hi, busy):
    assert trace.busy_us(sorted(intervals), lo, hi) == busy


def test_idle_gaps_and_summary_shares():
    assert trace.gaps([(2, 4), (3, 6), (8, 9)], 0, 10) == [
        (0, 2), (6, 8), (9, 10)]
    s = trace.Summary()
    s.window_s, s.busy_s, s.units, s.flops_per_unit = 2.0, 1.5, 4, 1e12
    s.clean_s, s.profiled_units = 2.0, 4
    assert s.idle() == pytest.approx(25.0)
    s.window_s = 3.0             # a profiled window stretched on the host
    assert s.idle() == pytest.approx(25.0)
    assert s.mfu() == pytest.approx(100 * 4e12 / (2.0 * 989e12))
    s.kernels = {"forward_tiles_kernel<32, 4>": (0.004, 2),
                 "backward_tiles_kernel<32>": (0.01, 2)}
    s.bounds_s = {"forward_tiles": 0.001}
    assert s.roofline("forward_tiles") == pytest.approx(25.0)
    assert s.roofline("backward_tiles") is None
    s.spans = {"encoder": 3.0, "decoder": 2.0}
    assert s.span_ms("encoder", "decoder") == 5.0
    assert s.span_ms("knn") is None


def test_launch_bounds_by_hand():
    w = {"power_cut": 10, "floor_cut": 20, "contributing": 1_000_000,
         "saturating": 50_000, "rows": 20_000, "rows_contributing": 15_000,
         "tiles_hit": 100, "tiles": 256}
    b = bounds.launch_bounds_s(w)
    k1_ops = 1_000_000 * 28 + 50_000 * 19 + 20_000 * 18
    k1_exp = 1_050_000
    k1_bytes = 20_000 * 40 + 8 * 256 + 256 * 8 * 1024 * 4
    k1 = max(k1_bytes / 3.35e12, k1_ops / 67e12, k1_exp / (67e12 / 16))
    assert b["forward_tiles"] == pytest.approx(k1, rel=1e-12)
    k2_ops = 1_000_000 * 55 + 50_000 * 19 + 20_000 * 31
    k2_bytes = (20_000 * 40 + 15_000 * 40 + 100 * 10 * 1024 * 4 + 8 * 256)
    k2 = max(k2_bytes / 3.35e12, k2_ops / 67e12, k1_exp / (67e12 / 16))
    assert b["backward_tiles"] == pytest.approx(k2, rel=1e-12)


def _cloud(n, seed):
    g = torch.Generator().manual_seed(seed)
    means = torch.randn((n, 3), generator=g) * 0.3
    q = torch.nn.functional.normalize(torch.randn((n, 4), generator=g), dim=-1)
    from portbench.reference.ops.rotations import quaternion_to_matrix
    from portbench.reference.ops.rasterizer.preprocess import build_cov3d

    scales = torch.rand((n, 3), generator=g) * 0.05 + 0.01
    cov = build_cov3d(scales, quaternion_to_matrix(q))
    colors = torch.rand((n, 3), generator=g)
    opacity = torch.rand(n, generator=g) * 0.9 + 0.05
    return means, cov, colors, opacity


def _camera(size):
    import numpy as np

    from portbench.reference.geometry.cameras import (
        camera_bundle,
        orbit_camera,
        projection_matrix,
    )

    proj = projection_matrix(0.1, 100.0, 0.87, 0.87)
    cv, cvp, _ = camera_bundle(np.stack([orbit_camera(15, 30, 1.5)]), proj)
    return torch.as_tensor(cv), torch.as_tensor(cvp)


def test_plain_renderer_matches_every_gaussian_at_every_pixel():
    """The tiled plain renderer against a direct per-pixel composite of
    every Gaussian (the port's dense oracle's rules), image and gradient."""
    from sigman_release_torch.ops.rasterizer.reference import render_dense

    from portbench.reference import render as plain

    size = 48
    means, cov, colors, opacity = _cloud(60, 3)
    cv, cvp = _camera(size)
    t = math.tan(0.5 * 0.87)
    outs = []
    for fn in ("plain", "dense"):
        x = [a.clone().requires_grad_(True) for a in (means, cov, colors,
                                                       opacity)]
        if fn == "plain":
            img, alpha = plain.render_view(*x, cv[0], cvp[0], t, t, size,
                                           size, torch.ones(3))
        else:
            out = render_dense(*x, cv[0], cvp[0], t, t, size, size,
                               torch.ones(3), tile_size=0)
            img, alpha = out["image"], out["alpha"]
        (img * torch.linspace(0, 1, img.numel()).reshape(img.shape)).sum() \
            .backward()
        outs.append((img.detach(), alpha.detach(),
                     [a.grad.clone() for a in x]))
    (ip, ap, gp), (idn, ad, gd) = outs
    assert (ip - idn).abs().max() < 1e-5
    assert (ap - ad).abs().max() < 1e-5
    for a, b in zip(gp, gd):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max() + 1e-7


def test_work_counts_add_up():
    from portbench.reference import render as plain

    size = 64
    means, cov, colors, opacity = _cloud(80, 4)
    cv, cvp = _camera(size)
    t = math.tan(0.5 * 0.87)
    w = plain.work_counts(means, cov, colors, opacity, cv, cvp, t, t, size,
                          size)
    assert w["contributing"] > 0 and w["rows"] > 0
    assert w["rows_contributing"] <= w["rows"]
    assert 0 < w["tiles_hit"] <= w["tiles"] == (size // 32) ** 2
    # every pixel has at most one saturating evaluation
    assert w["saturating"] <= size * size
