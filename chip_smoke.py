#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the final line):

1. build   — compile every CUDA source of the port with nvcc (sm_90a), one
             process per source, all started together;
2. k1      — the ``forward_tiles`` kernel against its plain PyTorch version
             on hand-made pair streams (empty tile, chunk-straddling segment,
             saturating stack, a Gaussian centred on a pixel centre);
3. main    — image -> avatar inference at the ``dit`` preset's full width
             (DiT d=2048 x 30 layers, ViT at 1536, VAE decoder to a 512^2 UV
             map, 30 CFG DDIM steps in bf16) with seeded random weights, a
             seeded image and pose, 100,000 Gaussians from the procedural
             body model, rendered at 512^2 over 4 orbit views; kernel launch
             counts are zeroed before and read after;
4. plain   — the render stage of phase 3 again: K1 against its plain version
             on the main path's own pair stream, and the image through the
             plain version against phase 3's image;
5. small   — the whole path at ``test_tiny`` on the GPU against the same
             path on the CPU (same weights, noise and pose);
6. k2      — the ``backward_tiles`` kernel against its plain version on the
             hand-made streams with seeded upstream gradients;
7. train   — ``VAETrainer`` at the ``vae_b`` preset's full width (3D-conv
             encoder 128/256/256/512 over 6 input views of 9 channels at
             512^2, a 64x64 UV-query bottleneck of 6 layers of 8 x 64 heads,
             a 16-channel latent, decoder to a 64-channel 512^2 UV map,
             100,000 Gaussians, 10 supervised views at 512^2, LPIPS VGG16 at
             256, bf16, per-block remat) on one synthetic item: 3 generator
             steps and 1 discriminator step, launch counts zeroed before;
8. k2 main — K1 and K2 against their plain versions on the last generator
             step's own pair stream and upstream gradients, with their
             times (K2 also its launch alone, without the wrapper's zero
             fill) and bounds;
9. small train — one ``test_tiny`` generator step on the GPU against the
             CPU (same weights, batch and noise, TF32 off): loss and
             gradients.

Phases 2 and 6 also run ``cull_cases``; phases 4 and 8 print each stream's
segment lengths and (pair, warp) slots and both bounds (this one: the hits
plus a staging pass per row; without the cull: every needed evaluation).

Prints the card's name and power limit, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Needs no network and one card; exits
non-zero without CUDA.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores
# exp on the special-function units: 16 results per SM per clock against 256
# f32 flops (128 FMA lanes) at the same clock
H100_SFU_PER_S = H100_F32_FLOPS / 16
# (f32 operations, exps) of one (pair, pixel) evaluation of forward_tiles at
# a pixel not yet saturated, by how far down the kernel's inner loop it runs
# (FMA = 2, any other f32 instruction = 1):
#   power_cut    5 FMAs of the exponent (10), power compare (1)
#   floor_cut    + clamp at 0 (1), exp, opacity scale (1), floor compare (1)
#   contributing + 0.99 clamp (1), 1 - alpha (1), T update (1), contributor
#                  compare (1), weight (1), 4 FMAs into rgb + depth (8),
#                  saturation compare (1)
#   saturating   + 0.99 clamp, 1 - alpha, T update, both compares (5)
K1_WORK = {"power_cut": (11, 0), "floor_cut": (14, 1),
           "contributing": (28, 1), "saturating": (19, 1)}
K1_ROW_BYTES = 40               # the 10 live f32 of a pair row
# (f32 operations, exps) of one (pair, pixel) evaluation of backward_tiles:
# K1's alpha and transmittance work, and for a contributing pair, instead of
# K1's 4 FMAs into rgb + depth: u (1 mul + 3 FMAs = 7), u w (1), prefix (1),
# d_pow (clamp test, alpha / (1 - alpha), TOT - prefix, mul, sub: 5), the
# centred moments (dx, dy, two products, S0 + Sx + Sy adds, 3 FMAs: 13) and
# sum w g (4 FMAs: 8)
K2_WORK = {"power_cut": (11, 0), "floor_cut": (14, 1),
           "contributing": (55, 1), "saturating": (19, 1)}
# The bound counts only what no exact kernel can skip: the evaluations where
# alpha > 0 (an exact cull skips every other one) and one staging pass per
# pair row. The count without the cull prices every needed evaluation of
# WORK_CLASSES; it is printed beside the bound.
HIT_CLASSES = ("contributing", "saturating")
# f32 operations of one staging pass: ml, nl and the six tile-local
# coefficients (2 subs, 6 muls, 2 FMAs, 1 sub, 3 scalings) = 18; K2 adds
# the row's gradient from its ten sums (2 x (mul + FMA + neg), 3 scalings,
# the opacity division and its compare) = 13
K1_STAGE_OPS = 18
K2_STAGE_OPS = 31
K1_TOL = 1e-4                   # kernel vs plain, rgb / depth / alpha rows
# K2 vs plain: max |kernel - plain| per output column over the plain
# column's max |value| (the columns span many decades)
K2_TOL = 1e-4
IMAGE_TOL = 1e-3                # image through the plain version
SMALL_TOL = 1e-3                # test_tiny path, GPU vs CPU
# test_tiny G step, GPU vs CPU: loss relative, gradient L2 relative
SMALL_LOSS_TOL = 1e-4
SMALL_GRAD_TOL = 1e-3
DEVICE = "cuda"
PRESET = "dit"
TRAIN_PRESET = "vae_b"
N_VERTS = 100_002               # -> 100,000 Gaussians (one per face)
N_VIEWS = 4
G_STEPS = 3


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def gpu_name_and_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call over ``reps`` calls, after one warm-up."""
    import torch

    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def hand_streams(rng, chunk=128):
    """Two views of 2x2 tiles of 32x32: an empty tile, a segment straddling
    several chunks from an unaligned start, a saturating stack and a Gaussian
    centred on a pixel centre; then random segments."""
    tile = 32
    rows, start, count = [np.zeros((5, 16), np.float32)], [], []

    def seg(r):
        start.append(sum(len(x) for x in rows))
        count.append(len(r))
        rows.append(r.astype(np.float32))

    def gaussians(k, ox, oy, opa=(0.1, 0.95), s=(2.0, 12.0)):
        r = np.zeros((k, 16), np.float32)
        r[:, 0] = ox + rng.uniform(-8, tile + 8, k)
        r[:, 1] = oy + rng.uniform(-8, tile + 8, k)
        sx, sy = rng.uniform(*s, k), rng.uniform(*s, k)
        rho = rng.uniform(-0.6, 0.6, k)
        det = (sx * sy) ** 2 * (1 - rho ** 2)
        r[:, 2] = sy ** 2 / det
        r[:, 3] = -rho * sx * sy / det
        r[:, 4] = sx ** 2 / det
        r[:, 5:8] = rng.uniform(0, 1, (k, 3))
        r[:, 8] = rng.uniform(*opa, k)
        r[:, 9] = np.sort(rng.uniform(0.5, 3.0, k))
        return r

    seg(np.zeros((0, 16)))
    seg(gaussians(3 * chunk + 7, tile, 0))
    seg(gaussians(60, 0, tile, opa=(0.9, 0.99), s=(20.0, 40.0)))
    centred = gaussians(1, tile, tile)
    centred[0, 0:2] = (tile + 5.0, tile + 7.0)
    centred[0, 8] = 0.8
    seg(np.concatenate([centred, gaussians(5, tile, tile)]))
    for t in range(4):
        seg(gaussians(int(rng.integers(1, 2 * chunk)), (t % 2) * tile,
                      (t // 2) * tile))
    pairs = np.concatenate(rows)
    pairs = np.concatenate(
        [pairs, np.zeros(((-len(pairs)) % chunk, 16), np.float32)])
    return pairs, np.array(start, np.int32), np.array(count, np.int32)


def _pair_rows(mx, my, sx, sy, rho, opa, rng):
    """Pair rows [k, 16] of Gaussians with the given means, standard
    deviations, correlation and opacity (arrays or scalars), random colours,
    increasing depth."""
    mx, my, sx, sy, rho, opa = np.broadcast_arrays(
        *(np.asarray(v, np.float64) for v in (mx, my, sx, sy, rho, opa)))
    k = mx.size
    det = (sx * sy) ** 2 * (1 - rho ** 2)
    r = np.zeros((k, 16), np.float32)
    r[:, 0], r[:, 1] = mx, my
    r[:, 2] = sy ** 2 / det
    r[:, 3] = -rho * sx * sy / det
    r[:, 4] = sx ** 2 / det
    r[:, 5:8] = rng.uniform(0, 1, (k, 3))
    r[:, 8] = opa
    r[:, 9] = np.linspace(0.5, 3.0, k)
    return r


def cull_cases(rng, chunk=128):
    """Hand-made streams for the kernels' per-warp cull and launch
    order, each (pairs, tile_start, tile_count, ntx, tiles_per_view):

    * ``staggered_saturation``: one tile; horizontal bands, one per four
      pixel rows with 2-9 copies each in shuffled depth order, so the rows
      (and the warps that own them) saturate at different depths, then
      small Gaussians behind them;
    * ``whole_tile``: one tile; a Gaussian far wider than the tile (every
      row's bit set), then small Gaussians;
    * ``one_warp``: one tile; a Gaussian confined to one warp's 8 x 4
      pixels (columns 8-15, rows 12-15);
    * ``longest_first``: one view of 3x2 tiles with segments of 0 to 700
      pairs, longest in the middle of the grid.
    """
    tile = 32

    def small(k, ox=0.0, oy=0.0):
        return _pair_rows(ox + rng.uniform(-4, tile + 4, k),
                          oy + rng.uniform(-4, tile + 4, k),
                          rng.uniform(0.5, 4, k), rng.uniform(0.5, 4, k),
                          rng.uniform(-0.6, 0.6, k), rng.uniform(0.1, 0.9, k),
                          rng)

    def stream(segments, ntx, tpv):
        rows, start, count = [np.zeros((3, 16), np.float32)], [], []
        for r in segments:
            start.append(sum(len(x) for x in rows))
            count.append(len(r))
            rows.append(r)
        pairs = np.concatenate(rows)
        pairs = np.concatenate(
            [pairs, np.zeros(((-len(pairs)) % chunk, 16), np.float32)])
        return (pairs, np.array(start, np.int32), np.array(count, np.int32),
                ntx, tpv)

    band_y = np.repeat(4.0 * np.arange(8) + 1.5, np.arange(2, 10))
    rng.shuffle(band_y)
    bands = _pair_rows(16.0, band_y, 60.0, 1.2, 0.0, 0.97, rng)
    wide = _pair_rows(16.0, 16.0, 300.0, 200.0, 0.3, 0.5, rng)
    narrow = _pair_rows(10.3, 13.6, 0.4, 0.4, 0.0, 0.9, rng)
    lengths = [0, 37, 700, 5, 260, 128]
    return {
        "staggered_saturation": stream(
            [np.concatenate([bands, small(60)])], 1, 1),
        "whole_tile": stream([np.concatenate([wide, small(40)])], 1, 1),
        "one_warp": stream([narrow], 1, 1),
        "longest_first": stream(
            [small(k, (t % 3) * tile, (t // 3) * tile)
             for t, k in enumerate(lengths)], 3, 6),
    }


def k1_bytes(n_pairs, n_tiles):
    """K1's own traffic: live pair rows and the segment arrays read once,
    the [n, 8, 1024] f32 tile buffers written once."""
    return n_pairs * K1_ROW_BYTES + 8 * n_tiles + n_tiles * 8 * 1024 * 4


def k1_diff(out, ref):
    """Max |kernel - plain| over the rgb, depth and alpha rows."""
    return (out[:, :5] - ref[:, :5]).abs().max().item()


def k2_diff(out, ref):
    """(max |kernel - plain|, max over columns of that over the plain
    column's max |value|)."""
    d = (out - ref).abs()
    scale = ref.abs().amax(dim=0) + 1e-30
    return d.max().item(), (d.amax(dim=0) / scale).max().item()


def grad_tiles(rng, n):
    """Seeded upstream gradients [n, 8, 1024] (rows 5-7 unused: zero)."""
    g = rng.normal(size=(n, 8, 1024)).astype(np.float32)
    g[:, 5:] = 0.0
    return g


def bound_ms(work, prices, n_bytes, rows=0, row_ops=0):
    """(bound ms, 'bytes' | 'operations', parts): the larger of the bytes
    over the memory rate and the priced operations (the f32 pipes and the
    special-function units run side by side, so the larger of the two).
    ``work`` classes missing from ``prices`` are not counted; ``rows``
    staging passes cost ``row_ops`` f32 operations each."""
    f32_ops = sum(work[k] * prices[k][0] for k in prices) + rows * row_ops
    exps = sum(work[k] * prices[k][1] for k in prices)
    f32_ms = f32_ops / H100_F32_FLOPS * 1e3
    sfu_ms = exps / H100_SFU_PER_S * 1e3
    bound = {"bytes": n_bytes / H100_BYTES_PER_S * 1e3,
             "operations": max(f32_ms, sfu_ms)}
    by = max(bound, key=bound.get)
    return bound[by], by, dict(bound, f32_ops=f32_ops, f32_ms=f32_ms,
                               exps=exps, sfu_ms=sfu_ms)


def bounds(work, prices, stage_ops, n_pairs, n_bytes):
    """(the bound, the bound without the cull), each as ``bound_ms``
    returns it: the hits plus one staging pass per pair row, and every
    needed evaluation."""
    hits = {k: prices[k] for k in HIT_CLASSES}
    return (bound_ms(work, hits, n_bytes, n_pairs, stage_ops),
            bound_ms(work, prices, n_bytes))


def bound_text(ms, new, old):
    """One line of a kernel's time against both bounds."""
    (b, by, p), (b2, by2, p2) = new, old
    return (f"bound {b:.4f} ms ({by}; bytes {p['bytes']:.4f} ms, f32 "
            f"{p['f32_ops']} ops {p['f32_ms']:.4f} ms, exp {p['exps']} "
            f"{p['sfu_ms']:.4f} ms; {100 * b / ms:.2f}% reached); without "
            f"the cull {b2:.4f} ms ({by2}; f32 {p2['f32_ops']} ops, exp "
            f"{p2['exps']}; {100 * b2 / ms:.2f}%)")


def stream_text(tile_count, work):
    """The segment lengths of a stream's non-empty tiles and its
    (pair, warp rectangle) slots: those with no alpha > 0 and those the
    cull keeps, as shares of the slots the warps must visit."""
    c = np.sort(tile_count.cpu().numpy())
    c = c[c > 0]
    q = (lambda f: int(c[min(len(c) - 1, int(f * len(c)))])) if len(c) \
        else (lambda f: 0)
    slots = max(work["warp_slots"], 1)
    return (f"{len(c)} of {tile_count.numel()} tiles non-empty, pairs per "
            f"non-empty tile p50 {q(0.5)}, p99 {q(0.99)}, max "
            f"{int(c[-1]) if len(c) else 0}; (pair, 8x4 warp) slots "
            f"{work['warp_slots']}, no alpha > 0 in "
            f"{100 * work['warp_slots_empty'] / slots:.2f}%, kept by the "
            f"cull {100 * work['warp_slots_kept'] / slots:.2f}%")


def seeded_pose(rng) -> np.ndarray:
    """A 188-d SMPL-X parameter vector (transl, orient, betas, body, expr,
    hands 45+45, jaw, eyes) with moderate joint rotations."""
    vec = np.zeros((1, 188), np.float32)
    vec[0, 6:16] = rng.normal(0, 0.5, 10)            # betas
    vec[0, 16:79] = rng.normal(0, 0.2, 63)           # body pose
    vec[0, 79:89] = rng.normal(0, 0.5, 10)           # expression
    vec[0, 89:179] = rng.normal(0, 0.1, 90)          # hands
    return vec


def main():
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this script needs a GPU")
    sys.path.insert(0, ROOT)
    from sigman_release_torch.body.smplx import synthetic_body_model
    from sigman_release_torch.body.template import synthetic_template
    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.inference import (
        AvatarPipeline, normalize_image, orbit_rig)
    from sigman_release_torch.ops.rasterizer import backward_tiles as k2
    from sigman_release_torch.ops.rasterizer import forward_tiles as k1
    from sigman_release_torch.ops.rasterizer.render import (
        composite, finish, prepare_pairs)
    from sigman_release_torch.utils import cuda_build
    from sigman_release_torch.utils.timing import StageTimer

    dev = torch.device(DEVICE)
    card = gpu_name_and_power()
    print(f"[smoke] card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # ---- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build([k1.SOURCE, k2.SOURCE])
    print(f"[build] {len(cuda_build.build_logs)} source(s) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in cuda_build.build_logs.items():
        print(f"[build] {os.path.relpath(src, ROOT)}:\n{log.strip()}")

    # ---- 2. K1 on hand-made streams -------------------------------------------
    pairs, start, count = hand_streams(np.random.default_rng(0))
    args = (torch.from_numpy(pairs).to(dev), torch.from_numpy(start).to(dev),
            torch.from_numpy(count).to(dev))
    kw = dict(ntx=2, tiles_per_view=4, chunk=128)
    out = k1.forward_tiles(*args, **kw)
    ref = k1.forward_tiles_plain(*args, **kw)
    torch.cuda.synchronize()
    hand_err = k1_diff(out, ref)
    print(f"[k1] hand-made streams: max |kernel - plain| {hand_err:.3e}")
    if not hand_err <= K1_TOL:
        fail(f"forward_tiles disagrees with its plain version: {hand_err}")
    if not (out[0, :3] == 0).all() or not (out[0, 5] == 1).all():
        fail("forward_tiles: the empty tile is not empty")
    if out[3, 4, 7 * 32 + 5].item() < 0.79:
        fail("forward_tiles dropped the Gaussian centred on a pixel")
    for name, (p, st, ct, ntx, tpv) in cull_cases(
            np.random.default_rng(0)).items():
        a3 = [torch.from_numpy(x).to(dev) for x in (p, st, ct)]
        kw3 = dict(ntx=ntx, tiles_per_view=tpv, chunk=128)
        err = k1_diff(k1.forward_tiles(*a3, **kw3),
                      k1.forward_tiles_plain(*a3, **kw3))
        print(f"[k1] cull case {name}: max |kernel - plain| {err:.3e}")
        if not err <= K1_TOL:
            fail(f"forward_tiles disagrees with its plain version on {name}")

    # ---- 3. the main path at full width ---------------------------------------
    cfg = PRESETS[PRESET]
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    body = synthetic_body_model(n_verts=N_VERTS, seed=0, device=dev)
    template = synthetic_template(body)
    pipe = AvatarPipeline(cfg, device=dev, seed=0, body_model=body,
                          template=template)
    torch.cuda.synchronize()
    print(f"[main] set-up {time.perf_counter() - t0:.1f} s: "
          f"{template.num_gaussians} Gaussians, DiT "
          f"{sum(p.numel() for p in pipe.dit.parameters()) / 1e9:.2f} B "
          f"params ({next(pipe.dit.parameters()).dtype})", flush=True)
    image = normalize_image(rng.uniform(0, 1, (cfg.input_size,
                                               cfg.input_size, 3)),
                            cfg.input_size)
    smpl_vec = torch.from_numpy(seeded_pose(rng))
    cv, cvp = (torch.from_numpy(a) for a in orbit_rig(cfg, N_VIEWS))
    gen = torch.Generator(device=dev).manual_seed(4)
    timer = StageTimer(dev)
    torch.cuda.reset_peak_memory_stats()
    k1.forward_tiles.launches = 0
    t0 = time.perf_counter()
    res = pipe(image, smpl_vec, cv, cvp, generator=gen, steps=30, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.forward_tiles.launches
    render = res["render"]
    stages = ", ".join(f"{k} {v * 1e3:.1f} ms ({100 * v / wall:.1f}%)"
                       for k, v in timer.seconds.items())
    print(f"[main] request {wall * 1e3:.1f} ms: {stages}")
    print(f"[main] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; forward_tiles launches {launches}; overflow "
          f"{render['overflow'].tolist()}")
    alpha = render["alpha"]
    print(f"[main] alpha mean {alpha.mean().item():.4f}, coverage (alpha > "
          f"0.5) {(alpha > 0.5).float().mean().item():.4f}; image "
          f"{tuple(render['image'].shape)}", flush=True)
    if launches < 1:
        fail("the main path did not launch forward_tiles")
    hw = cfg.output_size
    if tuple(render["image"].shape) != (1, N_VIEWS, 3, hw, hw):
        fail(f"unexpected image shape {tuple(render['image'].shape)}")
    for name, x in (("latents", res["latents"]), ("attr_map", res["attr_map"]),
                    ("points", res["gaussians"]["position"]),
                    ("image", render["image"]), ("alpha", alpha),
                    ("depth", render["depth"])):
        if not torch.isfinite(x).all():
            fail(f"non-finite values in {name}")
    if "overflow" not in render:
        fail("overflow not reported")
    if not alpha.max().item() > 0.5:
        fail("the avatar is not visible in any view")

    # ---- 4. the render stage through the plain version -------------------------
    rc = pipe.renderer.raster_cfg
    with torch.no_grad():
        pos, cov3d, rgb, opa = pipe.renderer.prepare(res["gaussians"])
        stream = prepare_pairs(pos[0], cov3d[0], rgb[0], opa[0], cv.to(dev),
                               cvp.to(dev), rc)
        tiles = composite(stream, rc)
        kw = dict(ntx=rc.ntx, tiles_per_view=rc.n_tiles, chunk=rc.chunk)
        work = {}
        t0 = time.perf_counter()
        plain = k1.forward_tiles_plain(
            stream.pairs, stream.tile_start, stream.tile_count, work=work,
            **kw)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        k1_err = k1_diff(tiles, plain)
        bg = torch.ones(3, device=dev)
        img_plain = finish(plain, stream.overflow, N_VIEWS, bg, rc)["image"]
        img_err = (img_plain - render["image"][0]).abs().max().item()
        k1_ms = cuda_ms(lambda: composite(stream, rc), reps=20)
    n_pairs = int(stream.tile_count.sum())
    k1_new, k1_old = bounds(work, K1_WORK, K1_STAGE_OPS, n_pairs,
                            k1_bytes(n_pairs, stream.tile_start.numel()))
    k1_bound, k1_by = k1_new[:2]
    print(f"[plain] main-path stream: {n_pairs} pairs in "
          f"{stream.tile_count.numel()} tiles; evaluations {work}; "
          f"max |kernel - plain| {k1_err:.3e}; image max diff {img_err:.3e}")
    print(f"[plain] serving stream: {stream_text(stream.tile_count, work)}")
    print(f"[plain] forward_tiles {k1_ms:.4f} ms, plain {plain_ms:.1f} ms, "
          f"{bound_text(k1_ms, k1_new, k1_old)}", flush=True)
    if not k1_err <= K1_TOL:
        fail(f"forward_tiles disagrees with its plain version on the main "
             f"path's stream: {k1_err}")
    if not img_err <= IMAGE_TOL:
        fail(f"image through the plain version differs by {img_err}")

    # ---- 5. test_tiny on the GPU against the CPU --------------------------------
    small = PRESETS["test_tiny"]
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False       # f32 convs on both sides
    try:
        outs = []
        noise = torch.from_numpy(np.random.default_rng(1).normal(
            size=(1, small.latent_channels, small.sample_height,
                  small.sample_width)).astype(np.float32))
        img_s = normalize_image(np.random.default_rng(2).uniform(
            0, 1, (small.input_size, small.input_size, 3)), small.input_size)
        cv_s, cvp_s = (torch.from_numpy(a) for a in orbit_rig(small, 2))
        cpu_pipe = AvatarPipeline(small, device="cpu", seed=0)
        gpu_pipe = AvatarPipeline(small, device=dev, seed=0)
        for m_cpu, m_gpu in ((cpu_pipe.vae, gpu_pipe.vae),
                             (cpu_pipe.dit, gpu_pipe.dit),
                             (cpu_pipe.encoder, gpu_pipe.encoder)):
            m_gpu.load_state_dict(m_cpu.state_dict())
        for p in (cpu_pipe, gpu_pipe):
            o = p(img_s, smpl_vec, cv_s, cvp_s, noise=noise, steps=5)
            outs.append({k: v.float().cpu() for k, v in
                         (("latents", o["latents"]),
                          ("image", o["render"]["image"]))})
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    small_err = max((outs[0][k] - outs[1][k]).abs().max().item()
                    for k in outs[0])
    print(f"[small] test_tiny GPU vs CPU: max diff {small_err:.3e}")
    if not small_err <= SMALL_TOL:
        fail(f"test_tiny path on the GPU differs from the CPU by {small_err}")

    del pipe, res, render, stream, tiles, plain
    torch.cuda.empty_cache()
    train = train_phases(dev, body, template)

    kernels = [{
        "name": "forward_tiles",
        "route": "cuda",
        "source": "sigman_release_torch/ops/rasterizer/csrc/forward_tiles.cu",
        "replaces": "sigman_release_tpu/ops/rasterizer/pallas_forward.py:339",
        "launches": launches + train["k1_launches"],
        "launches_by_path": {"serve": launches,
                             "train": train["k1_launches"]},
        "max_abs_err": k1_err,
        "max_abs_diff": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "bound_ms_without_cull": k1_old[0],
        "library_ms": None,
        "train": {"ms": train["k1_ms"], "plain_ms": train["k1_plain_ms"],
                  "bound_ms": train["k1_bound"],
                  "bound_ms_without_cull": train["k1_bound_old"],
                  "max_abs_err": train["k1_err"]},
    }, {
        "name": "backward_tiles",
        "route": "cuda",
        "source": "sigman_release_torch/ops/rasterizer/csrc/backward_tiles.cu",
        "replaces": "sigman_release_tpu/ops/rasterizer/pallas_backward.py:333",
        "launches": train["k2_launches"],
        "launches_by_path": {"serve": 0, "train": train["k2_launches"]},
        "max_abs_err": train["k2_err"],
        "max_abs_diff": train["k2_err"],
        "max_col_rel_err": train["k2_rel"],
        "ms": train["k2_ms"],
        "kernel_only_ms": train["k2_kernel_ms"],
        "plain_ms": train["k2_plain_ms"],
        "bound_ms": train["k2_bound"],
        "bound_by": train["k2_by"],
        "bound_ms_without_cull": train["k2_bound_old"],
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def small_train_step_diff(dev):
    """One ``test_tiny`` G step on ``dev`` and on the CPU from the same
    weights, batch and noise, TF32 off, dropout off: (loss relative
    difference, gradient relative L2 difference). With two accumulation
    micro-steps the first leaves its gradients in place."""
    import torch

    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.data.dataset import SyntheticAvatarDataset
    from sigman_release_torch.training.vae_trainer import VAETrainer

    cfg = PRESETS["test_tiny"].replace(gradient_accumulation_steps=2,
                                       attn_dropout=0.0)
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cpu = VAETrainer(cfg, device="cpu")
        gpu = VAETrainer(cfg, device=dev)
        gpu.load_state_dicts(vae=cpu.vae.state_dict(),
                             disc=cpu.disc.state_dict(),
                             lpips=cpu.lpips.state_dict())
        item = SyntheticAvatarDataset(cfg, n_items=1)[0]
        raw = {k: v[None] for k, v in item.items() if k != "item"}
        noise = torch.from_numpy(np.random.default_rng(2).normal(
            size=(1, cfg.uv_query_size, cfg.uv_query_size,
                  cfg.latent_channels)).astype(np.float32))
        lc = cpu.train_step_g(cpu.to_device(raw), noise)["loss"].item()
        lg = gpu.train_step_g(gpu.to_device(raw), noise.to(dev))[
            "loss"].item()
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    gc = torch.cat([p.grad.flatten() for p in cpu.params_g])
    gg = torch.cat([p.grad.flatten() for p in gpu.params_g]).cpu()
    return abs(lg - lc) / abs(lc), ((gg - gc).norm() / gc.norm()).item()


def train_phases(dev, body, template):
    """Phases 6-9; returns the numbers the kernels line needs."""
    import torch

    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.ops.rasterizer import backward_tiles as k2
    from sigman_release_torch.ops.rasterizer import forward_tiles as k1
    from sigman_release_torch.ops.rasterizer import render as render_lib
    from sigman_release_torch.training.vae_trainer import synthetic_setup
    from sigman_release_torch.utils.timing import StageTimer

    # ---- 6. K2 on hand-made streams -------------------------------------------
    rng = np.random.default_rng(1)
    pairs, start, count = hand_streams(rng)
    args = tuple(torch.from_numpy(a).to(dev) for a in (pairs, start, count))
    kw = dict(ntx=2, tiles_per_view=4, chunk=128)
    fwd = k1.forward_tiles(*args, **kw)
    grad = torch.from_numpy(grad_tiles(rng, start.shape[0])).to(dev)
    out = k2.backward_tiles(*args, fwd, grad, **kw)
    ref = k2.backward_tiles_plain(*args, fwd, grad, **kw)
    torch.cuda.synchronize()
    hand_abs, hand_rel = k2_diff(out, ref)
    print(f"[k2] hand-made streams: max |kernel - plain| {hand_abs:.3e}, "
          f"per-column relative {hand_rel:.3e}", flush=True)
    if not hand_rel <= K2_TOL:
        fail(f"backward_tiles disagrees with its plain version: {hand_rel}")
    sat_end = int(start[2]) + int(count[2])
    if not (out[sat_end - 5:sat_end] == 0).all() or not (out[:, 10:] == 0).all():
        fail("backward_tiles wrote rows past saturation or padding columns")
    if not out[int(start[3])].abs().max().item() > 0:
        fail("backward_tiles gave no gradient to the Gaussian on a pixel")
    for name, (p, st, ct, ntx, tpv) in cull_cases(rng).items():
        a3 = [torch.from_numpy(x).to(dev) for x in (p, st, ct)]
        kw3 = dict(ntx=ntx, tiles_per_view=tpv, chunk=128)
        f3 = k1.forward_tiles(*a3, **kw3)
        g3 = torch.from_numpy(grad_tiles(rng, st.shape[0])).to(dev)
        o3 = k2.backward_tiles(*a3, f3, g3, **kw3)
        rel = k2_diff(o3, k2.backward_tiles_plain(*a3, f3, g3, **kw3))[1]
        print(f"[k2] cull case {name}: per-column relative {rel:.3e}")
        if not rel <= K2_TOL or not torch.equal(
                o3, k2.backward_tiles(*a3, f3, g3, **kw3)):
            fail(f"backward_tiles disagrees with its plain version or "
                 f"itself on {name}")

    # ---- 7. vae_b training steps at full width ----------------------------------
    cfg = PRESETS[TRAIN_PRESET]
    t0 = time.perf_counter()
    trainer, batch = synthetic_setup(cfg, device=dev, body_model=body,
                                     template=template)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in trainer.vae.parameters())
    print(f"[train] set-up {time.perf_counter() - t0:.1f} s: "
          f"{template.num_gaussians} Gaussians, VAE {n_params / 1e6:.1f} M "
          f"params, input {tuple(batch['input'].shape)}, "
          f"{cfg.num_views} views at {cfg.output_size}^2, "
          f"{cfg.mixed_precision}, remat {cfg.remat_policy}", flush=True)
    ae = trainer.vae.autoencoder
    watch = {"encoder.conv_in": ae.encoder.conv_in.weight,
             "bottleneck.projection": ae.projection.weight,
             "decoder.conv_out": ae.decoder.conv_out.weight,
             "heads.geo": trainer.vae.heads.decode_gaussian_geo.weight}
    before = {n: w.detach().clone() for n, w in watch.items()}
    captured = {}
    real_backward = render_lib.backward_tiles

    def capturing_backward(*a, **kw):      # keeps the last step's K2 inputs
        captured.update(args=a, kw=kw)
        return real_backward(*a, **kw)

    render_lib.backward_tiles = capturing_backward
    torch.cuda.reset_peak_memory_stats()
    k1.forward_tiles.launches = 0
    k2.backward_tiles.launches = 0
    step_ms, spans = [], []
    try:
        for i in range(G_STEPS):
            timer = StageTimer(dev)
            c1, c2 = k1.forward_tiles.launches, k2.backward_tiles.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = trainer.train_step_g(batch, timer=timer)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            spans.append(timer.seconds)
            logs = {k: float(v) for k, v in logs.items()}
            n1 = k1.forward_tiles.launches - c1
            n2 = k2.backward_tiles.launches - c2
            print(f"[train] G step {i + 1}: {step_ms[-1]:.1f} ms, K1 "
                  f"launches {n1}, K2 launches {n2}, logs {logs}", flush=True)
            if n1 < 1 or n2 < 1:
                fail(f"G step {i + 1} did not launch both kernels ({n1}, {n2})")
            if not all(np.isfinite(v) for v in logs.values()):
                fail(f"non-finite loss in G step {i + 1}: {logs}")
        snap = [p.detach().clone() for p in trainer.params_g]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dlogs = trainer.train_step_d(batch)
        torch.cuda.synchronize()
        d_ms = (time.perf_counter() - t0) * 1e3
    finally:
        render_lib.backward_tiles = real_backward
    k1_train, k2_train = k1.forward_tiles.launches, k2.backward_tiles.launches
    peak = torch.cuda.max_memory_allocated() / 2**30
    dlogs = {k: float(v) for k, v in dlogs.items()}
    med = statistics.median(step_ms[1:])
    last = spans[-1]
    total = step_ms[-1] / 1e3
    stages = ", ".join(f"{k} {v * 1e3:.1f} ms ({100 * v / total:.1f}%)"
                       for k, v in last.items())
    print(f"[train] G step median of steps 2-{G_STEPS}: {med:.1f} ms; step "
          f"{G_STEPS} spans: {stages}")
    print(f"[train] D step {d_ms:.1f} ms, logs {dlogs}; peak memory "
          f"{peak:.2f} GiB; launches K1 {k1_train}, K2 {k2_train}; overflow "
          f"{logs['overflow']:.0f}", flush=True)
    for n, w in watch.items():
        if torch.equal(w.detach(), before[n]):
            fail(f"the G steps did not move {n}")
    if not all(torch.equal(p.detach(), q)
               for p, q in zip(trainer.params_g, snap)):
        fail("the D step changed the VAE parameters")
    if not all(np.isfinite(v) for v in dlogs.values()):
        fail(f"non-finite D loss: {dlogs}")
    del snap, before

    # ---- 8. K1 and K2 on the training step's own stream -----------------------
    a, kw = captured["args"], captured["kw"]
    pairs8, ts8, tc8 = a[:3]
    with torch.no_grad():
        out = k2.backward_tiles(*a, **kw)
        work = {}
        t0 = time.perf_counter()
        ref = k2.backward_tiles_plain(*a, work=work, **kw)
        torch.cuda.synchronize()
        k2_plain_ms = (time.perf_counter() - t0) * 1e3
        k2_err, k2_rel = k2_diff(out, ref)
        del ref
        k2_ms = cuda_ms(lambda: k2.backward_tiles(*a, **kw), reps=20)
        # the launch alone, into a buffer zeroed beforehand: every call
        # writes the same rows with the same values
        buf = torch.zeros_like(pairs8)
        order8 = k1.launch_order(tc8)
        lib2 = k2._library()
        cu_stream = torch.cuda.current_stream().cuda_stream

        def launch_alone():
            rc = lib2.backward_tiles_launch(
                pairs8.data_ptr(), ts8.data_ptr(), tc8.data_ptr(),
                order8.data_ptr(), a[3].data_ptr(), a[4].data_ptr(),
                buf.data_ptr(), ts8.numel(), kw["ntx"],
                kw["tiles_per_view"], cu_stream)
            if rc:
                fail(f"backward_tiles_launch failed: cudaError {rc}")

        k2_kernel_ms = cuda_ms(launch_alone, reps=20)
        if not torch.equal(buf, out):
            fail("backward_tiles' launch alone differs from the wrapper's")
        # rows the kernel must write: those with a nonzero gradient
        n_written = int((out[:, :10] != 0).any(dim=1).sum())
        del out, buf
        fwd8 = k1.forward_tiles(pairs8, ts8, tc8, **kw)
        t0 = time.perf_counter()
        ref = k1.forward_tiles_plain(pairs8, ts8, tc8, **kw)
        torch.cuda.synchronize()
        k1_plain_ms = (time.perf_counter() - t0) * 1e3
        k1_err = k1_diff(fwd8, ref)
        del fwd8, ref
        k1_ms = cuda_ms(lambda: k1.forward_tiles(pairs8, ts8, tc8, **kw),
                        reps=20)
    n_pairs, n_tiles = int(tc8.sum()), ts8.numel()
    k1_new, k1_old = bounds(work, K1_WORK, K1_STAGE_OPS, n_pairs,
                            k1_bytes(n_pairs, n_tiles))
    print(f"[k1 train] forward_tiles on the training stream {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.1f} ms, max |kernel - plain| {k1_err:.3e}; "
          f"{bound_text(k1_ms, k1_new, k1_old)}", flush=True)
    if not k1_err <= K1_TOL:
        fail(f"forward_tiles disagrees with its plain version on the "
             f"training stream: {k1_err}")
    # the function's own traffic: live pair rows read once, the 10 gradient
    # columns of the rows with a nonzero gradient written once, forward rows
    # 0-3, 5 and gradient rows 0-4 of the non-empty tiles (an empty tile
    # needs none) and the segment arrays read once. The wrapper's zero fill
    # of the whole [budget, 16] output is not the kernel's work: it is
    # printed beside the bound, not in it.
    n_bytes = ((n_pairs + n_written) * K1_ROW_BYTES
               + int((tc8 > 0).sum()) * 10 * 1024 * 4 + 8 * n_tiles)
    fill_ms = pairs8.numel() * 4 / H100_BYTES_PER_S * 1e3
    k2_new, k2_old = bounds(work, K2_WORK, K2_STAGE_OPS, n_pairs, n_bytes)
    k2_bound, k2_by = k2_new[:2]
    print(f"[k2 main] stream: {n_pairs} pairs in {n_tiles} tiles (budget "
          f"{pairs8.shape[0]}), {n_written} rows with a gradient; "
          f"evaluations {work}; max |kernel - plain| {k2_err:.3e}, "
          f"per-column relative {k2_rel:.3e}")
    print(f"[k2 main] training stream: {stream_text(tc8, work)}")
    print(f"[k2 main] backward_tiles {k2_ms:.4f} ms with the wrapper's zero "
          f"fill of the {pairs8.numel() * 4 / 1e6:.0f} MB output (at least "
          f"{fill_ms:.4f} ms, outside the bound), {k2_kernel_ms:.4f} ms the "
          f"launch alone; plain {k2_plain_ms:.1f} ms; "
          f"{bound_text(k2_kernel_ms, k2_new, k2_old)}", flush=True)
    if not k2_rel <= K2_TOL:
        fail(f"backward_tiles disagrees with its plain version on the "
             f"training stream: {k2_rel}")
    del trainer, batch, captured, a
    torch.cuda.empty_cache()

    # ---- 9. test_tiny G step on the GPU against the CPU ---------------------
    loss_rel, grad_rel = small_train_step_diff(dev)
    print(f"[small train] test_tiny G step GPU vs CPU: loss relative "
          f"{loss_rel:.3e}, gradient relative L2 {grad_rel:.3e}", flush=True)
    if not loss_rel <= SMALL_LOSS_TOL or not grad_rel <= SMALL_GRAD_TOL:
        fail(f"test_tiny G step on the GPU differs from the CPU: loss "
             f"{loss_rel}, gradient {grad_rel}")
    return {"k1_launches": k1_train, "k2_launches": k2_train,
            "k2_err": k2_err, "k2_rel": k2_rel, "k2_ms": k2_ms,
            "k2_kernel_ms": k2_kernel_ms, "k2_plain_ms": k2_plain_ms,
            "k2_bound": k2_bound, "k2_by": k2_by,
            "k2_bound_old": k2_old[0], "k1_ms": k1_ms,
            "k1_plain_ms": k1_plain_ms, "k1_err": k1_err,
            "k1_bound": k1_new[0], "k1_bound_old": k1_old[0]}


if __name__ == "__main__":
    main()
