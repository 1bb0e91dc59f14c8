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
             path on the CPU (same weights, noise and pose).

Prints the card's name and power limit, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Needs no network and one card; exits
non-zero without CUDA.
"""

from __future__ import annotations

import json
import os
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
K1_TOL = 1e-4                   # kernel vs plain, rgb / depth / alpha rows
IMAGE_TOL = 1e-3                # image through the plain version
SMALL_TOL = 1e-3                # test_tiny path, GPU vs CPU
DEVICE = "cuda"
PRESET = "dit"
N_VERTS = 100_002               # -> 100,000 Gaussians (one per face)
N_VIEWS = 4


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


def k1_diff(out, ref):
    """Max |kernel - plain| over the rgb, depth and alpha rows."""
    return (out[:, :5] - ref[:, :5]).abs().max().item()


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
    cuda_build.build([k1.SOURCE])
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
    n_out = tiles.numel() * 4
    bytes_moved = n_pairs * K1_ROW_BYTES + 8 * stream.tile_start.numel() \
        + n_out
    f32_ops = sum(work[k] * K1_WORK[k][0] for k in K1_WORK)
    exps = sum(work[k] * K1_WORK[k][1] for k in K1_WORK)
    # the f32 pipes and the special-function units run side by side
    f32_ms = f32_ops / H100_F32_FLOPS * 1e3
    sfu_ms = exps / H100_SFU_PER_S * 1e3
    bound = {"bytes": bytes_moved / H100_BYTES_PER_S * 1e3,
             "operations": max(f32_ms, sfu_ms)}
    bound_by = max(bound, key=bound.get)
    print(f"[plain] main-path stream: {n_pairs} pairs in "
          f"{stream.tile_count.numel()} tiles; evaluations needed {work}; "
          f"max |kernel - plain| {k1_err:.3e}; image max diff {img_err:.3e}")
    print(f"[plain] forward_tiles {k1_ms:.4f} ms, plain {plain_ms:.1f} ms, "
          f"bound {bound[bound_by]:.4f} ms ({bound_by}; bytes "
          f"{bound['bytes']:.4f} ms, f32 {f32_ops} ops {f32_ms:.4f} ms, "
          f"exp {exps} {sfu_ms:.4f} ms; "
          f"{100 * bound[bound_by] / k1_ms:.2f}% of the bound reached)",
          flush=True)
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

    kernels = [{
        "name": "forward_tiles",
        "route": "cuda",
        "source": "sigman_release_torch/ops/rasterizer/csrc/forward_tiles.cu",
        "replaces": "sigman_release_tpu/ops/rasterizer/pallas_forward.py:339",
        "launches": launches,
        "max_abs_err": k1_err,
        "max_abs_diff": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound[bound_by],
        "bound_by": bound_by,
        "library_ms": None,
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
