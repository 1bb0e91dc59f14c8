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
             gradients;
10. dit train — ``DiTTrainer`` at the ``dit`` preset's full width (DiT
             d=2048 x 30 layers, patch 2 on the 16x64x64 latent, bf16,
             per-block checkpointing; frozen ``vae_b``-geometry VAE encode
             of 6 views of 9 channels at 512^2 and frozen conditioning
             encoder at Sapiens-1B geometry, 1536 x 40 layers, on 512^2,
             both f32) on 8
             synthetic items, raw path: 3 training steps, one eval loss and
             one sampling eval on a held-out item (30 CFG DDIM steps ->
             VAE decode -> deform -> K1 render of 10 views at 512^2), K1's
             launch count zeroed before; K1 against its plain version on
             that eval's own pair stream;
11. small dit — one ``test_tiny`` DiT step on the GPU against the CPU (same
             weights, batch and draws, TF32 off): loss and gradients;
12. ckpt      — last, so that phases 1-11 run as they did without it: a
             fresh ``vae_b`` trainer of phase 7's set-up takes one G and
             one D step; ``save`` of its state (under ``build/``);
             a fresh trainer's ``resume`` equal bit for bit to the state
             saved, and one more G step on both with the same posterior
             noise (loss and updated weights against the original's, K1
             and K2 launch counts zeroed before the resumed step);
             reference-layout safetensors of the VAE and discriminator
             written with numpy and read back by ``load_params_any``;
             ``evaluate`` over 2 held-out items at batch 1 (posterior mean,
             PSNR, masked PSNR, SSIM, LPIPS at 512^2, the GT | pred PNG),
             K1 launches zeroed before, K1 against its plain version on
             the eval's own pair stream; and the ``test_tiny`` DiT
             accumulation round trip (save at micro-step 1 of 2, resume,
             compare with an uninterrupted run).
13. ddp       — last: (a) NCCL at world size 1, in a process group the
             phase initialises: the ``vae_b`` trainer of phase 7's set-up
             under DDP (``disc_start`` 2: two G steps, then one D step with
             the gate open) against a bare trainer on the same weights and
             noise (and ``WORLD1_REPEATS`` more bare runs: the spread), and
             the ``dit`` preset at B = 8, two steps, likewise (one more bare
             run) (loss, gradient at each clip, new weights; step times, peak
             memory, buckets and bytes all-reduced; K1 / K2 launch counts
             zeroed before the DDP steps); (b) two ranks sharing the card
             over gloo, child processes with one deadline
             (``parallel/launch.py``, ``parallel/cases.py``) against one
             process on the whole batch (and a second one-process run,
             the backward's spread): ``vae_b`` data 2 x view 1 at B = 1 per
             rank (a G step, then a D step with the gate open, dropout off;
             then the eval over 3 held-out items, 2 and 1), ``vae_b`` data
             1 x view 2 (5 of the 10 views on each rank, dropout on: both
             ranks draw the same masks) and the ``test_tiny`` DiT at data
             2 (two steps, 4 items, the eval loss over 3).
14. data      — last: the HGS-1M reader and the evaluation entry points.
             The decoder (``data/csrc/loader.cpp``: libjpeg, else nvJPEG;
             PNG on zlib) built with g++ and held against the committed
             libjpeg decode of a 1024^2 JPEG fixture (exactly, or within
             ``NVJPEG_MAX_LEVELS`` on nvJPEG); 3 item directories of the
             reference's layout (90 views at 1024^2) written under
             ``build/smoke_hgs/``; decode ms per view, the ms of one
             ``vae_b`` item and the loader's items/s; ``train_vae.main``
             at ``vae_b`` over the 2 training items with the eval over the
             held-out one, ``train_dit.main`` at ``test_tiny`` (one step),
             ``test_vae.main`` resuming train_vae's state, ``inference.main``
             at the ``dit`` preset (``avatar.ply``) and ``--eval``, then
             ``render_free`` of the PLY's Gaussians at 512^2 over 4 views
             with a seeded upstream gradient: K1 and K2 against their plain
             versions on its streams, with their bounds. Each path's K1 /
             K2 launches are counted from 0.
15. template  — last: the template tools, the converters and the VAE's
             remat. ``extract_template`` on a procedural SMPL-X npz of
             ``TEMPLATE_VERTS`` vertices (``save_smplx_npz``) and a seeded
             segmentation JSON of the 9 ``SUBDIVIDE_REGIONS`` (99,940
             Gaussians); a ``vae_b`` trainer whose ``template_dir`` is the
             result takes one G step (K1 and K2 launched once, held against
             their plain versions on its stream, with their bounds);
             ``inverse_skin_points`` of the template's LBS-posed anchors on
             the deformer's weight voxel; the G step under "block" (three
             runs: the gradients' spread), "conv_enc" and "conv" on the
             same weights, noise and draws (first loss, gradient at the
             clip, median ms of 2 steps, peak GiB); ``bake_uv`` over
             ``BAKE_ITEMS`` item of phase 14's layout (18 views at 1024^2,
             a 1024^2 atlas) read back by ``HGSDataset``; ``convert_reference_ckpt``
             of ``vae_b`` reference safetensors and ``convert_sapiens`` of
             an mmpretrain state dict at Sapiens-1B geometry, each read
             back by ``load_params_any`` bit for bit. Files under
             ``build/smoke_template/``, removed at the end.
16. fsdp      — last: the DiT trainer's ``spmd="fsdp"`` (FSDP2 over
             'data', tensor parallelism over 'model', ``parallel/fsdp.py``)
             at the ``dit`` preset's full width. (a) NCCL at world size 1,
             in a process group the phase initialises: two FSDP steps at
             B = 8 against two bare runs on the same weights and draws
             (``cases.dit_case``: loss, whole gradient at each clip, new
             weights; the ms and peak of two more untapped steps, sharded
             bytes), then a sampling eval under FSDP on the stepped
             weights (30 CFG steps, K1 launch count zeroed before, K1
             against its plain version on its stream); (b) two gloo ranks
             sharing the card against one process on the whole batch, the
             DiT cut to ``FSDP_LAYERS`` blocks at full width, in f32
             without TF32 at a constant learning rate: data 2 x model 1
             and data 1 x model 2 at ``FSDP_ITEMS`` items per data index,
             two steps, held within the ``F32_*`` limits (loss, gradient
             over all parameters and its worst one alone, each rank's
             global norm, the update) and each rank's parameter and AdamW
             bytes against the analytic model within ``BYTES_TOL``; (c)
             in the same launch, the state file: two gloo ranks at
             ``test_tiny`` save in the middle of an accumulation; its
             layout equals a one-process file's, one process resumes it
             bit for bit, and its next micro-step matches the ranks'
             within phase 12's limits. Files under ``build/smoke_fsdp/``,
             removed at the end.

17. knobs     — last: the ``RasterizeConfig`` knobs as K1 / K2 variants
             and the last features ported, on a fresh ``vae_b`` trainer of
             phase 7's set-up. Three G steps each at tile 32 with the f32
             gradient stream, at tile 32 with the bf16 stream and at tile
             16 (windows widened from ``T16_WINDOWS`` until the overflow is
             under 1% of the pairs), each from the same weights and draws;
             then ``fit`` over three steps with ``early_stop`` off and
             ``profile_dir`` (one trace, naming both kernels) and a
             ``test_tiny`` DiT ``fit`` likewise; launches counted from 0
             over these steps, by variant too. Then: (b) the first loss of
             the bf16 run equal bit for bit, its Gaussian gradients within
             8e-3 of the f32 run's, K2's bf16 output its f32 output
             rounded and within one bf16 rounding of its plain version,
             K2 alone / with the fill / with the regroup both ways; (a)
             K1 and K2 at tile 16 on the last step's stream against their
             plain versions with their bounds, K1 at 1 and 2 blocks per
             16-px tile, and on phase 4's serving scene K1 at tile 16 and
             its maps against tile 32's (5e-5 + 1e-4 relative, net of the
             cut share); (c) ``early_stop=False`` bit for bit (K1 serving,
             K2 training); (e) LPIPS from seeded weight files, card
             against CPU. Files under ``build/``, removed at the end.

18. knn       — last: the KNN base scale kernel (``ops/csrc/knn.cu``) on
             ``KNN_ITEMS`` items of phase 3's template Gaussians, each moved
             by a seeded offset: one launch against the plain version per
             item (equal bit for bit, since the kernel repeats its
             rounding), the kernel's ms (CUDA events over ``KNN_REPS``
             launches), the plain version's and the f32-issue bound at the
             published peak. Every path that counts K1 launches counts the
             KNN's too (one a render through ``GaussianRenderer``).

Phases 2 and 6 also run ``cull_cases``; phases 4, 8, 10 and 12 print each
stream's segment lengths and (pair, warp) slots and both bounds (this one:
the hits plus a staging pass per row; without the cull: every needed
evaluation). Each phase's wall seconds are printed at the end.

Prints the card's name and power limit, one ``{"kernels": [...]}`` line and,
last, ``{"ok": true, "device": {...}}``. Needs no network and one card; exits
non-zero without CUDA.
"""

from __future__ import annotations

import gc
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
H100_BF16_FLOPS = 989e12        # dense bf16 on the tensor cores
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
# a pixel whose lower final T is within this of the transmittance cut may
# stop on either side of one pair (``k1_cut_share``)
K1_CUT_RTOL = 1e-3
# K2 vs plain: max |kernel - plain| per output column over the plain
# column's max |value| (the columns span many decades)
K2_TOL = 1e-4
# K2's bf16 output against the plain version's f32 one, net of one bf16
# rounding (2^-8 of each value), per column over its max (``k2_bf16_excess``)
K2_BF16_TOL = K2_TOL
IMAGE_TOL = 1e-3                # image through the plain version
SMALL_TOL = 1e-3                # test_tiny path, GPU vs CPU
# test_tiny G step, GPU vs CPU: loss relative, gradient L2 relative
SMALL_LOSS_TOL = 1e-4
SMALL_GRAD_TOL = 1e-3
# the G step of a resumed vae_b trainer against the original's on the same
# noise: loss relative, updated weights relative L2 (the backward's atomics
# may round the gradients differently)
RESUME_LOSS_TOL = 1e-6
RESUME_PARAM_TOL = 1e-5
# test_tiny DiT: an accumulation saved and resumed against an uninterrupted
# one, max |difference| of the weights (TF32 off, cuDNN deterministic)
SMALL_RESUME_TOL = 1e-6
# phase 13, DDP against one process. NCCL at world size 1 against a bare
# trainer on the same weights and noise: the first step's loss (relative),
# its gradient at the clip and the new weights (relative L2) within
# WORLD1_TOL plus twice the most that more bare runs of the same steps
# differ by (``vae_b``: WORLD1_REPEATS of them, where the new weights after
# three steps swing 6x between runs; ``dit``: one); after the first
# update, each loss and gradient within the limits of the gloo layouts
# below. The steps' backward is not deterministic:
# cuDNN's attention backward and the antialiased resize before LPIPS have
# no deterministic algorithm (``torch.use_deterministic_algorithms`` names
# both), so two bare runs of one step differ (phase 13 prints by how much),
# and the steps after the first start from weights that differ. A
# process's first dit step also rounds its loss differently.
WORLD1_TOL = 1e-6
WORLD1_REPEATS = 3
# two gloo ranks sharing the card against one process on the whole batch:
# loss relative, the gradient at each clip and the update (new - old
# weights) relative L2, each within its limit or twice the most that
# DDP_REPEATS more one-process runs differ by, whichever is larger. The two
# runs differ in how the batch is split, and in the rounding of a backward
# that is not deterministic; Adam's first update is near lr sign(g), so a
# gradient that is zero but for rounding (a key norm's bias before the
# softmax) moves its weights by +-lr at random in every run. That spread
# itself varies from run to run (a second vae_b run's gradient at the
# second clip differed by 5.8e-4 in one run and 3.7e-3 in another, on the
# same card), so one more run alone is no measure of it.
DDP_LOSS_TOL = 1e-3
DDP_GRAD_TOL = 5e-3
DDP_REPEATS = 3
DDP_TIMEOUT = 600               # seconds for the two ranks of one layout
DDP_EVAL_TOL = 1e-3             # eval metrics, relative
EVAL_ITEMS = 2
DEVICE = "cuda"
PRESET = "dit"
TRAIN_PRESET = "vae_b"
DIT_PRESET = "dit"
DIT_STEPS = 3
N_VERTS = 100_002               # -> 100,000 Gaussians (one per face)
N_VIEWS = 4
G_STEPS = 3


def fail(msg: str):
    """Name the fault on both streams (a caller may keep only one) and exit
    with 1."""
    print(f"FAIL: {msg}", flush=True)
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
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


class PhaseClock:
    """Wall seconds of each named phase, from its start to the next one's."""

    def __init__(self):
        self.marks = []

    def start(self, name: str):
        self.marks.append((name, time.perf_counter()))

    def report(self):
        ends = [t for _, t in self.marks[1:]] + [time.perf_counter()]
        print("[phases] " + ", ".join(
            f"{n} {e - t:.1f} s" for (n, t), e in zip(self.marks, ends)),
            flush=True)


def hand_streams(rng, chunk=128, tile=32):
    """Two views of 2x2 tiles of ``tile`` x ``tile``: an empty tile, a
    segment straddling several chunks from an unaligned start, a saturating
    stack, a Gaussian centred on a pixel centre and one whose mean sits on
    a tile edge (at either tile side, also a 16-px one); then random
    segments."""
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
    edge = _pair_rows(float(tile), tile + 3.0, 3.0, 2.0, 0.2, 0.7,
                      np.random.default_rng(7))
    edge[0, 9] = 3.5                                  # behind the rest
    seg(np.concatenate([centred, gaussians(5, tile, tile), edge]))
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


def cull_cases(rng, chunk=128, tile=32):
    """Hand-made streams for the kernels' per-warp cull and launch
    order, each (pairs, tile_start, tile_count, ntx, tiles_per_view):

    Tiles of ``tile`` x ``tile`` pixels:

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

    n_bands = tile // 4
    band_y = np.repeat(4.0 * np.arange(n_bands) + 1.5,
                       np.arange(2, 2 + n_bands))
    rng.shuffle(band_y)
    bands = _pair_rows(tile / 2, band_y, 60.0, 1.2, 0.0, 0.97, rng)
    wide = _pair_rows(tile / 2, tile / 2, 300.0, 200.0, 0.3, 0.5, rng)
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


def k1_bytes(n_pairs, n_tiles, tile=32):
    """K1's own traffic: live pair rows and the segment arrays read once,
    the [n, 8, tile^2] f32 tile buffers written once."""
    return n_pairs * K1_ROW_BYTES + 8 * n_tiles + n_tiles * 8 * tile * tile * 4


def k1_kw(kw):
    """K1's arguments out of K2's (which also take ``out_bf16``)."""
    return {k: v for k, v in kw.items() if k != "out_bf16"}


def hold_k1(pairs, tile_start, tile_count, kw):
    """K1 against its plain version on one stream: the plain output, max
    |kernel - plain|, the kernel's ms (mean of 20 by CUDA events), the plain
    version's ms (one call), its per-class evaluation counts and both
    bounds (``bounds``)."""
    import torch

    from sigman_release_torch.ops.rasterizer import forward_tiles as k1

    out = k1.forward_tiles(pairs, tile_start, tile_count, **kw)
    work = {}
    t0 = time.perf_counter()
    plain = k1.forward_tiles_plain(pairs, tile_start, tile_count, work=work,
                                   **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    share = k1_cut_share(out, plain, pairs)
    diff = ((out[:, :5] - plain[:, :5]).abs() - share).clamp_min(0)
    err = diff.max().item()
    worst = np.unravel_index(int(diff.argmax()), tuple(diff.shape))
    at = {"tile, row, pixel": tuple(int(i) for i in worst),
          "row_err": [float(e) for e in diff.amax(dim=(0, 2))],
          "kernel": [float(v) for v in out[worst[0], :6, worst[2]]],
          "plain": [float(v) for v in plain[worst[0], :6, worst[2]]],
          "tile_pairs": int(tile_count[worst[0]]),
          "cut_pixels": int((share[:, 4] > 0).sum()),
          "cut_share_max": float(share.amax())}
    del out, diff, share
    ms = cuda_ms(lambda: k1.forward_tiles(pairs, tile_start, tile_count,
                                          **kw), reps=20)
    n_pairs = int(tile_count.sum())
    new, old = bounds(work, K1_WORK, K1_STAGE_OPS, n_pairs,
                      k1_bytes(n_pairs, tile_start.numel(),
                               kw.get("tile", 32)))
    return {"plain": plain, "err": err, "ms": ms, "plain_ms": plain_ms,
            "work": work, "n_pairs": n_pairs, "new": new, "old": old,
            "worst": at}


def hold_k2(args, kw):
    """K2 against its plain version on one backward's inputs (``args``: the
    stream, its segments, K1's tiles, the upstream gradients): the kernel's
    output, max |kernel - plain| and its per-column relative (with
    ``out_bf16``: also ``k2_bf16_excess``, against the plain version's f32
    output), the kernel's ms with the wrapper's zero fill (mean of 20), the
    plain version's ms (one call), its per-class evaluation counts, the
    rows with a gradient, and both bounds (``bounds``)."""
    import torch

    from sigman_release_torch.ops.rasterizer import backward_tiles as k2

    pairs, tile_start, tile_count = args[:3]
    out = k2.backward_tiles(*args, **kw)
    work = {}
    t0 = time.perf_counter()
    ref = k2.backward_tiles_plain(*args, work=work, **k1_kw(kw))
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, rel = k2_diff(out.float(), ref)
    excess = k2_bf16_excess(out, ref) if out.dtype == torch.bfloat16 else rel
    del ref
    ms = cuda_ms(lambda: k2.backward_tiles(*args, **kw), reps=20)
    n_pairs, n_tiles = int(tile_count.sum()), tile_start.numel()
    # rows the kernel must write: those with a nonzero gradient
    n_written = int((out[:, :10] != 0).any(dim=1).sum())
    # the function's own traffic: live pair rows read once, the 10 gradient
    # columns of the rows with a nonzero gradient written once (2 B a value
    # in bf16), forward rows 0-3, 5 and gradient rows 0-4 of the non-empty
    # tiles (an empty tile needs none) and the segment arrays read once. The
    # wrapper's zero fill of the whole [budget, 16] output is not the
    # kernel's work: it is printed beside the bound, not in it.
    px = args[3].shape[-1]                    # pixels of a tile
    n_bytes = (n_pairs * K1_ROW_BYTES + n_written * 10 * out.element_size()
               + int((tile_count > 0).sum()) * 10 * px * 4 + 8 * n_tiles)
    new, old = bounds(work, K2_WORK, K2_STAGE_OPS, n_pairs, n_bytes)
    return {"out": out, "err": err, "rel": rel, "excess": excess, "ms": ms,
            "plain_ms": plain_ms, "work": work, "n_pairs": n_pairs,
            "n_written": n_written, "new": new, "old": old}



def launch_alone_ms(args, kw, buf):
    """K2's launch alone (no zero fill, uncounted) on one backward's inputs
    into ``buf`` (zeros, the wrapper's output type): ms, mean of 20."""
    from sigman_release_torch.ops.rasterizer import backward_tiles as k2
    from sigman_release_torch.ops.rasterizer import forward_tiles as k1

    order = k1.launch_order(args[2])
    return cuda_ms(lambda: k2.launch(
        *args[:3], order, *args[3:5], buf, ntx=kw["ntx"],
        tiles_per_view=kw["tiles_per_view"], tile=kw.get("tile", 32),
        early_stop=kw.get("early_stop", True)), reps=20)


def k1_diff(out, ref):
    """Max |kernel - plain| over the rgb, depth and alpha rows."""
    return (out[:, :5] - ref[:, :5]).abs().max().item()


def k1_cut_share(out, ref, pairs):
    """[n, 5, 1024]: what one pair that K1 let through and its plain
    version did not (or the other way round) can add to |kernel - plain|
    on the rgb, depth and alpha rows; 0 elsewhere. Both stop a pixel
    before the first pair that would take its transmittance T below
    ``T_EPS``, but reach T by different roundings (a running product; exp
    of a sum of logs), so at a pixel whose T lands on the cut one may take
    that pair and the other not. Then the lower final T (row 5) is within
    ``K1_CUT_RTOL`` of the cut and the higher at most 1 / (1 -
    ``ALPHA_MAX``) times it, and the pair added alpha x T_high = T_high -
    T_low times its colour and depth to those rows and T_high - T_low to
    alpha: at most that gap times the stream's largest |colour| and
    |depth|. Everywhere else the two are held at ``K1_TOL`` as before."""
    import torch

    from sigman_release_torch.ops.rasterizer.binning import F_DEPTH, F_R
    from sigman_release_torch.ops.rasterizer.forward_tiles import (
        ALPHA_MAX,
        T_EPS,
    )

    lo = torch.minimum(out[:, 5], ref[:, 5])
    hi = torch.maximum(out[:, 5], ref[:, 5])
    at_cut = (((lo - T_EPS).abs() <= K1_CUT_RTOL * T_EPS)
              & (hi * (1 - ALPHA_MAX) <= lo * (1 + K1_CUT_RTOL)))
    gap = torch.where(at_cut, hi - lo, 0.0)
    scale = torch.cat([
        pairs[:, [F_R, F_R + 1, F_R + 2, F_DEPTH]].abs().amax(dim=0),
        torch.ones(1, device=pairs.device)])
    return gap[:, None, :] * scale[None, :, None]


def k2_diff(out, ref):
    """(max |kernel - plain|, max over columns of that over the plain
    column's max |value|)."""
    d = (out - ref).abs()
    scale = ref.abs().amax(dim=0) + 1e-30
    return d.max().item(), (d.amax(dim=0) / scale).max().item()


def k2_bf16_excess(out, ref):
    """K2's bf16 output against the plain version's f32 one: max over
    columns of max(|out - ref| - 2^-8 |ref|, 0) (one bf16 rounding to
    nearest is at most 2^-8 of the value) over the column's max |ref|."""
    d = ((out.float() - ref).abs() - ref.abs() * 2.0 ** -8).clamp_min(0)
    scale = ref.abs().amax(dim=0) + 1e-30
    return (d.amax(dim=0) / scale).max().item()


def grad_tiles(rng, n, tile=32):
    """Seeded upstream gradients [n, 8, tile^2] (rows 5-7 unused: zero)."""
    g = rng.normal(size=(n, 8, tile * tile)).astype(np.float32)
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
    from sigman_release_torch.ops import knn
    from sigman_release_torch.ops.rasterizer import backward_tiles as k2
    from sigman_release_torch.ops.rasterizer import forward_tiles as k1
    from sigman_release_torch.ops.rasterizer.render import (
        finish, prepare_pairs)
    from sigman_release_torch.utils import cuda_build
    from sigman_release_torch.utils.timing import StageTimer

    dev = torch.device(DEVICE)
    clock = PhaseClock()
    card = gpu_name_and_power()
    print(f"[smoke] card: {card}; torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}", flush=True)

    # ---- 1. build -----------------------------------------------------------
    clock.start("build")
    t0 = time.perf_counter()
    cuda_build.build([k1.SOURCE, k2.SOURCE, knn.SOURCE])
    print(f"[build] {len(cuda_build.build_logs)} source(s) built in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for src, log in cuda_build.build_logs.items():
        print(f"[build] {os.path.relpath(src, ROOT)}:\n{log.strip()}")

    # ---- 2. K1 on hand-made streams -------------------------------------------
    clock.start("k1")
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
    clock.start("main")
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
    knn.mean_knn_dist2.launches = 0
    t0 = time.perf_counter()
    res = pipe(image, smpl_vec, cv, cvp, generator=gen, steps=30, timer=timer)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = k1.forward_tiles.launches
    knn_serve = knn.mean_knn_dist2.launches
    render = res["render"]
    stages = ", ".join(f"{k} {v * 1e3:.1f} ms ({100 * v / wall:.1f}%)"
                       for k, v in timer.seconds.items())
    print(f"[main] request {wall * 1e3:.1f} ms: {stages}")
    print(f"[main] peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} "
          f"GiB; forward_tiles launches {launches}, mean_knn_dist2 launches "
          f"{knn_serve}; overflow {render['overflow'].tolist()}")
    alpha = render["alpha"]
    print(f"[main] alpha mean {alpha.mean().item():.4f}, coverage (alpha > "
          f"0.5) {(alpha > 0.5).float().mean().item():.4f}; image "
          f"{tuple(render['image'].shape)}", flush=True)
    if launches < 1:
        fail("the main path did not launch forward_tiles")
    if knn_serve != 1:
        fail(f"the main path launched mean_knn_dist2 {knn_serve} times, not "
             f"once for its one render")
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
    clock.start("plain")
    rc = pipe.renderer.raster_cfg
    with torch.no_grad():
        pos, cov3d, rgb, opa = pipe.renderer.prepare(res["gaussians"])
        stream = prepare_pairs(pos[0], cov3d[0], rgb[0], opa[0], cv.to(dev),
                               cvp.to(dev), rc)
        kw = dict(ntx=rc.ntx, tiles_per_view=rc.n_tiles, chunk=rc.chunk)
        held = hold_k1(stream.pairs, stream.tile_start, stream.tile_count, kw)
        bg = torch.ones(3, device=dev)
        img_plain = finish(held["plain"], stream.overflow, N_VIEWS, bg,
                           rc)["image"]
        img_err = (img_plain - render["image"][0]).abs().max().item()
    k1_err, k1_ms, plain_ms = held["err"], held["ms"], held["plain_ms"]
    k1_bound, k1_by = held["new"][:2]
    k1_bound_old = held["old"][0]
    # phase 17 renders this scene again at tile 16
    serve = {"pos": pos[0], "cov3d": cov3d[0], "rgb": rgb[0], "opa": opa[0],
             "cv": cv.to(dev), "cvp": cvp.to(dev), "rc": rc,
             "n_pairs": held["n_pairs"], "k1_ms": k1_ms, "plain_ms": plain_ms,
             "k1_bound": k1_bound, "k1_err": k1_err}
    print(f"[plain] main-path stream: {held['n_pairs']} pairs in "
          f"{stream.tile_count.numel()} tiles; evaluations {held['work']}; "
          f"max |kernel - plain| {k1_err:.3e}; image max diff {img_err:.3e}")
    print(f"[plain] serving stream: "
          f"{stream_text(stream.tile_count, held['work'])}")
    print(f"[plain] forward_tiles {k1_ms:.4f} ms, plain {plain_ms:.1f} ms, "
          f"{bound_text(k1_ms, held['new'], held['old'])}", flush=True)
    if not k1_err <= K1_TOL:
        fail(f"forward_tiles disagrees with its plain version on the main "
             f"path's stream: {k1_err}")
    if not img_err <= IMAGE_TOL:
        fail(f"image through the plain version differs by {img_err}")

    # ---- 5. test_tiny on the GPU against the CPU --------------------------------
    clock.start("small")
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

    del pipe, res, render, stream, held
    torch.cuda.empty_cache()
    train = train_phases(dev, body, template, clock)
    dit = dit_phases(dev, body, template, clock)
    ckpt = ckpt_phase(dev, body, template, clock)
    ddp = ddp_phase(dev, body, template, clock)
    data = data_phase(dev, body, template, clock, train["g_step_ms"])
    tmpl = template_phase(dev, clock)
    fsdp = fsdp_phase(dev, clock)
    knobs = knobs_phase(dev, body, template, clock, serve)
    knn_held = knn_phase(dev, template, clock)
    clock.report()

    # phase 14's paths, each counted from 0
    data_k1 = {"data_train_vae": data["k1_train"],
               "data_train_dit": data["k1_dit"],
               "data_test_vae": data["k1_test_vae"],
               "data_inference": data["k1_inference"],
               "data_inference_eval": data["k1_inference_eval"],
               "data_render_free": data["k1_free"]}
    data_k2 = {"data_train_vae": data["k2_train"],
               "data_render_free": data["k2_free"]}
    # phase 15's paths: the G step on the extracted template, the remat runs
    tmpl_k1 = {"template": tmpl["k1_template"],
               "template_remat": tmpl["k1_remat"]}
    tmpl_k2 = {"template": tmpl["k2_template"],
               "template_remat": tmpl["k2_remat"]}
    # the same paths' KNN launches; phase 18's own are left out
    knn_paths = {"serve": knn_serve, "train": train["knn_launches"],
                 "dit_train": dit["knn_launches"],
                 "vae_resume": ckpt["knn_resume"],
                 "vae_eval": ckpt["knn_eval"],
                 "ddp": ddp["mean_knn_dist2"], **data["knn"], **tmpl["knn"],
                 "fsdp": fsdp["k1"]["knn_launches"],
                 "knobs": knobs["knn_launches"]}
    kernels = [{
        "name": "forward_tiles",
        "route": "cuda",
        "source": "sigman_release_torch/ops/rasterizer/csrc/forward_tiles.cu",
        "replaces": "sigman_release_tpu/ops/rasterizer/pallas_forward.py:339",
        "launches": (launches + train["k1_launches"] + dit["k1_launches"]
                     + ckpt["k1_resume"] + ckpt["k1_eval"]
                     + ddp["forward_tiles"] + sum(data_k1.values())
                     + sum(tmpl_k1.values()) + fsdp["k1"]["launches"]
                     + knobs["k1_launches"]),
        "launches_by_path": {"serve": launches,
                             "train": train["k1_launches"],
                             "dit_train": dit["k1_launches"],
                             "vae_resume": ckpt["k1_resume"],
                             "vae_eval": ckpt["k1_eval"],
                             "ddp": ddp["forward_tiles"], **data_k1,
                             **tmpl_k1, "fsdp": fsdp["k1"]["launches"],
                             "knobs": knobs["k1_launches"]},
        "launches_by_variant": knobs["variants"]["k1"],
        "max_abs_err": k1_err,
        "max_abs_diff": k1_err,
        "ms": k1_ms,
        "plain_ms": plain_ms,
        "bound_ms": k1_bound,
        "bound_by": k1_by,
        "bound_ms_without_cull": k1_bound_old,
        "library_ms": None,
        "train": {"ms": train["k1_ms"], "plain_ms": train["k1_plain_ms"],
                  "bound_ms": train["k1_bound"],
                  "bound_ms_without_cull": train["k1_bound_old"],
                  "max_abs_err": train["k1_err"]},
        "dit_train": {"ms": dit["k1_ms"], "plain_ms": dit["k1_plain_ms"],
                      "bound_ms": dit["k1_bound"],
                      "bound_ms_without_cull": dit["k1_bound_old"],
                      "max_abs_err": dit["k1_err"]},
        "vae_eval": {"ms": ckpt["k1_ms"], "plain_ms": ckpt["k1_plain_ms"],
                     "bound_ms": ckpt["k1_bound"],
                     "bound_ms_without_cull": ckpt["k1_bound_old"],
                     "max_abs_err": ckpt["k1_err"]},
        "render_free": {"ms": data["k1"]["ms"],
                        "plain_ms": data["k1"]["plain_ms"],
                        "bound_ms": data["k1"]["bound_ms"],
                        "bound_ms_without_cull":
                            data["k1"]["bound_ms_without_cull"],
                        "max_abs_err": data["k1"]["err"]},
        "template": {"ms": tmpl["k1"]["ms"],
                     "plain_ms": tmpl["k1"]["plain_ms"],
                     "bound_ms": tmpl["k1"]["bound_ms"],
                     "bound_ms_without_cull":
                         tmpl["k1"]["bound_ms_without_cull"],
                     "max_abs_err": tmpl["k1"]["err"]},
        "fsdp": {"ms": fsdp["k1"]["ms"], "plain_ms": fsdp["k1"]["plain_ms"],
                 "bound_ms": fsdp["k1"]["bound_ms"],
                 "bound_ms_without_cull": fsdp["k1"]["bound_ms_without_cull"],
                 "max_abs_err": fsdp["k1"]["err"]},
        "tile16": knobs["k1_tile16"],
        "early_stop_off": knobs["k1_early_stop_off"],
    }, {
        "name": "backward_tiles",
        "route": "cuda",
        "source": "sigman_release_torch/ops/rasterizer/csrc/backward_tiles.cu",
        "replaces": "sigman_release_tpu/ops/rasterizer/pallas_backward.py:333",
        "launches": (train["k2_launches"] + ckpt["k2_resume"]
                     + ddp["backward_tiles"] + sum(data_k2.values())
                     + sum(tmpl_k2.values()) + knobs["k2_launches"]),
        "launches_by_path": {"serve": 0, "train": train["k2_launches"],
                             "dit_train": 0,
                             "vae_resume": ckpt["k2_resume"],
                             "vae_eval": 0, "ddp": ddp["backward_tiles"],
                             **data_k2, **tmpl_k2, "fsdp": 0,
                             "knobs": knobs["k2_launches"]},
        "launches_by_variant": knobs["variants"]["k2"],
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
        "render_free": {"ms": data["k2"]["ms"],
                        "plain_ms": data["k2"]["plain_ms"],
                        "bound_ms": data["k2"]["bound_ms"],
                        "bound_ms_without_cull":
                            data["k2"]["bound_ms_without_cull"],
                        "max_abs_err": data["k2"]["err"],
                        "max_col_rel_err": data["k2"]["rel"]},
        "template": {"ms": tmpl["k2"]["ms"],
                     "plain_ms": tmpl["k2"]["plain_ms"],
                     "bound_ms": tmpl["k2"]["bound_ms"],
                     "bound_ms_without_cull":
                         tmpl["k2"]["bound_ms_without_cull"],
                     "max_abs_err": tmpl["k2"]["err"],
                     "max_col_rel_err": tmpl["k2"]["rel"]},
        "tile16": knobs["k2_tile16"],
        "early_stop_off": knobs["k2_early_stop_off"],
        "bf16": knobs["k2_bf16"],
    }, {
        "name": "mean_knn_dist2",
        "route": "cuda",
        "source": "sigman_release_torch/ops/csrc/knn.cu",
        "replaces": None,
        "launches": sum(knn_paths.values()),
        "launches_by_path": knn_paths,
        **knn_held,
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


def train_phases(dev, body, template, clock):
    """Phases 6-9; returns the numbers the kernels line needs."""
    import torch

    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.ops import knn
    from sigman_release_torch.ops.rasterizer import backward_tiles as k2
    from sigman_release_torch.ops.rasterizer import forward_tiles as k1
    from sigman_release_torch.ops.rasterizer import render as render_lib
    from sigman_release_torch.training.vae_trainer import synthetic_setup
    from sigman_release_torch.utils.timing import StageTimer

    # ---- 6. K2 on hand-made streams -------------------------------------------
    clock.start("k2")
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
    clock.start("train")
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
    knn.mean_knn_dist2.launches = 0
    step_ms, spans = [], []
    try:
        for i in range(G_STEPS):
            timer = StageTimer(dev)
            c1, c2 = k1.forward_tiles.launches, k2.backward_tiles.launches
            ck = knn.mean_knn_dist2.launches
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = trainer.train_step_g(batch, timer=timer)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            spans.append(timer.seconds)
            logs = {k: float(v) for k, v in logs.items()}
            n1 = k1.forward_tiles.launches - c1
            n2 = k2.backward_tiles.launches - c2
            nk = knn.mean_knn_dist2.launches - ck
            print(f"[train] G step {i + 1}: {step_ms[-1]:.1f} ms, K1 "
                  f"launches {n1}, K2 launches {n2}, KNN launches {nk}, logs "
                  f"{logs}", flush=True)
            if n1 < 1 or n2 < 1:
                fail(f"G step {i + 1} did not launch both kernels ({n1}, {n2})")
            if nk != 1:
                fail(f"G step {i + 1} launched mean_knn_dist2 {nk} times, not "
                     f"once for its one render")
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
    knn_train = knn.mean_knn_dist2.launches
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
    clock.start("k2 main")
    a, kw = captured["args"], captured["kw"]
    pairs8, ts8, tc8 = a[:3]
    with torch.no_grad():
        held2 = hold_k2(a, kw)
        out = held2.pop("out")
        k2_err, k2_rel = held2["err"], held2["rel"]
        k2_ms, k2_plain_ms, work = held2["ms"], held2["plain_ms"], held2["work"]
        # the launch alone, into a buffer zeroed beforehand: every call
        # writes the same rows with the same values
        buf = torch.zeros_like(out)
        k2_kernel_ms = launch_alone_ms(a, kw, buf)
        if not torch.equal(buf, out):
            fail("backward_tiles' launch alone differs from the wrapper's")
        n_written = held2["n_written"]
        del out, buf
        held = hold_k1(pairs8, ts8, tc8, k1_kw(kw))
    k1_err, k1_ms, k1_plain_ms = held["err"], held["ms"], held["plain_ms"]
    k1_new, k1_old = held["new"], held["old"]
    n_pairs, n_tiles = held["n_pairs"], ts8.numel()
    print(f"[k1 train] forward_tiles on the training stream {k1_ms:.4f} ms, "
          f"plain {k1_plain_ms:.1f} ms, max |kernel - plain| {k1_err:.3e}; "
          f"{bound_text(k1_ms, k1_new, k1_old)}", flush=True)
    if not k1_err <= K1_TOL:
        fail(f"forward_tiles disagrees with its plain version on the "
             f"training stream: {k1_err}")
    k2_new, k2_old = held2["new"], held2["old"]
    k2_bound, k2_by = k2_new[:2]
    print(f"[k2 main] stream: {n_pairs} pairs in {n_tiles} tiles (budget "
          f"{pairs8.shape[0]}), {n_written} rows with a gradient; "
          f"evaluations {work}; max |kernel - plain| {k2_err:.3e}, "
          f"per-column relative {k2_rel:.3e}")
    print(f"[k2 main] training stream: {stream_text(tc8, work)}")
    fill_ms = pairs8.numel() * 4 / H100_BYTES_PER_S * 1e3
    print(f"[k2 main] backward_tiles {k2_ms:.4f} ms with the wrapper's zero "
          f"fill of the {pairs8.numel() * 4 / 1e6:.0f} MB output (at least "
          f"{fill_ms:.4f} ms, outside the bound), {k2_kernel_ms:.4f} ms the "
          f"launch alone; plain {k2_plain_ms:.1f} ms; "
          f"{bound_text(k2_kernel_ms, k2_new, k2_old)}", flush=True)
    if not k2_rel <= K2_TOL:
        fail(f"backward_tiles disagrees with its plain version on the "
             f"training stream: {k2_rel}")
    del trainer, batch, captured, a, held
    torch.cuda.empty_cache()

    # ---- 9. test_tiny G step on the GPU against the CPU ---------------------
    clock.start("small train")
    loss_rel, grad_rel = small_train_step_diff(dev)
    print(f"[small train] test_tiny G step GPU vs CPU: loss relative "
          f"{loss_rel:.3e}, gradient relative L2 {grad_rel:.3e}", flush=True)
    if not loss_rel <= SMALL_LOSS_TOL or not grad_rel <= SMALL_GRAD_TOL:
        fail(f"test_tiny G step on the GPU differs from the CPU: loss "
             f"{loss_rel}, gradient {grad_rel}")
    return {"k1_launches": k1_train, "k2_launches": k2_train,
            "knn_launches": knn_train,
            "g_step_ms": med, "k2_err": k2_err, "k2_rel": k2_rel, "k2_ms": k2_ms,
            "k2_kernel_ms": k2_kernel_ms, "k2_plain_ms": k2_plain_ms,
            "k2_bound": k2_bound, "k2_by": k2_by,
            "k2_bound_old": k2_old[0], "k1_ms": k1_ms,
            "k1_plain_ms": k1_plain_ms, "k1_err": k1_err,
            "k1_bound": k1_new[0], "k1_bound_old": k1_old[0]}


def trainer_state(t):
    """Every tensor and count a resumed ``VAETrainer`` must restore, on the
    host: weights (VAE, logvar, discriminator), both AdamW states, partial
    gradient sums, the step and micro-step counts, the generator."""
    def host(x):
        return x.detach().to("cpu", copy=True)

    tensors = [host(p) for p in [*t.params_g, *t.disc.parameters()]]
    for opt in (t.opt_g, t.opt_d):
        for group in opt.param_groups:
            for p in group["params"]:
                tensors += [host(v) for _, v in
                            sorted(opt.state.get(p, {}).items())]
    tensors += [host(p.grad) for p in [*t.params_g, *t.disc.parameters()]
                if p.grad is not None]
    return tensors, (t.step, dict(t._micro)), t.generator.get_state()


def write_safetensors(path, tensors):
    """{name: numpy array} as a safetensors file: an 8-byte little-endian
    header length, the JSON header (padded to 8 bytes), the raw bytes."""
    kinds = {np.dtype(np.float32): "F32", np.dtype(np.int64): "I64"}
    header, offset = {}, 0
    for name, a in tensors.items():
        header[name] = {"dtype": kinds[a.dtype], "shape": list(a.shape),
                        "data_offsets": [offset, offset + a.nbytes]}
        offset += a.nbytes
    head = json.dumps(header).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for a in tensors.values():
            f.write(np.ascontiguousarray(a).tobytes())


def small_dit_resume_diff(dev, path):
    """``test_tiny`` DiT at gradient_accumulation_steps 2 on ``dev``: four
    micro-steps in one trainer against one, a save to ``path``, a resume
    into a fresh trainer and micro-steps 2-4 (pre-encoded batches, draws
    from the trainers' generators, TF32 off, cuDNN deterministic). Returns
    the max |weight difference| and the counts of both."""
    import torch

    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.models.vae import VAEModel
    from sigman_release_torch.training.dit_trainer import (
        DiTTrainer, make_encoder)

    cfg = PRESETS["test_tiny"].replace(gradient_accumulation_steps=2,
                                       noised_condition_dropout=0.5)
    rng = np.random.default_rng(6)
    h = cfg.sample_height
    batches = [{"latent": torch.from_numpy(rng.normal(size=(
                    2, cfg.latent_channels, h, h)).astype(np.float32)).to(dev),
                "cond": torch.from_numpy(rng.normal(size=(
                    2, cfg.text_embed_dim, h, h)).astype(np.float32)).to(dev)}
               for _ in range(4)]
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.deterministic)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    try:
        def trainer():
            return DiTTrainer(cfg, VAEModel(cfg), make_encoder(cfg),
                              device=dev)

        whole = trainer()
        for b in batches:
            whole.train_step(b)
        first = trainer()
        first.train_step(batches[0])
        first.save(path)
        resumed = trainer()
        resumed.resume(path)
        for b in batches[1:]:
            resumed.train_step(b)
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.deterministic) = prev
        if os.path.exists(path):
            os.remove(path)
    diff = max((p - q).abs().max().item() for p, q in
               zip(resumed.model.parameters(), whole.model.parameters()))
    counts = [(t.step, t.updates, t._micro) for t in (resumed, whole)]
    return diff, counts


def ckpt_phase(dev, body, template, clock):
    """Phase 12; returns the numbers the kernels line needs."""
    import torch

    from sigman_release_torch import convert
    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.data.dataset import SyntheticAvatarDataset
    from sigman_release_torch.data.loader import DataLoader
    from sigman_release_torch.losses.gan import PatchDiscriminator
    from sigman_release_torch.models.vae import VAEModel
    from sigman_release_torch.ops import knn
    from sigman_release_torch.ops.rasterizer import backward_tiles as k2
    from sigman_release_torch.ops.rasterizer import forward_tiles as k1
    from sigman_release_torch.ops.rasterizer import render as render_lib
    from sigman_release_torch.training import checkpoint
    from sigman_release_torch.training.vae_trainer import (
        VAETrainer, synthetic_setup)

    clock.start("ckpt")
    cfg = PRESETS[TRAIN_PRESET]
    trainer, batch = synthetic_setup(cfg, device=dev, body_model=body,
                                     template=template)
    trainer.train_step_g(batch)
    trainer.train_step_d(batch)
    build = os.path.join(ROOT, "build", "smoke_ckpt")
    os.makedirs(build, exist_ok=True)
    path = os.path.join(build, "vae_state.pt")
    try:
        # ---- save, resume into a fresh trainer, one more G step on both
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        trainer.save(path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        saved = trainer_state(trainer)
        q, c = cfg.uv_query_size, cfg.latent_channels
        noise = torch.from_numpy(np.random.default_rng(12).normal(
            size=(1, q, q, c)).astype(np.float32)).to(dev)
        loss_a = trainer.train_step_g(batch, noise)["loss"].item()
        after_a = [p.detach().clone() for p in trainer.params_g]
        fresh = VAETrainer(cfg, body_model=body, template=template,
                           device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fresh.resume(path)
        torch.cuda.synchronize()
        resume_s = time.perf_counter() - t0
        got = trainer_state(fresh)
        n_equal = sum(torch.equal(x, y) for x, y in zip(saved[0], got[0]))
        print(f"[ckpt] save {save_s:.2f} s, {size} bytes; resume into a "
              f"fresh trainer {resume_s:.2f} s; {n_equal} of "
              f"{len(saved[0])} tensors equal bit for bit; step / micro "
              f"{got[1]} (saved {saved[1]}); generator state equal "
              f"{torch.equal(saved[2], got[2])}", flush=True)
        if (len(got[0]) != len(saved[0]) or n_equal != len(saved[0])
                or got[1] != saved[1] or not torch.equal(saved[2], got[2])):
            fail("the resumed vae_b state differs from the saved one")
        del saved, got
        k1.forward_tiles.launches = 0
        k2.backward_tiles.launches = 0
        knn.mean_knn_dist2.launches = 0
        loss_b = fresh.train_step_g(batch, noise)["loss"].item()
        k1_resume, k2_resume = (k1.forward_tiles.launches,
                                k2.backward_tiles.launches)
        knn_resume = knn.mean_knn_dist2.launches
        num = sum(((p.detach() - a) ** 2).sum().item()
                  for p, a in zip(fresh.params_g, after_a))
        den = sum((a ** 2).sum().item() for a in after_a)
        loss_rel = abs(loss_b - loss_a) / abs(loss_a)
        param_rel = (num / den) ** 0.5
        print(f"[ckpt] the next G step, original / resumed: loss "
              f"{loss_a:.8f} / {loss_b:.8f} (relative {loss_rel:.3e}); "
              f"updated weights relative L2 {param_rel:.3e}; K1 launches "
              f"{k1_resume}, K2 launches {k2_resume}", flush=True)
        if not loss_rel <= RESUME_LOSS_TOL or not param_rel <= RESUME_PARAM_TOL:
            fail(f"the resumed G step differs: loss {loss_rel}, weights "
                 f"{param_rel}")
        if k1_resume != 1 or k2_resume != 1:
            fail(f"the resumed G step launched K1 {k1_resume}, K2 "
                 f"{k2_resume} times, not once each")
        del after_a, trainer, batch
        torch.cuda.empty_cache()
    finally:
        if os.path.exists(path):
            os.remove(path)

    # ---- reference-layout safetensors, written here, read back
    for name, module, fresh_module in (
            ("vae", fresh.vae, lambda: VAEModel(cfg)),
            ("disc", fresh.disc,
             lambda: PatchDiscriminator(n_layers=len(fresh.disc.norms)))):
        src = module.state_dict()
        names = convert.reference_key_map(module)
        tensors = {names[n]: t.detach().cpu().numpy() for n, t in src.items()}
        if name == "disc":      # BatchNorm statistics, as the reference's
            for k in range(len(module.norms)):
                ch = module.norms[k].num_channels
                base = f"main.{3 + 3 * k}"
                tensors[f"{base}.running_mean"] = np.zeros(ch, np.float32)
                tensors[f"{base}.running_var"] = np.ones(ch, np.float32)
                tensors[f"{base}.num_batches_tracked"] = np.array(
                    1000, np.int64)
        st_path = os.path.join(build, f"{name}.safetensors")
        try:
            write_safetensors(st_path, tensors)
            with torch.device(dev):
                target = fresh_module()
            t0 = time.perf_counter()
            sd, stats = checkpoint.load_params_any(st_path, target, cfg,
                                                   verbose=False)
            target.load_state_dict(sd)
            torch.cuda.synchronize()
            read_s = time.perf_counter() - t0
            st_bytes = os.path.getsize(st_path)
        finally:
            if os.path.exists(st_path):
                os.remove(st_path)
        back = target.state_dict()
        n_equal = sum(torch.equal(back[n], t) for n, t in src.items())
        print(f"[ckpt] reference-layout {name} file {st_bytes} bytes, read "
              f"into a fresh module in {read_s:.2f} s: {stats['restored']} "
              f"restored, missing {len(stats['missing'])}, mismatched "
              f"{len(stats['mismatched'])}, unused {len(stats['unused'])}; "
              f"{n_equal} of {len(src)} tensors equal", flush=True)
        if (n_equal != len(src) or stats["missing"] or stats["mismatched"]
                or stats["unused"]):
            fail(f"the reference-layout {name} file did not read back equal")
        del target, back, sd, tensors
    torch.cuda.empty_cache()

    # ---- evaluate over held-out items through K1
    eval_loader = DataLoader(SyntheticAvatarDataset(cfg, n_items=EVAL_ITEMS,
                                                    seed=999),
                             1, shuffle=False, num_workers=1,
                             drop_last=False)
    captured = {}
    real_forward = render_lib.forward_tiles

    def capturing_forward(*a, **kw):       # keeps the last eval render's
        captured.update(args=a, kw=kw)
        return real_forward(*a, **kw)

    vis = os.path.join(ROOT, "chiprun_out", "vae_eval.png")
    if os.path.exists(vis):
        os.remove(vis)
    step_ms = []

    def timed_eval_step(b):                # the device part of each batch
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = type(fresh).eval_step(fresh, b)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return out

    fresh.eval_step = timed_eval_step
    render_lib.forward_tiles = capturing_forward
    k1.forward_tiles.launches = 0
    knn.mean_knn_dist2.launches = 0
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ev = fresh.evaluate(eval_loader, vis_path=vis)
        torch.cuda.synchronize()
        eval_ms = (time.perf_counter() - t0) * 1e3
    finally:
        render_lib.forward_tiles = real_forward
        del fresh.eval_step
    k1_eval, knn_eval = k1.forward_tiles.launches, knn.mean_knn_dist2.launches
    print(f"[eval] evaluate over {EVAL_ITEMS} held-out items at batch 1 "
          f"({cfg.num_views} views at {cfg.output_size}^2, LPIPS "
          f"{cfg.eval_lpips_net}) {eval_ms:.1f} ms, of which eval_step "
          f"{', '.join(f'{t:.1f}' for t in step_ms)} ms (the rest waits on the "
          f"held-out items the loader builds on the host, and writes the "
          f"PNG): {ev}; "
          f"forward_tiles launches {k1_eval}; PNG written "
          f"{os.path.exists(vis)}", flush=True)
    if not all(np.isfinite(v) for v in ev.values()) or len(ev) != 4:
        fail(f"non-finite or missing eval metrics: {ev}")
    if k1_eval != len(eval_loader):
        fail(f"evaluate launched K1 {k1_eval} times for "
             f"{len(eval_loader)} eval batches")
    if not os.path.exists(vis):
        fail("evaluate wrote no PNG")
    a, kw = captured["args"], captured["kw"]
    with torch.no_grad():
        held = hold_k1(*a[:3], kw)
    print(f"[k1 eval] forward_tiles on the eval's stream ({held['n_pairs']} "
          f"pairs in {a[1].numel()} tiles) {held['ms']:.4f} ms, plain "
          f"{held['plain_ms']:.1f} ms, max |kernel - plain| "
          f"{held['err']:.3e}; {bound_text(held['ms'], held['new'], held['old'])}",
          flush=True)
    print(f"[k1 eval] stream: {stream_text(a[2], held['work'])}")
    if not held["err"] <= K1_TOL:
        fail(f"forward_tiles disagrees with its plain version on the eval's "
             f"stream: {held['err']}")
    del fresh, captured, a, held["plain"]
    torch.cuda.empty_cache()

    # ---- test_tiny DiT: an accumulation saved and resumed
    diff, counts = small_dit_resume_diff(
        dev, os.path.join(build, "dit_tiny.pt"))
    print(f"[ckpt] test_tiny DiT accumulation saved at micro-step 1 of 2 and "
          f"resumed: max |weight difference| {diff:.3e} against an "
          f"uninterrupted run; (step, updates, micro) {counts}", flush=True)
    if not diff <= SMALL_RESUME_TOL or counts[0] != counts[1]:
        fail(f"the resumed test_tiny DiT accumulation differs: {diff}, "
             f"{counts}")
    return {"k1_resume": k1_resume, "k2_resume": k2_resume,
            "knn_resume": knn_resume, "knn_eval": knn_eval,
            "k1_eval": k1_eval, "k1_err": held["err"], "k1_ms": held["ms"],
            "k1_plain_ms": held["plain_ms"], "k1_bound": held["new"][0],
            "k1_bound_old": held["old"][0]}


def small_dit_step_diff(dev):
    """One ``test_tiny`` DiT step on ``dev`` and on the CPU from the same
    weights, batch (two synthetic items, raw path) and draws, TF32 off:
    (loss relative difference, gradient relative L2 difference). With two
    accumulation micro-steps the step leaves its gradients in place."""
    import torch

    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.data.dataset import SyntheticAvatarDataset
    from sigman_release_torch.inference import random_weights_
    from sigman_release_torch.models.vae import VAEModel
    from sigman_release_torch.training.dit_trainer import (
        RAW_KEYS, DiTTrainer, build_on, make_encoder)

    cfg = PRESETS["test_tiny"].replace(gradient_accumulation_steps=2,
                                       noised_condition_dropout=0.5)
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        trainers = []
        for d in ("cpu", dev):
            gen = torch.Generator().manual_seed(3)
            vae = random_weights_(VAEModel(cfg), gen)
            enc = build_on("cpu", lambda: make_encoder(cfg), gen)
            trainers.append(DiTTrainer(cfg, vae, enc, device=d))
        cpu, gpu = trainers
        gpu.model.load_state_dict(cpu.model.state_dict())
        data = SyntheticAvatarDataset(cfg, n_items=2)
        raw = {k: np.stack([data[i][k] for i in range(2)]) for k in RAW_KEYS}
        rng = np.random.default_rng(5)
        q, c = cfg.uv_query_size, cfg.latent_channels
        draws = {
            "enc_noise": rng.normal(size=(2, q, q, c)).astype(np.float32),
            "t": np.array([37, 912]),
            "noise": rng.normal(size=(2, c, q, q)).astype(np.float32),
            "drop": np.array([False, True]).reshape(2, 1, 1, 1)}
        draws = {k: torch.from_numpy(v) for k, v in draws.items()}
        lc, lg = (tr.train_step(tr.to_device(raw), draws)["loss"].item()
                  for tr in (cpu, gpu))
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    gc = torch.cat([p.grad.flatten() for p in cpu.model.parameters()])
    gg = torch.cat([p.grad.flatten() for p in gpu.model.parameters()]).cpu()
    return abs(lg - lc) / abs(lc), ((gg - gc).norm() / gc.norm()).item()


def dit_phases(dev, body, template, clock):
    """Phases 10-11; returns the numbers the kernels line needs."""
    import torch

    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.ops import knn
    from sigman_release_torch.ops.rasterizer import forward_tiles as k1
    from sigman_release_torch.ops.rasterizer import render as render_lib
    from sigman_release_torch.training.dit_trainer import (
        step_flops, synthetic_setup)
    from sigman_release_torch.utils.timing import StageTimer

    # ---- 10. dit training steps at full width -------------------------------
    clock.start("dit train")
    cfg = PRESETS[DIT_PRESET]
    t0 = time.perf_counter()
    trainer, batch, eval_batch = synthetic_setup(
        cfg, device=dev, body_model=body, template=template)
    torch.cuda.synchronize()
    dit = trainer.model
    n_dit = sum(p.numel() for p in dit.parameters())
    n_enc = sum(p.numel() for p in trainer.encoder.parameters())
    n_vae = sum(p.numel() for p in trainer.vae.parameters())
    print(f"[dit] set-up {time.perf_counter() - t0:.1f} s: DiT "
          f"{n_dit / 1e9:.3f} B params (d={cfg.hidden_dim} x "
          f"{cfg.num_layers}), encoder {n_enc / 1e9:.3f} B "
          f"({len(trainer.encoder.blocks)} layers at {cfg.text_embed_dim}), "
          f"VAE {n_vae / 1e6:.1f} M, frozen; batch "
          f"{ {k: tuple(v.shape) for k, v in batch.items()} }, "
          f"DiT {cfg.mixed_precision}, encodes f32, checkpointing "
          f"{cfg.gradient_checkpointing}", flush=True)
    blocks = dit.transformer_blocks
    watch = {"patch_embed.proj": dit.patch_embed.proj.weight,
             "proj_out": dit.proj_out.weight,
             "block 0 to_q": blocks[0].attn1.to_q.weight,
             f"block {len(blocks) - 1} ff.net.2": blocks[-1].ff.net[2].weight}
    before = {n: w.detach().clone() for n, w in watch.items()}
    captured = {}
    real_forward = render_lib.forward_tiles

    def capturing_forward(*a, **kw):       # keeps the eval render's K1 inputs
        captured.update(args=a, kw=kw)
        return real_forward(*a, **kw)

    torch.cuda.reset_peak_memory_stats()
    k1.forward_tiles.launches = 0
    knn.mean_knn_dist2.launches = 0
    step_ms, spans, losses = [], [], []
    for i in range(DIT_STEPS):
        timer = StageTimer(dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss = trainer.train_step(batch, timer=timer)["loss"].item()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        spans.append(timer.seconds)
        losses.append(loss)
        print(f"[dit] step {i + 1}: {step_ms[-1]:.1f} ms, loss {loss:.6f}, "
              f"lr {trainer.lr_at(trainer.updates - 1):.3e}", flush=True)
        if not np.isfinite(loss):
            fail(f"non-finite loss in DiT step {i + 1}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    delta = {n: (w.detach() - before[n]).abs().max().item()
             for n, w in watch.items()}
    del before
    med = statistics.median(step_ms[1:])
    total = step_ms[-1] / 1e3
    stages = ", ".join(f"{k} {v * 1e3:.1f} ms ({100 * v / total:.1f}%)"
                       for k, v in spans[-1].items())
    grid = cfg.input_size // trainer.encoder.patch_proj.stride[0]
    flops = step_flops(cfg, batch["input"].shape[0], (grid // 4) ** 2)
    fwd_bwd = spans[-1]["dit_fwd_bwd"]
    print(f"[dit] step median of steps 2-{DIT_STEPS}: {med:.1f} ms; step "
          f"{DIT_STEPS} spans: {stages}")
    print(f"[dit] peak memory {peak:.2f} GiB; max |param change| after step "
          f"{DIT_STEPS}: {delta}")
    print(f"[dit] model FLOPs per step {flops['model']:.4e} (6 N tokens + "
          f"attention), {flops['with_recompute']:.4e} with the recompute: "
          f"{100 * flops['model'] / (med / 1e3) / H100_BF16_FLOPS:.2f}% of "
          f"the dense bf16 peak over the step median, "
          f"{100 * flops['with_recompute'] / fwd_bwd / H100_BF16_FLOPS:.2f}% "
          f"(with the recompute) over step {DIT_STEPS}'s dit_fwd_bwd span",
          flush=True)
    for n, d in delta.items():
        if not d > 0:
            fail(f"the DiT steps did not move {n}")
    eval_loss = trainer.eval_loss(eval_batch).item()
    render_lib.forward_tiles = capturing_forward
    timer = StageTimer(dev)
    try:
        t0 = time.perf_counter()
        ev = trainer.sample_eval(eval_batch, timer=timer,
                                 vis_path=os.path.join(ROOT, "chiprun_out",
                                                       "dit_sample.png"))
        torch.cuda.synchronize()
        ev_s = time.perf_counter() - t0
    finally:
        render_lib.forward_tiles = real_forward
    k1_dit, knn_dit = k1.forward_tiles.launches, knn.mean_knn_dist2.launches
    stages = ", ".join(f"{k} {v * 1e3:.1f} ms" for k, v in
                       timer.seconds.items())
    print(f"[dit] eval loss {eval_loss:.6f}; sample_eval "
          f"({cfg.num_inference_steps} CFG steps, {cfg.num_views} views at "
          f"{cfg.output_size}^2) {ev_s * 1e3:.1f} ms: {stages}; sample PSNR "
          f"{ev['sample_psnr']:.4f}; forward_tiles launches {k1_dit}, "
          f"mean_knn_dist2 launches {knn_dit}", flush=True)
    if not (np.isfinite(eval_loss) and np.isfinite(ev["sample_psnr"])):
        fail(f"non-finite eval: loss {eval_loss}, {ev}")
    if k1_dit < 1:
        fail("the DiT path did not launch forward_tiles")
    a, kw = captured["args"], captured["kw"]
    with torch.no_grad():
        held = hold_k1(*a[:3], kw)
    print(f"[k1 dit] forward_tiles on the sampling eval's stream "
          f"({held['n_pairs']} pairs in {a[1].numel()} tiles) "
          f"{held['ms']:.4f} ms, plain {held['plain_ms']:.1f} ms, max "
          f"|kernel - plain| {held['err']:.3e}; "
          f"{bound_text(held['ms'], held['new'], held['old'])}", flush=True)
    print(f"[k1 dit] stream: {stream_text(a[2], held['work'])}")
    if not held["err"] <= K1_TOL:
        fail(f"forward_tiles disagrees with its plain version on the DiT "
             f"sampling eval's stream: {held['err']}")
    del trainer, batch, eval_batch, captured, a, held["plain"]
    torch.cuda.empty_cache()

    # ---- 11. test_tiny DiT step on the GPU against the CPU -------------------
    clock.start("small dit")
    loss_rel, grad_rel = small_dit_step_diff(dev)
    print(f"[small dit] test_tiny DiT step GPU vs CPU: loss relative "
          f"{loss_rel:.3e}, gradient relative L2 {grad_rel:.3e}", flush=True)
    if not loss_rel <= SMALL_LOSS_TOL or not grad_rel <= SMALL_GRAD_TOL:
        fail(f"test_tiny DiT step on the GPU differs from the CPU: loss "
             f"{loss_rel}, gradient {grad_rel}")
    return {"k1_launches": k1_dit, "knn_launches": knn_dit,
            "k1_err": held["err"], "k1_ms": held["ms"],
            "k1_plain_ms": held["plain_ms"], "k1_bound": held["new"][0],
            "k1_bound_old": held["old"][0]}


class ClipTap:
    """At each clip of ``module``'s optimizer step (its
    ``clip_by_global_norm_``): copy the gradients to the host, or hold them
    against such a copy taken in another run (relative L2, one tensor at a
    time on the card)."""

    def __init__(self, module, against=None):
        self.module, self.against = module, against
        self.real = module.clip_by_global_norm_
        self.host, self.rel = [], []

    def __enter__(self):
        def clip(params, max_norm):
            params = list(params)
            grads = [p.grad for p in params]
            if self.against is None:
                self.host.append(host_copy(grads))
            else:
                self.rel.append(rel_l2(grads, self.against[len(self.rel)]))
            return self.real(params, max_norm)

        self.module.clip_by_global_norm_ = clip
        return self

    def __exit__(self, *exc):
        self.module.clip_by_global_norm_ = self.real


def host_copy(tensors):
    return [t.detach().float().to("cpu", copy=True) for t in tensors]


def rel_l2(tensors, host):
    """|tensors - host| / |host| in L2 over all tensors, summed in f64 (one
    tensor at a time: the card holds one host tensor's copy at most)."""
    import torch

    num = den = 0.0
    for t, h in zip(tensors, host):
        h = h.to(t.device)
        num += float((t.detach().float() - h).square().sum(
            dtype=torch.float64))
        den += float(h.square().sum(dtype=torch.float64))
    return (num / max(den, 1e-300)) ** 0.5


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def world1_steps(make, kind, run, step, module, against=None):
    """``make()`` -> a trainer; ``run(trainer)`` takes its steps and
    returns their losses; ``step(trainer)`` takes one more step, timed
    twice after them without the tap. Returns the losses, the gradients at
    each clip (host copies, or their relative L2 against ``against``), the
    new weights on the host (or theirs), the peak GiB of the steps, the
    timed steps' ms and, under DDP, its buckets."""
    import torch

    from sigman_release_torch.parallel.cases import buckets

    trainer = make()
    params = (list(trainer.model.parameters()) if kind == "dit"
              else [*trainer.params_g, *trainer.disc.parameters()])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with ClipTap(module, against and against["clips"]) as tap:
        losses = run(trainer)
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {"losses": losses, "peak": peak,
           "buckets": buckets(trainer.ddp if kind == "dit"
                              else trainer.ddp_g)}
    if against is None:
        out.update(clips=tap.host, weights=host_copy(params))
    else:
        out.update(clip_rel=tap.rel,
                   weights_rel=rel_l2(params, against["weights"]))
    out["ms"] = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(trainer)
        torch.cuda.synchronize()
        out["ms"].append((time.perf_counter() - t0) * 1e3)
    del trainer, params
    torch.cuda.empty_cache()
    return out


def hold_two_ranks(name, r0, floor, weights_key, repeats):
    """Fail unless two ranks' run (``r0`` of a ``cases`` result) is within
    the limits or twice the most that ``repeats`` more one-process runs
    differ by (``floor``): each loss, each clip's gradient, and
    ``weights_key`` ("update_rel" or "weights_rel")."""
    checks = ([(d, f, DDP_LOSS_TOL) for d, f in
               zip(r0["loss_rel"], floor["loss_rel"])]
              + [(d, f, DDP_GRAD_TOL) for d, f in
                 zip(r0["grad_rel"], floor["grad_rel"])]
              + [(r0[weights_key], floor[weights_key], DDP_GRAD_TOL)])
    if (r0["n_clips"][0] != r0["n_clips"][1]
            or not all(d <= max(tol, 2 * f) for d, f, tol in checks)):
        fail(f"{name}: two ranks differ from one process by more than the "
             f"limits and twice the most that {repeats} more one-process "
             f"runs differ by: {checks}")


def ddp_phase(dev, body, template, clock):
    """Phase 13; returns the K1 / K2 launches of its DDP runs."""
    import torch
    import torch.distributed as dist

    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.ops import knn
    from sigman_release_torch.ops.rasterizer import backward_tiles as k2
    from sigman_release_torch.ops.rasterizer import forward_tiles as k1
    from sigman_release_torch.parallel import cases, launch
    from sigman_release_torch.parallel.mesh import make_mesh
    from sigman_release_torch.training import dit_trainer, vae_trainer

    clock.start("ddp")
    # ---- (a) NCCL at world size 1 against more runs of the bare trainers
    cfg = PRESETS[TRAIN_PRESET].replace(disc_start=2)
    q, c = cfg.uv_query_size, cfg.latent_channels
    noise = torch.from_numpy(np.random.default_rng(13).normal(
        size=(1, q, q, c)).astype(np.float32)).to(dev)
    batch = {}

    def make_vae(mesh):
        def make():
            trainer, b = vae_trainer.synthetic_setup(
                cfg, device=dev, body_model=body, template=template,
                mesh=mesh)
            batch.update(b)
            return trainer
        return make

    def run_vae(trainer):
        return [float(trainer.train_step_g(batch, noise)["loss"]),
                float(trainer.train_step_g(batch, noise)["loss"]),
                float(trainer.train_step_d(batch, noise)["GAN_D"])]

    def g_step(trainer):
        trainer.train_step_g(batch, noise)

    vae_runs = (run_vae, g_step, vae_trainer)
    bare = world1_steps(make_vae(cases.ONE), "vae", *vae_runs)
    again = [world1_steps(make_vae(cases.ONE), "vae", *vae_runs,
                          against=bare) for _ in range(WORLD1_REPEATS)]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    try:
        mesh = make_mesh()
        k1.forward_tiles.launches = 0
        k2.backward_tiles.launches = 0
        knn.mean_knn_dist2.launches = 0
        wrapped = world1_steps(make_vae(mesh), "vae", *vae_runs,
                               against=bare)
        launches = {"forward_tiles": k1.forward_tiles.launches,
                    "backward_tiles": k2.backward_tiles.launches,
                    "mean_knn_dist2": knn.mean_knn_dist2.launches}
        del batch
        out_vae = world1_report("vae_b", bare, again, wrapped)
        print(f"[ddp] vae_b under DDP: K1 launches "
              f"{launches['forward_tiles']}, K2 launches "
              f"{launches['backward_tiles']}, KNN launches "
              f"{launches['mean_knn_dist2']} (4 G steps, 1 D step)",
              flush=True)
        if launches != {"forward_tiles": 5, "backward_tiles": 4,
                        "mean_knn_dist2": 5}:
            fail(f"the vae_b steps under DDP launched K1 / K2 / KNN "
                 f"{launches}, not 5 / 4 / 5 times")

        dcfg = PRESETS[DIT_PRESET]
        draws = {k: torch.from_numpy(np.asarray(v)).to(dev) for k, v in
                 cases.dit_draws(dcfg, dcfg.batch_size, 13).items()}
        parts = {}

        def make_dit(m):
            def make():
                if not parts:
                    trainer, b, _ = dit_trainer.synthetic_setup(
                        dcfg, device=dev, body_model=body, template=template,
                        mesh=m)
                    parts.update(batch=b, vae=trainer.vae,
                                 encoder=trainer.encoder)
                    return trainer
                return dit_trainer.DiTTrainer(dcfg, parts["vae"],
                                              parts["encoder"], device=dev,
                                              mesh=m)
            return make

        def dit_step(trainer):
            return float(trainer.train_step(parts["batch"], draws)["loss"])

        dit_runs = (lambda t: [dit_step(t), dit_step(t)], dit_step,
                    dit_trainer)
        bare = world1_steps(make_dit(cases.ONE), "dit", *dit_runs)
        again = [world1_steps(make_dit(cases.ONE), "dit", *dit_runs,
                              against=bare)]
        wrapped = world1_steps(make_dit(mesh), "dit", *dit_runs,
                               against=bare)
        out_dit = world1_report("dit", bare, again, wrapped)
        del bare, again, parts, draws
    finally:
        dist.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- (b) two gloo ranks sharing the card, against one process: a G
    # step on the same weights, then a D step with the gate open
    gcfg = cfg.replace(disc_start=1)
    layouts = [
        # dropout off on a data split: each rank draws its item's masks
        # from its own generator, one process both from one
        ("vae_b data 2 x view 1", "vae_case", dict(
            cfg=gcfg.replace(attn_dropout=0.0), mesh_shape=(2,),
            mesh_axes=("data",), items=[0, 1], steps=("g", "d"),
            eval_items=[2, 3, 4], n_verts=N_VERTS, repeat=DDP_REPEATS)),
        ("vae_b data 1 x view 2", "vae_case", dict(
            cfg=gcfg, mesh_shape=(1, 2), mesh_axes=("data", "view"),
            items=[0], steps=("g", "d"), n_verts=N_VERTS,
            repeat=DDP_REPEATS)),
        ("test_tiny DiT data 2", "dit_case", dict(
            cfg=PRESETS["test_tiny"].replace(lr_scheduler="constant",
                                             noised_condition_dropout=0.5),
            items=[0, 1, 2, 3], steps=2, eval_items=[4, 5, 6],
            repeat=DDP_REPEATS)),
    ]
    gloo = {}
    for name, case, kwargs in layouts:
        t0 = time.perf_counter()
        res = launch.run(f"sigman_release_torch.parallel.cases:{case}", 2,
                         kwargs, device="cuda:0", backend="gloo",
                         timeout=DDP_TIMEOUT, threads=4)
        r0, floor = res[0], res[0]["floor"]
        for r in res:
            for k, n in r.get("launches", {}).items():
                launches[k] += n
        print(f"[ddp] {name}: 2 gloo ranks on one card in "
              f"{time.perf_counter() - t0:.1f} s; against one process (the "
              f"most that {DDP_REPEATS} more one-process runs differ by in "
              f"brackets): loss relative "
              f"{fmt(r0['loss_rel'])} ({fmt(floor['loss_rel'])}), gradient "
              f"at each clip relative L2 {fmt(r0['grad_rel'])} "
              f"({fmt(floor['grad_rel'])}), update relative L2 "
              f"{r0['update_rel']:.3e} ({floor['update_rel']:.3e}), new "
              f"weights {r0['weights_rel']:.3e} ({floor['weights_rel']:.3e});"
              f" step ms one process {fmt(r0['ref_step_ms'], '.1f')}, ranks "
              f"{[fmt(r['step_ms'], '.1f') for r in res]}; peak GiB one "
              f"process {r0['ref_peak_gib']}, ranks "
              f"{[r['peak_gib'] for r in res]}; buckets {r0['buckets']}; "
              f"launches {[r.get('launches') for r in res]}", flush=True)
        hold_two_ranks(name, r0, floor, "update_rel", DDP_REPEATS)
        for key, ref_key in (("eval", "ref_eval"),
                             ("eval_loss", "ref_eval_loss")):
            if ref_key not in r0:
                continue
            ref = r0[ref_key]
            got = [r[key] for r in res]
            print(f"[ddp] {name}: {key} on the ranks {got}, one process "
                  f"{ref}", flush=True)
            pairs = ([(g[k], ref[k]) for g in got for k in ref]
                     if isinstance(ref, dict) else [(g, ref) for g in got])
            if not all(abs(a - b) <= DDP_EVAL_TOL * abs(b) for a, b in pairs):
                fail(f"{name}: the {key} of two ranks differs from one "
                     f"process")
        gloo[name] = r0
    if launches["forward_tiles"] < 1 or launches["backward_tiles"] < 1:
        fail(f"the DDP runs launched K1 / K2 {launches} times")
    return {**launches, "vae": out_vae, "dit": out_dit}


# ---- phase 16: FSDP and the 'model' axis of the DiT ------------------------

FSDP_ITEMS = 2                  # items per rank of the two-rank layouts
FSDP_LAYERS = 6                 # DiT blocks of the two-rank layouts
BYTES_TOL = 0.01                # sharded bytes against the analytic model
FSDP_TIMEOUT = 900              # seconds for the two ranks' runs
# the two-rank layouts in f32 (no TF32) against one process, each limit
# 11-17x above the largest reading on the H100 (PERF.md, section 6): loss,
# relative; gradient at each clip, relative L2 over all parameters (and
# each rank's global norm, relative) and of the worst one alone; the
# update (new minus old weights), relative L2
F32_LOSS_TOL = 1e-6
F32_GRAD_TOL = 1e-5
F32_LEAF_TOL = 1e-4
F32_UPDATE_TOL = 1e-4


def fsdp_world1_report(res):
    """Print and check phase 16 (a): the FSDP steps at world size 1 against
    the bare trainer (a second bare run's spread in brackets)."""
    floor = res["floor"]
    b = res["bytes"]
    print(f"[fsdp] dit at world size 1 (NCCL) against the bare trainer (a "
          f"second bare run in brackets): losses {res['losses']} / "
          f"{res['ref_losses']}, relative {fmt(res['loss_rel'])} "
          f"({fmt(floor['loss_rel'])}); gradient at each clip relative L2 "
          f"{fmt(res['grad_rel'])} ({fmt(floor['grad_rel'])}); new weights "
          f"relative L2 {res['weights_rel']:.3e} ({floor['weights_rel']:.3e})"
          f"; two more steps untapped, ms: FSDP "
          f"{fmt(res['step_ms'], '.1f')}, bare "
          f"{fmt(res['ref_step_ms'], '.1f')}; peak GiB FSDP "
          f"{res['peak_gib']}, bare {res['ref_peak_gib']}; sharded "
          f"bytes: params {b['params']}, AdamW moments {b['moments']}, "
          f"steps {b['steps']}, analytic {b['analytic']:.0f}", flush=True)
    (first, *later), loss_floor = res["loss_rel"], floor["loss_rel"][0]
    (clip, *clips), (clip_floor, *clip_floors) = (res["grad_rel"],
                                                   floor["grad_rel"])
    pairs = [(first, loss_floor), (clip, clip_floor),
             (res["weights_rel"], floor["weights_rel"])]
    if (res["n_clips"][0] != res["n_clips"][1]
            or not all(d <= DDP_LOSS_TOL for d in later)
            or not all(d <= max(DDP_GRAD_TOL, 2 * f)
                       for d, f in zip(clips, clip_floors))
            or not all(d <= WORLD1_TOL + 2 * f for d, f in pairs)):
        fail("dit under FSDP at world size 1 differs from the bare trainer "
             "by more than a second bare run does")


def hold_f32_ranks(name, res):
    """Fail unless a two-rank layout in f32 (``res``: the ranks' results of
    ``cases.dit_case``) is within the ``F32_*`` limits of one process:
    each loss, each clip's gradient over all parameters and its worst
    parameter alone, the global norm each rank computes from its pieces,
    and the update; and each rank's parameter and AdamW bytes within
    ``BYTES_TOL`` of the analytic model."""
    r0 = res[0]
    leaf = [v for v, _ in r0["grad_leaf"]]
    norms = [abs(a - b) / b for r in res
             for a, b in zip(r["norms"], r0["ref_norms"], strict=True)]
    checks = ([(d, F32_LOSS_TOL) for d in r0["loss_rel"]]
              + [(d, F32_GRAD_TOL) for d in r0["grad_rel"] + norms]
              + [(d, F32_LEAF_TOL) for d in leaf]
              + [(r0["update_rel"], F32_UPDATE_TOL)])
    if (r0["n_clips"][0] != r0["n_clips"][1]
            or not all(d <= tol for d, tol in checks)):
        fail(f"{name}: two ranks differ from one process in f32 by more "
             f"than the limits: {checks}, worst parameters "
             f"{r0['grad_leaf']}")
    for r in res:
        b = r["bytes"]
        held_bytes = b["params"] + b["moments"]
        if not abs(held_bytes - b["analytic"]) <= BYTES_TOL * b["analytic"]:
            fail(f"{name}: rank {r['rank']} holds {held_bytes} B of "
                 f"parameters and AdamW moments, the analytic model "
                 f"{b['analytic']:.0f}")


def fsdp_phase(dev, clock):
    """Phase 16; returns the K1 launches of its paths and K1's numbers on
    the FSDP sampling eval's stream."""
    import torch
    import torch.distributed as dist

    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.ops.rasterizer import render as render_lib
    from sigman_release_torch.parallel import cases, launch

    clock.start("fsdp")
    cfg = PRESETS[DIT_PRESET].replace(spmd="fsdp")
    # ---- (a) NCCL at world size 1: two FSDP steps at B = 8 against two
    # bare runs, then a sampling eval under FSDP with K1 on its stream
    captured = {}
    real_forward = render_lib.forward_tiles

    def capturing_forward(*a, **kw):       # keeps the eval render's K1 inputs
        captured.update(args=a, kw=kw)
        return real_forward(*a, **kw)

    dist.init_process_group("nccl", init_method=f"tcp://localhost:"
                            f"{free_port()}", world_size=1, rank=0)
    render_lib.forward_tiles = capturing_forward
    try:
        t0 = time.perf_counter()
        res = cases.dit_case(
            cfg, items=list(range(cfg.batch_size)), steps=2, draw_seed=16,
            repeat=1, mesh_shape=(1,), mesh_axes=("data",), n_verts=N_VERTS,
            sample_steps=cfg.num_inference_steps, timed=2, device=dev)
        a_s = time.perf_counter() - t0
    finally:
        render_lib.forward_tiles = real_forward
        dist.destroy_process_group()
    gc.collect()                # FSDP's module state holds cycles
    torch.cuda.empty_cache()
    fsdp_world1_report(res)
    k1_fsdp, knn_fsdp = res["sample_launches"], res["sample_knn_launches"]
    print(f"[fsdp] (a) {a_s:.1f} s; sample_eval under FSDP after the steps "
          f"({cfg.num_inference_steps} CFG steps): sample PSNR "
          f"{res['sample']['sample_psnr']:.4f}, forward_tiles launches "
          f"{k1_fsdp}, mean_knn_dist2 launches {knn_fsdp}", flush=True)
    if k1_fsdp != 1 or not np.isfinite(res["sample"]["sample_psnr"]):
        fail(f"the FSDP sampling eval launched forward_tiles {k1_fsdp} "
             f"times, PSNR {res['sample']['sample_psnr']}")
    a, kw = captured["args"], captured["kw"]
    with torch.no_grad():
        held = hold_k1(*a[:3], kw)
    print(f"[k1 fsdp] forward_tiles on the FSDP sampling eval's stream "
          f"({held['n_pairs']} pairs in {a[1].numel()} tiles) "
          f"{held['ms']:.4f} ms, plain {held['plain_ms']:.1f} ms, max "
          f"|kernel - plain| {held['err']:.3e}; "
          f"{bound_text(held['ms'], held['new'], held['old'])}", flush=True)
    print(f"[k1 fsdp] largest difference (rows rgb, depth, alpha, final T): "
          f"{held['worst']}", flush=True)
    if not held["err"] <= K1_TOL:
        fail(f"forward_tiles disagrees with its plain version on the FSDP "
             f"sampling eval's stream: {held['err']}")
    k1_out = {"launches": k1_fsdp, "knn_launches": knn_fsdp,
              "err": held["err"], "ms": held["ms"],
              "plain_ms": held["plain_ms"], "bound_ms": held["new"][0],
              "bound_ms_without_cull": held["old"][0]}
    del captured, a, held, res
    gc.collect()
    torch.cuda.empty_cache()

    # ---- (b) two ranks sharing the card over gloo, against one process on
    # the whole batch, at full width and FSDP_LAYERS blocks (over gloo each
    # rank's collectives pass through the host: a step of all 30 took 22 s
    # at data 2), in f32 without TF32 and at a constant learning rate, so
    # that the sharding's own rounding is all that differs; then (c) the
    # state file: data 2 at test_tiny, two micro-steps per update, saved
    # after micro-step 1 and resumed by one process here, which takes
    # micro-step 2 beside the ranks. One launch runs all three.
    wide = cfg.replace(num_layers=FSDP_LAYERS, mixed_precision="no",
                       lr_scheduler="constant")
    layouts = [("dit data 2 x model 1", (2,), ("data",)),
               ("dit data 1 x model 2", (1, 2), ("data", "model"))]
    small = PRESETS["test_tiny"].replace(gradient_accumulation_steps=2,
                                         noised_condition_dropout=0.5,
                                         spmd="fsdp")
    path = os.path.join(ROOT, "build", "smoke_fsdp", "dit_state.pt")
    runs = [("dit_case", dict(cfg=wide, mesh_shape=shape, mesh_axes=axes,
                              items=list(range(FSDP_ITEMS * shape[0])),
                              steps=2, draw_seed=16))
            for _, shape, axes in layouts]
    runs.append(("dit_case", dict(cfg=small, mesh_shape=(2,),
                                  mesh_axes=("data",), items=[0, 1, 2, 3],
                                  steps=1, save_path=path, after_save=1)))
    prev_env = os.environ.get("NVIDIA_TF32_OVERRIDE")
    os.environ["NVIDIA_TF32_OVERRIDE"] = "0"      # f32 in the children
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    try:
        t0 = time.perf_counter()
        res = launch.run("sigman_release_torch.parallel.cases:series", 2,
                         {"runs": runs}, device="cuda:0", backend="gloo",
                         timeout=FSDP_TIMEOUT, threads=4)
        b_s = time.perf_counter() - t0
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
        same_layout = fsdp_file_layout(path)
        resumed = fsdp_resumed_step(small, path, res[0][2], dev)
    finally:
        if prev_env is None:
            os.environ.pop("NVIDIA_TF32_OVERRIDE", None)
        else:
            os.environ["NVIDIA_TF32_OVERRIDE"] = prev_env
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
        for f in (path, path + ".one"):
            if os.path.exists(f):
                os.remove(f)
    print(f"[fsdp] (b) and (c): 2 gloo ranks on one card in {b_s:.1f} s",
          flush=True)
    for i, (name, shape, _) in enumerate(layouts):
        ranks = [r[i] for r in res]
        r0 = ranks[0]
        print(f"[fsdp] {name}, {FSDP_LAYERS} of {cfg.num_layers} blocks, f32 "
              f"without TF32, constant lr: against one process on "
              f"{FSDP_ITEMS * shape[0]} items: loss relative "
              f"{fmt(r0['loss_rel'])}, gradient at each clip relative L2 "
              f"{fmt(r0['grad_rel'])}, worst parameter {r0['grad_leaf']}, "
              f"global norms {[r['norms'] for r in ranks]} / "
              f"{r0['ref_norms']}, update relative L2 "
              f"{r0['update_rel']:.3e}, new weights {r0['weights_rel']:.3e}; "
              f"step ms (less the comparisons' gathers and copies): one "
              f"process {fmt(r0['ref_step_ms'], '.1f')}, ranks "
              f"{[fmt(r['step_ms'], '.1f') for r in ranks]}; peak GiB one "
              f"process {r0['ref_peak_gib']}, ranks "
              f"{[r['peak_gib'] for r in ranks]}; sharded bytes "
              f"{[r['bytes'] for r in ranks]}", flush=True)
        hold_f32_ranks(name, ranks)
    print(f"[fsdp] (c) state file of 2 ranks at micro-step 1 of 2: the "
          f"one-process file's layout {same_layout}; resumed by one process "
          f"bit for bit {resumed['exact']}; micro-step 2 (the update) loss "
          f"relative {resumed['loss_rel']:.3e}, new weights relative L2 "
          f"{resumed['weights_rel']:.3e}", flush=True)
    if not (same_layout and resumed["exact"]
            and resumed["loss_rel"] <= RESUME_LOSS_TOL
            and resumed["weights_rel"] <= RESUME_PARAM_TOL):
        fail(f"the sharded state file round trip: {same_layout}, {resumed}")
    return {"k1": k1_out}


def fsdp_file_layout(path) -> bool:
    """Whether the sharded trainer's state file has the one-process file's
    (``path + ".one"``) entries, names, shapes and dtypes."""
    import torch

    a, b = (torch.load(f, map_location="cpu", weights_only=True)
            for f in (path, path + ".one"))

    def shapes(state):
        opt = state["optimizer"]
        return ([(k, v.shape, v.dtype) for k, v in state["model"].items()],
                [(i, k, v.shape, v.dtype) for i, s in opt["state"].items()
                 for k, v in s.items()], opt["param_groups"],
                [None if g is None else g.shape for g in state["grads"]])

    return list(a) == list(b) and shapes(a) == shapes(b)


def fsdp_resumed_step(cfg, path, r0, dev) -> dict:
    """One process resumes the sharded state file: is it bit for bit what
    the ranks saved (weights, AdamW state, gradient sums, counts), and
    does its next micro-step (the same batch and draws) match theirs?"""
    import torch

    from sigman_release_torch.data.dataset import SyntheticAvatarDataset
    from sigman_release_torch.parallel import cases
    from sigman_release_torch.training.dit_trainer import (
        RAW_KEYS, DiTTrainer)

    vae, _, encoder = cases._dit_parts(cfg, dev)
    t = DiTTrainer(cfg, vae, encoder, device=dev)
    t.resume(path)
    model, opt, grads = r0["saved"]
    exact = ((t.step, t.updates, t._micro) == (1, 0, 1) and all(
        torch.equal(p.detach().cpu(), model[n]) and
        torch.equal(p.grad.cpu(), g)
        for (n, p), g in zip(t.model.named_parameters(), grads)) and all(
        torch.equal(v.cpu(), opt["state"][i][k])
        for i, s in t.opt.state_dict()["state"].items()
        for k, v in s.items()))
    data = SyntheticAvatarDataset(cfg, n_items=5, seed=cfg.seed)
    batch = t.to_device({k: np.stack([data[i][k] for i in range(4)])
                         for k in RAW_KEYS})
    draws = {k: torch.from_numpy(np.asarray(v)).to(dev)
             for k, v in cases.dit_draws(cfg, 4, 2).items()}
    loss = float(t.train_step(batch, draws)["loss"])
    want = r0["after_losses"][0]
    return {"exact": exact and t.updates == 1,
            "loss_rel": abs(loss - want) / abs(want),
            "weights_rel": rel_l2(list(t.model.parameters()),
                                  r0["after_weights"])}


# ---- phase 14: real data and the evaluation entry points -------------------

FIXTURE_JPEG = os.path.join(ROOT, "tests", "torch_fixtures",
                            "hgs_view_1024.jpg")
FIXTURE_DECODE = os.path.join(ROOT, "tests", "torch_fixtures",
                              "hgs_view_1024_decode.npz")
# nvJPEG against libjpeg's decode of the fixture: libjpeg's chroma
# upsampling and colour conversion run on the host on both paths
# (csrc/loader.cpp), so only the inverse DCT differs: one level in Y and in
# Cb or Cr gives up to 1 + ceil(1.772) = 3 levels after the conversion;
# and on average far less than one
NVJPEG_MAX_LEVELS = 3
NVJPEG_MEAN_LEVELS = 0.05
HGS_ITEMS = 3
HGS_VIEWS = 90
RENDER_FREE_VIEWS = 4


def write_hgs_items(root, n_items, rng):
    """``n_items`` item directories of the reference's HGS-1M layout under
    ``root`` and their ``train_list.npy``: the 1024^2 JPEG fixture as every
    ``rgb_map/VVVV.jpg``, one PNG mask (the fixture's figure) as every
    ``mask_map/VVVV.png`` and one PNG as ``UV/smplxuv_albedo.png`` (each
    encoded once, then copied), an orbit rig's w2c ``R`` / ``T`` for all
    views in ``camera_full_calibration.json`` and a seeded ``smplx.npz``."""
    import shutil

    from sigman_release_torch.data.dataset import SMPLX_KEYS
    from sigman_release_torch.geometry.cameras import orbit_camera
    from sigman_release_torch.utils.image_io import write_png

    os.makedirs(root, exist_ok=True)
    rgb = np.load(FIXTURE_DECODE)["rgb"]
    mask_png, uv_png = (os.path.join(root, n) for n in ("mask.png", "uv.png"))
    fig = (np.abs(rgb.astype(np.int16) - rgb[0, 0]).sum(-1) > 40)
    write_png(mask_png, np.repeat((fig * 255).astype(np.uint8)[..., None], 3,
                                  axis=-1))
    write_png(uv_png, rgb[::-1].copy())
    cams = {}
    for v in range(HGS_VIEWS):
        w2c = np.linalg.inv(orbit_camera(10.0, 360.0 * v / HGS_VIEWS, 1.5))
        cams[f"{v:04d}"] = {"R": w2c[:3, :3].tolist(),
                            "T": w2c[:3, 3].tolist()}
    dims = (3, 3, 10, 63, 10, 45, 45, 3, 3, 3)
    dirs = []
    for i in range(n_items):
        d = os.path.join(root, f"item{i}")
        for sub in ("rgb_map", "mask_map", "UV"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        for v in range(HGS_VIEWS):
            shutil.copyfile(FIXTURE_JPEG,
                            os.path.join(d, "rgb_map", f"{v:04d}.jpg"))
            shutil.copyfile(mask_png,
                            os.path.join(d, "mask_map", f"{v:04d}.png"))
        shutil.copyfile(uv_png, os.path.join(d, "UV", "smplxuv_albedo.png"))
        with open(os.path.join(d, "camera_full_calibration.json"), "w") as f:
            json.dump(cams, f)
        np.savez(os.path.join(d, "smplx.npz"), **{
            k: rng.normal(0, 0.1, n).astype(np.float32)
            for k, n in zip(SMPLX_KEYS, dims)})
        dirs.append(d)
    lst = os.path.join(root, "train_list.npy")
    np.save(lst, np.array(dirs))
    return dirs, lst, mask_png


def orbit_rig_tensors(cfg, n_views, dev):
    """``inference.orbit_rig`` as [1,V,4,4] tensors on ``dev``."""
    import torch

    from sigman_release_torch.inference import orbit_rig

    return tuple(torch.from_numpy(a).to(dev)[None]
                 for a in orbit_rig(cfg, n_views))


class Counted:
    """Zero the K1 / K2 / KNN launch counts on entry; ``n1`` / ``n2`` /
    ``nk`` are the launches made inside."""

    def __enter__(self):
        from sigman_release_torch.ops import knn
        from sigman_release_torch.ops.rasterizer import backward_tiles as k2
        from sigman_release_torch.ops.rasterizer import forward_tiles as k1

        self.k1, self.k2, self.knn = k1, k2, knn
        k1.forward_tiles.launches = 0
        k2.backward_tiles.launches = 0
        knn.mean_knn_dist2.launches = 0
        return self

    def __exit__(self, *exc):
        self.n1 = self.k1.forward_tiles.launches
        self.n2 = self.k2.backward_tiles.launches
        self.nk = self.knn.mean_knn_dist2.launches


def data_phase(dev, body, template, clock, g_step_ms):
    """Phase 14; returns the numbers the kernels line needs."""
    import shutil

    import torch

    from sigman_release_torch import inference, test_vae, train_dit, train_vae
    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.data import native_loader
    from sigman_release_torch.data.dataset import HGSDataset
    from sigman_release_torch.data.loader import DataLoader
    from sigman_release_torch.ops.rasterizer import render as render_lib
    from sigman_release_torch.ops.rasterizer.render import finish
    from sigman_release_torch.renderer import GaussianRenderer
    from sigman_release_torch.training.vae_trainer import VAETrainer
    from sigman_release_torch.utils import cuda_build
    from sigman_release_torch.utils.ply import load_ply

    clock.start("data")
    root = os.path.join(ROOT, "build", "smoke_hgs")
    shutil.rmtree(root, ignore_errors=True)
    rng = np.random.default_rng(14)

    # ---- the decoder: built here, held against the fixture's CPU decode
    t0 = time.perf_counter()
    try:
        backend = native_loader.jpeg_backend()
    finally:
        log = cuda_build.build_logs.get(str(native_loader.SOURCE))
        if log and log.strip():
            print(f"[data] g++ on {os.path.relpath(native_loader.SOURCE, ROOT)}"
                  f":\n{log.strip()}")
    build_s = time.perf_counter() - t0
    ref = np.load(FIXTURE_DECODE)["rgb"].astype(np.float32)
    got = native_loader.decode_image(FIXTURE_JPEG, 1024, 1024, 3) * 255.0
    diff = np.abs(got - ref)
    d_max, d_mean = float(diff.max()), float(diff.mean())
    print(f"[data] decoder ({backend} JPEG, zlib PNG) built in {build_s:.1f} "
          f"s; the 1024^2 JPEG fixture against its committed libjpeg decode: "
          f"max {d_max:.4f}, mean {d_mean:.5f} levels of 255", flush=True)
    if backend == "libjpeg" and d_max > 1e-3:
        fail(f"libjpeg decode of the fixture differs by {d_max} levels")
    if backend == "nvjpeg" and not (d_max <= NVJPEG_MAX_LEVELS + 1e-3
                                    and d_mean <= NVJPEG_MEAN_LEVELS):
        fail(f"nvJPEG decode of the fixture differs by max {d_max}, mean "
             f"{d_mean} levels from libjpeg's")

    # ---- item directories of the reference's layout
    t0 = time.perf_counter()
    dirs, lst, mask_png = write_hgs_items(root, HGS_ITEMS, rng)
    write_s = time.perf_counter() - t0
    cfg = PRESETS[TRAIN_PRESET]
    S = max(cfg.input_size, cfg.output_size)
    decode_ms = {}
    for n_threads in (1, 4):
        for kind, path, ch in (("jpeg", FIXTURE_JPEG, 3),
                               ("png", mask_png, 1)):
            t0 = time.perf_counter()
            native_loader.decode_batch([path] * 16, S, S, ch,
                                       n_threads=n_threads)
            decode_ms[(kind, n_threads)] = (time.perf_counter() - t0) * 1e3 / 16
    zeros = 0
    for d in dirs:
        views = native_loader.decode_batch(
            [os.path.join(d, "rgb_map", f"{v:04d}.jpg")
             for v in range(HGS_VIEWS)]
            + [os.path.join(d, "mask_map", f"{v:04d}.png")
               for v in range(HGS_VIEWS)], 64, 64, 3, n_threads=4)
        zeros += int((views.reshape(len(views), -1).max(axis=1) == 0).sum())
    t0 = time.perf_counter()
    item = HGSDataset(cfg, items=dirs, training=True)[0]
    item_ms = (time.perf_counter() - t0) * 1e3
    loader = DataLoader(HGSDataset(cfg, items=dirs * 3, training=True), 1,
                        shuffle=False, num_workers=4)
    t0 = time.perf_counter()
    n_loaded = sum(1 for _ in loader)
    items_per_s = n_loaded / (time.perf_counter() - t0)
    print(f"[data] {HGS_ITEMS} items of {HGS_VIEWS} views at 1024^2 written in "
          f"{write_s:.1f} s; views decoded to zeros: {zeros}; decode at "
          f"{S}^2, ms per file: JPEG view {decode_ms[('jpeg', 1)]:.2f} (1 "
          f"thread) / {decode_ms[('jpeg', 4)]:.2f} (4), PNG mask "
          f"{decode_ms[('png', 1)]:.2f} / {decode_ms[('png', 4)]:.2f}; one "
          f"{TRAIN_PRESET} item ({cfg.num_views} views decoded and packed) "
          f"{item_ms:.1f} ms; the loader at num_workers 4: {items_per_s:.2f} "
          f"items/s", flush=True)
    if zeros:
        fail(f"{zeros} views of the items decoded to zeros")
    if not all(np.isfinite(v).all() for v in item.values()
               if isinstance(v, np.ndarray)) or item["images_output"].max() <= 0:
        fail("the decoded item is not finite or is empty")
    del item, loader

    # ---- train_vae on the items, with the eval over the held-out item
    ws = os.path.join(root, "ws")

    class TimedTrainer(VAETrainer):
        """G and eval steps timed on the host, synchronised."""
        times = {"g": [], "eval": []}

        def _timed(self, kind, fn, *a, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.times[kind].append((time.perf_counter() - t) * 1e3)
            return out

        def train_step_g(self, *a, **kw):
            return self._timed("g", super().train_step_g, *a, **kw)

        def eval_step(self, *a, **kw):
            return self._timed("eval", super().eval_step, *a, **kw)

    class TimedLoader(DataLoader):
        """Records the host's wait for each batch of a training loader."""
        waits = []

        def __iter__(self):
            it = super().__iter__()
            while True:
                t = time.perf_counter()
                try:
                    b = next(it)
                except StopIteration:
                    return
                if self.shuffle:
                    self.waits.append((time.perf_counter() - t) * 1e3)
                yield b

    saved = (train_vae.VAETrainer, train_vae.DataLoader, test_vae.VAETrainer)
    train_vae.VAETrainer = test_vae.VAETrainer = TimedTrainer
    train_vae.DataLoader = TimedLoader
    try:
        t0 = time.perf_counter()
        with Counted() as c_train:
            trainer = train_vae.main(
                [TRAIN_PRESET, "--device", DEVICE, "--train_list", lst,
                 "--synthetic_data", "false", "--workspace", ws,
                 "--num_epochs", "1", "--eval_steps", "2", "--log_every", "1",
                 "--num_workers", "4"], body_model=body, template=template)
        train_s = time.perf_counter() - t0
        steps = trainer.step
        del trainer
        torch.cuda.empty_cache()
        with open(os.path.join(ws, "vae_metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r["loss"] for r in rows if "loss" in r]
        ev = [r for r in rows if "eval_psnr" in r]
        g_ms, waits = list(TimedTrainer.times["g"]), list(TimedLoader.waits)
        wait_share = sum(waits) / (sum(waits) + sum(g_ms))
        print(f"[data] train_vae {TRAIN_PRESET} on {HGS_ITEMS - 1} items, one "
              f"epoch, {train_s:.1f} s (set-up, eval and the state file "
              f"included): G steps {', '.join(f'{t:.1f}' for t in g_ms)} ms "
              f"(phase 7's synthetic G step, median of steps 2-{G_STEPS}: "
              f"{g_step_ms:.1f} ms); the host waited "
              f"{', '.join(f'{t:.1f}' for t in waits)} ms for the training "
              f"batches (the device-to-host prefetch asks for 2 at the "
              f"start), {100 * wait_share:.2f}% of waits + G steps; the "
              f"loader's {items_per_s:.2f} items/s against "
              f"{1e3 / g_step_ms:.2f} G steps/s; losses {losses}; eval "
              f"{ev[-1] if ev else None}; K1 launches {c_train.n1}, K2 "
              f"launches {c_train.n2}", flush=True)
        if (steps != HGS_ITEMS - 1 or len(losses) != steps
                or not np.isfinite(losses).all() or not ev
                or not all(np.isfinite(v) for v in ev[-1].values())):
            fail(f"train_vae on the items: {steps} steps, losses {losses}, "
                 f"eval {ev}")
        if c_train.n2 != steps or c_train.n1 != steps + 1:
            fail(f"train_vae on the items launched K1 {c_train.n1}, K2 "
                 f"{c_train.n2} times for {steps} G steps and one eval batch")

        # ---- train_dit at test_tiny on the same files, one step
        with Counted() as c_dit:
            dit = train_dit.main(
                ["test_tiny", "--device", DEVICE, "--train_list", lst,
                 "--synthetic_data", "false", "--workspace",
                 os.path.join(root, "ws_dit"), "--batch_size", "2",
                 "--num_epochs", "1", "--eval_steps", "1", "--log_every", "1",
                 "--num_workers", "2", "--num_inference_steps", "2"])
        dit_steps = dit.step
        del dit
        with open(os.path.join(root, "ws_dit", "dit_metrics.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        dit_loss = [r["loss"] for r in rows if "loss" in r]
        print(f"[data] train_dit test_tiny on the items: {dit_steps} step, "
              f"losses {dit_loss}, eval "
              f"{[r for r in rows if 'eval_loss' in r]}; K1 launches "
              f"{c_dit.n1}", flush=True)
        if dit_steps != 1 or not np.isfinite(dit_loss).all() or c_dit.n1 != 1:
            fail(f"train_dit on the items: {dit_steps} steps, losses "
                 f"{dit_loss}, K1 launches {c_dit.n1}")

        # ---- test_vae over the held-out item, resuming train_vae's state
        TimedTrainer.times["eval"].clear()
        t0 = time.perf_counter()
        with Counted() as c_test:
            res = test_vae.main(
                [TRAIN_PRESET, "--device", DEVICE, "--train_list", lst,
                 "--synthetic_data", "false", "--workspace", ws, "--resume",
                 os.path.join(ws, "vae_state.pt"), "--num_workers", "1"],
                body_model=body, template=template)
        test_s = time.perf_counter() - t0
        eval_ms = list(TimedTrainer.times["eval"])
    finally:
        (train_vae.VAETrainer, train_vae.DataLoader,
         test_vae.VAETrainer) = saved
    print(f"[data] test_vae {TRAIN_PRESET} over the held-out item, resumed "
          f"from train_vae's state: {res}; wall {test_s:.1f} s (set-up and "
          f"resume included), eval_step {', '.join(f'{t:.1f}' for t in eval_ms)}"
          f" ms; K1 launches {c_test.n1}", flush=True)
    if (res["batches"] != 1 or c_test.n1 != 1
            or not all(np.isfinite(v) for v in res.values())):
        fail(f"test_vae over the held-out item: {res}, K1 {c_test.n1}")
    os.remove(os.path.join(ws, "vae_state.pt"))
    torch.cuda.empty_cache()

    # ---- inference at the dit preset: avatar.ply, then --eval
    out_dir = os.path.join(root, "inference")
    t0 = time.perf_counter()
    with Counted() as c_inf:
        single = inference.main(
            ["--preset", PRESET, "--device", DEVICE, "--out_dir", out_dir,
             "--num_views", str(RENDER_FREE_VIEWS), "--steps", "30"],
            body_model=body, template=template)
    inf_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    g14 = load_ply(single["ply"])
    read_ms = (time.perf_counter() - t0) * 1e3
    print(f"[data] inference {PRESET} (30 CFG steps, set-up included) "
          f"{inf_s:.1f} s: avatar.ply {single['ply_bytes']} bytes, "
          f"{len(g14)} Gaussians, write {single['ply_write_ms']:.1f} ms, read "
          f"{read_ms:.1f} ms; K1 launches {c_inf.n1}", flush=True)
    if c_inf.n1 != 1 or not np.isfinite(g14).all() or len(g14) < 1:
        fail(f"inference: K1 {c_inf.n1}, {len(g14)} Gaussians in the PLY")
    t0 = time.perf_counter()
    with Counted() as c_ev:
        ev = inference.main(
            ["--preset", PRESET, "--device", DEVICE, "--out_dir", out_dir,
             "--eval", "--eval_batches", "1", "--train_list", lst,
             "--synthetic_data", "false", "--steps", "30"],
            body_model=body, template=template)
    ev_s = time.perf_counter() - t0
    torch.cuda.empty_cache()
    print(f"[data] inference --eval {PRESET} over the held-out item "
          f"({ev_s:.1f} s with set-up): {ev['mean']}, ms per batch "
          f"{[round(t, 1) for t in ev['ms']]}; K1 launches {c_ev.n1}",
          flush=True)
    if (len(ev["batches"]) != 1 or c_ev.n1 != 1
            or not all(np.isfinite(v) for v in ev["mean"].values())):
        fail(f"inference --eval: {ev}, K1 {c_ev.n1}")

    # ---- render_free of the PLY: K1 forward, K2 backward
    rcfg = PRESETS[PRESET]
    renderer = GaussianRenderer(rcfg)
    cv, cvp = orbit_rig_tensors(rcfg, RENDER_FREE_VIEWS, dev)
    cols = {"position": (0, 3), "opacity": (3, 4), "scale": (4, 7),
            "rotation": (7, 11), "rgb": (11, 14)}
    g = {k: torch.from_numpy(np.ascontiguousarray(g14[:, a:b])).to(dev)[None]
         .requires_grad_() for k, (a, b) in cols.items()}
    g["opacity"] = g["opacity"].detach()[..., 0].requires_grad_()
    captured = {}
    real_fwd, real_bwd = render_lib.forward_tiles, render_lib.backward_tiles

    def capture(name, fn):
        def wrapped(*a, **kw):
            captured[name] = (a, kw)
            return fn(*a, **kw)
        return wrapped

    render_lib.forward_tiles = capture("k1", real_fwd)
    render_lib.backward_tiles = capture("k2", real_bwd)
    hw = rcfg.output_size
    up = torch.from_numpy(rng.normal(size=(1, RENDER_FREE_VIEWS, 4, hw, hw))
                          .astype(np.float32)).to(dev)
    try:
        with Counted() as c_free:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = renderer.render_free(g, cv, cvp)
            loss = ((out["image"] * up[:, :, :3]).sum()
                    + (out["alpha"] * up[:, :, 3:]).sum())
            loss.backward()
            torch.cuda.synchronize()
            free_ms = (time.perf_counter() - t0) * 1e3
    finally:
        render_lib.forward_tiles, render_lib.backward_tiles = real_fwd, real_bwd
    grads_ok = all(torch.isfinite(t.grad).all() for t in g.values())
    a, kw = captured["k1"]
    with torch.no_grad():
        held = hold_k1(*a[:3], kw)
        img_plain = finish(held["plain"], out["overflow"][0],
                           RENDER_FREE_VIEWS, torch.ones(3, device=dev),
                           renderer.raster_cfg)["image"]
        img_err = (img_plain - out["image"][0]).abs().max().item()
        del held["plain"]
        held2 = hold_k2(*captured["k2"])
        del held2["out"]
    print(f"[data] render_free of avatar.ply: {len(g14)} Gaussians at {hw}^2 "
          f"over {RENDER_FREE_VIEWS} orbit views, forward + backward "
          f"{free_ms:.1f} ms, alpha max {out['alpha'].max().item():.4f}, "
          f"overflow {out['overflow'].tolist()}; K1 launches {c_free.n1}, K2 "
          f"launches {c_free.n2}; gradients finite {grads_ok}", flush=True)
    print(f"[k1 free] forward_tiles on render_free's stream ({held['n_pairs']} "
          f"pairs in {a[1].numel()} tiles) {held['ms']:.4f} ms, plain "
          f"{held['plain_ms']:.1f} ms, max |kernel - plain| {held['err']:.3e}, "
          f"image through the plain version {img_err:.3e}; "
          f"{bound_text(held['ms'], held['new'], held['old'])}", flush=True)
    print(f"[k1 free] stream: {stream_text(a[2], held['work'])}")
    print(f"[k2 free] backward_tiles on render_free's backward "
          f"({held2['n_written']} rows with a gradient) {held2['ms']:.4f} ms "
          f"with the zero fill, plain {held2['plain_ms']:.1f} ms, max |kernel "
          f"- plain| {held2['err']:.3e}, per-column relative "
          f"{held2['rel']:.3e}; {bound_text(held2['ms'], held2['new'], held2['old'])}",
          flush=True)
    if c_free.n1 != 1 or c_free.n2 != 1 or not grads_ok:
        fail(f"render_free launched K1 {c_free.n1}, K2 {c_free.n2} times; "
             f"gradients finite {grads_ok}")
    if not out["alpha"].max().item() > 0.5:
        fail("render_free of the avatar shows nothing")
    if not held["err"] <= K1_TOL or not img_err <= IMAGE_TOL:
        fail(f"forward_tiles disagrees with its plain version on "
             f"render_free's stream: {held['err']}, image {img_err}")
    if not held2["rel"] <= K2_TOL:
        fail(f"backward_tiles disagrees with its plain version on "
             f"render_free's backward: {held2['rel']}")
    del g, out, loss, captured, a
    shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    return {"decoder": backend, "k1_train": c_train.n1, "k2_train": c_train.n2,
            "k1_dit": c_dit.n1, "k1_test_vae": c_test.n1,
            "k1_inference": c_inf.n1, "k1_inference_eval": c_ev.n1,
            "k1_free": c_free.n1, "k2_free": c_free.n2,
            "knn": {"data_train_vae": c_train.nk, "data_train_dit": c_dit.nk,
                    "data_test_vae": c_test.nk, "data_inference": c_inf.nk,
                    "data_inference_eval": c_ev.nk,
                    "data_render_free": c_free.nk},
            "k1": {k: held[k] for k in ("err", "ms", "plain_ms")}
            | {"bound_ms": held["new"][0],
               "bound_ms_without_cull": held["old"][0]},
            "k2": {k: held2[k] for k in ("err", "rel", "ms", "plain_ms")}
            | {"bound_ms": held2["new"][0],
               "bound_ms_without_cull": held2["old"][0]}}


# the procedural body of phase 15: 40,000 faces, 9 segmentation regions of
# 2,222 vertices, half the faces split once -> 99,940 Gaussians
TEMPLATE_VERTS = 40_002
TEMPLATE_REGION = 2_222
TEMPLATE_GAUSSIANS = (90_000, 110_000)
BAKE_ITEMS = 1
RASTER_CHECK_FACES = 2_000      # the card's rasterizer against the CPU's
SNARF_RECOVER_DIST = 1e-3       # a valid init "recovers" its anchor within
REMAT_LOSS_TOL = 1e-5           # first loss under each policy, relative
REMAT_REPEATS = 2               # second "block" runs: the gradient floor
REMAT_STEPS = 3                 # one tapped step, then two timed
SAPIENS_WIDTH, SAPIENS_DEPTH, SAPIENS_GRID = 1536, 40, 64


def sapiens_source(gen, dev):
    """An mmpretrain-named VisionTransformer state dict (under ``backbone.``,
    with a class token) at ``SAPIENS_*`` geometry, seeded on ``dev``, on the
    host."""
    import torch

    D = SAPIENS_WIDTH
    shapes = {"backbone.patch_embed.projection.weight": (D, 3, 16, 16),
              "backbone.patch_embed.projection.bias": (D,),
              "backbone.pos_embed": (1, SAPIENS_GRID ** 2 + 1, D),
              "backbone.cls_token": (1, 1, D),
              "backbone.ln1.weight": (D,), "backbone.ln1.bias": (D,)}
    for i in range(SAPIENS_DEPTH):
        p = f"backbone.layers.{i}."
        for name, shape in (("ln1", (D,)), ("ln2", (D,)),
                            ("attn.qkv", (3 * D, D)), ("attn.proj", (D, D)),
                            ("ffn.layers.0.0", (4 * D, D)),
                            ("ffn.layers.1", (D, 4 * D))):
            shapes[p + name + ".weight"] = shape
            shapes[p + name + ".bias"] = (shape[0],)
    return {k: torch.randn(s, generator=gen, device=dev).cpu()
            for k, s in shapes.items()}


def sapiens_expected(src, name):
    """The source tensor (or slice) that the encoder's ``name`` must hold."""
    D = SAPIENS_WIDTH
    b = "backbone."
    if name == "pos_embed":
        return src[b + "pos_embed"][:, 1:]
    if name.startswith("patch_proj."):
        return src[b + "patch_embed.projection." + name.split(".")[-1]]
    if name.startswith("norm_out."):
        return src[b + "ln1." + name.split(".")[-1]]
    _, i, *mid, leaf = name.split(".")
    layer = f"{b}layers.{i}."
    part = ".".join(mid)
    if part in ("attn.query", "attn.key", "attn.value"):
        k = ("attn.query", "attn.key", "attn.value").index(part)
        return src[layer + "attn.qkv." + leaf][k * D:(k + 1) * D]
    return src[layer + {"ln1": "ln1", "ln2": "ln2", "attn.out": "attn.proj",
                        "ffn1": "ffn.layers.0.0",
                        "ffn2": "ffn.layers.1"}[part] + "." + leaf]


def template_phase(dev, clock):
    """Phase 15; returns the numbers the kernels line needs."""
    import shutil

    import torch

    from sigman_release_torch import (bake_uv, convert, convert_reference_ckpt,
                                      convert_sapiens, extract_template)
    from sigman_release_torch.body.lbs import skinning
    from sigman_release_torch.body.smplx import (canonical_params,
                                                 parse_param_vector,
                                                 save_smplx_npz,
                                                 smplx_forward,
                                                 synthetic_body_model)
    from sigman_release_torch.body.snarf import inverse_skin_points
    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.data.dataset import (HGSDataset,
                                                   SyntheticAvatarDataset)
    from sigman_release_torch.data.uv_baking import rasterize_mesh
    from sigman_release_torch.geometry.cameras import orbit_camera
    from sigman_release_torch.models.encoders import sapiens_1b_encoder
    from sigman_release_torch.models.vae import VAEModel, set_remat_policy
    from sigman_release_torch.ops.rasterizer import render as render_lib
    from sigman_release_torch.training import checkpoint, vae_trainer

    clock.start("template")
    root = os.path.join(ROOT, "build", "smoke_template")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    rng = np.random.default_rng(15)

    # ---- extract a template from a procedural SMPL-X npz and segmentation
    body = synthetic_body_model(n_verts=TEMPLATE_VERTS, seed=15, device=dev)
    npz, seg_path = (os.path.join(root, n) for n in ("smplx.npz", "seg.json"))
    save_smplx_npz(body, npz)
    slot = TEMPLATE_VERTS // len(extract_template.SUBDIVIDE_REGIONS)
    seg = {name: list(range(s, s + TEMPLATE_REGION)) for name, s in zip(
        extract_template.SUBDIVIDE_REGIONS,
        (i * slot + int(rng.integers(0, slot - TEMPLATE_REGION))
         for i in range(len(extract_template.SUBDIVIDE_REGIONS))))}
    with open(seg_path, "w") as f:
        json.dump(seg, f)
    tdir = os.path.join(root, "template")
    t0 = time.perf_counter()
    extracted = extract_template.main(["--smplx", npz, "--seg", seg_path,
                                       "--out", tdir, "--device", DEVICE])
    torch.cuda.synchronize()
    extract_s = time.perf_counter() - t0
    n_faces = len(body.faces)
    n_split = int(extracted.face_mask.sum()) // 4
    n_g = extracted.num_gaussians
    print(f"[template] extract_template on a {TEMPLATE_VERTS}-vertex "
          f"procedural SMPL-X npz ({n_faces} faces) and 9 regions of "
          f"{TEMPLATE_REGION} vertices: {n_g} Gaussians, {n_split} faces "
          f"({100 * n_split / n_faces:.2f}%) subdivided, {extract_s:.2f} s",
          flush=True)
    if not TEMPLATE_GAUSSIANS[0] <= n_g <= TEMPLATE_GAUSSIANS[1]:
        fail(f"the extracted template has {n_g} Gaussians, not "
             f"{TEMPLATE_GAUSSIANS}")

    # ---- one vae_b G step on it: K1 and K2 on its stream
    cfg = PRESETS[TRAIN_PRESET].replace(template_dir=tdir)
    t0 = time.perf_counter()
    trainer = vae_trainer.VAETrainer(cfg, body_model=body, device=dev)
    item = SyntheticAvatarDataset(cfg, n_items=1, seed=0)[0]
    batch = trainer.to_device({k: v[None] for k, v in item.items()
                               if k != "item"})
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    lr = trainer.latent_renderer
    if lr.template.num_gaussians != n_g:
        fail(f"the trainer renders {lr.template.num_gaussians} Gaussians, "
             f"not the {n_g} of {tdir}")
    captured = {}
    real_fwd, real_bwd = render_lib.forward_tiles, render_lib.backward_tiles

    def capture(name, fn):
        def wrapped(*a, **kw):
            captured[name] = (a, kw)
            return fn(*a, **kw)
        return wrapped

    render_lib.forward_tiles = capture("k1", real_fwd)
    render_lib.backward_tiles = capture("k2", real_bwd)
    q, c = cfg.uv_query_size, cfg.latent_channels
    noise = torch.from_numpy(rng.normal(size=(1, q, q, c)).astype(
        np.float32)).to(dev)
    snap = [p.detach().clone() for p in trainer.params_g]
    gen_state, step0 = trainer.generator.get_state(), trainer.step
    try:
        with Counted() as c_step:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logs = trainer.train_step_g(batch, noise)
            torch.cuda.synchronize()
            g_ms = (time.perf_counter() - t0) * 1e3
    finally:
        render_lib.forward_tiles, render_lib.backward_tiles = real_fwd, real_bwd
    logs = {k: float(v) for k, v in logs.items()}
    print(f"[template] vae_b trainer on {tdir} (set-up {setup_s:.1f} s): "
          f"first G step {g_ms:.1f} ms, K1 launches {c_step.n1}, K2 "
          f"launches {c_step.n2}, logs {logs}", flush=True)
    if c_step.n1 != 1 or c_step.n2 != 1:
        fail(f"the G step on the extracted template launched K1 "
             f"{c_step.n1}, K2 {c_step.n2} times, not once each")
    if not all(np.isfinite(v) for v in logs.values()):
        fail(f"non-finite G step on the extracted template: {logs}")
    a, kw = captured["k1"]
    with torch.no_grad():
        held = hold_k1(*a[:3], kw)
        del held["plain"]
        held2 = hold_k2(*captured["k2"])
        del held2["out"]
    print(f"[k1 template] stream: {stream_text(a[2], held['work'])}")
    print(f"[k1 template] forward_tiles ({held['n_pairs']} pairs in "
          f"{a[1].numel()} tiles) {held['ms']:.4f} ms, plain "
          f"{held['plain_ms']:.1f} ms, max |kernel - plain| "
          f"{held['err']:.3e}; {bound_text(held['ms'], held['new'], held['old'])}",
          flush=True)
    print(f"[k2 template] backward_tiles ({held2['n_written']} rows with a "
          f"gradient) {held2['ms']:.4f} ms with the zero fill, plain "
          f"{held2['plain_ms']:.1f} ms, max |kernel - plain| "
          f"{held2['err']:.3e}, per-column relative {held2['rel']:.3e}; "
          f"{bound_text(held2['ms'], held2['new'], held2['old'])}", flush=True)
    if not held["err"] <= K1_TOL:
        fail(f"forward_tiles disagrees with its plain version on the "
             f"extracted template's stream: {held['err']}")
    if not held2["rel"] <= K2_TOL:
        fail(f"backward_tiles disagrees with its plain version on the "
             f"extracted template's stream: {held2['rel']}")
    del captured, a

    # ---- SNARF: inverse skinning of the posed anchors
    st, deformer = lr.deformer_state, lr.deformer
    with torch.no_grad():
        posed = deformer.prepare(parse_param_vector(
            torch.from_numpy(seeded_pose(rng)).to(dev)))
        tfs = posed.tfs_A[0] @ st.tfs_inv_t[0]        # canonical -> posed
        xc = lr.template.init_pcd
        w = deformer.query_weights(st, xc[None])
        xd = skinning(xc[None], w, tfs[None])[0][0]
        d, h, wd = st.lbs_voxel.shape[1:]
        gz, gy, gx = torch.meshgrid(
            *(torch.linspace(-1, 1, n, device=dev) for n in (d, h, wd)),
            indexing="ij")
        grid = (torch.stack([gx, gy, gz / st.ratio], dim=-1).reshape(-1, 3)
                * st.scale + st.offset.reshape(3))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x_c, valid = inverse_skin_points(xd, st.lbs_voxel, tfs, grid,
                                         st.offset, st.scale, st.ratio)
        torch.cuda.synchronize()
        snarf_ms = (time.perf_counter() - t0) * 1e3
        near = (x_c - xc[:, None]).norm(dim=-1) < SNARF_RECOVER_DIST
        recovered = float((near & valid).any(dim=1).float().mean())
        any_valid = float(valid.any(dim=1).float().mean())
        finite = bool(torch.isfinite(x_c[valid]).all())
    print(f"[snarf] inverse_skin_points of {xd.shape[0]} posed anchors x "
          f"{valid.shape[1]} inits x 10 iterations on the deformer's "
          f"{tuple(st.lbs_voxel.shape)} weight voxel: {snarf_ms:.1f} ms; "
          f"a valid init for {100 * any_valid:.2f}% of the points, the "
          f"anchor recovered within {SNARF_RECOVER_DIST} for "
          f"{100 * recovered:.2f}%", flush=True)
    if not finite or recovered <= 0:
        fail(f"SNARF: finite {finite}, recovered share {recovered}")
    del x_c, valid, near, grid

    # ---- remat policies on the same trainer, weights and noise
    runs = {"block again": []}
    with Counted() as c_remat:
        for name in ["block", *["block again"] * REMAT_REPEATS, "conv_enc",
                     "conv"]:
            policy = name.split()[0]
            set_remat_policy(trainer.vae, policy)
            with torch.no_grad():
                for p, s in zip(trainer.params_g, snap):
                    p.copy_(s)
            trainer.generator.set_state(gen_state)
            trainer.step = step0
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            against = runs["block"]["clips"] if "block" in runs else None
            with ClipTap(vae_trainer, against) as tap:
                loss = float(trainer.train_step_g(batch, noise)["loss"])
            ms = []
            for _ in range(REMAT_STEPS - 1):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                trainer.train_step_g(batch, noise)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
            run = {"loss": loss, "ms": statistics.median(ms),
                   "peak": torch.cuda.max_memory_allocated() / 2**30}
            if against is None:
                run["clips"] = tap.host
            else:
                run["grad_rel"] = tap.rel[0]
            if name == "block again":
                runs[name].append(run)
            else:
                runs[name] = run
    set_remat_policy(trainer.vae, cfg.remat_policy)
    block = runs["block"]
    spread = max(r["grad_rel"] for r in runs["block again"])
    for name in ("block", "conv_enc", "conv"):
        r = runs[name]
        print(f"[remat] {name}: G step median of {REMAT_STEPS - 1} "
              f"{r['ms']:.1f} ms, peak {r['peak']:.2f} GiB, first loss "
              f"{r['loss']!r}" + ("" if name == "block" else
                                  f", gradient against block relative L2 "
                                  f"{r['grad_rel']:.3e}"), flush=True)
    print(f"[remat] second block runs: gradient relative L2 "
          f"{fmt([r['grad_rel'] for r in runs['block again']])}, ms "
          f"{fmt([r['ms'] for r in runs['block again']], '.1f')}; K1 / K2 "
          f"launches {c_remat.n1} / {c_remat.n2}", flush=True)
    n_steps = (3 + REMAT_REPEATS) * REMAT_STEPS
    if c_remat.n1 != n_steps or c_remat.n2 != n_steps:
        fail(f"the remat steps launched K1 {c_remat.n1}, K2 {c_remat.n2} "
             f"times, not {n_steps}")
    for name in ("conv_enc", "conv", "block again"):
        for r in (runs[name] if name == "block again" else [runs[name]]):
            rel = abs(r["loss"] - block["loss"]) / max(abs(block["loss"]),
                                                       1e-30)
            if not rel <= REMAT_LOSS_TOL:
                fail(f"remat {name}: first loss {r['loss']} against block's "
                     f"{block['loss']} (relative {rel})")
    for name in ("conv_enc", "conv"):
        if not runs[name]["grad_rel"] <= 2 * spread:
            fail(f"remat {name}: gradient {runs[name]['grad_rel']} against "
                 f"block, more than twice a second block run's {spread}")
    del trainer, batch, snap, runs, block
    torch.cuda.empty_cache()

    # ---- the bake's rasterizer: the card against the CPU on one view
    with torch.no_grad():
        verts = smplx_forward(body, canonical_params(1, device=dev)) \
            .verts[0].cpu().numpy()
    sub = np.asarray(body.faces)[:RASTER_CHECK_FACES]
    w2c = np.linalg.inv(orbit_camera(10.0, 120.0, 1.5))
    r_dev = rasterize_mesh(verts, sub, w2c, bake_uv.K_BAKE, 1024, 1024,
                           device=dev)
    r_cpu = rasterize_mesh(verts, sub, w2c, bake_uv.K_BAKE, 1024, 1024)
    same_ids = torch.equal(r_dev["face_id"].cpu(), r_cpu["face_id"])
    r_diff = max((r_dev[k].cpu() - r_cpu[k]).abs().max().item()
                 for k in ("bary", "depth", "viewcos"))
    print(f"[bake] rasterize_mesh of {RASTER_CHECK_FACES} faces at 1024^2, "
          f"card against CPU: face ids equal {same_ids} "
          f"({float((r_cpu['face_id'] >= 0).float().mean()):.4f} covered), "
          f"barycentrics / depth / view cosine max diff {r_diff:.3e}",
          flush=True)
    if not same_ids or not r_diff == 0:
        fail(f"rasterize_mesh on the card differs from the CPU: ids equal "
             f"{same_ids}, values {r_diff}")

    # ---- UV bake of BAKE_ITEMS items of the reference's layout
    items_root = os.path.join(root, "items")
    dirs, lst, _ = write_hgs_items(items_root, BAKE_ITEMS, rng)
    bake_ms = []
    real_bake = bake_uv.bake_item

    def timed_bake(*a, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = real_bake(*a, **kw)
        torch.cuda.synchronize()
        bake_ms.append((time.perf_counter() - t) * 1e3)
        return out

    cwd = os.getcwd()
    bake_uv.bake_item = timed_bake
    os.chdir(root)              # wrong_id.npy, if any, stays under build/
    try:
        res = bake_uv.main(["--items", lst, "--smplx", npz, "--device",
                            DEVICE])
    finally:
        os.chdir(cwd)
        bake_uv.bake_item = real_bake
    covered = [s["covered"] for _, _, s in res["baked"]]
    direct = [s["direct"] for _, _, s in res["baked"]]
    back = HGSDataset(PRESETS[TRAIN_PRESET], items=dirs, training=False)[0]
    uv_back = back["UV_inital"]
    print(f"[bake] bake_uv over {BAKE_ITEMS} items (18 views at 1024^2 each, "
          f"a 1024^2 atlas, the {n_faces}-face mesh): ms per item "
          f"{fmt(bake_ms, '.1f')}; texels covered {fmt(direct, '.4f')}, "
          f"after the mip fill {fmt(covered, '.4f')}; read back by "
          f"HGSDataset: UV_inital {uv_back.shape}, mean "
          f"{float(uv_back.mean()):.4f}, std {float(uv_back.std()):.4f}",
          flush=True)
    if res["wrong"] or len(res["baked"]) != BAKE_ITEMS:
        fail(f"bake_uv: {len(res['baked'])} baked, failed {res['wrong']}")
    if (not np.isfinite(uv_back).all() or not uv_back.std() > 0
            or not min(direct) > 0):
        fail("the baked texture is empty or not finite")

    # ---- the converters at full width
    gen = torch.Generator(device=dev).manual_seed(15)
    with torch.device("meta"):
        vae = VAEModel(PRESETS[TRAIN_PRESET])
    names = convert.reference_key_map(vae)
    src = {names[k]: torch.randn(v.shape, generator=gen, device=dev)
           .cpu().numpy() for k, v in vae.state_dict().items()}
    st_path, vae_out = (os.path.join(root, n) for n in
                        ("autoencoder.safetensors", "vae_params.pt"))
    write_safetensors(st_path, src)
    t0 = time.perf_counter()
    report = convert_reference_ckpt.main(["--ckpt", st_path, "--preset",
                                          TRAIN_PRESET, "--out", vae_out])
    vae_s = time.perf_counter() - t0
    loaded, stats = checkpoint.load_params_any(vae_out, vae, None,
                                               verbose=False)
    vae_exact = all(np.array_equal(loaded[k].numpy(), src[names[k]])
                    for k in names)
    print(f"[convert] convert_reference_ckpt {TRAIN_PRESET} VAE: "
          f"{os.path.getsize(st_path)} bytes -> {os.path.getsize(vae_out)} "
          f"bytes in {vae_s:.2f} s; {report['converted']} converted, "
          f"unmapped {report['unmapped']}, missing {len(report['missing'])}; "
          f"read back bit for bit {vae_exact}", flush=True)
    if (report["missing"] or report["mismatches"] or report["unmapped"]
            or stats["missing"] or not vae_exact):
        fail(f"convert_reference_ckpt at {TRAIN_PRESET}: {report}, {stats}")
    del src, loaded

    sap = sapiens_source(gen, dev)
    pth, enc_out = (os.path.join(root, n) for n in ("sapiens.pth",
                                                    "sapiens_1b.pt"))
    torch.save(sap, pth)
    t0 = time.perf_counter()
    sstats = convert_sapiens.main(["--ckpt", pth, "--out", enc_out])
    sap_s = time.perf_counter() - t0
    with torch.device("meta"):
        enc = sapiens_1b_encoder()
    loaded, stats = checkpoint.load_params_any(enc_out, enc, None,
                                               verbose=False)
    sap_exact = all(torch.equal(loaded[k], sapiens_expected(sap, k))
                    for k in enc.state_dict())
    print(f"[convert] convert_sapiens at Sapiens-1B geometry "
          f"({sum(v.numel() for v in sap.values())} source values): "
          f"{os.path.getsize(pth)} bytes -> {os.path.getsize(enc_out)} bytes "
          f"in {sap_s:.2f} s; {sstats['converted']} converted, unmatched "
          f"{sstats['unmatched']}, missing {len(sstats['missing'])}; read "
          f"back bit for bit {sap_exact}", flush=True)
    if (sstats["missing"] or sstats["mismatches"]
            or sstats["unmatched"] != ["backbone.cls_token"]
            or stats["missing"] or not sap_exact):
        fail(f"convert_sapiens: {sstats['mismatches'][:3]}, unmatched "
             f"{sstats['unmatched']}, missing {sstats['missing'][:3]}")
    del sap, loaded
    shutil.rmtree(root, ignore_errors=True)
    return {"k1_template": c_step.n1, "k2_template": c_step.n2,
            "k1_remat": c_remat.n1, "k2_remat": c_remat.n2,
            "knn": {"template": c_step.nk, "template_remat": c_remat.nk},
            "k1": {k: held[k] for k in ("err", "ms", "plain_ms")}
            | {"bound_ms": held["new"][0],
               "bound_ms_without_cull": held["old"][0]},
            "k2": {k: held2[k] for k in ("err", "rel", "ms", "plain_ms")}
            | {"bound_ms": held2["new"][0],
               "bound_ms_without_cull": held2["old"][0]}}


# ---- phase 17: the RasterizeConfig knobs and the last ported features ----
# tile-16 windows (max_tiles_per_gaussian, big_win, pair_budget_factor) in
# 16-px tiles, tried in turn until the overflow is under OVERFLOW_SHARE of
# the pairs: the renderer's 32-px settings (Config: 36, 12, 12), then wider
# (the third has the JAX tile_ab.py "t16_w5" proportions to them: base side
# 5/3, big window 2x, budget 1.6x), then wider still
T16_WINDOWS = ((36, 12, 12), (64, 16, 16), (100, 24, 20), (144, 24, 24))
# 32-px windows for the tile-16 / tile-32 image check, which needs no drops
# at either tile: the renderer's, then wider
T32_WINDOWS = ((36, 12, 12), (64, 16, 16), (100, 20, 20))
OVERFLOW_SHARE = 0.01
# tile 16 against tile 32 (maps net of the cut share): the JAX
# test_tile16_matches_dense tolerance
TILE16_ATOL, TILE16_RTOL = 5e-5, 1e-4
# the bf16 gradient stream's Gaussian gradients against the f32 stream's,
# normalised by the f32 gradient's max (the JAX test's bound)
BF16_GRAD_TOL = 8e-3
LPIPS_FILE_TOL = 1e-4           # LPIPS from files, card against CPU, TF32 off
KNOB_STEPS = 3
KNN_ITEMS = 8                   # the vae_b batch, and a request's avatars
KNN_REPS = 20
KNN_PAIR_OPS = 5                # f32 instructions a pair test (csrc/knn.cu)


def lpips_files(root, net, rng, heads=True):
    """A torchvision-layout ``vgg16`` / ``alexnet`` feature state dict of
    seeded N(0, 2 / fan_in) weights and, with ``heads``, richzhang head
    weights, saved with ``torch.save`` under ``root``; their paths."""
    import torch

    from sigman_release_torch.losses.lpips import (
        ALEX_CHANNELS, ALEX_CONVS, ALEX_FEATURES, VGG_CHANNELS, VGG_CONVS,
        VGG_FEATURES)

    if net == "alex":
        chans = (3,) + ALEX_CHANNELS
        convs = [(i, chans[k + 1], chans[k], ALEX_CONVS[k][0])
                 for k, i in enumerate(ALEX_FEATURES)]
    else:
        shapes, cin = [], 3
        for n, ch in zip(VGG_CONVS, VGG_CHANNELS):
            shapes += [(ch, cin, 3)] + [(ch, ch, 3)] * (n - 1)
            cin = ch
        convs = [(i,) + sh for i, sh in zip(VGG_FEATURES, shapes)]
    sd = {}
    for i, co, ci, k in convs:
        sd[f"features.{i}.weight"] = torch.from_numpy(rng.normal(
            0, np.sqrt(2.0 / (ci * k * k)), (co, ci, k, k)).astype(np.float32))
        sd[f"features.{i}.bias"] = torch.from_numpy(
            rng.normal(0, 0.1, co).astype(np.float32))
    os.makedirs(root, exist_ok=True)
    trunk = os.path.join(root, f"{net}_features.pt")
    torch.save(sd, trunk)
    if not heads:
        return trunk, None
    lin = {f"lin{i}.model.1.weight": torch.from_numpy(
        rng.uniform(0, 2.0 / c, (1, c, 1, 1)).astype(np.float32))
        for i, c in enumerate(ALEX_CHANNELS if net == "alex"
                              else VGG_CHANNELS)}
    head = os.path.join(root, f"{net}_heads.pt")
    torch.save(lin, head)
    return trunk, head


def pixel_rows(tiles, V, cfg):
    """[V*n_tiles, 8, tile^2] tile buffers -> [V, 8, H*W] in image order."""
    t = tiles.reshape(V, cfg.nty, cfg.ntx, 8, cfg.tile, cfg.tile)
    t = t.permute(0, 3, 1, 4, 2, 5).reshape(V, 8, cfg.nty * cfg.tile,
                                            cfg.ntx * cfg.tile)
    return t[:, :, :cfg.img_h, :cfg.img_w].reshape(V, 8, -1)


def windowed(base, windows, tile, prepare):
    """The first of ``windows`` (in tiles of ``tile``) whose stream
    (``prepare(cfg)``) drops under OVERFLOW_SHARE of its pairs: (cfg,
    stream, the share of each window tried)."""
    tried = []
    for mtpg, big, budget in windows:
        cfg = base._replace(tile=tile, max_tiles_per_gaussian=mtpg,
                            big_win=big, pair_budget_factor=budget)
        stream = prepare(cfg)
        share = int(stream.overflow) / max(int(stream.tile_count.sum()), 1)
        tried.append(((mtpg, big, budget), share))
        if share < OVERFLOW_SHARE:
            return cfg, stream, tried
    fail(f"tile {tile}: overflow {tried} with every window tried")


def grad_rel(a, b):
    """max |a - b| over max |b|."""
    return float((a - b).abs().max() / (b.abs().max() + 1e-30))


def knobs_phase(dev, body, template, clock, serve):
    """Phase 17: the RasterizeConfig knobs as K1 / K2 variants, step
    tracing and LPIPS weights from files (``serve``: phase 4's serving
    scene and its K1 numbers). Returns the numbers the kernels line
    needs."""
    import shutil

    import torch

    from sigman_release_torch.config import PRESETS
    from sigman_release_torch.data.dataset import SyntheticAvatarDataset
    from sigman_release_torch.losses.lpips import LPIPS, load_lpips_params
    from sigman_release_torch.ops.rasterizer import backward_tiles as k2
    from sigman_release_torch.ops.rasterizer import forward_tiles as k1
    from sigman_release_torch.ops.rasterizer import render as render_lib
    from sigman_release_torch.training import dit_trainer, vae_trainer

    clock.start("knobs")
    t_phase = time.perf_counter()
    root = os.path.join(ROOT, "build", "smoke_knobs")
    trace_dir = os.path.join(ROOT, "build", "smoke_trace")
    for d in (root, trace_dir):
        shutil.rmtree(d, ignore_errors=True)
    cfg = PRESETS[TRAIN_PRESET]
    trainer, batch = vae_trainer.synthetic_setup(
        cfg, device=dev, body_model=body, template=template)
    renderer = trainer.latent_renderer.renderer
    base = renderer.raster_cfg
    snap = [p.detach().clone() for p in trainer.params_g]
    gen_state = trainer.generator.get_state()

    def restore():
        """The fresh trainer: weights, no AdamW state, the generator."""
        with torch.no_grad():
            for p, q in zip(trainer.params_g, snap):
                p.copy_(q)
                p.grad = None
        trainer.opt_g.state.clear()
        trainer.generator.set_state(gen_state)
        trainer.step, trainer._micro = 0, {"g": 0, "d": 0}

    # taps on the renderer's calls: the Gaussians' inputs and gradients of
    # a step's render, K1's and K2's inputs and the stream
    tap = {}
    real = (render_lib.prepare_pairs, render_lib.forward_tiles,
            render_lib.backward_tiles)

    def tapping_prepare(*a):
        stream = real[0](*a)
        if "grads" in tap:
            tap["inputs"] = [x.detach().clone() for x in a[:6]]
            for i, x in enumerate(a[:4]):
                x.register_hook(lambda g, i=i: tap["grads"].__setitem__(
                    i, g.detach().clone()))
        tap["stream"] = stream
        return stream

    def tapping(name, fn):
        def wrapped(*a, **kw):
            tap[name] = (a, kw)
            return fn(*a, **kw)
        return wrapped

    step_ms = []
    real_step = trainer.train_step_g

    def timed_step(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logs = real_step(*a, **kw)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        return logs

    def g_steps(name, rcfg):
        """KNOB_STEPS G steps from the fresh trainer under ``rcfg``: the
        first step's loss and Gaussian gradients, the last step's K1 / K2
        inputs and stream, the median of steps 2-3 and the peak."""
        restore()
        renderer.raster_cfg = rcfg
        torch.cuda.reset_peak_memory_stats()
        step_ms.clear()
        run = {}
        for i in range(KNOB_STEPS):
            tap.clear()
            if i == 0:
                tap["grads"] = [None] * 4
            logs = {k: float(v) for k, v in trainer.train_step_g(batch).items()}
            if i == 0:
                run.update(loss=logs["loss"], grads=tap["grads"],
                           inputs=tap["inputs"])
            if not all(np.isfinite(v) for v in logs.values()):
                fail(f"{name}: non-finite G step {i + 1}: {logs}")
        run.update(k1=tap["k1"], k2=tap["k2"], stream=tap["stream"],
                   overflow=logs["overflow"], ms=list(step_ms),
                   med=statistics.median(step_ms[1:]),
                   peak=torch.cuda.max_memory_allocated() / 2**30)
        tap.clear()
        print(f"[knobs] {name}: G steps {fmt(run['ms'], '.1f')} ms (median "
              f"of 2-{KNOB_STEPS} {run['med']:.1f}), peak {run['peak']:.2f} "
              f"GiB, first loss {run['loss']!r}, last overflow "
              f"{run['overflow']:.0f}", flush=True)
        return run

    render_lib.prepare_pairs = tapping_prepare
    render_lib.forward_tiles = tapping("k1", real[1])
    render_lib.backward_tiles = tapping("k2", real[2])
    trainer.train_step_g = timed_step
    k1.forward_tiles.launches_by_variant.clear()
    k2.backward_tiles.launches_by_variant.clear()
    try:
        with Counted() as path:
            runs = {"t32": g_steps("tile 32, f32 stream", base)}
            g_in = runs["t32"]["inputs"]
            with torch.no_grad():
                t16_cfg, _, tried = windowed(
                    base, T16_WINDOWS, 16,
                    lambda c: real[0](*g_in, c))
            print(f"[knobs] tile-16 windows on the G step's Gaussians "
                  f"(max_tiles_per_gaussian, big_win, pair_budget_factor): "
                  f"overflow share {tried}; the renderer's 32-px "
                  f"{(base.max_tiles_per_gaussian, base.big_win, base.pair_budget_factor)}",
                  flush=True)
            runs["bf16"] = g_steps("tile 32, bf16 stream",
                                   base._replace(grad_stream_bf16=True))
            runs["t16"] = g_steps("tile 16, f32 stream", t16_cfg)
            # ---- (d) step tracing: fit over 3 steps, the third traced;
            # early_stop off, so that the path runs that variant too
            restore()
            renderer.raster_cfg = base._replace(early_stop=False)
            item = SyntheticAvatarDataset(cfg, n_items=1, seed=0)[0]
            host = {k: v[None] for k, v in item.items() if k != "item"}
            step_ms.clear()
            trainer.fit([host] * KNOB_STEPS, num_steps=KNOB_STEPS,
                        profile_dir=trace_dir, profile_every=2)
            fit_ms = list(step_ms)
            tiny = PRESETS["test_tiny"]
            dit, _, _ = dit_trainer.synthetic_setup(
                tiny, device=dev, n_items=1, body_model=body,
                template=template)
            ditem = SyntheticAvatarDataset(tiny, n_items=1, seed=0)[0]
            dhost = {k: ditem[k][None] for k in dit_trainer.RAW_KEYS}
            dit_dir = os.path.join(trace_dir, "dit")
            dit.fit([dhost] * KNOB_STEPS, num_steps=KNOB_STEPS,
                    profile_dir=dit_dir, profile_every=2)
            del dit
    finally:
        (render_lib.prepare_pairs, render_lib.forward_tiles,
         render_lib.backward_tiles) = real
        trainer.train_step_g = real_step
        renderer.raster_cfg = base
    variants = {"k1": dict(k1.forward_tiles.launches_by_variant),
                "k2": dict(k2.backward_tiles.launches_by_variant)}
    n_g = 3 * KNOB_STEPS + KNOB_STEPS
    print(f"[knobs] the phase's G steps and fit launched K1 {path.n1}, K2 "
          f"{path.n2} times; by variant {variants}", flush=True)
    if path.n1 != n_g or path.n2 != n_g:
        fail(f"phase 17's steps launched K1 {path.n1}, K2 {path.n2}, not "
             f"{n_g} each")
    for kern, name in (("k1", "tile16"), ("k2", "tile16"), ("k2", "bf16"),
                       ("k1", "early_stop_off"), ("k2", "early_stop_off")):
        if variants[kern].get(name, 0) < 1:
            fail(f"phase 17's steps did not launch {kern} {name}")

    # ---- (d) the traces
    files = sorted(f for f in os.listdir(trace_dir)
                   if f.endswith(".pt.trace.json"))
    dit_files = [f for f in os.listdir(dit_dir) if f.endswith(".pt.trace.json")]
    if len(files) != 1 or len(dit_files) != 1:
        fail(f"fit with profile_every 2 over {KNOB_STEPS} steps wrote "
             f"{files} (VAE) and {dit_files} (DiT), not one trace each")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernels = [e.get("name", "") for e in events if e.get("cat") == "kernel"]
    device_ms = sum(e.get("dur", 0) for e in events
                    if e.get("cat") == "kernel") / 1e3
    named = {k: [n for n in kernels if k in n][:1]
             for k in ("forward_tiles_kernel", "backward_tiles_kernel")}
    trace_mb = os.path.getsize(os.path.join(trace_dir, files[0])) / 1e6
    print(f"[trace] VAETrainer.fit, {KNOB_STEPS} steps, profile_every 2: "
          f"{files[0]} ({trace_mb:.1f} MB, {len(events)} events, "
          f"{len(kernels)} kernels, {device_ms:.1f} ms of kernel time); K1 / "
          f"K2 named {named}; step ms {fmt(fit_ms, '.1f')} (step 3 traced, "
          f"step 2 not); DiT test_tiny: {dit_files[0]}", flush=True)
    if not all(named.values()):
        fail(f"the trace names no K1 or K2 kernel: {named}")
    shutil.rmtree(trace_dir, ignore_errors=True)

    # ---- (b) the bf16 gradient stream against the f32 one
    t32, b16, t16 = runs["t32"], runs["bf16"], runs["t16"]
    if b16["loss"] != t32["loss"]:
        fail(f"the bf16 stream's first loss {b16['loss']!r} is not the f32 "
             f"stream's {t32['loss']!r}")
    g_rel = [grad_rel(a, b) for a, b in zip(b16["grads"], t32["grads"])]
    print(f"[bf16] first loss bit for bit {b16['loss']!r}; Gaussian "
          f"gradients (means3d, cov3d, colors, opacity) against the f32 "
          f"stream's, max over max: {fmt(g_rel)}", flush=True)
    if not max(g_rel) <= BF16_GRAD_TOL:
        fail(f"the bf16 stream's Gaussian gradients differ by {g_rel}")
    a, kw = b16["k2"]
    f32kw = k1_kw(kw)
    stream = b16["stream"]
    with torch.no_grad():
        held_b = hold_k2(a, kw)
        out_b = held_b.pop("out")
        out_f = k2.backward_tiles(*a, **f32kw)
        if not torch.equal(out_b, out_f.to(torch.bfloat16)):
            fail("K2's bf16 output is not its f32 output rounded")
        n_src = stream.src.shape[0]
        times = {}
        for name, o, kwx in (("f32", out_f, f32kw), ("bf16", out_b, kw)):
            buf = torch.zeros_like(o)
            times[name] = (
                launch_alone_ms(a, kwx, buf),
                cuda_ms(lambda: k2.backward_tiles(*a, **kwx), reps=20),
                cuda_ms(lambda: render_lib.regroup(
                    k2.backward_tiles(*a, **kwx), stream.slots, stream.rows,
                    n_src), reps=20))
            del buf
        d_f = render_lib.regroup(out_f, stream.slots, stream.rows, n_src)
        d_b = render_lib.regroup(out_b, stream.slots, stream.rows, n_src)
        regroup_rel = grad_rel(d_b, d_f)
        # (c) early_stop off: K2 on the G stream against its plain version
        # (also without early_stop) and bit for bit against early_stop on
        held_off2 = hold_k2(a, {**f32kw, "early_stop": False})
        off = held_off2.pop("out")
        k2_off_equal = torch.equal(off, out_f)
        # tile 32 on the same stream: K1's time, both kernels' bounds from
        # the plain version's counts (the backward's are the forward's; the
        # counts do not depend on early_stop, so held_off2's bound is the
        # f32 K2's)
        pairs_b, ts_b, tc_b = a[:3]
        k1_32_ms = cuda_ms(lambda: k1.forward_tiles(pairs_b, ts_b, tc_b,
                                                    **k1_kw(f32kw)), reps=20)
        n_b = int(tc_b.sum())
        k1_32_new = bounds(held_b["work"], K1_WORK, K1_STAGE_OPS, n_b,
                           k1_bytes(n_b, ts_b.numel()))[0]
        k2_32_new = held_off2["new"]
    budget = pairs_b.shape[0]
    for name, (alone, fill, regr) in times.items():
        el = 2 if name == "bf16" else 4
        print(f"[bf16] K2 {name} stream on step 3's stream ({n_b} pairs, "
              f"budget {budget}): alone {alone:.4f} ms, with the zero fill "
              f"{fill:.4f} ms, with the regroup {regr:.4f} ms; writes "
              f"{held_b['n_written'] * 10 * el} B of rows into a "
              f"{budget * 16 * el} B zero-filled output", flush=True)
    print(f"[bf16] K2 bf16 against its plain version (f32, net of one bf16 "
          f"rounding) {held_b['excess']:.3e} per column, plain "
          f"{held_b['plain_ms']:.1f} ms, {bound_text(times['bf16'][0], held_b['new'], held_b['old'])}; "
          f"regrouped Gaussian rows against the f32 stream's "
          f"{regroup_rel:.3e}", flush=True)
    if not held_b["excess"] <= K2_BF16_TOL:
        fail(f"K2's bf16 output is {held_b['excess']} off its plain version")
    print(f"[early_stop] K2 on the G stream: off {held_off2['ms']:.4f} ms "
          f"against on {times['f32'][1]:.4f} ms (with the fill), equal bit "
          f"for bit {k2_off_equal}; off against its plain version (also "
          f"off): per-column relative {held_off2['rel']:.3e}, plain "
          f"{held_off2['plain_ms']:.1f} ms, "
          f"{bound_text(held_off2['ms'], held_off2['new'], held_off2['old'])}",
          flush=True)
    if not held_off2["rel"] <= K2_TOL:
        fail(f"K2 with early_stop=False is {held_off2['rel']} off its plain "
             f"version")
    if not k2_off_equal:
        fail("K2 with early_stop=False differs from early_stop=True")
    del out_b, out_f, off, d_f, d_b

    # ---- (a) tile 16 on the G stream: K1 and K2 against their plain versions
    a16, kw16 = t16["k2"]
    with torch.no_grad():
        held16_2 = hold_k2(a16, kw16)
        del held16_2["out"]
        held16_1 = hold_k1(*a16[:3], k1_kw(kw16))
    n16 = held16_1["n_pairs"]
    print(f"[tile16] G stream at tile 16: {n16} pairs in {a16[1].numel()} "
          f"tiles (tile 32: {n_b} in {ts_b.numel()}); last step's overflow "
          f"{t16['overflow']:.0f} (tile 32: {t32['overflow']:.0f}); "
          f"{stream_text(a16[2], held16_2['work'])}")
    print(f"[tile16] K1 {held16_1['ms']:.4f} ms (tile 32 {k1_32_ms:.4f}), "
          f"plain {held16_1['plain_ms']:.1f} ms, max |kernel - plain| "
          f"{held16_1['err']:.3e}; "
          f"{bound_text(held16_1['ms'], held16_1['new'], held16_1['old'])}; "
          f"tile 32 bound {k1_32_new[0]:.4f} ms ({k1_32_new[1]})")
    print(f"[tile16] K2 with the fill {held16_2['ms']:.4f} ms (tile 32 "
          f"{times['f32'][1]:.4f}), plain {held16_2['plain_ms']:.1f} ms, "
          f"per-column relative {held16_2['rel']:.3e}; "
          f"{bound_text(held16_2['ms'], held16_2['new'], held16_2['old'])}; "
          f"tile 32 bound {k2_32_new[0]:.4f} ms ({k2_32_new[1]})")
    print(f"[tile16] G step median of 2-{KNOB_STEPS}: tile 16 "
          f"{t16['med']:.1f} ms, peak {t16['peak']:.2f} GiB; tile 32 "
          f"{t32['med']:.1f} ms, peak {t32['peak']:.2f} GiB; bf16 stream "
          f"{b16['med']:.1f} ms, peak {b16['peak']:.2f} GiB", flush=True)
    if not held16_1["err"] <= K1_TOL or not held16_2["rel"] <= K2_TOL:
        fail(f"tile 16 on the G stream: K1 {held16_1['err']}, K2 "
             f"{held16_2['rel']} off their plain versions")
    del runs, t32, b16, t16, a, a16, stream, pairs_b

    # ---- (a) tile 16 on the serving stream; (c) K1 with early_stop off
    sv = serve
    scene = (sv["pos"], sv["cov3d"], sv["rgb"], sv["opa"], sv["cv"], sv["cvp"])
    with torch.no_grad():
        s16_cfg, s16, tried16 = windowed(
            sv["rc"], T16_WINDOWS, 16,
            lambda c: render_lib.prepare_pairs(*scene, c))
        kw_s16 = dict(ntx=s16_cfg.ntx, tiles_per_view=s16_cfg.n_tiles,
                      chunk=s16_cfg.chunk, tile=16)
        held_s16 = hold_k1(s16.pairs, s16.tile_start, s16.tile_count, kw_s16)
        # tile 32 at windows with no drops at either tile, for the maps
        for i, win in enumerate(T32_WINDOWS):
            c32 = sv["rc"]._replace(max_tiles_per_gaussian=win[0],
                                    big_win=win[1], pair_budget_factor=win[2])
            c16 = s16_cfg if i == 0 else s16_cfg._replace(
                max_tiles_per_gaussian=T16_WINDOWS[-1][0],
                big_win=T16_WINDOWS[-1][1],
                pair_budget_factor=T16_WINDOWS[-1][2])
            st32 = render_lib.prepare_pairs(*scene, c32)
            st16 = s16 if i == 0 else render_lib.prepare_pairs(*scene, c16)
            drops = (int(st32.overflow), int(st16.overflow))
            if drops == (0, 0):
                break
        else:
            fail(f"the serving stream drops pairs at every window: {drops}")
        kw32 = dict(ntx=c32.ntx, tiles_per_view=c32.n_tiles, chunk=c32.chunk)
        on = k1.forward_tiles(st32.pairs, st32.tile_start, st32.tile_count,
                              **kw32)
        m32 = pixel_rows(on, N_VIEWS, c32)
        m16 = pixel_rows(k1.forward_tiles(
            st16.pairs, st16.tile_start, st16.tile_count, ntx=c16.ntx,
            tiles_per_view=c16.n_tiles, chunk=c16.chunk, tile=16),
            N_VIEWS, c16)
        share = k1_cut_share(m16, m32, st32.pairs)
        d = (m16[:, :5] - m32[:, :5]).abs()
        over = (d - share - TILE16_ATOL - TILE16_RTOL * m32[:, :5].abs())
        maps_err = over.clamp_min(0).max().item()
        img_diff = d[:, :3].max().item()
        del on
        # (c) early_stop off: K1 on phase 4's serving stream (the renderer's
        # windows) against its plain version (also without early_stop) and
        # bit for bit against early_stop on
        rc = sv["rc"]
        ss = render_lib.prepare_pairs(*scene, rc)
        kw_s = dict(ntx=rc.ntx, tiles_per_view=rc.n_tiles, chunk=rc.chunk)
        held_off1 = hold_k1(ss.pairs, ss.tile_start, ss.tile_count,
                            {**kw_s, "early_stop": False})
        on = k1.forward_tiles(ss.pairs, ss.tile_start, ss.tile_count, **kw_s)
        off = k1.forward_tiles(ss.pairs, ss.tile_start, ss.tile_count,
                               early_stop=False, **kw_s)
        k1_off_equal = torch.equal(on, off)
        k1_on_ms = cuda_ms(lambda: k1.forward_tiles(
            ss.pairs, ss.tile_start, ss.tile_count, **kw_s), reps=20)
    print(f"[tile16] serving stream: windows tried {tried16}; "
          f"{int(s16.tile_count.sum())} pairs at tile 16 (tile 32: "
          f"{sv['n_pairs']}); K1 {held_s16['ms']:.4f} ms (tile 32 "
          f"{sv['k1_ms']:.4f}), plain {held_s16['plain_ms']:.1f} ms, max "
          f"|kernel - plain| {held_s16['err']:.3e}; "
          f"{bound_text(held_s16['ms'], held_s16['new'], held_s16['old'])}; "
          f"tile 32 bound {sv['k1_bound']:.4f} ms")
    print(f"[tile16] tile 16 against tile 32 on the serving scene (windows "
          f"{(c16.max_tiles_per_gaussian, c16.big_win)} / "
          f"{(c32.max_tiles_per_gaussian, c32.big_win)}, no drops): rgb max "
          f"diff {img_diff:.3e}, past {TILE16_ATOL} + {TILE16_RTOL} rel net "
          f"of the cut share {maps_err:.3e} ({int((share[:, 4] > 0).sum())} "
          f"pixels at the cut)", flush=True)
    print(f"[early_stop] K1 on the serving stream ({held_off1['n_pairs']} "
          f"pairs; phase 4: {sv['n_pairs']}): off {held_off1['ms']:.4f} ms "
          f"against on {k1_on_ms:.4f} ms, equal bit for bit {k1_off_equal}; "
          f"off against its plain version (also off) "
          f"{held_off1['err']:.3e}, plain {held_off1['plain_ms']:.1f} ms, "
          f"{bound_text(held_off1['ms'], held_off1['new'], held_off1['old'])}",
          flush=True)
    if not held_off1["err"] <= K1_TOL:
        fail(f"K1 with early_stop=False is {held_off1['err']} off its plain "
             f"version on the serving stream")
    if not held_s16["err"] <= K1_TOL:
        fail(f"K1 at tile 16 is {held_s16['err']} off its plain version on "
             f"the serving stream")
    if not maps_err == 0:
        fail(f"tile 16 renders the serving scene {maps_err} past the tile-32 "
             f"maps' tolerance")
    if not k1_off_equal:
        fail("K1 with early_stop=False differs from early_stop=True")
    del s16, st16, st32, ss, on, off, m16, m32, share, d, over, trainer, batch
    torch.cuda.empty_cache()

    # ---- (e) LPIPS from files, on the card and on the CPU
    rng = np.random.default_rng(17)
    x = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 64, 64)).astype(
        np.float32))
    y = torch.from_numpy(rng.uniform(-1, 1, (2, 3, 64, 64)).astype(
        np.float32))
    prev_tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    lp = {}
    try:
        for net in ("vgg", "alex"):
            trunk, head = lpips_files(root, net, rng)
            sd = load_lpips_params(trunk, head, net=net)
            outs = []
            for where in (dev, torch.device("cpu")):
                m = LPIPS(net).to(where)
                m.load_state_dict(sd)
                with torch.no_grad():
                    outs.append(m(x.to(where), y.to(where)).cpu())
            lp[net] = ((outs[0] - outs[1]).abs().max().item(),
                       outs[1].tolist())
    finally:
        torch.backends.cudnn.allow_tf32 = prev_tf32
    shutil.rmtree(root, ignore_errors=True)
    print(f"[lpips] from files (features + heads), card against CPU, TF32 "
          f"off: {lp}", flush=True)
    if not all(e <= LPIPS_FILE_TOL for e, _ in lp.values()):
        fail(f"LPIPS from files differs between the card and the CPU: {lp}")
    wall = time.perf_counter() - t_phase
    print(f"[knobs] phase 17 in {wall:.1f} s", flush=True)
    return {"k1_launches": path.n1, "k2_launches": path.n2,
            "knn_launches": path.nk, "variants": variants,
            "k1_tile16": {"ms": held16_1["ms"],
                          "plain_ms": held16_1["plain_ms"],
                          "bound_ms": held16_1["new"][0],
                          "bound_by": held16_1["new"][1],
                          "max_abs_err": held16_1["err"],
                          "serve": {"ms": held_s16["ms"],
                                    "plain_ms": held_s16["plain_ms"],
                                    "bound_ms": held_s16["new"][0],
                                    "max_abs_err": held_s16["err"]}},
            "k1_early_stop_off": {"ms": held_off1["ms"], "on_ms": k1_on_ms,
                                  "plain_ms": held_off1["plain_ms"],
                                  "bound_ms": held_off1["new"][0],
                                  "bound_by": held_off1["new"][1],
                                  "max_abs_err": held_off1["err"],
                                  "equal_to_early_stop_on": k1_off_equal},
            "k2_tile16": {"ms": held16_2["ms"],
                          "plain_ms": held16_2["plain_ms"],
                          "bound_ms": held16_2["new"][0],
                          "bound_by": held16_2["new"][1],
                          "max_abs_err": held16_2["err"],
                          "max_col_rel_err": held16_2["rel"]},
            "k2_early_stop_off": {"ms": held_off2["ms"],
                                  "on_ms": times["f32"][1],
                                  "plain_ms": held_off2["plain_ms"],
                                  "bound_ms": held_off2["new"][0],
                                  "bound_by": held_off2["new"][1],
                                  "max_abs_err": held_off2["err"],
                                  "max_col_rel_err": held_off2["rel"],
                                  "equal_to_early_stop_on": k2_off_equal},
            "k2_bf16": {"ms": times["bf16"][1],
                        "kernel_only_ms": times["bf16"][0],
                        "with_regroup_ms": times["bf16"][2],
                        "f32_ms": times["f32"][1],
                        "f32_kernel_only_ms": times["f32"][0],
                        "f32_with_regroup_ms": times["f32"][2],
                        "plain_ms": held_b["plain_ms"],
                        "bound_ms": held_b["new"][0],
                        "bound_by": held_b["new"][1],
                        "max_abs_err": held_b["err"],
                        "max_col_excess": held_b["excess"]},
            "wall_s": wall}


def knn_phase(dev, template, clock):
    """Phase 18: the KNN base scale kernel against its plain version at the
    main path's shape, its time and its f32-issue bound. Returns the
    numbers the kernels line needs."""
    import torch

    from sigman_release_torch.ops import knn

    clock.start("knn")
    pcd = template.init_pcd.to(dev, torch.float32)
    g = torch.Generator(device=dev).manual_seed(0)
    pts = (pcd[None] + 0.003 * torch.randn((KNN_ITEMS, *pcd.shape),
                                           generator=g, device=dev))
    pts = pts.contiguous()
    before = knn.mean_knn_dist2.launches
    out = knn.mean_knn_dist2(pts)
    if knn.mean_knn_dist2.launches != before + 1:
        fail("mean_knn_dist2 did not launch its kernel once for the batch")

    def plain():
        return torch.stack([knn.mean_knn_dist2_plain(p) for p in pts])

    ref = plain()
    torch.cuda.synchronize()
    err = (out.double() - ref.double()).abs().max().item()
    n_equal = (out == ref).sum().item()
    ms = cuda_ms(lambda: knn.mean_knn_dist2(pts), KNN_REPS)
    plain_ms = cuda_ms(plain, 2)
    n = pts.shape[1]
    bound_ms = 1e3 * KNN_ITEMS * n * n * KNN_PAIR_OPS / (H100_F32_FLOPS / 2)
    print(f"[knn] B = {KNN_ITEMS}, N = {n}: kernel {ms:.3f} ms, plain "
          f"{plain_ms:.1f} ms; f32-issue bound {bound_ms:.2f} ms at 67 "
          f"TFLOP/s ({100 * bound_ms / ms:.1f}%); {n_equal} of "
          f"{out.numel()} outputs equal the plain version's bit for bit, max "
          f"|kernel - plain| {err:.3e}", flush=True)
    if not torch.equal(out, ref):
        fail(f"mean_knn_dist2 differs from its plain version by up to {err}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": "f32 issue"}


def fmt(values, spec=".3e"):
    return "[" + ", ".join(f"{v:{spec}}" for v in values) + "]"


def world1_report(name, bare, again, wrapped):
    """Print and check one world-size-1 comparison (``world1_steps``): the
    DDP run and more bare runs (``again``), each against the first bare
    run; the most the bare runs differ by is the floor."""
    def loss_rel(run):
        return [abs(a - b) / max(abs(b), 1e-30)
                for a, b in zip(run["losses"], bare["losses"])]

    def most(rows):
        return [max(v) for v in zip(*rows)]

    loss_floor = most(loss_rel(a) for a in again)
    clip_floor = most(a["clip_rel"] for a in again)
    weights_floor = max(a["weights_rel"] for a in again)
    b = wrapped["buckets"]
    print(f"[ddp] {name} at world size 1 (NCCL) against the bare trainer "
          f"(the most that {len(again)} more bare run(s) differ by in "
          f"brackets): losses {wrapped['losses']} / {bare['losses']}, "
          f"relative {fmt(loss_rel(wrapped))} ({fmt(loss_floor)}); gradient "
          f"at each clip relative L2 {fmt(wrapped['clip_rel'])} "
          f"({fmt(clip_floor)}); new weights relative L2 "
          f"{wrapped['weights_rel']:.3e} ({weights_floor:.3e}); two more "
          f"steps untapped, ms: DDP {fmt(wrapped['ms'], '.1f')}, bare "
          f"{fmt(bare['ms'], '.1f')} ({fmt(again[0]['ms'], '.1f')}); peak "
          f"GiB DDP {wrapped['peak']:.2f}, bare {bare['peak']:.2f} "
          f"({again[0]['peak']:.2f}); {b['count']} bucket(s), {b['bytes']} "
          f"gradient bytes all-reduced per step", flush=True)
    (first, *later), (clip, *clips) = loss_rel(wrapped), wrapped["clip_rel"]
    pairs = [(first, loss_floor[0]), (clip, clip_floor[0]),
             (wrapped["weights_rel"], weights_floor)]
    if (len(wrapped["clip_rel"]) != len(bare["clips"])
            or not all(d <= DDP_LOSS_TOL for d in later)
            or not all(d <= max(DDP_GRAD_TOL, 2 * f)
                       for d, f in zip(clips, clip_floor[1:]))
            or not all(d <= WORLD1_TOL + 2 * f for d, f in pairs)):
        fail(f"{name} under DDP at world size 1 differs from the bare "
             f"trainer by more than the bare runs do")
    return {"ms": wrapped["ms"], "bare_ms": bare["ms"],
            "again_ms": again[0]["ms"], "peak": wrapped["peak"],
            "bare_peak": bare["peak"], "buckets": b}


if __name__ == "__main__":
    main()
