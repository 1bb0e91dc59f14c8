// forward_tiles: front-to-back alpha compositing of depth-sorted Gaussian
// pairs; kBands thread blocks per (view, tile), one pixel a thread, for
// tiles of 32 x 32 (four blocks) and 16 x 16 (two) pixels.
//
// Replaces the Pallas TPU kernel
// ops/rasterizer/pallas_forward.py::forward_tiles of the JAX package
// (body _forward_kernel / _forward_one_tile, alpha math _chunk_alpha).
//
// What it computes, per pixel of the tile, over the tile's pair segment
// [tile_start, tile_start + tile_count) of the row-major [budget, 16] f32
// pair stream (row layout: mean x, mean y, conic a, b, c, r, g, b, opacity,
// depth, 6 pad):
//   power = c0 + cx X + cy Y - a/2 X^2 - b XY - c/2 Y^2   (tile-local X, Y)
//   alpha = min(0.99, opa exp(min(power, 0))), 0 if power > 1e-3 or
//           opa exp(min(power, 0)) < 1/255
//   a pair contributes while T_incl = Tf (1 - alpha) >= 1e-4; Tf multiplies
//   through every pair, Tr is T_incl of the last contributor.
// Output [n_programs, 8, T^2] (T the tile side): rgb (no background),
// depth, 1 - Tr, Tr, 0, 0. With early_stop (the JAX kernel's, on by
// default) a block stops once every pixel of its band has saturated;
// without it the block walks its whole segment, and the output is the same
// bit for bit (a saturated pixel takes no more pairs).
//
// The exponent uses the same tile-local expanded quadratic as the Pallas
// kernel and the plain version, with the same clamp at 0: evaluating
// d = pixel - mean directly differs from it by up to 1e-3 relative at a
// pixel sitting on a Gaussian's mean.
//
// What bounds it on an H100. The work no exact kernel can skip is small: on
// the main path's streams ~3% of the (pair, pixel) evaluations at
// unsaturated pixels reach alpha > 0, so with one staging pass per pair row
// the bound is the bytes (the rows read once, the [n, 8, T^2] output
// written once). What holds the kernel far from it is the few long
// segments: a tenth of the 512^2 views is covered, and a handful of tiles
// hold 30-45 k pairs each while the median tile holds ~20, so the grid ends
// with those tiles' blocks alone on their SMs. Evaluating every row at
// every unsaturated pixel, as a kernel without a cull must, costs more
// than all the rest together. The design, each element timed against its
// alternative on the card (PERF.md):
//   * the exact per-warp cull of tile_common.cuh: staging gives each row a
//     32-bit mask over the tile's 8 x 4 warp rectangles, and each warp
//     takes, per 32 staged rows, the list of rows with its bit (a ballot)
//     and walks only those; a skipped row costs the warp nothing;
//   * at T = 32, kBands = 4 blocks of 256 threads share a tile, each a band
//     of 8 pixel rows, so a long segment is composited on four SMs (1 and 2
//     blocks per tile are slower); a band block tests only its own
//     rectangles at staging. At T = 16 a tile has 256 pixels: two bands of
//     128 (one block of 256 threads was as fast, PERF.md);
//   * blocks launch longest segment first (`order`, from the wrapper's
//     argsort of tile_count, as backward_tiles), so the long tiles start in
//     the first wave: faster on the training stream, a few hundredths of a
//     millisecond slower on the serving stream, whose long tiles come early
//     in tile order and where the argsort is not repaid;
//   * rows are copied into shared memory with cp.async a batch ahead and
//     staged up to 256 at a time (one row per lane of a block's threads)
//     into a double buffer: one barrier per batch; staged rows are three
//     float4, read as broadcasts.
// With early_stop the block stops once every pixel is saturated
// (__syncthreads_count), and a warp leaves a batch once its pixels are.
// Tensor cores do not fit: each (pair, pixel) step is an exp followed by a
// serial f32 transmittance update, and nothing here is a matrix product.

#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

using namespace tiles;

// Blocks per tile, each a band of whole rows of warp rectangles.
template <int kSide>
__host__ __device__ constexpr int bands() { return kSide == 32 ? 4 : 2; }

// Threads of one block: a band of T / bands pixel rows of a T x T tile,
// one pixel per thread.
template <int kSide>
__host__ __device__ constexpr int threads() {
  return kSide * kSide / bands<kSide>();
}

template <int kSide>
__global__ void __launch_bounds__(threads<kSide>(), 1024 / threads<kSide>())
forward_tiles_kernel(const float* __restrict__ pairs,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     const int* __restrict__ order,
                     float* __restrict__ out,
                     int ntx, int tiles_per_view, int early_stop) {
  using G = Tile<kSide>;
  constexpr int kBands = bands<kSide>();
  constexpr int kThreads = threads<kSide>();
  constexpr int kWarps = kThreads / 32;
  // pair rows per staged batch: one per lane of the staging warps
  constexpr int kBatch = kThreads < 256 ? kThreads : 256;
  constexpr int kStageWarps = kBatch / 32;    // warps that stage a batch
  static_assert(kStageWarps <= kWarps, "one staged row per lane");
  static_assert(kWarps % G::kRectsX == 0, "a band is whole rectangle rows");
  __shared__ Coef coef[2][kBatch];
  __shared__ unsigned mask[2][kBatch];
  __shared__ RawRow raw[kBatch];             // the next batch, in flight

  const int t = order[blockIdx.x / kBands];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int band = blockIdx.x % kBands;
  const int rect = band * kWarps + warp;                 // mask bit
  // the mask bits of this block's warps
  const unsigned band_bits = ((1u << kWarps) - 1u) << (band * kWarps);
  const int tv = t % tiles_per_view;
  const float ox = static_cast<float>((tv % ntx) * kSide);
  const float oy = static_cast<float>((tv / ntx) * kSide);
  const int px = G::pixel_x(rect, lane), py = G::pixel_y(rect, lane);
  const float X = static_cast<float>(px), Y = static_cast<float>(py);
  const int start = tile_start[t];
  const int count = tile_count[t];

  // Lane l of warp w < kStageWarps stages row 32 w + l of each batch:
  // `fetch` starts copying it a batch ahead, `stage` writes its cull mask
  // and, if any bit is set, its coefficients.
  auto fetch = [&](int b0) {
    const int slot = warp * 32 + lane;
    if (warp < kStageWarps && b0 + slot < count) {
      copy_row_async(&raw[slot],
                     pairs + static_cast<size_t>(start + b0 + slot) * 16);
    }
  };
  auto stage = [&](int buf, int b0) {
    const int slot = warp * 32 + lane;
    if (warp < kStageWarps && b0 + slot < count) {
      wait_rows();
      const RawRow r = raw[slot];
      const unsigned m =
          cull_bits<kSide>(ellipse<kSide>(r, ox, oy), band_bits);
      mask[buf][slot] = m;
      if (m != 0u) coef[buf][slot] = coefficients(r, ox, oy);
    }
  };

  float Tf = 1.0f, Tr = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  bool live = true;  // this pixel still has Tf >= T_EPS

  fetch(0);
  stage(0, 0);
  fetch(kBatch);
  for (int base = 0, buf = 0; base < count; base += kBatch, buf ^= 1) {
    // makes batch `buf` visible and frees buffer buf ^ 1 for the next one
    const int live_pixels = __syncthreads_count(live);
    if (early_stop && live_pixels == 0) break;
    const int n = min(kBatch, count - base);
    for (int c = 0; c < n && (!early_stop || __any_sync(kFull, live));
         c += 32) {
      // this warp's rows among these 32: those whose mask has its bit
      const bool mine = c + lane < n && ((mask[buf][c + lane] >> rect) & 1u);
      unsigned rows = __ballot_sync(kFull, mine);
      while (rows) {
        const int j = c + __ffs(rows) - 1;
        rows &= rows - 1;
        if (!live) continue;
        const Coef k = coef[buf][j];
        const float power = exponent(k, X, Y);
        if (!(power <= kPowerEps)) continue;
        const float raw_alpha = k.q1.z * expf(fminf(power, 0.0f));
        if (!(raw_alpha >= kAlphaMin)) continue;
        const float alpha = fminf(raw_alpha, kAlphaMax);
        const float t_incl = Tf * (1.0f - alpha);
        if (t_incl >= kTEps) {
          const float w = alpha * Tf;
          acc_r += w * k.q2.x;
          acc_g += w * k.q2.y;
          acc_b += w * k.q2.z;
          acc_d += w * k.q1.w;
          Tr = t_incl;
        }
        Tf = t_incl;
        if (Tf < kTEps) live = false;
      }
    }
    if (base + kBatch < count) {
      stage(buf ^ 1, base + kBatch);
      fetch(base + 2 * kBatch);
    }
  }
  wait_rows();  // a block that stopped early leaves no copy in flight

  constexpr int kPixels = G::kPixels;
  float* o = out + static_cast<size_t>(t) * 8 * kPixels + py * kSide + px;
  o[0] = acc_r;
  o[kPixels] = acc_g;
  o[2 * kPixels] = acc_b;
  o[3 * kPixels] = acc_d;
  o[4 * kPixels] = 1.0f - Tr;
  o[5 * kPixels] = Tr;
  o[6 * kPixels] = 0.0f;
  o[7 * kPixels] = 0.0f;
}

// The cull masks of rows [n, 16] (row i in the tile at origin[i] = (ox,
// oy)) over every warp rectangle: what staging stores, for tests.
template <int kSide>
__global__ void cull_masks_kernel(const float* __restrict__ rows,
                                  const float* __restrict__ origin,
                                  unsigned* __restrict__ masks, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float* p = rows + static_cast<size_t>(i) * 16;
  RawRow r;
  r.f0 = *reinterpret_cast<const float4*>(p);
  r.f1 = *reinterpret_cast<const float4*>(p + 4);
  r.f2 = *reinterpret_cast<const float2*>(p + 8);
  masks[i] = cull_bits<kSide>(
      ellipse<kSide>(r, origin[2 * i], origin[2 * i + 1]), Tile<kSide>::kAll);
}

template <int kSide>
void launch(const float* pairs, const int* tile_start, const int* tile_count,
            const int* order, float* out, int n_programs, int ntx,
            int tiles_per_view, int early_stop, cudaStream_t stream) {
  forward_tiles_kernel<kSide>
      <<<n_programs * bands<kSide>(), threads<kSide>(), 0, stream>>>(
          pairs, tile_start, tile_count, order, out, ntx, tiles_per_view,
          early_stop);
}

}  // namespace

// Plain C entry point for ctypes. `order` lists the n_programs tiles in
// launch order (tile order[i] is composited by the bands<tile>() blocks
// from i * bands<tile>() on). `tile` is 32 or 16; anything else returns
// cudaErrorInvalidValue. Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 on success).
extern "C" int forward_tiles_launch(const float* pairs, const int* tile_start,
                                    const int* tile_count, const int* order,
                                    float* out, int n_programs, int ntx,
                                    int tiles_per_view, int tile,
                                    int early_stop, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_programs > 0) {
    if (tile == 32) {
      launch<32>(pairs, tile_start, tile_count, order, out, n_programs, ntx,
                 tiles_per_view, early_stop, s);
    } else if (tile == 16) {
      launch<16>(pairs, tile_start, tile_count, order, out, n_programs, ntx,
                 tiles_per_view, early_stop, s);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// Plain C entry point for tests: the cull masks staging gives rows [n, 16]
// (16-byte aligned) in the tiles of side `tile` (16 or 32) at origin
// [n, 2]. Launches on `stream`, does not synchronise, returns
// cudaGetLastError().
extern "C" int cull_masks_launch(const float* rows, const float* origin,
                                 unsigned* masks, int n, int tile,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n > 0) {
    if (tile == 32) {
      cull_masks_kernel<32><<<(n + 255) / 256, 256, 0, s>>>(rows, origin,
                                                            masks, n);
    } else if (tile == 16) {
      cull_masks_kernel<16><<<(n + 255) / 256, 256, 0, s>>>(rows, origin,
                                                            masks, n);
    } else {
      return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
