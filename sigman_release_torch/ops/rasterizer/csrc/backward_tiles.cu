// backward_tiles: analytic VJP of forward_tiles, one block per (view, tile)
// of T x T pixels (T = 32: 1024 threads; T = 16: 256), one pixel a thread.
//
// Replaces the Pallas TPU kernel
// ops/rasterizer/pallas_backward.py::backward_tiles of the JAX package
// (body _backward_one_tile, per-pair algebra of its lines 193-282).
//
// What it computes, over the tile's pair segment
// [tile_start, tile_start + tile_count) of the row-major [budget, 16] f32
// pair stream (row layout as forward_tiles.cu), given the forward tile
// buffers fwd [n, 8, T^2] (rgb, depth, 1 - Tr, Tr, 0, 0) and the upstream
// gradients grad [n, 8, T^2] (of rgb, depth and 1 - Tr in rows 0-4):
//   per pixel  TOT = g_rgb . rgb_out + g_d depth_out - g_alpha Tr
//   front to back, replaying forward_tiles' alpha and transmittance,
//     u = g_rgb . c + g_d depth,  w = alpha T_excl (0 past the T floor),
//     prefix += u w,
//     d_pow = u w - alpha / (1 - alpha) (TOT - prefix)   (contributing,
//             unclamped pairs; 0 otherwise), the gradient w.r.t. the
//             exponent (alpha = opa exp(power))
//   per pair, summed over the tile's pixels: the moments of d_pow about the
//   pair's mean, S0 = sum d_pow, Sx = sum d_pow dx, Sy, Sxx, Sxy, Syy with
//   (dx, dy) = mean - pixel, and sum w g_{r,g,b,d}; then
//   d(mean x) = -(a Sx + b Sy), d(mean y) = -(c Sy + b Sx),
//   d(a, b, c) = -(Sxx / 2, Sxy, Syy / 2), d(opacity) = S0 / opa,
//   d(r, g, b, depth) = sum w g. Columns 10-15, rows whose sums are all
//   zero and rows the block never reaches stay as the caller's zeros. The
//   output is f32, or bf16 (each value rounded to nearest even from the
//   f32 sums, the JAX kernel's out_bf16): the same sums, half the bytes.
//   early_stop is forward_tiles.cu's: without it the block walks its whole
//   segment, with the same output bit for bit.
//
// The JAX kernel sums the moments in tile-local coordinates and expands
// them (its lines 254-266: a_grad = -(ml^2 S0 - 2 ml SX + SXX) / 2, ...);
// with a mean tens of pixels off the tile those terms cancel by orders of
// magnitude, and the result's rounding depends on the summation order.
// Centred moments are the same sums without the cancellation.
//
// The suffix term TOT - prefix cancels only if the replayed weights w are
// the ones forward_tiles summed into rgb_out: rows are staged by the same
// code (tile_common.cuh), the cull skips only pairs whose alpha is exactly
// 0, and the transmittance is the same running product.
//
// What bounds it on an H100: as forward_tiles, the bytes, once the
// evaluations no exact kernel needs are gone (the live rows read, the rows
// with a gradient written, the fwd and grad rows of the non-empty tiles),
// and the long segments in practice. Without a cull the time goes to
// evaluations with alpha == 0, and with a straightforward reduction to a
// ten-sum shuffle tree (50 shuffles) for every (row, warp) with a hit, a
// barrier per step and one thread per output value of each staged row.
// The design, each element timed against its alternative on the card
// (PERF.md):
//   * the cull and the per-warp row lists of forward_tiles.cu: a warp
//     visits only the rows whose mask has its 8 x 4 rectangle;
//   * a warp with a nonzero term reduces its ten sums by recursive halving
//     (each exchange step sends half of the remaining sums: 8 + 4 + 2 + 1
//     + 1 = 16 shuffles), stores one partial per (row, warp) and ORs its
//     bit into the row's set of writers (an integer OR: the set, not the
//     order, is recorded);
//   * rows are copied with cp.async a batch ahead and staged kBatch = 128
//     at a time (64 is slower) into a double buffer held in dynamic shared
//     memory with the partials: two barriers per batch; then one thread per
//     row adds the partials of its writers in warp order and writes the
//     row;
//   * blocks launch longest segment first, as forward_tiles (tile order is
//     slower). A tile keeps one block: its rows are then written once,
//     without atomics. At T = 16 the block has 256 threads and its shared
//     memory (SharedLayout<16>, ~63 KB) a quarter of the partials, so three
//     blocks share an SM.
// No carry between blocks and no float atomics: every sum runs in a fixed
// order, so runs repeat bit for bit. Tensor cores do not fit: the moments
// cancel across pixels, and TF32 or bf16 products would miss the 1e-4
// per-column tolerance; the rest is exps and a serial transmittance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "tile_common.cuh"

namespace {

using namespace tiles;

constexpr int kSums = 10;  // S0 Sx Sy Sxx Sxy Syy, sum w g_{r,g,b,d}
constexpr int kBatch = 128;  // pair rows per staged batch

// One step of recursive halving: lanes with bit 2 kHalf set keep the upper
// half of v[0..2 kHalf), the others the lower half, and each adds its
// partner's copy of the half it keeps.
template <int kHalf>
__device__ __forceinline__ void halve(float (&v)[16], int lane) {
  const bool upper = (lane & (2 * kHalf)) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float keep = upper ? v[i + kHalf] : v[i];
    const float send = upper ? v[i] : v[i + kHalf];
    v[i] = keep + __shfl_xor_sync(kFull, send, 2 * kHalf);
  }
}

// Sums s[0..kSums) over the warp: returns, in lanes 2m and 2m + 1, the
// warp's total of sum m (m < kSums; other lanes hold padding). Fixed order:
// the result does not depend on timing.
__device__ __forceinline__ float reduce_sums(const float (&s)[kSums],
                                             int lane) {
  float v[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = i < kSums ? s[i] : 0.0f;
  halve<8>(v, lane);
  halve<4>(v, lane);
  halve<2>(v, lane);
  halve<1>(v, lane);
  return v[0] + __shfl_xor_sync(kFull, v[0], 1);
}

// One block of T^2 threads (a pixel each) per tile; kBatch pair rows per
// staged batch. Shared memory (dynamic, SharedLayout) holds two batches of
// staged rows and one batch of (warp, row) partials.
template <int kSide>
struct SharedLayout {
  static constexpr int kWarps = Tile<kSide>::kPixels / 32;
  Coef coef[2][kBatch];
  float4 conic[2][kBatch];                     // nl, a, b, c
  float part[kWarps][kBatch][kSums];
  RawRow raw[kBatch];                          // the next batch, in flight
  unsigned mask[2][kBatch];
  unsigned writers[2][kBatch];                 // warps that set a partial
};

// Stores the ten gradient columns of a row (o0: mean x, y, conic a, b; o1:
// conic c, r, g, b; o2: opacity, depth) in f32 or, rounded to nearest
// even, in bf16.
__device__ __forceinline__ void store_row(float* o, float4 o0, float4 o1,
                                          float2 o2) {
  *reinterpret_cast<float4*>(o) = o0;
  *reinterpret_cast<float4*>(o + 4) = o1;
  *reinterpret_cast<float2*>(o + 8) = o2;
}
__device__ __forceinline__ void store_row(__nv_bfloat16* o, float4 o0,
                                          float4 o1, float2 o2) {
  auto* p = reinterpret_cast<__nv_bfloat162*>(o);
  p[0] = __floats2bfloat162_rn(o0.x, o0.y);
  p[1] = __floats2bfloat162_rn(o0.z, o0.w);
  p[2] = __floats2bfloat162_rn(o1.x, o1.y);
  p[3] = __floats2bfloat162_rn(o1.z, o1.w);
  p[4] = __floats2bfloat162_rn(o2.x, o2.y);
}

template <int kSide, typename Out>
__global__ void __launch_bounds__(kSide * kSide, 1024 / (kSide * kSide))
backward_tiles_kernel(const float* __restrict__ pairs,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tile_count,
                      const int* __restrict__ order,
                      const float* __restrict__ fwd,
                      const float* __restrict__ grad,
                      Out* __restrict__ d_pairs,
                      int ntx, int tiles_per_view, int early_stop) {
  using G = Tile<kSide>;
  using S = SharedLayout<kSide>;
  constexpr int kPixels = G::kPixels;
  constexpr int kStageWarps = kBatch / 32;    // warps that stage a batch
  static_assert(kBatch % 32 == 0 && kStageWarps <= S::kWarps &&
                    kBatch <= kPixels,
                "batch shape");
  extern __shared__ float4 smem_raw[];
  S& sh = *reinterpret_cast<S*>(smem_raw);

  const int t = order[blockIdx.x];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;           // = the warp's rectangle
  const int tv = t % tiles_per_view;
  const float ox = static_cast<float>((tv % ntx) * kSide);
  const float oy = static_cast<float>((tv / ntx) * kSide);
  const int px = G::pixel_x(warp, lane), py = G::pixel_y(warp, lane);
  const float X = static_cast<float>(px), Y = static_cast<float>(py);
  const int start = tile_start[t];
  const int count = tile_count[t];

  // as forward_tiles.cu: `fetch` copies a batch ahead, `stage` converts
  auto fetch = [&](int b0) {
    const int slot = warp * 32 + lane;
    if (warp < kStageWarps && b0 + slot < count) {
      copy_row_async(&sh.raw[slot],
                     pairs + static_cast<size_t>(start + b0 + slot) * 16);
    }
  };
  auto stage = [&](int buf, int b0) {
    const int slot = warp * 32 + lane;
    if (warp < kStageWarps && b0 + slot < count) {
      wait_rows();
      const RawRow r = sh.raw[slot];
      const Ellipse e = ellipse<kSide>(r, ox, oy);
      const unsigned m = cull_bits<kSide>(e, G::kAll);
      sh.mask[buf][slot] = m;
      if (m != 0u) {
        sh.coef[buf][slot] = coefficients(r, ox, oy);
        sh.conic[buf][slot] = make_float4(e.nl, e.ca, e.cb, e.cc);
      }
    }
  };

  const size_t pix = static_cast<size_t>(t) * 8 * kPixels + py * kSide + px;
  const float g_r = grad[pix];
  const float g_g = grad[pix + kPixels];
  const float g_b = grad[pix + 2 * kPixels];
  const float g_d = grad[pix + 3 * kPixels];
  const float g_a = grad[pix + 4 * kPixels];
  const float tot = g_r * fwd[pix] + g_g * fwd[pix + kPixels]
                    + g_b * fwd[pix + 2 * kPixels] + g_d * fwd[pix + 3 * kPixels]
                    - g_a * fwd[pix + 5 * kPixels];

  float Tf = 1.0f;
  float prefix = 0.0f;
  bool live = true;  // this pixel still has Tf >= T_EPS

  for (int j = threadIdx.x; j < 2 * kBatch; j += kPixels) {
    sh.writers[j / kBatch][j % kBatch] = 0u;
  }
  fetch(0);
  stage(0, 0);
  fetch(kBatch);
  for (int base = 0, buf = 0; base < count; base += kBatch, buf ^= 1) {
    // makes batch `buf` visible; frees buffer buf ^ 1 and `part`
    const int live_pixels = __syncthreads_count(live);
    if (early_stop && live_pixels == 0) break;
    const int n = min(kBatch, count - base);
    for (int j = threadIdx.x; j < kBatch; j += kPixels) {
      sh.writers[buf ^ 1][j] = 0u;
    }
    for (int c = 0; c < n && (!early_stop || __any_sync(kFull, live));
         c += 32) {
      const bool mine =
          c + lane < n && ((sh.mask[buf][c + lane] >> warp) & 1u);
      unsigned rows = __ballot_sync(kFull, mine);
      while (rows) {
        const int jj = __ffs(rows) - 1;
        rows &= rows - 1;
        const int j = c + jj;
        float d_pow = 0.0f, w = 0.0f;
        const Coef k = sh.coef[buf][j];
        if (live) {
          const float power = exponent(k, X, Y);
          if (power <= kPowerEps) {
            const float raw_alpha = k.q1.z * expf(fminf(power, 0.0f));
            if (raw_alpha >= kAlphaMin) {
              const float alpha = fminf(raw_alpha, kAlphaMax);
              const float t_incl = Tf * (1.0f - alpha);
              if (t_incl >= kTEps) {
                w = alpha * Tf;
                const float u = g_r * k.q2.x + g_g * k.q2.y + g_b * k.q2.z
                                + g_d * k.q1.w;
                const float uw = u * w;
                prefix += uw;
                // the 0.99 clamp has no gradient
                if (raw_alpha < kAlphaMax) {
                  d_pow = uw - alpha / (1.0f - alpha) * (tot - prefix);
                }
              }
              Tf = t_incl;
              if (Tf < kTEps) live = false;
            }
          }
        }
        if (__any_sync(kFull, w != 0.0f || d_pow != 0.0f)) {
          const float dx = k.q2.w - X;                 // mean - pixel
          const float dy = sh.conic[buf][j].x - Y;
          const float ddx = d_pow * dx, ddy = d_pow * dy;
          const float s[kSums] = {d_pow, ddx, ddy, ddx * dx, ddx * dy,
                                  ddy * dy, w * g_r, w * g_g, w * g_b,
                                  w * g_d};
          const float total = reduce_sums(s, lane);
          if ((lane & 1) == 0 && (lane >> 1) < kSums) {
            sh.part[warp][j][lane >> 1] = total;
          }
          // an integer OR: the set, not the order, is what is recorded
          if (lane == 0) atomicOr(&sh.writers[buf][j], 1u << warp);
        }
      }
    }
    if (base + kBatch < count) stage(buf ^ 1, base + kBatch);
    __syncthreads();
    // row j: the partials of the warps that set one, in warp order
    const int j = threadIdx.x;
    const unsigned wr = j < n ? sh.writers[buf][j] : 0u;
    if (wr != 0u) {
      float s[kSums];
      const int w0 = __ffs(wr) - 1;
#pragma unroll
      for (int q = 0; q < kSums; q += 2) {
        const float2 v = *reinterpret_cast<const float2*>(&sh.part[w0][j][q]);
        s[q] = v.x;
        s[q + 1] = v.y;
      }
      for (unsigned m = wr & (wr - 1); m; m &= m - 1) {
        const int wi = __ffs(m) - 1;
#pragma unroll
        for (int q = 0; q < kSums; q += 2) {
          const float2 v =
              *reinterpret_cast<const float2*>(&sh.part[wi][j][q]);
          s[q] += v.x;
          s[q + 1] += v.y;
        }
      }
      const float4 g = sh.conic[buf][j];         // nl, a, b, c
      const float ca = g.y, cb = g.z, cc = g.w;
      const float opa = sh.coef[buf][j].q1.z;
      float4 o0, o1;
      o0.x = -(ca * s[1] + cb * s[2]);                        // mean x
      o0.y = -(cc * s[2] + cb * s[1]);                        // mean y
      o0.z = -0.5f * s[3];                                    // conic a
      o0.w = -s[4];                                           // conic b
      o1.x = -0.5f * s[5];                                    // conic c
      o1.y = s[6];                                            // r
      o1.z = s[7];                                            // g
      o1.w = s[8];                                            // b
      float2 o2;
      // a live pixel has alpha = opa exp(power): sum d_alpha exp = S0 / opa
      o2.x = opa > 0.0f ? s[0] / fmaxf(opa, 1e-12f) : 0.0f;   // opacity
      o2.y = s[9];                                            // depth
      store_row(d_pairs + static_cast<size_t>(start + base + j) * 16, o0, o1,
                o2);
    }
    if (base + 2 * kBatch < count) fetch(base + 2 * kBatch);
  }
  wait_rows();  // a block that stopped early leaves no copy in flight
}

template <int kSide, typename Out>
int launch(const float* pairs, const int* tile_start, const int* tile_count,
           const int* order, const float* fwd, const float* grad,
           void* d_pairs, int n_programs, int ntx, int tiles_per_view,
           int early_stop, cudaStream_t stream) {
  constexpr int bytes = sizeof(SharedLayout<kSide>);
  static const cudaError_t set = cudaFuncSetAttribute(
      backward_tiles_kernel<kSide, Out>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return static_cast<int>(set);
  backward_tiles_kernel<kSide, Out><<<n_programs, kSide * kSide, bytes,
                                      stream>>>(
      pairs, tile_start, tile_count, order, fwd, grad,
      static_cast<Out*>(d_pairs), ntx, tiles_per_view, early_stop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. `order` lists the n_programs tiles in
// launch order; `tile` is 16 or 32 and `d_pairs` [budget, 16] f32, or bf16
// with `out_bf16` (anything else returns cudaErrorInvalidValue). Launches
// on `stream`, does not synchronise, and returns the CUDA error (0 on
// success). `d_pairs` must hold zeros: the kernel writes only the rows with
// a nonzero sum, columns 0-9.
extern "C" int backward_tiles_launch(const float* pairs, const int* tile_start,
                                     const int* tile_count, const int* order,
                                     const float* fwd, const float* grad,
                                     void* d_pairs, int n_programs, int ntx,
                                     int tiles_per_view, int tile,
                                     int early_stop, int out_bf16,
                                     void* stream) {
  if (n_programs <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  using Bf16 = __nv_bfloat16;
  if (tile == 32) {
    return out_bf16 ? launch<32, Bf16>(pairs, tile_start, tile_count, order,
                                       fwd, grad, d_pairs, n_programs, ntx,
                                       tiles_per_view, early_stop, s)
                    : launch<32, float>(pairs, tile_start, tile_count, order,
                                        fwd, grad, d_pairs, n_programs, ntx,
                                        tiles_per_view, early_stop, s);
  }
  if (tile == 16) {
    return out_bf16 ? launch<16, Bf16>(pairs, tile_start, tile_count, order,
                                       fwd, grad, d_pairs, n_programs, ntx,
                                       tiles_per_view, early_stop, s)
                    : launch<16, float>(pairs, tile_start, tile_count, order,
                                        fwd, grad, d_pairs, n_programs, ntx,
                                        tiles_per_view, early_stop, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
