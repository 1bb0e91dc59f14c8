// backward_tiles: analytic VJP of forward_tiles, one thread block per
// (view, 32x32 tile), one thread per pixel.
//
// Replaces the Pallas TPU kernel
// ops/rasterizer/pallas_backward.py::backward_tiles of the JAX package
// (body _backward_one_tile, per-pair algebra of its lines 193-282).
//
// What it computes, over the tile's pair segment
// [tile_start, tile_start + tile_count) of the row-major [budget, 16] f32
// pair stream (row layout as forward_tiles.cu), given the forward tile
// buffers fwd [n, 8, 1024] (rgb, depth, 1 - Tr, Tr, 0, 0) and the upstream
// gradients grad [n, 8, 1024] (of rgb, depth and 1 - Tr in rows 0-4):
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
//   d(r, g, b, depth) = sum w g. Columns 10-15 and rows the block never
//   reaches stay as the caller's zeros.
//
// The JAX kernel sums the moments in tile-local coordinates and expands
// them (its lines 254-266: a_grad = -(ml^2 S0 - 2 ml SX + SXX) / 2, ...);
// with a mean tens of pixels off the tile those terms cancel by orders of
// magnitude, and the result's rounding depends on the summation order.
// Centred moments are the same sums without the cancellation.
//
// The suffix term TOT - prefix cancels only if the replayed weights w are
// the ones forward_tiles summed into rgb_out: rows are staged with exactly
// forward_tiles.cu's coefficient arithmetic (the same fmaf / __fmul_rn
// order) and the transmittance is the same running product.
//
// What bounds it on an H100: arithmetic, as forward_tiles, plus the
// reduction of ten sums per pair over the tile's 1024 pixels. Design: no
// carry between blocks and no atomics in device memory (a pair row belongs
// to exactly one (view, tile), so its block writes it once). Rows are
// staged 32 at a time; for each row every warp reduces its ten sums with
// shuffles (skipped, with zeros stored, when no lane of the warp has a
// nonzero weight), lane 0 stores them in shared memory, and after the
// batch 320 threads sum the 32 warps' partials in a fixed order, so runs
// repeat bit for bit. The block stops once every pixel is saturated
// (__syncthreads_count), as forward_tiles does.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // tile side; one thread per pixel
constexpr int kPixels = kTile * kTile;
constexpr int kWarps = kPixels / 32;
constexpr int kBatch = 32;       // pair rows staged per shared-memory batch
constexpr int kCoef = 12;        // floats per staged row (11 used)
constexpr int kGeom = 8;         // ml, nl, ca, cb, cc, opa (6 used)
constexpr int kSums = 10;        // S0 Sx Sy Sxx Sxy Syy, sum w g_{r,g,b,d}
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kPowerEps = 1e-3f;
constexpr unsigned kFullMask = 0xffffffffu;

__global__ void __launch_bounds__(kPixels)
backward_tiles_kernel(const float* __restrict__ pairs,
                      const int* __restrict__ tile_start,
                      const int* __restrict__ tile_count,
                      const float* __restrict__ fwd,
                      const float* __restrict__ grad,
                      float* __restrict__ d_pairs,
                      int ntx, int tiles_per_view) {
  __shared__ __align__(16) float coef[kBatch * kCoef];
  __shared__ float geom[kBatch * kGeom];
  // per (warp, row, sum) partials; after a batch, warp 0's slots hold the
  // block totals
  __shared__ float part[kWarps * kBatch * kSums];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int tv = t % tiles_per_view;
  const float ox = static_cast<float>((tv % ntx) * kTile);
  const float oy = static_cast<float>((tv / ntx) * kTile);
  const float X = static_cast<float>(p % kTile);
  const float Y = static_cast<float>(p / kTile);
  const float XX = X * X, XY = X * Y, YY = Y * Y;

  const int start = tile_start[t];
  const int count = tile_count[t];

  const size_t px = static_cast<size_t>(t) * 8 * kPixels + p;
  const float g_r = grad[px];
  const float g_g = grad[px + kPixels];
  const float g_b = grad[px + 2 * kPixels];
  const float g_d = grad[px + 3 * kPixels];
  const float g_a = grad[px + 4 * kPixels];
  const float tot = g_r * fwd[px] + g_g * fwd[px + kPixels]
                    + g_b * fwd[px + 2 * kPixels] + g_d * fwd[px + 3 * kPixels]
                    - g_a * fwd[px + 5 * kPixels];

  float Tf = 1.0f;
  float prefix = 0.0f;
  bool live = true;  // this pixel still has Tf >= T_EPS

  for (int base = 0; base < count; base += kBatch) {
    // doubles as the barrier that protects the shared arrays from the
    // previous batch's final pass
    if (__syncthreads_count(live) == 0) break;
    const int n = min(kBatch, count - base);
    if (p < n) {
      const float* row = pairs + static_cast<size_t>(start + base + p) * 16;
      const float4 f0 = *reinterpret_cast<const float4*>(row);      // mx my ca cb
      const float4 f1 = *reinterpret_cast<const float4*>(row + 4);  // cc r g b
      const float2 f2 = *reinterpret_cast<const float2*>(row + 8);  // opa depth
      const float ml = f0.x - ox, nl = f0.y - oy;
      const float ca = f0.z, cb = f0.w, cc = f1.x;
      // forward_tiles.cu's coefficient arithmetic, operation for operation
      const float cbm = __fmul_rn(cb, ml);
      float* k = coef + p * kCoef;
      k[0] = __fsub_rn(
          __fmul_rn(-0.5f, fmaf(__fmul_rn(ca, ml), ml,
                                __fmul_rn(__fmul_rn(cc, nl), nl))),
          __fmul_rn(cbm, nl));
      k[1] = fmaf(cb, nl, __fmul_rn(ca, ml));
      k[2] = fmaf(cc, nl, cbm);
      k[3] = -0.5f * ca;
      k[4] = -cb;
      k[5] = -0.5f * cc;
      k[6] = f2.x;   // opacity
      k[7] = f1.y;   // r
      k[8] = f1.z;   // g
      k[9] = f1.w;   // b
      k[10] = f2.y;  // depth
      float* g = geom + p * kGeom;
      g[0] = ml;
      g[1] = nl;
      g[2] = ca;
      g[3] = cb;
      g[4] = cc;
      g[5] = f2.x;
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float* k = coef + j * kCoef;
      float d_pow = 0.0f, w = 0.0f;
      if (live) {
        float power = fmaf(k[1], X, k[0]);
        power = fmaf(k[2], Y, power);
        power = fmaf(k[3], XX, power);
        power = fmaf(k[4], XY, power);
        power = fmaf(k[5], YY, power);
        if (power <= kPowerEps) {
          const float raw = k[6] * expf(fminf(power, 0.0f));
          if (raw >= kAlphaMin) {
            const float alpha = fminf(raw, kAlphaMax);
            const float t_incl = Tf * (1.0f - alpha);
            if (t_incl >= kTEps) {
              w = alpha * Tf;
              const float u = g_r * k[7] + g_g * k[8] + g_b * k[9]
                              + g_d * k[10];
              const float uw = u * w;
              prefix += uw;
              // the 0.99 clamp has no gradient
              if (raw < kAlphaMax) {
                d_pow = uw - alpha / (1.0f - alpha) * (tot - prefix);
              }
            }
            Tf = t_incl;
            if (Tf < kTEps) live = false;
          }
        }
      }
      float* dst = part + (warp * kBatch + j) * kSums;
      if (__any_sync(kFullMask, w != 0.0f || d_pow != 0.0f)) {
        const float dx = geom[j * kGeom] - X;      // mean - pixel
        const float dy = geom[j * kGeom + 1] - Y;
        const float ddx = d_pow * dx, ddy = d_pow * dy;
        float s[kSums] = {d_pow, ddx, ddy, ddx * dx, ddx * dy, ddy * dy,
                          w * g_r, w * g_g, w * g_b, w * g_d};
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
          for (int c = 0; c < kSums; ++c) {
            s[c] += __shfl_down_sync(kFullMask, s[c], off);
          }
        }
        if (lane == 0) {
#pragma unroll
          for (int c = 0; c < kSums; ++c) dst[c] = s[c];
        }
      } else if (lane == 0) {
#pragma unroll
        for (int c = 0; c < kSums; ++c) dst[c] = 0.0f;
      }
    }
    __syncthreads();
    if (p < n * kSums) {
      // thread (row i, sum c) is the only one to touch the slots [*, i, c]
      const int i = p / kSums, c = p % kSums;
      float acc = 0.0f;
      for (int wi = 0; wi < kWarps; ++wi) {
        acc += part[(wi * kBatch + i) * kSums + c];
      }
      part[i * kSums + c] = acc;
    }
    __syncthreads();
    if (p < n) {
      const float* s = part + p * kSums;
      const float* g = geom + p * kGeom;
      const float ca = g[2], cb = g[3], cc = g[4], opa = g[5];
      const float s0 = s[0], sx = s[1], sy = s[2];
      float* o = d_pairs + static_cast<size_t>(start + base + p) * 16;
      float4 o0, o1;
      o0.x = -(ca * sx + cb * sy);                            // mean x
      o0.y = -(cc * sy + cb * sx);                            // mean y
      o0.z = -0.5f * s[3];                                    // conic a
      o0.w = -s[4];                                           // conic b
      o1.x = -0.5f * s[5];                                    // conic c
      o1.y = s[6];                                            // r
      o1.z = s[7];                                            // g
      o1.w = s[8];                                            // b
      float2 o2;
      // a live pixel has alpha = opa exp(power): sum d_alpha exp = S0 / opa
      o2.x = opa > 0.0f ? s0 / fmaxf(opa, 1e-12f) : 0.0f;     // opacity
      o2.y = s[9];                                            // depth
      *reinterpret_cast<float4*>(o) = o0;
      *reinterpret_cast<float4*>(o + 4) = o1;
      *reinterpret_cast<float2*>(o + 8) = o2;
    }
  }
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success). `d_pairs`
// must hold zeros: the kernel writes only the rows it reaches, columns 0-9.
extern "C" int backward_tiles_launch(const float* pairs, const int* tile_start,
                                     const int* tile_count, const float* fwd,
                                     const float* grad, float* d_pairs,
                                     int n_programs, int ntx,
                                     int tiles_per_view, void* stream) {
  if (n_programs > 0) {
    backward_tiles_kernel<<<n_programs, kPixels, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        pairs, tile_start, tile_count, fwd, grad, d_pairs, ntx,
        tiles_per_view);
  }
  return static_cast<int>(cudaGetLastError());
}
