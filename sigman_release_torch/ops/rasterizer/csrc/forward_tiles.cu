// forward_tiles: front-to-back alpha compositing of depth-sorted Gaussian
// pairs, one thread block per (view, 32x32 tile), one thread per pixel.
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
// Output [n_programs, 8, 32^2]: rgb (no background), depth, 1 - Tr, Tr,
// 0, 0.
//
// The exponent uses the same tile-local expanded quadratic as the Pallas
// kernel and the plain version, with the same clamp at 0: evaluating
// d = pixel - mean directly differs from it by up to 1e-3 relative at a
// pixel sitting on a Gaussian's mean.
//
// What bounds it on an H100: arithmetic, not memory. Each pair row is read
// once per tile (40 live bytes) but evaluated at every pixel of the tile
// still short of saturation: 11 to 28 f32 operations and at most one exp
// each, by how far down the loop it runs (chip_smoke.py counts the four
// cases on the main path's stream). The design keeps the
// inner loop free of memory traffic: the block stages 256 rows at a time
// into shared memory, converting each row once into its six tile-local
// quadratic coefficients plus opacity, colour and depth, and every thread
// then reads them as broadcasts. The block stops as soon as every pixel is
// saturated (__syncthreads_count), so saturated tiles skip the rest of
// their segment. Segments need no alignment: the block reads its own start
// and count.

#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;        // tile side; one thread per pixel
constexpr int kPixels = kTile * kTile;
constexpr int kBatch = 256;      // pair rows staged per shared-memory batch
constexpr int kCoef = 12;        // floats per staged row (11 used)
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kPowerEps = 1e-3f;

__global__ void __launch_bounds__(kPixels)
forward_tiles_kernel(const float* __restrict__ pairs,
                     const int* __restrict__ tile_start,
                     const int* __restrict__ tile_count,
                     float* __restrict__ out,
                     int ntx, int tiles_per_view) {
  __shared__ __align__(16) float coef[kBatch * kCoef];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int tv = t % tiles_per_view;
  const float ox = static_cast<float>((tv % ntx) * kTile);
  const float oy = static_cast<float>((tv / ntx) * kTile);
  const float X = static_cast<float>(p % kTile);
  const float Y = static_cast<float>(p / kTile);
  const float XX = X * X, XY = X * Y, YY = Y * Y;

  const int start = tile_start[t];
  const int count = tile_count[t];

  float Tf = 1.0f, Tr = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  bool live = true;  // this pixel still has Tf >= T_EPS

  for (int base = 0; base < count; base += kBatch) {
    // doubles as the barrier that protects `coef` from the previous batch
    if (__syncthreads_count(live) == 0) break;
    const int n = min(kBatch, count - base);
    for (int i = p; i < n; i += kPixels) {
      const float* row = pairs + static_cast<size_t>(start + base + i) * 16;
      const float4 f0 = *reinterpret_cast<const float4*>(row);      // mx my ca cb
      const float4 f1 = *reinterpret_cast<const float4*>(row + 4);  // cc r g b
      const float2 f2 = *reinterpret_cast<const float2*>(row + 8);  // opa depth
      const float ml = f0.x - ox, nl = f0.y - oy;
      const float ca = f0.z, cb = f0.w, cc = f1.x;
      // fixed rounding: __f*_rn is never contracted, fmaf always fused —
      // the order the plain version (and the JAX package's kernel on XLA's
      // CPU backend) uses; near a tile edge the terms cancel by 100x
      const float cbm = __fmul_rn(cb, ml);
      float* k = coef + i * kCoef;
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
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < n; ++j) {
      const float* k = coef + j * kCoef;
      float power = fmaf(k[1], X, k[0]);
      power = fmaf(k[2], Y, power);
      power = fmaf(k[3], XX, power);
      power = fmaf(k[4], XY, power);
      power = fmaf(k[5], YY, power);
      if (!(power <= kPowerEps)) continue;
      const float raw = k[6] * expf(fminf(power, 0.0f));
      if (!(raw >= kAlphaMin)) continue;
      const float alpha = fminf(raw, kAlphaMax);
      const float t_incl = Tf * (1.0f - alpha);
      if (t_incl >= kTEps) {
        const float w = alpha * Tf;
        acc_r += w * k[7];
        acc_g += w * k[8];
        acc_b += w * k[9];
        acc_d += w * k[10];
        Tr = t_incl;
      }
      Tf = t_incl;
      if (Tf < kTEps) {
        live = false;
        break;
      }
    }
  }

  float* o = out + static_cast<size_t>(t) * 8 * kPixels + p;
  o[0] = acc_r;
  o[kPixels] = acc_g;
  o[2 * kPixels] = acc_b;
  o[3 * kPixels] = acc_d;
  o[4 * kPixels] = 1.0f - Tr;
  o[5 * kPixels] = Tr;
  o[6 * kPixels] = 0.0f;
  o[7 * kPixels] = 0.0f;
}

}  // namespace

// Plain C entry point for ctypes. Launches on `stream`, does not
// synchronise, and returns cudaGetLastError() (0 on success).
extern "C" int forward_tiles_launch(const float* pairs, const int* tile_start,
                                    const int* tile_count, float* out,
                                    int n_programs, int ntx,
                                    int tiles_per_view, void* stream) {
  if (n_programs > 0) {
    forward_tiles_kernel<<<n_programs, kPixels, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        pairs, tile_start, tile_count, out, ntx, tiles_per_view);
  }
  return static_cast<int>(cudaGetLastError());
}
