// tile_common.cuh: what forward_tiles.cu and backward_tiles.cu share — the
// pixel layout, the compositing constants, the staging of a pair row (its
// tile-local exponent coefficients, computed with one fixed rounding so
// that backward_tiles replays forward_tiles' alpha bit for bit) and the
// exact per-warp cull.
//
// Pixel layout: one thread per pixel. A tile of side T (32 or 16: each
// kernel is instantiated for both, Tile<T> below) is cut into warp
// rectangles of 8 x 4 pixels, Q = T / 8 to a row: rectangle r covers
// columns 8 (r % Q) .. 8 (r % Q) + 7 and rows 4 (r / Q) .. 4 (r / Q) + 3,
// and lane l of its warp is the pixel (l % 8, l / 8) in it; 32 rectangles
// at T = 32, 8 at T = 16. A block covers whole rows of rectangles
// (forward_tiles: a band of the tile; backward_tiles: the tile).
//
// The cull. A tile is large next to most Gaussians: on the main path's
// streams most (pair, warp) slots hold no pixel with alpha > 0. Staging
// gives each pair row a 32-bit mask (its low 8 bits at T = 16), bit r
// clear when no pixel of
// rectangle r can reach the 1/255 alpha floor: the ellipse's minimum of
// q(d) = d^T C d over the rectangle (binning's _rect_min_q: 0 with the mean
// inside, else the least of the four edges' clamped minima) against
// 2 ln(255 opa) plus a slack. A warp evaluates a pair only where its bit is
// set, so the skip is warp-uniform, and every skipped (pair, pixel) has
// alpha == 0 in the kernels' own arithmetic: transmittance, outputs and
// backward_tiles' replay are unchanged. The slack (kCullAbs + kCullRel * S,
// S the magnitude of the expanded exponent's largest f32 terms) covers the
// rounding of both the exponent and the test; forward_tiles.py::cull_rects
// is the same rule in PyTorch, and tests/test_torch_raster_cull.py holds it
// to the kernels' alpha. A conic that is not positive-definite keeps every
// rectangle.
//
// What bounds both kernels on an H100 once the cull has removed the
// evaluations no exact kernel needs: the bytes (each live pair row read
// once, the [n, 8, T^2] tile buffers read or written once) and, in
// practice, the few segments of 30-45 k pairs whose tile's blocks run alone
// at the end of the grid, where the per-row staging (the cull's exact
// rectangle tests, once per row) sets the pace. Tensor cores do not fit: a
// (pair, pixel) step is an exp followed by a serial f32 transmittance
// update, and backward_tiles' moment sums cancel across pixels, so TF32 or
// bf16 products would miss its 1e-4 per-column tolerance.

#pragma once

#include <cuda_runtime.h>

namespace tiles {

constexpr int kRectW = 8, kRectH = 4;        // a warp's pixel rectangle
constexpr float kAlphaMin = 1.0f / 255.0f;
constexpr float kAlphaMax = 0.99f;
constexpr float kTEps = 1e-4f;
constexpr float kPowerEps = 1e-3f;
constexpr float kCullAbs = 1e-2f;            // forward_tiles.CULL_ABS
constexpr float kCullRel = 1e-5f;            // forward_tiles.CULL_REL
constexpr int kExactMax = 8;                 // forward_tiles.CULL_EXACT_MAX
constexpr unsigned kFull = 0xffffffffu;

// The geometry of a tile of side `kSide`.
template <int kSide>
struct Tile {
  static_assert(kSide == 16 || kSide == 32, "tile side 16 or 32");
  static constexpr int kPixels = kSide * kSide;
  static constexpr int kRectsX = kSide / kRectW;  // rectangles per row
  static constexpr int kRectsY = kSide / kRectH;  // rows of rectangles
  static constexpr int kRects = kRectsX * kRectsY;
  // the mask bits of every rectangle of the tile
  static constexpr unsigned kAll =
      kRects == 32 ? kFull : (1u << kRects) - 1u;

  // Tile-local pixel of lane `lane` in warp rectangle `rect`.
  static __device__ __forceinline__ int pixel_x(int rect, int lane) {
    return kRectW * (rect % kRectsX) + lane % kRectW;
  }
  static __device__ __forceinline__ int pixel_y(int rect, int lane) {
    return kRectH * (rect / kRectsX) + lane / kRectW;
  }
};

// A staged pair row, 16-byte aligned so the inner loop reads three float4.
struct __align__(16) Coef {
  float4 q0;  // c0, cx, cy, -a/2   (tile-local exponent coefficients)
  float4 q1;  // -b, -c/2, opacity, depth
  float4 q2;  // r, g, b, ml (mean x - tile origin x)
};

// The live fields of one row of the [budget, 16] pair stream (mean x,
// mean y, conic a, b, c, r, g, b, opacity, depth, 6 pad), as copied into
// shared memory a batch ahead of staging.
struct RawRow {
  float4 f0;  // mx my ca cb
  float4 f1;  // cc r g b
  float2 f2;  // opa depth
};

// Starts the asynchronous copy (cp.async, no registers held while it is in
// flight) of a pair row's 40 live bytes into `dst`; the same thread waits
// for it with wait_rows() before reading `dst`.
__device__ __forceinline__ void copy_row_async(RawRow* dst,
                                               const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
               :: "r"(d), "l"(src) : "memory");
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n"
               :: "r"(d + 16), "l"(src + 4) : "memory");
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n"
               :: "r"(d + 32), "l"(src + 8) : "memory");
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void wait_rows() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The tile-local exponent coefficients of a pair row for the tile at
// (ox, oy), with colour and depth.
__device__ __forceinline__ Coef coefficients(const RawRow& r, float ox,
                                             float oy) {
  const float ml = r.f0.x - ox, nl = r.f0.y - oy;
  const float ca = r.f0.z, cb = r.f0.w, cc = r.f1.x;
  Coef k;
  // fixed rounding: __f*_rn is never contracted, fmaf always fused — the
  // order the plain version (and the JAX package's kernel on XLA's CPU
  // backend) uses; near a tile edge the terms cancel by 100x
  const float cbm = __fmul_rn(cb, ml);
  k.q0.x = __fsub_rn(
      __fmul_rn(-0.5f, fmaf(__fmul_rn(ca, ml), ml,
                            __fmul_rn(__fmul_rn(cc, nl), nl))),
      __fmul_rn(cbm, nl));
  k.q0.y = fmaf(cb, nl, __fmul_rn(ca, ml));
  k.q0.z = fmaf(cc, nl, cbm);
  k.q0.w = -0.5f * ca;
  k.q1 = make_float4(-cb, -0.5f * cc, r.f2.x, r.f2.y);
  k.q2 = make_float4(r.f1.y, r.f1.z, r.f1.w, ml);
  return k;
}

// What the cull needs of a pair row, in the tile's frame.
struct Ellipse {
  float ml, nl;          // mean - tile origin
  float ca, cb, cc;      // the conic
  float sa, sc;          // -b / a, -b / c: where q is least along an edge
  float thresh;          // cull threshold on q
  bool every_rect;       // conic not positive-definite: keep every rectangle
};

template <int kSide>
__device__ __forceinline__ Ellipse ellipse(const RawRow& r, float ox,
                                           float oy) {
  Ellipse e;
  e.ml = r.f0.x - ox;
  e.nl = r.f0.y - oy;
  e.ca = r.f0.z;
  e.cb = r.f0.w;
  e.cc = r.f1.x;
  // the cull's own arithmetic may use the fast intrinsics: their errors
  // (~1e-6 relative) sit far inside its slack
  e.every_rect =
      !(e.ca > 0.0f && e.cc > 0.0f && e.ca * e.cc - e.cb * e.cb > 0.0f);
  const float mx = fabsf(e.ml) + kSide, my = fabsf(e.nl) + kSide;
  const float scale =
      e.ca * mx * mx + 2.0f * fabsf(e.cb) * mx * my + e.cc * my * my;
  e.thresh = 2.0f * __logf(255.0f * r.f2.x) + kCullAbs + kCullRel * scale;
  e.sa = __fdividef(-e.cb, e.ca);
  e.sc = __fdividef(-e.cb, e.cc);
  return e;
}

// The least of q over warp rectangle `rect` (0 with the mean inside).
template <int kSide>
__device__ __forceinline__ float rect_min_q(const Ellipse& s, int rect) {
  using G = Tile<kSide>;
  const float ml = s.ml, nl = s.nl, ca = s.ca, cb = s.cb, cc = s.cc;
  // the rectangle in d = pixel - mean
  const float x0 = static_cast<float>(kRectW * (rect % G::kRectsX)) - ml;
  const float x1 = x0 + (kRectW - 1.0f);
  const float y0 = static_cast<float>(kRectH * (rect / G::kRectsX)) - nl;
  const float y1 = y0 + (kRectH - 1.0f);
  if (x0 <= 0.0f && x1 >= 0.0f && y0 <= 0.0f && y1 >= 0.0f) return 0.0f;
  auto q = [&](float x, float y) {
    return (ca * x + 2.0f * cb * y) * x + cc * y * y;
  };
  auto at_x = [&](float x) {                 // x fixed, y free on the edge
    return q(x, fminf(fmaxf(s.sc * x, y0), y1));
  };
  auto at_y = [&](float y) {                 // y fixed, x free on the edge
    return q(fminf(fmaxf(s.sa * y, x0), x1), y);
  };
  return fminf(fminf(at_x(x0), at_x(x1)), fminf(at_y(y0), at_y(y1)));
}

// The cull mask of a pair row over the warp rectangles in `wanted`: bit r
// set unless no pixel of rectangle r can get alpha > 0. The rectangles
// that the ellipse's bounding box at the threshold touches are the
// candidates: the box is widened by 1% + 0.01 px (so f32 rounding cannot
// shrink it past the exact test's keeps) and not used for a nearly
// degenerate conic, whose determinant f32 does not resolve. Up to
// kExactMax candidates take the exact test; more (a large Gaussian, which
// reaches most of them anyway) are kept as they are, so that one lane's
// row cannot hold up its warp's staging. At T = 16 a tile has only 8
// rectangles, so every candidate takes the exact test.
template <int kSide>
__device__ __forceinline__ unsigned cull_bits(const Ellipse& s,
                                              unsigned wanted) {
  using G = Tile<kSide>;
  if (s.every_rect) return wanted;
  if (!(s.thresh >= 0.0f)) return 0u;          // q >= 0 everywhere
  unsigned cand = G::kAll;
  const float det = s.ca * s.cc - s.cb * s.cb;
  if (det > 1e-4f * s.ca * s.cc) {
    const float t = __fdividef(s.thresh, det);
    const float hx = sqrtf(t * s.cc) * 1.01f + 0.01f;
    const float hy = sqrtf(t * s.ca) * 1.01f + 0.01f;
    const float ml = s.ml, nl = s.nl;
    // rectangle columns i with [8 i, 8 i + 7] within [ml - hx, ml + hx],
    // rows j with [4 j, 4 j + 3] within [nl - hy, nl + hy]
    const int i0 = static_cast<int>(
        fmaxf(ceilf((ml - hx - (kRectW - 1.0f)) / kRectW), 0.0f));
    const int i1 = static_cast<int>(
        fminf(floorf((ml + hx) / kRectW), G::kRectsX - 1.0f));
    const int j0 = static_cast<int>(
        fmaxf(ceilf((nl - hy - (kRectH - 1.0f)) / kRectH), 0.0f));
    const int j1 = static_cast<int>(
        fminf(floorf((nl + hy) / kRectH), G::kRectsY - 1.0f));
    unsigned box = 0u;
    if (i0 <= i1) {
      const unsigned cols = ((2u << i1) - 1u) & ~((1u << i0) - 1u);
      for (int j = j0; j <= j1; ++j) box |= cols << (G::kRectsX * j);
    }
    cand = box;
  }
  if (__popc(cand) > kExactMax) return cand & wanted;
  cand &= wanted;
  unsigned bits = 0u;
  for (unsigned m = cand; m; m &= m - 1) {
    const int r = __ffs(m) - 1;
    if (rect_min_q<kSide>(s, r) <= s.thresh) bits |= 1u << r;
  }
  return bits;
}

// The tile-local exponent at pixel (X, Y): the coefficients' fused
// multiply-adds in the plain version's order.
__device__ __forceinline__ float exponent(const Coef& k, float X, float Y) {
  float power = fmaf(k.q0.y, X, k.q0.x);
  power = fmaf(k.q0.z, Y, power);
  power = fmaf(k.q0.w, X * X, power);
  power = fmaf(k.q1.x, X * Y, power);
  return fmaf(k.q1.y, Y * Y, power);
}

}  // namespace tiles
