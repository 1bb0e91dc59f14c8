// qk_norm_rope: the denoisers' per-head QK RMSNorm and RoPE in one launch.
// For every (item, token, head) row of q and of k of one or more streams:
// the RMS norm over the head's D values with its weight, then, for joined
// tokens from rope_from on, the interleaved-pair rotation against the f32
// RoPE tables; written in bf16 into a [B, S, H, D] buffer (the layout SDPA
// reads) at the stream's place in the joined sequence.
//
// Replaces no TPU kernel: the JAX package leaves the same chain to XLA
// (models/dit.py's RMSNormPerHead and apply_rope). The port's plain twin
// (sigman_release_torch/ops/qk_norm_rope.py::qk_norm_rope_plain) runs it as
// PyTorch ops on the card: a widening to f32, the square, the mean, the
// rsqrt, one or two multiplies, a cast, a stacked rotated copy, the two f32
// products against the tables, their sum, a cast and a torch.cat, each a
// full pass over q or k in device memory (~2.9 GB a tensor at the DiT's
// serving shape, against 142 MB to read and write it once).
//
// What it computes, with the plain twin's rounding at each step (explicit
// rounding intrinsics, so nvcc contracts nothing into an FMA), bit for bit
// what PyTorch computes on the card:
//   ms  = (sum over the row of fl(x * x)) * (1 / D), summed in the order of
//         torch's reduction kernel on the card (ATen's Reduce.cuh, as
//         torch 2.11 runs it on an H100: 32 threads a row, thread t adding
//         x[t]^2 + x[t + 32]^2 at D = 64 and x[4t..4t+3]^2 in turn at
//         D = 128, then a tree over the threads, halves first). A 1-bit
//         change of ms can move the norm's bf16 rounding, and the rotation
//         can cancel that into many ulps of a small output, so the kernel
//         keeps the order (Layout below);
//   r   = rsqrtf(ms + eps)                           (torch.rsqrt's own call)
//   DiT:  y = bf16(fl(fl(x * r) * w))                (weight in f32, one
//                                                     rounding to bf16)
//   FLUX: y = bf16(fl(bf16(fl(x * r)) * w))          (BFL's order: rounded,
//                                                     then the scale)
//   RoPE on (y0, y1) of a pair, tables c, s of row token - rope_from:
//     out0 = bf16(fl(fl(y0 * c0) + fl(-y1 * s0)))
//     out1 = bf16(fl(fl(y1 * c1) + fl(y0 * s1)))
// The weight is bf16 or f32 (a model run in bf16, or f32 weights under
// autocast); a bf16 weight widens exactly, so one path serves both.
//
// What bounds it on an H100: bytes. Each q and k value is read once and
// written once (2 B each way); the weights and the tables (0.5 MB for the
// DiT, 2 MB for FLUX) come from L2. The design, for that bound:
//   * one warp per (stream, item, token) of q or k; it walks the token's
//     heads, 4 (D = 64) or 2 (D = 128) at once, each on 8 or 16 lanes,
//     loading kHeads such steps before it computes, so each warp keeps
//     2 KB in flight;
//   * a lane holds 4 interleaved pairs of its row, so the rotation stays
//     in the lane's registers, and exactly two of torch's reduction
//     threads: its first level of the tree is the lane's own, shuffles
//     inside the row's lanes finish it (every lane ends with the same
//     sum). The token's table row and the lane's weights are read once
//     for all its heads;
//   * a stream's q and k are read in place through their strides (FLUX's
//     packed [B, L, 3, H, D] qkv), and every stream writes into the one
//     joined output, so no torch.cat is left for q and k.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;        // warps a block, one row of q or k each
constexpr int kHeads = 4;        // loads of a warp's rows ahead of compute
constexpr int kMaxSegments = 4;  // q and k of up to two streams
constexpr int kDesc = 8;         // int64 words describing one segment

struct Segment {
  const uint16_t* src;    // bf16 [B, tokens, H, D] through the strides
  uint16_t* dst;          // the joined [B, dst_tokens, H, D] output
  const void* weight;     // [D], bf16 or f32
  long long stride_b, stride_s, stride_h;  // elements
  long long row0;         // the segment's first row in the grid
  int tokens;             // tokens of the stream
  int dst_token0;         // its first token's place in the joined sequence
};

struct Params {
  Segment seg[kMaxSegments];
  const float* cos;       // [rows, D] f32, row = token - rope_from
  const float* sin;
  long long rows;         // rows of all segments
  int n_seg;
  int heads;
  int dst_tokens;
  int rope_from;
  float eps;
  int round_before_scale;
};

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

__device__ __forceinline__ uint32_t bf16_bits(float f) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16_rn(f)));
}

__device__ __forceinline__ float round_bf16(float f) {
  return __uint_as_float(bf16_bits(f) << 16);
}

__device__ __forceinline__ uint32_t ld32(const void* p) {
  return __ldg(static_cast<const unsigned int*>(p));
}

// the pair at element e of a [D] weight, widened to f32
template <typename W>
__device__ __forceinline__ float2 weight_pair(const void* w, int e) {
  if constexpr (sizeof(W) == 4) {
    return __ldg(static_cast<const float2*>(w) + e / 2);
  } else {
    const uint32_t raw = ld32(static_cast<const uint16_t*>(w) + e);
    return make_float2(lo_bf16(raw), hi_bf16(raw));
  }
}

// The lane's 4 interleaved pairs of a row and the sum of squares of a
// row, for each head dim, in the order of torch's reduction (see above).
// D = 64: 8 lanes a row; lane q holds the pairs q, q + 8, q + 16, q + 24,
// i.e. torch's threads 2q, 2q + 1, 2q + 16 and 2q + 17 (thread t sums
// x[t]^2 + x[t + 32]^2), so the tree's first level is the lane's own and
// three shuffles finish it.
// D = 128: 16 lanes a row; lane q holds the pairs 2q, 2q + 1, 2q + 32,
// 2q + 33, i.e. torch's threads q and q + 16 (thread t sums x[4t..4t+3]^2
// in turn: its load of 4 f32), so again the first level is the lane's own
// and four shuffles finish it.
template <int D>
struct Layout;

template <>
struct Layout<64> {
  static constexpr int kLanes = 8;  // lanes a row
  __device__ static int element(int q, int k) { return 2 * q + 16 * k; }
  __device__ static void load(const uint16_t* row, int q, uint32_t (&w)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = ld32(row + element(q, k));
  }
  __device__ static void store(uint16_t* row, int q, const uint32_t (&w)[4]) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<unsigned int*>(row + element(q, k)) = w[k];
  }
  __device__ static float sum_sq(const float (&x)[4][2]) {
    const float sq00 = __fmul_rn(x[0][0], x[0][0]);
    const float sq01 = __fmul_rn(x[0][1], x[0][1]);
    const float sq10 = __fmul_rn(x[1][0], x[1][0]);
    const float sq11 = __fmul_rn(x[1][1], x[1][1]);
    const float sq20 = __fmul_rn(x[2][0], x[2][0]);
    const float sq21 = __fmul_rn(x[2][1], x[2][1]);
    const float sq30 = __fmul_rn(x[3][0], x[3][0]);
    const float sq31 = __fmul_rn(x[3][1], x[3][1]);
    // threads 2q + 16 j + e: pairs j (e lo / hi) and j + 2 (32 further)
    float a = __fadd_rn(__fadd_rn(sq00, sq20), __fadd_rn(sq10, sq30));
    float b = __fadd_rn(__fadd_rn(sq01, sq21), __fadd_rn(sq11, sq31));
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) {
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
      b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, off));
    }
    return __fadd_rn(a, b);
  }
};

template <>
struct Layout<128> {
  static constexpr int kLanes = 16;
  __device__ static int element(int q, int k) {
    return 4 * q + 2 * (k & 1) + 64 * (k >> 1);
  }
  __device__ static void load(const uint16_t* row, int q, uint32_t (&w)[4]) {
#pragma unroll
    for (int k = 0; k < 4; k += 2) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(row + element(q, k)));
      w[k] = v.x;
      w[k + 1] = v.y;
    }
  }
  __device__ static void store(uint16_t* row, int q, const uint32_t (&w)[4]) {
#pragma unroll
    for (int k = 0; k < 4; k += 2)
      *reinterpret_cast<uint2*>(row + element(q, k)) =
          make_uint2(w[k], w[k + 1]);
  }
  __device__ static float sum_sq(const float (&x)[4][2]) {
    float part[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {  // threads q (j = 0) and q + 16
      float acc = __fmul_rn(x[2 * j][0], x[2 * j][0]);
      acc = __fadd_rn(acc, __fmul_rn(x[2 * j][1], x[2 * j][1]));
      acc = __fadd_rn(acc, __fmul_rn(x[2 * j + 1][0], x[2 * j + 1][0]));
      part[j] = __fadd_rn(acc, __fmul_rn(x[2 * j + 1][1], x[2 * j + 1][1]));
    }
    float ss = __fadd_rn(part[0], part[1]);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      ss = __fadd_rn(ss, __shfl_xor_sync(0xffffffffu, ss, off));
    return ss;
  }
};

// D the head dim; W the weight's type (uint16_t: bf16, float)
template <int D, typename W>
__global__ void __launch_bounds__(kWarps * 32)
    qk_norm_rope_kernel(const __grid_constant__ Params p) {
  using L = Layout<D>;
  constexpr int kRows = 32 / L::kLanes;  // heads a warp takes at once
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= p.rows) return;
  const int q = threadIdx.x & (L::kLanes - 1);
  const int sub = (threadIdx.x & 31) / L::kLanes;

  Segment sg = p.seg[0];
#pragma unroll
  for (int j = 1; j < kMaxSegments; ++j)
    if (j < p.n_seg && row >= p.seg[j].row0) sg = p.seg[j];
  const int r = static_cast<int>(row - sg.row0);
  const int b = r / sg.tokens;
  const int s = r - b * sg.tokens;
  const int t = sg.dst_token0 + s;       // the token in the joined sequence
  const bool rotate = t >= p.rope_from;  // warp-uniform

  float2 w[4], c[4], sn[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) w[k] = weight_pair<W>(sg.weight, L::element(q, k));
  if (rotate) {
    const size_t at = static_cast<size_t>(t - p.rope_from) * D;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      c[k] = __ldg(reinterpret_cast<const float2*>(p.cos + at + L::element(q, k)));
      sn[k] = __ldg(reinterpret_cast<const float2*>(p.sin + at + L::element(q, k)));
    }
  }
  const uint16_t* src = sg.src + b * sg.stride_b + s * sg.stride_s;
  uint16_t* dst = sg.dst + (static_cast<long long>(b) * p.dst_tokens + t) *
                               static_cast<long long>(p.heads) * D;

  for (int h0 = 0; h0 < p.heads; h0 += kRows * kHeads) {
    uint32_t raw[kHeads][4];
#pragma unroll
    for (int u = 0; u < kHeads; ++u) {
      const int h = h0 + kRows * u + sub;
      if (h < p.heads) {
        L::load(src + h * sg.stride_h, q, raw[u]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k) raw[u][k] = 0u;
      }
    }
#pragma unroll
    for (int u = 0; u < kHeads; ++u) {
      if (h0 + kRows * u >= p.heads) break;  // warp-uniform
      const int h = h0 + kRows * u + sub;    // past the last head: shuffles only
      float x[4][2];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k][0] = lo_bf16(raw[u][k]);
        x[k][1] = hi_bf16(raw[u][k]);
      }
      const float rr = rsqrtf(__fadd_rn(__fmul_rn(L::sum_sq(x), 1.0f / D), p.eps));
      if (h >= p.heads) continue;
      uint32_t out[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float wv[2] = {w[k].x, w[k].y};
        float y[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float n = __fmul_rn(x[k][e], rr);
          if (p.round_before_scale) n = round_bf16(n);
          y[e] = round_bf16(__fmul_rn(n, wv[e]));
        }
        float o0 = y[0], o1 = y[1];
        if (rotate) {
          o0 = __fadd_rn(__fmul_rn(y[0], c[k].x), __fmul_rn(-y[1], sn[k].x));
          o1 = __fadd_rn(__fmul_rn(y[1], c[k].y), __fmul_rn(y[0], sn[k].y));
        }
        out[k] = bf16_bits(o0) | (bf16_bits(o1) << 16);
      }
      L::store(dst + h * D, q, out);
    }
  }
}

template <int D, typename W>
void launch(const Params& p, cudaStream_t stream) {
  const long long blocks = (p.rows + kWarps - 1) / kWarps;
  qk_norm_rope_kernel<D, W>
      <<<static_cast<unsigned int>(blocks), kWarps * 32, 0, stream>>>(p);
}

}  // namespace

// Plain C entry point. desc holds kDesc int64 words a segment: src, dst,
// weight (device pointers), the source's item, token and head strides in
// elements, its tokens, and its first token's place in the joined output.
// Every segment shares batch, heads, head_dim (64 or 128) and the joined
// output's dst_tokens; cos and sin are f32 [dst_tokens - rope_from, D]
// (null when no token rotates). Launches on `stream`, does not
// synchronise, returns cudaGetLastError() (cudaErrorInvalidValue for what
// the kernel does not take).
extern "C" int qk_norm_rope_launch(const long long* desc, int n_seg,
                                   int batch, int heads, int head_dim,
                                   int dst_tokens, const float* cos,
                                   const float* sin, int rope_from,
                                   float eps, int round_before_scale,
                                   int weight_f32, void* stream) {
  if (n_seg < 1 || n_seg > kMaxSegments || batch < 0 || heads < 1 ||
      (head_dim != 64 && head_dim != 128))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  long long rows = 0;
  for (int i = 0; i < n_seg; ++i) {
    const long long* d = desc + kDesc * i;
    Segment& sg = p.seg[i];
    sg.src = reinterpret_cast<const uint16_t*>(d[0]);
    sg.dst = reinterpret_cast<uint16_t*>(d[1]);
    sg.weight = reinterpret_cast<const void*>(d[2]);
    sg.stride_b = d[3];
    sg.stride_s = d[4];
    sg.stride_h = d[5];
    sg.tokens = static_cast<int>(d[6]);
    sg.dst_token0 = static_cast<int>(d[7]);
    sg.row0 = rows;
    if (sg.tokens < 1) return static_cast<int>(cudaErrorInvalidValue);
    rows += static_cast<long long>(batch) * sg.tokens;
  }
  p.cos = cos;
  p.sin = sin;
  p.rows = rows;
  p.n_seg = n_seg;
  p.heads = heads;
  p.dst_tokens = dst_tokens;
  p.rope_from = rope_from;
  p.eps = eps;
  p.round_before_scale = round_before_scale;
  if (rows > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (head_dim == 64) {
      if (weight_f32) launch<64, float>(p, s);
      else launch<64, uint16_t>(p, s);
    } else {
      if (weight_f32) launch<128, float>(p, s);
      else launch<128, uint16_t>(p, s);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
