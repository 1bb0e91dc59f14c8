// ada_norm: the denoisers' AdaLN passes in one launch a pass. For every
// token row of one or two streams (the DiT's cond and image, FLUX's txt and
// img, or FLUX's joined sequence), optionally the gated residual add
//   x' = x + gate * y
// (y read in place from the attention's or feed-forward's output, gate the
// item's row of the modulation), and optionally the LayerNorm over D and
// the modulation of the (new) row
//   n = LN(x') * (1 + scale) + shift,
// written in bf16 at the stream's place in one joined [B, S, D] buffer or
// in a buffer of its own: the buffers the next GEMMs read.
//
// Replaces no TPU kernel: the JAX package leaves AdaLN to XLA
// (models/dit.py's AdaLNZero and DiTBlock). The port's plain twin
// (sigman_release_torch/ops/ada_norm.py::gated_residual_plain and
// norm_modulate_plain) runs it as PyTorch ops on the card: the layer norm,
// `1 + scale`, the product, the shift, the gated product, the residual sum
// and the torch.cat of the streams, each a pass over the sequence in device
// memory (~28 launches a DiT block).
//
// What it computes, with the plain twin's rounding at each step (explicit
// rounding intrinsics, so nvcc contracts nothing it should not), bit for bit
// what PyTorch computes on the card (the bf16-by-bf16 steps as bf16x2
// arithmetic: see add2):
//   gy = bf16(fl(gate * y));  x' = bf16(fl(x + gy))
//   LayerNorm as torch's vectorized_layer_norm_kernel computes it on the
//     card (torch 2.11, found by holding its mean against emulations): 128
//     threads a row (32 x 4), thread t holding the 4-value vectors t,
//     t + 128, ... of the row, a Welford update a value (mean += delta *
//     fl(1/k) and m2 += delta * (v - mean), each one FMA), the threads'
//     partials merged by a shuffle-down tree in each warp (offsets 16 .. 1),
//     then over the 4 warps (offsets 2, 1); var = m2 / D, rstd =
//     rsqrtf(var + eps). Every merge joins equal counts, so its weights are
//     exactly 1/2 and the merge is mean = (a + b) / 2, m2 = (m2a + m2b) +
//     fl(d * d * n) / 2.
//     ln = bf16(fl(rstd * fl(v - mean)))              (no affine: FLUX)
//     ln = bf16(fma(w, fl(rstd * fl(v - mean)), b))    (affine: the DiT)
//   t = bf16(fl(1 + scale));  n = bf16(fl(bf16(fl(ln * t)) + shift))
//
// What bounds it on an H100: bytes. Each row value is read once and each
// output written once, in 16-byte vectors (4 KB-6 KB a row); the
// modulation rows, gates and the norm's weights are per item and come from
// L1 / L2. The design, for that bound:
//   * one block of 64 threads a row; thread u holds torch's threads 2u and
//     2u + 1, i.e. the 8 values at 8u + 512 j for j < D / 512, so every
//     load and store is 16 bytes and the row stays in registers (as bf16:
//     x' is rounded to bf16 anyway) from the load through the statistics
//     to the writes; at 32-62 registers a thread, 16-32 rows are in flight
//     an SM (persistent variants that loaded the next row ahead in
//     registers, or three rows ahead through shared memory with cp.async,
//     were no faster on the H100);
//   * the bf16-by-bf16 steps run as bf16x2 instructions, the LayerNorm in
//     f32, so the arithmetic stays well under the bytes' time;
//   * torch's tree is kept: its shuffle offsets 16 .. 2 are offsets 8 .. 1
//     within 16 lanes here, its offset 1 the thread's own merge of its two
//     partials, and the 4 warp partials merge through shared memory (each
//     warp repeats that last merge, so one barrier a row suffices);
//   * streams are described by pointers and strides, so y is read from the
//     joined output at the stream's offset and the normalised rows land in
//     the joined buffer: no slice is copied and no torch.cat is left.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 64;      // threads a row (torch's 128, two each)
constexpr int kChunk = 512;       // values a pass of the row's 16-byte loads
constexpr int kTorchWarps = 4;    // warps of torch's block: 32 x 4 threads
constexpr int kMaxStreams = 2;
constexpr int kDesc = 19;         // int64 words describing one stream
constexpr uint32_t kOnes = 0x3f803f80u;  // bf16 (1, 1)

struct Stream {
  const uint16_t* x;      // [B, tokens, D] through the strides (elements)
  long long x_sb, x_ss;
  const uint16_t* y;      // the gated add's other operand, like x
  long long y_sb, y_ss;
  const uint16_t* gate;   // [B, 1, D]: row b at gate + b * gate_sb
  long long gate_sb;
  uint16_t* xo;           // x + gate * y, like x
  long long xo_sb, xo_ss;
  const uint16_t* shift;  // [B, 1, D]
  long long shift_sb;
  const uint16_t* scale;  // [B, 1, D]
  long long scale_sb;
  uint16_t* n;            // the modulated norm, like x (the joined buffer
  long long n_sb, n_ss;   //   at the stream's first token)
  long long row0;         // the stream's first row in the grid
  int tokens;
};

struct Params {
  Stream st[kMaxStreams];
  const uint16_t* weight;  // [D] bf16 or null (no affine)
  const uint16_t* bias;    // [D] bf16 or null
  int n_streams;
  float eps;
};

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}

__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// value e (0 .. 7) of a 16-byte vector of bf16
__device__ __forceinline__ float at(const uint4& raw, int e) {
  const uint32_t w = e < 2 ? raw.x : e < 4 ? raw.y : e < 6 ? raw.z : raw.w;
  return (e & 1) ? hi_bf16(w) : lo_bf16(w);
}

__device__ __forceinline__ uint32_t word(const uint4& raw, int i) {
  return i == 0 ? raw.x : i == 1 ? raw.y : i == 2 ? raw.z : raw.w;
}

__device__ __forceinline__ __nv_bfloat162 pair(uint32_t w) {
  __nv_bfloat162 v;
  memcpy(&v, &w, 4);
  return v;
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  uint32_t w;
  memcpy(&w, &v, 4);
  return w;
}

// Two bf16 values' sum or product, rounded once (the _rn forms contract
// nothing into an FMA). For bf16 operands the sum and the product are
// exact in f32, or (a sum whose exponents differ by more than 16) rounded
// to the larger operand either way, so this equals PyTorch's f32 op
// rounded to bf16.
__device__ __forceinline__ uint32_t add2(uint32_t a, uint32_t b) {
  return bits(__hadd2_rn(pair(a), pair(b)));
}

__device__ __forceinline__ uint32_t mul2(uint32_t a, uint32_t b) {
  return bits(__hmul2_rn(pair(a), pair(b)));
}

// a row read once: streamed, kept out of L1
__device__ __forceinline__ uint4 ld_stream(const uint16_t* p) {
  return __ldcs(reinterpret_cast<const uint4*>(p));
}

// a per-item row (modulation, gate, weights) read by every token of the item
__device__ __forceinline__ uint4 ld_item(const uint16_t* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// torch's cuWelfordCombine of two partials of n values each (its weights
// n / 2n are exactly 1/2 for every count here)
__device__ __forceinline__ void merge(float& mean, float& m2, float mean_b,
                                      float m2_b, float n) {
  const float delta = __fsub_rn(mean, mean_b);
  mean = __fmul_rn(__fadd_rn(mean, mean_b), 0.5f);
  m2 = __fadd_rn(__fadd_rn(m2_b, m2),
                 __fmul_rn(__fmul_rn(__fmul_rn(delta, delta), n), 0.5f));
}

// kGated: x' = x + gate * y written to xo; kNorm: the modulated norm of x'
// (or of x) written to n. D is 2048 or 3072. One block a row.
template <int D, bool kGated, bool kNorm>
__global__ void __launch_bounds__(kThreads)
    ada_norm_kernel(const __grid_constant__ Params p) {
  constexpr int J = D / kChunk;  // 16-byte vectors a thread
  __shared__ float s_mean[kTorchWarps], s_m2[kTorchWarps];

  const int u = threadIdx.x;
  const Stream& sg =
      (p.n_streams > 1 && blockIdx.x >= p.st[1].row0) ? p.st[1] : p.st[0];
  const int r = static_cast<int>(blockIdx.x - sg.row0);
  const int b = r / sg.tokens;
  const int s = r - b * sg.tokens;

  uint4 x[J];
  const uint16_t* xr = sg.x + b * sg.x_sb + s * sg.x_ss + 8 * u;
#pragma unroll
  for (int j = 0; j < J; ++j) x[j] = ld_stream(xr + j * kChunk);
  if constexpr (kGated) {
    uint4 y[J];
    const uint16_t* yr = sg.y + b * sg.y_sb + s * sg.y_ss + 8 * u;
#pragma unroll
    for (int j = 0; j < J; ++j) y[j] = ld_stream(yr + j * kChunk);
    const uint16_t* gr = sg.gate + b * sg.gate_sb + 8 * u;
    uint16_t* xo = sg.xo + b * sg.xo_sb + s * sg.xo_ss + 8 * u;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const uint4 g = ld_item(gr + j * kChunk);
      x[j] = make_uint4(add2(x[j].x, mul2(g.x, y[j].x)),
                        add2(x[j].y, mul2(g.y, y[j].y)),
                        add2(x[j].z, mul2(g.z, y[j].z)),
                        add2(x[j].w, mul2(g.w, y[j].w)));
      *reinterpret_cast<uint4*>(xo + j * kChunk) = x[j];
    }
  }
  if constexpr (kNorm) {
    // statistics in torch's order: torch thread 2u + h holds values
    // 4h .. 4h + 3 of each of the thread's vectors, in turn
    float mean[2], m2[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mean[h] = 0.0f;
      m2[h] = 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float val = at(x[j], 4 * h + e);
          const float k = static_cast<float>(4 * j + e + 1);
          const float delta = __fsub_rn(val, mean[h]);
          mean[h] = __fmaf_rn(delta, 1.0f / k, mean[h]);
          m2[h] = __fmaf_rn(delta, __fsub_rn(val, mean[h]), m2[h]);
        }
      }
    }
    // torch's shuffle offsets 16, 8, 4, 2: lanes 8, 4, 2, 1 within 16 here
    float count = static_cast<float>(4 * J);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float mb = __shfl_down_sync(0xffffffffu, mean[h], off, 16);
        const float m2b = __shfl_down_sync(0xffffffffu, m2[h], off, 16);
        merge(mean[h], m2[h], mb, m2b, count);
      }
      count *= 2.0f;
    }
    merge(mean[0], m2[0], mean[1], m2[1], count);  // torch's offset 1
    count *= 2.0f;
    if ((u & 15) == 0) {
      s_mean[u >> 4] = mean[0];
      s_m2[u >> 4] = m2[0];
    }
    __syncthreads();
    // torch's warps merge at offsets 2, 1; every warp repeats it
    const int lane = u & 31;
    float wm = s_mean[lane & (kTorchWarps - 1)];
    float wm2 = s_m2[lane & (kTorchWarps - 1)];
#pragma unroll
    for (int off = kTorchWarps / 2; off > 0; off >>= 1) {
      const float mb = __shfl_down_sync(0xffffffffu, wm, off, kTorchWarps);
      const float m2b = __shfl_down_sync(0xffffffffu, wm2, off, kTorchWarps);
      merge(wm, wm2, mb, m2b, count);
      count *= 2.0f;
    }
    const float mu = __shfl_sync(0xffffffffu, wm, 0);
    const float rstd = rsqrtf(__fadd_rn(
        __fdiv_rn(__shfl_sync(0xffffffffu, wm2, 0), static_cast<float>(D)),
        p.eps));

    // the modulated norm
    const uint16_t* shr = sg.shift + b * sg.shift_sb + 8 * u;
    const uint16_t* scr = sg.scale + b * sg.scale_sb + 8 * u;
    uint16_t* nr = sg.n + b * sg.n_sb + s * sg.n_ss + 8 * u;
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const uint4 sh = ld_item(shr + j * kChunk);
      const uint4 sc = ld_item(scr + j * kChunk);
      uint4 w = make_uint4(0, 0, 0, 0), bi = w;
      if (p.weight != nullptr) {
        w = ld_item(p.weight + 8 * u + j * kChunk);
        bi = ld_item(p.bias + 8 * u + j * kChunk);
      }
      uint32_t out[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float ln[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          ln[e] = __fmul_rn(rstd, __fsub_rn(at(x[j], 2 * i + e), mu));
          if (p.weight != nullptr)
            ln[e] = __fmaf_rn(at(w, 2 * i + e), ln[e], at(bi, 2 * i + e));
        }
        const uint32_t t = add2(kOnes, word(sc, i));
        out[i] = add2(mul2(bits(__floats2bfloat162_rn(ln[0], ln[1])), t),
                      word(sh, i));
      }
      *reinterpret_cast<uint4*>(nr + j * kChunk) =
          make_uint4(out[0], out[1], out[2], out[3]);
    }
  }
}

template <int D, bool kGated, bool kNorm>
void launch(const Params& p, long long rows, cudaStream_t stream) {
  ada_norm_kernel<D, kGated, kNorm>
      <<<static_cast<unsigned int>(rows), kThreads, 0, stream>>>(p);
}

template <int D>
void launch_mode(const Params& p, long long rows, int gated, int norm,
                 cudaStream_t stream) {
  if (gated && norm) launch<D, true, true>(p, rows, stream);
  else if (gated) launch<D, true, false>(p, rows, stream);
  else launch<D, false, true>(p, rows, stream);
}

}  // namespace

// Plain C entry point. desc holds kDesc int64 words a stream: x, its item
// and token strides; y, strides; gate, item stride; xo, strides; shift,
// item stride; scale, item stride; n, strides; tokens (pointers are device
// addresses of bf16 values, strides in elements; what a mode does not use
// may be 0). gated: x' = x + gate * y into xo; norm: the modulated LayerNorm
// of x' (or x) into n, with weight and bias ([D] bf16, both or neither) and
// eps. dim is 2048 or 3072, every row 16-byte aligned. Launches on
// `stream`, does not synchronise, returns cudaGetLastError()
// (cudaErrorInvalidValue for what the kernel does not take).
extern "C" int ada_norm_launch(const long long* desc, int n_streams,
                               int batch, int dim, int gated, int norm,
                               const void* weight, const void* bias,
                               float eps, void* stream) {
  if (n_streams < 1 || n_streams > kMaxStreams || batch < 0 ||
      (dim != 2048 && dim != 3072) || !(gated || norm) ||
      ((weight == nullptr) != (bias == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  long long rows = 0;
  for (int i = 0; i < n_streams; ++i) {
    const long long* d = desc + kDesc * i;
    Stream& sg = p.st[i];
    sg.x = reinterpret_cast<const uint16_t*>(d[0]);
    sg.x_sb = d[1];
    sg.x_ss = d[2];
    sg.y = reinterpret_cast<const uint16_t*>(d[3]);
    sg.y_sb = d[4];
    sg.y_ss = d[5];
    sg.gate = reinterpret_cast<const uint16_t*>(d[6]);
    sg.gate_sb = d[7];
    sg.xo = reinterpret_cast<uint16_t*>(d[8]);
    sg.xo_sb = d[9];
    sg.xo_ss = d[10];
    sg.shift = reinterpret_cast<const uint16_t*>(d[11]);
    sg.shift_sb = d[12];
    sg.scale = reinterpret_cast<const uint16_t*>(d[13]);
    sg.scale_sb = d[14];
    sg.n = reinterpret_cast<uint16_t*>(d[15]);
    sg.n_sb = d[16];
    sg.n_ss = d[17];
    sg.tokens = static_cast<int>(d[18]);
    sg.row0 = rows;
    if (sg.tokens < 1) return static_cast<int>(cudaErrorInvalidValue);
    rows += static_cast<long long>(batch) * sg.tokens;
  }
  p.weight = static_cast<const uint16_t*>(weight);
  p.bias = static_cast<const uint16_t*>(bias);
  p.n_streams = n_streams;
  p.eps = eps;
  if (rows > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (dim == 2048) launch_mode<2048>(p, rows, gated, norm, s);
    else launch_mode<3072>(p, rows, gated, norm, s);
  }
  return static_cast<int>(cudaGetLastError());
}
