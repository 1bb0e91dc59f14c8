// mean_knn_dist2: the renderer's KNN base scale. For every point of every
// item of a [B, N, 3] f32 batch, the mean squared distance to its 3 nearest
// other points (the reference's simple_knn distCUDA2), in one launch.
//
// Replaces no TPU kernel: the JAX package computes the same function in
// plain XLA (ops/knn.py::mean_knn_dist2, a blocked matmul and top_k). The
// port's plain version (sigman_release_torch/ops/knn.py) does the same in
// PyTorch: per block of 4096 queries a [4096, N] f32 distance table through
// an f32 GEMM and elementwise passes, then a radix top-4 of every row.
//
// What it computes, per query q of an item, over all N points p of the same
// item (q itself included, as in the plain version's top-k):
//   d(q, p) = (|q|^2 - 2 q.p) + |p|^2, with the plain version's rounding:
//     |x|^2 = (x0^2 + x2^2) + x1^2   (torch.sum(x * x, -1) on the card: the
//                                      reduction gives two threads to a row
//                                      of three, (x0 + x2) and x1)
//     q.p   = fma(q2, p2, fma(q1, p1, q0 p0))   (the f32 GEMM's FMA chain)
//     |q|^2 - 2 q.p as one rounding (2 q.p is exact), then + |p|^2
//   the 4 smallest d, sorted; c1..c3 = max(d1..d3, 0) (d0 is q itself)
//   out = ((c1 + c3) + c2) * fl(1/3)   (torch.mean on the card: the same
//                                       two-thread sum, times 1/N)
// Every step is an explicit-rounding intrinsic, so nvcc contracts nothing.
// Direct differences (q - p)^2 would be more exact, and would change the
// answer the plain version (and the benchmark's reference) gives.
//
// What bounds it on an H100: f32 issue. There are B N^2 pair tests, each
// five f32 instructions (one multiply and two FMAs for the dot product, the
// FMA and the add of the expansion) and one compare; nothing has to reach
// device memory but the points (read once per block, from L2) and one f32
// a query. At B = 8, N = 99,999: 8.0e10 pairs, 4.0e11 f32 instructions,
// 12 ms at the published 67 TFLOP/s (132 SMs x 128 lanes at 1.98 GHz), 13.5
// ms at a sustained 1.75 GHz: 1.5-1.7 ms an item. The design, for that
// bound:
//   * a thread holds kQueries queries in registers, with |q|^2 and their
//     sorted 4 smallest d; each staged point is one float4 (x, y, z, |p|^2)
//     read from shared memory as a broadcast and tested against all of
//     them, so a load feeds kQueries pair tests;
//   * the 4 smallest stay sorted in registers. A thread tests kGroup points,
//     takes the least of their d per query (3 FMNMX) and branches only if it
//     beats the 4th smallest; the insertion then runs per point. A query
//     inserts ~4 ln N (~46) times out of N = 1e5, so per pair the branch
//     costs ~(3 + 2) / kGroup instructions, not a compare and a branch;
//   * a block stages the item's points kThreads at a time, one a thread,
//     double-buffered: the next batch's point is read from global memory
//     into registers before the current batch is tested and stored (with
//     its |p|^2, which a copy could not form) after, so one barrier a batch
//     and no load on the test's path. Points past N stage as |p|^2 = +inf,
//     which no test takes;
//   * the grid is (query tiles of kThreads x kQueries, B): 98 blocks an
//     item at N = 99,999, 784 for a batch of 8, each as much work as any
//     other, so the issue rate, not the tail, sets the time.
// No distance table is written and nothing is sorted: the only output is
// one f32 a query.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // threads a block; points staged a batch
constexpr int kQueries = 4;    // queries a thread
constexpr int kGroup = 4;      // points tested between two branches

__device__ __forceinline__ float sum_sq(float x, float y, float z) {
  return __fadd_rn(__fadd_rn(__fmul_rn(x, x), __fmul_rn(z, z)),
                   __fmul_rn(y, y));
}

__device__ __forceinline__ float pair_d2(float qx, float qy, float qz,
                                         float q2, float4 p) {
  const float dot =
      __fmaf_rn(qz, p.z, __fmaf_rn(qy, p.y, __fmul_rn(qx, p.x)));
  return __fadd_rn(__fmaf_rn(-2.0f, dot, q2), p.w);
}

// b[0] <= b[1] <= b[2] <= b[3]: the 4 smallest so far. Exact (min / max).
__device__ __forceinline__ void insert(float d, float (&b)[4]) {
  if (d < b[3]) {
    const float b3 = fmaxf(b[2], d);
    const float b2 = fmaxf(b[1], fminf(b[2], d));
    const float b1 = fmaxf(b[0], fminf(b[1], d));
    b[0] = fminf(b[0], d);
    b[1] = b1;
    b[2] = b2;
    b[3] = b3;
  }
}

__device__ __forceinline__ float4 stage(const float* __restrict__ item,
                                        int j, int n) {
  if (j >= n) return make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000));
  const float x = item[3 * static_cast<size_t>(j)];
  const float y = item[3 * static_cast<size_t>(j) + 1];
  const float z = item[3 * static_cast<size_t>(j) + 2];
  return make_float4(x, y, z, sum_sq(x, y, z));
}

__global__ void __launch_bounds__(kThreads)
    mean_knn_dist2_kernel(const float* __restrict__ points,
                          float* __restrict__ out, int n) {
  __shared__ float4 staged[2][kThreads];
  const float* item = points + static_cast<size_t>(blockIdx.y) * n * 3;
  const int first = blockIdx.x * kThreads * kQueries + threadIdx.x;

  float qx[kQueries], qy[kQueries], qz[kQueries], q2[kQueries];
  float best[kQueries][4];
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    const float4 q = stage(item, min(first + k * kThreads, n - 1), n);
    qx[k] = q.x;
    qy[k] = q.y;
    qz[k] = q.z;
    q2[k] = q.w;
#pragma unroll
    for (int r = 0; r < 4; ++r) best[k][r] = __int_as_float(0x7f800000);
  }

  staged[0][threadIdx.x] = stage(item, threadIdx.x, n);
  __syncthreads();
  int buf = 0;
  for (int start = 0; start < n; start += kThreads) {
    // the next batch's point: read now, stored after the tests
    const int j = start + kThreads + threadIdx.x;
    float nx = 0.0f, ny = 0.0f, nz = 0.0f;
    if (j < n) {
      nx = item[3 * static_cast<size_t>(j)];
      ny = item[3 * static_cast<size_t>(j) + 1];
      nz = item[3 * static_cast<size_t>(j) + 2];
    }
    const float4* cur = staged[buf];
#pragma unroll 2
    for (int s = 0; s < kThreads; s += kGroup) {
      float4 p[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) p[g] = cur[s + g];
#pragma unroll
      for (int k = 0; k < kQueries; ++k) {
        float d[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          d[g] = pair_d2(qx[k], qy[k], qz[k], q2[k], p[g]);
        const float least = fminf(fminf(d[0], d[1]), fminf(d[2], d[3]));
        if (least < best[k][3]) {
#pragma unroll
          for (int g = 0; g < kGroup; ++g) insert(d[g], best[k]);
        }
      }
    }
    staged[buf ^ 1][threadIdx.x] =
        j < n ? make_float4(nx, ny, nz, sum_sq(nx, ny, nz))
              : make_float4(0.0f, 0.0f, 0.0f, __int_as_float(0x7f800000));
    __syncthreads();
    buf ^= 1;
  }

  float* item_out = out + static_cast<size_t>(blockIdx.y) * n;
#pragma unroll
  for (int k = 0; k < kQueries; ++k) {
    const int i = first + k * kThreads;
    if (i < n) {
      const float c1 = best[k][1] > 0.0f ? best[k][1] : 0.0f;
      const float c2 = best[k][2] > 0.0f ? best[k][2] : 0.0f;
      const float c3 = best[k][3] > 0.0f ? best[k][3] : 0.0f;
      item_out[i] = __fmul_rn(__fadd_rn(__fadd_rn(c1, c3), c2), 1.0f / 3.0f);
    }
  }
}

}  // namespace

// Plain C entry point: points [batch, n, 3] f32 contiguous, out [batch, n]
// f32. Launches on `stream`, does not synchronise, returns
// cudaGetLastError() (cudaErrorInvalidValue for n < 4 or a batch over the
// grid's 65,535).
extern "C" int mean_knn_dist2_launch(const float* points, float* out,
                                     int batch, int n, void* stream) {
  if (n < 4 || batch > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0) {
    const dim3 grid((n + kThreads * kQueries - 1) / (kThreads * kQueries),
                    batch);
    mean_knn_dist2_kernel<<<grid, kThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(points, out,
                                                                 n);
  }
  return static_cast<int>(cudaGetLastError());
}
