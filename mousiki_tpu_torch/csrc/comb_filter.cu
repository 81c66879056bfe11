// The CELT synthesis postfilter's comb filter for Hopper (sm_90a):
// comb_filter_kernel, in place over buf[..., pos:pos + N] of the (S, C, L)
// float32 decode memory.
//
//   y[j] = x[j] + sum of ten taps: x[j - t0 + o] * (1 - f(j)) * g0 * c0[|o|]
//          and x[j - t1 + o] * f(j) * g1 * c1[|o|], o in (0, +1, -1, +2, -2)
//
// with f the window's square over the blend region (none where the old and
// new filters are the same) and 1 after it, where the filter stops when
// g1 is 0; a row whose g0 and g1 are both 0 is left as it is.
//
// Replaces a loop that XLA compiled in the reference, which has no Pallas
// kernel: the fori_loop over chunks of 13 samples of
// synthesis_jax.comb_filter_batched (mousiki_tpu/ops/synthesis_jax.py:181,
// loop :240). Its plain version, ops/synthesis.comb_filter_batched_reference,
// is that loop in eager PyTorch.
//
// What bounds it: the recursion, a row's chain of chunks (rows run at once,
// 512 of them at S = 256 fill the card in one wave, so one row's chain is
// the launch's time). The reference's chunk of 13 is the shortest lag any
// row can have (periods are clamped to at least 15, taps reach 2 back),
// but a row's recursion only forbids a chunk longer than its own shortest
// lag, min(t0, t1) - 2: a chunk that short reads only outputs of earlier
// chunks, so each sample is computed from the same inputs by the same
// operations whatever the chunk. So a row's chunk is min(t0, t1) - 2 (both
// periods, even where a gain is 0: the plain version reads those taps too,
// times a zero weight), capped by the row's lanes (kRowLanes: four warps,
// since most rows' periods are 130 or more); 13, the plain version's,
// where a period under 15 leaves less. A row whose chunk fits a warp runs
// its chunks on its first warp (a __syncwarp a chunk), a longer one on
// all four (a named barrier of the row's warps a chunk). The row's span
// [pos - max lag, pos + N) sits in shared memory, read by its 128 lanes
// with eight loads in flight each, and the window's squares beside it, so
// a chunk waits on shared memory only. Rows stand alone (no sum
// across streams), so a stream's output does not depend on the batch.
//
// Arithmetic is the plain version's, in float32, one rounding an
// operation (no contraction): each weight (1 - f) * (c * g0) or
// f * (c * g1), each tap times its weight, the ten products summed in
// order (lag t0's taps at offsets 0, +1, -1, +2, -2, then lag t1's), then
// added to x.

#include <cuda_runtime.h>
#include <stdint.h>

// One per-stream parameter plane: its device pointer and the elements from
// one stream to the next (a column of a wider plane is taken as it is).
template <typename T>
struct Plane {
  const T* data;
  int64_t stride;
  __device__ T at(int s) const { return data[s * stride]; }
};

// The six (S,) parameter planes, in the wrapper's order.
struct CombPlanes {
  Plane<int32_t> t0, t1;
  Plane<float> g0, g1;
  Plane<int32_t> tap0, tap1;
};

namespace {

constexpr int kOverlap = 120;
// the plain version's chunk, the shortest lag a row can have
constexpr int kChunk = 13;
constexpr int kRowWarps = 4;
constexpr int kRowLanes = 32 * kRowWarps;
constexpr int kRowsPerBlock = 2;
constexpr int kThreads = kRowLanes * kRowsPerBlock;
__constant__ int kTapCol[5] = {0, 1, 1, 2, 2};
__constant__ int kTapOff[5] = {0, 1, -1, 2, -2};

// the row's warps meet (barrier `id`, one a row of the block; 0 is
// __syncthreads')
__device__ void row_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kRowLanes) : "memory");
}

// dst[i] = src[i] for i < n, by `count` threads, this one starting at
// `first`: eight loads in flight a thread, not one a trip of the loop.
template <typename T>
__device__ void copy_in(T* dst, const T* __restrict__ src, int n, int first,
                        int count) {
  for (int base = first; base < n; base += 8 * count) {
    T v[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (base + k * count < n) v[k] = src[base + k * count];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      if (base + k * count < n) dst[base + k * count] = v[k];
  }
}

__global__ void __launch_bounds__(kThreads)
comb_filter_kernel(float* __restrict__ buf, const float* __restrict__ window,
                   const float* __restrict__ gains, const CombPlanes P,
                   int rows, int C, int L, int pos, int N, int span) {
  extern __shared__ float smem[];
  __shared__ float wsq_rows[kRowsPerBlock][kOverlap];
  const int t = threadIdx.x % kRowLanes;
  const int slot = threadIdx.x / kRowLanes;
  const int row = blockIdx.x * kRowsPerBlock + slot;
  if (row >= rows) return;   // all of the row's warps
  const int s = row / C;
  const float g0 = P.g0.at(s), g1 = P.g1.at(s);
  if (g0 == 0.f && g1 == 0.f) return;
  const int t0 = P.t0.at(s), t1 = P.t1.at(s);
  const int tap0 = P.tap0.at(s), tap1 = P.tap1.at(s);
  const bool same = g0 == g1 && t0 == t1 && tap0 == tap1;
  const int ov = same ? 0 : kOverlap;
  // the taps' weights apart from the window: gains[tap] * g
  float tg[10];
  for (int k = 0; k < 5; ++k) {
    tg[k] = __fmul_rn(gains[3 * tap0 + kTapCol[k]], g0);
    tg[5 + k] = __fmul_rn(gains[3 * tap1 + kTapCol[k]], g1);
  }
  int lag[10];
  for (int k = 0; k < 5; ++k) {
    lag[k] = t0 - kTapOff[k];
    lag[5 + k] = t1 - kTapOff[k];
  }
  // the row's span in shared memory: x[lo .. pos + N), lo the furthest
  // tap back
  const int reach = max(t0, t1) + 2;
  const int lo = max(pos - reach, 0);
  const int len = pos + N - lo;
  float* x = smem + slot * span;
  float* g = buf + static_cast<size_t>(row) * L;
  // the window's squares, a row's copy (a row the filter skips stages
  // nothing)
  float* wsq = wsq_rows[slot];
  for (int i = t; i < ov; i += kRowLanes)
    wsq[i] = __fmul_rn(window[i], window[i]);
  copy_in(x, g + lo, len, t, kRowLanes);
  const int bar = 1 + slot;
  row_sync(bar);
  const int first = pos - lo;   // x index of sample 0
  // after the blend region the filter stops where g1 is 0
  const int n_on = g1 != 0.f ? N : min(N, ov);
  // the shortest lag bounds the chunk; under kChunk (a period under 15)
  // the plain version's chunk, whose taps may reach its own samples
  const int shortest = min(t0, t1) - 2;
  const int chunk = shortest < kChunk ? kChunk : min(shortest, kRowLanes);
  const bool one_warp = chunk <= 32;
  if (t < (one_warp ? 32 : kRowLanes)) {
    for (int c0 = 0; c0 < n_on; c0 += chunk) {
      const int rel = c0 + t;
      const bool on = t < chunk && rel < n_on;
      float y = 0.f;
      if (on) {
        const float f = rel < ov ? wsq[rel] : 1.f;
        const float omf = __fsub_rn(1.f, f);
        float acc = 0.f;
#pragma unroll
        for (int k = 0; k < 10; ++k) {
          const int at = min(max(first + rel - lag[k], 0), len - 1);
          const float w = __fmul_rn(k < 5 ? omf : f, tg[k]);
          acc = __fadd_rn(acc, __fmul_rn(x[at], w));
        }
        y = __fadd_rn(x[first + rel], acc);
      }
      // a chunk longer than the shortest lag reads its own samples: all
      // its taps are read before any sample is written, as in the plain
      // version
      if (chunk > shortest) __syncwarp();
      if (on) x[first + rel] = y;
      if (one_warp)
        __syncwarp();
      else
        row_sync(bar);
    }
  }
  row_sync(bar);
  for (int i = first + t; i < first + n_on; i += kRowLanes) g[lo + i] = x[i];
}

}  // namespace

// buf: (rows / C, C, L) float32, contiguous, updated in place over [pos,
// pos + N); window (120,), gains (3, 3) float32; planes (a host struct,
// copied into the launch): t0, t1, tap0, tap1 int32 and g0, g1 float32, a
// value a stream. Launches four warps a row on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// it does not take.
extern "C" int mousiki_comb_filter(float* buf, const float* window,
                                   const float* gains,
                                   const CombPlanes* planes, int rows, int C,
                                   int L, int pos, int N, void* stream) {
  if (rows <= 0 || C < 1 || N < 1 || pos < 0 || pos + N > L)
    return static_cast<int>(cudaErrorInvalidValue);
  // a row's span is at most pos + N values
  const int span = pos + N;
  const size_t bytes = sizeof(float) * kRowsPerBlock * span;
  if (bytes > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        comb_filter_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  const int blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  comb_filter_kernel<<<blocks, kThreads, bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      buf, window, gains, *planes, rows, C, L, pos, N, span);
  return static_cast<int>(cudaGetLastError());
}
