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
// is that loop in eager PyTorch: 272 launches a call at N = 840, 544 a
// stereo CELT step.
//
// What bounds it: the recursion. Every lag is at least 13 (the callers
// clamp periods to at least 15, taps reach 2 back), so a chunk of 13
// samples reads only outputs of earlier chunks, and the chunks of a row
// run one after another. One warp a (stream, channel) row: the row's span
// [pos - max lag, pos + N) in shared memory (read with eight loads in
// flight a lane), its chunks in order, the 13 samples of a chunk on 13
// lanes; then the span written back. Rows stand alone (no sum across
// streams), so a stream's output does not depend on the batch.
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
constexpr int kChunk = 13;
constexpr int kRowsPerBlock = 4;
constexpr int kThreads = 32 * kRowsPerBlock;
__constant__ int kTapCol[5] = {0, 1, 1, 2, 2};
__constant__ int kTapOff[5] = {0, 1, -1, 2, -2};

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
  const int lane = threadIdx.x % 32;
  const int slot = threadIdx.x / 32;
  const int row = blockIdx.x * kRowsPerBlock + slot;
  if (row >= rows) return;   // a whole warp
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
  copy_in(x, g + lo, len, lane, 32);
  __syncwarp();
  const int first = pos - lo;   // x index of sample 0
  for (int c0 = 0; c0 < N; c0 += kChunk) {
    const int rel = c0 + lane;
    // a chunk reads before any of its samples is written, as the plain
    // version gathers a chunk's taps before it stores the chunk
    const bool on = lane < kChunk && rel < N && (rel < ov || g1 != 0.f);
    float y = 0.f;
    if (on) {
      const float f = rel < ov ? __fmul_rn(window[rel], window[rel]) : 1.f;
      const float omf = __fsub_rn(1.f, f);
      float acc = 0.f;
      for (int k = 0; k < 10; ++k) {
        const int at = min(max(first + rel - lag[k], 0), len - 1);
        const float w = __fmul_rn(k < 5 ? omf : f, tg[k]);
        acc = __fadd_rn(acc, __fmul_rn(x[at], w));
      }
      y = __fadd_rn(x[first + rel], acc);
    }
    __syncwarp();
    if (on) x[first + rel] = y;
    __syncwarp();
  }
  for (int i = first + lane; i < len; i += 32) g[lo + i] = x[i];
}

}  // namespace

// buf: (rows / C, C, L) float32, contiguous, updated in place over [pos,
// pos + N); window (120,), gains (3, 3) float32; planes (a host struct,
// copied into the launch): t0, t1, tap0, tap1 int32 and g0, g1 float32, a
// value a stream. Launches one warp a row on `stream`; returns
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
