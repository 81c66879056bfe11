// CELT de-emphasis IIR for Hopper (sm_90a): y[n] = x[n] + coef * y[n-1],
// one carried state per row, over a (rows, n) float32 batch.
//
// Replaces the TPU kernel mousiki_tpu/ops/pallas_kernels.py
// (_deemph_kernel / deemphasis_pallas), which ran a log-step roll+fma
// prefix scan over (8, N) VMEM tiles and folded the carry in with an
// a^(n+1) ramp.
//
// What bounds it here: on the main path rows = 512 (256 stereo streams)
// and n = 960, so 2 MB in and 2 MB out, about 1.2 us of HBM traffic at
// 3.35 TB/s. Launch and the latency of the serial chain set the time,
// not bandwidth. The design therefore keeps the chain short instead of
// keeping the bytes few:
//   * one warp per row; the warp stages its row in shared memory with
//     coalesced loads, and each lane owns a contiguous segment of
//     ceil(n/32) samples (30 at n = 960);
//   * pass 1: each lane runs the recurrence over its segment from a zero
//     carry, giving the affine map carry_out = a^len * carry_in + b_end;
//   * the 32 maps are composed with a __shfl_up_sync inclusive scan
//     (5 steps), the row's mem entering as lane 0's carry;
//   * pass 2: each lane reruns the recurrence from its true carry-in,
//     writes its samples back to shared memory, and the warp stores the
//     row with coalesced writes. The last sample is the new mem.
// The chain per row is 2*30 + 5 dependent fma steps instead of 960.

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
deemphasis_kernel(const float* __restrict__ x, const float* __restrict__ mem,
                  float* __restrict__ y, float* __restrict__ new_mem,
                  int rows, int n, float coef) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + warp;
  if (row >= rows) return;  // the whole warp leaves together

  float* buf = smem + warp * n;
  const float* xr = x + static_cast<size_t>(row) * n;
  for (int i = lane; i < n; i += 32) buf[i] = xr[i];
  __syncwarp();

  const int seg = (n + 31) / 32;
  const int lo = min(lane * seg, n);
  const int hi = min(lo + seg, n);

  // pass 1: this lane's segment as an affine map of its carry-in
  float a = 1.f, b = 0.f;
  for (int i = lo; i < hi; ++i) {
    b = fmaf(coef, b, buf[i]);
    a *= coef;
  }
  // inclusive scan: lane i holds the composition of lanes 0..i
  for (int off = 1; off < 32; off <<= 1) {
    const float ap = __shfl_up_sync(kFull, a, off);
    const float bp = __shfl_up_sync(kFull, b, off);
    if (lane >= off) {
      b = fmaf(a, bp, b);
      a *= ap;
    }
  }
  const float m = mem[row];
  const float a_prev = __shfl_up_sync(kFull, a, 1);
  const float b_prev = __shfl_up_sync(kFull, b, 1);
  float v = lane == 0 ? m : fmaf(a_prev, m, b_prev);

  // pass 2: the true recurrence over the segment from its carry-in
  for (int i = lo; i < hi; ++i) {
    v = fmaf(coef, v, buf[i]);
    buf[i] = v;
  }
  __syncwarp();

  float* yr = y + static_cast<size_t>(row) * n;
  for (int i = lane; i < n; i += 32) yr[i] = buf[i];
  if (lane == 0) new_mem[row] = buf[n - 1];
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
extern "C" int mousiki_deemphasis(const float* x, const float* mem, float* y,
                                  float* new_mem, int rows, int n,
                                  float coef, void* stream) {
  if (rows <= 0 || n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kWarpsPerBlock) * n * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = (rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  deemphasis_kernel<<<blocks, kWarpsPerBlock * 32, smem,
                      static_cast<cudaStream_t>(stream)>>>(
      x, mem, y, new_mem, rows, n, coef);
  return static_cast<int>(cudaGetLastError());
}
