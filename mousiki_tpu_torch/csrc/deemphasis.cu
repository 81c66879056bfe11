// CELT de-emphasis tail for Hopper (sm_90a), one fused pass:
//   y[n] = x[n] + coef * y[n-1]    per (stream, channel) row, carried mem
//   pcm[s, n, c] = y[s, c, n] / 32768
//   new_mem[s, c] = y[s, c, N-1]   (unscaled)
// over x (S, C, N) float32, C in {1, 2}, N in {120, 240, 480, 960}.
//
// Replaces the TPU kernel mousiki_tpu/ops/pallas_kernels.py
// (_deemph_kernel / deemphasis_pallas), which ran a log-step roll+fma
// prefix scan over (8, N) VMEM tiles, together with the two XLA passes
// that followed it in synthesis_jax.synthesis_step (the 1/32768 scale and
// the (S, C, N) -> (S, N, C) transpose).
//
// What bounds it here: HBM bytes. Each input byte is read once and each
// output byte written once: S*C*N*4 + S*C*4 in, S*N*C*4 + S*C*4 out, 3.94
// MB at the main path's S = 256, C = 2, N = 960, i.e. 1.17 us at 3.35
// TB/s. The arithmetic (3 flops a sample) and the serial chain are not
// the limit once the chain is short. The design keeps every byte in
// flight at once, touches each only in registers, and writes whole
// 32-byte sectors:
//   * N is a template parameter, so every loop unrolls and a thread's
//     samples live in registers; nothing is staged in shared memory;
//   * each thread owns an 8-sample segment of one channel (two 16-byte
//     loads). A warp holds 32/C segments of every channel of one stream
//     (stereo: lanes 0-15 left, 16-31 right), a stream N/8/(32/C) warps
//     (8 at N = 960 stereo), so the main path runs 64k threads;
//   * every full segment maps its carry-in v to A * v + b with the same
//     A = coef^8, so the carry scan across a stream's segments is a scan
//     of b alone with precomputed powers of A: __shfl_up_sync steps
//     inside the warp, then one step through shared memory across the
//     warps of the stream. The stream's mem enters as segment 0's carry;
//   * the epilogue reruns the 8 samples from the true carry and scales
//     by 1/32768. In stereo the left and right lanes of a segment trade
//     four values (__shfl_xor_sync) so that each stores 16 interleaved
//     bytes of the same 32-byte sector in the same instruction: every
//     store instruction writes whole sectors.
// The dependent chain is 8 + 4 + (up to 7) + 8 fma steps.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kSeg = 8;  // samples per thread

template <int N, int C>
struct Shape {
  static constexpr int kSegs = N / kSeg;          // segments a stream
  static constexpr int kWidth = 32 / C;           // segments a warp
  static constexpr int kWarps = (kSegs + kWidth - 1) / kWidth;  // a stream
  static constexpr int kThreads = kWarps * 32 < 64 ? 64 : kWarps * 32;
  static constexpr int kStreams = kThreads / (kWarps * 32);     // a block
  static_assert(N % kSeg == 0 && kWarps <= 8, "unsupported N");
};

template <int N, int C>
__global__ void __launch_bounds__(Shape<N, C>::kThreads)
deemphasis_pcm_kernel(const float* __restrict__ x,
                      const float* __restrict__ mem,
                      float* __restrict__ pcm, float* __restrict__ new_mem,
                      int streams, float coef) {
  using Sh = Shape<N, C>;
  __shared__ float warp_total[Sh::kStreams][Sh::kWarps][C];

  const int warp_id = threadIdx.x / 32;
  const int local = warp_id / Sh::kWarps;       // stream within the block
  const int warp = warp_id % Sh::kWarps;        // warp within the stream
  const int lane = (threadIdx.x % 32) % Sh::kWidth;  // segment in the warp
  const int c = (threadIdx.x % 32) / Sh::kWidth;     // channel
  const int seg = warp * Sh::kWidth + lane;     // segment in the stream
  const int s = blockIdx.x * Sh::kStreams + local;
  // padded segments and streams past the end compute on zeros and store
  // nothing; they stay to the end for the shuffles and the barrier
  const bool live = s < streams && seg < Sh::kSegs;
  const size_t row = static_cast<size_t>(s) * C + c;

  float v[kSeg];
  if (live) {
    const float4* src = reinterpret_cast<const float4*>(x + row * N +
                                                        seg * kSeg);
    const float4 lo = src[0];
    const float4 hi = src[1];
    v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
    v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
  } else {
#pragma unroll
    for (int i = 0; i < kSeg; ++i) v[i] = 0.f;
  }
  const float m = s < streams ? mem[row] : 0.f;

  // powers of A = coef^8, in double so repeated squaring adds no error:
  // pw[k] = A^(2^k) for the scan steps, a_lane = A^lane, and after the
  // loop p = A^kWidth, a warp's multiplier
  float pw[5];
  double a_lane = 1.0;
  double p = coef;
  p *= p;
  p *= p;
  p *= p;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    if ((1 << k) >= Sh::kWidth) break;
    pw[k] = static_cast<float>(p);
    if ((lane >> k) & 1) a_lane *= p;
    p *= p;
  }
  const float a_warp = static_cast<float>(p);

  // the segment from a zero carry: its map is y -> A * y + b
  float b = 0.f;
#pragma unroll
  for (int i = 0; i < kSeg; ++i) b = fmaf(coef, b, v[i]);

  // inclusive scan inside the warp: L_j = sum_{i <= j} A^(j-i) b_i
  float scan = b;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int off = 1 << k;
    if (off >= Sh::kWidth) break;
    const float up = __shfl_up_sync(kFull, scan, off, Sh::kWidth);
    if (lane >= off) scan = fmaf(pw[k], up, scan);
  }

  // carry into this warp: Q = mem folded through the earlier warps
  float q = m;
  if constexpr (Sh::kWarps > 1) {
    if (lane == Sh::kWidth - 1) warp_total[local][warp][c] = scan;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < Sh::kWarps - 1; ++w)
      if (w < warp) q = fmaf(a_warp, q, warp_total[local][w][c]);
  }

  // carry into this segment: L_{j-1} + A^lane * Q, then the epilogue
  float prev = __shfl_up_sync(kFull, scan, 1, Sh::kWidth);
  if (lane == 0) prev = 0.f;
  float y = fmaf(static_cast<float>(a_lane), q, prev);
#pragma unroll
  for (int i = 0; i < kSeg; ++i) {
    y = fmaf(coef, y, v[i]);
    v[i] = y * (1.f / 32768.f);
  }

  float* out = pcm + (static_cast<size_t>(s) * N + seg * kSeg) * C;
  if constexpr (C == 2) {
    // left stores (L0 R0 L1 R1) and (L4 R4 L5 R5), right stores
    // (L2 R2 L3 R3) and (L6 R6 L7 R7): each trades the four values the
    // other one stores
    const bool left = c == 0;
    float t[4];
    t[0] = __shfl_xor_sync(kFull, left ? v[2] : v[0], 16);
    t[1] = __shfl_xor_sync(kFull, left ? v[3] : v[1], 16);
    t[2] = __shfl_xor_sync(kFull, left ? v[6] : v[4], 16);
    t[3] = __shfl_xor_sync(kFull, left ? v[7] : v[5], 16);
    if (!live) return;
    // selects, not branches: both halves of a sector go out in the same
    // store instruction
    const float4 lo = left ? make_float4(v[0], t[0], v[1], t[1])
                           : make_float4(t[0], v[2], t[1], v[3]);
    const float4 hi = left ? make_float4(v[4], t[2], v[5], t[3])
                           : make_float4(t[2], v[6], t[3], v[7]);
    float4* dst = reinterpret_cast<float4*>(out);
    dst[c] = lo;
    dst[2 + c] = hi;
  } else {
    if (!live) return;
    float4* dst = reinterpret_cast<float4*>(out);
    dst[0] = make_float4(v[0], v[1], v[2], v[3]);
    dst[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  if (seg == Sh::kSegs - 1) new_mem[row] = y;
}

template <int N, int C>
int launch(const float* x, const float* mem, float* pcm, float* new_mem,
           int streams, float coef, cudaStream_t stream) {
  using Sh = Shape<N, C>;
  const int blocks = (streams + Sh::kStreams - 1) / Sh::kStreams;
  deemphasis_pcm_kernel<N, C><<<blocks, Sh::kThreads, 0, stream>>>(
      x, mem, pcm, new_mem, streams, coef);
  return static_cast<int>(cudaGetLastError());
}

template <int C>
int dispatch_n(const float* x, const float* mem, float* pcm, float* new_mem,
               int streams, int n, float coef, cudaStream_t stream) {
  switch (n) {
    case 120: return launch<120, C>(x, mem, pcm, new_mem, streams, coef, stream);
    case 240: return launch<240, C>(x, mem, pcm, new_mem, streams, coef, stream);
    case 480: return launch<480, C>(x, mem, pcm, new_mem, streams, coef, stream);
    case 960: return launch<960, C>(x, mem, pcm, new_mem, streams, coef, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x (streams, channels, n) and mem (streams, channels) in; pcm (streams,
// n, channels) and new_mem (streams, channels) out; x and pcm 16-byte
// aligned. Launches on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a shape it does not take.
extern "C" int mousiki_deemphasis_pcm(const float* x, const float* mem,
                                      float* pcm, float* new_mem,
                                      int streams, int channels, int n,
                                      float coef, void* stream) {
  if (streams <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (channels == 1)
    return dispatch_n<1>(x, mem, pcm, new_mem, streams, n, coef, st);
  if (channels == 2)
    return dispatch_n<2>(x, mem, pcm, new_mem, streams, n, coef, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
