// The CELT concealment's row work for Hopper (sm_90a): plc_rows_kernel, for
// each (stream, channel) row of a stream that lost its packet, the LPC fit
// of a first loss (Hann-windowed autocorrelation, the noise floor and lag
// window, 24 Levinson iterations, the bandwidth expansion), the LPC
// residual of the row's last 1,024 samples, the decay from the last two
// pitch periods' energies, the periodic excitation with its per-period
// attenuation, and the order-24 LPC synthesis over n_ext samples with the
// decoder's saturation.
//
// Replaces a loop that XLA compiled in the reference, which has no Pallas
// kernel: the body of celt_plc_freq for each row (mousiki_tpu/ops/
// plc_jax.py:90-194: the Levinson fori_loop :109-127, the residual
// :132-139 and the LPC synthesis lax.scan :188-194). Its plain version,
// ops/plc.plc_rows_reference, is the port's eager sequence of the same
// steps (a Python loop of n_ext steps for the synthesis).
//
// What bounds it: the synthesis, n_ext dependent steps of one row (1,080
// at 20 ms frames). Bytes (the 4 KB history a lost row, 4.3 KB of output a
// row) and operations (~1.5e5 float64 a lost row) are small; rows run at
// once, one block a row, so a launch takes about one row's chain. The
// block stages the history in shared memory and spreads what does not
// depend on the chain over its 256 threads: the 25 autocorrelation lags
// (a warp a lag, float64 sums in a fixed order), the residual (a thread a
// sample), the energies (block sums in a fixed order) and the excitation
// (a thread a sample). The Levinson recursion runs on one warp (lane j
// holds a[j]) and so does the synthesis: lane j holds weight j and its
// window sample, the 24 float64 products are summed by a butterfly of
// shuffles (additions commute, so every lane ends with the same sum),
// every lane adds the excitation, clamps and rounds, and the window moves
// down a lane. Rows share no arithmetic, so a stream's values do not
// depend on the batch.
//
// Arithmetic is the plain version's, one rounding an operation (the
// functions of plc_rows.h); the float64 sums (autocorrelation, Levinson
// dots, energies, synthesis) add the same exact products in another order
// than torch does, so a sum may round differently in its last bit.

#include <cuda_runtime.h>
#include <stdint.h>

#include "plc_rows.h"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kLags = PLC_ORDER + 1;
// the longest extension: a 20 ms frame plus the overlap
constexpr int kMaxExt = 1080;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    v = PLC_DADD(v, __shfl_xor_sync(kFull, v, m));
  return v;
}

// the block's float64 sum of v, the same on every thread: warp sums, then
// the warps' in order
__device__ double block_sum(double v, double* part) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  double s = 0.0;
  for (int w = 0; w < kWarps; ++w) s = PLC_DADD(s, part[w]);
  __syncthreads();
  return s;
}

__global__ void __launch_bounds__(kThreads)
plc_rows_kernel(const float* __restrict__ hist, int64_t hist_s,
                int64_t hist_c, const uint8_t* __restrict__ first,
                const uint8_t* __restrict__ lost,
                const int32_t* __restrict__ pitch,
                const float* __restrict__ fade,
                const float* __restrict__ lpc_prev, int64_t lpc_s,
                int64_t lpc_c, const float* __restrict__ han,
                const float* __restrict__ lagw, const float* __restrict__ bw,
                float* __restrict__ lpc_out, float* __restrict__ ext_out,
                int C, int n_ext) {
  __shared__ float x[PLC_HIST];     // the history row
  __shared__ float w[PLC_HIST];     // windowed row, then the residual
  __shared__ float eext[kMaxExt];   // the excitation
  __shared__ float y[kMaxExt];      // the synthesis' output
  __shared__ double ac64[kLags];
  __shared__ float acf[kLags];
  __shared__ float lpc[PLC_ORDER];
  __shared__ double part[kWarps];
  const int row = blockIdx.x, s = row / C, c = row % C;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float* prev = lpc_prev + s * lpc_s + c * lpc_c;
  float* out = ext_out + static_cast<int64_t>(row) * n_ext;
  if (!lost[s]) {
    for (int i = t; i < n_ext; i += kThreads) out[i] = 0.0f;
    if (t < PLC_ORDER) lpc_out[row * PLC_ORDER + t] = prev[t];
    return;
  }
  const float* h = hist + s * hist_s + c * hist_c;
  for (int i = t; i < PLC_HIST; i += kThreads) x[i] = h[i];
  const int p = min(max(pitch[s], 1), PLC_HIST);
  if (first[s]) {
    __syncthreads();
    for (int i = t; i < PLC_HIST; i += kThreads)
      w[i] = PLC_FMUL(x[i], han[i]);
    __syncthreads();
    // lag l on warp l % kWarps, each lane's products in order, then the
    // warp's butterfly
    for (int l = warp; l < kLags; l += kWarps) {
      double acc = 0.0;
      for (int i = lane; i < PLC_HIST - l; i += 32)
        acc = PLC_DADD(acc, PLC_DMUL(static_cast<double>(w[i]),
                                     static_cast<double>(w[i + l])));
      acc = warp_sum(acc);
      if (lane == 0) acf[l] = static_cast<float>(acc);
    }
    __syncthreads();
    if (warp == 0) {
      if (lane < kLags) {
        const float a = lane == 0 ? plc_noise_floor(acf[0])
                                  : PLC_FMUL(acf[lane], lagw[lane - 1]);
        ac64[lane] = static_cast<double>(a);
      }
      __syncwarp();
      float err = static_cast<float>(ac64[0]);
      float a = 0.0f;   // a[lane]
      for (int i = 0; i < PLC_ORDER; ++i) {
        const double prod =
            lane < i ? PLC_DMUL(static_cast<double>(a), ac64[i - lane])
                     : 0.0;
        const float k = plc_levinson_k(ac64[i + 1], warp_sum(prod), err);
        const float arev = __shfl_sync(kFull, a, max(i - 1 - lane, 0));
        if (lane < i)
          a = plc_levinson_coef(a, arev, k);
        else if (lane == i)
          a = k;
        err = plc_levinson_err(err, k);
      }
      if (lane < PLC_ORDER) lpc[lane] = PLC_FMUL(a, bw[lane]);
    }
  } else if (t < PLC_ORDER) {
    lpc[t] = prev[t];
  }
  __syncthreads();
  if (t < PLC_ORDER) lpc_out[row * PLC_ORDER + t] = lpc[t];
  for (int i = t; i < PLC_HIST; i += kThreads) w[i] = plc_residual(x, lpc, i);
  __syncthreads();
  // the energies of the last pitch period and of the one before it
  double s1 = 0.0, s2 = 0.0;
  for (int i = t; i < PLC_HIST; i += kThreads) {
    const double e = static_cast<double>(w[i]);
    const double ee = PLC_DMUL(e, e);
    if (i >= PLC_HIST - p)
      s1 = PLC_DADD(s1, ee);
    else if (i >= PLC_HIST - 2 * p)
      s2 = PLC_DADD(s2, ee);
  }
  const float e1 = static_cast<float>(block_sum(s1, part));
  const float e2 = static_cast<float>(block_sum(s2, part));
  const float logd = plc_log_decay(plc_decay(e1, e2, 2 * p <= PLC_HIST));
  const float f = fade[s];
  for (int n = t; n < n_ext; n += kThreads)
    eext[n] = PLC_FMUL(w[PLC_HIST - p + n % p], plc_atten(f, logd, n / p));
  __syncthreads();
  if (warp == 0) {
    // lane j: weight lpc[23 - j] and window sample j (oldest first)
    const bool on = lane < PLC_ORDER;
    const double wt =
        on ? static_cast<double>(lpc[PLC_ORDER - 1 - lane]) : 0.0;
    float b = on ? x[PLC_HIST - PLC_ORDER + lane] : 0.0f;
    for (int n = 0; n < n_ext; ++n) {
      const double sum = warp_sum(PLC_DMUL(static_cast<double>(b), wt));
      const float v = plc_synth(sum, eext[n]);
      const float next = __shfl_down_sync(kFull, b, 1);
      b = lane == PLC_ORDER - 1 ? v : next;
      if (lane == 0) y[n] = v;
    }
  }
  __syncthreads();
  for (int i = t; i < n_ext; i += kThreads) out[i] = y[i];
}

}  // namespace

// hist: (S, C, >= PLC_HIST) float32 rows with element strides hist_s,
// hist_c (samples contiguous); first, lost: (S,) bool as bytes; pitch (S,)
// int32 in [1, PLC_HIST]; fade (S,) float32; lpc_prev (S, C, PLC_ORDER)
// float32 with strides lpc_s, lpc_c; han (PLC_HIST,), lagw and bw
// (PLC_ORDER,) float32. Writes lpc_out (S, C, PLC_ORDER) and ext_out (S, C,
// n_ext), contiguous. One block a row on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape it
// does not take.
extern "C" int mousiki_plc_rows(const float* hist, int64_t hist_s,
                                int64_t hist_c, const uint8_t* first,
                                const uint8_t* lost, const int32_t* pitch,
                                const float* fade, const float* lpc_prev,
                                int64_t lpc_s, int64_t lpc_c, const float* han,
                                const float* lagw, const float* bw,
                                float* lpc_out, float* ext_out, int S, int C,
                                int n_ext, void* stream) {
  if (S <= 0 || C < 1 || n_ext < 1 || n_ext > kMaxExt)
    return static_cast<int>(cudaErrorInvalidValue);
  plc_rows_kernel<<<S * C, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      hist, hist_s, hist_c, first, lost, pitch, fade, lpc_prev, lpc_s, lpc_c,
      han, lagw, bw, lpc_out, ext_out, C, n_ext);
  return static_cast<int>(cudaGetLastError());
}
