// The arithmetic of the device SILK synthesis (ops/silk_synthesis.py), one
// stream at a time: the gain scale of the excitation, the 16-tap
// re-whitening of the carried output, the 5-tap LTP prediction of a chunk of
// 8 samples, one step of the order-16 LPC synthesis, and the whole frame of
// one stream (silk_syn_stream) built from them.
//
// Each function rounds where the plain version (ops/silk_synthesis.
// silk_synthesis_step_reference, eager PyTorch) rounds, and nowhere else:
// every float32 add, subtract and multiply is a separate rounding (the
// __*_rn intrinsics on the device, plain operators on the host, where the
// header is compiled by g++ with -ffp-contract=off so that no multiply and
// add are fused). The LTP's 5 products and the LPC's 16 are summed in the
// order of torch's CPU reduction of a row of 5 and of 16 floats (as
// silk_nsq.h's nsq_sum does), so that the host build equals the plain
// version on the CPU bit for bit; the plain version on the card sums in
// another order.
//
// silk_syn_stream takes the thread's index and the number of threads: the
// scale and the re-whitening are spread over the threads, a chunk's 8 LTP
// predictions over its first 8, and the LPC chain runs on thread 0 with its
// 16-sample window in registers; SILK_SYN_SYNC is the barrier between the
// parts. With one thread (the host build) the same code runs the parts in
// order. csrc/silk_synthesis.cu includes this header for its kernel; with
// SILK_SYNTHESIS_HOST_API defined, g++ builds it alone into a host library
// whose entry point runs the streams of a frame one after another
// (ops/_build.build_header_host).

#ifndef MOUSIKI_SILK_SYNTHESIS_H_
#define MOUSIKI_SILK_SYNTHESIS_H_

#include <stdint.h>

#if defined(__CUDACC__)
#define SILK_SYN_HD __host__ __device__ __forceinline__
#else
#define SILK_SYN_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define SILK_SYN_FMUL(a, b) __fmul_rn(a, b)
#define SILK_SYN_FADD(a, b) __fadd_rn(a, b)
#define SILK_SYN_FSUB(a, b) __fsub_rn(a, b)
#define SILK_SYN_SYNC() __syncthreads()
#else
#define SILK_SYN_FMUL(a, b) ((a) * (b))
#define SILK_SYN_FADD(a, b) ((a) + (b))
#define SILK_SYN_FSUB(a, b) ((a) - (b))
#define SILK_SYN_SYNC() ((void)0)
#endif

#define SILK_SYN_D 16        // LPC order (MAX_D)
#define SILK_SYN_LTP 5       // LTP taps
#define SILK_SYN_CHUNK 8     // samples an LTP step
#define SILK_SYN_MAX_L 320   // a 20 ms frame at 16 kHz
#define SILK_SYN_MAX_H 320   // ltp_mem_length at 16 kHz
#define SILK_SYN_MAX_NB 4    // subframes

// Pointers of one call, S streams: the fields of SilkFrameParams, then of
// SilkStreamState, then the outputs. Each input's stream axis has its own
// element stride (the entry points take them in this order, the outputs
// have none); within a stream every input is contiguous. interp may be
// null (no interpolated halves).
enum SilkSynArg {
  kSynExc, kSynA, kSynB, kSynPitch, kSynGains, kSynVoiced, kSynLtpScale,
  kSynInterp, kSynOutHist, kSynLpcHist, kSynInputs,
  kSynOut = kSynInputs, kSynOHist, kSynOLpc, kSynArgs
};

struct SilkSynArgs {
  const float* exc;        // (S, L)
  const float* a;          // (S, 2, 16)
  const float* b;          // (S, nb, 5)
  const int32_t* pitch;    // (S, nb)
  const float* gains;      // (S, nb)
  const uint8_t* voiced;   // (S,)
  const float* ltp_scale;  // (S,)
  const uint8_t* interp;   // (S,) or null
  const float* out_hist;   // (S, H)
  const float* lpc_hist;   // (S, 16), y[n - 1] first
  int64_t stride[kSynInputs];
  float* out;              // (S, L)
  float* o_hist;           // (S, H)
  float* o_lpc;            // (S, 16)
  int L, H, nb, subfr_len;
};

inline SilkSynArgs silk_syn_args(void* const* p, const int64_t* strides,
                                 int L, int H, int nb, int subfr_len) {
  SilkSynArgs g;
  g.exc = static_cast<const float*>(p[kSynExc]);
  g.a = static_cast<const float*>(p[kSynA]);
  g.b = static_cast<const float*>(p[kSynB]);
  g.pitch = static_cast<const int32_t*>(p[kSynPitch]);
  g.gains = static_cast<const float*>(p[kSynGains]);
  g.voiced = static_cast<const uint8_t*>(p[kSynVoiced]);
  g.ltp_scale = static_cast<const float*>(p[kSynLtpScale]);
  g.interp = static_cast<const uint8_t*>(p[kSynInterp]);
  g.out_hist = static_cast<const float*>(p[kSynOutHist]);
  g.lpc_hist = static_cast<const float*>(p[kSynLpcHist]);
  for (int i = 0; i < kSynInputs; ++i) g.stride[i] = strides[i];
  g.out = static_cast<float*>(p[kSynOut]);
  g.o_hist = static_cast<float*>(p[kSynOHist]);
  g.o_lpc = static_cast<float*>(p[kSynOLpc]);
  g.L = L;
  g.H = H;
  g.nb = nb;
  g.subfr_len = subfr_len;
  return g;
}

// the first half's length: whole subframes, half the frame rounded down
SILK_SYN_HD int silk_syn_half(int L, int subfr_len) {
  return (L / 2 / subfr_len) * subfr_len;
}

// the shapes the entry points take: both halves whole chunks of 8 and at
// least an LPC window long, the planes within the work's arrays
inline bool silk_syn_shape_ok(int L, int H, int nb, int subfr_len) {
  if (L < 2 * SILK_SYN_D || L > SILK_SYN_MAX_L || H < 0 ||
      H > SILK_SYN_MAX_H || nb < 1 || nb > SILK_SYN_MAX_NB ||
      subfr_len < 1 || L % SILK_SYN_CHUNK != 0)
    return false;
  const int half = silk_syn_half(L, subfr_len);
  return half % SILK_SYN_CHUNK == 0 && half >= SILK_SYN_D &&
         L - half >= SILK_SYN_D;
}

// ---------------------------------------------------------------- sums

// p[0] + ... + p[4] in the order of torch's CPU reduction of a row of 5
// floats: four lanes (p[0] + p[4], p[1], p[2], p[3]) added lane after lane
SILK_SYN_HD float silk_syn_sum5(const float* p) {
  float s = SILK_SYN_FADD(p[0], p[4]);
  s = SILK_SYN_FADD(s, p[1]);
  s = SILK_SYN_FADD(s, p[2]);
  return SILK_SYN_FADD(s, p[3]);
}

// p[0] + ... + p[15] in the order of torch's CPU reduction of a row of 16
// floats: eight lanes (p[l] + p[l + 8]) added lane after lane
SILK_SYN_HD float silk_syn_sum16(const float* p) {
  float s = SILK_SYN_FADD(p[0], p[8]);
#pragma unroll
  for (int l = 1; l < 8; ++l)
    s = SILK_SYN_FADD(s, SILK_SYN_FADD(p[l], p[l + 8]));
  return s;
}

// ------------------------------------------------------------- the steps

// the excitation sample n scaled by its subframe's gain (the last
// subframe's past nb * subfr_len)
SILK_SYN_HD float silk_syn_scale(float exc, const float* gains, int n,
                                 int nb, int subfr_len) {
  const int sub = n / subfr_len;
  return SILK_SYN_FMUL(exc, gains[sub < nb - 1 ? sub : nb - 1]);
}

// sample k of the row [x0 (n0 samples) | x1]
SILK_SYN_HD float silk_syn_at(const float* x0, int n0, const float* x1,
                              int k) {
  return k < n0 ? x0[k] : x1[k - n0];
}

// the re-whitened sample i of the row [x0 | x1] through the LPC a: x[i] -
// a[0] x[i - 1] - ... - a[15] x[i - 16], a product and a subtraction a tap
// in that order, the samples before the row 0.0 (_lpc_analysis_batched)
SILK_SYN_HD float silk_syn_whiten(const float* x0, int n0, const float* x1,
                                  const float* a, int i) {
  float acc = silk_syn_at(x0, n0, x1, i);
#pragma unroll
  for (int j = 0; j < SILK_SYN_D; ++j) {
    const int k = i - 1 - j;
    const float xv = k >= 0 ? silk_syn_at(x0, n0, x1, k) : 0.0f;
    acc = SILK_SYN_FSUB(acc, SILK_SYN_FMUL(a[j], xv));
  }
  return acc;
}

// the LTP prediction of sample n of the plane r (width samples): sum_j
// b[j] r[n - lag + 2 - j], each index clamped to the plane as the plain
// version's gather clamps it
SILK_SYN_HD float silk_syn_ltp_pred(const float* r, int width, int n,
                                    int lag, const float* b) {
  float p[SILK_SYN_LTP];
#pragma unroll
  for (int j = 0; j < SILK_SYN_LTP; ++j) {
    int64_t idx = static_cast<int64_t>(n) - lag + 2 - j;
    idx = idx < 0 ? 0 : (idx > width - 1 ? width - 1 : idx);
    p[j] = SILK_SYN_FMUL(r[idx], b[j]);
  }
  return silk_syn_sum5(p);
}

// one LPC synthesis output: x plus the 16 products of the window (oldest
// first, win[j] weighted by a_rev[j] = a[15 - j]) summed as torch does
SILK_SYN_HD float silk_syn_lpc_step(float x, const float* win,
                                    const float* a_rev) {
  float p[SILK_SYN_D];
#pragma unroll
  for (int j = 0; j < SILK_SYN_D; ++j)
    p[j] = SILK_SYN_FMUL(win[j], a_rev[j]);
  return SILK_SYN_FADD(x, silk_syn_sum16(p));
}

// n LPC steps y[k] = x[k] + sum_j a[j] y[k - 1 - j] from the window seed
// (16 samples, oldest first) on one thread. The window is a ring of 16
// registers: the loop is unrolled by 16, so that at step k of a round the
// oldest sample is w[k] and every index is fixed at compile time.
SILK_SYN_HD void silk_syn_lpc(const float* a, const float* seed,
                              const float* x, float* y, int n) {
  float a_rev[SILK_SYN_D], w[SILK_SYN_D];
#pragma unroll
  for (int j = 0; j < SILK_SYN_D; ++j) {
    a_rev[j] = a[SILK_SYN_D - 1 - j];
    w[j] = seed[j];
  }
  for (int n0 = 0; n0 < n; n0 += SILK_SYN_D) {
#pragma unroll
    for (int k = 0; k < SILK_SYN_D; ++k) {
      if (n0 + k < n) {
        float win[SILK_SYN_D];
#pragma unroll
        for (int j = 0; j < SILK_SYN_D; ++j)
          win[j] = w[(k + j) % SILK_SYN_D];
        const float v = silk_syn_lpc_step(x[n0 + k], win, a_rev);
        w[k] = v;
        y[n0 + k] = v;
      }
    }
  }
}

// ------------------------------------------------------------ one stream

// a stream's work space (the kernel's shared memory): the carried output,
// the residual plane [re-whitened history | frame], the output, the
// parameters
struct SilkSynWork {
  float hist[SILK_SYN_MAX_H];
  float r[SILK_SYN_MAX_H + SILK_SYN_MAX_L];
  float y[SILK_SYN_MAX_L];
  float pred[SILK_SYN_CHUNK];
  float seed[SILK_SYN_D];
  float a[2][SILK_SYN_D];
  float b[SILK_SYN_MAX_NB][SILK_SYN_LTP];
  float gains[SILK_SYN_MAX_NB];
  int32_t pitch[SILK_SYN_MAX_NB];
};

// the LTP recurrence over chunks c_lo..c_hi-1 of the frame, in place on the
// plane r (width samples), chunk c_lo at r[hist_len]: a voiced stream's
// chunk reads its 40 samples before it writes its 8; an unvoiced stream
// adds 0.0 as the plain version does, and reads nothing
SILK_SYN_HD void silk_syn_ltp(SilkSynWork& w, bool voiced, int c_lo,
                              int c_hi, int hist_len, int width, int nb,
                              int subfr_len, int t, int nt) {
  if (!voiced) {
    for (int i = t; i < (c_hi - c_lo) * SILK_SYN_CHUNK; i += nt)
      w.r[hist_len + i] = SILK_SYN_FADD(w.r[hist_len + i], 0.0f);
    SILK_SYN_SYNC();
    return;
  }
  for (int ci = c_lo; ci < c_hi; ++ci) {
    const int n0 = hist_len + (ci - c_lo) * SILK_SYN_CHUNK;
    const int s = (ci * SILK_SYN_CHUNK) / subfr_len;
    const int sub = s < nb - 1 ? s : nb - 1;
    for (int i = t; i < SILK_SYN_CHUNK; i += nt)
      w.pred[i] = silk_syn_ltp_pred(w.r, width, n0 + i, w.pitch[sub],
                                    w.b[sub]);
    SILK_SYN_SYNC();
    for (int i = t; i < SILK_SYN_CHUNK; i += nt)
      w.r[n0 + i] = SILK_SYN_FADD(w.r[n0 + i], w.pred[i]);
    SILK_SYN_SYNC();
  }
}

// one SILK frame of stream s (silk_synthesis_step_reference): thread t of
// nt, w the stream's work space
SILK_SYN_HD void silk_syn_stream(const SilkSynArgs& g, int s, SilkSynWork& w,
                                 int t, int nt) {
  const int L = g.L, H = g.H, nb = g.nb, sl = g.subfr_len;
  const int half = silk_syn_half(L, sl);
  const int64_t* st = g.stride;
  const float* exc = g.exc + s * st[kSynExc];
  const float* a = g.a + s * st[kSynA];
  const float* b = g.b + s * st[kSynB];
  const int32_t* pitch = g.pitch + s * st[kSynPitch];
  const float* gains = g.gains + s * st[kSynGains];
  const float* hist = g.out_hist + s * st[kSynOutHist];
  const float* lpc_hist = g.lpc_hist + s * st[kSynLpcHist];
  const bool voiced = g.voiced[s * st[kSynVoiced]] != 0;
  const bool interp =
      g.interp != nullptr && g.interp[s * st[kSynInterp]] != 0;
  const float ltp_scale = g.ltp_scale[s * st[kSynLtpScale]];
  for (int i = t; i < 2 * SILK_SYN_D; i += nt)
    w.a[i / SILK_SYN_D][i % SILK_SYN_D] = a[i];
  for (int i = t; i < nb * SILK_SYN_LTP; i += nt)
    w.b[i / SILK_SYN_LTP][i % SILK_SYN_LTP] = b[i];
  for (int i = t; i < nb; i += nt) {
    w.gains[i] = gains[i];
    w.pitch[i] = pitch[i];
  }
  for (int i = t; i < SILK_SYN_D; i += nt)
    w.seed[i] = lpc_hist[SILK_SYN_D - 1 - i];
  for (int i = t; i < H; i += nt) w.hist[i] = hist[i];
  SILK_SYN_SYNC();
  // the frame's scaled excitation behind the history: the first half's
  // plane is r[0, H + half), the second half's r[0, H + L)
  for (int n = t; n < L; n += nt)
    w.r[H + n] = silk_syn_scale(exc[n], w.gains, n, nb, sl);
  // the history re-whitened with the first half's LPC, times ltp_scale
  for (int i = t; i < H; i += nt)
    w.r[i] = SILK_SYN_FMUL(
        silk_syn_whiten(w.hist, H, nullptr, w.a[0], i), ltp_scale);
  SILK_SYN_SYNC();
  silk_syn_ltp(w, voiced, 0, half / SILK_SYN_CHUNK, H, H + half, nb, sl, t,
               nt);
  if (t == 0) silk_syn_lpc(w.a[0], w.seed, w.r + H, w.y, half);
  SILK_SYN_SYNC();
  // an interpolated frame re-whitens [history | first half's output] with
  // the second half's LPC (no ltp_scale); otherwise the residual goes on
  if (interp) {
    for (int i = t; i < H + half; i += nt)
      w.r[i] = silk_syn_whiten(w.hist, H, w.y, w.a[1], i);
    SILK_SYN_SYNC();
  }
  silk_syn_ltp(w, voiced, half / SILK_SYN_CHUNK, L / SILK_SYN_CHUNK,
               H + half, H + L, nb, sl, t, nt);
  if (t == 0)
    silk_syn_lpc(w.a[1], w.y + half - SILK_SYN_D, w.r + H + half,
                 w.y + half, L - half);
  SILK_SYN_SYNC();
  float* out = g.out + static_cast<int64_t>(s) * L;
  float* o_hist = g.o_hist + static_cast<int64_t>(s) * H;
  for (int n = t; n < L; n += nt) out[n] = w.y[n];
  // the last H samples of [history | output]
  for (int i = t; i < H; i += nt)
    o_hist[i] = silk_syn_at(w.hist, H, w.y, L + i);
  for (int k = t; k < SILK_SYN_D; k += nt)
    g.o_lpc[s * SILK_SYN_D + k] = w.y[L - 1 - k];
}

#if defined(SILK_SYNTHESIS_HOST_API)
#include <stdlib.h>

// Entry point of the host build (ctypes): one frame of S streams, one after
// another, with one thread. ptrs holds kSynArgs pointers in SilkSynArg's
// order, strides the inputs' stream strides. Returns 0, or -1 for a shape
// it does not take.
extern "C" int silk_synthesis_host_step(void* const* ptrs,
                                        const int64_t* strides, int S, int L,
                                        int H, int nb, int subfr_len) {
  if (!silk_syn_shape_ok(L, H, nb, subfr_len)) return -1;
  const SilkSynArgs g = silk_syn_args(ptrs, strides, L, H, nb, subfr_len);
  SilkSynWork* w = static_cast<SilkSynWork*>(malloc(sizeof(SilkSynWork)));
  if (w == nullptr) return -1;
  for (int s = 0; s < S; ++s) silk_syn_stream(g, s, *w, 0, 1);
  free(w);
  return 0;
}
#endif  // SILK_SYNTHESIS_HOST_API

#endif  // MOUSIKI_SILK_SYNTHESIS_H_
