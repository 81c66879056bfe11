// The arithmetic of the SILK noise-shaping quantizers (ops/silk_nsq.py),
// one stream at a time: the per-subframe prologue (coefficient choice, the
// LTP re-whitening FIR, the gain-change rescaling) and the per-sample body
// of the single-state quantizer (nsq_frame_stream) and of the four-state
// delayed-decision quantizer (nsq_dd_stream).
//
// Each function rounds where the plain versions (ops/silk_nsq.
// nsq_frame_reference and nsq_del_dec_frame_reference, eager PyTorch)
// round, and nowhere else: every float32 add, subtract, multiply and divide
// is a separate rounding (the __*_rn intrinsics on the device, plain
// operators on the host, where the header is compiled by g++ with
// -ffp-contract=off so that no multiply and add are fused). A dot product
// sums its products in the order torch's CPU reduction takes for a row of
// 5, 16 or 24 floats (nsq_sum), so that the host build can equal the plain
// version on the CPU bit for bit; the plain version on the card sums in
// another order. The SILK dither is computed in uint32_t and read as
// int32_t (signed overflow is undefined in C++).
//
// The stream routines take the thread's index and the number of threads:
// columns of the prologue are spread over the threads, the sample loop runs
// on thread 0 (single state) or on threads 0-3, one trellis state each
// (delayed decision), and NSQ_SYNC / NSQ_SYNC_STATES are the barriers
// between the parts. With one thread (the host build) the same code runs
// the parts in order, the four states one after another. csrc/silk_nsq.cu
// includes this header for its two kernels; with SILK_NSQ_HOST_API defined,
// g++ builds it alone into a host library whose entry points run whole
// frames of S streams one after another (ops/_build.build_silk_nsq_host).

#ifndef MOUSIKI_SILK_NSQ_H_
#define MOUSIKI_SILK_NSQ_H_

#include <math.h>
#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#define NSQ_HD __host__ __device__ __forceinline__
#else
#define NSQ_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define NSQ_FMUL(a, b) __fmul_rn(a, b)
#define NSQ_FADD(a, b) __fadd_rn(a, b)
#define NSQ_FSUB(a, b) __fsub_rn(a, b)
#define NSQ_FDIV(a, b) __fdiv_rn(a, b)
#define NSQ_SYNC() __syncthreads()
#define NSQ_SYNC_STATES() __syncwarp(0xfu)
#else
#define NSQ_FMUL(a, b) ((a) * (b))
#define NSQ_FADD(a, b) ((a) + (b))
#define NSQ_FSUB(a, b) ((a) - (b))
#define NSQ_FDIV(a, b) ((a) / (b))
#define NSQ_SYNC() ((void)0)
#define NSQ_SYNC_STATES() ((void)0)
#endif

// the executor's shape (parallel/nsq_batch.py): 16 kHz, 20 ms frames
#define NSQ_LPC 16
#define NSQ_SHAPE 24
#define NSQ_LTP 5
#define NSQ_NB 4
#define NSQ_SUB 80
#define NSQ_L 320
#define NSQ_M 320
#define NSQ_ML (NSQ_M + NSQ_L)
#define NSQ_DD 40
#define NSQ_STATES 4
#define NSQ_QLA 0.078125f              // QUANT_LEVEL_ADJUST, 80 / 1024
#define NSQ_ONE_QLA 0.921875f          // 1 - QUANT_LEVEL_ADJUST
#define NSQ_BIG_RD 134217728.0f        // 2^27
#define NSQ_MIN_GAIN 1.52587890625e-05f  // 1 / 65536

// Pointers of one call, S streams, each array contiguous with the stream
// on its first axis: the fields of NsqParams, then of the state, then the
// warping and its rotation (delayed decision), then the outputs. The
// entry points take them as an array of pointers in this order.
enum NsqArg {
  kX, kA, kB, kArShp, kHarm, kTilt, kLfMa, kLfAr, kGains, kPitchL, kLam,
  kOffset, kVoiced, kSeed, kLtpScale, kInterp,
  kXq, kShp, kSLpc, kSAr2, kSLfAr, kSDiff, kLagPrev, kPrevGain,
  kWarp, kLw,
  kPulses, kXqFrame, kSeedUsed,
  kOXq, kOShp, kOSLpc, kOSAr2, kOSLfAr, kOSDiff, kOLagPrev, kOPrevGain,
  kNsqArgs
};

struct NsqArgs {
  const float *x, *a, *b, *ar_shp, *harm, *tilt, *lf_ma, *lf_ar, *gains;
  const int32_t* pitch_l;
  const float *lam, *offset;
  const uint8_t* voiced;
  const int32_t* seed;
  const float* ltp_scale;
  const uint8_t* interp;
  const float *xq, *shp, *s_lpc, *s_ar2, *s_lf_ar, *s_diff;
  const int32_t* lag_prev;
  const float* prev_gain;
  // the warping (a stream's value at w[s * w_stride]) and the rotation
  // (S or 1, order, order), Lw[j, m] = (-w)^(j - m) (lw_stride 0 or
  // order * order)
  const float *w, *lw;
  int64_t w_stride, lw_stride;
  int32_t* pulses;
  float* xq_frame;      // the single-state quantizer's unscaled frame
  int32_t* seed_used;   // the delayed decision's winning seed
  float *o_xq, *o_shp, *o_s_lpc, *o_s_ar2, *o_s_lf_ar, *o_s_diff;
  int32_t* o_lag_prev;
  float* o_prev_gain;
  int order;
};

inline NsqArgs nsq_args(void* const* p, int order, int64_t w_stride,
                        int64_t lw_stride) {
  NsqArgs g;
  g.x = static_cast<const float*>(p[kX]);
  g.a = static_cast<const float*>(p[kA]);
  g.b = static_cast<const float*>(p[kB]);
  g.ar_shp = static_cast<const float*>(p[kArShp]);
  g.harm = static_cast<const float*>(p[kHarm]);
  g.tilt = static_cast<const float*>(p[kTilt]);
  g.lf_ma = static_cast<const float*>(p[kLfMa]);
  g.lf_ar = static_cast<const float*>(p[kLfAr]);
  g.gains = static_cast<const float*>(p[kGains]);
  g.pitch_l = static_cast<const int32_t*>(p[kPitchL]);
  g.lam = static_cast<const float*>(p[kLam]);
  g.offset = static_cast<const float*>(p[kOffset]);
  g.voiced = static_cast<const uint8_t*>(p[kVoiced]);
  g.seed = static_cast<const int32_t*>(p[kSeed]);
  g.ltp_scale = static_cast<const float*>(p[kLtpScale]);
  g.interp = static_cast<const uint8_t*>(p[kInterp]);
  g.xq = static_cast<const float*>(p[kXq]);
  g.shp = static_cast<const float*>(p[kShp]);
  g.s_lpc = static_cast<const float*>(p[kSLpc]);
  g.s_ar2 = static_cast<const float*>(p[kSAr2]);
  g.s_lf_ar = static_cast<const float*>(p[kSLfAr]);
  g.s_diff = static_cast<const float*>(p[kSDiff]);
  g.lag_prev = static_cast<const int32_t*>(p[kLagPrev]);
  g.prev_gain = static_cast<const float*>(p[kPrevGain]);
  g.w = static_cast<const float*>(p[kWarp]);
  g.lw = static_cast<const float*>(p[kLw]);
  g.w_stride = w_stride;
  g.lw_stride = lw_stride;
  g.pulses = static_cast<int32_t*>(p[kPulses]);
  g.xq_frame = static_cast<float*>(p[kXqFrame]);
  g.seed_used = static_cast<int32_t*>(p[kSeedUsed]);
  g.o_xq = static_cast<float*>(p[kOXq]);
  g.o_shp = static_cast<float*>(p[kOShp]);
  g.o_s_lpc = static_cast<float*>(p[kOSLpc]);
  g.o_s_ar2 = static_cast<float*>(p[kOSAr2]);
  g.o_s_lf_ar = static_cast<float*>(p[kOSLfAr]);
  g.o_s_diff = static_cast<float*>(p[kOSDiff]);
  g.o_lag_prev = static_cast<int32_t*>(p[kOLagPrev]);
  g.o_prev_gain = static_cast<float*>(p[kOPrevGain]);
  g.order = order;
  return g;
}

// ---------------------------------------------------------------- scalars

// one step of the SILK generator, wrapping as int32 does in torch
NSQ_HD int32_t nsq_rand(int32_t seed) {
  return static_cast<int32_t>(static_cast<uint32_t>(seed) * 196314165u +
                              907633515u);
}

NSQ_HD int32_t nsq_add_wrap(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

NSQ_HD int nsq_clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// torch.clamp: a NaN stays NaN
NSQ_HD float nsq_clampf(float v, float lo, float hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// The sum of a row p[0..n) in the order of torch's CPU reduction of a row
// of n floats: from 8 on, eight lanes (lane l: p[l], p[l + 8], ... in
// order) added lane after lane; below 8, four lanes the same way. Exact
// for n = 1-5, 8, 16 and 24 (the quantizers' 5, 16 and 24); another n sums
// in an order of its own. The entries from nz on are zeros and are left
// out (a lane of zeros adds nothing).
template <int MAXN, int W>
NSQ_HD float nsq_sum_lanes(const float* p, int top) {
  float s = 0.0f;
#pragma unroll
  for (int l = 0; l < W; ++l) {
    if (l < top) {
      float acc = p[l];
#pragma unroll
      for (int j = l + W; j < MAXN; j += W)
        if (j < top) acc = NSQ_FADD(acc, p[j]);
      s = l == 0 ? acc : NSQ_FADD(s, acc);
    }
  }
  return s;
}

template <int MAXN>
NSQ_HD float nsq_sum(const float* p, int n, int nz) {
  const int top = nz < n ? nz : n;
  return n >= 8 ? nsq_sum_lanes<MAXN, 8>(p, top)
                : nsq_sum_lanes<MAXN, 4>(p, top);
}

template <int MAXN>
NSQ_HD float nsq_sum(const float* p, int n) {
  return nsq_sum<MAXN>(p, n, n);
}

// _dead_zone_q0: the first pulse candidate
NSQ_HD int nsq_dead_zone(float r, float offset, float rdo, bool use_dz) {
  const float q = NSQ_FSUB(r, offset);
  float v;
  if (!use_dz)
    v = floorf(q);
  else if (q > rdo)
    v = floorf(NSQ_FSUB(q, rdo));
  else if (q < -rdo)
    v = floorf(NSQ_FADD(q, rdo));
  else
    v = q < 0.0f ? -1.0f : 0.0f;
  return static_cast<int>(v);
}

// _level_val: the dequantized excitation level of the pulse q
NSQ_HD float nsq_level(int q, float offset) {
  const float qf = static_cast<float>(q);
  if (q > 0) return NSQ_FADD(NSQ_FSUB(qf, NSQ_QLA), offset);
  if (q == 0) return offset;
  if (q == -1) return NSQ_FSUB(offset, NSQ_ONE_QLA);
  return NSQ_FADD(NSQ_FADD(qf, NSQ_QLA), offset);
}

// lam * |v| + (r - v)^2
NSQ_HD float nsq_rd(float lam, float r, float v) {
  const float e = NSQ_FSUB(r, v);
  return NSQ_FADD(NSQ_FMUL(lam, fabsf(v)), NSQ_FMUL(e, e));
}

// ------------------------------------------------------ subframe prologue

// what a subframe derives from the parameters (_subframe_setup)
struct NsqSub {
  float gain, inv_gain, adj, ig;  // ig: the re-whitening's scale
  int lag, wr_lo, rw_lo;          // rw_lo: first re-whitened column
  bool rewhite, changed;
};

NSQ_HD NsqSub nsq_subframe(const NsqArgs& g, int s, int k, int lag_state,
                           float prev_gain) {
  NsqSub sf;
  const bool voiced = g.voiced[s] != 0, interp = g.interp[s] != 0;
  const float gk = g.gains[s * NSQ_NB + k];
  sf.gain = gk < NSQ_MIN_GAIN ? NSQ_MIN_GAIN : gk;
  // torch's 1.0 / gain is reciprocal(gain) * 1.0
  sf.inv_gain = NSQ_FDIV(1.0f, sf.gain);
  sf.lag = voiced ? g.pitch_l[s * NSQ_NB + k] : lag_state;
  sf.rewhite = voiced && (k & (interp ? 1 : 3)) == 0;
  sf.changed = sf.gain != prev_gain;
  sf.adj = sf.changed ? NSQ_FDIV(prev_gain, sf.gain) : 1.0f;
  const int seg_end = NSQ_M + k * NSQ_SUB;
  const int w = sf.lag + NSQ_LPC + NSQ_LTP / 2 < NSQ_M - 1
                    ? sf.lag + NSQ_LPC + NSQ_LTP / 2 : NSQ_M - 1;
  sf.wr_lo = seg_end - (sf.lag + NSQ_LTP / 2);
  const int valid_lo = seg_end - w + NSQ_LPC;
  sf.rw_lo = valid_lo > sf.wr_lo ? valid_lo : sf.wr_lo;
  if (sf.rw_lo < 0) sf.rw_lo = 0;
  sf.ig = k == 0 ? NSQ_FMUL(sf.inv_gain, g.ltp_scale[s]) : sf.inv_gain;
  return sf;
}

// the LPC coefficients of subframe k: the first half's where the NLSFs
// are interpolated, else the second's
NSQ_HD const float* nsq_a_k(const NsqArgs& g, int s, int k) {
  const bool half0 = k < 2 && g.interp[s] != 0;
  return g.a + s * 2 * NSQ_LPC + (half0 ? 0 : NSQ_LPC);
}

// column c of the re-whitened LTP buffer: the residual of xq through the
// LPC a_k, scaled; the FIR adds a product a tap in tap order from 0.0
NSQ_HD float nsq_rewhite(const float* xq, const float* a_k, int c, float ig) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < NSQ_LPC; ++j)
    if (c - 1 - j >= 0) acc = NSQ_FADD(acc, NSQ_FMUL(a_k[j], xq[c - 1 - j]));
  return NSQ_FMUL(NSQ_FSUB(xq[c], acc), ig);
}

// The prologue's column pass over the work planes: the re-whitened LTP
// buffer on [rw_lo, seg_end) where the subframe re-whitens; the shaping
// history rescaled on [fo, seg_end) and, for a voiced stream that does not
// re-whiten, the LTP buffer on [wr_lo, ltp_hi), where the gain changed.
NSQ_HD void nsq_prologue_cols(float* xq, float* shp, float* ltp,
                              const float* a_k, const NsqSub& sf, bool voiced,
                              int k, int ltp_hi, int tid, int nthr) {
  const int fo = k * NSQ_SUB, seg_end = NSQ_M + fo;
  const bool scale_ltp = sf.changed && voiced && !sf.rewhite;
  for (int c = tid; c < seg_end; c += nthr) {
    if (sf.rewhite && c >= sf.rw_lo)
      ltp[c] = nsq_rewhite(xq, a_k, c, sf.ig);
    else if (scale_ltp && c >= sf.wr_lo && c < ltp_hi)
      ltp[c] = NSQ_FMUL(ltp[c], sf.adj);
    if (sf.changed && c >= fo) shp[c] = NSQ_FMUL(shp[c], sf.adj);
  }
}

// the per-stream reads of a sample at absolute column t: the LTP
// prediction from the re-whitened buffer and the harmonic shaping term
NSQ_HD float nsq_ltp_pred(const float* ltp, const float* b_k, int t, int lag,
                          bool voiced) {
  float p[NSQ_LTP];
#pragma unroll
  for (int j = 0; j < NSQ_LTP; ++j)
    p[j] = NSQ_FMUL(b_k[j], ltp[nsq_clampi(t - lag + 2 - j, 0, NSQ_ML - 1)]);
  return voiced ? nsq_sum<NSQ_LTP>(p, NSQ_LTP) : 0.0f;
}

NSQ_HD float nsq_n_ltp(const float* shp, float harm, int t, int lag) {
  if (lag <= 0) return 0.0f;
  const float h0 = shp[nsq_clampi(t - lag + 1, 0, NSQ_ML - 1)];
  const float h1 = shp[nsq_clampi(t - lag, 0, NSQ_ML - 1)];
  const float h2 = shp[nsq_clampi(t - lag - 1, 0, NSQ_ML - 1)];
  return NSQ_FMUL(harm, NSQ_FADD(NSQ_FMUL(0.25f, NSQ_FADD(h0, h2)),
                                 NSQ_FMUL(0.5f, h1)));
}

// x - (lpc_pred + ltp_pred - n_ar - n_lf - n_ltp), left to right
NSQ_HD float nsq_residual(float x, float lpc_pred, float ltp_pred, float n_ar,
                          float n_lf, float n_ltp) {
  return NSQ_FSUB(x, NSQ_FSUB(NSQ_FSUB(NSQ_FSUB(NSQ_FADD(lpc_pred, ltp_pred),
                                                n_ar), n_lf), n_ltp));
}

// --------------------------------------------------- the single state

// one stream's buffers (the plain version's, column for column)
struct NsqFrameWork {
  float xq[NSQ_ML], shp[NSQ_ML], ltp[NSQ_ML];
  // the delay lines, oldest first: column 16 + n (24 + n) <-> time n
  float lpc_h[NSQ_LPC + NSQ_L], ar_h[NSQ_SHAPE + NSQ_L];
  float x_sc[NSQ_SUB];
  int32_t pulses[NSQ_L];
};

NSQ_HD void nsq_frame_stream(const NsqArgs& g, int s, NsqFrameWork& w,
                             int tid, int nthr) {
  const int order = g.order;
  const bool voiced = g.voiced[s] != 0;
  for (int c = tid; c < NSQ_ML; c += nthr) {
    w.xq[c] = c < NSQ_M ? g.xq[s * NSQ_M + c] : 0.0f;
    w.shp[c] = c < NSQ_M ? g.shp[s * NSQ_M + c] : 0.0f;
    w.ltp[c] = 0.0f;
  }
  for (int c = tid; c < NSQ_LPC + NSQ_L; c += nthr)
    w.lpc_h[c] = c < NSQ_LPC ? g.s_lpc[s * NSQ_LPC + NSQ_LPC - 1 - c] : 0.0f;
  for (int c = tid; c < NSQ_SHAPE + NSQ_L; c += nthr)
    w.ar_h[c] =
        c < NSQ_SHAPE ? g.s_ar2[s * NSQ_SHAPE + NSQ_SHAPE - 1 - c] : 0.0f;
  // the carried scalars, the same on every thread
  float s_lf_ar = g.s_lf_ar[s], s_diff = g.s_diff[s];
  float prev_gain = g.prev_gain[s];
  int lag_state = g.lag_prev[s];
  int32_t seed = g.seed[s];
  const float lam = g.lam[s], offset = g.offset[s];
  const float rdo = NSQ_FSUB(NSQ_FMUL(0.5f, lam), 0.5f);
  const bool use_dz = lam > 2.0f;
  NSQ_SYNC();
  for (int k = 0; k < NSQ_NB; ++k) {
    const int fo = k * NSQ_SUB;
    const NsqSub sf = nsq_subframe(g, s, k, lag_state, prev_gain);
    const float* a_k = nsq_a_k(g, s, k);
    nsq_prologue_cols(w.xq, w.shp, w.ltp, a_k, sf, voiced, k, NSQ_M + fo,
                      tid, nthr);
    for (int c = tid; c < NSQ_SUB; c += nthr)
      w.x_sc[c] = NSQ_FMUL(g.x[s * NSQ_L + fo + c], sf.inv_gain);
    for (int c = tid; c < NSQ_LPC; c += nthr)
      w.lpc_h[fo + c] = NSQ_FMUL(w.lpc_h[fo + c], sf.adj);
    for (int c = tid; c < NSQ_SHAPE; c += nthr)
      w.ar_h[fo + c] = NSQ_FMUL(w.ar_h[fo + c], sf.adj);
    s_lf_ar = NSQ_FMUL(s_lf_ar, sf.adj);
    s_diff = NSQ_FMUL(s_diff, sf.adj);
    prev_gain = sf.gain;
    NSQ_SYNC();
    if (tid == 0) {
      const float* b_k = g.b + (s * NSQ_NB + k) * NSQ_LTP;
      const float* ar_k = g.ar_shp + (s * NSQ_NB + k) * NSQ_SHAPE;
      const float harm = g.harm[s * NSQ_NB + k], tilt = g.tilt[s * NSQ_NB + k];
      const float lf_ma = g.lf_ma[s * NSQ_NB + k];
      const float lf_ar_c = g.lf_ar[s * NSQ_NB + k];
      float a_rev[NSQ_LPC], ar_rev[NSQ_SHAPE];
#pragma unroll
      for (int m = 0; m < NSQ_LPC; ++m) a_rev[m] = a_k[NSQ_LPC - 1 - m];
#pragma unroll
      for (int m = 0; m < NSQ_SHAPE; ++m)
        ar_rev[m] = m < order ? ar_k[order - 1 - m] : 0.0f;
      for (int i = 0; i < NSQ_SUB; ++i) {
        const int n = fo + i, t = NSQ_M + n;
        seed = nsq_rand(seed);
        float p[NSQ_SHAPE];
#pragma unroll
        for (int m = 0; m < NSQ_LPC; ++m)
          p[m] = NSQ_FMUL(a_rev[m], w.lpc_h[n + m]);
        const float lpc_pred = nsq_sum<NSQ_LPC>(p, NSQ_LPC);
        const float ltp_pred = nsq_ltp_pred(w.ltp, b_k, t, sf.lag, voiced);
#pragma unroll
        for (int m = 0; m < NSQ_SHAPE; ++m)
          if (m < order)
            p[m] = NSQ_FMUL(ar_rev[m], w.ar_h[NSQ_SHAPE + n - order + m]);
        const float n_ar = NSQ_FADD(nsq_sum<NSQ_SHAPE>(p, order),
                                    NSQ_FMUL(tilt, s_lf_ar));
        const float n_lf = NSQ_FADD(NSQ_FMUL(lf_ma, w.shp[t - 1]),
                                    NSQ_FMUL(lf_ar_c, s_lf_ar));
        const float n_ltp = nsq_n_ltp(w.shp, harm, t, sf.lag);
        const float x_i = w.x_sc[i];
        const bool neg = seed < 0;
        float r = nsq_residual(x_i, lpc_pred, ltp_pred, n_ar, n_lf, n_ltp);
        r = nsq_clampf(neg ? -r : r, -31.0f, 30.0f);
        int q0 = nsq_dead_zone(r, offset, rdo, use_dz);
        float v1 = nsq_level(q0, offset);
        const float v2 = nsq_level(q0 + 1, offset);
        const bool take2 = nsq_rd(lam, r, v2) < nsq_rd(lam, r, v1);
        q0 = nsq_clampi(take2 ? q0 + 1 : q0, -1000, 1000);
        v1 = take2 ? v2 : v1;
        const float lpc_exc = NSQ_FADD(neg ? -v1 : v1, ltp_pred);
        const float xq_v = NSQ_FADD(lpc_exc, lpc_pred);
        w.xq[t] = NSQ_FMUL(xq_v, sf.gain);
        w.lpc_h[NSQ_LPC + n] = xq_v;
        s_diff = NSQ_FSUB(xq_v, x_i);
        w.ar_h[NSQ_SHAPE + n] = s_diff;
        s_lf_ar = NSQ_FSUB(s_diff, n_ar);
        w.shp[t] = NSQ_FSUB(s_lf_ar, n_lf);
        w.ltp[t] = lpc_exc;
        seed = nsq_add_wrap(seed, q0);
        w.pulses[n] = q0;
      }
    }
    lag_state = sf.lag;
    NSQ_SYNC();
  }
  // the sample loop's scalars, from thread 0's copy
  for (int c = tid; c < NSQ_L; c += nthr) {
    g.pulses[s * NSQ_L + c] = w.pulses[c];
    g.xq_frame[s * NSQ_L + c] = w.xq[NSQ_M + c];
  }
  for (int c = tid; c < NSQ_M; c += nthr) {
    g.o_xq[s * NSQ_M + c] = w.xq[NSQ_L + c];
    g.o_shp[s * NSQ_M + c] = w.shp[NSQ_L + c];
  }
  for (int c = tid; c < NSQ_LPC; c += nthr)
    g.o_s_lpc[s * NSQ_LPC + c] = w.lpc_h[NSQ_LPC + NSQ_L - 1 - c];
  for (int c = tid; c < NSQ_SHAPE; c += nthr)
    g.o_s_ar2[s * NSQ_SHAPE + c] = w.ar_h[NSQ_SHAPE + NSQ_L - 1 - c];
  if (tid == 0) {
    g.o_s_lf_ar[s] = s_lf_ar;
    g.o_s_diff[s] = s_diff;
    g.o_lag_prev[s] = voiced ? g.pitch_l[s * NSQ_NB + NSQ_NB - 1] : 0;
    g.o_prev_gain[s] = prev_gain;
  }
}

// ------------------------------------------------- the delayed decision

enum { kRingQ, kRingXq, kRingPred, kRingShape, kRings };

// One trellis state: a replacement copies the whole struct (rd, lf_ar and
// diff are then set from the replacing candidate, as in the plain version)
struct NsqDDState {
  float rd, lf_ar, diff;
  int32_t seed, seed_init;
  float s_lpc[NSQ_LPC];   // newest first
  float s_ar2[NSQ_SHAPE]; // the warped chain, [0, order)
  int32_t r_rand[NSQ_DD];
  float ring[kRings][NSQ_DD];
};

// the two candidates of a state at a sample: cost, then vq, lexc, xqv, d,
// lfar, shape
enum { kCandVq, kCandLexc, kCandXq, kCandD, kCandLfar, kCandShape, kCands };
struct NsqDDCand {
  float rd[2];
  float v[2][kCands];
};

struct NsqDDWork {
  float xq[NSQ_ML], shp[NSQ_ML], ltp[NSQ_ML];
  float x_sc[NSQ_SUB];
  float lw[NSQ_SHAPE * NSQ_SHAPE];
  float delayed_gain[NSQ_DD];
  int32_t pulses[NSQ_L];
  NsqDDState st[NSQ_STATES];
  NsqDDCand cand[NSQ_STATES];
  int win;   // the final flush's winner
};

// state n's two candidates at sample i (head: the ring head before the
// sample moves it)
NSQ_HD void nsq_dd_candidates(NsqDDWork& w, int n, const float* a_k,
                              const float* ar_k, int order, float tilt,
                              float lf_ma, float lf_ar_c, float x_i,
                              float ltp_pred, float n_ltp, float lam,
                              float offset, float rdo, bool use_dz,
                              int head) {
  NsqDDState& st = w.st[n];
  st.seed = nsq_rand(st.seed);
  const float sgn = st.seed < 0 ? -1.0f : 1.0f;
  float p[NSQ_SHAPE];
#pragma unroll
  for (int m = 0; m < NSQ_LPC; ++m) p[m] = NSQ_FMUL(a_k[m], st.s_lpc[m]);
  const float lpc_pred = nsq_sum<NSQ_LPC>(p, NSQ_LPC);
#pragma unroll
  for (int j = 0; j < NSQ_SHAPE; ++j)
    if (j < order) p[j] = NSQ_FMUL(ar_k[j], st.s_ar2[j]);
  const float n_ar = NSQ_FADD(nsq_sum<NSQ_SHAPE>(p, order),
                              NSQ_FMUL(tilt, st.lf_ar));
  const float n_lf = NSQ_FADD(NSQ_FMUL(lf_ma, st.ring[kRingShape][head]),
                              NSQ_FMUL(lf_ar_c, st.lf_ar));
  float r = nsq_residual(x_i, lpc_pred, ltp_pred, n_ar, n_lf, n_ltp);
  r = nsq_clampf(NSQ_FMUL(sgn, r), -31.0f, 30.0f);
  const int q0 = nsq_dead_zone(r, offset, rdo, use_dz);
  const float v1 = nsq_level(q0, offset);
  const float v2 = q0 == 0 ? NSQ_FADD(v1, NSQ_ONE_QLA)
                           : (q0 == -1 ? offset : NSQ_FADD(v1, 1.0f));
  const float rd1 = nsq_rd(lam, r, v1), rd2 = nsq_rd(lam, r, v2);
  const bool swap = rd2 < rd1;
  NsqDDCand& c = w.cand[n];
  c.rd[0] = NSQ_FADD(st.rd, swap ? rd2 : rd1);
  c.rd[1] = NSQ_FADD(st.rd, swap ? rd1 : rd2);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float vq = (h == 0) == swap ? v2 : v1;
    const float lexc = NSQ_FADD(NSQ_FMUL(sgn, vq), ltp_pred);
    const float xqv = NSQ_FADD(lexc, lpc_pred);
    const float d = NSQ_FSUB(xqv, x_i);
    const float lfar = NSQ_FSUB(d, n_ar);
    c.v[h][kCandVq] = vq;
    c.v[h][kCandLexc] = lexc;
    c.v[h][kCandXq] = xqv;
    c.v[h][kCandD] = d;
    c.v[h][kCandLfar] = lfar;
    c.v[h][kCandShape] = NSQ_FSUB(lfar, n_lf);
  }
}

// the decisions of a sample over the four states: the winner, the
// rand-consistency penalty (added after rd + rd1 / rd2, as a float32
// add), the worst head mx and the best runner-up mn; ties go to the lowest
// index (torch.argmin / argmax)
struct NsqDDDecision {
  int win, mx, mn;
  bool rep;          // state mx takes state mn's runner-up
  float c1_best;
  float c0_rd[NSQ_STATES];   // the heads' costs after the penalty
};

NSQ_HD NsqDDDecision nsq_dd_decide(const NsqDDWork& w, int last) {
  NsqDDDecision d;
  d.win = 0;
#pragma unroll
  for (int n = 1; n < NSQ_STATES; ++n)
    if (w.cand[n].rd[0] < w.cand[d.win].rd[0]) d.win = n;
  const int32_t rr_win = w.st[d.win].r_rand[last];
  float c1[NSQ_STATES];
#pragma unroll
  for (int n = 0; n < NSQ_STATES; ++n) {
    const bool bad = w.st[n].r_rand[last] != rr_win;
    d.c0_rd[n] = bad ? NSQ_FADD(w.cand[n].rd[0], NSQ_BIG_RD) : w.cand[n].rd[0];
    c1[n] = bad ? NSQ_FADD(w.cand[n].rd[1], NSQ_BIG_RD) : w.cand[n].rd[1];
  }
  d.mx = 0;
  d.mn = 0;
#pragma unroll
  for (int n = 1; n < NSQ_STATES; ++n) {
    if (d.c0_rd[n] > d.c0_rd[d.mx]) d.mx = n;
    if (c1[n] < c1[d.mn]) d.mn = n;
  }
  d.c1_best = c1[d.mn];
  d.rep = d.c1_best < d.c0_rd[d.mx];
  return d;
}

// word e of state `src` over state `dst` (the struct is 32-bit fields
// only): one 32-bit load and store on the device, memcpy on the host
NSQ_HD void nsq_copy_word(NsqDDState& dst, const NsqDDState& src, int e) {
#if defined(__CUDA_ARCH__)
  reinterpret_cast<uint32_t*>(&dst)[e] =
      reinterpret_cast<const uint32_t*>(&src)[e];
#else
  memcpy(reinterpret_cast<char*>(&dst) + 4 * e,
         reinterpret_cast<const char*>(&src) + 4 * e, 4);
#endif
}

// the candidate state n advances with: its head, or mn's runner-up where
// it is the replaced state mx
NSQ_HD void nsq_dd_chosen(const NsqDDWork& w, int n, const NsqDDDecision& d,
                          float* c) {
  const float* src = d.rep && n == d.mx ? w.cand[d.mn].v[1] : w.cand[n].v[0];
#pragma unroll
  for (int e = 0; e < kCands; ++e) c[e] = src[e];
}

// state n advances with its chosen candidate c: the warped rotation
// new_s[j] = sum_m rhs[m] Lw[j, m] over m <= j (the zeros above the
// diagonal skipped) in nsq_sum's lanes, the rings and the dither at the
// new head
NSQ_HD void nsq_dd_advance(NsqDDWork& w, int n, const NsqDDDecision& d,
                           const float* c, int order, float warp, int head) {
  NsqDDState& st = w.st[n];
  const bool rep = d.rep && n == d.mx;
  float rhs[NSQ_SHAPE];
  rhs[0] = NSQ_FADD(c[kCandD], NSQ_FMUL(warp, st.s_ar2[0]));
#pragma unroll
  for (int m = 1; m < NSQ_SHAPE; ++m)
    if (m < order)
      rhs[m] = NSQ_FADD(st.s_ar2[m - 1], NSQ_FMUL(warp, st.s_ar2[m]));
#pragma unroll
  for (int j = 0; j < NSQ_SHAPE; ++j) {
    if (j < order) {
      float p[NSQ_SHAPE];
#pragma unroll
      for (int m = 0; m <= j; ++m)
        p[m] = NSQ_FMUL(rhs[m], w.lw[j * order + m]);
      st.s_ar2[j] = nsq_sum<NSQ_SHAPE>(p, order, j + 1);
    }
  }
  st.lf_ar = c[kCandLfar];
  st.diff = c[kCandD];
#pragma unroll
  for (int m = NSQ_LPC - 1; m > 0; --m) st.s_lpc[m] = st.s_lpc[m - 1];
  st.s_lpc[0] = c[kCandXq];
  st.ring[kRingQ][head] = c[kCandVq];
  st.ring[kRingXq][head] = c[kCandXq];
  st.ring[kRingPred][head] = c[kCandLexc];
  st.ring[kRingShape][head] = c[kCandShape];
  st.seed = nsq_add_wrap(
      st.seed, static_cast<int32_t>(floorf(NSQ_FADD(c[kCandVq], 0.5f))));
  st.r_rand[head] = st.seed;
  st.rd = rep ? d.c1_best : d.c0_rd[n];
}

NSQ_HD int nsq_dd_argmin_rd(const NsqDDWork& w) {
  int win = 0;
#pragma unroll
  for (int n = 1; n < NSQ_STATES; ++n)
    if (w.st[n].rd < w.st[win].rd) win = n;
  return win;
}

// Commit the dd delayed samples of the winner to the columns [fo - dd, fo)
// of the pulses and of the xq and shaping planes (one thread); returns the
// winner. The states that lost take the penalty.
NSQ_HD int nsq_dd_flush(NsqDDWork& w, float gain, int fo, int dd, int head) {
  const int win = nsq_dd_argmin_rd(w);
#pragma unroll
  for (int n = 0; n < NSQ_STATES; ++n)
    if (n != win) w.st[n].rd = NSQ_FADD(w.st[n].rd, NSQ_BIG_RD);
  const NsqDDState& st = w.st[win];
  for (int i = 0; i < dd; ++i) {
    const int last = (head + dd + NSQ_DD - 1 - i) % NSQ_DD;
    const int col = fo - dd + i;
    w.pulses[col] = static_cast<int32_t>(
        floorf(NSQ_FADD(st.ring[kRingQ][last], 0.5f)));
    w.xq[NSQ_M + col] = NSQ_FMUL(st.ring[kRingXq][last], gain);
    w.shp[NSQ_M + col] = st.ring[kRingShape][last];
  }
  return win;
}

NSQ_HD float nsq_gain(const NsqArgs& g, int s, int k) {
  const float gk = g.gains[s * NSQ_NB + k];
  return gk < NSQ_MIN_GAIN ? NSQ_MIN_GAIN : gk;
}

NSQ_HD void nsq_dd_stream(const NsqArgs& g, int s, NsqDDWork& w, int tid,
                          int nthr) {
  const int order = g.order;
  const bool voiced = g.voiced[s] != 0, interp = g.interp[s] != 0;
  const int lag_prev = g.lag_prev[s];
  // the threads of the sample loop and the states each runs: threads 0-3
  // a state each, or one thread all four
  const bool runs_states = tid < NSQ_STATES;
  const int n_lo = nthr == 1 ? 0 : tid;
  const int n_hi = nthr == 1 ? NSQ_STATES : tid + 1;
  const int n_step = nthr == 1 ? 1 : NSQ_STATES;
  for (int c = tid; c < NSQ_ML; c += nthr) {
    w.xq[c] = c < NSQ_M ? g.xq[s * NSQ_M + c] : 0.0f;
    w.shp[c] = c < NSQ_M ? g.shp[s * NSQ_M + c] : 0.0f;
    w.ltp[c] = 0.0f;
  }
  for (int c = tid; c < NSQ_L; c += nthr) w.pulses[c] = 0;
  for (int c = tid; c < NSQ_DD; c += nthr) w.delayed_gain[c] = 0.0f;
  const float* lw = g.lw + s * g.lw_stride;
  for (int c = tid; c < order * order; c += nthr) w.lw[c] = lw[c];
  if (runs_states) {
    for (int n = n_lo; n < n_hi; ++n) {
      NsqDDState& st = w.st[n];
      st.rd = 0.0f;
      st.lf_ar = g.s_lf_ar[s];
      st.diff = g.s_diff[s];
      st.seed = static_cast<int32_t>(
          (static_cast<uint32_t>(n) + (static_cast<uint32_t>(g.seed[s]) & 3u))
          & 3u);
      st.seed_init = st.seed;
      for (int m = 0; m < NSQ_LPC; ++m) st.s_lpc[m] = g.s_lpc[s * NSQ_LPC + m];
      for (int m = 0; m < NSQ_SHAPE; ++m)
        st.s_ar2[m] = m < order ? g.s_ar2[s * NSQ_SHAPE + m] : 0.0f;
      for (int j = 0; j < NSQ_DD; ++j) {
        st.r_rand[j] = 0;
        for (int p = 0; p < kRings; ++p) st.ring[p][j] = 0.0f;
      }
      st.ring[kRingShape][0] = g.shp[s * NSQ_M + NSQ_M - 1];
    }
  }
  // the decision delay
  int dd = NSQ_DD < NSQ_SUB ? NSQ_DD : NSQ_SUB;
  if (voiced) {
    for (int k = 0; k < NSQ_NB; ++k) {
      int v = g.pitch_l[s * NSQ_NB + k] - NSQ_LTP / 2 - 1;
      v = v < 0 ? 0 : v;
      dd = v < dd ? v : dd;
    }
  } else if (lag_prev > 0) {
    int v = lag_prev - NSQ_LTP / 2 - 1;
    v = v < 0 ? 0 : v;
    dd = v < dd ? v : dd;
  }
  const float lam = g.lam[s], offset = g.offset[s];
  const float rdo = NSQ_FSUB(NSQ_FMUL(0.5f, lam), 0.5f);
  const bool use_dz = lam > 2.0f;
  const float warp = g.w[s * g.w_stride];
  const bool flush2 = voiced && interp;
  float prev_gain = g.prev_gain[s];
  int lag_state = lag_prev;
  NSQ_SYNC();
  for (int k = 0; k < NSQ_NB; ++k) {
    const int fo = k * NSQ_SUB;
    // the ring head, equal for all streams, one step down a sample
    int head = (NSQ_DD - fo % NSQ_DD) % NSQ_DD;
    if (k == 2 && flush2) {
      // the mid-frame flush before the re-whitening, for the voiced and
      // interpolated streams (the others are left as they are)
      if (tid == 0) nsq_dd_flush(w, nsq_gain(g, s, 1), fo, dd, head);
      NSQ_SYNC();
    }
    const NsqSub sf = nsq_subframe(g, s, k, lag_state, prev_gain);
    const float* a_k = nsq_a_k(g, s, k);
    nsq_prologue_cols(w.xq, w.shp, w.ltp, a_k, sf, voiced, k,
                      NSQ_M + fo - dd, tid, nthr);
    for (int c = tid; c < NSQ_SUB; c += nthr)
      w.x_sc[c] = NSQ_FMUL(g.x[s * NSQ_L + fo + c], sf.inv_gain);
    if (runs_states) {
      for (int n = n_lo; n < n_hi; ++n) {
        NsqDDState& st = w.st[n];
        st.lf_ar = NSQ_FMUL(st.lf_ar, sf.adj);
        st.diff = NSQ_FMUL(st.diff, sf.adj);
        for (int m = 0; m < NSQ_LPC; ++m)
          st.s_lpc[m] = NSQ_FMUL(st.s_lpc[m], sf.adj);
        for (int m = 0; m < order; ++m)
          st.s_ar2[m] = NSQ_FMUL(st.s_ar2[m], sf.adj);
        for (int j = 0; j < NSQ_DD; ++j) {
          st.ring[kRingPred][j] = NSQ_FMUL(st.ring[kRingPred][j], sf.adj);
          st.ring[kRingShape][j] = NSQ_FMUL(st.ring[kRingShape][j], sf.adj);
        }
      }
    }
    prev_gain = sf.gain;
    NSQ_SYNC();
    if (runs_states) {
      const float* b_k = g.b + (s * NSQ_NB + k) * NSQ_LTP;
      const float* ar_k = g.ar_shp + (s * NSQ_NB + k) * NSQ_SHAPE;
      const float harm = g.harm[s * NSQ_NB + k], tilt = g.tilt[s * NSQ_NB + k];
      const float lf_ma = g.lf_ma[s * NSQ_NB + k];
      const float lf_ar_c = g.lf_ar[s * NSQ_NB + k];
      for (int i = 0; i < NSQ_SUB; ++i) {
        const int t = NSQ_M + fo + i;
        const float ltp_pred = nsq_ltp_pred(w.ltp, b_k, t, sf.lag, voiced);
        const float n_ltp = nsq_n_ltp(w.shp, harm, t, sf.lag);
        for (int n = n_lo; n < n_hi; ++n)
          nsq_dd_candidates(w, n, a_k, ar_k, order, tilt, lf_ma, lf_ar_c,
                            w.x_sc[i], ltp_pred, n_ltp, lam, offset, rdo,
                            use_dz, head);
        head = (head + NSQ_DD - 1) % NSQ_DD;
        const int last = (head + dd) % NSQ_DD;
        NSQ_SYNC_STATES();
        const NsqDDDecision d = nsq_dd_decide(w, last);
        // each state's candidate, read before any thread moves on to the
        // next sample's candidates
        float chosen[NSQ_STATES][kCands];
        for (int n = n_lo; n < n_hi; ++n)
          nsq_dd_chosen(w, n, d, chosen[n - n_lo]);
        // every thread has read the states' dither before one is replaced
        NSQ_SYNC_STATES();
        if (d.rep) {
          const int words = static_cast<int>(sizeof(NsqDDState) / 4);
          for (int e = n_lo; e < words; e += n_step)
            nsq_copy_word(w.st[d.mx], w.st[d.mn], e);
        }
        NSQ_SYNC_STATES();
        // the delayed emission from the winner (after the replacement)
        const bool emit = k == 0 ? i >= dd
                                 : (k == 2 ? (!flush2 || i >= dd) : true);
        if (n_lo == 0 && emit) {
          const NsqDDState& win = w.st[d.win];
          const int pcol = nsq_clampi(fo + i - dd, 0, NSQ_L - 1);
          const int xcol = nsq_clampi(t - dd, 0, NSQ_ML - 1);
          w.pulses[pcol] = static_cast<int32_t>(
              floorf(NSQ_FADD(win.ring[kRingQ][last], 0.5f)));
          w.xq[xcol] = NSQ_FMUL(win.ring[kRingXq][last],
                                w.delayed_gain[last]);
          w.shp[xcol] = win.ring[kRingShape][last];
          w.ltp[xcol] = win.ring[kRingPred][last];
        }
        NSQ_SYNC_STATES();
        for (int n = n_lo; n < n_hi; ++n)
          nsq_dd_advance(w, n, d, chosen[n - n_lo], order, warp, head);
        if (n_lo == 0) w.delayed_gain[head] = sf.gain;
      }
    }
    lag_state = sf.lag;
    NSQ_SYNC();
  }
  if (tid == 0)
    w.win = nsq_dd_flush(w, nsq_gain(g, s, NSQ_NB - 1), NSQ_L, dd,
                         (NSQ_DD - NSQ_L % NSQ_DD) % NSQ_DD);
  NSQ_SYNC();
  // the winner's state
  const NsqDDState& st = w.st[w.win];
  for (int c = tid; c < NSQ_L; c += nthr) g.pulses[s * NSQ_L + c] = w.pulses[c];
  for (int c = tid; c < NSQ_M; c += nthr) {
    g.o_xq[s * NSQ_M + c] = w.xq[NSQ_L + c];
    g.o_shp[s * NSQ_M + c] = w.shp[NSQ_L + c];
  }
  for (int c = tid; c < NSQ_LPC; c += nthr)
    g.o_s_lpc[s * NSQ_LPC + c] = st.s_lpc[c];
  for (int c = tid; c < NSQ_SHAPE; c += nthr)
    g.o_s_ar2[s * NSQ_SHAPE + c] =
        c < order ? st.s_ar2[c] : g.s_ar2[s * NSQ_SHAPE + c];
  if (tid == 0) {
    g.o_s_lf_ar[s] = st.lf_ar;
    g.o_s_diff[s] = st.diff;
    g.o_lag_prev[s] = voiced ? g.pitch_l[s * NSQ_NB + NSQ_NB - 1] : 0;
    g.o_prev_gain[s] = prev_gain;
    g.seed_used[s] = st.seed_init;
  }
}

#if defined(SILK_NSQ_HOST_API)
#include <stdlib.h>

// Entry points of the host build (ctypes): whole frames of S streams, one
// after another, with one thread. ptrs holds kNsqArgs pointers in NsqArg's
// order (the warping's two are read by the delayed decision only, the
// xq frame's written by the single state only, the seed's by the delayed
// decision only). Return 0, or -1 for an order outside [1, 24].
extern "C" {

int silk_nsq_host_frame(void* const* ptrs, int S, int order) {
  if (order < 1 || order > NSQ_SHAPE) return -1;
  const NsqArgs g = nsq_args(ptrs, order, 0, 0);
  NsqFrameWork* w = static_cast<NsqFrameWork*>(malloc(sizeof(NsqFrameWork)));
  if (w == nullptr) return -1;
  for (int s = 0; s < S; ++s) nsq_frame_stream(g, s, *w, 0, 1);
  free(w);
  return 0;
}

int silk_nsq_host_del_dec(void* const* ptrs, int S, int order,
                          int64_t w_stride, int64_t lw_stride) {
  if (order < 1 || order > NSQ_SHAPE) return -1;
  const NsqArgs g = nsq_args(ptrs, order, w_stride, lw_stride);
  NsqDDWork* w = static_cast<NsqDDWork*>(malloc(sizeof(NsqDDWork)));
  if (w == nullptr) return -1;
  for (int s = 0; s < S; ++s) nsq_dd_stream(g, s, *w, 0, 1);
  free(w);
  return 0;
}

}  // extern "C"
#endif  // SILK_NSQ_HOST_API

#endif  // MOUSIKI_SILK_NSQ_H_
