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
// columns of the prologue are spread over the threads. The sample loops
// run on warps, a sample's products one a lane: the single state on warp 0
// (its delay lines a window over the lanes), the delayed decision on warps
// 0-3, one trellis state each (its filter state and rotation in the lanes'
// registers, what another state may need published in shared memory and
// read behind one barrier a sample). What a sample's chain does not need
// from the sample before it (the dot products' other products and lane
// partials, the LTP and harmonic reads) is formed while that sample
// decides, in nsq_sum's order. The lane-level code is written once,
// for both builds, with the NSQ_LANES / NSQ_MY / NSQ_OF macros below: on
// the device a lane variable is one register and NSQ_OF a shuffle; on the
// host (nthr == 1) a lane variable is an array of the warp's 32 values, each
// NSQ_LANES block a loop over them and NSQ_EACH_STATE a loop over the four
// states, so the host build runs the device's per-lane arithmetic, lane by
// lane, with the same combining steps. csrc/silk_nsq.cu includes this
// header for its two kernels; with SILK_NSQ_HOST_API defined, g++ builds it
// alone into a host library whose entry points run whole frames of S
// streams one after another (ops/_build.build_silk_nsq_host).

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
#else
#define NSQ_FMUL(a, b) ((a) * (b))
#define NSQ_FADD(a, b) ((a) + (b))
#define NSQ_FSUB(a, b) ((a) - (b))
#define NSQ_FDIV(a, b) ((a) / (b))
#define NSQ_SYNC() ((void)0)
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
// out (a lane of zeros adds nothing). The lanes may sit on a warp's lanes
// (nsq_lanes_sum): lane l's column of entries col[c] = p[l + c W] is added
// up by nsq_partial, the W partials in lane order by nsq_combine (entries
// and lanes from top on are left out).
template <int MAXN, int W>
NSQ_HD float nsq_partial(const float* col, int l, int top) {
  float acc = col[0];
#pragma unroll
  for (int c = 1; c * W < MAXN; ++c)
    if (l + c * W < top) acc = NSQ_FADD(acc, col[c]);
  return acc;
}

template <int W>
NSQ_HD float nsq_combine(const float* part, int top) {
  float s = part[0];
#pragma unroll
  for (int l = 1; l < W; ++l)
    if (l < top) s = NSQ_FADD(s, part[l]);
  return s;
}

template <int MAXN, int W>
NSQ_HD float nsq_sum_lanes(const float* p, int top) {
  constexpr int kCols = (MAXN + W - 1) / W;
  float part[W];
#pragma unroll
  for (int l = 0; l < W; ++l) {
    float col[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      col[c] = l + c * W < MAXN ? p[l + c * W] : 0.0f;
    part[l] = nsq_partial<MAXN, W>(col, l, top);
  }
  return nsq_combine<W>(part, top);
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

// _dead_zone_q0: the first pulse candidate (every branch's value computed,
// then one chosen: no branch in the sample's chain)
NSQ_HD int nsq_dead_zone(float r, float offset, float rdo, bool use_dz) {
  const float q = NSQ_FSUB(r, offset);
  const float above = floorf(NSQ_FSUB(q, rdo));
  const float below = floorf(NSQ_FADD(q, rdo));
  const float inside = q < 0.0f ? -1.0f : 0.0f;
  const float v = !use_dz ? floorf(q)
                          : (q > rdo ? above : (q < -rdo ? below : inside));
  return static_cast<int>(v);
}

// _level_val: the dequantized excitation level of the pulse q
NSQ_HD float nsq_level(int q, float offset) {
  const float qf = static_cast<float>(q);
  const float pos = NSQ_FADD(NSQ_FSUB(qf, NSQ_QLA), offset);
  const float neg = NSQ_FADD(NSQ_FADD(qf, NSQ_QLA), offset);
  const float minus1 = NSQ_FSUB(offset, NSQ_ONE_QLA);
  return q > 0 ? pos : (q == 0 ? offset : (q == -1 ? minus1 : neg));
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

// column c of a plane, or e_val where c is e_col: the column the delayed
// decision's emission wrote at the last sample, which every state holds in
// a register (the thread that writes the plane may not have reached it)
NSQ_HD float nsq_plane(const float* plane, int c, int e_col, float e_val) {
  const float v = plane[c];   // loaded either way: no branch around it
  return c == e_col ? e_val : v;
}

// the per-stream reads of a sample at absolute column t: the LTP
// prediction from the re-whitened buffer and the harmonic shaping term
NSQ_HD float nsq_ltp_pred(const float* ltp, const float* b_k, int t, int lag,
                          bool voiced, int e_col = -1, float e_ltp = 0.0f) {
  float p[NSQ_LTP];
#pragma unroll
  for (int j = 0; j < NSQ_LTP; ++j)
    p[j] = NSQ_FMUL(b_k[j], nsq_plane(ltp, nsq_clampi(t - lag + 2 - j, 0,
                                                     NSQ_ML - 1),
                                      e_col, e_ltp));
  return voiced ? nsq_sum<NSQ_LTP>(p, NSQ_LTP) : 0.0f;
}

NSQ_HD float nsq_n_ltp(const float* shp, float harm, int t, int lag,
                       int e_col = -1, float e_shp = 0.0f) {
  if (lag <= 0) return 0.0f;
  const float h0 =
      nsq_plane(shp, nsq_clampi(t - lag + 1, 0, NSQ_ML - 1), e_col, e_shp);
  const float h1 =
      nsq_plane(shp, nsq_clampi(t - lag, 0, NSQ_ML - 1), e_col, e_shp);
  const float h2 =
      nsq_plane(shp, nsq_clampi(t - lag - 1, 0, NSQ_ML - 1), e_col, e_shp);
  return NSQ_FMUL(harm, NSQ_FADD(NSQ_FMUL(0.25f, NSQ_FADD(h0, h2)),
                                 NSQ_FMUL(0.5f, h1)));
}

// x - (lpc_pred + ltp_pred - n_ar - n_lf - n_ltp), left to right
NSQ_HD float nsq_residual(float x, float lpc_pred, float ltp_pred, float n_ar,
                          float n_lf, float n_ltp) {
  return NSQ_FSUB(x, NSQ_FSUB(NSQ_FSUB(NSQ_FSUB(NSQ_FADD(lpc_pred, ltp_pred),
                                                n_ar), n_lf), n_ltp));
}

// ------------------------------------------------------------- the lanes

// The lane-level code of the sample loops, written once for both builds.
// A lane variable (NSQ_LANE_VAR) holds one value a lane; an NSQ_LANES
// block is what each lane runs for itself, `lane` its index; NSQ_MY is
// the running lane's value and NSQ_OF(v, src) lane src's (src taken
// modulo 32). On the device a lane variable is the thread's register and
// NSQ_OF a shuffle, so every lane of the warp runs each NSQ_OF (never in
// one arm of a condition); on the host a lane variable is an array of 32
// and an NSQ_LANES block a loop over the lanes, so a block reads with
// NSQ_OF only lane variables it does not write. Code outside the blocks
// is the same on every lane of a warp (the host runs it once).
// NSQ_EACH_STATE runs its body for the trellis state of the thread's warp
// (the host: for each of the four in turn), whose registers sit at
// NSQ_SLOT(n).
#define NSQ_WARP 32
#if defined(__CUDA_ARCH__)
#define NSQ_LANE_SLOTS 1
#define NSQ_MY(v) ((v)[0])
#define NSQ_OF(v, src) \
  __shfl_sync(0xffffffffu, (v)[0], (src) & (NSQ_WARP - 1))
#define NSQ_LANES                                                       \
  for (int lane = static_cast<int>(threadIdx.x) & (NSQ_WARP - 1),      \
           lanes_once_ = 1;                                             \
       lanes_once_; lanes_once_ = 0)
#define NSQ_SYNC_WARP() __syncwarp()
#define NSQ_STATE_SLOTS 1
#define NSQ_EACH_STATE(n)                                               \
  for (int n = static_cast<int>(threadIdx.x) / NSQ_WARP, states_once_ = 1; \
       states_once_; states_once_ = 0)
#define NSQ_SLOT(n) 0
#else
#define NSQ_LANE_SLOTS NSQ_WARP
#define NSQ_MY(v) ((v)[lane])
#define NSQ_OF(v, src) ((v)[(src) & (NSQ_WARP - 1)])
#define NSQ_LANES for (int lane = 0; lane < NSQ_WARP; ++lane)
#define NSQ_SYNC_WARP() ((void)0)
#define NSQ_STATE_SLOTS NSQ_STATES
#define NSQ_EACH_STATE(n) for (int n = 0; n < NSQ_STATES; ++n)
#define NSQ_SLOT(n) (n)
#endif
#define NSQ_LANE_VAR(T, v) T v[NSQ_LANE_SLOTS]

// The W lane partials of nsq_sum's lanes over products held one a lane
// (product m on lane base + m), the products from top on left out, on
// every lane: lane l < W gathers its column and adds it up (nsq_partial),
// then each lane takes the W partials.
template <int MAXN, int W>
NSQ_HD void nsq_lanes_parts(const float* p, int top, int base, float* parts) {
  constexpr int kCols = (MAXN + W - 1) / W;
  NSQ_LANE_VAR(float, part);
  NSQ_LANES {
    float col[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) col[c] = NSQ_OF(p, base + lane + c * W);
    NSQ_MY(part) = nsq_partial<MAXN, W>(col, lane, top);
  }
#pragma unroll
  for (int l = 0; l < W; ++l) parts[l] = NSQ_OF(part, l);
}

// the sum of n products one a lane in nsq_sum's order, on every lane
template <int MAXN>
NSQ_HD float nsq_lanes_sum(const float* p, int n, int base) {
  if (n >= 8) {
    float parts[8];
    nsq_lanes_parts<MAXN, 8>(p, n, base, parts);
    return nsq_combine<8>(parts, n);
  }
  float parts[4];
  nsq_lanes_parts<8, 4>(p, n, base, parts);
  return nsq_combine<4>(parts, n);
}

// The same sum less its last product (n - 1) where that is the last entry
// of the last lane added (n a multiple of the lane width W,
// nsq_lanes_split): *head = the partials of lanes 0 .. W - 2 added in
// order, *rest = lane W - 1's partial without the last product (unused
// where n == W). nsq_lanes_tail adds the last product to them, in
// nsq_sum's order.
template <int MAXN>
NSQ_HD void nsq_lanes_head(const float* p, int n, int base, float* head,
                           float* rest) {
  if (n >= 8) {
    float parts[8];
    nsq_lanes_parts<MAXN, 8>(p, n - 1, base, parts);
    *head = nsq_combine<8>(parts, 7);
    *rest = parts[7];
  } else {
    float parts[4];
    nsq_lanes_parts<8, 4>(p, n - 1, base, parts);
    *head = nsq_combine<4>(parts, 3);
    *rest = parts[3];
  }
}

NSQ_HD float nsq_lanes_tail(float head, float rest, float last, int n) {
  const int w = n >= 8 ? 8 : 4;
  return NSQ_FADD(head, n == w ? last : NSQ_FADD(rest, last));
}

// whether nsq_lanes_head can split a sum of n products
NSQ_HD bool nsq_lanes_split(int n) { return n % (n >= 8 ? 8 : 4) == 0; }

// N floats of shared memory (16-byte aligned, N a multiple of 4) into
// registers, four a load on the device
template <int N>
NSQ_HD void nsq_load(const float* p, float* out) {
#pragma unroll
  for (int m = 0; m < N; m += 4) {
#if defined(__CUDA_ARCH__)
    const float4 v = *reinterpret_cast<const float4*>(p + m);
    out[m] = v.x;
    out[m + 1] = v.y;
    out[m + 2] = v.z;
    out[m + 3] = v.w;
#else
    for (int j = 0; j < 4; ++j) out[m + j] = p[m + j];
#endif
  }
}

// The parts of a sample that the clock probe times (tools/nsq_probe.cu
// defines NSQ_PROBE_BEGIN, NSQ_PROBE, NSQ_PROBE_SKIP and NSQ_PROBE_END:
// NSQ_PROBE(part) adds the cycles since the last mark to `part`,
// NSQ_PROBE_SKIP marks without adding, NSQ_PROBE_END adds a function's
// sums to the thread's record). Empty in the kernels' own build and in the
// host build.
enum NsqProbePart {
  kProbePrologue,  // a subframe's prologue, its barriers included
  kProbeReads,     // the LTP prediction and the harmonic term
  kProbeDots,      // the LPC and shaping dot products
  kProbeCand,      // the residual and the candidates, what a state publishes
  kProbeBarrier,   // the delayed decision's barrier
  kProbeDecide,    // the decisions (single state: the pulse)
  kProbeReplace,   // the replacement of a state
  kProbeEmit,      // the planes written (the delayed emission)
  kProbeAdvance,   // the rotation and the rings; the windows moved
  kProbeFlush,     // the flushes and the outputs
  kProbeParts
};
#ifndef NSQ_PROBE
#define NSQ_PROBE_BEGIN()
#define NSQ_PROBE(part)
#define NSQ_PROBE_SKIP()
#define NSQ_PROBE_END()
#endif

// --------------------------------------------------- the single state

// one stream's planes (the plain version's, column for column)
struct NsqFrameWork {
  float xq[NSQ_ML], shp[NSQ_ML], ltp[NSQ_ML];
  float x_sc[NSQ_SUB];
  int32_t pulses[NSQ_L];
};

// The samples of subframe k on warp 0. The delay lines are windows over
// its lanes, oldest first: at sample n lane m holds the xq of time n - 16 +
// m (lanes 0-15) and the diff of time n - 24 + m (lanes 0-23), with the LPC
// coefficient a_k[15 - m] and the shaping one ar_k[23 - m] (a_l, ar_l; on
// the lanes the order reaches). The newest value is the last product that
// nsq_sum adds (the LPC sum's product 15; the shaping sum's product order -
// 1 where the order is a multiple of the lane width, kSplitAr), so each
// sample forms the next one's sums but that product from the window moved
// down a lane while it decides, and the next sample adds the product of
// the newest value to them (nsq_lanes_tail). The rest of a sample is the
// same on every lane; lane 0 writes the planes. (Reading the next sample's
// LTP and harmonic columns early as well, where the lag allows, was no
// faster on the card.)
template <bool kSplitAr>
NSQ_HD void nsq_frame_samples(const NsqArgs& g, int s, int k, const NsqSub& sf,
                              NsqFrameWork& w, float* win_lpc, float* win_ar,
                              const float* a_l, const float* ar_l,
                              int32_t& seed, float& s_lf_ar, float& s_diff,
                              float lam, float offset, float rdo,
                              bool use_dz) {
  const int order = g.order, fo = k * NSQ_SUB;
  const bool voiced = g.voiced[s] != 0;
  const float* b_k = g.b + (s * NSQ_NB + k) * NSQ_LTP;
  const float harm = g.harm[s * NSQ_NB + k], tilt = g.tilt[s * NSQ_NB + k];
  const float lf_ma = g.lf_ma[s * NSQ_NB + k];
  const float lf_ar_c = g.lf_ar[s * NSQ_NB + k];
  // the newest values' coefficients (lanes 15 and 23)
  const float a_new = nsq_a_k(g, s, k)[0];
  const float ar_new = g.ar_shp[(s * NSQ_NB + k) * NSQ_SHAPE];
  // sample 0's parts, as each sample forms them for the next
  float lpc_head, lpc_rest, ar_head = 0.0f, ar_rest = 0.0f;
  {
    NSQ_LANE_VAR(float, p_lpc);
    NSQ_LANE_VAR(float, p_ar);
    NSQ_LANES {
      NSQ_MY(p_lpc) = NSQ_FMUL(NSQ_MY(a_l), NSQ_MY(win_lpc));
      NSQ_MY(p_ar) = NSQ_FMUL(NSQ_MY(ar_l), NSQ_MY(win_ar));
    }
    nsq_lanes_head<NSQ_LPC>(p_lpc, NSQ_LPC, 0, &lpc_head, &lpc_rest);
    if (kSplitAr)
      nsq_lanes_head<NSQ_SHAPE>(p_ar, order, NSQ_SHAPE - order, &ar_head,
                                &ar_rest);
  }
  float xq_new = NSQ_OF(win_lpc, NSQ_LPC - 1);
  float diff_new = NSQ_OF(win_ar, NSQ_SHAPE - 1);
  float shp_prev = w.shp[NSQ_M + fo - 1];
  NSQ_PROBE_BEGIN();
  for (int i = 0; i < NSQ_SUB; ++i) {
    const int n = fo + i, t = NSQ_M + n;
    seed = nsq_rand(seed);
    const float ltp_pred = nsq_ltp_pred(w.ltp, b_k, t, sf.lag, voiced);
    const float n_ltp = nsq_n_ltp(w.shp, harm, t, sf.lag);
    const float x_i = w.x_sc[i];
    NSQ_PROBE(kProbeReads);
    const float lpc_pred = nsq_lanes_tail(lpc_head, lpc_rest,
                                          NSQ_FMUL(a_new, xq_new), NSQ_LPC);
    float ar_dot;
    if (kSplitAr) {
      ar_dot = nsq_lanes_tail(ar_head, ar_rest, NSQ_FMUL(ar_new, diff_new),
                              order);
    } else {
      NSQ_LANE_VAR(float, p_ar);
      NSQ_LANES { NSQ_MY(p_ar) = NSQ_FMUL(NSQ_MY(ar_l), NSQ_MY(win_ar)); }
      ar_dot = nsq_lanes_sum<NSQ_SHAPE>(p_ar, order, NSQ_SHAPE - order);
    }
    NSQ_PROBE(kProbeDots);
    // the windows moved down a lane (the newest values enter at the end
    // of the sample), and the next sample's parts from them
    NSQ_LANE_VAR(float, up_lpc);
    NSQ_LANE_VAR(float, up_ar);
    NSQ_LANE_VAR(float, p_lpc);
    NSQ_LANE_VAR(float, p_ar);
    NSQ_LANES {
      // every lane takes part in the shuffles, the last ones too
      NSQ_MY(up_lpc) = NSQ_OF(win_lpc, lane + 1);
      NSQ_MY(up_ar) = NSQ_OF(win_ar, lane + 1);
      NSQ_MY(p_lpc) = NSQ_FMUL(NSQ_MY(a_l), NSQ_MY(up_lpc));
      NSQ_MY(p_ar) = NSQ_FMUL(NSQ_MY(ar_l), NSQ_MY(up_ar));
    }
    nsq_lanes_head<NSQ_LPC>(p_lpc, NSQ_LPC, 0, &lpc_head, &lpc_rest);
    if (kSplitAr)
      nsq_lanes_head<NSQ_SHAPE>(p_ar, order, NSQ_SHAPE - order, &ar_head,
                                &ar_rest);
    NSQ_PROBE(kProbeAdvance);
    const float n_ar = NSQ_FADD(ar_dot, NSQ_FMUL(tilt, s_lf_ar));
    const float n_lf = NSQ_FADD(NSQ_FMUL(lf_ma, shp_prev),
                                NSQ_FMUL(lf_ar_c, s_lf_ar));
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
    xq_new = NSQ_FADD(lpc_exc, lpc_pred);
    s_diff = NSQ_FSUB(xq_new, x_i);
    diff_new = s_diff;
    s_lf_ar = NSQ_FSUB(s_diff, n_ar);
    shp_prev = NSQ_FSUB(s_lf_ar, n_lf);
    seed = nsq_add_wrap(seed, q0);
    NSQ_PROBE(kProbeDecide);
    NSQ_LANES {
      if (lane == 0) {
        w.xq[t] = NSQ_FMUL(xq_new, sf.gain);
        w.shp[t] = shp_prev;
        w.ltp[t] = lpc_exc;
        w.pulses[n] = q0;
      }
      NSQ_MY(win_lpc) = lane == NSQ_LPC - 1 ? xq_new : NSQ_MY(up_lpc);
      NSQ_MY(win_ar) = lane == NSQ_SHAPE - 1 ? s_diff : NSQ_MY(up_ar);
    }
    // lane 0's plane columns, read by every lane at the next sample
    NSQ_SYNC_WARP();
    NSQ_PROBE(kProbeEmit);
  }
  NSQ_PROBE_END();
}

NSQ_HD void nsq_frame_stream(const NsqArgs& g, int s, NsqFrameWork& w,
                             int tid, int nthr) {
  const int order = g.order;
  const bool voiced = g.voiced[s] != 0;
  for (int c = tid; c < NSQ_ML; c += nthr) {
    w.xq[c] = c < NSQ_M ? g.xq[s * NSQ_M + c] : 0.0f;
    w.shp[c] = c < NSQ_M ? g.shp[s * NSQ_M + c] : 0.0f;
    w.ltp[c] = 0.0f;
  }
  NSQ_LANE_VAR(float, win_lpc);
  NSQ_LANE_VAR(float, win_ar);
  NSQ_LANE_VAR(float, a_l);
  NSQ_LANE_VAR(float, ar_l);
  NSQ_LANES {
    NSQ_MY(win_lpc) =
        lane < NSQ_LPC ? g.s_lpc[s * NSQ_LPC + NSQ_LPC - 1 - lane] : 0.0f;
    NSQ_MY(win_ar) = lane < NSQ_SHAPE
                         ? g.s_ar2[s * NSQ_SHAPE + NSQ_SHAPE - 1 - lane]
                         : 0.0f;
  }
  // the carried scalars, the same on every thread
  float s_lf_ar = g.s_lf_ar[s], s_diff = g.s_diff[s];
  float prev_gain = g.prev_gain[s];
  int lag_state = g.lag_prev[s];
  int32_t seed = g.seed[s];
  const float lam = g.lam[s], offset = g.offset[s];
  const float rdo = NSQ_FSUB(NSQ_FMUL(0.5f, lam), 0.5f);
  const bool use_dz = lam > 2.0f;
  const bool split_ar = nsq_lanes_split(order);
  NSQ_PROBE_BEGIN();
  NSQ_SYNC();
  for (int k = 0; k < NSQ_NB; ++k) {
    const int fo = k * NSQ_SUB;
    const NsqSub sf = nsq_subframe(g, s, k, lag_state, prev_gain);
    const float* a_k = nsq_a_k(g, s, k);
    const float* ar_k = g.ar_shp + (s * NSQ_NB + k) * NSQ_SHAPE;
    nsq_prologue_cols(w.xq, w.shp, w.ltp, a_k, sf, voiced, k, NSQ_M + fo,
                      tid, nthr);
    for (int c = tid; c < NSQ_SUB; c += nthr)
      w.x_sc[c] = NSQ_FMUL(g.x[s * NSQ_L + fo + c], sf.inv_gain);
    NSQ_LANES {
      if (lane < NSQ_LPC) NSQ_MY(win_lpc) = NSQ_FMUL(NSQ_MY(win_lpc), sf.adj);
      if (lane < NSQ_SHAPE) NSQ_MY(win_ar) = NSQ_FMUL(NSQ_MY(win_ar), sf.adj);
      NSQ_MY(a_l) = lane < NSQ_LPC ? a_k[NSQ_LPC - 1 - lane] : 0.0f;
      NSQ_MY(ar_l) = lane < NSQ_SHAPE && lane >= NSQ_SHAPE - order
                         ? ar_k[NSQ_SHAPE - 1 - lane] : 0.0f;
    }
    s_lf_ar = NSQ_FMUL(s_lf_ar, sf.adj);
    s_diff = NSQ_FMUL(s_diff, sf.adj);
    prev_gain = sf.gain;
    NSQ_SYNC();
    NSQ_PROBE(kProbePrologue);
    if (tid < NSQ_WARP) {
      if (split_ar)
        nsq_frame_samples<true>(g, s, k, sf, w, win_lpc, win_ar, a_l, ar_l,
                                seed, s_lf_ar, s_diff, lam, offset, rdo,
                                use_dz);
      else
        nsq_frame_samples<false>(g, s, k, sf, w, win_lpc, win_ar, a_l, ar_l,
                                 seed, s_lf_ar, s_diff, lam, offset, rdo,
                                 use_dz);
    }
    NSQ_PROBE_SKIP();
    lag_state = sf.lag;
    NSQ_SYNC();
  }
  // the windows and scalars of the sample loop, from warp 0
  for (int c = tid; c < NSQ_L; c += nthr) {
    g.pulses[s * NSQ_L + c] = w.pulses[c];
    g.xq_frame[s * NSQ_L + c] = w.xq[NSQ_M + c];
  }
  for (int c = tid; c < NSQ_M; c += nthr) {
    g.o_xq[s * NSQ_M + c] = w.xq[NSQ_L + c];
    g.o_shp[s * NSQ_M + c] = w.shp[NSQ_L + c];
  }
  if (tid < NSQ_WARP) {
    NSQ_LANES {
      if (lane < NSQ_LPC)
        g.o_s_lpc[s * NSQ_LPC + NSQ_LPC - 1 - lane] = NSQ_MY(win_lpc);
      if (lane < NSQ_SHAPE)
        g.o_s_ar2[s * NSQ_SHAPE + NSQ_SHAPE - 1 - lane] = NSQ_MY(win_ar);
    }
  }
  if (tid == 0) {
    g.o_s_lf_ar[s] = s_lf_ar;
    g.o_s_diff[s] = s_diff;
    g.o_lag_prev[s] = voiced ? g.pitch_l[s * NSQ_NB + NSQ_NB - 1] : 0;
    g.o_prev_gain[s] = prev_gain;
  }
  NSQ_PROBE(kProbeFlush);
  NSQ_PROBE_END();
}

// ------------------------------------------------- the delayed decision

enum { kRingQ, kRingXq, kRingPred, kRingShape, kRings };
// a candidate's values: vq, lexc, xqv, d, lfar, shape
enum { kCandVq, kCandLexc, kCandXq, kCandD, kCandLfar, kCandShape, kCands };

// one trellis state's rings and dither history (a replacement copies them)
struct NsqDDRings {
  float ring[kRings][NSQ_DD];
  int32_t r_rand[NSQ_DD];
};

// What a state publishes at a sample, before the barrier: the decisions'
// inputs, and what a state that replaces it or the emission take from it.
struct alignas(16) NsqDDPub {
  float rhs[NSQ_SHAPE];  // the rotation's right-hand side; rhs[0] less d
  float s_lpc[NSQ_LPC];
  float cand1[kCands];   // the runner-up candidate
  float rd[2];           // the head's and the runner-up's costs
  float last[kRings];    // the rings at the emitted column `last`
  int32_t rr_last, seed, seed_init;
};

struct NsqDDWork {
  float xq[NSQ_ML], shp[NSQ_ML], ltp[NSQ_ML];
  float x_sc[NSQ_SUB];
  float delayed_gain[NSQ_DD];
  int32_t pulses[NSQ_L];
  NsqDDRings st[NSQ_STATES];
  NsqDDPub pub[2][NSQ_STATES];   // by the sample's parity
  float rd[NSQ_STATES];          // each state's cost at a flush
};

// a state's scalars, the same on each of its lanes
struct NsqDDWarp {
  float rd, lf_ar, diff;
  int32_t seed, seed_init;
  float cand0[kCands];   // the sample's head candidate
  float xq_new;          // s_lpc[0], the newest xq
  // the next LPC sum but its first product (a_k[0] s_lpc[0]): product 8,
  // then the partials of lanes 1-7, in nsq_sum's order
  float lpc_rest[8];
};

// The states' registers (on the device the thread's state and lane, on
// the host all of them): a state's scalars; a lane's part of its filter
// state (s_lpc[lane] on lanes 0-15, newest first; s_ar2[lane] on the lanes
// below the order), the subframe's coefficients a_k[lane] and
// ar_k[lane], and row `lane` of the rotation Lw (zeros past the diagonal).
struct NsqDDRegs {
  NsqDDWarp st[NSQ_STATE_SLOTS];
  float s_lpc[NSQ_STATE_SLOTS][NSQ_LANE_SLOTS];
  float s_ar2[NSQ_STATE_SLOTS][NSQ_LANE_SLOTS];
  float a[NSQ_STATE_SLOTS][NSQ_LANE_SLOTS];
  float ar[NSQ_STATE_SLOTS][NSQ_LANE_SLOTS];
  float lw[NSQ_STATE_SLOTS][NSQ_LANE_SLOTS][NSQ_SHAPE];
};

// a candidate's values from its pulse level vq
NSQ_HD void nsq_dd_values(float vq, float sgn, float ltp_pred,
                          float lpc_pred, float x_i, float n_ar, float n_lf,
                          float* c) {
  const float lexc = NSQ_FADD(NSQ_FMUL(sgn, vq), ltp_pred);
  const float xqv = NSQ_FADD(lexc, lpc_pred);
  const float d = NSQ_FSUB(xqv, x_i);
  const float lfar = NSQ_FSUB(d, n_ar);
  c[kCandVq] = vq;
  c[kCandLexc] = lexc;
  c[kCandXq] = xqv;
  c[kCandD] = d;
  c[kCandLfar] = lfar;
  c[kCandShape] = NSQ_FSUB(lfar, n_lf);
}

// a state's two candidates at a sample: the costs (head, runner-up) into
// rd and their values into c0 and c1
NSQ_HD void nsq_dd_candidates(float sgn, float rd_state, float x_i,
                              float lpc_pred, float ltp_pred, float n_ar,
                              float n_lf, float n_ltp, float lam,
                              float offset, float rdo, bool use_dz,
                              float* rd, float* c0, float* c1) {
  float r = nsq_residual(x_i, lpc_pred, ltp_pred, n_ar, n_lf, n_ltp);
  r = nsq_clampf(NSQ_FMUL(sgn, r), -31.0f, 30.0f);
  const int q0 = nsq_dead_zone(r, offset, rdo, use_dz);
  const float v1 = nsq_level(q0, offset);
  const float v2 = q0 == 0 ? NSQ_FADD(v1, NSQ_ONE_QLA)
                           : (q0 == -1 ? offset : NSQ_FADD(v1, 1.0f));
  const float rd1 = nsq_rd(lam, r, v1), rd2 = nsq_rd(lam, r, v2);
  const bool swap = rd2 < rd1;
  rd[0] = NSQ_FADD(rd_state, swap ? rd2 : rd1);
  rd[1] = NSQ_FADD(rd_state, swap ? rd1 : rd2);
  nsq_dd_values(swap ? v2 : v1, sgn, ltp_pred, lpc_pred, x_i, n_ar, n_lf, c0);
  nsq_dd_values(swap ? v1 : v2, sgn, ltp_pred, lpc_pred, x_i, n_ar, n_lf, c1);
}

// the decisions of a sample over the four states: the winner, the
// rand-consistency penalty (added after rd + rd1 / rd2, as a float32
// add), the worst head mx and the best runner-up mn; ties go to the lowest
// index (torch.argmin / argmax). The four states' costs and dither are
// read once; the extremes are carried as values, not read back by an
// index known at run time (which would put the arrays in local memory).
struct NsqDDDecision {
  int win, mx, mn;
  bool rep;          // state mx takes state mn's runner-up
  float c1_best;
  float c0_own;      // state `own`'s head cost after the penalty
};

NSQ_HD NsqDDDecision nsq_dd_decide(const NsqDDPub* pub, int own) {
  float rd0[NSQ_STATES], rd1[NSQ_STATES];
  int32_t rr[NSQ_STATES];
#pragma unroll
  for (int n = 0; n < NSQ_STATES; ++n) {
    rd0[n] = pub[n].rd[0];
    rd1[n] = pub[n].rd[1];
    rr[n] = pub[n].rr_last;
  }
  NsqDDDecision d;
  d.win = 0;
  float best = rd0[0];
  int32_t rr_win = rr[0];
#pragma unroll
  for (int n = 1; n < NSQ_STATES; ++n) {
    if (rd0[n] < best) {
      d.win = n;
      best = rd0[n];
      rr_win = rr[n];
    }
  }
  d.mx = 0;
  d.mn = 0;
  float c0_mx = 0.0f, c1_mn = 0.0f;
  d.c0_own = 0.0f;
#pragma unroll
  for (int n = 0; n < NSQ_STATES; ++n) {
    const bool bad = rr[n] != rr_win;
    const float c0 = bad ? NSQ_FADD(rd0[n], NSQ_BIG_RD) : rd0[n];
    const float c1 = bad ? NSQ_FADD(rd1[n], NSQ_BIG_RD) : rd1[n];
    if (n == 0 || c0 > c0_mx) {
      d.mx = n;
      c0_mx = c0;
    }
    if (n == 0 || c1 < c1_mn) {
      d.mn = n;
      c1_mn = c1;
    }
    if (n == own) d.c0_own = c0;
  }
  d.c1_best = c1_mn;
  d.rep = c1_mn < c0_mx;
  return d;
}

NSQ_HD float nsq_gain(const NsqArgs& g, int s, int k) {
  const float gk = g.gains[s * NSQ_NB + k];
  return gk < NSQ_MIN_GAIN ? NSQ_MIN_GAIN : gk;
}

// A flush: every state's cost published, the winner's dd delayed samples
// committed by thread 0 to the columns [fo - dd, fo) of the pulses and of
// the xq and shaping planes, the other states penalised; returns the
// winner.
NSQ_HD int nsq_dd_flush(NsqDDWork& w, NsqDDRegs& r, float gain, int fo,
                        int dd, int head, int tid) {
  NSQ_EACH_STATE(n) {
    NSQ_LANES {
      if (lane == 0) w.rd[n] = r.st[NSQ_SLOT(n)].rd;
    }
  }
  NSQ_SYNC();
  int win = 0;
#pragma unroll
  for (int n = 1; n < NSQ_STATES; ++n)
    if (w.rd[n] < w.rd[win]) win = n;
  if (tid == 0) {
    const NsqDDRings& st = w.st[win];
    for (int i = 0; i < dd; ++i) {
      const int last = (head + dd + NSQ_DD - 1 - i) % NSQ_DD;
      const int col = fo - dd + i;
      w.pulses[col] = static_cast<int32_t>(
          floorf(NSQ_FADD(st.ring[kRingQ][last], 0.5f)));
      w.xq[NSQ_M + col] = NSQ_FMUL(st.ring[kRingXq][last], gain);
      w.shp[NSQ_M + col] = st.ring[kRingShape][last];
    }
  }
  NSQ_EACH_STATE(n) {
    if (n != win) {
      NsqDDWarp& st = r.st[NSQ_SLOT(n)];
      st.rd = NSQ_FADD(st.rd, NSQ_BIG_RD);
    }
  }
  NSQ_SYNC();
  return win;
}

// A sample of the four states, each on its warp: (A) the state's two
// candidates from its registers (the dot products over its lanes), and
// what the others may need published; one barrier; (B) the decisions on
// every lane from the published costs, the replaced state's registers,
// rings and dither taken from the state it copies, the winner's delayed
// emission by thread 0 (its values from what the winner published, and
// forwarded to every state's next sample through e_col / e_ltp / e_shp,
// since thread 0 may write the planes after another warp reads them), and
// the advance: row `lane` of the warped rotation on each lane below the
// order (its Lw row in registers, the right-hand side from the published
// one), the LPC history moved down a lane, the rings at the new head.
NSQ_HD void nsq_dd_stream(const NsqArgs& g, int s, NsqDDWork& w,
                          NsqDDRegs& r, int tid, int nthr) {
  const int order = g.order;
  const bool voiced = g.voiced[s] != 0, interp = g.interp[s] != 0;
  const int lag_prev = g.lag_prev[s];
  for (int c = tid; c < NSQ_ML; c += nthr) {
    w.xq[c] = c < NSQ_M ? g.xq[s * NSQ_M + c] : 0.0f;
    w.shp[c] = c < NSQ_M ? g.shp[s * NSQ_M + c] : 0.0f;
    w.ltp[c] = 0.0f;
  }
  for (int c = tid; c < NSQ_L; c += nthr) w.pulses[c] = 0;
  for (int c = tid; c < NSQ_DD; c += nthr) w.delayed_gain[c] = 0.0f;
  const float* lw = g.lw + s * g.lw_stride;
  NSQ_EACH_STATE(n) {
    const int q = NSQ_SLOT(n);
    NsqDDWarp& st = r.st[q];
    st.rd = 0.0f;
    st.lf_ar = g.s_lf_ar[s];
    st.diff = g.s_diff[s];
    st.seed = static_cast<int32_t>(
        (static_cast<uint32_t>(n) + (static_cast<uint32_t>(g.seed[s]) & 3u))
        & 3u);
    st.seed_init = st.seed;
    NsqDDRings& rings = w.st[n];
    NSQ_LANES {
      NSQ_MY(r.s_lpc[q]) = lane < NSQ_LPC ? g.s_lpc[s * NSQ_LPC + lane] : 0.0f;
      NSQ_MY(r.s_ar2[q]) =
          lane < order ? g.s_ar2[s * NSQ_SHAPE + lane] : 0.0f;
      float* row = NSQ_MY(r.lw[q]);
#pragma unroll
      for (int m = 0; m < NSQ_SHAPE; ++m)
        row[m] = lane < order && m <= lane ? lw[lane * order + m] : 0.0f;
      for (int e = lane; e < NSQ_DD; e += NSQ_WARP) {
        rings.r_rand[e] = 0;
#pragma unroll
        for (int p = 0; p < kRings; ++p)
          rings.ring[p][e] = p == kRingShape && e == 0
                                 ? g.shp[s * NSQ_M + NSQ_M - 1] : 0.0f;
      }
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
  NSQ_PROBE_BEGIN();
  NSQ_SYNC();
  for (int k = 0; k < NSQ_NB; ++k) {
    const int fo = k * NSQ_SUB;
    // the ring head, equal for all streams, one step down a sample
    int head = (NSQ_DD - fo % NSQ_DD) % NSQ_DD;
    // the mid-frame flush before the re-whitening, for the voiced and
    // interpolated streams (the others are left as they are)
    if (k == 2 && flush2)
      nsq_dd_flush(w, r, nsq_gain(g, s, 1), fo, dd, head, tid);
    const NsqSub sf = nsq_subframe(g, s, k, lag_state, prev_gain);
    const float* a_k = nsq_a_k(g, s, k);
    const float* ar_k = g.ar_shp + (s * NSQ_NB + k) * NSQ_SHAPE;
    nsq_prologue_cols(w.xq, w.shp, w.ltp, a_k, sf, voiced, k,
                      NSQ_M + fo - dd, tid, nthr);
    for (int c = tid; c < NSQ_SUB; c += nthr)
      w.x_sc[c] = NSQ_FMUL(g.x[s * NSQ_L + fo + c], sf.inv_gain);
    NSQ_EACH_STATE(n) {
      const int q = NSQ_SLOT(n);
      NsqDDWarp& st = r.st[q];
      st.lf_ar = NSQ_FMUL(st.lf_ar, sf.adj);
      st.diff = NSQ_FMUL(st.diff, sf.adj);
      NsqDDRings& rings = w.st[n];
      NSQ_LANES {
        if (lane < NSQ_LPC)
          NSQ_MY(r.s_lpc[q]) = NSQ_FMUL(NSQ_MY(r.s_lpc[q]), sf.adj);
        if (lane < order)
          NSQ_MY(r.s_ar2[q]) = NSQ_FMUL(NSQ_MY(r.s_ar2[q]), sf.adj);
        for (int e = lane; e < NSQ_DD; e += NSQ_WARP) {
          rings.ring[kRingPred][e] =
              NSQ_FMUL(rings.ring[kRingPred][e], sf.adj);
          rings.ring[kRingShape][e] =
              NSQ_FMUL(rings.ring[kRingShape][e], sf.adj);
        }
        NSQ_MY(r.a[q]) = lane < NSQ_LPC ? a_k[lane] : 0.0f;
        NSQ_MY(r.ar[q]) = lane < order ? ar_k[lane] : 0.0f;
      }
    }
    prev_gain = sf.gain;
    NSQ_SYNC();
    NSQ_PROBE(kProbePrologue);
    const float* b_k = g.b + (s * NSQ_NB + k) * NSQ_LTP;
    const float harm = g.harm[s * NSQ_NB + k], tilt = g.tilt[s * NSQ_NB + k];
    const float lf_ma = g.lf_ma[s * NSQ_NB + k];
    const float lf_ar_c = g.lf_ar[s * NSQ_NB + k];
    const float a_first = a_k[0];
    // the column the last sample emitted (-1: none) and its LTP and
    // shaping values
    int e_col = -1;
    float e_ltp = 0.0f, e_shp = 0.0f;
    for (int i = 0; i < NSQ_SUB; ++i) {
      const int t = NSQ_M + fo + i;
      const int head_new = (head + NSQ_DD - 1) % NSQ_DD;
      const int last = (head_new + dd) % NSQ_DD;
      NsqDDPub* pub = w.pub[i & 1];
      const float ltp_pred =
          nsq_ltp_pred(w.ltp, b_k, t, sf.lag, voiced, e_col, e_ltp);
      const float n_ltp = nsq_n_ltp(w.shp, harm, t, sf.lag, e_col, e_shp);
      NSQ_PROBE(kProbeReads);
      NSQ_EACH_STATE(n) {
        const int q = NSQ_SLOT(n);
        NsqDDWarp& st = r.st[q];
        const NsqDDRings& rings = w.st[n];
        // the ring entries the sample reads, first
        const float shape_head = rings.ring[kRingShape][head];
        float at_last[kRings];
#pragma unroll
        for (int p = 0; p < kRings; ++p) at_last[p] = rings.ring[p][last];
        const int32_t rr_last = rings.r_rand[last];
        st.seed = nsq_rand(st.seed);
        NSQ_LANE_VAR(float, p_lpc);
        NSQ_LANE_VAR(float, p_ar);
        NSQ_LANES {
          NSQ_MY(p_lpc) = NSQ_FMUL(NSQ_MY(r.a[q]), NSQ_MY(r.s_lpc[q]));
          NSQ_MY(p_ar) = NSQ_FMUL(NSQ_MY(r.ar[q]), NSQ_MY(r.s_ar2[q]));
        }
        float lpc_pred;
        if (i > 0) {
          // the sum's other parts were formed in the last sample's advance
          lpc_pred = NSQ_FADD(NSQ_FMUL(a_first, st.xq_new), st.lpc_rest[0]);
#pragma unroll
          for (int l = 1; l < 8; ++l)
            lpc_pred = NSQ_FADD(lpc_pred, st.lpc_rest[l]);
        } else {
          lpc_pred = nsq_lanes_sum<NSQ_LPC>(p_lpc, NSQ_LPC, 0);
        }
        const float n_ar = NSQ_FADD(nsq_lanes_sum<NSQ_SHAPE>(p_ar, order, 0),
                                    NSQ_FMUL(tilt, st.lf_ar));
        NSQ_PROBE(kProbeDots);
        const float n_lf = NSQ_FADD(NSQ_FMUL(lf_ma, shape_head),
                                    NSQ_FMUL(lf_ar_c, st.lf_ar));
        float rd[2], c1[kCands];
        nsq_dd_candidates(st.seed < 0 ? -1.0f : 1.0f, st.rd, w.x_sc[i],
                          lpc_pred, ltp_pred, n_ar, n_lf, n_ltp, lam, offset,
                          rdo, use_dz, rd, st.cand0, c1);
        NsqDDPub& mine = pub[n];
        NSQ_LANES {
          const float wa = NSQ_FMUL(warp, NSQ_MY(r.s_ar2[q]));
          const float prev = NSQ_OF(r.s_ar2[q], lane - 1);
          if (lane < NSQ_SHAPE)
            mine.rhs[lane] =
                lane == 0 ? wa : (lane < order ? NSQ_FADD(prev, wa) : 0.0f);
          if (lane < NSQ_LPC) mine.s_lpc[lane] = NSQ_MY(r.s_lpc[q]);
          if (lane == 0) {
            mine.rd[0] = rd[0];
            mine.rd[1] = rd[1];
#pragma unroll
            for (int e = 0; e < kCands; ++e) mine.cand1[e] = c1[e];
#pragma unroll
            for (int p = 0; p < kRings; ++p) mine.last[p] = at_last[p];
            mine.rr_last = rr_last;
            mine.seed = st.seed;
            mine.seed_init = st.seed_init;
          }
        }
        NSQ_PROBE(kProbeCand);
      }
      NSQ_SYNC();
      NSQ_PROBE(kProbeBarrier);
      const bool emit =
          k == 0 ? i >= dd : (k == 2 ? (!flush2 || i >= dd) : true);
      const int xcol = nsq_clampi(t - dd, 0, NSQ_ML - 1);
      NSQ_EACH_STATE(n) {
        const int q = NSQ_SLOT(n);
        NsqDDWarp& st = r.st[q];
        const NsqDDDecision d = nsq_dd_decide(pub, n);
        // the delayed emission from the winner as it stands after the
        // replacement (the same in every state)
        const NsqDDPub& ep = pub[d.rep && d.win == d.mx ? d.mn : d.win];
        e_col = emit ? xcol : -1;
        e_ltp = ep.last[kRingPred];
        e_shp = ep.last[kRingShape];
        NSQ_PROBE(kProbeDecide);
        const bool replaced = d.rep && n == d.mx;
        const NsqDDPub& src = pub[replaced ? d.mn : n];
        float c[kCands];
#pragma unroll
        for (int e = 0; e < kCands; ++e) {
          const float runner_up = src.cand1[e];
          c[e] = replaced ? runner_up : st.cand0[e];
        }
        NsqDDRings& rings = w.st[n];
        if (replaced) {
          st.seed = src.seed;
          st.seed_init = src.seed_init;
          // the rings but the new head, which the advance writes and the
          // copied state is writing
          const NsqDDRings& from = w.st[d.mn];
          NSQ_LANES {
            for (int e = lane; e < NSQ_DD; e += NSQ_WARP) {
              if (e == head_new) continue;
#pragma unroll
              for (int p = 0; p < kRings; ++p)
                rings.ring[p][e] = from.ring[p][e];
              rings.r_rand[e] = from.r_rand[e];
            }
          }
          NSQ_SYNC_WARP();
        }
        NSQ_PROBE(kProbeReplace);
        if (n == 0) {
          NSQ_LANES {
            if (lane == 0) {
              if (emit) {
                const int pcol = nsq_clampi(fo + i - dd, 0, NSQ_L - 1);
                w.pulses[pcol] = static_cast<int32_t>(
                    floorf(NSQ_FADD(ep.last[kRingQ], 0.5f)));
                w.xq[xcol] = NSQ_FMUL(ep.last[kRingXq], w.delayed_gain[last]);
                w.shp[xcol] = ep.last[kRingShape];
                w.ltp[xcol] = ep.last[kRingPred];
              }
              w.delayed_gain[head_new] = sf.gain;
            }
          }
        }
        NSQ_PROBE(kProbeEmit);
        NSQ_LANE_VAR(float, p_next);
        NSQ_LANES {
          // new_s[j] = sum_m rhs[m] Lw[j, m] over m <= j in nsq_sum's lanes
          const float* row = NSQ_MY(r.lw[q]);
          float p[NSQ_SHAPE];
          nsq_load<NSQ_SHAPE>(src.rhs, p);
          p[0] = NSQ_FADD(c[kCandD], p[0]);
#pragma unroll
          for (int m = 0; m < NSQ_SHAPE; ++m) p[m] = NSQ_FMUL(p[m], row[m]);
          if (lane < order)
            NSQ_MY(r.s_ar2[q]) = nsq_sum<NSQ_SHAPE>(p, order, lane + 1);
          const float older = src.s_lpc[(lane + NSQ_LPC - 1) % NSQ_LPC];
          if (lane < NSQ_LPC)
            NSQ_MY(r.s_lpc[q]) = lane == 0 ? c[kCandXq] : older;
          // the next LPC products but the newest (lane 0's)
          NSQ_MY(p_next) = NSQ_FMUL(NSQ_MY(r.a[q]), older);
        }
        // their lane partials (nsq_lanes_sum's, lane 0's without product 0)
        NSQ_LANE_VAR(float, part);
        NSQ_LANES {
          NSQ_MY(part) = NSQ_FADD(NSQ_MY(p_next), NSQ_OF(p_next, lane + 8));
        }
        st.lpc_rest[0] = NSQ_OF(p_next, 8);
#pragma unroll
        for (int l = 1; l < 8; ++l) st.lpc_rest[l] = NSQ_OF(part, l);
        st.xq_new = c[kCandXq];
        st.lf_ar = c[kCandLfar];
        st.diff = c[kCandD];
        st.seed = nsq_add_wrap(
            st.seed, static_cast<int32_t>(floorf(NSQ_FADD(c[kCandVq], 0.5f))));
        st.rd = replaced ? d.c1_best : d.c0_own;
        NSQ_LANES {
          if (lane == 0) {
            rings.ring[kRingQ][head_new] = c[kCandVq];
            rings.ring[kRingXq][head_new] = c[kCandXq];
            rings.ring[kRingPred][head_new] = c[kCandLexc];
            rings.ring[kRingShape][head_new] = c[kCandShape];
            rings.r_rand[head_new] = st.seed;
          }
        }
        // lane 0's ring entries, read by every lane at the next sample
        NSQ_SYNC_WARP();
        NSQ_PROBE(kProbeAdvance);
      }
      head = head_new;
    }
    lag_state = sf.lag;
    NSQ_SYNC();
  }
  const int win = nsq_dd_flush(w, r, nsq_gain(g, s, NSQ_NB - 1), NSQ_L, dd,
                               (NSQ_DD - NSQ_L % NSQ_DD) % NSQ_DD, tid);
  for (int c = tid; c < NSQ_L; c += nthr) g.pulses[s * NSQ_L + c] = w.pulses[c];
  for (int c = tid; c < NSQ_M; c += nthr) {
    g.o_xq[s * NSQ_M + c] = w.xq[NSQ_L + c];
    g.o_shp[s * NSQ_M + c] = w.shp[NSQ_L + c];
  }
  // the winner's state, from its warp
  NSQ_EACH_STATE(n) {
    if (n == win) {
      const int q = NSQ_SLOT(n);
      const NsqDDWarp& st = r.st[q];
      NSQ_LANES {
        if (lane < NSQ_LPC) g.o_s_lpc[s * NSQ_LPC + lane] = NSQ_MY(r.s_lpc[q]);
        if (lane < NSQ_SHAPE)
          g.o_s_ar2[s * NSQ_SHAPE + lane] =
              lane < order ? NSQ_MY(r.s_ar2[q]) : g.s_ar2[s * NSQ_SHAPE + lane];
        if (lane == 0) {
          g.o_s_lf_ar[s] = st.lf_ar;
          g.o_s_diff[s] = st.diff;
          g.seed_used[s] = st.seed_init;
        }
      }
    }
  }
  if (tid == 0) {
    g.o_lag_prev[s] = voiced ? g.pitch_l[s * NSQ_NB + NSQ_NB - 1] : 0;
    g.o_prev_gain[s] = prev_gain;
  }
  NSQ_PROBE(kProbeFlush);
  NSQ_PROBE_END();
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
  NsqDDRegs* r = static_cast<NsqDDRegs*>(malloc(sizeof(NsqDDRegs)));
  if (w == nullptr || r == nullptr) {
    free(w);
    free(r);
    return -1;
  }
  for (int s = 0; s < S; ++s) nsq_dd_stream(g, s, *w, *r, 0, 1);
  free(w);
  free(r);
  return 0;
}

}  // extern "C"
#endif  // SILK_NSQ_HOST_API

#endif  // MOUSIKI_SILK_NSQ_H_
