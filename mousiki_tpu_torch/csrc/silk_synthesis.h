// The arithmetic of the device SILK synthesis (ops/silk_synthesis.py), one
// stream at a time: the gain scale of the excitation, the 16-tap
// re-whitening of the carried output, the 5-tap LTP prediction of a chunk of
// 8 samples, the order-16 LPC synthesis, and the whole frame of one stream
// built from them.
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
// A frame runs in four parts (silk_syn_stream): the prologue (the loads,
// the scale and the history's re-whitening, spread over the block's
// threads), the LTP (silk_syn_ltp, on one warp, the producer), the LPC
// chain (silk_syn_chain_half, on another warp, the consumer) and the
// write-out. The LTP reads only the residual planes, never the output, so
// it runs ahead of the chain and hands it its chunks of 8 as a count in
// shared memory (release and acquire); in an interpolated frame the second
// half's LTP reads the first half's output re-whitened, which the producer
// forms as the chain hands it each 8 samples (a count too), only as far as
// the next chunks read. The chain carries the LPC window in a ring of 16
// registers in whole rounds of 16 samples (a half's remainder of 8 a round
// of its own) with no branch in a sample; the older pairs of each sample's
// sum are formed on the warp's lanes steps ahead (silk_syn_step), so that
// a sample's chain is one multiply and three adds. With one thread (the
// host build) the same code runs the parts in an order that respects what
// each reads: the first half's LTP, its chain, the second half's LTP, its
// chain, the lanes of a step one after another (SILK_SYN_LANES, and the
// chain's sample lanes as an array). csrc/
// silk_synthesis.cu includes this header for its kernel; with
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

// The producer's lanes: on the device each lane of its warp runs a
// SILK_SYN_LANES block once for itself and a lane variable is a register;
// on the host a lane variable is an array of the warp's 32 values and a
// block a loop over them, so that every lane's reads of a step come before
// any lane's writes as on the device (SILK_SYN_SYNC_WARP between).
// SILK_SYN_LANE0 runs its statement on lane 0 only (the host: once).
#define SILK_SYN_WARP 32
#if defined(__CUDA_ARCH__)
#define SILK_SYN_LANE_SLOTS 1
#define SILK_SYN_MY(v) ((v)[0])
#define SILK_SYN_LANES                                                   \
  for (int lane = static_cast<int>(threadIdx.x) & (SILK_SYN_WARP - 1),  \
           lanes_once_ = 1;                                              \
       lanes_once_; lanes_once_ = 0)
#define SILK_SYN_SYNC_WARP() __syncwarp()
#define SILK_SYN_LANE0 if ((threadIdx.x & (SILK_SYN_WARP - 1)) == 0)
#else
#define SILK_SYN_LANE_SLOTS SILK_SYN_WARP
#define SILK_SYN_MY(v) ((v)[lane])
#define SILK_SYN_LANES for (int lane = 0; lane < SILK_SYN_WARP; ++lane)
#define SILK_SYN_SYNC_WARP() ((void)0)
#define SILK_SYN_LANE0
#endif

#define SILK_SYN_D 16        // LPC order (MAX_D)
#define SILK_SYN_LTP 5       // LTP taps
#define SILK_SYN_CHUNK 8     // samples an LTP step
#define SILK_SYN_MAX_L 320   // a 20 ms frame at 16 kHz
#define SILK_SYN_MAX_H 320   // ltp_mem_length at 16 kHz
#define SILK_SYN_MAX_NB 4    // subframes
#define SILK_SYN_CHUNKS (SILK_SYN_MAX_L / SILK_SYN_CHUNK)
#define SILK_SYN_GROUP 4     // LTP chunks at most in one step of the warp
// a lag the LTP reads with: any int32 lag clamped to this range reads the
// same clamped indices of a plane (at most MAX_H + MAX_L wide)
#define SILK_SYN_LAG_LO (-1024)
#define SILK_SYN_LAG_HI 2048

// The parts of a frame that the clock probe times (tools/silk_syn_probe.cu
// defines SILK_SYN_PROBE_BEGIN, SILK_SYN_PROBE and SILK_SYN_PROBE_END:
// SILK_SYN_PROBE(part) adds the cycles since the last mark to `part`,
// SILK_SYN_PROBE_END adds a function's sums to the warp's record). Empty in
// the kernel's own build and in the host build.
enum SilkSynProbePart {
  kSynProbeLoads,   // the parameters and the history into shared memory
  kSynProbeWhiten,  // the scale and the history's re-whitening
  kSynProbeLtp,     // the LTP chunks
  kSynProbeLpc,     // the LPC chain
  kSynProbeInterp,  // an interpolated frame's re-whitening of the output
  kSynProbeWait,    // waiting on the other warp (or at the block barrier)
  kSynProbeOut,     // the write-out
  kSynProbeParts
};
#ifndef SILK_SYN_PROBE
#define SILK_SYN_PROBE_BEGIN()
#define SILK_SYN_PROBE(part)
#define SILK_SYN_PROBE_END()
#endif

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

// ------------------------------------------------- the warps' hand-offs

// Work is handed from one warp to the other as a count: the LTP's chunks
// written, the first half's output samples written. The writer stores the
// count with release semantics once the values are in shared memory, the
// reader loads it with acquire semantics only when the count it last read
// falls short of what it is about to read (the producer is usually ahead
// of the chain, so most of the chain's rounds read nothing). Plain memory
// on the host, where the parts run in order.
SILK_SYN_HD void silk_syn_release(int* p, int v) {
#if defined(__CUDA_ARCH__)
  asm volatile("st.release.cta.shared.b32 [%0], %1;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(p))),
               "r"(v)
               : "memory");
#else
  *p = v;
#endif
}

SILK_SYN_HD int silk_syn_acquire(const int* p) {
#if defined(__CUDA_ARCH__)
  int v;
  asm volatile("ld.acquire.cta.shared.b32 %0, [%1];"
               : "=r"(v)
               : "r"(static_cast<uint32_t>(__cvta_generic_to_shared(p)))
               : "memory");
  return v;
#else
  return *p;
#endif
}

// A word of global memory into shared memory: cp.async on the device, each
// thread's copies all in flight at once (silk_syn_copies_done waits for
// them), a plain copy on the host.
template <typename T>
SILK_SYN_HD void silk_syn_copy(T* dst, const T* src) {
  static_assert(sizeof(T) == 4, "a word");
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
#else
  *dst = *src;
#endif
}

SILK_SYN_HD void silk_syn_copies_done() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_all;" ::: "memory");
#endif
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

// N floats of shared memory (16-byte aligned, N a multiple of 4) into
// registers, four a load on the device
template <int N>
SILK_SYN_HD void silk_syn_load(const float* p, float* out) {
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

// the same the other way, registers into shared memory
template <int N>
SILK_SYN_HD void silk_syn_store(const float* v, float* p) {
#pragma unroll
  for (int m = 0; m < N; m += 4) {
#if defined(__CUDA_ARCH__)
    *reinterpret_cast<float4*>(p + m) =
        make_float4(v[m], v[m + 1], v[m + 2], v[m + 3]);
#else
    for (int j = 0; j < 4; ++j) p[m + j] = v[m + j];
#endif
  }
}

// ------------------------------------------------------------- the steps

// the re-whitened sample i of the row x (x[-16 .. -1] zeros, the samples
// before the row) through the LPC a: x[i] - a[0] x[i - 1] - ... - a[15]
// x[i - 16], a product and a subtraction a tap in that order
// (_lpc_analysis_batched)
SILK_SYN_HD float silk_syn_fir(const float* x, const float* a, int i) {
  float acc = x[i];
#pragma unroll
  for (int j = 0; j < SILK_SYN_D; ++j)
    acc = SILK_SYN_FSUB(acc, SILK_SYN_FMUL(a[j], x[i - 1 - j]));
  return acc;
}

// the LTP prediction of position n of the plane r (width positions): sum_j
// b[j] r[n - lag + 2 - j], each index clamped to the plane as the plain
// version's gather clamps it (lag within SILK_SYN_LAG_LO .. _HI)
SILK_SYN_HD float silk_syn_ltp_pred(const float* r, int width, int n,
                                    int lag, const float* b) {
  float p[SILK_SYN_LTP];
#pragma unroll
  for (int j = 0; j < SILK_SYN_LTP; ++j) {
    int idx = n - lag + 2 - j;
    idx = idx < 0 ? 0 : (idx > width - 1 ? width - 1 : idx);
    p[j] = SILK_SYN_FMUL(r[idx], b[j]);
  }
  return silk_syn_sum5(p);
}

// The chain, over a warp's lanes. The LPC sum of sample n in torch's order
// of a row of 16 products is eight lane sums P_k(n) = y[n - 16 + k] a[15 -
// k] + y[n - 8 + k] a[7 - k] added in order k = 0 .. 7, then x[n] added.
// P_k(n) is known once y[n - 8 + k] is, so the sums run ahead of the
// samples: at the step that makes y[m + 1] from y[m], every pair any sample
// takes is of y[m - 8] and y[m]. Lane n % 8 holds sample n's sum of pairs
// 0-4 and adds one pair a step (steps n - 8 .. n - 4: its weights at each
// step phase in registers, no shuffle between steps); the step that
// completes it broadcasts it (one shuffle), and every lane takes it two
// steps later to add pair 5 (formed at the step before), then pair 6, then,
// at the next step, pair 7 and x: one multiply and three adds from y[m] to
// y[m + 1], with the shuffle's latency spread over two steps. Every lane
// keeps the same ring of the last 16 outputs (oldest first at phase 0); on
// the host the 8 sample lanes are an array.
#define SILK_SYN_SAMPLE_LANES 8
#define SILK_SYN_HEAD_PAIRS 5  // pairs 0-4 on the sample lanes
#if defined(__CUDA_ARCH__)
#define SILK_SYN_SAMPLE_SLOTS 1
#else
#define SILK_SYN_SAMPLE_SLOTS SILK_SYN_SAMPLE_LANES
#endif

struct SilkSynChain {
  // a sample lane's sum, and its pair's weights a[15 - k], a[7 - k] at
  // each step phase m % 8 (k = (m - lane) % 8; 0.0 past pair 4)
  float s[SILK_SYN_SAMPLE_SLOTS];
  // at each step phase, the bits of the lane's sum it keeps: none where
  // its sample starts (the sum taken as -0.0, and -0.0 + P is P)
  uint32_t keep[SILK_SYN_SAMPLE_SLOTS][SILK_SYN_SAMPLE_LANES];
  float ca[SILK_SYN_SAMPLE_SLOTS][SILK_SYN_SAMPLE_LANES];
  float cb[SILK_SYN_SAMPLE_SLOTS][SILK_SYN_SAMPLE_LANES];
  float a5o, a5n, a6o, a6n, a7o, a7n;  // a[10], a[2], a[9], a[1], a[8], a[0]
  float s4_old, s4_mid;  // pairs 0-4 of samples m + 2, m + 3 (broadcast)
  float p5;              // pair 5 of sample m + 2
  float s6;              // pairs 0-6 of sample m + 1
};

// the chain's weights for the LPC a (the sums left as they are: the first
// 7 steps of a half refill them)
SILK_SYN_HD void silk_syn_chain_weights(SilkSynChain& c, const float* a) {
#if defined(__CUDA_ARCH__)
  const int lane = threadIdx.x & (SILK_SYN_SAMPLE_LANES - 1), slot = 0;
#else
  for (int lane = 0; lane < SILK_SYN_SAMPLE_LANES; ++lane) {
    const int slot = lane;
#endif
#pragma unroll
    for (int p = 0; p < SILK_SYN_SAMPLE_LANES; ++p) {
      const int k = (p - lane) & (SILK_SYN_SAMPLE_LANES - 1);
      c.keep[slot][p] = k == 0 ? 0u : 0xffffffffu;
      c.ca[slot][p] = k < SILK_SYN_HEAD_PAIRS ? a[15 - k] : 0.0f;
      c.cb[slot][p] = k < SILK_SYN_HEAD_PAIRS ? a[7 - k] : 0.0f;
    }
#if !defined(__CUDA_ARCH__)
  }
#endif
  c.a5o = a[10];
  c.a5n = a[2];
  c.a6o = a[9];
  c.a6n = a[1];
  c.a7o = a[8];
  c.a7n = a[0];
}

// The step that makes sample k of a round (ring phase 0, k fixed once
// unrolled; kOut false: a step of the refill, on known samples, that makes
// none).
template <bool kOut>
SILK_SYN_HD void silk_syn_step(SilkSynChain& c, float* w, int k, float x) {
  const int p = (k + 7) & (SILK_SYN_SAMPLE_LANES - 1);  // m % 8
  const float yold = w[(k + 7) & 15], ynew = w[(k + 15) & 15];
  // the sample lanes: lane p starts sample m + 8, the lanes of samples m +
  // 4 .. m + 7 add their pair; lane (p - 4) % 8 completes pairs 0-4
#if defined(__CUDA_ARCH__)
  {
    const float pk = SILK_SYN_FADD(SILK_SYN_FMUL(yold, c.ca[0][p]),
                                   SILK_SYN_FMUL(ynew, c.cb[0][p]));
    const uint32_t keep = c.keep[0][p];
    const float in = __uint_as_float((__float_as_uint(c.s[0]) & keep) |
                                     (~keep & 0x80000000u));
    c.s[0] = SILK_SYN_FADD(in, pk);
  }
  const float s4 = __shfl_sync(0xffffffffu, c.s[0],
                               (p - 4) & (SILK_SYN_SAMPLE_LANES - 1));
#else
  for (int lane = 0; lane < SILK_SYN_SAMPLE_LANES; ++lane) {
    const int kk = (p - lane) & (SILK_SYN_SAMPLE_LANES - 1);
    if (kk >= SILK_SYN_HEAD_PAIRS) continue;
    const float pk = SILK_SYN_FADD(SILK_SYN_FMUL(yold, c.ca[lane][p]),
                                   SILK_SYN_FMUL(ynew, c.cb[lane][p]));
    c.s[lane] = kk == 0 ? pk : SILK_SYN_FADD(c.s[lane], pk);
  }
  const float s4 = c.s[(p - 4) & (SILK_SYN_SAMPLE_LANES - 1)];
#endif
  // every lane: pairs 5 and 6 of sample m + 2, pair 7 and x of m + 1
  const float s6 = SILK_SYN_FADD(
      SILK_SYN_FADD(c.s4_old, c.p5),
      SILK_SYN_FADD(SILK_SYN_FMUL(yold, c.a6o), SILK_SYN_FMUL(ynew, c.a6n)));
  if (kOut)
    w[k & 15] = SILK_SYN_FADD(
        x, SILK_SYN_FADD(c.s6, SILK_SYN_FADD(SILK_SYN_FMUL(yold, c.a7o),
                                             SILK_SYN_FMUL(ynew, c.a7n))));
  c.p5 = SILK_SYN_FADD(SILK_SYN_FMUL(yold, c.a5o), SILK_SYN_FMUL(ynew, c.a5n));
  c.s6 = s6;
  c.s4_old = c.s4_mid;
  c.s4_mid = s4;
}

// N samples of the chain from ring phase 0 (a round): x the round's input;
// writes the round's output to y (samples at, at + 1, ... of the frame;
// kPublish: raising *done as each 8 are written; every lane writes the
// same values). Straight-line code once unrolled.
template <int N, bool kPublish>
SILK_SYN_HD void silk_syn_round(SilkSynChain& c, float* w, const float* x,
                                float* y, int* done, int at) {
#pragma unroll
  for (int k = 0; k < N; ++k) {
    silk_syn_step<true>(c, w, k, x[k]);
    if ((k & 7) == 7) {
      silk_syn_store<8>(w + (k & 15) - 7, y + k - 7);
      if (kPublish) silk_syn_release(done, at + k + 1);
    }
  }
}

// ------------------------------------------------------------ one stream

// the subframe of sample n, the last one's past nb * sl (min(n / sl, nb -
// 1) with nb <= 4, no division)
SILK_SYN_HD int silk_syn_sub(int n, int sl, int nb) {
  const int sub = (n >= sl) + (n >= 2 * sl) + (n >= 3 * sl);
  return sub < nb - 1 ? sub : nb - 1;
}

// a stream's work space (the kernel's shared memory). Plane position p of
// [history | frame] lies at index p + MAX_H - H of r and r2, so that the
// frame starts at MAX_H (16-byte aligned); r holds the first half's plane,
// continued by the second half's unless the frame is interpolated, r2 an
// interpolated frame's second half (the output re-whitened, then the
// frame). hy holds [16 zeros | history | output] with the output at D +
// MAX_H, so that both re-whitenings and the carried output read straight
// through it. ltp_done and y_done are the counts the warps hand over;
// chunk_lag and chunk_sub are each chunk's lag and subframe.
struct alignas(16) SilkSynWork {
  int32_t ltp_done;  // chunks of the frame the LTP has written
  int32_t y_done;    // samples of the first half's output the chain wrote
  int32_t pad_[2];   // hy on 16 bytes
  float hy[SILK_SYN_D + SILK_SYN_MAX_H + SILK_SYN_MAX_L];
  float r[SILK_SYN_MAX_H + SILK_SYN_MAX_L];
  float r2[SILK_SYN_MAX_H + SILK_SYN_MAX_L];
  float a[2][SILK_SYN_D];
  float seed[SILK_SYN_D];
  float b[SILK_SYN_MAX_NB][SILK_SYN_LTP];
  float gains[SILK_SYN_MAX_NB];
  int32_t pitch[SILK_SYN_MAX_NB];
  int32_t chunk_lag[SILK_SYN_CHUNKS];
  int32_t chunk_sub[SILK_SYN_CHUNKS];
};

// one stream's frame shape and flags
struct SilkSynFrame {
  int L, H, nb, sl, half, hb;  // hb = MAX_H - H
  bool voiced, interp;
  float ltp_scale;
};

// The loads, the scale and the history's re-whitening: thread t of nt.
SILK_SYN_HD SilkSynFrame silk_syn_prologue(const SilkSynArgs& g, int s,
                                           SilkSynWork& w, int t, int nt) {
  SILK_SYN_PROBE_BEGIN();
  SilkSynFrame f;
  f.L = g.L;
  f.H = g.H;
  f.nb = g.nb;
  f.sl = g.subfr_len;
  f.half = silk_syn_half(f.L, f.sl);
  f.hb = SILK_SYN_MAX_H - f.H;
  const int64_t* st = g.stride;
  const float* exc = g.exc + s * st[kSynExc];
  const float* a = g.a + s * st[kSynA];
  const float* b = g.b + s * st[kSynB];
  const int32_t* pitch = g.pitch + s * st[kSynPitch];
  const float* gains = g.gains + s * st[kSynGains];
  const float* hist = g.out_hist + s * st[kSynOutHist];
  const float* lpc_hist = g.lpc_hist + s * st[kSynLpcHist];
  f.voiced = g.voiced[s * st[kSynVoiced]] != 0;
  f.interp = g.interp != nullptr && g.interp[s * st[kSynInterp]] != 0;
  f.ltp_scale = g.ltp_scale[s * st[kSynLtpScale]];
  const int nb = f.nb, nbb = nb * SILK_SYN_LTP;
  if (t == 0) w.ltp_done = w.y_done = 0;
  // the parameter words in one pass (a, b, gains, pitch, the LPC state),
  // the history and the excitation, every copy in flight at once
  for (int i = t; i < 2 * SILK_SYN_D + nbb + 2 * nb + SILK_SYN_D; i += nt) {
    int k = i;
    if (k < 2 * SILK_SYN_D) {
      silk_syn_copy(&w.a[k / SILK_SYN_D][k % SILK_SYN_D], a + k);
    } else if ((k -= 2 * SILK_SYN_D) < nbb) {
      silk_syn_copy(&w.b[k / SILK_SYN_LTP][k % SILK_SYN_LTP], b + k);
    } else if ((k -= nbb) < nb) {
      silk_syn_copy(&w.gains[k], gains + k);
    } else if ((k -= nb) < nb) {
      silk_syn_copy(&w.pitch[k], pitch + k);
    } else {
      k -= nb;
      silk_syn_copy(&w.seed[k], lpc_hist + SILK_SYN_D - 1 - k);
    }
  }
  float* hx = w.hy + SILK_SYN_D + f.hb;  // history sample 0
  for (int i = t; i < f.H; i += nt) silk_syn_copy(hx + i, hist + i);
  for (int n = t; n < f.L; n += nt)
    silk_syn_copy(w.r + SILK_SYN_MAX_H + n, exc + n);
  for (int i = t; i < SILK_SYN_D; i += nt) hx[i - SILK_SYN_D] = 0.0f;
  silk_syn_copies_done();
  SILK_SYN_SYNC();
  SILK_SYN_PROBE(kSynProbeLoads);
  // each chunk's subframe (a chunk takes its first sample's) and lag
  for (int c = t; c < f.L / SILK_SYN_CHUNK; c += nt) {
    const int k = silk_syn_sub(c * SILK_SYN_CHUNK, f.sl, nb);
    const int lag = w.pitch[k];
    w.chunk_sub[c] = k;
    w.chunk_lag[c] = lag < SILK_SYN_LAG_LO ? SILK_SYN_LAG_LO
                     : lag > SILK_SYN_LAG_HI ? SILK_SYN_LAG_HI
                                             : lag;
  }
  // the frame's scaled excitation (plus 0.0 where the stream is unvoiced,
  // its LTP), also behind an interpolated frame's second-half plane
  for (int n = t; n < f.L; n += nt) {
    float e = SILK_SYN_FMUL(w.r[SILK_SYN_MAX_H + n],
                            w.gains[silk_syn_sub(n, f.sl, nb)]);
    if (!f.voiced) e = SILK_SYN_FADD(e, 0.0f);
    w.r[SILK_SYN_MAX_H + n] = e;
    if (f.interp && n >= f.half) w.r2[SILK_SYN_MAX_H + n] = e;
  }
  // the history re-whitened with the first half's LPC, times ltp_scale,
  // and in an interpolated frame with the second half's (no ltp_scale):
  // only a voiced stream's LTP reads them
  if (f.voiced) {
    for (int i = t; i < f.H; i += nt)
      w.r[f.hb + i] =
          SILK_SYN_FMUL(silk_syn_fir(hx, w.a[0], i), f.ltp_scale);
    if (f.interp)
      for (int i = t; i < f.H; i += nt)
        w.r2[f.hb + i] = silk_syn_fir(hx, w.a[1], i);
  }
  SILK_SYN_SYNC();
  SILK_SYN_PROBE(kSynProbeWhiten);
  SILK_SYN_PROBE_END();
  return f;
}

// The LTP chunks [c_lo, c_hi) of half `part` on the producer's warp, in
// place on the half's plane; ltp_done raised once they are written. A step
// takes chunk c and the next chunks c + i whose reads end before chunk c
// (lag >= 8 i + 10): each lane one sample of them, all reads before any
// write, as the plain version's chunk by chunk. An unvoiced stream's chunks
// are the scaled excitation itself (the prologue's). In an interpolated
// frame's second half the positions of the first half's output that a step
// reads are re-whitened first, each 8 once the chain hands them over.
SILK_SYN_HD void silk_syn_ltp(const SilkSynFrame& f, SilkSynWork& w,
                              int part) {
  SILK_SYN_PROBE_BEGIN();
  const int c_lo = part == 0 ? 0 : f.half / SILK_SYN_CHUNK;
  const int c_hi = (part == 0 ? f.half : f.L) / SILK_SYN_CHUNK;
  if (!f.voiced) {
    SILK_SYN_LANE0 { silk_syn_release(&w.ltp_done, c_hi); }
    SILK_SYN_PROBE_END();
    return;
  }
  const bool rew = part == 1 && f.interp;
  float* plane = (rew ? w.r2 : w.r) + f.hb;  // plane position 0
  const int width = f.H + (part == 0 ? f.half : f.L);
  const float* hx = w.hy + SILK_SYN_D + f.hb;
  int rew_done = f.H;  // re-whitened plane positions [0, rew_done)
  int y_known = 0;     // the chain's y_done as last read
  for (int c = c_lo; c < c_hi;) {
    int n_grp = 1;
    while (n_grp < SILK_SYN_GROUP && c + n_grp < c_hi &&
           w.chunk_lag[c + n_grp] >= SILK_SYN_CHUNK * n_grp + 10)
      ++n_grp;
    if (rew) {
      // the furthest position the step reads, plus one
      int need = 0;
      for (int i = 0; i < n_grp; ++i) {
        int hi = f.H + (c + i) * SILK_SYN_CHUNK + 9 - w.chunk_lag[c + i];
        hi = hi < 0 ? 0 : (hi > width - 1 ? width - 1 : hi);
        need = need > hi + 1 ? need : hi + 1;
      }
      need = need < f.H + f.half ? need : f.H + f.half;
      while (rew_done < need) {
        while (y_known < rew_done - f.H + SILK_SYN_CHUNK)
          y_known = silk_syn_acquire(&w.y_done);
        SILK_SYN_PROBE(kSynProbeWait);
        SILK_SYN_LANES {
          if (lane < SILK_SYN_CHUNK)
            plane[rew_done + lane] =
                silk_syn_fir(hx, w.a[1], rew_done + lane);
        }
        SILK_SYN_SYNC_WARP();
        rew_done += SILK_SYN_CHUNK;
        SILK_SYN_PROBE(kSynProbeInterp);
      }
    }
    float pred[SILK_SYN_LANE_SLOTS];
    SILK_SYN_LANES {
      const int ci = c + lane / SILK_SYN_CHUNK;
      if (ci < c + n_grp)
        SILK_SYN_MY(pred) = silk_syn_ltp_pred(
            plane, width, f.H + ci * SILK_SYN_CHUNK + lane % SILK_SYN_CHUNK,
            w.chunk_lag[ci], w.b[w.chunk_sub[ci]]);
    }
    SILK_SYN_SYNC_WARP();
    SILK_SYN_LANES {
      const int n = f.H + c * SILK_SYN_CHUNK + lane;
      if (lane < n_grp * SILK_SYN_CHUNK)
        plane[n] = SILK_SYN_FADD(plane[n], SILK_SYN_MY(pred));
    }
    SILK_SYN_SYNC_WARP();
    SILK_SYN_LANE0 { silk_syn_release(&w.ltp_done, c + n_grp); }
    c += n_grp;
    SILK_SYN_PROBE(kSynProbeLtp);
  }
  SILK_SYN_PROBE_END();
}

// the chain's wait for the LTP's first `chunks` chunks; *known the count
// it last read
SILK_SYN_HD void silk_syn_need(const SilkSynWork& w, int chunks,
                               int* known) {
  while (*known < chunks) *known = silk_syn_acquire(&w.ltp_done);
}

// The LPC chain over half `part` on the chain's warp: y[n] = x[n] + sum_j
// a[j] y[n - 1 - j] with the half's LPC, x the half's residual, the window
// the ring (oldest first at phase 0, carried from the first half to the
// second). The stage sums are refilled from the ring with the half's LPC
// (7 steps that make no sample). A round reads its input as it starts,
// once its chunks are handed over (read a round ahead, the input would be
// carried across the loop, and the copies cost more than the load);
// kPublish (the first half of an interpolated voiced frame, the only one
// the producer reads back) hands the output to the producer 8 samples at
// a time.
template <bool kFirst, bool kPublish>
SILK_SYN_HD void silk_syn_chain_half(const SilkSynFrame& f, SilkSynWork& w,
                                     float* ring, SilkSynChain& c,
                                     int* known) {
  SILK_SYN_PROBE_BEGIN();
  const int lo = kFirst ? 0 : f.half, hi = kFirst ? f.half : f.L;
  const float* x_at =
      (!kFirst && f.interp ? w.r2 : w.r) + SILK_SYN_MAX_H;  // sample 0
  float* y_at = w.hy + SILK_SYN_D + SILK_SYN_MAX_H;
  silk_syn_chain_weights(c, w.a[kFirst ? 0 : 1]);
#pragma unroll
  for (int k = SILK_SYN_D - 7; k < SILK_SYN_D; ++k)
    silk_syn_step<false>(c, ring, k, 0.0f);
  float x[SILK_SYN_D];
  int m = lo;
  for (; m + SILK_SYN_D <= hi; m += SILK_SYN_D) {
    // the round's input, behind the chunks that write it
    silk_syn_need(w, (m + SILK_SYN_D) / SILK_SYN_CHUNK, known);
    silk_syn_load<SILK_SYN_D>(x_at + m, x);
    SILK_SYN_PROBE(kSynProbeWait);
    silk_syn_round<SILK_SYN_D, kPublish>(c, ring, x, y_at + m, &w.y_done,
                                         m);
    SILK_SYN_PROBE(kSynProbeLpc);
  }
  if (m < hi) {
    // a remainder of 8: a round of its own, then the ring turned back to
    // phase 0
    silk_syn_need(w, hi / SILK_SYN_CHUNK, known);
    silk_syn_load<SILK_SYN_CHUNK>(x_at + m, x);
    SILK_SYN_PROBE(kSynProbeWait);
    silk_syn_round<SILK_SYN_CHUNK, kPublish>(c, ring, x, y_at + m,
                                             &w.y_done, m);
    float turned[SILK_SYN_D];
#pragma unroll
    for (int j = 0; j < SILK_SYN_D; ++j)
      turned[j] = ring[(j + SILK_SYN_CHUNK) & 15];
#pragma unroll
    for (int j = 0; j < SILK_SYN_D; ++j) ring[j] = turned[j];
    SILK_SYN_PROBE(kSynProbeLpc);
  }
  SILK_SYN_PROBE_END();
}

// The outputs: the frame's output, the last H samples of [history |
// output], the LPC state (y[L - 1] first); thread t of nt after the block's
// barrier.
SILK_SYN_HD void silk_syn_epilogue(const SilkSynArgs& g, int s,
                                   const SilkSynFrame& f,
                                   const SilkSynWork& w, int t, int nt) {
  SILK_SYN_PROBE_BEGIN();
  SILK_SYN_SYNC();
  SILK_SYN_PROBE(kSynProbeWait);
  const float* y = w.hy + SILK_SYN_D + SILK_SYN_MAX_H;
  float* out = g.out + static_cast<int64_t>(s) * f.L;
  float* o_hist = g.o_hist + static_cast<int64_t>(s) * f.H;
  for (int n = t; n < f.L; n += nt) out[n] = y[n];
  for (int i = t; i < f.H; i += nt) o_hist[i] = y[f.L - f.H + i];
  for (int k = t; k < SILK_SYN_D; k += nt)
    g.o_lpc[s * SILK_SYN_D + k] = y[f.L - 1 - k];
  SILK_SYN_PROBE(kSynProbeOut);
  SILK_SYN_PROBE_END();
}

// one SILK frame of stream s (silk_synthesis_step_reference): thread t of
// nt, w the stream's work space. On the device (nt = 64) warp 1 runs the
// LTP and warp 0 the chain; on the host the parts run in turn.
SILK_SYN_HD void silk_syn_stream(const SilkSynArgs& g, int s, SilkSynWork& w,
                                 int t, int nt) {
  const SilkSynFrame f = silk_syn_prologue(g, s, w, t, nt);
  float ring[SILK_SYN_D];
#pragma unroll
  for (int j = 0; j < SILK_SYN_D; ++j) ring[j] = w.seed[j];
  SilkSynChain c = {};
  int known = 0;
#if defined(__CUDA_ARCH__)
  if (t >= SILK_SYN_WARP) {
    silk_syn_ltp(f, w, 0);
    silk_syn_ltp(f, w, 1);
  } else {
    if (f.interp && f.voiced)
      silk_syn_chain_half<true, true>(f, w, ring, c, &known);
    else
      silk_syn_chain_half<true, false>(f, w, ring, c, &known);
    silk_syn_chain_half<false, false>(f, w, ring, c, &known);
  }
#else
  silk_syn_ltp(f, w, 0);
  silk_syn_chain_half<true, true>(f, w, ring, c, &known);
  silk_syn_ltp(f, w, 1);
  silk_syn_chain_half<false, false>(f, w, ring, c, &known);
#endif
  silk_syn_epilogue(g, s, f, w, t, nt);
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
