// Native CELT host symbol decoder: range decode -> frame descriptors.
//
// This is the serial, branchy half of the decoder (SURVEY.md §2.9.10): it
// consumes packet bytes and emits the dense per-frame tensors (norm
// spectrum X, band energies, postfilter params) that the batched TPU
// synthesis stage consumes. It mirrors the validated Python host decoder
// (mousiki_tpu/celt/{decoder,bands,rate,vq,cwrs,quant_bands}.py) and is
// differentially tested against it.
//
// Build: g++ -O3 -march=native -shared -fPIC -o libcelt_host.so celt_host.cpp

#include <cstdint>
#include <cstring>
#include <cmath>
#include <cstdlib>
#include <algorithm>
#include <vector>

#if defined(__AVX2__)
#include <immintrin.h>
#endif

#include "celt_tables.h"

// Optional phase profiler for the plan decode (build with -DPLAN_PROF and
// call celt_host_prof_report() from the harness; see native/bench_plan.cpp).
#ifdef PLAN_PROF
#include <x86intrin.h>
#include <cstdio>
namespace planprof {
enum Phase { HDR, COARSE, DYNALLOC, ALLOC, FINE, BANDS, THETA, PULSES,
             FINALISE, TAIL, MEMSET, N_PHASE };
static const char* kNames[N_PHASE] = {
    "header", "coarse_energy", "dynalloc", "allocation", "fine_energy",
    "pq_all_bands", "  theta(sub)", "  pulse_decode(sub)", "finalise",
    "state_tail", "memsets"};
static uint64_t acc[N_PHASE];
static uint64_t frames;
struct Scope {
  int p;
  uint64_t t0;
  Scope(int ph) : p(ph), t0(__rdtsc()) {}
  ~Scope() { acc[p] += __rdtsc() - t0; }
};
}  // namespace planprof
#define PROF_SCOPE(ph) planprof::Scope _prof_scope_##ph(planprof::ph)
#ifdef PLAN_PROF_LITE
// per-frame scopes only: the per-call THETA/PULSES rdtsc fencing costs
// ~60 cycles/scope and doubles the measured frame time; the lite mode
// keeps the top-level split honest
#define PROF_SCOPE_SUB(ph) ((void)0)
#else
#define PROF_SCOPE_SUB(ph) PROF_SCOPE(ph)
#endif
#define PROF_FRAME() planprof::frames++
extern "C" void celt_host_prof_report() {
  double f = planprof::frames ? (double)planprof::frames : 1.0;
  std::fprintf(stderr, "plan decode phase profile (%llu frames):\n",
               (unsigned long long)planprof::frames);
  for (int i = 0; i < planprof::N_PHASE; i++)
    std::fprintf(stderr, "  %-22s %8.1f cycles/frame\n", planprof::kNames[i],
                 planprof::acc[i] / f);
}
#else
#define PROF_SCOPE(ph) ((void)0)
#define PROF_SCOPE_SUB(ph) ((void)0)
#define PROF_FRAME() ((void)0)
#endif

namespace {

constexpr int BITRES = 3;
constexpr int MAX_FINE_BITS = 8;
constexpr int FINE_OFFSET = 21;
constexpr int QTHETA_OFFSET = 4;
constexpr int QTHETA_OFFSET_TWOPHASE = 16;
constexpr int ALLOC_STEPS = 6;
constexpr int LOG_MAX_PSEUDO = 6;
constexpr int NB = 21;
constexpr int SPREAD_AGGRESSIVE = 3;
constexpr int SPREAD_NONE = 0;
constexpr int SPREAD_LIGHT = 1;
constexpr int SPREAD_NORMAL = 2;

// ---------------------------------------------------------------- range dec
struct EcDec {
  const uint8_t* buf;
  uint32_t storage;
  uint32_t end_offs;
  uint32_t end_window;
  int nend_bits;
  int nbits_total;
  uint32_t offs;
  uint32_t rng;
  uint32_t val;
  uint32_t ext;
  int rem;
  int error;
};

inline int ec_ilog(uint32_t v) { return v ? 32 - __builtin_clz(v) : 0; }

inline int ec_read_byte(EcDec* d) {
  return d->offs < d->storage ? d->buf[d->offs++] : 0;
}
inline int ec_read_byte_from_end(EcDec* d) {
  return d->end_offs < d->storage ? d->buf[d->storage - ++(d->end_offs)] : 0;
}

void ec_dec_normalize(EcDec* d) {
  while (d->rng <= (1u << 23)) {
    d->nbits_total += 8;
    d->rng <<= 8;
    int sym = d->rem;
    d->rem = ec_read_byte(d);
    sym = ((sym << 8) | d->rem) >> 1;
    d->val = ((d->val << 8) + (255 & ~sym)) & 0x7FFFFFFFu;
  }
}

void ec_dec_init(EcDec* d, const uint8_t* buf, uint32_t storage) {
  d->buf = buf;
  d->storage = storage;
  d->end_offs = 0;
  d->end_window = 0;
  d->nend_bits = 0;
  d->nbits_total = 33 - 24;
  d->offs = 0;
  d->rng = 1u << 7;
  d->rem = ec_read_byte(d);
  d->val = d->rng - 1 - (uint32_t)(d->rem >> 1);
  d->error = 0;
  ec_dec_normalize(d);
}

inline int ec_tell(const EcDec* d) { return d->nbits_total - ec_ilog(d->rng); }

// ec_tell_frac's 3-step square-and-extract refinement is a pure function
// of the 16-bit normalized top of rng — precompute it (32 KB, L2-hot;
// the loop is a ~20-cycle dependent chain on the theta path, 2 calls per
// split).
static uint8_t g_tellfrac[1 << 15];
void build_tellfrac_table() {
  static bool done = false;
  if (done) return;
  for (uint32_t i = 0; i < (1u << 15); i++) {
    uint32_t r = i + (1u << 15);
    int l = 0;
    for (int k = 0; k < BITRES; k++) {
      r = (r * r) >> 15;
      int b = (int)(r >> 16);
      l = (l << 1) | b;
      r >>= b;
    }
    g_tellfrac[i] = (uint8_t)l;
  }
  done = true;
}

inline int ec_tell_frac(const EcDec* d) {
  uint32_t nbits = (uint32_t)d->nbits_total << BITRES;
  int l = ec_ilog(d->rng);
  uint32_t r = d->rng >> (l - 16);
  return (int)(nbits - (((uint32_t)l << BITRES) | g_tellfrac[r - (1u << 15)]));
}

#ifdef PLAN_PROF
namespace ecprof {
static uint64_t n_decode, n_decode_bin, n_bit_logp, n_icdf, n_bits, n_uint;
}
#define EC_COUNT(x) ecprof::x++
extern "C" void celt_host_ec_counts(uint64_t* out6) {
  out6[0] = ecprof::n_decode;
  out6[1] = ecprof::n_decode_bin;
  out6[2] = ecprof::n_bit_logp;
  out6[3] = ecprof::n_icdf;
  out6[4] = ecprof::n_bits;
  out6[5] = ecprof::n_uint;
}
#else
#define EC_COUNT(x) ((void)0)
#endif

// Optional EC-op recorder (build with -DEC_RECORD): captures the exact
// primitive range-decoder op sequence of a plan decode so a harness can
// replay ONLY the entropy ops on the same payload — this measures the
// irreducible serial EC cost apart from the band-walk bookkeeping.
// Production builds compile the hooks away.
#ifdef EC_RECORD
#include <vector>
namespace ecrec {
struct Op {
  uint8_t kind;  // 0 decode 1 decode_bin 2 update 3 bit_logp 4 icdf 5 bits
  const uint8_t* icdf;
  uint32_t a, b, c;
};
static std::vector<Op>* log_ = nullptr;
}  // namespace ecrec
#define EC_REC(k, ic, A, B, C_) \
  do { \
    if (ecrec::log_) ecrec::log_->push_back({(uint8_t)(k), (ic), \
        (uint32_t)(A), (uint32_t)(B), (uint32_t)(C_)}); \
  } while (0)
#else
#define EC_REC(k, ic, A, B, C_) ((void)0)
#endif

// Exact floor division rng/ft without the hardware divider (ICL div r32 is
// ~15 cycles on the serial EC dependency chain; this is ~5).  Granlund-
// Montgomery round-up reciprocal: with L = ceil(log2 ft) and
// m = floor(2^(31+L)/ft) + 1 (fits u32 for non-trivial ft),
// floor(n*m >> (31+L)) == floor(n/ft) for every n <= 2^31.  rng <= 2^31
// always (EC_CODE_TOP), and every ec_decode call site uses ft < 2^16
// (max is compute_theta's triangular ft <= 16641); larger ft falls back
// to the divider.  Table is 512 KB but only the handful of distinct ft
// values a stream uses stay hot.
struct FtDiv { uint32_t m; uint32_t sh; };
static FtDiv g_ftdiv[1 << 16];
void build_ftdiv_table() {
  for (uint32_t d = 2; d < (1u << 16); d++) {
    uint32_t L = (uint32_t)ec_ilog(d - 1);  // ceil(log2 d)
    g_ftdiv[d].m = (uint32_t)((((uint64_t)1 << (31 + L)) / d) + 1);
    g_ftdiv[d].sh = 31 + L;
  }
  // d=1: the round-up form overshoots at n = 2^31 exactly (rng starts
  // there); the identity reciprocal is exact for all n <= 2^31.
  g_ftdiv[1].m = 1u << 31;
  g_ftdiv[1].sh = 31;
}

uint32_t ec_decode(EcDec* d, uint32_t ft) {
  EC_COUNT(n_decode);
  EC_REC(0, nullptr, ft, 0, 0);
  uint32_t ext;
  if (__builtin_expect(ft < (1u << 16), 1)) {
    const FtDiv f = g_ftdiv[ft];
    ext = (uint32_t)(((uint64_t)d->rng * f.m) >> f.sh);
  } else {
    ext = d->rng / ft;
  }
  d->ext = ext;
  uint32_t s = d->val / ext;
  return ft - std::min(s + 1, ft);
}

uint32_t ec_decode_bin(EcDec* d, int bits) {
  EC_COUNT(n_decode_bin);
  EC_REC(1, nullptr, bits, 0, 0);
  d->ext = d->rng >> bits;
  uint32_t s = d->val / d->ext;
  return (1u << bits) - std::min(s + 1, (uint32_t)1u << bits);
}

void ec_dec_update(EcDec* d, uint32_t fl, uint32_t fh, uint32_t ft) {
  EC_REC(2, nullptr, fl, fh, ft);
  uint32_t s = d->ext * (ft - fh);
  d->val -= s;
  d->rng = fl > 0 ? d->ext * (fh - fl) : d->rng - s;
  ec_dec_normalize(d);
}

int ec_dec_bit_logp(EcDec* d, int logp) {
  EC_COUNT(n_bit_logp);
  EC_REC(3, nullptr, logp, 0, 0);
  uint32_t r = d->rng, dv = d->val, s = r >> logp;
  int ret = dv < s;
  if (!ret) d->val = dv - s;
  d->rng = ret ? s : r - s;
  ec_dec_normalize(d);
  return ret;
}

int ec_dec_icdf(EcDec* d, const uint8_t* icdf, int ftb) {
  EC_COUNT(n_icdf);
  EC_REC(4, icdf, ftb, 0, 0);
  uint32_t s = d->rng, dv = d->val, r = s >> ftb, t;
  int ret = -1;
  do {
    t = s;
    s = r * icdf[++ret];
  } while (dv < s);
  d->val = dv - s;
  d->rng = t - s;
  ec_dec_normalize(d);
  return ret;
}

uint32_t ec_dec_bits(EcDec* d, int bits) {
  EC_COUNT(n_bits);
  EC_REC(5, nullptr, bits, 0, 0);
  uint32_t window = d->end_window;
  int avail = d->nend_bits;
  if (avail < bits) {
    do {
      window |= (uint32_t)ec_read_byte_from_end(d) << avail;
      avail += 8;
    } while (avail <= 24);
  }
  uint32_t ret = window & ((1u << bits) - 1);
  window >>= bits;
  avail -= bits;
  d->end_window = window;
  d->nend_bits = avail;
  d->nbits_total += bits;
  return ret;
}

uint32_t ec_dec_uint(EcDec* d, uint32_t ft) {
  EC_COUNT(n_uint);
  ft--;
  int ftb = ec_ilog(ft);
  if (ftb > 8) {
    ftb -= 8;
    uint32_t ft_hi = (ft >> ftb) + 1;
    uint32_t s = ec_decode(d, ft_hi);
    ec_dec_update(d, s, s + 1, ft_hi);
    uint32_t t = (s << ftb) | ec_dec_bits(d, ftb);
    if (t <= ft) return t;
    d->error = 1;
    return ft;
  }
  ft++;
  uint32_t s = ec_decode(d, ft);
  ec_dec_update(d, s, s + 1, ft);
  return s;
}

// ------------------------------------------------------------------ laplace
int ec_laplace_decode(EcDec* d, uint32_t fs, int decay) {
  int val = 0;
  uint32_t fl = 0;
  uint32_t fm = ec_decode_bin(d, 15);
  if (fm >= fs) {
    val++;
    fl = fs;
    fs = ((32768 - 32 - fs) * (16384 - decay) >> 15) + 1;
    while (fs > 1 && fm >= fl + 2 * fs) {
      fs *= 2;
      fl += fs;
      fs = ((fs - 2) * decay >> 15) + 1;
      val++;
    }
    if (fs <= 1) {
      int di = (fm - fl) >> 1;
      val += di;
      fl += 2 * di;
    }
    if (fm < fl + fs)
      val = -val;
    else
      fl += fs;
  }
  ec_dec_update(d, fl, std::min(fl + fs, (uint32_t)32768), 32768);
  return val;
}

// ---------------------------------------------------------------- CWRS (U)
// Compact, L1-resident U(n, k) table. U is symmetric (U(n,k)=U(k,n)) and
// libopus caps V(N, K) < 2^32 via the pulse cache, which forces
// min(n, k) <= 15 for every (n, k) pair visited while decoding a valid
// stream. So we store u32 rows for k = 0..U_MAX_K_ROW only (~13 KB) and
// saturate entries >= 2^32 — saturated entries compare "huge" in the index
// walk, which matches exact u64 behaviour for any idx < 2^32 (always true,
// ec_dec_uint returns u32). Queries with both args > U_MAX_K_ROW only occur
// on corrupt streams and also saturate.
constexpr int U_MAX_N = 209;       // >= largest band size (176) + headroom
constexpr int U_MAX_K_ROW = 16;    // rows k=0..16 (walk reads k+1 <= K+1)
static uint32_t* g_u = nullptr;    // [U_MAX_K_ROW+1][U_MAX_N]
// Transposed copy: g_ut[n][k] = U(n, k) for all n < U_MAX_N, k <= 16
// (saturated, no symmetry fold). Contiguous in k, so the per-coefficient
// "find largest k' with U(m,k') <= idx" walk becomes one 64-byte load +
// vector compare instead of a mispredicting scalar loop. Padded to 32
// entries per row so a full-width load never crosses into the next row
// with garbage beyond k=16 (padding = UINT32_MAX).
constexpr int UT_STRIDE = 32;
static uint32_t* g_ut = nullptr;   // [U_MAX_N][UT_STRIDE]

void build_u_table() {
  if (g_u) return;
  g_u = (uint32_t*)calloc((size_t)(U_MAX_K_ROW + 1) * U_MAX_N,
                          sizeof(uint32_t));
  // Build in u64 via the recurrence U(n,k) = U(n-1,k)+U(n-1,k-1)+U(n,k-1),
  // row-by-row over k, then saturate-store to u32.
  std::vector<uint64_t> prev(U_MAX_N, 0), cur(U_MAX_N, 0);
  auto sat = [](uint64_t v) -> uint32_t {
    return v > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)v;
  };
  // k = 0 row: U(n, 0) = 0.
  for (int k = 1; k <= U_MAX_K_ROW; k++) {
    cur[0] = 0;
    cur[1] = 1;
    cur[2] = 2 * (uint64_t)k - 1;
    for (int n = 3; n < U_MAX_N; n++) {
      if (k == 1) {
        cur[n] = 1;
      } else {
        uint64_t v = prev[n] + prev[n - 1] + cur[n - 1];
        cur[n] = std::min<uint64_t>(v, 0x1FFFFFFFFull);  // keep sat stable
      }
    }
    for (int n = 0; n < U_MAX_N; n++)
      g_u[(size_t)k * U_MAX_N + n] = sat(cur[n]);
    std::swap(prev, cur);
  }
  g_ut = (uint32_t*)aligned_alloc(
      64, (size_t)U_MAX_N * UT_STRIDE * sizeof(uint32_t));
  for (int n = 0; n < U_MAX_N; n++) {
    g_ut[(size_t)n * UT_STRIDE + 0] = 0;  // U(n, 0) = 0
    for (int k = 1; k <= U_MAX_K_ROW; k++)
      g_ut[(size_t)n * UT_STRIDE + k] =
          g_u[(size_t)std::min(n, k) * U_MAX_N + std::max(n, k)];
    for (int k = U_MAX_K_ROW + 1; k < UT_STRIDE; k++)
      g_ut[(size_t)n * UT_STRIDE + k] = 0xFFFFFFFFu;
  }
}

inline uint32_t pvq_u(int n, int k) {
  if (k <= 0) return 0;
  if (n < k) std::swap(n, k);
  if (k > U_MAX_K_ROW || n >= U_MAX_N) return 0xFFFFFFFFu;  // corrupt stream
  return g_u[(size_t)k * U_MAX_N + n];
}

// Hot-path variant: caller guarantees n < U_MAX_N and k >= 1.
inline uint32_t pvq_u_hot(int n, int k) {
  if (n < k) std::swap(n, k);
  if (__builtin_expect(k > U_MAX_K_ROW, 0)) return 0xFFFFFFFFu;
  return g_u[(size_t)k * U_MAX_N + n];
}
inline uint32_t pvq_v(int n, int k) {
  if (k == 0) return 1;
  uint64_t v = (uint64_t)pvq_u(n, k) + pvq_u(n, k + 1);
  return v > 0xFFFFFFFFull ? 0xFFFFFFFFu : (uint32_t)v;
}

// decode pulses: returns Ryy
float decode_pulses(EcDec* d, int* iy, int n, int k) {
  uint32_t idx = ec_dec_uint(d, pvq_v(n, k));
  uint32_t ryy = 0;
  int j = 0;
  for (; j < n - 1; j++) {
    if (k == 0) break;  // no pulses left: the tail is all zeros
    int m = n - j;
#if defined(__AVX512F__)
    if (k <= 15) {
      // Branch-free: one aligned 64B load of U(m, 0..15), vector compare
      // against idx, highest qualifying k' via clz. No mispredicting scalar
      // descent. row[0] = 0 <= idx guarantees a nonzero candidate mask.
      const uint32_t* row = g_ut + (size_t)m * UT_STRIDE;
      uint32_t p = row[k + 1];
      uint32_t smask = (uint32_t) - (int)(idx >= p);
      idx -= p & smask;
      __m512i r = _mm512_load_si512((const void*)row);
      __mmask16 le =
          _mm512_cmple_epu32_mask(r, _mm512_set1_epi32((int)idx));
      uint32_t bits = (uint32_t)le & ((2u << k) - 1);
      int k_new = 31 - __builtin_clz(bits);
      idx -= row[k_new];
      uint32_t q = (uint32_t)(k - k_new);
      k = k_new;
      iy[j] = (int)((q ^ smask) - smask);  // smask ? -q : q
      ryy += q * q;
      continue;
    }
#endif
    uint32_t p = pvq_u_hot(m, k + 1);
    uint32_t smask = (uint32_t) - (int)(idx >= p);
    idx -= p & smask;
    int k0 = k;
    p = pvq_u_hot(m, k);
    while (p > idx) p = pvq_u(m, --k);
    idx -= p;
    uint32_t q = (uint32_t)(k0 - k);
    iy[j] = (int)((q ^ smask) - smask);  // smask ? -q : q
    ryy += q * q;
  }
  for (; j < n - 1; j++) iy[j] = 0;
  iy[n - 1] = idx ? -k : k;
  ryy += (uint32_t)(k * k);
  return (float)ryy;
}

// ---------------------------------------------------------------- rate/alloc
inline int get_pulses(int i) { return i < 8 ? i : (8 + (i & 7)) << ((i >> 3) - 1); }

int bits2pulses_search(int band, int lm, int bits) {
  if (bits <= 0) return 0;
  int ci = kCacheIndex[(lm + 1) * NB + band];
  if (ci < 0) return 0;
  const uint8_t* table = kCacheBits + ci;
  int lo = 0, hi = table[0];
  bits--;
  for (int i = 0; i < LOG_MAX_PSEUDO; i++) {
    int mid = (lo + hi + 1) >> 1;
    if ((int)table[mid] >= bits)
      hi = mid;
    else
      lo = mid;
  }
  int lo_val = lo == 0 ? -1 : (int)table[lo];
  return (bits - lo_val <= (int)table[hi] - bits) ? lo : hi;
}

// Direct bits -> pseudo-pulse LUT replacing the binary search (hot in
// clt_compute_allocation: ~100 lookups/frame). Entries are u8 pseudo-bit
// values, so bits-1 in [0, 255] covers everything; larger clamps to max.
constexpr int kB2PMax = 257;
uint8_t g_b2p[5 * NB][kB2PMax + 1];  // rows indexed by (lm + 1), lm in -1..3
bool g_b2p_built = false;

void build_b2p_table() {
  if (g_b2p_built) return;
  for (int lm = -1; lm <= 3; lm++)
    for (int band = 0; band < NB; band++)
      for (int bits = 0; bits <= kB2PMax; bits++)
        g_b2p[(lm + 1) * NB + band][bits] =
            (uint8_t)bits2pulses_search(band, lm, bits);
  g_b2p_built = true;
}

inline int bits2pulses(int band, int lm, int bits) {
  if (bits <= 0) return 0;
  return g_b2p[(lm + 1) * NB + band][bits < kB2PMax ? bits : kB2PMax];
}

int pulses2bits(int band, int lm, int pulses) {
  if (pulses == 0) return 0;
  int ci = kCacheIndex[(lm + 1) * NB + band];
  if (ci < 0) return 0;
  return (int)kCacheBits[ci + pulses] + 1;
}

struct Alloc {
  int pulses[NB];
  int ebits[NB];
  int fine_priority[NB];
  int coded_bands;
  int balance;
  int intensity;
  int dual_stereo;
};

void interp_bits2pulses(int start, int end, int skip_start, const int* bits1,
                        const int* bits2, const int* thresh, const int* cap,
                        int total, int skip_rsv, int intensity_rsv,
                        int dual_stereo_rsv, int C, int LM, EcDec* dec,
                        Alloc* out) {
  const int16_t* eb = kEBands;
  int alloc_floor = C << BITRES;
  int stereo = C > 1 ? 1 : 0;
  int log_m = LM << BITRES;
  int intensity = 0, dual_stereo = 0;
  int bits[NB] = {0};

  int lo = 0, hi = 1 << ALLOC_STEPS;
  for (int it = 0; it < ALLOC_STEPS; it++) {
    int mid = (lo + hi) >> 1;
    int psum = 0, done = 0;
    for (int j = end - 1; j >= start; j--) {
      int tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS);
      if (tmp >= thresh[j] || done) {
        done = 1;
        psum += std::min(tmp, cap[j]);
      } else if (tmp >= alloc_floor) {
        psum += alloc_floor;
      }
    }
    if (psum > total)
      hi = mid;
    else
      lo = mid;
  }
  int psum = 0, done = 0;
  for (int j = end - 1; j >= start; j--) {
    int tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS);
    if (tmp < thresh[j] && !done)
      tmp = tmp >= alloc_floor ? alloc_floor : 0;
    else
      done = 1;
    tmp = std::min(tmp, cap[j]);
    bits[j] = tmp;
    psum += tmp;
  }

  int coded_bands = end;
  while (coded_bands > start) {
    int j = coded_bands - 1;
    if (j <= skip_start) {
      total += skip_rsv;
      break;
    }
    int band_width = eb[coded_bands] - eb[j];
    uint32_t left = (uint32_t)(total - psum);
    int denom = eb[coded_bands] - eb[start];
    uint32_t per_coeff = left / denom;
    int32_t left2 = (int32_t)(left - denom * per_coeff);
    int rem = std::max(left2 - (eb[j] - eb[start]), 0);
    int32_t band_bits = (int32_t)(bits[j] + per_coeff * band_width + rem);
    if (band_bits >= std::max(thresh[j], alloc_floor + (1 << BITRES))) {
      if (ec_dec_bit_logp(dec, 1)) break;
      psum += 1 << BITRES;
      band_bits -= 1 << BITRES;
    }
    psum -= bits[j] + intensity_rsv;
    if (intensity_rsv > 0) intensity_rsv = kLog2FracTable[j - start];
    psum += intensity_rsv;
    if (band_bits >= alloc_floor) {
      psum += alloc_floor;
      bits[j] = alloc_floor;
    } else {
      bits[j] = 0;
    }
    coded_bands--;
  }

  if (intensity_rsv > 0)
    intensity = start + (int)ec_dec_uint(dec, coded_bands + 1 - start);
  else
    intensity = 0;
  if (intensity <= start) {
    total += dual_stereo_rsv;
    dual_stereo_rsv = 0;
  }
  if (dual_stereo_rsv > 0)
    dual_stereo = ec_dec_bit_logp(dec, 1);
  else
    dual_stereo = 0;

  int denom = std::max(eb[coded_bands] - eb[start], 1);
  uint32_t left = (uint32_t)(total - psum);
  uint32_t per_coeff = left / denom;
  int32_t leftr = (int32_t)(left - denom * per_coeff);
  for (int j = start; j < coded_bands; j++)
    bits[j] += (int)per_coeff * (eb[j + 1] - eb[j]);
  for (int j = start; j < coded_bands; j++) {
    int add = std::min((int)(eb[j + 1] - eb[j]), (int)leftr);
    bits[j] += add;
    leftr -= add;
  }

  int balance = 0;
  for (int j = start; j < coded_bands; j++) {
    int n0 = eb[j + 1] - eb[j];
    int n = n0 << LM;
    int bit = bits[j] + balance;
    int excess = 0;
    if (n > 1) {
      excess = std::max(bit - cap[j], 0);
      bits[j] = bit - excess;
      int den = C * n;
      if (C == 2 && n > 2 && dual_stereo == 0 && j < intensity) den++;
      int nclogn = den * ((int)kLogN[j] + log_m);
      int offset = (nclogn >> 1) - den * FINE_OFFSET;
      if (n == 2) offset += den << (BITRES - 2);
      if (bits[j] + offset < (den * 2) << BITRES)
        offset += nclogn >> 2;
      else if (bits[j] + offset < (den * 3) << BITRES)
        offset += nclogn >> 3;
      int ebv = std::max(0, bits[j] + offset + (den << (BITRES - 1)));
      ebv = ((uint32_t)ebv / den) >> BITRES;
      if (C * ebv > (bits[j] >> BITRES)) ebv = bits[j] >> stereo >> BITRES;
      ebv = std::min(ebv, MAX_FINE_BITS);
      out->fine_priority[j] = ebv * (den << BITRES) >= bits[j] + offset;
      bits[j] -= (C * ebv) << BITRES;
      out->ebits[j] = ebv;
    } else {
      excess = std::max(0, bit - (C << BITRES));
      bits[j] = bit - excess;
      out->ebits[j] = 0;
      out->fine_priority[j] = 1;
    }
    if (excess > 0) {
      int extra_fine =
          std::min(excess >> (stereo + BITRES), MAX_FINE_BITS - out->ebits[j]);
      out->ebits[j] += extra_fine;
      int extra_bits = (extra_fine * C) << BITRES;
      out->fine_priority[j] = extra_bits >= excess - balance;
      excess -= extra_bits;
    }
    balance = excess;
    out->pulses[j] = bits[j];
  }
  for (int j = coded_bands; j < end; j++) {
    out->ebits[j] = bits[j] >> stereo >> BITRES;
    out->pulses[j] = 0;
    out->fine_priority[j] = out->ebits[j] < 1;
  }
  out->coded_bands = coded_bands;
  out->balance = balance;
  out->intensity = intensity;
  out->dual_stereo = dual_stereo;
}

void clt_compute_allocation(int start, int end, const int* offsets,
                            const int* cap, int alloc_trim, int total, int C,
                            int LM, EcDec* dec, Alloc* out) {
  const int16_t* eb = kEBands;
  total = std::max(total, 0);
  int skip_start = start;
  int skip_rsv = 0;
  if (total >= 1 << BITRES) {
    skip_rsv = 1 << BITRES;
    total -= skip_rsv;
  }
  int intensity_rsv = 0, dual_stereo_rsv = 0;
  if (C == 2) {
    int cand = kLog2FracTable[end - start];
    if (cand <= total) {
      intensity_rsv = cand;
      total -= cand;
      if (total >= 1 << BITRES) {
        dual_stereo_rsv = 1 << BITRES;
        total -= dual_stereo_rsv;
      }
    }
  }
  int thresh[NB], trim_offset[NB];
  for (int j = start; j < end; j++) {
    int n = eb[j + 1] - eb[j];
    thresh[j] = std::max(C << BITRES, (3 * n) << (LM + BITRES) >> 4);
    trim_offset[j] = (C * n * (alloc_trim - 5 - LM) * (end - j - 1) *
                      (1 << (LM + BITRES))) >>
                     6;
    if ((n << LM) == 1) trim_offset[j] -= C << BITRES;
  }
  int lo = 1, hi = 11 - 1;
  while (lo <= hi) {
    int mid = (lo + hi) >> 1;
    int psum = 0, done = 0;
    for (int j = end - 1; j >= start; j--) {
      int n = eb[j + 1] - eb[j];
      int bitsj = (C * n * kAllocVectors[mid * NB + j]) << LM >> 2;
      if (bitsj > 0) bitsj = std::max(0, bitsj + trim_offset[j]);
      bitsj += offsets[j];
      if (bitsj >= thresh[j] || done) {
        done = 1;
        psum += std::min(bitsj, cap[j]);
      } else if (bitsj >= C << BITRES) {
        psum += C << BITRES;
      }
    }
    if (psum > total)
      hi = mid - 1;
    else
      lo = mid + 1;
  }
  hi = lo;
  lo -= 1;
  int bits1[NB] = {0}, bits2[NB] = {0};
  for (int j = start; j < end; j++) {
    int n = eb[j + 1] - eb[j];
    int b1 = (C * n * kAllocVectors[lo * NB + j]) << LM >> 2;
    int b2 = hi >= 11 ? cap[j] : (C * n * kAllocVectors[hi * NB + j]) << LM >> 2;
    if (b1 > 0) b1 = std::max(0, b1 + trim_offset[j]);
    if (b2 > 0) b2 = std::max(0, b2 + trim_offset[j]);
    if (lo > 0) b1 += offsets[j];
    b2 += offsets[j];
    if (offsets[j] > 0) skip_start = j;
    bits1[j] = b1;
    bits2[j] = std::max(0, b2 - b1);
  }
  interp_bits2pulses(start, end, skip_start, bits1, bits2, thresh, cap, total,
                     skip_rsv, intensity_rsv, dual_stereo_rsv, C, LM, dec, out);
}

}  // namespace

// ------------------------------------------------------------------ vq
namespace {

const int kSpreadFactor[3] = {15, 10, 5};

#if defined(__AVX512F__)
// The stride-1 Givens chain is a first-order linear recurrence:
//   forward pass:  a_{i+1} = c*b_{i+1} + s*a_i ;  X[i] = c*a_i - s*b_{i+1}
//   backward pass: d_i = c*y_i - s*d_{i+1}     ;  X[i+1] = c*d_{i+1} + s*y_i
// so it parallelizes 16-wide with a log-step in-register prefix scan.
inline __m512 shift_up1(__m512 v) {  // lane k <- lane k-1, lane 0 <- 0
  return _mm512_castsi512_ps(_mm512_alignr_epi32(
      _mm512_castps_si512(v), _mm512_setzero_si512(), 15));
}
inline __m512 shift_upN(__m512 v, int n) {
  switch (n) {
    case 2: return _mm512_castsi512_ps(_mm512_alignr_epi32(
        _mm512_castps_si512(v), _mm512_setzero_si512(), 14));
    case 4: return _mm512_castsi512_ps(_mm512_alignr_epi32(
        _mm512_castps_si512(v), _mm512_setzero_si512(), 12));
    default: return _mm512_castsi512_ps(_mm512_alignr_epi32(
        _mm512_castps_si512(v), _mm512_setzero_si512(), 8));
  }
}
inline __m512 shift_dn1(__m512 v) {  // lane k <- lane k+1, lane 15 <- 0
  return _mm512_castsi512_ps(_mm512_alignr_epi32(
      _mm512_setzero_si512(), _mm512_castps_si512(v), 1));
}
inline __m512 shift_dnN(__m512 v, int n) {
  switch (n) {
    case 2: return _mm512_castsi512_ps(_mm512_alignr_epi32(
        _mm512_setzero_si512(), _mm512_castps_si512(v), 2));
    case 4: return _mm512_castsi512_ps(_mm512_alignr_epi32(
        _mm512_setzero_si512(), _mm512_castps_si512(v), 4));
    default: return _mm512_castsi512_ps(_mm512_alignr_epi32(
        _mm512_setzero_si512(), _mm512_castps_si512(v), 8));
  }
}

void exp_rotation1_s1(float* X, int len, float c, float s) {
  alignas(64) float tmp[16];
  const __m512 vc = _mm512_set1_ps(c);
  const __m512 vs1 = _mm512_set1_ps(s);
  const __m512 vs2 = _mm512_set1_ps(s * s);
  const __m512 vs4 = _mm512_set1_ps(s * s * s * s);
  const __m512 vs8 = _mm512_mul_ps(vs4, vs4);
  // powup[k] = s^(k+1)
  for (int k = 0; k < 16; k++) tmp[k] = (float)std::pow((double)s, k + 1);
  const __m512 powup = _mm512_load_ps(tmp);

  // ---- forward pass over i = 0 .. len-2
  float a = X[0];
  int i = 0;
  for (; i + 16 <= len - 1; i += 16) {
    __m512 b = _mm512_loadu_ps(X + i + 1);
    __m512 t = _mm512_mul_ps(vc, b);
    t = _mm512_fmadd_ps(vs1, shift_up1(t), t);
    t = _mm512_fmadd_ps(vs2, shift_upN(t, 2), t);
    t = _mm512_fmadd_ps(vs4, shift_upN(t, 4), t);
    t = _mm512_fmadd_ps(vs8, shift_upN(t, 8), t);
    __m512 scan = _mm512_fmadd_ps(powup, _mm512_set1_ps(a), t);
    // aused[k] = a_{i+k}: scan shifted up one with carry a in lane 0
    __m512 aused = _mm512_castsi512_ps(_mm512_alignr_epi32(
        _mm512_castps_si512(scan),
        _mm512_castps_si512(_mm512_set1_ps(a)), 15));
    _mm512_storeu_ps(X + i, _mm512_fmsub_ps(vc, aused, _mm512_mul_ps(vs1, b)));
    _mm512_store_ps(tmp, scan);
    a = tmp[15];
  }
  for (; i < len - 1; i++) {
    float b = X[i + 1];
    X[i] = c * a - s * b;
    a = c * b + s * a;
  }
  X[len - 1] = a;

  // ---- backward pass over i = len-3 .. 0  (d_i = c*y_i - s*d_{i+1})
  if (len < 3) return;
  const __m512 vm1 = _mm512_set1_ps(-s);
  const __m512 vm2 = vs2;
  const __m512 vm4 = vs4;
  const __m512 vm8 = vs8;
  // powdn[k] = (-s)^(16-k)
  for (int k = 0; k < 16; k++) tmp[k] = (float)std::pow((double)-s, 16 - k);
  const __m512 powdn = _mm512_load_ps(tmp);

  float d = X[len - 2];
  int iend = len - 3;  // first (highest) index of the pass
  int ilo = iend;
  // blocks [I, I+15] descending; at block, inputs y_{I..I+15}, carry d_{I+16}
  while (ilo - 15 >= 0) {
    int I = ilo - 15;
    __m512 y = _mm512_loadu_ps(X + I);
    __m512 t = _mm512_mul_ps(vc, y);
    t = _mm512_fmadd_ps(vm1, shift_dn1(t), t);
    t = _mm512_fmadd_ps(vm2, shift_dnN(t, 2), t);
    t = _mm512_fmadd_ps(vm4, shift_dnN(t, 4), t);
    t = _mm512_fmadd_ps(vm8, shift_dnN(t, 8), t);
    __m512 dvec = _mm512_fmadd_ps(powdn, _mm512_set1_ps(d), t);
    // dnext[k] = d_{I+k+1}: dvec shifted down one with carry d in lane 15
    __m512 dnext = _mm512_castsi512_ps(_mm512_alignr_epi32(
        _mm512_castps_si512(_mm512_set1_ps(d)),
        _mm512_castps_si512(dvec), 1));
    _mm512_storeu_ps(X + I + 1,
                     _mm512_fmadd_ps(vc, dnext, _mm512_mul_ps(vs1, y)));
    _mm512_store_ps(tmp, dvec);
    d = tmp[0];
    ilo = I - 1;
  }
  for (int j = ilo; j >= 0; j--) {
    float y = X[j];
    X[j + 1] = c * d + s * y;
    d = c * y - s * d;
  }
  X[0] = d;
}
#endif  // __AVX512F__

void exp_rotation1(float* X, int len, int stride, float c, float s) {
#if defined(__AVX512F__)
  if (stride == 1 && len >= 48) {
    exp_rotation1_s1(X, len, c, s);
    return;
  }
#endif
  float ms = -s;
  for (int i = 0; i < len - stride; i++) {
    float x1 = X[i], x2 = X[i + stride];
    X[i + stride] = c * x2 + s * x1;
    X[i] = c * x1 + ms * x2;
  }
  for (int i = len - 2 * stride - 1; i >= 0; i--) {
    float x1 = X[i], x2 = X[i + stride];
    X[i + stride] = c * x2 + s * x1;
    X[i] = c * x1 + ms * x2;
  }
}

void exp_rotation(float* X, int len, int direction, int stride, int K,
                  int spread) {
  if (2 * K >= len || spread == 0) return;
  int factor = kSpreadFactor[spread - 1];
  float gain = (float)len / (len + factor * K);
  float theta = 0.5 * gain * gain;
  float c = cos(0.5 * M_PI * theta);
  float s = cos(0.5 * M_PI * (1 - theta));
  int stride2 = 0;
  if (len >= 8 * stride) {
    stride2 = 1;
    while ((stride2 * stride2 + stride2) * stride + (stride >> 2) < len)
      stride2++;
  }
  len /= stride;
  for (int i = 0; i < stride; i++) {
    float* seg = X + i * len;
    if (direction < 0) {
      if (stride2) exp_rotation1(seg, len, stride2, s, c);
      exp_rotation1(seg, len, 1, c, s);
    } else {
      exp_rotation1(seg, len, 1, c, -s);
      if (stride2) exp_rotation1(seg, len, stride2, s, -c);
    }
  }
}

uint32_t extract_collapse_mask(const int* iy, int N, int B) {
  if (B <= 1) return 1;
  int N0 = N / B;
  uint32_t mask = 0;
  for (int i = 0; i < B; i++) {
    int tmp = 0;
    for (int j = 0; j < N0; j++) tmp |= iy[i * N0 + j];
    mask |= (uint32_t)(tmp != 0) << i;
  }
  return mask;
}

void renormalise_vector(float* X, int N, float gain) {
  double E = 1e-15;
  for (int i = 0; i < N; i++) E += (double)X[i] * X[i];
  float g = gain / sqrt(E);
  for (int i = 0; i < N; i++) X[i] *= g;
}

uint32_t alg_unquant(float* X, int N, int K, int spread, int B, EcDec* dec,
                     float gain) {
  int iy[208];
  float ryy = decode_pulses(dec, iy, N, K);
  float g = gain / sqrt(ryy);
  for (int i = 0; i < N; i++) X[i] = iy[i] * g;
  exp_rotation(X, N, -1, B, K, spread);
  return extract_collapse_mask(iy, N, B);
}

// ------------------------------------------------------------------ bands
// Exact reciprocal division for the small divisors on the theta hot path
// (qn <= 512, n2 = 2N-1 <= 351): q = n * ceil(2^33/d) >> 33 is exact for
// n*d < 2^33 (here n <= 16384*512, d <= 512 -> n*d < 2^33 holds for every
// call site), turning 3 idivs/split into multiplies.
constexpr int kRecipMax = 512;
static uint64_t g_recip33[kRecipMax + 1];
void build_recip_table() {
  for (int d = 1; d <= kRecipMax; d++)
    g_recip33[d] = ((1ULL << 33) + d - 1) / d;
}
inline uint32_t fast_udiv(uint32_t n, int d) {
  return (uint32_t)(((uint64_t)n * g_recip33[d]) >> 33);
}

const int kExp2Table8[8] = {16384, 17866, 19483, 21247, 23170, 25267, 27554, 30048};
const int kBitInterleave[16] = {0, 1, 1, 1, 2, 3, 3, 3, 2, 3, 3, 3, 2, 3, 3, 3};
const int kBitDeinterleave[16] = {0x00, 0x03, 0x0C, 0x0F, 0x30, 0x33, 0x3C, 0x3F,
                                  0xC0, 0xC3, 0xCC, 0xCF, 0xF0, 0xF3, 0xFC, 0xFF};
const int kOrdery2[2] = {1, 0};
const int kOrdery4[4] = {3, 0, 2, 1};
const int kOrdery8[8] = {7, 0, 4, 3, 6, 1, 5, 2};
const int kOrdery16[16] = {15, 0, 8, 7, 12, 3, 11, 4, 14, 1, 9, 6, 13, 2, 10, 5};

const int* ordery_for(int stride) {
  switch (stride) {
    case 2: return kOrdery2;
    case 4: return kOrdery4;
    case 8: return kOrdery8;
    default: return kOrdery16;
  }
}

inline uint32_t lcg_rand(uint32_t seed) {
  return 1664525u * seed + 1013904223u;
}

inline int frac_mul16(int a, int b) { return (16384 + a * b) >> 15; }

int bitexact_cos(int x) {
  int tmp = (4096 + x * x) >> 13;
  int x2 = tmp;
  x2 = (32767 - x2) +
       frac_mul16(x2, -7651 + frac_mul16(x2, 8277 + frac_mul16(-626, x2)));
  return 1 + x2;
}

int bitexact_log2tan(int isin, int icos) {
  int lc = ec_ilog((uint32_t)icos);
  int ls = ec_ilog((uint32_t)isin);
  icos <<= 15 - lc;
  isin <<= 15 - ls;
  return (ls - lc) * (1 << 11) +
         frac_mul16(isin, frac_mul16(isin, -2597) + 7932) -
         frac_mul16(icos, frac_mul16(icos, -2597) + 7932);
}

inline uint32_t isqrt32(uint32_t v) {
  // theta-path arguments are < 8*(qn/2+1)^2+1 <= ~133k, exact in f32;
  // sqrtf is ~20 cycles cheaper than the double path, fixups keep it exact
  uint32_t r = (uint32_t)sqrtf((float)v);
  while (r > 0 && (uint64_t)r * r > v) r--;
  while ((uint64_t)(r + 1) * (r + 1) <= v) r++;
  return r;
}

int compute_qn(int N, int b, int offset, int pulse_cap, bool stereo) {
  int n2 = 2 * N - 1;
  if (stereo && N == 2) n2--;
  int num = b + n2 * offset;
  int qb = num >= 0 ? (int)fast_udiv((uint32_t)num, n2)
                    : -(int)fast_udiv((uint32_t)(-num), n2);
  qb = std::min(b - pulse_cap - (4 << BITRES), qb);
  qb = std::min(8 << BITRES, qb);
  if (qb < (1 << BITRES >> 1)) return 1;
  int qn = kExp2Table8[qb & 0x7] >> (14 - (qb >> 3));
  qn = ((qn + 1) >> 1) << 1;
  return qn;
}

void haar1(float* X, int n0, int stride) {
  n0 >>= 1;
  const float s = 0.70710678;
  for (int i = 0; i < stride; i++)
    for (int j = 0; j < n0; j++) {
      int i1 = i + stride * 2 * j;
      int i2 = i1 + stride;
      float t1 = s * X[i1];
      float t2 = s * X[i2];
      X[i1] = t1 + t2;
      X[i2] = t1 - t2;
    }
}

void interleave_hadamard(float* X, int n0, int stride, bool hadamard) {
  int N = n0 * stride;
  float tmp[1024];
  if (hadamard) {
    const int* ordery = ordery_for(stride);
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < n0; j++) tmp[j * stride + i] = X[ordery[i] * n0 + j];
  } else {
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < n0; j++) tmp[j * stride + i] = X[i * n0 + j];
  }
  memcpy(X, tmp, N * sizeof(float));
}

void deinterleave_hadamard(float* X, int n0, int stride, bool hadamard) {
  int N = n0 * stride;
  float tmp[1024];
  if (hadamard) {
    const int* ordery = ordery_for(stride);
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < n0; j++) tmp[ordery[i] * n0 + j] = X[j * stride + i];
  } else {
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < n0; j++) tmp[i * n0 + j] = X[j * stride + i];
  }
  memcpy(X, tmp, N * sizeof(float));
}

void stereo_merge(float* X, float* Y, float mid, int N) {
  // Accumulate in double: el/er feed a 6e-4 threshold branch that must
  // match the float64 Python host decoder.
  double xp = 0, side = 0;
  for (int i = 0; i < N; i++) {
    xp += (double)X[i] * Y[i];
    side += (double)Y[i] * Y[i];
  }
  xp *= mid;
  double el = (double)mid * mid + side - 2 * xp;
  double er = (double)mid * mid + side + 2 * xp;
  if (er < 6e-4 || el < 6e-4) {
    memcpy(Y, X, N * sizeof(float));
    return;
  }
  float lgain = 1.0 / sqrt(el);
  float rgain = 1.0 / sqrt(er);
  for (int i = 0; i < N; i++) {
    float l = mid * X[i];
    float r = Y[i];
    X[i] = lgain * (l - r);
    Y[i] = rgain * (l + r);
  }
}

struct BandCtx {
  int i;
  int intensity;
  int spread;
  int tf_change;
  EcDec* ec;
  int remaining_bits;
  uint32_t seed;
  bool disable_inv;
  bool avoid_split_noise;  // unused on decode, kept for parity
};

struct SplitCtx {
  int inv, imid, iside, delta, itheta, qalloc;
};

void compute_theta_impl(EcDec* ec, int i, int intensity, int remaining_bits,
                        bool disable_inv, SplitCtx* sctx, int N, int* b,
                        int B, int B0, int LM, bool stereo, uint32_t* fill) {
  PROF_SCOPE_SUB(THETA);
  int inv = 0, itheta = 0;

  int pulse_cap = (int)kLogN[i] + LM * (1 << BITRES);
  int offset = (pulse_cap >> 1) -
               (stereo && N == 2 ? QTHETA_OFFSET_TWOPHASE : QTHETA_OFFSET);
  int qn = compute_qn(N, b[0], offset, pulse_cap, stereo);
  if (stereo && i >= intensity) qn = 1;
  int tell = ec_tell_frac(ec);
  if (qn != 1) {
    if (stereo && N > 2) {
      const int p0 = 3;
      int x0 = qn / 2;
      uint32_t ft = (uint32_t)(p0 * (x0 + 1) + x0);
      uint32_t fs = ec_decode(ec, ft);
      int x;
      if (fs < (uint32_t)((x0 + 1) * p0))
        x = fs / p0;
      else
        x = x0 + 1 + (int)(fs - (x0 + 1) * p0);
      uint32_t fl = x <= x0 ? (uint32_t)(p0 * x)
                            : (uint32_t)((x - 1 - x0) + (x0 + 1) * p0);
      uint32_t fh = x <= x0 ? (uint32_t)(p0 * (x + 1))
                            : (uint32_t)((x - x0) + (x0 + 1) * p0);
      ec_dec_update(ec, fl, fh, ft);
      itheta = x;
    } else if (B0 > 1 || stereo) {
      itheta = (int)ec_dec_uint(ec, (uint32_t)(qn + 1));
    } else {
      uint32_t ft = (uint32_t)(((qn >> 1) + 1) * ((qn >> 1) + 1));
      uint32_t fm = ec_decode(ec, ft);
      uint32_t fl, fs;
      if (fm < (uint32_t)((qn >> 1) * ((qn >> 1) + 1) >> 1)) {
        itheta = (int)((isqrt32(8 * fm + 1) - 1) >> 1);
        fs = itheta + 1;
        fl = (uint32_t)(itheta * (itheta + 1) >> 1);
      } else {
        itheta = (int)((2 * (qn + 1) - isqrt32(8 * (ft - fm - 1) + 1)) >> 1);
        fs = qn + 1 - itheta;
        fl = ft - (uint32_t)((qn + 1 - itheta) * (qn + 2 - itheta) >> 1);
      }
      ec_dec_update(ec, fl, fl + fs, ft);
    }
    itheta = (int)fast_udiv((uint32_t)(itheta * 16384), qn);
  } else if (stereo) {
    if (b[0] > 2 << BITRES && remaining_bits > 2 << BITRES)
      inv = ec_dec_bit_logp(ec, 2);
    else
      inv = 0;
    if (disable_inv) inv = 0;
    itheta = 0;
  }
  int qalloc = ec_tell_frac(ec) - tell;
  b[0] -= qalloc;

  int imid, iside, delta;
  if (itheta == 0) {
    imid = 32767;
    iside = 0;
    fill[0] &= (1u << B) - 1;
    delta = -16384;
  } else if (itheta == 16384) {
    imid = 0;
    iside = 32767;
    fill[0] &= ((1u << B) - 1) << B;
    delta = 16384;
  } else {
    imid = bitexact_cos(itheta);
    iside = bitexact_cos(16384 - itheta);
    delta = frac_mul16((N - 1) << 7, bitexact_log2tan(iside, imid));
  }
  sctx->inv = inv;
  sctx->imid = imid;
  sctx->iside = iside;
  sctx->delta = delta;
  sctx->itheta = itheta;
  sctx->qalloc = qalloc;
}

void compute_theta(BandCtx* ctx, SplitCtx* sctx, float* X, float* Y, int N,
                   int* b, int B, int B0, int LM, bool stereo, uint32_t* fill) {
  (void)X;
  (void)Y;
  compute_theta_impl(ctx->ec, ctx->i, ctx->intensity, ctx->remaining_bits,
                     ctx->disable_inv, sctx, N, b, B, B0, LM, stereo, fill);
}

uint32_t quant_band_n1(BandCtx* ctx, float* X, float* Y, float* lowband_out) {
  EcDec* ec = ctx->ec;
  float* chans[2] = {X, Y};
  int nch = Y ? 2 : 1;
  for (int c = 0; c < nch; c++) {
    int sign = 0;
    if (ctx->remaining_bits >= 1 << BITRES) {
      sign = (int)ec_dec_bits(ec, 1);
      ctx->remaining_bits -= 1 << BITRES;
    }
    chans[c][0] = sign ? -1.0 : 1.0;
  }
  if (lowband_out) lowband_out[0] = X[0];
  return 1;
}

uint32_t quant_partition(BandCtx* ctx, float* X, int N, int b, int B,
                         float* lowband, int LM, float gain, uint32_t fill) {
  int i = ctx->i;
  EcDec* ec = ctx->ec;
  int B0 = B;
  uint32_t cm = 0;

  int cache_index = kCacheIndex[(LM + 1) * NB + i];
  const uint8_t* cache = kCacheBits + (cache_index < 0 ? 0 : cache_index);
  bool can_split = cache_index >= 0 && LM != -1 &&
                   b > (int)cache[cache[0]] + 12 && N > 2;
  if (can_split) {
    N >>= 1;
    float* Y = X + N;
    LM -= 1;
    if (B == 1) fill = (fill & 1) | (fill << 1);
    B = (B + 1) >> 1;

    SplitCtx sctx;
    int b_box = b;
    uint32_t fill_box = fill;
    compute_theta(ctx, &sctx, X, Y, N, &b_box, B, B0, LM, false, &fill_box);
    b = b_box;
    fill = fill_box;
    int delta = sctx.delta, itheta = sctx.itheta, qalloc = sctx.qalloc;
    float mid = sctx.imid / 32768.0;
    float side = sctx.iside / 32768.0;

    if (B0 > 1 && (itheta & 0x3FFF)) {
      if (itheta > 8192)
        delta -= delta >> (4 - LM);
      else
        delta = std::min(0, delta + (N << BITRES >> (5 - LM)));
    }
    // floor-div by 2 like Python's //
    int bd = b - delta;
    int half = bd >= 0 ? bd / 2 : -((-bd + 1) / 2);
    int mbits = std::max(0, std::min(b, half));
    int sbits = b - mbits;
    ctx->remaining_bits -= qalloc;

    float* next_lowband2 = lowband ? lowband + N : nullptr;

    int rebalance = ctx->remaining_bits;
    if (mbits >= sbits) {
      cm = quant_partition(ctx, X, N, mbits, B, lowband, LM, gain * mid, fill);
      rebalance = mbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << BITRES && itheta != 0)
        sbits += rebalance - (3 << BITRES);
      cm |= quant_partition(ctx, Y, N, sbits, B, next_lowband2, LM,
                            gain * side, fill >> B)
            << (B0 >> 1);
    } else {
      cm = quant_partition(ctx, Y, N, sbits, B, next_lowband2, LM, gain * side,
                           fill >> B)
           << (B0 >> 1);
      rebalance = sbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << BITRES && itheta != 16384)
        mbits += rebalance - (3 << BITRES);
      cm |= quant_partition(ctx, X, N, mbits, B, lowband, LM, gain * mid, fill);
    }
  } else {
    int q = bits2pulses(i, LM, b);
    int curr_bits = pulses2bits(i, LM, q);
    ctx->remaining_bits -= curr_bits;
    while (ctx->remaining_bits < 0 && q > 0) {
      ctx->remaining_bits += curr_bits;
      q--;
      curr_bits = pulses2bits(i, LM, q);
      ctx->remaining_bits -= curr_bits;
    }
    if (q != 0) {
      int K = get_pulses(q);
      cm = alg_unquant(X, N, K, ctx->spread, B, ec, gain);
    } else {
      uint32_t cm_mask = (1u << B) - 1;
      fill &= cm_mask;
      if (!fill) {
        memset(X, 0, N * sizeof(float));
      } else {
        if (!lowband) {
          for (int j = 0; j < N; j++) {
            ctx->seed = lcg_rand(ctx->seed);
            X[j] = (float)((int32_t)ctx->seed >> 20);
          }
          cm = cm_mask;
        } else {
          for (int j = 0; j < N; j++) {
            ctx->seed = lcg_rand(ctx->seed);
            float tmp = 1.0 / 256;
            X[j] = (ctx->seed & 0x8000) ? lowband[j] + tmp : lowband[j] - tmp;
          }
          cm = fill;
        }
        renormalise_vector(X, N, gain);
      }
    }
  }
  return cm;
}

uint32_t quant_band(BandCtx* ctx, float* X, int N, int b, int B,
                    float* lowband, int LM, float* lowband_out, float gain,
                    float* lowband_scratch, uint32_t fill) {
  int N0 = N;
  int N_B = N / B;
  int B0 = B;
  int time_divide = 0;
  int recombine = 0;
  bool long_blocks = B0 == 1;
  int tf_change = ctx->tf_change;

  if (N == 1) return quant_band_n1(ctx, X, nullptr, lowband_out);

  if (tf_change > 0) recombine = tf_change;

  if (lowband_scratch && lowband &&
      (recombine || ((N_B & 1) == 0 && tf_change < 0) || B0 > 1)) {
    memcpy(lowband_scratch, lowband, N * sizeof(float));
    lowband = lowband_scratch;
  }

  for (int k = 0; k < recombine; k++) {
    if (lowband) haar1(lowband, N >> k, 1 << k);
    fill = kBitInterleave[fill & 0xF] | kBitInterleave[(fill >> 4) & 0xF] << 2;
  }
  B >>= recombine;
  N_B <<= recombine;

  while ((N_B & 1) == 0 && tf_change < 0) {
    if (lowband) haar1(lowband, N_B, B);
    fill |= fill << B;
    B <<= 1;
    N_B >>= 1;
    time_divide++;
    tf_change++;
  }
  B0 = B;
  int N_B0 = N_B;

  if (B0 > 1 && lowband)
    deinterleave_hadamard(lowband, N_B >> recombine, B0 << recombine,
                          long_blocks);

  uint32_t cm = quant_partition(ctx, X, N, b, B, lowband, LM, gain, fill);

  // resynthesis (always on for decode)
  if (B0 > 1)
    interleave_hadamard(X, N_B >> recombine, B0 << recombine, long_blocks);
  N_B = N_B0;
  B = B0;
  for (int k = 0; k < time_divide; k++) {
    B >>= 1;
    N_B <<= 1;
    cm |= cm >> B;
    haar1(X, N_B, B);
  }
  for (int k = 0; k < recombine; k++) {
    cm = kBitDeinterleave[cm & 0xF];
    haar1(X, N0 >> k, 1 << k);
  }
  B <<= recombine;

  if (lowband_out) {
    float n = sqrt((float)N0);
    for (int j = 0; j < N0; j++) lowband_out[j] = n * X[j];
  }
  cm &= (1u << B) - 1;
  return cm;
}

uint32_t quant_band_stereo(BandCtx* ctx, float* X, float* Y, int N, int b,
                           int B, float* lowband, int LM, float* lowband_out,
                           float* lowband_scratch, uint32_t fill) {
  if (N == 1) return quant_band_n1(ctx, X, Y, lowband_out);

  EcDec* ec = ctx->ec;
  uint32_t orig_fill = fill;
  SplitCtx sctx;
  int b_box = b;
  uint32_t fill_box = fill;
  compute_theta(ctx, &sctx, X, Y, N, &b_box, B, B, LM, true, &fill_box);
  b = b_box;
  fill = fill_box;
  int inv = sctx.inv, delta = sctx.delta, itheta = sctx.itheta,
      qalloc = sctx.qalloc;
  float mid = sctx.imid / 32768.0;
  float side = sctx.iside / 32768.0;
  uint32_t cm;

  if (N == 2) {
    int mbits = b;
    int sbits = 0;
    if (itheta != 0 && itheta != 16384) sbits = 1 << BITRES;
    mbits -= sbits;
    bool c = itheta > 8192;
    ctx->remaining_bits -= qalloc + sbits;
    float* x2 = c ? Y : X;
    float* y2 = c ? X : Y;
    int sign = 0;
    if (sbits) sign = (int)ec_dec_bits(ec, 1);
    sign = 1 - 2 * sign;
    cm = quant_band(ctx, x2, N, mbits, B, lowband, LM, lowband_out, 1.0,
                    lowband_scratch, orig_fill);
    y2[0] = -sign * x2[1];
    y2[1] = sign * x2[0];
    X[0] *= mid;
    X[1] *= mid;
    Y[0] *= side;
    Y[1] *= side;
    float tmp = X[0];
    X[0] = tmp - Y[0];
    Y[0] = tmp + Y[0];
    tmp = X[1];
    X[1] = tmp - Y[1];
    Y[1] = tmp + Y[1];
  } else {
    int bd = b - delta;
    int half = bd >= 0 ? bd / 2 : -((-bd + 1) / 2);
    int mbits = std::max(0, std::min(b, half));
    int sbits = b - mbits;
    ctx->remaining_bits -= qalloc;
    int rebalance = ctx->remaining_bits;
    if (mbits >= sbits) {
      cm = quant_band(ctx, X, N, mbits, B, lowband, LM, lowband_out, 1.0,
                      lowband_scratch, fill);
      rebalance = mbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << BITRES && itheta != 0)
        sbits += rebalance - (3 << BITRES);
      cm |= quant_band(ctx, Y, N, sbits, B, nullptr, LM, nullptr, side,
                       nullptr, fill >> B);
    } else {
      cm = quant_band(ctx, Y, N, sbits, B, nullptr, LM, nullptr, side, nullptr,
                      fill >> B);
      rebalance = sbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << BITRES && itheta != 16384)
        mbits += rebalance - (3 << BITRES);
      cm |= quant_band(ctx, X, N, mbits, B, lowband, LM, lowband_out, 1.0,
                       lowband_scratch, fill);
    }
  }
  if (N != 2) stereo_merge(X, Y, mid, N);
  if (inv)
    for (int j = 0; j < N; j++) Y[j] = -Y[j];
  return cm;
}

void special_hybrid_folding(float* norm, float* norm2, int start, int M,
                            int dual_stereo) {
  int n1 = M * (kEBands[start + 1] - kEBands[start]);
  int n2 = M * (kEBands[start + 2] - kEBands[start + 1]);
  memmove(norm + n1, norm + 2 * n1 - n2, (n2 - n1) * sizeof(float));
  if (dual_stereo)
    memmove(norm2 + n1, norm2 + 2 * n1 - n2, (n2 - n1) * sizeof(float));
}

uint32_t quant_all_bands_dec(int start, int end, float* X_, float* Y_,
                             uint8_t* collapse_masks, const int* pulses,
                             bool short_blocks, int spread, int dual_stereo,
                             int intensity, const int* tf_res, int total_bits,
                             int balance, EcDec* ec, int LM, int coded_bands,
                             uint32_t seed, bool disable_inv, float* norm_buf,
                             float* scratch_buf) {
  int M = 1 << LM;
  int B = short_blocks ? M : 1;
  int norm_offset = M * kEBands[start];
  int C = Y_ ? 2 : 1;
  int norm_len = M * kEBands[kNbEBands - 1] - norm_offset;
  float* norm = norm_buf;
  float* norm2 = C == 2 ? norm_buf + norm_len : norm;
  memset(norm, 0, norm_len * sizeof(float));
  if (C == 2) memset(norm2, 0, norm_len * sizeof(float));
  float* lowband_scratch = scratch_buf;

  BandCtx ctx;
  ctx.intensity = intensity;
  ctx.spread = spread;
  ctx.ec = ec;
  ctx.seed = seed;
  ctx.disable_inv = disable_inv;
  ctx.avoid_split_noise = B > 1;

  int lowband_offset = 0;
  bool update_lowband = true;
  for (int i = start; i < end; i++) {
    ctx.i = i;
    bool last = i == end - 1;
    float* X = X_ + M * kEBands[i];
    float* Y = Y_ ? Y_ + M * kEBands[i] : nullptr;
    int N = M * kEBands[i + 1] - M * kEBands[i];
    int tell = ec_tell_frac(ec);

    if (i != start) balance -= tell;
    int remaining_bits = total_bits - tell - 1;
    ctx.remaining_bits = remaining_bits;
    int b;
    if (i <= coded_bands - 1) {
      int den = std::min(3, coded_bands - i);
      int curr_balance = balance / den;  // truncate toward zero, like libopus
      b = std::max(
          0, std::min(16383, std::min(remaining_bits + 1,
                                      pulses[i] + curr_balance)));
    } else {
      b = 0;
    }

    if ((M * kEBands[i] - N >= M * kEBands[start] || i == start + 1) &&
        (update_lowband || lowband_offset == 0))
      lowband_offset = i;
    if (i == start + 1)
      special_hybrid_folding(norm, norm2, start, M, dual_stereo);

    ctx.tf_change = tf_res[i];
    float* scratch = lowband_scratch;
    // i >= effective_ebands never happens for the 48k/960 mode (eff == nb)
    if (last) scratch = nullptr;

    int effective_lowband = -1;
    uint32_t x_cm, y_cm;
    if (lowband_offset != 0 &&
        (spread != SPREAD_AGGRESSIVE || B > 1 || ctx.tf_change < 0)) {
      effective_lowband =
          std::max(0, M * kEBands[lowband_offset] - norm_offset - N);
      int fold_start = lowband_offset;
      while (M * kEBands[--fold_start] > effective_lowband + norm_offset) {
      }
      int fold_end = lowband_offset - 1;
      while (++fold_end < i &&
             M * kEBands[fold_end] < effective_lowband + norm_offset + N) {
      }
      x_cm = y_cm = 0;
      int fold_i = fold_start;
      do {
        x_cm |= collapse_masks[fold_i * C + 0];
        y_cm |= collapse_masks[fold_i * C + C - 1];
      } while (++fold_i < fold_end);
    } else {
      x_cm = y_cm = (1u << B) - 1;
    }

    if (dual_stereo && i == intensity) {
      dual_stereo = 0;
      int upto = M * kEBands[i] - norm_offset;
      for (int j = 0; j < upto; j++) norm[j] = 0.5 * (norm[j] + norm2[j]);
    }
    if (dual_stereo) {
      x_cm = quant_band(&ctx, X, N, b / 2, B,
                        effective_lowband != -1 ? norm + effective_lowband
                                                : nullptr,
                        LM,
                        last ? nullptr : norm + M * kEBands[i] - norm_offset,
                        1.0, scratch, x_cm);
      y_cm = quant_band(&ctx, Y, N, b / 2, B,
                        effective_lowband != -1 ? norm2 + effective_lowband
                                                : nullptr,
                        LM,
                        last ? nullptr : norm2 + M * kEBands[i] - norm_offset,
                        1.0, scratch, y_cm);
    } else {
      if (Y) {
        x_cm = quant_band_stereo(
            &ctx, X, Y, N, b, B,
            effective_lowband != -1 ? norm + effective_lowband : nullptr, LM,
            last ? nullptr : norm + M * kEBands[i] - norm_offset, scratch,
            x_cm | y_cm);
      } else {
        x_cm = quant_band(
            &ctx, X, N, b, B,
            effective_lowband != -1 ? norm + effective_lowband : nullptr, LM,
            last ? nullptr : norm + M * kEBands[i] - norm_offset, 1.0, scratch,
            x_cm | y_cm);
      }
      y_cm = x_cm;
    }
    collapse_masks[i * C + 0] = (uint8_t)(x_cm & 0xFF);
    collapse_masks[i * C + C - 1] = (uint8_t)(y_cm & 0xFF);
    balance += pulses[i] + tell;
    update_lowband = b > (N << BITRES);
    ctx.avoid_split_noise = false;
  }
  return ctx.seed;
}

void anti_collapse(float* X_, const uint8_t* collapse_masks, int LM, int C,
                   int size, int start, int end, const double* logE,
                   const double* prev1logE, const double* prev2logE,
                   const int* pulses, uint32_t seed) {
  for (int i = start; i < end; i++) {
    int N0 = kEBands[i + 1] - kEBands[i];
    int depth = ((1 + pulses[i]) / N0) >> LM;
    double thresh = 0.5 * pow(2.0, -0.125 * depth);
    double sqrt_1 = 1.0 / sqrt((double)(N0 << LM));
    for (int c = 0; c < C; c++) {
      double prev1 = prev1logE[c * NB + i];
      double prev2 = prev2logE[c * NB + i];
      if (C == 1) {
        prev1 = std::max(prev1, prev1logE[NB + i]);
        prev2 = std::max(prev2, prev2logE[NB + i]);
      }
      double ediff = std::max(0.0, logE[c * NB + i] - std::min(prev1, prev2));
      double r = 2.0 * pow(2.0, -ediff);
      if (LM == 3) r *= 1.41421356;
      r = std::min(thresh, r) * sqrt_1;
      int base = c * size + (kEBands[i] << LM);
      bool renorm = false;
      for (int k = 0; k < (1 << LM); k++) {
        if (!(collapse_masks[i * C + c] & (1 << k))) {
          for (int j = 0; j < N0; j++) {
            seed = lcg_rand(seed);
            X_[base + (j << LM) + k] = (seed & 0x8000) ? r : -r;
          }
          renorm = true;
        }
      }
      if (renorm) renormalise_vector(X_ + base, N0 << LM, 1.0);
    }
  }
}

}  // namespace

// --------------------------------------------------------------- energy
namespace {

const double kPredCoef[4] = {29440 / 32768.0, 26112 / 32768.0,
                             21248 / 32768.0, 16384 / 32768.0};
const double kBetaCoef[4] = {30147 / 32768.0, 22282 / 32768.0,
                             12124 / 32768.0, 6554 / 32768.0};
const double kBetaIntra = 4915 / 32768.0;
const uint8_t kSmallEnergyICDF[3] = {2, 1, 0};

void unquant_coarse_energy(int start, int end, double* old_ebands, bool intra,
                           EcDec* dec, int C, int LM) {
  const uint8_t* prob_model = kEProbModel + (LM * 2 + (intra ? 1 : 0)) * 42;
  double prev[2] = {0.0, 0.0};
  double coef = intra ? 0.0 : kPredCoef[LM];
  double beta = intra ? kBetaIntra : kBetaCoef[LM];
  int budget = (int)dec->storage * 8;
  for (int i = start; i < end; i++) {
    for (int c = 0; c < C; c++) {
      int tell = ec_tell(dec);
      int qi;
      if (budget - tell >= 15) {
        int pi = 2 * std::min(i, 20);
        qi = ec_laplace_decode(dec, (uint32_t)prob_model[pi] << 7,
                               (int)prob_model[pi + 1] << 6);
      } else if (budget - tell >= 2) {
        qi = ec_dec_icdf(dec, kSmallEnergyICDF, 2);
        qi = (qi >> 1) ^ -(qi & 1);
      } else if (budget - tell >= 1) {
        qi = -ec_dec_bit_logp(dec, 1);
      } else {
        qi = -1;
      }
      double q = (double)qi;
      double old = std::max(old_ebands[c * NB + i], -9.0);
      old_ebands[c * NB + i] = coef * old + prev[c] + q;
      prev[c] = prev[c] + q - beta * q;
    }
  }
}

void unquant_fine_energy(int start, int end, double* old_ebands,
                         const int* fine_quant, EcDec* dec, int C) {
  for (int i = start; i < end; i++) {
    if (fine_quant[i] <= 0) continue;
    double scale = std::ldexp(1.0, -fine_quant[i]);
    for (int c = 0; c < C; c++) {
      uint32_t q2 = ec_dec_bits(dec, fine_quant[i]);
      old_ebands[c * NB + i] += ((double)q2 + 0.5) * scale - 0.5;
    }
  }
}

void unquant_energy_finalise(int start, int end, double* old_ebands,
                             const int* fine_quant, const int* fine_priority,
                             int bits_left, EcDec* dec, int C) {
  for (int prio = 0; prio < 2; prio++) {
    for (int i = start; i < end; i++) {
      if (bits_left < C) break;
      if (fine_quant[i] >= MAX_FINE_BITS || fine_priority[i] != prio) continue;
      double scale = std::ldexp(1.0, -(fine_quant[i] + 1));
      for (int c = 0; c < C; c++) {
        int q2 = (int)ec_dec_bits(dec, 1);
        old_ebands[c * NB + i] += (q2 - 0.5) * scale;
        bits_left--;
      }
    }
  }
}

// --------------------------------------------------------------- tf/caps
void tf_decode(int start, int end, bool is_transient, int* tf_res, int LM,
               EcDec* dec) {
  int budget = (int)dec->storage * 8;
  int tell = ec_tell(dec);
  int logp = is_transient ? 2 : 4;
  int tf_select_rsv = (LM > 0 && tell + logp + 1 <= budget) ? 1 : 0;
  budget -= tf_select_rsv;
  int tf_changed = 0, curr = 0;
  for (int i = start; i < end; i++) {
    if (tell + logp <= budget) {
      curr ^= ec_dec_bit_logp(dec, logp);
      tell = ec_tell(dec);
      tf_changed |= curr;
    }
    tf_res[i] = curr;
    logp = is_transient ? 4 : 5;
  }
  int tf_select = 0;
  int ti = is_transient ? 1 : 0;
  if (tf_select_rsv &&
      kTfSelect[LM * 8 + 4 * ti + 0 + tf_changed] !=
          kTfSelect[LM * 8 + 4 * ti + 2 + tf_changed])
    tf_select = ec_dec_bit_logp(dec, 1);
  for (int i = start; i < end; i++)
    tf_res[i] = kTfSelect[LM * 8 + 4 * ti + 2 * tf_select + tf_res[i]];
}

void init_caps(int* caps, int LM, int C) {
  for (int i = 0; i < NB; i++) {
    int N = (kEBands[i + 1] - kEBands[i]) << LM;
    caps[i] = ((int)kCacheCaps[NB * (2 * LM + C - 1) + i] + 64) * C * N >> 2;
  }
}

// --------------------------------------------------------------- decoder
constexpr int MAX_N = 960;  // 48k/960 mode, LM=3

struct CeltHost {
  uint32_t rng;
  int loss_count;
  double old_ebands[2 * NB];
  double old_log_e[2 * NB];
  double old_log_e2[2 * NB];
  double background_log_e[2 * NB];
  float norm_buf[2 * 8 * 100];      // 2 ch * M*eb[20]
  float scratch_buf[8 * 100];       // M*eb[21]
};

void celt_host_reset_impl(CeltHost* st) {
  st->rng = 0;
  st->loss_count = 0;
  for (int i = 0; i < 2 * NB; i++) {
    st->old_ebands[i] = 0.0;
    st->old_log_e[i] = -28.0;
    st->old_log_e2[i] = -28.0;
    st->background_log_e[i] = -28.0;
  }
}

// ------------------------------------------------------- plan-mode decode
// Symbol-only decode that records band-reconstruction plans (the packed
// tensor layout of mousiki_tpu/celt/plan_pack.py) instead of doing any
// float signal math. The device executor (ops/band_exec_jax.py) replays
// the plan; reference semantics per src/celt/bands.rs quant_all_bands and
// vq.rs alg_unquant. On capacity overflow the caller falls back to the
// direct decoder (direct=1 + x_direct).
namespace {

// tier capacities — runtime-profiled (celt_host_set_plan_profile):
// the full profile (224/48/16 slots, 4 fills) packs even 510 kbps stereo
// frames with no direct fallback; serving deployments shrink the slots to
// shrink the per-step H2D arena (overflowing streams fall back to the
// direct decoder, which stays correct). Defaults must match
// plan_pack.TIERS / FILL_SLOTS; the Python layout (host_native.py) reads
// the same profile when sizing the arenas.
constexpr int kTierN[3] = {16, 48, 176};
int kTierSlots[3] = {224, 48, 16};
int kFillSlots = 4;           // per-call fold/noise cap (device dense F axis)
int kFillPool = 21 * 2 * 4;   // per-stream fill Pool slots (wire planes)
constexpr int kPool0 = 1;  // reserved zero cell
constexpr int kLcgMax = 2048;
constexpr int kDupPool = 2;  // special-hybrid-folding copies (<= 2 slots)

uint32_t g_lcg_a[kLcgMax];
uint32_t g_lcg_c[kLcgMax];

void build_lcg_jump() {
  uint32_t a = 1, c = 0;
  for (int j = 0; j < kLcgMax; j++) {
    g_lcg_a[j] = a;
    g_lcg_c[j] = c;
    a = a * 1664525u;
    c = c * 1664525u + 1013904223u;
  }
}

inline uint32_t lcg_jump(uint32_t seed, int n) {
  return g_lcg_a[n] * seed + g_lcg_c[n];
}

// combo id — must match plan_pack.combos_for_m(M)
inline int combo_id(int b0, int tf, int M) {
  if (tf < -3 || tf > 3) return -1;
  if (b0 == 1) return tf == 0 ? 0 : (tf < 0 ? tf + 4 : tf + 3);
  if (b0 != M || M == 1) return -1;
  return 7 + (tf + 3);
}

// Per-stream views into the packed output arrays (already offset for s).
// Wire format v3: bit-packed flag planes, pooled sparse records, and ONE
// sequential 16-byte record per PVQ leaf (the v2 tier-SoA layout cost
// ~2 us/frame in scattered stores across 15 cache-distant planes; v3
// leaves land as a single contiguous write stream and the DEVICE does
// the tier scatter with a cumsum at unpack —
// ops/band_exec_jax.unpack_plan_arenas). Every value provably fits
// (n<=176, K<=255, B<=8, spread<=3, combo<=13, callid = band*2+slot
// <= 41, norm index <= 1600).
struct PlanOut {
  uint8_t* direct;
  uint32_t* pvq_rec;        // (R, 3) sequential leaf records, R = sum of
                            // tier slots. w0 = n | k<<8 | log2(b)<<16 |
                            // tier<<19 | dst<<21 (dst = X-plane offset of
                            // the leaf, < 2*frame <= 2048 — the device
                            // rebuilds the gather map from these with a
                            // difference-array cumsum; active == k>0 after
                            // the tier scatter); w1 = gain f32 bits;
                            // w2 = cwrs index. spread is frame-wide and
                            // rides the per-stream spread8 plane.
  uint16_t* pvq_cnt;        // (1,) number of records written
  uint8_t* call_flags;      // (21, 2): active | has_lb<<1 | lb_buf<<2 |
                            //          norm_write<<3 | norm_buf<<4
  uint8_t* call_combo;      // (21, 2): pre == post combo id
  int16_t* call_lb_src;
  int16_t* call_blend_upto;
  int16_t* dup_pool;        // (kDupPool, 4): [callid, dst, src, n] —
                            // window-local duplicate op emulating
                            // special_hybrid_folding (bands.rs); at most
                            // one band (start+1) x 2 slots per frame
  uint8_t* fill_cid;        // (kFillPool,): active | fold<<1 | callid<<2
  int16_t* fill_off;        // (kFillPool,)
  int16_t* fill_n;
  float* fill_gain;
  uint32_t* fill_seed;
  uint8_t* bm_flags;        // (21,): merge_active | merge_inv<<1 |
                            // theta2_active<<2 | cswap<<3 | t_inv<<4 |
                            // sign_neg<<5   (merge and theta2 exclusive)
  float* bm_mid;            // (21,): merge_mid or theta2_mid
  float* bm_side;           // (21,): theta2_side
  uint8_t* n1_as;           // (21, 2): active | neg<<1
  uint8_t* ac_on;
  uint8_t* ac_masks;        // (21, 2)
  float* ac_r;              // (2, 21)
  uint32_t* ac_seed;
  float* ble32;             // (2, 21) f32 copy of band_log_e
  float* pf32;              // scalar f32 copy of pf_gain
  uint8_t* spread8;         // frame-wide PVQ spread decision (one per
                            // stream; was duplicated in every leaf record)
};

struct PlanCtx {
  int i;
  int intensity;
  int spread;
  int tf_change;
  EcDec* ec;
  int remaining_bits;
  uint32_t seed;
  bool disable_inv;
  // plan state
  PlanOut* out;
  int tier_used[3];
  int rec_used;       // sequential leaf records written (pvq_rec)
  int band, slot;     // current top-level call location
  int call_base;      // absolute X-plane offset of the call's band vector
  int fill_used;      // fills recorded for the current call
  int fill_pool_used; // fills recorded for the whole frame (pool slots)
  int dup_used;       // dup_pool slots recorded
  bool failed;
  int frame;          // frame_size N (per channel plane)
  int dup_dst, dup_src, dup_n;  // pending special-hybrid-folding copy
                                // (norm coords; 0 n = none)
};

// index -> pulse vector (reference cwrs.rs cwrsi); same descent as
// decode_pulses but starting from a known index, no ryy.
void cwrs_iy(uint32_t idx, int* iy, int n, int k) {
  int j = 0;
  for (; j < n - 1; j++) {
    if (k == 0) break;
    int m = n - j;
#if defined(__AVX512F__)
    if (k <= 15) {
      // Same branch-free vector walk as decode_pulses: one aligned 64B
      // load of U(m, 0..15) + compare against idx + clz for the new k.
      const uint32_t* row = g_ut + (size_t)m * UT_STRIDE;
      uint32_t p = row[k + 1];
      uint32_t smask = (uint32_t) - (int)(idx >= p);
      idx -= p & smask;
      __m512i r = _mm512_load_si512((const void*)row);
      __mmask16 le =
          _mm512_cmple_epu32_mask(r, _mm512_set1_epi32((int)idx));
      uint32_t bits = (uint32_t)le & ((2u << k) - 1);
      int k_new = 31 - __builtin_clz(bits);
      idx -= row[k_new];
      uint32_t q = (uint32_t)(k - k_new);
      k = k_new;
      iy[j] = (int)((q ^ smask) - smask);
      continue;
    }
#endif
    uint32_t p = pvq_u_hot(m, k + 1);
    uint32_t smask = (uint32_t) - (int)(idx >= p);
    idx -= p & smask;
    int k0 = k;
    p = pvq_u_hot(m, k);
    while (p > idx) p = pvq_u(m, --k);
    idx -= p;
    uint32_t q = (uint32_t)(k0 - k);
    iy[j] = (int)((q ^ smask) - smask);
  }
  for (; j < n - 1; j++) iy[j] = 0;
  iy[n - 1] = idx ? -k : k;
}

uint32_t pq_alg_unquant(PlanCtx* ctx, int dst, int N, int K, int B,
                        double gain) {
  PROF_SCOPE_SUB(PULSES);
  uint32_t idx = ec_dec_uint(ctx->ec, pvq_v(N, K));
  uint32_t cm;
  if (B <= 1) {
    cm = 1;
  } else {
    int iy[208];
    cwrs_iy(idx, iy, N, K);
    cm = extract_collapse_mask(iy, N, B);
  }
  PlanOut* o = ctx->out;
  int t = N <= kTierN[0] ? 0 : (N <= kTierN[1] ? 1 : 2);
  while (t < 3 && ctx->tier_used[t] >= kTierSlots[t]) t++;
  if (t == 3) {
    ctx->failed = true;
    return cm;
  }
  if (dst >= 2048) {
    // dst occupies 11 bits of rec[0]; the supported 48k family keeps
    // dst < 2*960, but a larger custom frame wired through here would
    // silently wrap and corrupt the gather map — fall back to the
    // direct decoder instead.
    ctx->failed = true;
    return cm;
  }
  ctx->tier_used[t]++;
  uint32_t* rec = o->pvq_rec + 3 * (size_t)ctx->rec_used++;
  rec[0] = (uint32_t)N | ((uint32_t)K << 8) |
           ((uint32_t)__builtin_ctz(B) << 16) |
           ((uint32_t)t << 19) | ((uint32_t)dst << 21);
  float g = (float)gain;
  memcpy(&rec[1], &g, 4);
  rec[2] = idx;
  return cm;
}

uint32_t pq_partition(PlanCtx* ctx, int dst, int N, int b, int B,
                      bool has_lowband, int LM, double gain, uint32_t fill) {
  int i = ctx->i;
  EcDec* ec = ctx->ec;
  int B0 = B;
  uint32_t cm = 0;
  if (ctx->failed) return 0;

  int cache_index = kCacheIndex[(LM + 1) * NB + i];
  const uint8_t* cache = kCacheBits + (cache_index < 0 ? 0 : cache_index);
  bool can_split = cache_index >= 0 && LM != -1 &&
                   b > (int)cache[cache[0]] + 12 && N > 2;
  if (can_split) {
    N >>= 1;
    int dst_y = dst + N;
    LM -= 1;
    if (B == 1) fill = (fill & 1) | (fill << 1);
    B = (B + 1) >> 1;

    SplitCtx sctx;
    int b_box = b;
    uint32_t fill_box = fill;
    compute_theta_impl(ctx->ec, ctx->i, ctx->intensity, ctx->remaining_bits,
                       ctx->disable_inv, &sctx, N, &b_box, B, B0, LM, false,
                       &fill_box);
    b = b_box;
    fill = fill_box;
    int delta = sctx.delta, itheta = sctx.itheta, qalloc = sctx.qalloc;
    double mid = sctx.imid / 32768.0;
    double side = sctx.iside / 32768.0;

    if (B0 > 1 && (itheta & 0x3FFF)) {
      if (itheta > 8192)
        delta -= delta >> (4 - LM);
      else
        delta = std::min(0, delta + (N << BITRES >> (5 - LM)));
    }
    int bd = b - delta;
    int half = bd >= 0 ? bd / 2 : -((-bd + 1) / 2);
    int mbits = std::max(0, std::min(b, half));
    int sbits = b - mbits;
    ctx->remaining_bits -= qalloc;

    int rebalance = ctx->remaining_bits;
    if (mbits >= sbits) {
      cm = pq_partition(ctx, dst, N, mbits, B, has_lowband, LM, gain * mid,
                        fill);
      rebalance = mbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << BITRES && itheta != 0)
        sbits += rebalance - (3 << BITRES);
      cm |= pq_partition(ctx, dst_y, N, sbits, B, has_lowband, LM,
                         gain * side, fill >> B)
            << (B0 >> 1);
    } else {
      cm = pq_partition(ctx, dst_y, N, sbits, B, has_lowband, LM, gain * side,
                        fill >> B)
           << (B0 >> 1);
      rebalance = sbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << BITRES && itheta != 16384)
        mbits += rebalance - (3 << BITRES);
      cm |= pq_partition(ctx, dst, N, mbits, B, has_lowband, LM, gain * mid,
                         fill);
    }
  } else {
    int q = bits2pulses(i, LM, b);
    int curr_bits = pulses2bits(i, LM, q);
    ctx->remaining_bits -= curr_bits;
    while (ctx->remaining_bits < 0 && q > 0) {
      ctx->remaining_bits += curr_bits;
      q--;
      curr_bits = pulses2bits(i, LM, q);
      ctx->remaining_bits -= curr_bits;
    }
    if (q != 0) {
      int K = get_pulses(q);
      cm = pq_alg_unquant(ctx, dst, N, K, B, gain);
    } else {
      uint32_t cm_mask = (1u << B) - 1;
      fill &= cm_mask;
      if (fill) {
        // noise (no lowband) or fold leaf; the executor replays the LCG
        PlanOut* o = ctx->out;
        if (ctx->fill_used >= kFillSlots ||
            ctx->fill_pool_used >= kFillPool) {
          ctx->failed = true;
          return 0;
        }
        ctx->fill_used++;
        int fs = ctx->fill_pool_used++;
        int cid = ctx->band * 2 + ctx->slot;
        o->fill_cid[fs] =
            (uint8_t)(1 | (has_lowband ? 2 : 0) | (cid << 2));
        o->fill_off[fs] = dst - ctx->call_base;
        o->fill_n[fs] = N;
        o->fill_gain[fs] = (float)gain;
        o->fill_seed[fs] = ctx->seed;
        ctx->seed = lcg_jump(ctx->seed, N);
        cm = has_lowband ? fill : cm_mask;
      }
      // fill == 0: zero partition — map entries stay 0 (pool zero cell)
    }
  }
  return cm;
}

uint32_t pq_band_n1(PlanCtx* ctx, int dst, bool stereo, bool norm_write,
                    int norm_buf) {
  EcDec* ec = ctx->ec;
  PlanOut* o = ctx->out;
  int nch = stereo ? 2 : 1;
  for (int c = 0; c < nch; c++) {
    int sign = 0;
    if (ctx->remaining_bits >= 1 << BITRES) {
      sign = (int)ec_dec_bits(ec, 1);
      ctx->remaining_bits -= 1 << BITRES;
    }
    int ch = c == 0 ? ctx->slot : 1;  // X in the call's slot, Y in ch 1
    o->n1_as[ctx->band * 2 + ch] = (uint8_t)(1 | (sign ? 2 : 0));
  }
  int cs = ctx->band * 2 + ctx->slot;
  o->call_flags[cs] |= 1;  // active; combo stays 0 (identity)
  o->call_combo[cs] = 0;
  if (norm_write)
    o->call_flags[cs] |= (uint8_t)(8 | (norm_buf ? 16 : 0));
  (void)dst;
  return 1;
}

// One top-level quant_band call in plan mode. lb_buf/lb_src describe the
// lowband window symbolically (0 norm, 1 norm2; offset within that buffer).
uint32_t pq_band(PlanCtx* ctx, int dst, int N, int b, int B,
                 bool has_lowband, int lb_buf, int lb_src, int LM,
                 bool norm_write, int norm_buf, double gain, uint32_t fill,
                 int avg_upto, int M) {
  if (ctx->failed) return 0;
  if (N == 1) return pq_band_n1(ctx, dst, false, norm_write, norm_buf);

  int N_B = N / B;
  int B_entry = B;
  int tf_change = ctx->tf_change;
  int recombine = tf_change > 0 ? tf_change : 0;

  PlanOut* o = ctx->out;
  int cs = ctx->band * 2 + ctx->slot;
  uint8_t fl = 1;  // active
  ctx->call_base = dst;
  ctx->fill_used = 0;
  if (has_lowband) {
    fl |= (uint8_t)(2 | (lb_buf ? 4 : 0));
    o->call_lb_src[cs] = lb_src;
    o->call_blend_upto[cs] = lb_buf == 0 ? avg_upto : -1;
    if (ctx->dup_n > 0 && ctx->dup_used < kDupPool) {
      int16_t* dp = o->dup_pool + 4 * ctx->dup_used++;
      dp[0] = (int16_t)cs;
      dp[1] = (int16_t)(ctx->dup_dst - lb_src);
      dp[2] = (int16_t)(ctx->dup_src - lb_src);
      dp[3] = (int16_t)ctx->dup_n;
    }
  }
  int combo = combo_id(B_entry, tf_change, M);
  if (combo < 0) {
    ctx->failed = true;
    return 0;
  }
  o->call_combo[cs] = (uint8_t)combo;
  if (norm_write) fl |= (uint8_t)(8 | (norm_buf ? 16 : 0));
  o->call_flags[cs] |= fl;

  // fill bookkeeping mirrors quant_band's lowband transforms
  for (int k = 0; k < recombine; k++)
    fill = kBitInterleave[fill & 0xF] | kBitInterleave[(fill >> 4) & 0xF] << 2;
  B >>= recombine;
  N_B <<= recombine;
  int time_divide = 0;
  while ((N_B & 1) == 0 && tf_change < 0) {
    fill |= fill << B;
    B <<= 1;
    N_B >>= 1;
    time_divide++;
    tf_change++;
  }
  int B0 = B;

  uint32_t cm = pq_partition(ctx, dst, N, b, B, has_lowband, LM, gain, fill);

  // resynthesis cm bookkeeping (quant_band's post loops, sans signal math)
  B = B0;
  for (int k = 0; k < time_divide; k++) {
    B >>= 1;
    cm |= cm >> B;
  }
  for (int k = 0; k < recombine; k++) cm = kBitDeinterleave[cm & 0xF];
  B <<= recombine;
  cm &= (1u << B) - 1;
  (void)B_entry;
  return cm;
}

uint32_t pq_band_stereo(PlanCtx* ctx, int dst_x, int dst_y, int N, int b,
                        int B, bool has_lowband, int lb_src, int LM,
                        bool norm_write, uint32_t fill, int avg_upto, int M) {
  if (ctx->failed) return 0;
  if (N == 1) {
    ctx->slot = 0;
    return pq_band_n1(ctx, dst_x, true, norm_write, 0);
  }

  EcDec* ec = ctx->ec;
  PlanOut* o = ctx->out;
  uint32_t orig_fill = fill;
  SplitCtx sctx;
  int b_box = b;
  uint32_t fill_box = fill;
  compute_theta_impl(ctx->ec, ctx->i, ctx->intensity, ctx->remaining_bits,
                     ctx->disable_inv, &sctx, N, &b_box, B, B, LM, true,
                     &fill_box);
  b = b_box;
  fill = fill_box;
  int inv = sctx.inv, delta = sctx.delta, itheta = sctx.itheta,
      qalloc = sctx.qalloc;
  double mid = sctx.imid / 32768.0;
  double side = sctx.iside / 32768.0;
  uint32_t cm;

  if (N == 2) {
    int mbits = b;
    int sbits = 0;
    if (itheta != 0 && itheta != 16384) sbits = 1 << BITRES;
    mbits -= sbits;
    bool c = itheta > 8192;
    ctx->remaining_bits -= qalloc + sbits;
    int sign = 0;
    if (sbits) sign = (int)ec_dec_bits(ec, 1);
    sign = 1 - 2 * sign;
    ctx->slot = c ? 1 : 0;
    cm = pq_band(ctx, c ? dst_y : dst_x, N, mbits, B, has_lowband, 0, lb_src,
                 LM, norm_write, 0, 1.0, orig_fill, avg_upto, M);
    int bi = ctx->i;
    o->bm_flags[bi] = (uint8_t)(4 | (c ? 8 : 0) | (inv ? 16 : 0) |
                                (sign < 0 ? 32 : 0));
    o->bm_mid[bi] = (float)mid;
    o->bm_side[bi] = (float)side;
  } else {
    int bd = b - delta;
    int half = bd >= 0 ? bd / 2 : -((-bd + 1) / 2);
    int mbits = std::max(0, std::min(b, half));
    int sbits = b - mbits;
    ctx->remaining_bits -= qalloc;
    int rebalance = ctx->remaining_bits;
    if (mbits >= sbits) {
      ctx->slot = 0;
      cm = pq_band(ctx, dst_x, N, mbits, B, has_lowband, 0, lb_src, LM,
                   norm_write, 0, 1.0, fill, avg_upto, M);
      rebalance = mbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << BITRES && itheta != 0)
        sbits += rebalance - (3 << BITRES);
      ctx->slot = 1;
      cm |= pq_band(ctx, dst_y, N, sbits, B, false, 0, 0, LM, false, 0, side,
                    fill >> B, avg_upto, M);
    } else {
      ctx->slot = 1;
      cm = pq_band(ctx, dst_y, N, sbits, B, false, 0, 0, LM, false, 0, side,
                   fill >> B, avg_upto, M);
      rebalance = sbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << BITRES && itheta != 16384)
        mbits += rebalance - (3 << BITRES);
      ctx->slot = 0;
      cm |= pq_band(ctx, dst_x, N, mbits, B, has_lowband, 0, lb_src, LM,
                    norm_write, 0, 1.0, fill, avg_upto, M);
    }
    int bi = ctx->i;
    o->bm_flags[bi] = (uint8_t)(1 | (inv ? 2 : 0));
    o->bm_mid[bi] = (float)mid;
  }
  return cm;
}

// Plan-mode band loop; mirrors quant_all_bands_dec.
uint32_t pq_all_bands(int start, int end, uint8_t* collapse_masks,
                      const int* pulses, bool short_blocks, int spread,
                      int dual_stereo, int intensity, const int* tf_res,
                      int total_bits, int balance, EcDec* ec, int LM,
                      int coded_bands, uint32_t seed, bool disable_inv,
                      int C, int frame, PlanOut* out, bool* failed) {
  int M = 1 << LM;
  int B = short_blocks ? M : 1;
  int norm_offset = M * kEBands[start];

  PlanCtx ctx;
  ctx.intensity = intensity;
  ctx.spread = spread;
  out->spread8[0] = (uint8_t)spread;
  ctx.ec = ec;
  ctx.seed = seed;
  ctx.disable_inv = disable_inv;
  ctx.out = out;
  ctx.tier_used[0] = ctx.tier_used[1] = ctx.tier_used[2] = 0;
  ctx.rec_used = 0;
  ctx.fill_pool_used = 0;
  ctx.dup_used = 0;
  ctx.failed = false;
  ctx.frame = frame;
  int avg_upto = -1;

  int lowband_offset = 0;
  bool update_lowband = true;
  for (int i = start; i < end && !ctx.failed; i++) {
    ctx.i = i;
    ctx.band = i;
    bool last = i == end - 1;
    int dst_x = M * kEBands[i];
    int dst_y = frame + M * kEBands[i];
    int N = M * kEBands[i + 1] - M * kEBands[i];
    int tell = ec_tell_frac(ec);

    if (i != start) balance -= tell;
    int remaining_bits = total_bits - tell - 1;
    ctx.remaining_bits = remaining_bits;
    int b;
    if (i <= coded_bands - 1) {
      int den = std::min(3, coded_bands - i);
      int curr_balance = balance / den;
      b = std::max(
          0, std::min(16383, std::min(remaining_bits + 1,
                                      pulses[i] + curr_balance)));
    } else {
      b = 0;
    }

    if ((M * kEBands[i] - N >= M * kEBands[start] || i == start + 1) &&
        (update_lowband || lowband_offset == 0))
      lowband_offset = i;
    ctx.dup_n = 0;
    if (i == start + 1) {
      // special_hybrid_folding (bands.rs): duplicate the tail of the
      // first band's folding data so the (larger) second band can fold;
      // recorded as a window-local copy op on this band's call
      int n1f = M * (kEBands[start + 1] - kEBands[start]);
      int n2f = M * (kEBands[start + 2] - kEBands[start + 1]);
      if (n2f > n1f) {
        ctx.dup_dst = n1f;
        ctx.dup_src = 2 * n1f - n2f;
        ctx.dup_n = n2f - n1f;
      }
    }

    ctx.tf_change = tf_res[i];

    int effective_lowband = -1;
    uint32_t x_cm, y_cm;
    if (lowband_offset != 0 &&
        (spread != SPREAD_AGGRESSIVE || B > 1 || ctx.tf_change < 0)) {
      effective_lowband =
          std::max(0, M * kEBands[lowband_offset] - norm_offset - N);
      int fold_start = lowband_offset;
      while (M * kEBands[--fold_start] > effective_lowband + norm_offset) {
      }
      int fold_end = lowband_offset - 1;
      while (++fold_end < i &&
             M * kEBands[fold_end] < effective_lowband + norm_offset + N) {
      }
      x_cm = y_cm = 0;
      int fold_i = fold_start;
      do {
        x_cm |= collapse_masks[fold_i * C + 0];
        y_cm |= collapse_masks[fold_i * C + C - 1];
      } while (++fold_i < fold_end);
    } else {
      x_cm = y_cm = (1u << B) - 1;
    }

    if (dual_stereo && i == intensity) {
      dual_stereo = 0;
      avg_upto = M * kEBands[i] - norm_offset;
    }
    bool has_lb = effective_lowband != -1;
    bool norm_write = !last;
    if (dual_stereo) {
      ctx.slot = 0;
      x_cm = pq_band(&ctx, dst_x, N, b / 2, B, has_lb, 0, effective_lowband,
                     LM, norm_write, 0, 1.0, x_cm, avg_upto, M);
      ctx.slot = 1;
      y_cm = pq_band(&ctx, dst_y, N, b / 2, B, has_lb, 1, effective_lowband,
                     LM, norm_write, 1, 1.0, y_cm, avg_upto, M);
    } else {
      if (C == 2) {
        x_cm = pq_band_stereo(&ctx, dst_x, dst_y, N, b, B, has_lb,
                              effective_lowband, LM, norm_write,
                              x_cm | y_cm, avg_upto, M);
      } else {
        ctx.slot = 0;
        x_cm = pq_band(&ctx, dst_x, N, b, B, has_lb, 0, effective_lowband,
                       LM, norm_write, 0, 1.0, x_cm | y_cm, avg_upto, M);
      }
      y_cm = x_cm;
    }
    collapse_masks[i * C + 0] = (uint8_t)(x_cm & 0xFF);
    collapse_masks[i * C + C - 1] = (uint8_t)(y_cm & 0xFF);
    balance += pulses[i] + tell;
    update_lowband = b > (N << BITRES);
  }
  out->pvq_cnt[0] = (uint16_t)ctx.rec_used;
  *failed = ctx.failed;
  return ctx.seed;
}

}  // namespace

}  // namespace

// ------------------------------------------------------------------ C API
extern "C" {

#ifdef EC_RECORD
// Harness API (bench_plan.cpp -DEC_RECORD): route ops into `log`, then
// replay n_ops recorded primitives on a fresh decoder over `data`.
void celt_host_ec_record_begin(void* vec) {
  ecrec::log_ = (std::vector<ecrec::Op>*)vec;
}
void celt_host_ec_record_end() { ecrec::log_ = nullptr; }
uint32_t celt_host_ec_replay(const uint8_t* data, int len, const void* ops_v,
                             int n_ops) {
  const ecrec::Op* ops = (const ecrec::Op*)ops_v;
  EcDec dec;
  ec_dec_init(&dec, data, (uint32_t)len);
  uint32_t acc = 0;
  for (int i = 0; i < n_ops; i++) {
    const ecrec::Op& o = ops[i];
    switch (o.kind) {
      case 0: acc += ec_decode(&dec, o.a); break;
      case 1: acc += ec_decode_bin(&dec, (int)o.a); break;
      case 2: ec_dec_update(&dec, o.a, o.b, o.c); break;
      case 3: acc += (uint32_t)ec_dec_bit_logp(&dec, (int)o.a); break;
      case 4: acc += (uint32_t)ec_dec_icdf(&dec, o.icdf, (int)o.a); break;
      case 5: acc += ec_dec_bits(&dec, (int)o.a); break;
    }
  }
  return acc ^ dec.rng;
}
#endif

void* celt_host_create() {
  build_u_table();
  build_lcg_jump();
  build_b2p_table();
  build_recip_table();
  build_ftdiv_table();
  build_tellfrac_table();
  CeltHost* st = new CeltHost();
  celt_host_reset_impl(st);
  return st;
}

void celt_host_destroy(void* p) { delete (CeltHost*)p; }
void celt_host_reset(void* p) { celt_host_reset_impl((CeltHost*)p); }

// Mark one lost frame for this stream (batched PLC runs on device; the
// host only tracks loss_count for the background-energy bookkeeping of
// the next real frame — python decoder parity: _decode_lost).
void celt_host_note_loss(void* p) { ((CeltHost*)p)->loss_count++; }

// Import energy state (e.g. to sync with a Python-side decoder).
void celt_host_set_state(void* p, const double* old_ebands,
                         const double* old_log_e, const double* old_log_e2,
                         uint32_t rng) {
  CeltHost* st = (CeltHost*)p;
  memcpy(st->old_ebands, old_ebands, sizeof(st->old_ebands));
  memcpy(st->old_log_e, old_log_e, sizeof(st->old_log_e));
  memcpy(st->old_log_e2, old_log_e2, sizeof(st->old_log_e2));
  st->rng = rng;
}

void celt_host_get_state(void* p, double* old_ebands, double* old_log_e,
                         double* old_log_e2, uint32_t* rng) {
  CeltHost* st = (CeltHost*)p;
  memcpy(old_ebands, st->old_ebands, sizeof(st->old_ebands));
  memcpy(old_log_e, st->old_log_e, sizeof(st->old_log_e));
  memcpy(old_log_e2, st->old_log_e2, sizeof(st->old_log_e2));
  *rng = st->rng;
}

// Decode one CELT frame's symbols into a frame descriptor.
//   data/len      packet payload (the CELT part)
//   frame_size    output samples at 48 kHz (120 << LM)
//   C             coded (stream) channels, 1 or 2
//   start,end     band range (0..21 full band; hybrid uses start=17)
//   disable_inv   disable stereo phase inversion
//   x_out         C * frame_size floats: unit-norm spectrum (f32 — the
//                 device synthesis stage consumes f32 anyway)
//   band_log_e    2 * 21 doubles: post-frame band log-energies
//   iflags        int32[4]: transient, silence, pf_pitch, pf_tapset
//   pf_gain       postfilter gain for this frame
// Returns 0 on success, <0 on error.
int celt_host_decode_resume(void* p, const uint8_t* data, int len,
                            int frame_size, int C, int start, int end,
                            int disable_inv, float* x_out,
                            double* band_log_e, int32_t* iflags,
                            double* pf_gain, const uint32_t* ec_in);

int celt_host_decode(void* p, const uint8_t* data, int len, int frame_size,
                     int C, int start, int end, int disable_inv, float* x_out,
                     double* band_log_e, int32_t* iflags, double* pf_gain) {
  return celt_host_decode_resume(p, data, len, frame_size, C, start, end,
                                 disable_inv, x_out, band_log_e, iflags,
                                 pf_gain, nullptr);
}

// As celt_host_decode, but ec_in (when non-null) resumes a range decoder
// exported by silk_host_decode_ec / _stereo over the same buffer — the
// hybrid handoff for the EXACT direct decoder (the plan twin is
// celt_host_decode_plan_resume).
int celt_host_decode_resume(void* p, const uint8_t* data, int len,
                            int frame_size, int C, int start, int end,
                            int disable_inv, float* x_out,
                            double* band_log_e, int32_t* iflags,
                            double* pf_gain, const uint32_t* ec_in) {
  CeltHost* st = (CeltHost*)p;
  int LM = -1;
  for (int lm = 0; lm <= kMaxLM; lm++)
    if (kShortMdctSize << lm == frame_size) LM = lm;
  if (LM < 0 || C < 1 || C > 2 || len < 2 || !data) return -1;
  int M = 1 << LM;
  int N = M * kShortMdctSize;

  EcDec dec_s;
  EcDec* dec = &dec_s;
  if (ec_in) {
    dec->buf = data;
    dec->storage = (uint32_t)len;
    dec->offs = ec_in[0];
    dec->rng = ec_in[1];
    dec->val = ec_in[2];
    dec->nbits_total = (int)ec_in[3];
    dec->end_offs = ec_in[4];
    dec->end_window = ec_in[5];
    dec->nend_bits = (int)ec_in[6];
    dec->error = (int)ec_in[7];
    dec->rem = (int)ec_in[8];
    dec->ext = 0;
  } else {
    ec_dec_init(dec, data, (uint32_t)len);
  }
  int length = len;

  double* old_band_e = st->old_ebands;
  if (C == 1)
    for (int i = 0; i < NB; i++)
      old_band_e[i] = std::max(old_band_e[i], old_band_e[NB + i]);

  int total_bits = length * 8;
  int tell = ec_tell(dec);

  int silence;
  if (tell >= total_bits)
    silence = 1;
  else if (tell == 1)
    silence = ec_dec_bit_logp(dec, 15);
  else
    silence = 0;
  if (silence) {
    tell = length * 8;
    dec->nbits_total += tell - ec_tell(dec);
  }

  double postfilter_gain = 0.0;
  int postfilter_pitch = 0;
  int postfilter_tapset = 0;
  if (start == 0 && tell + 16 <= total_bits) {
    if (ec_dec_bit_logp(dec, 1)) {
      int octave = (int)ec_dec_uint(dec, 6);
      postfilter_pitch = (16 << octave) + (int)ec_dec_bits(dec, 4 + octave) - 1;
      int qg = (int)ec_dec_bits(dec, 3);
      if (ec_tell(dec) + 2 <= total_bits)
        postfilter_tapset = ec_dec_icdf(dec, kTapsetICDF, 2);
      postfilter_gain = 0.09375 * (qg + 1);
    }
    tell = ec_tell(dec);
  }

  int is_transient = 0;
  if (LM > 0 && tell + 3 <= total_bits) {
    is_transient = ec_dec_bit_logp(dec, 3);
    tell = ec_tell(dec);
  }
  bool short_blocks = is_transient != 0;

  int intra_ener = (tell + 3 <= total_bits) ? ec_dec_bit_logp(dec, 3) : 0;
  unquant_coarse_energy(start, end, old_band_e, intra_ener != 0, dec, C, LM);

  int tf_res[NB] = {0};
  tf_decode(start, end, is_transient != 0, tf_res, LM, dec);

  tell = ec_tell(dec);
  int spread_decision = 2;  // SPREAD_NORMAL
  if (tell + 4 <= total_bits) spread_decision = ec_dec_icdf(dec, kSpreadICDF, 5);

  int cap[NB];
  init_caps(cap, LM, C);
  int offsets[NB] = {0};
  int dynalloc_logp = 6;
  total_bits <<= BITRES;
  tell = ec_tell_frac(dec);
  for (int i = start; i < end; i++) {
    int width = C * (kEBands[i + 1] - kEBands[i]) << LM;
    int quanta = std::min(width << BITRES, std::max(6 << BITRES, width));
    int dynalloc_loop_logp = dynalloc_logp;
    int boost = 0;
    while (tell + (dynalloc_loop_logp << BITRES) < total_bits &&
           boost < cap[i]) {
      int flag = ec_dec_bit_logp(dec, dynalloc_loop_logp);
      tell = ec_tell_frac(dec);
      if (!flag) break;
      boost += quanta;
      total_bits -= quanta;
      dynalloc_loop_logp = 1;
    }
    offsets[i] = boost;
    if (boost > 0) dynalloc_logp = std::max(2, dynalloc_logp - 1);
  }

  int alloc_trim = (tell + (6 << BITRES) <= total_bits)
                       ? ec_dec_icdf(dec, kTrimICDF, 7)
                       : 5;

  int bits = ((length * 8) << BITRES) - ec_tell_frac(dec) - 1;
  int anti_collapse_rsv =
      (is_transient && LM >= 2 && bits >= (LM + 2) << BITRES) ? (1 << BITRES)
                                                              : 0;
  bits -= anti_collapse_rsv;

  Alloc alloc;
  memset(&alloc, 0, sizeof(alloc));
  clt_compute_allocation(start, end, offsets, cap, alloc_trim, bits, C, LM,
                         dec, &alloc);

  unquant_fine_energy(start, end, old_band_e, alloc.ebits, dec, C);

  uint8_t collapse_masks[2 * NB] = {0};
  memset(x_out, 0, (size_t)C * N * sizeof(float));
  st->rng = quant_all_bands_dec(
      start, end, x_out, C == 2 ? x_out + N : nullptr, collapse_masks,
      alloc.pulses, short_blocks, spread_decision, alloc.dual_stereo,
      alloc.intensity, tf_res, length * (8 << BITRES) - anti_collapse_rsv,
      alloc.balance, dec, LM, alloc.coded_bands, st->rng, disable_inv != 0,
      st->norm_buf, st->scratch_buf);

  int anti_collapse_on = 0;
  if (anti_collapse_rsv > 0) anti_collapse_on = (int)ec_dec_bits(dec, 1);

  unquant_energy_finalise(start, end, old_band_e, alloc.ebits,
                          alloc.fine_priority, length * 8 - ec_tell(dec), dec,
                          C);

  if (anti_collapse_on)
    anti_collapse(x_out, collapse_masks, LM, C, N, start, end, old_band_e,
                  st->old_log_e, st->old_log_e2, alloc.pulses, st->rng);

  if (silence)
    for (int i = 0; i < 2 * NB; i++) old_band_e[i] = -28.0;

  if (C == 1)
    for (int i = 0; i < NB; i++) old_band_e[NB + i] = old_band_e[i];

  // export the frame descriptor energies before the log-e bookkeeping
  memcpy(band_log_e, old_band_e, 2 * NB * sizeof(double));

  if (!is_transient) {
    memcpy(st->old_log_e2, st->old_log_e, sizeof(st->old_log_e));
    memcpy(st->old_log_e, old_band_e, sizeof(st->old_log_e));
    double max_bg = st->loss_count < 10 ? M * 0.001 : 1.0;
    for (int i = 0; i < 2 * NB; i++)
      st->background_log_e[i] =
          std::min(st->background_log_e[i] + max_bg, st->old_log_e[i]);
  } else {
    for (int i = 0; i < 2 * NB; i++)
      st->old_log_e[i] = std::min(st->old_log_e[i], old_band_e[i]);
  }
  for (int c = 0; c < 2; c++) {
    for (int i = 0; i < start; i++) {
      old_band_e[c * NB + i] = 0.0;
      st->old_log_e[c * NB + i] = -28.0;
      st->old_log_e2[c * NB + i] = -28.0;
    }
    for (int i = end; i < NB; i++) {
      old_band_e[c * NB + i] = 0.0;
      st->old_log_e[c * NB + i] = -28.0;
      st->old_log_e2[c * NB + i] = -28.0;
    }
  }
  st->rng = dec->rng;
  st->loss_count = 0;

  iflags[0] = is_transient;
  iflags[1] = silence;
  iflags[2] = postfilter_pitch;
  iflags[3] = postfilter_tapset;
  *pf_gain = postfilter_gain;

  if (ec_tell(dec) > 8 * length) return -2;
  return dec->error ? -3 : 0;
}

uint32_t celt_host_rng(void* p) { return ((CeltHost*)p)->rng; }

// Set the plan tier/fill slot capacities (process-wide). Must be called
// before any plan decode, with the Python-side layout sized to match
// (host_native.set_plan_profile does both). Values are clamped to the
// full-profile maxima the writer was validated against.
void celt_host_set_plan_profile(int t0, int t1, int t2, int fills) {
  const int mx[3] = {224, 48, 16};
  int v[3] = {t0, t1, t2};
  for (int t = 0; t < 3; t++)
    kTierSlots[t] = v[t] < 1 ? 1 : (v[t] > mx[t] ? mx[t] : v[t]);
  kFillSlots = fills < 1 ? 1 : (fills > 4 ? 4 : fills);
  kFillPool = 21 * 2 * kFillSlots;
}

// Cap the per-stream fill POOL below the dense 21*2*fills bound (serving
// profiles: typical 20 ms frames use <= 2 fills total; overflow falls back
// to the direct decoder like a tier overflow). Call AFTER set_plan_profile.
void celt_host_set_fill_pool(int pool) {
  int mx = 21 * 2 * kFillSlots;
  kFillPool = pool < 1 ? 1 : (pool > mx ? mx : pool);
}

// Plan-mode decode: symbols only; band signal math is recorded as a packed
// plan for the device executor (mousiki_tpu/ops/band_exec_jax.py). `arrs`
// is the packed-array pointer table for ALL S streams — wire format v4
// (12-byte PVQ leaf records), 29 entries, in this fixed order with these dtypes (must match the
// PlanOut views below and mousiki_tpu/celt/host_native.py
// _PTR_ORDER/_PLANE_DTYPES). R = sum of the three tier slot capacities.
//   0 direct u8(S)  1 pvq_rec u32(S,R,3)  2 pvq_cnt u16(S)
//   3 call_flags u8(S,21,2)  4 call_combo u8  5 call_lb_src i16
//   6 call_blend_upto i16  7 dup_pool i16(S,2,4)
//   8 fill_cid u8(S,P)  9 fill_off i16  10 fill_n i16  11 fill_gain f32
//   12 fill_seed u32  13 bm_flags u8(S,21)  14 bm_mid f32  15 bm_side f32
//   16 n1_as u8(S,21,2)
//   17 ac_on u8(S)  18 ac_masks u8(S,21,2)  19 ac_r f32(S,2,21)
//   20 ac_seed u32(S)  21 x_direct f32(S,C,frame)  22 band_log_e f64(S,2,21)
//   23 iflags i32(S,4)  24 pf_gain f64(S)  25 rcs i32(S)
//   26 ble32 f32(S,2,21)  27 pf32 f32(S)  28 spread8 u8(S)
int celt_host_decode_plan_resume(void* p, const uint8_t* data, int len,
                                 int frame_size, int C, int start, int end,
                                 int disable_inv, void** arrs, int S, int s,
                                 const uint32_t* ec_in);

// Consume the hybrid-mode redundancy signaling between the SILK and CELT
// halves of a shared-stream packet (reference opus_decoder.rs decode_frame:
// 1 bit logp-12 redundancy flag, then celt_to_silk bit + byte count).
// ec[10] is the exported range-decoder state (silk_host.cpp layout),
// updated in place. out[0]=redundancy, out[1]=celt_to_silk,
// out[2]=redundancy_bytes. Returns the effective payload length for the
// CELT decode (len minus any redundancy bytes).
int celt_host_hybrid_redundancy(uint32_t* ec, const uint8_t* data, int len,
                                int32_t* out) {
  EcDec d;
  d.buf = data;
  d.storage = (uint32_t)len;
  d.offs = ec[0];
  d.rng = ec[1];
  d.val = ec[2];
  d.nbits_total = (int)ec[3];
  d.end_offs = ec[4];
  d.end_window = ec[5];
  d.nend_bits = (int)ec[6];
  d.error = (int)ec[7];
  d.rem = (int)ec[8];
  d.ext = 0;
  int length = len;
  out[0] = out[1] = out[2] = 0;
  if (ec_tell(&d) + 17 + 20 <= 8 * length) {
    out[0] = ec_dec_bit_logp(&d, 12);
    if (out[0]) {
      out[1] = ec_dec_bit_logp(&d, 1);
      int rbytes = (int)ec_dec_uint(&d, 256) + 2;
      length -= rbytes;
      if (8 * length < ec_tell(&d)) {
        length = 0;
        rbytes = 0;
        out[0] = 0;
      }
      d.storage -= (uint32_t)rbytes;
      out[2] = rbytes;
    }
  }
  ec[0] = d.offs;
  ec[1] = d.rng;
  ec[2] = d.val;
  ec[3] = (uint32_t)d.nbits_total;
  ec[4] = d.end_offs;
  ec[5] = d.end_window;
  ec[6] = (uint32_t)d.nend_bits;
  ec[7] = (uint32_t)d.error;
  ec[8] = (uint32_t)d.rem;
  return length;
}

int celt_host_decode_plan(void* p, const uint8_t* data, int len,
                          int frame_size, int C, int start, int end,
                          int disable_inv, void** arrs, int S, int s) {
  return celt_host_decode_plan_resume(p, data, len, frame_size, C, start,
                                      end, disable_inv, arrs, S, s, nullptr);
}

// As celt_host_decode_plan, but ec_in (when non-null) resumes a range
// decoder exported by silk_host_decode_ec over the same buffer — the
// hybrid-mode shared-stream handoff (layout: see silk_host.cpp).
int celt_host_decode_plan_resume(void* p, const uint8_t* data, int len,
                                 int frame_size, int C, int start, int end,
                                 int disable_inv, void** arrs, int S, int s,
                                 const uint32_t* ec_in) {
  CeltHost* st = (CeltHost*)p;
  int LM = -1;
  for (int lm = 0; lm <= kMaxLM; lm++)
    if (kShortMdctSize << lm == frame_size) LM = lm;
  if (LM < 0 || C < 1 || C > 2 || len < 2 || !data) return -1;
  int M = 1 << LM;
  int N = M * kShortMdctSize;
  (void)S;

  // per-stream views
  PlanOut o;
  {
    size_t cs = (size_t)s;
    o.direct = (uint8_t*)arrs[0] + cs;
    size_t R = (size_t)(kTierSlots[0] + kTierSlots[1] + kTierSlots[2]);
    o.pvq_rec = (uint32_t*)arrs[1] + cs * R * 3;
    o.pvq_cnt = (uint16_t*)arrs[2] + cs;
    size_t c2 = cs * NB * 2;
    o.call_flags = (uint8_t*)arrs[3] + c2;
    o.call_combo = (uint8_t*)arrs[4] + c2;
    o.call_lb_src = (int16_t*)arrs[5] + c2;
    o.call_blend_upto = (int16_t*)arrs[6] + c2;
    o.dup_pool = (int16_t*)arrs[7] + cs * kDupPool * 4;
    size_t fp = cs * kFillPool;
    o.fill_cid = (uint8_t*)arrs[8] + fp;
    o.fill_off = (int16_t*)arrs[9] + fp;
    o.fill_n = (int16_t*)arrs[10] + fp;
    o.fill_gain = (float*)arrs[11] + fp;
    o.fill_seed = (uint32_t*)arrs[12] + fp;
    size_t b1 = cs * NB;
    o.bm_flags = (uint8_t*)arrs[13] + b1;
    o.bm_mid = (float*)arrs[14] + b1;
    o.bm_side = (float*)arrs[15] + b1;
    o.n1_as = (uint8_t*)arrs[16] + c2;
    o.ac_on = (uint8_t*)arrs[17] + cs;
    o.ac_masks = (uint8_t*)arrs[18] + c2;
    o.ac_r = (float*)arrs[19] + cs * 2 * NB;
    o.ac_seed = (uint32_t*)arrs[20] + cs;
    o.ble32 = (float*)arrs[26] + cs * 2 * NB;
    o.pf32 = (float*)arrs[27] + cs;
    o.spread8 = (uint8_t*)arrs[28] + cs;
  }
  float* x_direct = (float*)arrs[21] + (size_t)s * C * frame_size;
  double* band_log_e = (double*)arrs[22] + (size_t)s * 2 * NB;
  int32_t* iflags = (int32_t*)arrs[23] + (size_t)s * 4;
  double* pf_gain = (double*)arrs[24] + s;

  // zero the active flags (other fields are written when flagged; PVQ
  // leaf records need no zeroing — the device masks by pvq_cnt)
  {
    PROF_SCOPE(MEMSET);
    memset(o.direct, 0, 1);
    o.pvq_cnt[0] = 0;
    memset(o.call_flags, 0, NB * 2);
    memset(o.fill_cid, 0, kFillPool);
    memset(o.bm_flags, 0, NB);
    memset(o.n1_as, 0, NB * 2);
    memset(o.ac_on, 0, 1);
    memset(o.dup_pool, 0, kDupPool * 4 * sizeof(int16_t));
    o.spread8[0] = 0;
  }
  PROF_FRAME();

  // Work on a stack-local energy copy and commit on success: the only
  // pre-failure-point mutations are the coarse/fine energy decode (into
  // eb_loc) and the walk's rng (kept in new_rng), so the direct-decode
  // fallback needs no snapshot/restore of the persistent state.
  double eb_loc[2 * NB];
  memcpy(eb_loc, st->old_ebands, sizeof(eb_loc));

  EcDec dec_s;
  EcDec* dec = &dec_s;
  if (ec_in) {
    dec->buf = data;
    dec->storage = (uint32_t)len;
    dec->offs = ec_in[0];
    dec->rng = ec_in[1];
    dec->val = ec_in[2];
    dec->nbits_total = (int)ec_in[3];
    dec->end_offs = ec_in[4];
    dec->end_window = ec_in[5];
    dec->nend_bits = (int)ec_in[6];
    dec->error = (int)ec_in[7];
    dec->rem = (int)ec_in[8];
    dec->ext = 0;
  } else {
    ec_dec_init(dec, data, (uint32_t)len);
  }
  int length = len;

  double* old_band_e = eb_loc;
  if (C == 1)
    for (int i = 0; i < NB; i++)
      old_band_e[i] = std::max(old_band_e[i], old_band_e[NB + i]);

  int total_bits = length * 8;
  int tell = ec_tell(dec);

  int silence;
  if (tell >= total_bits)
    silence = 1;
  else if (tell == 1)
    silence = ec_dec_bit_logp(dec, 15);
  else
    silence = 0;
  if (silence) {
    tell = length * 8;
    dec->nbits_total += tell - ec_tell(dec);
  }

  double postfilter_gain = 0.0;
  int postfilter_pitch = 0;
  int postfilter_tapset = 0;
  if (start == 0 && tell + 16 <= total_bits) {
    if (ec_dec_bit_logp(dec, 1)) {
      int octave = (int)ec_dec_uint(dec, 6);
      postfilter_pitch = (16 << octave) + (int)ec_dec_bits(dec, 4 + octave) - 1;
      int qg = (int)ec_dec_bits(dec, 3);
      if (ec_tell(dec) + 2 <= total_bits)
        postfilter_tapset = ec_dec_icdf(dec, kTapsetICDF, 2);
      postfilter_gain = 0.09375 * (qg + 1);
    }
    tell = ec_tell(dec);
  }

  int is_transient = 0;
  if (LM > 0 && tell + 3 <= total_bits) {
    is_transient = ec_dec_bit_logp(dec, 3);
    tell = ec_tell(dec);
  }
  bool short_blocks = is_transient != 0;

  int intra_ener = (tell + 3 <= total_bits) ? ec_dec_bit_logp(dec, 3) : 0;
  {
    PROF_SCOPE(COARSE);
    unquant_coarse_energy(start, end, old_band_e, intra_ener != 0, dec, C, LM);
  }

  int tf_res[NB] = {0};
  tf_decode(start, end, is_transient != 0, tf_res, LM, dec);

  tell = ec_tell(dec);
  int spread_decision = 2;
  if (tell + 4 <= total_bits) spread_decision = ec_dec_icdf(dec, kSpreadICDF, 5);

  int cap[NB];
  init_caps(cap, LM, C);
  int offsets[NB] = {0};
  int dynalloc_logp = 6;
  total_bits <<= BITRES;
  tell = ec_tell_frac(dec);
  { PROF_SCOPE(DYNALLOC);
  for (int i = start; i < end; i++) {
    int width = C * (kEBands[i + 1] - kEBands[i]) << LM;
    int quanta = std::min(width << BITRES, std::max(6 << BITRES, width));
    int dynalloc_loop_logp = dynalloc_logp;
    int boost = 0;
    while (tell + (dynalloc_loop_logp << BITRES) < total_bits &&
           boost < cap[i]) {
      int flag = ec_dec_bit_logp(dec, dynalloc_loop_logp);
      tell = ec_tell_frac(dec);
      if (!flag) break;
      boost += quanta;
      total_bits -= quanta;
      dynalloc_loop_logp = 1;
    }
    offsets[i] = boost;
    if (boost > 0) dynalloc_logp = std::max(2, dynalloc_logp - 1);
  } }

  int alloc_trim = (tell + (6 << BITRES) <= total_bits)
                       ? ec_dec_icdf(dec, kTrimICDF, 7)
                       : 5;

  int bits = ((length * 8) << BITRES) - ec_tell_frac(dec) - 1;
  int anti_collapse_rsv =
      (is_transient && LM >= 2 && bits >= (LM + 2) << BITRES) ? (1 << BITRES)
                                                              : 0;
  bits -= anti_collapse_rsv;

  Alloc alloc;
  memset(&alloc, 0, sizeof(alloc));
  {
    PROF_SCOPE(ALLOC);
    clt_compute_allocation(start, end, offsets, cap, alloc_trim, bits, C, LM,
                           dec, &alloc);
  }

  {
    PROF_SCOPE(FINE);
    unquant_fine_energy(start, end, old_band_e, alloc.ebits, dec, C);
  }

  uint8_t collapse_masks[2 * NB] = {0};
  bool failed = false;
  uint32_t new_rng;
  { PROF_SCOPE(BANDS);
  new_rng = pq_all_bands(
      start, end, collapse_masks, alloc.pulses, short_blocks, spread_decision,
      alloc.dual_stereo, alloc.intensity, tf_res,
      length * (8 << BITRES) - anti_collapse_rsv, alloc.balance, dec, LM,
      alloc.coded_bands, st->rng, disable_inv != 0, C, frame_size, &o,
      &failed);
  }

  if (failed) {
    // persistent state untouched (energies decoded into eb_loc, rng in
    // new_rng): run the direct decoder for this stream from entry state
    if (ec_in) return -4;  // resumed (hybrid) streams cannot re-init the ec
    o.direct[0] = 1;
    int rc = celt_host_decode(p, data, len, frame_size, C, start, end,
                              disable_inv, x_direct, band_log_e, iflags,
                              pf_gain);
    for (int i = 0; i < 2 * NB; i++) o.ble32[i] = (float)band_log_e[i];
    o.pf32[0] = (float)pf_gain[0];
    return rc;
  }

  st->rng = new_rng;
  int anti_collapse_on = 0;
  if (anti_collapse_rsv > 0) anti_collapse_on = (int)ec_dec_bits(dec, 1);

  {
    PROF_SCOPE(FINALISE);
    unquant_energy_finalise(start, end, old_band_e, alloc.ebits,
                            alloc.fine_priority, length * 8 - ec_tell(dec),
                            dec, C);
  }

  if (anti_collapse_on) {
    o.ac_on[0] = 1;
    o.ac_seed[0] = st->rng;
    for (int i = 0; i < NB; i++) {
      o.ac_masks[i * 2 + 0] = collapse_masks[i * C + 0];
      o.ac_masks[i * 2 + 1] = collapse_masks[i * C + C - 1];
    }
    for (int i = start; i < end; i++) {
      int N0 = kEBands[i + 1] - kEBands[i];
      int depth = ((1 + alloc.pulses[i]) / N0) >> LM;
      double thresh = 0.5 * pow(2.0, -0.125 * depth);
      double sqrt_1 = 1.0 / sqrt((double)(N0 << LM));
      for (int ci = 0; ci < C; ci++) {
        double p1 = st->old_log_e[ci * NB + i];
        double p2 = st->old_log_e2[ci * NB + i];
        if (C == 1) {
          p1 = std::max(p1, st->old_log_e[NB + i]);
          p2 = std::max(p2, st->old_log_e2[NB + i]);
        }
        double ediff =
            std::max(0.0, old_band_e[ci * NB + i] - std::min(p1, p2));
        double r = 2.0 * pow(2.0, -ediff);
        if (LM == 3) r *= 1.41421356;
        o.ac_r[ci * NB + i] = (float)(std::min(thresh, r) * sqrt_1);
      }
    }
  }

  if (silence)
    for (int i = 0; i < 2 * NB; i++) old_band_e[i] = -28.0;

  if (C == 1)
    for (int i = 0; i < NB; i++) old_band_e[NB + i] = old_band_e[i];

  memcpy(band_log_e, old_band_e, 2 * NB * sizeof(double));

  if (!is_transient) {
    memcpy(st->old_log_e2, st->old_log_e, sizeof(st->old_log_e));
    memcpy(st->old_log_e, old_band_e, sizeof(st->old_log_e));
    double max_bg = st->loss_count < 10 ? M * 0.001 : 1.0;
    for (int i = 0; i < 2 * NB; i++)
      st->background_log_e[i] =
          std::min(st->background_log_e[i] + max_bg, st->old_log_e[i]);
  } else {
    for (int i = 0; i < 2 * NB; i++)
      st->old_log_e[i] = std::min(st->old_log_e[i], old_band_e[i]);
  }
  for (int c = 0; c < 2; c++) {
    for (int i = 0; i < start; i++) {
      old_band_e[c * NB + i] = 0.0;
      st->old_log_e[c * NB + i] = -28.0;
      st->old_log_e2[c * NB + i] = -28.0;
    }
    for (int i = end; i < NB; i++) {
      old_band_e[c * NB + i] = 0.0;
      st->old_log_e[c * NB + i] = -28.0;
      st->old_log_e2[c * NB + i] = -28.0;
    }
  }
  memcpy(st->old_ebands, eb_loc, sizeof(eb_loc));  // commit
  st->rng = dec->rng;
  st->loss_count = 0;

  iflags[0] = is_transient;
  iflags[1] = silence;
  iflags[2] = postfilter_pitch;
  iflags[3] = postfilter_tapset;
  *pf_gain = postfilter_gain;
  for (int i = 0; i < 2 * NB; i++) o.ble32[i] = (float)band_log_e[i];
  o.pf32[0] = (float)postfilter_gain;

  if (ec_tell(dec) > 8 * length) return -2;
  return dec->error ? -3 : 0;
}

// Zero stream s's plan flag planes (the per-entry memset block of
// celt_host_decode_plan) — used by callers that route a stream to the
// direct decoder WITHOUT running the plan decode (opus_host's
// mono-hybrid-in-stereo path): stale plan rows would otherwise execute.
void celt_host_plan_clear_stream(void** arrs, int s) {
  size_t cs = (size_t)s;
  ((uint8_t*)arrs[0])[cs] = 0;                          // direct
  ((uint16_t*)arrs[2])[cs] = 0;                         // pvq_cnt
  memset((uint8_t*)arrs[3] + cs * NB * 2, 0, NB * 2);   // call_flags
  memset((uint8_t*)arrs[8] + cs * kFillPool, 0, kFillPool);    // fill_cid
  memset((uint8_t*)arrs[13] + cs * NB, 0, NB);          // bm_flags
  memset((uint8_t*)arrs[16] + cs * NB * 2, 0, NB * 2);  // n1_as
  ((uint8_t*)arrs[17])[cs] = 0;                         // ac_on
  memset((int16_t*)arrs[7] + cs * kDupPool * 4, 0,
         kDupPool * 4 * sizeof(int16_t));               // dup_pool
  ((uint8_t*)arrs[28])[cs] = 0;                         // spread8
}

// Batched plan decode across S independent streams (threaded like
// celt_host_decode_batch). rcs[s] < 0 marks a failed stream.
void celt_host_decode_plan_batch(void** states, const uint8_t* blob,
                                 const int32_t* offs, const int32_t* lens,
                                 int S, int frame_size, int C, int start,
                                 int end, int disable_inv, void** arrs,
                                 int n_threads);

}  // extern "C"

// ----------------------------------------------------------- batched decode
#include <thread>
#include <atomic>
#include <vector>

extern "C" {

// Decode S independent streams' frames in parallel (one worker per core).
//   states      S opaque stream states (from celt_host_create)
//   blob        concatenated packet payloads
//   offs/lens   per-stream byte ranges into blob
//   x_out       S * C * frame_size floats
//   band_log_e  S * 2 * 21 doubles
//   iflags      S * 4 int32
//   pf_gains    S doubles
//   rcs         S int32 return codes
void celt_host_decode_batch(void** states, const uint8_t* blob,
                            const int32_t* offs, const int32_t* lens, int S,
                            int frame_size, int C, int start, int end,
                            int disable_inv, float* x_out,
                            double* band_log_e, int32_t* iflags,
                            double* pf_gains, int32_t* rcs, int n_threads) {
  int N = frame_size;
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min(n_threads, S);
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int s = next.fetch_add(1);
      if (s >= S) break;
      rcs[s] = celt_host_decode(
          states[s], blob + offs[s], lens[s], frame_size, C, start, end,
          disable_inv, x_out + (size_t)s * C * N, band_log_e + (size_t)s * 42,
          iflags + (size_t)s * 4, pf_gains + s);
    }
  };
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

void celt_host_decode_plan_batch(void** states, const uint8_t* blob,
                                 const int32_t* offs, const int32_t* lens,
                                 int S, int frame_size, int C, int start,
                                 int end, int disable_inv, void** arrs,
                                 int n_threads) {
  int32_t* rcs = (int32_t*)arrs[25];
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min(n_threads, S);
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int s = next.fetch_add(1);
      if (s >= S) break;
      if (s + 1 < S) {
        // hide the next stream's cold state/payload misses behind this
        // stream's decode (the plan path touches ~1.3 KB of energies
        // per stream; at S=256 that working set falls out of L1/L2)
        const char* nst = (const char*)states[s + 1];
        // rng/loss + the four 2*NB double energy arrays: ~1.4 KB
        for (int off = 0; off < 1408; off += 64)
          __builtin_prefetch(nst + off, 1, 1);
        __builtin_prefetch(blob + offs[s + 1], 0, 1);
        __builtin_prefetch(blob + offs[s + 1] + 64, 0, 1);
      }
      if (lens[s] == 0) {  // lost frame: device PLC conceals it
        celt_host_note_loss(states[s]);
        rcs[s] = 1;
        continue;
      }
      rcs[s] = celt_host_decode_plan(states[s], blob + offs[s], lens[s],
                                     frame_size, C, start, end, disable_inv,
                                     arrs, S, s);
    }
  };
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"

// ===================================================================
// CELT symbol ENCODER (back half): consumes the device front end's
// MDCT spectrum + analysis flags (ops/encode_front_jax.py) and runs
// the full symbol layer — coarse/fine energy, tf, spread, dynalloc,
// allocation, PVQ search + range coding. Mirrors the Python
// celt/encoder.py encode_with_ec precomputed path (itself behavioral
// parity with reference src/celt/celt_encoder.rs:6710) with
// resynth=false (complexity < 8: no theta RDO), own encoder, CBR
// byte budgets (bitrate = -1 semantics). Double-precision signal
// math tracks the numpy float64 Python host encoder.
// ===================================================================
namespace {

// ------------------------------------------------------------ EcEnc
// Range encoder (entenc mirror of bitstream/entcode.py RangeEncoder).
constexpr uint32_t EC_SYM_MAX_E = 255;
constexpr uint32_t EC_CODE_TOP_E = 1u << 31;
constexpr uint32_t EC_CODE_BOT_E = EC_CODE_TOP_E >> 8;
constexpr int EC_CODE_SHIFT_E = 32 - 8 - 1;
constexpr int EC_MAX_BYTES = 1300;

struct EcEnc {
  uint8_t buf[EC_MAX_BYTES];
  uint32_t storage;
  uint32_t end_offs;
  uint32_t end_window;
  int nend_bits;
  int nbits_total;
  uint32_t offs;
  uint32_t rng;
  uint32_t val;
  uint32_t ext;
  int rem;
  int error;
};

void ec_enc_init(EcEnc* e, uint32_t size) {
  e->storage = size;
  e->end_offs = 0;
  e->end_window = 0;
  e->nend_bits = 0;
  e->nbits_total = 32 + 1;
  e->offs = 0;
  e->rng = EC_CODE_TOP_E;
  e->rem = -1;
  e->val = 0;
  e->ext = 0;
  e->error = 0;
}

inline int ec_enc_tell(const EcEnc* e) {
  return e->nbits_total - ec_ilog(e->rng);
}

inline int ec_tell_frac_rn(int nbits_total, uint32_t rng) {
  int nbits = nbits_total << BITRES;
  int l = ec_ilog(rng);
  uint32_t r = rng >> (l - 16);
  for (int i = 0; i < BITRES; i++) {
    r = (r * r) >> 15;
    int b = (int)(r >> 16);
    l = (l << 1) | b;
    r >>= b;
  }
  return nbits - l;
}

inline int ec_enc_tell_frac(const EcEnc* e) {
  return ec_tell_frac_rn(e->nbits_total, e->rng);
}

inline void ec_enc_write_byte(EcEnc* e, uint32_t v) {
  if (e->offs + e->end_offs >= e->storage) {
    e->error = -1;
    return;
  }
  e->buf[e->offs++] = (uint8_t)v;
}

inline void ec_enc_write_byte_at_end(EcEnc* e, uint32_t v) {
  if (e->offs + e->end_offs >= e->storage) {
    e->error = -1;
    return;
  }
  e->end_offs++;
  e->buf[e->storage - e->end_offs] = (uint8_t)v;
}

void ec_enc_carry_out(EcEnc* e, uint32_t c) {
  if (c != EC_SYM_MAX_E) {
    uint32_t carry = c >> 8;
    if (e->rem >= 0) ec_enc_write_byte(e, ((uint32_t)e->rem + carry) & 0xFF);
    if (e->ext > 0) {
      uint32_t sym = (EC_SYM_MAX_E + carry) & EC_SYM_MAX_E;
      while (e->ext > 0) {
        ec_enc_write_byte(e, sym);
        e->ext--;
      }
    }
    e->rem = (int)(c & EC_SYM_MAX_E);
  } else {
    e->ext++;
  }
}

void ec_enc_normalize(EcEnc* e) {
  while (e->rng <= EC_CODE_BOT_E) {
    ec_enc_carry_out(e, e->val >> EC_CODE_SHIFT_E);
    e->val = (e->val << 8) & (EC_CODE_TOP_E - 1);
    e->rng <<= 8;
    e->nbits_total += 8;
  }
}

void ec_encode(EcEnc* e, uint32_t fl, uint32_t fh, uint32_t ft) {
  uint32_t r = e->rng / ft;
  if (fl > 0) {
    e->val += e->rng - r * (ft - fl);
    e->rng = r * (fh - fl);
  } else {
    e->rng -= r * (ft - fh);
  }
  ec_enc_normalize(e);
}

void ec_encode_bin(EcEnc* e, uint32_t fl, uint32_t fh, int bits) {
  uint32_t r = e->rng >> bits;
  if (fl > 0) {
    e->val += e->rng - r * ((1u << bits) - fl);
    e->rng = r * (fh - fl);
  } else {
    e->rng -= r * ((1u << bits) - fh);
  }
  ec_enc_normalize(e);
}

void ec_enc_bit_logp(EcEnc* e, int val, int logp) {
  uint32_t r = e->rng;
  uint32_t l = e->val;
  uint32_t s = r >> logp;
  r -= s;
  if (val) e->val = l + r;
  e->rng = val ? s : r;
  ec_enc_normalize(e);
}

void ec_enc_icdf(EcEnc* e, int s, const uint8_t* icdf, int ftb) {
  uint32_t r = e->rng >> ftb;
  if (s > 0) {
    e->val += e->rng - r * icdf[s - 1];
    e->rng = r * (uint32_t)(icdf[s - 1] - icdf[s]);
  } else {
    e->rng -= r * icdf[s];
  }
  ec_enc_normalize(e);
}

void ec_enc_bits(EcEnc* e, uint32_t fl, int bits) {
  uint32_t window = e->end_window;
  int used = e->nend_bits;
  if (used + bits > 32) {
    while (used >= 8) {
      ec_enc_write_byte_at_end(e, window & EC_SYM_MAX_E);
      window >>= 8;
      used -= 8;
    }
  }
  window |= fl << used;
  used += bits;
  e->end_window = window;
  e->nend_bits = used;
  e->nbits_total += bits;
}

void ec_enc_uint(EcEnc* e, uint32_t fl, uint32_t ft) {
  ft--;
  int ftb = ec_ilog(ft);
  if (ftb > 8) {
    ftb -= 8;
    uint32_t ft_hi = (ft >> ftb) + 1;
    uint32_t fl_hi = fl >> ftb;
    ec_encode(e, fl_hi, fl_hi + 1, ft_hi);
    ec_enc_bits(e, fl & ((1u << ftb) - 1), ftb);
  } else {
    ec_encode(e, fl, fl + 1, ft + 1);
  }
}

void ec_enc_done(EcEnc* e) {
  int l = 32 - ec_ilog(e->rng);
  uint32_t msk = (EC_CODE_TOP_E - 1) >> l;
  uint32_t end = (e->val + msk) & ~msk;
  if ((end | msk) >= e->val + e->rng) {
    l++;
    msk >>= 1;
    end = (e->val + msk) & ~msk;
  }
  while (l > 0) {
    ec_enc_carry_out(e, end >> EC_CODE_SHIFT_E);
    end = (end << 8) & (EC_CODE_TOP_E - 1);
    l -= 8;
  }
  if (e->rem >= 0 || e->ext > 0) ec_enc_carry_out(e, 0);
  uint32_t window = e->end_window;
  int used = e->nend_bits;
  while (used >= 8) {
    ec_enc_write_byte_at_end(e, window & EC_SYM_MAX_E);
    window >>= 8;
    used -= 8;
  }
  if (!e->error) {
    memset(e->buf + e->offs, 0, e->storage - e->end_offs - e->offs);
    if (used > 0) {
      if (e->end_offs >= e->storage) {
        e->error = -1;
      } else {
        l = -l;
        if (e->offs + e->end_offs >= e->storage && l < used) {
          window &= (1u << l) - 1;
          e->error = -1;
        }
        e->buf[e->storage - e->end_offs - 1] |= (uint8_t)(window & 0xFF);
      }
    }
  }
}

// snapshot/restore for the two-pass coarse energy search
struct EcEncSnap {
  EcEnc st;  // includes the buffer (1.3 KB copy, twice per frame)
};
inline void ec_enc_save(EcEncSnap* s, const EcEnc* e) { s->st = *e; }
inline void ec_enc_restore(EcEnc* e, const EcEncSnap* s) { *e = s->st; }

// Laplace encode (bitstream/laplace.py; reference src/celt/laplace.rs:33).
int ec_laplace_encode(EcEnc* e, int value, uint32_t fs, int decay) {
  int val = value;
  uint32_t fl = 0;
  if (val) {
    int s = val < 0 ? -1 : 0;
    val = (val + s) ^ s;
    fl = fs;
    fs = (uint32_t)(((32768 - 2 * 16 - (int)fs) * (16384 - decay)) >> 15);
    int i = 1;
    while (fs > 0 && i < val) {
      fs *= 2;
      fl += fs + 2;
      fs = (fs * (uint32_t)decay) >> 15;
      i++;
    }
    if (fs == 0) {
      int ndi_max = (int)((32768 - fl + 1 - 1) >> 0);
      ndi_max = (ndi_max - s) >> 1;
      int di = std::min(val - i, ndi_max - 1);
      fl += (uint32_t)(2 * di + 1 + s);
      fs = std::min<uint32_t>(1, 32768 - fl);
      value = (i + di + s) ^ s;
    } else {
      fs += 1;
      if (s == 0) fl += fs;
    }
  }
  ec_encode_bin(e, fl, fl + fs, 15);
  return value;
}

// ------------------------------------------------------ CWRS encode
void encode_pulses(EcEnc* e, const int* y, int n) {
  // icwrs (cwrs.py:44): index of y in the V(n, k) enumeration
  int j = n - 1;
  uint32_t i = y[j] < 0 ? 1u : 0u;
  int k = std::abs(y[j]);
  while (j > 0) {
    j--;
    i += pvq_u(n - j, k);
    k += std::abs(y[j]);
    if (y[j] < 0) i += pvq_u(n - j, k + 1);
  }
  ec_enc_uint(e, i, pvq_v(n, k));
}

// ---------------------------------------------- double-precision vq
void exp_rotation1_d(double* X, int len, int stride, double c, double s) {
  double ms = -s;
  for (int i = 0; i < len - stride; i++) {
    double x1 = X[i];
    double x2 = X[i + stride];
    X[i + stride] = c * x2 + s * x1;
    X[i] = c * x1 + ms * x2;
  }
  for (int i = len - 2 * stride - 1; i >= 0; i--) {
    double x1 = X[i];
    double x2 = X[i + stride];
    X[i + stride] = c * x2 + s * x1;
    X[i] = c * x1 + ms * x2;
  }
}

void exp_rotation_d(double* X, int len, int direction, int stride, int K,
                    int spread) {
  if (2 * K >= len || spread == SPREAD_NONE) return;
  int factor = kSpreadFactor[spread - 1];
  double gain = (double)len / (len + factor * K);
  double theta = 0.5 * gain * gain;
  double c = cos(0.5 * M_PI * theta);
  double s = cos(0.5 * M_PI * (1 - theta));
  int stride2 = 0;
  if (len >= 8 * stride) {
    stride2 = 1;
    while ((stride2 * stride2 + stride2) * stride + (stride >> 2) < len)
      stride2++;
  }
  len /= stride;
  for (int i = 0; i < stride; i++) {
    double* seg = X + i * len;
    if (direction < 0) {
      if (stride2) exp_rotation1_d(seg, len, stride2, s, c);
      exp_rotation1_d(seg, len, 1, c, s);
    } else {
      exp_rotation1_d(seg, len, 1, c, -s);
      if (stride2) exp_rotation1_d(seg, len, stride2, s, -c);
    }
  }
}

// Greedy PVQ search (vq.py op_pvq_search:122; reference vq.rs:393).
void op_pvq_search_d(const double* x, int* iy, int N, int K) {
  double X[208];
  int signs[208];
  int64_t y[208];
  for (int j = 0; j < N; j++) {
    X[j] = std::fabs(x[j]);
    signs[j] = x[j] < 0 ? -1 : 1;
    y[j] = 0;
  }
  int pulses_left = K;
  double xy = 0.0, yy = 0.0;
  if (K > (N >> 1)) {
    double sum_x = 0.0;
    for (int j = 0; j < N; j++) sum_x += X[j];
    if (sum_x > 1e-15) {
      double rcp = (K + 0.8) / sum_x;
      int placed = 0;
      for (int j = 0; j < N; j++) {
        y[j] = (int64_t)std::floor(rcp * X[j]);
        placed += (int)y[j];
      }
      pulses_left = K - placed;
      xy = 0.0;
      yy = 0.0;
      for (int j = 0; j < N; j++) {
        xy += X[j] * (double)y[j];
        yy += (double)y[j] * (double)y[j];
      }
    }
  }
  if (pulses_left > N + 3) {
    y[0] += pulses_left;
    xy = yy = 0.0;
    for (int j = 0; j < N; j++) {
      xy += X[j] * (double)y[j];
      yy += (double)y[j] * (double)y[j];
    }
    pulses_left = 0;
  }
  for (int p = 0; p < pulses_left; p++) {
    int best = 0;
    double best_val = -1.0;
    for (int j = 0; j < N; j++) {
      double num = (xy + X[j]) * (xy + X[j]);
      double den = yy + 2.0 * (double)y[j] + 1.0;
      double v = num / den;
      if (v > best_val) {
        best_val = v;
        best = j;
      }
    }
    xy += X[best];
    yy += 2.0 * (double)y[best] + 1.0;
    y[best]++;
  }
  for (int j = 0; j < N; j++) iy[j] = signs[j] * (int)y[j];
}

// alg_quant with resynth=false (vq.py:106): rotate, search, code pulses.
uint32_t alg_quant_d(double* X, int N, int K, int spread, int B, EcEnc* enc) {
  double x[208];
  memcpy(x, X, N * sizeof(double));
  exp_rotation_d(x, N, 1, B, K, spread);
  int iy[208];
  op_pvq_search_d(x, iy, N, K);
  encode_pulses(enc, iy, N);
  return extract_collapse_mask(iy, N, B);
}

void haar1_d(double* X, int n0, int stride) {
  n0 >>= 1;
  const double s = 0.70710678;
  for (int i = 0; i < stride; i++)
    for (int j = 0; j < n0; j++) {
      int i1 = i + stride * 2 * j;
      int i2 = i1 + stride;
      double t1 = s * X[i1];
      double t2 = s * X[i2];
      X[i1] = t1 + t2;
      X[i2] = t1 - t2;
    }
}

void deinterleave_hadamard_d(double* X, int n0, int stride, bool hadamard) {
  int N = n0 * stride;
  double tmp[1024];
  if (hadamard) {
    const int* ordery = ordery_for(stride);
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < n0; j++) tmp[ordery[i] * n0 + j] = X[j * stride + i];
  } else {
    for (int i = 0; i < stride; i++)
      for (int j = 0; j < n0; j++) tmp[i * n0 + j] = X[j * stride + i];
  }
  memcpy(X, tmp, N * sizeof(double));
}

void stereo_split_d(double* X, double* Y, int N) {
  const double s = 0.70710678;
  for (int j = 0; j < N; j++) {
    double l = s * X[j];
    double r = s * Y[j];
    X[j] = l + r;
    Y[j] = r - l;
  }
}

void intensity_stereo_d(double* X, const double* Y, const double* band_e,
                        int band, int N) {
  double left = band_e[band];            // band_e[0, band]
  double right = band_e[NB + band];      // band_e[1, band]
  double norm = 1e-15 + sqrt(1e-15 + left * left + right * right);
  double a1 = left / norm;
  double a2 = right / norm;
  for (int j = 0; j < N; j++) X[j] = a1 * X[j] + a2 * Y[j];
}

int stereo_itheta_d(const double* X, const double* Y, bool stereo, int N) {
  double emid = 1e-6, eside = 1e-6;
  if (stereo) {
    for (int j = 0; j < N; j++) {
      double m = X[j] + Y[j];
      double s = X[j] - Y[j];
      emid += m * m;
      eside += s * s;
    }
  } else {
    for (int j = 0; j < N; j++) {
      emid += X[j] * X[j];
      eside += Y[j] * Y[j];
    }
  }
  return (int)std::floor(0.5 + 16384 * 0.63662 * atan2(sqrt(eside),
                                                       sqrt(emid)));
}

// --------------------------------------------------- encode band loop
struct EncBandCtx {
  int i;
  int intensity;
  int spread;
  int tf_change;
  EcEnc* ec;
  int remaining_bits;
  const double* band_e;  // (2, NB)
  uint32_t seed;
  bool disable_inv;
  bool avoid_split_noise;
};

// compute_theta, encode side (bands.py:200; reference bands.rs:274).
void enc_compute_theta(EncBandCtx* ctx, SplitCtx* sctx, double* X, double* Y,
                       int N, int* b, int B, int B0, int LM, bool stereo,
                       uint32_t* fill) {
  EcEnc* ec = ctx->ec;
  int i = ctx->i;
  int inv = 0;

  int pulse_cap = (int)kLogN[i] + LM * (1 << BITRES);
  int offset = (pulse_cap >> 1) -
               (stereo && N == 2 ? QTHETA_OFFSET_TWOPHASE : QTHETA_OFFSET);
  int qn = compute_qn(N, b[0], offset, pulse_cap, stereo);
  if (stereo && i >= ctx->intensity) qn = 1;
  int itheta = stereo_itheta_d(X, Y ? Y : X + N, stereo, N);
  int tell = ec_enc_tell_frac(ec);
  if (qn != 1) {
    // theta_round == 0 path (no stereo theta RDO at complexity < 8)
    itheta = (itheta * qn + 8192) >> 14;
    if (!stereo && ctx->avoid_split_noise && itheta > 0 && itheta < qn) {
      int unq = (itheta * 16384) / qn;
      int t_imid = bitexact_cos(unq);
      int t_iside = bitexact_cos(16384 - unq);
      int t_delta = frac_mul16((N - 1) << 7, bitexact_log2tan(t_iside, t_imid));
      if (t_delta > b[0])
        itheta = qn;
      else if (t_delta < -b[0])
        itheta = 0;
    }
    if (stereo && N > 2) {
      const int p0 = 3;
      int x = itheta;
      int x0 = qn / 2;
      uint32_t ft = (uint32_t)(p0 * (x0 + 1) + x0);
      uint32_t fl = x <= x0 ? (uint32_t)(p0 * x)
                            : (uint32_t)((x - 1 - x0) + (x0 + 1) * p0);
      uint32_t fh = x <= x0 ? (uint32_t)(p0 * (x + 1))
                            : (uint32_t)((x - x0) + (x0 + 1) * p0);
      ec_encode(ec, fl, fh, ft);
    } else if (B0 > 1 || stereo) {
      ec_enc_uint(ec, (uint32_t)itheta, (uint32_t)(qn + 1));
    } else {
      uint32_t ft = (uint32_t)(((qn >> 1) + 1) * ((qn >> 1) + 1));
      uint32_t fl, fs;
      if (itheta <= qn >> 1) {
        fs = itheta + 1;
        fl = (uint32_t)(itheta * (itheta + 1) >> 1);
      } else {
        fs = qn + 1 - itheta;
        fl = ft - (uint32_t)((qn + 1 - itheta) * (qn + 2 - itheta) >> 1);
      }
      ec_encode(ec, fl, fl + fs, ft);
    }
    itheta = (int)fast_udiv((uint32_t)(itheta * 16384), qn);
    if (stereo) {
      if (itheta == 0)
        intensity_stereo_d(X, Y, ctx->band_e, i, N);
      else
        stereo_split_d(X, Y, N);
    }
  } else if (stereo) {
    inv = (itheta > 8192 && !ctx->disable_inv) ? 1 : 0;
    if (inv)
      for (int j = 0; j < N; j++) Y[j] = -Y[j];
    intensity_stereo_d(X, Y, ctx->band_e, i, N);
    if (b[0] > 2 << BITRES && ctx->remaining_bits > 2 << BITRES)
      ec_enc_bit_logp(ec, inv, 2);
    else
      inv = 0;
    itheta = 0;
  }
  int qalloc = ec_enc_tell_frac(ec) - tell;
  b[0] -= qalloc;

  int imid, iside, delta;
  if (itheta == 0) {
    imid = 32767;
    iside = 0;
    fill[0] &= (1u << B) - 1;
    delta = -16384;
  } else if (itheta == 16384) {
    imid = 0;
    iside = 32767;
    fill[0] &= ((1u << B) - 1) << B;
    delta = 16384;
  } else {
    imid = bitexact_cos(itheta);
    iside = bitexact_cos(16384 - itheta);
    delta = frac_mul16((N - 1) << 7, bitexact_log2tan(iside, imid));
  }
  sctx->inv = inv;
  sctx->imid = imid;
  sctx->iside = iside;
  sctx->delta = delta;
  sctx->itheta = itheta;
  sctx->qalloc = qalloc;
}

uint32_t enc_quant_band_n1(EncBandCtx* ctx, double* X, double* Y,
                           double* lowband_out) {
  EcEnc* ec = ctx->ec;
  double* chans[2] = {X, Y};
  int nch = Y ? 2 : 1;
  for (int c = 0; c < nch; c++) {
    int sign = 0;
    if (ctx->remaining_bits >= 1 << BITRES) {
      sign = chans[c][0] < 0 ? 1 : 0;
      ec_enc_bits(ec, (uint32_t)sign, 1);
      ctx->remaining_bits -= 1 << BITRES;
    }
  }
  if (lowband_out) lowband_out[0] = X[0];
  return 1;
}

uint32_t enc_quant_partition(EncBandCtx* ctx, double* X, int N, int b, int B,
                             int LM, double gain, uint32_t fill) {
  int i = ctx->i;
  int B0 = B;
  uint32_t cm = 0;

  int cache_index = kCacheIndex[(LM + 1) * NB + i];
  const uint8_t* cache = kCacheBits + (cache_index < 0 ? 0 : cache_index);
  bool can_split =
      cache_index >= 0 && LM != -1 && b > (int)cache[cache[0]] + 12 && N > 2;
  if (can_split) {
    N >>= 1;
    double* Y = X + N;
    LM -= 1;
    if (B == 1) fill = (fill & 1) | (fill << 1);
    B = (B + 1) >> 1;

    SplitCtx sctx;
    int b_box = b;
    uint32_t fill_box = fill;
    enc_compute_theta(ctx, &sctx, X, Y, N, &b_box, B, B0, LM, false,
                      &fill_box);
    b = b_box;
    fill = fill_box;
    int delta = sctx.delta, itheta = sctx.itheta, qalloc = sctx.qalloc;
    double mid = sctx.imid / 32768.0;
    double side = sctx.iside / 32768.0;

    if (B0 > 1 && (itheta & 0x3FFF)) {
      if (itheta > 8192)
        delta -= delta >> (4 - LM);
      else
        delta = std::min(0, delta + (N << BITRES >> (5 - LM)));
    }
    int bd = b - delta;
    int half = bd >= 0 ? bd / 2 : -((-bd + 1) / 2);
    int mbits = std::max(0, std::min(b, half));
    int sbits = b - mbits;
    ctx->remaining_bits -= qalloc;

    int rebalance = ctx->remaining_bits;
    if (mbits >= sbits) {
      cm = enc_quant_partition(ctx, X, N, mbits, B, LM, gain * mid, fill);
      rebalance = mbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << BITRES && itheta != 0)
        sbits += rebalance - (3 << BITRES);
      cm |= enc_quant_partition(ctx, Y, N, sbits, B, LM, gain * side,
                                fill >> B)
            << (B0 >> 1);
    } else {
      cm = enc_quant_partition(ctx, Y, N, sbits, B, LM, gain * side,
                               fill >> B)
           << (B0 >> 1);
      rebalance = sbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << BITRES && itheta != 16384)
        mbits += rebalance - (3 << BITRES);
      cm |= enc_quant_partition(ctx, X, N, mbits, B, LM, gain * mid, fill);
    }
  } else {
    int q = bits2pulses(i, LM, b);
    int curr_bits = pulses2bits(i, LM, q);
    ctx->remaining_bits -= curr_bits;
    while (ctx->remaining_bits < 0 && q > 0) {
      ctx->remaining_bits += curr_bits;
      q--;
      curr_bits = pulses2bits(i, LM, q);
      ctx->remaining_bits -= curr_bits;
    }
    if (q != 0) {
      int K = get_pulses(q);
      cm = alg_quant_d(X, N, K, ctx->spread, B, ctx->ec);
    }
    // q == 0 leaf: resynth-only (noise fill / folding), nothing coded
  }
  return cm;
}

uint32_t enc_quant_band(EncBandCtx* ctx, double* X, int N, int b, int B,
                        int LM, double* lowband_out, double gain,
                        uint32_t fill) {
  int N_B = N / B;
  int B0 = B;
  int recombine = 0;
  bool long_blocks = B0 == 1;
  int tf_change = ctx->tf_change;

  if (N == 1) return enc_quant_band_n1(ctx, X, nullptr, lowband_out);

  if (tf_change > 0) recombine = tf_change;

  for (int k = 0; k < recombine; k++) {
    haar1_d(X, N >> k, 1 << k);
    fill = kBitInterleave[fill & 0xF] | kBitInterleave[(fill >> 4) & 0xF] << 2;
  }
  B >>= recombine;
  N_B <<= recombine;

  while ((N_B & 1) == 0 && tf_change < 0) {
    haar1_d(X, N_B, B);
    fill |= fill << B;
    B <<= 1;
    N_B >>= 1;
    tf_change++;
  }
  B0 = B;

  if (B0 > 1)
    deinterleave_hadamard_d(X, N_B >> recombine, B0 << recombine, long_blocks);

  return enc_quant_partition(ctx, X, N, b, B, LM, gain, fill);
  // resynth=false: no interleave-back, no lowband_out fill, raw cm
}

uint32_t enc_quant_band_stereo(EncBandCtx* ctx, double* X, double* Y, int N,
                               int b, int B, int LM, double* lowband_out,
                               uint32_t fill) {
  if (N == 1) return enc_quant_band_n1(ctx, X, Y, lowband_out);

  EcEnc* ec = ctx->ec;
  uint32_t orig_fill = fill;
  SplitCtx sctx;
  int b_box = b;
  uint32_t fill_box = fill;
  enc_compute_theta(ctx, &sctx, X, Y, N, &b_box, B, B, LM, true, &fill_box);
  b = b_box;
  fill = fill_box;
  int delta = sctx.delta, itheta = sctx.itheta, qalloc = sctx.qalloc;
  double side = sctx.iside / 32768.0;
  uint32_t cm;

  if (N == 2) {
    int mbits = b;
    int sbits = 0;
    if (itheta != 0 && itheta != 16384) sbits = 1 << BITRES;
    mbits -= sbits;
    bool c = itheta > 8192;
    ctx->remaining_bits -= qalloc + sbits;
    double* x2 = c ? Y : X;
    double* y2 = c ? X : Y;
    int sign = 0;
    if (sbits) {
      sign = x2[0] * y2[1] - x2[1] * y2[0] < 0 ? 1 : 0;
      ec_enc_bits(ec, (uint32_t)sign, 1);
    }
    sign = 1 - 2 * sign;
    cm = enc_quant_band(ctx, x2, N, mbits, B, LM, lowband_out, 1.0,
                        orig_fill);
    y2[0] = -sign * x2[1];
    y2[1] = sign * x2[0];
  } else {
    int bd = b - delta;
    int half = bd >= 0 ? bd / 2 : -((-bd + 1) / 2);
    int mbits = std::max(0, std::min(b, half));
    int sbits = b - mbits;
    ctx->remaining_bits -= qalloc;
    int rebalance = ctx->remaining_bits;
    if (mbits >= sbits) {
      cm = enc_quant_band(ctx, X, N, mbits, B, LM, lowband_out, 1.0, fill);
      rebalance = mbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << BITRES && itheta != 0)
        sbits += rebalance - (3 << BITRES);
      cm |= enc_quant_band(ctx, Y, N, sbits, B, LM, nullptr, side,
                           fill >> B);
    } else {
      cm = enc_quant_band(ctx, Y, N, sbits, B, LM, nullptr, side, fill >> B);
      rebalance = sbits - (rebalance - ctx->remaining_bits);
      if (rebalance > 3 << BITRES && itheta != 16384)
        mbits += rebalance - (3 << BITRES);
      cm |= enc_quant_band(ctx, X, N, mbits, B, LM, lowband_out, 1.0, fill);
    }
  }
  // resynth=false: no stereo_merge / inv flip
  return cm;
}

// quant_all_bands, encode side with resynth=false (bands.py:655). With no
// resynthesis the lowband_offset gate never opens (matches the Python host
// encoder at complexity < 8): every band folds from a fresh fill mask and
// no norm buffer is consumed.
uint32_t enc_quant_all_bands(int start, int end, double* X_, double* Y_,
                             uint8_t* collapse_masks, const double* band_e,
                             const int* pulses, bool short_blocks, int spread,
                             int dual_stereo, int intensity, const int* tf_res,
                             int total_bits, int balance, EcEnc* ec, int LM,
                             int coded_bands, uint32_t seed, bool disable_inv) {
  int M = 1 << LM;
  int B = short_blocks ? M : 1;
  int norm_offset = M * kEBands[start];
  int C = Y_ ? 2 : 1;
  double norm_sink[2 * 8 * 100];  // dead lowband_out writes (n1 bands)

  EncBandCtx ctx;
  ctx.intensity = intensity;
  ctx.spread = spread;
  ctx.ec = ec;
  ctx.band_e = band_e;
  ctx.seed = seed;
  ctx.disable_inv = disable_inv;
  ctx.avoid_split_noise = B > 1;

  for (int i = start; i < end; i++) {
    ctx.i = i;
    bool last = i == end - 1;
    double* X = X_ + M * kEBands[i];
    double* Y = Y_ ? Y_ + M * kEBands[i] : nullptr;
    int N = M * kEBands[i + 1] - M * kEBands[i];
    int tell = ec_enc_tell_frac(ec);

    if (i != start) balance -= tell;
    int remaining_bits = total_bits - tell - 1;
    ctx.remaining_bits = remaining_bits;
    int b;
    if (i <= coded_bands - 1) {
      int den = std::min(3, coded_bands - i);
      int curr_balance = balance / den;
      b = std::max(0, std::min(16383, std::min(remaining_bits + 1,
                                               pulses[i] + curr_balance)));
    } else {
      b = 0;
    }

    ctx.tf_change = tf_res[i];
    uint32_t x_cm = (1u << B) - 1, y_cm = (1u << B) - 1;

    if (dual_stereo && i == intensity) dual_stereo = 0;
    if (dual_stereo) {
      x_cm = enc_quant_band(&ctx, X, N, b / 2, B, LM,
                            last ? nullptr
                                 : norm_sink + M * kEBands[i] - norm_offset,
                            1.0, x_cm);
      y_cm = enc_quant_band(&ctx, Y, N, b / 2, B, LM,
                            last ? nullptr
                                 : norm_sink + M * kEBands[i] - norm_offset,
                            1.0, y_cm);
    } else {
      if (Y) {
        x_cm = enc_quant_band_stereo(
            &ctx, X, Y, N, b, B, LM,
            last ? nullptr : norm_sink + M * kEBands[i] - norm_offset,
            x_cm | y_cm);
      } else {
        x_cm = enc_quant_band(
            &ctx, X, N, b, B, LM,
            last ? nullptr : norm_sink + M * kEBands[i] - norm_offset, 1.0,
            x_cm | y_cm);
      }
      y_cm = x_cm;
    }
    collapse_masks[i * C + 0] = (uint8_t)(x_cm & 0xFF);
    collapse_masks[i * C + C - 1] = (uint8_t)(y_cm & 0xFF);
    balance += pulses[i] + tell;
    ctx.avoid_split_noise = false;
  }
  return ctx.seed;
}

}  // namespace

// ------------------------------------------------- encoder energies
namespace {

const double kEMeansD[21] = {6.4375, 6.25,  5.75,   5.3125, 5.0625, 4.8125,
                             4.5,    4.375, 4.875,  4.6875, 4.5625, 4.4375,
                             4.875,  4.625, 4.3125, 4.5,    4.375,  4.625,
                             4.75,   4.4375, 3.75};
const int kIntensityThresholds[21] = {1,  2,  3,  4,  5,  6,  7,  8,  16, 24,
                                      36, 44, 50, 56, 62, 67, 72, 79, 88,
                                      106, 134};
const int kIntensityHysteresis[21] = {1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2,
                                      2, 2, 2, 3, 3, 4, 5, 6, 8, 8};

// hysteresis_decision (encoder.py:51; reference celt/bands.rs:573)
int hysteresis_decision(double value, const int* thresholds,
                        const int* hysteresis, int count, int prev) {
  int index = 0;
  while (index < count && value >= thresholds[index]) index++;
  if (prev < count && index > prev && value < thresholds[prev] + hysteresis[prev])
    index = prev;
  if (prev > 0 && index < prev && value > thresholds[prev - 1] - hysteresis[prev - 1])
    index = prev;
  return index;
}

// coarse energy quantizer, encode side (encoder.py:1059 _coarse_impl)
int enc_coarse_impl(EcEnc* enc, const double* e_bands, double* old, int budget,
                    int tell, const uint8_t* prob_model, double* error, int C,
                    int LM, bool intra, double max_decay, int start, int end,
                    bool lfe) {
  int badness = 0;
  double prev[2] = {0.0, 0.0};
  if (tell + 3 <= budget) ec_enc_bit_logp(enc, intra ? 1 : 0, 3);
  double coef = intra ? 0.0 : kPredCoef[LM];
  double beta = intra ? kBetaIntra : kBetaCoef[LM];
  for (int i = start; i < end; i++) {
    for (int c = 0; c < C; c++) {
      double x = e_bands[c * NB + i];
      double old_e = std::max(-9.0, old[c * NB + i]);
      double f = x - coef * old_e - prev[c];
      int qi = (int)std::floor(0.5 + f);
      double decay_bound = std::max(-28.0, old[c * NB + i]) - max_decay;
      if (qi < 0 && x < decay_bound) {
        qi += (int)(decay_bound - x);
        if (qi > 0) qi = 0;
      }
      int qi0 = qi;
      tell = ec_enc_tell(enc);
      int bits_left = budget - tell - 3 * C * (end - i);
      if (i != start && bits_left < 30) {
        if (bits_left < 24) qi = std::min(1, qi);
        if (bits_left < 16) qi = std::max(-1, qi);
      }
      if (lfe && i >= 2) qi = std::min(qi, 0);
      if (budget - tell >= 15) {
        int pi = 2 * std::min(i, 20);
        qi = ec_laplace_encode(enc, qi, (uint32_t)prob_model[pi] << 7,
                               (int)prob_model[pi + 1] << 6);
      } else if (budget - tell >= 2) {
        qi = std::max(-1, std::min(qi, 1));
        ec_enc_icdf(enc, (2 * qi) ^ -(qi < 0 ? 1 : 0), kSmallEnergyICDF, 2);
      } else if (budget - tell >= 1) {
        qi = std::min(0, qi);
        ec_enc_bit_logp(enc, -qi, 1);
      } else {
        qi = -1;
      }
      error[c * NB + i] = f - qi;
      badness += std::abs(qi0 - qi);
      double q = (double)qi;
      double tmp = coef * old_e + prev[c] + q;
      old[c * NB + i] = tmp;
      prev[c] = prev[c] + q - beta * q;
    }
  }
  return lfe ? 0 : badness;
}

struct CeltEncHost {
  int channels;       // == stream channels (C)
  int complexity;
  int disable_inv;
  int lsb_depth;
  uint32_t rng;
  int spread_decision;
  double delayed_intra;
  int tonal_average;
  int hf_average;
  int tapset_decision;
  int consec_transient;
  int intensity;
  int last_coded_bands;
  int force_intra;
  int loss_rate;
  double old_band_e[2 * NB];
  double old_log_e[2 * NB];
  double old_log_e2[2 * NB];
  double energy_error[2 * NB];
};

void celt_enc_reset_impl(CeltEncHost* st) {
  st->rng = 0;
  st->spread_decision = SPREAD_NORMAL;
  st->delayed_intra = 1.0;
  st->tonal_average = 256;
  st->hf_average = 0;
  st->tapset_decision = 0;
  st->consec_transient = 0;
  st->intensity = 0;
  st->last_coded_bands = 0;
  st->force_intra = 0;
  st->loss_rate = 0;
  for (int i = 0; i < 2 * NB; i++) {
    st->old_band_e[i] = 0.0;
    st->old_log_e[i] = -28.0;
    st->old_log_e2[i] = -28.0;
    st->energy_error[i] = 0.0;
  }
}

double enc_loss_distortion(const double* e_bands, const double* old, int start,
                           int end, int C) {
  double d = 0.0;
  for (int c = 0; c < C; c++)
    for (int i = start; i < end; i++) {
      double t = e_bands[c * NB + i] - old[c * NB + i];
      d += t * t;
    }
  return std::min(200.0, d);
}

void enc_quant_coarse_energy(CeltEncHost* st, EcEnc* enc,
                             const double* e_bands, double* error, int budget,
                             int C, int LM, int eff_end,
                             int nb_available_bytes, bool two_pass, int start,
                             int end) {
  double* old = st->old_band_e;
  bool intra = st->force_intra ||
               (!two_pass && st->delayed_intra > 2 * C * (end - start) &&
                nb_available_bytes > (end - start) * C);
  int intra_bias =
      (int)((double)budget * st->delayed_intra * st->loss_rate / (C * 512));
  double new_distortion = enc_loss_distortion(e_bands, old, start, eff_end, C);

  int tell = ec_enc_tell(enc);
  if (tell + 3 > budget) {
    two_pass = false;
    intra = false;
  }

  double max_decay = 16.0;
  if (end - start > 10)
    max_decay = std::min(max_decay, 0.125 * nb_available_bytes);

  static thread_local EcEncSnap snap_start, snap_intra;
  ec_enc_save(&snap_start, enc);
  double old_intra[2 * NB];
  memcpy(old_intra, old, sizeof(old_intra));
  double error_intra[2 * NB] = {0};
  int badness1 = 0;
  const uint8_t* pm_intra = kEProbModel + (LM * 2 + 1) * 42;
  const uint8_t* pm_inter = kEProbModel + (LM * 2 + 0) * 42;
  if (two_pass || intra)
    badness1 = enc_coarse_impl(enc, e_bands, old_intra, budget, tell, pm_intra,
                               error_intra, C, LM, true, max_decay, start, end,
                               false);
  if (!intra) {
    ec_enc_save(&snap_intra, enc);
    int tell_intra = ec_enc_tell_frac(enc);
    ec_enc_restore(enc, &snap_start);
    int badness2 = enc_coarse_impl(enc, e_bands, old, budget, tell, pm_inter,
                                   error, C, LM, false, max_decay, start, end,
                                   false);
    if (two_pass &&
        (badness1 < badness2 ||
         (badness1 == badness2 &&
          ec_enc_tell_frac(enc) + intra_bias > tell_intra))) {
      ec_enc_restore(enc, &snap_intra);
      memcpy(old, old_intra, sizeof(old_intra));
      memcpy(error, error_intra, sizeof(error_intra));
      intra = true;
    }
  } else {
    memcpy(old, old_intra, sizeof(old_intra));
    memcpy(error, error_intra, sizeof(error_intra));
  }

  if (intra)
    st->delayed_intra = new_distortion;
  else
    st->delayed_intra =
        kPredCoef[LM] * kPredCoef[LM] * st->delayed_intra + new_distortion;
}

void enc_quant_fine_energy(CeltEncHost* st, EcEnc* enc, double* error,
                           const int* fine_quant, int C, int start, int end) {
  for (int i = start; i < end; i++) {
    if (fine_quant[i] <= 0) continue;
    int frac = 1 << fine_quant[i];
    for (int c = 0; c < C; c++) {
      int q2 = (int)std::floor((error[c * NB + i] + 0.5) * frac);
      q2 = std::max(0, std::min(q2, frac - 1));
      ec_enc_bits(enc, (uint32_t)q2, fine_quant[i]);
      double offset = (q2 + 0.5) * std::ldexp(1.0, -fine_quant[i]) - 0.5;
      st->old_band_e[c * NB + i] += offset;
      error[c * NB + i] -= offset;
    }
  }
}

void enc_quant_energy_finalise(CeltEncHost* st, EcEnc* enc, double* error,
                               const int* fine_quant, const int* fine_priority,
                               int bits_left, int C, int start, int end) {
  for (int prio = 0; prio < 2; prio++) {
    for (int i = start; i < end; i++) {
      if (bits_left < C) break;
      if (fine_quant[i] >= MAX_FINE_BITS || fine_priority[i] != prio) continue;
      for (int c = 0; c < C; c++) {
        int q2 = error[c * NB + i] < 0 ? 0 : 1;
        ec_enc_bits(enc, (uint32_t)q2, 1);
        double offset = (q2 - 0.5) * std::ldexp(1.0, -(fine_quant[i] + 1));
        st->old_band_e[c * NB + i] += offset;
        error[c * NB + i] -= offset;
        bits_left--;
      }
    }
  }
}

// tf_encode (encoder.py:1112)
void enc_tf_encode(EcEnc* enc, bool is_transient, int* tf_res, int LM,
                   int tf_select, int budget, int start, int end) {
  int tell = ec_enc_tell(enc);
  int logp = is_transient ? 2 : 4;
  int tf_select_rsv = (LM > 0 && tell + logp + 1 <= budget) ? 1 : 0;
  budget -= tf_select_rsv;
  int curr = 0, tf_changed = 0;
  for (int i = start; i < end; i++) {
    if (tell + logp <= budget) {
      ec_enc_bit_logp(enc, tf_res[i] ^ curr, logp);
      tell = ec_enc_tell(enc);
      curr = tf_res[i];
      tf_changed |= curr;
    } else {
      tf_res[i] = curr;
    }
    logp = is_transient ? 4 : 5;
  }
  int ti = is_transient ? 1 : 0;
  if (tf_select_rsv && kTfSelect[LM * 8 + 4 * ti + 0 + tf_changed] !=
                           kTfSelect[LM * 8 + 4 * ti + 2 + tf_changed])
    ec_enc_bit_logp(enc, tf_select, 1);
  else
    tf_select = 0;
  for (int i = start; i < end; i++)
    tf_res[i] = kTfSelect[LM * 8 + 4 * ti + 2 * tf_select + tf_res[i]];
}

// tf_analysis (encoder.py:801; reference celt_encoder.rs:1604)
int enc_tf_analysis(int eff_end, bool is_transient, int lam, const double* X,
                    int LM, double tf_estimate, const int* importance,
                    int* tf_res) {
  double bias = 0.04 * std::max(-0.25, 0.5 - tf_estimate);
  int metric[NB] = {0};

  for (int band = 0; band < eff_end; band++) {
    int j0 = kEBands[band], j1 = kEBands[band + 1];
    int width = j1 - j0;
    int n = width << LM;
    double tmp[224];
    memcpy(tmp, X + (j0 << LM), n * sizeof(double));
    bool narrow = width == 1;
    int best_level = 0;
    auto l1_metric = [&](const double* v, int len, int b) {
      double s = 0.0;
      for (int j = 0; j < len; j++) s += std::fabs(v[j]);
      return s + b * bias * s;
    };
    double best_l1 = l1_metric(tmp, n, is_transient ? LM : 0);
    if (is_transient && !narrow) {
      double alt[224];
      memcpy(alt, tmp, n * sizeof(double));
      haar1_d(alt, n >> LM, 1 << LM);
      double l1 = l1_metric(alt, n, LM + 1);
      if (l1 < best_l1) {
        best_l1 = l1;
        best_level = -1;
      }
    }
    int extra = (is_transient || narrow) ? 0 : 1;
    for (int k = 0; k < LM + extra; k++) {
      if (n >> k == 0) break;
      haar1_d(tmp, n >> k, 1 << k);
      int b = is_transient ? (LM - k - 1) : (k + 1);
      double l1 = l1_metric(tmp, n, b);
      if (l1 < best_l1) {
        best_l1 = l1;
        best_level = k + 1;
      }
    }
    int value = is_transient ? 2 * best_level : -2 * best_level;
    if (narrow && (value == 0 || value == -2 * LM)) value -= 1;
    metric[band] = value;
  }

  int base = is_transient ? 4 : 0;
  int path0[NB], path1[NB];
  auto viterbi = [&](int sel, int* p0, int* p1, int64_t* c0_out,
                     int64_t* c1_out) {
    int t0 = 2 * (int)kTfSelect[LM * 8 + base + 2 * sel];
    int t1 = 2 * (int)kTfSelect[LM * 8 + base + 2 * sel + 1];
    int64_t cost0 = (int64_t)importance[0] * std::abs(metric[0] - t0);
    int64_t cost1 = (int64_t)importance[0] * std::abs(metric[0] - t1) +
                    (is_transient ? 0 : lam);
    for (int band = 1; band < eff_end; band++) {
      int64_t curr0, curr1;
      if (cost0 < cost1 + lam) {
        curr0 = cost0;
        p0[band] = 0;
      } else {
        curr0 = cost1 + lam;
        p0[band] = 1;
      }
      if (cost0 + lam < cost1) {
        curr1 = cost0 + lam;
        p1[band] = 0;
      } else {
        curr1 = cost1;
        p1[band] = 1;
      }
      cost0 = curr0 + (int64_t)importance[band] * std::abs(metric[band] - t0);
      cost1 = curr1 + (int64_t)importance[band] * std::abs(metric[band] - t1);
    }
    *c0_out = cost0;
    *c1_out = cost1;
  };
  int64_t c0a, c1a, c0b, c1b;
  viterbi(0, path0, path1, &c0a, &c1a);
  viterbi(1, path0, path1, &c0b, &c1b);
  int tf_select =
      (is_transient && std::min(c0b, c1b) < std::min(c0a, c1a)) ? 1 : 0;
  int64_t cost0, cost1;
  viterbi(tf_select, path0, path1, &cost0, &cost1);
  tf_res[eff_end - 1] = cost0 < cost1 ? 0 : 1;
  for (int band = eff_end - 2; band >= 0; band--)
    tf_res[band] = tf_res[band + 1] ? path1[band + 1] : path0[band + 1];
  return tf_select;
}

// spreading_decision (encoder.py:740; reference bands.rs:3576)
int enc_spreading_decision(CeltEncHost* st, const double* X, int end, int C,
                           int M, const int* spread_weight, bool update_hf,
                           int N_per_ch) {
  if (M * (kEBands[end] - kEBands[end - 1]) <= 8) return SPREAD_NONE;
  int ssum = 0, nb_bands = 0, hf_sum = 0;
  for (int c = 0; c < C; c++) {
    for (int band = 0; band < end; band++) {
      int j0 = M * kEBands[band], j1 = M * kEBands[band + 1];
      int n = j1 - j0;
      if (n <= 8) continue;
      int t0 = 0, t1 = 0, t2 = 0;
      for (int j = j0; j < j1; j++) {
        double x2n = X[c * N_per_ch + j] * X[c * N_per_ch + j] * n;
        t0 += x2n < 0.25;
        t1 += x2n < 0.0625;
        t2 += x2n < 0.015625;
      }
      if (band + 4 > kNbEBands) hf_sum += 32 * (t1 + t0) / n;
      int tmp = (2 * t2 >= n) + (2 * t1 >= n) + (2 * t0 >= n);
      ssum += tmp * spread_weight[band];
      nb_bands += spread_weight[band];
    }
  }
  if (update_hf) {
    if (hf_sum) {
      int denom = C * (4 - kNbEBands + end);
      hf_sum = denom > 0 ? hf_sum / denom : 0;
    }
    st->hf_average = (st->hf_average + hf_sum) >> 1;
    hf_sum = st->hf_average;
    if (st->tapset_decision == 2)
      hf_sum += 4;
    else if (st->tapset_decision == 0)
      hf_sum -= 4;
    if (hf_sum > 22)
      st->tapset_decision = 2;
    else if (hf_sum > 18)
      st->tapset_decision = 1;
    else
      st->tapset_decision = 0;
  }
  if (nb_bands <= 0) return SPREAD_NORMAL;
  ssum = ((ssum << 8) / nb_bands + st->tonal_average) >> 1;
  st->tonal_average = ssum;
  ssum = (3 * ssum + (((3 - st->spread_decision) << 7) + 64) + 2) >> 2;
  if (ssum < 80) return SPREAD_AGGRESSIVE;
  if (ssum < 256) return SPREAD_NORMAL;
  if (ssum < 384) return SPREAD_LIGHT;
  return SPREAD_NONE;
}

// stereo_analysis (encoder.py:720; reference celt_encoder.rs:1559)
bool enc_stereo_analysis(const double* X, int LM, int N, int N_per_ch) {
  double sum_lr = 1e-15, sum_ms = 1e-15;
  for (int band = 0; band < 13; band++) {
    int j0 = kEBands[band] << LM, j1 = kEBands[band + 1] << LM;
    if (j1 <= j0 || j1 > N) continue;
    for (int j = j0; j < j1; j++) {
      double l = X[j], r = X[N_per_ch + j];
      sum_lr += std::fabs(l) + std::fabs(r);
      sum_ms += std::fabs(l + r) + std::fabs(l - r);
    }
  }
  sum_ms *= 0.7071067811865476;
  int thetas = 13 - (LM <= 1 ? 8 : 0);
  double base = (double)(kEBands[13] << (LM + 1));
  return (base + thetas) * sum_ms > base * sum_lr;
}

inline double median3(double a, double b, double c) {
  if (a > b) std::swap(a, b);
  if (b > c) std::swap(b, c);
  if (a > b) std::swap(a, b);
  return b;
}

inline double median5(const double* v) {
  double t[5] = {v[0], v[1], v[2], v[3], v[4]};
  std::sort(t, t + 5);
  return t[2];
}

// dynalloc_analysis (encoder.py:886; reference celt_encoder.rs:2861)
void enc_dynalloc_analysis(CeltEncHost* st, const double* band_log_e,
                           const double* old_band_e, int C, int LM,
                           int effective_bytes, bool is_transient,
                           double tone_freq, double toneishness, int* want,
                           int* importance, int* spread_weight, int start,
                           int end, bool vbr) {
  for (int i = 0; i < NB; i++) {
    want[i] = 0;
    importance[i] = 13;
    spread_weight[i] = 32;
  }
  double noise_floor[NB];
  for (int i = 0; i < end; i++)
    noise_floor[i] = 0.0625 * (double)kLogN[i] + 0.5 +
                     (9.0 - st->lsb_depth) - kEMeansD[i] +
                     0.0062 * (i + 5.0) * (i + 5.0);
  double sig[NB], mask[NB];
  for (int i = 0; i < end; i++) {
    sig[i] = band_log_e[i] - noise_floor[i];
    if (C == 2)
      sig[i] = std::max(sig[i], band_log_e[NB + i] - noise_floor[i]);
    mask[i] = sig[i];
  }
  for (int i = 1; i < end; i++) mask[i] = std::max(mask[i], mask[i - 1] - 2.0);
  for (int i = end - 2; i >= 0; i--)
    mask[i] = std::max(mask[i], mask[i + 1] - 3.0);
  double max_depth = -1e30;
  for (int c = 0; c < C; c++)
    for (int i = 0; i < end; i++)
      max_depth = std::max(max_depth, band_log_e[c * NB + i] - noise_floor[i]);
  double base_threshold = std::max(0.0, max_depth - 12.0);
  for (int i = 0; i < end; i++) {
    double smr = sig[i] - std::max(base_threshold, mask[i]);
    int shift = std::min(5, std::max(0, -(int)std::floor(smr + 0.5)));
    spread_weight[i] = 32 >> shift;
  }
  if (effective_bytes < 30 + 5 * LM) return;

  double follower[2][NB];
  for (int c = 0; c < C; c++) {
    double ble3[NB];
    for (int i = 0; i < end; i++) ble3[i] = band_log_e[c * NB + i];
    if (LM == 0) {
      int k = std::min(end, 8);
      for (int i = 0; i < k; i++)
        ble3[i] = std::max(ble3[i], old_band_e[c * NB + i]);
    }
    double f[NB];
    f[0] = ble3[0];
    int last = 0;
    for (int i = 1; i < end; i++) {
      if (ble3[i] > ble3[i - 1] + 0.5) last = i;
      f[i] = std::min(f[i - 1] + 1.5, ble3[i]);
    }
    for (int i = last - 1; i >= 0; i--)
      f[i] = std::min(f[i], std::min(f[i + 1] + 2.0, ble3[i]));
    if (end >= 3) {
      double med0 = median3(ble3[0], ble3[1], ble3[2]) - 1.0;
      f[0] = std::max(f[0], med0);
      f[1] = std::max(f[1], med0);
      double med1 = median3(ble3[end - 3], ble3[end - 2], ble3[end - 1]) - 1.0;
      f[end - 2] = std::max(f[end - 2], med1);
      f[end - 1] = std::max(f[end - 1], med1);
    }
    for (int i = 2; i < end - 2; i++)
      f[i] = std::max(f[i], median5(ble3 + i - 2) - 1.0);
    for (int i = 0; i < end; i++)
      follower[c][i] = std::max(f[i], noise_floor[i]);
  }
  double depth[NB];
  if (C == 2) {
    for (int k = 0, i = start; i < end; i++, k++) {
      double fr = std::max(follower[1][i], follower[0][i] - 4.0);
      double fl = std::max(follower[0][i], fr - 4.0);
      double dl = std::max(band_log_e[i] - fl, 0.0);
      double dr = std::max(band_log_e[NB + i] - fr, 0.0);
      depth[k] = 0.5 * (dl + dr);
    }
  } else {
    for (int k = 0, i = start; i < end; i++, k++)
      depth[k] = std::max(band_log_e[i] - follower[0][i], 0.0);
  }
  for (int k = 0, i = start; i < end; i++, k++)
    importance[i] = (int)(13.0 * std::pow(2.0, std::min(depth[k], 4.0)) + 0.5);
  if (!vbr && !is_transient)
    for (int k = 0; k < end - start; k++) depth[k] *= 0.5;
  bool have_tone = toneishness > 0.98;
  int tone_bin =
      have_tone ? (int)std::floor(tone_freq * (120.0 / M_PI) + 0.5) : 0;
  for (int k = 0, i = start; i < end; i++, k++) {
    double d = depth[k];
    if (i < 8) d *= 2.0;
    if (i >= 12) d *= 0.5;
    if (have_tone) {
      int lo = kEBands[i], hi = kEBands[i + 1];
      if (lo <= tone_bin && tone_bin <= hi) d += 2.0;
      if (lo - 1 <= tone_bin && tone_bin <= hi + 1) d += 1.0;
      if (lo - 2 <= tone_bin && tone_bin <= hi + 2) d += 1.0;
      if (lo - 3 <= tone_bin && tone_bin <= hi + 3) d += 0.5;
    }
    d = std::min(d, 4.0);
    int width = C * (kEBands[i + 1] - kEBands[i]) << LM;
    if (width < 6)
      want[i] = (int)d;
    else if (width > 48)
      want[i] = (int)(d * 8.0);
    else
      want[i] = (int)(d * width / 6.0);
  }
}

// encoder-side interp_bits2pulses (rate.py:34 with is_encoder=True)
void enc_interp_bits2pulses(int start, int end, int skip_start,
                            const int* bits1, const int* bits2,
                            const int* thresh, const int* cap, int total,
                            int skip_rsv, int intensity, int intensity_rsv,
                            int dual_stereo, int dual_stereo_rsv, int C,
                            int LM, EcEnc* enc, int prev,
                            int signal_bandwidth, Alloc* out) {
  const int16_t* eb = kEBands;
  int alloc_floor = C << BITRES;
  int stereo = C > 1 ? 1 : 0;
  int log_m = LM << BITRES;
  int bits[NB] = {0};

  int lo = 0, hi = 1 << ALLOC_STEPS;
  for (int it = 0; it < ALLOC_STEPS; it++) {
    int mid = (lo + hi) >> 1;
    int psum = 0, done = 0;
    for (int j = end - 1; j >= start; j--) {
      int tmp = bits1[j] + ((mid * bits2[j]) >> ALLOC_STEPS);
      if (tmp >= thresh[j] || done) {
        done = 1;
        psum += std::min(tmp, cap[j]);
      } else if (tmp >= alloc_floor) {
        psum += alloc_floor;
      }
    }
    if (psum > total)
      hi = mid;
    else
      lo = mid;
  }
  int psum = 0, done = 0;
  for (int j = end - 1; j >= start; j--) {
    int tmp = bits1[j] + ((lo * bits2[j]) >> ALLOC_STEPS);
    if (tmp < thresh[j] && !done)
      tmp = tmp >= alloc_floor ? alloc_floor : 0;
    else
      done = 1;
    tmp = std::min(tmp, cap[j]);
    bits[j] = tmp;
    psum += tmp;
  }

  int coded_bands = end;
  while (coded_bands > start) {
    int j = coded_bands - 1;
    if (j <= skip_start) {
      total += skip_rsv;
      break;
    }
    int band_width = eb[coded_bands] - eb[j];
    uint32_t left = (uint32_t)(total - psum);
    int denom = eb[coded_bands] - eb[start];
    uint32_t per_coeff = left / denom;
    int32_t left2 = (int32_t)(left - denom * per_coeff);
    int rem = std::max(left2 - (eb[j] - eb[start]), 0);
    int32_t band_bits = (int32_t)(bits[j] + per_coeff * band_width + rem);
    if (band_bits >= std::max(thresh[j], alloc_floor + (1 << BITRES))) {
      bool decision;
      if (coded_bands <= start + 2) {
        decision = true;
      } else {
        int depth_threshold =
            coded_bands > 17 ? (j < prev ? 7 : 9) : 0;
        decision =
            band_bits > ((depth_threshold * band_width) << (LM + BITRES)) >> 4
            && j <= signal_bandwidth;
      }
      ec_enc_bit_logp(enc, decision ? 1 : 0, 1);
      if (decision) break;
      psum += 1 << BITRES;
      band_bits -= 1 << BITRES;
    }
    psum -= bits[j] + intensity_rsv;
    if (intensity_rsv > 0) intensity_rsv = kLog2FracTable[j - start];
    psum += intensity_rsv;
    if (band_bits >= alloc_floor) {
      psum += alloc_floor;
      bits[j] = alloc_floor;
    } else {
      bits[j] = 0;
    }
    coded_bands--;
  }

  if (intensity_rsv > 0) {
    intensity = std::min(intensity, coded_bands);
    ec_enc_uint(enc, (uint32_t)(intensity - start),
                (uint32_t)(coded_bands + 1 - start));
  } else {
    intensity = 0;
  }
  if (intensity <= start) {
    total += dual_stereo_rsv;
    dual_stereo_rsv = 0;
  }
  if (dual_stereo_rsv > 0)
    ec_enc_bit_logp(enc, dual_stereo, 1);
  else
    dual_stereo = 0;

  int denom = std::max(eb[coded_bands] - eb[start], 1);
  uint32_t left = (uint32_t)(total - psum);
  uint32_t per_coeff = left / denom;
  int32_t leftr = (int32_t)(left - denom * per_coeff);
  for (int j = start; j < coded_bands; j++)
    bits[j] += (int)per_coeff * (eb[j + 1] - eb[j]);
  for (int j = start; j < coded_bands; j++) {
    int add = std::min((int)(eb[j + 1] - eb[j]), (int)leftr);
    bits[j] += add;
    leftr -= add;
  }

  int balance = 0;
  for (int j = start; j < coded_bands; j++) {
    int n0 = eb[j + 1] - eb[j];
    int n = n0 << LM;
    int bit = bits[j] + balance;
    int excess = 0;
    if (n > 1) {
      excess = std::max(bit - cap[j], 0);
      bits[j] = bit - excess;
      int den = C * n;
      if (C == 2 && n > 2 && dual_stereo == 0 && j < intensity) den++;
      int nclogn = den * ((int)kLogN[j] + log_m);
      int offset = (nclogn >> 1) - den * FINE_OFFSET;
      if (n == 2) offset += den << (BITRES - 2);
      if (bits[j] + offset < (den * 2) << BITRES)
        offset += nclogn >> 2;
      else if (bits[j] + offset < (den * 3) << BITRES)
        offset += nclogn >> 3;
      int ebv = std::max(0, bits[j] + offset + (den << (BITRES - 1)));
      ebv = ((uint32_t)ebv / den) >> BITRES;
      if (C * ebv > (bits[j] >> BITRES)) ebv = bits[j] >> stereo >> BITRES;
      ebv = std::min(ebv, MAX_FINE_BITS);
      out->fine_priority[j] = ebv * (den << BITRES) >= bits[j] + offset;
      bits[j] -= (C * ebv) << BITRES;
      out->ebits[j] = ebv;
    } else {
      excess = std::max(0, bit - (C << BITRES));
      bits[j] = bit - excess;
      out->ebits[j] = 0;
      out->fine_priority[j] = 1;
    }
    if (excess > 0) {
      int extra_fine =
          std::min(excess >> (stereo + BITRES), MAX_FINE_BITS - out->ebits[j]);
      out->ebits[j] += extra_fine;
      int extra_bits = (extra_fine * C) << BITRES;
      out->fine_priority[j] = extra_bits >= excess - balance;
      excess -= extra_bits;
    }
    balance = excess;
    out->pulses[j] = bits[j];
  }
  for (int j = coded_bands; j < end; j++) {
    out->ebits[j] = bits[j] >> stereo >> BITRES;
    out->pulses[j] = 0;
    out->fine_priority[j] = out->ebits[j] < 1;
  }
  out->coded_bands = coded_bands;
  out->balance = balance;
  out->intensity = intensity;
  out->dual_stereo = dual_stereo;
}

void enc_clt_compute_allocation(int start, int end, const int* offsets,
                                const int* cap, int alloc_trim, int intensity,
                                int dual_stereo, int total, int C, int LM,
                                EcEnc* enc, int prev, int signal_bandwidth,
                                Alloc* out) {
  const int16_t* eb = kEBands;
  total = std::max(total, 0);
  int skip_start = start;
  int skip_rsv = 0;
  if (total >= 1 << BITRES) {
    skip_rsv = 1 << BITRES;
    total -= skip_rsv;
  }
  int intensity_rsv = 0, dual_stereo_rsv = 0;
  if (C == 2) {
    int cand = kLog2FracTable[end - start];
    if (cand <= total) {
      intensity_rsv = cand;
      total -= cand;
      if (total >= 1 << BITRES) {
        dual_stereo_rsv = 1 << BITRES;
        total -= dual_stereo_rsv;
      }
    }
  }
  int thresh[NB], trim_offset[NB];
  for (int j = start; j < end; j++) {
    int n = eb[j + 1] - eb[j];
    thresh[j] = std::max(C << BITRES, (3 * n) << (LM + BITRES) >> 4);
    trim_offset[j] = (C * n * (alloc_trim - 5 - LM) * (end - j - 1) *
                      (1 << (LM + BITRES))) >>
                     6;
    if ((n << LM) == 1) trim_offset[j] -= C << BITRES;
  }
  int lo = 1, hi = 11 - 1;
  while (lo <= hi) {
    int mid = (lo + hi) >> 1;
    int psum = 0, done = 0;
    for (int j = end - 1; j >= start; j--) {
      int n = eb[j + 1] - eb[j];
      int bitsj = (C * n * kAllocVectors[mid * NB + j]) << LM >> 2;
      if (bitsj > 0) bitsj = std::max(0, bitsj + trim_offset[j]);
      bitsj += offsets[j];
      if (bitsj >= thresh[j] || done) {
        done = 1;
        psum += std::min(bitsj, cap[j]);
      } else if (bitsj >= C << BITRES) {
        psum += C << BITRES;
      }
    }
    if (psum > total)
      hi = mid - 1;
    else
      lo = mid + 1;
  }
  hi = lo;
  lo -= 1;
  int bits1[NB] = {0}, bits2[NB] = {0};
  for (int j = start; j < end; j++) {
    int n = eb[j + 1] - eb[j];
    int b1 = (C * n * kAllocVectors[lo * NB + j]) << LM >> 2;
    int b2 =
        hi >= 11 ? cap[j] : (C * n * kAllocVectors[hi * NB + j]) << LM >> 2;
    if (b1 > 0) b1 = std::max(0, b1 + trim_offset[j]);
    if (b2 > 0) b2 = std::max(0, b2 + trim_offset[j]);
    if (lo > 0) b1 += offsets[j];
    b2 += offsets[j];
    if (offsets[j] > 0) skip_start = j;
    bits1[j] = b1;
    bits2[j] = std::max(0, b2 - b1);
  }
  enc_interp_bits2pulses(start, end, skip_start, bits1, bits2, thresh, cap,
                         total, skip_rsv, intensity, intensity_rsv,
                         dual_stereo, dual_stereo_rsv, C, LM, enc, prev,
                         signal_bandwidth, out);
}

}  // namespace

// ----------------------------------------------- encoder top level
namespace {

// One frame, symbol layer only (encoder.py encode_with_ec:120, precomputed
// path). freq: (C, N) float32 MDCT spectrum from the device front end.
// Returns nbytes on success, -1 on error.
int celt_enc_encode_one(CeltEncHost* st, const float* freq, int frame_size,
                        int silence_in, int pf_on_in, int pitch_index_in,
                        int qg_in, int transient_in, double tone_freq,
                        double toneishness, double tf_estimate, int nbytes,
                        uint8_t* out) {
  const int start = 0, end = NB;
  int C = st->channels;
  int LM = -1;
  for (int lm = 0; lm <= kMaxLM; lm++)
    if (kShortMdctSize << lm == frame_size) LM = lm;
  if (LM < 0 || nbytes < 2 || nbytes > EC_MAX_BYTES) return -1;
  int M = 1 << LM;
  int N = M * kShortMdctSize;
  int eff_end = end;

  EcEnc enc_s;
  EcEnc* enc = &enc_s;
  ec_enc_init(enc, (uint32_t)nbytes);
  int tell = 1;
  int total_bits = nbytes * 8;
  int effective_bytes = nbytes;

  // silence
  int silence = silence_in ? 1 : 0;
  ec_enc_bit_logp(enc, silence, 15);
  if (silence) enc->nbits_total += total_bits - ec_enc_tell(enc);

  // prefilter flags (decision + application happened on device)
  int pf_on = 0, pitch_index = 15, qg = 0;
  int prefilter_tapset = st->tapset_decision;
  bool enabled = start == 0 && !silence &&
                 ec_enc_tell(enc) + 16 <= total_bits && st->complexity >= 5 &&
                 nbytes > 12;
  if (enabled && pf_on_in) {
    pf_on = 1;
    pitch_index = pitch_index_in;
    qg = qg_in;
  }
  if (start == 0 && !silence && ec_enc_tell(enc) + 16 <= total_bits) {
    ec_enc_bit_logp(enc, pf_on, 1);
    if (pf_on) {
      int octave = std::max(0, ec_ilog((uint32_t)(pitch_index + 1)) - 5);
      ec_enc_uint(enc, (uint32_t)octave, 6);
      ec_enc_bits(enc, (uint32_t)(pitch_index + 1 - (16 << octave)),
                  4 + octave);
      ec_enc_bits(enc, (uint32_t)qg, 3);
      if (ec_enc_tell(enc) + 2 <= total_bits)
        ec_enc_icdf(enc, prefilter_tapset, kTapsetICDF, 2);
    }
  }

  // transient
  int is_transient = 0;
  if (LM > 0 && ec_enc_tell(enc) + 3 <= total_bits && !silence) {
    is_transient = transient_in ? 1 : 0;
    ec_enc_bit_logp(enc, is_transient, 3);
  }
  int short_blocks = is_transient ? M : 0;

  // energies + normalisation (ops_float.py)
  static thread_local double Xbuf[2 * MAX_N];
  double band_e[2 * NB] = {0};
  double band_log_e[2 * NB];
  for (int c = 0; c < C; c++) {
    for (int i = 0; i < eff_end; i++) {
      double acc = 0.0;
      for (int j = M * kEBands[i]; j < M * kEBands[i + 1]; j++) {
        double v = (double)freq[c * N + j];
        acc += v * v;
      }
      band_e[c * NB + i] = sqrt(1e-27 + acc);
    }
  }
  for (int c = 0; c < 2; c++)
    for (int i = 0; i < NB; i++)
      band_log_e[c * NB + i] =
          c < C && i < eff_end
              ? std::log2(band_e[c * NB + i]) - kEMeansD[i]
              : -14.0;
  for (int c = 0; c < C; c++)
    for (int i = 0; i < eff_end; i++) {
      double inv = 1.0 / (1e-27 + band_e[c * NB + i]);
      for (int j = M * kEBands[i]; j < M * kEBands[i + 1]; j++)
        Xbuf[c * N + j] = (double)freq[c * N + j] * inv;
    }

  // coarse energy
  double old_be_prev[2 * NB];
  memcpy(old_be_prev, st->old_band_e, sizeof(old_be_prev));
  double error[2 * NB] = {0};
  enc_quant_coarse_energy(st, enc, band_log_e, error, total_bits, C, LM,
                          eff_end, effective_bytes, st->complexity >= 4,
                          start, end);

  // dynalloc analysis
  int want[NB], importance[NB], spread_weight[NB];
  enc_dynalloc_analysis(st, band_log_e, old_be_prev, C, LM, effective_bytes,
                        is_transient != 0, tone_freq, toneishness, want,
                        importance, spread_weight, start, end, false);

  // tf
  int tf_res[NB];
  int tf_sel = 0;
  if (start == 0 && effective_bytes >= 15 * C && st->complexity >= 2) {
    int lam = std::max(80, 20480 / std::max(1, effective_bytes) + 2);
    tf_sel = enc_tf_analysis(eff_end, is_transient != 0, lam, Xbuf, LM,
                             tf_estimate, importance, tf_res);
    for (int i = eff_end; i < NB; i++) tf_res[i] = tf_res[eff_end - 1];
  } else {
    for (int i = 0; i < NB; i++) tf_res[i] = is_transient ? 1 : 0;
  }
  enc_tf_encode(enc, is_transient != 0, tf_res, LM, tf_sel, total_bits, start,
                end);

  // spread
  if (ec_enc_tell(enc) + 4 <= total_bits) {
    if (st->complexity == 0 || silence)
      st->spread_decision = SPREAD_NONE;
    else if (short_blocks || st->complexity < 3 ||
             effective_bytes < 10 * C)
      st->spread_decision = SPREAD_NORMAL;
    else
      st->spread_decision = enc_spreading_decision(
          st, Xbuf, eff_end, C, M, spread_weight,
          pf_on && !short_blocks, N);
    ec_enc_icdf(enc, st->spread_decision, kSpreadICDF, 5);
  }

  // dynalloc flag chains
  int cap[NB];
  init_caps(cap, LM, C);
  int offsets[NB] = {0};
  int dynalloc_logp = 6;
  int total_bits_q3 = total_bits << BITRES;
  int tell_frac = ec_enc_tell_frac(enc);
  for (int i = start; i < end; i++) {
    int width = C * (kEBands[i + 1] - kEBands[i]) << LM;
    int quanta = std::min(width << BITRES, std::max(6 << BITRES, width));
    int dynalloc_loop_logp = dynalloc_logp;
    int boost = 0;
    int j = 0;
    while (tell_frac + (dynalloc_loop_logp << BITRES) < total_bits_q3 &&
           boost < cap[i]) {
      int flag = j < want[i] ? 1 : 0;
      ec_enc_bit_logp(enc, flag, dynalloc_loop_logp);
      tell_frac = ec_enc_tell_frac(enc);
      if (!flag) break;
      boost += quanta;
      total_bits_q3 -= quanta;
      dynalloc_loop_logp = 1;
      j++;
    }
    offsets[i] = boost;
    if (boost) dynalloc_logp = std::max(2, dynalloc_logp - 1);
  }

  // trim (always the conservative mid value, encoder.py:997)
  int alloc_trim = 5;
  if (ec_enc_tell_frac(enc) + (6 << BITRES) <= total_bits_q3)
    ec_enc_icdf(enc, alloc_trim, kTrimICDF, 7);

  // allocation
  int bits = ((nbytes * 8) << BITRES) - ec_enc_tell_frac(enc) - 1;
  int anti_collapse_rsv =
      (is_transient && LM >= 2 && bits >= (LM + 2) << BITRES) ? (1 << BITRES)
                                                              : 0;
  bits -= anti_collapse_rsv;

  int intensity = end, dual_stereo = 0;
  if (C == 2) {
    int base_rate = nbytes * 8 * 50;
    int shift = 3 - LM;
    int equiv_rate = shift >= 0 ? base_rate << shift : base_rate >> -shift;
    equiv_rate -= (40 * C + 20) * ((400 >> LM) - 50);
    intensity = hysteresis_decision(equiv_rate / 1000.0,
                                    kIntensityThresholds,
                                    kIntensityHysteresis, 21, st->intensity);
    intensity = std::min(end, std::max(start, intensity));
    st->intensity = intensity;
    if (LM != 0) dual_stereo = enc_stereo_analysis(Xbuf, LM, N, N) ? 1 : 0;
  }
  int signal_bandwidth = end - 1;
  Alloc alloc;
  enc_clt_compute_allocation(start, end, offsets, cap, alloc_trim, intensity,
                             dual_stereo, bits, C, LM, enc,
                             st->last_coded_bands, signal_bandwidth, &alloc);
  int coded_bands = alloc.coded_bands;
  if (st->last_coded_bands)
    st->last_coded_bands =
        std::min(st->last_coded_bands + 1,
                 std::max(st->last_coded_bands - 1, coded_bands));
  else
    st->last_coded_bands = coded_bands;

  enc_quant_fine_energy(st, enc, error, alloc.ebits, C, start, end);

  // PVQ band encode
  uint8_t collapse_masks[2 * NB] = {0};
  enc_quant_all_bands(start, end, Xbuf, C == 2 ? Xbuf + N : nullptr,
                      collapse_masks, band_e, alloc.pulses, short_blocks != 0,
                      st->spread_decision, alloc.dual_stereo, alloc.intensity,
                      tf_res, nbytes * (8 << BITRES) - anti_collapse_rsv,
                      alloc.balance, enc, LM, coded_bands, st->rng,
                      st->disable_inv != 0);

  if (anti_collapse_rsv > 0) {
    int anti_collapse_on = st->consec_transient < 2 ? 1 : 0;
    ec_enc_bits(enc, (uint32_t)anti_collapse_on, 1);
  }

  enc_quant_energy_finalise(st, enc, error, alloc.ebits, alloc.fine_priority,
                            nbytes * 8 - ec_enc_tell(enc), C, start, end);
  memset(st->energy_error, 0, sizeof(st->energy_error));
  for (int c = 0; c < C; c++)
    for (int i = start; i < end; i++)
      st->energy_error[c * NB + i] =
          std::max(-0.5, std::min(0.5, error[c * NB + i]));

  if (silence)
    for (int i = 0; i < 2 * NB; i++) st->old_band_e[i] = -28.0;

  // state updates (decoder bookkeeping parity, encoder.py:485)
  if (C == 1)
    for (int i = 0; i < NB; i++) st->old_band_e[NB + i] = st->old_band_e[i];
  if (!is_transient) {
    memcpy(st->old_log_e2, st->old_log_e, sizeof(st->old_log_e2));
    memcpy(st->old_log_e, st->old_band_e, sizeof(st->old_log_e));
  } else {
    for (int i = 0; i < 2 * NB; i++)
      st->old_log_e[i] = std::min(st->old_log_e[i], st->old_band_e[i]);
  }
  st->consec_transient = is_transient ? st->consec_transient + 1 : 0;
  st->rng = enc->rng;

  if (ec_enc_tell(enc) > 8 * nbytes) return -1;
  ec_enc_done(enc);
  if (enc->error) return -1;
  memcpy(out, enc->buf, nbytes);
  (void)tell;
  return nbytes;
}

}  // namespace

extern "C" {

void* celt_enc_host_create(int channels, int complexity, int disable_inv) {
  if (channels < 1 || channels > 2) return nullptr;
  build_u_table();
  build_b2p_table();
  build_recip_table();
  build_ftdiv_table();
  build_tellfrac_table();
  CeltEncHost* st = new CeltEncHost();
  st->channels = channels;
  st->complexity = complexity;
  st->disable_inv = disable_inv;
  st->lsb_depth = 24;
  celt_enc_reset_impl(st);
  return st;
}

void celt_enc_host_destroy(void* p) { delete (CeltEncHost*)p; }
void celt_enc_host_reset(void* p) { celt_enc_reset_impl((CeltEncHost*)p); }
int celt_enc_host_tapset(void* p) {
  return ((CeltEncHost*)p)->tapset_decision;
}

int celt_enc_host_encode(void* p, const float* freq, int frame_size,
                         const int32_t* iparams, const float* fparams,
                         int nbytes, uint8_t* out) {
  // iparams: silence, pf_on, pitch_index, qg, is_transient
  // fparams: tone_freq, toneishness, tf_estimate
  return celt_enc_encode_one((CeltEncHost*)p, freq, frame_size, iparams[0],
                             iparams[1], iparams[2], iparams[3], iparams[4],
                             fparams[0], fparams[1], fparams[2], nbytes, out);
}

// Batched symbol encode: S streams, one thread pool. freq is (S, C, N)
// float32; iparams (S, 6) int32 rows [silence, pf_on, pitch_index, qg,
// is_transient, nbytes]; fparams (S, 3) float32 rows [tone_freq,
// toneishness, tf_estimate]. out is (S, max_bytes); out_lens[s] receives
// the packet length or -1.
void celt_enc_host_encode_batch(void** states, const float* freq,
                                const int32_t* iparams, const float* fparams,
                                int S, int C, int frame_size, int max_bytes,
                                uint8_t* out, int32_t* out_lens,
                                int n_threads) {
  int N = frame_size;
  if (n_threads <= 0) {
    n_threads = (int)std::thread::hardware_concurrency();
    if (n_threads <= 0) n_threads = 1;
  }
  n_threads = std::min(n_threads, S);
  std::atomic<int> next(0);
  auto worker = [&]() {
    for (;;) {
      int s = next.fetch_add(1);
      if (s >= S) break;
      int nbytes = iparams[s * 6 + 5];
      if (nbytes > max_bytes) nbytes = max_bytes;
      out_lens[s] = celt_enc_encode_one(
          (CeltEncHost*)states[s], freq + (size_t)s * C * N, frame_size,
          iparams[s * 6 + 0], iparams[s * 6 + 1], iparams[s * 6 + 2],
          iparams[s * 6 + 3], iparams[s * 6 + 4], fparams[s * 3 + 0],
          fparams[s * 3 + 1], fparams[s * 3 + 2], nbytes,
          out + (size_t)s * max_bytes);
    }
  };
  if (n_threads == 1) {
    worker();
    return;
  }
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; t++) pool.emplace_back(worker);
  for (auto& th : pool) th.join();
}

}  // extern "C"
