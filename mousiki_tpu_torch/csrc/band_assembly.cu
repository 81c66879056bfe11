// The band assembly of the CELT band-plan executor (stage P3 of
// ops/band_exec.execute_packed) for Hopper (sm_90a): band_assembly_kernel.
//
// For each stream and each band start..end-1, and each channel slot: the
// fold source gathered from the norm buffers (with the special-hybrid-
// folding duplicate and the lowband blend), the per-call pre operator, the
// fold / noise fills (LCG), the post operator, the n_b = 1 sign path, the
// norm-buffer writes, the N = 2 stereo butterfly and the stereo merge; the
// band is written back into the X plane.
//
// Replaces a loop that XLA compiled in the reference, which has no Pallas
// kernel: the P3 band_body lax.scan over the 21 bands of
// band_exec_jax.execute_packed (mousiki_tpu/ops/band_exec_jax.py:514, scan
// :643). Its plain version, ops/band_assembly.band_assembly_reference, is
// that loop in eager PyTorch.
//
// Planes as the executor holds them (ops/band_exec._normalize_plan): flags
// bool, integers and u32 values int64, gains float32; (S, 21, 2) a call,
// (S, 21) a band, (S, 21, 2, F) a fill slot, (S, 21, 2, 3) the duplicate
// window; each plane's trailing dimensions contiguous, its streams any
// stride apart (the arena's planes are views). X is (S, C * frame)
// float64; the bins of bands start..end-1 are read and written once, the
// rest of X is left as it is. The operators are the reference's float32
// values packed by ops/band_assembly.packed_operators as their nonzeros,
// pre and post apart: row m of band i's combo c is packed row
// row_off[i] + c * n_b + m, kNz (column, value) pairs in column order,
// padded with (0, 0.0) (uint8 columns, float32 values).
//
// What bounds it: neither bytes nor operations but the latency of one
// stream's chain. A block takes a stream, two blocks share an SM (at most
// 64 registers a thread), so 256 streams run in one wave and the slowest
// block is the launch's time, about the same at S = 3. The reference's
// scan runs the 21 bands one after another, but a band depends on an
// earlier one only through a live fold fill, whose source window reads
// the norm buffers the bands before it wrote; noise fills, the n1 path,
// the products, the butterfly and the merge read the band's own bins. And
// the operators are haar butterflies and Hadamard permutations: no row
// holds more than 8 nonzeros (at LM 3 the blocks hold 25x more entries
// than nonzeros). So the design follows those dependences, in stages a
// barrier apart:
//
//   A. the stream's planes staged in shared memory (a thread issues all
//      its loads before it stores any), X's bins read into the filled-band
//      buffer, the live noise windows listed and the calls with a live
//      fold fill marked by warp ballots;
//   B. the schedule on warp 0: a band goes to the ordered pass when it has
//      a live fold fill, or when an earlier band with one reads a norm or
//      norm2 position this band writes (the source window after the
//      clamps, which holds the duplicate and the blend), every other band
//      to the parallel pass; the noise windows, a warp each;
//   C. the parallel pass: every position of its bands at once, a thread a
//      position (its packed row's at most kNz loads and float64 fmas), and
//      the norm writes;
//   D. the ordered pass: the other bands in band order, each on the whole
//      block (fold source, pre product, fold windows, post product), its
//      rows' loads issued first. On the golden frames it holds 0-3 bands
//      of a stream;
//   E. each stereo band's merge or butterfly on a warp (its sums warp
//      sums), and X.
//
// The parallel pass writes nothing an ordered band reads before the
// ordered band runs (norm regions of bands are disjoint), so each band's
// arithmetic is the same whatever the split. A stream's value never
// depends on S or on the other streams (no sum across streams). On an
// H100 (clock probes at the barriers) a block's chain is the staging of
// the planes, the schedule and the products, a few thousand cycles each,
// then about 4,000 cycles an ordered band: chains of dependent shared-
// memory reads and L2 loads, not bandwidth.
//
// Arithmetic is the plain version's, in float64: f32 planes widened
// exactly, the merge's mid * mid rounded in float32 as the plain version
// rounds it, elementwise operations one rounding each (no contraction).
// The products (fmas in column order) and sums run in their own order:
// they differ from the plain version's by float64 round-off.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBands = 21;
// fill slots a call: the lockstep plan emission's 8 (the host's plan
// profiles give at most 4)
constexpr int kMaxFill = 8;
// (column, value) pairs a packed operator row
constexpr int kNz = 8;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr uint32_t kLcgA = 1664525u;
constexpr uint32_t kLcgC = 1013904223u;

}  // namespace

// One plan plane: its device pointer and the elements from one stream's
// row to the next (the row itself contiguous).
template <typename T>
struct Plane {
  const T* data;
  int64_t stride;
  __device__ const T* row(int s) const { return data + s * stride; }
};

// The plan planes the kernel reads, in the order of the wrapper's PLANES.
struct BandPlanes {
  Plane<bool> call_active;
  Plane<bool> call_norm_write;
  Plane<int64_t> call_lb_src;
  Plane<int64_t> call_lb_buf;
  Plane<int64_t> call_blend_upto;
  Plane<int64_t> call_pre;
  Plane<int64_t> call_post;
  Plane<int64_t> call_norm_buf;
  Plane<int64_t> call_dup;
  Plane<bool> fill_active;
  Plane<bool> fill_fold;
  Plane<int64_t> fill_off;
  Plane<int64_t> fill_n;
  Plane<float> fill_gain;
  Plane<int64_t> fill_seed;
  Plane<bool> merge_active;
  Plane<bool> merge_inv;
  Plane<float> merge_mid;
  Plane<bool> theta2_active;
  Plane<bool> theta2_cswap;
  Plane<bool> theta2_inv;
  Plane<float> theta2_sign;
  Plane<float> theta2_mid;
  Plane<float> theta2_side;
  Plane<bool> n1_active;
  Plane<float> n1_val;
};

// Per-band constants of one (lm, start) from the host: width, offset in a
// channel's frame, norm-buffer write offset (-1: no write), first packed
// operator row, and the norm write's scale (float32 sqrt(n_b)).
struct BandTable {
  int n[kBands];
  int boff[kBands];
  int nwoff[kBands];
  int row_off[kBands];
  double scale[kBands];
};

// One packed operator stack (pre or post): rows of kNz pairs.
struct Ops {
  const uint8_t* cols;
  const float* vals;
};

namespace {

// lcg^k(seed) mod 2^32, the affine map raised by squaring.
__device__ uint32_t lcg_pow(uint32_t seed, int k) {
  uint32_t ra = 1u, rc = 0u, ba = kLcgA, bc = kLcgC;
  while (k) {
    if (k & 1) {
      rc = ba * rc + bc;
      ra = ba * ra;
    }
    bc = ba * bc + bc;
    ba = ba * ba;
    k >>= 1;
  }
  return ra * seed + rc;
}

__device__ double warp_sum(double v) {
  for (int off = 16; off > 0; off >>= 1)
    v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// a combo index inside the stack (a valid plan holds no other)
__device__ int combo(int64_t c, int nc) {
  return c < 0 ? 0 : c >= nc ? nc - 1 : static_cast<int>(c);
}

// One packed operator row: its kNz columns (8 bytes) and values.
struct OpRow {
  uint2 cols;
  float4 v0, v1;
};

// Row `row` of a packed operator: three loads (8 + 16 + 16 bytes).
__device__ OpRow load_row(const Ops& op, int row) {
  OpRow o;
  o.cols = __ldg(reinterpret_cast<const uint2*>(op.cols) + row);
  const float4* vp = reinterpret_cast<const float4*>(op.vals) + 2 * row;
  o.v0 = __ldg(vp);
  o.v1 = __ldg(vp + 1);
  return o;
}

// The row times x: its kNz pairs in column order, one fma each (a pad
// pair (0, 0.0) adds nothing).
__device__ double row_dot(const OpRow& o, const double* x) {
  const float v[kNz] = {o.v0.x, o.v0.y, o.v0.z, o.v0.w,
                        o.v1.x, o.v1.y, o.v1.z, o.v1.w};
  double acc = 0.0;
#pragma unroll
  for (int k = 0; k < kNz; ++k) {
    const int col = ((k < 4 ? o.cols.x : o.cols.y) >> (8 * (k & 3))) & 0xff;
    acc = __fma_rn(static_cast<double>(v[k]), x[col], acc);
  }
  return acc;
}

constexpr int kFills = 2 * kBands * kMaxFill;
constexpr int kFillWarps = (kFills + 31) / 32;

// One stream's plan planes, staged in shared memory at the start. A call
// is c = 2 i + slot, a fill slot c * kMaxFill + w; the int64 planes hold
// values that fit 32 bits (int16 offsets, u8 combos, u32 seeds). Beside
// them: `fold`, a call of bands start..end-1 with a live fold fill, and
// the live noise windows, listed by the warp that staged them
// (noise[32 w + k], k < noise_count[w]).
struct Row {
  int32_t lb_src[2 * kBands], lb_buf[2 * kBands], blend_upto[2 * kBands];
  int32_t pre[2 * kBands], post[2 * kBands], norm_buf[2 * kBands];
  int32_t dup[2 * kBands * 3];
  int32_t fill_off[kFills], fill_n[kFills];
  uint32_t fill_seed[kFills];
  float fill_gain[kFills], n1_val[2 * kBands];
  float merge_mid[kBands], t2_sign[kBands], t2_mid[kBands], t2_side[kBands];
  uint16_t noise[kFillWarps * 32];
  uint8_t noise_count[kFillWarps];
  bool active[2 * kBands], norm_write[2 * kBands], n1_active[2 * kBands];
  bool fold[2 * kBands];
  bool fill_active[kFills], fill_fold[kFills];
  bool merge_active[kBands], merge_inv[kBands], t2_active[kBands];
  bool t2_cswap[kBands], t2_inv[kBands];
};

// The planes into `r` and the band table into `t`, the loads spread over
// the block: a thread a fill slot, a call, a band or a table entry, each
// issuing all its loads before it stores any (a store between two loads
// would keep the second waiting on the first). A fill slot's thread also
// decides whether it is a live window of the bands start..end-1 (active,
// on an active call of a band wider than one bin); the warp's ballots
// list the live noise windows and mark the calls with a live fold one.
__device__ void stage_row(Row& r, BandTable& t, const BandPlanes& P,
                          const BandTable& T, int s, int nc, int F,
                          int channels, int start, int end, int tid) {
  constexpr int kCalls = kFills + 2 * kBands;
  constexpr int kBandRows = kCalls + kBands;
  bool noise = false, live_fold = false;
  if (tid < kFills) {
    const int c = tid / kMaxFill, w = tid - c * kMaxFill;
    const int i = c / 2;
    const int g = c * F + w;
    int64_t off = 0, n = 0, seed = 0;
    float gain = 0.f;
    bool active = false, fold = false, call = false;
    if (w < F) {
      off = P.fill_off.row(s)[g];
      n = P.fill_n.row(s)[g];
      seed = P.fill_seed.row(s)[g];
      gain = P.fill_gain.row(s)[g];
      active = P.fill_active.row(s)[g];
      fold = P.fill_fold.row(s)[g];
      call = P.call_active.row(s)[c];
    }
    r.fill_off[tid] = static_cast<int32_t>(off);
    r.fill_n[tid] = static_cast<int32_t>(n);
    r.fill_seed[tid] = static_cast<uint32_t>(seed);
    r.fill_gain[tid] = gain;
    r.fill_active[tid] = active;
    r.fill_fold[tid] = fold;
    const bool live = active && call && i >= start && i < end &&
                      (c & 1) < channels && T.n[i] > 1;
    noise = live && !fold;
    live_fold = live && fold;
  } else if (tid < kCalls) {
    const int c = tid - kFills;
    const int64_t lb_src = P.call_lb_src.row(s)[c];
    const int64_t lb_buf = P.call_lb_buf.row(s)[c];
    const int64_t blend = P.call_blend_upto.row(s)[c];
    const int64_t pre = P.call_pre.row(s)[c];
    const int64_t post = P.call_post.row(s)[c];
    const int64_t nbuf = P.call_norm_buf.row(s)[c];
    const int64_t d0 = P.call_dup.row(s)[3 * c];
    const int64_t d1 = P.call_dup.row(s)[3 * c + 1];
    const int64_t d2 = P.call_dup.row(s)[3 * c + 2];
    const float n1_val = P.n1_val.row(s)[c];
    const bool active = P.call_active.row(s)[c];
    const bool norm_write = P.call_norm_write.row(s)[c];
    const bool n1_active = P.n1_active.row(s)[c];
    r.lb_src[c] = static_cast<int32_t>(lb_src);
    r.lb_buf[c] = static_cast<int32_t>(lb_buf);
    r.blend_upto[c] = static_cast<int32_t>(blend);
    r.pre[c] = combo(pre, nc);
    r.post[c] = combo(post, nc);
    r.norm_buf[c] = static_cast<int32_t>(nbuf);
    r.dup[3 * c] = static_cast<int32_t>(d0);
    r.dup[3 * c + 1] = static_cast<int32_t>(d1);
    r.dup[3 * c + 2] = static_cast<int32_t>(d2);
    r.n1_val[c] = n1_val;
    r.active[c] = active;
    r.norm_write[c] = norm_write;
    r.n1_active[c] = n1_active;
  } else if (tid < kBandRows) {
    const int i = tid - kCalls;
    const float mid = P.merge_mid.row(s)[i];
    const float sign = P.theta2_sign.row(s)[i];
    const float t2_mid = P.theta2_mid.row(s)[i];
    const float side = P.theta2_side.row(s)[i];
    const bool ma = P.merge_active.row(s)[i];
    const bool inv = P.merge_inv.row(s)[i];
    const bool t2 = P.theta2_active.row(s)[i];
    const bool cswap = P.theta2_cswap.row(s)[i];
    const bool t2_inv = P.theta2_inv.row(s)[i];
    r.merge_mid[i] = mid;
    r.t2_sign[i] = sign;
    r.t2_mid[i] = t2_mid;
    r.t2_side[i] = side;
    r.merge_active[i] = ma;
    r.merge_inv[i] = inv;
    r.t2_active[i] = t2;
    r.t2_cswap[i] = cswap;
    r.t2_inv[i] = t2_inv;
  } else if (tid < kBandRows + kBands) {
    const int i = tid - kBandRows;
    t.n[i] = T.n[i];
    t.boff[i] = T.boff[i];
    t.nwoff[i] = T.nwoff[i];
    t.row_off[i] = T.row_off[i];
    t.scale[i] = T.scale[i];
  }
  // a warp holds the fill slots of four calls, kMaxFill lanes each
  const unsigned nm = __ballot_sync(0xffffffffu, noise);
  const unsigned fm = __ballot_sync(0xffffffffu, live_fold);
  const int lane = tid % 32, w = tid / 32;
  if (noise) r.noise[32 * w + __popc(nm & ((1u << lane) - 1u))] = tid;
  if (tid < kFills) {
    if (lane == 0) r.noise_count[w] = static_cast<uint8_t>(__popc(nm));
    if (tid % kMaxFill == 0)
      r.fold[tid / kMaxFill] = (fm >> lane & ((1u << kMaxFill) - 1u)) != 0;
  }
}

// One live fill window on one warp: out[p] for p in [off, off + n) inside
// the band, folded from src (+-1/256 by the LCG's bit 15) or noise (the
// LCG's top 12 bits), scaled to `gain` over the window's energy (a warp
// sum). Windows do not overlap, so a covered position takes its window's
// value.
__device__ void fill_window(const Row& r, int fw, double* out,
                            const double* src, int nb, int lane) {
  const int off = r.fill_off[fw], n = r.fill_n[fw];
  const uint32_t seed0 = r.fill_seed[fw];
  const bool fold = r.fill_fold[fw];
  double e = 0.0;
  for (int d = lane; d < n; d += 32) {
    const int p = off + d;
    if (p < 0 || p >= nb) continue;
    const uint32_t seed = lcg_pow(seed0, d + 1);
    double v;
    if (fold)
      v = (seed & 0x8000u) ? __dadd_rn(src[p], 1.0 / 256)
                           : __dsub_rn(src[p], 1.0 / 256);
    else
      v = static_cast<double>(static_cast<int32_t>(seed) >> 20);
    out[p] = v;
    e = __fma_rn(v, v, e);
  }
  const double E = __dadd_rn(1e-15, warp_sum(e));
  const double g = __ddiv_rn(static_cast<double>(r.fill_gain[fw]),
                             __dsqrt_rn(E));
  for (int d = lane; d < n; d += 32) {
    const int p = off + d;
    if (p >= 0 && p < nb) out[p] = __dmul_rn(out[p], g);
  }
}

// What every stage of a band needs: the stream's shared buffers, its X row
// in device memory and the geometry.
struct Ctx {
  const Row* r;
  const BandTable* t;
  double* xg;                 // the stream's X row (device memory)
  double *norm, *norm2;       // (npad) each
  double *sl, *bx;            // (channels, width): filled band, products
  int channels, frame, lo, width;
};

// Position p of call (i, slot): the post product (`o`, row p of the
// call's combo) or the n1 sign path, the norm write, and X where no merge
// or butterfly follows.
__device__ void post_item(const Ctx& k, int i, int slot, int p,
                          const OpRow& o) {
  const Row& r = *k.r;
  const int nb = k.t->n[i], c = 2 * i + slot;
  const int at = slot * k.width + k.t->boff[i] - k.lo;   // band's first bin
  double v;
  if (nb == 1)
    v = r.n1_active[c] ? static_cast<double>(r.n1_val[c]) : k.sl[at];
  else
    v = row_dot(o, k.sl + at);
  // norm writes, slot 0 then slot 1: slot 0 leaves a position to slot 1
  // when both write the same buffer
  const int nwoff = k.t->nwoff[i];
  if (nwoff >= 0 && r.norm_write[c] && r.active[c]) {
    const int other = c ^ 1;
    const bool buf2 = r.norm_buf[c] == 1;
    const bool later = slot == 0 && k.channels == 2 && r.norm_write[other] &&
                       r.active[other] && (r.norm_buf[other] == 1) == buf2;
    if (!later)
      (buf2 ? k.norm2 : k.norm)[nwoff + p] = __dmul_rn(k.t->scale[i], v);
  }
  if (k.channels == 1 || nb == 1)
    k.xg[slot * k.frame + k.t->boff[i] + p] = v;
  else
    k.bx[at + p] = v;
}

// Band i of a stereo stream (n_b >= 2) on one warp, after its products:
// the N = 2 butterfly or the stereo merge, then X.
__device__ void finish_stereo(const Ctx& k, int i, int lane) {
  const Row& r = *k.r;
  const int nb = k.t->n[i], boff = k.t->boff[i];
  const double* b0 = k.bx + boff - k.lo;
  const double* b1 = b0 + k.width;
  double* x0g = k.xg + boff;
  double* x1g = x0g + k.frame;
  if (nb == 2) {
    if (lane != 0) return;
    double o00 = b0[0], o01 = b0[1], o10 = b1[0], o11 = b1[1];
    if (r.t2_active[i]) {
      const double sgn = static_cast<double>(r.t2_sign[i]);
      double nx0, nx1, ny0, ny1;
      if (r.t2_cswap[i]) {
        nx0 = __dmul_rn(-sgn, o11);
        nx1 = __dmul_rn(sgn, o10);
        ny0 = o10;
        ny1 = o11;
      } else {
        nx0 = o00;
        nx1 = o01;
        ny0 = __dmul_rn(-sgn, o01);
        ny1 = __dmul_rn(sgn, o00);
      }
      const double mid = static_cast<double>(r.t2_mid[i]);
      const double side = static_cast<double>(r.t2_side[i]);
      nx0 = __dmul_rn(nx0, mid);
      nx1 = __dmul_rn(nx1, mid);
      ny0 = __dmul_rn(ny0, side);
      ny1 = __dmul_rn(ny1, side);
      const double sg = r.t2_inv[i] ? -1.0 : 1.0;
      o00 = __dsub_rn(nx0, ny0);
      o01 = __dsub_rn(nx1, ny1);
      o10 = sg * __dadd_rn(nx0, ny0);
      o11 = sg * __dadd_rn(nx1, ny1);
    }
    x0g[0] = o00;
    x0g[1] = o01;
    x1g[0] = o10;
    x1g[1] = o11;
    return;
  }
  // stereo merge: sum x0 x1 and sum x1^2 as warp sums
  double xp = 0.0, sd = 0.0;
  for (int p = lane; p < nb; p += 32) {
    const double a = b0[p], b = b1[p];
    xp = __fma_rn(a, b, xp);
    sd = __fma_rn(b, b, sd);
  }
  xp = warp_sum(xp);
  sd = warp_sum(sd);
  const bool ma = r.merge_active[i], inv = r.merge_inv[i];
  const float mid32 = r.merge_mid[i];
  const double mid = static_cast<double>(mid32);
  xp = __dmul_rn(xp, mid);
  const double mm = static_cast<double>(__fmul_rn(mid32, mid32));
  const double el = __dsub_rn(__dadd_rn(mm, sd), __dmul_rn(2.0, xp));
  const double er = __dadd_rn(__dadd_rn(mm, sd), __dmul_rn(2.0, xp));
  const bool degen = er < 6e-4 || el < 6e-4;
  const double lg = __ddiv_rn(1.0, __dsqrt_rn(el > 1e-20 ? el : 1e-20));
  const double rg = __ddiv_rn(1.0, __dsqrt_rn(er > 1e-20 ? er : 1e-20));
  for (int p = lane; p < nb; p += 32) {
    const double x0 = b0[p], x1 = b1[p];
    double o0 = x0, o1 = inv ? -x1 : x1;
    if (ma) {
      const double lpart = __dmul_rn(mid, x0);
      double mx = __dmul_rn(lg, __dsub_rn(lpart, x1));
      double my = __dmul_rn(rg, __dadd_rn(lpart, x1));
      if (degen) mx = my = x0;
      o0 = mx;
      o1 = inv ? -my : my;
    }
    x0g[p] = o0;
    x1g[p] = o1;
  }
}

// The schedule, on warp 0 once the planes are staged: a bit a band of the
// ordered pass (a live fold fill, or a norm write into the source window
// of an earlier band with one) and of the parallel pass (every other band
// of start..end-1).
__device__ void schedule(const Row& r, const BandTable& t, int channels,
                         int npad, int start, int end, int lane,
                         uint32_t* ordered, uint32_t* parallel) {
  const int i = lane;
  const bool run = i >= start && i < end;
  bool fold = false, writes = false;
  int rlo = npad, rhi = -1, wlo = 0, whi = -1;
  if (run) {
    const int nb = t.n[i];
    for (int slot = 0; slot < channels; ++slot) {
      const int c = 2 * i + slot;
      if (r.fold[c]) {
        fold = true;
        rlo = min(rlo, min(max(r.lb_src[c], 0), npad - 1));
        rhi = max(rhi, min(max(r.lb_src[c] + nb - 1, 0), npad - 1));
      }
      writes |= t.nwoff[i] >= 0 && r.norm_write[c] && r.active[c];
    }
    wlo = t.nwoff[i];
    whi = wlo + nb - 1;
  }
  bool ord = fold;
  for (uint32_t folds = __ballot_sync(0xffffffffu, fold); folds;
       folds &= folds - 1) {
    const int j = __ffs(folds) - 1;
    const int lj = __shfl_sync(0xffffffffu, rlo, j);
    const int hj = __shfl_sync(0xffffffffu, rhi, j);
    if (j < i && writes && lj <= whi && hj >= wlo) ord = true;
  }
  const uint32_t omask = __ballot_sync(0xffffffffu, run && ord);
  const uint32_t all = __ballot_sync(0xffffffffu, run);
  if (lane == 0) {
    *ordered = omask;
    *parallel = all & ~omask;
  }
}

// a thread's positions of the band range: q = tid + u * kThreads, u < kPer
constexpr int kPer = 4;

__global__ void __launch_bounds__(kThreads, 2)
band_assembly_kernel(const BandPlanes P, const BandTable T,
                     double* __restrict__ X, const Ops pre_ops,
                     const Ops post_ops, int nc, int channels, int frame,
                     int npad, int nbmax, int start, int end, int F) {
  extern __shared__ double sm[];
  __shared__ Row r;
  __shared__ BandTable t;
  __shared__ uint32_t ordered, parallel;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  // only the bins of bands start..end-1 are read and written
  const int lo = T.boff[start], width = T.boff[end - 1] + T.n[end - 1] - lo;
  const int total = channels * width;
  Ctx k;
  k.r = &r;
  k.t = &t;
  k.xg = X + static_cast<size_t>(s) * channels * frame;
  k.norm = sm;
  k.norm2 = k.norm + npad;
  k.sl = k.norm2 + npad;
  k.bx = k.sl + total;
  k.channels = channels;
  k.frame = frame;
  k.lo = lo;
  k.width = width;
  double* scr = k.bx + total;     // (2, nbmax) an ordered band's fold source
  double* pre = scr + 2 * nbmax;  // (2, nbmax) its pre products
  // a band index a bin of [lo, lo + width)
  uint8_t* band_of = reinterpret_cast<uint8_t*>(pre + 2 * nbmax);

  // ---- A: the planes staged, X's bins into sl (the fills overwrite
  // their windows later), the norm buffers zeroed
  {
    double v[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int q = tid + u * kThreads;
      if (q < total) {
        const int slot = q / width;
        v[u] = k.xg[slot * frame + lo + q - slot * width];
      }
    }
    stage_row(r, t, P, T, s, nc, F, channels, start, end, tid);
#pragma unroll
    for (int u = 0; u < kPer; ++u)
      if (tid + u * kThreads < total) k.sl[tid + u * kThreads] = v[u];
  }
  for (int q = tid; q < 2 * npad; q += kThreads) k.norm[q] = 0.0;
  __syncthreads();

  // ---- B: the schedule (warp 0); the band of each bin (a binary search
  // of the shared table); the live noise windows, a warp each (they read
  // nothing of other bands)
  if (warp == 0)
    schedule(r, t, channels, npad, start, end, lane, &ordered, &parallel);
  for (int b = tid; b < width; b += kThreads) {
    int first = start, last = end - 1;
    while (first < last) {
      const int mid = (first + last + 1) / 2;
      if (t.boff[mid] - lo <= b)
        first = mid;
      else
        last = mid - 1;
    }
    band_of[b] = static_cast<uint8_t>(first);
  }
  {
    int count[kFillWarps], live = 0;
#pragma unroll
    for (int w = 0; w < kFillWarps; ++w) {
      count[w] = r.noise_count[w];
      live += count[w];
    }
    for (int e = warp; e < live; e += kWarps) {
      int w = 0, rank = e;
      while (rank >= count[w]) rank -= count[w++];
      const int fw = r.noise[32 * w + rank];
      const int c = fw / kMaxFill, i = c / 2;
      fill_window(r, fw, k.sl + (c & 1) * width + t.boff[i] - lo, nullptr,
                  t.n[i], lane);
    }
  }
  __syncthreads();

  // ---- C: the parallel pass: products, norm writes, X where no merge or
  // butterfly follows (mono, n1 bands)
  const uint32_t pmask = parallel, omask = ordered;
#pragma unroll
  for (int u = 0; u < kPer; ++u) {
    const int q = tid + u * kThreads;
    if (q < total) {
      const int slot = q / width, b = q - slot * width;
      const int i = band_of[b];
      const int nb = t.n[i], p = b - (t.boff[i] - lo);
      if (pmask >> i & 1u)
        post_item(k, i, slot, p,
                  nb > 1 ? load_row(post_ops, t.row_off[i] +
                                                  r.post[2 * i + slot] * nb + p)
                         : OpRow{});
    }
  }
  __syncthreads();

  // ---- D: the ordered pass, in band order, each band on the whole block
  // (a thread a position: channels * nbmax <= kThreads), its operator
  // rows in flight from the start
  for (int i = start; i < end; ++i) {
    if (!(omask >> i & 1u)) continue;
    const int nb = t.n[i];
    const int c0 = 2 * i;
    const bool mine = tid < channels * nb;
    const int slot = tid / nb, p = tid - slot * nb, c = c0 + slot;
    OpRow pre_row, post_row;
    if (mine && nb > 1) {
      post_row = load_row(post_ops, t.row_off[i] + r.post[c] * nb + p);
      if (r.fold[c])
        pre_row = load_row(pre_ops, t.row_off[i] + r.pre[c] * nb + p);
    }
    if (r.fold[c0] || (channels == 2 && r.fold[c0 + 1])) {
      // fold source: norm / norm2 at lb_src + p, the duplicate window
      // reading the same gather at its source, the lowband blend
      if (mine && r.fold[c]) {
        const int src = r.lb_src[c];
        const int* dup = r.dup + 3 * c;
        const int g = src + p;
        int at = g;
        const int d_rel = p - dup[0];
        if (d_rel >= 0 && d_rel < dup[2])
          at = src + min(max(dup[1] + d_rel, 0), nb - 1);
        at = min(max(at, 0), npad - 1);
        const double nv = k.norm[at], n2v = k.norm2[at];
        const double base = r.lb_buf[c] == 1 ? n2v : nv;
        scr[slot * nbmax + p] =
            g < r.blend_upto[c] ? __dmul_rn(0.5, __dadd_rn(nv, n2v)) : base;
      }
      __syncthreads();
      // the pre operator, on the calls with a live fold fill
      if (mine && r.fold[c])
        pre[slot * nbmax + p] = row_dot(pre_row, scr + slot * nbmax);
      __syncthreads();
      // the fold windows, a warp each
      for (int q = warp; q < channels * kMaxFill; q += kWarps) {
        const int wslot = q / kMaxFill, wc = c0 + wslot;
        const int fw = wc * kMaxFill + q - wslot * kMaxFill;
        if (r.fill_active[fw] && r.active[wc] && r.fill_fold[fw])
          fill_window(r, fw, k.sl + wslot * width + t.boff[i] - lo,
                      pre + wslot * nbmax, nb, lane);
      }
      __syncthreads();
    }
    if (mine) post_item(k, i, slot, p, post_row);
    __syncthreads();
  }
  // ---- E: each stereo band's merge or butterfly on a warp, and X (they
  // read only their band's products)
  if (channels == 2)
    for (int i = end - 1 - warp; i >= start; i -= kWarps)
      if (t.n[i] > 1) finish_stereo(k, i, lane);
}

// Shared-memory bytes of a block beyond its static part: the norm
// buffers, the filled band and its products over every bin, an ordered
// band's fold source and pre products, the bin -> band map.
size_t smem_bytes(int channels, int width, int npad, int nbmax) {
  return sizeof(double) *
             (2 * static_cast<size_t>(npad) + 2 * channels * width +
              4 * nbmax) +
         width;
}

}  // namespace

// planes / table: host structs (copied into the launch); X: (S, channels *
// frame) float64, in place; pre, post: the packed operators of nc combos
// (columns 8-byte aligned, values 16-byte aligned). Launches one block a
// stream on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int mousiki_band_assembly(const BandPlanes* planes,
                                     const BandTable* table, double* X,
                                     const uint8_t* pre_cols,
                                     const float* pre_vals,
                                     const uint8_t* post_cols,
                                     const float* post_vals, int nc, int S,
                                     int channels, int frame, int npad,
                                     int nbmax, int start, int end, int F,
                                     void* stream) {
  if (S <= 0 || channels < 1 || channels > 2 || start < 0 || end > kBands ||
      start >= end || F < 1 || F > kMaxFill || nbmax < 1 || nc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int width =
      table->boff[end - 1] + table->n[end - 1] - table->boff[start];
  // a thread holds at most kPer positions of the range, one of a band
  if (channels * width > kPer * kThreads || channels * nbmax > kThreads)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(channels, width, npad, nbmax);
  // past 48 KB a block's shared memory (its static part included) needs
  // the opt-in
  if (bytes + sizeof(Row) + sizeof(BandTable) > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        band_assembly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  band_assembly_kernel<<<S, kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      *planes, *table, X, Ops{pre_cols, pre_vals}, Ops{post_cols, post_vals},
      nc, channels, frame, npad, nbmax, start, end, F);
  return static_cast<int>(cudaGetLastError());
}
