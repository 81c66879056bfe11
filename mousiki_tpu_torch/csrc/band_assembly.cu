// The band assembly of the CELT band-plan executor (stage P3 of
// ops/band_exec.execute_packed) for Hopper (sm_90a): band_assembly_kernel.
//
// For each stream and each band start..end-1 in order, and each channel
// slot: the fold source gathered from the norm buffers (with the
// special-hybrid-folding duplicate and the lowband blend), the per-call
// pre operator, the fold / noise fills (LCG), the post operator, the
// n_b = 1 sign path, the norm-buffer writes, the N = 2 stereo butterfly
// and the stereo merge; the band is written back into the X plane.
//
// Replaces a loop that XLA compiled in the reference, which has no Pallas
// kernel: the P3 band_body lax.scan over the 21 bands of
// band_exec_jax.execute_packed (mousiki_tpu/ops/band_exec_jax.py:514, scan
// :643). Its plain version, ops/band_assembly.band_assembly_reference, is
// that loop in eager PyTorch: about 197 launches a band, 4,139 of the
// 5,112 launches of a stereo CELT step at S = 256.
//
// Planes as the executor holds them (ops/band_exec._normalize_plan): flags
// bool, integers and u32 values int64, gains float32; (S, 21, 2) a call,
// (S, 21) a band, (S, 21, 2, F) a fill slot, (S, 21, 2, 3) the duplicate
// window; each plane's trailing dimensions contiguous, its streams any
// stride apart (the arena's planes are views). X is (S, C * frame)
// float64; the bins of bands start..end-1 are read and written once, the
// rest of X is left as it is. The operators are
// the reference's float32 values packed by ops/band_assembly.
// packed_operators, pre and post apart: for band i and combo c an n_b x n_b
// block, stored by columns (entry (m, n) at n * n_b + m), at op_off[i] +
// c * n_b * n_b.
//
// What bounds it: neither bytes nor operations but one stream's serial
// chain of 21 bands, each waiting on the norm buffers the bands before it
// wrote (a fold source may read them). One thread block a stream holds
// that stream's X row, both norm buffers, its plan planes (staged once,
// at the start) and the band's scratch in shared memory, so the chain
// waits on device memory only for the operators, and a stream's value
// never depends on S or on the other streams (no sum across streams).
// Inside a band the block's threads take the band's positions (both
// slots at once); a product row is one thread's dot product over the
// operator's column-major block (neighbouring threads read neighbouring
// entries, sixteen loads in flight); a fill window is one warp (its
// energy a warp sum); the merge's two sums are block sums.
//
// Arithmetic is the plain version's, in float64: f32 planes widened
// exactly, the merge's mid * mid rounded in float32 as the plain version
// rounds it, elementwise operations one rounding each (no contraction).
// The dot products and sums run in their own order (fma in the products):
// they differ from the plain version's by float64 round-off.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBands = 21;
// fill slots a call: the lockstep plan emission's 8 (the host's plan
// profiles give at most 4)
constexpr int kMaxFill = 8;
constexpr int kThreads = 256;
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

// Per-band constants of one (lm, frame) from the host: width, offset in a
// channel's frame, norm-buffer write offset (-1: no write), offset of the
// band's operator blocks, and the norm write's scale (float32 sqrt(n_b)).
struct BandTable {
  int n[kBands];
  int boff[kBands];
  int nwoff[kBands];
  int op_off[kBands];
  double scale[kBands];
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

// a combo index inside the stack (a valid plan holds no other)
__device__ int combo(int64_t c, int nc) {
  return c < 0 ? 0 : c >= nc ? nc - 1 : static_cast<int>(c);
}

// out[m] = sum_n op[m][n] x[n], m < nb, op a column-major nb x nb block.
// The operator's entries come from L2: four partial sums over n mod 4,
// unrolled four times, keep sixteen loads in flight a thread (eight sums
// unrolled twice ran slower on the card).
__device__ double op_row(const float* __restrict__ op, const double* x, int nb,
                         int m) {
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
  int n = 0;
#pragma unroll 4
  for (; n + 4 <= nb; n += 4)
    for (int j = 0; j < 4; ++j)
      acc[j] = __fma_rn(static_cast<double>(op[(n + j) * nb + m]), x[n + j],
                        acc[j]);
  for (; n < nb; ++n)
    acc[0] = __fma_rn(static_cast<double>(op[n * nb + m]), x[n], acc[0]);
  return __dadd_rn(__dadd_rn(acc[0], acc[1]), __dadd_rn(acc[2], acc[3]));
}

// One stream's plan planes, staged in shared memory at the start so that
// the band chain reads them at shared-memory latency. A call is c = 2 i +
// slot, a fill slot c * kMaxFill + w; the int64 planes hold values that
// fit 32 bits (int16 offsets, u8 combos, u32 seeds).
struct Row {
  int32_t lb_src[2 * kBands], lb_buf[2 * kBands], blend_upto[2 * kBands];
  int32_t pre[2 * kBands], post[2 * kBands], norm_buf[2 * kBands];
  int32_t dup[2 * kBands * 3];
  int32_t fill_off[2 * kBands * kMaxFill], fill_n[2 * kBands * kMaxFill];
  uint32_t fill_seed[2 * kBands * kMaxFill];
  float fill_gain[2 * kBands * kMaxFill], n1_val[2 * kBands];
  float merge_mid[kBands], t2_sign[kBands], t2_mid[kBands], t2_side[kBands];
  bool active[2 * kBands], norm_write[2 * kBands], n1_active[2 * kBands];
  bool fill_active[2 * kBands * kMaxFill], fill_fold[2 * kBands * kMaxFill];
  bool merge_active[kBands], merge_inv[kBands], t2_active[kBands];
  bool t2_cswap[kBands], t2_inv[kBands];
};

__device__ void stage_row(Row& r, const BandPlanes& P, int s, int nc, int F,
                          int tid) {
  const bool *active = P.call_active.row(s), *nw = P.call_norm_write.row(s);
  const int64_t *lb_src = P.call_lb_src.row(s), *lb_buf = P.call_lb_buf.row(s);
  const int64_t *blend = P.call_blend_upto.row(s), *pre = P.call_pre.row(s);
  const int64_t *post = P.call_post.row(s), *nbuf = P.call_norm_buf.row(s);
  const int64_t* dup = P.call_dup.row(s);
  const bool *fa = P.fill_active.row(s), *ff = P.fill_fold.row(s);
  const int64_t *foff = P.fill_off.row(s), *fn = P.fill_n.row(s);
  const int64_t* fseed = P.fill_seed.row(s);
  const float* fgain = P.fill_gain.row(s);
  const bool* n1a = P.n1_active.row(s);
  const float* n1v = P.n1_val.row(s);
  for (int c = tid; c < 2 * kBands; c += kThreads) {
    r.lb_src[c] = static_cast<int32_t>(lb_src[c]);
    r.lb_buf[c] = static_cast<int32_t>(lb_buf[c]);
    r.blend_upto[c] = static_cast<int32_t>(blend[c]);
    r.pre[c] = combo(pre[c], nc);
    r.post[c] = combo(post[c], nc);
    r.norm_buf[c] = static_cast<int32_t>(nbuf[c]);
    r.n1_val[c] = n1v[c];
    r.active[c] = active[c];
    r.norm_write[c] = nw[c];
    r.n1_active[c] = n1a[c];
    for (int k = 0; k < 3; ++k)
      r.dup[3 * c + k] = static_cast<int32_t>(dup[3 * c + k]);
    for (int w = 0; w < kMaxFill; ++w) {
      const int g = c * F + w, fw = c * kMaxFill + w;
      const bool on = w < F;
      r.fill_off[fw] = on ? static_cast<int32_t>(foff[g]) : 0;
      r.fill_n[fw] = on ? static_cast<int32_t>(fn[g]) : 0;
      r.fill_seed[fw] = on ? static_cast<uint32_t>(fseed[g]) : 0u;
      r.fill_gain[fw] = on ? fgain[g] : 0.f;
      r.fill_active[fw] = on && fa[g];
      r.fill_fold[fw] = on && ff[g];
    }
  }
  for (int i = tid; i < kBands; i += kThreads) {
    r.merge_mid[i] = P.merge_mid.row(s)[i];
    r.t2_sign[i] = P.theta2_sign.row(s)[i];
    r.t2_mid[i] = P.theta2_mid.row(s)[i];
    r.t2_side[i] = P.theta2_side.row(s)[i];
    r.merge_active[i] = P.merge_active.row(s)[i];
    r.merge_inv[i] = P.merge_inv.row(s)[i];
    r.t2_active[i] = P.theta2_active.row(s)[i];
    r.t2_cswap[i] = P.theta2_cswap.row(s)[i];
    r.t2_inv[i] = P.theta2_inv.row(s)[i];
  }
}

__global__ void __launch_bounds__(kThreads)
band_assembly_kernel(const BandPlanes P, const BandTable T,
                     double* __restrict__ X, const float* __restrict__ pre_ops,
                     const float* __restrict__ post_ops, int nc, int channels,
                     int frame, int npad, int nbmax, int start, int end,
                     int F) {
  extern __shared__ double sm[];
  __shared__ Row r;
  const int s = blockIdx.x;
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int cf = channels * frame;
  double* xrow = sm;                    // (C * frame) the stream's X row
  double* norm = xrow + cf;             // (npad)
  double* norm2 = norm + npad;          // (npad)
  double* scr = norm2 + npad;           // (2, nbmax) fold source
  double* pre = scr + 2 * nbmax;        // (2, nbmax) after the pre operator
  double* sl = pre + 2 * nbmax;         // (2, nbmax) filled band
  double* bx = sl + 2 * nbmax;          // (2, nbmax) after the post operator
  double* red = bx + 2 * nbmax;         // (2, kWarps) block sums

  // only the bins of bands start..end-1 are read and written
  const int lo = T.boff[start], width = T.boff[end - 1] + T.n[end - 1] - lo;
  double* xg = X + static_cast<size_t>(s) * cf;
  for (int slot = 0; slot < channels; ++slot)
    copy_in(xrow + slot * frame + lo, xg + slot * frame + lo, width, tid,
            kThreads);
  for (int q = tid; q < 2 * npad; q += kThreads) norm[q] = 0.0;
  stage_row(r, P, s, nc, F, tid);
  __syncthreads();

  for (int i = start; i < end; ++i) {
    const int nb = T.n[i];
    const int boff = T.boff[i];
    const int c0 = 2 * i;                 // the band's slot-0 call
    if (nb == 1) {
      // the n1 sign path replaces the whole band
      if (tid < channels) {
        const int c = c0 + tid;
        bx[tid * nbmax] = r.n1_active[c] ? static_cast<double>(r.n1_val[c])
                                         : xrow[tid * frame + boff];
      }
    } else {
      // fold source: norm / norm2 at lb_src + p, the duplicate window
      // reading the same gather at its source, the lowband blend
      for (int q = tid; q < channels * nb; q += kThreads) {
        const int slot = q / nb, p = q - slot * nb, c = c0 + slot;
        const int src = r.lb_src[c];
        const int* dup = r.dup + 3 * c;
        const int g = src + p;
        int at = g;
        const int d_rel = p - dup[0];
        if (d_rel >= 0 && d_rel < dup[2])
          at = src + min(max(dup[1] + d_rel, 0), nb - 1);
        at = min(max(at, 0), npad - 1);
        const double nv = norm[at], n2v = norm2[at];
        const double base = r.lb_buf[c] == 1 ? n2v : nv;
        scr[slot * nbmax + p] =
            g < r.blend_upto[c] ? __dmul_rn(0.5, __dadd_rn(nv, n2v)) : base;
        sl[slot * nbmax + p] = xrow[slot * frame + boff + p];
      }
      __syncthreads();
      // the pre operator, where a live fold fill reads its output
      for (int q = tid; q < channels * nb; q += kThreads) {
        const int slot = q / nb, m = q - slot * nb, c = c0 + slot;
        bool fold = false;
        for (int w = 0; w < kMaxFill; ++w)
          fold |= r.fill_active[c * kMaxFill + w] &&
                  r.fill_fold[c * kMaxFill + w];
        if (fold && r.active[c]) {
          const float* op = pre_ops + T.op_off[i] + r.pre[c] * nb * nb;
          pre[slot * nbmax + m] = op_row(op, scr + slot * nbmax, nb, m);
        }
      }
      __syncthreads();
      // fills: one warp a live (slot, window); windows lie inside the band
      // and do not overlap, so a covered position takes its window's value
      for (int q = warp; q < channels * kMaxFill; q += kWarps) {
        const int slot = q / kMaxFill, c = c0 + slot;
        const int fw = c * kMaxFill + q - slot * kMaxFill;
        if (!(r.fill_active[fw] && r.active[c])) continue;
        const int off = r.fill_off[fw], n = r.fill_n[fw];
        const uint32_t seed0 = r.fill_seed[fw];
        const bool fold = r.fill_fold[fw];
        double* out = sl + slot * nbmax;
        const double* src = pre + slot * nbmax;
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
      __syncthreads();
      // the post operator, on every call (an inactive one keeps X's band)
      for (int q = tid; q < channels * nb; q += kThreads) {
        const int slot = q / nb, m = q - slot * nb, c = c0 + slot;
        const float* op = post_ops + T.op_off[i] + r.post[c] * nb * nb;
        bx[slot * nbmax + m] = op_row(op, sl + slot * nbmax, nb, m);
      }
    }
    __syncthreads();
    // norm writes, before the stereo merge, slot 0 then slot 1
    if (T.nwoff[i] >= 0) {
      for (int p = tid; p < nb; p += kThreads) {
        for (int slot = 0; slot < channels; ++slot) {
          const int c = c0 + slot;
          if (!(r.norm_write[c] && r.active[c])) continue;
          const double v = __dmul_rn(T.scale[i], bx[slot * nbmax + p]);
          (r.norm_buf[c] == 1 ? norm2 : norm)[T.nwoff[i] + p] = v;
        }
      }
    }
    if (channels == 2 && nb == 2) {
      // N == 2 stereo butterfly, after the norm writes have read bx
      __syncthreads();
      if (tid == 0 && r.t2_active[i]) {
        const double sgn = static_cast<double>(r.t2_sign[i]);
        const double x00 = bx[0], x01 = bx[1];
        const double x10 = bx[nbmax], x11 = bx[nbmax + 1];
        double nx0, nx1, ny0, ny1;
        if (r.t2_cswap[i]) {
          nx0 = __dmul_rn(-sgn, x11);
          nx1 = __dmul_rn(sgn, x10);
          ny0 = x10;
          ny1 = x11;
        } else {
          nx0 = x00;
          nx1 = x01;
          ny0 = __dmul_rn(-sgn, x01);
          ny1 = __dmul_rn(sgn, x00);
        }
        const double mid = static_cast<double>(r.t2_mid[i]);
        const double side = static_cast<double>(r.t2_side[i]);
        nx0 = __dmul_rn(nx0, mid);
        nx1 = __dmul_rn(nx1, mid);
        ny0 = __dmul_rn(ny0, side);
        ny1 = __dmul_rn(ny1, side);
        const double sg = r.t2_inv[i] ? -1.0 : 1.0;
        bx[0] = __dsub_rn(nx0, ny0);
        bx[1] = __dsub_rn(nx1, ny1);
        bx[nbmax] = sg * __dadd_rn(nx0, ny0);
        bx[nbmax + 1] = sg * __dadd_rn(nx1, ny1);
      }
      __syncthreads();
    }
    if (channels == 2 && nb > 2) {
      // stereo merge: sum x0 x1 and sum x1^2 as block sums
      double xp = 0.0, sd = 0.0;
      for (int p = tid; p < nb; p += kThreads) {
        const double a = bx[p], b = bx[nbmax + p];
        xp = __fma_rn(a, b, xp);
        sd = __fma_rn(b, b, sd);
      }
      xp = warp_sum(xp);
      sd = warp_sum(sd);
      if (lane == 0) {
        red[warp] = xp;
        red[kWarps + warp] = sd;
      }
      __syncthreads();
      const bool ma = r.merge_active[i], inv = r.merge_inv[i];
      const float mid32 = r.merge_mid[i];
      const double mid = static_cast<double>(mid32);
      xp = 0.0;
      sd = 0.0;
      for (int w = 0; w < kWarps; ++w) {
        xp = __dadd_rn(xp, red[w]);
        sd = __dadd_rn(sd, red[kWarps + w]);
      }
      xp = __dmul_rn(xp, mid);
      const double mm = static_cast<double>(__fmul_rn(mid32, mid32));
      const double el = __dsub_rn(__dadd_rn(mm, sd), __dmul_rn(2.0, xp));
      const double er = __dadd_rn(__dadd_rn(mm, sd), __dmul_rn(2.0, xp));
      const bool degen = er < 6e-4 || el < 6e-4;
      const double lg = __ddiv_rn(1.0, __dsqrt_rn(el > 1e-20 ? el : 1e-20));
      const double rg = __ddiv_rn(1.0, __dsqrt_rn(er > 1e-20 ? er : 1e-20));
      for (int p = tid; p < nb; p += kThreads) {
        const double x0 = bx[p], x1 = bx[nbmax + p];
        double o0 = x0, o1 = inv ? -x1 : x1;
        if (ma) {
          const double lpart = __dmul_rn(mid, x0);
          double mx = __dmul_rn(lg, __dsub_rn(lpart, x1));
          double my = __dmul_rn(rg, __dadd_rn(lpart, x1));
          if (degen) mx = my = x0;
          o0 = mx;
          o1 = inv ? -my : my;
        }
        xrow[boff + p] = o0;
        xrow[frame + boff + p] = o1;
      }
    } else {
      for (int q = tid; q < channels * nb; q += kThreads) {
        const int slot = q / nb, p = q - slot * nb;
        xrow[slot * frame + boff + p] = bx[slot * nbmax + p];
      }
    }
    __syncthreads();
  }
  for (int q = tid; q < channels * width; q += kThreads) {
    const int at = q / width * frame + lo + q % width;
    xg[at] = xrow[at];
  }
}

// Shared-memory bytes of a block.
size_t smem_bytes(int channels, int frame, int npad, int nbmax) {
  return sizeof(double) *
         (static_cast<size_t>(channels) * frame + 2 * npad + 8 * nbmax +
          2 * kWarps);
}

}  // namespace

// planes / table: host structs (copied into the launch); X: (S, channels *
// frame) float64, in place; pre, post: the packed float32 operators of nc
// combos. Launches one block a stream on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// it does not take.
extern "C" int mousiki_band_assembly(const BandPlanes* planes,
                                     const BandTable* table, double* X,
                                     const float* pre, const float* post,
                                     int nc, int S, int channels, int frame,
                                     int npad, int nbmax, int start, int end,
                                     int F, void* stream) {
  if (S <= 0 || channels < 1 || channels > 2 || start < 0 || end > kBands ||
      start >= end || F < 1 || F > kMaxFill || nbmax < 1 || nc < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t bytes = smem_bytes(channels, frame, npad, nbmax);
  // past 48 KB a block's shared memory (the staged Row included) needs
  // the opt-in
  if (bytes + sizeof(Row) > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        band_assembly_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (rc != cudaSuccess) return static_cast<int>(rc);
  }
  band_assembly_kernel<<<S, kThreads, bytes,
                         static_cast<cudaStream_t>(stream)>>>(
      *planes, *table, X, pre, post, nc, channels, frame, npad, nbmax, start,
      end, F);
  return static_cast<int>(cudaGetLastError());
}
