// The PVQ leaf stage of the CELT band-plan executor for Hopper (sm_90a),
// as two kernels over the leaves of one tier:
//
//   cwrs_walk_kernel        CWRS index -> pulse vector iy (libopus cwrsi)
//   pvq_leaf_values_kernel  iy * gain / sqrt(sum iy^2), then the spreading
//                           rotation exp_rotation(dir = -1) (vq.rs)
//
// Planes: active (bool), n, k, idx (u32 held in int64), gain (float32),
// b and spread (int64), iy (leaves, nmax) int32, values (leaves, nmax)
// float32, positions at or past n zero.
//
// Replaces two loops that XLA compiled in the reference, which have no
// Pallas kernel: band_exec_jax.cwrs_walk (mousiki_tpu/ops/band_exec_jax.py:
// 150, a lax.scan of nmax + 12 windowed-search steps over every leaf at
// once) and band_exec_jax.rotate_leaves (:280, each Givens chain solved
// as an affine recurrence by log-step doubling), with the normalisation
// before it (:425-429). In eager PyTorch the same loops cost about 80
// launches a scan step: 23,314 of the 28,448 launches of a stereo CELT
// step at S = 256.
//
// What bounds them: neither bytes nor operations but the serial chain of
// one leaf (its descent of up to n table steps, its rotation sweeps). A
// group of G lanes (4, 8 or 16, by nmax) holds each leaf, its row in
// shared memory:
//   * the group reads and writes the leaf's row as one contiguous run
//     (rows are contiguous in device memory): whole sectors, no strided
//     or transposed accesses, so an idle leaf costs a copy of its row;
//   * the walk is libopus's descent as csrc/celt_host.cpp cwrs_iy runs
//     it, on the group's first lane, in native uint32: no window, no
//     retry steps; the U(n, k) table (210 x 160 u32, saturated) is read
//     through the read-only cache, the next row's two entries asked for
//     a position ahead (staging the tier's rows in shared memory
//     measured slower);
//   * the rotation is exp_rotation1 of vq.rs (hostcodec/celt/vq.py,
//     celt_host.cpp exp_rotation1): a pass over len values with stride t
//     is t chains that touch disjoint values, so the group's lanes sweep
//     the chains of all b blocks at once (pass A, stride2, with (s, c)),
//     then the b blocks (pass B, stride 1, with (c, s)); each chain is
//     swept forward and then backward in libopus's order, its running
//     value carried in a register. Every value gets libopus's operations
//     in libopus's order; it rounds unlike the plain version's doubling
//     scan, and the two agree within 1e-5 (the X plane's bar).
// gain, theta, c and s, and every rotation step, round one float32
// operation at a time as the plain version does (no contraction into
// fma).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUN = 210;   // rows (n) of the U table
constexpr int kUK = 160;   // columns (k)
constexpr int kThreads = 128;
// SPREAD_FACTOR of ops/_tables.py: [unused, light, normal, aggressive]
__constant__ float kSpreadFactor[4] = {44.f, 15.f, 10.f, 5.f};

// lanes a leaf, 4 to 11 values a lane for the three tiers (16, 48, 176):
// more leaves a warp ran faster than fewer lanes a value
int group_lanes(int nmax) { return nmax <= 16 ? 4 : nmax <= 48 ? 8 : 16; }

// The group of G lanes that holds leaf `leaf`, one per G threads of the
// block, its row of nmax 4-byte values at smem + slot * nmax.
struct Group {
  int lane, slot, leaf;
  unsigned mask;
  __device__ Group(int G) {
    lane = threadIdx.x % G;
    slot = threadIdx.x / G;
    leaf = blockIdx.x * (blockDim.x / G) + slot;
    const unsigned own = G == 32 ? 0xffffffffu : (1u << G) - 1;
    mask = own << (threadIdx.x % 32 / G * G);
  }
};

__global__ void cwrs_walk_kernel(const bool* __restrict__ active,
                                 const int64_t* __restrict__ n_in,
                                 const int64_t* __restrict__ k_in,
                                 const int64_t* __restrict__ idx_in,
                                 const uint32_t* __restrict__ u,
                                 int32_t* __restrict__ iy, int leaves,
                                 int nmax, int G) {
  extern __shared__ int32_t rows[];
  const Group g(G);
  if (g.leaf >= leaves) return;   // a whole group: masks stay whole
  const bool act = active[g.leaf];
  const int n = static_cast<int>(n_in[g.leaf]);
  int k = static_cast<int>(k_in[g.leaf]);
  uint32_t idx = static_cast<uint32_t>(idx_in[g.leaf]);
  int32_t* row = rows + g.slot * nmax;
  for (int i = g.lane; i < nmax; i += G) row[i] = 0;
  __syncwarp(g.mask);
  // a leaf the plan cannot hold (n past the tier or k past the table)
  // decodes to zeros, as an inactive one does
  if (g.lane == 0 && act && n >= 1 && n <= nmax && k >= 0 && k < kUK - 1) {
    if (n > 1) {
      const uint32_t* um = u + n * kUK;   // row m = n - j
      uint32_t above = __ldg(um + k + 1), p = __ldg(um + k);
      for (int j = 0; j < n - 1 && k > 0; ++j, um -= kUK) {
        // the next row's entries at this k, asked for now: at most
        // positions place no pulse, keep k and need exactly these
        const int k0 = k;
        uint32_t next_above = __ldg(um - kUK + k + 1);
        uint32_t next_p = __ldg(um - kUK + k);
        // negative-sign codewords sit above U(m, k + 1)
        const bool neg = idx >= above;
        if (neg) idx -= above;
        // pulses at j: the largest k' <= k with U(m, k') <= idx
        while (p > idx) p = __ldg(um + --k);
        idx -= p;
        row[j] = neg ? k - k0 : k0 - k;
        if (k != k0) {
          next_above = __ldg(um - kUK + k + 1);
          next_p = __ldg(um - kUK + k);
        }
        above = next_above;
        p = next_p;
      }
    }
    // the last dimension: idx in {0, 1} is the sign of the leftover
    // pulses
    row[n - 1] = idx ? -k : k;
  }
  __syncwarp(g.mask);
  int32_t* out = iy + static_cast<size_t>(g.leaf) * nmax;
  for (int i = g.lane; i < nmax; i += G) out[i] = row[i];
}

// exp_rotation1's two sweeps (vq.rs) over one chain of m values `step`
// apart: forward over the pairs (t, t + 1), t = 0 .. m - 2, then backward
// over t = m - 3 .. 0, with x1 the pair's first value and x2 its second:
// x2' = c x2 + s x1, x1' = c x1 - s x2.
__device__ void rot_chain(float* x, int step, int m, float c, float s) {
  if (m < 2) return;
  float a = x[0];   // the next pair's first value
  for (int t = 0; t < m - 1; ++t) {
    const float b = x[(t + 1) * step];
    x[t * step] = __fsub_rn(__fmul_rn(c, a), __fmul_rn(s, b));
    a = __fadd_rn(__fmul_rn(c, b), __fmul_rn(s, a));
  }
  x[(m - 1) * step] = a;
  if (m < 3) return;
  float d = x[(m - 2) * step];   // the next pair's second value
  for (int t = m - 3; t >= 0; --t) {
    const float a1 = x[t * step];
    x[(t + 1) * step] = __fadd_rn(__fmul_rn(c, d), __fmul_rn(s, a1));
    d = __fsub_rn(__fmul_rn(c, a1), __fmul_rn(s, d));
  }
  x[0] = d;
}

__global__ void pvq_leaf_values_kernel(
    const int32_t* __restrict__ iy, const bool* __restrict__ active,
    const int64_t* __restrict__ n_in, const int64_t* __restrict__ k_in,
    const float* __restrict__ gain_in, const int64_t* __restrict__ b_in,
    const int64_t* __restrict__ spread_in, float* __restrict__ out,
    int leaves, int nmax, int G) {
  extern __shared__ float vals[];
  const Group g(G);
  if (g.leaf >= leaves) return;
  // the leaf's scalars first, so that their loads overlap the row's
  const bool act = active[g.leaf];
  const int n = static_cast<int>(n_in[g.leaf]);
  const int k = static_cast<int>(k_in[g.leaf]);
  const int spread = static_cast<int>(spread_in[g.leaf]);
  const int stride = max(static_cast<int>(b_in[g.leaf]), 1);
  const float leaf_gain = gain_in[g.leaf];
  float* x = vals + g.slot * nmax;
  const size_t base = static_cast<size_t>(g.leaf) * nmax;
  // sum iy^2, exact in int32 and in float32 (k <= 158 pulses)
  int ryy = 0;
  for (int i = g.lane; i < nmax; i += G) {
    const int v = iy[base + i];
    ryy += v * v;
    x[i] = static_cast<float>(v);
  }
  for (int off = G / 2; off > 0; off /= 2)
    ryy += __shfl_xor_sync(g.mask, ryy, off, G);
  const float gain =
      ryy > 0 ? leaf_gain / sqrtf(static_cast<float>(ryy)) : 0.f;
  for (int i = g.lane; i < nmax; i += G) x[i] = __fmul_rn(x[i], gain);

  if (act && 2 * k < n && spread != 0 && n <= nmax) {
    const float fn = static_cast<float>(n);
    const float fk = static_cast<float>(k);
    const float factor = kSpreadFactor[min(max(spread, 0), 3)];
    const float gr = fn / __fadd_rn(fn, __fmul_rn(factor, fk));
    const float theta = __fmul_rn(__fmul_rn(0.5f, gr), gr);
    const float half_pi = static_cast<float>(0.5 * 3.14159265358979323846);
    const float c = cosf(__fmul_rn(half_pi, theta));
    const float s = cosf(__fmul_rn(half_pi, __fsub_rn(1.f, theta)));
    int stride2 = 0;
    if (n >= 8 * stride) {
      stride2 = 1;
      while ((stride2 * stride2 + stride2) * stride + (stride >> 2) < n)
        ++stride2;
    }
    const int len = n / stride;
    __syncwarp(g.mask);
    // pass A: in each block, stride2 chains with (s, c)
    for (int q = g.lane; q < stride * stride2; q += G) {
      const int blk = q / stride2, r = q - blk * stride2;
      rot_chain(x + blk * len + r, stride2,
                (len - r + stride2 - 1) / stride2, s, c);
    }
    __syncwarp(g.mask);
    // pass B: each block one chain with (c, s)
    for (int blk = g.lane; blk < stride; blk += G)
      rot_chain(x + blk * len, 1, len, c, s);
  }
  __syncwarp(g.mask);
  for (int i = g.lane; i < nmax; i += G) out[base + i] = x[i];
}

// Blocks and shared-memory bytes of a launch over `leaves` leaves.
bool launch_shape(int leaves, int nmax, int* G, int* blocks, int* bytes) {
  if (leaves <= 0 || nmax < 1 || nmax >= kUN) return false;
  *G = group_lanes(nmax);
  const int per_block = kThreads / *G;
  *blocks = (leaves + per_block - 1) / per_block;
  *bytes = per_block * nmax * 4;
  return true;
}

}  // namespace

// active, n, k, idx: `leaves` values each; utab: the (210, 160) u32 table;
// iy: (leaves, nmax) int32 out, nmax < 210. Launches on `stream`; returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a shape
// it does not take.
extern "C" int mousiki_cwrs_walk(const bool* active, const int64_t* n,
                                 const int64_t* k, const int64_t* idx,
                                 const uint32_t* utab, int32_t* iy,
                                 int leaves, int nmax, void* stream) {
  int G, blocks, bytes;
  if (!launch_shape(leaves, nmax, &G, &blocks, &bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  cwrs_walk_kernel<<<blocks, kThreads, bytes,
                     static_cast<cudaStream_t>(stream)>>>(
      active, n, k, idx, utab, iy, leaves, nmax, G);
  return static_cast<int>(cudaGetLastError());
}

// iy (leaves, nmax) int32 from mousiki_cwrs_walk; active, n, k, gain, b,
// spread: `leaves` values each; out (leaves, nmax) float32, nmax < 210.
// Launches on `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape it does not take.
extern "C" int mousiki_pvq_leaf_values(const int32_t* iy, const bool* active,
                                       const int64_t* n, const int64_t* k,
                                       const float* gain, const int64_t* b,
                                       const int64_t* spread, float* out,
                                       int leaves, int nmax, void* stream) {
  int G, blocks, bytes;
  if (!launch_shape(leaves, nmax, &G, &blocks, &bytes))
    return static_cast<int>(cudaErrorInvalidValue);
  pvq_leaf_values_kernel<<<blocks, kThreads, bytes,
                           static_cast<cudaStream_t>(stream)>>>(
      iy, active, n, k, gain, b, spread, out, leaves, nmax, G);
  return static_cast<int>(cudaGetLastError());
}
