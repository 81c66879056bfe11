// The PVQ leaf stage of the CELT band-plan executor for Hopper (sm_90a):
//
//   pvq_leaf_stage_kernel  every leaf of the three tiers in one launch:
//                          CWRS index -> pulse vector iy (libopus cwrsi),
//                          iy * gain / sqrt(sum iy^2), the spreading
//                          rotation exp_rotation(dir = -1) (vq.rs), and the
//                          leaf's values written straight into the X plane
//   cwrs_walk_kernel       the walk alone over one tier's leaves, iy out
//                          (the lockstep plan emission's)
//
// Replaces loops and ops that XLA compiled in the reference, which have no
// Pallas kernel (mousiki_tpu/ops/band_exec_jax.py): cwrs_walk (:150, a
// lax.scan of windowed-search steps over every leaf at once),
// rotate_leaves (:280, each Givens chain solved as an affine recurrence by
// log-step doubling) with the normalisation before it (:425-430), and the
// pool -> X gather of execute_packed (:432-456, a gather map built by a
// difference-array cumsum over the per-slot destinations pvq_dst).
//
// Planes as the executor holds them (ops/band_exec._normalize_plan), a
// tier's (S, slots) each, read in place whatever their strides (the
// arena's planes are views, the lockstep emission's spread a broadcast):
// active bool, n, k, idx (u32), b, spread and dst int64, gain float32.
// X (S, cols) float64, zeroed by the caller: an active leaf of n values
// writes value i at dst + i, for i < n, where that falls inside [0,
// cols); nothing else is written (the spans of a stream's leaves are
// disjoint, as the gather map assumed).
//
// What bounds it: neither bytes (about 5 MB of planes and X at S = 256)
// nor operations, but chains of dependent steps (a leaf's descent, one
// table read a step; its four rotation sweeps), a warp's time being its
// slowest leaf's, and, with every warp of an SM busy at S = 256, the
// instructions those chains execute. Clock probes (tools/leaf_probe.cu)
// showed the rest: plane loads waiting on parameter reads at a run-time
// index, a descent whose lanes diverged (each waiting out the others'
// column searches, up to 97 steps long), and per-value divisions in the
// copies. A walk and a values kernel a tier would run as six launches one
// after another, iy and the values making a round trip through device
// memory, then about 80 launches of gather glue. So:
//   * one launch a step: persistent blocks (a grid of at most the blocks
//     that fit on the SMs) whose warps loop over tasks of 32 / G leaves of
//     one tier, G lanes a leaf (kStageLanes, kWalkLanes), the widest
//     tier's tasks first so that the longest chains start first; the
//     tiers' plane descriptors are copied into shared memory once a block;
//     a task none of whose leaves walks ends after its planes are read; a
//     leaf's row stays in shared memory from the walk to the write;
//   * the U table in shared memory: V(n, k) < 2^32 caps k, and that cap
//     kmax(n) never grows with n, so a valid leaf's descent stays in rows
//     <= n and columns <= kmax(n) + 1: 2,289 entries for rows up to 176.
//     The wrapper packs that region row by row, as libopus lays out
//     CELT_PVQ_U_DATA (row offsets ahead of the entries), and a block
//     copies the rows its tiers reach into shared memory with one bulk
//     asynchronous copy completing on an mbarrier (the stage as the block
//     starts, overlapping the first plane loads; the walk alone only once
//     a task walks). A leaf outside the region (k past kmax(n): no valid
//     codeword) runs the same descent over the full (210, 160) table in
//     device memory;
//   * the descent is libopus's as csrc/celt_host.cpp cwrs_iy runs it, in
//     native uint32: on a leaf's first lane in the 16-wide tier (and the
//     48-wide one in the walk alone, a lane a leaf, so that no lane of a
//     warp idles), with no branch in a step, each step testing kCols
//     columns of the position's pulse count at once (a step a position
//     where libopus's linear search takes one a pulse); in the wider
//     tiers on the group's G lanes at once, which try G positions
//     in one step (a position places no pulse exactly when U(m, k) <= idx
//     < U(m, k + 1), and takes U(m, k) off idx) and G columns of a
//     position's pulse count in one step;
//   * the rotation is exp_rotation1 of vq.rs (hostcodec/celt/vq.py): a pass
//     over len values with stride t is t chains that touch disjoint values,
//     so the group's lanes sweep the chains of all b blocks at once (pass
//     A, stride2, with (s, c)), then the b blocks (pass B, stride 1, with
//     (c, s)); each chain is swept forward and then backward in libopus's
//     order, its running value in a register and the chain's next values
//     read ahead into registers four at a time, so that a step waits on
//     two float32 operations, not on a shared-memory load. It rounds
//     unlike the plain version's doubling scan; the two agree within 1e-5.
// gain, theta, c and s, and every rotation step, round one float32
// operation at a time as the plain version does (no contraction into
// fma). A leaf stands alone: which block or lane takes it changes none of
// its arithmetic, and no sum crosses leaves or streams.

#include <cuda_runtime.h>
#include <stdint.h>

// A clock probe's hook at each stage of a warp's task (tools/leaf_probe.cu
// defines it; tools/torch_leaf_walk_ab.py --probe builds and reads it):
// nothing in the kernels' own build.
#ifndef LEAF_PROBE
#define LEAF_PROBE(task, point)
#endif

namespace {

constexpr int kUN = 210;     // rows (n) of the U table
constexpr int kUK = 160;     // columns (k)
constexpr int kHeader = 212; // words of row offsets ahead of the entries
constexpr int kTiers = 3;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSM = 4;  // at most 64 registers a thread
constexpr uint32_t kCopyChunk = 4096;  // bytes a bulk copy instruction
// SPREAD_FACTOR of ops/_tables.py: [unused, light, normal, aggressive]
__constant__ float kSpreadFactor[4] = {44.f, 15.f, 10.f, 5.f};

// lanes a leaf for the three tiers (16, 48, 176), in the stage (the
// rotation and the writes to X share a leaf's values among them) and in
// the walk alone
constexpr int kStageLanes[kTiers] = {2, 8, 16};
constexpr int kWalkLanes[kTiers] = {1, 1, 16};
int group_lanes(int nmax, bool values) {
  const int t = nmax <= 16 ? 0 : nmax <= 48 ? 1 : 2;
  return values ? kStageLanes[t] : kWalkLanes[t];
}
// tiers this wide descend on a leaf's first lane, in the stage and in the
// walk alone; wider tiers try G positions at once on the group (in the
// stage the 48-wide tier's leaves, one to a warp's eight lanes at S = 3,
// wait on a chain of up to 47 positions otherwise)
constexpr int kStageLaneNmax = 16;
constexpr int kWalkLaneNmax = 48;
// columns a step of the one-lane descent tests
constexpr int kCols = 4;

}  // namespace

// A plane of one tier: its data and its stream and slot strides, in
// elements.
struct Plane {
  const void* data;
  int64_t stride, slot_stride;
};

// One tier of leaves, S * slots of them; G and tasks are set by the launch.
struct Tier {
  Plane active, n, k, idx, gain, b, spread, dst;
  int32_t* iy;   // (S * slots, nmax) int32 pulse vectors out, or null
  int slots, nmax, G, tasks;
};

// A launch: the tiers in launch order, the packed U table (kHeader words
// of row offsets, then the entries) of which the first `packed_words` are
// staged, the full table, and X (null for the walk).
struct Stage {
  Tier tier[kTiers];
  int tiers, S;
  const int32_t* packed;
  const uint32_t* u;
  double* X;
  int64_t cols;
  int packed_words, row_words;
};

namespace {

template <class T>
__device__ __forceinline__ T at(const Plane& p, int s, int slot) {
  return static_cast<const T*>(p.data)[s * p.stride
                                       + slot * p.slot_stride];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Thread 0 readies `bar` for one bulk copy (before the block's barrier).
__device__ void init_table_barrier(uint64_t* bar) {
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                     smem_addr(bar))
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// One thread starts the bulk copy of `words` (a multiple of 4) words of
// `src` into `dst`, completing on `bar` (after the block's barrier).
__device__ void stage_table(uint64_t* bar, int32_t* dst, const int32_t* src,
                            int words) {
  {
    const uint32_t bytes = static_cast<uint32_t>(words) * 4;
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 ::"r"(smem_addr(bar)), "r"(bytes)
                 : "memory");
    for (uint32_t off = 0; off < bytes; off += kCopyChunk) {
      const uint32_t len = min(kCopyChunk, bytes - off);
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst) + off),
          "l"(reinterpret_cast<uint64_t>(src + off / 4)), "r"(len),
          "r"(smem_addr(bar))
          : "memory");
    }
  }
}

// Waits until the bulk copy of stage_table has landed.
__device__ void wait_table(uint64_t* bar) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], 0;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar))
        : "memory");
  }
}

// Where a leaf's descent reads U(m, k): row m at rows(m), column k at
// rows(m)[k]; the packed region in shared memory (ent + off[m]), or the
// full (210, 160) table in device memory for a leaf outside it.
struct Table {
  const int32_t* off;   // null: the full table
  const uint32_t* ent;
  __device__ const uint32_t* row(int m) const {
    return off != nullptr ? ent + off[m] : ent + m * kUK;
  }
};

// libopus's cwrsi descent of (n, k, idx) as celt_host.cpp cwrs_iy runs it,
// on one lane, into y[0..n-1] (zeroed by the caller); returns sum y^2.
// kPacked: the packed region in shared memory (row m's entries from
// ent[off[m]]), else the full table in device memory (from ent[m * kUK]).
// One step tests kCols columns at once, with no branch in the step, so
// that the lanes of a warp, each on its own leaf, step together whatever
// their leaves. Position j (row m = n - j) gets k - c pulses for the
// largest column c <= k with U(m, c) <= idx (U(m, 0) = 0, and U(m, .)
// never falls as c grows; columns below 0 read column 0). The step that
// starts position j reads U(m, k + 1) and columns k .. k - kCols + 1: idx
// at or above U(m, k + 1) is a negative sign, and loses it; each later
// step reads the next kCols columns down. At the step that finds c, idx
// loses U(m, c). Every step also reads the start of the row two positions
// on; y[j] is written at every step, the last write, at its resolving
// step, standing.
template <bool kPacked>
__device__ int descend_lane(const int32_t* off, const uint32_t* ent, int n,
                            int k, uint32_t idx, int32_t* y) {
  auto row = [&](int m) { return kPacked ? off[m] : m * kUK; };
  int ryy = 0, j = 0, c = k;
  int r = row(n), next = row(n - 1);      // rows m = n - j and m - 1
  bool start = true, neg = false;
  while (j < n - 1 && k > 0) {
    const int after = row(max(n - j - 2, 0));
    c = start ? k : c - kCols;
    const uint32_t above = ent[r + k + 1];
    uint32_t u[kCols];
#pragma unroll
    for (int d = 0; d < kCols; ++d) u[d] = ent[r + max(c - d, 0)];
    const bool sign = start && idx >= above;
    neg = start ? sign : neg;
    idx -= sign ? above : 0u;
    bool found = false;   // the largest column of the step that holds
    int hit = 0;
    uint32_t uhit = 0;
#pragma unroll
    for (int d = kCols - 1; d >= 0; --d) {
      const bool holds = u[d] <= idx;
      found = found || holds;
      hit = holds ? max(c - d, 0) : hit;
      uhit = holds ? u[d] : uhit;
    }
    start = found;   // position j resolves
    const int q = k - hit;
    y[j] = neg ? -q : q;
    idx -= start ? uhit : 0u;
    ryy += start ? q * q : 0;
    k = start ? hit : k;
    j += start ? 1 : 0;
    r = start ? next : r;
    next = start ? after : next;
  }
  // the last dimension: idx in {0, 1} is the sign of the leftover pulses
  y[n - 1] = idx ? -k : k;
  return ryy + k * k;
}

// libopus's cwrsi descent of (n, k, idx) (celt_host.cpp cwrs_iy) into
// y[0..n-1], zeroed by the caller, on the G lanes of a group; returns sum
// y^2 on each of them. Every lane of the warp calls it (its shuffles and
// ballots are the warp's); `walk` says whether this lane's group walks a
// leaf. In native uint32, step for step the serial descent's arithmetic:
//   * a position places no pulse exactly when U(m, k) <= idx < U(m,
//     k + 1); it keeps k and takes U(m, k) off idx. So the group tries G
//     positions at once: lane l takes row m - l and the idx the positions
//     before it would leave (an inclusive scan of their U(., k) across
//     the lanes; exact up to the first position that places pulses, the
//     only ones used), and the run ends at the first lane that fails;
//   * at a position that places pulses: negative-sign codewords sit
//     above U(m, k + 1); the count is k - k' for the largest k' <= k with
//     U(m, k') <= idx (U(m, 0) = 0), G columns tried at once.
__device__ int descend(const Table& t, bool walk, int n, int k, uint32_t idx,
                       int32_t* y, int gl, int G, int gbase) {
  const unsigned gmask = G == 32 ? 0xffffffffu : (1u << G) - 1;
  int ryy = 0, j = 0;
  bool go = walk && n > 1 && k > 0;
  while (__any_sync(0xffffffffu, go)) {
    const int m = n - j;   // the row of position j
    const bool in = go && j + gl < n - 1;
    uint32_t lo = 0, hi = 0;
    if (in) {
      const uint32_t* r = t.row(m - gl);
      lo = r[k];
      hi = r[k + 1];
    }
    uint32_t upto = lo;   // the group's inclusive scan of lo
    for (int d = 1; d < G; d *= 2) {
      const uint32_t v = __shfl_up_sync(0xffffffffu, upto, d, G);
      if (gl >= d) upto += v;
    }
    const uint32_t before = upto - lo;
    const uint32_t left = idx - before;
    const bool zero = in && left >= lo && left < hi;
    const unsigned stop =
        ~(__ballot_sync(0xffffffffu, zero) >> gbase) & gmask;
    const int z = stop ? __ffs(stop) - 1 : G;   // positions with no pulse
    // idx less their entries: lane z's exclusive prefix, or the total
    const uint32_t taken =
        __shfl_sync(0xffffffffu, z < G ? before : upto, min(z, G - 1), G);
    if (go) {
      idx -= taken;
      j += z;
      go = j < n - 1;
    }
    const bool pulse = go && z < G;
    const uint32_t* r = t.row(pulse ? n - j : 0);
    bool neg = false;
    if (pulse) {
      const uint32_t above = r[k + 1];
      neg = idx >= above;
      if (neg) idx -= above;
    }
    int k1 = k, top = k;
    bool search = pulse;
    while (__any_sync(0xffffffffu, search)) {
      const int col = top - gl;
      const bool ok = search && col >= 0 && r[max(col, 0)] <= idx;
      const unsigned hit = (__ballot_sync(0xffffffffu, ok) >> gbase) & gmask;
      if (search && hit) {
        k1 = top - (__ffs(hit) - 1);
        search = false;
      }
      top -= G;
    }
    if (pulse) {
      idx -= r[k1];
      const int q = k - k1;
      if (gl == 0) y[j] = neg ? -q : q;
      ryy += q * q;
      k = k1;
      j += 1;
      go = j < n - 1 && k > 0;
    }
  }
  // the last dimension: idx in {0, 1} is the sign of the leftover pulses
  if (walk && gl == 0) y[n - 1] = idx ? -k : k;
  return walk ? ryy + k * k : 0;
}

// exp_rotation1's two sweeps (vq.rs) over one chain of m values `step`
// apart: forward over the pairs (t, t + 1), t = 0 .. m - 2, then backward
// over t = m - 3 .. 0, with x1 the pair's first value and x2 its second:
// x2' = c x2 + s x1, x1' = c x1 - s x2. Each chunk's loads are made
// before its stores; none reads a value the sweep has written.
__device__ __forceinline__ void rot_chain(float* x, int step, int m, float c,
                                          float s) {
  if (m < 2) return;
  float a = x[0];   // the next pair's first value
  auto forward = [&](float b, int t) {
    x[t * step] = __fsub_rn(__fmul_rn(c, a), __fmul_rn(s, b));
    a = __fadd_rn(__fmul_rn(c, b), __fmul_rn(s, a));
  };
  int t = 0;
  for (; t + 4 <= m - 1; t += 4) {
    const float b0 = x[(t + 1) * step], b1 = x[(t + 2) * step];
    const float b2 = x[(t + 3) * step], b3 = x[(t + 4) * step];
    forward(b0, t);
    forward(b1, t + 1);
    forward(b2, t + 2);
    forward(b3, t + 3);
  }
  for (; t < m - 1; ++t) forward(x[(t + 1) * step], t);
  x[(m - 1) * step] = a;
  if (m < 3) return;
  float d = x[(m - 2) * step];   // the next pair's second value
  auto backward = [&](float a1, int t) {
    x[(t + 1) * step] = __fadd_rn(__fmul_rn(c, d), __fmul_rn(s, a1));
    d = __fsub_rn(__fmul_rn(c, a1), __fmul_rn(s, d));
  };
  for (t = m - 3; t >= 3; t -= 4) {
    const float a0 = x[t * step], a1 = x[(t - 1) * step];
    const float a2 = x[(t - 2) * step], a3 = x[(t - 3) * step];
    backward(a0, t);
    backward(a1, t - 1);
    backward(a2, t - 2);
    backward(a3, t - 3);
  }
  for (; t >= 0; --t) backward(x[t * step], t);
  x[0] = d;
}

// exp_rotation(dir = -1) of one leaf's n values in x, on the group's lanes.
// Every lane of the warp calls it (its barriers are the warp's); `rot`
// says whether this lane's leaf rotates.
__device__ __forceinline__ void rotate(float* x, bool rot, int n, int k,
                                       int b, int spread, int gl, int G) {
  float c = 0.f, s = 0.f;
  int stride = 1, stride2 = 0, len = 0;
  if (rot) {
    const float fn = static_cast<float>(n);
    const float fk = static_cast<float>(k);
    const float factor = kSpreadFactor[min(max(spread, 0), 3)];
    const float gr = fn / __fadd_rn(fn, __fmul_rn(factor, fk));
    const float theta = __fmul_rn(__fmul_rn(0.5f, gr), gr);
    const float half_pi = static_cast<float>(0.5 * 3.14159265358979323846);
    c = cosf(__fmul_rn(half_pi, theta));
    s = cosf(__fmul_rn(half_pi, __fsub_rn(1.f, theta)));
    stride = max(b, 1);
    if (n >= 8 * stride) {
      stride2 = 1;
      while ((stride2 * stride2 + stride2) * stride + (stride >> 2) < n)
        ++stride2;
    }
    len = n / stride;
  }
  __syncwarp();
  // pass A: in each block, stride2 chains with (s, c)
  if (rot)
    for (int q = gl; q < stride * stride2; q += G) {
      const int blk = q / stride2, r = q - blk * stride2;
      rot_chain(x + blk * len + r, stride2,
                (len - r + stride2 - 1) / stride2, s, c);
    }
  __syncwarp();
  // pass B: each block one chain with (c, s)
  if (rot)
    for (int blk = gl; blk < stride; blk += G)
      rot_chain(x + blk * len, 1, len, c, s);
  __syncwarp();
}

// A lane's leaf in a warp task (32 / G leaves of one tier): its tier in
// launch order (-1 past the last task), its place and its scalars.
struct Leaf {
  int t, leaf, s, n, k, b, spread;
  bool act;
  uint32_t idx;
  float gain;
  int64_t dst;
};

// The leaf of this lane in warp task `task`, its scalars asked for at
// once; tier -1 past the last task.
template <bool kValues>
__device__ Leaf load_leaf(const Stage& a, const Tier* tiers, int task,
                          int lane) {
  Leaf L{};
  L.t = -1;
  L.b = 1;
  int t = 0, first = task;
  while (t < a.tiers && first >= tiers[t].tasks) first -= tiers[t++].tasks;
  if (t == a.tiers) return L;
  L.t = t;
  const Tier& T = tiers[t];
  L.leaf = first * (32 / T.G) + lane / T.G;
  if (L.leaf >= a.S * T.slots) return L;   // past the tier's last leaf
  L.s = L.leaf / T.slots;
  const int slot = L.leaf - L.s * T.slots;
  L.act = at<bool>(T.active, L.s, slot);
  L.n = static_cast<int>(at<int64_t>(T.n, L.s, slot));
  L.k = static_cast<int>(at<int64_t>(T.k, L.s, slot));
  L.idx = static_cast<uint32_t>(at<int64_t>(T.idx, L.s, slot));
  if (kValues) {
    L.gain = at<float>(T.gain, L.s, slot);
    L.b = static_cast<int>(at<int64_t>(T.b, L.s, slot));
    L.spread = static_cast<int>(at<int64_t>(T.spread, L.s, slot));
    L.dst = at<int64_t>(T.dst, L.s, slot);
  }
  return L;
}

// The leaves of a launch, a warp task at a time; kValues: the whole stage
// into X, else the walk alone. The stage starts the table's copy as its block starts; the walk alone,
// whose planes are mostly idle slots (the lockstep emission's), only when
// a task of the block first walks, so that a block with none copies
// nothing and waits for nothing. Leaf rows lie nmax + 1 words apart in the
// stage (an odd stride spreads the groups' rows over the banks for the
// rotation) and nmax apart in the walk (whole rows copied to iy 16 bytes
// a lane).
template <bool kValues>
__device__ void run_leaves(const Stage& a) {
  constexpr bool kLazy = !kValues;
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);
  int32_t* table = reinterpret_cast<int32_t*>(smem + 16);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  int32_t* rows = table + a.packed_words + warp * a.row_words;
  // the tiers' planes from the launch's parameters into shared memory, a
  // word a thread: a task reads them there, not through a parameter load
  // at a run-time index
  __shared__ Tier tiers[kTiers];
  __shared__ int copying;   // the table's copy has been started
  constexpr int kTierWords = kTiers * sizeof(Tier) / 4;
  static_assert(kTierWords <= kThreads && sizeof(Tier) % 4 == 0, "");
  LEAF_PROBE(blockIdx.x * kWarps + warp, 0);
  if (threadIdx.x < kTierWords)
    reinterpret_cast<int32_t*>(tiers)[threadIdx.x] =
        reinterpret_cast<const int32_t*>(a.tier)[threadIdx.x];
  if (threadIdx.x == 0) copying = 0;
  init_table_barrier(bar);
  __syncthreads();
  if (!kLazy && threadIdx.x == 0)
    stage_table(bar, table, a.packed, a.packed_words);
  const uint32_t* ent = reinterpret_cast<const uint32_t*>(table + kHeader);
  bool staged = false;
  for (int task = blockIdx.x * kWarps + warp;; task += gridDim.x * kWarps) {
    LEAF_PROBE(task, 1);
    const Leaf cur = load_leaf<kValues>(a, tiers, task, lane);
    if (cur.t < 0) break;
    // a copy: the task's stores through generic pointers could otherwise
    // alias the shared tiers and have them read again after each one
    const Tier T = tiers[cur.t];
    const int G = T.G, nmax = T.nmax, n = cur.n, k = cur.k;
    const int group = lane / G, gl = lane - group * G;
    // the task's leaves, first .. first + count - 1, their rows rs words
    // apart; iy's rows, of nmax values, hold 16-byte units
    const int first = cur.leaf - group;
    const int count = min(32 / G, a.S * T.slots - first);
    const int rs = kValues ? nmax + 1 : nmax;
    int32_t* row = rows + group * rs;
    int4* iy4 = reinterpret_cast<int4*>(T.iy + static_cast<size_t>(first)
                                                   * nmax);
    const int units = count * nmax / 4;
    // a leaf the plan cannot hold (n past the tier or k past the table)
    // decodes to zeros, as an inactive one does
    const bool walk = cur.act && n >= 1 && n <= nmax && k >= 0 && k < kUK - 1;
    const bool any = __any_sync(0xffffffffu, walk);
    LEAF_PROBE(task, 2);
    if (!any) {
      // no leaf of the task walks: no values, zero pulse vectors
      if (T.iy != nullptr && kValues)
        for (int e = lane; e < count * nmax; e += 32)
          T.iy[static_cast<size_t>(first) * nmax + e] = 0;
      else if (T.iy != nullptr)
        for (int e = lane; e < units; e += 32) iy4[e] = make_int4(0, 0, 0, 0);
      LEAF_PROBE(task, 3);
      continue;
    }
    if (kValues)
      for (int e = lane; e < count * rs; e += 32) rows[e] = 0;
    else
      for (int e = lane; e < units; e += 32)
        reinterpret_cast<int4*>(rows)[e] = make_int4(0, 0, 0, 0);
    if (!staged) {
      if (kLazy) {
        if (lane == 0 && atomicExch(&copying, 1) == 0)
          stage_table(bar, table, a.packed, a.packed_words);
        __syncwarp();
      }
      wait_table(bar);
      staged = true;
    }
    __syncwarp();
    LEAF_PROBE(task, 4);
    const bool packed = walk && k + 2 <= table[n + 1] - table[n];
    int ryy = 0;
    if (nmax <= (kValues ? kStageLaneNmax : kWalkLaneNmax)) {
      if (walk && gl == 0)
        ryy = packed ? descend_lane<true>(table, ent, n, k, cur.idx, row)
                     : descend_lane<false>(nullptr, a.u, n, k, cur.idx, row);
      ryy = __shfl_sync(0xffffffffu, ryy, group * G);
    } else {
      const Table tab{packed ? table : nullptr, packed ? ent : a.u};
      ryy = descend(tab, walk, n, k, cur.idx, row, gl, G, group * G);
    }
    __syncwarp();
    LEAF_PROBE(task, 5);
    // the task's pulse vectors: one run of count * nmax values, read from
    // every row before any turns into values
    if (T.iy != nullptr) {
      if (kValues)
        for (int e = lane; e < count * nmax; e += 32)
          T.iy[static_cast<size_t>(first) * nmax + e] =
              rows[e / nmax * rs + e % nmax];
      else
        for (int e = lane; e < units; e += 32)
          iy4[e] = reinterpret_cast<const int4*>(rows)[e];
      __syncwarp();
    }
    LEAF_PROBE(task, 6);
    if (kValues) {
      // sum iy^2 is exact in int32 and in float32 (k <= 158 pulses)
      const float gain =
          ryy > 0 ? cur.gain / sqrtf(static_cast<float>(ryy)) : 0.f;
      float* x = reinterpret_cast<float*>(row);
      for (int i = gl; i < (walk ? n : 0); i += G) {
        const int v = row[i];
        x[i] = __fmul_rn(static_cast<float>(v), gain);
      }
      rotate(x, walk && 2 * k < n && cur.spread != 0, n, k, cur.b,
             cur.spread, gl, G);
      if (walk) {
        double* out = a.X + static_cast<size_t>(cur.s) * a.cols;
        for (int i = gl; i < n; i += G) {
          const int64_t pos = cur.dst + i;
          if (pos >= 0 && pos < a.cols) out[pos] = static_cast<double>(x[i]);
        }
      }
    }
    __syncwarp();   // the rows are the next task's
    LEAF_PROBE(task, 7);
  }
  // a thread with no task still waits: no copy outlives its block
  if (!kLazy && !staged) wait_table(bar);
  LEAF_PROBE(blockIdx.x * kWarps + warp, 8);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    pvq_leaf_stage_kernel(const __grid_constant__ Stage a) {
  run_leaves<true>(a);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    cwrs_walk_kernel(const __grid_constant__ Stage a) {
  run_leaves<false>(a);
}

// Sets each tier's G and tasks and the launch's row_words, sizes the grid
// to the blocks that fit on the SMs and launches; cudaErrorInvalidValue
// for a launch it does not take.
int launch(Stage a, bool values, cudaStream_t stream) {
  if (a.tiers < 1 || a.tiers > kTiers || a.S < 0 || a.packed_words < kHeader
      || a.packed_words % 4 != 0
      || reinterpret_cast<uintptr_t>(a.packed) % 16 != 0
      || (values && a.X == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  int total = 0;
  a.row_words = 0;
  for (int t = 0; t < a.tiers; ++t) {
    Tier& T = a.tier[t];
    if (T.nmax < 1 || T.nmax >= kUN || T.slots < 0
        || (!values && (T.nmax % 4 != 0
                        || reinterpret_cast<uintptr_t>(T.iy) % 16 != 0)))
      return static_cast<int>(cudaErrorInvalidValue);
    T.G = group_lanes(T.nmax, values);
    const int per_task = 32 / T.G;
    T.tasks = (a.S * T.slots + per_task - 1) / per_task;
    a.row_words = max(a.row_words, per_task * (T.nmax + (values ? 1 : 0)));
    total += T.tasks;
  }
  if (total == 0) return 0;
  const size_t bytes = 16 + 4 * (static_cast<size_t>(a.packed_words)
                                 + static_cast<size_t>(kWarps) * a.row_words);
  const void* kernel = values ? reinterpret_cast<const void*>(
                                    pvq_leaf_stage_kernel)
                              : reinterpret_cast<const void*>(
                                    cwrs_walk_kernel);
  int device, sms, per_sm;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  if (err == cudaSuccess)   // past 48 KB a launch must ask for it
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(bytes));
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks =
      min((total + kWarps - 1) / kWarps, max(1, sms * per_sm));
  if (values)
    pvq_leaf_stage_kernel<<<blocks, kThreads, bytes, stream>>>(a);
  else
    cwrs_walk_kernel<<<blocks, kThreads, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The leaf stage of one executor call: `stage` as ops/pvq_leaves.py builds
// it (X zeroed, tiers widest first, G, tasks and row_words left to this
// function). Launches on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for a launch it does not take.
extern "C" int mousiki_pvq_leaf_stage(const Stage* stage, void* stream) {
  return launch(*stage, true, static_cast<cudaStream_t>(stream));
}

// The walk alone over `leaves` leaves of one tier: active, n, k, idx
// contiguous, `leaves` values each; packed: the packed U table, its first
// packed_words staged (the rows up to nmax); utab: the (210, 160) u32
// table; iy: (leaves, nmax) int32 out, 16-byte aligned, every row
// written, nmax < 210 and a multiple of 4.
// Launches on `stream`; returns as mousiki_pvq_leaf_stage.
extern "C" int mousiki_cwrs_walk(const bool* active, const int64_t* n,
                                 const int64_t* k, const int64_t* idx,
                                 const int32_t* packed, int packed_words,
                                 const uint32_t* utab, int32_t* iy,
                                 int leaves, int nmax, void* stream) {
  Stage a = {};
  a.tiers = 1;
  a.S = 1;
  a.packed = packed;
  a.packed_words = packed_words;
  a.u = utab;
  Tier& T = a.tier[0];
  T.active = {active, 0, 1};
  T.n = {n, 0, 1};
  T.k = {k, 0, 1};
  T.idx = {idx, 0, 1};
  T.iy = iy;
  T.slots = leaves;
  T.nmax = nmax;
  return launch(a, false, static_cast<cudaStream_t>(stream));
}
