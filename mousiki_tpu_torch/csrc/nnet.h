// The layer arithmetic of the port's neural models (models/nnet.py) for the
// hand kernels of the neural loss recovery (fargan.h, rdovae.h): a dense
// layer's rows with its bias and the optional tri-diagonal `diag` shortcut,
// the activations, the GRU gates in libopus's z | r | h layout, the GLU and
// the streaming conv step, on layers packed by models/nnet.pack_layers.
//
// A packed layer (NnLayer) is a run of one float32 buffer: its weight
// stored transposed, w[k * n_out + r] the weight of input k in output row
// r (a warp's 32 rows read 128 contiguous bytes), then its bias and its
// diag, each at its own offset (-1 where the layer has none).
//
// Every output row sums its products in one fixed order, whatever the
// number of streams and whichever streams share the launch (the batch
// invariance of ROADMAP hazard g): NN_ACC partial sums, partial j over
// the inputs k = j, j + NN_ACC, j + 2 NN_ACC, ... in that order, each
// product rounded and then added; then the partials as the tree
// ((p0 + p1) + (p2 + p3)) + ((p4 + p5) + (p6 + p7)); then the bias, then
// diag[r] * x[r % n_in]. The partials of a layer are (j, r) items that a
// block's threads share in any way (nn_partials: on the device four
// neighbouring rows a thread, one 16-byte load of weights a step, a
// batch's NN_BATCH loads issued before its sums; on the host the rows
// innermost), so a thread's share of a layer changes no bit.
// The plain version (torch's products) sums in another order, so the two
// differ in the last bits.
//
// exp, tanh and sigmoid are computed here from + - * / and the bits of a
// power of two (nn_exp), because CUDA's expf / tanhf and glibc's differ in
// the last bit. Every float32 operation is one IEEE rounding: the __*_rn
// intrinsics on the device (never contracted into a fused multiply-add),
// plain operators on the host, where g++ builds the headers with
// -ffp-contract=off (ops/_build.HEADER_HOST_FLAGS); division stays IEEE. So
// the host build of a kernel's header gives the kernel's bits.
//
// NN_SYNC is the block's barrier on the device and nothing on the host,
// where one thread (tid 0 of nth 1) runs every item in turn.

#ifndef MOUSIKI_NNET_H_
#define MOUSIKI_NNET_H_

#include <stdint.h>
#if !defined(__CUDA_ARCH__)
#include <string.h>
#endif

#if defined(__CUDACC__)
#define NN_HD __host__ __device__ __forceinline__
#else
#define NN_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define NN_MUL(a, b) __fmul_rn(a, b)
#define NN_ADD(a, b) __fadd_rn(a, b)
#define NN_SUB(a, b) __fsub_rn(a, b)
#define NN_DIV(a, b) __fdiv_rn(a, b)
#define NN_SYNC() __syncthreads()
#else
#define NN_MUL(a, b) ((a) * (b))
#define NN_ADD(a, b) ((a) + (b))
#define NN_SUB(a, b) ((a) - (b))
#define NN_DIV(a, b) ((a) / (b))
#define NN_SYNC() ((void)0)
#endif

#define NN_ACC 8  // partial sums a row
// a thread's loads of weights issued together on the device: a kernel's
// header may set it before it includes this one (more loads in flight
// against the registers that two blocks an SM leave a thread)
#ifndef NN_BATCH
#define NN_BATCH 8
#endif

// activations (models/nnet.py ACTIVATION_*)
#define NN_LINEAR 0
#define NN_SIGMOID 1
#define NN_TANH 2

// One packed layer: offsets of its weight (transposed), bias and diag in
// floats (-1: none), its input and output widths.
struct NnLayer {
  int32_t w, b, d, n_in, n_out;
};
#define NN_LAYER_INTS 5

// A layer's input: x[k] = a[k] for k < na, b[k - na] beyond (a
// concatenation read in place; b may be null when na is the width).
struct NnIn {
  const float* a;
  int na;
  const float* b;
};

NN_HD NnIn nn_in(const float* a, int na) { return NnIn{a, na, nullptr}; }

NN_HD NnIn nn_in2(const float* a, int na, const float* b) {
  return NnIn{a, na, b};
}

NN_HD float nn_at(const NnIn& x, int k) {
  return k < x.na ? x.a[k] : x.b[k - x.na];
}

NN_HD NnLayer nn_layer(const int32_t* table, int i) {
  const int32_t* t = table + NN_LAYER_INTS * i;
  return NnLayer{t[0], t[1], t[2], t[3], t[4]};
}

// 2^n as a float for -126 <= n <= 127, from its bits.
NN_HD float nn_pow2i(int n) {
  const uint32_t bits = static_cast<uint32_t>(n + 127) << 23;
#if defined(__CUDA_ARCH__)
  return __uint_as_float(bits);
#else
  float f;
  memcpy(&f, &bits, sizeof f);
  return f;
#endif
}

// e^x within a few ulps: x clamped to [-87, 88] (where torch's result is
// finite and normal; outside, the two differ by less than 2e-38 or both
// saturate their callers), n = floor(x log2(e) + 1/2), r = x - n ln 2 in
// two steps (ln 2's high part has 12 trailing zero bits, so n * high is
// exact), e^r by its Taylor series to r^7 (|r| <= 0.35: the remainder is
// under 6e-9), scaled by 2^n.
NN_HD float nn_exp(float x) {
  x = x < -87.0f ? -87.0f : (x > 88.0f ? 88.0f : x);
  const float t = NN_ADD(NN_MUL(x, 1.44269502f), 0.5f);
  int n = static_cast<int>(t);
  if (static_cast<float>(n) > t) n -= 1;
  const float fn = static_cast<float>(n);
  float r = NN_SUB(x, NN_MUL(fn, 0.693145751953125f));
  r = NN_SUB(r, NN_MUL(fn, 1.42860677e-06f));
  float p = 1.98412701e-04f;                       // 1/5040
  p = NN_ADD(NN_MUL(p, r), 1.38888892e-03f);       // 1/720
  p = NN_ADD(NN_MUL(p, r), 8.33333377e-03f);       // 1/120
  p = NN_ADD(NN_MUL(p, r), 4.16666679e-02f);       // 1/24
  p = NN_ADD(NN_MUL(p, r), 1.66666672e-01f);       // 1/6
  p = NN_ADD(NN_MUL(p, r), 0.5f);
  p = NN_ADD(NN_MUL(p, r), 1.0f);
  p = NN_ADD(NN_MUL(p, r), 1.0f);
  return NN_MUL(p, nn_pow2i(n));
}

NN_HD float nn_sigmoid(float x) {
  return NN_DIV(1.0f, NN_ADD(1.0f, nn_exp(-x)));
}

// tanh(x) = sign(x) (1 - e) / (1 + e), e = e^(-2|x|): within 1e-7 of the
// true value (absolute), 1 where |x| > 9.
NN_HD float nn_tanh(float x) {
  const float a = x < 0.0f ? -x : x;
  float t = 1.0f;
  if (a <= 9.0f) {
    const float e = nn_exp(NN_MUL(-2.0f, a));
    t = NN_DIV(NN_SUB(1.0f, e), NN_ADD(1.0f, e));
  }
  return x < 0.0f ? -t : t;
}

NN_HD float nn_act(float y, int act) {
  if (act == NN_TANH) return nn_tanh(y);
  if (act == NN_SIGMOID) return nn_sigmoid(y);
  return y;
}

// The partial sums of layer L over input x: part[j * n_out + r] for the
// NN_ACC * n_out items (j, r), shared by threads tid of nth. A warp's
// consecutive items are consecutive rows of one j, so it reads 32
// contiguous weights a step.
NN_HD void nn_partials(const float* __restrict__ wts, const NnLayer& L,
                       const NnIn& x, float* part, int tid, int nth) {
  const int n = L.n_out;
  const float* __restrict__ w = wts + L.w;
#if !defined(__CUDA_ARCH__)
  // the host build's one thread: the rows innermost, each row's sums the
  // same adds in the same order, the weights read in their order
  (void)tid;
  (void)nth;
  for (int j = 0; j < NN_ACC; ++j) {
    float* acc = part + j * n;
    for (int r = 0; r < n; ++r) acc[r] = 0.0f;
    for (int k = j; k < L.n_in; k += NN_ACC) {
      const float xk = nn_at(x, k);
      const float* wk = w + k * n;
      for (int r = 0; r < n; ++r) acc[r] = NN_ADD(acc[r], NN_MUL(wk[r], xk));
    }
  }
#else
  if ((n & 3) == 0 && (L.w & 3) == 0) {
    // four rows a thread (n a multiple of 4, the run 16-byte aligned):
    // one 16-byte load of weights a step, four sums side by side
    const int n4 = n >> 2;
    for (int it = tid; it < NN_ACC * n4; it += nth) {
      const int j = it / n4, r = (it - j * n4) << 2;
      const float4* __restrict__ w4 =
          reinterpret_cast<const float4*>(w + r);
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
      for (int k0 = j; k0 < L.n_in; k0 += NN_BATCH * NN_ACC) {
        float4 v[NN_BATCH];
        float xs[NN_BATCH];
#pragma unroll
        for (int u = 0; u < NN_BATCH; ++u) {
          const int k = k0 + u * NN_ACC;
          if (k < L.n_in) {
            v[u] = __ldg(w4 + k * n4);
            xs[u] = nn_at(x, k);
          }
        }
#pragma unroll
        for (int u = 0; u < NN_BATCH; ++u) {
          if (k0 + u * NN_ACC < L.n_in) {
            a0 = NN_ADD(a0, NN_MUL(v[u].x, xs[u]));
            a1 = NN_ADD(a1, NN_MUL(v[u].y, xs[u]));
            a2 = NN_ADD(a2, NN_MUL(v[u].z, xs[u]));
            a3 = NN_ADD(a3, NN_MUL(v[u].w, xs[u]));
          }
        }
      }
      float* p = part + j * n + r;
      p[0] = a0;
      p[1] = a1;
      p[2] = a2;
      p[3] = a3;
    }
    return;
  }
  for (int it = tid; it < NN_ACC * n; it += nth) {
    const int j = it / n, r = it - j * n;
    float acc = 0.0f;
    for (int k0 = j; k0 < L.n_in; k0 += NN_BATCH * NN_ACC) {
      float v[NN_BATCH];
#pragma unroll
      for (int u = 0; u < NN_BATCH; ++u) {
        const int k = k0 + u * NN_ACC;
        if (k < L.n_in) v[u] = NN_MUL(__ldg(w + k * n + r), nn_at(x, k));
      }
#pragma unroll
      for (int u = 0; u < NN_BATCH; ++u)
        if (k0 + u * NN_ACC < L.n_in) acc = NN_ADD(acc, v[u]);
    }
    part[it] = acc;
  }
#endif
}

// Row r of layer L from its partials: the partials' tree, the bias, and
// (use_diag) diag[r] * x[r % n_in], as models/nnet.linear.
NN_HD float nn_row(const float* __restrict__ wts, const NnLayer& L,
                   const float* part, const NnIn& x, int r,
                   bool use_diag = true) {
  const int n = L.n_out;
  const float* p = part + r;
  const float s01 = NN_ADD(p[0], p[n]), s23 = NN_ADD(p[2 * n], p[3 * n]);
  const float s45 = NN_ADD(p[4 * n], p[5 * n]);
  const float s67 = NN_ADD(p[6 * n], p[7 * n]);
  float y = NN_ADD(NN_ADD(s01, s23), NN_ADD(s45, s67));
  if (L.b >= 0) y = NN_ADD(y, wts[L.b + r]);
  if (use_diag && L.d >= 0)
    y = NN_ADD(y, NN_MUL(wts[L.d + r], nn_at(x, r % L.n_in)));
  return y;
}

// A dense layer whole: out[r] = act(L(x))[r] (out must not alias x or
// part). Ends at a barrier.
NN_HD void nn_dense(const float* __restrict__ wts, const NnLayer& L,
                    const NnIn& x, int act, float* out, float* part,
                    int tid, int nth, bool use_diag = true) {
  nn_partials(wts, L, x, part, tid, nth);
  NN_SYNC();
  for (int r = tid; r < L.n_out; r += nth)
    out[r] = nn_act(nn_row(wts, L, part, x, r, use_diag), act);
  NN_SYNC();
}

// The GRU's partials: its input layer over x into part_i, its recurrent
// layer over the state h into part_r. No barrier.
NN_HD void nn_gru_partials(const float* __restrict__ wts, const NnLayer& Li,
                           const NnLayer& Lr, const NnIn& x, const float* h,
                           float* part_i, float* part_r, int tid, int nth) {
  nn_partials(wts, Li, x, part_i, tid, nth);
  nn_partials(wts, Lr, nn_in(h, Lr.n_in), part_r, tid, nth);
}

// Unit j of the GRU's new state from its partials (models/nnet.gru):
// z = sigmoid(zi + zr), r = sigmoid(ri + rr), c = tanh(hi + r * hr),
// z * h + (1 - z) * c.
NN_HD float nn_gru_unit(const float* __restrict__ wts, const NnLayer& Li,
                        const NnLayer& Lr, const NnIn& x, const float* h,
                        const float* part_i, const float* part_r, int j) {
  const int n = Lr.n_in;
  const NnIn hin = nn_in(h, n);
  const float z = nn_sigmoid(NN_ADD(nn_row(wts, Li, part_i, x, j),
                                    nn_row(wts, Lr, part_r, hin, j)));
  const float r = nn_sigmoid(NN_ADD(nn_row(wts, Li, part_i, x, n + j),
                                    nn_row(wts, Lr, part_r, hin, n + j)));
  const float c = nn_tanh(
      NN_ADD(nn_row(wts, Li, part_i, x, 2 * n + j),
             NN_MUL(r, nn_row(wts, Lr, part_r, hin, 2 * n + j))));
  return NN_ADD(NN_MUL(z, h[j]), NN_MUL(NN_SUB(1.0f, z), c));
}

// A GRU step whole, into out (which may be h itself: each unit reads its
// own h[j] before it writes out[j], after every partial has read h). Ends
// at a barrier.
NN_HD void nn_gru(const float* __restrict__ wts, const NnLayer& Li,
                  const NnLayer& Lr, const NnIn& x, float* h, float* out,
                  float* part_i, float* part_r, int tid, int nth) {
  nn_gru_partials(wts, Li, Lr, x, h, part_i, part_r, tid, nth);
  NN_SYNC();
  for (int j = tid; j < Lr.n_in; j += nth)
    out[j] = nn_gru_unit(wts, Li, Lr, x, h, part_i, part_r, j);
  NN_SYNC();
}

// GLU: out[r] = x[r] * sigmoid(L(x))[r] (models/nnet.glu), also into out2
// where it is not null. Ends at a barrier.
NN_HD void nn_glu(const float* __restrict__ wts, const NnLayer& L,
                  const float* x, float* out, float* out2, float* part,
                  int tid, int nth) {
  const NnIn in = nn_in(x, L.n_in);
  nn_partials(wts, L, in, part, tid, nth);
  NN_SYNC();
  for (int r = tid; r < L.n_out; r += nth) {
    const float y = NN_MUL(x[r], nn_sigmoid(nn_row(wts, L, part, in, r)));
    out[r] = y;
    if (out2 != nullptr) out2[r] = y;
  }
  NN_SYNC();
}

#endif  // MOUSIKI_NNET_H_
