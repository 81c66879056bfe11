// The row arithmetic of the CELT concealment (ops/plc.py), the parts that do
// not depend on how a kernel lays out its threads: one Levinson iteration
// given its float64 dot, one residual sample, the decay and attenuation of
// the excitation, one LPC synthesis step given its float64 sum.
//
// Each function rounds where the plain version (ops/plc.plc_rows_reference,
// eager PyTorch) rounds, and nowhere else: every float32 and float64 add,
// subtract, multiply and divide is a separate rounding (the __*_rn
// intrinsics on the device, plain operators on the host, where the header
// is compiled by g++ with -ffp-contract=off so that no multiply and add are
// fused). csrc/plc_rows.cu includes it for plc_rows_kernel; with
// PLC_ROWS_HOST_API defined, g++ builds it alone into a host library whose
// array entry points the CPU tests call through ctypes
// (ops/_build.build_plc_rows_host).

#ifndef MOUSIKI_PLC_ROWS_H_
#define MOUSIKI_PLC_ROWS_H_

#include <math.h>

#if defined(__CUDACC__)
#define PLC_HD __host__ __device__ __forceinline__
#else
#define PLC_HD inline
#endif

#if defined(__CUDA_ARCH__)
#define PLC_FMUL(a, b) __fmul_rn(a, b)
#define PLC_FADD(a, b) __fadd_rn(a, b)
#define PLC_FSUB(a, b) __fsub_rn(a, b)
#define PLC_FDIV(a, b) __fdiv_rn(a, b)
#define PLC_FSQRT(a) __fsqrt_rn(a)
#define PLC_DMUL(a, b) __dmul_rn(a, b)
#define PLC_DADD(a, b) __dadd_rn(a, b)
#define PLC_DSUB(a, b) __dsub_rn(a, b)
#else
#define PLC_FMUL(a, b) ((a) * (b))
#define PLC_FADD(a, b) ((a) + (b))
#define PLC_FSUB(a, b) ((a) - (b))
#define PLC_FDIV(a, b) ((a) / (b))
#define PLC_FSQRT(a) sqrtf(a)
#define PLC_DMUL(a, b) ((a) * (b))
#define PLC_DADD(a, b) ((a) + (b))
#define PLC_DSUB(a, b) ((a) - (b))
#endif

// CELT_LPC_ORDER, and the history the fit and the residual read
// (COMBFILTER_MAXPERIOD)
#define PLC_ORDER 24
#define PLC_HIST 1024

// x clamped to [lo, hi] as torch.clamp does it: a NaN stays NaN
PLC_HD float plc_clampf(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// ac[0] with the decoder's noise floor: ac0 * 1.0001 + 1e-9 * HIST in
// float32 (torch computes a float32 tensor with a Python scalar in float32)
PLC_HD float plc_noise_floor(float ac0) {
  return PLC_FADD(PLC_FMUL(ac0, 1.0001f),
                  static_cast<float>(1e-9 * PLC_HIST));
}

// Levinson iteration i: k = clamp((f32)(ac[i + 1] - dot) / max(err,
// 1e-12), -0.98, 0.98), dot = sum_{j < i} a[j] * ac[i - j] in float64
PLC_HD float plc_levinson_k(double ac_next, double dot, float err) {
  const float acc = static_cast<float>(PLC_DSUB(ac_next, dot));
  const float den = err < 1e-12f ? 1e-12f : err;
  return plc_clampf(PLC_FDIV(acc, den), -0.98f, 0.98f);
}

// the update of a[j], j < i: a[j] - k * a[i - 1 - j]
PLC_HD float plc_levinson_coef(float aj, float arev, float k) {
  return PLC_FSUB(aj, PLC_FMUL(k, arev));
}

// the prediction error after iteration i: err * (1 - k * k)
PLC_HD float plc_levinson_err(float err, float k) {
  return PLC_FMUL(err, PLC_FSUB(1.0f, PLC_FMUL(k, k)));
}

// residual sample i of the row x (PLC_HIST samples) through the LPC a:
// x[i] - a[0] x[i - 1] - ... - a[23] x[i - 24], a product and a subtraction
// a tap in that order, the samples before the row 0.0
PLC_HD float plc_residual(const float* x, const float* a, int i) {
  float acc = x[i];
#pragma unroll
  for (int j = 0; j < PLC_ORDER; ++j) {
    const float xv = i - 1 - j >= 0 ? x[i - 1 - j] : 0.0f;
    acc = PLC_FSUB(acc, PLC_FMUL(a[j], xv));
  }
  return acc;
}

// sqrt(min(1, e1 / max(e2', 1e-9))), e2' = e2 where two pitch periods fit
// in the history, else e1
PLC_HD float plc_decay(float e1, float e2, bool has2) {
  const float d = has2 ? e2 : e1;
  const float r = PLC_FDIV(e1, d < 1e-9f ? 1e-9f : d);
  return PLC_FSQRT(r > 1.0f ? 1.0f : r);
}

// log(max(decay, 1e-9)), full-precision logf
PLC_HD float plc_log_decay(float decay) {
  return logf(decay < 1e-9f ? 1e-9f : decay);
}

// the attenuation of the excitation's period `period`: fade * exp(logd *
// period), full-precision expf
PLC_HD float plc_atten(float fade, float logd, int period) {
  return PLC_FMUL(fade, expf(PLC_FMUL(logd, static_cast<float>(period))));
}

// one LPC synthesis output: the excitation plus the float64 sum of the
// window's products, clamped to the decoder's +-65536 in float64, rounded
// to float32 once
PLC_HD float plc_synth(double sum, float exc) {
  double v = PLC_DADD(static_cast<double>(exc), sum);
  v = v < -65536.0 ? -65536.0 : (v > 65536.0 ? 65536.0 : v);
  return static_cast<float>(v);
}

#if defined(PLC_ROWS_HOST_API)
// Array entry points of the host build (ctypes), element by element.
extern "C" {

void plc_host_noise_floor(const float* ac0, float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = plc_noise_floor(ac0[i]);
}

void plc_host_levinson(const double* ac_next, const double* dot,
                       const float* err, float* k, float* err_out, long n) {
  for (long i = 0; i < n; ++i) {
    k[i] = plc_levinson_k(ac_next[i], dot[i], err[i]);
    err_out[i] = plc_levinson_err(err[i], k[i]);
  }
}

void plc_host_levinson_coef(const float* aj, const float* arev,
                            const float* k, float* out, long n) {
  for (long i = 0; i < n; ++i)
    out[i] = plc_levinson_coef(aj[i], arev[i], k[i]);
}

// rows: (rows, PLC_HIST) samples, a: (rows, PLC_ORDER), out as rows
void plc_host_residual(const float* rows, const float* a, float* out,
                       long n_rows) {
  for (long r = 0; r < n_rows; ++r)
    for (int i = 0; i < PLC_HIST; ++i)
      out[r * PLC_HIST + i] =
          plc_residual(rows + r * PLC_HIST, a + r * PLC_ORDER, i);
}

void plc_host_decay(const float* e1, const float* e2,
                    const unsigned char* has2, float* decay, float* logd,
                    long n) {
  for (long i = 0; i < n; ++i) {
    decay[i] = plc_decay(e1[i], e2[i], has2[i] != 0);
    logd[i] = plc_log_decay(decay[i]);
  }
}

void plc_host_atten(const float* fade, const float* logd, const int* period,
                    float* out, long n) {
  for (long i = 0; i < n; ++i)
    out[i] = plc_atten(fade[i], logd[i], period[i]);
}

void plc_host_synth(const double* sum, const float* exc, float* out, long n) {
  for (long i = 0; i < n; ++i) out[i] = plc_synth(sum[i], exc[i]);
}

}  // extern "C"
#endif  // PLC_ROWS_HOST_API

#endif  // MOUSIKI_PLC_ROWS_H_
