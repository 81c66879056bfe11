// The arithmetic of the neural concealment kernel (models/fargan.
// conceal_frames), one stream at a time: for F frames of 10 ms, PitchDNN's
// period (models/deep_plc.compute_pitchdnn), FARGAN's conditioning
// (models/fargan.compute_cond) and four 40-sample subframes of its signal
// network (models/fargan.run_subframe), the de-emphasis among them, on the
// layers of nnet.h.
//
// A stream's state and activations live in a FarganWork (shared memory on
// the device); each layer's rows go over the block's threads (nnet.h), and
// its weights are read from the packed buffers (L2 on the card: the packed
// FARGAN is 3.84 MB, PitchDNN 0.1 MB). Inputs are laid out so that each
// concatenation of the plain version is one run of the work, or two runs
// read in place: fin = [cond | pred | prev] (the fwc0 conv's input), skip =
// [g2_base | g3_base | g3_out | x | gate * pshift | prev] (the skip dense's
// input; its last 336 floats, with gate 0's pitch, are GRU 1's input), gin
// = [g_base | gate * pshift | prev] (GRU 2's and 3's), cbuf = [conv memory
// | dense 1's output] (the conv's). The gain depends only on the frame's
// conditioning, so it is computed once a frame (the plain version computes
// the same value in each subframe). The de-emphasis runs as the
// reference's recurrence, y[n] = x[n] + 0.85 y[n-1], on one thread.
//
// hold: PitchDNN runs once, on frame 0's features, and its period and those
// features drive every frame (DeepPlcState.conceal's route); otherwise it
// runs on each frame's features. Outputs: the PCM (times active[s] where
// active is given), each frame's float period, and the new state.
//
// csrc/fargan.cu includes this header for fargan_conceal_kernel; with
// FARGAN_HOST_API defined, g++ builds it alone into a host library whose
// entry point runs the streams one after another with one thread
// (ops/_build.build_header_host).

#ifndef MOUSIKI_FARGAN_H_
#define MOUSIKI_FARGAN_H_

#include <stdint.h>

// four loads of weights issued together a thread: 64 registers, so that
// two blocks share an SM where the streams outnumber the SMs (eight: 100
// registers, one block an SM; on an H100 at S = 256, 1.07 ms a call of two
// frames beside 0.69, and 0.51 beside 0.58 at S = 64)
#define NN_BATCH 4
#include "nnet.h"

#define FARGAN_FEATURES 20
#define FARGAN_EMBED 12
#define FARGAN_COND 256
#define FARGAN_GRU 128
#define FARGAN_SUB 40
#define FARGAN_NB_SUB 4
#define FARGAN_FRAME (FARGAN_SUB * FARGAN_NB_SUB)
#define FARGAN_PITCH_MAX 256
#define FARGAN_PRED (FARGAN_SUB + 4)
#define FARGAN_FWC0_IN (FARGAN_COND + FARGAN_PRED + FARGAN_SUB)          // 340
#define FARGAN_SKIP_IN (3 * FARGAN_GRU + FARGAN_COND + 2 * FARGAN_SUB)   // 720
#define FARGAN_GIN (FARGAN_GRU + 2 * FARGAN_SUB)                         // 208
#define FARGAN_PITCH_GRU 64

// the FARGAN buffer's layers, in models/fargan.LAYERS's order, then the
// period embedding (n_in the embedding width, n_out the periods; stored
// row by row, not transposed)
enum FarganLayer {
  kFdense1, kFconv1, kFdense2, kGainDense, kFwc0Conv, kFwc0Glu, kGru1In,
  kGru1Rec, kGru1Glu, kGru2In, kGru2Rec, kGru2Glu, kGru3In, kGru3Rec,
  kGru3Glu, kSkipDense, kSkipGlu, kSigDenseOut, kGainDenseOut, kPembed,
  kFarganLayers
};
// the PitchDNN buffer's layers
enum PitchLayer { kPitchIn, kPitchGruIn, kPitchGruRec, kPitchOut,
                  kPitchLayers };

// the pointers of a call, in this order: inputs (each with its stream
// stride, rows contiguous), then outputs (contiguous)
enum FarganArg {
  kFeats, kActive, kPitchBuf, kConvMem, kGru1, kGru2, kGru3, kDeemph,
  kPitchState, kFarganInputs,
  kPcm = kFarganInputs, kPeriods, kPitchBufOut, kConvMemOut, kGru1Out,
  kGru2Out, kGru3Out, kDeemphOut, kPitchStateOut, kFarganArgs
};

struct FarganArgs {
  const float* fw;               // the packed FARGAN
  const float* pw;               // the packed PitchDNN
  NnLayer fl[kFarganLayers];
  NnLayer pl[kPitchLayers];
  const float* in[kFarganInputs];
  int64_t stride[kFarganInputs];
  float* out[kFarganArgs - kFarganInputs];
  int frames;                    // F
  int hold;
};

// The layers' widths the kernel takes (the defaults of models/fargan.
// random_model and from_blob, and PitchDNN's).
NN_HD bool fargan_layers_ok(const NnLayer* fl, const NnLayer* pl) {
  const int want[kFarganLayers - 1][2] = {
      {FARGAN_FEATURES + FARGAN_EMBED, FARGAN_COND},
      {2 * FARGAN_COND, FARGAN_COND}, {FARGAN_COND, FARGAN_COND},
      {FARGAN_COND, 1}, {FARGAN_FWC0_IN, FARGAN_COND},
      {FARGAN_COND, FARGAN_COND},
      {FARGAN_COND + 2 * FARGAN_SUB, 3 * FARGAN_GRU},
      {FARGAN_GRU, 3 * FARGAN_GRU}, {FARGAN_GRU, FARGAN_GRU},
      {FARGAN_GIN, 3 * FARGAN_GRU}, {FARGAN_GRU, 3 * FARGAN_GRU},
      {FARGAN_GRU, FARGAN_GRU}, {FARGAN_GIN, 3 * FARGAN_GRU},
      {FARGAN_GRU, 3 * FARGAN_GRU}, {FARGAN_GRU, FARGAN_GRU},
      {FARGAN_SKIP_IN, FARGAN_GRU}, {FARGAN_GRU, FARGAN_GRU},
      {FARGAN_GRU, FARGAN_SUB}, {FARGAN_COND, 4}};
  for (int i = 0; i < kFarganLayers - 1; ++i)
    if (fl[i].n_in != want[i][0] || fl[i].n_out != want[i][1]) return false;
  if (fl[kPembed].n_in != FARGAN_EMBED || fl[kPembed].n_out < 1)
    return false;
  const int pwant[kPitchLayers][2] = {
      {FARGAN_FEATURES, FARGAN_PITCH_GRU},
      {FARGAN_PITCH_GRU, 3 * FARGAN_PITCH_GRU},
      {FARGAN_PITCH_GRU, 3 * FARGAN_PITCH_GRU}, {FARGAN_PITCH_GRU, 1}};
  for (int i = 0; i < kPitchLayers; ++i)
    if (pl[i].n_in != pwant[i][0] || pl[i].n_out != pwant[i][1]) return false;
  return true;
}

// ptrs: kFarganArgs pointers in FarganArg's order (active may be null),
// strides the inputs' stream strides, tables the layers' NnLayer ints.
NN_HD FarganArgs fargan_args(const float* fw, const int32_t* ftab,
                             const float* pw, const int32_t* ptab,
                             void* const* ptrs, const int64_t* strides,
                             int frames, int hold) {
  FarganArgs g;
  g.fw = fw;
  g.pw = pw;
  for (int i = 0; i < kFarganLayers; ++i) g.fl[i] = nn_layer(ftab, i);
  for (int i = 0; i < kPitchLayers; ++i) g.pl[i] = nn_layer(ptab, i);
  for (int i = 0; i < kFarganInputs; ++i) {
    g.in[i] = static_cast<const float*>(ptrs[i]);
    g.stride[i] = strides[i];
  }
  for (int i = kFarganInputs; i < kFarganArgs; ++i)
    g.out[i - kFarganInputs] = static_cast<float*>(ptrs[i]);
  g.frames = frames;
  g.hold = hold;
  return g;
}

// A stream's state and activations.
struct FarganWork {
  float part_a[NN_ACC * 3 * FARGAN_GRU];   // a layer's partials
  float part_b[NN_ACC * 3 * FARGAN_GRU];   // a GRU's recurrent partials
  float pitch_buf[FARGAN_PITCH_MAX];
  float cbuf[2 * FARGAN_COND];             // conv memory | dense 1's out
  float gru[3][FARGAN_GRU];
  float pgru[FARGAN_PITCH_GRU];
  float ph[FARGAN_PITCH_GRU];              // PitchDNN's dense in
  float fe[FARGAN_FEATURES + FARGAN_EMBED];  // features | embedding
  float fin[FARGAN_FWC0_IN];               // cond | pred | prev
  float xa[FARGAN_COND];                   // fwc0 conv out; conv out
  float skip[FARGAN_SKIP_IN];
  float gin[FARGAN_GIN];
  float ta[FARGAN_GRU], tb[FARGAN_GRU];    // skip dense, skip GLU
  float pcm[FARGAN_SUB];
  float gate[4];
  float gain, gain_inv, deemph, period_f;
  int period;
};

// The offsets in skip of its runs.
#define FARGAN_SKIP_X (3 * FARGAN_GRU)                      // 384
#define FARGAN_SKIP_PS (FARGAN_SKIP_X + FARGAN_COND)        // 640
#define FARGAN_SKIP_PREV (FARGAN_SKIP_PS + FARGAN_SUB)      // 680

// PitchDNN on w.fe's features: w.pgru advances; w.period_f and w.period
// set. Ends at a barrier.
NN_HD void fargan_pitch(const FarganArgs& g, FarganWork& w, int tid,
                        int nth) {
  const float* pw = g.pw;
  nn_dense(pw, g.pl[kPitchIn], nn_in(w.fe, FARGAN_FEATURES), NN_TANH, w.ph,
           w.part_a, tid, nth);
  nn_gru(pw, g.pl[kPitchGruIn], g.pl[kPitchGruRec],
         nn_in(w.ph, FARGAN_PITCH_GRU), w.pgru, w.pgru, w.part_a, w.part_b,
         tid, nth);
  const NnIn h = nn_in(w.pgru, FARGAN_PITCH_GRU);
  nn_partials(pw, g.pl[kPitchOut], h, w.part_a, tid, nth);
  NN_SYNC();
  if (tid == 0) {
    const float raw = nn_row(pw, g.pl[kPitchOut], w.part_a, h, 0);
    float t = NN_MUL(0.5f, NN_ADD(raw, 1.0f));
    t = t < 0.0f ? 0.0f : (t > 1.0f ? 1.0f : t);
    const float pf = NN_ADD(32.0f, NN_MUL(224.0f, t));
    w.period_f = pf;
    w.period = static_cast<int>(pf);
  }
  NN_SYNC();
}

// compute_cond on w.fe's features and w.period: cond into fin[0:256], the
// conv memory advanced, and the frame's gain. Ends at a barrier.
NN_HD void fargan_cond(const FarganArgs& g, FarganWork& w, int tid,
                       int nth) {
  const float* fw = g.fw;
  const NnLayer& pe = g.fl[kPembed];
  int idx = w.period - 32;
  idx = idx < 0 ? 0 : (idx > pe.n_out - 1 ? pe.n_out - 1 : idx);
  for (int c = tid; c < FARGAN_EMBED; c += nth)
    w.fe[FARGAN_FEATURES + c] = fw[pe.w + idx * FARGAN_EMBED + c];
  NN_SYNC();
  nn_dense(fw, g.fl[kFdense1], nn_in(w.fe, FARGAN_FEATURES + FARGAN_EMBED),
           NN_TANH, w.cbuf + FARGAN_COND, w.part_a, tid, nth);
  nn_dense(fw, g.fl[kFconv1], nn_in(w.cbuf, 2 * FARGAN_COND), NN_TANH, w.xa,
           w.part_a, tid, nth, false);
  for (int i = tid; i < FARGAN_COND; i += nth)
    w.cbuf[i] = w.cbuf[FARGAN_COND + i];
  nn_dense(fw, g.fl[kFdense2], nn_in(w.xa, FARGAN_COND), NN_TANH, w.fin,
           w.part_a, tid, nth);
  const NnIn cond = nn_in(w.fin, FARGAN_COND);
  nn_partials(fw, g.fl[kGainDense], cond, w.part_a, tid, nth);
  NN_SYNC();
  if (tid == 0) {
    const float gain =
        nn_exp(nn_row(fw, g.fl[kGainDense], w.part_a, cond, 0));
    w.gain = gain;
    w.gain_inv = NN_DIV(1.0f, NN_ADD(1e-5f, gain));
  }
  NN_SYNC();
}

NN_HD float fargan_clamp1(float v) {
  return v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
}

// run_subframe: 40 samples of PCM into pcm_out (times act where act is not
// null), the state advanced. Ends at a barrier.
NN_HD void fargan_subframe(const FarganArgs& g, FarganWork& w,
                           float* pcm_out, const float* act, int tid,
                           int nth) {
  const float* fw = g.fw;
  const float* pshift = w.fin + FARGAN_COND + 2;
  // the pitch prediction and the previous subframe, scaled and clipped
  for (int i = tid; i < FARGAN_PRED; i += nth) {
    int pos = FARGAN_PITCH_MAX - w.period - 2 + i;
    if (pos >= FARGAN_PITCH_MAX) pos -= w.period;
    pos = pos < 0 ? 0 : (pos > FARGAN_PITCH_MAX - 1 ? FARGAN_PITCH_MAX - 1
                                                     : pos);
    w.fin[FARGAN_COND + i] =
        fargan_clamp1(NN_MUL(w.gain_inv, w.pitch_buf[pos]));
  }
  for (int i = tid; i < FARGAN_SUB; i += nth) {
    const float v = fargan_clamp1(
        NN_MUL(w.gain_inv, w.pitch_buf[FARGAN_PITCH_MAX - FARGAN_SUB + i]));
    w.fin[FARGAN_COND + FARGAN_PRED + i] = v;
    w.skip[FARGAN_SKIP_PREV + i] = v;
    w.gin[FARGAN_GRU + FARGAN_SUB + i] = v;
  }
  NN_SYNC();
  // framewise conv + GLU, the pitch gates
  nn_dense(fw, g.fl[kFwc0Conv], nn_in(w.fin, FARGAN_FWC0_IN), NN_TANH, w.xa,
           w.part_a, tid, nth, false);
  float* x = w.skip + FARGAN_SKIP_X;
  nn_glu(fw, g.fl[kFwc0Glu], w.xa, x, nullptr, w.part_a, tid, nth);
  nn_dense(fw, g.fl[kGainDenseOut], nn_in(x, FARGAN_COND), NN_SIGMOID,
           w.gate, w.part_a, tid, nth);
  for (int i = tid; i < FARGAN_SUB; i += nth)
    w.skip[FARGAN_SKIP_PS + i] = NN_MUL(w.gate[0], pshift[i]);
  NN_SYNC();
  // three GRUs, each with its GLU and its gated pitch
  nn_gru(fw, g.fl[kGru1In], g.fl[kGru1Rec],
         nn_in(x, FARGAN_COND + 2 * FARGAN_SUB), w.gru[0], w.gru[0],
         w.part_a, w.part_b, tid, nth);
  for (int i = tid; i < FARGAN_SUB; i += nth)
    w.gin[FARGAN_GRU + i] = NN_MUL(w.gate[1], pshift[i]);
  nn_glu(fw, g.fl[kGru1Glu], w.gru[0], w.skip, w.gin, w.part_a, tid, nth);
  nn_gru(fw, g.fl[kGru2In], g.fl[kGru2Rec], nn_in(w.gin, FARGAN_GIN),
         w.gru[1], w.gru[1], w.part_a, w.part_b, tid, nth);
  for (int i = tid; i < FARGAN_SUB; i += nth)
    w.gin[FARGAN_GRU + i] = NN_MUL(w.gate[2], pshift[i]);
  nn_glu(fw, g.fl[kGru2Glu], w.gru[1], w.skip + FARGAN_GRU, w.gin, w.part_a,
         tid, nth);
  nn_gru(fw, g.fl[kGru3In], g.fl[kGru3Rec], nn_in(w.gin, FARGAN_GIN),
         w.gru[2], w.gru[2], w.part_a, w.part_b, tid, nth);
  for (int i = tid; i < FARGAN_SUB; i += nth)
    w.skip[FARGAN_SKIP_PS + i] = NN_MUL(w.gate[3], pshift[i]);
  nn_glu(fw, g.fl[kGru3Glu], w.gru[2], w.skip + 2 * FARGAN_GRU, nullptr,
         w.part_a, tid, nth);
  // skip dense + GLU, the output dense times the gain
  nn_dense(fw, g.fl[kSkipDense], nn_in(w.skip, FARGAN_SKIP_IN), NN_TANH,
           w.ta, w.part_a, tid, nth);
  nn_glu(fw, g.fl[kSkipGlu], w.ta, w.tb, nullptr, w.part_a, tid, nth);
  const NnIn tb = nn_in(w.tb, FARGAN_GRU);
  nn_partials(fw, g.fl[kSigDenseOut], tb, w.part_a, tid, nth);
  NN_SYNC();
  for (int r = tid; r < FARGAN_SUB; r += nth)
    w.pcm[r] = NN_MUL(
        nn_tanh(nn_row(fw, g.fl[kSigDenseOut], w.part_a, tb, r)), w.gain);
  NN_SYNC();
  // the pitch buffer shifts in the new PCM (through part_a, free now); the
  // de-emphasis
  for (int i = tid; i < FARGAN_PITCH_MAX; i += nth)
    w.part_a[i] = i < FARGAN_PITCH_MAX - FARGAN_SUB
                      ? w.pitch_buf[i + FARGAN_SUB]
                      : w.pcm[i - (FARGAN_PITCH_MAX - FARGAN_SUB)];
  NN_SYNC();
  for (int i = tid; i < FARGAN_PITCH_MAX; i += nth)
    w.pitch_buf[i] = w.part_a[i];
  if (tid == 0) {
    float carry = w.deemph;
    for (int n = 0; n < FARGAN_SUB; ++n) {
      carry = NN_ADD(w.pcm[n], NN_MUL(0.85f, carry));
      pcm_out[n] = act != nullptr ? NN_MUL(carry, *act) : carry;
    }
    w.deemph = carry;
  }
  NN_SYNC();
}

// Stream s whole: the state in, F frames, the state out.
NN_HD void fargan_stream(const FarganArgs& g, int s, FarganWork& w, int tid,
                         int nth) {
  const float* const* in = g.in;
  const int64_t* st = g.stride;
  for (int i = tid; i < FARGAN_PITCH_MAX; i += nth)
    w.pitch_buf[i] = in[kPitchBuf][s * st[kPitchBuf] + i];
  for (int i = tid; i < FARGAN_COND; i += nth)
    w.cbuf[i] = in[kConvMem][s * st[kConvMem] + i];
  for (int k = 0; k < 3; ++k)
    for (int i = tid; i < FARGAN_GRU; i += nth)
      w.gru[k][i] = in[kGru1 + k][s * st[kGru1 + k] + i];
  for (int i = tid; i < FARGAN_PITCH_GRU; i += nth)
    w.pgru[i] = in[kPitchState][s * st[kPitchState] + i];
  if (tid == 0) w.deemph = in[kDeemph][s * st[kDeemph]];
  const float* act =
      in[kActive] != nullptr ? in[kActive] + s * st[kActive] : nullptr;
  const int F = g.frames;
  float* const* out = g.out;
  for (int f = 0; f < F || (g.hold && f == 0); ++f) {
    if (!g.hold || f == 0) {
      const float* feat =
          in[kFeats] + s * st[kFeats] + (g.hold ? 0 : f) * FARGAN_FEATURES;
      for (int i = tid; i < FARGAN_FEATURES; i += nth) w.fe[i] = feat[i];
      NN_SYNC();
      fargan_pitch(g, w, tid, nth);
    }
    if (f >= F) break;
    if (tid == 0) out[kPeriods - kFarganInputs][s * F + f] = w.period_f;
    fargan_cond(g, w, tid, nth);
    for (int k = 0; k < FARGAN_NB_SUB; ++k)
      fargan_subframe(
          g, w,
          out[kPcm - kFarganInputs] + (s * F + f) * FARGAN_FRAME +
              k * FARGAN_SUB,
          act, tid, nth);
  }
  for (int i = tid; i < FARGAN_PITCH_MAX; i += nth)
    out[kPitchBufOut - kFarganInputs][s * FARGAN_PITCH_MAX + i] =
        w.pitch_buf[i];
  for (int i = tid; i < FARGAN_COND; i += nth)
    out[kConvMemOut - kFarganInputs][s * FARGAN_COND + i] = w.cbuf[i];
  for (int k = 0; k < 3; ++k)
    for (int i = tid; i < FARGAN_GRU; i += nth)
      out[kGru1Out - kFarganInputs + k][s * FARGAN_GRU + i] = w.gru[k][i];
  for (int i = tid; i < FARGAN_PITCH_GRU; i += nth)
    out[kPitchStateOut - kFarganInputs][s * FARGAN_PITCH_GRU + i] =
        w.pgru[i];
  if (tid == 0) out[kDeemphOut - kFarganInputs][s] = w.deemph;
}

#if defined(FARGAN_HOST_API)
#include <stdlib.h>

// Entry point of the host build (ctypes): the streams one after another,
// with one thread. Returns 0, or -1 for layers it does not take.
extern "C" int fargan_conceal_host(const float* fw, const int32_t* ftab,
                                   const float* pw, const int32_t* ptab,
                                   void* const* ptrs, const int64_t* strides,
                                   int S, int frames, int hold) {
  const FarganArgs g =
      fargan_args(fw, ftab, pw, ptab, ptrs, strides, frames, hold);
  if (!fargan_layers_ok(g.fl, g.pl)) return -1;
  FarganWork* w = static_cast<FarganWork*>(malloc(sizeof(FarganWork)));
  if (w == nullptr) return -1;
  for (int s = 0; s < S; ++s) fargan_stream(g, s, *w, 0, 1);
  free(w);
  return 0;
}
#endif  // FARGAN_HOST_API

#endif  // MOUSIKI_FARGAN_H_
