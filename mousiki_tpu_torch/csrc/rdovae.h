// The arithmetic of the RDOVAE decode kernel (models/dred.decode_qframes),
// one stream at a time: the decoder's initial state from the stream's
// 24-float initial state (models/dred.dec_init_state), then Q quantized
// dframes (models/dred.decode_qframe: dense 1, five rounds of GRU, GLU and
// the kernel-2 dilated conv, each appending to the dense stack, then the
// output dense), on the layers of nnet.h.
//
// The state advances only where the qframe is active (the plain version's
// torch.where freeze); the qframe's 80 outputs are written either way. A
// stream's state and activations live in an RdovaeWork (shared memory on
// the device): the five GRU states, the stack buf (736 floats), and each
// conv's past inputs as a ring of its dilation's slots (dilations 1, 2, 2,
// 2, 2; 192 to 704 floats a slot), the oldest slot read in place beside
// buf as the conv's input. Each layer's rows go over the block's threads;
// its weights are read from the packed buffer (3.84 MB at the default
// widths, L2 on the card).
//
// Input: process's packed row a stream, [Q latents of 24 | the initial
// state's 24 | Q activity flags (> 0.5)], read in place. Output: (S, Q, 80)
// float32 and, where asked, the final state: the five GRU states, then
// each conv's past inputs oldest first.
//
// csrc/rdovae.cu includes this header for rdovae_decode_kernel; with
// RDOVAE_HOST_API defined, g++ builds it alone into a host library whose
// entry point runs the streams one after another with one thread
// (ops/_build.build_header_host).

#ifndef MOUSIKI_RDOVAE_H_
#define MOUSIKI_RDOVAE_H_

#include <stdint.h>

#include "nnet.h"

#define RDOVAE_PAD 24            // padded latent and state width
#define RDOVAE_HIDDEN 128
#define RDOVAE_DENSE1 96
#define RDOVAE_GRU 96
#define RDOVAE_CONV 32
#define RDOVAE_ROUNDS 5
#define RDOVAE_STACK 736         // 96 + 5 * (96 + 32)
#define RDOVAE_OUT 80
#define RDOVAE_PASTS 4288        // 192 + 2 * (320 + 448 + 576 + 704)
#define RDOVAE_STATE (RDOVAE_ROUNDS * RDOVAE_GRU + RDOVAE_PASTS)

// the packed decoder's layers: hidden_init, gru_init, dense1, then a
// round's GRU input, GRU recurrent, GLU and conv (kRound + 4 k + ...),
// then the output dense
enum RdovaeLayer { kHiddenInit, kGruInit, kDense1, kRound,
                   kOutput = kRound + 4 * RDOVAE_ROUNDS, kRdovaeLayers };

// round k's GRU input width (the stack before it) and conv input width
NN_HD int rdovae_gru_in(int k) {
  return RDOVAE_DENSE1 + (RDOVAE_GRU + RDOVAE_CONV) * k;
}
NN_HD int rdovae_conv_in(int k) { return rdovae_gru_in(k) + RDOVAE_GRU; }
NN_HD int rdovae_dilation(int k) { return k == 0 ? 1 : 2; }
// where round k's ring starts in the pasts
NN_HD int rdovae_past_at(int k) {
  int at = 0;
  for (int i = 0; i < k; ++i) at += rdovae_dilation(i) * rdovae_conv_in(i);
  return at;
}

struct RdovaeArgs {
  const float* w;
  NnLayer l[kRdovaeLayers];
  const float* packed;
  int64_t stride;
  int Q;
  float* out;                    // (S, Q, 80)
  float* state;                  // (S, RDOVAE_STATE) or null
};

// The widths the kernel takes of layer i (models/dred's decoder): its
// input width, times 65536, plus its output width.
NN_HD int rdovae_widths(int i) {
  if (i == kHiddenInit) return RDOVAE_PAD << 16 | RDOVAE_HIDDEN;
  if (i == kGruInit) return RDOVAE_HIDDEN << 16 | RDOVAE_ROUNDS * RDOVAE_GRU;
  if (i == kDense1) return RDOVAE_PAD << 16 | RDOVAE_DENSE1;
  if (i == kOutput) return RDOVAE_STACK << 16 | RDOVAE_OUT;
  const int k = (i - kRound) / 4;
  switch ((i - kRound) % 4) {
    case 0: return rdovae_gru_in(k) << 16 | 3 * RDOVAE_GRU;
    case 1: return RDOVAE_GRU << 16 | 3 * RDOVAE_GRU;
    case 2: return RDOVAE_GRU << 16 | RDOVAE_GRU;
    default: return 2 * rdovae_conv_in(k) << 16 | RDOVAE_CONV;
  }
}

NN_HD bool rdovae_layers_ok(const NnLayer* l) {
  for (int i = 0; i < kRdovaeLayers; ++i)
    if ((l[i].n_in << 16 | l[i].n_out) != rdovae_widths(i)) return false;
  return true;
}

NN_HD RdovaeArgs rdovae_args(const float* w, const int32_t* table,
                             const float* packed, int64_t stride, int Q,
                             float* out, float* state) {
  RdovaeArgs g;
  g.w = w;
  for (int i = 0; i < kRdovaeLayers; ++i) g.l[i] = nn_layer(table, i);
  g.packed = packed;
  g.stride = stride;
  g.Q = Q;
  g.out = out;
  g.state = state;
  return g;
}

// A stream's state and activations. part holds a layer's partials, or a
// GRU's input partials and, from RDOVAE_GRU_PART on, its recurrent ones.
#define RDOVAE_GRU_PART (NN_ACC * 3 * RDOVAE_GRU)
struct RdovaeWork {
  float part[2 * RDOVAE_GRU_PART];
  float gru[RDOVAE_ROUNDS * RDOVAE_GRU];
  float gnew[RDOVAE_GRU];
  float hidden[RDOVAE_HIDDEN];
  float buf[RDOVAE_STACK];
  float x[RDOVAE_PAD];
  float past[RDOVAE_PASTS];
};

// Stream s whole.
NN_HD void rdovae_stream(const RdovaeArgs& g, int s, RdovaeWork& w, int tid,
                         int nth) {
  const float* wts = g.w;
  const int Q = g.Q;
  const float* row = g.packed + s * g.stride;
  for (int i = tid; i < RDOVAE_PAD; i += nth)
    w.x[i] = row[Q * RDOVAE_PAD + i];
  for (int i = tid; i < RDOVAE_PASTS; i += nth) w.past[i] = 0.0f;
  NN_SYNC();
  nn_dense(wts, g.l[kHiddenInit], nn_in(w.x, RDOVAE_PAD), NN_TANH, w.hidden,
           w.part, tid, nth);
  nn_dense(wts, g.l[kGruInit], nn_in(w.hidden, RDOVAE_HIDDEN), NN_TANH,
           w.gru, w.part, tid, nth);
  // the qframes that advanced the state: a ring's oldest slot is their
  // count modulo its dilation
  int advanced = 0;
  for (int q = 0; q < Q; ++q) {
    const bool active = row[(Q + 1) * RDOVAE_PAD + q] > 0.5f;
    for (int i = tid; i < RDOVAE_PAD; i += nth)
      w.x[i] = row[q * RDOVAE_PAD + i];
    NN_SYNC();
    nn_dense(wts, g.l[kDense1], nn_in(w.x, RDOVAE_PAD), NN_TANH, w.buf,
             w.part, tid, nth);
    for (int k = 0; k < RDOVAE_ROUNDS; ++k) {
      const NnLayer* L = g.l + kRound + 4 * k;
      const int n = rdovae_gru_in(k), m = rdovae_conv_in(k);
      float* gk = w.gru + k * RDOVAE_GRU;
      nn_gru(wts, L[0], L[1], nn_in(w.buf, n), gk, w.gnew, w.part,
             w.part + RDOVAE_GRU_PART, tid, nth);
      nn_glu(wts, L[2], w.gnew, w.buf + n, nullptr, w.part, tid, nth);
      if (active)
        for (int i = tid; i < RDOVAE_GRU; i += nth) gk[i] = w.gnew[i];
      float* oldest =
          w.past + rdovae_past_at(k) + advanced % rdovae_dilation(k) * m;
      nn_dense(wts, L[3], nn_in2(oldest, m, w.buf), NN_TANH, w.buf + m,
               w.part, tid, nth);
      if (active)  // the newest input replaces the oldest, read by now
        for (int i = tid; i < m; i += nth) oldest[i] = w.buf[i];
    }
    advanced += active;
    nn_dense(wts, g.l[kOutput], nn_in(w.buf, RDOVAE_STACK), NN_LINEAR,
             g.out + (static_cast<int64_t>(s) * Q + q) * RDOVAE_OUT, w.part,
             tid, nth);
  }
  if (g.state == nullptr) return;
  float* st = g.state + static_cast<int64_t>(s) * RDOVAE_STATE;
  for (int i = tid; i < RDOVAE_ROUNDS * RDOVAE_GRU; i += nth) st[i] = w.gru[i];
  st += RDOVAE_ROUNDS * RDOVAE_GRU;
  for (int k = 0; k < RDOVAE_ROUNDS; ++k) {
    const int m = rdovae_conv_in(k), d = rdovae_dilation(k);
    const float* ring = w.past + rdovae_past_at(k);
    for (int i = tid; i < d * m; i += nth)
      st[i] = ring[((advanced + i / m) % d) * m + i % m];
    st += d * m;
  }
}

#if defined(RDOVAE_HOST_API)
#include <stdlib.h>

// Entry point of the host build (ctypes): the streams one after another,
// with one thread. Returns 0, or -1 for layers it does not take.
extern "C" int rdovae_decode_host(const float* w, const int32_t* table,
                                  const float* packed, int64_t stride,
                                  int S, int Q, float* out, float* state) {
  const RdovaeArgs g = rdovae_args(w, table, packed, stride, Q, out, state);
  if (!rdovae_layers_ok(g.l)) return -1;
  RdovaeWork* work = static_cast<RdovaeWork*>(malloc(sizeof(RdovaeWork)));
  if (work == nullptr) return -1;
  for (int s = 0; s < S; ++s) rdovae_stream(g, s, *work, 0, 1);
  free(work);
  return 0;
}
#endif  // RDOVAE_HOST_API

#endif  // MOUSIKI_RDOVAE_H_
