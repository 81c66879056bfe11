// The RDOVAE decode for Hopper (sm_90a): rdovae_decode_kernel, the DRED
// decoder's initial state and Q quantized dframes of S streams in one
// launch, one block a stream, the state (five GRUs, the dilated convs'
// past inputs) in shared memory and frozen where a qframe is inactive.
//
// Replaces no Pallas kernel: it replaces the scan that XLA compiled in the
// reference's _rdovae_decode_batch (mousiki_tpu/parallel/
// deep_recovery.py:39, lax.scan :55, each step models/dred.py:276
// decode_qframe vmapped over the streams). Its plain version,
// models/dred.decode_qframes_reference, runs it as a Python loop of eager
// ops (148 launches a qframe).
//
// What bounds it: each layer's weights. A qframe reads the packed decoder
// (3.84 MB, resident in the 50 MB L2) for 0.9 M multiply-adds, so each
// block streams its weights from L2 at its SM's read rate; the arithmetic
// (2.99 GFLOP at S = 64, Q = 26) and the bytes from HBM bound it far
// lower. The block's 1,024 threads share each layer's (partial, row)
// items (nnet.h), four rows a thread and eight 16-byte loads of weights
// issued together: its many narrow layers (96, 32 and 80 rows) leave most
// threads one item, so more threads mean more loads in flight (on an
// H100, 1,024 threads: 2.58 ms at S = 64, Q = 26, beside 3.01 with 512;
// the register cap of 64 this sets spills little). Streams share no arithmetic, so a stream's output does not
// depend on its batch.
//
// Arithmetic: rdovae.h and nnet.h, one rounding an operation (shared with
// the host build of the CPU tests).

#include <cuda_runtime.h>
#include <stdint.h>

#include "rdovae.h"

namespace {

constexpr int kThreads = 1024;

__global__ void __launch_bounds__(kThreads)
rdovae_decode_kernel(RdovaeArgs g) {
  __shared__ RdovaeWork w;
  rdovae_stream(g, blockIdx.x, w, threadIdx.x, kThreads);
}

}  // namespace

// w: the packed decoder on the card; table: its layer table (host memory,
// kRdovaeLayers NnLayers); packed: the (S, 25 Q + 24) rows of process, a
// stream `stride` floats apart; out (S, Q, 80); state (S, RDOVAE_STATE) or
// null. One block a stream on `stream`; returns cudaGetLastError() (0 on
// success), or cudaErrorInvalidValue for layers or a shape it does not
// take.
extern "C" int mousiki_rdovae_decode(const float* w, const int32_t* table,
                                     const float* packed, int64_t stride,
                                     int S, int Q, float* out, float* state,
                                     void* stream) {
  const RdovaeArgs g = rdovae_args(w, table, packed, stride, Q, out, state);
  if (S <= 0 || Q < 0 || !rdovae_layers_ok(g.l))
    return static_cast<int>(cudaErrorInvalidValue);
  rdovae_decode_kernel<<<S, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
