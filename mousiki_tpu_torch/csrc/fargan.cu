// The neural concealment for Hopper (sm_90a): fargan_conceal_kernel, F
// frames of 10 ms for S streams in one launch, one block a stream: each
// frame's PitchDNN period, FARGAN's conditioning and its four subframes
// (the pitch gather, the fwc0 conv and GLU, the pitch gates, three GRUs
// with their GLUs and gated pitch, the skip and output denses, the
// de-emphasis), the state carried from frame to frame in shared memory.
//
// Replaces no Pallas kernel: it replaces the scan that XLA compiled in the
// reference's _conceal_batch (mousiki_tpu/parallel/deep_recovery.py:63,
// lax.scan :77; a frame runs models/deep_plc.py:40 compute_pitchdnn,
// models/fargan.py:80 compute_cond and four :103 run_subframe, the
// de-emphasis lax.scan :145). Its plain version, models/fargan.
// conceal_frames_reference, runs it as a Python loop of eager ops (about
// 470 launches a frame).
//
// What bounds it: each layer's weights. A subframe reads about 3 MB of the
// packed FARGAN (3.84 MB, resident in the 50 MB L2) for 0.8 M
// multiply-adds, so each block streams its weights from L2 at its SM's
// read rate; the arithmetic (0.83 GFLOP for 64 streams and two frames) and
// the bytes from HBM (3.84 MB once) bound it far lower. The block's 512
// threads share each layer's (partial, row) items (nnet.h), four rows a
// thread and four 16-byte loads of weights issued together (fargan.h's
// NN_BATCH); the layers follow one another behind barriers. Streams share no arithmetic, so a
// stream's output does not depend on its batch.
//
// Arithmetic: fargan.h and nnet.h, one rounding an operation (shared with
// the host build of the CPU tests).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fargan.h"

namespace {

constexpr int kThreads = 512;

__global__ void __launch_bounds__(kThreads)
fargan_conceal_kernel(FarganArgs g) {
  __shared__ FarganWork w;
  fargan_stream(g, blockIdx.x, w, threadIdx.x, kThreads);
}

}  // namespace

// fw / pw: the packed FARGAN and PitchDNN on the card; ftab / ptab: their
// layer tables (host memory, kFarganLayers and kPitchLayers NnLayers);
// ptrs: kFarganArgs device pointers in FarganArg's order (active may be
// null), strides the inputs' stream strides. One block a stream on
// `stream`; returns cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for layers or a shape it does not take.
extern "C" int mousiki_fargan_conceal(const float* fw, const int32_t* ftab,
                                      const float* pw, const int32_t* ptab,
                                      void* const* ptrs,
                                      const int64_t* strides, int S,
                                      int frames, int hold, void* stream) {
  const FarganArgs g =
      fargan_args(fw, ftab, pw, ptab, ptrs, strides, frames, hold);
  if (S <= 0 || frames < 0 || !fargan_layers_ok(g.fl, g.pl))
    return static_cast<int>(cudaErrorInvalidValue);
  fargan_conceal_kernel<<<S, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(g);
  return static_cast<int>(cudaGetLastError());
}
