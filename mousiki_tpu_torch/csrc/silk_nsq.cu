// The SILK noise-shaping quantizers for Hopper (sm_90a): nsq_frame_kernel,
// the single-state quantizer, and nsq_del_dec_kernel, the four-state
// delayed-decision quantizer, each one launch a quantizer call and one
// block a stream.
//
// Replaces no Pallas kernel: it replaces the loops that XLA compiled in
// the reference, the sample lax.scan of nsq_frame (mousiki_tpu/ops/
// silk_nsq_jax.py:262, the body :99-276) and of nsq_del_dec_frame (:685,
// the body :319-708 with its flush :382). Their plain versions,
// ops/silk_nsq.nsq_frame_reference and nsq_del_dec_frame_reference, run the
// samples as a Python loop of small torch ops (about 104 and 155 launches
// a sample).
//
// What bounds it: one stream's chain of 320 dependent samples (each
// sample's pulse decides the dither and the filter states of the next).
// Bytes (about 10 KB a stream) and operations (a few hundred a sample and
// state) are small; streams run at once, one block a stream, so a launch
// takes about one stream's chain, and the design shortens the chain by
// spreading a sample's products over a warp's lanes. The block keeps the
// three work planes of the plain version (xq, shaping and re-whitened LTP,
// 640 columns each) in shared memory; its 128 threads share what does not
// depend on the chain (each subframe's re-whitening FIR and gain
// rescaling, a thread a column). The single state runs its samples on warp
// 0: the two delay lines are windows over the lanes' registers that move
// down a lane a sample (one shuffle each), the LPC and shaping products one
// a lane, summed in the plain version's order (eight lane partials
// gathered by shuffles, then added in sequence); since the newest sample
// is the last product that order adds, the rest of the next sample's sums
// are formed while a sample decides, and the chain carries one multiply
// and two adds of them. The delayed decision runs one trellis state a
// warp: a state's LPC history, warped shaping chain, row of the rotation
// Lw and coefficients sit in its lanes' registers, its rings in shared
// memory; a sample is the two candidates (the dot products over the
// lanes), what another state may need published in shared memory, one
// barrier of the block, then on every lane the decisions (winner, worst
// head, best runner-up), the replaced state's copy (over the warp's 32
// lanes), the winner's delayed emission (thread 0) and the advance, row j
// of the warped rotation on lane j, with the next sample's reads and LPC
// partials formed beside it. Streams share no arithmetic, so a stream's
// pulses do not depend on its batch.
//
// Arithmetic is the plain version's, one rounding an operation, in
// silk_nsq.h (shared with the host build of the CPU tests, which runs the
// same lane code lane by lane).

#include <cuda_runtime.h>
#include <stdint.h>

#include "silk_nsq.h"

namespace {

constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads) nsq_frame_kernel(NsqArgs g) {
  __shared__ NsqFrameWork w;
  nsq_frame_stream(g, blockIdx.x, w, threadIdx.x, kThreads);
}

__global__ void __launch_bounds__(kThreads) nsq_del_dec_kernel(NsqArgs g) {
  __shared__ NsqDDWork w;
  NsqDDRegs r;   // the warp's state, the thread's lane of it
  nsq_dd_stream(g, blockIdx.x, w, r, threadIdx.x, kThreads);
}

}  // namespace

// ptrs: kNsqArgs device pointers in NsqArg's order (silk_nsq.h), every
// array contiguous with S streams on its first axis; the shapes are the
// executor's (4 subframes of 80 samples, 320 samples of history, 16 LPC
// taps, shaping AR (S, 4, 24) of which `order` are used). One block a
// stream on `stream`; return cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for an S or order they do not take.
extern "C" int mousiki_nsq_frame(void* const* ptrs, int S, int order,
                                 void* stream) {
  if (S <= 0 || order < 1 || order > NSQ_SHAPE)
    return static_cast<int>(cudaErrorInvalidValue);
  nsq_frame_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nsq_args(ptrs, order, 0, 0));
  return static_cast<int>(cudaGetLastError());
}

// as mousiki_nsq_frame; the warping w[s * w_stride] and the rotation
// lw + s * lw_stride, (order, order) a stream
extern "C" int mousiki_nsq_del_dec(void* const* ptrs, int S, int order,
                                   int64_t w_stride, int64_t lw_stride,
                                   void* stream) {
  if (S <= 0 || order < 1 || order > NSQ_SHAPE)
    return static_cast<int>(cudaErrorInvalidValue);
  nsq_del_dec_kernel<<<S, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      nsq_args(ptrs, order, w_stride, lw_stride));
  return static_cast<int>(cudaGetLastError());
}
