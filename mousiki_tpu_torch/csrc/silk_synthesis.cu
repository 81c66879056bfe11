// The device SILK synthesis for Hopper (sm_90a): silk_synthesis_kernel, one
// SILK frame of S streams (the gain scale, the re-whitening of the carried
// output, the 5-tap LTP over the lag-gathered residual and the order-16
// LPC synthesis, both halves of the frame) in one launch, one block a
// stream.
//
// Replaces no Pallas kernel: it replaces the loops that XLA compiled in the
// reference's silk_synthesis_step (mousiki_tpu/ops/silk_synthesis_jax.py:71,
// the LTP fori_loop :102 and the LPC lax.scan :109). Their plain version,
// ops/silk_synthesis.silk_synthesis_step_reference, runs them as Python
// loops of small torch ops (40 LTP chunks and 320 LPC samples a 20 ms frame
// at 16 kHz, about 1,700 launches a step).
//
// What bounds it: one stream's chain of 320 dependent LPC steps (each needs the
// one before). Bytes (about 5.5 KB a stream: its excitation, parameters,
// carried output and outputs) and operations (about 2,000 a sample) are small;
// streams run at once, one block a stream, so a launch takes about one stream's
// chain. The block is two warps and keeps the stream in its shared memory
// (silk_synthesis.h's SilkSynWork). Its 64 threads copy the inputs in
// (cp.async, every word in flight at once), then share the scale and the
// history's re-whitening (a thread a position, the history behind 16 zeros so
// that the FIR reads straight). Then warp 1 runs the LTP chunk by chunk (up to
// four chunks a step where the lags keep them apart) and hands its chunks to
// warp 0 as a count (release / acquire, read only when the count last read
// falls short); warp 0 runs the LPC chain in straight-line rounds of 16
// samples, each reading its input as it starts. A sample's sum of 16 products
// is eight pairs added in order: lane n % 8 of warp 0 forms sample n's pairs
// 0-4 one a step as their samples come (no shuffle between steps), one shuffle
// broadcasts the five-pair sum, which every lane takes two steps later, and
// every lane adds pairs 5-7 and x itself, so that each sample's chain is one
// multiply and three adds and the shuffle's latency is spread over two steps.
// An interpolated frame's second-half LTP reads the first half's output
// re-whitened: warp 1 forms it 8 samples at a time as warp 0 hands them over
// (in such a frame only), only as far as its next chunks read. Streams share no
// arithmetic, so a stream's output does not depend on its batch.
//
// Arithmetic is the plain version's, one rounding an operation, in
// silk_synthesis.h (shared with the host build of the CPU tests).

#include <cuda_runtime.h>
#include <stdint.h>

#include "silk_synthesis.h"

namespace {

constexpr int kThreads = 2 * SILK_SYN_WARP;

__global__ void __launch_bounds__(kThreads)
silk_synthesis_kernel(SilkSynArgs g) {
  __shared__ SilkSynWork w;
  silk_syn_stream(g, blockIdx.x, w, threadIdx.x, kThreads);
}

}  // namespace

// ptrs: kSynArgs device pointers in SilkSynArg's order (silk_synthesis.h),
// strides the inputs' element strides along the stream axis (each stream's
// row contiguous), the outputs contiguous; pitch int32, voiced and interp
// bool as bytes (interp may be null). One block a stream on `stream`;
// returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for a
// shape it does not take.
extern "C" int mousiki_silk_synthesis(void* const* ptrs,
                                      const int64_t* strides, int S, int L,
                                      int H, int nb, int subfr_len,
                                      void* stream) {
  if (S <= 0 || !silk_syn_shape_ok(L, H, nb, subfr_len))
    return static_cast<int>(cudaErrorInvalidValue);
  silk_synthesis_kernel<<<S, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      silk_syn_args(ptrs, strides, L, H, nb, subfr_len));
  return static_cast<int>(cudaGetLastError());
}
