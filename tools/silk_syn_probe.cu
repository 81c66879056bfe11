// csrc/silk_synthesis.cu with a clock probe on the parts of a frame (the
// SILK_SYN_PROBE hooks of silk_synthesis.h), for tools/torch_step_ab.py
// --target silk_syn --probe:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        -I mousiki_tpu_torch/csrc -o libsilk_syn_probe.so
//        tools/silk_syn_probe.cu
//
// Each thread adds, for each part, the clock64 cycles from the hook before
// to the part's own hook over the whole frame (the parts are
// SilkSynProbePart's numbers: 0 loads, 1 scale and re-whitening, 2 LTP
// chunks, 3 LPC chain, 4 an interpolated frame's re-whitening of the first
// half's output, 5 waits on the other warp, 6 write-out); lane 0 of each
// warp adds its kSlots sums to buf[(blockIdx.x * 4 + warp) * kSlots] as
// the frame ends (the buffer starts at zero, four warps a block at most).
// Nothing is recorded while buf is null.

#include <cuda_runtime.h>
#include <stdint.h>

namespace silk_syn_probe {

constexpr int kSlots = 8;
constexpr int kWarps = 4;
__device__ long long* buf;

// the hooks sit in __host__ __device__ code: the host pass reads no clock
__host__ __device__ __forceinline__ long long ticks() {
#if defined(__CUDA_ARCH__)
  return clock64();
#else
  return 0;
#endif
}

__host__ __device__ __forceinline__ void store(const long long* acc) {
#if defined(__CUDA_ARCH__)
  if (buf == nullptr || threadIdx.x % 32 != 0) return;
  long long* out =
      buf + (static_cast<size_t>(blockIdx.x) * kWarps + threadIdx.x / 32) *
                kSlots;
  for (int p = 0; p < kSlots; ++p) out[p] += acc[p];
#else
  (void)acc;
#endif
}

}  // namespace silk_syn_probe

#define SILK_SYN_PROBE_BEGIN()                                  \
  long long syn_probe_acc[silk_syn_probe::kSlots] = {};         \
  long long syn_probe_t = silk_syn_probe::ticks()
#define SILK_SYN_PROBE(part)                                    \
  do {                                                          \
    const long long syn_probe_now = silk_syn_probe::ticks();    \
    syn_probe_acc[part] += syn_probe_now - syn_probe_t;         \
    syn_probe_t = syn_probe_now;                                \
  } while (0)
#define SILK_SYN_PROBE_END() silk_syn_probe::store(syn_probe_acc)

#include "silk_synthesis.cu"

// Where the next launches record (null: nowhere).
extern "C" int silk_syn_probe_set(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(silk_syn_probe::buf, &buf, sizeof buf));
}
