// csrc/silk_nsq.cu with a clock probe on the parts of a sample (the
// NSQ_PROBE hooks of silk_nsq.h), for tools/torch_step_ab.py --target nsq
// --probe:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        -I mousiki_tpu_torch/csrc -o libnsq_probe.so tools/nsq_probe.cu
//
// Each thread adds, for each part, the clock64 cycles from the hook before
// to the part's own hook over the whole call (the parts are NsqProbePart's
// numbers: 0 prologue, 1 reads, 2 dots, 3 candidates, 4 barrier, 5
// decisions, 6 replacement, 7 emission, 8 advance, 9 flushes and outputs);
// lane 0 of each warp adds its kSlots sums to
// buf[(blockIdx.x * warps + warp) * kSlots] as a function with hooks ends
// (the buffer starts at zero). Nothing is recorded while buf is null.

#include <cuda_runtime.h>
#include <stdint.h>

namespace nsq_probe {

constexpr int kSlots = 16;
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
  long long* out = buf + (static_cast<size_t>(blockIdx.x) * (blockDim.x / 32)
                          + threadIdx.x / 32) * kSlots;
  for (int p = 0; p < kSlots; ++p) out[p] += acc[p];
#else
  (void)acc;
#endif
}

}  // namespace nsq_probe

#define NSQ_PROBE_BEGIN()                             \
  long long nsq_probe_acc[nsq_probe::kSlots] = {};    \
  long long nsq_probe_t = nsq_probe::ticks()
#define NSQ_PROBE(part)                                   \
  do {                                                    \
    const long long nsq_probe_now = nsq_probe::ticks();   \
    nsq_probe_acc[part] += nsq_probe_now - nsq_probe_t;   \
    nsq_probe_t = nsq_probe_now;                          \
  } while (0)
#define NSQ_PROBE_SKIP() (nsq_probe_t = nsq_probe::ticks())
#define NSQ_PROBE_END() nsq_probe::store(nsq_probe_acc)

#include "silk_nsq.cu"

// Where the next launches record (null: nowhere).
extern "C" int nsq_probe_set(void* buf) {
  return static_cast<int>(
      cudaMemcpyToSymbol(nsq_probe::buf, &buf, sizeof buf));
}
