// csrc/pvq_leaves.cu with a clock probe at each stage of a warp's task
// (its LEAF_PROBE hooks), for tools/torch_leaf_walk_ab.py --probe:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC
//        -o libleaf_probe.so tools/leaf_probe.cu
//
// Lane 0 of a warp writes, at point p of task t, three words at
// buf[(t * kPoints + p) * 3]: %globaltimer (ns, one clock for all SMs),
// clock64 (the SM's cycles) and %smid. Points: 0 the warp's start and 8
// its end (under its first task), 1 a task's start, 2 its planes in, 3
// an idle task's zero pulse vectors written, 4 the table staged, 5 the
// descent done, 6 iy written, 7 the task's end. Tasks at or past the
// count given to leaf_probe_set are not recorded.

#include <cuda_runtime.h>
#include <stdint.h>

namespace leaf_probe {

constexpr int kPoints = 9;
__device__ unsigned long long* buf;
__device__ int tasks;

__device__ __forceinline__ void record(int task, int point) {
  if (threadIdx.x % 32 != 0 || buf == nullptr || task < 0 || task >= tasks)
    return;
  unsigned long long gt;
  unsigned sm;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(gt)::"memory");
  const long long clk = clock64();
  asm volatile("mov.u32 %0, %%smid;" : "=r"(sm));
  unsigned long long* r =
      buf + (static_cast<size_t>(task) * kPoints + point) * 3;
  r[0] = gt;
  r[1] = static_cast<unsigned long long>(clk);
  r[2] = sm;
}

}  // namespace leaf_probe

#define LEAF_PROBE(task, point) leaf_probe::record(task, point)
#include "../mousiki_tpu_torch/csrc/pvq_leaves.cu"

// Where the next launches record (null: nowhere) and how many tasks.
extern "C" int leaf_probe_set(void* buf, int tasks) {
  cudaError_t err = cudaMemcpyToSymbol(leaf_probe::buf, &buf, sizeof buf);
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(leaf_probe::tasks, &tasks, sizeof tasks);
  return static_cast<int>(err);
}
