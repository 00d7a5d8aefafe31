// probe_empty: a kernel that does nothing, launched on the grid of
// another kernel (blocks of threads): the time of a launch, the
// practical floor beside a bound below it. Built and timed only by
// chip_smoke.py and chip_probe.py (not a kernel of any path; _build.py's
// SOURCES leave it out).
#include <cuda_runtime.h>

namespace {
__global__ void empty_kernel() {}
}  // namespace

extern "C" int fts_empty_launch(int blocks, int threads, void* stream) {
  if (blocks <= 0) return 0;
  empty_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
