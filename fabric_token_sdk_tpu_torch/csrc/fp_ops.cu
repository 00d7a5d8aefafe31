// fp_ops: the Fp device functions of bn254_fp.cuh, one thread per value.
//
// A check of the field layer alone, not a kernel of the verify path:
// when a G1 kernel disagrees with its plain version, this one shows
// whether the fault lies in the field arithmetic underneath. For each
// row it writes canonical mul(a, b), add(a, b), sub(a, b) and inv(a).
//
// Layout: a, b (n, 8) Montgomery words in [0, 2p); out (n, 4, 8).
#include "bn254_fp.cuh"

using namespace bn254;

namespace {

__device__ __forceinline__ void fp_ops_row(const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ b,
                                           uint32_t* __restrict__ out, int row) {
  Fp x = fp_load(a + (size_t)row * NW);
  Fp y = fp_load(b + (size_t)row * NW);
  uint32_t* o = out + (size_t)row * 4 * NW;
  fp_store(o, fp_canon(fp_mul(x, y)));
  fp_store(o + NW, fp_canon(fp_add(x, y)));
  fp_store(o + 2 * NW, fp_canon(fp_sub(x, y)));
  fp_store(o + 3 * NW, fp_canon(fp_inv(x)));
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_fp_ops(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  for (int row = 0; row < n; ++row) fp_ops_row(a, b, out, row);
}
#else
#include <cuda_runtime.h>

namespace {
constexpr int THREADS = 128;

__global__ void fp_ops_kernel(const uint32_t* __restrict__ a,
                              const uint32_t* __restrict__ b,
                              uint32_t* __restrict__ out, int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) fp_ops_row(a, b, out, row);
}
}  // namespace

extern "C" int fts_fp_ops(const void* a, const void* b, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + THREADS - 1) / THREADS;
  fp_ops_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
