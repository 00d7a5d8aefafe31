// g1_msm: fixed-base multiexp, one thread per row.
//
// Replaces the JAX programs g1_msm{1,2,3}_tile
// (fabric_token_sdk_tpu/ops/stages.py:_g1_msm_tile, via
// ops/curve.py:msm_select). There, each row's window points were picked
// by a one-hot digit einsum (a dense matmul for the TPU's matrix unit)
// and summed by a scan of Jacobian adds. Here a thread gathers
// table[b*64 + w][digit] directly and adds it into its accumulator in
// the same order (base-major, windows LSB-first), so the canonical
// Jacobian result equals the reference's.
//
// Layout: table (nbases*64, 16, 3, 8) uint32, entry [t][d] = d * 16^w *
// base_b for t = 64b + w, in Montgomery form; scalars (n, nbases, 8)
// canonical (non-Montgomery); out (n, 3, 8) canonical Montgomery.
//
// What bounds it on the H100: integer multiplies. Each row does
// nbases*64 Jacobian adds of 23 CIOS products (16 for the add, 7 for the
// doubling that is always computed and selected); the table (295 KB at
// 3 bases) stays in L2, and a row reads 96 bytes per add. The design
// keeps the whole accumulator in registers and issues no shared memory
// or synchronisation. One thread per row gives only n threads (4,096 on
// a 1,024-transfer batch, against 132 SMs): low occupancy is the known
// gap, left for a later change (split the windows of a row across
// threads and tree-sum them).
//
// The digit gather is data-dependent. Verification multiplies public
// scalars only; a prover with secret scalars needs a select over all 16
// entries instead.
#include "bn254_g1.cuh"

using namespace bn254;

namespace {

constexpr int WINDOWS = 64;  // 4-bit windows per 256-bit scalar
constexpr int DIGITS = 16;   // entries per window

__device__ __forceinline__ void g1_msm_row(const uint32_t* __restrict__ table,
                                           const uint32_t* __restrict__ scalars,
                                           uint32_t* __restrict__ out, int row, int nbases) {
  G1 acc = g1_infinity();
  const uint32_t* s = scalars + (size_t)row * nbases * NW;
#pragma unroll 1
  for (int b = 0; b < nbases; ++b) {
#pragma unroll 1
    for (int k = 0; k < NW; ++k) {
      uint32_t word = __ldg(s + b * NW + k);
#pragma unroll 1
      for (int nib = 0; nib < 8; ++nib) {
        int t = b * WINDOWS + k * 8 + nib;
        uint32_t digit = (word >> (4 * nib)) & 15u;
        acc = g1_add(acc, g1_load(table + ((size_t)t * DIGITS + digit) * G1_WORDS));
      }
    }
  }
  g1_store_canon(out + (size_t)row * G1_WORDS, acc);
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_g1_msm(const uint32_t* table, const uint32_t* scalars, uint32_t* out,
                            int n, int nbases) {
  for (int row = 0; row < n; ++row) g1_msm_row(table, scalars, out, row, nbases);
}
#else
#include <cuda_runtime.h>

namespace {
constexpr int THREADS = 128;

__global__ void g1_msm_kernel(const uint32_t* __restrict__ table,
                              const uint32_t* __restrict__ scalars,
                              uint32_t* __restrict__ out, int n, int nbases) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) g1_msm_row(table, scalars, out, row, nbases);
}
}  // namespace

extern "C" int fts_g1_msm(const void* table, const void* scalars, void* out,
                          int n, int nbases, void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + THREADS - 1) / THREADS;
  g1_msm_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const uint32_t*)scalars, (uint32_t*)out, n, nbases);
  return (int)cudaGetLastError();
}
#endif
