// g1_msm: fixed-base multiexp, one thread per row, in two modes built
// from one template.
//
// Replaces the JAX programs g1_msm{1,2,3}_tile
// (fabric_token_sdk_tpu/ops/stages.py:_g1_msm_tile, via
// ops/curve.py:msm_select). There, each row's window points were picked
// by a one-hot digit einsum (a dense matmul for the TPU's matrix unit)
// and summed by a scan of Jacobian adds. Here a thread picks the entry
// table[b*64 + w][digit] of each window and adds it into its
// accumulator in the same order (base-major, windows LSB-first), so the
// canonical Jacobian result equals the reference's. The pick comes in
// two forms:
//
// * gather (fts_g1_msm, the verify path): the thread loads the one
//   entry the digit names. The load address depends on the digit, which
//   is fine for verification: its scalars are public proof responses.
// * select (fts_g1_msm_select, the prove path): the thread loads all 16
//   entries of the window and keeps the wanted one by OR-ing each entry
//   under a mask, 0 - (d == digit), made opaque to the compiler so that
//   it cannot be turned back into a predicated load or a branch. No load
//   address and no branch depends on the digit: the loops run over the
//   public window and entry counts, and the digit only ever enters the
//   mask arithmetic. This is the reference's one-hot contraction, and
//   what the prover's secret openings (values, blinding factors, sigma
//   randomness) need. g1_add itself computes every case and selects.
//   Checked in the sm_90a SASS (cuobjdump -sass of the built library;
//   chip_probe.py writes it): each entry is 24 unpredicated
//   LDG.E.CONSTANT, the mask one SEL from an ISETP of d against the
//   digit, the pick 24 LOP3 OR-ANDs, and the loop's back-branch tests d
//   alone; no load in the kernel is predicated. ptxas -v: 216 registers,
//   no spills, no stack (the gather: 219).
//
// Layout: table (nbases*64, 16, 3, 8) uint32, entry [t][d] = d * 16^w *
// base_b for t = 64b + w, in Montgomery form; scalars (n, nbases, 8)
// canonical (non-Montgomery); out (n, 3, 8) canonical Montgomery.
//
// What bounds it on the H100: integer multiplies. Each row does
// nbases*64 Jacobian adds of 23 CIOS products (16 for the add, 7 for the
// doubling that is always computed and selected); the table (295 KB at
// 3 bases) stays in L2. A row reads 96 bytes per add in gather mode and
// 16 x 96 in select mode, so select trades L2 bandwidth for secrecy.
// The design keeps the whole accumulator in registers and issues no
// shared memory or synchronisation. One thread per row gives only n
// threads (4,096 on a 1,024-transfer batch, against 132 SMs): low
// occupancy is the known gap, left for a later change (split the
// windows of a row across threads and tree-sum them).
#include "bn254_g1.cuh"

using namespace bn254;

namespace {

constexpr int WINDOWS = 64;  // 4-bit windows per 256-bit scalar
constexpr int DIGITS = 16;   // entries per window

// Hides a value from the optimiser: after this it cannot know that a
// mask is all zeros or all ones, so it keeps the AND/OR arithmetic.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The window entry `digit` of `window` (16 entries of 24 words), read by
// loading every entry and masking: the same loads whatever the digit.
__device__ __forceinline__ G1 g1_table_select(const uint32_t* __restrict__ window,
                                              uint32_t digit) {
  uint32_t w[G1_WORDS];
#pragma unroll
  for (int i = 0; i < G1_WORDS; ++i) w[i] = 0u;
#pragma unroll 1
  for (uint32_t d = 0; d < (uint32_t)DIGITS; ++d) {
    const uint32_t mask = opaque(0u - (uint32_t)(d == digit));
    const uint32_t* e = window + d * G1_WORDS;
#pragma unroll
    for (int i = 0; i < G1_WORDS; ++i) w[i] |= __ldg(e + i) & mask;
  }
  return g1_load(w);
}

template <bool SELECT>
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
        G1 pick = SELECT ? g1_table_select(table + (size_t)t * DIGITS * G1_WORDS, digit)
                         : g1_load(table + ((size_t)t * DIGITS + digit) * G1_WORDS);
        acc = g1_add(acc, pick);
      }
    }
  }
  g1_store_canon(out + (size_t)row * G1_WORDS, acc);
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_g1_msm(const uint32_t* table, const uint32_t* scalars, uint32_t* out,
                            int n, int nbases) {
  for (int row = 0; row < n; ++row) g1_msm_row<false>(table, scalars, out, row, nbases);
}

extern "C" void host_g1_msm_select(const uint32_t* table, const uint32_t* scalars,
                                   uint32_t* out, int n, int nbases) {
  for (int row = 0; row < n; ++row) g1_msm_row<true>(table, scalars, out, row, nbases);
}
#else
#include <cuda_runtime.h>

namespace {
constexpr int THREADS = 128;

template <bool SELECT>
__global__ void g1_msm_kernel(const uint32_t* __restrict__ table,
                              const uint32_t* __restrict__ scalars,
                              uint32_t* __restrict__ out, int n, int nbases) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) g1_msm_row<SELECT>(table, scalars, out, row, nbases);
}

template <bool SELECT>
int launch(const void* table, const void* scalars, void* out, int n, int nbases,
           void* stream) {
  if (n <= 0) return 0;
  int blocks = (n + THREADS - 1) / THREADS;
  g1_msm_kernel<SELECT><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)table, (const uint32_t*)scalars, (uint32_t*)out, n, nbases);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int fts_g1_msm(const void* table, const void* scalars, void* out,
                          int n, int nbases, void* stream) {
  return launch<false>(table, scalars, out, n, nbases, stream);
}

extern "C" int fts_g1_msm_select(const void* table, const void* scalars, void* out,
                                 int n, int nbases, void* stream) {
  return launch<true>(table, scalars, out, n, nbases, stream);
}
#endif
