// final_exp: f^((p^12 - 1) / r) on GT rows, one thread per row.
//
// Replaces the JAX program final_exp_tile (fabric_token_sdk_tpu/ops/
// pairing.py:final_exp). Easy part: t = conj(f) / f, then
// t = t^(p^2) * t. Hard part by the reference's balanced decomposition
// of (p^4 - p^2 + 1) / r = sum_i lambda_i p^i, lambda_i = sum_k c_ik u^k
// (pairing.py:_LAMBDA_COEFFS): t^u, t^(u^2), t^(u^3) by three 63-bit
// ladders over the bits of u; the four accumulators acc_i =
// prod_k (t^(u^k))^(c_ik) by one Straus pass over the 6 bits of |c_ik|
// MSB first, a negative c_ik taking the conjugate (the inverse, t being
// unitary); then acc_0 * acc_1^p * acc_2^(p^2) * acc_3^(p^3). The result
// is unique, so it equals the reference's.
//
// The bits of u and the Straus tables are public constants, the same
// for every thread: the ladders and the Straus pass are real loops over
// them (uniform branches), not unrolled, to keep the build short.
//
// Layout: f (n, 6, 2, 8) Montgomery Fp12 in [0, 2p); out (n, 6, 2, 8)
// canonical Montgomery.
//
// What bounds it on the H100: integer multiplies, ~11,000 base products
// a row for the function (cyclotomic squarings in the u-ladders). The
// four accumulators and four bases are 768 words, so they live on the
// stack (local memory, cached in L1); one warp a block.
#include "bn254_tower.cuh"

using namespace bn254;

namespace {

constexpr int FP12_WORDS = 12 * NW;
constexpr uint64_t U_VALUE = 0x44e992b44a6909f1ull;  // u, 63 bits
constexpr int U_NBITS = 63;
constexpr int HP_NBITS = 6;

// HP_BITS[s][i][k]: bit s (MSB first) of |c_ik|; HP_POS[i][k]: c_ik >= 0
static __device__ __constant__ uint8_t HP_BITS[HP_NBITS][4][4] = {
    {{0, 0, 0, 1}, {0, 0, 0, 1}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 1, 1, 0}, {0, 0, 1, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 1, 0}, {0, 1, 0, 0}, {0, 0, 0, 0}, {0, 0, 0, 0}},
    {{0, 0, 1, 1}, {0, 1, 0, 1}, {0, 0, 1, 0}, {0, 0, 0, 0}},
    {{1, 1, 1, 0}, {0, 0, 1, 0}, {0, 0, 1, 0}, {0, 0, 0, 0}},
    {{0, 0, 0, 0}, {1, 0, 0, 0}, {1, 0, 0, 0}, {1, 0, 0, 0}},
};
static __device__ __constant__ uint8_t HP_POS[4][4] = {
    {0, 0, 0, 0}, {1, 0, 0, 0}, {1, 1, 1, 1}, {1, 1, 1, 1}};

// f^u, MSB first over the bits of u below its leading one
FTS_NOINLINE __device__ Fp12 pow_u(const Fp12& f) {
  Fp12 acc = f;
#pragma unroll 1
  for (int i = U_NBITS - 2; i >= 0; --i) {
    acc = fp12_sqr(acc);
    if ((U_VALUE >> i) & 1ull) acc = fp12_mul(acc, f);
  }
  return acc;
}

__device__ __forceinline__ void final_exp_row(const uint32_t* __restrict__ f_in,
                                              uint32_t* __restrict__ out, int row) {
  const Fp12 f = fp12_load(f_in + (size_t)row * FP12_WORDS);
  Fp12 t = fp12_mul(fp12_conj(f), fp12_inv(f));
  t = fp12_mul(fp12_frobenius(t, 2), t);
  Fp12 pw[4];
  pw[0] = t;
  pw[1] = pow_u(pw[0]);
  pw[2] = pow_u(pw[1]);
  pw[3] = pow_u(pw[2]);
  Fp12 acc[4];
#pragma unroll 1
  for (int i = 0; i < 4; ++i) acc[i] = fp12_one();
#pragma unroll 1
  for (int s = 0; s < HP_NBITS; ++s) {
#pragma unroll 1
    for (int i = 0; i < 4; ++i) acc[i] = fp12_sqr(acc[i]);
#pragma unroll 1
    for (int k = 0; k < 4; ++k) {
#pragma unroll 1
      for (int i = 0; i < 4; ++i) {
        if (HP_BITS[s][i][k])
          acc[i] = fp12_mul(acc[i], HP_POS[i][k] ? pw[k] : fp12_conj(pw[k]));
      }
    }
  }
  Fp12 r01 = fp12_mul(acc[0], fp12_frobenius(acc[1], 1));
  Fp12 r23 = fp12_mul(fp12_frobenius(acc[2], 2), fp12_frobenius(acc[3], 3));
  fp12_store_canon(out + (size_t)row * FP12_WORDS, fp12_mul(r01, r23));
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_final_exp(const uint32_t* f, uint32_t* out, int n) {
  for (int row = 0; row < n; ++row) final_exp_row(f, out, row);
}
#else
namespace {
constexpr int THREADS = 32;

__global__ void final_exp_kernel(const uint32_t* __restrict__ f, uint32_t* __restrict__ out,
                                 int n) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) final_exp_row(f, out, row);
}
}  // namespace

extern "C" int fts_final_exp(const void* f, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = ensure_stack();
  if (e != cudaSuccess) return (int)e;
  int blocks = (n + THREADS - 1) / THREADS;
  final_exp_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)f, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
