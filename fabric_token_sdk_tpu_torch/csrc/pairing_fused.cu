// pairing_fused: a pairing product a row in one launch, one thread per
// row, in two modes of one template over `bool WITH_MILLER`:
//
// * fts_pairing_product (WITH_MILLER = true): prod_k e(P_k, Q_k) for each
//   row: the Miller loop of each of the row's K legs, their product, one
//   final exponentiation. Replaces the JAX programs behind
//   fabric_token_sdk_tpu/parallel/sharding.py:_fused_pairing_product
//   (the per-row body of its shard_map when mp = 1) and
//   fabric_token_sdk_tpu/ops/pairing.py:pairing_product (the fused entry
//   point).
// * fts_gt_product_final_exp (WITH_MILLER = false): the tail of the
//   sharded product, after the Miller values were gathered over the mp
//   axis: their product and one final exponentiation
//   (_fused_pairing_product's body after its all_gather).
//
// The Miller loop and the final exponentiation are those of
// bn254_pairing.cuh (the miller and final_exp kernels run the same
// code), so a row's GT value equals the staged sequence miller ->
// gt_product -> final_exp. The K legs are multiplied left to right; the
// product commutes and GT values are canonical, so the order does not
// change the result. A masked leg (mask != 0) contributes GT one, by a
// select after its Miller loop, as the reference's jnp.where: no branch
// and no address depends on the mask or the legs. Without a mask a
// (0, 0) leg runs through the loop, its Miller value lies in Fp4, and
// the final exponentiation sends it to one, as on the staged path.
//
// Stack: the Miller loop (2,424 bytes in miller.cu) and the final
// exponentiation (9,776 bytes in final_exp.cu) are __noinline__ calls
// here, so their frames do not add up; the row frame holds the running
// product and one leg's value. ensure_stack raises the limit to 16 KB.
//
// Layout: P (n, k, 2, 8), Q (n, k, 2, 2, 8) Montgomery affine in
// [0, 2p), mask (n, k) bytes or null; f (n, k, 6, 2, 8) Montgomery Fp12;
// out (n, 6, 2, 8) canonical Montgomery GT.
//
// What bounds it on the H100: integer multiplies, per row K Miller loops
// (~8,300 base products each), K - 1 Fp12 products and one final
// exponentiation (~11,000), against ~(K * 96 + 384) bytes moved
// (WITH_MILLER) or (K + 1) * 384; one warp a block. A simple kernel that
// is right: one thread walks the whole row serially, so K legs cost K
// Miller loops of latency; splitting legs over threads is later work.
#include "bn254_pairing.cuh"

using namespace bn254;

namespace {

FTS_NOINLINE __device__ Fp12 miller_call(const uint32_t* __restrict__ P,
                                         const uint32_t* __restrict__ Q, size_t leg) {
  return miller_leg(P, Q, leg);
}

FTS_NOINLINE __device__ Fp12 final_exp_call(const Fp12& f) { return final_exp(f); }

template <bool WITH_MILLER>
__device__ __forceinline__ Fp12 leg_value(const uint32_t* __restrict__ P,
                                          const uint32_t* __restrict__ Q,
                                          const uint8_t* __restrict__ mask,
                                          const uint32_t* __restrict__ f, size_t leg) {
  if constexpr (WITH_MILLER) {
    Fp12 v = miller_call(P, Q, leg);
    if (mask == nullptr) return v;
    uint32_t masked = 0u - (uint32_t)(mask[leg] != 0);
    return fp12_select(masked, fp12_one(), v);
  } else {
    return fp12_load(f + leg * FP12_WORDS);
  }
}

template <bool WITH_MILLER>
__device__ __forceinline__ void product_row(const uint32_t* __restrict__ P,
                                            const uint32_t* __restrict__ Q,
                                            const uint8_t* __restrict__ mask,
                                            const uint32_t* __restrict__ f,
                                            uint32_t* __restrict__ out, int row, int k) {
  const size_t first = (size_t)row * k;
  Fp12 acc = leg_value<WITH_MILLER>(P, Q, mask, f, first);
#pragma unroll 1
  for (int j = 1; j < k; ++j) acc = fp12_mul(acc, leg_value<WITH_MILLER>(P, Q, mask, f, first + j));
  fp12_store_canon(out + (size_t)row * FP12_WORDS, final_exp_call(acc));
}

}  // namespace

#ifdef FTS_HOST_CHECK
extern "C" void host_pairing_product(const uint32_t* P, const uint32_t* Q, const uint8_t* mask,
                                     uint32_t* out, int n, int k) {
  for (int row = 0; row < n; ++row) product_row<true>(P, Q, mask, nullptr, out, row, k);
}

extern "C" void host_gt_product_final_exp(const uint32_t* f, uint32_t* out, int n, int k) {
  for (int row = 0; row < n; ++row) product_row<false>(nullptr, nullptr, nullptr, f, out, row, k);
}
#else
namespace {
constexpr int THREADS = 32;

template <bool WITH_MILLER>
__global__ void product_kernel(const uint32_t* __restrict__ P, const uint32_t* __restrict__ Q,
                               const uint8_t* __restrict__ mask, const uint32_t* __restrict__ f,
                               uint32_t* __restrict__ out, int n, int k) {
  int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row < n) product_row<WITH_MILLER>(P, Q, mask, f, out, row, k);
}

template <bool WITH_MILLER>
int launch(const void* P, const void* Q, const void* mask, const void* f, void* out, int n, int k,
           void* stream) {
  if (n <= 0) return 0;
  if (k <= 0) return (int)cudaErrorInvalidValue;
  cudaError_t e = ensure_stack();
  if (e != cudaSuccess) return (int)e;
  int blocks = (n + THREADS - 1) / THREADS;
  product_kernel<WITH_MILLER><<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)P, (const uint32_t*)Q, (const uint8_t*)mask, (const uint32_t*)f,
      (uint32_t*)out, n, k);
  return (int)cudaGetLastError();
}
}  // namespace

extern "C" int fts_pairing_product(const void* P, const void* Q, const void* mask, void* out,
                                   int n, int k, void* stream) {
  return launch<true>(P, Q, mask, nullptr, out, n, k, stream);
}

extern "C" int fts_gt_product_final_exp(const void* f, void* out, int n, int k, void* stream) {
  return launch<false>(nullptr, nullptr, nullptr, f, out, n, k, stream);
}
#endif
