// The GT row functions over the cooperative tower of bn254_gt_coop.cuh,
// shared by the staged kernels and the fused one (pairing_fused.cu):
//
// * the product of a row's K Fp12 values (gt_product.cu): K - 1 op_mul
//   into slot 0, each next value taken into slot 1. The product is a
//   unique field element, so the order (left to right) does not change it;
//   the loop runs over the public K only.
// * the final exponentiation f^((p^12 - 1) / r) (final_exp.cu): the
//   reference's schedule (fabric_token_sdk_tpu/ops/pairing.py:final_exp):
//   the easy part t = conj(f) / f, t = t^(p^2) t; then three ladders over
//   the bits of u (t^u, t^(u^2), t^(u^3)), the Straus pass over the bits
//   of the balanced decomposition's coefficients and the Frobenius combine
//   acc0 acc1^p acc2^(p^2) acc3^(p^3). After the easy part every value
//   lies in the cyclotomic subgroup, so every squaring is Granger and
//   Scott's (18 base products, against 36 for a general Fp12 squaring),
//   and an accumulator still at one takes its first term as a copy. The
//   schedule is FE_PROGRAM below, steps (op, dst, a, b) over the row's ten
//   Fp12 slots, run by one loop in which each op is inlined once:
//   ops/pairing.py:final_exp_program() generates it and runs it as the
//   plain version, and a CPU test holds this table equal to it. Its input
//   is slot 0 and its result slot SLOT_OUT.
//
// Each takes its input from global memory or from a slot, and leaves its
// result in a slot, stored or not: the fused kernel chains them in shared
// memory. Every op is public; no address, branch or predicate depends on
// the values.
#pragma once

#include "bn254_gt_coop.cuh"

namespace bn254 {
namespace gtc {

// ---------------------------------------------------------------- product

// A row's values in global memory, value j at src + j * GT_WORDS.
struct FromGlobal {
  const uint32_t* __restrict__ src;

  template <int G, int NC>
  __device__ __forceinline__ void operator()(const Row<G, NC>& r, int j, int slot) const {
    load_slot(r, src + (size_t)j * GT_WORDS, slot);
  }
};

// ---------------------------------------------------------------- final exponentiation

enum : uint32_t {
  OP_MUL = 1, OP_MULC, OP_CSQR, OP_FROB1, OP_FROB2, OP_FROB3, OP_CONJ, OP_INV, OP_COPY
};
constexpr int SLOT_OUT = 6;  // the first Straus accumulator

// op | dst << 8 | a << 16 | b << 24; generated by ops/pairing.py:
// final_exp_program_words()
constexpr int FE_PROGRAM_LEN = 313;
static __device__ __constant__ uint32_t FE_PROGRAM[FE_PROGRAM_LEN] = {
    0x00000108u, 0x00000007u, 0x01000001u, 0x00000105u, 0x00010201u, 0x00020309u,
    0x00030303u, 0x00030303u, 0x00030303u, 0x00030303u, 0x02030301u, 0x00030303u,
    0x00030303u, 0x00030303u, 0x02030301u, 0x00030303u, 0x02030301u, 0x00030303u,
    0x02030301u, 0x00030303u, 0x00030303u, 0x02030301u, 0x00030303u, 0x00030303u,
    0x00030303u, 0x02030301u, 0x00030303u, 0x02030301u, 0x00030303u, 0x00030303u,
    0x00030303u, 0x02030301u, 0x00030303u, 0x00030303u, 0x00030303u, 0x02030301u,
    0x00030303u, 0x00030303u, 0x02030301u, 0x00030303u, 0x00030303u, 0x02030301u,
    0x00030303u, 0x02030301u, 0x00030303u, 0x00030303u, 0x02030301u, 0x00030303u,
    0x00030303u, 0x00030303u, 0x00030303u, 0x02030301u, 0x00030303u, 0x00030303u,
    0x00030303u, 0x02030301u, 0x00030303u, 0x00030303u, 0x02030301u, 0x00030303u,
    0x00030303u, 0x00030303u, 0x02030301u, 0x00030303u, 0x02030301u, 0x00030303u,
    0x00030303u, 0x02030301u, 0x00030303u, 0x00030303u, 0x00030303u, 0x02030301u,
    0x00030303u, 0x00030303u, 0x00030303u, 0x00030303u, 0x00030303u, 0x02030301u,
    0x00030303u, 0x00030303u, 0x00030303u, 0x02030301u, 0x00030303u, 0x02030301u,
    0x00030303u, 0x02030301u, 0x00030303u, 0x02030301u, 0x00030303u, 0x02030301u,
    0x00030303u, 0x00030303u, 0x00030303u, 0x00030303u, 0x02030301u, 0x00030409u,
    0x00040403u, 0x00040403u, 0x00040403u, 0x00040403u, 0x03040401u, 0x00040403u,
    0x00040403u, 0x00040403u, 0x03040401u, 0x00040403u, 0x03040401u, 0x00040403u,
    0x03040401u, 0x00040403u, 0x00040403u, 0x03040401u, 0x00040403u, 0x00040403u,
    0x00040403u, 0x03040401u, 0x00040403u, 0x03040401u, 0x00040403u, 0x00040403u,
    0x00040403u, 0x03040401u, 0x00040403u, 0x00040403u, 0x00040403u, 0x03040401u,
    0x00040403u, 0x00040403u, 0x03040401u, 0x00040403u, 0x00040403u, 0x03040401u,
    0x00040403u, 0x03040401u, 0x00040403u, 0x00040403u, 0x03040401u, 0x00040403u,
    0x00040403u, 0x00040403u, 0x00040403u, 0x03040401u, 0x00040403u, 0x00040403u,
    0x00040403u, 0x03040401u, 0x00040403u, 0x00040403u, 0x03040401u, 0x00040403u,
    0x00040403u, 0x00040403u, 0x03040401u, 0x00040403u, 0x03040401u, 0x00040403u,
    0x00040403u, 0x03040401u, 0x00040403u, 0x00040403u, 0x00040403u, 0x03040401u,
    0x00040403u, 0x00040403u, 0x00040403u, 0x00040403u, 0x00040403u, 0x03040401u,
    0x00040403u, 0x00040403u, 0x00040403u, 0x03040401u, 0x00040403u, 0x03040401u,
    0x00040403u, 0x03040401u, 0x00040403u, 0x03040401u, 0x00040403u, 0x03040401u,
    0x00040403u, 0x00040403u, 0x00040403u, 0x00040403u, 0x03040401u, 0x00040509u,
    0x00050503u, 0x00050503u, 0x00050503u, 0x00050503u, 0x04050501u, 0x00050503u,
    0x00050503u, 0x00050503u, 0x04050501u, 0x00050503u, 0x04050501u, 0x00050503u,
    0x04050501u, 0x00050503u, 0x00050503u, 0x04050501u, 0x00050503u, 0x00050503u,
    0x00050503u, 0x04050501u, 0x00050503u, 0x04050501u, 0x00050503u, 0x00050503u,
    0x00050503u, 0x04050501u, 0x00050503u, 0x00050503u, 0x00050503u, 0x04050501u,
    0x00050503u, 0x00050503u, 0x04050501u, 0x00050503u, 0x00050503u, 0x04050501u,
    0x00050503u, 0x04050501u, 0x00050503u, 0x00050503u, 0x04050501u, 0x00050503u,
    0x00050503u, 0x00050503u, 0x00050503u, 0x04050501u, 0x00050503u, 0x00050503u,
    0x00050503u, 0x04050501u, 0x00050503u, 0x00050503u, 0x04050501u, 0x00050503u,
    0x00050503u, 0x00050503u, 0x04050501u, 0x00050503u, 0x04050501u, 0x00050503u,
    0x00050503u, 0x04050501u, 0x00050503u, 0x00050503u, 0x00050503u, 0x04050501u,
    0x00050503u, 0x00050503u, 0x00050503u, 0x00050503u, 0x00050503u, 0x04050501u,
    0x00050503u, 0x00050503u, 0x00050503u, 0x04050501u, 0x00050503u, 0x04050501u,
    0x00050503u, 0x04050501u, 0x00050503u, 0x04050501u, 0x00050503u, 0x04050501u,
    0x00050503u, 0x00050503u, 0x00050503u, 0x00050503u, 0x04050501u, 0x00050607u,
    0x00050707u, 0x00060603u, 0x00070703u, 0x03060602u, 0x04060602u, 0x04070702u,
    0x00060603u, 0x00070703u, 0x03070702u, 0x04060602u, 0x00060603u, 0x00070703u,
    0x03070702u, 0x04060602u, 0x00040809u, 0x05060602u, 0x05070702u, 0x00060603u,
    0x00070703u, 0x00080803u, 0x02060602u, 0x03060602u, 0x04060602u, 0x04070702u,
    0x04080801u, 0x00060603u, 0x00070703u, 0x00080803u, 0x02070701u, 0x02080801u,
    0x00020909u, 0x00070004u, 0x00060601u, 0x00080005u, 0x00090106u, 0x01000001u,
    0x00060601u,
};

// A row's program through one dispatch loop: the product of its values j0
// .. j0 + nj - 1 into slot 0, then, with fexp, the final exponentiation of
// slot 0 into slot SLOT_OUT (the row's ten slots its scratch), ending with
// a barrier. take(r, j, slot) puts this lane's coefficients of value j
// into a slot and ends with a barrier; value 0 is taken into slot 0, any
// other into slot 1 and multiplied in. Take is a functor with an inlined
// call (a lambda's call may stay a call, and its captures then go to the
// stack). Each op is inlined once, so the product's op_mul is the
// program's own: a second inlined op_mul made the fused kernel's body
// larger and its tail ~20% slower at 3,968 rows.
template <int G, int NC, class Take>
__device__ __forceinline__ void program_run(const Row<G, NC>& r, int j0, int nj, const Take& take,
                                            bool fexp) {
  const int pre = 2 * nj;  // a take, then a product, a value
  const int len = pre + (fexp ? FE_PROGRAM_LEN : 0);
#pragma unroll 1
  for (int pc = 0; pc < len; ++pc) {
    uint32_t op;
    if (pc < pre) {
      const int j = j0 + (pc >> 1);
      if (!(pc & 1)) {
        take(r, j, j == 0 ? 0 : 1);
        continue;
      }
      if (j == 0) continue;
      op = OP_MUL | 1u << 24;  // slot 0 = slot 0 * slot 1
    } else {
      op = FE_PROGRAM[pc - pre];
    }
    const uint32_t code = op & 0xffu;
    const int dst = (int)((op >> 8) & 0xffu), a = (int)((op >> 16) & 0xffu), b = (int)(op >> 24);
    switch (code) {
      case OP_MUL:
      case OP_MULC:
        op_mul(r, dst, a, b, code == OP_MULC);
        break;
      case OP_CSQR:
        op_cyclo_sqr(r, dst, a);
        break;
      case OP_FROB1:
      case OP_FROB2:
      case OP_FROB3:
        op_frobenius(r, dst, a, (int)(code - OP_FROB1) + 1);
        break;
      case OP_INV:
        op_inv(r, dst, a);
        break;
      default:  // OP_COPY, OP_CONJ
        op_copy(r, dst, a, code == OP_CONJ);
        break;
    }
  }
}

// One row of f (n, k, 6, 2, 8) by this lane of NG, its product stored at
// row `row` of out. `live` is false for a row past the last: it runs
// (every lane takes part in every barrier) and stores nothing.
template <int NG, int NC>
__device__ __forceinline__ void gt_product_row(const Row<NG, NC>& r, const uint32_t* __restrict__ f,
                                               uint32_t* __restrict__ out, int row, int k,
                                               bool live) {
  program_run(r, 0, k, FromGlobal{f + (size_t)row * k * GT_WORDS}, false);
  store_slot(r, 0, out + (size_t)row * GT_WORDS, live);
}

// no value to take
struct NoTake {
  template <int G, int NC>
  __device__ __forceinline__ void operator()(const Row<G, NC>&, int, int) const {}
};

// The final exponentiation of slot 0 into slot SLOT_OUT by this lane of G
// (the row's ten slots are its scratch), ending with a barrier.
template <int G, int NC>
__device__ __forceinline__ void final_exp_run(const Row<G, NC>& r) {
  program_run(r, 0, 0, NoTake{}, true);
}

// One row of f (n, 6, 2, 8) by this lane of NG, its canonical result
// stored at row `row` of out. `live` is false for a row past the last: it
// runs (every lane takes part in every barrier) and stores nothing.
template <int NG>
__device__ __forceinline__ void final_exp_row(const Row<NG>& r, const uint32_t* __restrict__ f,
                                              uint32_t* __restrict__ out, int row, bool live) {
  load_slot(r, f + (size_t)row * GT_WORDS, 0);
  final_exp_run(r);
  store_slot(r, SLOT_OUT, out + (size_t)row * GT_WORDS, live);
}

}  // namespace gtc
}  // namespace bn254
