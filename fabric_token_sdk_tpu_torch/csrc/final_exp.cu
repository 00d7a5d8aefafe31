// final_exp: f^((p^12 - 1) / r) on GT rows, each row spread over G
// lanes of a warp (the cooperative tower of bn254_gt_coop.cuh), its Fp12
// values in shared memory.
//
// Replaces the JAX program final_exp_tile (fabric_token_sdk_tpu/ops/
// pairing.py:final_exp). The exponentiation is the reference's schedule:
// the easy part t = conj(f) / f, t = t^(p^2) t; then three ladders over
// the bits of u (t^u, t^(u^2), t^(u^3)), the Straus pass over the bits of
// the balanced decomposition's coefficients (HP_BITS, signs HP_POS) and
// the Frobenius combine acc0 acc1^p acc2^(p^2) acc3^(p^3). After the
// easy part every value lies in the cyclotomic subgroup, so every
// squaring is Granger and Scott's (18 base products, against 36 for a
// general Fp12 squaring), and an accumulator still at one takes its
// first term as a copy. The schedule is FE_PROGRAM below, steps (op,
// dst, a, b) over ten Fp12 slots, run by one loop in which each op is
// inlined once: ops/pairing.py:final_exp_program() generates it and runs
// it as the plain version, and a CPU test holds this table equal to it.
// The result is unique, so it equals the reference's.
//
// Layout: f (n, 6, 2, 8) Montgomery Fp12 in [0, 2p); out (n, 6, 2, 8)
// canonical Montgomery.
//
// What bounds it on the H100: integer multiplies, ~9,600 CIOS products a
// row (102 Fp12 products, 198 cyclotomic squarings, the inverse); the
// bound counts ~8,800. A row's ops are a long dependent chain, so the
// time is the chain's latency until the card fills. The design: G = 8
// lanes a row, each with whole Fp elements, share the independent Fp2
// products of each op (18 in a product, 9 in a cyclotomic squaring) and
// its output coefficients, the row's ten Fp12 values and its product
// cells (5 KB) in shared memory instead of the old 9.8 KB stack, a
// lane's live registers a few Fp2. G is from the sweep of chip_probe.py
// over G in {1, 2, 4, 8, 16, 32}; spreading each field element over 2, 4
// or 8 lanes instead lost 4-12x to lanes of separate products, whose
// field needs no shuffle.
#include "bn254_gt_coop.cuh"

using namespace bn254;

#ifndef FTS_FINAL_EXP_G
#define FTS_FINAL_EXP_G 8  // lanes a row (chip_probe.py overrides it for its sweep)
#endif

namespace {

enum : uint32_t {
  OP_MUL = 1, OP_MULC, OP_CSQR, OP_FROB1, OP_FROB2, OP_FROB3, OP_CONJ, OP_INV, OP_COPY
};
constexpr int SLOT_OUT = 6;  // the first Straus accumulator
constexpr int G = FTS_FINAL_EXP_G;
static_assert(32 % G == 0, "a row's lanes tile a warp");
constexpr int THREADS = 32;  // one warp a block
constexpr int ROWS_PER_BLOCK = THREADS / G;
// a block's cells: the dynamic shared memory of a launch
constexpr size_t SMEM = (size_t)ROWS_PER_BLOCK * gtc::ROW_WORDS * 4;

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

// One row by this lane of NG. `live` is false for a row past the last: it
// runs (every lane takes part in every barrier) and stores nothing.
template <int NG>
__device__ __forceinline__ void final_exp_row(const gtc::Row<NG>& r, const uint32_t* __restrict__ f,
                                              uint32_t* __restrict__ out, int row, bool live) {
  const uint32_t* src = f + (size_t)row * gtc::GT_WORDS;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    if (!r.owns(j)) continue;
    gtc::Fe2 v;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      v.c0.w[k] = __ldg(src + (2 * j) * NW + k);
      v.c1.w[k] = __ldg(src + (2 * j + 1) * NW + k);
    }
    r.store(j, v);  // slot 0
  }
  r.sync();
#pragma unroll 1
  for (int pc = 0; pc < FE_PROGRAM_LEN; ++pc) {
    const uint32_t op = FE_PROGRAM[pc];
    const uint32_t code = op & 0xffu;
    const int dst = (int)((op >> 8) & 0xffu), a = (int)((op >> 16) & 0xffu), b = (int)(op >> 24);
    switch (code) {
      case OP_MUL:
      case OP_MULC:
        gtc::op_mul(r, dst, a, b, code == OP_MULC);
        break;
      case OP_CSQR:
        gtc::op_cyclo_sqr(r, dst, a);
        break;
      case OP_FROB1:
      case OP_FROB2:
      case OP_FROB3:
        gtc::op_frobenius(r, dst, a, (int)(code - OP_FROB1) + 1);
        break;
      case OP_INV:
        gtc::op_inv(r, dst, a);
        break;
      default:  // OP_COPY, OP_CONJ
        gtc::op_copy(r, dst, a, code == OP_CONJ);
        break;
    }
  }
  uint32_t* dst = out + (size_t)row * gtc::GT_WORDS;
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    if (!live || !r.owns(j)) continue;
    const gtc::Fe2 v = r.load(SLOT_OUT * 6 + j);
    const gtc::Fe c0 = coop::fe_canon(r.g, v.c0), c1 = coop::fe_canon(r.g, v.c1);
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      dst[(2 * j) * NW + k] = c0.w[k];
      dst[(2 * j + 1) * NW + k] = c1.w[k];
    }
  }
}

}  // namespace

// the kernel's lanes a row and its dynamic shared memory a block, as
// this library was built
extern "C" int fts_final_exp_config(int* g, int* smem) {
  *g = G;
  *smem = (int)SMEM;
  return 0;
}

#ifdef FTS_HOST_CHECK
namespace {
// The rows by G emulated lanes (host_check.h), a row's cells in a host
// buffer.
template <int NG>
void host_rows(const uint32_t* f, uint32_t* out, int n) {
  std::vector<uint32_t> cells(gtc::ROW_WORDS);
  for (int row = 0; row < n; ++row) {
    auto body = [&](int lane) {
      const gtc::Row<NG> r((uint32_t)lane, cells.data(), 1);
      final_exp_row<NG>(r, f, out, row, true);
    };
    coop::host_group(NG, body);
  }
}
}  // namespace

// the kernel's own configuration
extern "C" void host_final_exp(const uint32_t* f, uint32_t* out, int n) {
  host_rows<G>(f, out, n);
}

// the same rows by g lanes (1, 2, 4, 8, 16 or 32); returns -1 for any
// other
extern "C" int host_final_exp_lanes(const uint32_t* f, uint32_t* out, int n, int g) {
  switch (g) {
    case 1: return host_rows<1>(f, out, n), 0;
    case 2: return host_rows<2>(f, out, n), 0;
    case 4: return host_rows<4>(f, out, n), 0;
    case 8: return host_rows<8>(f, out, n), 0;
    case 16: return host_rows<16>(f, out, n), 0;
    case 32: return host_rows<32>(f, out, n), 0;
    default: return -1;
  }
}
#else
#include <cuda_runtime.h>

namespace {
__global__ void __launch_bounds__(THREADS) final_exp_kernel(const uint32_t* __restrict__ f,
                                                            uint32_t* __restrict__ out, int n) {
  extern __shared__ uint32_t cells[];
  const uint32_t slot = threadIdx.x / G;  // the row's place in the block
  const gtc::Row<G> r(threadIdx.x % G, cells + slot, ROWS_PER_BLOCK);
  const int row = (int)(blockIdx.x * ROWS_PER_BLOCK + slot);
  const bool live = row < n;  // a clamped row still takes part in every barrier
  final_exp_row<G>(r, f, out, live ? row : n - 1, live);
}
}  // namespace

extern "C" int fts_final_exp(const void* f, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  if (SMEM > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(final_exp_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  int blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  final_exp_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)f, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
