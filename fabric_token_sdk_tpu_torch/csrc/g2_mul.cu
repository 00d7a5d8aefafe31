// g2_mul: variable-base scalar multiplication [k]Q on G2, each row
// spread over a group of TPI lanes of a warp.
//
// Replaces the JAX program g2_mul_tile (fabric_token_sdk_tpu/ops/
// curve2.py:scalar_mul, a 256-step bit ladder) by the 4-bit window
// ladder of bn254_ladder.cuh over Fp2, as g1_mul.cu: a per-row table
// [0]Q .. [15]Q in shared memory, 64 windows MSB-first, the entry read
// by a masked scan of all 16. The scalars of the verify path are public
// proof responses, those of the prove path (the membership randomness
// rho_v, rho_h) secret: no address, branch or predicate depends on a
// digit. The plain version (ops/curve2.py:scalar_mul over
// ops/curve.py:window_mul) runs the same ladder and equals this kernel
// bit for bit.
//
// Layout: points (n, 3, 2, 8) Montgomery Jacobian in [0, 2p); scalars
// (n, 8) canonical words; out (n, 3, 2, 8) canonical Montgomery.
//
// What bounds it on the H100: integer multiplies, about 8,530 base
// products a row (a doubling 16, an addition 59 with the doubling it
// selects away). The G2 formulas are inlined over the cooperative field
// (TPI = 4, from chip_probe.py's sweep over 1, 2, 4, 8): a lane holds 12
// words of a point, so the formulas run in registers with no stack and
// no spill. 3 KB of table a row.
#include "bn254_ladder.cuh"

using namespace bn254;

#ifndef FTS_G2_MUL_TPI
#define FTS_G2_MUL_TPI 4  // lanes a row (chip_probe.py overrides it for its sweep)
#endif

// the kernel's lanes a row, as this library was built
extern "C" int fts_g2_mul_config(int* tpi) {
  *tpi = FTS_G2_MUL_TPI;
  return 0;
}

#ifdef FTS_HOST_CHECK
extern "C" void host_g2_mul(const uint32_t* points, const uint32_t* scalars, uint32_t* out,
                            int n) {
  coop::host_ladder<coop::CurveG2>(points, scalars, out, n, 1);
}

// the same rows by emulated groups of tpi lanes (2, 4 or 8)
extern "C" void host_g2_mul_lanes(const uint32_t* points, const uint32_t* scalars,
                                  uint32_t* out, int n, int tpi) {
  coop::host_ladder<coop::CurveG2>(points, scalars, out, n, tpi);
}
#else
namespace {
constexpr int TPI = FTS_G2_MUL_TPI;
constexpr int THREADS = 32;  // one warp a block: 32 / TPI rows

__global__ void __launch_bounds__(THREADS) g2_mul_kernel(const uint32_t* __restrict__ points,
                                                         const uint32_t* __restrict__ scalars,
                                                         uint32_t* __restrict__ out, int n) {
  extern __shared__ uint32_t tables[];
  const coop::Group<TPI> g(threadIdx.x % 32);
  const int row = (int)((blockIdx.x * blockDim.x + threadIdx.x) / TPI);
  const bool live = row < n;  // a clamped group still takes part in every shuffle
  coop::ladder_row<coop::CurveG2<TPI>, TPI>(g, points, scalars, out, live ? row : n - 1, live,
                                            tables + threadIdx.x, THREADS);
}
}  // namespace

extern "C" int fts_g2_mul(const void* points, const void* scalars, void* out, int n,
                          void* stream) {
  return coop::launch_ladder<TPI, 6, THREADS>(g2_mul_kernel, points, scalars, out, n, stream);
}
#endif
