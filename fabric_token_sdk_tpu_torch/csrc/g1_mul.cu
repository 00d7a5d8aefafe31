// g1_mul: variable-base scalar multiplication [k]P, each row spread over
// a group of TPI lanes of a warp.
//
// Replaces the JAX program g1_mul_tile (fabric_token_sdk_tpu/ops/
// curve.py:scalar_mul, a 256-step bit ladder) by the 4-bit window
// ladder of bn254_ladder.cuh: a per-row table [0]P .. [15]P in shared
// memory, then 64 windows MSB-first, each 4 doublings and one addition
// of the entry read by a masked scan of all 16. No address, branch or
// predicate depends on a digit, so the prove plane's secret scalars are
// safe here. The result is the group element the reference computes,
// with another Jacobian Z; the plain version (ops/curve.py:window_mul)
// runs the same ladder and equals this kernel bit for bit.
//
// Layout: points (n, 3, 8) Montgomery Jacobian, coordinates in [0, 2p);
// scalars (n, 8) canonical words; out (n, 3, 8) canonical Montgomery.
//
// What bounds it on the H100: integer multiplies, about 3,520 CIOS
// products a row (table: a doubling and 13 additions; ladder: 63 x (4
// doublings + 1 addition), an addition 23 with the doubling it selects
// away, a doubling 7), with 120 bytes read and 96 written. The design
// fills the card: TPI lanes a row (TPI = 4, from the sweep of
// chip_probe.py over 1, 2, 4, 8) give 4x the warps of one thread a row,
// and a lane keeps 2 words of each element, so a point and the
// formulas' temporaries stay in registers. 1.5 KB of table a row.
#include "bn254_ladder.cuh"

using namespace bn254;

#ifndef FTS_G1_MUL_TPI
#define FTS_G1_MUL_TPI 4  // lanes a row (chip_probe.py overrides it for its sweep)
#endif

// the kernel's lanes a row, as this library was built
extern "C" int fts_g1_mul_config(int* tpi) {
  *tpi = FTS_G1_MUL_TPI;
  return 0;
}

#ifdef FTS_HOST_CHECK
extern "C" void host_g1_mul(const uint32_t* points, const uint32_t* scalars, uint32_t* out,
                            int n) {
  coop::host_ladder<coop::CurveG1>(points, scalars, out, n, 1);
}

// the same rows by emulated groups of tpi lanes (2, 4 or 8)
extern "C" void host_g1_mul_lanes(const uint32_t* points, const uint32_t* scalars,
                                  uint32_t* out, int n, int tpi) {
  coop::host_ladder<coop::CurveG1>(points, scalars, out, n, tpi);
}

// the ladder's cooperative field alone (mul, add, sub, is_zero) by groups
// of tpi lanes, for edge values
extern "C" void host_ladder_field(const uint32_t* a, const uint32_t* b, uint32_t* out, int n,
                                  int tpi) {
  coop::host_field(a, b, out, n, tpi);
}
#else
namespace {
constexpr int TPI = FTS_G1_MUL_TPI;
constexpr int THREADS = 32;  // one warp a block: 32 / TPI rows

__global__ void __launch_bounds__(THREADS) g1_mul_kernel(const uint32_t* __restrict__ points,
                                                         const uint32_t* __restrict__ scalars,
                                                         uint32_t* __restrict__ out, int n) {
  extern __shared__ uint32_t tables[];
  const coop::Group<TPI> g(threadIdx.x % 32);
  const int row = (int)((blockIdx.x * blockDim.x + threadIdx.x) / TPI);
  const bool live = row < n;  // a clamped group still takes part in every shuffle
  coop::ladder_row<coop::CurveG1<TPI>, TPI>(g, points, scalars, out, live ? row : n - 1, live,
                                            tables + threadIdx.x, THREADS);
}
}  // namespace

extern "C" int fts_g1_mul(const void* points, const void* scalars, void* out, int n,
                          void* stream) {
  return coop::launch_ladder<TPI, 3, THREADS>(g1_mul_kernel, points, scalars, out, n, stream);
}
#endif
