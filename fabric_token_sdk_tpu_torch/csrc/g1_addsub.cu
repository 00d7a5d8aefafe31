// g1_addsub: a + b or a - b on Jacobian points, each row spread over a
// group of TPI lanes of a warp.
//
// Replaces the JAX programs g1_sub_tile (fabric_token_sdk_tpu/ops/
// stages.py:_g1_sub_tile = curve.add(a, curve.neg(b))) and, with
// negate_b = 0, g1_add_tile (ops/curve.py:add): add-2007-bl with the
// doubling (dbl-2009-l) always computed and the reference's selects in
// its order: P == Q -> double(P); P == -Q -> the all-zero infinity; P at
// infinity -> Q; Q at infinity -> P. Every step is the same operation
// mod p as there, so the canonical output equals the plain version
// (ops/stages.py:g1_addsub_plain) and the JAX program bit for bit.
//
// Layout: a, b (n, 3, 8) Montgomery Jacobian in [0, 2p); out (n, 3, 8)
// canonical Montgomery.
//
// What bounds it on the H100: 16 products a row for the function
// against 288 bytes moved, so integer multiplies by a small margin; at
// the paths' rows (64 to 6,144) that is far below a launch's cost, so
// the time is one row's dependent chain: 23 products with the doubling
// it selects away. The design shortens each product: a row's elements
// are split over TPI lanes (bn254_ladder.cuh's cooperative field, the
// formula its coop::CurveG1::add), so a lane multiplies 8 / TPI words.
// TPI = 8 and 128 threads a block, from chip_probe.py --redesign --sweep
// add (TPI 2, 4, 8 at 32 and 128 threads; the formula's independent
// products split over lanes, as g2_add.cu does, lost at every row count
// there). The prove path adds secret-derived points (S^r + P^sig_bf): no
// address, branch or predicate depends on an operand; a group past the
// last row works on a clamped row and skips only its store.
#include "bn254_ladder.cuh"

using namespace bn254;

#ifndef FTS_G1_ADDSUB_TPI
#define FTS_G1_ADDSUB_TPI 8  // lanes a row (chip_probe.py overrides it for its sweep)
#endif
#ifndef FTS_G1_ADDSUB_THREADS
#define FTS_G1_ADDSUB_THREADS 128  // threads a block
#endif

namespace {
constexpr int TPI = FTS_G1_ADDSUB_TPI, THREADS = FTS_G1_ADDSUB_THREADS;
static_assert(THREADS % 32 == 0, "whole warps");
constexpr int ROWS = THREADS / TPI;  // rows a block

// a + b, or a - b with negate_b (Q's Y negated first), for one row by
// this lane of its group
template <int NT>
__device__ __forceinline__ void g1_addsub_row(const coop::Group<NT>& g,
                                              const uint32_t* __restrict__ a,
                                              const uint32_t* __restrict__ b,
                                              uint32_t* __restrict__ out, int row, bool live,
                                              bool negate_b) {
  constexpr int NL = coop::Group<NT>::NL;
  coop::Pt<NT, 3> p, q;
  const size_t at = (size_t)row * 3 * NW + g.lane * NL;
#pragma unroll
  for (int f = 0; f < 3; ++f)
#pragma unroll
    for (int k = 0; k < NL; ++k) {
      p.e[f].w[k] = __ldg(a + at + f * NW + k);
      q.e[f].w[k] = __ldg(b + at + f * NW + k);
    }
  if (negate_b) q.e[1] = coop::fe_sub(g, coop::fe_zero<NT>(), q.e[1]);  // uniform in a launch
  const coop::Pt<NT, 3> r = coop::CurveG1<NT>::add(g, p, q);
  if (!live) return;
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const coop::FeT<NT> c = coop::fe_canon(g, r.e[f]);
#pragma unroll
    for (int k = 0; k < NL; ++k) out[at + f * NW + k] = c.w[k];
  }
}
}  // namespace

// the kernel's lanes a row and threads a block, as this library was built
extern "C" int fts_g1_addsub_config(int* tpi, int* threads) {
  *tpi = TPI, *threads = THREADS;
  return 0;
}

#ifdef FTS_HOST_CHECK
namespace {
// the rows by an emulated group of NT lanes (host_check.h)
template <int NT>
void host_rows(const uint32_t* a, const uint32_t* b, uint32_t* out, int n, bool negate_b) {
  for (int row = 0; row < n; ++row) {
    auto body = [&](int lane) {
      g1_addsub_row<NT>(coop::Group<NT>((uint32_t)lane), a, b, out, row, true, negate_b);
    };
    coop::host_group(NT, body);
  }
}
}  // namespace

// the kernel's own configuration
extern "C" void host_g1_addsub(const uint32_t* a, const uint32_t* b, uint32_t* out, int n,
                               int negate_b) {
  host_rows<TPI>(a, b, out, n, negate_b != 0);
}

// the same rows by tpi lanes (1, 2, 4 or 8); returns -1 for any other
extern "C" int host_g1_addsub_lanes(const uint32_t* a, const uint32_t* b, uint32_t* out, int n,
                                    int negate_b, int tpi) {
  switch (tpi) {
    case 1: return host_rows<1>(a, b, out, n, negate_b != 0), 0;
    case 2: return host_rows<2>(a, b, out, n, negate_b != 0), 0;
    case 4: return host_rows<4>(a, b, out, n, negate_b != 0), 0;
    case 8: return host_rows<8>(a, b, out, n, negate_b != 0), 0;
    default: return -1;
  }
}
#else
#include <cuda_runtime.h>

namespace {
__global__ void __launch_bounds__(THREADS) g1_addsub_kernel(const uint32_t* __restrict__ a,
                                                            const uint32_t* __restrict__ b,
                                                            uint32_t* __restrict__ out, int n,
                                                            int negate_b) {
  const coop::Group<TPI> g(threadIdx.x % 32);
  const int row = (int)((blockIdx.x * THREADS + threadIdx.x) / TPI);
  const bool live = row < n;  // a clamped group still takes part in every shuffle
  g1_addsub_row<TPI>(g, a, b, out, live ? row : n - 1, live, negate_b != 0);
}
}  // namespace

// the blocks of the kernel an SM holds at once, as the card counts them
extern "C" int fts_g1_addsub_occupancy(int* blocks) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, g1_addsub_kernel, THREADS, 0);
}

extern "C" int fts_g1_addsub(const void* a, const void* b, void* out, int n, int negate_b,
                             void* stream) {
  if (n <= 0) return 0;
  const int blocks = (n + ROWS - 1) / ROWS;
  g1_addsub_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n, negate_b);
  return (int)cudaGetLastError();
}
#endif
