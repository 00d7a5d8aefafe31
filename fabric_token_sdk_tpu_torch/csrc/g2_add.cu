// g2_add: a + b on G2 Jacobian points, the formula's independent base
// products spread over a group of G lanes a row.
//
// Replaces the JAX program g2_add_tile (fabric_token_sdk_tpu/ops/
// curve2.py:add): add-2007-bl over Fp2 with the doubling (dbl-2009-l)
// always computed and the reference's selects in its order: P == Q ->
// double(P); P == -Q -> the all-zero infinity; P at infinity -> Q; Q at
// infinity -> P. Every coordinate is the same element mod p as there and
// the output is canonical, so it equals the plain version (ops/stages.py:
// g2_add_plain) and the JAX program bit for bit; only the grouping of
// the products differs (S1 as (Y1 Z2) Z2Z2, the doubling's Z3 as (2 Y1)
// Z1, D - X3 as 3 D - F, V - X3 as 3 V - RR + J, squares as Karatsuba
// products), which no field element depends on.
//
// Layout: a, b (n, 3, 2, 8) Montgomery Jacobian in [0, 2p); out
// (n, 3, 2, 8) canonical Montgomery.
//
// What bounds it on the H100: 43 base products a row for the function
// (11 Fp2 products and 5 squarings) against 576 bytes moved, so integer
// multiplies by a small margin; at the paths' rows (64 to 3,968) that is
// far below a launch's cost, so the time is one row's chain: one thread a
// row ran 59 dependent base products (the doubling it selects away
// included) with a 672 B stack. The design shortens the chain to the
// formula's depth. Each lane holds whole elements (bn254_ladder.cuh's
// field at TPI = 1); a row's values are cells in shared memory, an Fp2
// value as three elements (c0, c1, c0 + c1), and the formula is six
// phases, each a step of combinations (ADD_LIN: a cell gets a sum of
// cells times small integers) and a step of products (ADD_PROD: a cell
// gets the product of two), the next phase first assembling each Fp2
// product from its Karatsuba base products (c0 c0', c1 c1', (c0 + c1)(c0'
// + c1')). Task t of a step runs in lane t mod G, __syncwarp between
// steps; every product is one product of two stored elements, so the
// lanes of a step run the same code. A lane's chain is then 5 rounds of
// products at G = 16 or 32 (the phases hold 24, 21, 12, 6 and 6 base
// products), not 59. G = 16 and 32 threads a block, from chip_probe.py
// --redesign --sweep add (G 4, 8, 16, 32 at 32 and 128 threads; each
// element split over TPI lanes, as g1_addsub.cu does, was 1.2-2.2x
// slower at the paths' 64 to 3,968 rows). No address, branch or
// predicate depends on an operand
// (the prove path adds secret-derived points): every branch and address
// depends on the task tables, the lane's place and the row count, and
// the selects are masks. A row past the last runs on a clamped row,
// takes part in every barrier and stores nothing. Nothing lives on a
// stack.
#include "bn254_ladder.cuh"

using namespace bn254;

#ifndef FTS_G2_ADD_G
#define FTS_G2_ADD_G 16  // lanes a row (chip_probe.py overrides it for its sweep)
#endif
#ifndef FTS_G2_ADD_THREADS
#define FTS_G2_ADD_THREADS 32  // threads a block
#endif

namespace {

using Fe = coop::FeT<1>;
using Grp = coop::Group<1>;

// A row's value cells, each an Fp2 value as (c0, c1, c0 + c1). The sum
// X3, Y3, Z3 and the doubling's X3D, Y3D, DZ are consecutive: coordinate
// c is cell X3 + c.
enum : int {
  X1, Y1, Z1, X2, Y2, Z2,          // the operands
  ZSUM, Y1D,                       // Z1 + Z2, 2 Y1
  Z1Z1, Z2Z2, T1, T2, ZS, A, B,    // phase 1: Z1^2, Z2^2, Y1 Z2, Y2 Z1, ZSUM^2, X1^2, Y1^2
  XB1, E,                          // X1 + B, 3 A
  U1, U2, S1, S2, C, XB, F,        // phase 2: X1 Z2Z2, X2 Z1Z1, T1 Z2Z2, T2 Z1Z1, B^2, XB1^2, E^2
  H, H2, ZZ, R, D, DF,             // U2 - U1, 2 H, ZS - Z1Z1 - Z2Z2, 2 (S2 - S1), 2 (XB - A - C), 3 D - F
  I, RR, DY,                       // phase 3: H2^2, R^2, E DF
  J, V, VX, S1J, RY,               // phase 4: H I, U1 I; 3 V - RR + J; phase 5: S1 J, R VX
  X3, Y3, Z3,                      // the sum (Z3 = ZZ H, phase 3)
  X3D, Y3D, DZ,                    // the doubling (DZ = Y1D Z1, phase 1)
  NV
};

// A combination: cell dst gets the sum of coef[t] times cell[t], t < n.
// 16 bytes, read as one 16-byte load.
struct alignas(16) Lin {
  uint8_t dst, n, cell[6];
  int8_t coef[6];
  uint8_t pad[2];
};

// A product: cell dst gets cell a times cell b.
struct alignas(4) Prod {
  uint8_t dst, a, b, pad;
};

// add-2007-bl and dbl-2009-l: each phase's combinations, then its products
static __device__ const Lin ADD_LIN[] = {
    {ZSUM, 2, {Z1, Z2}, {1, 1}},  // phase 1
    {Y1D, 1, {Y1}, {2}},
    {XB1, 2, {X1, B}, {1, 1}},  // phase 2
    {E, 1, {A}, {3}},
    {H, 2, {U2, U1}, {1, -1}},  // phase 3
    {H2, 2, {U2, U1}, {2, -2}},
    {ZZ, 3, {ZS, Z1Z1, Z2Z2}, {1, -1, -1}},
    {R, 2, {S2, S1}, {2, -2}},
    {D, 3, {XB, A, C}, {2, -2, -2}},
    {DF, 4, {XB, A, C, F}, {6, -6, -6, -1}},
    {X3D, 2, {F, D}, {1, -2}},  // phase 4
    {Y3D, 2, {DY, C}, {1, -8}},
    {VX, 3, {V, RR, J}, {3, -1, 1}},  // phase 5
    {X3, 3, {RR, J, V}, {1, -1, -2}},
    {Y3, 2, {RY, S1J}, {1, -2}},  // phase 6
};
static __device__ const Prod ADD_PROD[] = {
    {Z1Z1, Z1, Z1}, {Z2Z2, Z2, Z2}, {T1, Y1, Z2}, {T2, Y2, Z1},  // phase 1
    {ZS, ZSUM, ZSUM}, {A, X1, X1}, {B, Y1, Y1}, {DZ, Y1D, Z1},
    {U1, X1, Z2Z2}, {U2, X2, Z1Z1}, {S1, T1, Z2Z2}, {S2, T2, Z1Z1},  // phase 2
    {C, B, B}, {XB, XB1, XB1}, {F, E, E},
    {I, H2, H2}, {Z3, ZZ, H}, {RR, R, R}, {DY, E, DF},  // phase 3
    {J, H, I}, {V, U1, I},  // phase 4
    {S1J, S1, J}, {RY, R, VX},  // phase 5
};

// A phase: its combinations, then its products (first and count of each).
struct Phase {
  uint8_t lin, nlin, prod, nprod;
};
constexpr int NPHASES = 6;
static __device__ __constant__ Phase ADD_PHASES[NPHASES] = {
    {0, 2, 0, 8}, {2, 2, 8, 7}, {4, 6, 15, 4}, {10, 2, 19, 2}, {12, 2, 21, 2}, {14, 1, 23, 0}};
constexpr int MAX_PROD = 8;  // products of a phase

// combination k: its cells and coefficients packed into 64 bits each, so
// that a term is picked by a shift and never by an index into an array
// (which would put the task in local memory)
struct LinTask {
  uint32_t dst, n;
  uint64_t cells, coefs;
  __device__ __forceinline__ int cell(int t) const { return (int)((cells >> (8 * t)) & 0xffu); }
  __device__ __forceinline__ int coef(int t) const {
    return (int)(int8_t)(uint8_t)((coefs >> (8 * t)) & 0xffu);
  }
};

__device__ __forceinline__ LinTask lin_task(int k) {
  uint32_t w[4];
#ifdef FTS_HOST_CHECK
  const uint8_t* src = reinterpret_cast<const uint8_t*>(ADD_LIN + k);
  for (int i = 0; i < 4; ++i)
    w[i] = src[4 * i] | src[4 * i + 1] << 8 | src[4 * i + 2] << 16 | (uint32_t)src[4 * i + 3] << 24;
#else
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(ADD_LIN) + k);
  w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
#endif
  LinTask t;
  t.dst = w[0] & 0xffu, t.n = (w[0] >> 8) & 0xffu;
  t.cells = (w[0] >> 16) | (uint64_t)w[1] << 16;
  t.coefs = w[2] | (uint64_t)w[3] << 32;
  return t;
}

// product k as dst | a << 8 | b << 16
__device__ __forceinline__ uint32_t prod_task(int k) {
#ifdef FTS_HOST_CHECK
  const Prod& p = ADD_PROD[k];
  return p.dst | p.a << 8 | p.b << 16;
#else
  return __ldg(reinterpret_cast<const uint32_t*>(ADD_PROD) + k);
#endif
}

// The cells of NR rows of a block, interleaved word by word (word k of
// element e of a row at col[e * EP + k * NR], col the row's column), with
// one word of padding an element so that the lanes of a row reading
// different cells fall in different banks. Elements: the 3 of each value
// cell, then the 3 base products of each product of a phase.
template <int NG, int NR>
struct Row {
  static_assert(32 % NG == 0, "a row's lanes tile a warp");
  static constexpr int PART = NV * 3;  // the first base-product element
  static constexpr int NE = PART + 3 * MAX_PROD;
  static constexpr int EP = 8 * NR + 1;
  static constexpr int WORDS = NE * EP;  // shared-memory words of a block's rows
  Grp g;
  uint32_t grp;   // this lane's place in the row, 0 .. NG-1
  uint32_t* col;  // the row's column

  __device__ __forceinline__ Row(uint32_t lane, uint32_t* column) : g(0u), grp(lane), col(column) {}

  __device__ __forceinline__ Fe load(int e) const {
    Fe v;
#pragma unroll
    for (int k = 0; k < NW; ++k) v.w[k] = col[e * EP + k * NR];
    return v;
  }
  __device__ __forceinline__ void store(int e, const Fe& v) const {
#pragma unroll
    for (int k = 0; k < NW; ++k) col[e * EP + k * NR] = v.w[k];
  }

  // orders one step's stores before the next step's loads
  __device__ __forceinline__ void sync() const {
    if constexpr (NG > 1) {
#ifdef FTS_HOST_CHECK
      fts_host::sync();
#else
      __syncwarp();
#endif
    }
  }
};

// each Fp2 product's value from its base products p0, p1, p2 (c0 = p0 -
// p1, c1 = p2 - p0 - p1, c0 + c1 = p2 - 2 p1), element j of product t by
// lane (3 t + j) mod NG
template <int NG, int NR>
__device__ __forceinline__ void assemble(const Row<NG, NR>& r, int first, int n) {
  const Grp& g = r.g;
#pragma unroll 1
  for (int q = (int)r.grp; q < 3 * n; q += NG) {
    const int t = q / 3, j = q % 3, at = Row<NG, NR>::PART + 3 * t;
    const Fe p0 = r.load(at), p1 = r.load(at + 1), p2 = r.load(at + 2);
    const uint32_t j0 = 0u - (uint32_t)(j == 0), j1 = 0u - (uint32_t)(j == 1);
    const Fe u = coop::fe_sub(g, coop::fe_select(j0, p0, p2), p1);  // p0 - p1, or p2 - p1
    const Fe v = coop::fe_sub(g, u, coop::fe_select(j1, p0, p1));   // then - p0, or - p1
    r.store((int)(prod_task(first + t) & 0xffu) * 3 + j, coop::fe_select(j0, u, v));
  }
  r.sync();
}

// a phase's combinations, element j of combination t by lane (3 t + j)
// mod NG
template <int NG, int NR>
__device__ __forceinline__ void combinations(const Row<NG, NR>& r, int first, int n) {
#pragma unroll 1
  for (int q = (int)r.grp; q < 3 * n; q += NG) {
    const int j = q % 3;
    const LinTask op = lin_task(first + q / 3);
    Fe acc = coop::fe_zero<1>();
#pragma unroll 1
    for (int t = 0; t < (int)op.n; ++t) {
      const Fe v = r.load(op.cell(t) * 3 + j);
      const int m = op.coef(t);
      const uint32_t am = (uint32_t)(m < 0 ? -m : m);
      int top = 0;
#pragma unroll 1
      while ((am >> (top + 1)) != 0u) ++top;
      Fe x = v;  // am v, from the top bit of am down
#pragma unroll 1
      for (int bit = top - 1; bit >= 0; --bit) {
        x = coop::fe_add(r.g, x, x);
        if ((am >> bit) & 1u) x = coop::fe_add(r.g, x, v);
      }
      if (t == 0) {
        acc = m < 0 ? coop::fe_sub(r.g, acc, x) : x;
      } else {
        acc = m < 0 ? coop::fe_sub(r.g, acc, x) : coop::fe_add(r.g, acc, x);
      }
    }
    r.store((int)op.dst * 3 + j, acc);
  }
  r.sync();
}

// a phase's base products, element j of the operands' product t by lane
// (3 t + j) mod NG: c0 c0', c1 c1', (c0 + c1)(c0' + c1')
template <int NG, int NR>
__device__ __forceinline__ void products(const Row<NG, NR>& r, int first, int n) {
#pragma unroll 1
  for (int q = (int)r.grp; q < 3 * n; q += NG) {
    const int j = q % 3;
    const uint32_t op = prod_task(first + q / 3);
    const Fe x = r.load((int)((op >> 8) & 0xffu) * 3 + j);
    const Fe y = r.load((int)((op >> 16) & 0xffu) * 3 + j);
    r.store(Row<NG, NR>::PART + q, coop::fe_mul(r.g, x, y));
  }
  r.sync();
}

// all ones when cell c represents 0 (c0 and c1)
template <int NG, int NR>
__device__ __forceinline__ uint32_t cell_is_zero(const Row<NG, NR>& r, int c) {
  return coop::fe_is_zero(r.g, r.load(c * 3)) & coop::fe_is_zero(r.g, r.load(c * 3 + 1));
}

// a + b for one row by this lane of its NG
template <int NG, int NR>
__device__ __forceinline__ void g2_add_row(const Row<NG, NR>& r, const uint32_t* __restrict__ a,
                                           const uint32_t* __restrict__ b,
                                           uint32_t* __restrict__ out, int row, bool live) {
  const Grp& g = r.g;
  constexpr int EW = 3 * 2 * NW;  // words of a point
  // the operands into cells X1 .. Z2, value v by lane v mod NG
#pragma unroll 1
  for (int v = (int)r.grp; v < 6; v += NG) {
    const uint32_t* src = (v < 3 ? a : b) + (size_t)row * EW + (v % 3) * 2 * NW;
    Fe c0, c1;
#pragma unroll
    for (int k = 0; k < NW; ++k) {
      c0.w[k] = __ldg(src + k);
      c1.w[k] = __ldg(src + NW + k);
    }
    r.store(v * 3, c0);
    r.store(v * 3 + 1, c1);
    r.store(v * 3 + 2, coop::fe_add(g, c0, c1));
  }
  r.sync();
#pragma unroll 1
  for (int ph = 0; ph < NPHASES; ++ph) {
    const Phase d = ADD_PHASES[ph];
    if (ph > 0) {
      const Phase prev = ADD_PHASES[ph - 1];
      assemble(r, prev.prod, prev.nprod);
    }
    combinations(r, d.lin, d.nlin);
    if (d.nprod) products(r, d.prod, d.nprod);
  }
  // the selects, in the reference's order, and the store: coordinate c
  // by lane c mod NG; the masks opaque, so that the compiler makes no
  // predicated load or select of them
  const uint32_t same_x = coop::opaque(cell_is_zero(r, H));
  const uint32_t same_y = coop::opaque(cell_is_zero(r, R));
  const uint32_t inf1 = coop::opaque(cell_is_zero(r, Z1));
  const uint32_t inf2 = coop::opaque(cell_is_zero(r, Z2));
  const uint32_t finite = ~inf1 & ~inf2;
#pragma unroll 1
  for (int c = (int)r.grp; c < 3; c += NG) {
    uint32_t* dst = out + (size_t)row * EW + c * 2 * NW;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      Fe v = r.load((X3 + c) * 3 + j);
      v = coop::fe_select(same_x & same_y & finite, r.load((X3D + c) * 3 + j), v);
      v = coop::fe_select(same_x & ~same_y & finite, coop::fe_zero<1>(), v);
      v = coop::fe_select(inf1, r.load((X2 + c) * 3 + j), v);
      v = coop::fe_select(inf2, r.load((X1 + c) * 3 + j), v);
      const Fe w = coop::fe_canon(g, v);
      if (live) {
#pragma unroll
        for (int k = 0; k < NW; ++k) dst[j * NW + k] = w.w[k];
      }
    }
  }
}

constexpr int G = FTS_G2_ADD_G, THREADS = FTS_G2_ADD_THREADS;
static_assert(THREADS % 32 == 0, "whole warps");
constexpr int ROWS = THREADS / G;  // rows a block
// a block's cells: the dynamic shared memory of a launch
constexpr size_t SMEM = (size_t)Row<G, ROWS>::WORDS * 4;

}  // namespace

// the kernel's lanes a row, threads and dynamic shared memory a block,
// as this library was built
extern "C" int fts_g2_add_config(int* g, int* threads, int* smem) {
  *g = G, *threads = THREADS, *smem = (int)SMEM;
  return 0;
}

#ifdef FTS_HOST_CHECK
namespace {
// the rows by NG emulated lanes (host_check.h), a row's cells in a host
// buffer
template <int NG>
void host_rows(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  std::vector<uint32_t> cells(Row<NG, 1>::WORDS);
  for (int row = 0; row < n; ++row) {
    auto body = [&](int lane) {
      g2_add_row<NG, 1>(Row<NG, 1>((uint32_t)lane, cells.data()), a, b, out, row, true);
    };
    coop::host_group(NG, body);
  }
}
}  // namespace

// the kernel's own configuration
extern "C" void host_g2_add(const uint32_t* a, const uint32_t* b, uint32_t* out, int n) {
  host_rows<G>(a, b, out, n);
}

// the same rows by g lanes (1, 2, 4, 8, 16 or 32); returns -1 for any
// other
extern "C" int host_g2_add_lanes(const uint32_t* a, const uint32_t* b, uint32_t* out, int n,
                                 int g) {
  switch (g) {
    case 1: return host_rows<1>(a, b, out, n), 0;
    case 2: return host_rows<2>(a, b, out, n), 0;
    case 4: return host_rows<4>(a, b, out, n), 0;
    case 8: return host_rows<8>(a, b, out, n), 0;
    case 16: return host_rows<16>(a, b, out, n), 0;
    case 32: return host_rows<32>(a, b, out, n), 0;
    default: return -1;
  }
}
#else
#include <cuda_runtime.h>

namespace {
__global__ void __launch_bounds__(THREADS) g2_add_kernel(const uint32_t* __restrict__ a,
                                                         const uint32_t* __restrict__ b,
                                                         uint32_t* __restrict__ out, int n) {
  extern __shared__ uint32_t cells[];
  const uint32_t slot = threadIdx.x / G;  // the row's place in the block
  const Row<G, ROWS> r(threadIdx.x % G, cells + slot);
  const int row = (int)(blockIdx.x * ROWS + slot);
  const bool live = row < n;  // a clamped row still takes part in every barrier
  g2_add_row<G, ROWS>(r, a, b, out, live ? row : n - 1, live);
}

// lets a launch take SMEM of dynamic shared memory (above 48 KB only
// by the attribute)
cudaError_t prepare() {
  if (SMEM <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(g2_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)SMEM);
}
}  // namespace

// the blocks of the kernel an SM holds at once, as the card counts them
extern "C" int fts_g2_add_occupancy(int* blocks) {
  cudaError_t e = prepare();
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, g2_add_kernel, THREADS, SMEM);
}

extern "C" int fts_g2_add(const void* a, const void* b, void* out, int n, void* stream) {
  if (n <= 0) return 0;
  cudaError_t e = prepare();
  if (e != cudaSuccess) return (int)e;
  const int blocks = (n + ROWS - 1) / ROWS;
  g2_add_kernel<<<blocks, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
#endif
