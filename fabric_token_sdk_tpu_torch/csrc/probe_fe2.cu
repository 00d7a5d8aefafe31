// probe_fe2: micro-benchmarks behind the GT kernels' design, run by
// `chip_probe.py --ubench` (not a kernel of any path; left out of
// _build.py's SOURCES, built by its build_probe).
//
// Each kernel runs one warp a block and reports, from lane 0, the clock
// cycles of its timed loop in cyc[block]:
// * 0: n dependent Fp2 products (bn254_ladder.cuh's field at TPI = 1)
//   at one call site in a loop: the latency of an Fp2 product;
// * 1, 2: the same products unrolled at 8 and at 64 call sites: the cost
//   of a body larger than the instruction cache;
// * 3: n dependent Fp2 additions;
// * 4: n rounds of 16 dependent shared-memory loads, lane l reading word
//   l * arg + k: arg = 16 and 64 make the 32 lanes of a warp meet in few
//   banks, arg = 17 and 65 in 32 (the padding of gtc::Row's PAD = 1).
#include "bn254_gt_coop.cuh"

using namespace bn254;
using gtc::Fe2;

namespace {

__device__ __forceinline__ Fe2 load_fe2(const uint32_t* p) {
  Fe2 v;
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    v.c0.w[k] = p[k];
    v.c1.w[k] = p[NW + k];
  }
  return v;
}

__device__ __forceinline__ void store_fe2(uint32_t* p, const Fe2& v) {
#pragma unroll
  for (int k = 0; k < NW; ++k) {
    p[k] = v.c0.w[k];
    p[NW + k] = v.c1.w[k];
  }
}

template <int U>  // call sites a loop iteration
__global__ void fe2_mul_chain(const uint32_t* in, uint32_t* out, long long* cyc, int n) {
  const gtc::Group g(0u);
  Fe2 a = load_fe2(in + 16 * (threadIdx.x % 4)), b = load_fe2(in + 64);
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n / U; ++i) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      a = coop::fe2_mul(g, a, b);
      if (U > 1) b.c0.w[u & 7] ^= 1u;  // a distinct operand a site
    }
  }
  const long long t1 = clock64();
  store_fe2(out + 16 * (blockIdx.x * 32 + threadIdx.x), a);
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

__global__ void fe2_add_chain(const uint32_t* in, uint32_t* out, long long* cyc, int n) {
  const gtc::Group g(0u);
  Fe2 a = load_fe2(in + 16 * (threadIdx.x % 4)), b = load_fe2(in + 64);
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) a = coop::fe2_add(g, a, b);
  const long long t1 = clock64();
  store_fe2(out + 16 * (blockIdx.x * 32 + threadIdx.x), a);
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

__global__ void lds_chain(uint32_t* out, long long* cyc, int n, int stride) {
  __shared__ uint32_t words[8192];
  for (int i = threadIdx.x; i < 8192; i += 32) words[i] = (uint32_t)i;
  __syncwarp();
  uint32_t acc = 0;
  const long long t0 = clock64();
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
#pragma unroll
    for (int k = 0; k < 16; ++k) acc += words[(threadIdx.x * stride + k + (acc & 1u)) & 8191u];
  }
  const long long t1 = clock64();
  out[threadIdx.x] = acc;
  if (threadIdx.x == 0) cyc[blockIdx.x] = t1 - t0;
}

}  // namespace

// runs kernel `which` on `blocks` one-warp blocks and waits for it
extern "C" int fts_probe_fe2(int which, const void* in, void* out, void* cyc, int n, int blocks,
                             int arg) {
  const uint32_t* i = (const uint32_t*)in;
  uint32_t* o = (uint32_t*)out;
  long long* c = (long long*)cyc;
  switch (which) {
    case 0: fe2_mul_chain<1><<<blocks, 32>>>(i, o, c, n); break;
    case 1: fe2_mul_chain<8><<<blocks, 32>>>(i, o, c, n); break;
    case 2: fe2_mul_chain<64><<<blocks, 32>>>(i, o, c, n); break;
    case 3: fe2_add_chain<<<blocks, 32>>>(i, o, c, n); break;
    case 4: lds_chain<<<blocks, 32>>>(o, c, n, arg); break;
    default: return -1;
  }
  return (int)cudaDeviceSynchronize();
}
