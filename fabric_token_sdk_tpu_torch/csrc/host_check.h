// Lets the kernels' row functions compile as plain C++ on a machine with
// no CUDA toolkit (g++ -x c++ -DFTS_HOST_CHECK -include host_check.h),
// so the CPU tests can run the very arithmetic the kernels run
// (tests/test_torch_csrc_host.py). Each .cu file then exposes a host
// loop over rows in place of its kernel launch.
#pragma once

#include <cstddef>
#include <cstdint>

#define __device__
#define __constant__
#define __forceinline__ inline
#define __ldg(ptr) (*(ptr))
#define FTS_NOINLINE __attribute__((noinline))
