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

// Lockstep emulation of the lanes of a row, for the cooperative kernels
// (bn254_ladder.cuh at TPI > 1, g1_msm.cu's split windows, final_exp.cu's
// lanes a row): each lane runs the row function as a coroutine
// (ucontext) on one host thread, and an exchange (what a shuffle or a
// ballot is on the card) lets every lane post a value and read all of
// them before any lane goes on. Valid because the lanes take the same
// path through the code between exchanges, as on the card.
#include <ucontext.h>

#include <vector>

namespace fts_host {

constexpr int MAX_LANES = 32;  // a warp
constexpr size_t LANE_STACK = 1 << 19;

struct Lanes {
  int tpi = 1, cur = 0, done = 0;
  bool active = false;  // inside run_group
  int arrived = 0, generation = 0;  // the barrier
  ucontext_t main, ctx[MAX_LANES];
  uint32_t slot[MAX_LANES];
  void (*body)(int lane, void* arg) = nullptr;
  void* arg = nullptr;
};

inline Lanes& lanes() {
  static thread_local Lanes state;
  return state;
}

// hand over to the next lane; back here after a full round
inline void pass() {
  Lanes& s = lanes();
  int me = s.cur;
  s.cur = (me + 1) % s.tpi;
  swapcontext(&s.ctx[me], &s.ctx[s.cur]);
}

// every lane posts v and reads all posted values into all[0..tpi)
inline void exchange(uint32_t v, uint32_t* all) {
  Lanes& s = lanes();
  s.slot[s.cur] = v;
  pass();  // every lane has posted
  for (int r = 0; r < s.tpi; ++r) all[r] = s.slot[r];
  pass();  // every lane has read
}

// this lane's index in the emulated group
inline int lane_id() { return lanes().cur; }

// a barrier of all the lanes (__syncwarp on the card): a lane waits,
// handing over, until every lane has arrived; nothing for one lane. The
// lanes of a final_exp.cu row part between barriers, with no exchange
// there (each holds whole field elements).
inline void sync() {
  Lanes& s = lanes();
  if (!s.active) return;
  const int gen = s.generation;
  if (++s.arrived == s.tpi) {
    s.arrived = 0;
    ++s.generation;
  }
  while (s.generation == gen) pass();
}

inline void lane_entry() {
  Lanes& s = lanes();
  int me = s.cur;
  s.body(me, s.arg);
  if (++s.done == s.tpi) setcontext(&s.main);
  s.cur = (me + 1) % s.tpi;
  setcontext(&s.ctx[s.cur]);
}

// body(lane, arg) for lanes 0 .. tpi - 1 in lockstep
inline void run_group(int tpi, void (*body)(int, void*), void* arg) {
  Lanes& s = lanes();
  s.tpi = tpi, s.cur = 0, s.done = 0, s.body = body, s.arg = arg, s.active = true;
  s.arrived = 0;
  std::vector<char> stacks((size_t)tpi * LANE_STACK);
  for (int r = 0; r < tpi; ++r) {
    getcontext(&s.ctx[r]);
    s.ctx[r].uc_stack.ss_sp = stacks.data() + (size_t)r * LANE_STACK;
    s.ctx[r].uc_stack.ss_size = LANE_STACK;
    s.ctx[r].uc_link = &s.main;
    makecontext(&s.ctx[r], lane_entry, 0);
  }
  swapcontext(&s.main, &s.ctx[0]);
  s.active = false;
}

}  // namespace fts_host
