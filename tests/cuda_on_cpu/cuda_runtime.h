// A stand-in for <cuda_runtime.h> that lets g++ build the kernels of
// multi_agent_solver_tpu_torch/csrc for the CPU, for tests: a block's
// threads run as std::threads, one block after another, and a warp's lanes
// meet at a barrier for every warp intrinsic.  A launch
// `kernel<<<grid, block, 0, stream>>>(args)` must first be rewritten as
// `mas_launch(grid, block, [=] { kernel(args); })` (see
// tests/test_torch_riccati_lanes.py).
#pragma once
#include <barrier>
#include <climits>
#include <cmath>
#include <cstring>
#include <functional>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline int cudaGetLastError() { return cudaSuccess; }

struct mas_idx {
  unsigned x = 0, y = 0, z = 0;
};
inline thread_local mas_idx threadIdx, blockIdx, blockDim;

// One warp: its live lanes' barrier and the slots they exchange through.
struct mas_warp {
  std::barrier<> bar;
  unsigned slot[32];
  bool alive[32];
  explicit mas_warp(int n) : bar(n) {
    for (int i = 0; i < 32; ++i) alive[i] = i < n;
  }
};
inline thread_local mas_warp* mas_cur_warp = nullptr;

inline unsigned mas_lane() { return threadIdx.x & 31u; }

inline void __syncwarp(unsigned = 0xffffffffu) { mas_cur_warp->bar.arrive_and_wait(); }

template <typename V>
inline V mas_exchange(V v, int src) {
  static_assert(sizeof(V) == 4, "32-bit values");
  mas_warp* w = mas_cur_warp;
  std::memcpy(&w->slot[mas_lane()], &v, 4);
  w->bar.arrive_and_wait();
  V r;
  std::memcpy(&r, &w->slot[src & 31], 4);
  w->bar.arrive_and_wait();
  return r;
}

template <typename V>
inline V __shfl_sync(unsigned, V v, int src, int width = 32) {
  const int base = static_cast<int>(mas_lane()) & ~(width - 1);
  return mas_exchange(v, base + (src % width));
}

template <typename V>
inline V __shfl_xor_sync(unsigned, V v, int m, int = 32) {
  return mas_exchange(v, static_cast<int>(mas_lane()) ^ m);
}

inline unsigned __ballot_sync(unsigned, int pred) {
  mas_warp* w = mas_cur_warp;
  w->slot[mas_lane()] = pred ? 1u : 0u;
  w->bar.arrive_and_wait();
  unsigned r = 0;
  for (int i = 0; i < 32; ++i)
    if (w->alive[i] && w->slot[i]) r |= 1u << i;
  w->bar.arrive_and_wait();
  return r;
}

inline int __ffs(unsigned x) { return __builtin_ffs(static_cast<int>(x)); }

// Run `fn` on grid x block threads, one block at a time; a thread that
// returns leaves its warp's barrier.
inline void mas_launch(long long grid, long long block, const std::function<void()>& fn) {
  for (long long g = 0; g < grid; ++g) {
    std::vector<std::unique_ptr<mas_warp>> warps;
    for (long long w = 0; w * 32 < block; ++w)
      warps.emplace_back(new mas_warp(static_cast<int>(std::min<long long>(32, block - w * 32))));
    std::vector<std::thread> threads;
    for (long long t = 0; t < block; ++t)
      threads.emplace_back([&, g, t] {
        threadIdx.x = static_cast<unsigned>(t);
        blockIdx.x = static_cast<unsigned>(g);
        blockDim.x = static_cast<unsigned>(block);
        mas_cur_warp = warps[t / 32].get();
        fn();
        mas_cur_warp->alive[t & 31] = false;
        mas_cur_warp->bar.arrive_and_drop();
      });
    for (auto& t : threads) t.join();
  }
}
