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
#define __maxnreg__(...)
#define __shared__ static
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1, cudaErrorNotSupported = 801 };
inline int cudaGetLastError() { return cudaSuccess; }

struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;

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

// The calling thread's index in its block, x fastest.
inline thread_local unsigned mas_tid = 0;
inline unsigned mas_lane() { return mas_tid & 31u; }

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

// Run `fn` on the grid's blocks, one block at a time, each on its block's
// threads (x fastest; warps of 32 consecutive threads in that order); a
// thread that returns leaves its warp's barrier.
inline void mas_launch(dim3 grid, dim3 block, const std::function<void()>& fn) {
  const long long n = static_cast<long long>(block.x) * block.y * block.z;
  for (unsigned gz = 0; gz < grid.z; ++gz)
    for (unsigned gy = 0; gy < grid.y; ++gy)
      for (unsigned gx = 0; gx < grid.x; ++gx) {
        std::vector<std::unique_ptr<mas_warp>> warps;
        for (long long w = 0; w * 32 < n; ++w)
          warps.emplace_back(new mas_warp(static_cast<int>(std::min<long long>(32, n - w * 32))));
        std::vector<std::thread> threads;
        for (long long t = 0; t < n; ++t)
          threads.emplace_back([&, gx, gy, gz, t] {
            threadIdx = dim3(static_cast<unsigned>(t % block.x),
                             static_cast<unsigned>(t / block.x % block.y),
                             static_cast<unsigned>(t / (static_cast<long long>(block.x) * block.y)));
            mas_tid = static_cast<unsigned>(t);
            blockIdx = dim3(gx, gy, gz);
            blockDim = block;
            gridDim = grid;
            mas_cur_warp = warps[t / 32].get();
            fn();
            mas_cur_warp->alive[t & 31] = false;
            mas_cur_warp->bar.arrive_and_drop();
          });
        for (auto& t : threads) t.join();
      }
}
