#pragma once
// CPU emulation of the CUDA subset that the kernels in csrc/ use, for
// tests/test_torch_emu.py: a launch runs its blocks one after another,
// each as blockDim std::threads sharing one shared-memory buffer, with a
// std::barrier for __syncthreads(). Launches are rewritten to mock_launch
// by the test's source translation. The "device" has 3 SMs, one block per
// SM, and 227 KB of opt-in shared memory, as an H100 block has.
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <functional>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__
#define __align__(x) alignas(16)
#define __restrict__

struct dim3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3_ threadIdx;
inline dim3_ blockIdx, blockDim, gridDim;
inline std::barrier<>* g_bar = nullptr;
inline void __syncthreads() { g_bar->arrive_and_wait(); }
alignas(16) inline unsigned char smem[240 * 1024];

typedef int cudaError_t;
typedef void* cudaStream_t;
enum {
  cudaSuccess = 0,
  cudaFuncAttributeMaxDynamicSharedMemorySize = 1,
  cudaDevAttrMaxSharedMemoryPerBlockOptin = 2,
  cudaDevAttrMultiProcessorCount = 3
};
template <typename F>
cudaError_t cudaFuncSetAttribute(F, int, int) { return 0; }
template <typename F>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, F, int, size_t) {
  *n = 1;
  return 0;
}
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return 0; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int attr, int) {
  *v = attr == cudaDevAttrMaxSharedMemoryPerBlockOptin ? 232448 : 3;
  return 0;
}
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t) { return "emulated"; }
using std::max;
using std::min;
inline void sincosf(float x, float* s, float* c) { *s = sinf(x); *c = cosf(x); }

inline void mock_launch(long long grid, int block, std::function<void()> fn) {
  gridDim.x = grid;
  blockDim.x = block;
  for (long long b = 0; b < grid; ++b) {
    blockIdx.x = b;
    std::memset(smem, 0xff, sizeof(smem));  // stale contents, as on the card
    std::barrier<> bar(block);
    g_bar = &bar;
    std::vector<std::thread> threads;
    for (int t = 0; t < block; ++t)
      threads.emplace_back([&, t]() { threadIdx.x = t; fn(); });
    for (auto& t : threads) t.join();
  }
}
