#pragma once
// CPU emulation of the CUDA subset that the kernels in csrc/ use, for
// tests/test_torch_emu.py: a launch runs its blocks one after another,
// each on the launch's blockDim std::threads (started once a launch),
// sharing one shared-memory buffer, with a std::barrier for
// __syncthreads(). Launches are rewritten to mock_launch
// by the test's source translation. The "device" has 3 SMs, one block per
// SM, and 227 KB of opt-in shared memory, as an H100 block has. Each warp
// of 32 threads has a std::barrier for __syncwarp() (the emulated mma.sync
// and shuffles exchange values across the warp, mma_bf16.cuh), and each
// warpgroup of 128 a std::barrier for nfk_emu_wg_sync() (the emulated
// wgmma pools the group's A fragments, wgmma.cuh). A block that
// writes shared memory past its launch's dynamic size fails the launch
// (cudaGetLastError), as an out-of-range shared access faults on the card.
#define NFK_EMU 1
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
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
#define __shared__
#define __align__(x) alignas(16)
#define __restrict__

struct dim3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3_ threadIdx;
inline dim3_ blockIdx, blockDim, gridDim;
inline std::barrier<>* g_bar = nullptr;
inline std::barrier<>* g_warp_bar[32];
inline void __syncthreads() { g_bar->arrive_and_wait(); }
inline void __syncwarp(unsigned = 0xffffffffu) { g_warp_bar[threadIdx.x >> 5]->arrive_and_wait(); }
inline std::barrier<>* g_wg_bar[8];
inline void nfk_emu_wg_sync() { g_wg_bar[threadIdx.x >> 7]->arrive_and_wait(); }
alignas(16) inline unsigned char smem[240 * 1024];
// __shfl_xor_sync of 32-bit values: each lane posts its value to its
// warp's row and reads its partner's between two __syncwarp()s
inline unsigned g_shfl[32][32];
template <typename T>
T __shfl_xor_sync(unsigned, T v, int lane_mask) {
  static_assert(sizeof(T) == 4, "32-bit shuffles only");
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  std::memcpy(&g_shfl[w][l], &v, 4);
  __syncwarp();
  T out;
  std::memcpy(&out, &g_shfl[w][l ^ lane_mask], 4);
  __syncwarp();
  return out;
}

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
constexpr cudaError_t kEmuSmemOverrun = 700;  // the card's cudaErrorIllegalAddress
inline cudaError_t g_last_error = 0;
inline cudaError_t cudaGetLastError() {
  const cudaError_t e = g_last_error;
  g_last_error = 0;
  return e;
}
inline const char* cudaGetErrorString(cudaError_t e) {
  return e == kEmuSmemOverrun ? "shared memory written past the launch's size (emulated)"
                              : "emulated";
}
// Blocks run one after another here, so a fence has nothing to order
// across blocks; the counter's add is atomic all the same (the threads of a
// block run at once)
inline void __threadfence() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline unsigned atomicAdd(unsigned* p, unsigned v) {
  return __atomic_fetch_add(p, v, __ATOMIC_SEQ_CST);
}
template <typename T>
T __ldcg(const T* p) { return *p; }
using std::max;
using std::min;
inline void sincosf(float x, float* s, float* c) { *s = sinf(x); *c = cosf(x); }

constexpr unsigned char kCanary = 0xa5;  // shared memory past the launch's size

inline void mock_launch(long long grid, int block, size_t smem_bytes, std::function<void()> fn) {
  gridDim.x = grid;
  blockDim.x = block;
  if (smem_bytes > sizeof(smem)) {
    g_last_error = kEmuSmemOverrun;
    return;
  }
  if (grid <= 0) return;
  std::barrier<> bar(block);
  g_bar = &bar;
  std::vector<std::unique_ptr<std::barrier<>>> warp_bars;
  for (int w = 0; 32 * w < block; ++w) {
    warp_bars.emplace_back(new std::barrier<>(std::min(32, block - 32 * w)));
    g_warp_bar[w] = warp_bars.back().get();
  }
  std::vector<std::unique_ptr<std::barrier<>>> wg_bars;
  for (int w = 0; 128 * w < block; ++w) {
    wg_bars.emplace_back(new std::barrier<>(std::min(128, block - 128 * w)));
    g_wg_bar[w] = wg_bars.back().get();
  }
  // One set of blockDim threads runs the blocks in turn: each block's
  // threads start together once the host has laid out its shared memory
  // and end together before the host checks it (a thread started for
  // every block made a launch of a thousand blocks take seconds)
  std::barrier<> gate(block + 1);
  bool stop = false;
  std::vector<std::thread> threads;
  for (int t = 0; t < block; ++t)
    threads.emplace_back([&, t]() {
      threadIdx.x = t;
      for (;;) {
        gate.arrive_and_wait();  // a block starts, or the launch ends
        if (stop) return;
        fn();
        gate.arrive_and_wait();  // the block has ended
      }
    });
  for (long long b = 0; b < grid && !stop; ++b) {
    blockIdx.x = b;
    std::memset(smem, 0xff, smem_bytes);  // stale contents, as on the card
    std::memset(smem + smem_bytes, kCanary, sizeof(smem) - smem_bytes);
    gate.arrive_and_wait();
    gate.arrive_and_wait();
    for (size_t i = smem_bytes; i < sizeof(smem); ++i)
      if (smem[i] != kCanary) {
        g_last_error = kEmuSmemOverrun;
        stop = true;
        break;
      }
  }
  stop = true;
  gate.arrive_and_wait();
  for (auto& t : threads) t.join();
}
