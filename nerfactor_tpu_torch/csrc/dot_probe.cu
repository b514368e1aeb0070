// Kernel P: chains of 128 x 128 bf16 products on the tensor cores, the
// probe of their dependent pass rate, on Hopper's warpgroup product.
//
// Replaces the TPU probe kernel tools/mosaic_dot_probe.py `kernel`
// (launched by its `build`), over the port's layout: the operand is
// (rows, 128) row-major, and a pass multiplies every row by W_i^T, which
// is the TPU probe's W_i @ y over its (128, cols) operand. Three
// dependency structures at the same pass count:
//   serial: y <- bf16(y W_i^T)           (each pass needs the previous one)
//   indep:  acc += y W_i^T, in f32        (no pass needs another)
//   pair:   two half-depth serial chains, y1 on W_0, W_2, ... and y2 on
//           W_1, W_3, ..., interleaved; out = y1 + y2 in f32
// with y = bf16(x), bf16 operands and f32 accumulation throughout.
//
// What bounds it: operations, 2 * 128 * 128 FLOP a row a pass (0.0347 ms a
// pass at 1,048,576 rows at 989 TFLOP/s); x is read and the output
// written once whatever the depth, so the slope of time against depth is
// the pass rate. The mma.sync design (dot_probe_mma.cu, the control) ran
// at 42 % of it. This one answers its five limits:
//   1. Shared-memory bandwidth: there every warp read every B fragment of
//      W itself, 1 byte per 32 FLOP, an SM's whole shared bandwidth at the
//      tensor rate. Here wgmma.m64n128k16 (wgmma.cuh) reads B from shared
//      memory once for a warpgroup's 64 rows, straight into the tensor
//      cores: 4 KB per 262,144 FLOP, 1 byte per 64 FLOP, in the
//      128-byte-swizzled layout that reads without bank conflicts.
//   2. mma.sync issues 16 x 8 x 16 products a warp; the warpgroup product
//      is Hopper's only way to the full tensor-core rate.
//   3. A block-wide barrier every pass: here the weights stream through a
//      ring of kRingMats shared-memory matrices (192 KB) under an mbarrier
//      pair a stage (full: the copy's bytes landed; empty: the stage's
//      last product done, one arrival a consumer warp), refilled by one
//      thread of a producer warpgroup with TMA bulk copies up to five
//      stages ahead. The pass loop has no __syncthreads, and no divergent
//      branch lies between a product and its wait (the arrival is a
//      predicated instruction, the poll loop one asm statement): ptxas
//      serializes the products around one.
//   4. Pair spilled (three 64-register fragment sets a warp). Here every
//      mode keeps 192 registers of state a thread: two "lanes", each an A
//      fragment (32 registers: 64 rows x 128 bf16 a warpgroup) and an f32
//      accumulator (64). serial: two 64-row tiles; pair: one 64-row tile's
//      two half-chains; indep: two tiles, each accumulating every pass.
//      setmaxnreg gives each consumer thread 232 registers and the
//      producer's 40 (384 threads start at 168: ptxas splits the register
//      file by warpgroups, so one producer warp alone would leave the
//      consumers 168 too, and they spill).
//   5. Each chunk of rows streams all the weights again from L2: 32 KB a
//      pass per 256 rows (serial, indep; pair's chunk is 128 rows, so 64
//      KB). Counted from these sizes, not read from the card: 128 MiB a
//      pass at 1,048,576 rows (pair 256 MiB), ~3.9 TB/s of L2 reads at
//      the bound's rate (pair ~7.7). Not multicast across a cluster:
//      pair, with twice serial's reloads, runs at serial's slope (PERF.md).
// Serial and pair run a stage's two lanes one after the other: issue,
// commit, wait for the group, pack the f32 accumulator into the next A
// fragment (the m64nNk16 accumulator layout is its A layout, wgmma.cuh).
// y never leaves the registers. The overlap of one warpgroup's epilogue
// with products in flight comes from the SM's other consumer warpgroup:
// interleaving the two lanes under wait_group 1 read the same slope
// (PERF.md, kernel P), since ptxas serialized them anyway (note C7514).
// Indep issues both tiles' products of a pass as one group and waits only
// for the previous pass's group, to free its stage.
//
// The weights reach the ring already in the swizzled K-major order the B
// descriptor reads (B[k][n] = W[n][k]: W's rows are K-major): one packing
// launch (dot_pack_kernel) lays every W_i out on the device, and the
// producer moves a stage with one 1-D cp.async.bulk (32 KB; 64 KB for
// pair). That keeps the copy a memcpy under the CPU emulation, where a
// tensor map's hardware swizzle would need a model of its own, and needs
// no driver entry point (cuTensorMapEncodeTiled) from a library that links
// only the runtime. Packing costs a read and a write of 32 KB a matrix.
//
// A block (2 consumer warpgroups and the producer warpgroup, 384 threads,
// one block an SM: 192 KB of ring) owns block_rows rows (a multiple of 256)
// and walks them in chunks of 256 (serial, indep) or 128 (pair) rows: each
// consumer warpgroup loads its 128 (64) rows of x into A fragments, runs
// the chain, writes its rows; rows past the end read 0 and are not
// written. The ring runs on across chunks, so the next chunk's first
// weights load while this one finishes.

#include <cstdint>

#include "chain_mlp.cuh"
#include "wgmma.cuh"

namespace nfk {
namespace probe {

constexpr int kWidth = 128;
constexpr int kKSteps = kWidth / 16;                  // k16 steps of a pass
constexpr int kTileRows = 64;                         // rows of one wgmma
constexpr int kConsumers = 2;                         // consumer warpgroups
constexpr int kConsumerWarps = 4 * kConsumers;        // arrivals that free a stage
constexpr int kThreads = 128 * (kConsumers + 1);      // + the producer warpgroup
constexpr int kConsumerRegs = 232;                    // setmaxnreg: 256 x 232 + 128 x 40
constexpr int kProducerRegs = 40;                     //   <= 65,536
constexpr int kChunkRows = 256;                       // block_rows is a multiple
constexpr int kMatElems = kWidth * kWidth;
constexpr uint32_t kMatBytes = kMatElems * 2;         // one W_i in bf16: 32 KB
constexpr int kRingMats = 6;                          // matrices the ring holds
constexpr int kSmemBytes = kRingMats * kMatBytes + wg::kSwizzleAtom + 2 * kRingMats * 8;
constexpr int kPackThreads = 256;

enum Mode { kSerial = 0, kIndep = 1, kPair = 2 };

template <int MODE>
struct Plan {
  static constexpr int kMats = MODE == kPair ? 2 : 1;  // matrices a stage holds
  static constexpr int kStages = kRingMats / kMats;
  // rows a consumer warpgroup holds: two tiles, or one tile's two chains
  static constexpr int kGroupRows = MODE == kPair ? kTileRows : 2 * kTileRows;
  static constexpr int kChunk = kConsumers * kGroupRows;
};

using Frag = uint32_t[kKSteps][4];  // a 64 x 128 bf16 operand, a thread's share
using Acc = float[wg::kAccRegs];    // a 64 x 128 f32 accumulator, a thread's share

// W (depth, 128, 128) row-major -> each W_i as B's 128-byte-swizzled
// K-major tile (wg::sw128_offset over 128 rows): one block a matrix, one
// 16-byte piece (8 K neighbours of a row) a step.
__global__ void __launch_bounds__(kPackThreads)
dot_pack_kernel(const __nv_bfloat16* __restrict__ w, __nv_bfloat16* __restrict__ packed) {
  const long long m0 = static_cast<long long>(blockIdx.x) * kMatElems;
  for (int p = threadIdx.x; p < kMatElems / 8; p += kPackThreads) {
    const int n = p / (kWidth / 8), k = 8 * (p % (kWidth / 8));
    const __nv_bfloat16* src = w + m0 + n * kWidth + k;
    __nv_bfloat16* dst = packed + m0 + wg::sw128_offset(n, k, kWidth) / 2;
#pragma unroll
    for (int e = 0; e < 8; e += 2)
      wg::st_u32(dst + e, wg::ld_bf16x2(src + e));
  }
}

// The A fragments of rows [r0, r0 + 64) of x as bf16 (this thread's two
// rows of its warp's 16); rows at or past r_end read 0
__device__ __forceinline__ void load_tile(Frag& a, const float* __restrict__ x, long long r0,
                                          long long r_end) {
  const int tid = threadIdx.x & 127, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = r0 + 16 * (tid >> 5) + g + 8 * (e & 1);
      float v0 = 0.f, v1 = 0.f;
      if (r < r_end) wg::ld_f32x2(x + r * kWidth + 16 * kk + 8 * (e >> 1) + 2 * t, v0, v1);
      a[kk][e] = wg::pack_bf16x2(v0, v1);
    }
}

// Rows [r0, r0 + 64) of the output from A fragments (bf16): the sum of
// a and b's values when b is given (pair)
__device__ __forceinline__ void store_frag(float* __restrict__ out, long long r0, long long r_end,
                                           const Frag& a, const Frag* b) {
  const int tid = threadIdx.x & 127, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const long long r = r0 + 16 * (tid >> 5) + g + 8 * (e & 1);
      if (r >= r_end) continue;
      float v0 = wg::bf16x2_lo(a[kk][e]), v1 = wg::bf16x2_hi(a[kk][e]);
      if (b) {
        v0 += wg::bf16x2_lo((*b)[kk][e]);
        v1 += wg::bf16x2_hi((*b)[kk][e]);
      }
      wg::st_f32x2(out + r * kWidth + 16 * kk + 8 * (e >> 1) + 2 * t, v0, v1);
    }
}

// Rows [r0, r0 + 64) of the output from an accumulator (indep)
__device__ __forceinline__ void store_acc(float* __restrict__ out, long long r0, long long r_end,
                                          const Acc& d) {
  const int tid = threadIdx.x & 127, lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kWidth / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = r0 + 16 * (tid >> 5) + g + 8 * h;
      if (r < r_end)
        wg::st_f32x2(out + r * kWidth + 8 * j + 2 * t, d[4 * j + 2 * h], d[4 * j + 2 * h + 1]);
    }
}

// d (+)= a W^T for the 64 rows of a: eight k16 steps, W the swizzled tile
// at shared address w; accumulate 0 overwrites d
__device__ __forceinline__ void issue_pass(Acc& d, const Frag& a, uint32_t w, int accumulate) {
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
    wg::mma_rs(d, a[kk], wg::kmajor_sw128_desc(w, kWidth, kk), kk > 0 || accumulate);
}

// A ring position: the stage, and the parity of the phase a wait expects
struct Ring {
  int slot = 0;
  uint32_t phase = 0;
  template <int STAGES>
  __device__ __forceinline__ void advance() {
    if (++slot == STAGES) {
      slot = 0;
      phase ^= 1;
    }
  }
};

// One pass of a serial chain's lane: d = a W^T (W the swizzled tile at
// shared address w), complete, then a <- bf16(d), the next pass's A
__device__ __forceinline__ void chain_pass(Frag& a, Acc& d, uint32_t w) {
  wg::fence();
  issue_pass(d, a, w, 0);
  wg::commit();
  wg::wait<0>();
  wg::fence_operands(d);
  wg::pack_acc(a, d);
}

// A consumer warpgroup of serial or pair: lanes 0 and 1, one after the
// other on each stage (serial: rows r0 and r0 + 64; pair: rows r0 on the
// even and on the odd matrices)
template <int MODE>
__device__ __forceinline__ void consume_chain(const float* __restrict__ x, float* __restrict__ out,
                                              long long r_begin, long long r_end, int stages,
                                              uint32_t ring, uint64_t* full, uint64_t* empty) {
  using P = Plan<MODE>;
  constexpr uint32_t kLane1 = MODE == kPair ? kMatBytes : 0;  // lane 1's matrix in a stage
  const bool signals = (threadIdx.x & 31) == 0;
  const int group = threadIdx.x >> 7;
  Ring pos;
  Frag a0, a1;
  Acc d0, d1;
  for (long long c0 = r_begin; c0 < r_end; c0 += P::kChunk) {
    const long long r0 = c0 + group * P::kGroupRows;
    load_tile(a0, x, r0, r_end);
    if constexpr (MODE == kPair) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) a1[kk][e] = a0[kk][e];
    } else {
      load_tile(a1, x, r0 + kTileRows, r_end);
    }
    for (int s = 0; s < stages; ++s) {
      wg::mbar_wait(&full[pos.slot], pos.phase);
      const uint32_t w = ring + pos.slot * P::kMats * kMatBytes;
      chain_pass(a0, d0, w);
      chain_pass(a1, d1, w + kLane1);
      wg::mbar_arrive_if(&empty[pos.slot], signals);
      pos.advance<P::kStages>();
    }
    if constexpr (MODE == kPair) {
      store_frag(out, r0, r_end, a0, &a1);
    } else {
      store_frag(out, r0, r_end, a0, nullptr);
      store_frag(out, r0 + kTileRows, r_end, a1, nullptr);
    }
  }
}

// A consumer warpgroup of indep: two 64-row tiles, each summing every pass
__device__ __forceinline__ void consume_indep(const float* __restrict__ x, float* __restrict__ out,
                                              long long r_begin, long long r_end, int stages,
                                              uint32_t ring, uint64_t* full, uint64_t* empty) {
  using P = Plan<kIndep>;
  const bool signals = (threadIdx.x & 31) == 0;
  const int group = threadIdx.x >> 7;
  Ring pos;
  Frag a0, a1;
  Acc d0, d1;
  for (long long c0 = r_begin; c0 < r_end; c0 += P::kChunk) {
    const long long r0 = c0 + group * P::kGroupRows;
    load_tile(a0, x, r0, r_end);
    load_tile(a1, x, r0 + kTileRows, r_end);
    wg::fence();
    int prev = 0;
    for (int s = 0; s < stages; ++s) {
      wg::mbar_wait(&full[pos.slot], pos.phase);
      const uint32_t w = ring + pos.slot * kMatBytes;
      issue_pass(d0, a0, w, s > 0);
      issue_pass(d1, a1, w, s > 0);
      wg::commit();
      if (s > 0) {  // pass s - 1 is done with its stage
        wg::wait<1>();
        wg::mbar_arrive_if(&empty[prev], signals);
      }
      prev = pos.slot;
      pos.advance<P::kStages>();
    }
    wg::wait<0>();
    wg::fence_operands(d0);
    wg::fence_operands(d1);
    wg::mbar_arrive_if(&empty[prev], signals);
    store_acc(out, r0, r_end, d0);
    store_acc(out, r0 + kTileRows, r_end, d1);
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads, 1)
dot_chain_wg_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ packed,
                    int depth, long long block_rows, long long n_rows, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  using P = Plan<MODE>;
  // the ring on the swizzle's 1,024-byte boundary of the shared window
  const uint32_t base = wg::smem_u32(smem);
  const uint32_t ring = (base + wg::kSwizzleAtom - 1) & ~static_cast<uint32_t>(wg::kSwizzleAtom - 1);
  unsigned char* ring_ptr = smem + (ring - base);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring_ptr + kRingMats * kMatBytes);
  uint64_t* empty = full + P::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      wg::mbar_init(&full[s], 1);
      wg::mbar_init(&empty[s], kConsumerWarps);
    }
    wg::mbar_fence_init();
  }
  __syncthreads();
  const long long r_begin = static_cast<long long>(blockIdx.x) * block_rows;
  const long long r_end = min(r_begin + block_rows, n_rows);
  const int stages = depth / P::kMats;
  // One if-else to the end: the two roles never meet again (setmaxnreg)
  if (threadIdx.x >= 128 * kConsumers) {  // the producer warpgroup: one thread issues
    wg::setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 128 * kConsumers) {
      Ring pos;
      for (long long c0 = r_begin; c0 < r_end; c0 += P::kChunk)
        for (int s = 0; s < stages; ++s) {
          wg::mbar_wait(&empty[pos.slot], pos.phase ^ 1);
          wg::mbar_arrive_expect_tx(&full[pos.slot], P::kMats * kMatBytes);
          wg::bulk_load(ring_ptr + pos.slot * P::kMats * kMatBytes,
                        packed + static_cast<long long>(s) * P::kMats * kMatElems,
                        P::kMats * kMatBytes, &full[pos.slot]);
          pos.advance<P::kStages>();
        }
    }
  } else {
    wg::setmaxnreg_inc<kConsumerRegs>();
    if constexpr (MODE == kIndep)
      consume_indep(x, out, r_begin, r_end, stages, ring, full, empty);
    else
      consume_chain<MODE>(x, out, r_begin, r_end, stages, ring, full, empty);
  }
}

template <int MODE>
int launch(const float* x, const __nv_bfloat16* packed, int depth, long long block_rows,
           long long n_rows, float* out, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(dot_chain_wg_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + block_rows - 1) / block_rows;
  dot_chain_wg_kernel<MODE><<<static_cast<unsigned>(blocks), kThreads, kSmemBytes, stream>>>(
      x, packed, depth, block_rows, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}

// The building blocks alone: d (64 x 128 f32) = a (64 x 128) w^T (w 128 x
// 128), both bf16 row-major, over eight k16 steps of wgmma.m64n128k16,
// B (and A, ss) laid out 128-byte-swizzled in shared memory and read
// through descriptors of the given layout type and stride byte offset
// (the card's are wg::kSwizzle128 and 1,024; others are the tests'
// controls). One warpgroup.
constexpr int kTileSmem = (kTileRows + kWidth) * kWidth * 2 + wg::kSwizzleAtom;

__global__ void __launch_bounds__(128, 1)
wgmma_tile_kernel(const __nv_bfloat16* __restrict__ a, const __nv_bfloat16* __restrict__ w,
                  int ss, int layout, int sbo, float* __restrict__ d) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = wg::smem_u32(smem);
  const uint32_t a_s = (base + wg::kSwizzleAtom - 1) & ~static_cast<uint32_t>(wg::kSwizzleAtom - 1);
  const uint32_t w_s = a_s + kTileRows * kWidth * 2;
  unsigned char* a_ptr = smem + (a_s - base);
  unsigned char* w_ptr = smem + (w_s - base);
  for (int i = threadIdx.x; i < kTileRows * kWidth / 2; i += 128) {
    const int r = i / (kWidth / 2), k = 2 * (i % (kWidth / 2));
    wg::st_u32(a_ptr + wg::sw128_offset(r, k, kTileRows), wg::ld_bf16x2(a + r * kWidth + k));
  }
  for (int i = threadIdx.x; i < kWidth * kWidth / 2; i += 128) {
    const int r = i / (kWidth / 2), k = 2 * (i % (kWidth / 2));
    wg::st_u32(w_ptr + wg::sw128_offset(r, k, kWidth), wg::ld_bf16x2(w + r * kWidth + k));
  }
  wg::fence_proxy_async();
  __syncthreads();
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3, r = 16 * (threadIdx.x >> 5) + g;
  Frag af;
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      af[kk][e] = wg::ld_bf16x2(a + (r + 8 * (e & 1)) * kWidth + 16 * kk + 8 * (e >> 1) + 2 * t);
  Acc acc;
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < kKSteps; ++kk) {
    const uint32_t step = (kk & 3) * 32;
    const uint64_t desc_b =
        wg::make_desc(w_s + (kk >> 2) * kWidth * 128 + step, 16, sbo, layout);
    if (ss)
      wg::mma_ss(acc, wg::make_desc(a_s + (kk >> 2) * kTileRows * 128 + step, 16, sbo, layout),
                 desc_b, kk > 0);
    else
      wg::mma_rs(acc, af[kk], desc_b, kk > 0);
  }
  wg::commit();
  wg::wait<0>();
  wg::fence_operands(acc);
  store_acc(d, 0, kTileRows, acc);
}

}  // namespace probe
}  // namespace nfk

extern "C" {

// Kernel P. x (n_rows, 128) f32, w (depth, 128, 128) bf16 row-major, out
// (n_rows, 128) f32; packed: depth * 128 * 128 bf16 of scratch (16-byte
// aligned) for the swizzled weights. Mode 0 serial, 1 indep, 2 pair (even
// depth). A block owns block_rows rows, a positive multiple of 256. Two
// launches: the packing, then the chain.
int nfk_dot_chain(int mode, const float* x, const void* w, int depth, long long block_rows,
                  long long n_rows, void* packed, float* out, void* stream) {
  namespace pr = nfk::probe;
  if (depth < 1 || block_rows < 1 || block_rows % pr::kChunkRows || mode < 0 || mode > 2 ||
      (mode == pr::kPair && depth % 2))
    return nfk::kErrBadArgs;
  if (n_rows <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* wp = static_cast<__nv_bfloat16*>(packed);
  pr::dot_pack_kernel<<<depth, pr::kPackThreads, 0, s>>>(static_cast<const __nv_bfloat16*>(w),
                                                         wp);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (mode == pr::kSerial) return pr::launch<pr::kSerial>(x, wp, depth, block_rows, n_rows, out, s);
  if (mode == pr::kIndep) return pr::launch<pr::kIndep>(x, wp, depth, block_rows, n_rows, out, s);
  return pr::launch<pr::kPair>(x, wp, depth, block_rows, n_rows, out, s);
}

// Kernel P's plan for a mode: the matrices its weight ring holds, the
// matrices a stage holds, and the rows a block's consumers hold at once
// (ops/dot_probe.py keeps the same numbers; the tests hold the two
// together).
int nfk_dot_chain_plan(int mode, int* ring_mats, int* stage_mats, int* chunk_rows) {
  namespace pr = nfk::probe;
  if (mode < 0 || mode > 2) return nfk::kErrBadArgs;
  *ring_mats = pr::kRingMats;
  *stage_mats = mode == pr::kPair ? pr::Plan<pr::kPair>::kMats : pr::Plan<pr::kSerial>::kMats;
  *chunk_rows = mode == pr::kPair ? pr::Plan<pr::kPair>::kChunk
                : mode == pr::kIndep ? pr::Plan<pr::kIndep>::kChunk
                                     : pr::Plan<pr::kSerial>::kChunk;
  return 0;
}

// The wgmma building blocks alone (wgmma_tile_kernel): d = a w^T for a
// (64, 128) and w (128, 128) bf16, d (64, 128) f32; ss 1 reads A from
// shared memory, 0 from registers; layout and sbo go into the
// descriptors.
int nfk_wgmma_tile(const void* a, const void* w, int ss, int layout, int sbo, float* d,
                   void* stream) {
  namespace pr = nfk::probe;
  if (layout < 0 || layout > 3 || sbo < 0 || sbo >= (1 << 18)) return nfk::kErrBadArgs;
  cudaError_t err = cudaFuncSetAttribute(pr::wgmma_tile_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         pr::kTileSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  pr::wgmma_tile_kernel<<<1, 128, pr::kTileSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(w), ss, layout,
      sbo, d);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
