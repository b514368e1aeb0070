// Kernel P's mma.sync design, kept as the control of the wgmma
// kernel in dot_probe.cu: the same three chains, reached only by the card
// tests and chip_smoke.py (ops/dot_probe.py's private wrapper), so that
// one call reads both designs' pass rates on one card, and the ceiling of
// the mma.sync chain kernels (K1-K3) beside the wgmma one.
//
// Chains of 128 x 128 bf16 products over the port's layout: the operand is
// (rows, 128) row-major, and a pass multiplies every row by W_i^T. Three
// dependency structures at the same pass count:
//   serial: y <- bf16(y W_i^T)           (each pass needs the previous one)
//   indep:  acc += y W_i^T, in f32        (no pass needs another)
//   pair:   two half-depth serial chains, y1 on W_0, W_2, ... and y2 on
//           W_1, W_3, ..., interleaved; out = y1 + y2 in f32
// with y = bf16(x), bf16 operands and f32 accumulation throughout.
//
// Every product runs on the tensor cores through
// mma.sync.aligned.m16n8k16 (bf16 in, f32 accumulate). What bounds it:
// operations, 2 * 128 * 128 FLOP a row a pass (0.035 ms a pass at
// 1,048,576 rows at 989 TFLOP/s). Design: a warp keeps two 16-row groups
// of its rows in registers as A fragments, for the whole chain; a pass
// turns the accumulators of two neighbouring 8-column tiles straight into
// the next pass's A fragment (the m16n8 accumulator layout is the m16k16
// operand layout), so y never leaves the registers. Each pass's W sits in
// shared memory (rows padded to 136 bf16, so a warp's B-fragment reads hit
// 32 banks), double-buffered with cp.async so the next stage's weights
// load while this one multiplies; the two row groups share every B
// fragment. A block walks its `block_rows` rows in chunks of 256 (8 warps
// x 32 rows) and reloads the weights for each chunk: 32 KB a pass per 256
// rows from L2.

#include <cstdint>

#include "chain_mlp.cuh"

namespace nfk {
namespace probe_mma {

constexpr int kWidth = 128;
constexpr int kWarps = 8;
constexpr int kProbeThreads = 32 * kWarps;
constexpr int kGroups = 2;                           // 16-row groups a warp holds
constexpr int kChunk = kWarps * kGroups * 16;        // rows a block iteration covers
constexpr int kLdW = kWidth + 8;                     // padded shared row of a weight
constexpr int kKTiles = kWidth / 16;                 // m16n8k16 steps along K
constexpr int kNTiles = kWidth / 8;                  // 8-column output tiles
constexpr int kMatElems = kWidth * kLdW;

enum Mode { kSerial = 0, kIndep = 1, kPair = 2 };

using Frag = uint32_t[kGroups][kKTiles][4];

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// d += a b on the tensor cores: a the 16 x 16 row-major A fragment, (b0,
// b1) the 16 x 8 column-major B fragment, d the 16 x 8 f32 accumulator.
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Starts copying `mats` consecutive 128 x 128 weights to `dst` (padded
// rows), 16 bytes a request.
__device__ __forceinline__ void load_weights(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                             int mats) {
  constexpr int kPerRow = kWidth / 8;  // 16-byte pieces of a row
  for (int idx = threadIdx.x; idx < mats * kWidth * kPerRow; idx += kProbeThreads) {
    const int m = idx / (kWidth * kPerRow), r = (idx / kPerRow) % kWidth, p = idx % kPerRow;
    cp_async16(dst + m * kMatElems + r * kLdW + 8 * p,
               src + (static_cast<long long>(m) * kWidth + r) * kWidth + 8 * p);
  }
  cp_async_commit();
}

// The B fragment of output tile n0 (8 columns) for K step k0: B[k][n] =
// W[n][k], two consecutive k per register.
__device__ __forceinline__ void b_frag(const __nv_bfloat16* w, int n0, int k0, uint32_t& b0,
                                       uint32_t& b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const __nv_bfloat16* p = w + (n0 + g) * kLdW + k0 + 2 * t;
  b0 = *reinterpret_cast<const uint32_t*>(p);
  b1 = *reinterpret_cast<const uint32_t*>(p + 8);
}

// One dependent pass: a <- bf16(a W^T), both row groups.
__device__ __forceinline__ void serial_pass(Frag& a, const __nv_bfloat16* w) {
  uint32_t next[kGroups][kKTiles][4];
#pragma unroll
  for (int kt_out = 0; kt_out < kKTiles; ++kt_out) {
    float c[kGroups][2][4];
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[gi][h][e] = 0.f;
#pragma unroll
    for (int kt = 0; kt < kKTiles; ++kt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t b0, b1;
        b_frag(w, 16 * kt_out + 8 * h, 16 * kt, b0, b1);
#pragma unroll
        for (int gi = 0; gi < kGroups; ++gi) mma16816(c[gi][h], a[gi][kt], b0, b1);
      }
    }
    // Output columns 16 kt_out .. + 15 are the next pass's K tile kt_out
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi) {
      next[gi][kt_out][0] = pack_bf16(c[gi][0][0], c[gi][0][1]);
      next[gi][kt_out][1] = pack_bf16(c[gi][0][2], c[gi][0][3]);
      next[gi][kt_out][2] = pack_bf16(c[gi][1][0], c[gi][1][1]);
      next[gi][kt_out][3] = pack_bf16(c[gi][1][2], c[gi][1][3]);
    }
  }
#pragma unroll
  for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
    for (int kt = 0; kt < kKTiles; ++kt)
#pragma unroll
      for (int e = 0; e < 4; ++e) a[gi][kt][e] = next[gi][kt][e];
}

// One independent pass: acc += a W^T, both row groups.
__device__ __forceinline__ void indep_pass(float (&acc)[kGroups][kNTiles][4], const Frag& a,
                                           const __nv_bfloat16* w) {
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
    for (int kt = 0; kt < kKTiles; ++kt) {
      uint32_t b0, b1;
      b_frag(w, 8 * nt, 16 * kt, b0, b1);
#pragma unroll
      for (int gi = 0; gi < kGroups; ++gi) mma16816(acc[gi][nt], a[gi][kt], b0, b1);
    }
}

template <int MODE>
__global__ void __launch_bounds__(kProbeThreads, 1)
dot_chain_mma_kernel(const float* __restrict__ x, const __nv_bfloat16* __restrict__ w, int depth,
                 long long block_rows, long long n_rows, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kMats = MODE == kPair ? 2 : 1;  // weights a stage consumes
  __nv_bfloat16* wbuf = reinterpret_cast<__nv_bfloat16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long r_begin = static_cast<long long>(blockIdx.x) * block_rows;
  const long long r_end = min(r_begin + block_rows, n_rows);
  const int stages = depth / kMats;
  for (long long c0 = r_begin; c0 < r_end; c0 += kChunk) {
    load_weights(wbuf, w, kMats);
    // Row r of group gi, K tile kt: registers (row g, cols 2t..), (row g + 8,
    // cols 2t..), (row g, cols 8 + 2t..), (row g + 8, cols 8 + 2t..)
    const long long base = c0 + warp * kGroups * 16;
    Frag a, a2;
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int kt = 0; kt < kKTiles; ++kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long r = base + 16 * gi + g + 8 * (e & 1);
          const int col = 16 * kt + 8 * (e >> 1) + 2 * t;
          float2 v = make_float2(0.f, 0.f);
          if (r < r_end) v = *reinterpret_cast<const float2*>(x + r * kWidth + col);
          a[gi][kt][e] = pack_bf16(v.x, v.y);
          a2[gi][kt][e] = a[gi][kt][e];
        }
    float acc[kGroups][kNTiles][4];
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[gi][nt][e] = 0.f;
    for (int s = 0; s < stages; ++s) {
      // Stage s has landed, and every warp is done with stage s - 1, whose
      // buffer the next stage's weights now fill
      cp_async_wait_all();
      __syncthreads();
      if (s + 1 < stages)
        load_weights(wbuf + ((s + 1) & 1) * kMats * kMatElems,
                     w + static_cast<long long>(s + 1) * kMats * kWidth * kWidth, kMats);
      const __nv_bfloat16* ws = wbuf + (s & 1) * kMats * kMatElems;
      if (MODE == kSerial) {
        serial_pass(a, ws);
      } else if (MODE == kIndep) {
        indep_pass(acc, a, ws);
      } else {
        serial_pass(a, ws);
        serial_pass(a2, ws + kMatElems);
      }
    }
    __syncthreads();  // the next chunk's first weights reuse buffer 0
#pragma unroll
    for (int gi = 0; gi < kGroups; ++gi)
#pragma unroll
      for (int kt = 0; kt < kKTiles; ++kt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const long long r = base + 16 * gi + g + 8 * (e & 1);
          if (r >= r_end) continue;
          float2 v;
          if (MODE == kIndep) {
            // Accumulator tile 2 kt + (e >> 1), rows g / g + 8
            const float* c = acc[gi][2 * kt + (e >> 1)];
            v = make_float2(c[2 * (e & 1)], c[2 * (e & 1) + 1]);
          } else {
            v = unpack_bf16(a[gi][kt][e]);
            if (MODE == kPair) {
              const float2 v2 = unpack_bf16(a2[gi][kt][e]);
              v = make_float2(v.x + v2.x, v.y + v2.y);
            }
          }
          *reinterpret_cast<float2*>(out + r * kWidth + 16 * kt + 8 * (e >> 1) + 2 * t) = v;
        }
  }
}

template <int MODE>
int launch(const float* x, const __nv_bfloat16* w, int depth, long long block_rows,
           long long n_rows, float* out, cudaStream_t stream) {
  constexpr int kMats = MODE == kPair ? 2 : 1;
  const size_t smem = 2 * kMats * sizeof(__nv_bfloat16) * kMatElems;
  cudaError_t err = cudaFuncSetAttribute(dot_chain_mma_kernel<MODE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n_rows + block_rows - 1) / block_rows;
  dot_chain_mma_kernel<MODE><<<static_cast<unsigned>(blocks), kProbeThreads, smem, stream>>>(
      x, w, depth, block_rows, n_rows, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace probe_mma
}  // namespace nfk

extern "C" {

// Kernel P's mma.sync control. x (n_rows, 128) f32, w (depth, 128, 128)
// bf16 row-major, out (n_rows, 128) f32; mode 0 serial, 1 indep, 2 pair
// (even depth). A block owns block_rows rows, a positive multiple of 256.
int nfk_dot_chain_mma(int mode, const float* x, const void* w, int depth, long long block_rows,
                  long long n_rows, float* out, void* stream) {
  namespace pr = nfk::probe_mma;
  if (depth < 1 || block_rows < 1 || block_rows % pr::kChunk || mode < 0 || mode > 2 ||
      (mode == pr::kPair && depth % 2))
    return nfk::kErrBadArgs;
  if (n_rows <= 0) return 0;
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == pr::kSerial) return pr::launch<pr::kSerial>(x, wb, depth, block_rows, n_rows, out, s);
  if (mode == pr::kIndep) return pr::launch<pr::kIndep>(x, wb, depth, block_rows, n_rows, out, s);
  return pr::launch<pr::kPair>(x, wb, depth, block_rows, n_rows, out, s);
}

}  // extern "C"
