// Tensor-core building blocks: bf16 products with f32 accumulation on
// mma.sync.aligned.m16n8k16, fed from shared memory with plain 32-bit
// loads, and cp.async copies for a ring of operand tiles.
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), lane = 4 g + t:
//   A (16 x 16, row-major): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                           a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col"):      b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8, f32):     d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g+8][2t, 2t+1]
// The lower-addressed bf16 of a pair is the low half of its register. B is
// read from its transpose Bt (n x k, row-major), so both operands load
// pairs of neighbouring k with one 32-bit load.
//
// Under the CPU emulation (csrc/emu, NFK_EMU) each instruction has a
// scalar counterpart with the same lane mapping: the emulated mma writes
// the warp's fragments to per-warp scratch, meets the warp at __syncwarp,
// and forms each lane's D entries from them; cp.async is a plain copy.
#pragma once

#include <cstdint>
#include <cstring>

#include "chain_mlp.cuh"

namespace nfk {
namespace tc {

using bf16 = __nv_bfloat16;

__host__ __device__ inline int round16(int k) { return (k + 15) & ~15; }

// Leading dimension (elements) of a bf16 operand of k columns in shared
// memory: k padded to 16, plus 8, so that the 8 rows of a fragment load
// start on 8 distinct 4-bank groups.
__host__ __device__ inline int tc_ld(int k) { return round16(k) + 8; }

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
#ifdef NFK_EMU
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
#else
  return *reinterpret_cast<const uint32_t*>(p);
#endif
}

__device__ __forceinline__ uint32_t pack2(bf16 lo, bf16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// The A fragment of rows [r0, r0 + 16), columns [k0, k0 + 16) of a
// row-major bf16 operand with leading dimension ld.
__device__ __forceinline__ void load_a(const bf16* a, int ld, int r0, int k0,
                                       uint32_t (&f)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = a + (r0 + g) * ld + k0 + 2 * t;
  f[0] = ld32(p);
  f[1] = ld32(p + 8 * ld);
  f[2] = ld32(p + 8);
  f[3] = ld32(p + 8 * ld + 8);
}

// The B fragment of output columns [n0, n0 + 8), K rows [k0, k0 + 16),
// from Bt (row n holds B's column n) with leading dimension ld.
__device__ __forceinline__ void load_b(const bf16* bt, int ld, int n0, int k0, uint32_t& b0,
                                       uint32_t& b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const bf16* p = bt + (n0 + g) * ld + k0 + 2 * t;
  b0 = ld32(p);
  b1 = ld32(p + 8);
}

#ifdef NFK_EMU

struct MmaScratch {
  float a[16][16], b[16][8];
};
inline MmaScratch g_mma_scratch[32];  // one per warp of a block

inline float bf16_lo(uint32_t v) { return __bfloat162float(__ushort_as_bfloat16(v & 0xffff)); }
inline float bf16_hi(uint32_t v) { return __bfloat162float(__ushort_as_bfloat16(v >> 16)); }

// d += a b, the warp's fragments exchanged through its scratch
inline void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  MmaScratch& s = g_mma_scratch[threadIdx.x >> 5];
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e & 1), c = 8 * (e >> 1) + 2 * t;
    s.a[r][c] = bf16_lo(a[e]);
    s.a[r][c + 1] = bf16_hi(a[e]);
  }
  s.b[2 * t][g] = bf16_lo(b0);
  s.b[2 * t + 1][g] = bf16_hi(b0);
  s.b[2 * t + 8][g] = bf16_lo(b1);
  s.b[2 * t + 9][g] = bf16_hi(b1);
  __syncwarp();
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);
    float acc = d[e];
    for (int k = 0; k < 16; ++k) acc = fmaf(s.a[r][k], s.b[k][c], acc);
    d[e] = acc;
  }
  __syncwarp();
}

inline void cp_async16(void* dst, const void* src) { std::memcpy(dst, src, 16); }
inline void cp_async_commit() {}
inline void cp_async_wait_all() {}
template <int N>
inline void cp_async_wait() {}

#else

// d += a b on the tensor cores (kernel P's mma16816, dot_probe.cu)
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

// Waits until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

#endif

__device__ __forceinline__ void zero16(void* dst) {
#ifdef NFK_EMU
  std::memset(dst, 0, 16);
#else
  *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
#endif
}

// ------ a row tile times a streamed weight ------

constexpr int kTcRows = 64;                // rows of a tile
constexpr int kTcM = kTcRows / 16;         // its m16 row groups
constexpr int kTcCols = 256;               // output columns a pass: 32 n8 tiles, 4 a warp
constexpr int kTcK = 32;                   // K rows of Bt a stage holds
constexpr int kTcLdB = kTcK + 8;           // padded stage row (conflict-free B loads)
constexpr int kTcStage = kTcCols * kTcLdB; // elements of one stage
constexpr int kTcStages = 3;               // the ring: loads run two stages ahead

// The A operand: rows of the tile in shared memory, K split in two
// segments (e.g. [h | embedding]); k1 and k2 are multiples of 16 and the
// segments are zero past their real widths.
struct TcA {
  const bf16* p1;
  int ld1, k1;
  const bf16* p2;
  int ld2, k2;
};

// Starts copying Bt rows [n0, n0 + nc), K columns [k0, k0 + kTcK) into a
// stage; columns at or past k_total are zeros. Bt rows are 16-byte aligned
// (ldb a multiple of 8) and k_total a multiple of 8.
__device__ __forceinline__ void load_stage(bf16* stage, const bf16* __restrict__ bt,
                                           long long ldb, int n0, int nc, int k0,
                                           int k_total) {
  constexpr int kPieces = kTcK / 8;
  for (int idx = threadIdx.x; idx < nc * kPieces; idx += kThreads) {
    const int r = idx / kPieces, k = k0 + 8 * (idx % kPieces);
    bf16* dst = stage + r * kTcLdB + 8 * (idx % kPieces);
    if (k < k_total)
      cp_async16(dst, bt + (n0 + r) * ldb + k);
    else
      zero16(dst);
  }
  cp_async_commit();
}

// out = A @ Bt^T for the tile's kTcRows rows and columns [0, n): A in
// shared memory (see TcA), Bt (n x (a.k1 + a.k2)) row-major in device
// memory with leading dimension ldb, streamed through a ring of kTcStages
// stages at `ws` (kTcStages * kTcStage elements). Warp w owns the n8 tiles
// w, w + 8, w + 16, w + 24 of each 256-column pass and all kTcM row groups:
// for each of its tiles, all lanes of the warp call epi(c0, v) together,
// v[m][e] the result at row 16 m + g + 8 (e >> 1), column c0 + 2 t + (e &
// 1) (columns past n included where n is not a multiple of 8). Every
// thread of the block calls tc_gemm. It starts by writing `ws` (whose
// previous readers must have passed a barrier: the loop's last barrier
// does so for a previous call); A, and whatever cp.async groups the caller
// committed before the call, are complete at the first barrier inside.
// It ends after the epilogue, without a barrier. Where n <= kTcCols (one
// pass) an epilogue may write over A, which every warp has finished
// reading by then; past that, every pass reads all of A again, so the
// epilogue must write elsewhere.
template <typename Epi>
__device__ void tc_gemm(const TcA& a, const bf16* __restrict__ bt, long long ldb, int n, bf16* ws,
                        Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int k_total = a.k1 + a.k2;
  const int n_stages = (k_total + kTcK - 1) / kTcK;
  for (int n0 = 0; n0 < n; n0 += kTcCols) {
    const int nc = min(kTcCols, n - n0);
    float acc[kTcM][4][4];
#pragma unroll
    for (int m = 0; m < kTcM; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;
    // One committed group per stage, empty past the last, so that
    // wait<kTcStages - 2> always means "stage s has landed"
#pragma unroll
    for (int s = 0; s < kTcStages - 1; ++s) {
      if (s < n_stages)
        load_stage(ws + s * kTcStage, bt, ldb, n0, nc, s * kTcK, k_total);
      else
        cp_async_commit();
    }
    for (int s = 0; s < n_stages; ++s) {
      // Stage s has landed and every warp is done with stage s - 1, whose
      // buffer stage s + kTcStages - 1 now fills
      cp_async_wait<kTcStages - 2>();
      __syncthreads();
      const int next = s + kTcStages - 1;
      if (next < n_stages)
        load_stage(ws + (next % kTcStages) * kTcStage, bt, ldb, n0, nc, next * kTcK, k_total);
      else
        cp_async_commit();
      const bf16* stage = ws + (s % kTcStages) * kTcStage;
#pragma unroll
      for (int kk = 0; kk < kTcK / 16; ++kk) {
        const int k = s * kTcK + 16 * kk;
        if (k >= k_total || 8 * warp >= nc) break;
        const bool first = k < a.k1;
        const bf16* ap = first ? a.p1 : a.p2;
        const int lda = first ? a.ld1 : a.ld2, ka = first ? k : k - a.k1;
        uint32_t af[kTcM][4];
#pragma unroll
        for (int m = 0; m < kTcM; ++m) load_a(ap, lda, 16 * m, ka, af[m]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int nt = warp + 8 * q;
          if (8 * nt >= nc) break;
          uint32_t b0, b1;
          load_b(stage, kTcLdB, 8 * nt, 16 * kk, b0, b1);
#pragma unroll
          for (int m = 0; m < kTcM; ++m) mma16816(acc[m][q], af[m], b0, b1);
        }
      }
    }
    __syncthreads();  // the stages are free for the next pass or call
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int nt = warp + 8 * q;
      if (8 * nt >= nc) break;
      float v[kTcM][4];
#pragma unroll
      for (int m = 0; m < kTcM; ++m)
#pragma unroll
        for (int e = 0; e < 4; ++e) v[m][e] = acc[m][q][e];
      epi(n0 + 8 * nt, v);
    }
  }
}

}  // namespace tc
}  // namespace nfk
