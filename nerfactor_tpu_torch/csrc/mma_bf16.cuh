// Tensor-core building blocks of the chain and field kernels (K1, K1r,
// K1w, fused_mlp.cu; K2, fused_rusink.cu; K3, fused_nerf.cu): products with
// f32 accumulation on mma.sync, fed from shared memory with plain 32-bit
// loads, and cp.async copies for a ring of operand tiles (tc_gemm); the
// padded embedding and the tiny f32 heads around them; the row-paired
// bf16 scratch that a backward's phase 1 writes, its epilogues, and the dW
// pass over it (dw_kernel).
//
// tc_gemm takes its product as a policy (below): MmaBf16, bf16 operands on
// m16n8k16, which every bf16 kernel runs; MmaTf32<3>, f32 operands split
// on load into TF32 hi = rna(a) and lo = rna(a - hi), each product formed
// as lo hi + hi lo + hi hi on m16n8k8 (split TF32, "3xTF32": the dropped
// lo lo term is ~2^-22 of the product), each m16n8k8 step's sum added
// into the f32 accumulator on the CUDA cores, which K1's f32 forward and
// dx-only backward run; MmaTf32<1>, hi hi alone (plain TF32, about three
// decimal digits), the control those two are held against.
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for
// mma.m16n8k16"), lane = 4 g + t:
//   A (16 x 16, row-major): a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//                           a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]
//   B (16 x 8, "col"):      b0 = B[2t, 2t+1][g], b1 = B[2t+8, 2t+9][g]
//   C, D (16 x 8, f32):     d0, d1 = D[g][2t, 2t+1], d2, d3 = D[g+8][2t, 2t+1]
// The lower-addressed bf16 of a pair is the low half of its register. B is
// read from its transpose Bt (n x k, row-major), so both operands load
// pairs of neighbouring k with one 32-bit load. m16n8k8 with TF32 operands
// ("mma.m16n8k8" for .tf32), one 32-bit value a register:
//   A (16 x 8): a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8 x 8):  b0 = B[t][g], b1 = B[t+4][g]
//   C, D as m16n8k16's, so every epilogue reads the same positions.
//
// Under the CPU emulation (csrc/emu, NFK_EMU) each instruction has a
// scalar counterpart with the same lane mapping: the emulated mma writes
// the warp's fragments to per-warp scratch, meets the warp at __syncwarp,
// and forms each lane's D entries from them; cvt.rna.tf32.f32 rounds the
// f32 bits to nearest, ties away from zero, dropping the 13 low ones;
// cp.async is a plain copy.
#pragma once

#include <cstdint>
#include <cstring>

#include "chain_mlp.cuh"

namespace nfk {
namespace tc {

using bf16 = __nv_bfloat16;

__host__ __device__ inline int round16(int k) { return (k + 15) & ~15; }

// Leading dimension (elements) of an operand of k columns of type T in
// shared memory: k padded to 16, plus 16 bytes, so that the 8 rows of a
// fragment load start on 8 distinct 4-bank groups (bf16: + 8; f32: + 4).
template <typename T = bf16>
__host__ __device__ inline int tc_ld(int k) {
  return round16(k) + 16 / static_cast<int>(sizeof(T));
}

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

inline float bits_f32(uint32_t v) {
  float f;
  std::memcpy(&f, &v, 4);
  return f;
}

// cvt.rna.tf32.f32: to nearest, ties away from zero (the magnitude's bit 12
// carries), the 13 low bits dropped; NaN stays NaN, Inf stays Inf
inline uint32_t tf32_rna(float v) {
  uint32_t u;
  std::memcpy(&u, &v, 4);
  if ((u & 0x7f800000u) == 0x7f800000u) return u & 0x007fffffu ? 0x7fffffffu : u;
  return (u + 0x1000u) & 0xffffe000u;
}

// The TF32 products of one m16n8k8 step: d += a_lo b_hi, d += a_hi b_lo
// (kTerms 3), then d += a_hi b_hi, each mma a sum over the 8 K in order,
// as three mma.sync.m16n8k8 in a row; the warp's fragments exchanged once.
// The tensor core reads a register's 19 high bits (the split's values have
// none below).
template <int kTerms>
inline void mma1688_tf32(float (&d)[4], const uint32_t (&a_hi)[4], const uint32_t (&a_lo)[4],
                         const uint32_t (&b_hi)[2], const uint32_t (&b_lo)[2]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  MmaScratch& s = g_mma_scratch[threadIdx.x >> 5];
  // a: hi in columns 0-7, lo in 8-15; b: hi in rows 0-7, lo in 8-15
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e & 1), c = t + 4 * (e >> 1);
    s.a[r][c] = bits_f32(a_hi[e] & 0xffffe000u);
    s.a[r][c + 8] = kTerms == 3 ? bits_f32(a_lo[e] & 0xffffe000u) : 0.f;
  }
  for (int e = 0; e < 2; ++e) {
    s.b[t + 4 * e][g] = bits_f32(b_hi[e] & 0xffffe000u);
    s.b[t + 4 * e + 8][g] = kTerms == 3 ? bits_f32(b_lo[e] & 0xffffe000u) : 0.f;
  }
  __syncwarp();
  for (int e = 0; e < 4; ++e) {
    const int r = g + 8 * (e >> 1), c = 2 * t + (e & 1);
    float acc = d[e];
    if (kTerms == 3) {
      for (int k = 0; k < 8; ++k) acc = fmaf(s.a[r][k + 8], s.b[k][c], acc);
      for (int k = 0; k < 8; ++k) acc = fmaf(s.a[r][k], s.b[k + 8][c], acc);
    }
    for (int k = 0; k < 8; ++k) acc = fmaf(s.a[r][k], s.b[k][c], acc);
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

__device__ __forceinline__ float bits_f32(uint32_t v) { return __uint_as_float(v); }

// cvt.rna.tf32.f32: to nearest, ties away from zero, the 13 low bits zero
__device__ __forceinline__ uint32_t tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// d += a b on the tensor cores with TF32 operands, one m16n8k8
__device__ __forceinline__ void mma1688(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                        uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The TF32 products of one m16n8k8 step: d += a_lo b_hi, d += a_hi b_lo
// (kTerms 3), then d += a_hi b_hi
template <int kTerms>
__device__ __forceinline__ void mma1688_tf32(float (&d)[4], const uint32_t (&a_hi)[4],
                                             const uint32_t (&a_lo)[4],
                                             const uint32_t (&b_hi)[2],
                                             const uint32_t (&b_lo)[2]) {
  if (kTerms == 3) {
    mma1688(d, a_lo, b_hi[0], b_hi[1]);
    mma1688(d, a_hi, b_lo[0], b_lo[1]);
  }
  mma1688(d, a_hi, b_hi[0], b_hi[1]);
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
constexpr int kTcK = 32;                   // K rows of Bt a bf16 stage holds
constexpr int kTcLdB = kTcK + 8;           // padded stage row (conflict-free B loads)
constexpr int kTcStage = kTcCols * kTcLdB; // elements of one bf16 stage
constexpr int kTcStages = 3;               // the ring: loads run two stages ahead

// ------ the product policies ------
//
// A policy gives tc_gemm its operand type T, the K of one mma (kStep), the
// K rows of Bt a ring stage holds (kK: a stage holds kTcStage bf16's bytes
// in every policy, so the ring's size does not depend on it), the A and B
// fragments, their loaders from shared memory and the product.

// bf16 operands, m16n8k16 (every bf16 kernel)
struct MmaBf16 {
  using T = bf16;
  static constexpr int kStep = 16, kK = kTcK;
  struct A {
    uint32_t r[4];
  };
  struct B {
    uint32_t b0, b1;
  };
  __device__ static void load_a(const T* a, int ld, int r0, int k0, A& f) {
    tc::load_a(a, ld, r0, k0, f.r);
  }
  __device__ static void load_b(const T* bt, int ld, int n0, int k0, B& f) {
    tc::load_b(bt, ld, n0, k0, f.b0, f.b1);
  }
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
    mma16816(d, a.r, b.b0, b.b1);
  }
};

// f32 operands split into TF32 hi and lo on load, m16n8k8: kTerms 3 forms
// lo hi + hi lo + hi hi (K1's f32 kernels), kTerms 1 hi hi alone (the
// control)
template <int kTerms>
struct MmaTf32 {
  static_assert(kTerms == 1 || kTerms == 3, "1 or 3 products");
  using T = float;
  static constexpr int kStep = 8, kK = kTcK / 2;
  struct A {
    uint32_t hi[4], lo[4];
  };
  struct B {
    uint32_t hi[2], lo[2];
  };
  __device__ static void split(float v, uint32_t& hi, uint32_t& lo) {
    hi = tf32_rna(v);
    lo = kTerms == 3 ? tf32_rna(v - bits_f32(hi)) : 0u;
  }
  __device__ static void load_a(const T* a, int ld, int r0, int k0, A& f) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const T* p = a + (r0 + g) * ld + k0 + t;
    split(p[0], f.hi[0], f.lo[0]);
    split(p[8 * ld], f.hi[1], f.lo[1]);
    split(p[4], f.hi[2], f.lo[2]);
    split(p[8 * ld + 4], f.hi[3], f.lo[3]);
  }
  __device__ static void load_b(const T* bt, int ld, int n0, int k0, B& f) {
    const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
    const T* p = bt + (n0 + g) * ld + k0 + t;
    split(p[0], f.hi[0], f.lo[0]);
    split(p[4], f.hi[1], f.lo[1]);
  }
  // The step's products go to a fresh accumulator, added into d on the
  // CUDA cores (rounded to nearest): the tensor cores do not round an
  // mma's sum to nearest, and with d as their accumulator the error grew
  // with the running sum (on an H100, K = 256: 2.2e-6 of the largest
  // value against float64, the fresh accumulator 2.5e-7, f32 cuBLAS 6.2e-7)
  __device__ static void mma(float (&d)[4], const A& a, const B& b) {
    float t[4] = {0.f, 0.f, 0.f, 0.f};
    mma1688_tf32<kTerms>(t, a.hi, a.lo, b.hi, b.lo);
#pragma unroll
    for (int e = 0; e < 4; ++e) d[e] += t[e];
  }
};
using MmaTf32x3 = MmaTf32<3>;
using MmaTf32x1 = MmaTf32<1>;

// The ring's geometry for policy P: a stage row of P::kK K values plus 16
// bytes of pad (conflict-free B loads), kTcCols rows a stage
template <typename P>
struct Ring {
  using T = typename P::T;
  static constexpr int kLdB = P::kK + 16 / static_cast<int>(sizeof(T));
  static constexpr int kStage = kTcCols * kLdB;  // elements of one stage
  static constexpr size_t kBytes = sizeof(T) * kTcStages * kStage;
};

// The A operand: rows of the tile in shared memory, K split in two
// segments (e.g. [h | embedding]); k1 and k2 are multiples of 16 and the
// segments are zero past their real widths.
template <typename T>
struct TcAOf {
  const T* p1;
  int ld1, k1;
  const T* p2;
  int ld2, k2;
};
using TcA = TcAOf<bf16>;

// Starts copying Bt rows [n0, n0 + nc), K columns [k0, k0 + P::kK) into a
// stage; columns at or past k_total are zeros. Bt rows are 16-byte aligned
// and k_total a multiple of 16 bytes' elements.
template <typename P = MmaBf16>
__device__ __forceinline__ void load_stage(typename P::T* stage,
                                           const typename P::T* __restrict__ bt, long long ldb,
                                           int n0, int nc, int k0, int k_total) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(typename P::T));
  constexpr int kPieces = P::kK / kVec, kLdB = Ring<P>::kLdB;
  for (int idx = threadIdx.x; idx < nc * kPieces; idx += kThreads) {
    const int r = idx / kPieces, k = k0 + kVec * (idx % kPieces);
    typename P::T* dst = stage + r * kLdB + kVec * (idx % kPieces);
    if (k < k_total)
      cp_async16(dst, bt + (n0 + r) * ldb + k);
    else
      zero16(dst);
  }
  cp_async_commit();
}

// out = A @ Bt^T for the tile's kTcRows rows and columns [0, n), products
// as policy P forms them: A in shared memory (see TcAOf), Bt (n x (a.k1 +
// a.k2)) row-major in device memory with leading dimension ldb, streamed
// through a ring of kTcStages stages at `ws` (Ring<P>::kBytes). Warp w
// owns the n8 tiles w, w + 8, w + 16, w + 24 of each 256-column pass and
// all kTcM row groups: for each of its tiles, all lanes of the warp call
// epi(c0, v) together, v[m][e] the result at row 16 m + g + 8 (e >> 1),
// column c0 + 2 t + (e & 1) (columns past n included where n is not a
// multiple of 8). Every thread of the block calls tc_gemm. It starts by
// writing `ws` (whose previous readers must have passed a barrier: the
// loop's last barrier does so for a previous call); A, and whatever
// cp.async groups the caller committed before the call, are complete at
// the first barrier inside. It ends after the epilogue, without a barrier.
// Where n <= kTcCols (one pass) an epilogue may write over A, which every
// warp has finished reading by then; past that, every pass reads all of A
// again, so the epilogue must write elsewhere.
template <typename P = MmaBf16, typename Epi>
__device__ void tc_gemm(const TcAOf<typename P::T>& a, const typename P::T* __restrict__ bt,
                        long long ldb, int n, typename P::T* ws, Epi epi) {
  using T = typename P::T;
  constexpr int kK = P::kK, kLdB = Ring<P>::kLdB, kStage = Ring<P>::kStage;
  const int warp = threadIdx.x >> 5;
  const int k_total = a.k1 + a.k2;
  const int n_stages = (k_total + kK - 1) / kK;
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
        load_stage<P>(ws + s * kStage, bt, ldb, n0, nc, s * kK, k_total);
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
        load_stage<P>(ws + (next % kTcStages) * kStage, bt, ldb, n0, nc, next * kK, k_total);
      else
        cp_async_commit();
      const T* stage = ws + (s % kTcStages) * kStage;
#pragma unroll
      for (int kk = 0; kk < kK / P::kStep; ++kk) {
        const int k = s * kK + P::kStep * kk;
        if (k >= k_total || 8 * warp >= nc) break;
        const bool first = k < a.k1;
        const T* ap = first ? a.p1 : a.p2;
        const int lda = first ? a.ld1 : a.ld2, ka = first ? k : k - a.k1;
        typename P::A af[kTcM];
#pragma unroll
        for (int m = 0; m < kTcM; ++m) P::load_a(ap, lda, 16 * m, ka, af[m]);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int nt = warp + 8 * q;
          if (8 * nt >= nc) break;
          typename P::B bf;
          P::load_b(stage, kLdB, 8 * nt, P::kStep * kk, bf);
#pragma unroll
          for (int m = 0; m < kTcM; ++m) P::mma(acc[m][q], af[m], bf);
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

using tc::bf16;
using tc::round16;

// ------ around the products: the embedding and the tiny heads ------

// Zeroes a 64-row tile's embedding columns (es, ld lde, type T) from its
// width up to the next 16: the products read them. No barrier.
template <typename T>
__device__ inline void zero_embed_pad(const ChainDesc& d, T* es, int lde) {
  const int ne = d.embed_dim, e16 = round16(ne);
  for (int idx = threadIdx.x; idx < tc::kTcRows * 16; idx += kThreads) {
    const int r = idx / 16, c = idx % 16;
    if (ne + c < e16) es[r * lde + ne + c] = from_f<T>(0.f);
  }
}

// The embedding of a 64-row tile's raw rows `xs` into es (ld lde, type T),
// its columns up to the next 16 zero. No barrier.
template <typename T>
__device__ inline void embed_tile(const ChainDesc& d, const float* xs, T* es, int lde) {
  embed_rows<T, tc::kTcRows>(d, xs, es, lde);
  zero_embed_pad(d, es, lde);
}

// A tiny head's sums over a 64-row tile's last post h (ld ldh, k wide,
// type H), in f32 on the CUDA cores: for each row r and column c < n_out,
// s = sum_j h[r][j] w[j][c] (w (k, n_out) row-major at type W), split over
// 4 neighbouring lanes, each a quarter of K, joined by shuffles in a fixed
// order; then f(item, r, c, s) on the first of the 4 lanes (item = r n_out
// + c). Every thread calls it, and every loop runs the same trips on every
// thread (the shuffles need whole warps).
template <typename H, typename W, typename F>
__device__ inline void head_sums(const H* h, int ldh, int k, const W* __restrict__ w,
                                 int n_out, F f) {
  constexpr int R = tc::kTcRows;
  for (int base = 0; base < 4 * R * n_out; base += kThreads) {
    const int idx = base + threadIdx.x, item = idx >> 2, part = idx & 3;
    const bool live = item < R * n_out;
    const int r = live ? item / n_out : 0, c = live ? item % n_out : 0;
    float s = 0.f;
    if (live)
      for (int j = part; j < k; j += 4)
        s = fmaf(to_f<H>(h[r * ldh + j]), to_f<W>(w[j * n_out + c]), s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    s += __shfl_xor_sync(0xffffffffu, s, 2);
    if (live && part == 0) f(item, r, c, s);
  }
}

// ------ the row-paired scratch of the bf16 backwards (K1-bwd, K3-bwd) ------
//
// Phase 1 of a bf16 backward writes, per 64-row tile, the bf16 inputs and
// the rounded d_pre of every dense layer to a scratch in device memory,
// and the dW pass forms dW = X^T D from it. The scratch pairs its rows:
// 32-bit word (j, c) of a tile holds rows 2j and 2j + 1 of column c (the
// lower row in the low half), and a tile is kPairs rows of `total` words.
// So phase 1 writes a row pair of neighbouring columns with neighbouring
// threads, and the dW pass loads the pair of neighbouring K values an mma
// fragment register holds with one 32-bit load.

constexpr int kPairs = tc::kTcRows / 2;  // row pairs of a tile

// A dense layer of a scratch: its input columns [seg1, seg1 + k1) and
// [seg2, seg2 + k2) of a scratch row (segments start at multiples of 16
// columns; k1 is one where k2 > 0), its d_pre columns from `dpre`, its
// width n, and its dW's offset in the packed dW.
struct DenseLayer {
  int seg1, k1, seg2, k2, dpre, n;
  long long w_off;
};

// What the dW pass reads: the dense layers of a scratch of `total` words a
// row pair, and n_dense, the floats of the packed dW (one row chunk's
// partial). Passed to the kernel by value.
constexpr int kMaxDense = kMaxLayers + 2;
struct DwTable {
  int n_layers, total;
  long long n_dense;
  DenseLayer layers[kMaxDense];
};

// Writes columns [0, cols) of a tile's rows (bf16 in shared memory, ld)
// to the scratch tile `st` (32-bit words, rows of `total`) from column
// col0: word (j, col0 + c) packs rows 2j and 2j + 1 of column c.
__device__ inline void store_pairs(const bf16* src, int ld, int cols, uint32_t* st, int total,
                                   int col0) {
  for (int idx = threadIdx.x; idx < kPairs * cols; idx += kThreads) {
    const int j = idx / cols, c = idx % cols;
    st[j * total + col0 + c] = tc::pack2(src[2 * j * ld + c], src[(2 * j + 1) * ld + c]);
  }
}

// The scratch words of a tc_gemm result fragment's bf16 values y (y[m][e]
// at row 16 m + g + 8 (e >> 1), column 2 t + (e & 1) of the fragment,
// which starts at scratch column col): a lane swaps rows with its
// neighbour (lane ^ 4 holds row r ^ 1) and stores one row pair, 8
// neighbouring words a row pair per warp. All lanes of the warp call it.
__device__ inline void store_frag_pairs(const bf16 (&y)[tc::kTcM][4], uint32_t* st, int total,
                                 int col) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < tc::kTcM; ++m)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t mine = tc::pack2(y[m][2 * h], y[m][2 * h + 1]);
      const uint32_t other = __shfl_xor_sync(0xffffffffu, mine, 4);
      // Even g: column 2t, rows (r, r + 1); odd g: column 2t + 1, rows (r - 1, r)
      const uint32_t word =
          g & 1 ? (other >> 16) | (mine & 0xffff0000u) : (mine & 0xffffu) | (other << 16);
      st[((16 * m + g + 8 * h) >> 1) * total + col + 2 * t + (g & 1)] = word;
    }
}

// The f32 backward's scratch (K1-bwd with dW in split TF32) keeps its rows
// as they are: a tile is kTcRows rows of `total` floats. store_rows writes
// columns [0, cols) of a tile's rows (f32 in shared memory, ld) from
// column col0; store_frag_rows a tc_gemm result fragment's values y (rows
// and columns as store_frag_pairs reads them) from column col.
__device__ inline void store_rows(const float* src, int ld, int cols, float* st, int total,
                                  int col0) {
  for (int idx = threadIdx.x; idx < tc::kTcRows * cols; idx += kThreads) {
    const int r = idx / cols, c = idx % cols;
    st[r * total + col0 + c] = src[r * ld + c];
  }
}

__device__ inline void store_frag_rows(const float (&y)[tc::kTcM][4], float* st, int total,
                                       int col) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int m = 0; m < tc::kTcM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      st[(16 * m + g + 8 * (e >> 1)) * total + col + 2 * t + (e & 1)] = y[m][e];
}

// The bf16 value of row r, column c of the scratch tile `st`.
__device__ __forceinline__ float scratch_at(const uint32_t* st, int total, int r, int c) {
  const uint32_t v = st[(r >> 1) * total + c];
  return __bfloat162float(
      __ushort_as_bfloat16(static_cast<unsigned short>(r & 1 ? v >> 16 : v & 0xffffu)));
}

// A forward product's epilogue: out = T(act(v + b)) into the tile's buffer
// (ld ldo) and, with kStore, its scratch columns from col (bf16: row
// pairs; f32: rows, store_frag_rows). ReLU,
// every hidden layer's act in the shipped chains and fields, takes its own
// loop: `activate`'s switch on each of the 16 values costs phase 1 more
// than its products (the same values either way).
template <bool kStore, typename T = bf16>
__device__ inline void fwd_epilogue(int c0, const float (&v)[tc::kTcM][4], int act,
                                    const float* __restrict__ b, T* out, int ldo, uint32_t* st,
                                    int total, int col) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  T y[tc::kTcM][4];
  if (act == kRelu) {
#pragma unroll
    for (int m = 0; m < tc::kTcM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m + g + 8 * (e >> 1), c = c0 + 2 * t + (e & 1);
        y[m][e] = from_f<T>(fmaxf(v[m][e] + b[c], 0.f));
        out[r * ldo + c] = y[m][e];
      }
  } else {
#pragma unroll
    for (int m = 0; m < tc::kTcM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m + g + 8 * (e >> 1), c = c0 + 2 * t + (e & 1);
        y[m][e] = from_f<T>(activate(act, v[m][e] + b[c]));
        out[r * ldo + c] = y[m][e];
      }
  }
  if constexpr (kStore) {
    if constexpr (sizeof(T) == 2)
      store_frag_pairs(y, st, total, col + c0);
    else
      store_frag_rows(y, reinterpret_cast<float*>(st), total, col + c0);
  }
}

// A d_pre @ W^T product's epilogue, which makes the next layer's d_pre:
// u = f(r, c, v) (the d_h term and act'), db += the column sums of the
// unrounded u (each column is one warp's: in-lane over its 8 rows, then
// across the 8 lanes of its t, in a fixed order), and bf16(u) into the
// tile's buffer (ld ldp) and the scratch columns from col.
template <typename F>
__device__ inline void dpre_epilogue(int c0, const float (&v)[tc::kTcM][4], F f, bf16* dpre, int ldp,
                                     uint32_t* st, int total, int col, float* db) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  bf16 y[tc::kTcM][4];
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int m = 0; m < tc::kTcM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * m + g + 8 * (e >> 1), c = c0 + 2 * t + (e & 1);
      const float u = f(r, c, v[m][e]);
      s[e & 1] += u;
      y[m][e] = from_f<bf16>(u);
      dpre[r * ldp + c] = y[m][e];
    }
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int off = 4; off < 32; off *= 2) s[e] += __shfl_xor_sync(0xffffffffu, s[e], off);
  if (g == 0) {
    db[c0 + 2 * t] += s[0];
    db[c0 + 2 * t + 1] += s[1];
  }
  store_frag_pairs(y, st, total, col + c0);
}

// ------ the dW pass ------
//
// A block owns a kTile x kTile tile of one dense layer's dW and one of
// `chunks` row chunks (64-row tiles [t0, t1) of the scratch), and writes
// its f32 partial to part[chunk * n_dense + ...]. Its operands keep the
// scratch's row pairs in shared memory: X^T's and D's K dimension is the
// tile's rows, so a fragment register is one word. 8 warps of (kTile / 2)
// x (kTile / 4). K3-bwd's dW tiles are 128 wide; the lvis chain's four
// 128-wide layers make only 5 such tiles, so the chain takes 64 (20
// tiles, four times the blocks). The tile changes no sum (each dW entry
// adds the same mma products over the same rows in the same order), so
// not the bits either.
constexpr int kMaxDwChunks = 8;

template <int kTile>
struct DwShape {
  static constexpr int ld = kTile + 8;             // words of an operand's row pair
  static constexpr int operand = kPairs * ld;      // words of one operand's tile
  static constexpr int frags = kTile / 32;         // m16 and n8 fragments a warp
  static constexpr size_t smem = sizeof(uint32_t) * 4 * operand;  // 2 stages of [X | D]
};

template <int kTile>
__host__ __device__ inline int dw_tiles(const DenseLayer& l) {
  return ((l.k1 + l.k2 + kTile - 1) / kTile) * ((l.n + kTile - 1) / kTile);
}

template <int kTile>
__host__ __device__ inline int dw_tiles_total(const DwTable& t) {
  int n = 0;
  for (int i = 0; i < t.n_layers; ++i) n += dw_tiles<kTile>(t.layers[i]);
  return n;
}

// The number of row chunks of the dW pass for n rows: at most
// kMaxDwChunks (8 x the dense weights in f32 stay in the L2), at most one
// a 64-row tile.
inline int dw_chunks(long long n) {
  const long long tiles = (n + tc::kTcRows - 1) / tc::kTcRows;
  return static_cast<int>(tiles < kMaxDwChunks ? tiles : kMaxDwChunks);
}

// Starts copying positions [c0, c0 + kTile) of a product's operand from
// one scratch tile `src` (rows of `total` words) into dst (kPairs rows of
// DwShape::ld words), 4 positions a 16-byte request: position m is
// scratch column seg1 + m below k1, seg2 + m - k1 above; zeros from k on.
template <int kTile>
__device__ inline void load_dw_operand(uint32_t* dst, const uint32_t* src, int total, int c0,
                                       int seg1, int k1, int seg2, int k) {
  constexpr int kPieces = kTile / 4, ld = DwShape<kTile>::ld;
  for (int idx = threadIdx.x; idx < kPairs * kPieces; idx += kThreads) {
    const int j = idx / kPieces, p = idx % kPieces, m = c0 + 4 * p;
    uint32_t* to = dst + j * ld + 4 * p;
    if (m < k)
      tc::cp_async16(to, src + static_cast<long long>(j) * total +
                             (m < k1 ? seg1 + m : seg2 + m - k1));
    else
      tc::zero16(to);
  }
}

// The m16n8k16 fragments from row-paired operands (word (j, m) holds K
// values 2j and 2j + 1 of position m; rows of ld words): A of positions
// [m0, m0 + 16) and B of positions [n0, n0 + 8), both over K [16 kk, 16 kk
// + 16).
template <int ld>
__device__ __forceinline__ void pair_frag_a(const uint32_t* s, int m0, int kk,
                                            uint32_t (&f)[4]) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* p = s + (8 * kk + t) * ld + m0 + g;
  f[0] = p[0];
  f[1] = p[8];
  f[2] = p[4 * ld];
  f[3] = p[4 * ld + 8];
}

template <int ld>
__device__ __forceinline__ void pair_frag_b(const uint32_t* s, int n0, int kk, uint32_t& b0,
                                            uint32_t& b1) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* p = s + (8 * kk + t) * ld + n0 + g;
  b0 = p[0];
  b1 = p[4 * ld];
}

// Each source that includes this header compiles its own copy (static).
template <int kTile>
static __global__ void __launch_bounds__(kThreads)
dw_kernel(DwTable tab, const uint32_t* __restrict__ scratch, float* __restrict__ part,
          int chunks, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  using S = DwShape<kTile>;
  constexpr int R = tc::kTcRows, F = S::frags;
  uint32_t* buf = reinterpret_cast<uint32_t*>(smem);
  const int chunk = blockIdx.x % chunks;
  int tile = blockIdx.x / chunks, li = 0;
  while (tile >= dw_tiles<kTile>(tab.layers[li])) tile -= dw_tiles<kTile>(tab.layers[li++]);
  const DenseLayer l = tab.layers[li];
  const int k = l.k1 + l.k2, n_tiles_n = (l.n + kTile - 1) / kTile;
  const int m0 = (tile / n_tiles_n) * kTile, c0 = (tile % n_tiles_n) * kTile;
  const int total = tab.total;
  const long long row_tiles = (n + R - 1) / R;
  const long long t0 = row_tiles * chunk / chunks, t1 = row_tiles * (chunk + 1) / chunks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of (kTile / 2) x (kTile / 4)
  float acc[F][F][4];
#pragma unroll
  for (int m = 0; m < F; ++m)
#pragma unroll
    for (int q = 0; q < F; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;
  auto load = [&](long long rt, uint32_t* stage) {
    const uint32_t* src = scratch + rt * kPairs * total;
    load_dw_operand<kTile>(stage, src, total, m0, l.seg1, l.k1, l.seg2, k);
    load_dw_operand<kTile>(stage + S::operand, src, total, c0, l.dpre, l.n, 0, l.n);
    tc::cp_async_commit();
  };
  if (t0 < t1) load(t0, buf);
  for (long long rt = t0; rt < t1; ++rt) {
    const int s = static_cast<int>((rt - t0) & 1);
    // Tile rt has landed and every warp is done with the other stage
    tc::cp_async_wait_all();
    __syncthreads();
    if (rt + 1 < t1) load(rt + 1, buf + (s ^ 1) * 2 * S::operand);
    const uint32_t* xs = buf + s * 2 * S::operand;
    const uint32_t* ds = xs + S::operand;
#pragma unroll
    for (int kk = 0; kk < R / 16; ++kk) {
      uint32_t af[F][4];
#pragma unroll
      for (int m = 0; m < F; ++m)
        pair_frag_a<S::ld>(xs, kTile / 2 * wm + 16 * m, kk, af[m]);
#pragma unroll
      for (int q = 0; q < F; ++q) {
        uint32_t b0, b1;
        pair_frag_b<S::ld>(ds, kTile / 4 * wn + 8 * q, kk, b0, b1);
#pragma unroll
        for (int m = 0; m < F; ++m) tc::mma16816(acc[m][q], af[m], b0, b1);
      }
    }
  }
  float* out = part + chunk * tab.n_dense + l.w_off;
#pragma unroll
  for (int m = 0; m < F; ++m)
#pragma unroll
    for (int q = 0; q < F; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + kTile / 2 * wm + 16 * m + g + 8 * (e >> 1);
        const int c = c0 + kTile / 4 * wn + 8 * q + 2 * t + (e & 1);
        if (r < k && c < l.n) out[static_cast<long long>(r) * l.n + c] = acc[m][q][e];
      }
}

// The dW pass (dW tiles of kTile x kTile) over a scratch of n rows, then
// the sum of its chunks in chunk order into dw (n_dense floats); part
// holds chunks x n_dense floats. Returns 0 or an error code.
template <int kTile>
inline int dw_pass(const DwTable& tab, const uint32_t* scratch, float* part, float* dw,
                   int chunks, long long n, cudaStream_t stream) {
  if (chunks < 1) return kErrBadArgs;
  int err = launch_with_smem(dw_kernel<kTile>, DwShape<kTile>::smem,
                             static_cast<long long>(dw_tiles_total<kTile>(tab)) * chunks, stream,
                             tab, scratch, part, chunks, n);
  if (err) return err;
  return sum_slices(part, chunks, tab.n_dense, dw, stream);
}

}  // namespace nfk
