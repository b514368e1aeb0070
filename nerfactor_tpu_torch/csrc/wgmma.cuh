// Hopper building blocks (sm_90a): the warpgroup product wgmma
// m64n128k16 (bf16 operands, f32 accumulators; A from registers or from
// shared memory), the shared-memory matrix descriptor with its swizzles,
// mbarriers, the 1-D bulk copy (TMA) that completes on an mbarrier, the
// fences between them and setmaxnreg. Kernel P (dot_probe.cu) is built on
// them; the chain kernels K1-K3 still run on mma.sync (mma_bf16.cuh).
//
// wgmma: the four warps of a warpgroup (128 threads, the first warp's
// index a multiple of 4) issue one asynchronous product D (64 x 128) +=
// A (64 x 16) B (16 x 128). Warp w of the group owns rows 16 w .. 16 w +
// 15, lane = 4 g + t (PTX ISA, "Register Fragments and Shared Memory
// Matrix Layouts" for wgmma .m64nNk16):
//   A in registers (RS), 4 x 32 bits a thread, mma.m16n8k16's A layout:
//     a0 = A[g][2t, 2t+1], a1 = A[g+8][2t, 2t+1],
//     a2 = A[g][2t+8, 2t+9], a3 = A[g+8][2t+8, 2t+9]   (rows within the warp's 16)
//   D, 64 f32 a thread: d[4j + 2h + c] = D[g + 8h][8j + 2t + c]
// so the accumulator of output columns 16 kk .. 16 kk + 15 packs into the
// A fragment of K step kk of a next product (pack_acc), as mma.sync's does.
// The lower-addressed bf16 of a pair is the low half of its register.
//
// Operands in shared memory are K-major (K contiguous: B[k][n] sits at
// row n, which is W[n][k] for a product by W^T) and 128-byte swizzled:
// rows of 128 bytes (64 bf16 of K), 8 rows an atom of 1,024 bytes, the
// 16-byte piece c of row r stored at piece c ^ (r % 8) (sw128_offset). A
// K of 128 is two such column blocks, each rows x 128 bytes. The
// descriptor of K step kk starts at the tile + (kk / 4) blocks + (kk % 4)
// x 32 bytes, with a stride byte offset (SBO) of 1,024 between 8-row
// groups (kmajor_sw128_desc); the leading byte offset is not read for a
// swizzled K-major operand whose K step (32 bytes) fits in the swizzle's
// width. The hardware swizzles the address's bits 4-6 with its bits 7-9,
// so a tile starts on a 1,024-byte boundary of the shared window.
//
// Under the CPU emulation (csrc/emu, NFK_EMU) each instruction has a
// scalar counterpart with the same lane mapping. The emulated wgmma is
// asynchronous as the card's is: issue queues the product (A's registers
// read at issue), commit closes a group, and wait_group<N> runs every
// queued product but those of the newest N groups, the warpgroup meeting
// at its barrier (nfk_emu_wg_sync) to pool its A fragments; each thread
// then decodes the descriptor (start, LBO, SBO, swizzle) and reads B (and
// A from shared memory, SS) at the swizzled addresses, as the hardware
// does. So an accumulator read before its wait, or a stage overwritten
// before the products that read it are done, shows as a wrong result. An
// mbarrier's state (phase, expected and pending arrivals, transaction
// bytes) lives in its 8 bytes of shared memory under one lock; the bulk
// copy is a memcpy that then completes its bytes on the barrier;
// setmaxnreg and the fences do nothing.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>
#ifdef NFK_EMU
#include <chrono>
#include <mutex>
#include <thread>
#include <vector>
#endif

namespace nfk {
namespace wg {

constexpr int kN = 128;         // columns of D and of B
constexpr int kAccRegs = 64;    // f32 accumulators a thread (64 x 128 / 128)
constexpr int kSwizzleAtom = 1024;  // bytes of an 8-row 128-byte-swizzled atom

// Descriptor layout types (bits 62-63)
enum Layout : int { kInterleave = 0, kSwizzle128 = 1, kSwizzle64 = 2, kSwizzle32 = 3 };

// The shared-window address of a pointer into shared memory
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
#ifdef NFK_EMU
  return static_cast<uint32_t>(static_cast<const unsigned char*>(p) - smem);
#else
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
#endif
}

// The matrix descriptor: start address, leading and stride byte offsets
// (16-byte units), layout type; base offset 0 (every tile starts on its
// swizzle's 1,024-byte boundary)
__host__ __device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo, uint32_t sbo,
                                                       int layout) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32) |
         (static_cast<uint64_t>(layout & 3) << 62);
}

// Byte offset of element (r, k) of a K-major operand of `rows` rows and a
// K of 128 in 128-byte-swizzled layout: column block k / 64 (rows x 128
// bytes), row r, the 16-byte piece (k % 64) / 8 moved to piece ^ (r % 8)
__host__ __device__ __forceinline__ uint32_t sw128_offset(int r, int k, int rows) {
  return static_cast<uint32_t>((k >> 6) * rows * 128 + r * 128 +
                               ((((k & 63) >> 3) ^ (r & 7)) << 4) + (k & 7) * 2);
}

// The descriptor of K step kk (K columns 16 kk .. 16 kk + 15) of a
// 128-byte-swizzled K-major operand of `rows` rows that starts at `tile`
__device__ __forceinline__ uint64_t kmajor_sw128_desc(uint32_t tile, int rows, int kk) {
  return make_desc(tile + (kk >> 2) * rows * 128 + (kk & 3) * 32, 16, kSwizzleAtom,
                   kSwizzle128);
}

// Two f32 as a bf16 pair (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
#ifdef NFK_EMU
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi))) << 16);
#else
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
#endif
}

__device__ __forceinline__ float as_f32(uint32_t bits) {
#ifdef NFK_EMU
  float f;
  std::memcpy(&f, &bits, 4);
  return f;
#else
  return __uint_as_float(bits);
#endif
}

__device__ __forceinline__ float bf16x2_lo(uint32_t v) { return as_f32(v << 16); }
__device__ __forceinline__ float bf16x2_hi(uint32_t v) { return as_f32(v & 0xffff0000u); }

// Two neighbouring f32 (8-byte aligned) and two neighbouring bf16 (4-byte
// aligned)
__device__ __forceinline__ void ld_f32x2(const float* p, float& a, float& b) {
#ifdef NFK_EMU
  a = p[0];
  b = p[1];
#else
  const float2 v = *reinterpret_cast<const float2*>(p);
  a = v.x;
  b = v.y;
#endif
}

__device__ __forceinline__ void st_f32x2(float* p, float a, float b) {
#ifdef NFK_EMU
  p[0] = a;
  p[1] = b;
#else
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
#endif
}

__device__ __forceinline__ uint32_t ld_bf16x2(const __nv_bfloat16* p) {
#ifdef NFK_EMU
  uint32_t v;
  std::memcpy(&v, p, 4);
  return v;
#else
  return *reinterpret_cast<const uint32_t*>(p);
#endif
}

// A 32-bit store to 4-byte-aligned memory
__device__ __forceinline__ void st_u32(void* p, uint32_t v) {
#ifdef NFK_EMU
  std::memcpy(p, &v, 4);
#else
  *reinterpret_cast<uint32_t*>(p) = v;
#endif
}

// The accumulator of D's columns 16 kk .. 16 kk + 15, as bf16, is the A
// fragment of K step kk of the next product
__device__ __forceinline__ void pack_acc(uint32_t (&a)[8][4], const float (&d)[kAccRegs]) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    a[kk][0] = pack_bf16x2(d[8 * kk + 0], d[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(d[8 * kk + 2], d[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(d[8 * kk + 4], d[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(d[8 * kk + 6], d[8 * kk + 7]);
  }
}

#ifndef NFK_EMU

// ---- the card ----

#define NFK_WG_D64                                                                            \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                   \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "          \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "          \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"
#define NFK_WG_D64_OPERANDS(d)                                                                \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),         \
      "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),              \
      "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),           \
      "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),           \
      "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),           \
      "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),           \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),           \
      "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),           \
      "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),           \
      "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),           \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d (+)= A B^T: A's fragment from registers, B from shared memory through
// desc_b (K-major); scale_d 0 overwrites d
__device__ __forceinline__ void mma_rs(float (&d)[kAccRegs], const uint32_t (&a)[4],
                                       uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NFK_WG_D64
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : NFK_WG_D64_OPERANDS(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// d (+)= A B^T, both from shared memory (K-major)
__device__ __forceinline__ void mma_ss(float (&d)[kAccRegs], uint64_t desc_a, uint64_t desc_b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " NFK_WG_D64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : NFK_WG_D64_OPERANDS(d)
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

#undef NFK_WG_D64
#undef NFK_WG_D64_OPERANDS

// Orders the warpgroup's earlier register and shared-memory accesses
// before its next wgmma
__device__ __forceinline__ void fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }

// Closes the warpgroup's issued products into a group
__device__ __forceinline__ void commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most N of the warpgroup's groups are pending
template <int N>
__device__ __forceinline__ void wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving reads of the accumulators above the wait
// that completes them (and writes below a product that reads them)
template <int R>
__device__ __forceinline__ void fence_operands(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// Makes the barriers' initialisation visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrives on bar where `pred` holds: a predicated instruction, not a
// branch, so that no divergent path lies between a warpgroup's wgmma and
// its wait (ptxas serializes the products around one)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 st;\nsetp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// Arrives and adds `bytes` to the transactions the phase waits for
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// Waits until the phase of parity `parity` has completed: the poll loop
// inside one asm statement (labels local to its braces), so that the
// compiler sees no divergent branch of its own between a wgmma and its
// wait
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// TMA's 1-D bulk copy of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory to shared memory; completes its bytes on bar
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// Orders the threads' own shared-memory writes before the async proxy's
// reads of them (a wgmma operand written by st.shared)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The warpgroup's registers a thread: raised for consumers, lowered for a
// producer warpgroup (all four warps together)
template <int R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

#else  // NFK_EMU

// ---- the emulation ----

// Byte offset in shared memory of element (r, k), 0 <= k < 16, of the
// K-major operand that desc describes: 8-row groups SBO apart; within a
// group rows the swizzle's width apart (128, 64 or 32 bytes), the 16-byte
// piece index (bits 4-6, 4-5 or 4) XORed with bits 7-9, 7-8 or 7 of the
// address; no swizzle: 8 x 16-byte core matrices, K neighbours LBO apart
inline uint32_t emu_operand_offset(uint64_t desc, int r, int k) {
  const uint32_t start = static_cast<uint32_t>(desc & 0x3fff) << 4;
  const uint32_t lbo = static_cast<uint32_t>((desc >> 16) & 0x3fff) << 4;
  const uint32_t sbo = static_cast<uint32_t>((desc >> 32) & 0x3fff) << 4;
  const int layout = static_cast<int>(desc >> 62);
  if (layout == kInterleave)
    return start + (r / 8) * sbo + (k / 8) * lbo + (r % 8) * 16 + (k % 8) * 2;
  const uint32_t width = 256u >> layout, mask = width / 16 - 1;
  const uint32_t off = start + (r / 8) * sbo + (r % 8) * width + k * 2;
  return off ^ (((off >> 7) & mask) << 4);
}

inline float emu_smem_bf16(uint32_t off) {
  uint16_t v;
  std::memcpy(&v, smem + off, 2);
  return __bfloat162float(__ushort_as_bfloat16(v));
}

struct EmuOp {
  float* d;
  uint32_t a[4];
  uint64_t desc_a, desc_b;
  bool ss;
  int scale_d;
};

struct EmuQueue {
  std::vector<EmuOp> ops;       // issued, not yet run
  std::vector<size_t> groups;   // ops.size() at each commit
};
inline thread_local EmuQueue g_queue;
inline float g_wg_a[8][64][16];  // one warpgroup's A while a product runs

// One queued product, the warpgroup together
inline void emu_run(const EmuOp& op) {
  const int tid = threadIdx.x & 127, w = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  float(&sa)[64][16] = g_wg_a[threadIdx.x >> 7];
  if (!op.ss)
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * w + g + 8 * (e & 1), c = 8 * (e >> 1) + 2 * t;
      sa[r][c] = bf16x2_lo(op.a[e]);
      sa[r][c + 1] = bf16x2_hi(op.a[e]);
    }
  nfk_emu_wg_sync();
  float arow[2][16];
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * w + g + 8 * h;
    for (int k = 0; k < 16; ++k)
      arow[h][k] = op.ss ? emu_smem_bf16(emu_operand_offset(op.desc_a, r, k)) : sa[r][k];
  }
  for (int j = 0; j < kN / 8; ++j)
    for (int c = 0; c < 2; ++c) {
      float b[16];
      for (int k = 0; k < 16; ++k)
        b[k] = emu_smem_bf16(emu_operand_offset(op.desc_b, 8 * j + 2 * t + c, k));
      for (int h = 0; h < 2; ++h) {
        float& d = op.d[4 * j + 2 * h + c];
        float acc = op.scale_d ? d : 0.f;
        for (int k = 0; k < 16; ++k) acc = fmaf(arow[h][k], b[k], acc);
        d = acc;
      }
    }
  nfk_emu_wg_sync();
}

inline void mma_rs(float (&d)[kAccRegs], const uint32_t (&a)[4], uint64_t desc_b,
                   int scale_d) {
  g_queue.ops.push_back({d, {a[0], a[1], a[2], a[3]}, 0, desc_b, false, scale_d});
}

inline void mma_ss(float (&d)[kAccRegs], uint64_t desc_a, uint64_t desc_b, int scale_d) {
  g_queue.ops.push_back({d, {0, 0, 0, 0}, desc_a, desc_b, true, scale_d});
}

inline void fence() {}
inline void commit() { g_queue.groups.push_back(g_queue.ops.size()); }

template <int N>
inline void wait() {
  EmuQueue& q = g_queue;
  const int done = static_cast<int>(q.groups.size()) - N;
  if (done <= 0) return;
  const size_t upto = q.groups[done - 1];
  for (size_t i = 0; i < upto; ++i) emu_run(q.ops[i]);
  q.ops.erase(q.ops.begin(), q.ops.begin() + upto);
  q.groups.erase(q.groups.begin(), q.groups.begin() + done);
  for (size_t& n : q.groups) n -= upto;
}

template <int R>
inline void fence_operands(float (&)[R]) {}

// An mbarrier's 8 bytes: its phase's parity, the arrivals a phase expects,
// those still pending, and the transaction bytes still pending
struct EmuBar {
  uint32_t phase : 1, expected : 15, pending : 16;
  int32_t tx;
};
static_assert(sizeof(EmuBar) == 8, "an mbarrier is 8 bytes");
inline std::mutex g_bar_mu;

inline void emu_bar_update(uint64_t* bar, int arrivals, int tx) {
  std::lock_guard<std::mutex> lock(g_bar_mu);
  EmuBar b;
  std::memcpy(&b, bar, 8);
  b.pending -= arrivals;
  b.tx += tx;
  if (b.pending == 0 && b.tx == 0) {
    b.phase ^= 1;
    b.pending = b.expected;
  }
  std::memcpy(bar, &b, 8);
}

inline void mbar_init(uint64_t* bar, int count) {
  std::lock_guard<std::mutex> lock(g_bar_mu);
  EmuBar b;
  b.phase = 0;
  b.expected = count;
  b.pending = count;
  b.tx = 0;
  std::memcpy(bar, &b, 8);
}

inline void mbar_fence_init() { std::atomic_thread_fence(std::memory_order_seq_cst); }
inline void mbar_arrive_if(uint64_t* bar, bool pred) {
  if (pred) emu_bar_update(bar, 1, 0);
}
inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  emu_bar_update(bar, 1, static_cast<int>(bytes));
}

// Polls with a sleep, not a yield: hundreds of threads polling one lock
// starve the producer that would complete the phase
inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (;;) {
    EmuBar b;
    {
      std::lock_guard<std::mutex> lock(g_bar_mu);
      std::memcpy(&b, bar, 8);
    }
    if (b.phase != parity) return;
    std::this_thread::sleep_for(std::chrono::microseconds(20));
  }
}

inline void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  std::memcpy(dst, src, bytes);
  emu_bar_update(bar, 0, -static_cast<int>(bytes));
}

inline void fence_proxy_async() { std::atomic_thread_fence(std::memory_order_seq_cst); }
template <int R>
inline void setmaxnreg_inc() {}
template <int R>
inline void setmaxnreg_dec() {}

#endif  // NFK_EMU

}  // namespace wg
}  // namespace nfk
