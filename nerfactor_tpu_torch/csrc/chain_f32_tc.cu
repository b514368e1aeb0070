// K1 in f32 on the tensor cores: K1-fwd and K1-bwd with dx only in split
// TF32 ("3xTF32"), K1's route alone (no stash, no skip after the head).
//
// chain_fwd_f32_tc_kernel replaces, for f32, the TPU kernel
// nerfactor_tpu/ops/pallas_mlp.py _pallas_forward_trig_t ->
// _fwd_kernel_trig_t; chain_dx_f32_tc_kernel, for f32 with needs_dw
// False, _pallas_backward_trig_t -> _bwd_kernel_trig_t (fused_mlp.cu's
// header describes both designs beside the bf16 and CUDA-core ones; the
// rules that pick them are ops/fused_mlp.py fwd_on_tensor_cores and
// bwd_on_tensor_cores). Both are the bf16 kernels' shared tiles
// (chain_tc.cuh: chain_fwd_tc_tile, chain_tile_dx_tc) at the product
// policy MmaTf32x3 (mma_bf16.cuh): f32 operands in shared memory, each
// split on load into TF32 hi and lo, each m16n8k8 step's products lo hi +
// hi lo + hi hi summed in a fresh accumulator that the CUDA cores add into
// the f32 one. What bounds them on an H100 is the tensor cores' TF32 rate
// three times over, the split and the adds on the CUDA cores, the weight
// ring's barrier every 16 K, and one block (8 warps) an SM (~143 KB of
// shared memory for the forward, ~175 KB for the dx tile at the sigma
// chain's 8 x 256): the products need a third of the time the card takes.
// The same kernels at MmaTf32x1 (hi hi alone: plain TF32) are the control
// their limits are held against (`terms` 1 of the entries). Compiled in
// their own source, so that nvcc builds them beside fused_mlp.cu.

#include "chain_mlp.cuh"
#include "chain_tc.cuh"
#include "mma_bf16.cuh"

namespace nfk {

// K1-fwd in f32: K1-fwd's tensor-core tile at policy P (MmaTf32x3; the
// control MmaTf32x1), f32 operands in shared memory, a block a 64-row
// tile. One block an SM (~143 KB at the sigma chain's width), so the
// launch bounds leave the registers to the split fragments.
template <typename P, bool kTwoBuffers>
__global__ void __launch_bounds__(kThreads, 1)
chain_fwd_f32_tc_kernel(ChainDesc d, const float* __restrict__ x, const float* __restrict__ w,
                        const float* __restrict__ wt, const float* __restrict__ bias,
                        float* __restrict__ y, long long n) {
  chain_fwd_tc_block<kTwoBuffers, EmbedSincos, false, P>(d, x, w, wt, bias, y, n, EmbedSincos{});
}

// K1-bwd in f32 with dx only (frozen weights): block blockIdx.x's 64-row
// tile, its raw rows, the head's cotangent rows (zero past n) and a zero
// embedding cotangent, then chain_tile_dx_tc at policy P (the recompute
// keeping each ReLU post's sign, the tiny head and the last hidden layer's
// d_pre in f32 on the CUDA cores, d_pre @ W^T of every hidden layer on the
// tensor cores) and the embedding's VJP (embed_bwd) into dx. No scratch,
// no dW, no slices: one launch.
template <typename P, bool kTwoBuffers>
__global__ void __launch_bounds__(kThreads, 1)
chain_dx_f32_tc_kernel(ChainDesc d, const float* __restrict__ x, const float* __restrict__ dy,
                       const float* __restrict__ w, const float* __restrict__ wt,
                       const float* __restrict__ bias, float* __restrict__ dx, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = tc::kTcRows;
  const ChainDxLayout L = chain_dx_layout<P>(d);
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int no = d.widths[d.n_layers - 1];
  float* xs = reinterpret_cast<float*>(smem + L.t.xs);
  float* dq = reinterpret_cast<float*>(smem + L.t.dq);
  float* de = reinterpret_cast<float*>(smem + L.de);
  for (int idx = threadIdx.x; idx < R * d.raw_dim; idx += kThreads) {
    const long long r = row0 + idx / d.raw_dim;
    xs[idx] = r < n ? x[r * d.raw_dim + idx % d.raw_dim] : 0.f;
  }
  for (int idx = threadIdx.x; idx < R * no; idx += kThreads) {
    const long long r = row0 + idx / no;
    dq[idx] = r < n ? dy[r * no + idx % no] : 0.f;
  }
  for (int idx = threadIdx.x; idx < R * L.ldde; idx += kThreads) de[idx] = 0.f;
  __syncthreads();
  chain_tile_dx_tc<kTwoBuffers, P>(d, w, wt, bias, smem);
  embed_bwd<R>(d, xs, de, L.ldde, dx + row0 * d.raw_dim, n - row0);
}

// The f32 building block alone: c (m x n, f32) = a (m x k, f32 row-major)
// @ bt^T, bt (n x round16(k), f32, zero past k), through tc_gemm at policy
// P (the split and the m16n8k8 fragments of the f32 kernels), a block a
// 64-row tile of a.
template <typename P>
__global__ void __launch_bounds__(kThreads, 1)
tc_matmul_f32_kernel(const float* __restrict__ a, const float* __restrict__ bt,
                     float* __restrict__ c, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = tc::kTcRows;
  const int k16 = round16(k), lda = tc::tc_ld<float>(k);
  float* as = reinterpret_cast<float*>(smem);
  float* ws = as + R * lda;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  for (int idx = threadIdx.x; idx < R * k16; idx += kThreads) {
    const int r = idx / k16, j = idx % k16;
    as[r * lda + j] = row0 + r < m && j < k ? a[(row0 + r) * k + j] : 0.f;
  }
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  tc::tc_gemm<P>(tc::TcAOf<float>{as, lda, k16, nullptr, 0, 0}, bt, k16, n, ws,
                 [&](int c0, const float (&v)[tc::kTcM][4]) {
                   for (int i = 0; i < tc::kTcM; ++i)
                     for (int e = 0; e < 4; ++e) {
                       const long long r = row0 + 16 * i + g + 8 * (e >> 1);
                       const int col = c0 + 2 * t + (e & 1);
                       if (r < m && col < n) c[r * n + col] = v[i][e];
                     }
                 });
}

template <typename P>
int tc_matmul_f32(const float* a, const float* bt, float* c, int m, int n, int k,
                  cudaStream_t stream) {
  const size_t smem = align16(sizeof(float) * tc::kTcRows * tc::tc_ld<float>(k)) +
                      tc::Ring<P>::kBytes;
  if (smem > static_cast<size_t>(max_smem_optin())) return kErrSmem;
  return launch_with_smem(tc_matmul_f32_kernel<P>, smem, (m + tc::kTcRows - 1) / tc::kTcRows,
                          stream, a, bt, c, m, n, k);
}

// Whether the f32 tensor-core forward (dx false) or dx-only backward runs
// the plan: not a last-skip plan (K1's route alone), and check_chain_tc's
// or check_chain_dx_tc's plans at MmaTf32x3.
inline int check_chain_f32_tc(const ChainDesc& d, bool dx) {
  if (last_skip(d)) return kErrBadPlan;
  return dx ? check_chain_dx_tc<tc::MmaTf32x3>(d) : check_chain_tc<tc::MmaTf32x3>(d, false);
}

// f32 K1-fwd (dx false) or K1-bwd with dx only on the tensor cores, the
// products as `terms` (3: split TF32; 1: plain TF32, the control) give
// them: one block a 64-row tile.
template <typename P>
int chain_f32_tc(const ChainDesc& d, bool dx_only, const float* x, const float* dy,
                 const float* w, const float* wt, const float* bias, float* out, long long n,
                 cudaStream_t stream) {
  const long long blocks = (n + tc::kTcRows - 1) / tc::kTcRows;
  const bool two = d.max_width > tc::kTcCols;
  if (dx_only)
    return launch_with_smem(
        two ? chain_dx_f32_tc_kernel<P, true> : chain_dx_f32_tc_kernel<P, false>,
        chain_dx_layout<P>(d).total, blocks, stream, d, x, dy, w, wt, bias, out, n);
  return launch_with_smem(
      two ? chain_fwd_f32_tc_kernel<P, true> : chain_fwd_f32_tc_kernel<P, false>,
      chain_tc_layout<P>(d, false).total, blocks, stream, d, x, w, wt, bias, out, n);
}

inline int chain_f32_tc_terms(const ChainDesc& d, bool dx_only, const float* x, const float* dy,
                              const float* w, const float* wt, const float* bias, float* out,
                              int terms, long long n, cudaStream_t stream) {
  if (int err = check_desc(d)) return err;
  if (int err = check_chain_f32_tc(d, dx_only)) return err;
  if (terms != 1 && terms != 3) return kErrBadArgs;
  if (n <= 0) return 0;
  return terms == 3 ? chain_f32_tc<tc::MmaTf32x3>(d, dx_only, x, dy, w, wt, bias, out, n, stream)
                    : chain_f32_tc<tc::MmaTf32x1>(d, dx_only, x, dy, w, wt, bias, out, n, stream);
}

}  // namespace nfk

extern "C" {

// Whether nfk_chain_fwd_tc_f32 (dx 0) or nfk_chain_bwd_dx_tc_f32 (dx != 0)
// runs the plan (*runs = 1): no skip after the head, chain_tc_plan's
// plans whose f32 block fits the card's shared memory, and for the
// backward every hidden act ReLU. The wrapper's rules (ops/fused_mlp.py
// fwd_on_tensor_cores, bwd_on_tensor_cores) ask it for f32 K1 launches.
int nfk_chain_f32_tc_runs(const nfk::ChainDesc* desc, int dx, int* runs) {
  if (int err = nfk::check_desc(*desc)) return err;
  *runs = nfk::check_chain_f32_tc(*desc, dx != 0) == 0;
  return 0;
}

// K1-fwd in f32 on the tensor cores: y (n, out_dim) f32 from x. w holds
// the f32 weights (the head's are read), wt each hidden layer's transpose
// in f32, laid out as nfk_chain_fwd_tc's bf16 ones. terms 3: split TF32
// (hi hi + hi lo + lo hi); 1: plain TF32 (hi hi), the control.
int nfk_chain_fwd_tc_f32(const nfk::ChainDesc* desc, const float* x, const float* w,
                         const float* wt, const float* bias, float* y, int terms, long long n,
                         void* stream) {
  return nfk::chain_f32_tc_terms(*desc, false, x, nullptr, w, wt, bias, y, terms, n,
                                 static_cast<cudaStream_t>(stream));
}

// K1-bwd in f32 with dx only on the tensor cores (frozen weights): dx (n,
// raw_dim) f32 for dy (n, out_dim); w, wt and terms as
// nfk_chain_fwd_tc_f32 takes them. One launch, no scratch.
int nfk_chain_bwd_dx_tc_f32(const nfk::ChainDesc* desc, const float* x, const float* dy,
                            const float* w, const float* wt, const float* bias, float* dx,
                            int terms, long long n, void* stream) {
  return nfk::chain_f32_tc_terms(*desc, true, x, dy, w, wt, bias, dx, terms, n,
                                 static_cast<cudaStream_t>(stream));
}

// The f32 tensor-core building block alone: c (m x n f32) = a (m x k f32)
// @ bt^T, bt (n x round16(k) f32, zero past k), with `terms` TF32
// products (3: split TF32; 1: plain TF32), through the split, fragments
// and pipeline of the f32 K1 kernels.
int nfk_tc_matmul_f32(const float* a, const float* bt, float* c, int m, int n, int k, int terms,
                      void* stream) {
  if (m < 0 || n < 1 || k < 1 || (terms != 1 && terms != 3)) return nfk::kErrBadArgs;
  if (m == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return terms == 3 ? nfk::tc_matmul_f32<nfk::tc::MmaTf32x3>(a, bt, c, m, n, k, s)
                    : nfk::tc_matmul_f32<nfk::tc::MmaTf32x1>(a, bt, c, m, n, k, s);
}

}  // extern "C"
