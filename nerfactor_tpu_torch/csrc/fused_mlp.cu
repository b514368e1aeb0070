// Kernels K1-fwd and K1-bwd: the fused posenc -> skip-MLP -> head chain.
//
// K1-fwd replaces the TPU kernel nerfactor_tpu/ops/pallas_mlp.py
// _pallas_forward_trig_t -> _fwd_kernel_trig_t: per row,
// head(MLP(posenc(x))) with ReLU hidden layers, the embedding concatenated
// after the layers in skip_after, and a sigmoid/softplus/linear head.
//
// K1-bwd replaces _pallas_backward_trig_t -> _bwd_kernel_trig_t (with
// _bwd_layers_trig_t): it recomputes each tile's forward, then returns
// the optional input cotangent dx and the optional dW/db (f32). It does
// about twice the forward's multiply-adds on top of the recompute (dW and
// d_h per layer), so it is bound by arithmetic like the forward.
// Determinism: CUDA blocks run in no fixed order, so there is no float
// atomicAdd into dW. The grid is fixed (the SM count times the blocks an
// SM holds); block b walks row tiles b, b + grid, ... in order and
// accumulates into its own slice of a scratch buffer, and a second kernel
// sums the slices in slice order. The same input gives bit-identical
// dW/db on the same card. The lvis chain's 72k weights x 132 slices are
// ~38 MB, which stays in the 50 MB L2.
//
// What bounds it on Hopper: arithmetic. At full width (128 x 4, skip after
// layer 2) the lvis chain does ~72k multiply-adds per row but reads 24 B
// and writes 4 B, far above the card's operations-per-byte ridge. So the
// design keeps everything between the input row and the output row on the
// chip (chain_mlp.cuh): a block owns 64 rows, their embedding and hidden
// activations live in shared memory, and the weights stream through a
// 32 x 128 shared-memory tile layer by layer, since the whole chain's
// weights (~290 KB in f32) exceed a block's 227 KB. Products run on the
// CUDA cores in f32 from f32 or bf16 operands; tensor cores (wgmma) and
// TMA are left for later work.
//
// The same two kernels in two more modes replace the TPU package's other
// chain kernels:
//   * K1r-fwd / K1r-bwd, the stash route (pallas_mlp.py _pallas_forward_trig
//     -> _fwd_kernel_trig, _pallas_backward_trig -> _bwd_kernel_trig): the
//     embedding's trig columns are sin(2^j x + phase), phase 0 or pi/2 in
//     f32; under autograd the forward writes them (at the operand type) to
//     a (n, trig_dim) stash that the backward reads instead of recomputing
//     sin/cos, and dx uses cos of the recomputed phase. The stash adds
//     2 * trig_dim bytes a row each way (bf16) to a kernel bound by
//     arithmetic.
//   * K1w-fwd / K1w-bwd, plans with a skip after the last layer
//     (pallas_mlp.py _pallas_forward -> _fwd_kernel, _pallas_backward ->
//     _bwd_kernel): the output row is [head | embedding], and the backward
//     seeds the embedding's cotangent from dy's trailing columns.
//
// Inputs: x (n, raw_dim) f32 row-major; weights packed in JAX layout
// (w is (din, dout), applied as x @ w), biases f32. Output y (n, out_dim)
// f32.

#include "chain_mlp.cuh"

namespace nfk {

template <typename T>
__global__ void __launch_bounds__(kThreads)
chain_fwd_kernel(ChainDesc d, int phase, const float* __restrict__ x, const T* __restrict__ w,
                 const float* __restrict__ bias, float* __restrict__ y, T* __restrict__ stash,
                 long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  float* xs = reinterpret_cast<float*>(smem + smem_layout<T>(d).xs);
  for (int idx = threadIdx.x; idx < kRows * d.raw_dim; idx += kThreads) {
    const long long r = row0 + idx / d.raw_dim;
    xs[idx] = r < n ? x[r * d.raw_dim + idx % d.raw_dim] : 0.f;
  }
  __syncthreads();
  chain_tile<T>(d, w, bias, smem, y, row0, n, phase ? kPhase : kSincos, stash);
}

__global__ void sum_slices_kernel(const float* __restrict__ part, int slices,
                                  long long stride, float* __restrict__ out) {
  for (long long j = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < stride; j += static_cast<long long>(gridDim.x) * blockDim.x) {
    float s = 0.f;
    for (int b = 0; b < slices; ++b) s += part[b * stride + j];
    out[j] = s;
  }
}

int sum_slices(const float* part, int slices, long long stride, float* out,
               cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = (stride + kThreads - 1) / kThreads;
  const long long cap = 8LL * sms;  // a grid-stride loop over at most 8 blocks an SM
  sum_slices_kernel<<<static_cast<unsigned>(blocks < cap ? blocks : cap), kThreads, 0,
                      stream>>>(part, slices, stride, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
chain_bwd_kernel(ChainDesc d, int phase, int needs_dx, int needs_dw, const float* __restrict__ x,
                 const float* __restrict__ dy, const T* __restrict__ stash,
                 const T* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ dx, float* __restrict__ dwb_part, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L = bwd_layout<T, ROWS>(d, needs_dx);
  const long long w_total = total_weights(d);
  const long long stride = w_total + total_biases(d);
  float* dw_slice = needs_dw ? dwb_part + blockIdx.x * stride : nullptr;
  if (needs_dw)
    for (long long j = threadIdx.x; j < stride; j += kThreads) dw_slice[j] = 0.f;
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* da = reinterpret_cast<float*>(smem + L.da);
  float* de = reinterpret_cast<float*>(smem + L.de);
  const int n_out = d.widths[d.n_layers - 1], ldy = out_dim(d);
  const bool seed_e = last_skip(d);
  const long long n_tiles = (n + ROWS - 1) / ROWS;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * ROWS;
    for (int idx = threadIdx.x; idx < ROWS * d.raw_dim; idx += kThreads) {
      const long long r = row0 + idx / d.raw_dim;
      xs[idx] = r < n ? x[r * d.raw_dim + idx % d.raw_dim] : 0.f;
    }
    // Padding rows get a zero cotangent, so they add nothing to dW/db
    for (int idx = threadIdx.x; idx < ROWS * n_out; idx += kThreads) {
      const int r = idx / n_out, c = idx % n_out;
      da[r * L.ldd + c] = row0 + r < n ? dy[(row0 + r) * ldy + c] : 0.f;
    }
    // The embedding's own cotangent: a last-skip plan's output carries the
    // embedding in its trailing columns (only dx depends on it)
    if (needs_dx)
      for (int idx = threadIdx.x; idx < ROWS * L.lde; idx += kThreads) {
        const int r = idx / L.lde, c = idx % L.lde;
        de[idx] = seed_e && c < d.embed_dim && row0 + r < n
                      ? dy[(row0 + r) * ldy + n_out + c] : 0.f;
      }
    __syncthreads();
    chain_tile_bwd<T, ROWS>(d, needs_dx, needs_dw, w, bias, smem, dw_slice,
                            needs_dw ? dw_slice + w_total : nullptr, stash, row0, n);
    if (needs_dx)
      embed_bwd<ROWS>(d, xs, de, L.lde, dx + row0 * d.raw_dim, n - row0, phase != 0);
    __syncthreads();
  }
}

// Slices of the dW scratch: the blocks the card holds at once, at most
// one per row tile.
template <typename T, int ROWS>
int chain_bwd_slices(const ChainDesc& d, int needs_dx, long long n, int* slices) {
  return dw_slices(chain_bwd_kernel<T, ROWS>, bwd_layout<T, ROWS>(d, needs_dx != 0).total,
                   (n + ROWS - 1) / ROWS, slices);
}

template <typename T, int ROWS>
int chain_bwd(const ChainDesc& d, int phase, int needs_dx, int needs_dw, const float* x,
              const float* dy, const T* stash, const T* w, const float* bias, float* dx,
              float* dwb_part, float* dwb, int slices, long long n, cudaStream_t stream) {
  const size_t smem = bwd_layout<T, ROWS>(d, needs_dx != 0).total;
  const long long tiles = (n + ROWS - 1) / ROWS;
  const long long blocks = needs_dw ? slices : tiles;
  if (blocks < 1) return kErrBadPlan;
  int err = launch_with_smem(chain_bwd_kernel<T, ROWS>, smem, blocks, stream, d, phase,
                             needs_dx, needs_dw, x, dy, stash, w, bias, dx, dwb_part, n);
  if (err || !needs_dw) return err;
  return sum_slices(dwb_part, slices, total_weights(d) + total_biases(d), dwb, stream);
}

template <typename T>
int chain_bwd_dispatch(const ChainDesc& d, int phase, int needs_dx, int needs_dw,
                       const float* x, const float* dy, const void* stash, const void* w,
                       const float* bias, float* dx, float* dwb_part, float* dwb, int slices,
                       long long n, cudaStream_t stream) {
  const T* st = static_cast<const T*>(stash);
  const T* wt = static_cast<const T*>(w);
  switch (bwd_rows<T>(d, needs_dx != 0, max_smem_optin())) {
    case 64:
      return chain_bwd<T, 64>(d, phase, needs_dx, needs_dw, x, dy, st, wt, bias, dx, dwb_part,
                              dwb, slices, n, stream);
    case 32:
      return chain_bwd<T, 32>(d, phase, needs_dx, needs_dw, x, dy, st, wt, bias, dx, dwb_part,
                              dwb, slices, n, stream);
    case 16:
      return chain_bwd<T, 16>(d, phase, needs_dx, needs_dw, x, dy, st, wt, bias, dx, dwb_part,
                              dwb, slices, n, stream);
    default:
      return kErrSmem;
  }
}

template <typename T>
int chain_bwd_slices_dispatch(const ChainDesc& d, int needs_dx, long long n, int* slices) {
  switch (bwd_rows<T>(d, needs_dx != 0, max_smem_optin())) {
    case 64: return chain_bwd_slices<T, 64>(d, needs_dx, n, slices);
    case 32: return chain_bwd_slices<T, 32>(d, needs_dx, n, slices);
    case 16: return chain_bwd_slices<T, 16>(d, needs_dx, n, slices);
    default: return kErrSmem;
  }
}

}  // namespace nfk

extern "C" {

const char* nfk_error_string(int code) {
  if (code == nfk::kErrBadPlan) return "chain plan not supported by the kernel";
  if (code == nfk::kErrSmem) return "chain needs more shared memory than a block has";
  if (code == nfk::kErrBadArgs) return "arguments not supported by the kernel";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bf16 != 0 selects bf16 operands (w must then hold bf16 values). phase
// != 0 selects the stash route's embedding (K1r-fwd); a non-null stash
// (n, trig_dim) of the operand type then receives its trig columns. y is
// (n, out_dim): [head | embedding] for a last-skip plan (K1w-fwd).
int nfk_chain_fwd(const nfk::ChainDesc* desc, int bf16, int phase, const float* x,
                  const void* w, const float* bias, float* y, void* stash, long long n,
                  void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (stash != nullptr && (!phase || nfk::last_skip(*desc))) return nfk::kErrBadPlan;
  if (bf16)
    return nfk::launch_tiles<__nv_bfloat16>(
        nfk::chain_fwd_kernel<__nv_bfloat16>, *desc, n, s, phase, x,
        static_cast<const __nv_bfloat16*>(w), bias, y, static_cast<__nv_bfloat16*>(stash));
  return nfk::launch_tiles<float>(nfk::chain_fwd_kernel<float>, *desc, n, s, phase, x,
                                  static_cast<const float*>(w), bias, y,
                                  static_cast<float*>(stash));
}

// Number of dW scratch slices nfk_chain_bwd uses for n rows (the wrapper
// allocates slices x (weights + biases) floats).
int nfk_chain_bwd_slices(const nfk::ChainDesc* desc, int bf16, int needs_dx, long long n,
                         int* slices) {
  if (int err = nfk::check_desc(*desc)) return err;
  *slices = 0;
  if (n <= 0) return 0;
  if (bf16) return nfk::chain_bwd_slices_dispatch<__nv_bfloat16>(*desc, needs_dx, n, slices);
  return nfk::chain_bwd_slices_dispatch<float>(*desc, needs_dx, n, slices);
}

// K1-bwd. dx (n, raw_dim) is written when needs_dx; with needs_dw the
// weight and bias cotangents land in dwb (packed like w then bias, f32),
// summed from dwb_part (slices x stride floats of scratch). dy is (n,
// out_dim). phase != 0 is the stash route (K1r-bwd): the trig columns come
// from `stash` (n, trig_dim), which a plan with trig columns must give.
int nfk_chain_bwd(const nfk::ChainDesc* desc, int bf16, int phase, int needs_dx,
                  int needs_dw, const float* x, const float* dy, const void* stash,
                  const void* w, const float* bias, float* dx, float* dwb_part, float* dwb,
                  int slices, long long n, void* stream) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (phase ? nfk::last_skip(*desc) || (stash == nullptr && nfk::trig_dim(*desc) > 0)
            : stash != nullptr)
    return nfk::kErrBadPlan;
  if (n <= 0 || (!needs_dx && !needs_dw)) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return nfk::chain_bwd_dispatch<__nv_bfloat16>(*desc, phase, needs_dx, needs_dw, x, dy,
                                                  stash, w, bias, dx, dwb_part, dwb, slices,
                                                  n, s);
  return nfk::chain_bwd_dispatch<float>(*desc, phase, needs_dx, needs_dw, x, dy, stash, w,
                                        bias, dx, dwb_part, dwb, slices, n, s);
}

}  // extern "C"
