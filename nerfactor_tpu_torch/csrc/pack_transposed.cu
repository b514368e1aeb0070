// The transposed hidden weights of the tensor-core chain kernels (K1, K1r,
// K1w in fused_mlp.cu and chain_f32_tc.cu; K2 in fused_rusink.cu) and the
// transposed dense weights of the NeRF field's (K3 in fused_nerf.cu),
// packed on the card in one launch.
//
// It replaces no TPU kernel: the Pallas kernels read W as it is, and the
// tensor-core kernels here stream each hidden layer's W^T through their
// ring (chain_tc.cuh, tc_gemm's Bt). The wrapper used to build that buffer
// on the host side of PyTorch at every launch (ops/fused_mlp.py
// pack_transposed: a zeroed buffer and one or two strided copies a layer,
// ~0.2 ms of host time on an H100 machine for a 128 x 4 chain, more than
// the f32 kernels' whole run at a training step's 2,048 rows).
// pack_transposed stays as this kernel's plain version, for the CPU and
// as its oracle. One thread an element of the output, in the output's
// order: each layer of the table (chain_dw_table(d), or K3's
// nerf_dw_table) is (n, round16(k1) +
// round16(k2)), row j its unit j's weights [W[0..k1), j | 0 ... |
// W[k1..k1 + k2), j | 0 ...], read from the packed weights (JAX layout:
// W is (k1 + k2, n) row-major at w_off). A copy, so the bits are the
// packed weights' (bf16 or f32); the pads are +0. Bound by bytes (the
// reads are strided by n, ~0.3 MB at 128 x 4 in f32) and, at these sizes,
// by the launch itself.

#include "chain_mlp.cuh"
#include "chain_tc.cuh"
#include "mma_bf16.cuh"

namespace nfk {

template <typename T>
__global__ void __launch_bounds__(kThreads)
pack_transposed_kernel(DwTable tab, const T* __restrict__ w, T* __restrict__ wt,
                       long long total) {
  for (long long e = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; e < total;
       e += static_cast<long long>(gridDim.x) * kThreads) {
    long long off = 0;
    int li = 0;
    for (; li < tab.n_layers - 1; ++li) {
      const DenseLayer& l = tab.layers[li];
      const long long size = static_cast<long long>(l.n) * (round16(l.k1) + round16(l.k2));
      if (e < off + size) break;
      off += size;
    }
    const DenseLayer& l = tab.layers[li];
    const int k16 = round16(l.k1), kw = k16 + round16(l.k2);
    const long long i = e - off;
    const int r = static_cast<int>(i / kw), j = static_cast<int>(i % kw);
    const int src = j < l.k1 ? j : (j >= k16 && j - k16 < l.k2 ? l.k1 + j - k16 : -1);
    wt[e] = src >= 0 ? w[l.w_off + static_cast<long long>(src) * l.n + r] : from_f<T>(0.f);
  }
}

template <typename T>
int pack_transposed(const DwTable& tab, long long total, const T* w, T* wt,
                    cudaStream_t stream) {
  if (total <= 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  return launch_with_smem(pack_transposed_kernel<T>, 0, blocks < 1024 ? blocks : 1024, stream,
                          tab, w, wt, total);
}

template <typename T>
int pack_transposed(const ChainDesc& d, const T* w, T* wt, cudaStream_t stream) {
  return pack_transposed(chain_dw_table(d), chain_wt_offset(d, d.n_layers - 1), w, wt, stream);
}

// The values of a table's transposed weights: its layers' n x (round16(k1)
// + round16(k2)), one after another
inline long long table_wt_values(const DwTable& tab) {
  long long total = 0;
  for (int i = 0; i < tab.n_layers; ++i)
    total += static_cast<long long>(tab.layers[i].n) *
             (round16(tab.layers[i].k1) + round16(tab.layers[i].k2));
  return total;
}

}  // namespace nfk

extern "C" {

// The transposed hidden weights wt (nfk_chain_bwd_tc_sizes' `wt` values,
// laid out as the tensor-core chain kernels read them) of the packed
// weights w, bf16 (bf16 != 0) or f32, for a plan the tensor-core chain
// kernels take (chain_tc_plan). One launch.
int nfk_pack_transposed(const nfk::ChainDesc* desc, int bf16, const void* w, void* wt,
                        void* stream) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (!nfk::chain_tc_plan(*desc)) return nfk::kErrBadPlan;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return nfk::pack_transposed(*desc, static_cast<const __nv_bfloat16*>(w),
                                static_cast<__nv_bfloat16*>(wt), s);
  return nfk::pack_transposed(*desc, static_cast<const float*>(w), static_cast<float*>(wt), s);
}

// The same for the dense layers of a table (nfk_nerf_dw_table's: the NeRF
// field's trunk, bottleneck and first rgb layer, whose packed weights w
// are the field's dense weights), the layout nfk_nerf_bwd_sizes' `wt`
// counts. One launch.
int nfk_pack_transposed_table(const nfk::DwTable* tab, int bf16, const void* w, void* wt,
                              void* stream) {
  if (tab->n_layers < 1 || tab->n_layers > nfk::kMaxDense) return nfk::kErrBadArgs;
  const long long total = nfk::table_wt_values(*tab);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return nfk::pack_transposed(*tab, total, static_cast<const __nv_bfloat16*>(w),
                                static_cast<__nv_bfloat16*>(wt), s);
  return nfk::pack_transposed(*tab, total, static_cast<const float*>(w), static_cast<float*>(wt),
                              s);
}

}  // extern "C"
