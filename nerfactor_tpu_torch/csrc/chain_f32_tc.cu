// K1 in f32 on the tensor cores, split TF32 ("3xTF32"), K1's route alone
// (no stash, no skip after the head): K1-fwd, K1-bwd with dx only and
// K1-bwd with dW only.
//
// chain_fwd_f32_tc_kernel replaces, for f32, the TPU kernel
// nerfactor_tpu/ops/pallas_mlp.py _pallas_forward_trig_t ->
// _fwd_kernel_trig_t; chain_dx_f32_tc_kernel (needs_dw False) and
// chain_bwd_f32_tc_kernel + dw_f32_kernel (needs_dx False) replace
// _pallas_backward_trig_t -> _bwd_kernel_trig_t (fused_mlp.cu's header
// describes the designs beside the bf16 and CUDA-core ones; the rules that
// pick them are ops/fused_mlp.py fwd_on_tensor_cores and
// bwd_on_tensor_cores). All run the product policy MmaTf32x3
// (mma_bf16.cuh): f32 operands in shared memory, each split on load into
// TF32 hi and lo, each m16n8k8 step's products lo hi + hi lo + hi hi
// summed in a fresh accumulator that the CUDA cores add into the f32 one.
//
// The forward and the dx tile are the bf16 kernels' shared tiles
// (chain_tc.cuh: chain_fwd_tc_tile, chain_tile_dx_tc) at that policy. What
// bounds them on an H100 is the tensor cores' TF32 rate three times over,
// the split and the adds on the CUDA cores, the weight ring's barrier
// every 16 K, and one block (8 warps) an SM (~143 KB of shared memory for
// the forward, ~175 KB for the dx tile at the sigma chain's 8 x 256).
//
// The backward with dW (the training heads: 128 x 4 at 2,048 rows, ~0.8
// GFLOP in split TF32 against a bound of 0.011 ms) is bound by latency
// and by how few blocks it has, not by the tensor cores' rate. Its design:
//   * Phase 1, chain_bwd_f32_tc_kernel, persistent blocks over 64-row
//     tiles (one block an SM, ~114 KB at 128 x 4): the recompute is the
//     forward's own loop, chain_hidden_tc at the forward's policy, so each
//     post, and each ReLU's gate, is the forward's bit for bit (a
//     recompute on other code gated some rows the other way from the
//     output); it stores the embedding and the posts that feed a later
//     layer to an f32 scratch (kTcRows rows of chain_cols a tile, ~3.8 KB
//     a row at 128 x 4); the head's d_pre, db and dW and the last hidden
//     layer's d_pre in f32 on the CUDA cores; d_pre @ W^T of every hidden
//     layer but the first on the tensor cores, each epilogue writing the
//     next d_pre to the scratch and its column sums into db.
//   * The dW pass, dw_f32_kernel: X^T D of every hidden layer over the
//     scratch in 64 x 64 dW tiles x up to 8 row chunks, the same split
//     and accumulator. With several chunks each writes a partial, and the
//     chunk that finishes last (an integer counter a tile, which phase 1
//     zeroes) adds the partials in chunk order; the grid's last blocks add
//     phase 1's slices (head dW and every db) in slice order. No float
//     atomicAdd: dW/db are bit-identical across launches.
//   Filling the card: at 2,048 rows phase 1 has 32 blocks in flight (one
//   a tile, each running the chain's 7 products back to back), the dW pass
//   16 tiles x 8 chunks + 4 blocks of sums = 132. Two launches a backward,
//   no sum_slices, no fill of the output (every value is written).
//   Scratch: the wrapper allocates it a launch (31 MB at 8,192 rows of
//   128 x 4). Past F32_DW_TC_MAX_ROWS rows (8,192: from there split TF32
//   gates a ReLU whose pre-activation lies within rounding of 0 the other
//   way from f32 often enough to move dW/db past the f32 limit) the rule
//   keeps the CUDA-core kernel, which needs no scratch.
//
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

// ------ K1-bwd in f32 with dW only: phase 1 and the dW pass ------

// A d_pre @ W^T product's epilogue in the f32 phase 1 (every hidden act
// ReLU), which makes the previous layer's d_pre: u = v where that layer's
// post, read back from the tile's scratch column post + c, is above 0,
// else 0; u into the tile's buffer (ld ldo) and the scratch column dcol +
// c; db += the column sums of u (each column is one warp's: in-lane over
// its 8 rows, then across the 8 lanes of its t, in a fixed order, as
// dpre_epilogue's).
__device__ inline void dpre_epilogue_f32(int c0, const float (&v)[tc::kTcM][4], float* st,
                                         int total, int post, int dcol, float* out, int ldo,
                                         float* db) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int m = 0; m < tc::kTcM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * m + g + 8 * (e >> 1), c = c0 + 2 * t + (e & 1);
      const float u = st[r * total + post + c] > 0.f ? v[m][e] : 0.f;
      s[e & 1] += u;
      out[r * ldo + c] = u;
      st[r * total + dcol + c] = u;
    }
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int off = 4; off < 32; off *= 2) s[e] += __shfl_xor_sync(0xffffffffu, s[e], off);
  if (g == 0) {
    db[c0 + 2 * t] += s[0];
    db[c0 + 2 * t + 1] += s[1];
  }
}

// Phase 1 for one 64-row tile whose raw rows and head cotangent rows are
// in shared memory (chain_tc_layout<P>(d, true)), in f32: the forward
// recompute through chain_hidden_tc at policy P, the f32 forward's own
// loop (so each post, and each ReLU's gate, is the forward's bit for bit),
// which also writes the embedding and the posts that feed a later hidden
// layer to the tile's scratch `st` (kTcRows rows of chain_cols(d).total
// floats); the tiny head's forward, d_pre, db and dW and the last hidden
// layer's d_pre in f32 on the CUDA cores; then d_pre @ W^T of every hidden
// layer but the first on the tensor cores (dpre_epilogue_f32), each d_pre
// to the scratch. The head's dW and every db add into `gaux`
// (chain_n_aux floats: [head dW | biases]). Ends at a barrier.
template <bool kTwoBuffers, typename P>
__device__ void chain_tile_bwd_f32_tc(const ChainDesc& d, const float* __restrict__ w,
                                      const float* __restrict__ wt,
                                      const float* __restrict__ bias, unsigned char* smem,
                                      float* st, float* gaux) {
  constexpr int R = tc::kTcRows;
  const ChainTcLayout L = chain_tc_layout<P>(d, true);
  const ChainCols cols = chain_cols(d);
  float* dq = reinterpret_cast<float*>(smem + L.dq);
  float* h = chain_hidden_tc<kTwoBuffers, true, false, EmbedSincos, P>(
      d, L, cols, wt, bias, smem, reinterpret_cast<uint32_t*>(st));
  // h holds the latest result; each product writes ho, then the two swap.
  // With one buffer ho is h, fixed
  float* ho = h;
  if (kTwoBuffers)
    ho = reinterpret_cast<float*>(smem +
                                  (h == reinterpret_cast<float*>(smem + L.h) ? L.h2 : L.h));
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  const int nh = d.n_layers - 1, ldh = L.ldh, total = cols.total;
  __syncthreads();
  // The head: its forward from the last post (the forward's head_sums),
  // its d_pre in place of dy
  const int no = d.widths[nh], kl = d.widths[nh - 1], act_h = d.acts[nh];
  const float* wh = w + d.w_off[nh];  // (kl, no) row-major
  const float* bh = bias + d.b_off[nh];
  float* dbias = gaux + (total_weights(d) - d.w_off[nh]);
  head_sums(h, ldh, kl, wh, no, [&](int item, int, int c, float s) {
    dq[item] = activate_bwd(act_h, activate(act_h, s + bh[c]), dq[item]);
  });
  __syncthreads();
  // Its db (warp c sums column c) and dW (2 lanes a weight, each half of
  // the rows)
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < no; c += kThreads / 32) {
    float s = dq[lane * no + c] + dq[(lane + 32) * no + c];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) dbias[d.b_off[nh] + c] += s;
  }
  for (int base = 0; base < 2 * kl * no; base += kThreads) {
    const int idx = base + threadIdx.x, item = idx >> 1, half = idx & 1;
    const bool live = item < kl * no;
    const int k = live ? item / no : 0, c = live ? item % no : 0;
    float s = 0.f;
    if (live)
      for (int r = half * R / 2; r < (half + 1) * R / 2; ++r)
        s = fmaf(h[r * ldh + k], dq[r * no + c], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (live && half == 0) gaux[item] += s;
  }
  __syncthreads();
  // The last hidden layer's d_pre = ReLU'(post) * (d_pre_head @ W_head^T)
  // in place of its post (2 lanes a column, each half of the rows): db,
  // the scratch
  const int dcol_l = cols.dpre[nh - 1];
  for (int base = 0; base < 2 * kl; base += kThreads) {
    const int idx = base + threadIdx.x, k = idx >> 1, half = idx & 1;
    const bool live = k < kl;
    float wk[kMaxHeadOut];
    for (int c = 0; c < no; ++c) wk[c] = live ? wh[k * no + c] : 0.f;
    float s = 0.f;
    if (live)
      for (int r = half * R / 2; r < (half + 1) * R / 2; ++r) {
        float gr = 0.f;
        for (int c = 0; c < no; ++c) gr = fmaf(dq[r * no + c], wk[c], gr);
        const float u = h[r * ldh + k] > 0.f ? gr : 0.f;
        s += u;
        h[r * ldh + k] = u;
        st[r * total + dcol_l + k] = u;
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (live && half == 0) dbias[d.b_off[nh - 1] + k] += s;
  }
  // The cotangents down the chain: hidden layer i's d_pre @ W_i^T (W_i's
  // rows of layer i - 1's post; no dx, so none of the embedding's), the
  // epilogue's ReLU' from the post this tile wrote to the scratch
  for (int i = nh - 1; i > 0; --i) {
    const int post = cols.post[i - 1], dcol = cols.dpre[i - 1];
    float* db = dbias + d.b_off[i - 1];
    tc::tc_gemm<P>(tc::TcAOf<float>{h, ldh, d.widths[i], nullptr, 0, 0}, w + d.w_off[i],
                   d.widths[i], d.widths[i - 1], ws,
                   [&](int c0, const float (&v)[tc::kTcM][4]) {
                     dpre_epilogue_f32(c0, v, st, total, post, dcol, ho, ldh, db);
                   });
    if (kTwoBuffers) {
      float* t = h;
      h = ho;
      ho = t;
    }
  }
  __syncthreads();
}

// f32 K1-bwd's phase 1: block b walks 64-row tiles b, b + grid, ... and
// writes each tile's scratch; its sums (chain_n_aux floats) go to its own
// slice of `part`. Block 0 first zeroes the dW pass's n_count tile
// counters. One block an SM (~114 KB of shared memory at 128 x 4).
template <bool kTwoBuffers, typename P>
__global__ void __launch_bounds__(kThreads, 1)
chain_bwd_f32_tc_kernel(ChainDesc d, const float* __restrict__ x, const float* __restrict__ dy,
                        const float* __restrict__ w, const float* __restrict__ wt,
                        const float* __restrict__ bias, float* scratch,
                        float* __restrict__ part, unsigned* count, int n_count, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = tc::kTcRows;
  const ChainTcLayout L = chain_tc_layout<P>(d, true);
  const long long tile_floats = static_cast<long long>(R) * chain_cols(d).total;
  const long long n_aux = chain_n_aux(d);
  if (blockIdx.x == 0)
    for (int j = threadIdx.x; j < n_count; j += kThreads) count[j] = 0u;
  float* gaux = part + blockIdx.x * n_aux;
  for (long long j = threadIdx.x; j < n_aux; j += kThreads) gaux[j] = 0.f;
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* dq = reinterpret_cast<float*>(smem + L.dq);
  const int no = d.widths[d.n_layers - 1];
  const long long n_tiles = (n + R - 1) / R;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * R;
    for (int idx = threadIdx.x; idx < R * d.raw_dim; idx += kThreads) {
      const long long r = row0 + idx / d.raw_dim;
      xs[idx] = r < n ? x[r * d.raw_dim + idx % d.raw_dim] : 0.f;
    }
    // Padding rows get a zero cotangent, so they add nothing to dW/db
    for (int idx = threadIdx.x; idx < R * no; idx += kThreads) {
      const long long r = row0 + idx / no;
      dq[idx] = r < n ? dy[r * no + idx % no] : 0.f;
    }
    __syncthreads();
    chain_tile_bwd_f32_tc<kTwoBuffers, P>(d, w, wt, bias, smem, scratch + tile * tile_floats,
                                         gaux);
  }
}

// The f32 dW pass: a block owns a kF32DwTile x kF32DwTile tile of one
// hidden layer's dW (its input positions by its units) and one of `chunks`
// row chunks, and forms X^T D over the chunk's 64-row scratch tiles at
// policy P (the split and the fresh accumulator of phase 1's products),
// with X and D streamed through two stages of shared memory by cp.async.
// With one chunk it writes the dW tile; with more, its partial, and the
// chunk that finishes last (an integer counter a tile, which phase 1
// zeroed) adds the chunks' partials in chunk order: no float atomicAdd,
// the same sums whichever block ends last. The grid's last blocks add
// phase 1's slices (head dW and every db) in slice order.
constexpr int kF32DwTile = 64;
constexpr int kF32DwLd = kF32DwTile + 4;  // floats of a row in shared memory
constexpr int kF32DwOperand = tc::kTcRows * kF32DwLd;
constexpr size_t kF32DwSmem = sizeof(float) * 4 * kF32DwOperand;  // 2 stages of [X | D]

// Starts copying positions [c0, c0 + kF32DwTile) of a product's operand
// from one 64-row scratch tile `src` (rows of `total` floats) into dst
// (kTcRows rows of kF32DwLd floats), 4 positions a 16-byte request:
// position m is scratch column seg1 + m below k1, seg2 + m - k1 above;
// zeros from k on. A request that starts below k reads whole 16-column
// segments (the embedding is stored zero-padded to 16), so none crosses
// a segment's end.
__device__ inline void load_dw_operand_f32(float* dst, const float* src, int total, int c0,
                                           int seg1, int k1, int seg2, int k) {
  constexpr int kPieces = kF32DwTile / 4;
  for (int idx = threadIdx.x; idx < tc::kTcRows * kPieces; idx += kThreads) {
    const int r = idx / kPieces, p = idx % kPieces, m = c0 + 4 * p;
    float* to = dst + r * kF32DwLd + 4 * p;
    if (m < k)
      tc::cp_async16(to, src + static_cast<long long>(r) * total +
                             (m < k1 ? seg1 + m : seg2 + m - k1));
    else
      tc::zero16(to);
  }
}

template <typename P>
__global__ void __launch_bounds__(kThreads)
dw_f32_kernel(DwTable tab, const float* __restrict__ scratch, float* part_dense,
              const float* __restrict__ part_aux, int slices, long long n_aux,
              float* __restrict__ dw, unsigned* count, int chunks, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = tc::kTcRows, T = kF32DwTile, ld = kF32DwLd;
  const long long dense_blocks = static_cast<long long>(dw_tiles_total<T>(tab)) * chunks;
  if (blockIdx.x >= dense_blocks) {
    // Phase 1's slices, in slice order
    const long long stride = (gridDim.x - dense_blocks) * kThreads;
    for (long long j = (blockIdx.x - dense_blocks) * kThreads + threadIdx.x; j < n_aux;
         j += stride) {
      float s = 0.f;
      for (int b = 0; b < slices; ++b) s += part_aux[b * n_aux + j];
      dw[tab.n_dense + j] = s;
    }
    return;
  }
  float* buf = reinterpret_cast<float*>(smem);
  const int chunk = blockIdx.x % chunks, tile_id = blockIdx.x / chunks;
  int tile = tile_id, li = 0;
  while (tile >= dw_tiles<T>(tab.layers[li])) tile -= dw_tiles<T>(tab.layers[li++]);
  const DenseLayer l = tab.layers[li];
  const int k = l.k1 + l.k2, n_tiles_n = (l.n + T - 1) / T;
  const int m0 = (tile / n_tiles_n) * T, c0 = (tile % n_tiles_n) * T;
  const int total = tab.total;
  const long long row_tiles = (n + R - 1) / R;
  const long long t0 = row_tiles * chunk / chunks, t1 = row_tiles * (chunk + 1) / chunks;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps of 32 x 16
  float acc[2][2][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][q][e] = 0.f;
  auto load = [&](long long rt, float* stage) {
    const float* src = scratch + rt * R * total;
    load_dw_operand_f32(stage, src, total, m0, l.seg1, l.k1, l.seg2, k);
    load_dw_operand_f32(stage + kF32DwOperand, src, total, c0, l.dpre, l.n, 0, l.n);
    tc::cp_async_commit();
  };
  if (t0 < t1) load(t0, buf);
  for (long long rt = t0; rt < t1; ++rt) {
    const int s = static_cast<int>((rt - t0) & 1);
    // Tile rt has landed and every warp is done with the other stage
    tc::cp_async_wait_all();
    __syncthreads();
    if (rt + 1 < t1) load(rt + 1, buf + (s ^ 1) * 2 * kF32DwOperand);
    const float* xs = buf + s * 2 * kF32DwOperand;
    const float* ds = xs + kF32DwOperand;
    // A = X^T (positions by rows), B = D (rows by units): m16n8k8
    // fragments, K the tile's rows
#pragma unroll
    for (int kk = 0; kk < R / 8; ++kk) {
      typename P::A af[2];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float* p = xs + (8 * kk + t) * ld + 32 * wm + 16 * m + g;
        P::split(p[0], af[m].hi[0], af[m].lo[0]);
        P::split(p[8], af[m].hi[1], af[m].lo[1]);
        P::split(p[4 * ld], af[m].hi[2], af[m].lo[2]);
        P::split(p[4 * ld + 8], af[m].hi[3], af[m].lo[3]);
      }
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        typename P::B bf;
        const float* p = ds + (8 * kk + t) * ld + 16 * wn + 8 * q + g;
        P::split(p[0], bf.hi[0], bf.lo[0]);
        P::split(p[4 * ld], bf.hi[1], bf.lo[1]);
#pragma unroll
        for (int m = 0; m < 2; ++m) P::mma(acc[m][q], af[m], bf);
      }
    }
  }
  float* out = chunks == 1 ? dw + l.w_off : part_dense + chunk * tab.n_dense + l.w_off;
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int q = 0; q < 2; ++q)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = m0 + 32 * wm + 16 * m + g + 8 * (e >> 1);
        const int c = c0 + 16 * wn + 8 * q + 2 * t + (e & 1);
        if (r < k && c < l.n) out[static_cast<long long>(r) * l.n + c] = acc[m][q][e];
      }
  if (chunks == 1) return;
  // The chunk that ends last adds the partials in chunk order
  __threadfence();
  __syncthreads();
  int* last = reinterpret_cast<int*>(smem);
  if (threadIdx.x == 0) last[0] = atomicAdd(count + tile_id, 1u) == static_cast<unsigned>(chunks - 1);
  __syncthreads();
  if (!last[0]) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < T * T; idx += kThreads) {
    const int r = m0 + idx / T, c = c0 + idx % T;
    if (r >= k || c >= l.n) continue;
    const long long off = l.w_off + static_cast<long long>(r) * l.n + c;
    float s = 0.f;
    for (int ch = 0; ch < chunks; ++ch) s += __ldcg(part_dense + ch * tab.n_dense + off);
    dw[off] = s;
  }
}

// Whether the f32 tensor-core design runs the plan: not a last-skip plan
// (K1's route alone), chain_tc_plan's plans whose hidden acts are all ReLU
// (phase 1's epilogues and the last hidden layer's d_pre take ReLU' from
// the post's sign) and whose phase-1 block fits the card's shared memory.
inline int check_chain_dw_f32_tc(const ChainDesc& d) {
  if (last_skip(d) || !chain_tc_plan(d)) return kErrBadPlan;
  for (int i = 0; i < d.n_layers - 1; ++i)
    if (d.acts[i] != kRelu) return kErrBadPlan;
  const size_t smem = static_cast<size_t>(max_smem_optin());
  if (chain_tc_layout<tc::MmaTf32x3>(d, true).total > smem || kF32DwSmem > smem) return kErrSmem;
  return 0;
}

inline auto chain_bwd_f32_tc_for(const ChainDesc& d) {
  return d.max_width > tc::kTcCols ? chain_bwd_f32_tc_kernel<true, tc::MmaTf32x3>
                                   : chain_bwd_f32_tc_kernel<false, tc::MmaTf32x3>;
}

// The f32 dW pass's blocks that add phase 1's slices
inline long long aux_blocks(long long n_aux) {
  const long long b = (n_aux + kThreads - 1) / kThreads;
  return b < 64 ? b : 64;
}

// f32 K1-bwd with dW only at policy P: phase 1 over `slices` persistent
// blocks, then the dW pass (the dense dW, its chunk sums and phase 1's
// slices): two launches. part holds slices x n_aux + chunks x n_dense
// floats, then the dW tiles' counters.
template <typename P>
int chain_bwd_dw_f32_tc(const ChainDesc& d, const float* x, const float* dy, const float* w,
                        const float* wt, const float* bias, float* scratch, float* part,
                        float* dwb, int slices, int chunks, long long n, cudaStream_t stream) {
  const DwTable tab = chain_dw_table(d);
  const long long n_aux = chain_n_aux(d);
  const int tiles = dw_tiles_total<kF32DwTile>(tab);
  float* part_dense = part + static_cast<long long>(slices) * n_aux;
  unsigned* count = reinterpret_cast<unsigned*>(part_dense + chunks * tab.n_dense);
  const bool two = d.max_width > tc::kTcCols;
  int err = launch_with_smem(
      two ? chain_bwd_f32_tc_kernel<true, P> : chain_bwd_f32_tc_kernel<false, P>,
      chain_tc_layout<P>(d, true).total, slices, stream, d, x, dy, w, wt, bias, scratch, part,
      count, tiles, n);
  if (err) return err;
  return launch_with_smem(dw_f32_kernel<P>, kF32DwSmem,
                          static_cast<long long>(tiles) * chunks + aux_blocks(n_aux), stream,
                          tab, scratch, part_dense, part, slices, n_aux, dwb, count, chunks, n);
}

// Whether the f32 tensor-core forward (mode 0), dx-only backward (1) or
// dW-only backward (2) runs the plan: not a last-skip plan (K1's route
// alone), and check_chain_tc's, check_chain_dx_tc's or
// check_chain_dw_f32_tc's plans at MmaTf32x3.
inline int check_chain_f32_tc(const ChainDesc& d, int mode) {
  if (last_skip(d)) return kErrBadPlan;
  if (mode == 2) return check_chain_dw_f32_tc(d);
  return mode ? check_chain_dx_tc<tc::MmaTf32x3>(d) : check_chain_tc<tc::MmaTf32x3>(d, false);
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
  if (int err = check_chain_f32_tc(d, dx_only ? 1 : 0)) return err;
  if (terms != 1 && terms != 3) return kErrBadArgs;
  if (n <= 0) return 0;
  return terms == 3 ? chain_f32_tc<tc::MmaTf32x3>(d, dx_only, x, dy, w, wt, bias, out, n, stream)
                    : chain_f32_tc<tc::MmaTf32x1>(d, dx_only, x, dy, w, wt, bias, out, n, stream);
}

}  // namespace nfk

extern "C" {

// Whether nfk_chain_fwd_tc_f32 (mode 0), nfk_chain_bwd_dx_tc_f32 (1) or
// nfk_chain_bwd_dw_tc_f32 (2) runs the plan (*runs = 1): no skip after the
// head, chain_tc_plan's plans whose f32 blocks fit the card's shared
// memory, and for the backwards every hidden act ReLU. The wrapper's rules
// (ops/fused_mlp.py fwd_on_tensor_cores, bwd_on_tensor_cores) ask it for
// f32 K1 launches.
int nfk_chain_f32_tc_runs(const nfk::ChainDesc* desc, int mode, int* runs) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (mode < 0 || mode > 2) return nfk::kErrBadArgs;
  *runs = nfk::check_chain_f32_tc(*desc, mode) == 0;
  return 0;
}

// The buffers nfk_chain_bwd_dw_tc_f32 needs for n rows, which the wrapper
// allocates: a scratch of `scratch` floats (kTcRows rows of
// chain_cols().total a 64-row tile: ~3.8 KB a row at 128 x 4); `part`
// floats (phase 1's slices, the dW pass's chunk partials and its tile
// counters); phase 1's slices (its blocks) and the dW pass's row chunks.
int nfk_chain_bwd_dw_tc_f32_sizes(const nfk::ChainDesc* desc, long long n, long long* scratch,
                                  long long* part, int* slices, int* chunks) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (int err = nfk::check_chain_dw_f32_tc(*desc)) return err;
  *scratch = *part = 0;
  *slices = *chunks = 0;
  if (n <= 0) return 0;
  const long long tiles = (n + nfk::tc::kTcRows - 1) / nfk::tc::kTcRows;
  const nfk::DwTable tab = nfk::chain_dw_table(*desc);
  *scratch = tiles * nfk::tc::kTcRows * nfk::chain_cols(*desc).total;
  *chunks = nfk::dw_chunks(n);
  if (int err = nfk::dw_slices(nfk::chain_bwd_f32_tc_for(*desc),
                               nfk::chain_tc_layout<nfk::tc::MmaTf32x3>(*desc, true).total,
                               tiles, slices))
    return err;
  *part = *slices * nfk::chain_n_aux(*desc) + *chunks * tab.n_dense +
          nfk::dw_tiles_total<nfk::kF32DwTile>(tab);
  return 0;
}

// K1-bwd in f32 with dW only on the tensor cores: dW/db of every layer
// into dwb (packed like w then bias, f32; every value written) over the
// buffers of nfk_chain_bwd_dw_tc_f32_sizes. w holds the f32 weights, wt
// each hidden layer's transpose (nfk_chain_fwd_tc_f32's), terms 3: split
// TF32; 1: plain TF32, the control. Two launches: phase 1, the dW pass.
int nfk_chain_bwd_dw_tc_f32(const nfk::ChainDesc* desc, const float* x, const float* dy,
                            const float* w, const float* wt, const float* bias, float* scratch,
                            float* part, float* dwb, int terms, int slices, int chunks,
                            long long n, void* stream) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (int err = nfk::check_chain_dw_f32_tc(*desc)) return err;
  if ((terms != 1 && terms != 3) || slices < 1 || chunks < 1) return nfk::kErrBadArgs;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return terms == 3 ? nfk::chain_bwd_dw_f32_tc<nfk::tc::MmaTf32x3>(*desc, x, dy, w, wt, bias,
                                                                    scratch, part, dwb, slices,
                                                                    chunks, n, s)
                    : nfk::chain_bwd_dw_f32_tc<nfk::tc::MmaTf32x1>(*desc, x, dy, w, wt, bias,
                                                                    scratch, part, dwb, slices,
                                                                    chunks, n, s);
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
