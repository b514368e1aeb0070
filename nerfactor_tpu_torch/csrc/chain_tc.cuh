// The tensor-core chain: the plans and the shared-memory layouts of the
// chain kernels on the tensor cores, the loaders of a tile's embedding,
// their one forward loop over a 64-row tile (chain_hidden_tc) and the two
// tile functions built on it that more than one kernel runs: the forward
// (chain_fwd_tc_tile: K1-fwd, K1r-fwd and K1w-fwd in fused_mlp.cu, K2-fwd
// in fused_rusink.cu) and the input-cotangent backward of a frozen chain
// (chain_tile_dx_tc: K2-bwd in fused_rusink.cu, K1-bwd with dx only in
// fused_mlp.cu). Phase 1 with dW of K1-bwd, K1r-bwd and K1w-bwd
// (chain_tile_bwd_tc) and K1w-bwd's dx pass stay in fused_mlp.cu, f32
// K1-bwd's with dW (chain_tile_bwd_f32_tc) in chain_f32_tc.cu: both run
// this loop with its scratch store on.
//
// The loop, the two tiles and their layouts take tc_gemm's product policy
// (mma_bf16.cuh) as a template argument P. MmaBf16, the default, is every
// bf16 kernel's: embedding, posts and d_pre in bf16, as they were before
// the policy existed. MmaTf32x3 (K1's f32 forward and backwards, the TPU
// kernels _fwd_kernel_trig_t and _bwd_kernel_trig_t in f32) keeps
// every operand f32 in shared memory and streams f32 weights through the
// same ring, a stage the same bytes (16 K rows where bf16 holds 32): the
// sigma chain's dx block (8 x 256, embedding 63) takes ~175 KB, its
// forward ~143 KB, one block an SM. Nothing is rounded below f32 but the
// products' TF32 split; what bounds them is the three products on the
// tensor cores, the split and the accumulator's adds on the CUDA cores,
// the ring's barrier every 16 K, and one block (8 warps) an SM to hide
// them.
#pragma once

#include "chain_mlp.cuh"
#include "mma_bf16.cuh"

namespace nfk {

// ------ plans and layouts ------

// The tensor-core backward's plans: a head of at most kMaxHeadOut columns
// after at least one hidden layer, no skip into the head (its tiny forward
// and dW read the last post alone, as the TPU kernel's _tiny_head, which
// takes no skip consumer), hidden widths on the mma K step (16). A skip
// after the head (K1w: the row is [head | embedding]) leaves the head's
// input the last post alone, so it is one of them.
inline bool chain_tc_plan(const ChainDesc& d) {
  if (d.n_layers < 2 || d.skip_after[d.n_layers - 2] ||
      d.widths[d.n_layers - 1] > kMaxHeadOut)
    return false;
  for (int i = 0; i < d.n_layers - 1; ++i)
    if (d.widths[i] % 16) return false;
  return true;
}

// Columns of a scratch row (mma_bf16.cuh's row-paired scratch): the
// embedding zero-padded to 16 columns; the posts of the hidden layers
// that feed a later hidden layer (all but the last); every hidden layer's
// rounded d_pre. The lvis chain: 96 + 3 x 128 + 4 x 128 = 992 columns.
struct ChainCols {
  int post[kMaxLayers], dpre[kMaxLayers], total;
};

__host__ __device__ inline ChainCols chain_cols(const ChainDesc& d) {
  const int nh = d.n_layers - 1;
  ChainCols c;
  int col = round16(d.embed_dim);
  for (int i = 0; i < nh; ++i) {
    c.post[i] = i < nh - 1 ? col : -1;
    if (i < nh - 1) col += d.widths[i];
  }
  for (int i = 0; i < nh; ++i) {
    c.dpre[i] = col;
    col += d.widths[i];
  }
  c.total = col;
  return c;
}

// Hidden layer i as the dW pass reads it: [embedding] for layer 0, [post
// of layer i - 1 | embedding] for a skip consumer, else [post of i - 1].
__host__ __device__ inline DenseLayer chain_dense_layer(const ChainDesc& d, int i) {
  const ChainCols c = chain_cols(d);
  DenseLayer l;
  l.seg1 = i ? c.post[i - 1] : 0;
  l.k1 = layer_in_dim(d, i) - (i > 0 && d.skip_after[i - 1] ? d.embed_dim : 0);
  l.seg2 = 0;
  l.k2 = i > 0 && d.skip_after[i - 1] ? d.embed_dim : 0;
  l.dpre = c.dpre[i];
  l.n = d.widths[i];
  l.w_off = d.w_off[i];
  return l;
}

// The dW pass's table: every hidden layer; its dW is the packed weights up
// to the head's, [0, w_off[head]).
inline DwTable chain_dw_table(const ChainDesc& d) {
  DwTable t;
  t.n_layers = d.n_layers - 1;
  t.total = chain_cols(d).total;
  t.n_dense = d.w_off[d.n_layers - 1];
  for (int i = 0; i < t.n_layers; ++i) t.layers[i] = chain_dense_layer(d, i);
  return t;
}

// Floats of phase 1's slice, the packed dW/db past the hidden dW: the
// head's dW, then every bias.
__host__ __device__ inline long long chain_n_aux(const ChainDesc& d) {
  return total_weights(d) + total_biases(d) - d.w_off[d.n_layers - 1];
}

// Offset of hidden layer i's transpose in the transposed weights: each
// W^T is (n, round16(k1) + round16(k2)), its segments zero-padded.
__host__ __device__ inline long long chain_wt_offset(const ChainDesc& d, int i) {
  long long off = 0;
  for (int j = 0; j < i; ++j) {
    const DenseLayer l = chain_dense_layer(d, j);
    off += static_cast<long long>(l.n) * (round16(l.k1) + round16(l.k2));
  }
  return off;
}

// Shared-memory layout of a tensor-core block: raw rows (f32) | the
// head's cotangent rows (f32, the backward's phase 1 only) | embedding |
// one activation buffer | the ring of weight stages, the last three at the
// policy's type. The buffer holds, in turn, each hidden post and, in the
// backward, each d_pre: every product's epilogue writes over its own
// operand (bf16: ~94 KB at the lvis width, two blocks an SM). Hidden
// layers wider than one tc_gemm pass (kTcCols) get a second buffer (h2;
// h2 == h otherwise), and each product writes the other one.
struct ChainTcLayout {
  size_t xs, dq, es, h, h2, ws, total;
  int lde, ldh;
};

// The layout at policy P's operand type T (the embedding, the activation
// buffers and the ring; the raw rows and the head's cotangent stay f32).
template <typename P = tc::MmaBf16>
__host__ __device__ inline ChainTcLayout chain_tc_layout(const ChainDesc& d, bool bwd) {
  using T = typename P::T;
  constexpr int R = tc::kTcRows;
  ChainTcLayout s;
  s.lde = tc::tc_ld<T>(d.embed_dim);
  s.ldh = tc::tc_ld<T>(d.max_width);
  s.xs = 0;
  s.dq = align16(s.xs + sizeof(float) * R * d.raw_dim);
  s.es = align16(s.dq + (bwd ? sizeof(float) * R * d.widths[d.n_layers - 1] : 0));
  s.h = align16(s.es + sizeof(T) * R * s.lde);
  s.h2 = d.max_width > tc::kTcCols ? align16(s.h + sizeof(T) * R * s.ldh) : s.h;
  s.ws = align16(s.h2 + sizeof(T) * R * s.ldh);
  s.total = align16(s.ws + tc::Ring<P>::kBytes);
  return s;
}

// Shared-memory layout of K1w-bwd's dx pass (chain_dx_pass_kernel,
// fused_mlp.cu): raw rows (f32) | the embedding's cotangent (f32, ld ldde)
// | one hidden layer's d_pre (bf16, ld lda) | the ring of weight stages.
// ~107 KB at the lvis width: two blocks an SM.
struct DxPassLayout {
  size_t xs, de, a, ws, total;
  int ldde, lda;
};

__host__ __device__ inline DxPassLayout dx_pass_layout(const ChainDesc& d) {
  constexpr int R = tc::kTcRows;
  DxPassLayout s;
  s.ldde = tc::tc_ld(d.embed_dim);
  s.lda = tc::tc_ld(d.max_width);
  s.xs = 0;
  s.de = align16(s.xs + sizeof(float) * R * d.raw_dim);
  s.a = align16(s.de + sizeof(float) * R * s.ldde);
  s.ws = align16(s.a + sizeof(bf16) * R * s.lda);
  s.total = align16(s.ws + sizeof(bf16) * tc::kTcStages * tc::kTcStage);
  return s;
}

// Whether the tensor-core forward (bwd false) or backward's phase 1 (bwd
// true) runs the plan at policy P: chain_tc_plan's plans whose block fits
// the card's shared memory; for a last-skip backward, the dx pass's block
// too.
template <typename P = tc::MmaBf16>
inline int check_chain_tc(const ChainDesc& d, bool bwd) {
  if (!chain_tc_plan(d)) return kErrBadPlan;
  const size_t smem = static_cast<size_t>(max_smem_optin());
  if (chain_tc_layout<P>(d, bwd).total > smem) return kErrSmem;
  if (bwd && last_skip(d) && dx_pass_layout(d).total > smem) return kErrSmem;
  return 0;
}

// ------ the input cotangent of a frozen chain (no dW, no db) ------
//
// K1-bwd's phase 1 reads a post back from its scratch for act'. Without
// dW there is no scratch: the recompute keeps, per post that feeds a later
// hidden layer, only its sign (every hidden act is ReLU), one bit a value
// in shared memory: 1 KB a 128-wide layer, where the post takes 16 KB. A
// product's epilogue gives lane l of warp w the same 16 fragment positions
// of a column tile whatever the product (tc_gemm: the tile at column c0
// is warp (c0 / 8) % 8's), so the thread that writes a word of the mask in
// the forward epilogue reads it back in the backward one: no barrier, no
// exchange.

// uint16s of the mask a hidden layer: one a lane of each n8 column tile.
__host__ __device__ inline int dx_mask_stride(const ChainDesc& d) { return 4 * d.max_width; }

// A ReLU forward product's epilogue that also keeps each post's sign:
// out = T(max(v + b, 0)), as fwd_epilogue's, and bit 4 m + e of the lane's
// word of the tile at c0 set where that post is above 0.
template <typename T = bf16>
__device__ inline void relu_mask_epilogue(int c0, const float (&v)[tc::kTcM][4],
                                          const float* __restrict__ b, T* out, int ldo,
                                          uint16_t* mask) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  unsigned bits = 0;
#pragma unroll
  for (int m = 0; m < tc::kTcM; ++m)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = 16 * m + g + 8 * (e >> 1), c = c0 + 2 * t + (e & 1);
      const T y = from_f<T>(fmaxf(v[m][e] + b[c], 0.f));
      out[r * ldo + c] = y;
      bits |= static_cast<unsigned>(to_f<T>(y) > 0.f) << (4 * m + e);
    }
  mask[(c0 >> 3) * 32 + lane] = static_cast<uint16_t>(bits);
}

// ------ the embedding's loaders ------
//
// The forward loop starts from the tile's embedding, which a loader fills
// from the raw rows xs into es (ld lde, the policy's type, zero-padded to
// 16 columns; no barrier). The loader is a template argument of the loop,
// so each kernel's copy compiles its own and K1's and K2's stay as they
// were.

// K1's and K2's: the trig columns by precise sincosf (embed_tile), in bf16
// or, for K1's f32 kernels, f32.
struct EmbedSincos {
  template <typename T>
  __device__ void operator()(const ChainDesc& d, const float* xs, T* es, int lde) const {
    embed_tile(d, xs, es, lde);
  }
};

// The stash route's forward (K1r-fwd): sin(2^j x + phase), the phase
// added in f32 (embed_rows' kPhase, as chain_fwd_kernel's), so the trig
// columns are the CUDA-core kernel's bit for bit.
struct EmbedPhase {
  __device__ void operator()(const ChainDesc& d, const float* xs, bf16* es, int lde) const {
    embed_rows<bf16, tc::kTcRows>(d, xs, es, lde, kPhase);
    zero_embed_pad(d, es, lde);
  }
};

// The stash route's backward (K1r-bwd): the raw columns from xs, the trig
// columns from the tile's rows of the (n, trig_dim) bf16 stash that
// K1r-fwd wrote, the tile starting at row row0 (rows past n get 0), the
// values chain_tile_bwd reads.
struct EmbedStash {
  const bf16* stash;
  long long row0, n;
  __device__ void operator()(const ChainDesc& d, const float* xs, bf16* es, int lde) const {
    embed_rows<bf16, tc::kTcRows>(d, xs, es, lde, kNoTrig);
    read_stash<bf16, tc::kTcRows>(d, stash, row0, n, es, lde);
    zero_embed_pad(d, es, lde);
  }
};

// ------ the forward loop ------

// The hidden layers' forward on the tensor cores for one 64-row tile whose
// raw rows are in shared memory (layout L, at policy P): the embedding
// (`embed`, one of the loaders above), then each hidden layer through
// tc_gemm<P>, its epilogue writing T(act(v + b)) over its operand. kStore
// (a backward's phase 1 with dW): the embedding and the posts that feed a
// later hidden layer also go to the tile's scratch `st` (the caller's
// chain_cols, `cols`: in bf16 kPairs row pairs of 32-bit words, in f32
// kTcRows rows of floats, `st` cast). kMask (an input-cotangent backward,
// chain_tile_dx_tc; every hidden act ReLU): the posts that feed a later
// hidden layer keep their signs in `mask` (relu_mask_epilogue,
// dx_mask_stride words a layer). Returns the buffer that holds the last
// hidden post, which its product's epilogue has just written (no barrier
// after it). The embedding stays in es. The one forward loop of the
// tensor-core chain kernels (K1-fwd, K1-bwd's phase 1 and dx-only tile,
// K1r-fwd, K1r-bwd's phase 1, K2-fwd, K2-bwd).
template <bool kTwoBuffers, bool kStore, bool kMask = false, typename Embed = EmbedSincos,
          typename P = tc::MmaBf16>
__device__ typename P::T* chain_hidden_tc(const ChainDesc& d, const ChainTcLayout& L,
                                          const ChainCols& cols,
                                          const typename P::T* __restrict__ wt,
                                          const float* __restrict__ bias, unsigned char* smem,
                                          uint32_t* st, uint16_t* mask = nullptr,
                                          Embed embed = {}) {
  using T = typename P::T;
  const float* xs = reinterpret_cast<const float*>(smem + L.xs);
  T* es = reinterpret_cast<T*>(smem + L.es);
  // h holds the latest result; each product writes ho, then the two swap.
  // With one buffer ho is h, fixed
  T* h = reinterpret_cast<T*>(smem + L.h);
  T* ho = kTwoBuffers ? reinterpret_cast<T*>(smem + L.h2) : h;
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  const int nh = d.n_layers - 1, e16 = round16(d.embed_dim), ldh = L.ldh;
  const int total = cols.total;
  embed(d, xs, es, L.lde);
  __syncthreads();
  if constexpr (kStore) {
    if constexpr (sizeof(T) == 2)
      store_pairs(es, L.lde, e16, st, total, 0);
    else
      store_rows(es, L.lde, e16, reinterpret_cast<float*>(st), total, 0);
  }
  tc::TcAOf<T> a{es, L.lde, e16, nullptr, 0, 0};
  for (int i = 0; i < nh; ++i) {
    const int act = d.acts[i], col = cols.post[i], k = a.k1 + a.k2;
    const float* b = bias + d.b_off[i];
    const T* wti = wt + chain_wt_offset(d, i);
    if (kStore && i < nh - 1)
      tc::tc_gemm<P>(a, wti, k, d.widths[i], ws, [&](int c0, const float (&v)[tc::kTcM][4]) {
        fwd_epilogue<kStore, T>(c0, v, act, b, ho, ldh, st, total, col);
      });
    else if (kMask && i < nh - 1)
      tc::tc_gemm<P>(a, wti, k, d.widths[i], ws, [&](int c0, const float (&v)[tc::kTcM][4]) {
        relu_mask_epilogue(c0, v, b, ho, ldh, mask + i * dx_mask_stride(d));
      });
    else
      tc::tc_gemm<P>(a, wti, k, d.widths[i], ws, [&](int c0, const float (&v)[tc::kTcM][4]) {
        fwd_epilogue<false, T>(c0, v, act, b, ho, ldh, st, total, 0);
      });
    if (kTwoBuffers) {
      T* t = h;
      h = ho;
      ho = t;
    }
    const bool skip = d.skip_after[i] != 0;
    a = tc::TcAOf<T>{h, ldh, d.widths[i], skip ? es : nullptr, L.lde, skip ? e16 : 0};
  }
  return h;
}

// ------ the forward of a tile ------

// The forward of one 64-row tile whose raw rows are in shared memory
// (chain_tc_layout<P>(d, false)): the hidden layers through
// chain_hidden_tc from the loader's embedding, without the scratch, then
// the tiny head in f32 on the CUDA cores from the last post (head_sums, as
// phase 1's head forward), its rows below n written to y. kLastSkip: y's
// rows are out_dim(d) wide ([head | embedding], K1w-fwd), the head their
// first columns; else the head alone. w and wt at the policy's type.
template <bool kTwoBuffers, typename Embed = EmbedSincos, bool kLastSkip = false,
          typename P = tc::MmaBf16>
__device__ void chain_fwd_tc_tile(const ChainDesc& d, const typename P::T* __restrict__ w,
                                  const typename P::T* __restrict__ wt,
                                  const float* __restrict__ bias, unsigned char* smem,
                                  float* __restrict__ y, long long row0, long long n,
                                  Embed embed = {}) {
  const ChainTcLayout L = chain_tc_layout<P>(d, false);
  const typename P::T* h = chain_hidden_tc<kTwoBuffers, false, false, Embed, P>(
      d, L, chain_cols(d), wt, bias, smem, nullptr, nullptr, embed);
  __syncthreads();
  const int nh = d.n_layers - 1, no = d.widths[nh], act = d.acts[nh];
  const float* bh = bias + d.b_off[nh];
  head_sums(h, L.ldh, d.widths[nh - 1], w + d.w_off[nh], no, [&](int item, int r, int c,
                                                                   float s) {
    if (row0 + r < n) {
      if constexpr (kLastSkip)
        y[(row0 + r) * out_dim(d) + c] = activate(act, s + bh[c]);
      else
        y[row0 * no + item] = activate(act, s + bh[c]);
    }
  });
}

// The forward of block blockIdx.x's 64-row tile: its raw rows from x (n,
// raw_dim), then chain_fwd_tc_tile
// (the hidden layers as phase 1 recomputes them, from the loader's
// embedding, without the scratch; the tiny head in f32 on the CUDA cores;
// kLastSkip: y's rows are [head | embedding]), products at policy P.
template <bool kTwoBuffers, typename Embed, bool kLastSkip = false, typename P = tc::MmaBf16>
__device__ void chain_fwd_tc_block(const ChainDesc& d, const float* __restrict__ x,
                                   const typename P::T* __restrict__ w,
                                   const typename P::T* __restrict__ wt,
                                   const float* __restrict__ bias, float* __restrict__ y,
                                   long long n, Embed embed) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = tc::kTcRows;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  float* xs = reinterpret_cast<float*>(smem + chain_tc_layout<P>(d, false).xs);
  for (int idx = threadIdx.x; idx < R * d.raw_dim; idx += kThreads) {
    const long long r = row0 + idx / d.raw_dim;
    xs[idx] = r < n ? x[r * d.raw_dim + idx % d.raw_dim] : 0.f;
  }
  __syncthreads();
  chain_fwd_tc_tile<kTwoBuffers, Embed, kLastSkip, P>(d, w, wt, bias, smem, y, row0, n, embed);
}


// ------ K1w: the embedding's columns of a last-skip row ------

// f(r, c) for every row r < rows and column c < cols of a tile. A thread
// keeps one column and walks the rows (no division a value); the block's
// threads cover whole rows a pass, so neighbouring threads touch
// neighbouring columns.
template <typename F>
__device__ inline void for_tile_cols(int rows, int cols, F f) {
  for (int c0 = 0; c0 < cols; c0 += kThreads) {
    const int nc = min(kThreads, cols - c0), per = kThreads / nc;
    if (threadIdx.x >= per * nc) continue;
    const int c = c0 + threadIdx.x % nc;
#pragma unroll 4
    for (int r = threadIdx.x / nc; r < rows; r += per) f(r, c);
  }
}

// K1w-fwd's trailing columns: the tile's embedding (es, ld lde, bf16, the
// values the products read) as f32 into columns [no, no + embed_dim) of
// y's rows below n (ld out_dim(d)), in the reference order, the values
// chain_tile writes. No barrier.
__device__ inline void write_embed_cols(const ChainDesc& d, const bf16* es, int lde,
                                        float* __restrict__ y, long long row0, long long n) {
  const int ldy = out_dim(d), no = d.widths[d.n_layers - 1];
  const int rows = static_cast<int>(min(static_cast<long long>(tc::kTcRows), n - row0));
  for_tile_cols(rows, d.embed_dim, [&](int r, int c) {
    y[(row0 + r) * ldy + no + c] = to_f<bf16>(es[r * lde + c]);
  });
}

// ------ the input cotangent of a frozen chain, continued ------

// A d_pre @ W^T product's epilogue in the input-cotangent backward, over
// the product's columns: below w (the previous hidden layer's units), its
// d_pre, T(v) where the post's sign bit is set and 0 elsewhere (ReLU'),
// into dpre (ld ldp); from w up to n (the embedding's rows of W), v added
// in f32 into the embedding's cotangent de (ld ldde) at column c - w; from
// n on (the last n8 tile of a width off the 8 step), nothing.
template <typename T = bf16>
__device__ inline void dx_epilogue(int c0, const float (&v)[tc::kTcM][4], int w, int n,
                                   const uint16_t* mask, T* dpre, int ldp, float* de,
                                   int ldde) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  if (c0 < w) {
    const unsigned bits = mask[(c0 >> 3) * 32 + lane];
#pragma unroll
    for (int m = 0; m < tc::kTcM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m + g + 8 * (e >> 1), c = c0 + 2 * t + (e & 1);
        dpre[r * ldp + c] = from_f<T>((bits >> (4 * m + e)) & 1u ? v[m][e] : 0.f);
      }
  } else {
#pragma unroll
    for (int m = 0; m < tc::kTcM; ++m)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 16 * m + g + 8 * (e >> 1), c = c0 + 2 * t + (e & 1);
        if (c < n) de[r * ldde + c - w] += v[m][e];
      }
  }
}

// Shared-memory layout of the input-cotangent backward at policy P: the
// phase-1 layout (chain_tc_layout<P>(d, true): raw rows | head cotangent
// rows | embedding | activation buffer(s) | weight ring), then the
// embedding's cotangent (f32, ld ldde) | the posts' sign masks | the raw
// rows' cotangent (f32). bf16: ~100 KB at the BRDF chain's width (128 x 4,
// embedding 18), two blocks an SM. f32: ~175 KB at the sigma chain's (256
// x 8, embedding 63), one.
struct ChainDxLayout {
  ChainTcLayout t;
  size_t de, mask, dxs, total;
  int ldde;
};

template <typename P = tc::MmaBf16>
__host__ __device__ inline ChainDxLayout chain_dx_layout(const ChainDesc& d) {
  constexpr int R = tc::kTcRows;
  ChainDxLayout s;
  s.t = chain_tc_layout<P>(d, true);
  s.ldde = tc::tc_ld(d.embed_dim);
  s.de = s.t.total;
  s.mask = align16(s.de + sizeof(float) * R * s.ldde);
  s.dxs = align16(s.mask + sizeof(uint16_t) * (d.n_layers - 2) * dx_mask_stride(d));
  s.total = align16(s.dxs + sizeof(float) * R * d.raw_dim);
  return s;
}

// Whether a product of chain_tile_dx_tc at policy P whose columns pass
// one tc_gemm pass runs as two (kSplitDx): the f32 policy's, so that the
// sigma chain's skip consumer (256 + 63 columns) keeps one activation
// buffer; the bf16 instantiations keep their one product and refuse such
// plans.
template <typename P>
constexpr bool kSplitDx = sizeof(typename P::T) == sizeof(float);

// Whether chain_tile_dx_tc runs the plan at policy P: chain_tc_plan's
// plans whose hidden layers are all ReLU (a mask keeps a post's sign
// alone), whose block fits the card's shared memory, and, in bf16 with
// one activation buffer, whose products all take one column pass (a
// second pass reads the whole operand again, which the first pass's
// epilogue wrote over).
template <typename P = tc::MmaBf16>
inline int check_chain_dx_tc(const ChainDesc& d) {
  if (!chain_tc_plan(d)) return kErrBadPlan;
  for (int i = 0; i < d.n_layers - 1; ++i)
    if (d.acts[i] != kRelu) return kErrBadPlan;
  if (!kSplitDx<P> && d.max_width <= tc::kTcCols)
    for (int i = 1; i < d.n_layers - 1; ++i)
      if (layer_in_dim(d, i) > tc::kTcCols) return kErrBadPlan;
  if (chain_dx_layout<P>(d).total > static_cast<size_t>(max_smem_optin())) return kErrSmem;
  return 0;
}

// The input cotangent of a frozen chain for one 64-row tile whose raw rows
// and head cotangent rows are in shared memory (layout chain_dx_layout<P>)
// and whose embedding cotangent de is zero: the forward recompute on the
// tensor cores, keeping the posts' signs; the tiny head's d_pre and the
// last hidden layer's in f32 on the CUDA cores; then, for i = nh - 1 ...
// 0, d_pre_i @ W_i^T on the tensor cores, the embedding's rows of W_i
// included (layer 0's and a skip consumer's), through dx_epilogue. Leaves
// the embedding's cotangent in de. Rounds where chain_tile_bwd does at the
// policy's type: in bf16 posts and d_pre at bf16, d_h and de in f32; in
// f32 nothing; de summed in its order (a skip consumer's rows, then layer
// 0's). At the f32 policy with one activation buffer, a product whose
// columns pass one tc_gemm pass (a skip consumer past 256 inputs: the
// sigma chain's 256 + 63) runs as two (kSplitDx): the embedding's rows
// into de first, then the previous layer's over its operand. Ends at a
// barrier.
template <bool kTwoBuffers, typename P = tc::MmaBf16>
__device__ void chain_tile_dx_tc(const ChainDesc& d, const typename P::T* __restrict__ w,
                                 const typename P::T* __restrict__ wt,
                                 const float* __restrict__ bias, unsigned char* smem) {
  using T = typename P::T;
  constexpr int R = tc::kTcRows;
  const ChainDxLayout L = chain_dx_layout<P>(d);
  float* dq = reinterpret_cast<float*>(smem + L.t.dq);
  float* de = reinterpret_cast<float*>(smem + L.de);
  uint16_t* mask = reinterpret_cast<uint16_t*>(smem + L.mask);
  T* h = chain_hidden_tc<kTwoBuffers, false, true, EmbedSincos, P>(d, L.t, chain_cols(d), wt,
                                                                    bias, smem, nullptr, mask);
  // h holds the latest d_pre; each product writes ho, then the two swap.
  // With one buffer ho is h, fixed
  T* ho = h;
  if (kTwoBuffers)
    ho = reinterpret_cast<T*>(smem + (h == reinterpret_cast<T*>(smem + L.t.h) ? L.t.h2 : L.t.h));
  T* ws = reinterpret_cast<T*>(smem + L.t.ws);
  const int nh = d.n_layers - 1, ldh = L.t.ldh;
  __syncthreads();
  // The head's forward from the last post, its d_pre in place of dy, then
  // the rounding
  const int no = d.widths[nh], kl = d.widths[nh - 1], act_h = d.acts[nh];
  const T* wh = w + d.w_off[nh];  // (kl, no) row-major
  const float* bh = bias + d.b_off[nh];
  head_sums(h, ldh, kl, wh, no, [&](int item, int, int c, float s) {
    dq[item] = activate_bwd(act_h, activate(act_h, s + bh[c]), dq[item]);
  });
  __syncthreads();
  if constexpr (sizeof(T) < sizeof(float)) {
    for (int idx = threadIdx.x; idx < R * no; idx += kThreads)
      dq[idx] = to_f<T>(from_f<T>(dq[idx]));
    __syncthreads();
  }
  // The last hidden layer's d_pre = ReLU'(post) * (d_pre_head @ W_head^T)
  // in place of its post, the sum in dgrad_pass's order
  for (int idx = threadIdx.x; idx < R * kl; idx += kThreads) {
    const int r = idx / kl, k = idx % kl;
    float gr = 0.f;
    for (int c = 0; c < no; ++c) gr = fmaf(dq[r * no + c], to_f<T>(wh[k * no + c]), gr);
    h[r * ldh + k] = from_f<T>(to_f<T>(h[r * ldh + k]) > 0.f ? gr : 0.f);
  }
  // Down the chain: the product of layer i has the previous layer's units
  // and, for layer 0 and a skip consumer, the embedding's rows as columns
  for (int i = nh - 1; i >= 0; --i) {
    const int prev = i ? d.widths[i - 1] : 0;
    const int n = i == 0 || d.skip_after[i - 1] ? layer_in_dim(d, i) : prev;
    const uint16_t* mi = i ? mask + (i - 1) * dx_mask_stride(d) : nullptr;
    const tc::TcAOf<T> a{h, ldh, d.widths[i], nullptr, 0, 0};
    const T* wi = w + d.w_off[i];
    if (kSplitDx<P> && !kTwoBuffers && n > tc::kTcCols && prev > 0) {
      tc::tc_gemm<P>(a, wi + static_cast<long long>(prev) * d.widths[i], d.widths[i], n - prev,
                     ws, [&](int c0, const float (&v)[tc::kTcM][4]) {
                       dx_epilogue(c0, v, 0, n - prev, nullptr, ho, ldh, de, L.ldde);
                     });
      tc::tc_gemm<P>(a, wi, d.widths[i], prev, ws, [&](int c0, const float (&v)[tc::kTcM][4]) {
        dx_epilogue(c0, v, prev, prev, mi, ho, ldh, de, L.ldde);
      });
    } else {
      tc::tc_gemm<P>(a, wi, d.widths[i], n, ws, [&](int c0, const float (&v)[tc::kTcM][4]) {
        dx_epilogue(c0, v, prev, n, mi, ho, ldh, de, L.ldde);
      });
    }
    if (kTwoBuffers) {
      T* t = h;
      h = ho;
      ho = t;
    }
  }
  __syncthreads();
}

}  // namespace nfk
