// Kernels K1-fwd and K1-bwd: the fused posenc -> skip-MLP -> head chain.
//
// K1-fwd replaces the TPU kernel nerfactor_tpu/ops/pallas_mlp.py
// _pallas_forward_trig_t -> _fwd_kernel_trig_t: per row,
// head(MLP(posenc(x))) with ReLU hidden layers, the embedding concatenated
// after the layers in skip_after, and a sigmoid/softplus/linear head. It
// runs as one of three designs, chosen by a rule on the plan
// (ops/fused_mlp.py fwd_on_tensor_cores):
//
//   * bf16, on the plans the tensor-core backward's phase 1 takes
//     (chain_tc_plan) with a block that fits the card's shared memory (the
//     joint step's lvis chain, NeRF's no-views chain): chain_fwd_tc_kernel
//     (chain_stash_fwd_tc_kernel on the stash route, K1r-fwd, below), a
//     block a 64-row tile, two blocks an SM. It is
//     the forward half of phase 1 (chain_hidden_tc in chain_tc.cuh, one
//     loop for both, which K2's tensor-core kernels share):
//     every hidden layer a tc_gemm of the tile's rows in shared memory
//     with the weights streamed through the cp.async ring, its epilogue
//     writing bf16(act(v + b)) over its operand; the tiny head in f32 on
//     the CUDA cores (head_sums). No scratch. What bounds it is what
//     bounds phase 1: the weight ring's barrier every 32 K, the epilogues
//     and the head on the CUDA cores, not the tensor cores' rate.
//   * f32 on K1's route, on the same plans with an f32 block that fits,
//     where no CUDA-core backward recomputes the forward: under autograd
//     at any size where the backward is one of the split-TF32 designs
//     below (the training heads, dW alone; distillation's sigma chain, 8
//     x 256, dx alone), so the forward and the backward's recompute gate
//     each ReLU alike; a forward alone from F32_TC_MIN_ROWS rows, below
//     which the wrapper's host work (the packing kernel's launch among
//     it) outlasts the kernel's saving:
//     chain_fwd_f32_tc_kernel (chain_f32_tc.cu, built beside this
//     source), the same
//     tile at the split-TF32 policy (chain_tc.cuh, MmaTf32x3): f32
//     embedding and posts in shared memory, f32 weights through the same
//     ring at 16 K a stage, each product lo hi + hi lo + hi hi of the
//     operands' TF32 halves on mma.sync.m16n8k8 (the dropped lo lo term is
//     ~2^-22 of it, so the result keeps f32's accuracy, where one TF32
//     product keeps ~1e-3), each m16n8k8 step's sum added into the f32
//     accumulator on the CUDA cores, rounded to nearest (the tensor cores'
//     own accumulation is not, and grew the error tenfold over K = 256,
//     enough to gate ReLU units the other way). ~143 KB of shared memory
//     at the sigma chain's width: one block an SM. Bound by the three
//     products a product on the tensor cores and, on the CUDA cores, the
//     split (the A fragments are split by each of the 8 warps) and the
//     accumulator's adds, with the ring's barrier every 16 K and one
//     block's 8 warps to hide them; the launch bounds leave it the
//     registers.
//   * every other call (f32 K1r and K1w; f32 with a CUDA-core backward
//     to follow, or alone below F32_TC_MIN_ROWS rows; a skip after the
//     head or into it; a head wider than 8; hidden layers too wide for
//     the block):
//     chain_fwd_kernel on the CUDA cores, described below.
//   The tensor-core kernels read each hidden layer's W^T, which the
//   wrapper packs on the card in one launch (pack_transposed.cu).
//
// K1-bwd replaces _pallas_backward_trig_t -> _bwd_kernel_trig_t (with
// _bwd_layers_trig_t): it recomputes each tile's forward, then returns
// the optional input cotangent dx and the optional dW/db (f32). d_h stays
// f32; in bf16 each layer's d_pre is rounded to bf16 before its products
// and db is the column sum of the unrounded d_pre; a head of at most 8
// columns is a tiny f32 product (the TPU kernel's _tiny_head). No float
// atomicAdd: the same input gives bit-identical dW/db on the same card.
// It runs as one of four designs, chosen by a rule on the plan and the
// flags (ops/fused_mlp.py bwd_on_tensor_cores):
//
//   * bf16 with dW only, a head of at most 8 columns with no skip after it
//     or into it, and a phase-1 block that fits the card's shared memory
//     (the joint step's lvis chain): the tensor-core design, three
//     launches that together replace _bwd_kernel_trig_t (and, on the stash
//     route, _bwd_kernel_trig, below).
//     1. chain_bwd_tc_kernel (chain_stash_bwd_tc_kernel on the stash
//        route), persistent blocks (two an SM) over 64-row
//        tiles: the forward recompute and d_pre @ W^T of every hidden
//        layer but the first as mma.sync products of the tile's rows in
//        shared memory (mma_bf16.cuh tc_gemm), the weights streamed
//        through a three-stage cp.async ring. Each product's epilogue
//        writes over its own operand (one bf16 activation buffer, ~94 KB
//        of shared memory a block at the lvis width, where the CUDA-core
//        layout's f32 rows took ~150 KB) and stores the embedding, the
//        posts that feed a later hidden layer and every rounded d_pre to a
//        bf16 scratch in device memory (992 columns, 1,984 B a row at the
//        lvis width, row pairs interleaved); the backward's epilogues form
//        the next d_pre (act' from the post read back from the scratch, db
//        from warp-shuffle sums, the rounding). The head's forward, d_pre,
//        db and dW and the last hidden layer's d_pre are f32 loops on the
//        CUDA cores. The block's small f32 slice holds only the head's dW
//        and every db, so no dW crosses the L2 per tile. Hidden layers
//        wider than 256 (two column passes a product) take a second
//        activation buffer in their own instantiation.
//     2. dw_kernel (mma_bf16.cuh, shared with K3-bwd): dW = X^T D of every
//        hidden layer over the scratch, a 64 x 64 tile of one layer's dW a
//        block (20 tiles at the lvis width, x 8 row chunks: 160 blocks).
//     3. sum_slices: the chunks' partials and phase 1's slices, each in
//        order.
//     What bounds it is not the tensor cores' rate: phase 1 waits on its
//     weight stages (a barrier every 32 K; two blocks an SM hide part of
//     it) and runs its epilogues and f32 head on the CUDA cores; the dW
//     pass reads each scratch column once per dW tile of the other
//     dimension (~5 GB at 1,048,576 rows), so it is bound by bytes.
//   * f32 with dx only (frozen weights: distillation's depth/normal pass,
//     the sigma chain's point gradient) on K1's route, every hidden act
//     ReLU, a block that fits: chain_dx_f32_tc_kernel (chain_f32_tc.cu),
//     one launch, a block
//     a 64-row tile, no scratch, no dW: chain_tile_dx_tc (chain_tc.cuh) at
//     the split-TF32 policy, K2-bwd's frozen-chain tile: the recompute
//     keeps each ReLU post's sign as a bit, not the post (the CUDA-core
//     kernel kept every f32 post, which fits at the sigma chain's width
//     only at 16 rows, each 16-row tile streaming all the weights twice);
//     the head and the last hidden layer's d_pre in f32 on the CUDA cores;
//     d_pre @ W^T of every layer on the tensor cores, the embedding's rows
//     of W adding into an f32 embedding cotangent (the skip consumer's 319
//     columns as two products, so one activation buffer holds); the trig
//     chain rule (embed_bwd). ~175 KB of shared memory: one block an SM.
//     Bound as the f32 forward.
//   * f32 with dW only (the training heads: the joint model's albedo and
//     brdf_z, the shape model's normal, the microfacet roughness) on K1's
//     route, every hidden act ReLU, a head of at most 8, up to
//     F32_DW_TC_MAX_ROWS rows: the bf16 dW-only design in split TF32, two
//     launches (chain_f32_tc.cu's header): phase 1
//     chain_bwd_f32_tc_kernel, whose recompute is the f32 forward's own
//     loop at its policy (each ReLU gates as in the output), writing an
//     f32 scratch (~3.8 KB a row at 128 x 4); then dw_f32_kernel, X^T D
//     in split TF32 over 64 x 64 tiles and up to 8 row chunks, the last
//     chunk of a tile adding the partials in chunk order and the grid's
//     last blocks phase 1's slices (no sum_slices). Bound, at 2,048 rows,
//     by phase 1's 32 blocks (one a tile) and their products' latency,
//     not by the tensor cores' rate.
//   * every other call (f32 with dx and dW, f32 dW past
//     F32_DW_TC_MAX_ROWS rows, f32 K1r and K1w, bf16 dx on K1 and K1r, a
//     non-ReLU hidden layer in f32, a skip after the head or into it, a
//     wider head, hidden layers too wide for phase 1's block, from ~600
//     columns): chain_bwd_kernel on the CUDA cores. A block keeps a
//     row tile's embedding, every hidden post and two f32 cotangent rows
//     in shared memory, streams each layer's weights through a 32 x 128
//     tile, and runs the recompute (layer_pass), d_pre @ W^T (dgrad_pass)
//     and X^T d_pre (wgrad_pass) as f32 FMA loops; each tile adds its dW
//     into its block's f32 slice of a scratch buffer (in the L2: the lvis
//     chain's 72k weights x 132 slices are ~38 MB), and sum_slices adds
//     the slices in slice order. Bound by arithmetic on the CUDA cores.
//
// The same kernels in two more modes replace the TPU package's other
// chain kernels:
//   * K1r-fwd / K1r-bwd, the stash route (pallas_mlp.py _pallas_forward_trig
//     -> _fwd_kernel_trig, _pallas_backward_trig -> _bwd_kernel_trig): the
//     embedding's trig columns are sin(2^j x + phase), phase 0 or pi/2 in
//     f32; under autograd the forward writes them (at the operand type) to
//     a (n, trig_dim) stash that the backward reads instead of recomputing
//     sin/cos, and dx uses cos of the recomputed phase. The stash adds
//     2 * trig_dim bytes a row each way (bf16). The rules pick the designs
//     as for K1: in bf16 (and for the backward, dW only) the tensor-core
//     kernels, K1's tile with the embedding's loader swapped (chain_tc.cuh:
//     EmbedPhase in chain_stash_fwd_tc_kernel, which also writes the
//     stash from the embedding it read; EmbedStash in phase 1,
//     chain_stash_bwd_tc_kernel, whose scratch then carries the stash's
//     values to the dW pass); f32 and dx: the CUDA-core kernels' phase
//     mode.
//   * K1w-fwd / K1w-bwd: plans with a skip after the last layer
//     (pallas_mlp.py _pallas_forward -> _fwd_kernel, _pallas_backward ->
//     _bwd_kernel): the output row is [head | embedding], and the
//     backward seeds the embedding's cotangent from dy's trailing
//     columns. In bf16 (the rules as for K1, with dx or dW or both) the
//     tensor-core kernels: chain_last_skip_fwd_tc_kernel, K1-fwd's tile
//     with the tile's embedding then written to the row's trailing
//     columns; K1-bwd's phase 1 (chain_last_skip_bwd_tc_kernel, dy's head
//     column read at the row's stride) and dW pass, and for dx a third
//     kernel, the dx pass (chain_dx_pass_kernel), over phase 1's scratch:
//     a tile's d_e is dy's trailing columns plus, from the highest skip
//     consumer down to layer 0, each one's rounded d_pre (read back from
//     the scratch) times the embedding's rows of its W on the tensor
//     cores, in f32; then the trig chain rule (embed_bwd). f32: the
//     CUDA-core kernels' last-skip mode.
//
// K1-fwd is bound by arithmetic: at full width (128 x 4, skip after layer
// 2) the lvis chain does ~72k multiply-adds a row against 24 B in and 4 B
// out. chain_fwd_kernel keeps a row tile's embedding and activations in
// shared memory and streams each layer's weights (~290 KB in f32, more
// than a block's 227 KB) through a 32 x 128 tile; products on the CUDA
// cores in f32 from f32 or bf16 operands.
//
// Inputs: x (n, raw_dim) f32 row-major; weights packed in JAX layout
// (w is (din, dout), applied as x @ w), biases f32; for the tensor-core
// kernels also each hidden layer's transpose (n x (round16(k1) +
// round16(k2)), zero-padded segments). Output y (n, out_dim) f32.

#include "chain_mlp.cuh"
#include "chain_tc.cuh"
#include "mma_bf16.cuh"

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

// ------ K1-bwd in bf16 with dW only: phase 1 and the dW pass ------

// The chain's dW tile (dw_kernel): 64, so that the lvis chain's four
// 128-wide layers make 20 tiles (160 blocks over 8 row chunks), not 5
constexpr int kChainDwTile = 64;

// Phase 1 for one 64-row tile whose raw rows and head cotangent rows are
// in shared memory: the forward recompute on the tensor cores from the
// loader's embedding (`embed`: K1's sincos, or K1r's stash), the tiny
// head's backward on the CUDA cores in f32, then d_pre @ W^T of every
// hidden layer but the first on the tensor cores. Writes the tile's
// scratch `st` (kPairs rows of `total` words; its embedding columns are
// the loader's, so the dW pass reads what the recompute read) and adds
// the head's dW and every db into `gaux` (chain_n_aux floats: [head dW |
// biases]). Rounds where chain_tile_bwd does: posts and d_pre at bf16,
// d_h in f32, db from the unrounded d_pre.
template <bool kTwoBuffers, typename Embed>
__device__ void chain_tile_bwd_tc(const ChainDesc& d, const bf16* __restrict__ w,
                                  const bf16* __restrict__ wt, const float* __restrict__ bias,
                                  unsigned char* smem, uint32_t* st, float* gaux, Embed embed) {
  constexpr int R = tc::kTcRows;
  const ChainTcLayout L = chain_tc_layout(d, true);
  const ChainCols cols = chain_cols(d);
  float* dq = reinterpret_cast<float*>(smem + L.dq);
  // Forward recompute. h holds the last post; each later product writes
  // ho, then the two swap. With one buffer ho is h, fixed
  bf16* h = chain_hidden_tc<kTwoBuffers, true, false, Embed>(d, L, cols, wt, bias, smem, st,
                                                             nullptr, embed);
  bf16* ho = h;
  if (kTwoBuffers)
    ho = reinterpret_cast<bf16*>(smem + (h == reinterpret_cast<bf16*>(smem + L.h) ? L.h2 : L.h));
  const auto flip = [&] {
    if (kTwoBuffers) {
      bf16* t = h;
      h = ho;
      ho = t;
    }
  };
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  const int nh = d.n_layers - 1, ldh = L.ldh;
  const int total = cols.total;
  __syncthreads();
  // The head (tiny, f32 on the CUDA cores, as chain_tile_bwd's). Each of
  // its sums is split over 2 or 4 neighbouring lanes and joined by
  // shuffles in a fixed order, so that all threads share the work; every
  // loop runs the same trips on every thread (the shuffles need whole
  // warps).
  const int no = d.widths[nh], kl = d.widths[nh - 1], act_h = d.acts[nh];
  const bf16* wh = w + d.w_off[nh];  // (kl, no) row-major
  const float* bh = bias + d.b_off[nh];
  float* dbias = gaux + (total_weights(d) - d.w_off[nh]);
  // Its forward from the last post, its d_pre in place of dy
  head_sums(h, ldh, kl, wh, no, [&](int item, int, int c, float s) {
    dq[item] = activate_bwd(act_h, activate(act_h, s + bh[c]), dq[item]);
  });
  __syncthreads();
  // db from the unrounded d_pre (warp c sums column c), then the rounding
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < no; c += kThreads / 32) {
    float* col = dq + c;
    float s = col[lane * no] + col[(lane + 32) * no];
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) dbias[d.b_off[nh] + c] += s;
    col[lane * no] = to_f<bf16>(from_f<bf16>(col[lane * no]));
    col[(lane + 32) * no] = to_f<bf16>(from_f<bf16>(col[(lane + 32) * no]));
  }
  __syncthreads();
  // dW (2 lanes a weight, each half of the rows)
  for (int base = 0; base < 2 * kl * no; base += kThreads) {
    const int idx = base + threadIdx.x, item = idx >> 1, half = idx & 1;
    const bool live = item < kl * no;
    const int k = live ? item / no : 0, c = live ? item % no : 0;
    float s = 0.f;
    if (live)
      for (int r = half * R / 2; r < (half + 1) * R / 2; ++r)
        s = fmaf(to_f<bf16>(h[r * ldh + k]), dq[r * no + c], s);
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (live && half == 0) gaux[item] += s;
  }
  __syncthreads();
  // The last hidden layer's d_pre = act'(post) * (d_pre_head @ W_head^T)
  // in place of its post (2 lanes a column, each half of the row pairs):
  // db, the rounding, the scratch
  const int act_l = d.acts[nh - 1], dcol_l = cols.dpre[nh - 1];
  for (int base = 0; base < 2 * kl; base += kThreads) {
    const int idx = base + threadIdx.x, k = idx >> 1, half = idx & 1;
    const bool live = k < kl;
    float wk[kMaxHeadOut];
    for (int c = 0; c < no; ++c) wk[c] = live ? to_f<bf16>(wh[k * no + c]) : 0.f;
    float s = 0.f;
    if (live)
      for (int j = half * kPairs / 2; j < (half + 1) * kPairs / 2; ++j) {
        bf16 y[2];
        for (int i = 0; i < 2; ++i) {
          const int r = 2 * j + i;
          float gr = 0.f;
          for (int c = 0; c < no; ++c) gr = fmaf(dq[r * no + c], wk[c], gr);
          const float u = activate_bwd(act_l, to_f<bf16>(h[r * ldh + k]), gr);
          s += u;
          y[i] = from_f<bf16>(u);
          h[r * ldh + k] = y[i];
        }
        st[j * total + dcol_l + k] = tc::pack2(y[0], y[1]);
      }
    s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (live && half == 0) dbias[d.b_off[nh - 1] + k] += s;
  }
  // The cotangents down the chain: hidden layer i's d_pre @ W_i^T (W_i's
  // rows of layer i - 1's post; no dx, so none of the embedding's) and its
  // epilogue make layer i - 1's d_pre, act' from the post read back from
  // the scratch columns this tile wrote. ReLU's act' takes its own
  // epilogue (see fwd_epilogue)
  for (int i = nh - 1; i > 0; --i) {
    const int act = d.acts[i - 1], post = cols.post[i - 1], dcol = cols.dpre[i - 1];
    float* db = dbias + d.b_off[i - 1];
    const tc::TcA a{h, ldh, d.widths[i], nullptr, 0, 0};
    if (act == kRelu)
      tc::tc_gemm(a, w + d.w_off[i], d.widths[i], d.widths[i - 1], ws,
                  [&](int c0, const float (&v)[tc::kTcM][4]) {
                    dpre_epilogue(
                        c0, v,
                        [&](int r, int c, float x) {
                          return scratch_at(st, total, r, post + c) > 0.f ? x : 0.f;
                        },
                        ho, ldh, st, total, dcol, db);
                  });
    else
      tc::tc_gemm(a, w + d.w_off[i], d.widths[i], d.widths[i - 1], ws,
                  [&](int c0, const float (&v)[tc::kTcM][4]) {
                    dpre_epilogue(
                        c0, v,
                        [&](int r, int c, float x) {
                          return activate_bwd(act, scratch_at(st, total, r, post + c), x);
                        },
                        ho, ldh, st, total, dcol, db);
                  });
    flip();
  }
  __syncthreads();
}

// Phase 1: block b walks 64-row tiles b, b + grid, ... and writes each
// tile's scratch; its sums (chain_n_aux floats) go to its own slice of
// `part`. kStash: the embedding's trig columns come from `stash` (K1r-bwd),
// else from sincos of x (K1-bwd). kLastSkip: dy's rows are out_dim(d)
// wide, [head | embedding] (K1w-bwd), of which phase 1 reads the head's.
template <bool kTwoBuffers, bool kStash, bool kLastSkip = false>
__device__ void chain_bwd_tc_blocks(const ChainDesc& d, const float* __restrict__ x,
                                    const float* __restrict__ dy, const bf16* __restrict__ stash,
                                    const bf16* __restrict__ w, const bf16* __restrict__ wt,
                                    const float* __restrict__ bias, uint32_t* scratch,
                                    float* __restrict__ part, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = tc::kTcRows;
  const ChainTcLayout L = chain_tc_layout(d, true);
  const long long tile_words = static_cast<long long>(kPairs) * chain_cols(d).total;
  const long long n_aux = chain_n_aux(d);
  float* gaux = part + blockIdx.x * n_aux;
  for (long long j = threadIdx.x; j < n_aux; j += kThreads) gaux[j] = 0.f;
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* dq = reinterpret_cast<float*>(smem + L.dq);
  const int no = d.widths[d.n_layers - 1], ldy = kLastSkip ? out_dim(d) : no;
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
      dq[idx] = r < n ? dy[r * ldy + idx % no] : 0.f;
    }
    __syncthreads();
    uint32_t* st = scratch + tile * tile_words;
    if constexpr (kStash)
      chain_tile_bwd_tc<kTwoBuffers>(d, w, wt, bias, smem, st, gaux,
                                     EmbedStash{stash, row0, n});
    else
      chain_tile_bwd_tc<kTwoBuffers>(d, w, wt, bias, smem, st, gaux, EmbedSincos{});
  }
}

// K1-bwd's phase 1
template <bool kTwoBuffers>
__global__ void __launch_bounds__(kThreads, 2)
chain_bwd_tc_kernel(ChainDesc d, const float* __restrict__ x, const float* __restrict__ dy,
                    const bf16* __restrict__ w, const bf16* __restrict__ wt,
                    const float* __restrict__ bias, uint32_t* scratch, float* __restrict__ part,
                    long long n) {
  chain_bwd_tc_blocks<kTwoBuffers, false>(d, x, dy, nullptr, w, wt, bias, scratch, part, n);
}

// K1r-bwd's phase 1: K1-bwd's with the embedding's trig columns read from
// the (n, trig_dim) bf16 stash
template <bool kTwoBuffers>
__global__ void __launch_bounds__(kThreads, 2)
chain_stash_bwd_tc_kernel(ChainDesc d, const float* __restrict__ x,
                          const float* __restrict__ dy, const bf16* __restrict__ stash,
                          const bf16* __restrict__ w, const bf16* __restrict__ wt,
                          const float* __restrict__ bias, uint32_t* scratch,
                          float* __restrict__ part, long long n) {
  chain_bwd_tc_blocks<kTwoBuffers, true>(d, x, dy, stash, w, wt, bias, scratch, part, n);
}

// K1w-bwd's phase 1: K1-bwd's, dy's head column read from rows of
// out_dim(d) ([head | embedding])
template <bool kTwoBuffers>
__global__ void __launch_bounds__(kThreads, 2)
chain_last_skip_bwd_tc_kernel(ChainDesc d, const float* __restrict__ x,
                              const float* __restrict__ dy, const bf16* __restrict__ w,
                              const bf16* __restrict__ wt, const float* __restrict__ bias,
                              uint32_t* scratch, float* __restrict__ part, long long n) {
  chain_bwd_tc_blocks<kTwoBuffers, false, true>(d, x, dy, nullptr, w, wt, bias, scratch, part,
                                                n);
}

// K1-bwd's phase 1 for d's widest hidden layer. K1r-bwd's and K1w-bwd's
// have the same launch bounds and shared memory, so the same blocks an SM:
// their launches take the slices this one's occupancy gives
// (nfk_chain_bwd_tc_sizes).
inline auto chain_bwd_tc_for(const ChainDesc& d) {
  return d.max_width > tc::kTcCols ? chain_bwd_tc_kernel<true> : chain_bwd_tc_kernel<false>;
}

// K1w-bwd's dx pass: block b's 64-row tile of the scratch that phase 1
// wrote. The embedding's cotangent de starts as dy's trailing columns;
// then, for each hidden layer that reads the embedding (the skip consumers
// from the highest down, then layer 0), its rounded d_pre, read back from
// the tile's scratch, times the embedding's rows of its W (a tc_gemm, N =
// embed_dim) is added into de in f32 (dx_epilogue's embedding branch):
// chain_tile_bwd's sums of de in its order, posts and d_pre at bf16, d_h
// and de in f32. Then dx of the tile's rows below n from de through the
// trig chain rule (embed_bwd).
__global__ void __launch_bounds__(kThreads, 2)
chain_dx_pass_kernel(ChainDesc d, const float* __restrict__ x, const float* __restrict__ dy,
                     const bf16* __restrict__ w, const uint32_t* __restrict__ scratch,
                     float* __restrict__ dx, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = tc::kTcRows;
  const DxPassLayout L = dx_pass_layout(d);
  const ChainCols cols = chain_cols(d);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* de = reinterpret_cast<float*>(smem + L.de);
  bf16* a = reinterpret_cast<bf16*>(smem + L.a);
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int ne = d.embed_dim, no = d.widths[d.n_layers - 1], ldy = out_dim(d);
  for (int idx = threadIdx.x; idx < R * d.raw_dim; idx += kThreads) {
    const long long r = row0 + idx / d.raw_dim;
    xs[idx] = r < n ? x[r * d.raw_dim + idx % d.raw_dim] : 0.f;
  }
  // The seed: the embedding's own cotangent, dy's trailing columns
  for_tile_cols(R, ne, [&](int r, int c) {
    de[r * L.ldde + c] = row0 + r < n ? dy[(row0 + r) * ldy + no + c] : 0.f;
  });
  const uint32_t* st = scratch + blockIdx.x * static_cast<long long>(kPairs) * cols.total;
  for (int i = d.n_layers - 2; i >= 0; --i) {
    if (i > 0 && !d.skip_after[i - 1]) continue;
    const int k = d.widths[i], prev = i ? d.widths[i - 1] : 0, dcol = cols.dpre[i];
    // Layer i's d_pre, row-major: scratch word (j, c) holds rows 2j and
    // 2j + 1. The previous product's last barrier has passed every read of
    // a, and tc_gemm's first barrier completes these stores
    for_tile_cols(kPairs, k, [&](int j, int c) {
      const uint32_t v = st[j * cols.total + dcol + c];
      a[2 * j * L.lda + c] = __ushort_as_bfloat16(static_cast<unsigned short>(v & 0xffffu));
      a[(2 * j + 1) * L.lda + c] = __ushort_as_bfloat16(static_cast<unsigned short>(v >> 16));
    });
    tc::tc_gemm(tc::TcA{a, L.lda, k, nullptr, 0, 0},
                w + d.w_off[i] + static_cast<long long>(prev) * k, k, ne, ws,
                [&](int c0, const float (&v)[tc::kTcM][4]) {
                  dx_epilogue<bf16>(c0, v, 0, ne, nullptr, nullptr, 0, de, L.ldde);
                });
  }
  __syncthreads();
  embed_bwd<R>(d, xs, de, L.ldde, dx + row0 * d.raw_dim, n - row0);
}

// bf16 K1-bwd, K1r-bwd over `stash` (stash_route) or K1w-bwd (a last-skip
// plan): phase 1, then with dwb the dW pass and its chunk sum and the sum
// of phase 1's slices, then with dx (K1w-bwd only) the dx pass.
int chain_bwd_tc(const ChainDesc& d, const float* x, const float* dy, bool stash_route,
                 const bf16* stash, const bf16* w, const bf16* wt, const float* bias,
                 uint32_t* scratch, float* part, float* dwb, float* dx, int slices, int chunks,
                 long long n, cudaStream_t stream) {
  if (int err = check_chain_tc(d, true)) return err;
  if (slices < 1 || chunks < 1 || (dwb == nullptr && dx == nullptr)) return kErrBadArgs;
  const DwTable tab = chain_dw_table(d);
  float* part_aux = part;
  float* part_dense = part + static_cast<long long>(slices) * chain_n_aux(d);
  const size_t smem = chain_tc_layout(d, true).total;
  const bool two = d.max_width > tc::kTcCols;
  int err;
  if (stash_route)
    err = launch_with_smem(two ? chain_stash_bwd_tc_kernel<true> : chain_stash_bwd_tc_kernel<false>,
                           smem, slices, stream, d, x, dy, stash, w, wt, bias, scratch, part_aux,
                           n);
  else if (last_skip(d))
    err = launch_with_smem(
        two ? chain_last_skip_bwd_tc_kernel<true> : chain_last_skip_bwd_tc_kernel<false>, smem,
        slices, stream, d, x, dy, w, wt, bias, scratch, part_aux, n);
  else
    err = launch_with_smem(chain_bwd_tc_for(d), smem, slices, stream, d, x, dy, w, wt, bias,
                           scratch, part_aux, n);
  if (err) return err;
  if (dwb != nullptr) {
    if (int err = dw_pass<kChainDwTile>(tab, scratch, part_dense, dwb, chunks, n, stream))
      return err;
    if (int err = sum_slices(part_aux, slices, chain_n_aux(d), dwb + tab.n_dense, stream))
      return err;
  }
  if (dx == nullptr) return 0;
  return launch_with_smem(chain_dx_pass_kernel, dx_pass_layout(d).total,
                          (n + tc::kTcRows - 1) / tc::kTcRows, stream, d, x, dy, w, scratch, dx,
                          n);
}

// ------ K1-fwd in bf16 on the tensor cores ------

// K1-fwd: a block a 64-row tile
template <bool kTwoBuffers>
__global__ void __launch_bounds__(kThreads, 2)
chain_fwd_tc_kernel(ChainDesc d, const float* __restrict__ x, const bf16* __restrict__ w,
                    const bf16* __restrict__ wt, const float* __restrict__ bias,
                    float* __restrict__ y, long long n) {
  chain_fwd_tc_block<kTwoBuffers>(d, x, w, wt, bias, y, n, EmbedSincos{});
}

// K1r-fwd: K1-fwd's tile on the stash route's embedding; a non-null stash
// then receives the tile's trig columns (rows below n, bf16), from the
// embedding the products read, which the tile leaves in shared memory.
template <bool kTwoBuffers>
__global__ void __launch_bounds__(kThreads, 2)
chain_stash_fwd_tc_kernel(ChainDesc d, const float* __restrict__ x, const bf16* __restrict__ w,
                          const bf16* __restrict__ wt, const float* __restrict__ bias,
                          float* __restrict__ y, bf16* __restrict__ stash, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  chain_fwd_tc_block<kTwoBuffers>(d, x, w, wt, bias, y, n, EmbedPhase{});
  const ChainTcLayout L = chain_tc_layout(d, false);
  if (stash != nullptr)
    write_stash<bf16, tc::kTcRows>(d, reinterpret_cast<const bf16*>(smem + L.es), L.lde, stash,
                                   static_cast<long long>(blockIdx.x) * tc::kTcRows, n);
}

// K1w-fwd: K1-fwd's tile with y's rows [head | embedding]; the tile's
// embedding, which the tile leaves in shared memory, then goes to the
// trailing columns (write_embed_cols).
template <bool kTwoBuffers>
__global__ void __launch_bounds__(kThreads, 2)
chain_last_skip_fwd_tc_kernel(ChainDesc d, const float* __restrict__ x,
                              const bf16* __restrict__ w, const bf16* __restrict__ wt,
                              const float* __restrict__ bias, float* __restrict__ y,
                              long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  chain_fwd_tc_block<kTwoBuffers, EmbedSincos, true>(d, x, w, wt, bias, y, n, EmbedSincos{});
  const ChainTcLayout L = chain_tc_layout(d, false);
  write_embed_cols(d, reinterpret_cast<const bf16*>(smem + L.es), L.lde, y,
                   static_cast<long long>(blockIdx.x) * tc::kTcRows, n);
}

// bf16 K1-fwd (stash_route false), K1r-fwd or, for a last-skip plan,
// K1w-fwd on the tensor cores: one block a 64-row tile.
int chain_fwd_tc(const ChainDesc& d, const float* x, const bf16* w, const bf16* wt,
                 const float* bias, float* y, bool stash_route, bf16* stash, long long n,
                 cudaStream_t stream) {
  if (int err = check_chain_tc(d, false)) return err;
  const size_t smem = chain_tc_layout(d, false).total;
  const long long blocks = (n + tc::kTcRows - 1) / tc::kTcRows;
  const bool two = d.max_width > tc::kTcCols;
  if (last_skip(d))
    return launch_with_smem(two ? chain_last_skip_fwd_tc_kernel<true>
                                : chain_last_skip_fwd_tc_kernel<false>,
                            smem, blocks, stream, d, x, w, wt, bias, y, n);
  if (stash_route)
    return launch_with_smem(two ? chain_stash_fwd_tc_kernel<true>
                                : chain_stash_fwd_tc_kernel<false>,
                            smem, blocks, stream, d, x, w, wt, bias, y, stash, n);
  return launch_with_smem(two ? chain_fwd_tc_kernel<true> : chain_fwd_tc_kernel<false>, smem,
                          blocks, stream, d, x, w, wt, bias, y, n);
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

// Whether nfk_chain_fwd_tc and nfk_chain_stash_fwd_tc, or for a last-skip
// plan nfk_chain_last_skip_fwd_tc (bwd 0), or nfk_chain_bwd_tc and
// nfk_chain_stash_bwd_tc, or nfk_chain_last_skip_bwd_tc (bwd != 0) run the
// plan (*runs = 1): chain_tc_plan's plans whose blocks fit the card's
// shared memory. The wrapper's rules (ops/fused_mlp.py
// fwd_on_tensor_cores, bwd_on_tensor_cores) ask it; every other plan
// keeps chain_fwd_kernel or chain_bwd_kernel.
int nfk_chain_tc_runs(const nfk::ChainDesc* desc, int bwd, int* runs) {
  if (int err = nfk::check_desc(*desc)) return err;
  *runs = nfk::check_chain_tc(*desc, bwd != 0) == 0;
  return 0;
}

// K1-fwd in bf16 on the tensor cores: y (n, out_dim) f32 from x. w holds
// the bf16 weights (the head's are read), wt each hidden layer's
// transpose, as nfk_chain_bwd_tc takes them.
int nfk_chain_fwd_tc(const nfk::ChainDesc* desc, const float* x, const void* w, const void* wt,
                     const float* bias, float* y, long long n, void* stream) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (nfk::last_skip(*desc)) return nfk::kErrBadPlan;
  if (n <= 0) return 0;
  return nfk::chain_fwd_tc(*desc, x, static_cast<const __nv_bfloat16*>(w),
                           static_cast<const __nv_bfloat16*>(wt), bias, y, false, nullptr, n,
                           static_cast<cudaStream_t>(stream));
}

// K1r-fwd in bf16 on the tensor cores: nfk_chain_fwd_tc on the stash
// route's embedding; a non-null stash (n, trig_dim) bf16 receives its trig
// columns, the values nfk_chain_fwd's stash route writes.
int nfk_chain_stash_fwd_tc(const nfk::ChainDesc* desc, const float* x, const void* w,
                           const void* wt, const float* bias, float* y, void* stash, long long n,
                           void* stream) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (nfk::last_skip(*desc)) return nfk::kErrBadPlan;
  if (n <= 0) return 0;
  return nfk::chain_fwd_tc(*desc, x, static_cast<const __nv_bfloat16*>(w),
                           static_cast<const __nv_bfloat16*>(wt), bias, y, true,
                           static_cast<__nv_bfloat16*>(stash), n,
                           static_cast<cudaStream_t>(stream));
}

// K1w-fwd in bf16 on the tensor cores, for a plan with a skip after its
// last layer: y (n, out_dim) f32, [head | embedding], the embedding's
// columns the bf16 values the products read (nfk_chain_fwd's, bit for
// bit); w and wt as nfk_chain_fwd_tc takes them.
int nfk_chain_last_skip_fwd_tc(const nfk::ChainDesc* desc, const float* x, const void* w,
                               const void* wt, const float* bias, float* y, long long n,
                               void* stream) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (!nfk::last_skip(*desc)) return nfk::kErrBadPlan;
  if (n <= 0) return 0;
  return nfk::chain_fwd_tc(*desc, x, static_cast<const __nv_bfloat16*>(w),
                           static_cast<const __nv_bfloat16*>(wt), bias, y, false, nullptr, n,
                           static_cast<cudaStream_t>(stream));
}

// The buffers nfk_chain_bwd_tc (and nfk_chain_stash_bwd_tc,
// nfk_chain_last_skip_bwd_tc) needs for n rows, which the wrapper
// allocates: a scratch of `scratch` bf16 values; the transposed hidden
// weights, `wt` bf16 values; part of slices x n_aux + chunks x n_dense
// floats (n_aux: the head's dW and every bias; n_dense: the hidden dW).
int nfk_chain_bwd_tc_sizes(const nfk::ChainDesc* desc, long long n, long long* scratch,
                           long long* wt, int* slices, int* chunks) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (int err = nfk::check_chain_tc(*desc, true)) return err;
  *scratch = *wt = 0;
  *slices = *chunks = 0;
  if (n <= 0) return 0;
  const long long tiles = (n + nfk::tc::kTcRows - 1) / nfk::tc::kTcRows;
  *scratch = tiles * nfk::tc::kTcRows * nfk::chain_cols(*desc).total;
  *wt = nfk::chain_wt_offset(*desc, desc->n_layers - 1);
  *chunks = nfk::dw_chunks(n);
  return nfk::dw_slices(nfk::chain_bwd_tc_for(*desc), nfk::chain_tc_layout(*desc, true).total, tiles,
                        slices);
}

// K1-bwd in bf16 with dW only, on the tensor cores: dW/db of every layer
// into dwb (packed like w then bias, f32) over the buffers of
// nfk_chain_bwd_tc_sizes. w holds the bf16 weights, wt each hidden
// layer's transpose (n x (round16(k1) + round16(k2)), zero-padded
// segments).
int nfk_chain_bwd_tc(const nfk::ChainDesc* desc, const float* x, const float* dy, const void* w,
                     const void* wt, const float* bias, void* scratch, float* part, float* dwb,
                     int slices, int chunks, long long n, void* stream) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (nfk::last_skip(*desc)) return nfk::kErrBadPlan;
  if (n <= 0) return 0;
  return nfk::chain_bwd_tc(*desc, x, dy, false, nullptr, static_cast<const __nv_bfloat16*>(w),
                           static_cast<const __nv_bfloat16*>(wt), bias,
                           static_cast<uint32_t*>(scratch), part, dwb, nullptr, slices, chunks,
                           n, static_cast<cudaStream_t>(stream));
}

// K1r-bwd in bf16 with dW only, on the tensor cores: nfk_chain_bwd_tc with
// the embedding's trig columns read from `stash` (n, trig_dim) bf16, which
// a plan with trig columns must give; the same buffers
// (nfk_chain_bwd_tc_sizes).
int nfk_chain_stash_bwd_tc(const nfk::ChainDesc* desc, const float* x, const float* dy,
                           const void* stash, const void* w, const void* wt, const float* bias,
                           void* scratch, float* part, float* dwb, int slices, int chunks,
                           long long n, void* stream) {
  if (int err = nfk::check_desc(*desc)) return err;
  if ((stash == nullptr && nfk::trig_dim(*desc) > 0) || nfk::last_skip(*desc))
    return nfk::kErrBadPlan;
  if (n <= 0) return 0;
  return nfk::chain_bwd_tc(*desc, x, dy, true, static_cast<const __nv_bfloat16*>(stash),
                           static_cast<const __nv_bfloat16*>(w),
                           static_cast<const __nv_bfloat16*>(wt), bias,
                           static_cast<uint32_t*>(scratch), part, dwb, nullptr, slices, chunks,
                           n, static_cast<cudaStream_t>(stream));
}

// K1w-bwd in bf16 on the tensor cores, for a plan with a skip after its
// last layer and dy (n, out_dim), [head | embedding]: phase 1 over the
// buffers of nfk_chain_bwd_tc_sizes, then with a non-null dwb the dW pass
// (dW/db of every layer, as nfk_chain_bwd_tc's), with a non-null dx (n,
// raw_dim) the dx pass; one of the two must be given. w and wt as
// nfk_chain_bwd_tc takes them.
int nfk_chain_last_skip_bwd_tc(const nfk::ChainDesc* desc, const float* x, const float* dy,
                               const void* w, const void* wt, const float* bias, void* scratch,
                               float* part, float* dwb, float* dx, int slices, int chunks,
                               long long n, void* stream) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (!nfk::last_skip(*desc)) return nfk::kErrBadPlan;
  if (n <= 0) return 0;
  return nfk::chain_bwd_tc(*desc, x, dy, false, nullptr, static_cast<const __nv_bfloat16*>(w),
                           static_cast<const __nv_bfloat16*>(wt), bias,
                           static_cast<uint32_t*>(scratch), part, dwb, dx, slices, chunks, n,
                           static_cast<cudaStream_t>(stream));
}

// The dense layers of the scratch (nfk_chain_bwd_tc_sizes' layout: every
// hidden layer) and the dW pass's tile over them, for nfk_dw_pass and the
// wrapper's transposed weights.
int nfk_chain_dw_table(const nfk::ChainDesc* desc, nfk::DwTable* tab, int* tile) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (int err = nfk::check_chain_tc(*desc, true)) return err;
  *tab = nfk::chain_dw_table(*desc);
  *tile = nfk::kChainDwTile;
  return 0;
}

// The dW pass alone, K1-bwd's and K3-bwd's, over a scratch of n rows laid
// out as a table of nfk_chain_dw_table or nfk_nerf_dw_table says, with its
// tile: the dense dW (tab->n_dense floats) into dw, from the row chunks'
// partials in part (kMaxDwChunks x n_dense floats).
int nfk_dw_pass(const nfk::DwTable* tab, int tile, const void* scratch, float* part, float* dw,
                long long n, void* stream) {
  if (tab->n_layers < 1 || tab->n_layers > nfk::kMaxDense) return nfk::kErrBadArgs;
  if (n <= 0) return 0;
  const uint32_t* s = static_cast<const uint32_t*>(scratch);
  const int chunks = nfk::dw_chunks(n);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 64) return nfk::dw_pass<64>(*tab, s, part, dw, chunks, n, st);
  if (tile == 128) return nfk::dw_pass<128>(*tab, s, part, dw, chunks, n, st);
  return nfk::kErrBadArgs;
}

}  // extern "C"
