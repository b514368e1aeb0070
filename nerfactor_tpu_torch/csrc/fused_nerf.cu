// Kernels K3-fwd and K3-bwd: the branched NeRF field.
//
// K3-fwd replaces the TPU kernel nerfactor_tpu/ops/pallas_nerf.py
// _forward -> _fwd_kernel. Per sample point, posenc(xyz) feeds a ReLU trunk
// (nerf.ini: 8 x 256, the embedding concatenated after layer 4); the trunk
// feeds a 1-wide sigma head and a linear bottleneck; [bottleneck |
// posenc(view)] feeds a ReLU layer (128) and a 3-wide rgb head. Outputs:
// rgb (n, 3) and sigma (n, 1), f32.
//
// K3-bwd replaces _backward -> _bwd_kernel: it recomputes a row tile's
// forward and returns dW and db of every layer from d_rgb and d_sigma.
// There is no input cotangent: the points and view directions are data.
// d_h stays f32; in bf16 mode each dense layer's d_pre is rounded to bf16
// before its products, db is the column sum of the unrounded d_pre, and
// the two tiny heads (sigma, rgb) stay f32 dot products per row, as the
// TPU kernel's VPU heads; their weights stay f32.
//
// What bounds K3 on Hopper: arithmetic. At nerf.ini width a row takes
// ~593k multiply-adds forward (~1.74M backward) against 24 B in and 16 B
// out, far above the card's operations-per-byte ridge.
//
// K3-fwd in bf16: nerf_fwd_tc_kernel, the forward half of bf16 K3-bwd's
// phase 1 below (nerf_field_tc, one loop for both), without the scratch:
// a block a 64-row tile, two blocks an SM, the trunk, the bottleneck and
// rgb layer 0 as tensor-core products of the tile's rows in shared memory,
// each epilogue writing bf16(act(v + b)) over its operand, and the two
// tiny heads in f32 on the CUDA cores (head_sums, 4 lanes a row and
// column). It rounds where the CUDA-core bf16 kernel does (posts, the
// bottleneck and the rgb hidden layer at bf16; heads in f32 from them);
// only the order of the sums moves. What bounds it is what bounds phase 1:
// the weight ring's barrier every 32 K and the epilogues, not the tensor
// cores' rate.
//
// K3-fwd in f32, and K3-bwd in f32: K1's design (chain_mlp.cuh, whose
// device code they reuse). A block owns a row tile; both embeddings and all
// activations of the tile stay in shared memory; each dense layer streams
// its weights through a shared-memory tile, the skip consumer and rgb
// layer 0 reading two K segments ([h | e], [bottleneck | e_view]).
// Products run on the CUDA cores in f32 from f32 or bf16 operands. The f32
// backward keeps 8 trunk posts, the bottleneck, both embeddings and two
// f32 cotangent rows per row in shared memory (16 rows fit a block) and
// adds each tile's dW/db into its block's f32 slice of a scratch buffer
// (~2.4 MB a slice at nerf.ini width); sum_slices adds the slices in slice
// order.
//
// K3-bwd in bf16: two launches on the tensor cores (mma.sync m16n8k16,
// bf16 operands, f32 accumulation; mma_bf16.cuh) and fixed-order sums.
//   1. nerf_bwd_tc_kernel, one 64-row tile at a time: the forward
//      recompute (trunk, bottleneck, rgb layer 0) and every d_pre @ W^T
//      as tensor-core products of the tile's rows in shared memory, the
//      weights streamed through a three-stage cp.async ring (transposed
//      weights for the recompute, W itself for d_pre @ W^T). It writes
//      each dense layer's input columns and its rounded d_pre to a bf16
//      scratch in device memory (nerf.ini: 9,664 B a row, row pairs
//      interleaved), and adds to its block's small f32 slice only the db
//      of every layer, the sigma head's dW/db and rgb layer 1's (n_aux
//      floats, ~3K). Each product's epilogue works in registers and in
//      place: it writes its result over its own operand, stores the
//      scratch words, and in the backward forms the next layer's d_pre
//      (act' from the post it reads back from the scratch, still in the
//      L2; db from warp-shuffle column sums; the rounding). So the tile
//      needs one activation buffer and no f32 cotangent in shared memory
//      (~112 KB; a trunk wider than 256, which takes two column passes a
//      product, needs a second buffer). What bounds phase 1 is not the
//      tensor cores' rate but the weight stream: each streamed weight serves the tile's 64 rows,
//      and each 32-deep stage of the ring costs a barrier. Two blocks
//      share an SM, so one's waits overlap the other's products (ptxas
//      caps phase 1 at 128 registers for that).
//   2. dw_kernel (mma_bf16.cuh, shared with bf16 K1-bwd): dW = X^T D of
//      every dense layer over all rows, a plain GEMM over the scratch. A
//      block owns one 128 x 128 tile of one layer's dW in registers over
//      one of a fixed number of row chunks;
//      the skip consumer's [h | e_xyz] and rgb layer 0's [bottleneck |
//      e_view] are two segments of its K. Its partials (chunks x the dense
//      weights, f32; ~16 MB at 8 chunks) stay in the L2, where sum_slices
//      adds them in chunk order.
// The mma K step is 16, so the trunk and rgb hidden widths are multiples
// of 16 (check_nerf_tc; the wrapper zero-pads other widths up to them).
// No float atomicAdd anywhere: dW/db are bit-identical across launches.
// The bytes: phase 1 writes the scratch once (~1.9 GB at 196,608 rows) and
// the dW pass reads each column once per 128-wide tile of the layer it
// feeds; the products, ~2.7x the forward's, sit on the tensor cores.
//
// Inputs: pts, views (n, 3) f32 row-major. Dense weights (trunk layers,
// bottleneck, rgb layer 0) packed in JAX layout (w is (din, dout), applied
// as x @ w) at type T, and for the bf16 kernels each one's transpose
// (dout x (round16(k1) + round16(k2)), zero-padded segments); the heads'
// weights and all biases in one f32 "aux" buffer. dW/db come back packed
// as [dense | aux], f32.

#include "chain_mlp.cuh"
#include "mma_bf16.cuh"

namespace nfk {

// Static description of one NeRF field. The Python wrapper fills it in with
// the same field order (nerfactor_tpu_torch/ops/fused_nerf.py, NerfDesc).
struct NerfDesc {
  ChainDesc trunk;  // the trunk's hidden layers over the xyz embedding
  ChainDesc view;   // the view embedding (n_parts, part_*, raw_dim, embed_dim)
  int rgb_hidden, rgb_out;
  int rgb_acts[2];
  long long bott_w, rgb0_w;  // offsets into the dense weights (type T)
  long long sigma_w, sigma_b, bott_b, rgb0_b, rgb1_w, rgb1_b;  // into aux (f32)
  long long n_dense, n_aux;
};

inline int check_nerf(const NerfDesc& d) {
  if (int err = check_desc(d.trunk)) return err;
  if (last_skip(d.trunk)) return kErrBadPlan;
  if (d.trunk.n_parts != 1 || d.trunk.raw_dim != 3) return kErrBadPlan;
  if (d.view.n_parts != 1 || d.view.raw_dim != 3) return kErrBadPlan;
  if (d.rgb_out < 1 || d.rgb_out > kMaxHeadOut || d.rgb_hidden < 1) return kErrBadPlan;
  // One width through the trunk and the bottleneck; the rgb hidden layer
  // no wider (it borrows a cotangent buffer in the backward)
  for (int i = 0; i < d.trunk.n_layers; ++i)
    if (d.trunk.widths[i] != d.trunk.widths[0]) return kErrBadPlan;
  if (d.rgb_hidden > d.trunk.widths[0]) return kErrBadPlan;
  return 0;
}

__host__ __device__ inline int trunk_width(const NerfDesc& d) { return d.trunk.widths[0]; }

// Shared-memory layout of a forward block: raw points and views (f32) |
// xyz and view embeddings (T) | two ping-pong activation buffers (T) |
// weight tile (T).
struct NerfFwdLayout {
  size_t xp, xv, es, ev, ha, hb, ws, total;
  int lde, ldv, ldh;
};

template <typename T>
__host__ __device__ inline NerfFwdLayout nerf_fwd_layout(const NerfDesc& d) {
  NerfFwdLayout s;
  s.lde = padded_ld(d.trunk.embed_dim);
  s.ldv = padded_ld(d.view.embed_dim);
  s.ldh = padded_ld(trunk_width(d));
  s.xp = 0;
  s.xv = align16(s.xp + sizeof(float) * kRows * 3);
  s.es = align16(s.xv + sizeof(float) * kRows * 3);
  s.ev = align16(s.es + sizeof(T) * kRows * s.lde);
  s.ha = align16(s.ev + sizeof(T) * kRows * s.ldv);
  s.hb = align16(s.ha + sizeof(T) * kRows * s.ldh);
  s.ws = align16(s.hb + sizeof(T) * kRows * s.ldh);
  s.total = align16(s.ws + sizeof(T) * kKTile * kColChunk);
  return s;
}

// Shared-memory layout of an f32 backward block: raw points and views |
// output cotangents [d_rgb | d_sigma] | embeddings | every trunk post |
// bottleneck | two cotangent buffers | transposed weight tile, all f32.
// The rgb hidden layer (ld ldo) borrows the second cotangent buffer.
struct NerfBwdLayout {
  size_t xp, xv, dout, es, ev, posts, bott, da, db, ws, total;
  int lde, ldv, ldh, ldd, ldo, ldq, post_stride;
};

template <int ROWS>
__host__ __device__ inline NerfBwdLayout nerf_bwd_layout(const NerfDesc& d) {
  NerfBwdLayout s;
  s.lde = padded_ld(d.trunk.embed_dim);
  s.ldv = padded_ld(d.view.embed_dim);
  s.ldh = padded_ld(trunk_width(d));
  s.ldd = s.ldh;
  s.ldo = padded_ld(d.rgb_hidden);
  s.ldq = d.rgb_out + 1;
  s.post_stride = ROWS * s.ldh;
  s.xp = 0;
  s.xv = align16(s.xp + sizeof(float) * ROWS * 3);
  s.dout = align16(s.xv + sizeof(float) * ROWS * 3);
  s.es = align16(s.dout + sizeof(float) * ROWS * s.ldq);
  s.ev = align16(s.es + sizeof(float) * ROWS * s.lde);
  s.posts = align16(s.ev + sizeof(float) * ROWS * s.ldv);
  s.bott = align16(s.posts + sizeof(float) * d.trunk.n_layers * s.post_stride);
  s.da = align16(s.bott + sizeof(float) * ROWS * s.ldh);
  s.db = align16(s.da + sizeof(float) * ROWS * s.ldd);
  s.ws = align16(s.db + sizeof(float) * ROWS * s.ldd);
  s.total = align16(s.ws + sizeof(float) * kKTile * kLdT);
  return s;
}

// The f32 backward's row tile: 32 rows where they fit the block's opt-in
// shared memory, else 16; 0 if neither fits.
inline int nerf_bwd_rows(const NerfDesc& d, int max_smem) {
  if (nerf_bwd_layout<32>(d).total <= static_cast<size_t>(max_smem)) return 32;
  if (nerf_bwd_layout<16>(d).total <= static_cast<size_t>(max_smem)) return 16;
  return 0;
}

// `cols`-wide f32 rows [row0, row0 + ROWS) of `src` into `dst`, zeros past n.
template <int ROWS>
__device__ void load_rows(const float* __restrict__ src, int cols, long long row0,
                          long long n, float* dst) {
  for (int idx = threadIdx.x; idx < ROWS * cols; idx += kThreads) {
    const long long r = row0 + idx / cols;
    dst[idx] = r < n ? src[r * cols + idx % cols] : 0.f;
  }
}

// A tiny head, out = act(h @ w + b), n_out <= kMaxHeadOut columns, in f32
// from the T-valued rows h (ld ldh, k wide); w (k, n_out) and b f32. Rows
// below n_valid go to `out` (n_out columns, row-major).
template <typename T, int ROWS>
__device__ void tiny_head(const T* h, int ldh, int k, const float* __restrict__ w,
                          const float* __restrict__ b, int n_out, int act,
                          float* __restrict__ out, long long n_valid) {
  for (int idx = threadIdx.x; idx < ROWS * n_out; idx += kThreads) {
    const int r = idx / n_out, c = idx % n_out;
    if (r >= n_valid) continue;
    float s = 0.f;
    for (int j = 0; j < k; ++j) s = fmaf(to_f<T>(h[r * ldh + j]), w[j * n_out + c], s);
    out[r * n_out + c] = activate(act, s + b[c]);
  }
}

// The trunk over the embedding `es`. With post_stride > 0 layer i's
// post-activation goes to buf0 + i * post_stride (the backward keeps them
// all), else to buf0 and buf1 in turn. Returns the last layer's buffer;
// ends at a barrier.
template <typename T, int ROWS>
__device__ const T* trunk_fwd(const ChainDesc& d, const T* es, int lde, const T* __restrict__ w,
                              const float* __restrict__ bias, T* ws, T* buf0, T* buf1,
                              int post_stride, int ldh) {
  const T* in = es;
  int ld_in = lde, k_in = d.embed_dim;
  for (int i = 0; i < d.n_layers; ++i) {
    const bool skip_in = i > 0 && d.skip_after[i - 1];
    T* out = post_stride > 0 ? buf0 + i * post_stride : (i & 1 ? buf1 : buf0);
    layer_pass<T, ROWS>(in, ld_in, k_in, skip_in ? es : nullptr, lde,
                        skip_in ? d.embed_dim : 0, w + d.w_off[i], bias + d.b_off[i],
                        d.widths[i], d.acts[i], ws, out, ldh, nullptr, 0, ROWS);
    in = out;
    ld_in = ldh;
    k_in = d.widths[i];
  }
  __syncthreads();
  return in;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
nerf_fwd_kernel(NerfDesc d, const float* __restrict__ pts, const float* __restrict__ views,
                const T* __restrict__ w, const float* __restrict__ aux,
                float* __restrict__ rgb, float* __restrict__ sigma, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const NerfFwdLayout L = nerf_fwd_layout<T>(d);
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  float* xp = reinterpret_cast<float*>(smem + L.xp);
  float* xv = reinterpret_cast<float*>(smem + L.xv);
  T* es = reinterpret_cast<T*>(smem + L.es);
  T* ev = reinterpret_cast<T*>(smem + L.ev);
  T* ha = reinterpret_cast<T*>(smem + L.ha);
  T* hb = reinterpret_cast<T*>(smem + L.hb);
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  const int width = trunk_width(d);
  load_rows<kRows>(pts, 3, row0, n, xp);
  load_rows<kRows>(views, 3, row0, n, xv);
  __syncthreads();
  embed_rows<T>(d.trunk, xp, es, L.lde);
  embed_rows<T>(d.view, xv, ev, L.ldv);
  __syncthreads();
  T* feat = const_cast<T*>(trunk_fwd<T, kRows>(d.trunk, es, L.lde, w, aux, ws, ha, hb, 0,
                                               L.ldh));
  T* bott = feat == ha ? hb : ha;
  tiny_head<T, kRows>(feat, L.ldh, width, aux + d.sigma_w, aux + d.sigma_b, 1, kNone,
                      sigma + row0, n - row0);
  layer_pass<T>(feat, L.ldh, width, nullptr, 0, 0, w + d.bott_w, aux + d.bott_b, width, kNone,
                ws, bott, L.ldh, nullptr, 0, kRows);
  // The rgb hidden layer overwrites the trunk's output: the barriers of its
  // K loop follow the sigma head's reads
  layer_pass<T>(bott, L.ldh, width, ev, L.ldv, d.view.embed_dim, w + d.rgb0_w,
                aux + d.rgb0_b, d.rgb_hidden, d.rgb_acts[0], ws, feat, L.ldh, nullptr, 0,
                kRows);
  __syncthreads();
  tiny_head<T, kRows>(feat, L.ldh, d.rgb_hidden, aux + d.rgb1_w, aux + d.rgb1_b, d.rgb_out,
                      d.rgb_acts[1], rgb + row0 * d.rgb_out, n - row0);
}

// The f32 backward for one tile on the CUDA cores: points, views and the
// output cotangents [d_rgb | d_sigma] are in shared memory. Adds the
// tile's dW/db into `slice` (dense part first, then aux).
template <int ROWS>
__device__ void nerf_tile_bwd(const NerfDesc& d, const float* __restrict__ w,
                              const float* __restrict__ aux, unsigned char* smem, float* slice) {
  const NerfBwdLayout L = nerf_bwd_layout<ROWS>(d);
  const ChainDesc& tr = d.trunk;
  const float* xp = reinterpret_cast<const float*>(smem + L.xp);
  const float* xv = reinterpret_cast<const float*>(smem + L.xv);
  float* dout = reinterpret_cast<float*>(smem + L.dout);
  float* es = reinterpret_cast<float*>(smem + L.es);
  float* ev = reinterpret_cast<float*>(smem + L.ev);
  float* posts = reinterpret_cast<float*>(smem + L.posts);
  float* bott = reinterpret_cast<float*>(smem + L.bott);
  float* da = reinterpret_cast<float*>(smem + L.da);
  float* db = reinterpret_cast<float*>(smem + L.db);
  float* h0 = reinterpret_cast<float*>(smem + L.db);
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  float* gaux = slice + d.n_dense;
  const int width = trunk_width(d), hr = d.rgb_hidden, no = d.rgb_out, ldq = L.ldq;
  const int nv = d.view.embed_dim;
  // Forward recompute, every activation kept
  embed_rows<float, ROWS>(tr, xp, es, L.lde);
  embed_rows<float, ROWS>(d.view, xv, ev, L.ldv);
  __syncthreads();
  const float* feat = trunk_fwd<float, ROWS>(tr, es, L.lde, w, aux, ws, posts, nullptr,
                                             L.post_stride, L.ldh);
  layer_pass<float, ROWS>(feat, L.ldh, width, nullptr, 0, 0, w + d.bott_w, aux + d.bott_b,
                          width, kNone, ws, bott, L.ldh, nullptr, 0, ROWS);
  layer_pass<float, ROWS>(bott, L.ldh, width, ev, L.ldv, nv, w + d.rgb0_w, aux + d.rgb0_b, hr,
                          d.rgb_acts[0], ws, h0, L.ldo, nullptr, 0, ROWS);
  __syncthreads();
  // rgb head (tiny, f32): d_pre in place of d_rgb
  const float* w1 = aux + d.rgb1_w;
  if (d.rgb_acts[1] != kNone) {
    for (int idx = threadIdx.x; idx < ROWS * no; idx += kThreads) {
      const int r = idx / no, c = idx % no;
      float s = aux[d.rgb1_b + c];
      for (int k = 0; k < hr; ++k) s = fmaf(h0[r * L.ldo + k], w1[k * no + c], s);
      dout[r * ldq + c] = activate_bwd(d.rgb_acts[1], activate(d.rgb_acts[1], s),
                                       dout[r * ldq + c]);
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < no; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < ROWS; ++r) s += dout[r * ldq + c];
    gaux[d.rgb1_b + c] += s;
  }
  for (int idx = threadIdx.x; idx < hr * no; idx += kThreads) {
    const int k = idx / no, c = idx % no;
    float s = 0.f;
    for (int r = 0; r < ROWS; ++r) s = fmaf(h0[r * L.ldo + k], dout[r * ldq + c], s);
    gaux[d.rgb1_w + idx] += s;
  }
  // rgb layer 0's d_pre = act'(h0) * (d_pre1 @ w1^T), into da
  for (int idx = threadIdx.x; idx < ROWS * hr; idx += kThreads) {
    const int r = idx / hr, k = idx % hr;
    float g = 0.f;
    for (int c = 0; c < no; ++c) g = fmaf(dout[r * ldq + c], w1[k * no + c], g);
    da[r * L.ldd + k] = activate_bwd(d.rgb_acts[0], h0[r * L.ldo + k], g);
  }
  __syncthreads();
  // rgb layer 0, [bottleneck | e_view] -> hr: d_bottleneck into db (h0 is done)
  dense_bwd<float, ROWS>(da, L.ldd, hr, bott, L.ldh, width, ev, L.ldv, nv, w + d.rgb0_w,
                         slice + d.rgb0_w, gaux + d.rgb0_b, width, width, ws, db, nullptr, 0);
  // bottleneck (linear): d_h of the trunk's output into da
  dense_bwd<float, ROWS>(db, L.ldd, width, feat, L.ldh, width, nullptr, 0, 0, w + d.bott_w,
                         slice + d.bott_w, gaux + d.bott_b, width, width, ws, da, nullptr, 0);
  // sigma head (tiny, f32, linear): its db and dW, and d_h += d_sigma w^T
  const float* dsig = dout + no;
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int r = 0; r < ROWS; ++r) s += dsig[r * ldq];
    gaux[d.sigma_b] += s;
  }
  for (int k = threadIdx.x; k < width; k += kThreads) {
    float s = 0.f;
    for (int r = 0; r < ROWS; ++r) s = fmaf(feat[r * L.ldh + k], dsig[r * ldq], s);
    gaux[d.sigma_w + k] += s;
  }
  for (int idx = threadIdx.x; idx < ROWS * width; idx += kThreads) {
    const int r = idx / width, k = idx % width;
    da[r * L.ldd + k] = fmaf(dsig[r * ldq], aux[d.sigma_w + k], da[r * L.ldd + k]);
  }
  __syncthreads();
  // The trunk, from its last layer
  float* dcur = da;
  float* dnext = db;
  for (int i = tr.n_layers - 1; i >= 0; --i) {
    const int n = tr.widths[i];
    const float* post = posts + i * L.post_stride;
    for (int idx = threadIdx.x; idx < ROWS * n; idx += kThreads) {
      const int r = idx / n, c = idx % n;
      dcur[r * L.ldd + c] = activate_bwd(tr.acts[i], post[r * L.ldh + c],
                                         dcur[r * L.ldd + c]);
    }
    __syncthreads();
    const bool skip_in = i > 0 && tr.skip_after[i - 1];
    const int hw = i > 0 ? tr.widths[i - 1] : 0;
    dense_bwd<float, ROWS>(dcur, L.ldd, n, i > 0 ? post - L.post_stride : es,
                           i > 0 ? L.ldh : L.lde, i > 0 ? hw : tr.embed_dim,
                           skip_in ? es : nullptr, L.lde, skip_in ? tr.embed_dim : 0,
                           w + tr.w_off[i], slice + tr.w_off[i], gaux + tr.b_off[i], hw, hw, ws,
                           dnext, nullptr, 0);
    float* t = dcur;
    dcur = dnext;
    dnext = t;
  }
}

template <int ROWS>
__global__ void __launch_bounds__(kThreads)
nerf_bwd_kernel(NerfDesc d, const float* __restrict__ pts, const float* __restrict__ views,
                const float* __restrict__ drgb, const float* __restrict__ dsigma,
                const float* __restrict__ w, const float* __restrict__ aux,
                float* __restrict__ part, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const NerfBwdLayout L = nerf_bwd_layout<ROWS>(d);
  const long long stride = d.n_dense + d.n_aux;
  float* slice = part + blockIdx.x * stride;
  for (long long j = threadIdx.x; j < stride; j += kThreads) slice[j] = 0.f;
  float* xp = reinterpret_cast<float*>(smem + L.xp);
  float* xv = reinterpret_cast<float*>(smem + L.xv);
  float* dout = reinterpret_cast<float*>(smem + L.dout);
  const int no = d.rgb_out, ldq = L.ldq;
  const long long n_tiles = (n + ROWS - 1) / ROWS;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * ROWS;
    load_rows<ROWS>(pts, 3, row0, n, xp);
    load_rows<ROWS>(views, 3, row0, n, xv);
    // Padding rows get a zero cotangent, so they add nothing to dW/db
    for (int idx = threadIdx.x; idx < ROWS * ldq; idx += kThreads) {
      const long long r = row0 + idx / ldq;
      const int c = idx % ldq;
      dout[idx] = r >= n ? 0.f : (c < no ? drgb[r * no + c] : dsigma[r]);
    }
    __syncthreads();
    nerf_tile_bwd<ROWS>(d, w, aux, smem, slice);
  }
}

// ------ K3-bwd in bf16: phase 1 and the dW pass on the tensor cores ------

// Columns of a scratch row (mma_bf16.cuh's row-paired scratch): every
// dense layer's inputs (e_xyz, the trunk posts, the bottleneck, e_view;
// the embeddings zero-padded to 16 columns), then every dense layer's
// rounded d_pre (trunk layers, bottleneck, rgb layer 0).
struct NerfCols {
  int es, post0, bott, ev, dpre0, dpre_bott, dpre_rgb0, total;
};

__host__ __device__ inline NerfCols nerf_cols(const NerfDesc& d) {
  const int w = trunk_width(d), nl = d.trunk.n_layers;
  NerfCols c;
  c.es = 0;
  c.post0 = round16(d.trunk.embed_dim);
  c.bott = c.post0 + nl * w;
  c.ev = c.bott + w;
  c.dpre0 = c.ev + round16(d.view.embed_dim);
  c.dpre_bott = c.dpre0 + nl * w;
  c.dpre_rgb0 = c.dpre_bott + w;
  c.total = c.dpre_rgb0 + d.rgb_hidden;
  return c;
}

// Dense layer i of the field: trunk layers 0 .. n_layers - 1, the
// bottleneck, rgb layer 0 (the dW pass's DenseLayer).
__host__ __device__ inline int n_dense_layers(const NerfDesc& d) { return d.trunk.n_layers + 2; }

__host__ __device__ inline DenseLayer dense_layer(const NerfDesc& d, int i) {
  const NerfCols c = nerf_cols(d);
  const ChainDesc& tr = d.trunk;
  const int w = trunk_width(d), nl = tr.n_layers;
  DenseLayer l;
  l.seg2 = c.es;
  l.k2 = 0;
  l.n = w;
  if (i < nl) {
    l.seg1 = i == 0 ? c.es : c.post0 + (i - 1) * w;
    l.k1 = i == 0 ? tr.embed_dim : w;
    if (i > 0 && tr.skip_after[i - 1]) l.k2 = tr.embed_dim;
    l.dpre = c.dpre0 + i * w;
    l.w_off = tr.w_off[i];
  } else if (i == nl) {
    l.seg1 = c.post0 + (nl - 1) * w;
    l.k1 = w;
    l.dpre = c.dpre_bott;
    l.w_off = d.bott_w;
  } else {
    l.seg1 = c.bott;
    l.k1 = w;
    l.seg2 = c.ev;
    l.k2 = d.view.embed_dim;
    l.dpre = c.dpre_rgb0;
    l.n = d.rgb_hidden;
    l.w_off = d.rgb0_w;
  }
  return l;
}

// Offset of dense layer i's transpose in the transposed weights: each
// layer's W^T is (n, round16(k1) + round16(k2)), its segments zero-padded.
__host__ __device__ inline long long wt_offset(const NerfDesc& d, int i) {
  long long off = 0;
  for (int j = 0; j < i; ++j) {
    const DenseLayer l = dense_layer(d, j);
    off += static_cast<long long>(l.n) * (round16(l.k1) + round16(l.k2));
  }
  return off;
}

// Shared-memory layout of a tensor-core block: raw points and views (f32)
// | output cotangents [d_rgb | d_sigma] (f32, the backward's phase 1 only)
// | embeddings (bf16) | one activation buffer (bf16) | the ring of weight
// stages. The buffer holds, in turn, each trunk post, the bottleneck, the
// rgb hidden layer and, in the backward, each rounded d_pre: every
// product's epilogue writes its result over its own operand, which the
// product has finished reading. ~112 KB at nerf.ini width, so that two
// blocks share an SM. A trunk wider than one tc_gemm pass (kTcCols) reads
// each operand once a pass, so it gets a second buffer (h2; h2 == h
// otherwise) and each product writes the other one.
struct NerfTcLayout {
  size_t xp, xv, dout, es, ev, h, h2, ws, total;
  int lde, ldv, ldh, ldq;
};

__host__ __device__ inline NerfTcLayout nerf_tc_layout(const NerfDesc& d, bool bwd) {
  constexpr int R = tc::kTcRows;
  NerfTcLayout s;
  s.lde = tc::tc_ld(d.trunk.embed_dim);
  s.ldv = tc::tc_ld(d.view.embed_dim);
  s.ldh = tc::tc_ld(trunk_width(d));
  s.ldq = d.rgb_out + 1;
  s.xp = 0;
  s.xv = align16(s.xp + sizeof(float) * R * 3);
  s.dout = align16(s.xv + sizeof(float) * R * 3);
  s.es = align16(s.dout + (bwd ? sizeof(float) * R * s.ldq : 0));
  s.ev = align16(s.es + sizeof(bf16) * R * s.lde);
  s.h = align16(s.ev + sizeof(bf16) * R * s.ldv);
  s.h2 = trunk_width(d) > tc::kTcCols ? align16(s.h + sizeof(bf16) * R * s.ldh) : s.h;
  s.ws = align16(s.h2 + sizeof(bf16) * R * s.ldh);
  s.total = align16(s.ws + sizeof(bf16) * tc::kTcStages * tc::kTcStage);
  return s;
}

// The tensor-core forward (bwd false) and backward (bwd true) take widths
// that are multiples of 16 (the mma K step) and a layout that fits the
// block's shared memory.
inline int check_nerf_tc(const NerfDesc& d, bool bwd) {
  if (trunk_width(d) % 16 || d.rgb_hidden % 16) return kErrBadPlan;
  if (nerf_tc_layout(d, bwd).total > static_cast<size_t>(max_smem_optin())) return kErrSmem;
  return 0;
}

// The field's forward on the tensor cores for one 64-row tile whose points
// and views are in shared memory (layout L): both embeddings, zero-padded
// to 16 columns; the trunk, each layer a tc_gemm over the transposed
// weights, the skip consumer's A [h | e_xyz]; after the trunk a barrier
// and between(h), which every thread calls with the trunk's output and
// which must finish reading it before the bottleneck's epilogue writes
// over it (the product's own barriers order that); the linear
// bottleneck; rgb layer 0 over [bottleneck | e_view]. Every epilogue
// writes bf16(act(v + b)) over its operand. kStore (the backward's phase
// 1): the embeddings, the trunk posts and the bottleneck also go to the
// tile's scratch `st` (kPairs rows of the caller's nerf_cols, `cols`).
// Returns the buffer that holds the rgb hidden layer; ends at a barrier.
// The one forward loop of nerf_fwd_tc_kernel and nerf_bwd_tc_kernel.
template <bool kTwoBuffers, bool kStore, typename Between>
__device__ bf16* nerf_field_tc(const NerfDesc& d, const NerfTcLayout& L, const NerfCols& cols,
                               const bf16* __restrict__ wt, const float* __restrict__ aux,
                               unsigned char* smem, uint32_t* st, Between between) {
  const ChainDesc& tr = d.trunk;
  const float* xp = reinterpret_cast<const float*>(smem + L.xp);
  const float* xv = reinterpret_cast<const float*>(smem + L.xv);
  bf16* es = reinterpret_cast<bf16*>(smem + L.es);
  bf16* ev = reinterpret_cast<bf16*>(smem + L.ev);
  // h holds the latest result; each product writes ho, then the two swap.
  // With one buffer ho is h, fixed (a swap would cost phase 1 registers)
  bf16* h = reinterpret_cast<bf16*>(smem + L.h);
  bf16* ho = kTwoBuffers ? reinterpret_cast<bf16*>(smem + L.h2) : h;
  const auto flip = [&] {
    if (kTwoBuffers) {
      bf16* t = h;
      h = ho;
      ho = t;
    }
  };
  bf16* ws = reinterpret_cast<bf16*>(smem + L.ws);
  const int width = trunk_width(d), hr = d.rgb_hidden, nl = tr.n_layers, ldh = L.ldh;
  const int e16 = round16(tr.embed_dim), v16 = round16(d.view.embed_dim), total = cols.total;
  embed_tile(tr, xp, es, L.lde);
  embed_tile(d.view, xv, ev, L.ldv);
  __syncthreads();
  if (kStore) {
    store_pairs(es, L.lde, e16, st, total, cols.es);
    store_pairs(ev, L.ldv, v16, st, total, cols.ev);
  }
  tc::TcA a{es, L.lde, e16, nullptr, 0, 0};
  for (int i = 0; i < nl; ++i) {
    const int act = tr.acts[i], col = cols.post0 + i * width;
    const float* b = aux + tr.b_off[i];
    tc::tc_gemm(a, wt + wt_offset(d, i), a.k1 + a.k2, width, ws,
                [&](int c0, const float (&v)[tc::kTcM][4]) {
                  fwd_epilogue<kStore>(c0, v, act, b, ho, ldh, st, total, col);
                });
    flip();
    const bool skip = tr.skip_after[i] != 0;
    a = tc::TcA{h, ldh, width, skip ? es : nullptr, L.lde, skip ? e16 : 0};
  }
  __syncthreads();
  between(static_cast<const bf16*>(h));
  // The bottleneck, then rgb layer 0 over [bottleneck | e_view] (their
  // epilogues follow their products' barriers, so between's reads)
  const float* bb = aux + d.bott_b;
  tc::tc_gemm(tc::TcA{h, ldh, width, nullptr, 0, 0}, wt + wt_offset(d, nl), width, width, ws,
              [&](int c0, const float (&v)[tc::kTcM][4]) {
                fwd_epilogue<kStore>(c0, v, kNone, bb, ho, ldh, st, total, cols.bott);
              });
  flip();
  const float* b0 = aux + d.rgb0_b;
  const int act0 = d.rgb_acts[0];
  tc::tc_gemm(tc::TcA{h, ldh, width, ev, L.ldv, v16}, wt + wt_offset(d, nl + 1), width + v16, hr,
              ws, [&](int c0, const float (&v)[tc::kTcM][4]) {
                fwd_epilogue<false>(c0, v, act0, b0, ho, ldh, st, total, 0);
              });
  flip();
  __syncthreads();
  return h;
}

// Phase 1 for one 64-row tile whose points, views and output cotangents
// are in shared memory: the forward recompute and the cotangents of every
// layer, writing the tile's scratch `st` (kPairs rows of the scratch's
// `total` words) and adding the heads' dW/db and every db into `gaux`
// (the aux part of the block's slice). kTwoBuffers: the trunk is wider
// than one column pass (nerf_tc_layout's h2).
template <bool kTwoBuffers>
__device__ void nerf_tile_bwd_tc(const NerfDesc& d, const bf16* __restrict__ w,
                                 const bf16* __restrict__ wt, const float* __restrict__ aux,
                                 unsigned char* smem, uint32_t* st, float* gaux) {
  constexpr int R = tc::kTcRows;
  const NerfTcLayout L = nerf_tc_layout(d, true);
  const NerfCols cols = nerf_cols(d);
  const ChainDesc& tr = d.trunk;
  float* dout = reinterpret_cast<float*>(smem + L.dout);
  const int width = trunk_width(d), hr = d.rgb_hidden, no = d.rgb_out, ldq = L.ldq;
  const int nl = tr.n_layers, ldh = L.ldh, total = cols.total;
  // Forward recompute, with the sigma head's (tiny, f32, linear) dW and db
  // from the trunk's output
  const float* dsig = dout + no;
  const auto sigma_grads = [&](const bf16* feat) {
    if (threadIdx.x == 0) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s += dsig[r * ldq];
      gaux[d.sigma_b] += s;
    }
    for (int k = threadIdx.x; k < width; k += kThreads) {
      float s = 0.f;
      for (int r = 0; r < R; ++r) s = fmaf(to_f<bf16>(feat[r * ldh + k]), dsig[r * ldq], s);
      gaux[d.sigma_w + k] += s;
    }
  };
  bf16* h = nerf_field_tc<kTwoBuffers, true>(d, L, cols, wt, aux, smem, st, sigma_grads);
  // h holds the rgb hidden layer; each later product writes ho, then the
  // two swap. With one buffer ho is h, fixed
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
  const int act0 = d.rgb_acts[0];
  // rgb head (tiny, f32): d_pre in place of d_rgb
  const float* w1 = aux + d.rgb1_w;
  if (d.rgb_acts[1] != kNone) {
    for (int idx = threadIdx.x; idx < R * no; idx += kThreads) {
      const int r = idx / no, c = idx % no;
      float s = aux[d.rgb1_b + c];
      for (int k = 0; k < hr; ++k) s = fmaf(to_f<bf16>(h[r * ldh + k]), w1[k * no + c], s);
      dout[r * ldq + c] = activate_bwd(d.rgb_acts[1], activate(d.rgb_acts[1], s),
                                       dout[r * ldq + c]);
    }
    __syncthreads();
  }
  for (int c = threadIdx.x; c < no; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < R; ++r) s += dout[r * ldq + c];
    gaux[d.rgb1_b + c] += s;
  }
  for (int idx = threadIdx.x; idx < hr * no; idx += kThreads) {
    const int k = idx / no, c = idx % no;
    float s = 0.f;
    for (int r = 0; r < R; ++r) s = fmaf(to_f<bf16>(h[r * ldh + k]), dout[r * ldq + c], s);
    gaux[d.rgb1_w + idx] += s;
  }
  __syncthreads();
  // rgb layer 0's d_pre = act'(h0) * (d_pre1 @ w1^T), a thread a column, in
  // place of h0: db, the rounded d_pre and its scratch columns
  for (int k = threadIdx.x; k < hr; k += kThreads) {
    float s = 0.f;
    for (int j = 0; j < kPairs; ++j) {
      bf16 y[2];
      for (int i = 0; i < 2; ++i) {
        const int r = 2 * j + i;
        float gr = 0.f;
        for (int c = 0; c < no; ++c) gr = fmaf(dout[r * ldq + c], w1[k * no + c], gr);
        const float u = activate_bwd(act0, to_f<bf16>(h[r * ldh + k]), gr);
        s += u;
        y[i] = from_f<bf16>(u);
        h[r * ldh + k] = y[i];
      }
      st[j * total + cols.dpre_rgb0 + k] = tc::pack2(y[0], y[1]);
    }
    gaux[d.rgb0_b + k] += s;
  }
  // The cotangents down the field: each d_pre @ W^T's epilogue makes the
  // next layer's d_pre. rgb layer 0 (W0's first `width` rows) gives the
  // linear bottleneck's
  tc::tc_gemm(tc::TcA{h, ldh, hr, nullptr, 0, 0}, w + d.rgb0_w, hr, width, ws,
              [&](int c0, const float (&v)[tc::kTcM][4]) {
                dpre_epilogue(c0, v, [](int, int, float x) { return x; }, ho, ldh, st, total,
                              cols.dpre_bott, gaux + d.bott_b);
              });
  flip();
  // the bottleneck gives the last trunk layer's, with d_sigma w_sigma^T
  const int act_last = tr.acts[nl - 1], post_last = cols.post0 + (nl - 1) * width;
  const float* ws_sigma = aux + d.sigma_w;
  tc::tc_gemm(tc::TcA{h, ldh, width, nullptr, 0, 0}, w + d.bott_w, width, width, ws,
              [&](int c0, const float (&v)[tc::kTcM][4]) {
                dpre_epilogue(
                    c0, v,
                    [&](int r, int c, float x) {
                      return activate_bwd(act_last, scratch_at(st, total, r, post_last + c),
                                          fmaf(dsig[r * ldq], ws_sigma[c], x));
                    },
                    ho, ldh, st, total, cols.dpre0 + (nl - 1) * width, gaux + tr.b_off[nl - 1]);
              });
  flip();
  // trunk layer i gives layer i - 1's (act' from its post, read back from
  // the scratch columns this tile wrote)
  for (int i = nl - 1; i > 0; --i) {
    const int act = tr.acts[i - 1], post = cols.post0 + (i - 1) * width;
    tc::tc_gemm(tc::TcA{h, ldh, width, nullptr, 0, 0}, w + tr.w_off[i], width, width, ws,
                [&](int c0, const float (&v)[tc::kTcM][4]) {
                  dpre_epilogue(
                      c0, v,
                      [&](int r, int c, float x) {
                        return activate_bwd(act, scratch_at(st, total, r, post + c), x);
                      },
                      ho, ldh, st, total, cols.dpre0 + (i - 1) * width, gaux + tr.b_off[i - 1]);
                });
    flip();
  }
  __syncthreads();
}

// Phase 1: block b walks 64-row tiles b, b + grid, ... and writes each
// tile's scratch; its aux sums (n_aux floats) go to its own slice of
// `part`.
template <bool kTwoBuffers>
__global__ void __launch_bounds__(kThreads, 2)
nerf_bwd_tc_kernel(NerfDesc d, const float* __restrict__ pts, const float* __restrict__ views,
                   const float* __restrict__ drgb, const float* __restrict__ dsigma,
                   const bf16* __restrict__ w, const bf16* __restrict__ wt,
                   const float* __restrict__ aux, uint32_t* scratch, float* __restrict__ part,
                   long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = tc::kTcRows;
  const NerfTcLayout L = nerf_tc_layout(d, true);
  const long long tile_words = static_cast<long long>(kPairs) * nerf_cols(d).total;
  float* gaux = part + blockIdx.x * d.n_aux;
  for (long long j = threadIdx.x; j < d.n_aux; j += kThreads) gaux[j] = 0.f;
  float* xp = reinterpret_cast<float*>(smem + L.xp);
  float* xv = reinterpret_cast<float*>(smem + L.xv);
  float* dout = reinterpret_cast<float*>(smem + L.dout);
  const int no = d.rgb_out, ldq = L.ldq;
  const long long n_tiles = (n + R - 1) / R;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long row0 = tile * R;
    load_rows<R>(pts, 3, row0, n, xp);
    load_rows<R>(views, 3, row0, n, xv);
    // Padding rows get a zero cotangent, so they add nothing to dW/db
    for (int idx = threadIdx.x; idx < R * ldq; idx += kThreads) {
      const long long r = row0 + idx / ldq;
      const int c = idx % ldq;
      dout[idx] = r >= n ? 0.f : (c < no ? drgb[r * no + c] : dsigma[r]);
    }
    __syncthreads();
    nerf_tile_bwd_tc<kTwoBuffers>(d, w, wt, aux, smem, scratch + tile * tile_words, gaux);
  }
}

// Phase 1's instantiation for d's trunk width
inline auto nerf_bwd_tc_for(const NerfDesc& d) {
  return trunk_width(d) > tc::kTcCols ? nerf_bwd_tc_kernel<true> : nerf_bwd_tc_kernel<false>;
}

// K3-fwd in bf16: a block a 64-row tile. The field as phase 1 recomputes
// it (nerf_field_tc, without the scratch), the sigma head from the trunk's
// output and the rgb head from the rgb hidden layer in f32 on the CUDA
// cores (head_sums; the heads' weights f32), their rows below n written
// to rgb and sigma.
template <bool kTwoBuffers>
__global__ void __launch_bounds__(kThreads, 2)
nerf_fwd_tc_kernel(NerfDesc d, const float* __restrict__ pts, const float* __restrict__ views,
                   const bf16* __restrict__ wt, const float* __restrict__ aux,
                   float* __restrict__ rgb, float* __restrict__ sigma, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = tc::kTcRows;
  const NerfTcLayout L = nerf_tc_layout(d, false);
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  load_rows<R>(pts, 3, row0, n, reinterpret_cast<float*>(smem + L.xp));
  load_rows<R>(views, 3, row0, n, reinterpret_cast<float*>(smem + L.xv));
  __syncthreads();
  const float sigma_b = aux[d.sigma_b];
  const bf16* h = nerf_field_tc<kTwoBuffers, false>(
      d, L, nerf_cols(d), wt, aux, smem, nullptr, [&](const bf16* feat) {
        head_sums(feat, L.ldh, trunk_width(d), aux + d.sigma_w, 1,
                  [&](int, int r, int, float s) {
                    if (row0 + r < n) sigma[row0 + r] = s + sigma_b;
                  });
      });
  const int no = d.rgb_out, act = d.rgb_acts[1];
  const float* b1 = aux + d.rgb1_b;
  head_sums(h, L.ldh, d.rgb_hidden, aux + d.rgb1_w, no, [&](int item, int r, int c, float s) {
    if (row0 + r < n) rgb[row0 * no + item] = activate(act, s + b1[c]);
  });
}

// The building block alone: c (m x n, f32) = a (m x k, bf16 row-major) @
// bt^T, bt (n x round16(k), bf16, zero past k) through tc_gemm, a block a
// 64-row tile of a.
__global__ void __launch_bounds__(kThreads)
tc_matmul_kernel(const bf16* __restrict__ a, const bf16* __restrict__ bt,
                 float* __restrict__ c, int m, int n, int k) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = tc::kTcRows;
  const int k16 = round16(k), lda = tc::tc_ld(k);
  bf16* as = reinterpret_cast<bf16*>(smem);
  bf16* ws = as + R * lda;
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  for (int idx = threadIdx.x; idx < R * k16; idx += kThreads) {
    const int r = idx / k16, j = idx % k16;
    as[r * lda + j] = row0 + r < m && j < k ? a[(row0 + r) * k + j] : from_f<bf16>(0.f);
  }
  const int g = (threadIdx.x & 31) >> 2, t = threadIdx.x & 3;
  tc::tc_gemm(tc::TcA{as, lda, k16, nullptr, 0, 0}, bt, k16, n, ws,
              [&](int c0, const float (&v)[tc::kTcM][4]) {
                for (int i = 0; i < tc::kTcM; ++i)
                  for (int e = 0; e < 4; ++e) {
                    const long long r = row0 + 16 * i + g + 8 * (e >> 1);
                    const int col = c0 + 2 * t + (e & 1);
                    if (r < m && col < n) c[r * n + col] = v[i][e];
                  }
              });
}

// bf16 K3-fwd on the tensor cores: one block a 64-row tile.
int nerf_fwd_tc(const NerfDesc& d, const float* pts, const float* views, const bf16* wt,
                const float* aux, float* rgb, float* sigma, long long n, cudaStream_t stream) {
  if (int err = check_nerf_tc(d, false)) return err;
  const auto kernel = trunk_width(d) > tc::kTcCols ? nerf_fwd_tc_kernel<true>
                                                   : nerf_fwd_tc_kernel<false>;
  return launch_with_smem(kernel, nerf_tc_layout(d, false).total,
                          (n + tc::kTcRows - 1) / tc::kTcRows, stream, d, pts, views, wt, aux,
                          rgb, sigma, n);
}

template <typename T>
int nerf_fwd(const NerfDesc& d, const float* pts, const float* views, const T* w,
             const float* aux, float* rgb, float* sigma, long long n, cudaStream_t stream) {
  const size_t smem = nerf_fwd_layout<T>(d).total;
  if (smem > static_cast<size_t>(max_smem_optin())) return kErrSmem;
  return launch_with_smem(nerf_fwd_kernel<T>, smem, (n + kRows - 1) / kRows, stream, d, pts,
                          views, w, aux, rgb, sigma, n);
}

// The f32 backward on the CUDA cores (nerf_bwd_kernel), then the slice sum.
template <int ROWS>
int nerf_bwd_f32(const NerfDesc& d, const float* pts, const float* views, const float* drgb,
                 const float* dsigma, const float* w, const float* aux, float* part, float* dwb,
                 int slices, long long n, cudaStream_t stream) {
  if (slices < 1) return kErrBadPlan;
  int err = launch_with_smem(nerf_bwd_kernel<ROWS>,
                             nerf_bwd_layout<ROWS>(d).total, slices, stream, d, pts, views,
                             drgb, dsigma, w, aux, part, n);
  if (err) return err;
  return sum_slices(part, slices, d.n_dense + d.n_aux, dwb, stream);
}

int nerf_bwd_f32_dispatch(const NerfDesc& d, const float* pts, const float* views,
                          const float* drgb, const float* dsigma, const float* w,
                          const float* aux, float* part, float* dwb, int slices, long long n,
                          cudaStream_t stream) {
  switch (nerf_bwd_rows(d, max_smem_optin())) {
    case 32:
      return nerf_bwd_f32<32>(d, pts, views, drgb, dsigma, w, aux, part, dwb, slices, n, stream);
    case 16:
      return nerf_bwd_f32<16>(d, pts, views, drgb, dsigma, w, aux, part, dwb, slices, n, stream);
    default:
      return kErrSmem;
  }
}

int nerf_bwd_f32_slices(const NerfDesc& d, long long n, int* slices) {
  switch (nerf_bwd_rows(d, max_smem_optin())) {
    case 32:
      return dw_slices(nerf_bwd_kernel<32>, nerf_bwd_layout<32>(d).total,
                       (n + 31) / 32, slices);
    case 16:
      return dw_slices(nerf_bwd_kernel<16>, nerf_bwd_layout<16>(d).total,
                       (n + 15) / 16, slices);
    default:
      return kErrSmem;
  }
}

// The field's dW tile (dw_kernel): 128
constexpr int kNerfDwTile = 128;

// The dW pass's table of the field's dense layers
inline DwTable nerf_dw_table(const NerfDesc& d) {
  DwTable t;
  t.n_layers = n_dense_layers(d);
  t.total = nerf_cols(d).total;
  t.n_dense = d.n_dense;
  for (int i = 0; i < t.n_layers; ++i) t.layers[i] = dense_layer(d, i);
  return t;
}

// The bf16 backward: phase 1, the dW pass and its chunk sum, then the sum
// of phase 1's slices.
int nerf_bwd_tc(const NerfDesc& d, const float* pts, const float* views, const float* drgb,
                const float* dsigma, const bf16* w, const bf16* wt, const float* aux,
                uint32_t* scratch, float* part, float* dwb, int slices, int chunks, long long n,
                cudaStream_t stream) {
  if (int err = check_nerf_tc(d, true)) return err;
  if (slices < 1 || chunks < 1) return kErrBadArgs;
  float* part_aux = part;
  float* part_dense = part + static_cast<long long>(slices) * d.n_aux;
  if (int err = launch_with_smem(nerf_bwd_tc_for(d), nerf_tc_layout(d, true).total, slices,
                                 stream, d, pts, views, drgb, dsigma, w, wt, aux, scratch,
                                 part_aux, n))
    return err;
  if (int err = dw_pass<kNerfDwTile>(nerf_dw_table(d), scratch, part_dense, dwb, chunks, n,
                                     stream))
    return err;
  return sum_slices(part_aux, slices, d.n_aux, dwb + d.n_dense, stream);
}

}  // namespace nfk

extern "C" {

// K3-fwd on the CUDA cores (nerf_fwd_kernel): f32, and the bf16 kernel the
// tensor-core one is held against. bf16 != 0 selects bf16 operands (w must
// then hold bf16 values).
int nfk_nerf_fwd(const nfk::NerfDesc* desc, int bf16, const float* pts, const float* views,
                 const void* w, const float* aux, float* rgb, float* sigma, long long n,
                 void* stream) {
  if (int err = nfk::check_nerf(*desc)) return err;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return nfk::nerf_fwd<__nv_bfloat16>(*desc, pts, views,
                                        static_cast<const __nv_bfloat16*>(w), aux, rgb, sigma,
                                        n, s);
  return nfk::nerf_fwd<float>(*desc, pts, views, static_cast<const float*>(w), aux, rgb, sigma,
                              n, s);
}

// K3-fwd in bf16 on the tensor cores (nerf_fwd_tc_kernel), over the
// transposed dense weights wt that nfk_nerf_bwd takes (nfk_nerf_dw_table's
// layers).
int nfk_nerf_fwd_tc(const nfk::NerfDesc* desc, const float* pts, const float* views,
                    const void* wt, const float* aux, float* rgb, float* sigma, long long n,
                    void* stream) {
  if (int err = nfk::check_nerf(*desc)) return err;
  if (n <= 0) return 0;
  return nfk::nerf_fwd_tc(*desc, pts, views, static_cast<const __nv_bfloat16*>(wt), aux, rgb,
                          sigma, n, static_cast<cudaStream_t>(stream));
}

// The buffers nfk_nerf_bwd needs for n rows, which the wrapper allocates.
// f32: `slices` x (n_dense + n_aux) floats of part. bf16: a scratch of
// `scratch` bf16 values; the transposed dense weights, `wt` bf16 values;
// part of slices x n_aux + chunks x n_dense floats.
int nfk_nerf_bwd_sizes(const nfk::NerfDesc* desc, int bf16, long long n, long long* scratch,
                       long long* wt, int* slices, int* chunks) {
  if (int err = nfk::check_nerf(*desc)) return err;
  *scratch = *wt = 0;
  *slices = *chunks = 0;
  if (n <= 0) return 0;
  if (!bf16) return nfk::nerf_bwd_f32_slices(*desc, n, slices);
  if (int err = nfk::check_nerf_tc(*desc, true)) return err;
  const long long tiles = (n + nfk::tc::kTcRows - 1) / nfk::tc::kTcRows;
  *scratch = tiles * nfk::tc::kTcRows * nfk::nerf_cols(*desc).total;
  *wt = nfk::wt_offset(*desc, nfk::n_dense_layers(*desc));
  *chunks = nfk::dw_chunks(n);
  return nfk::dw_slices(nfk::nerf_bwd_tc_for(*desc), nfk::nerf_tc_layout(*desc, true).total, tiles,
                        slices);
}

// K3-bwd: dW/db of every layer into dwb ([dense | aux] packing, f32).
// f32: the CUDA-core kernel and the sum of its slices (wt, scratch and
// chunks unused). bf16: phase 1, the dW pass and the sums over the
// buffers of nfk_nerf_bwd_sizes.
int nfk_nerf_bwd(const nfk::NerfDesc* desc, int bf16, const float* pts, const float* views,
                 const float* drgb, const float* dsigma, const void* w, const void* wt,
                 const float* aux, void* scratch, float* part, float* dwb, int slices,
                 int chunks, long long n, void* stream) {
  if (int err = nfk::check_nerf(*desc)) return err;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return nfk::nerf_bwd_tc(*desc, pts, views, drgb, dsigma,
                            static_cast<const __nv_bfloat16*>(w),
                            static_cast<const __nv_bfloat16*>(wt), aux,
                            static_cast<uint32_t*>(scratch), part, dwb, slices, chunks, n, s);
  return nfk::nerf_bwd_f32_dispatch(*desc, pts, views, drgb, dsigma,
                                    static_cast<const float*>(w), aux, part, dwb, slices, n, s);
}

// The dense layers of the bf16 backward's scratch (nfk_nerf_bwd_sizes'
// layout) and the dW pass's tile over them, for nfk_dw_pass and the
// wrapper's transposed weights.
int nfk_nerf_dw_table(const nfk::NerfDesc* desc, nfk::DwTable* tab, int* tile) {
  if (int err = nfk::check_nerf(*desc)) return err;
  if (int err = nfk::check_nerf_tc(*desc, true)) return err;
  *tab = nfk::nerf_dw_table(*desc);
  *tile = nfk::kNerfDwTile;
  return 0;
}

// The tensor-core building block alone: c (m x n f32) = a (m x k bf16) @
// bt^T, bt (n x round16(k) bf16, zero past k), through the loaders,
// fragments and pipeline that K3-bwd uses.
int nfk_tc_matmul(const void* a, const void* bt, float* c, int m, int n, int k, void* stream) {
  if (m < 0 || n < 1 || k < 1) return nfk::kErrBadArgs;
  if (m == 0) return 0;
  const size_t smem = nfk::align16(sizeof(__nv_bfloat16) * nfk::tc::kTcRows *
                                   nfk::tc::tc_ld(k)) +
                      sizeof(__nv_bfloat16) * nfk::tc::kTcStages * nfk::tc::kTcStage;
  if (smem > static_cast<size_t>(nfk::max_smem_optin())) return nfk::kErrSmem;
  return nfk::launch_with_smem(nfk::tc_matmul_kernel, smem,
                               (m + nfk::tc::kTcRows - 1) / nfk::tc::kTcRows,
                               static_cast<cudaStream_t>(stream),
                               static_cast<const __nv_bfloat16*>(a),
                               static_cast<const __nv_bfloat16*>(bt), c, m, n, k);
}

}  // extern "C"
