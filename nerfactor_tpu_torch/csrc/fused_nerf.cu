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
// forward, keeping every activation on the chip, and returns dW and db of
// every layer from d_rgb and d_sigma. There is no input cotangent: the
// points and view directions are data.
//
// What bounds it on Hopper: arithmetic. At nerf.ini width a row takes
// ~593k multiply-adds against 24 B in and 16 B out, far above the card's
// operations-per-byte ridge. So the design is K1's (chain_mlp.cuh, whose
// device code it reuses): a block owns a row tile; both embeddings and all
// activations of the tile stay in shared memory; each dense layer streams
// its weights through a shared-memory tile, the skip consumer and rgb layer
// 0 reading two K segments ([h | e], [bottleneck | e_view]). Products run on
// the CUDA cores in f32 from f32 or bf16 operands (bf16: every dense layer
// of the trunk, the bottleneck and rgb layer 0). The two tiny heads (sigma,
// rgb) are f32 dot products per row, as the TPU kernel's VPU heads; their
// weights stay f32.
//
// The backward's shared memory: the tile keeps 8 trunk posts, the
// bottleneck, both embeddings (type T) and two f32 cotangent rows 256 wide
// (~7 KB a row in bf16). The rgb hidden layer lives in the second cotangent
// buffer until rgb layer 0's backward needs that buffer. 32 rows fit a
// block in bf16 (~229 KB), 16 in f32; the launcher computes the layout and
// takes the largest tile that fits (kErrSmem if none does).
//
// Determinism, as K1-bwd: no float atomicAdd. The grid is the number of
// blocks the card holds at once; block b walks row tiles b, b + grid, ...
// and adds each tile's dW/db into its own f32 slice of a scratch buffer;
// sum_slices adds the slices in slice order. At nerf.ini width a slice is
// ~2.4 MB (132 slices: ~315 MB, outside the L2), and each row tile
// read-modify-writes its block's slice once.
//
// Inputs: pts, views (n, 3) f32 row-major. Dense weights (trunk layers,
// bottleneck, rgb layer 0) packed in JAX layout (w is (din, dout), applied
// as x @ w) at type T; the heads' weights and all biases in one f32 "aux"
// buffer. dW/db come back packed as [dense | aux], f32.

#include "chain_mlp.cuh"

namespace nfk {

constexpr int kMaxHeadOut = 8;  // widest tiny head (the TPU's TINY_HEAD_MAX)

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

// Shared-memory layout of a backward block: raw points and views (f32) |
// output cotangents [d_rgb | d_sigma] (f32) | embeddings (T) | every trunk
// post (T) | bottleneck (T) | two f32 cotangent buffers | transposed weight
// tile (T). The rgb hidden layer (T, ld ldo) borrows the second cotangent
// buffer.
struct NerfBwdLayout {
  size_t xp, xv, dout, es, ev, posts, bott, da, db, ws, total;
  int lde, ldv, ldh, ldd, ldo, ldq, post_stride;
};

template <typename T, int ROWS>
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
  s.ev = align16(s.es + sizeof(T) * ROWS * s.lde);
  s.posts = align16(s.ev + sizeof(T) * ROWS * s.ldv);
  s.bott = align16(s.posts + sizeof(T) * d.trunk.n_layers * s.post_stride);
  s.da = align16(s.bott + sizeof(T) * ROWS * s.ldh);
  s.db = align16(s.da + sizeof(float) * ROWS * s.ldd);
  s.ws = align16(s.db + sizeof(float) * ROWS * s.ldd);
  s.total = align16(s.ws + sizeof(T) * kKTile * kLdT);
  return s;
}

// The backward's row tile: 32 rows where they fit the block's opt-in
// shared memory, else 16; 0 if neither fits.
template <typename T>
inline int nerf_bwd_rows(const NerfDesc& d, int max_smem) {
  if (nerf_bwd_layout<T, 32>(d).total <= static_cast<size_t>(max_smem)) return 32;
  if (nerf_bwd_layout<T, 16>(d).total <= static_cast<size_t>(max_smem)) return 16;
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

// The backward for one tile: points, views and the output cotangents
// [d_rgb | d_sigma] are in shared memory. Adds the tile's dW/db into
// `slice` (dense part first, then aux). In bf16 mode each dense layer's
// d_pre is rounded to bf16 before its products (dense_bwd); the tiny heads'
// cotangents stay f32, as the TPU kernel's VPU heads.
template <typename T, int ROWS>
__device__ void nerf_tile_bwd(const NerfDesc& d, const T* __restrict__ w,
                              const float* __restrict__ aux, unsigned char* smem, float* slice) {
  const NerfBwdLayout L = nerf_bwd_layout<T, ROWS>(d);
  const ChainDesc& tr = d.trunk;
  const float* xp = reinterpret_cast<const float*>(smem + L.xp);
  const float* xv = reinterpret_cast<const float*>(smem + L.xv);
  float* dout = reinterpret_cast<float*>(smem + L.dout);
  T* es = reinterpret_cast<T*>(smem + L.es);
  T* ev = reinterpret_cast<T*>(smem + L.ev);
  T* posts = reinterpret_cast<T*>(smem + L.posts);
  T* bott = reinterpret_cast<T*>(smem + L.bott);
  float* da = reinterpret_cast<float*>(smem + L.da);
  float* db = reinterpret_cast<float*>(smem + L.db);
  T* h0 = reinterpret_cast<T*>(smem + L.db);
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  float* gaux = slice + d.n_dense;
  const int width = trunk_width(d), hr = d.rgb_hidden, no = d.rgb_out, ldq = L.ldq;
  const int nv = d.view.embed_dim;
  // Forward recompute, every activation kept
  embed_rows<T, ROWS>(tr, xp, es, L.lde);
  embed_rows<T, ROWS>(d.view, xv, ev, L.ldv);
  __syncthreads();
  const T* feat = trunk_fwd<T, ROWS>(tr, es, L.lde, w, aux, ws, posts, nullptr,
                                     L.post_stride, L.ldh);
  layer_pass<T, ROWS>(feat, L.ldh, width, nullptr, 0, 0, w + d.bott_w, aux + d.bott_b, width,
                      kNone, ws, bott, L.ldh, nullptr, 0, ROWS);
  layer_pass<T, ROWS>(bott, L.ldh, width, ev, L.ldv, nv, w + d.rgb0_w, aux + d.rgb0_b, hr,
                      d.rgb_acts[0], ws, h0, L.ldo, nullptr, 0, ROWS);
  __syncthreads();
  // rgb head (tiny, f32): d_pre in place of d_rgb
  const float* w1 = aux + d.rgb1_w;
  if (d.rgb_acts[1] != kNone) {
    for (int idx = threadIdx.x; idx < ROWS * no; idx += kThreads) {
      const int r = idx / no, c = idx % no;
      float s = aux[d.rgb1_b + c];
      for (int k = 0; k < hr; ++k) s = fmaf(to_f<T>(h0[r * L.ldo + k]), w1[k * no + c], s);
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
    for (int r = 0; r < ROWS; ++r) s = fmaf(to_f<T>(h0[r * L.ldo + k]), dout[r * ldq + c], s);
    gaux[d.rgb1_w + idx] += s;
  }
  // rgb layer 0's d_pre = act'(h0) * (d_pre1 @ w1^T), into da
  for (int idx = threadIdx.x; idx < ROWS * hr; idx += kThreads) {
    const int r = idx / hr, k = idx % hr;
    float g = 0.f;
    for (int c = 0; c < no; ++c) g = fmaf(dout[r * ldq + c], w1[k * no + c], g);
    da[r * L.ldd + k] = activate_bwd(d.rgb_acts[0], to_f<T>(h0[r * L.ldo + k]), g);
  }
  __syncthreads();
  // rgb layer 0, [bottleneck | e_view] -> hr: d_bottleneck into db (h0 is done)
  dense_bwd<T, ROWS>(da, L.ldd, hr, bott, L.ldh, width, ev, L.ldv, nv, w + d.rgb0_w,
                     slice + d.rgb0_w, gaux + d.rgb0_b, width, width, ws, db, nullptr, 0);
  // bottleneck (linear): d_h of the trunk's output into da
  dense_bwd<T, ROWS>(db, L.ldd, width, feat, L.ldh, width, nullptr, 0, 0, w + d.bott_w,
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
    for (int r = 0; r < ROWS; ++r) s = fmaf(to_f<T>(feat[r * L.ldh + k]), dsig[r * ldq], s);
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
    const T* post = posts + i * L.post_stride;
    for (int idx = threadIdx.x; idx < ROWS * n; idx += kThreads) {
      const int r = idx / n, c = idx % n;
      dcur[r * L.ldd + c] = activate_bwd(tr.acts[i], to_f<T>(post[r * L.ldh + c]),
                                         dcur[r * L.ldd + c]);
    }
    __syncthreads();
    const bool skip_in = i > 0 && tr.skip_after[i - 1];
    const int hw = i > 0 ? tr.widths[i - 1] : 0;
    dense_bwd<T, ROWS>(dcur, L.ldd, n, i > 0 ? post - L.post_stride : es,
                       i > 0 ? L.ldh : L.lde, i > 0 ? hw : tr.embed_dim,
                       skip_in ? es : nullptr, L.lde, skip_in ? tr.embed_dim : 0,
                       w + tr.w_off[i], slice + tr.w_off[i], gaux + tr.b_off[i], hw, hw, ws,
                       dnext, nullptr, 0);
    float* t = dcur;
    dcur = dnext;
    dnext = t;
  }
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
nerf_bwd_kernel(NerfDesc d, const float* __restrict__ pts, const float* __restrict__ views,
                const float* __restrict__ drgb, const float* __restrict__ dsigma,
                const T* __restrict__ w, const float* __restrict__ aux,
                float* __restrict__ part, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const NerfBwdLayout L = nerf_bwd_layout<T, ROWS>(d);
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
    nerf_tile_bwd<T, ROWS>(d, w, aux, smem, slice);
  }
}

template <typename T>
int nerf_fwd(const NerfDesc& d, const float* pts, const float* views, const T* w,
             const float* aux, float* rgb, float* sigma, long long n, cudaStream_t stream) {
  const size_t smem = nerf_fwd_layout<T>(d).total;
  if (smem > static_cast<size_t>(max_smem_optin())) return kErrSmem;
  return launch_with_smem(nerf_fwd_kernel<T>, smem, (n + kRows - 1) / kRows, stream, d, pts,
                          views, w, aux, rgb, sigma, n);
}

template <typename T, int ROWS>
int nerf_bwd(const NerfDesc& d, const float* pts, const float* views, const float* drgb,
             const float* dsigma, const T* w, const float* aux, float* part, float* dwb,
             int slices, long long n, cudaStream_t stream) {
  if (slices < 1) return kErrBadPlan;
  int err = launch_with_smem(nerf_bwd_kernel<T, ROWS>, nerf_bwd_layout<T, ROWS>(d).total,
                             slices, stream, d, pts, views, drgb, dsigma, w, aux, part, n);
  if (err) return err;
  return sum_slices(part, slices, d.n_dense + d.n_aux, dwb, stream);
}

template <typename T>
int nerf_bwd_dispatch(const NerfDesc& d, const float* pts, const float* views,
                      const float* drgb, const float* dsigma, const void* w, const float* aux,
                      float* part, float* dwb, int slices, long long n, cudaStream_t stream) {
  const T* wt = static_cast<const T*>(w);
  switch (nerf_bwd_rows<T>(d, max_smem_optin())) {
    case 32:
      return nerf_bwd<T, 32>(d, pts, views, drgb, dsigma, wt, aux, part, dwb, slices, n,
                             stream);
    case 16:
      return nerf_bwd<T, 16>(d, pts, views, drgb, dsigma, wt, aux, part, dwb, slices, n,
                             stream);
    default:
      return kErrSmem;
  }
}

template <typename T>
int nerf_bwd_slices(const NerfDesc& d, long long n, int* slices) {
  switch (nerf_bwd_rows<T>(d, max_smem_optin())) {
    case 32:
      return dw_slices(nerf_bwd_kernel<T, 32>, nerf_bwd_layout<T, 32>(d).total, (n + 31) / 32,
                       slices);
    case 16:
      return dw_slices(nerf_bwd_kernel<T, 16>, nerf_bwd_layout<T, 16>(d).total, (n + 15) / 16,
                       slices);
    default:
      return kErrSmem;
  }
}

}  // namespace nfk

extern "C" {

// K3-fwd. bf16 != 0 selects bf16 operands (w must then hold bf16 values).
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

// Number of dW scratch slices nfk_nerf_bwd uses for n rows (the wrapper
// allocates slices x (n_dense + n_aux) floats).
int nfk_nerf_bwd_slices(const nfk::NerfDesc* desc, int bf16, long long n, int* slices) {
  if (int err = nfk::check_nerf(*desc)) return err;
  *slices = 0;
  if (n <= 0) return 0;
  if (bf16) return nfk::nerf_bwd_slices<__nv_bfloat16>(*desc, n, slices);
  return nfk::nerf_bwd_slices<float>(*desc, n, slices);
}

// K3-bwd: dW/db of every layer into dwb ([dense | aux] packing, f32),
// summed from part (slices x (n_dense + n_aux) floats of scratch).
int nfk_nerf_bwd(const nfk::NerfDesc* desc, int bf16, const float* pts, const float* views,
                 const float* drgb, const float* dsigma, const void* w, const float* aux,
                 float* part, float* dwb, int slices, long long n, void* stream) {
  if (int err = nfk::check_nerf(*desc)) return err;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return nfk::nerf_bwd_dispatch<__nv_bfloat16>(*desc, pts, views, drgb, dsigma, w, aux, part,
                                                 dwb, slices, n, s);
  return nfk::nerf_bwd_dispatch<float>(*desc, pts, views, drgb, dsigma, w, aux, part, dwb,
                                       slices, n, s);
}

}  // extern "C"
