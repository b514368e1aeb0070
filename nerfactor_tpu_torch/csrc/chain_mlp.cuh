// Device-side building blocks of the fused embed -> skip-MLP -> head
// chains (kernels K1-fwd in fused_mlp.cu and K2-fwd in fused_rusink.cu).
//
// Two modes of the same chain: a plan with a skip after its last layer
// (the output is [head | embedding], kernels K1w) and the stash route
// (kernels K1r), whose embedding forms cos t as sin(t + pi/2) and whose
// forward may write its trig columns to device memory for the backward to
// read instead of recomputing them.
//
// One block owns a tile of kRows input rows. The positional embedding and
// every hidden activation of that tile stay in shared memory for the whole
// chain; device memory sees only the raw input rows and the output rows.
// The weights do not fit in shared memory at full width (the lvis chain's
// f32 weights are ~290 KB, one skip layer alone 111 KB), so each layer
// streams its weight matrix through a kKTile x kColChunk shared-memory
// tile while the row tile's activations stay resident.
//
// Arithmetic: every product is formed in f32 from operands of type T
// (float, or __nv_bfloat16 for the "bf16 operands, f32 accumulation"
// mode) and accumulated in f32. Biases and heads stay f32; hidden
// activations are stored back at type T.
//
// The CUDA-core backward (K1-bwd and K2-bwd but where they run on the
// tensor cores: K1-bwd in bf16 with dW only, K2-bwd in bf16) recomputes a
// tile's forward, keeping every hidden post-activation (nothing is saved
// by the forward), then walks the layers in reverse: d_pre = act'(post) * d_h,
// db and dW accumulate into the block's own slice of a scratch buffer,
// and d_h = d_pre @ W^T streams W transposed through shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace nfk {

constexpr int kMaxLayers = 16;
constexpr int kMaxParts = 4;
constexpr int kRows = 64;       // input rows per block
constexpr int kThreads = 256;   // 16 column groups x 16 row groups
constexpr int kColChunk = 128;  // output columns per pass over K
constexpr int kKTile = 32;      // weight rows per shared-memory tile
constexpr int kColsPerThread = kColChunk / 16;
constexpr int kMaxHeadOut = 8;  // widest tiny head (the TPU's TINY_HEAD_MAX)

enum Act { kNone = 0, kRelu = 1, kSigmoid = 2, kSoftplus = 3 };

// Error codes beyond cudaError_t's range.
constexpr int kErrBadPlan = 10001;
constexpr int kErrSmem = 10002;
constexpr int kErrBadArgs = 10003;

// Static description of one chain. The Python wrapper fills it in with the
// same field order (nerfactor_tpu_torch/ops/fused_mlp.py, ChainDesc).
struct ChainDesc {
  int n_layers;
  int widths[kMaxLayers];
  int acts[kMaxLayers];
  int skip_after[kMaxLayers];  // 1: the embedding is concatenated after layer i
  int n_parts;
  int part_dim[kMaxParts];
  int part_freqs[kMaxParts];  // 0: passthrough part
  int raw_dim;
  int embed_dim;
  int max_width;              // widest hidden layer
  long long w_off[kMaxLayers];  // offsets (elements) into the packed weights
  long long b_off[kMaxLayers];  // offsets (elements) into the packed biases
};

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Odd leading dimensions keep the row-group reads of one warp on
// different shared-memory banks.
__host__ __device__ inline int padded_ld(int dim) { return dim | 1; }

__host__ __device__ inline size_t align16(size_t bytes) {
  return (bytes + 15) & ~static_cast<size_t>(15);
}

// Shared-memory layout of one block: raw rows (f32) | embedding (T) |
// two ping-pong hidden buffers (T) | weight tile (T).
struct SmemLayout {
  size_t xs, es, ha, hb, ws, total;
  int lde, ldh;
};

template <typename T>
__host__ __device__ inline SmemLayout smem_layout(const ChainDesc& d) {
  SmemLayout s;
  s.lde = padded_ld(d.embed_dim);
  s.ldh = padded_ld(d.max_width);
  s.xs = 0;
  s.es = align16(s.xs + sizeof(float) * kRows * d.raw_dim);
  s.ha = align16(s.es + sizeof(T) * kRows * s.lde);
  s.hb = align16(s.ha + sizeof(T) * kRows * s.ldh);
  s.ws = align16(s.hb + sizeof(T) * kRows * s.ldh);
  s.total = align16(s.ws + sizeof(T) * kKTile * kColChunk);
  return s;
}

inline int check_desc(const ChainDesc& d) {
  if (d.n_layers < 1 || d.n_layers > kMaxLayers) return kErrBadPlan;
  if (d.n_parts < 1 || d.n_parts > kMaxParts) return kErrBadPlan;
  return 0;
}

// A skip after the last layer: the output row is [head | embedding].
__host__ __device__ inline bool last_skip(const ChainDesc& d) {
  return d.skip_after[d.n_layers - 1] != 0;
}

// Width of an output row (and of its cotangent).
__host__ __device__ inline int out_dim(const ChainDesc& d) {
  return d.widths[d.n_layers - 1] + (last_skip(d) ? d.embed_dim : 0);
}

// Width of a stash row: the sin and cos columns of every part.
__host__ __device__ inline int trig_dim(const ChainDesc& d) {
  int t = 0;
  for (int p = 0; p < d.n_parts; ++p) t += 2 * d.part_dim[p] * d.part_freqs[p];
  return t;
}

// float32(pi / 2): the stash route's phase of a cos column, as the TPU
// kernel's P row (pallas_mlp._trig_mats).
constexpr float kHalfPi = 1.57079637f;

// How embed_rows forms the trig columns: precise sincosf; the stash
// route's sin(2^j x + phase); or not at all (the backward of the stash
// route loads them from the stash).
enum EmbedTrig { kSincos = 0, kPhase = 1, kNoTrig = 2 };

// Embedding column of stash column s. A stash row holds, per part, the
// sines of every octave (octave-major, `dim` columns each), then the
// cosines: the columns of the TPU kernel's sin(x @ A + P). The embedding
// keeps the reference order [x, sin 2^0 x, cos 2^0 x, sin 2^1 x, ...].
__device__ inline int stash_to_embed_col(const ChainDesc& d, int s) {
  int e0 = 0;
  for (int p = 0; p < d.n_parts; ++p) {
    const int dim = d.part_dim[p], fd = d.part_freqs[p] * dim;
    if (s < 2 * fd) {
      const int cos_col = s / fd, j = (s % fd) / dim, k = s % dim;
      return e0 + dim + (2 * j + cos_col) * dim + k;
    }
    s -= 2 * fd;
    e0 += dim + 2 * fd;
  }
  return -1;
}

__device__ __forceinline__ float activate(int act, float v) {
  switch (act) {
    case kRelu: return fmaxf(v, 0.f);
    case kSigmoid: return 1.f / (1.f + expf(-v));
    // logaddexp(v, 0), as jax.nn.softplus
    case kSoftplus: return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v)));
    default: return v;
  }
}

// Positional embedding of the tile's raw rows, in the JAX row order
// [x, sin(2^0 x), cos(2^0 x), sin(2^1 x), ...] per part. Precise sincosf:
// the arguments reach 2^9 x, where the fast intrinsics are too coarse.
// kPhase forms the stash route's sin(2^j x) and sin(2^j x + pi/2): 2^j x
// is exact, the add rounds in f32 (at 2^9 x by up to ~3e-5 against cos).
template <typename T, int ROWS = kRows>
__device__ void embed_rows(const ChainDesc& d, const float* xs, T* es, int lde,
                           int trig = kSincos) {
  for (int idx = threadIdx.x; idx < ROWS * d.raw_dim; idx += kThreads) {
    const int r = idx / d.raw_dim, c = idx % d.raw_dim;
    int p = 0, col0 = 0, e0 = 0;
    while (c >= col0 + d.part_dim[p]) {
      col0 += d.part_dim[p];
      e0 += d.part_dim[p] * (1 + 2 * d.part_freqs[p]);
      ++p;
    }
    const int dim = d.part_dim[p], ci = c - col0;
    const float x = xs[r * d.raw_dim + c];
    T* er = es + r * lde + e0;
    er[ci] = from_f<T>(x);
    if (trig == kNoTrig) continue;
    float freq = 1.f;
    for (int j = 0; j < d.part_freqs[p]; ++j) {
      float s, co;
      if (trig == kPhase) {
        s = sinf(freq * x);
        co = sinf(freq * x + kHalfPi);
      } else {
        sincosf(freq * x, &s, &co);
      }
      er[dim + 2 * j * dim + ci] = from_f<T>(s);
      er[dim + (2 * j + 1) * dim + ci] = from_f<T>(co);
      freq *= 2.f;
    }
  }
}

// f(r, s, c) for every row r < ROWS of a tile, stash column s and its
// embedding column c. A thread keeps one stash column, finds its embedding
// column once and walks the rows; the block's threads cover whole stash
// rows a pass, so neighbouring threads touch neighbouring stash values.
template <int ROWS, typename F>
__device__ inline void for_stash_cells(const ChainDesc& d, F f) {
  const int t = trig_dim(d);
  for (int s0 = 0; s0 < t; s0 += kThreads) {
    const int cols = min(kThreads, t - s0), per = kThreads / cols;
    if (threadIdx.x >= per * cols) continue;
    const int s = s0 + threadIdx.x % cols, c = stash_to_embed_col(d, s);
#pragma unroll 4
    for (int r = threadIdx.x / cols; r < ROWS; r += per) f(r, s, c);
  }
}

// The stash rows of the tile (rows < n of the (n, trig_dim) stash, type
// T) from the embedding's trig columns. No barrier.
template <typename T, int ROWS = kRows>
__device__ void write_stash(const ChainDesc& d, const T* es, int lde, T* __restrict__ stash,
                            long long row0, long long n) {
  const int t = trig_dim(d);
  for_stash_cells<ROWS>(d, [&](int r, int s, int c) {
    if (row0 + r < n) stash[(row0 + r) * t + s] = es[r * lde + c];
  });
}

// The embedding's trig columns from the stash rows (padding rows get 0).
// No barrier.
template <typename T, int ROWS>
__device__ void read_stash(const ChainDesc& d, const T* __restrict__ stash, long long row0,
                           long long n, T* es, int lde) {
  const int t = trig_dim(d);
  for_stash_cells<ROWS>(d, [&](int r, int s, int c) {
    es[r * lde + c] = row0 + r < n ? stash[(row0 + r) * t + s] : from_f<T>(0.f);
  });
}

// One dense layer over the tile: out = act([in1 | in2] @ W + b). W is
// (k1 + k2, n) row-major in device memory, streamed through `ws`. The
// result goes to shared memory (`out_s`, at type T) or, for the head, to
// device memory (`out_g`, f32, rows < n_valid only, leading dimension
// `ldg`, or n if 0). ROWS is the tile's row count, a multiple of 16.
template <typename T, int ROWS = kRows>
__device__ void layer_pass(const T* in1, int ld1, int k1, const T* in2, int ld2,
                           int k2, const T* __restrict__ w,
                           const float* __restrict__ bias, int n, int act, T* ws,
                           T* out_s, int ldo, float* __restrict__ out_g,
                           long long row0, long long n_valid, int ldg = 0) {
  constexpr int kRowsPerThread = ROWS / (kThreads / 16);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k_total = k1 + k2;
  const long long ld_out = ldg > 0 ? ldg : n;
  for (int c0 = 0; c0 < n; c0 += kColChunk) {
    const int nc = min(kColChunk, n - c0);
    float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;
    for (int k0 = 0; k0 < k_total; k0 += kKTile) {
      const int kt = min(kKTile, k_total - k0);
      for (int idx = tid; idx < kKTile * kColChunk; idx += kThreads) {
        const int kk = idx / kColChunk, cc = idx % kColChunk;
        T v = from_f<T>(0.f);
        if (kk < kt && cc < nc) v = w[(long long)(k0 + kk) * n + c0 + cc];
        ws[idx] = v;
      }
      __syncthreads();
      for (int kk = 0; kk < kt; ++kk) {
        const int k = k0 + kk;
        const T* src = k < k1 ? in1 + k : in2 + (k - k1);
        const int ld = k < k1 ? ld1 : ld2;
        float a[kRowsPerThread], b[kColsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          a[i] = to_f<T>(src[(ty * kRowsPerThread + i) * ld]);
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j)
          b[j] = to_f<T>(ws[kk * kColChunk + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j)
            acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty * kRowsPerThread + i;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int c = tx + 16 * j;
        if (c >= nc) continue;
        const float v = activate(act, acc[i][j] + bias[c0 + c]);
        if (out_g != nullptr) {
          if (row0 + r < n_valid) out_g[(row0 + r) * ld_out + c0 + c] = v;
        } else {
          out_s[r * ldo + c0 + c] = from_f<T>(v);
        }
      }
    }
  }
}

// The whole chain for one tile whose raw rows are already in `xs`; y has
// out_dim(d) columns. `trig` selects the embedding's form (embed_rows);
// a non-null `stash` receives the tile's trig columns (write_stash).
template <typename T>
__device__ void chain_tile(const ChainDesc& d, const T* __restrict__ w,
                           const float* __restrict__ bias, unsigned char* smem,
                           float* __restrict__ y, long long row0, long long n,
                           int trig = kSincos, T* __restrict__ stash = nullptr) {
  const SmemLayout L = smem_layout<T>(d);
  const float* xs = reinterpret_cast<const float*>(smem + L.xs);
  T* es = reinterpret_cast<T*>(smem + L.es);
  T* bufs[2] = {reinterpret_cast<T*>(smem + L.ha), reinterpret_cast<T*>(smem + L.hb)};
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  embed_rows<T>(d, xs, es, L.lde, trig);
  __syncthreads();
  if (stash != nullptr) write_stash<T>(d, es, L.lde, stash, row0, n);
  const int ldy = out_dim(d);
  const T* in = es;
  int ld_in = L.lde, k_in = d.embed_dim;
  for (int i = 0; i < d.n_layers; ++i) {
    const bool head = i == d.n_layers - 1;
    const bool skip_in = i > 0 && d.skip_after[i - 1];
    T* out = bufs[i & 1];
    layer_pass<T>(in, ld_in, k_in, skip_in ? es : nullptr, L.lde,
                  skip_in ? d.embed_dim : 0, w + d.w_off[i], bias + d.b_off[i],
                  d.widths[i], d.acts[i], ws, out, L.ldh, head ? y : nullptr,
                  row0, n, ldy);
    in = out;
    ld_in = L.ldh;
    k_in = d.widths[i];
  }
  if (last_skip(d)) {
    // The row's trailing columns: the embedding as the layers saw it (at
    // type T), in the reference order
    const int n_out = d.widths[d.n_layers - 1];
    for (int idx = threadIdx.x; idx < kRows * d.embed_dim; idx += kThreads) {
      const int r = idx / d.embed_dim, c = idx % d.embed_dim;
      if (row0 + r < n) y[(row0 + r) * ldy + n_out + c] = to_f<T>(es[r * L.lde + c]);
    }
  }
}

// Launches `kernel` over ceil(n / kRows) tiles on `stream` with the
// chain's dynamic shared memory; returns 0 or an error code.
template <typename T, typename Kernel, typename... Args>
int launch_tiles(Kernel kernel, const ChainDesc& d, long long n,
                 cudaStream_t stream, Args... args) {
  if (int err = check_desc(d)) return err;
  if (n <= 0) return 0;
  const SmemLayout L = smem_layout<T>(d);
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (L.total > static_cast<size_t>(max_smem)) return kErrSmem;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L.total));
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kRows - 1) / kRows;
  kernel<<<static_cast<unsigned>(blocks), kThreads, L.total, stream>>>(d, args..., n);
  return static_cast<int>(cudaGetLastError());
}

// ------ backward ------

constexpr int kLdT = kColChunk + 1;  // leading dim of the transposed weight tile

__host__ __device__ inline int layer_in_dim(const ChainDesc& d, int i) {
  if (i == 0) return d.embed_dim;
  return d.widths[i - 1] + (d.skip_after[i - 1] ? d.embed_dim : 0);
}

// Element counts of the packed weights and biases.
__host__ __device__ inline long long total_weights(const ChainDesc& d) {
  const int l = d.n_layers - 1;
  return d.w_off[l] + static_cast<long long>(layer_in_dim(d, l)) * d.widths[l];
}

__host__ __device__ inline long long total_biases(const ChainDesc& d) {
  return d.b_off[d.n_layers - 1] + d.widths[d.n_layers - 1];
}

// Shared-memory layout of one backward block: raw rows (f32) | embedding
// (T) | every hidden post (T) | head post (f32) | two cotangent buffers
// (f32) | embedding cotangent and raw-input cotangent (f32, needs_dx
// only) | transposed weight tile (T).
struct BwdLayout {
  size_t xs, es, posts, hp, da, db, de, dxs, ws, total;
  int lde, ldh, ldd, post_stride;
};

template <typename T, int ROWS>
__host__ __device__ inline BwdLayout bwd_layout(const ChainDesc& d, bool needs_dx) {
  BwdLayout s;
  int widest = 0;
  for (int i = 0; i < d.n_layers; ++i) widest = d.widths[i] > widest ? d.widths[i] : widest;
  s.lde = padded_ld(d.embed_dim);
  s.ldh = padded_ld(d.max_width);
  s.ldd = padded_ld(widest);
  s.post_stride = ROWS * s.ldh;
  s.xs = 0;
  s.es = align16(s.xs + sizeof(float) * ROWS * d.raw_dim);
  s.posts = align16(s.es + sizeof(T) * ROWS * s.lde);
  s.hp = align16(s.posts + sizeof(T) * (d.n_layers - 1) * s.post_stride);
  s.da = align16(s.hp + sizeof(float) * ROWS * d.widths[d.n_layers - 1]);
  s.db = align16(s.da + sizeof(float) * ROWS * s.ldd);
  s.de = align16(s.db + sizeof(float) * ROWS * s.ldd);
  s.dxs = align16(s.de + (needs_dx ? sizeof(float) * ROWS * s.lde : 0));
  s.ws = align16(s.dxs + (needs_dx ? sizeof(float) * ROWS * d.raw_dim : 0));
  s.total = align16(s.ws + sizeof(T) * kKTile * kLdT);
  return s;
}

// The backward's row tile: the largest of 64, 32 and 16 rows whose shared
// memory fits the block's opt-in maximum; 0 if none fits (a 256-wide f32
// chain of 8 hidden layers keeps its posts only at 16 rows).
template <typename T>
inline int bwd_rows(const ChainDesc& d, bool needs_dx, int max_smem) {
  if (bwd_layout<T, 64>(d, needs_dx).total <= static_cast<size_t>(max_smem)) return 64;
  if (bwd_layout<T, 32>(d, needs_dx).total <= static_cast<size_t>(max_smem)) return 32;
  if (bwd_layout<T, 16>(d, needs_dx).total <= static_cast<size_t>(max_smem)) return 16;
  return 0;
}

// Activation derivative from the post-activation alone, as the TPU
// kernel's _act_bwd: relu' from post > 0, sigmoid' = post (1 - post),
// softplus' = sigmoid(pre) = 1 - exp(-post).
__device__ __forceinline__ float activate_bwd(int act, float post, float g) {
  switch (act) {
    case kRelu: return post > 0.f ? g : 0.f;
    case kSigmoid: return g * post * (1.f - post);
    case kSoftplus: return g * (1.f - expf(-post));
    default: return g;
  }
}

// The input cotangent of one layer, d_pre @ W^T, for input columns
// [0, k_hi). W is (K, n) row-major in device memory and is streamed
// transposed through `ws` (kKTile x kLdT: the odd leading dimension keeps
// the transposing stores on distinct banks). Columns below `hw` overwrite
// `out_h`; the rest (the embedding segment of layer 0 or of a skip
// consumer) are added into `out_e` at column k - hw.
template <typename T, int ROWS>
__device__ void dgrad_pass(const float* dpre, int ldd, int n, const T* __restrict__ w,
                           int k_hi, int hw, T* ws, float* out_h, int ldh_out,
                           float* out_e, int lde) {
  constexpr int kRowsPerThread = ROWS / (kThreads / 16);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  for (int c0 = 0; c0 < k_hi; c0 += kColChunk) {
    const int nc = min(kColChunk, k_hi - c0);
    float acc[kRowsPerThread][kColsPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = 0.f;
    for (int n0 = 0; n0 < n; n0 += kKTile) {
      const int nt = min(kKTile, n - n0);
      for (int idx = tid; idx < kKTile * kColChunk; idx += kThreads) {
        const int nn = idx % kKTile, cc = idx / kKTile;
        T v = from_f<T>(0.f);
        if (nn < nt && cc < nc) v = w[static_cast<long long>(c0 + cc) * n + n0 + nn];
        ws[nn * kLdT + cc] = v;
      }
      __syncthreads();
      for (int nn = 0; nn < nt; ++nn) {
        float a[kRowsPerThread], b[kColsPerThread];
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
          a[i] = dpre[(ty * kRowsPerThread + i) * ldd + n0 + nn];
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) b[j] = to_f<T>(ws[nn * kLdT + tx + 16 * j]);
#pragma unroll
        for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
          for (int j = 0; j < kColsPerThread; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = ty * kRowsPerThread + i;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int c = tx + 16 * j;
        if (c >= nc) continue;
        const int k = c0 + c;
        if (k < hw)
          out_h[r * ldh_out + k] = acc[i][j];
        else
          out_e[r * lde + k - hw] += acc[i][j];
      }
    }
  }
}

// dW += P^T @ d_pre over the tile's rows, added into `dw` (K x n
// row-major), the block's own slice. P's columns [0, k1) come from `p1`
// and [k1, k1 + k2) from `p2`: the [h | e] split of a skip consumer. A
// warp owns 4 rows of dW and 128 columns, so P reads are broadcasts and
// d_pre reads and the dW updates are contiguous.
template <typename T, int ROWS>
__device__ void wgrad_pass(const T* p1, int ld1, int k1, const T* p2, int ld2, int k2,
                           const float* dpre, int ldd, int n, float* __restrict__ dw) {
  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int k_total = k1 + k2;
  for (int n0 = 0; n0 < n; n0 += 128) {
    for (int k0 = 0; k0 < k_total; k0 += 4 * (kThreads / 32)) {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int r = 0; r < ROWS; ++r) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = k0 + 4 * ty + i;
          a[i] = k < k1 ? to_f<T>(p1[r * ld1 + k])
                        : (k < k_total ? to_f<T>(p2[r * ld2 + k - k1]) : 0.f);
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + tx + 32 * j;
          b[j] = c < n ? dpre[r * ldd + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = k0 + 4 * ty + i;
        if (k >= k_total) continue;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = n0 + tx + 32 * j;
          if (c < n) dw[static_cast<long long>(k) * n + c] += acc[i][j];
        }
      }
    }
  }
}

// Cotangent of the raw input rows from the embedding's: the passthrough
// columns plus d/dx sin(2^j x) = 2^j cos(2^j x) and d/dx cos(2^j x) =
// -2^j sin(2^j x), with precise sincosf as in the forward. Rows below
// `n_valid` are written to `out` (raw_dim columns, row-major). On the
// stash route (`phase`) both trig columns are sin(t + phase), and their
// derivative is 2^j cos(t + phase) of the phase recomputed in f32, as the
// TPU kernel's cos(x @ A + P).
template <int ROWS>
__device__ void embed_bwd(const ChainDesc& d, const float* xs, const float* de, int lde,
                          float* __restrict__ out, long long n_valid, bool phase = false) {
  for (int idx = threadIdx.x; idx < ROWS * d.raw_dim; idx += kThreads) {
    const int r = idx / d.raw_dim, c = idx % d.raw_dim;
    if (r >= n_valid) continue;
    int p = 0, col0 = 0, e0 = 0;
    while (c >= col0 + d.part_dim[p]) {
      col0 += d.part_dim[p];
      e0 += d.part_dim[p] * (1 + 2 * d.part_freqs[p]);
      ++p;
    }
    const int dim = d.part_dim[p], ci = c - col0;
    const float x = xs[r * d.raw_dim + c];
    const float* g = de + r * lde + e0;
    float acc = g[ci];
    float freq = 1.f;
    for (int j = 0; j < d.part_freqs[p]; ++j) {
      const float g_sin = g[dim + 2 * j * dim + ci], g_cos = g[dim + (2 * j + 1) * dim + ci];
      if (phase) {
        acc += freq * (cosf(freq * x) * g_sin + cosf(freq * x + kHalfPi) * g_cos);
      } else {
        float s, co;
        sincosf(freq * x, &s, &co);
        acc += freq * (co * g_sin - s * g_cos);
      }
      freq *= 2.f;
    }
    out[r * d.raw_dim + c] = acc;
  }
}

// One dense layer's backward once its pre-activation cotangent d_pre is in
// `dcur` (ROWS x n, leading dimension ldd): db += column sums of d_pre
// (unrounded); in bf16 mode d_pre is then rounded to bf16 before its
// products, as the TPU kernel's _dpre_mat; dW += [p1 | p2]^T d_pre; and,
// for k_hi > 0, d_pre @ W^T for input columns [0, k_hi) into `dnext`
// (columns < hw, ld ldd) and `out_e` (the rest, added). db and dw may be
// null (frozen weights). Ends at a barrier.
template <typename T, int ROWS>
__device__ void dense_bwd(float* dcur, int ldd, int n, const T* p1, int ld1, int k1,
                          const T* p2, int ld2, int k2, const T* __restrict__ w, float* dw,
                          float* db, int k_hi, int hw, T* ws, float* dnext, float* out_e,
                          int lde) {
  if (db != nullptr) {
    for (int c = threadIdx.x; c < n; c += kThreads) {
      float s = 0.f;
      for (int r = 0; r < ROWS; ++r) s += dcur[r * ldd + c];
      db[c] += s;
    }
  }
  if (sizeof(T) < sizeof(float)) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < ROWS * n; idx += kThreads) {
      float* g = dcur + (idx / n) * ldd + idx % n;
      *g = to_f<T>(from_f<T>(*g));
    }
    __syncthreads();
  }
  if (dw != nullptr) wgrad_pass<T, ROWS>(p1, ld1, k1, p2, ld2, k2, dcur, ldd, n, dw);
  if (k_hi > 0) dgrad_pass<T, ROWS>(dcur, ldd, n, w, k_hi, hw, ws, dnext, ldd, out_e, lde);
  __syncthreads();
}

// The backward of the chain for one tile: the raw rows are in `xs`, the
// head's cotangent rows in the `da` buffer (ld L.ldd) and, with needs_dx,
// `de` holds the embedding's own cotangent (zero, or for a last-skip plan
// the output's trailing columns). Leaves the embedding cotangent in `de`
// and adds the tile's dW and db into `dw_slice` / `db_slice` (packed
// layout) when needs_dw. A non-null `stash` (rows of the whole input)
// gives the embedding's trig columns for the tile at row0 of n rows; its
// sin/cos are then not recomputed.
template <typename T, int ROWS>
__device__ void chain_tile_bwd(const ChainDesc& d, bool needs_dx, bool needs_dw,
                               const T* __restrict__ w, const float* __restrict__ bias,
                               unsigned char* smem, float* dw_slice, float* db_slice,
                               const T* __restrict__ stash = nullptr, long long row0 = 0,
                               long long n = 0) {
  const BwdLayout L = bwd_layout<T, ROWS>(d, needs_dx);
  const float* xs = reinterpret_cast<const float*>(smem + L.xs);
  T* es = reinterpret_cast<T*>(smem + L.es);
  T* posts = reinterpret_cast<T*>(smem + L.posts);
  float* hp = reinterpret_cast<float*>(smem + L.hp);
  float* dcur = reinterpret_cast<float*>(smem + L.da);
  float* dnext = reinterpret_cast<float*>(smem + L.db);
  float* de = reinterpret_cast<float*>(smem + L.de);
  T* ws = reinterpret_cast<T*>(smem + L.ws);
  const int nl = d.n_layers;
  // Forward recompute, every post kept
  if (stash != nullptr) {
    embed_rows<T, ROWS>(d, xs, es, L.lde, kNoTrig);
    read_stash<T, ROWS>(d, stash, row0, n, es, L.lde);
  } else {
    embed_rows<T, ROWS>(d, xs, es, L.lde);
  }
  __syncthreads();
  const T* in = es;
  int ld_in = L.lde, k_in = d.embed_dim;
  for (int i = 0; i < nl; ++i) {
    const bool head = i == nl - 1;
    const bool skip_in = i > 0 && d.skip_after[i - 1];
    T* out = head ? nullptr : posts + i * L.post_stride;
    layer_pass<T, ROWS>(in, ld_in, k_in, skip_in ? es : nullptr, L.lde,
                        skip_in ? d.embed_dim : 0, w + d.w_off[i], bias + d.b_off[i],
                        d.widths[i], d.acts[i], ws, out, L.ldh, head ? hp : nullptr, 0,
                        ROWS);
    in = out;
    ld_in = L.ldh;
    k_in = d.widths[i];
  }
  __syncthreads();
  // Reverse walk
  for (int i = nl - 1; i >= 0; --i) {
    const int n = d.widths[i];
    const bool head = i == nl - 1;
    const T* post = posts + i * L.post_stride;
    for (int idx = threadIdx.x; idx < ROWS * n; idx += kThreads) {
      const int r = idx / n, c = idx % n;
      const float p = head ? hp[r * n + c] : to_f<T>(post[r * L.ldh + c]);
      dcur[r * L.ldd + c] = activate_bwd(d.acts[i], p, dcur[r * L.ldd + c]);
    }
    __syncthreads();
    const bool skip_in = i > 0 && d.skip_after[i - 1];
    const int hw = i > 0 ? d.widths[i - 1] : 0;
    const int k_hi = needs_dx && (i == 0 || skip_in) ? layer_in_dim(d, i) : hw;
    dense_bwd<T, ROWS>(dcur, L.ldd, n, i > 0 ? posts + (i - 1) * L.post_stride : es,
                       i > 0 ? L.ldh : L.lde, i > 0 ? hw : d.embed_dim,
                       skip_in ? es : nullptr, L.lde, skip_in ? d.embed_dim : 0,
                       w + d.w_off[i], needs_dw ? dw_slice + d.w_off[i] : nullptr,
                       needs_dw ? db_slice + d.b_off[i] : nullptr, k_hi, hw, ws, dnext, de,
                       L.lde);
    float* t = dcur;
    dcur = dnext;
    dnext = t;
  }
}

// Launches `kernel` on `blocks` blocks with `smem` bytes of dynamic shared
// memory; returns 0 or an error code.
template <typename Kernel, typename... Args>
int launch_with_smem(Kernel kernel, size_t smem, long long blocks, cudaStream_t stream,
                     Args... args) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<static_cast<unsigned>(blocks), kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

inline int max_smem_optin() {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  return max_smem;
}

// The number of dW scratch slices of a deterministic backward: the blocks
// of `kernel` (with `smem` bytes of shared memory) that the card holds at
// once, at most one per row tile.
template <typename Kernel>
int dw_slices(Kernel kernel, size_t smem, long long tiles, int* slices) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long cap = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *slices = static_cast<int>(tiles < cap ? tiles : cap);
  return 0;
}

// Sums the per-block dW slices in slice order, out[j] = sum_b part[b *
// stride + j], so the result does not depend on the order the blocks ran
// in (defined in fused_mlp.cu). Returns 0 or an error code.
int sum_slices(const float* part, int slices, long long stride, float* out,
               cudaStream_t stream);

}  // namespace nfk
