// Kernels K2-fwd and K2-bwd: the Rusinkiewicz transform fused into the
// frozen BRDF chain.
//
// K2-fwd replaces the TPU kernel nerfactor_tpu/ops/pallas_rusink.py
// _pallas_fwd -> _fwd_kernel: per row, rusink = dir2rusink(ldir, vdir)
// (phi_d, theta_h, theta_d), then the chain [z | posenc(rusink)] -> 128 x
// 4 MLP -> softplus head, without writing rusink or the embedding to
// device memory.
//
// K2-bwd replaces _pallas_bwd -> _bwd_kernel: it recomputes the transform
// and the chain, runs the chain backward for the input cotangent only (the
// prior's weights are frozen: no dW, so no cross-block reduction), and
// turns the rusink cotangent into (d_ldir, d_vdir) with the hand-derived
// safe-gradient VJP of _rusink_bwd, one thread per row.
//
// Bound by arithmetic: ~54k multiply-adds a row forward (the backward
// about twice that on top of the recompute) against 36 B in and 4 B out.
// The transform runs one thread per row in f32 with the precise
// acosf/atan2f (the TPU kernel's atan polynomial existed only because
// Mosaic lacks both). Each kernel runs as one of two designs, chosen by
// one rule on the plan (ops/fused_rusink.py rusink_on_tensor_cores):
//
//   * bf16 on the plans the library takes (nfk_rusink_chain_tc_runs:
//     chain_tc_plan's, every hidden act ReLU, a block that fits; the
//     shipped BRDF chain): the tensor-core kernels, a block a 64-row tile,
//     two blocks an SM, the transform loading the tile's raw rows.
//     rusink_chain_fwd_tc_kernel is K1-fwd's tensor-core kernel with this
//     loader (chain_fwd_tc_tile, chain_tc.cuh). rusink_chain_bwd_tc_kernel
//     runs chain_tile_dx_tc: the recompute on the tensor cores keeping each
//     ReLU post's sign as a bit in shared memory (no scratch: with no dW
//     the backward needs nothing else of the posts), the tiny head in f32
//     on the CUDA cores, then d_pre @ W^T of every layer on the tensor
//     cores with the embedding's rows of W (layer 0's and the skip
//     consumer's) adding into an f32 embedding cotangent; the embedding's
//     and the transform's VJPs on the CUDA cores. ~100 KB of shared memory
//     a block. What bounds them is what bounds K1's tensor-core kernels:
//     the weight ring's barrier every 32 K, the epilogues and the head on
//     the CUDA cores.
//   * every other call (f32; other plans): the CUDA-core kernels, which
//     share K1's CUDA-core tiling (chain_mlp.cuh): 64 rows a block,
//     activations resident in shared memory, weights streamed through a
//     shared-memory tile, f32 FMA loops. In bf16 they are the comparison
//     the tensor-core kernels are held against.
//
// Inputs: z (n, z_dim), ldir (n, 3), vdir (n, 3), all f32 row-major; the
// chain's raw input is [z | rusink], so desc.raw_dim == z_dim + 3.

#include "chain_mlp.cuh"
#include "chain_tc.cuh"

namespace nfk {

constexpr float kPi = 3.14159265358979323846f;

__device__ __forceinline__ void safe_normalize(const float* v, float* out) {
  const float s = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const float r = 1.f / sqrtf(fmaxf(s, 1e-6f));  // safe_l2_normalize
  out[0] = v[0] * r;
  out[1] = v[1] * r;
  out[2] = v[2] * r;
}

// Rodrigues rotation of v about a coordinate axis (0: x, 1: y, 2: z), in
// the term order of nerfactor_tpu/ops/geom.py _rot_vec.
__device__ __forceinline__ void rot_axis(const float* v, int axis, float angle, float* out) {
  const float c = cosf(angle), s = sinf(angle);
  const float dot = v[axis];
  const int a1 = (axis + 1) % 3, a2 = (axis + 2) % 3;
  // cross(e_axis, v): component a1 = -v[a2], component a2 = v[a1]
  out[axis] = v[axis] * c + dot * (1.f - c);
  out[a1] = v[a1] * c - v[a2] * s;
  out[a2] = v[a2] * c + v[a1] * s;
}

// (phi_d, theta_h, theta_d) of nerfactor_tpu/ops/geom.py dir2rusink.
__device__ void dir2rusink(const float* l, const float* v, float* out) {
  float a[3], b[3], h[3], b1[3], diff[3];
  safe_normalize(l, a);
  safe_normalize(v, b);
  const float hv[3] = {(a[0] + b[0]) / 2.f, (a[1] + b[1]) / 2.f, (a[2] + b[2]) / 2.f};
  safe_normalize(hv, h);
  const float theta_h = acosf(fminf(fmaxf(h[2], -1.f), 1.f));
  const float phi_h = atan2f(h[1], h[0]);
  rot_axis(b, 2, -phi_h, b1);
  rot_axis(b1, 1, -theta_h, diff);
  const float theta_d = acosf(fminf(fmaxf(diff[2], -1.f), 1.f));
  // Floored modulo, as jnp.mod: fmodf truncates, so shift negatives by pi
  float phi_d = fmodf(atan2f(diff[1], diff[0]), kPi);
  if (phi_d != 0.f && phi_d < 0.f) phi_d += kPi;
  out[0] = phi_d;
  out[1] = theta_h;
  out[2] = theta_d;
}

constexpr float kEps = 1e-6f;  // ops/math.py EPS

// VJP of y = x / sqrt(max(|x|^2, EPS)) given s = |x|^2, r = 1/sqrt(max(s, EPS)).
__device__ __forceinline__ void normalize_vjp(const float* x, float s, float r, const float* g,
                                              float* out) {
  const float dot = g[0] * x[0] + g[1] * x[1] + g[2] * x[2];
  const float scale = s > kEps ? dot * r * r * r : 0.f;
  for (int c = 0; c < 3; ++c) out[c] = g[c] * r - x[c] * scale;
}

// Cotangents (gl, gv) of dir2rusink's inputs from (g_pd, g_th, g_td), with
// the safe-gradient rules of ops/math.py (nerfactor_tpu/ops/pallas_rusink.py
// _rusink_fwd / _rusink_bwd, term for term): safe_atan2 divides by
// a^2 + b^2 + EPS, safe_acos clips and uses -1/(sqrt(1 - x^2 + EPS) + EPS),
// the mod passes its cotangent through, and each normalisation is the
// where(s > EPS) VJP.
__device__ void rusink_vjp(const float* l, const float* v, float g_pd, float g_th_out,
                           float g_td, float* gl, float* gv) {
  const float sa = l[0] * l[0] + l[1] * l[1] + l[2] * l[2];
  const float ra = 1.f / sqrtf(fmaxf(sa, kEps));
  const float sb = v[0] * v[0] + v[1] * v[1] + v[2] * v[2];
  const float rb = 1.f / sqrtf(fmaxf(sb, kEps));
  const float a[3] = {l[0] * ra, l[1] * ra, l[2] * ra};
  const float b[3] = {v[0] * rb, v[1] * rb, v[2] * rb};
  const float hv[3] = {(a[0] + b[0]) / 2.f, (a[1] + b[1]) / 2.f, (a[2] + b[2]) / 2.f};
  const float sh = hv[0] * hv[0] + hv[1] * hv[1] + hv[2] * hv[2];
  const float rh = 1.f / sqrtf(fmaxf(sh, kEps));
  const float h0 = hv[0] * rh, h1 = hv[1] * rh, h2 = hv[2] * rh;
  const float th = acosf(fminf(fmaxf(h2, -1.f), 1.f));
  const float ph = atan2f(h1, h0);
  const float c1 = cosf(ph), s1 = sinf(ph);
  const float b1x = b[0] * c1 + b[1] * s1;
  const float b1y = -b[0] * s1 + b[1] * c1;
  const float b1z = b[2];
  const float c2 = cosf(th), s2 = sinf(th);
  const float dx = b1x * c2 - b1z * s2;
  const float dy = b1y;
  const float dz = b1z * c2 + b1x * s2;
  // phi_d = mod(safe_atan2(dy, dx), pi)
  const float den_d = dy * dy + dx * dx + kEps;
  const float g_dy = g_pd * (dx / den_d);
  const float g_dx = g_pd * (-dy / den_d);
  // theta_d = safe_acos(dz)
  const float dz_c = fminf(fmaxf(dz, -1.f), 1.f);
  const float g_dz = g_td * (-1.f / (sqrtf(1.f - dz_c * dz_c + kEps) + kEps));
  // diff = Ry(-theta_h) b1, theta_h an input too
  const float g_b1x = g_dx * c2 + g_dz * s2;
  const float g_b1y = g_dy;
  const float g_b1z = -g_dx * s2 + g_dz * c2;
  const float g_th = g_th_out + g_dx * (-b1x * s2 - b1z * c2) + g_dz * (b1x * c2 - b1z * s2);
  // b1 = Rz(-phi_h) b, phi_h an input too
  float g_b[3] = {g_b1x * c1 - g_b1y * s1, g_b1x * s1 + g_b1y * c1, g_b1z};
  const float g_ph = g_b1x * (-b[0] * s1 + b[1] * c1) + g_b1y * (-b[0] * c1 - b[1] * s1);
  // theta_h = safe_acos(h2); phi_h = safe_atan2(h1, h0)
  const float h2_c = fminf(fmaxf(h2, -1.f), 1.f);
  const float g_h2 = g_th * (-1.f / (sqrtf(1.f - h2_c * h2_c + kEps) + kEps));
  const float den_h = h1 * h1 + h0 * h0 + kEps;
  const float g_h[3] = {g_ph * (-h1 / den_h), g_ph * (h0 / den_h), g_h2};
  // h = normalize(hv), hv = (a + b) / 2
  float g_hv[3];
  normalize_vjp(hv, sh, rh, g_h, g_hv);
  const float g_a[3] = {g_hv[0] / 2.f, g_hv[1] / 2.f, g_hv[2] / 2.f};
  for (int c = 0; c < 3; ++c) g_b[c] += g_hv[c] / 2.f;
  // a = normalize(ldir), b = normalize(vdir)
  normalize_vjp(l, sa, ra, g_a, gl);
  normalize_vjp(v, sb, rb, g_b, gv);
}

// The tile's raw chain rows [z | dir2rusink(l, v)] into `xs`.
__device__ void load_rusink_rows(const float* __restrict__ z, const float* __restrict__ ldir,
                                 const float* __restrict__ vdir, int raw_dim, int rows,
                                 long long row0, long long n, float* xs) {
  const int z_dim = raw_dim - 3;
  for (int idx = threadIdx.x; idx < rows * z_dim; idx += kThreads) {
    const int r = idx / z_dim, c = idx % z_dim;
    xs[r * raw_dim + c] = row0 + r < n ? z[(row0 + r) * z_dim + c] : 0.f;
  }
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    float rusink[3] = {0.f, 0.f, 0.f};
    if (row0 + r < n) {
      const float l[3] = {ldir[(row0 + r) * 3], ldir[(row0 + r) * 3 + 1],
                          ldir[(row0 + r) * 3 + 2]};
      const float v[3] = {vdir[(row0 + r) * 3], vdir[(row0 + r) * 3 + 1],
                          vdir[(row0 + r) * 3 + 2]};
      dir2rusink(l, v, rusink);
    }
    for (int c = 0; c < 3; ++c) xs[r * raw_dim + z_dim + c] = rusink[c];
  }
}

// The tile's rows below n of dz (n, z_dim), dl and dv (n, 3) from the raw
// rows' cotangent dxs ([dz | d_rusink], raw_dim columns a row): d_rusink
// through rusink_vjp, one thread a row.
__device__ void store_rusink_grads(const ChainDesc& d, const float* __restrict__ ldir,
                                   const float* __restrict__ vdir, const float* dxs, int rows,
                                   long long row0, long long n, float* __restrict__ dz,
                                   float* __restrict__ dl, float* __restrict__ dv) {
  const int z_dim = d.raw_dim - 3;
  for (int r = threadIdx.x; r < rows; r += kThreads) {
    const long long row = row0 + r;
    if (row >= n) continue;
    const float* g = dxs + r * d.raw_dim;
    for (int c = 0; c < z_dim; ++c) dz[row * z_dim + c] = g[c];
    const float l[3] = {ldir[row * 3], ldir[row * 3 + 1], ldir[row * 3 + 2]};
    const float v[3] = {vdir[row * 3], vdir[row * 3 + 1], vdir[row * 3 + 2]};
    float gl[3], gv[3];
    rusink_vjp(l, v, g[z_dim], g[z_dim + 1], g[z_dim + 2], gl, gv);
    for (int c = 0; c < 3; ++c) {
      dl[row * 3 + c] = gl[c];
      dv[row * 3 + c] = gv[c];
    }
  }
}

template <typename T, int ROWS>
__global__ void __launch_bounds__(kThreads)
rusink_chain_bwd_kernel(ChainDesc d, const float* __restrict__ z,
                        const float* __restrict__ ldir, const float* __restrict__ vdir,
                        const float* __restrict__ dy, const T* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ dz,
                        float* __restrict__ dl, float* __restrict__ dv, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const BwdLayout L = bwd_layout<T, ROWS>(d, true);
  const long long row0 = static_cast<long long>(blockIdx.x) * ROWS;
  const int n_out = d.widths[d.n_layers - 1];
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* da = reinterpret_cast<float*>(smem + L.da);
  float* de = reinterpret_cast<float*>(smem + L.de);
  float* dxs = reinterpret_cast<float*>(smem + L.dxs);
  load_rusink_rows(z, ldir, vdir, d.raw_dim, ROWS, row0, n, xs);
  for (int idx = threadIdx.x; idx < ROWS * n_out; idx += kThreads) {
    const int r = idx / n_out, c = idx % n_out;
    da[r * L.ldd + c] = row0 + r < n ? dy[(row0 + r) * n_out + c] : 0.f;
  }
  for (int idx = threadIdx.x; idx < ROWS * L.lde; idx += kThreads) de[idx] = 0.f;
  __syncthreads();
  chain_tile_bwd<T, ROWS>(d, true, false, w, bias, smem, nullptr, nullptr);
  embed_bwd<ROWS>(d, xs, de, L.lde, dxs, ROWS);
  __syncthreads();
  store_rusink_grads(d, ldir, vdir, dxs, ROWS, row0, n, dz, dl, dv);
}

template <typename T>
int rusink_chain_bwd(const ChainDesc& d, const float* z, const float* ldir, const float* vdir,
                     const float* dy, const void* w, const float* bias, float* dz, float* dl,
                     float* dv, long long n, cudaStream_t stream) {
  const T* wt = static_cast<const T*>(w);
  switch (bwd_rows<T>(d, true, max_smem_optin())) {
    case 64:
      return launch_with_smem(rusink_chain_bwd_kernel<T, 64>, bwd_layout<T, 64>(d, true).total,
                              (n + 63) / 64, stream, d, z, ldir, vdir, dy, wt, bias, dz, dl,
                              dv, n);
    case 32:
      return launch_with_smem(rusink_chain_bwd_kernel<T, 32>, bwd_layout<T, 32>(d, true).total,
                              (n + 31) / 32, stream, d, z, ldir, vdir, dy, wt, bias, dz, dl,
                              dv, n);
    case 16:
      return launch_with_smem(rusink_chain_bwd_kernel<T, 16>, bwd_layout<T, 16>(d, true).total,
                              (n + 15) / 16, stream, d, z, ldir, vdir, dy, wt, bias, dz, dl,
                              dv, n);
    default:
      return kErrSmem;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
rusink_chain_fwd_kernel(ChainDesc d, const float* __restrict__ z,
                        const float* __restrict__ ldir, const float* __restrict__ vdir,
                        const T* __restrict__ w, const float* __restrict__ bias,
                        float* __restrict__ y, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * kRows;
  float* xs = reinterpret_cast<float*>(smem + smem_layout<T>(d).xs);
  load_rusink_rows(z, ldir, vdir, d.raw_dim, kRows, row0, n, xs);
  __syncthreads();
  chain_tile<T>(d, w, bias, smem, y, row0, n);
}

// ------ bf16 K2-fwd and K2-bwd on the tensor cores ------

// A block a 64-row tile: the raw rows [z | dir2rusink(l, v)], then
// chain_fwd_tc_tile, as K1-fwd's tensor-core kernel.
template <bool kTwoBuffers>
__global__ void __launch_bounds__(kThreads, 2)
rusink_chain_fwd_tc_kernel(ChainDesc d, const float* __restrict__ z,
                           const float* __restrict__ ldir, const float* __restrict__ vdir,
                           const bf16* __restrict__ w, const bf16* __restrict__ wt,
                           const float* __restrict__ bias, float* __restrict__ y, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long row0 = static_cast<long long>(blockIdx.x) * tc::kTcRows;
  float* xs = reinterpret_cast<float*>(smem + chain_tc_layout(d, false).xs);
  load_rusink_rows(z, ldir, vdir, d.raw_dim, tc::kTcRows, row0, n, xs);
  __syncthreads();
  chain_fwd_tc_tile<kTwoBuffers>(d, w, wt, bias, smem, y, row0, n);
}

// A block a 64-row tile: the raw rows, the head's cotangent rows (zero past
// n) and a zero embedding cotangent, then chain_tile_dx_tc, the
// embedding's VJP and the transform's.
template <bool kTwoBuffers>
__global__ void __launch_bounds__(kThreads, 2)
rusink_chain_bwd_tc_kernel(ChainDesc d, const float* __restrict__ z,
                           const float* __restrict__ ldir, const float* __restrict__ vdir,
                           const float* __restrict__ dy, const bf16* __restrict__ w,
                           const bf16* __restrict__ wt, const float* __restrict__ bias,
                           float* __restrict__ dz, float* __restrict__ dl,
                           float* __restrict__ dv, long long n) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int R = tc::kTcRows;
  const ChainDxLayout L = chain_dx_layout(d);
  const long long row0 = static_cast<long long>(blockIdx.x) * R;
  const int no = d.widths[d.n_layers - 1];
  float* xs = reinterpret_cast<float*>(smem + L.t.xs);
  float* dq = reinterpret_cast<float*>(smem + L.t.dq);
  float* de = reinterpret_cast<float*>(smem + L.de);
  float* dxs = reinterpret_cast<float*>(smem + L.dxs);
  load_rusink_rows(z, ldir, vdir, d.raw_dim, R, row0, n, xs);
  for (int idx = threadIdx.x; idx < R * no; idx += kThreads) {
    const long long r = row0 + idx / no;
    dq[idx] = r < n ? dy[r * no + idx % no] : 0.f;
  }
  for (int idx = threadIdx.x; idx < R * L.ldde; idx += kThreads) de[idx] = 0.f;
  __syncthreads();
  chain_tile_dx_tc<kTwoBuffers>(d, w, wt, bias, smem);
  embed_bwd<R>(d, xs, de, L.ldde, dxs, R);
  __syncthreads();
  store_rusink_grads(d, ldir, vdir, dxs, R, row0, n, dz, dl, dv);
}

}  // namespace nfk

extern "C" {

int nfk_rusink_chain_fwd(const nfk::ChainDesc* desc, int bf16, const float* z,
                         const float* ldir, const float* vdir, const void* w,
                         const float* bias, float* y, long long n, void* stream) {
  if (desc->raw_dim < 4 || nfk::last_skip(*desc)) return nfk::kErrBadPlan;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return nfk::launch_tiles<__nv_bfloat16>(
        nfk::rusink_chain_fwd_kernel<__nv_bfloat16>, *desc, n, s, z, ldir, vdir,
        static_cast<const __nv_bfloat16*>(w), bias, y);
  return nfk::launch_tiles<float>(nfk::rusink_chain_fwd_kernel<float>, *desc, n, s,
                                  z, ldir, vdir, static_cast<const float*>(w), bias, y);
}

// K2-bwd: dz (n, z_dim), dl (n, 3), dv (n, 3), f32.
int nfk_rusink_chain_bwd(const nfk::ChainDesc* desc, int bf16, const float* z,
                         const float* ldir, const float* vdir, const float* dy,
                         const void* w, const float* bias, float* dz, float* dl, float* dv,
                         long long n, void* stream) {
  if (desc->raw_dim < 4 || nfk::last_skip(*desc)) return nfk::kErrBadPlan;
  if (int err = nfk::check_desc(*desc)) return err;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return nfk::rusink_chain_bwd<__nv_bfloat16>(*desc, z, ldir, vdir, dy, w, bias, dz, dl, dv,
                                                n, s);
  return nfk::rusink_chain_bwd<float>(*desc, z, ldir, vdir, dy, w, bias, dz, dl, dv, n, s);
}

// Whether nfk_rusink_chain_fwd_tc and nfk_rusink_chain_bwd_tc run the plan
// (*runs = 1): chain_tc_plan's plans without a skip after the head (K2's
// kernels take none, as its CUDA-core ones) whose hidden layers are all
// ReLU and whose backward block fits the card's shared memory
// (check_chain_dx_tc).
// The wrapper's rule (ops/fused_rusink.py rusink_on_tensor_cores) asks it
// for both kernels; every other plan keeps the CUDA-core kernels.
int nfk_rusink_chain_tc_runs(const nfk::ChainDesc* desc, int* runs) {
  if (int err = nfk::check_desc(*desc)) return err;
  *runs = desc->raw_dim >= 4 && !nfk::last_skip(*desc) && nfk::check_chain_dx_tc(*desc) == 0;
  return 0;
}

// K2-fwd in bf16 on the tensor cores: y (n, out_dim) f32. w holds the bf16
// weights (the head's are read), wt each hidden layer's transpose, as
// nfk_chain_fwd_tc takes them.
int nfk_rusink_chain_fwd_tc(const nfk::ChainDesc* desc, const float* z, const float* ldir,
                            const float* vdir, const void* w, const void* wt,
                            const float* bias, float* y, long long n, void* stream) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (desc->raw_dim < 4 || nfk::last_skip(*desc)) return nfk::kErrBadPlan;
  if (int err = nfk::check_chain_tc(*desc, false)) return err;
  if (n <= 0) return 0;
  const auto kernel = desc->max_width > nfk::tc::kTcCols ? nfk::rusink_chain_fwd_tc_kernel<true>
                                                         : nfk::rusink_chain_fwd_tc_kernel<false>;
  return nfk::launch_with_smem(kernel, nfk::chain_tc_layout(*desc, false).total,
                               (n + nfk::tc::kTcRows - 1) / nfk::tc::kTcRows,
                               static_cast<cudaStream_t>(stream), *desc, z, ldir, vdir,
                               static_cast<const nfk::bf16*>(w),
                               static_cast<const nfk::bf16*>(wt), bias, y, n);
}

// K2-bwd in bf16 on the tensor cores: dz (n, z_dim), dl (n, 3), dv (n, 3),
// f32, for dy (n, out_dim); w and wt as nfk_rusink_chain_fwd_tc takes them.
int nfk_rusink_chain_bwd_tc(const nfk::ChainDesc* desc, const float* z, const float* ldir,
                            const float* vdir, const float* dy, const void* w, const void* wt,
                            const float* bias, float* dz, float* dl, float* dv, long long n,
                            void* stream) {
  if (int err = nfk::check_desc(*desc)) return err;
  if (desc->raw_dim < 4 || nfk::last_skip(*desc)) return nfk::kErrBadPlan;
  if (int err = nfk::check_chain_dx_tc(*desc)) return err;
  if (n <= 0) return 0;
  const auto kernel = desc->max_width > nfk::tc::kTcCols ? nfk::rusink_chain_bwd_tc_kernel<true>
                                                         : nfk::rusink_chain_bwd_tc_kernel<false>;
  return nfk::launch_with_smem(kernel, nfk::chain_dx_layout(*desc).total,
                               (n + nfk::tc::kTcRows - 1) / nfk::tc::kTcRows,
                               static_cast<cudaStream_t>(stream), *desc, z, ldir, vdir, dy,
                               static_cast<const nfk::bf16*>(w),
                               static_cast<const nfk::bf16*>(wt), bias, dz, dl, dv, n);
}

}  // extern "C"
