// Fused NeRF training MLP in f32 compute for Hopper (sm_90a), written by
// hand: the training forward, backward-data and weight-gradient kernels.
//
// Replace the TPU kernels `mega_nerf_tpu/render/pallas_train.py::
// _train_fwd_kernel` and `::_train_bwd_kernel` (reached through
// `fused_nerf_train_apply`) in f32 compute (`--compute_dtype float32`) at
// layer widths up to 512. True f32 throughout: f32 weights, activations
// and gradients, FFMA products, f32 sums (no TF32, no bf16 tensor-core
// product), as the JAX package computes it in f32.
//
// - train_f32_fwd: the eval chain of eval_f32.cu (the same f32_chain.cuh
//   code, so without noise its output equals the eval kernel's bit for
//   bit) plus the sigma noise before the activation; it also writes every
//   activation of a point into one f32 row (fused_train.py::act_layout).
// - train_f32_bwd (backward-data, the dX half of _train_bwd_kernel): from
//   the f32 rows and the (M, 4) cotangent, the heads' derivatives (sigma
//   and rgb recomputed from the rows), then the chain backwards: d_a and
//   d_app, d_final, and per trunk layer d_pre = (d_pre' W) * (h > 0), each
//   product the same FFMA register tile as the forward's, reading the
//   packed matrices along their rows; the ReLU masks come from the rows in
//   the epilogue. Writes f32 gradient rows (fused_train.py::grad_layout)
//   and d_app.
// - weight_grad_f32 (the dW half): per job, dW = D^T X and the bias sums
//   of D, in output tiles of 128 x 128 over fixed point ranges
//   (fused_f32.py::f32_wg_plan, f32_wg_split); each CTA sums its range in
//   point order into registers and stores its partial; a second kernel
//   adds the partials of a tile in range order. No float atomics: two
//   launches give the same bits. Each job carries its own operand
//   pointers and row widths, so the one kernel pair serves the narrow
//   route (fused_train.py::weight_grad_jobs on the saved and gradient
//   rows) and, past width 512, the wide f32 route (wide_f32.cu; each dW
//   step of fused_train_wide.py::train_wide_plan on the tensors it names).
//
// What bounds them on an H100: f32 FMAs, at 67 TFLOP/s of FFMA. At the
// paper width a training pass of 524,288 points is ~0.63 TFLOP forward,
// ~0.59 dX and ~0.63 dW (~9.5, 8.8 and 9.5 ms); the saved rows (~10 KB of
// f32 a point) and the gradient rows (~9.8 KB) are this design's own
// traffic, ~1.6 ms each at 3.35 TB/s. Left for later work: 3xTF32 or
// wgmma products, TMA, persistent CTAs.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "f32_chain.cuh"

namespace {

using namespace f32chain;

// ------------------------------------------------------------- forward

template <int TP>
__global__ void __launch_bounds__(NT, 1) train_f32_fwd_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  forward_tile<TP>(p, smem);
}

// --------------------------------------------------------- backward-data

struct BwdParams {
  const float* act;    // (M, act_width) saved rows
  float* grad;         // (M, grad_width) gradient rows
  const float* g;      // (M, 4) cotangent
  const float* noise;  // (M,) or null
  float* d_app;        // (M, app_dim) or null
  const float* w_sigma;
  const float* b_sigma;
  const float* w_rgb;  // (3, rgb_in)
  const float* b_rgb;
  const float* w[MAX_MATS];  // packed (N, Ktot)
  int ld[MAX_MATS];
  int M, D, layers, has_branch, shifted_softplus, app_dim, skip_mask, EP, DP, KB;
  int act_width, grad_width, act_h0, act_branch, g_dfinal, g_da, g_heads;
  // The plan (fused_f32.py::f32_bwd_plan).
  int tm, x_off, y_off, w_off, heads_off;
};

// Columns [col, col + width) of the rows m0 .. m0 + tm - 1 into rows of a
// tile (zero past M).
__device__ __forceinline__ void rows_to_tile(const float* rows, int ld, int col, int width,
                                             int m0, int M, float* tile, int tm) {
  for (int idx = threadIdx.x; idx < tm * width; idx += NT) {
    const int pt = idx / width;
    const int c = idx - pt * width;
    const int m = m0 + pt;
    tile[tix(tm, c, pt)] = m < M ? __ldg(rows + (size_t)m * ld + col + c) : 0.f;
  }
}

// Zero the sums whose activation (the rows' column col + n) is not > 0.
template <int TP>
__device__ __forceinline__ void relu_mask(float (&v)[TP][8], const float* act, int ld,
                                          int col, int m0, int M, int n0, int nlim, int p0,
                                          int c0) {
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int m = m0 + p0 + i;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + col_of(c0, 4 * h);
      float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
      if (m < M && n < nlim)
        a = __ldg(reinterpret_cast<const float4*>(act + (size_t)m * ld + col + n));
      v[i][4 * h] = a.x > 0.f ? v[i][4 * h] : 0.f;
      v[i][4 * h + 1] = a.y > 0.f ? v[i][4 * h + 1] : 0.f;
      v[i][4 * h + 2] = a.z > 0.f ? v[i][4 * h + 2] : 0.f;
      v[i][4 * h + 3] = a.w > 0.f ? v[i][4 * h + 3] : 0.f;
    }
  }
}

template <int TP>
__global__ void __launch_bounds__(NT, 1) train_f32_bwd_kernel(const __grid_constant__ BwdParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  float* tx = reinterpret_cast<float*>(smem + p.x_off);
  float* ty = reinterpret_cast<float*>(smem + p.y_off);
  float* wbuf = reinterpret_cast<float*>(smem + p.w_off);
  float* hd = reinterpret_cast<float*>(smem + p.heads_off);  // (tm, 4) [g_sig, g_rgb]
  const int tm = p.tm;
  const int m0 = blockIdx.x * tm;
  const int t = threadIdx.x;
  int p0, c0;
  place<TP>(p0, c0);
  const int D = p.D, L = p.layers;
  const int half = D / 2;
  const int h_last = p.act_h0 + (L - 1) * D;

  rows_to_tile(p.act, p.act_width, h_last, D, m0, p.M, tx, tm);
  if (p.has_branch) rows_to_tile(p.act, p.act_width, p.act_branch, half, m0, p.M, ty, tm);
  __syncthreads();

  // The heads' derivatives: a thread per point, sigma and rgb recomputed
  // from the rows.
  if (t < tm) {
    const int m = m0 + t;
    float s = 0.f;
    for (int n = 0; n < D; ++n) s = fmaf(tx[tix(tm, n, t)], __ldg(p.w_sigma + n), s);
    s = s + p.b_sigma[0];
    if (p.noise != nullptr && m < p.M) s = s + __ldg(p.noise + m);
    const float* src = p.has_branch ? ty : tx;
    const int rin = p.has_branch ? half : D;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int n = 0; n < rin; ++n) {
      const float x = src[tix(tm, n, t)];
      a0 = fmaf(x, __ldg(p.w_rgb + n), a0);
      a1 = fmaf(x, __ldg(p.w_rgb + rin + n), a1);
      a2 = fmaf(x, __ldg(p.w_rgb + 2 * rin + n), a2);
    }
    const float4 g = m < p.M ? __ldg(reinterpret_cast<const float4*>(p.g) + m)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    const float s0 = 1.f / (1.f + expf(-(a0 + p.b_rgb[0])));
    const float s1 = 1.f / (1.f + expf(-(a1 + p.b_rgb[1])));
    const float s2 = 1.f / (1.f + expf(-(a2 + p.b_rgb[2])));
    const float gr = g.x * s0 * (1.f - s0);
    const float gg = g.y * s1 * (1.f - s1);
    const float gb = g.z * s2 * (1.f - s2);
    const float gs = p.shifted_softplus ? g.w * (1.f / (1.f + expf(-(s - 1.f))))
                                        : (s > 0.f ? g.w : 0.f);
    reinterpret_cast<float4*>(hd)[t] = make_float4(gs, gr, gg, gb);
    if (m < p.M) {
      float4* row = reinterpret_cast<float4*>(p.grad + (size_t)m * p.grad_width + p.g_heads);
      row[0] = make_float4(gs, gr, gg, gb);
      row[1] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();

  float* cur;
  if (p.has_branch) {
    // d_a = (g_rgb w_rgb) * (branch > 0), zero from D / 2 to KB, in place
    // over the branch tile.
    for (int idx = t; idx < tm * p.KB; idx += NT) {
      const int pt = idx / p.KB;
      const int j = idx - pt * p.KB;
      float v = 0.f;
      if (j < half) {
        const float4 h4 = reinterpret_cast<const float4*>(hd)[pt];
        float u = h4.y * __ldg(p.w_rgb + j);
        u = fmaf(h4.z, __ldg(p.w_rgb + half + j), u);
        u = fmaf(h4.w, __ldg(p.w_rgb + 2 * half + j), u);
        v = ty[tix(tm, j, pt)] > 0.f ? u : 0.f;
      }
      ty[tix(tm, j, pt)] = v;
      const int m = m0 + pt;
      if (m < p.M) p.grad[(size_t)m * p.grad_width + p.g_da + j] = v;
    }
    const Seg sa[1] = {{ty, p.KB, 0}};
    const int a = L + 1;
    if (p.app_dim > 0) {
      const Wts wt = {p.w[a], p.ld[a], D + p.DP, p.app_dim, half};
      for (int n0 = 0; n0 < p.app_dim; n0 += NB) {
        float acc[TP][8];
        product<TP>(acc, sa, 1, wt, n0, wbuf, p0, c0);
#pragma unroll
        for (int i = 0; i < TP; ++i) {
          const int m = m0 + p0 + i;
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int n = n0 + col_of(c0, j);
            if (m < p.M && n < p.app_dim) p.d_app[(size_t)m * p.app_dim + n] = acc[i][j];
          }
        }
      }
    }
    {  // d_final = d_a W_a[:, :D] into the h tile and the rows
      const Wts wt = {p.w[a], p.ld[a], 0, D, half};
      for (int n0 = 0; n0 < D; n0 += NB) {
        float acc[TP][8];
        product<TP>(acc, sa, 1, wt, n0, wbuf, p0, c0);
        store_tile<TP>(acc, tx, tm, n0, D, p0, c0);
        store_rows<TP>(acc, p.grad, p.grad_width, p.g_dfinal, m0, p.M, n0, D, p0, c0);
      }
    }
    {  // d_pre_{L-1} = (d_final W_final + g_sigma w_sigma) * (h_{L-1} > 0)
      const Seg sf[1] = {{tx, D, 0}};
      const Wts wt = {p.w[L], p.ld[L], 0, D, D};
      for (int n0 = 0; n0 < D; n0 += NB) {
        float acc[TP][8];
        product<TP>(acc, sf, 1, wt, n0, wbuf, p0, c0);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + col_of(c0, j);
          const float ws = n < D ? __ldg(p.w_sigma + n) : 0.f;
#pragma unroll
          for (int i = 0; i < TP; ++i) acc[i][j] = acc[i][j] + hd[4 * (p0 + i)] * ws;
        }
        relu_mask<TP>(acc, p.act, p.act_width, h_last, m0, p.M, n0, D, p0, c0);
        store_tile<TP>(acc, ty, tm, n0, D, p0, c0);
        store_rows<TP>(acc, p.grad, p.grad_width, (L - 1) * D, m0, p.M, n0, D, p0, c0);
      }
    }
    cur = ty;
  } else {
    // d_pre_{L-1} = (g_sigma w_sigma + g_rgb w_rgb) * (h_{L-1} > 0), in
    // place over the h tile.
    for (int idx = t; idx < tm * D; idx += NT) {
      const int pt = idx / D;
      const int n = idx - pt * D;
      const float4 h4 = reinterpret_cast<const float4*>(hd)[pt];
      float u = h4.y * __ldg(p.w_rgb + n);
      u = fmaf(h4.z, __ldg(p.w_rgb + D + n), u);
      u = fmaf(h4.w, __ldg(p.w_rgb + 2 * D + n), u);
      u = h4.x * __ldg(p.w_sigma + n) + u;
      const float v = tx[tix(tm, n, pt)] > 0.f ? u : 0.f;
      tx[tix(tm, n, pt)] = v;
      const int m = m0 + pt;
      if (m < p.M) p.grad[(size_t)m * p.grad_width + (L - 1) * D + n] = v;
    }
    cur = tx;
  }

  // Down the trunk: d_pre_{i-1} = (d_pre_i W_i[:, h columns]) * (h_{i-1} > 0).
  for (int i = L - 1; i >= 1; --i) {
    float* dst = cur == tx ? ty : tx;
    const Seg sc[1] = {{cur, D, 0}};
    const Wts wt = {p.w[i], p.ld[i], ((p.skip_mask >> i) & 1) ? p.EP : 0, D, D};
    const int hcol = p.act_h0 + (i - 1) * D;
    for (int n0 = 0; n0 < D; n0 += NB) {
      float acc[TP][8];
      product<TP>(acc, sc, 1, wt, n0, wbuf, p0, c0);
      relu_mask<TP>(acc, p.act, p.act_width, hcol, m0, p.M, n0, D, p0, c0);
      if (i > 1) store_tile<TP>(acc, dst, tm, n0, D, p0, c0);
      store_rows<TP>(acc, p.grad, p.grad_width, (i - 1) * D, m0, p.M, n0, D, p0, c0);
    }
    cur = dst;
  }
}

// ------------------------------------------------------- weight gradient

constexpr int WG_T = 128;  // output tile: 128 (n) x 128 (k)
constexpr int WG_P = 32;   // points per chunk
constexpr int WG_ELEMS = WG_T * WG_T + WG_T;  // partial tile + bias row

// A job of the weight gradient (fused_f32.py::weight_grad_f32_jobs): dW[r][c] (at
// out_off + r * stride + c of the flat buffer) = sum_p d[p][d_col + r]
// x[p][x_col + c] for r < n, c < k, and db[r] (at bias_off, when >= 0) =
// sum_p d[p][d_col + r]; d and x are row-major f32 with rows of d_ld and
// x_ld floats. The narrow route's jobs all read its gradient and saved
// rows, the wide route's the tensors it names.
constexpr int WG_JOB = 11;  // d, x, d_ld, x_ld, d_col, n, x_col, k, out_off, stride, bias_off

struct WgParams {
  float* out;              // flat gradients (fused_train.py::packed_shapes order)
  float* scratch;          // (splits, tiles, WG_ELEMS)
  const long long* jobs;   // (jobs, WG_JOB)
  const long long* tiles;  // (tiles, 3): job, n0, k0
  int M, ntiles, split_len;
};

// CTA (tile, split): the tile's partial dW and bias over the split's
// points, summed in point order. Thread t owns rows 4 (t / 16) + {0..3}
// and 64 + 4 (t / 16) + {0..3}, columns 4 (t % 16) + {0..3} and 64 + ...;
// threads 0..127 also sum bias column t.
__global__ void __launch_bounds__(NT) wg_partial_kernel(const __grid_constant__ WgParams p) {
  __shared__ __align__(16) float ds[WG_P][WG_T];
  __shared__ __align__(16) float xs[WG_P][WG_T];
  const int tile = blockIdx.x, split = blockIdx.y;
  const long long* tl = p.tiles + 3 * tile;
  const long long* job = p.jobs + WG_JOB * tl[0];
  const float* dsrc = reinterpret_cast<const float*>(job[0]);
  const float* xsrc = reinterpret_cast<const float*>(job[1]);
  const int d_ld = (int)job[2], x_ld = (int)job[3];
  const int n0 = (int)tl[1], k0 = (int)tl[2];
  const int d_col = (int)job[4] + n0, n_live = min(WG_T, (int)job[5] - n0);
  const int x_col = (int)job[6] + k0, k_live = min(WG_T, (int)job[7] - k0);
  const bool bias = job[10] >= 0 && k0 == 0;
  const int begin = split * p.split_len;
  const int end = min(p.M, begin + p.split_len);
  const int t = threadIdx.x;
  const int tn = t >> 4, tk = t & 15;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  float bsum = 0.f;
  float rd[16], rx[16];
  const auto load = [&](int pp0) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int e = r * NT + t;
      const int pt = e >> 7, c = e & 127;
      const int m = pp0 + pt;
      rd[r] = (m < end && c < n_live) ? __ldg(dsrc + (size_t)m * d_ld + d_col + c) : 0.f;
      rx[r] = (m < end && c < k_live) ? __ldg(xsrc + (size_t)m * x_ld + x_col + c) : 0.f;
    }
  };
  load(begin);
  for (int pp0 = begin; pp0 < end; pp0 += WG_P) {
#pragma unroll
    for (int r = 0; r < 16; ++r) {
      const int e = r * NT + t;
      ds[e >> 7][e & 127] = rd[r];
      xs[e >> 7][e & 127] = rx[r];
    }
    __syncthreads();
    if (pp0 + WG_P < end) load(pp0 + WG_P);
#pragma unroll 4
    for (int pt = 0; pt < WG_P; ++pt) {
      const float4 a0 = *reinterpret_cast<const float4*>(&ds[pt][4 * tn]);
      const float4 a1 = *reinterpret_cast<const float4*>(&ds[pt][64 + 4 * tn]);
      const float4 b0 = *reinterpret_cast<const float4*>(&xs[pt][4 * tk]);
      const float4 b1 = *reinterpret_cast<const float4*>(&xs[pt][64 + 4 * tk]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    if (bias && t < WG_T)
      for (int pt = 0; pt < WG_P; ++pt) bsum = bsum + ds[pt][t];
    __syncthreads();
  }
  float* part = p.scratch + ((size_t)split * p.ntiles + tile) * WG_ELEMS;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = (i < 4 ? 0 : 64 - 4) + 4 * tn + i;
    *reinterpret_cast<float4*>(part + row * WG_T + 4 * tk) =
        make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
    *reinterpret_cast<float4*>(part + row * WG_T + 64 + 4 * tk) =
        make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
  }
  if (t < WG_T) part[WG_T * WG_T + t] = bsum;
}

// Each live output element: its tile's partials added in split order.
__global__ void __launch_bounds__(NT) wg_reduce_kernel(const __grid_constant__ WgParams p,
                                                       int splits) {
  const int e = blockIdx.x * NT + threadIdx.x;
  const int tile = blockIdx.y;
  if (e >= WG_ELEMS) return;
  const long long* tl = p.tiles + 3 * tile;
  const long long* job = p.jobs + WG_JOB * tl[0];
  const long long n0 = tl[1], k0 = tl[2];
  float* dst = nullptr;
  if (e < WG_T * WG_T) {
    const int i = e >> 7, j = e & 127;
    if (n0 + i < job[5] && k0 + j < job[7]) dst = p.out + job[8] + (n0 + i) * job[9] + k0 + j;
  } else {
    const int i = e - WG_T * WG_T;
    if (job[10] >= 0 && k0 == 0 && n0 + i < job[5]) dst = p.out + job[10] + n0 + i;
  }
  if (dst == nullptr) return;
  float s = 0.f;
  const float* src = p.scratch + (size_t)tile * WG_ELEMS + e;
  for (int sp = 0; sp < splits; ++sp) s = s + src[(size_t)sp * p.ntiles * WG_ELEMS];
  *dst = s;
}

template <typename K, typename P>
int launch_fwd_like(K kernel, const P& p, int smem, int grid, cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs, dims, plan, shapes: as eval_f32_launch (fused_mlp.py::launch_tables
//   with the transposed matrices, fused_f32.py::f32_fwd_plan); extra: noise
//   (or 0), the saved rows;
//   cols: act_width, final, dir, app, branch (fused_train.py::act_layout).
int train_f32_fwd_launch(const long long* ptrs, const int* dims, const int* plan,
                         const int* shapes, const long long* extra, const int* cols,
                         void* stream) {
  FwdParams p = {};
  p.xyz = reinterpret_cast<const float*>(ptrs[0]);
  p.dirs = reinterpret_cast<const float*>(ptrs[1]);
  p.app = reinterpret_cast<const float*>(ptrs[2]);
  p.out = reinterpret_cast<float*>(ptrs[3]);
  p.w_sigma = reinterpret_cast<const float*>(ptrs[4]);
  p.b_sigma = reinterpret_cast<const float*>(ptrs[5]);
  p.w_rgb = reinterpret_cast<const float*>(ptrs[6]);
  p.b_rgb = reinterpret_cast<const float*>(ptrs[7]);
  p.M = dims[0];
  p.xyz_dim = dims[1];
  p.nf_xyz = dims[2];
  p.nf_dir = dims[3];
  p.layers = dims[4];
  p.D = dims[5];
  p.app_dim = dims[6];
  p.skip_mask = dims[7];
  p.has_branch = dims[8];
  p.shifted_softplus = dims[9];
  p.EP = dims[10];
  p.DP = dims[11];
  p.AP = dims[12];
  p.tm = plan[0];
  p.enc_off = plan[1];
  p.dir_off = plan[2];
  p.app_off = plan[3];
  p.x_off = plan[4];
  p.y_off = plan[5];
  p.w_off = plan[6];
  p.sig_off = plan[7];
  const int smem = plan[8];
  p.noise = reinterpret_cast<const float*>(extra[0]);
  p.act = reinterpret_cast<float*>(extra[1]);
  p.act_width = cols[0];
  p.act_final = cols[1];
  p.act_dir = cols[2];
  p.act_app = cols[3];
  p.act_branch = cols[4];
  const int nmat = p.layers + (p.has_branch ? 2 : 0);
  if (nmat > MAX_MATS || (p.tm != 64 && p.tm != 32) || p.xyz_dim > 4 || p.D % 16 ||
      p.act == nullptr)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nmat; ++i) {
    p.w[i] = reinterpret_cast<const float*>(ptrs[8 + 2 * i]);
    p.bias[i] = reinterpret_cast<const float*>(ptrs[9 + 2 * i]);
    p.kt[i] = shapes[2 * i + 1];
  }
  if (p.M <= 0) return 0;
  const int grid = (p.M + p.tm - 1) / p.tm;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return p.tm == 64 ? launch_fwd_like(train_f32_fwd_kernel<8>, p, smem, grid, s)
                    : launch_fwd_like(train_f32_fwd_kernel<4>, p, smem, grid, s);
}

// ptrs: act, grad, g, noise (or 0), d_app (or 0), w_sigma, b_sigma, w_rgb,
//   b_rgb, then the packed matrices in fused_mlp.py::mat_layout order.
// dims: M, D, layers, has_branch, shifted_softplus, app_dim, skip_mask, EP,
//   DP, KB, act_width, grad_width, act h0, act branch, grad dfinal, grad da,
//   grad heads (fused_train.py::act_layout, grad_layout).
// plan: tm, x_off, y_off, w_off, heads_off, smem_bytes (f32_bwd_plan).
// shapes: (N, Ktot) per matmul layer.
int train_f32_bwd_launch(const long long* ptrs, const int* dims, const int* plan,
                         const int* shapes, void* stream) {
  BwdParams p = {};
  p.act = reinterpret_cast<const float*>(ptrs[0]);
  p.grad = reinterpret_cast<float*>(ptrs[1]);
  p.g = reinterpret_cast<const float*>(ptrs[2]);
  p.noise = reinterpret_cast<const float*>(ptrs[3]);
  p.d_app = reinterpret_cast<float*>(ptrs[4]);
  p.w_sigma = reinterpret_cast<const float*>(ptrs[5]);
  p.b_sigma = reinterpret_cast<const float*>(ptrs[6]);
  p.w_rgb = reinterpret_cast<const float*>(ptrs[7]);
  p.b_rgb = reinterpret_cast<const float*>(ptrs[8]);
  p.M = dims[0];
  p.D = dims[1];
  p.layers = dims[2];
  p.has_branch = dims[3];
  p.shifted_softplus = dims[4];
  p.app_dim = dims[5];
  p.skip_mask = dims[6];
  p.EP = dims[7];
  p.DP = dims[8];
  p.KB = dims[9];
  p.act_width = dims[10];
  p.grad_width = dims[11];
  p.act_h0 = dims[12];
  p.act_branch = dims[13];
  p.g_dfinal = dims[14];
  p.g_da = dims[15];
  p.g_heads = dims[16];
  p.tm = plan[0];
  p.x_off = plan[1];
  p.y_off = plan[2];
  p.w_off = plan[3];
  p.heads_off = plan[4];
  const int smem = plan[5];
  const int nmat = p.layers + (p.has_branch ? 2 : 0);
  if (nmat > MAX_MATS || (p.tm != 64 && p.tm != 32) || p.D % 16 || p.KB > p.D ||
      (p.app_dim > 0 && p.d_app == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nmat; ++i) {
    p.w[i] = reinterpret_cast<const float*>(ptrs[9 + i]);
    p.ld[i] = shapes[2 * i + 1];
  }
  if (p.M <= 0) return 0;
  const int grid = (p.M + p.tm - 1) / p.tm;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return p.tm == 64 ? launch_fwd_like(train_f32_bwd_kernel<8>, p, smem, grid, s)
                    : launch_fwd_like(train_f32_bwd_kernel<4>, p, smem, grid, s);
}

// ptrs: out, scratch, table (device: jobs x WG_JOB, then tiles x 3, int64,
//   as fused_f32.py::weight_grad_f32_jobs lays them out); dims: M, jobs,
//   tiles, splits, split_len.
int weight_grad_f32_launch(const long long* ptrs, const int* dims, void* stream) {
  WgParams p = {};
  p.out = reinterpret_cast<float*>(ptrs[0]);
  p.scratch = reinterpret_cast<float*>(ptrs[1]);
  p.jobs = reinterpret_cast<const long long*>(ptrs[2]);
  p.tiles = p.jobs + (size_t)WG_JOB * dims[1];
  p.M = dims[0];
  p.ntiles = dims[2];
  const int splits = dims[3];
  p.split_len = dims[4];
  if (dims[1] <= 0 || p.ntiles <= 0 || splits <= 0 || p.split_len % WG_P)
    return (int)cudaErrorInvalidValue;
  if (p.M <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  wg_partial_kernel<<<dim3(p.ntiles, splits), NT, 0, s>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wg_reduce_kernel<<<dim3((WG_ELEMS + NT - 1) / NT, p.ntiles), NT, 0, s>>>(p, splits);
  return (int)cudaGetLastError();
}

const char* train_f32_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
