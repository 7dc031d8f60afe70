// Fused NeRF training MLP in f32 compute for Hopper (sm_90a), written by
// hand: the training forward, backward-data and weight-gradient kernels.
//
// Replace the TPU kernels `mega_nerf_tpu/render/pallas_train.py::
// _train_fwd_kernel` and `::_train_bwd_kernel` (reached through
// `fused_nerf_train_apply`) in f32 compute (`--compute_dtype float32`) at
// layer widths up to 512, and the dW half of the latter past 512. f32
// throughout: f32 weights, activations and gradients, f32 sums, as the JAX
// package computes it in f32. The forward's and the weight gradient's
// products run on the tensor cores as 3xTF32 split products, which keep
// f32-class accuracy (a single TF32 product keeps ~3 decimal digits and is
// not used); the backward-data products are FFMA.
//
// - train_f32_fwd: the eval kernel's forward (f32_forward.cuh, 3xTF32 on
//   wgmma: the same device path, so without noise its output equals the
//   eval kernel's bit for bit) plus the sigma noise before the activation;
//   it also writes every activation of a point into one f32 row
//   (fused_train.py::act_layout) from the epilogues.
// - train_f32_bwd (backward-data, the dX half of _train_bwd_kernel): from
//   the f32 rows and the (M, 4) cotangent, the heads' derivatives (sigma
//   and rgb recomputed from the rows), then the chain backwards: d_a and
//   d_app, d_final, and per trunk layer d_pre = (d_pre' W) * (h > 0), each
//   product an FFMA register tile (f32_chain.cuh), reading the packed
//   matrices along their rows; the ReLU masks come from the rows in
//   the epilogue. Writes f32 gradient rows (fused_train.py::grad_layout)
//   and d_app.
// - weight_grad_f32 (the dW half): per job, dW = D^T X and the bias sums
//   of D, in output tiles of 128 x 128 over fixed point ranges
//   (fused_f32.py::f32_wg_plan, f32_wg_split). A CTA (one an SM) streams
//   its range through a 3-stage ring of 64-point stages filled by cp.async
//   (16 bytes a copy where the operand's rows allow, else 4), and its 8
//   warps take the products on mma.sync m16n8k8 in TF32: each operand
//   element splits in registers into hi, its TF32 rounding, and lo = x -
//   hi, which the tensor cores read as TF32; lo*hi, hi*lo and hi*hi of a
//   stage chain from zero, and each chain is added into f32 totals. The
//   reduction runs over points, so both operands are staged
//   [point][column] (MN-major), which wgmma takes in TF32 only K-major;
//   mma.sync takes its fragments from registers, read as float4s at
//   transposed addresses from rows padded to 136 floats (no bank
//   conflict). Each CTA stores its partial; a second kernel adds the
//   partials of a tile in range order. No float atomics: two launches give
//   the same bits. Each job carries its own operand pointers, row widths
//   and copy widths, so the one kernel pair serves the narrow route
//   (fused_train.py::weight_grad_jobs on the saved and gradient rows) and,
//   past width 512, the wide f32 route (wide_f32.cu; each dW step of
//   fused_train_wide.py::train_wide_plan on the tensors it names).
//
// What bounds them on an H100: the forward, three TF32 products a
// multiply-add at 495 TFLOP/s; the backward-data, f32 FMAs at 67 TFLOP/s
// of FFMA. At the paper width a training pass of 524,288 points is ~0.63
// TFLOP forward (~3.85 ms of 3xTF32, ~9.5 of FFMA), ~0.59 dX (~8.8 ms of
// FFMA) and ~0.63 dW;
// the saved rows (~10 KB of f32 a point) and the gradient rows (~9.8 KB)
// are this design's own traffic, ~1.6 ms each at 3.35 TB/s. The weight
// gradient's three TF32 products a multiply-add at 495 TFLOP/s take ~3.85
// ms at that pass (~6.7 ms for a 1024 x 1024 wide layer), against ~3.1 ms
// of reading both row sets; mma.sync's own TF32 rate on the card is about
// half of that peak (scripts/f32_wide_probe.py measures it), and that sets
// the pace. Left for later work: wgmma products (a split pass writing
// K-major hi / lo tiles), TMA, persistent CTAs.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "f32_chain.cuh"
#include "f32_forward.cuh"

namespace {

using namespace f32chain;

// ------------------------------------------------------------- forward

__global__ void __launch_bounds__(f32fwd::NT, 1)
train_f32_fwd_kernel(const __grid_constant__ f32fwd::FwdMaps maps,
                     const __grid_constant__ f32fwd::FwdParams p) {
  f32fwd::forward_tile(maps, p);
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
constexpr int WG_P = 64;   // points a ring stage holds: 8 k-steps of the mma
constexpr int WG_S = 3;    // ring stages
// Floats a staged row takes: 8 mod 32 words, so the float4 fragment loads
// of a quarter-warp (stage_products) fall in eight different bank quads.
constexpr int WG_LD = WG_T + 8;
constexpr int WG_OPND = WG_P * WG_LD;              // floats of one operand's stage
constexpr int WG_SMEM = WG_S * 2 * WG_OPND * 4;    // 208,896 B
constexpr int WG_ELEMS = WG_T * WG_T + WG_T;       // partial tile + bias row

// A job of the weight gradient (fused_f32.py::weight_grad_f32_jobs): dW[r][c] (at
// out_off + r * stride + c of the flat buffer) = sum_p d[p][d_col + r]
// x[p][x_col + c] for r < n, c < k, and db[r] (at bias_off, when >= 0) =
// sum_p d[p][d_col + r]; d and x are row-major f32 with rows of d_ld and
// x_ld floats; copy says which operands the ring fills by 16-byte copies
// (WG_COPY_D16, WG_COPY_X16: every row's first column on 16 B), the others
// by 4-byte ones. The narrow route's jobs all read its gradient and saved
// rows, the wide route's the tensors it names.
constexpr int WG_JOB = 12;  // d, x, d_ld, x_ld, d_col, n, x_col, k, out_off, stride, bias_off, copy
constexpr int WG_COPY_D16 = 1, WG_COPY_X16 = 2;

struct WgParams {
  float* out;              // flat gradients (fused_train.py::packed_shapes order)
  float* scratch;          // (splits, tiles, WG_ELEMS)
  const long long* jobs;   // (jobs, WG_JOB)
  const long long* tiles;  // (tiles, 3): job, n0, k0
  int M, ntiles, split_len;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Points p0 .. p0 + WG_P - 1 (zero from `end` on) of columns [col, col +
// live) (zero past live) of a row-major f32 operand into a stage of WG_P
// rows of WG_LD floats, by cp.async: a warp copies one point's 128 columns
// at a time, 16 bytes a lane where `vec`, else 4.
__device__ __forceinline__ void stage_rows(float* st, const float* src, int ld, int col,
                                           int live, int p0, int end, bool vec) {
  const uint32_t base = smem_addr(st);
  if (vec) {
#pragma unroll
    for (int r = 0; r < WG_P * WG_T / 4 / NT; ++r) {
      const int e = r * NT + threadIdx.x;
      const int pt = e >> 5, c = 4 * (e & 31);
      const int m = p0 + pt;
      const int bytes = m < end ? 4 * max(0, min(4, live - c)) : 0;
      cp_async16(base + 4 * (pt * WG_LD + c), bytes ? src + (size_t)m * ld + col + c : src,
                 bytes);
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < WG_P * WG_T / NT; ++r) {
      const int e = r * NT + threadIdx.x;
      const int pt = e >> 7, c = e & 127;
      const int m = p0 + pt;
      const int bytes = m < end && c < live ? 4 : 0;
      cp_async4(base + 4 * (pt * WG_LD + c), bytes ? src + (size_t)m * ld + col + c : src,
                bytes);
    }
  }
}

// x = hi + lo for the tensor cores, which read a TF32 operand's top 19 bits
// (sign, exponent, 10 mantissa bits): hi is x rounded to TF32, to nearest
// with ties away from zero (cvt.rna.tf32.f32's result for finite x, by an
// integer add and mask), and lo the exact rest x - hi, which the tensor
// cores truncate to TF32 (~2^-21 of x); a NaN survives in lo.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// c += A B over one k-step of 8 points: A (16 x 8) rows of d values, B
// (8 x 8) columns of x values, in the m16n8k8 fragment layouts.
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The tensor cores add into their f32 sums without rounding to nearest
// (bits below the running sum's last place are dropped), so the error of
// one accumulator grows with the chain of products added into it: a whole
// split's chain (2,624 k-steps at the paper fg-fine pass) lost 1.5e-4 of
// the f64 sums on an H100. So a chain runs WG_CHAIN k-steps from zero and
// is then added into the f32 totals (round to nearest), a whole number of
// stages: a stage's 8 k-steps kept 5.8e-7 there (16 k-steps 9.2e-7) and
// ran fastest (scripts/f32_wide_probe.py), for 64 more registers a thread
// (one CTA an SM).
constexpr int WG_CHAIN = 8;
static_assert(WG_CHAIN % (WG_P / 8) == 0, "a chain spans whole stages");

// A warp's 64 x 32 block of the tile (rows from wm, columns from wn) as
// 4 x 4 m16n8k8 tiles. Which output row or column a fragment slot holds is
// free, as long as A and C agree on rows and B and C on columns; it is
// chosen so that each lane reads its fragments as float4s: lane 4 g + q
// takes, of m-tile i = 2 c + b, rows wm + 32 c + 4 g + 2 b + {0, 1} (the
// fragment's rows g, g + 8), and of n-tile j the columns wn + 4 n + j of
// fragment column n (lane group g = n in B). So a k-step's A is two
// float4s (c = 0, 1) at each of points q and q + 4, and its B one float4
// at each; with rows WG_LD = 8 mod 32 words apart, each quarter-warp's
// eight float4s fall in eight different bank quads.
//
// One stage's products into the running chains: 3xTF32, lo*hi, hi*lo, then
// hi*hi (lo*lo, ~2^-22 of a product, is left out), each term over the 4
// n-tiles in turn, so that neighbouring mma.sync do not wait on each other.
// ds / xs point at the stage's rows of d and x at the lane's point q and
// first row / column. RAGGED: only the rows of c below cl (the warp's live
// 32-row halves).
template <bool RAGGED>
__device__ __forceinline__ void stage_products(float (&ch)[4][4][4], const float* ds,
                                               const float* xs, int cl) {
#pragma unroll
  for (int ks = 0; ks < WG_P / 8; ++ks) {
    const float* d = ds + 8 * ks * WG_LD;
    const float* x = xs + 8 * ks * WG_LD;
    const float4 x0 = *reinterpret_cast<const float4*>(x);
    const float4 x1 = *reinterpret_cast<const float4*>(x + 4 * WG_LD);
    const float xv[2][4] = {{x0.x, x0.y, x0.z, x0.w}, {x1.x, x1.y, x1.z, x1.w}};
    uint32_t bh[4][2], bl[4][2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      split_tf32(xv[0][j], bh[j][0], bl[j][0]);
      split_tf32(xv[1][j], bh[j][1], bl[j][1]);
    }
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      if (RAGGED && c >= cl) continue;
      const float4 d0 = *reinterpret_cast<const float4*>(d + 32 * c);
      const float4 d1 = *reinterpret_cast<const float4*>(d + 4 * WG_LD + 32 * c);
      const float dv[2][4] = {{d0.x, d0.y, d0.z, d0.w}, {d1.x, d1.y, d1.z, d1.w}};
#pragma unroll
      for (int b = 0; b < 2; ++b) {
        const int i = 2 * c + b;
        uint32_t ah[4], al[4];
        split_tf32(dv[0][2 * b], ah[0], al[0]);      // row g, point q
        split_tf32(dv[0][2 * b + 1], ah[1], al[1]);  // row g + 8, point q
        split_tf32(dv[1][2 * b], ah[2], al[2]);      // row g, point q + 4
        split_tf32(dv[1][2 * b + 1], ah[3], al[3]);  // row g + 8, point q + 4
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(ch[i][j], al, bh[j][0], bh[j][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(ch[i][j], ah, bl[j][0], bl[j][1]);
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_tf32(ch[i][j], ah, bh[j][0], bh[j][1]);
      }
    }
  }
}

// The chains into the f32 totals, and the chains restarted from zero.
__device__ __forceinline__ void flush_chains(float (&acc)[4][4][4], float (&ch)[4][4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        acc[i][j][r] = acc[i][j][r] + ch[i][j][r];
        ch[i][j][r] = 0.f;
      }
}

// CTA (tile, split): the tile's partial dW and bias over the split's
// points. A WG_S-stage ring of WG_P-point stages, filled by cp.async
// WG_S - 1 stages ahead of the products, one barrier a stage. Warp w owns
// rows wm = 64 (w % 2) .. + 63 and columns wn = 32 (w / 2) .. + 31 of the
// tile (stage_products says which lane holds which); a warp with no live
// row or column skips its products, and one whose second 32-row half is
// past the job's rows skips that half. Every sum runs in point order, so
// a launch repeats bit for bit. Where the tile has a bias, thread t sums
// column t % 128 over the first (t < 128) or second half of every stage's
// points in point order, and the two halves are added at the end.
__global__ void __launch_bounds__(NT, 1) wg_tf32x3_kernel(const __grid_constant__ WgParams p) {
  extern __shared__ __align__(16) float ring[];  // WG_S x [d rows | x rows]
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
  const bool d_vec = job[11] & WG_COPY_D16, x_vec = job[11] & WG_COPY_X16;
  const int begin = split * p.split_len;
  const int end = min(p.M, begin + p.split_len);
  const int stages = (end - begin + WG_P - 1) / WG_P;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int g = lane >> 2, q = lane & 3;
  const int wm = 64 * (warp & 1), wn = 32 * (warp >> 1);
  // The warp's live 32-row halves (0 also where none of its columns is live).
  const int cl = wn < k_live ? max(0, min(2, (n_live - wm + 31) / 32)) : 0;
  const int bcol = t & (WG_T - 1), bpt = WG_P / 2 * (t >> 7);

  const auto load = [&](int s) {
    float* st = ring + (s % WG_S) * 2 * WG_OPND;
    const int p0 = begin + s * WG_P;
    stage_rows(st, dsrc, d_ld, d_col, n_live, p0, end, d_vec);
    stage_rows(st + WG_OPND, xsrc, x_ld, x_col, k_live, p0, end, x_vec);
  };

  float acc[4][4][4], ch[4][4][4];  // the f32 totals, the running chains
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = ch[i][j][r] = 0.f;
  float bsum = 0.f;
#pragma unroll
  for (int s = 0; s < WG_S - 1; ++s) {
    if (s < stages) load(s);
    cp_async_commit();
  }
  for (int s = 0; s < stages; ++s) {
    cp_async_wait<WG_S - 2>();  // stage s has landed (this thread's copies)
    __syncthreads();            // everyone's copies; everyone done with stage s - 1
    if (s + WG_S - 1 < stages) load(s + WG_S - 1);
    cp_async_commit();
    const float* ds = ring + (s % WG_S) * 2 * WG_OPND;
    const float* xs = ds + WG_OPND;
    const float* da = ds + q * WG_LD + wm + 4 * g;
    const float* xa = xs + q * WG_LD + wn + 4 * g;
    if (cl == 2)
      stage_products<false>(ch, da, xa, 2);
    else if (cl == 1)
      stage_products<true>(ch, da, xa, 1);
    if ((s + 1) % (WG_CHAIN / (WG_P / 8)) == 0 || s + 1 == stages) flush_chains(acc, ch);
    if (bias) {
#pragma unroll
      for (int pt = 0; pt < WG_P / 2; ++pt) bsum = bsum + ds[(bpt + pt) * WG_LD + bcol];
    }
  }

  // acc[i][j][r]: row wm + 32 c + 4 g + 2 b + (r >> 1) (i = 2 c + b),
  // column wn + 4 (2 q + (r & 1)) + j: each (i, r) is 4 neighbouring columns.
  float* part = p.scratch + ((size_t)split * p.ntiles + tile) * WG_ELEMS;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = wm + 32 * (i >> 1) + 4 * g + 2 * (i & 1) + (r >> 1);
      const int col = wn + 8 * q + 4 * (r & 1);
      *reinterpret_cast<float4*>(part + row * WG_T + col) =
          make_float4(acc[i][0][r], acc[i][1][r], acc[i][2][r], acc[i][3][r]);
    }
  if (bias) {
    cp_async_wait<0>();
    __syncthreads();  // the ring is free
    if (t >= WG_T) ring[bcol] = bsum;
    __syncthreads();
    if (t < WG_T) part[WG_T * WG_T + t] = bsum + ring[t];
  }
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

// ptrs, dims, plan, shapes, rests: as eval_f32_launch (fused_mlp.py::
//   launch_tables, fused_f32.py::f32_fwd_plan, w_rests); extra: noise (or
//   0), the saved rows;
//   cols: act_width, final, dir, app, branch (fused_train.py::act_layout).
int train_f32_fwd_launch(const long long* ptrs, const int* dims, const int* plan,
                         const int* shapes, const long long* rests, const long long* extra,
                         const int* cols, void* stream) {
  f32fwd::FwdParams p;
  f32fwd::FwdMaps maps;
  int smem = 0;
  const int err = f32fwd::fwd_setup(ptrs, dims, plan, shapes, rests, p, maps, smem);
  if (err) return err;
  p.noise = reinterpret_cast<const float*>(extra[0]);
  p.act = reinterpret_cast<float*>(extra[1]);
  p.act_width = cols[0];
  p.act_final = cols[1];
  p.act_dir = cols[2];
  p.act_app = cols[3];
  p.act_branch = cols[4];
  // The epilogues store pairs of columns: even row widths and columns.
  if (p.act == nullptr || p.act_width % 2 || p.act_final % 2 || p.act_branch % 2)
    return (int)cudaErrorInvalidValue;
  if (p.M <= 0) return 0;
  return f32fwd::fwd_launch(train_f32_fwd_kernel, maps, p, smem,
                            reinterpret_cast<cudaStream_t>(stream));
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
  cudaError_t err = cudaFuncSetAttribute(
      wg_tf32x3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, WG_SMEM);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  wg_tf32x3_kernel<<<dim3(p.ntiles, splits), NT, WG_SMEM, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wg_reduce_kernel<<<dim3((WG_ELEMS + NT - 1) / NT, p.ntiles), NT, 0, s>>>(p, splits);
  return (int)cudaGetLastError();
}

const char* train_f32_error_string(int code) { return f32fwd::fwd_error_string(code); }

}  // extern "C"
