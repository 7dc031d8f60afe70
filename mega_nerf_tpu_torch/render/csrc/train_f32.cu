// Fused NeRF training MLP in f32 compute for Hopper (sm_90a), written by
// hand: the training forward, backward-data and weight-gradient kernels.
//
// Replace the TPU kernels `mega_nerf_tpu/render/pallas_train.py::
// _train_fwd_kernel` and `::_train_bwd_kernel` (reached through
// `fused_nerf_train_apply`) in f32 compute (`--compute_dtype float32`) at
// layer widths up to 512, and the dW half of the latter past 512. f32
// throughout: f32 weights, activations and gradients, f32 sums, as the JAX
// package computes it in f32. Every layer product runs on the tensor cores
// as 3xTF32 split products, which keep f32-class accuracy (a single TF32
// product keeps ~3 decimal digits and is not used).
//
// - train_f32_fwd: the eval kernel's forward (f32_forward.cuh, 3xTF32 on
//   wgmma: the same device path, so without noise its output equals the
//   eval kernel's bit for bit) plus the sigma noise before the activation;
//   it also writes every activation of a point into one f32 row
//   (fused_train.py::act_layout) from the epilogues.
// - train_f32_bwd (backward-data, the dX half of _train_bwd_kernel): from
//   the f32 rows and the (M, 4) cotangent, the heads' derivatives (sigma
//   and rgb recomputed from the rows), the elementwise start (d_a, or
//   d_pre_{L-1} without the branch), then the chain backwards: d_app,
//   d_final, d_pre_{L-1} = (d_final W_final + g_sigma w_sigma) * (h > 0)
//   and per trunk layer d_pre_{i-1} = (d_pre_i W_i[:, h]) * (h_{i-1} > 0).
//   Writes f32 gradient rows (fused_train.py::grad_layout) and d_app. Its
//   products are the forward's (f32_forward.cuh `layer` / `products`: the
//   TMA ring, register-A split, two fragment sets held until their waits,
//   chains of 2 k-stages into f32 totals, 64-point tiles in place
//   to width 256 and 32-point ping-pong tiles past it) with B = the
//   transposed matrices (Ktot, N) (fused_train.py::transposed_weights),
//   which are K-major for the backward's reduction over N, beside their
//   TF32 rests (fused_f32.py::t_rests; TF32 wgmma takes no transposed
//   operand). A product's rows of a transposed matrix start at its box
//   coordinate: EP at a skip layer; 0, or D + DP for d_app, in dir_a's.
//   The gradient tile holds the branch rows, then d_a in place, then each
//   product's output; the masks (h > 0) come from the saved rows in the
//   epilogue, every load issued before the barrier and the first store.
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
// What bounds them on an H100: three TF32 products a multiply-add at 495
// TFLOP/s. At the paper width a training pass of 524,288 points is ~0.63
// TFLOP forward (~3.85 ms of 3xTF32, ~9.5 of FFMA), ~0.59 dX (~3.58 ms,
// ~8.8 of FFMA) and ~0.63 dW (~3.85 ms); the saved rows (~10 KB of f32 a
// point) and the gradient rows (~9.8 KB) are this design's own traffic,
// ~1.6 ms each at 3.35 TB/s, and the backward-data also reads ~8.5 KB a
// point of masks. mma.sync's own TF32 rate on the card is about half of
// wgmma's (scripts/f32_wide_probe.py measures it), and that sets the
// weight gradient's pace. Left for later work: the weight gradient on
// wgmma (a split pass writing K-major hi / lo tiles), persistent CTAs.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "f32_forward.cuh"

namespace {

using namespace f32fwd;

// ------------------------------------------------------------- forward

__global__ void __launch_bounds__(NT, 1)
train_f32_fwd_kernel(const __grid_constant__ FwdMaps maps, const __grid_constant__ FwdParams p) {
  forward_tile(maps, p);
}

// --------------------------------------------------------- backward-data

// What a product's epilogue does: d_app (to global memory only), d_final
// (no mask), trunk_final (totals seeded with g_sigma w_sigma, masked) or a
// trunk layer (masked).
constexpr int BWD_APP = 0, BWD_FINAL = 1, BWD_MASK_SIGMA = 2, BWD_MASK = 3;
// k-stages of a chain (the forward's CHAIN_STAGES is 4): the tensor cores'
// f32 adds truncate, and the backward carries that error through every
// product of the chain; with chains of 2 its worst gradient-row segment at
// the paper width sits at 5.3e-6 of f64 sums, with 4 at 8.5e-6 (against
// a 1e-5 limit), for 1.6% more time (scripts/f32_fwd_probe.py, an H100).
constexpr int BWD_CHAIN_STAGES = 2;

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
  int ktot[MAX_MATS];  // rows of each transposed matrix
  int M, D, layers, has_branch, shifted_softplus, app_dim, skip_mask, EP, DP, KB;
  int act_width, grad_width, act_h0, act_branch, g_dfinal, g_da, g_heads;
  // The plan (fused_f32.py::f32_bwd_plan): the tile, the ring's stages and
  // byte offsets from the 1024-aligned base (x_off == y_off: in place).
  int tm, stages, ring_off, x_off, y_off, heads_off, bar_off;
};

// Tensor maps of the transposed matrices (Ktot, N) and of their TF32
// rests, as the forward's of the packed ones: boxes of min(Ktot, 128) rows
// x 32 columns, 128-byte swizzle, zeros past the matrix.
struct BwdMaps {
  CUtensorMap w[MAX_MATS];
  CUtensorMap wlo[MAX_MATS];
};

// One product of the chain: rows [row0, row0 + N) of transposed matrix
// `mat` over the gradient tile's first K columns; `gcol` the gradient-row
// column its output goes to, `mcol` the saved-row column of its mask (-1:
// none).
struct BwdProd {
  int mat, row0, N, K, kind, gcol, mcol;
};

__device__ __forceinline__ int bwd_count(const BwdParams& p) {
  return (p.has_branch ? 2 + (p.app_dim > 0) : 0) + p.layers - 1;
}

// Product q, in the order the kernel runs them: with the branch, d_app
// (where the model has appearance), d_final and trunk_final; then trunk
// layers L - 1 .. 1.
__device__ __forceinline__ BwdProd bwd_product(const BwdParams& p, int q) {
  const int L = p.layers, D = p.D;
  if (p.has_branch) {
    if (p.app_dim > 0) {
      if (q == 0) return {L + 1, D + p.DP, p.app_dim, p.KB, BWD_APP, 0, -1};
      --q;
    }
    if (q == 0) return {L + 1, 0, D, p.KB, BWD_FINAL, p.g_dfinal, -1};
    if (q == 1) return {L, 0, D, D, BWD_MASK_SIGMA, (L - 1) * D, p.act_h0 + (L - 1) * D};
    q -= 2;
  }
  const int i = L - 1 - q;
  return {i, ((p.skip_mask >> i) & 1) ? p.EP : 0, D, D, BWD_MASK, (i - 1) * D,
          p.act_h0 + (i - 1) * D};
}

// Where p holds, store v at a (a predicated instruction, not a branch).
__device__ __forceinline__ void st_global1_if(float* a, float v, bool p) {
  asm volatile(
      "{\n.reg .pred q;\nsetp.ne.s32 q, %2, 0;\n@q st.global.f32 [%0], %1;\n}\n" ::"l"(a),
      "f"(v), "r"((int)p)
      : "memory");
}

// The epilogue of product `pr` (for f32_forward.cuh's `layer`): totals
// seeded with zero, or with g_sigma w_sigma for trunk_final; the mask
// (h > 0) of the saved rows applied before the barrier, every load issued
// before the first store; then the tile `dst` and the gradient rows, or
// d_app's rows only.
struct BwdEpi {
  const BwdParams& p;
  BwdProd pr;
  float* dst;
  int m0;
  const float* hd;  // (tm, 4): g_sigma, g_rgb a point
  const Place& pl;

  __device__ __forceinline__ int col0(int nb) const { return BN * nb + 64 * pl.wg + 2 * pl.q; }

  // Accumulator i: row r0 + 8 ((i / 2) % 2), column col0 + 8 (i / 4) + i % 2.
  __device__ __forceinline__ void start(float (&acc)[32], int nb) const {
    const bool sigma = pr.kind == BWD_MASK_SIGMA;
    const int n0 = col0(nb);
    const float gs0 = sigma ? hd[4 * min(pl.r0, p.tm - 1)] : 0.f;
    const float gs1 = sigma ? hd[4 * min(pl.r0 + 8, p.tm - 1)] : 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float ws = sigma ? __ldg(p.w_sigma + min(n0 + 8 * (i / 4) + i % 2, p.D - 1)) : 0.f;
      acc[i] = ((i >> 1) & 1 ? gs1 : gs0) * ws;
    }
  }

  __device__ __forceinline__ void finish(float (&acc)[32], int nb) const {
    if (pr.mcol < 0) return;  // a branch on the product, the same for every thread
    const int n0 = col0(nb);
    float2 mk[2][8];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int m = min(m0 + pl.r0 + 8 * rr, p.M - 1);
      const float* row = p.act + (size_t)m * p.act_width + pr.mcol;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mk[rr][j] = __ldg(reinterpret_cast<const float2*>(row + min(n0 + 8 * j, pr.N - 2)));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float& v0 = acc[4 * j + 2 * rr];
        float& v1 = acc[4 * j + 2 * rr + 1];
        v0 = mk[rr][j].x > 0.f ? v0 : 0.f;
        v1 = mk[rr][j].y > 0.f ? v1 : 0.f;
      }
  }

  __device__ __forceinline__ void store(const float (&acc)[32], int nb) const {
    const int n0 = col0(nb);
    if (pr.kind == BWD_APP) {
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const int m = m0 + pl.r0 + 8 * rr;
        float* row = p.d_app + (size_t)min(m, p.M - 1) * p.app_dim;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int n = n0 + 8 * j + e;
            st_global1_if(row + min(n, p.app_dim - 1), acc[4 * j + 2 * rr + e],
                          pl.rows && m < p.M && n < p.app_dim);
          }
      }
      return;
    }
    const int S = p.D + 4;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + 8 * j;
      const bool live = pl.rows && n < pr.N;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr)
        st_shared2_if(dst + (live ? (pl.r0 + 8 * rr) * S + n : 0), acc[4 * j + 2 * rr],
                      acc[4 * j + 2 * rr + 1], live);
    }
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int m = m0 + pl.r0 + 8 * rr;
      float* row = p.grad + (size_t)min(m, p.M - 1) * p.grad_width + pr.gcol;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + 8 * j;
        st_global2_if(row + min(n, pr.N - 2), acc[4 * j + 2 * rr], acc[4 * j + 2 * rr + 1],
                      pl.rows && n < pr.N && m < p.M);
      }
    }
  }
};

// Columns [col, col + width) of the saved rows of the tile's points into
// the tile (stride D + 4), float4s, each consumer thread's loads of a batch
// of ROW_BATCH issued together, then stored (zero past M).
constexpr int ROW_BATCH = 8;
__device__ __forceinline__ void rows_to_tile(const BwdParams& p, int col, int width, int m0,
                                             float* tile) {
  const int w4 = width / 4, total = p.tm * w4;
  for (int base = threadIdx.x; base < total; base += ROW_BATCH * CONSUMERS) {
    float4 v[ROW_BATCH];
#pragma unroll
    for (int k = 0; k < ROW_BATCH; ++k) {
      const int idx = base + k * CONSUMERS;
      const int pt = idx / w4, m = m0 + pt;
      v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < total && m < p.M)
        v[k] = __ldg(reinterpret_cast<const float4*>(p.act + (size_t)m * p.act_width + col +
                                                     4 * (idx - pt * w4)));
    }
#pragma unroll
    for (int k = 0; k < ROW_BATCH; ++k) {
      const int idx = base + k * CONSUMERS;
      const int pt = idx / w4;
      if (idx < total)
        *reinterpret_cast<float4*>(tile + pt * (p.D + 4) + 4 * (idx - pt * w4)) = v[k];
    }
  }
}

// Sigma's pre-activation of point t (consumer thread t < tm) from h_{L-1}
// in the tile: the sum over the columns in order, the bias, the point's
// noise nz.
__device__ __forceinline__ float sigma_pre(const BwdParams& p, const float* tile, float nz,
                                           int t) {
  const float4* hr = reinterpret_cast<const float4*>(tile + t * (p.D + 4));
  const float4* ws = reinterpret_cast<const float4*>(p.w_sigma);
  float s = 0.f;
#pragma unroll 4
  for (int n = 0; n < p.D / 4; ++n) {
    const float4 hv = hr[n], wv = __ldg(ws + n);
    s = fmaf(hv.x, wv.x, s);
    s = fmaf(hv.y, wv.y, s);
    s = fmaf(hv.z, wv.z, s);
    s = fmaf(hv.w, wv.w, s);
  }
  s = s + p.b_sigma[0];
  if (p.noise != nullptr) s = s + nz;
  return s;
}

// The heads' derivatives of point t (consumer thread t < tm) from sigma's
// pre-activation s, the point's cotangent g and the rgb head recomputed
// from the tile (the branch rows, or h_{L-1}; the sums over the columns in
// order): into hd and the gradient row's heads [g_sigma, g_rgb, 0 x 4].
__device__ __forceinline__ void heads(const BwdParams& p, const float* tile, float s,
                                      float4 g, float* hd, int m0, int t) {
  if (t >= p.tm) return;
  const int rin = p.has_branch ? p.D / 2 : p.D;
  const float4* xr = reinterpret_cast<const float4*>(tile + t * (p.D + 4));
  const float4* w0 = reinterpret_cast<const float4*>(p.w_rgb);
  const float4* w1 = reinterpret_cast<const float4*>(p.w_rgb + rin);
  const float4* w2 = reinterpret_cast<const float4*>(p.w_rgb + 2 * rin);
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll 2
  for (int n = 0; n < rin / 4; ++n) {
    const float4 x = xr[n], u0 = __ldg(w0 + n), u1 = __ldg(w1 + n), u2 = __ldg(w2 + n);
    a0 = fmaf(x.x, u0.x, a0);
    a1 = fmaf(x.x, u1.x, a1);
    a2 = fmaf(x.x, u2.x, a2);
    a0 = fmaf(x.y, u0.y, a0);
    a1 = fmaf(x.y, u1.y, a1);
    a2 = fmaf(x.y, u2.y, a2);
    a0 = fmaf(x.z, u0.z, a0);
    a1 = fmaf(x.z, u1.z, a1);
    a2 = fmaf(x.z, u2.z, a2);
    a0 = fmaf(x.w, u0.w, a0);
    a1 = fmaf(x.w, u1.w, a1);
    a2 = fmaf(x.w, u2.w, a2);
  }
  const int m = m0 + t;
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

// The chain's elementwise start, in place over the tile and into the
// gradient rows: d_a = (g_rgb w_rgb) * (branch > 0), zero from D / 2 to KB;
// without the branch d_pre_{L-1} = (g_sigma w_sigma + g_rgb w_rgb) *
// (h_{L-1} > 0). Four columns a thread (D / 2 and KB are multiples of 8),
// each column's sum in one order: g_r w_r, + g_g w_g, + g_b w_b (FMAs),
// then g_sigma w_sigma + that.
__device__ __forceinline__ void first(const BwdParams& p, float* tile, const float* hd,
                                      int m0) {
  const int w4 = (p.has_branch ? p.KB : p.D) / 4;
  const int live = p.has_branch ? p.D / 2 : p.D;
  const int col = p.has_branch ? p.g_da : (p.layers - 1) * p.D;
  const float4* wr = reinterpret_cast<const float4*>(p.w_rgb);
  const float4* ws = reinterpret_cast<const float4*>(p.w_sigma);
  for (int idx = threadIdx.x; idx < p.tm * w4; idx += CONSUMERS) {
    const int pt = idx / w4, c4 = idx - pt * w4;
    float4* at = reinterpret_cast<float4*>(tile + pt * (p.D + 4)) + c4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (4 * c4 < live) {
      const float4 h4 = reinterpret_cast<const float4*>(hd)[pt];
      const float4 r = __ldg(wr + c4), gg = __ldg(wr + live / 4 + c4);
      const float4 b = __ldg(wr + live / 2 + c4), a = *at;
      float u[4] = {h4.y * r.x, h4.y * r.y, h4.y * r.z, h4.y * r.w};
      const float gv[4] = {gg.x, gg.y, gg.z, gg.w}, bv[4] = {b.x, b.y, b.z, b.w};
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        u[e] = fmaf(h4.z, gv[e], u[e]);
        u[e] = fmaf(h4.w, bv[e], u[e]);
      }
      if (!p.has_branch) {
        const float4 s = __ldg(ws + c4);
        const float sv[4] = {s.x, s.y, s.z, s.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) u[e] = h4.x * sv[e] + u[e];
      }
      v = make_float4(av[0] > 0.f ? u[0] : 0.f, av[1] > 0.f ? u[1] : 0.f,
                      av[2] > 0.f ? u[2] : 0.f, av[3] > 0.f ? u[3] : 0.f);
    }
    *at = v;
    const int m = m0 + pt;
    if (m < p.M) reinterpret_cast<float4*>(p.grad + (size_t)m * p.grad_width + col)[c4] = v;
  }
}

// The backward-data of the CTA's tile of tm points (the warp-specialised
// CTA of f32_forward.cuh: one producer thread keeps the ring full of the
// products' transposed-W boxes and rests, two consumer warpgroups take the
// heads, the start and the products).
__global__ void __launch_bounds__(NT, 1)
train_f32_bwd_kernel(const __grid_constant__ BwdMaps maps, const __grid_constant__ BwdParams p) {
  extern __shared__ uint8_t smem_raw[];
  // The 128-byte swizzle repeats every 1024 B: the ring starts on it.
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + p.bar_off);
  uint64_t* empty = full + p.stages;
  const int nprod = bwd_count(p);
  const int m0 = blockIdx.x * p.tm;
  // Read from lane 0, so the compiler knows the warp (and warpgroup) index
  // is uniform: wgmma under a branch it cannot prove uniform is serialised.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (warp == CONSUMER_WARPS && lane == 0) {
      int st = 0, use = 0;
      for (int q = 0; q < nprod; ++q) {
        const BwdProd pr = bwd_product(p, q);
        const int bytes = min(p.ktot[pr.mat], BN) * BK * 4;
        for (int nb = 0; nb * BN < pr.N; ++nb) {
          for (int j = 0; j * BK < pr.K; ++j) {
            if (use > 0) mbar_wait(empty + st, (use - 1) & 1);
            mbar_expect_tx(full + st, 2 * bytes);
            const uint32_t stage = smem_u32(smem + p.ring_off + st * STAGE_BYTES);
            tma_load_keep(stage, &maps.w[pr.mat], j * BK, pr.row0 + BN * nb, full + st);
            tma_load_keep(stage + BOX_BYTES, &maps.wlo[pr.mat], j * BK, pr.row0 + BN * nb,
                          full + st);
            if (++st == p.stages) st = 0, ++use;
          }
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));

  Place pl;
  pl.wg = warp >> 2;
  pl.g = lane >> 2;
  pl.q = lane & 3;
  pl.r0 = 16 * (warp & 3) + pl.g;
  pl.rows = 16 * (warp & 3) < p.tm;
  Ring ring = {smem_u32(smem + p.ring_off), full, empty, p.stages, 0, 0};
  float* x = reinterpret_cast<float*>(smem + p.x_off);
  float* y = reinterpret_cast<float*>(smem + p.y_off);
  float* hd = reinterpret_cast<float*>(smem + p.heads_off);
  const int t = threadIdx.x;

  // The heads' inputs of point t (thread t < tm) first, so that their
  // latency runs under the row loads; sigma from h_{L-1}, then the rgb head
  // from the branch rows (which take the tile's place) or from h_{L-1}.
  const bool mine = t < p.tm && m0 + t < p.M;
  const float4 g = mine ? __ldg(reinterpret_cast<const float4*>(p.g) + m0 + t)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
  const float nz = mine && p.noise != nullptr ? __ldg(p.noise + m0 + t) : 0.f;
  rows_to_tile(p, p.act_h0 + (p.layers - 1) * p.D, p.D, m0, x);
  consumer_sync();
  const float s = t < p.tm ? sigma_pre(p, x, nz, t) : 0.f;
  if (p.has_branch) {
    consumer_sync();
    rows_to_tile(p, p.act_branch, p.D / 2, m0, x);
    consumer_sync();
  }
  heads(p, x, s, g, hd, m0, t);
  consumer_sync();
  first(p, x, hd, m0);
  consumer_sync();

  float acc0[32], acc1[32], ch[32];
  const bool in_place = p.x_off == p.y_off;
  float* cur = x;
  for (int q = 0; q < nprod; ++q) {
    const BwdProd pr = bwd_product(p, q);
    const bool app = pr.kind == BWD_APP;
    float* dst = in_place || app ? cur : (cur == x ? y : x);
    layer<BWD_CHAIN_STAGES>(acc0, acc1, ch, OneSrc{{cur, p.D + 4, pr.K}}, pr.N,
                            in_place && !app, BwdEpi{p, pr, dst, m0, hd, pl}, ring, pl, lane);
    cur = dst;
  }
}

// ------------------------------------------------------- weight gradient

constexpr int WG_NT = 256;  // threads of a weight-gradient CTA: 8 warps
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
    for (int r = 0; r < WG_P * WG_T / 4 / WG_NT; ++r) {
      const int e = r * WG_NT + threadIdx.x;
      const int pt = e >> 5, c = 4 * (e & 31);
      const int m = p0 + pt;
      const int bytes = m < end ? 4 * max(0, min(4, live - c)) : 0;
      cp_async16(base + 4 * (pt * WG_LD + c), bytes ? src + (size_t)m * ld + col + c : src,
                 bytes);
    }
  } else {
#pragma unroll 4
    for (int r = 0; r < WG_P * WG_T / WG_NT; ++r) {
      const int e = r * WG_NT + threadIdx.x;
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
__global__ void __launch_bounds__(WG_NT, 1) wg_tf32x3_kernel(const __grid_constant__ WgParams p) {
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
__global__ void __launch_bounds__(WG_NT) wg_reduce_kernel(const __grid_constant__ WgParams p,
                                                       int splits) {
  const int e = blockIdx.x * WG_NT + threadIdx.x;
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

}  // namespace

extern "C" {

// ptrs, dims, plan, shapes, rests: as eval_f32_launch (fused_mlp.py::
//   launch_tables, fused_f32.py::f32_fwd_plan, w_rests); extra: noise (or
//   0), the saved rows;
//   cols: act_width, final, dir, app, branch (fused_train.py::act_layout).
int train_f32_fwd_launch(const long long* ptrs, const int* dims, const int* plan,
                         const int* shapes, const long long* rests, const long long* extra,
                         const int* cols, void* stream) {
  FwdParams p;
  FwdMaps maps;
  int smem = 0;
  const int err = fwd_setup(ptrs, dims, plan, shapes, rests, p, maps, smem);
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
  return fwd_launch(train_f32_fwd_kernel, maps, p, smem, reinterpret_cast<cudaStream_t>(stream));
}

// ptrs: act, grad, g, noise (or 0), d_app (or 0), w_sigma, b_sigma, w_rgb,
//   b_rgb, then the transposed matrices (fused_train.py::transposed_weights)
//   in fused_mlp.py::mat_layout order.
// dims: M, D, layers, has_branch, shifted_softplus, app_dim, skip_mask, EP,
//   DP, KB, act_width, grad_width, act h0, act branch, grad dfinal, grad da,
//   grad heads (fused_train.py::act_layout, grad_layout).
// plan: tm, stages, ring, x, y, heads and barrier offsets, smem_bytes
//   (fused_f32.py::f32_bwd_plan).
// shapes: (Ktot, N) per transposed matrix.
// rests: per transposed matrix, its TF32 rests (fused_f32.py::t_rests).
// Returns 0, a cudaError_t or a tensor-map failure (train_f32_error_string).
int train_f32_bwd_launch(const long long* ptrs, const int* dims, const int* plan,
                         const int* shapes, const long long* rests, void* stream) {
  BwdParams p = {};
  BwdMaps maps;
  memset(&maps, 0, sizeof maps);
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
  p.stages = plan[1];
  p.ring_off = plan[2];
  p.x_off = plan[3];
  p.y_off = plan[4];
  p.heads_off = plan[5];
  p.bar_off = plan[6];
  const int smem = plan[7];
  const int nmat = p.layers + (p.has_branch ? 2 : 0);
  // tm = 64 writes in place (x == y) to width 256; the rows read, the heads
  // and the start's gradient rows move as float4s, the products' as pairs.
  if (nmat > MAX_MATS || p.layers < 1 || p.D % 16 || p.D < 16 || p.KB % 16 || p.KB > p.D ||
      p.stages < 2 || p.ring_off % 1024 ||
      !((p.tm == 64 && p.x_off == p.y_off && p.D <= 2 * BN) ||
        (p.tm == 32 && p.x_off != p.y_off)) ||
      p.act_width % 4 || p.act_h0 % 4 || p.act_branch % 4 || p.grad_width % 4 ||
      p.g_heads % 4 || p.g_dfinal % 2 || p.g_da % 4 ||
      (p.app_dim > 0 && p.d_app == nullptr))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nmat; ++i) {
    const void* w = reinterpret_cast<const void*>(ptrs[9 + i]);
    const void* wlo = reinterpret_cast<const void*>(rests[i]);
    const int kt = shapes[2 * i], n = shapes[2 * i + 1];
    // TMA reads both: 16-byte aligned bases and row pitches.
    if ((reinterpret_cast<uintptr_t>(w) & 15) || (reinterpret_cast<uintptr_t>(wlo) & 15) ||
        n % 4 || kt < 1)
      return (int)cudaErrorInvalidValue;
    p.ktot[i] = kt;
    if (p.M <= 0) continue;
    if (!encode_tiled()) return ERR_NO_ENCODE;
    const cuuint64_t gdims[2] = {(cuuint64_t)n, (cuuint64_t)kt};
    const cuuint64_t strides[1] = {(cuuint64_t)n * 4};
    const cuuint32_t box[2] = {BK, (cuuint32_t)(kt < BN ? kt : BN)};
    const cuuint32_t estr[2] = {1, 1};
    for (int h = 0; h < 2; ++h) {
      const CUresult r = encode_tiled()(
          h ? &maps.wlo[i] : &maps.w[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2,
          const_cast<void*>(h ? wlo : w), gdims, strides, box, estr,
          CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
      if (r != CUDA_SUCCESS) return -(int)r;
    }
  }
  if (p.M <= 0) return 0;
  cudaError_t err =
      cudaFuncSetAttribute(train_f32_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  train_f32_bwd_kernel<<<(p.M + p.tm - 1) / p.tm, NT, smem,
                         reinterpret_cast<cudaStream_t>(stream)>>>(maps, p);
  return (int)cudaGetLastError();
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
  wg_tf32x3_kernel<<<dim3(p.ntiles, splits), WG_NT, WG_SMEM, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  wg_reduce_kernel<<<dim3((WG_ELEMS + WG_NT - 1) / WG_NT, p.ntiles), WG_NT, 0, s>>>(p, splits);
  return (int)cudaGetLastError();
}

const char* train_f32_error_string(int code) { return f32fwd::fwd_error_string(code); }

}  // extern "C"
