// The f32 layer chain of the fused NeRF MLP: device helpers shared by
// eval_f32.cu (the eval kernel) and train_f32.cu (the training forward and
// backward-data kernels), so that the eval kernel and the training forward
// run the same code and agree bit for bit without noise.
//
// True f32: f32 operands from shared memory, one FFMA per product term,
// f32 sums (no TF32, no bf16 tensor-core product). A CTA owns a tile of tm
// points (fused_f32.py::f32_fwd_plan / f32_bwd_plan: 64, or 32 where two
// 64-point activation tiles do not fit) and NT = 256 threads.
// - Activations stay in shared memory, one tile per segment, each row of
//   the tile one column of the activation (tm floats, the points). Point p
//   of row c sits at p ^ (4 ((c / 4) % 8)) (`tix`): groups of four points
//   stay together for the float4 reads of a product, and the float4 stores
//   of an epilogue, whose lanes differ in column group, spread over the
//   banks (none conflict at 64 points, pairs at 32).
// - A product runs over the output columns in passes of NB = 256. A thread
//   keeps TP x 8 f32 sums (TP = tm / 8): points p0 .. p0 + TP - 1 and
//   columns c0 .. c0 + 3, c0 + 32 .. c0 + 35 of the pass (`place`): warp w
//   takes point half w % 2 and the 64 columns from 64 (w / 2), its lane l
//   point group l % 4 and column group l / 4. Each k-step is TP / 4 float4
//   reads of the points (4 addresses a warp) and two of the weights (8
//   contiguous addresses a warp), one shared-memory wavefront each, then
//   8 TP FFMAs.
// - The weights come in chunks of KS = 16 k-rows x NB columns through two
//   shared buffers: each thread loads its 16 floats of chunk c + 1 from
//   global memory (L2) into registers before the FFMAs of chunk c and
//   stores them after, one __syncthreads per chunk. Both directions read a
//   row-major matrix along its rows, 256 contiguous bytes per half-warp:
//   the forward the transposed (Ktot, N) copy of a packed matrix
//   (fused_f32.py::transposed), the backward the packed (N, Ktot) matrix
//   (reduce index = packed row, output column = packed column).
// - Epilogues act on a thread's TP x 8 sums: bias, ReLU, masks, and stores
//   to a tile (two float4 a column) or to global rows (a float4 a point and
//   column group, 512 contiguous bytes a warp).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32chain {

constexpr int NT = 256;       // threads of a CTA: 8 warps
constexpr int NB = 256;       // output columns of one pass: 32 lanes x 8
constexpr int KS = 16;        // k rows of a weight chunk
constexpr int CHUNK = KS * NB;
constexpr int MAX_MATS = 16;  // trunk layers + trunk_final + dir_a

// Float offset of (row c, point p) in a tile of tm points.
__device__ __forceinline__ int tix(int tm, int c, int p) {
  return c * tm + (p ^ (((c >> 2) & 7) << 2));
}

// This thread's first point p0 and first column c0 of a pass.
template <int TP>
__device__ __forceinline__ void place(int& p0, int& c0) {
  const int w = threadIdx.x >> 5, l = threadIdx.x & 31;
  p0 = (w & 1) * 4 * TP + (l & 3) * TP;
  c0 = (w >> 1) * 64 + (l >> 2) * 4;
}

// Column of the pass that sum j (0..7) of the thread at column c0 holds.
__device__ __forceinline__ int col_of(int c0, int j) { return c0 + (j < 4 ? j : 28 + j); }

// One operand segment of a product: rows [0, K) of a resident tile (K a
// multiple of KS), meeting the weights' k-indices [kw, kw + K).
struct Seg {
  const float* tile;
  int K;
  int kw;
};

// The weights of a product, as B (k x n): element (k, n) at
// w[k * ld + col0 + n], rows k >= klim and columns n >= nlim reading as
// zero. The forward reads the transposed (Ktot, N) copy of a packed matrix
// (k: the input column), the backward the packed (N, Ktot) matrix itself
// (k: the output row of the forward, n: its input column from col0).
struct Wts {
  const float* w;
  int ld, col0, nlim, klim;
};

// This thread's 16 floats of the chunk at rows [k0, k0 + KS), columns
// [n0, n0 + NB): row k0 + t / 16, four float4 64 columns apart, so a warp
// reads two 256-byte row pieces per load.
__device__ __forceinline__ void load_chunk(float (&r)[16], const Wts& wt, int k0, int n0) {
  const int t = threadIdx.x;
  const int k = k0 + (t >> 4);
  const float* row = wt.w + (size_t)k * wt.ld + wt.col0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int n = n0 + 4 * (t & 15) + 64 * q;
    if (k < wt.klim && n + 4 <= wt.nlim) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(row + n));
      r[4 * q] = v.x;
      r[4 * q + 1] = v.y;
      r[4 * q + 2] = v.z;
      r[4 * q + 3] = v.w;
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        r[4 * q + e] = (k < wt.klim && n + e < wt.nlim) ? __ldg(row + n + e) : 0.f;
    }
  }
}

// The chunk into a shared buffer laid out [k][NB].
__device__ __forceinline__ void store_chunk(const float (&r)[16], float* ws) {
  const int t = threadIdx.x;
  float* dst = ws + (t >> 4) * NB + 4 * (t & 15);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    *reinterpret_cast<float4*>(dst + 64 * q) =
        make_float4(r[4 * q], r[4 * q + 1], r[4 * q + 2], r[4 * q + 3]);
}

// KS k-steps of the TP x 8 outer products from one chunk (a tile of 8 TP
// points: the row stride is a constant, so the reads take immediate
// offsets).
template <int TP>
__device__ __forceinline__ void fma_chunk(float (&acc)[TP][8], const float* tile, int k0,
                                          const float* ws, int p0, int c0) {
#pragma unroll 8
  for (int kk = 0; kk < KS; ++kk) {
    float a[TP];
#pragma unroll
    for (int q = 0; q < TP / 4; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(tile + tix(8 * TP, k0 + kk, p0 + 4 * q));
      a[4 * q] = v.x;
      a[4 * q + 1] = v.y;
      a[4 * q + 2] = v.z;
      a[4 * q + 3] = v.w;
    }
    const float4 b0 = *reinterpret_cast<const float4*>(ws + kk * NB + c0);
    const float4 b1 = *reinterpret_cast<const float4*>(ws + kk * NB + c0 + 32);
    const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int i = 0; i < TP; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc = the product of the segments' tiles with the weights over output
// columns [n0, n0 + NB), summed over the segments' k in order. `wbuf` holds
// two chunks. Ends with a __syncthreads: every thread is past its reads of
// wbuf and of the tiles, and the tiles written before the call were seen.
template <int TP>
__device__ __forceinline__ void product(float (&acc)[TP][8], const Seg* segs, int nseg,
                                        const Wts& wt, int n0, float* wbuf, int p0, int c0) {
#pragma unroll
  for (int i = 0; i < TP; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  int total = 0;
  for (int s = 0; s < nseg; ++s) total += segs[s].K / KS;
  float r[16];
  load_chunk(r, wt, segs[0].kw, n0);
  store_chunk(r, wbuf);
  __syncthreads();
  int s = 0, k0 = 0;
  for (int c = 0; c < total; ++c) {
    int ns = s, nk = k0 + KS;
    if (nk >= segs[s].K) {
      ns = s + 1;
      nk = 0;
    }
    const bool more = c + 1 < total;
    if (more) load_chunk(r, wt, segs[ns].kw + nk, n0);
    fma_chunk<TP>(acc, segs[s].tile, k0, wbuf + (c & 1) * CHUNK, p0, c0);
    if (more) store_chunk(r, wbuf + ((c + 1) & 1) * CHUNK);
    __syncthreads();
    s = ns;
    k0 = nk;
  }
}

// Stores sums v[i][j] (points p0 + i, pass columns col_of(c0, j) from n0)
// into rows of a tile, the columns below nlim (a multiple of 4).
template <int TP>
__device__ __forceinline__ void store_tile(const float (&v)[TP][8], float* tile, int tm,
                                           int n0, int nlim, int p0, int c0) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int n = n0 + col_of(c0, j);
    if (n >= nlim) continue;
#pragma unroll
    for (int q = 0; q < TP / 4; ++q)
      *reinterpret_cast<float4*>(tile + tix(tm, n, p0 + 4 * q)) =
          make_float4(v[4 * q][j], v[4 * q + 1][j], v[4 * q + 2][j], v[4 * q + 3][j]);
  }
}

// Stores sums v into global rows: row m0 + p0 + i (below M) of `rows`
// (width ld floats), columns col + n for the pass columns n below nlim.
template <int TP>
__device__ __forceinline__ void store_rows(const float (&v)[TP][8], float* rows, int ld,
                                           int col, int m0, int M, int n0, int nlim,
                                           int p0, int c0) {
#pragma unroll
  for (int i = 0; i < TP; ++i) {
    const int m = m0 + p0 + i;
    if (m >= M) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int n = n0 + col_of(c0, 4 * h);
      if (n >= nlim) continue;
      *reinterpret_cast<float4*>(rows + (size_t)m * ld + col + n) =
          make_float4(v[i][4 * h], v[i][4 * h + 1], v[i][4 * h + 2], v[i][4 * h + 3]);
    }
  }
}

// ------------------------------------------------------------------ forward

struct FwdParams {
  const float* xyz;    // (M, xyz_dim)
  const float* dirs;   // (M, 3), or null
  const float* app;    // (M, app_dim), or null
  float* out;          // (M, 4)
  const float* w_sigma;
  const float* b_sigma;
  const float* w_rgb;  // (3, rgb_in)
  const float* b_rgb;
  const float* w[MAX_MATS];  // transposed packed matrices (Ktot, N)
  const float* bias[MAX_MATS];
  int kt[MAX_MATS];          // Ktot
  int M, xyz_dim, nf_xyz, nf_dir, layers, D, app_dim, skip_mask, has_branch;
  int shifted_softplus, EP, DP, AP;
  // The plan (fused_f32.py::f32_fwd_plan): the tile and byte offsets.
  int tm, enc_off, dir_off, app_off, x_off, y_off, w_off, sig_off;
  // The training forward: sigma noise (M,) or null, the saved rows (M,
  // act_width) or null (eval), and their columns (fused_train.py::act_layout).
  const float* noise;
  float* act;
  int act_width, act_final, act_dir, act_app, act_branch;
};

// Column c of the frequency encode of point m's d <= 4 coordinates (src
// rows of d floats): column c < live = d (1 + 2 nf) holds x[c % d] for
// block j = c / d = 0, else sin(x 2^k + phase) with k = (j - 1) / 2 and
// phase pi/2 on cos blocks (fused_mlp.py::encode); zero past `live`.
__device__ __forceinline__ float encode_value(const float* __restrict__ src, int d,
                                              int live, long long m, int c) {
  if (c >= live) return 0.f;
  const int j = c / d;
  const float x = __ldg(src + m * d + (c - j * d));
  if (j == 0) return x;
  const int k = (j - 1) >> 1;
  float arg = x * __int_as_float((k + 127) << 23);  // exact 2^k
  if ((j - 1) & 1) arg = arg + 1.57079632679489661923f;
  return sinf(arg);
}

// The encode (`encode_value`) of nf frequencies into rows [0, width) of a
// tile, zero for points past M. With `rows`, also into the saved rows from
// column `col`.
__device__ __forceinline__ void encode_tile(const float* __restrict__ src, int d, int nf,
                                            int width, int m0, int M, float* tile,
                                            int tm, float* rows, int ld, int col) {
  const int live = d * (1 + 2 * nf);
  for (int idx = threadIdx.x; idx < tm * width; idx += NT) {
    const int p = idx / width;
    const int c = idx - p * width;
    const int m = m0 + p;
    const float v = m < M ? encode_value(src, d, live, m, c) : 0.f;
    tile[tix(tm, c, p)] = v;
    if (rows != nullptr && m < M) rows[(size_t)m * ld + col + c] = v;
  }
}

// Appearance rows into rows [0, AP) of a tile (zero past app_dim).
__device__ __forceinline__ void app_tile(const FwdParams& p, int m0, float* tile) {
  for (int idx = threadIdx.x; idx < p.tm * p.AP; idx += NT) {
    const int pt = idx / p.AP;
    const int c = idx - pt * p.AP;
    const int m = m0 + pt;
    const float v = (m < p.M && c < p.app_dim) ? __ldg(p.app + (size_t)m * p.app_dim + c) : 0.f;
    tile[tix(p.tm, c, pt)] = v;
    if (p.act != nullptr && m < p.M)
      p.act[(size_t)m * p.act_width + p.act_app + c] = v;
  }
}

// One matmul layer of the forward: segments against packed matrix li, the
// bias, ReLU where `relu`, into tile `dst` (and the saved rows at column
// `col` when the forward saves them).
template <int TP>
__device__ __forceinline__ void fwd_layer(const FwdParams& p, int li, const Seg* segs,
                                          int nseg, int N, bool relu, float* dst, int col,
                                          float* wbuf, int m0, int p0, int c0) {
  const Wts wt = {p.w[li], N, 0, N, p.kt[li]};
  const float* __restrict__ bias = p.bias[li];
  for (int n0 = 0; n0 < N; n0 += NB) {
    float acc[TP][8];
    product<TP>(acc, segs, nseg, wt, n0, wbuf, p0, c0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = n0 + col_of(c0, j);
      const float b = n < N ? __ldg(bias + n) : 0.f;
#pragma unroll
      for (int i = 0; i < TP; ++i) {
        const float v = acc[i][j] + b;
        acc[i][j] = relu ? fmaxf(v, 0.f) : v;
      }
    }
    store_tile<TP>(acc, dst, p.tm, n0, N, p0, c0);
    if (p.act != nullptr)
      store_rows<TP>(acc, p.act, p.act_width, col, m0, p.M, n0, N, p0, c0);
  }
}

// The whole forward of the CTA's tile: encode, trunk (sigma head after its
// last layer), trunk_final and dir_a with the branch, the rgb head; writes
// (M, 4) [rgb, sigma] and, in the training forward, the saved rows.
template <int TP>
__device__ void forward_tile(const FwdParams& p, uint8_t* smem) {
  float* enc = reinterpret_cast<float*>(smem + p.enc_off);
  float* dirt = reinterpret_cast<float*>(smem + p.dir_off);
  float* appt = reinterpret_cast<float*>(smem + p.app_off);
  float* tx = reinterpret_cast<float*>(smem + p.x_off);
  float* ty = reinterpret_cast<float*>(smem + p.y_off);
  float* wbuf = reinterpret_cast<float*>(smem + p.w_off);
  float* sig = reinterpret_cast<float*>(smem + p.sig_off);
  const int m0 = blockIdx.x * p.tm;
  int p0, c0;
  place<TP>(p0, c0);
  const int D = p.D;

  encode_tile(p.xyz, p.xyz_dim, p.nf_xyz, p.EP, m0, p.M, enc, p.tm, p.act, p.act_width, 0);
  if (p.DP)
    encode_tile(p.dirs, 3, p.nf_dir, p.DP, m0, p.M, dirt, p.tm, p.act, p.act_width,
                p.act_dir);
  if (p.AP) app_tile(p, m0, appt);
  // (the first product's __syncthreads orders these stores before its reads)

  float* h = tx;  // the trunk's current output
  for (int li = 0; li < p.layers; ++li) {
    Seg segs[2];
    int nseg = 0;
    const bool with_enc = li == 0 || ((p.skip_mask >> li) & 1);
    if (with_enc) segs[nseg++] = {enc, p.EP, 0};
    if (li > 0) segs[nseg++] = {h, D, with_enc ? p.EP : 0};
    float* dst = li == 0 ? tx : (h == tx ? ty : tx);
    fwd_layer<TP>(p, li, segs, nseg, D, true, dst, p.EP + li * D, wbuf, m0, p0, c0);
    h = dst;
  }
  __syncthreads();

  // Sigma head: a thread per point.
  const int t = threadIdx.x;
  if (t < p.tm) {
    float s = 0.f;
    for (int n = 0; n < D; ++n) s = fmaf(h[tix(p.tm, n, t)], __ldg(p.w_sigma + n), s);
    s = s + p.b_sigma[0];
    const int m = m0 + t;
    if (p.noise != nullptr && m < p.M) s = s + __ldg(p.noise + m);
    if (p.shifted_softplus) {
      const float x = s - 1.f;
      s = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
    } else {
      s = fmaxf(s, 0.f);
    }
    sig[t] = s;
  }

  const float* last = h;
  int rgb_in = D;
  if (p.has_branch) {
    float* fin = h == tx ? ty : tx;
    Seg s1[1] = {{h, D, 0}};
    fwd_layer<TP>(p, p.layers, s1, 1, D, false, fin, p.act_final, wbuf, m0, p0, c0);
    Seg s2[3];
    int nseg = 0;
    s2[nseg++] = {fin, D, 0};
    if (p.DP) s2[nseg++] = {dirt, p.DP, D};
    if (p.AP) s2[nseg++] = {appt, p.AP, D + p.DP};
    // The trunk's last output (read by the sigma head and trunk_final: the
    // products' barriers order both before this layer's epilogue).
    fwd_layer<TP>(p, p.layers + 1, s2, nseg, D / 2, true, h, p.act_branch, wbuf, m0, p0,
                  c0);
    rgb_in = D / 2;
    __syncthreads();
  }

  // Rgb head and output: a thread per point.
  if (t < p.tm) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int n = 0; n < rgb_in; ++n) {
      const float x = last[tix(p.tm, n, t)];
      a0 = fmaf(x, __ldg(p.w_rgb + n), a0);
      a1 = fmaf(x, __ldg(p.w_rgb + rgb_in + n), a1);
      a2 = fmaf(x, __ldg(p.w_rgb + 2 * rgb_in + n), a2);
    }
    const int m = m0 + t;
    if (m < p.M) {
      float4 o;
      o.x = 1.f / (1.f + expf(-(a0 + p.b_rgb[0])));
      o.y = 1.f / (1.f + expf(-(a1 + p.b_rgb[1])));
      o.z = 1.f / (1.f + expf(-(a2 + p.b_rgb[2])));
      o.w = sig[t];
      reinterpret_cast<float4*>(p.out)[m] = o;
    }
  }
}

}  // namespace f32chain
