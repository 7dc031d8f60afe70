// The f32 layer chain of the fused NeRF MLP's backward-data kernel
// (train_f32.cu) and the f32 frequency encode that every f32 forward shares
// (`encode_coord`: f32_forward.cuh, the tensor-core forward of eval_f32.cu
// and train_f32.cu; `encode_value`: wide_f32.cu's encode).
//
// True f32: f32 operands from shared memory, one FFMA per product term,
// f32 sums (no TF32, no bf16 tensor-core product). A CTA owns a tile of tm
// points (fused_f32.py::f32_bwd_plan: 64, or 32 where two 64-point
// gradient tiles do not fit) and NT = 256 threads.
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
//   stores them after, one __syncthreads per chunk. The backward reads the
//   packed (N, Ktot) matrix along its rows, 256 contiguous bytes per
//   half-warp (reduce index = packed row, output column = packed column).
// - Epilogues act on a thread's TP x 8 sums: masks, and stores to a tile
//   (two float4 a column) or to global rows (a float4 a point and column
//   group, 512 contiguous bytes a warp).

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
// zero: the packed (N, Ktot) matrix (k: the output row of the forward, n:
// its input column from col0).
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

// ------------------------------------------------------------------ encode

// Block j of the frequency encode of one coordinate x: x for j = 0, else
// sin(x 2^k + phase) with k = (j - 1) / 2 and phase pi/2 on cos blocks
// (fused_mlp.py::encode).
__device__ __forceinline__ float encode_coord(float x, int j) {
  if (j == 0) return x;
  const int k = (j - 1) >> 1;
  float arg = x * __int_as_float((k + 127) << 23);  // exact 2^k
  if ((j - 1) & 1) arg = arg + 1.57079632679489661923f;
  return sinf(arg);
}

// Column c of the frequency encode of point m's d <= 4 coordinates (src
// rows of d floats): column c < live = d (1 + 2 nf) holds block j = c / d
// of x[c % d] (`encode_coord`); zero past `live`.
__device__ __forceinline__ float encode_value(const float* __restrict__ src, int d,
                                              int live, long long m, int c) {
  if (c >= live) return 0.f;
  const int j = c / d;
  return encode_coord(__ldg(src + m * d + (c - j * d)), j);
}

}  // namespace f32chain
