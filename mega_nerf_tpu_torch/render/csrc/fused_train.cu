// Fused NeRF training MLP for Hopper (sm_90a), written by hand: forward,
// backward-data and weight-gradient kernels.
//
// Replaces the TPU kernels `mega_nerf_tpu/render/pallas_train.py::
// _train_fwd_kernel` (the eval forward plus the pre-activation sigma noise)
// and `_train_bwd_kernel` (the custom-VJP backward: sigmoid, softplus(x-1)
// and ReLU derivatives, every weight and bias gradient summed in f32 over
// all points, d_app per point).
//
// What bounds it on an H100: at the paper width a point costs ~1.21 MFLOP
// forward (fg; 1.24 bg); the backward's weight-gradient products cost the
// same again and its data-gradient products a little less (no gradient
// flows into the encodings). The function moves ~140-240 bytes per point
// (points, noise, output cotangent, rgb/sigma, d_app), so it is
// compute-bound: for the fg-fine launch of one 1024-ray step (524,288
// points) the bounds at 989 TFLOP/s (dense bf16) are ~0.64 ms forward,
// ~0.60 ms dX and ~0.64 ms dW (chip_smoke.py computes them from its
// shapes).
// This design adds traffic of its own, which the bound does not count: the
// forward writes a saved activation row per point (5,184 B at the fg paper
// width) that both backward kernels read, and backward-data writes a
// gradient row per point (4,880 B) that weight-gradient reads; for the
// fg-fine launch that is 2.7 GB and 2.6 GB, ~0.8 ms per pass over either
// at 3.35 TB/s.
//
// Design (simple and correct first):
// - The Pallas backward recomputes the forward per block with all eight
//   trunk activations resident. A 64-point tile of them is 64 x 8 x 256 x 2 B
//   = 256 KB, more than the 227 KB a CTA may use, so here the training
//   forward (`fused_nerf_train_fwd_kernel`, the eval kernel of fused_mlp.cu
//   plus the noise) writes every bf16 activation tile it makes to one row
//   per point in device memory (ActLayout, ~5 KB per point). Its device code
//   is a copy of fused_mlp.cu's rather than a shared header, so that the
//   eval kernel compiles exactly as it was measured.
// - The Pallas backward sums weight gradients over a sequential grid into
//   resident accumulators; CUDA blocks run concurrently, and f32 atomics
//   from every tile into ~606k weight scalars would be slow and change
//   order run to run. So the backward is two kernels:
//   1. `train_bwd_data_kernel`, per 64-point tile: recomputes the sigma and
//      rgb pre-activations from the saved rows, applies the output
//      derivatives, then walks the layers backwards with mma.sync against
//      transposed weights (packed by the wrapper), writing each layer's
//      bf16 pre-activation gradient d_pre to one row per point (GradLayout)
//      and d_app (f32) per point; each layer's activation tile (for the
//      ReLU mask) comes in, and each d_pre tile goes out, as 16-byte
//      vector copies through shared memory;
//   2. `weight_grad_kernel`: dW = d_pre^T . input for every layer as
//      split-K mma.sync GEMMs over points (128 x 128 output tiles, so each
//      row chunk is read by half as many CTAs as with 64 x 64; f32 partials
//      per split; the next 32-point chunk is prefetched into registers
//      while the current one is multiplied); the last CTA of each tile (an
//      atomic counter) adds the splits in a fixed order, so results do not
//      depend on scheduling. Bias gradients are the column sums of d_pre
//      taken while its chunks are loaded.
// - Rounding follows `_train_bwd_kernel`: the output cotangent is rounded
//   to bf16; activation derivatives run in f32; every matmul operand is
//   bf16 with f32 accumulation; ReLU masks come from the bf16 activations.
//   One difference: the bias gradients of the sigma, rgb and trunk_final
//   layers sum the bf16-rounded pre-activation gradients that their weight
//   gradients use, where the Pallas kernel sums the f32 values (the plain
//   version in fused_train.py does the same as this kernel).
//
// Left for later work: recomputing activations in a 32-point tile instead
// of saving them, wgmma with TMA, fusing the weight-gradient GEMMs into the
// backward-data sweep.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;          // points per CTA
constexpr int NTHREADS = 256;   // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int PAD = 8;          // bf16 elements of row padding
constexpr int MAX_LAYERS = 16;  // trunk layers + trunk_final + dir_a
constexpr int MIN_BLOCKS = 2;

typedef __nv_bfloat16 bf16;

// Forward parameters: fused_mlp.cu's, plus the noise and the saved rows.
struct Params {
  const float* xyz;    // (M, xyz_dim)
  const float* dirs;   // (M, 3) direction coordinates, or null
  const bf16* app;     // (M, app_dim), or null
  float* out;          // (M, 4)
  const bf16* w_sigma; // (D,)
  const float* b_sigma;
  const bf16* w_rgb;   // (3, rgb_in)
  const float* b_rgb;
  const bf16* w[MAX_LAYERS];  // (N, Ktot) row-major, Ktot = sum of segments
  const float* b[MAX_LAYERS];
  int M, xyz_dim, nf_xyz, nf_dir, layers, D, app_dim, skip_mask, has_branch;
  int shifted_softplus, EP, DP, AP;
  const float* noise;  // (M,) pre-activation sigma noise, or null
  bf16* save;          // (M, save_stride) activation rows
  int save_stride;
};

// Column offsets of one point's saved activation row (bf16):
// [enc EP | h_0 D | ... | h_{L-1} D | final D | dir enc DP | app AP | branch D/2]
// (the last four only with the dir/appearance branch). The Python wrapper
// (render/fused_train.py::act_layout) computes the same offsets.
struct ActLayout {
  int h0, final_, dir, app, branch, width;
  __device__ ActLayout(int EP, int DP, int AP, int D, int layers, int has_branch) {
    h0 = EP;
    final_ = EP + layers * D;
    dir = final_ + D;
    app = dir + DP;
    branch = app + AP;
    width = has_branch ? branch + D / 2 : final_;
  }
};

struct Seg {
  const bf16* a;  // shared-memory tile, TM rows
  int stride;     // row stride in elements
  int K;          // columns (multiple of 16)
};

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld_smem_u32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t ld_global_u32(const bf16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc = concat(segments)[TM, Ktot] @ W[N, Ktot]^T in f32; then
// epi(row, col, v0, v1) for each pair of neighbouring output columns (the
// backward's matmuls). Each warp owns 32 output columns (4 n8 tiles) for
// all 4 m16 row tiles.
template <typename Epi>
__device__ void mma_gemm(const Seg* segs, int nseg, const bf16* __restrict__ W,
                         int N, Epi epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int ktot = 0;
  for (int s = 0; s < nseg; ++s) ktot += segs[s].K;

  for (int n0 = warp * 32; n0 < N; n0 += NWARPS * 32) {
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    int kw = 0;  // column offset of this segment inside W
    for (int s = 0; s < nseg; ++s) {
      const bf16* A = segs[s].a;
      const int sa = segs[s].stride;
      for (int k = 0; k < segs[s].K; k += 16) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const bf16* p0 = A + (mt * 16 + g) * sa + k + 2 * t;
          const bf16* p1 = p0 + 8 * sa;
          af[mt][0] = ld_smem_u32(p0);
          af[mt][1] = ld_smem_u32(p1);
          af[mt][2] = ld_smem_u32(p0 + 8);
          af[mt][3] = ld_smem_u32(p1 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (n0 + nt * 8 < N) {  // warp-uniform; N is a multiple of 8
            const bf16* wp =
                W + (size_t)(n0 + nt * 8 + g) * ktot + kw + k + 2 * t;
            const uint32_t b0 = ld_global_u32(wp);
            const uint32_t b1 = ld_global_u32(wp + 8);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
          }
        }
      }
      kw += segs[s].K;
    }

#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (n0 + nt * 8 < N) {
        const int col = n0 + nt * 8 + 2 * t;
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int row = mt * 16 + g;
          epi(row, col, acc[mt][nt][0], acc[mt][nt][1]);
          epi(row + 8, col, acc[mt][nt][2], acc[mt][nt][3]);
        }
      }
    }
  }
}

// out[TM, N] = act(concat(segments) @ W^T + bias) in bf16 (a dense layer:
// bias in f32, optional ReLU, then rounding to bf16): fused_mlp.cu's
// mma_layer. With the epilogue written out here (biases loaded once per
// column pair) the forward measured 6% faster on an H100 than through
// mma_gemm's per-element epilogue.
__device__ void mma_layer(const Seg* segs, int nseg, const bf16* __restrict__ W,
                          const float* __restrict__ bias, int N, bf16* outs,
                          int ostride, bool relu) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  int ktot = 0;
  for (int s = 0; s < nseg; ++s) ktot += segs[s].K;

  for (int n0 = warp * 32; n0 < N; n0 += NWARPS * 32) {
    float acc[4][4][4];
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;

    int kw = 0;  // column offset of this segment inside W
    for (int s = 0; s < nseg; ++s) {
      const bf16* A = segs[s].a;
      const int sa = segs[s].stride;
      for (int k = 0; k < segs[s].K; k += 16) {
        uint32_t af[4][4];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const bf16* p0 = A + (mt * 16 + g) * sa + k + 2 * t;
          const bf16* p1 = p0 + 8 * sa;
          af[mt][0] = ld_smem_u32(p0);
          af[mt][1] = ld_smem_u32(p1);
          af[mt][2] = ld_smem_u32(p0 + 8);
          af[mt][3] = ld_smem_u32(p1 + 8);
        }
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (n0 + nt * 8 < N) {  // warp-uniform; N is a multiple of 8
            const bf16* wp =
                W + (size_t)(n0 + nt * 8 + g) * ktot + kw + k + 2 * t;
            const uint32_t b0 = ld_global_u32(wp);
            const uint32_t b1 = ld_global_u32(wp + 8);
#pragma unroll
            for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
          }
        }
      }
      kw += segs[s].K;
    }

#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      if (n0 + nt * 8 < N) {
        const int col = n0 + nt * 8 + 2 * t;
        const float bias0 = bias[col];
        const float bias1 = bias[col + 1];
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          const int row = mt * 16 + g;
          float v0 = acc[mt][nt][0] + bias0;
          float v1 = acc[mt][nt][1] + bias1;
          float v2 = acc[mt][nt][2] + bias0;
          float v3 = acc[mt][nt][3] + bias1;
          if (relu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
            v2 = fmaxf(v2, 0.f);
            v3 = fmaxf(v3, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(outs + row * ostride + col) =
              __floats2bfloat162_rn(v0, v1);
          *reinterpret_cast<__nv_bfloat162*>(outs + (row + 8) * ostride + col) =
              __floats2bfloat162_rn(v2, v3);
        }
      }
    }
  }
}

// Frequency encode of d coordinates with nf frequencies into a TM x width
// bf16 tile: column c < d (1 + 2 nf) holds x[c % d] for block j = c / d = 0,
// else sin(x * 2^k + phase) with k = (j - 1) / 2 and phase pi/2 on cos
// blocks; columns past the live width are zero.
__device__ void encode_tile(const float* __restrict__ src, int d, int nf,
                            int width, int stride, int m0, int M, bf16* tile) {
  const int live = d * (1 + 2 * nf);
  for (int idx = threadIdx.x; idx < TM * width; idx += NTHREADS) {
    const int r = idx / width;
    const int c = idx - r * width;
    const int m = m0 + r;
    float v = 0.f;
    if (m < M && c < live) {
      const int j = c / d;
      const float x = src[(size_t)m * d + (c - j * d)];
      if (j == 0) {
        v = x;
      } else {
        const int k = (j - 1) >> 1;
        float arg = x * __int_as_float((k + 127) << 23);  // exact 2^k
        if ((j - 1) & 1) arg = arg + 1.57079632679489661923f;
        v = sinf(arg);
      }
    }
    tile[r * stride + c] = __float2bfloat16_rn(v);
  }
}

// Copy a TM x width bf16 shared-memory tile into columns [col0, col0 +
// width) of the saved rows m0 .. m0 + TM - 1 (rows past M are skipped).
// width, col0, the tile stride and the row stride are multiples of 8
// elements, so every copy is one 16-byte vector.
__device__ void save_tile(const bf16* tile, int stride, int width, bf16* save,
                          int save_stride, int col0, int m0, int M) {
  const int vec = width / 8;
  for (int idx = threadIdx.x; idx < TM * vec; idx += NTHREADS) {
    const int r = idx / vec;
    const int c = (idx - r * vec) * 8;
    if (m0 + r < M) {
      *reinterpret_cast<uint4*>(save + (size_t)(m0 + r) * save_stride + col0 + c) =
          *reinterpret_cast<const uint4*>(tile + r * stride + c);
    }
  }
}

// The reverse of save_tile: columns [col0, col0 + width) of rows m0 .. m0 +
// TM - 1 into a TM x width tile (rows past M read as zeros).
__device__ void load_tile(bf16* tile, int stride, int width, const bf16* src,
                          int src_stride, int col0, int m0, int M) {
  const int vec = width / 8;
  for (int idx = threadIdx.x; idx < TM * vec; idx += NTHREADS) {
    const int r = idx / vec;
    const int c = (idx - r * vec) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (m0 + r < M)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(m0 + r) * src_stride +
                                          col0 + c);
    *reinterpret_cast<uint4*>(tile + r * stride + c) = v;
  }
}

// The training forward for the tile of points starting at blockIdx.x * TM:
// fused_mlp.cu's eval kernel, plus the sigma noise before the density
// activation, and every bf16 activation tile written into the saved rows.
__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
fused_nerf_train_fwd_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SE = p.EP + PAD, SD = p.DP + PAD, SA = p.AP + PAD, SH = p.D + PAD;
  bf16* enc = reinterpret_cast<bf16*>(smem_raw);
  bf16* dirt = enc + TM * SE;
  bf16* appt = dirt + (p.DP ? TM * SD : 0);
  bf16* act0 = appt + (p.AP ? TM * SA : 0);
  bf16* act1 = act0 + TM * SH;
  float* sig = reinterpret_cast<float*>(act1 + TM * SH);

  const int m0 = blockIdx.x * TM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const ActLayout lay(p.EP, p.DP, p.AP, p.D, p.layers, p.has_branch);
  auto save = [&](const bf16* tile, int stride, int width, int col0) {
    save_tile(tile, stride, width, p.save, p.save_stride, col0, m0, p.M);
  };

  encode_tile(p.xyz, p.xyz_dim, p.nf_xyz, p.EP, SE, m0, p.M, enc);
  if (p.DP) encode_tile(p.dirs, 3, p.nf_dir, p.DP, SD, m0, p.M, dirt);
  if (p.AP) {
    for (int idx = threadIdx.x; idx < TM * p.AP; idx += NTHREADS) {
      const int r = idx / p.AP;
      const int c = idx - r * p.AP;
      const int m = m0 + r;
      appt[r * SA + c] = (m < p.M && c < p.app_dim)
                             ? p.app[(size_t)m * p.app_dim + c]
                             : __float2bfloat16_rn(0.f);
    }
  }
  __syncthreads();
  save(enc, SE, p.EP, 0);
  if (p.has_branch) {
    if (p.DP) save(dirt, SD, p.DP, lay.dir);
    if (p.AP) save(appt, SA, p.AP, lay.app);
  }

  bf16* bufs[2] = {act0, act1};
  int pi = 0;
  const bf16* h = enc;
  for (int i = 0; i < p.layers; ++i) {
    Seg segs[2];
    int ns = 1;
    if (i == 0) {
      segs[0] = {enc, SE, p.EP};
    } else if ((p.skip_mask >> i) & 1) {
      segs[0] = {enc, SE, p.EP};
      segs[1] = {h, SH, p.D};
      ns = 2;
    } else {
      segs[0] = {h, SH, p.D};
    }
    mma_layer(segs, ns, p.w[i], p.b[i], p.D, bufs[pi], SH, true);
    __syncthreads();
    h = bufs[pi];
    pi ^= 1;
    save(h, SH, p.D, lay.h0 + i * p.D);
  }

  // Sigma head: one warp per point.
  for (int r = warp; r < TM; r += NWARPS) {
    float s = 0.f;
    for (int c = 2 * lane; c < p.D; c += 64) {
      const float2 hv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(h + r * SH + c));
      const float2 wv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.w_sigma + c));
      s += hv.x * wv.x + hv.y * wv.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      s += p.b_sigma[0];
      if (p.noise != nullptr && m0 + r < p.M) s += p.noise[m0 + r];
      if (p.shifted_softplus) {
        const float x = s - 1.f;
        s = fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
      } else {
        s = fmaxf(s, 0.f);
      }
      sig[r] = s;
    }
  }

  int rgb_in = p.D;
  if (p.has_branch) {
    Seg fseg[1] = {{h, SH, p.D}};
    mma_layer(fseg, 1, p.w[p.layers], p.b[p.layers], p.D, bufs[pi], SH, false);
    __syncthreads();  // also orders the sigma head's reads of h
    const bf16* fin = bufs[pi];
    pi ^= 1;
    save(fin, SH, p.D, lay.final_);
    Seg segs[3];
    int ns = 0;
    segs[ns++] = {fin, SH, p.D};
    if (p.DP) segs[ns++] = {dirt, SD, p.DP};
    if (p.AP) segs[ns++] = {appt, SA, p.AP};
    mma_layer(segs, ns, p.w[p.layers + 1], p.b[p.layers + 1], p.D / 2, bufs[pi],
              SH, true);
    __syncthreads();
    h = bufs[pi];
    rgb_in = p.D / 2;
    save(h, SH, p.D / 2, lay.branch);
  }

  // Rgb head + output: one warp per point (the same warp wrote sig[r]).
  for (int r = warp; r < TM; r += NWARPS) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    for (int c = 2 * lane; c < rgb_in; c += 64) {
      const float2 hv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(h + r * SH + c));
      const float2 w0 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.w_rgb + c));
      const float2 w1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.w_rgb + rgb_in + c));
      const float2 w2 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(p.w_rgb + 2 * rgb_in + c));
      a0 += hv.x * w0.x + hv.y * w0.y;
      a1 += hv.x * w1.x + hv.y * w1.y;
      a2 += hv.x * w2.x + hv.y * w2.y;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      a0 += __shfl_xor_sync(0xffffffffu, a0, o);
      a1 += __shfl_xor_sync(0xffffffffu, a1, o);
      a2 += __shfl_xor_sync(0xffffffffu, a2, o);
    }
    const int m = m0 + r;
    if (lane == 0 && m < p.M) {
      float4 o;
      o.x = 1.f / (1.f + expf(-(a0 + p.b_rgb[0])));
      o.y = 1.f / (1.f + expf(-(a1 + p.b_rgb[1])));
      o.z = 1.f / (1.f + expf(-(a2 + p.b_rgb[2])));
      o.w = sig[r];
      reinterpret_cast<float4*>(p.out)[m] = o;
    }
  }
}

// Column offsets of one point's gradient row (bf16):
// [d_pre_0 D | ... | d_pre_{L-1} D | d_final D | d_a_pre KB | heads 8]
// heads = [g_sigma, g_r, g_g, g_b, 0, 0, 0, 0] (after the output
// derivatives, rounded to bf16). Without the branch the row is the trunk
// part plus the heads. fused_train.py::grad_layout computes the same.
struct GradLayout {
  int dfinal, da, heads, width;
  __device__ GradLayout(int D, int layers, int KB, int has_branch) {
    dfinal = layers * D;
    da = dfinal + D;
    heads = has_branch ? da + KB : dfinal;
    width = heads + 8;
  }
};

struct BwdParams {
  const bf16* act;
  bf16* grad;
  const float* g;      // (M, 4) output cotangent, f32
  const float* noise;  // (M,) or null
  float* d_app;        // (M, app_dim) or null
  const bf16* w_sigma;
  const float* b_sigma;
  const bf16* w_rgb;
  const float* b_rgb;
  // Transposed matmul weights (Ktot, N) row-major; dir_a's is
  // (D + DP + AP, KB) with zero columns past D / 2.
  const bf16* wt[MAX_LAYERS];
  int M, layers, D, skip_mask, has_branch, shifted_softplus, EP, DP, AP;
  int app_dim, KB, act_stride, grad_stride;
};

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
train_bwd_data_kernel(const BwdParams p) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int SW = p.D + PAD;
  bf16* tA = reinterpret_cast<bf16*>(smem_raw);  // gradient tiles (ping-pong)
  bf16* tB = tA + TM * SW;
  bf16* tH = tB + TM * SW;  // the activation tile the current mask reads
  float* gsig = reinterpret_cast<float*>(tH + TM * SW);
  float* grgb = gsig + TM;  // (TM, 3)

  const int m0 = blockIdx.x * TM;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int L = p.layers, D = p.D;
  const ActLayout lay(p.EP, p.DP, p.AP, D, L, p.has_branch);
  const GradLayout gl(D, L, p.KB, p.has_branch);
  const int h_last = lay.h0 + (L - 1) * D;
  const int rgb_in = p.has_branch ? D / 2 : D;
  const int rgb_src = p.has_branch ? lay.branch : h_last;
  auto load_act = [&](int width, int col0) {
    load_tile(tH, SW, width, p.act, p.act_stride, col0, m0, p.M);
  };
  auto store_grad = [&](const bf16* tile, int width, int col0) {
    save_tile(tile, SW, width, p.grad, p.grad_stride, col0, m0, p.M);
  };

  // 1. Output derivatives, one warp per point: recompute sigma_pre and
  //    rgb_pre from the saved rows.
  for (int r = warp; r < TM; r += NWARPS) {
    const int m = m0 + r;
    float gs = 0.f, gr[3] = {0.f, 0.f, 0.f};
    if (m < p.M) {  // warp-uniform
      const bf16* row = p.act + (size_t)m * p.act_stride;
      float s = 0.f, a0 = 0.f, a1 = 0.f, a2 = 0.f;
      for (int c = 2 * lane; c < D; c += 64) {
        const float2 hv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(row + h_last + c));
        const float2 wv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.w_sigma + c));
        s += hv.x * wv.x + hv.y * wv.y;
      }
      for (int c = 2 * lane; c < rgb_in; c += 64) {
        const float2 hv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(row + rgb_src + c));
        const float2 w0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.w_rgb + c));
        const float2 w1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.w_rgb + rgb_in + c));
        const float2 w2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(p.w_rgb + 2 * rgb_in + c));
        a0 += hv.x * w0.x + hv.y * w0.y;
        a1 += hv.x * w1.x + hv.y * w1.y;
        a2 += hv.x * w2.x + hv.y * w2.y;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s += __shfl_xor_sync(0xffffffffu, s, o);
        a0 += __shfl_xor_sync(0xffffffffu, a0, o);
        a1 += __shfl_xor_sync(0xffffffffu, a1, o);
        a2 += __shfl_xor_sync(0xffffffffu, a2, o);
      }
      if (lane == 0) {
        const float4 go = reinterpret_cast<const float4*>(p.g)[m];
        float x = s + p.b_sigma[0];
        if (p.noise != nullptr) x += p.noise[m];
        const float ds = p.shifted_softplus ? 1.f / (1.f + expf(-(x - 1.f)))
                                            : (x > 0.f ? 1.f : 0.f);
        gs = bf16_round(bf16_round(go.w) * ds);
        const float pre[3] = {a0 + p.b_rgb[0], a1 + p.b_rgb[1], a2 + p.b_rgb[2]};
        const float gin[3] = {go.x, go.y, go.z};
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          const float sj = 1.f / (1.f + expf(-pre[j]));
          gr[j] = bf16_round(bf16_round(gin[j]) * sj * (1.f - sj));
        }
        __nv_bfloat162 h4[4];
        h4[0] = __floats2bfloat162_rn(gs, gr[0]);
        h4[1] = __floats2bfloat162_rn(gr[1], gr[2]);
        h4[2] = __floats2bfloat162_rn(0.f, 0.f);
        h4[3] = h4[2];
        *reinterpret_cast<uint4*>(p.grad + (size_t)m * p.grad_stride + gl.heads) =
            *reinterpret_cast<const uint4*>(h4);
      }
    }
    if (lane == 0) {
      gsig[r] = gs;
      grgb[3 * r] = gr[0];
      grgb[3 * r + 1] = gr[1];
      grgb[3 * r + 2] = gr[2];
    }
  }
  load_act(p.has_branch ? D / 2 : D, rgb_src);
  __syncthreads();

  // d_pre = bf16(d_h * (h > 0)) into a tile; h comes from tH.
  auto mask_store = [&](int row, int col, float v0, float v1, bf16* dst) {
    const float2 hv = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(tH + row * SW + col));
    *reinterpret_cast<__nv_bfloat162*>(dst + row * SW + col) =
        __floats2bfloat162_rn(hv.x > 0.f ? v0 : 0.f, hv.y > 0.f ? v1 : 0.f);
  };

  if (p.has_branch) {
    // 2. d_a_pre = bf16((bf16(g_rgb) @ w_rgb) * (branch > 0)), zero past D/2
    //    (tH holds the branch tile).
    for (int idx = threadIdx.x; idx < TM * p.KB; idx += NTHREADS) {
      const int r = idx / p.KB;
      const int c = idx - r * p.KB;
      float v = 0.f;
      if (c < rgb_in) {
        const float db = grgb[3 * r] * __bfloat162float(p.w_rgb[c]) +
                         grgb[3 * r + 1] * __bfloat162float(p.w_rgb[rgb_in + c]) +
                         grgb[3 * r + 2] * __bfloat162float(p.w_rgb[2 * rgb_in + c]);
        v = __bfloat162float(tH[r * SW + c]) > 0.f ? db : 0.f;
      }
      tA[r * SW + c] = __float2bfloat16_rn(v);
    }
    __syncthreads();
    store_grad(tA, p.KB, gl.da);

    // 3. d_final = d_a_pre @ W_dir_a[:, :D]; d_app = d_a_pre @ W_dir_a[:, app].
    const Seg sa[1] = {{tA, SW, p.KB}};
    mma_gemm(sa, 1, p.wt[L + 1], D, [&](int row, int col, float v0, float v1) {
      *reinterpret_cast<__nv_bfloat162*>(tB + row * SW + col) =
          __floats2bfloat162_rn(v0, v1);
    });
    if (p.AP && p.d_app != nullptr) {
      mma_gemm(sa, 1, p.wt[L + 1] + (size_t)(D + p.DP) * p.KB, p.AP,
               [&](int row, int col, float v0, float v1) {
                 const int m = m0 + row;
                 if (m >= p.M) return;
                 float* dst = p.d_app + (size_t)m * p.app_dim;
                 if (col < p.app_dim) dst[col] = v0;
                 if (col + 1 < p.app_dim) dst[col + 1] = v1;
               });
    }
    __syncthreads();
    store_grad(tB, D, gl.dfinal);
    load_act(D, h_last);
    __syncthreads();

    // 4. d_h_last = d_final @ W_final + bf16(g_sigma) w_sigma, masked.
    const Seg sb[1] = {{tB, SW, D}};
    mma_gemm(sb, 1, p.wt[L], D, [&](int row, int col, float v0, float v1) {
      v0 += gsig[row] * __bfloat162float(p.w_sigma[col]);
      v1 += gsig[row] * __bfloat162float(p.w_sigma[col + 1]);
      mask_store(row, col, v0, v1, tA);
    });
  } else {
    // 4'. d_h_last = bf16(g_sigma) w_sigma + bf16(g_rgb) @ w_rgb, masked
    //     (tH holds h_last).
    for (int idx = threadIdx.x; idx < TM * D / 2; idx += NTHREADS) {
      const int r = idx / (D / 2);
      const int c = 2 * (idx - r * (D / 2));
      float v[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v[e] = gsig[r] * __bfloat162float(p.w_sigma[c + e]) +
               (grgb[3 * r] * __bfloat162float(p.w_rgb[c + e]) +
                grgb[3 * r + 1] * __bfloat162float(p.w_rgb[D + c + e]) +
                grgb[3 * r + 2] * __bfloat162float(p.w_rgb[2 * D + c + e]));
      }
      mask_store(r, c, v[0], v[1], tA);
    }
  }
  __syncthreads();
  store_grad(tA, D, (L - 1) * D);

  // 5. Trunk, last layer to first: d_h_{i-1} = d_pre_i @ W_i[:, h part].
  bf16* cur = tA;
  bf16* nxt = tB;
  for (int i = L - 1; i >= 1; --i) {
    load_act(D, lay.h0 + (i - 1) * D);
    __syncthreads();
    const bf16* W = p.wt[i] + (((p.skip_mask >> i) & 1) ? (size_t)p.EP * D : 0);
    const Seg s1[1] = {{cur, SW, D}};
    mma_gemm(s1, 1, W, D, [&](int row, int col, float v0, float v1) {
      mask_store(row, col, v0, v1, nxt);
    });
    __syncthreads();
    store_grad(nxt, D, (i - 1) * D);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// ---------------------------------------------------------------- dW, db

constexpr int WN = 128;       // output tile: 128 (n) x 128 (k)
constexpr int WK = 128;
constexpr int MC = 32;        // points per shared-memory chunk
constexpr int SMC = MC + 8;   // chunk row stride (elements)
constexpr int TILE_ELEMS = WN * WK + WN;  // partial dW tile + bias row
constexpr int MAX_JOBS = 24;

// dW[n][k] = sum_m grad[m][d_col + n] * act[m][x_col + k] for n < N, k < K,
// written to out[out_off + n * out_stride + k]; with bias_off >= 0 also
// db[n] = sum_m grad[m][d_col + n] to out[bias_off + n].
struct Job {
  int d_col, n, x_col, k, out_off, out_stride, bias_off;
};

struct WgradParams {
  const bf16* act;
  const bf16* grad;
  float* out;
  float* scratch;  // (splits, tiles, TILE_ELEMS)
  int* counters;   // (tiles,), zero at launch
  int M, njobs, tiles, splits, split_len, act_stride, grad_stride;
  Job jobs[MAX_JOBS];
};

// Two neighbouring bf16 of row m starting at column c (c < limit), as one
// word; columns at or past `limit` and rows past `me` read as zero.
__device__ __forceinline__ uint32_t ld_pair(const bf16* base, int stride, int m,
                                            int me, int c, int limit,
                                            bool aligned) {
  if (m >= me || c >= limit) return 0u;
  const bf16* q = base + (size_t)m * stride + c;
  if (aligned && c + 1 < limit) return ld_global_u32(q);
  const unsigned short lo = __bfloat16_as_ushort(q[0]);
  const unsigned short hi = c + 1 < limit ? __bfloat16_as_ushort(q[1]) : 0;
  return (uint32_t)lo | ((uint32_t)hi << 16);
}

__global__ void __launch_bounds__(NTHREADS)
weight_grad_kernel(const WgradParams p) {
  __shared__ __align__(16) bf16 sD[WN * SMC];  // [n][m]
  __shared__ __align__(16) bf16 sX[WK * SMC];  // [k][m]
  __shared__ float sb[4][WN];
  __shared__ int s_last;

  int t = blockIdx.x, j = 0, n0 = 0, k0 = 0;
  for (; j < p.njobs; ++j) {
    const int nt = (p.jobs[j].n + WN - 1) / WN;
    const int kt = (p.jobs[j].k + WK - 1) / WK;
    if (t < nt * kt) {
      n0 = (t / kt) * WN;
      k0 = (t % kt) * WK;
      break;
    }
    t -= nt * kt;
  }
  const Job jb = p.jobs[j];
  const int tile = blockIdx.x;
  const int mb = blockIdx.y * p.split_len;
  const int me = min(p.M, mb + p.split_len);
  const bool do_bias = jb.bias_off >= 0 && k0 == 0;

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t4 = lane & 3;
  const int wn = (warp >> 2) * 64;  // this warp's 64 output rows (n)
  const int wk = (warp & 3) * 32;   // and 32 output columns (k)
  // Loads: each thread takes two neighbouring columns and 8 points.
  const int lc = (threadIdx.x & 63) * 2;
  const int lm = (threadIdx.x >> 6) * 8;
  const bf16* dbase = p.grad + jb.d_col + n0;
  const bf16* xbase = p.act + jb.x_col + k0;
  const int dlim = jb.n - n0, xlim = jb.k - k0;
  const bool d_al = ((jb.d_col + n0) & 1) == 0;
  const bool x_al = ((jb.x_col + k0) & 1) == 0;

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.f;
  float bsum0 = 0.f, bsum1 = 0.f;

  uint32_t pd[8], px[8];  // the next chunk, prefetched into registers
  auto fetch = [&](int mbase) {
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int m = mbase + lm + e;
      pd[e] = ld_pair(dbase, p.grad_stride, m, me, lc, dlim, d_al);
      px[e] = ld_pair(xbase, p.act_stride, m, me, lc, xlim, x_al);
    }
  };
  // Rows lm .. lm+7 of columns lc, lc+1 -> sT[lc][lm..], sT[lc+1][lm..].
  auto stage = [&](bf16* sT, const uint32_t* v) {
    uint32_t lo[4], hi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      lo[e] = __byte_perm(v[2 * e], v[2 * e + 1], 0x5410);
      hi[e] = __byte_perm(v[2 * e], v[2 * e + 1], 0x7632);
    }
    *reinterpret_cast<uint4*>(sT + lc * SMC + lm) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
    *reinterpret_cast<uint4*>(sT + (lc + 1) * SMC + lm) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
  };

  if (mb < me) fetch(mb);
  for (int mbase = mb; mbase < me; mbase += MC) {
    stage(sD, pd);
    stage(sX, px);
    if (do_bias) {
#pragma unroll
      for (int e = 0; e < 8; ++e) {  // bf16 -> f32 is a 16-bit shift
        bsum0 += __uint_as_float(pd[e] << 16);
        bsum1 += __uint_as_float(pd[e] & 0xffff0000u);
      }
    }
    __syncthreads();
    if (mbase + MC < me) fetch(mbase + MC);
#pragma unroll
    for (int kk = 0; kk < MC; kk += 16) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const bf16* p0 = sD + (wn + mt * 16 + g) * SMC + kk + 2 * t4;
        const bf16* p1 = p0 + 8 * SMC;
        a[mt][0] = ld_smem_u32(p0);
        a[mt][1] = ld_smem_u32(p1);
        a[mt][2] = ld_smem_u32(p0 + 8);
        a[mt][3] = ld_smem_u32(p1 + 8);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const bf16* bp = sX + (wk + nt * 8 + g) * SMC + kk + 2 * t4;
        const uint32_t b0 = ld_smem_u32(bp);
        const uint32_t b1 = ld_smem_u32(bp + 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) mma_bf16(acc[mt][nt], a[mt], b0, b1);
      }
    }
    __syncthreads();
  }

  // This split's partial tile.
  float* part = p.scratch + ((size_t)blockIdx.y * p.tiles + tile) * TILE_ELEMS;
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int row = wn + mt * 16 + g;
      const int col = wk + nt * 8 + 2 * t4;
      *reinterpret_cast<float2*>(part + row * WK + col) =
          make_float2(acc[mt][nt][0], acc[mt][nt][1]);
      *reinterpret_cast<float2*>(part + (row + 8) * WK + col) =
          make_float2(acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
  if (do_bias) {
    sb[threadIdx.x >> 6][lc] = bsum0;
    sb[threadIdx.x >> 6][lc + 1] = bsum1;
    __syncthreads();
    if (threadIdx.x < WN)
      part[WN * WK + threadIdx.x] =
          ((sb[0][threadIdx.x] + sb[1][threadIdx.x]) + sb[2][threadIdx.x]) +
          sb[3][threadIdx.x];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last = atomicAdd(p.counters + tile, 1) == p.splits - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();

  // The last split of this tile sums every split's partial in split order.
  const int nelem = do_bias ? TILE_ELEMS : WN * WK;
  for (int e = threadIdx.x; e < nelem; e += NTHREADS) {
    float s = 0.f;
    for (int sp = 0; sp < p.splits; ++sp)
      s += __ldcg(p.scratch + ((size_t)sp * p.tiles + tile) * TILE_ELEMS + e);
    if (e < WN * WK) {
      const int n = n0 + e / WK;
      const int k = k0 + e % WK;
      if (n < jb.n && k < jb.k) p.out[jb.out_off + (size_t)n * jb.out_stride + k] = s;
    } else {
      const int n = n0 + e - WN * WK;
      if (n < jb.n) p.out[jb.bias_off + n] = s;
    }
  }
}

// Shared memory bytes of one forward CTA (the layout at the top of
// fused_nerf_train_fwd_kernel).
int forward_smem_bytes(int EP, int DP, int AP, int D) {
  int elems = TM * (EP + PAD) + (DP ? TM * (DP + PAD) : 0) +
              (AP ? TM * (AP + PAD) : 0) + 2 * TM * (D + PAD);
  return elems * 2 + TM * 4;
}

// Fill the forward Params from the pointer/int tables of
// fused_mlp.py::launch_tables (the eval kernel's tables).
int fill_params(Params& p, const long long* ptrs, const int* dims) {
  p.xyz = reinterpret_cast<const float*>(ptrs[0]);
  p.dirs = reinterpret_cast<const float*>(ptrs[1]);
  p.app = reinterpret_cast<const bf16*>(ptrs[2]);
  p.out = reinterpret_cast<float*>(ptrs[3]);
  p.w_sigma = reinterpret_cast<const bf16*>(ptrs[4]);
  p.b_sigma = reinterpret_cast<const float*>(ptrs[5]);
  p.w_rgb = reinterpret_cast<const bf16*>(ptrs[6]);
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
  const int nmat = p.layers + (p.has_branch ? 2 : 0);
  if (nmat > MAX_LAYERS) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < MAX_LAYERS; ++i) {
    p.w[i] = i < nmat ? reinterpret_cast<const bf16*>(ptrs[8 + 2 * i]) : nullptr;
    p.b[i] = i < nmat ? reinterpret_cast<const float*>(ptrs[9 + 2 * i]) : nullptr;
  }
  return 0;
}

cudaError_t set_smem(const void* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

// The training forward: ptrs/dims as fused_nerf_eval_launch, plus the sigma
// noise (or 0) and the saved-activation rows with their stride.
int fused_nerf_train_fwd_launch(const long long* ptrs, const int* dims,
                                long long noise, long long save, int save_stride,
                                void* stream) {
  Params p;
  const int bad = fill_params(p, ptrs, dims);
  if (bad) return bad;
  p.noise = reinterpret_cast<const float*>(noise);
  p.save = reinterpret_cast<bf16*>(save);
  p.save_stride = save_stride;
  if (p.M <= 0) return 0;
  const int smem = forward_smem_bytes(p.EP, p.DP, p.AP, p.D);
  cudaError_t err = set_smem((const void*)fused_nerf_train_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  fused_nerf_train_fwd_kernel<<<(p.M + TM - 1) / TM, NTHREADS, smem,
                                reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// ptrs: act, grad, g, noise, d_app, w_sigma, b_sigma, w_rgb, b_rgb, then the
//       transposed matmul weights (trunk layers, trunk_final, dir_a).
// dims: M, layers, D, skip_mask, has_branch, shifted_softplus, EP, DP, AP,
//       app_dim, KB, act_stride, grad_stride.
int train_bwd_data_launch(const long long* ptrs, const int* dims, void* stream) {
  BwdParams p;
  p.act = reinterpret_cast<const bf16*>(ptrs[0]);
  p.grad = reinterpret_cast<bf16*>(ptrs[1]);
  p.g = reinterpret_cast<const float*>(ptrs[2]);
  p.noise = reinterpret_cast<const float*>(ptrs[3]);
  p.d_app = reinterpret_cast<float*>(ptrs[4]);
  p.w_sigma = reinterpret_cast<const bf16*>(ptrs[5]);
  p.b_sigma = reinterpret_cast<const float*>(ptrs[6]);
  p.w_rgb = reinterpret_cast<const bf16*>(ptrs[7]);
  p.b_rgb = reinterpret_cast<const float*>(ptrs[8]);
  p.M = dims[0];
  p.layers = dims[1];
  p.D = dims[2];
  p.skip_mask = dims[3];
  p.has_branch = dims[4];
  p.shifted_softplus = dims[5];
  p.EP = dims[6];
  p.DP = dims[7];
  p.AP = dims[8];
  p.app_dim = dims[9];
  p.KB = dims[10];
  p.act_stride = dims[11];
  p.grad_stride = dims[12];
  const int nmat = p.layers + (p.has_branch ? 2 : 0);
  if (nmat > MAX_LAYERS || p.KB > p.D) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < MAX_LAYERS; ++i)
    p.wt[i] = i < nmat ? reinterpret_cast<const bf16*>(ptrs[9 + i]) : nullptr;
  if (p.M <= 0) return 0;
  const int smem = 3 * TM * (p.D + PAD) * 2 + TM * 4 * 4;
  cudaError_t err = set_smem((const void*)train_bwd_data_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  train_bwd_data_kernel<<<(p.M + TM - 1) / TM, NTHREADS, smem,
                          reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

// ptrs: act, grad, out, scratch, counters.
// dims: M, njobs, tiles, splits, split_len, act_stride, grad_stride.
// jobs: njobs x 7 ints (Job fields in order).
int weight_grad_launch(const long long* ptrs, const int* dims, const int* jobs,
                       void* stream) {
  WgradParams p;
  p.act = reinterpret_cast<const bf16*>(ptrs[0]);
  p.grad = reinterpret_cast<const bf16*>(ptrs[1]);
  p.out = reinterpret_cast<float*>(ptrs[2]);
  p.scratch = reinterpret_cast<float*>(ptrs[3]);
  p.counters = reinterpret_cast<int*>(ptrs[4]);
  p.M = dims[0];
  p.njobs = dims[1];
  p.tiles = dims[2];
  p.splits = dims[3];
  p.split_len = dims[4];
  p.act_stride = dims[5];
  p.grad_stride = dims[6];
  if (p.njobs > MAX_JOBS || p.split_len % MC) return (int)cudaErrorInvalidValue;
  for (int j = 0; j < p.njobs; ++j) {
    const int* f = jobs + 7 * j;
    p.jobs[j] = {f[0], f[1], f[2], f[3], f[4], f[5], f[6]};
  }
  if (p.tiles <= 0) return 0;
  weight_grad_kernel<<<dim3(p.tiles, p.splits), NTHREADS, 0,
                       reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* fused_train_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
