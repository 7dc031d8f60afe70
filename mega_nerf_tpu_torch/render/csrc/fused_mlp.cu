// Fused NeRF eval MLP for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `mega_nerf_tpu/render/pallas_mlp.py::_mlp_kernel`
// (reached through `fused_nerf_eval`). One launch evaluates the whole NeRF
// forward for M points: frequency encode -> ReLU trunk with a skip layer ->
// shifted-softplus sigma head -> trunk_final -> dir/appearance branch ->
// sigmoid rgb head, and writes (M, 4) float32 [r, g, b, sigma].
//
// What bounds it on an H100: at the paper width (8 x 256 trunk, 48-d
// appearance) a point costs about 1.21 MFLOP (fg, 75 + 27 encode columns)
// or 1.24 MFLOP (bg, 100 + 27) against about 140 bytes of input and output,
// so the function is compute-bound: the bound for one 16,384-ray chunk
// (18.9M points over 4 launches) is about 18.9M x 1.22 MFLOP / 989 TFLOP/s
// (dense bf16) ~= 23 ms.
//
// Design (simple and correct first):
// - One CTA of 256 threads (8 warps) takes a tile of TM = 64 points. The
//   ragged last tile is masked here: rows past M encode as zeros and write
//   nothing.
// - The frequency encode runs in the kernel from the raw coordinates, in
//   float32 with precise sinf (the argument reaches 2^11 |x|, so the fast
//   intrinsics are wrong here); cos columns are sin(x * 2^k + pi/2), the
//   JAX kernel's exact form. The result is rounded to bf16 into shared
//   memory.
// - Activations ping-pong between two bf16 TM x layer_dim tiles in shared
//   memory; rows are padded by 8 elements so fragment loads hit distinct
//   banks.
// - Weights (~1.3 MB bf16 per model) do not fit in shared memory; each warp
//   streams the rows of its 32 output columns from global memory / L2.
// - Matmuls are mma.sync m16n8k16 bf16 -> f32. The bias add is in f32, then
//   ReLU, then rounding to bf16: the rounding points of the JAX kernel. The
//   skip layer is a split matmul over [enc | h] (two input segments of one
//   weight matrix), and the dir_a layer reads [final | dir enc | app].
// - The sigma head (layer_dim -> 1) and the rgb head (-> 3) are warp
//   reductions, one warp per point.
//
// Left for later work: wgmma with TMA-fed shared-memory weight tiles, a
// persistent schedule that keeps one CTA per SM walking over tiles, and a
// larger point tile to raise the reuse of each weight fetch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;          // points per CTA
constexpr int NTHREADS = 256;   // 8 warps
constexpr int NWARPS = NTHREADS / 32;
constexpr int PAD = 8;          // bf16 elements of row padding
constexpr int MAX_LAYERS = 16;  // trunk layers + trunk_final + dir_a
// Two CTAs per SM: the 128-register cap this sets spills a few hundred
// bytes, which measured faster on an H100 than one CTA per SM without spills.
constexpr int MIN_BLOCKS = 2;

typedef __nv_bfloat16 bf16;

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

// out[TM, N] = act(concat(segments)[TM, Ktot] @ W[N, Ktot]^T + bias), bf16.
// Each warp owns 32 output columns (4 n8 tiles) for all 4 m16 row tiles.
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

__global__ void __launch_bounds__(NTHREADS, MIN_BLOCKS)
fused_nerf_eval_kernel(const Params p) {
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

// Shared memory bytes for one CTA (the layout at the top of the kernel).
int smem_bytes(int EP, int DP, int AP, int D) {
  int elems = TM * (EP + PAD) + (DP ? TM * (DP + PAD) : 0) +
              (AP ? TM * (AP + PAD) : 0) + 2 * TM * (D + PAD);
  return elems * 2 + TM * 4;
}

}  // namespace

extern "C" {

// ptrs: xyz, dirs, app, out, w_sigma, b_sigma, w_rgb, b_rgb, then (w, b) per
//       matmul layer (trunk layers, then trunk_final and dir_a).
// dims: M, xyz_dim, nf_xyz, nf_dir, layers, D, app_dim, skip_mask,
//       has_branch, shifted_softplus, EP, DP, AP.
// Returns the CUDA error code of the launch (0 on success).
int fused_nerf_eval_launch(const long long* ptrs, const int* dims,
                           void* stream) {
  Params p;
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
  if (p.M <= 0) return 0;

  const int smem = smem_bytes(p.EP, p.DP, p.AP, p.D);
  cudaError_t err = cudaFuncSetAttribute(
      fused_nerf_eval_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = (p.M + TM - 1) / TM;
  fused_nerf_eval_kernel<<<blocks, NTHREADS, smem,
                           reinterpret_cast<cudaStream_t>(stream)>>>(p);
  return (int)cudaGetLastError();
}

const char* fused_nerf_eval_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
