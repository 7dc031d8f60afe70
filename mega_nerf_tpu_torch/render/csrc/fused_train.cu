// Fused NeRF training MLP for Hopper (sm_90a), written by hand: the
// backward-data kernel. The training forward is in train_fwd.cu, the
// weight-gradient kernel in weight_grad.cu.
//
// Replaces the dX/d_app half of the TPU kernel `mega_nerf_tpu/render/
// pallas_train.py::_train_bwd_kernel` (the custom-VJP backward: sigmoid,
// softplus(x-1) and ReLU derivatives, d_app per point).
//
// What bounds it on an H100: at the paper width the data-gradient products
// of a point cost a little less than its ~1.21 MFLOP forward (no gradient
// flows into the encodings). The function moves ~140-240 bytes per point
// (points, noise, output cotangent, d_app), so it is compute-bound: for the
// fg-fine launch of one 1024-ray step (524,288 points) the bound at 989
// TFLOP/s (dense bf16) is ~0.60 ms (chip_smoke.py computes it from its
// shapes).
// This design adds traffic of its own, which the bound does not count: it
// reads the saved activation row the training forward writes per point
// (5,184 B at the fg paper width) and writes a gradient row per point
// (4,880 B) that weight-gradient reads; for the fg-fine launch that is 2.7
// GB and 2.6 GB, ~0.8 ms per pass over either at 3.35 TB/s.
//
// Design (simple and correct first):
// - The Pallas backward recomputes the forward per block with all eight
//   trunk activations resident. A 64-point tile of them is 64 x 8 x 256 x 2 B
//   = 256 KB, more than the 227 KB a CTA may use, so the training forward
//   (train_fwd.cu) writes every bf16 activation tile it makes to one row
//   per point in device memory (ActLayout, ~5 KB per point), which this
//   kernel reads.
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
//   2. `weight_grad_kernel` (weight_grad.cu): dW = d_pre^T . input and the
//      bias sums for every layer, split-K over points with a fixed-order
//      reduction.
// - Rounding follows `_train_bwd_kernel`: the output cotangent is rounded
//   to bf16; activation derivatives run in f32; every matmul operand is
//   bf16 with f32 accumulation; ReLU masks come from the bf16 activations.
//   One difference: the bias gradients of the sigma, rgb and trunk_final
//   layers sum the bf16-rounded pre-activation gradients that their weight
//   gradients use, where the Pallas kernel sums the f32 values (the plain
//   version in fused_train.py does the same as this kernel).
//
// Left for later work: the layer chain of train_fwd.cu (wgmma over a
// resident tile, weights through a TMA ring) run against the transposed
// weights, fusing the weight-gradient GEMMs into the backward-data sweep.

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

cudaError_t set_smem(const void* fn, int bytes) {
  return cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

}  // namespace

extern "C" {

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

const char* fused_train_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
