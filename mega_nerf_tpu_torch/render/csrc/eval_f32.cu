// Fused NeRF eval MLP in f32 compute for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `mega_nerf_tpu/render/pallas_mlp.py::_mlp_kernel`
// (reached through `fused_nerf_eval`) in f32 compute (`--compute_dtype
// float32`) at layer widths up to 512: the f32 frequency encode of xyz and
// dirs (cos as sin(x 2^k + pi/2), precise sinf), the ReLU trunk with the
// skip concat [enc | h], the sigma head with shifted softplus or ReLU, and
// with the branch trunk_final, dir_a over [final | dir enc | app] and the
// rgb head with a sigmoid. True f32: f32 weights and activations, FFMA
// products, f32 sums (no TF32, no bf16 tensor-core product), as the JAX
// package computes it in f32. Output (M, 4) f32 [r, g, b, sigma].
//
// What bounds it on an H100: ~1.21 MFLOP per point at the paper width
// against ~190 B of inputs and outputs, so the f32 FMA pipes: the fg-fine
// launch of one 16,384-ray chunk (8,388,608 points) is ~152 ms at 67 TFLOP/s
// of f32 FFMA, its boundary bytes ~0.5 ms at 3.35 TB/s.
//
// Design (f32_chain.cuh, shared with the training forward of train_f32.cu,
// so the two agree bit for bit without noise): a CTA of 256 threads per
// tile of tm points (fused_f32.py::f32_fwd_plan: 64, or 32 where two
// 64-point activation tiles do not fit), every activation resident in
// shared memory as f32, two activation
// tiles in turn, the weights (transposed copies of the packed matrices,
// read along their rows) streamed from L2 in 16-row chunks through two
// shared buffers, a register tile of (tm / 8) points x 8 columns a thread.
// The weights are read once per tile (4 x ~0.6 M floats at the paper
// width), so the tile size sets the L2 traffic: ~32 FLOP per L2 byte at 64
// points. Left for later work (the redesign queue): 3xTF32 split products
// or wgmma, TMA weight boxes, persistent CTAs, the heads spread over more
// threads.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "f32_chain.cuh"

namespace {

using namespace f32chain;

template <int TP>
__global__ void __launch_bounds__(NT, 1) eval_f32_kernel(const __grid_constant__ FwdParams p) {
  extern __shared__ __align__(16) uint8_t smem[];
  forward_tile<TP>(p, smem);
}

template <int TP>
int launch(const FwdParams& p, int smem, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      eval_f32_kernel<TP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int grid = (p.M + p.tm - 1) / p.tm;
  eval_f32_kernel<TP><<<grid, NT, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// ptrs, dims: fused_mlp.py::launch_tables (xyz, dirs, app, out, w_sigma,
//   b_sigma, w_rgb, b_rgb, then (matrix, bias) per matmul layer; M, xyz_dim,
//   nf_xyz, nf_dir, layers, D, app_dim, skip_mask, has_branch,
//   shifted_softplus, EP, DP, AP).
// plan: tm, enc_off, dir_off, app_off, x_off, y_off, w_off, sig_off,
//   smem_bytes (fused_f32.py::f32_fwd_plan).
//   The matrix pointers are the transposed (Ktot, N) copies.
// shapes: (N, Ktot) per matmul layer.
// Returns 0 or a cudaError_t (eval_f32_error_string).
int eval_f32_launch(const long long* ptrs, const int* dims, const int* plan,
                    const int* shapes, void* stream) {
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
  const int nmat = p.layers + (p.has_branch ? 2 : 0);
  if (nmat > MAX_MATS || (p.tm != 64 && p.tm != 32) || p.xyz_dim > 4 || p.D % 16)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < nmat; ++i) {
    p.w[i] = reinterpret_cast<const float*>(ptrs[8 + 2 * i]);
    p.bias[i] = reinterpret_cast<const float*>(ptrs[9 + 2 * i]);
    p.kt[i] = shapes[2 * i + 1];
  }
  if (p.M <= 0) return 0;
  cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
  return p.tm == 64 ? launch<8>(p, smem, s) : launch<4>(p, smem, s);
}

const char* eval_f32_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
