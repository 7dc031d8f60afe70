// Fused NeRF eval MLP in f32 compute for Hopper (sm_90a), written by hand.
//
// Replaces the TPU kernel `mega_nerf_tpu/render/pallas_mlp.py::_mlp_kernel`
// (reached through `fused_nerf_eval`) in f32 compute (`--compute_dtype
// float32`) at layer widths up to 512: the f32 frequency encode of xyz and
// dirs (cos as sin(x 2^k + pi/2), precise sinf), the ReLU trunk with the
// skip concat [enc | h], the sigma head with shifted softplus or ReLU, and
// with the branch trunk_final, dir_a over [final | dir enc | app] and the
// rgb head with a sigmoid. f32 accuracy: f32 weights and activations, the
// layer products as 3xTF32 split products on the tensor cores (within
// ~2^-21 of each f32 product; no one-pass TF32, no bf16 product), f32 sums,
// as the JAX package computes it in f32. Output (M, 4) f32 [r, g, b, sigma].
//
// What bounds it on an H100: ~1.21 MFLOP per point at the paper width
// against ~190 B of inputs and outputs, so the tensor cores: the fg-fine
// launch of one 16,384-ray chunk (8,388,608 points) is 10.16 TFLOP of TF32
// products (three a multiply-add), ~61.6 ms at 495 TFLOP/s (~152 ms of f32
// FFMA at 67 TFLOP/s, the chain this replaced); its boundary bytes ~0.5 ms
// at 3.35 TB/s. The weights and their rests are read from L2 once per
// 64-point tile (~4.9 MB at the paper width: ~640 GB over that launch,
// ~29 ms at the ~22 TB/s the card's L2 gives when every SM reads the same
// weights), the design's own traffic.
//
// Design: f32_forward.cuh, shared with the training forward of
// train_f32.cu, so that the two agree bit for bit without noise (warp-
// specialised CTAs of 384 threads: a TMA ring of W boxes and of their TF32
// rests, two consumer warpgroups on wgmma m64n64k8 over activations
// resident in shared memory). Where the time goes, and the designs tried
// beside it, is scripts/f32_fwd_probe.py's to measure: the products run at
// ~70% of the card's TF32 rate, the encode, heads and epilogues take ~20%
// of a CTA with the tensor cores idle.

#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>

#include "f32_forward.cuh"

namespace {

using namespace f32fwd;

__global__ void __launch_bounds__(NT, 1)
eval_f32_kernel(const __grid_constant__ FwdMaps maps, const __grid_constant__ FwdParams p) {
  forward_tile(maps, p);
}

}  // namespace

extern "C" {

// ptrs, dims: fused_mlp.py::launch_tables (xyz, dirs, app, out, w_sigma,
//   b_sigma, w_rgb, b_rgb, then (matrix, bias) per matmul layer, the packed
//   (N, Ktot) matrices; M, xyz_dim, nf_xyz, nf_dir, layers, D, app_dim,
//   skip_mask, has_branch, shifted_softplus, EP, DP, AP).
// plan: tm, stages, ring, x, y, enc, dir, app and barrier offsets,
//   smem_bytes (fused_f32.py::f32_fwd_plan).
// shapes: (N, Ktot) per matmul layer.
// rests: per matmul layer, its TF32 rests (N, Ktot) (fused_f32.py::w_rests).
// Returns 0, a cudaError_t or a tensor-map failure (eval_f32_error_string).
int eval_f32_launch(const long long* ptrs, const int* dims, const int* plan,
                    const int* shapes, const long long* rests, void* stream) {
  FwdParams p;
  FwdMaps maps;
  int smem = 0;
  const int err = fwd_setup(ptrs, dims, plan, shapes, rests, p, maps, smem);
  if (err || p.M <= 0) return err;
  return fwd_launch(eval_f32_kernel, maps, p, smem, reinterpret_cast<cudaStream_t>(stream));
}

const char* eval_f32_error_string(int code) { return fwd_error_string(code); }

}  // extern "C"
