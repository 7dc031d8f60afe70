// The f32 frequency encode that every f32 kernel shares: `encode_coord`
// (f32_forward.cuh, the tensor-core forward of eval_f32.cu and
// train_f32.cu) and `encode_value` (wide_f32.cu's encode), one arithmetic,
// so that the narrow and wide f32 routes encode alike.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace f32chain {

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
