// Helpers shared by the hand-written attention kernels (flash_fwd.cu,
// flash_decode.cu).  Each .cu file is compiled on its own into a shared
// library with a plain C interface; see repro_torch/kernels/build.py.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace repro {

// Masked logits: the running max starts at NEG_INF (-1e30, as on the TPU),
// while a masked entry inside a tile holds -INFINITY.  exp(-inf - m) is then
// exactly 0 for every running max m >= -1e30, so a row with no live key yet
// keeps m = -1e30, l = 0 and never meets exp(-inf - -inf) = NaN.
constexpr float NEG_INF = -1e30f;
#define MASKED (-CUDART_INF_F)

// dtype codes passed from Python
constexpr int DTYPE_F32 = 0;
constexpr int DTYPE_BF16 = 1;

template <typename T> __device__ __forceinline__ float to_f32(T x);
template <> __device__ __forceinline__ float to_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float apply_softcap(float s, float softcap) {
  return softcap > 0.f ? softcap * tanhf(s / softcap) : s;
}

}  // namespace repro
