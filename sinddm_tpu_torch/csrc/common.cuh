// Type conversions shared by the port's kernels: loads widen to fp32,
// stores round to the tensor's type (fp32, or bf16 round-to-nearest-even).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace sinddm {

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

}  // namespace sinddm
