// Shared helpers for the port's CUDA kernels (plain C interface, bound
// with ctypes from repro_torch/kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace rt {

// Element types a kernel accepts: 0 = float32, 1 = bfloat16 (the wrapper
// passes the code; compute is always f32).
enum DType : int { kF32 = 0, kBF16 = 1 };

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

constexpr float kNegInf = -1e30f;  // the Pallas kernels' mask value

}  // namespace rt
