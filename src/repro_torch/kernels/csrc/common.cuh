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

// 2^x, one MUFU.EX2 (below 2^-126 flushed to 0; -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLog2e = 1.4426950408889634f;  // exp(x) = exp2(x * kLog2e)

// A sum over the 32 lanes of a warp, every lane taking part. Each stage
// adds the same two values on both lanes of a pair, so every lane ends
// with the same bits, in an order fixed run after run.
__device__ __forceinline__ float warp_sum(float x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// A thread-block cluster's barrier in two halves: arrive (this CTA's
// earlier shared-memory writes released to the cluster), then wait (every
// CTA of the cluster arrived; their writes visible). Every thread of every
// CTA of the cluster calls both, in turn.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// Logit softcap, as the reference's _sdpa: c tanh(s / c) on the score s
// already scaled by 1/sqrt(hd); c <= 0 is off.
__device__ __forceinline__ float softcap(float s, float c) {
  return c > 0.f ? c * tanhf(s / c) : s;
}

// A score in log2 units from its dot product: dot * scale_log2 (= log2(e) /
// sqrt(hd)) without a cap, log2(e) c tanh(dot / sqrt(hd) / c) with one.
__device__ __forceinline__ float score_log2(float dot, float scale_log2, float c) {
  return c > 0.f ? softcap(dot * (scale_log2 / kLog2e), c) * kLog2e : dot * scale_log2;
}

}  // namespace rt
