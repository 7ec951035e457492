// The stabilised gates shared by the mLSTM and sLSTM recurrences
// (mlstm_scan.cu, slstm_scan.cu), forward and backward, with the plain
// version's arithmetic (kernels/ref.py: _gates, _gates_at, _gates_bwd).
#pragma once

#include "common.cuh"

namespace rt {

struct Gates {
  float m, i, f;  // the new stabiliser, i_s, f_s
};

// i_s = exp(log_i - m_new); f_s = 0 after m = -inf, else exp(log_f + m -
// m_new). The backward passes the saved m_new: the same bits.
__device__ __forceinline__ Gates gates_at(float li, float lf, float m, float mn) {
  return {mn, expf(li - mn), isinf(m) ? 0.f : expf((lf + m) - mn)};
}

// m_new = max(log_f + m, log_i), log_i where that is infinite (the first
// step, m = -inf), and its gates.
__device__ __forceinline__ Gates gates(float li, float lf, float m) {
  float mn = fmaxf(lf + m, li);
  if (isinf(mn)) mn = li;
  return gates_at(li, lf, m, mn);
}

// d max(a, b) / da as autograd takes it: 1 where a wins, 1/2 on a tie.
__device__ __forceinline__ float tie(float a, float b) {
  return a > b ? 1.f : (a == b ? 0.5f : 0.f);
}

// One step of the stabiliser chain backwards, from the products of the
// gradients of the step's i_s and f_s with the gates, di i_s and df f_s
// (dii, dff: the chunkwise mLSTM backward forms these, never dividing by a
// gate; the sLSTM's multiplies by gates it formed a step ahead), and the
// gradient of its m_new (dm, every other use of it already summed in). Out:
// the gradients of log_i and log_f, and the return value, that of the
// previous m (ref.py's _gates_bwd, from di and df).
__device__ __forceinline__ float gates_bwd_scaled(float li, float lf, float m, float dii,
                                                  float dff, float dm, float& dli, float& dlf) {
  const float a = lf + m;
  const float mt = fmaxf(a, li);
  dff = isinf(m) ? 0.f : dff;
  dm = dm - dii - dff;
  const bool first = isinf(mt);
  const float dmt = first ? 0.f : dm;
  const float wa = tie(a, li);
  const float da = dmt * wa;
  dli = dii + (first ? dm : 0.f) + dmt * (1.f - wa);
  dlf = dff + da;
  return dff + da;
}

// log(sigmoid(x)) and its derivative sigmoid(-x), as PyTorch's CUDA
// log_sigmoid forward and backward compute them.
__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}
__device__ __forceinline__ float log_sigmoid_grad(float x) {
  const float z = expf(-fabsf(x));
  return x < 0.f ? 1.f - z / (1.f + z) : z / (1.f + z);
}

__device__ __forceinline__ float sigmoid(float x) { return 1.f / (1.f + expf(-x)); }

}  // namespace rt
