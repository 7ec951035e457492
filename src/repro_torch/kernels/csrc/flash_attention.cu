// Flash attention (forward) for Hopper: causal or not, optional sliding
// window, GQA.
//
// Replaces: src/repro/kernels/flash_attention.py :: _flash_kernel (the
// pallas_call in flash_attention). q [B,H,S,hd], k/v [B,KV,T,hd] ->
// out [B,H,S,hd]; f32 online softmax, scale 1/sqrt(hd), masked scores
// -1e30 and masked probabilities 0, out = acc / max(l, 1e-30). GQA is
// r-major: query head h reads KV head h % KV (as the Pallas code does; its
// docstring's h // (H/KV) is wrong). Tiles wholly past the causal diagonal
// or the window are skipped with the Pallas kernel's own conditions.
//
// What bounds it: at prefill lengths (S = T in the hundreds, hd = 128) the
// products QK^T and PV, about 4*S*T*hd FLOP per head (halved by the causal
// mask) against 2 bytes per element moved: well above the card's balance
// point, so operations bound it. This first version runs them as f32 FMAs
// on the CUDA cores, not on the tensor cores; wgmma, TMA and a pipelined
// K/V ring are the later work.
// Design: one block per (q tile of 64 rows, head, batch) loops over K/V
// tiles of 64 rows staged in shared memory as f32, rows padded to hd+1 so
// the 16x16 thread grid reads them without bank conflicts. Each thread
// owns a 4x4 block of the score tile and a 4 x hd/16 block of the output
// accumulator in registers. Ragged S and T are masked in the kernel (rows
// past the end load as 0 and are never stored): nothing is padded in
// device memory. Inputs are addressed through strides (hd contiguous), so
// the model's [B,S,H,hd] tensors are read and written in place.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kBQ = 64, kBK = 64, kThreads = 256, kMaxHd = 128;
constexpr int kDPer = kMaxHd / 16;  // output columns per thread

struct Strides {
  int64_t b, h, s;
};

__device__ __forceinline__ bool visible(int qp, int kp, int S, int T, bool causal,
                                        int window) {
  bool ok = qp < S && kp < T;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && (qp - kp < window);
  return ok;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int H,
             int KV, int S, int Tn, int hd, bool causal, int window, float scale) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* q_s = smem;                 // [kBQ][hd+1]
  float* k_s = q_s + kBQ * hdp;      // [kBK][hd+1]
  float* v_s = k_s + kBK * hdp;      // [kBK][hd]
  float* s_s = v_s + kBK * hd;       // [kBQ][kBK+1]
  float* m_s = s_s + kBQ * (kBK + 1);
  float* l_s = m_s + kBQ;
  float* c_s = l_s + kBQ;

  const int iq = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h % KV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = iq * kBQ;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + g * ks.h;
  const T* vb = v + b * vs.b + g * vs.h;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    q_s[i * hdp + d] = (q0 + i < S) ? rt::to_f(qb[(q0 + i) * qs.s + d]) : 0.f;
  }
  for (int i = tid; i < kBQ; i += kThreads) {
    m_s[i] = rt::kNegInf;
    l_s[i] = 0.f;
  }
  float acc[4][kDPer];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < kDPer; ++c) acc[a][c] = 0.f;

  const int nk = (Tn + kBK - 1) / kBK;
  for (int ik = 0; ik < nk; ++ik) {
    const int k0 = ik * kBK;
    if (causal && k0 > q0 + kBQ - 1) break;                    // past the diagonal
    if (window > 0 && q0 - (k0 + kBK - 1) >= window) continue;  // behind the window
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < kBK * hd; e += kThreads) {
      const int j = e / hd, d = e % hd;
      const bool in = k0 + j < Tn;
      k_s[j * hdp + d] = in ? rt::to_f(kb[(k0 + j) * ks.s + d]) : 0.f;
      v_s[j * hd + d] = in ? rt::to_f(vb[(k0 + j) * vs.s + d]) : 0.f;
    }
    __syncthreads();
    // scores: thread (ty, tx) owns rows ty+16a and columns tx+16c
    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = q_s[(ty + 16 * a) * hdp + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = k_s[(tx + 16 * c) * hdp + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] += qv[a] * kv[c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty + 16 * a, j = tx + 16 * c;
        s_s[i * (kBK + 1) + j] =
            visible(q0 + i, k0 + j, S, Tn, causal, window) ? sc[a][c] * scale : rt::kNegInf;
      }
    __syncthreads();
    // online softmax, one thread per query row
    for (int i = tid; i < kBQ; i += kThreads) {
      float* row = s_s + i * (kBK + 1);
      const float m_prev = m_s[i];
      float mx = rt::kNegInf;
      for (int j = 0; j < kBK; ++j) mx = fmaxf(mx, row[j]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < kBK; ++j) {
        const float p = visible(q0 + i, k0 + j, S, Tn, causal, window)
                            ? expf(row[j] - m_new) : 0.f;
        row[j] = p;
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      l_s[i] = l_s[i] * corr + sum;
      m_s[i] = m_new;
      c_s[i] = corr;
    }
    __syncthreads();
    // acc = acc * corr + P V
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float corr = c_s[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < kDPer; ++c) acc[a][c] *= corr;
    }
    for (int j = 0; j < kBK; ++j) {
      float pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = s_s[(ty + 16 * a) * (kBK + 1) + j];
#pragma unroll
      for (int c = 0; c < kDPer; ++c) {
        const int d = tx + 16 * c;
        if (d < hd) {
          const float vv = v_s[j * hd + d];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][c] += pv[a] * vv;
        }
      }
    }
  }
  __syncthreads();
  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    if (q0 + i >= S) continue;
    const float inv = 1.f / fmaxf(l_s[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDPer; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) ob[(q0 + i) * os.s + d] = rt::from_f<T>(acc[a][c] * inv);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, const int64_t* st,
           int B, int H, int KV, int S, int Tn, int hd, bool causal, int window,
           cudaStream_t stream) {
  const int hdp = hd + 1;
  const size_t smem =
      sizeof(float) * (kBQ * hdp + kBK * hdp + kBK * hd + kBQ * (kBK + 1) + 3 * kBQ);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides qs{st[0], st[1], st[2]}, ks{st[3], st[4], st[5]},
      vs{st[6], st[7], st[8]}, os{st[9], st[10], st[11]};
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), qs, ks, vs, os, H, KV, S, Tn, hd, causal, window,
      1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64 (batch, head, seq) strides of q, k, v, out, in
// elements; the head_dim stride is 1 for all four.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  const void* strides, int B, int H, int KV, int S, int T,
                                  int hd, int causal, int window, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* st = static_cast<const int64_t*>(strides);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return launch<float>(q, k, v, out, st, B, H, KV, S, T, hd, causal != 0, window, s);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(q, k, v, out, st, B, H, KV, S, T, hd, causal != 0,
                                 window, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rt_flash_attention_max_hd() { return kMaxHd; }
