// Paged decode attention for Hopper.
//
// Replaces: src/repro/kernels/paged_attention.py :: _paged_kernel (the
// pallas_call in paged_attention). One query token per sequence attends
// over its KV pages: q [B,H,hd], k/v pages [P,KV,page,hd], block_tables
// [B,pps] int32, seq_lens [B] int32 -> out [B,H,hd]. Online softmax over
// pages in f32, scale 1/sqrt(hd), positions >= seq_len masked with -1e30,
// pages with p*page >= seq_len skipped, out = acc / max(l, 1e-30); a
// sequence of length 0 gives zeros. GQA is r-major: query head h reads KV
// head h % KV.
//
// What bounds it: device-memory bytes. Decode reads every live K and V
// element once for one query token per head, about 2 FLOP per byte, far
// below the card's ~295 FLOP/byte balance point in bf16.
// Design: one block per (KV head, sequence) serves all H/KV query heads of
// that KV head, so each page is read from device memory once (the Pallas
// grid (B,H,pps) reads it once per query head). The block loads its own
// block-table row and seq_len (no scalar prefetch), stages one K and one V
// page at a time in shared memory as f32 (K rows padded to hd+1 so the
// score loop is free of bank conflicts), and keeps m and l in shared memory
// and acc in registers. At B=8, KV=4 that is 32 blocks on 132 SMs: the next
// step is a split-K pass over pages.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxAcc = 16;  // rep*hd <= kThreads * kMaxAcc

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
             const T* __restrict__ v_pages, const int* __restrict__ block_tables,
             const int* __restrict__ seq_lens, T* __restrict__ out, int H, int KV,
             int page, int hd, int pps, float scale) {
  extern __shared__ float smem[];
  const int rep = H / KV;
  const int hdp = hd + 1;
  float* q_s = smem;                  // [rep][hd]
  float* k_s = q_s + rep * hd;        // [page][hd+1]
  float* v_s = k_s + page * hdp;      // [page][hd]
  float* p_s = v_s + page * hd;       // [rep][page]
  float* m_s = p_s + rep * page;      // [rep]
  float* l_s = m_s + rep;             // [rep]
  float* c_s = l_s + rep;             // [rep]

  const int g = blockIdx.x, b = blockIdx.y, tid = threadIdx.x;
  const int seq_len = seq_lens[b];
  const int n_pages = seq_len > 0 ? min((seq_len + page - 1) / page, pps) : 0;
  const int n_out = rep * hd;

  for (int e = tid; e < n_out; e += kThreads) {
    const int r = e / hd, d = e % hd;
    q_s[e] = rt::to_f(q[(static_cast<int64_t>(b) * H + r * KV + g) * hd + d]);
  }
  for (int r = tid; r < rep; r += kThreads) {
    m_s[r] = rt::kNegInf;
    l_s[r] = 0.f;
  }
  float acc[kMaxAcc];
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) acc[i] = 0.f;

  for (int p = 0; p < n_pages; ++p) {
    const int64_t pid = block_tables[static_cast<int64_t>(b) * pps + p];
    const int64_t base = (pid * KV + g) * static_cast<int64_t>(page) * hd;
    for (int e = tid; e < page * hd; e += kThreads) {
      const int t = e / hd, d = e % hd;
      k_s[t * hdp + d] = rt::to_f(k_pages[base + e]);
      v_s[e] = rt::to_f(v_pages[base + e]);
    }
    __syncthreads();
    // scores s[r][t], masked past seq_len
    for (int e = tid; e < rep * page; e += kThreads) {
      const int r = e / page, t = e % page;
      float dot = 0.f;
      for (int d = 0; d < hd; ++d) dot += q_s[r * hd + d] * k_s[t * hdp + d];
      p_s[e] = (p * page + t < seq_len) ? dot * scale : rt::kNegInf;
    }
    __syncthreads();
    // online softmax, one thread per query head
    for (int r = tid; r < rep; r += kThreads) {
      const float m_prev = m_s[r];
      float mx = rt::kNegInf;
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, p_s[r * page + t]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int t = 0; t < page; ++t) {
        const float pr = (p * page + t < seq_len) ? expf(p_s[r * page + t] - m_new) : 0.f;
        p_s[r * page + t] = pr;
        sum += pr;
      }
      const float corr = expf(m_prev - m_new);
      l_s[r] = l_s[r] * corr + sum;
      m_s[r] = m_new;
      c_s[r] = corr;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kMaxAcc; ++i) {
      const int e = tid + i * kThreads;
      if (e < n_out) {
        const int r = e / hd, d = e % hd;
        float a = acc[i] * c_s[r];
        for (int t = 0; t < page; ++t) a += p_s[r * page + t] * v_s[t * hd + d];
        acc[i] = a;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < kMaxAcc; ++i) {
    const int e = tid + i * kThreads;
    if (e < n_out) {
      const int r = e / hd, d = e % hd;
      out[(static_cast<int64_t>(b) * H + r * KV + g) * hd + d] =
          rt::from_f<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
    }
  }
}

template <typename T>
int launch(const void* q, const void* kp, const void* vp, const void* bt,
           const void* sl, void* out, int B, int H, int KV, int page, int hd,
           int pps, cudaStream_t stream) {
  const int rep = H / KV;
  const size_t smem = sizeof(float) *
      (rep * hd + page * (hd + 1) + page * hd + rep * page + 3 * rep);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(KV, B);
  paged_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(bt), static_cast<const int*>(sl), static_cast<T*>(out),
      H, KV, page, hd, pps, 1.0f / sqrtf(static_cast<float>(hd)));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const void* block_tables,
                                  const void* seq_lens, void* out, int B, int H,
                                  int KV, int page, int hd, int pps, int dtype,
                                  void* stream) {
  if (B <= 0 || KV <= 0 || H % KV != 0 || (H / KV) * hd > kThreads * kMaxAcc)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return launch<float>(q, k_pages, v_pages, block_tables, seq_lens, out, B, H,
                         KV, page, hd, pps, s);
  if (dtype == rt::kBF16)
    return launch<__nv_bfloat16>(q, k_pages, v_pages, block_tables, seq_lens, out,
                                 B, H, KV, page, hd, pps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rt_paged_attention_max_rep_hd() { return kThreads * kMaxAcc; }
