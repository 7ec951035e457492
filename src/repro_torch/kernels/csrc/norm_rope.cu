// The paged block's elementwise chain as two kernels: RMSNorm (with the
// residual add before it folded in) and RoPE on q and k with the page write
// of k and v.
//
// Replaces no TPU kernel: the JAX package's paged block
// (src/repro/serving/paged_model.py :: _paged_block) leaves rms_norm,
// apply_rope and the page scatter to XLA, which fuses each chain into one
// loop on the device. The port ran them as ~58 PyTorch ops a dense layer
// (a norm 8-9, a RoPE ~16, the scatter 8-10), each a launch the host issues
// and most of them a float32 tensor written to device memory and read back.
//
// rms_norm: x [T, D] (and, with a residual r [T, D], first s = x + r rounded
// to x's dtype, written out as the new residual stream), y = x * rsqrt(mean(
// x^2) + eps) * scale in float32, rounded once, as models/layers.py ::
// rms_norm. A CTA a row, the row in registers (16-byte loads; NV vectors a
// thread), one block-wide sum. Bound: bytes, 2 (3 with r) rows in and 1 (2)
// out.
//
// rope_write: q [B,S,H,hd], k, v [B,S,KV,hd] (the projections), positions
// [B,S] int32, inv_freq [hd/2] f32 (models/layers.py :: rope_freqs, built
// once a forward by the caller), block_tables [B,pps] int32 -> q_out, k_out
// (RoPE'd, the inputs' dtype) and k_pages, v_pages [P,KV,pg,hd] (of that
// dtype too) written at (block_tables[b, pos / pg], :, pos % pg): the RoPE'd
// k and v. Idle lanes (block table rows of page 0) write the scratch
// page, as the plain scatter does. A CTA a token: its hd/2 angles pos *
// inv_freq, their sinf and cosf (accurate: positions reach the thousands)
// in shared memory, then every head's rotation, 16-byte vectors of the two
// halves a thread. Bound: bytes, q, k, v in, q, k out and k, v to the pages.
//
// Rounding is the plain chain's, where it rounds: every product and sum is
// its own IEEE operation (__fmul_rn, __fadd_rn: no FMA contraction), float32
// throughout, one rounding to the output dtype. The norm's sum of squares
// is taken in another order than PyTorch's reduction.
#include "common.cuh"

namespace {

// V elements in one load or store (16 bytes at most).
template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T e[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

template <typename T, int V>
__device__ __forceinline__ void store(T* p, const Vec<T, V>& v) {
  *reinterpret_cast<Vec<T, V>*>(p) = v;
}

constexpr int kNormThreads = 256;
constexpr int kMaxNV = 8;  // vectors a thread: D <= 256 x 8 x V
constexpr int kRopeThreads = 128;
constexpr int kMaxHd = 512;  // the angles' shared memory: 2 x 256 floats

// The sum of x over the CTA; every thread gets the same bits (the warps'
// partials summed in warp order).
__device__ __forceinline__ float block_sum(float x) {
  __shared__ float part[kNormThreads / 32];
  x = rt::warp_sum(x);
  const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = x;
  __syncthreads();
  float s = 0.f;
  for (int w = 0; w < nw; ++w) s += part[w];
  return s;
}

template <typename T, int V, int NV, bool RES>
__global__ void __launch_bounds__(kNormThreads)
rms_norm_kernel(const T* __restrict__ x, const T* __restrict__ r, const T* __restrict__ scale,
                T* __restrict__ sum_out, T* __restrict__ y, int D, float inv_d, float eps) {
  const size_t row = static_cast<size_t>(blockIdx.x) * D;
  const int nvec = D / V;
  float v[NV][V];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
#pragma unroll
    for (int j = 0; j < V; ++j) v[i][j] = 0.f;
    if (c < nvec) {
      Vec<T, V> a = load<T, V>(x + row + c * V);
      if constexpr (RES) {  // the residual stream, rounded as the unfused add rounds
        const Vec<T, V> b = load<T, V>(r + row + c * V);
#pragma unroll
        for (int j = 0; j < V; ++j)
          a.e[j] = rt::from_f<T>(__fadd_rn(rt::to_f(a.e[j]), rt::to_f(b.e[j])));
        store<T, V>(sum_out + row + c * V, a);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        v[i][j] = rt::to_f(a.e[j]);
        ss += v[i][j] * v[i][j];
      }
    }
  }
  const float rs = rsqrtf(__fadd_rn(__fmul_rn(block_sum(ss), inv_d), eps));
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nvec) {
      const Vec<T, V> sc = load<T, V>(scale + c * V);
      Vec<T, V> o;
#pragma unroll
      for (int j = 0; j < V; ++j)
        o.e[j] = rt::from_f<T>(__fmul_rn(__fmul_rn(v[i][j], rs), rt::to_f(sc.e[j])));
      store<T, V>(y + row + c * V, o);
    }
  }
}

template <typename T, int V, int NV>
int launch_norm_nv(const void* x, const void* r, const void* scale, void* sum_out, void* y,
                   int rows, int D, int threads, float eps, cudaStream_t s) {
  const float inv_d = 1.f / static_cast<float>(D);
  auto* xp = static_cast<const T*>(x);
  auto* sp = static_cast<const T*>(scale);
  auto* yp = static_cast<T*>(y);
  if (r)
    rms_norm_kernel<T, V, NV, true><<<rows, threads, 0, s>>>(
        xp, static_cast<const T*>(r), sp, static_cast<T*>(sum_out), yp, D, inv_d, eps);
  else
    rms_norm_kernel<T, V, NV, false><<<rows, threads, 0, s>>>(xp, nullptr, sp, nullptr, yp, D,
                                                              inv_d, eps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int V>
int launch_norm(const void* x, const void* r, const void* scale, void* sum_out, void* y,
                int rows, int D, float eps, cudaStream_t s) {
  const int nvec = D / V;
  const int threads = nvec >= kNormThreads ? kNormThreads : (nvec + 31) / 32 * 32;
  const int nv = (nvec + threads - 1) / threads;
  switch (nv) {
    case 1: return launch_norm_nv<T, V, 1>(x, r, scale, sum_out, y, rows, D, threads, eps, s);
    case 2: return launch_norm_nv<T, V, 2>(x, r, scale, sum_out, y, rows, D, threads, eps, s);
    case 3:
    case 4: return launch_norm_nv<T, V, 4>(x, r, scale, sum_out, y, rows, D, threads, eps, s);
    default:
      return nv <= kMaxNV ? launch_norm_nv<T, V, kMaxNV>(x, r, scale, sum_out, y, rows, D,
                                                          threads, eps, s)
                          : static_cast<int>(cudaErrorInvalidValue);
  }
}

template <typename T>
int norm_for(const void* x, const void* r, const void* scale, void* sum_out, void* y, int rows,
             int D, int vec, float eps, cudaStream_t s) {
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_norm<T, 8>(x, r, scale, sum_out, y, rows, D, eps, s);
      break;
    case 4: return launch_norm<T, 4>(x, r, scale, sum_out, y, rows, D, eps, s);
    case 2: return launch_norm<T, 2>(x, r, scale, sum_out, y, rows, D, eps, s);
    case 1: return launch_norm<T, 1>(x, r, scale, sum_out, y, rows, D, eps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// a[j] cos - b[j] sin and b[j] cos + a[j] sin, each operation rounded on its
// own, into dst and, where page is not null, the page's slot too
template <typename T, int V>
__device__ __forceinline__ void rotate(const T* src, T* dst, T* page, const float* cs,
                                       const float* sn, int half) {
  const Vec<T, V> a = load<T, V>(src), b = load<T, V>(src + half);
  Vec<T, V> o1, o2;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    const float x1 = rt::to_f(a.e[j]), x2 = rt::to_f(b.e[j]);
    o1.e[j] = rt::from_f<T>(__fsub_rn(__fmul_rn(x1, cs[j]), __fmul_rn(x2, sn[j])));
    o2.e[j] = rt::from_f<T>(__fadd_rn(__fmul_rn(x2, cs[j]), __fmul_rn(x1, sn[j])));
  }
  store<T, V>(dst, o1);
  store<T, V>(dst + half, o2);
  if (page == nullptr) return;
  store<T, V>(page, o1);
  store<T, V>(page + half, o2);
}

template <typename T, int V>
__global__ void __launch_bounds__(kRopeThreads)
rope_write_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const int* __restrict__ positions, const float* __restrict__ inv_freq,
                  const int* __restrict__ block_tables, T* __restrict__ q_out,
                  T* __restrict__ k_out, T* __restrict__ k_pages, T* __restrict__ v_pages, int S,
                  int H, int KV, int hd, int pg, int pps) {
  __shared__ float angles[kMaxHd];  // cos [0, hd/2), sin [hd/2, hd)
  const int tok = blockIdx.x, b = tok / S, half = hd / 2;
  const int pos = positions[tok];
  for (int i = threadIdx.x; i < half; i += blockDim.x) {
    const float a = __fmul_rn(static_cast<float>(pos), inv_freq[i]);
    angles[i] = cosf(a);
    angles[half + i] = sinf(a);
  }
  const int lp = pos / pg;  // a page past the table is not written (the plain scatter raises)
  const long page = (pos >= 0 && lp < pps) ? block_tables[static_cast<long>(b) * pps + lp] : -1;
  const size_t slot_off = page < 0 ? 0 : static_cast<size_t>(page) * KV * pg + pos % pg;
  __syncthreads();
  const int cph = half / V;  // vectors a half head
  for (int w = threadIdx.x; w < (H + KV) * cph; w += blockDim.x) {
    const int head = w / cph, c = (w - head * cph) * V;
    if (head < H) {
      const size_t off = (static_cast<size_t>(tok) * H + head) * hd + c;
      rotate<T, V>(q + off, q_out + off, nullptr, angles + c, angles + half + c, half);
    } else {
      const int h = head - H;
      const size_t off = (static_cast<size_t>(tok) * KV + h) * hd + c;
      T* dst = page < 0 ? nullptr : k_pages + (slot_off + static_cast<size_t>(h) * pg) * hd + c;
      rotate<T, V>(k + off, k_out + off, dst, angles + c, angles + half + c, half);
    }
  }
  if (page < 0) return;
  const int cpr = hd / V;  // vectors a whole head
  for (int w = threadIdx.x; w < KV * cpr; w += blockDim.x) {
    const int h = w / cpr, c = (w - h * cpr) * V;
    store<T, V>(v_pages + (slot_off + static_cast<size_t>(h) * pg) * hd + c,
                load<T, V>(v + (static_cast<size_t>(tok) * KV + h) * hd + c));
  }
}

template <typename T, int V>
int launch_rope(const void* q, const void* k, const void* v, const void* positions,
                const void* inv_freq, const void* block_tables, void* q_out, void* k_out,
                void* k_pages, void* v_pages, int tokens, int S, int H, int KV, int hd, int pg,
                int pps, cudaStream_t s) {
  rope_write_kernel<T, V><<<tokens, kRopeThreads, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(positions), static_cast<const float*>(inv_freq),
      static_cast<const int*>(block_tables), static_cast<T*>(q_out), static_cast<T*>(k_out),
      static_cast<T*>(k_pages), static_cast<T*>(v_pages), S, H, KV, hd, pg, pps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int rope_for(int vec, const void* q, const void* k, const void* v, const void* positions,
             const void* inv_freq, const void* block_tables, void* q_out, void* k_out,
             void* k_pages, void* v_pages, int tokens, int S, int H, int KV, int hd, int pg,
             int pps, cudaStream_t s) {
  switch (vec) {
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_rope<T, 8>(q, k, v, positions, inv_freq, block_tables, q_out, k_out,
                                 k_pages, v_pages, tokens, S, H, KV, hd, pg, pps, s);
      break;
    case 4:
      return launch_rope<T, 4>(q, k, v, positions, inv_freq, block_tables, q_out, k_out,
                               k_pages, v_pages, tokens, S, H, KV, hd, pg, pps, s);
    case 2:
      return launch_rope<T, 2>(q, k, v, positions, inv_freq, block_tables, q_out, k_out,
                               k_pages, v_pages, tokens, S, H, KV, hd, pg, pps, s);
    case 1:
      return launch_rope<T, 1>(q, k, v, positions, inv_freq, block_tables, q_out, k_out,
                               k_pages, v_pages, tokens, S, H, KV, hd, pg, pps, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int rt_rms_norm_max_d() { return kNormThreads * kMaxNV; }  // in vectors of vec
extern "C" int rt_rope_write_max_hd() { return kMaxHd; }

// y [rows, D] = rms_norm(x) (with r non-null: s = x + r into sum_out first,
// then y = rms_norm(s)); scale [D]; x, r, scale, sum_out and y of one dtype,
// contiguous, 16-byte aligned where vec elements are 16 bytes. vec (1, 2,
// 4, or 8 in bfloat16) divides D; D / vec <= rt_rms_norm_max_d().
extern "C" int rt_rms_norm(const void* x, const void* r, const void* scale, void* sum_out,
                           void* y, int rows, int D, int vec, float eps, int dtype,
                           void* stream) {
  if (rows < 1 || D < 1 || vec < 1 || D % vec != 0 || (r == nullptr) != (sum_out == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16)
    return norm_for<__nv_bfloat16>(x, r, scale, sum_out, y, rows, D, vec, eps, st);
  if (dtype == rt::kF32) return norm_for<float>(x, r, scale, sum_out, y, rows, D, vec, eps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

// q_out, k_out = RoPE(q, k) at positions, and k_pages, v_pages written at
// each token's (block_tables[b, pos / pg], :, pos % pg); tokens = B x S.
// q, k, v, q_out, k_out and the pages [P,KV,pg,hd] contiguous, all in
// dtype; vec (elements a load) divides hd / 2.
extern "C" int rt_rope_write(const void* q, const void* k, const void* v, const void* positions,
                             const void* inv_freq, const void* block_tables, void* q_out,
                             void* k_out, void* k_pages, void* v_pages, int tokens, int S, int H,
                             int KV, int hd, int pg, int pps, int vec, int dtype,
                             void* stream) {
  if (tokens < 1 || S < 1 || H < 1 || KV < 1 || hd < 2 || hd % 2 != 0 || hd > kMaxHd ||
      pg < 1 || pps < 1 || vec < 1 || (hd / 2) % vec != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16)
    return rope_for<__nv_bfloat16>(vec, q, k, v, positions, inv_freq, block_tables, q_out,
                                   k_out, k_pages, v_pages, tokens, S, H, KV, hd, pg, pps, st);
  if (dtype == rt::kF32)
    return rope_for<float>(vec, q, k, v, positions, inv_freq, block_tables, q_out, k_out,
                           k_pages, v_pages, tokens, S, H, KV, hd, pg, pps, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
