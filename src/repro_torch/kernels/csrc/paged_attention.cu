// Paged decode attention for Hopper: split-K over pages plus a combine pass.
//
// Replaces: src/repro/kernels/paged_attention.py :: _paged_kernel (the
// pallas_call in paged_attention). One query token per sequence attends
// over its KV pages: q [B,H,hd], k/v pages [P,KV,page,hd], block_tables
// [B,pps] int32, seq_lens [B] int32 -> out [B,H,hd]. Softmax in f32, scale
// 1/sqrt(hd), positions >= seq_len masked (-1e30, probability 0), pages with
// p*page >= seq_len never read, out = acc / max(l, 1e-30); a sequence of
// length 0 gives zeros. GQA is r-major: query head h reads KV head h % KV.
//
// What bounds it: device-memory bytes. Decode reads every live K and V
// element once for one query token per head, about 2 FLOP per byte, far
// below the card's ~295 FLOP/byte balance point in bf16. At B=8, 1,024
// tokens, that is 16.9 MB, 5.05 us at 3.35 TB/s: the card needs hundreds of
// KB in flight, so the work has to be spread over every SM.
// Design: the grid is (KV head, sequence, split). A split is 64 consecutive
// token positions, whatever the page size: token t of a sequence lies in
// page block_tables[t / page] at slot t % page, so a split may cover several
// small pages (4 of 16), part of one (a page of 128 is two splits), or a
// page boundary inside it (pages of 24 or 48). The split count is
// cdiv(pps * page, 64), from the table's width and never from seq_lens (the
// decode path reads nothing back to the host). A CTA
// serves all H/KV query heads of its KV head, so each page is read once,
// and issues 16-byte cp.async copies of all its live K and V rows at once
// (K and V in two commit groups: scores start while V is in flight). Each
// split writes (m, l, acc[rep, hd]) in f32 to scratch the wrapper
// allocates; a second launch combines the splits of each (sequence, head):
//   out = sum_i 2^(m_i - M) acc_i / max(sum_i 2^(m_i - M) l_i, 1e-30).
// A split with no live token writes m = -1e30, l = 0, acc = 0, which weighs
// 0 against any live split and gives zeros when all are empty. With one
// split the first launch writes the output itself. Softmax in exp2 with
// log2(e)/sqrt(hd) folded into the scale. With a softcap c > 0 a score s
// (already scaled by 1/sqrt(hd)) becomes c tanh(s / c) before the mask and
// the max, as the reference's _sdpa does.
//
// bfloat16 (paged_mma_kernel): both products on the tensor cores with
// mma.sync m16n8k16, the H/KV query heads padded to the 16 rows of the A
// tile. A per-phase clock64 trace on an H100 showed the CUDA-core version
// latency-bound in every phase (about 10 us a CTA for 64 tokens); here a
// warp scores its 8 tokens in hd/16 mma (K by ldmatrix from rows padded by
// 16 bytes, so the 8 rows of a matrix hit distinct banks), the softmax
// reduces over a quad by shuffles and across the 8 warps in shared memory,
// P goes to shared memory as bf16 and P.V runs a warp per 16 columns of hd
// (V by ldmatrix.trans). Rows past the live tokens are zeroed, since a 0
// probability times stale bits would be NaN.
//
// float32, and bfloat16 heads the mma tiles do not take (paged_scalar_kernel<T>:
// head_dim not a multiple of 16 or above 256, more than 16 query heads a KV
// head): the CUDA cores, with the K/V rows converted to f32 in shared memory
// (f32 rows by cp.async, bf16 rows by 8-byte loads). For f32 the tensor
// cores would need TF32, which misses the f32 tolerance (2e-5). A thread
// scores one (token, head) pair with 4 partial sums (a warp takes 32 tokens
// of one head, q reads broadcast, K rows padded), a thread per head runs the
// softmax, and a thread per output element sums P.V.
#include <cmath>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRepHd = kThreads * 16;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

constexpr int kVec = 4;  // floats in a 16-byte copy

// A split with no live token: (m, l, acc) = (-1e30, 0, 0), or zeros in the
// output when it is the only split. part indexes (b, head 0, split).
template <typename T>
__device__ __forceinline__ void write_empty_split(T* out, float* part_acc, float* part_ml,
                                                  int64_t part, int b, int g, int H, int KV,
                                                  int hd) {
  const int rep = H / KV, n_split = gridDim.z;
  for (int e = threadIdx.x; e < rep * hd; e += blockDim.x) {
    const int h = (e / hd) * KV + g, d = e % hd;
    if (n_split == 1)
      out[(static_cast<int64_t>(b) * H + h) * hd + d] = rt::from_f<T>(0.f);
    else
      part_acc[(part + static_cast<int64_t>(h) * n_split) * hd + d] = 0.f;
  }
  if (n_split > 1)
    for (int r = threadIdx.x; r < rep; r += blockDim.x) {
      const int64_t o = part + static_cast<int64_t>(r * KV + g) * n_split;
      part_ml[2 * o] = rt::kNegInf;
      part_ml[2 * o + 1] = 0.f;
    }
}

constexpr int kChunk = 64;  // token positions of a split

// four elements of a K/V row into f32 shared memory: one 16-byte cp.async
// for f32, an 8-byte load converted for bf16
__device__ __forceinline__ void load4(float* dst, const float* src) { cp_async16(dst, src); }
__device__ __forceinline__ void load4(float* dst, const __nv_bfloat16* src) {
  const uint2 raw = *reinterpret_cast<const uint2*>(src);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo), b = __bfloat1622float2(hi);
  *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.y, b.x, b.y);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_scalar_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages, const int* __restrict__ block_tables,
                    const int* __restrict__ seq_lens, T* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml, int H, int KV,
                    int page, int hd, int pps, float scale_log2, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rep = H / KV;
  const int kp = hd + kVec;      // padded K row
  float* k_s = reinterpret_cast<float*>(smem_raw);  // [kChunk][hd + kVec]
  float* v_s = k_s + kChunk * kp;                   // [kChunk][hd]
  float* q_s = v_s + kChunk * hd;                   // [rep][hd]
  float* s_s = q_s + rep * hd;                      // [rep][kChunk]
  float* m_s = s_s + rep * kChunk;                  // [rep]
  float* l_s = m_s + rep;                           // [rep]

  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid % 32;
  const int live = min(seq_lens[b], pps * page);      // tokens that exist
  const int t0 = split * kChunk;
  const int n_t = max(0, min(kChunk, live - t0));     // live tokens of this split
  const int64_t part = (static_cast<int64_t>(b) * H) * n_split + split;  // + h*n_split

  if (n_t == 0) {  // weight 0 in the combine; zeros when it is the only split
    write_empty_split(out, part_acc, part_ml, part, b, g, H, KV, hd);
    return;
  }

  // K, then V, of the live tokens, four elements a copy (two commit groups
  // on the f32 path); K rows padded by 16 bytes
  const int vpr = hd / kVec;
  const int* bt = block_tables + static_cast<int64_t>(b) * pps;
  for (int pass = 0; pass < 2; ++pass) {
    const T* src = pass == 0 ? k_pages : v_pages;
    float* dst = pass == 0 ? k_s : v_s;
    const int ld = pass == 0 ? kp : hd;
    for (int e = tid; e < n_t * vpr; e += kThreads) {
      const int t = e / vpr, c = e % vpr, tg = t0 + t;
      const int64_t pid = bt[tg / page];
      load4(dst + t * ld + c * kVec, src + ((pid * KV + g) * page + tg % page) * hd + c * kVec);
    }
    cp_async_commit();
  }
  for (int e = tid; e < rep * hd; e += kThreads)
    q_s[e] = rt::to_f(q[(static_cast<int64_t>(b) * H + (e / hd) * KV + g) * hd + e % hd]);
  cp_async_wait<1>();  // this thread's K copies landed
  __syncthreads();     // everyone's K copies and q_s visible

  // scores, in log2 units: a thread per (token, head), 4 partial sums; a
  // warp takes 32 tokens of one head, so its q reads are broadcasts and,
  // with the padded rows, its K reads hit distinct banks
  const int n_groups = (n_t + 31) / 32;
  for (int e = tid; e < n_groups * 32 * rep; e += kThreads) {
    const int w = e / 32, r = w % rep, t = (w / rep) * 32 + lane;
    if (t >= n_t) continue;
    const float* kr = k_s + t * kp;
    const float* qr = q_s + r * hd;
    float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int c = 0; c < hd; c += kVec) {
      const float4 k4 = *reinterpret_cast<const float4*>(kr + c);
      const float4 q4 = *reinterpret_cast<const float4*>(qr + c);
      acc.x += q4.x * k4.x;
      acc.y += q4.y * k4.y;
      acc.z += q4.z * k4.z;
      acc.w += q4.w * k4.w;
    }
    s_s[r * kChunk + t] = rt::score_log2(acc.x + acc.y + acc.z + acc.w, scale_log2, softcap);
  }
  __syncthreads();

  // the split's softmax, a thread per query head (every token here is live)
  for (int r = tid; r < rep; r += kThreads) {
    float* row = s_s + r * kChunk;
    float mx = rt::kNegInf;
#pragma unroll 8
    for (int t = 0; t < n_t; ++t) mx = fmaxf(mx, row[t]);
    float sum = 0.f;
#pragma unroll 8
    for (int t = 0; t < n_t; ++t) {
      const float p = exp2f(row[t] - mx);
      row[t] = p;
      sum += p;
    }
    m_s[r] = mx;
    l_s[r] = sum;
  }
  cp_async_wait<0>();  // V landed
  __syncthreads();

  // acc[r][d] = sum_t p[r][t] v[t][d], a thread per output
  for (int e = tid; e < rep * hd; e += kThreads) {
    const int r = e / hd, d = e % hd, h = r * KV + g;
    const float* pr = s_s + r * kChunk;
    float a = 0.f;
#pragma unroll 4
    for (int t = 0; t < n_t; ++t) a += pr[t] * v_s[t * hd + d];
    if (n_split == 1)
      out[(static_cast<int64_t>(b) * H + h) * hd + d] = rt::from_f<T>(a / fmaxf(l_s[r], 1e-30f));
    else
      part_acc[(part + static_cast<int64_t>(h) * n_split) * hd + d] = a;
  }
  if (n_split > 1)
    for (int r = tid; r < rep; r += kThreads) {
      const int64_t o = part + static_cast<int64_t>(r * KV + g) * n_split;
      part_ml[2 * o] = m_s[r];
      part_ml[2 * o + 1] = l_s[r];
    }
}

// ---------------------------------------------------------------------------
// bfloat16: tensor-core tiles (mma.sync m16n8k16), one 64-token split a CTA
// ---------------------------------------------------------------------------

constexpr int kMmaRows = 16;  // query heads of a KV head, padded to the tile

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
// d += a b: A 16x16 (4 x bf16x2), B 16x8 (2 x bf16x2), D 16x8 f32
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Fragments (lane l, g4 = l / 4, q4 = l % 4): D rows g4 and g4 + 8 (query
// heads), columns 2 q4, 2 q4 + 1 of the n8 tile; A registers i hold row
// g4 + 8 (i % 2), k = 8 (i / 2) + 2 q4 + {0, 1}.
template <int kMaxKs>
__global__ void __launch_bounds__(kThreads)
paged_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
                 const __nv_bfloat16* __restrict__ v_pages,
                 const int* __restrict__ block_tables, const int* __restrict__ seq_lens,
                 __nv_bfloat16* __restrict__ out, float* __restrict__ part_acc,
                 float* __restrict__ part_ml, int H, int KV, int page, int hd, int pps,
                 float scale_log2, float softcap) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int rep = H / KV, ld = hd + 8;  // rows padded by 16 bytes: ldmatrix hits 8 banks
  __nv_bfloat16* k_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][hd + 8]
  __nv_bfloat16* v_s = k_s + kChunk * ld;                             // [64][hd + 8]
  __nv_bfloat16* p_s = v_s + kChunk * ld;                             // [16][64 + 8]
  float* mx_s = reinterpret_cast<float*>(p_s + kMmaRows * (kChunk + 8));  // [8 warps][16]
  float* sm_s = mx_s + 8 * kMmaRows;                                  // [8 warps][16]

  const int g = blockIdx.x, b = blockIdx.y, split = blockIdx.z, n_split = gridDim.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, g4 = lane / 4, q4 = lane % 4;
  const int live = min(seq_lens[b], pps * page);
  const int t0 = split * kChunk;
  const int n_t = max(0, min(kChunk, live - t0));
  const int64_t part = (static_cast<int64_t>(b) * H) * n_split + split;  // + h*n_split

  if (n_t == 0) {  // weight 0 in the combine; zeros when it is the only split
    write_empty_split(out, part_acc, part_ml, part, b, g, H, KV, hd);
    return;
  }

  // live K, then V, rows: 16-byte cp.async copies, two commit groups; rows
  // past the live ones are zeroed (a 0 probability times stale bits is NaN)
  const int vpr = hd / 8;
  const int* bt = block_tables + static_cast<int64_t>(b) * pps;
  for (int pass = 0; pass < 2; ++pass) {
    const __nv_bfloat16* src = pass == 0 ? k_pages : v_pages;
    __nv_bfloat16* dst = pass == 0 ? k_s : v_s;
    for (int e = tid; e < kChunk * vpr; e += kThreads) {
      const int t = e / vpr, c = e % vpr, tg = t0 + t;
      if (t < n_t) {
        const int64_t pid = bt[tg / page];
        cp_async16(dst + t * ld + c * 8, src + ((pid * KV + g) * page + tg % page) * hd + c * 8);
      } else {
        *reinterpret_cast<uint4*>(dst + t * ld + c * 8) = make_uint4(0, 0, 0, 0);
      }
    }
    cp_async_commit();
  }
  // q as A fragments, straight from device memory: rows are query heads
  uint32_t qa[kMaxKs][4];
  const int nks = hd / 16;
  const int64_t qrow0 = (static_cast<int64_t>(b) * H + g4 * KV + g) * hd;
  const int64_t qrow1 = (static_cast<int64_t>(b) * H + (g4 + 8) * KV + g) * hd;
#pragma unroll
  for (int ks = 0; ks < kMaxKs; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = g4 + 8 * (i % 2), kcol = 16 * ks + 8 * (i / 2) + 2 * q4;
      qa[ks][i] = (ks < nks && row < rep)
          ? *reinterpret_cast<const uint32_t*>(q + (i % 2 ? qrow1 : qrow0) + kcol) : 0u;
    }
  cp_async_wait<1>();
  __syncthreads();  // K in place

  // S = Q K^T for this warp's 8 tokens
  float sc[4] = {0.f, 0.f, 0.f, 0.f};
  const int tok = 8 * warp;
#pragma unroll
  for (int ks = 0; ks < kMaxKs; ++ks) {
    if (ks < nks) {
      uint32_t b0, b1;
      ldsm_x2(smem_u32(k_s + (tok + lane % 8) * ld + 16 * ks + 8 * ((lane / 8) % 2)), b0, b1);
      mma16816(sc, qa[ks], b0, b1);
    }
  }
  // softmax over the split for each head: quad shuffles, then across warps
  const int tq = tok + 2 * q4;
  float p[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    p[i] = tq + i % 2 < n_t ? rt::score_log2(sc[i], scale_log2, softcap) : rt::kNegInf;
  float ma = fmaxf(p[0], p[1]), mb = fmaxf(p[2], p[3]);
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    ma = fmaxf(ma, __shfl_xor_sync(0xffffffffu, ma, off));
    mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, off));
  }
  if (q4 == 0) {
    mx_s[warp * kMmaRows + g4] = ma;
    mx_s[warp * kMmaRows + g4 + 8] = mb;
  }
  __syncthreads();
  ma = mb = rt::kNegInf;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    ma = fmaxf(ma, mx_s[w * kMmaRows + g4]);
    mb = fmaxf(mb, mx_s[w * kMmaRows + g4 + 8]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) p[i] = p[i] == rt::kNegInf ? 0.f : exp2f(p[i] - (i < 2 ? ma : mb));
  float la = p[0] + p[1], lb = p[2] + p[3];
#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    la += __shfl_xor_sync(0xffffffffu, la, off);
    lb += __shfl_xor_sync(0xffffffffu, lb, off);
  }
  if (q4 == 0) {
    sm_s[warp * kMmaRows + g4] = la;
    sm_s[warp * kMmaRows + g4 + 8] = lb;
  }
  *reinterpret_cast<__nv_bfloat162*>(p_s + g4 * (kChunk + 8) + tq) =
      __floats2bfloat162_rn(p[0], p[1]);
  *reinterpret_cast<__nv_bfloat162*>(p_s + (g4 + 8) * (kChunk + 8) + tq) =
      __floats2bfloat162_rn(p[2], p[3]);
  cp_async_wait<0>();
  __syncthreads();  // V, P and the per-warp sums in place

  // O = P V: a warp per pair of 8-column tiles of hd
  uint32_t pa[kChunk / 16][4];
#pragma unroll
  for (int ks = 0; ks < kChunk / 16; ++ks)
    ldsm_x4(smem_u32(p_s + (lane % 8 + 8 * ((lane / 8) % 2)) * (kChunk + 8) + 16 * ks +
                     8 * (lane / 16)),
            pa[ks]);
  la = lb = 0.f;
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    la += sm_s[w * kMmaRows + g4];
    lb += sm_s[w * kMmaRows + g4 + 8];
  }
  for (int pair = warp; pair < hd / 16; pair += 8) {
    float o[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < kChunk / 16; ++ks) {
      uint32_t vb[4];
      ldsm_x4_t(smem_u32(v_s + (16 * ks + lane % 8 + 8 * ((lane / 8) % 2)) * ld + 16 * pair +
                         8 * (lane / 16)),
                vb);
      mma16816(o[0], pa[ks], vb[0], vb[1]);
      mma16816(o[1], pa[ks], vb[2], vb[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = g4 + 8 * half, col = 16 * pair + 8 * j + 2 * q4;
        if (r >= rep) continue;
        const int h = r * KV + g;
        const float a0 = o[j][2 * half], a1 = o[j][2 * half + 1];
        if (n_split == 1) {
          const float inv = 1.f / fmaxf(half ? lb : la, 1e-30f);
          *reinterpret_cast<__nv_bfloat162*>(out + (static_cast<int64_t>(b) * H + h) * hd +
                                             col) = __floats2bfloat162_rn(a0 * inv, a1 * inv);
        } else {
          *reinterpret_cast<float2*>(part_acc + (part + static_cast<int64_t>(h) * n_split) *
                                                    hd + col) = make_float2(a0, a1);
        }
      }
  }
  if (n_split > 1 && warp == 0 && q4 == 0)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g4 + 8 * half;
      if (r >= rep) continue;
      const int64_t o = part + static_cast<int64_t>(r * KV + g) * n_split;
      part_ml[2 * o] = half ? mb : ma;
      part_ml[2 * o + 1] = half ? lb : la;
    }
}

// One CTA per (sequence, query head): weigh each split by 2^(m_i - M).
template <typename T>
__global__ void __launch_bounds__(128)
paged_combine_kernel(const float* __restrict__ part_acc, const float* __restrict__ part_ml,
                     T* __restrict__ out, int n_split, int hd) {
  extern __shared__ float ml_s[];  // [n_split][2]
  const int64_t bh = blockIdx.x;
  for (int i = threadIdx.x; i < 2 * n_split; i += blockDim.x)
    ml_s[i] = part_ml[bh * n_split * 2 + i];
  __syncthreads();
  float M = rt::kNegInf;
  for (int i = 0; i < n_split; ++i) M = fmaxf(M, ml_s[2 * i]);
  float denom = 0.f;
  for (int i = 0; i < n_split; ++i) denom += exp2f(ml_s[2 * i] - M) * ml_s[2 * i + 1];
  const float inv = 1.f / fmaxf(denom, 1e-30f);
  const float* acc = part_acc + bh * n_split * hd;
  for (int d = threadIdx.x; d < hd; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < n_split; ++i) a += exp2f(ml_s[2 * i] - M) * acc[i * hd + d];
    out[bh * hd + d] = rt::from_f<T>(a * inv);
  }
}

// the combine launch, when there is more than one split
template <typename T>
int combine(void* part_acc, void* part_ml, void* out, int BH, int n_split, int hd,
            cudaStream_t stream) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return static_cast<int>(err);
  paged_combine_kernel<T><<<BH, 128, 2 * n_split * sizeof(float), stream>>>(
      static_cast<const float*>(part_acc), static_cast<const float*>(part_ml),
      static_cast<T*>(out), n_split, hd);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scalar(const void* q, const void* kp, const void* vp, const void* bt, const void* sl,
                  void* out, void* part_acc, void* part_ml, int B, int H, int KV, int page,
                  int hd, int pps, float softcap, cudaStream_t stream) {
  if (hd % kVec != 0) return static_cast<int>(cudaErrorInvalidValue);
  const int rep = H / KV;
  const int n_split = (pps * page + kChunk - 1) / kChunk;
  const size_t smem =
      sizeof(float) * (kChunk * (2 * hd + kVec) + rep * hd + rep * kChunk + 2 * rep);
  static size_t smem_set = 48 * 1024;  // the attribute only grows
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_scalar_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  paged_scalar_kernel<T><<<dim3(KV, B, n_split), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(kp), static_cast<const T*>(vp),
      static_cast<const int*>(bt), static_cast<const int*>(sl), static_cast<T*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, KV, page, hd, pps,
      rt::kLog2e / sqrtf(static_cast<float>(hd)), softcap);
  return combine<T>(part_acc, part_ml, out, B * H, n_split, hd, stream);
}

template <int kMaxKs>
int launch_mma(const void* q, const void* kp, const void* vp, const void* bt, const void* sl,
               void* out, void* part_acc, void* part_ml, int B, int H, int KV, int page,
               int hd, int pps, float softcap, cudaStream_t stream) {
  const int n_split = (pps * page + kChunk - 1) / kChunk;
  const int smem = 2 * kChunk * (hd + 8) * 2 + kMmaRows * (kChunk + 8) * 2 +
                   2 * 8 * kMmaRows * 4;
  static int smem_set = 48 * 1024;  // the attribute only grows
  if (smem > smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_mma_kernel<kMaxKs>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = smem;
  }
  paged_mma_kernel<kMaxKs><<<dim3(KV, B, n_split), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kp),
      static_cast<const __nv_bfloat16*>(vp), static_cast<const int*>(bt),
      static_cast<const int*>(sl), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part_acc), static_cast<float*>(part_ml), H, KV, page, hd, pps,
      rt::kLog2e / sqrtf(static_cast<float>(hd)), softcap);
  return combine<__nv_bfloat16>(part_acc, part_ml, out, B * H, n_split, hd, stream);
}

}  // namespace

// With cdiv(pps * page, kChunk) > 1 splits, part_acc holds [B, H, splits,
// hd] and part_ml [B, H, splits, 2] floats, and a combine launch follows.
// softcap: 0 = off.
extern "C" int rt_paged_attention(const void* q, const void* k_pages,
                                  const void* v_pages, const void* block_tables,
                                  const void* seq_lens, void* out, void* part_acc,
                                  void* part_ml, int B, int H, int KV, int page, int hd,
                                  int pps, int dtype, float softcap, void* stream) {
  if (B <= 0 || KV <= 0 || pps <= 0 || page <= 0 || H % KV != 0 ||
      (H / KV) * hd > kMaxRepHd)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return launch_scalar<float>(q, k_pages, v_pages, block_tables, seq_lens, out, part_acc,
                                part_ml, B, H, KV, page, hd, pps, softcap, s);
  if (dtype != rt::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  if (hd % 16 != 0 || hd > 256 || H / KV > kMmaRows)  // shapes the mma tiles do not take
    return launch_scalar<__nv_bfloat16>(q, k_pages, v_pages, block_tables, seq_lens, out,
                                        part_acc, part_ml, B, H, KV, page, hd, pps, softcap, s);
  return (hd <= 128 ? launch_mma<8> : launch_mma<16>)(
      q, k_pages, v_pages, block_tables, seq_lens, out, part_acc, part_ml, B, H, KV, page,
      hd, pps, softcap, s);
}

extern "C" int rt_paged_attention_max_rep_hd() { return kMaxRepHd; }
