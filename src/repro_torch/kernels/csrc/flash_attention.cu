// Flash attention (forward) for Hopper: causal or not, optional sliding
// window, GQA.
//
// Replaces: src/repro/kernels/flash_attention.py :: _flash_kernel (the
// pallas_call in flash_attention). q [B,H,S,hd], k/v [B,KV,T,hd] ->
// out [B,H,S,hd]; f32 online softmax, scale 1/sqrt(hd), masked scores
// -1e30 and masked probabilities 0, out = acc / max(l, 1e-30). GQA is
// r-major: query head h reads KV head h % KV (as the Pallas code does; its
// docstring's h // (H/KV) is wrong). Tiles wholly past the causal diagonal
// or behind the window are skipped with the Pallas kernel's own conditions.
// Ragged S and T are masked in the kernel (rows past the end load as 0 and
// are never stored): nothing is padded in device memory. Inputs are read
// through strides (hd contiguous), so the model's [B,S,H,hd] tensors are
// read and written in place.
//
// What bounds it: at prefill lengths (S = T in the hundreds, hd = 128) the
// products QK^T and PV, about 4*S*T*hd FLOP per head (halved by the causal
// mask) against 2 bytes per element moved. At B=1, H=32, S=T=512 the bytes
// (9.4 MB, 2.8 us) and the products on the tensor cores (2.15 GFLOP, 2.2 us)
// are about even; on the CUDA cores in f32 (67 TFLOP/s) the products alone
// would take 32 us, so the tensor cores are the whole game.
//
// bfloat16 design (flash_bf16_kernel): one warpgroup (128 threads) per CTA
// owns 64 query rows of one head. S = Q K^T runs as wgmma m64n64k16 with Q
// and K read from shared memory (both K-major: rows are hd-contiguous);
// O += P V as wgmma m64n{hd}k16 with P in registers (the S accumulator
// fragment converted to bf16 is the A fragment) and V from shared memory
// (MN-major, the transpose bit). Every tile (Q, and K and V per stage) is
// stored in 128-byte-swizzled column blocks of 64 (hd 128 = two blocks; hd
// below 64 is zero-padded to 64), the layout the descriptors name. The
// tiles arrive by TMA: one thread issues a 64 x 64 box per block on a
// tensor map built per call from the wrapper's strides (the model's
// [B,S,H,hd] views included), the TMA swizzles as it stores and fills rows
// past S or T with zeros, and an mbarrier per stage of a two-stage K/V ring
// says when a tile has landed, so the next tile loads while this one
// computes. The map's encoder comes from the driver through the runtime
// (cudaGetDriverEntryPoint), so nothing links -lcuda. An earlier version
// filled the ring with per-thread 16-byte cp.async copies; a clock64 trace
// on an H100 put their issue at about 1,200 of a tile's 4,000 cycles. The
// softmax stays in registers: a row lives on the 4 lanes of a quad, max by
// two shuffles, exp2f with log2(e)/sqrt(hd) folded into the scale, and the
// row sum kept per thread until the end. A softcap c > 0 turns each scaled
// score s into c tanh(s / c) before the mask, as the reference's _sdpa
// does. Only tiles that cross the
// diagonal, the window edge or the end of T apply the per-element mask.
// The GQA heads are not packed into one CTA: the 8 query heads of a KV
// head read the same K/V from L2 (1 MB at S=512). Two heads a CTA (two
// warpgroups, one ring) measured no faster at S=512 and slower at S=128 on
// an H100, and all 8 would leave 4 CTAs at S=64. The heaviest causal tiles
// launch first.
//
// float32 stays on the CUDA cores (flash_f32_kernel): the tensor cores
// would need TF32, which cannot meet the f32 tolerance (2e-5).
#include <cuda.h>

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using hp::mbar_expect;
using hp::mbar_init;
using hp::mbar_wait;
using hp::pack_bf16;
using hp::wgmma_pv;

constexpr int kMaxHd = 128;

struct Strides {
  int64_t b, h, s;
};

__device__ __forceinline__ bool visible(int qp, int kp, int Tn, bool causal, int window) {
  bool ok = kp < Tn;
  if (causal) ok = ok && qp >= kp;
  if (window > 0) ok = ok && (qp - kp < window);
  return ok;
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma tiles
// ---------------------------------------------------------------------------

constexpr int kRows = 64;           // query rows per CTA, keys per K/V tile
constexpr int kWgThreads = 128;     // one warpgroup
// One 64-column block of a tile: 64 rows of 128 bytes, 16-byte chunk c of row
// r at r * 128 + ((c ^ r % 8) << 4) (the 128-byte swizzle the TMA applies).
constexpr int kBlockBytes = kRows * 128;

// V is MN-major for the P.V product: LBO steps between the 64-column blocks
// of hd, SBO between groups of 8 keys.
constexpr uint32_t kVLbo = kBlockBytes, kVSbo = 8 * 128;

template <int HDP>
__global__ void __launch_bounds__(kWgThreads)
flash_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                  Strides os, int KV, int S, int Tn, int hd, bool causal, int window,
                  float scale_log2, float softcap) {
  constexpr int kTile = kRows * HDP * 2;  // bytes of one tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  const uint32_t base =
      (static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw)) + 1023u) & ~1023u;
  const uint32_t sQ = base;
  auto sK = [&](int st) { return base + (1 + st) * kTile; };
  auto sV = [&](int st) { return base + (3 + st) * kTile; };
  const uint32_t full = base + 5 * kTile;  // two mbarriers: stage 0, stage 1 filled

  const int iq = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z, g = h % KV;
  const int q0 = iq * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // K/V tiles [lo, hi): skip those past the diagonal and behind the window
  const int nk = (Tn + kRows - 1) / kRows;
  const int hi = causal ? min(nk, (q0 + kRows - 1) / kRows + 1) : nk;
  int lo = 0;
  if (window > 0)
    while (lo < hi && q0 - (lo * kRows + kRows - 1) >= window) ++lo;

  // one thread starts the copies: Q and the first K/V tile on stage 0's
  // barrier (rows past S or T arrive as zeros)
  if (threadIdx.x == 0) {
    mbar_init(full);
    mbar_init(full + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect(full, (lo < hi ? 3 : 1) * kTile);
    hp::tma_tile<HDP, kBlockBytes>(sQ, &tq, q0, h, b, full);
    if (lo < hi) {
      hp::tma_tile<HDP, kBlockBytes>(sK(0), &tk, lo * kRows, g, b, full);
      hp::tma_tile<HDP, kBlockBytes>(sV(0), &tv, lo * kRows, g, b, full);
    }
  }
  __syncthreads();  // the barriers are initialised

  // this thread's rows (and 8 below) and first column of each 8-column block
  const int r0 = q0 + warp * 16 + lane / 4, r1 = r0 + 8, c0 = 2 * (lane % 4);
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = rt::kNegInf, m1 = rt::kNegInf, l0 = 0.f, l1 = 0.f;

  uint32_t parity = 0;  // bit st: the phase of stage st's barrier to wait for
  for (int it = lo; it < hi; ++it) {
    const int st = (it - lo) & 1;
    mbar_wait(full + 8 * st, (parity >> st) & 1);
    parity ^= 1u << st;
    __syncthreads();  // everyone is done with the other stage
    if (threadIdx.x == 0 && it + 1 < hi) {  // the next tile loads while this one computes
      mbar_expect(full + 8 * (st ^ 1), 2 * kTile);
      const uint32_t bar = full + 8 * (st ^ 1);
      hp::tma_tile<HDP, kBlockBytes>(sK(st ^ 1), &tk, (it + 1) * kRows, g, b, bar);
      hp::tma_tile<HDP, kBlockBytes>(sV(st ^ 1), &tv, (it + 1) * kRows, g, b, bar);
    }
    const int k0 = it * kRows;

    // S = Q K^T over hd in steps of 16: within a 64-column block a step is
    // 32 bytes on from the block's start (the hardware applies the swizzle)
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < HDP / 16; ++kk) {
      const uint32_t off = (kk / 4) * kBlockBytes + (kk % 4) * 32;
      wg::wgmma_ss_m64n64(s, wg::desc_sw128(sQ + off, 0, 1024),
                          wg::desc_sw128(sK(st) + off, 0, 1024), kk > 0);
    }
    wg::commit();
    wg::wait_all();
    wg::fence_operands(s);

    // online softmax in log2 units; s[4j + e]: row e < 2 ? r0 : r1,
    // key k0 + 8j + c0 + e % 2
    const bool masked = (causal && k0 + kRows - 1 > q0) ||
                        (window > 0 && q0 + kRows - 1 - k0 >= window) || k0 + kRows > Tn;
    float mx0 = rt::kNegInf, mx1 = rt::kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = rt::score_log2(s[i], scale_log2, softcap);
      if (masked && !visible(i % 4 < 2 ? r0 : r1, k0 + 8 * (i / 4) + c0 + i % 2, Tn, causal,
                             window))
        x = rt::kNegInf;
      s[i] = x;
      if (i % 4 < 2) mx0 = fmaxf(mx0, x);
      else mx1 = fmaxf(mx1, x);
    }
#pragma unroll
    for (int off = 1; off < 4; off *= 2) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const bool top = i % 4 < 2;
      const float p = s[i] == rt::kNegInf ? 0.f : exp2f(s[i] - (top ? mn0 : mn1));
      s[i] = p;
      if (top) sum0 += p;
      else sum1 += p;
    }
    l0 = l0 * corr0 + sum0;  // this thread's share of the row sum
    l1 = l1 * corr1 + sum1;
#pragma unroll
    for (int i = 0; i < HDP / 2; ++i) acc[i] *= (i % 4 < 2) ? corr0 : corr1;

    // P (bf16) as the A fragment: keys 16kk.. are S columns of blocks 2kk, 2kk+1
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    // O += P V over the tile's 64 keys in steps of 16 (16 rows of 128 bytes)
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<HDP>(acc, pa[kk], wg::desc_sw128(sV(st) + kk * 16 * 128, kVLbo, kVSbo));
    wg::commit();
    wg::wait_all();
    wg::fence_operands(acc);
  }
  if (lo >= hi) mbar_wait(full, 0);  // Q's copy, never waited for in the loop

#pragma unroll
  for (int off = 1; off < 4; off *= 2) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int j = 0; j < HDP / 8; ++j) {
    const int col = 8 * j + c0;
    if (col >= hd) continue;
    if (r0 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r0 * os.s + col) =
          __floats2bfloat162_rn(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (r1 < S)
      *reinterpret_cast<__nv_bfloat162*>(ob + r1 * os.s + col) =
          __floats2bfloat162_rn(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
  }
}

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v, void* o, const Strides* st,
                int B, int H, int KV, int S, int Tn, int hd, bool causal, int window,
                float softcap, cudaStream_t stream) {
  const int smem = 5 * kRows * HDP * 2 + 16 + 1024;  // Q, K x2, V x2, barriers, alignment
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_bf16_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  CUtensorMap tq, tk, tv;
  // each a [B, heads, rows, hd] tensor read as [B, rows, heads, hd]
  auto map = [&](CUtensorMap* m, const void* p, const Strides& s, int heads, int rows) {
    return hp::make_map(m, p, B, rows, heads, hd, s.s, s.h, s.b);
  };
  int err = map(&tq, q, st[0], H, S);
  if (err == 0) err = map(&tk, k, st[1], KV, Tn);
  if (err == 0) err = map(&tv, v, st[2], KV, Tn);
  if (err != 0) return err;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  flash_bf16_kernel<HDP><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[3], KV, S, Tn, hd, causal, window,
      rt::kLog2e / sqrtf(static_cast<float>(hd)), softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// float32: CUDA cores
// ---------------------------------------------------------------------------
// One block per (q tile of 64 rows, head, batch) loops over K/V tiles of 64
// rows staged in shared memory, rows padded to hd+1 so the 16x16 thread grid
// reads them without bank conflicts. Each thread owns a 4x4 block of the
// score tile and a 4 x hd/16 block of the output accumulator in registers.

constexpr int kBQ = 64, kBK = 64, kThreads = 256;
constexpr int kDPer = kMaxHd / 16;  // output columns per thread

__global__ void __launch_bounds__(kThreads)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o, Strides qs, Strides ks,
                 Strides vs, Strides os, int KV, int S, int Tn, int hd, bool causal,
                 int window, float scale, float softcap) {
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
  const float* qb = q + b * qs.b + h * qs.h;
  const float* kb = k + b * ks.b + g * ks.h;
  const float* vb = v + b * vs.b + g * vs.h;

  for (int e = tid; e < kBQ * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    q_s[i * hdp + d] = (q0 + i < S) ? qb[(q0 + i) * qs.s + d] : 0.f;
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
      k_s[j * hdp + d] = in ? kb[(k0 + j) * ks.s + d] : 0.f;
      v_s[j * hd + d] = in ? vb[(k0 + j) * vs.s + d] : 0.f;
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
        s_s[i * (kBK + 1) + j] = (q0 + i < S && visible(q0 + i, k0 + j, Tn, causal, window))
                                     ? rt::softcap(sc[a][c] * scale, softcap) : rt::kNegInf;
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
        const float p = (q0 + i < S && visible(q0 + i, k0 + j, Tn, causal, window))
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
  float* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    if (q0 + i >= S) continue;
    const float inv = 1.f / fmaxf(l_s[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kDPer; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) ob[(q0 + i) * os.s + d] = acc[a][c] * inv;
    }
  }
}

int launch_f32(const void* q, const void* k, const void* v, void* o, const Strides* st,
               int B, int H, int KV, int S, int Tn, int hd, bool causal, int window,
               float softcap, cudaStream_t stream) {
  const int hdp = hd + 1;
  const size_t smem =
      sizeof(float) * (kBQ * hdp + kBK * hdp + kBK * hd + kBQ * (kBK + 1) + 3 * kBQ);
  const cudaError_t err = cudaFuncSetAttribute(
      flash_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_f32_kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), st[0], st[1], st[2], st[3], KV,
      S, Tn, hd, causal, window, 1.0f / sqrtf(static_cast<float>(hd)), softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64 (batch, head, seq) strides of q, k, v, out, in
// elements; the head_dim stride is 1 for all four. bfloat16 needs hd % 8 == 0,
// T > 0 and strides % 8 == 0: a tensor map takes 16-byte multiples.
// softcap: 0 = off.
extern "C" int rt_flash_attention(const void* q, const void* k, const void* v, void* out,
                                  const void* strides, int B, int H, int KV, int S, int T,
                                  int hd, int causal, int window, int dtype, float softcap,
                                  void* stream) {
  if (B <= 0 || S <= 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* p = static_cast<const int64_t*>(strides);
  const Strides st[4] = {{p[0], p[1], p[2]}, {p[3], p[4], p[5]},
                         {p[6], p[7], p[8]}, {p[9], p[10], p[11]}};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return launch_f32(q, k, v, out, st, B, H, KV, S, T, hd, causal != 0, window, softcap, s);
  if (dtype == rt::kBF16) {
    if (hd % 8 != 0 || T <= 0) return static_cast<int>(cudaErrorInvalidValue);
    for (int i = 0; i < 12; ++i)
      if (p[i] % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
    return (hd <= 64 ? launch_bf16<64> : launch_bf16<128>)(q, k, v, out, st, B, H, KV, S, T,
                                                           hd, causal != 0, window, softcap,
                                                           s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rt_flash_attention_max_hd() { return kMaxHd; }
