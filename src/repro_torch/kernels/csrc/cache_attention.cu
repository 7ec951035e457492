// chunked_cache_attention's KV-block scan (forward) for Hopper: the
// attention of a prefill's queries over the KV ring, with the positions the
// ring holds.
//
// Replaces: src/repro/models/layers.py :: chunked_cache_attention, the
// lax.scan over KV blocks at :203 (not a Pallas kernel: XLA runs the scan as
// one loop on the device, and the port ran it as a Python loop of ~15 ops a
// block). q [B,S,H,hd] (the model's RoPE'd queries), k, v [B,T,KV,hd] (the
// ring, read in place), q_pos [B,S] and k_pos [B,T] int32 (-1 an empty slot)
// -> out [B,S,H,hd] in q's dtype. A slot is visible to a query where k_pos
// >= 0, q_pos >= k_pos and, with a window w > 0, q_pos - k_pos < w. Scores
// q.k / sqrt(hd) in f32, c tanh(s / c) before the mask where softcap c > 0;
// an online softmax from m = -1e30, a masked probability 0, out = acc /
// max(l, 1e-30), so a row that sees no slot is 0. r-major GQA: query head h
// reads KV head h % KV. The whole ring is one launch: slots t >= T are
// masked here, so the reference's block_k (which only orders its sums) has
// no counterpart and nothing is padded.
//
// What bounds it: at llava-next's prefill (B 2, S 2,944, T 2,976, H/KV
// 32/8, hd 128, bf16) the products, 4 hd FLOPs a visible (query, slot) pair
// and head: 1.4e11 FLOPs, 0.14 ms on the tensor cores, against 121 MB of
// inputs and output (0.036 ms). The plain loop wrote ~6 [B,S,H,block_k] f32
// tensors a block (0.77 GB each at that shape); here no S x T intermediate
// leaves the SM.
//
// Which tiles: a slot's position is in k_pos, not in its index (hymba's
// ring wraps), so a K/V tile cannot be skipped by its index as flash does.
// Each CTA first takes its rows' positions (qmin, qmax over rows < S) and
// walks k_pos once, a warp a tile of 64 slots: a tile is needed where some
// slot is visible to some position in [qmin, qmax] (p >= 0, p <= qmax,
// qmin - p < w), and needs no per-element mask where every slot is visible
// to every one (inside T, p >= 0, p <= qmin, qmax - p < w). The needed
// tiles go to a list in shared memory, in slot order, with that flag.
// Where positions follow the slots (a prefill into an empty ring, llava's)
// the list is the causal half of the ring.
//
// bfloat16 with hd % 16 == 0 and 16-byte aligned rows (cache_bf16_kernel):
// flash_attention.cu's design over the list. One warpgroup a CTA owns 64
// query rows of one head; S = Q K^T as wgmma m64n64k16 from 128-byte
// swizzled shared tiles, O += P V as wgmma m64n{64,128}k16 with P in
// registers; Q and a two-stage K/V ring arrive by TMA on tensor maps built
// per call from the strides (zeros past S, T and hd), the next listed tile
// loading while this one computes. hd up to 64 runs as 64 (zero columns),
// up to 128 as 128.
//
// Every other case (float32, hd not a multiple of 16 or past 128, unaligned
// rows) runs on the CUDA cores (cache_scalar_kernel<T, DPER>, hd up to 16
// DPER: 128 or 256): flash's f32 kernel over the
// list, the mask from the positions, bf16 read into f32 and P rounded to
// bf16 before P V as the plain version rounds it. float32 stays off the
// tensor cores: TF32 would miss the f32 tolerance (2e-5).
#include <cuda.h>

#include <climits>
#include <cmath>
#include <initializer_list>

#include "common.cuh"
#include "wgmma.cuh"

namespace {

constexpr int kMaxHd = 256;       // the CUDA-core kernel's; the wgmma kernel takes up to 128
constexpr int kMaxTileHd = 128;
constexpr int kRows = 64;        // query rows a CTA, slots a K/V tile
constexpr int kFull = 1 << 30;   // list entry flag: every slot visible to every row
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have

struct Strides {
  int64_t b, s, h;  // batch, sequence and head strides in elements (hd contiguous)
};

__device__ __forceinline__ bool visible(int qp, int kp, int window) {
  return kp >= 0 && qp >= kp && (window <= 0 || qp - kp < window);
}

// The CTA's plan, called by every thread (blockDim.x a multiple of 32, at
// least 64): the position range of rows q0.. below S, then the K/V tiles any
// of them can see, in slot order, as list[0, n) (tile | kFull where no slot
// needs a mask); returns n. red: 3 ints; list: one int a tile of the ring,
// written in place over the per-tile flags (warp 0 reads a group of 32
// flags before it writes any entry, and entries land at or below them).
__device__ int plan_tiles(const int* __restrict__ qp, const int* __restrict__ kp, int q0,
                          int S, int Tn, int window, int* red, int* list) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32, nwarp = blockDim.x / 32;
  if (tid == 0) {
    red[0] = INT_MAX;
    red[1] = INT_MIN;
  }
  __syncthreads();
  if (tid < kRows && q0 + tid < S) {
    const int p = qp[q0 + tid];
    atomicMin(&red[0], p);
    atomicMax(&red[1], p);
  }
  __syncthreads();
  const int qmin = red[0], qmax = red[1];
  const int nk = (Tn + kRows - 1) / kRows;
  for (int i = warp; i < nk; i += nwarp) {
    bool any = false, all = true;
    for (int j = lane; j < kRows; j += 32) {
      const int t = i * kRows + j;
      const int p = t < Tn ? kp[t] : -1;
      any = any || (p >= 0 && p <= qmax && (window <= 0 || qmin - p < window));
      all = all && (p >= 0 && p <= qmin && (window <= 0 || qmax - p < window));
    }
    any = __any_sync(0xffffffffu, any);
    all = __all_sync(0xffffffffu, all);
    if (lane == 0) list[i] = any ? (all ? 2 : 1) : 0;
  }
  __syncthreads();
  if (warp == 0) {
    int n = 0;
    for (int i0 = 0; i0 < nk; i0 += 32) {
      const int i = i0 + lane;
      const int f = i < nk ? list[i] : 0;
      const unsigned take = __ballot_sync(0xffffffffu, f != 0);
      if (f != 0) list[n + __popc(take & ((1u << lane) - 1u))] = i | (f == 2 ? kFull : 0);
      n += __popc(take);
    }
    if (lane == 0) red[2] = n;
  }
  __syncthreads();
  return red[2];
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma tiles (flash_attention.cu's, over the list)
// ---------------------------------------------------------------------------

constexpr int kWgThreads = 128;  // one warpgroup
// One 64-column block of a tile: 64 rows of 128 bytes, 16-byte chunk c of row
// r at r * 128 + ((c ^ r % 8) << 4) (the 128-byte swizzle the TMA applies).
constexpr int kBlockBytes = kRows * 128;

// mbarrier and TMA (cp.async.bulk.tensor) helpers; addresses are shared-space
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
// Wait for the phase of the given parity to complete. A copy that never
// lands (a bad tensor map) traps instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  for (int i = 0;; ++i) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (i > (1 << 20)) asm volatile("trap;");
  }
}
// one 64 x 64 box (row0.., column c0..) of a [B, rows, heads, hd] tensor map
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c0, int row0,
                                        int head, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(row0), "r"(head), "r"(b),
        "r"(bar) : "memory");
}
// a tile: its 64-column blocks, each a box the TMA swizzles as it stores
template <int HDP>
__device__ __forceinline__ void tma_tile(uint32_t tile, const CUtensorMap* map, int row0,
                                         int head, int b, uint32_t bar) {
#pragma unroll
  for (int cb = 0; cb < HDP / 64; ++cb)
    tma_box(tile + cb * kBlockBytes, map, 64 * cb, row0, head, b, bar);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

template <int HDP> __device__ __forceinline__ void wgmma_pv(float (&o)[HDP / 2],
                                                            const uint32_t (&a)[4],
                                                            uint64_t db);
template <> __device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                                         const uint32_t (&a)[4],
                                                         uint64_t db) {
  wg::wgmma_rs_m64n64(o, a, db);
}
template <> __device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                                          const uint32_t (&a)[4],
                                                          uint64_t db) {
  wg::wgmma_rs_m64n128(o, a, db);
}

// V is MN-major for the P.V product: LBO steps between the 64-column blocks
// of hd, SBO between groups of 8 slots.
constexpr uint32_t kVLbo = kBlockBytes, kVSbo = 8 * 128;

template <int HDP>
__global__ void __launch_bounds__(kWgThreads)
cache_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const int* __restrict__ q_pos,
                  const int* __restrict__ k_pos, __nv_bfloat16* __restrict__ o, Strides os,
                  int KV, int S, int Tn, int hd, int window, float scale_log2, float softcap) {
  constexpr int kTile = kRows * HDP * 2;  // bytes of one tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;
  auto sK = [&](int st) { return base + (1 + st) * kTile; };
  auto sV = [&](int st) { return base + (3 + st) * kTile; };
  const uint32_t full = base + 5 * kTile;  // two mbarriers: stage 0, stage 1 filled
  int* red = reinterpret_cast<int*>(smem_raw + (base - raw) + 5 * kTile + 16);
  int* list = red + 4;

  const int iq = gridDim.x - 1 - blockIdx.x;  // the latest positions first, in a prefill
  const int h = blockIdx.y, b = blockIdx.z, g = h % KV;
  const int q0 = iq * kRows;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int* qp = q_pos + static_cast<int64_t>(b) * S;
  const int* kp = k_pos + static_cast<int64_t>(b) * Tn;

  if (threadIdx.x == 0) {
    mbar_init(full);
    mbar_init(full + 8);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int n = plan_tiles(qp, kp, q0, S, Tn, window, red, list);  // syncs the barriers too

  // one thread starts the copies: Q and the first listed K/V tile on stage
  // 0's barrier (rows past S or T arrive as zeros); none without a tile
  if (threadIdx.x == 0 && n > 0) {
    const int k0 = (list[0] & ~kFull) * kRows;
    mbar_expect(full, 3 * kTile);
    tma_tile<HDP>(sQ, &tq, q0, h, b, full);
    tma_tile<HDP>(sK(0), &tk, k0, g, b, full);
    tma_tile<HDP>(sV(0), &tv, k0, g, b, full);
  }

  // this thread's rows (and 8 below), their positions (-1 past S: sees
  // nothing), and the first column of each 8-column block
  const int r0 = q0 + warp * 16 + lane / 4, r1 = r0 + 8, c0 = 2 * (lane % 4);
  const int qp0 = r0 < S ? qp[r0] : -1, qp1 = r1 < S ? qp[r1] : -1;
  float acc[HDP / 2];
#pragma unroll
  for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
  float s[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  float m0 = rt::kNegInf, m1 = rt::kNegInf, l0 = 0.f, l1 = 0.f;

  uint32_t parity = 0;  // bit st: the phase of stage st's barrier to wait for
  for (int it = 0; it < n; ++it) {
    const int st = it & 1;
    mbar_wait(full + 8 * st, (parity >> st) & 1);
    parity ^= 1u << st;
    __syncthreads();  // everyone is done with the other stage
    if (threadIdx.x == 0 && it + 1 < n) {  // the next tile loads while this one computes
      const int kn = (list[it + 1] & ~kFull) * kRows;
      mbar_expect(full + 8 * (st ^ 1), 2 * kTile);
      tma_tile<HDP>(sK(st ^ 1), &tk, kn, g, b, full + 8 * (st ^ 1));
      tma_tile<HDP>(sV(st ^ 1), &tv, kn, g, b, full + 8 * (st ^ 1));
    }
    const int entry = list[it];
    const int k0 = (entry & ~kFull) * kRows;

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

    // online softmax in log2 units; s[4j + e]: row e < 2 ? r0 : r1, slot
    // k0 + 8j + c0 + e % 2. A tile not flagged full masks element by
    // element with its slots' positions (-1 past T).
    const bool masked = !(entry & kFull);
    int kpv[16];
    if (masked) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int t = k0 + 8 * (i / 2) + c0 + i % 2;
        kpv[i] = t < Tn ? kp[t] : -1;
      }
    }
    float mx0 = rt::kNegInf, mx1 = rt::kNegInf;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      float x = rt::score_log2(s[i], scale_log2, softcap);
      if (masked && !visible(i % 4 < 2 ? qp0 : qp1, kpv[2 * (i / 4) + i % 2], window))
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

    // P (bf16) as the A fragment: slots 16kk.. are S columns of blocks 2kk, 2kk+1
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);

    // O += P V over the tile's 64 slots in steps of 16 (16 rows of 128 bytes)
    wg::fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_pv<HDP>(acc, pa[kk], wg::desc_sw128(sV(st) + kk * 16 * 128, kVLbo, kVSbo));
    wg::commit();
    wg::wait_all();
    wg::fence_operands(acc);
  }

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

// A [B, rows, heads, hd] bf16 tensor (element strides st, hd contiguous) as
// a TMA map of 64 x 64 boxes, 128-byte swizzled, zeros past the edges.
int make_map(CUtensorMap* map, const void* ptr, const Strides& st, int B, int rows, int heads,
             int hd) {
  using Encode = decltype(&cuTensorMapEncodeTiled);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", reinterpret_cast<void**>(&encode), cudaEnableDefault, &found);
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess || encode == nullptr) {
      encode = nullptr;
      return static_cast<int>(cudaErrorNotSupported);
    }
  }
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(hd), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(heads), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(st.s) * 2,
                                 static_cast<cuuint64_t>(st.h) * 2,
                                 static_cast<cuuint64_t>(st.b) * 2};
  const cuuint32_t box[4] = {64, kRows, 1, 1}, elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v, const int* q_pos, const int* k_pos,
                void* o, const Strides* st, int B, int H, int KV, int S, int Tn, int hd,
                int window, float softcap, cudaStream_t stream) {
  const int nk = (Tn + kRows - 1) / kRows;
  // Q, K x2, V x2, barriers, alignment; the plan's 4 + nk ints
  const int smem = 5 * kRows * HDP * 2 + 16 + 1024 + 4 * (4 + nk);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static int attr = 0;  // the largest size set so far
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        cache_bf16_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = smem;
  }
  CUtensorMap tq, tk, tv;
  int err = make_map(&tq, q, st[0], B, S, H, hd);
  if (err == 0) err = make_map(&tk, k, st[1], B, Tn, KV, hd);
  if (err == 0) err = make_map(&tv, v, st[2], B, Tn, KV, hd);
  if (err != 0) return err;
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  cache_bf16_kernel<HDP><<<grid, kWgThreads, smem, stream>>>(
      tq, tk, tv, q_pos, k_pos, static_cast<__nv_bfloat16*>(o), st[3], KV, S, Tn, hd, window,
      rt::kLog2e / sqrtf(static_cast<float>(hd)), softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// every other case: CUDA cores
// ---------------------------------------------------------------------------
// One block per (q tile of 64 rows, head, batch) walks the listed K/V tiles
// of 64 slots staged in shared memory as f32, rows padded to hd+1 so the
// 16x16 thread grid reads them without bank conflicts. Each thread owns a
// 4x4 block of the score tile and a 4 x hd/16 block of the output
// accumulator in registers.

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float as_v(float p);  // P as P V reads it
template <> __device__ __forceinline__ float as_v<float>(float p) { return p; }
template <> __device__ __forceinline__ float as_v<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// DPER: output columns a thread (hd <= 16 DPER)
template <typename T, int DPER>
__global__ void __launch_bounds__(kThreads)
cache_scalar_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                    T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int KV,
                    int S, int Tn, int hd, int window, float scale, float softcap) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* q_s = smem;                  // [kRows][hd+1]
  float* k_s = q_s + kRows * hdp;     // [kRows][hd+1]
  float* v_s = k_s + kRows * hdp;     // [kRows][hd]
  float* s_s = v_s + kRows * hd;      // [kRows][kRows+1]
  float* m_s = s_s + kRows * (kRows + 1);
  float* l_s = m_s + kRows;
  float* c_s = l_s + kRows;
  int* qp_s = reinterpret_cast<int*>(c_s + kRows);  // the rows' positions
  int* kp_s = qp_s + kRows;                          // the tile's slots' positions
  int* red = kp_s + kRows;
  int* list = red + 4;

  const int iq = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h % KV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = iq * kRows;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + g * ks.h;
  const T* vb = v + b * vs.b + g * vs.h;
  const int* qp = q_pos + static_cast<int64_t>(b) * S;
  const int* kp = k_pos + static_cast<int64_t>(b) * Tn;

  const int n = plan_tiles(qp, kp, q0, S, Tn, window, red, list);
  for (int e = tid; e < kRows * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    q_s[i * hdp + d] = (q0 + i < S) ? rt::to_f(qb[(q0 + i) * qs.s + d]) : 0.f;
  }
  for (int i = tid; i < kRows; i += kThreads) {
    qp_s[i] = q0 + i < S ? qp[q0 + i] : -1;  // a row past S sees nothing
    m_s[i] = rt::kNegInf;
    l_s[i] = 0.f;
  }
  float acc[4][DPER];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DPER; ++c) acc[a][c] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int k0 = (list[it] & ~kFull) * kRows;
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < kRows * hd; e += kThreads) {
      const int j = e / hd, d = e % hd;
      const bool in = k0 + j < Tn;
      k_s[j * hdp + d] = in ? rt::to_f(kb[(k0 + j) * ks.s + d]) : 0.f;
      v_s[j * hd + d] = in ? rt::to_f(vb[(k0 + j) * vs.s + d]) : 0.f;
    }
    for (int j = tid; j < kRows; j += kThreads) kp_s[j] = k0 + j < Tn ? kp[k0 + j] : -1;
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
        s_s[i * (kRows + 1) + j] = visible(qp_s[i], kp_s[j], window)
                                       ? rt::softcap(sc[a][c] * scale, softcap) : rt::kNegInf;
      }
    __syncthreads();
    // online softmax, one thread per query row; P as P V reads it (bf16
    // rounded for bf16 V), the row sum of the unrounded P
    for (int i = tid; i < kRows; i += kThreads) {
      float* row = s_s + i * (kRows + 1);
      const float m_prev = m_s[i];
      float mx = rt::kNegInf;
      for (int j = 0; j < kRows; ++j) mx = fmaxf(mx, row[j]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < kRows; ++j) {
        const float p = visible(qp_s[i], kp_s[j], window) ? expf(row[j] - m_new) : 0.f;
        row[j] = as_v<T>(p);
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
      for (int c = 0; c < DPER; ++c) acc[a][c] *= corr;
    }
    for (int j = 0; j < kRows; ++j) {
      float pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = s_s[(ty + 16 * a) * (kRows + 1) + j];
#pragma unroll
      for (int c = 0; c < DPER; ++c) {
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
    for (int c = 0; c < DPER; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) ob[(q0 + i) * os.s + d] = rt::from_f<T>(acc[a][c] * inv);
    }
  }
}

template <typename T, int DPER>
int launch_scalar(const void* q, const void* k, const void* v, const int* q_pos,
                  const int* k_pos, void* o, const Strides* st, int B, int H, int KV, int S,
                  int Tn, int hd, int window, float softcap, cudaStream_t stream) {
  const int hdp = hd + 1, nk = (Tn + kRows - 1) / kRows;
  const size_t smem =
      sizeof(float) * (2 * kRows * hdp + kRows * hd + kRows * (kRows + 1) + 3 * kRows) +
      sizeof(int) * (2 * kRows + 4 + nk);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  static size_t attr = 0;  // the largest size set so far
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        cache_scalar_kernel<T, DPER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = smem;
  }
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  cache_scalar_kernel<T, DPER><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      k_pos, static_cast<T*>(o), st[0], st[1], st[2], st[3], KV, S, Tn, hd, window,
      1.0f / sqrtf(static_cast<float>(hd)), softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64 (batch, sequence, head) strides of q, k, v, out, in
// elements; the head_dim stride is 1 for all four. bfloat16 takes the
// tensor cores where hd % 16 == 0, T > 0, the strides are multiples of 8
// and q, k, v start on 16 bytes (a tensor map's terms); else the CUDA
// cores. window, softcap: 0 = off.
extern "C" int rt_cache_attention(const void* q, const void* k, const void* v,
                                  const void* q_pos, const void* k_pos, void* out,
                                  const void* strides, int B, int H, int KV, int S, int T,
                                  int hd, int window, int dtype, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || T < 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* p = static_cast<const int64_t*>(strides);
  const Strides st[4] = {{p[0], p[1], p[2]}, {p[3], p[4], p[5]},
                         {p[6], p[7], p[8]}, {p[9], p[10], p[11]}};
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return (hd <= 128 ? launch_scalar<float, 8> : launch_scalar<float, 16>)(
        q, k, v, qp, kp, out, st, B, H, KV, S, T, hd, window, softcap, s);
  if (dtype != rt::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  bool tiles = hd % 16 == 0 && hd <= kMaxTileHd && T > 0;
  for (int i = 0; i < 9; ++i) tiles = tiles && p[i] % 8 == 0;
  for (const void* t : {q, k, v}) tiles = tiles && reinterpret_cast<uintptr_t>(t) % 16 == 0;
  if (!tiles)
    return (hd <= 128 ? launch_scalar<__nv_bfloat16, 8> : launch_scalar<__nv_bfloat16, 16>)(
        q, k, v, qp, kp, out, st, B, H, KV, S, T, hd, window, softcap, s);
  return (hd <= 64 ? launch_bf16<64> : launch_bf16<128>)(q, k, v, qp, kp, out, st, B, H, KV, S,
                                                         T, hd, window, softcap, s);
}

extern "C" int rt_cache_attention_max_hd() { return kMaxHd; }
