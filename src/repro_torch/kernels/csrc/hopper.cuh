// Hopper helpers of the two attention kernels (flash_attention.cu,
// cache_attention.cu): mbarriers, TMA tile loads on tensor maps built from
// a tensor's strides, named barriers, register reallocation between
// warpgroups, and the P V product with P in registers. Shared-memory
// addresses are shared-space (__cvta_generic_to_shared).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "wgmma.cuh"

namespace hp {

// An mbarrier whose phase completes after `count` arrivals (and the bytes
// any arrival announced with mbar_expect).
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count = 1) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
// Make the initialised barriers visible to the async proxy (the TMA) and to
// the other threads of the CTA, which must still sync with the one that
// initialised them.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// One arrival that also announces `bytes` the TMA will complete on `bar`.
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
// One arrival where `pred` holds (release: this thread's earlier shared-
// memory writes are seen by a thread whose wait completes the phase); a
// predicated instruction, no branch.
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      ::"r"(bar), "r"(static_cast<int>(pred)) : "memory");
}
// Wait for the phase of the given parity to complete; every lane of the
// warp calls it. The loop is in the asm and its branches are uniform
// (bra.uni), so the compiler sees no divergent path: one there makes ptxas
// serialise the wgmmas after it (C7520). A copy that never lands (a bad
// tensor map) or an arrival that never comes traps instead of hanging the
// card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .u32 i;\nmov.u32 i, 0;\n"
      "WAIT:\nmbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@p bra.uni DONE;\nadd.u32 i, i, 1;\nsetp.gt.u32 p, i, 1048576;\n@p trap;\n"
      "bra.uni WAIT;\nDONE:\n}\n"
      ::"r"(bar), "r"(parity) : "memory");
}

// Named barriers (ids 1-15; 0 is __syncthreads'): `threads` (a multiple of
// 32) arrive in all, the ones that sync waiting for the rest.
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Registers a thread of this warpgroup may hold from here on (a multiple
// of 8 in [24, 256]); every warp of the warpgroup that exists executes it.
template <int N> __device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N> __device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// One box (columns c0.., rows row0..) of a [B, rows, heads, hd] tensor map,
// onto barrier `bar`.
__device__ __forceinline__ void tma_box(uint32_t dst, const CUtensorMap* map, int c0, int row0,
                                        int head, int b, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(row0), "r"(head), "r"(b),
        "r"(bar) : "memory");
}
// A tile: its 64-column blocks of kBlock bytes each (rows x 128 bytes, the
// map's box), each a box the TMA swizzles as it stores.
template <int HDP, uint32_t kBlock>
__device__ __forceinline__ void tma_tile(uint32_t tile, const CUtensorMap* map, int row0,
                                         int head, int b, uint32_t bar) {
#pragma unroll
  for (int cb = 0; cb < HDP / 64; ++cb)
    tma_box(tile + cb * kBlock, map, 64 * cb, row0, head, b, bar);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// O [64 x HDP] += P [64 x 16] V [16 x HDP], P in registers, V MN-major
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

// A [B, rows, heads, hd] bf16 tensor (element strides s_row, s_head, s_b;
// hd contiguous) as a TMA map of boxes of 64 columns x box_rows rows,
// 128-byte swizzled, zeros past the edges. The encoder comes from the
// driver through the runtime (cudaGetDriverEntryPoint): nothing links
// -lcuda. Returns a cudaError_t.
inline int make_map(CUtensorMap* map, const void* ptr, int B, int rows, int heads, int hd,
                    int64_t s_row, int64_t s_head, int64_t s_b, int box_rows = 64) {
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
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(s_row) * 2,
                                 static_cast<cuuint64_t>(s_head) * 2,
                                 static_cast<cuuint64_t>(s_b) * 2};
  const cuuint32_t box[4] = {64, static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace hp
