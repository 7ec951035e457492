// mma.sync m16n8k16 tiles (bf16 inputs, float32 accumulators) read from
// shared memory, shared by the scan kernels (mlstm_scan.cu, ssd_scan.cu):
// the fragments, float32 operands as bf16 hi + lo parts (the one place that
// rule is written), and the cp.async copies that stage a tile's rows.
// Fragments of m16n8k16, lane l = 4 g + q (g = l / 4, q = l % 4):
//   A (16 x 16, row-major) a0 = (g, 2q..2q+1), a1 = (g + 8, 2q..), a2 = (g,
//     2q + 8..), a3 = (g + 8, 2q + 8..);
//   B (16 x 8, k x n) b0 = (k 2q..2q+1, n g), b1 = (k 2q + 8.., n g);
//   C (16 x 8) c0 = (g, 2q), c1 = (g, 2q + 1), c2 = (g + 8, 2q), c3 = (g + 8, 2q + 1),
// so two C tiles side by side (columns 0-7, 8-15) are, pair by pair, the A
// fragment of a product over those 16 columns.
#pragma once

#include "common.cuh"

namespace rt {

// A matrix in shared memory read as (row, k): element (r, k) at p[r ld + k],
// or at p[k ld + r] when kT.
template <typename E, bool kT>
struct Mat {
  const E* p;
  int ld;
  __device__ __forceinline__ float at(int r, int k) const {
    return rt::to_f(kT ? p[k * ld + r] : p[r * ld + k]);
  }
  // bf16 only: elements (r, k) and (r, k + 1) as a pair, k even (not kT)
  __device__ __forceinline__ uint32_t pair(int r, int k) const {
    return *reinterpret_cast<const uint32_t*>(p + r * ld + k);
  }
  // bf16 only: this lane's m16n8k16 A fragment of rows m0.., k0.. (and,
  // frag_b, its B fragment of columns n0.., k0..); kT by ldmatrix.trans from
  // the rows k (rows and columns on 16 bytes)
  __device__ __forceinline__ void frag_a(uint32_t (&a)[4], int m0, int k0) const {
    const int lane = threadIdx.x & 31;
    if constexpr (kT) {
      const int q = lane >> 3;
      const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(
          p + (k0 + (q >> 1) * 8 + (lane & 7)) * ld + m0 + (q & 1) * 8));
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3]) : "r"(at) : "memory");
    } else {
      const int r = m0 + (lane >> 2), k = k0 + (lane & 3) * 2;
      a[0] = pair(r, k);
      a[1] = pair(r + 8, k);
      a[2] = pair(r, k + 8);
      a[3] = pair(r + 8, k + 8);
    }
  }
  __device__ __forceinline__ void frag_b(uint32_t (&b)[2], int n0, int k0) const {
    const int lane = threadIdx.x & 31;
    if constexpr (kT) {
      const uint32_t at = static_cast<uint32_t>(__cvta_generic_to_shared(
          p + (k0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * ld + n0));
      asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                   : "=r"(b[0]), "=r"(b[1]) : "r"(at) : "memory");
    } else {
      const int n = n0 + (lane >> 2), k = k0 + (lane & 3) * 2;
      b[0] = pair(n, k);
      b[1] = pair(n, k + 8);
    }
  }
};

__device__ __forceinline__ void mma16816(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// A float32 operand as the tensor cores take it: a bf16 hi part and a bf16
// lo part of the rest v - hi. A product of two such (hi hi + lo hi + hi lo;
// lo lo is below float32's rounding of the sum) keeps ~16 bits of each.

// (a, b)'s hi parts as a bf16 pair in hi, their lo parts in lo
__device__ __forceinline__ void split2(uint32_t& hi, uint32_t& lo, float a, float b) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const __nv_bfloat162 l = __floats2bfloat162_rn(a - __low2float(h), b - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// v's hi part at d and, kLo, its lo part lo elements on
template <bool kLo = true>
__device__ __forceinline__ void put_parts(__nv_bfloat16* d, int lo, float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  d[0] = hi;
  if constexpr (kLo) d[lo] = __float2bfloat16_rn(v - __bfloat162float(hi));
}

// (a, b)'s hi parts at d, d + 1 and their lo parts lo elements on (d on 4 bytes)
__device__ __forceinline__ void put2(__nv_bfloat16* d, int lo, float a, float b) {
  uint32_t h, l;
  split2(h, l, a, b);
  *reinterpret_cast<uint32_t*>(d) = h;
  *reinterpret_cast<uint32_t*>(d + lo) = l;
}

// The A fragment, hi and lo parts, of the [16 x 16] float32 tile held as two
// accumulators side by side (columns 0-7 in c0, 8-15 in c1).
__device__ __forceinline__ void split_a(uint32_t (&hi)[4], uint32_t (&lo)[4],
                                        const float (&c0)[4], const float (&c1)[4]) {
  split2(hi[0], lo[0], c0[0], c0[1]);
  split2(hi[1], lo[1], c0[2], c0[3]);
  split2(hi[2], lo[2], c1[0], c1[1]);
  split2(hi[3], lo[3], c1[2], c1[3]);
}

// c += A B over one k-step from hi parts and, kALo / kBLo, lo parts (else
// the operand is exact in bf16): hi hi + lo hi + hi lo, in that order.
template <bool kALo, bool kBLo>
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], const uint32_t (&bh)[2],
                                     const uint32_t (&bl)[2]) {
  mma16816(c, ah[0], ah[1], ah[2], ah[3], bh[0], bh[1]);
  if constexpr (kALo) mma16816(c, al[0], al[1], al[2], al[3], bh[0], bh[1]);
  if constexpr (kBLo) mma16816(c, ah[0], ah[1], ah[2], ah[3], bl[0], bl[1]);
}

// The A (B) fragment of a bf16 array in shared memory and, kLo, of its lo
// part lo elements on.
template <bool kLo, bool kT>
__device__ __forceinline__ void frags_a(uint32_t (&h)[4], uint32_t (&l)[4],
                                        Mat<__nv_bfloat16, kT> m, int lo, int m0, int k0) {
  m.frag_a(h, m0, k0);
  if constexpr (kLo) Mat<__nv_bfloat16, kT>{m.p + lo, m.ld}.frag_a(l, m0, k0);
}

template <bool kLo, bool kT>
__device__ __forceinline__ void frags_b(uint32_t (&h)[2], uint32_t (&l)[2],
                                        Mat<__nv_bfloat16, kT> m, int lo, int n0, int k0) {
  m.frag_b(h, n0, k0);
  if constexpr (kLo) Mat<__nv_bfloat16, kT>{m.p + lo, m.ld}.frag_b(l, n0, k0);
}

// 16 (4) bytes from global to shared memory by cp.async; cp16 with live
// false writes 16 zero bytes and reads nothing
__device__ __forceinline__ void cp16(void* dst, const void* src, bool live = true) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(live ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

// This thread's cp.async copies landed (a barrier then shows them to all).
__device__ __forceinline__ void cp_wait() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// c += A[m0 .. m0 + 16)[0, K) B[0, K)[n0 .. n0 + 8) at this lane's place in
// the m16n8 accumulator (rows m0 + lane / 4 (+ 8), columns n0 + 2 (lane % 4)
// (+ 1)); B read as (column, k). bf16 on the tensor cores (K a multiple of
// 16), float32 on the CUDA cores.
template <typename E, bool kTA, bool kTB>
__device__ __forceinline__ void tile(float (&c)[4], Mat<E, kTA> a, Mat<E, kTB> b, int m0,
                                     int n0, int K) {
  const int lane = threadIdx.x & 31, r = m0 + (lane >> 2), kq = (lane & 3) * 2;
  if constexpr (sizeof(E) == 2) {
#pragma unroll 4
    for (int k = 0; k < K; k += 16) {
      uint32_t fa[4], fb[2];
      a.frag_a(fa, m0, k);
      b.frag_b(fb, n0, k);
      mma16816(c, fa[0], fa[1], fa[2], fa[3], fb[0], fb[1]);
    }
  } else {
    const int n = n0 + kq;
#pragma unroll 4
    for (int k = 0; k < K; ++k) {
      const float a0 = a.at(r, k), a1 = a.at(r + 8, k), b0 = b.at(n, k), b1 = b.at(n + 1, k);
      c[0] = fmaf(a0, b0, c[0]);
      c[1] = fmaf(a0, b1, c[1]);
      c[2] = fmaf(a1, b0, c[2]);
      c[3] = fmaf(a1, b1, c[3]);
    }
  }
}

// c[j] += A B_j (j < NJ): the warp's 16 rows m0 of A against B's 8-column
// tiles at min(n0 + dn j, n_last), over K (a multiple of 16 in bf16), k
// outer and the tiles inner with no branch, so that consecutive mma.syncs
// go to independent accumulators (a tile past n_last repeats the last one,
// for the caller to drop). bf16: A and B in parts, kALo (kBLo): the lo part
// a_lo (b_lo) elements past the hi, else the operand is exact (mma3).
// float32: tile() for each, on the CUDA cores.
template <int NJ, bool kALo, bool kBLo, typename T, bool kTA, bool kTB>
__device__ __forceinline__ void tiles(float (&c)[NJ][4], Mat<T, kTA> a, int a_lo, Mat<T, kTB> b,
                                      int b_lo, int m0, int n0, int dn, int n_last, int K) {
  if constexpr (sizeof(T) == 2) {
    const Mat<T, kTA> al{a.p + a_lo, a.ld};
    const Mat<T, kTB> bl{b.p + b_lo, b.ld};
#pragma unroll 2
    for (int k = 0; k < K; k += 16) {
      uint32_t fa[4], fl[4];
      a.frag_a(fa, m0, k);
      if constexpr (kALo) al.frag_a(fl, m0, k);
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int n = min(n0 + dn * j, n_last);
        uint32_t fb[2], gb[2];
        b.frag_b(fb, n, k);
        if constexpr (kBLo) bl.frag_b(gb, n, k);
        mma3<kALo, kBLo>(c[j], fa, fl, fb, gb);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < NJ; ++j) tile(c[j], a, b, m0, min(n0 + dn * j, n_last), K);
  }
}

// tiles() with B a float32 matrix in shared memory, B(n, k) = bf[n ldb + k],
// split into hi + lo bf16 fragments as it loads (bf16 A in its two parts).
template <int NJ>
__device__ __forceinline__ void tiles_split_b(float (&c)[NJ][4], Mat<__nv_bfloat16, false> a,
                                              int a_lo, const float* bf, int ldb, int m0, int n0,
                                              int dn, int n_last, int K) {
  const int lane = threadIdx.x & 31, kq = (lane & 3) * 2;
  const Mat<__nv_bfloat16, false> al{a.p + a_lo, a.ld};
#pragma unroll 2
  for (int k = 0; k < K; k += 16) {
    uint32_t fa[4], fl[4];
    a.frag_a(fa, m0, k);
    al.frag_a(fl, m0, k);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int n = min(n0 + dn * j, n_last) + (lane >> 2);
      uint32_t bh[2], bl[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 x = *reinterpret_cast<const float2*>(bf + n * ldb + k + kq + 8 * h);
        split2(bh[h], bl[h], x.x, x.y);
      }
      mma3<true, true>(c[j], fa, fl, bh, bl);
    }
  }
}

}  // namespace rt
