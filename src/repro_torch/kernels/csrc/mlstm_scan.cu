// The stabilised mLSTM recurrence, forward and backward, for Hopper: the
// whole time loop in one launch each.
//
// Replaces: the reference's lax.scan of src/repro/models/ssm.py ::
// mlstm_scan (the scan at :90, its step at :66), which XLA runs as one loop
// on the device; its gradient is XLA's reverse scan. Per (row b, head h),
// over q, k (scaled by 1/sqrt(d)), v [B,H,S,d] and the log gates log_i,
// log_f [B,H,S] (float32), from the state C [B,H,d,d], n [B,H,d], m [B,H]:
//   m_t = max(log_f + m, log_i) (log_i at the first step), i = exp(log_i -
//   m_t), f = exp(log_f + m - m_t) (0 at the first step), C = f C + i k v^T,
//   n = f n + i k, h = C^T q / max(|n . q|, exp(-m_t)),
// each h cast to q's dtype as it is written.
//
// Forward: chunkwise parallel. Only the stabiliser m is a chain, and it is
// a max-plus recurrence of the gates alone; the state update is linear. So
// the S steps become S / kL chunks of kL = 32 steps (the backward's
// checkpoint interval: a chunk's entry state is the checkpoint the backward
// reads). In a chunk with entry state (C0, n0, m0), F_t the sum of log_f
// over the chunk's steps up to t and D_ts = F_t - F_s (summed over (s, t]
// only, never as a difference of two sums, which would cancel):
//   m_t  = max(F_t + m0, max_{s<=t} (D_ts + log_i_s)), a warp's scan,
//   w_ts = exp(D_ts + log_i_s - m_t), c_t = exp(F_t + m0 - m_t) (0 when m0
//          = -inf), both <= 1 by construction of m_t,
//   h_t  = (sum_s w_ts (q_t . k_s) v_s + c_t q_t^T C0) / max(|nq_t|, exp(-m_t)),
//   nq_t = sum_s w_ts (q_t . k_s) + c_t q_t . n0, n_t = c_t n0 + sum_s w_ts k_s,
//   C    = c_last C0 + K^T (w_last . V), n = n_last, m = m_last.
// What bounds it: per (b, h) and chunk the products Q K^T, P V, Q C0 and
// K^T (w V) (~4 kL d^2 + 4 kL^2 d FLOPs, 0.6 MFLOP at d = 192) and the
// chain of S / kL chunks, each a few barriers of one CTA; the inputs are
// read once, so bytes bound a call at microseconds.
// Design: a CTA per (block of kFV = 32 value columns, h, b), 8 warps, its
// [d, kFV] slice of C in mma accumulators for the whole call. bfloat16
// runs the products as mma.sync m16n8k16 from shared memory; the float32
// operands (C0, P = w . (Q K^T), w V) go in as two bf16 parts, hi + lo, so
// a product keeps ~16 bits of them (a single bf16 rounding of C0 or P would
// cost 2^-9 of h). float32 inputs run the same tiles on the CUDA cores (TF32
// would miss their 1e-4). The O(kL) chain, w, n . q and the row sums of P
// are computed alike by every CTA of a (b, h) (the same order, the same
// bits), so no CTA waits on another: the reference's "TP over the VALUE dim
// ... every time step is collective-free". n_t's columns are split over
// the CTAs as v's are (its O(kL^2 d) sum on the CUDA cores). The next
// chunk's q, k, v and gates arrive by cp.async while this one computes.
// The decode step is a chunk of one step.
// Backward: the forward saves C at each chunk's start (ck), and n_t, m_t,
// n . q and h in float32 at every step (O(S d)). One CTA per (value block
// of kBV, h, b) walks the segments backwards: it recomputes the segment's
// C from its checkpoint into a scratch slice of its own, then steps back
// through it carrying dC (its columns, registers) and dn. dv is complete
// in the CTA; dq, dk and the gate gradients sum over the value dim, so
// each CTA writes its partials and a second launch sums them in a fixed
// order, then runs the scalar stabiliser chain (warp 0). No atomics: the
// gradients are the same bits run after run.
#include <initializer_list>

#include "xlstm.cuh"

namespace {

using rt::Gates;

constexpr int kBV = 16;          // value columns a backward CTA keeps
constexpr int kMaxD = 256;       // head width: one thread a key row in the backward
constexpr int kMaxWarps = kMaxD / 32;
constexpr int kMaxK = 64;        // checkpoint interval the backward takes
constexpr int kReduceThreads = 256;
constexpr int kReduceSteps = 16;  // steps a CTA of the second launch sums

constexpr int kL = 32;            // the forward's chunk: the checkpoint interval it saves
constexpr int kFV = 32;           // value (and n's key) columns a forward CTA takes
constexpr int kFwdThreads = 256;  // 8 warps
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kMaxTiles = kMaxD / 16 * (kFV / 8) / kFwdWarps;  // C's 16 x 8 tiles a warp
constexpr unsigned kFull = 0xffffffffu;

struct Fwd {
  const void *q, *k, *v;
  const float *li, *lf, *C0, *n0, *m0;
  void* h;
  float *C, *n, *m;
  float *ck, *n_all, *m_all, *nq_all, *h32;  // all null: nothing saved
  int B, H, S, d, vec;  // vec: rows and bases on 16 bytes, copied 16 bytes at a time
};

struct Bwd {
  const void *q, *k, *v, *dh;
  const float *li, *lf, *ck, *n_all, *m_all, *nq_all, *h32, *dC, *dn, *dm;
  void *dq, *dk, *dv;
  float *dli, *dlf, *dC0, *dn0, *dm0;
  float *scr, *dq_part, *dk_part, *di_part, *df_part, *ds, *dmden;
  int B, H, S, d, K, nx;
};

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

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

// A float32 operand into shared memory: as itself, or (bf16) as hi at dst
// and lo = v - hi at dst + lo_off.
template <typename T>
__device__ __forceinline__ void put(T* dst, int lo_off, float v) {
  if constexpr (sizeof(T) == 2) {
    const __nv_bfloat16 hi = __float2bfloat16_rn(v);
    dst[0] = hi;
    dst[lo_off] = __float2bfloat16_rn(v - __bfloat162float(hi));
  } else {
    dst[0] = v;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

// The forward's shared memory, byte offsets (each on 16 bytes) for a head
// width padded to DP (a multiple of 16). Q, K, V and the gates are
// double-buffered; C0, P, (w V)^T and w's copy hold kParts parts (bf16:
// hi, lo).
struct FwdLayout {
  int ld;  // row stride (elements) of Q and K: DP + 16 bytes
  size_t q[2], k[2], v[2], li[2], lf[2], c0, p, wv, wb, w, m, c, qn, rs, n0[2], bytes;
};

template <typename T>
__host__ __device__ inline FwdLayout fwd_layout(int DP) {
  constexpr int pad = 16 / sizeof(T), parts = sizeof(T) == 2 ? 2 : 1;
  FwdLayout s{};
  s.ld = DP + pad;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) / 16 * 16;
    return at;
  };
  for (int i = 0; i < 2; ++i) {
    s.q[i] = take(sizeof(T) * kL * s.ld);
    s.k[i] = take(sizeof(T) * kL * s.ld);
    s.v[i] = take(sizeof(T) * kL * (kFV + pad));
    s.li[i] = take(sizeof(float) * kL);
    s.lf[i] = take(sizeof(float) * kL);
  }
  s.c0 = take(sizeof(T) * parts * DP * (kFV + pad));
  s.p = take(sizeof(T) * parts * kL * (kL + pad));
  s.wv = take(sizeof(T) * parts * kFV * (kL + pad));
  s.wb = take(sizeof(T) * parts * kL * (kL + pad));
  s.w = take(sizeof(float) * kL * (kL + 1));
  s.m = take(sizeof(float) * kL);
  s.c = take(sizeof(float) * kL);
  s.qn = take(sizeof(float) * kL);
  s.rs = take(sizeof(float) * 4 * kL);
  s.n0[0] = take(sizeof(float) * DP);
  s.n0[1] = take(sizeof(float) * DP);
  s.bytes = o;
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kFwdThreads) mlstm_fwd_kernel(Fwd p) {
  constexpr bool kTC = sizeof(T) == 2;
  constexpr int pad = 16 / sizeof(T), ldS = kL + pad, ldV = kFV + pad;  // ldV: V's, C0's rows
  using M = Mat<T, false>;
  using MT = Mat<T, true>;
  const int x = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int d = p.d, S = p.S, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int DP = (d + 15) / 16 * 16, v0 = x * kFV, nv = min(kFV, d - v0);
  const int ntiles = DP / 16 * (kFV / 8), nc = (S + kL - 1) / kL;
  const FwdLayout L = fwd_layout<T>(DP);
  const int ld = L.ld;
  extern __shared__ __align__(16) char smem[];
  auto at = [&](size_t off) { return reinterpret_cast<T*>(smem + off); };
  auto atf = [&](size_t off) { return reinterpret_cast<float*>(smem + off); };
  auto pick = [](const size_t (&off)[2], int i) { return i ? off[1] : off[0]; };  // no local copy
  T* sC0 = at(L.c0);   // C0 [DP][ldV] (+ lo)
  T* sP = at(L.p);     // P [kL][ldS] (+ lo)
  T* sWV = at(L.wv);   // (w V)^T [kFV][ldS] (+ lo)
  T* sWb = at(L.wb);   // w [kL][ldS] (+ lo), the A operand of n's product
  float* sW = atf(L.w);  // w [kL][kL + 1]
  float *sM = atf(L.m), *sC = atf(L.c), *sQn = atf(L.qn), *sRs = atf(L.rs);
  const long bh = static_cast<long>(b) * p.H + hh;
  const T* q = static_cast<const T*>(p.q) + bh * S * d;
  const T* k = static_cast<const T*>(p.k) + bh * S * d;
  const T* v = static_cast<const T*>(p.v) + bh * S * d;
  const float* li = p.li + bh * S;
  const float* lf = p.lf + bh * S;
  T* h = static_cast<T*>(p.h) + bh * S * d;
  const bool save = p.ck != nullptr;

  for (size_t i = tid; i < L.bytes / 16; i += kFwdThreads)  // zeros past d, S and kFV
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // the chunk kc's q, k, v columns, log gates into buffer buf; rows past S zero
  auto load_chunk = [&](int kc, int buf) {
    const int t0 = kc * kL, Lk = min(kL, S - t0);
    T *dq = at(pick(L.q, buf)), *dk = at(pick(L.k, buf)), *dv = at(pick(L.v, buf));
    if (p.vec) {
      const int per = d / pad, pv = nv / pad;  // 16-byte pieces of a row, of its v slice
      for (int i = tid; i < Lk * per; i += kFwdThreads) {
        const int t = i / per, c = (i % per) * pad;
        cp_async16(dq + t * ld + c, q + static_cast<long>(t0 + t) * d + c);
        cp_async16(dk + t * ld + c, k + static_cast<long>(t0 + t) * d + c);
      }
      for (int i = tid; i < Lk * pv; i += kFwdThreads) {
        const int t = i / pv, c = (i % pv) * pad;
        cp_async16(dv + t * ldV + c, v + static_cast<long>(t0 + t) * d + v0 + c);
      }
    } else {
      for (int i = tid; i < Lk * d; i += kFwdThreads) {
        const int t = i / d, c = i % d;
        dq[t * ld + c] = q[static_cast<long>(t0 + t) * d + c];
        dk[t * ld + c] = k[static_cast<long>(t0 + t) * d + c];
      }
      for (int i = tid; i < Lk * nv; i += kFwdThreads) {
        const int t = i / nv, c = i % nv;
        dv[t * ldV + c] = v[static_cast<long>(t0 + t) * d + v0 + c];
      }
    }
    for (int i = tid; i < Lk; i += kFwdThreads) {
      cp_async4(atf(pick(L.li, buf)) + i, li + t0 + i);
      cp_async4(atf(pick(L.lf, buf)) + i, lf + t0 + i);
    }
    const T zero = rt::from_f<T>(0.f);
    for (int i = tid; i < (kL - Lk) * ld; i += kFwdThreads) {
      dq[Lk * ld + i] = zero;
      dk[Lk * ld + i] = zero;
    }
    for (int i = tid; i < (kL - Lk) * ldV; i += kFwdThreads) dv[Lk * ldV + i] = zero;
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // C's slice in accumulators: tile i = warp + 8 j is C[16 (i / 4) .., 8 (i % 4) ..]
  // (key rows, value columns); element e of the lane at row 16 (i / 4) +
  // lane / 4 + 8 (e / 2), column 8 (i % 4) + 2 (lane % 4) + e % 2
  float acc[kMaxTiles][4];
  auto rc = [&](int j, int e, int& key, int& col) {
    const int i = warp + kFwdWarps * j;
    key = (i >> 2) * 16 + (lane >> 2) + (e >> 1) * 8;
    col = (i & 3) * 8 + (lane & 3) * 2 + (e & 1);
  };
  auto live = [&](int j) { return warp + kFwdWarps * j < ntiles; };
  const long cbase = bh * d * d + v0;
#pragma unroll
  for (int j = 0; j < kMaxTiles; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int key, col;
      rc(j, e, key, col);
      acc[j][e] = live(j) && key < d && col < nv ? p.C0[cbase + static_cast<long>(key) * d + col]
                                                 : 0.f;
    }
  const bool even = d % 2 == 0;  // (key, col), (key, col + 1) as one 8-byte store
  auto store_c = [&](float* dst, int j0, int j1) {  // tiles j0 .. j1 - 1
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        int key, col;
        rc(j, e, key, col);
        if (j < j0 || j >= j1 || !live(j) || key >= d || col >= nv) continue;
        float* o = dst + cbase + static_cast<long>(key) * d + col;
        if (even && col + 1 < nv) {
          *reinterpret_cast<float2*>(o) = make_float2(acc[j][e], acc[j][e + 1]);
        } else {
          o[0] = acc[j][e];
          if (col + 1 < nv) o[1] = acc[j][e + 1];
        }
      }
  };
  auto put_c0 = [&]() {  // C0 [key][col] for Q C0's B operand
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        int key, col;
        rc(j, e, key, col);
        if (!live(j)) continue;
        T* o = sC0 + key * ldV + col;
        if constexpr (kTC) {
          const __nv_bfloat162 hi = __floats2bfloat162_rn(acc[j][e], acc[j][e + 1]);
          *reinterpret_cast<__nv_bfloat162*>(o) = hi;
          *reinterpret_cast<__nv_bfloat162*>(o + DP * ldV) = __floats2bfloat162_rn(
              acc[j][e] - __low2float(hi), acc[j][e + 1] - __high2float(hi));
        } else {
          o[0] = acc[j][e];
          o[1] = acc[j][e + 1];
        }
      }
  };

  float m0 = p.m0[bh];
  for (int i = tid; i < d; i += kFwdThreads) atf(L.n0[0])[i] = p.n0[bh * d + i];
  if (save) {
    for (int i = tid; i < nv; i += kFwdThreads)
      p.n_all[bh * (S + 1) * d + v0 + i] = p.n0[bh * d + v0 + i];
    if (x == 0 && tid == 0) p.m_all[bh * (S + 1)] = m0;
  }
  put_c0();
  if (nc > 0) load_chunk(0, 0);

  const int mt = warp >> 2, nt = warp & 3;  // this warp's 16 x 8 tile of the [kL, kFV] outputs
  const int r0 = mt * 16 + (lane >> 2), c0 = nt * 8 + (lane & 3) * 2;
  for (int kc = 0; kc < nc; ++kc) {
    const int cb = kc & 1, t0 = kc * kL, Lk = min(kL, S - t0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk kc landed; chunk kc - 1's reads of every buffer done
    if (kc + 1 < nc) load_chunk(kc + 1, cb ^ 1);
    // the entry state is saved in three parts, one a phase, so that the
    // stores drain while the chunk computes
    float* ck_kc = save ? p.ck + static_cast<long>(kc) * p.B * p.H * d * d : nullptr;
    const T *sq = at(pick(L.q, cb)), *sk = at(pick(L.k, cb)), *sv = at(pick(L.v, cb));
    const float *cli = atf(pick(L.li, cb)), *clf = atf(pick(L.lf, cb));
    const float* n0 = atf(pick(L.n0, cb));

    // the stabiliser chain, every warp alike: an inclusive scan of the
    // maps m -> max(log_f + m, log_i); lane t ends with (F_t, max_s (D_ts +
    // log_i_s)) and takes m_t, c_t
    float A = lane < Lk ? clf[lane] : 0.f;
    float Bm = lane < Lk ? cli[lane] : -__int_as_float(0x7f800000);  // -inf
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float a2 = __shfl_up_sync(kFull, A, o), b2 = __shfl_up_sync(kFull, Bm, o);
      if (lane >= o) {
        Bm = fmaxf(A + b2, Bm);
        A += a2;
      }
    }
    const float mt_l = fmaxf(A + m0, Bm);
    const float ct_l = isinf(m0) ? 0.f : expf((A + m0) - mt_l);
    if (save) store_c(ck_kc, 0, kMaxTiles / 3);
    const float m_last = __shfl_sync(kFull, mt_l, Lk - 1);
    const float c_last = __shfl_sync(kFull, ct_l, Lk - 1);
    if (warp == 0 && lane < Lk) {
      sM[lane] = mt_l;
      sC[lane] = ct_l;
    }
    {  // w: thread (row t, keys s0 .. s0 + 3), D_ts summed down from t
      const int t = tid >> 3, s0 = (tid & 7) * 4;
      const float m_t = __shfl_sync(kFull, mt_l, t);
      float dsum = 0.f;
#pragma unroll 4
      for (int r = t; r > s0 + 3; --r) dsum += clf[r];
#pragma unroll
      for (int s = s0 + 3; s >= s0; --s) {
        const bool in = s <= t && t < Lk;
        const float w = in ? expf(dsum + cli[s] - m_t) : 0.f;
        sW[t * (kL + 1) + s] = w;
        put(sWb + t * ldS + s, kL * ldS, w);
        if (in) dsum += clf[s];
      }
    }
    float sacc[4] = {}, qc[4] = {}, qc_lo[4] = {};  // Q K^T, Q C0 (hi, lo)
    if constexpr (kTC) {  // the three products share Q's fragments
      const M A{sq, ld}, Bk{sk, ld};
      const MT Bh{sC0, ldV}, Bl{sC0 + DP * ldV, ldV};
#pragma unroll 2
      for (int k = 0; k < DP; k += 16) {
        uint32_t a[4], bk[2], bh[2], bl[2];
        A.frag_a(a, mt * 16, k);
        Bk.frag_b(bk, nt * 8, k);
        Bh.frag_b(bh, nt * 8, k);
        Bl.frag_b(bl, nt * 8, k);
        mma16816(sacc, a[0], a[1], a[2], a[3], bk[0], bk[1]);
        mma16816(qc, a[0], a[1], a[2], a[3], bh[0], bh[1]);
        mma16816(qc_lo, a[0], a[1], a[2], a[3], bl[0], bl[1]);
      }
    } else {
      tile(sacc, M{sq, ld}, M{sk, ld}, mt * 16, nt * 8, DP);
      tile(qc, M{sq, ld}, MT{sC0, ldV}, mt * 16, nt * 8, DP);
    }
    __syncthreads();  // w, m_t, c_t written
    if (save) store_c(ck_kc, kMaxTiles / 3, 2 * kMaxTiles / 3);

    {  // P = w . (Q K^T) at this lane's places; its row sums by column tile
      float pr[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >> 1) * 8, s = c0 + (e & 1);
        pr[e] = sW[r * (kL + 1) + s] * sacc[e];
        put(sP + r * ldS + s, kL * ldS, pr[e]);
      }
      float rs0 = pr[0] + pr[1], rs1 = pr[2] + pr[3];
      rs0 += __shfl_xor_sync(kFull, rs0, 1);
      rs1 += __shfl_xor_sync(kFull, rs1, 1);
      rs0 += __shfl_xor_sync(kFull, rs0, 2);
      rs1 += __shfl_xor_sync(kFull, rs1, 2);
      if ((lane & 3) == 0) {
        sRs[nt * kL + r0] = rs0;
        sRs[nt * kL + r0 + 8] = rs1;
      }
    }
#pragma unroll
    for (int i = 0; i < kL * kFV / kFwdThreads; ++i) {  // (w_last V)^T
      const int col = tid & 31, s = (tid >> 5) + kFwdWarps * i;
      put(sWV + col * ldS + s, kFV * ldS,
          sW[(Lk - 1) * (kL + 1) + s] * rt::to_f(sv[s * ldV + col]));
    }
    {  // q_t . n0, 8 lanes a row
      const int t = tid >> 3;
      float a0 = 0.f, a1 = 0.f;  // q and n0 are zero from d to DP
#pragma unroll 4
      for (int key = tid & 7; key < DP; key += 16) {
        a0 = fmaf(rt::to_f(sq[t * ld + key]), n0[key], a0);
        a1 = fmaf(rt::to_f(sq[t * ld + key + 8]), n0[key + 8], a1);
      }
      float a = a0 + a1;
      a += __shfl_xor_sync(kFull, a, 1);
      a += __shfl_xor_sync(kFull, a, 2);
      a += __shfl_xor_sync(kFull, a, 4);
      if ((tid & 7) == 0) sQn[t] = a;
    }
    // n_t = c_t n0 + w K: the saved rows, this CTA's key columns (as v's),
    // on the tensor cores; and the next n0, every key of the last row, on
    // the CUDA cores (the same arithmetic in every CTA)
    if (save) {
      float nr[4] = {};
      tile(nr, M{sWb, ldS}, MT{sk + v0, ld}, mt * 16, nt * 8, kL);
      if constexpr (kTC) tile(nr, M{sWb + kL * ldS, ldS}, MT{sk + v0, ld}, mt * 16, nt * 8, kL);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int t = r0 + (e >> 1) * 8, key = c0 + (e & 1);
        if (t < Lk && key < nv)
          p.n_all[(bh * (S + 1) + t0 + t + 1) * d + v0 + key] = fmaf(sC[t], n0[v0 + key], nr[e]);
      }
    }
    for (int key = tid; key < d; key += kFwdThreads) {
      float a = 0.f;
#pragma unroll
      for (int s = 0; s < kL; ++s)  // w_last,s = 0 past Lk - 1
        a = fmaf(sW[(Lk - 1) * (kL + 1) + s], rt::to_f(sk[s * ld + key]), a);
      atf(pick(L.n0, cb ^ 1))[key] = fmaf(c_last, n0[key], a);
    }
    __syncthreads();  // P, (w V)^T, the row sums and q . n0 written
    if (save) store_c(ck_kc, 2 * kMaxTiles / 3, kMaxTiles);

    auto nq_at = [&](int t) {
      return fmaf(sC[t], sQn[t], ((sRs[t] + sRs[kL + t]) + sRs[2 * kL + t]) + sRs[3 * kL + t]);
    };
    {  // h = (P V + c_t Q C0) / max(|nq_t|, exp(-m_t))
      float pv[4] = {};
      tile(pv, M{sP, ldS}, MT{sv, ldV}, mt * 16, nt * 8, kL);
      if constexpr (kTC) tile(pv, M{sP + kL * ldS, ldS}, MT{sv, ldV}, mt * 16, nt * 8, kL);
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int t = r0 + 8 * e2;
        if (t >= Lk) continue;
        const float den = fmaxf(fabsf(nq_at(t)), expf(-sM[t]));
        if (c0 >= nv) continue;
        const int e = 2 * e2;
        const float h0 = fmaf(sC[t], qc[e] + qc_lo[e], pv[e]) / den;
        const float h1 = fmaf(sC[t], qc[e + 1] + qc_lo[e + 1], pv[e + 1]) / den;
        const long o = static_cast<long>(t0 + t) * d + v0 + c0;
        if (even && c0 + 1 < nv) {
          if constexpr (kTC)
            *reinterpret_cast<__nv_bfloat162*>(h + o) = __floats2bfloat162_rn(h0, h1);
          else
            *reinterpret_cast<float2*>(h + o) = make_float2(h0, h1);
          if (save) *reinterpret_cast<float2*>(p.h32 + bh * S * d + o) = make_float2(h0, h1);
        } else {
          h[o] = rt::from_f<T>(h0);
          if (save) p.h32[bh * S * d + o] = h0;
          if (c0 + 1 < nv) {
            h[o + 1] = rt::from_f<T>(h1);
            if (save) p.h32[bh * S * d + o + 1] = h1;
          }
        }
      }
    }
    if (save && x == 0 && tid < Lk) {
      p.nq_all[bh * S + t0 + tid] = nq_at(tid);
      p.m_all[bh * (S + 1) + t0 + tid + 1] = sM[tid];
    }
    // C = c_last C0 + K^T (w_last V)
#pragma unroll
    for (int j = 0; j < kMaxTiles; ++j) {
      if (!live(j)) continue;
      const int i = warp + kFwdWarps * j;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= c_last;
      tile(acc[j], MT{sk, ld}, M{sWV, ldS}, (i >> 2) * 16, (i & 3) * 8, kL);
      if constexpr (kTC) tile(acc[j], MT{sk, ld}, M{sWV + kFV * ldS, ldS}, (i >> 2) * 16,
                              (i & 3) * 8, kL);
    }
    put_c0();  // C0's last reads were before the second barrier
    m0 = m_last;
  }
  __syncthreads();
  store_c(p.C, 0, kMaxTiles);
  if (x == 0) {
    for (int i = tid; i < d; i += kFwdThreads) p.n[bh * d + i] = atf(pick(L.n0, nc & 1))[i];
    if (tid == 0) p.m[bh] = m0;
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

// What a backward step reads, loaded a step ahead: the recompute's
// (k, v, the gates, this thread's dh h) and the step back's (the rest).
struct RecIn {
  float k, li, lf, mp, mt, g, v[kBV];
};

struct BackIn {
  float q, k, li, lf, mp, mt, nq, np, v[kBV], dh[kBV], Cp[kBV];
};

// The backward's first launch: grid and threads as the forward's.
template <typename T>
__global__ void __launch_bounds__(kMaxD) mlstm_bwd_kernel(Bwd p) {
  const int x = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int d = p.d, S = p.S, K = p.K, row = threadIdx.x, lane = row & 31, warp = row >> 5;
  const int nt = blockDim.x, nw = nt >> 5, v0 = x * kBV;
  const long bh = static_cast<long>(b) * p.H + hh, BH = static_cast<long>(p.B) * p.H;
  const T* q = static_cast<const T*>(p.q) + bh * S * d;
  const T* k = static_cast<const T*>(p.k) + bh * S * d;
  const T* v = static_cast<const T*>(p.v) + bh * S * d;
  const T* dh = static_cast<const T*>(p.dh) + bh * S * d;
  const float* li = p.li + bh * S;
  const float* lf = p.lf + bh * S;
  const float* n_all = p.n_all + bh * (S + 1) * d;
  const float* m_all = p.m_all + bh * (S + 1);
  const float* h32 = p.h32 + bh * S * d;
  T* dv = static_cast<T*>(p.dv) + bh * S * d;
  float* dq_part = p.dq_part + (x * BH + bh) * S * d;
  float* dk_part = p.dk_part + (x * BH + bh) * S * d;
  // this CTA's scratch: [K][threads][kBV], each thread its own 16 floats
  float* scr = p.scr + ((bh * p.nx + x) * K * nt + row) * kBV;
  __shared__ float red[2][kMaxWarps][kBV + 2];
  __shared__ float gsum[kMaxWarps][kMaxK];

  auto load_rec = [&](RecIn& in, int t) {
    const long o = static_cast<long>(t) * d;
    in.k = row < d ? rt::to_f(k[o + row]) : 0.f;
    in.g = row < d ? rt::to_f(dh[o + row]) * h32[o + row] : 0.f;
    in.li = li[t];
    in.lf = lf[t];
    in.mp = m_all[t];
    in.mt = m_all[t + 1];
#pragma unroll
    for (int j = 0; j < kBV; ++j) in.v[j] = v0 + j < d ? rt::to_f(v[o + v0 + j]) : 0.f;
  };
  auto load_back = [&](BackIn& in, int t, int s) {
    const long o = static_cast<long>(t) * d;
    in.q = row < d ? rt::to_f(q[o + row]) : 0.f;
    in.k = row < d ? rt::to_f(k[o + row]) : 0.f;
    in.np = row < d ? n_all[o + row] : 0.f;  // n_{t-1}: slot t of [S + 1]
    in.li = li[t];
    in.lf = lf[t];
    in.mp = m_all[t];
    in.mt = m_all[t + 1];
    in.nq = p.nq_all[bh * S + t];
#pragma unroll
    for (int j = 0; j < kBV; ++j) {
      const bool col = v0 + j < d;
      in.v[j] = col ? rt::to_f(v[o + v0 + j]) : 0.f;
      in.dh[j] = col ? rt::to_f(dh[o + v0 + j]) : 0.f;
    }
    const float4* c4 = reinterpret_cast<const float4*>(scr + static_cast<long>(s) * nt * kBV);
#pragma unroll
    for (int j = 0; j < kBV / 4; ++j) {
      const float4 cj = c4[j];
      in.Cp[4 * j] = cj.x;
      in.Cp[4 * j + 1] = cj.y;
      in.Cp[4 * j + 2] = cj.z;
      in.Cp[4 * j + 3] = cj.w;
    }
  };

  float C[kBV], dC[kBV];
  const long c_off = bh * d * d + static_cast<long>(row) * d + v0;
#pragma unroll
  for (int j = 0; j < kBV; ++j) dC[j] = row < d && v0 + j < d ? p.dC[c_off + j] : 0.f;
  float dn = row < d ? p.dn[bh * d + row] : 0.f;

  for (int seg = (S + K - 1) / K - 1; seg >= 0; --seg) {
    const int t0 = seg * K, L = min(K, S - t0);
    __syncthreads();  // the previous segment's gsum and red are read
    const float* ck = p.ck + static_cast<long>(seg) * BH * d * d + c_off;
#pragma unroll
    for (int j = 0; j < kBV; ++j) C[j] = row < d && v0 + j < d ? ck[j] : 0.f;
    // recompute the segment: C_{t-1} of each step to scratch; and the sums
    // g_t = sum_v dh_t h_t that the denominator's gradient takes
    RecIn rn, rc;
    load_rec(rn, t0);
    for (int s = 0; s < L; ++s) {
      rc = rn;
      if (s + 1 < L) load_rec(rn, t0 + s + 1);
      float4* out = reinterpret_cast<float4*>(scr + static_cast<long>(s) * nt * kBV);
#pragma unroll
      for (int j = 0; j < kBV / 4; ++j)
        out[j] = make_float4(C[4 * j], C[4 * j + 1], C[4 * j + 2], C[4 * j + 3]);
      const Gates g = rt::gates_at(rc.li, rc.lf, rc.mp, rc.mt);
#pragma unroll
      for (int j = 0; j < kBV; ++j) C[j] = g.f * C[j] + g.i * (rc.k * rc.v[j]);
      const float gp = rt::warp_sum(rc.g);
      if (lane == 0) gsum[warp][s] = gp;
    }
    __syncthreads();
    BackIn bn, bc;
    load_back(bn, t0 + L - 1, L - 1);
    for (int s = L - 1; s >= 0; --s) {
      const int t = t0 + s;
      const long o = static_cast<long>(t) * d;
      bc = bn;
      if (s > 0) load_back(bn, t - 1, s - 1);
      float gt = 0.f;
      for (int w = 0; w < nw; ++w) gt += gsum[w][s];
      const float e = expf(-bc.mt), an = fabsf(bc.nq), den = fmaxf(an, e);
      const float dden = -gt / den, rden = 1.f / den;
      const float ds = dden * rt::tie(an, e) * (bc.nq > 0.f ? 1.f : (bc.nq < 0.f ? -1.f : 0.f));
      const float dmden = -e * dden * rt::tie(e, an);
      const Gates g = rt::gates_at(bc.li, bc.lf, bc.mp, bc.mt);
      float dqp = 0.f, dcv = 0.f, dfp = 0.f, part[kBV + 2];
#pragma unroll
      for (int j = 0; j < kBV; ++j) {
        const float dnum = bc.dh[j] * rden;
        dC[j] += bc.q * dnum;
        dqp += C[j] * dnum;
        dcv += dC[j] * bc.v[j];
        dfp += dC[j] * bc.Cp[j];
        part[j] = dC[j] * bc.k;
      }
      dn += ds * bc.q;
      part[kBV] = bc.k * dcv;
      part[kBV + 1] = dfp;
      if (x == 0) {  // the dn terms, once a (b, h)
        part[kBV] += dn * bc.k;
        part[kBV + 1] += dn * bc.np;
      }
      if (row < d) {
        dq_part[o + row] = dqp;
        dk_part[o + row] = g.i * (dcv + (x == 0 ? dn : 0.f));
      }
#pragma unroll
      for (int j = 0; j < kBV + 2; ++j) part[j] = rt::warp_sum(part[j]);
      float(*r)[kBV + 2] = red[s & 1];
      if (lane == 0) {
#pragma unroll
        for (int j = 0; j < kBV + 2; ++j) r[warp][j] = part[j];
      }
      __syncthreads();
      if (row < kBV + 2) {
        float sum = 0.f;
        for (int w = 0; w < nw; ++w) sum += r[w][row];
        if (row < kBV) {
          if (v0 + row < d) dv[o + v0 + row] = rt::from_f<T>(g.i * sum);
        } else {
          (row == kBV ? p.di_part : p.df_part)[(x * BH + bh) * S + t] = sum;
        }
      }
      if (x == 0 && row == kBV + 2) {
        p.ds[bh * S + t] = ds;
        p.dmden[bh * S + t] = dmden;
      }
#pragma unroll
      for (int j = 0; j < kBV; ++j) {
        dC[j] *= g.f;
        C[j] = bc.Cp[j];
      }
      dn *= g.f;
    }
  }
#pragma unroll
  for (int j = 0; j < kBV; ++j)
    if (row < d && v0 + j < d) p.dC0[c_off + j] = dC[j];
  if (x == 0 && row < d) p.dn0[bh * d + row] = dn;
}

// The backward's second launch, a CTA per (kReduceSteps steps, b, h): dq
// and dk summed over the value blocks (in block order) with their dn
// terms; the first CTA of each (b, h) then sums the gate gradients and runs
// the stabiliser chain.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) mlstm_bwd_reduce_kernel(Bwd p) {
  const long bh = blockIdx.y, BH = static_cast<long>(p.B) * p.H;
  const int d = p.d, S = p.S, nx = p.nx, tid = threadIdx.x;
  const long sd = static_cast<long>(S) * d;
  T* dq = static_cast<T*>(p.dq) + bh * sd;
  T* dk = static_cast<T*>(p.dk) + bh * sd;
  const long i1 = min(sd, static_cast<long>(blockIdx.x + 1) * kReduceSteps * d);
  for (long i = blockIdx.x * kReduceSteps * d + tid; i < i1; i += blockDim.x) {
    const long t = i / d, kx = i % d;
    float sq = 0.f, sk = 0.f;
    for (int x = 0; x < nx; ++x) {
      sq += p.dq_part[(x * BH + bh) * sd + i];
      sk += p.dk_part[(x * BH + bh) * sd + i];
    }
    sq += p.ds[bh * S + t] * p.n_all[(bh * (S + 1) + t + 1) * d + kx];
    dq[i] = rt::from_f<T>(sq);
    dk[i] = rt::from_f<T>(sk);
  }
  if (blockIdx.x != 0) return;
  for (int t = tid; t < S; t += blockDim.x) {  // into block 0's slot
    float si = 0.f, sf = 0.f;
    for (int x = 0; x < nx; ++x) {
      si += p.di_part[(x * BH + bh) * S + t];
      sf += p.df_part[(x * BH + bh) * S + t];
    }
    p.di_part[bh * S + t] = si;
    p.df_part[bh * S + t] = sf;
  }
  __syncthreads();
  if (tid >= 32) return;
  // the chain, 32 steps at a time: lane l loads step tc - l, then every
  // lane runs the 32 steps alike on values broadcast by shuffles
  const float* li = p.li + bh * S;
  const float* lf = p.lf + bh * S;
  const float* m_all = p.m_all + bh * (S + 1);
  float dm = p.dm[bh];
  for (int tc = S - 1; tc >= 0; tc -= 32) {
    const int t = tc - tid;
    const bool ok = t >= 0;
    const float a_li = ok ? li[t] : 0.f, a_lf = ok ? lf[t] : 0.f;
    const float a_mp = ok ? m_all[t] : 0.f, a_mt = ok ? m_all[t + 1] : 0.f;
    const float a_di = ok ? p.di_part[bh * S + t] : 0.f;
    const float a_df = ok ? p.df_part[bh * S + t] : 0.f;
    const float a_dd = ok ? p.dmden[bh * S + t] : 0.f;
    float my_li = 0.f, my_lf = 0.f;
    const int cnt = min(32, tc + 1);
    for (int j = 0; j < cnt; ++j) {
      const float sli = __shfl_sync(0xffffffffu, a_li, j);
      const float slf = __shfl_sync(0xffffffffu, a_lf, j);
      const float smp = __shfl_sync(0xffffffffu, a_mp, j);
      const float smt = __shfl_sync(0xffffffffu, a_mt, j);
      const float sdi = __shfl_sync(0xffffffffu, a_di, j);
      const float sdf = __shfl_sync(0xffffffffu, a_df, j);
      const float sdd = __shfl_sync(0xffffffffu, a_dd, j);
      float dli, dlf;
      dm = rt::gates_bwd(sli, slf, smp, smt, sdi, sdf, dm + sdd, dli, dlf);
      if (tid == j) {
        my_li = dli;
        my_lf = dlf;
      }
    }
    if (ok) {
      p.dli[bh * S + t] = my_li;
      p.dlf[bh * S + t] = my_lf;
    }
  }
  if (tid == 0) p.dm0[bh] = dm;
}


int threads_for(int d) { return (d + 31) / 32 * 32; }

template <typename T>
int launch_fwd(const Fwd& p, cudaStream_t st) {
  const size_t bytes = fwd_layout<T>((p.d + 15) / 16 * 16).bytes;
  static size_t allowed = 0;  // the largest size set yet: a smaller call sets nothing
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        mlstm_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = bytes;
  }
  const dim3 grid((p.d + kFV - 1) / kFV, p.H, p.B);
  mlstm_fwd_kernel<T><<<grid, kFwdThreads, bytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_mlstm_max_d() { return kMaxD; }
extern "C" int rt_mlstm_block_v() { return kBV; }
// The forward's chunk, the checkpoint interval of the saves it writes.
extern "C" int rt_mlstm_chunk() { return kL; }

extern "C" int rt_mlstm_fwd(const void* q, const void* k, const void* v, const void* li,
                            const void* lf, const void* C0, const void* n0, const void* m0,
                            void* h, void* C, void* n, void* m, void* ck, void* n_all,
                            void* m_all, void* nq_all, void* h32, int B, int H, int S, int d,
                            int dtype, void* stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t es = dtype == rt::kBF16 ? 2 : 4;
  bool vec = d * es % 16 == 0;
  for (const void* t : {q, k, v}) vec = vec && reinterpret_cast<uintptr_t>(t) % 16 == 0;
  Fwd p{q, k, v, static_cast<const float*>(li), static_cast<const float*>(lf),
        static_cast<const float*>(C0), static_cast<const float*>(n0),
        static_cast<const float*>(m0), h, static_cast<float*>(C), static_cast<float*>(n),
        static_cast<float*>(m), static_cast<float*>(ck), static_cast<float*>(n_all),
        static_cast<float*>(m_all), static_cast<float*>(nq_all), static_cast<float*>(h32),
        B, H, S, d, vec ? 1 : 0};
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == rt::kBF16 ? launch_fwd<__nv_bfloat16>(p, st) : launch_fwd<float>(p, st);
}

// Both launches of the backward. Scratch (float32, the wrapper's): scr
// [B*H*nx, K, threads, kBV]; dq_part, dk_part [nx, B, H, S, d]; di_part,
// df_part [nx, B, H, S]; ds, dmden [B, H, S].
extern "C" int rt_mlstm_bwd(const void* q, const void* k, const void* v, const void* li,
                            const void* lf, const void* ck, const void* n_all,
                            const void* m_all, const void* nq_all, const void* h32,
                            const void* dh, const void* dC, const void* dn, const void* dm,
                            void* dq, void* dk, void* dv, void* dli, void* dlf, void* dC0,
                            void* dn0, void* dm0, void* scr, void* dq_part, void* dk_part,
                            void* di_part, void* df_part, void* ds, void* dmden, int B, int H,
                            int S, int d, int K, int dtype, void* stream) {
  if (d < 1 || d > kMaxD || K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int nx = (d + kBV - 1) / kBV;
  auto f = [](const void* a) { return static_cast<const float*>(a); };
  auto w = [](void* a) { return static_cast<float*>(a); };
  Bwd p{q, k, v, dh, f(li), f(lf), f(ck), f(n_all), f(m_all), f(nq_all), f(h32), f(dC),
        f(dn), f(dm), dq, dk, dv, w(dli), w(dlf), w(dC0), w(dn0), w(dm0), w(scr),
        w(dq_part), w(dk_part), w(di_part), w(df_part), w(ds), w(dmden), B, H, S, d, K, nx};
  const dim3 grid(nx, H, B), rgrid(S > 0 ? (S + kReduceSteps - 1) / kReduceSteps : 1, B * H);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16) {
    mlstm_bwd_kernel<__nv_bfloat16><<<grid, threads_for(d), 0, st>>>(p);
    mlstm_bwd_reduce_kernel<__nv_bfloat16><<<rgrid, kReduceThreads, 0, st>>>(p);
  } else {
    mlstm_bwd_kernel<float><<<grid, threads_for(d), 0, st>>>(p);
    mlstm_bwd_reduce_kernel<float><<<rgrid, kReduceThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}
