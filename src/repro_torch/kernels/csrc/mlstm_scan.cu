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
// Backward: chunkwise too. The forward saves C at each chunk's start (ck),
// and n_t, m_t, n . q and h in float32 at every step (O(S d)). With m_t
// saved for every step, a chunk's w_ts and c_t come from the saves with no
// chain inside the chunk, and the step-by-step backward's products reverse
// into the chunk's: dv = P^T dNum + w_last (K dC), dq = (w dP) K + c dNum
// C0^T, dk = (w dP)^T Q + w_last V dC^T, the entry state's dC = Q^T (c dNum)
// + c_last dC (dNum = dh / den, dP = dNum V^T; the equations before
// mlstm_bwd_kernel), so the backward, too, runs S / kL chunk steps, each
// the chunk's products on mma.sync tiles (bf16, the float32 operands as hi
// + lo parts; float32 inputs on the CUDA cores), with its CTAs per (block of
// kFV value columns, h, b) carrying their slice of dC in mma accumulators as
// the forward carries C. What bounds it: as the forward, the chain of S / kL
// chunks, each a few barriers of one CTA, and its products (8 kL d^2 + 10
// kL^2 d FLOPs a chunk and (b, h), 11 MFLOP at d = 192, over d / kFV CTAs).
// The gate gradients enter the stabiliser chain as di_t i_t and df_t f_t,
// formed in the stabilised scale (never a division by a gate, which
// underflows at strong forget gates). dv is complete in the CTA; dq, dk and
// the gate products sum over the value dim, so each CTA writes its
// partials and a second launch sums them in a fixed order, while one more
// CTA a (b, h) sums the gate products and runs the scalar stabiliser
// chain, a warp's scan of its affine steps. No atomics: the gradients are
// the same bits run after run.
#include <initializer_list>
#include <type_traits>

#include "mma.cuh"
#include "xlstm.cuh"

namespace {

using rt::Mat;
using rt::mma16816;
using rt::tile;
using rt::tiles;
using rt::tiles_split_b;

constexpr int kMaxD = 256;       // head width
constexpr int kReduceThreads = 256;
constexpr int kReduceSteps = 16;  // steps a CTA of the second launch sums

constexpr int kL = 32;            // the forward's chunk: the checkpoint interval it saves
constexpr int kFV = 32;           // value (and n's key) columns a CTA takes
constexpr int kFwdThreads = 256;  // 8 warps
constexpr int kFwdWarps = kFwdThreads / 32;
constexpr int kMaxTiles = kMaxD / 16 * (kFV / 8) / kFwdWarps;  // C's 16 x 8 tiles a warp
constexpr unsigned kFull = 0xffffffffu;
static_assert(kFV == kL, "a thread's row of w is its row of dNum");

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
  float *dq_part, *dk_part, *di_part, *df_part, *ds, *dmden;
  int B, H, S, d, nx, vec;  // vec: as Fwd's, for q, k, v and dh
};
// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// A float32 operand into shared memory: as itself, or (bf16) as its hi and
// lo parts (rt::put_parts), lo lo_off elements on.
template <typename T>
__device__ __forceinline__ void put(T* dst, int lo_off, float v) {
  if constexpr (sizeof(T) == 2)
    rt::put_parts(dst, lo_off, v);
  else
    dst[0] = v;
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
        rt::cp16(dq + t * ld + c, q + static_cast<long>(t0 + t) * d + c);
        rt::cp16(dk + t * ld + c, k + static_cast<long>(t0 + t) * d + c);
      }
      for (int i = tid; i < Lk * pv; i += kFwdThreads) {
        const int t = i / pv, c = (i % pv) * pad;
        rt::cp16(dv + t * ldV + c, v + static_cast<long>(t0 + t) * d + v0 + c);
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
      rt::cp4(atf(pick(L.li, buf)) + i, li + t0 + i);
      rt::cp4(atf(pick(L.lf, buf)) + i, lf + t0 + i);
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
          rt::put2(o, DP * ldV, acc[j][e], acc[j][e + 1]);
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

// The backward's shared memory, byte offsets (each on 16 bytes) for a head
// width padded to DP. The chunk's inputs (Q, K, this CTA's V and dh columns,
// the gates, m, n . q and the entry n) are double-buffered in bf16 (one
// buffer in float32, loaded before each chunk); the entry state's slice C0
// is float32 (its bf16 parts formed as it loads into fragments); dC, dNum,
// c dNum, P, w dP and w (dP + ds) hold kParts parts (bf16: hi, lo).
struct BwdLayout {
  int ld;
  size_t q[2], k[2], v[2], dh[2], li[2], lf[2], m[2], nq[2], n0[2], c0, dc, dnm, cdn, p, mq, mk,
      w, mm, c, ds, qn0, kdn, y, a, e, dn[2], bytes;
};

constexpr int kLdC = kFV + 8;  // C0's float32 row: float2 fragment loads without bank conflicts

template <typename T>
__host__ __device__ inline BwdLayout bwd_layout(int DP) {
  constexpr int pad = 16 / sizeof(T), parts = sizeof(T) == 2 ? 2 : 1;
  constexpr int stages = sizeof(T) == 2 ? 2 : 1;
  BwdLayout s{};
  s.ld = DP + pad;
  size_t o = 0;
  auto take = [&o](size_t bytes) {
    const size_t at = o;
    o += (bytes + 15) / 16 * 16;
    return at;
  };
  for (int i = 0; i < stages; ++i) {
    s.q[i] = take(sizeof(T) * kL * s.ld);
    s.k[i] = take(sizeof(T) * kL * s.ld);
    s.v[i] = take(sizeof(T) * kL * (kFV + pad));
    s.dh[i] = take(sizeof(T) * kL * (kFV + pad));
    s.li[i] = take(sizeof(float) * kL);
    s.lf[i] = take(sizeof(float) * kL);
    s.m[i] = take(sizeof(float) * (kL + 1));
    s.nq[i] = take(sizeof(float) * kL);
    s.n0[i] = take(sizeof(float) * DP);
  }
  if (stages == 1) {
    s.q[1] = s.q[0], s.k[1] = s.k[0], s.v[1] = s.v[0], s.dh[1] = s.dh[0], s.li[1] = s.li[0];
    s.lf[1] = s.lf[0], s.m[1] = s.m[0], s.nq[1] = s.nq[0], s.n0[1] = s.n0[0];
  }
  s.c0 = take(sizeof(float) * DP * kLdC);
  s.dc = take(sizeof(T) * parts * DP * (kFV + pad));
  s.dnm = take(sizeof(T) * parts * kL * (kFV + pad));
  s.cdn = take(sizeof(T) * parts * kL * (kFV + pad));
  s.p = take(sizeof(T) * parts * kL * (kL + pad));
  s.mq = take(sizeof(T) * parts * kL * (kL + pad));
  s.mk = take(sizeof(T) * parts * kL * (kL + pad));
  s.w = take(sizeof(float) * kL * (kL + 1));
  s.mm = take(sizeof(float) * kL * (kL + 1));
  s.c = take(sizeof(float) * kL);
  s.ds = take(sizeof(float) * kL);
  s.qn0 = take(sizeof(float) * kL);
  s.kdn = take(sizeof(float) * kL);
  s.y = take(sizeof(float) * 4 * kL);
  s.a = take(sizeof(float) * 4 * kL);
  s.e = take(sizeof(float) * (kFwdWarps + 1));
  s.dn[0] = take(sizeof(float) * DP);
  s.dn[1] = take(sizeof(float) * DP);
  s.bytes = o;
  return s;
}

// The backward's first launch: a CTA per (block of kFV value columns, h, b),
// as the forward's, walking the chunks backwards with its [d, kFV] slice of
// dC (the gradient of the chunk's exit state) in mma accumulators. A chunk
// with entry state (C0 = ck[kc], n0, m0), w_ts, c_t from the saves (m_t is
// saved for every step: no chain inside the chunk), den_t = max(|nq_t|,
// exp(-m_t)), dNum = dh / den, S = Q K^T, P = w S, dP = dNum V^T (partial
// over the value blocks), ds_t = -(dh_t . h_t) / den_t tie sign (first block
// only, with dn), w_last and c_last the chunk's last row and step:
//   dv  = P^T dNum + w_last (K dC)                 (complete: all keys here)
//   dq  = (w dP) K + c dNum C0^T                   (partial; + ds n_t in the reduce)
//   dk  = (w (dP + ds))^T Q + w_last (V dC^T + dn) (partial)
//   dC <- c_last dC + Q^T (c dNum),  dn <- c_last dn + Q^T (c ds),
// and the products di_t i_t, df_t f_t the stabiliser chain takes, in the
// stabilised scale (no division by a gate, no difference of two cumulative
// sums; M = P (dP + ds), y_s = w_last_s (k_s^T dC v_s + dn . k_s), a_u = c_u
// q_u^T C0 dnum_u + c_u ds_u q_u . n0, e = c_last (<dC, C0> + dn . n0)):
//   di_t i_t = sum_u M_ut + y_t,
//   df_t f_t = sum_{u>=t} a_u + e + sum_{u>=t, s<t} M_us + sum_{s<t} y_s,
// partials over the value blocks for the second launch to sum.
// NJ: a warp's 16 x 8 tiles of dC and of a [kL, DP] product (DP <= 32 NJ)
template <typename T, int NJ>
__global__ void __launch_bounds__(kFwdThreads, 1) mlstm_bwd_kernel(Bwd p) {
  constexpr bool kTC = sizeof(T) == 2;
  constexpr int kStages = kTC ? 2 : 1;
  constexpr int pad = 16 / sizeof(T), ldS = kL + pad, ldV = kFV + pad, ldW = kL + 1;
  using M = Mat<T, false>;
  using MT = Mat<T, true>;
  const int x = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int d = p.d, S = p.S, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int DP = (d + 15) / 16 * 16, v0 = x * kFV, nv = min(kFV, d - v0);
  const int ntiles = DP / 16 * (kFV / 8), nc = (S + kL - 1) / kL;
  const bool first = x == 0;  // the block that takes the ds and dn terms
  const BwdLayout L = bwd_layout<T>(DP);
  const int ld = L.ld;
  extern __shared__ __align__(16) char smem[];
  auto at = [&](size_t off) { return reinterpret_cast<T*>(smem + off); };
  auto atf = [&](size_t off) { return reinterpret_cast<float*>(smem + off); };
  auto pick = [](const size_t (&off)[2], int i) { return i ? off[1] : off[0]; };
  float* sC0 = atf(L.c0);  // C0 [DP][kLdC]
  T* sDC = at(L.dc);       // dC [DP][ldV] (+ lo)
  T* sDN = at(L.dnm);      // dNum [kL][ldV] (+ lo)
  T* sCDN = at(L.cdn);     // c dNum [kL][ldV] (+ lo)
  T *sP = at(L.p), *sMq = at(L.mq), *sMk = at(L.mk);  // [kL][ldS] (+ lo)
  float *sW = atf(L.w), *sMm = atf(L.mm);              // [kL][ldW]
  float *sC = atf(L.c), *sDs = atf(L.ds), *sQn0 = atf(L.qn0), *sKdn = atf(L.kdn);
  float *sY = atf(L.y), *sA = atf(L.a), *sE = atf(L.e);  // [4][kL], [4][kL], [kFwdWarps + 1]
  const int dlo = kTC ? DP * ldV : 0, nlo = kTC ? kL * ldV : 0, slo = kTC ? kL * ldS : 0;
  const long bh = static_cast<long>(b) * p.H + hh, BH = static_cast<long>(p.B) * p.H;
  const T* q = static_cast<const T*>(p.q) + bh * S * d;
  const T* k = static_cast<const T*>(p.k) + bh * S * d;
  const T* v = static_cast<const T*>(p.v) + bh * S * d;
  const T* dh = static_cast<const T*>(p.dh) + bh * S * d;
  const float* h32 = p.h32 + bh * S * d;
  T* dv = static_cast<T*>(p.dv) + bh * S * d;
  float* dq_part = p.dq_part + (x * BH + bh) * S * d;
  float* dk_part = p.dk_part + (x * BH + bh) * S * d;

  for (size_t i = tid; i < L.bytes / 16; i += kFwdThreads)  // zeros past d, S and kFV
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  __syncthreads();

  // the chunk kc's q, k rows, v and dh columns, gates, m, n . q and entry n
  // into buffer buf; rows past S zero
  auto load_chunk = [&](int kc, int buf) {
    const int t0 = kc * kL, Lk = min(kL, S - t0);
    T *sq = at(pick(L.q, buf)), *sk = at(pick(L.k, buf));
    T *sv = at(pick(L.v, buf)), *sdh = at(pick(L.dh, buf));
    if (p.vec) {
      const int per = d / pad, pv = nv / pad;
      for (int i = tid; i < Lk * per; i += kFwdThreads) {
        const int t = i / per, c = (i % per) * pad;
        rt::cp16(sq + t * ld + c, q + static_cast<long>(t0 + t) * d + c);
        rt::cp16(sk + t * ld + c, k + static_cast<long>(t0 + t) * d + c);
      }
      for (int i = tid; i < Lk * pv; i += kFwdThreads) {
        const int t = i / pv, c = (i % pv) * pad;
        rt::cp16(sv + t * ldV + c, v + static_cast<long>(t0 + t) * d + v0 + c);
        rt::cp16(sdh + t * ldV + c, dh + static_cast<long>(t0 + t) * d + v0 + c);
      }
    } else {
      for (int i = tid; i < Lk * d; i += kFwdThreads) {
        const int t = i / d, c = i % d;
        sq[t * ld + c] = q[static_cast<long>(t0 + t) * d + c];
        sk[t * ld + c] = k[static_cast<long>(t0 + t) * d + c];
      }
      for (int i = tid; i < Lk * nv; i += kFwdThreads) {
        const int t = i / nv, c = i % nv;
        sv[t * ldV + c] = v[static_cast<long>(t0 + t) * d + v0 + c];
        sdh[t * ldV + c] = dh[static_cast<long>(t0 + t) * d + v0 + c];
      }
    }
    for (int i = tid; i < Lk; i += kFwdThreads) {
      rt::cp4(atf(pick(L.li, buf)) + i, p.li + bh * S + t0 + i);
      rt::cp4(atf(pick(L.lf, buf)) + i, p.lf + bh * S + t0 + i);
      rt::cp4(atf(pick(L.nq, buf)) + i, p.nq_all + bh * S + t0 + i);
    }
    for (int i = tid; i <= Lk; i += kFwdThreads)
      rt::cp4(atf(pick(L.m, buf)) + i, p.m_all + bh * (S + 1) + t0 + i);
    for (int i = tid; i < d; i += kFwdThreads)
      rt::cp4(atf(pick(L.n0, buf)) + i, p.n_all + (bh * (S + 1) + t0) * d + i);
    const T zero = rt::from_f<T>(0.f);
    for (int i = tid; i < (kL - Lk) * ld; i += kFwdThreads) {
      sq[Lk * ld + i] = zero;
      sk[Lk * ld + i] = zero;
    }
    for (int i = tid; i < (kL - Lk) * ldV; i += kFwdThreads) {
      sv[Lk * ldV + i] = zero;
      sdh[Lk * ldV + i] = zero;
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  // the chunk kc's entry state, this CTA's columns, into C0 (float32)
  auto load_c0 = [&](int kc) {
    const float* ck = p.ck + (static_cast<long>(kc) * BH + bh) * d * d + v0;
    if (p.vec) {
      const int pv = nv / 4;
      for (int i = tid; i < d * pv; i += kFwdThreads) {
        const int key = i / pv, c = (i % pv) * 4;
        rt::cp16(sC0 + key * kLdC + c, ck + static_cast<long>(key) * d + c);
      }
    } else {
      for (int i = tid; i < d * nv; i += kFwdThreads) {
        const int key = i / nv, c = i % nv;
        rt::cp4(sC0 + key * kLdC + c, ck + static_cast<long>(key) * d + c);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // dC's slice in accumulators, as the forward's C: tile i = warp + 8 j is
  // dC[16 (i / 4) .., 8 (i % 4) ..] (key rows, value columns)
  float acc[NJ][4];
  auto rc = [&](int j, int e, int& key, int& col) {
    const int i = warp + kFwdWarps * j;
    key = (i >> 2) * 16 + (lane >> 2) + (e >> 1) * 8;
    col = (i & 3) * 8 + (lane & 3) * 2 + (e & 1);
  };
  auto live = [&](int j) { return warp + kFwdWarps * j < ntiles; };
  const long cbase = bh * d * d + v0;
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int key, col;
      rc(j, e, key, col);
      acc[j][e] = live(j) && key < d && col < nv ? p.dC[cbase + static_cast<long>(key) * d + col]
                                                 : 0.f;
    }
  int dnb = 0;  // dn's buffer (first block only): the carried dn, the next in dnb ^ 1
  for (int i = tid; i < d; i += kFwdThreads) atf(L.dn[0])[i] = p.dn[bh * d + i];
  if (kStages == 2 && nc > 0) {
    load_chunk(nc - 1, (nc - 1) & 1);
    load_c0(nc - 1);
  }

  const int mt = warp >> 2, nt = warp & 3;  // this warp's 16 x 8 tile of a [kL, kL or kFV] product
  const int r0 = mt * 16 + (lane >> 2), c0 = nt * 8 + (lane & 3) * 2;
  const int ntd = DP / 8;                   // 8-column tiles of a [kL, DP] product
  for (int kc = nc - 1; kc >= 0; --kc) {
    const int cb = kStages == 2 ? kc & 1 : 0, t0 = kc * kL, Lk = min(kL, S - t0);
    if (kStages == 1) {
      load_chunk(kc, 0);
      load_c0(kc);
    }
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();  // chunk kc landed; chunk kc + 1's reads of every buffer done
    if (kStages == 2 && kc > 0) load_chunk(kc - 1, cb ^ 1);
    const T *sq = at(pick(L.q, cb)), *sk = at(pick(L.k, cb));
    const T *sv = at(pick(L.v, cb)), *sdh = at(pick(L.dh, cb));
    const float *cli = atf(pick(L.li, cb)), *clf = atf(pick(L.lf, cb));
    const float *cm = atf(pick(L.m, cb)), *cnq = atf(pick(L.nq, cb)), *n0 = atf(pick(L.n0, cb));
    const float* dnx = atf(L.dn[dnb]);
    float* dnn = atf(L.dn[dnb ^ 1]);

    // the first block's g_t = dh_t . h_t over every value column, loaded now
    // and summed after the first products: row t = tid / 8, columns 4 (tid %
    // 8) + 32 i
    constexpr int kGI = kMaxD / 32;
    using Quad = std::conditional_t<kTC, uint2, float4>;
    float4 gh[kGI];
    Quad gd[kGI];
    const int gt = tid >> 3, gk = (tid & 7) * 4;
    const bool gload = first && p.vec && gt < Lk;
#pragma unroll
    for (int i = 0; i < kGI; ++i) {
      const int key = gk + 32 * i;
      if (gload && key < d) {
        gh[i] = *reinterpret_cast<const float4*>(h32 + static_cast<long>(t0 + gt) * d + key);
        gd[i] = *reinterpret_cast<const Quad*>(dh + static_cast<long>(t0 + gt) * d + key);
      } else {
        gh[i] = make_float4(0.f, 0.f, 0.f, 0.f);
        gd[i] = Quad{};
      }
    }

    // dC (the exit state's gradient) into shared memory for the products
    // that read it, and its partial <dC, C0>
    float ep = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        int key, col;
        rc(j, e, key, col);
        if (!live(j)) continue;
        ep = fmaf(acc[j][e], sC0[key * kLdC + col], ep);
        ep = fmaf(acc[j][e + 1], sC0[key * kLdC + col + 1], ep);
        T* o = sDC + key * ldV + col;
        if constexpr (kTC) {
          rt::put2(o, dlo, acc[j][e], acc[j][e + 1]);
        } else {
          o[0] = acc[j][e];
          o[1] = acc[j][e + 1];
        }
      }
    ep = rt::warp_sum(ep);
    if (lane == 0) sE[warp] = ep;

    // every warp alike: lane t takes F_t (an inclusive scan of log_f), m_t,
    // c_t and 1 / den_t
    const float m0 = cm[0];
    float F = lane < Lk ? clf[lane] : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float f2 = __shfl_up_sync(kFull, F, o);
      if (lane >= o) F += f2;
    }
    const float m_l = lane < Lk ? cm[lane + 1] : 0.f;
    const float c_l = lane < Lk && !isinf(m0) ? expf((F + m0) - m_l) : 0.f;
    const float rden_l = lane < Lk ? 1.f / fmaxf(fabsf(cnq[lane]), expf(-m_l)) : 0.f;
    const float c_last = __shfl_sync(kFull, c_l, Lk - 1);
    if (warp == 0) sC[lane] = c_l;
    {  // w: thread (row t, keys s0 .. s0 + 3), D_ts summed down from t
      const int t = tid >> 3, s0 = (tid & 7) * 4;
      const float m_t = __shfl_sync(kFull, m_l, t);
      float dsum = 0.f;
#pragma unroll 4
      for (int r = t; r > s0 + 3; --r) dsum += clf[r];
#pragma unroll
      for (int s = s0 + 3; s >= s0; --s) {
        const bool in = s <= t && t < Lk;
        sW[t * ldW + s] = in ? expf(dsum + cli[s] - m_t) : 0.f;
        if (in) dsum += clf[s];
      }
      // dNum = dh / den and c dNum: the same thread's row t, columns s0 .. s0 + 3
      const float rd = __shfl_sync(kFull, rden_l, t), ct = __shfl_sync(kFull, c_l, t);
#pragma unroll
      for (int s = s0; s < s0 + 4; ++s) {
        const float dn_ = rt::to_f(sdh[t * ldV + s]) * rd;
        put(sDN + t * ldV + s, nlo, dn_);
        put(sCDN + t * ldV + s, nlo, ct * dn_);
      }
    }
    __syncthreads();  // dC, w, dNum, c dNum, c_t written

    // S = Q K^T, dP = dNum V^T and K dC at this warp's tile; the carried dC
    // becomes the entry state's: c_last dC + Q^T (c dNum)
    float sacc[1][4] = {}, dpa[1][4] = {}, xv[1][4] = {};
    if constexpr (kTC) {  // S and K dC in one k loop: three independent accumulators
      float xl[4] = {};
      const M Q{sq, ld}, K{sk, ld};
      const MT Dh{sDC, ldV}, Dl{sDC + dlo, ldV};
#pragma unroll 2
      for (int k = 0; k < DP; k += 16) {
        uint32_t qa[4], ka[4], kb[2], dh_[2], dl_[2];
        Q.frag_a(qa, mt * 16, k);
        K.frag_b(kb, nt * 8, k);
        K.frag_a(ka, mt * 16, k);
        Dh.frag_b(dh_, nt * 8, k);
        Dl.frag_b(dl_, nt * 8, k);
        mma16816(sacc[0], qa[0], qa[1], qa[2], qa[3], kb[0], kb[1]);
        mma16816(xv[0], ka[0], ka[1], ka[2], ka[3], dh_[0], dh_[1]);
        mma16816(xl, ka[0], ka[1], ka[2], ka[3], dl_[0], dl_[1]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) xv[0][e] += xl[e];
    } else {
      tile(sacc[0], M{sq, ld}, M{sk, ld}, mt * 16, nt * 8, DP);
      tile(xv[0], M{sk, ld}, MT{sDC, ldV}, mt * 16, nt * 8, DP);
    }
    tiles<1, kTC, false>(dpa, M{sDN, ldV}, nlo, M{sv, ldV}, 0, mt * 16, nt * 8, 0, nt * 8, kFV);
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= c_last;
    if constexpr (kTC) {  // + Q^T (c dNum): the warp's tiles share their B fragments
      const MT A{sq, ld}, Bh{sCDN, ldV}, Bl{sCDN + nlo, ldV};
#pragma unroll
      for (int k = 0; k < kL; k += 16) {
        uint32_t bh[2], bl[2];
        Bh.frag_b(bh, (warp & 3) * 8, k);
        Bl.frag_b(bl, (warp & 3) * 8, k);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {  // a tile past the last repeats its key rows
          uint32_t fa[4];
          A.frag_a(fa, min((warp + kFwdWarps * j) >> 2, DP / 16 - 1) * 16, k);
          mma16816(acc[j], fa[0], fa[1], fa[2], fa[3], bh[0], bh[1]);
          mma16816(acc[j], fa[0], fa[1], fa[2], fa[3], bl[0], bl[1]);
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NJ; ++j)
        if (live(j))
          tile(acc[j], MT{sq, ld}, MT{sCDN, ldV}, ((warp + kFwdWarps * j) >> 2) * 16,
               (warp & 3) * 8, kL);
    }
    if (first) {
      // g_t and the step's ds_t, dm_den_t (8 lanes a row); q_u . n0 and
      // k_u . dn (8 lanes a row); dn . n0 (warp 0)
      float g = 0.f;
#pragma unroll
      for (int i = 0; i < kGI; ++i) {
        float hv[4] = {gh[i].x, gh[i].y, gh[i].z, gh[i].w}, dv4[4];
        if constexpr (kTC) {
          const __nv_bfloat162* pr = reinterpret_cast<const __nv_bfloat162*>(&gd[i]);
          dv4[0] = __low2float(pr[0]);
          dv4[1] = __high2float(pr[0]);
          dv4[2] = __low2float(pr[1]);
          dv4[3] = __high2float(pr[1]);
        } else {
          dv4[0] = gd[i].x, dv4[1] = gd[i].y, dv4[2] = gd[i].z, dv4[3] = gd[i].w;
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) g = fmaf(dv4[u], hv[u], g);
      }
      if (!p.vec && gt < Lk)  // rows not on 16 bytes: the same sum, read as it goes
        for (int key = gk; key < d; key += 32)
          for (int u = key; u < min(key + 4, d); ++u)
            g = fmaf(rt::to_f(dh[static_cast<long>(t0 + gt) * d + u]),
                     h32[static_cast<long>(t0 + gt) * d + u], g);
      float qn = 0.f, kd = 0.f;
      for (int key = tid & 7; key < d; key += 8) {
        qn = fmaf(rt::to_f(sq[gt * ld + key]), n0[key], qn);
        kd = fmaf(rt::to_f(sk[gt * ld + key]), dnx[key], kd);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) {
        g += __shfl_xor_sync(kFull, g, o);
        qn += __shfl_xor_sync(kFull, qn, o);
        kd += __shfl_xor_sync(kFull, kd, o);
      }
      if ((tid & 7) == 0) {
        float ds = 0.f;
        if (gt < Lk) {
          const float nq = cnq[gt], e = expf(-cm[gt + 1]), an = fabsf(nq);
          const float den = fmaxf(an, e), dden = -g / den;
          ds = dden * rt::tie(an, e) * (nq > 0.f ? 1.f : (nq < 0.f ? -1.f : 0.f));
          p.ds[bh * S + t0 + gt] = ds;
          p.dmden[bh * S + t0 + gt] = -e * dden * rt::tie(e, an);
        }
        sDs[gt] = ds;
        sQn0[gt] = qn;
        sKdn[gt] = kd;
      }
      if (warp == 0) {
        float a = 0.f;
        for (int key = lane; key < d; key += 32) a = fmaf(dnx[key], n0[key], a);
        a = rt::warp_sum(a);
        if (lane == 0) sE[kFwdWarps] = a;
      }
    }
    __syncthreads();  // ds, q . n0, k . dn written

    {  // P = w S, w dP, w (dP + ds), M = P (dP + ds) at this lane's places
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >> 1) * 8, s = c0 + (e & 1);
        const float w = sW[r * ldW + s], pv = w * sacc[0][e];
        const float dpd = dpa[0][e] + (first ? sDs[r] : 0.f);
        put(sP + r * ldS + s, slo, pv);
        put(sMq + r * ldS + s, slo, w * dpa[0][e]);
        put(sMk + r * ldS + s, slo, w * dpd);
        sMm[r * ldW + s] = pv * dpd;
      }
      // w_last (K dC) in dv's accumulators, and its row dot with V: the
      // rows' k^T dC v scaled by w_last, a partial over this warp's columns
      float y0 = 0.f, y1 = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + (e >> 1) * 8, col = c0 + (e & 1);
        xv[0][e] *= sW[(Lk - 1) * ldW + r];
        (e < 2 ? y0 : y1) += xv[0][e] * rt::to_f(sv[r * ldV + col]);
      }
      y0 += __shfl_xor_sync(kFull, y0, 1);
      y1 += __shfl_xor_sync(kFull, y1, 1);
      y0 += __shfl_xor_sync(kFull, y0, 2);
      y1 += __shfl_xor_sync(kFull, y1, 2);
      if ((lane & 3) == 0) {
        sY[nt * kL + r0] = y0;
        sY[nt * kL + r0 + 8] = y1;
      }
    }
    if (first)  // the entry dn = c_last dn + sum_u c_u ds_u q_u
      for (int key = tid; key < d; key += kFwdThreads) {
        float a = c_last * dnx[key];
#pragma unroll 4
        for (int u = 0; u < kL; ++u) a = fmaf(sC[u] * sDs[u], rt::to_f(sq[u * ld + key]), a);
        dnn[key] = a;
      }
    __syncthreads();  // P, w dP, w (dP + ds), M, the y partials written

    // dv = P^T dNum + w_last (K dC), complete
    tiles<1, kTC, kTC>(xv, MT{sP, ldS}, slo, MT{sDN, ldV}, nlo, mt * 16, nt * 8, 0, nt * 8,
                       kL);
#pragma unroll
    for (int e2 = 0; e2 < 2; ++e2) {
      const int t = r0 + 8 * e2;
      if (t >= Lk || c0 >= nv) continue;
      const long o = static_cast<long>(t0 + t) * d + v0 + c0;
      dv[o] = rt::from_f<T>(xv[0][2 * e2]);
      if (c0 + 1 < nv) dv[o + 1] = rt::from_f<T>(xv[0][2 * e2 + 1]);
    }
    // the [kL, DP] products: this warp's rows mt * 16 .., column tiles nt + 4 j
    const int nj = (ntd - nt + 3) / 4, nlast = (ntd - 1) * 8;
    float acc2[NJ][4];
    auto store2 = [&](float* dst) {  // (col, col + 1) as one 8-byte store where d is even
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int col = (nt + 4 * j) * 8 + (lane & 3) * 2;
        if (j >= nj || col >= d) continue;
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int t = r0 + 8 * e2;
          if (t >= Lk) continue;
          float* o = dst + static_cast<long>(t0 + t) * d + col;
          if (d % 2 == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(acc2[j][2 * e2], acc2[j][2 * e2 + 1]);
          } else {
            o[0] = acc2[j][2 * e2];
            if (col + 1 < d) o[1] = acc2[j][2 * e2 + 1];
          }
        }
      }
    };
    // dq = c dNum C0^T (its row dot with Q: a_u) + (w dP) K
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[j][e] = 0.f;
    if constexpr (kTC)
      tiles_split_b<NJ>(acc2, M{sCDN, ldV}, nlo, sC0, kLdC, mt * 16, nt * 8, 32, nlast, kFV);
    else
      tiles<NJ, false, false>(acc2, M{sCDN, ldV}, 0, Mat<float, false>{sC0, kLdC}, 0, mt * 16,
                               nt * 8, 32, nlast, kFV);
    float a0 = 0.f, a1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      if (j >= nj) break;  // the tiles past the last repeat it
      const int col = (nt + 4 * j) * 8 + (lane & 3) * 2;
      a0 += acc2[j][0] * rt::to_f(sq[r0 * ld + col]) + acc2[j][1] * rt::to_f(sq[r0 * ld + col + 1]);
      a1 += acc2[j][2] * rt::to_f(sq[(r0 + 8) * ld + col]) +
            acc2[j][3] * rt::to_f(sq[(r0 + 8) * ld + col + 1]);
    }
    tiles<NJ, kTC, false>(acc2, M{sMq, ldS}, slo, MT{sk, ld}, 0, mt * 16, nt * 8, 32, nlast,
                           kL);
    a0 += __shfl_xor_sync(kFull, a0, 1);
    a1 += __shfl_xor_sync(kFull, a1, 1);
    a0 += __shfl_xor_sync(kFull, a0, 2);
    a1 += __shfl_xor_sync(kFull, a1, 2);
    if ((lane & 3) == 0) {
      sA[nt * kL + r0] = a0;
      sA[nt * kL + r0 + 8] = a1;
    }
    store2(dq_part);
    // dk = w_last (V dC^T + dn) + (w (dP + ds))^T Q
#pragma unroll
    for (int j = 0; j < NJ; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[j][e] = 0.f;
    tiles<NJ, false, kTC>(acc2, M{sv, ldV}, 0, M{sDC, ldV}, dlo, mt * 16, nt * 8, 32, nlast,
                           kFV);
    const float wl0 = sW[(Lk - 1) * ldW + r0], wl1 = sW[(Lk - 1) * ldW + r0 + 8];
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = min((nt + 4 * j) * 8, nlast) + (lane & 3) * 2;
      const float n0_ = first ? dnx[col] : 0.f, n1_ = first ? dnx[col + 1] : 0.f;
      acc2[j][0] = (acc2[j][0] + n0_) * wl0;
      acc2[j][1] = (acc2[j][1] + n1_) * wl0;
      acc2[j][2] = (acc2[j][2] + n0_) * wl1;
      acc2[j][3] = (acc2[j][3] + n1_) * wl1;
    }
    tiles<NJ, kTC, false>(acc2, MT{sMk, ldS}, slo, MT{sq, ld}, 0, mt * 16, nt * 8, 32, nlast,
                           kL);
    store2(dk_part);
    __syncthreads();  // the a partials written; C0's last reads done
    if (kStages == 2 && kc > 0) load_c0(kc - 1);

    // di_t i_t and df_t f_t: warp w the steps w + 8 i, lane u the row u of M
    {
      const int u = lane;
      const float e_all = c_last * ((((((((sE[0] + sE[1]) + sE[2]) + sE[3]) + sE[4]) + sE[5]) +
                                      sE[6]) + sE[7]) + (first ? sE[kFwdWarps] : 0.f));
      const float wl = sW[(Lk - 1) * ldW + u];
      const float yu = ((sY[u] + sY[kL + u]) + sY[2 * kL + u]) + sY[3 * kL + u] +
                       (first ? wl * sKdn[u] : 0.f);
      const float au = ((sA[u] + sA[kL + u]) + sA[2 * kL + u]) + sA[3 * kL + u] +
                       (first ? sC[u] * sDs[u] * sQn0[u] : 0.f);
      constexpr int kTW = kL / kFwdWarps;  // steps a warp takes
      float R[kTW] = {}, run = 0.f;         // R[i]: sum over s < t_i of M[u][s]
#pragma unroll
      for (int s = 0; s < kL; ++s) {
#pragma unroll
        for (int i = 0; i < kTW; ++i)
          if (s == warp + kFwdWarps * i) R[i] = run;
        run += sMm[u * ldW + s];
      }
      float v[2 * kTW];  // the lanes' terms of df_t f_t and di_t i_t, summed together
#pragma unroll
      for (int i = 0; i < kTW; ++i) {
        const int t = warp + kFwdWarps * i;
        v[i] = u >= t ? R[i] + au : yu;
        v[kTW + i] = sMm[u * ldW + t];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
#pragma unroll
        for (int i = 0; i < 2 * kTW; ++i) v[i] += __shfl_xor_sync(kFull, v[i], o);
#pragma unroll
      for (int i = 0; i < kTW; ++i) {
        const int t = warp + kFwdWarps * i;
        const float idi = v[kTW + i] + __shfl_sync(kFull, yu, t);
        if (lane == 0 && t < Lk) {
          p.di_part[(x * BH + bh) * S + t0 + t] = idi;
          p.df_part[(x * BH + bh) * S + t0 + t] = v[i] + e_all;
        }
      }
    }
    dnb ^= 1;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      int key, col;
      rc(j, e, key, col);
      if (live(j) && key < d && col < nv)
        p.dC0[cbase + static_cast<long>(key) * d + col] = acc[j][e];
    }
  if (first)
    for (int i = tid; i < d; i += kFwdThreads) p.dn0[bh * d + i] = atf(L.dn[dnb])[i];
}

// The backward's second launch: a CTA per (kReduceSteps steps, b, h) sums
// dq and dk over the value blocks (in block order) with dq's ds n_t term;
// one more CTA a (b, h), the last in x, sums the gate products over the
// blocks and runs the stabiliser chain, beside them.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads) mlstm_bwd_reduce_kernel(Bwd p) {
  constexpr int kMaxX = kMaxD / kFV;
  const long bh = blockIdx.y, BH = static_cast<long>(p.B) * p.H;
  const int d = p.d, S = p.S, nx = p.nx, tid = threadIdx.x;
  if (blockIdx.x + 1 < gridDim.x) {
    const long sd = static_cast<long>(S) * d;
    T* dq = static_cast<T*>(p.dq) + bh * sd;
    T* dk = static_cast<T*>(p.dk) + bh * sd;
    const long i1 = min(sd, static_cast<long>(blockIdx.x + 1) * kReduceSteps * d);
    for (long i = blockIdx.x * kReduceSteps * d + tid; i < i1; i += blockDim.x) {
      float vq[kMaxX], vk[kMaxX];
#pragma unroll
      for (int x = 0; x < kMaxX; ++x) {  // the loads first, then the sums in order
        vq[x] = x < nx ? p.dq_part[(x * BH + bh) * sd + i] : 0.f;
        vk[x] = x < nx ? p.dk_part[(x * BH + bh) * sd + i] : 0.f;
      }
      float sq = vq[0], sk = vk[0];
#pragma unroll
      for (int x = 1; x < kMaxX; ++x) {
        if (x >= nx) break;
        sq += vq[x];
        sk += vk[x];
      }
      const long t = i / d, kx = i % d;
      sq += p.ds[bh * S + t] * p.n_all[(bh * (S + 1) + t + 1) * d + kx];
      dq[i] = rt::from_f<T>(sq);
      dk[i] = rt::from_f<T>(sk);
    }
    return;
  }
  for (int t = tid; t < S; t += blockDim.x) {  // into block 0's slot
    float vi[kMaxX], vf[kMaxX];
#pragma unroll
    for (int x = 0; x < kMaxX; ++x) {
      vi[x] = x < nx ? p.di_part[(x * BH + bh) * S + t] : 0.f;
      vf[x] = x < nx ? p.df_part[(x * BH + bh) * S + t] : 0.f;
    }
    float si = vi[0], sf = vf[0];
#pragma unroll
    for (int x = 1; x < kMaxX; ++x) {
      if (x >= nx) break;
      si += vi[x];
      sf += vf[x];
    }
    p.di_part[bh * S + t] = si;
    p.df_part[bh * S + t] = sf;
  }
  __syncthreads();
  if (tid >= 32) return;
  // the chain, 32 steps at a time, lane l step tc - l (its inputs loaded a
  // block ahead): a step maps the m gradient it receives to the previous
  // m's, dm -> A dm + B (A = 0, 1/2 or 1: the max's tie weight, 0 at the
  // first step), so a warp's scan of the maps in step order gives each lane
  // the dm its step receives; each lane then runs its step of the chain
  const float* li = p.li + bh * S;
  const float* lf = p.lf + bh * S;
  const float* m_all = p.m_all + bh * (S + 1);
  float dm = p.dm[bh], nxt[6] = {};
  auto load = [&](int tc) {  // log_i, log_f, m_{t-1}, di i, df f, the denominator's dm
    const int t = tc - tid;
    const bool ok = t >= 0;
    nxt[0] = ok ? li[t] : 0.f;
    nxt[1] = ok ? lf[t] : 0.f;
    nxt[2] = ok ? m_all[t] : 0.f;
    nxt[3] = ok ? p.di_part[bh * S + t] : 0.f;
    nxt[4] = ok ? p.df_part[bh * S + t] : 0.f;
    nxt[5] = ok ? p.dmden[bh * S + t] : 0.f;
  };
  if (S > 0) load(S - 1);
  for (int tc = S - 1; tc >= 0; tc -= 32) {
    const int t = tc - tid;
    const bool ok = t >= 0;
    const float a_li = nxt[0], a_lf = nxt[1], a_mp = nxt[2], a_di = nxt[3], a_df = nxt[4],
                a_dd = nxt[5];
    if (tc >= 32) load(tc - 32);
    const float a = a_lf + a_mp, dff = isinf(a_mp) ? 0.f : a_df;
    float A = !ok ? 1.f : isinf(fmaxf(a, a_li)) ? 0.f : rt::tie(a, a_li);
    float Bc = ok ? fmaf(A, (a_dd - a_di) - dff, dff) : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {  // inclusive: this lane's map after those of lanes < it
      const float A2 = __shfl_up_sync(0xffffffffu, A, o), B2 = __shfl_up_sync(0xffffffffu, Bc, o);
      if (tid >= o) {
        Bc = fmaf(A, B2, Bc);
        A *= A2;
      }
    }
    const float Ap = __shfl_up_sync(0xffffffffu, A, 1), Bp = __shfl_up_sync(0xffffffffu, Bc, 1);
    const float din = tid == 0 ? dm : fmaf(Ap, dm, Bp);  // the dm this lane's step receives
    float dli, dlf;
    const float out = rt::gates_bwd_scaled(a_li, a_lf, a_mp, a_di, a_df, din + a_dd, dli, dlf);
    if (ok) {
      p.dli[bh * S + t] = dli;
      p.dlf[bh * S + t] = dlf;
    }
    dm = __shfl_sync(0xffffffffu, ok ? out : din, 31);
  }
  if (tid == 0) p.dm0[bh] = dm;
}

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

template <typename T, int NJ>
int launch_bwd(const Bwd& p, cudaStream_t st) {
  const size_t bytes = bwd_layout<T>((p.d + 15) / 16 * 16).bytes;
  static size_t allowed = 0;  // as launch_fwd's
  if (bytes > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(mlstm_bwd_kernel<T, NJ>,
                                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(bytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    allowed = bytes;
  }
  const dim3 grid(p.nx, p.H, p.B);
  const dim3 rgrid((p.S + kReduceSteps - 1) / kReduceSteps + 1, p.B * p.H);
  mlstm_bwd_kernel<T, NJ><<<grid, kFwdThreads, bytes, st>>>(p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_reduce_kernel<T><<<rgrid, kReduceThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_mlstm_max_d() { return kMaxD; }
extern "C" int rt_mlstm_block_v() { return kFV; }
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

// Both launches of the backward, on the saves of a forward with the chunk
// kL. Scratch (float32, the wrapper's): dq_part, dk_part [nx, B, H, S, d];
// di_part, df_part [nx, B, H, S]; ds, dmden [B, H, S].
extern "C" int rt_mlstm_bwd(const void* q, const void* k, const void* v, const void* li,
                            const void* lf, const void* ck, const void* n_all,
                            const void* m_all, const void* nq_all, const void* h32,
                            const void* dh, const void* dC, const void* dn, const void* dm,
                            void* dq, void* dk, void* dv, void* dli, void* dlf, void* dC0,
                            void* dn0, void* dm0, void* dq_part, void* dk_part, void* di_part,
                            void* df_part, void* ds, void* dmden, int B, int H, int S, int d,
                            int dtype, void* stream) {
  if (d < 1 || d > kMaxD) return static_cast<int>(cudaErrorInvalidValue);
  const size_t es = dtype == rt::kBF16 ? 2 : 4;
  bool vec = d * es % 16 == 0;
  for (const void* t : {q, k, v, dh}) vec = vec && reinterpret_cast<uintptr_t>(t) % 16 == 0;
  auto f = [](const void* a) { return static_cast<const float*>(a); };
  auto w = [](void* a) { return static_cast<float*>(a); };
  Bwd p{q, k, v, dh, f(li), f(lf), f(ck), f(n_all), f(m_all), f(nq_all), f(h32), f(dC),
        f(dn), f(dm), dq, dk, dv, w(dli), w(dlf), w(dC0), w(dn0), w(dm0), w(dq_part),
        w(dk_part), w(di_part), w(df_part), w(ds), w(dmden), B, H, S, d,
        (d + kFV - 1) / kFV, vec ? 1 : 0};
  auto st = static_cast<cudaStream_t>(stream);
  if (d <= 192)  // 6 tiles a warp up to xlstm-125m's heads, else 8
    return dtype == rt::kBF16 ? launch_bwd<__nv_bfloat16, 6>(p, st) : launch_bwd<float, 6>(p, st);
  return dtype == rt::kBF16 ? launch_bwd<__nv_bfloat16, 8>(p, st) : launch_bwd<float, 8>(p, st);
}
