// The stabilised mLSTM recurrence, forward and backward, for Hopper: the
// whole time loop in one launch.
//
// Replaces: the reference's lax.scan of src/repro/models/ssm.py ::
// mlstm_scan (the scan at :90, its step at :66), which XLA runs as one loop
// on the device; its gradient is XLA's reverse scan. Per (row b, head h),
// over q, k (scaled by 1/sqrt(d)), v [B,H,S,d] and the log gates log_i,
// log_f [B,H,S] (float32), from the state C [B,H,d,d], n [B,H,d], m [B,H]:
//   m_t = max(log_f + m, log_i) (log_i at the first step), i = exp(log_i -
//   m_t), f = exp(log_f + m - m_t) (0 at the first step), C = f C + i k v^T,
//   n = f n + i k, h = C^T q / max(|n . q|, exp(-m_t)),
// in float32, each h cast to q's dtype as it is written.
//
// What bounds it: the chain of S dependent steps, not the card's rates. A
// step is 4 d^2 FLOPs a (b, h) (d = 192: 0.15 MFLOP) on 147 KB of state;
// the inputs are read once and h written once, so the bytes and FLOPs
// bound a call at microseconds, while each step waits for the last one.
// Design: a CTA per (value block of kBV columns, h, b) keeps its [d, kBV]
// slice of C in registers (thread k holds row k) for all S steps, so no
// step touches C in memory; n, n . q and the gates are O(d) and every CTA
// of a (b, h) computes them alike (the same order, the same bits), so no
// step needs another CTA: the reference's own note, "TP over the VALUE
// dim ... every time step is collective-free". A step's column sums of
// C^T q run through warp shuffles and one __syncthreads; the next step's
// inputs are loaded while this one computes.
// Backward: the forward saves C every K steps (ck), and n_t, m_t, n . q
// and h in float32 at every step (O(S d)). One CTA per the same (value
// block, h, b) walks the segments backwards: it recomputes the segment's C
// from its checkpoint into a scratch slice of its own, then steps back
// through it carrying dC (its columns, registers) and dn. dv is complete
// in the CTA; dq, dk and the gate gradients sum over the value dim, so
// each CTA writes its partials and a second launch sums them in a fixed
// order, then runs the scalar stabiliser chain (warp 0). No atomics: the
// gradients are the same bits run after run.
#include "xlstm.cuh"

namespace {

using rt::Gates;

constexpr int kBV = 16;          // value columns a CTA keeps
constexpr int kMaxD = 256;       // head width: one thread a key row
constexpr int kMaxWarps = kMaxD / 32;
constexpr int kMaxK = 64;        // checkpoint interval the backward takes
constexpr int kReduceThreads = 256;
constexpr int kReduceSteps = 16;  // steps a CTA of the second launch sums

struct Fwd {
  const void *q, *k, *v;
  const float *li, *lf, *C0, *n0, *m0;
  void* h;
  float *C, *n, *m;
  float *ck, *n_all, *m_all, *nq_all, *h32;  // all null: nothing saved
  int B, H, S, d, K;
};

struct Bwd {
  const void *q, *k, *v, *dh;
  const float *li, *lf, *ck, *n_all, *m_all, *nq_all, *h32, *dC, *dn, *dm;
  void *dq, *dk, *dv;
  float *dli, *dlf, *dC0, *dn0, *dm0;
  float *scr, *dq_part, *dk_part, *di_part, *df_part, *ds, *dmden;
  int B, H, S, d, K, nx;
};

// A forward step's inputs, loaded a step ahead.
struct StepIn {
  float q, k, li, lf, v[kBV];
};

template <typename T>
__device__ __forceinline__ void load_step(StepIn& in, const T* q, const T* k, const T* v,
                                          const float* li, const float* lf, int t, int d,
                                          int row, int v0) {
  const long o = static_cast<long>(t) * d;
  in.q = row < d ? rt::to_f(q[o + row]) : 0.f;
  in.k = row < d ? rt::to_f(k[o + row]) : 0.f;
  in.li = li[t];
  in.lf = lf[t];
#pragma unroll
  for (int j = 0; j < kBV; ++j) in.v[j] = v0 + j < d ? rt::to_f(v[o + v0 + j]) : 0.f;
}

template <typename T>
__global__ void __launch_bounds__(kMaxD) mlstm_fwd_kernel(Fwd p) {
  const int x = blockIdx.x, hh = blockIdx.y, b = blockIdx.z;
  const int d = p.d, S = p.S, row = threadIdx.x, lane = row & 31, warp = row >> 5;
  const int nw = blockDim.x >> 5, v0 = x * kBV;
  const long bh = static_cast<long>(b) * p.H + hh;
  const T* q = static_cast<const T*>(p.q) + bh * S * d;
  const T* k = static_cast<const T*>(p.k) + bh * S * d;
  const T* v = static_cast<const T*>(p.v) + bh * S * d;
  const float* li = p.li + bh * S;
  const float* lf = p.lf + bh * S;
  T* h = static_cast<T*>(p.h) + bh * S * d;
  const bool save = p.ck != nullptr;
  __shared__ float red[2][kMaxWarps][kBV + 1];

  float C[kBV];
  const long c_off = bh * d * d + static_cast<long>(row) * d + v0;
#pragma unroll
  for (int j = 0; j < kBV; ++j) C[j] = row < d && v0 + j < d ? p.C0[c_off + j] : 0.f;
  float n = row < d ? p.n0[bh * d + row] : 0.f;
  float m = p.m0[bh];
  if (save && x == 0) {
    if (row < d) p.n_all[bh * (S + 1) * d + row] = n;
    if (row == 0) p.m_all[bh * (S + 1)] = m;
  }
  StepIn cur, nxt;
  if (S > 0) load_step(nxt, q, k, v, li, lf, 0, d, row, v0);
  for (int t = 0; t < S; ++t) {
    cur = nxt;
    if (t + 1 < S) load_step(nxt, q, k, v, li, lf, t + 1, d, row, v0);
    if (save && t % p.K == 0 && row < d) {
      float* ck = p.ck + (static_cast<long>(t / p.K) * p.B * p.H) * d * d + c_off;
#pragma unroll
      for (int j = 0; j < kBV; ++j)
        if (v0 + j < d) ck[j] = C[j];
    }
    const Gates g = rt::gates(cur.li, cur.lf, m);
    float part[kBV + 1];
#pragma unroll
    for (int j = 0; j < kBV; ++j) {
      C[j] = g.f * C[j] + g.i * (cur.k * cur.v[j]);
      part[j] = C[j] * cur.q;
    }
    n = g.f * n + g.i * cur.k;
    part[kBV] = n * cur.q;
#pragma unroll
    for (int j = 0; j <= kBV; ++j) part[j] = rt::warp_sum(part[j]);
    float(*r)[kBV + 1] = red[t & 1];
    if (lane == 0) {
#pragma unroll
      for (int j = 0; j <= kBV; ++j) r[warp][j] = part[j];
    }
    __syncthreads();  // red[t & 1] full; red[(t + 1) & 1] was read before it
    float nq = 0.f;
    for (int w = 0; w < nw; ++w) nq += r[w][kBV];
    const float den = fmaxf(fabsf(nq), expf(-g.m));
    if (row < kBV && v0 + row < d) {
      float num = 0.f;
      for (int w = 0; w < nw; ++w) num += r[w][row];
      const float hv = num / den;
      h[static_cast<long>(t) * d + v0 + row] = rt::from_f<T>(hv);
      if (save) p.h32[(bh * S + t) * d + v0 + row] = hv;
    }
    if (save && x == 0) {
      if (row < d) p.n_all[(bh * (S + 1) + t + 1) * d + row] = n;
      if (row == 0) {
        p.m_all[bh * (S + 1) + t + 1] = g.m;
        p.nq_all[bh * S + t] = nq;
      }
    }
    m = g.m;
  }
  if (row < d) {
#pragma unroll
    for (int j = 0; j < kBV; ++j)
      if (v0 + j < d) p.C[c_off + j] = C[j];
  }
  if (x == 0) {
    if (row < d) p.n[bh * d + row] = n;
    if (row == 0) p.m[bh] = m;
  }
}

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

}  // namespace

extern "C" int rt_mlstm_max_d() { return kMaxD; }
extern "C" int rt_mlstm_block_v() { return kBV; }

extern "C" int rt_mlstm_fwd(const void* q, const void* k, const void* v, const void* li,
                            const void* lf, const void* C0, const void* n0, const void* m0,
                            void* h, void* C, void* n, void* m, void* ck, void* n_all,
                            void* m_all, void* nq_all, void* h32, int B, int H, int S, int d,
                            int K, int dtype, void* stream) {
  if (d < 1 || d > kMaxD || K < 1 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  Fwd p{q, k, v, static_cast<const float*>(li), static_cast<const float*>(lf),
        static_cast<const float*>(C0), static_cast<const float*>(n0),
        static_cast<const float*>(m0), h, static_cast<float*>(C), static_cast<float*>(n),
        static_cast<float*>(m), static_cast<float*>(ck), static_cast<float*>(n_all),
        static_cast<float*>(m_all), static_cast<float*>(nq_all), static_cast<float*>(h32),
        B, H, S, d, K};
  const dim3 grid((d + kBV - 1) / kBV, H, B);
  auto st = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kBF16)
    mlstm_fwd_kernel<__nv_bfloat16><<<grid, threads_for(d), 0, st>>>(p);
  else
    mlstm_fwd_kernel<float><<<grid, threads_for(d), 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
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
