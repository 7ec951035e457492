// The stabilised sLSTM recurrence, forward and backward, for Hopper: the
// whole time loop in one launch.
//
// Replaces: the reference's lax.scan of src/repro/models/ssm.py ::
// slstm_block (the scan at :170, its step at :148), which XLA runs as one
// loop on the device; its gradient is XLA's reverse scan. Per (row b, head
// h), over the input preactivations zx, ix, fx, ox [B,S,H,hd] and the
// recurrent matrices r [H,hd,4hd] (float32; [z | i | f | o] side by side),
// from the state c, n, h [B,H,hd] and m [B,H]:
//   [zr|ir|fr|or] = h r, z = tanh(zx + zr), o = sigmoid(ox + or), log_i =
//   mean(ix + ir), log_f = log_sigmoid(mean(fx + fr)) (scalars a head),
//   m, i_s, f_s as the mLSTM's, c = f_s c + i_s z, n = f_s n + i_s,
//   h = o c / max(n, 1),
// in float32, each h cast to zx's dtype as it is written.
//
// What bounds it: the chain of S dependent steps (h feeds every gate
// through r). A step is 8 hd^2 FLOPs a (b, h) (hd = 192: 0.3 MFLOP) and
// reads all of r's head, 4 hd^2 f32 (590 KB at hd = 192): more than one
// SM's shared memory. So a step's time is its latency: the forward (below,
// before slstm_fwd_kernel) holds r in the registers of a cluster's CTAs
// and pays one cluster barrier a step.
// Backward: the forward saves each step's c, n, h, z, o, log_i, the forget
// preactivation's mean and m. The same clusters step back carrying dh,
// dc, dn and dm: a step's per-head sums go round the cluster through
// distributed shared memory, each CTA's four gradients of its elements (drec_t, also saved)
// meet its own columns of r, and the partial dh_{t-1} = r drec_t of its
// columns goes to the CTA that owns each element, which sums the kNC
// shares in order. A second launch forms dr = sum over rows and steps of
// h_{t-1} (x) drec_t as a tiled product in a fixed order. No atomics.
#include <cooperative_groups.h>

#include "xlstm.cuh"

namespace cg = cooperative_groups;

namespace {

using rt::Gates;

constexpr int kRows = 4;         // batch rows a cluster takes at most
constexpr int kNC = 8;           // CTAs a cluster: each E = ceil(hd / 8) elements
constexpr int kMaxHd = 256;      // E <= 32: a warp a row in the element role
constexpr int kMaxThreads = kRows * 4 * (kMaxHd / kNC);
constexpr int kTile = 64, kTileK = 16, kDrThreads = 256;  // dr's product

struct Fwd {
  const void *zx, *ix, *fx, *ox;
  const float *r, *c0, *n0, *h0, *m0;
  void* hs;
  float *c, *n, *h, *m;
  float *h_all, *c_all, *n_all, *z_all, *o_all, *li_all, *pf_all, *m_all;  // null: not saved
  int B, S, H, hd, G;  // G: batch rows a cluster takes
};

struct Bwd {
  const float *r, *h_all, *c_all, *n_all, *z_all, *o_all, *li_all, *pf_all, *m_all;
  const void* dhs;
  const float *dc, *dn, *dh, *dm;
  void *dzx, *dix, *dfx, *dox;
  float *dr, *dc0, *dn0, *dh0, *dm0, *drec;
  int B, S, H, hd;
};

// A backward CTA's shape: E elements, CW = 4 E columns of r (row stride CW +
// 1 in shared memory: read by rows without bank conflicts).
struct Shape {
  int E, CW, ld;
};

__host__ __device__ inline Shape shape(int hd) {
  const int E = (hd + kNC - 1) / kNC;
  return {E, 4 * E, 4 * E + 1};
}

// The thread's element role: warp r of the CTA is batch row b0 + r, lane
// el its element c E + el.
struct Role {
  int r, el, e, b;
  bool on;
};

__device__ __forceinline__ Role role(int c, int E, int hd, int B) {
  Role x;
  x.r = threadIdx.x >> 5;
  x.el = threadIdx.x & 31;
  x.e = c * E + x.el;
  x.b = blockIdx.y * kRows + x.r;
  x.on = x.r < kRows && x.el < E && x.e < hd && x.b < B;
  return x;
}

// This CTA's columns of r's head into shared memory: Rs[dd][g E + el] =
// r[h, dd, g hd + c E + el] (0 past hd).
__device__ void load_r(float* Rs, const float* R, int c, int hd, Shape sh) {
  const int G = 4 * hd;
  for (int i = threadIdx.x; i < hd * sh.CW; i += blockDim.x) {
    const int dd = i / sh.CW, j = i % sh.CW, g = j / sh.E, e = c * sh.E + j % sh.E;
    Rs[dd * sh.ld + j] = e < hd ? R[static_cast<long>(dd) * G + g * hd + e] : 0.f;
  }
}

// The forward: a cluster of kNC CTAs a (head, up to kRows batch rows), the
// rows a cluster takes 2 or kRows (B up to 2, or more). CTA c owns
// elements [c E, (c + 1) E) (E = ceil(hd / kNC)) and the 2 E columns of r
// that feed their z and o, kept in registers: matvec thread (column j, part
// kp) holds r[kp NI + i, j] for i < NI, so r is read from memory once and
// every row's step reads it from registers. The per-head means need no
// columns of r: mean(ix + h r_i) = mean(ix) + h . wi, wi = r_i summed over
// its columns (so wf), formed at the start (each CTA an eighth, shared
// through distributed shared memory); so every CTA computes the gates
// itself, in the same order and with the same bits, from the whole h it
// holds. The gates have warps of their own, one a batch row (lane el its
// element c E + el), beside the matvec warps. A step: the matvec warps dot
// their columns with h over their NI-th of hd (no chain longer than NI),
// every row, the kKP parts summed by shuffles; meanwhile the gate warps sum
// their row's gate means and form its gates; one __syncthreads; lane el of
// gate warp r forms the element's z, o, c, n, h and stores h into every
// CTA's next h buffer (distributed shared memory, double-buffered); then
// one cluster barrier, arrive before the step's output stores and the next
// step's input loads, wait after them.
constexpr int kKP = 8;          // lanes a column of the matvec: hd split in kKP parts
constexpr int kLanePer = kMaxHd / 32;        // elements of a row a lane sums
constexpr unsigned kFull = 0xffffffffu;
// NI: the elements of h a matvec thread takes (24 up to hd = 192, else 32).
// A row of h in shared memory is kKP blocks of NI floats, each padded to NI
// + 4 (element dd at (dd / NI) (NI + 4) + dd % NI), zero past hd, as is r's
// part in a thread's registers: the step's loops have fixed trip counts and
// no branch, so their loads issue together, and part kp reads its block as
// float4s with no bank conflict.
template <int NI>
struct HRow {
  static constexpr int kBlk = NI + 4, kLen = kKP * kBlk;
  static constexpr int kThreads = 2 * NI * kKP + 32 * kRows;  // matvec + gate warps, at most
  __device__ static int at(int dd) { return dd / NI * kBlk + dd % NI; }
};

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// G: the batch rows a cluster takes (2 or kRows); NI as above
template <typename T, int G, int NI>
__global__ void __cluster_dims__(kNC, 1, 1) __launch_bounds__(HRow<NI>::kThreads)
    slstm_fwd_kernel(Fwd p) {
  using Row = HRow<NI>;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int hh = blockIdx.z, hd = p.hd, S = p.S, H = p.H, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int E = (hd + kNC - 1) / kNC, cols = 2 * E, hdp = kMaxHd;  // hdp: wsum's rows
  const int mw = (cols * kKP + 31) / 32;  // matvec warps; the gate warps follow
  const int b0 = blockIdx.y * G, rows = min(G, p.B - b0);
  const bool save = p.h_all != nullptr;
  extern __shared__ __align__(16) float fsm[];
  float* hbuf = fsm;                         // [2][G][Row::kLen]: h_{t-1}, double-buffered
  float* rec = hbuf + 2 * G * Row::kLen;     // [G][cols]: the columns' h r
  float* wsum = rec + G * cols;              // [2][hdp]: r_i, r_f summed over their columns
  const float* R = p.r + static_cast<long>(hh) * hd * 4 * hd;

  // matvec role: column j (z of element c E + j, then o of c E + j - E), part
  // kp: h's elements kp NI .. kp NI + NI - 1
  const int j = tid / kKP, kp = tid % kKP;
  const int ej = c * E + (j < E ? j : j - E);
  const bool mv = warp < mw && j < cols && ej < hd;
  float rr[NI];
#pragma unroll
  for (int i = 0; i < NI; ++i) {
    const int dd = kp * NI + i;
    rr[i] = mv && dd < hd ? R[static_cast<long>(dd) * 4 * hd + (j < E ? 0 : 3 * hd) + ej] : 0.f;
  }
  for (int i = tid; i < 2 * G * Row::kLen + G * cols + 2 * hdp; i += blockDim.x) fsm[i] = 0.f;
  cluster.sync();  // every CTA's shared memory zeroed before the peers write wsum
  // wi, wf: row dd of r_i or r_f summed over its columns; CTA c sums its
  // eighth of the 2 hd rows and stores each sum into every CTA's wsum
  const int U = (2 * hd + kNC - 1) / kNC;
  for (int u = c * U + warp; u < min(2 * hd, (c + 1) * U); u += nw) {
    const int g = u / hd, dd = u % hd;
    const float* row = R + static_cast<long>(dd) * 4 * hd + (1 + g) * hd;
    float a = 0.f;
    for (int e = lane; e < hd; e += 32) a += row[e];
    a = rt::warp_sum(a);
    if (lane < kNC) cluster.map_shared_rank(wsum, lane)[g * hdp + dd] = a;
  }
  for (int i = tid; i < rows * hd; i += blockDim.x) {  // the rows' whole h
    const int r = i / hd, e = i % hd;
    hbuf[r * Row::kLen + Row::at(e)] = p.h0[(static_cast<long>(b0 + r) * H + hh) * hd + e];
  }

  // gate role: warp mw + r is batch row b0 + r, lane el its element c E + el
  const int er = warp - mw, el = lane, e = c * E + el;
  const bool gw = er >= 0 && er < rows, on = gw && el < E && e < hd;
  const long si = (static_cast<long>(b0 + er) * H + hh) * hd + e;  // state [B,H,hd]
  float cc = 0.f, n = 0.f, m = 0.f, hv = 0.f;
  if (gw) m = p.m0[static_cast<long>(b0 + er) * H + hh];
  if (on) {
    cc = p.c0[si];
    n = p.n0[si];
    hv = p.h0[si];
    if (save) {
      const long a0 = (static_cast<long>(b0 + er) * (S + 1) * H + hh) * hd + e;
      p.h_all[a0] = hv;
      p.c_all[a0] = cc;
      p.n_all[a0] = n;
      if (e == 0) p.m_all[static_cast<long>(b0 + er) * (S + 1) * H + hh] = m;
    }
  }
  // a step's inputs, loaded in the previous step's barrier slack in their
  // own type (no register of a load is read before the next step): z's and
  // o's preactivation of the element, and this lane's share of the row's ix
  // and fx
  const T zero = rt::from_f<T>(0.f);
  T nz = zero, no = zero, ni[kLanePer], nf[kLanePer];
#pragma unroll
  for (int i = 0; i < kLanePer; ++i) ni[i] = nf[i] = zero;
  auto load = [&](int t) {
    const long xb = ((static_cast<long>(b0 + er) * S + t) * H + hh) * hd;  // [B,S,H,hd]
    if (on) {
      nz = static_cast<const T*>(p.zx)[xb + e];
      no = static_cast<const T*>(p.ox)[xb + e];
    }
#pragma unroll
    for (int i = 0; i < kLanePer; ++i) {
      const int ee = lane + 32 * i;
      if (ee < hd) {
        ni[i] = static_cast<const T*>(p.ix)[xb + ee];
        nf[i] = static_cast<const T*>(p.fx)[xb + ee];
      }
    }
  };
  if (gw && S > 0) load(0);
  cluster.sync();  // wsum and h set in every CTA before the first step
  for (int t = 0; t < S; ++t) {
    const float* hb = hbuf + (t & 1) * G * Row::kLen;
    float* hn = hbuf + ((t + 1) & 1) * G * Row::kLen;
    Gates g{};
    float zt = 0.f, ot = 0.f, li = 0.f, pfm = 0.f;
    if (warp < mw) {
      float acc[G] = {};
#pragma unroll
      for (int i = 0; i < NI; i += 4)
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const float4 x =
              *reinterpret_cast<const float4*>(hb + r * Row::kLen + kp * Row::kBlk + i);
          acc[r] = fmaf(x.x, rr[i], acc[r]);
          acc[r] = fmaf(x.y, rr[i + 1], acc[r]);
          acc[r] = fmaf(x.z, rr[i + 2], acc[r]);
          acc[r] = fmaf(x.w, rr[i + 3], acc[r]);
        }
#pragma unroll
      for (int r = 0; r < G; ++r) {
        float a = acc[r];
        a += __shfl_xor_sync(kFull, a, 1);
        a += __shfl_xor_sync(kFull, a, 2);
        a += __shfl_xor_sync(kFull, a, 4);
        if (mv && kp == 0 && r < rows) rec[r * cols + j] = a;
      }
    } else if (gw) {  // the row's sums of h r_i + ix and h r_f + fx, and its gates
      float a = 0.f, f = 0.f;
#pragma unroll
      for (int i = 0; i < kLanePer; ++i) {
        const int dd = lane + 32 * i;
        if (dd < hd) {
          const float x = hb[er * Row::kLen + Row::at(dd)];
          a = fmaf(x, wsum[dd], a);
          f = fmaf(x, wsum[hdp + dd], f);
        }
      }
      zt = rt::to_f(nz);
      ot = rt::to_f(no);
#pragma unroll
      for (int i = 0; i < kLanePer; ++i) {
        a += rt::to_f(ni[i]);
        f += rt::to_f(nf[i]);
      }
      li = rt::warp_sum(a) / hd;
      pfm = rt::warp_sum(f) / hd;
      g = rt::gates(li, rt::log_sigmoid(pfm), m);
    }
    __syncthreads();  // rec complete
    float z = 0.f, o = 0.f;
    if (on) {
      z = tanhf(zt + rec[er * cols + el]);
      o = rt::sigmoid(ot + rec[er * cols + E + el]);
      cc = g.f * cc + g.i * z;
      n = g.f * n + g.i;
      hv = o * cc / fmaxf(n, 1.f);
      const int at = er * Row::kLen + Row::at(e);
      for (int q = 0; q < kNC; ++q) cluster.map_shared_rank(hn, q)[at] = hv;
    }
    cluster_arrive();  // h_t is out; the peers' reads of hn ended a barrier ago
    if (on) {
      const long xi = ((static_cast<long>(b0 + er) * S + t) * H + hh) * hd + e;  // [B,S,H,hd]
      static_cast<T*>(p.hs)[xi] = rt::from_f<T>(hv);
      if (save) {
        const long a = ((static_cast<long>(b0 + er) * (S + 1) + t + 1) * H + hh) * hd + e;
        p.h_all[a] = hv;
        p.c_all[a] = cc;
        p.n_all[a] = n;
        p.z_all[xi] = z;
        p.o_all[xi] = o;
        if (e == 0) {
          const long gi = (static_cast<long>(b0 + er) * S + t) * H + hh;
          p.li_all[gi] = li;
          p.pf_all[gi] = pfm;
          p.m_all[(static_cast<long>(b0 + er) * (S + 1) + t + 1) * H + hh] = g.m;
        }
      }
    }
    if (gw) {
      m = g.m;
      if (t + 1 < S) load(t + 1);
    }
    cluster_wait();  // every CTA's h_t in hn
  }
  if (on) {
    p.c[si] = cc;
    p.n[si] = n;
    p.h[si] = hv;
    if (e == 0) p.m[static_cast<long>(b0 + er) * H + hh] = m;
  }
}

template <typename T>
__global__ void __cluster_dims__(kNC, 1, 1) __launch_bounds__(kMaxThreads)
    slstm_bwd_kernel(Bwd p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int hh = blockIdx.z, hd = p.hd, G = 4 * hd, S = p.S, H = p.H, tid = threadIdx.x;
  const Shape sh = shape(hd);
  const Role x = role(c, sh.E, hd, p.B);
  extern __shared__ float smem[];
  float* Rs = smem;                              // [hd][ld]
  float* drl = Rs + hd * sh.ld;                  // [kRows][CW], drec of this CTA's columns
  float* dhp = drl + kRows * sh.CW;              // [kNC][kRows][E], dh_{t-1}'s shares
  float* part = dhp + kNC * kRows * sh.E;        // [kNC][kRows][2]

  load_r(Rs, p.r + static_cast<long>(hh) * hd * G, c, hd, sh);
  for (int i = tid; i < kRows * sh.CW; i += blockDim.x) drl[i] = 0.f;
  float dc = 0.f, dn = 0.f, dm = 0.f, dhc = 0.f;
  const int rows = min(kRows, p.B - static_cast<int>(blockIdx.y) * kRows);
  const long si = (static_cast<long>(x.b) * H + hh) * hd + x.e;
  if (x.on) {
    dc = p.dc[si];
    dn = p.dn[si];
    dhc = p.dh[si];
    dm = p.dm[static_cast<long>(x.b) * H + hh];
  }
  cluster.sync();
  // a step's saved values, loaded a step ahead: c_t, n_t, c_{t-1}, n_{t-1},
  // z, o, log_i, the forget mean, m_{t-1}, m_t and the output's gradient
  auto load = [&](float* in, int t) {
    if (!x.on || t < 0) return;
    const long xi = ((static_cast<long>(x.b) * S + t) * H + hh) * hd + x.e;
    const long a = ((static_cast<long>(x.b) * (S + 1) + t) * H + hh) * hd + x.e;  // slot t
    const long a1 = a + static_cast<long>(H) * hd;                                 // t + 1
    const long gi = (static_cast<long>(x.b) * S + t) * H + hh;
    const long mi = (static_cast<long>(x.b) * (S + 1) + t) * H + hh;
    in[0] = p.c_all[a1];
    in[1] = p.n_all[a1];
    in[2] = p.c_all[a];
    in[3] = p.n_all[a];
    in[4] = p.z_all[xi];
    in[5] = p.o_all[xi];
    in[6] = p.li_all[gi];
    in[7] = p.pf_all[gi];
    in[8] = p.m_all[mi];
    in[9] = p.m_all[mi + H];
    in[10] = rt::to_f(static_cast<const T*>(p.dhs)[xi]);
  };
  float nxt[11] = {};
  load(nxt, S - 1);
  for (int t = S - 1; t >= 0; --t) {
    const long xi = ((static_cast<long>(x.b) * S + t) * H + hh) * hd + x.e;
    float cur[11];
#pragma unroll
    for (int i = 0; i < 11; ++i) cur[i] = nxt[i];
    load(nxt, t - 1);
    float pdi = 0.f, pdf = 0.f, dct = 0.f, dnt = 0.f, do_ = 0.f;
    const float z = cur[4], o = cur[5], li = cur[6], pf = cur[7], mp = cur[8], mt = cur[9];
    if (x.on) {
      const float ct = cur[0], nt = cur[1], cp = cur[2], np = cur[3];
      const float dht = dhc + cur[10];
      const float nc = fmaxf(nt, 1.f), gh = dht / nc;
      do_ = gh * ct;
      dct = dc + gh * o;
      dnt = dn + (nt >= 1.f ? -dht * (o * ct) / (nc * nc) : 0.f);
      pdi = dct * z + dnt;
      pdf = dct * cp + dnt * np;
    }
    if (x.r < kRows) {
      pdi = rt::warp_sum(pdi);
      pdf = rt::warp_sum(pdf);
      if (x.el < kNC) {
        float* dst = cluster.map_shared_rank(part, x.el) + (c * kRows + x.r) * 2;
        dst[0] = pdi;
        dst[1] = pdf;
      }
    }
    cluster.sync();
    if (x.on) {
      float di = 0.f, df = 0.f;
      for (int q = 0; q < kNC; ++q) {
        di += part[(q * kRows + x.r) * 2];
        df += part[(q * kRows + x.r) * 2 + 1];
      }
      const float lf = rt::log_sigmoid(pf);
      const Gates g = rt::gates_at(li, lf, mp, mt);
      float dli, dlf;
      dm = rt::gates_bwd(li, lf, mp, mt, di, df, dm, dli, dlf);
      const float dpf = dlf * rt::log_sigmoid_grad(pf);
      const float gz = dct * g.i * (1.f - z * z), gi_ = dli / hd, gf = dpf / hd;
      const float go = do_ * (1.f - o) * o;
      static_cast<T*>(p.dzx)[xi] = rt::from_f<T>(gz);
      static_cast<T*>(p.dix)[xi] = rt::from_f<T>(gi_);
      static_cast<T*>(p.dfx)[xi] = rt::from_f<T>(gf);
      static_cast<T*>(p.dox)[xi] = rt::from_f<T>(go);
      float* dr = p.drec + ((static_cast<long>(x.b) * S + t) * H + hh) * G + x.e;
      float* dl = drl + x.r * sh.CW + x.el;
      dr[0] = dl[0] = gz;
      dr[hd] = dl[sh.E] = gi_;
      dr[2 * hd] = dl[2 * sh.E] = gf;
      dr[3 * hd] = dl[3 * sh.E] = go;
      dc = g.f * dct;
      dn = g.f * dnt;
    }
    __syncthreads();
    // this CTA's share of dh_{t-1} = r drec_t, to the CTA owning each element
    for (int i = tid; i < rows * hd; i += blockDim.x) {
      const int r = i / hd, dd = i % hd;
      const float* rs = Rs + dd * sh.ld;
      const float* dl = drl + r * sh.CW;
      float acc = 0.f;
#pragma unroll 8
      for (int j = 0; j < sh.CW; ++j) acc += rs[j] * dl[j];
      cluster.map_shared_rank(dhp, dd / sh.E)[(c * kRows + r) * sh.E + dd % sh.E] = acc;
    }
    cluster.sync();
    if (x.on) {
      dhc = 0.f;
      for (int q = 0; q < kNC; ++q) dhc += dhp[(q * kRows + x.r) * sh.E + x.el];
    }
  }
  if (x.on) {
    p.dc0[si] = dc;
    p.dn0[si] = dn;
    p.dh0[si] = dhc;
    if (x.e == 0) p.dm0[static_cast<long>(x.b) * H + hh] = dm;
  }
  cluster.sync();  // no CTA leaves while another may still read its shares
}

// dr[h] = sum over (b, t) of h_{t-1}[b, h] (x) drec[b, t, h]: a [hd, B*S] x
// [B*S, 4hd] product a head, 64 x 64 tiles, each thread 4 x 4 outputs, the
// sum over (b, t) in order.
__global__ void __launch_bounds__(kDrThreads) slstm_dr_kernel(Bwd p) {
  const int hh = blockIdx.z, hd = p.hd, G = 4 * hd, S = p.S, H = p.H;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const long KT = static_cast<long>(p.B) * S;
  __shared__ float As[kTileK][kTile + 4], Bs[kTileK][kTile + 4];
  float acc[4][4] = {};
  for (long kb = 0; kb < KT; kb += kTileK) {
    for (int i = tid; i < kTileK * kTile; i += kDrThreads) {
      const int kk = i / kTile, mm = i % kTile;
      const long kg = kb + kk;
      const long b = kg / S, t = kg % S;
      As[kk][mm] = kg < KT && m0 + mm < hd
                       ? p.h_all[((b * (S + 1) + t) * H + hh) * hd + m0 + mm] : 0.f;
      Bs[kk][mm] = kg < KT && n0 + mm < G ? p.drec[((b * S + t) * H + hh) * G + n0 + mm] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        av[i] = As[kk][ty * 4 + i];
        bv[i] = Bs[kk][tx * 4 + i];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int mm = m0 + ty * 4 + i, nn = n0 + tx * 4 + j;
      if (mm < hd && nn < G) p.dr[(static_cast<long>(hh) * hd + mm) * G + nn] = acc[i][j];
    }
}

int threads_for(int hd) {
  const int n = kRows * shape(hd).CW;
  return ((n > kRows * 32 ? n : kRows * 32) + 31) / 32 * 32;
}

size_t bwd_smem(int hd) {
  const Shape sh = shape(hd);
  return sizeof(float) * (hd * sh.ld + kRows * sh.CW + kNC * kRows * sh.E + kNC * kRows * 2);
}

// Lets ``kernel`` take ``bytes`` of dynamic shared memory. Raised at most
// to the largest size yet (a call at the same or a smaller head width sets
// nothing), so no call under a CUDA graph capture sets it anew once a
// first call of that width ran outside.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

size_t bwd_allowed[2] = {0, 0};  // by dtype code

}  // namespace

extern "C" int rt_slstm_max_hd() { return kMaxHd; }

extern "C" int rt_slstm_fwd(const void* zx, const void* ix, const void* fx, const void* ox,
                            const void* r, const void* c0, const void* n0, const void* h0,
                            const void* m0, void* hs, void* c, void* n, void* h, void* m,
                            void* h_all, void* c_all, void* n_all, void* z_all, void* o_all,
                            void* li_all, void* pf_all, void* m_all, int B, int S, int H,
                            int hd, int dtype, void* stream) {
  if (hd < 1 || hd > kMaxHd) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* a) { return static_cast<const float*>(a); };
  auto w = [](void* a) { return static_cast<float*>(a); };
  const int G = B <= 2 ? 2 : kRows, E = (hd + kNC - 1) / kNC;
  Fwd p{zx, ix, fx, ox, f(r), f(c0), f(n0), f(h0), f(m0), hs, w(c), w(n), w(h), w(m),
        w(h_all), w(c_all), w(n_all), w(z_all), w(o_all), w(li_all), w(pf_all), w(m_all),
        B, S, H, hd, G};
  const dim3 grid(kNC, (B + G - 1) / G, H);
  const int threads = (2 * E * kKP + 31) / 32 * 32 + 32 * G;
  auto st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, int blk_len) {
    const size_t bytes = sizeof(float) * (2 * G * blk_len + G * 2 * E + 2 * kMaxHd);
    kernel<<<grid, threads, bytes, st>>>(p);
  };
  const bool bf = dtype == rt::kBF16, narrow = hd <= 24 * kKP;
#define RT_SLSTM_FWD(TT, GG)                                                    \
  (narrow ? launch(slstm_fwd_kernel<TT, GG, 24>, HRow<24>::kLen)                \
          : launch(slstm_fwd_kernel<TT, GG, 32>, HRow<32>::kLen))
  if (G == 2)
    bf ? RT_SLSTM_FWD(__nv_bfloat16, 2) : RT_SLSTM_FWD(float, 2);
  else
    bf ? RT_SLSTM_FWD(__nv_bfloat16, 4) : RT_SLSTM_FWD(float, 4);
#undef RT_SLSTM_FWD
  return static_cast<int>(cudaGetLastError());
}

// Both launches of the backward; drec [B, S, H, 4hd] float32 is the
// wrapper's scratch.
extern "C" int rt_slstm_bwd(const void* r, const void* h_all, const void* c_all,
                            const void* n_all, const void* z_all, const void* o_all,
                            const void* li_all, const void* pf_all, const void* m_all,
                            const void* dhs, const void* dc, const void* dn, const void* dh,
                            const void* dm, void* dzx, void* dix, void* dfx, void* dox,
                            void* dr, void* dc0, void* dn0, void* dh0, void* dm0, void* drec,
                            int B, int S, int H, int hd, int dtype, void* stream) {
  if (hd < 1 || hd > kMaxHd) return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* a) { return static_cast<const float*>(a); };
  auto w = [](void* a) { return static_cast<float*>(a); };
  Bwd p{f(r), f(h_all), f(c_all), f(n_all), f(z_all), f(o_all), f(li_all), f(pf_all),
        f(m_all), dhs, f(dc), f(dn), f(dh), f(dm), dzx, dix, dfx, dox, w(dr), w(dc0),
        w(dn0), w(dh0), w(dm0), w(drec), B, S, H, hd};
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(kNC, (B + kRows - 1) / kRows, H);
  const size_t bytes = bwd_smem(hd);
  cudaError_t err;
  if (dtype == rt::kBF16) {
    err = allow_smem(slstm_bwd_kernel<__nv_bfloat16>, bytes, bwd_allowed[1]);
    if (err == cudaSuccess)
      slstm_bwd_kernel<__nv_bfloat16><<<grid, threads_for(hd), bytes, st>>>(p);
  } else {
    err = allow_smem(slstm_bwd_kernel<float>, bytes, bwd_allowed[0]);
    if (err == cudaSuccess) slstm_bwd_kernel<float><<<grid, threads_for(hd), bytes, st>>>(p);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 dr_grid((4 * hd + kTile - 1) / kTile, (hd + kTile - 1) / kTile, H);
  slstm_dr_kernel<<<dr_grid, kDrThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
