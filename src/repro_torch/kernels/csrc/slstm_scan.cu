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
// preactivation's mean and m; the backward's chain of S steps back (dh_{t-1}
// = r^T of the step's preactivation gradient) is bound the same way, by a
// step's latency. It is the forward's design transposed (before
// slstm_bwd_kernel): the same clusters, each CTA holding the rows of r's z
// and o blocks for its elements in registers. The i and f columns of a
// step's preactivation gradient are per-head scalars broadcast over hd, so
// r's i and f blocks enter dh_{t-1} only through wi, wf (those blocks summed
// over their columns): the matvec runs over the z and o columns alone, and
// a step exchanges its z and o gradients and two partial sums once through
// distributed shared memory, one cluster barrier a step. A second launch
// forms dr in a fixed order: the z and o blocks a tiled product, the i and f
// blocks one sum each. No atomics.
#include <cooperative_groups.h>

#include "xlstm.cuh"

namespace cg = cooperative_groups;

namespace {

using rt::Gates;

constexpr int kRows = 4;         // batch rows a cluster takes at most
constexpr int kNC = 8;           // CTAs a cluster: each E = ceil(hd / 8) elements
constexpr int kMaxHd = 256;      // E <= 32: a warp a row in the element role
constexpr int kTile = 64, kTileK = 64, kDrThreads = 256;  // dr's product

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
  float *dr, *dc0, *dn0, *dh0, *dm0;
  float* drec;  // [H, B, S, 2 hd + 2]: a step's gz, go, then gi, gf (dr's inputs)
  int B, S, H, hd;
};

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

using rt::cluster_arrive;
using rt::cluster_wait;

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

// The backward: the forward's clusters (kNC CTAs a head and G batch rows),
// stepping back from S - 1 carrying dh, dc, dn and dm. CTA c owns elements
// [c E, (c + 1) E) as inputs of the matvec: the rows dd of r's z and o
// blocks, 2 hd columns each, in registers (matvec thread (row j, part kp)
// holds rz[dd, e] and ro[dd, e] for the NI / 2 elements e of its part, dd =
// c E + j): dh_{t-1}[dd] = sum_e rz[dd, e] gz_e + ro[dd, e] go_e + gi wi[dd]
// + gf wf[dd], the i and f blocks reduced to wi, wf (formed at the start,
// each CTA its own rows). A step: gate warp r (lane el: element c E + el of
// batch row b0 + r) forms the element's dc, dn, gz, go from the saves and
// dh_t, stores (gz, go) into every CTA's K buffer and the row's partial sums
// of pdi = dc z + dn and pdf = dc c_{t-1} + dn n_{t-1} into every CTA's
// partial buffer (distributed shared memory, both double-buffered); one
// cluster barrier, arrive before the step's output stores and the next
// step's loads, wait after them; then the matvec warps dot their rows with
// (gz, go) (fixed trip counts, kKB parts summed by shuffles) while the gate
// warps sum the kNC partials in the same order in every CTA (the same bits)
// and run the stabiliser step; one __syncthreads; each gate lane adds gi wi
// + gf wf to its element's matvec sum: dh_{t-1}, local, no second exchange.
constexpr int kKB = 16;  // lanes a row of the backward's matvec: 2 hd split in kKB parts
// The K vector of a step: (gz_e, go_e) of the head's hd elements side by
// side, 2 hd long, in kKB parts of NI floats (NI / 2 elements each; NI = 24
// up to hd = 192, else 32), each padded to NI + 4 and zero past hd, as are
// r's rows in a thread's registers: element e's pair at (e / (NI / 2)) (NI +
// 4) + 2 (e % (NI / 2)).
template <int NI>
struct GRow {
  static constexpr int kHalf = NI / 2, kBlk = NI + 4, kLen = kKB * kBlk;
  static constexpr int kThreads = kKB * (kKB * kHalf / kNC) + 32 * kRows;  // at most
  __device__ static int at(int e) { return e / kHalf * kBlk + 2 * (e % kHalf); }
};

template <typename T, int G, int NI>
__global__ void __cluster_dims__(kNC, 1, 1) __launch_bounds__(GRow<NI>::kThreads)
    slstm_bwd_kernel(Bwd p) {
  using Row = GRow<NI>;
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int hh = blockIdx.z, hd = p.hd, S = p.S, H = p.H, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5, nw = blockDim.x >> 5;
  const int E = (hd + kNC - 1) / kNC, NR = 2 * hd + 2;  // NR: drec's row
  const int mw = (E * kKB + 31) / 32;  // matvec warps; the gate warps follow
  const int b0 = blockIdx.y * G, rows = min(G, p.B - b0);
  extern __shared__ __align__(16) float bsm[];
  float* kbuf = bsm;                              // [2][G][Row::kLen]: (gz, go), double-buffered
  float2* part = reinterpret_cast<float2*>(kbuf + 2 * G * Row::kLen);  // [2][kNC][G]
  float* mvs = reinterpret_cast<float*>(part + 2 * kNC * G);  // [G][32]: the rows' matvec sums
  float* wsum = mvs + G * 32;                     // [2][32]: wi, wf of this CTA's rows
  const float* R = p.r + static_cast<long>(hh) * hd * 4 * hd;

  // matvec role: row j (element dd = c E + j), part kp: elements kp NI / 2 ..
  const int j = tid / kKB, kp = tid % kKB, dd = c * E + j;
  const bool mv = warp < mw && j < E && dd < hd;
  float rr[NI];
#pragma unroll
  for (int i = 0; i < Row::kHalf; ++i) {
    const int e = kp * Row::kHalf + i;
    const bool in = mv && e < hd;
    rr[2 * i] = in ? R[static_cast<long>(dd) * 4 * hd + e] : 0.f;
    rr[2 * i + 1] = in ? R[static_cast<long>(dd) * 4 * hd + 3 * hd + e] : 0.f;
  }
  for (int i = tid; i < 2 * G * Row::kLen + 4 * kNC * G + G * 32 + 64; i += blockDim.x)
    bsm[i] = 0.f;
  __syncthreads();
  // wi, wf of this CTA's rows: row dd of r_i or r_f summed over its columns
  for (int u = warp; u < 2 * E; u += nw) {
    const int g = u / E, e = c * E + u % E;
    if (e >= hd) continue;
    const float* row = R + static_cast<long>(e) * 4 * hd + (1 + g) * hd;
    float a = 0.f;
    for (int i = lane; i < hd; i += 32) a += row[i];
    a = rt::warp_sum(a);
    if (lane == 0) wsum[g * 32 + u % E] = a;
  }
  __syncthreads();

  // gate role: warp mw + r is batch row b0 + r, lane el its element c E + el
  const int er = warp - mw, el = lane, e = c * E + el;
  const bool gw = er >= 0 && er < rows, on = gw && el < E && e < hd;
  const long si = (static_cast<long>(b0 + er) * H + hh) * hd + e;  // state [B,H,hd]
  float dc = 0.f, dn = 0.f, dm = 0.f, dhc = 0.f;
  const float wi = gw ? wsum[el] : 0.f, wf = gw ? wsum[32 + el] : 0.f;
  if (gw) dm = p.dm[static_cast<long>(b0 + er) * H + hh];
  if (on) {
    dc = p.dc[si];
    dn = p.dn[si];
    dhc = p.dh[si];
  }
  // a step's saved values, loaded in the previous step's barrier slack (no
  // register of a load is read before the next step): c_t, n_t, c_{t-1},
  // n_{t-1}, z, o and the output's gradient of the element; log_i, the
  // forget mean, m_{t-1}, m_t of the row
  float nxt[11] = {};
  auto load = [&](int t) {
    const long gi = (static_cast<long>(b0 + er) * S + t) * H + hh;
    const long mi = (static_cast<long>(b0 + er) * (S + 1) + t) * H + hh;
    nxt[6] = p.li_all[gi];
    nxt[7] = p.pf_all[gi];
    nxt[8] = p.m_all[mi];
    nxt[9] = p.m_all[mi + H];
    if (!on) return;
    const long xi = gi * hd + e;                                // [B,S,H,hd]
    const long a = mi * hd + e, a1 = a + static_cast<long>(H) * hd;  // slots t, t + 1
    nxt[0] = p.c_all[a1];
    nxt[1] = p.n_all[a1];
    nxt[2] = p.c_all[a];
    nxt[3] = p.n_all[a];
    nxt[4] = p.z_all[xi];
    nxt[5] = p.o_all[xi];
    nxt[10] = rt::to_f(static_cast<const T*>(p.dhs)[xi]);
  };
  if (gw && S > 0) load(S - 1);
  cluster.sync();  // every CTA's shared memory zeroed before the peers write into it
  for (int t = S - 1; t >= 0; --t) {
    float* kb = kbuf + (t & 1) * G * Row::kLen;
    float2* pb = part + (t & 1) * kNC * G;
    float cur[11];
#pragma unroll
    for (int i = 0; i < 11; ++i) cur[i] = nxt[i];
    const float z = cur[4], o = cur[5], li = cur[6], pf = cur[7], mp = cur[8], mt = cur[9];
    const float lf = rt::log_sigmoid(pf);
    const long xi = ((static_cast<long>(b0 + er) * S + t) * H + hh) * hd + e;
    const long ri = ((static_cast<long>(hh) * p.B + b0 + er) * S + t) * NR;  // drec's row
    Gates g{};
    float gz = 0.f, go = 0.f, dct = 0.f, dnt = 0.f;
    if (gw) {  // the element's gradients and the row's partial sums, out to every CTA
      g = rt::gates_at(li, lf, mp, mt);
      float pdi = 0.f, pdf = 0.f;
      if (on) {
        const float ct = cur[0], nt = cur[1], dht = dhc + cur[10];
        const float nc = fmaxf(nt, 1.f), gh = dht / nc;
        dct = dc + gh * o;
        dnt = dn + (nt >= 1.f ? -dht * (o * ct) / (nc * nc) : 0.f);
        pdi = dct * z + dnt;
        pdf = dct * cur[2] + dnt * cur[3];
        gz = dct * g.i * (1.f - z * z);
        go = gh * ct * (1.f - o) * o;
        const int at = er * Row::kLen + Row::at(e);
        for (int q = 0; q < kNC; ++q)
          *reinterpret_cast<float2*>(cluster.map_shared_rank(kb, q) + at) = make_float2(gz, go);
      }
      pdi = rt::warp_sum(pdi);
      pdf = rt::warp_sum(pdf);
      if (lane < kNC) cluster.map_shared_rank(pb, lane)[c * G + er] = make_float2(pdi, pdf);
    }
    cluster_arrive();  // the step's K and partials are out
    if (gw) {
      if (on) {
        static_cast<T*>(p.dzx)[xi] = rt::from_f<T>(gz);
        static_cast<T*>(p.dox)[xi] = rt::from_f<T>(go);
        p.drec[ri + e] = gz;
        p.drec[ri + hd + e] = go;
        dc = g.f * dct;
        dn = g.f * dnt;
      }
      if (t > 0) load(t - 1);
    }
    cluster_wait();  // every CTA's (gz, go) in kb, its partials in pb
    float gi = 0.f, gf = 0.f;
    if (warp < mw) {
      float acc[G] = {};
#pragma unroll
      for (int i = 0; i < NI; i += 4)
#pragma unroll
        for (int r = 0; r < G; ++r) {
          const float4 x =
              *reinterpret_cast<const float4*>(kb + r * Row::kLen + kp * Row::kBlk + i);
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
        a += __shfl_xor_sync(kFull, a, 8);
        if (mv && kp == 0) mvs[r * 32 + j] = a;
      }
    } else if (gw) {  // the row's di, df (the same order in every CTA) and its stabiliser step
      float di = 0.f, df = 0.f;
#pragma unroll
      for (int q = 0; q < kNC; ++q) {
        const float2 v = pb[q * G + er];
        di += v.x;
        df += v.y;
      }
      float dli, dlf;
      dm = rt::gates_bwd_scaled(li, lf, mp, di * g.i, df * g.f, dm, dli, dlf);
      gi = dli / hd;
      gf = dlf * rt::log_sigmoid_grad(pf) / hd;
      if (on) {
        static_cast<T*>(p.dix)[xi] = rt::from_f<T>(gi);
        static_cast<T*>(p.dfx)[xi] = rt::from_f<T>(gf);
      }
      if (c == 0 && lane == 0) {
        p.drec[ri + 2 * hd] = gi;
        p.drec[ri + 2 * hd + 1] = gf;
      }
    }
    __syncthreads();  // the matvec sums in mvs
    if (on) dhc = fmaf(gf, wf, fmaf(gi, wi, mvs[er * 32 + el]));
  }
  if (on) {
    p.dc0[si] = dc;
    p.dn0[si] = dn;
    p.dh0[si] = dhc;
    if (e == 0) p.dm0[static_cast<long>(b0 + er) * H + hh] = dm;
  }
}

// dr[h] from drec's rows (gz | go | gi | gf, 2 hd + 2 columns): a [hd, B S]
// x [B S, 2 hd + 2] product a head, 64 x 64 tiles, each thread 4 x 4
// outputs, the sum over (b, t) in order, the next kTileK rows of both
// operands loaded into registers while this tile's are summed. Column n <
// hd is dr's z column n, hd <= n < 2 hd its o column n + 2 hd; the last two
// are sum h_{t-1} gi and sum h_{t-1} gf, each written across its hd columns
// of dr's i and f blocks.
__global__ void __launch_bounds__(kDrThreads) slstm_dr_kernel(Bwd p) {
  constexpr int kPer = kTileK * kTile / kDrThreads;  // elements of a tile a thread loads
  const int hh = blockIdx.z, hd = p.hd, NR = 2 * hd + 2, S = p.S, H = p.H;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile, tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int KT = p.B * S;
  __shared__ __align__(16) float As[kTileK][kTile + 4], Bs[kTileK][kTile + 4];
  __shared__ float bc[kTile][2];
  float acc[4][4] = {}, ra[kPer], rb[kPer];
  auto fetch = [&](int kb) {  // (row kg of B S) = (b, t): h_{t-1} at slot b (S + 1) + t = kg + b
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kDrThreads, kk = i / kTile, mm = i % kTile, kg = kb + kk;
      const long hrow = static_cast<long>(kg + kg / S) * H + hh;
      const long drow = static_cast<long>(hh) * KT + kg;
      ra[u] = kg < KT && m0 + mm < hd ? p.h_all[hrow * hd + m0 + mm] : 0.f;
      rb[u] = kg < KT && n0 + mm < NR ? p.drec[drow * NR + n0 + mm] : 0.f;
    }
  };
  if (KT > 0) fetch(0);
  for (int kb = 0; kb < KT; kb += kTileK) {
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int i = tid + u * kDrThreads;
      As[i / kTile][i % kTile] = ra[u];
      Bs[i / kTile][i % kTile] = rb[u];
    }
    __syncthreads();
    if (kb + kTileK < KT) fetch(kb + kTileK);
#pragma unroll
    for (int kk = 0; kk < kTileK; ++kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w}, bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] += av[i] * bv[j];
    }
    __syncthreads();
  }
  float* dr = p.dr + static_cast<long>(hh) * hd * 4 * hd;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int mm = m0 + ty * 4 + i, nn = n0 + tx * 4 + j;
      if (mm >= hd || nn >= NR) continue;
      if (nn < 2 * hd)
        dr[static_cast<long>(mm) * 4 * hd + (nn < hd ? nn : nn + 2 * hd)] = acc[i][j];
      else
        bc[ty * 4 + i][nn - 2 * hd] = acc[i][j];
    }
  if (n0 + kTile <= 2 * hd) return;  // (the same for the whole CTA) no i or f sum here
  __syncthreads();
  const int rows = min(kTile, hd - m0);
  for (int i = tid; i < rows * 2 * hd; i += kDrThreads) {
    const int r = i / (2 * hd), col = i % (2 * hd);
    dr[static_cast<long>(m0 + r) * 4 * hd + hd + col] = bc[r][col / hd];
  }
}

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


// Both launches of the backward; drec [H, B, S, 2hd + 2] float32 is the
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
  const int G = B <= 2 ? 2 : kRows, E = (hd + kNC - 1) / kNC;
  const dim3 grid(kNC, (B + G - 1) / G, H);
  const int threads = (E * kKB + 31) / 32 * 32 + 32 * G;
  auto st = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, int row_len) {
    const size_t bytes = sizeof(float) * (2 * G * row_len + 4 * kNC * G + G * 32 + 64);
    kernel<<<grid, threads, bytes, st>>>(p);
  };
  const bool bf = dtype == rt::kBF16, narrow = hd <= kKB * 12;
#define RT_SLSTM_BWD(TT, GG)                                                    \
  (narrow ? launch(slstm_bwd_kernel<TT, GG, 24>, GRow<24>::kLen)                \
          : launch(slstm_bwd_kernel<TT, GG, 32>, GRow<32>::kLen))
  if (G == 2)
    bf ? RT_SLSTM_BWD(__nv_bfloat16, 2) : RT_SLSTM_BWD(float, 2);
  else
    bf ? RT_SLSTM_BWD(__nv_bfloat16, 4) : RT_SLSTM_BWD(float, 4);
#undef RT_SLSTM_BWD
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 dr_grid((2 * hd + 2 + kTile - 1) / kTile, (hd + kTile - 1) / kTile, H);
  slstm_dr_kernel<<<dr_grid, kDrThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
