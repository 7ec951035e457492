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
// What bounds it: the chain of S dependent steps. A step is 8 hd^2 FLOPs a
// (b, h) (hd = 192: 0.3 MFLOP), and it reads all of r's head, 4 hd^2 f32
// (590 KB at hd = 192): more than one SM's shared memory, and streamed
// from L2 every step it is what a step waits for.
// Design: a thread-block cluster of kNC = 8 CTAs per (head, kRows batch
// rows). CTA c owns elements [c E, (c + 1) E) of the head (E = hd / 8, 24
// at hd = 192) and keeps the 4 E columns of r that feed them ([z | i | f |
// o] of its elements; 74 KB at hd = 192) in shared memory for all S steps,
// so no step reads r from memory. A step: thread (row, column) of 4 E
// columns forms that column of h r from the full h in shared memory;
// thread (row, element) forms z, o and its share of the two per-head
// means, one warp a row; the shares go to every CTA of the cluster
// (distributed shared memory) and a cluster barrier; every CTA sums them
// in the same order, so all hold the same gates, and each writes its
// elements' h into every CTA's copy of h; a second cluster barrier.
// Backward: the forward saves each step's c, n, h, z, o, log_i, the forget
// preactivation's mean and m. The same clusters step back carrying dh,
// dc, dn and dm: a step's per-head sums go round the cluster as in the
// forward, each CTA's four gradients of its elements (drec_t, also saved)
// meet its own columns of r, and the partial dh_{t-1} = r drec_t of its
// columns goes to the CTA that owns each element, which sums the kNC
// shares in order. A second launch forms dr = sum over rows and steps of
// h_{t-1} (x) drec_t as a tiled product in a fixed order. No atomics.
#include <cooperative_groups.h>

#include "xlstm.cuh"

namespace cg = cooperative_groups;

namespace {

using rt::Gates;

constexpr int kRows = 4;         // batch rows a cluster takes
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
  int B, S, H, hd;
};

struct Bwd {
  const float *r, *h_all, *c_all, *n_all, *z_all, *o_all, *li_all, *pf_all, *m_all;
  const void* dhs;
  const float *dc, *dn, *dh, *dm;
  void *dzx, *dix, *dfx, *dox;
  float *dr, *dc0, *dn0, *dh0, *dm0, *drec;
  int B, S, H, hd;
};

// A CTA's shape: E elements, CW = 4 E columns of r (row stride CW + 1 in
// shared memory: the backward reads r's slice by rows, the forward by
// columns, both without bank conflicts).
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

template <typename T>
__global__ void __cluster_dims__(kNC, 1, 1) __launch_bounds__(kMaxThreads)
    slstm_fwd_kernel(Fwd p) {
  cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const int hh = blockIdx.z, hd = p.hd, S = p.S, H = p.H, tid = threadIdx.x;
  const Shape sh = shape(hd);
  const int hdp = kNC * sh.E;  // a row of h in shared memory
  const Role x = role(c, sh.E, hd, p.B);
  const bool save = p.h_all != nullptr;
  extern __shared__ float smem[];
  float* Rs = smem;                           // [hd][ld]
  float* hs = Rs + hd * sh.ld;                // [kRows][hdp], the whole h
  float* rec = hs + kRows * hdp;              // [kRows][CW], this CTA's columns of h r
  float* part = rec + kRows * sh.CW;          // [kNC][kRows][2], the means' shares

  load_r(Rs, p.r + static_cast<long>(hh) * hd * 4 * hd, c, hd, sh);
  for (int i = tid; i < kRows * hdp; i += blockDim.x) {  // the rows' whole h
    const int r = i / hdp, e = i % hdp, b = blockIdx.y * kRows + r;
    hs[i] = e < hd && b < p.B ? p.h0[(static_cast<long>(b) * H + hh) * hd + e] : 0.f;
  }
  float cc = 0.f, n = 0.f, m = 0.f;
  const long si = (static_cast<long>(x.b) * H + hh) * hd + x.e;  // state [B,H,hd]
  if (x.on) {
    cc = p.c0[si];
    n = p.n0[si];
    m = p.m0[static_cast<long>(x.b) * H + hh];
    if (save) {
      const long a0 = (static_cast<long>(x.b) * (S + 1) * H + hh) * hd + x.e;
      p.h_all[a0] = p.h0[si];
      p.c_all[a0] = cc;
      p.n_all[a0] = n;
      if (x.e == 0) p.m_all[static_cast<long>(x.b) * (S + 1) * H + hh] = m;
    }
  }
  float hv = x.on ? p.h0[si] : 0.f;
  cluster.sync();  // every CTA running before the first remote store
  const int mr = tid / sh.CW, mj = tid % sh.CW;  // matvec role: (row, column)
  const int rows = min(kRows, p.B - static_cast<int>(blockIdx.y) * kRows);
  // the step's inputs, loaded a step ahead: [B,S,H,hd] at (b, t, h, e)
  auto load = [&](float* in, int t) {
    if (!x.on || t >= S) return;
    const long xi = ((static_cast<long>(x.b) * S + t) * H + hh) * hd + x.e;
    in[0] = rt::to_f(static_cast<const T*>(p.zx)[xi]);
    in[1] = rt::to_f(static_cast<const T*>(p.ix)[xi]);
    in[2] = rt::to_f(static_cast<const T*>(p.fx)[xi]);
    in[3] = rt::to_f(static_cast<const T*>(p.ox)[xi]);
  };
  float nxt[4] = {};
  load(nxt, 0);
  for (int t = 0; t < S; ++t) {
    const long xi = ((static_cast<long>(x.b) * S + t) * H + hh) * hd + x.e;  // [B,S,H,hd]
    const float zt = nxt[0], it = nxt[1], ft = nxt[2], ot = nxt[3];
    load(nxt, t + 1);
    if (mr < rows) {
      const float* hr = hs + mr * hdp;
      float acc = 0.f;
#pragma unroll 8
      for (int dd = 0; dd < hd; ++dd) acc += hr[dd] * Rs[dd * sh.ld + mj];
      rec[mr * sh.CW + mj] = acc;
    }
    __syncthreads();
    float z = 0.f, o = 0.f, pi = 0.f, pf = 0.f;
    if (x.on) {
      const float* rr = rec + x.r * sh.CW + x.el;
      z = tanhf(zt + rr[0]);
      pi = it + rr[sh.E];
      pf = ft + rr[2 * sh.E];
      o = rt::sigmoid(ot + rr[3 * sh.E]);
    }
    if (x.r < kRows) {
      pi = rt::warp_sum(pi);
      pf = rt::warp_sum(pf);
      if (x.el < kNC) {  // lane q sends this CTA's shares to CTA q
        float* dst = cluster.map_shared_rank(part, x.el) + (c * kRows + x.r) * 2;
        dst[0] = pi;
        dst[1] = pf;
      }
    }
    cluster.sync();
    if (x.on) {
      float s_i = 0.f, s_f = 0.f;
      for (int q = 0; q < kNC; ++q) {
        s_i += part[(q * kRows + x.r) * 2];
        s_f += part[(q * kRows + x.r) * 2 + 1];
      }
      const float li = s_i / hd, pfm = s_f / hd;
      const Gates g = rt::gates(li, rt::log_sigmoid(pfm), m);
      cc = g.f * cc + g.i * z;
      n = g.f * n + g.i;
      hv = o * cc / fmaxf(n, 1.f);
      for (int q = 0; q < kNC; ++q) cluster.map_shared_rank(hs, q)[x.r * hdp + x.e] = hv;
      static_cast<T*>(p.hs)[xi] = rt::from_f<T>(hv);
      if (save) {
        const long a = ((static_cast<long>(x.b) * (S + 1) + t + 1) * H + hh) * hd + x.e;
        p.h_all[a] = hv;
        p.c_all[a] = cc;
        p.n_all[a] = n;
        p.z_all[xi] = z;
        p.o_all[xi] = o;
        if (x.e == 0) {
          const long gi = (static_cast<long>(x.b) * S + t) * H + hh;
          p.li_all[gi] = li;
          p.pf_all[gi] = pfm;
          p.m_all[(static_cast<long>(x.b) * (S + 1) + t + 1) * H + hh] = g.m;
        }
      }
      m = g.m;
    }
    cluster.sync();
  }
  if (x.on) {
    p.c[si] = cc;
    p.n[si] = n;
    p.h[si] = hv;
    if (x.e == 0) p.m[static_cast<long>(x.b) * H + hh] = m;
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

size_t fwd_smem(int hd) {
  const Shape sh = shape(hd);
  return sizeof(float) * (hd * sh.ld + kRows * kNC * sh.E + kRows * sh.CW + kNC * kRows * 2);
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

size_t fwd_allowed[2] = {0, 0}, bwd_allowed[2] = {0, 0};  // by dtype code

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
  Fwd p{zx, ix, fx, ox, f(r), f(c0), f(n0), f(h0), f(m0), hs, w(c), w(n), w(h), w(m),
        w(h_all), w(c_all), w(n_all), w(z_all), w(o_all), w(li_all), w(pf_all), w(m_all),
        B, S, H, hd};
  const dim3 grid(kNC, (B + kRows - 1) / kRows, H);
  const size_t bytes = fwd_smem(hd);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == rt::kBF16) {
    err = allow_smem(slstm_fwd_kernel<__nv_bfloat16>, bytes, fwd_allowed[1]);
    if (err == cudaSuccess)
      slstm_fwd_kernel<__nv_bfloat16><<<grid, threads_for(hd), bytes, st>>>(p);
  } else {
    err = allow_smem(slstm_fwd_kernel<float>, bytes, fwd_allowed[0]);
    if (err == cudaSuccess) slstm_fwd_kernel<float><<<grid, threads_for(hd), bytes, st>>>(p);
  }
  return static_cast<int>(err != cudaSuccess ? err : cudaGetLastError());
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
