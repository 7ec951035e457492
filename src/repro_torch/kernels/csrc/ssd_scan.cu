// SSD (Mamba2-style, one scalar decay a head) for Hopper: the chunked scan
// in one launch, its backward in two, and the one-token decode step in one.
//
// Replaces: the reference's lax.scan of src/repro/models/ssm.py ::
// ssd_chunked (the scan at :236, its chunk step at :213), which XLA runs as
// one loop over chunks on the device, its gradient XLA's reverse scan; and
// ssd_decode_step (:241). Per (row b, head h), over x [B,S,H,P], b, c
// [B,S,H,N] (x's dtype), log_a [B,S,H] float32, from the state h [B,H,P,N]
// float32, in chunks of L positions (a short last chunk is the padded one):
//   la_t = inclusive cumsum of log_a within the chunk,
//   y_t = sum_{s<=t} exp(la_t - la_s) (C_t . B_s) x_s + exp(la_t) C_t . h,
//   h' = exp(la_end) h + sum_s exp(la_end - la_s) B_s (x) x_s,
// in float32, y cast to x's dtype once. The decay's exponent is formed only
// where s <= t (the port's repair of the reference's overflow in the masked
// corner), so no exp of a positive exponent is taken.
//
// What bounds it on this card: neither rate. A (b, h) chunk of 256 is
// ~6 MFLOP of f32 (the causal [L, L] matrix against N + P columns) on a
// few hundred KB, and the chunks of a (b, h) are a chain of nc steps. The
// intra-chunk matrix is 256 KB of f32 at L = 256, more than an SM holds,
// so it is never stored: a thread owns a row t of the chunk and walks the
// columns s <= t, recomputing C_t . B_s and the decay as it goes.
// Design: a CTA per (block of kPB value columns p, head, row), grid B * H *
// ceil(P / kPB), walks the chunks in order with its [kPB, N] slice of the
// state in shared memory; the chunk's B rows and x columns are in shared
// memory, C_t in the row's registers. The state slices of a (b, h) are
// independent, so no CTA waits on another. No tensor cores: the f32 path
// must hold a relative L2 of 1e-4, which TF32 or bf16 MMA would miss.
// The state width N runs in tiles of kN = 16 (hymba's 16), a CTA a tile: a
// row of B or C is 16 registers, zero past N. y (and dx) sum over n, so with
// more than one tile each CTA writes its partial in float32 and a second
// launch (the backward's reduction) sums the tiles in order; a second
// build for N <= 64 instead added a minute of nvcc and spilled.
// Backward: the forward saves the state at each chunk's start, [nc,B,H,P,N]
// f32; nothing per token. One CTA per the same (block, head, row) walks
// the chunks backwards carrying its slice of dh, recomputing la, the
// decays and the matrix from the saved state: a row pass (thread t over s
// <= t: dc_t and the row sums of d la) and a column pass (thread s over t
// >= s: dx_s, db_s and the column sums). dx and dh are complete in the CTA;
// db, dc and d la sum over p, so each CTA writes its partials and a second
// launch sums them over the value blocks in a fixed order, casts, and
// takes d log_a as the reverse cumsum of d la within each chunk. No
// atomics: a gradient is the same bits run after run.
// Decode: a thread per (b, h, value column p), the columns of a (b, h) over
// ceil(P / 1,024) CTAs: state' = exp(log_a) state + x_p b, then y_p =
// state' . c (the reference's order), the state written to a new tensor.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChunk = kThreads;  // a thread a row of the chunk
constexpr int kPB = 16;              // value columns (state rows) a CTA keeps
constexpr int kN = 16;               // state width: a row of B or C in a thread's registers
constexpr int kDecodeThreads = 1024;  // the decode's CTA: a thread a value column
constexpr int kMaxDevices = 64;

struct Fwd {
  const void *x, *b, *c;
  const float *log_a, *h0;
  void* y;
  float *hT, *saved;  // saved null: nothing saved
  float* ypart;       // [nt,B,S,H,P]: y by state tile when nt > 1
  int B, S, H, P, N, L, npb, nt;
};

struct Bwd {
  const void *x, *b, *c, *dy;
  const float *log_a, *saved, *dhT;
  void *dx, *db, *dc;
  float *dla, *dh0;
  float *db_part, *dc_part, *dla_part;  // [npb,B,S,H,N], [npb,B,S,H,N], [nt,npb,B,S,H]
  float* dx_part;                       // [nt,B,S,H,P]: dx by state tile when nt > 1
  int B, S, H, P, N, L, npb, nt;
};

struct Dec {
  const void *x, *b, *c;
  const float *log_a, *h0;
  void* y;
  float* h;
  int P, N;
};

// The CTA's (value block, state tile, head, row) from a flat grid.
struct Cta {
  int blk, tile, h, b, p0, n0;
};

__device__ __forceinline__ Cta cta_of(int npb, int nt, int H) {
  const int i = blockIdx.x;
  const int blk = i % npb, tile = (i / npb) % nt;
  return {blk, tile, (i / (npb * nt)) % H, i / (npb * nt * H), blk * kPB, tile * kN};
}

// The inclusive cumsum of the chunk's log_a in place, in order (one thread:
// L <= 256 adds, against the chunk's O(L^2) work).
__device__ __forceinline__ void cumsum_la(float* la, int Lk) {
  if (threadIdx.x == 0) {
    float a = 0.f;
    for (int s = 0; s < Lk; ++s) {
      a += la[s];
      la[s] = a;
    }
  }
}

template <typename T>
__device__ __forceinline__ float at(const T* a, long i) {
  return rt::to_f(a[i]);
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

constexpr int fwd_floats(int L) {
  return L * kN + L * kPB + 2 * L + kPB * kN;  // B rows, x columns, la, w, state slice
}

// kTiles: N past kN, a state tile a CTA (else the one tile starts at 0 and y
// is written as it is)
template <typename T, bool kTiles>
__global__ void __launch_bounds__(kThreads) ssd_fwd_kernel(Fwd p) {
  constexpr int kPer = (kPB * kN + kThreads - 1) / kThreads;  // state elements a thread
  extern __shared__ float sm[];
  const int L = p.L, tid = threadIdx.x;
  float* sB = sm;               // [L][kN]
  float* sX = sB + L * kN;      // [L][kPB]
  float* sLa = sX + L * kPB;    // [L]
  float* sW = sLa + L;          // [L] exp(la_end - la_s)
  float* sH = sW + L;           // [kPB][kN]
  const Cta q = cta_of(p.npb, p.nt, p.H);
  const int n0 = kTiles ? q.n0 : 0;
  const T* x = static_cast<const T*>(p.x);
  const T* bm = static_cast<const T*>(p.b);
  const T* cm = static_cast<const T*>(p.c);
  T* y = static_cast<T*>(p.y);
  const long PN = static_cast<long>(p.P) * p.N;
  const long hb = (static_cast<long>(q.b) * p.H + q.h) * PN;  // this (b, h) in [B,H,P,N]
  for (int e = tid; e < kPB * kN; e += kThreads) {
    const int j = e / kN, n = e % kN;
    sH[e] = q.p0 + j < p.P && n0 + n < p.N
                ? p.h0[hb + static_cast<long>(q.p0 + j) * p.N + n0 + n] : 0.f;
  }
  const int nc = (p.S + L - 1) / L;
  for (int k = 0; k < nc; ++k) {
    const int t0 = k * L, Lk = min(L, p.S - t0);
    __syncthreads();  // sH settled; the last chunk's reads of sB, sX, sLa, sW done
    if (p.saved != nullptr) {
      float* sv = p.saved + static_cast<long>(k) * p.B * p.H * PN + hb;
      for (int e = tid; e < kPB * kN; e += kThreads) {
        const int j = e / kN, n = e % kN;
        if (q.p0 + j < p.P && n0 + n < p.N)
          sv[static_cast<long>(q.p0 + j) * p.N + n0 + n] = sH[e];
      }
    }
    const int t = tid;
    const long row = static_cast<long>(q.b) * p.S + t0 + t;  // (b, t0 + t) in [B,S]
    float cr[kN];
    if (t < L) {
      const bool live = t < Lk;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const long i = (row * p.H + q.h) * p.N + n0 + n;
        const bool in = live && n0 + n < p.N;
        sB[t * kN + n] = in ? at(bm, i) : 0.f;
        cr[n] = in ? at(cm, i) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPB; ++j)
        sX[t * kPB + j] = live && q.p0 + j < p.P
                              ? at(x, (row * p.H + q.h) * p.P + q.p0 + j) : 0.f;
      sLa[t] = live ? p.log_a[row * p.H + q.h] : 0.f;
    }
    __syncthreads();
    cumsum_la(sLa, Lk);
    __syncthreads();
    const float la_end = sLa[Lk - 1];
    if (t < Lk) {
      sW[t] = expf(la_end - sLa[t]);
      const float lat = sLa[t];
      float acc[kPB];
#pragma unroll
      for (int j = 0; j < kPB; ++j) acc[j] = 0.f;
      const int last = min(Lk - 1, t | 31);  // the warp's last row
#pragma unroll 1
      for (int s = 0; s <= last; ++s) {
        if (s <= t) {
          float g = 0.f;
#pragma unroll
          for (int n = 0; n < kN; ++n) g = fmaf(cr[n], sB[s * kN + n], g);
          const float m = g * expf(lat - sLa[s]);
#pragma unroll
          for (int j = 0; j < kPB; ++j) acc[j] = fmaf(m, sX[s * kPB + j], acc[j]);
        }
      }
      const float et = expf(lat);
#pragma unroll
      for (int j = 0; j < kPB; ++j) {
        float ch = 0.f;
#pragma unroll
        for (int n = 0; n < kN; ++n) ch = fmaf(cr[n], sH[j * kN + n], ch);
        if (q.p0 + j >= p.P) continue;
        const long o = (row * p.H + q.h) * p.P + q.p0 + j;
        if constexpr (kTiles)
          p.ypart[static_cast<long>(q.tile) * p.B * p.S * p.H * p.P + o] = acc[j] + ch * et;
        else
          y[o] = rt::from_f<T>(acc[j] + ch * et);
      }
    }
    __syncthreads();  // every read of sH for y done, sW written
    const float e_end = expf(la_end);
    float nh[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < kPB * kN) {
        const int j = e / kN, n = e % kN;
        float acc = 0.f;
#pragma unroll 1
        for (int s = 0; s < Lk; ++s) acc = fmaf(sW[s] * sX[s * kPB + j], sB[s * kN + n], acc);
        nh[i] = fmaf(e_end, sH[e], acc);
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < kPB * kN) sH[e] = nh[i];
    }
  }
  __syncthreads();
  for (int e = tid; e < kPB * kN; e += kThreads) {
    const int j = e / kN, n = e % kN;
    if (q.p0 + j < p.P && n0 + n < p.N)
      p.hT[hb + static_cast<long>(q.p0 + j) * p.N + n0 + n] = sH[e];
  }
}

// ---------------------------------------------------------------------------
// y = the sum of the state tiles' partials, in tile order (nt > 1 only)
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_fwd_reduce_kernel(Fwd p) {
  const long total = static_cast<long>(p.B) * p.S * p.H * p.P;
  for (long i = blockIdx.x * static_cast<long>(kThreads) + threadIdx.x; i < total;
       i += static_cast<long>(gridDim.x) * kThreads) {
    float a = 0.f;
    for (int t = 0; t < p.nt; ++t) a += p.ypart[t * total + i];
    static_cast<T*>(p.y)[i] = rt::from_f<T>(a);
  }
}

// ---------------------------------------------------------------------------
// backward
// ---------------------------------------------------------------------------

constexpr int bwd_floats(int L) {
  // B and C rows, x and dy columns, la, e, w, d la, R, the state and dh slices
  return 2 * L * kN + 2 * L * kPB + 5 * L + 2 * kPB * kN;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_kernel(Bwd p) {
  constexpr int kPer = (kPB * kN + kThreads - 1) / kThreads;
  extern __shared__ float sm[];
  const int L = p.L, tid = threadIdx.x;
  float* sB = sm;               // [L][kN]
  float* sC = sB + L * kN;      // [L][kN]
  float* sX = sC + L * kN;      // [L][kPB]
  float* sDY = sX + L * kPB;    // [L][kPB]
  float* sLa = sDY + L * kPB;   // [L]
  float* sE = sLa + L;          // [L] exp(la_t)
  float* sW = sE + L;           // [L] exp(la_end - la_s)
  float* sD = sW + L;           // [L] d la
  float* sR = sD + L;           // [L] w_s (x_s (x) B_s) : dh
  float* sH = sR + L;           // [kPB][kN] the chunk's start state
  float* sG = sH + kPB * kN;    // [kPB][kN] dh, carried
  const Cta q = cta_of(p.npb, p.nt, p.H);
  const T* x = static_cast<const T*>(p.x);
  const T* bm = static_cast<const T*>(p.b);
  const T* cm = static_cast<const T*>(p.c);
  const T* dy = static_cast<const T*>(p.dy);
  T* dx = static_cast<T*>(p.dx);
  const long PN = static_cast<long>(p.P) * p.N;
  const long hb = (static_cast<long>(q.b) * p.H + q.h) * PN;
  const long rows = static_cast<long>(p.B) * p.S * p.H;
  const long part = q.blk * rows;                                // db's, dc's partials
  const long lpart = (static_cast<long>(q.tile) * p.npb + q.blk) * rows;  // d la's
  for (int e = tid; e < kPB * kN; e += kThreads) {
    const int j = e / kN, n = e % kN;
    sG[e] = q.p0 + j < p.P && q.n0 + n < p.N
                ? p.dhT[hb + static_cast<long>(q.p0 + j) * p.N + q.n0 + n] : 0.f;
  }
  const int nc = (p.S + L - 1) / L;
  for (int k = nc - 1; k >= 0; --k) {
    const int t0 = k * L, Lk = min(L, p.S - t0);
    __syncthreads();  // the last chunk done with shared memory
    const float* sv = p.saved + static_cast<long>(k) * p.B * p.H * PN + hb;
    for (int e = tid; e < kPB * kN; e += kThreads) {
      const int j = e / kN, n = e % kN;
      sH[e] = q.p0 + j < p.P && q.n0 + n < p.N
                  ? sv[static_cast<long>(q.p0 + j) * p.N + q.n0 + n] : 0.f;
    }
    const int t = tid;
    const long row = static_cast<long>(q.b) * p.S + t0 + t;
    if (t < L) {
      const bool live = t < Lk;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const long i = (row * p.H + q.h) * p.N + q.n0 + n;
        const bool in = live && q.n0 + n < p.N;
        sB[t * kN + n] = in ? at(bm, i) : 0.f;
        sC[t * kN + n] = in ? at(cm, i) : 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPB; ++j) {
        const long i = (row * p.H + q.h) * p.P + q.p0 + j;
        const bool in = live && q.p0 + j < p.P;
        sX[t * kPB + j] = in ? at(x, i) : 0.f;
        sDY[t * kPB + j] = in ? at(dy, i) : 0.f;
      }
      sLa[t] = live ? p.log_a[row * p.H + q.h] : 0.f;
    }
    __syncthreads();
    cumsum_la(sLa, Lk);
    __syncthreads();
    const float la_end = sLa[Lk - 1], e_end = expf(la_end);
    if (t < Lk) {
      sE[t] = expf(sLa[t]);
      sW[t] = expf(la_end - sLa[t]);
    }
    __syncthreads();
    if (t < Lk) {
      // row pass: dc_t and d la_t's row sum, over s <= t
      float cr[kN], dyr[kPB], dcr[kN];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        cr[n] = sC[t * kN + n];
        dcr[n] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPB; ++j) dyr[j] = sDY[t * kPB + j];
      const float lat = sLa[t];
      float drow = 0.f;
      const int last = min(Lk - 1, t | 31);
#pragma unroll 1
      for (int s = 0; s <= last; ++s) {
        if (s <= t) {
          float g = 0.f, d = 0.f;
#pragma unroll
          for (int n = 0; n < kN; ++n) g = fmaf(cr[n], sB[s * kN + n], g);
#pragma unroll
          for (int j = 0; j < kPB; ++j) d = fmaf(dyr[j], sX[s * kPB + j], d);
          const float ed = expf(lat - sLa[s]) * d;
#pragma unroll
          for (int n = 0; n < kN; ++n) dcr[n] = fmaf(ed, sB[s * kN + n], dcr[n]);
          drow = fmaf(ed, g, drow);
        }
      }
      // the inter-chunk term: with u = dy_t . h, e_t u into dc_t and e_t C_t . u
      // (= e_t dy_t . y_inter's C_t . h) into d la_t
      const float et = sE[t];
      float cu = 0.f;
      float* dcp = p.dc_part + (part + row * p.H + q.h) * p.N + q.n0;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        float u = 0.f;
#pragma unroll
        for (int j = 0; j < kPB; ++j) u = fmaf(dyr[j], sH[j * kN + n], u);
        cu = fmaf(cr[n], u, cu);
        if (q.n0 + n < p.N) dcp[n] = fmaf(et, u, dcr[n]);
      }
      drow = fmaf(et, cu, drow);

      // column pass: dx_s, db_s and d la_s's column sum, over t >= s
      const int s = t;
      float br[kN], xr[kPB], dxr[kPB], dbr[kN];
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        br[n] = sB[s * kN + n];
        dbr[n] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kPB; ++j) {
        xr[j] = sX[s * kPB + j];
        dxr[j] = 0.f;
      }
      const float las = sLa[s];
      float dcol = 0.f;
#pragma unroll 1
      for (int u = s & ~31; u < Lk; ++u) {  // from the warp's first row
        if (u >= s) {
          float g = 0.f, d = 0.f;
#pragma unroll
          for (int n = 0; n < kN; ++n) g = fmaf(sC[u * kN + n], br[n], g);
#pragma unroll
          for (int j = 0; j < kPB; ++j) d = fmaf(sDY[u * kPB + j], xr[j], d);
          const float e = expf(sLa[u] - las);
          const float ge = g * e, ed = e * d;
#pragma unroll
          for (int j = 0; j < kPB; ++j) dxr[j] = fmaf(ge, sDY[u * kPB + j], dxr[j]);
#pragma unroll
          for (int n = 0; n < kN; ++n) dbr[n] = fmaf(ed, sC[u * kN + n], dbr[n]);
          dcol = fmaf(ed, g, dcol);
        }
      }
      // the state terms: w_s B_s . dh into dx_s, w_s x_s . dh into db_s
      const float ws = sW[s];
      float r = 0.f;
#pragma unroll
      for (int j = 0; j < kPB; ++j) {
        float v = 0.f;
#pragma unroll
        for (int n = 0; n < kN; ++n) v = fmaf(br[n], sG[j * kN + n], v);
        dxr[j] = fmaf(ws, v, dxr[j]);
        r = fmaf(xr[j], v, r);
        if (q.p0 + j >= p.P) continue;
        const long o = (row * p.H + q.h) * p.P + q.p0 + j;
        if (p.nt == 1)
          dx[o] = rt::from_f<T>(dxr[j]);
        else
          p.dx_part[q.tile * rows * p.P + o] = dxr[j];
      }
      float* dbp = p.db_part + (part + row * p.H + q.h) * p.N + q.n0;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        float v = 0.f;
#pragma unroll
        for (int j = 0; j < kPB; ++j) v = fmaf(xr[j], sG[j * kN + n], v);
        if (q.n0 + n < p.N) dbp[n] = fmaf(ws, v, dbr[n]);
      }
      r *= ws;
      sR[s] = r;
      sD[s] = drow - dcol - r;
    }
    __syncthreads();
    // the chunk's end: e_end h : dh + sum_s R_s into d la at its last real row
    if (tid < 32) {
      float a = 0.f, hh = 0.f;
      for (int i = tid; i < Lk; i += 32) a += sR[i];
      for (int e = tid; e < kPB * kN; e += 32) hh = fmaf(sG[e], sH[e], hh);
      a = rt::warp_sum(a);
      hh = rt::warp_sum(hh);
      if (tid == 0) sD[Lk - 1] += fmaf(e_end, hh, a);
    }
    // dh for the previous chunk: e_end dh + sum_t e_t dy_t (x) C_t
    float nd[kPer];
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < kPB * kN) {
        const int j = e / kN, n = e % kN;
        float acc = 0.f;
#pragma unroll 1
        for (int u = 0; u < Lk; ++u) acc = fmaf(sE[u] * sDY[u * kPB + j], sC[u * kN + n], acc);
        nd[i] = fmaf(e_end, sG[e], acc);
      }
    }
    __syncthreads();  // warp 0's reads of sG, sH done; sD final
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int e = tid + i * kThreads;
      if (e < kPB * kN) sG[e] = nd[i];
    }
    if (t < Lk) p.dla_part[lpart + row * p.H + q.h] = sD[t];
  }
  __syncthreads();
  for (int e = tid; e < kPB * kN; e += kThreads) {
    const int j = e / kN, n = e % kN;
    if (q.p0 + j < p.P && q.n0 + n < p.N)
      p.dh0[hb + static_cast<long>(q.p0 + j) * p.N + q.n0 + n] = sG[e];
  }
}

// The second launch: a CTA per (chunk, head, row) sums db, dc and d la over
// the value blocks (d la also over the state tiles) in order, casts db and
// dc, and writes d log_a, the reverse cumsum of d la within the chunk; with
// more than one state tile, dx is the sum of its tiles' partials.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_kernel(Bwd p) {
  __shared__ float sD[kMaxChunk];
  const int nc = (p.S + p.L - 1) / p.L;
  const int k = blockIdx.x % nc, h = (blockIdx.x / nc) % p.H, b = blockIdx.x / (nc * p.H);
  const int t0 = k * p.L, Lk = min(p.L, p.S - t0);
  const long rows = static_cast<long>(p.B) * p.S * p.H;  // one block's partials
  const long first = (static_cast<long>(b) * p.S + t0) * p.H + h;
  T* db = static_cast<T*>(p.db);
  T* dc = static_cast<T*>(p.dc);
  for (int e = threadIdx.x; e < Lk * p.N; e += kThreads) {
    const int t = e / p.N, n = e % p.N;
    const long i = (first + static_cast<long>(t) * p.H) * p.N + n;
    float sb = 0.f, sc = 0.f;
    for (int j = 0; j < p.npb; ++j) {
      sb += p.db_part[j * rows * p.N + i];
      sc += p.dc_part[j * rows * p.N + i];
    }
    db[i] = rt::from_f<T>(sb);
    dc[i] = rt::from_f<T>(sc);
  }
  if (p.nt > 1) {
    for (int e = threadIdx.x; e < Lk * p.P; e += kThreads) {
      const long i = (first + static_cast<long>(e / p.P) * p.H) * p.P + e % p.P;
      float a = 0.f;
      for (int j = 0; j < p.nt; ++j) a += p.dx_part[j * rows * p.P + i];
      static_cast<T*>(p.dx)[i] = rt::from_f<T>(a);
    }
  }
  for (int t = threadIdx.x; t < Lk; t += kThreads) {
    const long i = first + static_cast<long>(t) * p.H;
    float s = 0.f;
    for (int j = 0; j < p.npb * p.nt; ++j) s += p.dla_part[j * rows + i];
    sD[t] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float a = 0.f;
    for (int t = Lk - 1; t >= 0; --t) {
      a += sD[t];
      p.dla[first + static_cast<long>(t) * p.H] = a;
    }
  }
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

template <typename TX, typename TB>
__global__ void ssd_decode_kernel(Dec p) {
  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= p.P) return;
  const long bh = blockIdx.x;
  const TX* x = static_cast<const TX*>(p.x);
  const TB* bm = static_cast<const TB*>(p.b) + bh * p.N;
  const TB* cm = static_cast<const TB*>(p.c) + bh * p.N;
  const float a = expf(p.log_a[bh]);
  const float xv = at(x, bh * p.P + j);
  const long o = (bh * p.P + j) * p.N;
  float y = 0.f;
  for (int n = 0; n < p.N; ++n) {
    const float s = fmaf(a, p.h0[o + n], xv * at(bm, n));
    p.h[o + n] = s;
    y = fmaf(s, at(cm, n), y);
  }
  static_cast<TX*>(p.y)[bh * p.P + j] = rt::from_f<TX>(y);
}

constexpr int kDefaultSmem = 48 * 1024;
static_assert(fwd_floats(kMaxChunk) * sizeof(float) <= kDefaultSmem, "forward past 48 KB");

template <typename T>
int launch_fwd(const Fwd& p, cudaStream_t st) {
  const int smem = fwd_floats(p.L) * static_cast<int>(sizeof(float));
  if (p.nt == 1) {
    ssd_fwd_kernel<T, false><<<p.B * p.H * p.npb, kThreads, smem, st>>>(p);
  } else {
    ssd_fwd_kernel<T, true><<<p.B * p.H * p.npb * p.nt, kThreads, smem, st>>>(p);
    const long total = static_cast<long>(p.B) * p.S * p.H * p.P;
    const long grid = (total + kThreads - 1) / kThreads;
    ssd_fwd_reduce_kernel<T><<<static_cast<int>(grid < 65536 ? grid : 65536), kThreads, 0,
                               st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The backward's 71 KB at a chunk of 256 is past the default 48 KB: its
// limit is raised once a device.
template <typename T>
int launch_bwd(const Bwd& p, cudaStream_t st) {
  static bool raised[kMaxDevices] = {};  // racing threads set the same value
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(dev < kMaxDevices && raised[dev])) {
    err = cudaFuncSetAttribute(ssd_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bwd_floats(kMaxChunk) * static_cast<int>(sizeof(float)));
    if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int smem = bwd_floats(p.L) * static_cast<int>(sizeof(float));
  ssd_bwd_kernel<T><<<p.B * p.H * p.npb * p.nt, kThreads, smem, st>>>(p);
  const int nc = (p.S + p.L - 1) / p.L;
  ssd_bwd_reduce_kernel<T><<<p.B * p.H * nc, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool shape_ok(int B, int S, int H, int P, int N, int L) {
  const long ctas = static_cast<long>(B) * H * ((P + kPB - 1) / kPB) * ((N + kN - 1) / kN);
  return B >= 1 && S >= 1 && H >= 1 && P >= 1 && N >= 1 && L >= 1 &&
         L <= kMaxChunk && ctas <= 0x7fffffffL &&
         static_cast<long>(B) * H * ((S + L - 1) / L) <= 0x7fffffffL;
}

}  // namespace

extern "C" int rt_ssd_max_chunk() { return kMaxChunk; }
extern "C" int rt_ssd_block_n() { return kN; }
extern "C" int rt_ssd_block_p() { return kPB; }

// y [B,S,H,P] in x's dtype, hT [B,H,P,N] f32 and, unless null, saved
// [nc,B,H,P,N] f32 (the state at each chunk's start) from x, b, c, log_a
// and h0, in chunks of L. ypart [nt,B,S,H,P] f32 (the wrapper's scratch,
// nt = ceil(N / rt_ssd_block_n())) when nt > 1, else null.
extern "C" int rt_ssd_fwd(const void* x, const void* b, const void* c, const void* log_a,
                          const void* h0, void* y, void* hT, void* saved, void* ypart, int B,
                          int S, int H, int P, int N, int L, int dtype, void* stream) {
  const int nt = (N + kN - 1) / kN;
  if (!shape_ok(B, S, H, P, N, L) || (nt > 1) != (ypart != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Fwd p{x, b, c, static_cast<const float*>(log_a), static_cast<const float*>(h0), y,
        static_cast<float*>(hT), static_cast<float*>(saved), static_cast<float*>(ypart), B, S, H,
        P, N, L, (P + kPB - 1) / kPB, nt};
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == rt::kBF16 ? launch_fwd<__nv_bfloat16>(p, st) : launch_fwd<float>(p, st);
}

// Both launches of the backward: dx, db, dc (the inputs' dtype), dla, dh0
// (f32) from the forward's inputs, its saved states and the gradients dy,
// dhT. Scratch (f32, the wrapper's): db_part, dc_part [npb,B,S,H,N],
// dla_part [nt,npb,B,S,H], npb = ceil(P / rt_ssd_block_p()), nt = ceil(N /
// rt_ssd_block_n()); dx_part [nt,B,S,H,P] when nt > 1, else null.
extern "C" int rt_ssd_bwd(const void* x, const void* b, const void* c, const void* log_a,
                          const void* saved, const void* dy, const void* dhT, void* dx,
                          void* db, void* dc, void* dla, void* dh0, void* db_part,
                          void* dc_part, void* dla_part, void* dx_part, int B, int S, int H,
                          int P, int N, int L, int dtype, void* stream) {
  const int nt = (N + kN - 1) / kN;
  if (!shape_ok(B, S, H, P, N, L) || (nt > 1) != (dx_part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* a) { return static_cast<const float*>(a); };
  auto w = [](void* a) { return static_cast<float*>(a); };
  Bwd p{x, b, c, dy, f(log_a), f(saved), f(dhT), dx, db, dc, w(dla), w(dh0), w(db_part),
        w(dc_part), w(dla_part), w(dx_part), B, S, H, P, N, L, (P + kPB - 1) / kPB, nt};
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == rt::kBF16 ? launch_bwd<__nv_bfloat16>(p, st) : launch_bwd<float>(p, st);
}

// One token: h = exp(log_a) h0 + x (x) b, y = h . c, over x [B,H,P]
// (x_dtype), b, c [B,H,N] (bc_dtype), log_a [B,H] and h0 [B,H,P,N] f32.
extern "C" int rt_ssd_decode(const void* x, const void* b, const void* c, const void* log_a,
                             const void* h0, void* y, void* h, int B, int H, int P, int N,
                             int x_dtype, int bc_dtype, void* stream) {
  if (B < 1 || H < 1 || P < 1 || N < 1 || static_cast<long>(B) * H > 0x7fffffffL ||
      (P + kDecodeThreads - 1) / kDecodeThreads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Dec p{x, b, c, static_cast<const float*>(log_a), static_cast<const float*>(h0), y,
        static_cast<float*>(h), P, N};
  auto st = static_cast<cudaStream_t>(stream);
  const int threads = P < kDecodeThreads ? (P + 31) / 32 * 32 : kDecodeThreads;
  const dim3 grid(B * H, (P + threads - 1) / threads);
  const bool xb = x_dtype == rt::kBF16, bb = bc_dtype == rt::kBF16;
  if (xb && bb)
    ssd_decode_kernel<__nv_bfloat16, __nv_bfloat16><<<grid, threads, 0, st>>>(p);
  else if (xb)
    ssd_decode_kernel<__nv_bfloat16, float><<<grid, threads, 0, st>>>(p);
  else if (bb)
    ssd_decode_kernel<float, __nv_bfloat16><<<grid, threads, 0, st>>>(p);
  else
    ssd_decode_kernel<float, float><<<grid, threads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
