// SSD (Mamba2-style, one scalar decay a head) for Hopper: the chunked scan
// in one launch, its backward in one, and the one-token decode step in one.
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
// in float32, y cast to x's dtype once. The decay is always the difference
// exp(la_t - la_s), its exponent formed only where s <= t (the port's repair
// of the reference's overflow in the masked corner): a 256-token chunk's
// summed decay passes 88 at hymba-1.5b's gates, so exp(la_t) exp(-la_s)
// would overflow.
//
// What bounds it on this card: a (b, h) chunk of 256 is the causal [L, L]
// matrix M = (C B^T) o E against N + P columns, ~3 MFLOP on ~50 KB, and the
// chunks of a (b, h) are a chain. So the chunk's products run on the tensor
// cores (mma.sync m16n8k16, mma.cuh) and M never leaves registers, as flash
// attention keeps P: a warp forms a 16 x 16 tile of C B^T in two
// accumulators, applies the decay to the fragment, and feeds it, split into
// bf16 hi + lo parts, as the A fragment of the product with X's rows. Only
// tiles on or below the diagonal are formed, and the 16-row strips are dealt
// to the 8 warps in balanced pairs (strip i with strip L/16 - 1 - i: 17 tiles
// a warp at L = 256). x, B, C and dy are exact in bf16; the float32 operands
// (M, w o B, e o dy, the states h and dh) go in as hi + lo (mma.cuh), and
// float32 inputs split alike. The cumsums are warp scans, the warps' totals
// added in order. A chunk's rows arrive by cp.async (bf16). A CTA takes kP =
// 64 value columns and 16 state columns of a (head, row), so C B^T and the
// decay are formed once a chunk at hymba-1.5b's P = 64, and each warp holds
// a 16 x 8 tile of the CTA's [64 x 16] slice of a state (Slice).
//
// The chain: a CTA takes one chunk at a time, and the CTAs of kc = min(chunks,
// 4) consecutive chunks of a slice form a thread-block cluster. Each forms
// its chunk's own change of the state from zero (forward X^T (w o B),
// backward dy^T (e o C)) and its e_end into its shared memory; after one
// cluster barrier each reads its peers' through distributed shared memory
// and walks h_{k+1} = e_end_k h_k + dH_k (backward dh_k = e_end_k dh_{k+1} +
// ..., from the last chunk) over the cluster's chunks in order (walk). Every
// CTA of the cluster runs the same steps in the same order, so all hold the
// same bits, the saved states included, and carry the state on to the next
// kc chunks. At hymba-1.5b's train shape (B = 2, 512 tokens, chunks of 256:
// two chunks a slice) the grid is 100 CTAs forward and backward, one chunk
// each, all resident at once on the 132 SMs (a CTA an SM, by its
// registers). What is left is the tile loops' latency: with 8 warps a CTA
// each scheduler has two warps.
// Forward, a chunk: the loads and la's scan, w o B, dH_k; the barrier and
// the walk; the chunk's start state saved and put in shared memory as bf16
// parts; then each warp's strips, y = e_t C_t . h + M X over their tiles,
// written once. Past N = 16 each CTA's y is a partial over its state
// columns (C B^T sums over n), written in float32 and summed in tile order
// by a second launch.
// Backward: the forward saves the state at each chunk's start, [nc,B,H,P,N]
// f32; nothing per token. A chunk, its state recomputed from the saved one,
// with G = C B^T, D = dy x^T and E the decay:
//   its change of dh, dy^T (e o C) (dy's fragments scaled by e_t as they
//     load), out to the cluster (the barrier's arrive);
//   a row pass (a warp over its strips' tiles (t, s <= t)): dc_t = sum_s E
//     D B_s + e_t dy_t . h and the row sums of Q = E G D;
//   the barrier's wait and the walk: dh at the chunk's end;
//   a column pass (the tiles transposed, (s, t >= s)): dx_s = sum_t E G dy_t
//     + w_s B_s . dh, db_s = sum_t E D C_t + w_s x_s . dh, the column sums
//     and R_s = w_s (x_s (x) B_s) : dh;
//   d la = rows - columns - R + e_t dy_t . (C_t . h), the chunk's end term
//     e_end h : dh + sum_s R_s at its last row, d log_a its reverse cumsum.
// Each pass forms its tiles' G, D and E itself (twice a chunk). When the CTA
// holds all of P and N (P <= 64, N <= 16: hymba-1.5b) every gradient is
// complete in it: one launch. Otherwise db, dc and d la are partials over
// the value blocks (dx and d la over the state tiles), written in float32,
// and a second launch sums them in a fixed order and takes the cumsum. No
// float atomics: a repeated call gives the same bits.
// Decode: state' = exp(log_a) state + x_p b, then y_p = state' . c (the
// reference's order), the state written to a new tensor. One token moves the
// state twice ([B,H,P,N] float32 in and out, 0.8 MB at hymba-1.5b's 4 lanes)
// and does 5 FLOPs an element: its bound is those bytes, and what it costs is
// a launch. So it is one launch a call that reads x, b, c and log_a in place
// through their element strides (hymba's b and c are views into the fused
// projection's rows, which the port copied before, two more launches a
// layer), and the state's rows coalesced: tpc threads a value column (a power
// of 2, ceil(N / 4) up to 32), each 4 consecutive n as a float4 (N % 4 == 0,
// the state 16-byte aligned; else one n a thread), so a warp reads whole rows
// of 8 columns at N = 16; y summed over a column's lanes by shuffles. b and
// c go through shared memory as float, once a CTA, 1,024 values at a time
// (any N). A CTA is 128 threads over 128 / tpc columns of one (b, h): 200
// CTAs at hymba-1.5b's B = 4, H = 25, P = 64, N = 16.
#include <cooperative_groups.h>

#include "mma.cuh"

namespace cg = cooperative_groups;

namespace {

using bf16 = __nv_bfloat16;
using rt::cp16;
using rt::cp_wait;
using rt::ex2;
using rt::frags_a;
using rt::frags_b;
using rt::mma3;
using rt::put2;
using rt::put_parts;
using rt::split2;
using rt::split_a;
using MN = rt::Mat<bf16, false>;  // element (r, k) at p[r ld + k]
using MT = rt::Mat<bf16, true>;   // element (r, k) at p[k ld + r]

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 2 * 16 * kWarps;  // 16 strips of 16 rows, a pair a warp
constexpr int kN = 16;                      // state columns a CTA: one k-step of C B^T
constexpr int kP = 64;                      // value columns a CTA
constexpr int kLdN = kN + 8;                // bf16 rows padded so ldmatrix meets no bank conflict
constexpr int kLdP = kP + 8;
constexpr int kXch = kP * kN;    // floats of a CTA's slice of a state change, 4 a thread
constexpr int kMaxCluster = 4;   // chunks a cluster takes side by side
constexpr int kDecThreads = 128;   // the decode's CTA
constexpr int kDecChunk = 1024;    // b and c values the decode stages at a time
constexpr int kMaxDevices = 64;
constexpr unsigned kFull = 0xffffffffu;
static_assert(kXch == 4 * kThreads, "a thread's 16 x 8 accumulator share of the state slice");

struct Fwd {
  const void *x, *b, *c;
  const float *log_a, *h0;
  void* y;
  float *hT, *saved;  // saved null: nothing saved
  float* ypart;       // [nt,B,S,H,P]: y by state tile when nt > 1
  int B, S, H, P, N, L, npb, nt, kc, vec;  // kc: a cluster's CTAs; vec: 1 x's rows, 2 b's
                                           // and c's, read 16 bytes at a time
};

struct Bwd {
  const void *x, *b, *c, *dy;
  const float *log_a, *saved, *dhT;
  void *dx, *db, *dc;
  float *dla, *dh0;
  float *db_part, *dc_part, *dla_part;  // [npb,B,S,H,N] twice, [nt,npb,B,S,H] when split
  float* dx_part;                       // [nt,B,S,H,P]: dx by state tile when nt > 1
  int B, S, H, P, N, L, npb, nt, kc, vec;  // kc, vec: as Fwd's (vec 1 also dy's rows)
};

struct Dec {
  const void *x, *b, *c;
  const float *log_a, *h0;
  void* y;
  float* h;
  int64_t sx[3], sb[3], sc[3], sa[2];  // element strides: x [B,H,P], b, c [B,H,N], log_a [B,H]
  int H, P, N, tpc;                    // tpc: threads a value column, a power of 2 up to 32
};

// The shared memory of a chunk kernel (kFwd: the forward's, else the
// backward's) for chunks of up to L rows padded to whole strips: offsets in
// bf16 elements, each array on 16 bytes. Each input array holds its hi part
// and, for float32 inputs, its lo part xlo (nlo for the kN-wide ones)
// elements on; the float32 operands formed in the kernel (w o B, h, dh)
// always hold both. Then float arrays from byte f: the state changes the
// cluster exchanges [2][kXch] (two groups of chunks in turn) and their
// e_end [4]; the forward's la [Lp] and the scan's totals [kWarps]; the
// backward's la, the row and column sums of Q, R [Lp each], the scan's
// totals, R's and h : dh's warp sums [kWarps each].
struct Layout {
  int Lp, xlo, nlo, hlo, x, dy, b, c, wb, h, dh, f, bytes;
};

template <typename T, bool kFwd>
__host__ __device__ constexpr Layout layout(int L) {
  constexpr int parts = sizeof(T) == 2 ? 1 : 2;
  Layout s{};
  s.Lp = (L + 15) / 16 * 16;
  s.xlo = s.Lp * kLdP;
  s.nlo = s.Lp * kLdN;
  s.hlo = kP * kLdN;
  int o = 0;
  s.x = o;
  o += parts * s.xlo;
  s.dy = o;
  o += kFwd ? 0 : parts * s.xlo;
  s.b = o;
  o += parts * s.nlo;
  s.c = o;
  o += parts * s.nlo;
  s.wb = o;
  o += kFwd ? 2 * s.nlo : 0;
  s.h = o;
  o += 2 * s.hlo;
  s.dh = o;
  o += kFwd ? 0 : 2 * s.hlo;
  s.f = 2 * o;
  s.bytes = s.f + 4 * (2 * kXch + 4 + (kFwd ? s.Lp + kWarps : 4 * s.Lp + 3 * kWarps));
  return s;
}

// The CTA's (rank in its cluster, value block, state tile, head, row) from
// a flat grid; the kc CTAs of a cluster are consecutive.
struct Cta {
  int rank, blk, tile, h, b, p0, n0;
};

__device__ __forceinline__ Cta cta_of(int npb, int nt, int H, int kc) {
  const int i = blockIdx.x / kc;
  const int blk = i % npb, tile = (i / npb) % nt;
  return {static_cast<int>(blockIdx.x % kc), blk, tile, (i / (npb * nt)) % H,
          i / (npb * nt * H), blk * kP, tile * kN};
}

// A thread's four places in the CTA's [kP x kN] slice of a state (h or dh):
// warp w holds the 16 x 8 tile at value rows 16 (w / 2), state columns 8 (w
// % 2), as mma.cuh's C: rows r, r + 8, columns c, c + 1.
struct Slice {
  int r, c;
  __device__ Slice() : r(16 * (threadIdx.x >> 6) + ((threadIdx.x & 31) >> 2)),
                       c(8 * ((threadIdx.x >> 5) & 1) + 2 * (threadIdx.x & 3)) {}
  __device__ int row(int e) const { return r + 8 * (e >> 1); }
  __device__ int col(int e) const { return c + (e & 1); }
};

template <typename T>
__device__ __forceinline__ float at(const T* a, long i) {
  return rt::to_f(a[i]);
}


// exp(la_t - la_s) in log2 units, taken only where s <= t (live), else 0
__device__ __forceinline__ float decay(float lt, float ls, bool live) {
  return ex2(live ? lt - ls : -INFINITY);
}

// The sum over a quad's 4 lanes (the 4 lanes of an accumulator row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kFull, v, 1);
  return v + __shfl_xor_sync(kFull, v, 2);
}

// An inclusive scan of v over the CTA's threads in the order of their index
// (kRev: from the last down): a warp's shuffles, then the earlier warps'
// totals added in order. Every thread calls it; tot holds kWarps floats and
// is free again after the next barrier.
template <bool kRev>
__device__ __forceinline__ float block_scan(float v, float* tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float u = kRev ? __shfl_down_sync(kFull, v, o) : __shfl_up_sync(kFull, v, o);
    if (kRev ? lane + o < 32 : lane >= o) v += u;
  }
  if (lane == (kRev ? 0 : 31)) tot[warp] = v;
  __syncthreads();
  float a = 0.f;
  if constexpr (kRev) {
    for (int w = kWarps - 1; w > warp; --w) a += tot[w];
  } else {
    for (int w = 0; w < warp; ++w) a += tot[w];
  }
  return v + a;
}

// Rows [0, rows) of a chunk (zero from row Lk on) and columns [0, W) of a
// slice (zero from column n on) into a bf16 array [rows][ld]: each value's
// hi part and, for float32, its lo part lo elements on. src is the slice's
// first element, rs a row's stride. vec: src and rs on 16 bytes and n a
// multiple of 16 / sizeof(T), so 16 bytes are read at a time: bf16 rows go
// by cp.async, all in flight at once (the caller waits with cp_wait),
// float32 ones through registers, four loads a thread in flight.
template <typename T, int W>
__device__ __forceinline__ void load_rows(bf16* dst, int ld, int lo, const T* src, long rs,
                                          int rows, int Lk, int n, bool vec) {
  constexpr bool kLo = sizeof(T) == 4;
  if (vec) {
    constexpr int V = 16 / sizeof(T), kV = W / V;
    constexpr int kIt = (kMaxChunk * kV + kThreads - 1) / kThreads;
    if constexpr (!kLo) {
#pragma unroll
      for (int i = 0; i < kIt; ++i) {
        const int e = threadIdx.x + i * kThreads, t = e / kV, c = e % kV * V;
        const bool live = t < Lk && c < n;
        if (e < rows * kV) cp16(dst + t * ld + c, live ? src + t * rs + c : src, live);
      }
    } else {
      constexpr int kB = 4;  // loads in flight a thread (float32: each becomes two parts)
#pragma unroll 1
      for (int i0 = 0; i0 < kIt; i0 += kB) {
        uint4 u[kB];
#pragma unroll
        for (int i = 0; i < kB; ++i) {
          const int e = threadIdx.x + (i0 + i) * kThreads, t = e / kV, c = e % kV * V;
          u[i] = make_uint4(0u, 0u, 0u, 0u);
          if (e < rows * kV && t < Lk && c < n)
            u[i] = *reinterpret_cast<const uint4*>(src + t * rs + c);
        }
#pragma unroll
        for (int i = 0; i < kB; ++i) {
          const int e = threadIdx.x + (i0 + i) * kThreads, t = e / kV, c = e % kV * V;
          const float* f = reinterpret_cast<const float*>(&u[i]);
          if (e < rows * kV) {
            put2(dst + t * ld + c, lo, f[0], f[1]);
            put2(dst + t * ld + c + 2, lo, f[2], f[3]);
          }
        }
      }
    }
  } else {  // rows or n not on 16 bytes: element by element
    for (int e = threadIdx.x; e < rows * W; e += kThreads) {
      const int t = e / W, c = e % W;
      put_parts<kLo>(dst + t * ld + c, lo, t < Lk && c < n ? at(src, t * rs + c) : 0.f);
    }
  }
}

// (a, b) into d[0], d[1] where m (the columns left in the row) allows, as
// one pair when the row length is even (both on 2 elements).
template <typename T>
__device__ __forceinline__ void store2(T* d, float a, float b, int m, bool even) {
  if (m >= 2 && even) {
    if constexpr (sizeof(T) == 2)
      *reinterpret_cast<__nv_bfloat162*>(d) = __floats2bfloat162_rn(a, b);
    else
      *reinterpret_cast<float2*>(d) = make_float2(a, b);
  } else {
    if (m >= 1) d[0] = rt::from_f<T>(a);
    if (m >= 2) d[1] = rt::from_f<T>(b);
  }
}

// The strips a warp takes of a chunk's ns: strip w and its pair ns - 1 - w.
template <typename F>
__device__ __forceinline__ void for_strips(int ns, F&& f) {
  const int w = threadIdx.x >> 5;
  if (w <= ns - 1 - w) f(w);
  if (ns - 1 - w > w) f(ns - 1 - w);
}

// acc += A^T B over a chunk's ns k-steps of 16 rows, A^T read from mt (hi,
// and lo alo on when kALo) and B from the kN-wide nb (hi, lo blo on): this
// warp's 16 x 8 share of the [kP x kN] product (Slice). The even and odd
// k-steps go to two chains, added at the end. kScale: A's rows scaled by
// 2^la[t] as they load, the products then split into hi + lo.
template <bool kALo, bool kBLo, bool kScale>
__device__ __forceinline__ void slice_product(float (&acc)[4], MT a, int alo, MT nb, int blo,
                                              int ns, const float* la) {
  const int warp = threadIdx.x >> 5, q = threadIdx.x & 3;
  auto step = [&](float (&c)[4], int kk) {
    uint32_t ah[4], al[4], bh[2], bl[2];
    frags_a<kALo>(ah, al, a, alo, 16 * (warp >> 1), 16 * kk);
    frags_b<kBLo>(bh, bl, nb, blo, 8 * (warp & 1), 16 * kk);
    if constexpr (kScale) {  // ah[0], ah[1] hold rows t, t + 1; ah[2], ah[3] t + 8, t + 9
      const int t = 16 * kk + 2 * q;
      const float e[4] = {ex2(la[t]), ex2(la[t + 1]), ex2(la[t + 8]), ex2(la[t + 9])};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&ah[i]));
        if constexpr (kALo) {
          const float2 u = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&al[i]));
          v.x += u.x;
          v.y += u.y;
        }
        split2(ah[i], al[i], v.x * e[i & 2], v.y * e[(i & 2) + 1]);
      }
      mma3<true, kBLo>(c, ah, al, bh, bl);
    } else {
      mma3<kALo, kBLo>(c, ah, al, bh, bl);
    }
  };
  float odd[4] = {};
#pragma unroll 2
  for (int kk = 0; kk + 1 < ns; kk += 2) {
    step(acc, kk);
    step(odd, kk + 1);
  }
  if (ns & 1) step(acc, ns - 1);
#pragma unroll
  for (int e = 0; e < 4; ++e) acc[e] += odd[e];
}

// The cluster's walk of a group's kn chunks (rank j the group's chunk j):
// v <- e_end_j v + d_j for j = 0 .. kn - 1 (kRev: kn - 1 .. 0), d_j and
// e_end_j read from rank j's xch (buffer buf); mine gets v as it stood
// before this CTA's own chunk (rank). Every CTA runs the same steps in the
// same order, so all end with the same bits.
template <bool kRev>
__device__ __forceinline__ void walk(float (&v)[4], float (&mine)[4], float* xch, int buf,
                                     int kn, int rank) {
  cg::cluster_group cluster = cg::this_cluster();
  float4 d[kMaxCluster];
  float e[kMaxCluster];
#pragma unroll
  for (int j = 0; j < kMaxCluster; ++j) {
    if (j < kn) {
      const float* peer = cluster.map_shared_rank(xch, j);
      d[j] = *reinterpret_cast<const float4*>(peer + buf * kXch + 4 * threadIdx.x);
      e[j] = peer[2 * kXch + buf];
    }
  }
#pragma unroll
  for (int i = 0; i < kMaxCluster; ++i) {
    const int j = kRev ? kMaxCluster - 1 - i : i;
    if (j >= kn) continue;
    if (j == rank) {
#pragma unroll
      for (int a = 0; a < 4; ++a) mine[a] = v[a];
    }
    v[0] = fmaf(e[j], v[0], d[j].x);
    v[1] = fmaf(e[j], v[1], d[j].y);
    v[2] = fmaf(e[j], v[2], d[j].z);
    v[3] = fmaf(e[j], v[3], d[j].w);
  }
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

// kTiles: N past kN, y by state tile into ypart (else written as it is)
template <typename T, bool kTiles>
__global__ void __launch_bounds__(kThreads, 1) ssd_fwd_kernel(Fwd p) {
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int kJ = kP / 8;  // a strip's 8-column tiles of y
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout s = layout<T, true>(p.L);
  bf16* const base = reinterpret_cast<bf16*>(smem);
  bf16 *sX = base + s.x, *sB = base + s.b, *sC = base + s.c, *sWB = base + s.wb, *sH = base + s.h;
  float* sXch = reinterpret_cast<float*>(smem + s.f);  // [2][kXch] dH_k, then [4] e_end
  float* sLa = sXch + 2 * kXch + 4;                    // [Lp] la in log2 units
  float* sTot = sLa + s.Lp;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const Cta cta = cta_of(p.npb, p.nt, p.H, p.kc);
  const T* x = static_cast<const T*>(p.x);
  const T* bm = static_cast<const T*>(p.b);
  const T* cm = static_cast<const T*>(p.c);
  const long PN = static_cast<long>(p.P) * p.N;
  const long hb = (static_cast<long>(cta.b) * p.H + cta.h) * PN;  // this (b, h) in [B,H,P,N]
  const int np = min(kP, p.P - cta.p0), nn = min(kN, p.N - cta.n0);  // live columns
  const Slice sl;
  auto hat = [&](int e) { return static_cast<long>(cta.p0 + sl.row(e)) * p.N + cta.n0 + sl.col(e); };
  auto hlive = [&](int e) { return sl.row(e) < np && sl.col(e) < nn; };
  float hs[4];  // the state at the group's first chunk, the same in every CTA of the cluster
#pragma unroll
  for (int e = 0; e < 4; ++e) hs[e] = hlive(e) ? p.h0[hb + hat(e)] : 0.f;

  const int nc = (p.S + p.L - 1) / p.L, ng = (nc + p.kc - 1) / p.kc;
  for (int gi = 0; gi < ng; ++gi) {
    const int kn = min(p.kc, nc - gi * p.kc), k = gi * p.kc + cta.rank, buf = gi & 1;
    const bool live = cta.rank < kn;  // this CTA has a chunk in the group
    const int t0 = k * p.L, Lk = live ? min(p.L, p.S - t0) : 0, ns = (Lk + 15) >> 4;
    const long row0 = (static_cast<long>(cta.b) * p.S + t0) * p.H + cta.h;  // (b, t0, h)
    if (live) {
      __syncthreads();  // the last chunk's reads of shared memory done
      load_rows<T, kP>(sX, kLdP, s.xlo, x + row0 * p.P + cta.p0, static_cast<long>(p.H) * p.P,
                       16 * ns, Lk, np, p.vec & 1);
      load_rows<T, kN>(sB, kLdN, s.nlo, bm + row0 * p.N + cta.n0, static_cast<long>(p.H) * p.N,
                       16 * ns, Lk, nn, p.vec & 2);
      load_rows<T, kN>(sC, kLdN, s.nlo, cm + row0 * p.N + cta.n0, static_cast<long>(p.H) * p.N,
                       16 * ns, Lk, nn, p.vec & 2);
      const float la = block_scan<false>(tid < Lk ? p.log_a[row0 + tid * p.H] : 0.f, sTot);
      if (tid < s.Lp) sLa[tid] = la * rt::kLog2e;
      cp_wait();
      __syncthreads();
      const float la_end = sLa[Lk - 1];
      // w o B, w_s = exp(la_end - la_s)
      for (int e = tid; e < 16 * ns * kN; e += kThreads) {
        const int t = e / kN, n = e % kN;
        float bv = __bfloat162float(sB[t * kLdN + n]);
        if constexpr (kLo) bv += __bfloat162float(sB[s.nlo + t * kLdN + n]);
        put_parts(sWB + t * kLdN + n, s.nlo, ex2(la_end - sLa[t]) * bv);
      }
      __syncthreads();
      // the chunk's own change of the state, dH_k = X^T (w o B), for the peers
      float dH[4] = {};
      slice_product<kLo, true, false>(dH, MT{sX, kLdP}, s.xlo, MT{sWB, kLdN}, s.nlo, ns, sLa);
      *reinterpret_cast<float4*>(sXch + buf * kXch + 4 * tid) =
          make_float4(dH[0], dH[1], dH[2], dH[3]);
      if (tid == 0) sXch[2 * kXch + buf] = ex2(la_end);
    }
    rt::cluster_arrive();
    rt::cluster_wait();  // every chunk's dH_k and e_end_k of the group out
    float hk[4];         // the state at this CTA's chunk's start
    walk<false>(hs, hk, sXch, buf, kn, cta.rank);
    if (!live) continue;
    if (p.saved != nullptr) {
      float* sv = p.saved + static_cast<long>(k) * p.B * p.H * PN + hb;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (hlive(e)) sv[hat(e)] = hk[e];
    }
    put2(sH + sl.r * kLdN + sl.c, s.hlo, hk[0], hk[1]);
    put2(sH + (sl.r + 8) * kLdN + sl.c, s.hlo, hk[2], hk[3]);
    __syncthreads();

    for_strips(ns, [&](int i) {
      const int r0 = 16 * i, ta = r0 + g, tb = ta + 8;
      const float la_a = sLa[ta], la_b = sLa[tb];
      uint32_t ca[4], cl[4];
      frags_a<kLo>(ca, cl, MN{sC, kLdN}, s.nlo, r0, 0);
      float acc[kJ][4] = {};
      // e_t C_t . h
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        uint32_t bh[2], bl[2];
        frags_b<true>(bh, bl, MN{sH, kLdN}, s.hlo, 8 * j, 0);
        mma3<kLo, true>(acc[j], ca, cl, bh, bl);
      }
      const float ea = ex2(la_a), eb = ex2(la_b);
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        acc[j][0] *= ea;
        acc[j][1] *= ea;
        acc[j][2] *= eb;
        acc[j][3] *= eb;
      }
      // + M X over the tiles on and below the diagonal
#pragma unroll 1
      for (int jt = 0; jt <= i; ++jt) {
        const int c0 = 16 * jt;
        float m[2][4] = {};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t bh[2], bl[2];
          frags_b<kLo>(bh, bl, MN{sB, kLdN}, s.nlo, c0 + 8 * hf, 0);
          mma3<kLo, kLo>(m[hf], ca, cl, bh, bl);
          const int s0 = c0 + 8 * hf + 2 * q;
          const float2 ls = *reinterpret_cast<const float2*>(sLa + s0);
          m[hf][0] *= decay(la_a, ls.x, s0 <= ta);
          m[hf][1] *= decay(la_a, ls.y, s0 + 1 <= ta);
          m[hf][2] *= decay(la_b, ls.x, s0 <= tb);
          m[hf][3] *= decay(la_b, ls.y, s0 + 1 <= tb);
        }
        uint32_t mh[4], ml[4];
        split_a(mh, ml, m[0], m[1]);
#pragma unroll
        for (int j = 0; j < kJ; ++j) {
          uint32_t xh[2], xl[2];
          frags_b<kLo>(xh, xl, MT{sX, kLdP}, s.xlo, 8 * j, c0);
          mma3<true, kLo>(acc[j], mh, ml, xh, xl);
        }
      }
      const long o = row0 * p.P + cta.p0;
      const long rs = static_cast<long>(p.H) * p.P;
#pragma unroll
      for (int j = 0; j < kJ; ++j) {
        const int c = 8 * j + 2 * q;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = r ? tb : ta;
          if (t >= Lk) continue;
          const long at_ = o + t * rs + c;
          if constexpr (kTiles)
            store2(p.ypart + static_cast<long>(cta.tile) * p.B * p.S * p.H * p.P + at_,
                   acc[j][2 * r], acc[j][2 * r + 1], np - c, (p.P & 1) == 0);
          else
            store2(static_cast<T*>(p.y) + at_, acc[j][2 * r], acc[j][2 * r + 1], np - c,
                   (p.P & 1) == 0);
        }
      }
    });
  }
  rt::cluster_arrive();
  rt::cluster_wait();  // the peers done reading this CTA's shared memory
  if (cta.rank == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (hlive(e)) p.hT[hb + hat(e)] = hs[e];
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

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_bwd_kernel(Bwd p) {
  constexpr bool kLo = sizeof(T) == 4;
  constexpr int kJ = kP / 8;   // a strip's 8-column tiles of dx
  constexpr int kK = kP / 16;  // k-steps over the value columns
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout s = layout<T, false>(p.L);
  bf16* const base = reinterpret_cast<bf16*>(smem);
  bf16 *sX = base + s.x, *sDY = base + s.dy, *sB = base + s.b, *sC = base + s.c;
  bf16 *sH = base + s.h, *sDH = base + s.dh;
  float* sXch = reinterpret_cast<float*>(smem + s.f);  // [2][kXch] ddH_k, then [4] e_end
  float* sLa = sXch + 2 * kXch + 4;
  float* sRow = sLa + s.Lp;   // row sums of Q and e_t dy_t . (C_t . h)
  float* sCol = sRow + s.Lp;  // column sums of Q
  float* sR = sCol + s.Lp;    // R_s
  float* sTot = sR + s.Lp;
  float* sRs = sTot + kWarps;  // the warps' sums of R
  float* sHH = sRs + kWarps;   // the warps' shares of h : dh
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, g = lane >> 2, q = lane & 3;
  const Cta cta = cta_of(p.npb, p.nt, p.H, p.kc);
  const bool split = p.npb > 1 || p.nt > 1;
  const T* x = static_cast<const T*>(p.x);
  const T* bm = static_cast<const T*>(p.b);
  const T* cm = static_cast<const T*>(p.c);
  const T* dy = static_cast<const T*>(p.dy);
  const long PN = static_cast<long>(p.P) * p.N;
  const long hb = (static_cast<long>(cta.b) * p.H + cta.h) * PN;
  const long rows = static_cast<long>(p.B) * p.S * p.H;  // one block's partials
  const int np = min(kP, p.P - cta.p0), nn = min(kN, p.N - cta.n0);
  const Slice sl;
  auto hat = [&](int e) { return static_cast<long>(cta.p0 + sl.row(e)) * p.N + cta.n0 + sl.col(e); };
  auto hlive = [&](int e) { return sl.row(e) < np && sl.col(e) < nn; };
  float dh[4];  // dh at the group's last chunk's end, the same in every CTA of the cluster
#pragma unroll
  for (int e = 0; e < 4; ++e) dh[e] = hlive(e) ? p.dhT[hb + hat(e)] : 0.f;
  float rsum = 0.f;  // this warp's sum of R over the chunk

  const int nc = (p.S + p.L - 1) / p.L, ng = (nc + p.kc - 1) / p.kc;
  for (int gi = ng - 1; gi >= 0; --gi) {
    const int kn = min(p.kc, nc - gi * p.kc), k = gi * p.kc + cta.rank, buf = gi & 1;
    const bool live = cta.rank < kn;
    const int t0 = k * p.L, Lk = live ? min(p.L, p.S - t0) : 0, ns = (Lk + 15) >> 4;
    const long row0 = (static_cast<long>(cta.b) * p.S + t0) * p.H + cta.h;
    const float* hkp = p.saved + static_cast<long>(k) * p.B * p.H * PN + hb;
    float hk[4] = {};  // h_k at this thread's places of dh
    auto cval = [&](const bf16* a, int t, int n) {  // an input's value from its parts
      float v = __bfloat162float(a[t * kLdN + n]);
      if constexpr (kLo) v += __bfloat162float(a[s.nlo + t * kLdN + n]);
      return v;
    };
    float la_end = 0.f;
    if (live) {
      __syncthreads();  // the last chunk done with shared memory
      // the chunk's rows first (cp.async in bf16), then what waits on global
      // memory beside them: log_a and h's slice
      load_rows<T, kP>(sX, kLdP, s.xlo, x + row0 * p.P + cta.p0, static_cast<long>(p.H) * p.P,
                       16 * ns, Lk, np, p.vec & 1);
      load_rows<T, kP>(sDY, kLdP, s.xlo, dy + row0 * p.P + cta.p0, static_cast<long>(p.H) * p.P,
                       16 * ns, Lk, np, p.vec & 1);
      load_rows<T, kN>(sB, kLdN, s.nlo, bm + row0 * p.N + cta.n0, static_cast<long>(p.H) * p.N,
                       16 * ns, Lk, nn, p.vec & 2);
      load_rows<T, kN>(sC, kLdN, s.nlo, cm + row0 * p.N + cta.n0, static_cast<long>(p.H) * p.N,
                       16 * ns, Lk, nn, p.vec & 2);
      const float lv = tid < Lk ? p.log_a[row0 + tid * p.H] : 0.f;
      float hv[kXch / kThreads];
#pragma unroll
      for (int i = 0; i < kXch / kThreads; ++i) {
        const int e = tid + i * kThreads, r = e / kN, n = e % kN;
        hv[i] = r < np && n < nn ? hkp[static_cast<long>(cta.p0 + r) * p.N + cta.n0 + n] : 0.f;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (hlive(e)) hk[e] = hkp[hat(e)];
#pragma unroll
      for (int i = 0; i < kXch / kThreads; ++i) {
        const int e = tid + i * kThreads;
        put_parts(sH + e / kN * kLdN + e % kN, s.hlo, hv[i]);
      }
      const float la = block_scan<false>(lv, sTot);
      if (tid < s.Lp) sLa[tid] = la * rt::kLog2e;
      cp_wait();
      __syncthreads();
      la_end = sLa[Lk - 1];
      // the chunk's own change of dh, dy^T (e o C) with e_t = exp(la_t), for
      // the peers: dy's rows scaled by e_t as they load
      float ddh[4] = {};
      slice_product<kLo, kLo, true>(ddh, MT{sDY, kLdP}, s.xlo, MT{sC, kLdN}, s.nlo, ns, sLa);
      *reinterpret_cast<float4*>(sXch + buf * kXch + 4 * tid) =
          make_float4(ddh[0], ddh[1], ddh[2], ddh[3]);
      if (tid == 0) sXch[2 * kXch + buf] = ex2(la_end);
    }
    rt::cluster_arrive();  // the group's changes out; the row pass needs no dh

    // row pass: dc_t and the row sums of Q over the tiles (t, s <= t)
    if (live) for_strips(ns, [&](int i) {
      const int r0 = 16 * i, ta = r0 + g, tb = ta + 8;
      const float la_a = sLa[ta], la_b = sLa[tb];
      uint32_t ya[kK][4], yl[kK][4], ca[4], cl[4];
#pragma unroll
      for (int kk = 0; kk < kK; ++kk)
        frags_a<kLo>(ya[kk], yl[kk], MN{sDY, kLdP}, s.xlo, r0, 16 * kk);
      frags_a<kLo>(ca, cl, MN{sC, kLdN}, s.nlo, r0, 0);
      float dc[2][4] = {};  // u = dy_t . h, then e_t u + sum_s E D B_s
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bh[2], bl[2];
          frags_b<true>(bh, bl, MT{sH, kLdN}, s.hlo, 8 * j, 16 * kk);
          mma3<kLo, true>(dc[j], ya[kk], yl[kk], bh, bl);
        }
      }
      float ia = 0.f, ib = 0.f;  // C_t . u_t, this lane's columns
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int n = 8 * j + 2 * q;
        ia += cval(sC, ta, n) * dc[j][0] + cval(sC, ta, n + 1) * dc[j][1];
        ib += cval(sC, tb, n) * dc[j][2] + cval(sC, tb, n + 1) * dc[j][3];
      }
      const float ea = ex2(la_a), eb = ex2(la_b);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        dc[j][0] *= ea;
        dc[j][1] *= ea;
        dc[j][2] *= eb;
        dc[j][3] *= eb;
      }
      float ra = 0.f, rb = 0.f;
#pragma unroll 1
      for (int jt = 0; jt <= i; ++jt) {
        const int c0 = 16 * jt;
        float gm[2][4] = {}, dd[2][4] = {};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t bh[2], bl[2];
          frags_b<kLo>(bh, bl, MN{sB, kLdN}, s.nlo, c0 + 8 * hf, 0);
          mma3<kLo, kLo>(gm[hf], ca, cl, bh, bl);
#pragma unroll
          for (int kk = 0; kk < kK; ++kk) {
            uint32_t xh[2], xl[2];
            frags_b<kLo>(xh, xl, MN{sX, kLdP}, s.xlo, c0 + 8 * hf, 16 * kk);
            mma3<kLo, kLo>(dd[hf], ya[kk], yl[kk], xh, xl);
          }
          const int s0 = c0 + 8 * hf + 2 * q;
          const float2 ls = *reinterpret_cast<const float2*>(sLa + s0);
          dd[hf][0] *= decay(la_a, ls.x, s0 <= ta);
          dd[hf][1] *= decay(la_a, ls.y, s0 + 1 <= ta);
          dd[hf][2] *= decay(la_b, ls.x, s0 <= tb);
          dd[hf][3] *= decay(la_b, ls.y, s0 + 1 <= tb);
          ra += dd[hf][0] * gm[hf][0] + dd[hf][1] * gm[hf][1];
          rb += dd[hf][2] * gm[hf][2] + dd[hf][3] * gm[hf][3];
        }
        uint32_t eh[4], el[4];
        split_a(eh, el, dd[0], dd[1]);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          uint32_t bh[2], bl[2];
          frags_b<kLo>(bh, bl, MT{sB, kLdN}, s.nlo, 8 * j, c0);
          mma3<true, kLo>(dc[j], eh, el, bh, bl);
        }
      }
      ra = quad_sum(ra);
      rb = quad_sum(rb);
      ia = quad_sum(ia);
      ib = quad_sum(ib);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = 8 * j + 2 * q;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int t = r ? tb : ta;
          if (t >= Lk) continue;
          const long o = (row0 + static_cast<long>(t) * p.H) * p.N + cta.n0 + c;
          if (split)
            store2(p.dc_part + cta.blk * rows * p.N + o, dc[j][2 * r], dc[j][2 * r + 1], nn - c,
                   (p.N & 1) == 0);
          else
            store2(static_cast<T*>(p.dc) + o, dc[j][2 * r], dc[j][2 * r + 1], nn - c,
                   (p.N & 1) == 0);
        }
      }
      if (q == 0) {
        sRow[ta] = fmaf(ea, ia, ra);
        sRow[tb] = fmaf(eb, ib, rb);
      }
    });

    rt::cluster_wait();  // every chunk's change of dh and e_end of the group out
    float dk[4];         // dh at this CTA's chunk's end
    walk<true>(dh, dk, sXch, buf, kn, cta.rank);
    if (!live) continue;
    float hh = 0.f;  // this warp's share of h_k : dh_{k+1}
#pragma unroll
    for (int e = 0; e < 4; ++e) hh = fmaf(hk[e], dk[e], hh);
    put2(sDH + sl.r * kLdN + sl.c, s.hlo, dk[0], dk[1]);
    put2(sDH + (sl.r + 8) * kLdN + sl.c, s.hlo, dk[2], dk[3]);
    hh = rt::warp_sum(hh);
    if (lane == 0) sHH[warp] = hh;
    __syncthreads();

    // column pass: dx_s, db_s, the column sums of Q and R_s over (s, t >= s)
    for_strips(ns, [&](int j) {
      const int r0 = 16 * j, sa = r0 + g, sb = sa + 8;
      const float la_a = sLa[sa], la_b = sLa[sb];
      uint32_t xa[kK][4], xl[kK][4], ba[4], bl[4];
#pragma unroll
      for (int kk = 0; kk < kK; ++kk)
        frags_a<kLo>(xa[kk], xl[kk], MN{sX, kLdP}, s.xlo, r0, 16 * kk);
      frags_a<kLo>(ba, bl, MN{sB, kLdN}, s.nlo, r0, 0);
      float dx[kJ][4] = {}, db[2][4] = {};
      // B_s . dh and x_s . dh
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        uint32_t hh_[2], hl[2];
        frags_b<true>(hh_, hl, MN{sDH, kLdN}, s.hlo, 8 * jj, 0);
        mma3<kLo, true>(dx[jj], ba, bl, hh_, hl);
      }
#pragma unroll
      for (int kk = 0; kk < kK; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t hh_[2], hl[2];
          frags_b<true>(hh_, hl, MT{sDH, kLdN}, s.hlo, 8 * jj, 16 * kk);
          mma3<kLo, true>(db[jj], xa[kk], xl[kk], hh_, hl);
        }
      }
      float Ra = 0.f, Rb = 0.f;  // B_s . (x_s . dh), this lane's columns
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        const int n = 8 * jj + 2 * q;
        Ra += cval(sB, sa, n) * db[jj][0] + cval(sB, sa, n + 1) * db[jj][1];
        Rb += cval(sB, sb, n) * db[jj][2] + cval(sB, sb, n + 1) * db[jj][3];
      }
      const float wa = ex2(la_end - la_a), wb = ex2(la_end - la_b);
#pragma unroll
      for (int jj = 0; jj < kJ; ++jj) {
        dx[jj][0] *= wa;
        dx[jj][1] *= wa;
        dx[jj][2] *= wb;
        dx[jj][3] *= wb;
      }
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        db[jj][0] *= wa;
        db[jj][1] *= wa;
        db[jj][2] *= wb;
        db[jj][3] *= wb;
      }
      float ka = 0.f, kb = 0.f;
#pragma unroll 1
      for (int it = j; it < ns; ++it) {
        const int c0 = 16 * it;
        float gt[2][4] = {}, dt[2][4] = {};
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          uint32_t ch[2], cl[2];
          frags_b<kLo>(ch, cl, MN{sC, kLdN}, s.nlo, c0 + 8 * hf, 0);
          mma3<kLo, kLo>(gt[hf], ba, bl, ch, cl);
#pragma unroll
          for (int kk = 0; kk < kK; ++kk) {
            uint32_t yh[2], yl[2];
            frags_b<kLo>(yh, yl, MN{sDY, kLdP}, s.xlo, c0 + 8 * hf, 16 * kk);
            mma3<kLo, kLo>(dt[hf], xa[kk], xl[kk], yh, yl);
          }
          const int u0 = c0 + 8 * hf + 2 * q;  // this lane's t
          const float2 lt = *reinterpret_cast<const float2*>(sLa + u0);
          const float e[4] = {decay(lt.x, la_a, u0 >= sa), decay(lt.y, la_a, u0 + 1 >= sa),
                              decay(lt.x, la_b, u0 >= sb), decay(lt.y, la_b, u0 + 1 >= sb)};
#pragma unroll
          for (int v = 0; v < 4; ++v) {
            gt[hf][v] *= e[v];
            const float qv = gt[hf][v] * dt[hf][v];
            if (v < 2) ka += qv; else kb += qv;
            dt[hf][v] *= e[v];
          }
        }
        uint32_t gh[4], gl[4], eh[4], el[4];
        split_a(gh, gl, gt[0], gt[1]);
        split_a(eh, el, dt[0], dt[1]);
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          uint32_t yh[2], yl[2];
          frags_b<kLo>(yh, yl, MT{sDY, kLdP}, s.xlo, 8 * jj, c0);
          mma3<true, kLo>(dx[jj], gh, gl, yh, yl);
        }
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          uint32_t ch[2], cl[2];
          frags_b<kLo>(ch, cl, MT{sC, kLdN}, s.nlo, 8 * jj, c0);
          mma3<true, kLo>(db[jj], eh, el, ch, cl);
        }
      }
      ka = quad_sum(ka);
      kb = quad_sum(kb);
      Ra = quad_sum(Ra) * wa;
      Rb = quad_sum(Rb) * wb;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int t = r ? sb : sa;
        if (t >= Lk) continue;
        const long ox = (row0 + static_cast<long>(t) * p.H) * p.P + cta.p0;
#pragma unroll
        for (int jj = 0; jj < kJ; ++jj) {
          const int c = 8 * jj + 2 * q;
          if (p.nt == 1)
            store2(static_cast<T*>(p.dx) + ox + c, dx[jj][2 * r], dx[jj][2 * r + 1], np - c,
                   (p.P & 1) == 0);
          else
            store2(p.dx_part + cta.tile * rows * p.P + ox + c, dx[jj][2 * r], dx[jj][2 * r + 1],
                   np - c, (p.P & 1) == 0);
        }
        const long on = (row0 + static_cast<long>(t) * p.H) * p.N + cta.n0;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int c = 8 * jj + 2 * q;
          if (split)
            store2(p.db_part + cta.blk * rows * p.N + on + c, db[jj][2 * r], db[jj][2 * r + 1],
                   nn - c, (p.N & 1) == 0);
          else
            store2(static_cast<T*>(p.db) + on + c, db[jj][2 * r], db[jj][2 * r + 1], nn - c,
                   (p.N & 1) == 0);
        }
      }
      if (q == 0) {
        sCol[sa] = ka;
        sCol[sb] = kb;
        sR[sa] = Ra;
        sR[sb] = Rb;
        rsum += Ra + Rb;
      }
    });
    rsum = rt::warp_sum(rsum);
    if (lane == 0) sRs[warp] = rsum;
    rsum = 0.f;
    __syncthreads();  // the passes done: sRow, sCol, sR, sRs, sHH final

    // d la, with the chunk's end e_end h : dh + sum_s R_s at its last row,
    // and d log_a its reverse cumsum
    float d = 0.f;
    if (tid < Lk) {
      d = sRow[tid] - sCol[tid] - sR[tid];
      if (tid == Lk - 1) {
        float a = 0.f, r = 0.f;
        for (int w = 0; w < kWarps; ++w) {
          a += sHH[w];
          r += sRs[w];
        }
        d += fmaf(ex2(la_end), a, r);
      }
    }
    const long od = row0 + static_cast<long>(tid) * p.H;
    if (split) {
      if (tid < Lk) p.dla_part[(static_cast<long>(cta.tile) * p.npb + cta.blk) * rows + od] = d;
    } else {
      d = block_scan<true>(d, sTot);
      if (tid < Lk) p.dla[od] = d;
    }
  }
  rt::cluster_arrive();
  rt::cluster_wait();  // the peers done reading this CTA's shared memory
  if (cta.rank == 0) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (hlive(e)) p.dh0[hb + hat(e)] = dh[e];
  }
}

// The second launch, when the CTAs split P or N (split): a CTA per (chunk,
// head, row) sums db and dc over the value blocks, dx over the state tiles
// (nt > 1) and d la over both, in order, casts, and writes d log_a, the
// reverse cumsum of d la within the chunk.
template <typename T>
__global__ void __launch_bounds__(kThreads) ssd_bwd_reduce_kernel(Bwd p) {
  __shared__ float tot[kWarps];
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
  const int t = threadIdx.x;
  const long i = first + static_cast<long>(t) * p.H;
  float s = 0.f;
  if (t < Lk)
    for (int j = 0; j < p.npb * p.nt; ++j) s += p.dla_part[j * rows + i];
  s = block_scan<true>(s, tot);
  if (t < Lk) p.dla[i] = s;
}

// ---------------------------------------------------------------------------
// decode
// ---------------------------------------------------------------------------

// V: state elements a thread reads at a time (4: a float4; 1)
template <typename TX, typename TB, int V>
__global__ void __launch_bounds__(kDecThreads) ssd_decode_kernel(Dec p) {
  __shared__ __align__(16) float sb[kDecChunk], sc[kDecChunk];
  const int bh = blockIdx.x, bi = bh / p.H, hi = bh % p.H;
  const int g = threadIdx.x % p.tpc;  // the thread's lane in its column's group
  const int j = blockIdx.y * (kDecThreads / p.tpc) + threadIdx.x / p.tpc;
  const bool live = j < p.P;
  const TB* bm = static_cast<const TB*>(p.b) + bi * p.sb[0] + hi * p.sb[1];
  const TB* cm = static_cast<const TB*>(p.c) + bi * p.sc[0] + hi * p.sc[1];
  const float a = expf(p.log_a[bi * p.sa[0] + hi * p.sa[1]]);
  const float xv =
      live ? at(static_cast<const TX*>(p.x), bi * p.sx[0] + hi * p.sx[1] + j * p.sx[2]) : 0.f;
  const long row = (static_cast<long>(bh) * p.P + j) * p.N;
  float y = 0.f;
  for (int n0 = 0; n0 < p.N; n0 += kDecChunk) {
    const int m = min(kDecChunk, p.N - n0);
    if (n0 > 0) __syncthreads();  // every thread is done with the last chunk
    for (int i = threadIdx.x; i < m; i += kDecThreads) {
      sb[i] = at(bm, (n0 + i) * p.sb[2]);
      sc[i] = at(cm, (n0 + i) * p.sc[2]);
    }
    __syncthreads();
    if (!live) continue;
    for (int i = g * V; i < m; i += p.tpc * V) {
      if constexpr (V == 4) {
        const float4 h0 = *reinterpret_cast<const float4*>(p.h0 + row + n0 + i);
        const float4 bv = *reinterpret_cast<const float4*>(sb + i);
        const float4 cv = *reinterpret_cast<const float4*>(sc + i);
        float4 s;
        s.x = fmaf(a, h0.x, xv * bv.x);
        s.y = fmaf(a, h0.y, xv * bv.y);
        s.z = fmaf(a, h0.z, xv * bv.z);
        s.w = fmaf(a, h0.w, xv * bv.w);
        *reinterpret_cast<float4*>(p.h + row + n0 + i) = s;
        y = fmaf(s.x, cv.x, y);
        y = fmaf(s.y, cv.y, y);
        y = fmaf(s.z, cv.z, y);
        y = fmaf(s.w, cv.w, y);
      } else {
        const float s = fmaf(a, p.h0[row + n0 + i], xv * sb[i]);
        p.h[row + n0 + i] = s;
        y = fmaf(s, sc[i], y);
      }
    }
  }
  for (int o = p.tpc / 2; o > 0; o /= 2) y += __shfl_xor_sync(kFull, y, o);
  if (live && g == 0) static_cast<TX*>(p.y)[static_cast<long>(bh) * p.P + j] = rt::from_f<TX>(y);
}

static_assert(layout<float, false>(kMaxChunk).bytes <= 232448, "backward past 227 KB");
static_assert(layout<float, true>(kMaxChunk).bytes <= 232448, "forward past 227 KB");

// A kernel's dynamic shared memory limit raised to `bytes`, once a device
// (racing threads set the same value).
int allow_smem(const void* kernel, int bytes, bool (&raised)[kMaxDevices]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && !(dev < kMaxDevices && raised[dev])) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  }
  return static_cast<int>(err);
}

// kernel<<<grid * p.kc, kThreads, smem, st>>>(p) in clusters of p.kc CTAs
template <typename P>
int launch_clusters(void (*kernel)(P), const P& p, int grid, int smem, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid * p.kc);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.kc;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, p));
}

template <typename T, bool kTiles>
int launch_fwd_tiles(const Fwd& p, cudaStream_t st) {
  static bool raised[kMaxDevices] = {};
  const int err = allow_smem(reinterpret_cast<const void*>(ssd_fwd_kernel<T, kTiles>),
                             layout<T, true>(kMaxChunk).bytes, raised);
  if (err != 0) return err;
  return launch_clusters(ssd_fwd_kernel<T, kTiles>, p, p.B * p.H * p.npb * p.nt,
                         layout<T, true>(p.L).bytes, st);
}

template <typename T>
int launch_fwd(const Fwd& p, cudaStream_t st) {
  const int err = p.nt == 1 ? launch_fwd_tiles<T, false>(p, st) : launch_fwd_tiles<T, true>(p, st);
  if (err != 0) return err;
  if (p.nt > 1) {
    const long total = static_cast<long>(p.B) * p.S * p.H * p.P;
    const long grid = (total + kThreads - 1) / kThreads;
    ssd_fwd_reduce_kernel<T><<<static_cast<int>(grid < 65536 ? grid : 65536), kThreads, 0,
                               st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const Bwd& p, cudaStream_t st) {
  static bool raised[kMaxDevices] = {};
  int err = allow_smem(reinterpret_cast<const void*>(ssd_bwd_kernel<T>),
                       layout<T, false>(kMaxChunk).bytes, raised);
  if (err != 0) return err;
  err = launch_clusters(ssd_bwd_kernel<T>, p, p.B * p.H * p.npb * p.nt,
                        layout<T, false>(p.L).bytes, st);
  if (err != 0) return err;
  if (p.npb > 1 || p.nt > 1) {
    const int nc = (p.S + p.L - 1) / p.L;
    ssd_bwd_reduce_kernel<T><<<p.B * p.H * nc, kThreads, 0, st>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// The CTAs a cluster takes: one a chunk, up to kMaxCluster chunks.
int cluster_of(int S, int L) {
  const int nc = (S + L - 1) / L;
  return nc < kMaxCluster ? nc : kMaxCluster;
}

bool shape_ok(int B, int S, int H, int P, int N, int L) {
  const long ctas = static_cast<long>(B) * H * ((N + kN - 1) / kN) * ((P + kP - 1) / kP);
  return B >= 1 && S >= 1 && H >= 1 && P >= 1 && N >= 1 && L >= 1 && L <= kMaxChunk &&
         ctas * kMaxCluster <= 0x7fffffffL &&
         static_cast<long>(B) * H * ((S + L - 1) / L) <= 0x7fffffffL;
}

bool on16(const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 == 0; }

// The vec flags: 1 when x's rows (and dy's) can be read 16 bytes at a
// time, 2 when b's and c's can.
int vec_of(const void* x, const void* dy, const void* b, const void* c, int P, int N,
           int dtype) {
  const int v = dtype == rt::kBF16 ? 8 : 4;
  return (P % v == 0 && on16(x) && on16(dy) ? 1 : 0) |
         (N % v == 0 && on16(b) && on16(c) ? 2 : 0);
}

}  // namespace

extern "C" int rt_ssd_max_chunk() { return kMaxChunk; }
extern "C" int rt_ssd_block_n() { return kN; }
extern "C" int rt_ssd_block_p() { return kP; }

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
        P, N, L, (P + kP - 1) / kP, nt, cluster_of(S, L), vec_of(x, x, b, c, P, N, dtype)};
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == rt::kBF16 ? launch_fwd<__nv_bfloat16>(p, st) : launch_fwd<float>(p, st);
}

// The backward: dx, db, dc (the inputs' dtype), dla, dh0 (f32) from the
// forward's inputs, its saved states and the gradients dy, dhT; one launch
// when P <= rt_ssd_block_p() and N <= rt_ssd_block_n(), else split over
// npb = ceil(P / rt_ssd_block_p()) value blocks and nt = ceil(N /
// rt_ssd_block_n()) state tiles, with a second launch that sums the
// wrapper's float32 scratch: db_part, dc_part [npb,B,S,H,N], dla_part
// [nt,npb,B,S,H] (null when not split) and dx_part [nt,B,S,H,P] (null unless
// nt > 1).
extern "C" int rt_ssd_bwd(const void* x, const void* b, const void* c, const void* log_a,
                          const void* saved, const void* dy, const void* dhT, void* dx,
                          void* db, void* dc, void* dla, void* dh0, void* db_part,
                          void* dc_part, void* dla_part, void* dx_part, int B, int S, int H,
                          int P, int N, int L, int dtype, void* stream) {
  const int nt = (N + kN - 1) / kN, npb = (P + kP - 1) / kP;
  const bool split = npb > 1 || nt > 1;
  if (!shape_ok(B, S, H, P, N, L) || (nt > 1) != (dx_part != nullptr) ||
      split != (db_part != nullptr) || split != (dc_part != nullptr) ||
      split != (dla_part != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto f = [](const void* a) { return static_cast<const float*>(a); };
  auto w = [](void* a) { return static_cast<float*>(a); };
  Bwd p{x, b, c, dy, f(log_a), f(saved), f(dhT), dx, db, dc, w(dla), w(dh0), w(db_part),
        w(dc_part), w(dla_part), w(dx_part), B, S, H, P, N, L, npb, nt, cluster_of(S, L),
        vec_of(x, dy, b, c, P, N, dtype)};
  auto st = static_cast<cudaStream_t>(stream);
  return dtype == rt::kBF16 ? launch_bwd<__nv_bfloat16>(p, st) : launch_bwd<float>(p, st);
}

// One token: h = exp(log_a) h0 + x (x) b, y = h . c, over x [B,H,P]
// (x_dtype), b, c [B,H,N] (bc_dtype) and log_a [B,H] f32, each read through
// its element strides (11 int64: x's 3, b's 3, c's 3, log_a's 2), and h0
// [B,H,P,N] f32 contiguous; y [B,H,P] (x_dtype) and h [B,H,P,N] f32 are
// written contiguous.
extern "C" int rt_ssd_decode(const void* x, const void* b, const void* c, const void* log_a,
                             const void* h0, void* y, void* h, const void* strides, int B, int H,
                             int P, int N, int x_dtype, int bc_dtype, void* stream) {
  if (B < 1 || H < 1 || P < 1 || N < 1 || static_cast<long>(B) * H > 0x7fffffffL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* s = static_cast<const int64_t*>(strides);
  const int vec = N % 4 == 0 && on16(h0) && on16(h) ? 4 : 1;
  int tpc = 1;
  while (tpc < 32 && tpc * vec < N) tpc *= 2;
  const long cols = kDecThreads / tpc, blocks = (P + cols - 1) / cols;
  if (blocks > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Dec p{x, b, c, static_cast<const float*>(log_a), static_cast<const float*>(h0), y,
        static_cast<float*>(h), {s[0], s[1], s[2]}, {s[3], s[4], s[5]}, {s[6], s[7], s[8]},
        {s[9], s[10]}, H, P, N, tpc};
  auto st = static_cast<cudaStream_t>(stream);
  const dim3 grid(B * H, static_cast<unsigned>(blocks));
  const bool xb = x_dtype == rt::kBF16, bb = bc_dtype == rt::kBF16;
  void (*kernel)(Dec);
  if (vec == 4)
    kernel = xb ? (bb ? ssd_decode_kernel<bf16, bf16, 4> : ssd_decode_kernel<bf16, float, 4>)
                : (bb ? ssd_decode_kernel<float, bf16, 4> : ssd_decode_kernel<float, float, 4>);
  else
    kernel = xb ? (bb ? ssd_decode_kernel<bf16, bf16, 1> : ssd_decode_kernel<bf16, float, 1>)
                : (bb ? ssd_decode_kernel<float, bf16, 1> : ssd_decode_kernel<float, float, 1>);
  kernel<<<grid, kDecThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}
