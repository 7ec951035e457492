// chunked_cache_attention's KV-block scan (forward) for Hopper: the
// attention of a prefill's queries over the KV ring, with the positions the
// ring holds.
//
// Replaces: src/repro/models/layers.py :: chunked_cache_attention, the
// lax.scan over KV blocks at :203 (not a Pallas kernel: XLA runs the scan as
// one loop on the device, and the port ran it as a Python loop of ~15 ops a
// block). q [B,S,H,hd] (the model's RoPE'd queries), k, v [B,T,KV,hd] (the
// ring, read in place), q_pos [B,S] and k_pos [B,T] int32 (-1 an empty slot)
// -> out [B,S,H,hd] in q's dtype. A slot is visible to a query where k_pos
// >= 0, q_pos >= k_pos and, with a window w > 0, q_pos - k_pos < w. Scores
// q.k / sqrt(hd) in f32, c tanh(s / c) before the mask where softcap c > 0;
// an online softmax from m = -1e30, a masked probability 0, out = acc /
// max(l, 1e-30), so a row that sees no slot is 0. r-major GQA: query head h
// reads KV head h % KV. The whole ring is one launch: slots t >= T are
// masked here, so the reference's block_k (which only orders its sums) has
// no counterpart and nothing is padded.
//
// What bounds it: at llava-next's prefill (B 2, S 2,944, T 2,976, H/KV
// 32/8, hd 128, bf16) the products, 4 hd FLOPs a visible (query, slot) pair
// and head: 1.4e11 FLOPs, 0.14 ms on the tensor cores, against 121 MB of
// inputs and output (0.036 ms). The plain loop wrote ~6 [B,S,H,block_k] f32
// tensors a block (0.77 GB each at that shape); here no S x T intermediate
// leaves the SM. Next to the products: each K/V tile staged in shared
// memory is read from L2 once for every query tile that sees it (1.1 GB at
// that shape for 128-row query tiles, twice that for 64), and the softmax's
// exponentials on the CUDA cores take about half the products' time, so
// they must run under them.
//
// Which tiles: a slot's position is in k_pos, not in its index (hymba's
// ring wraps), so a K/V tile cannot be skipped by its index as flash does.
// A CTA plans each block of query rows first: the position range of its
// rows below S (per group of 64 rows), then a walk of k_pos, a warp a tile:
// a tile is needed where some slot is visible to some position in the
// block's [qmin, qmax] (p >= 0, p <= qmax, qmin - p < w), and needs no
// per-element mask for a group's rows where every slot is visible to every
// one of their positions (inside T, p >= 0, p <= the group's qmin, its qmax
// - p < w). The needed tiles go to a list in shared memory, in slot order,
// each with a flag a group. Where positions follow the slots (a prefill into
// an empty ring, llava's) the list is the causal half of the ring.
//
// bfloat16 with hd % 16 == 0 and 16-byte aligned rows (cache_bf16_kernel),
// warp-specialised and persistent (its times against the earlier kernel of
// one warpgroup a 64-row CTA: PERF.md). One CTA an SM (its shared memory
// allows one) walks work items, a block of 128 query rows of
// one (head, row) each, the latest blocks first, in a snake over the grid so
// that long and short items even out. Each K/V tile staged in shared memory
// serves 128 rows. Three roles, a warpgroup each, no CTA-wide barrier after
// the start:
//   - the producer warpgroup (its registers lowered with setmaxnreg, given
//     to the consumers): three warps plan the next item while the current
//     one runs, into one of two plan buffers; one warp loads, by TMA, each
//     item's Q (once the consumers' last Q K^T of the item before is done),
//     then each listed tile's K with its 128 slots' positions (so a masked
//     tile reads positions from shared memory) and its V, into rings of 2
//     stages at hd 128 and 4 at 64 (64 or 32 KB a stage; 227 KB a CTA).
//     K and V have full and empty mbarriers each: K is free once the tile's
//     scores are read, V once its P V is done, so the next tile's copy
//     starts a tile earlier than with one barrier for both.
//   - two consumer warpgroups, each 64 of an item's rows: S = Q K^T as wgmma
//     m64n128k16 (both K-major in 128-byte swizzled shared memory), O += P V
//     as wgmma m64n{64,128}k16 with P in registers and V MN-major. Tile j's
//     Q K^T and tile j-1's P V are issued together; after wgmma.wait_group 1
//     (Q K^T done) tile j's softmax runs while P V still does.
//   - between the two consumers, named barriers order the issues (ping-
//     pong): one issues its pair of products after the other has issued
//     its own, so one's softmax runs under the other's products.
// Every branch of a consumer is uniform to the compiler (mbarrier waits in
// the asm with bra.uni, predicated arrivals, values broadcast from lane 0),
// S is declared fresh a tile and the first tile of an item is peeled: with a
// divergent path or a loop-carried accumulator ptxas serialises every wgmma
// (C7520, C7515), and each issue waits for the products. Tiles of 128 slots:
// Q K^T as m64n128 reads 6 KB of shared memory per 64 columns of work (8 KB
// as two n64), and each tile's barrier and issue cost is spread over twice
// the work; the consumers' registers (S 64, P 32, O 64 a thread) fit in
// 232. The softmax: scores stay q.k without a softcap, the scale folded into
// the exponent's FMA; row maxima and sums by trees; one MUFU.EX2 an element.
//
// Every other case (float32, hd not a multiple of 16 or past 128, unaligned
// rows) runs on the CUDA cores (cache_scalar_kernel<T, DPER>, hd up to 16
// DPER: 128 or 256): flash's f32 kernel over the list of 64-slot tiles of
// 64-row CTAs, the mask from the positions, bf16 read into f32 and P rounded
// to bf16 before P V as the plain version rounds it. float32 stays off the
// tensor cores: TF32 would miss the f32 tolerance (2e-5).
#include <cuda.h>

#include <climits>
#include <cmath>
#include <initializer_list>

#include "common.cuh"
#include "hopper.cuh"

namespace {

using hp::mbar_arrive_if;
using hp::mbar_expect;
using hp::mbar_init;
using hp::mbar_wait;

constexpr int kMaxHd = 256;       // the CUDA-core kernel's; the wgmma kernel takes up to 128
constexpr int kMaxTileHd = 128;
constexpr int kRows = 64;        // query rows of a group (a CTA of the scalar kernel, a
                                 // consumer warpgroup); slots a tile of the scalar kernel
constexpr int kFull = 1 << 30;   // list entry flag: every slot visible to every row (of group
                                 // g: kFull >> g)
constexpr int kMaxSmem = 232448;  // dynamic shared memory a block may have

struct Strides {
  int64_t b, s, h;  // batch, sequence and head strides in elements (hd contiguous)
};

__device__ __forceinline__ bool visible(int qp, int kp, int window) {
  return kp >= 0 && qp >= kp && (window <= 0 || qp - kp < window);
}

// A K/V tile's list entry flags, a warp together, from its slots' positions
// (this lane's kPer of them, -1 past T) and the position range [lo[g],
// hi[g]] of each group of query rows (lo > hi: the group has no row below
// S): bit 0 where some slot is visible to some position in the CTA's range,
// kFull >> g where every slot is visible to every position of group g (a
// group without rows counts as such). The same on every lane.
template <int G, int kPer>
__device__ __forceinline__ int tile_flags(const int (&p)[kPer], const int (&lo)[G],
                                          const int (&hi)[G], int window) {
  int qmin = INT_MAX, qmax = INT_MIN;
#pragma unroll
  for (int g = 0; g < G; ++g) {
    qmin = min(qmin, lo[g]);
    qmax = max(qmax, hi[g]);
  }
  bool any = false, all[G];
#pragma unroll
  for (int g = 0; g < G; ++g) all[g] = true;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    any = any || (p[j] >= 0 && p[j] <= qmax && (window <= 0 || qmin - p[j] < window));
#pragma unroll
    for (int g = 0; g < G; ++g)
      all[g] = all[g] && (lo[g] > hi[g] ||
                          (p[j] >= 0 && p[j] <= lo[g] && (window <= 0 || hi[g] - p[j] < window)));
  }
  int f = __any_sync(0xffffffffu, any) ? 1 : 0;
#pragma unroll
  for (int g = 0; g < G; ++g)
    if (__all_sync(0xffffffffu, all[g])) f |= kFull >> g;
  return f;
}

// The range of the positions of rows r0 .. r1 - 1 (below S), a warp
// together: lo > hi where there is none.
__device__ __forceinline__ void row_range(const int* __restrict__ qp, int r0, int r1, int& lo,
                                          int& hi) {
  int a = INT_MAX, z = INT_MIN;
  for (int r = r0 + threadIdx.x % 32; r < r1; r += 32) {
    a = min(a, qp[r]);
    z = max(z, qp[r]);
  }
  lo = __reduce_min_sync(0xffffffffu, a);
  hi = __reduce_max_sync(0xffffffffu, z);
}

// The plan of G groups of kRows rows from q0, made by nwarp warps (this
// one is `warp` of them, nwarp >= G) that sync() together: the K/V tiles of
// TILE slots the rows can see, in slot order, as list[0, n) (tile | kFull >>
// g where no slot of the tile needs a mask for group g's rows), a warp a
// tile; returns n. Each warp's first two tiles' positions load before the
// rows' ranges are known, so the two loads overlap. red: 2 G + 1 ints;
// list: one int a tile of the ring, written in place over the per-tile
// flags (warp 0 reads a group of 32 flags before it writes any entry, and
// entries land at or below them).
template <int G, int TILE, typename Sync>
__device__ int plan_tiles(const int* __restrict__ qp, const int* __restrict__ kp, int q0,
                          int S, int Tn, int window, int* red, int* list, int warp, int nwarp,
                          Sync sync) {
  constexpr int kPer = TILE / 32, kPre = 2;  // slots a lane a tile; tiles loaded early
  const int lane = threadIdx.x % 32;
  const int nk = (Tn + TILE - 1) / TILE;
  auto load = [&](int i, int (&p)[kPer]) {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int t = i * TILE + 32 * j + lane;
      p[j] = t < Tn ? kp[t] : -1;
    }
  };
  int pre[kPre][kPer];
#pragma unroll
  for (int u = 0; u < kPre; ++u) load(warp + u * nwarp, pre[u]);
  if (warp < G) {  // warp g: the range of group g's positions
    int lo, hi;
    row_range(qp, q0 + warp * kRows, min(S, q0 + (warp + 1) * kRows), lo, hi);
    if (lane == 0) {
      red[2 * warp] = lo;
      red[2 * warp + 1] = hi;
    }
  }
  sync();
  int lo[G], hi[G];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    lo[g] = red[2 * g];
    hi[g] = red[2 * g + 1];
  }
#pragma unroll
  for (int u = 0; u < kPre; ++u) {
    const int i = warp + u * nwarp;
    if (i < nk) {
      const int f = tile_flags<G, kPer>(pre[u], lo, hi, window);
      if (lane == 0) list[i] = f;
    }
  }
  for (int i = warp + kPre * nwarp; i < nk; i += nwarp) {
    int p[kPer];
    load(i, p);
    const int f = tile_flags<G, kPer>(p, lo, hi, window);
    if (lane == 0) list[i] = f;
  }
  sync();
  if (warp == 0) {
    int n = 0;
    for (int i0 = 0; i0 < nk; i0 += 32) {
      const int i = i0 + lane;
      const int f = i < nk ? list[i] : 0;
      const unsigned take = __ballot_sync(0xffffffffu, f & 1);
      if (f & 1) list[n + __popc(take & ((1u << lane) - 1u))] = i | (f & ~1);
      n += __popc(take);
    }
    if (lane == 0) red[2 * G] = n;
  }
  sync();
  return red[2 * G];
}

// ---------------------------------------------------------------------------
// bfloat16: a producer warp and two consumer warpgroups on wgmma tiles
// ---------------------------------------------------------------------------

constexpr int kSlots = 128;                  // slots a K/V tile
constexpr int kConsumers = 2;                // consumer warpgroups, kRows query rows each
constexpr int kCtaRows = kConsumers * kRows;
constexpr int kProducerWarp = 4 * kConsumers;  // the first warp of the last warpgroup
constexpr int kWsThreads = 128 * (kConsumers + 1);
constexpr int kTurn = 1;  // named barriers kTurn + w: consumer warpgroup w's turn to issue
constexpr int kTileMask = (kFull >> 2) - 1;  // a list entry's tile
// Registers a thread: ptxas gives each of the 3 warpgroups 168 at launch;
// the producer's gives back 128 a thread, which the consumers take.
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
static_assert(128 * (168 - kProducerRegs) == 128 * kConsumers * (kConsumerRegs - 168),
              "the producer frees what the consumers take");
// A 64-column block of a tile: its rows of 128 bytes, 16-byte chunk c of row
// r at r * 128 + ((c ^ r % 8) << 4) (the 128-byte swizzle the TMA applies).
constexpr uint32_t kQBlock = kRows * 128;
constexpr uint32_t kKvBlock = kSlots * 128;

// K/V stages: as many as 227 KB holds beside Q at 128 and at 64 columns
template <int HDP> constexpr int stages() { return HDP == 128 ? 2 : 4; }

// The shared memory of cache_bf16_kernel<HDP> for nk tiles in the ring:
// offsets in bytes from a 1,024-aligned base.
template <int HDP>
struct Layout {
  static constexpr int kSt = stages<HDP>();
  static constexpr uint32_t kQHalf = kQBlock * (HDP / 64);  // a warpgroup's Q
  static constexpr uint32_t kKv = kKvBlock * (HDP / 64);    // a K or V tile
  static constexpr uint32_t kK = kConsumers * kQHalf;       // stage st's K at kK + 2 st kKv
  // mbarriers: K full[kSt], V full[kSt], K empty[kSt], V empty[kSt], Q's
  static constexpr uint32_t kBars = kK + 2 * kSt * kKv;
  // and the plans' full[2], empty[2], Q's empty
  static constexpr uint32_t kPos = kBars + 8 * (4 * kSt + 6);  // [kSt][kSlots] ints
  // two plans, each 8 ints and its list
  static constexpr uint32_t kPlan = kPos + 4 * kSt * kSlots;
  static constexpr int bytes(int nk) { return 1024 + kPlan + 2 * 4 * (8 + nk); }
};
static_assert(Layout<128>::bytes(4096) <= kMaxSmem && Layout<64>::bytes(4096) <= kMaxSmem,
              "a ring of 4,096 tiles");
constexpr int kPlanners = 3;       // the producer warpgroup's warps that plan
constexpr int kPlanBarrier = 3;    // their named barrier

// S = Q K^T over hd in steps of 16 (Q's 64 rows at q, K's 128 at k): within
// a 64-column block a step is 32 bytes on from the block's start (the
// hardware applies the swizzle); one committed group.
template <int HDP>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t q, uint32_t k) {
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < HDP / 16; ++kk)
    wg::wgmma_ss_m64n128(s, wg::desc_sw128(q + (kk / 4) * kQBlock + (kk % 4) * 32, 0, 1024),
                         wg::desc_sw128(k + (kk / 4) * kKvBlock + (kk % 4) * 32, 0, 1024),
                         kk > 0);
  wg::commit();
}

// O += P V over a tile's 128 slots (V at v) in steps of 16 (16 rows of 128
// bytes); V is MN-major: LBO steps between its 64-column blocks, SBO
// between groups of 8 slots. One committed group.
template <int HDP>
__device__ __forceinline__ void issue_pv(float (&acc)[HDP / 2], uint32_t (&pa)[8][4],
                                         uint32_t v) {
  wg::fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    hp::wgmma_pv<HDP>(acc, pa[kk], wg::desc_sw128(v + kk * 16 * 128, kKvBlock, 1024));
  wg::commit();
}

// A consumer thread's two rows: their positions (-1: sees nothing) and the
// score's terms.
struct Rows {
  int qp0, qp1, window;
  float scale_log2, softcap;
};

// The maxima of rows r0 (x[4c], x[4c + 1]) and r1 (x[4c + 2], x[4c + 3])
// of a thread's 64 values, by halving: a tree of depth 6, not a chain of 32.
__device__ __forceinline__ void row_max(const float (&x)[64], float& mx0, float& mx1) {
  float a[16], b[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    a[c] = fmaxf(x[4 * c], x[4 * c + 1]);
    b[c] = fmaxf(x[4 * c + 2], x[4 * c + 3]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)  // halves of 8, 4, 2, 1 (fixed trip counts: all in registers)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < 8 >> k) {
        a[c] = fmaxf(a[c], a[c + (8 >> k)]);
        b[c] = fmaxf(b[c], b[c + (8 >> k)]);
      }
  mx0 = a[0];
  mx1 = b[0];
}

// A tile's scores, in place; s[4c + e]: row e < 2 ? r0 : r1, slot 8c + c0 +
// e % 2 of the tile, whose positions kpos[8c], kpos[8c + 1] mask it element
// by element where kMasked (-1e30). With a softcap (kCap) they are turned
// into log2 units here; without, they stay q.k, and the scale goes into the
// exponent's FMA (probs). The rows' maxima, in log2 units, into mx0, mx1.
template <bool kMasked, bool kCap>
__device__ __forceinline__ void scores(float (&s)[64], const int* kpos, const Rows& r,
                                       float& mx0, float& mx1) {
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    int2 kq = make_int2(0, 0);
    if constexpr (kMasked) kq = *reinterpret_cast<const int2*>(kpos + 8 * c);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * c + e;
      if constexpr (kCap)
        s[i] = rt::softcap(s[i] * (r.scale_log2 / rt::kLog2e), r.softcap) * rt::kLog2e;
      if (kMasked && !visible(e < 2 ? r.qp0 : r.qp1, e % 2 ? kq.y : kq.x, r.window))
        s[i] = rt::kNegInf;
    }
  }
  row_max(s, mx0, mx1);
  if constexpr (!kCap) {  // a masked row's -1e30 stays far below any score
    mx0 *= r.scale_log2;
    mx1 *= r.scale_log2;
  }
}

// P = 2^(score - the row's max) in place (kRaw: the score is q.k, scaled
// here), each row's share of its sum into sum0, sum1 (a tree, as row_max).
// Where kMasked, a masked score (-1e30) gives 0 also while the row's max
// is -1e30 (a row that has seen no slot yet).
template <bool kMasked, bool kRaw>
__device__ __forceinline__ void probs(float (&s)[64], float scale_log2, float mn0, float mn1,
                                      float& sum0, float& sum1) {
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const float mn = i % 4 < 2 ? mn0 : mn1;
    const float x = kRaw ? fmaf(s[i], scale_log2, -mn) : s[i] - mn;
    s[i] = kMasked && s[i] == rt::kNegInf ? 0.f : rt::ex2(x);
  }
  float a[16], b[16];
#pragma unroll
  for (int c = 0; c < 16; ++c) {
    a[c] = s[4 * c] + s[4 * c + 1];
    b[c] = s[4 * c + 2] + s[4 * c + 3];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int c = 0; c < 8; ++c)
      if (c < 8 >> k) {
        a[c] += a[c + (8 >> k)];
        b[c] += b[c + (8 >> k)];
      }
  sum0 = a[0];
  sum1 = b[0];
}

// Work item k (0 .. nq H B - 1) of the CTAs' walk: the latest 128-row block
// first, over every (head, row) before the next.
struct Item {
  int q0, h, b;
};
__device__ __forceinline__ Item item_of(int k, int nq, int H, int B) {
  const int hb = k % (H * B);
  return {(nq - 1 - k / (H * B)) * kCtaRows, hb % H, hb / H};
}
// The m-th item of this CTA: a snake over the grid, round r taking items r G
// .. r G + G - 1 forwards when r is even and backwards when odd, so the
// CTAs' loads of long and short items even out; -1 past the last.
__device__ __forceinline__ int nth_item(int m, int items) {
  const int G = gridDim.x, c = m % 2 ? G - 1 - blockIdx.x : blockIdx.x;
  const int k = m * G + c;
  return k < items ? k : -1;
}

template <int HDP>
__global__ void __launch_bounds__(kWsThreads, 1)
cache_bf16_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                  const __grid_constant__ CUtensorMap tv, const int* __restrict__ q_pos,
                  const int* __restrict__ k_pos, __nv_bfloat16* __restrict__ o, Strides os,
                  int H, int KV, int B, int S, int Tn, int hd, int window, float scale_log2,
                  float softcap) {
  using L = Layout<HDP>;
  constexpr int kSt = L::kSt;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle pattern repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - raw);
  auto sK = [&](int st) { return base + L::kK + 2 * st * L::kKv; };
  auto sV = [&](int st) { return sK(st) + L::kKv; };
  // stage st's mbarriers: K (v = 0) or V (v = 1) landed, done with
  auto full = [&](int v, int st) { return base + L::kBars + 8 * (v * kSt + st); };
  auto empty = [&](int v, int st) { return base + L::kBars + 8 * ((2 + v) * kSt + st); };
  const uint32_t qbar = base + L::kBars + 32 * kSt;  // Q landed
  // plan buffer u's mbarriers: made, read by every warp that reads it; Q done with
  auto plan_full = [&](int u) { return qbar + 8 + 8 * u; };
  auto plan_empty = [&](int u) { return qbar + 24 + 8 * u; };
  const uint32_t qfree = qbar + 40;
  int* pos = reinterpret_cast<int*>(gbase + L::kPos);
  const int nk = (Tn + kSlots - 1) / kSlots;
  auto red = [&](int u) { return reinterpret_cast<int*>(gbase + L::kPlan) + u * (8 + nk); };
  auto list = [&](int u) { return red(u) + 8; };

  const int nq = (S + kCtaRows - 1) / kCtaRows, items = nq * H * B;
  // values every lane of a warp holds alike are broadcast from lane 0, so
  // the compiler knows the branches on them uniform (see hp::mbar_wait)
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x / 32, 0), lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < kSt; ++st) {
      mbar_init(full(0, st), 2);  // K's copy's arrival (with its bytes), the positions'
      mbar_init(full(1, st), 1);
      mbar_init(empty(0, st), 4 * kConsumers);  // each consumer warp's
      mbar_init(empty(1, st), 4 * kConsumers);
    }
    mbar_init(qbar, 1);
    for (int u = 0; u < 2; ++u) {
      mbar_init(plan_full(u), 1);
      mbar_init(plan_empty(u), 4 * kConsumers + 1);  // the consumer warps and the loader
    }
    mbar_init(qfree, 4 * kConsumers);
    hp::mbar_fence_init();
  }
  __syncthreads();  // the barriers are initialised; no CTA-wide barrier after this

  if (warp >= kProducerWarp) {
    hp::reg_dealloc<kProducerRegs>();
    if (warp > kProducerWarp) {
      // planners: each item's plan into buffer m % 2, once the item two
      // before has left it
      const int pw = warp - kProducerWarp - 1;
      for (int m = 0;; ++m) {
        const int k = nth_item(m, items);
        if (k < 0) break;
        const Item it = item_of(k, nq, H, B);
        if (m >= 2) mbar_wait(plan_empty(m % 2), (m / 2 + 1) & 1);
        plan_tiles<kConsumers, kSlots>(q_pos + static_cast<int64_t>(it.b) * S,
                                       k_pos + static_cast<int64_t>(it.b) * Tn, it.q0, S, Tn,
                                       window, red(m % 2), list(m % 2), pw, kPlanners,
                                       [] { hp::bar_sync(kPlanBarrier, 32 * kPlanners); });
        mbar_arrive_if(plan_full(m % 2), pw == 0 && lane == 0);
      }
      return;
    }
    // loader: each item's Q (once the consumers' last Q K^T is done), then
    // its listed tiles' K (with their slots' positions) and V into the ring
    int it = 0;  // tiles put, over the items
    for (int m = 0;; ++m) {
      const int k = nth_item(m, items);
      if (k < 0) break;
      const Item item = item_of(k, nq, H, B);
      const int g = item.h % KV;
      const int* kp = k_pos + static_cast<int64_t>(item.b) * Tn;
      mbar_wait(plan_full(m % 2), (m / 2) & 1);
      const int n = red(m % 2)[2 * kConsumers];
      const int* lst = list(m % 2);
      if (m > 0) mbar_wait(qfree, (m - 1) & 1);
      if (lane == 0) {
        mbar_expect(qbar, kConsumers * L::kQHalf);  // rows past S arrive as zeros
        for (int w = 0; w < kConsumers; ++w)
          hp::tma_tile<HDP, kQBlock>(base + w * L::kQHalf, &tq, item.q0 + w * kRows, item.h,
                                     item.b, qbar);
      }
      for (int t = 0; t < n; ++t, ++it) {
        const int st = it % kSt, k0 = (lst[t] & kTileMask) * kSlots;
        // K and its positions once tile it - kSt's scores are read
        if (it >= kSt) mbar_wait(empty(0, st), (it / kSt + 1) & 1);
        if (lane == 0) {
          mbar_expect(full(0, st), L::kKv);
          hp::tma_tile<HDP, kKvBlock>(sK(st), &tk, k0, g, item.b, full(0, st));
        }
#pragma unroll
        for (int j = 0; j < kSlots / 32; ++j) {
          const int t_ = k0 + 32 * j + lane;
          pos[st * kSlots + 32 * j + lane] = t_ < Tn ? kp[t_] : -1;
        }
        __syncwarp();
        mbar_arrive_if(full(0, st), lane == 0);
        // V once tile it - kSt's P V is done
        if (it >= kSt) mbar_wait(empty(1, st), (it / kSt + 1) & 1);
        if (lane == 0) {
          mbar_expect(full(1, st), L::kKv);
          hp::tma_tile<HDP, kKvBlock>(sV(st), &tv, k0, g, item.b, full(1, st));
        }
      }
      __syncwarp();
      mbar_arrive_if(plan_empty(m % 2), lane == 0);
    }
  } else {
    // consumer warpgroup w: of each item, rows q0 + 64 w.., this thread's r0
    // and r0 + 8, and the first column of each 8-column block
    hp::reg_alloc<kConsumerRegs>();
    const int w = warp / 4;
    const int c0 = 2 * (lane % 4);
    const uint32_t sQ = base + w * L::kQHalf;
    float acc[HDP / 2];
    uint32_t pa[8][4];  // P (bf16) as the A fragments of P V, 16 slots each
    float m0, m1, l0, l1, corr0, corr1;
    Rows rows{-1, -1, window, scale_log2, softcap};
    // global tile j's online softmax on its scores s (e: its list entry);
    // every warpgroup's branches here are uniform
    auto softmax = [&](float (&s)[64], int j, int e) {
      const int st = j % kSt;
      const bool full_tile = e & (kFull >> w);
      float mx0, mx1;
      const int* kpos = pos + st * kSlots + c0;
      if (rows.softcap > 0.f) {  // a kernel argument: uniform
        if (full_tile) scores<false, true>(s, kpos, rows, mx0, mx1);
        else scores<true, true>(s, kpos, rows, mx0, mx1);
      } else {
        if (full_tile) scores<false, false>(s, kpos, rows, mx0, mx1);
        else scores<true, false>(s, kpos, rows, mx0, mx1);
      }
      __syncwarp();  // this warp is done with the tile's K and positions
      mbar_arrive_if(empty(0, st), lane == 0);
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      corr0 = rt::ex2(m0 - mn0);
      corr1 = rt::ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float sum0, sum1;
      const float sc = rows.scale_log2;
      if (rows.softcap > 0.f) {
        if (full_tile) probs<false, false>(s, sc, mn0, mn1, sum0, sum1);
        else probs<true, false>(s, sc, mn0, mn1, sum0, sum1);
      } else {
        if (full_tile) probs<false, true>(s, sc, mn0, mn1, sum0, sum1);
        else probs<true, true>(s, sc, mn0, mn1, sum0, sum1);
      }
      l0 = l0 * corr0 + sum0;  // this thread's share of the row sum
      l1 = l1 * corr1 + sum1;
    };
    // P as the A fragment: slots 16kk.. are S columns of blocks 2kk, 2kk+1
    auto pack = [&](const float (&s)[64]) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i)
          pa[kk][i] = hp::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    };
    // global tile j's K has landed: e, its list entry, broadcast (uniform)
    auto wait_k = [&](int j, int e) {
      mbar_wait(full(0, j % kSt), (j / kSt) & 1);
      return __shfl_sync(0xffffffffu, e, 0);
    };
    // this warp is done with Q: the loader may bring the next item's
    auto free_q = [&] {
      __syncwarp();
      mbar_arrive_if(qfree, lane == 0);
    };

    if (w == 1) hp::bar_arrive(kTurn, 2 * 128);  // warpgroup 0 issues first
    int it = 0;  // tiles done, over the items
    for (int m = 0;; ++m) {
      const int k = nth_item(m, items);
      if (k < 0) break;
      const Item item = item_of(k, nq, H, B);
      const int* qp = q_pos + static_cast<int64_t>(item.b) * S;
      const int r0 = item.q0 + w * kRows + (warp % 4) * 16 + lane / 4, r1 = r0 + 8;
      rows.qp0 = r0 < S ? qp[r0] : -1;  // -1 past S: sees nothing
      rows.qp1 = r1 < S ? qp[r1] : -1;
#pragma unroll
      for (int i = 0; i < HDP / 2; ++i) acc[i] = 0.f;
      m0 = m1 = rt::kNegInf;
      l0 = l1 = 0.f;
      mbar_wait(plan_full(m % 2), (m / 2) & 1);
      const int n = __shfl_sync(0xffffffffu, red(m % 2)[2 * kConsumers], 0);
      const int* lst = list(m % 2);
      mbar_wait(qbar, m & 1);
      if (n > 0) {  // tile 0: its Q K^T alone
        float s[64];
        const int e = wait_k(it, lst[0]);
        hp::bar_sync(kTurn + w, 2 * 128);
        issue_qk<HDP>(s, sQ, sK(it % kSt));
        hp::bar_arrive(kTurn + 1 - w, 2 * 128);
        wg::wait<0>();
        wg::fence_operands(s);
        if (n == 1) free_q();
        softmax(s, it, e);
        pack(s);
      } else {
        free_q();
      }
      for (int j = 1; j < n; ++j) {
        // tile j's Q K^T and tile j-1's P V issued together, in this
        // warpgroup's turn; tile j's softmax runs while P V does
        const int gj = it + j, st = gj % kSt, sp = (gj - 1) % kSt;
        float s[64];
        const int e = wait_k(gj, lst[j]);
        hp::bar_sync(kTurn + w, 2 * 128);
        issue_qk<HDP>(s, sQ, sK(st));
        mbar_wait(full(1, sp), ((gj - 1) / kSt) & 1);
        issue_pv<HDP>(acc, pa, sV(sp));
        hp::bar_arrive(kTurn + 1 - w, 2 * 128);
        wg::wait<1>();  // Q K^T done
        wg::fence_operands(s);
        if (j + 1 == n) free_q();
        softmax(s, gj, e);
        wg::wait<0>();  // P V done: tile j-1's V is free
        wg::fence_operands(acc);
#pragma unroll
        for (int kk = 0; kk < 8; ++kk) wg::fence_operands(pa[kk]);
        __syncwarp();
        mbar_arrive_if(empty(1, sp), lane == 0);
        // O rescaled where a row's max moved (a causal walk's later tiles
        // rarely move it); the vote keeps the branch uniform
        if (!__all_sync(0xffffffffu, corr0 == 1.f && corr1 == 1.f))
#pragma unroll
          for (int i = 0; i < HDP / 2; ++i) acc[i] *= (i % 4 < 2) ? corr0 : corr1;
        pack(s);
      }
      __syncwarp();  // done with the plan
      mbar_arrive_if(plan_empty(m % 2), lane == 0);
      if (n > 0) {  // the last tile's P V
        const int sp = (it + n - 1) % kSt;
        mbar_wait(full(1, sp), ((it + n - 1) / kSt) & 1);
        issue_pv<HDP>(acc, pa, sV(sp));
        wg::wait<0>();
        wg::fence_operands(acc);
        __syncwarp();
        mbar_arrive_if(empty(1, sp), lane == 0);
      }
      it += n;

#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-30f), inv1 = 1.f / fmaxf(l1, 1e-30f);
      __nv_bfloat16* ob = o + item.b * os.b + item.h * os.h;
#pragma unroll
      for (int jb = 0; jb < HDP / 8; ++jb) {
        const int col = 8 * jb + c0;
        if (col >= hd) continue;
        if (r0 < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + r0 * os.s + col) =
              __floats2bfloat162_rn(acc[4 * jb] * inv0, acc[4 * jb + 1] * inv0);
        if (r1 < S)
          *reinterpret_cast<__nv_bfloat162*>(ob + r1 * os.s + col) =
              __floats2bfloat162_rn(acc[4 * jb + 2] * inv1, acc[4 * jb + 3] * inv1);
      }
    }
    // warpgroup 1 arrived in warpgroup 0's turn once more than 0 waited
    if (w == 0) hp::bar_sync(kTurn, 2 * 128);
  }
}

template <int HDP>
int launch_bf16(const void* q, const void* k, const void* v, const int* q_pos, const int* k_pos,
                void* o, const Strides* st, int B, int H, int KV, int S, int Tn, int hd,
                int window, float softcap, cudaStream_t stream) {
  const int smem = Layout<HDP>::bytes((Tn + kSlots - 1) / kSlots);
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  static int attr = 0;  // the largest size set so far
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        cache_bf16_kernel<HDP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = smem;
  }
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap tq, tk, tv;
  int err = hp::make_map(&tq, q, B, S, H, hd, st[0].s, st[0].h, st[0].b);
  if (err == 0) err = hp::make_map(&tk, k, B, Tn, KV, hd, st[1].s, st[1].h, st[1].b, kSlots);
  if (err == 0) err = hp::make_map(&tv, v, B, Tn, KV, hd, st[2].s, st[2].h, st[2].b, kSlots);
  if (err != 0) return err;
  // persistent: one CTA an SM (its shared memory allows no more), each
  // walking its share of the nq H B items
  const long items = static_cast<long>((S + kCtaRows - 1) / kCtaRows) * H * B;
  const int grid = static_cast<int>(items < sms ? items : sms);
  cache_bf16_kernel<HDP><<<grid, kWsThreads, smem, stream>>>(
      tq, tk, tv, q_pos, k_pos, static_cast<__nv_bfloat16*>(o), st[3], H, KV, B, S, Tn, hd,
      window, rt::kLog2e / sqrtf(static_cast<float>(hd)), softcap);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// every other case: CUDA cores
// ---------------------------------------------------------------------------
// One block per (q tile of 64 rows, head, batch) walks the listed K/V tiles
// of 64 slots staged in shared memory as f32, rows padded to hd+1 so the
// 16x16 thread grid reads them without bank conflicts. Each thread owns a
// 4x4 block of the score tile and a 4 x hd/16 block of the output
// accumulator in registers.

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ float as_v(float p);  // P as P V reads it
template <> __device__ __forceinline__ float as_v<float>(float p) { return p; }
template <> __device__ __forceinline__ float as_v<__nv_bfloat16>(float p) {
  return __bfloat162float(__float2bfloat16_rn(p));
}

// DPER: output columns a thread (hd <= 16 DPER)
template <typename T, int DPER>
__global__ void __launch_bounds__(kThreads)
cache_scalar_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
                    T* __restrict__ o, Strides qs, Strides ks, Strides vs, Strides os, int KV,
                    int S, int Tn, int hd, int window, float scale, float softcap) {
  extern __shared__ float smem[];
  const int hdp = hd + 1;
  float* q_s = smem;                  // [kRows][hd+1]
  float* k_s = q_s + kRows * hdp;     // [kRows][hd+1]
  float* v_s = k_s + kRows * hdp;     // [kRows][hd]
  float* s_s = v_s + kRows * hd;      // [kRows][kRows+1]
  float* m_s = s_s + kRows * (kRows + 1);
  float* l_s = m_s + kRows;
  float* c_s = l_s + kRows;
  int* qp_s = reinterpret_cast<int*>(c_s + kRows);  // the rows' positions
  int* kp_s = qp_s + kRows;                          // the tile's slots' positions
  int* red = kp_s + kRows;
  int* list = red + 4;

  const int iq = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int g = h % KV;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = iq * kRows;
  const T* qb = q + b * qs.b + h * qs.h;
  const T* kb = k + b * ks.b + g * ks.h;
  const T* vb = v + b * vs.b + g * vs.h;
  const int* qp = q_pos + static_cast<int64_t>(b) * S;
  const int* kp = k_pos + static_cast<int64_t>(b) * Tn;

  const int n = plan_tiles<1, kRows>(qp, kp, q0, S, Tn, window, red, list, tid / 32,
                                   kThreads / 32, [] { __syncthreads(); });
  for (int e = tid; e < kRows * hd; e += kThreads) {
    const int i = e / hd, d = e % hd;
    q_s[i * hdp + d] = (q0 + i < S) ? rt::to_f(qb[(q0 + i) * qs.s + d]) : 0.f;
  }
  for (int i = tid; i < kRows; i += kThreads) {
    qp_s[i] = q0 + i < S ? qp[q0 + i] : -1;  // a row past S sees nothing
    m_s[i] = rt::kNegInf;
    l_s[i] = 0.f;
  }
  float acc[4][DPER];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < DPER; ++c) acc[a][c] = 0.f;

  for (int it = 0; it < n; ++it) {
    const int k0 = (list[it] & ~kFull) * kRows;
    __syncthreads();  // previous tile fully consumed
    for (int e = tid; e < kRows * hd; e += kThreads) {
      const int j = e / hd, d = e % hd;
      const bool in = k0 + j < Tn;
      k_s[j * hdp + d] = in ? rt::to_f(kb[(k0 + j) * ks.s + d]) : 0.f;
      v_s[j * hd + d] = in ? rt::to_f(vb[(k0 + j) * vs.s + d]) : 0.f;
    }
    for (int j = tid; j < kRows; j += kThreads) kp_s[j] = k0 + j < Tn ? kp[k0 + j] : -1;
    __syncthreads();
    // scores: thread (ty, tx) owns rows ty+16a and columns tx+16c
    float sc[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[a][c] = 0.f;
    for (int d = 0; d < hd; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) qv[a] = q_s[(ty + 16 * a) * hdp + d];
#pragma unroll
      for (int c = 0; c < 4; ++c) kv[c] = k_s[(tx + 16 * c) * hdp + d];
#pragma unroll
      for (int a = 0; a < 4; ++a)
#pragma unroll
        for (int c = 0; c < 4; ++c) sc[a][c] += qv[a] * kv[c];
    }
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = ty + 16 * a, j = tx + 16 * c;
        s_s[i * (kRows + 1) + j] = visible(qp_s[i], kp_s[j], window)
                                       ? rt::softcap(sc[a][c] * scale, softcap) : rt::kNegInf;
      }
    __syncthreads();
    // online softmax, one thread per query row; P as P V reads it (bf16
    // rounded for bf16 V), the row sum of the unrounded P
    for (int i = tid; i < kRows; i += kThreads) {
      float* row = s_s + i * (kRows + 1);
      const float m_prev = m_s[i];
      float mx = rt::kNegInf;
      for (int j = 0; j < kRows; ++j) mx = fmaxf(mx, row[j]);
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int j = 0; j < kRows; ++j) {
        const float p = visible(qp_s[i], kp_s[j], window) ? expf(row[j] - m_new) : 0.f;
        row[j] = as_v<T>(p);
        sum += p;
      }
      const float corr = expf(m_prev - m_new);
      l_s[i] = l_s[i] * corr + sum;
      m_s[i] = m_new;
      c_s[i] = corr;
    }
    __syncthreads();
    // acc = acc * corr + P V
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float corr = c_s[ty + 16 * a];
#pragma unroll
      for (int c = 0; c < DPER; ++c) acc[a][c] *= corr;
    }
    for (int j = 0; j < kRows; ++j) {
      float pv[4];
#pragma unroll
      for (int a = 0; a < 4; ++a) pv[a] = s_s[(ty + 16 * a) * (kRows + 1) + j];
#pragma unroll
      for (int c = 0; c < DPER; ++c) {
        const int d = tx + 16 * c;
        if (d < hd) {
          const float vv = v_s[j * hd + d];
#pragma unroll
          for (int a = 0; a < 4; ++a) acc[a][c] += pv[a] * vv;
        }
      }
    }
  }
  __syncthreads();
  T* ob = o + b * os.b + h * os.h;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = ty + 16 * a;
    if (q0 + i >= S) continue;
    const float inv = 1.f / fmaxf(l_s[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < DPER; ++c) {
      const int d = tx + 16 * c;
      if (d < hd) ob[(q0 + i) * os.s + d] = rt::from_f<T>(acc[a][c] * inv);
    }
  }
}

template <typename T, int DPER>
int launch_scalar(const void* q, const void* k, const void* v, const int* q_pos,
                  const int* k_pos, void* o, const Strides* st, int B, int H, int KV, int S,
                  int Tn, int hd, int window, float softcap, cudaStream_t stream) {
  const int hdp = hd + 1, nk = (Tn + kRows - 1) / kRows;
  const size_t smem =
      sizeof(float) * (2 * kRows * hdp + kRows * hd + kRows * (kRows + 1) + 3 * kRows) +
      sizeof(int) * (2 * kRows + 4 + nk);
  if (smem > static_cast<size_t>(kMaxSmem)) return static_cast<int>(cudaErrorInvalidValue);
  static size_t attr = 0;  // the largest size set so far
  if (smem > attr) {
    const cudaError_t err = cudaFuncSetAttribute(
        cache_scalar_kernel<T, DPER>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attr = smem;
  }
  const dim3 grid((S + kRows - 1) / kRows, H, B);
  cache_scalar_kernel<T, DPER><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), q_pos,
      k_pos, static_cast<T*>(o), st[0], st[1], st[2], st[3], KV, S, Tn, hd, window,
      1.0f / sqrtf(static_cast<float>(hd)), softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 int64 (batch, sequence, head) strides of q, k, v, out, in
// elements; the head_dim stride is 1 for all four. bfloat16 takes the
// tensor cores where hd % 16 == 0, T > 0, the strides are multiples of 8
// and q, k, v start on 16 bytes (a tensor map's terms); else the CUDA
// cores. window, softcap: 0 = off.
extern "C" int rt_cache_attention(const void* q, const void* k, const void* v,
                                  const void* q_pos, const void* k_pos, void* out,
                                  const void* strides, int B, int H, int KV, int S, int T,
                                  int hd, int window, int dtype, float softcap, void* stream) {
  if (B <= 0 || S <= 0 || T < 0 || KV <= 0 || H % KV != 0 || hd <= 0 || hd > kMaxHd)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t* p = static_cast<const int64_t*>(strides);
  const Strides st[4] = {{p[0], p[1], p[2]}, {p[3], p[4], p[5]},
                         {p[6], p[7], p[8]}, {p[9], p[10], p[11]}};
  const int* qp = static_cast<const int*>(q_pos);
  const int* kp = static_cast<const int*>(k_pos);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == rt::kF32)
    return (hd <= 128 ? launch_scalar<float, 8> : launch_scalar<float, 16>)(
        q, k, v, qp, kp, out, st, B, H, KV, S, T, hd, window, softcap, s);
  if (dtype != rt::kBF16) return static_cast<int>(cudaErrorInvalidValue);
  bool tiles = hd % 16 == 0 && hd <= kMaxTileHd && T > 0;
  for (int i = 0; i < 9; ++i) tiles = tiles && p[i] % 8 == 0;
  for (const void* t : {q, k, v}) tiles = tiles && reinterpret_cast<uintptr_t>(t) % 16 == 0;
  if (!tiles)
    return (hd <= 128 ? launch_scalar<__nv_bfloat16, 8> : launch_scalar<__nv_bfloat16, 16>)(
        q, k, v, qp, kp, out, st, B, H, KV, S, T, hd, window, softcap, s);
  return (hd <= 64 ? launch_bf16<64> : launch_bf16<128>)(q, k, v, qp, kp, out, st, B, H, KV, S,
                                                         T, hd, window, softcap, s);
}

extern "C" int rt_cache_attention_max_hd() { return kMaxHd; }
