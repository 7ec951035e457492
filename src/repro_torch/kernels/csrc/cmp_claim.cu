// k-way earliest-cycle claim over the CMP slot pool, for Hopper: one launch
// at every pool size, with slotpool.claim's epilogue fused in.
//
// Replaces: src/repro/kernels/cmp_claim.py :: _claim_kernel (:43, the
// single-block pallas_call at :137) and _claim_block_kernel (:64, the tiled
// pallas_call at :95) with the XLA lexsort merge of _cmp_claim_tiled. Slot
// j is claimable when state[j] == AVAILABLE and cycle[j] != INT32_MAX; the k
// claimable slots of smallest (cycle, id) go AVAILABLE -> CLAIMED and their
// ids are written in that order; lanes past the claimable slots hold n (also
// when k > n). The Pallas block size never changes the result; here the
// kernel picks its own tile.
//
// What bounds it: nothing on the card's rates. 65,536 slots move 0.79 MB
// (1.3 MB with the pool's retire copy), 0.24-0.39 us at 3.35 TB/s; a call
// costs its latency chain: the loads, a selection and a merge across CTAs.
// Design (phases timed by clock64() stamps in a copy of this file):
//   key    one int64, the cycle in the high word and the id in the low, so
//          the (cycle, id) order is one signed compare. A slot that is not
//          claimable, and a lane past n, gets the high word INT32_MAX and
//          keeps its own id, so all keys are distinct and these rank last.
//   tiles  one CTA of 128 threads per 512 slots (128 CTAs at 65,536: one an
//          SM). A thread loads 4 slots of state and cycle (16 bytes each
//          when aligned) and copies state (and retire_cycle) to the outputs
//          as it loads. Each warp sorts its 128 keys in registers (bitonic:
//          register swaps below a stride of 4, __shfl_xor_sync above). For m
//          = min(k, 512) <= 128, two levels of warp min-merges (the 128
//          smallest of two sorted runs: an elementwise min against the other
//          run reversed, then 7 bitonic stages) leave the tile's first m in
//          warp 0; for larger m each key ranks itself in the other warps'
//          runs by branch-free binary search. No full-tile sort in shared
//          memory. The run goes to the candidates by column (key i of tile
//          t at i * nb + t), so the merge reads each column contiguously.
//   merge  in the same launch, by the last CTA to finish: each CTA writes its
//          run and counts itself (an acq_rel atomic add) on a counter that the
//          wrapper keeps per (device, stream), zeroed once outside any graph
//          capture; the CTA that sees the count reach nb - 1 merges, then
//          resets the counter to 0 for the next call (and the next replay of
//          a CUDA graph). Chosen over a
//          cooperative launch, whose grid.sync bounds the grid to what is
//          co-resident (2**20 slots are 2,048 CTAs) and makes every CTA
//          wait. The merging CTA stages the runs in shared memory by
//          cp.async, one group (up to 8,192 keys in all: 65,536 slots at
//          k = 64), and bounds the k-th key from above: by the smallest run
//          tail when m == k, and by the r-th smallest
//          of column j of the runs, r (j + 1) >= k (j = 0: the k-th smallest
//          head). The keys at or below the bound are a prefix of each run
//          (a thread a run finds it by binary search); there are about k of
//          them, and each is ranked by counting the others. When more than
//          1,024 lie below the bound (k in the hundreds, or k > n), each
//          ranks itself run by run instead (one compare when a run lies
//          wholly below or above it, a binary search otherwise, stopping at
//          k). Rank r < k writes ids[r]; ranks are distinct, so no atomics
//          order the selection.
//   pool   the merging CTA (or the only CTA) also writes valid, the new
//          deque_cycle (the monotone max of deque_cycle and the cycle of the
//          last valid lane, 0 when a lane is invalid, as slotpool.claim's
//          max over where(valid, cycle[ids], 0)), and that boundary at each
//          claimed id of the retire_cycle copy: slotpool.claim is one launch.
// Concurrent calls: two calls that share a counter must not overlap. Calls
// on one stream are ordered by it; a CUDA graph uses the counter of the
// stream it was captured on, so one graph is not replayed while another
// replay of it, or a call on its capture stream, is running.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kAvailable = 1, kClaimed = 2;
constexpr int kThreads = 128;               // four warps
constexpr int kPer = 4;                     // slots a thread: one int4 of each array
constexpr int kWarpRun = 32 * kPer;         // keys a warp sorts
constexpr int kTile = kThreads * kPer;      // slots a CTA: 512
constexpr int kStage = 8192;                // runs' keys the merging CTA stages: 64 KiB
constexpr int kSelect = 1024;               // keys at or below the bound it ranks by counting
constexpr int kMaxN = INT_MAX - kTile;      // ids of lanes past n stay below 2**31
// keys at or above kSentinel are not claimable
constexpr long long kSentinel = static_cast<long long>(INT_MAX) << 32;

// slotpool.claim's epilogue; every pointer null for a bare claim.
struct Pool {
  const int* retire;
  int* new_retire;
  const int* deque;
  int* new_deque;
  bool* valid;
};

__device__ __forceinline__ long long pack(int hi, unsigned lo) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(hi)) << 32) | lo);
}

__device__ __forceinline__ long long lmin(long long a, long long b) { return a < b ? a : b; }
__device__ __forceinline__ long long lmax(long long a, long long b) { return a < b ? b : a; }

// One compare-exchange stage of a bitonic network over a warp's 128 keys,
// element e = lane * 4 + r in x[r]: strides 1 and 2 swap registers, larger
// strides shuffle with lane ^ (stride / 4). Blocks of `size` with bit
// `size` of e clear sort ascending.
__device__ __forceinline__ void bitonic_stage(long long (&x)[kPer], int lane, int size,
                                              int stride) {
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const bool asc = ((lane * kPer + r) & size) == 0;
    if (stride < kPer) {
      if ((r & stride) == 0) {
        const long long a = x[r], b = x[r | stride];
        if ((a > b) == asc) {
          x[r] = b;
          x[r | stride] = a;
        }
      }
    } else {
      const long long p = __shfl_xor_sync(0xffffffffu, x[r], stride / kPer);
      const bool lower = (lane & (stride / kPer)) == 0;
      x[r] = (lower == asc) ? lmin(x[r], p) : lmax(x[r], p);
    }
  }
}

// Bitonic sort, ascending, of the warp's 128 keys (15 of its 28 stages shuffle).
__device__ __forceinline__ void warp_sort(long long (&x)[kPer], int lane) {
#pragma unroll
  for (int size = 2; size <= kWarpRun; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) bitonic_stage(x, lane, size, stride);
  }
}

// x (sorted) becomes the 128 smallest of x and the sorted run b, sorted:
// min(x[e], b[127 - e]) is bitonic and holds them; 7 stages merge it.
__device__ __forceinline__ void warp_merge_min(long long (&x)[kPer], const long long* b,
                                               int lane) {
#pragma unroll
  for (int r = 0; r < kPer; ++r) x[r] = lmin(x[r], b[kWarpRun - 1 - (lane * kPer + r)]);
#pragma unroll
  for (int stride = kWarpRun / 2; stride > 0; stride >>= 1) {
    bitonic_stage(x, lane, 2 * kWarpRun, stride);
  }
}

// Keys below x in a warp's sorted run a[0, 128): branch-free, 8 loads.
__device__ __forceinline__ int count_below(const long long* a, long long x) {
  int pos = 0;
#pragma unroll
  for (int step = kWarpRun / 2; step > 0; step >>= 1) pos += a[pos + step - 1] < x ? step : 0;
  return pos + (a[pos] < x);  // a[pos] >= x unless pos == 127
}

// Start copying keys [begin, end) written by other CTAs of this launch from
// global to shared memory: 16-byte cp.async past L1, all in flight at once
// (a key at an odd edge is copied at once). cp_async_wait<g> waits until at
// most g committed groups are in flight.
__device__ void copy_async(long long* dst, const long long* src, int begin, int end) {
  const int a = begin + (begin & 1), b = end - (end & 1);
  for (int i = a + 2 * static_cast<int>(threadIdx.x); i + 1 < b; i += 2 * kThreads) {
    const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst + i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src + i) : "memory");
  }
  if (threadIdx.x == 0) {
    if (begin < a && begin < end) dst[begin] = __ldcg(src + begin);
    if (b < end && b >= a) dst[b] = __ldcg(src + b);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int kGroups>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(kGroups) : "memory");
}

// Global memory written by other CTAs of this launch is read past L1.
template <bool kShared>
__device__ __forceinline__ long long load(const long long* p, long long i) {
  if constexpr (kShared) return p[i];
  else return __ldcg(p + i);
}

struct Shared {
  int count;       // claimable keys taken (they hold ranks 0 .. count - 1)
  int cycle_max;   // the largest cycle among them
  int selected;    // keys at or below the merge's bound
  long long bound; // the merge's upper bound on the k-th key
  bool last;       // this CTA merges
};

// A thread's claims, added to Shared a warp at a time.
struct Taken {
  int count = 0, cycle_max = INT_MIN;
};

// Rank `rank` < k takes `key`: a claimable key claims its slot.
__device__ __forceinline__ void take(long long key, int rank, int* ids, int* new_state,
                                     Taken& tk) {
  if (key < kSentinel) {
    const int id = static_cast<int>(key & 0xffffffffLL);
    ids[rank] = id;
    new_state[id] = kClaimed;  // after the copy of its tile: a barrier or the counter orders them
    ++tk.count;
    tk.cycle_max = max(tk.cycle_max, static_cast<int>(key >> 32));
  }
}

// Whole warps: one atomic each.
__device__ __forceinline__ void flush(const Taken& tk, Shared& sh) {
  const int count = __reduce_add_sync(0xffffffffu, tk.count);
  const int cycle_max = __reduce_max_sync(0xffffffffu, tk.cycle_max);
  if ((threadIdx.x & 31) == 0 && count > 0) {
    atomicAdd(&sh.count, count);
    atomicMax(&sh.cycle_max, cycle_max);
  }
}

// After every take: pad ids with n, then the pool's epilogue.
__device__ void finish(int* ids, const Pool& pool, Shared& sh, int n, int k) {
  __syncthreads();
  const int count = sh.count;
  for (int r = count + threadIdx.x; r < k; r += kThreads) ids[r] = n;
  if (pool.valid == nullptr) return;
  for (int r = threadIdx.x; r < k; r += kThreads) pool.valid[r] = r < count;
  // max over where(valid, cycle[ids], 0): the last valid lane's cycle, and 0
  // as soon as one lane is invalid
  const int claimed_max = count == 0 ? 0 : count < k ? max(sh.cycle_max, 0) : sh.cycle_max;
  const int dq = max(*pool.deque, claimed_max);
  if (threadIdx.x == 0) *pool.new_deque = dq;
  for (int r = threadIdx.x; r < count; r += kThreads) pool.new_retire[ids[r]] = dq;
}

// The last CTA's merge of nb sorted runs of m keys, stored by column: key i
// of run t at cand[i * nb + t]. runs: cand, or, when kShared, its copy in
// shared memory, in flight in one cp.async group. col: column j of the runs
// in shared memory (see below), or null.
template <bool kShared>
__device__ void merge_runs(const long long* runs, const long long* cand, const long long* col,
                           int j, long long* s_sel, int nb, int m, int k, int* ids,
                           int* new_state, Shared& sh) {
  auto at = [runs, nb](int t, int i) {
    return load<kShared>(runs, static_cast<long long>(i) * nb + t);
  };
  const int tid = threadIdx.x, lane = tid & 31;
  // An upper bound u on the k-th key: k keys lie at or below it. Each run's
  // tail when m == k; and the r-th smallest of column j, which has j + 1
  // keys at or below it in each of r runs: r (j + 1) >= k (j = 0: the k-th
  // smallest head).
  long long u = LLONG_MAX;
  if (m == k) {  // from global memory, while the copy is in flight
    for (int t = tid; t < nb; t += kThreads) {
      u = lmin(u, __ldcg(cand + static_cast<long long>(m - 1) * nb + t));
    }
  }
  if constexpr (kShared) {
    cp_async_wait<0>();
    __syncthreads();
  }
  if (col != nullptr) {
    const int r = (k + j) / (j + 1);
    for (int t = tid; t < nb; t += kThreads) {
      const long long v = col[t];
      int below = 0;  // stops once past r - 1: then v is not the r-th
      int t0 = 0;
      for (; t0 + 16 <= nb && below < r; t0 += 16) {
#pragma unroll
        for (int d = 0; d < 16; ++d) below += col[t0 + d] < v;
      }
      for (; t0 < nb && below < r; ++t0) below += col[t0] < v;
      if (below == r - 1) u = lmin(u, v);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) u = lmin(u, __shfl_xor_sync(0xffffffffu, u, off));
  if (lane == 0) atomicMin(&sh.bound, u);
  __syncthreads();
  u = sh.bound;
  // Gather the keys at or below u, a thread a run: a prefix of each run,
  // its length by binary search, its place by a scan across the warp.
  for (int t0 = 0; t0 < nb; t0 += kThreads) {
    const int t = t0 + tid;
    int len = 0;
    if (t < nb && at(t, 0) <= u) {
      for (int step = 1 << (31 - __clz(m)); step > 0; step >>= 1) {
        if (len + step <= m && at(t, len + step - 1) <= u) len += step;
      }
    }
    int end = len;  // inclusive scan
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(0xffffffffu, end, off);
      if (lane >= off) end += v;
    }
    int base = 0;
    if (lane == 31) base = atomicAdd(&sh.selected, end);
    base = __shfl_sync(0xffffffffu, base, 31) + end - len;
    for (int i = 0; i < len && base + i < kSelect; ++i) s_sel[base + i] = at(t, i);
  }
  __syncthreads();
  const int selected = sh.selected;
  Taken tk;
  if (selected <= kSelect) {  // rank by counting among them
    for (int e0 = 0; e0 < selected; e0 += kThreads) {
      const int e = e0 + tid;
      if (e < selected) {
        const long long x = s_sel[e];
        int rank = 0, e2 = 0;
        for (; e2 + 8 <= selected; e2 += 8) {
#pragma unroll
          for (int d = 0; d < 8; ++d) rank += s_sel[e2 + d] < x;
        }
        for (; e2 < selected; ++e2) rank += s_sel[e2] < x;
        if (rank < k) take(x, rank, ids, new_state, tk);
      }
    }
  } else {
    // Too many to count among (k in the hundreds, or k > n): each key at
    // or below u counts, run by run, the keys below it.
    const long long total = static_cast<long long>(nb) * m;
    for (long long f0 = 0; f0 < total; f0 += kThreads) {
      const long long f = f0 + tid;
      const int i = static_cast<int>(f / nb), t0 = static_cast<int>(f % nb);
      const long long x = f < total ? at(t0, i) : LLONG_MAX;
      if (x > u) continue;
      int rank = 0;
      for (int t = 0; t < nb && rank < k; ++t) {
        if (at(t, 0) >= x) continue;           // nothing below x (== x: x heads this run)
        if (at(t, m - 1) < x) {
          rank += m;
          continue;
        }
        int lo = 1, hi = m - 1;                 // run[0] < x <= run[m - 1]
        while (lo < hi) {
          const int mid = (lo + hi) >> 1;
          if (at(t, mid) < x) lo = mid + 1; else hi = mid;
        }
        rank += lo;
      }
      if (rank < k) take(x, rank, ids, new_state, tk);
    }
  }
  flush(tk, sh);
}

__global__ void __launch_bounds__(kThreads)
claim_kernel(const int* __restrict__ state, const int* __restrict__ cycle,
             int* __restrict__ new_state, int* __restrict__ ids, Pool pool,
             long long* __restrict__ cand, unsigned* __restrict__ counter, int n, int k,
             int m, bool vec, const int* __restrict__ gate) {
  // a gated launch with *gate == 0 does nothing (no CTA counts itself)
  if (gate != nullptr && *gate == 0) return;
  extern __shared__ __align__(16) long long s_keys[];  // the warps' runs; then the merge's
  __shared__ Shared sh;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (tid == 0) {
    sh.count = 0;
    sh.cycle_max = INT_MIN;
    sh.selected = 0;
    sh.bound = LLONG_MAX;
  }
  const int g0 = blockIdx.x * kTile + tid * kPer;
  int st[kPer], cy[kPer];
  if (vec && g0 + kPer <= n) {
    const int4 s4 = *reinterpret_cast<const int4*>(state + g0);
    const int4 c4 = *reinterpret_cast<const int4*>(cycle + g0);
    *reinterpret_cast<int4*>(new_state + g0) = s4;
    if (pool.retire != nullptr) {
      *reinterpret_cast<int4*>(pool.new_retire + g0) =
          *reinterpret_cast<const int4*>(pool.retire + g0);
    }
    st[0] = s4.x; st[1] = s4.y; st[2] = s4.z; st[3] = s4.w;
    cy[0] = c4.x; cy[1] = c4.y; cy[2] = c4.z; cy[3] = c4.w;
  } else {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const int g = g0 + r;
      st[r] = 0;
      cy[r] = 0;
      if (g < n) {
        st[r] = state[g];
        cy[r] = cycle[g];
        new_state[g] = st[r];
        if (pool.retire != nullptr) pool.new_retire[g] = pool.retire[g];
      }
    }
  }
  long long x[kPer];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int g = g0 + r;
    x[r] = pack(g < n && st[r] == kAvailable ? cy[r] : INT_MAX, static_cast<unsigned>(g));
  }
  warp_sort(x, lane);
  long long* run = s_keys + warp * kWarpRun;
#pragma unroll
  for (int r = 0; r < kPer; ++r) run[lane * kPer + r] = x[r];
  __syncthreads();
  // The tile's first m keys, sorted: rank r goes to ids (one CTA) or to
  // column r of the candidates.
  const int nb = gridDim.x;
  Taken tk;
  auto emit = [&](long long key, int rank) {
    if (nb == 1) take(key, rank, ids, new_state, tk);
    else cand[static_cast<long long>(rank) * nb + blockIdx.x] = key;
  };
  if (m <= kWarpRun) {  // two levels of min-merges: warps 0 + 1, 2 + 3; then 0 + 2
    if ((warp & 1) == 0) warp_merge_min(x, run + kWarpRun, lane);
    if (warp == 2) {
#pragma unroll
      for (int r = 0; r < kPer; ++r) run[lane * kPer + r] = x[r];
    }
    __syncthreads();
    if (warp == 0) {
      warp_merge_min(x, s_keys + 2 * kWarpRun, lane);
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        if (lane * kPer + r < m) emit(x[r], lane * kPer + r);
      }
    }
  } else {  // each key ranks itself in the other warps' runs
    int rank[kPer];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      rank[r] = lane * kPer + r;
#pragma unroll
      for (int w = 0; w < kThreads / 32; ++w) {
        if (w != warp) rank[r] += count_below(s_keys + w * kWarpRun, x[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      if (rank[r] < m) emit(x[r], rank[r]);
    }
  }
  if (nb > 1) {
    __syncthreads();  // the CTA's run is written
    if (tid == 0) {  // count the CTA: release its run, acquire the others'
      unsigned before;
      asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;"
                   : "=r"(before) : "l"(counter) : "memory");
      sh.last = before == static_cast<unsigned>(nb - 1);
    }
    __syncthreads();
    if (!sh.last) return;
    if (tid == 0) *counter = 0;  // every CTA has counted
    // column j of the bound (see merge_runs): the smallest j with r <= nb
    const int j = (k + nb - 1) / nb - 1;
    const long long total = static_cast<long long>(nb) * m;
    if (total <= kStage) {
      copy_async(s_keys, cand, 0, static_cast<int>(total));
      cp_async_commit();
      merge_runs<true>(s_keys, cand, j < m ? s_keys + j * nb : nullptr, j, s_keys + total, nb,
                       m, k, ids, new_state, sh);
    } else {
      long long* col = nullptr;
      if (j < m && nb <= kStage) {
        col = s_keys;
        for (int t = tid; t < nb; t += kThreads) {
          col[t] = __ldcg(cand + static_cast<long long>(j) * nb + t);
        }
        __syncthreads();
      }
      merge_runs<false>(cand, cand, col, j, s_keys + (col != nullptr ? nb : 0), nb, m, k, ids,
                        new_state, sh);
    }
  } else {
    flush(tk, sh);
  }
  finish(ids, pool, sh, n, k);
}

}  // namespace

// One launch: the claim, and with the pool pointers (retire .. valid) not
// null, slotpool.claim's epilogue. cand (int64, cdiv(n, 512) * min(k, 512))
// and counter (an int32 at 0, left at 0) are needed when n > 512. vec: every
// slot array is 16-byte aligned.
namespace {

int launch_claim(const void* state, const void* cycle, void* new_state, void* ids,
                 const void* retire, void* new_retire, const void* deque, void* new_deque,
                 void* valid, void* cand, void* counter, int n, int k, int vec,
                 const void* gate, void* stream) {
  const int nb = n > 0 ? (n + kTile - 1) / kTile : 0;
  const bool pool = retire != nullptr;
  if (n <= 0 || n > kMaxN || k <= 0 ||
      (nb > 1 && (cand == nullptr || counter == nullptr)) ||
      (pool && (new_retire == nullptr || deque == nullptr || new_deque == nullptr ||
                valid == nullptr))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int m = std::min(k, kTile);
  const long long total = static_cast<long long>(nb) * m;
  // shared memory: the warps' runs; then the staged runs or run heads and
  // the keys at or below the merge's bound
  const long long staged = total <= kStage ? total : nb <= kStage ? nb : 0;
  const long long keys = nb == 1 ? kTile : std::max<long long>(kTile, staged + kSelect);
  const size_t smem = static_cast<size_t>(keys) * sizeof(long long);
  if (smem > 48 * 1024) {  // once a device: up to 72 KiB
    static bool opted_in[64];
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess && !opted_in[dev & 63]) {
      err = cudaFuncSetAttribute(claim_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 static_cast<int>((kStage + kSelect) * sizeof(long long)));
      opted_in[dev & 63] = err == cudaSuccess;
    }
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const Pool p{static_cast<const int*>(retire), static_cast<int*>(new_retire),
               static_cast<const int*>(deque), static_cast<int*>(new_deque),
               static_cast<bool*>(valid)};
  claim_kernel<<<nb, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(state), static_cast<const int*>(cycle),
      static_cast<int*>(new_state), static_cast<int*>(ids), p,
      static_cast<long long*>(cand), static_cast<unsigned*>(counter), n, k, m, vec != 0,
      static_cast<const int*>(gate));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rt_cmp_claim(const void* state, const void* cycle, void* new_state,
                            void* ids, const void* retire, void* new_retire,
                            const void* deque, void* new_deque, void* valid, void* cand,
                            void* counter, int n, int k, int vec, void* stream) {
  return launch_claim(state, cycle, new_state, ids, retire, new_retire, deque, new_deque,
                      valid, cand, counter, n, k, vec, nullptr, stream);
}

// The same claim (no pool epilogue) that runs only when *gate != 0, read on
// the card: the admission ring's grid path launches it unconditionally and
// lets its enqueue pass decide.
extern "C" int rt_cmp_claim_gated(const void* state, const void* cycle, void* new_state,
                                  void* ids, void* cand, void* counter, int n, int k, int vec,
                                  const void* gate, void* stream) {
  return launch_claim(state, cycle, new_state, ids, nullptr, nullptr, nullptr, nullptr,
                      nullptr, cand, counter, n, k, vec, gate, stream);
}
