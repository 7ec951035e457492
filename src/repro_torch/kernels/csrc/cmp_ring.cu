// Fused CMP admission-ring step for Hopper.
//
// Replaces: src/repro/kernels/cmp_ring.py :: _ring_kernel (the pallas_call
// in cmp_ring_step, cmp_ring.py:111). One call runs the whole admission
// step on the card:
//   R  CLAIMED slots with cycle < dc - window return to FREE (paper Alg 4);
//   E  the push_n new items take offsets off_j = (j - enq) mod N and the
//      contiguous FREE prefix of offsets is accepted, cycles enq+1+off;
//   C  up to min(want, k) earliest-cycle AVAILABLE slots are claimed, their
//      cycles written ascending, unfilled lanes -1;
//   P  meta' = [enq + accepted, max(dc, max claimed)].
// All int32 arithmetic wraps, as in the oracle (kernels/ref.py).
//
// What bounds it: one CTA's latency chain. The ring is N = 16 * max_batch
// int32 slots (128 at max_batch 8, 16,384 at 1,024): a few KB to 200 KB of
// state, so the bytes take well under a microsecond and the time is the
// dependent steps between the loads and the stores, plus the launch.
//
// Design: claim by ring position, not by rank. Enqueue gives the slot
// (c-1) mod N the cycle c, and an enqueue stops at the first slot that is
// not FREE, so every AVAILABLE cycle lies in (enq' - N, enq'] (enq' the new
// frontier). While that holds for every claimable slot, the ascending-cycle
// order of those slots is ring order starting at slot enq' mod N, and a
// slot's claim rank is the count of claimable slots before it in that
// rotated order: a warp ballot and popc per row of slots, one scan over the
// warps' counts, no search. The invariant is checked in the kernel (one
// __syncthreads_or); when any slot breaks it (inputs the engine never
// makes: duplicate or permuted cycles, wrapped cycles near INT32_MAX) the
// same launch takes a general path that is exact for any input: a bitonic
// sort of the keys in shared memory, then the oracle's threshold select
// (ties included). `accepted` is a warp min-reduce and a min over the
// warps; there is no atomic. Each thread holds S slots in registers
// (S = 1..16, 1,024 threads at most); shared memory holds the warps'
// partials, and the general path's keys.
//
// Rings of more than 16,384 slots (max_batch above 1,024) take a grid path
// of four launches, a thread a slot, exact for any input:
//   scan     reclaim, and the first blocked offset of the push by atomicMin
//            into a scratch word (set by a memset first);
//   enqueue  the accepted prefix's writes (the new state to scratch, the
//            cycles to the output, meta'[0] published); each CTA counts its
//            claimable slots, and those before slot enq' mod N, and flags
//            any claimable slot that breaks the enqueue invariant;
//   claim    only when a slot broke it (the launch is gated on the flag, on
//            the card): the claim kernel of cmp_claim.cu takes the
//            min(k, want) claimable slots of smallest (cycle, id), whose
//            cycles in ascending order are the oracle's sorted keys;
//   publish  with the invariant intact, a claim by ring position as in the
//            one-CTA kernel: a slot's rank is the CTA counts before it plus
//            its place in its CTA (ballots), rotated to start at enq' mod
//            N. Otherwise threshold = the take-th smallest claimable cycle
//            and every claimable slot at or below it goes CLAIMED, ties
//            included, as the oracle's select does (a state with duplicate
//            cycles claims more slots than take; the claim kernel alone
//            claims exactly take).
#include <climits>

#include "common.cuh"

namespace {

constexpr int kFree = 0, kAvailable = 1, kClaimed = 2;
constexpr int kMaxThreads = 1024;
constexpr int kMaxSlots = 16;  // slots a thread holds
constexpr int kMaxN = kMaxThreads * kMaxSlots;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int wrap_add(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}
__device__ __forceinline__ int wrap_sub(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) - static_cast<unsigned>(b));
}
// The oracle's mod floors (jnp.mod, torch.remainder); C's % truncates.
__device__ __forceinline__ int floor_mod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// Thread (warp w, lane l) holds the slots j = w*32*S + 32*i + l, i < S:
// each row i of a warp is 32 consecutive slots, so the loads coalesce and a
// ballot of one row is in slot order.
template <int S>
__global__ void __launch_bounds__(kMaxThreads)
ring_step_kernel(const int* __restrict__ state_in, const int* __restrict__ cycle_in,
                 const int* __restrict__ meta_in, int* state_out, int* cycle_out,
                 int* meta_out, int* claimed_out, int n, int k, int window,
                 int push_n, int want) {
  extern __shared__ int s_keys[];  // general path: next_pow2(n) keys
  __shared__ int s_min[32], s_count[32], s_before[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int base = warp * 32 * S + lane;
  const int enq = meta_in[0], dc = meta_in[1];
  const int reclaim_below = wrap_sub(dc, window);
  // off_j = (j - enq) mod N on the wrapped difference. Unless enq is within
  // N of INT32_MIN no j - enq wraps, and off_j is j rotated by enq mod N.
  const bool no_wrap = static_cast<long long>(enq) >=
                       static_cast<long long>(n) - 1 - INT_MAX;
  const int e0 = floor_mod(enq, n);
  auto offset = [&](int j) {
    if (no_wrap) {
      const int o = j - e0;
      return o < 0 ? o + n : o;
    }
    return floor_mod(wrap_sub(j, enq), n);
  };

  // Stages R and E's scan: load, reclaim, first blocked offset.
  int cy[S];
  unsigned avail = 0;
  int first_blocked = push_n;
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int j = base + 32 * i;
    cy[i] = 0;
    if (j < n) {
      int st = state_in[j];
      cy[i] = cycle_in[j];
      if (st == kClaimed && cy[i] < reclaim_below) st = kFree;
      const int off = offset(j);
      if (off < push_n && st != kFree) first_blocked = min(first_blocked, off);
      if (st == kAvailable) avail |= 1u << i;
    }
  }
  first_blocked = __reduce_min_sync(kFull, first_blocked);
  if (lane == 0) s_min[warp] = first_blocked;
  __syncthreads();
  const int accepted = __reduce_min_sync(kFull, lane < nwarps ? s_min[lane] : push_n);
  const int enq_new = wrap_add(enq, accepted);
  const int start = floor_mod(enq_new, n);  // slot of the oldest possible cycle

  // Stage E's writes, the claimable set, and the invariant of each
  // claimable slot: cycle c in (enq' - N, enq'] without wrapping, at slot
  // (c - 1) mod N. A cycle of INT32_MAX is never claimable (the oracle's
  // sentinel key).
  unsigned claimable = 0, before_start = 0;
  bool broken = false;
  const int cycle0 = wrap_add(enq, 1);
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int j = base + 32 * i;
    if (j < n) {
      if (offset(j) < accepted) {
        cy[i] = wrap_add(cycle0, offset(j));
        avail |= 1u << i;
      }
      if ((avail >> i & 1u) && cy[i] != INT_MAX) {
        claimable |= 1u << i;
        const unsigned d = static_cast<unsigned>(enq_new) - static_cast<unsigned>(cy[i]);
        bool ok = cy[i] <= enq_new && d < static_cast<unsigned>(n);
        if (ok) {
          const int pos = start - 1 - static_cast<int>(d);  // (c - 1) mod N + 0 or -N
          ok = (pos < 0 ? pos + n : pos) == j;
        }
        broken |= !ok;
      }
      if (j < start) before_start |= 1u << i;
    }
  }
  const int w_count = __reduce_add_sync(kFull, __popc(claimable));
  const int w_before = __reduce_add_sync(kFull, __popc(claimable & before_start));
  if (lane == 0) {
    s_count[warp] = w_count;
    s_before[warp] = w_before;
  }
  broken = __syncthreads_or(broken);

  // Every warp scans the warps' counts itself: no further barrier.
  const int c_lane = lane < nwarps ? s_count[lane] : 0;
  int incl = c_lane;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += up;
  }
  const int total = __shfl_sync(kFull, incl, 31);
  const int warp_prefix = __shfl_sync(kFull, incl - c_lane, warp);
  const int take = min(want, min(k, total));
  unsigned claimed = 0;

  if (!broken) {
    // Fast path: rank = claimable slots before j in ring order from
    // `start` = (prefix(j) - #claimable before start) mod total.
    const int b = __reduce_add_sync(kFull, lane < nwarps ? s_before[lane] : 0);
    const unsigned lt = (1u << lane) - 1u;
    int run = warp_prefix;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const unsigned row = __ballot_sync(kFull, claimable >> i & 1u);
      if (claimable >> i & 1u) {
        int rank = run + __popc(row & lt) - b;
        rank = rank < 0 ? rank + total : rank;
        if (rank < take) {
          claimed |= 1u << i;
          claimed_out[rank] = cy[i];
          if (rank == take - 1) meta_out[1] = max(dc, cy[i]);
        }
      }
      run += __popc(row);
    }
  } else {
    // General path: sort every key (INT32_MAX where not claimable), claim
    // every claimable slot at or below the take-th key, ties included.
    int p2 = 1;
    while (p2 < n) p2 <<= 1;
#pragma unroll
    for (int i = 0; i < S; ++i) {
      const int j = base + 32 * i;
      if (j < n) s_keys[j] = (claimable >> i & 1u) ? cy[i] : INT_MAX;
    }
    for (int j = n + tid; j < p2; j += blockDim.x) s_keys[j] = INT_MAX;
    __syncthreads();
    for (int size = 2; size <= p2; size <<= 1) {
      for (int stride = size >> 1; stride > 0; stride >>= 1) {
        for (int q = tid; q < (p2 >> 1); q += blockDim.x) {
          const int lo = 2 * q - (q & (stride - 1));
          const int hi = lo + stride;
          const int a = s_keys[lo], c = s_keys[hi];
          if ((a > c) == ((lo & size) == 0)) {
            s_keys[lo] = c;
            s_keys[hi] = a;
          }
        }
        __syncthreads();
      }
    }
    if (take > 0) {
      const int threshold = s_keys[take - 1];
#pragma unroll
      for (int i = 0; i < S; ++i)
        if ((claimable >> i & 1u) && cy[i] <= threshold) claimed |= 1u << i;
      for (int r = tid; r < take; r += blockDim.x) claimed_out[r] = s_keys[r];
      if (tid == 0) meta_out[1] = max(dc, threshold);
    }
  }

  // Outputs. A slot's state is re-read (each thread reads only its own
  // slots) rather than held: registers go to the cycles.
#pragma unroll
  for (int i = 0; i < S; ++i) {
    const int j = base + 32 * i;
    if (j < n) {
      int st = state_in[j];
      if (offset(j) < accepted) {
        st = kAvailable;
      } else if (st == kClaimed && cy[i] < reclaim_below) {
        st = kFree;
      }
      state_out[j] = (claimed >> i & 1u) ? kClaimed : st;
      cycle_out[j] = cy[i];
    }
  }
  for (int r = max(take, 0) + tid; r < k; r += blockDim.x) claimed_out[r] = -1;
  if (tid == 0) {
    meta_out[0] = enq_new;
    if (take <= 0) meta_out[1] = dc;
  }
}

// The path is chosen inside the kernel (one __syncthreads_or), so every
// launch reserves the general path's keys, next_pow2(n) ints of dynamic
// shared memory: the CTA is alone on its SM either way. Above the default
// 48 KB (only S = 16, N > 12,288) the kernel's limit is raised to kMaxN
// keys, once a device.
constexpr int kDefaultSmem = 48 * 1024;
constexpr int kMaxDevices = 64;

template <int S>
cudaError_t allow_smem(int smem) {
  if (smem <= kDefaultSmem) return cudaSuccess;
  static bool raised[kMaxDevices] = {};  // racing threads set the same value
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && raised[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(ring_step_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kMaxN * static_cast<int>(sizeof(int)));
  if (err == cudaSuccess && dev < kMaxDevices) raised[dev] = true;
  return err;
}

template <int S>
int launch(const int* state_in, const int* cycle_in, const int* meta_in,
           int* state_out, int* cycle_out, int* meta_out, int* claimed_out,
           int n, int k, int window, int push_n, int want, cudaStream_t stream) {
  int p2 = 1;
  while (p2 < n) p2 <<= 1;
  const int smem = p2 * static_cast<int>(sizeof(int));
  const cudaError_t err = allow_smem<S>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int threads = ((n + S - 1) / S + 31) / 32 * 32;
  ring_step_kernel<S><<<1, threads, smem, stream>>>(
      state_in, cycle_in, meta_in, state_out, cycle_out, meta_out, claimed_out,
      n, k, window, push_n, want);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// grid path: N > kMaxN
// ---------------------------------------------------------------------------

constexpr int kGridThreads = 256;

struct RingArgs {
  int n, enq, dc, window, push_n;
};

__device__ __forceinline__ int grid_offset(const RingArgs& a, int j) {
  return floor_mod(wrap_sub(j, a.enq), a.n);
}

__device__ __forceinline__ int reclaimed_state(const RingArgs& a, int st, int cy) {
  return (st == kClaimed && cy < wrap_sub(a.dc, a.window)) ? kFree : st;
}

__global__ void __launch_bounds__(kGridThreads)
ring_scan_kernel(const int* __restrict__ state_in, const int* __restrict__ cycle_in,
                 const int* __restrict__ meta_in, int n, int window, int push_n,
                 int* __restrict__ blocked) {
  const RingArgs a{n, meta_in[0], meta_in[1], window, push_n};
  const int j = blockIdx.x * kGridThreads + threadIdx.x;
  int first = INT_MAX;
  if (j < n) {
    const int off = grid_offset(a, j);
    if (off < push_n && reclaimed_state(a, state_in[j], cycle_in[j]) != kFree) first = off;
  }
  first = __reduce_min_sync(kFull, first);
  if ((threadIdx.x & 31) == 0 && first != INT_MAX) atomicMin(blocked, first);
}

// Block sum of v (every thread of the CTA calls it).
__device__ __forceinline__ int block_sum(int v, int* s_warp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = __reduce_add_sync(kFull, v);
  if (lane == 0) s_warp[warp] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < kGridThreads / 32; ++w) total += s_warp[w];
  return total;
}

// Grid scratch (int32): [0] blocked offset, [1] broken flag, then the CTAs'
// claimable counts [nb] and their counts before slot enq' mod N [nb].
constexpr int kBlocked = 0, kBroken = 1, kCounts = 2;

__global__ void __launch_bounds__(kGridThreads)
ring_enqueue_kernel(const int* __restrict__ state_in, const int* __restrict__ cycle_in,
                    const int* __restrict__ meta_in, int n, int window, int push_n,
                    int* __restrict__ words, int* __restrict__ mid_state,
                    int* __restrict__ cycle_out, int* __restrict__ meta_out) {
  __shared__ int s_warp[2][kGridThreads / 32];
  const RingArgs a{n, meta_in[0], meta_in[1], window, push_n};
  const int accepted = min(push_n, words[kBlocked]);
  const int enq_new = wrap_add(a.enq, accepted);
  const int start = floor_mod(enq_new, n);  // slot of the oldest possible cycle
  const int j = blockIdx.x * kGridThreads + threadIdx.x;
  if (j == 0) meta_out[0] = enq_new;
  bool claimable = false, broken = false;
  if (j < n) {
    const int off = grid_offset(a, j);
    int cy = cycle_in[j];
    int st = reclaimed_state(a, state_in[j], cy);
    if (off < accepted) {
      st = kAvailable;
      cy = wrap_add(wrap_add(a.enq, 1), off);
    }
    mid_state[j] = st;
    cycle_out[j] = cy;
    // the invariant of a claimable slot: cycle c in (enq' - N, enq'] without
    // wrapping, at slot (c - 1) mod N
    claimable = st == kAvailable && cy != INT_MAX;
    if (claimable) {
      const unsigned d = static_cast<unsigned>(enq_new) - static_cast<unsigned>(cy);
      bool ok = cy <= enq_new && d < static_cast<unsigned>(n);
      if (ok) {
        const int pos = start - 1 - static_cast<int>(d);
        ok = (pos < 0 ? pos + n : pos) == j;
      }
      broken = !ok;
    }
  }
  if (__syncthreads_or(broken) && threadIdx.x == 0) atomicOr(words + kBroken, 1);
  const int count = block_sum(claimable, s_warp[0]);
  const int before = block_sum(claimable && j < start, s_warp[1]);
  if (threadIdx.x == 0) {
    words[kCounts + blockIdx.x] = count;
    words[kCounts + gridDim.x + blockIdx.x] = before;
  }
}

// lanes of ids below n: the claim's valid lanes are a prefix
__device__ __forceinline__ int valid_prefix(const int* ids, int lanes, int n) {
  int lo = 0, hi = lanes;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (ids[mid] < n) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

__global__ void __launch_bounds__(kGridThreads)
ring_publish_kernel(const int* __restrict__ mid_state, const int* __restrict__ cycle_out,
                    const int* __restrict__ meta_in, const int* __restrict__ words,
                    const int* __restrict__ ids, int lanes, int n, int k, int want,
                    int nb, int* __restrict__ state_out, int* __restrict__ meta_out,
                    int* __restrict__ claimed_out) {
  __shared__ int s_take, s_threshold, s_prefix, s_total, s_before;
  __shared__ int s_warp[kGridThreads / 32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.x * kGridThreads + tid;
  const int dc = meta_in[1];
  const bool broken = words[kBroken] != 0;
  const int st = j < n ? mid_state[j] : 0, cy = j < n ? cycle_out[j] : 0;
  const bool claimable = j < n && st == kAvailable && cy != INT_MAX;
  bool claim = false;
  int take;
  if (!broken) {
    // claim by ring position: rank = (claimable slots before j - those before
    // slot enq' mod N) mod total
    if (tid == 0) {
      int prefix = 0, total = 0, before = 0;
      for (int c = 0; c < nb; ++c) {
        const int cnt = words[kCounts + c];
        if (c < blockIdx.x) prefix += cnt;
        total += cnt;
        before += words[kCounts + nb + c];
      }
      s_prefix = prefix;
      s_total = total;
      s_before = before;
    }
    const unsigned row = __ballot_sync(kFull, claimable);
    if (lane == 0) s_warp[warp] = __popc(row);
    __syncthreads();
    int rank = s_prefix + __popc(row & ((1u << lane) - 1u)) - s_before;
    for (int w = 0; w < warp; ++w) rank += s_warp[w];
    rank = rank < 0 ? rank + s_total : rank;
    take = min(want, min(k, s_total));
    if (claimable && rank < take) {
      claim = true;
      claimed_out[rank] = cy;
      if (rank == take - 1) meta_out[1] = max(dc, cy);
    }
  } else {
    if (tid == 0) {
      const int t = lanes > 0 ? valid_prefix(ids, lanes, n) : 0;
      s_take = t;
      s_threshold = t > 0 ? cycle_out[ids[t - 1]] : 0;
    }
    __syncthreads();
    take = s_take;
    claim = take > 0 && claimable && cy <= s_threshold;
    if (j < take) claimed_out[j] = cycle_out[ids[j]];
    if (j == 0 && take > 0) meta_out[1] = max(dc, s_threshold);
  }
  if (j == 0 && take <= 0) meta_out[1] = dc;
  if (j >= max(take, 0) && j < k) claimed_out[j] = -1;
  if (j < n) state_out[j] = claim ? kClaimed : st;
}

}  // namespace

extern "C" int rt_cmp_claim_gated(const void* state, const void* cycle, void* new_state,
                                  void* ids, void* cand, void* counter, int n, int k, int vec,
                                  const void* gate, void* stream);

// Rings of more than rt_cmp_ring_max_n() slots. Scratch from the wrapper:
// mid_state int32 [n]; ids int32 [max(lanes, 1)]; cand int64 [cdiv(n, 512)
// * min(max(lanes, 1), 512)] and counter (a claim counter at 0) as
// rt_cmp_claim takes them; words int32 [2 + 2 * cdiv(n, 256)]. lanes =
// min(k, want) when both are >= 1, else 0 and the claim is not launched
// (three kernels a call, else four). Returns a cudaError_t.
extern "C" int rt_cmp_ring_step_grid(const void* state_in, const void* cycle_in,
                                     const void* meta_in, void* state_out, void* cycle_out,
                                     void* meta_out, void* claimed_out, void* mid_state,
                                     void* ids, void* cand, void* counter, void* words,
                                     int n, int k, int window, int push_n, int want,
                                     int lanes, int vec, void* stream) {
  if (n <= kMaxN || k < 0 || k > n || lanes < 0 || lanes > k)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto si = static_cast<const int*>(state_in);
  auto ci = static_cast<const int*>(cycle_in);
  auto mi = static_cast<const int*>(meta_in);
  auto mid = static_cast<int*>(mid_state);
  auto co = static_cast<int*>(cycle_out);
  auto mo = static_cast<int*>(meta_out);
  auto w = static_cast<int*>(words);
  // 0x7f7f7f7f: above every offset, so an unblocked push keeps push_n
  cudaError_t err = cudaMemsetAsync(w + kBlocked, 0x7f, sizeof(int), st);
  if (err == cudaSuccess) err = cudaMemsetAsync(w + kBroken, 0, sizeof(int), st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = (n + kGridThreads - 1) / kGridThreads;
  ring_scan_kernel<<<grid, kGridThreads, 0, st>>>(si, ci, mi, n, window, push_n, w + kBlocked);
  ring_enqueue_kernel<<<grid, kGridThreads, 0, st>>>(si, ci, mi, n, window, push_n, w, mid,
                                                     co, mo);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (lanes > 0) {
    // runs only if a slot broke the invariant; its new_state lands in
    // state_out and is rewritten below
    const int rc = rt_cmp_claim_gated(mid, co, state_out, ids, cand, counter, n, lanes, vec,
                                      w + kBroken, stream);
    if (rc != 0) return rc;
  }
  const int pgrid = (max(n, k) + kGridThreads - 1) / kGridThreads;
  ring_publish_kernel<<<pgrid, kGridThreads, 0, st>>>(
      mid, co, mi, w, static_cast<const int*>(ids), lanes, n, k, want, grid,
      static_cast<int*>(state_out), mo, static_cast<int*>(claimed_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_cmp_ring_step(const void* state_in, const void* cycle_in,
                                const void* meta_in, void* state_out,
                                void* cycle_out, void* meta_out, void* claimed_out,
                                int n, int k, int window, int push_n, int want,
                                void* stream) {
  if (n <= 0 || n > kMaxN || k < 0 || k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto si = static_cast<const int*>(state_in);
  auto ci = static_cast<const int*>(cycle_in);
  auto mi = static_cast<const int*>(meta_in);
  auto so = static_cast<int*>(state_out);
  auto co = static_cast<int*>(cycle_out);
  auto mo = static_cast<int*>(meta_out);
  auto cl = static_cast<int*>(claimed_out);
  auto st = static_cast<cudaStream_t>(stream);
  // The fewest slots a thread that keeps the CTA at 1,024 threads or less.
  if (n <= kMaxThreads) return launch<1>(si, ci, mi, so, co, mo, cl, n, k, window, push_n, want, st);
  if (n <= 2 * kMaxThreads) return launch<2>(si, ci, mi, so, co, mo, cl, n, k, window, push_n, want, st);
  if (n <= 4 * kMaxThreads) return launch<4>(si, ci, mi, so, co, mo, cl, n, k, window, push_n, want, st);
  if (n <= 8 * kMaxThreads) return launch<8>(si, ci, mi, so, co, mo, cl, n, k, window, push_n, want, st);
  return launch<16>(si, ci, mi, so, co, mo, cl, n, k, window, push_n, want, st);
}

extern "C" int rt_cmp_ring_max_n() { return kMaxN; }

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
