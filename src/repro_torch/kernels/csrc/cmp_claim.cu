// k-way earliest-cycle claim over the CMP slot pool, for Hopper.
//
// Replaces: src/repro/kernels/cmp_claim.py :: _claim_kernel (the single-
// block pallas_call in cmp_claim) and _claim_block_kernel with the XLA
// lexsort merge of _cmp_claim_tiled. Slot j is claimable when state[j] ==
// AVAILABLE and cycle[j] != INT32_MAX; the k claimable slots of smallest
// (cycle, id) go AVAILABLE -> CLAIMED and their ids are written in that
// order; lanes past the claimable slots hold n (also when k > n).
//
// What bounds it: nothing on the card's rates at pool sizes (65,536 slots
// move 0.79 MB, 0.24 us at 3.35 TB/s); a call costs its launches. Design:
// a key is one int64, the cycle in the high word and the id in the low, so
// the (cycle, id) order is one signed compare and no two keys are equal.
//   tiles  one CTA per tile of block_n slots sorts the tile's keys in
//          shared memory (bitonic, padded to a power of two). With one tile
//          it writes ids and new_state itself: one launch. Otherwise it
//          writes its first m = min(k, block_n) keys, a sorted run, as the
//          tile's candidates, and a key that is not claimable becomes a
//          sentinel (high word INT32_MAX) whose low word is its candidate
//          index, so sentinels stay unique and sorted.
//   merge  one thread per candidate counts, run by run, the candidates
//          below its own key (one compare when a run lies wholly below or
//          above it, a binary search otherwise) and stops once the count
//          reaches k. Each of the k smallest keys is within its tile's first
//          m, so for them the count is the global rank. Rank r < k writes
//          ids[r]; ranks are distinct, so the selection needs no atomics.
// Sentinels rank after every claimable key, so they fill the lanes past the
// claimable slots with n, and lanes at or past nb * m are filled directly.
#include <algorithm>
#include <climits>

#include "common.cuh"

namespace {

constexpr int kAvailable = 1, kClaimed = 2;
constexpr int kMaxBlock = 4096;  // keys one CTA sorts: 32 KiB of shared memory
constexpr long long kSentinel = static_cast<long long>(INT_MAX) << 32;  // keys >= it are not claimable

__device__ __forceinline__ long long pack(int hi, unsigned lo) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(hi)) << 32) | lo);
}

__device__ __forceinline__ int key_id(long long key) {
  return static_cast<int>(key & 0xffffffffLL);
}

__global__ void __launch_bounds__(1024)
claim_tiles_kernel(const int* __restrict__ state, const int* __restrict__ cycle,
                   int* __restrict__ new_state, int* __restrict__ ids,
                   long long* __restrict__ cand, int n, int k, int block_n, int p,
                   int m) {
  extern __shared__ long long s_key[];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int base = blockIdx.x * block_n;
  const int len = min(block_n, n - base);
  for (int j = tid; j < p; j += nt) {
    long long key = LLONG_MAX;  // padding to the power of two
    if (j < len) {
      const int g = base + j;
      const int st = state[g];
      new_state[g] = st;
      key = pack(st == kAvailable ? cycle[g] : INT_MAX, static_cast<unsigned>(g));
    }
    s_key[j] = key;
  }
  __syncthreads();
  // Bitonic sort, ascending. Pair (i, i + stride) has bit `stride` clear in i.
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = tid; t < p / 2; t += nt) {
        const int i = ((t & ~(stride - 1)) << 1) | (t & (stride - 1));
        const long long a = s_key[i], b = s_key[i + stride];
        if ((a > b) == ((i & size) == 0)) {
          s_key[i] = b;
          s_key[i + stride] = a;
        }
      }
      __syncthreads();
    }
  }
  if (cand == nullptr) {  // one tile: the sorted keys are the claim
    for (int r = tid; r < k; r += nt) {
      const long long key = r < p ? s_key[r] : LLONG_MAX;
      if (key < kSentinel) {
        ids[r] = key_id(key);
        new_state[key_id(key)] = kClaimed;  // after the copy above: the barrier orders them
      } else {
        ids[r] = n;
      }
    }
    return;
  }
  for (int r = tid; r < m; r += nt) {
    const int c = blockIdx.x * m + r;
    const long long key = s_key[r];
    cand[c] = key < kSentinel ? key : (kSentinel | static_cast<unsigned>(c));
  }
}

__global__ void __launch_bounds__(256)
claim_merge_kernel(const long long* __restrict__ cand, int* __restrict__ new_state,
                   int* __restrict__ ids, int n, int k, int nb, int m) {
  const int total = nb * m;
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c < total) {
    const long long x = cand[c];
    const int own = c / m;
    int rank = c - own * m;  // the keys below x in its own run
    for (int t = 0; t < nb && rank < k; ++t) {
      if (t == own) continue;
      const long long* run = cand + static_cast<long long>(t) * m;
      if (run[0] > x) continue;
      if (run[m - 1] < x) {
        rank += m;
        continue;
      }
      int lo = 1, hi = m - 1;  // run[0] < x < run[m - 1]: count the keys below x
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (run[mid] < x) lo = mid + 1; else hi = mid;
      }
      rank += lo;
    }
    if (rank < k) {
      if (x < kSentinel) {
        ids[rank] = key_id(x);
        new_state[key_id(x)] = kClaimed;
      } else {
        ids[rank] = n;
      }
    }
  }
  for (long long r = static_cast<long long>(total) + c; r < k;
       r += static_cast<long long>(gridDim.x) * blockDim.x) {
    ids[r] = n;
  }
}

int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

}  // namespace

// One launch of the tile kernel. cand == nullptr: n <= block_n, one tile,
// ids and new_state are final. Otherwise cand holds cdiv(n, block_n) *
// min(k, block_n) int64 candidates for rt_cmp_claim_merge, and new_state
// is state until the merge runs.
extern "C" int rt_cmp_claim_tiles(const void* state, const void* cycle, void* new_state,
                                  void* ids, void* cand, int n, int k, int block_n,
                                  void* stream) {
  if (n <= 0 || k <= 0 || block_n <= 0 || std::min(n, block_n) > kMaxBlock ||
      (cand == nullptr && n > block_n)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nb = (n + block_n - 1) / block_n;
  const int p = next_pow2(std::min(n, block_n));
  const int threads = std::min(1024, std::max(32, p / 2));
  claim_tiles_kernel<<<nb, threads, p * sizeof(long long),
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(state), static_cast<const int*>(cycle),
      static_cast<int*>(new_state), static_cast<int*>(ids),
      static_cast<long long*>(cand), n, k, block_n, p, std::min(k, block_n));
  return static_cast<int>(cudaGetLastError());
}

// The merge over nb runs of m candidates: writes ids [k] and the CLAIMED
// states into new_state.
extern "C" int rt_cmp_claim_merge(const void* cand, void* new_state, void* ids, int n,
                                  int k, int nb, int m, void* stream) {
  if (n <= 0 || k <= 0 || nb <= 0 || m <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = 256;
  const int blocks = (nb * m + threads - 1) / threads;
  claim_merge_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(cand), static_cast<int*>(new_state),
      static_cast<int*>(ids), n, k, nb, m);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_cmp_claim_max_block() { return kMaxBlock; }
