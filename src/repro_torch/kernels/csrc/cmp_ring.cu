// Fused CMP admission-ring step for Hopper.
//
// Replaces: src/repro/kernels/cmp_ring.py :: _ring_kernel (the pallas_call
// in cmp_ring_step). One call runs the whole admission step on the card:
//   R  CLAIMED slots with cycle < dc - window return to FREE (paper Alg 4);
//   E  the push_n new items take offsets off_j = (j - enq) mod N and the
//      contiguous FREE prefix of offsets is accepted, cycles enq+1+off;
//   C  up to min(want, k) earliest-cycle AVAILABLE slots are claimed, their
//      cycles written ascending, unfilled lanes -1;
//   P  meta' = [enq + accepted, max(dc, max claimed)].
//
// What bounds it: nothing on the card's rates. The ring is N = 2*claim_block
// int32 words (128 at max_batch 8): a few hundred bytes and ~N^2 integer
// compares, so a call costs one launch plus the host's one read of its
// result. Design: a single CTA stages state and cycle in shared memory
// (N <= kMaxN), finds `accepted` with one shared-memory atomicMin, and
// claims by rank — each AVAILABLE slot counts the keys below it, so the
// claim needs no sort and no serial argmin cascade (the Pallas kernel
// unrolls k argmins). Ranks reproduce the oracle's sort + threshold select
// exactly, ties included. Everything is read before the first barrier, so
// outputs may alias inputs.
#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kFree = 0, kAvailable = 1, kClaimed = 2;
constexpr int kMaxN = 4096;

__global__ void __launch_bounds__(1024)
ring_step_kernel(const int* state_in, const int* cycle_in,
                 const int* meta_in, int* state_out, int* cycle_out,
                 int* meta_out, int* claimed_out, int n, int k, int window,
                 int push_n, int want) {
  __shared__ int s_state[kMaxN];
  __shared__ int s_cycle[kMaxN];
  __shared__ int s_accepted, s_count, s_max_claimed;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int enq = meta_in[0], dc = meta_in[1];
  if (tid == 0) {
    s_accepted = push_n;
    s_count = 0;
    s_max_claimed = dc;
  }
  // Stage R: window reclaim.
  for (int j = tid; j < n; j += nt) {
    int st = state_in[j];
    const int cy = cycle_in[j];
    if (st == kClaimed && cy < dc - window) st = kFree;
    s_state[j] = st;
    s_cycle[j] = cy;
  }
  __syncthreads();
  // Stage E: contiguous FREE prefix of offsets. C's % truncates; the
  // oracle's mod floors, hence the double mod.
  for (int j = tid; j < n; j += nt) {
    const int off = ((j - enq) % n + n) % n;
    if (off < push_n && s_state[j] != kFree) atomicMin(&s_accepted, off);
  }
  __syncthreads();
  const int accepted = s_accepted;
  for (int j = tid; j < n; j += nt) {
    const int off = ((j - enq) % n + n) % n;
    if (off < accepted) {
      s_state[j] = kAvailable;
      s_cycle[j] = enq + 1 + off;
    }
    if (s_state[j] == kAvailable) atomicAdd(&s_count, 1);
  }
  __syncthreads();
  const int take = min(want, min(s_count, k));
  // Stage C: claim by rank. Slot j with key c sits at sorted positions
  // [#keys < c, #keys <= c); it is claimed iff #keys < c is below `take`.
  for (int j = tid; j < n; j += nt) {
    int st = s_state[j];
    if (st == kAvailable) {
      const int key = s_cycle[j];
      int lt = 0, le = 0;
      for (int i = 0; i < n; ++i) {
        if (s_state[i] == kAvailable) {
          const int c = s_cycle[i];
          lt += c < key;
          le += c <= key;
        }
      }
      if (lt < take) {
        st = kClaimed;
        for (int r = lt; r < min(le, take); ++r) claimed_out[r] = key;
        atomicMax(&s_max_claimed, key);
      }
    }
    state_out[j] = st;
    cycle_out[j] = s_cycle[j];
  }
  for (int r = take + tid; r < k; r += nt) claimed_out[r] = -1;
  __syncthreads();
  // Stage P: monotone frontier publish.
  if (tid == 0) {
    meta_out[0] = enq + accepted;
    meta_out[1] = s_max_claimed;
  }
}

}  // namespace

extern "C" int rt_cmp_ring_step(const void* state_in, const void* cycle_in,
                                const void* meta_in, void* state_out,
                                void* cycle_out, void* meta_out, void* claimed_out,
                                int n, int k, int window, int push_n, int want,
                                void* stream) {
  if (n <= 0 || n > kMaxN || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int threads = std::min(1024, ((n + 31) / 32) * 32);
  ring_step_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(state_in), static_cast<const int*>(cycle_in),
      static_cast<const int*>(meta_in), static_cast<int*>(state_out),
      static_cast<int*>(cycle_out), static_cast<int*>(meta_out),
      static_cast<int*>(claimed_out), n, k, window, push_n, want);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_cmp_ring_max_n() { return kMaxN; }

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
