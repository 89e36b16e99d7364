// The cascade's gather-window compaction on Hopper (sm_90a): each row's
// slots ordered by (key, slot), the first W kept.
//
// Replaces no TPU kernel: the JAX package compacts with a stable argsort
// (edge_based_visual_odometry_tpu/ops/grid.py::compact_candidates_attrs).
// The port's plain twin (ops/grid.py::compact_candidates_plain, the CPU
// path) is a stable per-row torch.sort of the keys and three gathers; on
// the card PyTorch pads each row of 129-1,024 keys to 1,024 and
// radix-sorts it in one 32-thread block (radixSortKVInPlace): 1.22 ms a
// KITTI frame for the stereo call (32,768 rows x 160 slots) and the
// temporal call (24,576 x 195).
//
// Contract (the twin's on the card, bit for bit on every output slot):
// key = priority on live slots and 3.0e38 on masked ones (with no
// priority, key = 0 live, 1 masked); the S slots of a row ordered by
// (key, slot), the key in the order cub's radix sort gives floats
// (`radix_bits` of sort_order.cuh: -0.0 as +0.0, NaNs by their bits);
// output position r < W = min(C, S) holds the slot of rank r: its idx,
// its A attribute planes and its mask. So live slots come first by
// priority, then the masked slots in slot order (their idx and
// attributes copied too), wherever no live key is at or past 3.0e38.
//
// What bounds it: bytes. Each slot's mask and priority are read once
// (5 B), each output slot written once from its source slot (idx, the A
// attributes and the mask read and written: 2 (8 + 4 A + 1) B).
//
// Design: one warp a row, 2 rows a block (1 where S is large: each warp
// keeps 8 B a slot and a 256-bin histogram in shared memory). Blocks of
// 2 rows beat blocks of 4 and 8 (rows' costs differ, and a block holds
// its SM until its slowest row ends) and of 1 (too few warps an SM).
//   1. The row in chunks of 32 slots, lane l on slot 32 c + l (coalesced
//      reads of mask and priority). `__ballot_sync` finds the live slots;
//      each writes its radix key and slot to the warp's list at its rank
//      among the live ones in slot order (the ballot's prefix popcount),
//      so the list is in slot order. The ballots also count the live
//      keys below the fill's (`lo`) and those equal to it (`eq`).
//   2. Where more than W live keys lie below the fill (`lo` > W: the
//      temporal call's rows mostly) and the list is longer than
//      `SELECT_PAST`, it is cut to the W that rank first (`keep_lowest`):
//      a radix select of the W-th smallest key, 8 bits a round over a
//      256-bin histogram of the entries still in the running, then the
//      entries below it and the first of its ties in slot order, packed
//      in place. None left out ranks below W. A shorter list is ranked
//      whole: at 2 entries a lane that costs less than the select.
//   3. Each entry e left (lane l takes e = l, l + 32, ...) is ranked by
//      counting the list's entries before it in (key, slot) order: keys
//      <= its own among the entries before e, keys < its own after it
//      (O(L^2 / 32) compares a lane for L entries); then the masked slots
//      whose (fill, slot) come before it. With no priority every live key
//      is equal: rank e.
//   4. A masked slot's rank: the masked slots before it, plus `lo`, plus
//      the live slots keyed exactly at the fill before it (read again
//      only where `eq` > 0). Skipped where `lo` >= W, as it is in every
//      row with at least W live slots below the fill; stopped at the
//      first chunk whose masked slots all rank at or past W.
//   Each slot of rank r < W copies its idx and attributes to position r:
//   the ranks below W are each taken once, so every output slot is
//   written once and no fill pass is needed.
// Nothing is allocated or synchronised here: the wrapper hands in the
// outputs, so the launch captures into a CUDA graph.

#include <cuda_runtime.h>

#include "sort_order.cuh"

namespace {

using sort_order::radix_bits;

constexpr int MAX_WARPS = 2;                 // rows a block
constexpr int MAX_SLOTS = 4096;              // slots a row
constexpr int BINS = 256;                    // keep_lowest's histogram
constexpr int SELECT_PAST = 64;              // live slots: keep_lowest
constexpr int SMEM_BYTES = 48 * 1024;        // no opt-in needed
constexpr unsigned FULL = 0xffffffffu;
constexpr float FILL = 3.0e38f;              // the twin's masked key

struct Args {
  const long long* idx;        // (Q, S)
  const float* attrs;          // (A, Q, S)
  const unsigned char* mask;   // (Q, S)
  const float* priority;       // (Q, S), or null
  int Q, S, A, W;
  long long* idx_out;          // (Q, W)
  float* attrs_out;            // (A, Q, W)
  unsigned char* mask_out;     // (Q, W)
};

// Row `row`'s slot s to output position r.
__device__ __forceinline__ void put(const Args& a, int row, int s, int r,
                                    bool live) {
  const size_t qs = (size_t)a.Q * a.S, qw = (size_t)a.Q * a.W;
  const size_t src = (size_t)row * a.S + s, dst = (size_t)row * a.W + r;
  a.idx_out[dst] = a.idx[src];
  for (int k = 0; k < a.A; ++k)
    a.attrs_out[k * qw + dst] = a.attrs[k * qs + src];
  a.mask_out[dst] = live;
}

// The list's first W entries in (key, slot) order, packed in place at
// its front in slot order; n > W entries. A radix select finds the W-th
// smallest key T and how many of its ties are kept (`want`); the entries
// below T and the first `want` with key T are then every one that ranks
// below W.
__device__ int keep_lowest(unsigned* keys, unsigned* slots, unsigned* hist,
                           int n, int W, int lane) {
  const unsigned lt = (1u << lane) - 1u;
  int want = W;                     // the rank sought among those left
  unsigned prefix = 0u, high = 0u;  // the digits chosen so far
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = lane; b < BINS; b += 32) hist[b] = 0u;
    __syncwarp();
    for (int e = lane; e < n; e += 32) {
      const unsigned k = keys[e];
      if ((k & high) == prefix) atomicAdd(&hist[(k >> shift) & 0xffu], 1u);
    }
    __syncwarp();
    // lane l holds bins 8 l .. 8 l + 7: its sum, scanned over the lanes
    int local = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) local += (int)hist[8 * lane + j];
    int incl = local;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, incl, o);
      if (lane >= o) incl += v;
    }
    const bool mine = incl - local < want && want <= incl;
    const int src = __ffs(__ballot_sync(FULL, mine)) - 1;
    int digit = 0, below = incl - local;
    if (mine) {
      for (int j = 0; j < 8; ++j) {
        const int h = (int)hist[8 * lane + j];
        if (below + h >= want) {
          digit = 8 * lane + j;
          break;
        }
        below += h;
      }
    }
    digit = __shfl_sync(FULL, digit, src);
    want -= __shfl_sync(FULL, below, src);
    prefix |= (unsigned)digit << shift;
    high |= 0xffu << shift;
    __syncwarp();
  }
  int kept = 0, ties = 0;
  for (int c = 0; c < n; c += 32) {
    const int e = c + lane;
    const bool in = e < n;
    const unsigned k = in ? keys[e] : 0u, s = in ? slots[e] : 0u;
    const bool tie = in && k == prefix;
    const unsigned bt = __ballot_sync(FULL, tie);
    const bool keep = in && (k < prefix
                             || (tie && ties + __popc(bt & lt) < want));
    const unsigned bk = __ballot_sync(FULL, keep);
    __syncwarp();               // every lane has read before any writes
    if (keep) {
      const int at = kept + __popc(bk & lt);
      keys[at] = k;
      slots[at] = s;
    }
    kept += __popc(bk);
    ties += __popc(bt);
    __syncwarp();
  }
  return kept;
}

__global__ void __launch_bounds__(MAX_WARPS * 32)
compact_candidates_kernel(Args a) {
  extern __shared__ unsigned smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * (blockDim.x >> 5) + warp;
  if (row >= a.Q) return;
  const unsigned lt = (1u << lane) - 1u;
  const bool has_pri = a.priority != nullptr;
  const unsigned char* m = a.mask + (size_t)row * a.S;
  const float* p = has_pri ? a.priority + (size_t)row * a.S : nullptr;
  const unsigned fill = radix_bits(has_pri ? FILL : 1.0f);
  const unsigned zero = radix_bits(0.0f);    // every live key, no priority
  unsigned* keys = smem + (size_t)warp * (2 * a.S + BINS);
  unsigned* slots = keys + a.S;
  unsigned* hist = slots + a.S;
  const int W = a.W;

  // 1. the live slots, in slot order, and their keys
  int n = 0, lo = 0, eq = 0;
  for (int c = 0; c < a.S; c += 32) {
    const int s = c + lane;
    const bool live = s < a.S && m[s] != 0;
    const unsigned key = live ? (has_pri ? radix_bits(p[s]) : zero) : fill;
    const unsigned b = __ballot_sync(FULL, live);
    if (live && has_pri) {
      const int at = n + __popc(b & lt);
      keys[at] = key;
      slots[at] = s;
    }
    n += __popc(b);
    lo += __popc(__ballot_sync(FULL, live && key < fill));
    eq += __popc(__ballot_sync(FULL, live && key == fill));
  }
  __syncwarp();

  if (has_pri) {
    // 2. the W that rank first, where more live keys lie below the fill
    const int len = lo > W && n > SELECT_PAST
                        ? keep_lowest(keys, slots, hist, n, W, lane) : n;
    // 3. their ranks
    for (int e = lane; e < len; e += 32) {
      const unsigned key = keys[e];
      int r = 0;
#pragma unroll 4
      for (int t = 0; t < e; ++t) r += keys[t] <= key;
#pragma unroll 4
      for (int t = e + 1; t < len; ++t) r += keys[t] < key;
      const int s = (int)slots[e];
      if (key > fill) r += a.S - n;           // every masked slot
      else if (key == fill) r += s - e;       // the masked slots before s
      if (r < W) put(a, row, s, r, true);
    }
  } else {
    // 3. rank = the live slots before it (all keys equal)
    int before = 0;
    for (int c = 0; c < a.S && before < W; c += 32) {
      const int s = c + lane;
      const bool live = s < a.S && m[s] != 0;
      const unsigned b = __ballot_sync(FULL, live);
      const int r = before + __popc(b & lt);
      if (live && r < W) put(a, row, s, r, true);
      before += __popc(b);
    }
  }

  // 4. the masked slots' ranks
  if (lo >= W) return;
  int live_before = 0, eq_before = 0;
  for (int c = 0; c < a.S; c += 32) {
    const int s = c + lane;
    const bool in = s < a.S;
    const bool live = in && m[s] != 0;
    const bool at_fill = eq > 0 && live && has_pri
                         && radix_bits(p[s]) == fill;
    const unsigned b = __ballot_sync(FULL, live);
    const unsigned be = __ballot_sync(FULL, at_fill);
    if (in && !live) {
      const int r = (s - live_before - __popc(b & lt)) + lo + eq_before
                    + __popc(be & lt);
      if (r < W) put(a, row, s, r, false);
    }
    live_before += __popc(b);
    eq_before += __popc(be);
    // the next chunk's masked slots rank at least this
    if (c + 32 - live_before + lo >= W) break;
  }
}

}  // namespace

// idx (Q, S) int64, attrs (A, Q, S) float32, mask (Q, S) bool, priority
// (Q, S) float32 or null; outputs idx (Q, W) int64, attrs (A, Q, W)
// float32, mask (Q, W) bool, W = min(capacity, S) >= 1, S <= 4,096.
extern "C" int compact_candidates_launch(
    const long long* idx, const float* attrs, const unsigned char* mask,
    const float* priority, int Q, int S, int A, int W, long long* idx_out,
    float* attrs_out, unsigned char* mask_out, cudaStream_t stream) {
  if (Q <= 0 || S <= 0 || S > MAX_SLOTS || A < 0 || W <= 0 || W > S)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.idx = idx;
  a.attrs = attrs;
  a.mask = mask;
  a.priority = priority;
  a.Q = Q;
  a.S = S;
  a.A = A;
  a.W = W;
  a.idx_out = idx_out;
  a.attrs_out = attrs_out;
  a.mask_out = mask_out;
  const int per_warp = priority ? 4 * (2 * S + BINS) : 0;
  int warps = per_warp ? SMEM_BYTES / per_warp : MAX_WARPS;
  warps = warps < 1 ? 1 : (warps > MAX_WARPS ? MAX_WARPS : warps);
  const int blocks = (Q + warps - 1) / warps;
  compact_candidates_kernel<<<blocks, warps * 32, (size_t)warps * per_warp,
                              stream>>>(a);
  return (int)cudaGetLastError();
}
