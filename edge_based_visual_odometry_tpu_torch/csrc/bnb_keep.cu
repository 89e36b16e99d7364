// The best/nearly-best (BNB) streak filter on Hopper (sm_90a): the stereo
// cascade's stages 6 and 7 and the temporal cascade's BNB step, 4 calls a
// frame.
//
// Replaces no TPU kernel: the JAX package ranks each row by a comparison
// count and moves the slots by one-hot products, XLA ops with no
// pallas_call (edge_based_visual_odometry_tpu/models/stereo_matcher.py::
// _bnb_keep, ops/sortfree.py). The port's plain twin
// (models/stereo_matcher.py::_bnb_keep, the CPU path) sorts each row
// (a stable torch.sort), gathers, divides, compares, takes an int64
// cumprod of the passes and scatters back: ~35 launches a call, 1.60 ms of
// device work over a KITTI frame's 4 calls (32,768 rows x 32 slots
// stereo, 24,576 x 32 temporal), the cumprod alone 0.78 ms.
//
// Contract (the twin's on the card, bit for bit on every slot): key =
// mask ? (higher_better ? -s : s) : 3.4e38; the C slots of a row ordered
// by (key, slot), the key in the order torch.sort gives floats there
// (`radix_bits` of sort_order.cuh: -0.0 as +0.0, NaNs by their bits);
// best = the score at rank 0, live or not; rank 0 passes where it is
// live, a later rank where its ratio >= thresh (a float32 compare), it is
// live and best != 0, ratio = s / best (higher better) or best / s, IEEE
// division; a slot is kept where it is live and every rank up to its own
// passes; a row with fewer than 2 live slots is kept as its mask.
//
// What bounds it: bytes. Each slot's score and mask read once, its mask
// written once: 6 B a slot, 6.3 / 4.7 MB a stereo / temporal call, 1.9 /
// 1.4 us at 3.35 TB/s. Its compares (C shuffles a slot) are not counted.
//
// Design: one warp a row, 8 rows a block; lane l on slot l and, past 32
// slots (H = 2), slot l + 32, so C <= 64. Scores and masks are read
// coalesced; nothing is kept in shared memory or global scratch.
//   1. Each slot's key as radix bits; its rank in (key, slot) order by
//      counting, over the C slots' keys shuffled in turn, those before it.
//      The ranks are a permutation of 0 .. C - 1.
//   2. best: the score of the slot of rank 0 (a ballot, then a shuffle).
//   3. Each slot's pass; the first failing rank is the warp's minimum of
//      the failing slots' ranks (__reduce_min_sync); the live count is a
//      popcount of the mask's ballots.
//   4. A slot is kept where it is live and ranks below the first failing
//      rank, or where the row has fewer than 2 live slots.
// This is the sorted streak whatever the order of the ratios: no slot is
// moved, so nothing is gathered or scattered. Nothing is allocated or
// synchronised here: the wrapper hands in the output, so the launch
// captures into a CUDA graph.

#include <cuda_runtime.h>
#include <math.h>

#include "sort_order.cuh"

namespace {

constexpr int WARPS = 8;                 // rows a block
constexpr int MAX_SLOTS = 64;            // slots a row: two a lane
constexpr unsigned FULL = 0xffffffffu;
constexpr float FILL = 3.4e38f;          // the twin's masked key

// `-s` as PyTorch's neg kernel gives it on the card: the sign flipped,
// and a NaN of any sign or payload as the canonical 0x7fffffff (ptxas
// forms neg.f32 as an FADD, which returns canonical NaNs).
__device__ __forceinline__ float torch_neg(float s) {
  return isnan(s) ? __uint_as_float(0x7fffffffu) : -s;
}

template <int H>
__global__ void __launch_bounds__(WARPS * 32)
bnb_keep_kernel(const float* __restrict__ scores,
                const unsigned char* __restrict__ mask, int N, int C,
                float thresh, int higher_better,
                unsigned char* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= N) return;                  // the whole warp: one row
  const size_t base = (size_t)row * C;

  // 1. each slot's score, mask, key and rank
  float s[H];
  bool in[H], live[H];
  unsigned key[H];
  int rank[H];
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int j = lane + 32 * h;
    in[h] = j < C;
    s[h] = in[h] ? scores[base + j] : 0.0f;
    live[h] = in[h] && mask[base + j] != 0;
    key[h] = sort_order::radix_bits(
        live[h] ? (higher_better ? torch_neg(s[h]) : s[h]) : FILL);
    rank[h] = 0;
  }
#pragma unroll
  for (int g = 0; g < H; ++g) {
    const int n = min(32, C - 32 * g);   // the same in every lane
    for (int t = 0; t < n; ++t) {
      const unsigned kt = __shfl_sync(FULL, key[g], t);
      const int st = 32 * g + t;
#pragma unroll
      for (int h = 0; h < H; ++h)
        rank[h] += kt < key[h] || (kt == key[h] && st < lane + 32 * h);
    }
  }

  // 2. best: the score of the one slot of rank 0
  float best = 0.0f;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const unsigned b = __ballot_sync(FULL, in[h] && rank[h] == 0);
    const float v = __shfl_sync(FULL, s[h], b ? __ffs(b) - 1 : 0);
    if (b) best = v;
  }

  // 3. the first failing rank and the live count
  int first_fail = MAX_SLOTS, n_live = 0;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float ratio = higher_better ? __fdiv_rn(s[h], best)
                                      : __fdiv_rn(best, s[h]);
    const bool ok = rank[h] == 0
                        ? live[h]
                        : ratio >= thresh && live[h] && best != 0.0f;
    if (in[h] && !ok) first_fail = min(first_fail, rank[h]);
    n_live += __popc(__ballot_sync(FULL, live[h]));
  }
  first_fail = __reduce_min_sync(FULL, first_fail);

  // 4. the kept slots
#pragma unroll
  for (int h = 0; h < H; ++h)
    if (in[h])
      out[base + lane + 32 * h] =
          live[h] && (n_live < 2 || rank[h] < first_fail);
}

}  // namespace

// scores (N, C) float32, mask (N, C) bool; out (N, C) bool, the kept
// slots; 1 <= C <= 64, higher_better 0 or 1.
extern "C" int bnb_keep_launch(const float* scores, const unsigned char* mask,
                               int N, int C, float thresh, int higher_better,
                               unsigned char* out, cudaStream_t stream) {
  if (N <= 0 || C <= 0 || C > MAX_SLOTS) return (int)cudaErrorInvalidValue;
  const int blocks = (N + WARPS - 1) / WARPS;
  if (C > 32)
    bnb_keep_kernel<2><<<blocks, WARPS * 32, 0, stream>>>(
        scores, mask, N, C, thresh, higher_better, out);
  else
    bnb_keep_kernel<1><<<blocks, WARPS * 32, 0, stream>>>(
        scores, mask, N, C, thresh, higher_better, out);
  return (int)cudaGetLastError();
}
