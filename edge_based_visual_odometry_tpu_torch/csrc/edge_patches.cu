// Two-side rotated edge patches on Hopper (sm_90a): kernel K7.
//
// Replaces edge_based_visual_odometry_tpu/ops/patches.py:125
// `edge_patches_tiled`, which the stereo step calls four times: the left
// edges, the right edges, the post-cluster centres of stage 11 and the
// final mates (whose patches the temporal step reads). On the TPU it is
// an XLA formulation, not a `pallas_call`: one slice-gathered atlas tile a
// chunk of edges, then hat-weight contractions. This kernel computes what
// it computes, per edge (x, y, theta):
//   - the two points shifted +-m along the edge's normal, (x + m sin t,
//     y - m cos t) and (x - m sin t, y + m cos t);
//   - around each, the P x P grid rotated to theta, (c + cos t i - sin t j,
//     c' + sin t i + cos t j), i outer, j inner;
//   - each sample bilinear in the atlas tile picked by the edge (tile 32,
//     stride 8: clamped to the tile, edge-replicated beyond the image; the
//     column weights first, then the row weights), a NaN position reading
//     index 0 with its NaN weights;
//   - a side's ok flag: every sample's floor and ceil inside the image.
// Output: row e of the (B, 2 P^2) float32 patches [plus | minus] and of
// the (B, 2) ok flags. With a `live` mask (B,) (stage 11's flat list,
// whose live entries are a prefix), a dead edge is neither sampled nor
// written: its rows hold whatever the buffer held.
//
// What bounds it on the card: bytes. A stereo step's four calls write
// their live edges' patches and read the edges and the two images
// (chip_smoke.py `k7_work`, over the live entries of stage 11's call).
//
// Design: a block takes kEdges edges. First one thread an edge forms the
// edge's terms once (sinf, cosf, the two shifted centres, the tile
// origins) into shared memory, beside a table of the 2 P^2 samples'
// offsets (up to 242, P = 11); a block whose edges are all dead returns
// there. Then the
// block's threads sweep its kEdges x 2 P^2 contiguous output floats, two
// samples of one edge a thread a step (one 8-byte store; the edge's
// terms read once for both): no idle slot, coalesced stores, and a
// thread keeps several independent gathers in flight. The image is read
// through the read-only cache. A sample outside the image sets its side's
// bit of the edge's flag word (a shared atomicOr, rare); the flags are
// written once the sweep is done. (The first form, one warp an edge,
// computed each edge's terms on all 32 lanes and kept 30 of its 128
// sample slots idle: PERF.md.)
//
// Arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction), NaN-keeping clamps and the twin's operation order
// (`edge_patches_plain`: `orthogonal_shifted_points`,
// `rotated_patch_coords`, `sample_tile_clamped`); sinf and cosf are the
// functions torch.sin and torch.cos call on the card, and a term formed
// once has the bits it had when every lane formed it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

using gn::add;
using gn::mul;
using gn::sub;

constexpr int kThreads = 256;
constexpr int kEdges = 32;           // edges a block
constexpr int kMaxSamples = 242;     // 2 P^2, odd P <= 11

// an edge's terms, formed once
struct EdgeTerms {
  float ct, st;                      // cos t, sin t
  float cxp, cyp, cxm, cym;          // the plus and minus centres
  float ox, oy;                      // the atlas tile's origin
};

__global__ void __launch_bounds__(kThreads)
edge_patches_kernel(const float* __restrict__ img, int H, int W,
                    const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ theta,
                    const uint8_t* __restrict__ live, int B, int P,
                    float shift, int tile, int stride,
                    float* __restrict__ out, uint8_t* __restrict__ ok) {
  __shared__ EdgeTerms edge[kEdges];
  __shared__ float off_i[kMaxSamples], off_j[kMaxSamples];
  __shared__ bool plus_side[kMaxSamples];
  __shared__ unsigned bad[kEdges];   // bit 0 plus, bit 1 minus
  __shared__ bool alive[kEdges];
  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * kEdges;
  const int pp = P * P, n2 = 2 * pp, half = P / 2;
  if (tid < kEdges) {
    const int e = e0 + tid;
    const bool on = e < B && (live == nullptr || live[e] != 0);
    alive[tid] = on;
    bad[tid] = 0u;
    if (on) {
      const float th = __ldg(theta + e);
      const float st = sinf(th), ct = cosf(th);
      const float ex = __ldg(x + e), ey = __ldg(y + e);
      // plus = (x + m sin t, y - m cos t): y + (-(m cos t)) is y - m cos t
      const float nsx = mul(shift, st), nsy = -mul(shift, ct);
      EdgeTerms t;
      t.ct = ct;
      t.st = st;
      t.cxp = add(ex, nsx);
      t.cyp = add(ey, nsy);
      t.cxm = sub(ex, nsx);
      t.cym = sub(ey, nsy);
      t.ox = gn::tile_origin(ex, tile, stride, W);
      t.oy = gn::tile_origin(ey, tile, stride, H);
      edge[tid] = t;
    }
  }
  // the samples' offsets (i, j) and sides, as gn::make_slots forms them
  for (int s = tid; s < n2; s += kThreads) {
    const int q = s < pp ? s : s - pp;
    off_i[s] = (float)(q / P - half);
    off_j[s] = (float)(q % P - half);
    plus_side[s] = s < pp;
  }
  const bool any_alive = __syncthreads_or(tid < kEdges && alive[tid]);
  if (!any_alive) return;            // every edge of the block is dead
  const float t1 = (float)(tile - 1);
  const float xmax = (float)(W - 1), ymax = (float)(H - 1);
  const int n_edges = min(kEdges, B - e0);
  // thread tid takes sample pairs tid, tid + kThreads, ... of the
  // block's contiguous rows (2 P^2 is even, so a pair lies in one row);
  // (e, q), the pair's row and its first sample's half-index, follow
  // that index without a division a step
  const int total = n_edges * pp;
  int e = tid / pp, q = tid - e * pp;
  const int step_e = kThreads / pp, step_q = kThreads - step_e * pp;
  float2* const base = reinterpret_cast<float2*>(out + (size_t)e0 * n2);
#pragma unroll 2
  for (int f = tid; f < total; f += kThreads) {
    if (alive[e]) {
      const EdgeTerms t = edge[e];
      float v[2];
      unsigned flags = 0u;
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int s = 2 * q + k;
        const float oi = off_i[s], oj = off_j[s];
        const bool plus = plus_side[s];
        // gn::slot_xy over gn::rotate's terms
        const float cx = plus ? t.cxp : t.cxm;
        const float cy = plus ? t.cyp : t.cym;
        const float px = sub(add(cx, mul(t.ct, oi)), mul(t.st, oj));
        const float py = add(add(cy, mul(t.st, oi)), mul(t.ct, oj));
        v[k] = gn::read_global(img,
                               gn::make_tap(px, py, t.ox, t.oy, t1, H, W));
        // floor(p) >= 0 and ceil(p) <= n - 1 (an integer) hold exactly
        // where p >= 0 and p <= n - 1, and neither for a NaN
        if (!(px >= 0.0f && py >= 0.0f && px <= xmax && py <= ymax))
          flags |= plus ? 1u : 2u;
      }
      base[f] = make_float2(v[0], v[1]);
      if (flags) atomicOr(&bad[e], flags);
    }
    q += step_q;
    e += step_e;
    if (q >= pp) {
      q -= pp;
      ++e;
    }
  }
  __syncthreads();
  if (tid < 2 * n_edges) {
    const int k = tid >> 1, side = tid & 1;
    if (alive[k])
      ok[2 * (size_t)(e0 + k) + side] = ((bad[k] >> side) & 1u) == 0u;
  }
}

}  // namespace

extern "C" int edge_patches_launch(const float* img, int H, int W,
                                   const float* x, const float* y,
                                   const float* theta, const uint8_t* live,
                                   int B, int P, float shift, int tile,
                                   int stride, float* out, uint8_t* ok,
                                   cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (P <= 0 || P % 2 == 0 || 2 * P * P > kMaxSamples || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  edge_patches_kernel<<<(B + kEdges - 1) / kEdges, kThreads, 0, stream>>>(
      img, H, W, x, y, theta, live, B, P, shift, tile, stride, out, ok);
  return (int)cudaGetLastError();
}

// What the built kernel is on this card: out[0..4] = edges a block,
// registers a thread, local (spill) bytes a thread, static shared bytes a
// block, blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int edge_patches_info(int* out) {
  cudaFuncAttributes a{};
  cudaError_t err = cudaFuncGetAttributes(&a, edge_patches_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, edge_patches_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = kEdges;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = per_sm;
  return 0;
}
