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
// the (B, 2) ok flags.
//
// What bounds it on the card: bytes. A stereo step's four calls (221,184
// edges) write 87 MB of patches and read ~2.7 MB of edges and the two
// images (~27 us at 3.35 TB/s), against ~0.8 GFLOP (~12 us at 67
// TFLOP/s) (chip_smoke.py `k7_work`).
//
// Design: one warp an edge, the 2 P^2 <= 128 samples spread over its lanes
// as K2 spreads them (sample s = lane + 32 k, k < 4, gn_common.cuh; the
// slots carry no branches), so a row of the output is written by
// consecutive lanes; the image is read
// through the read-only cache (a warp's samples lie in one 32 x 32 tile);
// the ok flags are two warp ballots. No shared memory, no atomics.
//
// Arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction), NaN-keeping clamps and the twin's operation order
// (`edge_patches_plain`: `orthogonal_shifted_points`,
// `rotated_patch_coords`, `sample_tile_clamped`); sinf and cosf are the
// functions torch.sin and torch.cos call on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

using gn::mul;

constexpr int kWarps = 8;            // edges a block, one warp each

__global__ void __launch_bounds__(kWarps * 32)
edge_patches_kernel(const float* __restrict__ img, int H, int W,
                    const float* __restrict__ x, const float* __restrict__ y,
                    const float* __restrict__ theta, int B, int P,
                    float shift, int tile, int stride,
                    float* __restrict__ out, uint8_t* __restrict__ ok) {
  const int lane = threadIdx.x & 31;
  const int e = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (e >= B) return;                // whole warps only
  const gn::Slots sl = gn::make_slots(lane, P);
  const float th = __ldg(theta + e);
  const float st = sinf(th), ct = cosf(th);
  const gn::Rotated r = gn::rotate(sl, ct, st);
  const float ex = __ldg(x + e), ey = __ldg(y + e);
  // plus = (x + m sin t, y - m cos t): y + (-(m cos t)) is y - m cos t
  const float nsx = mul(shift, st), nsy = -mul(shift, ct);
  const float ox = gn::tile_origin(ex, tile, stride, W);
  const float oy = gn::tile_origin(ey, tile, stride, H);
  const float t1 = (float)(tile - 1);
  const float xmax = (float)(W - 1), ymax = (float)(H - 1);
  float* row = out + (size_t)e * 2 * P * P;
  bool bad_p = false, bad_m = false;
#pragma unroll
  for (int k = 0; k < gn::NS; ++k) {
    // a slot past the 2 P^2 samples computes sample 0 and keeps nothing
    float px, py;
    gn::slot_xy(sl, r, k, ex, ey, nsx, nsy, &px, &py);
    const float v =
        gn::read_global(img, gn::make_tap(px, py, ox, oy, t1, H, W));
    const bool out_ = !(floorf(px) >= 0.0f && floorf(py) >= 0.0f
                        && ceilf(px) <= xmax && ceilf(py) <= ymax);
    if (sl.has[k]) row[lane + 32 * k] = v;
    bad_p = bad_p || (sl.has[k] && out_ && sl.sgn[k] > 0);
    bad_m = bad_m || (sl.has[k] && out_ && sl.sgn[k] < 0);
  }
  const unsigned any_p = __ballot_sync(0xffffffffu, bad_p);
  const unsigned any_m = __ballot_sync(0xffffffffu, bad_m);
  if (lane < 2) ok[2 * (size_t)e + lane] = (lane ? any_m : any_p) == 0u;
}

}  // namespace

extern "C" int edge_patches_launch(const float* img, int H, int W,
                                   const float* x, const float* y,
                                   const float* theta, int B, int P,
                                   float shift, int tile, int stride,
                                   float* out, uint8_t* ok,
                                   cudaStream_t stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (P <= 0 || 2 * P * P > 32 * gn::NS || H <= 0 || W <= 0)
    return (int)cudaErrorInvalidValue;
  edge_patches_kernel<<<(B + kWarps - 1) / kWarps, kWarps * 32, 0, stream>>>(
      img, H, W, x, y, theta, B, P, shift, tile, stride, out, ok);
  return (int)cudaGetLastError();
}
