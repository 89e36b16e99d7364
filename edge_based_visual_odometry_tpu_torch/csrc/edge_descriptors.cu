// Edge descriptors on Hopper (sm_90a): kernel K5.
//
// Replaces edge_based_visual_odometry_tpu/ops/descriptors.py:114
// `edge_descriptors_tiled`, the stereo step's descriptors of the left
// edges, the right edges and the final mates. On the TPU it is an XLA
// formulation, not a `pallas_call`: tile-resident gathers of the gradient
// maps, a dense (S, 16) x (b, S, 8) einsum over samples and two norms.
// This kernel computes what it computes, per keypoint (one of the two
// points shifted along an edge's normal):
//   - S <= 256 samples on a grid rotated to theta, each read bilinearly
//     from gx and gy through the atlas tile of the keypoint (tile 40,
//     stride 8: the tile clamp and edge replication of the GN kernels);
//   - per sample the magnitude times the Gaussian weight, the angle
//     relative to theta in orientation bins, ob = (angle mod 2 pi) / 2 pi
//     * 8, and the circular hat's 8 weights max(0, 1 - min(d, 8 - d));
//   - the histogram of 4 x 4 cells x 8 bins: bin (p, o) adds
//     SP[s, p] * T[s, o] over cell p's samples;
//   - L2 normalise, clip, normalise again, scale, round to bf16.
//
// What bounds it on the card: operations. At the stereo step's 180,224
// keypoints it writes 46 MB of bf16 and reads ~15 MB of maps and
// keypoints (~18 us at 3.35 TB/s), against ~4.2 GFLOP counted at the
// nonzero terms of the hats (~63 us at 67 TFLOP/s, twice that without
// FMA). On an H100 SXM it runs at ~6% of that bound; scripts/
// k5_variants.py times the launch with its parts taken out.
//
// Design: one warp per keypoint. Phase 1: lane l takes samples l + 32 k
// and writes their 8 orientation terms T[s, o] to the warp's 8 KB of
// shared memory. Phase 2: lane l owns bins 4 l .. 4 l + 3 (cell l / 2,
// orientations 4 (l % 2) ..) and adds w * T[s, o..o+3] over its cell's
// list of samples (index and weight), T read as one float4. The lists come
// from the wrapper, built from the spatial weight table as computed on the
// card (weights of ~1e-7 where the ideal hat is 0 count), in ascending s,
// padded to the longest list with weight 0: each lane runs the same loop.
// Term j of the 16 lists lies side by side (L, 16), so that a warp's read
// of its lanes' terms is one 64-byte line, not 16 lines.
// Phase 3: the norms are each lane's 4 squares in order, then a butterfly;
// lane l writes its 4 bf16 as one 8-byte store into the (N, 256) output,
// keypoint k < N into row k, columns 0-127, keypoint N + k into row k,
// columns 128-255. No atomics: every sum has one fixed order.
//
// Arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction), NaN-keeping min and max, division by a scalar as a
// multiply by its float32 reciprocal, in the order of the plain twin
// `edge_descriptors_plain`, which sums each bin over the same padded lists
// and the norms in this lane order; atan2f, fmodf and sqrtf are the ones
// PyTorch's kernels call. The keypoints, their cosine and sine and the
// static tables come from the wrapper, computed by PyTorch for both.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

using gn::add;
using gn::mul;
using gn::sub;

constexpr int kWarps = 4;            // keypoints a block, one warp each
constexpr int kMaxSamples = 256;     // 16 x 16 grid
constexpr int kOrient = 8;           // orientation bins
constexpr int kCells = 16;           // 4 x 4 spatial cells
constexpr int kBins = kCells * kOrient;   // 128: 4 bins a lane

struct Params {
  const float* gx;
  const float* gy;
  int H, W;
  const float *kx, *ky, *kt, *ct, *st;   // 2N keypoints [plus | minus]
  int N;
  const float *ii, *jj, *gauss;          // S samples
  int S;
  const int* cell_idx;                   // (L, 16) term j of each cell
  const float* cell_w;                   // (L, 16) its weight
  int L;
  int tile, stride;
  float two_pi, inv_two_pi, clip, scale;
  uint2* out;                            // (N, 256) bf16, 4 a lane
};

// torch.minimum / torch.clamp: a NaN stays NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch.remainder(a, b) for b > 0: fmod, then + b where the signs differ
__device__ __forceinline__ float remainder_pos(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && m < 0.0f) m = add(m, b);
  return m;
}

// the warp's L2 norm of its 4 x 32 bins, clamped below at 1e-7
__device__ __forceinline__ float norm4(const float a[4]) {
  float s = add(add(add(mul(a[0], a[0]), mul(a[1], a[1])), mul(a[2], a[2])),
                mul(a[3], a[3]));
  return max_nan(sqrtf(gn::warp_sum(s)), 1e-7f);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
         | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

__global__ void __launch_bounds__(kWarps * 32)
edge_descriptors_kernel(const Params p) {
  __shared__ __align__(16) float tsm[kWarps][kMaxSamples * kOrient];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int k = blockIdx.x * kWarps + wid;
  if (k >= 2 * p.N) return;           // whole warps only
  float* T = tsm[wid];

  // ---- phase 1: each sample's 8 orientation terms ----
  const float kx = p.kx[k], ky = p.ky[k], kt = p.kt[k];
  const float ct = p.ct[k], st = p.st[k];
  const float ox = gn::tile_origin(kx, p.tile, p.stride, p.W);
  const float oy = gn::tile_origin(ky, p.tile, p.stride, p.H);
  const float t1 = (float)(p.tile - 1);
  for (int s = lane; s < p.S; s += 32) {
    const float ii = __ldg(p.ii + s), jj = __ldg(p.jj + s);
    const float sx = sub(add(kx, mul(ct, ii)), mul(st, jj));
    const float sy = add(add(ky, mul(st, ii)), mul(ct, jj));
    const gn::Tap tap = gn::make_tap(sx, sy, ox, oy, t1, p.H, p.W);
    const float gx = gn::read_global(p.gx, tap);
    const float gy = gn::read_global(p.gy, tap);
    const float mag = mul(sqrtf(add(mul(gx, gx), mul(gy, gy))),
                          __ldg(p.gauss + s));
    const float ang = sub(atan2f(gy, gx), kt);
    const float ob = mul(mul(remainder_pos(ang, p.two_pi), p.inv_two_pi),
                         (float)kOrient);
    float t[kOrient];
#pragma unroll
    for (int o = 0; o < kOrient; ++o) {
      float d = fabsf(sub(ob, (float)o));
      d = min_nan(d, sub((float)kOrient, d));
      t[o] = mul(mag, max_nan(sub(1.0f, d), 0.0f));
    }
    float4* row = reinterpret_cast<float4*>(T + s * kOrient);
    row[0] = make_float4(t[0], t[1], t[2], t[3]);
    row[1] = make_float4(t[4], t[5], t[6], t[7]);
  }
  __syncwarp();

  // ---- phase 2: lane l's 4 bins over its cell's samples ----
  const int cell = lane >> 1, o0 = (lane & 1) * 4;
  float a[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  for (int j = 0; j < p.L; ++j) {
    const int s = __ldg(p.cell_idx + j * kCells + cell);
    const float wj = __ldg(p.cell_w + j * kCells + cell);
    const float4 v = *reinterpret_cast<const float4*>(T + s * kOrient + o0);
    a[0] = add(a[0], mul(wj, v.x));
    a[1] = add(a[1], mul(wj, v.y));
    a[2] = add(a[2], mul(wj, v.z));
    a[3] = add(a[3], mul(wj, v.w));
  }

  // ---- phase 3: normalise, clip, normalise, scale, bf16 ----
  const float n1 = norm4(a);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = min_nan(__fdiv_rn(a[i], n1), p.clip);
  const float n2 = norm4(a);
#pragma unroll
  for (int i = 0; i < 4; ++i) a[i] = mul(__fdiv_rn(a[i], n2), p.scale);
  const int row = k < p.N ? k : k - p.N;
  const int col = (k < p.N ? 0 : kBins) / 4 + lane;   // in 4-bin units
  p.out[(size_t)row * (2 * kBins / 4) + col] =
      make_uint2(pack2(a[0], a[1]), pack2(a[2], a[3]));
}

}  // namespace

extern "C" int edge_descriptors_launch(
    const float* gx, const float* gy, int H, int W, const float* kx,
    const float* ky, const float* kt, const float* ct, const float* st, int N,
    const float* ii, const float* jj, const float* gauss, int S,
    const int* cell_idx, const float* cell_w, int L, int tile, int stride,
    float two_pi, float inv_two_pi, float clip, float scale, void* out,
    cudaStream_t stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (S <= 0 || S > kMaxSamples || L <= 0) return (int)cudaErrorInvalidValue;
  Params p{gx, gy, H, W, kx, ky, kt, ct, st, N, ii, jj, gauss, S,
           cell_idx, cell_w, L, tile, stride, two_pi, inv_two_pi, clip,
           scale, reinterpret_cast<uint2*>(out)};
  const int blocks = (2 * N + kWarps - 1) / kWarps;
  edge_descriptors_kernel<<<blocks, kWarps * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}
