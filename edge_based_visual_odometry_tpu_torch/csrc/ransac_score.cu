// RANSAC hypothesis scoring on Hopper (sm_90a): kernel K8.
//
// Replaces edge_based_visual_odometry_tpu/models/motion_tracker.py:240
// `make_score` / `score_all` of `estimate_pose`: on the TPU a `lax.map`
// over chunks of 256 hypotheses, each chunk an XLA einsum that forms the
// (256, Q, 3) projections, not a `pallas_call`. This kernel computes, for
// each hypothesis h (row h of KG = K R_h and Kt = K t_h, or row index[h]
// where the caller passes the kept hypotheses' indices), the number of
// quads q with valid[q], depth uvw_2 > 1e-6 and reprojection error below
// the threshold:
//   uvw_i = ((KG_i0 g0 + KG_i1 g1) + KG_i2 g2) + Kt_i     (i = 0, 1, 2)
//   u = uvw_0 / uvw_2, v = uvw_1 / uvw_2                   (IEEE divisions)
//   err = sqrt((u - cf_0)^2 + (v - cf_1)^2)
// and writes -1 for a hypothesis whose gate is false. The twin
// `ransac_counts_plain` (ops/pose.py) does each step as one elementwise
// torch op in this order, so each pair's decision is the same bit for bit.
//
// What bounds it on the card: operations. 26 float ops a pair of a gated
// hypothesis and a valid quad (18 for the projection, 2 divisions, 2
// subtractions, 2 squares, an add and a square root); at `VOConfig()`'s
// 5,000 hypotheses x 4,096 prescore quads that is up to 0.53 G ops, and
// the inputs are under 1 MB.
//
// Design: a block of 64 threads owns 64 consecutive hypotheses and one
// tile of 256 quads (the grid's y walks the tiles). The tile's gamma, cf
// and valid are staged in shared memory once and read by every thread as
// a broadcast. The block's gated-in hypotheses are compacted to its first
// threads, each holding its 12 floats in registers, so gated-out
// hypotheses do no work and a warp with none skips the loop; an invalid
// quad is skipped by a branch that is the same on every thread. A
// thread's count over the tile joins the hypothesis's total with one
// integer atomicAdd (counts are integers: the order cannot change them);
// the output is zeroed by a memset on the stream before the launch, and
// the blocks of tile 0 write the -1s.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

constexpr int kHyp = 64;          // hypotheses a block, one a thread
constexpr int kTile = 256;        // quads a block stages at a time
constexpr int kMaxTilesY = 65535; // grid y; further tiles are strided

using gn::add;
using gn::mul;
using gn::sub;

__global__ void __launch_bounds__(kHyp)
ransac_score_kernel(const float* __restrict__ KG, const float* __restrict__ Kt,
                    const unsigned char* __restrict__ gate,
                    const long long* __restrict__ index, int n,
                    const float* __restrict__ gamma,
                    const float* __restrict__ cf,
                    const unsigned char* __restrict__ valid, int Q, float thr,
                    float zmin, int* __restrict__ out) {
  __shared__ float s_g[3 * kTile];
  __shared__ float s_c[2 * kTile];
  __shared__ unsigned char s_v[kTile];
  __shared__ int s_hyp[kHyp];
  __shared__ int s_warp[kHyp / 32];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x * kHyp + tid;
  long long row = h;
  bool on = h < n;
  if (on && index != nullptr) row = index[h];
  if (on && gate != nullptr) on = gate[row] != 0;
  if (h < n && !on && blockIdx.y == 0) out[h] = -1;

  // compact the block's gated-in hypotheses to its first threads
  const unsigned m = __ballot_sync(0xffffffffu, on);
  if (lane == 0) s_warp[warp] = __popc(m);
  __syncthreads();
  int base = 0;
  for (int w = 0; w < warp; ++w) base += s_warp[w];
  int n_on = 0;
  for (int w = 0; w < kHyp / 32; ++w) n_on += s_warp[w];
  if (on) s_hyp[base + __popc(m & ((1u << lane) - 1u))] = h;
  __syncthreads();
  if (n_on == 0) return;

  const bool mine = tid < n_on;
  int my_h = 0;
  float k[9], t[3];
  if (mine) {
    my_h = s_hyp[tid];
    const long long r = index != nullptr ? index[my_h] : my_h;
#pragma unroll
    for (int i = 0; i < 9; ++i) k[i] = KG[9 * r + i];
#pragma unroll
    for (int i = 0; i < 3; ++i) t[i] = Kt[3 * r + i];
  }

  const int n_tiles = (Q + kTile - 1) / kTile;
  for (int tile = blockIdx.y; tile < n_tiles; tile += gridDim.y) {
    const int q0 = tile * kTile;
    const int nq = min(kTile, Q - q0);
    __syncthreads();
    for (int i = tid; i < 3 * nq; i += kHyp) s_g[i] = gamma[3 * q0 + i];
    for (int i = tid; i < 2 * nq; i += kHyp) s_c[i] = cf[2 * q0 + i];
    for (int i = tid; i < nq; i += kHyp) s_v[i] = valid[q0 + i];
    __syncthreads();
    if (!mine) continue;
    int cnt = 0;
    for (int j = 0; j < nq; ++j) {
      if (!s_v[j]) continue;
      const float g0 = s_g[3 * j], g1 = s_g[3 * j + 1], g2 = s_g[3 * j + 2];
      const float x = add(add(add(mul(k[0], g0), mul(k[1], g1)), mul(k[2], g2)), t[0]);
      const float y = add(add(add(mul(k[3], g0), mul(k[4], g1)), mul(k[5], g2)), t[1]);
      const float w = add(add(add(mul(k[6], g0), mul(k[7], g1)), mul(k[8], g2)), t[2]);
      const float du = sub(__fdiv_rn(x, w), s_c[2 * j]);
      const float dv = sub(__fdiv_rn(y, w), s_c[2 * j + 1]);
      const float err = __fsqrt_rn(add(mul(du, du), mul(dv, dv)));
      cnt += (err < thr) & (w > zmin);
    }
    if (cnt) atomicAdd(out + my_h, cnt);
  }
}

}  // namespace

// KG (K, 3, 3), Kt (K, 3) float32; gate (K,) bool or null; index (n,)
// int64 rows of KG or null (then n = K); gamma (Q, 3), cf (Q, 2) float32,
// valid (Q,) bool; out (n,) int32.
extern "C" int ransac_score_launch(const float* KG, const float* Kt,
                                   const unsigned char* gate,
                                   const long long* index, int n,
                                   const float* gamma, const float* cf,
                                   const unsigned char* valid, int Q,
                                   float thr, float zmin, int* out,
                                   cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  cudaError_t e = cudaMemsetAsync(out, 0, sizeof(int) * (size_t)n, stream);
  if (e != cudaSuccess) return (int)e;
  const int n_tiles = Q > 0 ? (Q + kTile - 1) / kTile : 1;
  dim3 grid((n + kHyp - 1) / kHyp, n_tiles < kMaxTilesY ? n_tiles : kMaxTilesY);
  ransac_score_kernel<<<grid, kHyp, 0, stream>>>(KG, Kt, gate, index, n,
                                                 gamma, cf, valid, Q, thr,
                                                 zmin, out);
  return (int)cudaGetLastError();
}
