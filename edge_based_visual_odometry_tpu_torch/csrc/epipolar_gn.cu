// 1-DoF epipolar photometric Gauss-Newton on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `refine_along_epipolar_pallas` (body
// `_gn_kernel`) of edge_based_visual_odometry_tpu/ops/gn_pallas.py, which
// computes what ops/gauss_newton.py::refine_along_epipolar_batch computes
// per stereo candidate: two rotated P x P side patches (7 x 7 by
// default) at +-(P/2 + 1) along
// the left-edge normal, sampled bilinearly from the right image and its
// gx/gy and mean-centred, against the centred left patches; Huber weights
// (delta = huber); gradient term -gx*dx + gy*dy; a scalar normal
// equation; at most max_iter iterations, stopping at |step| < tol.
//
// What bounds it on the card: instruction issue and latency, not bytes.
// The work is ~7 kflop per candidate-iteration against ~51 bytes of lane
// data, but each iteration is ~600 warp instructions (4 sample slots of
// coordinates, tile clamp, bilinear taps of 3 maps, residual and Huber
// weight, then 5 butterfly reductions), while the three 376 x 1241 maps
// (5.6 MB) stay in L2 and the samples of an iteration mostly hit L1.
//
// Design: one warp per candidate. The 2 P^2 samples (98 at P = 7) are
// spread over the 32 lanes, NS slots each (gn_common.cuh `slots_for`: 4
// up to P = 7, 6 at P = 9, 8 at P = 11; the kernel is compiled for each
// NS, and the P <= 7 instance is the kernel as it was before P = 9 and
// 11 were taken); the two patch means and H, b, cost are warp-shuffle
// butterfly reductions, so every lane holds the same scalar state and the
// warp leaves its loop as soon as its candidate converges - no lane waits
// for another candidate. The NS sample slots carry no branches (a lane
// past the samples recomputes sample 0 and adds nothing), so their loads
// overlap. Each map sample is 4 16-byte `__ldg` gathers of interleaved
// {right, gx, gy, -} pixels (the first version: 12 4-byte gathers of
// three planar maps), which mostly hit L1: a candidate's samples stay in
// one tile.
// Copying each candidate's tile rows into shared memory first (16-byte
// `cp.async`, a band of 23 of the 33 rows, 12 KB per warp) was measured
// slower in every form - one 20-iteration launch, phase 1 and phase 2 -
// and was taken out: the copy costs ~12 KB of L2 traffic per candidate,
// and the loop it spares is bound by issue, not by its loads.
// The left patches are sampled once per candidate with direct gathers
// from the 32 x 32 tile around the left edge. The kernel runs iterations
// [it0, it_stop) from per-lane alpha0/active, so `_two_phase` in
// ops/gauss_newton.py launches it twice with the reference's semantics.
// The sampling and summing helpers it shares with the 2-DoF kernel
// (gn_2dof.cu) are in gn_common.cuh.
//
// Arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction) in the order of the plain twin `refine_along_epipolar_plain`
// (which sums in this kernel's lane order), so the two agree bit for bit
// and a GN lane that needs all iterations cannot drift apart by rounding.

#include <cuda_runtime.h>
#include <math.h>

#include "gn_common.cuh"

namespace {

using namespace gn;

constexpr int WARPS = 8;       // candidates per block

template <int NS>
__global__ void __launch_bounds__(WARPS * 32)
epipolar_gn_kernel(const float* __restrict__ left,
                   const float4* __restrict__ maps4, int H, int W,
                   const float* __restrict__ lx_, const float* __restrict__ ly_,
                   const float* __restrict__ lt_, const float* __restrict__ rx_,
                   const float* __restrict__ ry_,
                   const float* __restrict__ epi_dir,
                   const float* __restrict__ alpha0,
                   const bool* __restrict__ active, int B, int it0,
                   int it_stop, int max_iter, int P, int tile, int stride,
                   float tol, float huber,
                   float* __restrict__ out_alpha,
                   float* __restrict__ out_score, float* __restrict__ out_conf,
                   bool* __restrict__ out_valid, int* __restrict__ out_iters,
                   bool* __restrict__ out_done) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cand = blockIdx.x * (blockDim.x >> 5) + warp;
  if (cand >= B) return;

  float alpha = alpha0[cand];
  if (!active[cand]) {
    if (lane == 0) {
      out_alpha[cand] = alpha;
      out_score[cand] = 1e6f;
      out_conf[cand] = 0.0f;
      out_valid[cand] = false;
      out_iters[cand] = 0;
      out_done[cand] = true;
    }
    return;
  }

  const int pp = P * P;
  const int n_samples = 2 * pp;
  const float side = P / 2.0f + 1.0f;
  const float inv_pp = 1.0f / pp, inv_n = 1.0f / n_samples;
  const float inv_huber = 1.0f / huber;
  const float lx = lx_[cand], ly = ly_[cand], lt = lt_[cand];
  const float rx = rx_[cand], ry = ry_[cand];
  const float dx = epi_dir[2 * cand], dy = epi_dir[2 * cand + 1];
  const float ct = cosf(lt), st = sinf(lt);
  const float nsx = mul(-st, side), nsy = mul(ct, side);   // normal * side

  const float ox = tile_origin(rx, tile, stride, W);
  const float oy = tile_origin(ry, tile, stride, H);
  const float t1 = tile - 1.0f;
  const Slots<NS> sl = make_slots<NS>(lane, P);
  const Rotated<NS> rot = rotate(sl, ct, st);
  float lc[NS];     // centred left patches (sampled once)
  centred_patches(left, H, W, lx, ly, nsx, nsy, sl, rot, inv_pp, lc);

  float score = 1e6f, conf = 0.0f;
  bool valid = false, done = false;
  int iters = 0;
  for (int it = it0; it < it_stop && !done; ++it) {
    const float bx = add(rx, mul(alpha, dx)), by = add(ry, mul(alpha, dy));
    float rv[NS], gx[NS], gy[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      float px, py;
      slot_xy(sl, rot, k, bx, by, nsx, nsy, &px, &py);
      read3(maps4, make_tap(px, py, ox, oy, t1, H, W), &rv[k], &gx[k],
            &gy[k]);
    }
    float mp, mm;
    half_means(sl, rv, inv_pp, &mp, &mm);
    float Hh = 0.0f, bb = 0.0f, cost = 0.0f;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float r = sub(lc[k], sub(rv[k], sl.sgn[k] > 0 ? mp : mm));
      const float g = add(mul(-gx[k], dx), mul(gy[k], dy));
      const float ar = fabsf(r);
      const float w = ar <= huber ? 1.0f : mul(__frcp_rn(ar), huber);
      Hh = sl.has[k] ? add(Hh, mul(mul(w, g), g)) : Hh;
      bb = sl.has[k] ? add(bb, mul(mul(w, g), r)) : bb;
      cost = sl.has[k] ? add(cost, mul(mul(w, r), r)) : cost;
    }
    Hh = warp_sum(Hh);
    bb = warp_sum(bb);
    cost = warp_sum(cost);

    const bool degenerate = Hh < 1e-8f;
    const float delta = degenerate ? 0.0f : __fdiv_rn(-bb, fmaxf(Hh, 1e-8f));
    const float rms = __fsqrt_rn(mul(cost, inv_n));
    const bool converged = fabsf(delta) < tol || it == max_iter - 1;
    if (converged && !degenerate) {
      score = rms;
      conf = expf(mul(-rms, inv_huber));
      valid = !(rms > huber * 2.0f || it < 1);
    }
    if (!degenerate) alpha = add(alpha, delta);
    iters = it + 1;
    done = converged || degenerate;
  }
  if (lane == 0) {
    out_alpha[cand] = alpha;
    out_score[cand] = score;
    out_conf[cand] = conf;
    out_valid[cand] = valid;
    out_iters[cand] = iters;
    out_done[cand] = done;
  }
}

}  // namespace

// maps4: the (H, W) interleaved {right, gx, gy, any} copy of the right
// maps (16-byte pixels).
extern "C" int refine_along_epipolar_launch(
    const float* left, const float* maps4, int H, int W, const float* lx,
    const float* ly, const float* lt, const float* rx, const float* ry,
    const float* epi_dir, const float* alpha0, const bool* active, int B,
    int it0, int it_stop, int max_iter, int patch_size, int tile, int stride,
    float tol, float huber, float* alpha, float* score, float* conf,
    bool* valid, int* iters, bool* done, cudaStream_t stream) {
  // odd patch sizes up to 11, each on the slots it needs
  decltype(&epipolar_gn_kernel<4>) kernel = nullptr;
  switch (patch_size) {
    case 1: case 3: case 5: case 7: kernel = epipolar_gn_kernel<4>; break;
    case 9: kernel = epipolar_gn_kernel<slots_for(9)>; break;
    case 11: kernel = epipolar_gn_kernel<slots_for(11)>; break;
    default: return (int)cudaErrorInvalidValue;
  }
  if (tile < 1) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      left, reinterpret_cast<const float4*>(maps4), H, W, lx, ly, lt, rx, ry,
      epi_dir, alpha0, active, B, it0, it_stop, max_iter, patch_size, tile,
      stride, tol, huber, alpha, score, conf, valid, iters, done);
  return (int)cudaGetLastError();
}
