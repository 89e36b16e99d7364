// 2-DoF KF -> CF photometric Gauss-Newton on Hopper (sm_90a): kernel K3.
//
// Replaces edge_based_visual_odometry_tpu/ops/gauss_newton.py:387
// `refine_2dof_batch`, the temporal cascade's refiner. On the TPU it is an
// XLA formulation, not a `pallas_call`: a CF tile atlas and a KF 32/8
// atlas, bilinear sampling as MXU einsums, chunks of `lax.while_loop`s
// and the two-phase compaction. This kernel computes what it computes,
// per flat (KF mate, candidate) lane of one side: two rotated 7x7 KF
// patches at +-(P/2 + 1) along the KF edge normal, sampled once from the
// 32 x 32 tile around the KF edge and mean-centred per half; each
// iteration the CF patch pair at kf - d rotated by the CF orientation,
// sampled bilinearly from the CF image, gx and gy, each sample clamped to
// the gn_tile tile of the CF candidate (which bounds GN travel), and
// mean-centred; Huber weights (w = 1 if |r| < delta, else delta / |r|);
// the 2x2 normal equations (+ reg 1e-6 n) solved through 1 / det; at most
// max_iter iterations, stopping at |step| < tol.
//
// What bounds it on the card: instruction issue, as with the 1-DoF kernel
// K2 (epipolar_gn.cu), not bytes. Per lane-iteration ~7.7 kflop against
// ~55 bytes of lane data; each iteration is ~700 warp instructions (4
// sample slots of coordinates, tile clamp, bilinear taps of 3 maps,
// residual and Huber weight, then 8 butterfly reductions), while the three
// 376 x 1241 maps stay in L2 and a lane's samples mostly hit L1.
//
// Design: K2's, measured there. One warp per lane; the 98 samples over the
// 32 threads (<= 4 each) in branch-free slots (a slot past the samples
// recomputes sample 0 and adds nothing); the two patch means and the six
// sums are warp-shuffle butterflies, so every thread holds the same scalar
// state and the warp leaves its loop as soon as its lane converges; each
// CF sample is 4 16-byte `__ldg` gathers of the interleaved
// {image, gx, gy, -} pixels (`interleave_maps`, made once per side). The
// kernel runs iterations [it0, it_stop) from per-lane d0/active, so
// `_two_phase` in ops/gauss_newton.py launches it twice, as for K2.
//
// Arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction) and reciprocal multiplies in the order of the plain twin
// `refine_2dof_plain`, which sums in this kernel's lane order: the two
// agree bit for bit.

#include <cuda_runtime.h>
#include <math.h>

#include "gn_common.cuh"

namespace {

using namespace gn;

constexpr int WARPS = 8;       // lanes per block

__global__ void __launch_bounds__(WARPS * 32)
gn_2dof_kernel(const float* __restrict__ kf,
               const float4* __restrict__ maps4, int H, int W,
               const float* __restrict__ kx_, const float* __restrict__ ky_,
               const float* __restrict__ kt_, const float* __restrict__ cx_,
               const float* __restrict__ cy_, const float* __restrict__ ct_,
               const float* __restrict__ d0, const bool* __restrict__ active,
               int B, int it0, int it_stop, int max_iter, int P, int tile,
               int stride, float tol, float huber,
               float* __restrict__ out_d, float* __restrict__ out_score,
               float* __restrict__ out_conf, bool* __restrict__ out_valid,
               int* __restrict__ out_iters, bool* __restrict__ out_done) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int cand = blockIdx.x * (blockDim.x >> 5) + warp;
  if (cand >= B) return;

  float dx = d0[2 * cand], dy = d0[2 * cand + 1];
  if (!active[cand]) {
    if (lane == 0) {
      out_d[2 * cand] = dx;
      out_d[2 * cand + 1] = dy;
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
  const float reg = (float)(1e-6 * n_samples);
  const float kx = kx_[cand], ky = ky_[cand], kt = kt_[cand];
  const float cx = cx_[cand], cy = cy_[cand], ct = ct_[cand];
  const Slots sl = make_slots(lane, P);

  float kc[NS];     // centred KF patches (sampled once)
  {
    const float c = cosf(kt), s = sinf(kt);
    centred_patches(kf, H, W, kx, ky, mul(-s, side), mul(c, side), sl,
                    rotate(sl, c, s), inv_pp, kc);
  }
  const float cc = cosf(ct), sc = sinf(ct);
  const Rotated rot = rotate(sl, cc, sc);
  const float nsx = mul(-sc, side), nsy = mul(cc, side);   // CF normal * side
  const float ox = tile_origin(cx, tile, stride, W);
  const float oy = tile_origin(cy, tile, stride, H);
  const float t1 = tile - 1.0f;

  float score = 1e6f, conf = 0.0f;
  bool valid = false, done = false;
  int iters = 0;
  for (int it = it0; it < it_stop && !done; ++it) {
    const float bx = sub(kx, dx), by = sub(ky, dy);
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
    float h00 = 0.0f, h01 = 0.0f, h11 = 0.0f;
    float b0 = 0.0f, b1 = 0.0f, cost = 0.0f;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float r = sub(kc[k], sub(rv[k], sl.sgn[k] > 0 ? mp : mm));
      const float ar = fabsf(r);
      const float w = ar < huber ? 1.0f : mul(__frcp_rn(ar), huber);
      const float wgx = mul(w, gx[k]), wgy = mul(w, gy[k]);
      const bool h = sl.has[k];
      h00 = h ? add(h00, mul(wgx, gx[k])) : h00;
      h01 = h ? add(h01, mul(wgx, gy[k])) : h01;
      h11 = h ? add(h11, mul(wgy, gy[k])) : h11;
      b0 = h ? add(b0, mul(wgx, r)) : b0;
      b1 = h ? add(b1, mul(wgy, r)) : b1;
      cost = h ? add(cost, mul(mul(w, r), r)) : cost;
    }
    h00 = add(warp_sum(h00), reg);
    h01 = warp_sum(h01);
    h11 = add(warp_sum(h11), reg);
    b0 = warp_sum(b0);
    b1 = warp_sum(b1);
    cost = warp_sum(cost);

    const float inv = __frcp_rn(sub(mul(h00, h11), mul(h01, h01)));
    const float e0 = mul(-sub(mul(h11, b0), mul(h01, b1)), inv);
    const float e1 = mul(-add(mul(-h01, b0), mul(h00, b1)), inv);
    const float rms = __fsqrt_rn(mul(cost, inv_n));
    const float step = __fsqrt_rn(add(mul(e0, e0), mul(e1, e1)));
    const bool converged = step < tol || it == max_iter - 1;
    if (converged) {
      score = rms;
      conf = expf(mul(-rms, inv_huber));
      valid = !(rms > huber * 2.0f || it < 1);
    }
    dx = add(dx, e0);
    dy = add(dy, e1);
    iters = it + 1;
    done = converged;
  }
  if (lane == 0) {
    out_d[2 * cand] = dx;
    out_d[2 * cand + 1] = dy;
    out_score[cand] = score;
    out_conf[cand] = conf;
    out_valid[cand] = valid;
    out_iters[cand] = iters;
    out_done[cand] = done;
  }
}

}  // namespace

// maps4: the (H, W) interleaved {cf, gx, gy, any} copy of the CF maps
// (16-byte pixels); d0 and d: (B, 2) displacements kf - cf.
extern "C" int refine_2dof_launch(
    const float* kf, const float* maps4, int H, int W, const float* kx,
    const float* ky, const float* kt, const float* cx, const float* cy,
    const float* ct, const float* d0, const bool* active, int B, int it0,
    int it_stop, int max_iter, int patch_size, int tile, int stride,
    float tol, float huber, float* d, float* score, float* conf, bool* valid,
    int* iters, bool* done, cudaStream_t stream) {
  if (2 * patch_size * patch_size > 32 * NS || tile < 1)
    return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  gn_2dof_kernel<<<(B + WARPS - 1) / WARPS, WARPS * 32, 0, stream>>>(
      kf, reinterpret_cast<const float4*>(maps4), H, W, kx, ky, kt, cx, cy,
      ct, d0, active, B, it0, it_stop, max_iter, patch_size, tile, stride,
      tol, huber, d, score, conf, valid, iters, done);
  return (int)cudaGetLastError();
}
