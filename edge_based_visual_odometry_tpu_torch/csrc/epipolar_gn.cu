// 1-DoF epipolar photometric Gauss-Newton on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `refine_along_epipolar_pallas` (body
// `_gn_kernel`) of edge_based_visual_odometry_tpu/ops/gn_pallas.py, which
// computes what ops/gauss_newton.py::refine_along_epipolar_batch computes
// per stereo candidate: two rotated 7x7 side patches at +-(P/2 + 1) along
// the left-edge normal, sampled bilinearly from the right image and its
// gx/gy and mean-centred, against the centred left patches; Huber weights
// (delta = huber); gradient term -gx*dx + gy*dy; a scalar normal
// equation; at most max_iter iterations, stopping at |step| < tol.
//
// What bounds it on the card: latency of dependent, data-dependent
// gathers. Each iteration of a candidate reads 98 samples x 4 corners x 3
// maps scattered around the candidate, then needs three reductions before
// the next step can start; lanes converge after different numbers of
// iterations. The three 376x1241 f32 maps (5.6 MB) fit the 50 MB L2, so
// the gathers hit L2 rather than HBM.
//
// Design: one warp per candidate. The 98 samples are spread over the 32
// lanes (<= 4 each); the two patch means and H, b, cost are warp-shuffle
// butterfly reductions, so every lane holds the same scalar state and the
// warp leaves its loop as soon as its candidate converges - no lane waits
// for another candidate. The left patches are sampled once. Images are
// read through __ldg from global memory; every sample is clamped to the
// T x T atlas tile the reference picks around the candidate (the clamp
// bounds GN travel, see ops/tiled_sampling.py), left samples to the
// 32 x 32 tile around the left edge. The kernel runs iterations
// [it0, it_stop) from per-lane alpha0/active, so `_two_phase` in
// ops/gauss_newton.py launches it twice with the reference's semantics.
//
// Arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction) in the order of the plain twin `refine_along_epipolar_plain`
// (which sums in this kernel's lane order), so the two agree bit for bit
// and a GN lane that needs all iterations cannot drift apart by rounding.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int WARPS = 8;
constexpr int NS = 4;          // samples per lane: 2 * P * P <= 32 * NS

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = add(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// origin of the atlas tile picked for anchor c on an axis of length n
__device__ __forceinline__ float tile_origin(float c, int tile, int stride,
                                             int n) {
  const int nb = (n + stride - 1) / stride;
  float k = rintf(__fdiv_rn(sub(c, tile * 0.5f), (float)stride));
  k = fminf(fmaxf(k, 0.0f), (float)(nb - 1));
  return mul(k, (float)stride);
}

struct Tap {
  int i00, i01, i10, i11;
  float wc0, wc1, wr0, wr1;
};

// bilinear taps of (x, y) clamped to the tile at (ox, oy), edge-replicated
// into the image; weights as the reference's hat-weight contraction
__device__ __forceinline__ Tap make_tap(float x, float y, float ox, float oy,
                                        float t1, int H, int W) {
  const float rx = fminf(fmaxf(sub(x, ox), 0.0f), t1);
  const float ry = fminf(fmaxf(sub(y, oy), 0.0f), t1);
  const float x0 = floorf(rx), y0 = floorf(ry);
  Tap t;
  t.wc0 = sub(1.0f, fabsf(sub(rx, x0)));
  t.wc1 = sub(1.0f, fabsf(sub(rx, add(x0, 1.0f))));
  t.wr0 = sub(1.0f, fabsf(sub(ry, y0)));
  t.wr1 = sub(1.0f, fabsf(sub(ry, add(y0, 1.0f))));
  const int ix0 = min((int)add(ox, x0), W - 1);
  const int ix1 = min((int)add(add(ox, x0), 1.0f), W - 1);
  const int iy0 = min((int)add(oy, y0), H - 1);
  const int iy1 = min((int)add(add(oy, y0), 1.0f), H - 1);
  t.i00 = iy0 * W + ix0;
  t.i01 = iy0 * W + ix1;
  t.i10 = iy1 * W + ix0;
  t.i11 = iy1 * W + ix1;
  return t;
}

__device__ __forceinline__ float read(const float* __restrict__ m,
                                      const Tap& t) {
  return add(mul(t.wr0, add(mul(t.wc0, __ldg(m + t.i00)),
                            mul(t.wc1, __ldg(m + t.i01)))),
             mul(t.wr1, add(mul(t.wc0, __ldg(m + t.i10)),
                            mul(t.wc1, __ldg(m + t.i11)))));
}

// sample coordinate of patch offset (i, j) around centre (cx, cy)
__device__ __forceinline__ void patch_xy(float cx, float cy, float ct,
                                         float st, float i, float j,
                                         float* px, float* py) {
  *px = sub(add(cx, mul(ct, i)), mul(st, j));
  *py = add(add(cy, mul(st, i)), mul(ct, j));
}

__global__ void __launch_bounds__(WARPS * 32)
epipolar_gn_kernel(const float* __restrict__ left,
                   const float* __restrict__ right,
                   const float* __restrict__ rgx,
                   const float* __restrict__ rgy, int H, int W,
                   const float* __restrict__ lx_, const float* __restrict__ ly_,
                   const float* __restrict__ lt_, const float* __restrict__ rx_,
                   const float* __restrict__ ry_,
                   const float* __restrict__ epi_dir,
                   const float* __restrict__ alpha0,
                   const bool* __restrict__ active, int B, int it0,
                   int it_stop, int max_iter, int P, int tile, int stride,
                   float tol, float huber, float* __restrict__ out_alpha,
                   float* __restrict__ out_score, float* __restrict__ out_conf,
                   bool* __restrict__ out_valid, int* __restrict__ out_iters,
                   bool* __restrict__ out_done) {
  const int lane = threadIdx.x & 31;
  const int cand = blockIdx.x * WARPS + (threadIdx.x >> 5);
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
  const int half = P / 2;
  const float side = P / 2.0f + 1.0f;
  const float inv_pp = 1.0f / pp, inv_n = 1.0f / n_samples;
  const float inv_huber = 1.0f / huber;
  const float lx = lx_[cand], ly = ly_[cand], lt = lt_[cand];
  const float rx = rx_[cand], ry = ry_[cand];
  const float dx = epi_dir[2 * cand], dy = epi_dir[2 * cand + 1];
  const float ct = cosf(lt), st = sinf(lt);
  const float nsx = mul(-st, side), nsy = mul(ct, side);   // normal * side

  // per-lane samples: offsets, patch half (+1 plus / -1 minus)
  float oi[NS], oj[NS], sgn[NS], lc[NS];
  bool has[NS];
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int s = lane + 32 * k;
    has[k] = s < n_samples;
    const int q = s < pp ? s : s - pp;
    oi[k] = (float)(q / P - half);
    oj[k] = (float)(q % P - half);
    sgn[k] = s < pp ? 1.0f : -1.0f;
  }

  // centred left patches (sampled once)
  {
    const float ox = tile_origin(lx, 32, 8, W), oy = tile_origin(ly, 32, 8, H);
    float sp = 0.0f, sm = 0.0f;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      lc[k] = 0.0f;
      if (!has[k]) continue;
      const float cx = sgn[k] > 0 ? add(lx, nsx) : sub(lx, nsx);
      const float cy = sgn[k] > 0 ? add(ly, nsy) : sub(ly, nsy);
      float px, py;
      patch_xy(cx, cy, ct, st, oi[k], oj[k], &px, &py);
      lc[k] = read(left, make_tap(px, py, ox, oy, 31.0f, H, W));
      if (sgn[k] > 0) sp = add(sp, lc[k]); else sm = add(sm, lc[k]);
    }
    const float mp = mul(warp_sum(sp), inv_pp);
    const float mm = mul(warp_sum(sm), inv_pp);
#pragma unroll
    for (int k = 0; k < NS; ++k) lc[k] = sub(lc[k], sgn[k] > 0 ? mp : mm);
  }

  const float ox = tile_origin(rx, tile, stride, W);
  const float oy = tile_origin(ry, tile, stride, H);
  const float t1 = tile - 1.0f;
  float score = 1e6f, conf = 0.0f;
  bool valid = false, done = false;
  int iters = 0;
  for (int it = it0; it < it_stop && !done; ++it) {
    const float bx = add(rx, mul(alpha, dx)), by = add(ry, mul(alpha, dy));
    float rv[NS], gx[NS], gy[NS];
    float sp = 0.0f, sm = 0.0f;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      rv[k] = gx[k] = gy[k] = 0.0f;
      if (!has[k]) continue;
      const float cx = sgn[k] > 0 ? add(bx, nsx) : sub(bx, nsx);
      const float cy = sgn[k] > 0 ? add(by, nsy) : sub(by, nsy);
      float px, py;
      patch_xy(cx, cy, ct, st, oi[k], oj[k], &px, &py);
      const Tap t = make_tap(px, py, ox, oy, t1, H, W);
      rv[k] = read(right, t);
      gx[k] = read(rgx, t);
      gy[k] = read(rgy, t);
      if (sgn[k] > 0) sp = add(sp, rv[k]); else sm = add(sm, rv[k]);
    }
    const float mp = mul(warp_sum(sp), inv_pp);
    const float mm = mul(warp_sum(sm), inv_pp);
    float Hh = 0.0f, bb = 0.0f, cost = 0.0f;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      if (!has[k]) continue;
      const float r = sub(lc[k], sub(rv[k], sgn[k] > 0 ? mp : mm));
      const float g = add(mul(-gx[k], dx), mul(gy[k], dy));
      const float ar = fabsf(r);
      const float w = ar <= huber ? 1.0f : mul(__fdiv_rn(1.0f, ar), huber);
      Hh = add(Hh, mul(mul(w, g), g));
      bb = add(bb, mul(mul(w, g), r));
      cost = add(cost, mul(mul(w, r), r));
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

extern "C" int refine_along_epipolar_launch(
    const float* left, const float* right, const float* rgx, const float* rgy,
    int H, int W, const float* lx, const float* ly, const float* lt,
    const float* rx, const float* ry, const float* epi_dir,
    const float* alpha0, const bool* active, int B, int it0, int it_stop,
    int max_iter, int patch_size, int tile, int stride, float tol,
    float huber, float* alpha, float* score, float* conf, bool* valid,
    int* iters, bool* done, cudaStream_t stream) {
  if (2 * patch_size * patch_size > 32 * NS) return (int)cudaErrorInvalidValue;
  if (B <= 0) return (int)cudaGetLastError();
  const int blocks = (B + WARPS - 1) / WARPS;
  epipolar_gn_kernel<<<blocks, WARPS * 32, 0, stream>>>(
      left, right, rgx, rgy, H, W, lx, ly, lt, rx, ry, epi_dir, alpha0,
      active, B, it0, it_stop, max_iter, patch_size, tile, stride, tol,
      huber, alpha, score, conf, valid, iters, done);
  return (int)cudaGetLastError();
}
