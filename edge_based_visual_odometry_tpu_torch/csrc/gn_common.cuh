// Device helpers of the photometric Gauss-Newton kernels (epipolar_gn.cu,
// gn_2dof.cu): round-to-nearest arithmetic, the warp butterfly sum, the
// tile-clamped bilinear taps of the reference's atlas sampling, and a
// lane's share of the two rotated side patches. The descriptor kernel
// (edge_descriptors.cu) samples through the same arithmetic, sum and taps.
//
// One warp refines one lane. The 2 P^2 samples of the plus and minus
// patches are spread over the 32 threads, sample s = thread + 32 k in slot
// k < NS, NS = max(4, ceil(2 P^2 / 32)) (`slots_for`: 4 up to P = 7, 6 at
// P = 9, 8 at P = 11). Every sum is the thread's slots in order, then a
// butterfly over the warp, the order the plain twins' `_lane_sum`
// follows.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace gn {

// samples a thread for patch size P: 2 P^2 <= 32 NS, and at least 4 (the
// kernels' slots up to P = 7)
__host__ __device__ constexpr int slots_for(int P) {
  return (2 * P * P + 31) / 32 > 4 ? (2 * P * P + 31) / 32 : 4;
}

// no FMA contraction: each multiply and add rounds on its own, as in the
// plain twins
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// torch.clamp's semantics, one instruction a bound: a NaN stays NaN
// (fminf/fmaxf would return the bound), so a lane whose step went NaN
// samples NaN, as in the plain twins
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(v), "f"(lo));
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(r), "f"(hi));
  return r;
}

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
  k = clamp(k, 0.0f, (float)(nb - 1));
  return mul(k, (float)stride);
}

struct Tap {
  int i00, i01, i10, i11;
  float wc0, wc1, wr0, wr1;
};

// bilinear taps of (x, y) clamped to the tile at (ox, oy), as image
// indices (edge-replicated into the image); weights as the reference's
// hat-weight contraction. A NaN coordinate gives NaN weights and index 0
// (the float-to-int conversion maps NaN to 0).
__device__ __forceinline__ Tap make_tap(float x, float y, float ox, float oy,
                                       float t1, int H, int W) {
  const float rx = clamp(sub(x, ox), 0.0f, t1);
  const float ry = clamp(sub(y, oy), 0.0f, t1);
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

__device__ __forceinline__ float lerp4(const Tap& t, float v00, float v01,
                                       float v10, float v11) {
  return add(mul(t.wr0, add(mul(t.wc0, v00), mul(t.wc1, v01))),
             mul(t.wr1, add(mul(t.wc0, v10), mul(t.wc1, v11))));
}

__device__ __forceinline__ float read_global(const float* __restrict__ m,
                                             const Tap& t) {
  return lerp4(t, __ldg(m + t.i00), __ldg(m + t.i01), __ldg(m + t.i10),
               __ldg(m + t.i11));
}

// image, gx, gy at one tap of the interleaved {image, gx, gy, -} pixels
__device__ __forceinline__ void read3(const float4* __restrict__ m,
                                      const Tap& t, float* rv, float* gx,
                                      float* gy) {
  const float4 a = __ldg(m + t.i00);
  const float4 b = __ldg(m + t.i01);
  const float4 c = __ldg(m + t.i10);
  const float4 d = __ldg(m + t.i11);
  *rv = lerp4(t, a.x, b.x, c.x, d.x);
  *gx = lerp4(t, a.y, b.y, c.y, d.y);
  *gy = lerp4(t, a.z, b.z, c.z, d.z);
}

// A thread's slots: the patch offsets (i, j) of its samples and their
// patch half (+1 plus, -1 minus). A slot past the 2 P^2 samples
// (has = false) computes sample 0 again and adds nothing, so its reads
// stay inside the patch and the slots carry no branches.
template <int NS>
struct Slots {
  float oi[NS], oj[NS], sgn[NS];
  bool has[NS];
};

template <int NS>
__device__ __forceinline__ Slots<NS> make_slots(int lane, int P) {
  const int pp = P * P, half = P / 2;
  Slots<NS> sl;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    const int s_ = lane + 32 * k;
    sl.has[k] = s_ < 2 * pp;
    const int q = !sl.has[k] ? 0 : s_ < pp ? s_ : s_ - pp;
    sl.oi[k] = (float)(q / P - half);
    sl.oj[k] = (float)(q % P - half);
    sl.sgn[k] = s_ < pp ? 1.0f : -1.0f;
  }
  return sl;
}

// the slots' offsets rotated by the angle with cosine c and sine s:
// (c i, s j, s i, c j)
template <int NS>
struct Rotated {
  float cti[NS], stj[NS], sti[NS], ctj[NS];
};

template <int NS>
__device__ __forceinline__ Rotated<NS> rotate(const Slots<NS>& sl, float c,
                                              float s) {
  Rotated<NS> r;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    r.cti[k] = mul(c, sl.oi[k]);
    r.stj[k] = mul(s, sl.oj[k]);
    r.sti[k] = mul(s, sl.oi[k]);
    r.ctj[k] = mul(c, sl.oj[k]);
  }
  return r;
}

// coordinates of slot k: the centre (x, y) moved by +-(nsx, nsy) (the
// normal times the side offset) for its half, plus the rotated offset
template <int NS>
__device__ __forceinline__ void slot_xy(const Slots<NS>& sl,
                                        const Rotated<NS>& r, int k, float x,
                                        float y, float nsx, float nsy,
                                        float* px, float* py) {
  const float cx = sl.sgn[k] > 0 ? add(x, nsx) : sub(x, nsx);
  const float cy = sl.sgn[k] > 0 ? add(y, nsy) : sub(y, nsy);
  *px = sub(add(cx, r.cti[k]), r.stj[k]);
  *py = add(add(cy, r.sti[k]), r.ctj[k]);
}

// the means of the plus and minus halves of the warp's slot values
template <int NS>
__device__ __forceinline__ void half_means(const Slots<NS>& sl,
                                           const float v[NS], float inv_pp,
                                           float* mp, float* mm) {
  float sp = 0.0f, sm = 0.0f;
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    sp = sl.has[k] && sl.sgn[k] > 0 ? add(sp, v[k]) : sp;
    sm = sl.has[k] && sl.sgn[k] < 0 ? add(sm, v[k]) : sm;
  }
  *mp = mul(warp_sum(sp), inv_pp);
  *mm = mul(warp_sum(sm), inv_pp);
}

// the mean-centred two-side patches around the edge (x, y) of `img`,
// sampled once per lane from the 32 x 32 tile (atlas stride 8) around it
template <int NS>
__device__ __forceinline__ void centred_patches(
    const float* __restrict__ img, int H, int W, float x, float y, float nsx,
    float nsy, const Slots<NS>& sl, const Rotated<NS>& r, float inv_pp,
    float out[NS]) {
  const float ox = tile_origin(x, 32, 8, W);
  const float oy = tile_origin(y, 32, 8, H);
#pragma unroll
  for (int k = 0; k < NS; ++k) {
    float px, py;
    slot_xy(sl, r, k, x, y, nsx, nsy, &px, &py);
    out[k] = read_global(img, make_tap(px, py, ox, oy, 31.0f, H, W));
  }
  float mp, mm;
  half_means(sl, out, inv_pp, &mp, &mm);
#pragma unroll
  for (int k = 0; k < NS; ++k) out[k] = sub(out[k], sl.sgn[k] > 0 ? mp : mm);
}

}  // namespace gn
