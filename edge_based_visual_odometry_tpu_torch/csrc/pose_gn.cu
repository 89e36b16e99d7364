// The inlier Gauss-Newton step of the RANSAC pose on Hopper (sm_90a):
// kernel K9.
//
// Replaces edge_based_visual_odometry_tpu/models/motion_tracker.py:307
// `gn_step` of `estimate_pose` (a `lax.scan` of XLA ops on the TPU, not a
// `pallas_call`): for the pose (R, t) and every quad q, the camera point
// X = R gamma_q + t, its projection through fx, fy, cx, cy (depth clamped
// at 1e-6), the residual r against cf_q, the weight w = (|r| < thr) and
// valid[q], the 2 x 6 Jacobian J = [-Jp [X]x | Jp], and the weighted sums
// of the normal equations: H's 21 upper-triangle entries (w Ja Jb over
// both rows), b = -sum w Ja r, and sum w. The 6 x 6 solve, the exp map and
// the update stay in torch on the card.
//
// Every term is formed with round-to-nearest intrinsics (no FMA
// contraction) in the order of the plain twin `_gn_terms` (ops/pose.py),
// and summed in the order of `_k9_layout_sum`: block c owns quads
// [c * 512, (c + 1) * 512); thread i adds quads c * 512 + k * 128 + i for
// k = 0..3 in order, starting from -0.0 (which adds nothing); a butterfly
// over the 32 lanes; the 4 warps in order; the blocks' partial sums go to
// a scratch buffer, and the block that takes the last ticket adds them in
// block order. So the sums do not depend on which block finishes first,
// and equal the twin's bit for bit. No term is skipped: a quad with w = 0
// still adds w Ja Jb (a NaN there poisons the sum, as in the reference).
//
// What bounds it on the card: at 32,768 quads, ~173 float ops a quad
// (5.7 M) and 21 B a quad read (0.7 MB): both well under a microsecond,
// so one launch is bound by its own latency. Fusing the 4 steps, with the
// 6 x 6 solve in the kernel, is the next form.

#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kPerThread = 4;
constexpr int kQuads = kThreads * kPerThread;   // quads a block
constexpr int kSums = 28;                       // H (21), b (6), sum w
constexpr int kWarps = kThreads / 32;

using gn::add;
using gn::mul;
using gn::sub;

// a quad's 28 terms; b's terms are w Ja r, negated after the sums
__device__ __forceinline__ void quad_terms(const float* R, const float* t,
                                           float fx, float fy, float cx,
                                           float cy, float g0, float g1,
                                           float g2, float c0, float c1,
                                           bool ok, float thr, float zmin,
                                           float* T) {
  const float X = add(add(add(mul(R[0], g0), mul(R[1], g1)), mul(R[2], g2)), t[0]);
  const float Y = add(add(add(mul(R[3], g0), mul(R[4], g1)), mul(R[5], g2)), t[1]);
  const float Z = add(add(add(mul(R[6], g0), mul(R[7], g1)), mul(R[8], g2)), t[2]);
  const float z = Z < zmin ? zmin : Z;     // torch.clamp: a NaN stays NaN
  const float r0 = sub(add(__fdiv_rn(mul(fx, X), z), cx), c0);
  const float r1 = sub(add(__fdiv_rn(mul(fy, Y), z), cy), c1);
  const float e = __fsqrt_rn(add(mul(r0, r0), mul(r1, r1)));
  const float w = (e < thr && ok) ? 1.0f : 0.0f;
  const float iz = __frcp_rn(z);
  const float iz2 = mul(iz, iz);
  const float a = mul(fx, iz), d = mul(fy, iz);
  const float c = mul(mul(-fx, X), iz2), f = mul(mul(-fy, Y), iz2);
  const float J0[6] = {mul(c, Y), sub(mul(a, Z), mul(c, X)), -mul(a, Y),
                       a, 0.0f, c};
  const float J1[6] = {sub(mul(f, Y), mul(d, Z)), -mul(f, X), mul(d, X),
                       0.0f, d, f};
  float w0[6], w1[6];
#pragma unroll
  for (int p = 0; p < 6; ++p) {
    w0[p] = mul(w, J0[p]);
    w1[p] = mul(w, J1[p]);
  }
  int s = 0;
#pragma unroll
  for (int p = 0; p < 6; ++p)
#pragma unroll
    for (int q = p; q < 6; ++q)
      T[s++] = add(mul(w0[p], J0[q]), mul(w1[p], J1[q]));
#pragma unroll
  for (int p = 0; p < 6; ++p) T[s++] = add(mul(w0[p], r0), mul(w1[p], r1));
  T[s] = w;
}

__global__ void __launch_bounds__(kThreads)
pose_gn_kernel(const float* __restrict__ Rg, const float* __restrict__ tg,
               const float* __restrict__ Kc, const float* __restrict__ gamma,
               const float* __restrict__ cf,
               const unsigned char* __restrict__ valid, int Q, float thr,
               float zmin, float* __restrict__ partial,
               unsigned* __restrict__ ticket, float* __restrict__ out) {
  __shared__ float s_warp[kWarps][kSums];
  __shared__ bool s_last;
  float R[9], t[3];
#pragma unroll
  for (int i = 0; i < 9; ++i) R[i] = Rg[i];
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = tg[i];
  const float fx = Kc[0], cx = Kc[2], fy = Kc[4], cy = Kc[5];

  float acc[kSums];
#pragma unroll
  for (int i = 0; i < kSums; ++i) acc[i] = -0.0f;
  const int q0 = blockIdx.x * kQuads + threadIdx.x;
#pragma unroll 1
  for (int k = 0; k < kPerThread; ++k) {
    const int q = q0 + k * kThreads;
    if (q >= Q) break;
    float T[kSums];
    quad_terms(R, t, fx, fy, cx, cy, gamma[3 * q], gamma[3 * q + 1],
               gamma[3 * q + 2], cf[2 * q], cf[2 * q + 1], valid[q] != 0, thr,
               zmin, T);
#pragma unroll
    for (int i = 0; i < kSums; ++i) acc[i] = add(acc[i], T[i]);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < kSums; ++i) {
    const float v = gn::warp_sum(acc[i]);
    if (lane == 0) s_warp[warp][i] = v;
  }
  __syncthreads();
  if (threadIdx.x < kSums) {
    float s = s_warp[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s = add(s, s_warp[w][threadIdx.x]);
    partial[blockIdx.x * kSums + threadIdx.x] = s;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) s_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!s_last || threadIdx.x >= kSums) return;
  __threadfence();
  const int i = threadIdx.x;
  float s = __ldcg(partial + i);
  for (int b = 1; b < (int)gridDim.x; ++b)
    s = add(s, __ldcg(partial + b * kSums + i));
  out[i] = (i >= 21 && i < 27) ? -s : s;
}

}  // namespace

// R (3, 3), t (3,), K (3, 3), gamma (Q, 3), cf (Q, 2) float32, valid (Q,)
// bool; threads and per_thread must be the kernel's (the twin's layout);
// partial holds blocks * 28 floats and then the block ticket; out (28,).
extern "C" int pose_gn_launch(const float* R, const float* t, const float* K,
                              const float* gamma, const float* cf,
                              const unsigned char* valid, int Q, float thr,
                              float zmin, int threads, int per_thread,
                              float* partial, float* out,
                              cudaStream_t stream) {
  if (threads != kThreads || per_thread != kPerThread || Q < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = Q > 0 ? (Q + kQuads - 1) / kQuads : 1;
  unsigned* ticket = reinterpret_cast<unsigned*>(partial + blocks * kSums);
  cudaError_t e = cudaMemsetAsync(ticket, 0, sizeof(unsigned), stream);
  if (e != cudaSuccess) return (int)e;
  pose_gn_kernel<<<blocks, kThreads, 0, stream>>>(
      R, t, K, gamma, cf, valid, Q, thr, zmin, partial, ticket, out);
  return (int)cudaGetLastError();
}
