// Edge clustering on Hopper (sm_90a): kernel K4.
//
// Replaces edge_based_visual_odometry_tpu/ops/clustering.py:42
// `cluster_edges`, the stereo cascade's stage 10 and the temporal
// cascade's clustering of the left centres. On the TPU it is an XLA
// formulation, not a `pallas_call`: (.., C, C) adjacency, min-label rounds
// with a bf16 one-hot MXU einsum as the pointer jump, an (r, k, j)
// comparison cube for the size cap and einsums for the representative.
// This kernel computes what it computes, per row of C <= 32 candidate
// slots (x, y, theta, mask):
//   - adjacency: |p_j - p_k| < dist_thresh (and, with the orientation
//     gate, |theta_j - theta_k| < orient_rad), both slots in the mask,
//     plus the self-loop;
//   - connected components by ceil(log2 C) + 2 rounds of min-label
//     propagation, each followed by a pointer jump lab = min(lab,
//     lab[lab]); slots out of the mask take the label C;
//   - the size cap (0 < cap < C): each member ranks by its distance to its
//     component's centroid, ties by slot index; members ranked >= cap
//     become singletons and the kept members take the least kept index;
//   - the Gaussian-weighted representative of each component: centre,
//     mean distance to it, weights exp(-0.5 ((d - mean) / sigma)^2), the
//     weighted x, y and theta, written at the slot whose label is its own
//     index; the (C, C) membership matrix M[r, j] = (lab_j == r) & m_j.
//
// What bounds it on the card: bytes, on paper. At N = 32,768 rows of 32
// slots it reads 13 B and writes 21 B a slot plus 1 KiB of membership a
// row (69 MB, 21 us at 3.35 TB/s), against ~1.2 GFLOP of the O(N C^2)
// form (18 us at 67 TFLOP/s, before counting that sqrt and exp run on the
// special-function units). In practice instruction issue: every
// cross-slot step is a warp shuffle, ~10 of them per (row, slot pair).
//
// Design: one warp per row, lane j holding slot j, so every cross-slot
// step is a `__shfl_sync` and nothing needs shared memory. The adjacency
// of slot j is a 32-bit mask on lane j; a propagation round reads every
// lane's label from before the round, and the jump is one shuffle by the
// label. The cap's rank is the O(C^2) form of the reference's cube: lane
// j counts the members k of its component with (dc_k, k) < (dc_j, j); the
// least kept index of a component comes from `__match_any_sync` and a
// ballot. Lane r forms component r's sums over j = 0 .. C-1. Loads are
// coalesced (128 B a row an array), and each lane writes its 32 bytes of
// membership as two 16-byte stores. Lanes >= C take part in the shuffles,
// hold mask false and write nothing.
//
// Arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction) and reciprocal multiplies in the order of the plain twin
// `cluster_edges_plain`, which sums over j in ascending order, one term
// after another, as a lane here does. Every sum adds all C terms, each
// weighted by its 0/1 membership as the twin's products are: a slot out of
// the mask that holds NaN or inf poisons its row's sums in both. The two
// agree bit for bit on the card.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;            // rows a block, one warp each
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ float shf(float v, int src) {
  return __shfl_sync(kAll, v, src);
}

__device__ __forceinline__ int shi(int v, int src) {
  return __shfl_sync(kAll, v, src);
}

// |(x, y) - (cx, cy)| in the twin's order: sqrt(dx*dx + dy*dy)
__device__ __forceinline__ float dist(float x, float y, float cx, float cy) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy);
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// sum over j of w_j * v_j, ascending j, the first term as it is
__device__ __forceinline__ float acc(float s, int j, float term) {
  return j ? __fadd_rn(s, term) : term;
}

// 16 membership bytes (0/1) from bits [b, b + 16) of `bits`
__device__ __forceinline__ uint4 bytes16(unsigned bits, int b) {
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned n = bits >> (b + 4 * q);
    w[q] = (n & 1u) | ((n >> 1) & 1u) << 8 | ((n >> 2) & 1u) << 16 |
           ((n >> 3) & 1u) << 24;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__global__ void __launch_bounds__(kWarps * 32)
cluster_edges_kernel(const float* __restrict__ xs, const float* __restrict__ ys,
                     const float* __restrict__ ts,
                     const unsigned char* __restrict__ ms, int N, int C,
                     float thresh, int by_orient, float orient_rad,
                     float inv_sigma, int cap, int rounds,
                     float* __restrict__ ox, float* __restrict__ oy,
                     float* __restrict__ ot, unsigned char* __restrict__ omask,
                     long long* __restrict__ olabel,
                     unsigned char* __restrict__ omembers) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;                  // the whole warp leaves together
  const bool in = lane < C;
  const long long at = row * C + lane;
  const float x = in ? xs[at] : 0.f;
  const float y = in ? ys[at] : 0.f;
  const float t = in ? ts[at] : 0.f;
  const bool m = in && ms[at] != 0;
  const unsigned mball = __ballot_sync(kAll, m);

  // adjacency of slot j = lane: bit k
  unsigned adj = 0;
  for (int k = 0; k < C; ++k) {
    const float xk = shf(x, k), yk = shf(y, k), tk = shf(t, k);
    bool e = dist(x, y, xk, yk) < thresh;
    if (by_orient) e = e && fabsf(__fsub_rn(t, tk)) < orient_rad;
    adj |= (unsigned)e << k;
  }
  adj = (m ? adj & mball : 0u) | 1u << lane;

  // min-label propagation, each round followed by the pointer jump
  int lab = lane;
  for (int r = 0; r < rounds; ++r) {
    int mn = C;
    for (int k = 0; k < C; ++k) {
      const int lk = shi(lab, k);
      if (adj >> k & 1u) mn = min(mn, lk);
    }
    lab = min(lab, mn);
    lab = min(lab, shi(lab, lab));
  }
  lab = m ? lab : C;

  if (cap != 0 && cap < C) {
    // lane r: count and centroid of component r
    float sx = 0.f, sy = 0.f;
    int cnt = 0;
    for (int j = 0; j < C; ++j) {
      const int lj = shi(lab, j);
      const float xj = shf(x, j), yj = shf(y, j);
      const bool mem = lj == lane && (mball >> j & 1u);
      const float mf = mem ? 1.f : 0.f;
      cnt += mem;
      sx = acc(sx, j, __fmul_rn(mf, xj));
      sy = acc(sy, j, __fmul_rn(mf, yj));
    }
    const float c0 = fmaxf((float)cnt, 1.f);
    const float cx = __fdiv_rn(sx, c0), cy = __fdiv_rn(sy, c0);
    // lane j: distance to the centroid of its component, then its rank
    const float dc = dist(x, y, shf(cx, lab & 31), shf(cy, lab & 31));
    int rank = 0;
    for (int k = 0; k < C; ++k) {
      const float dk = shf(dc, k);
      const int lk = shi(lab, k);
      rank += (mball >> k & 1u) && lk == lab &&
              (dk < dc || (dk == dc && k < lane));
    }
    const bool kept = rank < cap;
    const unsigned kball = __ballot_sync(kAll, m && kept);
    const unsigned same = __match_any_sync(kAll, lab);
    const int core = __ffs(same & kball) - 1;
    lab = m ? (kept ? core : lane) : lab;
  }

  // lane r: component r's members, centre, mean distance, weighted means
  unsigned memb = 0;
  float sx = 0.f, sy = 0.f;
  int cnt = 0;
  for (int j = 0; j < C; ++j) {
    const int lj = shi(lab, j);
    const float xj = shf(x, j), yj = shf(y, j);
    const bool mem = lj == lane && (mball >> j & 1u);
    const float mf = mem ? 1.f : 0.f;
    memb |= (unsigned)mem << j;
    cnt += mem;
    sx = acc(sx, j, __fmul_rn(mf, xj));
    sy = acc(sy, j, __fmul_rn(mf, yj));
  }
  const float safe = fmaxf((float)cnt, 1.f);
  const float cx = __fdiv_rn(sx, safe), cy = __fdiv_rn(sy, safe);
  float sd = 0.f;
  for (int j = 0; j < C; ++j) {
    const float xj = shf(x, j), yj = shf(y, j);
    const float mf = (memb >> j & 1u) ? 1.f : 0.f;
    sd = acc(sd, j, __fmul_rn(mf, dist(xj, yj, cx, cy)));
  }
  const float mean = __fdiv_rn(sd, safe);
  float sw = 0.f, gx = 0.f, gy = 0.f, gt = 0.f;
  for (int j = 0; j < C; ++j) {
    const float xj = shf(x, j), yj = shf(y, j), tj = shf(t, j);
    const float mf = (memb >> j & 1u) ? 1.f : 0.f;
    const float z = __fmul_rn(__fsub_rn(dist(xj, yj, cx, cy), mean),
                              inv_sigma);
    const float w = __fmul_rn(expf(__fmul_rn(-0.5f, __fmul_rn(z, z))), mf);
    sw = acc(sw, j, w);
    gx = acc(gx, j, __fmul_rn(w, xj));
    gy = acc(gy, j, __fmul_rn(w, yj));
    gt = acc(gt, j, __fmul_rn(w, tj));
  }
  sw = isnan(sw) ? sw : fmaxf(sw, 1e-12f);   // clamp keeps NaN
  if (!in) return;
  const bool rep = lab == lane && m;
  ox[at] = rep ? __fdiv_rn(gx, sw) : 0.f;
  oy[at] = rep ? __fdiv_rn(gy, sw) : 0.f;
  ot[at] = rep ? __fdiv_rn(gt, sw) : 0.f;
  omask[at] = rep;
  olabel[at] = lab;
  unsigned char* mrow = omembers + at * C;
  if ((C & 15) == 0) {                       // rows of 16-byte multiples
    for (int b = 0; b < C; b += 16)
      *reinterpret_cast<uint4*>(mrow + b) = bytes16(memb, b);
  } else {
    for (int j = 0; j < C; ++j) mrow[j] = memb >> j & 1u;
  }
}

}  // namespace

// x, y, theta (N, C) float32, mask (N, C) bool, C <= 32; outputs x, y,
// theta (N, C) float32, mask (N, C) bool, label (N, C) int64, members
// (N, C, C) bool (16-byte aligned when C is a multiple of 16). `thresh`,
// `orient_rad` and `inv_sigma` are the float32 values the twin compares
// and multiplies with; `cap` applies when 0 < cap < C.
extern "C" int cluster_edges_launch(
    const float* x, const float* y, const float* theta,
    const unsigned char* mask, int N, int C, float thresh, int by_orient,
    float orient_rad, float inv_sigma, int cap, int rounds, float* ox,
    float* oy, float* ot, unsigned char* omask, long long* olabel,
    unsigned char* omembers, cudaStream_t stream) {
  if (N <= 0 || C <= 0) return (int)cudaGetLastError();
  if (C > 32) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kWarps - 1) / kWarps;
  cluster_edges_kernel<<<blocks, kWarps * 32, 0, stream>>>(
      x, y, theta, mask, N, C, thresh, by_orient, orient_rad, inv_sigma, cap,
      rounds, ox, oy, ot, omask, olabel, omembers);
  return (int)cudaGetLastError();
}
