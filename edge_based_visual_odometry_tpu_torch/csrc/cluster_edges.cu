// Edge clustering on Hopper (sm_90a): kernel K4.
//
// Replaces edge_based_visual_odometry_tpu/ops/clustering.py:42
// `cluster_edges`, the stereo cascade's stage 10 and the temporal
// cascade's clustering of the left centres. On the TPU it is an XLA
// formulation, not a `pallas_call`: (.., C, C) adjacency, min-label rounds
// with a bf16 one-hot MXU einsum as the pointer jump, an (r, k, j)
// comparison cube for the size cap and einsums for the representative.
// This kernel computes what it computes, per row of C <= 64 candidate
// slots (x, y, theta, mask):
//   - adjacency: |p_j - p_k| < dist_thresh (and, with the orientation
//     gate, |theta_j - theta_k| < orient_rad), both slots in the mask,
//     plus the self-loop;
//   - `rounds` = ceil(log2 C) + 2 rounds of min-label propagation, each
//     followed by the pointer jump lab = min(lab, lab[lab]); slots out of
//     the mask take the label C. These rounds are JAX's result, not the
//     connected components: a chain of more than 8 members can end them
//     in more than one label (tests/cluster_cases.py `long_chains`);
//   - the size cap (0 < cap < C): each member ranks by its distance to its
//     label group's centroid, ties by slot index; members ranked >= cap
//     become singletons and the kept members take the least kept index of
//     their group;
//   - the Gaussian-weighted representative of each group: centre, mean
//     distance to it, weights exp(-0.5 ((d - mean) / sigma)^2), the
//     weighted x, y and theta, written at the slot whose label is its own
//     index; the (C, C) membership matrix M[r, j] = (lab_j == r) & m_j.
//
// What bounds it on the card: bytes. Every slot is read (13 B) and every
// output written (21 B a slot and C bytes of membership a slot), 69 MB at
// N = 32,768 rows of 32 (21 us at 3.35 TB/s). The work the function needs
// follows the active slots: ~31 flops a pair of active slots and ~6 an
// active slot (chip_smoke.py `k4_work`); at the main path's ~3.5 active
// slots a row that is ~0.02 GFLOP, far below the bytes.
//
// Design: one warp per row; slot j lives on lane j & 31 (two slots a lane
// when C > 32, the second in half 1 of each per-lane array, 64-bit slot
// masks). Every cross-slot step (the adjacency, each label round, the
// cap's centroid and rank, the representative's sums) walks the set bits
// of a slot mask that is the same on every lane, the row's active slots,
// each step one `__shfl_sync` from the slot's lane. A row with no active
// slot writes its outputs and does nothing else. Lane r holds label group
// r: its members as a slot mask, its sums. Loads are coalesced, and each
// lane writes its slot's membership row in 16-byte stores.
// (`scripts/k4_variants.py` times other forms of it.)
//
// Why the shortcuts keep the twin's result, bit for bit:
//   - Rounds over active slots only: a masked slot's adjacency is its
//     self-loop alone, so it enters no active slot's min and keeps its own
//     index; an active slot's label is always an active slot's index, so
//     the jump reads active labels only.
//   - A round that moves no label is a fixed point: the rounds after it
//     move none either, so the loop ends there.
//   - The cap: where no label group has more than `cap` members, every
//     rank is below the cap and all are kept, so the ranks are not formed.
//     The relabel still runs: where the rounds stopped short, a group can
//     lack the slot its label names, and then its least index moves it.
//   - The sums. The twin adds all C terms m_rj * v_j in
//     ascending j, the first as it is. A term whose weight is 0 is +-0 for
//     a finite v_j (the sign of v_j; distances and weights are >= +0).
//     Adding +-0 to a nonzero partial sum leaves it; a zero partial sum
//     stays a zero. So skipping such terms changes only the sign of a
//     zero, and the full fold's result is the fold of the kept terms
//     started at the zero the skipped terms fold to: -0 where all of them
//     are -0 (or there are none), else +0. Coordinates and theta may be
//     negative, so that zero is formed from the sign bits of the skipped
//     slots' values (a rule for +0 terms into sums >= +0 would not cover
//     it). Masked slots are skipped only in a row where every slot
//     holds a finite theta and |x|, |y| <= 2^62 and 1 / sigma is finite:
//     then every skipped term is finite (no centre, distance or weight
//     overflows to inf or NaN). Any other row adds all C slots' terms, so
//     NaN and inf poison it as they do in the twin.
//   - On such a row every term outside a group is +-0 (a weight of 0
//     times a finite value), so each active slot's distance to its own
//     group's centre, its weight and its weighted x, y and theta are
//     formed once, by its lane, and a group's sums add them times its 0/1
//     membership: the twin's terms for that group, bit for bit. Any other
//     row forms the twin's (group, slot) terms for every slot.
//
// Arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction) and IEEE divisions in the order of the plain twin
// `cluster_edges_plain`, one term after another in ascending slot order.
// The two agree bit for bit on the card.

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 4;            // rows a block, one warp each
constexpr unsigned kAll = 0xffffffffu;
constexpr float kBig = 0x1p62f;      // |x|, |y| that cannot overflow a sum

__device__ __forceinline__ int lowest(unsigned v) { return __ffs(v) - 1; }
__device__ __forceinline__ int lowest(unsigned long long v) {
  return __ffsll(v) - 1;
}
__device__ __forceinline__ int count(unsigned v) { return __popc(v); }
__device__ __forceinline__ int count(unsigned long long v) {
  return __popcll(v);
}

// value v of slot k (lane k & 31, half k >> 5); k the same on every lane
template <int H, typename T>
__device__ __forceinline__ T of_slot(const T (&v)[H], int k) {
  if constexpr (H == 1) return __shfl_sync(kAll, v[0], k);
  else return __shfl_sync(kAll, (k >> 5) ? v[1] : v[0], k & 31);
}

// value v of slot k, k per lane (0 <= k < 2 * 32 * H)
template <int H, typename T>
__device__ __forceinline__ T gather(const T (&v)[H], int k) {
  const T lo = __shfl_sync(kAll, v[0], k & 31);
  if constexpr (H == 1) return lo;
  else {
    const T hi = __shfl_sync(kAll, v[1], k & 31);
    return (k >> 5) ? hi : lo;
  }
}

// |(x, y) - (cx, cy)| in the twin's order: sqrt(dx*dx + dy*dy)
__device__ __forceinline__ float dist(float x, float y, float cx, float cy) {
  const float dx = __fsub_rn(x, cx), dy = __fsub_rn(y, cy);
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// 16 membership bytes (0/1) from bits [b, b + 16) of `bits`
template <typename Mask>
__device__ __forceinline__ uint4 bytes16(Mask bits, int b) {
  const unsigned v = (unsigned)(bits >> b);
  unsigned w[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const unsigned n = v >> (4 * q);
    w[q] = (n & 1u) | ((n >> 1) & 1u) << 8 | ((n >> 2) & 1u) << 16 |
           ((n >> 3) & 1u) << 24;
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// lane r, half h: the slots of `set` whose label is r + 32 h
template <int H, typename Mask>
__device__ __forceinline__ void groups(Mask set, const int (&lab)[H],
                                       int lane, Mask (&memb)[H]) {
#pragma unroll
  for (int h = 0; h < H; ++h) memb[h] = 0;
  for (Mask s = set; s; s &= s - 1) {
    const int k = lowest(s);
    const int lk = of_slot(lab, k);
#pragma unroll
    for (int h = 0; h < H; ++h)
      memb[h] |= (Mask)(lk == lane + 32 * h) << k;
  }
}

// lane r, half h: the centre of group r + 32 h, whose members are memb[h]:
// the twin's sums over the slots of S, started at zx and zy, divided by
// max(members, 1)
template <int H, typename Mask>
__device__ __forceinline__ void centres(Mask S, const Mask (&memb)[H],
                                        const float (&x)[H],
                                        const float (&y)[H], float zx,
                                        float zy, float (&cx)[H],
                                        float (&cy)[H]) {
#pragma unroll
  for (int h = 0; h < H; ++h) cx[h] = zx, cy[h] = zy;
  for (Mask s = S; s; s &= s - 1) {
    const int k = lowest(s);
    const float xk = of_slot(x, k), yk = of_slot(y, k);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      const float mf = (memb[h] >> k & 1) ? 1.f : 0.f;
      cx[h] = __fadd_rn(cx[h], __fmul_rn(mf, xk));
      cy[h] = __fadd_rn(cy[h], __fmul_rn(mf, yk));
    }
  }
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const float c = fmaxf((float)count(memb[h]), 1.f);
    cx[h] = __fdiv_rn(cx[h], c);
    cy[h] = __fdiv_rn(cy[h], c);
  }
}

// H slots a lane: C <= 32 H
template <int H>
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
  using Mask = std::conditional_t<H == 1, unsigned, unsigned long long>;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= N) return;                  // the whole warp leaves together
  float x[H], y[H], t[H];
  bool m[H];
  int lab[H];
  Mask act = 0, unbounded = 0, negx = 0, negy = 0, negt = 0;
#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int j = lane + 32 * h;
    const bool in = j < C;
    const long long at = row * C + j;
    x[h] = in ? xs[at] : 0.f;
    y[h] = in ? ys[at] : 0.f;
    t[h] = in ? ts[at] : 0.f;
    m[h] = in && ms[at] != 0;
    lab[h] = m[h] ? j : C;
    const bool fin = fabsf(x[h]) <= kBig && fabsf(y[h]) <= kBig &&
                     fabsf(t[h]) <= FLT_MAX;
    act |= (Mask)__ballot_sync(kAll, m[h]) << (32 * h);
    unbounded |= (Mask)__ballot_sync(kAll, in && !fin) << (32 * h);
    negx |= (Mask)__ballot_sync(kAll, in && signbit(x[h])) << (32 * h);
    negy |= (Mask)__ballot_sync(kAll, in && signbit(y[h])) << (32 * h);
    negt |= (Mask)__ballot_sync(kAll, in && signbit(t[h])) << (32 * h);
  }
  const Mask all = C == 8 * (int)sizeof(Mask) ? ~(Mask)0
                                              : ((Mask)1 << C) - 1;

  Mask memb[H];                          // lane r: the members of group r
  float gx[H], gy[H], gt[H], sw[H];
#pragma unroll
  for (int h = 0; h < H; ++h)
    memb[h] = 0, gx[h] = gy[h] = gt[h] = sw[h] = 0.f;
  if (act) {
    // adjacency of slot j to the active slots (its self-loop apart)
    Mask adj[H];
#pragma unroll
    for (int h = 0; h < H; ++h) adj[h] = 0;
    for (Mask s = act; s; s &= s - 1) {
      const int k = lowest(s);
      const float xk = of_slot(x, k), yk = of_slot(y, k);
      const float tk = by_orient ? of_slot(t, k) : 0.f;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        bool e = m[h] && dist(x[h], y[h], xk, yk) < thresh;
        if (by_orient) e = e && fabsf(__fsub_rn(t[h], tk)) < orient_rad;
        adj[h] |= (Mask)e << k;
      }
    }

    // min-label propagation, each round followed by the pointer jump
#pragma unroll
    for (int h = 0; h < H; ++h) lab[h] = lane + 32 * h;
    for (int r = 0; r < rounds; ++r) {
      int mn[H];
#pragma unroll
      for (int h = 0; h < H; ++h) mn[h] = lab[h];
      for (Mask s = act; s; s &= s - 1) {
        const int k = lowest(s);
        const int lk = of_slot(lab, k);
#pragma unroll
        for (int h = 0; h < H; ++h)
          if (adj[h] >> k & 1) mn[h] = min(mn[h], lk);
      }
      bool moved = false;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int jl = min(mn[h], gather(mn, mn[h]));
        moved |= jl != lab[h];
        lab[h] = jl;
      }
      if (!__any_sync(kAll, moved)) break;   // a fixed point
    }
#pragma unroll
    for (int h = 0; h < H; ++h) lab[h] = m[h] ? lab[h] : C;

    // the slots whose terms every sum adds: the active ones, or all C
    // where a skipped term could be inf or NaN; each sum starts at the
    // zero that the skipped slots' terms fold to (see the header)
    const bool plain = unbounded || !(fabsf(inv_sigma) <= FLT_MAX);
    const Mask S = plain ? all : act;
    const Mask out = all & ~S;
    const float zx = (out & ~negx) ? 0.f : -0.f;
    const float zy = (out & ~negy) ? 0.f : -0.f;
    const float zt = (out & ~negt) ? 0.f : -0.f;
    const float zp = out ? 0.f : -0.f;

    groups(act, lab, lane, memb);
    if (cap != 0 && cap < C) {
      int most = 0;
#pragma unroll
      for (int h = 0; h < H; ++h) most = max(most, count(memb[h]));
      bool kept[H];
#pragma unroll
      for (int h = 0; h < H; ++h) kept[h] = true;
      if (__reduce_max_sync(kAll, most) > cap) {
        // lane r: centroid of group r; lane j: its distance to its own
        float cx[H], cy[H], dc[H];
        centres(S, memb, x, y, zx, zy, cx, cy);
#pragma unroll
        for (int h = 0; h < H; ++h)
          dc[h] = dist(x[h], y[h], gather(cx, lab[h]), gather(cy, lab[h]));
        // rank of j in its group: members k with (dc_k, k) < (dc_j, j)
        int rank[H];
#pragma unroll
        for (int h = 0; h < H; ++h) rank[h] = 0;
        for (Mask s = act; s; s &= s - 1) {
          const int k = lowest(s);
          const float dk = of_slot(dc, k);
          const int lk = of_slot(lab, k);
#pragma unroll
          for (int h = 0; h < H; ++h)
            rank[h] += lk == lab[h] &&
                       (dk < dc[h] || (dk == dc[h] && k < lane + 32 * h));
        }
#pragma unroll
        for (int h = 0; h < H; ++h) kept[h] = rank[h] < cap;
      }
      // kept members take the least kept index of their group
      Mask kball = 0;
#pragma unroll
      for (int h = 0; h < H; ++h)
        kball |= (Mask)__ballot_sync(kAll, m[h] && kept[h]) << (32 * h);
      bool moved = false;
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const int core = lowest(gather(memb, lab[h]) & kball);
        const int nl = m[h] ? (kept[h] ? core : lane + 32 * h) : C;
        moved |= nl != lab[h];
        lab[h] = nl;
      }
      if (__any_sync(kAll, moved)) groups(act, lab, lane, memb);
    }

    // lane r: group r's centre, mean distance, weighted means
    float cx[H], cy[H], safe[H], mean[H];
    centres(S, memb, x, y, zx, zy, cx, cy);
#pragma unroll
    for (int h = 0; h < H; ++h) {
      safe[h] = fmaxf((float)count(memb[h]), 1.f);
      mean[h] = zp;
      sw[h] = zp, gx[h] = zx, gy[h] = zy, gt[h] = zt;
    }
    if (!plain) {
      // Every term outside group r is +-0 here, so slot j's distance,
      // weight and weighted values are formed once, by lane j, for its
      // own group: the twin's terms for that group, bit for bit.
      float d[H];
#pragma unroll
      for (int h = 0; h < H; ++h)
        d[h] = dist(x[h], y[h], gather(cx, lab[h]), gather(cy, lab[h]));
      for (Mask s = act; s; s &= s - 1) {
        const int k = lowest(s);
        const float dk = of_slot(d, k);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float mf = (memb[h] >> k & 1) ? 1.f : 0.f;
          mean[h] = __fadd_rn(mean[h], __fmul_rn(mf, dk));
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h) mean[h] = __fdiv_rn(mean[h], safe[h]);
      float w[H], wx[H], wy[H], wt[H];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        const float z = __fmul_rn(__fsub_rn(d[h], gather(mean, lab[h])),
                                  inv_sigma);
        w[h] = expf(__fmul_rn(-0.5f, __fmul_rn(z, z)));
        wx[h] = __fmul_rn(w[h], x[h]);
        wy[h] = __fmul_rn(w[h], y[h]);
        wt[h] = __fmul_rn(w[h], t[h]);
      }
      for (Mask s = act; s; s &= s - 1) {
        const int k = lowest(s);
        const float wk = of_slot(w, k), wxk = of_slot(wx, k);
        const float wyk = of_slot(wy, k), wtk = of_slot(wt, k);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float mf = (memb[h] >> k & 1) ? 1.f : 0.f;
          sw[h] = __fadd_rn(sw[h], __fmul_rn(mf, wk));
          gx[h] = __fadd_rn(gx[h], __fmul_rn(mf, wxk));
          gy[h] = __fadd_rn(gy[h], __fmul_rn(mf, wyk));
          gt[h] = __fadd_rn(gt[h], __fmul_rn(mf, wtk));
        }
      }
    } else {
      // the twin's (group, slot) terms, every slot's
      for (Mask s = S; s; s &= s - 1) {
        const int k = lowest(s);
        const float xk = of_slot(x, k), yk = of_slot(y, k);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float mf = (memb[h] >> k & 1) ? 1.f : 0.f;
          mean[h] = __fadd_rn(mean[h], __fmul_rn(mf, dist(xk, yk, cx[h],
                                                          cy[h])));
        }
      }
#pragma unroll
      for (int h = 0; h < H; ++h) mean[h] = __fdiv_rn(mean[h], safe[h]);
      for (Mask s = S; s; s &= s - 1) {
        const int k = lowest(s);
        const float xk = of_slot(x, k), yk = of_slot(y, k);
        const float tk = of_slot(t, k);
#pragma unroll
        for (int h = 0; h < H; ++h) {
          const float mf = (memb[h] >> k & 1) ? 1.f : 0.f;
          const float z = __fmul_rn(
              __fsub_rn(dist(xk, yk, cx[h], cy[h]), mean[h]), inv_sigma);
          const float w = __fmul_rn(
              expf(__fmul_rn(-0.5f, __fmul_rn(z, z))), mf);
          sw[h] = __fadd_rn(sw[h], w);
          gx[h] = __fadd_rn(gx[h], __fmul_rn(w, xk));
          gy[h] = __fadd_rn(gy[h], __fmul_rn(w, yk));
          gt[h] = __fadd_rn(gt[h], __fmul_rn(w, tk));
        }
      }
    }
  }

#pragma unroll
  for (int h = 0; h < H; ++h) {
    const int j = lane + 32 * h;
    if (j >= C) break;
    const long long at = row * C + j;
    const bool rep = m[h] && lab[h] == j;
    if (rep) {
      const float s = isnan(sw[h]) ? sw[h] : fmaxf(sw[h], 1e-12f);
      ox[at] = __fdiv_rn(gx[h], s);
      oy[at] = __fdiv_rn(gy[h], s);
      ot[at] = __fdiv_rn(gt[h], s);
    } else {
      ox[at] = oy[at] = ot[at] = 0.f;
    }
    omask[at] = rep;
    olabel[at] = lab[h];
    unsigned char* mrow = omembers + at * C;
    if ((C & 15) == 0) {                     // rows of 16-byte multiples
      for (int b = 0; b < C; b += 16)
        *reinterpret_cast<uint4*>(mrow + b) = bytes16(memb[h], b);
    } else {
      for (int k = 0; k < C; ++k) mrow[k] = memb[h] >> k & 1;
    }
  }
}

}  // namespace

// x, y, theta (N, C) float32, mask (N, C) bool, C <= 64; outputs x, y,
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
  if (C > 64) return (int)cudaErrorInvalidValue;
  const int blocks = (N + kWarps - 1) / kWarps;
  if (C > 32)
    cluster_edges_kernel<2><<<blocks, kWarps * 32, 0, stream>>>(
        x, y, theta, mask, N, C, thresh, by_orient, orient_rad, inv_sigma,
        cap, rounds, ox, oy, ot, omask, olabel, omembers);
  else
    cluster_edges_kernel<1><<<blocks, kWarps * 32, 0, stream>>>(
        x, y, theta, mask, N, C, thresh, by_orient, orient_rad, inv_sigma,
        cap, rounds, ox, oy, ot, omask, olabel, omembers);
  return (int)cudaGetLastError();
}
