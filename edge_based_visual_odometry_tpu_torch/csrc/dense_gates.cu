// The dense NCC and descriptor gates on Hopper (sm_90a): kernel K6.
//
// Replaces edge_based_visual_odometry_tpu/ops/patches.py:186 `ncc4` and
// ops/descriptors.py:205 `min_cross_distance_dot` where the cascades call
// them densely: the stereo cascade's stages 4-5
// (models/stereo_matcher.py:486-591) and stage 11, and the temporal
// cascade's NCC and descriptor gates (models/temporal_matcher.py:279-372).
// On the TPU these are XLA formulations, not `pallas_call`s: row gathers
// of the candidates' patches and descriptors into (N, C, .) tensors, then
// reductions and an MXU einsum. This kernel computes, per live (row, slot)
// pair:
//   - the NCC gate: the max over the 4 side pairings (A+,B+), (A-,B-),
//     (A+,B-), (A-,B+) of the NCC of two P x P patches, each pairing -1
//     where a side is degenerate (sum of squares < 1e-10) or not ok;
//   - the descriptor gate: the min over the 4 cross L2 distances of two
//     2 x 128 bf16 descriptors, sqrt(max(min(|a|^2 + |b|^2 - 2 a.b), 0)).
// Three entries share the two device functions:
//   - stereo (stages 4-5): the distance on the live slots of the mask,
//     the SIFT gate (< sift_threshold), then the NCC on its survivors
//     only; (N, C) distances and scores;
//   - temporal: for both sides, the NCC against the CF mate's patches,
//     read from a bf16 table, and the distance, on the live slots; (4, M,
//     C) [left NCC, right NCC, left distance, right distance];
//   - flat (stage 11): the NCC of a flat list of (left row, right patch)
//     pairs.
// A slot that is not computed gets the fill value the caller passes: the
// value its state held before the stage.
//
// What bounds it on the card (chip_smoke.py `k6_work`): the work the
// function needs over the live pairs. Bytes: the mask and the outputs in
// full, the index of each live slot and each table row a live pair reads,
// once. Flops: a descriptor's |a|^2 (510) and a patch side's centring
// (195 at P = 7) once a row and once a distinct candidate row; a pair's
// cross dots and distance (1,033) and an NCC's 4 pairings (400). With
// every slot of the stereo call's 32,768 x 32 live and every table row
// read, that is ~77 MB and ~1.6 GFLOP, ~23 us either way; the main
// path's calls have a few live slots a row. The kernel forms a
// candidate's |b|^2 and centring again for each pair that reads it, work
// the bound does not count.
//
// Design: one warp a row (the flat entry: one warp two pairs). The row's
// live slots are a 64-bit ballot of the mask, and the warp walks only
// those, in ascending order, two a step: one slot a half-warp. A row's own
// terms are formed once: its descriptor's halves and |a|^2, its patches
// mean-centred with their sums of squares. Per slot, lane h of a half
// reads chunk h of each half of the candidate's 512-byte descriptor (two
// 16-byte loads) and samples h, h + 16, h + 32, h + 48 of each patch side,
// through L2, which holds the right tables. Every sum keeps the twin's
// order: a descriptor half is a lane's 8 products in order, then a
// butterfly over 16 lanes; a patch side is the 32-lane order of the twin
// (lane s % 32 adds samples s and s + 32, then a butterfly), whose first
// level (lanes h and h + 16) lane h adds itself before its 16-lane
// butterfly. Lane c % 32 keeps slot c's results, and the row's outputs
// are written once, coalesced. No shared memory, no atomics. (The first
// form, one slot a full warp with two samples a side a lane, took 1.30 ms
// for the temporal call, this one 0.73: PERF.md.)
//
// Arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction), the mean as a multiply by the float32 reciprocal of P^2,
// torch's NaN rules for max, min and clamp, in the order of the plain
// twins `dense_gates_*_plain` (ops/patches.py: `_lane_sum`, `_half_dot`),
// so kernel and twin agree bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

using gn::add;
using gn::mul;
using gn::sub;

constexpr int kWarps = 8;            // rows (flat: pairs of pairs) a block
constexpr unsigned kFull = 0xffffffffu;

// torch.maximum / torch.minimum on the card: a NaN operand is the result
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : b != b ? b : fmaxf(a, b);
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : b != b ? b : fminf(a, b);
}
// torch.clamp(v, min=lo): a NaN stays NaN
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

// a butterfly over the 16 lanes of a half-warp
__device__ __forceinline__ float sum16(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = add(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// ---- patches: lane h of a half holds samples h, h + 16, h + 32, h + 48
// of each side ----

struct Side {
  float v[4], ss;                    // centred samples, sum of squares
};

struct Patch {
  Side p, m;                         // plus, minus
  bool okp, okm;
};

struct Gate {
  int pp;                            // P * P <= 64 samples a side
  float inv_pp, eps, eps2;
};

// a lane's share of a side sum: the twin's lane s % 32 adds samples s and
// s + 32, and its butterfly's first level adds lanes h and h + 16, so lane
// h's part is (x[h] + x[h + 32]) + (x[h + 16] + x[h + 48])
__device__ __forceinline__ float fold4(const float v[4]) {
  return add(add(v[0], v[2]), add(v[1], v[3]));
}

// a side's samples minus their mean, and its sum of squares (the twin's
// `_centred`); samples past P^2 are 0 and stay 0
__device__ __forceinline__ Side centre(const float x[4], const bool has[4],
                                       float inv_pp) {
  const float mean = mul(sum16(fold4(x)), inv_pp);
  Side s;
  float sq[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    s.v[k] = has[k] ? sub(x[k], mean) : 0.0f;
    sq[k] = mul(s.v[k], s.v[k]);
  }
  s.ss = sum16(fold4(sq));
  return s;
}

template <typename T>
__device__ __forceinline__ float as_float(T v);
template <>
__device__ __forceinline__ float as_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ float as_float<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// FLAT [plus | minus] patches of float32 (or bf16) at `row`, with its two
// ok flags, mean-centred
template <typename T>
__device__ __forceinline__ Patch load_patch(const T* __restrict__ row,
                                            const uint8_t* __restrict__ ok,
                                            const Gate& g, int h) {
  bool has[4];
  float pv[4], mv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int s = h + 16 * k;
    has[k] = s < g.pp;
    pv[k] = has[k] ? as_float<T>(row[s]) : 0.0f;
    mv[k] = has[k] ? as_float<T>(row[g.pp + s]) : 0.0f;
  }
  Patch p;
  p.p = centre(pv, has, g.inv_pp);
  p.m = centre(mv, has, g.inv_pp);
  p.okp = ok[0] != 0;
  p.okm = ok[1] != 0;
  return p;
}

// `ncc` of two centred sides (the twin's `_ncc_lanes`)
__device__ __forceinline__ float ncc1(const Side& a, const Side& b, bool ok,
                                      const Gate& g) {
  float pr[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) pr[k] = mul(a.v[k], b.v[k]);
  const float cross = sum16(fold4(pr));
  const float score =
      __fdiv_rn(cross, sqrtf(clamp_min(mul(a.ss, b.ss), g.eps2)));
  return (a.ss < g.eps || b.ss < g.eps || !ok) ? -1.0f : score;
}

// the NCC gate: the max of the 4 side pairings (`ncc4_lanes`)
__device__ __forceinline__ float ncc4(const Patch& a, const Patch& b,
                                      const Gate& g) {
  const float s_pp = ncc1(a.p, b.p, a.okp && b.okp, g);
  const float s_nn = ncc1(a.m, b.m, a.okm && b.okm, g);
  const float s_pn = ncc1(a.p, b.m, a.okp && b.okm, g);
  const float s_np = ncc1(a.m, b.p, a.okm && b.okp, g);
  return tmax(tmax(s_pp, s_nn), tmax(s_pn, s_np));
}

// ---- descriptors: 256 bf16 [plus | minus] as 32 uint4; lane h of a
// half holds bins 8 h .. 8 h + 7 of each half (chunk h) ----

__device__ __forceinline__ void unpack8(const uint4 u, float v[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// a chunk's dot in the twin's `_half_dot` order: its 8 products in order
__device__ __forceinline__ float dot8(const float a[8], const float b[8]) {
  float s = mul(a[0], b[0]);
#pragma unroll
  for (int t = 1; t < 8; ++t) s = add(s, mul(a[t], b[t]));
  return s;
}

// a row's descriptor and its halves' |a|^2
struct Desc {
  float p[8], m[8];
  float a2p, a2m;
};

__device__ __forceinline__ Desc load_desc(const uint4* __restrict__ row,
                                          int h) {
  Desc d;
  unpack8(__ldg(row + h), d.p);
  unpack8(__ldg(row + 16 + h), d.m);
  d.a2p = sum16(dot8(d.p, d.p));
  d.a2m = sum16(dot8(d.m, d.m));
  return d;
}

__device__ __forceinline__ float d2(float a2, float b2, float ab) {
  return sub(add(a2, b2), mul(2.0f, ab));
}

// the descriptor gate against the candidate descriptor at `row`
// (`desc_distance_lanes`)
__device__ __forceinline__ float desc_distance(const Desc& a,
                                               const uint4* __restrict__ row,
                                               int h) {
  float bp[8], bm[8];
  unpack8(__ldg(row + h), bp);
  unpack8(__ldg(row + 16 + h), bm);
  const float xp = sum16(dot8(a.p, bp)), xm = sum16(dot8(a.p, bm));
  const float yp = sum16(dot8(a.m, bp)), ym = sum16(dot8(a.m, bm));
  const float zp = sum16(dot8(bp, bp)), zm = sum16(dot8(bm, bm));
  const float pp = d2(a.a2p, zp, xp), pm = d2(a.a2p, zm, xm);
  const float mp = d2(a.a2m, zp, yp), mm = d2(a.a2m, zm, ym);
  return sqrtf(clamp_min(tmin(tmin(pp, pm), tmin(mp, mm)), 0.0f));
}

// ---- a row's slots ----

// the row's live slots (c < C <= 64) as a 64-bit mask, and the candidate
// index of slot lane / lane + 32 on each lane
__device__ __forceinline__ uint64_t live_slots(
    const uint8_t* __restrict__ mask, const long long* __restrict__ idx,
    int C, int lane, long long* j0, long long* j1) {
  const bool m0 = lane < C && mask[lane] != 0;
  const bool m1 = lane + 32 < C && mask[lane + 32] != 0;
  *j0 = m0 ? idx[lane] : 0;
  *j1 = m1 ? idx[lane + 32] : 0;
  return (uint64_t)__ballot_sync(kFull, m0)
         | ((uint64_t)__ballot_sync(kFull, m1) << 32);
}

// a row's outputs: lane l keeps slot l in `lo` and slot l + 32 in `hi`
struct Slots2 {
  float lo, hi;
};

__device__ __forceinline__ void keep(Slots2& v, int c, int lane, float x) {
  if (lane == (c & 31)) {
    if (c < 32) v.lo = x;
    else v.hi = x;
  }
}

__device__ __forceinline__ void store_row(float* __restrict__ out, int C,
                                          int lane, const Slots2& v) {
  if (lane < C) out[lane] = v.lo;
  if (lane + 32 < C) out[lane + 32] = v.hi;
}

// Two slots of a set a warp step: slot c0 on lanes 0-15, c1 on lanes
// 16-31 (c1 = -1 when none is left: that half repeats c0 and its results
// are unused). `slot` is this lane's slot and `j` its candidate index.
struct Step {
  int c0, c1, slot;
  long long j;
};

__device__ __forceinline__ Step next_two(uint64_t& m, int lane, long long j0,
                                         long long j1) {
  Step s;
  s.c0 = __ffsll((long long)m) - 1;
  m &= m - 1;
  s.c1 = m ? __ffsll((long long)m) - 1 : -1;
  if (m) m &= m - 1;
  s.slot = (lane >= 16 && s.c1 >= 0) ? s.c1 : s.c0;
  const long long ja = __shfl_sync(kFull, j0, s.slot & 31);
  const long long jb = __shfl_sync(kFull, j1, s.slot & 31);
  s.j = s.slot < 32 ? ja : jb;
  return s;
}

// lane c % 32 keeps slot c's result, from lane 0 (c0) or lane 16 (c1);
// returns the two results
__device__ __forceinline__ float2 put(Slots2& o, const Step& s, int lane,
                                      float x) {
  const float x0 = __shfl_sync(kFull, x, 0);
  const float x1 = __shfl_sync(kFull, x, 16);
  keep(o, s.c0, lane, x0);
  if (s.c1 >= 0) keep(o, s.c1, lane, x1);
  return make_float2(x0, x1);
}

struct StereoParams {
  const uint4 *l_desc, *r_desc;      // (N, 32), (Nr, 32) uint4: 256 bf16
  const long long* cand;             // (N, C)
  const uint8_t* cmask;              // (N, C)
  int N, C;
  const float *l_pat, *r_pat;        // (N, 2pp), (Nr, 2pp)
  const uint8_t *l_ok, *r_ok;        // (N, 2), (Nr, 2)
  Gate g;
  float sift, fill_dist, fill_ncc;
  float *dist, *ncc;                 // (N, C) each
};

__global__ void __launch_bounds__(kWarps * 32)
dense_gates_stereo_kernel(const StereoParams p) {
  const int lane = threadIdx.x & 31, h = lane & 15;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= p.N) return;              // whole warps only
  const size_t base = (size_t)i * p.C;
  long long j0, j1;
  const uint64_t live =
      live_slots(p.cmask + base, p.cand + base, p.C, lane, &j0, &j1);
  Slots2 dist{p.fill_dist, p.fill_dist}, ncc{p.fill_ncc, p.fill_ncc};
  if (live) {
    // stage 4: the descriptor distance of every live slot, the SIFT gate
    const Desc a = load_desc(p.l_desc + (size_t)i * 32, h);
    uint64_t pass = 0;
    for (uint64_t m = live; m;) {
      const Step s = next_two(m, lane, j0, j1);
      const float2 d = put(dist, s, lane,
                           desc_distance(a, p.r_desc + (size_t)s.j * 32, h));
      if (d.x < p.sift) pass |= 1ull << s.c0;
      if (s.c1 >= 0 && d.y < p.sift) pass |= 1ull << s.c1;
    }
    // stage 5: the NCC of the survivors
    if (pass) {
      const int two = 2 * p.g.pp;
      const Patch l = load_patch(p.l_pat + (size_t)i * two,
                                 p.l_ok + 2 * (size_t)i, p.g, h);
      for (uint64_t m = pass; m;) {
        const Step s = next_two(m, lane, j0, j1);
        const Patch r = load_patch(p.r_pat + (size_t)s.j * two,
                                   p.r_ok + 2 * (size_t)s.j, p.g, h);
        put(ncc, s, lane, ncc4(l, r, p.g));
      }
    }
  }
  store_row(p.dist + base, p.C, lane, dist);
  store_row(p.ncc + base, p.C, lane, ncc);
}

struct TemporalParams {
  const float *kf_pat_l, *kf_pat_r;  // (M, 2pp) each
  const uint8_t *kf_ok_l, *kf_ok_r;  // (M, 2) each
  const uint4 *kf_desc_l, *kf_desc_r;  // (M, 32) uint4 each
  const __nv_bfloat16* cf_pat;       // (Mc, 4pp) [left | right]
  const uint8_t* cf_ok;              // (Mc, 4)
  const uint4* cf_desc;              // (Mc, 64) uint4: [left | right]
  const long long* cf_idx;           // (M, C)
  const uint8_t* cmask;              // (M, C)
  int M, C;
  Gate g;
  float fill_ncc, fill_dist;
  float* out;                        // (4, M, C)
};

__global__ void __launch_bounds__(kWarps * 32)
dense_gates_temporal_kernel(const TemporalParams p) {
  const int lane = threadIdx.x & 31, h = lane & 15;
  const int i = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (i >= p.M) return;              // whole warps only
  const size_t base = (size_t)i * p.C;
  long long j0, j1;
  const uint64_t live =
      live_slots(p.cmask + base, p.cf_idx + base, p.C, lane, &j0, &j1);
  Slots2 nl{p.fill_ncc, p.fill_ncc}, nr{p.fill_ncc, p.fill_ncc};
  Slots2 dl{p.fill_dist, p.fill_dist}, dr{p.fill_dist, p.fill_dist};
  if (live) {
    const int two = 2 * p.g.pp;
    const Patch kl = load_patch(p.kf_pat_l + (size_t)i * two,
                                p.kf_ok_l + 2 * (size_t)i, p.g, h);
    const Patch kr = load_patch(p.kf_pat_r + (size_t)i * two,
                                p.kf_ok_r + 2 * (size_t)i, p.g, h);
    const Desc al = load_desc(p.kf_desc_l + (size_t)i * 32, h);
    const Desc ar = load_desc(p.kf_desc_r + (size_t)i * 32, h);
    for (uint64_t m = live; m;) {
      const Step s = next_two(m, lane, j0, j1);
      const __nv_bfloat16* cp = p.cf_pat + (size_t)s.j * 2 * two;
      const uint8_t* cok = p.cf_ok + 4 * (size_t)s.j;
      const uint4* cd = p.cf_desc + (size_t)s.j * 64;
      put(nl, s, lane, ncc4(kl, load_patch(cp, cok, p.g, h), p.g));
      put(nr, s, lane, ncc4(kr, load_patch(cp + two, cok + 2, p.g, h), p.g));
      put(dl, s, lane, desc_distance(al, cd, h));
      put(dr, s, lane, desc_distance(ar, cd + 32, h));
    }
  }
  const size_t plane = (size_t)p.M * p.C;
  store_row(p.out + base, p.C, lane, nl);
  store_row(p.out + plane + base, p.C, lane, nr);
  store_row(p.out + 2 * plane + base, p.C, lane, dl);
  store_row(p.out + 3 * plane + base, p.C, lane, dr);
}

struct FlatParams {
  const float* l_pat;                // (N, 2pp)
  const uint8_t* l_ok;               // (N, 2)
  const long long* rows;             // (F,)
  const float* r_pat;                // (F, 2pp)
  const uint8_t *r_ok, *live;        // (F, 2), (F,)
  int F;
  Gate g;
  float fill;
  float* out;                        // (F,)
};

// one pair a half-warp
__global__ void __launch_bounds__(kWarps * 32)
dense_gates_flat_kernel(const FlatParams p) {
  const int lane = threadIdx.x & 31, h = lane & 15;
  const int f0 = 2 * (blockIdx.x * kWarps + (threadIdx.x >> 5));
  if (f0 >= p.F) return;             // whole warps only
  const int f = min(f0 + (lane >> 4), p.F - 1);
  const bool mine = f0 + (lane >> 4) < p.F;
  float s = p.fill;
  // both halves run the same steps (their butterflies stay in step); a
  // half whose pair is not live computes and drops its NCC
  if (__any_sync(kFull, mine && p.live[f])) {
    const int two = 2 * p.g.pp;
    const long long r = p.rows[f];
    const Patch l = load_patch(p.l_pat + (size_t)r * two,
                               p.l_ok + 2 * (size_t)r, p.g, h);
    const Patch b = load_patch(p.r_pat + (size_t)f * two,
                               p.r_ok + 2 * (size_t)f, p.g, h);
    const float x = ncc4(l, b, p.g);
    if (p.live[f]) s = x;
  }
  if (h == 0 && mine) p.out[f] = s;
}

__host__ inline Gate make_gate(int P, float inv_pp, float eps, float eps2) {
  return Gate{P * P, inv_pp, eps, eps2};
}

__host__ inline bool bad_gate(int P) {
  return P <= 0 || P * P > 64;
}

__host__ inline unsigned blocks(int n) {
  return (unsigned)((n + kWarps - 1) / kWarps);
}

}  // namespace

extern "C" int dense_gates_stereo_launch(
    const void* l_desc, const void* r_desc, const long long* cand,
    const uint8_t* cmask, int N, int C, const float* l_pat,
    const uint8_t* l_ok, const float* r_pat, const uint8_t* r_ok, int P,
    float sift, float inv_pp, float eps, float eps2, float fill_dist,
    float fill_ncc, float* out, cudaStream_t stream) {
  if (N <= 0 || C <= 0) return (int)cudaGetLastError();
  if (C > 64 || bad_gate(P)) return (int)cudaErrorInvalidValue;
  const size_t plane = (size_t)N * C;
  StereoParams p{static_cast<const uint4*>(l_desc),
                 static_cast<const uint4*>(r_desc),
                 cand, cmask, N, C, l_pat, r_pat, l_ok, r_ok,
                 make_gate(P, inv_pp, eps, eps2), sift, fill_dist, fill_ncc,
                 out, out + plane};
  dense_gates_stereo_kernel<<<blocks(N), kWarps * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int dense_gates_temporal_launch(
    const float* kf_pat_l, const uint8_t* kf_ok_l, const float* kf_pat_r,
    const uint8_t* kf_ok_r, const void* kf_desc_l, const void* kf_desc_r,
    const void* cf_pat, const uint8_t* cf_ok, const void* cf_desc,
    const long long* cf_idx, const uint8_t* cmask, int M, int C, int P,
    float inv_pp, float eps, float eps2, float fill_ncc, float fill_dist,
    float* out, cudaStream_t stream) {
  if (M <= 0 || C <= 0) return (int)cudaGetLastError();
  if (C > 64 || bad_gate(P)) return (int)cudaErrorInvalidValue;
  TemporalParams p{kf_pat_l, kf_pat_r, kf_ok_l, kf_ok_r,
                   static_cast<const uint4*>(kf_desc_l),
                   static_cast<const uint4*>(kf_desc_r),
                   static_cast<const __nv_bfloat16*>(cf_pat), cf_ok,
                   static_cast<const uint4*>(cf_desc), cf_idx, cmask, M, C,
                   make_gate(P, inv_pp, eps, eps2), fill_ncc, fill_dist,
                   out};
  dense_gates_temporal_kernel<<<blocks(M), kWarps * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

extern "C" int dense_gates_flat_launch(
    const float* l_pat, const uint8_t* l_ok, const long long* rows,
    const float* r_pat, const uint8_t* r_ok, const uint8_t* live, int F,
    int P, float inv_pp, float eps, float eps2, float fill, float* out,
    cudaStream_t stream) {
  if (F <= 0) return (int)cudaGetLastError();
  if (bad_gate(P)) return (int)cudaErrorInvalidValue;
  FlatParams p{l_pat, l_ok, rows, r_pat, r_ok, live, F,
               make_gate(P, inv_pp, eps, eps2), fill, out};
  dense_gates_flat_kernel<<<blocks((F + 1) / 2), kWarps * 32, 0, stream>>>(
      p);
  return (int)cudaGetLastError();
}
