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
// Three entries:
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
// cross dots and distance (1,033) and an NCC's 4 pairings (400).
//
// Design. The stereo and temporal entries launch two kernels:
//   1. a prep pass over the candidate table (the right table, the CF
//      table): per row and side, the patch sides' means and sums of
//      squares of centred samples and the descriptor halves' |b|^2, with
//      the device functions of the row terms (`load_patch`, `load_desc`),
//      into 32 (stereo) or 48 (temporal) bytes a row. A candidate row is
//      read by ~6 (stereo) or ~28 (temporal) live slots; the pair loop
//      forms none of these terms again, and centres a candidate sample
//      with one subtraction of the stored mean (the bits `centre` gives);
//   2. the gates: one warp a row. The row's own terms (its centred
//      patches, its descriptor as float) are formed once into the warp's
//      shared memory, which every lane then reads by broadcast; the row's
//      live slots are compacted into a list there, and the warp walks it
//      kSlots slots a step, kLanes = 32 / kSlots lanes a slot. A lane
//      holds the leaves of a sum congruent to it modulo kLanes and adds
//      them in the twin's butterfly order (`lane_tree`: the levels above
//      kLanes taken inside the lane, depth first), then the slot's lanes
//      finish with a kLanes-lane butterfly. The four cross sums of a
//      pairing (NCC) or of a descriptor pair share their leaves and their
//      butterfly; lane k < 4 of a slot scores NCC pairing k (one division
//      and square root a lane). The stereo entry takes a live slot's
//      distance and NCC in the same step and keeps the NCC where the
//      distance passes the SIFT gate. A slot's results go to the warp's
//      output row in shared memory, which starts as the fills and is
//      stored once, coalesced. (kSlots = 8: 2, 4 and 32 were slower, one
//      lane a slot by 1.9x on the temporal call; scripts/k6_variants.py.)
// The flat entry keeps one pair a half-warp (its right patches are read
// once each). (The first form, one slot a warp, took 1.30 ms for frame
// 2's temporal call, the half-warp form 0.73: PERF.md.)
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
constexpr int kSlots = 8;            // live slots a warp step: 2, 4, 8, 32
constexpr int kLanes = 32 / kSlots;  // lanes a slot
// A patch side's P^2 samples on the 32 lanes of the twin's `_lane_sum`, S
// a lane (sample s on lane s % 32, slot s // 32): S = 2 for P^2 <= 64 (P
// <= 7), S = 4 for P^2 <= 128 (P = 9, 11). Every kernel that reads a
// patch is compiled for both; the S = 2 instances are the kernels as they
// were before P = 9 and 11 were taken.
constexpr int kMaxSide = 128;        // P^2 samples a side
__host__ __device__ constexpr int side_slots(int pp) { return pp <= 64 ? 2 : 4; }
constexpr unsigned kFull = 0xffffffffu;

static_assert(kSlots >= 2 && kSlots <= 32 && (kSlots & (kSlots - 1)) == 0,
              "kSlots: a power of two from 2 to 32");

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

// ---- the sums' order with kLanes lanes a slot ----

// Four sums that share their leaves: the 4 side pairings of an NCC, the 4
// cross dots of a descriptor pair.
struct F4 {
  float a, b, c, d;
};

__device__ __forceinline__ F4 add(const F4& x, const F4& y) {
  return F4{add(x.a, y.a), add(x.b, y.b), add(x.c, y.c), add(x.d, y.d)};
}

template <int V>
struct Int {
  static constexpr int value = V;
};

// The twin's butterfly over N leaves (leaf l on lane l; level o adds
// lanes l and l + o, o = N/2 .. 1), split at kLanes: a lane holds the
// T = N / kLanes leaves l = h + kLanes t of its residue h and adds them
// as the levels o >= kLanes would (t with t + T/2 first, ...), then the
// slot's lanes run the levels below (`slot_sum`). node(t, M) covers the
// leaves t mod M: node(t, M) = node(t, 2M) + node(t + M, 2M), leaf(t) at
// M = T. The walk is depth first: the leaves are visited in bit-reversed
// order and at most log2(T) + 1 partials are live at a time.
template <int T, int M, int I, class Leaf>
__device__ __forceinline__ auto lane_tree(const Leaf& leaf) {
  if constexpr (M == T) {
    return leaf(Int<I>{});
  } else {
    return add(lane_tree<T, 2 * M, I>(leaf), lane_tree<T, 2 * M, I + M>(leaf));
  }
}

__device__ __forceinline__ float slot_sum(float v) {
#pragma unroll
  for (int o = kLanes / 2; o > 0; o >>= 1)
    v = add(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ F4 slot_sum(F4 v) {
  return F4{slot_sum(v.a), slot_sum(v.b), slot_sum(v.c), slot_sum(v.d)};
}

// ---- patches: lane h of a half holds samples h + 16 k, k < 2 S, of
// each side ----

template <int S>
struct Side {
  float v[2 * S], ss, mean;          // centred samples, sum of squares
};

template <int S>
struct Patch {
  Side<S> p, m;                      // plus, minus
  bool okp, okm;
};

struct Gate {
  int pp;                            // P * P <= 128 samples a side
  float inv_pp, eps, eps2;
};

// a lane's share of a side sum: the twin's lane l adds samples l + 32 j,
// j < S, in order, and its butterfly's first level adds lanes h and
// h + 16, so lane h's part is the in-order sum of x[h + 32 j] (v[2 j])
// plus that of x[h + 16 + 32 j] (v[2 j + 1]); at S = 2,
// (x[h] + x[h + 32]) + (x[h + 16] + x[h + 48])
template <int S>
__device__ __forceinline__ float fold(const float v[2 * S]) {
  float a = add(v[0], v[2]), b = add(v[1], v[3]);
#pragma unroll
  for (int j = 2; j < S; ++j) {
    a = add(a, v[2 * j]);
    b = add(b, v[2 * j + 1]);
  }
  return add(a, b);
}

// a side's samples minus their mean, and its sum of squares (the twin's
// `_centred`); samples past P^2 are 0 and stay 0
template <int S>
__device__ __forceinline__ Side<S> centre(const float x[2 * S],
                                          const bool has[2 * S],
                                          float inv_pp) {
  Side<S> s;
  s.mean = mul(sum16(fold<S>(x)), inv_pp);
  float sq[2 * S];
#pragma unroll
  for (int k = 0; k < 2 * S; ++k) {
    s.v[k] = has[k] ? sub(x[k], s.mean) : 0.0f;
    sq[k] = mul(s.v[k], s.v[k]);
  }
  s.ss = sum16(fold<S>(sq));
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
template <int S, typename T>
__device__ __forceinline__ Patch<S> load_patch(const T* __restrict__ row,
                                               const uint8_t* __restrict__ ok,
                                               const Gate& g, int h) {
  bool has[2 * S];
  float pv[2 * S], mv[2 * S];
#pragma unroll
  for (int k = 0; k < 2 * S; ++k) {
    const int s = h + 16 * k;
    has[k] = s < g.pp;
    pv[k] = has[k] ? as_float<T>(row[s]) : 0.0f;
    mv[k] = has[k] ? as_float<T>(row[g.pp + s]) : 0.0f;
  }
  Patch<S> p;
  p.p = centre<S>(pv, has, g.inv_pp);
  p.m = centre<S>(mv, has, g.inv_pp);
  p.okp = ok[0] != 0;
  p.okm = ok[1] != 0;
  return p;
}

// `ncc` of two centred sides (the twin's `_ncc_lanes`) from their cross
// sum and sums of squares
__device__ __forceinline__ float ncc_score(float cross, float ssa, float ssb,
                                           bool ok, const Gate& g) {
  const float score =
      __fdiv_rn(cross, sqrtf(clamp_min(mul(ssa, ssb), g.eps2)));
  return (ssa < g.eps || ssb < g.eps || !ok) ? -1.0f : score;
}

template <int S>
__device__ __forceinline__ float ncc1(const Side<S>& a, const Side<S>& b,
                                      bool ok, const Gate& g) {
  float pr[2 * S];
#pragma unroll
  for (int k = 0; k < 2 * S; ++k) pr[k] = mul(a.v[k], b.v[k]);
  return ncc_score(sum16(fold<S>(pr)), a.ss, b.ss, ok, g);
}

// the NCC gate: the max of the 4 side pairings (`ncc4_lanes`)
__device__ __forceinline__ float max4(const F4& s) {
  return tmax(tmax(s.a, s.b), tmax(s.c, s.d));
}

template <int S>
__device__ __forceinline__ float ncc4(const Patch<S>& a, const Patch<S>& b,
                                      const Gate& g) {
  return max4(F4{ncc1(a.p, b.p, a.okp && b.okp, g),
                 ncc1(a.m, b.m, a.okm && b.okm, g),
                 ncc1(a.p, b.m, a.okp && b.okm, g),
                 ncc1(a.m, b.p, a.okm && b.okp, g)});
}

// ---- descriptors: 256 bf16 [plus | minus] as 32 uint4; chunk q of a
// half (bins 8 q .. 8 q + 7) is uint4 q ----

__device__ __forceinline__ void unpack8(const uint4 u, float v[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v[2 * k] = __uint_as_float(w[k] << 16);
    v[2 * k + 1] = __uint_as_float(w[k] & 0xffff0000u);
  }
}

// a chunk's dot in the twin's `_half_dot` order: its 8 products in order
__device__ __forceinline__ float dot8(const float* a, const float* b) {
  float s = mul(a[0], b[0]);
#pragma unroll
  for (int t = 1; t < 8; ++t) s = add(s, mul(a[t], b[t]));
  return s;
}

// a descriptor's halves (lane h of a half-warp: chunk h) and their |a|^2
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

// the min of the 4 cross distances (`desc_distance_lanes`)
__device__ __forceinline__ float distance(float a2p, float a2m, float zp,
                                          float zm, const F4& x) {
  const float pp = d2(a2p, zp, x.a), pm = d2(a2p, zm, x.b);
  const float mp = d2(a2m, zp, x.c), mm = d2(a2m, zm, x.d);
  return sqrtf(clamp_min(tmin(tmin(pp, pm), tmin(mp, mm)), 0.0f));
}

// ---- a table's terms, formed once a row by the prep pass ----

// floats a row of the terms table with S sides: S x {mean+, ss+, mean-,
// ss-}, then S x {|b+|^2, |b-|^2}, padded to 16 bytes
__host__ __device__ constexpr int terms_stride(int S) {
  return S == 1 ? 8 : 12;
}

// One half-warp a (row, side) of the table: S sides a row, each a FLAT
// [plus | minus] patch (L samples a lane of a side) and a 32-uint4
// descriptor.
template <typename T, int L>
__global__ void __launch_bounds__(kWarps * 32)
dense_gates_prep_kernel(const T* __restrict__ pat,
                        const uint4* __restrict__ desc, int R, int S,
                        const Gate g, float* __restrict__ terms) {
  const int lane = threadIdx.x & 31, h = lane & 15;
  const int u0 = 2 * (blockIdx.x * kWarps + (threadIdx.x >> 5));
  const int total = R * S;
  if (u0 >= total) return;           // whole warps only
  const int u = min(u0 + (lane >> 4), total - 1);
  const int row = u / S, side = u - row * S;
  const int two = 2 * g.pp;
  bool has[2 * L];
  float pv[2 * L], mv[2 * L];
  const T* src = pat + (size_t)u * two;
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) {
    const int s = h + 16 * k;
    has[k] = s < g.pp;
    pv[k] = has[k] ? as_float<T>(src[s]) : 0.0f;
    mv[k] = has[k] ? as_float<T>(src[g.pp + s]) : 0.0f;
  }
  const Side<L> sp = centre<L>(pv, has, g.inv_pp);
  const Side<L> sm = centre<L>(mv, has, g.inv_pp);
  const Desc d = load_desc(desc + (size_t)u * 32, h);
  if (h == 0 && u0 + (lane >> 4) < total) {
    float* r = terms + (size_t)row * terms_stride(S);
    reinterpret_cast<float4*>(r)[side] =
        make_float4(sp.mean, sp.ss, sm.mean, sm.ss);
    reinterpret_cast<float2*>(r + 4 * S)[side] = make_float2(d.a2p, d.a2m);
  }
}

// ---- a row's own terms, in the warp's shared memory ----

template <int S>
struct RowPatch {
  float v[2][32 * S];                // [plus | minus] centred, 0 past P^2
  float ss[2];
  bool ok[2];
};

struct RowDesc {
  float v[2][128];                   // [plus | minus] halves as float
  float a2[2];
};

// lane h of a half-warp writes its share of a patch `load_patch` formed
template <int S>
__device__ __forceinline__ void keep_patch(RowPatch<S>& r, const Patch<S>& p,
                                           int h) {
#pragma unroll
  for (int k = 0; k < 2 * S; ++k) {
    r.v[0][h + 16 * k] = p.p.v[k];
    r.v[1][h + 16 * k] = p.m.v[k];
  }
  if (h == 0) {
    r.ss[0] = p.p.ss;
    r.ss[1] = p.m.ss;
    r.ok[0] = p.okp;
    r.ok[1] = p.okm;
  }
}

__device__ __forceinline__ void keep_desc(RowDesc& r, const Desc& d, int h) {
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    r.v[0][8 * h + t] = d.p[t];
    r.v[1][8 * h + t] = d.m[t];
  }
  if (h == 0) {
    r.a2[0] = d.a2p;
    r.a2[1] = d.a2m;
  }
}

// ---- a (row, candidate) pair on the kLanes lanes of a slot; lane hl ----

// the NCC gate of the row's patch `a` against candidate patch `b` (FLAT,
// float32 or bf16) with its stored terms {mean+, ss+, mean-, ss-} and ok
// flags: leaf l adds samples l + 32 j, j < S, of the 4 pairings' products
// in order
template <int S, typename T>
__device__ __forceinline__ float ncc_pair(const RowPatch<S>& a,
                                          const T* __restrict__ b,
                                          const float4 bt,
                                          const uint8_t* __restrict__ bok,
                                          const Gate& g, int hl) {
  const auto prod = [&](int s) {
    if (s >= g.pp) return F4{0.0f, 0.0f, 0.0f, 0.0f};
    const float cp = sub(as_float<T>(b[s]), bt.x);
    const float cm = sub(as_float<T>(b[g.pp + s]), bt.z);
    const float ap = a.v[0][s], am = a.v[1][s];
    return F4{mul(ap, cp), mul(am, cm), mul(ap, cm), mul(am, cp)};
  };
  const auto leaf = [&](auto I) {
    const int l = hl + kLanes * decltype(I)::value;
    F4 x = add(prod(l), prod(l + 32));
#pragma unroll
    for (int j = 2; j < S; ++j) x = add(x, prod(l + 32 * j));
    return x;
  };
  const F4 x = slot_sum(lane_tree<32 / kLanes, 1, 0>(leaf));
  const bool okp = bok[0] != 0, okm = bok[1] != 0;
  if constexpr (kLanes >= 4) {
    // lane k < 4 of the slot scores pairing k, and every lane gathers the
    // four: one division and square root a lane, not four
    const int k = hl & 3;
    const bool bm = k == 1 || k == 2;          // (A-,B-), (A+,B-)
    const float v = ncc_score(k == 0 ? x.a : k == 1 ? x.b : k == 2 ? x.c : x.d,
                              a.ss[k & 1], bm ? bt.w : bt.y,
                              a.ok[k & 1] && (bm ? okm : okp), g);
    return max4(F4{__shfl_sync(kFull, v, 0, kLanes),
                   __shfl_sync(kFull, v, 1, kLanes),
                   __shfl_sync(kFull, v, 2, kLanes),
                   __shfl_sync(kFull, v, 3, kLanes)});
  } else {
    return max4(F4{ncc_score(x.a, a.ss[0], bt.y, a.ok[0] && okp, g),
                   ncc_score(x.b, a.ss[1], bt.w, a.ok[1] && okm, g),
                   ncc_score(x.c, a.ss[0], bt.w, a.ok[0] && okm, g),
                   ncc_score(x.d, a.ss[1], bt.y, a.ok[1] && okp, g)});
  }
}

// the descriptor gate of the row's descriptor `a` against candidate
// descriptor `b` with its stored |b+|^2, |b-|^2: leaf q is chunk q's 4
// cross dots
__device__ __forceinline__ float desc_pair(const RowDesc& a,
                                           const uint4* __restrict__ b,
                                           const float2 bz, int hl) {
  const auto leaf = [&](auto I) {
    const int q = hl + kLanes * decltype(I)::value;
    float bp[8], bm[8];
    unpack8(__ldg(b + q), bp);
    unpack8(__ldg(b + 16 + q), bm);
    const float* ap = a.v[0] + 8 * q;
    const float* am = a.v[1] + 8 * q;
    return F4{dot8(ap, bp), dot8(ap, bm), dot8(am, bp), dot8(am, bm)};
  };
  const F4 x = slot_sum(lane_tree<16 / kLanes, 1, 0>(leaf));
  return distance(a.a2[0], a.a2[1], bz.x, bz.y, x);
}

// ---- a row's slots ----

// The slots c of the row where m (lane c % 32: m0 for c < 32, m1 for c >=
// 32) holds, in ascending order, with their candidate indices, into the
// warp's list; returns their count.
__device__ __forceinline__ int list_slots(bool m0, bool m1, long long j0,
                                          long long j1, int lane,
                                          uint8_t* __restrict__ sc,
                                          int* __restrict__ sj) {
  const unsigned b0 = __ballot_sync(kFull, m0), b1 = __ballot_sync(kFull, m1);
  const unsigned below = (1u << lane) - 1u;
  if (m0) {
    const int k = __popc(b0 & below);
    sc[k] = (uint8_t)lane;
    sj[k] = (int)j0;
  }
  if (m1) {
    const int k = __popc(b0) + __popc(b1 & below);
    sc[k] = (uint8_t)(lane + 32);
    sj[k] = (int)j1;
  }
  __syncwarp();
  return __popc(b0) + __popc(b1);
}

// Walk the n listed slots kSlots a step: `fn(c, j, keep)` computes slot c
// against candidate j on the slot's lanes (lane hl = lane % kLanes) and
// keeps its results where `keep`. A slot past the list repeats the last
// one and keeps nothing, so every lane runs every butterfly.
template <class Fn>
__device__ __forceinline__ void walk(int n, int lane,
                                     const uint8_t* __restrict__ sc,
                                     const int* __restrict__ sj,
                                     const Fn& fn) {
  const int sl = lane / kLanes, hl = lane % kLanes;
  for (int u0 = 0; u0 < n; u0 += kSlots) {
    const int u = min(u0 + sl, n - 1);
    fn((int)sc[u], (size_t)sj[u], hl, u0 + sl < n && hl == 0);
  }
  __syncwarp();
}

// a row's output row in shared memory, its C slots set to `fill`
__device__ __forceinline__ void fill_row(float* __restrict__ o, int C,
                                         int lane, float fill) {
  if (lane < C) o[lane] = fill;
  if (lane + 32 < C) o[lane + 32] = fill;
}

__device__ __forceinline__ void store_row(float* __restrict__ out,
                                          const float* __restrict__ o, int C,
                                          int lane) {
  if (lane < C) out[lane] = o[lane];
  if (lane + 32 < C) out[lane + 32] = o[lane + 32];
}

struct StereoParams {
  const uint4 *l_desc, *r_desc;      // (N, 32), (Nr, 32) uint4: 256 bf16
  const long long* cand;             // (N, C)
  const uint8_t* cmask;              // (N, C)
  int N, C;
  const float *l_pat, *r_pat;        // (N, 2pp), (Nr, 2pp)
  const uint8_t *l_ok, *r_ok;        // (N, 2), (Nr, 2)
  const float* r_terms;              // (Nr, 8): the prep pass's
  Gate g;
  float sift, fill_dist, fill_ncc;
  float *dist, *ncc;                 // (N, C) each
};

template <int S>
__global__ void __launch_bounds__(kWarps * 32)
dense_gates_stereo_kernel(const StereoParams p) {
  __shared__ RowPatch<S> s_pat[kWarps];
  __shared__ RowDesc s_desc[kWarps];
  __shared__ uint8_t s_c[kWarps][64];
  __shared__ int s_j[kWarps][64];
  __shared__ float s_out[kWarps][2][64];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, h = lane & 15;
  const int i = blockIdx.x * kWarps + w;
  if (i >= p.N) return;              // whole warps only
  const size_t base = (size_t)i * p.C;
  const int C = p.C;
  const bool m0 = lane < C && p.cmask[base + lane] != 0;
  const bool m1 = lane + 32 < C && p.cmask[base + lane + 32] != 0;
  const long long j0 = m0 ? p.cand[base + lane] : 0;
  const long long j1 = m1 ? p.cand[base + lane + 32] : 0;
  float* const o_dist = s_out[w][0];
  float* const o_ncc = s_out[w][1];
  fill_row(o_dist, C, lane, p.fill_dist);
  fill_row(o_ncc, C, lane, p.fill_ncc);
  // the row's own terms, read before its slots are known (the loads
  // overlap); half-warp 0 keeps them
  const int two = 2 * p.g.pp;
  const Desc d = load_desc(p.l_desc + (size_t)i * 32, h);
  const Patch<S> l = load_patch<S>(p.l_pat + (size_t)i * two,
                                   p.l_ok + 2 * (size_t)i, p.g, h);
  if (lane < 16) {
    keep_desc(s_desc[w], d, h);
    keep_patch(s_pat[w], l, h);
  }
  const int n = list_slots(m0, m1, j0, j1, lane, s_c[w], s_j[w]);
  // stages 4-5 in one walk: each live slot's distance, and its NCC, kept
  // where the distance passes the SIFT gate (the NCC of a slot that
  // fails it is formed and dropped: ~2% of the live slots on the main
  // path)
  walk(n, lane, s_c[w], s_j[w], [&](int c, size_t j, int hl, bool keep) {
    const float* t = p.r_terms + j * terms_stride(1);
    const float x = desc_pair(s_desc[w], p.r_desc + j * 32,
                              reinterpret_cast<const float2*>(t + 4)[0], hl);
    const float y = ncc_pair(s_pat[w], p.r_pat + j * two,
                             reinterpret_cast<const float4*>(t)[0],
                             p.r_ok + 2 * j, p.g, hl);
    if (keep) {
      o_dist[c] = x;
      if (x < p.sift) o_ncc[c] = y;
    }
  });
  store_row(p.dist + base, o_dist, C, lane);
  store_row(p.ncc + base, o_ncc, C, lane);
}

struct TemporalParams {
  const float *kf_pat_l, *kf_pat_r;  // (M, 2pp) each
  const uint8_t *kf_ok_l, *kf_ok_r;  // (M, 2) each
  const uint4 *kf_desc_l, *kf_desc_r;  // (M, 32) uint4 each
  const __nv_bfloat16* cf_pat;       // (Mc, 4pp) [left | right]
  const uint8_t* cf_ok;              // (Mc, 4)
  const uint4* cf_desc;              // (Mc, 64) uint4: [left | right]
  const float* cf_terms;             // (Mc, 12): the prep pass's
  const long long* cf_idx;           // (M, C)
  const uint8_t* cmask;              // (M, C)
  int M, C;
  Gate g;
  float fill_ncc, fill_dist;
  float* out;                        // (4, M, C)
};

// at most 80 registers (3 blocks an SM), no spill; at 128 it takes 109
// and is 7.5% slower (PERF.md)
template <int S>
__global__ void __launch_bounds__(kWarps * 32, 3)
dense_gates_temporal_kernel(const TemporalParams p) {
  __shared__ RowPatch<S> s_pat[kWarps][2];
  __shared__ RowDesc s_desc[kWarps][2];
  __shared__ uint8_t s_c[kWarps][64];
  __shared__ int s_j[kWarps][64];
  __shared__ float s_out[kWarps][4][64];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31, h = lane & 15;
  const int i = blockIdx.x * kWarps + w;
  if (i >= p.M) return;              // whole warps only
  const size_t base = (size_t)i * p.C;
  const int C = p.C;
  const bool m0 = lane < C && p.cmask[base + lane] != 0;
  const bool m1 = lane + 32 < C && p.cmask[base + lane + 32] != 0;
  const long long j0 = m0 ? p.cf_idx[base + lane] : 0;
  const long long j1 = m1 ? p.cf_idx[base + lane + 32] : 0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    fill_row(s_out[w][q], C, lane, q < 2 ? p.fill_ncc : p.fill_dist);
  // the row's own terms, read before its slots are known (the loads
  // overlap): half-warp 0 the left side's, 1 the right's
  const int two = 2 * p.g.pp, side = lane >> 4;
  const Patch<S> k = load_patch<S>((side ? p.kf_pat_r : p.kf_pat_l)
                                       + (size_t)i * two,
                                   (side ? p.kf_ok_r : p.kf_ok_l)
                                       + 2 * (size_t)i,
                                   p.g, h);
  keep_patch(s_pat[w][side], k, h);
  const Desc d = load_desc((side ? p.kf_desc_r : p.kf_desc_l)
                               + (size_t)i * 32, h);
  keep_desc(s_desc[w][side], d, h);
  const int n = list_slots(m0, m1, j0, j1, lane, s_c[w], s_j[w]);
  walk(n, lane, s_c[w], s_j[w], [&](int c, size_t j, int hl, bool keep) {
    const float* t = p.cf_terms + j * terms_stride(2);
    const float4 z = reinterpret_cast<const float4*>(t)[2];
#pragma unroll
    for (int sd = 0; sd < 2; ++sd) {
      const float x = ncc_pair(s_pat[w][sd], p.cf_pat + (2 * j + sd) * two,
                               reinterpret_cast<const float4*>(t)[sd],
                               p.cf_ok + 4 * j + 2 * sd, p.g, hl);
      const float y = desc_pair(s_desc[w][sd], p.cf_desc + (2 * j + sd) * 32,
                                sd ? make_float2(z.z, z.w)
                                   : make_float2(z.x, z.y), hl);
      if (keep) {
        s_out[w][sd][c] = x;
        s_out[w][2 + sd][c] = y;
      }
    }
  });
  const size_t plane = (size_t)p.M * p.C;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    store_row(p.out + q * plane + base, s_out[w][q], C, lane);
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
template <int S>
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
    const Patch<S> l = load_patch<S>(p.l_pat + (size_t)r * two,
                                     p.l_ok + 2 * (size_t)r, p.g, h);
    const Patch<S> b = load_patch<S>(p.r_pat + (size_t)f * two,
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
  return P <= 0 || P % 2 == 0 || P * P > kMaxSide;
}

__host__ inline unsigned blocks(long long n) {
  return (unsigned)((n + kWarps - 1) / kWarps);
}

// the prep pass over R rows of S sides, L samples a lane of a side
template <typename T, int L>
__host__ inline void prep(const T* pat, const void* desc, int R, int S,
                          const Gate& g, float* terms, cudaStream_t stream) {
  dense_gates_prep_kernel<T, L><<<blocks(((long long)R * S + 1) / 2),
                                  kWarps * 32, 0, stream>>>(
      pat, static_cast<const uint4*>(desc), R, S, g, terms);
}

// the stereo entry's two launches at L samples a lane
template <int L>
__host__ inline int stereo_launch(const StereoParams& p, const float* r_pat,
                                  const void* r_desc, int Nr,
                                  float* r_terms, cudaStream_t stream) {
  if (Nr > 0) {
    prep<float, L>(r_pat, r_desc, Nr, 1, p.g, r_terms, stream);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  dense_gates_stereo_kernel<L><<<blocks(p.N), kWarps * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// the temporal entry's two launches at L samples a lane
template <int L>
__host__ inline int temporal_launch(const TemporalParams& p, const void* cf_desc,
                                    int Mc, float* cf_terms,
                                    cudaStream_t stream) {
  if (Mc > 0) {
    prep<__nv_bfloat16, L>(p.cf_pat, cf_desc, Mc, 2, p.g, cf_terms, stream);
    const int err = (int)cudaGetLastError();
    if (err) return err;
  }
  dense_gates_temporal_kernel<L><<<blocks(p.M), kWarps * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches the prep pass over the Nr right rows (into `r_terms`, (Nr, 8)
// float32 scratch), then the gates; with no right row, the gates alone.
extern "C" int dense_gates_stereo_launch(
    const void* l_desc, const void* r_desc, const long long* cand,
    const uint8_t* cmask, int N, int C, const float* l_pat,
    const uint8_t* l_ok, const float* r_pat, const uint8_t* r_ok, int Nr,
    float* r_terms, int P, float sift, float inv_pp, float eps, float eps2,
    float fill_dist, float fill_ncc, float* out, cudaStream_t stream) {
  if (N <= 0 || C <= 0) return (int)cudaGetLastError();
  if (C > 64 || bad_gate(P) || Nr < 0) return (int)cudaErrorInvalidValue;
  const Gate g = make_gate(P, inv_pp, eps, eps2);
  const size_t plane = (size_t)N * C;
  StereoParams p{static_cast<const uint4*>(l_desc),
                 static_cast<const uint4*>(r_desc),
                 cand, cmask, N, C, l_pat, r_pat, l_ok, r_ok, r_terms, g,
                 sift, fill_dist, fill_ncc, out, out + plane};
  return side_slots(g.pp) == 2
             ? stereo_launch<2>(p, r_pat, r_desc, Nr, r_terms, stream)
             : stereo_launch<4>(p, r_pat, r_desc, Nr, r_terms, stream);
}

// Launches the prep pass over the Mc CF rows (into `cf_terms`, (Mc, 12)
// float32 scratch), then the gates; with no CF row, the gates alone.
extern "C" int dense_gates_temporal_launch(
    const float* kf_pat_l, const uint8_t* kf_ok_l, const float* kf_pat_r,
    const uint8_t* kf_ok_r, const void* kf_desc_l, const void* kf_desc_r,
    const void* cf_pat, const uint8_t* cf_ok, const void* cf_desc, int Mc,
    float* cf_terms, const long long* cf_idx, const uint8_t* cmask, int M,
    int C, int P, float inv_pp, float eps, float eps2, float fill_ncc,
    float fill_dist, float* out, cudaStream_t stream) {
  if (M <= 0 || C <= 0) return (int)cudaGetLastError();
  if (C > 64 || bad_gate(P) || Mc < 0) return (int)cudaErrorInvalidValue;
  const Gate g = make_gate(P, inv_pp, eps, eps2);
  const __nv_bfloat16* cp = static_cast<const __nv_bfloat16*>(cf_pat);
  TemporalParams p{kf_pat_l, kf_pat_r, kf_ok_l, kf_ok_r,
                   static_cast<const uint4*>(kf_desc_l),
                   static_cast<const uint4*>(kf_desc_r), cp, cf_ok,
                   static_cast<const uint4*>(cf_desc), cf_terms, cf_idx,
                   cmask, M, C, g, fill_ncc, fill_dist, out};
  return side_slots(g.pp) == 2
             ? temporal_launch<2>(p, cf_desc, Mc, cf_terms, stream)
             : temporal_launch<4>(p, cf_desc, Mc, cf_terms, stream);
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
  if (side_slots(p.g.pp) == 2)
    dense_gates_flat_kernel<2><<<blocks((F + 1) / 2), kWarps * 32, 0,
                                 stream>>>(p);
  else
    dense_gates_flat_kernel<4><<<blocks((F + 1) / 2), kWarps * 32, 0,
                                 stream>>>(p);
  return (int)cudaGetLastError();
}

namespace {

template <typename K>
__host__ inline int kernel_info(K kernel, int* out) {
  cudaFuncAttributes a{};
  cudaError_t err = cudaFuncGetAttributes(&a, kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kWarps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = kWarps;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = per_sm;
  return 0;
}

}  // namespace

namespace {

// the five kernels at L samples a lane, 5 ints each
template <int L>
__host__ inline int info_l(int* out) {
  int err = kernel_info(dense_gates_prep_kernel<float, L>, out);
  if (!err)
    err = kernel_info(dense_gates_prep_kernel<__nv_bfloat16, L>, out + 5);
  if (!err) err = kernel_info(dense_gates_stereo_kernel<L>, out + 10);
  if (!err) err = kernel_info(dense_gates_temporal_kernel<L>, out + 15);
  if (!err) err = kernel_info(dense_gates_flat_kernel<L>, out + 20);
  return err;
}

}  // namespace

// What the built kernels are on this card, 5 ints each for the prep pass
// over a float32 (stereo) and a bf16 (temporal) table, the stereo, the
// temporal and the flat gates: warps a block, registers a thread, local
// (spill) bytes a thread, static shared bytes a block, blocks an SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), at 2 samples a lane
// (P <= 7) in out[0..24]; then out[25] = the slots a warp step; then the
// same 25 at 4 samples a lane (P = 9, 11) in out[26..50].
extern "C" int dense_gates_info(int* out) {
  int err = info_l<2>(out);
  out[25] = kSlots;
  if (!err) err = info_l<4>(out + 26);
  return err;
}
