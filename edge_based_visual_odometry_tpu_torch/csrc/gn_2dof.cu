// 2-DoF KF -> CF photometric Gauss-Newton on Hopper (sm_90a): kernel K3.
//
// Replaces edge_based_visual_odometry_tpu/ops/gauss_newton.py:387
// `refine_2dof_batch`, the temporal cascade's refiner. On the TPU it is an
// XLA formulation, not a `pallas_call`: a CF tile atlas and a KF 32/8
// atlas, bilinear sampling as MXU einsums, chunks of `lax.while_loop`s
// and the two-phase compaction. This kernel computes what it computes,
// per flat (KF mate, candidate) lane of a side: two rotated 7x7 KF
// patches at +-(P/2 + 1) along the KF edge normal, sampled once from the
// 32 x 32 tile around the KF edge and mean-centred per half; each
// iteration the CF patch pair at kf - d rotated by the CF orientation,
// sampled bilinearly from the CF image, gx and gy, each sample clamped to
// the gn_tile tile of the CF candidate (which bounds GN travel), and
// mean-centred; Huber weights (w = 1 if |r| < delta, else delta / |r|);
// the 2x2 normal equations (+ reg 1e-6 n) solved through 1 / det; at most
// max_iter iterations, stopping at |step| < tol. A lane whose step is not
// finite (a singular system: det rounds to 0) takes no step and stops
// there without a score (valid = false): the reference's 1-DoF refiner
// treats a degenerate system so; the reference's 2-DoF outcome on such a
// lane depends on its reduction order (a documented deviation).
//
// What bounds it on the card: instruction issue, as with the 1-DoF kernel
// K2 (epipolar_gn.cu), not bytes. Per lane-iteration ~7.7 kflop against
// ~55 bytes of lane data; each iteration is ~700 warp instructions (4
// sample slots of coordinates, tile clamp, bilinear taps of 3 maps,
// residual and Huber weight, then 8 butterfly reductions), while the
// 376 x 1241 maps stay in L2 and a lane's samples mostly hit L1.
//
// Design. One warp per lane; the 98 samples over the 32 threads (<= 4
// each) in branch-free slots (a slot past the samples recomputes sample 0
// and adds nothing); the two patch means and the six sums are warp-shuffle
// butterflies, so every thread holds the same scalar state and the warp
// leaves its loop as soon as its lane converges; each CF sample is 4
// 16-byte `__ldg` gathers of the interleaved {image, gx, gy, -} pixels.
// One launch covers both sides of a temporal step (the left and right KF
// images, the (2, H, W, 4) CF maps, the (B, 6) lane packs), and the
// reference's two phases are two launches:
//   - phase 1, one warp per (side, lane), iterations [0, phase1_iters)
//     from kf - cf; it writes every lane's state and `done`;
//   - phase 2 runs iterations [phase1_iters, max_iter) on the first
//     `budget` lanes of each side that phase 1 left undone, in index
//     order (the reference's stable compaction), reading the phase-1
//     state at the lane's own index and writing it back there. Its input
//     is the inclusive prefix count of `done` over the flat (side, lane)
//     order (one torch.cumsum, no sort): a lane's rank among the undone
//     lanes of its side is (i + 1) - its count of done lanes, and a warp
//     finds the lane of rank r by a 32-way search of the count. Warps are
//     persistent (as many as fit on the card) and take lanes from a queue,
//     an atomic counter over the selected lanes, so a warp whose lane
//     converged takes the next one and no block holds its SM for its
//     slowest lane. A lane's arithmetic does not depend on which warp runs
//     it or when.
// `__launch_bounds__` asks for min_blocks(P) blocks of kWarps warps an
// SM: up to P = 7, 4 x 256 threads, so <= 64 registers and 32 warps an SM
// (a few bytes spill; measured faster than 3 blocks at <= 80 registers
// and 2 at up to 128); at P = 9 and 11, whose threads hold 6 and 8
// samples (gn_common.cuh `slots_for`), 2 blocks (<= 128 registers);
// `refine_2dof_info` reports the registers, spills and the blocks an SM
// holds at each patch size. The kernels are compiled for each patch size
// (a template argument), so the slots' offsets, halves and presence fold
// into constants. In the direct launch, the lanes of one KF mate lie next to
// each other (`_flatten_active`), so the first warp of each run of equal
// mates in a block samples the centred KF patches once into shared
// memory and the run's other warps read them. (Measured and not kept,
// PERF.md: each warp sampling its own KF patches; phase 2 reading the
// patches phase 1 sampled; phase 2 gathering from a copy of the CF tile
// in shared memory.)
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

constexpr unsigned FULL = 0xffffffffu;
constexpr int kWarps = 8;          // warps a block
// blocks an SM (__launch_bounds__) at patch size P
__host__ __device__ constexpr int min_blocks(int P) { return P <= 7 ? 4 : 2; }

// One launch over `nsides` sides of B lanes. Lane operand v of lane i of
// side s is v[s * sstride + i * lstride]; outputs are (nsides, B[, 2]).
struct K3Params {
  const float* kf0;          // KF image of side 0 / side 1, (H, W)
  const float* kf1;
  const float4* maps;        // (nsides, H, W) interleaved CF maps
  int H, W;
  const float *kx, *ky, *kt, *cx, *cy, *ct;
  int lstride, sstride;
  const float* d0;           // (nsides, B, 2) start; null: kf - cf
                             // (phase 2: d, read in place)
  const bool* active;        // (B,), shared by the sides
  int B, nsides, it0, it_stop, max_iter, P, tile, stride;
  float tol, huber;
  float* d;                  // (nsides, B, 2)
  float* score;
  float* conf;
  bool* valid;
  int* iters;
  bool* done;
  const int* cum_done;       // phase 2: inclusive count of done, flat
  int budget;                //   lanes per side phase 2 takes at most
  int* counter;              //   the queue (0 at launch)
};

struct Lane {
  int s, i, g;               // side, lane, flat index s * B + i
  float kx, ky, kt, cx, cy, ct, dx, dy;
};

__device__ __forceinline__ Lane load_lane(const K3Params& p, int s, int i) {
  Lane l;
  l.s = s;
  l.i = i;
  l.g = s * p.B + i;
  const int o = s * p.sstride + i * p.lstride;
  l.kx = __ldg(p.kx + o);
  l.ky = __ldg(p.ky + o);
  l.kt = __ldg(p.kt + o);
  l.cx = __ldg(p.cx + o);
  l.cy = __ldg(p.cy + o);
  l.ct = __ldg(p.ct + o);
  if (p.d0) {
    l.dx = p.d0[2 * l.g];
    l.dy = p.d0[2 * l.g + 1];
  } else {
    l.dx = sub(l.kx, l.cx);
    l.dy = sub(l.ky, l.cy);
  }
  return l;
}

__device__ __forceinline__ void write_lane(const K3Params& p, int g, float dx,
                                           float dy, float score, float conf,
                                           bool valid, int iters, bool done) {
  p.d[2 * g] = dx;
  p.d[2 * g + 1] = dy;
  p.score[g] = score;
  p.conf[g] = conf;
  p.valid[g] = valid;
  p.iters[g] = iters;
  p.done[g] = done;
}

// the centred KF patches of a lane (this thread's slots)
template <int NS>
__device__ __forceinline__ void kf_patches(const K3Params& p, const Lane& l,
                                           const Slots<NS>& sl, float inv_pp,
                                           float side, float kc[NS]) {
  const float c = cosf(l.kt), s = sinf(l.kt);
  centred_patches(l.s ? p.kf1 : p.kf0, p.H, p.W, l.kx, l.ky, mul(-s, side),
                  mul(c, side), sl, rotate(sl, c, s), inv_pp, kc);
}

// iterations [p.it0, p.it_stop) of one lane from (l.dx, l.dy) on the
// centred KF patches kc; writes the lane's outputs
template <int P, int NS = slots_for(P)>
__device__ __forceinline__ void iterate(const K3Params& p, const Lane& l,
                                        const Slots<NS>& sl,
                                        const float kc[NS], int lane) {
  constexpr int pp = P * P;
  constexpr int n_samples = 2 * pp;
  const float side = P / 2.0f + 1.0f;
  const float inv_pp = 1.0f / pp, inv_n = 1.0f / n_samples;
  const float inv_huber = 1.0f / p.huber;
  const float huber = p.huber;
  const float reg = (float)(1e-6 * n_samples);
  const float4* maps = p.maps + (size_t)l.s * p.H * p.W;
  const float cc = cosf(l.ct), sc = sinf(l.ct);
  const Rotated<NS> rot = rotate(sl, cc, sc);
  const float nsx = mul(-sc, side), nsy = mul(cc, side);   // CF normal * side
  const float ox = tile_origin(l.cx, p.tile, p.stride, p.W);
  const float oy = tile_origin(l.cy, p.tile, p.stride, p.H);
  const float t1 = p.tile - 1.0f;

  float dx = l.dx, dy = l.dy;
  float score = 1e6f, conf = 0.0f;
  bool valid = false, done = false;
  int iters = 0;
  for (int it = p.it0; it < p.it_stop && !done; ++it) {
    const float bx = sub(l.kx, dx), by = sub(l.ky, dy);
    float rv[NS], gx[NS], gy[NS];
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      float px, py;
      slot_xy(sl, rot, k, bx, by, nsx, nsy, &px, &py);
      const Tap t = make_tap(px, py, ox, oy, t1, p.H, p.W);
      read3(maps, t, &rv[k], &gx[k], &gy[k]);
    }
    float mp, mm;
    half_means(sl, rv, inv_pp, &mp, &mm);
    // a thread's sums start from its first slot's terms (the twin's
    // `_lane_sum` adds no leading 0), and slots past the samples add
    // nothing
    float h00 = 0.0f, h01 = 0.0f, h11 = 0.0f;
    float b0 = 0.0f, b1 = 0.0f, cost = 0.0f;
#pragma unroll
    for (int k = 0; k < NS; ++k) {
      const float r = sub(kc[k], sub(rv[k], sl.sgn[k] > 0 ? mp : mm));
      const float ar = fabsf(r);
      const float w = ar < huber ? 1.0f : mul(__frcp_rn(ar), huber);
      const float wgx = mul(w, gx[k]), wgy = mul(w, gy[k]);
      const float t00 = mul(wgx, gx[k]), t01 = mul(wgx, gy[k]);
      const float t11 = mul(wgy, gy[k]), tb0 = mul(wgx, r);
      const float tb1 = mul(wgy, r), tc = mul(mul(w, r), r);
      if (k == 0) {
        h00 = sl.has[0] ? t00 : 0.0f;
        h01 = sl.has[0] ? t01 : 0.0f;
        h11 = sl.has[0] ? t11 : 0.0f;
        b0 = sl.has[0] ? tb0 : 0.0f;
        b1 = sl.has[0] ? tb1 : 0.0f;
        cost = sl.has[0] ? tc : 0.0f;
        continue;
      }
      const bool h = sl.has[k];
      h00 = h ? add(h00, t00) : h00;
      h01 = h ? add(h01, t01) : h01;
      h11 = h ? add(h11, t11) : h11;
      b0 = h ? add(b0, tb0) : b0;
      b1 = h ? add(b1, tb1) : b1;
      cost = h ? add(cost, tc) : cost;
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
    // a singular system: no step, no score, and the lane stops
    const bool finite = isfinite(e0) && isfinite(e1);
    const bool converged = step < p.tol || it == p.max_iter - 1;
    if (converged && finite) {
      score = rms;
      conf = expf(mul(-rms, inv_huber));
      valid = !(rms > huber * 2.0f || it < 1);
    }
    if (finite) {
      dx = add(dx, e0);
      dy = add(dy, e1);
    }
    iters = it + 1;
    done = converged || !finite;
  }
  if (lane == 0) write_lane(p, l.g, dx, dy, score, conf, valid, iters, done);
}

// one warp per (side, lane): phase 1 and the one-launch form; P the
// patch size (2 P^2 <= 32 NS)
template <int P, int NS = slots_for(P)>
__global__ void __launch_bounds__(kWarps * 32, min_blocks(P))
gn_2dof_direct(const K3Params p) {
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int g = blockIdx.x * kWarps + w;
  const bool in = g < p.nsides * p.B;
  const int s = in ? g / p.B : 0;
  const int i = in ? g - s * p.B : 0;
  const bool act = in && p.active[i];
  const Slots<NS> sl = make_slots<NS>(lane, P);
  const float side = P / 2.0f + 1.0f;
  const float inv_pp = 1.0f / (P * P);
  // lanes of one KF mate lie next to each other: the first warp of a run
  // of equal mates in the block samples the patches for the run
  __shared__ int4 key_s[kWarps];
  __shared__ float kc_s[kWarps][32 * NS];
  const Lane l = load_lane(p, s, i);
  if (lane == 0)
    key_s[w] = act ? make_int4(__float_as_int(l.kx), __float_as_int(l.ky),
                               __float_as_int(l.kt), s)
                   : make_int4(0, 0, 0, -1 - w);
  __syncthreads();
  int leader = w;
  const int4 me = key_s[w];
  while (act && leader > 0) {
    const int4 o = key_s[leader - 1];
    if (o.x != me.x || o.y != me.y || o.z != me.z || o.w != me.w) break;
    --leader;
  }
  float kc[NS];
  if (act && leader == w) {
    kf_patches(p, l, sl, inv_pp, side, kc);
#pragma unroll
    for (int k = 0; k < NS; ++k) kc_s[w][32 * k + lane] = kc[k];
  }
  __syncthreads();
  if (!in) return;
  if (!act) {
    if (lane == 0) write_lane(p, g, l.dx, l.dy, 1e6f, 0.0f, false, 0, true);
    return;
  }
  if (leader != w) {
#pragma unroll
    for (int k = 0; k < NS; ++k) kc[k] = kc_s[leader][32 * k + lane];
  }
  iterate<P>(p, l, sl, kc, lane);
}

// the first i in [0, B) whose rank among the lanes not done,
// (i + 1) - (cum[i] - base), reaches `rank` (such an i exists): a 32-way
// search, one probe a thread a round
__device__ __forceinline__ int nth_pending(const int* cum, int base, int B,
                                           int rank, int lane) {
  int lo = 0, hi = B;        // the answer is in [lo, hi); hi - 1 qualifies
  while (hi - lo > 32) {
    const int step = (hi - lo + 31) >> 5;
    const int q = min(lo + (lane + 1) * step, hi) - 1;
    const unsigned m =
        __ballot_sync(FULL, q + 1 - (__ldg(cum + q) - base) >= rank);
    const int t = __ffs(m) - 1;            // thread 31 probes hi - 1
    hi = min(lo + (t + 1) * step, hi);
    lo += t * step;
  }
  const int q = lo + lane;
  const bool ok = q < hi && q + 1 - (__ldg(cum + q) - base) >= rank;
  return lo + __ffs(__ballot_sync(FULL, ok)) - 1;
}

// phase 2: persistent warps over the queue of selected lanes
template <int P, int NS = slots_for(P)>
__global__ void __launch_bounds__(kWarps * 32, min_blocks(P))
gn_2dof_queue(const K3Params p) {
  const int lane = threadIdx.x & 31;
  const int c0 = __ldg(p.cum_done + p.B - 1);            // side 0's done
  const int n0 = min(p.B - c0, p.budget);
  const int n = n0 + (p.nsides > 1
                      ? min(p.B - (__ldg(p.cum_done + 2 * p.B - 1) - c0),
                            p.budget)
                      : 0);
  const Slots<NS> sl = make_slots<NS>(lane, P);
  const float side = P / 2.0f + 1.0f;
  const float inv_pp = 1.0f / (P * P);
  for (;;) {
    int q = 0;
    if (lane == 0) q = atomicAdd(p.counter, 1);
    q = __shfl_sync(FULL, q, 0);
    if (q >= n) break;
    const int s = q >= n0 ? 1 : 0;
    const int i = nth_pending(p.cum_done + s * p.B, s ? c0 : 0, p.B,
                              q - s * n0 + 1, lane);
    const Lane l = load_lane(p, s, i);
    float kc[NS];
    kf_patches(p, l, sl, inv_pp, side, kc);
    iterate<P>(p, l, sl, kc, lane);
  }
}

template <int P>
int launch_p(const K3Params& p, cudaStream_t stream) {
  if (!p.cum_done) {
    const int lanes = p.nsides * p.B;
    gn_2dof_direct<P><<<(lanes + kWarps - 1) / kWarps, kWarps * 32, 0,
                        stream>>>(p);
    return (int)cudaGetLastError();
  }
  // as many persistent blocks as the card holds (asked once per device),
  // and no more warps than the queue can hold lanes
  static int cached_dev = -1, cached_blocks = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev != cached_dev) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gn_2dof_queue<P>, kWarps * 32, 0);
    if (e != cudaSuccess) return (int)e;
    if (per_sm * sms < 1) return (int)cudaErrorInvalidConfiguration;
    cached_blocks = per_sm * sms;
    cached_dev = dev;
  }
  const int most = (p.nsides * min(p.B, p.budget) + kWarps - 1) / kWarps;
  const int blocks = max(1, min(cached_blocks, most));
  gn_2dof_queue<P><<<blocks, kWarps * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

// the kernels are compiled for each patch size the wrappers take (odd,
// P <= 11: 2 P^2 <= 242)
int launch(const K3Params& p, cudaStream_t stream) {
  if (p.tile < 1) return (int)cudaErrorInvalidValue;
  if (p.B <= 0) return (int)cudaGetLastError();
  switch (p.P) {
    case 1: return launch_p<1>(p, stream);
    case 3: return launch_p<3>(p, stream);
    case 5: return launch_p<5>(p, stream);
    case 7: return launch_p<7>(p, stream);
    case 9: return launch_p<9>(p, stream);
    case 11: return launch_p<11>(p, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Both sides (nsides = 2; kf1 is side 1's KF image) or one. maps4:
// (nsides, H, W, 4) interleaved CF maps; kpack, cpack: (B, 3 nsides)
// {x, y, theta} of the KF edge and of the CF candidate per side; outputs
// (nsides, B[, 2]). cum_done null: iterations [it0, it_stop) on every
// lane from d0 (nsides, B, 2), or from kf - cf if d0 is null (phase 1,
// the one-launch form). cum_done set: phase 2, iterations [it0, it_stop)
// on the first `budget` undone lanes of each side, in place (d0 unused);
// cum_done is the inclusive prefix count of `done` over the flat
// (side, lane) order and *counter is 0.
extern "C" int refine_2dof_sides_launch(
    const float* kf0, const float* kf1, const float* maps4, int H, int W,
    const float* kpack, const float* cpack, const float* d0, int nsides,
    const bool* active,
    int B, int it0, int it_stop, int max_iter, int patch_size, int tile,
    int stride, float tol, float huber, const int* cum_done, int budget,
    int* counter, float* d, float* score, float* conf, bool* valid,
    int* iters, bool* done, cudaStream_t stream) {
  if (nsides < 1 || nsides > 2) return (int)cudaErrorInvalidValue;
  K3Params p{};
  p.kf0 = kf0;
  p.kf1 = kf1;
  p.maps = reinterpret_cast<const float4*>(maps4);
  p.H = H;
  p.W = W;
  p.kx = kpack; p.ky = kpack + 1; p.kt = kpack + 2;
  p.cx = cpack; p.cy = cpack + 1; p.ct = cpack + 2;
  p.lstride = 3 * nsides;
  p.sstride = 3;
  p.d0 = cum_done ? d : d0;
  p.active = active;
  p.B = B;
  p.nsides = nsides;
  p.it0 = it0; p.it_stop = it_stop; p.max_iter = max_iter;
  p.P = patch_size; p.tile = tile; p.stride = stride;
  p.tol = tol; p.huber = huber;
  p.d = d; p.score = score; p.conf = conf; p.valid = valid; p.iters = iters;
  p.done = done;
  p.cum_done = cum_done;
  p.budget = budget;
  p.counter = counter;
  return launch(p, stream);
}

// Registers, local (spill) bytes and blocks an SM holds of the two
// kernels at each patch size (1, 3, 5, 7, 9, 11), and the warps of a
// block: out[0] = warps per block, then per patch size, in that order,
// 7 ints: the patch size, direct {registers, local bytes, blocks per SM},
// queue {the same}.
template <int P>
int info_p(int* out) {
  cudaFuncAttributes a{};
  const void* fns[2] = {(const void*)gn_2dof_direct<P>,
                        (const void*)gn_2dof_queue<P>};
  out[0] = P;
  for (int k = 0; k < 2; ++k) {
    cudaError_t e = cudaFuncGetAttributes(&a, fns[k]);
    if (e != cudaSuccess) return (int)e;
    int per_sm = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fns[k],
                                                      kWarps * 32, 0);
    if (e != cudaSuccess) return (int)e;
    out[1 + 3 * k] = a.numRegs;
    out[2 + 3 * k] = (int)a.localSizeBytes;
    out[3 + 3 * k] = per_sm;
  }
  return 0;
}

extern "C" int refine_2dof_info(int* out) {
  out[0] = kWarps;
  int err = info_p<1>(out + 1);
  if (!err) err = info_p<3>(out + 8);
  if (!err) err = info_p<5>(out + 15);
  if (!err) err = info_p<7>(out + 22);
  if (!err) err = info_p<9>(out + 29);
  if (!err) err = info_p<11>(out + 36);
  return err;
}
