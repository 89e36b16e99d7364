// Edge descriptors on Hopper (sm_90a): kernel K5.
//
// Replaces edge_based_visual_odometry_tpu/ops/descriptors.py:114
// `edge_descriptors_tiled`, the stereo step's descriptors of the left
// edges, the right edges and the final mates. On the TPU it is an XLA
// formulation, not a `pallas_call`: tile-resident gathers of the gradient
// maps, a dense (S, 16) x (b, S, 8) einsum over samples and two norms.
// This kernel computes what it computes, per edge (x, y, theta):
//   - the two keypoints shifted +-m along the edge's normal, (x + m sin t,
//     y - m cos t) and (x - m sin t, y + m cos t);
//   - per keypoint S <= 256 samples on a grid rotated to theta, each read
//     bilinearly from gx and gy through the atlas tile of the keypoint
//     (tile 40, stride 8: the tile clamp and edge replication of the GN
//     kernels);
//   - per sample the magnitude times the Gaussian weight, the angle
//     relative to theta in orientation bins, ob = (angle mod 2 pi) / 2 pi
//     * 8, and the circular hat max(0, 1 - min(d, 8 - d)) of each bin;
//   - the histogram of 4 x 4 cells x 8 bins: bin (p, o) adds
//     SP[s, p] * T[s, o] over cell p's samples;
//   - L2 normalise, clip, normalise again, scale, round to bf16.
//
// What bounds it on the card: operations. At the stereo step's 180,224
// keypoints it writes 46 MB of bf16 and reads ~15 MB of maps and edges
// (~18 us at 3.35 TB/s), against ~4.2 GFLOP counted at the nonzero terms
// of the hats (~63 us at 67 TFLOP/s, twice that without FMA). It runs at
// ~11% of that bound (PERF.md): half its time is the sampling pass (the
// gathers, atan2f), half the histogram's shared-memory traffic, and the two
// overlap little. scripts/k5_variants.py times it with parts taken out.
//
// Design: one warp per edge, its two keypoints side by side.
// Phase 1: lane l takes samples l + 32 k of both keypoints (the rotated
// offsets are the same for both). gx and gy are read by two texture
// gathers from a CUDA array of {gx, gy} pairs, which the launch fills
// first (block-linear: a warp's rotated samples fall on few lines). A
// sample's hat is nonzero in at most 2 bins, o_lo = floor(ob) mod 8 and
// o_lo + 1 mod 8 (ob = 8.0 gives bin 0 the weight 1): the kernel evaluates
// the twin's expressions at those two and keeps (T[s, o_lo], T[s, o_hi])
// and o_lo in shared memory, 9 bytes a sample, not 32. A sample's place
// comes from the wrapper: a record slot of its bank colour (slot % 16),
// the colours chosen so that the 16 samples phase 2 reads at one step lie
// on distinct banks, and the byte of its o_lo in a word of that colour.
// Phase 2: lane (h, p) = (lane / 16, lane % 16) owns the 8 bins of cell p
// of keypoint h, in shared memory, and walks cell p's list of samples
// (place and weight, from the table as computed on the card) to its own
// length, not the longest: 2 multiply-adds a term.
// Phase 3: the norms in the twin's lane order (its lane 2 p + b holds
// bins 4 b .. 4 b + 3 of cell p), a butterfly over the 16 cells; lane
// (h, p) writes its 8 bf16 as one 16-byte store into row e of the
// (N, 256) output at column 128 h + 8 p. No atomics: every sum has one
// fixed order.
// (Measured and not kept, PERF.md: gathers from global memory, records by
// sample index, the bins in registers, the lists staged in shared memory,
// 2 or 8 warps a block, cell-major lists.)
//
// Exactness: the twin adds every term of its padded lists. Every term is
// >= +0 (the weights, the magnitude and the hat are), and adding +0 to a
// sum >= +0 changes no bit, so the terms that are +0 may be skipped: the
// padding (weight 0) and the 6 bins whose hat is 0, as long as the sample
// is finite. A sample whose magnitude is not finite or whose ob is NaN
// gives a non-finite term in a bin of a cell it lies in (every sample lies
// in one), so the half's norm, and with it all 128 bins, are NaN in the
// kernel as in the twin.
//
// Arithmetic is written with round-to-nearest intrinsics (no FMA
// contraction), NaN-keeping min and max, division by a scalar as a
// multiply by its float32 reciprocal, in the order of the plain twin
// `edge_descriptors_plain`; sinf, cosf, atan2f, fmodf and sqrtf are the
// ones PyTorch's kernels call (sinf and cosf equal torch.sin and torch.cos
// on every float32). The static tables come from the wrapper, computed by
// PyTorch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gn_common.cuh"

namespace {

using gn::add;
using gn::mul;
using gn::sub;

constexpr int kWarps = 4;            // edges a block, one warp each
constexpr int kMaxSamples = 256;     // 16 x 16 grid
constexpr int kOrient = 8;           // orientation bins
constexpr int kCells = 16;           // 4 x 4 spatial cells
// a keypoint's record slots: 17 of each of 16 bank colours (slot % 16)
constexpr int kSlots = 17 * 16;
constexpr int kOBytes = 4 * 16 * 5;  // o_lo: 16 colours x 5 words of 4

struct Params {
  cudaTextureObject_t maps;              // (H, W) {gx, gy}
  int H, W;
  const float *x, *y, *theta;            // (N,) edges
  int N;
  float shift;
  const float *ii, *jj, *gauss;          // S samples
  const int* place;                      // (S,) record place of each
  int S;
  const int2* terms;                     // (L, 16) {place, weight bits}
  const int* lens;                       // (16,) terms of each cell
  int tile, stride;
  float two_pi, inv_two_pi, clip, scale;
  uint4* out;                            // (N, 256) bf16, 8 a lane
};

// one warp's shared memory: its two keypoints' records and the lanes' bins
struct WarpSmem {
  float2 t[2][kSlots];                   // (T[s, o_lo], T[s, o_hi])
  uint8_t o[2][kOBytes];                 // o_lo
  float acc[kOrient][32];                // bin o of lane l at [o][l]
};

// torch.minimum / torch.clamp: a NaN stays NaN
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// torch.remainder(a, b) for b > 0: fmod, then + b where the signs differ
__device__ __forceinline__ float remainder_pos(float a, float b) {
  float m = fmodf(a, b);
  if (m != 0.0f && m < 0.0f) m = add(m, b);
  return m;
}

// the twin's circular hat of bin o, times the magnitude
__device__ __forceinline__ float hat(float ob, int o, float mag) {
  float d = fabsf(sub(ob, (float)o));
  d = min_nan(d, sub((float)kOrient, d));
  return mul(mag, max_nan(sub(1.0f, d), 0.0f));
}

// gx, gy at (x, y) clamped to the atlas tile at (ox, oy): the weights of
// gn::make_tap, and its 2 x 2 pixels (x0, y0) .. (x0 + 1, y0 + 1) by one
// texture gather a map. A gather at (u, v) = (x0 + 1, y0 + 1) returns the
// pixels floor(u - 0.5) + {0, 1} as (x0, y1), (x1, y1), (x1, y0), (x0, y0);
// the clamp address mode repeats the last column and row, as make_tap's
// min(., n - 1) does (the indices are never negative).
__device__ __forceinline__ float2 sample_maps(cudaTextureObject_t maps,
                                              float x, float y, float ox,
                                              float oy, float t1) {
  const float rx = gn::clamp(sub(x, ox), 0.0f, t1);
  const float ry = gn::clamp(sub(y, oy), 0.0f, t1);
  const float x0 = floorf(rx), y0 = floorf(ry);
  gn::Tap t;
  t.wc0 = sub(1.0f, fabsf(sub(rx, x0)));
  t.wc1 = sub(1.0f, fabsf(sub(rx, add(x0, 1.0f))));
  t.wr0 = sub(1.0f, fabsf(sub(ry, y0)));
  t.wr1 = sub(1.0f, fabsf(sub(ry, add(y0, 1.0f))));
  const float u = add(add(ox, x0), 1.0f), v = add(add(oy, y0), 1.0f);
  const float4 gx = tex2Dgather<float4>(maps, u, v, 0);
  const float4 gy = tex2Dgather<float4>(maps, u, v, 1);
  return make_float2(gn::lerp4(t, gx.w, gx.z, gx.x, gx.y),
                     gn::lerp4(t, gy.w, gy.z, gy.x, gy.y));
}

// L2 norm of a keypoint's 128 bins, clamped below at 1e-7, in the twin's
// lane order: its lane 2 p adds bins 0-3 of cell p, lane 2 p + 1 bins 4-7,
// then a butterfly over its 32 lanes (here over the 16 cells, then the
// two halves)
__device__ __forceinline__ float norm8(const float a[kOrient]) {
  float lo = add(add(add(mul(a[0], a[0]), mul(a[1], a[1])), mul(a[2], a[2])),
                 mul(a[3], a[3]));
  float hi = add(add(add(mul(a[4], a[4]), mul(a[5], a[5])), mul(a[6], a[6])),
                 mul(a[7], a[7]));
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) {
    lo = add(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = add(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  return max_nan(sqrtf(add(lo, hi)), 1e-7f);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
         | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}

// the launch's first pass: gx, gy into the {gx, gy} array
__global__ void interleave_kernel(const float* __restrict__ gx,
                                  const float* __restrict__ gy,
                                  cudaSurfaceObject_t maps, int W, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n)
    surf2Dwrite(make_float2(__ldg(gx + i), __ldg(gy + i)), maps,
                (i % W) * (int)sizeof(float2), i / W);
}

__global__ void __launch_bounds__(kWarps * 32)
edge_descriptors_kernel(const Params p) {
  __shared__ WarpSmem smem[kWarps];
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
  const int e = blockIdx.x * kWarps + wid;
  if (e >= p.N) return;               // whole warps only
  WarpSmem& sm = smem[wid];

  // ---- phase 1: both keypoints' samples, 2 hat bins each ----
  const float th = p.theta[e];
  const float st = sinf(th), ct = cosf(th);
  const float dx = mul(p.shift, st), dy = mul(p.shift, ct);
  const float x = p.x[e], y = p.y[e];
  const float kx[2] = {add(x, dx), sub(x, dx)};
  const float ky[2] = {sub(y, dy), add(y, dy)};
  float ox[2], oy[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    ox[h] = gn::tile_origin(kx[h], p.tile, p.stride, p.W);
    oy[h] = gn::tile_origin(ky[h], p.tile, p.stride, p.H);
  }
  const float t1 = (float)(p.tile - 1);
  for (int s = lane; s < p.S; s += 32) {
    const float ii = __ldg(p.ii + s), jj = __ldg(p.jj + s);
    const float g = __ldg(p.gauss + s);
    const float cti = mul(ct, ii), stj = mul(st, jj);
    const float sti = mul(st, ii), ctj = mul(ct, jj);
    const int at = __ldg(p.place + s);
    const int slot = at & 0xffff, ob8 = at >> 16;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float sx = sub(add(kx[h], cti), stj);
      const float sy = add(add(ky[h], sti), ctj);
      const float2 v = sample_maps(p.maps, sx, sy, ox[h], oy[h], t1);
      const float mag = mul(sqrtf(add(mul(v.x, v.x), mul(v.y, v.y))), g);
      const float ang = sub(atan2f(v.y, v.x), th);
      const float ob = mul(mul(remainder_pos(ang, p.two_pi), p.inv_two_pi),
                           (float)kOrient);
      const int lo = (int)floorf(ob) & (kOrient - 1);
      sm.t[h][slot] = make_float2(hat(ob, lo, mag),
                                  hat(ob, (lo + 1) & (kOrient - 1), mag));
      sm.o[h][ob8] = (uint8_t)lo;
    }
  }
#pragma unroll
  for (int o = 0; o < kOrient; ++o) sm.acc[o][lane] = 0.0f;
  __syncwarp();

  // ---- phase 2: lane (h, p)'s 8 bins over cell p's nonzero terms ----
  const int h = lane >> 4, cell = lane & (kCells - 1);
  const float2* T = sm.t[h];
  const uint8_t* O = sm.o[h];
  float* acc = &sm.acc[0][lane];
  const int n = __ldg(p.lens + cell);
  for (int j = 0; j < n; ++j) {
    const int2 tm = __ldg(p.terms + j * kCells + cell);
    const float w = __int_as_float(tm.y);
    const float2 t = T[tm.x & 0xffff];
    const int lo = O[tm.x >> 16], hi = (lo + 1) & (kOrient - 1);
    acc[32 * lo] = add(acc[32 * lo], mul(w, t.x));
    acc[32 * hi] = add(acc[32 * hi], mul(w, t.y));
  }
  float a[kOrient];
#pragma unroll
  for (int o = 0; o < kOrient; ++o) a[o] = acc[32 * o];

  // ---- phase 3: normalise, clip, normalise, scale, bf16 ----
  const float n1 = norm8(a);
#pragma unroll
  for (int o = 0; o < kOrient; ++o) a[o] = min_nan(__fdiv_rn(a[o], n1), p.clip);
  const float n2 = norm8(a);
#pragma unroll
  for (int o = 0; o < kOrient; ++o) a[o] = mul(__fdiv_rn(a[o], n2), p.scale);
  p.out[(size_t)e * 32 + lane] = make_uint4(pack2(a[0], a[1]),
                                            pack2(a[2], a[3]),
                                            pack2(a[4], a[5]),
                                            pack2(a[6], a[7]));
}

}  // namespace

// An H x W map of {gx, gy} pairs in a CUDA array (block-linear: a warp's
// rotated samples fall on few cache lines), with the texture K5 reads it
// through (clamped, unfiltered) and the surface a launch writes it through:
// out = {array, texture, surface}. The caller keeps it for its calls on
// one stream.
extern "C" int edge_descriptors_maps_create(int H, int W,
                                            unsigned long long* out) {
  const cudaChannelFormatDesc fd = cudaCreateChannelDesc<float2>();
  cudaArray_t arr = nullptr;
  cudaError_t err = cudaMallocArray(&arr, &fd, W, H,
                                    cudaArraySurfaceLoadStore);
  if (err != cudaSuccess) return (int)err;
  cudaResourceDesc rd{};
  rd.resType = cudaResourceTypeArray;
  rd.res.array.array = arr;
  cudaTextureDesc td{};
  td.addressMode[0] = td.addressMode[1] = cudaAddressModeClamp;
  td.filterMode = cudaFilterModePoint;
  td.readMode = cudaReadModeElementType;
  cudaTextureObject_t tex = 0;
  cudaSurfaceObject_t surf = 0;
  err = cudaCreateTextureObject(&tex, &rd, &td, nullptr);
  if (err == cudaSuccess) err = cudaCreateSurfaceObject(&surf, &rd);
  if (err != cudaSuccess) return (int)err;
  out[0] = (unsigned long long)arr;
  out[1] = tex;
  out[2] = surf;
  return 0;
}

extern "C" int edge_descriptors_launch(
    const float* gx, const float* gy, unsigned long long tex,
    unsigned long long surf, int H, int W,
    const float* x, const float* y, const float* theta, int N, float shift,
    const float* ii, const float* jj, const float* gauss, const int* place,
    int S, const int* terms, const int* lens, int tile, int stride, float two_pi,
    float inv_two_pi, float clip, float scale, void* out,
    cudaStream_t stream) {
  if (N <= 0) return (int)cudaGetLastError();
  if (S <= 0 || S > kMaxSamples) return (int)cudaErrorInvalidValue;
  const int n = H * W;
  if (n <= 0) return (int)cudaErrorInvalidValue;
  interleave_kernel<<<(n + 255) / 256, 256, 0, stream>>>(gx, gy, surf, W,
                                                         n);
  Params p{tex, H, W, x, y, theta, N,
           shift, ii, jj, gauss, place, S,
           reinterpret_cast<const int2*>(terms),
           lens, tile, stride, two_pi, inv_two_pi, clip, scale,
           reinterpret_cast<uint4*>(out)};
  edge_descriptors_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0,
                            stream>>>(p);
  return (int)cudaGetLastError();
}

// What the built kernel is on this card: out[0..4] = warps a block,
// registers a thread, local (spill) bytes a thread, static shared bytes a
// block, blocks an SM holds (cudaOccupancyMaxActiveBlocksPerMultiprocessor).
extern "C" int edge_descriptors_info(int* out) {
  cudaFuncAttributes a{};
  cudaError_t err = cudaFuncGetAttributes(&a, edge_descriptors_kernel);
  if (err != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, edge_descriptors_kernel, kWarps * 32, 0);
  if (err != cudaSuccess) return (int)err;
  out[0] = kWarps;
  out[1] = a.numRegs;
  out[2] = (int)a.localSizeBytes;
  out[3] = (int)a.sharedSizeBytes;
  out[4] = per_sm;
  return 0;
}
