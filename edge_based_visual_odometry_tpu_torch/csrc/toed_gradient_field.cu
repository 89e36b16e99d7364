// TOED gradient field on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `toed_gradient_field_pallas` (body
// `_kernel`) of edge_based_visual_odometry_tpu/ops/toed_pallas.py, which
// computes what ops/toed.py::toed_gradient_field computes: the separable
// third-order filter bank - 12 column and 36 row correlations of 19 taps
// (filters.toed_separable_taps) at 4 half-pixel phases - then |grad| and
// the third-order direction, written interleaved onto the (2H, 2W) grid.
//
// What bounds it on the card: arithmetic and shared-memory reads, not
// device memory. Per low-res pixel it reads 1 float and writes 16 (4
// phases x Ix, Iy, |grad|, orient), but does ~1,000 FMAs: 12 x 19 for its
// column channels (plus the halo columns' share) and 36 x 19 for the row
// pass. At 376x1241 x 2 images that is ~1 GFLOP against ~60 MB of output.
//
// Design: one CTA per 16 x 64 tile of low-res pixels and one image
// (blockIdx.z). The image slab with a 9-pixel halo on every side, zero
// outside the image (the reference's zero padding), is loaded once into
// shared memory; the column pass writes the 12 column channels of the
// 16 x 82 halo-wide strip to dynamic shared memory (~63 KB); the row pass
// reads them back for all 4 phases from the one slab, so no phase grid
// axis is needed. Taps live in __constant__ memory (uniform addresses
// broadcast). atan2f runs in the kernel and each phase is stored straight
// to its interleaved position.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HALO = 9;
constexpr int K = 2 * HALO + 1;     // 19 taps
constexpr int NCOL = 12;            // column channels
constexpr int NOUT = 36;            // 4 phases x 9 derivatives
constexpr int TH = 16;              // tile rows (low-res pixels)
constexpr int TW = 64;              // tile cols
constexpr int SH = TH + 2 * HALO;   // slab rows
constexpr int SW = TW + 2 * HALO;   // slab cols
constexpr int THREADS = 256;
constexpr size_t SMEM_BYTES = sizeof(float) * (SH * SW + NCOL * TH * SW);

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

__constant__ float c_col[NCOL * K];
__constant__ float c_row[NOUT * K];
__constant__ int c_sel[NOUT];

__global__ void __launch_bounds__(THREADS)
toed_gradient_field_kernel(const float* __restrict__ img, int H, int W,
                           float* __restrict__ out_ix,
                           float* __restrict__ out_iy,
                           float* __restrict__ out_mag,
                           float* __restrict__ out_orient) {
  extern __shared__ float smem[];
  float* slab = smem;                  // [SH][SW]
  float* cols = smem + SH * SW;        // [NCOL][TH][SW]
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const float* im = img + (size_t)b * H * W;

  for (int i = threadIdx.x; i < SH * SW; i += THREADS) {
    const int r = i / SW, c = i % SW;
    const int gy = y0 - HALO + r, gx = x0 - HALO + c;
    slab[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                  ? __ldg(im + (size_t)gy * W + gx) : 0.0f;
  }
  __syncthreads();

  // column pass: cols[ch][r][c] = sum_a col[ch][a] * slab[r + a][c]
  for (int i = threadIdx.x; i < TH * SW; i += THREADS) {
    const int r = i / SW, c = i % SW;
    float v[K];
#pragma unroll
    for (int a = 0; a < K; ++a) v[a] = slab[(r + a) * SW + c];
#pragma unroll
    for (int ch = 0; ch < NCOL; ++ch) {
      float acc = 0.0f;
#pragma unroll
      for (int a = 0; a < K; ++a) acc = fmaf(c_col[ch * K + a], v[a], acc);
      cols[(ch * TH + r) * SW + c] = acc;
    }
  }
  __syncthreads();

  // row pass, all 4 phases: d[o] = sum_a row[o][a] * cols[sel[o]][r][c + a]
  const size_t W2 = 2 * (size_t)W;
  const size_t plane = (size_t)4 * H * W;
  for (int i = threadIdx.x; i < TH * TW; i += THREADS) {
    const int r = i / TW, c = i % TW;
    const int gy = y0 + r, gx = x0 + c;
    if (gy >= H || gx >= W) continue;
#pragma unroll
    for (int ph = 0; ph < 4; ++ph) {
      float d[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int o = ph * 9 + k;
        const float* src = cols + (c_sel[o] * TH + r) * SW + c;
        float acc = 0.0f;
#pragma unroll
        for (int a = 0; a < K; ++a) acc = fmaf(c_row[o * K + a], src[a], acc);
        d[k] = acc;
      }
      const float fx = d[0], fy = d[1], fxx = d[2], fxy = d[3], fyy = d[4];
      const float fxxy = d[5], fxyy = d[6], fxxx = d[7], fyyy = d[8];
      // third-order direction, evaluated left to right without FMA
      // contraction (the plain twin's rounding)
      const float mag = __fsqrt_rn(add(mul(fx, fx), mul(fy, fy)));
      const float to_ix = add(add(add(add(
          mul(fx, add(mul(mul(2.0f, fxx), fxx), mul(mul(2.0f, fxy), fxy))),
          mul(fy, add(mul(mul(2.0f, fxx), fxy), mul(mul(2.0f, fyy), fxy)))),
          mul(mul(mul(2.0f, fx), fy), fxxy)),
          mul(mul(fy, fy), fxyy)),
          mul(mul(fx, fx), fxxx));
      const float to_iy = add(add(add(add(
          mul(fx, add(mul(mul(2.0f, fxx), fxy), mul(mul(2.0f, fyy), fxy))),
          mul(fy, add(mul(mul(2.0f, fyy), fyy), mul(mul(2.0f, fxy), fxy)))),
          mul(mul(mul(2.0f, fx), fy), fxyy)),
          mul(mul(fx, fx), fxxy)),
          mul(mul(fy, fy), fyyy));
      const size_t at = (size_t)b * plane
                        + (2 * (size_t)gy + (ph >> 1)) * W2
                        + 2 * (size_t)gx + (ph & 1);
      out_ix[at] = fx;
      out_iy[at] = fy;
      out_mag[at] = mag;
      out_orient[at] = atan2f(to_ix, -to_iy);
    }
  }
}

}  // namespace

extern "C" int toed_gradient_field_launch(
    const float* img, int B, int H, int W, float* ix, float* iy, float* mag,
    float* orient, const float* col_taps, const float* row_taps,
    const int* row_select, cudaStream_t stream) {
  static bool attr_set = false;
  cudaError_t err;
  if (!attr_set) {
    err = cudaFuncSetAttribute(toed_gradient_field_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  err = cudaMemcpyToSymbolAsync(c_col, col_taps, sizeof(float) * NCOL * K, 0,
                                cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbolAsync(c_row, row_taps, sizeof(float) * NOUT * K, 0,
                                cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  err = cudaMemcpyToSymbolAsync(c_sel, row_select, sizeof(int) * NOUT, 0,
                                cudaMemcpyHostToDevice, stream);
  if (err != cudaSuccess) return (int)err;
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  toed_gradient_field_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      img, H, W, ix, iy, mag, orient);
  return (int)cudaGetLastError();
}
