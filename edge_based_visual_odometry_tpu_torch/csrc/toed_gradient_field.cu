// TOED gradient field on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `toed_gradient_field_pallas` (body
// `_kernel`) of edge_based_visual_odometry_tpu/ops/toed_pallas.py, which
// computes what ops/toed.py::toed_gradient_field computes: the separable
// third-order filter bank - 12 column and 36 row correlations of 19 taps
// (filters.toed_separable_taps) at 4 half-pixel phases - then |grad| and
// the third-order direction, written interleaved onto the (2H, 2W) grid.
//
// What bounds it on the card: arithmetic. Per low-res pixel it reads 1
// float and writes 16 (4 phases x Ix, Iy, |grad|, orient) but does 912
// FMAs (12 x 19 column, 36 x 19 row) and 4 epilogues: at 376x1241 x 2
// images ~1.9 GFLOP against ~63 MB, ~29 us at 67 TFLOP/s vs ~19 us at
// 3.35 TB/s. The first version spent over half its time on shared-memory
// reads: one 4-byte load per row-pass FMA.
//
// Design: one CTA per 8 x 64 tile of low-res pixels and one image
// (blockIdx.z), 40 KB of shared memory, so 5 CTAs share an SM.
//   - The image slab with a 9-pixel halo on every side, zero outside the
//     image (the reference's zero padding), is loaded once into shared
//     memory; the column pass writes the 12 column channels of the
//     8 x 82 halo-wide strip to shared memory (row stride 83: odd, so
//     the row pass's loads are free of bank conflicts).
//   - Row pass, register-blocked: each thread owns N = COLS adjacent
//     output columns of one row (4; 8 measured slower: more registers,
//     fewer warps). For each phase it loads each of the phase's 4 column
//     channels' (N + 18)-wide window into registers once and applies
//     every row filter fed by that channel (3, 3, 2 and 1 of the 9) to
//     all N outputs: per phase 4 (N + 18) loads for 171 N FMAs, 0.13
//     loads per FMA at N = 4 (the first version: 1). Which channel
//     feeds which output is fixed by the filter bank (phase_base and
//     deriv_ychan below; the wrapper checks it).
//   - A warp covers N rows x 32/N column groups, so its 32 lanes read 32
//     different banks.
//   - Phases run in the order (0,0), (0,1), (1,0), (1,1); both phases of
//     an output row stay in registers, then the tile's output rows are
//     staged in the slab's shared memory (free after the column pass), two
//     maps at a time, and written as float2 pairs (both half-pixel columns
//     of a low-res pixel) with consecutive threads on consecutive pairs:
//     each warp store writes 256 contiguous bytes. Stores straight from
//     the row pass's layout (lanes spread over rows and column groups)
//     measured at a third of the kernel's time. The loop over the two
//     output rows is not unrolled: that halves the code and the registers,
//     which measured faster than full unrolling.
//   - Taps travel in the launch's parameter block (its constant bank),
//     built once per (kernel_size, sigma) by the wrapper, so nothing
//     copies host memory to the device around a launch.
// Each output keeps the first version's accumulation order (a = 0..18
// with fmaf, from 0), and the epilogue is evaluated left to right without
// FMA contraction (the plain twin's rounding).

#include <cuda_runtime.h>
#include <math.h>
#include <string.h>

namespace {

constexpr int HALO = 9;
constexpr int K = 2 * HALO + 1;     // 19 taps
constexpr int NCOL = 12;            // column channels
constexpr int NOUT = 36;            // 4 phases x 9 derivatives
constexpr int TH = 8;               // tile rows (low-res pixels)
#ifndef TOED_COLS
#define TOED_COLS 4                 // scripts/k1_variants.py builds 8 too
#endif
constexpr int COLS = TOED_COLS;     // output columns per row-pass thread
constexpr int TW = 64;              // tile cols
constexpr int SH = TH + 2 * HALO;   // slab rows
constexpr int SW = TW + 2 * HALO;   // slab cols = column-pass cols
constexpr int CS = SW + 1;          // row stride of a column channel (odd)
constexpr int OS2 = TW + 1;         // row stride of the output stage (float2)
static_assert(2 * 2 * TH * OS2 <= SH * SW, "output stage fits the slab");
constexpr size_t SMEM_BYTES = sizeof(float) * (SH * SW + NCOL * TH * CS);

struct Taps {
  float col[NCOL * K];
  float row[NOUT * K];
};

// column channel feeding output (phase ph, derivative k): the phase's
// y-filter block (8 truncated for (0,0), 0 unshifted for (0,1), 4 shifted
// for (1,x)) plus the derivative's y-filter (G 0, Gx 1, Gxx 2, Gxxx 3)
__host__ __device__ constexpr int phase_base(int ph) {
  return ph == 0 ? 8 : (ph == 1 ? 0 : 4);
}
__host__ __device__ constexpr int deriv_ychan(int k) {
  return (k == 1 || k == 3 || k == 5) ? 1
         : (k == 4 || k == 6) ? 2 : (k == 8 ? 3 : 0);
}

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }

// (Ix, Iy, |grad|, orient) of one output from its 9 derivatives
__device__ __forceinline__ float4 epilogue(float fx, float fy, float fxx,
                                           float fxy, float fyy, float fxxy,
                                           float fxyy, float fxxx,
                                           float fyyy) {
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
  return make_float4(fx, fy, mag, atan2f(to_ix, -to_iy));
}

constexpr int THREADS = TH * TW / COLS;

__global__ void __launch_bounds__(THREADS, 1)
toed_gradient_field_kernel(const float* __restrict__ img, int H, int W,
                           float* __restrict__ out_ix,
                           float* __restrict__ out_iy,
                           float* __restrict__ out_mag,
                           float* __restrict__ out_orient,
                           const __grid_constant__ Taps taps) {
  constexpr int N = COLS;
  constexpr int WG = 32 / N;          // column groups per warp (N rows)
  constexpr int BANDS = TH / N;       // warp row bands in the tile
  static_assert(TH % N == 0 && 32 % N == 0 && TW % (WG * N) == 0, "tiling");
  extern __shared__ float smem[];
  float* slab = smem;                  // [SH][SW]
  float* cols = smem + SH * SW;        // [NCOL][TH][CS]
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
      for (int a = 0; a < K; ++a) acc = fmaf(taps.col[ch * K + a], v[a], acc);
      cols[(ch * TH + r) * CS + c] = acc;
    }
  }
  __syncthreads();

  // row pass: d[o][j] = sum_a row[o][a] * cols[sel[o]][r][c0 + j + a]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int r = (warp % BANDS) * N + lane % N;
  const int c0 = ((warp / BANDS) * WG + lane / N) * N;
  const size_t W2 = 2 * (size_t)W;
  const size_t plane = (size_t)4 * H * W;
  // the slab's shared memory, free after the column pass, stages two maps
  // of an output row set for coalesced stores: [2][TH][OS2] float2 pairs
  // (both half-pixel columns of a low-res pixel); OS2 * 2 = 2 (mod 32)
  // floats keeps the row pass's float2 writes free of bank conflicts
  float2* stage = reinterpret_cast<float2*>(slab);
  // one output row per pass; not unrolled, which keeps the code (and the
  // registers) of one pass: the row taps are then read by index
#pragma unroll 1
  for (int sy = 0; sy < 2; ++sy) {
    float4 e[2][N];                    // per sx: (Ix, Iy, |grad|, orient)
#pragma unroll
    for (int sx = 0; sx < 2; ++sx) {
      const int ph = 2 * sy + sx;
      float d[9][N];
#pragma unroll
      for (int k = 0; k < 9; ++k)
#pragma unroll
        for (int j = 0; j < N; ++j) d[k][j] = 0.0f;
#pragma unroll
      for (int yc = 0; yc < 4; ++yc) {
        const float* src = cols + ((phase_base(ph) + yc) * TH + r) * CS + c0;
        float w[N + K - 1];
#pragma unroll
        for (int i = 0; i < N + K - 1; ++i) w[i] = src[i];
#pragma unroll
        for (int k = 0; k < 9; ++k) {
          if (deriv_ychan(k) != yc) continue;
#pragma unroll
          for (int a = 0; a < K; ++a)
#pragma unroll
            for (int j = 0; j < N; ++j)
              d[k][j] = fmaf(taps.row[(ph * 9 + k) * K + a], w[j + a], d[k][j]);
        }
      }
#pragma unroll
      for (int j = 0; j < N; ++j)
        e[sx][j] = epilogue(d[0][j], d[1][j], d[2][j], d[3][j], d[4][j],
                            d[5][j], d[6][j], d[7][j], d[8][j]);
    }
    // output row 2gy+sy of the tile's rows, two maps at a time: each warp
    // store writes 256 contiguous bytes of one row (8-byte aligned: W2 and
    // the plane are even)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
#pragma unroll
      for (int j = 0; j < N; ++j) {
        stage[r * OS2 + c0 + j] = half
            ? make_float2(e[0][j].z, e[1][j].z) : make_float2(e[0][j].x, e[1][j].x);
        stage[(TH + r) * OS2 + c0 + j] = half
            ? make_float2(e[0][j].w, e[1][j].w) : make_float2(e[0][j].y, e[1][j].y);
      }
      __syncthreads();
      for (int i = threadIdx.x; i < 2 * TH * TW; i += THREADS) {
        const int m = i / (TH * TW), rr = (i / TW) % TH, q = i % TW;
        if (y0 + rr >= H || x0 + q >= W) continue;
        float* out = half ? (m ? out_orient : out_mag) : (m ? out_iy : out_ix);
        // streaming store: the 60 MB of output is not read again here
        __stcs(reinterpret_cast<float2*>(
                   out + b * plane + (2 * (size_t)(y0 + rr) + sy) * W2
                   + 2 * (size_t)(x0 + q)),
               stage[(m * TH + rr) * OS2 + q]);
      }
      __syncthreads();
    }
  }
}

}  // namespace

// taps: host floats, 12 x 19 column taps then 36 x 19 row taps; they are
// passed by value in the launch.
extern "C" int toed_gradient_field_launch(
    const float* img, int B, int H, int W, float* ix, float* iy, float* mag,
    float* orient, const float* taps, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0) return (int)cudaGetLastError();
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        toed_gradient_field_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  Taps t;
  memcpy(t.col, taps, sizeof(t.col));
  memcpy(t.row, taps + NCOL * K, sizeof(t.row));
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  toed_gradient_field_kernel<<<grid, THREADS, SMEM_BYTES, stream>>>(
      img, H, W, ix, iy, mag, orient, t);
  return (int)cudaGetLastError();
}
