// TOED's directional NMS, parabola subpixel fit and raster-order
// compaction on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package computes this step with XLA ops
// (edge_based_visual_odometry_tpu/ops/toed.py::toed_nms_subpixel and
// extract_edges). The port's plain twin (ops/toed.py: the same two
// functions, the CPU path) runs ~100 elementwise passes over the
// (B, 2H, 2W) fields, then an int64 cumsum, a searchsorted and five
// gathers per image; on the card that took 2.5 ms a KITTI frame.
//
// What bounds it on the card: bytes. Every field pixel's Ix, Iy and |grad|
// are read once (12 B) and its 3 x 3 |grad| neighbourhood (from L2 or a
// shared tile); the orientation only at kept pixels; each EdgeList slot is
// written once (17 B). At 2 x 752 x 2482 (KITTI) that is 44.8 MB, 13.4 us
// at 3.35 TB/s.
//
// Design: two launches, both images in each (blockIdx.y).
//   1. Count pass, one block a field row: the row in chunks of 512
//      columns, each chunk's |grad| with a 1-pixel halo (3 x 514, zero
//      outside the field, as the twin's `_neighbor` pads) in shared
//      memory. Each thread tests 2 columns; the tests run cheapest first
//      and stop at the first that fails, so the parabola fit's divisions
//      run only on pixels past NMS. The kept columns of the row are
//      ranked by a ballot and a scan of the warps' counts, written in
//      raster order to the scratch `cols`, and their number to
//      `row_count`.
//   2. Write pass, one block a field row: its rank offset is the sum of
//      the earlier rows' counts (every row's count is summed too, for the
//      total); it recomputes the kept pixels alone (their 3 x 3 from global
//      memory) and writes each to its slot below `max_edges`. The image's
//      blocks share out the slots: `valid` for each, and zeros past the
//      count, as the twin's `pick` leaves them. Block 0 writes the count.
// Nothing is allocated or synchronised here: the wrapper hands in the
// scratch (`row_count`, `cols`, fully written by pass 1 where pass 2
// reads them) and the outputs, so the launches capture into a CUDA graph.
//
// Arithmetic: the twin's op order with `__f*_rn` intrinsics (no FMA
// contraction), IEEE division and square root as PyTorch's tensor-by-tensor
// `/` and `torch.sqrt` on the card; the quadrant chosen as the twin's
// `torch.where` chain chooses (the last match wins, none gives 0); every
// comparison as the twin writes it, so NaN fails it as there.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 256;            // count pass: threads a block
constexpr int PIX = 2;                  // columns a thread a chunk
constexpr int CHUNK = THREADS * PIX;    // columns a chunk
constexpr int WARPS = THREADS / 32;
constexpr int WTHREADS = 128;           // write pass: threads a block
constexpr int WWARPS = WTHREADS / 32;
constexpr float SQRT2_F32 = 1.41421353816986083984375f;  // f32(sqrt(2))
constexpr float DIR_EPS = 1e-5f;

struct Args {
  const float* ix;
  const float* iy;
  const float* g;
  const float* orient;
  int fh, fw;              // field rows (2H) and columns (2W)
  float lo;                // border, as float32 (the twin's comparisons)
  float fh_hi, fw_hi;      // 2H - border, 2W - border
  float h_hi, w_hi;        // H - border, W - border
  float gmin;              // grad_mag_min
  int max_edges;
  int* row_count;          // (B, fh) kept pixels a row
  int* cols;               // (B, fh, fw) a row's kept columns, in order
  float* x;                // (B, max_edges) each
  float* y;
  float* theta;
  float* mag;
  unsigned char* ok;
  int* count;              // (B,)
};

__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float dv(float a, float b) { return __fdiv_rn(a, b); }

// The twin's keep at field pixel (i, j): n[r][c] is |grad| at
// (i + r - 1, j + c - 1), zero outside the field. Where it keeps the pixel
// it sets the image-coordinate position and the subpixel magnitude.
__device__ __forceinline__ bool edge_at(const float (&n)[3][3], float ix,
                                        float iy, int i, int j, const Args& a,
                                        float& ex, float& ey, float& smag) {
  const float g = n[1][1];
  const float fi = (float)i, fj = (float)j;
  const float ax = fabsf(ix), ay = fabsf(iy);
  if (!(fi >= a.lo && fi < a.fh_hi && fj >= a.lo && fj < a.fw_hi)) return false;
  if (!(g > a.gmin)) return false;
  if (ax < DIR_EPS && ay < DIR_EPS) return false;

  const float nd_x = dv(ix, g), nd_y = dv(iy, g);
  const bool px = ix >= 0.0f, py = iy >= 0.0f;
  int q = -1;
  if (px && py && ix >= iy) q = 0;
  if (px && py && ix < iy) q = 1;
  if (!px && py && ax < iy) q = 2;
  if (!px && py && ax >= iy) q = 3;
  if (!px && !py && ax >= ay) q = 4;
  if (!px && !py && ax < ay) q = 5;
  if (px && !py && ix < ay) q = 6;
  if (px && !py && ix >= ay) q = 7;
  float slope = 0.0f, fp = 0.0f, fm = 0.0f;
  if (q >= 0) {
    // the twin's (fp_a, fp_b), (fm_a, fm_b) of quadrant q: fm's lie
    // opposite fp's
    float pa, pb, ma, mb;
    switch (q) {
      case 0: pa = n[1][2]; pb = n[2][2]; ma = n[1][0]; mb = n[0][0]; break;
      case 1: pa = n[2][1]; pb = n[2][2]; ma = n[0][1]; mb = n[0][0]; break;
      case 2: pa = n[2][1]; pb = n[2][0]; ma = n[0][1]; mb = n[0][2]; break;
      case 3: pa = n[1][0]; pb = n[2][0]; ma = n[1][2]; mb = n[0][2]; break;
      case 4: pa = n[1][0]; pb = n[0][0]; ma = n[1][2]; mb = n[2][2]; break;
      case 5: pa = n[0][1]; pb = n[0][0]; ma = n[2][1]; mb = n[2][2]; break;
      case 6: pa = n[0][1]; pb = n[0][2]; ma = n[2][1]; mb = n[2][0]; break;
      default: pa = n[1][2]; pb = n[0][2]; ma = n[1][0]; mb = n[2][0]; break;
    }
    const bool yx = q == 0 || q == 3 || q == 4 || q == 7;
    float sl = yx ? dv(nd_y, nd_x) : dv(nd_x, nd_y);
    if (q == 2 || q == 3 || q == 6 || q == 7) sl = -sl;
    const float w = sub(1.0f, sl);
    slope = sl;
    fp = add(mul(pa, w), mul(pb, sl));
    fm = add(mul(ma, w), mul(mb, sl));
  }
  if (!((g > fm && g >= fp) || (g >= fm && g > fp))) return false;

  const float s = __fsqrt_rn(add(mul(slope, slope), 1.0f));
  const float A = dv(sub(add(fm, fp), mul(2.0f, g)), mul(mul(2.0f, s), s));
  const float Bq = dv(sub(fp, fm), mul(2.0f, s));
  const float ss = dv(-Bq, mul(2.0f, A));
  if (!(fabsf(ss) <= SQRT2_F32)) return false;
  ex = mul(sub(add(fj, mul(ss, nd_x)), 1.0f), 0.5f);
  ey = mul(sub(add(fi, mul(ss, nd_y)), 1.0f), 0.5f);
  if (!(ex > a.lo && ex < a.w_hi && ey > a.lo && ey < a.h_hi)) return false;
  const float max_f = add(add(mul(mul(A, ss), ss), mul(Bq, ss)), g);
  const float gx = mul(max_f, nd_x), gy = mul(max_f, nd_y);
  smag = __fsqrt_rn(add(mul(gx, gx), mul(gy, gy)));
  return true;
}

__global__ void __launch_bounds__(THREADS)
toed_nms_count_kernel(const Args a) {
  __shared__ float tile[3][CHUNK + 2];
  __shared__ int warp_n[PIX][WARPS];
  const int i = blockIdx.x, b = blockIdx.y;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const size_t plane = (size_t)a.fh * a.fw;
  const float* g = a.g + b * plane;
  const size_t row = (size_t)i * a.fw;
  const float* ixr = a.ix + b * plane + row;
  const float* iyr = a.iy + b * plane + row;
  int* cols = a.cols + b * plane + row;
  const unsigned below = (1u << lane) - 1u;
  int kept = 0;
  for (int j0 = 0; j0 < a.fw; j0 += CHUNK) {
    // the chunk's |grad| tile and this thread's Ix, Iy, all loads in
    // flight together
    float ixv[PIX], iyv[PIX];
#pragma unroll
    for (int p = 0; p < PIX; ++p) {
      const int j = j0 + p * THREADS + t;
      ixv[p] = j < a.fw ? __ldg(ixr + j) : 0.0f;
      iyv[p] = j < a.fw ? __ldg(iyr + j) : 0.0f;
    }
#pragma unroll
    for (int m = 0; m <= PIX; ++m) {
      const int k = m * THREADS + t, c = j0 - 1 + k;
      if (k >= CHUNK + 2) break;
      const bool in_c = c >= 0 && c < a.fw;
#pragma unroll
      for (int r = 0; r < 3; ++r) {
        const int rr = i - 1 + r;
        tile[r][k] = (in_c && rr >= 0 && rr < a.fh)
                         ? __ldg(g + (size_t)rr * a.fw + c) : 0.0f;
      }
    }
    __syncthreads();
    unsigned mask[PIX];
    bool keep[PIX];
#pragma unroll
    for (int p = 0; p < PIX; ++p) {
      const int k = p * THREADS + t, j = j0 + k;
      keep[p] = false;
      if (j < a.fw) {
        float n[3][3];
#pragma unroll
        for (int r = 0; r < 3; ++r)
#pragma unroll
          for (int c = 0; c < 3; ++c) n[r][c] = tile[r][k + c];
        float ex, ey, smag;
        keep[p] = edge_at(n, ixv[p], iyv[p], i, j, a, ex, ey, smag);
      }
      mask[p] = __ballot_sync(0xffffffffu, keep[p]);
      if (lane == 0) warp_n[p][w] = __popc(mask[p]);
    }
    __syncthreads();
    // the chunk's kept columns in raster order: (p, warp, lane)
    int before = 0;
#pragma unroll
    for (int p = 0; p < PIX; ++p) {
      int off = before;
      for (int v = 0; v < w; ++v) off += warp_n[p][v];
      if (keep[p])
        cols[kept + off + __popc(mask[p] & below)] = j0 + p * THREADS + t;
#pragma unroll
      for (int v = 0; v < WARPS; ++v) before += warp_n[p][v];
    }
    kept += before;
  }
  if (t == 0) a.row_count[(size_t)b * a.fh + i] = kept;
}

__device__ __forceinline__ int block_sum(int v, int* scratch) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) scratch[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = 0;
#pragma unroll
  for (int k = 0; k < WWARPS; ++k) s += scratch[k];
  return s;
}

__global__ void __launch_bounds__(WTHREADS)
toed_nms_write_kernel(const Args a) {
  __shared__ int sums[2][WWARPS];
  const int i = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const int* rc = a.row_count + (size_t)b * a.fh;
  int pre = 0, tot = 0;
  for (int r = t; r < a.fh; r += WTHREADS) {
    const int c = rc[r];
    tot += c;
    if (r < i) pre += c;
  }
  pre = block_sum(pre, sums[0]);
  tot = block_sum(tot, sums[1]);
  const int M = a.max_edges;
  const int cnt = min(tot, M);
  if (i == 0 && t == 0) a.count[b] = cnt;

  const size_t plane = (size_t)a.fh * a.fw;
  const float* g = a.g + b * plane;
  const size_t out0 = (size_t)b * M;
  const int n_row = rc[i];
  const int* cols = a.cols + b * plane + (size_t)i * a.fw;
  for (int k = t; k < n_row && pre + k < M; k += WTHREADS) {
    const int j = cols[k];
    float n[3][3];
#pragma unroll
    for (int r = 0; r < 3; ++r)
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int rr = i - 1 + r, cc = j - 1 + c;
        n[r][c] = (rr >= 0 && rr < a.fh && cc >= 0 && cc < a.fw)
                      ? g[(size_t)rr * a.fw + cc] : 0.0f;
      }
    const size_t at = b * plane + (size_t)i * a.fw + j;
    float ex = 0.0f, ey = 0.0f, smag = 0.0f;
    edge_at(n, a.ix[at], a.iy[at], i, j, a, ex, ey, smag);
    const size_t s = out0 + pre + k;
    a.x[s] = ex;
    a.y[s] = ey;
    a.theta[s] = a.orient[at];
    a.mag[s] = smag;
  }
  for (int k = i * WTHREADS + t; k < M; k += a.fh * WTHREADS) {
    const size_t s = out0 + k;
    a.ok[s] = k < cnt;
    if (k >= cnt) {
      a.x[s] = 0.0f;
      a.y[s] = 0.0f;
      a.theta[s] = 0.0f;
      a.mag[s] = 0.0f;
    }
  }
}

}  // namespace

// Ix, Iy, |grad|, orientation: (B, 2H, 2W) float32; H, W the image's
// size. Scratch: row_count (B, 2H) and cols (B, 2H, 2W) int32. Outputs:
// x, y, theta, mag (B, max_edges) float32, ok (B, max_edges) bool, count
// (B,) int32.
extern "C" int toed_nms_compact_launch(
    const float* ix, const float* iy, const float* g, const float* orient,
    int B, int H, int W, int border, float grad_mag_min, int max_edges,
    int* row_count, int* cols, float* x, float* y, float* theta, float* mag,
    unsigned char* ok, int* count, cudaStream_t stream) {
  if (B <= 0 || H <= 0 || W <= 0 || max_edges < 0 || B > 65535
      || (long long)(2 * (long long)H) * (2 * (long long)W) >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.ix = ix;
  a.iy = iy;
  a.g = g;
  a.orient = orient;
  a.fh = 2 * H;
  a.fw = 2 * W;
  a.lo = (float)border;
  a.fh_hi = (float)(2 * (long long)H - border);
  a.fw_hi = (float)(2 * (long long)W - border);
  a.h_hi = (float)((long long)H - border);
  a.w_hi = (float)((long long)W - border);
  a.gmin = grad_mag_min;
  a.max_edges = max_edges;
  a.row_count = row_count;
  a.cols = cols;
  a.x = x;
  a.y = y;
  a.theta = theta;
  a.mag = mag;
  a.ok = ok;
  a.count = count;
  const dim3 grid(a.fh, B);
  toed_nms_count_kernel<<<grid, THREADS, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  toed_nms_write_kernel<<<grid, WTHREADS, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
