// The front end's image pyramid and the previous frame's gradient pyramid:
// ops/image.py::pyr_down (one launch a level) and scharr_gradients over
// every level of a pyramid (one launch for all levels), each for all lanes,
// with the plain chain's bits.
//
// The JAX package has no TPU kernel for either: larvio_tpu/ops/image.py runs
// them as XLA operations (its banded-matmul pyr_down is TPU-only and not
// ported). On the card the plain chain (ops/image.py::_sep_apply: a
// replicate pad per axis, then a multiply pass and an add pass per tap, and
// pyr_down's strided copy) is 143 PyTorch kernels a frame at three levels,
// each reading and writing full-size float32 arrays: ~46 GB a 256-lane
// batched frame at 752x480.
//
// What bounds it on an H100: bytes. The work needs each source image read
// once and each output written once: level 0 read (369.6 MB at 256 lanes
// of 752x480), levels 1-2 read and levels 1-3 written (236.8 MB), the
// previous pyramid's four levels read (490.9 MB) and its eight gradient
// images written (981.7 MB): ~2.08 GB, 0.62 ms at 3.35 TB/s a batched frame.
// Both kernels read a tile of the source and its clamped halo into shared
// memory with coalesced loads, all of a thread's loads issued before the
// first is used, and write only the outputs, in rows that whole warps
// store; no intermediate goes to device memory. The halos are re-read from
// L2 by the neighbouring tiles.
//   - pyr_down_kernel: one block for PD_TY x PD_TX outputs of level L+1
//     (grid (tiles x, tiles y, B)); it loads level L's rows and columns
//     2i-2 .. 2i+2 of its tile, runs the row pass at the even rows only (the
//     decimation keeps no other), keeping even and odd columns apart in
//     shared memory (the column pass then reads without bank conflicts), and
//     the column pass at the even columns only. An output depends only on
//     its own taps, so computing the kept pixels alone gives the same bits.
//   - scharr_kernel: one block for SC_TY x SC_TX pixels of one level (grid
//     (the tiles of every level, B)); each thread takes one column and
//     SC_RUN rows of the tile, sliding a 3 x 3 register window down them:
//     per row three shared-memory reads, the row passes at x-1, x, x+1, the
//     column passes, two stores.
//
// The bits are the plain chain's (as in detect.cu):
//   - each separable filter runs its row taps (axis -2) before its column
//     taps (axis -1); zero taps are skipped; every tap is __fmul_rn(x, tap)
//     with the tap in float32, summed with __fadd_rn from the first nonzero
//     tap on, in tap order (nothing is contracted into an FMA);
//   - edge replication is an index clamp into the image's domain, which is
//     every intermediate's domain: a row-pass value at a column out of the
//     image is the clamped column's, a row out of the image is its edge row;
//   - pyr_down's level L+1 is (ceil(H/2), ceil(W/2)), its pixel (i, j) the
//     filtered level L at (2i, 2j).
// Nothing depends on the grid or the lane count. tests/test_torch_pyramid.py
// emulates both kernels block by block in numpy; tests/test_torch_cuda.py
// holds them to the plain chain on the card.

#include <cuda_runtime.h>

#define PYR_MAX_LEVELS 8

#define PD_TX 32  // output columns of a pyr_down block
#define PD_TY 16  // output rows of a pyr_down block
#define PD_IN_W (2 * PD_TX + 3)
#define PD_IN_H (2 * PD_TY + 3)
#define PD_THREADS 256

#define SC_TX 64  // columns of a scharr block
#define SC_TY 32  // rows of a scharr block
#define SC_THREADS 256
#define SC_RUN (SC_TY * SC_TX / SC_THREADS)  // rows a thread

// [1, 4, 6, 4, 1] / 16 over five values, left to right
__device__ __forceinline__ float pyr_k5(float p0, float p1, float p2, float p3, float p4) {
  float acc = __fmul_rn(p0, 0.0625f);
  acc = __fadd_rn(acc, __fmul_rn(p1, 0.25f));
  acc = __fadd_rn(acc, __fmul_rn(p2, 0.375f));
  acc = __fadd_rn(acc, __fmul_rn(p3, 0.25f));
  return __fadd_rn(acc, __fmul_rn(p4, 0.0625f));
}

// [3, 10, 3] / 32 over three values, left to right
__device__ __forceinline__ float pyr_smooth3(float a, float b, float c) {
  const float s3 = 0.09375f, s10 = 0.3125f;
  return __fadd_rn(__fadd_rn(__fmul_rn(a, s3), __fmul_rn(b, s10)), __fmul_rn(c, s3));
}

// [-1, 0, 1]: the zero tap skipped
__device__ __forceinline__ float pyr_diff3(float a, float c) {
  return __fadd_rn(__fmul_rn(a, -1.0f), __fmul_rn(c, 1.0f));
}

__global__ void __launch_bounds__(PD_THREADS)
pyr_down_kernel(const float* __restrict__ src, int H, int W, float* __restrict__ dst, int Ho,
                int Wo) {
  __shared__ float in[PD_IN_H * PD_IN_W];    // level L rows 2 i0 - 2 .. and columns 2 j0 - 2 ..
  __shared__ float rpe[PD_TY][PD_TX + 2];    // the row pass at the tile's even columns
  __shared__ float rpo[PD_TY][PD_TX + 1];    // and at its odd columns
  const int t = threadIdx.x;
  const int j0 = blockIdx.x * PD_TX, i0 = blockIdx.y * PD_TY;
  const size_t b = blockIdx.z;
  const float* s = src + b * (size_t)H * (size_t)W;
  const int ys = 2 * i0 - 2, xs = 2 * j0 - 2;
  constexpr int N = PD_IN_H * PD_IN_W;
  float v[(N + PD_THREADS - 1) / PD_THREADS];
#pragma unroll
  for (int i = 0; i < (N + PD_THREADS - 1) / PD_THREADS; ++i) {
    const int e = t + i * PD_THREADS;
    if (e < N) {
      const int r = e / PD_IN_W, c = e - r * PD_IN_W;
      const int y = min(max(ys + r, 0), H - 1), x = min(max(xs + c, 0), W - 1);
      v[i] = __ldg(s + (size_t)y * W + x);
    }
  }
#pragma unroll
  for (int i = 0; i < (N + PD_THREADS - 1) / PD_THREADS; ++i) {
    const int e = t + i * PD_THREADS;
    if (e < N) in[e] = v[i];
  }
  __syncthreads();
  // the row pass at the even rows 2i: rows 2i-2 .. 2i+2 are the tile's 2r .. 2r+4
  for (int e = t; e < PD_TY * PD_IN_W; e += PD_THREADS) {
    const int r = e / PD_IN_W, c = e - r * PD_IN_W;
    const float* p = in + 2 * r * PD_IN_W + c;
    const float x = pyr_k5(p[0], p[PD_IN_W], p[2 * PD_IN_W], p[3 * PD_IN_W], p[4 * PD_IN_W]);
    if (c & 1)
      rpo[r][c >> 1] = x;
    else
      rpe[r][c >> 1] = x;
  }
  __syncthreads();
  // the column pass at the even columns 2j: the tile's columns 2c .. 2c+4
  for (int e = t; e < PD_TY * PD_TX; e += PD_THREADS) {
    const int r = e / PD_TX, c = e % PD_TX;
    const int i = i0 + r, j = j0 + c;
    if (i < Ho && j < Wo)
      dst[b * (size_t)Ho * (size_t)Wo + (size_t)i * Wo + j] =
          pyr_k5(rpe[r][c], rpo[r][c], rpe[r][c + 1], rpo[r][c + 1], rpe[r][c + 2]);
  }
}

struct ScharrLevels {
  const float* src[PYR_MAX_LEVELS];
  float* gx[PYR_MAX_LEVELS];
  float* gy[PYR_MAX_LEVELS];
  int H[PYR_MAX_LEVELS];
  int W[PYR_MAX_LEVELS];
  int tiles_x[PYR_MAX_LEVELS];
  int first[PYR_MAX_LEVELS + 1];  // each level's first block; first[levels] blocks in all
  int levels;
};

__global__ void __launch_bounds__(SC_THREADS) scharr_kernel(const ScharrLevels p) {
  __shared__ float tile[(SC_TY + 2) * (SC_TX + 2)];  // rows y0 - 1 .., columns x0 - 1 .., clamped
  const int k = blockIdx.x;
  int l = 0;
  while (l + 1 < p.levels && k >= p.first[l + 1]) ++l;
  const int H = p.H[l], W = p.W[l];
  const int tk = k - p.first[l];
  const int y0 = (tk / p.tiles_x[l]) * SC_TY, x0 = (tk % p.tiles_x[l]) * SC_TX;
  const size_t base = blockIdx.y * (size_t)H * (size_t)W;
  const float* s = p.src[l] + base;
  const int t = threadIdx.x;
  constexpr int TW = SC_TX + 2, N = (SC_TY + 2) * TW;
  float v[(N + SC_THREADS - 1) / SC_THREADS];
#pragma unroll
  for (int i = 0; i < (N + SC_THREADS - 1) / SC_THREADS; ++i) {
    const int e = t + i * SC_THREADS;
    if (e < N) {
      const int r = e / TW, c = e - r * TW;
      const int y = min(max(y0 - 1 + r, 0), H - 1), x = min(max(x0 - 1 + c, 0), W - 1);
      v[i] = __ldg(s + (size_t)y * W + x);
    }
  }
#pragma unroll
  for (int i = 0; i < (N + SC_THREADS - 1) / SC_THREADS; ++i) {
    const int e = t + i * SC_THREADS;
    if (e < N) tile[e] = v[i];
  }
  __syncthreads();
  // this thread: column x = x0 + c, rows y0 + r0 .. y0 + r0 + SC_RUN - 1;
  // the tile's columns c, c+1, c+2 are the image's x-1, x, x+1 (clamped)
  const int c = t % SC_TX, r0 = (t / SC_TX) * SC_RUN;
  const int x = x0 + c;
  if (x >= W) return;
  const float* q = tile + r0 * TW + c;
  float a0 = q[0], a1 = q[1], a2 = q[2];           // row y - 1
  float b0 = q[TW], b1 = q[TW + 1], b2 = q[TW + 2];  // row y
  float* gx = p.gx[l] + base;
  float* gy = p.gy[l] + base;
#pragma unroll
  for (int i = 0; i < SC_RUN; ++i) {
    const int y = y0 + r0 + i;
    if (y >= H) break;
    const float* n = q + (i + 2) * TW;
    const float n0 = n[0], n1 = n[1], n2 = n[2];  // row y + 1
    // gx: the smooth row pass at x-1 and x+1, then the diff column pass
    const float s0 = pyr_smooth3(a0, b0, n0), s2 = pyr_smooth3(a2, b2, n2);
    // gy: the diff row pass at x-1, x, x+1, then the smooth column pass
    const float d0 = pyr_diff3(a0, n0), d1 = pyr_diff3(a1, n1), d2 = pyr_diff3(a2, n2);
    const size_t o = (size_t)y * W + x;
    gx[o] = pyr_diff3(s0, s2);
    gy[o] = pyr_smooth3(d0, d1, d2);
    a0 = b0, a1 = b1, a2 = b2;
    b0 = n0, b1 = n1, b2 = n2;
  }
}

// Plain C entry points (bound with ctypes); see lk.cu for the conventions.
// larvio_pyr_down: src (B, H, W) float32, contiguous on the device, B =
// n_lanes (1: one image); dst (B, ceil(H/2), ceil(W/2)) float32 written. One
// launch for all lanes. Refuses (cudaErrorInvalidValue) an empty image and
// more than 65535 lanes.
extern "C" int larvio_pyr_down(const void* src, int n_lanes, int H, int W, void* dst,
                               void* stream) {
  if (H < 1 || W < 1 || n_lanes < 0 || n_lanes > 65535) return (int)cudaErrorInvalidValue;
  if (n_lanes == 0) return 0;
  const int Ho = (H + 1) / 2, Wo = (W + 1) / 2;
  const dim3 grid((Wo + PD_TX - 1) / PD_TX, (Ho + PD_TY - 1) / PD_TY, n_lanes);
  pyr_down_kernel<<<grid, PD_THREADS, 0, (cudaStream_t)stream>>>((const float*)src, H, W,
                                                                 (float*)dst, Ho, Wo);
  return (int)cudaGetLastError();
}

// larvio_scharr_pyramid: src[l] (B, heights[l], widths[l]) float32,
// contiguous on the device, for l < levels; gx[l], gy[l] of the same shape
// written. One launch for every level and lane. Refuses
// (cudaErrorInvalidValue) more than PYR_MAX_LEVELS levels, an empty level
// and more than 65535 lanes.
extern "C" int larvio_scharr_pyramid(const void* const* src, void* const* gx, void* const* gy,
                                     const int* heights, const int* widths, int levels,
                                     int n_lanes, void* stream) {
  if (levels < 1 || levels > PYR_MAX_LEVELS || n_lanes < 0 || n_lanes > 65535)
    return (int)cudaErrorInvalidValue;
  ScharrLevels p;
  p.levels = levels;
  p.first[0] = 0;
  for (int l = 0; l < levels; ++l) {
    if (heights[l] < 1 || widths[l] < 1) return (int)cudaErrorInvalidValue;
    p.src[l] = (const float*)src[l];
    p.gx[l] = (float*)gx[l];
    p.gy[l] = (float*)gy[l];
    p.H[l] = heights[l];
    p.W[l] = widths[l];
    p.tiles_x[l] = (widths[l] + SC_TX - 1) / SC_TX;
    p.first[l + 1] = p.first[l] + p.tiles_x[l] * ((heights[l] + SC_TY - 1) / SC_TY);
  }
  if (n_lanes == 0) return 0;
  const dim3 grid(p.first[levels], n_lanes);
  scharr_kernel<<<grid, SC_THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
