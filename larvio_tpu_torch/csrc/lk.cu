// Kernels K1 and K3: pyramidal inverse-compositional Lucas-Kanade tracking,
// one feature table (K1) or B independent tables (K3, a fleet of instances).
//
// K1 replaces the Pallas TPU kernel larvio_tpu/ops/lk_pallas.py:
// _make_kernel_multi / _make_multi_feature_body (launched by
// _lk_track_pallas_impl). K3 replaces _make_kernel_batched (launched by
// _lk_track_pallas_batched_impl, grid (B, F), the custom_vmap rule that
// jax.vmap of the pipeline step takes). Both are one __global__, K1 being its
// launch with one lane, whose device body lk_track_feature plays the part of
// the Pallas kernels' shared _make_multi_feature_body. They follow the
// Pallas semantics, which differ slightly from the plain
// larvio_tpu/ops/lk.py::lk_track:
//   * the slab centre is clamped to [r, W-r-2] and the bilinear fraction is
//     taken from the clamped centre;
//   * the stopping iteration (|step| < precision, or the last of `iters`)
//     does NOT apply its step; `err` is that iteration's mean |residual|;
//   * a level that fails (ill-conditioned, out of bounds) keeps the previous
//     flow; validity is decided at level 0 only, with err < 25;
//   * an invalid slot returns its guess, valid 0, err 0.
//
// What bounds it on an H100: latency, not bandwidth or FLOPs. A frame tracks
// at most F = 200 features; each does <= 4 levels x <= 12 dependent
// Gauss-Newton iterations, and each iteration is 225 bilinear samples plus a
// block-wide reduction. The whole pyramid (prev, curr, gx, gy over 4 levels,
// ~7.7 MB at 480x752) fits in the 50 MB L2, so the samples are L1/L2 hits.
//
// Design: one thread block per feature, 256 threads = the 16x16 slab, one
// bilinear pixel of the 15x15 patch per thread (the spare row/column idle).
// Sums go through warp shuffles and one shared-memory pass; every thread
// then adds the 8 warp partials in the same order, so all threads hold
// bit-identical sums and the iteration loop is block-uniform: the early exit
// costs no divergence. The pyramid is read straight from global memory.
// K3 is the same kernel with grid (F, B): blockIdx.y picks the lane, whose
// pyramid levels sit at b * H_l * W_l in contiguous (B, H_l, W_l) arrays and
// whose table at b * F. What bounds it is again latency: at B = 8 it has 1,600 blocks, which
// fill the 132 SMs better than K1's 200, but the 8 lanes' pyramids (~62 MB)
// no longer fit the 50 MB L2 as one lane's 7.7 MB does, so a lane's samples
// may come from device memory the first time they are touched.
// Not yet done (later work): several features per block, shared-memory
// pyramid tiles via TMA, and capturing the step in a CUDA graph.

#include <cuda_runtime.h>
#include <math.h>

#define LK_MAX_LEVELS 8
#define LK_THREADS 256
#define LK_WARPS (LK_THREADS / 32)

struct LkPyramid {
  const float* prev[LK_MAX_LEVELS];
  const float* curr[LK_MAX_LEVELS];
  const float* gx[LK_MAX_LEVELS];
  const float* gy[LK_MAX_LEVELS];
  int H[LK_MAX_LEVELS];
  int W[LK_MAX_LEVELS];
  int levels;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Sum three per-thread values over the block; every thread gets the same
// bit pattern (lane 0's warp partials, added in warp order by all threads).
__device__ __forceinline__ float3 block_sum3(float a, float b, float c, float* sh) {
  a = warp_sum(a);
  b = warp_sum(b);
  c = warp_sum(c);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sh[warp] = a;
    sh[LK_WARPS + warp] = b;
    sh[2 * LK_WARPS + warp] = c;
  }
  __syncthreads();
  float3 r = make_float3(0.f, 0.f, 0.f);
  for (int w = 0; w < LK_WARPS; ++w) {
    r.x += sh[w];
    r.y += sh[LK_WARPS + w];
    r.z += sh[2 * LK_WARPS + w];
  }
  __syncthreads();  // sh is reused by the next call
  return r;
}

// Slab origin and bilinear fraction for a patch centred at (cx, cy):
// the centre is clamped to [r, W-r-2] x [r, H-r-2] (fmaxf maps NaN to r).
__device__ __forceinline__ void slab_origin(float cx, float cy, int H, int W, int r,
                                            int* x0, int* y0, float* fx, float* fy) {
  const float cxc = fminf(fmaxf(cx, (float)r), (float)(W - r - 2));
  const float cyc = fminf(fmaxf(cy, (float)r), (float)(H - r - 2));
  const float flx = floorf(cxc);
  const float fly = floorf(cyc);
  *x0 = (int)flx - r;
  *y0 = (int)fly - r;
  *fx = cxc - flx;
  *fy = cyc - fly;
}

__device__ __forceinline__ float bilinear(const float* img, int W, int x0, int y0, int px,
                                          int py, float fx, float fy) {
  const float* p = img + (size_t)(y0 + py) * W + (x0 + px);
  const float i00 = p[0], i01 = p[1], i10 = p[W], i11 = p[W + 1];
  return i00 * (1.f - fx) * (1.f - fy) + i01 * fx * (1.f - fy) + i10 * (1.f - fx) * fy +
         i11 * fx * fy;
}

// One feature's whole pyramid track (the body of K1 and K3). `pyr` holds
// lane 0's level pointers; lane b's level l starts b * H_l * W_l floats on
// (the offset is taken per level, so the kernel keeps no per-lane copy of
// the pointer table). `pos`, `guess`, `valid` and the outputs point at the
// lane's table; f indexes it.
__device__ __forceinline__ void lk_track_feature(
    const LkPyramid& pyr, size_t b, int f, const float* __restrict__ pos,
    const float* __restrict__ guess, const int* __restrict__ valid, int patch, int iters,
    float precision_sq, float max_err, float min_eig, float* __restrict__ out_pos,
    int* __restrict__ out_valid, float* __restrict__ out_err, float* sh) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const bool active = (tx < patch) && (ty < patch);
  const int r = patch / 2;
  const float n_px = (float)(patch * patch);
  const float px = pos[2 * f], py = pos[2 * f + 1];
  const float gpx = guess[2 * f], gpy = guess[2 * f + 1];

  if (valid[f] == 0) {  // block-uniform
    if (threadIdx.x == 0) {
      out_pos[2 * f] = gpx;
      out_pos[2 * f + 1] = gpy;
      out_valid[f] = 0;
      out_err[f] = 0.f;
    }
    return;
  }

  float flow_x = gpx - px, flow_y = gpy - py;
  bool ok = false;
  float err = 0.f;
  const float margin = (float)(patch / 2 + 1);

  for (int lvl = pyr.levels - 1; lvl >= 0; --lvl) {
    const int H = pyr.H[lvl], W = pyr.W[lvl];
    const size_t off = b * (size_t)H * (size_t)W;
    const float* prev = pyr.prev[lvl] + off;
    const float* curr = pyr.curr[lvl] + off;
    const float* gxl = pyr.gx[lvl] + off;
    const float* gyl = pyr.gy[lvl] + off;
    const float scale = ldexpf(1.f, -lvl);
    const float cx = px * scale, cy = py * scale;

    int x0, y0;
    float fx, fy;
    slab_origin(cx, cy, H, W, r, &x0, &y0, &fx, &fy);
    float T = 0.f, Gx = 0.f, Gy = 0.f;
    if (active) {
      T = bilinear(prev, W, x0, y0, tx, ty, fx, fy);
      Gx = bilinear(gxl, W, x0, y0, tx, ty, fx, fy);
      Gy = bilinear(gyl, W, x0, y0, tx, ty, fx, fy);
    }
    const float3 g = block_sum3(Gx * Gx, Gx * Gy, Gy * Gy, sh);
    const float gxx = g.x, gxy = g.y, gyy = g.z;
    const float det = gxx * gyy - gxy * gxy;
    const float tr = gxx + gyy;
    const float min_e = (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f))) / (2.f * n_px);
    const float inv_det = 1.f / fmaxf(det, 1e-12f);
    const bool lvl_ok = (min_e > min_eig) && (cx >= margin) && (cx <= (float)(W - 1) - margin) &&
                        (cy >= margin) && (cy <= (float)(H - 1) - margin);

    float dx = flow_x * scale, dy = flow_y * scale;
    float lerr = 0.f;
    bool done = !lvl_ok;
    for (int it = 0; it < iters && !done; ++it) {
      int ix0, iy0;
      float ifx, ify;
      slab_origin(cx + dx, cy + dy, H, W, r, &ix0, &iy0, &ifx, &ify);
      float e = 0.f;
      if (active) e = bilinear(curr, W, ix0, iy0, tx, ty, ifx, ify) - T;
      const float3 s = block_sum3(fabsf(e), Gx * e, Gy * e, sh);
      const float sx = (gyy * s.y - gxy * s.z) * inv_det;
      const float sy = (gxx * s.z - gxy * s.y) * inv_det;
      const bool stop = (sx * sx + sy * sy < precision_sq) || (it + 1 >= iters);
      lerr = s.x / n_px;
      if (!stop) {
        dx -= sx;
        dy -= sy;
      }
      done = stop;
    }
    const bool inb = (cx + dx >= 1.f) && (cx + dx <= (float)W - 2.f) && (cy + dy >= 1.f) &&
                     (cy + dy <= (float)H - 2.f);
    const bool new_ok = lvl_ok && inb;
    if (new_ok) {
      flow_x = dx / scale;
      flow_y = dy / scale;
    }
    if (lvl == 0) {
      ok = new_ok && (lerr < max_err);
      err = lerr;
    }
  }

  if (threadIdx.x == 0) {
    out_pos[2 * f] = px + flow_x;
    out_pos[2 * f + 1] = py + flow_y;
    out_valid[f] = ok ? 1 : 0;
    out_err[f] = err;
  }
}

// K1 and K3: one block per (feature, lane); blockIdx.y = lane b of B (K1 is
// the launch with B = 1). Lane b's table starts b * n_feat slots on.
__global__ void __launch_bounds__(LK_THREADS)
lk_track_kernel(LkPyramid pyr, int n_feat, const float* __restrict__ pos,
                const float* __restrict__ guess, const int* __restrict__ valid, int patch,
                int iters, float precision_sq, float max_err, float min_eig,
                float* __restrict__ out_pos, int* __restrict__ out_valid,
                float* __restrict__ out_err) {
  __shared__ float sh[3 * LK_WARPS];
  const size_t b = blockIdx.y;
  const size_t t = b * (size_t)n_feat;
  lk_track_feature(pyr, b, blockIdx.x, pos + 2 * t, guess + 2 * t, valid + t, patch, iters,
                   precision_sq, max_err, min_eig, out_pos + 2 * t, out_valid + t, out_err + t,
                   sh);
}

static int fill_pyramid(LkPyramid* pyr, const void* const* prev, const void* const* curr,
                        const void* const* gx, const void* const* gy, const int* heights,
                        const int* widths, int levels) {
  if (levels < 1 || levels > LK_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < levels; ++l) {
    pyr->prev[l] = (const float*)prev[l];
    pyr->curr[l] = (const float*)curr[l];
    pyr->gx[l] = (const float*)gx[l];
    pyr->gy[l] = (const float*)gy[l];
    pyr->H[l] = heights[l];
    pyr->W[l] = widths[l];
  }
  pyr->levels = levels;
  return 0;
}

// Plain C entry point (bound with ctypes). The image pointer arrays and the
// level shapes are host arrays of `levels` entries; everything else lives on
// the device. The level pointers are those of contiguous (B, H_l, W_l)
// arrays and the tables (B, n_feat, 2) / (B, n_feat), with B = n_lanes: all
// lanes in one launch (K3), or one table with n_lanes = 1 (K1). It launches
// on `stream`, does not synchronize, and returns cudaGetLastError() of the
// launch (0 on success).
extern "C" int larvio_lk_track_batched(const void* const* prev, const void* const* curr,
                                       const void* const* gx, const void* const* gy,
                                       const int* heights, const int* widths, int levels,
                                       int n_lanes, const void* pos, const void* guess,
                                       const void* valid, int n_feat, int patch, int iters,
                                       float precision_sq, float max_err, float min_eig,
                                       void* out_pos, void* out_valid, void* out_err,
                                       void* stream) {
  if (patch < 1 || patch > 15 || n_feat < 0 || n_lanes < 0 || n_lanes > 65535)
    return (int)cudaErrorInvalidValue;
  LkPyramid pyr;
  const int bad = fill_pyramid(&pyr, prev, curr, gx, gy, heights, widths, levels);
  if (bad) return bad;
  if (n_feat == 0 || n_lanes == 0) return 0;
  const dim3 grid(n_feat, n_lanes);
  lk_track_kernel<<<grid, LK_THREADS, 0, (cudaStream_t)stream>>>(
      pyr, n_feat, (const float*)pos, (const float*)guess, (const int*)valid, patch, iters,
      precision_sq, max_err, min_eig, (float*)out_pos, (int*)out_valid, (float*)out_err);
  return (int)cudaGetLastError();
}
