// Kernels K1 and K3: pyramidal inverse-compositional Lucas-Kanade tracking,
// one feature table (K1) or B independent tables (K3, a fleet of instances).
//
// K1 replaces the Pallas TPU kernel larvio_tpu/ops/lk_pallas.py:
// _make_kernel_multi / _make_multi_feature_body (launched by
// _lk_track_pallas_impl). K3 replaces _make_kernel_batched (launched by
// _lk_track_pallas_batched_impl, grid (B, F), the custom_vmap rule that
// jax.vmap of the pipeline step takes). Both are one __global__, K1 being its
// launch with one lane. They follow the Pallas semantics, which differ
// slightly from the plain larvio_tpu/ops/lk.py::lk_track:
//   * the slab centre is clamped to [r, W-r-2] and the bilinear fraction is
//     taken from the clamped centre;
//   * the stopping iteration (|step| < precision, or the last of `iters`)
//     does NOT apply its step; `err` is that iteration's mean |residual|;
//   * a level that fails (ill-conditioned, out of bounds) keeps the previous
//     flow; validity is decided at level 0 only, with err < 25;
//   * an invalid slot returns its guess, valid 0, err 0.
//
// What bounds it on an H100: the latency of one dependent chain, not bytes
// or FLOPs. A frame tracks at most F = 200 features per lane; each runs
// <= 4 levels x <= 12 Gauss-Newton iterations, and iteration k+1 samples
// `curr` at an address that depends on iteration k's sums. The data are
// small (the whole 4-level pyramid of one lane, ~7.7 MB at 480x752, sits in
// the 50 MB L2), so the time is the chain: per iteration one round of
// bilinear taps plus one reduction, per level the loads that start it.
//
// Design (what it does about the chain):
//   * One warp per (feature, lane), LK_WARPS warps per block (the ragged
//     last block exits warp-uniformly). Lane j owns patch pixels j, j+32,
//     ..., up to 8 of the 225, and keeps their template T and gradients Gx,
//     Gy in registers.
//   * Sums are a per-lane sum in a fixed order, then a __shfl_xor_sync
//     butterfly: every lane ends with the same bits, so the iteration loop
//     and its early exit are warp-uniform. No __syncthreads, no shared
//     partials anywhere in the kernel.
//   * The templates do not depend on the flow: level l-1's prev/gx/gy
//     windows are copied to shared memory with cp.async while level l
//     iterates, so their global latency is off the chain.
//   * At each level a 32x32 tile of `curr` around the level's starting
//     estimate is copied to shared memory (cp.async, one column per lane);
//     the iterations read their taps from it, and from global memory only
//     when the estimate leaves the tile (a warp-uniform branch); this
//     measured faster than reading every tap from global memory. The tile's
//     row stride is 47 (= 15 mod 32), so a warp's 32 pixels of a 15-wide
//     patch fall in 32 different banks. (Staging the next level's tile
//     speculatively during this level's iterations, into a second buffer,
//     measured slower: PERF.md.)
//   * The per-pixel work is branch-free (padding pixels carry a 0 mask), so
//     a lane's 32 taps are in flight together.
//   * Tensor cores do not apply: the work is 2x2 solves and 225-element sums.
// K3 is the same kernel with grid (ceil(F / LK_WARPS), B): blockIdx.y picks
// the lane, whose pyramid levels sit at b * H_l * W_l in contiguous
// (B, H_l, W_l) arrays and whose table at b * F. At B = 8, 1,600 warps.

#include <cuda_runtime.h>
#include <math.h>

#define LK_MAX_LEVELS 8
#define LK_WARPS 4                 // features (warps) per block
#define LK_THREADS (32 * LK_WARPS)
#define LK_PX 8                    // patch pixels per lane: ceil(15 * 15 / 32)
#define LK_WIN 16                  // template window side: patch + 1 <= 16
#define LK_TILE 32                 // curr tile side: the 16x16 slab and an 8-pixel margin
#define LK_MARGIN 8
#define LK_TILE_S 47               // tile row stride (floats), 15 mod 32: conflict-free taps

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
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed copy groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

struct Bilerp {
  float w00, w01, w10, w11;
  __device__ __forceinline__ Bilerp(float fx, float fy)
      : w00((1.f - fx) * (1.f - fy)), w01(fx * (1.f - fy)), w10((1.f - fx) * fy), w11(fx * fy) {}
  __device__ __forceinline__ float operator()(const float* p, int stride) const {
    return p[0] * w00 + p[1] * w01 + p[stride] * w10 + p[stride + 1] * w11;
  }
};

// Copy the 16x16 windows of prev, gx and gy under level lvl's template slab
// into win (3 x 16 x 16 floats, row stride 16), asynchronously, rows and
// columns clamped into the level (for patch 15 the window lies inside it);
// returns the template's bilinear fraction.
__device__ __forceinline__ void stage_template(const LkPyramid& pyr, size_t b, int lvl, float px,
                                               float py, int r, float* win, int lane, float* fx,
                                               float* fy) {
  const int H = pyr.H[lvl], W = pyr.W[lvl];
  const size_t off = b * (size_t)H * (size_t)W;
  const float scale = ldexpf(1.f, -lvl);
  int x0, y0;
  slab_origin(px * scale, py * scale, H, W, r, &x0, &y0, fx, fy);
  const float* prev = pyr.prev[lvl] + off;
  const float* gx = pyr.gx[lvl] + off;
  const float* gy = pyr.gy[lvl] + off;
  const int col = min(x0 + (lane & 15), W - 1);
#pragma unroll
  for (int m = 0; m < LK_WIN * LK_WIN / 32; ++m) {
    const int i = m * 32 + lane;
    const int o = min(y0 + (i >> 4), H - 1) * W + col;
    cp_async4(win + i, prev + o);
    cp_async4(win + LK_WIN * LK_WIN + i, gx + o);
    cp_async4(win + 2 * LK_WIN * LK_WIN + i, gy + o);
  }
}

// Copy the 32x32 tile of `curr` around the slab at (ix0, iy0) asynchronously:
// lane j copies column j of every row. The tile's origin is clamped so that
// its tw x th extent (32 x 32, or the level where it is smaller) lies inside
// the level; rows and columns past the extent repeat the last one.
__device__ __forceinline__ void stage_tile(const float* curr, int H, int W, int ix0, int iy0,
                                           float* tile, int lane, int* tx0, int* ty0, int* tw,
                                           int* th) {
  *tw = min(LK_TILE, W);
  *th = min(LK_TILE, H);
  *tx0 = min(max(ix0 - LK_MARGIN, 0), W - *tw);
  *ty0 = min(max(iy0 - LK_MARGIN, 0), H - *th);
  const float* src = curr + min(*tx0 + lane, W - 1);
#pragma unroll 8
  for (int yy = 0; yy < LK_TILE; ++yy)
    cp_async4(tile + yy * LK_TILE_S + lane, src + min(*ty0 + yy, H - 1) * W);
}

// Per-lane residual sums (|e|, Gx e, Gy e) of the slab whose top-left tap is
// base, with row stride `stride` and this lane's pixel offsets off[k]: in
// shared memory (the tile) or in global memory. Branch-free: padding pixels
// (mask 0) read a real pixel and have T = Gx = Gy = 0, so only |e| needs
// the mask; all 32 taps of a lane can be in flight at once.
__device__ __forceinline__ void residual_sums(const float* base, int stride, const int* off,
                                              const Bilerp& w, const float* T, const float* GX,
                                              const float* GY, const float* msk, float* sa,
                                              float* sx, float* sy) {
  float a = 0.f, x = 0.f, y = 0.f;
#pragma unroll
  for (int k = 0; k < LK_PX; ++k) {
    const float e = w(base + off[k], stride) - T[k];
    a = fmaf(msk[k], fabsf(e), a);
    x += GX[k] * e;
    y += GY[k] * e;
  }
  *sa = a;
  *sx = x;
  *sy = y;
}

// K1 and K3: one warp per (feature, lane); blockIdx.y = lane b of B (K1 is
// the launch with B = 1). Lane b's table starts b * n_feat slots on.
__global__ void __launch_bounds__(LK_THREADS)
lk_track_kernel(LkPyramid pyr, int n_feat, const float* __restrict__ pos,
                const float* __restrict__ guess, const int* __restrict__ valid, int patch,
                int iters, float precision_sq, float max_err, float min_eig,
                float* __restrict__ out_pos, int* __restrict__ out_valid,
                float* __restrict__ out_err) {
  __shared__ float s_win[LK_WARPS][3 * LK_WIN * LK_WIN];
  __shared__ float s_tile[LK_WARPS][LK_TILE * LK_TILE_S];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int f = blockIdx.x * LK_WARPS + warp;
  if (f >= n_feat) return;  // warp-uniform: the ragged last block
  const size_t b = blockIdx.y;
  const size_t slot = b * (size_t)n_feat + f;
  float* win = s_win[warp];
  float* tile = s_tile[warp];

  const float px = pos[2 * slot], py = pos[2 * slot + 1];
  const float gpx = guess[2 * slot], gpy = guess[2 * slot + 1];
  if (valid[slot] == 0) {  // warp-uniform
    if (lane == 0) {
      out_pos[2 * slot] = gpx;
      out_pos[2 * slot + 1] = gpy;
      out_valid[slot] = 0;
      out_err[slot] = 0.f;
    }
    return;
  }

  const int r = patch / 2, npx = patch * patch;
  const float n_px = (float)npx;
  const float margin = (float)(patch / 2 + 1);
  // this lane's patch pixels p = 32k + lane as (row, column), padding
  // (p >= npx) clamped onto the last real pixel with mask 0
  int prow[LK_PX], pcol[LK_PX], owin[LK_PX], otile[LK_PX];
  float msk[LK_PX];
#pragma unroll
  for (int k = 0; k < LK_PX; ++k) {
    const int p = min(k * 32 + lane, npx - 1);
    prow[k] = p / patch;
    pcol[k] = p - prow[k] * patch;
    owin[k] = prow[k] * LK_WIN + pcol[k];
    otile[k] = prow[k] * LK_TILE_S + pcol[k];
    msk[k] = k * 32 + lane < npx ? 1.f : 0.f;
  }

  float T[LK_PX], GX[LK_PX], GY[LK_PX];
  float gxx, gxy, gyy;
  float tfx, tfy;
  // the template (T, Gx, Gy and the Hessian) of a level from its staged windows
  auto load_template = [&]() {
    const Bilerp w(tfx, tfy);
    float a = 0.f, c = 0.f, d = 0.f;
#pragma unroll
    for (int k = 0; k < LK_PX; ++k) {
      T[k] = msk[k] * w(win + owin[k], LK_WIN);
      GX[k] = msk[k] * w(win + LK_WIN * LK_WIN + owin[k], LK_WIN);
      GY[k] = msk[k] * w(win + 2 * LK_WIN * LK_WIN + owin[k], LK_WIN);
      a += GX[k] * GX[k];
      c += GX[k] * GY[k];
      d += GY[k] * GY[k];
    }
    gxx = warp_sum(a);
    gxy = warp_sum(c);
    gyy = warp_sum(d);
  };

  const int top = pyr.levels - 1;
  float flow_x = gpx - px, flow_y = gpy - py;
  bool ok = false;
  float err = 0.f;
  int tx0 = 0, ty0 = 0, tw = 0, th = 0;

  // coarsest level: its template windows and its curr tile in flight together
  {
    const int H = pyr.H[top], W = pyr.W[top];
    const float scale = ldexpf(1.f, -top);
    stage_template(pyr, b, top, px, py, r, win, lane, &tfx, &tfy);
    int ix0, iy0;
    float ifx, ify;
    slab_origin(px * scale + flow_x * scale, py * scale + flow_y * scale, H, W, r, &ix0, &iy0,
                &ifx, &ify);
    stage_tile(pyr.curr[top] + b * (size_t)H * (size_t)W, H, W, ix0, iy0, tile, lane, &tx0, &ty0,
               &tw, &th);
    cp_async_commit();
    cp_async_wait<0>();
    __syncwarp();
    load_template();
  }

  for (int lvl = top; lvl >= 0; --lvl) {
    const int H = pyr.H[lvl], W = pyr.W[lvl];
    const float* curr = pyr.curr[lvl] + b * (size_t)H * (size_t)W;
    const float scale = ldexpf(1.f, -lvl);
    const float cx = px * scale, cy = py * scale;
    float dx = flow_x * scale, dy = flow_y * scale;

    __syncwarp();  // every lane is done with the previous tile and windows
    if (lvl < top) {
      int ix0, iy0;
      float ifx, ify;
      slab_origin(cx + dx, cy + dy, H, W, r, &ix0, &iy0, &ifx, &ify);
      stage_tile(curr, H, W, ix0, iy0, tile, lane, &tx0, &ty0, &tw, &th);
    }
    cp_async_commit();
    float nfx = 0.f, nfy = 0.f;  // the next level's template, copied while this one iterates
    if (lvl > 0) stage_template(pyr, b, lvl - 1, px, py, r, win, lane, &nfx, &nfy);
    cp_async_commit();
    cp_async_wait<1>();  // this level's tile has landed; the windows may still be in flight
    __syncwarp();

    int oglob[LK_PX];  // this lane's pixel offsets in the level
#pragma unroll
    for (int k = 0; k < LK_PX; ++k) oglob[k] = prow[k] * W + pcol[k];
    const float det = gxx * gyy - gxy * gxy;
    const float tr = gxx + gyy;
    const float min_e = (tr - sqrtf(fmaxf(tr * tr - 4.f * det, 0.f))) / (2.f * n_px);
    const float inv_det = 1.f / fmaxf(det, 1e-12f);
    const bool lvl_ok = (min_e > min_eig) && (cx >= margin) && (cx <= (float)(W - 1) - margin) &&
                        (cy >= margin) && (cy <= (float)(H - 1) - margin);

    float lerr = 0.f;
    bool done = !lvl_ok;
    for (int it = 0; it < iters && !done; ++it) {
      int ix0, iy0;
      float ifx, ify;
      slab_origin(cx + dx, cy + dy, H, W, r, &ix0, &iy0, &ifx, &ify);
      const Bilerp w(ifx, ify);
      float sa, sx, sy;
      if (ix0 >= tx0 && ix0 + patch < tx0 + tw && iy0 >= ty0 && iy0 + patch < ty0 + th) {
        residual_sums(tile + (iy0 - ty0) * LK_TILE_S + (ix0 - tx0), LK_TILE_S, otile, w, T, GX,
                      GY, msk, &sa, &sx, &sy);  // warp-uniform branch
      } else {
        residual_sums(curr + iy0 * W + ix0, W, oglob, w, T, GX, GY, msk, &sa, &sx, &sy);
      }
      sa = warp_sum(sa);
      sx = warp_sum(sx);
      sy = warp_sum(sy);
      const float stx = (gyy * sx - gxy * sy) * inv_det;
      const float sty = (gxx * sy - gxy * sx) * inv_det;
      const bool stop = (stx * stx + sty * sty < precision_sq) || (it + 1 >= iters);
      lerr = sa / n_px;
      if (!stop) {
        dx -= stx;
        dy -= sty;
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
    } else {
      cp_async_wait<0>();
      __syncwarp();
      tfx = nfx;
      tfy = nfy;
      load_template();
    }
  }
  if (lane == 0) {
    out_pos[2 * slot] = px + flow_x;
    out_pos[2 * slot + 1] = py + flow_y;
    out_valid[slot] = ok ? 1 : 0;
    out_err[slot] = err;
  }
}

static int fill_pyramid(LkPyramid* pyr, const void* const* prev, const void* const* curr,
                        const void* const* gx, const void* const* gy, const int* heights,
                        const int* widths, int levels) {
  if (levels < 1 || levels > LK_MAX_LEVELS) return (int)cudaErrorInvalidValue;
  for (int l = 0; l < levels; ++l) {
    if (heights[l] < LK_WIN || widths[l] < LK_WIN) return (int)cudaErrorInvalidValue;
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
// lanes in one launch (K3), or one table with n_lanes = 1 (K1). Every level
// must be at least 16x16. It launches on `stream`, does not synchronize, and
// returns cudaGetLastError() of the launch (0 on success).
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
  const dim3 grid((n_feat + LK_WARPS - 1) / LK_WARPS, n_lanes);
  lk_track_kernel<<<grid, LK_THREADS, 0, (cudaStream_t)stream>>>(
      pyr, n_feat, (const float*)pos, (const float*)guess, (const int*)valid, patch, iters,
      precision_sq, max_err, min_eig, (float*)out_pos, (int*)out_valid, (float*)out_err);
  return (int)cudaGetLastError();
}

