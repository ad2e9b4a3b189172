// The fused ORB describe kernel: for each feature slot, the 256-bit
// rotation-steered binary descriptor of larvio_tpu_torch/ops/orb.py::describe
// in one launch, from the raw image.
//
// Replaces the Pallas TPU kernel larvio_tpu/ops/orb.py:_make_slab_kernel
// (launched by _slabs_pallas_impl), which cut the 31x31 slab of the
// descriptor-blurred image at round(pos) for each slot, and with it the ~65
// separate PyTorch kernels that built the descriptor around it: the
// whole-image blur, the slab copy, the moments, the angle, the steered
// pattern, the rounding, the gather, the tests and the bit packing. Under
// jax.vmap the JAX package takes XLA's gather instead of the slab kernel
// (larvio_tpu/ops/orb.py:143-151); the batched launch (B lanes) is the
// port's form of the same work for a fleet.
//
// Per slot (one 256-thread block, grid (F, B), lane b = blockIdx.y):
//   1. the raw 35x35 window whose inner 31x31 is the slab at round(pos)
//      (half-to-even, the centre clamped to [15, W-16] AFTER the saturating
//      float-to-int conversion, so NaN reads in bounds), rows and columns
//      clamped to the image (edge replication), goes to shared memory by
//      cp.async;
//   2. the vertical then horizontal 5-tap [1,4,6,4,1]/16 blur in shared
//      memory, each pass accumulated as ops/orb.py::_desc_blur does
//      (k0*p0, + k1*p1, ...) with __fmul_rn/__fadd_rn, so nothing is
//      contracted into an FMA: the blurred slab is bit-identical to the
//      crop of the whole-image blur;
//   3. the intensity centroid m10, m01 over the radius-15 disc (per-thread
//      sums, warp shuffles, 8 warp partials added in one order by every
//      thread), then atan2f, cosf, sinf (the accurate functions);
//   4. thread t runs test t of the pattern (ops/orb.py::_PAT, which the
//      wrapper passes as a device array): both points rotated with the plain
//      version's expression order, rounded half-to-even, offset by 15,
//      clamped to [0, 30], compared a < b on the blurred slab;
//   5. __ballot_sync packs warp w's 32 tests into word w (bit j = test
//      32w + j); invalid slots write 0.
// Only the moment sums run in another order than torch.sum, so a rotated
// sample can round the other way and flip a bit against the plain version.
//
// What bounds it on an H100: launch latency and one dependent chain per
// block (load, two blur passes, a reduction, the tests), not bytes: a frame
// reads ~1 MB of raw pixels per lane and writes 32 B per slot. The slab
// never leaves shared memory; one launch replaces the plain path's ~65.

#include <cuda_runtime.h>

#define ORB_BITS 256
#define ORB_PATCH 31
#define ORB_R (ORB_PATCH / 2)
#define ORB_WIN (ORB_PATCH + 4)  // the slab and the blur's 2-pixel apron
#define ORB_THREADS ORB_BITS     // one thread per test
#define ORB_WARPS (ORB_THREADS / 32)

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

// acc = k0*p[0] + k1*p[s] + k2*p[2s] + k1*p[3s] + k0*p[4s], left to right,
// every product and sum rounded on its own (the plain version's order)
__device__ __forceinline__ float blur5(const float* p, int s) {
  const float k0 = 0.0625f, k1 = 0.25f, k2 = 0.375f;  // [1, 4, 6, 4, 1] / 16
  float acc = __fmul_rn(k0, p[0]);
  acc = __fadd_rn(acc, __fmul_rn(k1, p[s]));
  acc = __fadd_rn(acc, __fmul_rn(k2, p[2 * s]));
  acc = __fadd_rn(acc, __fmul_rn(k1, p[3 * s]));
  return __fadd_rn(acc, __fmul_rn(k0, p[4 * s]));
}

__global__ void __launch_bounds__(ORB_THREADS)
orb_describe_kernel(const float* __restrict__ img, int H, int W, int n_feat,
                    const float* __restrict__ pos, const unsigned char* __restrict__ valid,
                    const float4* __restrict__ pat, unsigned* __restrict__ out) {
  __shared__ float raw[ORB_WIN * ORB_WIN];
  __shared__ float vert[ORB_PATCH * ORB_WIN];
  __shared__ float slab[ORB_PATCH * ORB_PATCH];
  __shared__ float part[2][ORB_WARPS];
  const size_t b = blockIdx.y;
  const size_t slot = b * (size_t)n_feat + blockIdx.x;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  if (!valid[slot]) {  // block-uniform
    if (t < ORB_BITS / 32) out[slot * (ORB_BITS / 32) + t] = 0u;
    return;
  }

  // 1. the raw window, edge-replicated, by cp.async
  const float* im = img + b * (size_t)H * (size_t)W;
  const int rx = min(max(__float2int_rn(pos[2 * slot]), ORB_R), W - ORB_R - 1);
  const int ry = min(max(__float2int_rn(pos[2 * slot + 1]), ORB_R), H - ORB_R - 1);
  const int x0 = rx - ORB_R - 2, y0 = ry - ORB_R - 2;
  for (int i = t; i < ORB_WIN * ORB_WIN; i += ORB_THREADS) {
    const int wy = i / ORB_WIN, wx = i - wy * ORB_WIN;
    const int gy = min(max(y0 + wy, 0), H - 1), gx = min(max(x0 + wx, 0), W - 1);
    cp_async4(raw + i, im + (size_t)gy * W + gx);
  }
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // 2. the blur: vertical pass (31 x 35), then horizontal (31 x 31)
  for (int i = t; i < ORB_PATCH * ORB_WIN; i += ORB_THREADS) vert[i] = blur5(raw + i, ORB_WIN);
  __syncthreads();
  float m10 = 0.f, m01 = 0.f;
  for (int i = t; i < ORB_PATCH * ORB_PATCH; i += ORB_THREADS) {
    const int y = i / ORB_PATCH, x = i - y * ORB_PATCH;
    const float v = blur5(vert + y * ORB_WIN + x, 1);
    slab[i] = v;
    // 3. the centroid over the disc x^2 + y^2 <= 15^2
    const int dx = x - ORB_R, dy = y - ORB_R;
    if (dx * dx + dy * dy <= ORB_R * ORB_R) {
      m10 = __fadd_rn(m10, __fmul_rn(v, (float)dx));
      m01 = __fadd_rn(m01, __fmul_rn(v, (float)dy));
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m10 = __fadd_rn(m10, __shfl_xor_sync(0xffffffffu, m10, o));
    m01 = __fadd_rn(m01, __shfl_xor_sync(0xffffffffu, m01, o));
  }
  if (lane == 0) {
    part[0][warp] = m10;
    part[1][warp] = m01;
  }
  __syncthreads();  // the slab and the partials are complete
  m10 = 0.f;
  m01 = 0.f;
#pragma unroll
  for (int w = 0; w < ORB_WARPS; ++w) {
    m10 = __fadd_rn(m10, part[0][w]);
    m01 = __fadd_rn(m01, part[1][w]);
  }
  const float th = atan2f(m01, m10);
  const float c = cosf(th), s = sinf(th);

  // 4. test t: a = rot(pat[t].xy), b = rot(pat[t].zw), as the plain version
  const float4 p = pat[t];
  const float ax = __fsub_rn(__fmul_rn(p.x, c), __fmul_rn(p.y, s));
  const float ay = __fadd_rn(__fmul_rn(p.x, s), __fmul_rn(p.y, c));
  const float bx = __fsub_rn(__fmul_rn(p.z, c), __fmul_rn(p.w, s));
  const float by = __fadd_rn(__fmul_rn(p.z, s), __fmul_rn(p.w, c));
  const int iax = min(max(__float2int_rn(ax) + ORB_R, 0), ORB_PATCH - 1);
  const int iay = min(max(__float2int_rn(ay) + ORB_R, 0), ORB_PATCH - 1);
  const int ibx = min(max(__float2int_rn(bx) + ORB_R, 0), ORB_PATCH - 1);
  const int iby = min(max(__float2int_rn(by) + ORB_R, 0), ORB_PATCH - 1);
  const bool bit = slab[iay * ORB_PATCH + iax] < slab[iby * ORB_PATCH + ibx];

  // 5. pack: word `warp`, bit `lane`
  const unsigned word = __ballot_sync(0xffffffffu, bit);
  if (lane == 0) out[slot * (ORB_BITS / 32) + warp] = word;
}

// Plain C entry point (bound with ctypes); see lk.cu for the conventions.
// img (B, H, W) float32, pos (B, n_feat, 2) float32, valid (B, n_feat) bool
// (one byte each), pat (256, 4) float32 test pairs (ax, ay, bx, by), 16-byte
// aligned, out (B, n_feat, 8) 32-bit words, all contiguous on the device,
// B = n_lanes; one launch for all lanes (n_lanes = 1: one image).
extern "C" int larvio_orb_describe(const void* img, int n_lanes, int H, int W, const void* pos,
                                   const void* valid, int n_feat, const void* pat, void* out,
                                   void* stream) {
  if (H < ORB_PATCH || W < ORB_PATCH || n_feat < 0 || n_lanes < 0 || n_lanes > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_feat == 0 || n_lanes == 0) return 0;
  const dim3 grid(n_feat, n_lanes);
  orb_describe_kernel<<<grid, ORB_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)img, H, W, n_feat, (const float*)pos, (const unsigned char*)valid,
      (const float4*)pat, (unsigned*)out);
  return (int)cudaGetLastError();
}
