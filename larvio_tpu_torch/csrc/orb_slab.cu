// Kernel K2: ORB descriptor slab extraction.
//
// Replaces the Pallas TPU kernel larvio_tpu/ops/orb.py:_make_slab_kernel
// (launched by _slabs_pallas_impl): for each feature, copy the 31x31
// integer-aligned window of the descriptor-blurred image centred at
// round(pos), the centre clamped to [15, W-16] x [15, H-16].
//
// Rounding is half-to-even (__float2int_rn, as jnp.round), never roundf.
// The clamp comes AFTER the float-to-int conversion: the conversion
// saturates and maps NaN to 0, so NaN or garbage positions of invalid slots
// still read in bounds (their slab content is unspecified, as on the TPU).
//
// What bounds it on an H100: launch latency. A frame copies F = 200 windows
// of 961 floats (0.77 MB out, reads from an image that sits in L2). One
// block per feature, 256 threads striding over the 961 pixels; consecutive
// threads read consecutive pixels of a row. Output is (F, 31, 31) contiguous.
// Fusing the centroid orientation, the 256 steered tests and the bit packing
// into this kernel is later work.
//
// The batched form is the same kernel and entry with n_lanes = B: one
// launch with grid (F, B). Lane b reads its own (H, W) image at b * H * W of
// a contiguous (B, H, W) array, its positions at b * F and writes its slabs
// at b * F * 961. It replaces no TPU kernel of its own: under jax.vmap the
// JAX package's slab extraction falls back to XLA's gather
// (larvio_tpu/ops/orb.py:143-151); this is the port's batched form of K2, so
// a fleet keeps K2's work on the card in one launch per frame. At B = 8 it
// copies 8 x 0.77 MB, still launch-bound.

#include <cuda_runtime.h>

#define ORB_PATCH 31
#define ORB_R (ORB_PATCH / 2)
#define ORB_THREADS 256

// One feature's slab; img, pos and out point at the feature's own lane.
__device__ __forceinline__ void orb_slab(const float* __restrict__ img, int H, int W,
                                         const float* __restrict__ pos, float* __restrict__ out,
                                         int f) {
  int rx = __float2int_rn(pos[2 * f]);
  int ry = __float2int_rn(pos[2 * f + 1]);
  rx = min(max(rx, ORB_R), W - ORB_R - 1);
  ry = min(max(ry, ORB_R), H - ORB_R - 1);
  const int x0 = rx - ORB_R, y0 = ry - ORB_R;
  float* dst = out + (size_t)f * ORB_PATCH * ORB_PATCH;
  for (int i = threadIdx.x; i < ORB_PATCH * ORB_PATCH; i += ORB_THREADS) {
    const int yy = i / ORB_PATCH, xx = i - yy * ORB_PATCH;
    dst[i] = img[(size_t)(y0 + yy) * W + (x0 + xx)];
  }
}

// One block per (feature, lane): blockIdx.y = lane b, n_feat slots per lane.
__global__ void __launch_bounds__(ORB_THREADS)
orb_slab_kernel(const float* __restrict__ img, int H, int W, int n_feat,
                const float* __restrict__ pos, float* __restrict__ out) {
  const size_t b = blockIdx.y;
  orb_slab(img + b * (size_t)H * W, H, W, pos + 2 * b * n_feat,
           out + b * (size_t)n_feat * ORB_PATCH * ORB_PATCH, blockIdx.x);
}

// Plain C entry point (bound with ctypes); see lk.cu for the conventions.
// img (B, H, W), pos (B, n_feat, 2), out (B, n_feat, 31, 31), all
// contiguous, B = n_lanes; one launch for all lanes (n_lanes = 1: one image).
extern "C" int larvio_orb_slabs(const void* img, int n_lanes, int H, int W, const void* pos,
                                int n_feat, void* out, void* stream) {
  if (H < ORB_PATCH || W < ORB_PATCH || n_feat < 0 || n_lanes < 0 || n_lanes > 65535)
    return (int)cudaErrorInvalidValue;
  if (n_feat == 0 || n_lanes == 0) return 0;
  const dim3 grid(n_feat, n_lanes);
  orb_slab_kernel<<<grid, ORB_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)img, H, W, n_feat, (const float*)pos, (float*)out);
  return (int)cudaGetLastError();
}
