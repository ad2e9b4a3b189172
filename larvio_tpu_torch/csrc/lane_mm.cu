// The lane-batched float32 product of the filter: for every index of the
// leading (lane and broadcast) axes,
//     C[l, b..., m, n] = sum_k A[l, b..., m, k] * B[l, b..., k, n],
// in one launch for all lanes, each output element summed in a fixed order.
//
// No TPU kernel of the JAX package computes this: under jax.vmap each product
// of the filter (larvio_tpu/core/linalg.py::mm and the vmapped models) is one
// XLA dot_general for all lanes. The port's counterpart must not let a lane's
// bits depend on the fleet's width (ROADMAP F4): cuBLAS picks its kernel, and
// how it splits a long sum, by the batch count, so a batched cuBLAS product
// cannot promise that, and one cuBLAS call per lane costs a launch per lane.
//
// The order: each output element is one thread's single accumulator, summed
// over k = 0 .. K-1 in ascending order with fmaf (acc = fmaf(a_k, b_k, acc),
// acc starting at 0). No split-K, no atomics, no tensor cores, no fast math.
// Shared-memory tiles of A and B change where the operands are read from, not
// that order. So an element's bits are a function of its row of A and its
// column of B alone: not of the lanes beside it, their number, its position
// among them, nor of the tile shape.
//
// Layout: A, B are strided views (any strides, stride 0 for a broadcast axis,
// transposed views as they are: nothing is copied); the leading axes are
// passed as up to LMM_MAX_DIMS (size, stride of A, stride of B) triples; C is
// contiguous (lead..., M, N). Grid: one block per (batch index, tile of C),
// flattened into blockIdx.x; a block is bm x bn threads (bm * bn <= 256, both
// powers of two chosen from M and N by the wrapper), one output each, and
// walks K in steps of LMM_TK through shared tiles As (bm x TK), Bs (TK x bn).
//
// What bounds it on an H100: for the filter's small products (2-15 rows, up
// to D = 160 columns, K up to a few hundred) launch latency and the dependent
// fmaf chain; for D x D x D (the Joseph form) the f32 FMA rate of a kernel
// that keeps one accumulator per thread.

#include <cuda_runtime.h>

#define LMM_MAX_DIMS 8
#define LMM_TK 16
#define LMM_THREADS 256

struct LaneMMArgs {
  int nd;                          // leading axes
  long long size[LMM_MAX_DIMS];    // their sizes
  long long sa[LMM_MAX_DIMS];      // A's strides along them (elements)
  long long sb[LMM_MAX_DIMS];      // B's strides along them
  int M, N, K;
  long long a_sm, a_sk, b_sk, b_sn;  // A's row and column strides, B's
  int bm, bn, log2_bn;             // the block's tile of C
  long long tiles_m, tiles_n;
};

__global__ void __launch_bounds__(LMM_THREADS)
lane_mm_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
               const LaneMMArgs p) {
  __shared__ float As[LMM_THREADS * LMM_TK];  // bm x TK, bm <= 256
  __shared__ float Bs[LMM_TK * LMM_THREADS];  // TK x bn, bn <= 256
  long long blk = blockIdx.x;
  const long long tn = blk % p.tiles_n;
  blk /= p.tiles_n;
  const long long tm = blk % p.tiles_m;
  long long rem = blk / p.tiles_m;  // the batch index
  const long long bidx = rem;
  long long offA = 0, offB = 0;
  for (int d = p.nd - 1; d >= 0; --d) {
    const long long i = rem % p.size[d];
    rem /= p.size[d];
    offA += i * p.sa[d];
    offB += i * p.sb[d];
  }
  const float* Ab = A + offA;
  const float* Bb = B + offB;
  const int t = threadIdx.x;
  const int nthreads = p.bm * p.bn;
  const int li = t >> p.log2_bn, lj = t & (p.bn - 1);
  const long long row0 = tm * p.bm, col0 = tn * p.bn;
  float acc = 0.0f;
  for (int k0 = 0; k0 < p.K; k0 += LMM_TK) {
    const int kc = min(LMM_TK, p.K - k0);
    for (int e = t; e < p.bm * LMM_TK; e += nthreads) {
      const int r = e / LMM_TK, c = e % LMM_TK;
      const long long gi = row0 + r;
      As[e] = (gi < p.M && c < kc) ? Ab[gi * p.a_sm + (long long)(k0 + c) * p.a_sk] : 0.0f;
    }
    for (int e = t; e < LMM_TK * p.bn; e += nthreads) {
      const int r = e >> p.log2_bn, c = e & (p.bn - 1);
      const long long gj = col0 + c;
      Bs[e] = (gj < p.N && r < kc) ? Bb[(long long)(k0 + r) * p.b_sk + gj * p.b_sn] : 0.0f;
    }
    __syncthreads();
    // ascending k, one accumulator: the order that makes a lane's bits its own
    for (int kk = 0; kk < kc; ++kk) acc = fmaf(As[li * LMM_TK + kk], Bs[(kk << p.log2_bn) + lj], acc);
    __syncthreads();
  }
  const long long i = row0 + li, j = col0 + lj;
  if (i < p.M && j < p.N) C[(bidx * p.M + i) * p.N + j] = acc;
}

// C (lead..., M, N), contiguous, from the strided A and B. Returns a
// cudaError_t (0 on success). nd <= LMM_MAX_DIMS; bm, bn powers of two with
// bm * bn <= 256; M, N >= 1 and at least one batch index (the wrapper returns
// an empty C without a launch otherwise).
extern "C" int larvio_lane_mm(const float* A, const float* B, float* C, int nd, const long long* size,
                              const long long* sa, const long long* sb, int M, int N, int K,
                              long long a_sm, long long a_sk, long long b_sk, long long b_sn, int bm,
                              int bn, void* stream) {
  if (nd < 0 || nd > LMM_MAX_DIMS || M < 1 || N < 1 || K < 0 || bm < 1 || bn < 1 ||
      bm * bn > LMM_THREADS || (bm & (bm - 1)) || (bn & (bn - 1)))
    return (int)cudaErrorInvalidValue;
  LaneMMArgs p;
  p.nd = nd;
  long long batch = 1;
  for (int d = 0; d < nd; ++d) {
    p.size[d] = size[d];
    p.sa[d] = sa[d];
    p.sb[d] = sb[d];
    batch *= size[d];
  }
  for (int d = nd; d < LMM_MAX_DIMS; ++d) p.size[d] = 1, p.sa[d] = 0, p.sb[d] = 0;
  p.M = M, p.N = N, p.K = K;
  p.a_sm = a_sm, p.a_sk = a_sk, p.b_sk = b_sk, p.b_sn = b_sn;
  p.bm = bm, p.bn = bn;
  p.log2_bn = 0;
  while ((1 << p.log2_bn) < bn) ++p.log2_bn;
  p.tiles_m = (M + bm - 1) / bm;
  p.tiles_n = (N + bn - 1) / bn;
  const long long blocks = batch * p.tiles_m * p.tiles_n;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  lane_mm_kernel<<<(unsigned)blocks, bm * bn, 0, (cudaStream_t)stream>>>(A, B, C, p);
  return (int)cudaGetLastError();
}

// The lane-batched triangular solve, the same promise for X = A^{-1} B with
// A (lead..., n, n) triangular (lower or upper, any strides: a transposed
// view is passed as it is) and B (lead..., n, W) strided; X contiguous. It
// replaces torch.linalg.solve_triangular for a fleet's D x D systems, where
// PyTorch loops cuBLAS's trsm over batches of at most 8 and calls the
// batched trsm above 8, so a lane's bits changed between 8 and 256 lanes.
//
// One thread per (batch index, column j) of X, forward (lower) or backward
// (upper) substitution in one fixed order:
//   X[i, j] = (B[i, j] - sum_k A[i, k] X[k, j]) / A[i, i],
// the sum one accumulator, k ascending (lower) or descending (upper), each
// step acc = fmaf(-A[i, k], X[k, j], acc), the division IEEE-rounded. A
// thread reads back only its own column of X; the warp's threads share A's
// element (one broadcast load) and read neighbouring X.
//
// What bounds it: the dependent chain of n (n + 1) / 2 fmaf per column (n =
// 160: 12,880), with the lanes x columns in flight to hide it.

#define LTRSM_THREADS 128

struct LaneTrsmArgs {
  int nd;
  long long size[LMM_MAX_DIMS];
  long long sa[LMM_MAX_DIMS];
  long long sb[LMM_MAX_DIMS];
  int n, W, upper;
  long long a_sr, a_sc, b_sr, b_sc;
  long long tiles_w;
};

__global__ void __launch_bounds__(LTRSM_THREADS)
lane_trsm_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ X,
                 const LaneTrsmArgs p) {
  const long long blk = blockIdx.x;
  const long long tw = blk % p.tiles_w;
  long long rem = blk / p.tiles_w;
  const long long bidx = rem;
  long long offA = 0, offB = 0;
  for (int d = p.nd - 1; d >= 0; --d) {
    const long long i = rem % p.size[d];
    rem /= p.size[d];
    offA += i * p.sa[d];
    offB += i * p.sb[d];
  }
  const long long j = tw * LTRSM_THREADS + threadIdx.x;
  if (j >= p.W) return;  // no barrier below
  const float* Ab = A + offA;
  const float* Bb = B + offB + j * p.b_sc;
  float* Xb = X + bidx * (long long)p.n * p.W + j;
  const int n = p.n;
  if (!p.upper) {
    for (int i = 0; i < n; ++i) {
      const float* Ai = Ab + i * p.a_sr;
      float acc = Bb[i * p.b_sr];
      for (int k = 0; k < i; ++k) acc = fmaf(-Ai[k * p.a_sc], Xb[(long long)k * p.W], acc);
      Xb[(long long)i * p.W] = acc / Ai[i * p.a_sc];
    }
  } else {
    for (int i = n - 1; i >= 0; --i) {
      const float* Ai = Ab + i * p.a_sr;
      float acc = Bb[i * p.b_sr];
      for (int k = n - 1; k > i; --k) acc = fmaf(-Ai[k * p.a_sc], Xb[(long long)k * p.W], acc);
      Xb[(long long)i * p.W] = acc / Ai[i * p.a_sc];
    }
  }
}

// X (lead..., n, W), contiguous, from the strided A and B. Returns a
// cudaError_t (0 on success).
extern "C" int larvio_lane_trsm(const float* A, const float* B, float* X, int nd, const long long* size,
                                const long long* sa, const long long* sb, int n, int W, int upper,
                                long long a_sr, long long a_sc, long long b_sr, long long b_sc,
                                void* stream) {
  if (nd < 0 || nd > LMM_MAX_DIMS || n < 1 || W < 1) return (int)cudaErrorInvalidValue;
  LaneTrsmArgs p;
  p.nd = nd;
  long long batch = 1;
  for (int d = 0; d < nd; ++d) {
    p.size[d] = size[d];
    p.sa[d] = sa[d];
    p.sb[d] = sb[d];
    batch *= size[d];
  }
  for (int d = nd; d < LMM_MAX_DIMS; ++d) p.size[d] = 1, p.sa[d] = 0, p.sb[d] = 0;
  p.n = n, p.W = W, p.upper = upper;
  p.a_sr = a_sr, p.a_sc = a_sc, p.b_sr = b_sr, p.b_sc = b_sc;
  p.tiles_w = (W + LTRSM_THREADS - 1) / LTRSM_THREADS;
  const long long blocks = batch * p.tiles_w;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  lane_trsm_kernel<<<(unsigned)blocks, LTRSM_THREADS, 0, (cudaStream_t)stream>>>(A, B, X, p);
  return (int)cudaGetLastError();
}
