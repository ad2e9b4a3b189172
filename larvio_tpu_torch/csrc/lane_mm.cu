// The lane-batched float32 product of the filter: for every index of the
// leading (lane and broadcast) axes,
//     C[l, b..., m, n] = sum_k A[l, b..., m, k] * B[l, b..., k, n],
// in one launch for all lanes, each output element summed in a fixed order.
//
// No TPU kernel of the JAX package computes this: under jax.vmap each product
// of the filter (larvio_tpu/core/linalg.py::mm and the vmapped models) is one
// XLA dot_general for all lanes. The port's counterpart must not let a lane's
// bits depend on the fleet's width (ROADMAP F4, F5): cuBLAS picks its kernel,
// and how it splits a long sum, by the batch count and folds a broadcast
// operand's batch into its rows, so a batched cuBLAS product cannot promise
// that, and one cuBLAS call per lane costs a launch per lane.
//
// The order, the rule every kernel below keeps: each output element is ONE
// thread's accumulator, acc = 0, then acc = fmaf(A[m, k], B[k, n], acc) for
// k = 0 .. K-1 ascending. No split-K, no atomics, no tensor cores (TF32 would
// break the f32 rule), no fast math. So an element's bits are a function of
// its row of A and its column of B alone.
//   - What may follow anything, the batch count included: the shape class,
//     the tile shapes, how many batch indices a block packs, the grid, where
//     an operand is staged (registers, shared memory). None of these changes
//     an element's sum.
//   - What may not: the order of an element's sum. It depends on nothing,
//     not even on (M, N, K). A split-K or a reduction tree chosen by the
//     batch count would make a lane's bits depend on the width again (F4).
//
// Layout: A, B are strided views (any strides, stride 0 for a broadcast
// axis, transposed views as they are: nothing is copied); the leading axes
// are passed as up to LMM_MAX_DIMS (size, stride of A, stride of B) triples;
// C is contiguous (lead..., M, N). The wrapper (ops/lane_mm_cuda.py::plan)
// picks the shape class from (M, N, K) and the strides:
//   flat   (tiny M N <= 16, one-row M == 1, and every other product that is
//          neither a GEMM nor a long matrix-vector product): one thread per
//          output element over all batch indices, 256 to a block, so many
//          small matrices share a block; operands read straight from device
//          memory, LMM_CHUNK loads of a thread in flight before its sums (the
//          L1 catches the reuse of a tiny matrix; a row of A is one broadcast
//          load per warp, a row of B one coalesced load). Bound: the bytes of
//          the operands, and launch latency for the tiny ones.
//   rows   (matrix-vector N == 1, M >= 2, K >= 128, either layout of A): one
//          block per (batch index, 32 rows); all eight warps stage A's 32 x
//          LMM_RK tile and B's LMM_RK values by cp.async along A's
//          contiguous axis, two stages, and the first warp sums them (lane =
//          row, k ascending). Bound: the bytes of A; at 8 lanes the one
//          thread's dependent chain of K fmaf per row (K = 984 at the Gram
//          update), which the staging keeps fed.
//   tiled  (GEMM, M >= 16 and N >= 16): one block per (batch index, BM x BN
//          tile of C), ty x tx threads each keeping a 4 x 4 register tile of
//          accumulators; A and B staged through dynamic shared memory sized
//          to the tile in K steps of 16 by cp.async, three stages (two
//          steps' copies in flight while one is summed), each staging load
//          along the operand's contiguous axis. Bound: the f32 FMA rate
//          (16 fmaf per two float4 shared-memory loads) for D x D x D and the
//          update's H_o P; the shared-memory loads and the barrier of each K
//          step hold it below that.

#include <cuda_runtime.h>

#define LMM_MAX_DIMS 8
#define LMM_THREADS 256
#define LMM_BK 16         // tiled: the K step
#define LMM_TILE_MAX 128  // tiled: BM, BN <= 128 (ty, tx <= 32 threads of a 4 x 4 tile)
#define LMM_TM 4
#define LMM_TN 4
#define LMM_CHUNK 16      // flat: loads in flight per thread
#define LMM_RK 128        // rows: the K step
#define LMM_STAGES 3      // tiled: K steps in flight
#define LMM_SMEM_MAX 232448  // bytes of shared memory a block may use (Hopper)

enum { LMM_FLAT = 0, LMM_ROWS = 1, LMM_TILED = 2 };

struct LaneMMArgs {
  int nd;                          // leading axes
  unsigned size[LMM_MAX_DIMS];     // their sizes
  long long sa[LMM_MAX_DIMS];      // A's strides along them (elements)
  long long sb[LMM_MAX_DIMS];      // B's strides along them
  unsigned batch;                  // the product of the sizes
  int M, N, K;
  long long a_sm, a_sk, b_sk, b_sn;  // A's row and column strides, B's
  int ty, tx;                      // tiled: the block's threads (BM = 4 ty, BN = 4 tx)
  unsigned tiles_m, tiles_n;       // tiled: tiles of C per batch index
};

// The operands' offsets of batch index ``bidx`` (row-major over the
// leading axes, the last one fastest).
__device__ __forceinline__ void lmm_offsets(const LaneMMArgs& p, unsigned bidx, long long& offA,
                                            long long& offB) {
  offA = 0;
  offB = 0;
  for (int d = p.nd - 1; d >= 0; --d) {
    const unsigned q = bidx / p.size[d];
    const unsigned i = bidx - q * p.size[d];
    bidx = q;
    offA += (long long)i * p.sa[d];
    offB += (long long)i * p.sb[d];
  }
}

__global__ void __launch_bounds__(LMM_THREADS)
lane_mm_flat_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                    const LaneMMArgs p) {
  const unsigned mn = (unsigned)p.M * (unsigned)p.N;
  const unsigned e = blockIdx.x * LMM_THREADS + threadIdx.x;  // C's element, row-major
  if (e >= p.batch * mn) return;
  const unsigned bidx = e / mn, r = e - bidx * mn;
  const unsigned i = r / (unsigned)p.N, j = r - i * (unsigned)p.N;
  long long offA, offB;
  lmm_offsets(p, bidx, offA, offB);
  const float* a = A + offA + (long long)i * p.a_sm;
  const float* b = B + offB + (long long)j * p.b_sn;
  float acc = 0.0f;
  int k = 0;
  for (; k + LMM_CHUNK <= p.K; k += LMM_CHUNK) {  // the chunk's loads in flight together, then its sums in order
    float av[LMM_CHUNK], bv[LMM_CHUNK];
#pragma unroll
    for (int u = 0; u < LMM_CHUNK; ++u) {
      av[u] = __ldg(a + (long long)(k + u) * p.a_sk);
      bv[u] = __ldg(b + (long long)(k + u) * p.b_sk);
    }
#pragma unroll
    for (int u = 0; u < LMM_CHUNK; ++u) acc = fmaf(av[u], bv[u], acc);
  }
  for (; k < p.K; ++k) acc = fmaf(__ldg(a + (long long)k * p.a_sk), __ldg(b + (long long)k * p.b_sk), acc);
  C[e] = acc;
}

__device__ __forceinline__ void lmm_cp_async4(float* smem, const float* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 4 : 0;  // 0: the shared word is zero-filled, nothing read
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__global__ void __launch_bounds__(LMM_THREADS)
lane_mm_rows_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                    const LaneMMArgs p) {
  __shared__ float At[2][32][LMM_RK + 1];  // rows x k, padded
  __shared__ float Bt[2][LMM_RK];
  const unsigned groups = (p.M + 31) / 32;
  const unsigned bidx = blockIdx.x / groups, g = blockIdx.x - bidx * groups;
  long long offA, offB;
  lmm_offsets(p, bidx, offA, offB);
  const int row0 = g * 32, nrows = min(32, p.M - row0), t = threadIdx.x;
  const float* a = A + offA + (long long)row0 * p.a_sm;
  const float* b = B + offB;  // N == 1: B's only column
  const bool kfast = !(p.a_sm == 1 && p.a_sk != 1);  // stage along A's contiguous axis
  auto stage = [&](int buf, int k0) {  // the valid rows and k only: nothing past them is summed
    const int kc = min(LMM_RK, p.K - k0), w = t >> 5, l = t & 31;
    if (kfast) {  // warps along rows, lanes along k
      for (int r = w; r < nrows; r += LMM_THREADS / 32)
        for (int k = l; k < kc; k += 32)
          lmm_cp_async4(&At[buf][r][k], a + (long long)r * p.a_sm + (long long)(k0 + k) * p.a_sk, true);
    } else if (l < nrows) {  // lanes along rows, warps along k
      for (int k = w; k < kc; k += LMM_THREADS / 32)
        lmm_cp_async4(&At[buf][l][k], a + (long long)l * p.a_sm + (long long)(k0 + k) * p.a_sk, true);
    }
    if (t < kc) lmm_cp_async4(&Bt[buf][t], b + (long long)(k0 + t) * p.b_sk, true);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  float acc = 0.0f;
  const int steps = (p.K + LMM_RK - 1) / LMM_RK;
  if (steps > 0) stage(0, 0);
  for (int s = 0; s < steps; ++s) {
    const int buf = s & 1;
    if (s + 1 < steps) {
      stage(buf ^ 1, (s + 1) * LMM_RK);  // every warp loads; the first one sums
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (t < 32) {  // lane = row: k ascending, one accumulator
      const int kc = min(LMM_RK, p.K - s * LMM_RK);
#pragma unroll 8
      for (int kk = 0; kk < kc; ++kk) acc = fmaf(At[buf][t][kk], Bt[buf][kk], acc);
    }
    __syncthreads();
  }
  if (t < nrows) C[(long long)bidx * p.M + row0 + t] = acc;
}

__global__ void __launch_bounds__(LMM_THREADS)
lane_mm_tiled_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
                     const LaneMMArgs p) {
  extern __shared__ __align__(16) float lmm_smem[];  // the block's stages, sized to its tile
  unsigned blk = blockIdx.x;
  const unsigned tn = blk % p.tiles_n;
  blk /= p.tiles_n;
  const unsigned tm = blk % p.tiles_m;
  const unsigned bidx = blk / p.tiles_m;
  long long offA, offB;
  lmm_offsets(p, bidx, offA, offB);
  const int BM = p.ty * LMM_TM, BN = p.tx * LMM_TN, nthr = p.ty * p.tx;
  const int t = threadIdx.x, tyi = t / p.tx, txi = t - tyi * p.tx;
  const int row0 = tm * BM, col0 = tn * BN;
  const float* Ab = A + offA;
  const float* Bb = B + offB;
  const bool a_kfast = p.a_sk == 1 && p.a_sm != 1;  // stage along the contiguous axis
  const bool b_nfast = !(p.b_sk == 1 && p.b_sn != 1);
  const int lda = BM + 4, ldb = BN + 4;  // padded rows, float4-aligned
  float* As = lmm_smem;                               // [stage][k][m]
  float* Bs = lmm_smem + LMM_STAGES * LMM_BK * lda;   // [stage][k][n]

  auto stage = [&](int buf, int k0) {
    for (int e = t; e < BM * LMM_BK; e += nthr) {
      const int m = a_kfast ? e / LMM_BK : e % BM, k = a_kfast ? e % LMM_BK : e / BM;
      const bool ok = row0 + m < p.M && k0 + k < p.K;
      lmm_cp_async4(&As[(buf * LMM_BK + k) * lda + m], ok ? Ab + (long long)(row0 + m) * p.a_sm + (long long)(k0 + k) * p.a_sk : Ab, ok);
    }
    for (int e = t; e < LMM_BK * BN; e += nthr) {
      const int n = b_nfast ? e % BN : e / LMM_BK, k = b_nfast ? e / BN : e % LMM_BK;
      const bool ok = col0 + n < p.N && k0 + k < p.K;
      lmm_cp_async4(&Bs[(buf * LMM_BK + k) * ldb + n], ok ? Bb + (long long)(k0 + k) * p.b_sk + (long long)(col0 + n) * p.b_sn : Bb, ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[LMM_TM][LMM_TN];
#pragma unroll
  for (int i = 0; i < LMM_TM; ++i)
#pragma unroll
    for (int j = 0; j < LMM_TN; ++j) acc[i][j] = 0.0f;

  const int steps = (p.K + LMM_BK - 1) / LMM_BK;
  for (int s = 0; s < LMM_STAGES - 1; ++s) {  // one commit group per step, empty past the end
    if (s < steps) stage(s, s * LMM_BK);
    else asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int s = 0; s < steps; ++s) {
    const int buf = s % LMM_STAGES, ahead = s + LMM_STAGES - 1;
    // the stage read at step s - 1, freed by the barrier that ended it
    if (ahead < steps) stage(ahead % LMM_STAGES, ahead * LMM_BK);
    else asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(LMM_STAGES - 1));  // step s's copies have landed
    __syncthreads();
    const int kc = min(LMM_BK, p.K - s * LMM_BK);  // no padding terms enter a sum
    auto step = [&](int kk) {
      const float4 a4 = *reinterpret_cast<const float4*>(&As[(buf * LMM_BK + kk) * lda + tyi * LMM_TM]);
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[(buf * LMM_BK + kk) * ldb + txi * LMM_TN]);
      const float a[LMM_TM] = {a4.x, a4.y, a4.z, a4.w}, b[LMM_TN] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < LMM_TM; ++i)
#pragma unroll
        for (int j = 0; j < LMM_TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    };
    if (kc == LMM_BK) {
#pragma unroll
      for (int kk = 0; kk < LMM_BK; ++kk) step(kk);
    } else {
      for (int kk = 0; kk < kc; ++kk) step(kk);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < LMM_TM; ++i) {
    const int gi = row0 + tyi * LMM_TM + i;
    if (gi >= p.M) break;
#pragma unroll
    for (int j = 0; j < LMM_TN; ++j) {
      const int gj = col0 + txi * LMM_TN + j;
      if (gj < p.N) C[((long long)bidx * p.M + gi) * p.N + gj] = acc[i][j];
    }
  }
}

// Opens a kernel's dynamic shared memory up to the maximum, once per device
// (the first call, in an eager step before any capture).
static cudaError_t lmm_open_smem(const void* kernel) {
  static const void* opened[64][16] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  for (int i = 0; i < 16; ++i) {
    if (opened[dev][i] == kernel) return cudaSuccess;
    if (!opened[dev][i]) {
      cudaFuncAttributes attr;
      cudaError_t e = cudaFuncGetAttributes(&attr, kernel);  // its static shared memory counts too
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 LMM_SMEM_MAX - (int)attr.sharedSizeBytes);
      if (e == cudaSuccess) opened[dev][i] = kernel;
      return e;
    }
  }
  return cudaErrorInvalidValue;
}

// C (lead..., M, N), contiguous, from the strided A and B, in the shape
// class ``kind`` (LMM_FLAT, LMM_ROWS, LMM_TILED; ``ty``, ``tx`` the tiled
// block's threads). Returns a cudaError_t (0 on success). nd <=
// LMM_MAX_DIMS; M, N >= 1 and at least one batch index (the wrapper returns
// an empty C without a launch otherwise).
extern "C" int larvio_lane_mm(const float* A, const float* B, float* C, int nd, const long long* size,
                              const long long* sa, const long long* sb, int M, int N, int K,
                              long long a_sm, long long a_sk, long long b_sk, long long b_sn, int kind,
                              int ty, int tx, void* stream) {
  if (nd < 0 || nd > LMM_MAX_DIMS || M < 1 || N < 1 || K < 0) return (int)cudaErrorInvalidValue;
  LaneMMArgs p;
  p.nd = nd;
  long long batch = 1;
  for (int d = 0; d < nd; ++d) {
    if (size[d] < 1 || size[d] > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    p.size[d] = (unsigned)size[d];
    p.sa[d] = sa[d];
    p.sb[d] = sb[d];
    batch *= size[d];
  }
  for (int d = nd; d < LMM_MAX_DIMS; ++d) p.size[d] = 1, p.sa[d] = 0, p.sb[d] = 0;
  if (batch * M * N > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  p.batch = (unsigned)batch;
  p.M = M, p.N = N, p.K = K;
  p.a_sm = a_sm, p.a_sk = a_sk, p.b_sk = b_sk, p.b_sn = b_sn;
  p.ty = ty, p.tx = tx, p.tiles_m = 1, p.tiles_n = 1;
  cudaStream_t s = (cudaStream_t)stream;
  if (kind == LMM_FLAT) {
    const long long blocks = (batch * M * N + LMM_THREADS - 1) / LMM_THREADS;
    lane_mm_flat_kernel<<<(unsigned)blocks, LMM_THREADS, 0, s>>>(A, B, C, p);
  } else if (kind == LMM_ROWS) {
    if (N != 1) return (int)cudaErrorInvalidValue;
    const long long blocks = batch * ((M + 31) / 32);
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    lane_mm_rows_kernel<<<(unsigned)blocks, LMM_THREADS, 0, s>>>(A, B, C, p);
  } else if (kind == LMM_TILED) {
    if (ty < 1 || tx < 1 || ty * tx > LMM_THREADS || ty * LMM_TM > LMM_TILE_MAX || tx * LMM_TN > LMM_TILE_MAX)
      return (int)cudaErrorInvalidValue;
    p.tiles_m = (M + ty * LMM_TM - 1) / (ty * LMM_TM);
    p.tiles_n = (N + tx * LMM_TN - 1) / (tx * LMM_TN);
    const long long blocks = batch * p.tiles_m * p.tiles_n;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
    const cudaError_t e = lmm_open_smem((const void*)lane_mm_tiled_kernel);
    if (e != cudaSuccess) return (int)e;
    const size_t smem = 4 * LMM_STAGES * LMM_BK * (ty * LMM_TM + 4 + tx * LMM_TN + 4);
    lane_mm_tiled_kernel<<<(unsigned)blocks, ty * tx, smem, s>>>(A, B, C, p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The lane-batched triangular solve, the same promise for X = A^{-1} B with
// A (lead..., n, n) triangular (lower or upper, any strides: a transposed
// view is passed as it is) and B (lead..., n, W) strided; X contiguous. It
// replaces torch.linalg.solve_triangular for a fleet's D x D systems, where
// PyTorch loops cuBLAS's trsm over batches of at most 8 and calls the
// batched trsm above 8, so a lane's bits changed between 8 and 256 lanes.
//
// The order (every element, whatever the tiling):
//   X[i, j] = (B[i, j] - sum_k A[i, k] X[k, j]) / A[i, i],
// the sum one accumulator starting at B[i, j], k ascending (lower) or
// descending (upper), each step acc = fmaf(-A[i, k], X[k, j], acc), the
// division IEEE-rounded.
//
// One block per (batch index, tile of wt columns of X). The block stages A's
// triangle in dynamic shared memory by cp.async, each load along A's
// contiguous axis, column by column from the diagonal down (n (n + 1) / 2
// floats, 61.6 KB at n = 175; an upper A is stored index-reversed, r' = n -
// 1 - r, as a lower one, so both solve forward). Then each of its 8 warps
// solves wt / 8 columns on its own, with no barrier: lane l holds the
// accumulators of rows l, l + 32, ... of each column in registers, loaded
// from B. The rows go in panels of 32 (one register slot each). A panel is
// solved row by row: row i's lane, whose accumulators then hold every term,
// hands column c's to lane c, which divides it by A[i, i] (the C divisions
// side by side) and writes X; x_i goes to the warp by shuffles, and the
// panel's rows below i take acc[r] = fmaf(-A[r, i], x_i, acc[r]).
// Then every row of the later panels takes the panel's 32 terms, i
// ascending. Each element so sums its terms in the order above exactly
// (panel by panel, then within its own panel), whatever the panels. Every
// index into the registers is a compile-time one (a row chosen by a runtime
// index would send them to local memory). The wrapper picks wt (8, 16, 32
// or 64) from W and the batch count, which may follow anything: columns are
// independent.
//
// What bounds it: per warp, n steps of a division and a shuffle on the
// critical path (the panels' solves); the ~n^2 W / 2 fmaf of the later
// panels' updates in throughput (A's column from shared memory, consecutive
// lanes on consecutive words), with the blocks of all lanes in flight.

#define LTRSM_THREADS 256
#define LTRSM_XS_MAX (LTRSM_THREADS * 8 * 4)  // bytes of the largest static panel buffer (8 columns a warp)

struct LaneTrsmArgs {
  int nd;
  unsigned size[LMM_MAX_DIMS];
  long long sa[LMM_MAX_DIMS];
  long long sb[LMM_MAX_DIMS];
  int n, W, upper, wt, log2_wt;
  long long a_sr, a_sc, b_sr, b_sc;
  unsigned tiles_w;
};

template <int R, int C>  // rows per lane (n <= 32 R), columns per warp (wt = 8 C)
__global__ void __launch_bounds__(LTRSM_THREADS)
lane_trsm_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ X,
                 const LaneTrsmArgs p) {
  extern __shared__ __align__(16) float lt_smem[];
  __shared__ float lt_xs[LTRSM_THREADS / 32 * 32 * C];
  const int n = p.n;
  float* L = lt_smem;  // column c' from its diagonal down, at c' n - c' (c' - 1) / 2
  const unsigned tw = blockIdx.x % p.tiles_w;
  unsigned rem = blockIdx.x / p.tiles_w;
  const unsigned bidx = rem;
  long long offA = 0, offB = 0;
  for (int d = p.nd - 1; d >= 0; --d) {
    const unsigned q = rem / p.size[d];
    const unsigned i = rem - q * p.size[d];
    rem = q;
    offA += (long long)i * p.sa[d];
    offB += (long long)i * p.sb[d];
  }
  const float* Ab = A + offA;
  const float* Bb = B + offB;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31, nwarps = LTRSM_THREADS / 32;
  // stage A's triangle: r', c' (c' <= r') of the lower or index-reversed upper
  // A, every copy of the block in flight at once (cp.async)
  auto a_at = [&](int r, int c) -> const float* {
    return p.upper ? Ab + (long long)(n - 1 - r) * p.a_sr + (long long)(n - 1 - c) * p.a_sc
                   : Ab + (long long)r * p.a_sr + (long long)c * p.a_sc;
  };
  auto at = [&](int r, int c) { return c * n - c * (c - 1) / 2 + (r - c); };
  const long long a_c = p.a_sc < 0 ? -p.a_sc : p.a_sc, a_r = p.a_sr < 0 ? -p.a_sr : p.a_sr;
  if (a_c <= a_r) {  // lanes along c' (A's contiguous axis, forwards or backwards)
    for (int r = warp; r < n; r += nwarps)
      for (int c = lane; c <= r; c += 32) lmm_cp_async4(&L[at(r, c)], a_at(r, c), true);
  } else {  // lanes along r'
    for (int c = warp; c < n; c += nwarps)
      for (int r = c + lane; r < n; r += 32) lmm_cp_async4(&L[at(r, c)], a_at(r, c), true);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  // this warp's C columns; lane l holds rows l, l + 32, ... of each, starting at B
  const int col0 = tw * p.wt + warp * C;
  float y[R][C];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int r = lane + 32 * q, ro = p.upper ? n - 1 - r : r;
#pragma unroll
    for (int c = 0; c < C; ++c)
      y[q][c] = r < n && col0 + c < p.W ? __ldg(Bb + (long long)ro * p.b_sr + (long long)(col0 + c) * p.b_sc) : 0.0f;
  }
  asm volatile("cp.async.wait_group 0;\n" ::);
  __syncthreads();
  if (col0 >= p.W) return;  // no barrier below: each warp substitutes on its own
  float* Xb = X + (long long)bidx * n * p.W + col0;
  float(*xs)[C] = reinterpret_cast<float(*)[C]>(lt_xs + warp * 32 * C);  // the panel's solved rows
  // panel p: rows 32p .. 32p + 31, row 32p + l in lane l's y[p]
#pragma unroll
  for (int pn = 0; pn < R; ++pn) {
    const int i0 = 32 * pn;
    if (i0 < n) {
      // 1. the panel, row by row: the row's lane solves it (its accumulator holds every
      //    earlier term), the warp takes x_i by a shuffle, the panel's rows below update
      const int iend = min(i0 + 32, n);
      for (int i = i0; i < iend; ++i) {
        const int l = i - i0;
        const float d = L[at(i, i)];
        // lane c (< C) takes column c of row i from lane l and divides it: the
        // C divisions side by side, then x_i of every column to the warp
        float v = 0.0f;
#pragma unroll
        for (int c = 0; c < C; ++c) {
          const float t = __shfl_sync(0xffffffffu, y[pn][c], l);
          v = lane == c ? t : v;
        }
        const float xv = v / d;
        if (lane < C) {
          xs[l][lane] = xv;
          if (col0 + lane < p.W) Xb[(long long)(p.upper ? n - 1 - i : i) * p.W + lane] = xv;
        }
        float x[C];
#pragma unroll
        for (int c = 0; c < C; ++c) x[c] = __shfl_sync(0xffffffffu, xv, c);
        if (lane > l && i0 + lane < n) {
          const float a = L[at(i0 + lane, i)];
#pragma unroll
          for (int c = 0; c < C; ++c) y[pn][c] = fmaf(-a, x[c], y[pn][c]);
        }
      }
      __syncwarp();
      // 2. the panels below: every row takes the panel's x_i, i ascending
      for (int i = i0, cs = at(i0, i0); i < iend; cs += n - i, ++i) {
        float x[C];
#pragma unroll
        for (int c = 0; c < C; ++c) x[c] = xs[i - i0][c];
#pragma unroll
        for (int q = pn + 1; q < R; ++q) {
          const int r = lane + 32 * q;
          if (r < n) {
            const float a = L[cs + (r - i)];
#pragma unroll
            for (int c = 0; c < C; ++c) y[q][c] = fmaf(-a, x[c], y[q][c]);
          }
        }
      }
      __syncwarp();
    }
  }
}

// X (lead..., n, W), contiguous, from the strided A and B, ``wt`` columns of
// X per block (8, 16, 32 or 64: 1, 2, 4 or 8 per warp). Returns a
// cudaError_t (0 on success).
extern "C" int larvio_lane_trsm(const float* A, const float* B, float* X, int nd, const long long* size,
                                const long long* sa, const long long* sb, int n, int W, int upper,
                                long long a_sr, long long a_sc, long long b_sr, long long b_sc, int wt,
                                void* stream) {
  if (nd < 0 || nd > LMM_MAX_DIMS || n < 1 || W < 1) return (int)cudaErrorInvalidValue;
  const long long smem = 4LL * ((long long)n * (n + 1) / 2);
  if (smem + LTRSM_XS_MAX > LMM_SMEM_MAX || (wt != 8 && wt != 16 && wt != 32 && wt != 64)) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const float*, const float*, float*, const LaneTrsmArgs);
#define LTRSM_BY_C(R) (wt == 8 ? (Kernel)lane_trsm_kernel<R, 1> : wt == 16 ? (Kernel)lane_trsm_kernel<R, 2> \
                       : wt == 32 ? (Kernel)lane_trsm_kernel<R, 4> : (Kernel)lane_trsm_kernel<R, 8>)
  const Kernel kernel = n <= 32 ? LTRSM_BY_C(1) : n <= 64 ? LTRSM_BY_C(2) : n <= 128 ? LTRSM_BY_C(4)
                      : n <= 192 ? LTRSM_BY_C(6) : n <= 256 ? LTRSM_BY_C(8) : n <= 384 ? LTRSM_BY_C(12) : nullptr;
#undef LTRSM_BY_C
  if (!kernel) return (int)cudaErrorInvalidValue;
  const cudaError_t e = lmm_open_smem((const void*)kernel);
  if (e != cudaSuccess) return (int)e;
  LaneTrsmArgs p;
  p.nd = nd;
  long long batch = 1;
  for (int d = 0; d < nd; ++d) {
    if (size[d] < 1 || size[d] > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
    p.size[d] = (unsigned)size[d];
    p.sa[d] = sa[d];
    p.sb[d] = sb[d];
    batch *= size[d];
  }
  for (int d = nd; d < LMM_MAX_DIMS; ++d) p.size[d] = 1, p.sa[d] = 0, p.sb[d] = 0;
  p.n = n, p.W = W, p.upper = upper, p.wt = wt;
  p.log2_wt = 0;
  while ((1 << p.log2_wt) < wt) ++p.log2_wt;
  p.a_sr = a_sr, p.a_sc = a_sc, p.b_sr = b_sr, p.b_sc = b_sc;
  p.tiles_w = (W + wt - 1) / wt;
  const long long blocks = batch * p.tiles_w;
  if (blocks < 1 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  kernel<<<(unsigned)blocks, LTRSM_THREADS, (size_t)smem, (cudaStream_t)stream>>>(A, B, X, p);
  return (int)cudaGetLastError();
}
