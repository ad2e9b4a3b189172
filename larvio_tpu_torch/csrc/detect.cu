// The fused corner detector: for each grid cell of each image, the top k of
// grid_topk(nms(shi_tomasi_response(img), radius), ...) of
// larvio_tpu_torch/ops/detect.py in one launch, from the float image, with
// the plain chain's bits.
//
// The JAX package runs this chain as XLA operations (no TPU kernel); on the
// card the plain chain is ~130-145 PyTorch kernels a frame, each a full pass
// over the frame (Scharr, the three products, three 5-tap box filters, the
// eigenvalue, two max pools, the border mask, the grid's padding and a
// stable sort of every cell), while its whole output is k scores and
// positions per cell.
//
// One block per (cell, lane) (grid (cells, B)), one thread per image column
// of the cell and its halo of 3 + r columns (Scharr 1, box 2, NMS radius r).
// The block sweeps the cell's rows top to bottom with the stages pipelined,
// each working on an older row than the one before it:
//   1. the image row (edge rows clamped), held in a 3-row register window:
//      the Scharr row passes (smooth [3,10,3]/32 for gx, diff [-1,0,1] for gy)
//      -> shared memory;
//   2. the Scharr column passes from the neighbours' row-pass values, the
//      three products gx*gx, gy*gy, gx*gy into a 5-row register window, the
//      box filter's row pass -> shared memory;
//   3. the box filter's column pass from the neighbours' values, the
//      eigenvalue (-inf outside the image), and the column max over 2r+1
//      rows by van Herk's method: the responses go into a ring of 2r+1 rows,
//      each completed block of 2r+1 leaves its suffix maxima, and the max is
//      that suffix's and the running block's (two reads a row, not 2r+1)
//      -> shared memory, between -inf margins r wide;
//   4. the row max of the neighbours' column maxima (outside the image the
//      margins' -inf), the NMS test, the border mask: one candidate per pixel
//      into the thread's list of its k largest keys (shared memory; a key
//      below the list's last is dropped with one compare).
// Each stage reads what the stage before it wrote in the previous step and
// writes the other half of a double buffer, so a step ends in one barrier.
// After the sweep the grid's padding (columns x >= W and rows y >= H of the
// cell, the zeros Fn.pad makes) joins as 0.0 candidates, and k rounds of a
// block-wide max over the lists' heads give the cell's top k.
//
// The bits are the plain chain's (ROADMAP D's rules):
//   - each separable filter runs its row taps (axis -2) before its column
//     taps (axis -1); zero taps are skipped; every tap is __fmul_rn(x, tap)
//     with the tap in float32, summed with __fadd_rn from the first nonzero
//     tap on, in tap order (nothing is contracted into an FMA);
//   - edge replication is an index clamp into the image's domain, which is
//     every intermediate's domain: a row out of the image is its edge row's
//     value (the 5-row window is filled with row 0 when row 0 arrives and
//     repeats row H-1 after it), a column is clamped before it is read;
//   - tr = 0.5 (gxx + gyy), det = sqrt(max(a*a + gxy*gxy, 0)) with
//     a = 0.5 (gxx - gyy), tr - det, in the plain expression's order;
//     __fsqrt_rn is correctly rounded, as torch.sqrt is;
//   - NMS: the (2r+1) max over rows, then over columns, NaN-propagating
//     (max.NaN.f32, as max_pool2d propagates NaN), -inf outside the image;
//     a pixel is kept where resp >= max, else 0.0; then the border mask;
//   - the order of a cell's candidates is torch.sort(descending=True,
//     stable=True)'s: value descending, in-cell index cy*cw + cx ascending on
//     ties, as one 64-bit key (the value's radix-sort order, then the index
//     reversed): every key differs, so the block's max is unique each
//     round. No float atomics; nothing depends on the grid or the lane count.
//
// What bounds it on an H100: instructions and shared-memory reads (~40 a
// pixel, most in the two horizontal passes and the NMS row window), with
// four blocks of 192 threads to an SM, not bytes: a lane's image is read
// once with its halo. tests/test_torch_detect.py emulates this sweep step by
// step in numpy; tests/test_torch_cuda.py holds it to the plain chain.

#include <cuda_runtime.h>

#define DET_MAX_THREADS 512  // columns of a cell and its halo, rounded up to a warp
#define DET_MAX_WARPS (DET_MAX_THREADS / 32)
#define DET_MAX_K 32
#define DET_NEG_INF __int_as_float(0xff800000)

__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// value descending (radix order of the float, -0 as +0), then index ascending
__device__ __forceinline__ unsigned long long cand_key(float v, unsigned idx) {
  const unsigned b = __float_as_uint(__fadd_rn(v, 0.0f));
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return ((unsigned long long)o << 32) | (unsigned long long)(0xFFFFFFFFu - idx);
}

// A thread's candidate list: its k largest keys so far, largest first, in
// shared memory (entry i of thread t at lst[i * bd]). Returns the k-th key.
__device__ __forceinline__ unsigned long long list_insert(unsigned long long* lst, int bd, int k,
                                                          unsigned long long key) {
  int i = k - 1;
  for (; i > 0; --i) {
    const unsigned long long p = lst[(i - 1) * bd];
    if (p > key) break;
    lst[i * bd] = p;
  }
  lst[i * bd] = key;
  return lst[(k - 1) * bd];
}

// acc = t*p[0] + t*p[1] + ... + t*p[4], left to right (sep_filter's order)
__device__ __forceinline__ float box5(float p0, float p1, float p2, float p3, float p4) {
  const float t = 0.2f;  // float32(1.0 / 5)
  float acc = __fmul_rn(p0, t);
  acc = __fadd_rn(acc, __fmul_rn(p1, t));
  acc = __fadd_rn(acc, __fmul_rn(p2, t));
  acc = __fadd_rn(acc, __fmul_rn(p3, t));
  return __fadd_rn(acc, __fmul_rn(p4, t));
}

// [3, 10, 3] / 32 over three values, left to right
__device__ __forceinline__ float smooth3(float a, float b, float c) {
  const float s3 = 0.09375f, s10 = 0.3125f;
  return __fadd_rn(__fadd_rn(__fmul_rn(a, s3), __fmul_rn(b, s10)), __fmul_rn(c, s3));
}

// [-1, 0, 1]: the zero tap skipped
__device__ __forceinline__ float diff3(float a, float c) {
  return __fadd_rn(__fmul_rn(a, -1.0f), __fmul_rn(c, 1.0f));
}

// 80 registers a thread let four blocks of 192 threads share an SM (the
// compiler's own choice spills or holds three).
__global__ void __maxnreg__(80)
detect_kernel(const float* __restrict__ img, int H, int W, int grid_cols, int ch, int cw, int k,
              int border, int r, float* __restrict__ scores, float* __restrict__ xy) {
  extern __shared__ float smem[];
  const int win = 2 * r + 1, h = 3 + r;
  const int bd = blockDim.x, t = threadIdx.x;
  const int cell = blockIdx.x, n_cells = gridDim.x;
  const size_t b = blockIdx.y;
  const int Y0 = (cell / grid_cols) * ch, X0 = (cell % grid_cols) * cw;
  const int Y1 = min(Y0 + ch, H), X1 = min(X0 + cw, W);
  float* rsrd = smem;          // [2 halves][rs, rd][bd]
  float* vs = rsrd + 4 * bd;   // [2][row-pass box sums of pxx, pyy, pxy][bd]
  float* raw = vs + 6 * bd;    // [win][bd]: this thread's responses, push s at s mod win
  float* suf = raw + win * bd; // [win][bd]: the suffix maxima of the last complete win pushes
  float* vm = suf + win * bd;  // [2][r + bd + r]: column maxima, -inf in the r-wide margins
  unsigned long long* red =
      reinterpret_cast<unsigned long long*>(vm + 2 * (bd + 2 * r));  // [2][warps]
  unsigned long long* lists = red + 2 * DET_MAX_WARPS;  // [k][bd]
  for (int i = t; i < (12 + 2 * win) * bd + 4 * r; i += bd)
    smem[i] = i < 10 * bd ? 0.0f : DET_NEG_INF;  // rsrd, vs zero; raw, suf, vm -inf
  for (int i = t; i < k * bd; i += bd) lists[i] = 0ull;  // below every candidate's key
  unsigned long long* lst = lists + t;
  unsigned long long thr = 0ull;  // the k-th key of this thread's list
  __syncthreads();

  if (Y0 < H && X0 < W) {  // block-uniform: the cell holds image pixels
    const int Xlo = max(X0 - h, 0), Xhi = min(X1 + h, W), n = Xhi - Xlo;
    const int tl = min(t, n - 1);  // threads past the region repeat its last column
    const int c = Xlo + tl;
    // the local index of column clamp(c + d) (clamped into the region too:
    // a column whose neighbours leave the region is never needed)
    int nb[5];
#pragma unroll
    for (int d = -2; d <= 2; ++d) nb[d + 2] = min(max(min(max(c + d, 0), W - 1) - Xlo, 0), n - 1);
    const bool emits = t < n && c >= X0 && c < X1;

    const float* im = img + b * (size_t)H * (size_t)W + c;
    float w0 = 0.f, w1 = 0.f, w2 = 0.f;  // image rows
    float q[5][3];                       // the products' rows, oldest first
#pragma unroll
    for (int j = 0; j < 5; ++j) q[j][0] = q[j][1] = q[j][2] = 0.f;
    float pmax = DET_NEG_INF;  // the max of this block of win pushes so far
    float resp_c = 0.f;        // the response at the row of the column max in vm
    float pre = im[(size_t)min(max(Y0 - h, 0), H - 1) * W];
    const int steps = (Y1 - Y0) + 2 * r + 9;
    int slot = 0;  // s mod win
    for (int s = 0; s < steps; ++s) {
      const float row = pre;
      if (s + 1 < steps) pre = im[(size_t)min(max(Y0 - h + s + 1, 0), H - 1) * W];
      const int rd_half = (s + 1) & 1, wr_half = s & 1;

      // 4. row ry: the row max of the column maxima, NMS, border, candidate
      const int ry = Y0 - h - 6 - r + s;
      if (ry >= Y0 && ry < Y1) {
        // columns c - r .. c + r; outside the image the margins' or the idle
        // threads' -inf (a column the cell needs never leaves the region otherwise)
        const float* m_row = vm + rd_half * (bd + 2 * r) + tl;
        float m = m_row[0];
#pragma unroll 4
        for (int d = 1; d < win; ++d) m = max_nan(m, m_row[d]);
        float v = resp_c >= m ? resp_c : 0.0f;
        if (ry < border || ry >= H - border || c < border || c >= W - border) v = 0.0f;
        if (emits) {
          const unsigned long long key = cand_key(v, (unsigned)((ry - Y0) * cw + (c - X0)));
          if (key > thr) thr = list_insert(lst, bd, k, key);
        }
      }

      // 3. row rr = ry + r + 1: the box column pass, the eigenvalue; the
      //    column max of rows rr - 2r .. rr (van Herk: the suffix maxima of the
      //    last complete block of win pushes and this block's running max)
      {
        const float* v = vs + rd_half * 3 * bd;
        float g[3];
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          const float* va = v + a * bd;
          g[a] = box5(va[nb[0]], va[nb[1]], va[nb[2]], va[nb[3]], va[nb[4]]);
        }
        const float tr = __fmul_rn(__fadd_rn(g[0], g[1]), 0.5f);
        const float a = __fmul_rn(__fsub_rn(g[0], g[1]), 0.5f);
        float det2 = __fadd_rn(__fmul_rn(a, a), __fmul_rn(g[2], g[2]));
        det2 = det2 < 0.0f ? 0.0f : det2;  // torch.clamp(min=0): NaN passes
        const int rr = Y0 - h - 5 + s;
        const float x = (rr >= 0 && rr < H) ? __fsub_rn(tr, __fsqrt_rn(det2)) : DET_NEG_INF;
        float* raw_t = raw + t;
        float* suf_t = suf + t;
        raw_t[slot * bd] = x;
        pmax = slot == 0 ? x : max_nan(pmax, x);
        const int rm = rr - r;  // the row whose column max this is
        if (rm >= Y0 && rm < Y1) {
          const float mv = slot == win - 1 ? pmax : max_nan(suf_t[(slot + 1) * bd], pmax);
          vm[wr_half * (bd + 2 * r) + r + t] = t < n ? mv : DET_NEG_INF;
          int cs = slot + r + 1;
          if (cs >= win) cs -= win;
          resp_c = raw_t[cs * bd];
        }
        if (slot == win - 1) {  // a block complete: its suffix maxima
          float m = x;
          suf_t[slot * bd] = m;
#pragma unroll 4
          for (int j = win - 2; j >= 0; --j) {
            m = max_nan(raw_t[j * bd], m);
            suf_t[j * bd] = m;
          }
        }
      }

      // 2. row rp: the Scharr column passes, the products, the box row pass of row rp - 2
      {
        const float* rs = rsrd + rd_half * 2 * bd;
        const float* rd = rs + bd;
        const float gx = diff3(rs[nb[1]], rs[nb[3]]);
        const float gy = smooth3(rd[nb[1]], rd[nb[2]], rd[nb[3]]);
        const float p[3] = {__fmul_rn(gx, gx), __fmul_rn(gy, gy), __fmul_rn(gx, gy)};
        const int rp = Y0 - h - 2 + s;
#pragma unroll
        for (int a = 0; a < 3; ++a) {
          if (rp == 0) {  // the top edge: rows -4..0 are row 0
            q[0][a] = q[1][a] = q[2][a] = q[3][a] = q[4][a] = p[a];
          } else {  // below the bottom edge, row H-1 again
            const float nw = rp >= H ? q[4][a] : p[a];
            q[0][a] = q[1][a];
            q[1][a] = q[2][a];
            q[2][a] = q[3][a];
            q[3][a] = q[4][a];
            q[4][a] = nw;
          }
          vs[(wr_half * 3 + a) * bd + t] = box5(q[0][a], q[1][a], q[2][a], q[3][a], q[4][a]);
        }
      }

      // 1. image row Y0 - h + s: the Scharr row passes of the row above it
      w0 = w1;
      w1 = w2;
      w2 = row;
      rsrd[wr_half * 2 * bd + t] = smooth3(w0, w1, w2);
      rsrd[(wr_half * 2 + 1) * bd + t] = diff3(w0, w2);

      __syncthreads();
      if (++slot == win) slot = 0;
    }
  }

  // the grid's padding inside this cell: 0.0 candidates at their own index
  const int nr = max(min(ch, H - Y0), 0);            // rows of the cell inside the image
  const int pc = X0 < W ? max(X0 + cw - W, 0) : cw;  // padding columns of those rows
  const int n_pad = nr * pc + (ch - nr) * cw;
  for (int i = t; i < n_pad; i += bd) {
    int cy, cx;
    if (i < nr * pc) {
      cy = i / pc;
      cx = cw - pc + (i - cy * pc);
    } else {
      const int j = i - nr * pc;
      cy = nr + j / cw;
      cx = j % cw;
    }
    const unsigned long long key = cand_key(0.0f, (unsigned)(cy * cw + cx));
    if (key > thr) thr = list_insert(lst, bd, k, key);
  }

  // the cell's top k: k rounds of a block-wide max over the lists' heads
  // (keys are distinct: one thread holds the max)
  const int lane = t & 31, warp = t >> 5, n_warps = bd >> 5;
  int head = 0;  // this thread's next list entry
  for (int j = 0; j < k; ++j) {
    const unsigned long long mine = head < k ? lst[head * bd] : 0ull;
    unsigned long long m = mine;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(0xffffffffu, m, o);
      m = other > m ? other : m;
    }
    if (lane == 0) red[(j & 1) * DET_MAX_WARPS + warp] = m;
    __syncthreads();
    unsigned long long best = 0ull;
    for (int w = 0; w < n_warps; ++w) {
      const unsigned long long x = red[(j & 1) * DET_MAX_WARPS + w];
      best = x > best ? x : best;
    }
    if (mine == best) ++head;
    if (t == 0) {
      const unsigned o = (unsigned)(best >> 32);
      const unsigned bits = (o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o;
      const unsigned idx = 0xFFFFFFFFu - (unsigned)best;
      const size_t out = (b * n_cells + cell) * (size_t)k + j;
      const int cy = idx / cw, cx = idx - cy * cw;
      scores[out] = __uint_as_float(bits);
      xy[2 * out] = (float)(X0 + cx);
      xy[2 * out + 1] = (float)(Y0 + cy);
    }
  }
}

// Plain C entry point (bound with ctypes); see lk.cu for the conventions.
// img (B, H, W) float32, contiguous on the device, B = n_lanes (1: one
// image); scores (B, grid_rows * grid_cols, k) and xy (B, grid_rows *
// grid_cols, k, 2) float32 written. One launch for all lanes. Refuses
// (cudaErrorInvalidValue) k > 32, cells of fewer than k pixels, a cell and
// its halo wider than 512 columns and more than 65535 lanes.
extern "C" int larvio_detect_corners(const void* img, int n_lanes, int H, int W, int grid_rows,
                                     int grid_cols, int k, int border, int radius, void* scores,
                                     void* xy, void* stream) {
  if (H < 1 || W < 1 || grid_rows < 1 || grid_cols < 1 || k < 1 || k > DET_MAX_K || radius < 0 ||
      n_lanes < 0 || n_lanes > 65535)
    return (int)cudaErrorInvalidValue;
  const int ch = (H + grid_rows - 1) / grid_rows, cw = (W + grid_cols - 1) / grid_cols;
  const int cols = cw + 2 * (3 + radius) < W ? cw + 2 * (3 + radius) : W;
  const int threads = ((cols + 31) / 32) * 32;
  if ((long long)ch * cw < k || threads > DET_MAX_THREADS) return (int)cudaErrorInvalidValue;
  if (n_lanes == 0) return 0;
  const size_t smem = ((size_t)(12 + 2 * (2 * radius + 1)) * threads + 4 * radius) * sizeof(float) +
                      (2 * DET_MAX_WARPS + (size_t)k * threads) * sizeof(unsigned long long);
  const dim3 grid(grid_rows * grid_cols, n_lanes);
  if (smem > 48 * 1024) {  // a wide NMS window or many corners: opt in to more shared memory
    const cudaError_t e =
        cudaFuncSetAttribute(detect_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  detect_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>((const float*)img, H, W, grid_cols,
                                                               ch, cw, k, border, radius,
                                                               (float*)scores, (float*)xy);
  return (int)cudaGetLastError();
}
