// PERMANOVA within-group statistic s_W on Hopper (sm_90a): three kernels.
//
//   s_W[p] = sum_{i < j} mat2[i,j] * 1[g_p[i] == g_p[j]] * w[g_p[i]]
//
// mat2 is the (n, n) element-squared distance matrix (symmetric, zero
// diagonal), groupings the (P, n) int32 permuted labels, w the (G,) inverse
// group sizes. Each kernel writes per-block partial sums; the host wrapper
// (ops.py) reduces them with one deterministic torch.sum. There are no
// floating-point atomics, so two runs give the same bits.
//
// The Pallas kernels these replace accumulate into one output block across
// an in-order TPU grid. CUDA blocks run in no order, so each sequential grid
// axis became a loop inside the block and each cross-tile sum a partial.
// Ragged n and P are masked inside the kernels (nothing is padded), and all
// element offsets are 64-bit (i * n overflows int32 past n = 46,340).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. The C entry points below return
//        cudaGetLastError() after the launch; they launch on the caller's
//        stream and never synchronise.
//
// Bounds below are for the main path's shape on an H100 SXM at 700 W:
// n = 25,145 samples, P = 4,000 permutations, G = 8 groups, 3.35 TB/s HBM,
// 67 TFLOP/s f32 on the CUDA cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Sum of v over the block, in a fixed order; the result is valid in
// thread 0. Every thread of the block must call it.
__device__ float block_sum(float v, float* scratch) {
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) scratch[warp] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0)
    for (int i = 0; i < kWarps; ++i) s += scratch[i];
  return s;
}

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}
__device__ __forceinline__ int64_t max64(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__device__ __forceinline__ float row_weight(int g, const float* w,
                                            int n_groups) {
  return (g >= 0 && g < n_groups) ? w[g] : 0.f;
}

// ---------------------------------------------------------------------------
// brute — replaces kernels/permanova_sw/kernel.py:sw_brute_pallas (paper
// Algorithm 3).
//
// Grid (P, ceil(n / kBruteRows)); block (p, band) sums the strict upper
// triangle of rows [band*32, band*32 + 32) for permutation p. The labels of
// g_p are staged in shared memory a column tile at a time; threads stride
// over the columns j > i of each row (coalesced reads of mat2[i, j]) and add
// mat2[i, j] where the labels match. Each thread's per-row sum is weighted
// by w[g_p[i]]; the block reduces through warp shuffles and shared memory
// and writes partials[p, band].
//
// Bound: Algorithm 3 re-reads the triangle for every permutation,
// P * n(n-1)/2 * 4 B = 5.06 TB, 1.5 s of HBM (3.0 s for the full square, as
// the TPU kernel reads it). The permutation index is the grid's fastest
// axis, so the blocks resident at once are ~1,000 permutations of the same
// band and the band is served from L2: HBM traffic falls to a few passes of
// mat2, and the kernel is bound by L2 reads and instruction issue over the
// 1.3e12 (pair, permutation) updates instead.
// ---------------------------------------------------------------------------

constexpr int kBruteRows = 32;
constexpr int kBruteCols = 2048;

__global__ void __launch_bounds__(kThreads)
sw_brute_kernel(const float* __restrict__ mat2,
                const int* __restrict__ groupings,
                const float* __restrict__ w, float* __restrict__ partials,
                int64_t n, int n_groups) {
  __shared__ int lab[kBruteCols];
  __shared__ int row_lab[kBruteRows];
  __shared__ float row_w[kBruteRows];
  __shared__ float scratch[kWarps];
  const int64_t p = blockIdx.x;
  const int64_t band = blockIdx.y;
  const int64_t r0 = band * kBruteRows;
  const int64_t r1 = min64(r0 + kBruteRows, n);
  const int* g = groupings + p * n;
  if (threadIdx.x < kBruteRows) {
    const int64_t i = r0 + threadIdx.x;
    const int gi = i < n ? g[i] : -1;
    row_lab[threadIdx.x] = gi;
    row_w[threadIdx.x] = row_weight(gi, w, n_groups);
  }
  float acc = 0.f;
  for (int64_t c0 = r0 + 1; c0 < n; c0 += kBruteCols) {
    const int64_t c1 = min64(c0 + kBruteCols, n);
    __syncthreads();  // the previous tile's readers are done
    for (int64_t j = c0 + threadIdx.x; j < c1; j += kThreads)
      lab[j - c0] = g[j];
    __syncthreads();
    for (int64_t i = r0; i < r1; ++i) {
      const int gi = row_lab[i - r0];
      const int64_t js = max64(c0, i + 1);
      const float* mrow = mat2 + i * n;
      float local = 0.f;
      for (int64_t j = js + threadIdx.x; j < c1; j += kThreads)
        if (lab[j - c0] == gi) local += __ldg(mrow + j);
      acc += local * row_w[i - r0];
    }
  }
  const float s = block_sum(acc, scratch);
  if (threadIdx.x == 0) partials[p * gridDim.y + band] = s;
}

// ---------------------------------------------------------------------------
// permblock — replaces kernels/permanova_sw/kernel.py:sw_permblock_pallas
// (the paper's CPU tiling on an on-chip tile).
//
// Grid (ceil(P / kPB), ceil(n / kTile)); block (pb, ti) walks the row
// stripe ti over the upper-triangle tiles tj >= ti. Each 64 x 64 mat2 tile
// is read once into registers (thread t holds column t % 64 of rows
// t / 64 + 4k, k < 16, with the lower triangle and the ragged edge zeroed)
// and applied to kPB = 16 permutations, whose row and column labels sit in
// shared memory. Each block writes partials[p, ti] for its 16 permutations.
//
// Bound: ceil(P / 16) * n^2 * 4 B / 2 (upper tiles) = 0.32 TB, 0.09 s of
// HBM, against 1.3e12 masked (pair, permutation) updates of a compare and
// an FMA each: issue-bound at a similar order. The perm block is the grid's
// fastest axis, so the blocks resident at once share a few row stripes in
// L2.
// ---------------------------------------------------------------------------

constexpr int kPB = 16;
constexpr int kTile = 64;
constexpr int kRowsPerThread = kTile * kTile / kThreads;  // 16

__global__ void __launch_bounds__(kThreads)
sw_permblock_kernel(const float* __restrict__ mat2,
                    const int* __restrict__ groupings,
                    const float* __restrict__ w,
                    float* __restrict__ partials, int64_t n,
                    int64_t n_perms, int n_groups) {
  __shared__ int gr[kPB][kTile];
  __shared__ float wr[kPB][kTile];
  __shared__ int gc[kPB][kTile];
  __shared__ float scratch[kWarps][kPB];
  const int64_t p0 = (int64_t)blockIdx.x * kPB;
  const int64_t ti = blockIdx.y;
  const int64_t n_tiles = gridDim.y;
  const int64_t r0 = ti * kTile;
  const int tid = threadIdx.x;
  const int c = tid % kTile;
  const int rbase = tid / kTile;

  for (int e = tid; e < kPB * kTile; e += kThreads) {
    const int q = e / kTile, r = e % kTile;
    const int64_t p = p0 + q, i = r0 + r;
    int gi = -2;  // pad rows never match a column (pad columns carry -1)
    if (p < n_perms && i < n) gi = groupings[p * n + i];
    gr[q][r] = gi;
    wr[q][r] = row_weight(gi, w, n_groups);
  }

  float acc[kPB];
#pragma unroll
  for (int q = 0; q < kPB; ++q) acc[q] = 0.f;

  for (int64_t tj = ti; tj < n_tiles; ++tj) {
    const int64_t c0 = tj * kTile;
    __syncthreads();  // the previous tile's readers of gc are done
    for (int e = tid; e < kPB * kTile; e += kThreads) {
      const int q = e / kTile, cc = e % kTile;
      const int64_t p = p0 + q, j = c0 + cc;
      gc[q][cc] = (p < n_perms && j < n) ? groupings[p * n + j] : -1;
    }
    float m[kRowsPerThread];
    const int64_t j = c0 + c;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int64_t i = r0 + rbase + 4 * k;
      m[k] = (i < n && j < n && j > i) ? __ldg(mat2 + i * n + j) : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int q = 0; q < kPB; ++q) {
      const int gj = gc[q][c];
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < kRowsPerThread; ++k) {
        const int r = rbase + 4 * k;
        s += (gr[q][r] == gj) ? m[k] * wr[q][r] : 0.f;
      }
      acc[q] += s;
    }
  }

  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int q = 0; q < kPB; ++q) {
    const float v = warp_sum(acc[q]);
    if (lane == 0) scratch[warp][q] = v;
  }
  __syncthreads();
  if (tid < kPB && p0 + tid < n_perms) {
    float s = 0.f;
    for (int k = 0; k < kWarps; ++k) s += scratch[k][tid];
    partials[(p0 + tid) * n_tiles + ti] = s;
  }
}

// ---------------------------------------------------------------------------
// matmul — replaces kernels/permanova_sw/kernel.py:sw_matmul_pallas (the
// one-hot contraction).
//
// Grid (ceil(P / PB), ceil(n / kMR)); block (pb, ti) owns rows
// [ti*64, ti*64 + 64) and permutations [pb*PB, pb*PB + PB), where
// PB = matmul_perm_block(G) fills 128 one-hot columns (16 at G = 8). The PB*G
// columns k = q*G + g of the one-hot factor E[j, k] = sqrt_w[g] *
// 1[g_{p0+q}[j] == g] are taken kMK = 128 at a time. For each such slice
// the block computes Y = mat2[rows, :] . E (CUDA-core f32 FMAs over
// 64 x 32 mat2 tiles and 32 x 128 E tiles in shared memory, each thread a
// 4 x 8 micro-tile, each 32-deep tile summed in registers before it joins
// Y), then dots Y with the row factor E[i, k] and sums per permutation in a
// fixed order. The full i != j square is summed and halved: this is exact
// only because mat2's diagonal is zero. mat2 may be f32 or bf16 (read as
// bf16, accumulated in f32); sqrt_w arrives already rounded to mat2's type.
//
// Bound: the function is the same as brute's, and so is its bound: the
// 1.4e12 compares and adds that s_W needs (a compare per (pair,
// permutation), an add per match) take 0.02 s at 67 TFLOP/s. The one-hot
// form does far more: it reads ceil(P / 16) * n^2 * 4 B = 0.63 TB (0.19 s
// of HBM) and issues 2 n^2 P G = 4.0e13 FLOP (0.60 s at 67 TFLOP/s), so
// on the CUDA cores this design cannot come within 30x of the function's
// bound. The structure (a tile GEMM against a one-hot factor) is kept so a
// later change can move it to bf16 tensor cores (wgmma), where the
// 4.0e13 FLOP take 0.04 s.
// ---------------------------------------------------------------------------

constexpr int kMR = 64;    // rows per block
constexpr int kMC = 32;    // contraction depth per step
constexpr int kMK = 128;   // one-hot columns per slice
constexpr int kMaxPB = kMK;      // PB at G = 1
constexpr int kMaxQ = kMK + 1;   // permutations one 128-column slice spans
constexpr int kMsLd = kMR + 4;   // padded leading dims (float4-aligned)
constexpr int kEsLd = kMK + 4;

struct MatmulTiles {
  float ms[kMC][kMsLd];   // mat2 tile, transposed: ms[c][r]
  float es[kMC][kEsLd];   // one-hot factor tile: es[c][k]
  int lab[kMaxQ][kMC];    // labels of the slice's permutations, this tile
};

// Permutations per block: as many as fill kMK one-hot columns, at least 1.
__host__ __device__ constexpr int matmul_perm_block(int n_groups) {
  return n_groups >= kMK ? 1 : kMK / n_groups;
}

union __align__(16) MatmulSmem {
  MatmulTiles t;
  float contrib[kMR][kMK + 1];  // Y . E_row, per (row, column)
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sw_matmul_kernel(const T* __restrict__ mat2,
                 const int* __restrict__ groupings,
                 const float* __restrict__ sqrt_w,
                 float* __restrict__ partials, int64_t n, int64_t n_perms,
                 int n_groups) {
  __shared__ MatmulSmem sm;
  __shared__ int kq[kMK];      // column k of the slice: permutation - q_lo
  __shared__ int kg[kMK];      //   its group
  __shared__ float kw[kMK];    //   sqrt_w[group], 0 past the last column
  __shared__ float colsum[2][kMK];
  __shared__ float perm_acc[kMaxPB];
  const int perm_block = matmul_perm_block(n_groups);
  const int64_t p0 = (int64_t)blockIdx.x * perm_block;
  const int64_t ti = blockIdx.y;
  const int64_t r0 = ti * kMR;
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;   // rows ty*4.., cols tx*8..
  const int pb_here = (int)min64(perm_block, n_perms - p0);
  const int k_total = pb_here * n_groups;

  for (int q = tid; q < kMaxPB; q += kThreads) perm_acc[q] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += kMK) {
    const int q_lo = k0 / n_groups;
    const int q_hi = min(pb_here - 1, (k0 + kMK - 1) / n_groups);
    const int q_span = q_hi - q_lo + 1;
    __syncthreads();  // the previous slice's readers of kq/kg/kw are done
    for (int k = tid; k < kMK; k += kThreads) {
      const int kk = k0 + k;
      const bool valid = kk < k_total;
      kq[k] = valid ? kk / n_groups - q_lo : 0;
      kg[k] = valid ? kk % n_groups : -1;
      kw[k] = valid ? sqrt_w[kk % n_groups] : 0.f;
    }
    float y[4][8];
#pragma unroll
    for (int v = 0; v < 4; ++v)
#pragma unroll
      for (int u = 0; u < 8; ++u) y[v][u] = 0.f;

    for (int64_t c0 = 0; c0 < n; c0 += kMC) {
      __syncthreads();  // the previous step's readers are done
      // mat2[r0 + r, c0 + c] -> ms[c][r]; a warp reads 32 columns of a row
      for (int e = tid; e < kMR * kMC; e += kThreads) {
        const int c = e % kMC, r = e / kMC;
        const int64_t i = r0 + r, j = c0 + c;
        sm.t.ms[c][r] = (i < n && j < n) ? to_float(mat2[i * n + j]) : 0.f;
      }
      // the slice's labels for columns c0.. (a warp reads 32 in a row)
      for (int e = tid; e < q_span * kMC; e += kThreads) {
        const int q = e / kMC, c = e % kMC;
        const int64_t j = c0 + c;
        sm.t.lab[q][c] = j < n ? groupings[(p0 + q_lo + q) * n + j] : -1;
      }
      __syncthreads();
      // E[c0 + c, k0 + k] = kw[k] where the label is column k's group
      for (int e = tid; e < kMC * kMK; e += kThreads) {
        const int c = e % kMC, k = e / kMC;
        sm.t.es[c][k] = sm.t.lab[kq[k]][c] == kg[k] ? kw[k] : 0.f;
      }
      __syncthreads();
      float t[4][8];
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int u = 0; u < 8; ++u) t[v][u] = 0.f;
#pragma unroll 8
      for (int c = 0; c < kMC; ++c) {
        const float4 a = *reinterpret_cast<const float4*>(&sm.t.ms[c][ty * 4]);
        const float4 b0 =
            *reinterpret_cast<const float4*>(&sm.t.es[c][tx * 8]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&sm.t.es[c][tx * 8 + 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int v = 0; v < 4; ++v)
#pragma unroll
          for (int u = 0; u < 8; ++u) t[v][u] = fmaf(av[v], bv[u], t[v][u]);
      }
#pragma unroll
      for (int v = 0; v < 4; ++v)
#pragma unroll
        for (int u = 0; u < 8; ++u) y[v][u] += t[v][u];
    }

    // Y . E_row for this thread's 4 x 8 outputs.
    __syncthreads();  // the tiles are dead; contrib reuses their memory
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int r = ty * 4 + v;
      const int64_t i = r0 + r;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int k = tx * 8 + u;
        float e_row = 0.f;
        if (i < n && groupings[(p0 + q_lo + kq[k]) * n + i] == kg[k])
          e_row = kw[k];
        sm.contrib[r][k] = y[v][u] * e_row;
      }
    }
    __syncthreads();
    {  // column sums over the 64 rows, two halves of 32
      const int k = tid % kMK, h = tid / kMK;
      float s = 0.f;
      for (int r = h * 32; r < h * 32 + 32; ++r) s += sm.contrib[r][k];
      colsum[h][k] = s;
    }
    __syncthreads();
    // each permutation of this slice adds its G columns, in order
    for (int q = q_lo + tid; q <= q_hi; q += kThreads) {
      const int k_begin = max(q * n_groups, k0) - k0;
      const int k_end = min((q + 1) * n_groups, k0 + kMK) - k0;
      float s = 0.f;
      for (int k = k_begin; k < k_end; ++k) s += colsum[0][k] + colsum[1][k];
      perm_acc[q] += s;
    }
  }
  __syncthreads();
  for (int q = tid; q < pb_here; q += kThreads)
    partials[(p0 + q) * gridDim.y + ti] = 0.5f * perm_acc[q];
}

}  // namespace

extern "C" {

// Tile constants the host needs to size the partials:
// [brute rows per band, permblock perms per block, permblock tile,
//  matmul rows per block, matmul max perms per block].
void sw_kernel_config(int* out) {
  out[0] = kBruteRows;
  out[1] = kPB;
  out[2] = kTile;
  out[3] = kMR;
  out[4] = kMaxPB;
}

// partials: (P, ceil(n / 32)) f32.
int sw_brute_launch(const void* mat2, const void* groupings, const void* w,
                    void* partials, long long n, long long n_perms,
                    int n_groups, void* stream) {
  const dim3 grid((unsigned)n_perms,
                  (unsigned)((n + kBruteRows - 1) / kBruteRows));
  sw_brute_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)mat2, (const int*)groupings, (const float*)w,
      (float*)partials, n, n_groups);
  return (int)cudaGetLastError();
}

// partials: (P, ceil(n / 64)) f32.
int sw_permblock_launch(const void* mat2, const void* groupings,
                        const void* w, void* partials, long long n,
                        long long n_perms, int n_groups, void* stream) {
  const dim3 grid((unsigned)((n_perms + kPB - 1) / kPB),
                  (unsigned)((n + kTile - 1) / kTile));
  sw_permblock_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)mat2, (const int*)groupings, (const float*)w,
      (float*)partials, n, n_perms, n_groups);
  return (int)cudaGetLastError();
}

// partials: (P, ceil(n / 64)) f32. is_bf16 selects the mat2 element type;
// sqrt_w is f32, already rounded to mat2's type.
int sw_matmul_launch(const void* mat2, const void* groupings,
                     const void* sqrt_w, void* partials, long long n,
                     long long n_perms, int n_groups, int is_bf16,
                     void* stream) {
  if (n_groups < 1) return (int)cudaErrorInvalidValue;
  const int perm_block = matmul_perm_block(n_groups);
  const dim3 grid((unsigned)((n_perms + perm_block - 1) / perm_block),
                  (unsigned)((n + kMR - 1) / kMR));
  if (is_bf16)
    sw_matmul_kernel<__nv_bfloat16><<<grid, kThreads, 0,
                                      (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)mat2, (const int*)groupings,
        (const float*)sqrt_w, (float*)partials, n, n_perms, n_groups);
  else
    sw_matmul_kernel<float><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const float*)mat2, (const int*)groupings, (const float*)sqrt_w,
        (float*)partials, n, n_perms, n_groups);
  return (int)cudaGetLastError();
}

}  // extern "C"
