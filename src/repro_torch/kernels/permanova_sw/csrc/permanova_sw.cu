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

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// 4-byte asynchronous copy global -> shared; src_bytes < 4 zero-fills the
// rest (0: the destination becomes 0 and nothing is read).
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}
__device__ __forceinline__ float row_weight(int g, const float* w,
                                            int n_groups) {
  return (g >= 0 && g < n_groups) ? w[g] : 0.f;
}

// ---------------------------------------------------------------------------
// brute — replaces kernels/permanova_sw/kernel.py:sw_brute_pallas (paper
// Algorithm 3: a same-group test on every (pair, permutation), w[g_p[i]]
// applied per row; no one-hot product and no tensor cores).
//
// What bounds it. The TPU kernel re-reads the triangle for every
// permutation, P * n(n-1)/2 * 4 B = 3.37 TB at P = 2,668; the first port
// (one block a permutation) took those reads from L2 at ~6.5 TB/s, one
// compare and add per 4-byte L2 read (519 ms on an H100 SXM at 700 W).
// Here a block applies each mat2 element it stages to kBrutePerms = 128
// permutations, so L2 serves 4 / 128 B of mat2 and (4 / 64 B of labels)
// per (pair, permutation), 21x less, and the kernel is bound by its
// instruction rate: an integer compare and a predicated add per (pair,
// permutation). That floor is the compare on the INT32 pipe, 8.43e11
// updates at P = 2,668 over 132 SMs x 64 lanes x 1.98 GHz, ~50 ms (the
// function's operations bound at the f32 rate is 14.2 ms).
//
// Grid (ceil(P / 128), ceil(n / 64)), the permutation block fastest, so the
// blocks resident at once share a band of mat2 in L2. Block (pb, band) owns
// rows [band*64, band*64 + 64) and permutations [pb*128, pb*128 + 128) and
// walks the column tiles tb >= band of its band: only tiles on or above the
// diagonal are visited. Each 64 x 64 mat2 tile and the 128 x 64 labels of
// its columns go through a two-stage cp.async ring in dynamic shared memory
// (4-byte copies: n need not be a multiple of 4); pairs with j <= i, j >= n
// or i >= n are zero-filled as they are copied, so the diagonal tile adds
// only j > i and nothing past n is read. Warp w owns 8 rows, lane l the
// permutations l + 32k (k < 4): their row labels sit in registers, and so
// does one accumulator per (row, permutation). Per 4 columns a lane reads
// its 4 permutations' labels (one int4 each; rows of 68 ints keep a
// quarter-warp's 16-byte reads on distinct banks) and each of its rows'
// mat2 values (one float4, the same address across the warp), then does
// `if (g_r == g_c) acc += m`, an ISETP and a predicated FADD, 128 times.
// Labels stay int32 in shared memory: one int4 read gives four of them with
// no byte extraction in the inner loop, and any G the reference accepts
// runs. At the end each accumulator is weighted once by w[g_r], the 8 warps'
// sums are added in a fixed order and one partial per (permutation, band)
// is written; the wrapper sums the partials with torch.sum. No atomics.
// ---------------------------------------------------------------------------

constexpr int kBruteRows = 64;      // rows per band (per block)
constexpr int kBruteCols = 64;      // columns per staged tile
constexpr int kBrutePerms = 128;    // permutations per block
constexpr int kBruteWarpRows = kBruteRows / kWarps;    // 8 rows a warp
constexpr int kBruteLanePerms = kBrutePerms / 32;      // 4 a lane
constexpr int kBruteLabLd = kBruteCols + 4;            // a label row: 68
constexpr int kBruteTileFloats = kBruteRows * kBruteCols;
constexpr int kBruteStageBytes =
    (kBruteTileFloats + kBrutePerms * kBruteLabLd) * 4;
constexpr int kBruteSmemBytes = 2 * kBruteStageBytes;  // 102,400
static_assert(kBruteCols % 4 == 0 && kBruteRows % kWarps == 0 &&
              kBrutePerms % 32 == 0, "whole vectors, warps and lanes");

// Start the copies of the mat2 tile of rows r0.. and columns c0.. into
// shared memory, zero where j <= i, i >= row_end or j >= n (so a diagonal
// tile adds only j > i and nothing past the slab or n is read). mat2
// points at global row row_base (pitch n): 0 for a whole matrix, the
// slab's first row for brute's row-slab entry. Both kernels below.
__device__ __forceinline__ void load_mat2_tile(
    float* ms, const float* __restrict__ mat2, int64_t n, int64_t r0,
    int64_t c0, int64_t row_base, int64_t row_end) {
  for (int e = threadIdx.x; e < kBruteTileFloats; e += kThreads) {
    const int r = e / kBruteCols, c = e % kBruteCols;
    const int64_t i = r0 + r, j = c0 + c;
    const bool ok = i < row_end && j < n && j > i;
    cp_async4(ms + e, ok ? (const void*)(mat2 + (i - row_base) * n + j)
                         : (const void*)mat2, ok ? 4 : 0);
  }
}

// Start the copies of the labels of permutations p0.. at columns c0..
// (rows of kBruteLabLd ints; zero past P or n).
__device__ __forceinline__ void load_col_labels(
    int* lab, const int* __restrict__ groupings, int64_t n, int64_t n_perms,
    int64_t c0, int64_t p0) {
  for (int e = threadIdx.x; e < kBrutePerms * kBruteCols; e += kThreads) {
    const int q = e / kBruteCols, c = e % kBruteCols;
    const int64_t p = p0 + q, j = c0 + c;
    const bool ok = p < n_perms && j < n;
    cp_async4(lab + q * kBruteLabLd + c,
              ok ? (const void*)(groupings + p * n + j)
                 : (const void*)groupings, ok ? 4 : 0);
  }
}

// One staged tile applied to 128 permutations: ms points at the warp's 8
// rows of the tile, lab at the labels of the lane's first permutation;
// gr and acc hold the row labels and accumulators of (row, permutation
// lane + 32k). Both kernels below.
__device__ __forceinline__ void apply_tile(
    const float* ms, const int* lab,
    const int (&gr)[kBruteWarpRows][kBruteLanePerms],
    float (&acc)[kBruteWarpRows][kBruteLanePerms]) {
#pragma unroll 2
  for (int c = 0; c < kBruteCols; c += 4) {
    int4 gc[kBruteLanePerms];
#pragma unroll
    for (int k = 0; k < kBruteLanePerms; ++k)
      gc[k] = *reinterpret_cast<const int4*>(lab + 32 * k * kBruteLabLd +
                                             c);
#pragma unroll
    for (int r = 0; r < kBruteWarpRows; ++r) {
      const float4 m =
          *reinterpret_cast<const float4*>(ms + r * kBruteCols + c);
#pragma unroll
      for (int k = 0; k < kBruteLanePerms; ++k) {
        const int g = gr[r][k];
        if (g == gc[k].x) acc[r][k] += m.x;
        if (g == gc[k].y) acc[r][k] += m.y;
        if (g == gc[k].z) acc[r][k] += m.z;
        if (g == gc[k].w) acc[r][k] += m.w;
      }
    }
  }
}

// mat2 holds global rows [row_offset, row_end) with pitch n (the whole
// matrix: row_offset 0, row_end n); row_offset is a multiple of 64, so
// block y runs global band row_offset / 64 + y, from its diagonal tile,
// exactly as the whole-matrix launch runs that band, and writes partial
// column y: a slab's partials are the whole launch's columns of its bands,
// bit for bit.
__global__ void __launch_bounds__(kThreads, 2)
sw_brute_kernel(const float* __restrict__ mat2,
                const int* __restrict__ groupings,
                const float* __restrict__ w, float* __restrict__ partials,
                int64_t n, int64_t n_perms, int n_groups,
                int64_t row_offset, int64_t row_end) {
  extern __shared__ __align__(16) unsigned char brute_smem[];
  __shared__ float red[kWarps][kBrutePerms];
  const int64_t p0 = (int64_t)blockIdx.x * kBrutePerms;
  const int64_t band = row_offset / kBruteRows + blockIdx.y;
  const int64_t r0 = band * kBruteRows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rw = warp * kBruteWarpRows;   // the warp's first row in the band

  // row labels of (row rw + r, permutation lane + 32k); -1 past n or P
  int gr[kBruteWarpRows][kBruteLanePerms];
  float acc[kBruteWarpRows][kBruteLanePerms];
#pragma unroll
  for (int r = 0; r < kBruteWarpRows; ++r)
#pragma unroll
    for (int k = 0; k < kBruteLanePerms; ++k) {
      const int64_t i = r0 + rw + r, p = p0 + lane + 32 * k;
      gr[r][k] = i < n && p < n_perms ? groupings[p * n + i] : -1;
      acc[r][k] = 0.f;
    }

  const int64_t n_tiles = (n + kBruteCols - 1) / kBruteCols - band;
  auto stage_ms = [&](int64_t t) {
    return reinterpret_cast<float*>(brute_smem + (t & 1) * kBruteStageBytes);
  };
  load_mat2_tile(stage_ms(0), mat2, n, r0, band * kBruteCols, row_offset,
                 row_end);
  load_col_labels(reinterpret_cast<int*>(stage_ms(0) + kBruteTileFloats),
                  groupings, n, n_perms, band * kBruteCols, p0);
  cp_async_commit();
  for (int64_t t = 0; t < n_tiles; ++t) {
    cp_async_wait<0>();
    __syncthreads();   // tile t has landed; stage t + 1's readers are done
    if (t + 1 < n_tiles) {
      float* nxt = stage_ms(t + 1);
      load_mat2_tile(nxt, mat2, n, r0, (band + t + 1) * kBruteCols,
                     row_offset, row_end);
      load_col_labels(reinterpret_cast<int*>(nxt + kBruteTileFloats),
                      groupings, n, n_perms, (band + t + 1) * kBruteCols,
                      p0);
    }
    cp_async_commit();
    apply_tile(stage_ms(t) + rw * kBruteCols,
               reinterpret_cast<const int*>(stage_ms(t) + kBruteTileFloats) +
                   lane * kBruteLabLd,
               gr, acc);
  }
  cp_async_wait<0>();

  // w[g_r] once per (row, permutation), then the warps in a fixed order
#pragma unroll
  for (int k = 0; k < kBruteLanePerms; ++k) {
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kBruteWarpRows; ++r)
      s = fmaf(acc[r][k], row_weight(gr[r][k], w, n_groups), s);
    red[warp][lane + 32 * k] = s;
  }
  __syncthreads();
  const int64_t p = p0 + threadIdx.x;
  if (threadIdx.x < kBrutePerms && p < n_perms) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) s += red[k][threadIdx.x];
    partials[p * gridDim.y + blockIdx.y] = s;
  }
}

// ---------------------------------------------------------------------------
// permblock — replaces kernels/permanova_sw/kernel.py:sw_permblock_pallas
// (the paper's Algorithm 2: one cache-resident mat2 tile serves a block of
// permutations), here with the tile in shared memory and EVERY permutation
// of the launch as its block.
//
// Brute's grid is (permutation block, band): it streams the triangle from
// L2 once per 128 permutations. Here a block owns a 64-row band ti, a strip
// of kPbStripTiles = 16 column tiles j >= ti (the strips that start at the
// diagonal and every 16 tiles after it, numbered strip offset first, as
// fused_sw.cu's symmetric visit) and every permutation, so each mat2 tile
// of the upper triangle is read from HBM once and staged once. Per tile,
// passes of 128 permutations run brute's pattern (apply_tile): the pass's
// column labels come through a two-stage cp.async ring, the row labels and
// one accumulator per (row, permutation) sit in registers, `if (g_r ==
// g_c) acc += m`; w[g_r] is applied once per (row, permutation) a pass and
// one fixed-order reduction per (tile, pass) adds the 8 warps' sums into
// the block's running s_W, kept in its own partial row (one value per
// (block, permutation), read and rewritten by the same thread). The
// wrapper sums the (blocks, P) partials with one torch.sum over the
// blocks. No atomics.
//
// What bounds it: the same compare-and-add as brute, P n(n-1)/2 INT32
// compares, 18.9 ms at P = 1,000 and n = 25,145 over 132 SMs x 64 lanes
// at 1.98 GHz; mat2 crosses HBM once (1.26 GB, 0.38 ms). Unlike brute it
// reloads the pass's row labels for every tile: 32 loads a thread whose
// lanes hit 32 rows of the label array, served by L1. So the tile is
// staged once, in one buffer (its copies start when the previous tile's
// last pass is done, one exposed copy per n_pass passes): 90,112 bytes of
// shared memory, two blocks an SM, leave L1 room for those rows. A second
// tile buffer (106,496 bytes) made the kernel slower on the card;
// staging 2 or 4 tiles a pass, which halves or quarters the reloads, did
// not beat one.
// ---------------------------------------------------------------------------

constexpr int kPbStripTiles = 16;   // column tiles a block walks
constexpr int kPbPass = kBrutePerms;   // permutations a pass (128)
constexpr int kPbLabStage = kPbPass * kBruteLabLd;   // ints a label stage
constexpr int kPbSmemBytes =
    (kBruteTileFloats + 2 * kPbLabStage + kWarps * kPbPass) * 4;
static_assert(kPbSmemBytes == 90112, "one mat2 tile, two label stages");
static_assert(kThreads >= kPbPass, "a thread sums a permutation");

// A block's (band, first column tile): blocks are the strips of
// kPbStripTiles column tiles that start at the diagonal and every
// kPbStripTiles tiles after it, strip offset first (c = 0 for every band,
// then c = 1, ...).
struct PbBlock {
  int64_t ti, jt0;
};

__host__ __device__ inline int64_t pb_blocks(int64_t nt) {
  int64_t total = 0;
  for (int64_t c = 0; c * kPbStripTiles < nt; ++c)
    total += nt - c * kPbStripTiles;
  return total;
}

__device__ __forceinline__ PbBlock pb_block(int64_t b, int64_t nt) {
  int64_t c = 0;
  while (b >= nt - c * kPbStripTiles) {
    b -= nt - c * kPbStripTiles;
    ++c;
  }
  return {b, b + c * kPbStripTiles};
}

// Grid: pb_blocks(ceil(n / 64)) blocks of 256 threads. Step s = t * n_pass
// + q (tile t of the strip, pass q) takes its column labels from label
// stage s % 2, copied during step s - 1. partials: (blocks, P).
__global__ void __launch_bounds__(kThreads, 2)
sw_permblock_kernel(const float* __restrict__ mat2,
                    const int* __restrict__ groupings,
                    const float* __restrict__ w,
                    float* __restrict__ partials, int64_t n,
                    int64_t n_perms, int n_groups) {
  extern __shared__ __align__(16) unsigned char pb_smem[];
  float* tile = reinterpret_cast<float*>(pb_smem);         // [64 * 64]
  int* labs = reinterpret_cast<int*>(tile + kBruteTileFloats);
  float* red = reinterpret_cast<float*>(labs + 2 * kPbLabStage);
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int rw = warp * kBruteWarpRows;   // the warp's first row in the band
  const int64_t nt = (n + kBruteCols - 1) / kBruteCols;
  const PbBlock blk = pb_block(blockIdx.x, nt);
  const int n_t = (int)min64(kPbStripTiles, nt - blk.jt0);
  const int64_t r0 = blk.ti * kBruteRows;
  const int64_t n_pass = (n_perms + kPbPass - 1) / kPbPass;
  float* __restrict__ out = partials + (int64_t)blockIdx.x * n_perms;

  load_mat2_tile(tile, mat2, n, r0, blk.jt0 * kBruteCols, 0, n);
  load_col_labels(labs, groupings, n, n_perms, blk.jt0 * kBruteCols, 0);
  cp_async_commit();
  int64_t s = 0;
  for (int t = 0; t < n_t; ++t) {
    const int64_t c0 = (blk.jt0 + t) * kBruteCols;
    if (t > 0) {   // tile t - 1's readers passed its last reduction barrier
      load_mat2_tile(tile, mat2, n, r0, c0, 0, n);
      cp_async_commit();
    }
    for (int64_t q = 0; q < n_pass; ++q, ++s) {
      const int64_t p0 = q * kPbPass;
      // row labels of (row rw + r, permutation p0 + lane + 32k); -1 past
      // n or P
      int gr[kBruteWarpRows][kBruteLanePerms];
      float acc[kBruteWarpRows][kBruteLanePerms];
#pragma unroll
      for (int k = 0; k < kBruteLanePerms; ++k) {
        const int64_t p = p0 + lane + 32 * k;
        const int* src = groupings + p * n + r0 + rw;
#pragma unroll
        for (int r = 0; r < kBruteWarpRows; ++r) {
          gr[r][k] = p < n_perms && r0 + rw + r < n ? __ldg(src + r) : -1;
          acc[r][k] = 0.f;
        }
      }
      cp_async_wait<0>();
      __syncthreads();   // step s's labels (and tile t) have landed; step
                         // s - 1's readers are done
      // the next step's labels: this tile's next pass, else the next
      // tile's first
      if (q + 1 < n_pass)
        load_col_labels(labs + ((s + 1) & 1) * kPbLabStage, groupings, n,
                        n_perms, c0, p0 + kPbPass);
      else if (t + 1 < n_t)
        load_col_labels(labs + ((s + 1) & 1) * kPbLabStage, groupings, n,
                        n_perms, c0 + kBruteCols, 0);
      cp_async_commit();
      apply_tile(tile + rw * kBruteCols,
                 labs + (s & 1) * kPbLabStage + lane * kBruteLabLd, gr, acc);

      // w[g_r] once per (row, permutation), then the warps in a fixed
      // order into the block's running s_W
#pragma unroll
      for (int k = 0; k < kBruteLanePerms; ++k) {
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < kBruteWarpRows; ++r)
          v = fmaf(acc[r][k], row_weight(gr[r][k], w, n_groups), v);
        red[warp * kPbPass + lane + 32 * k] = v;
      }
      __syncthreads();
      const int64_t p = p0 + tid;
      if (tid < kPbPass && p < n_perms) {
        float v = 0.f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) v += red[k * kPbPass + tid];
        out[p] = (t == 0 ? 0.f : out[p]) + v;
      }
    }
  }
  cp_async_wait<0>();
}

// ---------------------------------------------------------------------------
// matmul — replaces kernels/permanova_sw/kernel.py:sw_matmul_pallas (the
// one-hot contraction), on Hopper's tensor cores with wgmma.
//
// The product. With the factor EXACTLY one-hot, E[c, (q, g)] =
// 1[l_q(c) == g], the block computes Y[r, (q, g)] = sum_c mat2[r, c] E[c,
// (q, g)] and then adds Y[r, (q, g)] * w_g * 1[l_q(r) == g], w_g = sw_g^2
// with sw = sqrt(w) already rounded to mat2's type (what the reference
// multiplies in on both sides). Taking the weights after the product
// instead of inside the factor reorders two roundings: s_W moves by ~1e-7
// relative.
//
// Exactness. 0 and 1 are exact in TF32 and in bf16, and a tensor core's
// products are exact. f32 mat2 is split as it is read into fragments:
// hi = tf32(x) and lo = tf32(x - hi) (cvt.rna.tf32.f32; x - hi is exact in
// f32), and hi.E + lo.E carries ~22 bits of every entry (one TF32 product
// keeps 11, which the f32 bars reject). 3xTF32 would add hi.E_lo with
// E_lo = E - tf32(E); E has no low part (E_lo = 0 identically), so that
// product vanishes and two products are as exact as three. bf16 mat2 is
// one bf16 product, exact against 0/1 with f32 accumulation. A tensor
// core aligns and truncates as it accumulates, so a long sum kept in its
// accumulator would drift low; the products of kTf32Flush k-steps (or
// kBf16Flush) go into a fresh accumulator (scale-d 0) and join the
// block's f32 sums with a rounded add. A deeper chain leaves s_W lower on
// average against an fp64 oracle; two k-steps a flush keep that drift
// well inside the f32 bars, one k-step a flush costs time.
//
// Tiles. Grid (ceil(P / PB), ceil(n / kMR)), the perm block fastest, so the
// blocks resident at once share a row band of mat2 and read it from L2.
// Block (pb, ti) owns rows [ti*64, ti*64 + 64) and permutations
// [pb*PB, pb*PB + PB), PB = matmul_perm_block(G) filling kMN = 256 one-hot
// columns (32 at G = 8; 128 at most, so G = 1 fills half; for G > 256 the
// columns go in slices of 256). kMN / 128 warpgroups each own 128 of the
// columns: per k-step one wgmma m64n128k8 (tf32) or m64n128k16 (bf16), A
// (the 64 rows of mat2) from registers, each warp's 16 rows split into
// hi / lo as they are loaded, B (the 0/1 factor) from shared memory: a
// K-major tile built once a stage for the whole block from the staged
// labels (`label == g ? 1 : 0`), while the tensor cores run the previous
// stage's products.
//
// Copies. A kStages = 4 ring of stages in dynamic shared memory, each a
// 64 x 32 mat2 tile and the PB x 32 labels of the same columns, filled by
// cp.async (4-byte copies: n need not be a multiple of 4, so rows are not
// 16-byte aligned; bf16 rows are copied as the aligned 4-byte words that
// cover them, starting one element early on rows whose offset is odd).
// The next stages' loads are in flight while this one's products run.
// Copies past the matrix (rows or columns >= n) are zero-filled, so they
// add exact zeros whatever label the zero-filled label words give.
//
// Epilogue. The block's Y . (w 1[l(r) == g]) contributions go through
// shared memory (the B tiles' and the ring's space) and are summed per
// column over the 64 rows, then per permutation over its G columns, in a
// fixed order into partials[p, ti]; the wrapper reduces the partials with
// one torch.sum. No atomics. The full i != j square is summed and halved:
// exact only because mat2's diagonal is zero (the wrapper's precondition).
//
// Bound: the function is brute's, and so is its bound (1.4e12 compares and
// adds at P = 4,000, 0.02 s at 67 TFLOP/s). The one-hot form does 2 n^2 P
// G FLOP (1.01e13 at P = 1,000, G = 8; 4.0e13 at the whole EMP test's P =
// 4,000): on f32 mat2 two TF32 products of it, 2.02e13 FLOP, 41 ms at 495
// TFLOP/s; on bf16 one, 10 ms at 989 TFLOP/s; and ceil(P / 32) passes over
// mat2, at most 81 GB (24 ms at 3.35 TB/s) when L2 serves none of them.
// ---------------------------------------------------------------------------

constexpr int kMR = 64;     // rows per block
constexpr int kMN = 256;    // one-hot columns per slice
constexpr int kMK = 32;     // contraction depth per stage
constexpr int kStages = 4;  // cp.async ring depth
constexpr int kMaxPB = 128;           // PB at G = 1 (the ring's label rows)
constexpr int kMsLd = kMK + 4;        // f32 tile row: 36 floats
constexpr int kHWords = kMK / 2 + 1;  // bf16 tile row: 17 words copied
constexpr int kHLd = 20;              //   in a row of 20 words
constexpr int kLabLd = kMK + 4;       // label row: 36 ints
// The B tile of a stage: K-major, 8 x 16-byte core matrices, the two
// along k kLbo apart, 8-column groups kSbo apart; a k-step's 256 columns
// take kBStep bytes (each warpgroup's 128 half of them).
constexpr int kLbo = 128, kSbo = 256, kBStep = kMN / 8 * kSbo;
// k-steps whose products a fresh accumulator sums before they join the
// block's f32 sums (see Exactness): 2 m64n128k8 steps (4 TF32 products:
// hi, lo, hi, lo), 2 m64n128k16 bf16 steps
constexpr int kTf32Flush = 2;
constexpr int kBf16Flush = 2;
constexpr int kMatmulMinBlocks = 1;   // resident blocks an SM (registers)
// one warpgroup (its m64n128 wgmma) per 128 columns; a thread builds one B
// column and sums one column in the epilogue
constexpr int kMatmulThreads = kMN;
static_assert(kMN % 128 == 0, "whole warpgroups");
static_assert(kMK % (8 * kTf32Flush) == 0 && kMK % (16 * kBf16Flush) == 0,
              "whole flush chains a stage");

// Permutations per block: as many as fill kMN one-hot columns, at least 1
// and at most kMaxPB.
__host__ __device__ constexpr int matmul_perm_block(int n_groups) {
  return n_groups >= kMN ? 1 : (kMN / n_groups < kMaxPB ? kMN / n_groups
                                                        : kMaxPB);
}

template <typename T> struct MatmulTile;
template <> struct MatmulTile<float> {
  static constexpr int kBytes = kMR * kMsLd * 4;
  static constexpr int kBBytes = kMN * kMK * 4;   // a stage's B tile
};
template <> struct MatmulTile<__nv_bfloat16> {
  static constexpr int kBytes = kMR * kHLd * 4;
  static constexpr int kBBytes = kMN * kMK * 2;
};

__host__ __device__ constexpr int matmul_stage_bytes(int tile_bytes,
                                                     int perm_block) {
  return tile_bytes + perm_block * kLabLd * 4;
}

constexpr int kContribBytes = kMR * (kMN + 1) * 4;

// Dynamic shared memory: two B tiles, then the ring; the epilogue's
// contributions reuse it from the start.
template <typename T>
__host__ __device__ constexpr int matmul_smem_bytes(int perm_block) {
  return 2 * MatmulTile<T>::kBBytes +
                     kStages * matmul_stage_bytes(MatmulTile<T>::kBytes,
                                                  perm_block) >
                 kContribBytes
             ? 2 * MatmulTile<T>::kBBytes +
                   kStages * matmul_stage_bytes(MatmulTile<T>::kBytes,
                                                perm_block)
             : kContribBytes;
}

// Shared-memory stores of this thread become visible to the tensor cores'
// (async proxy) reads of the B tile.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// x rounded to TF32, round to nearest with ties away (a .b32 pattern whose
// low 13 bits are zero).
__device__ __forceinline__ uint32_t tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// A B-tile descriptor: no swizzle, the start address and the core
// matrices' strides in 16-byte units.
__device__ __forceinline__ uint64_t b_desc(const void* tile) {
  const uint64_t a = (uint64_t)__cvta_generic_to_shared(tile);
  return ((a & 0x3FFFF) >> 4) | ((uint64_t)(kLbo >> 4) << 16) |
         ((uint64_t)(kSbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until this warpgroup's committed wgmma groups are done.
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// The accumulator registers are read and written here, so the compiler
// keeps their other uses on the right side of the wgmma and its wait.
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= a . B: m64n128k8, tf32 A from registers (4 a thread), B from
// shared memory; scale_d 0 starts a fresh sum, 1 adds to d.
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}
// d (+)= a . B: m64n128k16, bf16 A from registers, K-major bf16 B.
__device__ __forceinline__ void wgmma_bf16(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Issue the copies of contraction tile t (columns c0 = t * kMK ..) into
// ring stage `st`: the mat2 tile of rows r0.. and the labels of the
// slice's permutations q_row0 + [0, q_span).
template <typename T>
__device__ __forceinline__ void matmul_load_tile(
    unsigned char* st, const T* __restrict__ mat2,
    const int* __restrict__ groupings, int64_t n, int64_t r0, int64_t c0,
    int64_t q_row0, int q_span) {
  const int tid = threadIdx.x;
  if constexpr (sizeof(T) == 4) {
    float* ms = reinterpret_cast<float*>(st);
    for (int e = tid; e < kMR * kMK; e += kMatmulThreads) {
      const int r = e / kMK, c = e % kMK;
      const int64_t i = r0 + r, j = c0 + c;
      const bool ok = i < n && j < n;
      cp_async4(ms + r * kMsLd + c, ok ? (const void*)(mat2 + i * n + j)
                                       : (const void*)mat2, ok ? 4 : 0);
    }
  } else {
    // a row's 32 bf16 values start at element i*n + c0; its words start at
    // the even element at or before that (shift 1 on odd offsets)
    uint32_t* mw = reinterpret_cast<uint32_t*>(st);
    const unsigned short* m16 = reinterpret_cast<const unsigned short*>(mat2);
    for (int e = tid; e < kMR * kHWords; e += kMatmulThreads) {
      const int r = e / kHWords, w = e % kHWords;
      const int64_t i = r0 + r;
      const int64_t shift = (i * n + c0) & 1;
      const int64_t col = c0 - shift + 2 * w;   // column of the low half
      int bytes = 0;
      if (i < n && col < n) bytes = col + 1 < n ? 4 : 2;
      cp_async4(mw + r * kHLd + w,
                bytes ? (const void*)(m16 + i * n + col) : (const void*)m16,
                bytes);
    }
  }
  int* lab = reinterpret_cast<int*>(st + MatmulTile<T>::kBytes);
  for (int e = tid; e < q_span * kMK; e += kMatmulThreads) {
    const int q = e / kMK, c = e % kMK;
    const int64_t j = c0 + c;
    const bool ok = j < n;
    cp_async4(lab + q * kLabLd + c,
              ok ? (const void*)(groupings + (q_row0 + q) * n + j)
                 : (const void*)groupings, ok ? 4 : 0);
  }
}

// Build a stage's B tile from its staged labels: thread tid owns column
// tid (permutation bq of the slice, group bg; -1 past the last column) and
// writes its 32 k-values, 16 bytes at a time.
template <typename T>
__device__ __forceinline__ void matmul_build_b(unsigned char* bt,
                                               const unsigned char* st,
                                               int bq, int bg) {
  const int tid = threadIdx.x;
  const int* lab = reinterpret_cast<const int*>(st + MatmulTile<T>::kBytes) +
                   bq * kLabLd;
  unsigned char* col = bt + (tid / 8) * kSbo + (tid % 8) * 16;
  if constexpr (sizeof(T) == 4) {
    constexpr uint32_t kOne = 0x3f800000u;  // 1.0f
#pragma unroll
    for (int c = 0; c < kMK / 4; ++c) {       // k = 4c .. 4c + 3
      const int4 l = *reinterpret_cast<const int4*>(lab + 4 * c);
      *reinterpret_cast<uint4*>(col + (c / 2) * kBStep + (c % 2) * kLbo) =
          make_uint4(l.x == bg ? kOne : 0u, l.y == bg ? kOne : 0u,
                     l.z == bg ? kOne : 0u, l.w == bg ? kOne : 0u);
    }
  } else {
    constexpr uint32_t kLo = 0x3f80u, kHi = 0x3f800000u;  // 1.0 in bf16
#pragma unroll
    for (int c = 0; c < kMK / 8; ++c) {       // k = 8c .. 8c + 7
      const int4 l0 = *reinterpret_cast<const int4*>(lab + 8 * c);
      const int4 l1 = *reinterpret_cast<const int4*>(lab + 8 * c + 4);
      *reinterpret_cast<uint4*>(col + (c / 2) * kBStep + (c % 2) * kLbo) =
          make_uint4((l0.x == bg ? kLo : 0u) | (l0.y == bg ? kHi : 0u),
                     (l0.z == bg ? kLo : 0u) | (l0.w == bg ? kHi : 0u),
                     (l1.x == bg ? kLo : 0u) | (l1.y == bg ? kHi : 0u),
                     (l1.z == bg ? kLo : 0u) | (l1.w == bg ? kHi : 0u));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kMatmulThreads, kMatmulMinBlocks)
sw_matmul_kernel(const T* __restrict__ mat2,
                 const int* __restrict__ groupings,
                 const float* __restrict__ sqrt_w,
                 float* __restrict__ partials, int64_t n, int64_t n_perms,
                 int n_groups) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float colsum[kMN];
  __shared__ float perm_acc[kMaxPB];
  constexpr bool kBf16 = sizeof(T) == 2;
  constexpr int kBBytes = MatmulTile<T>::kBBytes;
  const int perm_block = matmul_perm_block(n_groups);
  const int stage_bytes = matmul_stage_bytes(MatmulTile<T>::kBytes,
                                             perm_block);
  unsigned char* ring = smem + 2 * kBBytes;
  const int64_t p0 = (int64_t)blockIdx.x * perm_block;
  const int64_t ti = blockIdx.y;
  const int64_t r0 = ti * kMR;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int wg = warp >> 2;   // its columns [128 wg, 128 wg + 128)
  const int arow = (warp & 3) * 16 + (lane >> 2);  // A rows arow, arow + 8
  const int tig = lane & 3;
  const int pb_here = (int)min64(perm_block, n_perms - p0);
  const int k_total = pb_here * n_groups;
  const int n_tiles = (int)((n + kMK - 1) / kMK);

  for (int q = tid; q < kMaxPB; q += kMatmulThreads) perm_acc[q] = 0.f;

  // bf16: the element shift of this thread's two A rows
  int shift[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    shift[h] = (int)(((r0 + arow + 8 * h) * n) & 1);

  float d[64];   // a flush chain's fresh accumulator
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = 0.f;

  for (int k0 = 0; k0 < k_total; k0 += kMN) {
    const int q_lo = k0 / n_groups;
    const int q_hi = min(pb_here - 1, (k0 + kMN - 1) / n_groups);
    const int q_span = q_hi - q_lo + 1;
    // this thread's B column: k0 + tid
    const int kb = k0 + tid;
    const int bq = kb < k_total ? kb / n_groups - q_lo : 0;
    const int bg = kb < k_total ? kb % n_groups : -1;
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    __syncthreads();  // the previous slice's readers of shared memory done
#pragma unroll
    for (int t = 0; t < kStages - 1; ++t) {
      if (t < n_tiles)
        matmul_load_tile<T>(ring + t * stage_bytes, mat2, groupings, n, r0,
                            (int64_t)t * kMK, p0 + q_lo, q_span);
      cp_async_commit();
    }
    cp_async_wait<kStages - 2>();   // tile 0
    __syncthreads();
    matmul_build_b<T>(smem, ring, bq, bg);
    fence_proxy_async();
    for (int t = 0; t < n_tiles; ++t) {
      cp_async_wait<kStages - 3>();   // tiles t and t + 1 (this thread's)
      __syncthreads();   // everyone's; B(t) built; stage t - 1 is free
      const int tn = t + kStages - 1;
      if (tn < n_tiles)
        matmul_load_tile<T>(ring + (tn % kStages) * stage_bytes, mat2,
                            groupings, n, r0, (int64_t)tn * kMK, p0 + q_lo,
                            q_span);
      cp_async_commit();

      const unsigned char* st = ring + (t % kStages) * stage_bytes;
      const unsigned char* bt = smem + (t & 1) * kBBytes + wg * 16 * kSbo;
      // the steps of a stage go in flush chains; while the first chain
      // runs on the tensor cores, the block builds the next stage's B tile
      constexpr int kSteps = kBf16 ? kMK / 16 : kMK / 8;
      constexpr int kFlush = kBf16 ? kBf16Flush : kTf32Flush;
#pragma unroll
      for (int c0 = 0; c0 < kSteps; c0 += kFlush) {
        fence_regs(d);
        if constexpr (!kBf16) {
          const float* ms = reinterpret_cast<const float*>(st) +
                            arow * kMsLd + tig;
          uint32_t hi[kFlush][4], lo[kFlush][4];
#pragma unroll
          for (int f = 0; f < kFlush; ++f) {
            const float* m = ms + 8 * (c0 + f);
            const float x[4] = {m[0], m[8 * kMsLd], m[4], m[8 * kMsLd + 4]};
#pragma unroll
            for (int v = 0; v < 4; ++v) {
              hi[f][v] = tf32_round(x[v]);
              lo[f][v] = tf32_round(x[v] - __uint_as_float(hi[f][v]));
            }
          }
          wgmma_fence();
#pragma unroll
          for (int f = 0; f < kFlush; ++f) {
            const uint64_t b = b_desc(bt + (c0 + f) * kBStep);
            wgmma_tf32(d, hi[f], b, f > 0);
            wgmma_tf32(d, lo[f], b, 1);
          }
        } else {
          const unsigned short* mh =
              reinterpret_cast<const unsigned short*>(st);
          uint32_t a[kFlush][4];
#pragma unroll
          for (int f = 0; f < kFlush; ++f)
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const unsigned short* m = mh + (arow + 8 * h) * (2 * kHLd) +
                                        shift[h] + 16 * (c0 + f) + 2 * tig;
              a[f][h] = (uint32_t)m[0] | ((uint32_t)m[1] << 16);
              a[f][2 + h] = (uint32_t)m[8] | ((uint32_t)m[9] << 16);
            }
          wgmma_fence();
#pragma unroll
          for (int f = 0; f < kFlush; ++f)
            wgmma_bf16(d, a[f], b_desc(bt + (c0 + f) * kBStep), f > 0);
        }
        wgmma_commit();
        if (c0 == 0 && t + 1 < n_tiles) {
          matmul_build_b<T>(smem + ((t + 1) & 1) * kBBytes,
                            ring + ((t + 1) % kStages) * stage_bytes, bq, bg);
          fence_proxy_async();
        }
        wgmma_wait_all();
        fence_regs(d);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += d[i];
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // B tiles and ring dead; contrib reuses their memory

    // Y . w 1[l(r) == g] for this thread's accumulators: acc[4i + v] is
    // row arow + 8 (v / 2), column 128 wg + 8 i + 2 tig + v % 2
    float* contrib = reinterpret_cast<float*>(smem);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = arow + 8 * h;
      const int64_t i = r0 + r;
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kl = 128 * wg + 8 * j + 2 * tig + e;
          const int kk = k0 + kl;
          float val = 0.f;
          if (i < n && kk < k_total) {
            const int g = kk % n_groups;
            if (groupings[(p0 + kk / n_groups) * n + i] == g) {
              const float sw = sqrt_w[g];
              val = acc[4 * j + 2 * h + e] * (sw * sw);
            }
          }
          contrib[r * (kMN + 1) + kl] = val;
        }
    }
    __syncthreads();
    {  // column sums over the 64 rows, in order
      float s = 0.f;
      for (int r = 0; r < kMR; ++r) s += contrib[r * (kMN + 1) + tid];
      colsum[tid] = s;
    }
    __syncthreads();
    // each permutation of this slice adds its G columns, in order
    for (int q = q_lo + tid; q <= q_hi; q += kMatmulThreads) {
      const int k_begin = max(q * n_groups, k0) - k0;
      const int k_end = min((q + 1) * n_groups, k0 + kMN) - k0;
      float s = 0.f;
      for (int k = k_begin; k < k_end; ++k) s += colsum[k];
      perm_acc[q] += s;
    }
  }
  __syncthreads();
  for (int q = tid; q < pb_here; q += kMatmulThreads)
    partials[(p0 + q) * gridDim.y + ti] = 0.5f * perm_acc[q];
}

}  // namespace

extern "C" {

// Tile constants the host needs to size the partials:
// [brute rows per band, permblock perms per pass, permblock tile,
//  matmul rows per block, matmul max perms per block, matmul one-hot
//  columns per block, brute columns per tile, brute perms per block,
//  permblock column tiles per strip].
void sw_kernel_config(int* out) {
  out[0] = kBruteRows;
  out[1] = kPbPass;
  out[2] = kBruteRows;
  out[3] = kMR;
  out[4] = kMaxPB;
  out[5] = kMN;
  out[6] = kBruteCols;
  out[7] = kBrutePerms;
  out[8] = kPbStripTiles;
}

// partials: (P, ceil(n / 64)) f32. The two-stage ring takes 102,400 bytes
// of dynamic shared memory, above the 48 KB default, so the limit is
// raised first.
int sw_brute_launch(const void* mat2, const void* groupings, const void* w,
                    void* partials, long long n, long long n_perms,
                    int n_groups, void* stream) {
  const dim3 grid((unsigned)((n_perms + kBrutePerms - 1) / kBrutePerms),
                  (unsigned)((n + kBruteRows - 1) / kBruteRows));
  cudaFuncSetAttribute(sw_brute_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kBruteSmemBytes);
  sw_brute_kernel<<<grid, kThreads, kBruteSmemBytes,
                    (cudaStream_t)stream>>>(
      (const float*)mat2, (const int*)groupings, (const float*)w,
      (float*)partials, n, n_perms, n_groups, 0, n);
  return (int)cudaGetLastError();
}

// The row-slab entry (row-sharded s_W): mat2_rows holds global rows
// [row_offset, row_offset + n_rows) of the (n, n) matrix with pitch n;
// groupings are the (P, n) labels of every sample. partials: (P,
// ceil(n_rows / 64)) f32, column y the partial of global band
// row_offset / 64 + y, bit for bit the whole-matrix launch's. row_offset
// must be a multiple of 64 (a band is the unit of the partials) and the
// slab must lie inside the matrix; otherwise nothing is launched and
// cudaErrorInvalidValue is returned.
int sw_brute_rows_launch(const void* mat2_rows, const void* groupings,
                         const void* w, void* partials, long long n,
                         long long n_rows, long long row_offset,
                         long long n_perms, int n_groups, void* stream) {
  if (n < 1 || n_rows < 1 || n_perms < 1 || row_offset < 0 ||
      row_offset % kBruteRows != 0 || row_offset + n_rows > n)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n_perms + kBrutePerms - 1) / kBrutePerms),
                  (unsigned)((n_rows + kBruteRows - 1) / kBruteRows));
  cudaFuncSetAttribute(sw_brute_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kBruteSmemBytes);
  sw_brute_kernel<<<grid, kThreads, kBruteSmemBytes,
                    (cudaStream_t)stream>>>(
      (const float*)mat2_rows, (const int*)groupings, (const float*)w,
      (float*)partials, n, n_perms, n_groups, row_offset,
      row_offset + n_rows);
  return (int)cudaGetLastError();
}

// partials: (blocks, P) f32, blocks = pb_blocks(ceil(n / 64)) (5,025 at
// n = 25,145). The tile and the label stages take 90,112 bytes of dynamic
// shared memory, above the 48 KB default, so the limit is raised first.
int sw_permblock_launch(const void* mat2, const void* groupings,
                        const void* w, void* partials, long long n,
                        long long n_perms, int n_groups, void* stream) {
  const int64_t blocks = pb_blocks((n + kBruteCols - 1) / kBruteCols);
  if (n < 1 || n_perms < 1 || blocks > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaFuncSetAttribute(sw_permblock_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kPbSmemBytes);
  sw_permblock_kernel<<<(unsigned)blocks, kThreads, kPbSmemBytes,
                        (cudaStream_t)stream>>>(
      (const float*)mat2, (const int*)groupings, (const float*)w,
      (float*)partials, n, n_perms, n_groups);
  return (int)cudaGetLastError();
}

// partials: (P, ceil(n / 64)) f32. is_bf16 selects the mat2 element type;
// sqrt_w is f32, already rounded to mat2's type. The B tiles and the ring
// take up to 176,128 bytes of dynamic shared memory (f32, G <= 2),
// 120,832 at G = 8, above the 48 KB default, so the limit is raised
// first.
int sw_matmul_launch(const void* mat2, const void* groupings,
                     const void* sqrt_w, void* partials, long long n,
                     long long n_perms, int n_groups, int is_bf16,
                     void* stream) {
  if (n_groups < 1) return (int)cudaErrorInvalidValue;
  const int perm_block = matmul_perm_block(n_groups);
  const dim3 grid((unsigned)((n_perms + perm_block - 1) / perm_block),
                  (unsigned)((n + kMR - 1) / kMR));
  if (is_bf16) {
    const int smem = matmul_smem_bytes<__nv_bfloat16>(perm_block);
    cudaFuncSetAttribute(sw_matmul_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    sw_matmul_kernel<__nv_bfloat16><<<grid, kMatmulThreads, smem,
                                      (cudaStream_t)stream>>>(
        (const __nv_bfloat16*)mat2, (const int*)groupings,
        (const float*)sqrt_w, (float*)partials, n, n_perms, n_groups);
  } else {
    const int smem = matmul_smem_bytes<float>(perm_block);
    cudaFuncSetAttribute(sw_matmul_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    sw_matmul_kernel<float><<<grid, kMatmulThreads, smem,
                             (cudaStream_t)stream>>>(
        (const float*)mat2, (const int*)groupings, (const float*)sqrt_w,
        (float*)partials, n, n_perms, n_groups);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
