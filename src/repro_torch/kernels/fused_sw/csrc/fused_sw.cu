// Fused distance -> s_W megakernels on Hopper (sm_90a). For a row slab
// xr (nr, d) whose first row is global sample `row_offset`, against the
// full table xc (n, d), and permuted labels g_rows (P, nr) / g_cols (P, n),
// one launch gives
//
//   s_W[p]   = 1/2 sum_{r, c valid, r != c} D2[r, c] * 1[g_r == g_c] / n_{g_r}
//   rows[r]  = sum_c D2[r, c]                       (the Gower row sums)
//
// as per-tile partials (reduced by the caller), and never writes D2 to
// device memory. D2 is the metric's squared distance:
//
//   euclidean   max(|x|^2 + |y|^2 - 2 x.y, 0)
//   braycurtis  (sum_k |x_k - y_k| / max(S_x + S_y, 1e-30))^2
//   jaccard     (1 - inter / max(card_x + card_y - inter, 1))^2, 0/1 floats
//
// It replaces src/repro/kernels/fused_sw/kernel.py:193 (fused_sw_pallas,
// in each of its feature modes: below). That kernel walks a (row tile,
// col tile, t) grid in order: feature steps accumulate into VMEM scratch,
// the last one finalizes the masked D2 tile, and permutation steps
// contract it on the MXU with one-hot label blocks into an s_W
// accumulator flushed at the final step. CUDA blocks run in no order, so
// here each block of 256 threads owns one 64 x 64 tile and runs both
// phases itself:
//
//   feature phase   a loop over 32-feature chunks staged transposed in
//                   static shared memory; each thread keeps a 4 x 4
//                   micro-tile of accumulators in registers (the layout of
//                   kernels/distance/csrc/distance.cu, whose metric bodies
//                   are copied below with a squared finalize)
//   finalize        D2 and the mask by GLOBAL index, once: slab pad rows,
//                   row_offset + r >= n_valid, c >= n_valid and the exact
//                   diagonal row_offset + r == c are zeroed before anything
//                   reads the tile (the euclidean self pair is not 0 in f32)
//   row sums        each thread sums its 4 columns per row, then a fixed
//                   shuffle tree over the 16 threads of a tile row: one
//                   partial per (row, column tile)
//   permutations    blocks of 16: the 16 x 64 row labels (with 1/n_g of
//                   each) and column labels are staged in shared memory;
//                   each thread adds d2 * w_r over its 16 pairs where
//                   g_r == g_c, then a fixed shuffle tree per warp and a
//                   fixed-order sum over the 8 warps: one partial per
//                   (tile, permutation)
//
// The same-group form weights each pair by 1/n_g once, where the reference
// multiplies sqrt(1/n_g) from both sides; the two differ by rounding only.
// It does ~G times fewer operations than the one-hot contraction, which
// on CUDA cores made the permanova_sw matmul kernel ~5x slower than
// permblock per permutation. Partials are reduced by the caller with
// torch.sum (a fixed order): no float atomics, the same bits every run.
//
// Bound on an H100 SXM at 700 W at the main path's shape (n = 25,145,
// d = 128, a chunk of P = 156 permutations, G = 8): the feature phase is
// 2 n^2 d = 1.6e11 operations (2.4 ms at 67 TFLOP/s f32) and the
// permutation phase P (n(n-1)/2 + matches) = 5.5e10 (0.8 ms), 3.2 ms in
// all; the inputs are 13 MB of features and 16 MB of labels (0.01 ms of
// HBM), so it is bound by operations. Every tile recomputes its D2 for
// each chunk (the reference's design: the footprint does not grow with
// n^2); the D2 tile
// lives only in registers, and the staged tiles make each feature and
// label read from L2 once per 64 rows or columns. Symmetry (half the
// tiles) and wgmma are left for later.
//
// The dense-design kernel (fused_sw_cols_kernel) replaces
// src/repro/kernels/fused_sw/kernel.py:338 (fused_sw_cols_pallas, in each
// of its feature modes). It shares the feature phase, the finalize and the
// mask (feature_tile below) and swaps the labels for a permuted design
// basis v_rows (P, nr, K) / v_cols (P, n, K):
//
//   s[p, k]  = 1/2 sum_{r, c valid, r != c} v_r[p, r, k] D2[r, c] v_c[p, c, k]
//   rows[r]  = sum_c D2[r, c]
//
// Pallas sums s over the whole grid in a VMEM accumulator flushed at the
// last step; a CUDA block must not, and one (P, K) partial per 64 x 64
// tile would be 785 MB at the EMP design chunk (n = 25,145, P = 127, K =
// 10). So each block owns a row tile and a strip of kStripTiles = 8
// column tiles and sums over the strip itself, kRegTiles = 2 D2 tiles in
// registers at a time: one partial per (row tile, strip, permutation,
// column), 99.8 MB there, plus one row sum per (row, strip), reduced by
// the caller with torch.sum. The permutation phase takes kQ = 32
// (permutation, column) pairs q = p K + k a step, any P and K: their basis
// entries at the tile's rows and columns are staged in shared memory (zero
// past Q), each thread forms sum_ii v_r[ii] sum_jj D2[ii][jj] v_c[jj] over
// its 4 x 4 pairs of both tiles (f32 FMAs on the CUDA cores), and a
// transposed shuffle reduction leaves one warp sum per q in each lane, then
// a fixed-order sum over the 8 warps. The strip's later register tiles add
// to the block's own partials in place: no atomics, the same bits every
// run. A row tile made only of pad rows (row_offset + i0 >= n_valid, the
// reference's row_live) writes zeros and skips both phases.
//
// Its bound at the EMP design chunk on an H100 SXM at 700 W: 2 n^2 d +
// 2 n^2 P K = 1.6e11 + 1.6e12 operations, ~26 ms at 67 TFLOP/s f32; the
// inputs (features 13 MB, each basis factor 128 MB) take ~0.08 ms of HBM,
// so it is bound by operations. A block reads its strip's v_c entries
// once and its rows' v_r entries once per pair of register tiles, from L2
// where the concurrent blocks (neighbouring row tiles of one strip) share
// them. Symmetry, TMA and wgmma are left for later.
//
// Feature modes (src/repro/kernels/fused_sw/kernel.py:54-103, _accumulate):
// both kernels take their features as f32, bf16, fp8 e4m3 with one
// per-study scale (a device scalar), or 32-bit presence words for jaccard
// (the element type is a template parameter, the loaders below). Staging
// is where the modes differ and nothing else: each staged element becomes
// f32 in shared memory (bf16 cast up; e4m3 cast up and multiplied by the
// scale, as the reference dequantizes in-register; a presence word moved
// bit for bit), so the register micro-tile, the finalize, the mask and
// both permutation phases are the f32 code. The packed body (PackedJaccard)
// counts |A & B| with popcount(AND) and each row's cardinality with
// popcount, exact integers like the f32 jaccard's 0/1 FMAs, so its D2,
// s_W and row sums equal those of the f32 jaccard kernel on the same
// presence data bit for bit. The modes move 2, 4 or 32 times fewer feature
// bytes, but the kernels are bound by operations (above): a mode's cast
// runs once per staged element, not per pair, so bf16 and fp8 take the
// f32 time, and packed does 4 AND + popcount a pair where f32 jaccard
// does 128 FMAs (d = 128), which shrinks only the feature phase.
//
// Ragged nr, n, d, P and K are masked here; nothing is padded. Element
// offsets are 64-bit. Division is nvcc's default IEEE-rounded form (no
// --use_fast_math). Static shared memory: 30,720 B (labels), 45,056 B
// (dense design).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. The C entry point launches on the caller's
//        stream, never synchronises, and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;              // tile rows (and cols) per block
constexpr int kMicro = 4;              // each thread owns 4 x 4 pairs
constexpr int kChunk = 32;             // features staged per step
constexpr int kPitch = kTile + 4;      // keeps 16-byte micro-tile reads
constexpr int kPermBlock = 16;         // permutations staged per step
constexpr int kMaxGridY = 65535;
// the dense-design kernel (fused_sw_cols_kernel)
constexpr int kStripTiles = 8;         // column tiles a block sums over
constexpr int kRegTiles = 2;           // D2 tiles a thread holds at once
constexpr int kQ = 32;                 // (permutation, column) pairs a step
constexpr int kRowStep = kThreads / kQ;  // rows apart a thread stages
static_assert(kThreads % kQ == 0, "a thread stages one pair a step");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// The metric bodies of distance.cu (stat: the per-row statistic; step: one
// feature's contribution to a pair; d2: the squared distance from the
// pair's sum and the two rows' statistics).
struct BrayCurtis {
  static __device__ __forceinline__ float stat(float a) { return a; }
  static __device__ __forceinline__ void step(float& acc, float a, float b) {
    acc += fabsf(a - b);
  }
  static __device__ __forceinline__ float d2(float num, float sr, float sc) {
    const float d = num / fmaxf(sr + sc, 1e-30f);
    return d * d;
  }
};

struct Euclidean {
  static __device__ __forceinline__ float stat(float a) { return a * a; }
  static __device__ __forceinline__ void step(float& acc, float a, float b) {
    acc = fmaf(a, b, acc);
  }
  static __device__ __forceinline__ float d2(float dot, float sr, float sc) {
    return fmaxf(sr + sc - 2.f * dot, 0.f);
  }
};

struct Jaccard {
  static __device__ __forceinline__ float stat(float a) { return a; }
  static __device__ __forceinline__ void step(float& acc, float a, float b) {
    acc = fmaf(a, b, acc);  // 0/1 products: an exact integer count
  }
  static __device__ __forceinline__ float d2(float inter, float sr,
                                             float sc) {
    const float card = sr + sc;
    const float uni = card - inter;
    const float d = 1.f - inter / fmaxf(uni, 1.f);
    return d * d;
  }
};

// Jaccard on 32-bit presence words staged bit for bit as floats (d counts
// words): popcount(AND) per word for |A & B|, popcount for a row's
// cardinality, the float jaccard's finalize.
struct PackedJaccard {
  static __device__ __forceinline__ float stat(float w) {
    return (float)__popc(__float_as_uint(w));
  }
  static __device__ __forceinline__ void step(float& acc, float a, float b) {
    acc += (float)__popc(__float_as_uint(a) & __float_as_uint(b));
  }
  static __device__ __forceinline__ float d2(float inter, float sr,
                                             float sc) {
    return Jaccard::d2(inter, sr, sc);
  }
};

// Feature loaders: element type T in device memory -> the f32 staged in
// shared memory. scale() reads the fp8 scale once per block (the other
// modes take no scale and never dereference the pointer).
struct F32In {
  using T = float;
  static __device__ __forceinline__ float scale(const float*) { return 1.f; }
  static __device__ __forceinline__ float load(const T* p, int64_t i,
                                               float) {
    return p[i];
  }
};

struct Bf16In {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ float scale(const float*) { return 1.f; }
  static __device__ __forceinline__ float load(const T* p, int64_t i,
                                               float) {
    return __bfloat162float(p[i]);
  }
};

struct Fp8In {
  using T = __nv_fp8_e4m3;
  static __device__ __forceinline__ float scale(const float* s) {
    return __ldg(s);
  }
  static __device__ __forceinline__ float load(const T* p, int64_t i,
                                               float s) {
    return static_cast<float>(p[i]) * s;
  }
};

struct PackedIn {
  using T = uint32_t;
  static __device__ __forceinline__ float scale(const float*) { return 1.f; }
  static __device__ __forceinline__ float load(const T* p, int64_t i,
                                               float) {
    return __uint_as_float(p[i]);
  }
};

// The feature phase and the finalize of one 64 x 64 tile, shared by both
// kernels: the block's 256 threads stage 32-feature chunks of slab rows
// i0 + [0, 64) and columns j0 + [0, 64) transposed in rs / cs, thread (ty,
// tx) accumulates rows 4 ty + [0, 4) x columns 4 tx + [0, 4) in `acc`, and
// the finalize leaves the masked D2 there. Threads 0-63 sum the row
// statistic of tile row t, threads 64-127 the column statistic. Every
// caller passes d >= 1, so the chunk loop's barriers also separate this
// call's writes of rs / cs / row_stat / col_stat from an earlier call's
// reads. L loads the mode's elements (d of them a row) as f32.
template <class M, class L>
__device__ __forceinline__ void feature_tile(
    const typename L::T* __restrict__ xr,
    const typename L::T* __restrict__ xc, float scale,
    int64_t nr, int64_t n, int64_t d, int64_t i0, int64_t j0,
    int64_t row_offset, int64_t n_valid, float (&rs)[kChunk][kPitch],
    float (&cs)[kChunk][kPitch], float (&row_stat)[kTile],
    float (&col_stat)[kTile], float (&acc)[kMicro][kMicro]) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = 0.f;
  float stat = 0.f;

  for (int64_t k0 = 0; k0 < d; k0 += kChunk) {
    const int kn = (int)min64(kChunk, d - k0);
    // Stage the chunk transposed: a warp reads 32 consecutive features of
    // one row (coalesced) and writes them down one column of rs / cs.
    for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk, k = e % kChunk;
      const int64_t i = i0 + r, j = j0 + r;
      float a = 0.f, b = 0.f;
      if (k < kn) {
        if (i < nr) a = L::load(xr, i * d + k0 + k, scale);
        if (j < n) b = L::load(xc, j * d + k0 + k, scale);
      }
      rs[k][r] = a;
      cs[k][r] = b;
    }
    __syncthreads();
    if (threadIdx.x < kTile) {
      for (int k = 0; k < kn; ++k) stat += M::stat(rs[k][threadIdx.x]);
    } else if (threadIdx.x < 2 * kTile) {
      for (int k = 0; k < kn; ++k)
        stat += M::stat(cs[k][threadIdx.x - kTile]);
    }
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(&rs[k][ty * kMicro]);
      const float4 b = *reinterpret_cast<const float4*>(&cs[k][tx * kMicro]);
      const float av[kMicro] = {a.x, a.y, a.z, a.w};
      const float bv[kMicro] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int ii = 0; ii < kMicro; ++ii)
#pragma unroll
        for (int jj = 0; jj < kMicro; ++jj)
          M::step(acc[ii][jj], av[ii], bv[jj]);
    }
    __syncthreads();  // the chunk's readers are done before it is replaced
  }
  if (threadIdx.x < kTile)
    row_stat[threadIdx.x] = stat;
  else if (threadIdx.x < 2 * kTile)
    col_stat[threadIdx.x - kTile] = stat;
  __syncthreads();

  // ---- finalize: the masked D2 tile, in place of the accumulators --------
#pragma unroll
  for (int ii = 0; ii < kMicro; ++ii) {
    const int64_t i = i0 + ty * kMicro + ii;
    const int64_t gi = row_offset + i;
    const bool row_ok = i < nr && gi < n_valid;
    const float sr = row_stat[ty * kMicro + ii];
#pragma unroll
    for (int jj = 0; jj < kMicro; ++jj) {
      const int64_t j = j0 + tx * kMicro + jj;
      const bool ok = row_ok && j < n_valid && gi != j;
      acc[ii][jj] = ok ? M::d2(acc[ii][jj], sr, col_stat[tx * kMicro + jj])
                       : 0.f;
    }
  }
}

// Row ii of a thread's D2 micro-tile summed over the tile's 64 columns: the
// thread's 4, then a fixed shuffle tree over the 16 threads of the tile
// row. The result is valid at tx == 0.
__device__ __forceinline__ float tile_row_sum(
    const float (&acc)[kMicro][kMicro], int ii) {
  float s = ((acc[ii][0] + acc[ii][1]) + acc[ii][2]) + acc[ii][3];
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)         // the 16 threads of a row
    s += __shfl_down_sync(0xffffffffu, s, off, 16);
  return s;
}

// Grid (ceil(n / 64), ceil(nr / 64)); block (bx, by) owns slab rows
// by*64 + [0, 64) and columns bx*64 + [0, 64). Thread (ty, tx) owns rows
// 4 ty + [0, 4) and columns 4 tx + [0, 4) of the tile.
// sw_part: (ceil(nr/64) * ceil(n/64), P), row-major by tile (by, bx).
// rs_part: (nr, ceil(n/64)).
template <class M, class L>
__global__ void __launch_bounds__(kThreads)
fused_sw_kernel(const typename L::T* __restrict__ xr,
                const typename L::T* __restrict__ xc,
                const float* __restrict__ scale,
                const int* __restrict__ g_rows,
                const int* __restrict__ g_cols,
                const float* __restrict__ inv_gs,
                float* __restrict__ sw_part, float* __restrict__ rs_part,
                int64_t nr, int64_t n, int64_t d, int64_t n_perms,
                int n_groups, int64_t row_offset, int64_t n_valid) {
  __shared__ __align__(16) float rs[kChunk][kPitch];
  __shared__ __align__(16) float cs[kChunk][kPitch];
  __shared__ float row_stat[kTile];
  __shared__ float col_stat[kTile];
  __shared__ __align__(16) int lab_r[kPermBlock][kTile];
  __shared__ __align__(16) float w_r[kPermBlock][kTile];
  __shared__ __align__(16) int lab_c[kPermBlock][kTile];
  __shared__ float warp_sum[kWarps][kPermBlock];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t i0 = (int64_t)blockIdx.y * kTile;   // slab-local rows
  const int64_t j0 = (int64_t)blockIdx.x * kTile;
  const int64_t ntj = gridDim.x;
  const int64_t tile = (int64_t)blockIdx.y * ntj + blockIdx.x;

  // ---- feature phase and finalize: the masked D2 tile in registers ------
  float acc[kMicro][kMicro];
  feature_tile<M, L>(xr, xc, L::scale(scale), nr, n, d, i0, j0,
                     row_offset, n_valid, rs, cs, row_stat, col_stat, acc);

  // ---- Gower row sums: one partial per (row, column tile) ----------------
#pragma unroll
  for (int ii = 0; ii < kMicro; ++ii) {
    const float s = tile_row_sum(acc, ii);
    const int64_t i = i0 + ty * kMicro + ii;
    if (tx == 0 && i < nr) rs_part[i * ntj + blockIdx.x] = s;
  }

  // ---- permutation phase: one partial per (tile, permutation) ------------
  for (int64_t p0 = 0; p0 < n_perms; p0 += kPermBlock) {
    const int pn = (int)min64(kPermBlock, n_perms - p0);
    __syncthreads();  // the previous block's readers are done
    for (int e = threadIdx.x; e < kPermBlock * kTile; e += kThreads) {
      const int p = e / kTile, r = e % kTile;
      int gr = 0, gc = -1;
      float w = 0.f;
      if (p < pn) {
        const int64_t i = i0 + r, j = j0 + r;
        if (i < nr) {
          gr = g_rows[(p0 + p) * nr + i];
          w = (gr >= 0 && gr < n_groups) ? inv_gs[gr] : 0.f;
        }
        if (j < n) gc = g_cols[(p0 + p) * n + j];
      }
      lab_r[p][r] = gr;
      w_r[p][r] = w;
      lab_c[p][r] = gc;
    }
    __syncthreads();
    for (int p = 0; p < pn; ++p) {
      const int4 gr = *reinterpret_cast<const int4*>(&lab_r[p][ty * kMicro]);
      const float4 wr = *reinterpret_cast<const float4*>(&w_r[p][ty * kMicro]);
      const int4 gc = *reinterpret_cast<const int4*>(&lab_c[p][tx * kMicro]);
      const int grv[kMicro] = {gr.x, gr.y, gr.z, gr.w};
      const float wv[kMicro] = {wr.x, wr.y, wr.z, wr.w};
      const int gcv[kMicro] = {gc.x, gc.y, gc.z, gc.w};
      float s = 0.f;
#pragma unroll
      for (int ii = 0; ii < kMicro; ++ii) {
        float t = 0.f;
#pragma unroll
        for (int jj = 0; jj < kMicro; ++jj)
          t += grv[ii] == gcv[jj] ? acc[ii][jj] : 0.f;
        s = fmaf(t, wv[ii], s);
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        s += __shfl_down_sync(0xffffffffu, s, off);
      if (lane == 0) warp_sum[warp][p] = s;
    }
    __syncthreads();
    if (threadIdx.x < pn) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) s += warp_sum[w][threadIdx.x];
      sw_part[tile * n_perms + p0 + threadIdx.x] = 0.5f * s;
    }
  }
}

// One step of a warp's transposed reduction over kQ = 32 values a lane:
// lanes exchange the half of their values the partner keeps (shuffle xor
// W), so after the steps 16, 8, 4, 2, 1 lane L holds in v[0] the warp's
// sum of value L, in a fixed order: 31 shuffles for 32 sums where a
// shuffle tree per value would take 160.
template <int W>
__device__ __forceinline__ void transpose_reduce_step(float (&v)[kQ],
                                                      int lane) {
  const bool upper = (lane & W) != 0;
#pragma unroll
  for (int i = 0; i < W; ++i) {
    const float send = upper ? v[i] : v[i + W];
    const float keep = upper ? v[i + W] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
  }
}

// Grid (ceil(nr / 64), n_strips); block (bx, by) owns slab rows
// bx*64 + [0, 64) and the strip of column tiles by*kStripTiles + [0,
// kStripTiles), kRegTiles at a time, and sums over the strip itself. Q =
// P * K (permutation, column) pairs, q = p * K + k.
// s_part: (n_strips * ceil(nr/64), Q), row-major by (by, bx).
// rs_part: (nr, n_strips).
template <class M, class L>
__global__ void __launch_bounds__(kThreads)
fused_sw_cols_kernel(const typename L::T* __restrict__ xr,
                     const typename L::T* __restrict__ xc,
                     const float* __restrict__ scale,
                     const float* __restrict__ v_rows,
                     const float* __restrict__ v_cols,
                     float* __restrict__ s_part, float* __restrict__ rs_part,
                     int64_t nr, int64_t n, int64_t d, int64_t n_perms,
                     int64_t n_cols, int64_t row_offset, int64_t n_valid) {
  __shared__ __align__(16) float rs[kChunk][kPitch];
  __shared__ __align__(16) float cs[kChunk][kPitch];
  __shared__ float row_stat[kTile];
  __shared__ float col_stat[kTile];
  __shared__ __align__(16) float vr_s[kQ][kPitch];
  __shared__ __align__(16) float vc_s[kRegTiles][kQ][kPitch];
  __shared__ float warp_sum[kWarps][kQ];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t i0 = (int64_t)blockIdx.x * kTile;   // slab-local rows
  const int64_t ntj = (n + kTile - 1) / kTile;
  const int64_t n_strips = gridDim.y;
  const int64_t jt0 = (int64_t)blockIdx.y * kStripTiles;
  const int64_t nq = n_perms * n_cols;
  float* __restrict__ out =
      s_part + ((int64_t)blockIdx.y * gridDim.x + blockIdx.x) * nq;

  // A row tile made only of pad rows (an offset slab past n_valid) has
  // nothing to add: its partials and row sums are 0.
  if (row_offset + i0 >= n_valid) {
    for (int64_t q = threadIdx.x; q < nq; q += kThreads) out[q] = 0.f;
#pragma unroll
    for (int ii = 0; ii < kMicro; ++ii) {
      const int64_t i = i0 + ty * kMicro + ii;
      if (tx == 0 && i < nr) rs_part[i * n_strips + blockIdx.y] = 0.f;
    }
    return;
  }

  const float xscale = L::scale(scale);
  float rsum[kMicro] = {0.f, 0.f, 0.f, 0.f};
  for (int sub = 0; sub < kStripTiles && jt0 + sub < ntj;
       sub += kRegTiles) {
    // ---- feature phase: kRegTiles masked D2 tiles in registers ----------
    float d2[kRegTiles][kMicro][kMicro];
#pragma unroll
    for (int t = 0; t < kRegTiles; ++t) {
      if (jt0 + sub + t < ntj) {
        feature_tile<M, L>(xr, xc, xscale, nr, n, d, i0,
                           (jt0 + sub + t) * kTile, row_offset, n_valid, rs,
                           cs, row_stat, col_stat, d2[t]);
#pragma unroll
        for (int ii = 0; ii < kMicro; ++ii)
          rsum[ii] += tile_row_sum(d2[t], ii);
      } else {
#pragma unroll
        for (int ii = 0; ii < kMicro; ++ii)
#pragma unroll
          for (int jj = 0; jj < kMicro; ++jj) d2[t][ii][jj] = 0.f;
      }
    }

    // ---- permutation phase: kQ (permutation, column) pairs a step -------
    for (int64_t q0 = 0; q0 < nq; q0 += kQ) {
      __syncthreads();  // the previous step's readers are done
      // Stage the step's basis entries: v_rows at the tile's 64 rows and
      // v_cols at each register tile's 64 columns, 0 past nr, n or Q.
      // kThreads is a multiple of kQ, so a thread stages one pair q (its
      // (p, k) found once a step) at rows kRowStep apart.
      {
        const int qq = threadIdx.x % kQ;
        const int64_t q = q0 + qq;
        const bool live = q < nq;
        const int64_t p = live ? q / n_cols : 0, k = live ? q % n_cols : 0;
        const float* __restrict__ vr_q = v_rows + p * nr * n_cols + k;
        const float* __restrict__ vc_q = v_cols + p * n * n_cols + k;
        for (int r = threadIdx.x / kQ; r < kTile; r += kRowStep) {
          const int64_t i = i0 + r;
          vr_s[qq][r] = live && i < nr ? vr_q[i * n_cols] : 0.f;
#pragma unroll
          for (int t = 0; t < kRegTiles; ++t) {
            const int64_t j = (jt0 + sub + t) * kTile + r;
            vc_s[t][qq][r] = live && j < n ? vc_q[j * n_cols] : 0.f;
          }
        }
      }
      __syncthreads();
      // sum_{ii, jj} v_r[ii] D2[ii][jj] v_c[jj] over the thread's pairs
      float part[kQ];
#pragma unroll
      for (int qq = 0; qq < kQ; ++qq) {
        float y[kMicro] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int t = 0; t < kRegTiles; ++t) {
          const float4 c =
              *reinterpret_cast<const float4*>(&vc_s[t][qq][tx * kMicro]);
#pragma unroll
          for (int ii = 0; ii < kMicro; ++ii) {
            y[ii] = fmaf(d2[t][ii][0], c.x, y[ii]);
            y[ii] = fmaf(d2[t][ii][1], c.y, y[ii]);
            y[ii] = fmaf(d2[t][ii][2], c.z, y[ii]);
            y[ii] = fmaf(d2[t][ii][3], c.w, y[ii]);
          }
        }
        const float4 rv =
            *reinterpret_cast<const float4*>(&vr_s[qq][ty * kMicro]);
        float s = y[0] * rv.x;
        s = fmaf(y[1], rv.y, s);
        s = fmaf(y[2], rv.z, s);
        part[qq] = fmaf(y[3], rv.w, s);
      }
      transpose_reduce_step<16>(part, lane);
      transpose_reduce_step<8>(part, lane);
      transpose_reduce_step<4>(part, lane);
      transpose_reduce_step<2>(part, lane);
      transpose_reduce_step<1>(part, lane);
      warp_sum[warp][lane] = part[0];
      __syncthreads();
      // a fixed-order sum over the 8 warps; the block owns these partials,
      // so later register tiles of its strip add to them in place
      const int64_t q = q0 + threadIdx.x;
      if (threadIdx.x < kQ && q < nq) {
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) s += warp_sum[w][threadIdx.x];
        s *= 0.5f;
        out[q] = sub == 0 ? s : out[q] + s;
      }
    }
  }
#pragma unroll
  for (int ii = 0; ii < kMicro; ++ii) {
    const int64_t i = i0 + ty * kMicro + ii;
    if (tx == 0 && i < nr) rs_part[i * n_strips + blockIdx.y] = rsum[ii];
  }
}

template <class M, class L>
int launch(const void* xr, const void* xc, const void* scale,
           const void* g_rows, const void* g_cols, const void* inv_gs,
           void* sw_part, void* rs_part, int64_t nr, int64_t n, int64_t d,
           int64_t n_perms, int n_groups, int64_t row_offset,
           int64_t n_valid, cudaStream_t stream) {
  using T = typename L::T;
  const dim3 grid((unsigned)((n + kTile - 1) / kTile),
                  (unsigned)((nr + kTile - 1) / kTile));
  fused_sw_kernel<M, L><<<grid, kThreads, 0, stream>>>(
      (const T*)xr, (const T*)xc, (const float*)scale, (const int*)g_rows,
      (const int*)g_cols, (const float*)inv_gs, (float*)sw_part,
      (float*)rs_part, nr, n, d, n_perms, n_groups, row_offset, n_valid);
  return (int)cudaGetLastError();
}

template <class M, class L>
int launch_cols(const void* xr, const void* xc, const void* scale,
                const void* v_rows, const void* v_cols, void* s_part,
                void* rs_part, int64_t nr, int64_t n, int64_t d,
                int64_t n_perms, int64_t n_cols, int64_t row_offset,
                int64_t n_valid, cudaStream_t stream) {
  using T = typename L::T;
  const int64_t ntj = (n + kTile - 1) / kTile;
  const dim3 grid((unsigned)((nr + kTile - 1) / kTile),
                  (unsigned)((ntj + kStripTiles - 1) / kStripTiles));
  fused_sw_cols_kernel<M, L><<<grid, kThreads, 0, stream>>>(
      (const T*)xr, (const T*)xc, (const float*)scale, (const float*)v_rows,
      (const float*)v_cols, (float*)s_part, (float*)rs_part, nr, n, d,
      n_perms, n_cols, row_offset, n_valid);
  return (int)cudaGetLastError();
}

// The metric switch of both C entries (kind: 0 braycurtis, 1 euclidean,
// 2 jaccard) for one feature loader L.
template <class L, class... A>
int launch_kind(int kind, A... a) {
  switch (kind) {
    case 0:
      return launch<BrayCurtis, L>(a...);
    case 1:
      return launch<Euclidean, L>(a...);
    case 2:
      return launch<Jaccard, L>(a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <class L, class... A>
int launch_cols_kind(int kind, A... a) {
  switch (kind) {
    case 0:
      return launch_cols<BrayCurtis, L>(a...);
    case 1:
      return launch_cols<Euclidean, L>(a...);
    case 2:
      return launch_cols<Jaccard, L>(a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// out: kTile, kPermBlock, kThreads.
void fused_sw_config(int* out) {
  out[0] = kTile;
  out[1] = kPermBlock;
  out[2] = kThreads;
}

// out: kStripTiles, kRegTiles, kQ.
void fused_sw_cols_config(int* out) {
  out[0] = kStripTiles;
  out[1] = kRegTiles;
  out[2] = kQ;
}

// kind: 0 braycurtis, 1 euclidean, 2 jaccard. mode: 0 f32, 1 bf16, 2 fp8
// e4m3 (scale: one f32 on the device, the dequantization factor), 3 packed
// 32-bit presence words (jaccard only; d counts words). xr (nr, d), xc (n,
// d) of the mode's type; g_rows (P, nr), g_cols (P, n) int32; inv_gs (G,)
// f32. sw_part (ceil(nr/64) * ceil(n/64), P) and rs_part (nr, ceil(n/64))
// f32.
int fused_sw_launch(int kind, int mode, const void* xr, const void* xc,
                    const void* scale, const void* g_rows,
                    const void* g_cols, const void* inv_gs, void* sw_part,
                    void* rs_part, long long nr, long long n, long long d,
                    long long n_perms, int n_groups, long long row_offset,
                    long long n_valid, void* stream) {
  if (nr < 1 || n < 1 || d < 1 || n_perms < 1 || n_groups < 1 ||
      row_offset < 0 || n_valid < 1 || n_valid > n ||
      (nr + kTile - 1) / kTile > kMaxGridY ||
      (n + kTile - 1) / kTile > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return launch_kind<F32In>(kind, xr, xc, scale, g_rows, g_cols, inv_gs,
                                sw_part, rs_part, nr, n, d, n_perms,
                                n_groups, row_offset, n_valid, s);
    case 1:
      return launch_kind<Bf16In>(kind, xr, xc, scale, g_rows, g_cols,
                                 inv_gs, sw_part, rs_part, nr, n, d, n_perms,
                                 n_groups, row_offset, n_valid, s);
    case 2:
      if (scale == nullptr) return (int)cudaErrorInvalidValue;
      return launch_kind<Fp8In>(kind, xr, xc, scale, g_rows, g_cols, inv_gs,
                                sw_part, rs_part, nr, n, d, n_perms,
                                n_groups, row_offset, n_valid, s);
    case 3:
      if (kind != 2) return (int)cudaErrorInvalidValue;
      return launch<PackedJaccard, PackedIn>(
          xr, xc, scale, g_rows, g_cols, inv_gs, sw_part, rs_part, nr, n, d,
          n_perms, n_groups, row_offset, n_valid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// kind and mode as fused_sw_launch's. xr (nr, d), xc (n, d) of the mode's
// type; v_rows (P, nr, K), v_cols (P, n, K) f32. s_part (n_strips *
// ceil(nr/64), P * K) and rs_part (nr, n_strips) f32, n_strips =
// ceil(ceil(n/64) / kStripTiles).
int fused_sw_cols_launch(int kind, int mode, const void* xr, const void* xc,
                         const void* scale, const void* v_rows,
                         const void* v_cols, void* s_part, void* rs_part,
                         long long nr, long long n, long long d,
                         long long n_perms, long long n_cols,
                         long long row_offset, long long n_valid,
                         void* stream) {
  const long long ntj = (n + kTile - 1) / kTile;
  if (nr < 1 || n < 1 || d < 1 || n_perms < 1 || n_cols < 1 ||
      row_offset < 0 || n_valid < 1 || n_valid > n ||
      (nr + kTile - 1) / kTile > 0x7fffffffLL ||
      (ntj + kStripTiles - 1) / kStripTiles > kMaxGridY)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return launch_cols_kind<F32In>(kind, xr, xc, scale, v_rows, v_cols,
                                     s_part, rs_part, nr, n, d, n_perms,
                                     n_cols, row_offset, n_valid, s);
    case 1:
      return launch_cols_kind<Bf16In>(kind, xr, xc, scale, v_rows, v_cols,
                                      s_part, rs_part, nr, n, d, n_perms,
                                      n_cols, row_offset, n_valid, s);
    case 2:
      if (scale == nullptr) return (int)cudaErrorInvalidValue;
      return launch_cols_kind<Fp8In>(kind, xr, xc, scale, v_rows, v_cols,
                                     s_part, rs_part, nr, n, d, n_perms,
                                     n_cols, row_offset, n_valid, s);
    case 3:
      if (kind != 2) return (int)cudaErrorInvalidValue;
      return launch_cols<PackedJaccard, PackedIn>(
          xr, xc, scale, v_rows, v_cols, s_part, rs_part, nr, n, d, n_perms,
          n_cols, row_offset, n_valid, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
