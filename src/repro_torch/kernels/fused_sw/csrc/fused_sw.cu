// Fused distance -> s_W megakernels on Hopper (sm_90a). For a row slab
// xr (nr, d) whose first row is global sample `row_offset`, against the
// full table xc (n, d), and permuted labels g_rows (P, nr) / g_cols (P, n),
// one launch gives
//
//   s_W[p]   = 1/2 sum_{r, c valid, r != c} D2[r, c] * 1[g_r == g_c] / n_{g_r}
//   rows[r]  = sum_c D2[r, c]                       (the Gower row sums)
//
// as partials of a fixed number of slots, summed in a fixed order by a
// second kernel, and never writes D2 to device memory. D2 is the
// metric's squared distance:
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
// here a block of 256 threads owns one row tile of 64 rows and a strip of
// kSwStripTiles = 16 column tiles, and every permutation of the launch:
//
//   symmetry        a call over the whole table against itself (the
//                   sweep's: the same features, the same label storage,
//                   offset 0) visits the column tiles j >= i only: off-
//                   diagonal tiles count once at weight 1, diagonal tiles
//                   keep 1/2, and each off-diagonal tile's column sums go
//                   to a second set of row-sum partials (the rows of its
//                   columns), so the row sums stay exact. A slab call with
//                   an offset visits every tile at 1/2, so disjoint slabs
//                   still sum to the whole statistic.
//   feature phase   per tile, once: 32-feature chunks staged transposed in
//                   shared memory, each thread a 4 x 4 micro-tile of
//                   accumulators in registers (the layout the distance
//                   kernels had before their 128 x 128 tiles; their
//                   metric bodies, kernels/distance/csrc/distance.cu, are
//                   copied below with a squared finalize)
//   finalize        D2 and the mask by GLOBAL index, once: slab pad rows,
//                   row_offset + r >= n_valid, c >= n_valid and the exact
//                   diagonal row_offset + r == c are zeroed before anything
//                   reads the tile (the euclidean self pair is not 0 in f32);
//                   the row sums accumulate in registers over the strip,
//                   and the tile goes, weighted, into shared memory (16 KB)
//   permutations    brute's pattern (permanova_sw.cu, sw_brute_kernel): in
//                   passes of kSwPass = 128 permutations, the columns'
//                   int32 labels (68-int rows) come through a two-stage
//                   cp.async ring; warp w owns tile rows 8w + [0, 8), lane l
//                   the permutations l + 32k (k < 4), with their row labels
//                   and one accumulator per (row, permutation) in
//                   registers, and per 4 columns does `if (g_r == g_c) acc
//                   += m` (an integer compare and a predicated add) 128
//                   times. w[g_r] is applied once per (row, permutation) a
//                   pass; the 8 warps' sums are added in a fixed order once
//                   per (tile, pass) into the slot's running s_W, which
//                   lives in its own partial row (one value per (slot,
//                   permutation), read and rewritten by the same thread)
//   slots           the grid is min(kSwSlots, items) blocks; block s walks
//                   the work items (row tile, strip) s, s + slots, ... and
//                   carries its partial row across them, so the partials
//                   are slots x P floats whatever n (16 KiB a permutation,
//                   a sixth of the labels' 4 n bytes at n = 25,145), and one
//                   f64 D2 total a slot (for s_T). The row sums are written
//                   only when the caller asks for them (rs_part not null,
//                   (strips + row tiles) x n floats); the sweeps take the
//                   totals. Before, one partial row per item and (strips +
//                   row tiles) x n row sums grew as n^2 / 64 (633.6 MiB at
//                   n = 100,000, over the 256 MiB budget that sized them)
//
// What bounded the first port (36.7 ms a 156-permutation chunk on an H100
// SXM at 700 W, ~18x its bound): every 16 permutations cost a staging pass
// and 3 barriers, every permutation 16 compare-selects and 4 FMAs a thread
// and then a 5-step shuffle tree, a shared write and a cross-warp sum, so
// the reduction cost about as much as the work; the full square was
// computed; and its partials, one per (64 x 64 tile, permutation), grew
// with tiles x P and held the plan to chunks of 156, so the feature phase
// ran 26 times a test. The partials now grow with slots x P (4,096 x P
// floats), so the plan takes chunks of thousands. The same-group form
// weights each pair by 1/n_g once, where the reference multiplies
// sqrt(1/n_g) from both sides; the two differ by rounding only. The slot
// sum (slot_sum_kernel) adds the slots in an order that does not depend on
// P, in double: no float atomics, the same bits every run and in every
// chunk. The slot walk costs the labels kernel nothing measurable; a slot
// sum of one thread a q (a dependent chain of 4,096 loads) cost ~1-2 ms,
// so 8 warps split the slots.
//
// Bound on an H100 SXM at 700 W at the main path's shape (n = 25,145,
// d = 128, G = 8, the plan's chunk of P = 1,792), each unordered pair
// once: the feature phase is n(n-1) d = 8.1e10 operations (1.2 ms at 67
// TFLOP/s f32) and the permutation phase P (n(n-1)/2 + matches) = 6.4e11
// (9.5 ms); the inputs are 13 MB of features and 180 MB of labels (0.06 ms
// of HBM), so it is bound by operations, 10.7 ms. This formulation's own
// floor is brute's: one INT32 compare per (pair, permutation) at 64 lanes
// x 132 SMs x 1.98 GHz, 33.9 ms, beside the feature phase at the f32 peak.
// What holds it now: 73.4 ms, 46% of that floor; a further permutation
// costs 0.0355 ms (brute's 0.0346), two instructions an update (a
// compare and a predicated add) at about half the rate the schedulers
// allow, and the feature phase takes ~4.9 ms a launch. Each chunk
// rebuilds its D2 tiles (the reference's design: the footprint does not
// grow with n^2). Tried and dropped: the column loop unrolled 4 (barely
// faster, with spills; unrolled 1, kept, spills nothing) and strips of 32
// tiles (half the partials, so two launches a 4,000-slot test in place of
// three, slightly shorter in all, but each launch slower for its longer
// tail). Tensor cores are not used: the labels form
// is a compare and an add, and the exact one-hot wgmma product of the
// permanova_sw matmul kernel loses to it by ~4x a permutation.
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
// last step; a CUDA block must not. Its permutation phase is a matrix
// product, Y = D2 (64 rows x the strip's columns) . V_c (those columns x Q,
// Q = P K), then s[q] += sum_r v_r[r, q] Y[r, q]; with Q = 1,270 at the
// EMP design chunk (n = 25,145, P = 127, K = 10) it is 2 n^2 Q = 1.6e12 of
// the kernel's 1.77e12 operations. What bounded the first port (88 ms a
// chunk on an H100 SXM at 700 W, ~21.5 TFLOP/s in that phase): every 32 q
// paid three barriers, a staging pass reading v_cols K floats apart and a
// 31-shuffle transposed reduction, each staged basis float4 served 4 rows,
// and the full square was computed. This design:
//
//   symmetry        a call over the whole table against itself (the design
//                   sweep's) visits the column tiles j >= i only: off-
//                   diagonal tiles count once at weight 1, diagonal tiles
//                   keep 1/2, and each off-diagonal tile's column sums are
//                   the Gower row sums of its columns' rows (a second set
//                   of row-sum partials), so the row sums stay exact. Both
//                   phases halve. A slab call with an offset keeps the
//                   full tiles at weight 1/2, so summing disjoint slabs
//                   still gives the whole statistic.
//   tensor cores    the product runs as wgmma m64n64k8 in 3xTF32: neither
//                   D2 nor the basis is 0/1, so both are split, hi =
//                   tf32(x) and lo = tf32(x - hi), and hi.hi + hi.lo +
//                   lo.hi carries ~22 bits (lo.lo is below f32's
//                   rounding; one TF32 product keeps 11, which the f32
//                   bars reject). A block holds its strip's kStripTiles = 2
//                   D2 tiles in shared memory as B (hi and lo tiles,
//                   written split by the feature phase); per pass of 128 q
//                   each of its two warpgroups takes 64 q as A from
//                   registers, split as they are loaded from a four-stage
//                   cp.async ring of the basis (16 columns a stage,
//                   [c][q]). The tensor cores truncate as they accumulate,
//                   so a stage's 6 products go into a fresh accumulator
//                   that joins the f32 sums with a rounded add; that
//                   leaves s ~2e-7 s_T from fp64 at the EMP design chunk
//                   (the f32 bar is 1e-6 s_T), with a signed drift of ~-2e-8
//                   s_T. The v_r reduction runs once per (strip, pass): a
//                   thread's 16 rows, then its quad's shuffles.
//
// Its grid is min(kColsSlots = 2,048, items) slots, each walking its items
// s, s + slots, ... with one running partial per (slot, q) (80 KiB a
// permutation at K = 10, against the 1.06 MiB of index and basis it
// gathers) and one f64 D2 total; the row sums only when the caller asks
// (as the labels kernel's); the slot sum adds the slots in a fixed order:
// no atomics, the same bits every run and in every chunk. Each pass loads
// its running partials at its start, so the load is not waited for at its
// end. The walk costs ~10% against one block an item (29 ms at P = 127
// -> ~32 ms on an H100 SXM at 700 W): ~1 ms the tail of the last wave
// (8,192 slots recover it, with partials that would cut the chunk to
// 128), ~2 ms not pinned down without a profiler: not the slot sum, not
// the registers (128, no spills, the item body inlined or not), not the
// order of the items. 132 SMs hold two blocks each
// (100,352 B of dynamic shared memory, <= 128 registers a thread). A row
// tile made only of pad rows (row_offset + i0 >= n_valid, the reference's
// row_live) adds nothing and skips both phases.
//
// Its bound at the EMP design chunk on an H100 SXM at 700 W, each
// unordered pair once: n(n-1) (d + P K) = 8.8e11 operations, 13.2 ms at
// 67 TFLOP/s f32 (the function's bound; the inputs, features 13 MB and
// each basis factor 128 MB, take ~0.08 ms of HBM; before this design it
// was counted over the full square, 26.4 ms, which the packed mode now
// beats). This formulation's own floors, over the same half: the feature
// phase 1.21 ms at the f32 peak and the three TF32 products 4.87 ms at
// 495 TFLOP/s dense. What holds it now: the
// product runs at ~25% of the TF32 peak (~20 ms of ~29), and the integer
// work around each stage's 6 products counts (copies from precomputed
// pointers and descriptors built by adding offsets gained 4%); the same
// product on the CUDA cores (8 x 8 register tiles of Y) was ~10% slower, a
// deeper ring (2 -> 4 stages) gained 2.5%, two accumulator chains in
// flight lost 12% to spills, and 12 products a wait gained 1% but doubled
// the drift. The feature phase (~8.5 ms) runs at two blocks an SM.

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
// --use_fast_math). Shared memory: 90,112 B dynamic and 512 B static
// (labels); 100,352 B dynamic and 512 B static (dense design). Both
// kernels run two blocks an SM (<= 128 registers a thread).
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
constexpr int kD2Floats = kTile * kTile;
// the labels kernel (fused_sw_kernel)
constexpr int kSwStripTiles = 16;      // column tiles a block walks
constexpr int kSwPass = 128;           // permutations a pass
constexpr int kSwWarpRows = kTile / kWarps;       // 8 tile rows a warp
constexpr int kSwLanePerms = kSwPass / 32;        // 4 permutations a lane
constexpr int kLabLd = kTile + 4;      // a staged label row: 68 ints
constexpr int kLabStage = kSwPass * kLabLd;       // ints a ring stage
// dynamic shared memory: two ring stages of column labels (the stage not
// in flight also holds the feature phase's staged chunks), the weighted
// D2 tile [r][c] and the warps' sums [warp][p]
constexpr int kSwSmemBytes =
    (2 * kLabStage + kD2Floats + kWarps * kSwPass) * 4;   // 90,112
static_assert(kSwPass % 32 == 0 && kTile % kWarps == 0 && kTile % 4 == 0,
              "whole lanes, warps and vectors");
static_assert(kThreads % kTile == 0 && kSwPass * kTile % kThreads == 0,
              "a thread copies one column of the staged labels");
static_assert(kLabStage >= 2 * kChunk * kPitch,
              "a ring stage holds the feature staging");
static_assert(kThreads >= kSwPass, "a thread sums a permutation");
// the dense-design kernel (fused_sw_cols_kernel)
constexpr int kStripTiles = 2;         // column tiles a block sums over
constexpr int kQPass = 128;            // (permutation, column) pairs a pass
constexpr int kKc = 16;                // basis columns a ring stage (2 k8)
constexpr int kVLd = kQPass + 8;       // a staged basis row: 136 floats
constexpr int kColsStages = 4;         // cp.async ring depth
// a D2 tile as wgmma's B operand: K-major (the columns c of a row r), no
// swizzle, 8 x 16-byte core matrices; the two along k kLbo bytes apart,
// the 8-row groups kSbo apart, a k-step's 64 rows x 8 columns kBStep
constexpr int kLbo = 128, kSbo = 256, kBStep = kTile / 8 * kSbo;
// dynamic shared memory: the strip's D2 tiles (hi and lo halves each),
// then a ring of basis stages (which first holds the feature phase's
// staged chunks, then the column-sum partials)
constexpr int kRingFloats = kColsStages * kKc * kVLd;
constexpr int kColsSmemBytes =
    (kStripTiles * 2 * kD2Floats + kRingFloats) * 4;   // 100,352
static_assert(2 * kQPass == kThreads, "two threads stage a q");
static_assert(kTile % kKc == 0 && kKc % 16 == 0, "whole k-steps a stage");
static_assert(kQPass == 2 * 64, "two warpgroups of 64 q");
static_assert(kRingFloats >= 2 * kChunk * kPitch,
              "the ring holds the feature staging");
static_assert(kRingFloats >= kStripTiles * 16 * kTile,
              "the ring holds the column-sum partials");
// Both kernels: the grid is min(slots, work items) blocks, a block the
// slot of its index; slot s walks the work items (row tile, strip) s, s +
// slots, s + 2 slots, ... in that order and keeps one running partial per
// permutation (or q) across them. The map depends on the call's shape
// alone (never on P or on the card), so a permutation's partials and
// their sum are the same bits for any chunking.
constexpr int kSwSlots = 4096;         // labels: 1-2 items a slot at the
                                       // EMP shape (2-3 at 2,048 left a
                                       // longer tail)
constexpr int kColsSlots = 2048;       // dense design: its partials are K
                                       // floats a permutation a slot
// The slot sum: a block of kSumWarps warps takes 32 q (a lane a q); warp w
// adds the slots w, w + kSumWarps, ... in order, and the warps' sums are
// added in warp order: a fixed order that does not depend on Q.
constexpr int kSumWarps = 8;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// 4-byte asynchronous copy global -> shared; src_bytes 0 writes a zero and
// reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
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

// A work item's tiles, for strips of S column tiles (both kernels). A
// symmetric call (the whole table against itself) visits the column tiles
// j >= i only: its items are the strips of S column tiles that start at
// the diagonal and every S tiles after it, numbered strip offset first (c
// = 0 for every row tile, then c = 1, ...). A slab call visits every
// column tile: item b is row tile b % nti and strip b / nti. `slot`
// numbers the item's row-sum partial row: its strip (offset).
struct TileBlock {
  int64_t ti, jt0, slot;
};

template <int S>
__host__ __device__ inline int64_t strip_count(int64_t ntj) {
  return (ntj + S - 1) / S;
}

template <int S>
__host__ __device__ inline int64_t n_blocks(int64_t nti, int64_t ntj,
                                            int sym) {
  if (!sym) return nti * strip_count<S>(ntj);
  int64_t total = 0;
  for (int64_t c = 0; c < strip_count<S>(ntj); ++c) total += ntj - c * S;
  return total;
}

// Blocks of a launch: one a slot, at most one a work item.
template <int S, int kMaxSlots>
__host__ __device__ inline int64_t n_slots(int64_t nti, int64_t ntj,
                                           int sym) {
  const int64_t items = n_blocks<S>(nti, ntj, sym);
  return items < kMaxSlots ? items : kMaxSlots;
}

// The slot's D2 total: each thread adds its share into its own entry of
// tot (shared memory, so no register is held across the item loop), and
// thread 0 sums the entries in thread order in double (a fixed order).
__device__ __forceinline__ void slot_total(const double* tot,
                                           double* tot_part) {
  __syncthreads();   // every thread's last share is in
  if (threadIdx.x == 0) {
    double s = 0.0;
    for (int t = 0; t < kThreads; ++t) s += tot[t];
    tot_part[blockIdx.x] = s;
  }
}

template <int S>
__device__ __forceinline__ TileBlock tile_block(int64_t b, int64_t nti,
                                                int64_t ntj, int sym) {
  if (!sym) return {b % nti, (b / nti) * S, b / nti};
  int64_t c = 0;
  while (b >= ntj - c * S) {
    b -= ntj - c * S;
    ++c;
  }
  return {b, b + c * S, c};
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

__device__ __forceinline__ float row_weight(int g, const float* w,
                                            int n_groups) {
  return (g >= 0 && g < n_groups) ? __ldg(w + g) : 0.f;
}

// Grid: n_slots<kSwStripTiles>(nti, ntj, sym) blocks of 256 threads, one
// a slot. Slot s walks the work items b = s, s + slots, ...: item (ti,
// jt0) is slab rows ti*64 + [0, 64), the column tiles jt0 + [0,
// kSwStripTiles) and every permutation. Per tile: the feature phase
// (thread (ty, tx) holds rows 4 ty + [0, 4) x columns 4 tx + [0, 4)), the
// weighted D2 tile into shared memory, then the tile's passes; the steps
// s = t * n_pass + q (tile t, pass q) take their column labels from ring
// stage s % 2, copied during step s - 1.
// sw_part: (slots, P), one running s_W per (slot, permutation) over its
// items. tot_part: (slots,) f64, the slot's D2 total (every ordered pair
// of its tiles, a symmetric call's off-diagonal tiles twice), so the
// slots sum to the slab's row sums' total. rs_part (optional, zeroed by
// the caller): row sums at [strip, i] for strips < n_strips, and for a
// symmetric call the column sums of the off-diagonal tiles of row tile ti
// at [n_strips + ti, j].
template <class M, class L>
__global__ void __launch_bounds__(kThreads, 2)
fused_sw_kernel(const typename L::T* __restrict__ xr,
                const typename L::T* __restrict__ xc,
                const float* __restrict__ scale,
                const int* __restrict__ g_rows,
                const int* __restrict__ g_cols,
                const float* __restrict__ inv_gs,
                float* __restrict__ sw_part, double* __restrict__ tot_part,
                float* __restrict__ rs_part, int64_t nr, int64_t n,
                int64_t d, int64_t n_perms, int n_groups, int64_t row_offset,
                int64_t n_valid, int sym) {
  extern __shared__ __align__(16) int sw_smem[];
  float* d2s = reinterpret_cast<float*>(sw_smem + 2 * kLabStage);  // [r][c]
  float* red = d2s + kD2Floats;                                 // [warp][p]
  __shared__ float row_stat[kTile];
  __shared__ float col_stat[kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int64_t nti = (nr + kTile - 1) / kTile;
  const int64_t ntj = (n + kTile - 1) / kTile;
  const int64_t n_strips = strip_count<kSwStripTiles>(ntj);
  const int64_t n_items = n_blocks<kSwStripTiles>(nti, ntj, sym);
  float* __restrict__ out = sw_part + (int64_t)blockIdx.x * n_perms;
  // out[p] is zeroed, and later rewritten, by thread p % kSwPass
  if (tid < kSwPass)
    for (int64_t p = tid; p < n_perms; p += kSwPass) out[p] = 0.f;

  const int64_t n_pass = (n_perms + kSwPass - 1) / kSwPass;
  const float xscale = L::scale(scale);
  const int rw = warp * kSwWarpRows;   // the warp's first tile row
  constexpr int kCopyPerms = kThreads / kTile;   // 4 permutations a sweep
  __shared__ double tot[kThreads];   // each thread's share of the slot's
  tot[tid] = 0.0;                    // D2 total
  for (int64_t b = blockIdx.x; b < n_items; b += gridDim.x) {
    const TileBlock blk = tile_block<kSwStripTiles>(b, nti, ntj, sym);
    const int n_t = (int)min64(kSwStripTiles, ntj - blk.jt0);
    const int64_t i0 = blk.ti * kTile;   // slab-local rows
    // A row tile made only of pad rows (an offset slab past n_valid) has
    // nothing to add (and in a symmetric call neither have its columns).
    if (row_offset + i0 >= n_valid) continue;
    __syncthreads();   // the previous item's readers of shared memory
                       // are done

    const int64_t steps = n_t * n_pass;
    // Start the copies of step s's column labels into its ring stage:
    // thread tid copies column tid % 64 of permutations tid / 64 + 4u. A
    // label past P (whose row labels are -1) or past n (whose D2 is 0) is
    // a zero, which adds nothing.
    auto start_copies = [&](int64_t s) {
      const int64_t jt = blk.jt0 + s / n_pass, p0 = (s % n_pass) * kSwPass;
      const int c = tid % kTile, q0 = tid / kTile;
      const int64_t j = jt * kTile + c;
      int* dst = sw_smem + (s & 1) * kLabStage + q0 * kLabLd + c;
      const int* src = g_cols + (p0 + q0) * n + j;
#pragma unroll 4
      for (int u = 0; u < kSwPass / kCopyPerms; ++u) {
        const bool ok = j < n && p0 + q0 + kCopyPerms * u < n_perms;
        cp_async4(dst + kCopyPerms * u * kLabLd, ok ? src : g_cols,
                  ok ? 4 : 0);
        src += kCopyPerms * n;
      }
    };
    start_copies(0);
    cp_async_commit();

    float rsum[kMicro] = {0.f, 0.f, 0.f, 0.f};
    for (int t = 0; t < n_t; ++t) {
      const int64_t jt = blk.jt0 + t;
      // ---- feature phase and finalize: the masked D2 tile in registers --
      // Staged in the ring stage that is not in flight (step t * n_pass -
      // 1's, whose readers finished before that step's last barrier).
      float* stage = reinterpret_cast<float*>(
          sw_smem + ((t * n_pass + 1) & 1) * kLabStage);
      auto& rs = *reinterpret_cast<float (*)[kChunk][kPitch]>(stage);
      auto& cs = *reinterpret_cast<float (*)[kChunk][kPitch]>(
          stage + kChunk * kPitch);
      float d2[kMicro][kMicro];
      feature_tile<M, L>(xr, xc, xscale, nr, n, d, i0, jt * kTile,
                         row_offset, n_valid, rs, cs, row_stat, col_stat,
                         d2);
#pragma unroll
      for (int ii = 0; ii < kMicro; ++ii) rsum[ii] += tile_row_sum(d2, ii);
      // Weighted as it is stored: 1/2 where both orders of a pair are
      // visited (every tile of a slab call, the diagonal tile of a
      // symmetric one), 1 for a symmetric call's off-diagonal tiles, which
      // stand for their mirror images too; both weights are exact.
      const bool mirrored = sym && jt != blk.ti;
      const float wt = mirrored ? 1.f : 0.5f;
#pragma unroll
      for (int ii = 0; ii < kMicro; ++ii)
        *reinterpret_cast<float4*>(d2s + (ty * kMicro + ii) * kTile +
                                   tx * kMicro) =
            make_float4(wt * d2[ii][0], wt * d2[ii][1], wt * d2[ii][2],
                        wt * d2[ii][3]);

      // ---- permutation phase: the tile's passes ----------------------------
      for (int64_t q = 0; q < n_pass; ++q) {
        const int64_t s = t * n_pass + q;
        cp_async_wait<0>();
        __syncthreads();   // step s's labels and the D2 tile are complete;
                           // step s - 1's readers of the other stage are
                           // done
        if (q == 0 && mirrored && tid < kTile) {
          // an off-diagonal tile's column sums are its columns' rows' sums
          const int64_t j = jt * kTile + tid;
          float cs_sum = 0.f;
          for (int r = 0; r < kTile; ++r) cs_sum += d2s[r * kTile + tid];
          tot[tid] += cs_sum;
          if (rs_part != nullptr && j < n)
            rs_part[(n_strips + blk.ti) * n + j] = cs_sum;
        }
        if (s + 1 < steps) start_copies(s + 1);
        cp_async_commit();

        const int64_t p0 = q * kSwPass;
        // row labels of (tile row rw + r, permutation p0 + lane + 32k); -1
        // past nr or P
        int gr[kSwWarpRows][kSwLanePerms];
        float acc[kSwWarpRows][kSwLanePerms];
#pragma unroll
        for (int k = 0; k < kSwLanePerms; ++k) {
          const int64_t p = p0 + lane + 32 * k;
          const int* src = g_rows + p * nr + i0 + rw;
#pragma unroll
          for (int r = 0; r < kSwWarpRows; ++r) {
            gr[r][k] = p < n_perms && i0 + rw + r < nr ? __ldg(src + r) : -1;
            acc[r][k] = 0.f;
          }
        }
        const float* ms = d2s + rw * kTile;
        const int* lab = sw_smem + (s & 1) * kLabStage + lane * kLabLd;
#pragma unroll 1
        for (int c = 0; c < kTile; c += 4) {
          int4 gc[kSwLanePerms];
#pragma unroll
          for (int k = 0; k < kSwLanePerms; ++k)
            gc[k] = *reinterpret_cast<const int4*>(lab + 32 * k * kLabLd + c);
#pragma unroll
          for (int r = 0; r < kSwWarpRows; ++r) {
            const float4 m =
                *reinterpret_cast<const float4*>(ms + r * kTile + c);
#pragma unroll
            for (int k = 0; k < kSwLanePerms; ++k) {
              const int g = gr[r][k];
              if (g == gc[k].x) acc[r][k] += m.x;
              if (g == gc[k].y) acc[r][k] += m.y;
              if (g == gc[k].z) acc[r][k] += m.z;
              if (g == gc[k].w) acc[r][k] += m.w;
            }
          }
        }
        // w[g_r] once per (row, permutation), then the warps in a fixed
        // order into the slot's running s_W
#pragma unroll
        for (int k = 0; k < kSwLanePerms; ++k) {
          float v = 0.f;
#pragma unroll
          for (int r = 0; r < kSwWarpRows; ++r)
            v = fmaf(acc[r][k], row_weight(gr[r][k], inv_gs, n_groups), v);
          red[warp * kSwPass + lane + 32 * k] = v;
        }
        __syncthreads();
        const int64_t p = p0 + tid;
        if (tid < kSwPass && p < n_perms) {
          float v = 0.f;
#pragma unroll
          for (int w = 0; w < kWarps; ++w) v += red[w * kSwPass + tid];
          out[p] += v;
        }
      }
    }
    cp_async_wait<0>();

    // ---- Gower row sums: the strip's rows ----------------------------------
#pragma unroll
    for (int ii = 0; ii < kMicro; ++ii) {
      const int64_t i = i0 + ty * kMicro + ii;
      if (tx == 0 && i < nr) {
        tot[tid] += rsum[ii];
        if (rs_part != nullptr) rs_part[blk.slot * nr + i] = rsum[ii];
      }
    }
  }
  slot_total(tot, tot_part);
}

// x rounded to TF32, round to nearest with ties away (a .b32 pattern whose
// low 13 bits are zero).
__device__ __forceinline__ uint32_t tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// Shared-memory stores of this thread become visible to the tensor cores'
// (async proxy) reads of the B tiles.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
// d (+)= a . B: m64n64k8, tf32 A from registers (4 a thread), B from
// shared memory; scale_d 0 starts a fresh sum, 1 adds to d.
__device__ __forceinline__ void wgmma_tf32(float* d, const uint32_t* a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// Byte offset of D2 element (row r, column c) of a tile in the B layout.
__device__ __forceinline__ int b_offset(int r, int c) {
  return (c / 8) * kBStep + (r / 8) * kSbo + ((c % 8) / 4) * kLbo +
         (r % 8) * 16 + (c % 4) * 4;
}

// Grid: n_slots<kStripTiles>(nti, ntj, sym) blocks of 256 threads (two
// warpgroups), one a slot. Slot s walks the work items b = s, s + slots,
// ...: item (ti, jt0) is slab rows ti*64 + [0, 64) and column tiles jt0 +
// [0, kStripTiles). Q = P * K (permutation, column) pairs, q = p * K + k.
// s_part: (slots, Q), one running partial per (slot, q) over its items.
// tot_part: (slots,) f64, the slot's D2 total (as the labels kernel's).
// rs_part (optional, zeroed by the caller): row sums at [strip, i] for
// strips < n_strips, and for a symmetric call the column sums of the
// off-diagonal tiles of row tile ti at [n_strips + ti, j].
template <class M, class L>
__global__ void __launch_bounds__(kThreads, 2)
fused_sw_cols_kernel(const typename L::T* __restrict__ xr,
                     const typename L::T* __restrict__ xc,
                     const float* __restrict__ scale,
                     const float* __restrict__ v_rows,
                     const float* __restrict__ v_cols,
                     float* __restrict__ s_part,
                     double* __restrict__ tot_part,
                     float* __restrict__ rs_part, int64_t nr, int64_t n,
                     int64_t d, int64_t n_perms, int64_t n_cols,
                     int64_t row_offset, int64_t n_valid, int sym) {
  extern __shared__ __align__(128) float cols_smem[];
  unsigned char* btiles = reinterpret_cast<unsigned char*>(cols_smem);
  float* ring = cols_smem + kStripTiles * 2 * kD2Floats;   // stages [c][q]
  // the feature phase stages its chunks where the ring will be
  auto& rs = *reinterpret_cast<float (*)[kChunk][kPitch]>(ring);
  auto& cs = *reinterpret_cast<float (*)[kChunk][kPitch]>(ring +
                                                         kChunk * kPitch);
  __shared__ float row_stat[kTile];
  __shared__ float col_stat[kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int lane = tid % 32, warp = tid / 32;
  const int64_t nti = (nr + kTile - 1) / kTile;
  const int64_t ntj = (n + kTile - 1) / kTile;
  const int64_t n_strips = strip_count<kStripTiles>(ntj);
  const int64_t n_items = n_blocks<kStripTiles>(nti, ntj, sym);
  const int64_t nq = n_perms * n_cols;
  float* __restrict__ out = s_part + (int64_t)blockIdx.x * nq;
  // zeroed before the first item's first barrier; every later write of
  // out[q] follows a barrier
  for (int64_t q = tid; q < nq; q += kThreads) out[q] = 0.f;

  const float xscale = L::scale(scale);
  const int wg = warp / 4;
  const int arow = (warp % 4) * 16 + lane / 4;   // A rows (q) arow, arow + 8
  const int tig = lane % 4;
  const int ql = tid % kQPass, ch = tid / kQPass;   // this thread's copies
  constexpr int kHalf = kKc / 2;   // columns a thread copies a stage
  const uint64_t desc0 = b_desc(btiles);   // stage offsets are added to it
  __shared__ double tot[kThreads];   // each thread's share of the slot's
  tot[tid] = 0.0;                    // D2 total
  for (int64_t b = blockIdx.x; b < n_items; b += gridDim.x) {
    const TileBlock blk = tile_block<kStripTiles>(b, nti, ntj, sym);
    const int n_t = (int)min64(kStripTiles, ntj - blk.jt0);
    const int64_t i0 = blk.ti * kTile;   // slab-local rows
    // A row tile made only of pad rows (an offset slab past n_valid) has
    // nothing to add (and in a symmetric call neither have its columns).
    if (row_offset + i0 >= n_valid) continue;
    __syncthreads();   // the previous item's readers of the ring and of
                       // the B tiles are done

    // ---- feature phase: the strip's masked D2 tiles into shared memory ---
    // Each tile is weighted as it is stored: 1/2 where both orders of a
    // pair are visited (every tile of a slab call, the diagonal tile of a
    // symmetric one), 1 for a symmetric call's off-diagonal tiles, which
    // stand for their mirror images too; both weights are exact. It is
    // stored split for the tensor cores, hi = tf32(x) and lo = tf32(x - hi)
    // (x - hi is exact in f32), as two B tiles.
    float rsum[kMicro] = {0.f, 0.f, 0.f, 0.f};
    float csum[kStripTiles][kMicro];   // this thread's 4 rows, per column
    for (int t = 0; t < n_t; ++t) {
      const int64_t jt = blk.jt0 + t;
      float d2[kMicro][kMicro];
      feature_tile<M, L>(xr, xc, xscale, nr, n, d, i0, jt * kTile,
                         row_offset, n_valid, rs, cs, row_stat, col_stat,
                         d2);
#pragma unroll
      for (int ii = 0; ii < kMicro; ++ii) rsum[ii] += tile_row_sum(d2, ii);
#pragma unroll
      for (int jj = 0; jj < kMicro; ++jj)
        csum[t][jj] = ((d2[0][jj] + d2[1][jj]) + d2[2][jj]) + d2[3][jj];
      const float wt = sym && jt != blk.ti ? 1.f : 0.5f;
      unsigned char* hi = btiles + t * 2 * kD2Floats * 4;
      unsigned char* lo = hi + kD2Floats * 4;
#pragma unroll
      for (int ii = 0; ii < kMicro; ++ii) {
        uint32_t h[kMicro], l[kMicro];
#pragma unroll
        for (int jj = 0; jj < kMicro; ++jj) {
          const float x = wt * d2[ii][jj];
          h[jj] = tf32_round(x);
          l[jj] = tf32_round(x - __uint_as_float(h[jj]));
        }
        const int off = b_offset(ty * kMicro + ii, tx * kMicro);
        *reinterpret_cast<uint4*>(hi + off) =
            make_uint4(h[0], h[1], h[2], h[3]);
        *reinterpret_cast<uint4*>(lo + off) =
            make_uint4(l[0], l[1], l[2], l[3]);
      }
    }
    fence_proxy_async();
    __syncthreads();   // the B tiles are complete; the staging area is free

    // ---- Gower row sums: the strip's rows, and (symmetric) its columns ---
#pragma unroll
    for (int ii = 0; ii < kMicro; ++ii) {
      const int64_t i = i0 + ty * kMicro + ii;
      if (tx == 0 && i < nr) {
        tot[tid] += rsum[ii];
        if (rs_part != nullptr) rs_part[blk.slot * nr + i] = rsum[ii];
      }
    }
    if (sym) {   // an off-diagonal tile's column sums are its columns' rows'
      for (int t = 0; t < n_t; ++t)
#pragma unroll
        for (int jj = 0; jj < kMicro; ++jj)
          ring[(t * 16 + ty) * kTile + tx * kMicro + jj] = csum[t][jj];
      __syncthreads();
      const int t = tid / kTile, c = tid % kTile;
      const int64_t j = (blk.jt0 + t) * kTile + c;
      if (t < n_t && blk.jt0 + t != blk.ti && j < n) {
        float s = 0.f;
        for (int y = 0; y < 16; ++y) s += ring[(t * 16 + y) * kTile + c];
        tot[tid] += s;
        if (rs_part != nullptr) rs_part[(n_strips + blk.ti) * n + j] = s;
      }
    }

    // ---- permutation phase: Y^T = V_c^T . D2^T on the tensor cores -------
    // Per pass of 128 q, warpgroup wg computes for its 64 q (M) and the row
    // tile's 64 rows r (N) the sum over every column c of the strip (K):
    // A = V_c^T from registers, B = the D2 tile from shared memory, in
    // three TF32 products of the split operands, hi.hi + hi.lo + lo.hi
    // (lo.lo is below f32's rounding). V_c goes through a four-stage
    // cp.async ring, 16 columns a stage ([c][q]; the basis is (P, n, K),
    // so a q's entries lie K floats apart down the columns), and is split
    // as it is loaded into A fragments. The tensor cores truncate as they
    // accumulate, so each stage's 6 products go into a fresh accumulator
    // that joins the f32 sums with a rounded add. Then s[q] += sum_r
    // v_r[r, q] Y[r, q]: a thread's 16 rows, then its quad (shuffles) in a
    // fixed order, into the slot's running partial.
    const int steps = n_t * (kTile / kKc);
    // its columns' offset from the strip's first, and the columns left
    const int64_t c_first = blk.jt0 * kTile + ch * kHalf;
    const int c_left = (int)min64(n - c_first, 0x7fffffff);
    for (int64_t q0 = 0; q0 < nq; q0 += kQPass) {
      const int64_t qs = q0 + ql;
      const bool q_ok = qs < nq;
      const float* vsrc =
          (q_ok ? v_cols + (qs / n_cols) * n * n_cols + qs % n_cols
                : v_cols) +
          c_first * n_cols;
      auto stage = [&](int st) {
        float* vs = ring + (st % kColsStages) * kKc * kVLd +
                    ch * kHalf * kVLd + ql;
        const float* src = vsrc + (int64_t)st * kKc * n_cols;
        const int rem = c_left - st * kKc;
#pragma unroll
        for (int cc = 0; cc < kHalf; ++cc) {
          const bool ok = q_ok && cc < rem;
          cp_async4(vs + cc * kVLd, ok ? src : v_cols, ok ? 4 : 0);
          src += n_cols;
        }
      };
      float acc[32], dd[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] = dd[i] = 0.f;
      const bool wg_live = q0 + 64 * wg < nq;   // any of its q < Q
      // the slot's running partials of this thread's two q, loaded now so
      // the load is not waited for at the pass's end
      float prev[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int64_t q = q0 + 64 * wg + arow + 8 * h;
        prev[h] = (wg_live && tig == 0 && q < nq) ? out[q] : 0.f;
      }
      __syncthreads();   // the ring's earlier readers are done
#pragma unroll
      for (int s = 0; s < kColsStages - 1; ++s) {
        if (s < steps) stage(s);
        cp_async_commit();
      }
      for (int st = 0; st < steps; ++st) {
        cp_async_wait<kColsStages - 2>();   // this thread's copies of st
        __syncthreads();   // everyone's; stage st - 1's readers are done
        if (st + kColsStages - 1 < steps) stage(st + kColsStages - 1);
        cp_async_commit();
        if (!wg_live) continue;
        const float* vs =
            ring + (st % kColsStages) * kKc * kVLd + 64 * wg + arow;
        // the stage's k-steps in the strip's B tiles: tile st / (kTile /
        // kKc), k-step (st % (kTile / kKc)) * kKc / 8 on
        const uint64_t bh0 =
            desc0 + (((st / (kTile / kKc)) * 2 * kD2Floats * 4 +
                      (st % (kTile / kKc)) * (kKc / 8) * kBStep) >> 4);
        constexpr uint64_t kLoDesc = kD2Floats * 4 >> 4,
                           kStepDesc = kBStep >> 4;
        uint32_t ah[kKc / 8][4], al[kKc / 8][4];
#pragma unroll
        for (int f = 0; f < kKc / 8; ++f) {
          const float* v0 = vs + (8 * f + tig) * kVLd;
          const float x[4] = {v0[0], v0[8], v0[4 * kVLd],
                              v0[4 * kVLd + 8]};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            ah[f][e] = tf32_round(x[e]);
            al[f][e] = tf32_round(x[e] - __uint_as_float(ah[f][e]));
          }
        }
        fence_regs(dd);
        wgmma_fence();
#pragma unroll
        for (int f = 0; f < kKc / 8; ++f) {
          const uint64_t bh = bh0 + f * kStepDesc, bl = bh + kLoDesc;
          wgmma_tf32(dd, ah[f], bh, f > 0);
          wgmma_tf32(dd, ah[f], bl, 1);
          wgmma_tf32(dd, al[f], bh, 1);
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dd);
#pragma unroll
        for (int i = 0; i < 32; ++i) acc[i] += dd[i];
      }
      cp_async_wait<0>();
      if (wg_live) {
        // acc[4i + 2h + e] is q = arow + 8h, row r = 8i + 2 tig + e
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int64_t q = q0 + 64 * wg + arow + 8 * h;
          float s = 0.f;
          if (q < nq) {
            const float* vq =
                v_rows + (q / n_cols) * nr * n_cols + q % n_cols;
#pragma unroll
            for (int i = 0; i < 8; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int64_t r = i0 + 8 * i + 2 * tig + e;
                if (r < nr)
                  s = fmaf(__ldg(vq + r * n_cols), acc[4 * i + 2 * h + e],
                           s);
              }
          }
          s += __shfl_xor_sync(0xffffffffu, s, 1);
          s += __shfl_xor_sync(0xffffffffu, s, 2);
          if (tig == 0 && q < nq) out[q] = prev[h] + s;
        }
      }
    }
  }
  slot_total(tot, tot_part);
}

// The fixed-order sum of a launch's slot partials (either kernel): out[q]
// = sum_s part[s, q] in double, rounded once to f32; block x takes q =
// 32 x + lane, warp w the slots w, w + kSumWarps, ... in order, then the
// warps' sums in warp order. Block 0 also sums tot_part (thread t the
// slots t, t + 256, ... in order, then the threads in order) into tot_out.
// Neither order depends on Q, so a permutation's s_W (or s_cols) is the
// same bits in any chunk.
__global__ void __launch_bounds__(kSumWarps * 32)
slot_sum_kernel(const float* __restrict__ part,
                const double* __restrict__ tot_part, int64_t slots,
                int64_t nq, float* __restrict__ out,
                double* __restrict__ tot_out) {
  __shared__ double red[kSumWarps * 32];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int64_t q = (int64_t)blockIdx.x * 32 + lane;
  double s = 0.0;
  if (q < nq) {
#pragma unroll 8
    for (int64_t k = warp; k < slots; k += kSumWarps) s += part[k * nq + q];
  }
  red[threadIdx.x] = s;
  __syncthreads();
  if (warp == 0 && q < nq) {
    double t = 0.0;
    for (int w = 0; w < kSumWarps; ++w) t += red[w * 32 + lane];
    out[q] = (float)t;
  }
  if (blockIdx.x != 0) return;
  __syncthreads();
  double t = 0.0;
  for (int64_t k = threadIdx.x; k < slots; k += kSumWarps * 32)
    t += tot_part[k];
  red[threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    double u = 0.0;
    for (int i = 0; i < kSumWarps * 32; ++i) u += red[i];
    *tot_out = u;
  }
}

// Launch the slot sum after a kernel on the same stream.
inline int launch_slot_sum(const float* part, const double* tot_part,
                           int64_t slots, int64_t nq, float* out,
                           double* tot_out, cudaStream_t stream) {
  const int64_t blocks = (nq + 31) / 32;
  slot_sum_kernel<<<(unsigned)blocks, kSumWarps * 32, 0, stream>>>(
      part, tot_part, slots, nq, out, tot_out);
  return (int)cudaGetLastError();
}

template <class M, class L>
int launch(const void* xr, const void* xc, const void* scale,
           const void* g_rows, const void* g_cols, const void* inv_gs,
           void* sw_part, void* tot_part, void* rs_part, void* sw_out,
           void* tot_out, int64_t nr, int64_t n, int64_t d, int64_t n_perms,
           int n_groups, int64_t row_offset, int64_t n_valid, int sym,
           cudaStream_t stream) {
  using T = typename L::T;
  const int64_t slots = n_slots<kSwStripTiles, kSwSlots>(
      (nr + kTile - 1) / kTile, (n + kTile - 1) / kTile, sym);
  cudaFuncSetAttribute(fused_sw_kernel<M, L>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSwSmemBytes);
  fused_sw_kernel<M, L><<<(unsigned)slots, kThreads, kSwSmemBytes,
                          stream>>>(
      (const T*)xr, (const T*)xc, (const float*)scale, (const int*)g_rows,
      (const int*)g_cols, (const float*)inv_gs, (float*)sw_part,
      (double*)tot_part, (float*)rs_part, nr, n, d, n_perms, n_groups,
      row_offset, n_valid, sym);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_slot_sum((const float*)sw_part, (const double*)tot_part,
                         slots, n_perms, (float*)sw_out, (double*)tot_out,
                         stream);
}

template <class M, class L>
int launch_cols(const void* xr, const void* xc, const void* scale,
                const void* v_rows, const void* v_cols, void* s_part,
                void* tot_part, void* rs_part, void* s_out, void* tot_out,
                int64_t nr, int64_t n, int64_t d, int64_t n_perms,
                int64_t n_cols, int64_t row_offset, int64_t n_valid, int sym,
                cudaStream_t stream) {
  using T = typename L::T;
  const int64_t slots = n_slots<kStripTiles, kColsSlots>(
      (nr + kTile - 1) / kTile, (n + kTile - 1) / kTile, sym);
  cudaFuncSetAttribute(fused_sw_cols_kernel<M, L>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kColsSmemBytes);
  fused_sw_cols_kernel<M, L><<<(unsigned)slots, kThreads, kColsSmemBytes,
                               stream>>>(
      (const T*)xr, (const T*)xc, (const float*)scale, (const float*)v_rows,
      (const float*)v_cols, (float*)s_part, (double*)tot_part,
      (float*)rs_part, nr, n, d, n_perms, n_cols, row_offset, n_valid, sym);
  const int err = (int)cudaGetLastError();
  if (err != 0) return err;
  return launch_slot_sum((const float*)s_part, (const double*)tot_part,
                         slots, n_perms * n_cols, (float*)s_out,
                         (double*)tot_out, stream);
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

// out: kTile, kSwPass, kThreads, kSwStripTiles, kSwSlots.
void fused_sw_config(int* out) {
  out[0] = kTile;
  out[1] = kSwPass;
  out[2] = kThreads;
  out[3] = kSwStripTiles;
  out[4] = kSwSlots;
}

// out: kStripTiles, kQPass, kKc, kColsSlots.
void fused_sw_cols_config(int* out) {
  out[0] = kStripTiles;
  out[1] = kQPass;
  out[2] = kKc;
  out[3] = kColsSlots;
}

// kind: 0 braycurtis, 1 euclidean, 2 jaccard. mode: 0 f32, 1 bf16, 2 fp8
// e4m3 (scale: one f32 on the device, the dequantization factor), 3 packed
// 32-bit presence words (jaccard only; d counts words). xr (nr, d), xc (n,
// d) of the mode's type; g_rows (P, nr), g_cols (P, n) int32; inv_gs (G,)
// f32. symmetric: 1 when the call covers the whole table against itself
// (xr and xc, g_rows and g_cols the same storage, nr == n, row_offset 0),
// which visits the column tiles j >= i only. Work items: nti * n_strips
// for a slab and sum_{c < n_strips} (ntj - c kSwStripTiles) for a
// symmetric call (nti = ceil(nr / 64), ntj = ceil(n / 64), n_strips =
// ceil(ntj / kSwStripTiles)); slots = min(kSwSlots, items). Scratch:
// sw_part (slots, P) f32 and tot_part (slots,) f64. Out: sw_out (P,) f32,
// the slots summed in order, and tot_out (1,) f64, the slab's D2 total.
// rs_part: null, or the row sums, (n_strips, nr) f32 for a slab and
// (n_strips + nti, n) for a symmetric call, zeroed by the caller.
int fused_sw_launch(int kind, int mode, const void* xr, const void* xc,
                    const void* scale, const void* g_rows,
                    const void* g_cols, const void* inv_gs, void* sw_part,
                    void* tot_part, void* rs_part, void* sw_out,
                    void* tot_out, long long nr, long long n, long long d,
                    long long n_perms, int n_groups, long long row_offset,
                    long long n_valid, int symmetric, void* stream) {
  if (nr < 1 || n < 1 || d < 1 || n_perms < 1 || n_groups < 1 ||
      row_offset < 0 || n_valid < 1 || n_valid > n ||
      (symmetric && (nr != n || row_offset != 0)) ||
      n_perms > 0x7fffffffLL * 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return launch_kind<F32In>(kind, xr, xc, scale, g_rows, g_cols, inv_gs,
                                sw_part, tot_part, rs_part, sw_out, tot_out,
                                nr, n, d, n_perms, n_groups, row_offset,
                                n_valid, symmetric, s);
    case 1:
      return launch_kind<Bf16In>(kind, xr, xc, scale, g_rows, g_cols,
                                 inv_gs, sw_part, tot_part, rs_part, sw_out,
                                 tot_out, nr, n, d, n_perms, n_groups,
                                 row_offset, n_valid, symmetric, s);
    case 2:
      if (scale == nullptr) return (int)cudaErrorInvalidValue;
      return launch_kind<Fp8In>(kind, xr, xc, scale, g_rows, g_cols, inv_gs,
                                sw_part, tot_part, rs_part, sw_out, tot_out,
                                nr, n, d, n_perms, n_groups, row_offset,
                                n_valid, symmetric, s);
    case 3:
      if (kind != 2) return (int)cudaErrorInvalidValue;
      return launch<PackedJaccard, PackedIn>(
          xr, xc, scale, g_rows, g_cols, inv_gs, sw_part, tot_part, rs_part,
          sw_out, tot_out, nr, n, d, n_perms, n_groups, row_offset, n_valid,
          symmetric, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// kind and mode as fused_sw_launch's. xr (nr, d), xc (n, d) of the mode's
// type; v_rows (P, nr, K), v_cols (P, n, K) f32. symmetric: 1 when the
// call covers the whole table against itself (xr and xc, v_rows and v_cols
// the same storage, nr == n, row_offset 0), which visits the column tiles
// j >= i only. Work items and slots as fused_sw_launch's with kStripTiles
// and kColsSlots.
// Scratch: s_part (slots, P * K) f32 and tot_part (slots,) f64. Out:
// s_out (P * K,) f32, the slots summed in order, and tot_out (1,) f64.
// rs_part: null, or the row sums, (n_strips, nr) f32 for a slab and
// (n_strips + nti, n) for a symmetric call, zeroed by the caller.
int fused_sw_cols_launch(int kind, int mode, const void* xr, const void* xc,
                         const void* scale, const void* v_rows,
                         const void* v_cols, void* s_part, void* tot_part,
                         void* rs_part, void* s_out, void* tot_out,
                         long long nr, long long n, long long d,
                         long long n_perms, long long n_cols,
                         long long row_offset, long long n_valid,
                         int symmetric, void* stream) {
  if (nr < 1 || n < 1 || d < 1 || n_perms < 1 || n_cols < 1 ||
      row_offset < 0 || n_valid < 1 || n_valid > n ||
      (symmetric && (nr != n || row_offset != 0)) ||
      n_perms * n_cols > 0x7fffffffLL * 32)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (mode) {
    case 0:
      return launch_cols_kind<F32In>(kind, xr, xc, scale, v_rows, v_cols,
                                     s_part, tot_part, rs_part, s_out,
                                     tot_out, nr, n, d, n_perms, n_cols,
                                     row_offset, n_valid, symmetric, s);
    case 1:
      return launch_cols_kind<Bf16In>(kind, xr, xc, scale, v_rows, v_cols,
                                      s_part, tot_part, rs_part, s_out,
                                      tot_out, nr, n, d, n_perms, n_cols,
                                      row_offset, n_valid, symmetric, s);
    case 2:
      if (scale == nullptr) return (int)cudaErrorInvalidValue;
      return launch_cols_kind<Fp8In>(kind, xr, xc, scale, v_rows, v_cols,
                                     s_part, tot_part, rs_part, s_out,
                                     tot_out, nr, n, d, n_perms, n_cols,
                                     row_offset, n_valid, symmetric, s);
    case 3:
      if (kind != 2) return (int)cudaErrorInvalidValue;
      return launch_cols<PackedJaccard, PackedIn>(
          xr, xc, scale, v_rows, v_cols, s_part, tot_part, rs_part, s_out,
          tot_out, nr, n, d, n_perms, n_cols, row_offset, n_valid,
          symmetric, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
