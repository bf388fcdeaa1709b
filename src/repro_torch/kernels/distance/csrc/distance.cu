// Pairwise distances on Hopper (sm_90a). Rows xr (nr, d) against rows xc
// (nc, d), both row-major, give out (nr, nc) f32:
//
//   braycurtis      sum_k |x_k - y_k| / max(S_x + S_y, 1e-30)
//   euclidean       sqrt(max(|x|^2 + |y|^2 - 2 x.y, 0))
//   jaccard         on 0/1 floats: 1 - inter / max(card_x + card_y - inter, 1)
//   jaccard_packed  the same on 32-bit presence words, inter = popc(a & b)
//
// They replace kernels/distance/kernel.py:braycurtis_pallas,
// :euclidean_pallas, :jaccard_pallas and :jaccard_packed_pallas. Those run
// a (row tile, col tile, feature block) grid in order, with the feature
// axis innermost, accumulating in VMEM and finalizing on the last
// feature step. Here each block owns a 128 x 128 output tile and loops
// over the features itself: each 32-feature chunk of its 128 rows and 128
// columns is copied, transposed, into shared memory with 4-byte cp.async
// copies (a warp reads 4 rows x 8 features, 32-byte sectors whole, and
// writes them on 32 distinct banks), double-buffered, so the next chunk's
// copies overlap this chunk's arithmetic. The per-row statistics (S_x,
// |x|^2, card_x) are summed by one thread per row or column of the tile
// from the same staged chunks, in feature order, so a sample's statistic
// is the same bits whether it is a row or a column of the tile.
//
// Bray-Curtis and the packed jaccard have no product form; they run on
// the CUDA cores (distance_kernel<M>): each of the 256 threads
// accumulates an 8 x 8 micro-tile in registers (rows 4 ty + [0, 4) and
// 64 + 4 ty + [0, 4), columns likewise with tx, so its float4 reads of a
// staged feature row are conflict-free), and the finalize runs once after
// the loop. Euclidean's x.y and jaccard's intersection are products, which
// the reference computes on the matrix unit (dot_general); here they run
// on the tensor cores (tc_distance_kernel<M>, wgmma). Their chunks are
// staged as [r][k] by 16-byte cp.async copies two chunks ahead, and each
// is converted once into one of two buffers in wgmma's K-major core-matrix
// layout (no swizzle: LBO the k-direction stride of 128 B, SBO the 8-row
// one of 256 B); the warpgroups read both operands from shared memory by
// descriptor while the next chunk is converted into the other buffer.
//
//   jaccard    exact int8 counts. Each 0/1 value becomes an int8 0/1, and
//              two warpgroups run wgmma m64n128k32 .s32.s8.s8, one 64-row
//              half of the tile each, summing in s32 over the whole feature
//              loop: the counts are exact whatever the order. OPERAND
//              CONTRACT: xr and xc hold presence data, 0.0 or 1.0 exactly
//              (core.distance.presence_prepare); the conversion is exact for
//              those only, and nothing is checked on the device.
//   euclidean  3xTF32. Each value is split, hi = tf32(x) (cvt.rna) and lo =
//              tf32(x - hi), and x.y = hi.hi + hi.lo + lo.hi (lo.lo is below
//              f32's rounding; one TF32 product keeps ~11 bits, which the
//              f32 bar rejects) runs as wgmma m64n64k8 in four warpgroups,
//              one 64 x 64 quadrant each. The tensor cores truncate as they
//              accumulate, so each chunk's products go into fresh
//              accumulators that join an f32 running sum on the CUDA cores,
//              in chunk order: HH over features 0-15, HH over 16-31, then
//              (X + Y). The cross products keep separate accumulators, X =
//              hi_r.lo_c and Y = lo_r.hi_c: in the mirrored tile of a
//              rectangular call X' = Y^T and Y' = X^T (each product is the
//              same exact value at the same k), and f32 + commutes. One
//              cross accumulator would take the two terms in the opposite
//              order there, and truncating sums do not commute. |x|^2 is
//              the f32 sum of x x in feature order, never hi + lo.
//
// A whole-table call (xr and xc the same table, ops.is_symmetric_call)
// visits only the tiles j >= i, in strips of 16 row tiles, column by
// column (tile_pair), and writes each off-diagonal tile and its transpose
// through shared memory, so that both stores coalesce. The mirrored entry
// equals what a rectangular call computes there bit for bit: |a - b| =
// |b - a|, a b = b a, the feature loop runs in the same order for every
// pair, the cross products join as above, and S_x + S_y = S_y + S_x.
//
// Bray-Curtis's denominator sum_k (x_k + y_k) is S_x + S_y, formed from
// the row sums (the reference adds x + y per feature; the value differs
// only by f32 summation order). Both jaccard kernels call the same f32
// finalize on counts that are exact integers in f32 (d < 2^24), so the
// packed kernel equals the float one bit for bit.
//
// Ragged nr, nc and d are masked here (out-of-range rows and features are
// copied as 0 and not stored; zeros add nothing to a product), so nothing
// is padded. Element offsets are 64-bit. Division and sqrt are nvcc's
// default IEEE-rounded forms (no --use_fast_math).
//
// What bounds them, at the main path's dense shape on an H100 SXM at 700 W
// (n = 25,145, d = 128), each pair once: the output write, 4 n^2 B = 2.53
// GB, 0.75 ms of HBM at 3.35 TB/s, bounds euclidean, jaccard and
// jaccard_packed. Their products on the tensor cores take less: jaccard's
// n(n-1)/2 d multiply-adds in int8 at 1,979 TOPS 0.04 ms, euclidean's three
// TF32 products at 495 TFLOP/s 0.49 ms. Bray-Curtis issues two FP32
// instructions per (pair, feature), a subtract and an add of its
// magnitude: n(n-1)/2 d of each, 2.42 ms at 128 lanes x 132 SMs x 1.98 GHz
// (1.21 ms at the 67 TFLOP/s f32 peak, its bound, which counts an FMA as
// two). jaccard_packed does an AND, a popcount and an add per word pair,
// on 4 words a row. The features (12.9 MB) stay in L2. Measured (PERF.md),
// the write takes ~1 ms (~2.3 TB/s) and overlaps little of the rest: with
// the stores left out jaccard takes ~0.95 ms and euclidean ~2.0 (its
// products read ~0.2 MB of shared memory a chunk and block, and its 512
// threads hold one block an SM).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. The C entry point returns cudaGetLastError()
//        after the launch; it launches on the caller's stream and never
//        synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kTile = 128;             // output rows (and cols) per block
constexpr int kHalf = kTile / 2;       // a thread's rows: two runs of 4
constexpr int kMicro = 8;              // each thread owns 8 x 8 outputs
constexpr int kChunk = 32;             // features (words) staged per step
constexpr int kPitch = kTile + 4;      // a staged feature row: 132 elements
constexpr int kStage = 2 * kChunk * kPitch;   // rows and cols of a chunk
constexpr int kOutPitch = kTile + 1;   // the finalized tile's rows: 129
constexpr int kSmemBytes = 2 * kStage * 4;    // two stages: 67,584 bytes
static_assert(kTile * kOutPitch <= 2 * kStage,
              "the finalized tile reuses the staging");
static_assert(kThreads * 16 == kTile * kChunk,
              "16 copies a thread per operand and chunk");
// wgmma operands, K-major without swizzle: 8-row x 16-byte core matrices,
// kLbo bytes apart along k and kSbo bytes apart down the rows
constexpr int kLbo = 128, kSbo = 256;
constexpr int kWgRows = 64;            // a warpgroup's rows (wgmma's M)
constexpr int kI8Tile = kTile / 8 * kSbo;      // a chunk of 128 rows, int8:
                                               // one k32 step, 4,096 B
constexpr int kTf32Step = kTile / 8 * kSbo;    // one k8 step of 128 rows
constexpr int kTf32Tile = kChunk / 8 * kTf32Step;   // a chunk, 16,384 B
// the tensor-core kernels stage a chunk as [r][k]: 36 floats a row (144 B,
// so a quarter-warp's 16-byte accesses of 8 rows fall on distinct banks),
// the rows then the columns, two stages
constexpr int kRawPitch = kChunk + 4;
constexpr int kRawOperand = kTile * kRawPitch;   // floats
constexpr int kRawStage = 2 * kRawOperand;
constexpr int kRawBytes = 2 * kRawStage * 4;     // 73,728
// the tensor-core kernels' finalized tile: rows of 132 floats, each
// shifted by its output row's misalignment (0-3 floats), so 16-byte reads
// of it feed 16-byte stores
constexpr int kT4Pitch = kTile + 4;
static_assert(kTile * kT4Pitch * 4 <= kRawBytes,
              "the finalized tile reuses the [r][k] staging");

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// 4-byte asynchronous copy global -> shared; src_bytes 0 writes a zero and
// reads nothing.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
// 16-byte asynchronous copy global -> shared (L2 only); src_bytes 0 writes
// zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// The finalize both jaccard kernels share: the packed result equals the
// float result bit for bit only because this arithmetic is identical.
__device__ __forceinline__ float jaccard_finalize(float inter, float card_r,
                                                  float card_c) {
  const float card = card_r + card_c;
  const float uni = card - inter;
  return 1.f - inter / fmaxf(uni, 1.f);
}

struct BrayCurtis {
  using T = float;
  using Acc = float;
  static __device__ __forceinline__ float stat(float a) { return a; }
  static __device__ __forceinline__ void step(float& acc, float a, float b) {
    acc += fabsf(a - b);
  }
  static __device__ __forceinline__ float finish(float num, float sr,
                                                 float sc) {
    return num / fmaxf(sr + sc, 1e-30f);
  }
};

struct JaccardPacked {
  using T = unsigned;
  using Acc = int;
  static __device__ __forceinline__ float stat(unsigned a) {
    return (float)__popc(a);
  }
  static __device__ __forceinline__ void step(int& acc, unsigned a,
                                              unsigned b) {
    acc += __popc(a & b);
  }
  static __device__ __forceinline__ float finish(int inter, float sr,
                                                 float sc) {
    return jaccard_finalize((float)inter, sr, sc);
  }
};

template <class T> struct Vec4;
template <> struct Vec4<float> { using type = float4; };
template <> struct Vec4<unsigned> { using type = uint4; };

// a thread's 8 rows (or columns) of a staged feature row: 4 at 4 t, 4 at
// 64 + 4 t
template <class T>
__device__ __forceinline__ void load8(const T* row, int t, T v[kMicro]) {
  using V = typename Vec4<T>::type;
  const V lo = *reinterpret_cast<const V*>(row + 4 * t);
  const V hi = *reinterpret_cast<const V*>(row + kHalf + 4 * t);
  v[0] = lo.x; v[1] = lo.y; v[2] = lo.z; v[3] = lo.w;
  v[4] = hi.x; v[5] = hi.y; v[6] = hi.z; v[7] = hi.w;
}

// tile row (or column) of a thread's micro-tile entry u < 8
__device__ __forceinline__ int micro_index(int t, int u) {
  return (u < 4 ? 0 : kHalf - 4) + 4 * t + u;
}

// Start the copies of features k0 + [0, 32) of the 128 rows r0.. of x
// (n rows of d elements) into st[k][r] (pitch kPitch), zero past n or d.
// Copy e of thread tid: lane l = tid % 32 takes row 4 g + l / 8 and
// feature 8 h + l % 8 of group (g, h), so a warp reads 4 rows x 32
// bytes and writes 32 distinct banks ((4 k + r) mod 32).
template <class T>
__device__ __forceinline__ void stage_chunk(T* st, const T* __restrict__ x,
                                            int64_t n, int64_t d,
                                            int64_t r0, int64_t k0) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
#pragma unroll
  for (int u = 0; u < kTile * kChunk / kThreads; ++u) {
    const int grp = warp + (kThreads / 32) * u;   // 128 groups of 32
    const int r = 4 * (grp / 4) + lane / 8, k = 8 * (grp % 4) + lane % 8;
    const int64_t i = r0 + r, kk = k0 + k;
    const bool ok = i < n && kk < d;
    cp_async4(st + k * kPitch + r, ok ? (const void*)(x + i * d + kk)
                                      : (const void*)x, ok ? 4 : 0);
  }
}

// A block's (row tile, column tile). A rectangular call visits every
// tile, the column tile fastest. A symmetric call visits the tiles j >= i
// in strips of kStripTiles row tiles: a strip's triangle (its first
// kStripTiles columns, rows up to the column), then its rectangle, column
// by column, so the blocks in flight write runs of ~kStripTiles tiles
// along their output rows both as tiles and as mirrors.
constexpr int kStripTiles = 16;

struct TilePair {
  int64_t bi, bj;
};

__host__ __device__ inline int64_t n_tile_blocks(int64_t nti, int64_t ntj,
                                                 int sym) {
  return sym ? nti * (nti + 1) / 2 : nti * ntj;
}

__device__ __forceinline__ TilePair tile_pair(int64_t b, int64_t nti,
                                              int64_t ntj, int sym) {
  if (!sym) return {b / ntj, b % ntj};
  int64_t s0 = 0;   // the strip's first row tile
  for (;;) {
    const int64_t w = nti - s0 < kStripTiles ? nti - s0 : kStripTiles;
    const int64_t tri = w * (w + 1) / 2;
    const int64_t size = tri + w * (nti - s0 - w);
    if (b >= size) {
      b -= size;
      s0 += w;
      continue;
    }
    if (b >= tri) return {s0 + (b - tri) % w, s0 + w + (b - tri) / w};
    // the triangle: column t holds t + 1 tiles
    int64_t t = (int64_t)((sqrt(8.0 * (double)b + 1.0) - 1.0) / 2.0);
    while (t > 0 && t * (t + 1) / 2 > b) --t;
    while ((t + 1) * (t + 2) / 2 <= b) ++t;
    return {s0 + (b - t * (t + 1) / 2), s0 + t};
  }
}

// Grid: n_tile_blocks(ceil(nr / 128), ceil(nc / 128), sym) blocks of 256
// threads. Block (bi, bj) writes out[bi*128 + [0, 128), bj*128 + [0, 128))
// and, when sym and bj > bi, its transpose at out[bj*128 + .., bi*128 +
// ..]. Thread (ty, tx) owns rows micro_index(ty, u) and columns
// micro_index(tx, v) of the tile. Threads 0-127 sum the statistic of tile
// row t, threads 128-255 that of tile column t - 128.
template <class M>
__global__ void __launch_bounds__(kThreads, 2)
distance_kernel(const typename M::T* __restrict__ xr,
                const typename M::T* __restrict__ xc,
                float* __restrict__ out, int64_t nr, int64_t nc, int64_t d,
                int sym) {
  using T = typename M::T;
  extern __shared__ __align__(16) unsigned char dist_smem[];
  T* stages = reinterpret_cast<T*>(dist_smem);   // [2][rows, cols][k][r]
  __shared__ float row_stat[kTile];
  __shared__ float col_stat[kTile];
  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int64_t nti = (nr + kTile - 1) / kTile;
  const int64_t ntj = (nc + kTile - 1) / kTile;
  const TilePair tp = tile_pair(blockIdx.x, nti, ntj, sym);
  const int64_t i0 = tp.bi * kTile, j0 = tp.bj * kTile;

  typename M::Acc acc[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = 0;
  float stat = 0.f;

  const int64_t n_chunks = (d + kChunk - 1) / kChunk;
  stage_chunk<T>(stages, xr, nr, d, i0, 0);
  stage_chunk<T>(stages + kChunk * kPitch, xc, nc, d, j0, 0);
  cp_async_commit();
  for (int64_t c = 0; c < n_chunks; ++c) {
    if (c + 1 < n_chunks) {
      T* nxt = stages + ((c + 1) & 1) * kStage;
      stage_chunk<T>(nxt, xr, nr, d, i0, (c + 1) * kChunk);
      stage_chunk<T>(nxt + kChunk * kPitch, xc, nc, d, j0, (c + 1) * kChunk);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();   // chunk c has landed (chunk c + 1 may be in flight)
    const T* rs = stages + (c & 1) * kStage;
    const T* cs = rs + kChunk * kPitch;
    const int kn = (int)min64(kChunk, d - c * kChunk);
    {  // the statistic of tile row tid (or column tid - 128), in order
      const T* st = tid < kTile ? rs + tid : cs + (tid - kTile);
#pragma unroll 8
      for (int k = 0; k < kn; ++k) stat += M::stat(st[k * kPitch]);
    }
#pragma unroll 4
    for (int k = 0; k < kn; ++k) {
      T a[kMicro], b[kMicro];
      load8(rs + k * kPitch, ty, a);
      load8(cs + k * kPitch, tx, b);
#pragma unroll
      for (int u = 0; u < kMicro; ++u)
#pragma unroll
        for (int v = 0; v < kMicro; ++v) M::step(acc[u][v], a[u], b[v]);
    }
    __syncthreads();  // the chunk's readers are done before it is replaced
  }
  cp_async_wait<0>();

  if (tid < kTile)
    row_stat[tid] = stat;
  else
    col_stat[tid - kTile] = stat;
  __syncthreads();

  // the finalized tile [r][c] in shared memory (the staging is free)
  float* tile = reinterpret_cast<float*>(dist_smem);
#pragma unroll
  for (int u = 0; u < kMicro; ++u) {
    const int r = micro_index(ty, u);
    const float sr = row_stat[r];
#pragma unroll
    for (int v = 0; v < kMicro; ++v) {
      const int cc = micro_index(tx, v);
      tile[r * kOutPitch + cc] = M::finish(acc[u][v], sr, col_stat[cc]);
    }
  }
  __syncthreads();
  // row-wise: a warp stores 32 consecutive columns of one row
  for (int e = tid; e < kTile * kTile; e += kThreads) {
    const int r = e / kTile, cc = e % kTile;
    const int64_t i = i0 + r, j = j0 + cc;
    if (i < nr && j < nc) out[i * nc + j] = tile[r * kOutPitch + cc];
  }
  if (sym && tp.bj != tp.bi) {
    // the transpose: a warp stores 32 consecutive rows of one column
    for (int e = tid; e < kTile * kTile; e += kThreads) {
      const int cc = e / kTile, r = e % kTile;
      const int64_t i = i0 + r, j = j0 + cc;
      if (i < nr && j < nc) out[j * nc + i] = tile[r * kOutPitch + cc];
    }
  }
}

template <class M>
int launch(const void* xr, const void* xc, void* out, int64_t nr,
           int64_t nc, int64_t d, int sym, cudaStream_t stream) {
  const int64_t blocks = n_tile_blocks((nr + kTile - 1) / kTile,
                                       (nc + kTile - 1) / kTile, sym);
  cudaFuncSetAttribute(distance_kernel<M>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       kSmemBytes);
  distance_kernel<M><<<(unsigned)blocks, kThreads, kSmemBytes, stream>>>(
      (const typename M::T*)xr, (const typename M::T*)xc, (float*)out, nr,
      nc, d, sym);
  return (int)cudaGetLastError();
}

// ---- the tensor-core kernels: euclidean and jaccard ------------------------

// x rounded to TF32, round to nearest with ties away (a .b32 pattern whose
// low 13 bits are zero).
__device__ __forceinline__ uint32_t tf32_round(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}
// Shared-memory stores of this thread become visible to the tensor cores'
// (async proxy) reads of the operands.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// An operand descriptor: no swizzle, the start address and the core
// matrices' strides in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t a = (uint64_t)__cvta_generic_to_shared(p);
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
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(int* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}
// d (+)= A . B: m64n64k8, tf32 A and B from shared memory by descriptor;
// scale_d 0 starts a fresh sum, otherwise it adds to d.
__device__ __forceinline__ void wgmma_tf32(float* d, uint64_t a, uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(scale_d));
}
// d (+)= A . B: m64n128k32, s8 A and B from shared memory by descriptor,
// s32 sums (exact); scale_d as wgmma_tf32's.
__device__ __forceinline__ void wgmma_s8(int* d, uint64_t a, uint64_t b,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, "
      "%14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, "
      "%26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, "
      "%38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63}, %64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]),
        "+r"(d[5]), "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]),
        "+r"(d[10]), "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]),
        "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]),
        "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]),
        "+r"(d[30]), "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]),
        "+r"(d[35]), "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]),
        "+r"(d[40]), "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]),
        "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]),
        "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]),
        "+r"(d[60]), "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(scale_d));
}

// Byte offset of element (r, k) of a chunk's operand: int8, one k32 step
// (two core matrices along k); tf32, four k8 steps of kTf32Step bytes.
__device__ __forceinline__ int i8_offset(int r, int k) {
  return (r / 8) * kSbo + (k / 16) * kLbo + (r % 8) * 16 + k % 16;
}
__device__ __forceinline__ int tf32_offset(int r, int k) {
  return (k / 8) * kTf32Step + (r / 8) * kSbo + ((k % 8) / 4) * kLbo +
         (r % 8) * 16 + (k % 4) * 4;
}

// Start the copies of features k0 + [0, 32) of the 128 rows r0.. of x (n
// rows of d floats) into st[r][k] (pitch kRawPitch), zero past n or d, by
// a block of NT threads: with vec (d % 4 == 0, x 16-byte aligned) as
// 16-byte copies, a warp 4 rows x 128 B; otherwise 4-byte copies, a warp
// one row.
template <int NT>
__device__ __forceinline__ void stage_rows(float* st,
                                           const float* __restrict__ x,
                                           int64_t n, int64_t d, int64_t r0,
                                           int64_t k0, int vec) {
  const int tid = threadIdx.x;
  if (vec) {
#pragma unroll
    for (int u = 0; u < kTile * kChunk / 4 / NT; ++u) {
      const int e = tid + NT * u, r = e / (kChunk / 4);
      const int k = 4 * (e % (kChunk / 4));
      const int64_t i = r0 + r, kk = k0 + k;
      const bool ok = i < n && kk < d;
      cp_async16(st + r * kRawPitch + k,
                 ok ? (const void*)(x + i * d + kk) : (const void*)x,
                 ok ? 16 : 0);
    }
  } else {
#pragma unroll 4
    for (int u = 0; u < kTile * kChunk / NT; ++u) {
      const int e = tid + NT * u, r = e / kChunk, k = e % kChunk;
      const int64_t i = r0 + r, kk = k0 + k;
      const bool ok = i < n && kk < d;
      cp_async4(st + r * kRawPitch + k,
                ok ? (const void*)(x + i * d + kk) : (const void*)x,
                ok ? 4 : 0);
    }
  }
}

// Jaccard's intersection as exact int8 counts. Two warpgroups, warpgroup
// wg the tile rows 64 wg + [0, 64) against all 128 columns, one
// m64n128k32 a chunk, summed in s32 across the chunks (wgmma chains the
// sum). The conversion buffer holds the chunk's rows then its columns,
// int8.
struct Jaccard {
  static constexpr int kThreads = 256;
  static constexpr int kMinBlocks = 2;
  static constexpr int kConvBytes = 2 * kI8Tile;
  static constexpr int kAcc = 64;
  static constexpr int kPend = 1;   // nothing of a product outside acc
  using Acc = int;
  static __device__ __forceinline__ float stat(float a) { return a; }
  // (first row, first column) of warpgroup wg's part of the tile
  static __device__ __forceinline__ void origin(int wg, int& r0, int& c0) {
    r0 = kWgRows * wg;
    c0 = 0;
  }
  // Thread tid converts tile row (and column) tid % 128, features 16
  // (tid / 128) + [0, 16): 16 presence floats, one 16-byte core-matrix row
  // of int8. x + 2^23 holds the integer x in its low mantissa bits (exact
  // for 0 and 1, and -0 gives 0).
  static __device__ __forceinline__ void convert(const float* st,
                                                 unsigned char* cv,
                                                 int tid) {
    const int r = tid % kTile, k0 = 16 * (tid / kTile);
#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const float4* p = reinterpret_cast<const float4*>(
          st + o * kRawOperand + r * kRawPitch + k0);
      uint32_t w[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 v = p[q];
        const uint32_t b01 = __byte_perm(__float_as_uint(v.x + 8388608.f),
                                         __float_as_uint(v.y + 8388608.f),
                                         0x0040);
        const uint32_t b23 = __byte_perm(__float_as_uint(v.z + 8388608.f),
                                         __float_as_uint(v.w + 8388608.f),
                                         0x0040);
        w[q] = __byte_perm(b01, b23, 0x5410);
      }
      *reinterpret_cast<uint4*>(cv + o * kI8Tile + i8_offset(r, k0)) =
          make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  // Issue the chunk's product; it runs while the next chunk is converted.
  static __device__ __forceinline__ void mma(int* acc, int*,
                                             const unsigned char* cv,
                                             int tid) {
    const int wg = tid / 128;
    wgmma_fence();
    wgmma_s8(acc, smem_desc(cv + wg * (kWgRows / 8) * kSbo),
             smem_desc(cv + kI8Tile), 1);
    wgmma_commit();
  }
  // The product in flight is done (its operands may be rewritten).
  static __device__ __forceinline__ void drain(int* acc, int*) {
    wgmma_wait_all();
    fence_regs<kAcc>(acc);
  }
  static __device__ __forceinline__ float finish(int inter, float sr,
                                                 float sc) {
    return jaccard_finalize((float)inter, sr, sc);
  }
};

// Euclidean's Gram in 3xTF32. Four warpgroups, warpgroup wg the 64 x 64
// quadrant (rows 64 (wg / 2), columns 64 (wg % 2)) of the tile. Per chunk,
// the running sum takes acc += HH(features 0-15), acc += HH(16-31), each a
// fresh sum of two k8 steps, then acc += (X + Y), X = hi_r.lo_c and Y =
// lo_r.hi_c fresh sums over the chunk, which run while the next chunk is
// converted and join at the next drain; pend holds X then Y (and first
// the HH halves). The conversion buffer holds the chunk's rows hi, rows lo,
// columns hi, columns lo, tf32.
struct Euclidean {
  static constexpr int kThreads = 512;
  static constexpr int kMinBlocks = 1;
  static constexpr int kConvBytes = 4 * kTf32Tile;
  static constexpr int kAcc = 32;
  static constexpr int kPend = 2 * kAcc;
  using Acc = float;
  static __device__ __forceinline__ float stat(float a) { return a * a; }
  static __device__ __forceinline__ void origin(int wg, int& r0, int& c0) {
    r0 = kWgRows * (wg / 2);
    c0 = kWgRows * (wg % 2);
  }
  // Thread tid converts tile row (and column) tid % 128, features 4 q +
  // [0, 4) for q = tid / 128 and q + 4: split into hi and lo, one 16-byte
  // core-matrix row of each.
  static __device__ __forceinline__ void convert(const float* st,
                                                 unsigned char* cv,
                                                 int tid) {
    const int r = tid % kTile;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int o = u / 2, k0 = 4 * (tid / kTile + 4 * (u % 2));
      const float4 v = *reinterpret_cast<const float4*>(
          st + o * kRawOperand + r * kRawPitch + k0);
      const float x[4] = {v.x, v.y, v.z, v.w};
      uint32_t h[4], l[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = tf32_round(x[e]);
        l[e] = tf32_round(x[e] - __uint_as_float(h[e]));
      }
      unsigned char* hi = cv + o * 2 * kTf32Tile + tf32_offset(r, k0);
      *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(hi + kTf32Tile) =
          make_uint4(l[0], l[1], l[2], l[3]);
    }
  }
  static __device__ __forceinline__ void mma(float* acc, float* pend,
                                             const unsigned char* cv,
                                             int tid) {
    const int wg = tid / 128;
    const unsigned char* ah = cv + (wg / 2) * (kWgRows / 8) * kSbo;
    const unsigned char* al = ah + kTf32Tile;
    const unsigned char* bh =
        cv + 2 * kTf32Tile + (wg % 2) * (kWgRows / 8) * kSbo;
    const unsigned char* bl = bh + kTf32Tile;
    float* x = pend;
    float* y = pend + kAcc;
    constexpr int kSteps = kChunk / 8;
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps / 2; ++s)   // HH(features 0-15) into x
      wgmma_tf32(x, smem_desc(ah + s * kTf32Step),
                 smem_desc(bh + s * kTf32Step), s);
#pragma unroll
    for (int s = kSteps / 2; s < kSteps; ++s)   // HH(16-31) into y
      wgmma_tf32(y, smem_desc(ah + s * kTf32Step),
                 smem_desc(bh + s * kTf32Step), s - kSteps / 2);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs<kPend>(pend);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += x[i];
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += y[i];
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kSteps; ++s)   // X into x
      wgmma_tf32(x, smem_desc(ah + s * kTf32Step),
                 smem_desc(bl + s * kTf32Step), s);
#pragma unroll
    for (int s = 0; s < kSteps; ++s)   // Y into y
      wgmma_tf32(y, smem_desc(al + s * kTf32Step),
                 smem_desc(bh + s * kTf32Step), s);
    wgmma_commit();
  }
  // The cross products in flight join the running sum (before the first
  // chunk pend is 0, and acc + (0 + 0) = acc). pend is zeroed after use:
  // without it ptxas (sm_90a) segfaults on this kernel.
  static __device__ __forceinline__ void drain(float* acc, float* pend) {
    wgmma_wait_all();
    fence_regs<kPend>(pend);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) acc[i] += pend[i] + pend[kAcc + i];
#pragma unroll
    for (int i = 0; i < kPend; ++i) pend[i] = 0.f;
  }
  static __device__ __forceinline__ float finish(float dot, float sr,
                                                 float sc) {
    return sqrtf(fmaxf(sr + sc - 2.f * dot, 0.f));
  }
};

// A warp stores out[dst + k] = src[k] for k < len, src in shared memory
// laid out so that src + k is 16-byte aligned where dst + k is: 16-byte
// stores of the aligned middle, scalar stores of the up to 3 elements
// before it and after it.
__device__ __forceinline__ void store_row(float* __restrict__ dst,
                                          const float* src, int len,
                                          int lane) {
  const int h = min((4 - (int)(((uintptr_t)dst >> 2) & 3)) & 3, len);
  if (lane < h) dst[lane] = src[lane];
  const int nv = (len - h) / 4;
  for (int v = lane; v < nv; v += 32)
    *reinterpret_cast<float4*>(dst + h + 4 * v) =
        *reinterpret_cast<const float4*>(src + h + 4 * v);
  const int t0 = h + 4 * nv;
  if (lane < len - t0) dst[t0 + lane] = src[t0 + lane];
}

// Misalignment (in floats, 0-3) of out + row * nc + col.
__device__ __forceinline__ int misalign(const float* out, int64_t row,
                                        int64_t nc, int64_t col) {
  return (int)(((uintptr_t)(out + row * nc + col) >> 2) & 3);
}

// Grid and tiles as distance_kernel's; M::kThreads threads. The chunks
// are staged as [r][k] two ahead through a two-stage cp.async ring. Per
// chunk: the statistic (threads 0-255, as distance_kernel), the conversion
// into one of two buffers, then the warpgroups' products, which read that
// buffer while the next chunk is converted into the other. Accumulator j
// of a thread is wgmma's fragment entry: tile row r0 + 16 (warp % 4) +
// lane / 4 + 8 ((j / 2) % 2), column c0 + 8 (j / 4) + 2 (lane % 4) + j % 2,
// with (r0, c0) its warpgroup's origin. The finalized entries go out
// through shared memory, first as rows of the tile and then (mirrored) as
// its columns, each output row by one warp (store_row).
template <class M>
__global__ void __launch_bounds__(M::kThreads, M::kMinBlocks)
tc_distance_kernel(const float* __restrict__ xr,
                   const float* __restrict__ xc, float* __restrict__ out,
                   int64_t nr, int64_t nc, int64_t d, int sym, int vec) {
  constexpr int NT = M::kThreads;
  extern __shared__ __align__(128) unsigned char tc_smem[];
  float* raw = reinterpret_cast<float*>(tc_smem);   // [2][rows, cols][r][k]
  unsigned char* conv = tc_smem + kRawBytes;        // [2][M::kConvBytes]
  __shared__ float row_stat[kTile];
  __shared__ float col_stat[kTile];
  const int tid = threadIdx.x;
  const int64_t nti = (nr + kTile - 1) / kTile;
  const int64_t ntj = (nc + kTile - 1) / kTile;
  const TilePair tp = tile_pair(blockIdx.x, nti, ntj, sym);
  const int64_t i0 = tp.bi * kTile, j0 = tp.bj * kTile;
  const int64_t n_chunks = (d + kChunk - 1) / kChunk;
  auto stage = [&](int64_t c) {
    float* st = raw + (c & 1) * kRawStage;
    stage_rows<NT>(st, xr, nr, d, i0, c * kChunk, vec);
    stage_rows<NT>(st + kRawOperand, xc, nc, d, j0, c * kChunk, vec);
  };

  typename M::Acc acc[M::kAcc];
  typename M::Acc pend[M::kPend];
#pragma unroll
  for (int i = 0; i < M::kAcc; ++i) acc[i] = 0;
#pragma unroll
  for (int i = 0; i < M::kPend; ++i) pend[i] = 0;
  float stat = 0.f;

  stage(0);
  cp_async_commit();
  if (n_chunks > 1) stage(1);
  cp_async_commit();
  for (int64_t c = 0; c < n_chunks; ++c) {
    cp_async_wait<1>();
    __syncthreads();   // chunk c has landed; chunk c - 2's products are done
    const float* st = raw + (c & 1) * kRawStage;
    if (tid < 2 * kTile) {
      // the statistic of tile row tid (or column tid - 128: the columns
      // follow the rows), in feature order; features past d are zeros
      const float4* p = reinterpret_cast<const float4*>(st + tid * kRawPitch);
#pragma unroll
      for (int k = 0; k < kChunk / 4; ++k) {
        const float4 v = p[k];
        stat += M::stat(v.x);
        stat += M::stat(v.y);
        stat += M::stat(v.z);
        stat += M::stat(v.w);
      }
    }
    unsigned char* cv = conv + (c & 1) * M::kConvBytes;
    M::convert(st, cv, tid);
    fence_proxy_async();
    M::drain(acc, pend);   // chunk c - 1's products
    __syncthreads();       // chunk c is converted; its staging is free
    if (c + 2 < n_chunks) stage(c + 2);
    cp_async_commit();
    M::mma(acc, pend, cv, tid);
  }
  M::drain(acc, pend);

  if (tid < kTile)
    row_stat[tid] = stat;
  else if (tid < 2 * kTile)
    col_stat[tid - kTile] = stat;
  __syncthreads();
  const int lane = tid % 32, warp = tid / 32, wr = warp % 4;
  int r0, c0;
  M::origin(tid / 128, r0, c0);
  float v[M::kAcc];
#pragma unroll
  for (int j = 0; j < M::kAcc; ++j) {
    const int r = r0 + 16 * wr + lane / 4 + 8 * ((j / 2) % 2);
    const int cc = c0 + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
    v[j] = M::finish(acc[j], row_stat[r], col_stat[cc]);
  }
  // the tile as rows [r][shift_r + c] (the staging is free)
  float* tile = reinterpret_cast<float*>(tc_smem);
  const int ra = r0 + 16 * wr + lane / 4;
  const int sh[2] = {misalign(out, i0 + ra, nc, j0),
                     misalign(out, i0 + ra + 8, nc, j0)};
#pragma unroll
  for (int j = 0; j < M::kAcc; ++j) {
    const int h = (j / 2) % 2;
    const int cc = c0 + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
    tile[(ra + 8 * h) * kT4Pitch + sh[h] + cc] = v[j];
  }
  __syncthreads();
  const int len_c = (int)min64(kTile, nc - j0);
  for (int r = warp; r < kTile && i0 + r < nr; r += NT / 32)
    store_row(out + (i0 + r) * nc + j0,
              tile + r * kT4Pitch + misalign(out, i0 + r, nc, j0), len_c,
              lane);
  if (!(sym && tp.bj != tp.bi)) return;
  __syncthreads();
  // the mirror: the tile's columns as rows [c][shift_c + r]
#pragma unroll
  for (int j = 0; j < M::kAcc; ++j) {
    const int h = (j / 2) % 2;
    const int cc = c0 + 8 * (j / 4) + 2 * (lane % 4) + j % 2;
    tile[cc * kT4Pitch + misalign(out, j0 + cc, nc, i0) + ra + 8 * h] = v[j];
  }
  __syncthreads();
  const int len_r = (int)min64(kTile, nr - i0);
  for (int cc = warp; cc < kTile && j0 + cc < nc; cc += NT / 32)
    store_row(out + (j0 + cc) * nc + i0,
              tile + cc * kT4Pitch + misalign(out, j0 + cc, nc, i0), len_r,
              lane);
}

template <class M>
int launch_tc(const void* xr, const void* xc, void* out, int64_t nr,
              int64_t nc, int64_t d, int sym, cudaStream_t stream) {
  constexpr int smem = kRawBytes + 2 * M::kConvBytes;
  const int vec = d % 4 == 0 && (uintptr_t)xr % 16 == 0 &&
                  (uintptr_t)xc % 16 == 0;
  const int64_t blocks = n_tile_blocks((nr + kTile - 1) / kTile,
                                       (nc + kTile - 1) / kTile, sym);
  cudaFuncSetAttribute(tc_distance_kernel<M>,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  tc_distance_kernel<M><<<(unsigned)blocks, M::kThreads, smem, stream>>>(
      (const float*)xr, (const float*)xc, (float*)out, nr, nc, d, sym, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 braycurtis, 1 euclidean, 2 jaccard (f32 xr, xc; jaccard on
// presence data, 0.0 or 1.0), 3 jaccard_packed (int32 words, read as
// unsigned). out: (nr, nc) f32. symmetric: 1 when xr and xc are the same
// table (nr == nc), so only the tiles j >= i are computed and each is
// mirrored.
int distance_launch(int kind, const void* xr, const void* xc, void* out,
                    long long nr, long long nc, long long d, int symmetric,
                    void* stream) {
  if (nr < 1 || nc < 1 || d < 1 || (symmetric && nr != nc) ||
      n_tile_blocks((nr + kTile - 1) / kTile, (nc + kTile - 1) / kTile,
                    symmetric) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int sym = symmetric ? 1 : 0;
  switch (kind) {
    case 0: return launch<BrayCurtis>(xr, xc, out, nr, nc, d, sym, s);
    case 1: return launch_tc<Euclidean>(xr, xc, out, nr, nc, d, sym, s);
    case 2: return launch_tc<Jaccard>(xr, xc, out, nr, nc, d, sym, s);
    case 3: return launch<JaccardPacked>(xr, xc, out, nr, nc, d, sym, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
