// Pairwise distances on Hopper (sm_90a): four kernels from one tile
// template. Rows xr (nr, d) against rows xc (nc, d), both row-major, give
// out (nr, nc) f32:
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
// copies overlap this chunk's arithmetic. Each of the 256 threads
// accumulates an 8 x 8 micro-tile in registers (rows 4 ty + [0, 4) and 64
// + 4 ty + [0, 4), columns likewise with tx, so its float4 reads of a
// staged feature row are conflict-free), and the finalize runs once after
// the loop. The per-row statistics (S_x, |x|^2, card_x) are summed by one
// thread per row or column of the tile from the same staged chunks, in
// feature order, so a sample's statistic is the same bits whether it is a
// row or a column of the tile.
//
// A whole-table call (xr and xc the same table, ops.is_symmetric_call)
// visits only the tiles j >= i, and writes each off-diagonal tile and its
// transpose: the finalized tile goes through shared memory (pitch 129, so
// both the row-wise and the column-wise reads are conflict-free) and both
// stores coalesce. The mirrored entry equals what a rectangular call
// computes there bit for bit: |a - b| = |b - a|, a b = b a, the feature
// loop runs in the same order for every pair, and S_x + S_y = S_y + S_x.
//
// Bray-Curtis's denominator sum_k (x_k + y_k) is S_x + S_y, formed from
// the row sums (the reference adds x + y per feature; the value differs
// only by f32 summation order). Both jaccard kernels call the same f32
// finalize on counts that are exact integers in f32 (d < 2^24), so the
// packed kernel equals the float one bit for bit.
//
// Ragged nr, nc and d are masked here (out-of-range rows are copied as 0
// and not stored; the last chunk's loop stops at d), so nothing is
// padded. Element offsets are 64-bit.
// Division and sqrt are nvcc's default IEEE-rounded forms (no
// --use_fast_math).
//
// What bounds it, at the main path's dense shape on an H100 SXM at 700 W
// (n = 25,145, d = 128): the feature loop, each pair once. Bray-Curtis
// issues two FP32 instructions per (pair, feature), a subtract and an add
// of its magnitude: n(n-1)/2 d of each, 2.42 ms at 128 lanes x 132 SMs x
// 1.98 GHz (1.21 ms at the 67 TFLOP/s f32 peak, the function's bound,
// which counts an FMA as two). Euclidean and jaccard issue one FMA, half
// that. The output write is 4 n^2 B = 2.53 GB, 0.75 ms of HBM at 3.35
// TB/s; jaccard_packed (an AND, a popcount and an add per word pair, on 4
// words a row) is bound by it. The features (12.9 MB) stay in L2.
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

struct Euclidean {
  using T = float;
  using Acc = float;
  static __device__ __forceinline__ float stat(float a) { return a * a; }
  static __device__ __forceinline__ void step(float& acc, float a, float b) {
    acc = fmaf(a, b, acc);
  }
  static __device__ __forceinline__ float finish(float dot, float sr,
                                                 float sc) {
    return sqrtf(fmaxf(sr + sc - 2.f * dot, 0.f));
  }
};

struct Jaccard {
  using T = float;
  using Acc = float;
  static __device__ __forceinline__ float stat(float a) { return a; }
  static __device__ __forceinline__ void step(float& acc, float a, float b) {
    acc = fmaf(a, b, acc);  // 0/1 products: an exact integer count
  }
  static __device__ __forceinline__ float finish(float inter, float sr,
                                                 float sc) {
    return jaccard_finalize(inter, sr, sc);
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

// A block's (row tile, column tile). A symmetric call visits the tiles
// j >= i, row tile by row tile (nt - bi tiles in row bi); a rectangular
// call every tile, the column tile fastest.
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
  int64_t bi = 0;
  while (b >= nti - bi) {
    b -= nti - bi;
    ++bi;
  }
  return {bi, bi + b};
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

}  // namespace

extern "C" {

// kind: 0 braycurtis, 1 euclidean, 2 jaccard (f32 xr, xc), 3 jaccard_packed
// (int32 words, read as unsigned). out: (nr, nc) f32. symmetric: 1 when xr
// and xc are the same table (nr == nc), so only the tiles j >= i are
// computed and each is mirrored.
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
    case 1: return launch<Euclidean>(xr, xc, out, nr, nc, d, sym, s);
    case 2: return launch<Jaccard>(xr, xc, out, nr, nc, d, sym, s);
    case 3: return launch<JaccardPacked>(xr, xc, out, nr, nc, d, sym, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
