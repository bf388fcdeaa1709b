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
// feature step. Here each block owns a 64 x 64 output tile and loops over
// the features itself: a 32-feature chunk of its 64 rows and 64 columns is
// staged in static shared memory (17.9 KB), each of the 256 threads
// accumulates a 4 x 4 micro-tile in registers, and the finalize runs once
// after the loop. The per-row statistics (S_x, |x|^2, card_x) are summed
// by one thread per row of the tile from the same staged chunks.
//
// Bray-Curtis's denominator sum_k (x_k + y_k) is S_x + S_y, formed from
// the row sums (the reference adds x + y per feature; the value differs
// only by f32 summation order). Both jaccard kernels call the same f32
// finalize on counts that are exact integers in f32 (d < 2^24), so the
// packed kernel equals the float one bit for bit.
//
// Ragged nr, nc and d are masked here (out-of-range features load as 0,
// which adds nothing to any metric; out-of-range rows are not stored), so
// nothing is padded. Element offsets are 64-bit. Division and sqrt are
// nvcc's default IEEE-rounded forms (no --use_fast_math).
//
// Bound at the main path's dense shape on an H100 SXM at 700 W
// (n = 25,145, d = 128): the output write is 4 n^2 B = 2.53 GB, 0.75 ms of
// HBM at 3.35 TB/s; the feature loop is 2 n^2 d = 1.6e11 operations
// (braycurtis: a subtract and an add of its magnitude; euclidean and
// jaccard: one fused multiply-add), 2.4 ms at 67 TFLOP/s f32, so those
// three are bound by operations. jaccard_packed does 3 integer operations
// per word pair on 4 words a row and is bound by the output write. The
// staged tiles make each feature read from L2 n / 64 times instead of n.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. The C entry point returns cudaGetLastError()
//        after the launch; it launches on the caller's stream and never
//        synchronises.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;          // 16 x 16 threads
constexpr int kTile = 64;              // output rows (and cols) per block
constexpr int kMicro = 4;              // each thread owns 4 x 4 outputs
constexpr int kChunk = 32;             // features (words) staged per step
constexpr int kPitch = kTile + 4;      // keeps 16-byte micro-tile reads
constexpr int kMaxGridY = 65535;

__device__ __forceinline__ int64_t min64(int64_t a, int64_t b) {
  return a < b ? a : b;
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

template <class T>
__device__ __forceinline__ void load4(const T* p, T v[kMicro]) {
  const typename Vec4<T>::type q =
      *reinterpret_cast<const typename Vec4<T>::type*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}

// Grid (ceil(nc / 64), ceil(nr / 64)); block (bx, by) writes
// out[by*64 : by*64 + 64, bx*64 : bx*64 + 64]. Thread (ty, tx) owns rows
// by*64 + 4 ty + [0, 4) and cols bx*64 + 4 tx + [0, 4). Threads 0-63 sum
// the row statistic of tile row t, threads 64-127 the column statistic.
template <class M>
__global__ void __launch_bounds__(kThreads)
distance_kernel(const typename M::T* __restrict__ xr,
                const typename M::T* __restrict__ xc,
                float* __restrict__ out, int64_t nr, int64_t nc, int64_t d) {
  using T = typename M::T;
  __shared__ __align__(16) T rs[kChunk][kPitch];
  __shared__ __align__(16) T cs[kChunk][kPitch];
  __shared__ float row_stat[kTile];
  __shared__ float col_stat[kTile];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t i0 = (int64_t)blockIdx.y * kTile;
  const int64_t j0 = (int64_t)blockIdx.x * kTile;

  typename M::Acc acc[kMicro][kMicro];
#pragma unroll
  for (int a = 0; a < kMicro; ++a)
#pragma unroll
    for (int b = 0; b < kMicro; ++b) acc[a][b] = 0;
  float stat = 0.f;

  for (int64_t k0 = 0; k0 < d; k0 += kChunk) {
    const int kn = (int)min64(kChunk, d - k0);
    // Stage the chunk transposed: a warp reads 32 consecutive features of
    // one row (coalesced) and writes them down one column of rs / cs.
    for (int e = threadIdx.x; e < kTile * kChunk; e += kThreads) {
      const int r = e / kChunk, k = e % kChunk;
      const int64_t i = i0 + r, j = j0 + r;
      T a = T(0), b = T(0);
      if (k < kn) {
        if (i < nr) a = xr[i * d + k0 + k];
        if (j < nc) b = xc[j * d + k0 + k];
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
      T a[kMicro], b[kMicro];
      load4(&rs[k][ty * kMicro], a);
      load4(&cs[k][tx * kMicro], b);
#pragma unroll
      for (int ii = 0; ii < kMicro; ++ii)
#pragma unroll
        for (int jj = 0; jj < kMicro; ++jj) M::step(acc[ii][jj], a[ii], b[jj]);
    }
    __syncthreads();  // the chunk's readers are done before it is replaced
  }

  if (threadIdx.x < kTile)
    row_stat[threadIdx.x] = stat;
  else if (threadIdx.x < 2 * kTile)
    col_stat[threadIdx.x - kTile] = stat;
  __syncthreads();

#pragma unroll
  for (int ii = 0; ii < kMicro; ++ii) {
    const int64_t i = i0 + ty * kMicro + ii;
    if (i >= nr) continue;
    const float sr = row_stat[ty * kMicro + ii];
#pragma unroll
    for (int jj = 0; jj < kMicro; ++jj) {
      const int64_t j = j0 + tx * kMicro + jj;
      if (j < nc)
        out[i * nc + j] = M::finish(acc[ii][jj], sr,
                                    col_stat[tx * kMicro + jj]);
    }
  }
}

template <class M>
int launch(const void* xr, const void* xc, void* out, int64_t nr,
           int64_t nc, int64_t d, cudaStream_t stream) {
  const dim3 grid((unsigned)((nc + kTile - 1) / kTile),
                  (unsigned)((nr + kTile - 1) / kTile));
  distance_kernel<M><<<grid, kThreads, 0, stream>>>(
      (const typename M::T*)xr, (const typename M::T*)xc, (float*)out, nr,
      nc, d);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// kind: 0 braycurtis, 1 euclidean, 2 jaccard (f32 xr, xc), 3 jaccard_packed
// (int32 words, read as unsigned). out: (nr, nc) f32.
int distance_launch(int kind, const void* xr, const void* xc, void* out,
                    long long nr, long long nc, long long d, void* stream) {
  if (nr < 1 || nc < 1 || d < 1 || (nr + kTile - 1) / kTile > kMaxGridY ||
      (nc + kTile - 1) / kTile > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (kind) {
    case 0: return launch<BrayCurtis>(xr, xc, out, nr, nc, d, s);
    case 1: return launch<Euclidean>(xr, xc, out, nr, nc, d, s);
    case 2: return launch<Jaccard>(xr, xc, out, nr, nc, d, s);
    case 3: return launch<JaccardPacked>(xr, xc, out, nr, nc, d, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
