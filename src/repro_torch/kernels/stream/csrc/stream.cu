// STREAM bandwidth probe on Hopper (sm_90a): over 1-D float32 arrays of n
// elements,
//
//   copy   out = a
//   scale  out = s * a
//   add    out = a + b
//   triad  out = a + s * b
//
// It replaces src/repro/kernels/stream/kernel.py:35 (stream_pallas), which
// runs one (block,) slice per grid step. The probe exists to measure the
// device memory rate the card reaches (the paper's Appendix A2 method), so
// it is bound by bytes by construction: 2 or 3 arrays of 4 n bytes moved,
// no reuse, one multiply or add per element. Each thread moves 16-byte
// vectors (float4: a warp reads 512 contiguous bytes a load) in a grid-
// stride loop over n / 4 vectors, then the n % 4 tail element by element;
// a pointer that is not 16-byte aligned takes the element loop for the
// whole array. b is not read by copy and scale. The arithmetic is
// IEEE-rounded per operation (__fmul_rn / __fadd_rn, no FMA contraction),
// so triad gives the bits of torch's s * b then + a.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. The C entry point launches on the caller's
//        stream, never synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;     // resident blocks a grid-stride grid
                                    // keeps per SM

template <int Op>
__device__ __forceinline__ float apply(float a, float b, float s) {
  if (Op == 0) return a;
  if (Op == 1) return __fmul_rn(s, a);
  if (Op == 2) return __fadd_rn(a, b);
  return __fadd_rn(a, __fmul_rn(s, b));
}

template <int Op>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, int64_t n, float s, int vec) {
  constexpr bool kReadsB = Op >= 2;
  const int64_t tid = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  const int64_t stride = (int64_t)gridDim.x * kThreads;
  int64_t done = 0;
  if (vec) {
    const int64_t nv = n / 4;
    const float4* __restrict__ a4 = reinterpret_cast<const float4*>(a);
    const float4* __restrict__ b4 = reinterpret_cast<const float4*>(b);
    float4* __restrict__ o4 = reinterpret_cast<float4*>(out);
    for (int64_t v = tid; v < nv; v += stride) {
      const float4 x = __ldg(a4 + v);
      const float4 y = kReadsB ? __ldg(b4 + v) : make_float4(0.f, 0.f, 0.f,
                                                             0.f);
      o4[v] = make_float4(apply<Op>(x.x, y.x, s), apply<Op>(x.y, y.y, s),
                          apply<Op>(x.z, y.z, s), apply<Op>(x.w, y.w, s));
    }
    done = nv * 4;
  }
  for (int64_t i = done + tid; i < n; i += stride)
    out[i] = apply<Op>(__ldg(a + i), kReadsB ? __ldg(b + i) : 0.f, s);
}

template <int Op>
int launch(const void* a, const void* b, void* out, int64_t n, float s,
           cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int vec = ((uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
                   (uintptr_t)out % 16 == 0) ? 1 : 0;
  const int64_t work = vec ? (n + 3) / 4 : n;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  const int64_t cap = (int64_t)(sms > 0 ? sms : 1) * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  stream_kernel<Op><<<(unsigned)blocks, kThreads, 0, stream>>>(
      (const float*)a, (const float*)b, (float*)out, n, s, vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// op: 0 copy, 1 scale, 2 add, 3 triad. a, b, out (n,) float32 (b unread by
// copy and scale).
int stream_launch(int op, const void* a, const void* b, void* out,
                  long long n, float s, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (op) {
    case 0: return launch<0>(a, b, out, n, s, st);
    case 1: return launch<1>(a, b, out, n, s, st);
    case 2: return launch<2>(a, b, out, n, s, st);
    case 3: return launch<3>(a, b, out, n, s, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
