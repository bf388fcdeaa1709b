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
// no reuse, one multiply or add per element.
//
// What the design does about the bytes: each thread moves one 16-byte
// vector (float4: a warp moves 512 contiguous bytes an access) of each
// array, and the grid covers the arrays once in blocks of kThreads, so
// every block is short-lived and the SMs refill as blocks retire. On an
// H100 this ran at or just under PyTorch's calls, where a grid of one
// resident wave striding over the arrays ran 6-9% over them, even with 4
// vectors in flight a thread and streaming (evict-first) loads and
// stores, and 4 vectors a thread in blocks of 256 came within 2% either
// way (PERF.md section 6, row 10).
// The n % 4 tail goes element by element; a pointer that is not 16-byte
// aligned takes the element form for the whole array. b is not read by
// copy and scale. The arithmetic is IEEE-rounded per operation
// (__fmul_rn / __fadd_rn, no FMA contraction), so triad gives the bits of
// torch's s * b then + a.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC. The C entry point launches on the caller's
//        stream, never synchronises, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;

template <int Op>
__device__ __forceinline__ float apply(float a, float b, float s) {
  if (Op == 0) return a;
  if (Op == 1) return __fmul_rn(s, a);
  if (Op == 2) return __fadd_rn(a, b);
  return __fadd_rn(a, __fmul_rn(s, b));
}

template <int Op>
__device__ __forceinline__ float4 apply4(float4 x, float4 y, float s) {
  return make_float4(apply<Op>(x.x, y.x, s), apply<Op>(x.y, y.y, s),
                     apply<Op>(x.z, y.z, s), apply<Op>(x.w, y.w, s));
}

// One thread a vector (vec) or an element (not vec); the grid covers the
// arrays once.
template <int Op>
__global__ void __launch_bounds__(kThreads)
stream_kernel(const float* __restrict__ a, const float* __restrict__ b,
              float* __restrict__ out, int64_t n, float s, int vec) {
  constexpr bool kReadsB = Op >= 2;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (!vec) {
    if (t < n) out[t] = apply<Op>(__ldg(a + t), kReadsB ? __ldg(b + t) : 0.f,
                                  s);
    return;
  }
  const int64_t nv = n / 4;
  if (t < nv) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(a) + t);
    const float4 y = kReadsB ? __ldg(reinterpret_cast<const float4*>(b) + t)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    reinterpret_cast<float4*>(out)[t] = apply4<Op>(x, y, s);
  }
  const int64_t i = nv * 4 + t;    // the n % 4 tail, threads 0..2
  if (i < n) out[i] = apply<Op>(__ldg(a + i), kReadsB ? __ldg(b + i) : 0.f,
                                s);
}

template <int Op>
int launch(const void* a, const void* b, void* out, int64_t n, float s,
           cudaStream_t stream) {
  const int vec = ((uintptr_t)a % 16 == 0 && (uintptr_t)b % 16 == 0 &&
                   (uintptr_t)out % 16 == 0) ? 1 : 0;
  const int64_t blocks = ((vec ? (n + 3) / 4 : n) + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
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
