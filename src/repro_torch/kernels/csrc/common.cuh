// Shared helpers for the port's Hopper kernels (built for sm_90a).
//
// Every kernel is templated on its element type: double (the fp64 job path),
// float and __nv_bfloat16 (the standalone sweeps).  Arithmetic runs in the
// accumulator type Acc: double for double, float otherwise, so an fp64 job is
// never summed in f32.  The C entry points take a dtype code (DTYPE_*), launch
// on the stream they are given, and return cudaGetLastError().
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

enum DtypeCode { DTYPE_F64 = 0, DTYPE_F32 = 1, DTYPE_BF16 = 2 };

template <typename T>
struct AccOf {
  using type = float;
};
template <>
struct AccOf<double> {
  using type = double;
};

__device__ __forceinline__ double load_acc(double v) { return v; }
__device__ __forceinline__ float load_acc(float v) { return v; }
__device__ __forceinline__ float load_acc(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_acc(typename AccOf<T>::type v);
template <>
__device__ __forceinline__ double from_acc<double>(double v) {
  return v;
}
template <>
__device__ __forceinline__ float from_acc<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename Acc>
__device__ __forceinline__ Acc warp_sum(Acc v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// Dispatch a templated launch on a dtype code: LAUNCH(T) must be a macro
// that expands to the launch for element type T.
#define REPRO_DISPATCH_DTYPE(code, LAUNCH)    \
  switch (code) {                             \
    case DTYPE_F64:                           \
      LAUNCH(double);                         \
      break;                                  \
    case DTYPE_F32:                           \
      LAUNCH(float);                          \
      break;                                  \
    case DTYPE_BF16:                          \
      LAUNCH(__nv_bfloat16);                  \
      break;                                  \
    default:                                  \
      return (int)cudaErrorInvalidValue;      \
  }
