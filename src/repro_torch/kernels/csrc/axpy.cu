// z = alpha * x + y over a batch of vectors laid end to end.
//
// Replaces the Pallas TPU kernel src/repro/kernels/axpy.py (axpy /
// _axpy_kernel).  There, alpha is a scalar-prefetch job word and the vector
// is padded to (rows, 1024) lane tiles; here alpha is a kernel argument and
// the kernel masks the ragged edges itself, so nothing is padded.
//
// Bound on the card: bytes.  Each element reads two values and writes one, at
// one FMA, far below the ~20 flop/byte the H100 needs before its FP units are
// the limit.  So the design keeps as many bytes in flight as it can:
//   - every access moves 16 bytes (2 doubles, 4 floats or 8 bf16), and
//     neighbouring threads take neighbouring 16-byte packs;
//   - each thread loads UNROLL packs of x and of y before it computes any,
//     so 2 * UNROLL independent loads are in flight a thread;
//   - the grid covers the work once (a shard of 2^20 doubles is 512 blocks,
//     under one wave), with no grid-stride loop.
// Where x, y and z all start on a 16-byte boundary, the elements after the
// last whole pack (the tail, shorter than one pack) are done one at a time by
// the first threads of the grid.  Otherwise (x or y a view off the boundary,
// as a slice of a fused stack can be) the same kernel runs with one element
// a pack.  The sum is taken in the accumulator type and rounded once.
#include <stdint.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256, UNROLL = 4;

// W elements of T, moved as one access of W * sizeof(T) bytes
template <typename T, int W>
struct alignas(W * sizeof(T)) Pack {
  T v[W];
};

template <typename T>
__device__ __forceinline__ T axpy1(typename AccOf<T>::type alpha, T x, T y) {
  return from_acc<T>(alpha * load_acc(x) + load_acc(y));
}

// elements [0, W * packs) as packs, and the tail [W * packs, total),
// shorter than W, one at a time
template <typename T, int W>
__global__ void __launch_bounds__(THREADS)
axpy_kernel(const T* __restrict__ x, const T* __restrict__ y, T* __restrict__ z,
            typename AccOf<T>::type alpha, long long packs, long long total) {
  using P = Pack<T, W>;
  const long long tid = (long long)blockIdx.x * THREADS + threadIdx.x;
  const long long tail0 = W * packs;
  if (tid < total - tail0) z[tail0 + tid] = axpy1(alpha, x[tail0 + tid], y[tail0 + tid]);
  const P* xp = reinterpret_cast<const P*>(x);
  const P* yp = reinterpret_cast<const P*>(y);
  P* zp = reinterpret_cast<P*>(z);
  const long long p0 = (long long)blockIdx.x * THREADS * UNROLL + threadIdx.x;
  P a[UNROLL], b[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long p = p0 + u * THREADS;
    if (p < packs) {
      a[u] = xp[p];
      b[u] = yp[p];
    }
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long p = p0 + u * THREADS;
    if (p < packs) {
      P r;
#pragma unroll
      for (int w = 0; w < W; ++w) r.v[w] = axpy1(alpha, a[u].v[w], b[u].v[w]);
      zp[p] = r;
    }
  }
}

template <typename T>
int launch(const T* x, const T* y, T* z, double alpha, long long total,
           cudaStream_t s) {
  using Acc = typename AccOf<T>::type;
  constexpr int W = 16 / sizeof(T);
  constexpr long long PER_BLOCK = (long long)THREADS * UNROLL;
  if (((uintptr_t)x | (uintptr_t)y | (uintptr_t)z) % 16 == 0) {
    const long long packs = total / W;
    const long long blocks = packs ? (packs + PER_BLOCK - 1) / PER_BLOCK : 1;
    axpy_kernel<T, W><<<(unsigned)blocks, THREADS, 0, s>>>(x, y, z, (Acc)alpha,
                                                           packs, total);
  } else {
    const long long blocks = (total + PER_BLOCK - 1) / PER_BLOCK;
    axpy_kernel<T, 1><<<(unsigned)blocks, THREADS, 0, s>>>(x, y, z, (Acc)alpha,
                                                           total, total);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_axpy(int dtype, const void* x, const void* y, void* z,
                          double alpha, long long total, void* stream) {
  if (total < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DTYPE_F64:
      return launch((const double*)x, (const double*)y, (double*)z, alpha, total, s);
    case DTYPE_F32:
      return launch((const float*)x, (const float*)y, (float*)z, alpha, total, s);
    case DTYPE_BF16:
      return launch((const __nv_bfloat16*)x, (const __nv_bfloat16*)y,
                    (__nv_bfloat16*)z, alpha, total, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
