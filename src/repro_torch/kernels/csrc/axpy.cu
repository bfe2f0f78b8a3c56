// z = alpha * x + y over a batch of vectors laid end to end.
//
// Replaces the Pallas TPU kernel src/repro/kernels/axpy.py (axpy /
// _axpy_kernel).  There, alpha is a scalar-prefetch job word and the vector
// is padded to (rows, 1024) lane tiles; here alpha is a kernel argument and a
// grid-stride loop masks the ragged edge, so nothing is padded.
//
// Bound on the card: bytes.  Each element reads two values and writes one, at
// one FMA, far below the ~20 flop/byte the H100 needs before its FP units are
// the limit.  The design keeps neighbouring threads on neighbouring addresses
// (coalesced loads and stores) and caps the grid at a few blocks per SM.
#include "common.cuh"

template <typename T>
__global__ void axpy_kernel(const T* __restrict__ x, const T* __restrict__ y,
                            T* __restrict__ z, typename AccOf<T>::type alpha,
                            long long total) {
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    z[i] = from_acc<T>(alpha * load_acc(x[i]) + load_acc(y[i]));
  }
}

extern "C" int repro_axpy(int dtype, const void* x, const void* y, void* z,
                          double alpha, long long total, void* stream) {
  const int threads = 256;
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  cudaStream_t s = (cudaStream_t)stream;
#define AXPY_LAUNCH(T)                                                    \
  axpy_kernel<T><<<(unsigned)blocks, threads, 0, s>>>(                    \
      (const T*)x, (const T*)y, (T*)z, (typename AccOf<T>::type)alpha, total)
  REPRO_DISPATCH_DTYPE(dtype, AXPY_LAUNCH)
#undef AXPY_LAUNCH
  return (int)cudaGetLastError();
}
