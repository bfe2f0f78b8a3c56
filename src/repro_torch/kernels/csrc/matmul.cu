// C[b] = A[b] @ B[b] for a batch of row-major matrices.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py (matmul /
// _matmul_kernel), whose grid walks 128^3 MXU tiles with K innermost and an
// f32 VMEM accumulator carried across grid steps.  On the GPU the K loop runs
// inside the block instead: each block owns a 64x64 output tile, stages
// 64x16 panels of A and B through shared memory and keeps a 4x4 register
// micro-tile per thread in the accumulator type (double for fp64, float for
// f32 and bf16, with no TF32 anywhere).
//
// Bound on the card: operations at the large shapes (2MNK flops against
// (MK + KN + MN) elements), bytes at the job path's small per-cluster shards.
// This first version uses the CUDA cores only (no wgmma, TMA or DMMA); the
// shared-memory panels give every loaded element 64-fold reuse, and the
// padded, transposed A panel keeps shared-memory reads free of bank conflicts.
#include "common.cuh"

namespace {

constexpr int BM = 64, BN = 64, BK = 16, TM = 4, TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

template <typename T>
__global__ void __launch_bounds__(THREADS)
matmul_kernel(const T* __restrict__ A, const T* __restrict__ B, T* __restrict__ C,
              int M, int N, int K, long long sA, long long sB, long long sC) {
  using Acc = typename AccOf<T>::type;
  __shared__ Acc As[BK][BM + 1];  // A panel, transposed: As[k][row]
  __shared__ Acc Bs[BK][BN + 1];  // B panel: Bs[k][col]
  const long long b = blockIdx.z;
  A += b * sA;
  B += b * sB;
  C += b * sC;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x;
  const int tr = tid / (BN / TN), tc = tid % (BN / TN);
  Acc acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      int r = e / BK, c = e % BK;
      int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? load_acc(A[(long long)gr * K + gc]) : Acc(0);
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      int r = e / BN, c = e % BN;
      int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? load_acc(B[(long long)gr * N + gc]) : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tr + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = Bs[kk][tc + j * (BN / TN)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int r = row0 + tr + i * (BM / TM);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      int c = col0 + tc + j * (BN / TN);
      if (c < N) C[(long long)r * N + c] = from_acc<T>(acc[i][j]);
    }
  }
}

}  // namespace

extern "C" int repro_matmul(int dtype, const void* a, const void* b, void* c,
                            long long batch, int M, int N, int K, long long sA,
                            long long sB, long long sC, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || N < 1) return (int)cudaErrorInvalidValue;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, (unsigned)batch);
  cudaStream_t s = (cudaStream_t)stream;
#define MATMUL_LAUNCH(T)                                                      \
  matmul_kernel<T><<<grid, THREADS, 0, s>>>((const T*)a, (const T*)b, (T*)c, M, \
                                            N, K, sA, sB, sC)
  REPRO_DISPATCH_DTYPE(dtype, MATMUL_LAUNCH)
#undef MATMUL_LAUNCH
  return (int)cudaGetLastError();
}
