// cov[b] = (X[b] - mu)(X[b] - mu)^T / (N - 1) for a batch of (M, N) data
// matrices (rows are variables, columns samples).
//
// Replaces the Pallas TPU kernel src/repro/kernels/covariance.py (covariance /
// _cov_kernel).  There the mean pass runs in XLA before the kernel and the
// kernel computes (bm, bm) output tiles from (bm, N) row panels held whole in
// VMEM.  Here both passes are hand-written:
//   1. row_mean_kernel: one warp per row sums it in the accumulator type.
//   2. cov_kernel: a SYRK.  Only tiles on or above the diagonal are computed
//      (T(T+1)/2 blocks for T tiles a side); each block streams 64x16 panels
//      of both row sets through shared memory, centring them as they load, and
//      writes its tile and, off the diagonal, the mirrored tile.  The mirror is
//      the same value, so the result is exactly symmetric.
//
// Bound on the card: operations at the large shapes (M^2 N flops for the
// upper triangle against MN + M^2 elements), bytes at the job path's small
// shapes.  This first version runs on the CUDA cores; the triangle halves the
// work of the full product the TPU kernel computes.
#include "common.cuh"

namespace {

constexpr int BM = 64, BK = 16, TM = 4;
constexpr int THREADS = (BM / TM) * (BM / TM);  // 256

template <typename T>
__global__ void row_mean_kernel(const T* __restrict__ X,
                                typename AccOf<T>::type* __restrict__ mean, int N,
                                long long rows) {
  using Acc = typename AccOf<T>::type;
  const int warps = blockDim.x / 32, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (long long r = (long long)blockIdx.x * warps + warp; r < rows;
       r += (long long)gridDim.x * warps) {
    const T* row = X + r * N;
    Acc s = Acc(0);
    for (int j = lane; j < N; j += 32) s += load_acc(row[j]);
    s = warp_sum(s);
    if (lane == 0) mean[r] = s / Acc(N);
  }
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
cov_kernel(const T* __restrict__ X, const typename AccOf<T>::type* __restrict__ mean,
           T* __restrict__ C, int M, int N, int tiles, double denom) {
  using Acc = typename AccOf<T>::type;
  __shared__ Acc As[BK][BM + 1];  // centred rows of tile ti, transposed
  __shared__ Acc Bs[BK][BM + 1];  // centred rows of tile tj, transposed
  const long long b = blockIdx.y;
  X += b * (long long)M * N;
  mean += b * (long long)M;
  C += b * (long long)M * M;
  // linear block index -> (ti, tj) with ti <= tj
  int t = blockIdx.x, ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  const int tj = ti + t;
  const int row0 = ti * BM, col0 = tj * BM;
  const int tid = threadIdx.x;
  const int tr = tid / (BM / TM), tc = tid % (BM / TM);
  Acc acc[TM][TM];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TM; ++j) acc[i][j] = Acc(0);

  for (int k0 = 0; k0 < N; k0 += BK) {
    for (int e = tid; e < BM * BK; e += THREADS) {
      int r = e / BK, c = e % BK, gc = k0 + c;
      int gi = row0 + r, gj = col0 + r;
      As[c][r] = (gi < M && gc < N) ? load_acc(X[(long long)gi * N + gc]) - mean[gi] : Acc(0);
      Bs[c][r] = (gj < M && gc < N) ? load_acc(X[(long long)gj * N + gc]) - mean[gj] : Acc(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      Acc a[TM], bv[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][tr + i * (BM / TM)];
#pragma unroll
      for (int j = 0; j < TM; ++j) bv[j] = Bs[kk][tc + j * (BM / TM)];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TM; ++j) acc[i][j] += a[i] * bv[j];
    }
    __syncthreads();
  }
  const Acc d = Acc(denom);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    int r = row0 + tr + i * (BM / TM);
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TM; ++j) {
      int c = col0 + tc + j * (BM / TM);
      if (c >= M) continue;
      T v = from_acc<T>(acc[i][j] / d);
      C[(long long)r * M + c] = v;
      if (ti != tj) C[(long long)c * M + r] = v;
    }
  }
}

}  // namespace

// mean: scratch of batch * M accumulator-typed elements.
extern "C" int repro_covariance(int dtype, const void* x, void* mean, void* c,
                                long long batch, int M, int N, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || N < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = batch * M;
  long long mblocks = (rows + 7) / 8;
  if (mblocks > 132 * 16) mblocks = 132 * 16;
  const int tiles = (M + BM - 1) / BM;
  const int tri = tiles * (tiles + 1) / 2;
#define COV_LAUNCH(T)                                                          \
  {                                                                            \
    using Acc = typename AccOf<T>::type;                                       \
    row_mean_kernel<T><<<(unsigned)mblocks, 256, 0, s>>>((const T*)x, (Acc*)mean, \
                                                         N, rows);             \
    cudaError_t err = cudaGetLastError();                                      \
    if (err != cudaSuccess) return (int)err;                                   \
    cov_kernel<T><<<dim3(tri, (unsigned)batch), THREADS, 0, s>>>(              \
        (const T*)x, (const Acc*)mean, (T*)c, M, N, tiles, (double)(N - 1));   \
  }
  REPRO_DISPATCH_DTYPE(dtype, COV_LAUNCH)
#undef COV_LAUNCH
  return (int)cudaGetLastError();
}
