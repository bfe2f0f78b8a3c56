// cov[b] = (X[b] - mu)(X[b] - mu)^T / (N - 1) for a batch of (M, N) data
// matrices (rows are variables, columns samples).
//
// Replaces the Pallas TPU kernel src/repro/kernels/covariance.py (covariance /
// _cov_kernel).  There the mean pass runs in XLA before the kernel and the
// kernel computes (bm, bm) output tiles from (bm, N) row panels held whole in
// VMEM.  Here both passes are hand-written:
//   1. row_mean_kernel: one warp per row sums it in the accumulator type.
//      It reads X once.  The one-pass form (N sum x_i x_j - s_i s_j) is not
//      used: it cancels badly on data whose mean is large against its spread.
//   2. a SYRK: only tiles on or above the diagonal are computed (T(T+1)/2
//      blocks for T tiles a side), each block keeps the whole sum over N (no
//      split-K, so the result does not change from run to run) and writes
//      its tile and its mirror with the same values, so the result is
//      exactly symmetric.  On a diagonal tile only the upper triangle is
//      taken from the accumulators and mirrored.
//
// Bound on the card: operations at the large shapes (M^2 N flops for the
// upper triangle against MN + M^2 elements), bytes at the job path's small
// shapes.
//
// fp64 (the job path) runs on the tensor cores: cov_dmma_kernel, mma.sync
// m16n8k16 on f64 (DMMA).  Both operands are row panels of X (rows row0.. for
// A, rows col0.. for B), staged 16 k-values a row, padded to 20 doubles, so
// the .col B fragment (B[k][n] = X[col0 + n][k]) loads down a row exactly as
// the A fragment does, free of bank conflicts.  The panels come through a
// ring of 3-4 cp.async stages (16-byte copies where X is 16-byte aligned and
// N even, 8-byte ones otherwise, zero-filled past the edges); a diagonal
// tile loads one panel for both.  cp.async lands raw X; each thread then
// centres the pairs it copied, in place, as soon as they have landed (a
// thread sees its own cp.async writes after the wait, so the ring's one
// barrier a panel still suffices), with its rows' means in registers for
// the whole K loop.  So each element is centred once, not once for every
// warp that reads it as a fragment.  Past N the zero fill would become -mu
// and add (padded k) * mu_i * mu_j to every entry: those elements stay 0.
// Rows past M are zero-filled and take a mean of 0.
// Tiles are square and their side follows M: 16 at M <= 16, 32 at M <= 32,
// 64 above; 128 (half the bytes a flop from L2) only where it still gives
// the grid two blocks for every SM, since a 128 tile holds a whole SM.
//
// f32 and bf16 run on the CUDA cores in true f32 (never TF32: the reference
// accumulates in f32): 64x64 tiles, 16-deep panels through one shared-memory
// stage, centred as they load, and a 4x4 register micro-tile per thread.
#include "common.cuh"
#include "hopper.cuh"

namespace {

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

// linear block index -> tile (ti, tj) with ti <= tj, T tiles a side
__device__ __forceinline__ void upper_tile(int t, int tiles, int& ti, int& tj) {
  ti = 0;
  while (t >= tiles - ti) {
    t -= tiles - ti;
    ++ti;
  }
  tj = ti + t;
}

// ---- f32 and bf16: CUDA cores ----------------------------------------------------

constexpr int BM = 64, BK = 16, TM = 4;
constexpr int THREADS = (BM / TM) * (BM / TM);  // 256

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
  int ti, tj;
  upper_tile(blockIdx.x, tiles, ti, tj);
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

// ---- fp64: DMMA ---------------------------------------------------------------

namespace dmma {

constexpr int BK = 16;
constexpr int PAD = BK + 4;   // panel row stride in doubles (20 = 4 mod 16)

template <int BM, int WM, int WN, int STAGES>
struct Cfg {
  static constexpr int WARPS = (BM / WM) * (BM / WN);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int PANEL = BM * PAD;   // one operand's stage, in doubles
  static constexpr size_t SMEM = sizeof(double) * STAGES * 2 * PANEL;
};

// acc += A panel . B panel^T for one 16-deep panel (both centred).  Lane
// (g, t) reads A[g + 8 h][t + 4 q] and B[g][t + 4 q] of each 16x16 / 8x16
// fragment: rows 20 doubles apart, so a half-warp's 8-byte loads fall in 16
// distinct banks.
template <int MT, int NT>
__device__ __forceinline__ void panel_product(double (&acc)[MT][NT][4],
                                              const double* as,
                                              const double* bs, int wr,
                                              int wc, int g, int t) {
  double a[MT][8], bv[NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int v = 0; v < 8; ++v)
      a[i][v] = as[(wr + 16 * i + g + 8 * (v % 2)) * PAD + t + 4 * (v / 2)];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) bv[j][v] = bs[(wc + 8 * j + g) * PAD + t + 4 * v];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j) dmma_m16n8k16(acc[i][j], a[i], bv[j]);
}

template <int BM, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(Cfg<BM, WM, WN, STAGES>::THREADS)
cov_dmma_kernel(const double* __restrict__ X, const double* __restrict__ mean,
                double* __restrict__ C, int M, int N, int tiles, double denom,
                int vec) {
  using G = Cfg<BM, WM, WN, STAGES>;
  constexpr int MT = WM / 16, NT = WN / 8;  // 16x8 DMMA tiles a warp
  extern __shared__ double smem[];
  double* As = smem;                        // [STAGES][BM][PAD]: rows row0..
  double* Bs = smem + STAGES * G::PANEL;    // [STAGES][BM][PAD]: rows col0..
  const long long b = blockIdx.y;
  X += b * (long long)M * N;
  mean += b * (long long)M;
  C += b * (long long)M * M;
  int ti, tj;
  upper_tile(blockIdx.x, tiles, ti, tj);
  const bool diag = ti == tj;               // one panel serves as A and B
  const int row0 = ti * BM, col0 = tj * BM;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = (warp / (BM / WN)) * WM, wc = (warp % (BM / WN)) * WN;
  const int g = lane / 4, t = lane % 4;
  const int KT = (N + BK - 1) / BK;
  // each thread copies, and then centres, PER pairs of each panel: pair
  // q is row (tid + q THREADS) / 8, columns 2 ((tid + q THREADS) % 8) + {0, 1}
  constexpr int PER = BM * BK / 2 / G::THREADS;
  static_assert(PER * G::THREADS == BM * BK / 2, "whole pairs a thread");

  auto load = [=](int kt, int stage) {
    const int k0 = kt * BK;
    double* as = As + stage * G::PANEL;
    double* bs = Bs + stage * G::PANEL;
#pragma unroll
    for (int q = 0; q < PER; ++q) {
      const int e = tid + q * G::THREADS;
      const int r = e / (BK / 2), c = (e % (BK / 2)) * 2;
      cp_async_f64x2(as + r * PAD + c, X, row0 + r, k0 + c, M, N, N, vec);
      if (!diag)
        cp_async_f64x2(bs + r * PAD + c, X, col0 + r, k0 + c, M, N, N, vec);
    }
  };

  // the means of the rows this thread copies (0 past M, whose rows are
  // zero-filled)
  double mu_a[PER], mu_b[PER];
#pragma unroll
  for (int q = 0; q < PER; ++q) {
    const int r = (tid + q * G::THREADS) / (BK / 2);
    mu_a[q] = row0 + r < M ? mean[row0 + r] : 0.0;
    mu_b[q] = col0 + r < M ? mean[col0 + r] : 0.0;
  }

  double acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();   // this thread's copies of panel kt landed
    // ... and a thread sees its own cp.async writes after the wait: it
    // centres its pairs in place.  Past N the zero fill would become -mu,
    // so those stay 0
    {
      const int k0 = kt * BK;
      double* as = As + (kt % STAGES) * G::PANEL;
      double* bs = Bs + (kt % STAGES) * G::PANEL;
#pragma unroll
      for (int q = 0; q < PER; ++q) {
        const int e = tid + q * G::THREADS;
        const int r = e / (BK / 2), c = (e % (BK / 2)) * 2;
        const bool in0 = k0 + c < N, in1 = k0 + c + 1 < N;
        double2* pa = reinterpret_cast<double2*>(as + r * PAD + c);
        const double2 va = *pa;
        *pa = make_double2(in0 ? va.x - mu_a[q] : 0.0, in1 ? va.y - mu_a[q] : 0.0);
        if (!diag) {
          double2* pb = reinterpret_cast<double2*>(bs + r * PAD + c);
          const double2 vb = *pb;
          *pb = make_double2(in0 ? vb.x - mu_b[q] : 0.0, in1 ? vb.y - mu_b[q] : 0.0);
        }
      }
    }
    __syncthreads();               // panel kt centred for all; kt - 1 is free
    if (kt + STAGES - 1 < KT) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const double* as = As + (kt % STAGES) * G::PANEL;
    panel_product<MT, NT>(acc, as, diag ? as : Bs + (kt % STAGES) * G::PANEL,
                          wr, wc, g, t);
  }
  cp_async_wait<0>();

  // (r, c) from the accumulators where c >= r, and its mirror (c, r)
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wr + 16 * i + 8 * h + g;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int c = col0 + wc + 8 * j + 2 * t + cc;
          if (c >= M || c < r) continue;
          const double v = acc[i][j][2 * h + cc] / denom;
          C[(long long)r * M + c] = v;
          if (c != r) C[(long long)c * M + r] = v;
        }
    }
}

template <int BM, int WM, int WN, int STAGES>
int launch(const double* x, const double* mean, double* c, long long batch,
           int M, int N, cudaStream_t s) {
  using G = Cfg<BM, WM, WN, STAGES>;
  auto kern = cov_dmma_kernel<BM, WM, WN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int vec = !((uintptr_t)x % 16) && N % 2 == 0;
  const int tiles = (M + BM - 1) / BM;
  dim3 grid(tiles * (tiles + 1) / 2, (unsigned)batch);
  kern<<<grid, G::THREADS, G::SMEM, s>>>(x, mean, c, M, N, tiles,
                                         (double)(N - 1), vec);
  return (int)cudaGetLastError();
}

int run(const double* x, const double* mean, double* c, long long batch, int M,
        int N, cudaStream_t s) {
  if (M <= 16) return launch<16, 16, 8, 4>(x, mean, c, batch, M, N, s);
  if (M <= 32) return launch<32, 16, 16, 4>(x, mean, c, batch, M, N, s);
  const long long t128 = (M + 127) / 128;
  if (M <= 64 || batch * t128 * (t128 + 1) / 2 < 2 * 132)
    return launch<64, 16, 32, 4>(x, mean, c, batch, M, N, s);
  return launch<128, 32, 32, 3>(x, mean, c, batch, M, N, s);
}

}  // namespace dmma

}  // namespace

// mean: scratch of batch * M accumulator-typed elements.
extern "C" int repro_covariance(int dtype, const void* x, void* mean, void* c,
                                long long batch, int M, int N, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || N < 2) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long rows = batch * M;
  long long mblocks = (rows + 7) / 8;
  if (mblocks > 132 * 16) mblocks = 132 * 16;
#define MEAN_LAUNCH(T)                                                         \
  {                                                                            \
    using Acc = typename AccOf<T>::type;                                       \
    row_mean_kernel<T><<<(unsigned)mblocks, 256, 0, s>>>((const T*)x, (Acc*)mean, \
                                                         N, rows);             \
  }
  REPRO_DISPATCH_DTYPE(dtype, MEAN_LAUNCH)
#undef MEAN_LAUNCH
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (dtype == DTYPE_F64)
    return dmma::run((const double*)x, (const double*)mean, (double*)c, batch,
                     M, N, s);
  const int tiles = (M + BM - 1) / BM;
  dim3 grid(tiles * (tiles + 1) / 2, (unsigned)batch);
  switch (dtype) {
    case DTYPE_F32:
      cov_kernel<float><<<grid, THREADS, 0, s>>>(
          (const float*)x, (const float*)mean, (float*)c, M, N, tiles,
          (double)(N - 1));
      break;
    case DTYPE_BF16:
      cov_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          (const __nv_bfloat16*)x, (const float*)mean, (__nv_bfloat16*)c, M,
          N, tiles, (double)(N - 1));
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
