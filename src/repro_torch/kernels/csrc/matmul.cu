// C[b] = A[b] @ B[b] for a batch of row-major matrices.
//
// Replaces the Pallas TPU kernel src/repro/kernels/matmul.py (matmul /
// _matmul_kernel), whose grid walks 128^3 MXU tiles with K innermost and an
// f32 VMEM accumulator carried across grid steps.  On the GPU the K loop runs
// inside the block instead, and the sum over K stays in one block (no
// split-K), so a result does not change from run to run.
//
// Bound on the card: operations at the large shapes (2MNK flops against
// (MK + KN + MN) elements), bytes at the job path's per-cluster shards: at
// n = 32 clusters each shard is 32 rows of A against all of B, so the
// kernel streams B (268 MB at 1024^3) once.
//
// fp64 (the job path) runs on the tensor cores: mma.sync m16n8k16 on f64
// (DMMA), IEEE fp64 products and sums with a double accumulator.  The tile
// height follows M (16, 32, 64 or 128 rows), so a skinny shard computes no
// tile of padding; tiles are 64 columns wide.  The K loop streams 16-deep
// panels of A and B through a ring of 3-4 stages of cp.async copies (16
// bytes each, zero-filled past the edges; 8 bytes each where a row length
// is odd), so several panels are in flight while the tensor cores work.
// Shared-memory rows are padded to 20 and 68 doubles (4 mod 16), which
// keeps each lane's 8-byte fragment loads free of bank conflicts.
//
// f32 and bf16 run on the CUDA cores: each block owns a 64x64 output tile,
// stages 64x16 panels of A and B through shared memory and keeps a 4x4
// register micro-tile per thread in f32, with no TF32 anywhere (the
// tensor cores would take f32 only as TF32).
#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---- f32 and bf16: CUDA cores ----------------------------------------------------

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


// ---- fp64: DMMA ---------------------------------------------------------------

namespace dmma {

constexpr int BN = 64, BK = 16;
constexpr int APAD = BK + 4;   // A row stride in doubles (20 = 4 mod 16)
constexpr int BPAD = BN + 4;   // B row stride in doubles (68 = 4 mod 16)

template <int BM, int WM, int WN, int STAGES>
struct Cfg {
  static constexpr int WARPS = (BM / WM) * (BN / WN);
  static constexpr int THREADS = 32 * WARPS;
  static constexpr int A_ELEMS = BM * APAD, B_ELEMS = BK * BPAD;
  static constexpr size_t SMEM = sizeof(double) * STAGES * (A_ELEMS + B_ELEMS);
};

template <int BM, int WM, int WN, int STAGES>
__global__ void __launch_bounds__(Cfg<BM, WM, WN, STAGES>::THREADS)
matmul_dmma_kernel(const double* __restrict__ A, const double* __restrict__ B,
                   double* __restrict__ C, int M, int N, int K, long long sA,
                   long long sB, long long sC, int vec) {
  using G = Cfg<BM, WM, WN, STAGES>;
  constexpr int MT = WM / 16, NT = WN / 8;  // 16x8 DMMA tiles a warp
  static_assert(BK == 16, "one m16n8k16 step a panel");
  extern __shared__ double smem[];
  double* As = smem;                          // [STAGES][BM][APAD]
  double* Bs = smem + STAGES * G::A_ELEMS;    // [STAGES][BK][BPAD]
  const long long b = blockIdx.z;
  A += b * sA;
  B += b * sB;
  C += b * sC;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int wr = (warp / (BN / WN)) * WM, wc = (warp % (BN / WN)) * WN;
  const int g = lane / 4, t = lane % 4;
  const int KT = (K + BK - 1) / BK;

  auto load = [&](int kt, int stage) {
    const int k0 = kt * BK;
    double* as = As + stage * G::A_ELEMS;
    double* bs = Bs + stage * G::B_ELEMS;
    for (int e = tid; e < BM * BK / 2; e += G::THREADS) {
      const int r = e / (BK / 2), c = (e % (BK / 2)) * 2;
      cp_async_f64x2(as + r * APAD + c, A, row0 + r, k0 + c, M, K, K, vec);
    }
    for (int e = tid; e < BK * BN / 2; e += G::THREADS) {
      const int r = e / (BN / 2), c = (e % (BN / 2)) * 2;
      cp_async_f64x2(bs + r * BPAD + c, B, k0 + r, col0 + c, K, N, N, vec);
    }
  };

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
    cp_async_wait<STAGES - 2>();   // panel kt has landed
    __syncthreads();               // ... for every thread; kt - 1 is free
    if (kt + STAGES - 1 < KT) load(kt + STAGES - 1, (kt + STAGES - 1) % STAGES);
    cp_async_commit();
    const double* as = As + (kt % STAGES) * G::A_ELEMS;
    const double* bs = Bs + (kt % STAGES) * G::B_ELEMS;
    double a[MT][8], bv[NT][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int v = 0; v < 8; ++v)
        a[i][v] = as[(wr + 16 * i + g + 8 * (v % 2)) * APAD + t + 4 * (v / 2)];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v)
        bv[j][v] = bs[(t + 4 * v) * BPAD + wc + 8 * j + g];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j) dmma_m16n8k16(acc[i][j], a[i], bv[j]);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = row0 + wr + 16 * i + 8 * h + g;
      if (r >= M) continue;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const int c = col0 + wc + 8 * j + 2 * t;
        if (c < N) C[(long long)r * N + c] = acc[i][j][2 * h];
        if (c + 1 < N) C[(long long)r * N + c + 1] = acc[i][j][2 * h + 1];
      }
    }
}

template <int BM, int WM, int WN, int STAGES>
int launch(const double* a, const double* b, double* c, long long batch,
           int M, int N, int K, long long sA, long long sB, long long sC,
           cudaStream_t s) {
  using G = Cfg<BM, WM, WN, STAGES>;
  auto kern = matmul_dmma_kernel<BM, WM, WN, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)G::SMEM);
  if (err != cudaSuccess) return (int)err;
  const bool aligned = !((uintptr_t)a % 16) && !((uintptr_t)b % 16);
  const int vec = aligned && K % 2 == 0 && N % 2 == 0;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, (unsigned)batch);
  kern<<<grid, G::THREADS, G::SMEM, s>>>(a, b, c, M, N, K, sA, sB, sC, vec);
  return (int)cudaGetLastError();
}

// The tile height follows M, so no block computes a tile of padding only;
// skinny tiles take 8 warps of 16 rows, which keeps more DMMAs in flight
// a block.  128-row tiles (fewer bytes a flop from L2) only where they
// still give every SM two blocks.
int run(const double* a, const double* b, double* c, long long batch, int M,
        int N, int K, long long sA, long long sB, long long sC,
        cudaStream_t s) {
  if (M <= 16) return launch<16, 16, 16, 4>(a, b, c, batch, M, N, K, sA, sB, sC, s);
  if (M <= 32) return launch<32, 16, 16, 4>(a, b, c, batch, M, N, K, sA, sB, sC, s);
  const long long tiles128 = batch * ((M + 127) / 128) * ((N + BN - 1) / BN);
  if (M <= 64 || tiles128 < 2 * 132)
    return launch<64, 16, 32, 4>(a, b, c, batch, M, N, K, sA, sB, sC, s);
  return launch<128, 32, 32, 3>(a, b, c, batch, M, N, K, sA, sB, sC, s);
}

}  // namespace dmma

}  // namespace

extern "C" int repro_matmul(int dtype, const void* a, const void* b, void* c,
                            long long batch, int M, int N, int K, long long sA,
                            long long sB, long long sC, void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == DTYPE_F64)
    return dmma::run((const double*)a, (const double*)b, (double*)c, batch, M,
                     N, K, sA, sB, sC, s);
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, (unsigned)batch);
  switch (dtype) {
    case DTYPE_F32:
      matmul_kernel<float><<<grid, THREADS, 0, s>>>(
          (const float*)a, (const float*)b, (float*)c, M, N, K, sA, sB, sC);
      break;
    case DTYPE_BF16:
      matmul_kernel<__nv_bfloat16><<<grid, THREADS, 0, s>>>(
          (const __nv_bfloat16*)a, (const __nv_bfloat16*)b, (__nv_bfloat16*)c,
          M, N, K, sA, sB, sC);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
