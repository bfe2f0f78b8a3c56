// Causal or full attention with an online softmax: O = softmax(Q Kᵀ/√D) V.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel).  It computes that kernel's function,
// not its block schedule: there, a sequential kv-innermost grid carries the
// running max, denominator and accumulator in VMEM scratch from one grid step
// to the next.  CUDA blocks run in no order, so here one block owns one
// (batch·query head, 64-row query tile) and walks the KV tiles in a loop of
// its own, keeping all three in f32 (the accumulator in registers, max and
// denominator in shared memory).
//
// Semantics, as the port's plain version (kernels/ref.py: attention) has them:
//   * the causal mask is aligned bottom-right, col <= row + (Skv - Sq), as
//     ref.attention and the model's _mask have it (the TPU kernel aligns
//     top-left; the two agree only for Sq == Skv);
//   * KV tiles wholly above the diagonal are never loaded; columns >= Skv
//     never attend; a row with no visible column outputs 0 (the plain
//     version gives the mean of V there; only causal Sq > Skv has such rows);
//   * GQA: query head h reads KV head h / (Hq / Hkv); nothing is repeated
//     in memory;
//   * f32 or bf16 in, f32 arithmetic throughout (no TF32: the products run
//     on the CUDA cores), output in the input's type; head dims 32, 64, 80
//     and 128, with no padding.
// Masked scores are held as -inf, so exp() gives exactly 0 for them, while
// the running max starts at -1e30 as in the reference: no -inf - -inf ever.
//
// Bound on the card: about 4·Sq·Skv·D operations per query head (halved by
// the causal mask) against 2·(Sq·Hq + Skv·Hkv)·D elements moved.  At the
// serving prefill (Yi-9B, 4 x 512 tokens, bf16) that is bytes, 37.7 MB
// against 8.6 GFLOP; longer sequences are bound by operations.  This
// first version runs both products on the CUDA
// cores from shared-memory tiles (4x4 and 4x(D/16) register micro-tiles per
// thread, padded rows against bank conflicts); mma/wgmma, TMA and warp
// specialisation are later work.
#include <math.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64, BKV = 64, THREADS = 256;
constexpr float NEG = -1e30f;

template <int D>
struct FlashSmem {
  static constexpr int QS = BQ * (D + 1);    // Q tile, rows padded by one
  static constexpr int KS = BKV * (D + 1);   // K tile, rows padded by one
  static constexpr int VS = BKV * D;         // V tile
  static constexpr int SS = BQ * (BKV + 1);  // scores, then probabilities
  static constexpr size_t BYTES = sizeof(float) * (QS + KS + VS + SS + 3 * BQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ o, int Hq, int rep,
             int Sq, int Skv, int causal, float scale) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int NJ = D / 16;
  using S = FlashSmem<D>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + S::QS;
  float* Vs = Ks + S::KS;
  float* Ss = Vs + S::VS;
  float* m_s = Ss + S::SS;   // running max per row
  float* l_s = m_s + BQ;     // running denominator per row
  float* a_s = l_s + BQ;     // this tile's rescale factor per row

  const int bh = blockIdx.y;
  const int b = bh / Hq, h = bh % Hq;
  const long long kvh = (long long)b * (Hq / rep) + h / rep;
  const int q0 = blockIdx.x * BQ;
  const T* qp = q + (long long)bh * Sq * D;
  const T* kp = k + kvh * Skv * D;
  const T* vp = v + kvh * Skv * D;
  T* op = o + (long long)bh * Sq * D;
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;   // rows tr+16i, columns tc+16j
  const int shift = Skv - Sq;               // bottom-right causal offset

  for (int e = tid; e < BQ * D; e += THREADS) {
    int r = e / D, c = e % D, gr = q0 + r;
    Qs[r * (D + 1) + c] = gr < Sq ? load_acc(qp[(long long)gr * D + c]) : 0.f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG;
    l_s[tid] = 0.f;
  }

  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  // the last column any row of this tile may see; tiles past it are skipped
  int kv_end = Skv;
  if (causal) {
    int last_row = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
    long long end = (long long)last_row + shift + 1;
    kv_end = end < 0 ? 0 : (end > Skv ? Skv : (int)end);
  }

  for (int kv0 = 0; kv0 < kv_end; kv0 += BKV) {
    __syncthreads();  // the previous tile's readers are done (and Q is in)
    for (int e = tid; e < BKV * D; e += THREADS) {
      int r = e / D, c = e % D, gr = kv0 + r;
      bool in = gr < Skv;
      Ks[r * (D + 1) + c] = in ? load_acc(kp[(long long)gr * D + c]) : 0.f;
      Vs[r * D + c] = in ? load_acc(vp[(long long)gr * D + c]) : 0.f;
    }
    __syncthreads();

    // scores: a 4x4 micro-tile per thread
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(tr + 16 * i) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[(tc + 16 * j) * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * bk[j];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      int r = tr + 16 * i, row = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c = tc + 16 * j, col = kv0 + c;
        bool ok = col < Skv && (!causal || col <= row + shift);
        Ss[r * (BKV + 1) + c] = ok ? s[i][j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: one warp per 8 rows, two columns per lane
    const int warp = tid / 32, lane = tid % 32;
    for (int r = warp * (BQ / 8); r < (warp + 1) * (BQ / 8); ++r) {
      float* srow = Ss + r * (BKV + 1);
      float s0 = srow[lane], s1 = srow[lane + 32];
      float mx = fmaxf(s0, s1);
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      float m_old = m_s[r];
      float m_new = fmaxf(m_old, mx);       // never -inf: starts at -1e30
      float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      srow[lane] = p0;
      srow[lane + 32] = p1;
      float sum = warp_sum(p0 + p1);
      if (lane == 0) {
        float alpha = expf(m_old - m_new);
        a_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // O = alpha * O + P V
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float alpha = a_s[tr + 16 * i];
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
#pragma unroll 4
    for (int c = 0; c < BKV; ++c) {
      float p[4], vv[NJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ss[(tr + 16 * i) * (BKV + 1) + c];
#pragma unroll
      for (int j = 0; j < NJ; ++j) vv[j] = Vs[c * D + tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] += p[i] * vv[j];
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    int r = tr + 16 * i, row = q0 + r;
    if (row >= Sq) continue;
    float l = l_s[r];
    float inv = l == 0.f ? 0.f : 1.f / l;   // no visible column: output 0
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      op[(long long)row * D + tc + 16 * j] = from_acc<T>(acc[i][j] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
           int Hkv, int Sq, int Skv, int causal, cudaStream_t s) {
  auto kern = flash_kernel<T, D>;
  const size_t smem = FlashSmem<D>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  kern<<<grid, THREADS, smem, s>>>((const T*)q, (const T*)k, (const T*)v,
                                   (T*)o, Hq, Hq / Hkv, Sq, Skv, causal,
                                   1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int Hkv, int Sq, int Skv, int D, int causal,
             cudaStream_t s) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, s);
    case 80:
      return launch<T, 80>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o (B, Hq, Sq, D), contiguous.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int Hq,
                                     int Hkv, int Sq, int Skv, int D,
                                     int causal, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 0 ||
      (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DTYPE_F32:
      return launch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, s);
    case DTYPE_BF16:
      return launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D,
                                     causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
