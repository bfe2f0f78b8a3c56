// Causal or full attention with an online softmax: O = softmax(Q Kᵀ/√D) V.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention.py
// (flash_attention / _flash_kernel).  It computes that kernel's function,
// not its block schedule: there, a sequential kv-innermost grid carries the
// running max, denominator and accumulator in VMEM scratch from one grid step
// to the next.  CUDA blocks run in no order, so here one block owns one
// (batch·query head, query tile) and walks the KV tiles in a loop of its
// own, keeping all three in f32.
//
// Semantics, as the port's plain version (kernels/ref.py: attention) has them:
//   * the causal mask is aligned bottom-right, col <= row + (Skv - Sq), as
//     ref.attention and the model's _mask have it (the TPU kernel aligns
//     top-left; the two agree only for Sq == Skv);
//   * KV tiles wholly above the diagonal are never loaded; columns >= Skv
//     never attend;
//   * a causal row with no visible column (row + Skv - Sq < 0, only when
//     Sq > Skv) outputs the mean of V over all Skv columns, as ref.attention
//     does (a softmax over a row filled with -1e30): such a row scores 0 on
//     every column, and a tile that holds one visits every KV tile;
//   * GQA: query head h reads KV head h / (Hq / Hkv); nothing is repeated
//     in memory;
//   * f32 or bf16 in, f32 softmax statistics and accumulators, output in
//     the input's type; head dims 32, 64, 80 and 128.
// Masked scores are held as -inf, so exp() gives exactly 0 for them, while
// the running max starts at -1e30 as in the reference: no -inf - -inf ever.
//
// Bound on the card: about 4·Sq·Skv·D operations per query head (halved by
// the causal mask) against 2·(Sq·Hq + Skv·Hkv)·D elements moved.  At the
// serving prefill (Yi-9B, 4 x 512 tokens, bf16) that is bytes, 37.7 MB
// against 8.6 GFLOP; longer sequences are bound by operations.
//
// bf16 (the serving path) runs on the tensor cores.  One CTA per
// (batch·query head, 128-row query tile): two consumer warpgroups of 64
// rows and one producer warp.  The producer loads Q once and K/V tiles of
// 64 rows into a two-stage ring in shared memory with TMA (128-byte
// swizzle, mbarriers counting the bytes); elements past the tensor's edge
// arrive as zeros, so ragged Sq and Skv need no masking of the loads.  Each
// consumer computes S = Q·Kᵀ with wgmma (m64n64k16, both operands from
// shared memory, K-major), keeps S in registers, applies the mask only on
// tiles that cross the diagonal or Skv, and runs the online softmax in
// registers (row max and sum over the four lanes that share a row).  P is
// rounded to bf16 pairs in registers and fed as wgmma's register A operand
// to O += P·V (V MN-major from shared memory): the S fragment of each k16
// slice is the A fragment, so P never touches shared memory.  Head dims 32
// and 80 are zero-padded to 64 and 128 in shared memory (TMA fills the
// columns past D with zeros, which add nothing).  Q·Kᵀ on bf16 operands is
// exact in f32; rounding P to bf16 is the one rounding the f32 path lacks.
//
// f32 stays on the CUDA cores (64-row query tiles, f32 products from
// shared-memory tiles, 4x4 and 4x(D/16) register micro-tiles per thread):
// the tensor cores take f32 only as TF32, which would drop the f32 path's
// precision.
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// ---- f32: CUDA cores --------------------------------------------------------------

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

  // the last column any row of this tile may see; tiles past it are skipped.
  // A tile that holds a row with no visible column visits every tile.
  int kv_end = Skv;
  if (causal && q0 + shift >= 0) {
    int last_row = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
    long long end = (long long)last_row + shift + 1;
    kv_end = end > Skv ? Skv : (int)end;
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
        bool empty = causal && row + shift < 0;   // sees no column
        bool ok = col < Skv && (!causal || col <= row + shift || empty);
        Ss[r * (BKV + 1) + c] = ok ? (empty ? 0.f : s[i][j] * scale)
                                   : -INFINITY;
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
    float inv = 1.f / l;
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


// ---- bf16: tensor cores ---------------------------------------------------------

namespace tc {

constexpr int BQ = 128;               // query rows a CTA: two warpgroups of 64
constexpr int BKV = 64;               // KV rows a tile
constexpr int STAGES = 2;             // K/V tiles in flight
constexpr int CONSUMERS = 256;        // warps 0-7: two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;   // warp 8: the producer
constexpr int ROWB = 128;             // bytes of a swizzled row (64 bf16)
constexpr float NEG_INIT = -1e30f;

// DP: the head dim padded to the swizzle's width (64 or 128)
template <int DP>
struct Smem {
  static constexpr int NB = DP / 64;                  // 64-column blocks
  static constexpr int Q_BYTES = NB * BQ * ROWB;
  static constexpr int KV_BYTES = NB * BKV * ROWB;    // K or V, one stage
  static constexpr int STAGE_BYTES = 2 * KV_BYTES;
  static constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
  // + the barriers, + slack to align the base to 1024 bytes
  static constexpr size_t BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
};

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

template <int N>
__device__ __forceinline__ void pv_mma(float* o, const uint32_t* a,
                                       uint64_t desc_b);
template <>
__device__ __forceinline__ void pv_mma<64>(float* o, const uint32_t* a,
                                           uint64_t desc_b) {
  wgmma_m64n64k16_rs(o, a, desc_b);
}
template <>
__device__ __forceinline__ void pv_mma<128>(float* o, const uint32_t* a,
                                            uint64_t desc_b) {
  wgmma_m64n128k16_rs(o, a, desc_b);
}

// S[64 x 64] = Q[64 x DP] · K[64 x DP]ᵀ for one warpgroup: Q and K are
// NB column blocks of 128-byte swizzled rows (q_block / k_block bytes
// apart); 16 columns (32 bytes) a step.
template <int DP>
__device__ __forceinline__ void qk_mma(float* s, const uint8_t* q,
                                       int q_block, const uint8_t* k,
                                       int k_block) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const int off = (kk % 4) * 32;
    uint64_t da = wgmma_desc(q + (kk / 4) * q_block + off, 16, 8 * ROWB);
    uint64_t db = wgmma_desc(k + (kk / 4) * k_block + off, 16, 8 * ROWB);
    wgmma_m64n64k16_ss(s, da, db, 1);
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs<32>(s);
}

template <int DP>
__global__ void __launch_bounds__(THREADS, 1)
flash_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   __nv_bfloat16* __restrict__ o, int Hq, int rep, int Sq,
                   int Skv, int D, int causal, float scale_log2) {
  using S = Smem<DP>;
  constexpr int NO = DP / 2;           // O accumulator floats a thread
  constexpr int NS = BKV / 2;          // S accumulator floats a thread
  static_assert(BKV == 64, "qk_mma computes 64 KV columns");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + S::Q_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + S::BAR_OFF);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  // causal: the heaviest query tiles (last rows) start first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q0 = qt * BQ;
  const int bh = blockIdx.y;
  const int kvh = (bh / Hq) * (Hq / rep) + (bh % Hq) / rep;
  const int shift = Skv - Sq;          // bottom-right causal offset

  // the KV tiles this CTA visits: all of them when a row sees no column
  int kv_end = Skv;
  if (causal && q0 + shift >= 0) {
    int last_row = (q0 + BQ < Sq ? q0 + BQ : Sq) - 1;
    kv_end = min(last_row + shift + 1, Skv);
  }
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  if (tid == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS / 32);   // one arrival a consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {
    // ---- producer: Q once, then the K/V ring ----
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, S::Q_BYTES);
      for (int cb = 0; cb < S::NB; ++cb)
        tma_load_3d(Qs + cb * BQ * ROWB, &tq, qbar, cb * 64, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) mbar_wait(&empty[s], ((j / STAGES) - 1) & 1);
        uint8_t* ks = KVs + s * S::STAGE_BYTES;
        uint8_t* vs = ks + S::KV_BYTES;
        mbar_arrive_expect_tx(&full[s], S::STAGE_BYTES);
        for (int cb = 0; cb < S::NB; ++cb) {
          tma_load_3d(ks + cb * BKV * ROWB, &tk, &full[s], cb * 64, j * BKV,
                      kvh);
          tma_load_3d(vs + cb * BKV * ROWB, &tv, &full[s], cb * 64, j * BKV,
                      kvh);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q0 + 64wg .. +63 ----
    const int wg = warp / 4, w = warp % 4;
    const int wg_first = q0 + wg * 64;
    const int wg_last = min(wg_first + 63, Sq - 1);
    const int row0 = wg_first + w * 16 + lane / 4;   // and row0 + 8
    const int quad_col = 2 * (lane % 4);
    const uint8_t* qw = Qs + wg * 64 * ROWB;

    float oacc[NO];
#pragma unroll
    for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
    float m[2] = {NEG_INIT, NEG_INIT}, lsum[2] = {0.f, 0.f};
    mbar_wait(qbar, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % STAGES;
      const int kv0 = j * BKV;
      mbar_wait(&full[s], (j / STAGES) & 1);
      // a tile wholly above this warpgroup's diagonal, or a warpgroup past
      // Sq: nothing to add, but the stage is released all the same
      const bool skip = wg_first >= Sq ||
                        (causal && wg_first + shift >= 0 &&
                         kv0 > wg_last + shift);
      if (skip) {
        if (lane == 0) mbar_arrive(&empty[s]);
        continue;
      }
      const uint8_t* ks = KVs + s * S::STAGE_BYTES;
      const uint8_t* vs = ks + S::KV_BYTES;

      float sc[NS];
      qk_mma<DP>(sc, qw, BQ * ROWB, ks, BKV * ROWB);

      // scale into log2 units; mask only a tile that crosses Skv or the
      // diagonal of some row of this warpgroup
      const bool need_mask =
          kv0 + BKV > Skv || (causal && kv0 + BKV - 1 > wg_first + shift);
#pragma unroll
      for (int jj = 0; jj < NS / 4; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * jj + 2 * i + c];
            x *= scale_log2;
            if (need_mask) {
              const int col = kv0 + 8 * jj + quad_col + c;
              const int row = row0 + 8 * i;
              if (col >= Skv)
                x = -INFINITY;
              else if (causal && col > row + shift)
                x = row + shift < 0 ? 0.f : -INFINITY;   // no column: mean
            }
          }

      // online softmax in registers; each thread holds rows row0, row0 + 8
      float alpha[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        float mx = -INFINITY;
#pragma unroll
        for (int jj = 0; jj < NS / 4; ++jj)
          mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * i], sc[4 * jj + 2 * i + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[i], mx);   // finite: starts at -1e30
        alpha[i] = exp2f(m[i] - m_new);
        m[i] = m_new;
        float sum = 0.f;
#pragma unroll
        for (int jj = 0; jj < NS / 4; ++jj)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            float& x = sc[4 * jj + 2 * i + c];
            x = exp2f(x - m_new);
            sum += x;
          }
        lsum[i] = lsum[i] * alpha[i] + sum;   // this thread's columns only
      }
#pragma unroll
      for (int jj = 0; jj < NO / 4; ++jj)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          oacc[4 * jj + 2 * i] *= alpha[i];
          oacc[4 * jj + 2 * i + 1] *= alpha[i];
        }

      // P as wgmma's A operand: the S fragment of k16 slice kc
      uint32_t pa[BKV / 16][4];
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kc][r] = pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
      wgmma_fence();
#pragma unroll
      for (int kc = 0; kc < BKV / 16; ++kc) {
        // rows kv 16kc.. of V: K-rows of B, 64-column blocks BKV rows apart
        uint64_t db = wgmma_desc(vs + kc * 16 * ROWB, BKV * ROWB, 8 * ROWB);
        pv_mma<DP>(oacc, pa[kc], db);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs<NO>(oacc);
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // O / l, in bf16 pairs
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = lsum[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      const float inv = 1.f / l;
      const int row = row0 + 8 * i;
      if (row >= Sq) continue;
      __nv_bfloat16* orow = o + ((long long)bh * Sq + row) * D;
#pragma unroll
      for (int jj = 0; jj < NO / 4; ++jj) {
        const int col = 8 * jj + quad_col;
        if (col < D)
          *reinterpret_cast<__nv_bfloat162*>(orow + col) =
              __floats2bfloat162_rn(oacc[4 * jj + 2 * i] * inv,
                                    oacc[4 * jj + 2 * i + 1] * inv);
      }
    }
  }
}

// One warpgroup, one tile: S[64 x 64] = Q[64 x D] · K[64 x D]ᵀ through the
// same TMA loads and wgmma descriptors as the attention kernel (a check of
// the swizzle, the descriptors and the accumulator layout).
template <int DP>
__global__ void __launch_bounds__(128)
qk_tile_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk, float* __restrict__ out) {
  constexpr int NB = DP / 64, BYTES = NB * 64 * ROWB;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* qs = smem;
  uint8_t* ks = smem + BYTES;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + 2 * BYTES);
  const int tid = threadIdx.x, w = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0) {
    mbar_arrive_expect_tx(bar, 2 * BYTES);
    for (int cb = 0; cb < NB; ++cb) {
      tma_load_3d(qs + cb * 64 * ROWB, &tq, bar, cb * 64, 0, 0);
      tma_load_3d(ks + cb * 64 * ROWB, &tk, bar, cb * 64, 0, 0);
    }
  }
  mbar_wait(bar, 0);
  float sc[32];
  qk_mma<DP>(sc, qs, 64 * ROWB, ks, 64 * ROWB);
#pragma unroll
  for (int jj = 0; jj < 8; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c)
        out[(w * 16 + lane / 4 + 8 * i) * 64 + 8 * jj + 2 * (lane % 4) + c] =
            sc[4 * jj + 2 * i + c];
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int Hkv, int Sq, int Skv, int D, int causal,
           cudaStream_t s) {
  CUtensorMap tq, tk, tv;
  int rc = make_tmap_bf16_3d(&tq, q, D, Sq, (uint64_t)B * Hq, BQ);
  if (!rc) rc = make_tmap_bf16_3d(&tk, k, D, Skv, (uint64_t)B * Hkv, BKV);
  if (!rc) rc = make_tmap_bf16_3d(&tv, v, D, Skv, (uint64_t)B * Hkv, BKV);
  if (rc) return rc;
  auto kern = flash_wgmma_kernel<DP>;
  const size_t smem = Smem<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((Sq + BQ - 1) / BQ, B * Hq);
  const float log2e = 1.4426950408889634f;
  kern<<<grid, THREADS, smem, s>>>(tq, tk, tv, (__nv_bfloat16*)o, Hq,
                                   Hq / Hkv, Sq, Skv, D, causal,
                                   log2e / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int DP>
int launch_qk_tile(const void* q, const void* k, float* out, int D,
                   cudaStream_t s) {
  CUtensorMap tq, tk;
  int rc = make_tmap_bf16_3d(&tq, q, D, 64, 1, 64);
  if (!rc) rc = make_tmap_bf16_3d(&tk, k, D, 64, 1, 64);
  if (rc) return rc;
  const size_t smem = 2 * (DP / 64) * 64 * ROWB + 8 + 1024;
  cudaError_t err = cudaFuncSetAttribute(
      qk_tile_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  qk_tile_kernel<DP><<<1, 128, smem, s>>>(tq, tk, out);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

// q (B, Hq, Sq, D), k and v (B, Hkv, Skv, D), o (B, Hq, Sq, D), contiguous.
extern "C" int repro_flash_attention(int dtype, const void* q, const void* k,
                                     const void* v, void* o, int B, int Hq,
                                     int Hkv, int Sq, int Skv, int D,
                                     int causal, void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv || Sq < 1 || Skv < 1 ||
      (long long)B * Hq > 65535)
    return (int)cudaErrorInvalidValue;
  if (D != 32 && D != 64 && D != 80 && D != 128)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DTYPE_F32:
      return launch_d<float>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, s);
    case DTYPE_BF16:
      if (D <= 64)
        return tc::launch<64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, s);
      return tc::launch<128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, D, causal, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// s (64, 64) f32 = q (64, D) · k (64, D)ᵀ, bf16 in: one tile of the bf16
// kernel's first product, for the tests.
extern "C" int repro_flash_qk_tile(const void* q, const void* k, void* s,
                                   int D, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  switch (D) {
    case 32:
    case 64:
      return tc::launch_qk_tile<64>(q, k, (float*)s, D, st);
    case 80:
    case 128:
      return tc::launch_qk_tile<128>(q, k, (float*)s, D, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
