// MLA's prefill attention: O = softmax(scale · Q Kᵀ + causal mask) V, with q
// and k of head dim 192 (DeepSeek-V2's nope 128 + rope 64) and v and O of
// 128, bf16 in and out.
//
// It replaces no Pallas TPU kernel: the reference runs MLA's attention
// through XLA (src/repro/models/attention.py, _chunked_attention: a
// lax.scan over key chunks that XLA fuses).  The port's twin of that loop
// (models/attention.py, _chunked_attention) runs eagerly on the card as
// about ten separate f32 passes over a (B, H, Sq, chunk) tile a chunk, the
// causal half included.  This kernel runs the same online softmax in one
// launch and takes over that loop for bf16 calls of these head dims on the
// card (models/attention.py, multihead_attention).
//
// Semantics, as the plain version (kernels/ref.py: masked_attention) and
// the loop have them:
//   * q (B, H, Sq, 192), k (B, H, Skv, 192), v (B, H, Skv, 128), bf16,
//     contiguous; o (B, H, Sq, 128) bf16;
//   * the causal mask is aligned bottom-right, col <= row + (Skv - Sq), as
//     the flash kernel's; columns >= Skv never attend;
//   * a row with no visible column (row + Skv - Sq < 0, only when Sq > Skv)
//     outputs the mean of V, as the plain version does (a softmax over a
//     row filled with -1e30): such a row scores 0 on every column;
//   * precision: q·kᵀ as bf16 x bf16 products summed in f32 (the products
//     of the loop's f32 einsum of the same bf16 values); the running max,
//     sum and O in f32; P enters P·V as a bf16 head plus a bf16 tail
//     (p_hi = bf16(p), p_lo = bf16(p - p_hi)), two products against the
//     same V tile, so it keeps about 16 significant bits and not 8.  No fp8,
//     no tf32, and P is never rounded to bf16 alone.
//
// Bound on the card: tensor-core operations.  The least causal work is
// 2·(192 + 128)·Sq(Sq+1)/2 per (batch, head) for 2·(192·2 + 128·2)·S bytes:
// at S = 4,871 the intensity is already past 2,000 operations a byte, far
// over the H100's 295 at which bytes would limit.  The P split makes P·V
// twice the least work, 1.4x the least operations in all.
//
// Design (after csrc/flash_attention.cu's wgmma + TMA path): one CTA per
// (batch·head, 128-row query tile), two consumer warpgroups of 64 rows and
// one producer warp.  The producer loads Q once (48 KB) and K/V tiles of
// 64 keys (24 + 16 KB) into a three-stage ring with TMA (128-byte swizzle,
// mbarriers counting the bytes); what lies past the tensors' edges arrives
// as zeros, so the ragged Sq and Skv need no masked loads.  Each consumer
// warpgroup computes S = Q·Kᵀ with 12 wgmma k16 slices (both operands in
// shared memory) into registers, and overlaps it with the previous tile's
// O += P·V (register A operand, V from shared memory): tile j's Q·Kᵀ is
// issued with tile j-1's P·V, and tile j's softmax (max, exp2, sum) runs
// while that P·V is still in flight.  The scale is folded into the exp2's
// argument in log2 units (one FMA an element); only the tiles that cross
// the diagonal or Skv are masked; tiles wholly above a warpgroup's
// diagonal are released unread.  The grid is flat and (batch·head) major:
// a plane's query tiles run side by side, its longest first, and share its
// K/V tiles in L2; any B·H fits (a grid's x holds 2^31 - 1 CTAs).
#include <math.h>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int DQK = 192, DV = 128;
constexpr int NBQK = DQK / 64, NBV = DV / 64;   // 64-column (128-byte) blocks
constexpr int BQ = 128;               // query rows a CTA: two warpgroups of 64
constexpr int BKV = 64;               // keys a tile
constexpr int STAGES = 3;             // K/V tiles in the ring
constexpr int CONSUMERS = 256;        // warps 0-7: two consumer warpgroups
constexpr int THREADS = CONSUMERS + 32;   // warp 8: the producer
constexpr int ROWB = 128;             // bytes of a swizzled row (64 bf16)
constexpr int Q_BYTES = NBQK * BQ * ROWB;            // 48 KB
constexpr int K_BYTES = NBQK * BKV * ROWB;           // 24 KB
constexpr int V_BYTES = NBV * BKV * ROWB;            // 16 KB
constexpr int STAGE_BYTES = K_BYTES + V_BYTES;
constexpr int BAR_OFF = Q_BYTES + STAGES * STAGE_BYTES;
// + the barriers, + slack to align the base to 1024 bytes
constexpr size_t SMEM_BYTES = BAR_OFF + 8 * (1 + 2 * STAGES) + 1024;
constexpr int NS = BKV / 2;           // S accumulator floats a thread
constexpr int NO = DV / 2;            // O accumulator floats a thread
constexpr float NEG_INIT = -1e30f;
constexpr long long MAX_CTAS = 0x7fffffffLL;   // a grid's x

__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  uint32_t a = smem_u32(p);
  return p + (((a + 1023) & ~1023u) - a);
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// wait until the phase of parity `parity` of `bar` has completed, the spin
// inside one asm statement, so that the compiler sees no divergent branch
// between the wgmma instructions around it (a divergent path makes ptxas
// serialize them).  Past `deadline` (%globaltimer, ns) it traps: a broken
// pipeline fails the launch instead of holding the card.
__device__ __forceinline__ void wait_phase(uint64_t* bar, uint32_t parity,
                                           uint64_t deadline) {
  asm volatile(
      "{\n"
      ".reg .pred done, late;\n"
      ".reg .u64 now;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "mov.u64 now, %%globaltimer;\n"
      "setp.gt.u64 late, now, %2;\n"
      "@late trap;\n"
      "bra WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity), "l"(deadline)
      : "memory");
}

// one arrival on `bar` from the lane whose `lane` is 0, predicated rather
// than branched around
__device__ __forceinline__ void arrive_lane0(uint64_t* bar, int lane) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.eq.s32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(lane)
      : "memory");
}

// 2^x; -inf gives 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// (a, b) as a bf16 pair `hi` and the pair of what it leaves out, `lo`
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  __nv_bfloat162 l = __floats2bfloat162_rn(a - hf.x, b - hf.y);
  hi = *reinterpret_cast<uint32_t*>(&h);
  lo = *reinterpret_cast<uint32_t*>(&l);
}

// issue S[64 x 64] = Q[64 x 192] · K[64 x 192]ᵀ for one warpgroup: Q and K
// are three column blocks of 128-byte swizzled rows; 16 columns a step
__device__ __forceinline__ void qk_issue(float* s, const uint8_t* q,
                                         const uint8_t* k) {
#pragma unroll
  for (int kk = 0; kk < DQK / 16; ++kk) {
    const int off = (kk % 4) * 32;
    uint64_t da = wgmma_desc(q + (kk / 4) * (BQ * ROWB) + off, 16, 8 * ROWB);
    uint64_t db = wgmma_desc(k + (kk / 4) * (BKV * ROWB) + off, 16, 8 * ROWB);
    wgmma_m64n64k16_ss(s, da, db, kk > 0);
  }
}

// issue O[64 x 128] += (P_hi + P_lo)[64 x 64] · V[64 x 128]: the S fragment
// of each k16 slice is wgmma's A fragment; V rows 16kc.. are the K-rows of
// B, its two 64-column blocks BKV rows apart
__device__ __forceinline__ void pv_issue(float* o, const uint32_t (*hi)[4],
                                         const uint32_t (*lo)[4],
                                         const uint8_t* v) {
#pragma unroll
  for (int kc = 0; kc < BKV / 16; ++kc) {
    uint64_t db = wgmma_desc(v + kc * 16 * ROWB, BKV * ROWB, 8 * ROWB);
    wgmma_m64n128k16_rs(o, hi[kc], db);
    wgmma_m64n128k16_rs(o, lo[kc], db);
  }
}

// the online softmax of one tile on the raw scores `sc` (two rows a thread,
// row0 and row0 + 8, each spread over the four lanes of a quad): the
// running max `m` and sum `lsum` updated, `sc` turned into probabilities,
// and the factor that rescales O returned in `alpha`
__device__ __forceinline__ void softmax_tile(float* sc, float* m, float* lsum,
                                             float* alpha, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float mx = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < NS / 4; ++jj)
      mx = fmaxf(mx, fmaxf(sc[4 * jj + 2 * i], sc[4 * jj + 2 * i + 1]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[i], mx);   // finite: starts at -1e30
    alpha[i] = ex2((m[i] - m_new) * scale_log2);
    m[i] = m_new;
    const float mb = m_new * scale_log2;
    float sum = 0.f;
#pragma unroll
    for (int jj = 0; jj < NS / 4; ++jj)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = sc[4 * jj + 2 * i + c];
        x = ex2(fmaf(x, scale_log2, -mb));
        sum += x;
      }
    lsum[i] = lsum[i] * alpha[i] + sum;   // this thread's columns only
  }
}

// mask the scores of the tile at column kv0 where it crosses Skv or the
// diagonal of some row of this warpgroup (rows from wg_first on)
__device__ __forceinline__ void mask_tile(float* sc, int kv0, int wg_first,
                                          int row0, int quad_col, int Skv,
                                          int shift) {
  if (kv0 + BKV <= Skv && kv0 + BKV - 1 <= wg_first + shift) return;
#pragma unroll
  for (int jj = 0; jj < NS / 4; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = kv0 + 8 * jj + quad_col + c;
        const int row = row0 + 8 * i;
        float& x = sc[4 * jj + 2 * i + c];
        if (col >= Skv)
          x = -INFINITY;
        else if (col > row + shift)
          x = row + shift < 0 ? 0.f : -INFINITY;   // no column: mean
      }
}

// O *= alpha (per row), then P = sc as the bf16 head and tail pairs of
// wgmma's A fragments, one k16 slice of keys each
__device__ __forceinline__ void rescale_and_split(float* oacc,
                                                  const float* alpha,
                                                  const float* sc,
                                                  uint32_t (*phi)[4],
                                                  uint32_t (*plo)[4]) {
#pragma unroll
  for (int jj = 0; jj < NO / 4; ++jj)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      oacc[4 * jj + 2 * i] *= alpha[i];
      oacc[4 * jj + 2 * i + 1] *= alpha[i];
    }
#pragma unroll
  for (int kc = 0; kc < BKV / 16; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      split_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1], phi[kc][r],
                 plo[kc][r]);
}

__global__ void __launch_bounds__(THREADS, 1)
mla_attention_kernel(const __grid_constant__ CUtensorMap tq,
                     const __grid_constant__ CUtensorMap tk,
                     const __grid_constant__ CUtensorMap tv,
                     __nv_bfloat16* __restrict__ o, int Sq, int Skv,
                     float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = align1024(smem_raw);
  uint8_t* Qs = smem;
  uint8_t* KVs = smem + Q_BYTES;
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + BAR_OFF);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;

  const int tid = threadIdx.x, lane = tid % 32;
  // the warp's index as a value the compiler knows to be warp-uniform
  const int warp = __shfl_sync(0xffffffffu, tid / 32, 0);
  // one flat grid, (batch·head) major: a plane's query tiles run side by
  // side and share its K/V tiles in L2, the longest tile first
  const int n_qt = (Sq + BQ - 1) / BQ;
  const int bh = blockIdx.x / n_qt;
  const int qt = n_qt - 1 - blockIdx.x % n_qt;
  const int q0 = qt * BQ;
  const int shift = Skv - Sq;                  // bottom-right causal offset
  // a wait that lasts 10 s can only be a broken pipeline
  const uint64_t deadline = global_ns() + 10000000000ull;

  // the KV tiles this CTA visits: all of them when a row sees no column
  int kv_end = Skv;
  if (q0 + shift >= 0) kv_end = min(min(q0 + BQ, Sq) + shift, Skv);
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
      mbar_arrive_expect_tx(qbar, Q_BYTES);
      for (int cb = 0; cb < NBQK; ++cb)
        tma_load_3d(Qs + cb * BQ * ROWB, &tq, qbar, cb * 64, q0, bh);
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES;
        if (j >= STAGES) wait_phase(&empty[s], ((j / STAGES) - 1) & 1,
                                    deadline);
        uint8_t* ks = KVs + s * STAGE_BYTES;
        uint8_t* vs = ks + K_BYTES;
        mbar_arrive_expect_tx(&full[s], STAGE_BYTES);
        for (int cb = 0; cb < NBQK; ++cb)
          tma_load_3d(ks + cb * BKV * ROWB, &tk, &full[s], cb * 64, j * BKV,
                      bh);
        for (int cb = 0; cb < NBV; ++cb)
          tma_load_3d(vs + cb * BKV * ROWB, &tv, &full[s], cb * 64, j * BKV,
                      bh);
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q0 + 64wg .. +63 ----
  const int wg = warp / 4, w = warp % 4;
  const int wg_first = q0 + wg * 64;
  // the tiles this warpgroup computes; it releases the CTA's others unread
  int n_mine = n_tiles;
  if (wg_first >= Sq) {
    n_mine = 0;
  } else if (wg_first + shift >= 0) {
    const int end = min(min(wg_first + 64, Sq) + shift, Skv);
    n_mine = (end + BKV - 1) / BKV;
  }
  const int row0 = wg_first + w * 16 + lane / 4;   // and row0 + 8
  const int quad_col = 2 * (lane % 4);
  const uint8_t* qw = Qs + wg * 64 * ROWB;
  auto k_tile = [&](int j) { return KVs + (j % STAGES) * STAGE_BYTES; };
  auto v_tile = [&](int j) { return k_tile(j) + K_BYTES; };

  float oacc[NO], sc[NS];
#pragma unroll
  for (int i = 0; i < NO; ++i) oacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < NS; ++i) sc[i] = 0.f;
  uint32_t phi[BKV / 16][4], plo[BKV / 16][4];
  float m[2] = {NEG_INIT, NEG_INIT}, lsum[2] = {0.f, 0.f}, alpha[2];

  if (n_mine > 0) {
    wait_phase(qbar, 0, deadline);
    // tile 0: Q·Kᵀ alone
    wait_phase(&full[0], 0, deadline);
    wgmma_fence();
    qk_issue(sc, qw, k_tile(0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NS>(sc);
    mask_tile(sc, 0, wg_first, row0, quad_col, Skv, shift);
    softmax_tile(sc, m, lsum, alpha, scale_log2);
    rescale_and_split(oacc, alpha, sc, phi, plo);
    // tile j's Q·Kᵀ with tile j-1's P·V, which runs under tile j's softmax
    for (int j = 1; j < n_mine; ++j) {
      wait_phase(&full[j % STAGES], (j / STAGES) & 1, deadline);
      wgmma_fence();
      qk_issue(sc, qw, k_tile(j));
      wgmma_commit();
      pv_issue(oacc, phi, plo, v_tile(j - 1));
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs<NS>(sc);
      mask_tile(sc, j * BKV, wg_first, row0, quad_col, Skv, shift);
      softmax_tile(sc, m, lsum, alpha, scale_log2);
      wgmma_wait<0>();
      fence_regs<NO>(oacc);
      arrive_lane0(&empty[(j - 1) % STAGES], lane);
      rescale_and_split(oacc, alpha, sc, phi, plo);
    }
    wgmma_fence();
    pv_issue(oacc, phi, plo, v_tile(n_mine - 1));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(oacc);
    arrive_lane0(&empty[(n_mine - 1) % STAGES], lane);
  }
  for (int j = n_mine; j < n_tiles; ++j) {
    wait_phase(&full[j % STAGES], (j / STAGES) & 1, deadline);
    arrive_lane0(&empty[j % STAGES], lane);
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
    __nv_bfloat16* orow = o + ((long long)bh * Sq + row) * DV;
#pragma unroll
    for (int jj = 0; jj < NO / 4; ++jj)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * jj + quad_col) =
          __floats2bfloat162_rn(oacc[4 * jj + 2 * i] * inv,
                                oacc[4 * jj + 2 * i + 1] * inv);
  }
}

}  // namespace

// q (B, H, Sq, 192), k (B, H, Skv, 192), v (B, H, Skv, 128) and
// o (B, H, Sq, 128), bf16, contiguous, 16-byte aligned; scale > 0.
extern "C" int repro_mla_attention(const void* q, const void* k, const void* v,
                                   void* o, int B, int H, int Sq, int Skv,
                                   double scale, void* stream) {
  const long long ctas = (long long)B * H * ((Sq + BQ - 1) / BQ);
  if (B < 1 || H < 1 || Sq < 1 || Skv < 1 || ctas > MAX_CTAS ||
      !(scale > 0.0) || !isfinite(scale))
    return (int)cudaErrorInvalidValue;
  CUtensorMap tq, tk, tv;
  const uint64_t planes = (uint64_t)B * H;
  int rc = make_tmap_bf16_3d(&tq, q, DQK, Sq, planes, BQ);
  if (!rc) rc = make_tmap_bf16_3d(&tk, k, DQK, Skv, planes, BKV);
  if (!rc) rc = make_tmap_bf16_3d(&tv, v, DV, Skv, planes, BKV);
  if (rc) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      mla_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((unsigned)ctas);
  const double log2e = 1.4426950408889634;
  mla_attention_kernel<<<grid, THREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, Sq, Skv, (float)(scale * log2e));
  return (int)cudaGetLastError();
}
