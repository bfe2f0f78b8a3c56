// Decode attention: one query token per row against the KV cache, with
// grouped query heads (GQA) and a length per row.
//
// It replaces no Pallas TPU kernel: the reference keeps its decode
// attention as plain XLA (src/repro/models/attention.py, gqa_decode_ragged
// and gqa_decode).  This kernel takes over that plain attend in the port's
// gqa_decode_ragged and gqa_decode, whose plain PyTorch twin widened the
// bf16 cache to f32 in two strided copies, made each contiguous once more
// for its einsum, and read every one of the Smax positions under a mask.
//
// Semantics, as the plain version (kernels/decode_attention.py: plain) has
// them:
//   * q (B, Hq, D) in f32 or bf16; k and v the cache as it is stored,
//     (B, Smax, Hkv·D) in f32 or bf16, read in place; lengths (B,) int32:
//     row b attends positions [0, min(lengths[b], Smax));
//   * query head h reads KV head h / G, G = Hq / Hkv; nothing is repeated;
//   * every product and sum in f32, from the stored values widened
//     exactly; s = (q·k)·scale; a softmax in f32; o = Σ p·v with p in f32
//     (never rounded to bf16 or TF32), written in q's type;
//   * a position past the row's length is never read: the masked softmax
//     gives it exp(-1e30 - m) = 0, so leaving it out changes no term.
//     A row of length 0 has no softmax: the kernel writes zeros there.
//
// Bound on the card: the live K and V bytes.  A position costs 4·G·D
// operations for 2·D stored elements: 8 operations a byte of bf16 at G = 8,
// far under the 295 at which the tensor cores would limit, and under the
// ~20 of the CUDA cores' f32 rate.  At Yi-9B's serving step (256 rows,
// Hkv = 4, D = 128, bf16) a live position is 2 KB a layer.
//
// Design: one CTA of 128 threads takes one (row, KV head) and one chunk of
// positions; it holds the group's G query rows in shared memory (f32), so
// each K and V row is read once for all of them.  K and V tiles of TP rows
// stream through a three-stage cp.async ring (16-byte copies of each
// contiguous D-wide row at stride Hkv·D, rows past the length zero-filled).
// A tile is three phases: the scores (a thread per position and subset of
// heads, K rows padded by 16 bytes in shared memory so that the lanes' rows
// fall in distinct banks), the online softmax (a warp per head: the tile's
// max, the rescale factor, the probabilities and their sum), and P·V on
// the CUDA cores (a thread per 16-byte column slice and group of positions,
// all G heads' f32 accumulators in its registers).  At the end the
// position groups are summed in shared memory and the chunk's (m, l, acc)
// go to scratch; a second kernel merges the chunks by log-sum-exp.  The
// grid is (B·Hkv, chunks); a CTA whose chunk starts at or past its row's
// length exits at once, so the time follows the live positions and not
// Smax, and a ragged batch balances itself across the CTAs.  The wrapper
// picks the chunk from the shapes (kernels/decode_attention.py: plan).
#include <math.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int STAGES = 3;
constexpr float NEG = -1e30f;

template <typename T, int D, int GM>
struct Shape {
  static constexpr int VEC = 16 / (int)sizeof(T);   // elements a 16-byte copy
  static constexpr int NV = D / VEC;                // 16-byte copies a row
  static constexpr int ROW = D * (int)sizeof(T);    // bytes of a row
  static constexpr int KROW = ROW + 16;             // a K row in shared memory
  static constexpr int TP = ROW <= 256 ? 64 : (ROW <= 512 ? 32 : 16);
  static constexpr int STAGE = TP * (KROW + ROW);   // bytes of a stage
  static constexpr int NHS = THREADS / TP;          // head subsets (scores)
  static constexpr int HPT = (GM + NHS - 1) / NHS;  // heads a thread (scores)
  static constexpr int PG = THREADS / NV;           // position groups (P·V)
  static constexpr int RING_BYTES = STAGES * STAGE;
  static constexpr int RED_BYTES = PG * GM * D * 4; // the groups' sums
  static constexpr int RING = RING_BYTES > RED_BYTES ? RING_BYTES : RED_BYTES;
  // ring | q (GM·D f32) | scores/probabilities (TP·GM f32) | m, l, alpha
  static constexpr int BYTES = RING + 4 * (GM * D + TP * GM + 3 * GM);
  static_assert(D % VEC == 0 && NV <= THREADS, "head dim");
  static_assert(THREADS % TP == 0, "tile");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 16 bytes of shared memory widened to f32 (exact for bf16).
__device__ __forceinline__ void widen(const unsigned char* p, float* out,
                                      float) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  out[0] = x.x;
  out[1] = x.y;
  out[2] = x.z;
  out[3] = x.w;
}
__device__ __forceinline__ void widen(const unsigned char* p, float* out,
                                      __nv_bfloat16) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const unsigned w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    out[2 * i] = __uint_as_float(w[i] << 16);
    out[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_add(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// One (row, KV head, chunk): the chunk's softmax state (m, l) and its
// unnormalised sum acc for each of the group's G heads, into scratch.
template <typename T, int D, int GM>
__global__ void __launch_bounds__(THREADS)
decode_chunk_kernel(const void* __restrict__ qv, int q_bf16,
                    const T* __restrict__ k, const T* __restrict__ v,
                    const int* __restrict__ lengths,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int Hkv, int G, int Smax, int chunk, float scale) {
  using S = Shape<T, D, GM>;
  constexpr int VEC = S::VEC, NV = S::NV, ROW = S::ROW, KROW = S::KROW,
                TP = S::TP, NHS = S::NHS, HPT = S::HPT, PG = S::PG;
  const int bh = blockIdx.x;  // b · Hkv + KV head
  const int b = bh / Hkv, kvh = bh - b * Hkv;
  const int len = min(lengths[b], Smax);
  const int start = blockIdx.y * chunk;
  if (start >= len) return;
  const int end = min(start + chunk, len);
  const int ntiles = (end - start + TP - 1) / TP;

  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + S::RING);
  float* ps = qs + GM * D;   // [TP][GM]: scores, then probabilities
  float* st = ps + TP * GM;  // m[GM], l[GM], alpha[GM]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;

  const long long stride = (long long)Hkv * D;  // between positions
  const long long base = (long long)b * Smax * stride + (long long)kvh * D;
  const T* kb = k + base;
  const T* vb = v + base;

  auto load_tile = [&](int t) {
    unsigned char* ks = smem + (t % STAGES) * S::STAGE;
    unsigned char* vs = ks + TP * KROW;
    const int p0 = start + t * TP;
    const int n = min(TP, end - p0);
    for (int i = tid; i < TP * NV; i += THREADS) {
      const int r = i / NV, c = i - r * NV;
      const long long off = (long long)(r < n ? p0 + r : start) * stride +
                            c * VEC;
      const int bytes = r < n ? 16 : 0;  // rows past the length: zeros
      cp_async16(ks + r * KROW + c * 16, kb + off, bytes);
      cp_async16(vs + r * ROW + c * 16, vb + off, bytes);
    }
  };

#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_tile(t);
    cp_async_commit();
  }

  // the group's query rows in f32 (heads G..GM-1 are zeros: finite scores
  // that no output reads)
  const long long q0 = ((long long)b * Hkv + kvh) * G * D;
  for (int i = tid; i < GM * D; i += THREADS) {
    const int h = i / D;
    float x = 0.f;
    if (h < G)
      x = q_bf16 ? __bfloat162float(
                       static_cast<const __nv_bfloat16*>(qv)[q0 + i])
                 : static_cast<const float*>(qv)[q0 + i];
    qs[i] = x;
  }
  if (tid < GM) {
    st[tid] = NEG;
    st[GM + tid] = 0.f;
  }

  // P·V: this thread's column slice c and position group g
  const int c = tid % NV, g = tid / NV;
  float acc[GM][VEC];
#pragma unroll
  for (int h = 0; h < GM; ++h)
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[h][e] = 0.f;

  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile t landed; tile t-1's stage is free again
    if (t + STAGES - 1 < ntiles) load_tile(t + STAGES - 1);
    cp_async_commit();
    const unsigned char* ks = smem + (t % STAGES) * S::STAGE;
    const unsigned char* vs = ks + TP * KROW;
    const int n = min(TP, end - (start + t * TP));

    {  // scores: position p, heads hs, hs + NHS, ...
      const int p = tid % TP, hs = tid / TP;
      float s[HPT];
#pragma unroll
      for (int j = 0; j < HPT; ++j) s[j] = 0.f;
      const unsigned char* kr = ks + p * KROW;
#pragma unroll 2
      for (int cv = 0; cv < NV; ++cv) {
        float kf[VEC];
        widen(kr + cv * 16, kf, T());
#pragma unroll
        for (int j = 0; j < HPT; ++j) {
          const int h = hs + NHS * j;
          if (HPT * NHS == GM || h < GM) {
            const float4* qq =
                reinterpret_cast<const float4*>(qs + h * D + cv * VEC);
#pragma unroll
            for (int e = 0; e < VEC / 4; ++e) {
              const float4 x = qq[e];
              s[j] = fmaf(x.x, kf[4 * e], s[j]);
              s[j] = fmaf(x.y, kf[4 * e + 1], s[j]);
              s[j] = fmaf(x.z, kf[4 * e + 2], s[j]);
              s[j] = fmaf(x.w, kf[4 * e + 3], s[j]);
            }
          }
        }
      }
#pragma unroll
      for (int j = 0; j < HPT; ++j) {
        const int h = hs + NHS * j;
        if (HPT * NHS == GM || h < GM)
          ps[p * GM + h] = p < n ? s[j] * scale : -INFINITY;
      }
    }
    __syncthreads();

    // the online softmax, a warp per head
    for (int h = warp; h < GM; h += THREADS / 32) {
      float mx = -INFINITY;
      for (int p = lane; p < TP; p += 32) mx = fmaxf(mx, ps[p * GM + h]);
      mx = warp_max(mx);
      const float m_old = st[h];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int p = lane; p < TP; p += 32) {
        const float e = expf(ps[p * GM + h] - m_new);
        ps[p * GM + h] = e;
        sum += e;
      }
      sum = warp_add(sum);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        st[h] = m_new;
        st[GM + h] = st[GM + h] * alpha + sum;
        st[2 * GM + h] = alpha;
      }
    }
    __syncthreads();

    if (g < PG) {  // acc = acc·alpha + Σ_p P[p]·V[p], this slice
#pragma unroll
      for (int h = 0; h < GM; ++h) {
        const float alpha = st[2 * GM + h];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[h][e] *= alpha;
      }
      for (int p = g; p < n; p += PG) {
        float vf[VEC];
        widen(vs + p * ROW + c * 16, vf, T());
        float pr[GM];
        if constexpr (GM % 4 == 0) {
#pragma unroll
          for (int h = 0; h < GM; h += 4) {
            const float4 x = *reinterpret_cast<const float4*>(ps + p * GM + h);
            pr[h] = x.x;
            pr[h + 1] = x.y;
            pr[h + 2] = x.z;
            pr[h + 3] = x.w;
          }
        } else {
#pragma unroll
          for (int h = 0; h < GM; ++h) pr[h] = ps[p * GM + h];
        }
#pragma unroll
        for (int h = 0; h < GM; ++h)
#pragma unroll
          for (int e = 0; e < VEC; ++e)
            acc[h][e] = fmaf(pr[h], vf[e], acc[h][e]);
      }
    }
  }

  // the position groups' sums, in group order, then the chunk's state
  cp_async_wait<0>();
  __syncthreads();
  float* red = reinterpret_cast<float*>(smem);  // [PG][GM][D]
  if (g < PG) {
#pragma unroll
    for (int h = 0; h < GM; ++h)
#pragma unroll
      for (int e = 0; e < VEC; e += 4)
        *reinterpret_cast<float4*>(red + (g * GM + h) * D + c * VEC + e) =
            make_float4(acc[h][e], acc[h][e + 1], acc[h][e + 2],
                        acc[h][e + 3]);
  }
  __syncthreads();
  const long long slot = (long long)bh * gridDim.y + blockIdx.y;
  for (int i = tid; i < G * D; i += THREADS) {
    const int h = i / D, d = i - h * D;
    float sum = 0.f;
    for (int gg = 0; gg < PG; ++gg) sum += red[(gg * GM + h) * D + d];
    part_acc[slot * G * D + i] = sum;
  }
  if (tid < G) {
    part_ml[(slot * G + tid) * 2] = st[tid];
    part_ml[(slot * G + tid) * 2 + 1] = st[GM + tid];
  }
}

// o[b, h] = Σ_c e^{m_c - M} acc_c / Σ_c e^{m_c - M} l_c over the row's live
// chunks, M their largest m; in q's type.
template <typename TO>
__global__ void __launch_bounds__(THREADS)
decode_merge_kernel(const float* __restrict__ part_acc,
                    const float* __restrict__ part_ml,
                    const int* __restrict__ lengths, TO* __restrict__ out,
                    int Hq, int G, int D, int Smax, int chunk, int nchunk) {
  const int bq = blockIdx.x;  // b · Hq + query head
  const int b = bq / Hq, hq = bq - b * Hq;
  const int h = hq % G;
  const long long slot0 = (long long)(bq / G) * nchunk;  // (b, KV head)
  const int len = min(lengths[b], Smax);
  const int live = len > 0 ? (len + chunk - 1) / chunk : 0;
  float M = -INFINITY;
  for (int c = 0; c < live; ++c)
    M = fmaxf(M, part_ml[((slot0 + c) * G + h) * 2]);
  float L = 0.f;
  for (int c = 0; c < live; ++c) {
    const float* ml = part_ml + ((slot0 + c) * G + h) * 2;
    L += expf(ml[0] - M) * ml[1];
  }
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float o = 0.f;
    for (int c = 0; c < live; ++c)
      o += expf(part_ml[((slot0 + c) * G + h) * 2] - M) *
           part_acc[((slot0 + c) * G + h) * D + d];
    out[(long long)bq * D + d] = from_acc<TO>(live ? o / L : 0.f);
  }
}

template <typename T, int D, int GM>
int launch(const void* q, int q_bf16, const void* k, const void* v,
           const int* lengths, float* part_acc, float* part_ml, int B,
           int Hkv, int G, int Smax, int chunk, int nchunk, float scale,
           cudaStream_t s) {
  using S = Shape<T, D, GM>;
  if (chunk % S::TP) return (int)cudaErrorInvalidValue;
  auto kern = decode_chunk_kernel<T, D, GM>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, S::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(B * Hkv, nchunk);
  kern<<<grid, THREADS, S::BYTES, s>>>(q, q_bf16, (const T*)k, (const T*)v,
                                       lengths, part_acc, part_ml, Hkv, G,
                                       Smax, chunk, scale);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_g(const void* q, int q_bf16, const void* k, const void* v,
             const int* lengths, float* part_acc, float* part_ml, int B,
             int Hkv, int G, int Smax, int chunk, int nchunk, float scale,
             cudaStream_t s) {
#define REPRO_DECODE_G(GM)                                                 \
  return launch<T, D, GM>(q, q_bf16, k, v, lengths, part_acc, part_ml, B, \
                          Hkv, G, Smax, chunk, nchunk, scale, s)
  // f32 caches take one width of group (not the serving path)
  if constexpr (sizeof(T) == 4) {
    REPRO_DECODE_G(8);
  } else {
    if (G <= 1) REPRO_DECODE_G(1);
    if (G <= 2) REPRO_DECODE_G(2);
    if (G <= 4) REPRO_DECODE_G(4);
    REPRO_DECODE_G(8);
  }
#undef REPRO_DECODE_G
}

template <typename T>
int launch_d(const void* q, int q_bf16, const void* k, const void* v,
             const int* lengths, float* part_acc, float* part_ml, int B,
             int Hkv, int G, int Smax, int D, int chunk, int nchunk,
             float scale, cudaStream_t s) {
#define REPRO_DECODE_D(DD)                                                \
  case DD:                                                                \
    return launch_g<T, DD>(q, q_bf16, k, v, lengths, part_acc, part_ml, B, \
                           Hkv, G, Smax, chunk, nchunk, scale, s)
  switch (D) {
    REPRO_DECODE_D(32);
    REPRO_DECODE_D(64);
    REPRO_DECODE_D(80);
    REPRO_DECODE_D(128);
    REPRO_DECODE_D(256);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef REPRO_DECODE_D
}

}  // namespace

// q (B, Hq, D) and out (B, Hq, D) in q's type; k and v (B, Smax, Hkv·D) in
// the cache's type, contiguous and 16-byte aligned; lengths (B,) int32;
// scratch part_acc (B·Hkv·nchunk·G·D) and part_ml (B·Hkv·nchunk·G·2) f32.
// chunk is a multiple of the tile (kernels/decode_attention.py: plan).
extern "C" int repro_decode_attention(int cache_dtype, int q_dtype,
                                      const void* q, const void* k,
                                      const void* v, const void* lengths,
                                      void* part_acc, void* part_ml,
                                      void* out, int B, int Hq, int Hkv,
                                      int Smax, int D, int chunk, int nchunk,
                                      double scale, void* stream) {
  if (B < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv || Hq / Hkv > 8 ||
      Smax < 1 || chunk < 1 || nchunk < 1 || nchunk > 65535 ||
      (long long)(nchunk - 1) * chunk >= Smax)
    return (int)cudaErrorInvalidValue;
  if (q_dtype != DTYPE_F32 && q_dtype != DTYPE_BF16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int G = Hq / Hkv, q_bf16 = q_dtype == DTYPE_BF16;
  const int* len = (const int*)lengths;
  float* pa = (float*)part_acc;
  float* pm = (float*)part_ml;
  int rc;
  switch (cache_dtype) {
    case DTYPE_F32:
      rc = launch_d<float>(q, q_bf16, k, v, len, pa, pm, B, Hkv, G, Smax, D,
                           chunk, nchunk, (float)scale, s);
      break;
    case DTYPE_BF16:
      rc = launch_d<__nv_bfloat16>(q, q_bf16, k, v, len, pa, pm, B, Hkv, G,
                                   Smax, D, chunk, nchunk, (float)scale, s);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  if (rc) return rc;
  if (q_bf16)
    decode_merge_kernel<__nv_bfloat16><<<B * Hq, THREADS, 0, s>>>(
        pa, pm, len, (__nv_bfloat16*)out, Hq, G, D, Smax, chunk, nchunk);
  else
    decode_merge_kernel<float><<<B * Hq, THREADS, 0, s>>>(
        pa, pm, len, (float*)out, Hq, G, D, Smax, chunk, nchunk);
  return (int)cudaGetLastError();
}
