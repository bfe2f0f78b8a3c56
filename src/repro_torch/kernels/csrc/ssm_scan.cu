// The SSM scan of a Mamba-1 layer: h_t = a_t ⊙ h_{t-1} + b_t and
// y_t[d] = Σ_n h_t[d, n] · c_t[n], for a, b of shape (B, S, D, N) and c of
// shape (B, S, N), giving y (B, S, D).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssm_scan.py (ssm_scan /
// _ssm_kernel).  It computes that kernel's function, not its block schedule:
// there, the grid is (B, D/block_d, S/chunk) with the sequence innermost, and
// the (block_d, N) state is carried from one grid step to the next in a VMEM
// scratch.  CUDA blocks run in no order, so a literal copy races.  Here one
// block owns one (batch row, group of channels) and walks the whole sequence
// in a loop of its own; the sequence is never split across blocks.
//
// Layout: the lanes cover (d, n) with n fastest.  For N <= 32 a group of N
// lanes holds one channel's N states, one per thread in a register, so
// N = 16 puts two channels in a warp; for N = 64 a warp holds one channel and
// each thread two states (n and n + 32).  A step's loads of a and b are the
// block's channels × N contiguous elements (coalesced); c_t is the same for
// every channel and comes from the cache.  The sum over n is a
// __shfl_xor_sync tree inside the lane group.  The loads do not depend on h,
// so the t loop is unrolled by UNROLL: the loads of the next steps are in
// flight while the chain of FMAs runs.  The edges are masked (any D, S >= 1),
// not padded with a = 1 as the TPU kernel pads them.  No atomics: the result
// is deterministic.
//
// Types: a, b, c in f32 (the model's) or bf16 (the standalone sweep); the
// state and the sums in f32; y in a's type.  h0 (B, D, N) f32, if given, is
// read once before the first step; the final state (B, D, N) f32, if asked
// for, is written once after the last.
//
// Bound on the card: bytes.  Each step moves 2·N elements of a and b per
// channel for 4·N operations (two FMAs per state): about 0.5 operations a
// byte in f32, far below the H100's ~20.  At the prefill chunk of
// falcon-mamba-7b (4 × 256 tokens, D = 8192, N = 16, f32) a and b are 537 MB
// each: 0.33 ms at 3.35 TB/s.  Fusing the gate construction (exp(dt·A) and
// dt·x·B) into this kernel would remove a and b from device memory
// altogether; that is later work.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

template <typename T, int N>
__global__ void __launch_bounds__(THREADS)
ssm_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                const T* __restrict__ c, const float* __restrict__ h0,
                T* __restrict__ y, float* __restrict__ h_out, int S, int D) {
  constexpr int LANES = N < 32 ? N : 32;  // lanes per channel
  constexpr int NPT = N / LANES;          // states per thread
  constexpr int CH = THREADS / LANES;     // channels per block
  static_assert(LANES * NPT == N, "N must be a power of two up to 64");

  const int bi = blockIdx.y;
  const int ln = threadIdx.x % LANES;
  const int d = blockIdx.x * CH + threadIdx.x / LANES;
  const bool live = d < D;

  const long long dn = (long long)D * N;  // stride of t in a and b
  const long long off = (long long)bi * S * dn + (long long)d * N + ln;
  const T* ap = a + off;
  const T* bp = b + off;
  const T* cp = c + (long long)bi * S * N + ln;
  T* yp = y + (long long)bi * S * D + d;

  float h[NPT];
#pragma unroll
  for (int j = 0; j < NPT; ++j)
    h[j] = (h0 != nullptr && live)
               ? h0[((long long)bi * D + d) * N + ln + j * LANES]
               : 0.f;

  for (int t0 = 0; t0 < S; t0 += UNROLL) {
    float av[UNROLL][NPT], bv[UNROLL][NPT], cv[UNROLL][NPT];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const bool in = live && t0 + u < S;
      const long long tt = (long long)(t0 + u);
#pragma unroll
      for (int j = 0; j < NPT; ++j) {
        av[u][j] = in ? load_acc(ap[tt * dn + j * LANES]) : 0.f;
        bv[u][j] = in ? load_acc(bp[tt * dn + j * LANES]) : 0.f;
        cv[u][j] = (t0 + u < S) ? load_acc(cp[tt * N + j * LANES]) : 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      if (t0 + u < S) {  // the same for the whole block
        float part = 0.f;
#pragma unroll
        for (int j = 0; j < NPT; ++j) {
          h[j] = fmaf(av[u][j], h[j], bv[u][j]);
          part = fmaf(h[j], cv[u][j], part);
        }
        // every lane takes part in the shuffles, live or not
#pragma unroll
        for (int s = LANES / 2; s > 0; s >>= 1)
          part += __shfl_xor_sync(0xffffffffu, part, s);
        if (live && ln == 0) yp[(long long)(t0 + u) * D] = from_acc<T>(part);
      }
    }
  }

  if (h_out != nullptr && live) {
#pragma unroll
    for (int j = 0; j < NPT; ++j)
      h_out[((long long)bi * D + d) * N + ln + j * LANES] = h[j];
  }
}

template <typename T, int N>
int launch(const void* a, const void* b, const void* c, const void* h0,
           void* y, void* h_out, int B, int S, int D, cudaStream_t s) {
  constexpr int LANES = N < 32 ? N : 32;
  constexpr int CH = THREADS / LANES;
  dim3 grid((unsigned)((D + CH - 1) / CH), (unsigned)B);
  ssm_scan_kernel<T, N><<<grid, THREADS, 0, s>>>(
      (const T*)a, (const T*)b, (const T*)c, (const float*)h0, (T*)y,
      (float*)h_out, S, D);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_n(const void* a, const void* b, const void* c, const void* h0,
             void* y, void* h_out, int B, int S, int D, int N,
             cudaStream_t s) {
  switch (N) {
    case 8:
      return launch<T, 8>(a, b, c, h0, y, h_out, B, S, D, s);
    case 16:
      return launch<T, 16>(a, b, c, h0, y, h_out, B, S, D, s);
    case 32:
      return launch<T, 32>(a, b, c, h0, y, h_out, B, S, D, s);
    case 64:
      return launch<T, 64>(a, b, c, h0, y, h_out, B, S, D, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// h0 and h_out may be null.  dtype: DTYPE_F32 or DTYPE_BF16.
extern "C" int repro_ssm_scan(int dtype, const void* a, const void* b,
                              const void* c, const void* h0, void* y,
                              void* h_out, int B, int S, int D, int N,
                              void* stream) {
  if (B < 1 || S < 1 || D < 1 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (dtype) {
    case DTYPE_F32:
      return launch_n<float>(a, b, c, h0, y, h_out, B, S, D, N, s);
    case DTYPE_BF16:
      return launch_n<__nv_bfloat16>(a, b, c, h0, y, h_out, B, S, D, N, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
