// y[b] = A[b]^T (A[b] x[b]) for a batch of row-major (M, N) matrices.
//
// Replaces the Pallas TPU kernel src/repro/kernels/atax.py (atax /
// _atax_kernel).  That kernel reads A once: each (bm, N) row block gives
// its tmp = A_blk x and, in the same visit, its rank-bm update
// A_blk^T tmp, into a (1, N) accumulator carried in VMEM across an ordered
// grid.  GPU blocks run in no order, so the carry cannot be copied; this
// kernel gets the single read back with a thread-block cluster instead.
//
// Bound on the card: bytes (4MN operations over MN elements of A).
//
// Design (atax_cluster_kernel):
//   * One cluster of C CTAs (C <= 8, the portable size) owns (batch item b,
//     row group g).  CTA rank c owns the column slice [c S VEC, (c+1) S VEC)
//     of A and x: S 16-byte chunks of VEC elements, the last slice ragged.
//     The row group is a run of whole R-row panels.
//   * Each CTA walks its panels through a ring of 2-3 shared-memory stages.
//     Where every row of the slice starts on 16 bytes (A aligned, N *
//     sizeof(T) a multiple of 16) warp 0 copies them with cp.async.bulk,
//     one copy a row, counted by the stage's mbarrier, two or three panels
//     ahead; otherwise each thread fills its own chunks of the stage with
//     plain loads (bf16 with odd N, a view off 16 bytes) in the same
//     kernel.  Bulk copies do not zero-fill: rows past M and chunks past
//     the slice are never read from the ring.
//   * A x inside the cluster: each thread forms R partial dots of its chunks
//     with its x chunks (kept in registers); the warp sums R values at once
//     (a halving exchange, 9 shuffles for R = 8); the warps' sums meet in a
//     fixed order, giving t_c[R].  Then each of R threads pushes its value
//     with st.async into slot [c][row] of every CTA of the cluster, itself
//     included; each CTA's mbarrier for that panel parity counts the C * R
//     values, and once it completes the CTA sums its slots in rank order
//     0..C-1, so every CTA forms the same t, bit for bit.  No cluster
//     barrier a panel: a CTA waits only for the data it needs.  The slots
//     are double-buffered by panel parity: a peer can store panel i + 2's
//     values only after this CTA has pushed panel i + 1's, which it does
//     after reading panel i's slots.
//   * A^T t from the same stage: each thread adds A_slice^T t into its y
//     accumulators, which stay in registers across all panels.  A is read
//     from device memory once; nothing goes back to it per panel.  A stage
//     is refilled after the next panel's first CTA barrier, when every
//     thread is done with it.
//   * Epilogue: with one row group (G = 1) y is written once from the
//     registers.  With G > 1 (tall M, to fill the card) each group writes
//     its partial row and atax_reduce_kernel sums the G rows in the fixed
//     order g = 0..G-1.
//   * Two cluster barriers in all: after the mbarriers are set up (before
//     any peer stores into them) and before exit (no CTA leaves while a
//     peer may still store into it).
// Every sum is taken in a fixed order, so the result does not change from
// run to run.  The plan (C, R, stages, G, threads, chunks per thread) comes
// from kernels/atax.py.  The copies are one-dimensional bulk copies, not
// TMA tensor maps: a row of a slice is contiguous, so no map is needed,
// and nothing is encoded on the host per call.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_STAGES = 3;
constexpr int MAX_CLUSTER = 8;

// VEC elements of a 16-byte pack, as the accumulator type
template <typename T>
__device__ __forceinline__ typename AccOf<T>::type elem(const uint4& p, int v) {
  return load_acc(reinterpret_cast<const T*>(&p)[v]);
}

// the first `valid` elements of a pack from global memory, plain loads, the
// rest zero
template <typename T>
__device__ __forceinline__ uint4 load_pack(const T* src, int valid) {
  uint4 p = make_uint4(0, 0, 0, 0);
  T* e = reinterpret_cast<T*>(&p);
#pragma unroll
  for (int v = 0; v < 16 / (int)sizeof(T); ++v)
    if (v < valid) e[v] = src[v];
  return p;
}

// Sums v[0..R) over the warp's lanes.  Each step halves the values a lane
// holds: the lanes with bit `off` set keep the upper half and give away the
// lower.  Returns the total of row lane / (32 / R), which every lane of
// that group of 32 / R lanes holds.
template <int R, typename Acc>
__device__ __forceinline__ Acc warp_sum_rows(Acc (&v)[R], int lane) {
  int off = 16;
#pragma unroll
  for (int h = R / 2; h >= 1; h /= 2, off /= 2) {
    const bool upper = lane & off;
#pragma unroll
    for (int i = 0; i < h; ++i) {
      const Acc send = upper ? v[i] : v[i + h];
      const Acc keep = upper ? v[i + h] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
    }
  }
  Acc s = v[0];
  for (; off >= 1; off /= 2) s += __shfl_xor_sync(0xffffffffu, s, off);
  return s;
}

template <typename T, int R, int CH>
__global__ void __launch_bounds__(MAX_THREADS)
atax_cluster_kernel(const T* __restrict__ A, const T* __restrict__ x,
                    T* __restrict__ y, typename AccOf<T>::type* __restrict__ partial,
                    int M, int N, int G, int S, int stages, int bulk) {
  using Acc = typename AccOf<T>::type;
  constexpr int VEC = 16 / sizeof(T);
  extern __shared__ __align__(128) uint4 ring[];  // [stages][R][S] packs
  __shared__ uint64_t full[MAX_STAGES];           // a stage has landed
  __shared__ uint64_t got[2];                     // all C partials, by parity
  __shared__ Acc red[MAX_WARPS][R];
  __shared__ Acc recv[2][MAX_CLUSTER][R];         // [parity][rank][row]
  __shared__ Acc tfull[R];

  const int C = (int)cluster_size();
  const int rank = (int)cluster_rank();
  const long long cid = cluster_index();
  const long long b = cid / G;
  const int g = (int)(cid % G);
  const int tid = threadIdx.x, nthreads = blockDim.x;
  const int warp = tid / 32, lane = tid % 32, warps = nthreads / 32;
  const int panels = (M + R - 1) / R;
  const int p0 = (int)((long long)g * panels / G);
  const int np = (int)((long long)(g + 1) * panels / G) - p0;
  const int c0 = rank * S * VEC;  // first column of this CTA's slice
  const int width = max(0, min(S * VEC, N - c0));
  const int nchunk = (width + VEC - 1) / VEC;
  A += b * (long long)M * N + c0;
  x += b * (long long)N + c0;

  uint4 xr[CH];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch) {
    const int k = tid + ch * nthreads;
    xr[ch] = k < nchunk ? load_pack(x + k * VEC, width - k * VEC)
                        : make_uint4(0, 0, 0, 0);
  }
  Acc yacc[CH][VEC];
#pragma unroll
  for (int ch = 0; ch < CH; ++ch)
#pragma unroll
    for (int v = 0; v < VEC; ++v) yacc[ch][v] = Acc(0);

  // warp 0 fills stage i % stages with panel i: one bulk copy a row
  const uint32_t rowbytes = (uint32_t)nchunk * 16;
  auto issue = [&](int i) {
    const int s = i % stages, row0 = (p0 + i) * R;
    const int rows = min(R, M - row0);
    if (lane == 0) mbar_arrive_expect_tx(&full[s], rows * rowbytes);
    __syncwarp();
    if (lane < rows && rowbytes)
      bulk_load(ring + ((long long)s * R + lane) * S,
                A + (long long)(row0 + lane) * N, rowbytes, &full[s]);
  };
  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_init(&got[0], 1);
    mbar_init(&got[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers are set before any peer stores
  if (bulk && warp == 0)
    for (int i = 0; i < min(stages, np); ++i) issue(i);

  for (int i = 0; i < np; ++i) {
    const int row0 = (p0 + i) * R, rows = min(R, M - row0), par = i & 1;
    uint4* stage = ring + (long long)(i % stages) * R * S;
    if (bulk) {
      mbar_wait(&full[i % stages], (uint32_t)(i / stages) & 1);
    } else {
      // plain loads; a thread reads back only the chunks it wrote
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int ch = 0; ch < CH; ++ch) {
          const int k = tid + ch * nthreads;
          if (r < rows && k < nchunk)
            stage[r * S + k] = load_pack(A + (long long)(row0 + r) * N + k * VEC,
                                         width - k * VEC);
        }
    }

    // t_c = A_panel,slice x_slice: per thread, per warp, then the warps in
    // order; rows past M and chunks past the slice count as zero
    Acc v[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      v[r] = Acc(0);
#pragma unroll
      for (int ch = 0; ch < CH; ++ch) {
        const int k = tid + ch * nthreads;
        if (r < rows && k < nchunk) {
          const uint4 a = stage[r * S + k];
#pragma unroll
          for (int e = 0; e < VEC; ++e) v[r] += elem<T>(a, e) * elem<T>(xr[ch], e);
        }
      }
    }
    const Acc w = warp_sum_rows<R>(v, lane);
    if (lane % (32 / R) == 0) red[warp][lane / (32 / R)] = w;
    __syncthreads();
    // every thread is done with panel i - 1: refill its stage
    if (bulk && warp == 0 && i > 0 && i - 1 + stages < np) issue(i - 1 + stages);
    if (tid < R) {
      Acc s = Acc(0);
      for (int k = 0; k < warps; ++k) s += red[k][tid];
      // push t_c[row] into slot [rank][row] of every CTA of the cluster
      for (int c = 0; c < C; ++c)
        st_async(map_rank(&recv[par][rank][tid], c), s, map_rank(&got[par], c));
      if (tid == 0)
        mbar_arrive_expect_tx(&got[par], (uint32_t)(C * R * sizeof(Acc)));
      mbar_wait<true>(&got[par], (uint32_t)(i >> 1) & 1);
      Acc t = Acc(0);
      for (int c = 0; c < C; ++c) t += recv[par][c][tid];
      tfull[tid] = t;
    }
    __syncthreads();

    // y_slice += A_panel,slice^T t, rows in order
    Acc t[R];
#pragma unroll
    for (int r = 0; r < R; ++r) t[r] = tfull[r];
#pragma unroll
    for (int ch = 0; ch < CH; ++ch) {
      const int k = tid + ch * nthreads;
      if (k >= nchunk) continue;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= rows) break;
        const uint4 a = stage[r * S + k];
#pragma unroll
        for (int e = 0; e < VEC; ++e) yacc[ch][e] += elem<T>(a, e) * t[r];
      }
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still store into it

#pragma unroll
  for (int ch = 0; ch < CH; ++ch) {
    const int k = tid + ch * nthreads;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const int col = k * VEC + e;
      if (k >= nchunk || col >= width) continue;
      if (G == 1)
        y[b * N + c0 + col] = from_acc<T>(yacc[ch][e]);
      else
        partial[(b * G + g) * (long long)N + c0 + col] = yacc[ch][e];
    }
  }
}

template <typename T>
__global__ void atax_reduce_kernel(const typename AccOf<T>::type* __restrict__ partial,
                                   T* __restrict__ y, int N, int G, long long total) {
  using Acc = typename AccOf<T>::type;
  long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += stride) {
    const long long b = i / N, j = i % N;
    const Acc* col = partial + b * G * (long long)N + j;
    Acc s = Acc(0);
    for (int g = 0; g < G; ++g) s += col[(long long)g * N];
    y[i] = from_acc<T>(s);
  }
}

struct Shape {
  long long batch;
  int M, N, C, R, stages, G, threads, ch;
};

template <typename T>
int slice_chunks(const Shape& sh) {
  const long long chunks = ((long long)sh.N * sizeof(T) + 15) / 16;
  return (int)((chunks + sh.C - 1) / sh.C);
}

template <typename T, int R, int CH>
cudaError_t config(const Shape& sh, const void* a, cudaLaunchConfig_t& cfg,
                   cudaLaunchAttribute* attr, int& S, int& bulk) {
  S = slice_chunks<T>(sh);
  bulk = !((uintptr_t)a % 16) && ((long long)sh.N * sizeof(T)) % 16 == 0;
  const size_t smem = (size_t)sh.stages * R * S * 16;
  cudaError_t err = cudaFuncSetAttribute(
      atax_cluster_kernel<T, R, CH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  cfg = cudaLaunchConfig_t{};
  cfg.gridDim = dim3((unsigned)(sh.batch * sh.G * sh.C));
  cfg.blockDim = dim3(sh.threads);
  cfg.dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = sh.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaSuccess;
}

template <typename T, int R, int CH>
int run(const Shape& sh, const void* a, const void* x, void* partial, void* y,
        cudaStream_t s) {
  using Acc = typename AccOf<T>::type;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int S, bulk;
  cudaError_t err = config<T, R, CH>(sh, a, cfg, attr, S, bulk);
  if (err != cudaSuccess) return (int)err;
  cfg.stream = s;
  err = cudaLaunchKernelEx(&cfg, atax_cluster_kernel<T, R, CH>, (const T*)a,
                           (const T*)x, (T*)y, (Acc*)partial, sh.M, sh.N, sh.G,
                           S, sh.stages, bulk);
  if (err != cudaSuccess) return (int)err;
  if (sh.G > 1) {
    const long long total = sh.batch * sh.N;
    long long blocks = (total + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    atax_reduce_kernel<T><<<(unsigned)blocks, 256, 0, s>>>((const Acc*)partial,
                                                           (T*)y, sh.N, sh.G, total);
  }
  return (int)cudaGetLastError();
}

template <typename T, int R, int CH>
int max_clusters(const Shape& sh, int* out) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int S, bulk;
  cudaError_t err = config<T, R, CH>(sh, (const void*)0, cfg, attr, S, bulk);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(out, atax_cluster_kernel<T, R, CH>,
                                             &cfg);
}

bool valid(const Shape& sh, int itemsize) {
  if (sh.batch < 1 || sh.M < 1 || sh.N < 1 || sh.C < 1 || sh.C > MAX_CLUSTER ||
      sh.G < 1 || sh.threads < 32 || sh.threads > MAX_THREADS ||
      sh.threads % 32 || sh.stages < 2 || sh.stages > MAX_STAGES)
    return false;
  if (sh.batch * sh.G * sh.C > 0x7fffffffLL) return false;
  const long long chunks = ((long long)sh.N * itemsize + 15) / 16;
  return (chunks + sh.C - 1) / sh.C <= (long long)sh.threads * sh.ch;
}

// the (T, R, CH) instance of F: R in {2, 4, 8}, CH in {1, 2, 4}
#define ATAX_DISPATCH(T, F, ...)                                   \
  switch (sh.R * 8 + sh.ch) {                                      \
    case 17: return F<T, 2, 1>(__VA_ARGS__);                       \
    case 18: return F<T, 2, 2>(__VA_ARGS__);                       \
    case 20: return F<T, 2, 4>(__VA_ARGS__);                       \
    case 33: return F<T, 4, 1>(__VA_ARGS__);                       \
    case 34: return F<T, 4, 2>(__VA_ARGS__);                       \
    case 36: return F<T, 4, 4>(__VA_ARGS__);                       \
    case 65: return F<T, 8, 1>(__VA_ARGS__);                       \
    case 66: return F<T, 8, 2>(__VA_ARGS__);                       \
    default: return (int)cudaErrorInvalidValue;                    \
  }

template <typename T>
int run_t(const Shape& sh, const void* a, const void* x, void* partial, void* y,
          cudaStream_t s) {
  if (!valid(sh, sizeof(T))) return (int)cudaErrorInvalidValue;
  ATAX_DISPATCH(T, run, sh, a, x, partial, y, s)
}

template <typename T>
int max_clusters_t(const Shape& sh, int* out) {
  if (!valid(sh, sizeof(T))) return (int)cudaErrorInvalidValue;
  ATAX_DISPATCH(T, max_clusters, sh, out)
}

}  // namespace

// partial: scratch of batch * G * N accumulator-typed elements (unused, and
// may be null, when G == 1).
extern "C" int repro_atax(int dtype, const void* a, const void* x, void* partial,
                          void* y, long long batch, int M, int N, int C, int R,
                          int stages, int G, int threads, int ch, void* stream) {
  const Shape sh{batch, M, N, C, R, stages, G, threads, ch};
  if (G > 1 && !partial) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
#define ATAX_RUN(T) return run_t<T>(sh, a, x, partial, y, s)
  REPRO_DISPATCH_DTYPE(dtype, ATAX_RUN)
#undef ATAX_RUN
  return (int)cudaErrorInvalidValue;
}

// How many clusters of this plan the card holds at once
// (cudaOccupancyMaxActiveClusters).
extern "C" int repro_atax_max_clusters(int dtype, int N, int C, int R,
                                       int stages, int threads, int ch,
                                       int* out) {
  const Shape sh{1, 1, N, C, R, stages, 1, threads, ch};
#define ATAX_OCC(T) return max_clusters_t<T>(sh, out)
  REPRO_DISPATCH_DTYPE(dtype, ATAX_OCC)
#undef ATAX_OCC
  return (int)cudaErrorInvalidValue;
}
