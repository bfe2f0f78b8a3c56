// y[b] = A[b]^T (A[b] x[b]) for a batch of row-major (M, N) matrices.
//
// Replaces the Pallas TPU kernel src/repro/kernels/atax.py (atax /
// _atax_kernel).  That kernel sweeps row blocks of A in grid order and carries
// the (1, N) output accumulator in VMEM from one grid step to the next, which
// is only correct because a TPU core runs its grid in order.  GPU blocks run
// concurrently and in no order, so a literal copy would race.  Here it is two
// passes:
//   1. atax_partial_kernel: block g of batch b walks row panels g, g+G, ...
//      (8 rows each, one warp per row).  For a panel it computes
//      tmp = A_panel x in shared memory, then adds A_panel^T tmp into its own
//      partial row partial[b][g][:].  No other block touches that row.
//   2. atax_reduce_kernel sums the G partial rows of each batch in a fixed
//      order, so the result does not change from run to run.
//
// Bound on the card: bytes (2MN flops over MN elements of A).  A panel is
// read twice in a row by the same block (once for A x, once for A^T tmp); the
// second read mostly hits L2, which holds the panels in flight.  Reading A
// exactly once would need the panel on chip across both uses; that is for a
// later version.
#include "common.cuh"

namespace {

constexpr int ROWS = 8;  // rows per panel == warps per block
constexpr int THREADS = ROWS * 32;

template <typename T>
__global__ void __launch_bounds__(THREADS)
atax_partial_kernel(const T* __restrict__ A, const T* __restrict__ x,
                    typename AccOf<T>::type* __restrict__ partial, int M, int N,
                    int G) {
  using Acc = typename AccOf<T>::type;
  __shared__ Acc tmp[ROWS];
  const long long b = blockIdx.y;
  const int g = blockIdx.x;
  A += b * (long long)M * N;
  x += b * (long long)N;
  Acc* part = partial + (b * G + g) * (long long)N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int npanels = (M + ROWS - 1) / ROWS;
  bool first = true;
  for (int p = g; p < npanels; p += G) {
    const int r = p * ROWS + warp;
    Acc s = Acc(0);
    if (r < M) {
      const T* row = A + (long long)r * N;
      for (int j = lane; j < N; j += 32) s += load_acc(row[j]) * load_acc(x[j]);
    }
    s = warp_sum(s);
    if (lane == 0) tmp[warp] = s;
    __syncthreads();
    const int rows = min(ROWS, M - p * ROWS);
    const T* panel = A + (long long)p * ROWS * N;
    for (int j = threadIdx.x; j < N; j += THREADS) {
      Acc acc = first ? Acc(0) : part[j];
      for (int rr = 0; rr < rows; ++rr) acc += load_acc(panel[(long long)rr * N + j]) * tmp[rr];
      part[j] = acc;
    }
    first = false;
    __syncthreads();  // tmp is rewritten by the next panel
  }
  if (first)
    for (int j = threadIdx.x; j < N; j += THREADS) part[j] = Acc(0);
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

}  // namespace

// partial: scratch of batch * G * N accumulator-typed elements.
extern "C" int repro_atax(int dtype, const void* a, const void* x, void* partial,
                          void* y, long long batch, int M, int N, int G,
                          void* stream) {
  if (batch < 1 || batch > 65535 || M < 1 || N < 1 || G < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const long long total = batch * N;
  long long rblocks = (total + 255) / 256;
  if (rblocks > 132 * 16) rblocks = 132 * 16;
#define ATAX_LAUNCH(T)                                                         \
  {                                                                            \
    using Acc = typename AccOf<T>::type;                                       \
    atax_partial_kernel<T><<<dim3(G, (unsigned)batch), THREADS, 0, s>>>(       \
        (const T*)a, (const T*)x, (Acc*)partial, M, N, G);                     \
    cudaError_t err = cudaGetLastError();                                      \
    if (err != cudaSuccess) return (int)err;                                   \
    atax_reduce_kernel<T><<<(unsigned)rblocks, 256, 0, s>>>((const Acc*)partial, \
                                                            (T*)y, N, G, total); \
  }
  REPRO_DISPATCH_DTYPE(dtype, ATAX_LAUNCH)
#undef ATAX_LAUNCH
  return (int)cudaGetLastError();
}
