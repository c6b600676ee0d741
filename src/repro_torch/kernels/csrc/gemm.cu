// Dense GEMM kernels: `gemm` (z = x @ y, f32 accumulator, out_dtype cast),
// `gemm_batch` (stacked z[t] = x[t] @ y[t]) and the Dense Task Queue's
// `gemm_batch_scatter` (task t overwrites one tile of a canvas in place).
//
// gemm replaces the Pallas kernel `src/repro/kernels/gemm.py:40` (grid
// (M/bm, N/bn, K/bk), the contraction innermost, an f32 VMEM accumulator
// zeroed at k == 0 and cast to out_dtype at the last k step).
// gemm_batch replaces `src/repro/kernels/gemm.py:165` (grid (T, K/bk),
// output block (t, 0, 0)).  gemm_batch_scatter replaces
// `src/repro/kernels/gemm.py:94` (grid (T, K/bk), output index map
// (rows[t], cols[t]) on a canvas aliased to the output).  Here one thread
// block owns one output tile and walks all of K itself, so no accumulator
// crosses blocks; the three kernels run one body (batched_tile) on the
// register-blocked tile product of sgemm_sm90.cuh, which gives the note on
// tiles, stages, layouts and the summation order.  They differ only in
// where a task's tile is stored: gemm and gemm_batch write z[t] densely
// (row stride n), the scatter writes task t at canvas rows
// [rows[t]*m, +m) and columns [cols[t]*n, +n) (row stride nz) and leaves
// every other canvas element as it is.
//
// What bounds them on an H100: GCN-FL's layer-1 update (x 89,250 x 500,
// y 500 x 128) and the dense queue's batch (8 x 11264 x 500 by 8 x 500 x
// 128) each do ~1.1e10 FLOP over ~225 MB, bound by the FP32 CUDA-core
// rate (67 TFLOP/s, ~0.17 ms); GCN-FL's logits layer (n = 7) is bound by
// reading x once (48 MB, ~0.014 ms).  The launch picks the tile from n
// (tile_for): the narrow tiles for n <= 16, 128 x 64 for n <= 64, else
// 128 x 128.  At n = 128 the layer-1 update is 698 tiles of 128 x 128,
// 2.64 waves of two thread blocks on each of 132 SMs; the 128 x 64 tile,
// 3.5 waves of three, ran slower (scripts/gemm_tile_ablation.py,
// `wide64`), so the tail wave was left as it is.  The grid is
// one-dimensional over a task's tiles, the column tiles of a row stripe
// adjacent, so they share x through L2; the task is blockIdx.y.  The
// wrappers pad nothing: the kernels mask their own M, N and K tails.
//
// Inputs of gemm are float32 or bfloat16 (both of one type; bf16 widened
// in registers, which is exact, and a product of two bf16 values is exact
// in f32), its output float32 or bfloat16 (round to nearest even).
// gemm_batch and gemm_batch_scatter are float32.  `pred`, when not null,
// predicates a gemm or scatter launch on *pred == when: the compiled
// activation route launches gemm as its dense overflow fallback and the
// scatter as its dense queue inside one captured program, and their
// thread blocks return at once on the branch not taken.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sgemm_sm90.cuh"

namespace {

using namespace sgemm_sm90;

template <class Tile>
__device__ __forceinline__ void tile_origin(int n, int& row0, int& col0) {
  const int col_tiles = (n + Tile::BN - 1) / Tile::BN;
  row0 = (int)(blockIdx.x / col_tiles) * Tile::BM;
  col0 = (int)(blockIdx.x % col_tiles) * Tile::BN;
}

// The canvas of the scatter: task blockIdx.y's tile starts at canvas row
// rows[t]*m and column cols[t]*n, rows ld apart.  Read after the product
// (DenseOut in sgemm_sm90.cuh): read before it, the pointer stayed live
// across the K loop, the 128 x 128 tile spilled 8 bytes and the dense
// queue ran 1.7 % slower (scripts/gemm_tile_ablation.py, `early_origin`).
struct CanvasOut {
  float* z;
  const int* rows;
  const int* cols;
  int m, n;
  int64_t ld;
  __device__ __forceinline__ float* origin() const {
    const int t = blockIdx.y;
    return z + (int64_t)rows[t] * m * ld + (int64_t)cols[t] * n;
  }
};

// The body of the three kernels: tile blockIdx.x of task blockIdx.y of a
// stacked batch (gemm is a batch of one), stored through out.  One body
// gives the kernels one register allocation and one schedule: gemm with
// its own body, operands taken straight from its parameters, ran 15 %
// slower on the layer-1 update (scripts/gemm_tile_ablation.py,
// `own_body`).
template <class Tile, bool VEC, typename TIn, class Out>
__device__ __forceinline__ void batched_tile(const TIn* __restrict__ x,
                                             const TIn* __restrict__ y,
                                             const Out& out, int m, int k,
                                             int n, typename Tile::Smem& s) {
  const int64_t t = blockIdx.y;
  int row0, col0;
  tile_origin<Tile>(n, row0, col0);
  Tile::template tile<VEC>(x + t * m * k, y + t * k * n, out, m, k, n, row0,
                           col0, s);
}

template <class Tile, bool VEC, typename TIn, typename TOut>
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
gemm_kernel(const TIn* __restrict__ x, const TIn* __restrict__ y,
            TOut* __restrict__ z, int m, int k, int n,
            const int* __restrict__ pred, int when) {
  if (skipped(pred, when)) return;
  __shared__ typename Tile::Smem s;
  batched_tile<Tile, VEC>(x, y, DenseOut<TOut>{z, n}, m, k, n, s);
}

template <class Tile, bool VEC>
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
gemm_batch_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ z, int m, int k, int n) {
  __shared__ typename Tile::Smem s;
  batched_tile<Tile, VEC>(
      x, y, DenseOut<float>{z + (int64_t)blockIdx.y * m * n, n}, m, k, n, s);
}

// Task blockIdx.y's tile lands at canvas rows rows[t]*m and columns
// cols[t]*n of z (row stride ldz); nothing else of z is written.
template <class Tile, bool VEC>
__global__ void __launch_bounds__(Tile::THREADS, Tile::MIN_BLOCKS)
gemm_batch_scatter_kernel(const float* __restrict__ x,
                          const float* __restrict__ y,
                          const int* __restrict__ rows,
                          const int* __restrict__ cols,
                          float* __restrict__ z, int m, int k, int n,
                          int ldz, const int* __restrict__ pred, int when) {
  if (skipped(pred, when)) return;
  __shared__ typename Tile::Smem s;
  batched_tile<Tile, VEC>(x, y, CanvasOut{z, rows, cols, m, n, ldz}, m, k,
                          n, s);
}

bool aligned(const void* p, int bytes) {
  return (uintptr_t)p % (uintptr_t)bytes == 0;
}

// Vector loads: k % 4 == 0 and x aligned to four elements; the wide tiles
// also load y by four, so they need n % 4 == 0 and y aligned.  Then every
// row of every task starts aligned too.
template <class Tile, typename TIn>
bool vector_loads(const void* x, const void* y, int k, int n) {
  const int four = 4 * (int)sizeof(TIn);
  const bool y_vec = Tile::BN <= 16 || (n % 4 == 0 && aligned(y, four));
  return k % 4 == 0 && aligned(x, four) && y_vec;
}

template <class Tile>
dim3 grid_of(int m, int n, int T) {
  const int64_t tiles = (int64_t)((m + Tile::BM - 1) / Tile::BM) *
                        ((n + Tile::BN - 1) / Tile::BN);
  return dim3((unsigned)tiles, (unsigned)T);
}

template <class Tile, typename TIn, typename TOut>
int launch_gemm(const void* x, const void* y, void* z, int m, int k, int n,
                const void* pred, int when, cudaStream_t st) {
  const dim3 grid = grid_of<Tile>(m, n, 1);
  if (vector_loads<Tile, TIn>(x, y, k, n))
    gemm_kernel<Tile, true, TIn, TOut><<<grid, Tile::THREADS, 0, st>>>(
        (const TIn*)x, (const TIn*)y, (TOut*)z, m, k, n, (const int*)pred,
        when);
  else
    gemm_kernel<Tile, false, TIn, TOut><<<grid, Tile::THREADS, 0, st>>>(
        (const TIn*)x, (const TIn*)y, (TOut*)z, m, k, n, (const int*)pred,
        when);
  return (int)cudaGetLastError();
}

template <class Tile>
int launch_batch(const void* x, const void* y, void* z, int T, int m, int k,
                 int n, cudaStream_t st) {
  const dim3 grid = grid_of<Tile>(m, n, T);
  if (vector_loads<Tile, float>(x, y, k, n))
    gemm_batch_kernel<Tile, true><<<grid, Tile::THREADS, 0, st>>>(
        (const float*)x, (const float*)y, (float*)z, m, k, n);
  else
    gemm_batch_kernel<Tile, false><<<grid, Tile::THREADS, 0, st>>>(
        (const float*)x, (const float*)y, (float*)z, m, k, n);
  return (int)cudaGetLastError();
}

template <class Tile>
int launch_scatter(const void* x, const void* y, const void* rows,
                   const void* cols, void* z, int T, int m, int k, int n,
                   int ldz, const void* pred, int when, cudaStream_t st) {
  const dim3 grid = grid_of<Tile>(m, n, T);
  if (vector_loads<Tile, float>(x, y, k, n))
    gemm_batch_scatter_kernel<Tile, true><<<grid, Tile::THREADS, 0, st>>>(
        (const float*)x, (const float*)y, (const int*)rows, (const int*)cols,
        (float*)z, m, k, n, ldz, (const int*)pred, when);
  else
    gemm_batch_scatter_kernel<Tile, false><<<grid, Tile::THREADS, 0, st>>>(
        (const float*)x, (const float*)y, (const int*)rows, (const int*)cols,
        (float*)z, m, k, n, ldz, (const int*)pred, when);
  return (int)cudaGetLastError();
}

// Calls pick(Tile{}) with the tile for n: the narrow tiles (every column
// in one tile) for n <= 16, 128 x 64 for n <= 64, else 128 x 128.
template <class Pick>
int tile_for(int n, Pick&& pick) {
  if (n <= 8) return pick(Narrow<8>{});
  if (n <= 16) return pick(Narrow<16>{});
  if (n <= 64) return pick(Wide<64>{});
  return pick(Wide<128, 16>{});
}

template <typename TIn, typename TOut>
int gemm_for(const void* x, const void* y, void* z, int m, int k, int n,
             const void* pred, int when, cudaStream_t st) {
  return tile_for(n, [&](auto tile) {
    return launch_gemm<decltype(tile), TIn, TOut>(x, y, z, m, k, n, pred,
                                                  when, st);
  });
}

}  // namespace

// z (m, n) = x (m, k) @ y (k, n), all row-major contiguous.  in_dtype /
// out_dtype: 0 = float32, 1 = bfloat16.  pred: int32 device flag or null.
extern "C" int gemm_tiled(const void* x, const void* y, void* z, int m, int k,
                          int n, int in_dtype, int out_dtype, const void* pred,
                          int when, void* stream) {
  if (m == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  using bf16 = __nv_bfloat16;
  if (in_dtype == 0 && out_dtype == 0)
    return gemm_for<float, float>(x, y, z, m, k, n, pred, when, st);
  if (in_dtype == 0 && out_dtype == 1)
    return gemm_for<float, bf16>(x, y, z, m, k, n, pred, when, st);
  if (in_dtype == 1 && out_dtype == 0)
    return gemm_for<bf16, float>(x, y, z, m, k, n, pred, when, st);
  if (in_dtype == 1 && out_dtype == 1)
    return gemm_for<bf16, bf16>(x, y, z, m, k, n, pred, when, st);
  return (int)cudaErrorInvalidValue;
}

// z[t] = x[t] @ y[t] for t < T.  x (T, m, k), y (T, k, n), z (T, m, n), all
// f32 row-major contiguous.
extern "C" int gemm_batch_f32(const void* x, const void* y, void* z, int T,
                              int m, int k, int n, void* stream) {
  if (T == 0 || m == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return tile_for(n, [&](auto tile) {
    return launch_batch<decltype(tile)>(x, y, z, T, m, k, n, st);
  });
}

// z[rows[t]*m:+m, cols[t]*n:+n] = x[t] @ y[t] for t < T.  x (T, m, k),
// y (T, k, n), z (., ldz), all f32 row-major contiguous; rows / cols
// int32 tile coordinates on the device; pred an int32 device flag or null.
extern "C" int gemm_batch_scatter_f32(const void* x, const void* y,
                                      const void* rows, const void* cols,
                                      void* z, int T, int m, int k, int n,
                                      int ldz, const void* pred, int when,
                                      void* stream) {
  if (T == 0 || m == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  return tile_for(n, [&](auto tile) {
    return launch_scatter<decltype(tile)>(x, y, rows, cols, z, T, m, k, n,
                                          ldz, pred, when, st);
  });
}
