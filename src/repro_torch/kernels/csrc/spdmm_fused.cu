// Block-sparse x dense products: the fused multi-task SpDMM on an in-place
// canvas, and the single-BlockCSR SpDMM.
//
// spdmm_fused replaces the Pallas kernel `repro/kernels/spdmm.py::spdmm_fused`
// (`_spdmm_fused_kernel` / `_spdmm_fused_inplace_kernel`: grid (n_entries,),
// scalar-prefetched entry arrays, output block (out_rows[t], out_cols[t])
// resident in VMEM across a consecutive run).  For each entry t in order:
//   Z[orow*B:+B, ocol*bn:+bn]  (zeroed if first[t])
//       += A_pool[a_ids[t]] @ Y[y_rows[t]*B:+B, ocol*bn:+bn]
// Output blocks no entry covers keep their canvas content.
//
// spdmm replaces `repro/kernels/spdmm.py::spdmm` (grid (N/bn, nnzb): the
// stored blocks of ONE BlockCSR walked per output column stripe, `first`
// zero-initializing each block-row run): Z[row*B:+B, :] (zeroed if first)
// += blocks[t] @ Y[col_ids[t]*B:+B, :].  It is spdmm_fused with the entry
// list of a single BlockCSR (a_ids = t, y_rows = col_ids, out_rows =
// row_ids) over the whole width of Y, and shares its run walk, so a tile
// computed by either kernel is bitwise the same.
//
// What bounds them on an H100: a GCN aggregation over the Flickr stand-in
// has ~0.9M stored 8x8 blocks (231 MB) and gathers one 8 x bn slice of Y per
// entry (4 KB at bn = 128, mostly L2 hits), i.e. 2*64*bn FLOP per entry --
// ~1.5e10 FLOP at bn = 128.  The FP32 CUDA-core rate bounds the arithmetic
// (~0.2 ms); the block pool and descriptors bound the bytes.
// Design: the TPU walks the entry list sequentially; here one thread block
// owns one output-block RUN (a maximal stretch of entries with one
// (out_row, out_col) key, found from key changes by the wrapper) times a
// chunk of up to 128 columns, so runs proceed in parallel on all SMs while
// each run is still walked in entry order.  Per entry the B x B A block is
// staged in shared memory; each thread owns one column and keeps the B
// accumulators of that column in registers, reading its Y values coalesced
// across the warp.  The accumulator starts from the canvas content (the
// aliasing semantics), a `first` flag zeroes it -- also mid-run -- and it
// is stored once at the end.  Each accumulator sums with fmaf in entry
// order and, within an entry, in increasing k: over a row's stored blocks
// (sorted by block column) that is the dense GEMM kernels' order with the
// zero blocks left out, and a zero product never changes a sum.  No atomics,
// so results are bitwise reproducible; 64-bit addressing throughout (pools
// at Reddit scale pass 2^31 elements).
//
// Run offsets may be padded: a run whose offsets are equal holds no entry
// and its thread blocks return at once.  The compiled activation route,
// whose descriptors are made on the device at run time, launches one slot
// per entry and lets the empty ones exit, so the launch shape never depends
// on the data.  `pred` (not null) predicates the launch on *pred == when
// (the route's overflow flag).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// Walks entries [s, e) of one run into acc (one column per thread).
// a_ids == nullptr means entry t uses pool block t.
template <int B>
__device__ __forceinline__ void walk_run(const float* __restrict__ a_blocks,
                                         const float* __restrict__ y,
                                         const int* __restrict__ a_ids,
                                         const int* __restrict__ y_rows,
                                         const int* __restrict__ first,
                                         int s, int e, int64_t yc, int64_t ldy,
                                         bool active, float* as,
                                         float (&acc)[B]) {
  for (int t = s; t < e; ++t) {
    const int64_t a0 = (int64_t)(a_ids != nullptr ? a_ids[t] : t) * (B * B);
    const int64_t y0 = (int64_t)y_rows[t] * B;
    __syncthreads();  // the previous entry's block is no longer read
    for (int l = threadIdx.x; l < B * B; l += blockDim.x) as[l] = a_blocks[a0 + l];
    __syncthreads();
    if (first[t]) {
#pragma unroll
      for (int r = 0; r < B; ++r) acc[r] = 0.0f;
    }
    if (active) {
#pragma unroll
      for (int kk = 0; kk < B; ++kk) {
        const float yv = y[(y0 + kk) * ldy + yc];
#pragma unroll
        for (int r = 0; r < B; ++r) acc[r] = fmaf(as[r * B + kk], yv, acc[r]);
      }
    }
  }
}

template <int B>
__global__ void spdmm_fused_kernel(const float* __restrict__ a_blocks,
                                   const float* __restrict__ y,
                                   const int* __restrict__ a_ids,
                                   const int* __restrict__ y_rows,
                                   const int* __restrict__ out_rows,
                                   const int* __restrict__ out_cols,
                                   const int* __restrict__ first,
                                   const int* __restrict__ run_starts,
                                   float* __restrict__ z,
                                   int bn, int ldy, int ldz,
                                   const int* __restrict__ pred, int when) {
  if (pred != nullptr && *pred != when) return;
  __shared__ float as[B * B];
  const int run = blockIdx.x;
  const int s = run_starts[run];
  const int e = run_starts[run + 1];
  if (s >= e) return;  // a padding run slot
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = col < bn;
  const int64_t zr0 = (int64_t)out_rows[s] * B;
  const int64_t zc = (int64_t)out_cols[s] * bn + col;

  float acc[B];
#pragma unroll
  for (int r = 0; r < B; ++r)
    acc[r] = active ? z[(zr0 + r) * ldz + zc] : 0.0f;
  walk_run<B>(a_blocks, y, a_ids, y_rows, first, s, e, zc, ldy, active, as,
              acc);
  if (active) {
#pragma unroll
    for (int r = 0; r < B; ++r) z[(zr0 + r) * ldz + zc] = acc[r];
  }
}

template <int B>
__global__ void spdmm_kernel(const float* __restrict__ blocks,
                             const float* __restrict__ y,
                             const int* __restrict__ row_ids,
                             const int* __restrict__ col_ids,
                             const int* __restrict__ first,
                             const int* __restrict__ run_starts,
                             float* __restrict__ z, int n) {
  __shared__ float as[B * B];
  const int run = blockIdx.x;
  const int s = run_starts[run];
  const int e = run_starts[run + 1];
  if (s >= e) return;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = col < n;
  const int64_t zr0 = (int64_t)row_ids[s] * B;

  float acc[B];
#pragma unroll
  for (int r = 0; r < B; ++r)
    acc[r] = active ? z[(zr0 + r) * n + col] : 0.0f;
  walk_run<B>(blocks, y, nullptr, col_ids, first, s, e, col, n, active, as,
              acc);
  if (active) {
#pragma unroll
    for (int r = 0; r < B; ++r) z[(zr0 + r) * n + col] = acc[r];
  }
}

int threads_for(int width) {
  return width >= 128 ? 128 : ((width + 31) / 32) * 32;
}

template <int B>
int launch_fused(const void* a_blocks, const void* y, const void* a_ids,
                 const void* y_rows, const void* out_rows,
                 const void* out_cols, const void* first,
                 const void* run_starts, int n_runs, void* z, int bn, int ldy,
                 int ldz, const void* pred, int when, cudaStream_t stream) {
  const int threads = threads_for(bn);
  dim3 grid(n_runs, (bn + threads - 1) / threads);
  spdmm_fused_kernel<B><<<grid, threads, 0, stream>>>(
      (const float*)a_blocks, (const float*)y, (const int*)a_ids,
      (const int*)y_rows, (const int*)out_rows, (const int*)out_cols,
      (const int*)first, (const int*)run_starts, (float*)z, bn, ldy, ldz,
      (const int*)pred, when);
  return (int)cudaGetLastError();
}

template <int B>
int launch_single(const void* blocks, const void* y, const void* row_ids,
                  const void* col_ids, const void* first,
                  const void* run_starts, int n_runs, void* z, int n,
                  cudaStream_t stream) {
  const int threads = threads_for(n);
  dim3 grid(n_runs, (n + threads - 1) / threads);
  spdmm_kernel<B><<<grid, threads, 0, stream>>>(
      (const float*)blocks, (const float*)y, (const int*)row_ids,
      (const int*)col_ids, (const int*)first, (const int*)run_starts,
      (float*)z, n);
  return (int)cudaGetLastError();
}

}  // namespace

#define SPDMM_BLOCK_SWITCH(CALL)   \
  switch (block) {                 \
    case 1: return CALL(1);        \
    case 2: return CALL(2);        \
    case 4: return CALL(4);        \
    case 8: return CALL(8);        \
    case 16: return CALL(16);      \
    case 32: return CALL(32);      \
    default: return (int)cudaErrorInvalidValue; \
  }

// a_blocks (P, B, B), y (Kp, ldy), z (m_pad, ldz): f32 row-major contiguous.
// Descriptors int32; run_starts (n_runs + 1,) closes with the entry count
// (padding run slots repeat it).  pred: int32 device flag or null.
extern "C" int spdmm_fused_f32(const void* a_blocks, const void* y,
                               const void* a_ids, const void* y_rows,
                               const void* out_rows, const void* out_cols,
                               const void* first, const void* run_starts,
                               int n_runs, void* z, int block, int bn,
                               int ldy, int ldz, const void* pred, int when,
                               void* stream) {
  if (n_runs == 0 || bn == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define FUSED(BB)                                                         \
  launch_fused<BB>(a_blocks, y, a_ids, y_rows, out_rows, out_cols, first, \
                   run_starts, n_runs, z, bn, ldy, ldz, pred, when, st)
  SPDMM_BLOCK_SWITCH(FUSED)
#undef FUSED
}

// blocks (nnzb, B, B), y (Kp, n), z (m_pad, n): f32 row-major contiguous.
// row_ids / col_ids / first int32 (nnzb,); run_starts (n_runs + 1,) are the
// block-row runs (padding slots repeat the closing count).
extern "C" int spdmm_f32(const void* blocks, const void* y,
                         const void* row_ids, const void* col_ids,
                         const void* first, const void* run_starts,
                         int n_runs, void* z, int block, int n,
                         void* stream) {
  if (n_runs == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define SINGLE(BB)                                                          \
  launch_single<BB>(blocks, y, row_ids, col_ids, first, run_starts, n_runs, \
                    z, n, st)
  SPDMM_BLOCK_SWITCH(SINGLE)
#undef SINGLE
}
