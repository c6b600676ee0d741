// Fused multi-task SpMM (block-sparse x block-sparse pools) on an in-place
// canvas.
//
// Replaces the Pallas kernel `repro/kernels/spmm.py::_spmm_call`
// (`_spmm_kernel` / `_spmm_inplace_kernel`, reached by `spmm_fused`): grid
// (n_triples,), one B x B output block resident across a consecutive run.
// For each triple t in order:
//   Z[orow*B:+B, ocol*B:+B]  (zeroed if first[t])
//       += A_pool[a_ids[t]] @ Y_pool[y_ids[t]]
// Sentinel zero blocks back the padding triples; output blocks no triple
// covers keep their canvas content.
//
// What bounds it on an H100: a GIN aggregation of the Cora stand-in's raw
// features walks ~1.9M triples of 2*8*8*8 = 1024 FLOP each (~2e9 FLOP, far
// below the FP32 rate) reading two 256-byte blocks per triple, so in
// principle it is bound by the block reads; in practice it is bound by the
// latency of the dependent per-triple loop in each run.
// Design: one warp per output-block run (runs are found by the wrapper from
// key changes), four runs per 128-thread block, walked in triple order.
// Per triple the warp stages the A and Y blocks in its own slice of shared
// memory (__syncwarp only, no block barrier), and each lane owns
// ceil(B*B/32) output elements with register accumulators that start from
// the canvas content, are zeroed by `first` (also mid-run) and are stored
// once at the end.  No atomics, so results are bitwise reproducible; 64-bit
// addressing throughout.
//
// Run offsets may be padded: a run whose offsets are equal holds no triple
// and its warp returns at once (the compiled activation route launches one
// slot per triple, since its runs are found on the device at run time).
// `pred` (not null) predicates the launch on *pred == when (the route's
// overflow flag).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;

template <int B>
__global__ void __launch_bounds__(WARPS * 32)
spmm_fused_kernel(const float* __restrict__ a_blocks,
                  const float* __restrict__ y_blocks,
                  const int* __restrict__ a_ids,
                  const int* __restrict__ y_ids,
                  const int* __restrict__ out_rows,
                  const int* __restrict__ out_cols,
                  const int* __restrict__ first,
                  const int* __restrict__ run_starts,
                  int n_runs, float* __restrict__ z, int ldz,
                  const int* __restrict__ pred, int when) {
  if (pred != nullptr && *pred != when) return;
  constexpr int BB = B * B;
  constexpr int NE = (BB + 31) / 32;
  __shared__ float sa[WARPS][BB];
  __shared__ float sy[WARPS][BB];
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int run = blockIdx.x * WARPS + warp;
  if (run >= n_runs) return;  // whole warp leaves together
  const int s = run_starts[run];
  const int e = run_starts[run + 1];
  if (s >= e) return;  // a padding run slot: the whole warp leaves
  const int64_t zr0 = (int64_t)out_rows[s] * B;
  const int64_t zc0 = (int64_t)out_cols[s] * B;
  float* wa = sa[warp];
  float* wy = sy[warp];

  float acc[NE];
#pragma unroll
  for (int q = 0; q < NE; ++q) {
    const int el = lane + 32 * q;
    acc[q] = el < BB ? z[(zr0 + el / B) * ldz + zc0 + el % B] : 0.0f;
  }

  for (int t = s; t < e; ++t) {
    const int64_t a0 = (int64_t)a_ids[t] * BB;
    const int64_t y0 = (int64_t)y_ids[t] * BB;
    __syncwarp();  // the previous triple's blocks are no longer read
    for (int l = lane; l < BB; l += 32) {
      wa[l] = a_blocks[a0 + l];
      wy[l] = y_blocks[y0 + l];
    }
    __syncwarp();
    const bool reset = first[t] != 0;
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      const int el = lane + 32 * q;
      if (el >= BB) continue;
      const int r = el / B, c = el % B;
      float v = reset ? 0.0f : acc[q];
#pragma unroll
      for (int kk = 0; kk < B; ++kk) v = fmaf(wa[r * B + kk], wy[kk * B + c], v);
      acc[q] = v;
    }
  }
#pragma unroll
  for (int q = 0; q < NE; ++q) {
    const int el = lane + 32 * q;
    if (el < BB) z[(zr0 + el / B) * ldz + zc0 + el % B] = acc[q];
  }
}

template <int B>
int launch(const void* a_blocks, const void* y_blocks, const void* a_ids,
           const void* y_ids, const void* out_rows, const void* out_cols,
           const void* first, const void* run_starts, int n_runs, void* z,
           int ldz, const void* pred, int when, cudaStream_t stream) {
  dim3 grid((n_runs + WARPS - 1) / WARPS);
  spmm_fused_kernel<B><<<grid, WARPS * 32, 0, stream>>>(
      (const float*)a_blocks, (const float*)y_blocks, (const int*)a_ids,
      (const int*)y_ids, (const int*)out_rows, (const int*)out_cols,
      (const int*)first, (const int*)run_starts, n_runs, (float*)z, ldz,
      (const int*)pred, when);
  return (int)cudaGetLastError();
}

}  // namespace

// a_blocks (Pa, B, B), y_blocks (Py, B, B), z (m_pad, ldz): f32 row-major
// contiguous.  Descriptors int32; run_starts (n_runs + 1,) (padding slots
// repeat the closing count).  pred: int32 device flag or null.
extern "C" int spmm_fused_f32(const void* a_blocks, const void* y_blocks,
                              const void* a_ids, const void* y_ids,
                              const void* out_rows, const void* out_cols,
                              const void* first, const void* run_starts,
                              int n_runs, void* z, int block, int ldz,
                              const void* pred, int when, void* stream) {
  if (n_runs == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define SPMM_CASE(BB)                                                        \
  case BB:                                                                   \
    return launch<BB>(a_blocks, y_blocks, a_ids, y_ids, out_rows, out_cols, \
                      first, run_starts, n_runs, z, ldz, pred, when, st);
  switch (block) {
    SPMM_CASE(1)
    SPMM_CASE(2)
    SPMM_CASE(4)
    SPMM_CASE(8)
    SPMM_CASE(16)
    SPMM_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPMM_CASE
}
