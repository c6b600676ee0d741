// Fused multi-task SpDMM (block-sparse pool x dense) on an in-place canvas.
//
// Replaces the Pallas kernel `repro/kernels/spdmm.py::spdmm_fused`
// (`_spdmm_fused_kernel` / `_spdmm_fused_inplace_kernel`: grid (n_entries,),
// scalar-prefetched entry arrays, output block (out_rows[t], out_cols[t])
// resident in VMEM across a consecutive run).  For each entry t in order:
//   Z[orow*B:+B, ocol*bn:+bn]  (zeroed if first[t])
//       += A_pool[a_ids[t]] @ Y[y_rows[t]*B:+B, ocol*bn:+bn]
// Output blocks no entry covers keep their canvas content.
//
// What bounds it on an H100: a GCN aggregation over the Flickr stand-in has
// ~0.9M stored 8x8 blocks (231 MB) and gathers one 8 x bn slice of Y per
// entry (4 KB at bn = 128, mostly L2 hits), i.e. 2*64*bn FLOP per entry --
// ~1.5e10 FLOP at bn = 128.  The FP32 CUDA-core rate bounds the arithmetic
// (~0.2 ms); the block pool and descriptors bound the bytes.
// Design: the TPU walks the entry list sequentially; here one thread block
// owns one output-block RUN (a maximal stretch of entries with one
// (out_row, out_col) key, found from key changes by the wrapper) times a
// chunk of up to 128 columns, so runs proceed in parallel on all SMs while
// each run is still walked in entry order.  Per entry the 8x8 A block is
// staged in shared memory; each thread owns one column and keeps the B
// accumulators of that column in registers, reading its Y values coalesced
// across the warp.  The accumulator starts from the canvas content (the
// aliasing semantics), a `first` flag zeroes it -- also mid-run -- and it
// is stored once at the end.  No atomics, so results are bitwise
// reproducible; 64-bit addressing throughout (pools at Reddit scale pass
// 2^31 elements).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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
                                   int bn, int ldy, int ldz) {
  __shared__ float as[B * B];
  const int run = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + threadIdx.x;
  const bool active = col < bn;
  const int s = run_starts[run];
  const int e = run_starts[run + 1];
  const int64_t zr0 = (int64_t)out_rows[s] * B;
  const int64_t zc = (int64_t)out_cols[s] * bn + col;

  float acc[B];
#pragma unroll
  for (int r = 0; r < B; ++r)
    acc[r] = active ? z[(zr0 + r) * ldz + zc] : 0.0f;

  for (int t = s; t < e; ++t) {
    const int64_t a0 = (int64_t)a_ids[t] * (B * B);
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
        const float yv = y[(y0 + kk) * ldy + zc];
#pragma unroll
        for (int r = 0; r < B; ++r) acc[r] = fmaf(as[r * B + kk], yv, acc[r]);
      }
    }
  }
  if (active) {
#pragma unroll
    for (int r = 0; r < B; ++r) z[(zr0 + r) * ldz + zc] = acc[r];
  }
}

template <int B>
int launch(const void* a_blocks, const void* y, const void* a_ids,
           const void* y_rows, const void* out_rows, const void* out_cols,
           const void* first, const void* run_starts, int n_runs, void* z,
           int bn, int ldy, int ldz, cudaStream_t stream) {
  const int threads = bn >= 128 ? 128 : ((bn + 31) / 32) * 32;
  dim3 grid(n_runs, (bn + threads - 1) / threads);
  spdmm_fused_kernel<B><<<grid, threads, 0, stream>>>(
      (const float*)a_blocks, (const float*)y, (const int*)a_ids,
      (const int*)y_rows, (const int*)out_rows, (const int*)out_cols,
      (const int*)first, (const int*)run_starts, (float*)z, bn, ldy, ldz);
  return (int)cudaGetLastError();
}

}  // namespace

// a_blocks (P, B, B), y (Kp, ldy), z (m_pad, ldz): f32 row-major contiguous.
// Descriptors int32; run_starts (n_runs + 1,) closes with the entry count.
extern "C" int spdmm_fused_f32(const void* a_blocks, const void* y,
                               const void* a_ids, const void* y_rows,
                               const void* out_rows, const void* out_cols,
                               const void* first, const void* run_starts,
                               int n_runs, void* z, int block, int bn,
                               int ldy, int ldz, void* stream) {
  if (n_runs == 0 || bn == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
#define SPDMM_CASE(BB)                                                        \
  case BB:                                                                    \
    return launch<BB>(a_blocks, y, a_ids, y_rows, out_rows, out_cols, first, \
                      run_starts, n_runs, z, bn, ldy, ldz, st);
  switch (block) {
    SPDMM_CASE(1)
    SPDMM_CASE(2)
    SPDMM_CASE(4)
    SPDMM_CASE(8)
    SPDMM_CASE(16)
    SPDMM_CASE(32)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef SPDMM_CASE
}
