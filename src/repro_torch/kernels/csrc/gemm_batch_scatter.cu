// Batched tile GEMMs scattered in place into a canvas.
//
// gemm_batch_scatter replaces the Pallas kernel
// `repro/kernels/gemm.py::gemm_batch_scatter` (grid (T, K/bk), f32 VMEM
// accumulator, output index map (rows[t], cols[t]) on a canvas aliased to
// the output).  Task t OVERWRITES canvas tile (rows[t], cols[t]) -- rows
// [rows[t]*m, +m), cols [cols[t]*n, +n) -- with x[t] @ y[t] summed in f32;
// every other canvas element is left as it is.
//
// What bounds it on an H100: at the Dense Task Queue shapes of a GCN
// layer (x (8, 11264, 500), y (8, 500, 128)) the product does
// ~2*m*n*k*T = 1.2e10 FLOP over ~180 MB of x, so it is compute bound on the
// FP32 CUDA cores (67 TFLOP/s); with n = 8 (the logits layer) it is bound
// by reading x.
// Design: a plain shared-memory tiled SGEMM (gemm_tile.cuh), one 256-thread
// block per (64 x 64) output tile per task, M/N/K tails masked in the
// kernel.  The per-element summation order is that of gemm.cu's
// register-blocked tiles (sgemm_sm90.cuh), so a task's tile equals the
// dense kernel's result on the same rows bit for bit.  FP32 FMA, no tensor
// cores (TF32 would change the numbers); no atomics -- every output element
// has one writer, so the result is deterministic.  Moving it onto the
// register-blocked tile of sgemm_sm90.cuh is the next step.
// `pred` (not null) predicates the scatter on *pred == when: the compiled
// activation route skips it when the batch overflowed its block budget.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

using namespace tile_gemm;

// Writes task t's tile to z at row offset zr0, col offset zc0, stride ldz.
__device__ __forceinline__ void store_tile(float* __restrict__ z, int64_t zr0,
                                           int64_t zc0, int64_t ldz,
                                           int row0, int col0, int m, int n,
                                           const float (&acc)[4][4]) {
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < n) z[(zr0 + r) * ldz + zc0 + c] = acc[i][j];
    }
  }
}

__global__ void __launch_bounds__(THREADS)
gemm_batch_scatter_kernel(const float* __restrict__ x,
                          const float* __restrict__ y,
                          const int* __restrict__ rows,
                          const int* __restrict__ cols,
                          float* __restrict__ z,
                          int m, int k, int n, int ldz,
                          const int* __restrict__ pred, int when) {
  if (skipped(pred, when)) return;
  __shared__ Smem s;
  const int t = blockIdx.z;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * TN;
  float acc[4][4];
  product(x + (int64_t)t * m * k, k, y + (int64_t)t * k * n, n, m, k, n,
          row0, col0, s, acc);
  store_tile(z, (int64_t)rows[t] * m, (int64_t)cols[t] * n, ldz, row0, col0,
             m, n, acc);
}

}  // namespace

// z[rows[t]*m:+m, cols[t]*n:+n] = x[t] @ y[t] for t < T.  x (T, m, k),
// y (T, k, n), z (mz, ldz), all f32 row-major contiguous; rows/cols int32;
// pred an int32 device flag or null.
extern "C" int gemm_batch_scatter_f32(const void* x, const void* y,
                                      const void* rows, const void* cols,
                                      void* z, int T, int m, int k, int n,
                                      int mz, int ldz, const void* pred,
                                      int when, void* stream) {
  (void)mz;
  if (T == 0 || m == 0 || n == 0) return 0;
  dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN, T);
  gemm_batch_scatter_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const int*)rows, (const int*)cols,
      (float*)z, m, k, n, ldz, (const int*)pred, when);
  return (int)cudaGetLastError();
}
