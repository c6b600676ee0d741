// Batched tile GEMM scattered in place into a canvas.
//
// Replaces the Pallas kernel `repro/kernels/gemm.py::gemm_batch_scatter`
// (grid (T, K/bk), f32 VMEM accumulator, output index map (rows[t], cols[t])
// on a canvas aliased to the output).  Task t OVERWRITES canvas tile
// (rows[t], cols[t]) -- rows [rows[t]*m, +m), cols [cols[t]*n, +n) -- with
// x[t] @ y[t] summed in f32; every other canvas element is left as it is.
//
// What bounds it on an H100: at the Dense Task Queue shapes of a GCN layer
// (x (8, 11264, 512), y (8, 512, 128)) the product does ~2*m*n*k*T = 1.2e10
// FLOP over ~185 MB of x, so it is compute bound on the FP32 CUDA cores
// (67 TFLOP/s); with n = 8 (the logits layer) it is bound by reading x.
// Design: a plain shared-memory tiled SGEMM.  One 256-thread block per
// (64 x 64) output tile per task; K is walked in chunks of 16 staged in
// shared memory (x tile stored transposed, padded against bank conflicts);
// each thread keeps a 4 x 4 register accumulator over rows ty+16i and
// cols tx+16j so shared-memory reads of y are consecutive across a warp and
// reads of x are broadcasts.  The K, M and N tails are masked in the kernel,
// so any shapes are taken.  FP32 FMA, no tensor cores (TF32 would change
// the numbers); no atomics -- every output element has one writer, so the
// result is deterministic.  Faster variants (wgmma on TF32/bf16 opt-in,
// TMA pipelines) are later work.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
gemm_batch_scatter_kernel(const float* __restrict__ x,
                          const float* __restrict__ y,
                          const int* __restrict__ rows,
                          const int* __restrict__ cols,
                          float* __restrict__ z,
                          int m, int k, int n, int ldz) {
  __shared__ float xs[TK][TM + 1];
  __shared__ float ys[TK][TN];

  const int t = blockIdx.z;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * TN;
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const float* xt = x + (int64_t)t * m * k;
  const float* yt = y + (int64_t)t * k * n;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += TK) {
    // x tile (TM x TK), coalesced along k, stored transposed
#pragma unroll
    for (int l = tid; l < TM * TK; l += THREADS) {
      const int r = l / TK, kk = l % TK;
      const int gr = row0 + r, gk = k0 + kk;
      xs[kk][r] = (gr < m && gk < k) ? xt[(int64_t)gr * k + gk] : 0.0f;
    }
    // y tile (TK x TN), coalesced along n
#pragma unroll
    for (int l = tid; l < TK * TN; l += THREADS) {
      const int kk = l / TN, c = l % TN;
      const int gk = k0 + kk, gc = col0 + c;
      ys[kk][c] = (gk < k && gc < n) ? yt[(int64_t)gk * n + gc] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ys[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: overwrite the task's canvas tile
  const int64_t zr0 = (int64_t)rows[t] * m;
  const int64_t zc0 = (int64_t)cols[t] * n;
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

}  // namespace

// z[rows[t]*m:+m, cols[t]*n:+n] = x[t] @ y[t] for t < T.  x (T, m, k),
// y (T, k, n), z (mz, ldz), all f32 row-major contiguous; rows/cols int32.
extern "C" int gemm_batch_scatter_f32(const void* x, const void* y,
                                      const void* rows, const void* cols,
                                      void* z, int T, int m, int k, int n,
                                      int mz, int ldz, void* stream) {
  (void)mz;
  if (T == 0 || m == 0 || n == 0) return 0;
  dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN, T);
  gemm_batch_scatter_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)x, (const float*)y, (const int*)rows, (const int*)cols,
      (float*)z, m, k, n, ldz);
  return (int)cudaGetLastError();
}
