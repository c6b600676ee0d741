// Tile product of the batched scatter kernel (gemm_batch_scatter.cu) only:
// one 256-thread block computes a 64 x 64 output tile of x @ y in f32.
// `gemm` and `gemm_batch` run the register-blocked tiles of sgemm_sm90.cuh;
// this loop serves gemm_batch_scatter until it moves onto them too.
//
// K is walked in chunks of 16 staged in shared memory (the x tile stored
// transposed, padded against bank conflicts); each thread keeps a 4 x 4
// register accumulator over rows ty+16i and cols tx+16j, so shared-memory
// reads of y are consecutive across a warp and reads of x are broadcasts.
// Every accumulator sums its products with fmaf in increasing k, starting
// from 0 -- the same per-element order as sgemm_sm90.cuh and the fused
// sparse kernels, which is what makes the port's routes (per-task gemm,
// batched gemm_batch_scatter, compiled gemm) bitwise equal on the card.  The M, N and K tails are masked to zero, and a zero
// product leaves the sum unchanged, so padding never changes a result.
// FP32 FMA on the CUDA cores, no tensor cores (TF32 would change the
// numbers), no atomics.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tile_gemm {

constexpr int TM = 64;
constexpr int TN = 64;
constexpr int TK = 16;
constexpr int THREADS = 256;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

struct Smem {
  float xs[TK][TM + 1];
  float ys[TK][TN];
};

// acc[i][j] (zeroed here) = sum over kk < k, in increasing kk, of
// x[row0 + ty + 16i, kk] * y[kk, col0 + tx + 16j]; x is (m, k) with row
// stride ldx, y (k, n) with row stride ldy.  Called by all THREADS threads.
template <typename T>
__device__ __forceinline__ void product(const T* __restrict__ x, int64_t ldx,
                                        const T* __restrict__ y, int64_t ldy,
                                        int m, int k, int n, int row0,
                                        int col0, Smem& s,
                                        float (&acc)[4][4]) {
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < k; k0 += TK) {
    // x tile (TM x TK), coalesced along k, stored transposed
    for (int l = tid; l < TM * TK; l += THREADS) {
      const int r = l / TK, kk = l % TK;
      const int gr = row0 + r, gk = k0 + kk;
      s.xs[kk][r] = (gr < m && gk < k) ? widen(x[gr * ldx + gk]) : 0.0f;
    }
    // y tile (TK x TN), coalesced along n
    for (int l = tid; l < TK * TN; l += THREADS) {
      const int kk = l / TN, c = l % TN;
      const int gk = k0 + kk, gc = col0 + c;
      s.ys[kk][c] = (gk < k && gc < n) ? widen(y[gk * ldy + gc]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < TK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = s.xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = s.ys[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// Predicated launch: a kernel given `pred` runs only where *pred == when
// (the compiled activation route's overflow flag, read on the device).
__device__ __forceinline__ bool skipped(const int* pred, int when) {
  return pred != nullptr && *pred != when;
}

}  // namespace tile_gemm
