// Tiled dense GEMM z = x @ y with an f32 accumulator and an out_dtype cast.
//
// Replaces the Pallas kernel `repro/kernels/gemm.py::gemm` (grid
// (M/bm, N/bn, K/bk), the contraction innermost, an f32 VMEM accumulator
// zeroed at k == 0 and cast to out_dtype at the last k step).  Here one
// 256-thread block owns one 64 x 64 output tile and walks all of K itself
// (gemm_tile.cuh), so no accumulator crosses blocks.
//
// What bounds it on an H100: the compiled GCN layer on the Flickr stand-in
// (x 89,250 x 500, y 500 x 128) does 2*M*K*N = 1.14e10 FLOP over ~179 MB
// of x, so it is bound by the FP32 CUDA-core rate (67 TFLOP/s, ~0.17 ms);
// with N = 7 (the logits layer) it is bound by reading x.  The TPU wrapper
// pads x to its block multiples; this kernel masks its own M, N and K
// tails, so the caller makes no padded copy of x.
// Inputs are float32 or bfloat16 (both of one type; bfloat16 is loaded
// natively and widened in registers, which is exact, and a product of two
// bf16 values is exact in f32), the output float32 or bfloat16 (round to
// nearest even).  `pred`, when not null, predicates the whole launch on
// *pred == when: the compiled activation route launches this kernel as its
// dense overflow fallback inside one captured program, and its thread
// blocks return at once when the batch did not overflow.
#include <cuda_runtime.h>
#include <stdint.h>

#include "gemm_tile.cuh"

namespace {

using namespace tile_gemm;

template <typename TIn, typename TOut>
__global__ void __launch_bounds__(THREADS)
gemm_kernel(const TIn* __restrict__ x, const TIn* __restrict__ y,
            TOut* __restrict__ z, int m, int k, int n,
            const int* __restrict__ pred, int when) {
  if (skipped(pred, when)) return;
  __shared__ Smem s;
  const int row0 = blockIdx.x * TM;
  const int col0 = blockIdx.y * TN;
  float acc[4][4];
  product(x, k, y, n, m, k, n, row0, col0, s, acc);
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < n) narrow(&z[(int64_t)r * n + c], acc[i][j]);
    }
  }
}

template <typename TIn, typename TOut>
int launch(const void* x, const void* y, void* z, int m, int k, int n,
           const void* pred, int when, cudaStream_t stream) {
  dim3 grid((m + TM - 1) / TM, (n + TN - 1) / TN);
  gemm_kernel<TIn, TOut><<<grid, THREADS, 0, stream>>>(
      (const TIn*)x, (const TIn*)y, (TOut*)z, m, k, n, (const int*)pred,
      when);
  return (int)cudaGetLastError();
}

}  // namespace

// z (m, n) = x (m, k) @ y (k, n), all row-major contiguous.  in_dtype /
// out_dtype: 0 = float32, 1 = bfloat16.  pred: int32 device flag or null.
extern "C" int gemm_tiled(const void* x, const void* y, void* z, int m, int k,
                          int n, int in_dtype, int out_dtype, const void* pred,
                          int when, void* stream) {
  if (m == 0 || n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  if (in_dtype == 0 && out_dtype == 0)
    return launch<float, float>(x, y, z, m, k, n, pred, when, st);
  if (in_dtype == 0 && out_dtype == 1)
    return launch<float, __nv_bfloat16>(x, y, z, m, k, n, pred, when, st);
  if (in_dtype == 1 && out_dtype == 0)
    return launch<__nv_bfloat16, float>(x, y, z, m, k, n, pred, when, st);
  if (in_dtype == 1 && out_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, y, z, m, k, n, pred, when,
                                                st);
  return (int)cudaErrorInvalidValue;
}
