// Register-blocked FP32 tile product of the dense GEMM kernels `gemm`,
// `gemm_batch` and `gemm_batch_scatter` (gemm.cu): one output tile of
// x @ y, x (m, k) and y (k, n) row-major contiguous, float32 or bfloat16
// inputs widened to float32 in registers (exact), a float32 accumulator,
// stored from an output origin with a row stride (a dense output, or a
// tile of the scatter's canvas: DenseOut below, CanvasOut in gemm.cu).
//
// Replaces, with gemm.cu, the Pallas kernels `src/repro/kernels/gemm.py:40`
// (`gemm`), `src/repro/kernels/gemm.py:94` (`gemm_batch_scatter`) and
// `src/repro/kernels/gemm.py:165` (`gemm_batch`).
//
// What bounds the shapes on the path (H100 SXM: 67 TFLOP/s FP32 outside
// the tensor cores, 3.35 TB/s HBM3):
//   - n = 128 (GCN-FL's layer-1 update, x 89,250 x 500; the dense queue's
//     8 x 11264 x 500 batch): 1.1e10 FLOP over ~225 MB, bound by the FP32
//     rate (~0.17 ms).  Each thread keeps 8 x 8 outputs in registers, so a
//     step of k is 4 vector shared loads (LDS.128) for 64 fmaf.
//   - n <= 16 (GCN-FL's logits layer, x 89,250 x 128 by 128 x 7): 1.6e8
//     FLOP over 48 MB of x, bound by reading x once (~0.014 ms).  One tile
//     spans every column, so each x element is read from device memory
//     once and used for all n columns.
//
// Tiles, picked at launch from n (gemm.cu):
//   Wide<128, 16>  128 x 128 tile, K in chunks of 16, 256 threads of 8 x 8
//                  outputs (n > 64), two thread blocks an SM (<= 128
//                  registers);
//   Wide<64>       128 x 64 tile, chunks of 8, 256 threads of 8 x 4
//                  outputs (16 < n <= 64), three thread blocks an SM;
//   Narrow<NP>     NP = 8 or 16 columns (every column of n <= 16 in one
//                  tile), chunks of 64, 128 threads of 4 columns each:
//                  64 or 32 rows a tile.
// A wide thread's rows and columns are two groups of four consecutive ones
// (ty*4 and 64 + ty*4; tx*4 and 64 + tx*4), so each fragment is two
// 16-byte shared loads; a warp spans 4 row groups and 8 column groups,
// so its loads are broadcasts or consecutive 16-byte words, free of bank
// conflicts.  x is stored k-major in shared memory (transposed on the
// way in; rows padded by 4 words, so the transposing stores of a warp hit
// 32 distinct banks at chunks of 8 and two ways at 16); y is stored
// row-major.  A step of k runs its 64 fmafs column by column.  The narrow
// tile keeps x row-major (a thread reads its row 16 bytes at a time; rows
// padded to 68 words, so eight consecutive rows fill the 32 banks) and
// reads its four columns of a y row as one 16-byte load.
//
// Chunks of 16, the column-by-column fmaf order and four columns a narrow
// thread were each kept because they ran faster on the card
// (scripts/gemm_tile_ablation.py, PERF.md section 6): the schedule ptxas
// makes of the wide loop moves its time by up to 15 %.  The narrow tiles'
// chunks of 64 halve the round trips to memory of a long K: a narrow call
// with few rows (compiled GIN-CO's scatter, 12 blocks walking K = 2708)
// is a chain of such round trips with one warp on each SM scheduler, and
// ran 13-14 % faster than with chunks of 32, GCN-FL's logits call 10 %.
//
// Pipeline: two shared-memory stages.  While the threads multiply chunk c
// out of one stage, their global loads of chunk c + 1 (16 bytes of f32, 8
// of bf16, per load) are in flight into registers; after the fmafs they
// are stored into the other stage, and one barrier per chunk separates
// the two.  Staging through registers serves both operand types and the
// transposition of x (cp.async copies bytes and can neither widen bf16
// nor transpose).
//
// Vector loads need k % 4 == 0 and base pointers aligned to four
// elements (and n % 4 == 0 for y in the wide tiles); otherwise the launch
// takes the VEC = false instantiation, which loads one element at a time
// into the same shared-memory layout.  The M, N and K tails are masked to
// zero in both operands: a masked product is 0 * 0, never 0 * (an Inf or
// NaN past the end).  Offsets are 64-bit.
//
// Order invariant.  Every output element is
//   acc = +0.0f; for kk in 0 .. k-1: acc = fmaf(x[r][kk], y[kk][c], acc)
// in increasing kk, in every tile and both pipeline variants: the chunks
// are walked in order and the fmafs of a chunk in increasing kk.  It is,
// with zero terms left out, the order of the sparse kernels too, which is
// what keeps the port's routes bitwise equal on the card.  A zero term
// (masked tail) leaves a sum that started from +0 unchanged.  So: no
// split-K, no partial sums across threads, no tensor cores (TF32 rounds
// the operands), no atomics; FP32 FMA on the CUDA cores.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace sgemm_sm90 {

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void narrow(float* p, float v) { *p = v; }
__device__ __forceinline__ void narrow(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);  // round to nearest even, as torch's .to()
}

// Four consecutive elements in one load (16 B of f32, 8 B of bf16),
// widened; p is aligned to four elements.
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  // a bf16 is the high half of its f32: element 0 is the low half-word
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

__device__ __forceinline__ float4 ld_shared4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Predicated launch: a kernel given `pred` runs only where *pred == when
// (the compiled activation route's overflow flag, read on the device).
__device__ __forceinline__ bool skipped(const int* pred, int when) {
  return pred != nullptr && *pred != when;
}

// Where a tile is stored: out.origin() is element (0, 0) of the output,
// whose rows are out.ld elements apart.  The tiles call origin() only
// after the product, so an output whose origin is read from memory (the
// scatter's canvas, gemm.cu) holds no pointer across the K loop.
template <typename T>
struct DenseOut {
  T* z;
  int64_t ld;
  __device__ __forceinline__ T* origin() const { return z; }
};

// ---------------------------------------------------------------- wide
template <int BN_, int BK_ = 8>
struct Wide {
  static constexpr int BM = 128, BN = BN_, BK = BK_, THREADS = 256;
  static constexpr int MIN_BLOCKS = BN_ == 128 ? 2 : 3;
  static constexpr int CB = BN / 64;                // column groups: 2 or 1
  static constexpr int XS = BM * BK / THREADS;      // x elements a thread
  static constexpr int XV = XS / 4;                 // x vectors a thread
  static constexpr int YS = BK * BN / THREADS;      // y elements a thread
  static constexpr int YV = (BK * BN / 4 + THREADS - 1) / THREADS;
  static constexpr int YR = 4 * YV > YS ? 4 * YV : YS;
  static_assert(XV * 4 * THREADS == BM * BK, "whole x vectors a thread");
  static_assert(BN == 64 || BN == 128, "tile width");

  struct Smem {
    float xs[2][BK][BM + 4];  // k-major
    float ys[2][BK][BN];
  };

  // Chunk at k0 into registers (rows / columns past the ends are zero).
  template <bool VEC, typename T>
  __device__ static __forceinline__ void fetch(
      const T* __restrict__ x, const T* __restrict__ y, int m, int k, int n,
      int row0, int col0, int k0, float (&xr)[XS], float (&yr)[YR]) {
    const int tid = threadIdx.x;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        const int l = tid + THREADS * i;
        const int gr = row0 + l / (BK / 4), gk = k0 + l % (BK / 4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < m && gk < k) v = load4(x + (int64_t)gr * k + gk);
        xr[4 * i] = v.x; xr[4 * i + 1] = v.y;
        xr[4 * i + 2] = v.z; xr[4 * i + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < YV; ++i) {
        const int l = tid + THREADS * i;
        float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
        if (l < BK * BN / 4) {
          const int gk = k0 + l / (BN / 4), gc = col0 + l % (BN / 4) * 4;
          if (gk < k && gc < n) w = load4(y + (int64_t)gk * n + gc);
        }
        yr[4 * i] = w.x; yr[4 * i + 1] = w.y;
        yr[4 * i + 2] = w.z; yr[4 * i + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < XS; ++i) {
        const int l = tid + THREADS * i;
        const int gr = row0 + l / BK, gk = k0 + l % BK;
        xr[i] = (gr < m && gk < k) ? widen(x[(int64_t)gr * k + gk]) : 0.f;
      }
#pragma unroll
      for (int i = 0; i < YS; ++i) {
        const int l = tid + THREADS * i;
        const int gk = k0 + l / BN, gc = col0 + l % BN;
        yr[i] = (gk < k && gc < n) ? widen(y[(int64_t)gk * n + gc]) : 0.f;
      }
    }
  }

  // Registers into stage st: x transposed, y as it is.
  template <bool VEC>
  __device__ static __forceinline__ void stash(Smem& s, int st,
                                               const float (&xr)[XS],
                                               const float (&yr)[YR]) {
    const int tid = threadIdx.x;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < XV; ++i) {
        const int l = tid + THREADS * i;
        const int r = l / (BK / 4), kq = l % (BK / 4) * 4;
#pragma unroll
        for (int q = 0; q < 4; ++q) s.xs[st][kq + q][r] = xr[4 * i + q];
      }
#pragma unroll
      for (int i = 0; i < YV; ++i) {
        const int l = tid + THREADS * i;
        if (l < BK * BN / 4)
          *reinterpret_cast<float4*>(
              &s.ys[st][l / (BN / 4)][l % (BN / 4) * 4]) =
              make_float4(yr[4 * i], yr[4 * i + 1], yr[4 * i + 2],
                          yr[4 * i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < XS; ++i) {
        const int l = tid + THREADS * i;
        s.xs[st][l % BK][l / BK] = xr[i];
      }
#pragma unroll
      for (int i = 0; i < YS; ++i) {
        const int l = tid + THREADS * i;
        s.ys[st][l / BN][l % BN] = yr[i];
      }
    }
  }

  // acc[i][j] += x[row i] * y[col j] over the chunk in stage st, kk
  // increasing.
  __device__ static __forceinline__ void multiply(const Smem& s, int st,
                                                  int ty, int tx,
                                                  float (&acc)[8][4 * CB]) {
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[8], b[4 * CB];
      const float4 a0 = ld_shared4(&s.xs[st][kk][ty * 4]);
      const float4 a1 = ld_shared4(&s.xs[st][kk][64 + ty * 4]);
      a[0] = a0.x; a[1] = a0.y; a[2] = a0.z; a[3] = a0.w;
      a[4] = a1.x; a[5] = a1.y; a[6] = a1.z; a[7] = a1.w;
#pragma unroll
      for (int cb = 0; cb < CB; ++cb) {
        const float4 v = ld_shared4(&s.ys[st][kk][64 * cb + tx * 4]);
        b[4 * cb] = v.x; b[4 * cb + 1] = v.y;
        b[4 * cb + 2] = v.z; b[4 * cb + 3] = v.w;
      }
#pragma unroll
      for (int j = 0; j < 4 * CB; ++j)
#pragma unroll
        for (int i = 0; i < 8; ++i) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }

  // out[row0 :+BM, col0 :+BN] = x[row0 :+BM, :] @ y[:, col0 :+BN].
  template <bool VEC, typename TIn, class Out>
  __device__ static __forceinline__ void tile(
      const TIn* __restrict__ x, const TIn* __restrict__ y, const Out& out,
      int m, int k, int n, int row0, int col0, Smem& s) {
    const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
    const int ty = warp / 2 * 4 + lane / 8;  // 0..15: rows ty*4, 64+ty*4
    const int tx = warp % 2 * 8 + lane % 8;  // 0..15: cols tx*4 (+64)
    float acc[8][4 * CB];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4 * CB; ++j) acc[i][j] = 0.0f;
    float xr[XS], yr[YR];
    const int chunks = (k + BK - 1) / BK;
    fetch<VEC>(x, y, m, k, n, row0, col0, 0, xr, yr);
    stash<VEC>(s, 0, xr, yr);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      const bool more = c + 1 < chunks;
      if (more) fetch<VEC>(x, y, m, k, n, row0, col0, (c + 1) * BK, xr, yr);
      multiply(s, c & 1, ty, tx, acc);
      if (more) stash<VEC>(s, (c + 1) & 1, xr, yr);
      __syncthreads();
    }
    auto* z = out.origin();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = row0 + (i < 4 ? ty * 4 + i : 64 + ty * 4 + i - 4);
      if (r >= m) continue;
#pragma unroll
      for (int j = 0; j < 4 * CB; ++j) {
        const int c = col0 + 64 * (j / 4) + tx * 4 + j % 4;
        if (c < n) narrow(&z[r * out.ld + c], acc[i][j]);
      }
    }
  }
};

// -------------------------------------------------------------- narrow
// NP columns (the whole of n <= NP) over 128 threads: CG threads share a
// row, each owning NP / CG consecutive columns, so a tile is 128 / CG rows.
template <int NP, int CG = NP / 4>
struct Narrow {
  static constexpr int THREADS = 128, BM = THREADS / CG, BN = NP, BK = 64;
  static constexpr int MIN_BLOCKS = 4;
  static constexpr int CW = NP / CG;            // columns a thread
  static constexpr int XS = BM * BK / THREADS;  // x elements a thread
  static constexpr int YS = BK * BN / THREADS;  // y elements a thread
  static_assert((NP == 8 || NP == 16) && CW % 4 == 0, "narrow tile width");

  struct Smem {
    float xs[2][BM][BK + 4];  // row-major
    float ys[2][BK][BN];
  };

  template <bool VEC, typename T>
  __device__ static __forceinline__ void fetch(
      const T* __restrict__ x, const T* __restrict__ y, int m, int k, int n,
      int row0, int k0, float (&xr)[XS], float (&yr)[YS]) {
    const int tid = threadIdx.x;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < XS / 4; ++i) {
        const int l = tid + THREADS * i;
        const int gr = row0 + l / (BK / 4), gk = k0 + l % (BK / 4) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gr < m && gk < k) v = load4(x + (int64_t)gr * k + gk);
        xr[4 * i] = v.x; xr[4 * i + 1] = v.y;
        xr[4 * i + 2] = v.z; xr[4 * i + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < XS; ++i) {
        const int l = tid + THREADS * i;
        const int gr = row0 + l / BK, gk = k0 + l % BK;
        xr[i] = (gr < m && gk < k) ? widen(x[(int64_t)gr * k + gk]) : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < YS; ++i) {
      const int l = tid + THREADS * i;
      const int gk = k0 + l / BN, c = l % BN;
      yr[i] = (gk < k && c < n) ? widen(y[(int64_t)gk * n + c]) : 0.f;
    }
  }

  template <bool VEC>
  __device__ static __forceinline__ void stash(Smem& s, int st,
                                               const float (&xr)[XS],
                                               const float (&yr)[YS]) {
    const int tid = threadIdx.x;
    if constexpr (VEC) {
#pragma unroll
      for (int i = 0; i < XS / 4; ++i) {
        const int l = tid + THREADS * i;
        *reinterpret_cast<float4*>(&s.xs[st][l / (BK / 4)][l % (BK / 4) * 4]) =
            make_float4(xr[4 * i], xr[4 * i + 1], xr[4 * i + 2],
                        xr[4 * i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < XS; ++i) {
        const int l = tid + THREADS * i;
        s.xs[st][l / BK][l % BK] = xr[i];
      }
    }
#pragma unroll
    for (int i = 0; i < YS; ++i) {
      const int l = tid + THREADS * i;
      s.ys[st][l / BN][l % BN] = yr[i];
    }
  }

  // acc[j] += x[row] * y[col c0 + j] over the chunk in stage st, kk
  // increasing.
  __device__ static __forceinline__ void multiply(const Smem& s, int st,
                                                  float (&acc)[CW]) {
    const int r = threadIdx.x / CG, c0 = threadIdx.x % CG * CW;
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      const float4 v = ld_shared4(&s.xs[st][r][kq]);
      const float a[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int cb = 0; cb < CW / 4; ++cb) {
          const float4 b = ld_shared4(&s.ys[st][kq + q][c0 + 4 * cb]);
          acc[4 * cb] = fmaf(a[q], b.x, acc[4 * cb]);
          acc[4 * cb + 1] = fmaf(a[q], b.y, acc[4 * cb + 1]);
          acc[4 * cb + 2] = fmaf(a[q], b.z, acc[4 * cb + 2]);
          acc[4 * cb + 3] = fmaf(a[q], b.w, acc[4 * cb + 3]);
        }
    }
  }

  // out[row0 :+BM, :n] = x[row0 :+BM, :] @ y, for n <= NP (col0 is 0).
  template <bool VEC, typename TIn, class Out>
  __device__ static __forceinline__ void tile(
      const TIn* __restrict__ x, const TIn* __restrict__ y, const Out& out,
      int m, int k, int n, int row0, int col0, Smem& s) {
    (void)col0;
    float acc[CW];
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[j] = 0.0f;
    float xr[XS], yr[YS];
    const int chunks = (k + BK - 1) / BK;
    fetch<VEC>(x, y, m, k, n, row0, 0, xr, yr);
    stash<VEC>(s, 0, xr, yr);
    __syncthreads();
    for (int c = 0; c < chunks; ++c) {
      const bool more = c + 1 < chunks;
      if (more) fetch<VEC>(x, y, m, k, n, row0, (c + 1) * BK, xr, yr);
      multiply(s, c & 1, acc);
      if (more) stash<VEC>(s, (c + 1) & 1, xr, yr);
      __syncthreads();
    }
    const int r = row0 + threadIdx.x / CG, c0 = threadIdx.x % CG * CW;
    if (r >= m) return;
    auto* z = out.origin();
#pragma unroll
    for (int j = 0; j < CW; ++j)
      if (c0 + j < n) narrow(&z[r * out.ld + c0 + j], acc[j]);
  }
};

}  // namespace sgemm_sm90
