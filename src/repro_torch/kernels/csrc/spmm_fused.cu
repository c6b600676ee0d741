// Fused multi-task SpMM (block-sparse x block-sparse pools) on an in-place
// canvas: the triple walk behind `spmm_fused` and `spmm`.
//
// Replaces the Pallas kernel `repro/kernels/spmm.py::_spmm_call`
// (`_spmm_kernel` / `_spmm_inplace_kernel`, reached by `spmm_fused` and
// `spmm`): grid (n_triples,), one B x B output block resident across a
// consecutive run.  For each triple t in order:
//   Z[orow*B:+B, ocol*B:+B]  (zeroed if first[t])
//       += A_pool[a_ids[t]] @ Y_pool[y_ids[t]]
// Sentinel zero blocks back the padding triples; output blocks no triple
// covers keep their canvas content.
//
// What bounds it on an H100 (chip_smoke.py; PERF.md section 6).  GIN's
// aggregation over the Cora stand-in walks 1.86M triples in 115k runs of
// ~16 (the dense-Y pairing pairs every stored A block with every logical Y
// block).  A block has ~1.5 non-zero columns of 8 and 44 % of the Y blocks
// are all zero: of the 2.7M (triple, k) pairs with a non-zero A column
// only 265k have a non-zero Y row too, and the function's own work is
// 2.8e5 fmaf.  Its least time is its bytes: the descriptors (37 MB), the
// Y pool (33 MB) and the canvas (38 MB), ~0.03 ms at 3.35 TB/s.
// Multiplying every block in full is 1.9 GFLOP, and reading both blocks of
// every triple ~950 MB from L2; reading A's block for every triple alone
// (477 MB) bounded the first warp walk of this file.  So each pool is read
// once per call by a first launch, which writes the A pool's blocks
// transposed (a column contiguous, 32 B at B = 8), each A block's mask of
// non-zero columns and each Y block's mask of non-zero rows.  The walk then
// fetches 32 B of A and 32 B of Y only for the live (triple, k) pairs.
// What is left is streaming the descriptors and the canvas, and one
// round trip a group for its live items; the resident warps hide part of
// it (PERF.md gives the measured split).
//
// Design.  A warp walks runs (maximal stretches of triples with one
// (out_row, out_col) key, found from key changes, so the kernel takes no
// run offsets).  The grid is sized to the card: warp w takes the runs that
// start in its equal share of the triples and walks each to its end, so a
// launch costs nothing per empty run slot and a long run is one warp's
// work.  No __syncthreads: the warps of a thread block share nothing.
// Lane l owns output elements l + 32q (q < ceil(B*B/32)), all in column
// l % B since B divides 32, with register accumulators.  Per group of 32
// triples (a lane each):
//   1. the lane holds its triple's descriptors (one coalesced read, issued
//      a group ahead) and its live columns, the A mask and the Y mask of
//      its blocks anded (read while the previous group's copies fly);
//   2. a warp scan numbers the items (one per live column) in triple
//      order, then k increasing;
//   3. for a window of items (<= 4 KB a warp), cp.async copies each item's
//      Y row and A column (16 B at a time where B allows) into the warp's
//      slice of shared memory;
//   4. the warp walks the items in order: before an item it takes the run
//      starts and `first` resets of the triples up to its own (a run start
//      stores the finished run and starts from the canvas block, or from
//      +0 at a `first`; a `first` mid-run zeroes), then each lane adds
//      A[r][k] * Y[k][c] with fmaf.
// So a triple whose A or Y block is all zero costs its two mask reads and
// no copy and no fmaf.
//
// Order and exactness.  Each accumulator starts from the canvas content or
// from +0, is zeroed by a `first` triple, and then sums with fmaf in triple
// order and, within a triple, in increasing k: the order of the dense GEMM
// kernels with zero terms left out.  Leaving out a term whose A or Y factor
// is zero is exact for finite operands: the product is +-0, and adding +-0
// to a sum that started from +0 leaves its value unchanged (only the sign
// of a zero sum could differ; an infinite or NaN factor beside a zero would
// have given NaN).  No atomics and no split runs, so results are bitwise
// reproducible and equal across the per-task, batched and compiled routes;
// 64-bit addressing throughout.
//
// `pred` (not null) predicates the launch on *pred == when (the activation
// route's overflow flag).
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr int kWarps = 4;           // warps of a thread block
constexpr int W = 32;               // triples of a group: a lane each
constexpr int kStageBytes = 4096;   // Y rows and A columns staged, per warp
constexpr int kMinTriples = 32;     // triples of a warp's share, at least
constexpr unsigned kFull = 0xffffffffu;

// Items (Y row and A column pairs, B floats each) staged at once for
// block B: at most kStageBytes, and no more than a group can hold.
__host__ __device__ constexpr int window_of(int B) {
  return kStageBytes / (8 * B) < W * B ? kStageBytes / (8 * B) : W * B;
}

// A warp's shared memory: the Y rows and A columns of one window of
// items, and the (triple, k) of every item of the group.
template <int B>
struct WarpStage {
  float y[window_of(B) * B];
  float a[window_of(B) * B];
  int item[W * B];  // triple << 8 | k
};

struct Triples {
  const float* a_cols;    // (Pa, B, B) pool, each block transposed
  const int* a_masks;     // (Pa,) non-zero columns of each A pool block
  const int* y_masks;     // (Py,) non-zero rows of each Y pool block
  const float* y_blocks;  // (Py, B, B) pool
  const int* a_ids;
  const int* y_ids;
  const int* out_rows;
  const int* out_cols;
  const int* first;
  float* z;               // (m_pad, ldz), updated in place
  const int* pred;
  int when;
  int n_entries, ldz;
  int shares;             // warps that take a share of the triples
};

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// One pass over both pools.  Thread (A block, k) writes column k of its
// block contiguously (a_cols[blk][k][r] = a_blocks[blk][r][k]); thread
// (Y block, k) reads row k of its block.  A ballot gives each block's mask
// of non-zero columns (A) or rows (Y): the B threads of a block share a
// warp, since B divides 32.
template <int B>
__global__ void __launch_bounds__(256)
    spmm_masks_kernel(const float* __restrict__ a_blocks, int n_a,
                      const float* __restrict__ y_blocks, int n_y,
                      float* __restrict__ a_cols, int* __restrict__ a_masks,
                      int* __restrict__ y_masks, const int* __restrict__ pred,
                      int when) {
  if (pred != nullptr && *pred != when) return;
  constexpr int BB = B * B;
  constexpr unsigned kColumns = B == 32 ? kFull : (1u << B) - 1u;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t blk = t / B;
  const int k = (int)(t % B), lane = threadIdx.x & 31;
  bool nz = false;
  if (blk < n_a) {
    const float* src = a_blocks + blk * BB + k;
    float* dst = a_cols + blk * BB + k * B;
#pragma unroll
    for (int r = 0; r < B; ++r) {
      const float v = src[r * B];
      dst[r] = v;
      nz |= v != 0.0f;
    }
  } else if (blk < (int64_t)n_a + n_y) {
    const float* src = y_blocks + (blk - n_a) * BB + k * B;
    if (B % 4 == 0 && reinterpret_cast<uintptr_t>(y_blocks) % 16 == 0) {
#pragma unroll
      for (int c = 0; c < B; c += 4) {
        const float4 v = __ldcs(reinterpret_cast<const float4*>(src + c));
        nz |= v.x != 0.0f || v.y != 0.0f || v.z != 0.0f || v.w != 0.0f;
      }
    } else {
#pragma unroll
      for (int c = 0; c < B; ++c) nz |= src[c] != 0.0f;
    }
  }
  const unsigned bal = __ballot_sync(kFull, nz);
  if (k == 0 && blk < (int64_t)n_a + n_y) {
    const int m = (int)((bal >> lane) & kColumns);
    if (blk < n_a)
      a_masks[blk] = m;
    else
      y_masks[blk - n_a] = m;
  }
}

__device__ __forceinline__ bool key_change(const Triples& p, int t) {
  return t == 0 || p.out_rows[t] != p.out_rows[t - 1] ||
         p.out_cols[t] != p.out_cols[t - 1];
}

template <int B>
__global__ void __launch_bounds__(kWarps * 32)
    spmm_fused_kernel(const Triples p) {
  if (p.pred != nullptr && *p.pred != p.when) return;
  constexpr int BB = B * B;
  constexpr int NE = (BB + 31) / 32;  // elements of a lane
  constexpr int I = window_of(B);
  __shared__ __align__(16) WarpStage<B> stages[kWarps];
  WarpStage<B>& st = stages[threadIdx.x / 32];
  const int lane = threadIdx.x & 31;
  const int warp = blockIdx.x * kWarps + threadIdx.x / 32;
  if (warp >= p.shares) return;
  const int E = p.n_entries;
  const int x0 = (int)((int64_t)warp * E / p.shares);
  const int x1 = (int)((int64_t)(warp + 1) * E / p.shares);

  // the first run start in [x0, x1); none: the share belongs to a run
  // that an earlier warp walks
  int c = x1;
  for (int base = x0; base < x1; base += 32) {
    const int t = base + lane;
    const unsigned b = __ballot_sync(kFull, t < x1 && key_change(p, t));
    if (b != 0) {
      c = base + __ffs(b) - 1;
      break;
    }
  }
  if (c >= x1) return;

  const int col = lane % B;  // this lane's column in every block
  // a copy moves `gran` floats (16 B where B and the pools allow); an item
  // is `per` copies of its Y row, then `per` of its A column
  const int gran = B % 4 == 0 &&
                           reinterpret_cast<uintptr_t>(p.y_blocks) % 16 == 0 &&
                           reinterpret_cast<uintptr_t>(p.a_cols) % 16 == 0
                       ? 4
                       : 1;
  const int per = B / gran, per_shift = __ffs(per) - 1;
  // this lane's triple of the group (c + lane): its descriptors, and its
  // live columns k (A column k and Y row k both non-zero)
  int aid = 0, yid = 0, orow = -1, ocol = -1, fst = 0;
  auto read_desc = [&](int t0, int& a, int& y, int& r, int& k, int& f) {
    const int t = t0 + lane;
    if (t < E) {
      a = p.a_ids[t];
      y = p.y_ids[t];
      r = p.out_rows[t];
      k = p.out_cols[t];
      f = p.first[t];
    } else {
      a = y = 0;
      r = k = -1;
      f = 0;
    }
  };
  auto live_of = [&](int t0, int a, int y) {
    return t0 + lane < E ? (unsigned)(p.a_masks[a] & p.y_masks[y]) : 0u;
  };
  read_desc(c, aid, yid, orow, ocol, fst);
  unsigned live = live_of(c, aid, yid);

  float acc[NE];
#pragma unroll
  for (int q = 0; q < NE; ++q) acc[q] = 0.0f;
  // the finished run's block into the canvas
  auto store_run = [&](const float(&v)[NE], int64_t r0, int64_t c0) {
#pragma unroll
    for (int q = 0; q < NE; ++q) {
      const int el = lane + 32 * q;
      if (el < BB) p.z[(r0 + el / B) * p.ldz + c0 + col] = v[q];
    }
  };
  int64_t zr = 0, zc = 0;  // the canvas block of the run in acc
  bool have_run = false;
  int key_r = -1, key_c = -1;  // the key of the triple before the group
  bool done = false;
  while (!done) {
    const int n0 = min(W, E - c);
    // the next group's descriptors, in flight while this one is walked
    int n_aid, n_yid, n_orow, n_ocol, n_fst;
    read_desc(c + W, n_aid, n_yid, n_orow, n_ocol, n_fst);
    // run starts; the walk ends at the first run that starts in the next
    // warp's share, or at the end of the list
    int pr = __shfl_up_sync(kFull, orow, 1), pc = __shfl_up_sync(kFull, ocol, 1);
    if (lane == 0) {
      pr = key_r;
      pc = key_c;
    }
    const unsigned starts =
        __ballot_sync(kFull, lane < n0 && (orow != pr || ocol != pc));
    const int lo = max(x1 - c, 0);
    const unsigned late = starts & (lo >= 32 ? 0u : kFull << lo);
    int n = n0;
    if (late != 0) {
      n = __ffs(late) - 1;
      done = true;
    } else if (c + n0 >= E) {
      done = true;
    }
    const unsigned firsts = __ballot_sync(kFull, lane < n && fst != 0);
    const unsigned ours = starts & (n >= 32 ? kFull : (1u << n) - 1u);
    // the items, one per live column, in triple order then k increasing
    const unsigned mask = lane < n ? live : 0u;
    const int cnt = __popc(mask);
    int incl = cnt;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += v;
    }
    const int total = __shfl_sync(kFull, incl, 31);
    __syncwarp();  // the previous group's items are no longer read
    {
      int item = incl - cnt;
      for (unsigned m = mask; m != 0; m &= m - 1)
        st.item[item++] = lane << 8 | (__ffs(m) - 1);
    }
    __syncwarp();
    unsigned events = ours | firsts;
    // the run starts and `first` resets of the triples up to i, in order
    auto events_upto = [&](int i) {
      const unsigned upto = i >= 31 ? kFull : (2u << i) - 1u;
      unsigned todo = events & upto;
      events &= ~upto;
      for (; todo != 0; todo &= todo - 1) {
        const int j = __ffs(todo) - 1;
        if ((ours >> j) & 1u) {
          if (have_run) store_run(acc, zr, zc);
          zr = (int64_t)__shfl_sync(kFull, orow, j) * B;
          zc = (int64_t)__shfl_sync(kFull, ocol, j) * B;
          have_run = true;
          const bool canvas = ((firsts >> j) & 1u) == 0;
#pragma unroll
          for (int q = 0; q < NE; ++q) {
            const int el = lane + 32 * q;
            acc[q] = canvas && el < BB
                         ? p.z[(zr + el / B) * p.ldz + zc + col]
                         : 0.0f;
          }
        } else {
#pragma unroll
          for (int q = 0; q < NE; ++q) acc[q] = 0.0f;
        }
      }
    };
    unsigned n_live = 0;
    for (int w0 = 0; w0 < total; w0 += I) {
      const int wn = min(I, total - w0);
      __syncwarp();  // the previous window's stage is no longer read
      // Y rows and A columns of the window's items
      for (int v0 = 0; v0 < wn << (per_shift + 1); v0 += 32) {
        const int v = v0 + lane, it = min(v >> (per_shift + 1), wn - 1);
        const int t = st.item[w0 + it];
        const int j = t >> 8, k = t & 255;
        const int64_t yj = __shfl_sync(kFull, yid, j);
        const int64_t aj = __shfl_sync(kFull, aid, j);
        if (v < wn << (per_shift + 1)) {
          const int q = v & (per - 1);
          const bool is_a = (v >> per_shift) & 1;
          const float* src =
              (is_a ? p.a_cols + aj * BB : p.y_blocks + yj * BB) + k * B +
              q * gran;
          float* dst = (is_a ? st.a : st.y) + it * B + q * gran;
          if (gran == 4)
            cp_async16(dst, src);
          else
            cp_async4(dst, src);
        }
      }
      // the next group's live columns, in flight with the copies
      if (w0 == 0) n_live = live_of(c + n0, n_aid, n_yid);
      cp_async_wait_all();
      __syncwarp();
      // the window's items in order, each after the events of the triples
      // up to its own
      for (int it = 0; it < wn; ++it) {
        events_upto(st.item[w0 + it] >> 8);
        const float y = st.y[it * B + col];
        const float* a = st.a + it * B;
#pragma unroll
        for (int q = 0; q < NE; ++q) {
          const int el = lane + 32 * q;
          if (el < BB) acc[q] = fmaf(a[el / B], y, acc[q]);
        }
      }
    }
    events_upto(31);
    if (total == 0) n_live = live_of(c + n0, n_aid, n_yid);
    key_r = __shfl_sync(kFull, orow, n - 1);
    key_c = __shfl_sync(kFull, ocol, n - 1);
    c += n;
    aid = n_aid;
    yid = n_yid;
    orow = n_orow;
    ocol = n_ocol;
    fst = n_fst;
    live = n_live;
  }
  if (have_run) store_run(acc, zr, zc);
}

// Thread blocks of `kernel` resident at once on the current device.  The
// query is made once per kernel and device: the per-task path launches
// many short calls, whose host time it would otherwise lengthen.
std::mutex g_fit_mu;
std::map<std::pair<const void*, int>, long long> g_resident;

int resident_blocks(const void* kernel, long long* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(g_fit_mu);
  const auto key = std::make_pair(kernel, dev);
  auto it = g_resident.find(key);
  if (it == g_resident.end()) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kWarps * 32, 0);
    if (err != cudaSuccess) return (int)err;
    it = g_resident.emplace(key, (long long)(per_sm > 0 ? per_sm : 1) * sms)
             .first;
  }
  *out = it->second;
  return 0;
}

template <int B>
int launch(Triples p, const float* a_blocks, int n_a, int n_y,
           float* a_cols, int* masks, cudaStream_t stream) {
  const long long threads = ((long long)n_a + n_y) * B;
  if (threads > 0) {
    spmm_masks_kernel<B><<<(unsigned)((threads + 255) / 256), 256, 0,
                           stream>>>(a_blocks, n_a, p.y_blocks, n_y, a_cols,
                                     masks, masks + n_a, p.pred, p.when);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  p.a_cols = a_cols;
  p.a_masks = masks;
  p.y_masks = masks + n_a;
  long long resident = 0;
  const int err =
      resident_blocks((const void*)spmm_fused_kernel<B>, &resident);
  if (err != 0) return err;
  // one share per resident warp, of kMinTriples triples at least
  long long shares = resident * kWarps;
  const long long want = (p.n_entries + kMinTriples - 1) / kMinTriples;
  if (shares > want) shares = want;
  if (shares < 1) shares = 1;
  p.shares = (int)shares;
  const dim3 grid((unsigned)((shares + kWarps - 1) / kWarps));
  spmm_fused_kernel<B><<<grid, kWarps * 32, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// a_blocks (Pa, B, B), y_blocks (Py, B, B), z (m_pad, ldz): f32 row-major
// contiguous.  The n_entries int32 descriptors are sorted by output block,
// each output block one run.  pred: int32 device flag or null.  a_cols
// (Pa, B, B) f32 and masks (Pa + Py,) int32 are scratch the caller
// allocates: the A pool's transposed blocks, its blocks' column masks and
// the Y pool's blocks' row masks, written by the first of the two
// launches.
extern "C" int spmm_fused_f32(const void* a_blocks, const void* y_blocks,
                              const void* a_ids, const void* y_ids,
                              const void* out_rows, const void* out_cols,
                              const void* first, int n_entries, void* z,
                              int block, int ldz, const void* pred, int when,
                              int n_a, int n_y, void* a_cols, void* masks,
                              void* stream) {
  if (n_entries == 0) return 0;
  Triples p{};
  p.y_blocks = (const float*)y_blocks;
  p.a_ids = (const int*)a_ids;
  p.y_ids = (const int*)y_ids;
  p.out_rows = (const int*)out_rows;
  p.out_cols = (const int*)out_cols;
  p.first = (const int*)first;
  p.z = (float*)z;
  p.pred = (const int*)pred;
  p.when = when;
  p.n_entries = n_entries;
  p.ldz = ldz;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (block) {
#define SPMM_CASE(BB)                                                    \
  case BB:                                                               \
    return launch<BB>(p, (const float*)a_blocks, n_a, n_y, (float*)a_cols, \
                      (int*)masks, st);
    SPMM_CASE(1)
    SPMM_CASE(2)
    SPMM_CASE(4)
    SPMM_CASE(8)
    SPMM_CASE(16)
    SPMM_CASE(32)
#undef SPMM_CASE
    default: return (int)cudaErrorInvalidValue;
  }
}
