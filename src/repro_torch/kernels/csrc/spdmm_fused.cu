// Block-sparse x dense products: the fused multi-task SpDMM on an in-place
// canvas, and the single-BlockCSR SpDMM.  Each entry point launches its own
// kernel (spdmm_fused_kernel, spdmm_kernel), both the run walk below, so a
// tile computed by either is bitwise the same.
//
// spdmm_fused replaces the Pallas kernel `repro/kernels/spdmm.py::spdmm_fused`
// (`_spdmm_fused_kernel` / `_spdmm_fused_inplace_kernel`: grid (n_entries,),
// scalar-prefetched entry arrays, output block (out_rows[t], out_cols[t])
// resident in VMEM across a consecutive run).  For each entry t in order:
//   Z[orow*B:+B, ocol*bn:+bn]  (zeroed if first[t])
//       += A_pool[a_ids[t]] @ Y[y_rows[t]*B:+B, ocol*bn:+bn]
// Output blocks no entry covers keep their canvas content.
//
// Y (K x n) and Z (m x n) are read and written where they lie: each has
// its own row stride (ldy, ldz) and unit column stride, and neither needs
// padding.  Stripe ocol is columns [ocol*bn, min(ocol*bn + bn, n)): a
// ragged last stripe copies only its columns below n (its other lanes sum
// whatever the stage holds and are never stored), a canvas block only its
// rows below m, and stores are masked to rows < m and columns < n.  Rows of
// Y at or past K are never read: the walk reads only the Y rows of non-zero
// A columns, and the packer leaves every A column past K zero.  The padded
// layout (K, m block multiples, n a multiple of bn) is the case in which
// nothing is clipped; the summation order is the same in both.
//
// spdmm replaces `repro/kernels/spdmm.py::spdmm` (grid (N/bn, nnzb): the
// stored blocks of ONE BlockCSR walked per output column stripe, `first`
// zero-initializing each block-row run): Z[row*B:+B, :] (zeroed if first)
// += blocks[t] @ Y[col_ids[t]*B:+B, :].  It is spdmm_fused with the entry
// list of a single BlockCSR (a_ids = t, y_rows = col_ids, out_rows =
// row_ids, out_cols = 0) over the whole width of Y.
//
// What bounds them on an H100 (chip_smoke.py; PERF.md section 6).  The
// summation order is fixed (below), so a run cannot be split across thread
// blocks, and no tensor core applies (B = 8 is below every MMA shape, and
// TF32 would round differently).  The least time of a call is its bytes:
// the stored pool read once, the Y rows of the non-zero A columns only
// (~1.1 of a block's 8 in a GCN aggregation over the Flickr stand-in) and
// the canvas, 0.10 ms for that aggregation at 3.35 TB/s.  The dependent
// fmaf chain is short even on the longest run: GIN's first MLP kernel on
// Cora has a run of 1,984 entries, mostly all-zero filler blocks, with 938
// non-zero columns in all, so 938 dependent fmaf an element.  What bounds
// the walk as built is its steps: a step takes at most 32 entries of one
// run and costs three barriers and a one-warp scan besides its copies, so
// a call takes about its busiest thread block's steps times a step's
// latency (that longest run: 62 steps, ~1.5 us each, measured).
//
// Design.  A thread block walks runs (maximal stretches of entries with one
// (out_row, out_col) key, found from key changes) times a chunk of up to 128
// columns.  The grid is sized to the card: thread block b takes the runs
// that start in its equal share of the entries, so a launch costs nothing
// per run slot and a long run is one thread block's whole share.  Threads
// map to output ELEMENTS: C column lanes times G row groups of R rows, C*G
// <= 128, so narrow widths (bn 8, 16) still fill the block with rows.  Each
// step of the walk (one __syncthreads round) takes up to 32 entries of one
// run and
//   1. compacts their staged A blocks into ITEMS, one per non-zero A column
//      in entry order then increasing k, each holding that column's B
//      values and its Y row -- thread (entry, column) loads the column, a
//      warp ballot makes the column masks, one warp scans the entries (the
//      run's end, the entries that fit the item stage, the last `first`);
//   2. issues, with cp.async, the items' Y rows (16 B where the row
//      stride and address allow, else 4 B), the canvas block where a run
//      starts without a `first`, and the descriptors and A blocks of the
//      next entries;
//   3. multiplies the items of the previous step, whose Y rows have
//      arrived: every element does one fmaf per item, operands loaded a
//      group ahead of the chain; a run's first step stores the finished run.
// So Y is read only where A has a non-zero column, an all-zero block (the
// packer's fillers) costs neither Y traffic nor an fmaf, and the copies of
// the next step are in flight while this one is multiplied.
//
// Order and exactness.  Each accumulator starts from the canvas content (the
// aliasing semantics) or from +0; a `first` entry zeroes it, also mid-run (a
// step keeps only the items from its last `first` on, and zeroes first).  It
// then sums with fmaf in entry order and, within an entry, in increasing k:
// over a row's stored blocks (sorted by block column) that is the dense GEMM
// kernels' order with zero terms left out.  Leaving out a k whose A column is
// all zero is exact for finite Y: each such product is +-0, and adding +-0
// to a sum that started from +0 leaves its value unchanged -- the argument
// by which the kernels already leave out zero blocks.  (Only a sum that is
// -0 could differ, in the sign of zero; a zero A value with an infinite or
// NaN Y value would have given NaN.)  No atomics and no split runs, so
// results are bitwise reproducible and equal across the per-task, batched
// and compiled routes; 64-bit addressing throughout (pools at Reddit scale
// pass 2^31 elements).
//
// The kernel needs no run offsets: the compiled activation route, whose
// descriptors are made on the device at run time, launches the same fixed
// grid whatever the data.  `pred` (not null) predicates the launch on
// *pred == when (the route's overflow flag).
#include <cuda_runtime.h>
#include <stdint.h>

#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace {

constexpr int kThreads = 128;       // threads of a thread block
constexpr int kMaxWindow = 32;      // entries a step scans: one warp
constexpr int kRingBytes = 8192;    // A blocks staged per thread block
constexpr int kStageBytes = 16384;  // Y rows of one step's items
constexpr int kMaxItems = 128;      // items of one step
constexpr int kMinEntries = 32;     // entries per thread block, at least
constexpr unsigned kFull = 0xffffffffu;

// Entries a step scans for block B: a power of two, at most kMaxWindow
// (one warp scans them), their A blocks at most kRingBytes.
__host__ __device__ constexpr int window_of(int B) {
  int w = kMaxWindow;
  while (w > 1 && w * B * B * 4 > kRingBytes) w >>= 1;
  return w;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__host__ __device__ constexpr size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

struct Walk {
  const float* a_blocks;  // (P, B, B) pool
  const float* y;         // K rows of n columns, row stride ldy
  const int* a_ids;       // null: entry t uses pool block t
  const int* y_rows;
  const int* out_rows;
  const int* out_cols;    // null: every entry has out_col 0
  const int* first;
  float* z;               // m rows of n columns, row stride ldz
  const int* pred;
  int when;
  int n_entries, bn, ldy, ldz;
  int m, n;               // Z's rows; the columns of Y and Z
  int lanes;              // C: column lanes (a power of two <= 128)
  int n_chunks;           // column chunks of bn
  int parts;              // entry shares per chunk (one per thread block)
  int items;              // items per step, B rows of it for a canvas block
};

// Byte offsets of the shared-memory regions; the same on host and device:
// the A blocks of one window, two stages of Y rows (the canvas block in
// their last B rows), item A values and item Y rows, rings of the five
// descriptors over two windows, each window entry's column mask and first
// item, and the scan's results.
struct Layout {
  size_t a, ys, ia, iy, desc, masks, offs, ctl, total;
  __host__ __device__ Layout(int B, const Walk& p) {
    const size_t W = window_of(B), I = p.items;
    a = 0;
    ys = a + align16(W * B * B * 4);
    ia = ys + align16(2 * I * p.lanes * 4);
    iy = ia + align16(2 * I * B * 4);
    desc = iy + align16(2 * I * 4);
    masks = desc + align16(5 * 2 * W * 4);
    offs = masks + align16(W * 4);
    ctl = offs + align16(W * 4);
    total = ctl + 16 * 4;
  }
};

// R consecutive floats of shared memory (16-byte loads where R allows).
template <int R>
__device__ __forceinline__ void load_rows(float (&a)[R], const float* src) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int r = 0; r < R; r += 4) {
      const float4 v = *reinterpret_cast<const float4*>(src + r);
      a[r] = v.x;
      a[r + 1] = v.y;
      a[r + 2] = v.z;
      a[r + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) a[r] = src[r];
  }
}

// The operands of items i .. i + U - 1: each item's Y value in this
// thread's column and its A values in this thread's R rows.
template <int U, int R>
__device__ __forceinline__ void load_group(float (&y)[U], float (&a)[U][R],
                                           const float* yv, const float* av,
                                           int i, int C, int B) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
    y[u] = yv[(i + u) * C];
    load_rows<R>(a[u], av + (i + u) * B);
  }
}

// acc[r] += a[u][r] * y[u], item by item in order.
template <int U, int R>
__device__ __forceinline__ void fma_group(float (&acc)[R], const float (&y)[U],
                                          const float (&a)[U][R]) {
#pragma unroll
  for (int u = 0; u < U; ++u) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(a[u][r], y[u], acc[r]);
  }
}

// Store a finished run's R rows of column zc, those inside Z's m rows and
// n columns.
template <int R>
__device__ __forceinline__ void store_run(const Walk& p, const float (&acc)[R],
                                          int64_t zr, int64_t zc,
                                          bool active) {
  if (!active || zc >= p.n) return;
  if (zr + R <= p.m) {
#pragma unroll
    for (int r = 0; r < R; ++r) p.z[(zr + r) * p.ldz + zc] = acc[r];
  } else {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (zr + r < p.m) p.z[(zr + r) * p.ldz + zc] = acc[r];
    }
  }
}

// Issue the copies of `rows` rows of `src` (row stride ld) into the stage,
// row i of the stage from row iy[i] (Gather) or r0 + i: columns [col,
// col + w), 16 B a thread where vec (w a multiple of 4, the rows 16-B
// aligned), else 4 B.  Stage lanes from w on are not written.
template <bool Gather>
__device__ __forceinline__ void copy_rows(float* stage, const float* src,
                                          int64_t ld, const int* iy,
                                          int64_t r0, int rows, int64_t col,
                                          int w, int C, bool vec) {
  if (w <= 0) return;
  const int T = kThreads, tid = threadIdx.x;
  auto row = [&](int i) {
    return src + (Gather ? (int64_t)iy[i] : r0 + i) * ld + col;
  };
  if (vec && (w & (w - 1)) == 0) {
    const int sh = __ffs(w / 4) - 1;  // w / 4 granules a row
    for (int v = tid; v < rows << sh; v += T) {
      const int i = v >> sh, q = (v & ((1 << sh) - 1)) * 4;
      cp_async16(stage + i * C + q, row(i) + q);
    }
  } else if (vec) {
    const int per = w / 4;
    for (int v = tid; v < rows * per; v += T) {
      const int i = v / per, q = (v - i * per) * 4;
      cp_async16(stage + i * C + q, row(i) + q);
    }
  } else if (w <= 8) {
    // a row a thread: a row this short is one or two sectors
    for (int i = tid; i < rows; i += T) {
      const float* r = row(i);
      for (int q = 0; q < w; ++q) cp_async4(stage + i * C + q, r + q);
    }
  } else {
    for (int v = tid; v < rows * w; v += T) {
      const int i = v / w, q = v - i * w;
      cp_async4(stage + i * C + q, row(i) + q);
    }
  }
}

// The first entry at or after x that starts a run (a maximal stretch of one
// (out_row, out_col) key), or n_entries.  Block-uniform; kThreads entries a
// round.
__device__ int run_start_at(const Walk& p, int x, int* flag) {
  const int E = p.n_entries;
  for (int base = x; base < E; base += kThreads) {
    const int t = base + threadIdx.x;
    bool st = false;
    if (t < E) {
      st = t == 0 || p.out_rows[t] != p.out_rows[t - 1] ||
           (p.out_cols != nullptr && p.out_cols[t] != p.out_cols[t - 1]);
    }
    __syncthreads();  // the flag's previous reads are done
    if (threadIdx.x == 0) *flag = E;
    __syncthreads();
    if (st) atomicMin(flag, t);
    __syncthreads();
    const int f = *flag;
    if (f < E) return f;
  }
  return E;
}

// The run walk of one thread block (its share of the entries).
template <int B, int R>
__device__ __forceinline__ void walk_share(const Walk p) {
  if (p.pred != nullptr && *p.pred != p.when) return;
  constexpr int G = B / R;  // row groups
  // the window, the descriptor ring, the rounds of (entry, column) pairs
  // over the thread block, and the mask of an entry's columns
  constexpr int W = window_of(B), kRing = 2 * W;
  constexpr int kRounds = (W * B + kThreads - 1) / kThreads;
  constexpr unsigned kColumns = B == 32 ? kFull : (1u << B) - 1u;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout L(B, p);
  float* a_ring = reinterpret_cast<float*>(smem + L.a);
  float* ys = reinterpret_cast<float*>(smem + L.ys);
  float* ia = reinterpret_cast<float*>(smem + L.ia);
  int* iy = reinterpret_cast<int*>(smem + L.iy);
  int* d_aid = reinterpret_cast<int*>(smem + L.desc);
  int* d_yrow = d_aid + kRing;
  int* d_first = d_yrow + kRing;
  int* d_orow = d_first + kRing;
  int* d_ocol = d_orow + kRing;
  unsigned* masks = reinterpret_cast<unsigned*>(smem + L.masks);
  int* offs = reinterpret_cast<int*>(smem + L.offs);
  int* ctl = reinterpret_cast<int*>(smem + L.ctl);

  const int C = p.lanes, T = kThreads, tid = threadIdx.x;
  const int lane = tid & 31;
  const int cl = tid % C, g = tid / C;  // column lane, row group
  const int wmask = W - 1, rmask = kRing - 1;
  const int E = p.n_entries;
  const int chunk = blockIdx.x % p.n_chunks, part = blockIdx.x / p.n_chunks;
  // this thread block walks the runs that start in its share of entries
  const int x0 = (int)((int64_t)part * E / p.parts);
  const int x1 = (int)((int64_t)(part + 1) * E / p.parts);
  const int s = run_start_at(p, x0, ctl + 8);
  if (s >= x1) return;
  const int c0 = chunk * C;
  const int cv = min(C, p.bn - c0);  // valid columns of this chunk
  const bool active = g < G && cl < cv;
  const bool aligned = (p.out_cols == nullptr || p.bn % 4 == 0) &&
                       c0 % 4 == 0 && cv % 4 == 0;
  const bool vec_y = aligned && p.ldy % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(p.y) % 16 == 0;
  const bool vec_z = aligned && p.ldz % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(p.z) % 16 == 0;
  const bool vec_a = reinterpret_cast<uintptr_t>(p.a_blocks) % 16 == 0;

  float acc[R];
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.0f;
  int64_t zr = 0, zc = 0;  // the canvas block of the run in acc
  bool have_run = false;

  // walk state, uniform over the thread block: entries [c, a_hi) have
  // their A blocks staged, [c, d_hi) their descriptors; the walk ends at e
  int c = s, a_hi = s, d_hi = s, e = E, buf = 0;
  int key_r = -1, key_c = -1;  // the run key of the last step
  // the previous step, multiplied one iteration later
  bool pend = false, p_reset = false, p_starts = false, p_canvas = false;
  int p_n = 0, p_orow = 0, p_ocol = 0;
  while (true) {
    cp_async_wait_all();
    __syncthreads();
    // 1. compact the staged entries into this step's items: at most the
    // item stage, never past the end of a run
    const int w = min(a_hi, d_hi) - c;
    int taken = 0, n = 0, orow = 0, ocol = 0;
    bool reset = false, starts = false, canvas = false;
    float* ia_b = ia + buf * p.items * B;
    int* iy_b = iy + buf * p.items;
    if (w > 0) {
      // 1a. thread (entry j, column k) loads A column k of entry j, and a
      // ballot gathers each entry's mask of non-zero columns
      float vals[kRounds][B];
#pragma unroll
      for (int rd = 0; rd < kRounds; ++rd) {
        const int q = rd * kThreads + tid, j = q / B, k = q % B;
        bool nz = false;
        if (j < w) {
          const float* a = a_ring + ((c + j) & wmask) * B * B + k;
#pragma unroll
          for (int r = 0; r < B; ++r) {
            vals[rd][r] = a[r * B];
            nz |= vals[rd][r] != 0.0f;
          }
        }
        const unsigned bal = __ballot_sync(kFull, nz);
        if (k == 0 && j < w) masks[j] = (bal >> lane) & kColumns;
      }
      __syncthreads();
      // 1b. one warp, a lane per entry: run starts, the entries that fit,
      // the last `first` among them, and each kept entry's first item
      if (tid < 32) {
        const int j = lane, sl = (c + j) & rmask;
        const bool in = j < w;
        const int cnt = in ? __popc(masks[j]) : 0;
        const int kr = in ? d_orow[sl] : -1;
        const int kc = in && p.out_cols != nullptr ? d_ocol[sl] : 0;
        int pr = __shfl_up_sync(kFull, kr, 1), pc = __shfl_up_sync(kFull, kc, 1);
        if (lane == 0) {
          pr = key_r;
          pc = key_c;
        }
        const bool st = in && (kr != pr || kc != pc);
        const bool fj = in && d_first[sl] != 0;
        const unsigned later = __ballot_sync(kFull, st && j > 0);
        const int bound = later != 0 ? __ffs(later) - 1 : w;
        // a run that starts without a `first` reads its canvas block into
        // the last B rows of the Y stage
        const bool st0 = __shfl_sync(kFull, st, 0);
        const bool f0 = __shfl_sync(kFull, fj, 0);
        const int cap = p.items - (st0 && !f0 ? B : 0);
        int incl = cnt;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, incl, o);
          if (lane >= o) incl += v;
        }
        int tk = __popc(__ballot_sync(kFull, in && incl <= cap));
        tk = min(tk, bound);
        const bool stop = st0 && c >= x1;  // the next run is another block's
        if (stop) tk = 0;
        const unsigned fm = __ballot_sync(kFull, j < tk && fj);
        const int lo = fm != 0 ? 31 - __clz(fm) : 0;
        // items of the entries before the last `first` are dropped
        const int base = __shfl_sync(kFull, incl - cnt, lo);
        const int total = __shfl_sync(kFull, incl, max(tk - 1, 0));
        if (j >= lo && j < tk) offs[j] = incl - cnt - base;
        if (lane == 0) {
          ctl[0] = tk;
          ctl[1] = tk > 0 ? total - base : 0;
          ctl[2] = fm != 0;
          ctl[3] = lo;
          ctl[4] = st;
          ctl[5] = kr;
          ctl[6] = kc;
          ctl[7] = stop;
        }
      }
      __syncthreads();
      taken = ctl[0];
      n = ctl[1];
      reset = ctl[2] != 0;
      const int from = ctl[3];
      starts = ctl[4] != 0;
      orow = ctl[5];
      ocol = ctl[6];
      if (ctl[7] != 0) e = c;
      canvas = taken > 0 && starts && !reset;
      // 1c. each kept non-zero column becomes an item: its B values and
      // its Y row, at its place in entry order, k increasing
#pragma unroll
      for (int rd = 0; rd < kRounds; ++rd) {
        const int q = rd * kThreads + tid, j = q / B, k = q % B;
        if (j < from || j >= taken) continue;
        const unsigned m = masks[j];
        if (((m >> k) & 1u) == 0) continue;
        const int idx = offs[j] + __popc(m & ((1u << k) - 1u));
        float* dst = ia_b + idx * B;
        if constexpr (B % 4 == 0) {
#pragma unroll
          for (int r = 0; r < B; r += 4)
            *reinterpret_cast<float4*>(dst + r) = make_float4(
                vals[rd][r], vals[rd][r + 1], vals[rd][r + 2], vals[rd][r + 3]);
        } else {
#pragma unroll
          for (int r = 0; r < B; ++r) dst[r] = vals[rd][r];
        }
        iy_b[idx] = d_yrow[(c + j) & rmask] * B + k;
      }
      __syncthreads();
      // 1d. the items' Y rows, and the canvas block where a run starts
      // without a `first`
      // the chunk's columns [col, col + cv), of which the first vn lie
      // inside n: a ragged last stripe copies only those (its other lanes
      // are never stored), and a canvas block only its rows inside m
      const int64_t col = (int64_t)ocol * p.bn + c0;
      const int64_t left = (int64_t)p.n - col;
      const int vn = left <= 0 ? 0 : left < cv ? (int)left : cv;
      float* ys_b = ys + buf * p.items * C;
      copy_rows<true>(ys_b, p.y, p.ldy, iy_b, 0, n, col, vn, C,
                      vec_y && vn % 4 == 0);
      if (canvas) {
        const int64_t r0 = (int64_t)orow * B;
        const int64_t below = (int64_t)p.m - r0;
        const int rv = below <= 0 ? 0 : below < B ? (int)below : B;
        copy_rows<false>(ys_b + (p.items - B) * C, p.z, p.ldz, nullptr, r0,
                         rv, col, vn, C, vec_z && vn % 4 == 0);
      }
      if (taken > 0) {
        key_r = orow;
        key_c = ocol;
      }
    }
    c += taken;
    // 2. descriptors of [d_hi, d_new), and A blocks of [a_hi, a_new) whose
    // descriptors are staged (the slots of the entries just taken are free)
    const int d_new = min(e, c + kRing);
    for (int t = d_hi + tid; t < d_new; t += T) {
      const int sl = t & rmask;
      if (p.a_ids != nullptr) cp_async4(d_aid + sl, p.a_ids + t);
      cp_async4(d_yrow + sl, p.y_rows + t);
      cp_async4(d_first + sl, p.first + t);
      cp_async4(d_orow + sl, p.out_rows + t);
      if (p.out_cols != nullptr) cp_async4(d_ocol + sl, p.out_cols + t);
    }
    const int a_new = min(min(p.a_ids != nullptr ? d_hi : e, e), c + W);
    if (B * B * 4 >= 16 && vec_a) {
      constexpr int GR = B * B >= 4 ? B * B / 4 : 1;  // 16-B granules
      for (int v = tid; v < (a_new - a_hi) * GR; v += T) {
        const int t = a_hi + v / GR, q = v % GR;
        const int64_t id = p.a_ids != nullptr ? d_aid[t & rmask] : t;
        cp_async16(a_ring + (t & wmask) * B * B + q * 4,
                   p.a_blocks + id * (B * B) + q * 4);
      }
    } else {
      for (int v = tid; v < (a_new - a_hi) * B * B; v += T) {
        const int t = a_hi + v / (B * B), q = v % (B * B);
        const int64_t id = p.a_ids != nullptr ? d_aid[t & rmask] : t;
        cp_async4(a_ring + (t & wmask) * B * B + q,
                  p.a_blocks + id * (B * B) + q);
      }
    }
    cp_async_commit();
    // 3. multiply the previous step's items (their Y rows have arrived);
    // where it starts a run, store the finished run first
    if (pend) {
      const int pb = buf ^ 1;
      if (p_starts) {
        if (have_run) store_run<R>(p, acc, zr, zc, active);
        zr = (int64_t)p_orow * B + g * R;
        zc = (int64_t)p_ocol * p.bn + c0 + cl;
        have_run = true;
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r] = (p_canvas && g < G)
                       ? ys[(pb * p.items + p.items - B + g * R + r) * C + cl]
                       : 0.0f;
      }
      if (p_reset) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      }
      if (g < G) {
        // U items' operands are loaded ahead of their fmaf chain
        constexpr int U = R >= 16 ? 2 : R >= 8 ? 4 : R >= 4 ? 8 : 16;
        const float* av = ia + pb * p.items * B + g * R;
        const float* yv = ys + pb * p.items * C + cl;
        int i = 0;
        for (; i + U <= p_n; i += U) {
          float y[U], a[U][R];
          load_group<U, R>(y, a, yv, av, i, C, B);
          fma_group<U, R>(acc, y, a);
        }
        for (; i < p_n; ++i) {
          float a[R];
          load_rows<R>(a, av + i * B);
          const float y = yv[i * C];
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = fmaf(a[r], y, acc[r]);
        }
      }
    }
    pend = taken > 0;
    p_n = n;
    p_reset = reset;
    p_starts = starts;
    p_canvas = canvas;
    p_orow = orow;
    p_ocol = ocol;
    d_hi = max(d_hi, d_new);
    a_hi = max(a_hi, a_new);
    buf ^= 1;
    if (c >= e && !pend) break;
  }
  if (have_run) store_run<R>(p, acc, zr, zc, active);
}

// One kernel per entry point, the same walk, so a profile tells their
// launches apart.  Six thread blocks an SM (at most 85 registers a
// thread): narrow widths, whose shared memory allows six, run six; a
// tighter bound spills.
template <int B, int R>
__global__ void __launch_bounds__(kThreads, 6)
    spdmm_fused_kernel(const Walk p) {
  walk_share<B, R>(p);
}

template <int B, int R>
__global__ void __launch_bounds__(kThreads, 6) spdmm_kernel(const Walk p) {
  walk_share<B, R>(p);
}

// Thread blocks of `kernel` resident at once on the current device with
// `smem` bytes of shared memory each.  The occupancy query and the
// shared-memory attribute are made once per kernel, device and size: the
// per-task path launches many short calls, whose host time they would
// otherwise lengthen.  The attribute only grows, so every size a kernel
// was launched with stays allowed.
std::mutex g_fit_mu;
std::map<int, int> g_sms;                               // device -> SMs
std::map<std::pair<const void*, int>, size_t> g_smem;   // attribute set
std::map<std::tuple<const void*, int, size_t>, long long> g_resident;

int resident_blocks(const void* kernel, size_t smem, long long* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> lock(g_fit_mu);
  const auto key = std::make_tuple(kernel, dev, smem);
  auto it = g_resident.find(key);
  if (it == g_resident.end()) {
    auto sms = g_sms.find(dev);
    if (sms == g_sms.end()) {
      int n = 0;
      err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
      if (err != cudaSuccess) return (int)err;
      sms = g_sms.emplace(dev, n).first;
    }
    size_t& allowed = g_smem[std::make_pair(kernel, dev)];
    if (smem > 48 * 1024 && smem > allowed) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
      allowed = smem;
    }
    int per_sm = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        kThreads, smem);
    if (err != cudaSuccess) return (int)err;
    it = g_resident.emplace(key, (long long)(per_sm > 0 ? per_sm : 1) *
                                     sms->second).first;
  }
  *out = it->second;
  return 0;
}

template <int B, int R>
int launch(Walk p, bool fused, cudaStream_t stream) {
  const void* kernel = fused ? (const void*)spdmm_fused_kernel<B, R>
                             : (const void*)spdmm_kernel<B, R>;
  const size_t smem = Layout(B, p).total;
  long long resident = 0;
  const int err = resident_blocks(kernel, smem, &resident);
  if (err != 0) return err;
  // thread blocks resident at once, shared among the column chunks; each
  // takes an equal share of the entries, of kMinEntries at least
  long long parts = resident / p.n_chunks;
  const long long want = (p.n_entries + kMinEntries - 1) / kMinEntries;
  if (parts > want) parts = want;
  if (parts < 1) parts = 1;
  p.parts = (int)parts;
  const dim3 grid((unsigned)(parts * p.n_chunks));
  if (fused)
    spdmm_fused_kernel<B, R><<<grid, kThreads, smem, stream>>>(p);
  else
    spdmm_kernel<B, R><<<grid, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

int pow2_at_least(int x) {
  int v = 1;
  while (v < x) v <<= 1;
  return v;
}

template <int B, int R>
int launch_r(const Walk& p, bool fused, cudaStream_t stream) {
  if constexpr (R <= B) {
    return launch<B, R>(p, fused, stream);
  } else {
    return (int)cudaErrorInvalidValue;
  }
}

// Thread mapping for block B: C column lanes times G = min(B, 128 / C) row
// groups of R = B / G rows each.  Threads past C * G take no part in the
// product, only in the copies.
template <int B>
int launch_b(const Walk& p, bool fused, cudaStream_t stream) {
  int groups = kThreads / p.lanes;
  if (groups < 1) groups = 1;
  if (groups > B) groups = B;
  switch (B / groups) {
    case 1: return launch_r<B, 1>(p, fused, stream);
    case 2: return launch_r<B, 2>(p, fused, stream);
    case 4: return launch_r<B, 4>(p, fused, stream);
    case 8: return launch_r<B, 8>(p, fused, stream);
    case 16: return launch_r<B, 16>(p, fused, stream);
    case 32: return launch_r<B, 32>(p, fused, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Column lanes, chunks and stage sizes for width bn, then the launch.
int walk(Walk p, int block, bool fused, cudaStream_t stream) {
  p.lanes = pow2_at_least(p.bn < kThreads ? p.bn : kThreads);
  p.n_chunks = (p.bn + p.lanes - 1) / p.lanes;
  const int window = window_of(block);
  int items = kStageBytes / (p.lanes * 4);
  if (items > window * block) items = window * block;
  if (items > kMaxItems) items = kMaxItems;
  if (items < 2 * block) items = 2 * block;
  p.items = items;
  switch (block) {
    case 1: return launch_b<1>(p, fused, stream);
    case 2: return launch_b<2>(p, fused, stream);
    case 4: return launch_b<4>(p, fused, stream);
    case 8: return launch_b<8>(p, fused, stream);
    case 16: return launch_b<16>(p, fused, stream);
    case 32: return launch_b<32>(p, fused, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// a_blocks (P, B, B) f32 contiguous; y (K, n) and z (m, n) f32 with unit
// column stride and row strides ldy, ldz.  The n_entries int32 descriptors
// are sorted by output block, each output block one run; stripe out_col
// covers columns [out_col * bn, out_col * bn + bn) clipped to n.  pred:
// int32 device flag or null.
extern "C" int spdmm_fused_f32(const void* a_blocks, const void* y,
                               const void* a_ids, const void* y_rows,
                               const void* out_rows, const void* out_cols,
                               const void* first, int n_entries, void* z,
                               int block, int bn, int ldy, int ldz, int m,
                               int n, const void* pred, int when,
                               void* stream) {
  if (n_entries == 0 || bn == 0) return 0;
  Walk p{};
  p.a_blocks = (const float*)a_blocks;
  p.y = (const float*)y;
  p.a_ids = (const int*)a_ids;
  p.y_rows = (const int*)y_rows;
  p.out_rows = (const int*)out_rows;
  p.out_cols = (const int*)out_cols;
  p.first = (const int*)first;
  p.z = (float*)z;
  p.pred = (const int*)pred;
  p.when = when;
  p.n_entries = n_entries;
  p.bn = bn;
  p.ldy = ldy;
  p.ldz = ldz;
  p.m = m;
  p.n = n;
  return walk(p, block, true, (cudaStream_t)stream);
}

// blocks (nnzb, B, B), y (Kp, n), z (m, n): f32 row-major contiguous;
// row_ids / col_ids / first int32 (nnzb,), sorted by block row.
extern "C" int spdmm_f32(const void* blocks, const void* y,
                         const void* row_ids, const void* col_ids,
                         const void* first, int nnzb, void* z, int block,
                         int m, int n, void* stream) {
  if (nnzb == 0 || n == 0) return 0;
  Walk p{};
  p.a_blocks = (const float*)blocks;
  p.y = (const float*)y;
  p.y_rows = (const int*)col_ids;
  p.out_rows = (const int*)row_ids;
  p.first = (const int*)first;
  p.z = (float*)z;
  p.n_entries = nnzb;
  p.bn = n;
  p.ldy = n;
  p.ldz = n;
  p.m = m;
  p.n = n;
  return walk(p, block, false, (cudaStream_t)stream);
}
