// K12: the packed non-resident engine's history probe over W-word keys.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   _dict_history_search (:1445), i.e. ops/lex.py
//   searchsorted_words_2sided_fp (:81), run against the base and the delta
//   of the two-level history (or one flat state);
//   _history_conflict_ranges_hist_packed (:1597) and the flat
//   _history_conflict_ranges_packed (:1458) with too_old_mask_packed
//   (:1425): read slots gather their bounds by rank, the range max over the
//   base from its K2 table and over the per-batch level from a table built
//   here over its live rows.
//
// Bound on the H100: dependent-load latency, not bytes. Every search walks
// a chain of loads whose next address depends on the last compare; the
// bytes are small (a batch's 49,153 dictionary rows of W = 4 words are 0.8
// MB, the read plane's 341 query rows 12 KB), the live rows a search could
// read at most 16 MB at C = 2^20 and W = 4. The work's own bound is the
// queries and outputs plus the rows any exact search must read.
//
// Design of the search (wp_search, one launch a call; a block answers its
// tile of queries against both histories of the two-history form):
// - Live prefix. Given a live count n (a 0-dim device int, read by the
//   kernel: the wrapper never syncs), only rows [0, n) are searched. Rows
//   past n are all INT32_MAX words in every state the caller trusts (see
//   tests/test_torch_live_prefix.py), and no word exceeds INT32_MAX, so
//   only a query of all INT32_MAX words reaches them: its right bound is
//   c and its left bound the first such row in [0, n), or n. Every other
//   query's bounds lie in [0, n]. Without a count, n = c. (The smoke's
//   non-resident histories hold about 10^4 live rows of 2^20.)
// - Group search. A block has 4 warps and a tile of T queries (a power of
//   two, 4..128); a warp's T/4 queries each get a group of g = 128/T
//   lanes. At each step the g lanes of a group compare g pivots spread
//   evenly over the group's range and one __ballot_sync picks the
//   sub-range: a (g+1)-ary search, 4 steps for 2^20 rows at g = 32 (one
//   query a warp) instead of ~21. The right bound starts at the left one
//   and gallops (windows of g, g(g+1), ... rows, the last pivot at the
//   window's end, then the same search inside the window that holds it):
//   a run of equal rows costs O(log run) steps, and the 0-2 row runs of a
//   history one step. Four words of a row load at once (cmp_row): the
//   read plane's keys share a long prefix.
// - Direct tiles (T = 4 or 8, the wrapper's choice while the grid fits
//   one wave: the read plane's 341 rows, a paint's 16,384) search [0, n).
// - Span tiles (T >= 16; the wrapper's 128 past that: the engine's 49,153
//   dictionary rows) stage their query rows in shared memory when there
//   is room, take the first and last row as the minimum and maximum when
//   the tile is sorted (one compare a thread shows it; else warp 0
//   reduces), and find their bounds in [0, n) of each history (warps 2x
//   and 2x + 1 for history x, g = 32, all at once): every answer of the
//   tile lies in that span [L, R]. If a span's rows fit in what is left of
//   the dynamic shared memory (sized by the wrapper for a sorted tile
//   spread evenly, twice over, within one wave's share of the SM's 228
//   KB), the block stages them with cp.async (16 bytes where aligned) and
//   a thread answers each query there alone ("staged": in shared memory a
//   step's load is cheap and a group's ballots and shuffles are not);
//   otherwise the groups search the span in global memory ("global":
//   unsorted rows). A span search costs about as many dependent steps as
//   it saves, so it pays only when the tile's rows are staged.
//   Each branch is exact; a stats array, when given, counts each block's
//   branch for each history (WP_DIRECT, WP_STAGED, WP_GLOBAL).
// What is left is latency: on the engine's step a block's chain (the
//   span search, the staging, the staged searches) is most of its time.
// Rows compare as W signed int32 words (the packing bias makes that the
// key byte order). The JAX search narrows one word column at a time, a
// cascade built for the TPU's vector gathers; the answers are the same.
//
// The probe (wp_probe, the sparse arm's; K17's rb_probe is the blocked
// arm's): the packed engines' history probe by rank, over a two-level
// history (the base with its prebuilt K2 table, and the delta) or a flat
// one (the level alone: the flat history, the speculation scratch). The
// per-batch level gets a range-max table over its live rows only, in one
// launch, with its n_used read on the device: live_probe.cuh's lp_build at
// one history (windowed-max levels 1..8 over the live rows and a sparse
// table over the 256-row block maxima, built by the column's last block),
// in place of K2's ~21 levels over every row of the level, every batch (a
// flat history's 2^20). Its query is at most four independent loads, and
// the table keeps the sparse arm the sparse-table design beside K17's
// blocked arm. Then live_probe.cuh's level probe (the kernel K17's
// rb_probe runs, with this table as its range max): a transaction's R
// slots on adjacent lanes, each slot's bounds gathered by rank from the
// search, the end clamped to the live count, the base's range max from
// its K2 table; the OR and the too-old test by shuffles over the lanes.
// Two CUDA kernels a call.

#include <cuda_runtime.h>
#include <stdint.h>

#include "live_probe.cuh"

#define NEG_VERSION (-2147483647)
#define I32MAX 2147483647
#define FULL 0xffffffffu
#define WP_THREADS 128
#define WP_WARPS (WP_THREADS / 32)
enum { WP_DIRECT, WP_STAGED, WP_GLOBAL };

// Asynchronous copies into shared memory (cp.async): a thread issues all
// of its copies before it waits, so the staging costs one round trip.
__device__ __forceinline__ void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async16(int* dst, const int* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// -1, 0 or 1 as row a is below, equal to or above row q (w signed words).
// Four words of each row are loaded at once, before any compare: keys
// with a long common prefix (the read plane's "ycsb/000...") would
// otherwise cost one dependent load a word.
__device__ __forceinline__ int cmp_row(const int* a, const int* q, int w) {
  for (int j = 0; j < w; j += 4) {
    int x[4], y[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      x[k] = j + k < w ? a[j + k] : 0;
      y[k] = j + k < w ? q[j + k] : 0;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (x[k] != y[k]) return x[k] < y[k] ? -1 : 1;
  }
  return 0;
}

// Pivot k of g over [lo, lo + m): a window's end at the last pivot (win),
// else g + 1 even parts; every row when m <= g. One 32-bit division (the
// product fits below 2^32 for m < 2^27; larger ranges take 64 bits).
__device__ __forceinline__ int pivot(int lo, int m, int k, int g, bool win) {
  if (m <= g) return lo + k;
  if (win) return lo + (int)(((long long)(k + 1) * m) >> (31 - __clz(g))) - 1;
  if (m < (1 << 27))
    return lo + (int)((unsigned)(k + 1) * (unsigned)m / (unsigned)(g + 1));
  return lo + (int)((long long)(k + 1) * m / (g + 1));
}

// Every group of g lanes (g a power of two; the group of lane l is l / g)
// finds, for its own query q and range [lo, hi), the first row that is
// above q (upper) or not below it (!upper), or hi. Row i lies at rows +
// (i - off) * w. With gallop the group first scans windows of g, g(g+1),
// ... rows from lo. All 32 lanes call it; groups with !active idle. Each
// lane computes its own pivot; the group reads the ones it needs from
// their lanes (shuffles).
__device__ int group_search(const int* rows, int off, int lo, int hi,
                            const int* q, int w, int g, bool upper,
                            bool gallop, bool active) {
  const int lane = threadIdx.x & 31;
  const int k = lane & (g - 1);
  const int base = lane & ~(g - 1);
  const unsigned gmask = g == 32 ? FULL : ((1u << g) - 1u) << base;
  bool go = active && lo < hi;
  int len = g;
  while (__any_sync(FULL, go)) {
    const bool win = gallop && go;
    const int end = (win && hi - lo > len) ? lo + len : hi;
    const int m = end - lo;
    const int p = pivot(lo, m, k, g, win);
    bool pass = false;
    if (go && k < (m < g ? m : g)) {
      const int c = cmp_row(rows + (long long)(p - off) * w, q, w);
      pass = upper ? c > 0 : c >= 0;
    }
    const unsigned b = (__ballot_sync(FULL, pass) & gmask) >> base;
    const int f = b ? __ffs(b) - 1 : g - 1;
    const int pf = __shfl_sync(FULL, p, base + f);
    const int pprev = __shfl_sync(FULL, p, base + (f ? f - 1 : 0));
    if (go) {
      if (b) {  // the first passing pivot f: the answer is in (p[f-1], p[f]]
        lo = f ? pprev + 1 : lo;
        hi = pf;
        gallop = false;
      } else if (win || m <= g) {  // every row of [lo, end) fails
        lo = end;
        len = len > (1 << 24) ? (1 << 30) : len * (g + 1);
      } else {
        lo = pf + 1;  // past the last pivot
      }
      go = lo < hi;
    }
  }
  return lo;
}

// group_search at g = 1 by one thread alone (no ballots, no shuffles): the
// same pivots (the midpoint; with gallop, windows of 1, 2, 4, ... rows
// tested at their ends), so it reads the same rows. The staged branch's
// search, where loads are cheap and instructions are not.
__device__ int thread_search(const int* rows, int off, int lo, int hi,
                             const int* q, int w, bool upper, bool gallop) {
  int len = 1;
  while (lo < hi) {
    const int end = (gallop && hi - lo > len) ? lo + len : hi;
    const int m = end - lo;
    const int p = m <= 1 ? lo : (gallop ? end - 1 : lo + (m >> 1));
    const int c = cmp_row(rows + (long long)(p - off) * w, q, w);
    if (upper ? c > 0 : c >= 0) {
      hi = p;
      gallop = false;
    } else if (gallop || m <= 1) {
      lo = end;
      len = len > (1 << 24) ? (1 << 30) : 2 * len;
    } else {
      lo = p + 1;
    }
  }
  return lo;
}

// The live row count of a history: *live clamped to [0, c], else c.
__device__ __forceinline__ int live_rows(const int* live, int c) {
  if (!live) return c;
  const int n = *live;
  return n < 0 ? 0 : (n > c ? c : n);
}

// Stages n ints from src into shared dst with cp.async (16 bytes a copy
// when both are aligned and n is a multiple of 4); the caller waits.
__device__ __forceinline__ void stage(int* dst, const int* src, int n) {
  if ((((uintptr_t)src | (uintptr_t)dst) & 15) == 0 && (n & 3) == 0) {
    for (int i = 4 * threadIdx.x; i < n; i += 4 * WP_THREADS)
      cp_async16(dst + i, src + i);
  } else {
    for (int i = threadIdx.x; i < n; i += WP_THREADS)
      cp_async4(dst + i, src + i);
  }
}

// One block a tile of `tile` dictionary rows, against every history (one
// or two). smem: the dynamic shared bytes (the span path's tile rows
// first, when they fit, then span rows).
__global__ void __launch_bounds__(WP_THREADS)
k_search(const int* keys0, int c0, const int* live0, const int* keys1,
         int c1, const int* live1, const int* dict, int n1, int w, int tile,
         int smem, int* ls0, int* rs0, int* ls1, int* rs1, int* stats) {
  extern __shared__ int s_dyn[];
  __shared__ int s_span[6];  // min row, max row, then L and R a history
  const int h = keys1 ? 2 : 1;
  const int* keys[2] = {keys0, keys1};
  const int cs[2] = {c0, c1};
  const int ns[2] = {live_rows(live0, c0), keys1 ? live_rows(live1, c1) : 0};
  int* ls[2] = {ls0, ls1};
  int* rs[2] = {rs0, rs1};
  const int t0 = blockIdx.x * tile;
  const int nt = min(tile, n1 - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per_warp = tile / WP_WARPS;
  const int g = 32 / per_warp;
  const bool span = per_warp > 2;
  // The tile's query rows: staged first on the span path when they fit.
  const bool q_staged = span && smem >= tile * w * 4;
  int* s_rows = s_dyn + (q_staged ? tile * w : 0);
  const int smem_rows = (smem - (q_staged ? tile * w * 4 : 0)) / (4 * w);
  const int* tq = dict + (long long)t0 * w;
  if (q_staged) {
    stage(s_dyn, tq, nt * w);
    cp_async_wait_all();
    __syncthreads();
    tq = s_dyn;
  }
  const int slot = warp * per_warp + lane / g;
  const bool active = slot < nt;
  const int u = t0 + (active ? slot : 0);
  const int* q = tq + (long long)(u - t0) * w;
  bool top = active;  // a query of all INT32_MAX words: its right bound is c
  for (int j = 0; j < w && top; ++j) top = q[j] == I32MAX;
  // Per history: the rows searched (global, or staged at off), the range.
  const int* rows[2] = {keys0, keys1};
  int off[2] = {0, 0}, lo[2] = {0, 0}, hi[2] = {ns[0], ns[1]};
  int branch[2] = {WP_DIRECT, WP_DIRECT};
  if (span) {
    // The tile's lexicographic minimum and maximum: its first and last row
    // when it is sorted (the engine's dictionary; one compare a thread
    // shows it), else a reduction by warp 0.
    const int t = threadIdx.x;
    const bool sorted = __syncthreads_and(
        t + 1 >= nt ||
        cmp_row(tq + (long long)t * w, tq + (long long)(t + 1) * w, w) <= 0);
    if (sorted && t == 0) {
      s_span[0] = 0;
      s_span[1] = nt - 1;
    }
    if (!sorted && warp == 0) {
      int mn = lane < nt ? lane : 0, mx = mn;
      for (int i = lane + 32; i < nt; i += 32) {
        const int* r = tq + (long long)i * w;
        if (cmp_row(r, tq + (long long)mn * w, w) < 0) mn = i;
        if (cmp_row(r, tq + (long long)mx * w, w) > 0) mx = i;
      }
      for (int s = 16; s; s >>= 1) {
        const int a = __shfl_down_sync(FULL, mn, s);
        const int b = __shfl_down_sync(FULL, mx, s);
        if (cmp_row(tq + (long long)a * w, tq + (long long)mn * w, w) < 0)
          mn = a;
        if (cmp_row(tq + (long long)b * w, tq + (long long)mx * w, w) > 0)
          mx = b;
      }
      if (lane == 0) {
        s_span[0] = mn;
        s_span[1] = mx;
      }
    }
    __syncthreads();
    // Warp 2x + 1 finds history x's R (the maximum's right bound), warp 2x
    // its L (the minimum's left bound), all at once.
    if (warp < 2 * h) {
      const int right = warp & 1;
      const int b = group_search(warp >> 1 ? keys1 : keys0, 0, 0,
                                 warp >> 1 ? ns[1] : ns[0],
                                 tq + (long long)s_span[right] * w, w, 32,
                                 right, false, true);
      if (lane == 0) s_span[2 + warp] = b;
    }
    __syncthreads();
    int used = 0;  // staged rows so far
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (x == h) break;
      lo[x] = s_span[2 + 2 * x];
      hi[x] = s_span[3 + 2 * x];
      branch[x] = WP_GLOBAL;
      if (hi[x] - lo[x] > smem_rows - used) continue;
      int* dst = s_rows + (long long)used * w;
      stage(dst, keys[x] + (long long)lo[x] * w, (hi[x] - lo[x]) * w);
      rows[x] = dst;
      off[x] = lo[x];
      branch[x] = WP_STAGED;
      used += hi[x] - lo[x];
    }
    cp_async_wait_all();
    __syncthreads();
  }
  // A staged history: thread t answers query t0 + t alone. Otherwise the
  // groups answer theirs.
  const bool t_active = threadIdx.x < nt;
  const int* tqt = tq + (long long)(t_active ? threadIdx.x : 0) * w;
  bool t_top = t_active;
  for (int j = 0; j < w && t_top; ++j) t_top = tqt[j] == I32MAX;
#pragma unroll
  for (int x = 0; x < 2; ++x) {
    if (x == h) break;
    if (branch[x] == WP_STAGED) {
      if (t_active) {
        const int left = thread_search(rows[x], off[x], lo[x], hi[x], tqt, w,
                                       false, false);
        ls[x][t0 + threadIdx.x] = left;
        rs[x][t0 + threadIdx.x] =
            t_top ? cs[x]
                  : thread_search(rows[x], off[x], left, hi[x], tqt, w, true,
                                  true);
      }
    } else {
      const int left = group_search(rows[x], off[x], lo[x], hi[x], q, w, g,
                                    false, false, active);
      const int right = group_search(rows[x], off[x], left, hi[x], q, w, g,
                                     true, true, active && !top);
      if (active && (lane & (g - 1)) == 0) {
        ls[x][u] = left;
        rs[x][u] = top ? cs[x] : right;
      }
    }
    if (stats && threadIdx.x == 0) atomicAdd(stats + branch[x], 1);
  }
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

// (ls, rs) of every dictionary row in keys0 and, when keys1 is given, in
// keys1. live0/live1: 0-dim live row counts or null (every row live).
// tile, smem: the wrapper's plan (kernels.word_search_plan). stats: int32
// [3] block counts by branch, or null. The CUDA kernels launched (one, or
// none for no rows) are counted into *launched when given.
extern "C" int wp_search(const int* keys0, int c0, const int* live0,
                         const int* keys1, int c1, const int* live1,
                         const int* dict, int n1, int w, int tile, int smem,
                         int* ls0, int* rs0, int* ls1, int* rs1, int* stats,
                         int* launched, cudaStream_t s) {
  if (launched) *launched = 0;
  if (n1 <= 0) return (int)cudaGetLastError();
  if (tile < WP_WARPS || tile > 32 * WP_WARPS || (tile & (tile - 1)) ||
      w <= 0)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k_search, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  k_search<<<blocks(n1, tile), WP_THREADS, smem, s>>>(
      keys0, c0, live0, keys1, c1, live1, dict, n1, w, tile, smem, ls0, rs0,
      ls1, rs1, stats);
  if (launched) *launched = 1;
  return (int)cudaGetLastError();
}

// The probe of one level of n rows (vals, n_used its 0-dim live count)
// by the bounds rs_d/ls_d, and of a base when bst (its K2 table [lb, cb])
// is given, by rs_b/ls_b: the bounds indexed by the slot, or through
// idx_b/idx_e (the slots' dictionary ranks [B, R]) when given. A slot is
// live when its mask is set and rows_b < rows_e ([B, R, w] rows, ranks at
// w = 1). lv: the live table's scratch (kernels.live_table_words(1, n)
// words), tickets: one zeroed word (left zeroed). Two CUDA kernels (the
// level's live table, the probe), counted into *launched.
extern "C" int wp_probe(const int* bst, int cb, int lb, const int* rs_b,
                        const int* ls_b, const int* vals, int n,
                        const int* n_used, const int* rs_d, const int* ls_d,
                        const int* idx_b, const int* idx_e,
                        const int* rows_b, const int* rows_e, int w,
                        const bool* rmask, const int* rv, const bool* tmask,
                        const int* floor_p, int B, int R, int* lv,
                        int* tickets, bool* hist_mask, bool* too_old,
                        bool* cand, int* launched, cudaStream_t s) {
  *launched = 0;
  if (B <= 0) return (int)cudaGetLastError();
  if (n <= 0 || R <= 0) return (int)cudaErrorInvalidValue;
  int* top = lv + (int64_t)LP_LV * n;
  int gx = (n + LP_OWN - 1) / LP_OWN;
  if (gx > LP_BUILD_GRID) gx = LP_BUILD_GRID;
  lp_build<<<dim3(gx, 1), LP_BUILD_THREADS, 0, s>>>(vals, n_used, 1, n, lv,
                                                    top, tickets);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  LpLevelArgs g{bst, cb, lb, rs_b, ls_b, n_used, n, rs_d, ls_d, idx_b,
                idx_e, rows_b, rows_e, w, rmask, rv, tmask, floor_p, B, R, 1,
                hist_mask, too_old, cand};
  const int rc = lp_level_probe_launch(
      g, LpTableMax{vals, lv, top, nullptr, 1, n}, s);
  *launched = 2;
  return rc;
}
