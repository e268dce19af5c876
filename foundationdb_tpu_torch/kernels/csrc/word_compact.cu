// K13: step-function rewrites over W-word keys — the packed paint, the
// base+delta fold and the dedup + compaction, and the unpacked paint (its
// new endpoint rows and its sorted paint).
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   _paint_and_compact_packed (:1489) -> _paint_tail (:925), as run by
//   resolve_batch_hist_packed (:1634), wave_apply_batch_hist_packed
//   (:2501), paint_batch_hist_packed (:2732) and _spec_mark_rejected
//   (:2854);
//   _merge_delta (:1243) at width W, as run by _maybe_merge (:1290), with
//   its decision and _reset_delta (:1229), and by advance_hist (:1404);
//   _dedup_compact (:977) over [n, W] rows;
//   _paint_and_compact (:869) -> _paint_tail (:925), the unpacked flat
//   paint (wc_paint_keys, wc_paint_sorted), as run by resolve_batch
//   (:1108) and parallel/sharded_resolver.py _sharded_resolve (:160).
//
// Bound on the H100: bytes. A paint touches the live rows of its level
// and 2BQ new rows; a fold reads the live rows of base and delta and
// rewrites the base's (C = 2^20, W = 4, a full base: ~40 MB); a gated step
// whose fold is not needed reads the base versions once (the decision).
// What is left is the tiles' chains of dependent loads and the launches.
//
// Live rows. Every row of a history at or past n_used holds (+inf,
// NEG_VERSION) (every writer leaves it so; tests/test_torch_live_prefix.py
// checks it). Such rows change nothing in a merge but the forced row when
// every key is +inf, which any +inf row then stands for; so every rewrite
// here merges the live rows [0, n_used) (read on the device) only, and its
// work is in proportion to the live rows, not to C.
//
// The sorted paint (wc_paint_sorted: K4's second design at width W,
// step_compact.cu): new row k sits at merged position k + min(its cross
// rank, n_used) (history rows before equal new rows, the JAX merge order),
// so a tile of 256 merged rows (one a thread: small tiles spread over more
// SMs) finds its new rows by one search over those positions, marks their
// slots, and fills the others from the history in order; nothing merged
// is written to device memory. Persistent blocks take tiles by ticket
// until the live merged length is covered. Two sums cross tiles by a
// decoupled look-back: the coverage before the tile and the survivors
// before it. The dedup needs, for the tile's first run of equal keys, the
// version of the row before the run: the run starts at the tile unless the
// row before the tile has its key, and then one lower-bound search in each
// input finds its start; the coverage there is the tile's less the deltas
// of the run's new rows before the tile. The forced row is the last of the
// minimum key's run (the last row when every key is +inf). Survivors land
// in a scratch buffer; a second launch copies them back, writes (+inf,
// NEG_VERSION) over [new n_used, old n_used) only, n_used, the sticky
// overflow and oldest, and re-zeroes the look-back words and the ticket
// (K4's workspace, step_compact.cu's layout).
//
// The packed paint (wc_paint, three launches): its new rows are already in
// key order. paint_src is the stable argsort of the write endpoints'
// dictionary ranks, the dictionary is sorted, and each endpoint's cross
// rank into the level is rs[rank] (K12's right search). One small launch
// gathers them (row k: the dictionary row of rank(paint_src[k]), coverage
// delta +1/-1, 0 for a rejected or empty write, cross rank rs[rank]) into
// the workspace; the sorted paint's two launches follow. The gather costs
// one coalesced pass over 2BQ rows; reading through the indirection inside
// the tiles instead would put three dependent loads (paint_src, the slot's
// rank, rs or the dictionary row) into every step of their merge-path
// searches. A rejected write stays a no-op endpoint at its own key (delta
// 0): the new rows stay sorted, the dedup drops it or keeps it as the last
// row of a run with the version that run's last row has anyway, so the
// state is the one the JAX paint leaves by parking it on the +inf row
// wherever the level's first row is at or below every endpoint, as the
// minimum-key row every engine's history keeps is.
//
// The fold (wc_fold, wc_fold_step) and the compaction (wc_compact): the
// same tiles over the stable merge of two sorted inputs, base before equal
// delta rows (K4's M_FOLD mode at width W): a tile finds where its slices
// start by one merge-path diagonal search at each end (a warp, 32 pivots a
// step), stages the slices in shared memory and merges them there, a
// thread a merged row. A merged row's version is the max of the two step
// functions there (its own value and the other input's last row before it,
// a halo row from before the tile when there is none in the tile), GC'd to
// the floor; then the dedup, the forced row and the survivors' look-back
// as in the paint (no coverage). The finish writes the base back over its
// live rows, and resets the delta to its minimum-key row at the floor over
// the delta's live rows: _maybe_merge's reset, in the same call. The
// gated step (wc_fold_step) is three launches: K4's decision
// (fold_need.cuh), the tiles and the finish, both exiting at once when the
// decision is False. The compaction is the A-only mode out of place, its
// versions given (no GC).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fold_need.cuh"
#include "lookback.cuh"

#define I32MAX 2147483647
#define NEG_VERSION (-2147483647)
#define NEG_M1 (-2147483647 - 1)

__device__ __forceinline__ const int* row(const int* a, int64_t i, int w) {
  return a + i * w;
}

// -1, 0, 1: lexicographic order of two w-word rows (signed words).
__device__ __forceinline__ int cmp_row(const int* a, const int* b, int w) {
  for (int j = 0; j < w; ++j)
    if (a[j] != b[j]) return a[j] < b[j] ? -1 : 1;
  return 0;
}

__device__ __forceinline__ bool is_inf(const int* a, int w) {
  for (int j = 0; j < w; ++j)
    if (a[j] != I32MAX) return false;
  return true;
}

__device__ __forceinline__ void copy_row(int* dst, const int* src, int w) {
  for (int j = 0; j < w; ++j) dst[j] = src[j];
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

// ------------------------------------------------- the unpacked paint

// The unpacked flat paint (the JAX _paint_and_compact, :869): the 2BQ new
// endpoint rows of the accepted writes, begins then ends, a rejected or
// empty write parked on the +inf row with coverage delta 0.
__global__ void k_paint_keys(const int* wb, const int* we, const bool* wmask,
                             const bool* accepted, int B, int Q, int w,
                             int* keys, int* delta) {
  int e2 = B * Q;
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2 * e2) return;
  bool is_begin = k < e2;
  int slot = is_begin ? k : k - e2;
  const int* a = row(wb, slot, w);
  const int* z = row(we, slot, w);
  bool valid = accepted[slot / Q] && wmask[slot] && cmp_row(a, z, w) < 0;
  const int* src = is_begin ? a : z;
  for (int j = 0; j < w; ++j) keys[(int64_t)k * w + j] = valid ? src[j] : I32MAX;
  delta[k] = valid ? (is_begin ? 1 : -1) : 0;
}

// keys [B*Q*2, w] and delta [B*Q*2] of the accepted writes wb/we [B, Q, w].
extern "C" int wc_paint_keys(const int* wb, const int* we, const bool* wmask,
                             const bool* accepted, int B, int Q, int w,
                             int* keys, int* delta, cudaStream_t s) {
  const int T = 256;
  if (B * Q > 0)
    k_paint_keys<<<blocks(2 * B * Q, T), T, 0, s>>>(wb, we, wmask, accepted,
                                                    B, Q, w, keys, delta);
  return (int)cudaGetLastError();
}


// ------------------------------------------- the sorted paint: live tiles

#define PT 256            // threads a paint tile
#define STAGE 8           // loads in flight a thread
#define SMEM_DYN 231424   // dynamic shared memory a tile may use (227 KB
                          // less 1 KB for the static arrays)
#define WS_TICKET 0       // workspace words (uint64), step_compact.cu's head
#define WS_TOTAL 3        // (1 and 2: the fold's decision, fold_need.cuh)
#define WS_LIVE 4
#define WS_NTILES 5
#define WS_DLIVE 6        // the fold: the delta's live rows before it
#define WS_WORDS 8        // then ntiles coverage words, ntiles count words

struct SortedPaint {
  const int* hk;  // the history [c, w] and its versions (read only here)
  const int* hv;
  int c, w;
  const int* n_used;
  const int* nk;  // the sorted new rows [n2, w], their deltas, cross ranks
  const int* nd;
  const int* nx;
  int n2;
  int cv;
  const int* floor_p;
  int ntiles;  // tiles of c + n2 rows: the span of each look-back array
  int* sk;     // the survivors' scratch [c, w], [c]
  int* sv;
  u64* ws;
};

// Merged position of new row k: k plus the live history rows before it.
__device__ __forceinline__ int npos(const SortedPaint& p, int k, int nu) {
  return k + min(p.nx[k], nu);
}

// Merged row a + b, given a history and b new rows before it.
__device__ __forceinline__ const int* merged_row(const SortedPaint& p,
                                                 int nu, int a, int b) {
  return b < p.n2 && npos(p, b, nu) == a + b ? p.nk + (int64_t)b * p.w
                                             : p.hk + (int64_t)a * p.w;
}

// Merged row a + b - 1, given a history and b new rows before row a + b.
__device__ __forceinline__ const int* row_before(const SortedPaint& p,
                                                 int nu, int a, int b) {
  return b > 0 && min(p.nx[b - 1], nu) == a ? p.nk + (int64_t)(b - 1) * p.w
                                            : p.hk + (int64_t)(a - 1) * p.w;
}

__device__ __forceinline__ int gcw(int v, bool inf, int fl) {
  return (v <= fl || inf) ? NEG_VERSION : v;
}

// The merge of the history's live rows [0, n_used) with the n2 sorted new
// rows, painted, GC'd, deduped and compacted by tiles of PT merged rows;
// the survivors into the scratch. Persistent blocks take tiles by ticket
// until the live merged length (read on the device) is covered.
__global__ void __launch_bounds__(PT) k_sorted_tiles(SortedPaint p) {
  extern __shared__ int sm[];
  const int w = p.w, T = PT;
  int* s_key = sm;           // [T, w] the tile's merged keys
  int* s_val = sm + T * w;   // [T] the new rows' slots, then the versions
  int* s_src = s_val + T;    // [T] each merged row's source
  int* s_k0 = s_src + T;     // [w] merged row 0
  int* s_next = s_k0 + w;    // [w] the row after the tile
  __shared__ int s_scan[32];
  __shared__ int s_m[16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nu = min(max(*p.n_used, 1), p.c), n2 = p.n2, n = nu + n2;
  const int nt = (n + T - 1) / T;
  const int fl = *p.floor_p;
  for (;;) {
    if (tid == 0) s_m[0] = (int)atomicAdd(p.ws + WS_TICKET, 1ull);
    __syncthreads();
    const int t = s_m[0];
    if (t >= nt) return;
    if (t == 0 && tid == 0) {
      p.ws[WS_LIVE] = (u64)nu;
      p.ws[WS_NTILES] = (u64)nt;
    }
    const int d0 = t * T, d1 = min(n, d0 + T), len = d1 - d0;

    // The new rows before each end of the tile (their positions increase).
    if (warp < 2) {
      const int diag = warp ? d1 : d0;
      int b = warp_search(0, n2, [&](int k) { return npos(p, k, nu) < diag; });
      if (lane == 0) s_m[1 + warp] = b;
    }
    __syncthreads();
    const int b0 = s_m[1], b1 = s_m[2], a0 = d0 - b0;
    const int lb = b1 - b0;
    for (int j = tid; j < lb; j += PT) s_val[j] = npos(p, b0 + j, nu) - d0;
    __syncthreads();

    // Each thread's merged row r: its source (history row h, or new row ~k,
    // into s_src), its coverage delta and its version before the paint.
    const int r = tid;
    int dc = 0, pre = NEG_VERSION;
    if (r < len) {
      int lo = 0, hi = lb;  // the tile's new rows before r
      while (lo < hi) {
        int mid = (lo + hi) >> 1;
        if (s_val[mid] < r) lo = mid + 1; else hi = mid;
      }
      const int h = a0 + r - lo;  // history rows before merged row d0 + r
      if (lo < lb && s_val[lo] == r) {
        s_src[r] = ~(b0 + lo);
        dc = p.nd[b0 + lo];
        pre = p.hv[max(h - 1, 0)];
      } else {
        s_src[r] = h;
        pre = p.hv[h];
      }
    }
    __syncthreads();  // every slot read: s_val is free

    // The keys, coalesced, STAGE loads in flight a thread.
    for (int e0 = tid; e0 < len * w; e0 += PT * STAGE) {
      int x[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int e = e0 + u * PT;
        x[u] = 0;
        if (e < len * w) {
          const int i = e / w, q = s_src[i];
          x[u] = (q >= 0 ? p.hk + (int64_t)q * w
                         : p.nk + (int64_t)(~q) * w)[e - i * w];
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u)
        if (e0 + u * PT < len * w) s_key[e0 + u * PT] = x[u];
    }
    if (warp == 0) {
      // Where the tile's first run of equal keys starts (the tile's start,
      // unless merged row d0 - 1 has its key: then one search in each
      // input), and the row before that run.
      const int* fk = merged_row(p, nu, a0, b0);
      int fa = a0, fb = b0;
      if (d0 > 0 && cmp_row(row_before(p, nu, a0, b0), fk, w) == 0) {
        fa = warp_search(0, nu, [&](int m) {
          return cmp_row(p.hk + (int64_t)m * w, fk, w) < 0;
        });
        fb = warp_search(0, n2, [&](int m) {
          return cmp_row(p.nk + (int64_t)m * w, fk, w) < 0;
        });
      }
      if (lane == 0) {
        s_m[3] = fa + fb;
        s_m[4] = fb;
        s_m[5] = p.hv[max(fa - 1, 0)];  // its version before the paint
        s_m[6] = fa + fb > 0 && is_inf(row_before(p, nu, fa, fb), w);
      }
    } else if (warp == 1) {
      const int* k0 = merged_row(p, nu, 0, 0);
      for (int q = lane; q < w; q += 32) s_k0[q] = k0[q];
      if (d1 < n) {
        const int* after = merged_row(p, nu, d1 - b1, b1);
        for (int q = lane; q < w; q += 32) s_next[q] = after[q];
      }
    }
    __syncthreads();

    // The coverage: the tile's, after the look-back; at the row before the
    // first run, less the deltas of that run's rows before the tile.
    const int fs = s_m[3], fb = s_m[4];
    int part = 0;
    for (int k = fb + tid; k < b0; k += PT) part += p.nd[k];
    int run_cov, agg;
    block_excl_sum(part, s_scan, &run_cov);
    const int th = block_excl_sum(dc, s_scan, &agg);
    if (warp == 0) {
      int e = look_back(p.ws + WS_WORDS, t, agg);
      if (lane == 0) s_m[7] = e;
    }
    __syncthreads();
    const int cov_excl = s_m[7];
    const int* key = s_key + r * w;
    int v = NEG_VERSION;
    if (r < len) {
      v = gcw(cov_excl + th + dc > 0 ? p.cv : pre, is_inf(key, w), fl);
      s_val[r] = v;
    }
    if (tid == 0)
      s_m[8] = fs == 0 ? NEG_M1
                       : gcw(cov_excl - run_cov > 0 ? p.cv : s_m[5],
                             s_m[6], fl);
    __syncthreads();

    // Dedup: the last row of each run stays unless its version equals the
    // previous run's last row's; the minimum key's last row is forced.
    const bool k0_inf = is_inf(s_k0, w), has_next = d1 < n;
    const int start = r > 0 && r < len && cmp_row(key, key - w, w) != 0
                          ? r : -1;
    const int st = max(block_excl_max(start, s_scan), start);
    bool keep = false;
    if (r < len) {
      bool keep1 = r + 1 < len ? cmp_row(key, key + w, w) != 0
                               : (!has_next || cmp_row(key, s_next, w) != 0);
      int prev = st < 0 ? s_m[8] : s_val[st - 1];
      bool forced = !k0_inf ? (keep1 && cmp_row(key, s_k0, w) == 0)
                            : (d0 + r == n - 1);
      keep = forced || (keep1 && v != prev && !is_inf(key, w));
    }
    int agg2;
    const int idx = block_excl_sum(keep, s_scan, &agg2);
    if (warp == 0) {
      int e = look_back(p.ws + WS_WORDS + p.ntiles, t, agg2);
      if (lane == 0) {
        s_m[9] = e;
        if (t == nt - 1) p.ws[WS_TOTAL] = (u64)(e + agg2);
      }
    }
    __syncthreads();
    if (keep && s_m[9] + idx < p.c) {
      copy_row(p.sk + (int64_t)(s_m[9] + idx) * w, key, w);
      p.sv[s_m[9] + idx] = v;
    }
    __syncthreads();  // before the next tile reuses shared memory
  }
}

// The survivors back into the history, (+inf, NEG_VERSION) over [new
// n_used, old n_used) (every row past the old n_used already holds it),
// n_used, the sticky overflow and oldest; the look-back words and the
// ticket re-zeroed for the next call.
__global__ void k_sorted_finish(int* hk, int* hv, int c, int w, int* n_used,
                                bool* overflow, int* oldest,
                                const int* floor_p, const int* sk,
                                const int* sv, u64* ws, int ntiles) {
  const int total = (int)ws[WS_TOTAL];
  const int nold = (int)ws[WS_LIVE], nt = (int)ws[WS_NTILES];
  const int nnew = min(total, c);
  const int span = max(max(nnew, nold), nt);
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < span;
       j += gridDim.x * blockDim.x) {
    if (j < nnew) {
      copy_row(hk + (int64_t)j * w, sk + (int64_t)j * w, w);
      hv[j] = sv[j];
    } else if (j < nold) {
      for (int q = 0; q < w; ++q) hk[(int64_t)j * w + q] = I32MAX;
      hv[j] = NEG_VERSION;
    }
    if (j < nt) {
      ws[WS_WORDS + j] = 0;
      ws[WS_WORDS + ntiles + j] = 0;
    }
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *n_used = nnew;
    *overflow = *overflow || total > c;
    *oldest = *floor_p;
    ws[WS_TICKET] = 0;
  }
}


// ------------------------------------------- the packed paint's new rows

// Row k of the packed paint's sorted new rows (k in paint_src order): the
// dictionary row of its endpoint's rank, its coverage delta (0 for a
// rejected or empty write) and its cross rank rs[rank] into the level.
__global__ void k_packed_rows(const int* dict, const int* rs, int w,
                              const int* wb, const int* we, const bool* wmask,
                              const bool* accepted, const int* src, int B,
                              int Q, int* nk, int* nd, int* nx) {
  const int e2 = B * Q;
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2 * e2) return;
  const int e = src[k];
  const bool begin = e < e2;
  const int slot = begin ? e : e - e2;
  const int a = wb[slot], z = we[slot];
  const bool valid = accepted[slot / Q] && wmask[slot] && a < z;
  const int rank = begin ? a : z;
  nx[k] = rs[rank];
  nd[k] = valid ? (begin ? 1 : -1) : 0;
  copy_row(nk + (int64_t)k * w, row(dict, rank, w), w);
}

// ------------------------------------------ the fold and the compaction

#define M_FOLD 0
#define M_COMPACT 1

struct FoldTiles {
  const int* ak;  // A: the base [ca, w] (fold), the rows (compact)
  const int* av;
  int ca;
  const int* a_nused;  // A's live rows (0-dim), or null: all ca rows
  const int* bk;  // B: the delta [cb, w] (fold); unused by the compaction
  const int* bv;
  int cb;
  const int* b_nused;
  int w;
  const int* floor_p;  // the fold's GC floor
  int c_out;
  int ntiles;  // tiles of ca + cb rows: the span of the look-back array
  int* sk;     // survivors: the scratch (fold), the output (compact)
  int* sv;
  u64* ws;
  const bool* need;  // the gated step's decision, or null
};

// The rows [0, live) of an input of c rows (at least one row; all c
// without a count).
__device__ __forceinline__ int live_of(const int* n_used, int c) {
  return n_used ? min(max(*n_used, 1), c) : c;
}

// The stable merge of A's and B's live rows, each merged row's version
// (the max of the two step functions there, GC'd: the fold; A's value:
// the compaction), deduped and compacted by tiles of PT merged rows into
// the survivors' array. Persistent blocks take tiles by ticket.
template <int MODE>
__global__ void __launch_bounds__(PT) k_fold_tiles(FoldTiles p) {
  if (p.need && !*p.need) return;
  extern __shared__ int sm[];
  const int w = p.w, T = PT;
  int* s_row = sm;             // [T, w] the slices: A's rows, then B's
  int* s_sv = s_row + T * w;   // [T] their values
  int* s_src = s_sv + T;       // [T] each merged row's slice row
  int* s_val = s_src + T;      // [T] each merged row's version
  int* s_k0 = s_val + T;       // [w] merged row 0
  int* s_next = s_k0 + w;      // [w] the row after the tile
  __shared__ int s_scan[32];
  __shared__ int s_m[8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int na = live_of(p.a_nused, p.ca);
  const int nb = MODE == M_FOLD ? live_of(p.b_nused, p.cb) : 0;
  const int n = na + nb, nt = (n + T - 1) / T;
  const int fl = MODE == M_FOLD ? *p.floor_p : 0;
  const int* A = p.ak;
  const int* B = p.bk;
  for (;;) {
    if (tid == 0) s_m[0] = (int)atomicAdd(p.ws + WS_TICKET, 1ull);
    __syncthreads();
    const int t = s_m[0];
    if (t >= nt) return;
    if (t == 0 && tid == 0) {
      p.ws[WS_LIVE] = (u64)na;
      p.ws[WS_DLIVE] = (u64)nb;
      p.ws[WS_NTILES] = (u64)nt;
    }
    const int d0 = t * T, d1 = min(n, d0 + T), len = d1 - d0;

    // A's rows among the first diag merged rows, at each end of the tile
    // (A's rows before equal rows of B).
    if (warp < 2) {
      const int diag = warp ? d1 : d0;
      const int a = warp_search(max(0, diag - nb), min(diag, na), [&](int m) {
        return cmp_row(row(A, m, w), row(B, diag - 1 - m, w), w) <= 0;
      });
      if (lane == 0) s_m[1 + warp] = a;
    }
    __syncthreads();
    const int a0 = s_m[1], a1 = s_m[2], b0 = d0 - a0, b1 = d1 - a1;
    const int la = a1 - a0, lb = len - la;

    // The slices, coalesced, STAGE loads in flight a thread.
    for (int e0 = tid; e0 < len * w; e0 += PT * STAGE) {
      int x[STAGE];
#pragma unroll
      for (int u = 0; u < STAGE; ++u) {
        const int e = e0 + u * PT;
        x[u] = 0;
        if (e < len * w) {
          const int i = e / w;
          x[u] = (i < la ? row(A, a0 + i, w) : row(B, b0 + i - la, w))[e - i * w];
        }
      }
#pragma unroll
      for (int u = 0; u < STAGE; ++u)
        if (e0 + u * PT < len * w) s_row[e0 + u * PT] = x[u];
    }
    if (tid < len) s_sv[tid] = tid < la ? p.av[a0 + tid] : p.bv[b0 + tid - la];
    if (warp == 0) {
      // The row before the tile's first run of equal keys: the tile's
      // first row has the key fk; the run began before the tile when the
      // last row of either input before it has fk, and then one
      // lower-bound search in each input finds its start.
      const bool fa_first =
          a0 < a1 && (b0 >= b1 || cmp_row(row(A, a0, w), row(B, b0, w), w) <= 0);
      const int* fk = fa_first ? row(A, a0, w) : row(B, b0, w);
      int fa = a0, fb = b0;
      if ((a0 > 0 && cmp_row(row(A, a0 - 1, w), fk, w) == 0) ||
          (b0 > 0 && cmp_row(row(B, b0 - 1, w), fk, w) == 0)) {
        fa = warp_search(0, a0, [&](int m) {
          return cmp_row(row(A, m, w), fk, w) < 0;
        });
        fb = warp_search(0, b0, [&](int m) {
          return cmp_row(row(B, m, w), fk, w) < 0;
        });
      }
      if (lane == 0) {
        int vp = NEG_M1;  // no row before the run
        if (fa + fb > 0 && MODE == M_COMPACT) {
          vp = p.av[fa - 1];
        } else if (fa + fb > 0) {
          const bool from_b =
              fb > 0 && (fa == 0 || cmp_row(row(A, fa - 1, w),
                                            row(B, fb - 1, w), w) <= 0);
          const int* kp = from_b ? row(B, fb - 1, w) : row(A, fa - 1, w);
          const int v = from_b ? max(p.bv[fb - 1], p.av[max(fa - 1, 0)])
                               : max(p.av[fa - 1], p.bv[max(fb - 1, 0)]);
          vp = gcw(v, is_inf(kp, w), fl);
        }
        s_m[3] = vp;
      }
    } else if (warp == 1) {
      // Merged row 0, the row after the tile, and the halos: each input's
      // last value before the tile.
      const int* k0 = nb == 0 || cmp_row(row(A, 0, w), row(B, 0, w), w) <= 0
                          ? row(A, 0, w) : row(B, 0, w);
      for (int q = lane; q < w; q += 32) s_k0[q] = k0[q];
      if (d1 < n) {
        const int* after =
            a1 < na && (b1 >= nb || cmp_row(row(A, a1, w), row(B, b1, w), w) <= 0)
                ? row(A, a1, w) : row(B, b1, w);
        for (int q = lane; q < w; q += 32) s_next[q] = after[q];
      }
      if (lane == 0) {
        s_m[4] = p.av[max(a0 - 1, 0)];
        s_m[5] = MODE == M_FOLD ? p.bv[max(b0 - 1, 0)] : 0;
      }
    }
    __syncthreads();

    // Each thread merges its row r of the tile from the slices (a
    // diagonal search in shared memory) and takes its version.
    const int r = tid;
    int v = NEG_VERSION;
    if (r < len) {
      int lo = max(0, r - lb), hi = min(r, la);
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (cmp_row(s_row + mid * w, s_row + (la + r - 1 - mid) * w, w) <= 0)
          lo = mid + 1;
        else
          hi = mid;
      }
      const int ai = lo, bi = r - lo;
      const bool from_a =
          ai < la && (bi >= lb ||
                      cmp_row(s_row + ai * w, s_row + (la + bi) * w, w) <= 0);
      const int src = from_a ? ai : la + bi;
      s_src[r] = src;
      if (MODE == M_FOLD) {
        const int x = from_a
            ? max(s_sv[ai], bi > 0 ? s_sv[la + bi - 1] : s_m[5])
            : max(s_sv[la + bi], ai > 0 ? s_sv[ai - 1] : s_m[4]);
        v = gcw(x, is_inf(s_row + src * w, w), fl);
      } else {
        v = s_sv[ai];
      }
      s_val[r] = v;
    }
    __syncthreads();

    // Dedup: the last row of each run stays unless its version equals the
    // previous run's last row's; the minimum key's last row is forced.
    const int* key = s_row + (r < len ? s_src[r] : 0) * w;
    const bool k0_inf = is_inf(s_k0, w), has_next = d1 < n;
    const int start =
        r > 0 && r < len && cmp_row(key, s_row + s_src[r - 1] * w, w) != 0
            ? r : -1;
    const int st = max(block_excl_max(start, s_scan), start);
    bool keep = false;
    if (r < len) {
      const bool keep1 = r + 1 < len
          ? cmp_row(key, s_row + s_src[r + 1] * w, w) != 0
          : (!has_next || cmp_row(key, s_next, w) != 0);
      const int prev = st < 0 ? s_m[3] : s_val[st - 1];
      const bool forced = !k0_inf ? (keep1 && cmp_row(key, s_k0, w) == 0)
                                  : (d0 + r == n - 1);
      keep = forced || (keep1 && v != prev && !is_inf(key, w));
    }
    int agg;
    const int idx = block_excl_sum(keep, s_scan, &agg);
    if (warp == 0) {
      const int e = look_back(p.ws + WS_WORDS, t, agg);
      if (lane == 0) {
        s_m[6] = e;
        if (t == nt - 1) p.ws[WS_TOTAL] = (u64)(e + agg);
      }
    }
    __syncthreads();
    if (keep && s_m[6] + idx < p.c_out) {
      copy_row(p.sk + (int64_t)(s_m[6] + idx) * w, key, w);
      p.sv[s_m[6] + idx] = v;
    }
    __syncthreads();  // before the next tile reuses shared memory
  }
}

struct FoldFinish {
  const int* sk;  // survivors in scratch (the fold, in place), or null
  const int* sv;  // (the compaction: written to its output by the tiles)
  int* ok;  // the base (fold) or the output (compact)
  int* ov;
  int c_out, w;
  int* n_used;
  bool* overflow;
  const bool* prior_a;
  const bool* prior_b;
  int* oldest;
  const int* floor_p;
  int* dk;  // the delta to reset (its live rows), or null
  int* dv;
  int* d_nused;
  int* d_oldest;
  u64* ws;
  int ntiles;
  const bool* need;
};

// The survivors back into the base, (+inf, NEG_VERSION) over [new n_used,
// old n_used) (the output's every row past the survivors, out of place),
// n_used, the sticky overflow and oldest; the delta reset to its min-key
// row at the floor over its live rows; the look-back words and the ticket
// re-zeroed for the next call.
__global__ void k_fold_finish(FoldFinish f) {
  if (f.need && !*f.need) return;
  const int total = (int)f.ws[WS_TOTAL], nt = (int)f.ws[WS_NTILES];
  const int nold = f.sk ? (int)f.ws[WS_LIVE] : f.c_out;
  const int ndold = f.dk ? (int)f.ws[WS_DLIVE] : 0;
  const int nnew = min(total, f.c_out), w = f.w;
  const int span = max(max(nnew, nold), max(nt, ndold));
  for (int j = blockIdx.x * blockDim.x + threadIdx.x; j < span;
       j += gridDim.x * blockDim.x) {
    if (j < nnew) {
      if (f.sk) {
        copy_row(f.ok + (int64_t)j * w, f.sk + (int64_t)j * w, w);
        f.ov[j] = f.sv[j];
      }
    } else if (j < nold) {
      for (int q = 0; q < w; ++q) f.ok[(int64_t)j * w + q] = I32MAX;
      f.ov[j] = NEG_VERSION;
    }
    if (j < ndold) {
      if (j > 0)
        for (int q = 0; q < w; ++q) f.dk[(int64_t)j * w + q] = I32MAX;
      f.dv[j] = NEG_VERSION;
    }
    if (j < nt) f.ws[WS_WORDS + j] = 0;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) {
    *f.n_used = nnew;
    const bool prior = (f.prior_a && *f.prior_a) || (f.prior_b && *f.prior_b);
    *f.overflow = prior || total > f.c_out;
    if (f.oldest) *f.oldest = *f.floor_p;
    if (f.dk) {
      *f.d_nused = 1;
      *f.d_oldest = *f.floor_p;
    }
    f.ws[WS_TICKET] = 0;
  }
}

// ---------------------------------------------------------------- entries

// Per device: the SM count, and the tile kernels allowed SMEM_DYN bytes.
static cudaError_t device_setup(int* sms) {
  static int count[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 64 && count[dev]) {
    *sms = count[dev];
    return cudaSuccess;
  }
  e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  const void* fns[] = {(const void*)k_sorted_tiles,
                       (const void*)k_fold_tiles<M_FOLD>,
                       (const void*)k_fold_tiles<M_COMPACT>};
  for (const void* fn : fns)
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_DYN);
  if (e == cudaSuccess && dev < 64) count[dev] = *sms;
  return e;
}

static inline size_t sorted_smem(int w) { return (size_t)PT * (w + 2) * 4 + 8 * w; }
static inline size_t fold_smem(int w) { return (size_t)PT * (w + 3) * 4 + 8 * w; }

// The sorted paint's two launches (the tiles and the finish).
static int sorted_paint(int* keys, int* vers, int c, int w, int* n_used,
                        bool* overflow, int* oldest, const int* snew,
                        const int* sdelta, const int* scross, int n2, int cv,
                        const int* floor_p, int* scratch, u64* ws, int sms,
                        cudaStream_t s) {
  SortedPaint a = {keys, vers, c, w, n_used, snew, sdelta, scross, n2, cv,
                   floor_p, blocks((int64_t)c + n2, PT), scratch,
                   scratch + (int64_t)c * w, ws};
  int grid = a.ntiles < 4 * sms ? a.ntiles : 4 * sms;
  k_sorted_tiles<<<grid, PT, sorted_smem(w), s>>>(a);
  int fgrid = blocks(c, 256) < 4 * sms ? blocks(c, 256) : 4 * sms;
  k_sorted_finish<<<fgrid, 256, 0, s>>>(keys, vers, c, w, n_used, overflow,
                                        oldest, floor_p, scratch,
                                        scratch + (int64_t)c * w, ws,
                                        a.ntiles);
  return (int)cudaGetLastError();
}

// _paint_tail at width w from sorted new rows (snew [n2, w], sdelta,
// scross [n2]: K14's output) into the history (keys [c, w] / vers [c], in
// place), over its live rows only: two launches. Scratch: c (w + 1) ints;
// ws the zeroed look-back state of 8 + 2 ceil((c + n2) / 256) words, left
// zeroed.
extern "C" int wc_paint_sorted(int* keys, int* vers, int c, int w,
                               int* n_used, bool* overflow, int* oldest,
                               const int* snew, const int* sdelta,
                               const int* scross, int n2, int cv,
                               const int* floor_p, int* scratch, u64* ws,
                               cudaStream_t s) {
  if (sorted_smem(w) > SMEM_DYN || c < 1) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = device_setup(&sms);
  if (e != cudaSuccess) return (int)e;
  return sorted_paint(keys, vers, c, w, n_used, overflow, oldest, snew,
                      sdelta, scross, n2, cv, floor_p, scratch, ws, sms, s);
}

// The packed paint of the accepted writes into the history (keys [c, w] /
// vers [c], in place): dict [n1, w] is the batch dictionary, rs [n1] its
// cross ranks into keys (K12's right search), wb/we/wmask [B, Q] the write
// ranks, src [2BQ] the host's paint order. Scratch: c (w + 1) + 2BQ (w +
// 2) ints; ws as wc_paint_sorted's. Three CUDA kernels (the gather, the
// tiles, the finish; two with no writes), counted into *launched.
extern "C" int wc_paint(int* keys, int* vers, int c, int w, int* n_used,
                        bool* overflow, int* oldest, const int* dict,
                        const int* rs, const int* wb, const int* we,
                        const bool* wmask, const bool* accepted,
                        const int* src, int B, int Q, int cv,
                        const int* floor_p, int* scratch, u64* ws,
                        int* launched, cudaStream_t s) {
  *launched = 0;
  if (sorted_smem(w) > SMEM_DYN || c < 1) return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = device_setup(&sms);
  if (e != cudaSuccess) return (int)e;
  const int n2 = 2 * B * Q;
  int* nk = scratch + (int64_t)c * (w + 1);
  int* nd = nk + (int64_t)n2 * w;
  int* nx = nd + n2;
  int count = 0;
  if (n2 > 0) {
    k_packed_rows<<<blocks(n2, 256), 256, 0, s>>>(dict, rs, w, wb, we, wmask,
                                                  accepted, src, B, Q, nk, nd,
                                                  nx);
    ++count;
  }
  const int rc = sorted_paint(keys, vers, c, w, n_used, overflow, oldest, nk,
                              nd, nx, n2, cv, floor_p, scratch, ws, sms, s);
  *launched = count + 2;
  return rc;
}

// The fold's tiles and finish (two launches), gated on need when given.
static int fold(int* bk, int* bv, int c, int w, int* b_nused, bool* b_over,
                int* b_oldest, int* dk, int* dv, int cd, const bool* d_over,
                int* d_nused, int* d_oldest, int reset, const int* floor_p,
                const bool* need, int* scratch, u64* ws, int sms,
                cudaStream_t s) {
  FoldTiles a = {bk, bv, c, b_nused, dk, dv, cd, d_nused, w, floor_p, c,
                 blocks((int64_t)c + cd, PT), scratch,
                 scratch + (int64_t)c * w, ws, need};
  FoldFinish f = {scratch, scratch + (int64_t)c * w, bk, bv, c, w,
                  b_nused, b_over, b_over, d_over, b_oldest, floor_p,
                  reset ? dk : nullptr, dv, d_nused, d_oldest, ws, a.ntiles,
                  need};
  const int grid = a.ntiles < 4 * sms ? a.ntiles : 4 * sms;
  k_fold_tiles<M_FOLD><<<grid, PT, fold_smem(w), s>>>(a);
  const int fgrid = blocks(c, 256) < 4 * sms ? blocks(c, 256) : 4 * sms;
  k_fold_finish<<<fgrid, 256, 0, s>>>(f);
  return (int)cudaGetLastError();
}

// Fold the delta (dk [cd, w] / dv) into the base (bk [c, w] / bv, in
// place) over the live rows of both; with reset, the delta is reset to its
// min-key row at the floor. Gated on need when given (null: always).
// Scratch: c (w + 1) ints; ws the zeroed look-back state of 8 + ceil((c +
// cd) / 256) words, left zeroed. Two CUDA kernels, counted into *launched.
extern "C" int wc_fold(int* bk, int* bv, int c, int w, int* b_nused,
                       bool* b_over, int* b_oldest, int* dk, int* dv, int cd,
                       const bool* d_over, int* d_nused, int* d_oldest,
                       int reset, const int* floor_p, const bool* need,
                       int* scratch, u64* ws, int* launched, cudaStream_t s) {
  *launched = 0;
  if (fold_smem(w) > SMEM_DYN || c < 1 || cd < 1)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = device_setup(&sms);
  if (e != cudaSuccess) return (int)e;
  const int rc = fold(bk, bv, c, w, b_nused, b_over, b_oldest, dk, dv, cd,
                      d_over, d_nused, d_oldest, reset, floor_p, need,
                      scratch, ws, sms, s);
  *launched = 2;
  return rc;
}

// The gated step: K4's decision writes need (the 0-dim bool), then the
// fold with the delta reset runs gated on it. Three CUDA kernels, counted
// into *launched.
extern "C" int wc_fold_step(int* bk, int* bv, int c, int w, int* b_nused,
                            bool* b_over, int* b_oldest, int* dk, int* dv,
                            int cd, const bool* d_over, int* d_nused,
                            int* d_oldest, const int* floor_p, int demand,
                            bool* need, int* scratch, u64* ws, int* launched,
                            cudaStream_t s) {
  *launched = 0;
  if (fold_smem(w) > SMEM_DYN || c < 1 || cd < 1)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = device_setup(&sms);
  if (e != cudaSuccess) return (int)e;
  fn_launch_need(bv, c, floor_p, d_nused, demand, cd, need, ws, s);
  const int rc = fold(bk, bv, c, w, b_nused, b_over, b_oldest, dk, dv, cd,
                      d_over, d_nused, d_oldest, 1, floor_p, need, scratch,
                      ws, sms, s);
  *launched = 3;
  return rc;
}

// Dedup + compaction of sorted [n, w] rows mk / versions mv alone (out of
// place, into ok [c_out, w] / ov): the tiles' A-only mode and the finish.
// Two CUDA kernels, counted into *launched.
extern "C" int wc_compact(const int* mk, const int* mv, int n, int w,
                          int c_out, const bool* prior, int* ok, int* ov,
                          int* n_used, bool* overflow, u64* ws, int* launched,
                          cudaStream_t s) {
  *launched = 0;
  if (fold_smem(w) > SMEM_DYN || n < 1 || c_out < 1)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = device_setup(&sms);
  if (e != cudaSuccess) return (int)e;
  FoldTiles a = {mk, mv, n, nullptr, nullptr, nullptr, 0, nullptr, w,
                 nullptr, c_out, blocks(n, PT), ok, ov, ws, nullptr};
  FoldFinish f = {nullptr, nullptr, ok, ov, c_out, w, n_used, overflow,
                  prior, nullptr, nullptr, nullptr, nullptr, nullptr,
                  nullptr, nullptr, ws, a.ntiles, nullptr};
  const int grid = a.ntiles < 4 * sms ? a.ntiles : 4 * sms;
  k_fold_tiles<M_COMPACT><<<grid, PT, fold_smem(w), s>>>(a);
  const int fgrid = blocks(c_out, 256) < 4 * sms ? blocks(c_out, 256)
                                                 : 4 * sms;
  k_fold_finish<<<fgrid, 256, 0, s>>>(f);
  *launched = 2;
  return (int)cudaGetLastError();
}
