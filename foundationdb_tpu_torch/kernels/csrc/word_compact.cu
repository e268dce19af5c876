// K13: step-function rewrites over W-word keys — the packed paint, the
// base+delta fold and the dedup + compaction they share, and the unpacked
// paint (its new endpoint rows and its sorted paint).
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   _paint_and_compact_packed (:1489) -> _paint_tail (:925), as run by
//   resolve_batch_hist_packed (:1634), wave_apply_batch_hist_packed
//   (:2501), paint_batch_hist_packed (:2732) and _spec_mark_rejected
//   (:2854);
//   _merge_delta (:1243) at width W, as run by _maybe_merge (:1290) and
//   advance_hist (:1404);
//   _dedup_compact (:977) over [n, W] rows;
//   _paint_and_compact (:869) -> _paint_tail (:925), the unpacked flat
//   paint (wc_paint_keys, wc_paint_sorted), as run by resolve_batch
//   (:1108) and parallel/sharded_resolver.py _sharded_resolve (:160).
//
// Bound on the H100: bytes. The fold reads the [C, W] base and [Cd, W]
// delta and rewrites the base (C = 2^20, W = 4: ~20 MB of state, ~40 MB of
// scratch through the merge and the two scans); a paint touches its live
// rows and 2BQ new rows (~36 K at W words). The searches add dependent
// loads mostly in L2.
//
// The packed paint, the fold and the compaction (wc_paint, wc_fold,
// wc_compact) are K4's first design at width W, one word row per thread.
// A paint takes the host's paint order (``paint_src``: a stable argsort of
// the write endpoints' ranks, the permutation the JAX rank sort gives) and
// K12's cross ranks into the delta (rs), and gathers each endpoint's key
// back from the batch dictionary by its rank, so nothing is sorted on the
// card. Rows are scattered to their merge slots (a new or delta row lands
// at its index plus the count of history rows <= it, a history row at its
// index plus the count of new rows < it: the JAX merge order), the
// coverage and keep prefix sums are device-wide scans, and the dedup and
// forced minimum-key rule use W-word row compares. A rejected write merges
// as a no-op endpoint (coverage delta 0) and is compacted out, which
// leaves the same state as the JAX paint's parking of it on the
// dictionary's +inf row. Every fold launch reads an optional device flag
// and exits at once when it is false.
//
// The unpacked paint: wc_paint_keys writes the accepted writes' endpoint
// rows (a rejected write parked on the +inf row, as the JAX
// _paint_and_compact parks it, :893-900) and their coverage deltas; K12's
// search gives their cross ranks, K14 (word_sort.cu) sorts the rows
// carrying deltas and cross ranks; wc_paint_sorted is _paint_tail (:925)
// from those sorted rows, in K4's second design (step_compact.cu) at width
// W and over the live rows only, two launches. Every row of a history at
// or past n_used holds (+inf, NEG_VERSION) (every writer leaves it so), and
// such rows change nothing in the merge but the forced row when every key
// is +inf, which any +inf row then stands for; so the merge is of the
// live rows [0, n_used) (read on the device) and the n2 new rows, and the
// work is in proportion to n_used + n2, not C + n2. New row k sits at
// merged position k + min(its cross rank, n_used) (history rows before
// equal new rows, the JAX merge order), so a tile of 256 merged rows (one
// a thread: small tiles spread over more SMs) finds its new rows by one
// search over those positions, marks their slots, and fills the others
// from the history in order; nothing merged is written to device memory.
// Persistent blocks take tiles by ticket until the live merged length is
// covered. Two sums cross tiles by a decoupled look-back: the coverage
// before the tile and the survivors before it. The dedup needs, for the
// tile's first run of equal keys, the version of the row before the run:
// the run starts at the tile unless the row before the tile has its key,
// and then one lower-bound search in each input finds its start; the
// coverage there is the tile's less the deltas of the run's new rows
// before the tile. The forced row is the last of the minimum key's run
// (the last row when every key is +inf). Survivors land in a scratch
// buffer; a second launch copies them back, writes (+inf, NEG_VERSION)
// over [new n_used, old n_used) only, n_used, the sticky overflow and
// oldest, and re-zeroes the look-back words and the ticket (K4's
// workspace, step_compact.cu's layout).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

#define I32MAX 2147483647
#define NEG_VERSION (-2147483647)
#define NEG_M1 (-2147483647 - 1)
#define FULL 0xffffffffu
#define ST 256
#define SI 4
#define STILE (ST * SI)

#define GATE if (need && !*need) return

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

// first index of a sorted [n, w] array with row >= q (strict) / > q.
__device__ __forceinline__ int search(const int* a, int n, const int* q,
                                      int w, bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    int c = cmp_row(row(a, mid, w), q, w);
    if (c < 0 || (upper && c == 0)) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// ---------------------------------------------------------------- scan

__device__ int block_incl_scan(int v, int* ws) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nwarps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) ws[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? ws[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) ws[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += ws[warp - 1];
  return v;
}

__global__ void k_scan_tile(const int* in, int* out, int n, int* bsum,
                            const bool* need) {
  GATE;
  __shared__ int ws[32];
  int64_t base = (int64_t)blockIdx.x * STILE + threadIdx.x * SI;
  int x[SI];
  int s = 0;
  for (int k = 0; k < SI; ++k) {
    x[k] = base + k < n ? in[base + k] : 0;
    s += x[k];
  }
  int incl = block_incl_scan(s, ws);
  int run = incl - s;
  for (int k = 0; k < SI; ++k) {
    run += x[k];
    if (base + k < n) out[base + k] = run;
  }
  if (threadIdx.x == blockDim.x - 1) bsum[blockIdx.x] = incl;
}

__global__ void k_scan_sums(int* bsum, int nb, const bool* need) {
  GATE;
  __shared__ int ws[32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int c0 = 0; c0 < nb; c0 += blockDim.x) {
    int i = c0 + threadIdx.x;
    int v = i < nb ? bsum[i] : 0;
    int incl = block_incl_scan(v, ws);
    int cbase = carry;
    __syncthreads();
    if (i < nb) bsum[i] = cbase + incl - v;
    if (threadIdx.x == blockDim.x - 1) carry = cbase + incl;
    __syncthreads();
  }
}

__global__ void k_scan_add(int* out, int n, const int* bsum,
                           const bool* need) {
  GATE;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] += bsum[i / STILE];
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

static void scan(const int* in, int* out, int n, int* bsum, const bool* need,
                 cudaStream_t s) {
  int nb = blocks(n, STILE);
  k_scan_tile<<<nb, ST, 0, s>>>(in, out, n, bsum, need);
  k_scan_sums<<<1, ST, 0, s>>>(bsum, nb, need);
  k_scan_add<<<blocks(n, 256), 256, 0, s>>>(out, n, bsum, need);
}

// ------------------------------------------------------- dedup + compact

__global__ void k_keep(const int* mk, const int* mv, int n, int w, int* flag,
                       const bool* need) {
  GATE;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* key = row(mk, i, w);
  bool keep1 = (i == n - 1) || cmp_row(key, row(mk, i + 1, w), w) != 0;
  bool inf = is_inf(key, w);
  bool keep = false;
  if (keep1 && !inf) {
    int s = search(mk, n, key, w, false);  // run start
    int prev_v = s > 0 ? mv[s - 1] : NEG_M1;
    keep = mv[i] != prev_v;
  }
  bool min_last = !is_inf(mk, w) ? (keep1 && cmp_row(key, mk, w) == 0)
                                 : (i == n - 1);
  flag[i] = keep || min_last;
}

__global__ void k_scatter(const int* mk, const int* mv, const int* flag,
                          const int* cum, int n, int w, int c_out, int* ok,
                          int* ov, const bool* need) {
  GATE;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !flag[i]) return;
  int k = cum[i] - 1;
  if (k < c_out) {
    copy_row(ok + (int64_t)k * w, row(mk, i, w), w);
    ov[k] = mv[i];
  }
}

__global__ void k_fill(const int* cum, int n, int w, int c_out, int* ok,
                       int* ov, int* n_used, bool* overflow,
                       const bool* prior_a, const bool* prior_b,
                       int* oldest_out, const int* floor_p,
                       const bool* need) {
  GATE;
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= c_out) return;
  int total = cum[n - 1];
  if (j >= total) {
    for (int q = 0; q < w; ++q) ok[(int64_t)j * w + q] = I32MAX;
    ov[j] = NEG_VERSION;
  }
  if (j == 0) {
    *n_used = total < c_out ? total : c_out;
    bool prior = (prior_a && *prior_a) || (prior_b && *prior_b);
    *overflow = prior || total > c_out;
    if (oldest_out) *oldest_out = *floor_p;
  }
}

static void compact(const int* mk, const int* mv, int n, int w, int c_out,
                    int* ok, int* ov, int* n_used, bool* overflow,
                    const bool* prior_a, const bool* prior_b, int* oldest_out,
                    const int* floor_p, int* t0, int* t1, int* bsum,
                    const bool* need, cudaStream_t s) {
  const int T = 256;
  k_keep<<<blocks(n, T), T, 0, s>>>(mk, mv, n, w, t0, need);
  scan(t0, t1, n, bsum, need, s);
  k_scatter<<<blocks(n, T), T, 0, s>>>(mk, mv, t0, t1, n, w, c_out, ok, ov,
                                       need);
  k_fill<<<blocks(c_out, T), T, 0, s>>>(t1, n, w, c_out, ok, ov, n_used,
                                        overflow, prior_a, prior_b,
                                        oldest_out, floor_p, need);
}

// ------------------------------------------------------------------ paint

__global__ void k_paint_new(const int* vers, const int* dict, const int* rs,
                            int w, const int* wb, const int* we,
                            const bool* wmask, const bool* accepted,
                            const int* src, int B, int Q, int* snew, int* mk,
                            int* md, int* mv) {
  int e2 = B * Q;
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2 * e2) return;
  int e = src[k];
  bool is_begin = e < e2;
  int slot = is_begin ? e : e - e2;
  int a = wb[slot], z = we[slot];
  bool valid = accepted[slot / Q] && wmask[slot] && a < z;
  int rank = is_begin ? a : z;
  int cross = rs[rank];
  int64_t pos = (int64_t)k + cross;
  const int* key = row(dict, rank, w);
  copy_row(mk + pos * w, key, w);
  copy_row(snew + (int64_t)k * w, key, w);
  md[pos] = valid ? (is_begin ? 1 : -1) : 0;
  mv[pos] = vers[cross > 0 ? cross - 1 : 0];
}

__global__ void k_paint_old(const int* keys, const int* vers, int c, int w,
                            const int* snew, int n2, int* mk, int* md,
                            int* mv) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  const int* key = row(keys, i, w);
  int64_t pos = (int64_t)i + search(snew, n2, key, w, false);
  copy_row(mk + pos * w, key, w);
  md[pos] = 0;
  mv[pos] = vers[i];
}

__global__ void k_newv(const int* mk, const int* cov, int* mv, int n, int w,
                       int cv, const int* floor_p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int v = cov[i] > 0 ? cv : mv[i];
  mv[i] = (v <= *floor_p || is_inf(row(mk, i, w), w)) ? NEG_VERSION : v;
}

// ------------------------------------------------------------------- fold

__global__ void k_fold_delta(const int* bk, const int* bv, int c,
                             const int* dk, const int* dv, int cd, int w,
                             const int* floor_p, int* mk, int* mv,
                             const bool* need) {
  GATE;
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cd) return;
  const int* key = row(dk, j, w);
  int cross = search(bk, c, key, w, true);
  int vb = bv[cross > 0 ? cross - 1 : 0];
  int v = vb > dv[j] ? vb : dv[j];
  int64_t pos = (int64_t)j + cross;
  copy_row(mk + pos * w, key, w);
  mv[pos] = (v <= *floor_p || is_inf(key, w)) ? NEG_VERSION : v;
}

__global__ void k_fold_base(const int* bk, const int* bv, int c,
                            const int* dk, const int* dv, int cd, int w,
                            const int* floor_p, int* mk, int* mv,
                            const bool* need) {
  GATE;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  const int* key = row(bk, i, w);
  int lb = search(dk, cd, key, w, false);
  int cb = search(dk, cd, key, w, true);
  int vd = dv[cb > 0 ? cb - 1 : 0];
  int v = bv[i] > vd ? bv[i] : vd;
  int64_t pos = (int64_t)i + lb;
  copy_row(mk + pos * w, key, w);
  mv[pos] = (v <= *floor_p || is_inf(key, w)) ? NEG_VERSION : v;
}

// ---------------------------------------------------------------- entries

// Paint the accepted writes into the history (keys [c, w] / vers [c], in
// place); dict [n1, w] is the batch dictionary, rs [n1] its cross ranks
// into keys. Scratch: snew [2BQ, w], mk [n, w], mv, t0, t1 [n], n = c+2BQ.
extern "C" int wc_paint(int* keys, int* vers, int c, int w, int* n_used,
                        bool* overflow, int* oldest, const int* dict,
                        const int* rs, const int* wb, const int* we,
                        const bool* wmask, const bool* accepted,
                        const int* src, int B, int Q, int cv,
                        const int* floor_p, int* snew, int* mk, int* mv,
                        int* t0, int* t1, int* bsum, cudaStream_t s) {
  const int T = 256;
  int n2 = 2 * B * Q;
  int n = c + n2;
  k_paint_new<<<blocks(n2, T), T, 0, s>>>(vers, dict, rs, w, wb, we, wmask,
                                          accepted, src, B, Q, snew, mk, t0,
                                          mv);
  k_paint_old<<<blocks(c, T), T, 0, s>>>(keys, vers, c, w, snew, n2, mk, t0,
                                         mv);
  scan(t0, t1, n, bsum, nullptr, s);
  k_newv<<<blocks(n, T), T, 0, s>>>(mk, t1, mv, n, w, cv, floor_p);
  compact(mk, mv, n, w, c, keys, vers, n_used, overflow, overflow, nullptr,
          oldest, floor_p, t0, t1, bsum, nullptr, s);
  return (int)cudaGetLastError();
}

// Fold the delta into the base (base arrays in place); need may be null.
extern "C" int wc_fold(int* bk, int* bv, int c, int w, int* b_nused,
                       bool* b_over, int* b_oldest, const int* dk,
                       const int* dv, int cd, const bool* d_over,
                       const int* floor_p, const bool* need, int* mk, int* mv,
                       int* t0, int* t1, int* bsum, cudaStream_t s) {
  const int T = 256;
  int n = c + cd;
  k_fold_delta<<<blocks(cd, T), T, 0, s>>>(bk, bv, c, dk, dv, cd, w, floor_p,
                                           mk, mv, need);
  k_fold_base<<<blocks(c, T), T, 0, s>>>(bk, bv, c, dk, dv, cd, w, floor_p,
                                         mk, mv, need);
  compact(mk, mv, n, w, c, bk, bv, b_nused, b_over, b_over, d_over, b_oldest,
          floor_p, t0, t1, bsum, need, s);
  return (int)cudaGetLastError();
}

// Dedup + compaction of sorted [n, w] rows alone (out of place).
extern "C" int wc_compact(const int* mk, const int* mv, int n, int w,
                          int c_out, const bool* prior, int* ok, int* ov,
                          int* n_used, bool* overflow, int* t0, int* t1,
                          int* bsum, cudaStream_t s) {
  compact(mk, mv, n, w, c_out, ok, ov, n_used, overflow, prior, nullptr,
          nullptr, nullptr, t0, t1, bsum, nullptr, s);
  return (int)cudaGetLastError();
}

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
#define WS_TOTAL 3
#define WS_LIVE 4
#define WS_NTILES 5
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

// Per device: the SM count, and the tile kernel allowed SMEM_DYN bytes.
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
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k_sorted_tiles,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SMEM_DYN);
  if (e == cudaSuccess && dev < 64) count[dev] = *sms;
  return e;
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
  if ((int64_t)PT * (w + 2) * 4 + 8 * w > SMEM_DYN || c < 1)
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t e = device_setup(&sms);
  if (e != cudaSuccess) return (int)e;
  SortedPaint a = {keys, vers, c, w, n_used, snew, sdelta, scross, n2, cv,
                   floor_p, blocks((int64_t)c + n2, PT), scratch,
                   scratch + (int64_t)c * w, ws};
  size_t smem = (size_t)PT * (w + 2) * 4 + 8 * w;
  int grid = a.ntiles < 4 * sms ? a.ntiles : 4 * sms;
  k_sorted_tiles<<<grid, PT, smem, s>>>(a);
  int fgrid = blocks(c, 256) < 4 * sms ? blocks(c, 256) : 4 * sms;
  k_sorted_finish<<<fgrid, 256, 0, s>>>(keys, vers, c, w, n_used, overflow,
                                        oldest, floor_p, scratch,
                                        scratch + (int64_t)c * w, ws,
                                        a.ntiles);
  return (int)cudaGetLastError();
}
