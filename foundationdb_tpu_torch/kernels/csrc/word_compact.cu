// K13: step-function rewrites over W-word keys — the packed paint, the
// base+delta fold and the dedup + compaction they share.
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
// scratch through the merge and the two scans); a paint touches Cd + 2BQ
// rows (~33 K at W words). The searches add dependent loads mostly in L2.
//
// The unpacked flat programs (the sharded full-key engine, B3 with
// resident=False, and the single flat B5 resolve) paint through two more
// entries: wc_paint_keys writes the accepted writes' endpoint rows (a
// rejected write parked on the +inf row, as the JAX _paint_and_compact
// parks it, :893-900) and their coverage deltas; K12's search gives their
// cross ranks, K14 (word_sort.cu) sorts the rows carrying deltas and cross
// ranks; wc_paint_sorted is _paint_tail (:925) from those sorted rows,
// over the same merge-scatter, scans and compaction as wc_paint.
//
// Design: K4 (step_compact.cu) at width W, one word row per thread. A
// paint takes the host's paint order (``paint_src``: a stable argsort of
// the write endpoints' ranks, the permutation the JAX rank sort gives) and
// K12's cross ranks into the delta (rs), and gathers each endpoint's key
// back from the batch dictionary by its rank, so nothing is sorted on the
// card. Rows are scattered to their merge slots (a new or delta row lands
// at its index plus the count of history rows <= it, a history row at its
// index plus the count of new rows < it: the JAX merge order), the
// coverage and keep prefix sums are K4's device-wide scans, and the dedup
// and forced minimum-key rule are K4's with W-word row compares. A
// rejected write merges as a no-op endpoint (coverage delta 0) and is
// compacted out, which leaves the same state as the JAX paint's parking of
// it on the dictionary's +inf row. Every fold launch reads an optional
// device flag and exits at once when it is false.

#include <cuda_runtime.h>
#include <stdint.h>

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

// The SORTED new rows (K14's output: keys, deltas, cross ranks into the
// history) to their merge slots, each with its segment's pre-paint
// version.
__global__ void k_sorted_new(const int* vers, const int* snew,
                             const int* sdelta, const int* scross, int n2,
                             int w, int* mk, int* md, int* mv) {
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n2) return;
  int cross = scross[k];
  int64_t pos = (int64_t)k + cross;
  copy_row(mk + pos * w, row(snew, k, w), w);
  md[pos] = sdelta[k];
  mv[pos] = vers[cross > 0 ? cross - 1 : 0];
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

// _paint_tail at width w from sorted new rows (snew [n2, w], sdelta,
// scross [n2]): merge into the history (keys [c, w] / vers [c], in
// place), paint, GC to the floor, compact. Scratch as wc_paint's.
extern "C" int wc_paint_sorted(int* keys, int* vers, int c, int w,
                               int* n_used, bool* overflow, int* oldest,
                               const int* snew, const int* sdelta,
                               const int* scross, int n2, int cv,
                               const int* floor_p, int* mk, int* mv, int* t0,
                               int* t1, int* bsum, cudaStream_t s) {
  const int T = 256;
  int n = c + n2;
  if (n2 > 0)
    k_sorted_new<<<blocks(n2, T), T, 0, s>>>(vers, snew, sdelta, scross, n2,
                                             w, mk, t0, mv);
  k_paint_old<<<blocks(c, T), T, 0, s>>>(keys, vers, c, w, snew, n2, mk, t0,
                                         mv);
  scan(t0, t1, n, bsum, nullptr, s);
  k_newv<<<blocks(n, T), T, 0, s>>>(mk, t1, mv, n, w, cv, floor_p);
  compact(mk, mv, n, w, c, keys, vers, n_used, overflow, overflow, nullptr,
          oldest, floor_p, t0, t1, bsum, nullptr, s);
  return (int)cudaGetLastError();
}
