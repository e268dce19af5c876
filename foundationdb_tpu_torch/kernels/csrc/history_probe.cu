// K2: sparse-table build and the history probe.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   too_old_mask_packed (:1425) and _history_conflict_ranges_hist_res
//   (:2161) with its rank probes _rank_probe (:2129), i.e. ops/lex.py
//   searchsorted_words (:45) at W = 1;
//   ops/rmq.py sparse_table (:20) and range_max (:40).
//
// Bound on the H100: bytes for the table (each level reads the previous
// level and writes its own: 2 x 4 B x N per level, ~170 MB for the base at
// C = 2^20 after a fold, ~2 MB for the per-batch delta table), and
// dependent-load latency for the probe: every read slot walks two binary
// searches of ~21 and ~15 steps whose upper levels stay in L2.
//
// Design: the table is built level by level, one launch per level (level
// l reads level l-1 at min(i + 2^(l-1), N-1), the JAX clamped-tail
// convention), so no block depends on another inside a launch. The probe
// is one thread per transaction: it walks its R read slots (rank search
// right-1 / left into base and delta keys, two O(1) table lookups each),
// writes the [B, R] slot mask the report path needs and folds the
// too-old test and the per-transaction OR into the acceptance candidate
// mask, so nothing of the probe is re-read from device memory. Non-live
// slots skip their searches: their mask bit is false either way. Every
// launch can be gated by a device flag (the demand-driven fold decides on
// the device whether the base table must be rebuilt).

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_VERSION (-2147483647)

__device__ __forceinline__ int lower_bound(const int* a, int n, int q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int upper_bound(const int* a, int n, int q) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] <= q) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// max(values[lo:hi]) from the sparse table st [L, n]; empty -> NEG_VERSION.
__device__ __forceinline__ int range_max(const int* st, int n, int lo, int hi) {
  int len = hi - lo;
  if (len <= 0) return NEG_VERSION;
  int lvl = 31 - __clz(len);
  int w = 1 << lvl;
  int b = hi - w;
  if (b < 0) b = 0;
  int x = st[(int64_t)lvl * n + lo];
  int y = st[(int64_t)lvl * n + b];
  return x > y ? x : y;
}

__global__ void k_row0(const int* values, int* st, int n, const bool* need) {
  if (need && !*need) return;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) st[i] = values[i];
}

__global__ void k_level(int* st, int n, int l, const bool* need) {
  if (need && !*need) return;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* prev = st + (int64_t)(l - 1) * n;
  int j = i + (1 << (l - 1));
  if (j > n - 1) j = n - 1;
  int a = prev[i], b = prev[j];
  st[(int64_t)l * n + i] = a > b ? a : b;
}

__global__ void k_probe(const int* bkeys, int c, const int* bst,
                        const int* dkeys, int cd, const int* dst,
                        const int* rb, const int* re, const bool* rmask,
                        const int* rv, const bool* tmask, const int* floor_p,
                        int B, int R, bool* hist_mask, bool* too_old,
                        bool* cand) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  int v = rv[b];
  bool has_reads = false, any_hist = false;
  for (int r = 0; r < R; ++r) {
    int s = b * R + r;
    int qb = rb[s], qe = re[s];
    bool live = rmask[s] && qb < qe;
    bool h = false;
    if (live) {
      has_reads = true;
      int lo = upper_bound(bkeys, c, qb) - 1;
      if (lo < 0) lo = 0;
      int nb = range_max(bst, c, lo, lower_bound(bkeys, c, qe));
      int lod = upper_bound(dkeys, cd, qb) - 1;
      if (lod < 0) lod = 0;
      int nd = range_max(dst, cd, lod, lower_bound(dkeys, cd, qe));
      h = (nb > nd ? nb : nd) > v;
    }
    hist_mask[s] = h;
    any_hist |= h;
  }
  bool t = tmask[b];
  bool to = t && has_reads && v < *floor_p;
  too_old[b] = to;
  cand[b] = t && !to && !any_hist;
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

// st [levels, n]; row 0 is copied from values unless they alias.
extern "C" int hp_table(const int* values, int n, int levels, int* st,
                        const bool* need, cudaStream_t s) {
  const int T = 256;
  if (n > 0) {
    if (values != st) k_row0<<<blocks(n, T), T, 0, s>>>(values, st, n, need);
    for (int l = 1; l < levels; ++l)
      k_level<<<blocks(n, T), T, 0, s>>>(st, n, l, need);
  }
  return (int)cudaGetLastError();
}

extern "C" int hp_probe(const int* bkeys, int c, const int* bst,
                        const int* dkeys, int cd, const int* dst,
                        const int* rb, const int* re, const bool* rmask,
                        const int* rv, const bool* tmask, const int* floor_p,
                        int B, int R, bool* hist_mask, bool* too_old,
                        bool* cand, cudaStream_t s) {
  const int T = 128;
  if (B > 0)
    k_probe<<<blocks(B, T), T, 0, s>>>(bkeys, c, bst, dkeys, cd, dst, rb, re,
                                       rmask, rv, tmask, floor_p, B, R,
                                       hist_mask, too_old, cand);
  return (int)cudaGetLastError();
}
