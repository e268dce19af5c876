// K12: the packed non-resident engine's history probe over W-word keys.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   _dict_history_search (:1445), i.e. ops/lex.py
//   searchsorted_words_2sided_fp (:81), run against the base and the delta
//   of the two-level history (or one flat state);
//   _history_conflict_ranges_hist_packed (:1597) and the flat
//   _history_conflict_ranges_packed (:1458) with too_old_mask_packed
//   (:1425): read slots gather their bounds by rank, range max over the
//   versions from K2's sparse tables.
//
// Bound on the H100: dependent-load latency. A batch brings N + 1 = 49,153
// dictionary rows of W = 4 words; each walks two binary searches of ~21
// steps into the [2^20, W] base and two of ~15 into the delta, each step a
// W-word compare whose upper levels stay in L2. The bytes are small
// (~0.8 MB of dictionary, ~0.6 MB of rank outputs, ~0.2 MB of read slots).
//
// Design: the JAX search narrows one word column at a time (a cascade
// built for the TPU's vector gathers). Here one thread takes one
// dictionary row and one history and runs the two textbook binary searches
// with a full W-word lexicographic compare at each step (signed int32
// words: the packing bias makes that the key byte order): lower bound
// first, then the upper bound from there, since rs >= ls. The rows are
// sorted, so rs is the paint's cross rank into the delta. The probe is one
// thread per transaction, as K2's: for each live read slot it gathers
// lo = max(rs[begin] - 1, 0) and hi = ls[end] for the base and the delta
// and takes the two O(1) range maxima from K2's tables, then folds too-old
// and the per-transaction OR into the acceptance candidates.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_VERSION (-2147483647)

// a < b (lt) or a <= b (!lt) over w signed words.
__device__ __forceinline__ bool row_before(const int* a, const int* b, int w,
                                           bool strict) {
  for (int j = 0; j < w; ++j) {
    if (a[j] != b[j]) return a[j] < b[j];
  }
  return !strict;
}

__global__ void k_search(const int* keys0, int c0, const int* keys1, int c1,
                         const int* dict, int n1, int w, int* ls0, int* rs0,
                         int* ls1, int* rs1) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  int which = t / n1;
  int u = t - which * n1;
  if (which > 1 || (which == 1 && keys1 == nullptr)) return;
  const int* keys = which ? keys1 : keys0;
  int c = which ? c1 : c0;
  const int* q = dict + (int64_t)u * w;
  int lo = 0, hi = c;  // first row >= q
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (row_before(keys + (int64_t)mid * w, q, w, true)) lo = mid + 1;
    else hi = mid;
  }
  int left = lo;
  hi = c;  // first row > q, at or after left
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (row_before(keys + (int64_t)mid * w, q, w, false)) lo = mid + 1;
    else hi = mid;
  }
  (which ? ls1 : ls0)[u] = left;
  (which ? rs1 : rs0)[u] = lo;
}

__device__ __forceinline__ int range_max(const int* st, int n, int lo, int hi) {
  int len = hi - lo;
  if (len <= 0) return NEG_VERSION;
  int lvl = 31 - __clz(len);
  int b = hi - (1 << lvl);
  if (b < 0) b = 0;
  int x = st[(int64_t)lvl * n + lo];
  int y = st[(int64_t)lvl * n + b];
  return x > y ? x : y;
}

__global__ void k_probe(const int* st0, int c0, const int* ls0,
                        const int* rs0, const int* st1, int c1,
                        const int* ls1, const int* rs1, const int* rb,
                        const int* re, const bool* rmask, const int* rv,
                        const bool* tmask, const int* floor_p, int B, int R,
                        bool* hist_mask, bool* too_old, bool* cand) {
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
      int lo = rs0[qb] - 1;
      int newest = range_max(st0, c0, lo < 0 ? 0 : lo, ls0[qe]);
      if (st1) {
        int lod = rs1[qb] - 1;
        int nd = range_max(st1, c1, lod < 0 ? 0 : lod, ls1[qe]);
        newest = newest > nd ? newest : nd;
      }
      h = newest > v;
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

// (ls, rs) of every dictionary row in keys0 and, when keys1 is given, in
// keys1.
extern "C" int wp_search(const int* keys0, int c0, const int* keys1, int c1,
                         const int* dict, int n1, int w, int* ls0, int* rs0,
                         int* ls1, int* rs1, cudaStream_t s) {
  const int T = 128;
  int64_t n = (int64_t)n1 * (keys1 ? 2 : 1);
  if (n1 > 0)
    k_search<<<blocks(n, T), T, 0, s>>>(keys0, c0, keys1, c1, dict, n1, w,
                                        ls0, rs0, ls1, rs1);
  return (int)cudaGetLastError();
}

// st1/ls1/rs1 may be null (a flat history).
extern "C" int wp_probe(const int* st0, int c0, const int* ls0,
                        const int* rs0, const int* st1, int c1,
                        const int* ls1, const int* rs1, const int* rb,
                        const int* re, const bool* rmask, const int* rv,
                        const bool* tmask, const int* floor_p, int B, int R,
                        bool* hist_mask, bool* too_old, bool* cand,
                        cudaStream_t s) {
  const int T = 128;
  if (B > 0)
    k_probe<<<blocks(B, T), T, 0, s>>>(st0, c0, ls0, rs0, st1, c1, ls1, rs1,
                                       rb, re, rmask, rv, tmask, floor_p, B,
                                       R, hist_mask, too_old, cand);
  return (int)cudaGetLastError();
}
