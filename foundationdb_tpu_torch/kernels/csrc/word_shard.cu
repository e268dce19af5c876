// K15, K16: the full-key sharded engine's clip and probe (S keyspace
// shards of one card, each with a flat [C, W] word-key history, the shard
// axis leading every array). The W-word twins of K9 and K8 (shard.cu).
//
// Replaces (foundationdb_tpu/):
//   K15: models/conflict_kernel.py clip_batch (:1028) with ops/lex.py
//        lex_max / lex_min (:34, :40), for every shard at once;
//   K16: parallel/sharded_resolver.py _sharded_resolve (:107), its probe
//        half: models/conflict_kernel.py too_old_mask (:1056), the
//        per-shard _history_conflict_ranges / _history_conflicts (:219,
//        :252) of the clipped reads, and the cross-shard OR of the
//        conflict bits (the all_gather of the packed bits or the psum,
//        :115-131). At S = 1 with no bounds it is the single flat engine's
//        history probe, and its [B, R] slot mask is the one
//        resolve_batch(report=True) needs.
//
// K15 is elementwise and bound by bytes: per shard it reads the batch's
// [B, Q, W] write rows (and [B, R, W] read rows on a wave engine) and
// writes their clamped copies, one thread per (shard, slot): begin ->
// lex_max(begin, lo_s), end -> lex_min(end, hi_s), mask -> mask && begin <
// end after the clamp, all as signed W-word compares (the key bias makes
// that the byte order).
//
// K16 is one launch over every (read slot, shard) pair (grid.y = S): the
// slot's rows clamped to the shard in registers, a W-word upper-bound
// search of the begin and a lower-bound search of the end in the shard's
// [C, W] keys (about 2 log2 C steps, each a W-word compare whose upper
// levels stay in L2), a range max from the sparse table that K2 builds
// over the S shards' versions as one [S x C] array (a query never leaves
// its shard's segment, so one table answers every shard), and a store of
// true into the slot's byte of the [B, R] mask: the mesh's OR becomes
// stores of one value into device memory. A second launch, one thread per
// transaction, folds the too-old test on the UNCLIPPED reads (every shard
// judges too-old on the whole batch) and writes too_old, the OR-ed
// conflict bit and the acceptance candidates. Bound: the dependent loads
// of the searches; the bytes (the read rows, a few MB of history touched)
// are small. The flat design rebuilds the table every batch, as the JAX
// program does (:236-240): at S x C = 2^22 that is K2's larger cost.

#include <cuda_runtime.h>
#include <stdint.h>

#define NEG_VERSION (-2147483647)

// a < b over w signed words.
__device__ __forceinline__ bool lex_lt(const int* a, const int* b, int w) {
  for (int j = 0; j < w; ++j)
    if (a[j] != b[j]) return a[j] < b[j];
  return false;
}

// First index of the sorted [n, w] rows a with row > q (upper) or >= q.
__device__ __forceinline__ int search(const int* a, int n, const int* q,
                                      int w, bool upper) {
  int lo = 0, hi = n;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    const int* r = a + (int64_t)mid * w;
    bool before = upper ? !lex_lt(q, r, w) : lex_lt(r, q, w);
    if (before) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// max(values[lo:hi]) from the sparse table st [L, n]; empty -> NEG_VERSION.
__device__ __forceinline__ int range_max(const int* st, int64_t n, int64_t lo,
                                         int64_t hi) {
  int64_t len = hi - lo;
  if (len <= 0) return NEG_VERSION;
  int lvl = 63 - __clzll(len);
  int64_t b = hi - ((int64_t)1 << lvl);
  int x = st[lvl * n + lo];
  int y = st[lvl * n + b];
  return x > y ? x : y;
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

// ----------------------------------------------------------------- K15

// Thread t < S*nq clips write slot t; past it (reads on), read slot
// t - S*nq. Rows are w words; lo/hi [S, w].
__global__ void k_wclip(const int* rb, const int* re, const bool* rm,
                        const int* wb, const int* we, const bool* wm,
                        int64_t nr, int64_t nq, int w, const int* lo,
                        const int* hi, int S, bool reads, int* owb, int* owe,
                        bool* owm, int* orb, int* ore, bool* orm) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int64_t nw_all = (int64_t)S * nq;
  const int *a, *z;
  const bool* m;
  int *oa, *oz;
  bool* om;
  int64_t n;
  if (t < nw_all) {
    a = wb; z = we; m = wm; oa = owb; oz = owe; om = owm; n = nq;
  } else {
    t -= nw_all;
    if (!reads || t >= (int64_t)S * nr) return;
    a = rb; z = re; m = rm; oa = orb; oz = ore; om = orm; n = nr;
  }
  int s = (int)(t / n);
  int64_t i = t % n;
  const int* l = lo + (int64_t)s * w;
  const int* h = hi + (int64_t)s * w;
  const int* x = a + i * w;
  const int* y = z + i * w;
  const int* cx = lex_lt(x, l, w) ? l : x;  // lex_max(begin, lo)
  const int* cy = lex_lt(y, h, w) ? y : h;  // lex_min(end, hi)
  for (int j = 0; j < w; ++j) {
    oa[t * w + j] = cx[j];
    oz[t * w + j] = cy[j];
  }
  om[t] = m[i] && lex_lt(cx, cy, w);
}

// Rows [B, R, w] / [B, Q, w], lo/hi [S, w]; outputs [S, B, ., w] and
// masks [S, B, .]; the read outputs are written only when reads != 0.
extern "C" int wsh_clip(const int* rb, const int* re, const bool* rm,
                        const int* wb, const int* we, const bool* wm, int B,
                        int R, int Q, int w, const int* lo, const int* hi,
                        int S, int reads, int* owb, int* owe, bool* owm,
                        int* orb, int* ore, bool* orm, cudaStream_t s) {
  const int T = 256;
  int64_t nr = (int64_t)B * R, nq = (int64_t)B * Q;
  int64_t n = (int64_t)S * (nq + (reads ? nr : 0));
  if (n > 0)
    k_wclip<<<blocks(n, T), T, 0, s>>>(rb, re, rm, wb, we, wm, nr, nq, w,
                                       lo, hi, S, reads != 0, owb, owe, owm,
                                       orb, ore, orm);
  return (int)cudaGetLastError();
}

// ----------------------------------------------------------------- K16

__global__ void k_wprobe(const int* keys, int C, int w, const int* st,
                         int64_t N, const int* rb, const int* re,
                         const bool* rm, const int* rv, const int* lo,
                         const int* hi, int B, int R, bool* hist_mask) {
  int64_t slot = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (slot >= (int64_t)B * R || !rm[slot]) return;
  int s = blockIdx.y;
  const int* qb = rb + slot * w;
  const int* qe = re + slot * w;
  if (lo) {
    const int* l = lo + (int64_t)s * w;
    const int* h = hi + (int64_t)s * w;
    if (lex_lt(qb, l, w)) qb = l;
    if (!lex_lt(qe, h, w)) qe = h;
  }
  if (!lex_lt(qb, qe, w)) return;  // empty in this shard
  const int* k = keys + (int64_t)s * C * w;
  int a = search(k, C, qb, w, true) - 1;
  if (a < 0) a = 0;
  int z = search(k, C, qe, w, false);
  int64_t base = (int64_t)s * C;
  if (range_max(st, N, base + a, base + z) > rv[slot / R])
    hist_mask[slot] = true;
}

__global__ void k_wprobe_finish(const bool* hist_mask, const int* rb,
                                const int* re, const bool* rm, const int* rv,
                                const bool* tm, const int* floor_p, int B,
                                int R, int w, bool* too_old, bool* hist,
                                bool* cand) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  bool has_reads = false, h = false;
  for (int r = 0; r < R; ++r) {
    int64_t i = (int64_t)b * R + r;
    has_reads |= rm[i] && lex_lt(rb + i * w, re + i * w, w);
    h |= hist_mask[i];
  }
  bool t = tm[b];
  bool to = t && has_reads && rv[b] < *floor_p;
  too_old[b] = to;
  hist[b] = h;
  cand[b] = t && !to && !h;
}

// keys [S, C, w], st [L, S*C]; reads [B, R, w]; lo/hi [S, w] or both null
// (no clip: the single flat engine). hist_mask [B, R] is the OR over the
// shards of each slot's conflict.
extern "C" int wsh_probe(const int* keys, int C, int w, const int* st, int S,
                         const int* rb, const int* re, const bool* rm,
                         const int* rv, const bool* tm, const int* lo,
                         const int* hi, const int* floor_p, int B, int R,
                         bool* hist_mask, bool* too_old, bool* hist,
                         bool* cand, cudaStream_t s) {
  const int T = 128;
  if (B <= 0) return (int)cudaGetLastError();
  if (R > 0) {
    cudaError_t e = cudaMemsetAsync(hist_mask, 0, (size_t)B * R, s);
    if (e != cudaSuccess) return (int)e;
    if (S > 0)
      k_wprobe<<<dim3(blocks((int64_t)B * R, T), S), T, 0, s>>>(
          keys, C, w, st, (int64_t)S * C, rb, re, rm, rv, lo, hi, B, R,
          hist_mask);
  }
  k_wprobe_finish<<<blocks(B, T), T, 0, s>>>(hist_mask, rb, re, rm, rv, tm,
                                             floor_p, B, R, w, too_old, hist,
                                             cand);
  return (int)cudaGetLastError();
}
