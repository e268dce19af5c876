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
// K16 is K8's design (live_probe.cuh) at W words: each shard's live rows
// only, a range-max structure over them built in one launch, then one
// launch that clamps each read slot to each shard in registers, ends the
// W-word upper-bound search of the begin and lower-bound search of the
// end past the shared fences (four words of a row loaded at once), takes
// the range max, writes the slot's byte of the [B, R] mask (its OR over
// the shards) and folds the too-old test on the UNCLIPPED reads (every
// shard judges too-old on the whole batch), the OR-ed conflict bit and
// the acceptance candidates. Given K2's table over the rows (the
// two-level engine's base keeps one), it reads that and builds nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include "live_probe.cuh"

// a < b over w signed words.
__device__ __forceinline__ bool lex_lt(const int* a, const int* b, int w) {
  for (int j = 0; j < w; ++j)
    if (a[j] != b[j]) return a[j] < b[j];
  return false;
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

// keys [S, C, w], versions [S, C], n_used [S] (live rows, read on the
// device); reads [B, R, w]; lo/hi [S, w] or both null (no clip: the single
// flat engine); st K2's table [L, S*C] (no build) or null (the live table
// in ws, tickets [S] zeroed). hist_mask [B, R] is the OR over the shards
// of each slot's conflict. Two CUDA kernels, or the probe alone given st,
// counted into *launched.
extern "C" int wsh_probe(const int* keys, int C, int w, const int* versions,
                         const int* n_used, int S, const int* st,
                         const int* rb, const int* re, const bool* rm,
                         const int* rv, const bool* tm, const int* lo,
                         const int* hi, const int* floor_p, int B, int R,
                         int* ws, int* tickets, bool* hist_mask,
                         bool* too_old, bool* hist, bool* cand,
                         int* launched, cudaStream_t s) {
  LpArgs a{};
  a.keys = keys;
  a.vals = versions;
  a.n_used = n_used;
  a.st = st;
  a.rb = rb;
  a.re = re;
  a.rm = rm;
  a.rv = rv;
  a.tm = tm;
  a.lo = lo;
  a.hi = hi;
  a.floor_p = floor_p;
  a.hist_mask = hist_mask;
  a.too_old = too_old;
  a.hist = hist;
  a.cand = cand;
  a.S = S;
  a.C = C;
  a.w = w;
  a.B = B;
  a.R = R;
  return lp_run(a, ws, tickets, launched, s);
}
