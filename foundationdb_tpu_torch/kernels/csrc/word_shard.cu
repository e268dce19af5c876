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
// K15 is elementwise and bound by bytes: it reads the batch's [B, Q, W]
// write rows (and [B, R, W] read rows on a wave engine) once and writes
// each shard's clamped copy: begin -> lex_max(begin, lo_s), end ->
// lex_min(end, hi_s), mask -> mask && begin < end after the clamp, all as
// signed W-word compares (the key bias makes that the byte order). One
// block row per (array, slot range), a thread a slot: it loads the slot's
// begin and end rows once and loops over the S shards in registers, the
// shards' bounds staged in shared memory; at W = 4 a row is one 16-byte
// load or store wherever the pointers allow, any other W a word loop. Its
// card work is microseconds, so the window program checks the window's
// arrays and allocates the outputs once a window and each step launches
// unchecked into them (kernels.word_clip_into).
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

// a < b over 4 signed words.
__device__ __forceinline__ bool lt4(int4 a, int4 b) {
  if (a.x != b.x) return a.x < b.x;
  if (a.y != b.y) return a.y < b.y;
  if (a.z != b.z) return a.z < b.z;
  return a.w < b.w;
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

static inline bool aligned(const void* p, uintptr_t a) {
  return ((uintptr_t)p & (a - 1)) == 0;
}

// ----------------------------------------------------------------- K15

#define WCLIP_T 256
#define WCLIP_SMEM (48 * 1024)

// Block (x, y): slots [x·WCLIP_T, (x+1)·WCLIP_T) of the writes (y = 0) or
// the reads (y = 1). lo/hi [S, w] are staged in shared memory when they
// fit (STAGE; VEC needs them there: w = 4, 16-byte rows). Outputs
// [S, n, w] rows and [S, n] masks.
template <bool VEC, bool STAGE>
__global__ void __launch_bounds__(WCLIP_T)
k_wclip(const int* __restrict__ rb, const int* __restrict__ re,
        const bool* __restrict__ rm, const int* __restrict__ wb,
        const int* __restrict__ we, const bool* __restrict__ wm, int64_t nr,
        int64_t nq, int w, const int* __restrict__ lo,
        const int* __restrict__ hi, int S, int* owb, int* owe, bool* owm,
        int* orb, int* ore, bool* orm) {
  extern __shared__ int4 s_bounds4[];
  const bool rd = blockIdx.y != 0;
  const int *a = rd ? rb : wb, *z = rd ? re : we;
  const bool* m = rd ? rm : wm;
  const int64_t n = rd ? nr : nq;
  int *oa = rd ? orb : owb, *oz = rd ? ore : owe;
  bool* om = rd ? orm : owm;
  const int sw = S * w;
  const int *L = lo, *H = hi;
  if (STAGE) {
    int* sb = reinterpret_cast<int*>(s_bounds4);
    for (int t = threadIdx.x; t < sw; t += WCLIP_T) {
      sb[t] = lo[t];
      sb[sw + t] = hi[t];
    }
    __syncthreads();
    L = sb;
    H = sb + sw;
  }
  const int64_t i = (int64_t)blockIdx.x * WCLIP_T + threadIdx.x;
  if (i >= n) return;
  const bool mi = m[i];
  if (VEC) {
    const int4 x = reinterpret_cast<const int4*>(a)[i];
    const int4 y = reinterpret_cast<const int4*>(z)[i];
    for (int s = 0; s < S; ++s) {
      const int4 l = reinterpret_cast<const int4*>(L)[s];
      const int4 h = reinterpret_cast<const int4*>(H)[s];
      const int4 cx = lt4(x, l) ? l : x;  // lex_max(begin, lo)
      const int4 cy = lt4(y, h) ? y : h;  // lex_min(end, hi)
      const int64_t o = (int64_t)s * n + i;
      reinterpret_cast<int4*>(oa)[o] = cx;
      reinterpret_cast<int4*>(oz)[o] = cy;
      om[o] = mi && lt4(cx, cy);
    }
  } else {
    const int* x = a + i * w;
    const int* y = z + i * w;
    for (int s = 0; s < S; ++s) {
      const int* l = L + s * w;
      const int* h = H + s * w;
      const int* cx = lex_lt(x, l, w) ? l : x;
      const int* cy = lex_lt(y, h, w) ? y : h;
      const int64_t o = (int64_t)s * n + i;
      for (int j = 0; j < w; ++j) {
        oa[o * w + j] = cx[j];
        oz[o * w + j] = cy[j];
      }
      om[o] = mi && lex_lt(cx, cy, w);
    }
  }
}

template <bool VEC, bool STAGE>
static void launch_wclip(dim3 grid, size_t smem, cudaStream_t s,
                         const int* rb, const int* re, const bool* rm,
                         const int* wb, const int* we, const bool* wm,
                         int64_t nr, int64_t nq, int w, const int* lo,
                         const int* hi, int S, int* owb, int* owe, bool* owm,
                         int* orb, int* ore, bool* orm) {
  k_wclip<VEC, STAGE><<<grid, WCLIP_T, smem, s>>>(
      rb, re, rm, wb, we, wm, nr, nq, w, lo, hi, S, owb, owe, owm, orb, ore,
      orm);
}

// Rows [B, R, w] / [B, Q, w], lo/hi [S, w]; outputs [S, B, ., w] and
// masks [S, B, .]; the read outputs are written only when reads != 0. One
// CUDA kernel (none when there is nothing to clip).
extern "C" int wsh_clip(const int* rb, const int* re, const bool* rm,
                        const int* wb, const int* we, const bool* wm, int B,
                        int R, int Q, int w, const int* lo, const int* hi,
                        int S, int reads, int* owb, int* owe, bool* owm,
                        int* orb, int* ore, bool* orm, cudaStream_t s) {
  const int64_t nr = (int64_t)B * R, nq = (int64_t)B * Q;
  const int64_t n = reads && nr > nq ? nr : nq;
  if (n <= 0 || S <= 0 || w <= 0) return (int)cudaGetLastError();
  const size_t smem = (size_t)8 * S * w;
  const bool stage = smem <= WCLIP_SMEM;
  bool vec = stage && w == 4 && aligned(wb, 16) && aligned(we, 16) &&
             aligned(owb, 16) && aligned(owe, 16);
  if (reads)
    vec = vec && aligned(rb, 16) && aligned(re, 16) && aligned(orb, 16) &&
          aligned(ore, 16);
  const dim3 grid(blocks(n, WCLIP_T), reads ? 2 : 1);
  const size_t sm = stage ? smem : 0;
  if (vec)
    launch_wclip<true, true>(grid, sm, s, rb, re, rm, wb, we, wm, nr, nq, w,
                             lo, hi, S, owb, owe, owm, orb, ore, orm);
  else if (stage)
    launch_wclip<false, true>(grid, sm, s, rb, re, rm, wb, we, wm, nr, nq,
                              w, lo, hi, S, owb, owe, owm, orb, ore, orm);
  else
    launch_wclip<false, false>(grid, sm, s, rb, re, rm, wb, we, wm, nr, nq,
                               w, lo, hi, S, owb, owe, owm, orb, ore, orm);
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
