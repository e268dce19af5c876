// K2: sparse-table build and the history probe.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   too_old_mask_packed (:1425) and _history_conflict_ranges_hist_res
//   (:2161) with its rank probes _rank_probe (:2129), i.e. ops/lex.py
//   searchsorted_words (:45) at W = 1; with no delta (a null delta key
//   array) the flat _history_conflict_ranges_res (:2136) of the resident
//   engine's flat history (FDB_TPU_HISTORY=batch);
//   ops/rmq.py sparse_table (:20) and range_max (:40).
//
// Bound on the H100: bytes for the table (the values read once, L levels
// of N int32 written: ~88 MB for the base at C = 2^20 after a fold, ~1 MB
// for the per-batch delta table), and dependent-load latency for the
// probe: every read slot runs two binary searches into each key array
// (~20 steps into the base, ~15 into the delta).
//
// Design, the table: JAX's clamped recurrence (row l reads row l-1 at
// min(i + 2^(l-1), N-1)) is, by induction, the windowed maximum
// ST[l, i] = max(values[i : min(i + 2^l, N)]). So one launch builds a
// group of levels l0+1 .. l1 from level l0 inside shared memory: level
// l0 seen at stride 2^l0 splits into 2^l0 interleaved sequences, and
// levels l0+1 .. l1 are windowed maxima of widths 2, 4, .. 2^(l1-l0) over
// each sequence. A block loads a tile of adjacent sequences (as many as
// fit beside their length, 32-byte sectors of them or more) with a halo
// of 2^(l1-l0) - 1 positions, padded with INT32_MIN past the end (a
// window that reaches the end already holds the last value, so this
// equals the clamp), and writes each level of the tile from there: one
// barrier a level (two copies of the tile in shared memory, each level
// reading one and writing the other), no global round trip. The first
// launch takes levels 1..12 from the values (row 0 is copied on the way),
// the next ones up to 10 levels each at a stride of 2^12 or more: two
// launches for N up to 2^22 (the per-batch delta table, the base table of
// C = 2^20), where the recurrence took one
// launch per level. Every block of a gated build (the demand-driven fold
// decides on the device whether the base table must be rebuilt) reads the
// flag and exits.
//
// Design, the probe: one thread per read slot, the R slots of a
// transaction on adjacent lanes of one warp (a group of P lanes, P the
// power of two >= R, at most 32). Each block first loads 2,048 evenly
// spaced keys ("fences") of both key arrays into shared memory, so the
// first ~11 steps of each search are shared loads and only the last
// steps (9 into a 2^20 base, 3 into a 16,386 delta) go to L2; the four
// searches of a slot then advance together, four independent loads a
// step. The answers are exactly upper_bound - 1 clamped at 0 and
// lower_bound. The slot mask, the too-old test and the transaction's OR
// (a shuffle over its lanes) are folded into the acceptance candidates.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define NEG_VERSION (-2147483647)
#define FULL 0xffffffffu

// Table: threads a block, int32 a tile holds (twice, in dynamic shared
// memory), the first group's levels and the later groups' levels.
#define TB_THREADS 1024
#define TB_TILE 16384
#define TB_FIRST 12
#define TB_NEXT 10
#define TB_GRID 264  // blocks a launch (two an SM of an H100); more tiles
                     // loop

// Probe: fences per key array.
#define PR_FENCES 2048
#define PR_THREADS 256

// Levels l0+1 .. l1 of st [levels, n] from level l0 (``src``: the values
// for l0 = 0, else row l0 of st); row 0 is written from the tile when
// ``write0``. A tile is 2^lrw adjacent residues mod 2^l0 by mt positions
// of their sequences, plus the halo (at most cap int32), held twice in
// shared memory: a level reads one copy and writes the other, one barrier
// a level.
__global__ void __launch_bounds__(TB_THREADS)
k_levels(const int* src, int* st, int n, int l0, int l1, int lrw, int mt,
         int cap, bool write0, const bool* need) {
  if (need && !*need) return;
  extern __shared__ int lv_sm[];  // [2][cap]
  const int rw = 1 << lrw;
  const int64_t stride = (int64_t)1 << l0;
  const int halo = (1 << (l1 - l0)) - 1;
  const int64_t ns = ((int64_t)n + stride - 1) / stride;  // positions
  const int64_t n_rt = stride >> lrw, n_mt = (ns + mt - 1) / mt;
  for (int64_t tile = blockIdx.x; tile < n_rt * n_mt; tile += gridDim.x) {
    const int64_t r0 = (tile % n_rt) << lrw, m0 = (tile / n_rt) * mt;
    const int own = (int)min((int64_t)mt, ns - m0) << lrw;  // written
    const int len = own + (halo << lrw);                     // held
    int* cur = lv_sm;
    int* nxt = lv_sm + cap;
    __syncthreads();  // the previous tile's last reads
    for (int u = threadIdx.x; u < len; u += TB_THREADS) {
      const int64_t idx = r0 + (u & (rw - 1)) + (m0 + (u >> lrw)) * stride;
      const int v = idx < n ? src[idx] : INT_MIN;
      cur[u] = v;
      if (write0 && u < own && idx < n) st[idx] = v;
    }
    for (int l = l0 + 1; l <= l1; ++l) {
      const int d = (1 << (l - 1 - l0)) << lrw;
      int* row = st + (int64_t)l * n;
      __syncthreads();
      for (int u = threadIdx.x; u < len; u += TB_THREADS) {
        const int v = u + d < len ? max(cur[u], cur[u + d]) : cur[u];
        nxt[u] = v;
        if (u < own) {
          const int64_t idx =
              r0 + (u & (rw - 1)) + (m0 + (u >> lrw)) * stride;
          if (idx < n) row[idx] = v;
        }
      }
      int* t = cur;
      cur = nxt;
      nxt = t;
    }
  }
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

struct Fenced {
  const int* a;  // the sorted keys
  int n, s;      // length, fence spacing
  const int* f;  // fences f[k] = a[k * s], k < nf (shared memory)
  int nf;
};

// The first index x with !(a[x] < q) (lower) or !(a[x] <= q) (upper),
// narrowed to [lo, hi] by the fences: x lies in ((k-1)s, min(ks, n)] for
// k the count of fences before it (x = 0 when k = 0).
__device__ __forceinline__ void fence_range(const Fenced& t, int q, bool upper,
                                            int& lo, int& hi) {
  int l = 0, h = t.nf;
  while (l < h) {
    int mid = (l + h) >> 1;
    int v = t.f[mid];
    if (upper ? v <= q : v < q) l = mid + 1; else h = mid;
  }
  lo = l == 0 ? 0 : (l - 1) * t.s + 1;
  hi = l == 0 ? 0 : min(l * t.s, t.n);
}

__device__ __forceinline__ void step(const int* a, int q, bool upper, int& lo,
                                     int& hi) {
  if (lo < hi) {
    int mid = (lo + hi) >> 1;
    int v = a[mid];
    if (upper ? v <= q : v < q) lo = mid + 1; else hi = mid;
  }
}

__device__ void load_fences(const int* a, int n, int* f, int& s, int& nf) {
  s = (n + PR_FENCES - 1) / PR_FENCES;
  nf = (n + s - 1) / s;
  for (int k = threadIdx.x; k < nf; k += blockDim.x) f[k] = a[(int64_t)k * s];
}

__global__ void __launch_bounds__(PR_THREADS)
k_probe(const int* bkeys, int c, const int* bst, const int* dkeys, int cd,
        const int* dst, const int* rb, const int* re, const bool* rmask,
        const int* rv, const bool* tmask, const int* floor_p, int B, int R,
        int P, bool* hist_mask, bool* too_old, bool* cand) {
  __shared__ int fb[PR_FENCES], fd[PR_FENCES];
  Fenced tb{bkeys, c, 0, fb, 0}, td{dkeys, cd, 0, fd, 0};
  load_fences(bkeys, c, fb, tb.s, tb.nf);
  if (dkeys) load_fences(dkeys, cd, fd, td.s, td.nf);
  __syncthreads();
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  int b = (int)(t / P), r0 = (int)(t % P);
  bool valid = b < B;
  int v = valid ? rv[b] : 0;
  bool has_reads = false, any_hist = false;
  for (int r = r0; valid && r < R; r += P) {
    int s = b * R + r;
    int qb = rb[s], qe = re[s];
    bool h = false;
    if (rmask[s] && qb < qe) {
      has_reads = true;
      int bl0, bh0, bl1, bh1, dl0 = 0, dh0 = 0, dl1 = 0, dh1 = 0;
      fence_range(tb, qb, true, bl0, bh0);
      fence_range(tb, qe, false, bl1, bh1);
      if (dkeys) {
        fence_range(td, qb, true, dl0, dh0);
        fence_range(td, qe, false, dl1, dh1);
      }
      while (bl0 < bh0 || bl1 < bh1 || dl0 < dh0 || dl1 < dh1) {
        step(bkeys, qb, true, bl0, bh0);
        step(bkeys, qe, false, bl1, bh1);
        step(dkeys, qb, true, dl0, dh0);
        step(dkeys, qe, false, dl1, dh1);
      }
      int nb = range_max(bst, c, max(bl0 - 1, 0), bl1);
      int nd = dkeys ? range_max(dst, cd, max(dl0 - 1, 0), dl1) : NEG_VERSION;
      h = max(nb, nd) > v;
    }
    hist_mask[s] = h;
    any_hist |= h;
  }
  for (int o = P >> 1; o > 0; o >>= 1) {
    has_reads |= __shfl_xor_sync(FULL, has_reads, o);
    any_hist |= __shfl_xor_sync(FULL, any_hist, o);
  }
  if (valid && r0 == 0) {
    bool tm = tmask[b];
    bool to = tm && has_reads && v < *floor_p;
    too_old[b] = to;
    cand[b] = tm && !to && !any_hist;
  }
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

// st [levels >= 2, n]; row 0 is copied from values unless they alias.
// Writes the number of kernel launches made into *launched when given.
extern "C" int hp_table(const int* values, int n, int levels, int* st,
                        const bool* need, int* launched, cudaStream_t s) {
  static bool smem_set[64];
  int dev = 0;
  cudaGetDevice(&dev);
  dev &= 63;
  if (!smem_set[dev]) {  // up to two 16,384-int32 tiles
    cudaError_t e = cudaFuncSetAttribute(
        k_levels, cudaFuncAttributeMaxDynamicSharedMemorySize, 8 * TB_TILE);
    if (e != cudaSuccess) return (int)e;
    smem_set[dev] = true;
  }
  int count = 0;
  for (int l0 = 0; n > 0 && l0 < levels - 1;) {
    int l1 = min(levels - 1, l0 + (l0 == 0 ? TB_FIRST : TB_NEXT));
    int halo = (1 << (l1 - l0)) - 1;
    // A tile holds as many adjacent residues as fit beside their whole
    // sequences (or as long a run of one as fits), so a group spreads over
    // whole tiles, not over many tiny ones.
    int64_t ns = ((int64_t)n + (1 << l0) - 1) >> l0;
    int lrw = 0;  // log2 residues a tile
    while (lrw < l0 && (min(ns, (int64_t)TB_TILE) + halo) << (lrw + 1)
                           <= TB_TILE)
      ++lrw;
    int mt = (TB_TILE >> lrw) - halo;
    if (l0 == 0)  // a small array: shorter tiles, more blocks
      mt = (int)min((int64_t)mt,
                    max((int64_t)256, (ns + TB_GRID - 1) / TB_GRID));
    int64_t tiles = ((int64_t)1 << (l0 - lrw)) * ((ns + mt - 1) / mt);
    int cap = (int)(min((int64_t)mt, ns) + halo) << lrw;
    k_levels<<<(int)min(tiles, (int64_t)TB_GRID), TB_THREADS, 8 * cap, s>>>(
        l0 == 0 ? values : st + (int64_t)l0 * n, st, n, l0, l1, lrw, mt, cap,
        l0 == 0 && values != st, need);
    ++count;
    l0 = l1;
  }
  if (launched) *launched = count;
  return (int)cudaGetLastError();
}

extern "C" int hp_probe(const int* bkeys, int c, const int* bst,
                        const int* dkeys, int cd, const int* dst,
                        const int* rb, const int* re, const bool* rmask,
                        const int* rv, const bool* tmask, const int* floor_p,
                        int B, int R, bool* hist_mask, bool* too_old,
                        bool* cand, cudaStream_t s) {
  int p = 1;
  while (p < R && p < 32) p *= 2;
  if (B > 0)
    k_probe<<<blocks((int64_t)B * p, PR_THREADS), PR_THREADS, 0, s>>>(
        bkeys, c, bst, dkeys, cd, dst, rb, re, rmask, rv, tmask, floor_p, B,
        R, p, hist_mask, too_old, cand);
  return (int)cudaGetLastError();
}
