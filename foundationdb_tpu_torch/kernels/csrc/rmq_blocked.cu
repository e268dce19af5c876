// K17: the two-level blocked range max (the blocked RMQ arm).
//
// Replaces (foundationdb_tpu/ops/rmq.py):
//   block_table (:104): blocks of RMQ_BLOCK = 256 rows, padded with
//   NEG_VERSION, their in-block prefix and suffix cummax and a sparse
//   table ("top") over the block maxima;
//   range_max_blocked (:117), as the conflict kernel queries it under
//   FDB_TPU_RMQ=blocked (foundationdb_tpu/models/conflict_kernel.py :237,
//   :1329, :1471, :1612, :2143, :2176): the flat history's table, or the
//   delta's beside the base's prebuilt sparse table; and the sharded
//   probes under the same knob (:2143 under parallel/sharded_resolver.py
//   _res_shard_step, :237 under _sharded_resolve): each shard's blocked
//   range max over its flat history, OR-ed across the shards.
//
// Live rows. Every row of a history (of a shard) at or past its live
// count n_used is (+inf, NEG_VERSION) (tests/test_torch_live_prefix.py
// checks it after every writer). A range max over [a, z) with z <= C then
// equals the one over [a, min(z, n_used)): the rows past n_used add only
// NEG_VERSION, which is also the empty answer. So the build covers the
// live rows only, and a probe clamps its end to n_used, read on the
// device (no host sync). Without n_used (rb_build's null) the build
// covers all C rows, bit for bit JAX's block_table, and rb_query answers
// as the JAX range_max_blocked does, out-of-range indices included.
//
// Build (rb_build, one launch): a 512-thread block takes a tile of 16
// 256-row blocks of one history's live rows (grid-stride over the tiles,
// at most RB_BUILD_GRID blocks over all histories, one an SM: a block with
// no live tile exits at once, but is still launched). The warp of a 256-row block loads it in two
// coalesced halves (a lane's four rows of each, 16-byte loads), scans each
// lane's rows and then the lanes' maxima of each half forward and backward
// with shuffles: no barrier in the scan; prefix and suffix are stored
// four rows at once. The block maxima are row 0 of the
// top. The last of the blocks with live rows to finish (a ticket in a
// zeroed workspace, after a __threadfence, reset by that block; a history
// of one tile, or one whose tiles a single block scanned (a grid one block
// wide, S > 66), needs none: that block wrote every maximum) builds the top's
// other levels, table_levels(nb) in all for the nb live blocks, each from
// the one below with JAX's clamp (t[l][j] = max(t[l-1][j], t[l-1][min(j +
// 2^(l-1), nb - 1)])), in shared memory for up to RB_TOP_STAGE blocks (a
// shard of 2^20 rows), else in device memory. No second launch, no K2.
//
// Range max (rb_max) over [a, z) of the live rows: inside one block, the
// prefix entry when a starts the block, the suffix entry when z ends it,
// else the rows themselves (at most 254); across blocks, the suffix at a,
// the prefix at z - 1 and two entries of the top for the whole blocks
// between.
//
// Probes. rb_probe (the flat and two-level arms) is live_probe.cuh's level
// probe (lp_level_probe: a transaction's R read slots on adjacent lanes;
// each live slot's bounds from the search, directly or through its
// dictionary rank, the base's O(1) sparse range max when there is a base;
// the transaction's OR, the too-old test and the candidates from shuffles
// over its lanes, in the same launch) with the blocked range max over the
// level's live rows as its policy; K12's sparse arm (word_probe.cu) runs
// the same kernel with the live table. rb_shard_probe (the
// sharded arms) is live_probe.cuh's probe (K8's and K16's: fences staged
// in shared memory, each lane walking the shards its slot overlaps,
// searches over each shard's live rows) with rb_max as its range max,
// after rb_build over the S shards' live rows: two CUDA kernels a call.
//
// Bound on the H100: bytes for the build (the live versions read once,
// prefix and suffix written: 12 B a live row); dependent-load latency for
// the probes (a few words of L2 a slot).

#include <cuda_runtime.h>
#include <stdint.h>

#include "live_probe.cuh"

#define NEG_VERSION (-2147483647)
#define G 256
#define RB_ROWS 8            // rows a build thread scans
#define RB_BUILD_THREADS 512
#define RB_TILE (RB_ROWS * RB_BUILD_THREADS)  // 16 blocks a build tile
#define RB_BUILD_GRID 132    // build blocks a launch over all histories
#define RB_TOP_STAGE 4096    // top blocks built in shared memory
#define RB_THREADS 128

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }
__device__ __forceinline__ int iclamp(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Levels of a sparse table over n >= 1 entries (kernels.table_levels).
__host__ __device__ __forceinline__ int rb_levels(int n) {
  int c = 0;
  while ((1 << c) < n) ++c;  // ceil(log2 n)
  return (c > 1 ? c : 1) + 1;
}

// The JAX range_max_blocked over a whole structure of n values (nb
// blocks, the top [levels, nb]), out-of-range indices clamped as JAX
// clamps them: rb_query without n_used.
__device__ int blocked_max_jax(const int* vals, int n, const int* prefix,
                               const int* suffix, const int* top, int nb,
                               int levels, int lo, int hi) {
  if (hi <= lo) return NEG_VERSION;
  int last = hi - 1 > 0 ? hi - 1 : 0;
  int safe_lo = iclamp(lo, 0, nb * G - 1);
  int bl = safe_lo / G, il = safe_lo % G;
  int bh = last / G, ih = last % G;
  if (bl == bh) {
    int m = NEG_VERSION;
    int base = bl * G;
    for (int j = il; j <= ih; ++j) {
      int i = base + j;
      if (i < n) m = imax(m, vals[i]);
    }
    return m;
  }
  int bhc = bh < nb - 1 ? bh : nb - 1;
  int cross = imax(suffix[bl * G + il], prefix[bhc * G + ih]);
  return imax(cross, lp_table_max(top, nb, levels, bl + 1, bh));
}

// max(v[a:z]) of one history over its live rows, 0 <= a, z <= n; empty ->
// NEG_VERSION. pre/suf: its prefix and suffix rows; top level l, block j
// at top[l * tstride + j]. Every load a range needs but the rows of a long
// one inside a block is issued at once, before any branch: the lanes of a
// warp take different cases, and a load in each case would be a round trip
// each.
__device__ __forceinline__ int rb_max(const int* v, const int* pre,
                                      const int* suf, const int* top,
                                      int64_t tstride, int a, int z) {
  if (z <= a) return NEG_VERSION;
  const int e = z - 1, bl = a >> 8, bh = e >> 8, k = bh - bl - 1;
  const int rows = imax(imax(v[a], v[min(a + 1, e)]),
                        imax(v[min(a + 2, e)], v[min(a + 3, e)]));
  const int p = pre[e], q = suf[a];
  int t = NEG_VERSION;
  if (k > 0) {  // whole blocks between
    const int l = 31 - __clz(k);
    const int* r = top + l * tstride;
    t = imax(r[bl + 1], r[bh - (1 << l)]);
  }
  if (bl != bh) return imax(imax(p, q), t);
  if ((a & (G - 1)) == 0) return p;
  if ((z & (G - 1)) == 0) return q;
  int m = rows;
  for (int i = a + 4; i < z; ++i) m = imax(m, v[i]);
  return m;
}

// The blocked range max of rb_shard_probe (live_probe.cuh's policy):
// shard s's structure, prefix and suffix [S, NB * 256], top [L, S, NB].
struct RbMax {
  const int *vals, *prefix, *suffix, *top;
  int S, C, NB;
  __device__ __forceinline__ int operator()(int s, int a, int z) const {
    const int64_t off = (int64_t)s * NB * G;
    return rb_max(vals + (int64_t)s * C, prefix + off, suffix + off,
                  top + (int64_t)s * NB, (int64_t)S * NB, a, z);
  }
};

// ---------------------------------------------------------------- build

// x = v[i..i+3], rows at or past n read as NEG_VERSION; one 16-byte load
// when v is at a 16-byte address and all four rows are live.
__device__ __forceinline__ void rb_load4(const int* v, int i, int n, bool vec,
                                         int* x) {
  if (vec && i + 4 <= n) {
    const int4 q = __ldg(reinterpret_cast<const int4*>(v + i));
    x[0] = q.x, x[1] = q.y, x[2] = q.z, x[3] = q.w;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) x[k] = i + k < n ? v[i + k] : NEG_VERSION;
  }
}

// vals [S, C]; n_used [S] or null (every row); prefix, suffix [S, NB *
// 256]; top [rb_levels(NB), S, NB], the levels of the live blocks only;
// tickets [S], zero on entry and on exit.
__global__ void __launch_bounds__(RB_BUILD_THREADS)
k_build(const int* __restrict__ vals, const int* __restrict__ n_used, int S,
        int C, int NB, int* __restrict__ prefix, int* __restrict__ suffix,
        int* __restrict__ top, int* tickets) {
  __shared__ int wmax[RB_BUILD_THREADS / 32];
  __shared__ int tbuf[2][RB_TOP_STAGE];
  __shared__ bool last;
  const int s = blockIdx.y, t = threadIdx.x, lane = t & 31, wid = t >> 5;
  const int n = n_used ? lp_live(n_used, s, C) : C;
  // The blocks with live rows to scan; the others exit at once and take
  // no ticket.
  const int workers = min((int)gridDim.x, (n + RB_TILE - 1) / RB_TILE);
  if ((int)blockIdx.x >= workers) return;
  const int* v = vals + (int64_t)s * C;
  int* pre = prefix + (int64_t)s * NB * G;
  int* suf = suffix + (int64_t)s * NB * G;
  int* t0 = top + (int64_t)s * NB;
  const bool vec = ((uintptr_t)v & 15) == 0;
  for (int tile = blockIdx.x; (int64_t)tile * RB_TILE < n;
       tile += gridDim.x) {
    // A warp a 256-row block: lane l holds rows 4l..4l+3 (chunk a) and
    // 128 + 4l..128 + 4l+3 (chunk b), each chunk one coalesced load.
    const int blk = tile * (RB_TILE / G) + wid;
    const int ia = blk * G + 4 * lane, ib = ia + G / 2;
    int xa[4], xb[4];
    rb_load4(v, ia, n, vec, xa);
    rb_load4(v, ib, n, vec, xb);
    int pa[4], qa[4], pb[4], qb[4];  // in-chunk prefix and suffix
    pa[0] = xa[0], pb[0] = xb[0], qa[3] = xa[3], qb[3] = xb[3];
#pragma unroll
    for (int k = 1; k < 4; ++k) {
      pa[k] = imax(pa[k - 1], xa[k]);
      pb[k] = imax(pb[k - 1], xb[k]);
      qa[3 - k] = imax(qa[4 - k], xa[3 - k]);
      qb[3 - k] = imax(qb[4 - k], xb[3 - k]);
    }
    // The lanes' inclusive scans of each chunk, forward and backward.
    int fa = pa[3], fb = pb[3], ba = qa[0], bb = qb[0];
    for (int off = 1; off < 32; off <<= 1) {
      const int ya = __shfl_up_sync(0xffffffffu, fa, off);
      const int yb = __shfl_up_sync(0xffffffffu, fb, off);
      const int za = __shfl_down_sync(0xffffffffu, ba, off);
      const int zb = __shfl_down_sync(0xffffffffu, bb, off);
      if (lane >= off) fa = imax(fa, ya), fb = imax(fb, yb);
      if (lane + off < 32) ba = imax(ba, za), bb = imax(bb, zb);
    }
    const int ta = __shfl_sync(0xffffffffu, fa, 31);  // chunk maxima
    const int tb = __shfl_sync(0xffffffffu, fb, 31);
    int fae = __shfl_up_sync(0xffffffffu, fa, 1);  // exclusive
    int fbe = __shfl_up_sync(0xffffffffu, fb, 1);
    int bae = __shfl_down_sync(0xffffffffu, ba, 1);
    int bbe = __shfl_down_sync(0xffffffffu, bb, 1);
    if (lane == 0) fae = fbe = NEG_VERSION;
    if (lane == 31) bae = bbe = NEG_VERSION;
    fbe = imax(fbe, ta);  // chunk b's prefix spans chunk a
    bae = imax(bae, tb);  // chunk a's suffix spans chunk b
    if (blk * G < n) {  // a block with live rows (the whole warp)
      *reinterpret_cast<int4*>(pre + ia) =
          make_int4(imax(fae, pa[0]), imax(fae, pa[1]), imax(fae, pa[2]),
                    imax(fae, pa[3]));
      *reinterpret_cast<int4*>(pre + ib) =
          make_int4(imax(fbe, pb[0]), imax(fbe, pb[1]), imax(fbe, pb[2]),
                    imax(fbe, pb[3]));
      *reinterpret_cast<int4*>(suf + ia) =
          make_int4(imax(bae, qa[0]), imax(bae, qa[1]), imax(bae, qa[2]),
                    imax(bae, qa[3]));
      *reinterpret_cast<int4*>(suf + ib) =
          make_int4(imax(bbe, qb[0]), imax(bbe, qb[1]), imax(bbe, qb[2]),
                    imax(bbe, qb[3]));
      if (lane == 0) t0[blk] = imax(ta, tb);  // the block's maximum
    }
    if (lane == 0) wmax[wid] = imax(ta, tb);
  }
  int* cur = tbuf[0];
  int* nxt = tbuf[1];
  const int nb = (n + G - 1) / G;
  if (n <= RB_TILE) {
    // One tile held every live row (nb <= 16 blocks): its maxima are this
    // block's warp maxima, no ticket needed.
    __syncthreads();
    for (int j = t; j < nb; j += blockDim.x) cur[j] = wmax[j];
  } else {
    if (workers > 1) {
      __threadfence();
      __syncthreads();
      if (t == 0) last = atomicAdd(&tickets[s], 1) == workers - 1;
      __syncthreads();
      if (!last) return;
    } else {
      __syncthreads();  // one block scanned every tile: its own maxima
    }
    if (nb <= RB_TOP_STAGE)
      for (int j = t; j < nb; j += blockDim.x) cur[j] = __ldcg(t0 + j);
  }
  // The top's levels 1.. over the nb live blocks (every block of this
  // history has written its maximum), in shared memory up to
  // RB_TOP_STAGE blocks, else through L2.
  const int levels = rb_levels(nb);
  const int64_t ts = (int64_t)S * NB;
  const bool staged = nb <= RB_TOP_STAGE;
  for (int l = 1; l < levels; ++l) {
    const int d = 1 << (l - 1);
    const int* prev = t0 + (l - 1) * ts;
    int* row = t0 + l * ts;
    __syncthreads();
    for (int j = t; j < nb; j += blockDim.x) {
      const int k = min(j + d, nb - 1);
      if (staged) {
        const int y = imax(cur[j], cur[k]);
        nxt[j] = y;
        row[j] = y;
      } else {
        row[j] = imax(__ldcg(prev + j), __ldcg(prev + k));
      }
    }
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (t == 0 && workers > 1) tickets[s] = 0;
}

static inline int rb_launch_build(const int* vals, const int* n_used, int S,
                                  int C, int* prefix, int* suffix, int* top,
                                  int* tickets, cudaStream_t s) {
  const int NB = (C + G - 1) / G;
  int gx = (C + RB_TILE - 1) / RB_TILE, cap = RB_BUILD_GRID / S;
  gx = min(gx, max(cap, 1));
  k_build<<<dim3(gx, S), RB_BUILD_THREADS, 0, s>>>(
      vals, n_used, S, C, NB, prefix, suffix, top, tickets);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- query

__global__ void k_query(const int* vals, int n, const int* n_used,
                        const int* prefix, const int* suffix, const int* top,
                        int nb, int levels, const int* lo, const int* hi,
                        int nq, int* out) {
  int q = blockIdx.x * blockDim.x + threadIdx.x;
  if (q >= nq) return;
  if (!n_used) {
    out[q] = blocked_max_jax(vals, n, prefix, suffix, top, nb, levels, lo[q],
                             hi[q]);
    return;
  }
  const int live = lp_live(n_used, 0, n);
  out[q] = rb_max(vals, prefix, suffix, top, nb, imax(lo[q], 0),
                  min(hi[q], live));
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

// ---------------------------------------------------------------- entries

// The structure over vals [S, C] (S histories of C rows), over the live
// rows of each when n_used [S] is given, else over all C; prefix, suffix
// [S, ceil(C / 256) * 256], top [table_levels(ceil(C / 256)), S, ceil(C /
// 256)]; tickets [S] zeroed (left zeroed). One CUDA kernel.
extern "C" int rb_build(const int* vals, const int* n_used, int S, int C,
                        int* prefix, int* suffix, int* top, int* tickets,
                        cudaStream_t s) {
  if (S <= 0 || C <= 0) return (int)cudaGetLastError();
  return rb_launch_build(vals, n_used, S, C, prefix, suffix, top, tickets, s);
}

// max(vals[lo:hi]) per query over one history of n rows: with n_used, over
// its live rows (lo clamped at 0, hi at n_used); without, as the JAX
// range_max_blocked answers (the structure then covers all n rows).
extern "C" int rb_query(const int* vals, int n, const int* n_used,
                        const int* prefix, const int* suffix, const int* top,
                        int nb, int levels, const int* lo, const int* hi,
                        int nq, int* out, cudaStream_t s) {
  const int T = 256;
  if (nq > 0)
    k_query<<<blocks(nq, T), T, 0, s>>>(vals, n, n_used, prefix, suffix, top,
                                        nb, levels, lo, hi, nq, out);
  return (int)cudaGetLastError();
}

// The history probe over the live rows of one level of n rows (n_used its
// 0-dim live count) with its structure, and a base's sparse table bst when
// given.
extern "C" int rb_probe(const int* bst, int cb, int lb, const int* rs_b,
                        const int* ls_b, const int* vals, int n,
                        const int* n_used, const int* prefix,
                        const int* suffix, const int* top, int nb,
                        const int* rs_d, const int* ls_d, const int* idx_b,
                        const int* idx_e, const int* rows_b,
                        const int* rows_e, int w, const bool* rmask,
                        const int* rv, const bool* tmask,
                        const int* floor_p, int B, int R, bool* hist_mask,
                        bool* too_old, bool* cand, cudaStream_t s) {
  LpLevelArgs g{bst, cb, lb, rs_b, ls_b, n_used, n, rs_d, ls_d, idx_b,
                idx_e, rows_b, rows_e, w, rmask, rv, tmask, floor_p, B, R, 1,
                hist_mask, too_old, cand};
  return lp_level_probe_launch(g, RbMax{vals, prefix, suffix, top, 1, n, nb},
                               s);
}

// keys [S, C, w], versions [S, C], n_used [S] (live rows, read on the
// device); reads [B, R, w]; lo/hi [S, w] or both null (no clip); ws the
// structure (kernels.blocked_words(S, C)), tickets [S] zeroed; hist_mask
// [B, R] (the OR over the shards of each slot's conflict) or null. The
// build over the shards' live rows and live_probe.cuh's probe with its
// range max: two CUDA kernels, counted into *launched.
extern "C" int rb_shard_probe(const int* keys, int C, int w,
                              const int* versions, const int* n_used, int S,
                              const int* rb, const int* re, const bool* rm,
                              const int* rv, const bool* tm, const int* lo,
                              const int* hi, const int* floor_p, int B,
                              int R, int* ws, int* tickets, bool* hist_mask,
                              bool* too_old, bool* hist, bool* cand,
                              int* launched, cudaStream_t s) {
  int count = 0;
  *launched = 0;
  if (B <= 0) return (int)cudaGetLastError();
  const int NB = (C + G - 1) / G;
  RbMax mx{versions, ws, ws + (int64_t)S * NB * G,
           ws + 2 * (int64_t)S * NB * G, S, C, NB};
  if (S > 0 && C > 0) {
    const int rc = rb_launch_build(versions, n_used, S, C, ws,
                                   ws + (int64_t)S * NB * G,
                                   ws + 2 * (int64_t)S * NB * G, tickets, s);
    if (rc) return rc;
    ++count;
  }
  LpArgs a{};
  a.keys = keys;
  a.vals = versions;
  a.n_used = n_used;
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
  const int rc = lp_probe_launch(a, mx, s);
  ++count;
  *launched = count;
  return rc;
}
