// The sharded history probe of K8 (shard.cu, rank keys, W = 1) and K16
// (word_shard.cu, W-word keys): one design at two widths, over each
// shard's live rows only.
//
// Every row of a shard at or past its live count n_used[s] is (+inf,
// NEG_VERSION) (tests/test_torch_live_prefix.py checks it after every
// writer). A read's range clamped to a shard, [qb, qe) with qb < qe, has
// qb below +inf, so upper_bound(qb) and lower_bound(qe) over the shard's
// C rows equal those over its first n rows: the searches and the range
// max read only [0, n), with n read on the device (no host sync). A full
// shard (n = C) is searched whole.
//
// Range max (lp_build, then lp_max): for each shard, over its live rows,
// levels 1..LP_LV of the windowed maximum lv[l][i] = max(v[i : min(i +
// 2^l, n)]) (K2's sparse table cut at LP_LV), and a sparse table "top"
// over the block maxima of LP_BLOCK = 2^LP_LV rows (top[0][j] = lv[LP_LV]
// [j * LP_BLOCK]). A range of 1 row reads the value, one shorter than
// 2 * LP_BLOCK two entries of its level, a longer one its two ends at
// level LP_LV and the whole blocks between them from the top: four loads.
// One launch builds both: a tile of LP_OWN rows (and the LP_BLOCK - 1
// rows its last windows reach) in shared memory, two levels a pass, every
// block of a shard's column past its live rows exits at once; the last
// block of the column to finish (a ticket in a zeroed workspace, reset by
// that block) builds the shard's top from level LP_LV. The work is
// LP_LV writes a live row, not K2's ~23 over all S·C rows.
//
// The probe takes its range max from a policy (a template argument of
// lp_probe): the live table above or K2's table (LpTableMax), or K17's
// blocked structure over the same live rows (rmq_blocked.cu's RbMax).
//
// One level's probe (lp_level_probe, at the end): the packed engines'
// probe of a two-level history (a base with its prebuilt K2 table, and a
// per-batch level: the delta) or of a flat history (the level alone), the
// slots' bounds gathered by rank from K12's search. The per-batch level's
// range max comes from a policy over its live rows only: the live table
// (LpTableMax at S = 1; K12's sparse arm, word_probe.cu) or K17's blocked
// structure (RbMax; rmq_blocked.cu's rb_probe).
//
// Search (lp_probe): one thread a read slot, the R slots of a transaction
// on adjacent lanes (a group of P lanes, the power of two >= R up to 32).
// A block first stages, for every shard, F evenly spaced live rows
// ("fences", F·S·W words within LP_FENCE_WORDS) in shared memory with
// cp.async (one round trip); a slot clamped to a shard finds the fences
// around its begin and end there, then ends both searches in global
// memory, interleaved, a step of each a round. The lanes of a warp walk
// each its own shards (one for a point read), so they search together,
// not one shard after another. The answers are exactly upper_bound - 1
// clamped at 0 and lower_bound. The slot's conflict is the OR over the
// shards it touches, taken in the thread; the transaction's OR, the
// too-old test on the unclipped reads and the candidates follow from a
// shuffle over its lanes: no memset, no second launch, no atomics.
//
// Bound on the H100: dependent-load latency. The bytes are small (the
// read slots, and a few MB of live rows, L2-resident); what a call costs
// is the chain of loads of one slot (the fence staging, ~log2(F) shared
// steps, ~log2(n/F) steps into L2, the range max) and the build's passes.

#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define LP_NEG (-2147483647)
#define LP_LV 8
#define LP_BLOCK (1 << LP_LV)
#define LP_OWN 1024
#define LP_TOP_STAGE 4096  // top blocks staged in shared memory (C <= 2^20)
#define LP_BUILD_THREADS 512
#define LP_BUILD_GRID 264  // build blocks a launch over all shards
#define LP_THREADS 128
#define LP_MAX_FENCES 1024  // fences a shard
#define LP_FENCE_WORDS 8192

// Rows the top of one shard of capacity c covers, and its levels.
__host__ __device__ __forceinline__ int lp_nb(int c) {
  return c > 0 ? (c + LP_BLOCK - 1) / LP_BLOCK : 1;
}
__host__ __device__ __forceinline__ int lp_top_levels(int c) {
  int nb = lp_nb(c), l = 0;
  while (nb >> l) ++l;
  return l;  // floor(log2 nb) + 1
}

// Fences a shard for s shards of w-word rows (0: none, search [0, n)).
static inline int lp_fences(int s, int w) {
  int f = LP_FENCE_WORDS / (s * w);
  return f < LP_MAX_FENCES ? f : LP_MAX_FENCES;
}

__device__ __forceinline__ int lp_live(const int* n_used, int s, int c) {
  const int n = n_used[s];
  return n < 0 ? 0 : (n > c ? c : n);
}

// ---------------------------------------------------------------- build

// vals [S, C]; lv [LP_LV, S, C]; top [lp_top_levels(C), S, lp_nb(C)];
// tickets [S], zero on entry and on exit.
__global__ void __launch_bounds__(LP_BUILD_THREADS)
lp_build(const int* __restrict__ vals, const int* __restrict__ n_used,
         int S, int C, int* __restrict__ lv, int* __restrict__ top,
         int* tickets) {
  __shared__ int buf[2][LP_OWN + LP_BLOCK - 1];
  __shared__ int tbuf[2][LP_TOP_STAGE];
  __shared__ bool last;
  const int s = blockIdx.y;
  const int n = lp_live(n_used, s, C);
  const int* v = vals + (int64_t)s * C;
  for (int t = blockIdx.x; (int64_t)t * LP_OWN < n; t += gridDim.x) {
    const int i0 = t * LP_OWN;
    const int own = min(LP_OWN, n - i0);
    const int held = own + LP_BLOCK - 1;
    int* cur = buf[0];
    int* nxt = buf[1];
    __syncthreads();  // the previous tile's last reads
    for (int u = threadIdx.x; u < held; u += blockDim.x)
      cur[u] = i0 + u < n ? v[i0 + u] : INT_MIN;
    // Two levels a pass: level l and l + 1 from level l - 1 at distance
    // d = 2^(l-1) are the maxima of its rows u, u + d (and u + 2d, u + 3d)
    // that lie in the tile (the rest lie past n or serve no written row).
    for (int l = 1; l <= LP_LV; l += 2) {
      const int d = 1 << (l - 1);
      int* row = lv + ((int64_t)(l - 1) * S + s) * C + i0;
      int* row2 = row + (int64_t)S * C;
      __syncthreads();
      for (int u = threadIdx.x; u < held; u += blockDim.x) {
        const int x = u + d < held ? max(cur[u], cur[u + d]) : cur[u];
        int y = x;
        if (u + 2 * d < held) y = max(y, cur[u + 2 * d]);
        if (u + 3 * d < held) y = max(y, cur[u + 3 * d]);
        nxt[u] = l < LP_LV ? y : x;
        if (u < own) {
          row[u] = x;
          if (l < LP_LV) row2[u] = y;
        }
      }
      int* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(&tickets[s], 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // The top: every block of this shard's column has written its level
  // LP_LV rows (read through L2). Its levels are built in shared memory
  // when the blocks fit there (C up to 2^20), else level by level in
  // device memory.
  const int nb = (n + LP_BLOCK - 1) / LP_BLOCK, NB = lp_nb(C);
  const int* top_lv = lv + ((int64_t)(LP_LV - 1) * S + s) * C;
  int* t0 = top + (int64_t)s * NB;
  const bool staged = nb <= LP_TOP_STAGE;
  int* cur = tbuf[0];
  int* nxt = tbuf[1];
  for (int j = threadIdx.x; j < nb; j += blockDim.x) {
    const int x = __ldcg(top_lv + (int64_t)j * LP_BLOCK);
    t0[j] = x;
    if (staged) cur[j] = x;
  }
  for (int l = 1; (1 << l) <= nb; ++l) {
    const int d = 1 << (l - 1);
    const int* prev = top + ((int64_t)(l - 1) * S + s) * NB;
    int* row = top + ((int64_t)l * S + s) * NB;
    __syncthreads();
    for (int j = threadIdx.x; j < nb; j += blockDim.x) {
      if (staged) {
        const int x = j + d < nb ? max(cur[j], cur[j + d]) : cur[j];
        nxt[j] = x;
        row[j] = x;
      } else {
        row[j] = j + d < nb ? max(prev[j], prev[j + d]) : prev[j];
      }
    }
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (threadIdx.x == 0) tickets[s] = 0;
}

// max(v[a:z]) of shard s, 0 <= a <= z <= n; empty -> LP_NEG.
__device__ __forceinline__ int lp_max(const int* vals, const int* lv,
                                      const int* top, int S, int C, int s,
                                      int a, int z) {
  const int len = z - a;
  if (len <= 0) return LP_NEG;
  if (len == 1) return vals[(int64_t)s * C + a];
  if (len < 2 * LP_BLOCK) {
    const int l = 31 - __clz(len);
    const int* row = lv + ((int64_t)(l - 1) * S + s) * C;
    return max(row[a], row[z - (1 << l)]);
  }
  const int* row = lv + ((int64_t)(LP_LV - 1) * S + s) * C;
  const int x = max(row[a], row[z - LP_BLOCK]);
  const int ja = (a + LP_BLOCK - 1) >> LP_LV, jz = z >> LP_LV;
  const int l = 31 - __clz(jz - ja);  // jz - ja >= 1 here
  const int* t = top + ((int64_t)l * S + s) * lp_nb(C);
  return max(x, max(t[ja], t[jz - (1 << l)]));
}

// max(values[lo:hi]) from K2's sparse table st [L, N]; empty -> LP_NEG.
__device__ __forceinline__ int lp_max_k2(const int* st, int64_t N,
                                         int64_t lo, int64_t hi) {
  const int64_t len = hi - lo;
  if (len <= 0) return LP_NEG;
  const int l = 63 - __clzll(len);
  return max(st[l * N + lo], st[l * N + hi - ((int64_t)1 << l)]);
}

// ---------------------------------------------------------------- probe

// The probe's row widths: WK = 1 (ranks), 4 (four-word rows at 16-byte
// addresses, each row one vector load) or 0 (any w).
//
// -1, 0 or 1 as row a is below, equal to or above row q (w signed words;
// four of each row loaded before any compare).
template <int WK>
__device__ __forceinline__ int lp_cmp(const int* a, const int* q, int w) {
  if constexpr (WK == 1) {
    const int x = *a, y = *q;
    return x < y ? -1 : (x > y ? 1 : 0);
  } else if constexpr (WK == 4) {
    const int4 x = *reinterpret_cast<const int4*>(a);
    const int4 y = *reinterpret_cast<const int4*>(q);
    if (x.x != y.x) return x.x < y.x ? -1 : 1;
    if (x.y != y.y) return x.y < y.y ? -1 : 1;
    if (x.z != y.z) return x.z < y.z ? -1 : 1;
    if (x.w != y.w) return x.w < y.w ? -1 : 1;
    return 0;
  } else {
    for (int j = 0; j < w; j += 4) {
      int x[4], y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k] = j + k < w ? a[j + k] : 0;
        y[k] = j + k < w ? q[j + k] : 0;
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        if (x[k] != y[k]) return x[k] < y[k] ? -1 : 1;
    }
    return 0;
  }
}

// Does row a come before the answer: a <= q (upper) or a < q (lower)?
template <int WK>
__device__ __forceinline__ bool lp_before(const int* a, const int* q, int w,
                                          bool upper) {
  const int c = lp_cmp<WK>(a, q, w);
  return upper ? c <= 0 : c < 0;
}

// One step of a binary search of [lo, hi) in rows (w words a row).
template <int WK>
__device__ __forceinline__ void lp_step(const int* rows, int w, const int* q,
                                        bool upper, int& lo, int& hi) {
  if (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (lp_before<WK>(rows + (int64_t)mid * w, q, w, upper)) lo = mid + 1;
    else hi = mid;
  }
}

// The answers' intervals from the fences f (nf rows, every sp-th live
// row of n) for the upper bound of qb and the lower bound of qe, the two
// searches interleaved: x in ((k - 1) sp, min(k sp, n)] for k the fences
// before it (x = 0 when k = 0); [0, n) without fences.
template <int WK>
__device__ __forceinline__ void lp_fence(const int* f, int nf, int sp, int n,
                                         int w, const int* qb, const int* qe,
                                         int& l0, int& h0, int& l1,
                                         int& h1) {
  int a0 = 0, b0 = nf, a1 = 0, b1 = nf;
  while (a0 < b0 || a1 < b1) {
    lp_step<WK>(f, w, qb, true, a0, b0);
    lp_step<WK>(f, w, qe, false, a1, b1);
  }
  if (nf == 0) {
    l0 = l1 = 0;
    h0 = h1 = n;
    return;
  }
  l0 = a0 == 0 ? 0 : (a0 - 1) * sp + 1;
  h0 = a0 == 0 ? 0 : min(a0 * sp, n);
  l1 = a1 == 0 ? 0 : (a1 - 1) * sp + 1;
  h1 = a1 == 0 ? 0 : min(a1 * sp, n);
}

// Asynchronous copies into shared memory (cp.async): a thread issues all
// of its copies before it waits, so staging the fences costs one round
// trip.
__device__ __forceinline__ void lp_cp4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void lp_cp16(int* dst, const int* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
      (unsigned)__cvta_generic_to_shared(dst)), "l"(src));
}

__device__ __forceinline__ void lp_cp_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

struct LpArgs {
  const int* keys;  // [S, C, w]
  const int* vals;  // [S, C]
  const int* n_used;  // [S]
  const int* st;  // K2's table [L, S*C] in place of the live table, or null
  const int *rb, *re;  // [B, R, w]
  const bool* rm;
  const int* rv;
  const bool* tm;
  const int *lo, *hi;  // [S, w] or null (no clip)
  const int* floor_p;
  bool* hist_mask;  // [B, R] or null
  bool *too_old, *hist, *cand;
  int S, C, w, B, R, P, F;
};

// The first shard after s whose clip of [qb0, qe0) ([max(begin, lo),
// min(end, hi)), or the range itself without bounds) is not empty, with
// the clipped bounds in qb, qe; S if none.
template <int WK>
__device__ __forceinline__ int lp_next(const LpArgs& g, int s,
                                       const int* qb0, const int* qe0,
                                       const int*& qb, const int*& qe) {
  const int w = g.w;
  for (++s; s < g.S; ++s) {
    qb = qb0;
    qe = qe0;
    if (!g.lo) return s;
    const int* l = g.lo + (int64_t)s * w;
    const int* u = g.hi + (int64_t)s * w;
    if (lp_cmp<WK>(qb, l, w) < 0) qb = l;
    if (lp_cmp<WK>(u, qe, w) < 0) qe = u;
    if (lp_cmp<WK>(qb, qe, w) < 0) return s;
  }
  return s;
}

// The range max of lp_run's probe: max(v[a:z]) of shard s over the live
// table (lp_build's, in lv and top) or over K2's table st when given.
struct LpTableMax {
  const int *vals, *lv, *top, *st;
  int S, C;
  __device__ __forceinline__ int operator()(int s, int a, int z) const {
    return st ? lp_max_k2(st, (int64_t)S * C, (int64_t)s * C + a,
                          (int64_t)s * C + z)
              : lp_max(vals, lv, top, S, C, s, a, z);
  }
};

// mx(s, a, z): max(v[a:z]) of shard s, 0 <= a <= z <= n_used[s].
template <int WK, class Max>
__global__ void __launch_bounds__(LP_THREADS) lp_probe(LpArgs g, Max mx) {
  constexpr bool W1 = WK == 1;
  extern __shared__ __align__(16) int fence[];  // [S, F, w]
  const int S = g.S, C = g.C, w = g.w, F = g.F;
  if (F > 0) {
    // Rows of 16-byte multiples at 16-byte addresses copy 16 bytes at once.
    const bool v4 = !W1 && w % 4 == 0 && ((uintptr_t)g.keys & 15) == 0;
    const int q = v4 ? w / 4 : w;  // copies a fence row
    for (int s = 0; s < S; ++s) {
      const int n = lp_live(g.n_used, s, C);
      if (n == 0) continue;
      const int sp = (n + F - 1) / F, nf = (n + sp - 1) / sp;
      int* f = fence + s * F * w;
      const int* rows = g.keys + (int64_t)s * C * w;
      for (int u = threadIdx.x; u < nf * q; u += blockDim.x) {
        const int k = W1 ? u : u / q, j = W1 ? 0 : u - k * q;
        if (v4)
          lp_cp16(f + k * w + 4 * j, rows + (int64_t)k * sp * w + 4 * j);
        else
          lp_cp4(f + k * w + j, rows + (int64_t)k * sp * w + j);
      }
    }
    lp_cp_wait();
    __syncthreads();
  }
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = (int)(t / g.P), r0 = (int)(t % g.P);
  const bool valid = b < g.B;
  const int v = valid ? g.rv[b] : 0;
  bool has_reads = false, any = false;
  for (int r = r0; valid && r < g.R; r += g.P) {
    const int64_t slot = (int64_t)b * g.R + r;
    const int* qb0 = g.rb + slot * w;
    const int* qe0 = g.re + slot * w;
    const bool live = g.rm[slot] && lp_cmp<WK>(qb0, qe0, w) < 0;
    has_reads |= live;
    bool h = false;
    // Each lane walks the shards its slot overlaps (one for a point read):
    // the lanes of a warp search their own shards together, not one shard
    // after another.
    const int *qb, *qe;
    int s = live ? lp_next<WK>(g, -1, qb0, qe0, qb, qe) : S;
    while (s < S) {
      const int n = lp_live(g.n_used, s, C);
      const int sp = n > 0 ? (n + F - 1) / max(F, 1) : 0;
      const int nf = F > 0 && n > 0 ? (n + sp - 1) / sp : 0;
      const int* rows = g.keys + (int64_t)s * C * w;
      int l0, h0, l1, h1;
      lp_fence<WK>(fence + s * F * w, nf, sp, n, w, qb, qe, l0, h0, l1, h1);
      while (l0 < h0 || l1 < h1) {
        lp_step<WK>(rows, w, qb, true, l0, h0);
        lp_step<WK>(rows, w, qe, false, l1, h1);
      }
      h = mx(s, max(l0 - 1, 0), l1) > v;
      s = h ? S : lp_next<WK>(g, s, qb0, qe0, qb, qe);
    }
    if (g.hist_mask) g.hist_mask[slot] = h;
    any |= h;
  }
  for (int o = g.P >> 1; o > 0; o >>= 1) {
    has_reads |= __shfl_xor_sync(0xffffffffu, has_reads, o);
    any |= __shfl_xor_sync(0xffffffffu, any, o);
  }
  if (valid && r0 == 0) {
    const bool tmb = g.tm[b];
    const bool to = tmb && has_reads && v < *g.floor_p;
    g.too_old[b] = to;
    g.hist[b] = any;
    g.cand[b] = tmb && !to && !any;
  }
}

// The probe on stream st_ with the range max mx: one CUDA kernel.
template <class Max>
static inline int lp_probe_launch(LpArgs a, Max mx, cudaStream_t st_) {
  int p = 1;
  while (p < a.R && p < 32) p *= 2;
  a.P = p;
  a.F = a.S > 0 && a.w > 0 ? lp_fences(a.S, a.w) : 0;
  const size_t smem = (size_t)a.S * a.F * a.w * sizeof(int);
  const int64_t threads = (int64_t)a.B * p;
  const int grid = (int)((threads + LP_THREADS - 1) / LP_THREADS);
  // Four-word rows take the vector path when every row array is at a
  // 16-byte address (the staged fences always are).
  const bool a16 = ((uintptr_t)a.keys | (uintptr_t)a.rb | (uintptr_t)a.re |
                    (uintptr_t)a.lo | (uintptr_t)a.hi) % 16 == 0;
  if (a.w == 1)
    lp_probe<1, Max><<<grid, LP_THREADS, smem, st_>>>(a, mx);
  else if (a.w == 4 && a16)
    lp_probe<4, Max><<<grid, LP_THREADS, smem, st_>>>(a, mx);
  else
    lp_probe<0, Max><<<grid, LP_THREADS, smem, st_>>>(a, mx);
  return (int)cudaGetLastError();
}

// The build (unless a K2 table a.st is given) and the probe on stream st_;
// ws holds lv then top (kernels.live_table_words). The kernels launched
// are counted into *launched when given.
static inline int lp_run(LpArgs a, int* ws, int* tickets, int* launched,
                         cudaStream_t st_) {
  int count = 0;
  if (launched) *launched = 0;
  if (a.B <= 0) return (int)cudaGetLastError();
  LpTableMax mx{a.vals, nullptr, nullptr, a.st, a.S, a.C};
  if (!a.st && a.S > 0 && a.C > 0) {
    mx.lv = ws;
    mx.top = ws + (int64_t)LP_LV * a.S * a.C;
    int gx = (a.C + LP_OWN - 1) / LP_OWN, cap = LP_BUILD_GRID / a.S;
    gx = min(gx, max(cap, 1));
    lp_build<<<dim3(gx, a.S), LP_BUILD_THREADS, 0, st_>>>(
        a.vals, a.n_used, a.S, a.C, ws, ws + (int64_t)LP_LV * a.S * a.C,
        tickets);
    ++count;
  }
  const int rc = lp_probe_launch(a, mx, st_);
  ++count;
  if (launched) *launched = count;
  return rc;
}

// ------------------------------------------------------- one level's probe

// max(st[.][lo:hi]) over a sparse table [levels, n] (K2's); empty ->
// LP_NEG. The level row and both columns are clamped into the table (the
// JAX gather's clamp).
__device__ __forceinline__ int lp_table_max(const int* st, int n, int levels,
                                            int lo, int hi) {
  const int len = hi - lo;
  if (len <= 0) return LP_NEG;
  const int lvl = 31 - __clz(len);
  const int row = lvl < levels - 1 ? lvl : levels - 1;
  const int a = st[(int64_t)row * n + min(max(lo, 0), n - 1)];
  const int b = st[(int64_t)row * n + min(max(hi - (1 << lvl), 0), n - 1)];
  return max(a, b);
}

// a < b over w signed words (the packed key order; ranks at w = 1).
__device__ __forceinline__ bool lp_row_lt(const int* a, const int* b, int w) {
  for (int j = 0; j < w; ++j)
    if (a[j] != b[j]) return a[j] < b[j];
  return false;
}

struct LpLevelArgs {
  const int* bst;  // the base's sparse table [lb, cb], or null (flat)
  int cb, lb;
  const int *rs_b, *ls_b;  // the base's bounds (with bst)
  const int* n_used;  // the level's live count (0-dim)
  int n;  // the level's rows
  const int *rs_d, *ls_d;  // the level's bounds
  const int *idx_b, *idx_e;  // the slots' ranks into the bounds, or null
  const int *rows_b, *rows_e;  // [B, R, w]
  int w;
  const bool* rmask;
  const int* rv;
  const bool* tmask;
  const int* floor_p;
  int B, R, P;
  bool *hist_mask, *too_old, *cand;
};

// A transaction's R read slots on adjacent lanes (a group of P lanes, the
// power of two >= R up to 32). A live slot takes its bounds from the
// search (directly, or through its dictionary rank), the base's O(1) range
// max when there is a base, and mx(0, a, z), the level's range max over
// [a, z) with z clamped to the level's live count; the transaction's OR,
// the too-old test and the candidates follow from shuffles over its lanes.
template <class Max>
__global__ void __launch_bounds__(LP_THREADS) lp_level_probe(LpLevelArgs g,
                                                             Max mx) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int b = (int)(t / g.P), r0 = (int)(t % g.P);
  const bool valid = b < g.B;
  const int v = valid ? g.rv[b] : 0;
  const int live_n = lp_live(g.n_used, 0, g.n);
  bool has_reads = false, any = false;
  for (int r = r0; valid && r < g.R; r += g.P) {
    const int64_t s = (int64_t)b * g.R + r;
    const bool live = g.rmask[s] && lp_row_lt(g.rows_b + s * g.w,
                                              g.rows_e + s * g.w, g.w);
    bool h = false;
    if (live) {
      has_reads = true;
      const int64_t bi = g.idx_b ? g.idx_b[s] : s;
      const int64_t ei = g.idx_e ? g.idx_e[s] : s;
      int newest = LP_NEG;
      if (g.bst)
        newest = lp_table_max(g.bst, g.cb, g.lb, max(g.rs_b[bi] - 1, 0),
                              g.ls_b[ei]);
      const int nd = mx(0, max(g.rs_d[bi] - 1, 0), min(g.ls_d[ei], live_n));
      h = max(newest, nd) > v;
    }
    g.hist_mask[s] = h;
    any |= h;
  }
  for (int o = g.P >> 1; o > 0; o >>= 1) {
    has_reads |= __shfl_xor_sync(0xffffffffu, has_reads, o);
    any |= __shfl_xor_sync(0xffffffffu, any, o);
  }
  if (valid && r0 == 0) {
    const bool tm = g.tmask[b];
    const bool to = tm && has_reads && v < *g.floor_p;
    g.too_old[b] = to;
    g.cand[b] = tm && !to && !any;
  }
}

// The level probe on stream st_ with the range max mx: one CUDA kernel.
template <class Max>
static inline int lp_level_probe_launch(LpLevelArgs g, Max mx,
                                        cudaStream_t st_) {
  if (g.B <= 0) return (int)cudaGetLastError();
  g.P = 1;
  while (g.P < g.R && g.P < 32) g.P *= 2;
  const int64_t threads = (int64_t)g.B * g.P;
  const int grid = (int)((threads + LP_THREADS - 1) / LP_THREADS);
  lp_level_probe<Max><<<grid, LP_THREADS, 0, st_>>>(g, mx);
  return (int)cudaGetLastError();
}
