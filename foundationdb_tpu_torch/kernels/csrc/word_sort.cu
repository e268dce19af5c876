// K14: a stable sort of [N, W] int32 key rows carrying int32 payload
// columns, and the endpoint ranks, which need no sorted output at all.
//
// Replaces (foundationdb_tpu/):
//   ops/lex.py sort_keys_with_payload (:160), i.e. lax.sort over the W
//   word columns with is_stable=True, where the unpacked flat programs run
//   it: models/conflict_kernel.py _endpoint_ranks (:291, with its
//   searchsorted_words(sorted, flat, side="left") of every endpoint into
//   the sorted rows, the rank tail) under endpoint_ranks_live (:365), and
//   _paint_and_compact (:869), which sorts the 2BQ new endpoint rows with
//   their coverage deltas and cross ranks.
//
// Bound on the H100: shared-memory traffic and dependent loads. The rows
// are small (N = 49,152 rows of W = 4 words for the endpoint ranks of a
// YCSB-A batch of 8192, 0.8 MB; 16,384 rows for a paint), so the bytes a
// sort must move take a microsecond; what costs is the compares, each a
// few dependent shared-memory loads at scattered rows.
//
// Design: merge by ranking, three launches. (1) Each block sorts a tile of
// T rows (T: the smallest power of two from 1024 that cuts N into at most
// 24 tiles, up to 2048 and less as W grows, so that the tile fits in the
// 227 KB of dynamic shared memory; N = 49,152 takes 24 tiles of 2048, a
// paint's 16,384 rows 16 of 1024). The rows of a tile share their words
// before the first word f where any two differ; an element is its two
// 64-bit heads (words f, f + 1 and f + 2, f + 3, the sign bits flipped so
// that unsigned order is the signed order) and its local index, and two
// elements compare by heads, then (past W = f + 4) by the rest of their
// rows in shared memory, then by index: a total order, so any sorting
// network gives the stable order. The network is bitonic, T / 4 threads
// holding 4 elements each: the stages whose pairs lie inside a warp's 128
// elements (most of them) run in registers, by shuffles, and only the
// others go through shared memory, which a stage of the whole tile would
// otherwise saturate. (2) A grid of (tile t, tile u) blocks, u != t: the
// count of tile u's rows before each row of tile t is the number of u's
// rows ahead of it in the merge of the two sorted tiles (t's row first on
// a tie for a later u and for the ranks: < counts; u's first for an
// earlier u: <=, which keeps equal rows in input order). The block stages
// both tiles' heads (compared at the smaller of the two f) and merges
// them by merge path, one diagonal search a thread and then a run of
// merged rows, adding each count to the row's slot by one atomic; two
// tiles that differ before that f do not interleave, and one adds all or
// nothing. A row's final position is its slot in its own tile plus those
// counts. (3) One scatter of keys and payloads. The ranks need no output
// order: rank[i] is the count of rows strictly less than row i, the start
// of its run in its sorted tile (launch 1) plus its counts in every other
// tile (launch 2), and launch 3 is the liveness masks of
// endpoint_ranks_live. Words compare as signed int32, which the key
// packing's bias makes the byte order. With one tile launch 2 is skipped,
// and a sort of one tile writes its output from launch 1. The input rows
// may come from up to four sections (read begins, read ends, write
// begins, write ends), read in place.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

#define MAX_SECS 4
#define MAX_PAY 4
#define EPT 4                 // elements a thread in launch 1
#define TILE_MAX 2048         // rows a tile, at most
#define TILE_MIN 256          // and at least
#define TILE_BASE 1024        // the first tile size tried
#define TILES 24              // tiles a call before the tile grows
#define CT 256                // threads a launch-2 block
#define STAGE 8               // loads in flight a thread
#define SMEM_DYN 231424       // dynamic shared memory of launch 1 (227 KB
                              // less 1 KB for its static arrays)
#define FULL 0xffffffffu

struct Rows {
  const int* p[MAX_SECS];
  int end[MAX_SECS];  // cumulative row counts of the sections
  int nsec;
  int w;
};

struct Pay {
  const int* in[MAX_PAY];
  int* out[MAX_PAY];
  int n;
};

struct OutSecs {
  int* p[MAX_SECS];
  int end[MAX_SECS];
  int nsec;
};

// Section of row i (a fixed chain of compares, so that the kernel
// parameters are read in place, never copied to local memory).
__device__ __forceinline__ int sec_of(const int* end, int nsec, int i) {
  return (nsec > 1 && i >= end[0]) + (nsec > 2 && i >= end[1]) +
         (nsec > 3 && i >= end[2]);
}

__device__ __forceinline__ const int* row_of(const Rows& r, int i) {
  const int s = sec_of(r.end, r.nsec, i);
  const int* p = s == 0 ? r.p[0] : s == 1 ? r.p[1] : s == 2 ? r.p[2] : r.p[3];
  const int base = s == 0 ? 0 : s == 1 ? r.end[0] : s == 2 ? r.end[1]
                                                          : r.end[2];
  return p + (int64_t)(i - base) * r.w;
}

__device__ __forceinline__ int* out_of(const OutSecs& o, int i) {
  const int s = sec_of(o.end, o.nsec, i);
  int* p = s == 0 ? o.p[0] : s == 1 ? o.p[1] : s == 2 ? o.p[2] : o.p[3];
  const int base = s == 0 ? 0 : s == 1 ? o.end[0] : s == 2 ? o.end[1]
                                                          : o.end[2];
  return p + (i - base);
}

// The 64-bit head of words a, b (unsigned order = the words' signed
// order), and of a row at word f (0 words past the row).
__device__ __forceinline__ u64 head_of(int a, int b) {
  return ((u64)((unsigned)a ^ 0x80000000u) << 32) |
         (u64)((unsigned)b ^ 0x80000000u);
}

__device__ __forceinline__ u64 head_at(const int* row, int f, int w) {
  return head_of(f < w ? row[f] : 0, f + 1 < w ? row[f + 1] : 0);
}

// Word e of a [total / w, w] run into shared memory at row stride ws,
// STAGE loads in flight a thread (get(e) reads word e).
template <class G>
__device__ __forceinline__ void stage(int* sk, int ws, int w, int total,
                                      G get) {
  const int nt = blockDim.x;
  for (int e0 = threadIdx.x; e0 < total; e0 += nt * STAGE) {
    int v[STAGE];
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      int e = e0 + u * nt;
      v[u] = e < total ? get(e) : 0;
    }
#pragma unroll
    for (int u = 0; u < STAGE; ++u) {
      int e = e0 + u * nt;
      if (e < total) {
        int r = e / w;
        sk[r * ws + e - r * w] = v[u];
      }
    }
  }
}

// A tile's sort state: its rows (stride ws), the first word where two of
// them differ, its real rows.
struct Tile {
  const int* sk;
  int ws, w, f, cnt;
};

// Element (hi, gi, i) before element (hj, gj, j): by the two heads, then
// the rest of the rows, then index; indices at or past cnt (a partial
// tile's padding, heads ~0) after every row.
__device__ __forceinline__ bool before(const Tile& t, u64 hi, u64 gi, int i,
                                       u64 hj, u64 gj, int j) {
  if (hi != hj) return hi < hj;
  if (gi != gj) return gi < gj;
  bool pi = i >= t.cnt, pj = j >= t.cnt;
  if (pi || pj) return pi != pj ? pj : i < j;
  for (int k = t.f + 4; k < t.w; ++k) {
    int a = t.sk[i * t.ws + k], b = t.sk[j * t.ws + k];
    if (a != b) return a < b;
  }
  return i < j;
}

// A thread's EPT elements of the bitonic network, striped: slot s of lane
// L of warp v is element 32 EPT v + 32 s + L.
struct Elems {
  u64 h[EPT], g[EPT];
  int x[EPT];
};

// The compare-exchange of slots s < t of one lane (element e of slot s):
// ascending (e & k == 0) leaves the smaller in s.
__device__ __forceinline__ void cx_slots(const Tile& tl, Elems& m, int s,
                                         int t, int e, int k) {
  const bool asc = !(e & k);
  if (before(tl, m.h[t], m.g[t], m.x[t], m.h[s], m.g[s], m.x[s]) == asc) {
    u64 a = m.h[s]; m.h[s] = m.h[t]; m.h[t] = a;
    a = m.g[s]; m.g[s] = m.g[t]; m.g[t] = a;
    int b = m.x[s]; m.x[s] = m.x[t]; m.x[t] = b;
  }
}

// One stage (k, j) of the network whose pairs lie inside the warp (j < 32
// EPT): across lanes by shuffles, across a lane's slots in registers.
__device__ __forceinline__ void warp_stage(const Tile& tl, Elems& m, int k,
                                           int j, int wbase) {
  const int lane = threadIdx.x & 31;
  if (j >= 32) {
    const int js = j >> 5;
#pragma unroll
    for (int s = 0; s < EPT; ++s)
#pragma unroll
      for (int t = s + 1; t < EPT; ++t)
        if ((s ^ t) == js) cx_slots(tl, m, s, t, wbase + 32 * s + lane, k);
    return;
  }
#pragma unroll
  for (int s = 0; s < EPT; ++s) {
    const u64 oh = __shfl_xor_sync(FULL, m.h[s], j);
    const u64 og = __shfl_xor_sync(FULL, m.g[s], j);
    const int ox = __shfl_xor_sync(FULL, m.x[s], j);
    const int e = wbase + 32 * s + lane;
    const bool asc = !(e & k), low = !(lane & j);
    // The low element keeps the smaller when ascending, the larger else.
    if (before(tl, oh, og, ox, m.h[s], m.g[s], m.x[s]) == (low == asc)) {
      m.h[s] = oh;
      m.g[s] = og;
      m.x[s] = ox;
    }
  }
}

// Launch 1: sort tile blockIdx.x of T rows (T / EPT threads) by a bitonic
// network: the stages whose pairs lie inside a warp's 32 EPT elements run
// in registers (shuffles), the others in shared memory. tk [N, w] gets the
// tile's sorted rows, th [N, 2] their heads, tf[tile] the tile's first
// differing word and ti the original index of each sorted row; for a sort,
// pos its slot in the tile (direct: the one tile's keys and payloads
// straight into the output); for the ranks, the start of each row's run
// in its sorted tile, at its original index.
__global__ void __launch_bounds__(TILE_MAX / EPT)
    k_tile_sort(Rows rows, int n, int T, int* tk, u64* th, int* tf, int* ti,
                int* pos, Pay pay, int direct, OutSecs rk) {
  extern __shared__ u64 smu[];
  __shared__ int s_red[32];
  __shared__ int s_f;
  const int w = rows.w, ws = w | 1, tid = threadIdx.x;
  const int lane = tid & 31, wbase = (tid >> 5) * 32 * EPT;
  u64* h1 = smu;                    // [T] first heads
  u64* h2 = h1 + T;                 // [T] second heads
  int* ix = (int*)(h2 + T);         // [T] local indices
  int* sk = ix + T;                 // [T, ws] the tile's rows, by index
  const int base = blockIdx.x * T;
  const int cnt = min(T, n - base);
  if (tid == 0) s_f = w;
  stage(sk, ws, w, cnt * w, [=](int e) {
    int r = e / w;
    return row_of(rows, base + r)[e - r * w];
  });
  __syncthreads();
  {  // f: the first word where some row differs from row 0
    int f = w;
    for (int r = tid; r < cnt; r += blockDim.x)
      for (int k = 0; k < f; ++k)
        if (sk[r * ws + k] != sk[k]) {
          f = k;
          break;
        }
    for (int o = 16; o; o >>= 1) f = min(f, __shfl_xor_sync(FULL, f, o));
    if ((tid & 31) == 0) atomicMin(&s_f, f);
  }
  __syncthreads();
  const Tile tl = {sk, ws, w, s_f, cnt};
  Elems m;
#pragma unroll
  for (int s = 0; s < EPT; ++s) {
    const int e = wbase + 32 * s + lane;
    m.h[s] = e < cnt ? head_at(sk + e * ws, tl.f, w) : ~0ull;
    m.g[s] = e < cnt ? head_at(sk + e * ws, tl.f + 2, w) : ~0ull;
    m.x[s] = e;
  }
  for (int k = 2; k <= 32 * EPT; k <<= 1)
    for (int j = k >> 1; j > 0; j >>= 1) warp_stage(tl, m, k, j, wbase);
  for (int k = 64 * EPT; k <= T; k <<= 1) {
#pragma unroll
    for (int s = 0; s < EPT; ++s) {
      const int e = wbase + 32 * s + lane;
      h1[e] = m.h[s];
      h2[e] = m.g[s];
      ix[e] = m.x[s];
    }
    __syncthreads();
    for (int j = k >> 1; j >= 32 * EPT; j >>= 1) {
      for (int p = tid; p < T / 2; p += blockDim.x) {
        const int a = 2 * j * (p / j) + (p & (j - 1)), b = a + j;
        const u64 ha = h1[a], ga = h2[a], hb = h1[b], gb = h2[b];
        const int xa = ix[a], xb = ix[b];
        if (before(tl, hb, gb, xb, ha, ga, xa) == !(a & k)) {
          h1[a] = hb; h2[a] = gb; ix[a] = xb;
          h1[b] = ha; h2[b] = ga; ix[b] = xa;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int s = 0; s < EPT; ++s) {
      const int e = wbase + 32 * s + lane;
      m.h[s] = h1[e];
      m.g[s] = h2[e];
      m.x[s] = ix[e];
    }
    __syncthreads();
    for (int j = 16 * EPT; j > 0; j >>= 1) warp_stage(tl, m, k, j, wbase);
  }
#pragma unroll
  for (int s = 0; s < EPT; ++s) {
    const int e = wbase + 32 * s + lane;
    h1[e] = m.h[s];
    h2[e] = m.g[s];
    ix[e] = m.x[s];
  }
  __syncthreads();

  for (int e = tid; e < cnt * w; e += blockDim.x) {
    int r = e / w, j = e - r * w;
    tk[(int64_t)(base + r) * w + j] = sk[ix[r] * ws + j];
  }
  for (int r = tid; r < cnt; r += blockDim.x) {
    th[2 * (int64_t)(base + r)] = h1[r];
    th[2 * (int64_t)(base + r) + 1] = h2[r];
    ti[base + r] = base + ix[r];
  }
  if (tid == 0) tf[blockIdx.x] = tl.f;
  if (rk.nsec) {  // the ranks: the start of each row's run
    int start = -1;
    unsigned neq = 0;  // bit s: row EPT tid + s differs from the row before
#pragma unroll
    for (int s = 0; s < EPT; ++s) {
      int r = EPT * tid + s;
      if (r <= 0 || r >= cnt) continue;
      bool differ = h1[r - 1] != h1[r] || h2[r - 1] != h2[r];
      for (int q = tl.f + 4; q < w && !differ; ++q)
        differ = sk[ix[r - 1] * ws + q] != sk[ix[r] * ws + q];
      if (differ) {
        neq |= 1u << s;
        start = r;
      }
    }
    int st = block_excl_max(start, s_red);
#pragma unroll
    for (int s = 0; s < EPT; ++s) {
      int r = EPT * tid + s;
      if (r >= cnt) continue;
      if (neq >> s & 1) st = r;
      *out_of(rk, base + ix[r]) = st < 0 ? 0 : st;
    }
  } else if (direct) {
    for (int r = tid; r < cnt; r += blockDim.x)
#pragma unroll
      for (int k = 0; k < MAX_PAY; ++k)
        if (k < pay.n) pay.out[k][r] = pay.in[k][ix[r]];
  } else {
    for (int r = tid; r < cnt; r += blockDim.x) pos[base + r] = r;
  }
}

// Launch 2: block (t, u), u != t. Tiles t (A) and u (B) are sorted; the
// count of B's rows before each row of A is the number of B rows ahead of
// it in their merge, with A's row first on a tie for the ranks and for a
// later u (< counts), B's first for an earlier u (<=). The block merges
// them by merge path (one diagonal search a thread, then CE merged rows)
// and adds each A row's count to its slot (a sort: pos at the row's sorted
// index; the ranks: the rank at its original index). The heads compare
// at g = min(f_t, f_u) (recomputed from the rows for a tile whose own f is
// larger); unless the tiles agree on their words before g, one tile lies
// wholly before the other.
__global__ void __launch_bounds__(CT) k_cross(int n, int w, int T,
                                              const int* tk, const u64* th,
                                              const int* tf, const int* ti,
                                              int* pos, OutSecs rk) {
  const int t = blockIdx.x, u = blockIdx.y;
  if (t == u) return;
  extern __shared__ u64 sm2[];  // [2, T] A's heads, [2, T] B's, then ints
  __shared__ int s_c;
  const int tid = threadIdx.x;
  const int ba = t * T, ca = min(T, n - ba);
  const int bb = u * T, cb = min(T, n - bb);
  const int ft = tf[t], fu = tf[u], g = min(ft, fu);
  const bool a_first = rk.nsec || u > t;
  if (tid == 0) {
    int c = 0;
    for (int j = 0; j < g && !c; ++j) {
      int x = tk[(int64_t)ba * w + j], y = tk[(int64_t)bb * w + j];
      c = x < y ? -1 : x > y;
    }
    s_c = c;
  }
  __syncthreads();
  const int c = s_c;
  if (c) {  // the tiles do not interleave: every A row counts none or all
    if (c > 0)
      for (int r = tid; r < ca; r += CT)
        atomicAdd(rk.nsec ? out_of(rk, ti[ba + r]) : pos + ba + r, cb);
    return;
  }
  u64* ah = sm2;
  u64* ag = ah + T;
  u64* bh = ag + T;
  u64* bg = bh + T;
  int* at = (int*)(bg + T);  // [T] A's original indices (the ranks)
  for (int r0 = tid; r0 < ca + cb; r0 += CT * STAGE) {
    u64 x[STAGE], y[STAGE];
    int o[STAGE];
#pragma unroll
    for (int k = 0; k < STAGE; ++k) {
      const int r = r0 + k * CT;
      const bool in_a = r < ca;
      const int q = in_a ? ba + r : bb + r - ca;
      x[k] = y[k] = 0;
      o[k] = rk.nsec && in_a ? ti[q] : 0;
      if (r >= ca + cb) continue;
      if ((in_a ? ft : fu) == g) {
        x[k] = th[2 * (int64_t)q];
        y[k] = th[2 * (int64_t)q + 1];
      } else {
        const int* row = tk + (int64_t)q * w;
        x[k] = head_at(row, g, w);
        y[k] = head_at(row, g + 2, w);
      }
    }
#pragma unroll
    for (int k = 0; k < STAGE; ++k) {
      const int r = r0 + k * CT;
      if (r < ca) {
        ah[r] = x[k];
        ag[r] = y[k];
        at[r] = o[k];
      } else if (r < ca + cb) {
        bh[r - ca] = x[k];
        bg[r - ca] = y[k];
      }
    }
  }
  __syncthreads();
  // A row i ahead of B row j in the merge.
  auto a_ahead = [&](int i, int j) {
    int d = ah[i] != bh[j] ? (ah[i] < bh[j] ? -1 : 1)
          : ag[i] != bg[j] ? (ag[i] < bg[j] ? -1 : 1) : 0;
    for (int k = g + 4; k < w && !d; ++k) {
      int x = tk[(int64_t)(ba + i) * w + k], y = tk[(int64_t)(bb + j) * w + k];
      d = x < y ? -1 : x > y;
    }
    return d < 0 || (d == 0 && a_first);
  };
  const int len = ca + cb;
  const int per = (len + CT - 1) / CT;
  const int d0 = min(tid * per, len), d1 = min(d0 + per, len);
  int lo = max(0, d0 - cb), hi = min(d0, ca);
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a_ahead(mid, d0 - 1 - mid)) lo = mid + 1;
    else hi = mid;
  }
  int ai = lo, bi = d0 - lo;
  for (int d = d0; d < d1; ++d) {
    if (ai < ca && (bi >= cb || a_ahead(ai, bi))) {
      if (bi) atomicAdd(rk.nsec ? out_of(rk, at[ai]) : pos + ba + ai, bi);
      ++ai;
    } else {
      ++bi;
    }
  }
}

// Launch 3 of a sort: every row to its final position with its payloads.
__global__ void k_scatter(int n, int w, const int* tk, const int* ti,
                          const int* pos, int* okeys, Pay pay) {
  int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int o = pos[p], src = ti[p];
  for (int j = 0; j < w; ++j) okeys[(int64_t)o * w + j] = tk[(int64_t)p * w + j];
#pragma unroll
  for (int k = 0; k < MAX_PAY; ++k)
    if (k < pay.n) pay.out[k][o] = pay.in[k][src];
}

// Launch 3 of the ranks: live = mask && begin rank < end rank.
__global__ void k_live(const int* rb, const int* re, const bool* rm,
                       const int* wb, const int* we, const bool* wm, int nr,
                       int nq, bool* rlive, bool* wlive) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nr) {
    rlive[i] = rm[i] && rb[i] < re[i];
  } else if (i < nr + nq) {
    int k = i - nr;
    wlive[k] = wm[k] && wb[k] < we[k];
  }
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

// Launch 1's shared memory for a tile of t rows: two head arrays, the
// indices, the rows at an odd stride.
static size_t sort_smem(int t, int w) {
  return (size_t)t * (2 * sizeof(u64) + sizeof(int) + (w | 1) * 4);
}

// Rows a tile for n rows of width w: the smallest power of two from
// TILE_BASE that cuts n into at most TILES tiles, within the largest
// whose launch 1 fits in shared memory; 0 if not even TILE_MIN rows fit.
static int tile_rows(int w, int n) {
  int cap = 0;
  for (int t = TILE_MAX; t >= TILE_MIN && !cap; t >>= 1)
    if (sort_smem(t, w) <= SMEM_DYN) cap = t;
  int t = cap < TILE_BASE ? cap : TILE_BASE;
  while (t < cap && blocks(n, t) > TILES) t <<= 1;
  return t;
}

// Lets launch 1 take SMEM_DYN bytes and launch 2 its four head arrays and
// A's indices, once per device.
static cudaError_t allow_smem() {
  static bool done[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || (dev < 64 && done[dev])) return e;
  e = cudaFuncSetAttribute(k_tile_sort,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           SMEM_DYN);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(k_cross,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TILE_MAX * (4 * sizeof(u64) + 4));
  if (e == cudaSuccess && dev < 64) done[dev] = true;
  return e;
}

// Launches 1 and 2 (2 only past one tile); returns the tile count or a
// negative CUDA error.
static int sort_tiles(const Rows& rows, int n, int* tk, u64* th, int* tf,
                      int* ti, int* pos, const Pay& pay, int direct,
                      const OutSecs& rk, cudaStream_t s) {
  int T = tile_rows(rows.w, n);
  if (!T) return -(int)cudaErrorInvalidValue;
  cudaError_t e = allow_smem();
  if (e != cudaSuccess) return -(int)e;
  int nt = blocks(n, T);
  k_tile_sort<<<nt, T / EPT, sort_smem(T, rows.w), s>>>(
      rows, n, T, tk, th, tf, ti, pos, pay, direct, rk);
  if (nt > 1)
    k_cross<<<dim3(nt, nt), CT, (size_t)T * (4 * sizeof(u64) + 4), s>>>(
        n, rows.w, T, tk, th, tf, ti, pos, rk);
  return nt;
}

// Stable sort of keys [n, w] with np <= 4 payload columns (p*[n]) into
// okeys [n, w] and o*[n]. Scratch: tk [n, w], th [n, 2] (8-byte words), ti
// and pos [n], tf [n / 256 + 1].
extern "C" int wso_sort(const int* keys, int n, int w, const int* p0,
                        const int* p1, const int* p2, const int* p3, int np,
                        int* okeys, int* o0, int* o1, int* o2, int* o3,
                        int* tk, u64* th, int* ti, int* pos, int* tf,
                        cudaStream_t s) {
  if (n <= 0) return (int)cudaGetLastError();
  Rows rows = {};
  rows.p[0] = keys;
  rows.end[0] = n;
  rows.nsec = 1;
  rows.w = w;
  Pay pay = {};
  const int* ins[MAX_PAY] = {p0, p1, p2, p3};
  int* outs[MAX_PAY] = {o0, o1, o2, o3};
  pay.n = np < MAX_PAY ? np : MAX_PAY;
  for (int k = 0; k < pay.n; ++k) {
    pay.in[k] = ins[k];
    pay.out[k] = outs[k];
  }
  OutSecs none = {};
  int direct = n <= tile_rows(w, n);
  int nt = sort_tiles(rows, n, direct ? okeys : tk, th, tf, ti, pos, pay,
                      direct, none, s);
  if (nt < 0) return -nt;
  if (!direct)
    k_scatter<<<blocks(n, 256), 256, 0, s>>>(n, w, tk, ti, pos, okeys, pay);
  return (int)cudaGetLastError();
}

// Endpoint ranks of a batch (read begins [nr, w], read ends, write begins
// [nq, w], write ends): the rank of every endpoint into the sorted
// multiset of all of them, into orb, ore [nr] and owb, owe [nq], and the
// liveness masks rlive [nr], wlive [nq]. Scratch: tk [n, w], th [n, 2]
// (8-byte words), ti [n] and tf [n / 256 + 1], n = 2 (nr + nq).
extern "C" int wso_ranks(const int* rb, const int* re, const int* wb,
                         const int* we, int nr, int nq, int w,
                         const bool* rm, const bool* wm, int* orb, int* ore,
                         int* owb, int* owe, bool* rlive, bool* wlive,
                         int* tk, u64* th, int* ti, int* tf,
                         cudaStream_t s) {
  int64_t n64 = 2 * ((int64_t)nr + nq);
  if (n64 <= 0) return (int)cudaGetLastError();
  int n = (int)n64;
  Rows rows = {};
  const int* secs[MAX_SECS] = {rb, re, wb, we};
  int lens[MAX_SECS] = {nr, nr, nq, nq};
  OutSecs o = {};
  int* outs[MAX_SECS] = {orb, ore, owb, owe};
  int acc = 0;
  for (int k = 0; k < MAX_SECS; ++k) {
    acc += lens[k];
    rows.p[k] = secs[k];
    rows.end[k] = acc;
    o.p[k] = outs[k];
    o.end[k] = acc;
  }
  rows.nsec = o.nsec = MAX_SECS;
  rows.w = w;
  Pay none = {};
  int nt = sort_tiles(rows, n, tk, th, tf, ti, nullptr, none, 0, o, s);
  if (nt < 0) return -nt;
  k_live<<<blocks((int64_t)nr + nq, 256), 256, 0, s>>>(
      orb, ore, rm, owb, owe, wm, nr, nq, rlive, wlive);
  return (int)cudaGetLastError();
}
