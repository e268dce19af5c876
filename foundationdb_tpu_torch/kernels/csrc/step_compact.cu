// K4: step-function rewrites — the paint, the base+delta fold, the dedup
// + compaction they share, and the gated fold's decision and delta reset.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   _paint_and_compact_res (:2196) -> _paint_tail (:925);
//   _merge_delta (:1243) as run by _maybe_merge (:1290) and advance_hist
//   (:1404), with _maybe_merge's decision and _reset_delta (:1229);
//   _dedup_compact (:977).
//
// Bound on the H100: bytes. The fold reads the base [C] and delta [Cd]
// keys and versions and rewrites the base (C = 2^20: ~8 MB of state); the
// paint touches Cd + 2BQ rows (~33 K), so one paint is launch cost.
//
// Design: merge-path tiles, one pass. A tile of 2048 rows of the merged
// sequence (old rows before equal new rows, the JAX merge order) takes a
// ticket from an atomic counter (tiles start in ticket order, so a tile
// only ever waits on tiles that are running or done), finds where its
// slices of the two sorted inputs start by one diagonal search each end,
// loads them into shared memory and merges them there; nothing merged is
// written to device memory. Each row's version is computed from the two
// slices and one halo row before each (the paint: the coverage delta and
// the version under a new endpoint; the fold: the pointwise max of base
// and delta). Two sums cross tiles, each by a decoupled look-back (one
// 64-bit word a tile holds a status and a value; a warp reads 32
// predecessors at once): the coverage before the tile (the paint only)
// and the survivors before it. The dedup needs, for the tile's first run
// of equal keys, the version of the row before that run (the previous
// dedup survivor, not the previous kept row). The run starts at the tile
// unless the row before the tile has its key; then one lower-bound search
// in each input finds the start. That row's version is computed from the
// inputs (for the paint, with the coverage there: the tile's coverage
// minus the deltas of the run's rows before the tile). Later runs of the
// tile read it from shared memory. The row forced to stay is
// the last row of the minimum key's run (the last row when every key is
// +inf). Survivors land in a scratch buffer, because an output slot can
// lie ahead of input rows a later tile has not read yet; a second launch
// copies them back, writes the +inf tail, n_used (clamped to the
// capacity), the sticky overflow and oldest, resets the look-back words
// and the ticket for the next call and, for a fold, resets the delta.
// The look-back state lives in a zeroed workspace that the wrapper keeps
// per device, stream and thread, and that the second launch leaves zeroed.
//
// The gated fold: the decision kernel reduces the expired base versions
// over the card (the last block decides) and writes it into a device
// flag; the fold's launches and K2's gated table read it and exit at once
// when it is false, so the decision never syncs with the host. sc_fold
// with a demand launches the decision, then the fold, from one call; with
// the delta reset fused into the fold's second launch, a step whose fold
// is not needed costs five launches: the decision, two fold launches, two
// table launches. sc_need and sc_reset are the decision and the reset
// alone, for K13's width-W fold.

#include <cuda_runtime.h>
#include <stdint.h>

#define I32MAX 2147483647
#define NEG_VERSION (-2147483647)
#define NEG_M1 (-2147483647 - 1)
#define FULL 0xffffffffu
#define NT 256             // threads a tile
#define NI 8               // merged rows a thread
#define TILE (NT * NI)     // merged rows a tile
#define WS_TICKET 0        // workspace words (uint64)
#define WS_RECLAIM 1
#define WS_DONE 2
#define WS_TOTAL 3
#define WS_WORDS 8         // then ntiles coverage words, ntiles count words

#define M_PAINT 0
#define M_FOLD 1
#define M_COMPACT 2

#include "lookback.cuh"

// ----------------------------------------------------------- the tile pass

struct TileArgs {
  const int* ak;  // A: the history (paint), the base (fold), the rows
  const int* av;
  int na;
  const int* bk;  // B (fold): the delta
  const int* bv;
  int nb;
  const int* wb;  // B (paint): the endpoints in src order
  const int* we;
  const bool* wmask;
  const bool* accepted;
  const int* src;
  int e2, q;
  int cv;
  const int* floor_p;
  int c_out;
  int* ok;  // survivors: scratch (paint, fold) or the output (compact)
  int* ov;
  u64* ws;
  int ntiles;
  const bool* need;
};

template <int MODE>
__device__ __forceinline__ int b_key(const TileArgs& p, int k) {
  if (MODE == M_PAINT) {
    int e = p.src[k];
    return e < p.e2 ? p.wb[e] : p.we[e - p.e2];
  }
  return p.bk[k];
}

// The paint's coverage delta of endpoint k (in src order).
__device__ __forceinline__ int paint_delta(const TileArgs& p, int k) {
  int e = p.src[k];
  bool begin = e < p.e2;
  int slot = begin ? e : e - p.e2;
  bool valid = p.accepted[slot / p.q] && p.wmask[slot] &&
               p.wb[slot] < p.we[slot];
  return valid ? (begin ? 1 : -1) : 0;
}

__device__ __forceinline__ int gc(int v, int key, int fl) {
  return (v <= fl || key == I32MAX) ? NEG_VERSION : v;
}

template <int MODE>
__global__ void __launch_bounds__(NT) k_tiles(TileArgs p) {
  if (p.need && !*p.need) return;
  __shared__ int s_key[TILE];
  __shared__ int s_val[TILE];
  __shared__ int s_scan[32];
  __shared__ int s_m[16];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int na = p.na, nb = p.nb, n = na + nb;
  const int fl = MODE == M_COMPACT ? 0 : *p.floor_p;

  if (tid == 0) s_m[0] = (int)atomicAdd(p.ws + WS_TICKET, 1ull);
  __syncthreads();
  const int t = s_m[0];
  const int d0 = t * TILE;
  const int d1 = min(n, d0 + TILE);
  const int len = d1 - d0;

  // The merge-path split of each end of the tile.
  if (warp < 2) {
    int diag = warp ? d1 : d0;
    int a = warp_search(max(0, diag - nb), min(diag, na), [&](int mid) {
      return p.ak[mid] <= b_key<MODE>(p, diag - 1 - mid);
    });
    if (lane == 0) s_m[1 + warp] = a;
  }
  __syncthreads();
  const int a0 = s_m[1], a1 = s_m[2], b0 = d0 - a0, b1 = d1 - a1;
  const int la = a1 - a0;

  // Warp 0: where the tile's first run starts in A and in B (the tile's
  // start, unless the run began before it: then one search in each), and
  // the row before that run, its version before coverage and the floor;
  // warp 1: the halos. All: the slices into shared memory.
  if (warp == 0) {
    const int fk = (a0 < a1 &&
                    (b0 >= b1 || p.ak[a0] <= b_key<MODE>(p, b0)))
                       ? p.ak[a0] : b_key<MODE>(p, b0);
    int pk = NEG_M1;  // the key of merged row d0 - 1
    if (a0 > 0) pk = p.ak[a0 - 1];
    if (b0 > 0) pk = max(pk, b_key<MODE>(p, b0 - 1));
    int fa = a0, fb = b0;
    if (d0 > 0 && pk == fk) {
      fa = warp_search(0, na, [&](int mid) { return p.ak[mid] < fk; });
      fb = warp_search(0, nb, [&](int mid) {
        return b_key<MODE>(p, mid) < fk;
      });
    }
    if (lane == 0) {
      int key_p = I32MAX, vp = NEG_M1;
      if (fa + fb > 0) {
        bool from_b = fb > 0 &&
                      (fa == 0 || p.ak[fa - 1] <= b_key<MODE>(p, fb - 1));
        if (MODE == M_COMPACT) {
          vp = p.av[fa - 1];
        } else if (from_b) {
          key_p = b_key<MODE>(p, fb - 1);
          int va = p.av[max(fa - 1, 0)];
          vp = MODE == M_PAINT ? va : max(p.bv[fb - 1], va);
        } else {
          key_p = p.ak[fa - 1];
          vp = MODE == M_PAINT ? p.av[fa - 1]
                               : max(p.av[fa - 1], p.bv[max(fb - 1, 0)]);
        }
      }
      s_m[3] = fa;
      s_m[4] = fb;
      s_m[13] = key_p;
      s_m[14] = vp;
    }
  } else if (warp == 1 && lane == 0) {
    int nxt = I32MAX, has = 0;
    if (a1 < na) { nxt = p.ak[a1]; has = 1; }
    if (b1 < nb) {
      int bk = b_key<MODE>(p, b1);
      nxt = has ? min(nxt, bk) : bk;
      has = 1;
    }
    s_m[5] = nxt;
    s_m[6] = has;
    s_m[7] = p.av[max(a0 - 1, 0)];
    s_m[8] = MODE == M_FOLD ? p.bv[max(b0 - 1, 0)] : 0;
    int k0 = na > 0 ? p.ak[0] : I32MAX;
    if (nb > 0) k0 = min(k0, b_key<MODE>(p, 0));
    s_m[9] = k0;
  }
  {
    // The slices, staged in registers so that a thread's loads are all in
    // flight at once (the paint's endpoints are two gathers deep).
    int lk[NI], lv[NI];
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      int i = tid + k * NT;
      if (i < la) {
        lk[k] = p.ak[a0 + i];
        lv[k] = p.av[a0 + i];
      } else if (i < len && MODE != M_PAINT) {
        lk[k] = p.bk[b0 + i - la];
        lv[k] = p.bv[b0 + i - la];
      } else if (i < len) {
        lv[k] = p.src[b0 + i - la];
      }
    }
    if (MODE == M_PAINT) {
#pragma unroll
      for (int k = 0; k < NI; ++k) {
        int i = tid + k * NT;
        if (i < la || i >= len) continue;
        int e = lv[k];
        bool begin = e < p.e2;
        int slot = begin ? e : e - p.e2;
        int a = p.wb[slot], z = p.we[slot];
        bool valid = p.accepted[slot / p.q] && p.wmask[slot] && a < z;
        lk[k] = begin ? a : z;
        lv[k] = valid ? (begin ? 1 : -1) : 0;
      }
    }
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      int i = tid + k * NT;
      if (i < len) {
        s_key[i] = lk[k];
        s_val[i] = lv[k];
      }
    }
  }
  __syncthreads();
  const int fa = s_m[3], fb = s_m[4];
  const int halo_a = s_m[7], halo_b = s_m[8];

  // Each thread merges NI rows from its own diagonal.
  const int lb = len - la;
  int ai, bi;
  {
    int diag = min(tid * NI, len);
    int lo = max(0, diag - lb), hi = min(diag, la);
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (s_key[mid] <= s_key[la + diag - 1 - mid]) lo = mid + 1;
      else hi = mid;
    }
    ai = lo;
    bi = diag - lo;
  }
  int key[NI], dc[NI], v[NI];
  int dsum = 0;
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    key[k] = I32MAX;
    dc[k] = 0;
    v[k] = NEG_VERSION;
    if (ai + bi >= len) continue;
    bool from_a = ai < la && (bi >= lb || s_key[ai] <= s_key[la + bi]);
    if (from_a) {
      key[k] = s_key[ai];
      if (MODE == M_FOLD)
        v[k] = max(s_val[ai], bi > 0 ? s_val[la + bi - 1] : halo_b);
      else
        v[k] = s_val[ai];
      ++ai;
    } else {
      key[k] = s_key[la + bi];
      int before_a = ai > 0 ? s_val[ai - 1] : halo_a;
      if (MODE == M_PAINT) {
        dc[k] = s_val[la + bi];
        v[k] = before_a;
      } else {
        v[k] = max(s_val[la + bi], before_a);
      }
      ++bi;
    }
    dsum += dc[k];
  }

  // The paint's coverage: the sum of the deltas of the tile's first run's
  // rows before the tile (usually none), then the look-back.
  int cov_excl = 0, run_cov = 0;
  if (MODE == M_PAINT) {
    int part = 0;
    for (int k = fb + tid; k < b0; k += NT) part += paint_delta(p, k);
    block_excl_sum(part, s_scan, &run_cov);
    int agg;
    int th = block_excl_sum(dsum, s_scan, &agg);
    if (warp == 0) {
      int e = look_back(p.ws + WS_WORDS, t, agg);
      if (lane == 0) s_m[10] = e;
    }
    __syncthreads();
    cov_excl = s_m[10];
    int cov = cov_excl + th;
#pragma unroll
    for (int k = 0; k < NI; ++k) {
      cov += dc[k];
      if (cov > 0) v[k] = p.cv;
    }
  } else {
    __syncthreads();  // every thread is done reading the slices
  }
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    if (MODE != M_COMPACT) v[k] = gc(v[k], key[k], fl);
    int r = tid * NI + k;
    if (r < len) {
      s_key[r] = key[k];
      s_val[r] = v[k];
    }
  }
  // The version of the row before the tile's first run (row fa + fb - 1).
  if (tid == 0) {
    int vp = s_m[14];
    if (fa + fb > 0 && MODE != M_COMPACT) {
      if (MODE == M_PAINT && cov_excl - run_cov > 0) vp = p.cv;
      vp = gc(vp, s_m[13], fl);
    }
    s_m[11] = vp;
  }
  __syncthreads();

  // Dedup: the last row of each run stays unless its version equals the
  // previous run's last row's; the minimum key's last row is forced.
  const int k0 = s_m[9], nxt = s_m[5], has_next = s_m[6];
  const int prev_first = s_m[11];
  int start = -1;
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    int r = tid * NI + k;
    if (r > 0 && r < len && s_key[r] != s_key[r - 1]) start = r;
  }
  int st = block_excl_max(start, s_scan);
  bool keep[NI];
  int kcount = 0;
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    int r = tid * NI + k;
    keep[k] = false;
    if (r >= len) continue;
    if (r > 0 && key[k] != s_key[r - 1]) st = r;
    bool keep1 = r + 1 < len ? key[k] != s_key[r + 1]
                             : (!has_next || key[k] != nxt);
    int prev = st < 0 ? prev_first : s_val[st - 1];
    bool forced = k0 != I32MAX ? (keep1 && key[k] == k0)
                               : (d0 + r == n - 1);
    keep[k] = forced || (keep1 && v[k] != prev && key[k] != I32MAX);
    kcount += keep[k];
  }
  int agg;
  int th = block_excl_sum(kcount, s_scan, &agg);
  if (warp == 0) {
    int e = look_back(p.ws + WS_WORDS + p.ntiles, t, agg);
    if (lane == 0) {
      s_m[12] = e;
      if (t == p.ntiles - 1) p.ws[WS_TOTAL] = (u64)(e + agg);
    }
  }
  __syncthreads();
  int idx = s_m[12] + th;
#pragma unroll
  for (int k = 0; k < NI; ++k) {
    if (!keep[k]) continue;
    if (idx < p.c_out) {
      p.ok[idx] = key[k];
      p.ov[idx] = v[k];
    }
    ++idx;
  }
}

// ----------------------------------------------------------- the finish

struct FinishArgs {
  const int* sk;  // survivors in scratch; null when written in place
  const int* sv;
  int* ok;
  int* ov;
  int c_out;
  int* n_used;
  bool* overflow;
  const bool* prior_a;
  const bool* prior_b;
  int* oldest;
  const int* floor_p;
  int* dk;  // the delta to reset (a fold), or null
  int* dv;
  int cd, dw;
  int* d_nused;
  int* d_oldest;
  u64* ws;
  int ntiles;
  const bool* need;
};

__global__ void k_finish(FinishArgs p) {
  if (p.need && !*p.need) return;
  const int total = (int)p.ws[WS_TOTAL];
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < p.c_out) {
    if (j >= total) {
      p.ok[j] = I32MAX;
      p.ov[j] = NEG_VERSION;
    } else if (p.sk) {
      p.ok[j] = p.sk[j];
      p.ov[j] = p.sv[j];
    }
  }
  if (p.dk && j < p.cd) {
    if (j > 0)
      for (int w = 0; w < p.dw; ++w) p.dk[(int64_t)j * p.dw + w] = I32MAX;
    p.dv[j] = NEG_VERSION;
  }
  if (j < 2 * p.ntiles) p.ws[WS_WORDS + j] = 0;
  if (j == 0) {
    *p.n_used = total < p.c_out ? total : p.c_out;
    bool prior = (p.prior_a && *p.prior_a) || (p.prior_b && *p.prior_b);
    *p.overflow = prior || total > p.c_out;
    if (p.oldest) *p.oldest = *p.floor_p;
    if (p.dk) {
      *p.d_nused = 1;
      *p.d_oldest = *p.floor_p;
    }
    p.ws[WS_TICKET] = 0;
  }
}

// ---------------------------------------------------------- the decision

// need = delta.n_used + demand > cd || #(NEG_VERSION < v <= floor) >= thr.
__global__ void k_need(const int* bv, int c, const int* floor_p,
                       const int* d_nused, int demand, int cd, int thr,
                       bool* need, u64* ws) {
  __shared__ int s_scan[32];
  const int fl = *floor_p;
  int cnt = 0;
  const int stride = gridDim.x * blockDim.x;
  const int c4 = (c & 3) == 0 && ((uintptr_t)bv & 15) == 0 ? c / 4 : 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < c4; i += stride) {
    int4 v = reinterpret_cast<const int4*>(bv)[i];
    cnt += (v.x <= fl && v.x > NEG_VERSION) + (v.y <= fl && v.y > NEG_VERSION)
         + (v.z <= fl && v.z > NEG_VERSION) + (v.w <= fl && v.w > NEG_VERSION);
  }
  for (int i = 4 * c4 + blockIdx.x * blockDim.x + threadIdx.x; i < c;
       i += stride) {
    int v = bv[i];
    cnt += v <= fl && v > NEG_VERSION;
  }
  int total;
  block_excl_sum(cnt, s_scan, &total);
  if (threadIdx.x == 0) {
    atomicAdd(ws + WS_RECLAIM, (u64)total);
    __threadfence();
    if (atomicAdd(ws + WS_DONE, 1ull) == gridDim.x - 1) {
      __threadfence();
      u64 sum = atomicAdd(ws + WS_RECLAIM, 0ull);
      *need = *d_nused + demand > cd || sum >= (u64)thr;
      ws[WS_RECLAIM] = 0;
      ws[WS_DONE] = 0;
    }
  }
}

__global__ void k_reset(int* dk, int cd, int w, int* dv, int* d_nused,
                        int* d_oldest, const int* floor_p, const bool* need) {
  if (need && !*need) return;
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j < cd) {
    if (j > 0)
      for (int k = 0; k < w; ++k) dk[(int64_t)j * w + k] = I32MAX;
    dv[j] = NEG_VERSION;
  }
  if (j == 0) {
    *d_nused = 1;
    *d_oldest = *floor_p;
  }
}

// ---------------------------------------------------------------- entries

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }
static inline int tiles(int64_t n) { return blocks(n, TILE); }

template <int MODE>
static int run(const TileArgs& a, FinishArgs f, cudaStream_t s) {
  int nt = a.ntiles;
  k_tiles<MODE><<<nt, NT, 0, s>>>(a);
  int64_t span = f.c_out;
  if (f.dk && f.cd > span) span = f.cd;
  if (2 * nt > span) span = 2 * nt;
  k_finish<<<blocks(span, 256), 256, 0, s>>>(f);
  return (int)cudaGetLastError();
}

// Paint the accepted writes into the history (keys/vers [c], in place);
// scratch holds 2c ints, ws the zeroed look-back state.
extern "C" int sc_paint(int* keys, int* vers, int c, int* n_used,
                        bool* overflow, int* oldest, const int* wb,
                        const int* we, const bool* wmask, const bool* accepted,
                        const int* src, int B, int Q, int cv,
                        const int* floor_p, int* scratch, u64* ws,
                        cudaStream_t s) {
  int n2 = 2 * B * Q;
  TileArgs a = {keys, vers, c, nullptr, nullptr, n2, wb, we, wmask,
                accepted, src, B * Q, Q, cv, floor_p, c, scratch,
                scratch + c, ws, tiles((int64_t)c + n2), nullptr};
  FinishArgs f = {scratch, scratch + c, keys, vers, c, n_used, overflow,
                  overflow, nullptr, oldest, floor_p, nullptr, nullptr, 0,
                  0, nullptr, nullptr, ws, a.ntiles, nullptr};
  return run<M_PAINT>(a, f, s);
}

static void launch_need(const int* bv, int c, const int* floor_p,
                        const int* d_nused, int demand, int cd, bool* need,
                        u64* ws, cudaStream_t s) {
  int nb = blocks(c, 256);
  if (nb > 132 * 4) nb = 132 * 4;
  int thr = c / 8 > 1 ? c / 8 : 1;
  k_need<<<nb, 256, 0, s>>>(bv, c, floor_p, d_nused, demand, cd, thr, need,
                            ws);
}

static int fold(int* bk, int* bv, int c, int* b_nused, bool* b_over,
                int* b_oldest, int* dk, int* dv, int cd, const bool* d_over,
                int* d_nused, int* d_oldest, int reset, const int* floor_p,
                const bool* need, int* scratch, u64* ws, cudaStream_t s) {
  TileArgs a = {bk, bv, c, dk, dv, cd, nullptr, nullptr, nullptr, nullptr,
                nullptr, 0, 1, 0, floor_p, c, scratch, scratch + c, ws,
                tiles((int64_t)c + cd), need};
  FinishArgs f = {scratch, scratch + c, bk, bv, c, b_nused, b_over, b_over,
                  d_over, b_oldest, floor_p, reset ? dk : nullptr, dv, cd, 1,
                  d_nused, d_oldest, ws, a.ntiles, need};
  return run<M_FOLD>(a, f, s);
}

// Fold the delta into the base (base arrays in place), gated on need (null:
// always). With reset, the delta is reset to its min-key row at the floor.
extern "C" int sc_fold(int* bk, int* bv, int c, int* b_nused, bool* b_over,
                       int* b_oldest, int* dk, int* dv, int cd,
                       const bool* d_over, int* d_nused, int* d_oldest,
                       int reset, const int* floor_p, const bool* need,
                       int* scratch, u64* ws, cudaStream_t s) {
  return fold(bk, bv, c, b_nused, b_over, b_oldest, dk, dv, cd, d_over,
              d_nused, d_oldest, reset, floor_p, need, scratch, ws, s);
}

// The gated step: the decision writes need, then the fold with the delta
// reset runs gated on it (three launches).
extern "C" int sc_fold_step(int* bk, int* bv, int c, int* b_nused,
                            bool* b_over, int* b_oldest, int* dk, int* dv,
                            int cd, const bool* d_over, int* d_nused,
                            int* d_oldest, const int* floor_p, int demand,
                            bool* need, int* scratch, u64* ws,
                            cudaStream_t s) {
  launch_need(bv, c, floor_p, d_nused, demand, cd, need, ws, s);
  return fold(bk, bv, c, b_nused, b_over, b_oldest, dk, dv, cd, d_over,
              d_nused, d_oldest, 1, floor_p, need, scratch, ws, s);
}

// Dedup + compaction alone (out of place).
extern "C" int sc_compact(const int* mk, const int* mv, int n, int c_out,
                          const bool* prior, int* ok, int* ov, int* n_used,
                          bool* overflow, u64* ws, cudaStream_t s) {
  TileArgs a = {mk, mv, n, nullptr, nullptr, 0, nullptr, nullptr, nullptr,
                nullptr, nullptr, 0, 1, 0, nullptr, c_out, ok, ov, ws,
                tiles(n), nullptr};
  FinishArgs f = {nullptr, nullptr, ok, ov, c_out, n_used, overflow, prior,
                  nullptr, nullptr, nullptr, nullptr, nullptr, 0, 0, nullptr,
                  nullptr, ws, a.ntiles, nullptr};
  return run<M_COMPACT>(a, f, s);
}

// The gated fold's decision into the 0-dim bool need (one launch), for a
// fold launched apart (K13's at width W).
extern "C" int sc_need(const int* bv, int c, const int* floor_p,
                       const int* d_nused, int demand, int cd, bool* need,
                       u64* ws, cudaStream_t s) {
  launch_need(bv, c, floor_p, d_nused, demand, cd, need, ws, s);
  return (int)cudaGetLastError();
}

// The delta reset alone (width w), gated on need (null: always).
extern "C" int sc_reset(int* dk, int cd, int w, int* dv, int* d_nused,
                        int* d_oldest, const int* floor_p, const bool* need,
                        cudaStream_t s) {
  k_reset<<<blocks(cd, 256), 256, 0, s>>>(dk, cd, w, dv, d_nused, d_oldest,
                                          floor_p, need);
  return (int)cudaGetLastError();
}
