// K4: step-function rewrites — the paint, the base+delta fold, and the
// dedup + compaction they share.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   _paint_and_compact_res (:2196) -> _paint_tail (:925);
//   _merge_delta (:1243) as run by _maybe_merge (:1290) and advance_hist
//   (:1404);
//   _dedup_compact (:977).
//
// Bound on the H100: bytes. The fold reads base [C] and delta [Cd] keys and
// versions and rewrites the base (C = 2^20: ~8 MB of state, ~40 MB of
// scratch traffic through the two scans); the paint touches Cd + 2BQ rows
// (~33 K). Binary searches add dependent loads that mostly hit L2.
//
// Design: the TPU program merged by gathers only, because TPU scatters
// serialize. On Hopper each row is simply scattered to its merge slot: a
// new (or delta) row lands at its index plus the count of old (base) rows
// <= it, an old row at its index plus the count of new rows strictly
// below it. That is the JAX merge order (old rows before equal new rows),
// so the merged sequence is identical. The coverage sum and the keep
// prefix sum are hand-written device-wide inclusive scans (1024-element
// tiles scanned with warp shuffles, one block scanning the tile sums, one
// pass adding them back), so the fold over ~1 M rows spreads over the
// whole card. The dedup needs, per run of equal keys, the version of the
// previous run's last row (the previous dedup survivor, not the previous
// finally-kept row): the merged keys are sorted, so one lower-bound search
// finds the run start. The row forced to stay is the last row of the
// minimum key's run; n_used is clamped to the capacity and the sticky
// overflow set when the survivors do not fit. Each fold launch reads an
// optional device flag and exits at once when it is false, so the fold
// decision never syncs with the host.

#include <cuda_runtime.h>
#include <stdint.h>

#define I32MAX 2147483647
#define NEG_VERSION (-2147483647)
#define NEG_M1 (-2147483647 - 1)
#define FULL 0xffffffffu
#define ST 256
#define SI 4
#define STILE (ST * SI)

#define GATE if (need && !*need) return

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

// ---------------------------------------------------------------- scan

__device__ int block_incl_scan(int v, int* ws) {
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nwarps = blockDim.x >> 5;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  if (lane == 31) ws[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? ws[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    if (lane < nwarps) ws[lane] = s;
  }
  __syncthreads();
  if (warp > 0) v += ws[warp - 1];
  return v;
}

__global__ void k_scan_tile(const int* in, int* out, int n, int* bsum,
                            const bool* need) {
  GATE;
  __shared__ int ws[32];
  int64_t base = (int64_t)blockIdx.x * STILE + threadIdx.x * SI;
  int x[SI];
  int s = 0;
  for (int k = 0; k < SI; ++k) {
    x[k] = base + k < n ? in[base + k] : 0;
    s += x[k];
  }
  int incl = block_incl_scan(s, ws);
  int run = incl - s;
  for (int k = 0; k < SI; ++k) {
    run += x[k];
    if (base + k < n) out[base + k] = run;
  }
  if (threadIdx.x == blockDim.x - 1) bsum[blockIdx.x] = incl;
}

// Exclusive scan of the tile sums in place (one block).
__global__ void k_scan_sums(int* bsum, int nb, const bool* need) {
  GATE;
  __shared__ int ws[32];
  __shared__ int carry;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int c0 = 0; c0 < nb; c0 += blockDim.x) {
    int i = c0 + threadIdx.x;
    int v = i < nb ? bsum[i] : 0;
    int incl = block_incl_scan(v, ws);
    int cbase = carry;
    __syncthreads();
    if (i < nb) bsum[i] = cbase + incl - v;
    if (threadIdx.x == blockDim.x - 1) carry = cbase + incl;
    __syncthreads();
  }
}

__global__ void k_scan_add(int* out, int n, const int* bsum,
                           const bool* need) {
  GATE;
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] += bsum[i / STILE];
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

static void scan(const int* in, int* out, int n, int* bsum, const bool* need,
                 cudaStream_t s) {
  int nb = blocks(n, STILE);
  k_scan_tile<<<nb, ST, 0, s>>>(in, out, n, bsum, need);
  k_scan_sums<<<1, ST, 0, s>>>(bsum, nb, need);
  k_scan_add<<<blocks(n, 256), 256, 0, s>>>(out, n, bsum, need);
}

// ------------------------------------------------------- dedup + compact

// flag[i]: row i of the sorted merged sequence survives.
__global__ void k_keep(const int* mk, const int* mv, int n, int* flag,
                       const bool* need) {
  GATE;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int key = mk[i];
  bool keep1 = (i == n - 1) || key != mk[i + 1];
  bool keep = false;
  if (keep1 && key != I32MAX) {
    int s = lower_bound(mk, n, key);  // run start; row s-1 is the previous
    int prev_v = s > 0 ? mv[s - 1] : NEG_M1;  // dedup survivor
    keep = mv[i] != prev_v;
  }
  int k0 = mk[0];
  bool min_last = k0 != I32MAX ? (keep1 && key == k0) : (i == n - 1);
  flag[i] = keep || min_last;
}

__global__ void k_scatter(const int* mk, const int* mv, const int* flag,
                          const int* cum, int n, int c_out, int* ok, int* ov,
                          const bool* need) {
  GATE;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || !flag[i]) return;
  int k = cum[i] - 1;
  if (k < c_out) {
    ok[k] = mk[i];
    ov[k] = mv[i];
  }
}

__global__ void k_fill(const int* cum, int n, int c_out, int* ok, int* ov,
                       int* n_used, bool* overflow, const bool* prior_a,
                       const bool* prior_b, int* oldest_out,
                       const int* floor_p, const bool* need) {
  GATE;
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= c_out) return;
  int total = cum[n - 1];
  if (j >= total) {
    ok[j] = I32MAX;
    ov[j] = NEG_VERSION;
  }
  if (j == 0) {
    *n_used = total < c_out ? total : c_out;
    bool prior = (prior_a && *prior_a) || (prior_b && *prior_b);
    *overflow = prior || total > c_out;
    if (oldest_out) *oldest_out = *floor_p;
  }
}

// Compaction of the merged (mk, mv) into (ok, ov): t0/t1 are [n] scratch.
static void compact(const int* mk, const int* mv, int n, int c_out, int* ok,
                    int* ov, int* n_used, bool* overflow, const bool* prior_a,
                    const bool* prior_b, int* oldest_out, const int* floor_p,
                    int* t0, int* t1, int* bsum, const bool* need,
                    cudaStream_t s) {
  const int T = 256;
  k_keep<<<blocks(n, T), T, 0, s>>>(mk, mv, n, t0, need);
  scan(t0, t1, n, bsum, need, s);
  k_scatter<<<blocks(n, T), T, 0, s>>>(mk, mv, t0, t1, n, c_out, ok, ov, need);
  k_fill<<<blocks(c_out, T), T, 0, s>>>(t1, n, c_out, ok, ov, n_used,
                                        overflow, prior_a, prior_b,
                                        oldest_out, floor_p, need);
}

// ------------------------------------------------------------------ paint

__global__ void k_paint_new(const int* keys, const int* vers, int c,
                            const int* wb, const int* we, const bool* wmask,
                            const bool* accepted, const int* src, int B,
                            int Q, int* snew, int* mk, int* md, int* mv) {
  int e2 = B * Q;
  int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= 2 * e2) return;
  int e = src[k];
  bool is_begin = e < e2;
  int slot = is_begin ? e : e - e2;
  int a = wb[slot], z = we[slot];
  bool valid = accepted[slot / Q] && wmask[slot] && a < z;
  int rank = is_begin ? a : z;
  int cross = upper_bound(keys, c, rank);
  int64_t pos = (int64_t)k + cross;
  mk[pos] = rank;
  md[pos] = valid ? (is_begin ? 1 : -1) : 0;
  mv[pos] = vers[cross > 0 ? cross - 1 : 0];
  snew[k] = rank;
}

__global__ void k_paint_old(const int* keys, const int* vers, int c,
                            const int* snew, int n2, int* mk, int* md,
                            int* mv) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  int key = keys[i];
  int64_t pos = (int64_t)i + lower_bound(snew, n2, key);
  mk[pos] = key;
  md[pos] = 0;
  mv[pos] = vers[i];
}

__global__ void k_newv(const int* mk, const int* cov, int* mv, int n, int cv,
                       const int* floor_p) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int v = cov[i] > 0 ? cv : mv[i];
  mv[i] = (v <= *floor_p || mk[i] == I32MAX) ? NEG_VERSION : v;
}

// ------------------------------------------------------------------- fold

__global__ void k_fold_delta(const int* bk, const int* bv, int c,
                             const int* dk, const int* dv, int cd,
                             const int* floor_p, int* mk, int* mv,
                             const bool* need) {
  GATE;
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= cd) return;
  int key = dk[j];
  int cross = upper_bound(bk, c, key);
  int vb = bv[cross > 0 ? cross - 1 : 0];
  int v = vb > dv[j] ? vb : dv[j];
  int64_t pos = (int64_t)j + cross;
  mk[pos] = key;
  mv[pos] = (v <= *floor_p || key == I32MAX) ? NEG_VERSION : v;
}

__global__ void k_fold_base(const int* bk, const int* bv, int c,
                            const int* dk, const int* dv, int cd,
                            const int* floor_p, int* mk, int* mv,
                            const bool* need) {
  GATE;
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= c) return;
  int key = bk[i];
  int64_t pos = (int64_t)i + lower_bound(dk, cd, key);
  int cb = upper_bound(dk, cd, key);
  int vd = dv[cb > 0 ? cb - 1 : 0];
  int v = bv[i] > vd ? bv[i] : vd;
  mk[pos] = key;
  mv[pos] = (v <= *floor_p || key == I32MAX) ? NEG_VERSION : v;
}

// ---------------------------------------------------------------- entries

// Paint the accepted writes into the history (keys/vers [c], in place).
extern "C" int sc_paint(int* keys, int* vers, int c, int* n_used,
                        bool* overflow, int* oldest, const int* wb,
                        const int* we, const bool* wmask, const bool* accepted,
                        const int* src, int B, int Q, int cv,
                        const int* floor_p, int* snew, int* mk, int* mv,
                        int* t0, int* t1, int* bsum, cudaStream_t s) {
  const int T = 256;
  int n2 = 2 * B * Q;
  int n = c + n2;
  k_paint_new<<<blocks(n2, T), T, 0, s>>>(keys, vers, c, wb, we, wmask,
                                          accepted, src, B, Q, snew, mk, t0,
                                          mv);
  k_paint_old<<<blocks(c, T), T, 0, s>>>(keys, vers, c, snew, n2, mk, t0, mv);
  scan(t0, t1, n, bsum, nullptr, s);
  k_newv<<<blocks(n, T), T, 0, s>>>(mk, t1, mv, n, cv, floor_p);
  compact(mk, mv, n, c, keys, vers, n_used, overflow, overflow, nullptr,
          oldest, floor_p, t0, t1, bsum, nullptr, s);
  return (int)cudaGetLastError();
}

// Fold the delta into the base (base arrays in place); need may be null.
extern "C" int sc_fold(int* bk, int* bv, int c, int* b_nused, bool* b_over,
                       int* b_oldest, const int* dk, const int* dv, int cd,
                       const bool* d_over, const int* floor_p,
                       const bool* need, int* mk, int* mv, int* t0, int* t1,
                       int* bsum, cudaStream_t s) {
  const int T = 256;
  int n = c + cd;
  k_fold_delta<<<blocks(cd, T), T, 0, s>>>(bk, bv, c, dk, dv, cd, floor_p, mk,
                                           mv, need);
  k_fold_base<<<blocks(c, T), T, 0, s>>>(bk, bv, c, dk, dv, cd, floor_p, mk,
                                         mv, need);
  compact(mk, mv, n, c, bk, bv, b_nused, b_over, b_over, d_over, b_oldest,
          floor_p, t0, t1, bsum, need, s);
  return (int)cudaGetLastError();
}

// Dedup + compaction alone (out of place).
extern "C" int sc_compact(const int* mk, const int* mv, int n, int c_out,
                          const bool* prior, int* ok, int* ov, int* n_used,
                          bool* overflow, int* t0, int* t1, int* bsum,
                          cudaStream_t s) {
  compact(mk, mv, n, c_out, ok, ov, n_used, overflow, prior, nullptr, nullptr,
          nullptr, t0, t1, bsum, nullptr, s);
  return (int)cudaGetLastError();
}
