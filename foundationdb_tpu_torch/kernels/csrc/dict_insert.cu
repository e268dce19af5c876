// K1: resident dictionary insert, rank-row rewrites and version rebase.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   _dict_insert (:1948) and apply_delta (:2006) with the rank shifts
//   _shift_rank_rows / _shift_rank_vec / _shift_hist (:1980-2003);
//   the rank remap of apply_dict_remap (:2077);
//   the version shift of rebase (:1143) as used by _rebase_res_jit (:2353).
//
// Bound on the H100: bytes. The insert reads the [D+1, W] dictionary and
// writes it once (32 MB at D = 2^21, W = 4) with the [D+1] shift table;
// the rewrites stream the history rank rows once ([C] + [Cd] int32).
//
// Design: search by the delta, not by the dictionary. The TPU program
// built the merged dictionary by a gather over a merge-path plan; the
// first port searched every one of the D+1 dictionary rows into the
// delta. Here each of the M delta rows finds p[j], the dictionary rows
// <= it (a W-word binary search; a +inf row is past them all without
// one), so delta row j lands at q[j] = j + p[j] (strictly increasing).
// The output is cut into tiles of 2048 of the D+1+M merged positions; a
// tile finds its delta rows by one warp search over q, marks where they
// land in shared memory, and an exclusive count of the marks gives every
// position its source (delta row j0 + count, or dictionary row k - j0 -
// count) and every dictionary row its shift (the count: the delta rows
// strictly below it, since q is increasing). Positions past D+1 write
// only their shifts, which is how rows that fall off the end drop. The
// rows then move in coalesced W-word copies, a word a thread. That is the
// stable merge of the JAX program (dictionary rows before equal delta
// rows), +inf padding included. The rank rewrites are one elementwise
// launch over up to four arrays (base ranks, delta ranks, shard bounds)
// with INT32_MAX left invariant.

#include <cuda_runtime.h>
#include <stdint.h>

#define I32MAX 2147483647
#define NEG_VERSION (-2147483647)
#define FULL 0xffffffffu
#define KT 256           // threads a tile
#define KI 8             // positions a thread
#define KTILE (KT * KI)  // merged positions a tile

__device__ __forceinline__ bool lex_lt(const int* a, const int* b, int w) {
  for (int k = 0; k < w; ++k) {
    if (a[k] != b[k]) return a[k] < b[k];
  }
  return false;
}

// First index in [lo, hi) where pred is false (pred true on a prefix), or
// hi; a 32-way search by one whole warp.
template <class P>
__device__ __forceinline__ int warp_search(int lo, int hi, P pred) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    int step = (hi - lo + 31) / 32;
    int piv = lo + (lane + 1) * step - 1;
    bool t = piv < hi && pred(piv);
    int cnt = __popc(__ballot_sync(FULL, t));
    int nlo = cnt > 0 ? lo + cnt * step : lo;
    int nhi = lo + (cnt + 1) * step - 1;
    lo = nlo;
    hi = nhi < hi ? nhi : hi;
  }
  bool t = lo + lane < hi && pred(lo + lane);
  return lo + __popc(__ballot_sync(FULL, t));
}

// q[j] = j + (dictionary rows <= delta row j).
__global__ void k_positions(const int* dict, int d1, const int* delta,
                            int m, int w, int* q) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int* r = delta + (int64_t)j * w;
  bool inf = true;
  for (int k = 0; k < w; ++k) inf = inf && r[k] == I32MAX;
  int lo = inf ? d1 : 0, hi = d1;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (!lex_lt(r, dict + (int64_t)mid * w, w)) lo = mid + 1; else hi = mid;
  }
  q[j] = j + lo;
}

__global__ void __launch_bounds__(KT)
k_merge(const int* dict, int d1, const int* delta, int m, int w,
        const int* q, int* shift, int* out) {
  __shared__ int s_src[KTILE];  // >= 0: dictionary row; < 0: ~delta row
  __shared__ int s_scan[32];
  __shared__ int s_j[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int k0 = blockIdx.x * KTILE;
  const int k1 = min(k0 + KTILE, d1 + m);
  const int len = k1 - k0;
  if (warp < 2) {
    int key = warp ? k1 : k0;
    int j = warp_search(0, m, [&](int mid) { return q[mid] < key; });
    if (lane == 0) s_j[warp] = j;
  }
  for (int r = tid; r < KTILE; r += KT) s_src[r] = 0;
  __syncthreads();
  const int j0 = s_j[0], j1 = s_j[1];
  for (int j = j0 + tid; j < j1; j += KT) s_src[q[j] - k0] = 1;
  __syncthreads();
  // Exclusive count of the marks: thread-local, then across the block.
  int mark[KI], cnt = 0;
#pragma unroll
  for (int k = 0; k < KI; ++k) {
    mark[k] = s_src[tid * KI + k];
    cnt += mark[k];
  }
  int x = cnt;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_scan[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < KT / 32 ? s_scan[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, s, o);
      if (lane >= o) s += y;
    }
    s_scan[lane] = s;
  }
  __syncthreads();
  int before = j0 + x - cnt + (warp > 0 ? s_scan[warp - 1] : 0);
#pragma unroll
  for (int k = 0; k < KI; ++k) {
    int r = tid * KI + k;
    if (r >= len) break;
    if (mark[k]) {
      s_src[r] = ~before;
      ++before;
    } else {
      int i = k0 + r - before;
      s_src[r] = i;
      shift[i] = before;
    }
  }
  __syncthreads();
  // Word f of the tile's output is word c of row r; both step by KT words.
  const int live = min(k1, d1) - k0;
  const int words = live > 0 ? live * w : 0;
  int* dst = out + (int64_t)k0 * w;
  const int rstep = KT / w, cstep = KT - rstep * w;
  int r = tid / w, c = tid - r * w;
  for (int f = tid; f < words; f += KT) {
    int src = s_src[r];
    dst[f] = src >= 0 ? dict[(int64_t)src * w + c]
                      : delta[(int64_t)(~src) * w + c];
    r += rstep;
    c += cstep;
    if (c >= w) {
      c -= w;
      ++r;
    }
  }
}

// r -> r + table[clip(r)] (remap == 0) or table[clip(r)] (remap == 1).
__global__ void k_rewrite(int* a0, int n0, int* a1, int n1, int* a2, int n2,
                          int* a3, int n3, const int* table, int tn,
                          int remap) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int* a;
  if (i < n0) { a = a0; }
  else if ((i -= n0) < n1) { a = a1; }
  else if ((i -= n1) < n2) { a = a2; }
  else if ((i -= n2) < n3) { a = a3; }
  else return;
  int r = a[i];
  if (r == I32MAX) return;
  int c = r < 0 ? 0 : (r > tn - 1 ? tn - 1 : r);
  a[i] = remap ? table[c] : r + table[c];
}

__global__ void k_rebase(int* v0, int n0, int* v1, int n1, int delta) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  int* v;
  if (i < n0) { v = v0; }
  else if ((i -= n0) < n1) { v = v1; }
  else return;
  int x = v[i];
  v[i] = x < delta ? NEG_VERSION : x - delta;
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

// Insert the sorted delta [m, W] into the dictionary [d1, W]: out, shift
// [d1]; q is [m] ints of scratch.
extern "C" int di_insert(const int* dict, int d1, const int* delta, int m,
                         int w, int* shift, int* out, int* q, cudaStream_t s) {
  const int T = 256;
  if (m > 0) k_positions<<<blocks(m, T), T, 0, s>>>(dict, d1, delta, m, w, q);
  k_merge<<<blocks((int64_t)d1 + m, KTILE), KT, 0, s>>>(dict, d1, delta, m,
                                                        w, q, shift, out);
  return (int)cudaGetLastError();
}

extern "C" int di_rewrite(int* a0, int n0, int* a1, int n1, int* a2, int n2,
                          int* a3, int n3, const int* table, int tn,
                          int remap, cudaStream_t s) {
  int64_t n = (int64_t)n0 + n1 + n2 + n3;
  if (n > 0) {
    const int T = 256;
    k_rewrite<<<blocks(n, T), T, 0, s>>>(a0, n0, a1, n1, a2, n2, a3, n3,
                                         table, tn, remap);
  }
  return (int)cudaGetLastError();
}

extern "C" int di_rebase(int* v0, int n0, int* v1, int n1, int delta,
                         cudaStream_t s) {
  int64_t n = (int64_t)n0 + n1;
  if (n > 0) {
    const int T = 256;
    k_rebase<<<blocks(n, T), T, 0, s>>>(v0, n0, v1, n1, delta);
  }
  return (int)cudaGetLastError();
}
