// K1: resident dictionary insert, rank-row rewrites and version rebase.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   _dict_insert (:1948) and apply_delta (:2006) with the rank shifts
//   _shift_rank_rows / _shift_rank_vec / _shift_hist (:1980-2003);
//   the rank remap of apply_dict_remap (:2077);
//   the version shift of rebase (:1143) as used by _rebase_res_jit (:2353).
//
// Bound on the H100: bytes. The insert reads the [D+1, W] dictionary and
// writes it once (32 MB at D = 2^21, W = 4); the searches are
// O(log M) dependent loads per dictionary row, served mostly from L2. The
// rewrites stream the history rank rows once ([C] + [Cd] int32).
//
// Design: the TPU program avoided scatters and built the merged dictionary
// by a gather over a merge-path plan. On Hopper a scatter is cheap, so the
// merge is two placement kernels: every dictionary row lands at
// i + shift[i] (shift = delta rows strictly below it, a left search), every
// delta row at j + (dictionary rows <= it) (a right search). That is the
// same stable merge, so the output is byte-identical, +inf padding
// included; rows whose slot falls past D+1 are dropped exactly as the
// gather drops them. The rank rewrites are one elementwise launch over up
// to four arrays (base ranks, delta ranks, shard bounds) with INT32_MAX
// left invariant.

#include <cuda_runtime.h>
#include <stdint.h>

#define I32MAX 2147483647
#define NEG_VERSION (-2147483647)

__device__ __forceinline__ bool lex_lt(const int* a, const int* b, int w) {
  for (int k = 0; k < w; ++k) {
    if (a[k] != b[k]) return a[k] < b[k];
  }
  return false;
}

// shift[i] = number of delta rows strictly below dict row i (side=left).
__global__ void k_shift(const int* dict, int d1, const int* delta, int m,
                        int w, int* shift) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d1) return;
  const int* q = dict + (int64_t)i * w;
  int lo = 0, hi = m;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (lex_lt(delta + (int64_t)mid * w, q, w)) lo = mid + 1; else hi = mid;
  }
  shift[i] = lo;
}

__global__ void k_place_old(const int* dict, int d1, int w, const int* shift,
                            int* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= d1) return;
  int64_t pos = (int64_t)i + shift[i];
  if (pos >= d1) return;
  for (int k = 0; k < w; ++k) out[pos * w + k] = dict[(int64_t)i * w + k];
}

// Delta row j lands after every dictionary row <= it (side=right).
__global__ void k_place_new(const int* dict, int d1, const int* delta, int m,
                            int w, int* out) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  const int* q = delta + (int64_t)j * w;
  int lo = 0, hi = d1;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (!lex_lt(q, dict + (int64_t)mid * w, w)) lo = mid + 1; else hi = mid;
  }
  int64_t pos = (int64_t)j + lo;
  if (pos >= d1) return;
  for (int k = 0; k < w; ++k) out[pos * w + k] = q[k];
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

extern "C" int di_insert(const int* dict, int d1, const int* delta, int m,
                         int w, int* shift, int* out, cudaStream_t s) {
  const int T = 256;
  k_shift<<<blocks(d1, T), T, 0, s>>>(dict, d1, delta, m, w, shift);
  k_place_old<<<blocks(d1, T), T, 0, s>>>(dict, d1, w, shift, out);
  if (m > 0) k_place_new<<<blocks(m, T), T, 0, s>>>(dict, d1, delta, m, w, out);
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
