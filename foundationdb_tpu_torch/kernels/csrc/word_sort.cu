// K14: a stable sort of [N, W] int32 key rows carrying int32 payload
// columns, with a rank tail.
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
// Bound on the H100: dependent loads. The rows are small (N = 49,152 rows
// of W = 4 words for the endpoint ranks of a YCSB-A batch of 8192, 0.8 MB;
// 16,384 rows for a paint), so the bytes a sort must move take a few
// microseconds; what costs is the chain of binary-search steps, each a
// W-word compare through an index, of the log2(N / T) global merge passes.
//
// Design: a merge sort of row INDICES, stable by construction, chosen over
// an LSD radix sort because stability then needs no care at all: a merge
// puts an element of the left run before the equal elements of the right
// run, and the left run holds the smaller original indices, so the order
// is (row, original index) at every pass. Each element finds its output
// slot independently (its index in its own run plus the count of the other
// run's elements that precede it, by one binary search: strictly smaller
// for a left element, smaller or equal for a right one), so a pass is one
// thread per element with no cooperation. The first log2(T) passes run in
// one block's shared memory over a tile of T rows (T = 1024 for W <= 10),
// the rest as global passes ping-ponging two index arrays. Words compare
// as signed int32, which the key packing's bias makes the byte order, so no
// sign flip is needed (a radix sort would have to flip each digit's top
// bit). A last launch gathers the keys and payloads by the permutation;
// the rank tail gives every input row the head of its run of equal rows in
// the sorted order (a lower-bound search into the sorted rows), written
// back at the row's original index, and ``wso_ranks`` adds the liveness
// masks of endpoint_ranks_live. The input rows may come from up to four
// sections (read begins, read ends, write begins, write ends), read in
// place.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_SECS 4
#define MAX_PAY 4
#define SMEM_CAP (48 * 1024)

struct Rows {
  const int* p[MAX_SECS];
  int64_t end[MAX_SECS];  // cumulative row counts of the sections
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
  int64_t end[MAX_SECS];
  int nsec;
};

__device__ __forceinline__ const int* row_of(const Rows& r, int64_t i) {
  int s = 0;
  while (s + 1 < r.nsec && i >= r.end[s]) ++s;
  int64_t base = s ? r.end[s - 1] : 0;
  return r.p[s] + (i - base) * r.w;
}

// -1, 0, 1: lexicographic order of two w-word rows (signed words).
__device__ __forceinline__ int cmp_rows(const int* a, const int* b, int w) {
  for (int j = 0; j < w; ++j)
    if (a[j] != b[j]) return a[j] < b[j] ? -1 : 1;
  return 0;
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

// Sort each tile of T = blockDim.x rows in shared memory; writes the
// tile's permutation (global indices) into perm.
__global__ void k_block_sort(Rows rows, int64_t n, int* perm) {
  extern __shared__ int sm[];
  const int T = blockDim.x, w = rows.w, t = threadIdx.x;
  int* sk = sm;           // [T, w] the tile's keys, by local index
  int* pa = sm + T * w;   // [T] local indices, current order
  int* pb = pa + T;       // [T] next order
  const int64_t base = (int64_t)blockIdx.x * T;
  const int cnt = (int)(n - base < T ? n - base : T);
  if (t < cnt) {
    const int* src = row_of(rows, base + t);
    for (int j = 0; j < w; ++j) sk[t * w + j] = src[j];
  }
  pa[t] = t;
  __syncthreads();
  for (int run = 1; run < cnt; run <<= 1) {
    if (t < cnt) {
      int start = (t / (2 * run)) * (2 * run);
      int mid = start + run < cnt ? start + run : cnt;
      int end = start + 2 * run < cnt ? start + 2 * run : cnt;
      int me = pa[t];
      const int* key = sk + me * w;
      int out;
      if (t < mid) {  // right-run elements strictly before me
        int lo = mid, hi = end;
        while (lo < hi) {
          int m = (lo + hi) >> 1;
          if (cmp_rows(sk + pa[m] * w, key, w) < 0) lo = m + 1; else hi = m;
        }
        out = t + (lo - mid);
      } else {  // left-run elements at or before me
        int lo = start, hi = mid;
        while (lo < hi) {
          int m = (lo + hi) >> 1;
          if (cmp_rows(sk + pa[m] * w, key, w) <= 0) lo = m + 1; else hi = m;
        }
        out = start + (t - mid) + (lo - start);
      }
      pb[out] = me;
    }
    __syncthreads();
    int* tmp = pa; pa = pb; pb = tmp;
  }
  if (t < cnt) perm[base + t] = (int)(base + pa[t]);
}

// One global merge pass: runs of `run` sorted elements of pin -> runs of
// 2 * run in pout.
__global__ void k_merge(Rows rows, int64_t n, int64_t run, const int* pin,
                        int* pout) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int64_t start = (i / (2 * run)) * (2 * run);
  int64_t mid = start + run < n ? start + run : n;
  int64_t end = start + 2 * run < n ? start + 2 * run : n;
  int me = pin[i];
  const int* key = row_of(rows, me);
  int w = rows.w;
  int64_t out;
  if (i < mid) {
    int64_t lo = mid, hi = end;
    while (lo < hi) {
      int64_t m = (lo + hi) >> 1;
      if (cmp_rows(row_of(rows, pin[m]), key, w) < 0) lo = m + 1; else hi = m;
    }
    out = i + (lo - mid);
  } else {
    int64_t lo = start, hi = mid;
    while (lo < hi) {
      int64_t m = (lo + hi) >> 1;
      if (cmp_rows(row_of(rows, pin[m]), key, w) <= 0) lo = m + 1;
      else hi = m;
    }
    out = start + (i - mid) + (lo - start);
  }
  pout[out] = me;
}

__global__ void k_gather(Rows rows, int64_t n, const int* perm, int* okeys,
                         Pay pay) {
  int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  int src = perm[p];
  const int* row = row_of(rows, src);
  for (int j = 0; j < rows.w; ++j) okeys[p * rows.w + j] = row[j];
  for (int k = 0; k < pay.n; ++k) pay.out[k][p] = pay.in[k][src];
}

// rank[i] = first index of the sorted rows equal to row i (searchsorted
// left), written at i's section and offset.
__global__ void k_rank(Rows rows, int64_t n, const int* sorted, OutSecs o) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int* key = row_of(rows, i);
  int w = rows.w;
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    int64_t m = (lo + hi) >> 1;
    if (cmp_rows(sorted + m * w, key, w) < 0) lo = m + 1; else hi = m;
  }
  int s = 0;
  while (s + 1 < o.nsec && i >= o.end[s]) ++s;
  o.p[s][i - (s ? o.end[s - 1] : 0)] = (int)lo;
}

// live = mask && begin rank < end rank, for the read and write slots.
__global__ void k_live(const int* rb, const int* re, const bool* rm,
                       const int* wb, const int* we, const bool* wm,
                       int64_t nr, int64_t nq, bool* rlive, bool* wlive) {
  int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nr) {
    rlive[i] = rm[i] && rb[i] < re[i];
  } else if (i < nr + nq) {
    int64_t k = i - nr;
    wlive[k] = wm[k] && wb[k] < we[k];
  }
}

static int tile_rows(int w) {
  int t = 1024;
  while (t > 32 && (int64_t)t * (w + 2) * 4 > SMEM_CAP) t >>= 1;
  return t;
}

// Sorts the index permutation of `rows` into perm0 or perm1 (returned).
static int* sort_perm(const Rows& rows, int64_t n, int* perm0, int* perm1,
                      cudaStream_t s) {
  int T = tile_rows(rows.w);
  size_t smem = (size_t)T * (rows.w + 2) * sizeof(int);
  k_block_sort<<<blocks(n, T), T, smem, s>>>(rows, n, perm0);
  int* pin = perm0;
  int* pout = perm1;
  for (int64_t run = T; run < n; run <<= 1) {
    k_merge<<<blocks(n, 256), 256, 0, s>>>(rows, n, run, pin, pout);
    int* tmp = pin; pin = pout; pout = tmp;
  }
  return pin;
}

// Stable sort of keys [n, w] with np <= 4 payload columns (p*[n]) into
// okeys [n, w] and o*[n]; perm0, perm1 [n] scratch.
extern "C" int wso_sort(const int* keys, int n, int w, const int* p0,
                        const int* p1, const int* p2, const int* p3, int np,
                        int* okeys, int* o0, int* o1, int* o2, int* o3,
                        int* perm0, int* perm1, cudaStream_t s) {
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
  int* perm = sort_perm(rows, n, perm0, perm1, s);
  k_gather<<<blocks(n, 256), 256, 0, s>>>(rows, n, perm, okeys, pay);
  return (int)cudaGetLastError();
}

// Endpoint ranks of a batch (read begins [nr, w], read ends, write begins
// [nq, w], write ends): the rank of every endpoint into the sorted
// multiset of all of them, into orb, ore [nr] and owb, owe [nq], and the
// liveness masks rlive [nr], wlive [nq]. Scratch: perm0, perm1 [n] and
// sorted [n, w], n = 2 (nr + nq).
extern "C" int wso_ranks(const int* rb, const int* re, const int* wb,
                         const int* we, int nr, int nq, int w,
                         const bool* rm, const bool* wm, int* orb, int* ore,
                         int* owb, int* owe, bool* rlive, bool* wlive,
                         int* perm0, int* perm1, int* sorted,
                         cudaStream_t s) {
  int64_t n = 2 * ((int64_t)nr + nq);
  if (n <= 0) return (int)cudaGetLastError();
  Rows rows = {};
  const int* secs[MAX_SECS] = {rb, re, wb, we};
  int64_t lens[MAX_SECS] = {nr, nr, nq, nq};
  OutSecs o = {};
  int* outs[MAX_SECS] = {orb, ore, owb, owe};
  int64_t acc = 0;
  for (int k = 0; k < MAX_SECS; ++k) {
    acc += lens[k];
    rows.p[k] = secs[k];
    rows.end[k] = acc;
    o.p[k] = outs[k];
    o.end[k] = acc;
  }
  rows.nsec = o.nsec = MAX_SECS;
  rows.w = w;
  int* perm = sort_perm(rows, n, perm0, perm1, s);
  Pay none = {};
  k_gather<<<blocks(n, 256), 256, 0, s>>>(rows, n, perm, sorted, none);
  k_rank<<<blocks(n, 256), 256, 0, s>>>(rows, n, sorted, o);
  k_live<<<blocks((int64_t)nr + nq, 256), 256, 0, s>>>(
      orb, ore, rm, owb, owe, wm, nr, nq, rlive, wlive);
  return (int)cudaGetLastError();
}
