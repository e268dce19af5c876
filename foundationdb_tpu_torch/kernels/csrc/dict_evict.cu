// K7: tiered-dictionary demotion, the inverse of K1's insert.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   _dict_evict (:2026) and apply_evict (:2056), jitted as _evict_res_jit
//   (:2379). The rank rewrite of the history and the shard bounds by the
//   shift table this kernel writes is K1's di_rewrite (dict_insert.cu),
//   which adds table[r] to every rank r as _shift_rank_rows (:1980) does.
//
// Bound on the H100: bytes. The [D+1, W] dictionary is read once and its
// compacted copy written once (2 x 21 MB at D = 1,310,720, W = 4), the
// shift table [D+1] written once; the evict vector [E] is read by every
// thread, so it is served from L2 after the first touch.
//
// Design: one thread per output row j and two binary searches over the
// n_ev real ranks at the head of the evict vector e (strictly increasing,
// INT32_MAX padded; the host passes n_ev, the chunk's real count):
//   t = |{i : e_i - i <= j}|  (e_i - i is nondecreasing), so kept row j
//       reads source row j + t;
//   s = |{i : e_i <= j}|, written as shift[j] = -s.
// Rows at or past n_keys - n_ev become +inf, and thread 0 writes the new
// n_keys. The output is a fresh buffer: row j reads row j + t >= j, which
// an in-place pass would overwrite before another thread had read it.

#include <cuda_runtime.h>
#include <stdint.h>

#define I32MAX 2147483647

__global__ void k_evict(const int* dict, int d1, int w, const int* ev,
                        int n_ev, const int* n_keys, int* out, int* new_n,
                        int* shift) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= d1) return;
  int lo = 0, hi = n_ev;
  while (lo < hi) {  // t = |{i : e_i - i <= j}|
    int mid = (lo + hi) >> 1;
    if (ev[mid] - mid <= j) lo = mid + 1; else hi = mid;
  }
  int t = lo;
  lo = 0;
  hi = n_ev;
  while (lo < hi) {  // s = |{i : e_i <= j}|
    int mid = (lo + hi) >> 1;
    if (ev[mid] <= j) lo = mid + 1; else hi = mid;
  }
  shift[j] = -lo;
  int n_out = *n_keys - n_ev;
  if (j == 0) *new_n = n_out;
  int64_t o = (int64_t)j * w;
  if (j < n_out) {
    int64_t src = (int64_t)j + t;
    if (src > d1 - 1) src = d1 - 1;
    for (int k = 0; k < w; ++k) out[o + k] = dict[src * w + k];
  } else {
    for (int k = 0; k < w; ++k) out[o + k] = I32MAX;
  }
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

extern "C" int de_evict(const int* dict, int d1, int w, const int* ev,
                        int n_ev, const int* n_keys, int* out, int* new_n,
                        int* shift, cudaStream_t s) {
  const int T = 256;
  if (d1 > 0) {
    k_evict<<<blocks(d1, T), T, 0, s>>>(dict, d1, w, ev, n_ev, n_keys, out,
                                        new_n, shift);
  }
  return (int)cudaGetLastError();
}
