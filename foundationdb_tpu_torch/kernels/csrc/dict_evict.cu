// K7: tiered-dictionary demotion, the inverse of K1's insert.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   _dict_evict (:2026) and apply_evict (:2056), jitted as _evict_res_jit
//   (:2379). The rank rewrite of the history and the shard bounds by the
//   shift table this kernel writes is K1's di_rewrite (dict_insert.cu),
//   which adds table[r] to every rank r as _shift_rank_rows (:1980) does.
//
// Bound on the H100: bytes. The kept rows of the [D+1, W] dictionary are
// read once (the live prefix [0, n_keys) only), the compacted [D+1, W]
// dictionary written once, the shift table [D+1] written once and the
// n_ev real ranks of the evict vector read once (at D+1 = 1,310,721,
// W = 4: 21 MB out, 5 MB of shifts, up to 21 MB in).
//
// Design: a mark-and-scan pass over the SOURCE rows, in tiles of 2048
// rows (256 threads x 8). The evict vector e (strictly increasing ranks
// below n_keys, INT32_MAX padded, n_ev real) is sorted, so the ranks
// evicted before a tile's first row are an index into it: two warps find
// the tile's slice [s0, s1) of e with one 32-way search each (no search
// by row), the slice is marked into a 2048-bit mask in shared memory, and
// a popcount prefix over the mask's 64 words gives every row r of the
// tile the count of evicted ranks below it, before = s0 + (marks below
// r). Then shift[r] = -(before + mark) (the <= count) and a kept row r
// moves to r - before. Row i of a thread's eight is tile row i·256 + tid,
// so every load and store of a warp is 32 neighbouring rows: at W = 4 a
// row is one 16-byte vector (int4), loaded before the searches so that
// the loads are in flight while the tile's slice is found; other widths
// and unaligned pointers copy word by word. Blocks past the source tiles
// write the tail: rows [n_keys - n_ev, D+1) of the output are INT32_MAX
// and shift[j] = -n_ev for j >= n_keys, without reading anything. The
// host passes n_keys (the mirror's count) to size the grid; block 0
// writes the new n_keys from the device's. One launch a demotion event,
// however many ranks it evicts. The output is a fresh buffer: a kept row
// moves down into rows another block may not have read yet.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

#define I32MAX 2147483647
#define ET 256              // threads a tile
#define EI 8                // source rows a thread
#define ETILE (ET * EI)     // source rows a tile
#define EWORDS (ETILE / 32) // mask words a tile

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

static inline bool aligned(const void* p, uintptr_t a) {
  return ((uintptr_t)p & (a - 1)) == 0;
}

template <bool VEC>
__global__ void __launch_bounds__(ET)
k_evict(const int* __restrict__ dict, int d1, int w,
        const int* __restrict__ ev, int n_ev, int n_live, int src_tiles,
        const int* __restrict__ n_keys, int* __restrict__ out,
        int* __restrict__ new_n, int* __restrict__ shift) {
  __shared__ unsigned s_mask[EWORDS];
  __shared__ int s_pre[EWORDS];
  __shared__ int s_s[2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  if (blockIdx.x == 0 && tid == 0) *new_n = *n_keys - n_ev;
  if ((int)blockIdx.x >= src_tiles) {
    // The tail: output rows [n_live - n_ev, d1) and shifts [n_live, d1).
    const int64_t j0 = (int64_t)(n_live - n_ev)
                       + (int64_t)(blockIdx.x - src_tiles) * ETILE;
    const int64_t j1 = j0 + ETILE < d1 ? j0 + ETILE : d1;
    for (int64_t j = j0 + tid; j < j1; j += ET) {
      if (VEC) {
        reinterpret_cast<int4*>(out)[j] = make_int4(I32MAX, I32MAX, I32MAX,
                                                    I32MAX);
      } else {
        for (int c = 0; c < w; ++c) out[j * w + c] = I32MAX;
      }
      if (j >= n_live) shift[j] = -n_ev;
    }
    return;
  }
  const int r0 = blockIdx.x * ETILE;
  const int r1 = min(r0 + ETILE, n_live);
  int4 row[EI];
  if (VEC) {  // in flight while the slice is found
#pragma unroll
    for (int k = 0; k < EI; ++k) {
      const int r = r0 + k * ET + tid;
      if (r < r1) row[k] = reinterpret_cast<const int4*>(dict)[r];
    }
  }
  if (warp < 2) {
    const int key = warp ? r1 : r0;
    const int s = warp_search(0, n_ev, [&](int m) { return ev[m] < key; });
    if (lane == 0) s_s[warp] = s;
  }
  for (int t = tid; t < EWORDS; t += ET) s_mask[t] = 0u;
  __syncthreads();
  const int s0 = s_s[0], s1 = s_s[1];
  for (int i = s0 + tid; i < s1; i += ET) {
    const int x = ev[i] - r0;
    atomicOr(&s_mask[x >> 5], 1u << (x & 31));
  }
  __syncthreads();
  if (warp == 0) {  // exclusive popcount prefix over the mask's words
    const int c0 = __popc(s_mask[2 * lane]);
    const int c1 = __popc(s_mask[2 * lane + 1]);
    int x = c0 + c1;
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += y;
    }
    x -= c0 + c1;
    s_pre[2 * lane] = x;
    s_pre[2 * lane + 1] = x + c0;
  }
  __syncthreads();
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < EI; ++k) {
    const int x = k * ET + tid;  // x & 31 == lane
    const int r = r0 + x;
    if (r < r1) {
      const unsigned word = s_mask[x >> 5];
      const int mark = (word >> lane) & 1u;
      const int before = s0 + s_pre[x >> 5] + __popc(word & below);
      shift[r] = -(before + mark);
      if (!mark) {
        const int64_t o = (int64_t)r - before;
        if (VEC) {
          reinterpret_cast<int4*>(out)[o] = row[k];
        } else {
          for (int c = 0; c < w; ++c) out[o * w + c] = dict[(int64_t)r * w + c];
        }
      }
    }
  }
}

// Evict the n_ev ranks at the head of ev [>= n_ev] (strictly increasing,
// all below n_live = the dictionary's n_keys) from dict [d1, w]: out
// [d1, w], new_n, shift [d1]. One CUDA kernel.
extern "C" int de_evict(const int* dict, int d1, int w, const int* ev,
                        int n_ev, int n_live, const int* n_keys, int* out,
                        int* new_n, int* shift, cudaStream_t s) {
  if (d1 <= 0 || w <= 0 || n_ev < 0 || n_live < n_ev || n_live > d1)
    return (int)cudaErrorInvalidValue;
  const int src_tiles = blocks(n_live, ETILE);
  const int grid = src_tiles + blocks((int64_t)d1 - (n_live - n_ev), ETILE);
  const bool vec = w == 4 && aligned(dict, 16) && aligned(out, 16);
  if (vec)
    k_evict<true><<<grid, ET, 0, s>>>(dict, d1, w, ev, n_ev, n_live,
                                      src_tiles, n_keys, out, new_n, shift);
  else
    k_evict<false><<<grid, ET, 0, s>>>(dict, d1, w, ev, n_ev, n_live,
                                       src_tiles, n_keys, out, new_n, shift);
  return (int)cudaGetLastError();
}
