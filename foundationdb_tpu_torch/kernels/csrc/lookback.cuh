// The decoupled look-back and the block scans that K4 (step_compact.cu)
// and K13's sorted paint (word_compact.cu) build their single-pass tiles
// from, and K14's (word_sort.cu) block max. Any block size that is a
// multiple of 32 (up to 1024).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

typedef unsigned long long u64;

__device__ __forceinline__ u64 ld_relaxed(const u64* p) {
  u64 v;
  asm volatile("ld.relaxed.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(u64* p, u64 v) {
  asm volatile("st.relaxed.gpu.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
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
    int cnt = __popc(__ballot_sync(0xffffffffu, t));
    int nlo = cnt > 0 ? lo + cnt * step : lo;
    int nhi = lo + (cnt + 1) * step - 1;
    lo = nlo;
    hi = nhi < hi ? nhi : hi;
  }
  bool t = lo + lane < hi && pred(lo + lane);
  return lo + __popc(__ballot_sync(0xffffffffu, t));
}

// ------------------------------------------------------------ block scans

// Exclusive sum over the block's threads; *total gets the block's sum; ws
// holds 32 ints.
__device__ __forceinline__ int block_excl_sum(int v, int* ws, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? ws[lane] : 0;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s += y;
    }
    ws[lane] = s;
  }
  __syncthreads();
  int r = x - v + (warp > 0 ? ws[warp - 1] : 0);
  *total = ws[nwarps - 1];
  __syncthreads();
  return r;
}

// Exclusive max over the block's threads (-1 before thread 0); ws holds
// 32 ints.
__device__ __forceinline__ int block_excl_max(int v, int* ws) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x = max(x, y);
  }
  int ex = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) ex = -1;
  if (lane == 31) ws[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < nwarps ? ws[lane] : -1;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, s, o);
      if (lane >= o) s = max(s, y);
    }
    ws[lane] = s;
  }
  __syncthreads();
  int r = max(ex, warp > 0 ? ws[warp - 1] : -1);
  __syncthreads();
  return r;
}

// ------------------------------------------------------ decoupled look-back

// A tile's word: status (1 aggregate, 2 inclusive) << 32 | value.
__device__ __forceinline__ u64 lb_word(int status, int v) {
  return ((u64)status << 32) | (unsigned)v;
}

// Called by one whole warp: publishes tile t's aggregate, sums the
// predecessors' values back to the nearest inclusive one (32 at a time),
// publishes t's inclusive value and returns the exclusive one.
__device__ __forceinline__ int look_back(u64* words, int t, int agg) {
  const int lane = threadIdx.x & 31;
  if (t == 0) {
    if (lane == 0) st_relaxed(words, lb_word(2, agg));
    return 0;
  }
  if (lane == 0) st_relaxed(words + t, lb_word(1, agg));
  int excl = 0;
  for (int base = t - 1;; base -= 32) {
    int j = base - lane;
    int st = 2, v = 0;  // before tile 0: an inclusive zero
    if (j >= 0) {
      u64 x;
      while (((x = ld_relaxed(words + j)) >> 32) == 0) __nanosleep(32);
      st = (int)(x >> 32);
      v = (int)(unsigned)x;
    }
    unsigned incl = __ballot_sync(0xffffffffu, st == 2);
    int stop = incl ? __ffs(incl) - 1 : 31;
    int take = lane <= stop ? v : 0;
    for (int o = 16; o; o >>= 1) take += __shfl_xor_sync(0xffffffffu, take, o);
    excl += take;
    if (incl) break;
  }
  if (lane == 0) st_relaxed(words + t, lb_word(2, excl + agg));
  return excl;
}
