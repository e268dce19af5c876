// The gated fold's decision (the JAX _maybe_merge's need,
// foundationdb_tpu/models/conflict_kernel.py:1290), shared by K4's fold
// (step_compact.cu, rank keys) and K13's (word_compact.cu, W-word keys):
// need = delta.n_used + demand > Cd, or at least max(C / 8, 1) base
// versions in (NEG_VERSION, floor]. One launch reduces the expired base
// versions over the card (16-byte loads where aligned); the last block to
// finish (a ticket in the zeroed workspace, which it re-zeroes) decides
// and writes the 0-dim device flag that the fold's launches read, so the
// decision never syncs with the host. The key width does not enter.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "lookback.cuh"

#define FN_NEG (-2147483647)
#define FN_WS_RECLAIM 1  // workspace words (uint64) the decision uses
#define FN_WS_DONE 2

__global__ void fn_need(const int* bv, int c, const int* floor_p,
                        const int* d_nused, int demand, int cd, int thr,
                        bool* need, u64* ws) {
  __shared__ int s_scan[32];
  const int fl = *floor_p;
  int cnt = 0;
  const int stride = gridDim.x * blockDim.x;
  const int c4 = (c & 3) == 0 && ((uintptr_t)bv & 15) == 0 ? c / 4 : 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < c4; i += stride) {
    int4 v = reinterpret_cast<const int4*>(bv)[i];
    cnt += (v.x <= fl && v.x > FN_NEG) + (v.y <= fl && v.y > FN_NEG)
         + (v.z <= fl && v.z > FN_NEG) + (v.w <= fl && v.w > FN_NEG);
  }
  for (int i = 4 * c4 + blockIdx.x * blockDim.x + threadIdx.x; i < c;
       i += stride) {
    int v = bv[i];
    cnt += v <= fl && v > FN_NEG;
  }
  int total;
  block_excl_sum(cnt, s_scan, &total);
  if (threadIdx.x == 0) {
    atomicAdd(ws + FN_WS_RECLAIM, (u64)total);
    __threadfence();
    if (atomicAdd(ws + FN_WS_DONE, 1ull) == gridDim.x - 1) {
      __threadfence();
      u64 sum = atomicAdd(ws + FN_WS_RECLAIM, 0ull);
      *need = *d_nused + demand > cd || sum >= (u64)thr;
      ws[FN_WS_RECLAIM] = 0;
      ws[FN_WS_DONE] = 0;
    }
  }
}

// The decision over the base versions bv [c] into need: one CUDA kernel.
static inline void fn_launch_need(const int* bv, int c, const int* floor_p,
                                  const int* d_nused, int demand, int cd,
                                  bool* need, u64* ws, cudaStream_t s) {
  int nb = (c + 255) / 256;
  if (nb > 132 * 4) nb = 132 * 4;
  if (nb < 1) nb = 1;
  int thr = c / 8 > 1 ? c / 8 : 1;
  fn_need<<<nb, 256, 0, s>>>(bv, c, floor_p, d_nused, demand, cd, thr, need,
                             ws);
}
