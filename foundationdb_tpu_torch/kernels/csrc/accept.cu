// K3: exact sequential-order acceptance, verdicts and the loser mask.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   _block_accept_fused (:472) -> _block_scan_accept (:391), _overlap_rows
//   (:327), _wave_accept_packed (:573) and, when B % G != 0, _wave_accept
//   (:525); the ops/bitset.py packing (:28/:38/:44);
//   assemble_verdicts (:1072);
//   loser_range_mask (:1082) with _read_vs_accepted_writes (:257) and
//   pack_loser_mask (:1537), the report program's extra output.
//
// Bound on the H100: the overlap rows are operations (B^2/2 x R x Q
// interval compares, 67 M at B = 8192, R = 2, Q = 1, written as 4 MB of
// packed words); the acceptance itself is a chain of B dependent steps,
// so it is bound by latency, not by bytes or operations.
//
// Design: kernel A writes the strict-lower packed overlap rows (bit j of
// row i: a read of txn i overlaps a write of txn j < i), only for
// candidate rows. Hopper runs a grid in no order, so kernel B runs the
// blocks of G = 512 transactions in order inside ONE thread block: its 32
// warps first demote each row of the block by the accepted set of earlier
// blocks (kept in shared memory, B/32 words), then copy the block's
// lower-triangular [G, G/32] tile (32 KB) to shared memory, where one warp
// settles the order within the block, one transaction per step: lane t
// holds accepted word t of the block and __any_sync ORs the row against
// it. That is the literal sequential rule, so the accepted set is the
// exact one for every B, including B not a multiple of 32 or of G (the
// JAX package takes a dense path there; the result is the same). The
// verdict epilogue runs in the same block. Kernel C, for report chunks,
// marks each read slot of a CONFLICT transaction that lost to history or
// overlaps an accepted transaction's write, and packs the slots of a
// transaction into one 32-bit word.

#include <cuda_runtime.h>
#include <stdint.h>

#define G 512
#define TW (G / 32)
#define FULL 0xffffffffu

// rows [B, nw] uint32; word w of row i holds bits for txns 32w .. 32w+31 < i.
__global__ void k_overlap(const bool* cand, const int* rb, const int* re,
                          const bool* rlive, const int* wb, const int* we,
                          const bool* wlive, int B, int R, int Q, int nw,
                          unsigned* rows) {
  int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)B * nw) return;
  int i = (int)(t / nw);
  int w = (int)(t % nw);
  if (w > (i >> 5) || !cand[i]) return;
  unsigned bits = 0;
  for (int k = 0; k < 32; ++k) {
    int j = w * 32 + k;
    if (j >= i) break;
    bool hit = false;
    for (int q = 0; q < Q && !hit; ++q) {
      int s = j * Q + q;
      if (!wlive[s]) continue;
      int b0 = wb[s], e0 = we[s];
      for (int r = 0; r < R; ++r) {
        int u = i * R + r;
        if (rlive[u] && rb[u] < e0 && b0 < re[u]) { hit = true; break; }
      }
    }
    if (hit) bits |= 1u << k;
  }
  rows[t] = bits;
}

__global__ void k_scan(const unsigned* rows, const bool* cand,
                       const bool* too_old, const bool* tmask, int B, int nw,
                       bool* accepted, signed char* verdicts) {
  extern __shared__ unsigned smem[];
  unsigned* acc = smem;                 // [nw] accepted bits
  unsigned* tile = smem + nw;           // [G][TW]
  unsigned char* candf = (unsigned char*)(tile + G * TW);  // [G]
  int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int nwarps = blockDim.x >> 5;
  for (int w = threadIdx.x; w < nw; w += blockDim.x) acc[w] = 0;
  __syncthreads();
  for (int g0 = 0; g0 < B; g0 += G) {
    int gn = min(G, B - g0);
    int w0 = g0 >> 5;
    for (int li = warp; li < gn; li += nwarps) {
      int i = g0 + li;
      bool c = cand[i];
      const unsigned* row = rows + (int64_t)i * nw;
      bool hit = false;
      if (c)
        for (int w = lane; w < w0; w += 32) hit |= (row[w] & acc[w]) != 0;
      hit = __any_sync(FULL, hit);
      for (int t = lane; t < TW; t += 32) {
        int w = w0 + t;
        tile[li * TW + t] = (c && w <= (i >> 5)) ? row[w] : 0u;
      }
      if (lane == 0) candf[li] = c && !hit;
    }
    __syncthreads();
    if (warp == 0) {
      unsigned mine = 0;  // lane t: accepted word w0 + t of this block
      for (int li = 0; li < gn; ++li) {
        bool hit = lane < TW && (tile[li * TW + lane] & mine) != 0;
        hit = __any_sync(FULL, hit);
        if (candf[li] && !hit && lane == (li >> 5)) mine |= 1u << (li & 31);
      }
      if (lane < TW && w0 + lane < nw) acc[w0 + lane] = mine;
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    bool a = (acc[i >> 5] >> (i & 31)) & 1u;
    accepted[i] = a;
    verdicts[i] = too_old[i] ? 2 : ((tmask[i] && !a) ? 1 : 0);
  }
}

__global__ void k_losers(const bool* hist_mask, const bool* accepted,
                         const signed char* verdicts, const int* rb,
                         const int* re, const bool* rlive, const int* wb,
                         const int* we, const bool* wlive, int B, int R,
                         int Q, bool* losers) {
  int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= B * R) return;
  int b = s / R;
  bool lost = false;
  if (verdicts[b] == 1 && rlive[s]) {
    lost = hist_mask[s];
    int r0 = rb[s], r1 = re[s];
    for (int j = 0; j < B && !lost; ++j) {
      if (!accepted[j]) continue;
      for (int q = 0; q < Q; ++q) {
        int u = j * Q + q;
        if (wlive[u] && r0 < we[u] && wb[u] < r1) { lost = true; break; }
      }
    }
  }
  losers[s] = lost;
}

__global__ void k_pack(const bool* losers, int B, int R, unsigned* packed) {
  int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  unsigned w = 0;
  for (int r = 0; r < R; ++r) w |= (unsigned)losers[b * R + r] << r;
  packed[b] = w;
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

extern "C" int ac_accept(const bool* cand, const bool* too_old,
                         const bool* tmask, const int* rb, const int* re,
                         const bool* rlive, const int* wb, const int* we,
                         const bool* wlive, int B, int R, int Q,
                         unsigned* rows, bool* accepted,
                         signed char* verdicts, cudaStream_t s) {
  if (B <= 0) return (int)cudaGetLastError();
  int nw = (B + 31) / 32;
  const int T = 256;
  k_overlap<<<blocks((int64_t)B * nw, T), T, 0, s>>>(
      cand, rb, re, rlive, wb, we, wlive, B, R, Q, nw, rows);
  size_t smem = (size_t)nw * 4 + (size_t)G * TW * 4 + G;
  cudaError_t e = cudaFuncSetAttribute(
      k_scan, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  k_scan<<<1, 1024, smem, s>>>(rows, cand, too_old, tmask, B, nw, accepted,
                               verdicts);
  return (int)cudaGetLastError();
}

// packed may be null (R > 32): then only the bool [B, R] mask is written.
extern "C" int ac_losers(const bool* hist_mask, const bool* accepted,
                         const signed char* verdicts, const int* rb,
                         const int* re, const bool* rlive, const int* wb,
                         const int* we, const bool* wlive, int B, int R,
                         int Q, bool* losers, unsigned* packed,
                         cudaStream_t s) {
  const int T = 256;
  if (B > 0) {
    k_losers<<<blocks((int64_t)B * R, T), T, 0, s>>>(
        hist_mask, accepted, verdicts, rb, re, rlive, wb, we, wlive, B, R, Q,
        losers);
    if (packed) k_pack<<<blocks(B, T), T, 0, s>>>(losers, B, R, packed);
  }
  return (int)cudaGetLastError();
}
