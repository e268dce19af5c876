// K5 + K6: wave commit (reorder, don't abort), the predecessor matrix and
// the wave leveling.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   K5: wave_pred_matrix (:739) -> _pred_matrix_packed (:664) with its
//       _overlap_rows (:327) and the ops/bitset.py packing;
//   K6: _wave_level_packed (:776) with _min_pred (:702) and _cycle_victim
//       (:713); wave_level_from_graph (:834) and _wave_commit_accept (:850);
//       assemble_verdicts (:1072) as the epilogue.
//
// K5 writes the packed predecessor rows uint32 [BP][BP/32], BP = B rounded
// up to 32: bit i of row j is set when a live read interval of txn i
// overlaps a live write interval of txn j (i must serialize before j), for
// candidate columns i != j only. Rows of non-candidate txns keep their
// bits and padding rows are zero, as in the JAX function: the two-phase
// protocol ships these rows to other shards. Bound on the H100: B^2 x R x Q
// interval tests, two compares each (268 M operations at B = 8192, R = 2,
// Q = 1), or the 8 MiB written.
// Design (K3's overlap layout, k_overlap in accept.cu, transposed to K5's
// rows): one block of 16 warps takes 256 writer rows by a tile of TW words
// (32·TW reader columns, TW <= 32 as shared memory allows). It stages the
// tile's read intervals and the rows' write intervals in shared memory; a
// dead slot, a reader that is not a candidate and a padding column are
// staged empty (begin INT32_MAX, end INT32_MIN), so no test can set their
// bit. A warp forms word w of row j: lane k tests reader 32w + k against
// the row's write intervals and a __ballot_sync gives the word; lane l
// keeps the word of the l-th step, so the warp writes TW consecutive words
// of row j in one store (128 bytes at TW = 32). The block lists its rows
// with a live write first (a warp's ballots); a row without one (half of
// YCSB-A's) and a padding row store zeros without a test. A warp takes 8
// listed rows at once, their write intervals in registers: one reader
// load serves 8 tests and the 8 ballots of a word are independent (the
// loop is bound by issue, not by latency). The diagonal is cleared by a
// mask; a word with no live candidate reader is skipped without a test.
//
// K6 levels the candidates Kahn-style, in a fixed sequence of launches
// with no host read between them (the window path allows no host sync; the
// round count depends on the data: waves plus victims, hundreds on a Zipf
// batch). The result is the fixed point of _wave_level_packed: each round
// levels every undetermined txn with no undetermined predecessor into the
// next wave, or, when there is none, aborts the one cycle victim.
//   1. k_prologue, a grid over 256-row x 8-word tiles of p, reads the
//      matrix once at bandwidth: each candidate's in-degree (the popcount
//      of its row masked to the candidates) and the successor rows pT, the
//      candidate rows of p transposed by 32x32-bit tiles (__ballot_sync).
//   2. k_first_mask and k_first_release, grids again, level the first wave
//      (the candidates of in-degree 0) and drop it from every other row's
//      in-degree: on a Zipf batch it is most of the leveled rows, which one
//      block would release at one SM's bandwidth.
//   3. k_level, one block of 512 threads, runs the other rounds. A wave
//      round takes the ready list the round before built: leveling those
//      rows decrements their successors' in-degrees (a warp per row, two
//      rows in flight), and a successor that reaches zero joins the next
//      list. A stall (no ready txn) removes the victim and the block
//      decrements its successors the same way (a word per thread). No
//      round sweeps all BP/32 words: its work is the rows it frees. Each
//      txn joins the list once, so the list is one array with a moving
//      head.
// The stall rule: abort the minimum of the cycle that the min-predecessor
// walk from the lowest undetermined txn enters. Warp 0 walks. The lowest
// undetermined txn is a pointer that only moves forward (the set only
// shrinks). The min-predecessor function is lazy: row j keeps a witness
// mp[j], the lowest undetermined predecessor its last scan found, which
// stays the lowest while it is undetermined; row j is rescanned (one warp,
// from the old witness's word on) only when the walk visits it and its
// witness is gone. The walk keeps its path: the next stall reuses the
// longest prefix of the last path whose txns are all still undetermined
// (one ballot per 32 nodes; the victim was on the path, so the prefix ends
// at or before it) and walks on from there. A visited bitset finds the
// first repeated node, which lies on the terminal cycle; the victim is the
// minimum of the path from that node on. The JAX walk of BP steps and BP
// more gives that same victim, since BP exceeds every entry distance and
// cycle length. While the other warps release a victim, warp 0 already
// walks to the next stall's victim: the set does not change in between
// unless the release frees a txn, and then the next round is a wave and
// drops that walk's victim.
// The round state (the undetermined and visited sets, the witnesses, the
// ready list, the path and the in-degrees: 16 bytes a row and 8 a word)
// lives in shared memory when it fits (BP up to about 14,000) and in the
// wrapper's global scratch otherwise (L2-resident: 0.9 MB at BP = 57,344),
// through the same code: no batch size is refused. Bound: the matrix read
// once and its transpose written once, the masks, levels and verdicts; the
// rounds are a chain of dependent steps of one warp (a rescan is a round
// trip to L2, a walk step a few shared loads), so K6 is bound by latency.
// A stats build (the entry given `clk`) also records clock64 and
// globaltimer counters of each phase (WV_CLK_* below).

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define WV_THREADS 512  // K6's one block

#define PRED_WARPS 16
#define PRED_ROWS 256  // writer rows a block
#define EMPTY_BEGIN 2147483647
#define EMPTY_END (-2147483647 - 1)

#define PRED_RPW 8  // rows a warp forms at once

// Shared memory: reads int2 [R][32·TW], writes int2 [PRED_ROWS][Q] and the
// words' live reader masks unsigned [TW]; statically the block's rows
// with a live write, then (from the end) those without, and their count.
__global__ void __launch_bounds__(PRED_WARPS * 32)
k_pred(const bool* cand, const int* rb, const int* re, const bool* rlive,
       const int* wb, const int* we, const bool* wlive, int B, int R, int Q,
       int BP, int NW, int TW, unsigned* rows) {
  extern __shared__ int2 s_pred[];
  __shared__ short s_order[PRED_ROWS];
  __shared__ int s_nlive;
  const int cols = 32 * TW;
  int2* s_read = s_pred;
  int2* s_write = s_read + (size_t)R * cols;
  unsigned* s_any = (unsigned*)(s_write + (size_t)PRED_ROWS * Q);
  const int w0 = blockIdx.x * TW;
  const int tw = min(TW, NW - w0);
  const int j0 = blockIdx.y * PRED_ROWS;
  const int nrows = min(PRED_ROWS, BP - j0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  // Staging: every load of an item issued at once (a dead slot's values
  // are read and dropped), four items in flight a thread.
#pragma unroll 4
  for (int t = tid; t < R * cols; t += PRED_WARPS * 32) {
    const int r = t / cols, col = t - r * cols;
    const int i = min(w0 * 32 + col, B - 1);
    const size_t u = (size_t)i * R + r;
    const bool live = (w0 * 32 + col < B) & cand[i] & rlive[u];
    const int b = rb[u], e = re[u];
    s_read[(size_t)r * cols + col] =
        live ? make_int2(b, e) : make_int2(EMPTY_BEGIN, EMPTY_END);
  }
#pragma unroll 4
  for (int t = tid; t < PRED_ROWS * Q; t += PRED_WARPS * 32) {
    const int j = min(j0 + t / Q, B - 1);
    const size_t s = (size_t)j * Q + t % Q;
    const bool live = (j0 + t / Q < B) & wlive[s];
    const int b = wb[s], e = we[s];
    s_write[t] = live ? make_int2(b, e) : make_int2(EMPTY_BEGIN, EMPTY_END);
  }
  __syncthreads();
  for (int w = warp; w < tw; w += PRED_WARPS) {
    bool any = false;
    for (int r = 0; r < R; ++r)
      any |= s_read[(size_t)r * cols + w * 32 + lane].x != EMPTY_BEGIN;
    const unsigned m = __ballot_sync(FULL, any);
    if (lane == 0) s_any[w] = m;
  }
  if (warp == 0) {  // the rows with a live write first, in order
    int nlive = 0, ndead = 0;
    for (int c = 0; c < PRED_ROWS; c += 32) {
      const int jj = c + lane;
      bool live = false;
      for (int q = 0; jj < nrows && q < Q; ++q)
        live |= s_write[jj * Q + q].x != EMPTY_BEGIN;
      const bool dead = !live && jj < nrows;
      const unsigned lb = __ballot_sync(FULL, live);
      const unsigned db = __ballot_sync(FULL, dead);
      const unsigned below = (1u << lane) - 1u;
      if (live) s_order[nlive + __popc(lb & below)] = (short)jj;
      if (dead)
        s_order[PRED_ROWS - 1 - ndead - __popc(db & below)] = (short)jj;
      nlive += __popc(lb);
      ndead += __popc(db);
    }
    if (lane == 0) s_nlive = nlive;
  }
  __syncthreads();
  const int nlive = s_nlive;
  // Rows without a live write: zeros, one store of TW words a row.
  for (int x = PRED_ROWS - 1 - warp; x >= PRED_ROWS - (nrows - nlive);
       x -= PRED_WARPS)
    if (lane < tw) rows[(size_t)(j0 + s_order[x]) * NW + w0 + lane] = 0u;
  // Rows with one, PRED_RPW at a time a warp: their write intervals in
  // registers, one reader interval load serving every row, PRED_RPW
  // independent ballots a word.
  for (int c0 = warp * PRED_RPW; c0 < nlive; c0 += PRED_WARPS * PRED_RPW) {
    int jr[PRED_RPW];
    unsigned mine[PRED_RPW];
#pragma unroll
    for (int x = 0; x < PRED_RPW; ++x) {
      jr[x] = c0 + x < nlive ? s_order[c0 + x] : -1;
      mine[x] = 0;
    }
    for (int q = 0; q < Q; ++q) {
      int2 wr[PRED_RPW];
#pragma unroll
      for (int x = 0; x < PRED_RPW; ++x)
        wr[x] = jr[x] >= 0 ? s_write[jr[x] * Q + q]
                           : make_int2(EMPTY_BEGIN, EMPTY_END);
      for (int w = 0; w < tw; ++w) {
        if (!s_any[w]) continue;
        bool hit[PRED_RPW];
#pragma unroll
        for (int x = 0; x < PRED_RPW; ++x) hit[x] = false;
        for (int r = 0; r < R; ++r) {
          const int2 rd = s_read[(size_t)r * cols + w * 32 + lane];
#pragma unroll
          for (int x = 0; x < PRED_RPW; ++x)
            hit[x] |= (wr[x].x < rd.y) & (rd.x < wr[x].y);
        }
#pragma unroll
        for (int x = 0; x < PRED_RPW; ++x) {
          const unsigned word = __ballot_sync(FULL, hit[x]);
          if (lane == w) mine[x] |= word;
        }
      }
    }
#pragma unroll
    for (int x = 0; x < PRED_RPW; ++x) {
      if (jr[x] < 0 || lane >= tw) continue;
      const int j = j0 + jr[x];
      const unsigned diag = lane == (j >> 5) - w0 ? 1u << (j & 31) : 0u;
      rows[(size_t)j * NW + w0 + lane] = mine[x] & ~diag;
    }
  }
}

__device__ __forceinline__ bool bit_of(const unsigned* set, int j) {
  return (set[j >> 5] >> (j & 31)) & 1u;
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// The stats build's counters, int64 [WV_CLK_N]: the prologue's first start
// and last end and the level kernel's start and end (globaltimer ns), the
// level kernel's clock64 cycles in all, in its set-up, in its wave rounds
// and in its stall rounds (each from one block barrier to the next, as
// thread 0 sees it), and of the stalls' cycles those spent finding the
// lowest txn and the reusable prefix, walking (rescans included),
// rescanning, and releasing the victim's successors (two barriers
// included); then the walk's new steps, the prefix nodes reused, the
// rescans, the words they read, and the in-degree decrements of the whole
// leveling.
enum {
  WV_CLK_PRO_T0, WV_CLK_PRO_T1, WV_CLK_LVL_T0, WV_CLK_LVL_T1, WV_CLK_CYCLES,
  WV_CLK_INIT, WV_CLK_WAVE, WV_CLK_STALL, WV_CLK_STALL_PREFIX,
  WV_CLK_STALL_WALK, WV_CLK_STALL_RESCAN, WV_CLK_STALL_RELEASE,
  WV_CLK_STEPS, WV_CLK_REUSED, WV_CLK_RESCANS, WV_CLK_RESCAN_WORDS,
  WV_CLK_DECREMENTS, WV_CLK_N
};

// One block of 256 threads per 256 rows x 8 words of p: the tile's
// candidate rows in shared memory (8 consecutive words of a row are one
// 32-byte sector), each row's popcount against the candidate words added
// to its in-degree, and the 64 32x32-bit sub-tiles transposed by 32
// ballots each into the successor rows pT (again 8 words a row).
__global__ void __launch_bounds__(256) k_prologue(
    const unsigned* __restrict__ p, const bool* __restrict__ cand, int B,
    int BP, int NW, unsigned* __restrict__ pT, int* __restrict__ indeg,
    long long* clk) {
  __shared__ unsigned tile[256][9];
  __shared__ unsigned out[256][9];
  __shared__ unsigned cw[8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = blockIdx.x * 8, r0 = blockIdx.y * 256;
  if (clk && tid == 0)
    atomicMin((unsigned long long*)&clk[WV_CLK_PRO_T0], globaltimer());
  {
    int i = (c0 + warp) * 32 + lane;
    unsigned m = __ballot_sync(FULL, c0 + warp < NW && i < B && cand[i]);
    if (lane == 0) cw[warp] = m;
  }
  const int wc = tid & 7;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int r = (tid >> 3) + 32 * k, j = r0 + r;
    tile[r][wc] = (j < B && c0 + wc < NW && cand[j])
                      ? p[(int64_t)j * NW + c0 + wc] : 0u;
  }
  __syncthreads();
  {
    int s = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w) s += __popc(tile[tid][w] & cw[w]);
    if (s) atomicAdd(&indeg[r0 + tid], s);
  }
  for (int st = warp; st < 64; st += 8) {
    int rb = st >> 3, w = st & 7;
    unsigned x = tile[rb * 32 + lane][w], mine = 0;
#pragma unroll
    for (int bit = 0; bit < 32; ++bit) {
      unsigned bal = __ballot_sync(FULL, (x >> bit) & 1u);
      if (lane == bit) mine = bal;
    }
    out[w * 32 + lane][rb] = mine;
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    int q = (tid >> 3) + 32 * k, i = c0 * 32 + q, wo = (r0 >> 5) + wc;
    if (i < BP && wo < NW) pT[(int64_t)i * NW + wo] = out[q][wc];
  }
  __syncthreads();
  if (clk && tid == 0)
    atomicMax((unsigned long long*)&clk[WV_CLK_PRO_T1], globaltimer());
}

// The first wave, on the grid: w1 [NW] marks the candidates with no
// candidate predecessor (one warp a word), then every other candidate row
// of p, tiled as in k_prologue, drops from its in-degree its predecessors
// in w1. The level kernel starts after that wave: it is most of the
// leveled rows on a Zipf batch (4,303 of 5,493 on the smoke's), and one
// block would release them at one SM's bandwidth.
__global__ void __launch_bounds__(256) k_first_mask(const bool* cand,
                                                    const int* indeg, int B,
                                                    int NW, unsigned* w1) {
  const int w = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int i = w * 32 + (threadIdx.x & 31);
  unsigned m = __ballot_sync(FULL, w < NW && i < B && cand[i] &&
                                       indeg[i] == 0);
  if (w < NW && (threadIdx.x & 31) == 0) w1[w] = m;
}

__global__ void __launch_bounds__(256) k_first_release(
    const unsigned* __restrict__ p, const bool* __restrict__ cand, int B,
    int NW, const unsigned* __restrict__ w1, int* __restrict__ indeg,
    long long* clk) {
  __shared__ unsigned ww[8];
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * 8, j = blockIdx.y * 256 + tid;
  if (tid < 8) ww[tid] = c0 + tid < NW ? w1[c0 + tid] : 0u;
  __syncthreads();
  if (j < B && cand[j] && !((w1[j >> 5] >> (j & 31)) & 1u)) {
    const unsigned* row = p + (int64_t)j * NW + c0;
    int s = 0;
#pragma unroll
    for (int w = 0; w < 8; ++w)
      if (ww[w]) s += __popc(row[w] & ww[w]);
    if (s) atomicSub(&indeg[j], s);
  }
  if (clk && tid == 0)
    atomicMax((unsigned long long*)&clk[WV_CLK_PRO_T1], globaltimer());
}

// One warp: the lowest undetermined predecessor in row `row` at or after
// word w (BP if none), eight words per lane at a time (a rescan finds its
// txn about 64 words on, so one round trip to L2 is the rule).
template <bool CLK>
__device__ __forceinline__ int min_pred(const unsigned* row,
                                        const unsigned* und, int NW, int w,
                                        int BP, int lane, long long* words) {
  for (; w < NW; w += 256) {
    unsigned x[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      int ww = w + c * 32 + lane;
      x[c] = ww < NW ? (row[ww] & und[ww]) : 0u;
    }
    if (CLK && lane == 0) *words += 256;
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      unsigned bal = __ballot_sync(FULL, x[c] != 0u);
      if (bal) {
        int l = __ffs(bal) - 1;
        unsigned v = __shfl_sync(FULL, x[c], l);
        return (w + c * 32 + l) * 32 + __ffs(v) - 1;
      }
    }
  }
  return BP;
}

// Decrement the in-degree of the undetermined successors whose bits are in
// the successor word `x` of word w; a txn that reaches zero joins the ready
// list.
template <bool CLK>
__device__ __forceinline__ void release_word(unsigned x, int w, int* indeg,
                                             int* queue, int* tail,
                                             long long* decs) {
  while (x) {
    int j = w * 32 + __ffs(x) - 1;
    x &= x - 1;
    if (CLK) *decs += 1;
    if (atomicSub(&indeg[j], 1) == 1) queue[atomicAdd(tail, 1)] = j;
  }
}

// The rows rows[0, R), one warp a row and two rows a warp in flight (16
// loads a lane for 256 words): release each one's undetermined successors.
// A word of a wave row holds one successor or none, so the loads and their
// round trips to L2, not the atomics, set the pace.
template <bool CLK>
__device__ __forceinline__ void release_rows(const unsigned* pT,
                                             const int* rows, int R,
                                             const unsigned* und, int NW,
                                             int* indeg, int* queue,
                                             int* tail, int warp, int nwarps,
                                             int lane, long long* decs) {
  for (int r = warp * 2; r < R; r += nwarps * 2) {
    const unsigned* a = pT + (int64_t)rows[r] * NW;
    const unsigned* b = r + 1 < R ? pT + (int64_t)rows[r + 1] * NW : nullptr;
    for (int w0 = 0; w0 < NW; w0 += 256) {
      unsigned x[8], y[8];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int w = w0 + c * 32 + lane;
        x[c] = w < NW ? a[w] : 0u;
        y[c] = b && w < NW ? b[w] : 0u;
      }
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        int w = w0 + c * 32 + lane;
        unsigned m = (x[c] | y[c]) ? und[w] : 0u;
        release_word<CLK>(x[c] & m, w, indeg, queue, tail, decs);
        release_word<CLK>(y[c] & m, w, indeg, queue, tail, decs);
      }
    }
  }
}

// One row (a victim's) by threads [t, t + nt), a word a thread.
template <bool CLK>
__device__ __forceinline__ void release_row(const unsigned* row,
                                            const unsigned* und, int NW,
                                            int* indeg, int* queue,
                                            int* tail, int t, int nt,
                                            long long* decs) {
  for (int w0 = t; w0 < NW; w0 += 4 * nt) {
    unsigned x[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int w = w0 + u * nt;
      x[u] = w < NW ? row[w] : 0u;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      int w = w0 + u * nt;
      if (x[u]) release_word<CLK>(x[u] & und[w], w, indeg, queue, tail, decs);
    }
  }
}

// Warp 0's stall rule: the minimum of the cycle that the min-predecessor
// walk from the lowest undetermined txn j0 enters (BP if the set is empty
// after all). j0 and the last path (path[0, plen), its txns set in vis)
// carry over between calls: the prefix of the last path whose txns are all
// still undetermined is reused, and a witness mp[j] is rescanned only when
// the walk visits j and the witness is gone.
template <bool CLK>
__device__ __forceinline__ int walk(const unsigned* __restrict__ p,
                                    unsigned* und, unsigned* vis, int* mp,
                                    int* path, int NW, int BP, int lane,
                                    int& j0, int& plen, long long* c) {
  const bool tick = CLK && lane == 0;
  long long t0 = tick ? clock64() : 0;
  if (!bit_of(und, j0)) {
    int found = BP;
    for (int w = j0 >> 5; w < NW && found == BP; w += 32) {
      int ww = w + lane;
      unsigned x = ww < NW ? und[ww] : 0u;
      if (ww == (j0 >> 5)) x &= FULL << (j0 & 31);
      unsigned bal = __ballot_sync(FULL, x != 0u);
      if (bal) {
        int l = __ffs(bal) - 1;
        unsigned v = __shfl_sync(FULL, x, l);
        found = (w + l) * 32 + __ffs(v) - 1;
      }
    }
    j0 = found;  // BP only if the count and the set disagree
  }
  int victim = BP;
  if (j0 < BP) {
    // The last path's prefix of undetermined txns, if it starts at j0.
    int k = 0;
    if (plen > 0 && path[0] == j0) {
      k = plen;
      for (int b0 = 0; b0 < plen; b0 += 32) {
        int idx = b0 + lane;
        unsigned bal =
            __ballot_sync(FULL, idx < plen && !bit_of(und, path[idx]));
        if (bal) {
          k = b0 + __ffs(bal) - 1;
          break;
        }
      }
    }
    for (int idx = k + lane; idx < plen; idx += 32) {
      int j = path[idx];
      atomicAnd(&vis[j >> 5], ~(1u << (j & 31)));
    }
    __syncwarp();
    int j;
    if (k == 0) {
      j = j0;
      path[0] = j0;  // every lane stores the same value
      vis[j0 >> 5] |= 1u << (j0 & 31);
      plen = 1;
    } else {
      j = path[k - 1];
      plen = k;
    }
    __syncwarp();
    long long t1 = tick ? clock64() : 0;
    if (tick) {
      c[WV_CLK_STALL_PREFIX] += t1 - t0;
      c[WV_CLK_REUSED] += k;
    }
    int rep;  // the first repeated node: it lies on the cycle
    for (;;) {
      int m = mp[j];
      if (m < 0 || m >= BP || !bit_of(und, m)) {
        long long t2 = tick ? clock64() : 0;
        m = min_pred<CLK>(p + (int64_t)j * NW, und, NW,
                          m < 0 ? 0 : m >> 5, BP, lane,
                          &c[WV_CLK_RESCAN_WORDS]);
        mp[j] = m;
        if (tick) {
          c[WV_CLK_STALL_RESCAN] += clock64() - t2;
          c[WV_CLK_RESCANS] += 1;
        }
      }
      if (m >= BP) {  // no undetermined predecessor: not a stall
        rep = j;
        break;
      }
      const unsigned vw = vis[m >> 5], bit = 1u << (m & 31);
      if (vw & bit) {
        rep = m;
        break;
      }
      vis[m >> 5] = vw | bit;  // every lane stores the same values
      path[plen] = m;
      ++plen;
      if (tick) c[WV_CLK_STEPS] += 1;
      j = m;
      __syncwarp();
    }
    __syncwarp();
    const long long t3 = tick ? clock64() : 0;
    if (tick) c[WV_CLK_STALL_WALK] += t3 - t1;
    // The victim: the minimum of the path from the repeated node on.
    int pos = 0;
    for (int b0 = 0; b0 < plen; b0 += 32) {
      int idx = b0 + lane;
      unsigned bal = __ballot_sync(FULL, idx < plen && path[idx] == rep);
      if (bal) {
        pos = b0 + __ffs(bal) - 1;
        break;
      }
    }
    int mn = BP;
    for (int idx = pos + lane; idx < plen; idx += 32)
      mn = min(mn, path[idx]);
    victim = __reduce_min_sync(FULL, mn);
  }
  return victim;
}

// level [B] int32; accepted [B]; verdicts [B] (may be null, then too_old
// and tmask are not read); stats int64 [5] (may be null) accumulates
// (batches, rounds, victims, max rounds, max victims). The round state is
// in shared memory (SMEM: the compiler then sees shared-space pointers, and
// shared loads and atomics) or in `state`.
template <bool CLK, bool SMEM>
__global__ void __launch_bounds__(WV_THREADS, 1) k_level(
    const unsigned* __restrict__ p, const unsigned* __restrict__ pT,
    const bool* cand, const bool* too_old, const bool* tmask, int B, int BP,
    int NW, const int* gindeg, const unsigned* w1, int* state, int* level,
    bool* accepted, signed char* verdicts, long long* stats,
    long long* clk) {
  extern __shared__ int smem[];
  int* base;
  if constexpr (SMEM) base = smem; else base = state;
  unsigned* und = (unsigned*)base;  // [NW] undetermined txns
  unsigned* vis = und + NW;         // [NW] the walk's path as a set
  int* mp = (int*)(vis + NW);       // [BP] witness; -1 unscanned
  int* queue = mp + BP;             // [BP] ready list, each txn once
  int* path = queue + BP;           // [BP] the last walk
  int* indeg = path + BP;           // [BP] undetermined predecessors
  __shared__ int s_head, s_tail, s_nund, s_wave, s_rounds, s_victims;
  __shared__ int s_victim, s_spec;
  __shared__ long long c[WV_CLK_N];  // the stats build's counters
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5;
  long long t_last = 0, decs = 0;
  if (CLK && tid == 0) {
    clk[WV_CLK_LVL_T0] = (long long)globaltimer();
    t_last = clock64();
  }
  if (CLK && tid < WV_CLK_N) c[tid] = 0;
  if (tid == 0) {
    s_head = 0; s_tail = 0; s_nund = 0; s_wave = 0; s_rounds = 0;
    s_victims = 0; s_spec = -1;
  }
  __syncthreads();
  // The first wave (w1) is leveled and released already.
  for (int i = tid; i < BP; i += nt) {  // BP and nt are multiples of 32
    const unsigned first = w1[i >> 5];
    unsigned bits = __ballot_sync(FULL, i < B && cand[i]) & ~first;
    if (lane == 0) {
      und[i >> 5] = bits;
      vis[i >> 5] = 0u;
      if (bits) atomicAdd(&s_nund, __popc(bits));
      if (first) s_wave = 1;
    }
    mp[i] = -1;
    indeg[i] = gindeg[i];
    if (i < B) level[i] = ((first >> (i & 31)) & 1u) ? 0 : -1;
  }
  __syncthreads();
  if (tid == 0) s_rounds = s_wave;
  for (int j = tid; j < B; j += nt)
    if (bit_of(und, j) && indeg[j] == 0) queue[atomicAdd(&s_tail, 1)] = j;
  if (CLK && tid == 0) {
    long long t = clock64();
    c[WV_CLK_INIT] = t - t_last;
    t_last = t;
  }

  int j0 = 0, plen = 0;  // warp 0's walk: the lowest txn, the path length
  bool last_wave = false, first = true;
  while (true) {
    __syncthreads();
    const int head = s_head, tail = s_tail, nund = s_nund;
    const int rounds = s_rounds, wave = s_wave;
    __syncthreads();
    if (CLK && tid == 0) {
      long long t = clock64();
      if (!first) c[last_wave ? WV_CLK_WAVE : WV_CLK_STALL] += t - t_last;
      t_last = t;
    }
    if (nund == 0 || rounds > BP) break;
    first = false;
    last_wave = head < tail;
    if (last_wave) {
      // A wave: level the ready list. No ready txn is a successor of
      // another, so the release below reads none of the bits cleared here.
      for (int qi = head + tid; qi < tail; qi += nt) {
        int i = queue[qi];
        level[i] = wave;
        atomicAnd(&und[i >> 5], ~(1u << (i & 31)));
      }
      release_rows<CLK>(pT, queue + head, tail - head, und, NW, indeg, queue,
                        &s_tail, warp, nt >> 5, lane, &decs);
      if (tid == 0) {
        s_spec = -1;
        s_head = tail;
        s_wave = wave + 1;
        s_nund = nund - (tail - head);
        s_rounds = rounds + 1;
      }
      continue;
    }
    // A stall. Its victim was walked during the last stall's release if
    // that release freed no txn (s_spec); otherwise warp 0 walks now.
    if (warp == 0) {
      int victim = s_spec;
      if (victim < 0)
        victim = walk<CLK>(p, und, vis, mp, path, NW, BP, lane, j0, plen, c);
      if (lane == 0) {
        s_victim = victim;
        if (victim < BP) {
          level[victim] = -2;
          und[victim >> 5] &= ~(1u << (victim & 31));
          s_nund = nund - 1;
          s_victims += 1;
        } else {
          s_nund = 0;
        }
        s_rounds = rounds + 1;
      }
    }
    __syncthreads();
    const int victim = s_victim;
    if (warp == 0) {
      // The next stall's victim, walked while the other warps release this
      // one: the set does not change in between unless the release frees a
      // txn, and then the next round is a wave and drops it.
      int next = -1;
      if (victim < BP && nund > 1)
        next = walk<CLK>(p, und, vis, mp, path, NW, BP, lane, j0, plen, c);
      if (lane == 0) s_spec = next;
    } else if (victim < BP) {
      long long t0 = (CLK && tid == 32) ? clock64() : 0;
      release_row<CLK>(pT + (int64_t)victim * NW, und, NW, indeg, queue,
                       &s_tail, tid - 32, nt - 32, &decs);
      if (CLK && tid == 32) c[WV_CLK_STALL_RELEASE] += clock64() - t0;
    }
  }

  for (int i = tid; i < B; i += nt) {
    bool a = level[i] >= 0;
    accepted[i] = a;
    if (verdicts) verdicts[i] = too_old[i] ? 2 : ((tmask[i] && !a) ? 1 : 0);
  }
  if (tid == 0 && stats) {
    const long long rounds = s_rounds, victims = s_victims;
    stats[0] += 1;
    stats[1] += rounds;
    stats[2] += victims;
    stats[3] = stats[3] > rounds ? stats[3] : rounds;
    stats[4] = stats[4] > victims ? stats[4] : victims;
  }
  if (CLK) {
    if (decs)
      atomicAdd((unsigned long long*)&c[WV_CLK_DECREMENTS],
                (unsigned long long)decs);
    __syncthreads();
    if (tid == 0) {
      for (int k = WV_CLK_INIT; k < WV_CLK_N; ++k) clk[k] = c[k];
      clk[WV_CLK_CYCLES] = c[WV_CLK_INIT] + c[WV_CLK_WAVE] + c[WV_CLK_STALL];
      clk[WV_CLK_LVL_T1] = (long long)globaltimer();
    }
  }
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

// Words of K5's reader tile: up to 32, fewer when R is so wide that 32·TW
// read intervals would pass 48 KB of shared memory with the rows' writes.
static int pred_tile(int R, int Q, int NW) {
  const int fixed = PRED_ROWS * 8 * Q + 32 * 4;
  int tw = R > 0 ? (48 * 1024 - fixed) / (256 * R) : 32;
  tw = tw < 1 ? 1 : (tw > 32 ? 32 : tw);
  return tw < NW ? tw : NW;
}

extern "C" int wv_pred(const bool* cand, const int* rb, const int* re,
                       const bool* rlive, const int* wb, const int* we,
                       const bool* wlive, int B, int R, int Q, int BP,
                       unsigned* rows, cudaStream_t s) {
  if (BP <= 0) return (int)cudaGetLastError();
  const int nw = BP / 32;
  const int tw = pred_tile(R, Q, nw);
  const size_t smem = (size_t)8 * R * 32 * tw + (size_t)PRED_ROWS * 8 * Q +
                      4 * 32;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        k_pred, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  k_pred<<<dim3((nw + tw - 1) / tw, (BP + PRED_ROWS - 1) / PRED_ROWS),
           PRED_WARPS * 32, smem, s>>>(cand, rb, re, rlive, wb, we, wlive, B,
                                       R, Q, BP, nw, tw, rows);
  return (int)cudaGetLastError();
}

// Round state past this many bytes of shared memory lives in global scratch.
#define WV_SMEM_MAX (232448 - 1024)

template <bool CLK, bool SMEM>
static int launch_level(const unsigned* p, const unsigned* pT,
                        const bool* cand, const bool* too_old,
                        const bool* tmask, int B, int BP, const int* indeg,
                        const unsigned* w1, int* state, int* level,
                        bool* accepted,
                        signed char* verdicts, long long* stats,
                        long long* clk, size_t smem, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      k_level<CLK, SMEM>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  k_level<CLK, SMEM><<<1, WV_THREADS, smem, s>>>(p, pT, cand, too_old, tmask, B,
                                           BP, BP / 32, indeg, w1, state,
                                           level, accepted, verdicts, stats,
                                           clk);
  return (int)cudaGetLastError();
}

// scratch: uint32 [BP·BP/32 + 5·BP + 3·BP/32] (the wrapper's), holding pT
// [BP][BP/32], the in-degrees [BP], the round state [4·BP + 2·BP/32] and
// the first wave [BP/32].
// clk: int64 [WV_CLK_N] or null; given, the stats build runs and the
// counters of this launch are written there.
extern "C" int wv_level(const unsigned* p, const bool* cand,
                        const bool* too_old, const bool* tmask, int B, int BP,
                        int* level, bool* accepted, signed char* verdicts,
                        long long* stats, unsigned* scratch, long long* clk,
                        cudaStream_t s) {
  if (B <= 0) return (int)cudaGetLastError();
  const int nw = BP / 32;
  unsigned* pT = scratch;
  int* indeg = (int*)(scratch + (size_t)BP * nw);
  int* state = indeg + BP;
  unsigned* w1 = (unsigned*)(state + 4 * (size_t)BP + 2 * nw);
  cudaError_t e = cudaMemsetAsync(indeg, 0, (size_t)BP * 4, s);
  if (e == cudaSuccess && clk) e = cudaMemsetAsync(clk, 0, WV_CLK_N * 8, s);
  if (e == cudaSuccess && clk) e = cudaMemsetAsync(clk, 0xff, 8, s);
  if (e != cudaSuccess) return (int)e;
  k_prologue<<<dim3((nw + 7) / 8, (BP + 255) / 256), 256, 0, s>>>(
      p, cand, B, BP, nw, pT, indeg, clk);
  k_first_mask<<<(nw + 7) / 8, 256, 0, s>>>(cand, indeg, B, nw, w1);
  k_first_release<<<dim3((nw + 7) / 8, (B + 255) / 256), 256, 0, s>>>(
      p, cand, B, nw, w1, indeg, clk);
  const size_t smem = (size_t)4 * (4 * (size_t)BP + 2 * nw);
  if (smem <= WV_SMEM_MAX)
    return clk ? launch_level<true, true>(p, pT, cand, too_old, tmask, B, BP,
                                          indeg, w1, state, level, accepted,
                                          verdicts, stats, clk, smem, s)
               : launch_level<false, true>(p, pT, cand, too_old, tmask, B, BP,
                                           indeg, w1, state, level, accepted,
                                           verdicts, stats, clk, smem, s);
  return clk ? launch_level<true, false>(p, pT, cand, too_old, tmask, B, BP,
                                         indeg, w1, state, level, accepted,
                                         verdicts, stats, clk, 0, s)
             : launch_level<false, false>(p, pT, cand, too_old, tmask, B, BP,
                                          indeg, w1, state, level, accepted,
                                          verdicts, stats, clk, 0, s);
}
