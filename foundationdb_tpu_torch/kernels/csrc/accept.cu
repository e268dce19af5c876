// K3: exact sequential-order acceptance, verdicts and the loser mask.
//
// Replaces (foundationdb_tpu/models/conflict_kernel.py):
//   _block_accept_fused (:472) -> _block_scan_accept (:391), _overlap_rows
//   (:327), _wave_accept_packed (:573) and, when B % G != 0, _wave_accept
//   (:525); the ops/bitset.py packing (:28/:38/:44); under
//   FDB_TPU_ACCEPT=seq the in-block _seq_accept_packed (:607) and, under
//   FDB_TPU_PACKED=0 too, _seq_accept (:503): the G-step sequential rule,
//   whose exact result this kernel computes, so accept="seq" launches it;
//   assemble_verdicts (:1072);
//   loser_range_mask (:1082) with _read_vs_accepted_writes (:257) and
//   pack_loser_mask (:1537), the report program's extra output.
//
// What it computes: txn i is accepted iff cand[i] and no accepted j < i
// has a live write overlapping a live read of i: the exact sequential
// result for every B (the JAX package's 512-txn block scan and its dense
// path for B % 512 != 0 give the same set).
//
// Bound on the H100: the overlap rows are operations (B^2/2 x R x Q
// interval compares, 67 M at B = 8192, R = 2, Q = 1); the settle is a chain
// of dependent steps, one per row it walks, so it is bound by latency.
//
// Design, four launches (k_init resets the per-row summaries first):
// 1. k_overlap, across the card: one block a group of 32 rows by a tile of
//    1,024 columns (the lower triangle only). The block stages the tile's
//    write ranges in shared memory, and a warp forms word w of row i with
//    lane k testing column j = 32w + k (neighbouring lanes read
//    neighbouring writes) and __ballot_sync, four words in flight. A
//    column j that is not a candidate can never be accepted, so its write
//    range is staged empty and its bit is never set (cand is final before
//    K3: too-old and history losers are already out of it). Rows of
//    non-candidates are not built. Beside each row: its first and last
//    nonzero word (atomicMin / atomicMax over its tiles: the same answer
//    in any order); the group's last tile to finish writes acc0, the
//    group's candidates with no bit, which are accepted whatever else
//    happens.
// 2. k_prune, across the card: a row that has bits and meets acc0 is
//    rejected at once; every other row but the remaining ("pending") ones
//    gets its verdict here. A word per 32 rows marks the pending ones.
// 3. k_walk, one block: the pending rows in index order, found by a
//    deterministic prefix count over the marks, 1,024 at a time. Sixteen
//    warps stage a chunk's entries and words into one half of a double
//    buffer with cp.async. All warps then run up to 8 relaxation rounds
//    over the chunk, against the accepted set in shared memory (B/8
//    bytes): a row that meets it is rejected, one whose bits all point to
//    settled rows is accepted. One warp then walks the rows the rounds
//    left, in index order: a row is accepted when none of its words
//    first..last meets the accepted set. A step is a few shared loads and
//    a vote, the next row's entry and first words loaded during it, and
//    the stagers fill the other half meanwhile. The walked rows' outputs
//    are written after the walk, so no global store sits in the chain.
// The accepted set so far only grows, and rows are settled in index
// order, so every decision is the sequential one, edges across 512-txn
// blocks included. k_losers (the report path) is unchanged: it marks
// each read slot of a CONFLICT transaction that lost to history or
// overlaps an accepted transaction's write, and packs the slots of a
// transaction into one 32-bit word.
// A stats build (the entry given `clk`) records globaltimer spans of the
// overlap, prune and walk launches, counts and the walk's cycles (AC_CLK_*
// below).

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#define FULL 0xffffffffu
#define OV_ROWS 32      // rows a k_overlap / k_prune block: one word of marks
#define OV_WARPS 16
#define OV_SMEM 98304   // k_overlap's staging budget (bytes)
#define WK_STAGERS 16   // k_walk: warps staging beside the walking warp
#define WK_THREADS ((WK_STAGERS + 1) * 32)
#define WK_CHUNK (WK_STAGERS * 64)  // pending rows a stage (two a thread)
#define WK_SHORT 64                 // longer entries are staged by a warp
#define WK_ROUNDS 8                 // relaxation rounds a chunk, at most
#define WK_HDR 64                   // int32 scratch at the start of k_walk's
                                    // shared memory

// The stats build's counters, int64 [AC_CLK_N]: each launch's first
// start and last end (globaltimer ns), the rows with a candidate
// predecessor, the pending rows, the relaxation rounds run, the rows the
// serial walk visits and the words they hold, and the walk kernel's
// clock64 cycles in the prefix count, in the first stage (as a staging
// warp sees it), in the rounds and in the walking warp's steps.
enum {
  AC_CLK_OVERLAP_T0, AC_CLK_OVERLAP_T1, AC_CLK_PRUNE_T0, AC_CLK_PRUNE_T1,
  AC_CLK_WALK_T0, AC_CLK_WALK_T1, AC_CLK_EDGEFUL, AC_CLK_PENDING,
  AC_CLK_ROUNDS, AC_CLK_WALK_STEPS, AC_CLK_WALK_WORDS, AC_CLK_PREFIX_CYCLES,
  AC_CLK_STAGE_CYCLES, AC_CLK_ROUND_CYCLES, AC_CLK_WALKING_CYCLES, AC_CLK_N
};

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ void clk_start(long long* clk, int k) {
  if (clk && threadIdx.x == 0)
    atomicMin((unsigned long long*)&clk[k], globaltimer());
}

__device__ __forceinline__ void clk_end(long long* clk, int k) {
  if (clk) {
    __syncthreads();
    if (threadIdx.x == 0)
      atomicMax((unsigned long long*)&clk[k], globaltimer());
  }
}

// Before each acceptance: no row has a bit yet, no tile of a group is
// done; the stats build's counters start.
__global__ void k_init(int* first, int* last, int* done, int B, int nw,
                       long long* clk) {
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < B) {
    first[t] = INT_MAX;
    last[t] = -1;
  }
  if (t < nw) done[t] = 0;
  if (clk && t < AC_CLK_N)
    clk[t] = (t == AC_CLK_OVERLAP_T0 || t == AC_CLK_PRUNE_T0 ||
              t == AC_CLK_WALK_T0) ? LLONG_MAX : 0;
}

// One block: the 32 rows of group g (blockIdx.y) against the tw·32 columns
// of tile blockIdx.x. rows [B, nw] uint32: word w < ceil(i/32) of a
// candidate row i holds bits for the candidates 32w .. 32w+31 < i.
// first[i] / last[i]: the row's first and last nonzero word (INT_MAX, -1
// while it has none), combined across tiles by atomicMin / atomicMax; the
// last tile of a group to finish writes acc0[g], bit k: row 32g + k is a
// candidate with no bit. RC, QC > 0 fix R and Q.
template <int RC, int QC>
__global__ void __launch_bounds__(OV_WARPS * 32)
k_overlap(const bool* cand, const int* rb, const int* re, const bool* rlive,
          const int* wb, const int* we, const bool* wlive, int B, int R,
          int Q, int nw, int tw, unsigned* rows, int* first, int* last,
          int* done, unsigned* acc0, long long* clk) {
  extern __shared__ int2 ov_sm[];
  __shared__ bool s_last_tile;
  const int nr = RC ? RC : R, nq = QC ? QC : Q, tcols = tw * 32;
  const int g = blockIdx.y, i0 = g * OV_ROWS, c0 = blockIdx.x * tcols;
  const int colmax = min(B, i0 + OV_ROWS);  // columns j < i of these rows
  if (c0 >= colmax) return;
  int2* sw = ov_sm;               // [nq][tcols] write ranges of the tile
  int2* sr = ov_sm + nq * tcols;  // [OV_ROWS][nr] read ranges of the rows
  clk_start(clk, AC_CLK_OVERLAP_T0);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int u = threadIdx.x; u < OV_ROWS * nr; u += blockDim.x) {
    int i = i0 + u / nr, s = i * nr + u % nr;
    sr[u] = i < B && rlive[s] ? make_int2(rb[s], re[s])
                              : make_int2(INT_MAX, INT_MIN);
  }
  for (int u = threadIdx.x; u < nq * tcols; u += blockDim.x) {
    int j = c0 + u % tcols, s = j * nq + u / tcols;
    int2 v = make_int2(INT_MAX, INT_MIN);
    if (j < colmax) {  // four independent loads: one round trip
      bool c = cand[j], l = wlive[s];
      int b0 = wb[s], e0 = we[s];
      if (c && l) v = make_int2(b0, e0);
    }
    sw[u] = v;
  }
  __syncthreads();
  const int w0 = c0 >> 5;
  for (int lr = warp; lr < OV_ROWS; lr += OV_WARPS) {
    const int i = i0 + lr;
    const int nt = min(tw, ((i + 31) >> 5) - w0);  // row words in the tile
    if (i >= B || nt <= 0 || !cand[i]) continue;
    const int2* rr = sr + lr * nr;
    int2 reg[RC ? RC : 1];
    if (RC)
#pragma unroll
      for (int r = 0; r < (RC ? RC : 1); ++r) reg[r] = rr[r];
    // Four words a pass, their loads in flight together (tw is a multiple
    // of 4, so a pass stays inside the tile; words past the row's end are
    // formed and dropped).
    unsigned mine = 0;
    for (int t0 = 0; t0 < nt; t0 += 4) {
      unsigned bits[4];
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        const int c = (t0 + d) * 32 + lane;
        bool h = false;
        for (int q = 0; q < nq; ++q) {
          int2 wv = sw[q * tcols + c];
          if (RC) {
#pragma unroll
            for (int r = 0; r < (RC ? RC : 1); ++r)
              h |= (reg[r].x < wv.y) & (wv.x < reg[r].y);
          } else {
            for (int r = 0; r < nr; ++r) {
              int2 rv = rr[r];
              h |= (rv.x < wv.y) & (wv.x < rv.y);
            }
          }
        }
        bits[d] = __ballot_sync(FULL, h);
      }
#pragma unroll
      for (int d = 0; d < 4; ++d)
        if (lane == t0 + d) mine = bits[d];
    }
    if (w0 + lane == i >> 5) mine &= (1u << (i & 31)) - 1;  // columns < i
    if (lane < nt) rows[(int64_t)i * nw + w0 + lane] = mine;
    unsigned nz = __ballot_sync(FULL, lane < nt && mine);
    if (nz && lane == 0) {
      atomicMin(&first[i], w0 + __ffs(nz) - 1);
      atomicMax(&last[i], w0 + 31 - __clz(nz));
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    s_last_tile = atomicAdd(&done[g], 1) == (colmax + tcols - 1) / tcols - 1;
  __syncthreads();
  if (s_last_tile && warp == 0) {
    const int i = i0 + lane;
    bool free_row = i < B && cand[i] && __ldcg(&last[i]) < 0;
    unsigned m = __ballot_sync(FULL, free_row);
    if (lane == 0) acc0[g] = m;
  }
  clk_end(clk, AC_CLK_OVERLAP_T1);
}

// pend[g] bit k: row 32g + k has bits and none meets acc0 (the walk
// decides it); every other row's accepted flag and verdict are written.
__global__ void __launch_bounds__(OV_WARPS * 32)
k_prune(const bool* cand, const bool* too_old, const bool* tmask,
        const unsigned* rows, const int* first, const int* last,
        const unsigned* acc0, int B, int nw, unsigned* pend, bool* accepted,
        signed char* verdicts, long long* clk) {
  __shared__ unsigned char s_pend[OV_ROWS], s_acc[OV_ROWS];
  clk_start(clk, AC_CLK_PRUNE_T0);
  const int g = blockIdx.x, i0 = g * OV_ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int lr = warp; lr < OV_ROWS; lr += OV_WARPS) {
    const int i = i0 + lr;
    bool p = false, a = false;
    if (i < B && cand[i]) {
      const int f = first[i], l = last[i];
      a = l < 0;
      if (!a) {
        bool hit = false;
        const unsigned* row = rows + (int64_t)i * nw;
        for (int w = f + lane; !hit && w - lane <= l; w += 32)
          hit = __any_sync(FULL, w <= l && (row[w] & acc0[w]) != 0);
        p = !hit;
        if (clk && lane == 0)
          atomicAdd((unsigned long long*)&clk[AC_CLK_EDGEFUL], 1ull);
      }
    }
    if (lane == 0) {
      s_pend[lr] = p;
      s_acc[lr] = a;
    }
  }
  __syncthreads();
  if (warp == 0) {
    const int i = i0 + lane;
    unsigned m = __ballot_sync(FULL, s_pend[lane]);
    if (lane == 0) pend[g] = m;
    if (i < B && !s_pend[lane]) {
      bool a = s_acc[lane];
      accepted[i] = a;
      verdicts[i] = too_old[i] ? 2 : ((tmask[i] && !a) ? 1 : 0);
    }
  }
  clk_end(clk, AC_CLK_PRUNE_T1);
}

// Exclusive prefix sum of one int a thread over the whole block, in thread
// order; *total gets the sum. hdr: 64 ints of scratch; two barriers.
__device__ int block_scan(int v, int* hdr, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  int incl = v;
  for (int o = 1; o < 32; o <<= 1) {
    int y = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += y;
  }
  if (lane == 31) hdr[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    int w = lane < nwarps ? hdr[lane] : 0, x = w;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane < nwarps) hdr[32 + lane] = x - w;  // warps before
    if (lane == nwarps - 1) hdr[32 + nwarps] = x;
  }
  __syncthreads();
  *total = hdr[32 + nwarps];
  return hdr[32 + warp] + incl - v;
}

__device__ __forceinline__ void stagers_sync() {
  asm volatile("bar.sync 1, %0;" ::"r"(WK_STAGERS * 32));
}

__global__ void __launch_bounds__(WK_THREADS, 1)
k_walk(const unsigned* rows, const int* first, const int* last,
       const unsigned* acc0, const unsigned* pend_g, const bool* too_old,
       const bool* tmask, int B, int nw, int cap, bool* accepted,
       signed char* verdicts, long long* clk) {
  extern __shared__ int4 wk_sm[];
  int* hdr = (int*)wk_sm;                 // [WK_HDR]
  unsigned* acc = (unsigned*)(hdr + WK_HDR);  // [nw] accepted so far
  unsigned* pend = acc + nw;                  // [nw] the marks
  unsigned* und = pend + nw;                  // [nw] pending, not yet settled
  int* prefix = (int*)(und + nw);             // [nw + 1] marks before word w
  int4* ent = wk_sm + (WK_HDR + 4 * nw + 1 + 3) / 4;  // [2][WK_CHUNK]
  int* todo = (int*)(ent + 2 * WK_CHUNK);  // [WK_CHUNK] entries to walk
  unsigned char* dec = (unsigned char*)(todo + WK_CHUNK);  // [WK_CHUNK]
  unsigned* buf = (unsigned*)(dec + WK_CHUNK);              // [2][cap]
  clk_start(clk, AC_CLK_WALK_T0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nwarps = WK_THREADS / 32;
  long long cyc = clock64();

  // The marks' exclusive prefix count (each thread a run of words).
  const int per = (nw + WK_THREADS - 1) / WK_THREADS;
  const int w_lo = min(nw, tid * per), w_hi = min(nw, w_lo + per);
  int mine = 0;
  for (int w = w_lo; w < w_hi; ++w) {
    acc[w] = acc0[w];
    unsigned m = pend_g[w];
    pend[w] = m;
    und[w] = m;
    mine += __popc(m);
  }
  int total;
  int run = block_scan(mine, hdr, &total);
  for (int w = w_lo; w < w_hi; ++w) {
    prefix[w] = run;
    run += __popc(pend[w]);
  }
  if (tid == 0) prefix[nw] = total;
  __syncthreads();
  if (clk && tid == 0) {
    clk[AC_CLK_PENDING] = total;
    clk[AC_CLK_PREFIX_CYCLES] = clock64() - cyc;
  }
  const int nch = (total + WK_CHUNK - 1) / WK_CHUNK;
  if (clk && tid == 32) cyc = clock64();

  // Stage chunk c (stager threads only): entries, word offsets, copies.
  auto stage = [&](int c) {
    const int st = tid - 32, sw = st >> 5;
    int4 e[2];
    int spn[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int rank = c * WK_CHUNK + 2 * st + h;
      spn[h] = 0;
      e[h] = make_int4(0, 0, 0, -1);
      if (rank < total) {
        int lo = 0, hi = nw + 1;  // the last w with prefix[w] <= rank
        while (hi - lo > 1) {
          int mid = (lo + hi) >> 1;
          if (prefix[mid] <= rank) lo = mid; else hi = mid;
        }
        unsigned m = pend[lo];
        for (int k = rank - prefix[lo]; k > 0; --k) m &= m - 1;
        const int i = lo * 32 + __ffs(m) - 1;
        const int f = first[i];
        spn[h] = last[i] - f + 1;
        e[h] = make_int4(i, f, spn[h], 0);
      }
    }
    const int mine_w = spn[0] + spn[1];
    int x = mine_w;
    for (int o = 1; o < 32; o <<= 1) {
      int y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x += y;
    }
    if (lane == 31) hdr[sw] = x;
    stagers_sync();
    int off = x - mine_w;
    for (int k = 0; k < sw; ++k) off += hdr[k];
    const int b = c & 1;  // entries (row, first word, span, offset in the
                          // stage buffer, -1 when they did not fit)
    int4* E = ent + b * WK_CHUNK;
    unsigned* bf = buf + (size_t)b * cap;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (spn[h]) {
        e[h].w = off + spn[h] <= cap ? off : -1;
        E[2 * st + h] = e[h];
      }
      off += spn[h];
    }
    // A short entry's words are copied by its own thread; a long one's by
    // its warp, one entry at a time.
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool mine_long = spn[h] > WK_SHORT && e[h].w >= 0;
      if (spn[h] && !mine_long && e[h].w >= 0) {
        const unsigned* from = rows + (int64_t)e[h].x * nw + e[h].y;
        for (int t = 0; t < spn[h]; ++t)
          __pipeline_memcpy_async(bf + e[h].w + t, from + t, 4);
      }
      for (unsigned lm = __ballot_sync(FULL, mine_long); lm; lm &= lm - 1) {
        const int src = __ffs(lm) - 1;
        const int i = __shfl_sync(FULL, e[h].x, src);
        const int f = __shfl_sync(FULL, e[h].y, src);
        const int s = __shfl_sync(FULL, spn[h], src);
        const int o = __shfl_sync(FULL, e[h].w, src);
        const unsigned* from = rows + (int64_t)i * nw + f;
        for (int t = lane; t < s; t += 32)
          __pipeline_memcpy_async(bf + o + t, from + t, 4);
      }
    }
    __pipeline_commit();
    __pipeline_wait_prior(0);
  };

  // Relaxation rounds over the entries of chunk c, every warp: a pending
  // row that meets the accepted set is rejected, one whose bits all point
  // to settled rows is accepted (a warp an entry, lanes over its words).
  // Earlier chunks are settled by then, and a round decides every row
  // from one state before it applies them, so each decision is final.
  // Then the entries still open are listed in order in todo; returns
  // (rounds run) and sets *n_todo.
  auto rounds = [&](int c, int* n_todo) {
    const int b = c & 1;
    const int n = min(WK_CHUNK, total - c * WK_CHUNK);
    const int4* E = ent + b * WK_CHUNK;
    const unsigned* bf = buf + (size_t)b * cap;
    int r = 0;
    while (r < WK_ROUNDS) {
      ++r;
      for (int e = warp; e < n; e += nwarps) {
        const int4 x = E[e];
        unsigned char d = 0;  // 1 accept, 2 reject
        if ((und[x.x >> 5] >> (x.x & 31)) & 1u) {
          const unsigned* row = rows + (int64_t)x.x * nw + x.y;
          bool hit = false, open = false;
          for (int t = lane; t < x.z; t += 32) {
            const unsigned w = x.w >= 0 ? bf[x.w + t] : row[t];
            hit |= (w & acc[x.y + t]) != 0;
            open |= (w & und[x.y + t]) != 0;
          }
          hit = __any_sync(FULL, hit);
          open = __any_sync(FULL, open);
          d = hit ? 2 : (open ? 0 : 1);
        }
        if (lane == 0) dec[e] = d;
      }
      __syncthreads();
      bool changed = false;
      for (int e = tid; e < n; e += WK_THREADS) {
        if (!dec[e]) continue;
        const int i = E[e].x;
        if (dec[e] == 1) atomicOr(&acc[i >> 5], 1u << (i & 31));
        atomicAnd(&und[i >> 5], ~(1u << (i & 31)));
        changed = true;
      }
      if (!__syncthreads_or(changed)) break;
    }
    // The open entries, in order (two consecutive ones a thread).
    bool open[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int e = 2 * tid + h;
      open[h] = e < n && ((und[E[e].x >> 5] >> (E[e].x & 31)) & 1u);
    }
    int at = block_scan(open[0] + open[1], hdr, n_todo);
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (open[h]) todo[at++] = 2 * tid + h;
    __syncthreads();
    return r;
  };

  if (warp > 0 && nch > 0) stage(0);
  if (clk && tid == 32) clk[AC_CLK_STAGE_CYCLES] = clock64() - cyc;
  __syncthreads();
  long long words = 0, steps = 0, walking = 0, relaxing = 0, n_rounds = 0;
  for (int c = 0; c < nch; ++c) {
    const long long t_round = clock64();
    int n_todo;
    n_rounds += rounds(c, &n_todo);
    relaxing += clock64() - t_round;
    if (warp == 0) {
      const long long t_walk = clock64();
      const int b = c & 1;
      const int4* E = ent + b * WK_CHUNK;
      const unsigned* bf = buf + (size_t)b * cap;
      int4 x = n_todo ? E[todo[0]] : make_int4(0, 0, 0, -1);
      unsigned w0 = lane < x.z && x.w >= 0 ? bf[x.w + lane] : 0u;
      for (int k = 0; k < n_todo; ++k) {
        // The next entry and its first words (shared loads that do not
        // depend on this step), then this step.
        const int4 xn = E[todo[k + 1 < n_todo ? k + 1 : k]];
        const unsigned wn = lane < xn.z && xn.w >= 0 ? bf[xn.w + lane] : 0u;
        const int i = x.x, f = x.y, s = x.z;
        bool hit;
        if (x.w >= 0) {
          hit = lane < s && (w0 & acc[f + lane]) != 0;
          for (int t = lane + 32; t < s; t += 32)
            hit |= (bf[x.w + t] & acc[f + t]) != 0;
        } else {  // not staged: the row's words from L2
          const unsigned* row = rows + (int64_t)i * nw + f;
          hit = false;
          for (int t = lane; t < s; t += 32)
            hit |= (row[t] & acc[f + t]) != 0;
        }
        hit = __any_sync(FULL, hit);
        if (!hit) {  // every lane stores the same word, so each lane's
                     // later loads see it with no warp barrier
          const unsigned v = acc[i >> 5];
          acc[i >> 5] = v | (1u << (i & 31));
        }
        const unsigned v = und[i >> 5];
        und[i >> 5] = v & ~(1u << (i & 31));
        words += s;
        x = xn;
        w0 = wn;
      }
      steps += n_todo;
      walking += clock64() - t_walk;
    } else if (c + 1 < nch) {
      stage(c + 1);
    }
    __syncthreads();
  }
  if (clk && tid == 0) {
    clk[AC_CLK_ROUNDS] = n_rounds;
    clk[AC_CLK_WALK_STEPS] = steps;
    clk[AC_CLK_WALK_WORDS] = words;
    clk[AC_CLK_ROUND_CYCLES] = relaxing;
    clk[AC_CLK_WALKING_CYCLES] = walking;
  }
  // The walked rows' outputs, from the settled accepted set.
  for (int w = w_lo; w < w_hi; ++w) {
    for (unsigned m = pend[w]; m; m &= m - 1) {
      const int i = w * 32 + __ffs(m) - 1;
      const bool a = (acc[w] >> (i & 31)) & 1u;
      accepted[i] = a;
      verdicts[i] = too_old[i] ? 2 : ((tmask[i] && !a) ? 1 : 0);
    }
  }
  clk_end(clk, AC_CLK_WALK_T1);
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

// Raise a kernel's dynamic shared memory limit to ``bytes`` (once per
// size and device).
static cudaError_t allow_smem(const void* fn, size_t bytes, size_t* done) {
  if (bytes <= 48 * 1024 || bytes <= *done) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e == cudaSuccess) *done = bytes;
  return e;
}

// aux int32 [2B + 3 ceil(B/32)]: the rows' first and last nonzero words,
// acc0, the marks and the groups' finished tiles.
extern "C" int ac_accept(const bool* cand, const bool* too_old,
                         const bool* tmask, const int* rb, const int* re,
                         const bool* rlive, const int* wb, const int* we,
                         const bool* wlive, int B, int R, int Q,
                         unsigned* rows, int* aux, bool* accepted,
                         signed char* verdicts, long long* clk,
                         cudaStream_t s) {
  static size_t ov_done[64], ovg_done[64], wk_done[64];
  static int optin[64];
  if (B <= 0) return (int)cudaGetLastError();
  int dev = 0;
  cudaGetDevice(&dev);
  dev &= 63;
  if (!optin[dev])
    cudaDeviceGetAttribute(&optin[dev],
                           cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const int nw = (B + 31) / 32;
  int* first = aux;
  int* last = aux + B;
  unsigned* acc0 = (unsigned*)(aux + 2 * (int64_t)B);
  unsigned* pend = acc0 + nw;
  int* done = (int*)(pend + nw);
  k_init<<<blocks(max(B, AC_CLK_N), 256), 256, 0, s>>>(first, last, done, B,
                                                       nw, clk);
  int tw = 32;  // words a staged tile: 1,024 columns unless Q is large
  while (tw > 4 && (size_t)Q * tw * 32 * 8 > OV_SMEM) tw /= 2;
  const size_t ov = (size_t)Q * tw * 32 * 8 + (size_t)OV_ROWS * R * 8;
  if (ov > (size_t)optin[dev]) return (int)cudaErrorInvalidValue;
  const dim3 grid((B + tw * 32 - 1) / (tw * 32), nw);
  cudaError_t e;
  if (R == 2 && Q == 1) {
    if ((e = allow_smem((const void*)k_overlap<2, 1>, ov, &ov_done[dev])))
      return (int)e;
    k_overlap<2, 1><<<grid, OV_WARPS * 32, ov, s>>>(
        cand, rb, re, rlive, wb, we, wlive, B, R, Q, nw, tw, rows, first,
        last, done, acc0, clk);
  } else {
    if ((e = allow_smem((const void*)k_overlap<0, 0>, ov, &ovg_done[dev])))
      return (int)e;
    k_overlap<0, 0><<<grid, OV_WARPS * 32, ov, s>>>(
        cand, rb, re, rlive, wb, we, wlive, B, R, Q, nw, tw, rows, first,
        last, done, acc0, clk);
  }
  k_prune<<<nw, OV_WARPS * 32, 0, s>>>(cand, too_old, tmask, rows, first,
                                       last, acc0, B, nw, pend, accepted,
                                       verdicts, clk);
  const size_t fixed = ((size_t)(WK_HDR + 4 * nw + 1 + 3) / 4) * 16
                       + (size_t)2 * WK_CHUNK * 16 + (size_t)WK_CHUNK * 5;
  if (fixed + 2 * 32 * 4 > (size_t)optin[dev])
    return (int)cudaErrorInvalidValue;
  const int cap = (int)(((size_t)optin[dev] - fixed) / 8) & ~3;
  const size_t wk = fixed + (size_t)2 * cap * 4;
  if ((e = allow_smem((const void*)k_walk, wk, &wk_done[dev]))) return (int)e;
  k_walk<<<1, WK_THREADS, wk, s>>>(rows, first, last, acc0, pend, too_old,
                                   tmask, B, nw, cap, accepted, verdicts,
                                   clk);
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
