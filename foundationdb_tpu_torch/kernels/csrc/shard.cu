// K8, K9: the sharded engine's probe and clip (S keyspace shards of one
// card, the shard axis leading every array). Its wave exchange, K10, is
// K5's OR mode (wave.cu wv_pred_or).
//
// Replaces (foundationdb_tpu/):
//   K8: parallel/sharded_resolver.py _res_shard_step (:188), its probe half
//       with models/conflict_kernel.py too_old_mask_packed (:1425) and
//       _history_conflict_ranges_res (:2136), and the cross-shard OR of the
//       conflict bits (the all_gather of pack_bits_u32 or the psum, :199-205);
//   K9: models/conflict_kernel.py clip_ranks (:2109), every shard at once.
//
// K9 is elementwise and bound by bytes: per shard it reads the batch's
// endpoint ranks and masks and writes their clamped copies (S x B x Q
// writes, and S x B x R reads on a wave engine). One block row per (shard,
// array), four elements a thread with 16-byte loads and stores where the
// lengths and pointers allow; the clamp is the same two-sided
// min(max(v, lo), hi) on both endpoints, a monotone map, so the host's
// paint order of the unclipped endpoints stays sorted for every shard.
// Its card work is microseconds: what a launch costs is the host's
// wrapper, so the window program checks shapes once a window and clips
// into buffers it allocates once a window (kernels.shard_clip_into).
//
// K8 reads only each shard's live rows: live_probe.cuh (shared with K16)
// builds a range-max structure over them in one launch and searches and
// ORs the shards' conflict bits in a second, which also folds the too-old
// test and writes too_old, the OR-ed conflict bit and the acceptance
// candidates, so K3 and K6 take them as they take K2's. Bound: dependent
// loads of the searches (a few steps into L2 past the shared fences) and
// LP_LV writes a live row for the table.

#include <cuda_runtime.h>
#include <stdint.h>

#include "live_probe.cuh"

__device__ __forceinline__ int clamp(int v, int lo, int hi) {
  v = v > lo ? v : lo;
  return v < hi ? v : hi;
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

// ------------------------------------------------------------------ K9

// blockIdx.y < S clips shard y's writes, past it (reads on) shard y - S's
// reads; each thread four consecutive elements of its array (int4 loads and
// stores of the endpoints, 4 mask bytes at once) when every length is a
// multiple of 4 and every pointer aligned (VEC), else one element.
template <bool VEC>
__global__ void k_clip(const int* __restrict__ rb, const int* __restrict__ re,
                       const bool* __restrict__ rm,
                       const int* __restrict__ wb, const int* __restrict__ we,
                       const bool* __restrict__ wm, int64_t nr, int64_t nq,
                       const int* __restrict__ lo, const int* __restrict__ hi,
                       int S, int* owb, int* owe, bool* owm, int* orb,
                       int* ore, bool* orm) {
  const bool rd = blockIdx.y >= (unsigned)S;
  const int s = rd ? blockIdx.y - S : blockIdx.y;
  const int *a = rd ? rb : wb, *z = rd ? re : we;
  const bool* m = rd ? rm : wm;
  const int64_t n = rd ? nr : nq;
  int* oa = (rd ? orb : owb) + s * n;
  int* oz = (rd ? ore : owe) + s * n;
  bool* om = (rd ? orm : owm) + s * n;
  const int l = lo[s], h = hi[s];
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (VEC) {
    if (4 * t >= n) return;
    const int4 x = reinterpret_cast<const int4*>(a)[t];
    const int4 y = reinterpret_cast<const int4*>(z)[t];
    const uchar4 k = reinterpret_cast<const uchar4*>(m)[t];
    const int4 cx = make_int4(clamp(x.x, l, h), clamp(x.y, l, h),
                              clamp(x.z, l, h), clamp(x.w, l, h));
    const int4 cy = make_int4(clamp(y.x, l, h), clamp(y.y, l, h),
                              clamp(y.z, l, h), clamp(y.w, l, h));
    reinterpret_cast<int4*>(oa)[t] = cx;
    reinterpret_cast<int4*>(oz)[t] = cy;
    reinterpret_cast<uchar4*>(om)[t] = make_uchar4(
        k.x && cx.x < cy.x, k.y && cx.y < cy.y, k.z && cx.z < cy.z,
        k.w && cx.w < cy.w);
  } else {
    if (t >= n) return;
    const int x = clamp(a[t], l, h), y = clamp(z[t], l, h);
    oa[t] = x;
    oz[t] = y;
    om[t] = m[t] && x < y;
  }
}

static inline bool aligned(const void* p, uintptr_t a) {
  return ((uintptr_t)p & (a - 1)) == 0;
}

extern "C" int sh_clip(const int* rb, const int* re, const bool* rm,
                       const int* wb, const int* we, const bool* wm, int B,
                       int R, int Q, const int* lo, const int* hi, int S,
                       int reads, int* owb, int* owe, bool* owm, int* orb,
                       int* ore, bool* orm, cudaStream_t s) {
  const int T = 256;
  const int64_t nr = (int64_t)B * R, nq = (int64_t)B * Q;
  const int64_t n = reads && nr > nq ? nr : nq;
  if (n <= 0 || S <= 0) return (int)cudaGetLastError();
  bool vec = nq % 4 == 0 && aligned(wb, 16) && aligned(we, 16) &&
             aligned(owb, 16) && aligned(owe, 16) && aligned(wm, 4) &&
             aligned(owm, 4);
  if (reads)
    vec = vec && nr % 4 == 0 && aligned(rb, 16) && aligned(re, 16) &&
          aligned(orb, 16) && aligned(ore, 16) && aligned(rm, 4) &&
          aligned(orm, 4);
  const dim3 grid(blocks(vec ? n / 4 : n, T), S * (reads ? 2 : 1));
  if (vec)
    k_clip<true><<<grid, T, 0, s>>>(rb, re, rm, wb, we, wm, nr, nq, lo, hi, S,
                                    owb, owe, owm, orb, ore, orm);
  else
    k_clip<false><<<grid, T, 0, s>>>(rb, re, rm, wb, we, wm, nr, nq, lo, hi,
                                     S, owb, owe, owm, orb, ore, orm);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------------ K8

// keys [S, C, 1], versions [S, C], n_used [S] (live rows, read on the
// device); reads [B, R]; lo/hi [S]; ws the live table (lp_run), tickets
// [S] zeroed: two CUDA kernels, counted into *launched.
extern "C" int sh_probe(const int* keys, int C, const int* versions,
                        const int* n_used, int S, const int* rb,
                        const int* re, const bool* rm, const int* rv,
                        const bool* tm, const int* lo, const int* hi,
                        const int* floor_p, int B, int R, int* ws,
                        int* tickets, bool* too_old, bool* hist, bool* cand,
                        int* launched, cudaStream_t s) {
  LpArgs a{};
  a.keys = keys;
  a.vals = versions;
  a.n_used = n_used;
  a.rb = rb;
  a.re = re;
  a.rm = rm;
  a.rv = rv;
  a.tm = tm;
  a.lo = lo;
  a.hi = hi;
  a.floor_p = floor_p;
  a.too_old = too_old;
  a.hist = hist;
  a.cand = cand;
  a.S = S;
  a.C = C;
  a.w = 1;
  a.B = B;
  a.R = R;
  return lp_run(a, ws, tickets, launched, s);
}
