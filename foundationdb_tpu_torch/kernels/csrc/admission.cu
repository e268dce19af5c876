// K11: the admission filter's device banks — set, clear, probe, count.
//
// Replaces (foundationdb_tpu/admission/filter.py, _JaxBanks):
//   _set (:158), a scatter-max of bools into one bank;
//   _clear (:164), one bank zeroed;
//   _probe (:168), an AND over the k hashed bits of each row, then an OR
//   over the banks the read version selects;
//   fill / fill_max (:198, :201), the mean of a bank's bools.
//
// Bound on the H100: launch and latency. A record sets m·k bits (m ~ the
// accepted writes of one batch, a few thousand), a probe reads n·k words
// at random slots of a 2^16-2^20-bit bank, a count reads one bank (at
// most 128 KiB): microseconds of traffic against the launch itself.
//
// Design: the banks are bit-packed, bit j of word w being slot 32w + j,
// 32 times fewer bytes than JAX's bool banks with identical answers. A
// set is one atomicOr per index (bits are only ever set, so the order of
// the atomics does not matter and a set never clears a bit); a clear is
// one thread per word; a probe is one thread per row that walks the
// masked banks and stops at the first whose k bits are all set; a count
// is a grid-stride popcount per bank, summed by warp shuffles and one
// atomicAdd per warp into a zeroed int32 per bank, so the fill is the
// exact count over nbits.

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL 0xffffffffu

__global__ void k_set(unsigned* words, int nw, int bank, const int64_t* idx,
                      int m) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  int64_t s = idx[i];
  atomicOr(words + (int64_t)bank * nw + (s >> 5), 1u << (s & 31));
}

__global__ void k_clear(unsigned* words, int nw, int bank) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < nw) words[(int64_t)bank * nw + i] = 0;
}

__global__ void k_probe(const unsigned* words, int banks, int nw,
                        const int64_t* idx, int n, int k,
                        const bool* bank_mask, bool* out) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool hit = false;
  for (int b = 0; b < banks && !hit; ++b) {
    if (!bank_mask[b]) continue;
    const unsigned* w = words + (int64_t)b * nw;
    bool all = true;
    for (int h = 0; h < k && all; ++h) {
      int64_t s = idx[(int64_t)i * k + h];
      all = (w[s >> 5] >> (s & 31)) & 1u;
    }
    hit = all;
  }
  out[i] = hit;
}

// counts[b] += popcount of bank b; grid (blocks, banks).
__global__ void k_count(const unsigned* words, int nw, int* counts) {
  int b = blockIdx.y;
  const unsigned* w = words + (int64_t)b * nw;
  int c = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < nw;
       i += gridDim.x * blockDim.x)
    c += __popc(w[i]);
  for (int o = 16; o > 0; o >>= 1) c += __shfl_down_sync(FULL, c, o);
  if ((threadIdx.x & 31) == 0 && c) atomicAdd(counts + b, c);
}

static inline int blocks(int64_t n, int t) { return (int)((n + t - 1) / t); }

extern "C" int ad_set(unsigned* words, int nw, int bank, const int64_t* idx,
                      int m, cudaStream_t s) {
  if (m > 0) k_set<<<blocks(m, 256), 256, 0, s>>>(words, nw, bank, idx, m);
  return (int)cudaGetLastError();
}

extern "C" int ad_clear(unsigned* words, int nw, int bank, cudaStream_t s) {
  k_clear<<<blocks(nw, 256), 256, 0, s>>>(words, nw, bank);
  return (int)cudaGetLastError();
}

extern "C" int ad_probe(const unsigned* words, int banks, int nw,
                        const int64_t* idx, int n, int k,
                        const bool* bank_mask, bool* out, cudaStream_t s) {
  if (n > 0)
    k_probe<<<blocks(n, 128), 128, 0, s>>>(words, banks, nw, idx, n, k,
                                           bank_mask, out);
  return (int)cudaGetLastError();
}

// counts: int32 [banks], zeroed by the caller.
extern "C" int ad_count(const unsigned* words, int banks, int nw, int* counts,
                        cudaStream_t s) {
  int g = blocks(nw, 256);
  if (g > 64) g = 64;
  dim3 grid(g, banks);
  k_count<<<grid, 256, 0, s>>>(words, nw, counts);
  return (int)cudaGetLastError();
}
