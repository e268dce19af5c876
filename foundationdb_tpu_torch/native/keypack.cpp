// Resolver wire format -> padded batch arrays, for foundationdb_tpu_torch.
//
// The port's own copy of the repository's batch packer (kp_pack_batch,
// kp_count_txns and the fused window packer kp_pack_window of the
// speculative non-resident engine). The reference resolver receives
// ResolveTransactionBatchRequest as flat serialized bytes and walks them in
// C++ (fdbserver/Resolver.actor.cpp + ConflictSet.h
// ConflictBatch::addTransaction). Here one C pass over the batch blob emits
// the padded int32 key arrays that TorchConflictSet ranks against its
// dictionary mirror and uploads, so the Python runtime never touches
// per-transaction objects on the hot path.
//
// Wire format (little-endian, packed tight):
//   per txn:
//     int64  read_version (absolute)
//     int32  n_reads
//     int32  n_writes
//     then n_reads + n_writes ranges (reads first):
//       int32 begin_len, int32 end_len, begin bytes, end bytes
//
// Key packing must match core/keypack.py KeyCodec bit-for-bit: big-endian
// bytes into int32 words, XOR 0x80000000 bias, trailing length column;
// overlong begins truncate down, overlong ends round up to the prefix
// successor (all-0xff prefix -> +inf sentinel). Range-count overflow
// coalesces exactly like models/conflict_set.py _coalesce: stable-sort by
// begin, cover ceil(n/limit)-sized groups.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr int32_t INT32_MAX_V = 0x7fffffff;
constexpr int MAX_KEY_BYTES = 256;  // packer scratch bound (codec max)

struct RangeView {
  const uint8_t* b;
  int32_t bl;
  const uint8_t* e;
  int32_t el;
};

int bytecmp(const uint8_t* a, int la, const uint8_t* b, int lb) {
  int n = la < lb ? la : lb;
  int c = std::memcmp(a, b, n);
  if (c) return c;
  return la - lb;
}

// Pack one key into out[0..n_words]: words + length column.
void pack_key(const uint8_t* k, int len, int n_words, bool end_mode,
              int32_t* out) {
  uint8_t tmp[MAX_KEY_BYTES];
  const int maxb = 4 * n_words;
  if (len > maxb) {
    if (end_mode) {
      // Successor of the truncated prefix: drop trailing 0xff, bump last.
      std::memcpy(tmp, k, maxb);
      int i = maxb - 1;
      while (i >= 0 && tmp[i] == 0xff) --i;
      if (i < 0) {  // all-0xff prefix: no successor -> +inf sentinel
        for (int w = 0; w <= n_words; ++w) out[w] = INT32_MAX_V;
        return;
      }
      ++tmp[i];
      len = i + 1;
      k = tmp;
    } else {
      len = maxb;  // begins truncate down
    }
  }
  for (int w = 0; w < n_words; ++w) {
    uint32_t word = 0;
    for (int b = 0; b < 4; ++b) {
      const int idx = 4 * w + b;
      word = (word << 8) | (idx < len ? k[idx] : 0u);
    }
    out[w] = static_cast<int32_t>(word ^ 0x80000000u);
  }
  out[n_words] = len;
}

// Emit up to `limit` slots for `ranges` into row-major [limit, W] tensors,
// mirroring _coalesce: empties dropped; if still over limit, stable-sort by
// begin and cover even groups (group begin, max group end).
void emit_ranges(std::vector<RangeView>& live, int limit, int n_words,
                 int32_t* begin_out, int32_t* end_out, uint8_t* mask_out) {
  const int w = n_words + 1;
  if (static_cast<int>(live.size()) <= limit) {
    for (size_t c = 0; c < live.size(); ++c) {
      pack_key(live[c].b, live[c].bl, n_words, false, begin_out + c * w);
      pack_key(live[c].e, live[c].el, n_words, true, end_out + c * w);
      mask_out[c] = 1;
    }
    return;
  }
  std::stable_sort(live.begin(), live.end(),
                   [](const RangeView& x, const RangeView& y) {
                     return bytecmp(x.b, x.bl, y.b, y.bl) < 0;
                   });
  const int n = static_cast<int>(live.size());
  const int step = (n + limit - 1) / limit;
  int c = 0;
  for (int i = 0; i < n; i += step, ++c) {
    const int hi = std::min(i + step, n);
    const RangeView* best = &live[i];
    for (int j = i + 1; j < hi; ++j)
      if (bytecmp(live[j].e, live[j].el, best->e, best->el) > 0)
        best = &live[j];
    pack_key(live[i].b, live[i].bl, n_words, false, begin_out + c * w);
    pack_key(best->e, best->el, n_words, true, end_out + c * w);
    mask_out[c] = 1;
  }
}

}  // namespace

extern "C" {

// Walks `count` transactions starting at byte `offset`; fills the padded
// batch tensors (callers pass zero/INT32_MAX-prefilled arrays of shape
// B x R x W / B x Q x W / B x R / B x Q / B). Returns the wire offset just
// past the last consumed transaction, or -1 on malformed input / overrun.
int64_t kp_pack_batch(
    const uint8_t* wire, int64_t wire_len, int64_t offset, int count,
    int b_cap, int r_cap, int q_cap, int n_words, int64_t base_version,
    int32_t* read_begin, int32_t* read_end, uint8_t* read_mask,
    int32_t* write_begin, int32_t* write_end, uint8_t* write_mask,
    int32_t* read_version, uint8_t* txn_mask) {
  const int w = n_words + 1;
  if (count > b_cap) return -1;
  // pack_key's truncation scratch is MAX_KEY_BYTES — a wider codec would
  // smash the stack on overlong wire keys. Reject the config, not the key.
  if (n_words <= 0 || 4 * n_words > MAX_KEY_BYTES) return -1;
  std::vector<RangeView> reads, writes;
  for (int t = 0; t < count; ++t) {
    if (offset + 16 > wire_len) return -1;
    int64_t rv;
    int32_t n_reads, n_writes;
    std::memcpy(&rv, wire + offset, 8);
    std::memcpy(&n_reads, wire + offset + 8, 4);
    std::memcpy(&n_writes, wire + offset + 12, 4);
    offset += 16;
    if (n_reads < 0 || n_writes < 0) return -1;
    // All arithmetic below in int64: hostile 32-bit counts/lengths must
    // not overflow int before the bounds checks run (this parser is the
    // RPC trust boundary).
    const int64_t n_ranges = static_cast<int64_t>(n_reads) + n_writes;

    reads.clear();
    writes.clear();
    for (int64_t i = 0; i < n_ranges; ++i) {
      if (offset + 8 > wire_len) return -1;
      int32_t bl, el;
      std::memcpy(&bl, wire + offset, 4);
      std::memcpy(&el, wire + offset + 4, 4);
      offset += 8;
      if (bl < 0 || el < 0 ||
          static_cast<int64_t>(bl) + el > wire_len - offset)
        return -1;
      RangeView v{wire + offset, bl, wire + offset + bl, el};
      offset += static_cast<int64_t>(bl) + el;
      if (bytecmp(v.b, v.bl, v.e, v.el) < 0)  // drop empty ranges
        (i < n_reads ? reads : writes).push_back(v);
    }

    // Relative read version, clamped like _rel_read (ancient readers -> -1,
    // strictly below every window floor -> TOO_OLD). A version beyond int32
    // is rejected: the Python object path raises on the same input, and a
    // silent wrap would turn a far-future reader into a recent one.
    const int64_t rel = rv - base_version;
    if (rel > 0x7fffffffLL) return -1;
    txn_mask[t] = 1;
    read_version[t] = static_cast<int32_t>(rel < -1 ? -1 : rel);
    emit_ranges(reads, r_cap, n_words, read_begin + t * r_cap * w,
                read_end + t * r_cap * w, read_mask + t * r_cap);
    emit_ranges(writes, q_cap, n_words, write_begin + t * q_cap * w,
                write_end + t * q_cap * w, write_mask + t * q_cap);
  }
  return offset;
}

// Fused window pack: k consecutive batches of `count` txns each, plus each
// batch's sorted-unique endpoint-key dictionary and per-slot ranks — the
// full host half of the packed window path (models/conflict_set.py
// pack_wire_window + _pack_dict) in one C pass, so packing window N+2 on
// the packer thread never stalls the device on window N+1 (the speculative
// pipeline's host half). Tensor arguments carry a [k] leading axis; callers
// prefill them exactly like kp_pack_batch's (masked slots all-INT32_MAX, so
// they dedup into the +inf dictionary row by construction). dict_keys is
// [k, n+1, W] for n = 2*B*(R+Q) input rows — the unique count can never
// reach n+1, so the +inf padding row the kernel parks masked slots on
// always survives. Rank order must match models/conflict_set.py
// pack_rank_dictionary bit-for-bit: rows compare lexicographically by
// SIGNED int32 words (the packing bias makes that equal to key byte order;
// the trailing length column is a small non-negative int in both).
// Returns the wire offset past the last batch, or -1 on malformed input.
int64_t kp_pack_window(
    const uint8_t* wire, int64_t wire_len, int64_t offset, int k, int count,
    int b_cap, int r_cap, int q_cap, int n_words, int64_t base_version,
    int32_t* read_begin, int32_t* read_end, uint8_t* read_mask,
    int32_t* write_begin, int32_t* write_end, uint8_t* write_mask,
    int32_t* read_version, uint8_t* txn_mask,
    int32_t* dict_keys, int32_t* rb_rank, int32_t* re_rank,
    int32_t* wb_rank, int32_t* we_rank) {
  const int w = n_words + 1;
  const int64_t nr = static_cast<int64_t>(b_cap) * r_cap;
  const int64_t nq = static_cast<int64_t>(b_cap) * q_cap;
  const int64_t n = 2 * (nr + nq);
  const int64_t pad_rows = n + 1;
  std::vector<int32_t> idx(n);
  std::vector<int32_t> rank_of(n);
  for (int i = 0; i < k; ++i) {
    int32_t* rb = read_begin + i * nr * w;
    int32_t* re = read_end + i * nr * w;
    int32_t* wb = write_begin + i * nq * w;
    int32_t* we = write_end + i * nq * w;
    offset = kp_pack_batch(wire, wire_len, offset, count, b_cap, r_cap,
                           q_cap, n_words, base_version, rb, re,
                           read_mask + i * nr, wb, we, write_mask + i * nq,
                           read_version + static_cast<int64_t>(i) * b_cap,
                           txn_mask + static_cast<int64_t>(i) * b_cap);
    if (offset < 0) return -1;
    // Flat dictionary-input row j, section order rb/re/wb/we (the order
    // _pack_dict concatenates — ranks scatter back by the same layout).
    auto row = [&](int64_t j) -> const int32_t* {
      if (j < nr) return rb + j * w;
      j -= nr;
      if (j < nr) return re + j * w;
      j -= nr;
      if (j < nq) return wb + j * w;
      return we + (j - nq) * w;
    };
    for (int64_t j = 0; j < n; ++j) idx[j] = static_cast<int32_t>(j);
    std::sort(idx.begin(), idx.end(), [&](int32_t a, int32_t b) {
      const int32_t* ra = row(a);
      const int32_t* rb2 = row(b);
      for (int c = 0; c < w; ++c)
        if (ra[c] != rb2[c]) return ra[c] < rb2[c];
      return false;
    });
    int32_t* dict = dict_keys + static_cast<int64_t>(i) * pad_rows * w;
    int32_t u = -1;
    const int32_t* prev = nullptr;
    for (int64_t s = 0; s < n; ++s) {
      const int32_t* r = row(idx[s]);
      if (!prev || std::memcmp(prev, r, w * 4) != 0) {
        ++u;
        std::memcpy(dict + static_cast<int64_t>(u) * w, r, w * 4);
        prev = dict + static_cast<int64_t>(u) * w;
      }
      rank_of[idx[s]] = u;
    }
    for (int64_t j = 0; j < nr; ++j) rb_rank[i * nr + j] = rank_of[j];
    for (int64_t j = 0; j < nr; ++j) re_rank[i * nr + j] = rank_of[nr + j];
    for (int64_t j = 0; j < nq; ++j) wb_rank[i * nq + j] = rank_of[2 * nr + j];
    for (int64_t j = 0; j < nq; ++j)
      we_rank[i * nq + j] = rank_of[2 * nr + nq + j];
  }
  return offset;
}

// Count (and structurally validate) the transactions in [offset, wire_len).
int64_t kp_count_txns(const uint8_t* wire, int64_t wire_len, int64_t offset) {
  int64_t n = 0;
  while (offset < wire_len) {
    if (offset + 16 > wire_len) return -1;
    int32_t n_reads, n_writes;
    std::memcpy(&n_reads, wire + offset + 8, 4);
    std::memcpy(&n_writes, wire + offset + 12, 4);
    offset += 16;
    if (n_reads < 0 || n_writes < 0) return -1;
    const int64_t n_ranges = static_cast<int64_t>(n_reads) + n_writes;
    for (int64_t i = 0; i < n_ranges; ++i) {
      if (offset + 8 > wire_len) return -1;
      int32_t bl, el;
      std::memcpy(&bl, wire + offset, 4);
      std::memcpy(&el, wire + offset + 4, 4);
      offset += 8;
      if (bl < 0 || el < 0 ||
          static_cast<int64_t>(bl) + el > wire_len - offset)
        return -1;
      offset += static_cast<int64_t>(bl) + el;
    }
    ++n;
  }
  return n;
}

}  // extern "C"
