// Redwood-class storage engine: a copy-on-write page B+tree.
//
// Reference: fdbserver/VersionedBTree.actor.cpp (Redwood) — the
// reference's current-generation ssd engine is a paged, checksummed,
// copy-on-write B+tree with a two-generation freelist and atomic root
// flips. This is the same architecture at sim scale, NOT a translation:
// one C++ file, a batch-apply recursive COW rebuild instead of actor
// pipelines, and the MVCC window stays in the storage server's memory
// (runtime/storage.py) exactly as with the sqlite engine — this engine
// persists the consistent prefix (runtime/kvstore.py contract: flush /
// durable_version / load).
//
// Crash model (what the design guarantees):
// - All NEW pages of a flush are written and fsync'd BEFORE the meta
//   page that references them; the meta (with checksum + seq) is then
//   written to the ALTERNATE slot and fsync'd. A crash at any point
//   leaves at least one valid meta whose every reachable page was
//   durable when that meta committed — torn in-flight pages are simply
//   unreachable. Open picks the valid meta with the higher seq.
// - Pages freed by commit N (replaced COW paths, deleted overflow
//   chains) are PENDING until commit N+1: while meta(N-1) is still the
//   fallback, its pages must not be overwritten. At commit N+1 the
//   pending set joins the free list. (Redwood's lazy-delete queue has
//   the same one-generation delay for the same reason.)
//
// Layout: 16 KiB pages. Page 0/1 = meta slots. Data pages start at 2.
//   meta:     {magic, seq, root, page_count, durable_version,
//              free_head, pending_head, checksum}
//   leaf:     {type=1, n} then n cells
//             cell: klen u32 | flags u8 | vlen u32 | key | (value |
//                   overflow_head u64)
//   internal: {type=2, n} then n entries: klen u32 | child u64 | key
//             entry i's key is the SMALLEST key of child i; entry 0's
//             key is empty.
//   freelist: {type=3, n, next} then n u64 page ids
//   overflow: {type=4, used, next} then `used` value bytes
//
// Values larger than INLINE_MAX spill to an overflow chain; keys (<=
// 10 KB by the client limit) always fit a 16 KiB page inline.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <map>
#include <string>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

constexpr uint64_t MAGIC = 0x52574254504642ULL;  // "RWBTPFB"
constexpr uint32_t PAGE = 16384;
constexpr uint32_t INLINE_MAX = 4096;  // larger values go to overflow pages
constexpr uint8_t LEAF = 1, INTERNAL = 2, FREEPAGE = 3, OVERFLOW_PAGE = 4;
constexpr uint8_t F_OVERFLOW = 1;

struct Meta {
  uint64_t magic;
  uint64_t seq;
  uint64_t root;        // 0 = empty tree
  uint64_t page_count;  // next fresh page id
  int64_t durable_version;
  uint64_t free_head;     // SPILL chain for free ids beyond the inline cap
  uint64_t pending_head;  // SPILL chain for pending ids beyond the cap
  uint32_t free_inline;     // ids stored inline in the meta page
  uint32_t pending_inline;  //   (free first, then pending)
  uint64_t checksum;  // fnv1a over the whole used meta region, field 0
};

// Inline freelist capacity: the meta page itself carries the free and
// pending ids in the common case, so steady-state commits write ZERO
// extra freelist pages (a naive chain-page-per-commit design grew the
// file 2 pages per commit forever — measured). Spill chains only appear
// under huge churn (a giant clear_range), and their pages recycle too.
constexpr size_t META_IDS_CAP = (PAGE - sizeof(Meta)) / 8;

uint64_t fnv1a(const uint8_t* p, size_t n) {
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < n; i++) {
    h ^= p[i];
    h *= 1099511628211ULL;
  }
  return h;
}

struct Store {
  int fd = -1;
  Meta meta{};
  std::vector<uint64_t> meta_ids;  // inline free+pending ids of `meta`
  // Commit-scoped state:
  std::vector<uint64_t> free_now;   // allocatable this commit
  std::vector<uint64_t> freed;      // freed this commit -> pending
  uint64_t next_page = 2;
  // Sticky IO/corruption flag for the current operation: every writer
  // and the apply-path readers set it on failure, and rw_flush refuses
  // to flip the meta when it is set (review finding: a short pwrite —
  // ENOSPC — previously still committed a root referencing the missing
  // page, silently corrupting the durable snapshot).
  mutable bool io_error = false;

  bool read_page(uint64_t id, uint8_t* buf) const {
    if (::pread(fd, buf, PAGE, off_t(id) * PAGE) == ssize_t(PAGE))
      return true;
    io_error = true;
    return false;
  }
  bool write_page(uint64_t id, const uint8_t* buf) const {
    if (::pwrite(fd, buf, PAGE, off_t(id) * PAGE) == ssize_t(PAGE))
      return true;
    io_error = true;
    return false;
  }
  uint64_t alloc() {
    if (!free_now.empty()) {
      uint64_t id = free_now.back();
      free_now.pop_back();
      return id;
    }
    return next_page++;
  }
  void free_page(uint64_t id) { freed.push_back(id); }
};

// -- little struct readers/writers on page buffers ---------------------------

struct W {
  uint8_t* p;
  size_t pos = 0;
  void u8(uint8_t v) { p[pos++] = v; }
  void u32(uint32_t v) { memcpy(p + pos, &v, 4); pos += 4; }
  void u64(uint64_t v) { memcpy(p + pos, &v, 8); pos += 8; }
  void bytes(const uint8_t* b, size_t n) { memcpy(p + pos, b, n); pos += n; }
};

struct R {
  const uint8_t* p;
  size_t pos = 0;
  uint8_t u8() { return p[pos++]; }
  uint32_t u32() { uint32_t v; memcpy(&v, p + pos, 4); pos += 4; return v; }
  uint64_t u64() { uint64_t v; memcpy(&v, p + pos, 8); pos += 8; return v; }
};

using Key = std::string;

struct LeafCell {
  Key key;
  std::string value;      // inline value, or empty when overflow
  uint64_t overflow = 0;  // overflow chain head (flags & F_OVERFLOW)
  uint64_t vlen = 0;      // total value length (overflow case)
};

struct Entry {  // internal-node entry
  Key min_key;
  uint64_t child;
};

size_t leaf_cell_size(const LeafCell& c) {
  size_t inline_v = c.overflow ? 8 : c.value.size();
  return 4 + 1 + 4 + c.key.size() + inline_v;
}

size_t entry_size(const Entry& e) { return 4 + 8 + e.min_key.size(); }

constexpr size_t HDR = 1 + 4;  // type + count

// -- page codecs -------------------------------------------------------------

void write_leaf(Store& s, uint64_t id, const std::vector<LeafCell>& cells) {
  std::vector<uint8_t> buf(PAGE, 0);
  W w{buf.data()};
  w.u8(LEAF);
  w.u32(uint32_t(cells.size()));
  for (const auto& c : cells) {
    w.u32(uint32_t(c.key.size()));
    w.u8(c.overflow ? F_OVERFLOW : 0);
    w.u32(uint32_t(c.overflow ? c.vlen : c.value.size()));
    w.bytes(reinterpret_cast<const uint8_t*>(c.key.data()), c.key.size());
    if (c.overflow) {
      w.u64(c.overflow);
    } else {
      w.bytes(reinterpret_cast<const uint8_t*>(c.value.data()),
              c.value.size());
    }
  }
  s.write_page(id, buf.data());
}

bool read_leaf(const Store& s, uint64_t id, std::vector<LeafCell>& out) {
  std::vector<uint8_t> buf(PAGE);
  if (!s.read_page(id, buf.data())) return false;
  R r{buf.data()};
  if (r.u8() != LEAF) return false;
  uint32_t n = r.u32();
  out.clear();
  out.reserve(n);
  for (uint32_t i = 0; i < n; i++) {
    LeafCell c;
    uint32_t klen = r.u32();
    uint8_t flags = r.u8();
    uint32_t vlen = r.u32();
    c.key.assign(reinterpret_cast<const char*>(buf.data() + r.pos), klen);
    r.pos += klen;
    if (flags & F_OVERFLOW) {
      c.overflow = r.u64();
      c.vlen = vlen;
    } else {
      c.value.assign(reinterpret_cast<const char*>(buf.data() + r.pos), vlen);
      r.pos += vlen;
    }
    out.push_back(std::move(c));
  }
  return true;
}

void write_internal(Store& s, uint64_t id, const std::vector<Entry>& es) {
  std::vector<uint8_t> buf(PAGE, 0);
  W w{buf.data()};
  w.u8(INTERNAL);
  w.u32(uint32_t(es.size()));
  for (const auto& e : es) {
    w.u32(uint32_t(e.min_key.size()));
    w.u64(e.child);
    w.bytes(reinterpret_cast<const uint8_t*>(e.min_key.data()),
            e.min_key.size());
  }
  s.write_page(id, buf.data());
}

uint8_t page_type(const Store& s, uint64_t id) {
  uint8_t b;
  if (::pread(s.fd, &b, 1, off_t(id) * PAGE) != 1) {
    s.io_error = true;  // unknown subtree must fail the op, not vanish
    return 0;
  }
  return b;
}

bool read_internal(const Store& s, uint64_t id, std::vector<Entry>& out) {
  std::vector<uint8_t> buf(PAGE);
  if (!s.read_page(id, buf.data())) return false;
  R r{buf.data()};
  if (r.u8() != INTERNAL) return false;
  uint32_t n = r.u32();
  out.clear();
  out.reserve(n);
  for (uint32_t i = 0; i < n; i++) {
    Entry e;
    uint32_t klen = r.u32();
    e.child = r.u64();
    e.min_key.assign(reinterpret_cast<const char*>(buf.data() + r.pos), klen);
    r.pos += klen;
    out.push_back(std::move(e));
  }
  return true;
}

// -- overflow chains ---------------------------------------------------------

uint64_t write_overflow(Store& s, const std::string& v) {
  constexpr size_t CAP = PAGE - (1 + 4 + 8);
  uint64_t head = 0, prev = 0;
  std::vector<uint8_t> buf;
  for (size_t off = 0; off < v.size() || off == 0; off += CAP) {
    size_t n = std::min(CAP, v.size() - off);
    uint64_t id = s.alloc();
    buf.assign(PAGE, 0);
    W w{buf.data()};
    w.u8(OVERFLOW_PAGE);
    w.u32(uint32_t(n));
    w.u64(0);  // next — patched below
    w.bytes(reinterpret_cast<const uint8_t*>(v.data()) + off, n);
    s.write_page(id, buf.data());
    if (prev) {  // patch prev.next
      std::vector<uint8_t> pb(PAGE);
      s.read_page(prev, pb.data());
      memcpy(pb.data() + 1 + 4, &id, 8);
      s.write_page(prev, pb.data());
    } else {
      head = id;
    }
    prev = id;
    if (v.size() == 0) break;
  }
  return head;
}

bool read_overflow(const Store& s, uint64_t head, uint64_t vlen,
                   std::string& out) {
  out.clear();
  out.reserve(vlen);
  std::vector<uint8_t> buf(PAGE);
  for (uint64_t id = head; id;) {
    if (!s.read_page(id, buf.data())) return false;
    R r{buf.data()};
    if (r.u8() != OVERFLOW_PAGE) return false;
    uint32_t n = r.u32();
    uint64_t next = r.u64();
    out.append(reinterpret_cast<const char*>(buf.data() + r.pos), n);
    id = next;
  }
  return out.size() == vlen;
}

void free_overflow(Store& s, uint64_t head) {
  std::vector<uint8_t> buf(PAGE);
  for (uint64_t id = head; id;) {
    if (!s.read_page(id, buf.data())) return;
    uint64_t next;
    memcpy(&next, buf.data() + 1 + 4, 8);
    s.free_page(id);
    id = next;
  }
}

// -- freelist chains ---------------------------------------------------------

uint64_t write_free_chain(Store& s, const std::vector<uint64_t>& ids) {
  // Chain pages are allocated FRESH (never from the pages being freed —
  // those may still be referenced by the fallback meta).
  if (ids.empty()) return 0;
  constexpr size_t CAP = (PAGE - (1 + 4 + 8)) / 8;
  uint64_t head = 0;
  std::vector<uint8_t> buf;
  for (size_t off = 0; off < ids.size(); off += CAP) {
    size_t n = std::min(CAP, ids.size() - off);
    uint64_t id = s.next_page++;  // always fresh
    buf.assign(PAGE, 0);
    W w{buf.data()};
    w.u8(FREEPAGE);
    w.u32(uint32_t(n));
    w.u64(head);  // prepend
    for (size_t i = 0; i < n; i++) w.u64(ids[off + i]);
    s.write_page(id, buf.data());
    head = id;
  }
  return head;
}

bool read_free_chain(const Store& s, uint64_t head,
                     std::vector<uint64_t>& out_ids,
                     std::vector<uint64_t>& out_chain_pages) {
  // The ids INSIDE a chain are allocatable by the caller's rules; the
  // chain PAGES themselves were freshly written by the commit that
  // created the chain and stay reachable from that commit's meta — they
  // are only reusable one commit LATER (callers route them to pending).
  std::vector<uint8_t> buf(PAGE);
  for (uint64_t id = head; id;) {
    if (!s.read_page(id, buf.data())) return false;
    R r{buf.data()};
    if (r.u8() != FREEPAGE) return false;
    uint32_t n = r.u32();
    uint64_t next = r.u64();
    for (uint32_t i = 0; i < n; i++) out_ids.push_back(r.u64());
    out_chain_pages.push_back(id);
    id = next;
  }
  return true;
}

// -- batch ops ---------------------------------------------------------------

struct Op {          // one mutation in a flush batch
  Key key;           // point write (set or tombstone)
  std::string value;
  bool tombstone;
};

struct FlushBatch {
  std::vector<Op> ops;                    // sorted by key
  std::vector<std::pair<Key, Key>> purges;  // sorted [begin, end)
};

void coalesce_purges(std::vector<std::pair<Key, Key>>& purges) {
  // Overlapping/adjacent purges merge so the binary-search membership
  // test below (which only inspects the last range with begin <= k) is
  // exact. The storage server legitimately batches overlapping purges
  // (a moved-away range plus single-key residue purges inside it —
  // review finding: testing only the nearest begin let keys inside a
  // WIDER earlier range survive a clear).
  std::sort(purges.begin(), purges.end());
  std::vector<std::pair<Key, Key>> out;
  for (auto& p : purges) {
    if (p.first >= p.second) continue;  // empty
    if (!out.empty() && p.first <= out.back().second) {
      if (p.second > out.back().second) out.back().second = p.second;
    } else {
      out.push_back(std::move(p));
    }
  }
  purges = std::move(out);
}

bool in_purge(const FlushBatch& b, const Key& k) {
  // purges sorted, coalesced, disjoint: the last with begin <= k decides.
  auto it = std::upper_bound(
      b.purges.begin(), b.purges.end(), k,
      [](const Key& key, const std::pair<Key, Key>& p) {
        return key < p.first;
      });
  if (it == b.purges.begin()) return false;
  --it;
  return k >= it->first && k < it->second;
}

void build_leaves(Store& s, std::vector<LeafCell>& cells,
                  std::vector<Entry>& out) {
  // Pack cells into as few leaves as fit; split points keep every page
  // under PAGE bytes.
  size_t i = 0;
  while (i < cells.size()) {
    size_t used = HDR, j = i;
    std::vector<LeafCell> page;
    while (j < cells.size() && used + leaf_cell_size(cells[j]) <= PAGE) {
      used += leaf_cell_size(cells[j]);
      page.push_back(std::move(cells[j]));
      j++;
    }
    if (page.empty()) {  // oversized cell (guarded at rw_flush; backstop)
      s.io_error = true;
      return;
    }
    uint64_t id = s.alloc();
    Entry e;
    e.min_key = page.front().key;
    e.child = id;
    write_leaf(s, id, page);
    out.push_back(std::move(e));
    i = j;
  }
}

void build_internals(Store& s, std::vector<Entry>& level,
                     std::vector<Entry>& out) {
  size_t i = 0;
  while (i < level.size()) {
    size_t used = HDR, j = i;
    std::vector<Entry> page;
    while (j < level.size() && used + entry_size(level[j]) <= PAGE) {
      used += entry_size(level[j]);
      page.push_back(std::move(level[j]));
      j++;
    }
    uint64_t id = s.alloc();
    Entry e;
    e.min_key = page.front().min_key;
    e.child = id;
    write_internal(s, id, page);
    out.push_back(std::move(e));
    i = j;
  }
}

void free_subtree(Store& s, uint64_t id) {
  uint8_t t = page_type(s, id);
  if (t == INTERNAL) {
    std::vector<Entry> es;
    if (read_internal(s, id, es))
      for (const auto& e : es) free_subtree(s, e.child);
  } else if (t == LEAF) {
    std::vector<LeafCell> cells;
    if (read_leaf(s, id, cells))
      for (const auto& c : cells)
        if (c.overflow) free_overflow(s, c.overflow);
  }
  s.free_page(id);
}

LeafCell make_cell(Store& s, const Key& k, const std::string& v) {
  LeafCell c;
  c.key = k;
  if (v.size() > INLINE_MAX) {
    c.vlen = v.size();
    c.overflow = write_overflow(s, v);
  } else {
    c.value = v;
  }
  return c;
}

// Recursive COW rebuild: apply ops/purges falling in [lo, hi) (hi empty
// = +inf) to the subtree at `id`; emit replacement entries. The old page
// is always freed (its replacement is freshly written).
void apply_rec(Store& s, uint64_t id, const FlushBatch& b,
               size_t op_lo, size_t op_hi, std::vector<Entry>& out) {
  uint8_t t = page_type(s, id);
  if (t == LEAF) {
    std::vector<LeafCell> cells;
    read_leaf(s, id, cells);
    std::vector<LeafCell> merged;
    merged.reserve(cells.size() + (op_hi - op_lo));
    size_t oi = op_lo;
    auto emit_op = [&](size_t k) {
      // Same-flush semantics match the sqlite engine: purges apply
      // FIRST, point writes second — a write inside a purged range
      // survives (kvstore.flush applies them in that order in one txn).
      const Op& op = b.ops[k];
      if (!op.tombstone) merged.push_back(make_cell(s, op.key, op.value));
    };
    for (auto& c : cells) {
      while (oi < op_hi && b.ops[oi].key < c.key) emit_op(oi++);
      bool replaced = oi < op_hi && b.ops[oi].key == c.key;
      if (replaced || in_purge(b, c.key)) {
        if (c.overflow) free_overflow(s, c.overflow);
        if (replaced) emit_op(oi++);
      } else {
        merged.push_back(std::move(c));
      }
    }
    while (oi < op_hi) emit_op(oi++);
    s.free_page(id);
    if (!merged.empty()) build_leaves(s, merged, out);
    return;
  }
  if (t != INTERNAL) return;  // corrupt/unexpected: drop (unreachable)
  std::vector<Entry> es;
  read_internal(s, id, es);
  s.free_page(id);
  std::vector<Entry> children;
  for (size_t ci = 0; ci < es.size(); ci++) {
    const Key& lo = es[ci].min_key;  // child's smallest CONTENT key
    const Key* hi = (ci + 1 < es.size()) ? &es[ci + 1].min_key : nullptr;
    // Ops for this child: everything up to the NEXT child's separator.
    // The leftmost child absorbs ops below its own min_key too — keys
    // smaller than any existing content still belong to its range
    // (skipping them would silently drop writes).
    size_t a = op_lo, z = op_hi;
    size_t e2 = a;
    while (e2 < z && (hi == nullptr || b.ops[e2].key < *hi)) e2++;
    // Whole child inside one purge and no point ops -> free the subtree.
    bool covered = false;
    if (a == e2 && hi != nullptr) {
      for (const auto& pr : b.purges)
        if (pr.first <= lo && *hi <= pr.second) { covered = true; break; }
    }
    if (covered) {
      free_subtree(s, es[ci].child);
    } else if (a == e2 && b.purges.empty()) {
      children.push_back(std::move(es[ci]));  // untouched subtree
    } else if (a == e2) {
      // No point ops, but purges may intersect: check overlap cheaply.
      bool overlap = false;
      for (const auto& pr : b.purges) {
        if (hi != nullptr && pr.first >= *hi) continue;
        if (pr.second <= lo) continue;
        overlap = true;
        break;
      }
      if (overlap) {
        apply_rec(s, es[ci].child, b, a, e2, children);
      } else {
        children.push_back(std::move(es[ci]));
      }
    } else {
      apply_rec(s, es[ci].child, b, a, e2, children);
    }
    op_lo = e2;
  }
  if (!children.empty()) {
    // Repack the children into internal pages.
    build_internals(s, children, out);
  }
}

void scan_rec(const Store& s, uint64_t id,
              void (*cb)(const uint8_t*, uint64_t, const uint8_t*, uint64_t,
                         void*),
              void* ctx) {
  // Any unreadable/corrupt page marks io_error (a silent skip would
  // hand the storage server an INCOMPLETE snapshot at full
  // durable_version — permanent, invisible data loss; review finding).
  uint8_t t = page_type(s, id);
  if (t == LEAF) {
    std::vector<LeafCell> cells;
    if (!read_leaf(s, id, cells)) {
      s.io_error = true;
      return;
    }
    std::string big;
    for (const auto& c : cells) {
      const std::string* v = &c.value;
      if (c.overflow) {
        if (!read_overflow(s, c.overflow, c.vlen, big)) {
          s.io_error = true;
          continue;  // never emit a partial value
        }
        v = &big;
      }
      cb(reinterpret_cast<const uint8_t*>(c.key.data()), c.key.size(),
         reinterpret_cast<const uint8_t*>(v->data()), v->size(), ctx);
    }
  } else if (t == INTERNAL) {
    std::vector<Entry> es;
    if (!read_internal(s, id, es)) {
      s.io_error = true;
      return;
    }
    for (const auto& e : es) scan_rec(s, e.child, cb, ctx);
  } else {
    s.io_error = true;  // tree pointer at a non-tree page
  }
}

bool parse_meta_page(const uint8_t* buf, Meta& m,
                     std::vector<uint64_t>& ids) {
  memcpy(&m, buf, sizeof(Meta));
  if (m.magic != MAGIC) return false;
  size_t n = size_t(m.free_inline) + size_t(m.pending_inline);
  if (n > META_IDS_CAP) return false;
  size_t used = sizeof(Meta) + n * 8;
  std::vector<uint8_t> copy(buf, buf + used);
  memset(copy.data() + offsetof(Meta, checksum), 0, 8);
  if (fnv1a(copy.data(), used) != m.checksum) return false;
  ids.assign(n, 0);
  memcpy(ids.data(), buf + sizeof(Meta), n * 8);
  return true;
}

bool load_meta(Store& s) {
  Meta a{}, b{};
  std::vector<uint64_t> ia, ib;
  bool va = false, vb = false;
  std::vector<uint8_t> buf(PAGE);
  if (s.read_page(0, buf.data())) va = parse_meta_page(buf.data(), a, ia);
  if (s.read_page(1, buf.data())) vb = parse_meta_page(buf.data(), b, ib);
  if (!va && !vb) return false;
  if (!vb || (va && a.seq >= b.seq)) {
    s.meta = a;
    s.meta_ids = std::move(ia);
  } else {
    s.meta = b;
    s.meta_ids = std::move(ib);
  }
  return true;
}

void write_meta(Store& s) {
  size_t n = size_t(s.meta.free_inline) + size_t(s.meta.pending_inline);
  size_t used = sizeof(Meta) + n * 8;
  std::vector<uint8_t> buf(PAGE, 0);
  s.meta.checksum = 0;
  memcpy(buf.data(), &s.meta, sizeof(Meta));
  memcpy(buf.data() + sizeof(Meta), s.meta_ids.data(), n * 8);
  uint64_t ck = fnv1a(buf.data(), used);
  s.meta.checksum = ck;
  memcpy(buf.data() + offsetof(Meta, checksum), &ck, 8);
  s.write_page(s.meta.seq % 2, buf.data());  // alternate slots by seq
}

}  // namespace

extern "C" {

void* rw_open(const char* path) {
  int fd = ::open(path, O_RDWR | O_CREAT, 0644);
  if (fd < 0) return nullptr;
  Store* s = new Store();
  s->fd = fd;
  struct stat st{};
  fstat(fd, &st);
  if (st.st_size >= off_t(2 * PAGE) && load_meta(*s)) {
    s->next_page = s->meta.page_count;
  } else if (st.st_size > off_t(2 * PAGE)) {
    // A file with DATA pages but no valid meta is corruption: refuse
    // rather than silently reinitialize over someone's data (review
    // finding). A file at/below 2 pages never held data (data starts at
    // page 2) — a torn fresh init — and is safely re-initialized below.
    ::close(fd);
    delete s;
    return nullptr;
  } else {
    // Fresh file: seq 0 so the first commit writes slot 1... write both
    // slots so torn half-created files never parse.
    s->meta = Meta{MAGIC, 0, 0, 2, 0, 0, 0, 0};
    s->next_page = 2;
    write_meta(*s);
    s->meta.seq = 1;
    write_meta(*s);
    s->meta.seq = 0;
    ::fsync(fd);
  }
  return s;
}

int64_t rw_durable_version(void* h) {
  return static_cast<Store*>(h)->meta.durable_version;
}

// One atomic flush. Arrays: n point writes (key blob + offsets, value
// blob + offsets; vlen<0 via tomb[i]!=0 = tombstone), m purges (begin/
// end blob + offsets). Returns 0 on success.
int64_t rw_flush(void* h, int64_t n, const uint8_t* kblob,
                 const int64_t* koff, const uint8_t* vblob,
                 const int64_t* voff, const uint8_t* tomb, int64_t m,
                 const uint8_t* pbblob, const int64_t* pboff,
                 const uint8_t* peblob, const int64_t* peoff,
                 int64_t version) {
  Store& s = *static_cast<Store*>(h);
  s.io_error = false;
  // Largest key whose leaf cell (overflow form) still fits a page: a
  // bigger one would make build_leaves spin forever (review finding) —
  // refuse it up front. (Client limit is 10 KB; this is the backstop.)
  const size_t MAX_KEY_BYTES = PAGE - HDR - (4 + 1 + 4 + 8);
  FlushBatch b;
  b.ops.reserve(n);
  for (int64_t i = 0; i < n; i++) {
    Op op;
    op.key.assign(reinterpret_cast<const char*>(kblob + koff[i]),
                  size_t(koff[i + 1] - koff[i]));
    if (op.key.size() > MAX_KEY_BYTES) return -3;
    op.tombstone = tomb[i] != 0;
    if (!op.tombstone)
      op.value.assign(reinterpret_cast<const char*>(vblob + voff[i]),
                      size_t(voff[i + 1] - voff[i]));
    b.ops.push_back(std::move(op));
  }
  std::sort(b.ops.begin(), b.ops.end(),
            [](const Op& a, const Op& c) { return a.key < c.key; });
  for (int64_t i = 0; i < m; i++) {
    b.purges.emplace_back(
        Key(reinterpret_cast<const char*>(pbblob + pboff[i]),
            size_t(pboff[i + 1] - pboff[i])),
        Key(reinterpret_cast<const char*>(peblob + peoff[i]),
            size_t(peoff[i + 1] - peoff[i])));
  }
  coalesce_purges(b.purges);

  if (b.ops.empty() && b.purges.empty()) {
    // Durability-marker-only flush (the storage server's periodic
    // flusher with a clean dirty set): bump the version without
    // COW-rewriting the root (review finding). The freelist carries
    // over unchanged — rotation resumes with the next real commit.
    s.meta.seq += 1;
    s.meta.durable_version = version;
    write_meta(s);
    if (s.io_error || ::fsync(s.fd) != 0) return -1;
    return 0;
  }

  // The pages freed by the LAST commit (pending) become allocatable now
  // (both meta slots are at-or-past that commit); this commit's frees
  // go to pending. Ids live inline in the meta page (free first, then
  // pending); overflow SPILL chain pages are reachable from the
  // fallback meta, so they join pending, never free_now (overwriting
  // one and crashing would corrupt the fallback's freelist, whose
  // stale ids could point at live pages).
  s.free_now.clear();
  s.freed.clear();
  s.free_now.assign(s.meta_ids.begin(), s.meta_ids.end());
  std::vector<uint64_t> chain_pages;
  if (!read_free_chain(s, s.meta.free_head, s.free_now, chain_pages) ||
      !read_free_chain(s, s.meta.pending_head, s.free_now, chain_pages)) {
    return -2;  // corrupt freelist: refuse to guess (fail the flush)
  }
  for (uint64_t id : chain_pages) s.freed.push_back(id);

  std::vector<Entry> roots;
  if (s.meta.root != 0) {
    apply_rec(s, s.meta.root, b, 0, b.ops.size(), roots);
  } else {
    std::vector<LeafCell> cells;
    for (const auto& op : b.ops)
      if (!op.tombstone) cells.push_back(make_cell(s, op.key, op.value));
    if (!cells.empty()) build_leaves(s, cells, roots);
  }
  while (roots.size() > 1) {
    std::vector<Entry> up;
    build_internals(s, roots, up);
    roots = std::move(up);
  }
  uint64_t new_root = roots.empty() ? 0 : roots[0].child;

  // Freelist persistence: inline as much as fits in the meta page
  // (free ids first, pending after); spill only the excess to chains.
  size_t cap = META_IDS_CAP;
  size_t fi = std::min(s.free_now.size(), cap);
  size_t pi = std::min(s.freed.size(), cap - fi);
  std::vector<uint64_t> spill_free(s.free_now.begin() + fi,
                                   s.free_now.end());
  std::vector<uint64_t> spill_pend(s.freed.begin() + pi, s.freed.end());
  uint64_t free_head = write_free_chain(s, spill_free);
  uint64_t pending = write_free_chain(s, spill_pend);
  s.meta_ids.assign(s.free_now.begin(), s.free_now.begin() + fi);
  s.meta_ids.insert(s.meta_ids.end(), s.freed.begin(), s.freed.begin() + pi);

  // Gate: NO meta flip when anything failed to read or write — the old
  // meta (complete snapshot) stays authoritative and the caller sees
  // the error instead of silent corruption.
  if (s.io_error || ::fsync(s.fd) != 0) return -1;
  s.meta.seq += 1;
  s.meta.root = new_root;
  s.meta.page_count = s.next_page;
  s.meta.durable_version = version;
  s.meta.free_head = free_head;
  s.meta.pending_head = pending;
  s.meta.free_inline = uint32_t(fi);
  s.meta.pending_inline = uint32_t(pi);
  write_meta(s);
  if (s.io_error || ::fsync(s.fd) != 0) return -1;
  return 0;
}

// Full ordered scan via callback (load path). Returns 0, or -1 when any
// page failed to read/parse — the snapshot handed back is incomplete
// and the caller must treat the store as corrupt, not as small.
int64_t rw_scan(void* h,
                void (*cb)(const uint8_t*, uint64_t, const uint8_t*,
                           uint64_t, void*),
                void* ctx) {
  Store& s = *static_cast<Store*>(h);
  s.io_error = false;
  if (s.meta.root) scan_rec(s, s.meta.root, cb, ctx);
  return s.io_error ? -1 : 0;
}

int64_t rw_page_count(void* h) {
  return int64_t(static_cast<Store*>(h)->meta.page_count);
}

void rw_close(void* h) {
  Store* s = static_cast<Store*>(h);
  if (s->fd >= 0) ::close(s->fd);
  delete s;
}

}  // extern "C"
