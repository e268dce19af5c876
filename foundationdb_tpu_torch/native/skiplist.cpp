// CPU baseline ConflictSet: a randomized skiplist over keyspace boundaries.
//
// The port's own copy of the JAX package's CPU engine
// (foundationdb_tpu/native/skiplist.cpp), unchanged in code. It plays the
// role of the reference's fdbserver/SkipList.cpp (the SSE-tuned skiplist
// behind newConflictSet()): an ordered step function boundary-key ->
// last-write-version, with MVCC conflict checks and range paints.
// Semantics match foundationdb_tpu_torch/sim/oracle.py exactly; it is the
// "CPU SkipList" side of the bench's vs_baseline ratio
// (foundationdb_tpu_torch/bench.py --baseline).
//
// Batch semantics note: painting each accepted txn's writes at the batch
// commit version immediately makes the intra-batch read-vs-earlier-write
// rule fall out of the ordinary history check (cv > rv for every txn in the
// batch), so resolve is one sequential pass — exactly how the reference's
// ConflictBatch behaves observably.
//
// Built at first use by foundationdb_tpu_torch/native/__init__.py
// (g++ -O3 -std=c++17 -shared -fPIC -march=native) into native/_build/.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

namespace {

constexpr int kMaxLevel = 24;
constexpr int64_t kNegVersion = INT64_MIN;

struct Node {
  Node* next[kMaxLevel];  // only [0, level) valid
  int64_t version;        // version of segment [this->key, succ->key)
  int level;
  uint32_t keylen;
  // key bytes follow the struct
  const uint8_t* key() const {
    return reinterpret_cast<const uint8_t*>(this) + sizeof(Node);
  }
};

int cmp_keys(const uint8_t* a, uint32_t alen, const uint8_t* b, uint32_t blen) {
  uint32_t n = alen < blen ? alen : blen;
  int c = n ? std::memcmp(a, b, n) : 0;
  if (c) return c;
  return (alen > blen) - (alen < blen);
}

struct SkipListCS {
  Node* head;  // sentinel: the b"" boundary (version starts at kNegVersion)
  int level = 1;
  uint64_t rng = 0x9e3779b97f4a7c15ull;
  int64_t oldest = 0;
  size_t node_count = 1;
  size_t sweep_watermark = 64;
  std::vector<void*> arena_blocks;
  std::vector<Node*> free_lists[kMaxLevel + 1];

  SkipListCS() {
    head = alloc_node(kMaxLevel, nullptr, 0);
    head->version = kNegVersion;
    for (int i = 0; i < kMaxLevel; i++) head->next[i] = nullptr;
  }
  ~SkipListCS() {
    for (void* b : arena_blocks) std::free(b);
  }

  Node* alloc_node(int lvl, const uint8_t* key, uint32_t keylen) {
    // Reuse freed nodes of sufficient level and key capacity is fiddly;
    // keep it simple: free lists keyed by level, nodes sized for their key.
    // (Freed nodes are only reused when the key fits; otherwise leak until
    // destroy — bounded in practice by the sweep keeping node count low.)
    for (size_t i = 0; i < free_lists[lvl].size(); i++) {
      Node* n = free_lists[lvl][i];
      if (n->keylen >= keylen) {
        free_lists[lvl][i] = free_lists[lvl].back();
        free_lists[lvl].pop_back();
        n->level = lvl;
        n->keylen = keylen;
        if (keylen) std::memcpy(const_cast<uint8_t*>(n->key()), key, keylen);
        return n;
      }
    }
    void* mem = std::malloc(sizeof(Node) + keylen);
    arena_blocks.push_back(mem);
    Node* n = reinterpret_cast<Node*>(mem);
    n->level = lvl;
    n->keylen = keylen;
    if (keylen) std::memcpy(const_cast<uint8_t*>(n->key()), key, keylen);
    return n;
  }

  int random_level() {
    rng ^= rng << 13;
    rng ^= rng >> 7;
    rng ^= rng << 17;
    int lvl = 1;
    uint64_t x = rng;
    while ((x & 1) && lvl < kMaxLevel) {
      lvl++;
      x >>= 1;
    }
    return lvl;
  }

  // Fill update[] with the last node < key at each level; returns update[0].
  Node* find_pred(const uint8_t* key, uint32_t keylen, Node** update) {
    Node* x = head;
    for (int i = level - 1; i >= 0; i--) {
      while (x->next[i] &&
             cmp_keys(x->next[i]->key(), x->next[i]->keylen, key, keylen) < 0)
        x = x->next[i];
      update[i] = x;
    }
    return x;
  }

  // Version in effect at `key` (the floor segment's version).
  int64_t version_at(const uint8_t* key, uint32_t keylen) {
    Node* update[kMaxLevel];
    Node* pred = find_pred(key, keylen, update);
    Node* nxt = pred->next[0];
    if (nxt && cmp_keys(nxt->key(), nxt->keylen, key, keylen) == 0)
      return nxt->version;
    return pred->version;
  }

  // Any segment intersecting [b, e) with version > rv?
  bool check(const uint8_t* b, uint32_t blen, const uint8_t* e, uint32_t elen,
             int64_t rv) {
    Node* update[kMaxLevel];
    Node* pred = find_pred(b, blen, update);
    // Floor segment: pred unless a node sits exactly at b.
    Node* x = pred->next[0];
    if (!(x && cmp_keys(x->key(), x->keylen, b, blen) == 0)) {
      if (pred->version > rv) return true;
    }
    while (x && cmp_keys(x->key(), x->keylen, e, elen) < 0) {
      if (x->version > rv) return true;
      x = x->next[0];
    }
    return false;
  }

  void insert_at(Node** update, const uint8_t* key, uint32_t keylen,
                 int64_t version) {
    int lvl = random_level();
    if (lvl > level) {
      for (int i = level; i < lvl; i++) update[i] = head;
      level = lvl;
    }
    Node* n = alloc_node(lvl, key, keylen);
    n->version = version;
    for (int i = 0; i < lvl; i++) {
      n->next[i] = update[i]->next[i];
      update[i]->next[i] = n;
    }
    node_count++;
  }

  // Paint [b, e) at version cv: boundary at b (version cv), erase interior
  // boundaries, boundary at e restoring the prior version.
  void paint(const uint8_t* b, uint32_t blen, const uint8_t* e, uint32_t elen,
             int64_t cv) {
    if (cmp_keys(b, blen, e, elen) >= 0) return;
    int64_t resume = version_at(e, elen);

    Node* update[kMaxLevel];
    find_pred(b, blen, update);
    Node* x = update[0]->next[0];
    // Node exactly at b? repaint it. Otherwise insert one.
    if (x && cmp_keys(x->key(), x->keylen, b, blen) == 0) {
      x->version = cv;
      for (int i = 0; i < x->level; i++) update[i] = x;
      x = x->next[0];
    } else {
      insert_at(update, b, blen, cv);
      // update[] now stale at low levels; refresh via the inserted node.
      Node* nb = update[0]->next[0];
      for (int i = 0; i < nb->level; i++) update[i] = nb;
      x = nb->next[0];
    }
    // Erase interior nodes in (b, e).
    while (x && cmp_keys(x->key(), x->keylen, e, elen) < 0) {
      Node* victim = x;
      // update[i] is the last surviving node < victim at each level.
      for (int i = 0; i < victim->level; i++)
        update[i]->next[i] = victim->next[i];
      x = victim->next[0];
      free_lists[victim->level].push_back(victim);
      node_count--;
    }
    // Boundary at e (unless one already exists).
    if (!(x && cmp_keys(x->key(), x->keylen, e, elen) == 0)) {
      if (resume != cv) insert_at(update, e, elen, resume);
    }
  }

  // Remove expired + redundant boundaries (segment version == predecessor's).
  void sweep() {
    Node* update[kMaxLevel];
    for (int i = 0; i < level; i++) update[i] = head;
    int64_t prev_version = kNegVersion;
    if (head->version < oldest) head->version = kNegVersion;
    prev_version = head->version;
    Node* x = head->next[0];
    while (x) {
      if (x->version < oldest) x->version = kNegVersion;
      if (x->version == prev_version) {
        for (int i = 0; i < x->level; i++) update[i]->next[i] = x->next[i];
        Node* victim = x;
        x = x->next[0];
        free_lists[victim->level].push_back(victim);
        node_count--;
      } else {
        prev_version = x->version;
        for (int i = 0; i < x->level; i++) update[i] = x;
        x = x->next[0];
      }
    }
    sweep_watermark = node_count < 32 ? 64 : node_count * 2;
  }
};

struct Range {
  const uint8_t* b;
  uint32_t blen;
  const uint8_t* e;
  uint32_t elen;
};

}  // namespace

extern "C" {

void* cs_create() { return new SkipListCS(); }

void cs_destroy(void* p) { delete static_cast<SkipListCS*>(p); }

int64_t cs_node_count(void* p) {
  return static_cast<int64_t>(static_cast<SkipListCS*>(p)->node_count);
}

// Resolve one batch.
//   blob: all key bytes, ranges reference (offset, len) pairs into it.
//   ranges: 4 int64 per range [boff, blen, eoff, elen]; for txn i its read
//     ranges come first, then its write ranges (prefix-summed via counts).
//   verdicts_out: int8 per txn, 0=committed 1=conflict 2=too_old.
void cs_resolve(void* p, const uint8_t* blob, const int64_t* ranges,
                const int32_t* read_counts, const int32_t* write_counts,
                const int64_t* read_versions, int32_t n_txns,
                int64_t commit_version, int64_t oldest_version,
                int8_t* verdicts_out) {
  SkipListCS* cs = static_cast<SkipListCS*>(p);
  if (oldest_version > cs->oldest) cs->oldest = oldest_version;

  size_t ri = 0;  // running range index
  for (int32_t t = 0; t < n_txns; t++) {
    int32_t nr = read_counts[t], nw = write_counts[t];
    const int64_t* rr = ranges + 4 * ri;
    const int64_t* wr = ranges + 4 * (ri + nr);
    ri += nr + nw;

    bool has_reads = false;
    for (int32_t k = 0; k < nr; k++) {
      const int64_t* q = rr + 4 * k;
      if (cmp_keys(blob + q[0], (uint32_t)q[1], blob + q[2], (uint32_t)q[3]) < 0)
        has_reads = true;
    }
    if (has_reads && read_versions[t] < cs->oldest) {
      verdicts_out[t] = 2;
      continue;
    }
    bool conflict = false;
    for (int32_t k = 0; k < nr && !conflict; k++) {
      const int64_t* q = rr + 4 * k;
      if (cmp_keys(blob + q[0], (uint32_t)q[1], blob + q[2], (uint32_t)q[3]) >= 0)
        continue;
      conflict = cs->check(blob + q[0], (uint32_t)q[1], blob + q[2],
                           (uint32_t)q[3], read_versions[t]);
    }
    if (conflict) {
      verdicts_out[t] = 1;
      continue;
    }
    verdicts_out[t] = 0;
    for (int32_t k = 0; k < nw; k++) {
      const int64_t* q = wr + 4 * k;
      cs->paint(blob + q[0], (uint32_t)q[1], blob + q[2], (uint32_t)q[3],
                commit_version);
    }
  }
  if (cs->node_count > cs->sweep_watermark) cs->sweep();
}

}  // extern "C"
