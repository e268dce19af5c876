"""Global wave-commit exchange across sharded resolvers (numpy only).

The port's own copy of ``foundationdb_tpu/core/wavemesh.py``, so that the
port never imports the JAX package; the sharded engine will reuse it.

Wave commit (``models/conflict_kernel.py``) reorders a batch along its
conflict graph instead of aborting, but a reorder is only serializable
against the COMPLETE graph of the batch. Role-level multi-resolver
deployments clip each transaction's ranges to the resolver's key shard,
so each shard sees only the edges whose read/write overlap falls inside
its slice of the keyspace. Because the shards PARTITION the keyspace,
the true edge set is exactly the union of the per-shard clipped edge
sets:

    reads(i) ∩ writes(j) ≠ ∅  ⇔  ∃ shard d:
        clip_d(reads(i)) ∩ clip_d(writes(j)) ≠ ∅

so OR-reducing the per-shard packed predecessor bitsets rebuilds the
global graph, and a deterministic leveling of that graph, run
identically on every shard, yields one global (wave, index) schedule
every resolver agrees on byte for byte. This module is the shard- and
device-agnostic half of that protocol:

- the wire payloads (``WaveEdges`` per shard, ``WaveGraph`` combined),
  made of ints, bools and bytes;
- ``combine_edges``: the commit proxy's OR-reduce;
- ``level_wave_graph`` / ``schedule_graph``: the HOST reference leveling
  (level every source, else abort the one min-index cycle victim), which
  the plain leveling and the K6 kernel are tested against.

Predecessor bitset layout (shared with ops/bitset.pack_bits_u32): row j
holds the predecessors of txn j; bit i of word w is txn 32*w + i,
little-endian lanes. Rows are padded to BP = ceil32(n).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from foundationdb_tpu_torch.core.types import (
    WAVE_LEVEL_CYCLE as LEVEL_CYCLE,
    WAVE_LEVEL_NONE as LEVEL_NONE,
    KeyRange,
    TxnConflictInfo,
    Verdict,
)


def ceil32(n: int) -> int:
    return ((max(int(n), 1) + 31) // 32) * 32


def clip_ranges(ranges, lo: bytes, hi: bytes):
    """Clip KeyRanges to the shard [lo, hi), dropping emptied ones — THE
    clip rule the partition identity rests on (an edge's overlap region
    lands in exactly the shards whose clip of both sides is non-empty).
    One definition serves the commit proxy's per-resolver split, the A/B
    harness, and the tests, so none can drift from what ships."""
    out = []
    for r in ranges:
        b, e = max(r.begin, lo), min(r.end, hi)
        if b < e:
            out.append(KeyRange(b, e))
    return out


def clip_txns(txns, lo: bytes, hi: bytes):
    """Per-shard clipped TxnConflictInfo view (clip_ranges on both range
    sets; read_version and the report flag ride unchanged)."""
    return [
        TxnConflictInfo(
            read_version=t.read_version,
            read_ranges=clip_ranges(t.read_ranges, lo, hi),
            write_ranges=clip_ranges(t.write_ranges, lo, hi),
            report_conflicting_keys=t.report_conflicting_keys,
        )
        for t in txns
    ]


def pack_pred_rows(pred: "dict[int, set[int]]", n: int) -> np.ndarray:
    """{j: {i, ...}} predecessor sets -> packed uint32 [BP, BP/32]
    (kernel bit layout: row j, bit i ⇔ i must serialize before j)."""
    bp = ceil32(n)
    m = np.zeros((bp, bp // 32), np.uint32)
    for j, preds in pred.items():
        for i in preds:
            m[j, i >> 5] |= np.uint32(1) << np.uint32(i & 31)
    return m


def unpack_pred_rows(m: np.ndarray, n: int) -> "dict[int, set[int]]":
    """Inverse of pack_pred_rows, restricted to the first n txns."""
    bits = (m[:, None, :] >> np.arange(32, dtype=np.uint32)[None, :, None]) & 1
    dense = bits.transpose(0, 2, 1).reshape(m.shape[0], -1)[:n, :n]
    out: dict[int, set[int]] = {}
    for j in range(n):
        s = set(np.nonzero(dense[j])[0].tolist())
        if s:
            out[j] = s
    return out


@dataclass
class WaveEdges:
    """One shard's phase-1 reply: its clipped view of the window.

    ``chunks`` is one packed predecessor bitset per engine chunk (chunks
    serialize in order; edges never cross a chunk boundary), each a
    uint32 [BP, BP/32] with BP = the engine's padded chunk width. All
    shards of a deployment run identically configured engines, so the
    chunk structure matches across shards (combine_edges asserts it).
    ``too_old``/``hist_conflict`` are this shard's CLIPPED gate verdicts
    — the global gate is their OR across shards, exactly the AND-combine
    the sequential multi-resolver path applies to verdicts."""

    count: int
    too_old: np.ndarray  # bool [count]
    hist_conflict: np.ndarray  # bool [count]
    chunks: "list[tuple[int, np.ndarray]]"  # (n_chunk, pred [BP, BP/32])
    fail_safe: bool = False

    def to_wire(self) -> tuple:
        return (
            int(self.count),
            bool(self.fail_safe),
            np.asarray(self.too_old, np.uint8).tobytes(),
            np.asarray(self.hist_conflict, np.uint8).tobytes(),
            [
                (int(n), int(p.shape[0]), np.asarray(p, np.uint32).tobytes())
                for n, p in self.chunks
            ],
        )

    @classmethod
    def from_wire(cls, t: tuple) -> "WaveEdges":
        count, fail_safe, too_old, hist, chunks = t
        return cls(
            count=count,
            fail_safe=fail_safe,
            too_old=np.frombuffer(too_old, np.uint8).astype(bool),
            hist_conflict=np.frombuffer(hist, np.uint8).astype(bool),
            chunks=[
                (n, np.frombuffer(p, np.uint32).reshape(bp, bp // 32))
                for n, bp, p in chunks
            ],
        )


@dataclass
class WaveGraph:
    """The combined phase-2 request: the GLOBAL conflict graph every
    shard levels identically. ``cand`` is the global candidate mask
    (present ∧ ¬too_old ∧ ¬hist_conflict anywhere); the per-chunk
    predecessor bitsets are the OR of every shard's clipped edges,
    column-masked to candidates by the leveler."""

    count: int
    too_old: np.ndarray  # bool [count] — OR across shards
    cand: np.ndarray  # bool [count]
    chunks: "list[tuple[int, np.ndarray]]"
    fail_safe: bool = False

    def to_wire(self) -> tuple:
        return (
            int(self.count),
            bool(self.fail_safe),
            np.asarray(self.too_old, np.uint8).tobytes(),
            np.asarray(self.cand, np.uint8).tobytes(),
            [
                (int(n), int(p.shape[0]), np.asarray(p, np.uint32).tobytes())
                for n, p in self.chunks
            ],
        )

    @classmethod
    def from_wire(cls, t: tuple) -> "WaveGraph":
        count, fail_safe, too_old, cand, chunks = t
        return cls(
            count=count,
            fail_safe=fail_safe,
            too_old=np.frombuffer(too_old, np.uint8).astype(bool),
            cand=np.frombuffer(cand, np.uint8).astype(bool),
            chunks=[
                (n, np.frombuffer(p, np.uint32).reshape(bp, bp // 32))
                for n, bp, p in chunks
            ],
        )


def combine_edges(shards: "list[WaveEdges]") -> WaveGraph:
    """The commit proxy's reduction: OR the per-shard clipped gates and
    predecessor bitsets into the global graph. Shards partition the
    keyspace, so the OR is EXACT — every true edge lands in the shard
    owning the overlapping keys, and no shard can fabricate an edge its
    clipped ranges do not witness."""
    first = shards[0]
    n = first.count
    fail_safe = any(s.fail_safe for s in shards)
    if fail_safe:
        return WaveGraph(
            count=n,
            too_old=np.zeros(n, bool),
            cand=np.zeros(n, bool),
            chunks=[],
            fail_safe=True,
        )
    too_old = np.zeros(n, bool)
    hist = np.zeros(n, bool)
    for s in shards:
        if s.count != n or len(s.chunks) != len(first.chunks):
            raise ValueError(
                "wave edge exchange: shards disagree on window chunking "
                f"({s.count}x{len(s.chunks)} vs {n}x{len(first.chunks)})"
            )
        too_old |= s.too_old[:n]
        hist |= s.hist_conflict[:n]
    chunks: list[tuple[int, np.ndarray]] = []
    for ci, (nc, p0) in enumerate(first.chunks):
        acc = np.array(p0, np.uint32, copy=True)
        for s in shards[1:]:
            nc_s, p_s = s.chunks[ci]
            if nc_s != nc or p_s.shape != acc.shape:
                raise ValueError(
                    "wave edge exchange: shards disagree on chunk "
                    f"{ci} shape ({nc_s}/{p_s.shape} vs {nc}/{acc.shape})"
                )
            acc |= p_s
        chunks.append((nc, acc))
    return WaveGraph(
        count=n, too_old=too_old, cand=~too_old & ~hist, chunks=chunks
    )


def _min_pred(pred: "dict[int, set[int]]", undet: "set[int]", j: int) -> int:
    return min(pred.get(j, frozenset()) & undet)


def cycle_victim(pred: "dict[int, set[int]]", undet: "set[int]",
                 steps: int) -> int:
    """The kernel's deterministic exactly-on-a-cycle victim rule
    (conflict_kernel._cycle_victim), replayed on the host: from the
    lowest-index stuck txn, follow the minimum-index undetermined
    predecessor ``steps`` times (entering the walk's unique terminal
    cycle), then ``steps`` more tracking the minimum index visited — at
    least one full loop, so the result is that cycle's minimum member.
    Any step count exceeding every entry distance and cycle length
    yields the same victim, which is why the kernel's padded-size walk
    and this walk agree byte-for-byte."""
    j = min(undet)
    for _ in range(steps):
        j = _min_pred(pred, undet, j)
    m = j
    for _ in range(steps):
        j = _min_pred(pred, undet, j)
        m = min(m, j)
    return m


def level_wave_graph(n: int, cand: "set[int] | list[int]",
                     pred: "dict[int, set[int]]") -> "list[int]":
    """HOST reference of conflict_kernel._wave_level_packed: level the
    candidate constraint digraph into commit waves; only true-cycle
    members abort (one min-index victim per stall, the wave counter NOT
    advancing on an abort round). Deterministic — every shard given the
    same graph computes the identical schedule."""
    level = [LEVEL_NONE] * n
    undet = set(cand)
    wave = 0
    while undet:
        ready = sorted(j for j in undet if not (pred.get(j, set()) & undet))
        if ready:
            for j in ready:
                level[j] = wave
            wave += 1
            undet.difference_update(ready)
        else:
            victim = cycle_victim(pred, undet, n)
            level[victim] = LEVEL_CYCLE
            undet.discard(victim)
    return level


def level_wave_edges(n: int, cand, rows, cols) -> "list[int]":
    """``level_wave_graph``'s schedule over an edge list (txn cols[e] must
    serialize before txn rows[e]; edges touching a non-candidate are
    ignored), for graphs too large for sets of predecessors: a batch of
    32,768 txns with millions of edges. The same rule, counted rather
    than searched: a txn is ready once its count of undetermined
    predecessors reaches zero, and a stall walks the min-predecessor
    chain from the lowest undetermined txn, each row's predecessors
    sorted with a pointer past those already determined (the set only
    shrinks), to the first repeated txn; the victim is the minimum of the
    cycle from there."""
    is_c = np.zeros(n, bool)
    is_c[np.asarray(list(cand), dtype=np.int64)] = True
    rows = np.asarray(rows, dtype=np.int64)
    cols = np.asarray(cols, dtype=np.int64)
    keep = is_c[rows] & is_c[cols]
    key = np.unique(rows[keep] * n + cols[keep])
    rows, cols = key // n, key % n  # sorted by row, then column
    pin = np.searchsorted(rows, np.arange(n + 1))
    order = np.argsort(cols, kind="stable")
    succ = rows[order]
    sin = np.searchsorted(cols[order], np.arange(n + 1))
    indeg = np.diff(pin)
    undet = is_c.copy()
    level = np.full(n, LEVEL_NONE, dtype=np.int64)
    ptr = pin[:-1].copy()
    ready = np.nonzero(undet & (indeg == 0))[0]
    left, wave, low = int(undet.sum()), 0, 0

    def release(done):
        s = np.concatenate([succ[sin[i]:sin[i + 1]] for i in done])
        s = s[undet[s]]
        np.subtract.at(indeg, s, 1)
        return np.unique(s[indeg[s] == 0])

    def min_pred(j):
        k = ptr[j]
        while not undet[cols[k]]:
            k += 1
        ptr[j] = k
        return int(cols[k])

    while left:
        if ready.size:
            level[ready] = wave
            undet[ready] = False
            left -= ready.size
            wave += 1
            ready = release(ready)
            continue
        while not undet[low]:
            low += 1
        seen, path, j = {}, [], low
        while j not in seen:
            seen[j] = len(path)
            path.append(j)
            j = min_pred(j)
        victim = min(path[seen[j]:])
        level[victim] = LEVEL_CYCLE
        undet[victim] = False
        left -= 1
        ready = release([victim])
    return level.tolist()


def schedule_graph(graph: WaveGraph) -> "tuple[list[int], int]":
    """Level every chunk of the combined graph on the host and stitch the
    chunk schedules into one coherent window schedule (chunk i+1's wave 0
    serializes after all of chunk i's waves — the same offset rule as
    TorchConflictSet._collect_waves). Returns (levels[count], reordered)
    where ``reordered`` counts commits past their CHUNK's first wave
    (raw level > 0 — offsets excluded, matching the engine counters)."""
    levels: list[int] = []
    offset = 0
    reordered = 0
    start = 0
    for nc, p in graph.chunks:
        cand = [
            start + k
            for k in range(nc)
            if start + k < graph.count and graph.cand[start + k]
        ]
        local_cand = {k - start for k in cand}
        pred = {
            j: {i for i in preds if i in local_cand}
            for j, preds in unpack_pred_rows(p, nc).items()
            if j in local_cand
        }
        lv = level_wave_graph(nc, local_cand, pred)
        reordered += sum(1 for x in lv if x > 0)
        levels.extend(x + offset if x >= 0 else x for x in lv)
        mx = max((x for x in lv if x >= 0), default=-1)
        if mx >= 0:
            offset += mx + 1
        start += nc
    return levels[: graph.count], reordered


def verdicts_from_schedule(graph: WaveGraph, levels: "list[int]"):
    """int8-compatible verdict codes from the global gate + schedule:
    TOO_OLD wins (matching the proxy's AND-combine precedence), then
    COMMITTED iff leveled, else CONFLICT. Identical on every shard
    because every input is global."""
    out = []
    for i in range(graph.count):
        if graph.too_old[i]:
            out.append(Verdict.TOO_OLD)
        elif levels[i] >= 0:
            out.append(Verdict.COMMITTED)
        else:
            out.append(Verdict.CONFLICT)
    return out


__all__ = [
    "WaveEdges",
    "WaveGraph",
    "ceil32",
    "clip_ranges",
    "clip_txns",
    "combine_edges",
    "cycle_victim",
    "level_wave_graph",
    "pack_pred_rows",
    "schedule_graph",
    "unpack_pred_rows",
    "verdicts_from_schedule",
]
