"""Brute-force MVCC conflict oracle (the port's copy of the JAX package's
``sim/oracle.py``, over the port's ``core.types`` and ``core.wavemesh``).

The O(n²) reference model the simulation workloads compare the real engine
against — the same role ConflictRange.actor.cpp's in-memory model plays for
the reference's simulation tests. Semantics mirror
fdbserver/ConflictSet.h exactly:

- a txn with reads and read_version < oldestVersion is TOO_OLD
  (write-only txns are never too old);
- a txn conflicts if any non-empty read range overlaps a historical write
  with version > read_version, or overlaps a write range of an EARLIER
  ACCEPTED txn in the same batch;
- accepted txns' write ranges enter the history at the batch commit version.

``wave_commit=True`` replaces the third rule with the reorder-don't-abort
schedule (conflict_kernel phase 2b): the intra-batch constraint
"i must serialize before j" exists exactly when reads(i) ∩ writes(j) ≠ ∅,
the constraint digraph is leveled into commit WAVES, and only txns on true
cycles abort — one deterministic min-index victim per stall, replaying the
kernel's ``_cycle_victim`` walk byte-for-byte so engine/oracle parity holds
on verdicts AND schedules (``last_wave``).
"""

from __future__ import annotations

from foundationdb_tpu_torch.core.types import (
    WAVE_LEVEL_CYCLE as LEVEL_CYCLE,
    WAVE_LEVEL_NONE as LEVEL_NONE,
    KeyRange,
    TxnConflictInfo,
    Verdict,
)
from foundationdb_tpu_torch.core.wavemesh import (
    WaveEdges,
    level_wave_graph,
    pack_pred_rows,
    schedule_graph,
    unpack_pred_rows,
    verdicts_from_schedule,
)


class OracleConflictSet:
    def __init__(self, wave_commit: bool = False) -> None:
        self.history: list[tuple[KeyRange, int]] = []
        self.oldest_version = 0
        self.wave_commit = wave_commit
        # Exact conflicting read ranges of the LAST resolve call, by txn
        # index — only recorded for txns that asked (report_conflicting_keys;
        # reference: conflictingKRIndices in ResolveTransactionBatchReply).
        self.last_conflicting: dict[int, list[KeyRange]] = {}
        # Wave levels of the LAST resolve call (wave_commit engines only):
        # >= 0 committed at that wave, LEVEL_CYCLE aborted on a true
        # cycle, LEVEL_NONE every other non-commit. last_reordered counts
        # the commits past wave 0 (same contract as TPUConflictSet).
        self.last_wave: list[int] | None = None
        self.last_reordered: int | None = None
        # Role-level global wave protocol (core/wavemesh): resolve_edges
        # stashes the window here until resolve_apply paints it.
        self._wave_pending: "tuple | None" = None

    @property
    def wave_global_capable(self) -> bool:
        """Wave-commit oracles implement the two-phase global protocol
        (resolve_edges/resolve_apply), so sharded multi-resolver wave
        deployments are legal with this engine."""
        return self.wave_commit

    def resolve(
        self,
        txns: list[TxnConflictInfo],
        commit_version: int,
        oldest_version: int | None = None,
    ) -> list[Verdict]:
        if oldest_version is not None:
            self.oldest_version = max(self.oldest_version, oldest_version)
        if self.wave_commit:
            return self._resolve_wave(txns, commit_version)
        verdicts: list[Verdict] = []
        accepted_writes: list[KeyRange] = []
        self.last_conflicting = {}
        for i, t in enumerate(txns):
            reads = [r for r in t.read_ranges if not r.empty]
            if reads and t.read_version < self.oldest_version:
                verdicts.append(Verdict.TOO_OLD)
                continue

            def bad(r: KeyRange, t=t, accepted=accepted_writes) -> bool:
                return any(
                    r.overlaps(w) and v > t.read_version
                    for (w, v) in self.history
                ) or any(r.overlaps(w) for w in accepted)

            conflicting = [r for r in reads if bad(r)]
            if conflicting:
                verdicts.append(Verdict.CONFLICT)
                if t.report_conflicting_keys:
                    self.last_conflicting[i] = conflicting
                continue
            verdicts.append(Verdict.COMMITTED)
            accepted_writes.extend(w for w in t.write_ranges if not w.empty)
        self.history.extend((w, commit_version) for w in accepted_writes)
        # GC below the window floor (matches the kernel's clamp-to-sentinel).
        self.history = [
            (w, v) for (w, v) in self.history if v > self.oldest_version
        ]
        return verdicts

    # -- wave commit (reorder-don't-abort) ----------------------------------

    def _resolve_wave(
        self, txns: list[TxnConflictInfo], commit_version: int
    ) -> list[Verdict]:
        n = len(txns)
        self.last_conflicting = {}
        verdicts: list[Verdict | None] = [None] * n
        reads = [[r for r in t.read_ranges if not r.empty] for t in txns]
        writes = [[w for w in t.write_ranges if not w.empty] for t in txns]

        # History gate first (unchanged from sequential acceptance): the
        # wave schedule only reorders txns whose reads are clean against
        # every PRIOR batch.
        cand: list[int] = []
        for i, t in enumerate(txns):
            if reads[i] and t.read_version < self.oldest_version:
                verdicts[i] = Verdict.TOO_OLD
                continue
            hist = [
                r for r in reads[i]
                if any(r.overlaps(w) and v > t.read_version
                       for (w, v) in self.history)
            ]
            if hist:
                verdicts[i] = Verdict.CONFLICT
                if t.report_conflicting_keys:
                    self.last_conflicting[i] = hist
                continue
            cand.append(i)

        # pred[j] = {i : reads(i) ∩ writes(j) ≠ ∅} — i must serialize
        # BEFORE j (i must not observe j's write). Candidates only,
        # diagonal excluded — exactly _pred_matrix_packed's bitset.
        pred: dict[int, set[int]] = {
            j: {
                i for i in cand
                if i != j and any(
                    r.overlaps(w) for r in reads[i] for w in writes[j]
                )
            }
            for j in cand
        }

        # Deterministic leveling — ONE implementation (core/wavemesh,
        # replaying the kernel's _wave_level_packed rule byte-for-byte)
        # shared with the role-level global-graph apply path below.
        level = level_wave_graph(n, cand, pred)

        committed_writes = [w for j in cand if level[j] >= 0 for w in writes[j]]
        for i in cand:
            if level[i] >= 0:
                verdicts[i] = Verdict.COMMITTED
                continue
            verdicts[i] = Verdict.CONFLICT
            if txns[i].report_conflicting_keys:
                # A cycle victim's losers: its reads overlapping same-batch
                # WINNERS' writes (those land at commit_version; a repair
                # replay at commit_version-1 re-validates over a window
                # that includes them — see repair/engine.py's soundness
                # argument). Degrades to the full read set if the cycle
                # was broken before its peers committed.
                lost = [
                    r for r in reads[i]
                    if any(r.overlaps(w) for w in committed_writes)
                ]
                self.last_conflicting[i] = lost or list(reads[i])
        self.history.extend(
            (w, commit_version) for w in committed_writes
        )
        self.history = [
            (w, v) for (w, v) in self.history if v > self.oldest_version
        ]
        self.last_wave = level
        self.last_reordered = sum(1 for lv in level if lv > 0)
        return verdicts  # type: ignore[return-value]

    # -- role-level global wave protocol (core/wavemesh) ---------------------

    def _gate_and_pred(self, txns: list[TxnConflictInfo]):
        """(too_old, hist_conflict, hist_losers, pred): this shard's
        clipped gate + predecessor sets over LOCAL candidates — phase 1's
        raw material, shared with nothing else so the single-shard
        _resolve_wave stays byte-identical to its history."""
        n = len(txns)
        reads = [[r for r in t.read_ranges if not r.empty] for t in txns]
        writes = [[w for w in t.write_ranges if not w.empty] for t in txns]
        too_old = [
            bool(reads[i] and t.read_version < self.oldest_version)
            for i, t in enumerate(txns)
        ]
        hist_losers = [
            [] if too_old[i] else [
                r for r in reads[i]
                if any(r.overlaps(w) and v > txns[i].read_version
                       for (w, v) in self.history)
            ]
            for i in range(n)
        ]
        hist_conflict = [bool(h) for h in hist_losers]
        cand = [
            i for i in range(n) if not too_old[i] and not hist_conflict[i]
        ]
        pred = {
            j: {
                i for i in cand
                if i != j and any(
                    r.overlaps(w) for r in reads[i] for w in writes[j]
                )
            }
            for j in cand
        }
        return too_old, hist_conflict, hist_losers, pred

    def resolve_edges(
        self,
        txns: list[TxnConflictInfo],
        commit_version: int,
        oldest_version: int | None = None,
    ) -> WaveEdges:
        """Phase 1: gate this shard's clipped view and pack its clipped
        predecessor bitsets; nothing is painted until resolve_apply."""
        if not self.wave_global_capable:
            raise ValueError("resolve_edges requires a wave-commit oracle")
        if self._wave_pending is not None:
            raise ValueError(
                "resolve_edges with an apply outstanding (version chain)"
            )
        import numpy as np

        if oldest_version is not None:
            self.oldest_version = max(self.oldest_version, oldest_version)
        too_old, hist_conflict, hist_losers, pred = self._gate_and_pred(txns)
        n = len(txns)
        self._wave_pending = (txns, commit_version, hist_losers)
        return WaveEdges(
            count=n,
            too_old=np.asarray(too_old, bool),
            hist_conflict=np.asarray(hist_conflict, bool),
            chunks=[(n, pack_pred_rows(pred, n))] if n else [],
        )

    def resolve_abandon(self) -> None:
        """Drop a pending resolve_edges without painting (fail-safe
        elsewhere in the deployment rejected the window)."""
        self._wave_pending = None

    def resolve_apply(self, graph) -> list[Verdict]:
        """Phase 2: level the combined GLOBAL graph with the shared
        deterministic rule, paint this shard's clipped accepted writes,
        publish last_wave/last_reordered. Every shard receives the same
        graph, so every shard reports the identical schedule."""
        if self._wave_pending is None:
            raise ValueError("resolve_apply without a pending resolve_edges")
        txns, commit_version, hist_losers = self._wave_pending
        self._wave_pending = None
        levels, reordered = schedule_graph(graph)
        verdicts = verdicts_from_schedule(graph, levels)
        reads = [[r for r in t.read_ranges if not r.empty] for t in txns]
        writes = [[w for w in t.write_ranges if not w.empty] for t in txns]
        committed_writes = [
            w for i in range(len(txns)) if levels[i] >= 0 for w in writes[i]
        ]
        self.last_conflicting = {}
        for i, t in enumerate(txns):
            if verdicts[i] != Verdict.CONFLICT or not t.report_conflicting_keys:
                continue
            if hist_losers[i]:
                self.last_conflicting[i] = list(hist_losers[i])
                continue
            lost = [
                r for r in reads[i]
                if any(r.overlaps(w) for w in committed_writes)
            ]
            # Only losers THIS shard can witness are reported (the proxy
            # unions the shards); a txn gated purely elsewhere reports
            # nothing here.
            if lost:
                self.last_conflicting[i] = lost
        self.history.extend((w, commit_version) for w in committed_writes)
        self.history = [
            (w, v) for (w, v) in self.history if v > self.oldest_version
        ]
        self.last_wave = levels
        self.last_reordered = reordered
        return verdicts


class ReplayCheckedOracle(OracleConflictSet):
    """OracleConflictSet that PROVES each wave verdict by sequential
    replay, inline, on every resolve call.

    With ``wave_commit=True`` every resolve snapshots the pre-batch
    history and runs ``replay_wave_schedule`` over the verdicts it is
    about to return — a sequential executor replaying the realized
    (wave, index) order must agree byte-for-byte, or the resolve raises
    instead of answering. This is the engine behind the wave-commit A/B's
    "oracle-verified serializability" claim (repair/bench.py) and the
    nemesis campaigns' exactness rule. With ``wave_commit=False`` the
    sequential oracle's acceptance rule IS sequential replay (each txn is
    validated against the already-replayed prefix), so the subclass adds
    nothing beyond the shared entry point for A/B harnesses.
    """

    def resolve(
        self,
        txns: list[TxnConflictInfo],
        commit_version: int,
        oldest_version: int | None = None,
    ) -> list[Verdict]:
        if not self.wave_commit:
            return super().resolve(txns, commit_version, oldest_version)
        if oldest_version is not None:
            # Mirror the base class's floor advance BEFORE snapshotting:
            # replay must judge TOO_OLD against the same floor.
            self.oldest_version = max(self.oldest_version, oldest_version)
        history_before = list(self.history)
        floor_before = self.oldest_version
        verdicts = super().resolve(txns, commit_version, None)
        replay_wave_schedule(
            txns, verdicts, self.last_wave, history_before, floor_before
        )
        return verdicts

    def resolve_apply(self, graph) -> list[Verdict]:
        """Global-wave phase 2 with inline verification of everything
        THIS SHARD can witness, plus the graph-global cycle rule:

        - serial-order replay over the shard's CLIPPED ranges — a
          committed txn's reads must overlap no pre-batch write past its
          read version and no earlier-ordered committed write. Every
          overlap in the keyspace is clipped into the shard(s) owning
          those keys, so all shards passing their local replays IS a
          proof of global serializability;
        - edge-respect on local edges (level(i) < level(j));
        - cycle-only aborts on the GLOBAL graph (the shard holds the
          OR-reduced matrix — a cross-shard cycle is checkable here even
          though no single shard's ranges witness all its edges)."""
        history_before = list(self.history)
        floor_before = self.oldest_version
        txns = self._wave_pending[0] if self._wave_pending else []
        verdicts = super().resolve_apply(graph)
        replay_wave_schedule(
            txns, verdicts, self.last_wave, history_before, floor_before,
            global_graph=graph,
        )
        return verdicts


def replay_wave_schedule(
    txns: list[TxnConflictInfo],
    verdicts: list[Verdict],
    levels: list[int],
    history: list[tuple[KeyRange, int]],
    oldest_version: int = 0,
    global_graph=None,
) -> None:
    """Sequentially replay a wave schedule and raise AssertionError on any
    serializability violation — the acceptance check behind the wave-commit
    A/B: a sequential executor visiting committed txns in
    realized order (wave level, then batch index) must reproduce the
    engine's verdicts byte-for-byte.

    Checks, against ``history`` as it stood BEFORE the batch:
    - every committed txn's reads overlap no historical write past its
      read version and no write of a txn EARLIER in the realized order;
    - every committed txn with reads is within the MVCC window;
    - every CONFLICT either fails the history gate or sits on a true
      cycle of the candidate constraint graph (cycle-only aborts);
    - levels respect the constraint digraph: reads(i) ∩ writes(j) ≠ ∅
      for committed i, j implies level(i) < level(j).
    """
    reads = [[r for r in t.read_ranges if not r.empty] for t in txns]
    writes = [[w for w in t.write_ranges if not w.empty] for t in txns]
    order = sorted(
        (i for i, v in enumerate(verdicts) if v == Verdict.COMMITTED),
        key=lambda i: (levels[i], i),
    )
    replayed: list[KeyRange] = []
    for i in order:
        assert levels[i] >= 0, f"txn {i}: committed without a wave level"
        t = txns[i]
        if reads[i]:
            assert t.read_version >= oldest_version, (
                f"txn {i}: committed outside the MVCC window"
            )
        for r in reads[i]:
            assert not any(
                r.overlaps(w) and v > t.read_version for (w, v) in history
            ), f"txn {i}: committed over a history conflict"
            assert not any(r.overlaps(w) for w in replayed), (
                f"txn {i}: read overlaps an earlier-ordered write — the "
                f"realized order is not serial"
            )
        replayed.extend(writes[i])
    # Ordering respects every constraint edge among committed txns.
    for i in order:
        for j in order:
            if i != j and any(
                r.overlaps(w) for r in reads[i] for w in writes[j]
            ):
                assert levels[i] < levels[j], (
                    f"edge {i}->{j} violated: level {levels[i]} !< {levels[j]}"
                )
    # Cycle-only aborts: every intra-batch CONFLICT must lie on a cycle of
    # the candidate graph (candidates = txns passing the history gate).
    # Under the role-level global protocol the candidate set and the edge
    # set are GLOBAL (``global_graph``: a txn gated on another shard is
    # no candidate here, and a cycle may thread edges through several
    # shards' keyspace slices) — the local recomputation below would
    # misjudge both.
    if global_graph is not None:
        cand = [i for i in range(global_graph.count) if global_graph.cand[i]]
        cset = set(cand)
        pred = {}
        start = 0
        for nc, m in global_graph.chunks:
            for j, preds in unpack_pred_rows(m, nc).items():
                if start + j in cset:
                    pred[start + j] = {
                        start + i for i in preds if start + i in cset
                    }
            start += nc
    else:
        cand = [
            i for i, v in enumerate(verdicts)
            if v != Verdict.TOO_OLD and not (
                reads[i] and any(
                    r.overlaps(w) and v2 > txns[i].read_version
                    for r in reads[i] for (w, v2) in history
                )
            )
        ]
        cset = set(cand)
        pred = {
            j: {
                i for i in cand
                if i != j and any(
                    r.overlaps(w) for r in reads[i] for w in writes[j]
                )
            }
            for j in cand
        }
    for i in cand:
        if verdicts[i] != Verdict.CONFLICT:
            continue
        assert levels[i] == LEVEL_CYCLE, (
            f"txn {i}: intra-batch abort without the cycle level"
        )
        assert _on_cycle(i, pred, cset), (
            f"txn {i}: aborted but lies on no cycle of the constraint graph"
        )


def _on_cycle(i: int, pred: dict[int, set[int]], nodes: set[int]) -> bool:
    """Is node i on a directed cycle of the predecessor graph restricted
    to ``nodes``? (DFS from i through predecessors back to i.)"""
    stack, seen = [i], set()
    while stack:
        j = stack.pop()
        # frozenset default: the global-graph path hands a SPARSE pred
        # (entries only for txns with at least one predecessor bit).
        for k in pred.get(j, frozenset()) & nodes:
            if k == i:
                return True
            if k not in seen:
                seen.add(k)
                stack.append(k)
    return False
