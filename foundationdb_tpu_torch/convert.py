"""Carry a conflict engine's state across: snapshot <-> TorchConflictSet.

A snapshot is a plain dict of numpy arrays and ints, so an engine of
either package can be captured mid-stream and continued by the port:

- ``config``: the constructor arguments (capacity, batch_size,
  max_read_ranges, max_write_ranges, max_key_bytes, window_versions,
  delta_capacity, dict_capacity, dict_delta_slots, wave_commit, resident,
  dict_hot_capacity and dict_demote_batch (0 when untiered),
  spec_resolve, spec_depth);
- ``state``: every ResState leaf under its dotted path (``dict_keys``,
  ``n_keys``, ``hist.base.keys``, ..., ``hist.base_st``, ...,
  ``shard_hi``; a sharded engine's flat history as ``hist.keys`` [S, C, 1],
  ``hist.versions`` [S, C], ``hist.n_used``, ``hist.oldest`` and
  ``hist.overflow`` [S]);
- ``sharded`` (a ``ShardedConflictSet`` only): ``n_shards``, ``splits``
  (the interior split keys, None for uniform), ``auto_reshard``,
  ``reshard_interval``, ``reshard_skew`` and the counters
  ``reshard_moved_shards``, ``auto_reshards``, ``dispatches`` and
  ``exchange`` (occupied tiles, dense tiles, wave batches; the pending
  stats folded first);
- ``mirror``: every field of the host dictionary mirror (MIRROR_FIELDS)
  and its ``stats`` dict;
- ``base_version``, ``oldest_version``, ``last_commit``.

A non-resident engine (``resident=False``) has no mirror and a bare
``HistState``: its ``state`` leaves are ``base.keys``, ..., ``base_st``,
``delta.keys``, ... (no ``hist.`` prefix, no dictionary) and its snapshot
has no ``mirror`` entry. A non-resident sharded engine's state is its S
flat histories: the leaves ``keys`` [S, C, W], ``versions`` [S, C],
``n_used``, ``oldest`` and ``overflow`` [S], with the ``sharded`` entry and
no ``mirror``; a JAX non-resident ``ShardedConflictSet``'s state (a
ConflictState of [D, C, W] keys and [D] scalars, as numpy) has the same
leaves, and :func:`flat_shards_from_leaves` makes the port's state of
them.

An admission filter travels on its own (``filter_snapshot`` /
``filter_from_snapshot``): its geometry, the banks as bool [banks, nbits],
the per-bank version bounds, the current bank and the version it opened
at, the exact shadow, the delta log and the counters.

A speculative engine is reconciled before it is captured (its in-flight
windows and their snapshots cannot be carried). The port reads no object
of the JAX package: whoever captures a JAX engine builds this dict from
it (the tests do).
"""

from __future__ import annotations

import numpy as np
import torch

from foundationdb_tpu_torch.admission.filter import RecentWritesFilter
from foundationdb_tpu_torch.models import conflict_kernel as ck
from foundationdb_tpu_torch.models.conflict_set import TorchConflictSet
from foundationdb_tpu_torch.parallel.sharded_resolver import ShardedConflictSet

CONFIG_FIELDS = ("capacity", "batch_size", "max_read_ranges",
                 "max_write_ranges", "window_versions", "delta_capacity",
                 "dict_capacity", "dict_delta_slots", "wave_commit", "resident",
                 "dict_hot_capacity", "dict_demote_batch", "spec_resolve",
                 "spec_depth")
STATE_FIELDS = ("keys", "versions", "n_used", "oldest", "overflow")
MIRROR_FIELDS = ("u64", "rows", "pinned", "_n_ids", "u64_by_id",
                 "rank_of_id", "last_used_by_id", "hot_by_id", "id_at", "tab",
                 "_mask")


def hist_leaves(hist) -> dict[str, object]:
    """Dotted-path leaves of a two-level HistState (either package's)."""
    out = {"base_st": hist.base_st}
    for level in ("base", "delta"):
        st = getattr(hist, level)
        for f in STATE_FIELDS:
            out[f"{level}.{f}"] = getattr(st, f)
    return out


def state_leaves(res) -> dict[str, object]:
    """Dotted-path leaves of a ResState (either package's: only field
    names are read), its history two-level or flat (sharded); of a
    non-resident engine's bare HistState; or of a non-resident sharded
    engine's bare flat ConflictState."""
    if hasattr(res, "keys") and hasattr(res, "overflow"):
        return {f: getattr(res, f) for f in STATE_FIELDS}
    if not hasattr(res, "dict_keys"):
        return hist_leaves(res)
    out = {"dict_keys": res.dict_keys, "n_keys": res.n_keys}
    if not hasattr(res.hist, "base"):
        out.update({f"hist.{f}": getattr(res.hist, f) for f in STATE_FIELDS})
        return out | {"shard_lo": res.shard_lo, "shard_hi": res.shard_hi}
    out.update({f"hist.{k}": v for k, v in hist_leaves(res.hist).items()})
    return out | {"shard_lo": res.shard_lo, "shard_hi": res.shard_hi}


def flat_shards_from_leaves(leaves: dict, device=None) -> ck.ConflictState:
    """The port's non-resident sharded state (S flat [C, W] histories on
    ``device``) from the state leaves of a snapshot, or of a JAX
    non-resident ``ShardedConflictSet`` (``state_leaves`` of its numpy
    state: [D, C, W] keys, [D, C] versions, [D] scalars)."""
    return ck.ConflictState(*(
        torch.from_numpy(np.array(leaves[f], copy=True)).to(device)
        for f in STATE_FIELDS))


def snapshot(cs: TorchConflictSet) -> dict:
    """Snapshot of a port engine (device state copied to the host), after
    reconciling its in-flight speculative windows."""
    cs.reconcile_all()
    mir = cs._mirror
    snap = {
        "config": {f: getattr(cs, f) for f in CONFIG_FIELDS}
        | {"max_key_bytes": cs.codec.max_key_bytes},
        "state": {k: v.cpu().numpy()
                  for k, v in state_leaves(cs.state).items()},
        "base_version": cs.base_version,
        "oldest_version": cs.oldest_version,
        "last_commit": cs._last_commit,
    }
    if mir is not None:
        snap["mirror"] = {f: np.array(getattr(mir, f), copy=True)
                          for f in MIRROR_FIELDS} | {"stats": dict(mir.stats)}
    if isinstance(cs, ShardedConflictSet):
        cs._fold_exchange()
        snap["sharded"] = {
            "n_shards": cs.n_shards, "splits": cs._interior_splits,
            "auto_reshard": cs.auto_reshard,
            "reshard_interval": cs.reshard_interval,
            "reshard_skew": cs.reshard_skew,
            "reshard_moved_shards": cs.reshard_moved_shards,
            "auto_reshards": cs.auto_reshards, "dispatches": cs._dispatches,
            "exchange": list(cs._exchange_acc)}
    return snap


def engine_from_snapshot(snap: dict, device=None) -> TorchConflictSet:
    """A TorchConflictSet (a ShardedConflictSet for a snapshot with a
    ``sharded`` entry) whose device ResState and host mirror equal the
    snapshot's, ready to resolve the next batch."""
    sh = snap.get("sharded")
    if sh is None:
        cs = TorchConflictSet(**snap["config"], device=device)
    else:
        cs = ShardedConflictSet(
            n_shards=sh["n_shards"], splits=sh["splits"],
            auto_reshard=sh["auto_reshard"],
            reshard_interval=sh["reshard_interval"],
            reshard_skew=sh["reshard_skew"], **snap["config"], device=device)
        cs.reshard_moved_shards = int(sh["reshard_moved_shards"])
        cs.auto_reshards = int(sh["auto_reshards"])
        cs._dispatches = int(sh["dispatches"])
        cs._exchange_acc = [int(x) for x in sh["exchange"]]
    st = snap["state"]

    def t(name):
        return torch.from_numpy(np.array(st[name], copy=True)).to(cs.device)

    def level(name, prefix="hist."):
        return ck.ConflictState(*(t(f"{prefix}{name}.{f}")
                                  for f in STATE_FIELDS))

    if not cs.resident and sh is not None:
        cs.state = flat_shards_from_leaves(st, cs.device)
    elif not cs.resident:
        cs.state = ck.HistState(level("base", ""), t("base_st"),
                                level("delta", ""))
    else:
        if sh is None:
            hist = ck.HistState(level("base"), t("hist.base_st"),
                                level("delta"))
        else:
            hist = ck.ConflictState(*(t(f"hist.{f}") for f in STATE_FIELDS))
        cs.state = ck.ResState(
            dict_keys=t("dict_keys"), n_keys=t("n_keys"), hist=hist,
            shard_lo=t("shard_lo"), shard_hi=t("shard_hi"))
        _load_mirror(cs._mirror, snap["mirror"])
    cs.base_version = snap["base_version"]
    cs.oldest_version = snap["oldest_version"]
    cs._last_commit = snap["last_commit"]
    return cs


def _load_mirror(mir, snap: dict) -> None:
    for f in MIRROR_FIELDS:
        cur, v = getattr(mir, f), snap[f]
        setattr(mir, f, np.array(v, copy=True)
                if isinstance(cur, np.ndarray) else type(cur)(v))
    for k in mir.stats:
        mir.stats[k] = int(snap["stats"][k])


FILTER_FIELDS = ("bank_min", "bank_max", "_cur", "_cur_from", "delta_seq",
                 "recorded", "rotations")


def filter_snapshot(f: RecentWritesFilter) -> dict:
    """Snapshot of a port filter (either backend; the banks as bool)."""
    bits = f._bits.bool_banks().cpu().numpy() if f.backend == "device" \
        else f._bits.bits
    return {
        "config": {"bits_log2": f.nbits.bit_length() - 1, "banks": f.banks,
                   "hashes": f.hashes, "window_versions": f.window_versions,
                   "exact_shadow": f.exact_shadow},
        "bits": np.array(bits, bool, copy=True),
        **{k: np.array(getattr(f, k), copy=True)
           if isinstance(getattr(f, k), np.ndarray) else int(getattr(f, k))
           for k in FILTER_FIELDS},
        "shadow": [dict(s) for s in f._shadow],
        "delta_log": list(f._delta_log),
    }


def filter_from_snapshot(snap: dict, backend: str = "numpy",
                         device=None) -> RecentWritesFilter:
    """A port filter of ``backend`` (on ``device`` for ``"device"``) that
    answers, ages and feeds exactly as the snapshot's filter."""
    f = RecentWritesFilter(**snap["config"], backend=backend, device=device)
    if backend == "device":
        f._bits.load(snap["bits"])
    else:
        f._bits.bits = np.array(snap["bits"], bool, copy=True)
    for k in FILTER_FIELDS:
        cur = getattr(f, k)
        setattr(f, k, np.array(snap[k], np.int64, copy=True)
                if isinstance(cur, np.ndarray) else int(snap[k]))
    f._shadow = [dict(s) for s in snap["shadow"]]
    f._delta_log = list(snap["delta_log"])
    return f
