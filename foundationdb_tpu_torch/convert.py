"""Carry a conflict engine's state across: snapshot <-> TorchConflictSet.

A snapshot is a plain dict of numpy arrays and ints, so an engine of
either package can be captured mid-stream and continued by the port:

- ``config``: the constructor arguments (capacity, batch_size,
  max_read_ranges, max_write_ranges, max_key_bytes, window_versions,
  delta_capacity, dict_capacity, dict_delta_slots, wave_commit,
  dict_hot_capacity and dict_demote_batch (0 when untiered),
  spec_resolve, spec_depth);
- ``state``: every ResState leaf under its dotted path (``dict_keys``,
  ``n_keys``, ``hist.base.keys``, ..., ``hist.base_st``, ...,
  ``shard_hi``);
- ``mirror``: every field of the host dictionary mirror (MIRROR_FIELDS)
  and its ``stats`` dict;
- ``base_version``, ``oldest_version``, ``last_commit``.

A speculative engine is reconciled before it is captured (its in-flight
windows and their snapshots cannot be carried). The port reads no object
of the JAX package: whoever captures a JAX engine builds this dict from
it (the tests do).
"""

from __future__ import annotations

import numpy as np
import torch

from foundationdb_tpu_torch.models import conflict_kernel as ck
from foundationdb_tpu_torch.models.conflict_set import TorchConflictSet

CONFIG_FIELDS = ("capacity", "batch_size", "max_read_ranges",
                 "max_write_ranges", "window_versions", "delta_capacity",
                 "dict_capacity", "dict_delta_slots", "wave_commit",
                 "dict_hot_capacity", "dict_demote_batch", "spec_resolve",
                 "spec_depth")
STATE_FIELDS = ("keys", "versions", "n_used", "oldest", "overflow")
MIRROR_FIELDS = ("u64", "rows", "pinned", "_n_ids", "u64_by_id",
                 "rank_of_id", "last_used_by_id", "hot_by_id", "id_at", "tab",
                 "_mask")


def state_leaves(res) -> dict[str, object]:
    """Dotted-path leaves of a ResState (either package's: only field
    names are read)."""
    out = {"dict_keys": res.dict_keys, "n_keys": res.n_keys,
           "hist.base_st": res.hist.base_st,
           "shard_lo": res.shard_lo, "shard_hi": res.shard_hi}
    for level in ("base", "delta"):
        st = getattr(res.hist, level)
        for f in STATE_FIELDS:
            out[f"hist.{level}.{f}"] = getattr(st, f)
    return out


def snapshot(cs: TorchConflictSet) -> dict:
    """Snapshot of a port engine (device state copied to the host), after
    reconciling its in-flight speculative windows."""
    cs.reconcile_all()
    mir = cs._mirror
    return {
        "config": {f: getattr(cs, f) for f in CONFIG_FIELDS}
        | {"max_key_bytes": cs.codec.max_key_bytes},
        "state": {k: v.cpu().numpy()
                  for k, v in state_leaves(cs.state).items()},
        "mirror": {f: np.array(getattr(mir, f), copy=True)
                   for f in MIRROR_FIELDS} | {"stats": dict(mir.stats)},
        "base_version": cs.base_version,
        "oldest_version": cs.oldest_version,
        "last_commit": cs._last_commit,
    }


def engine_from_snapshot(snap: dict, device=None) -> TorchConflictSet:
    """A TorchConflictSet whose device ResState and host mirror equal the
    snapshot's, ready to resolve the next batch."""
    cs = TorchConflictSet(**snap["config"], device=device)
    st = snap["state"]

    def t(name):
        return torch.from_numpy(np.array(st[name], copy=True)).to(cs.device)

    def level(name):
        return ck.ConflictState(*(t(f"hist.{name}.{f}")
                                  for f in STATE_FIELDS))

    cs.state = ck.ResState(
        dict_keys=t("dict_keys"), n_keys=t("n_keys"),
        hist=ck.HistState(level("base"), t("hist.base_st"), level("delta")),
        shard_lo=t("shard_lo"), shard_hi=t("shard_hi"))
    mir = cs._mirror
    for f in MIRROR_FIELDS:
        cur, v = getattr(mir, f), snap["mirror"][f]
        setattr(mir, f, np.array(v, copy=True)
                if isinstance(cur, np.ndarray) else type(cur)(v))
    for k in mir.stats:
        mir.stats[k] = int(snap["mirror"]["stats"][k])
    cs.base_version = snap["base_version"]
    cs.oldest_version = snap["oldest_version"]
    cs._last_commit = snap["last_commit"]
    return cs
