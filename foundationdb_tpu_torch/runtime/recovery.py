"""Recovery: replace the transaction subsystem after a role failure.

A copy of ``foundationdb_tpu/runtime/recovery.py`` for the port, its imports rewritten to
the port's modules; names and behaviour are the JAX module's.

Reference: the recovery state machine in fdbserver/masterserver.actor.cpp
(READING_CSTATE → LOCKING_TLOGS → RECRUITING → ACCEPTING_COMMITS),
compressed to the steps that matter for a single-region cluster whose
tlogs are full replicas:

1. **Lock** every reachable old-generation tlog. A locked tlog refuses
   further pushes, freezing its end version — in-flight batches racing the
   lock fail back to their proxy as commit_unknown_result.
2. **Determine the recovery version**: the max end version among locked
   tlogs. Our tlogs carry identical chains (every proxy pushes every batch
   to every tlog), so any one locked tlog bounds what could have been
   acked; the max over the locked set dominates every acked commit. At
   least one tlog must be reachable — with none, the durable suffix is
   unknown and recovery must wait (RecoveryFailed → controller retries).
3. **Salvage** the un-popped suffix of the chosen tlog's log: entries some
   storage server may not have pulled yet. These seed the new tlogs so
   storage can finish pulling from the new generation (the reference's
   equivalent: new-epoch tlogs peek the old generation's logs).
4. **Recruit** the next generation at ``recovery_version + EPOCH_VERSION_JUMP``
   — the version gap guarantees nothing the dead generation had in flight
   can collide — and re-point surviving storage servers at the new tlogs.

Resolver conflict state is deliberately NOT carried over: the version jump
puts every pre-recovery read version below the new MVCC window floor, so
in-flight transactions resolve TOO_OLD and retry at a fresh read version —
exactly the reference's behavior across recoveries.
"""

from __future__ import annotations

from foundationdb_tpu_torch.core.errors import FdbError
from foundationdb_tpu_torch.runtime.cluster import Generation
from foundationdb_tpu_torch.runtime.flow import Loop
from foundationdb_tpu_torch.runtime.trace import Severity, trace


class RecoveryFailed(FdbError):
    """No tlog reachable to lock — recovery version unknowable (reference:
    master_recovery_failed, error 1203)."""

    code = 1203


async def recover(loop: Loop, old: Generation, recruiter, epoch: int,
                  stage_log: "dict | None" = None) -> Generation:
    """`stage_log` (optional out-param): filled with the per-stage MTTR
    durations `lock_s`/`salvage_s`/`recruit_s` — the same breakdown the
    deployed controller records (server.py recovery_log), so sim and
    deployed recoveries report one vocabulary."""
    t0 = loop.now
    trace(loop).event("MasterRecoveryState", state="locking_tlogs",
                      epoch=epoch, old_tlogs=len(old.tlog_eps))
    # 1+2. Lock reachable tlogs; take the max frozen end version. Locks go
    # out in parallel so k unreachable tlogs cost ONE failure-detection
    # delay, not k — every extra second here widens the window in which
    # unlocked tlogs accept pushes recovery will orphan.
    tasks = [
        loop.spawn(ep.lock(), name=f"recovery.lock@e{epoch}") for ep in old.tlog_eps
    ]
    locked: list[tuple[int, object]] = []
    for ep, t in zip(old.tlog_eps, tasks):
        try:
            locked.append((await t, ep))
        except Exception:
            continue  # dead/partitioned tlog — proceed with the rest
    if not locked:
        trace(loop).event("MasterRecoveryFailed", Severity.WARN,
                          epoch=epoch, reason="no_tlog_reachable")
        raise RecoveryFailed(f"epoch {epoch}: no old-generation tlog reachable")
    recovery_version, source_ep = max(locked, key=lambda e: e[0])
    t_locked = loop.now
    trace(loop).event("MasterRecoveryState", state="salvaging", epoch=epoch,
                      recovery_version=recovery_version, locked=len(locked))

    # 3. Salvage the un-popped suffix from the most-advanced locked tlog.
    try:
        seed_entries = await source_ep.recover_entries()
    except Exception:
        raise RecoveryFailed(
            f"epoch {epoch}: tlog died between lock and salvage"
        ) from None
    t_salvaged = loop.now

    # 4. Recruit the next generation (also re-points storage servers).
    gen = recruiter.recruit_generation(
        epoch=epoch, recovery_version=recovery_version, seed_entries=seed_entries
    )
    trace(loop).event("MasterRecoveryState", state="accepting_commits",
                      epoch=epoch, recovery_version=recovery_version,
                      salvaged=len(seed_entries))
    if stage_log is not None:
        stage_log["lock_s"] = round(t_locked - t0, 6)
        stage_log["salvage_s"] = round(t_salvaged - t_locked, 6)
        stage_log["recruit_s"] = round(loop.now - t_salvaged, 6)
    return gen
