"""Cluster status document: one JSON-able snapshot of every role's health.

A copy of ``foundationdb_tpu/runtime/status.py`` for the port, its imports rewritten to
the port's modules; names and behaviour are the JAX module's.

Reference: fdbclient/StatusClient.actor.cpp + fdbserver/Status.actor.cpp —
the ``\\xff\\xff/status/json`` special key clients read for monitoring. The
shape here follows the reference's top-level sections (cluster / recovery /
workload / qos / processes) with the fields our roles actually track; every
number is fetched over the simulated network, so a partitioned or dead role
shows up as ``"reachable": false`` exactly as the reference's status marks
unreachable processes.
"""

from __future__ import annotations

from foundationdb_tpu_torch.runtime.cluster import ClusterController  # noqa: F401 (doc link)

STATUS_KEY = b"\xff\xff/status/json"


async def fetch_status(cluster, _retries: int = 3) -> dict:
    """Assemble the status document for a SimCluster (server side of the
    reference's status json machinery).

    Consistency: every endpoint/role pair is snapshotted up front, all
    probes and metric RPCs run in parallel (k dead processes cost ONE
    failure-detection delay, like the controller's sweep), and if a
    recovery swaps the generation mid-fetch the whole document is
    re-assembled so it never mixes epochs."""
    epoch_before = cluster.controller.generation.epoch
    # Snapshot all endpoints at one instant.
    grv_eps = list(cluster.grv_proxy_eps)
    commit_eps = list(cluster.commit_proxy_eps)
    resolver_eps = list(cluster.resolver_eps)
    tlog_eps = list(cluster.tlog_eps)
    storage_eps = list(cluster.storage_eps)
    ratekeeper_ep = cluster.ratekeeper_ep
    sequencer_ep = cluster.sequencer_ep

    # All metric RPCs go out in parallel over the simulated network: k dead
    # processes cost ONE failure-detection delay, and an unreachable role's
    # counters are genuinely invisible (reachable=False, no stats) — status
    # never reads role objects in-process.
    spawn = cluster.loop.spawn
    controller_t = spawn(_safe(cluster.controller_ep.get_status()), name="status.cc")
    grv_ms = [spawn(_safe(ep.get_metrics()), name="status.grv") for ep in grv_eps]
    commit_ms = [spawn(_safe(ep.get_metrics()), name="status.cp") for ep in commit_eps]
    resolver_ms = [spawn(_safe(ep.get_metrics()), name="status.res") for ep in resolver_eps]
    tlog_vers = [spawn(_safe(ep.get_version()), name="status.tlog") for ep in tlog_eps]
    storage_ms = [spawn(_safe(ep.metrics()), name="status.ss") for ep in storage_eps]
    rate_t = (
        spawn(_safe(ratekeeper_ep.get_rates()), name="status.rk")
        if ratekeeper_ep is not None
        else None
    )
    seq_t = spawn(_safe(sequencer_ep.get_live_committed_version()), name="status.seq")

    controller = await controller_t
    doc: dict = {
        "cluster": {
            "controller": (
                {"reachable": True, **controller}
                if controller
                else {"reachable": False}
            ),
            "recovery_state": _recovery_state(controller),
        },
        "workload": {
            "transactions": {"committed": 0, "conflicted": 0},
            "grvs_served": 0,
            # reordered/aborted_cycles are the wave-commit attribution
            # counters (reorder-don't-abort resolve mode; zero under
            # sequential-order resolution), conflicts the exact CONFLICT
            # verdict total they are judged against.
            "resolver": {"batches": 0, "txns": 0, "conflicts": 0,
                         "reordered": 0, "aborted_cycles": 0},
            # Resolve-dispatch scheduler backpressure (sched subsystem):
            # depth/age are the worst over resolvers (the binding signal
            # for admission), dispatch counts are cluster totals.
            "resolver_queue": {
                "depth": 0,
                "oldest_age_s": 0.0,
                "dispatch_occupancy": 0.0,
                "target_depth": 0,
                "windows_dispatched": 0,
                "batches_dispatched": 0,
            },
            # Hot-range conflict statistics (repair subsystem): the
            # proxies' aggregated decayed loss sketches, hottest first.
            "hot_ranges": [],
            "conflict_losses": 0,
            # Admission-time early conflict detection (admission
            # subsystem): probe/shape/preabort counters summed over the
            # commit proxies, false-positive accounting (shaped txns the
            # engine then committed), shaped-lane occupancy, the filter
            # saturation signal (worst proxy), GRV-side deferral ticks,
            # and the resolvers' filter feed totals.
            "admission": {
                "enabled": False,
                "probes": 0,
                "admitted": 0,
                "shaped": 0,
                "preaborted": 0,
                "shaped_committed": 0,
                "shaped_conflicted": 0,
                "shaped_too_old": 0,
                "system_bypass": 0,
                "system_shaped": 0,
                "no_shape_rejects": 0,
                "shaped_depth": 0,
                "saturation": 0.0,
                "grv_defer_ticks": 0,
                "filter_recorded": 0,
            },
            # Read plane (reads subsystem): batched-read coalescer and
            # watch-registry totals summed over the storage servers;
            # queue_depth/occupancy are the WORST instance (the binding
            # backpressure signal, like resolver_queue).
            "reads": {
                "dispatches": 0,
                "served": 0,
                "per_dispatch": 0.0,
                "queue_depth": 0,
                "occupancy": 0.0,
                "watch_count": 0,
                "watch_fires": 0,
                "too_many_watches": 0,
            },
            # Replica byte-parity audit (consistency subsystem): summary
            # of the most recent ConsistencyChecker run against this
            # cluster, or never_run.
            "consistency": (
                getattr(cluster, "consistency_status", None)
                or {"status": "never_run"}
            ),
        },
        "qos": {},
        "processes": {},
    }

    adm = doc["workload"]["admission"]
    for ep, mt in zip(grv_eps, grv_ms):
        m = await mt
        doc["processes"][ep.process] = {"role": "grv_proxy", "reachable": m is not None}
        doc["workload"]["grvs_served"] += m["grvs_served"] if m else 0
        adm["grv_defer_ticks"] += m.get("admission_defer_ticks", 0) if m else 0

    # Same range recorded at several proxies = one global hot range: merge
    # by (begin, end), summing the decayed loss mass, before ranking.
    hot: dict[tuple, float] = {}
    for ep, mt in zip(commit_eps, commit_ms):
        m = await mt
        doc["processes"][ep.process] = {"role": "commit_proxy", "reachable": m is not None}
        if m:
            doc["workload"]["transactions"]["committed"] += m["txns_committed"]
            doc["workload"]["transactions"]["conflicted"] += m["txns_conflicted"]
            for h in m.get("hot_ranges") or []:
                k = (h["begin"], h["end"])
                hot[k] = hot.get(k, 0.0) + h["score"]
            doc["workload"]["conflict_losses"] += m.get("conflict_losses", 0)
            a = m.get("admission")
            if a:
                adm["enabled"] = adm["enabled"] or bool(a.get("enabled"))
                for key in ("probes", "admitted", "shaped", "preaborted",
                            "shaped_committed", "shaped_conflicted",
                            "shaped_too_old",
                            "system_bypass", "system_shaped",
                            "no_shape_rejects"):
                    adm[key] += a.get(key, 0)
                adm["shaped_depth"] = max(
                    adm["shaped_depth"], a.get("shaped_depth", 0))
                adm["saturation"] = max(
                    adm["saturation"], a.get("saturation", 0.0))
    doc["workload"]["hot_ranges"] = [
        {"begin": b, "end": e, "score": round(s, 3)}
        for (b, e), s in sorted(hot.items(), key=lambda kv: -kv[1])[:16]
    ]

    rq = doc["workload"]["resolver_queue"]
    for ep, mt in zip(resolver_eps, resolver_ms):
        m = await mt
        doc["processes"][ep.process] = {"role": "resolver", "reachable": m is not None}
        if m:
            doc["workload"]["resolver"]["batches"] += m["batches_resolved"]
            doc["workload"]["resolver"]["txns"] += m["txns_resolved"]
            doc["workload"]["resolver"]["conflicts"] += m.get(
                "txns_conflicted", 0)
            doc["workload"]["resolver"]["reordered"] += m.get(
                "txns_reordered", 0)
            doc["workload"]["resolver"]["aborted_cycles"] += m.get(
                "txns_cycle_aborted", 0)
            q = m.get("queue") or {}
            rq["depth"] = max(rq["depth"], q.get("depth", 0))
            rq["oldest_age_s"] = max(
                rq["oldest_age_s"], q.get("oldest_age_s", 0.0)
            )
            rq["dispatch_occupancy"] = max(
                rq["dispatch_occupancy"], q.get("dispatch_occupancy", 0.0)
            )
            rq["target_depth"] = max(
                rq["target_depth"], q.get("target_depth", 0)
            )
            rq["windows_dispatched"] += q.get("windows_dispatched", 0)
            rq["batches_dispatched"] += q.get("batches_dispatched", 0)
            f = m.get("admission_filter")
            if f:
                adm["filter_recorded"] += f.get("recorded", 0)

    for ep, vt in zip(tlog_eps, tlog_vers):
        ver = await vt
        doc["processes"][ep.process] = {
            "role": "tlog",
            "reachable": ver is not None,
            "version": ver,
        }

    max_lag = 0
    for ep, mt in zip(storage_eps, storage_ms):
        m = await mt
        doc["processes"][ep.process] = {
            "role": "storage",
            "reachable": m is not None,
            **(m or {}),
        }
        if m:
            max_lag = max(max_lag, m["version_lag"])
            rd = doc["workload"]["reads"]
            mr = m.get("reads") or {}
            rd["dispatches"] += mr.get("dispatches", 0)
            rd["served"] += mr.get("served", 0)
            rd["queue_depth"] = max(rd["queue_depth"],
                                    mr.get("queue_depth", 0))
            rd["occupancy"] = max(rd["occupancy"], mr.get("occupancy", 0.0))
            rd["watch_count"] += m.get("watch_count", 0)
            rd["watch_fires"] += m.get("watch_fires", 0)
            rd["too_many_watches"] += m.get("too_many_watches", 0)
    doc["qos"]["worst_storage_version_lag"] = max_lag
    rd = doc["workload"]["reads"]
    if rd["dispatches"]:
        rd["per_dispatch"] = round(rd["served"] / rd["dispatches"], 2)

    if rate_t is not None:
        rates = await rate_t
        doc["qos"]["ratekeeper"] = {
            "reachable": rates is not None,
            # Full multi-signal picture (reference status reports the
            # limiting reason + both priority lanes' budgets).
            **(rates or {}),
        }

    seq_ver = await seq_t
    doc["processes"][sequencer_ep.process] = {
        "role": "sequencer",
        "reachable": seq_ver is not None,
        "committed_version": seq_ver,
    }
    doc["cluster"]["committed_version"] = seq_ver

    # Commit-path latency attribution (obs subsystem): the loop's span
    # sink's per-stage breakdown — sampled-txn stage histograms plus the
    # e2e-vs-sum reconciliation with the residue reported as
    # `unattributed`, never silently dropped.
    sink = getattr(cluster.loop, "span_sink", None)
    doc["workload"]["latency_breakdown"] = (
        sink.breakdown() if sink is not None else {"enabled": False}
    )

    # SLO burn + anomaly state (obs flight recorder, obs/slo.py): the
    # rolling-baseline tracker's document, honesty flags (warm-up,
    # insufficient-sample counts) included — or an explicit disabled
    # marker when no recorder is armed on this loop.
    recorder = getattr(cluster.loop, "flight_recorder", None)
    doc["workload"]["slo"] = (
        recorder.slo.status() if recorder is not None
        else {"enabled": False}
    )

    # Trace rollup (reference: status surfaces recent TraceEvent errors and
    # event counts from the cluster's trace logs).
    tracer = getattr(cluster.loop, "tracer", None)
    if tracer is not None:
        from foundationdb_tpu_torch.runtime.trace import Severity

        doc["cluster"]["messages"] = tracer.recent(
            min_severity=Severity.WARN, limit=20
        )
        doc["cluster"]["trace_event_counts"] = dict(tracer.counts)

    if cluster.controller.generation.epoch != epoch_before and _retries > 0:
        return await fetch_status(cluster, _retries - 1)  # mid-fetch recovery
    return doc


def _recovery_state(controller_status: dict | None) -> dict:
    """Reference: the recovery_state section (name + description)."""
    if not controller_status:
        return {"name": "unknown", "healthy": False}
    if controller_status.get("recovering"):
        return {"name": "recovering", "healthy": False}
    return {
        "name": "fully_recovered",
        "healthy": True,
        "epoch": controller_status.get("epoch"),
    }


async def _safe(fut):
    try:
        return await fut
    except Exception:
        return None
