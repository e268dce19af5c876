#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA conflict engine on one NVIDIA card.

    python3 chip_smoke.py [--seed N] [--batches N]

Phases, each fatal on failure:

1. Device: the card's name and power limit; the kernel build, timed.
2. Per kernel: K1-K4, every launch of each, on inputs captured from the
   YCSB-A stream at its full shapes (B = 8192, R = 2, Q = 1, 12-byte keys,
   capacity 2^20), plus one forced fold and one report chunk, K2's table
   over the delta, the base and gated off (its CUDA launches a build
   printed as ``k2_table_launches``), K3's stats build on the captured
   batch (``k3_phase_clocks``: overlap and settle ms, edgeful and pending
   rows, relaxation rounds, walk steps) and K3 on the dense worst case
   (every txn reads and writes one key) and on a 32,768-txn batch of the
   stream, each against its plain version and timed; and K5/K6
   (wave_pred, wave_level) on a batch captured from a wave engine on the
   same stream, whose levels must also equal the host replay
   (``core/wavemesh.level_wave_graph``) of the unpacked K5 matrix, run in
   a worker process beside phases 3-4 and checked before step 5; K12's
   search and K5 on adversarial inputs (``k12_k5_adversarial``: live
   prefixes of 0 and C rows, runs of equal rows, all-INT32_MAX queries,
   sorted and unsorted queries around the tile sizes, W = 1, 4, 9, 24,
   both history forms, plans forcing each of K12's branches and a span
   one row over the shared budget; K5 on B not a multiple of 32, rows
   with no live write, a wide R, every interval equal, live empty
   intervals and few candidates); each output must equal the plain torch
   version's on the same card, bit for bit.
3. End to end: a 1M-txn YCSB-A stream (128 batches x 8192, scrambled
   Zipf-0.99 over 2^20 keys) through TorchConflictSet on cuda, with the
   Resolver's headroom fail-safe before each batch; K1-K4 must launch and
   the history must not overflow.
3b. Window path: the same stream in the resolver wire format through the
   bench's runner (``foundationdb_tpu_torch.bench``: window 8, 4 windows
   in flight, packing on a worker thread); per window K3 must launch k
   times and K1's insert at most once, and K1-K4 and the window program
   must launch. Then, each fatal: per-batch ``resolve_wire`` on cuda
   gives the same verdict hash; the first window on the CPU equals the
   card's; the mako and tpcc shapes, 16 batches at window 4, give equal
   verdicts on cuda and the CPU; one captured window program (A14,
   ``resolve_many_res``) equals its plain version in every verdict and
   state leaf.
3c. Wave phase: the same wire stream through the same runner on a
   ``wave_commit=True`` engine; K5 and K6 must launch once per batch,
   K1, K2 and K4 must launch, K3 must not, and the history must not
   overflow. Then, each fatal: (a) per-batch ``resolve_wire`` on cuda
   gives the same verdict hash and levels; (b) window 0 on the CPU equals
   the card's in verdicts, levels and every state leaf; (d) mako and
   tpcc, 8 batches at window 4, give equal verdicts and levels on cuda
   and the CPU; (e) two wave shards on the card, fed the
   ``wavemesh.clip_txns`` halves of 8 batches through ``resolve_edges``
   / ``combine_edges`` / ``resolve_apply``, give the single wave
   engine's verdicts and ``last_wave``. K6's stats build on phase 2's
   captured batch prints its phase counters (``k6_phase_clocks``: the
   prologue with the first wave, the level kernel's wave and stall rounds,
   the stalls' prefix, walk, rescan and release time, and the counts).
   (g) The stream's first 16 batches of 32,768 txns (K6's round state
   then lives in global scratch, not shared memory) through a cuda wave
   engine on the object path: every batch's K6 levels equal the host
   replay (``wavemesh.level_wave_edges`` of its K5 matrix, in the workers
   beside the later phases, checked after phase 4), and the last batch's
   K6 output and stats equal ``wave_level_plain``; K6's time on it and
   the run's txns/s are printed.
3d. Tiered phase: the YCSB-A shape over 2^23 keys (the touched set
   outgrows the hot tier; ``loadgen/ycsb.dictionary_counts`` checks the
   sizing first) through the same runner on an engine with a tiered
   dictionary (hot tier 1,310,720 keys, 262,144 delta slots) and
   speculative resolve (depth 2, every window confirmed). (a) Its verdict
   hash equals an untiered engine's with the same delta slots; it
   demotes (>= 3 events), never full-repacks, repairs nothing; K7 launches
   once a demotion event (one K1 rewrite beside it) and K3 k times per
   window. (b) Every K7 launch of (a) equals the plain version in the
   dictionary, n_keys and every rank leaf, and K7's tile twin
   (``dict_evict_tiles_plain``) in the dictionary, n_keys and shift. (c)
   With a hook that revokes the first accepted txn of every window, 16
   batches at window 4 and depth 3 on cuda equal depth 1 on cuda and
   depth 3 on the CPU (worker processes beside phase 4, checked after
   it) in verdicts, spec_metrics (depth 1 has no younger window to flip)
   and every state leaf, sequentially and on wave engines (levels too).
   (c′) The same adversary across demotions: check (c)'s stream on a
   tiered speculative engine sized from its own ``dictionary_counts``
   (``spec_tier``: MVCC window SPEC_K, a hot tier that fills at window
   1, evict chunks of a quarter delta) demotes at least twice and repairs
   at least one window; depth 3 on cuda equals depth 1 on cuda and depth
   3 on the CPU (workers beside phase 4) in verdicts, levels,
   spec_metrics, dict_stats and every state leaf, sequentially and on
   wave engines; one K7 launch a demotion event, each equal to the plain
   version and the tile twin.
   (d) One captured paint-only window (``paint_many_res``, forced mask)
   equals its plain version in every state leaf.
3e. Sharded phase: the stream of 3b through the same runner on a
   ``ShardedConflictSet`` of 4 keyspace shards on the card (capacity 2^20
   per shard, split at the density quantiles of a stream sample, as the
   bench's ``--resolvers 4``). (a) Its verdict hash equals 3b's single
   engine's; per window K8 and K3 launch k times, K9 k times, K4's paint
   4k times, K1's insert at most once; no shard overflows and
   ``shard_occupancy`` is printed. (b) The same stream starting on
   uniform splits, resharded to the density splits at its middle: the
   same hash, shards moved. (c) A 4-shard wave engine over the first 16
   batches equals 3c's single wave engine in verdicts and levels; the
   exchange (K10) is K5's OR mode, S launches a batch, never
   ``sh_exchange``, and every fused exchange of the run (the OR matrix and
   the stats) equals ``wave_exchange_plain`` of the shards' stacked plain
   matrices; 0 < occupied tiles <= total tiles. (d) One
   captured step launch by launch (K9 with and without the reads, through
   its checked entry and as the window program launches it, into buffers
   allocated and checked once a window; K8 over the shards' live rows,
   also against the plain twin of its algorithm and at full shards,
   n_used = C, with its live table's and probe's device times and the
   table's bytes printed; K5's plain store per shard, the fused exchange)
   and one captured sharded window program equal their plain versions bit
   for bit, every state leaf included. (e) Window 0 on the CPU (a worker process beside phase 4,
   checked after it) equals the card's in verdicts and every state leaf.
3f. Admission phase: (a) the first 32 batches of the stream on the
   object path through a resident cuda engine with a device-backend
   ``RecentWritesFilter`` attached (2^20 bits, 4 banks over the stream's
   MVCC window, so the banks rotate): phase 3's verdicts, K11 launched,
   the saturation printed. (b) The banks, bank bounds and counters equal
   a numpy filter fed the same fingerprints, and every K11 launch of one
   captured batch (the bank clear of its rotation, the set), a probe and
   a count of its banks equal the plain versions. (c) A tiered resident
   engine with a filter (hot tier sized by ``ycsb.dictionary_counts``,
   MVCC window 8) over 24 batches demotes, and its verdicts, dict_stats
   and banks equal the same run on the CPU (a worker beside phase 4).
3g. Non-resident phase (``resident=False``): (a) the stream of 3b through
   the same runner: 3b's hash, no overflow, per window K12's search and
   probe, K13's paint and K3 k times, never K1, K2's probe or K4. (b) A
   non-resident wave engine over 16 batches equals 3c's verdicts and
   levels. (c) Check (c)'s adversary on a non-resident speculative engine
   (window 4): depth 3 equals depth 1 on cuda and depth 3 on the CPU (a
   worker beside phase 4) in verdicts, spec_metrics, every state leaf and
   the dependency probe's answers, which are printed (windows found clean
   and dependent). (d) One ``kp_pack_window`` window equals
   ``_pack_dict`` leaf for leaf. (e) One captured step launch by launch
   (K13's gated fold step, its fold needed and not; K12's search of base
   and delta and its probe with the live table it builds, and the probe
   of one flat level and the dependency probe over the window; K13's
   packed paint; a forced K13 fold, of the step's history and of a full
   base of 2^20 rows; K13's compaction) and one captured window program
   equal their plain versions bit for bit (the probe and the paint also
   their algorithms' twins), each call's CUDA kernels counted at launch
   (3 a gated step, 2 a probe, 3 a paint, 2 a forced fold or a
   compaction) and their sum outside K3 printed.
3h. Non-resident sharded phase (``ShardedConflictSet(n_shards=4,
   resident=False)``: full-key batches, four flat [2^20, 4] shard
   histories): (a) the stream of 3b through the same runner: 3b's hash,
   no overflow, per window K16, K15, K14's ranks and K3 k times and the
   unpacked paint (K13's keys, K12's search, K14's sort, K13's sorted
   paint) 4k times, never K1, K2, K4, K8 or K12's probe;
   ``shard_occupancy`` printed; every K15 launch (the window program's,
   into its window buffers) equals ``word_clip_plain``. (b) The same stream starting on uniform
   splits, resharded to the density splits at its middle: the same
   hash. (c) A 4-shard non-resident wave engine over 16 batches equals
   3c's verdicts and levels, its exchange K5's OR mode (never
   ``sh_exchange``), every K15 launch and fused exchange equal to the
   plain twins. (d) One captured step launch by launch (K16
   over the shards' live rows as K8 in 3e(d), K15 with and without the
   reads, through its checked entry and into the window's buffers
   (``WordWindowClip``), K14's ranks, its
   sort of one shard's paint rows, K13's sorted paint, each shard's whole
   paint) and one captured window program equal their plain versions bit
   for bit, every state leaf included. (e) Window 0 on the CPU (a worker
   process beside phase 4, checked after it) equals the card's in
   verdicts and every state leaf.
3i. Design-arm phase (the JAX FDB_TPU_* knobs as constructor arguments):
   the stream of 3b through the same runner on (a) ``history="batch"``
   (the flat [2^20, 1] rank history, K2's table over all its versions
   every batch, no fold), (b) ``rmq="blocked"`` on the default engine
   (K17's one-launch build over the delta's live rows, K12's rank
   searches, K17's probe; never K2's probe) and on (a) (K17 at 2^20,
   never K2), (c) ``packed=False`` (the
   unpacked window-history engine: K14's ranks, two K16 probes, the
   unpacked paint, K13's width-4 gated fold step) and ``packed=False,
   history="batch"``, (d) ``resident=False, history="batch"`` (the packed
   flat arm: K12's probe with a table over the flat history's live rows,
   never K2) and (e) ``accept="seq"``: each 3b's hash, no overflow, its
   kernel entries k times per window and never the replaced ones, one
   captured window program equal to its plain version bit for bit, its
   txns/s, p50/p99 and program ms printed. K17's full build and query at
   N = 16,386 and 2^20 held against ``block_table`` / ``range_max_blocked``
   (random, empty, one-block and out-of-range bounds); its live build and
   queries over the flat arm's history and the two-level arm's delta
   against the plain twin (``block_table_live``) and the full-array
   ``range_max_blocked`` (queries past n_used, ending at C, empty); its
   probe, flat and two-level, and the flat step (live build + probe)
   against their plain versions, the step timed beside the parent
   design's build over all rows + query; K14 at W = 1 with
   payloads (``sort_ranks_with_payload``) too, and K12 at W = 1 (the
   flat blocked arm's rank search of the step's slot begin and end ranks)
   against the plain search and ``torch.searchsorted`` left and right,
   timed. (d) also speculating:
   check (c)'s adversary at depth 3 equals depth 1, and the dependency
   probe finds a clean younger window (repaired paint-only). (f) Wave
   twins on 16 batches: ``packed=False, wave_commit=True`` on the window
   path, and the packed flat engine through the two-phase protocol on two
   shards, equal to 3c's verdicts and levels.
3j. Read-plane phase (YCSB-B/C reads: YCSB core workloads B and C, and
   the op stream of the JAX reads/bench.py): a port ``VersionedMap`` of
   2^20 keys ``ycsb/%08d`` with 64 versions of Pareto-hot value updates,
   its [2^20, 9] int32 mirror resident on the card. (a) 24 closed-loop
   clients under the port's ``Loop`` through ``ReadCoalescer`` and
   ``TorchReadSet`` on cuda: 95% multi-gets of 16 keys (log-uniform hot
   head), 5% scans of 1-16 rows, at read versions spread over the map;
   every answer equals the scalar oracle's and the host arm's, the mirror
   uploads once, K12's search launches once per search (one or two per
   dispatch: the points and the ranges of a dispatch); reads/s, reads per
   dispatch and p50/p99 dispatch ms printed. (b) 10^6 armed watches on
   the device arm, 64 versions of 64 written keys (some changed, some
   never armed) and one cancel of a quarter of the keys: fire sets, the
   cancelled entries and the counters equal arms "1" and "0" (arm "0"
   counts no searched keys, only the device arm uploads); K12 once a
   sweep; sweep ms per version printed. (c) K12's read-plane search on
   one dispatch's query rows, random rows, truncated equal-prefix keys,
   k = 1, a query above every row and an empty mirror, bit for bit
   against the plain two-sided search, and timed.
3k. Sharded-arm phase: the stream of 3e (resident) and of 3h
   (non-resident) on 4 shards through the same runner on
   ``ShardedConflictSet(rmq="blocked")``, ``(resident=False,
   rmq="blocked")`` and ``(packed=False)``: each 3b's hash, no overflow,
   its kernel entries k (or S·k) times per window and never the replaced
   ones (a blocked arm: K17's sharded probe once a step, never its
   separate build, K2, K8 or K16), one captured window program equal to
   its plain version bit for bit with every state leaf, K17's sharded
   probe at the captured step and at full shards (n_used = C) equal to
   its plain version, to its algorithm's plain twin and (captured) to the
   sparse arm's answer, two CUDA kernels a call counted at launch (at
   most two by the profiler), txns/s, p50/p99 and program ms
   printed; and a 16-batch ``packed=False, wave_commit=True`` sharded
   twin equal to 3c's verdicts and levels. Every K15 launch of the
   non-resident arms and every fused exchange of the wave twin equal the
   plain twins.
3l. Baseline phase (the north star's CPU SkipList, ported as
   ``models/cpu_conflict_set.py`` over ``native/skiplist.cpp``): (a) the
   pinned baseline (``bench.CPU_BASELINE_PIN``: YCSB-A, 262,144 txns,
   2^16 keys, seed 20260729) through the skiplist a batch a call, and the
   same stream through the window path on the card (window 8, best of
   3): txns/s, p50 and p99 (per batch for the skiplist, per window for
   the card), ``vs_baseline`` and the verdict parity; (b) the skiplist
   over 3b's stream, its verdict hash equal to 3b's. A differing verdict
   fails the phase and names the first differing txn.
3m. Commit-path phase (``sim/commit_path.py``): one generation of the
   commit path on one ``Loop`` (a sequencer, R resolvers over
   ``server.make_conflict_set("torch")``, the deployed engine at capacity
   2^16 and batch 512, the commit and GRV proxies, a tlog, two storage
   servers with their read plane and watches on the card, the ratekeeper,
   uniform shard maps) under 512 closed-loop YCSB-A clients over 2^20
   12-byte keys (a GRV, a ``get`` of each read key, a commit). Runs: (a)
   R = 1, 65,536 commits; (b) R = 2, the proxy's AND of clipped verdicts;
   (c) R = 2 with wave commit (``resolve_edges``/``resolve_apply``); (d)
   R = 1 over a speculative engine (depth 2) under a resolver queue with
   a 5 ms budget (``_dispatch_group_spec``); (b)-(d) 16,384 commits. Each
   fatal: no outcome but committed, conflict or too old; every
   acknowledged write read back through its storage server's read plane
   (``get_multi``, K12) at the last committed version equal to the host
   replay of the commits in version and (wave, index) order; no fail-safe
   and no overflow on any resolver; K1-K4 launched on (a), (b), (d), K5
   and K6 and never K3 on (c), K12 by the read plane; the group path on
   (d). Printed: each run's wall s, commits/s, committed share, the p50
   and p99 wall ms of the resolver's dispatch of a proxy batch, the
   launches. Each run again over the plain versions on the CPU and over
   ``IndexedOracleConflictSet`` (workers beside phase 4, checked after
   it): the same ``commit_outcomes_sha256`` and reads, and on the CPU the
   same roles' metrics and every engine leaf.
3n. Cluster phase (``sim/cluster.py`` ``SimCluster`` on its defaults:
   each generation's engines, ``new_conflict_set("torch")`` at capacity
   2^14 and batch 256, and both storage servers' read plane on the card):
   3 coordinators and an elected cluster controller, 2 tlogs, 2 storage
   servers in one team, under 256 closed-loop YCSB-A clients over 2^20
   12-byte keys, each transaction through the client library
   (``open_database(c).run``: ``tr.get_multi`` of its reads, ``tr.set``
   of its write, the commit; ``sim/cluster_load.py``), with kills at
   counts of finished transactions. Runs: (a) one resolver, 8,192
   transactions, ``resolver0`` killed at 1/3 and ``tlog0`` at 2/3; (b)
   two resolvers with wave commit, 4,096, ``resolver1`` killed at 1/2.
   Each fatal: epochs 1 to 3 and 1 to 2, each recovered epoch's first
   commit at least ``EPOCH_VERSION_JUMP`` past its recovery version; no
   transaction given up; every acknowledged write read back through
   ``tr.get_multi`` (K12) equal to the host replay in version and (wave,
   index) order; in each generation K1-K4 on (a), K5 and K6 and never K3
   on (b), and K12; no fail-safe and no overflow. Printed: wall s,
   transactions/s, committed share, retries and error codes, each
   recovery's virtual and wall time from the kill to the new epoch's
   first commit, the new resolvers' first dispatch and longest dispatch
   up to it, ``torch.cuda.memory_allocated()`` at it (before and after a
   gc), the launches by generation. Each run again over the plain
   versions on the CPU and over the oracle (workers beside phases 3m-4,
   from the end of phase 3l; checked after phase 4), the read plane on
   its host arm: the same ``cluster_outcomes_sha256``.
3o. Specs phase (``sim/specs.py``, ``sim/workloads.py``, ``sim/run.py``:
   the repository's TOML simulation specs, each [[test]] on a fresh
   ``SimCluster`` on its defaults, every generation's engines and the read
   plane on the card, under the seeded ``FaultInjector``'s kills (the
   controller's too), partitions and clogs and BUGGIFY as each test asks).
   (a) Every [[test]] of tests/specs/*.toml through the port's
   ``run_one`` at the run's seed: each ported test passes its workloads'
   own checks; each test whose workload or cluster arm is not ported
   (``SPEC_REFUSED``) raises ``NotImplementedError`` naming its module.
   (b) One spec at scale (``SPEC_B``): Chaos.toml's ChaosMultiResolver
   faults and cluster (3 tlogs, 3 storages, 2 replicas, 3 coordinators, 2
   resolvers, 2 proxies) under mako's 90/10 mix over 16,384 rows (1,024
   transactions, 64 clients), YCSB-B over 2,048 keys (1,024, 64;
   ``get_multi`` through K12), TPC-C new-order over 4 warehouses of 10
   districts and 2,048 items (512, 32) and Cycle over 1,024 nodes (512,
   32), at once (``SPEC_B_CUT_FROM``: the keys and items for the MVCC
   window, the transaction counts to a quarter for time). Each fatal:
   every workload's own check (Cycle's ring, TPC-C's dense order ids and
   stock conservation, mako's read-your-committed, YCSB's ``get_multi``
   parity); no transaction given up; no fail-safe and no overflow; K1-K4
   in every generation whose resolvers resolved a transaction; in (b) at
   least one kill and a recovery to a higher epoch after it, and K12.
   Printed: wall s and committed transactions/s of wall by run, test and
   workload; retries by error code; the kills, partitions and clogs, each
   kill with the virtual and wall s to its new epoch's first acknowledged
   commit; dispatch p50/p99 ms; launches by kernel; memory_allocated at
   the start and the end. Each run again over the plain versions on the
   CPU, over the oracle given the ranges the engine resolves (its pack
   widens a transaction of more than 8 read or write ranges) and over the
   oracle on the exact ranges (workers, (b) on the CPU from the end of
   phase 2, the others from the end of 3l; checked after phase 4): the
   same ``spec_outcomes_sha256`` on the first two;
   on the exact oracle the same record for every test none of whose
   transactions was widened.
4. Cross-check: the first 16 batches again on the CPU (plain versions),
   and 16 batches each of the mako and tpcc shapes on cuda against the
   CPU: the verdicts must be equal; then the CPU halves of 3d, 3e, 3f,
   3g, 3h, 3m, 3n and 3o (in workers from the end of phase 3l, beside
   phases 3m-4, but 3o(b)'s on the CPU, which starts at the end of phase
   2).
5. The seconds of each phase, a ``kernels`` JSON line (K1-K4, the
   window program, K5, K6, K7, the paint-only window, K8, K9, K10 (K5's
   OR mode), the sharded window program, K11, K12, K13, the non-resident window
   program, K14, K15, K16, K13's sorted paint, the non-resident
   sharded window program, K17 and each design arm's window program,
   K12's read-plane search and its W = 1 rank search, K17's two sharded
   probes and each sharded arm's window program), then the card line,
   then the result line.

Exits non-zero, printing no result, when no CUDA card is available or when
run without the rest of the repository.
"""

from __future__ import annotations

import argparse
import faulthandler
import hashlib
import json
import math
import multiprocessing
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
SCALAR_OPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores
N_KEYS = 1 << 20
REPLACES = {
    "dict_insert": "foundationdb_tpu/models/conflict_kernel.py:1948",
    "history_probe": "foundationdb_tpu/models/conflict_kernel.py:2161",
    "accept": "foundationdb_tpu/models/conflict_kernel.py:472",
    "step_compact": "foundationdb_tpu/models/conflict_kernel.py:2196",
    "resolve_many": "foundationdb_tpu/models/conflict_kernel.py:2291",
    "wave_pred": "foundationdb_tpu/models/conflict_kernel.py:739",
    "wave_level": "foundationdb_tpu/models/conflict_kernel.py:776",
    "dict_evict": "foundationdb_tpu/models/conflict_kernel.py:2026",
    "paint_many": "foundationdb_tpu/models/conflict_kernel.py:2788",
    "shard_probe": "foundationdb_tpu/parallel/sharded_resolver.py:188",
    "shard_clip": "foundationdb_tpu/models/conflict_kernel.py:2109",
    "wave_exchange": "foundationdb_tpu/parallel/sharded_resolver.py:169",
    "sharded_many": "foundationdb_tpu/parallel/sharded_resolver.py:249",
    "admission": "foundationdb_tpu/admission/filter.py:158",
    "word_probe": "foundationdb_tpu/models/conflict_kernel.py:1445",
    "word_probe_probe": "foundationdb_tpu/models/conflict_kernel.py:1597",
    "word_compact": "foundationdb_tpu/models/conflict_kernel.py:1489",
    "word_compact_fold_step": "foundationdb_tpu/models/conflict_kernel.py:"
                              "1290",
    "word_compact_fold_forced": "foundationdb_tpu/models/conflict_kernel.py:"
                                "1404",
    "packed_many": "foundationdb_tpu/models/conflict_kernel.py:1672",
    "word_sort": "foundationdb_tpu/models/conflict_kernel.py:291",
    "word_sort_paint": "foundationdb_tpu/ops/lex.py:160",
    "word_clip": "foundationdb_tpu/models/conflict_kernel.py:1028",
    "word_shard_probe": "foundationdb_tpu/parallel/sharded_resolver.py:115",
    "word_paint_sorted": "foundationdb_tpu/models/conflict_kernel.py:925",
    "nr_sharded_many": "foundationdb_tpu/parallel/sharded_resolver.py:551",
    "rmq_blocked": "foundationdb_tpu/ops/rmq.py:104",
}
# The kernel sources each path launches: the sequential-order paths run
# K1-K4, the wave paths K1, K2, K4 and K5/K6 (wave.cu), never K3.
SEQ_SOURCES = ("dict_insert", "history_probe", "accept", "step_compact")
WAVE_SOURCES = ("dict_insert", "history_probe", "step_compact", "wave")
# Phase 3e: the sharded engine's (its "shard" source added by counted_run;
# no K2: K8 builds its own table over the shards' live rows).
SHARD_SEQ = ("dict_insert", "accept", "step_compact")
SHARD_WAVE = ("dict_insert", "step_compact", "wave")
WINDOW_K, WINDOW_DEPTH = 8, 4  # window phase: batches per window, in flight
CAP = 1 << 20
# Tiered phase: a keyspace whose touched set outgrows the hot tier H while
# the MVCC window's set plus one delta M fits in it, and every window's
# delta fits in M (dictionary_counts checks the three before the run).
TIER_KEYS = 1 << 23
TIER_HOT, TIER_DELTA = 1_310_720, 262_144
TIER = {"dict_hot_capacity": TIER_HOT, "dict_delta_slots": TIER_DELTA}
SPEC_K, SPEC_BATCHES = 4, 16  # check (c): window, batches
SHARDS = 4  # phase 3e: keyspace shards on the card (a 4-resolver config)
# Check (g) of phase 3c: a wave batch four times the stream's, too large
# for K6's round state to fit in one block's shared memory (it then lives
# in global scratch), on the stream's first BIG_WAVE_BATCHES such batches.
BIG_WAVE_BATCH, BIG_WAVE_BATCHES = 32768, 16
# Checks (d) and (e) of phase 3c: mako's and tpcc's wave window path on
# cuda and the CPU, and the two-phase protocol on two shards, over this
# many batches (the smoke's time limit sets it: the CPU halves of (d)
# take most of phase 3c).
WAVE_CROSS_BATCHES = 8
# Phase 3f: the admission filter's geometry (2^20 bits: the repository's
# default of 2^16 saturates at 8192-txn batches), the object-path batches
# it is fed, the one whose K11 launches are captured (the 17th record: its
# version opens a new bank, so a clear launches too), and the tiered
# engine's batches and MVCC window (short, so that keys age out of it).
ADM = {"bits_log2": 20, "banks": 4}
ADM_BATCHES, ADM_CAPTURE = 32, 17
ADM_TIER_BATCHES, ADM_TIER_WINDOW = 24, 8
# Phase 3g: the kernel sources the non-resident window path launches (K2
# only for the base's table after a fold; K1 and K4 never).
NR_SEQ = ("history_probe", "accept", "word_probe", "word_compact")
NR_WAVE = ("history_probe", "wave", "word_probe", "word_compact")
# The entries a packed window never launches: K1, K2's probe, K4, and a
# fold apart from its decision and reset (the gated step is one entry,
# ``wc_fold_step``; ``wc_fold`` is the forced fold of advance_hist).
NR_NEVER = ("di_insert", "sc_paint", "hp_probe", "sc_need", "sc_fold",
            "sc_fold_step", "wc_fold")
# Phase 3h: the kernel sources the non-resident sharded window path
# launches (K12 for the paint's search; K1, K2, K4, K8 and K12's probe
# never: K16 builds its own table over the shards' live rows).
NRS_SEQ = ("accept", "word_probe", "word_compact", "word_sort",
           "word_shard")
NRS_WAVE = ("wave", "word_probe", "word_compact", "word_sort",
            "word_shard")


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def clone(tree):
    import torch

    if isinstance(tree, torch.Tensor):
        return tree.clone()
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone(x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(clone(x) for x in tree)
    return tree


def leaves(tree, prefix=""):
    import torch

    if isinstance(tree, torch.Tensor):
        return {prefix: tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        out = {}
        for f in tree._fields:
            out.update(leaves(getattr(tree, f), f"{prefix}.{f}"))
        return out
    out = {}
    for i, x in enumerate(tree):
        out.update(leaves(x, f"{prefix}[{i}]"))
    return out


MAX_ABS_ERR: dict[str, int] = {}


def assert_equal(name: str, got, want) -> None:
    """Every output leaf of the kernel equals the plain version's; records
    the largest absolute difference under the kernel's name (0 or fail)."""
    g, w = leaves(got), leaves(want)
    if g.keys() != w.keys():
        fail(f"{name}: output structure differs")
    kernel = name.split(".")[0]
    for k in g:
        a, b = g[k], w[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            fail(f"{name}{k}: shape/dtype {a.shape} {a.dtype} vs "
                 f"{b.shape} {b.dtype}")
        diff = (a.long() - b.long()).abs().reshape(-1)
        err = int(diff.max()) if diff.numel() else 0
        MAX_ABS_ERR[kernel] = max(MAX_ABS_ERR.get(kernel, 0), err)
        if err:
            i = int((diff != 0).nonzero()[0, 0])
            fail(f"{name}{k}: kernel differs from its plain version at flat "
                 f"index {i}: {a.reshape(-1)[i].item()} vs "
                 f"{b.reshape(-1)[i].item()} ({int((diff != 0).sum())} "
                 f"differ)")


def bound(nbytes: float, ops: float = 0.0) -> tuple[float, str]:
    """(least ms, what bounds it): the larger of bytes over the memory
    rate and operations over the scalar rate."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / SCALAR_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def time_ms(fn, setup=None, reps: int = 10) -> float:
    """Mean device time of ``fn`` (CUDA events; inputs made outside)."""
    import torch

    args = setup() if setup else ()
    fn(*args)  # warm-up
    total = 0.0
    for _ in range(reps):
        args = setup() if setup else ()
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn(*args)
        e.record()
        torch.cuda.synchronize()
        total += s.elapsed_time(e)
    return total / reps


def cuda_kernels(fn, setup=None, reps: int = 5) -> dict:
    """CUDA kernels one call of ``fn`` launches and their device ms (in all,
    and by kernel name), from ``torch.profiler`` (copies and fills of device
    memory apart); a call that rewrites its state gets a copy made by
    ``setup`` before the profiled span. A profile that saw no device time
    is taken again, up to three times (then its zeros stand)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):  # the profiler has been seen to miss every kernel
        args = [setup() if setup else () for _ in range(reps + 1)]
        fn(*args[0])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for a in args[1:]:
                fn(*a)
            torch.cuda.synchronize()
        launches = device_us = 0.0
        by_name = {}
        for ev in prof.key_averages():
            us = getattr(ev, "device_time_total", None)
            if us is None:
                us = ev.cuda_time_total
            if us and not ev.key.startswith(("Memcpy", "Memset")):
                launches += ev.count
                device_us += us
                by_name[ev.key] = us / 1e3 / reps
        if device_us:
            break
    return {"launches": launches / reps, "device_ms": device_us / 1e3 / reps,
            "kernels": by_name}


# What K8's and K16's rows in the kernels line add (live_probe_report).
LIVE_PROBE_KEYS = ("table_ms", "probe_only_ms", "device_ms", "cuda_kernels",
                   "kernels_counted", "live_rows", "full_shard_ms",
                   "full_shard_device_ms")


def live_probe_report(fn, s: int, c: int, n_used: list) -> dict:
    """K8's or K16's call ``fn`` on the card: the device ms of its live
    table's build (``lp_build``) and of its probe (``lp_probe``), the CUDA
    kernels a call launches (by the profiler, and as ``lp_run`` counts its
    launches), the shards' live rows, the int32 words the live table of
    ``s`` shards of capacity ``c`` takes, and the bytes of the workspace
    scratch that holds it, read after the call."""
    import torch
    from foundationdb_tpu_torch import kernels as K

    prof = cuda_kernels(fn)
    counted = K.LIVE_PROBE_KERNELS["last"]
    held = K._workspace(torch.device("cuda"), 0)[1].numel() * 4

    def device(part):  # None: the profiler saw no kernel (not measured)
        if not prof["device_ms"]:
            return None
        return sum(ms for name, ms in prof["kernels"].items() if part in name)

    return {"table_ms": device("lp_build"), "probe_only_ms": device(
        "lp_probe"), "device_ms": device(""),
        "cuda_kernels": prof["launches"] if prof["device_ms"] else None,
        "kernels_counted": counted, "live_rows": n_used,
        "table_words": K.live_table_words(s, c), "workspace_bytes": held}


def check_live_probe(name: str, r: dict) -> None:
    """K8's or K16's call launches its live table's build and its probe,
    two CUDA kernels (the parent design launched four and a memset), as
    ``lp_run`` counts them at their launches and, where it saw them, as
    the profiler does; and the workspace holds the live table."""
    seen = r["cuda_kernels"]
    if r["kernels_counted"] != 2 or (seen is not None and seen > 2):
        fail(f"{name}: {r['kernels_counted']} CUDA kernels a call counted "
             f"at launch (profiler: {seen}), want 2")
    if r["workspace_bytes"] < 4 * r["table_words"]:
        fail(f"{name}: workspace {r['workspace_bytes']} bytes, the live "
             f"table needs {4 * r['table_words']}")


def print_live_probe(name: str, r: dict, c: int) -> None:
    """One line of K8's or K16's ``live_probe_report`` and full-shard
    times (device numbers the profiler did not see: "not measured")."""
    def ms(x):
        return "not measured" if x is None else f"{x:.4f}"

    print(f"kernel {name}: live rows {r['live_rows']} of C = {c}; device "
          f"ms: live table {ms(r['table_ms'])}, probe "
          f"{ms(r['probe_only_ms'])} ({r['kernels_counted']} CUDA kernels "
          f"a call counted at launch, {r['cuda_kernels']} by the profiler);"
          f" the live table {4 * r['table_words']} bytes (live_table_words),"
          f" held in a workspace scratch of {r['workspace_bytes']} bytes "
          f"read after the call; full shards (n_used = C) "
          f"{ms(r['full_shard_ms'])} ms ({ms(r['full_shard_device_ms'])} ms "
          f"of device)")


def full_shards(s: int, c: int, w: int, b: int, r: int, seed: int):
    """Every one of ``s`` shards full (n_used = c) and a batch of ``b``
    txns of ``r`` reads over them, on the card: (hist, read_begin,
    read_end, read_mask, read_version, txn_mask, lo, hi). ``w`` = 0: rank
    histories [S, C, 1] (K8; shard d's keys 2c·d + 2i, reads [B, R]);
    else [S, C, W] word rows (K16; shard d's rows (d, 2i, 0, ...) from lo
    = (d, INT32_MIN, ...), reads [B, R, W]). Most reads cover 1-3 keys,
    one in 64 up to a whole shard (the live table's top); versions and
    read versions in [0, 1000)."""
    import torch

    from foundationdb_tpu_torch.models import conflict_kernel as ck

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(lo_, hi_, shape):
        return torch.randint(lo_, hi_, shape, generator=g, device=dev,
                             dtype=torch.int32)

    i = torch.arange(c, dtype=torch.int32, device=dev)
    span = torch.where(rand(0, 64, (b, r)) == 0, rand(1, 2 * c, (b, r)),
                       rand(1, 6, (b, r)))
    if w == 0:
        lo = torch.arange(s, dtype=torch.int32, device=dev) * 2 * c
        keys = (lo[:, None] + 2 * i[None, :])[..., None].contiguous()
        hi = torch.cat([lo[1:], torch.full((1,), ck.INT32_MAX,
                                           dtype=torch.int32, device=dev)])
        rb = rand(0, 2 * c * s, (b, r))
        re_ = rb + span
    else:
        lo = torch.full((s, w), -2**31, dtype=torch.int32, device=dev)
        lo[:, 0] = torch.arange(s, dtype=torch.int32, device=dev)
        hi = torch.cat([lo[1:], torch.full((1, w), ck.INT32_MAX,
                                           dtype=torch.int32, device=dev)])
        keys = torch.zeros((s, c, w), dtype=torch.int32, device=dev)
        keys[:, :, 0] = torch.arange(s, dtype=torch.int32, device=dev)[:,
                                                                         None]
        keys[:, :, 1] = 2 * i
        rb = torch.zeros((b, r, w), dtype=torch.int32, device=dev)
        rb[..., 0] = rand(0, s, (b, r))
        rb[..., 1] = rand(0, 2 * c, (b, r))
        re_ = rb.clone()
        re_[..., 1] += span
    hist = ck.ConflictState(
        keys, rand(0, 1000, (s, c)), torch.full((s,), c, dtype=torch.int32,
                                                device=dev),
        torch.zeros(s, dtype=torch.int32, device=dev),
        torch.zeros(s, dtype=torch.bool, device=dev))
    return (hist, rb, re_, rand(0, 8, (b, r)) != 0, rand(0, 1000, (b,)),
            torch.ones(b, dtype=torch.bool, device=dev), lo, hi)


def make_engine(mode, device, wave: bool = False):
    from foundationdb_tpu_torch.bench import make_engine as bench_engine

    return bench_engine(mode, CAP, device, wave)


def capture_batch(stream, mode, wave: bool, report: bool = False):
    """Warm an engine on the stream's first 6 batches and capture the 7th
    at its full shapes up to its acceptance: the packed and uploaded
    batch, the state before K1 (``res``) and after it (``res1``), the
    too-old floor, the history after the gated fold, K2's outputs and the
    live endpoint ranks. ``report`` asks for conflicting keys on every
    97th txn."""
    from types import SimpleNamespace

    from foundationdb_tpu_torch.loadgen.ycsb import batch_versions, build_txns
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import upload

    cs = make_engine(mode, "cuda", wave)
    warm = 6
    for i in range(warm):
        cv, old = batch_versions(i)
        cs.resolve(build_txns(*stream, i, mode), cv, old)
    cv, old = batch_versions(warm)
    txns = build_txns(*stream, warm, mode)
    if report:
        for t in txns[::97]:
            t.report_conflicting_keys = True
    cs._begin_resolve(cv, old)
    cvr, oldr = cs._rel(cv), cs._rel(cs.oldest_version)
    batch, _ = cs._pack(txns)
    hb = cs._pack_resident(batch)
    rb = upload(hb, cs.device)
    res = cs.state
    res1 = ck.apply_delta(clone(res), rb.delta_keys, hb.n_new)
    floor, _ = ck.too_old_mask_packed(res1.hist.delta, rb.ranks, oldr)
    hist = ck._maybe_merge(clone(res1.hist), hb.demand, floor)
    too_old, hist_mask, cand = ck.history_probe(hist, rb.ranks, floor)
    return SimpleNamespace(
        index=warm, hb=hb, rb=rb, res=res, cvr=cvr, oldr=oldr, res1=res1,
        floor=floor, hist=hist, too_old=too_old, hist_mask=hist_mask,
        cand=cand, ranks=ck.endpoint_ranks_live_packed(rb.ranks))


def dense_batch(b: int, device):
    """K3's inputs for the dense worst case: every txn reads and writes
    key rank 0 (one live read of two), so every row has an edge."""
    import torch

    def full(shape, v, dtype):
        return torch.full(shape, v, dtype=dtype, device=device)

    read_live = full((b, 2), False, torch.bool)
    read_live[:, 0] = True
    cand = full((b,), True, torch.bool)
    return (cand, full((b,), False, torch.bool), cand.clone(),
            (full((b, 2), 0, torch.int32), full((b, 2), 1, torch.int32),
             read_live, full((b, 1), 0, torch.int32),
             full((b, 1), 1, torch.int32), full((b, 1), True, torch.bool)))


def big_seq_batch(stream, b: int):
    """K3's inputs (cand, too_old, txn_mask, ranks) of the stream's 4th
    batch of ``b`` txns on a cuda engine of that batch size (three
    batches warm it)."""
    import dataclasses

    from foundationdb_tpu_torch.loadgen.ycsb import (
        MODES,
        batch_versions,
        build_txns,
    )
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    mode = dataclasses.replace(MODES["ycsb"], batch=b)
    cs = make_engine(mode, "cuda")
    real, seen = ck.accept, []

    def capturing(cand, too_old, txn_mask, ranks, out=None):
        seen.append((cand, too_old, txn_mask, ranks))
        return real(cand, too_old, txn_mask, ranks, out)

    ck.accept = capturing
    try:
        for i in range(4):
            cv, old = batch_versions(i)
            cs.resolve(build_txns(*stream, i, mode), cv, old)
    finally:
        ck.accept = real
    if cs.overflowed or len(seen) != 4:
        fail(f"{b}-txn batches: overflow or K3 ran {len(seen)} times")
    return seen[-1]


def k3_phase_clocks(clk) -> dict:
    """K3's stats-build counters (``kernels.ACCEPT_CLOCKS``) as ms and
    counts: the overlap launch, the settle (prune and walk launches), the
    walk kernel alone, the counts and the walk kernel's cycles by phase."""
    from foundationdb_tpu_torch import kernels as K

    c = dict(zip(K.ACCEPT_CLOCKS, (int(x) for x in clk.cpu())))
    out = {"overlap_ms": (c["overlap_t1"] - c["overlap_t0"]) / 1e6,
           "settle_ms": (c["walk_t1"] - c["prune_t0"]) / 1e6,
           "prune_ms": (c["prune_t1"] - c["prune_t0"]) / 1e6,
           "walk_kernel_ms": (c["walk_t1"] - c["walk_t0"]) / 1e6}
    for k in ("edgeful", "pending", "rounds", "walk_steps", "walk_words",
              "prefix_cycles", "stage_cycles", "round_cycles",
              "walking_cycles"):
        out[k] = c[k]
    return out


def k1_bytes(n_keys: int, n_new: int, d1: int, w: int, c: int,
             cd: int) -> int:
    """K1's least bytes for one insert: the live dictionary rows and the
    real delta rows read once, the [D+1, W] output written once, and the
    base and delta rank rows read and rewritten."""
    return 4 * ((n_keys + n_new) * w + d1 * w + 2 * (c + cd))


def k1_k4_adversarial(res, rb) -> None:
    """K4 and K1 at the main path's shapes on inputs its stream never
    gives, each run twice against its plain version: the paint with every
    write a range between two ranks, with every endpoint on one rank (a
    run of 2BQ rows, longer than a tile), with no accepted write, and with
    every row below the floor; the fold with every row below the floor;
    the compaction with runs starting at tile edges and longer than a
    tile; K1 with M delta rows equal to live dictionary rows and M past
    every live row."""
    import torch

    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    dev = res.dict_keys.device
    rbk, hist = rb.ranks, res.hist
    b, q = rbk.write_begin.shape
    src = torch.arange(2 * b * q, dtype=torch.int32, device=dev)
    yes = torch.ones(b, dtype=torch.bool, device=dev)

    def floor_of(v):
        return torch.tensor(v, dtype=torch.int32, device=dev)

    def rank(v):
        return torch.full_like(rbk.write_begin, v)

    on = torch.ones_like(rbk.write_mask)
    for label, ranks, acc, fl in (
            ("ranges", rbk._replace(write_begin=rank(5), write_end=rank(9),
                                    write_mask=on, paint_src=src), yes, 0),
            ("one_rank", rbk._replace(write_begin=rank(7), write_end=rank(7),
                                      paint_src=src), yes, 0),
            ("none_accepted", rbk, ~yes, 0),
            ("below_floor", rbk, yes, 1 << 30)):
        want = ck._paint_and_compact_res_plain(clone(hist.delta), ranks, acc,
                                               77, floor_of(fl))
        for _ in range(2):
            assert_equal(f"step_compact.paint_{label}",
                         ck._paint_and_compact_res(clone(hist.delta), ranks,
                                                   acc, 77, floor_of(fl)),
                         want)
    want = ck._merge_delta_plain(hist.base, hist.delta, floor_of(1 << 30))
    for _ in range(2):
        assert_equal("step_compact.fold_below_floor", ck._merge_delta(
            clone(hist.base), hist.delta, floor_of(1 << 30)), want)
    n = 3 * K.K4_TILE + 5
    gen = np.random.default_rng(3)
    for run in (2, K.K4_TILE, K.K4_TILE + 3):
        sk = torch.arange(n, dtype=torch.int32, device=dev)[:, None] // run
        newv = torch.from_numpy(gen.integers(0, 3, n).astype(np.int32)).to(
            dev)
        for c_out in (5, n):
            no = torch.zeros((), dtype=torch.bool, device=dev)
            want = ck._dedup_compact_plain(sk, newv, c_out, no)
            for _ in range(2):
                assert_equal(f"step_compact.compact_run{run}",
                             ck._dedup_compact(sk, newv, c_out, no), want)
    m, w = rb.delta_keys.shape
    n_keys = int(res.n_keys)
    live = res.dict_keys[:n_keys]
    equal = live[torch.linspace(0, n_keys - 1, min(m, n_keys),
                                device=dev).long().unique()]
    past = torch.zeros((m, w), dtype=torch.int32, device=dev)
    past[:, 0] = ck.INT32_MAX - m + torch.arange(m, dtype=torch.int32,
                                                  device=dev)
    for label, rows in (("equal", equal), ("past", past)):
        dk = torch.full((m, w), ck.INT32_MAX, dtype=torch.int32, device=dev)
        dk[:rows.shape[0]] = rows
        want = ck._dict_insert_plain(res.dict_keys, res.n_keys, dk)
        for _ in range(2):
            out, shift = K.dict_insert(res.dict_keys, dk)
            assert_equal(f"dict_insert.{label}", (out, shift),
                         (want[0], want[2]))


def kernel_phase(stream, mode) -> dict:
    """Capture one mid-stream batch and hold every kernel launch against
    its plain version; returns per-kernel timings and bounds."""
    import torch

    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.ops.rmq import sparse_table

    cap = capture_batch(stream, mode, wave=False, report=True)
    hb, rb, res, cvr, oldr = cap.hb, cap.rb, cap.res, cap.cvr, cap.oldr
    if hb.n_new == 0:
        fail("captured batch has an empty dictionary delta")
    b, r = rb.ranks.read_begin.shape
    q = rb.ranks.write_begin.shape[1]
    c = res.hist.base.keys.shape[0]
    cd = res.hist.delta.keys.shape[0]
    d1, w = res.dict_keys.shape
    timings = {}

    # K1: insert + rank shift, remap rewrite, version rebase.
    def k1(res_):
        return ck.apply_delta(res_, rb.delta_keys, hb.n_new)

    def k1_plain(res_):
        nd, nn, shift = ck._dict_insert_plain(res_.dict_keys, res_.n_keys,
                                              rb.delta_keys)
        h = res_.hist
        ranks = ck._rewrite_ranks_plain(
            [h.base.keys, h.delta.keys, res_.shard_lo, res_.shard_hi], shift,
            False)
        return ck.ResState(nd, nn, ck.HistState(
            h.base._replace(keys=ranks[0]), h.base_st,
            h.delta._replace(keys=ranks[1])), ranks[2], ranks[3])

    assert_equal("dict_insert", k1(clone(res)), k1_plain(clone(res)))
    out, shift = K.dict_insert(res.dict_keys, rb.delta_keys)
    nd, _, shift_p = ck._dict_insert_plain(res.dict_keys, res.n_keys,
                                           rb.delta_keys)
    assert_equal("dict_insert.shift", (out, shift), (nd, shift_p))
    remap = (torch.arange(d1, dtype=torch.int32, device=shift.device)
             + shift).contiguous()
    arrays = [res.hist.base.keys, res.hist.delta.keys]
    got = [a.clone() for a in arrays]
    K.rewrite_ranks(got, remap, True)
    assert_equal("dict_insert.remap", got,
                 ck._rewrite_ranks_plain(arrays, remap, True))
    vers = [res.hist.base.versions, res.hist.delta.versions]
    got = [v.clone() for v in vers]
    K.rebase_versions(got, 5)
    assert_equal("dict_insert.rebase", got,
                 [ck._rebase_versions_plain(v, 5) for v in vers])
    timings["dict_insert"] = (
        time_ms(k1, lambda: (clone(res),)),
        time_ms(k1_plain, lambda: (clone(res),), reps=3))
    bytes_k1 = k1_bytes(int(res.n_keys), hb.n_new, d1, w, c, cd)
    k1_parts = {
        "insert_ms": time_ms(lambda: K.dict_insert(res.dict_keys,
                                                   rb.delta_keys)),
        "rewrite_ms": time_ms(lambda a: K.rewrite_ranks(a, shift, False),
                              lambda: ([res.hist.base.keys.clone(),
                                        res.hist.delta.keys.clone()],))}
    launch_counts = {
        "insert": cuda_kernels(lambda: K.dict_insert(res.dict_keys,
                                                     rb.delta_keys)),
        "insert_rewrite": cuda_kernels(k1, lambda: (clone(res),))}
    k1_k4_adversarial(res, rb)

    res1, floor = cap.res1, cap.floor

    # K4 fold (the forced fold of advance_hist and the gated one).
    def fold(hist):
        return ck.advance_hist(hist, cvr, oldr)

    def fold_plain(hist):
        nb = ck._merge_delta_plain(hist.base, hist.delta, floor)
        return ck.HistState(nb, sparse_table(nb.versions),
                            ck._reset_delta(hist.delta, floor))

    assert_equal("step_compact.fold", fold(clone(res1.hist)),
                 fold_plain(clone(res1.hist)))
    hist2 = cap.hist
    assert_equal("step_compact.maybe_merge", hist2,
                 ck._maybe_merge_plain(clone(res1.hist), hb.demand, floor))
    fold_ms = (time_ms(fold, lambda: (clone(res1.hist),), reps=5),
               time_ms(fold_plain, lambda: (clone(res1.hist),), reps=2))
    # The gated step: after this batch's step nothing has expired and the
    # delta has room, so the fold is not needed (the state must not
    # change); before it, a demand past the delta's room makes it needed.
    gfold = {}
    for label, h0, dem in (
            ("not_needed", hist2, hb.demand),
            ("needed", res1.hist, res1.hist.delta.keys.shape[0] + 1)):
        need = bool(ck.fold_need_plain(h0, dem, floor))
        if need != (label == "needed"):
            fail(f"gated fold {label}: the decision's plain twin says {need}")
        if bool(K.fold_need(h0.base.versions, h0.delta, floor, dem)) != need:
            fail(f"gated fold {label}: sc_need disagrees with its twin")
        want = ck._maybe_merge_plain(clone(h0), dem, floor)
        for _ in range(2):
            assert_equal(f"step_compact.gated_{label}",
                         ck._maybe_merge(clone(h0), dem, floor), want)
        gfold[label] = (
            time_ms(lambda h, d=dem: ck._maybe_merge(h, d, floor),
                    lambda h0=h0: (clone(h0),)),
            time_ms(lambda h, d=dem: ck._maybe_merge_plain(h, d, floor),
                    lambda h0=h0: (clone(h0),), reps=3))
        launch_counts[f"gated_fold_{label}"] = cuda_kernels(
            lambda h, d=dem: ck._maybe_merge(h, d, floor),
            lambda h0=h0: (clone(h0),))
    kept = clone(hist2)
    gfold["in_place_ms"] = time_ms(
        lambda: ck._maybe_merge(hist2, hb.demand, floor))
    assert_equal("step_compact.gated_kept", hist2, kept)
    launch_counts["forced_fold"] = cuda_kernels(fold,
                                                lambda: (clone(res1.hist),))

    # K2: delta table + probe; the base table alone.
    def k2(hist):
        return ck.history_probe(hist, rb.ranks, floor)

    def k2_plain(hist):
        return ck.history_probe_plain(hist, rb.ranks, floor)

    too_old, hist_mask, cand = cap.too_old, cap.hist_mask, cap.cand
    assert_equal("history_probe", k2(hist2), k2_plain(hist2))
    assert_equal("history_probe.delta_table",
                 K.build_table(hist2.delta.versions),
                 sparse_table(hist2.delta.versions))
    table_launches = {"delta": K.TABLE_KERNELS["last"]}
    assert_equal("history_probe.table", K.build_table(hist2.base.versions),
                 sparse_table(hist2.base.versions))
    table_launches["base"] = K.TABLE_KERNELS["last"]
    gated = hist2.base_st.clone()
    no = torch.zeros((), dtype=torch.bool, device="cuda")
    K.build_table(hist2.base.versions, out=gated, need=no)
    assert_equal("history_probe.gated_table", gated, hist2.base_st)
    table_launches["base_gated_off"] = K.TABLE_KERNELS["last"]
    gated_ms = time_ms(lambda: K.build_table(hist2.base.versions, out=gated,
                                             need=no))
    print(json.dumps({"k2_table_launches": table_launches,
                      "gated_base_table_ms": gated_ms}))
    timings["history_probe"] = (time_ms(k2, lambda: (hist2,)),
                                time_ms(k2_plain, lambda: (hist2,), reps=3))
    table_ms = (time_ms(lambda: K.build_table(hist2.base.versions)),
                time_ms(lambda: sparse_table(hist2.base.versions), reps=3))
    bytes_k2 = (b * r * 9 + b * 5 + cd * 8
                + b * r * 4 * (2 * math.ceil(math.log2(c + 1)) + 2)
                + b * r + 2 * b)

    # K3: acceptance + verdicts; the report launch.
    ranks = cap.ranks
    tm = rb.ranks.txn_mask
    accepted, verdicts = ck.accept(cand, too_old, tm, ranks)
    assert_equal("accept", (accepted, verdicts),
                 ck.accept_plain(cand, too_old, tm, ranks))
    losers = ck.loser_mask(hist_mask, ranks, accepted, verdicts)
    assert_equal("accept.losers", losers,
                 ck.loser_mask_plain(hist_mask, ranks, accepted, verdicts))
    timings["accept"] = (
        time_ms(lambda: ck.accept(cand, too_old, tm, ranks)),
        time_ms(lambda: ck.accept_plain(cand, too_old, tm, ranks), reps=2))
    # K3's stats build on the captured batch (its phases and counts), then
    # the dense worst case and a 32,768-txn batch of the stream against
    # the plain version.
    clk = torch.zeros(len(K.ACCEPT_CLOCKS), dtype=torch.int64, device="cuda")
    assert_equal("accept.stats", K.accept(cand, too_old, tm, *ranks,
                                          clocks=clk),
                 ck.accept_plain(cand, too_old, tm, ranks))
    k3_clocks = k3_phase_clocks(clk)
    print(json.dumps({"k3_phase_clocks": k3_clocks}))
    k3_more = {}
    for label, args in (("dense_8192", dense_batch(b, "cuda")),
                        ("stream_32768", big_seq_batch(stream, 32768))):
        assert_equal(f"accept.{label}", ck.accept(*args),
                     ck.accept_plain(*args))
        clk.zero_()
        K.accept(*args[:3], *args[3], clocks=clk)
        k3_more[label] = {"ms": time_ms(lambda: ck.accept(*args)),
                          "plain_ms": time_ms(lambda: ck.accept_plain(*args),
                                              reps=1),
                          "phase_clocks": k3_phase_clocks(clk)}
        print(json.dumps({"k3_check": label, **k3_more[label]}))
    loser_ms = (
        time_ms(lambda: ck.loser_mask(hist_mask, ranks, accepted, verdicts)),
        time_ms(lambda: ck.loser_mask_plain(hist_mask, ranks, accepted,
                                            verdicts), reps=2))
    idx = torch.nonzero(cand).flatten().double()
    ops_k3 = float(3 * r * q * idx.sum())
    bytes_k3 = 3 * b + b * r * 9 + b * q * 9 + 2 * b

    # K4: paint; compaction alone.
    def k4(delta):
        return ck._paint_and_compact_res(delta, rb.ranks, accepted, cvr,
                                         floor)

    def k4_plain(delta):
        return ck._paint_and_compact_res_plain(delta, rb.ranks, accepted,
                                               cvr, floor)

    for _ in range(2):
        assert_equal("step_compact.paint", k4(clone(hist2.delta)),
                     k4_plain(clone(hist2.delta)))
    launch_counts["paint"] = cuda_kernels(k4, lambda: (clone(hist2.delta),))
    print(json.dumps({"k1_k4_cuda_launches": launch_counts}))
    if (launch_counts["paint"]["launches"] > 2
            or launch_counts["gated_fold_not_needed"]["launches"] > 5):
        fail(f"K4 launches: {launch_counts}")
    timings["step_compact"] = (
        time_ms(k4, lambda: (clone(hist2.delta),)),
        time_ms(k4_plain, lambda: (clone(hist2.delta),), reps=3))
    skeys = torch.cat([hist2.base.keys, hist2.delta.keys]).sort(0).values
    gen = np.random.default_rng(1)
    newv = torch.from_numpy(gen.integers(0, 4, skeys.shape[0]).astype(
        np.int32)).cuda()
    prior = torch.zeros((), dtype=torch.bool, device="cuda")
    assert_equal("step_compact.compact",
                 ck._dedup_compact(skeys.contiguous(), newv, c, prior),
                 ck._dedup_compact_plain(skeys, newv, c, prior))
    bytes_k4 = cd * 8 * 2 + b * q * 9 + b + 2 * b * q * 4
    torch.cuda.synchronize()

    # Bounds of the other launches. Forced fold (advance_hist): base and
    # delta read, base written, the base table's L levels written, the
    # delta reset. Table rebuild: values read, L levels written. Loser
    # mask: its inputs read, one int32 per txn written; operations are
    # the two compares of each CONFLICT txn's live read slot against each
    # accepted live write.
    levels = K.table_levels(c)
    fold_bound = bound(8 * c + 8 * cd + 8 * c + 4 * levels * c + 8 * cd)
    # The gated step whose fold is not needed: the decision reads the base
    # versions and the delta's count, and writes the flag; the gated
    # launches read the flag alone.
    gated_bound = bound(4 * c + 4 + 1)
    table_bound = bound(4 * c + 4 * levels * c)
    conf = verdicts == ck.V_CONFLICT
    loser_ops = 2.0 * float((ranks[2] & conf[:, None]).sum()) * float(
        (ranks[5] & accepted[:, None]).sum())
    loser_bound = bound(b * r * 10 + 2 * b + b * q * 9 + 4 * b, loser_ops)

    bounds = {"dict_insert": (bytes_k1, 0.0), "history_probe": (bytes_k2, 0.0),
              "accept": (bytes_k3, ops_k3), "step_compact": (bytes_k4, 0.0)}
    for name, (ms, plain) in timings.items():
        print(f"kernel {name}: {ms:.4f} ms (plain {plain:.4f} ms)")
    for label, (ms, plain), (lo, by) in (
            (f"step_compact fold (forced, C={c})", fold_ms, fold_bound),
            ("step_compact gated fold step (need False)",
             gfold["not_needed"], gated_bound),
            ("step_compact gated fold step (need True)", gfold["needed"],
             fold_bound),
            (f"history_probe base table (C={c})", table_ms, table_bound),
            ("accept losers (report chunk)", loser_ms, loser_bound)):
        print(f"kernel {label}: {ms:.4f} ms (plain {plain:.4f} ms, "
              f"bound {lo:.6f} ms by {by})")
    return {"timings": timings, "bounds": bounds, "k1_parts": k1_parts,
            "launch_counts": launch_counts,
            "fold": {"forced": (fold_ms, fold_bound),
                     "gated": (gfold["not_needed"], gated_bound),
                     "gated_needed": gfold["needed"],
                     "gated_in_place_ms": gfold["in_place_ms"]},
            "accept_more": {"phase_clocks": k3_clocks, **k3_more},
            "table_more": {"table_launches": table_launches,
                           "base_table_ms": table_ms[0],
                           "gated_base_table_ms": gated_ms}}


def run_stream(stream, mode, n_batches: int, device, label: str):
    """Resolve n_batches of the stream with the Resolver's fail-safe;
    returns (verdict int8 array, per-batch latency ms, engine)."""
    import torch

    from foundationdb_tpu_torch.loadgen.ycsb import batch_versions, build_txns

    cs = make_engine(mode, device)
    out, lat = [], []
    fail_safe = 0
    for i in range(n_batches):
        txns = build_txns(*stream, i, mode)
        cv, old = batch_versions(i)
        t0 = time.perf_counter()
        if cs.headroom() < cs.worst_case_growth(len(txns)):
            cs.advance(cv, old)
            v = [1] * len(txns)  # Verdict.CONFLICT for the whole batch
            fail_safe += 1
        else:
            v = [int(x) for x in cs.resolve(txns, cv, old)]
        if cs.device.type == "cuda":
            torch.cuda.synchronize()
        lat.append((time.perf_counter() - t0) * 1e3)
        out.append(np.asarray(v, np.int8))
    if fail_safe:
        print(f"{label}: {fail_safe} batches took the fail-safe")
    return np.concatenate(out), lat, cs


def wire_stream(stream, mode, n_batches: int):
    """(blob, txn_ends, n_batches) of the stream's first whole windows."""
    from foundationdb_tpu_torch.loadgen.ycsb import build_wire_stream

    n_batches = n_batches // WINDOW_K * WINDOW_K
    blob, ends = build_wire_stream(
        *(a[: n_batches * mode.batch] for a in stream), n_batches, mode)
    return blob, ends, n_batches


def counted_run(blob, ends, mode, n_batches: int, wave: bool,
                engine: dict | None = None, label: str | None = None,
                program: str = "resolve_many", sources=None):
    """The stream through the bench's runner on cuda (window WINDOW_K,
    WINDOW_DEPTH in flight, threaded), after a warm-up outside the count;
    ``engine`` holds further constructor arguments, ``program`` names the
    engine's window program (``sharded_many`` for a sharded engine,
    ``packed_many`` for a non-resident one) and ``sources`` the kernel
    sources it must launch (by default the sequential or wave set).
    Returns (record, verdicts, levels, engine, launches per source, entry
    launches per window)."""
    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import TorchConflictSet

    engine = engine or {}
    label = label or ("wave" if wave else "window")
    # Warm-up outside the counted run: the packer's build, first launches.
    bench.make_engine(mode, CAP, "cuda", wave, **engine).resolve_wire_window(
        *bench.window_wire(blob, ends, mode, WINDOW_K, 0), mode.batch)
    per_window: list[dict] = []
    dispatch = TorchConflictSet.dispatch_window

    def counted(self, prepared):
        before = dict(K.ENTRY_LAUNCHES)
        out = dispatch(self, prepared)
        per_window.append({k: n - before.get(k, 0)
                           for k, n in K.ENTRY_LAUNCHES.items()})
        return out

    TorchConflictSet.dispatch_window = counted
    try:
        K.reset_launches()
        ck.reset_launches()
        rec, verdicts, levels, cs = bench.run_wire(
            blob, ends, mode, n_batches, CAP, "cuda", window=WINDOW_K,
            pipeline_depth=WINDOW_DEPTH, repeats=1, threaded=True,
            warmup=False, wave=wave, engine=engine)
        launches = {**K.LAUNCHES, **ck.LAUNCHES}
    finally:
        TorchConflictSet.dispatch_window = dispatch
    n_windows = n_batches // WINDOW_K
    if rec["overflowed"]:
        fail(f"history overflowed on the {label} path")
    if sources is None:
        sources = WAVE_SOURCES if wave else SEQ_SOURCES
    if program == "sharded_many":
        sources = (*sources, "shard")
    for k in (*sources, program):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the {label} path")
    if len(per_window) != n_windows or launches[program] != n_windows:
        fail(f"{len(per_window)} dispatches, {launches[program]} "
             f"window programs for {n_windows} windows")
    return rec, verdicts, levels, cs, launches, per_window


def capture_launches():
    """Every launch of K15's window step (``WordWindowClip.step``) and of
    the fused exchanges (``shard_pred_exchange``, ``word_pred_exchange``)
    until ``restore`` is called: each call's inputs and outputs cloned on
    the card where it runs (no host sync), for ``check_launches`` after
    the run. Returns (captures, restore)."""
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    caps = []
    step = ck.WordWindowClip.step
    shard_x, word_x = ck.shard_pred_exchange, ck.word_pred_exchange

    def clip_step(self, batch):
        out = step(self, batch)
        if self.out is not None:
            caps.append(("clip", (clone(batch), self.lo, self.hi,
                                  self.reads), clone(out)))
        return out

    def shard_exchange(cand, clip, stats_out=None, plain=False):
        got = shard_x(cand, clip, stats_out, plain)
        if not plain:
            caps.append(("ranks", (cand.clone(), clone(clip)), clone(got)))
        return got

    def word_exchange(cand, batch, clip, stats_out=None, plain=False):
        got = word_x(cand, batch, clip, stats_out, plain)
        if not plain:
            caps.append(("keys", (cand.clone(), clone(batch), clone(clip)),
                         clone(got)))
        return got

    ck.WordWindowClip.step = clip_step
    ck.shard_pred_exchange, ck.word_pred_exchange = (shard_exchange,
                                                     word_exchange)

    def restore():
        ck.WordWindowClip.step = step
        ck.shard_pred_exchange, ck.word_pred_exchange = shard_x, word_x

    return caps, restore


def check_launches(caps, label: str) -> dict:
    """Each captured launch against its plain twin: K15's against
    ``word_clip_plain``; a fused exchange's (p, stats) against
    ``wave_exchange_plain`` of the shards' stacked plain matrices (from
    the clipped ranks, or from K14's plain ranks of the clipped key rows).
    Returns the launches checked, by kind."""
    import torch

    from foundationdb_tpu_torch.models import conflict_kernel as ck

    n = {"clip": 0, "exchange": 0}
    for kind, args, got in caps:
        if kind == "clip":
            want = ck.word_clip_plain(*args)
            assert_equal(f"word_clip.{label}",
                         [x for x in got if x is not None],
                         [x for x in want if x is not None])
            n["clip"] += 1
            continue
        cand, clip = args[0], args[-1]
        shards = range(clip.write_begin.shape[0])
        if kind == "ranks":
            ranks = [ck._clip_live(clip, s) for s in shards]
        else:
            ranks = [ck.endpoint_ranks_live_plain(ck.clip_view(args[1], clip,
                                                               s))
                     for s in shards]
        assert_equal(f"wave_exchange.{label}", got, ck.wave_exchange_plain(
            torch.stack([ck.wave_pred_matrix_plain(cand, r) for r in ranks])))
        n["exchange"] += 1
    caps.clear()
    return n


def exchange_bound(cand, ranks) -> tuple[float, float]:
    """(bytes, operations) of the fused exchange over the shards' clipped
    ``ranks``: K5's of each shard (the candidate mask, the read slots of
    candidates and every write slot read once; two compares per (live
    read slot of a candidate, live write slot)), the one matrix and the
    stats written once."""
    b = cand.shape[0]
    bp = (b + 31) // 32 * 32
    n_cand = int(cand.sum())
    nbytes, ops = float(b + 4 * bp * (bp // 32) + 8), 0.0
    for rb, _, rm, wb, _, wm in ranks:
        nbytes += 9 * n_cand * rb.shape[1] + 9 * b * wb.shape[1]
        ops += 2.0 * float((rm & cand[:, None]).sum()) * float(wm.sum())
    return nbytes, ops


def window_phase(blob, ends, mode, n_batches: int, seed: int, card: str,
                 object_sha: str) -> dict:
    """Phase 3b: the window path through the bench's runner, counted, then
    its cross-checks and the window program held against its plain
    version. Returns the resolve_many row's measurements and the run's
    record."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.loadgen.ycsb import (
        MODES,
        build_wire_stream,
        gen_workload,
    )
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import _RepackPlan, upload

    cap = CAP
    b = mode.batch
    n_windows = n_batches // WINDOW_K
    rec, verdicts, _, _, launches, per_window = counted_run(
        blob, ends, mode, n_batches, wave=False)
    windows = launches["resolve_many"]
    for i, pw in enumerate(per_window):
        if pw.get("ac_accept", 0) != WINDOW_K or pw.get("di_insert", 0) > 1:
            fail(f"window {i}: K3 launched {pw.get('ac_accept', 0)} times "
                 f"(want {WINDOW_K}), K1 insert {pw.get('di_insert', 0)} "
                 "(want <= 1)")

    # (a) Per-batch resolve_wire on cuda at the same commit versions.
    one = bench.make_engine(mode, cap, "cuda")
    rows = []
    t0 = time.perf_counter()
    for i in range(n_batches):
        lo, hi = int(ends[i * b]), int(ends[(i + 1) * b])
        rows.append(one.resolve_wire_async(blob[lo:hi], i + 1, count=b,
                                           as_array=True)())
    per_batch_s = time.perf_counter() - t0
    per_batch_sha = hashlib.sha256(np.concatenate(rows).tobytes()).hexdigest()
    if per_batch_sha != rec["verdicts_sha256"]:
        fail("window path and per-batch resolve_wire verdicts differ")
    print(json.dumps({
        "phase": "window", "stream": "ycsb-a", **rec,
        "launches_per_window": {k: launches[k] / n_windows
                                for k in SEQ_SOURCES},
        "window_programs": windows,
        "per_batch_wire_txns_per_s": n_batches * b / per_batch_s,
        "per_batch_wire_verdicts_sha256": per_batch_sha,
        "object_path_sha_equal": per_batch_sha == object_sha,
        "card": card}))

    # (b) The first window on the CPU plain path.
    cpu0 = bench.make_engine(mode, cap, "cpu").resolve_wire_window(
        *bench.window_wire(blob, ends, mode, WINDOW_K, 0), b)
    if not np.array_equal(cpu0, verdicts[0]):
        fail("window 0: cuda and cpu verdicts differ")
    print(f"cross-check window 0: {cpu0.size} txns equal on cuda and cpu")

    # (c) mako and tpcc through the window path on cuda and the CPU.
    for mname in ("mako", "tpcc"):
        m = MODES[mname]
        n_cross = 16
        mb, me = build_wire_stream(
            *gen_workload(n_cross * m.batch, N_KEYS, seed, m), n_cross, m)
        got = {dev: bench.run_wire(mb, me, m, n_cross, cap, dev, window=4,
                                   pipeline_depth=WINDOW_DEPTH, repeats=1,
                                   warmup=False)
               for dev in ("cuda", "cpu")}
        if (not np.array_equal(got["cuda"][1], got["cpu"][1])
                or got["cuda"][0]["overflowed"]):
            fail(f"{mname} window path: cuda and cpu verdicts differ")
        r = got["cuda"][0]
        print(f"cross-check {mname} window path: {r['txns']} txns equal on "
              f"cuda and cpu (committed {r['committed']}, conflict "
              f"{r['conflict']}, too_old {r['too_old']})")

    # The window program (A14) held against its plain version on a
    # captured warm window at the stream's full shapes: the first after
    # window 0 that brings a dictionary delta (no deferred repack), so K1
    # inserts inside it.
    cs = bench.make_engine(mode, cap, "cuda")
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, WINDOW_K, 0),
                           b)
    for wi in range(1, n_windows):
        prepared = cs.pack_wire_window(
            *bench.window_wire(blob, ends, mode, WINDOW_K, wi), b)
        hb = prepared.batch
        if not isinstance(hb, _RepackPlan) and hb.n_new:
            break
        cs.dispatch_window(prepared)()
    else:
        fail("no window of the stream brings a dictionary delta")
    if prepared.rebase_delta:
        fail("unexpected rebase in the captured window")
    rb = upload(hb, cs.device)
    cvs, olds = prepared.cvs_rel, prepared.olds_rel
    state = cs.state

    def many(res):
        return ck.resolve_many_res(res, rb, cvs, olds, hb.n_new, hb.demand)

    def many_plain(res):
        return ck.resolve_many_res_plain(res, rb, cvs, olds)

    assert_equal("resolve_many", many(clone(state)), many_plain(clone(state)))
    torch.cuda.synchronize()
    ms = time_ms(many, lambda: (clone(state),), reps=5)
    plain = time_ms(many_plain, lambda: (clone(state),), reps=2)
    print(f"kernel resolve_many (window of {WINDOW_K}, n_new {hb.n_new}): "
          f"{ms:.4f} ms (plain {plain:.4f} ms)")
    return {"launches": windows, "ms": ms, "plain_ms": plain,
            "k": WINDOW_K, "record": rec}


def host_replay(pn: np.ndarray, b: int, cand: list[int]) -> list[int]:
    """Levels of the first b txns by the port's host replay
    (``core/wavemesh.level_wave_graph``) of the packed predecessor rows
    ``pn``; run in a worker process beside the card's phases."""
    from foundationdb_tpu_torch.core import wavemesh

    bp = pn.shape[0]
    t0 = time.perf_counter()
    levels = wavemesh.level_wave_graph(bp, set(cand),
                                       wavemesh.unpack_pred_rows(pn, bp))
    return levels[:b], time.perf_counter() - t0


def wave_kernel_phase(stream, mode, pool) -> dict:
    """K5 and K6 on a batch captured from a wave engine warmed on the
    stream, at its full shapes, each held against its plain version; K6's
    levels go to ``pool`` for the host replay of the unpacked K5 matrix
    (check (c) of the wave phase, read by ``check_replay``). Returns
    their timings and bounds."""
    import torch

    from foundationdb_tpu_torch.models import conflict_kernel as ck

    cap = capture_batch(stream, mode, wave=True)
    cand, too_old, ranks = cap.cand, cap.too_old, cap.ranks
    tm = cap.rb.ranks.txn_mask
    b, r = cap.rb.ranks.read_begin.shape
    q = cap.rb.ranks.write_begin.shape[1]

    p = ck.wave_pred_matrix(cand, ranks)
    assert_equal("wave_pred", p, ck.wave_pred_matrix_plain(cand, ranks))
    stats = [torch.zeros(5, dtype=torch.int64, device="cuda")
             for _ in range(2)]
    got = ck.wave_level(cand, p, too_old, tm, stats=stats[0])
    assert_equal("wave_level", got,
                 ck.wave_level_plain(cand, p, too_old, tm, stats=stats[1]))
    assert_equal("wave_level.stats", stats[0], stats[1])
    _, rounds, victims, _, _ = (int(x) for x in stats[0].cpu())
    pn = p.cpu().numpy().view(np.uint32)
    bp, nw = pn.shape
    n_cand = int(cand.sum())
    replay = pool.apply_async(host_replay, (
        pn, b, np.nonzero(cand.cpu().numpy())[0].tolist()))
    print(f"wave batch {cap.index}: {n_cand} candidates, {rounds} K6 "
          f"rounds, {victims} cycle victims")

    timings = {
        "wave_pred": (time_ms(lambda: ck.wave_pred_matrix(cand, ranks)),
                      time_ms(lambda: ck.wave_pred_matrix_plain(cand, ranks),
                              reps=2)),
        "wave_level": (time_ms(lambda: ck.wave_level(cand, p, too_old, tm)),
                       time_ms(lambda: ck.wave_level_plain(cand, p, too_old,
                                                           tm), reps=2)),
    }
    # K5: the candidate mask, the read slots of candidates (the columns;
    # the kernel reads no other) and every write slot read once, the
    # matrix written once; two compares per (live read slot of a
    # candidate, live write slot). K6: the masks and the rows of the
    # candidates (the undetermined set never leaves them) read once;
    # levels, accepted and verdicts written once. The JAX leveling
    # instead re-reads the whole matrix every round: printed beside it
    # for reference, not as the bound.
    live_reads = float((ranks[2] & cand[:, None]).sum())
    live_writes = float(ranks[5].sum())
    bounds = {
        "wave_pred": (b + 9 * n_cand * r + 9 * b * q + 4 * bp * nw,
                      2.0 * live_reads * live_writes),
        "wave_level": (4 * n_cand * nw + 3 * b + 6 * b, 0.0),
    }
    jax_rounds_ms = rounds * 4 * bp * nw / HBM_BYTES_PER_S * 1e3
    print(f"kernel wave_level: the JAX rounds' matrix traffic for this "
          f"batch would take {jax_rounds_ms:.4f} ms at the HBM rate")
    return {"timings": timings, "bounds": bounds, "rounds": rounds,
            "victims": victims, "replay": replay,
            "levels": got[1].cpu().numpy().tolist(), "index": cap.index,
            "tensors": (cand, p, too_old, tm)}


def _search_case(rng, kind: str, w: int, c: int = 320, nq: int = 300):
    """(keys [C, W] with rows past n all INT32_MAX, n, query rows) of one
    adversarial kind (``k12_k5_adversarial``)."""
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    n = {"n0": 0, "full": c}.get(kind, int(rng.integers(1, c)))
    spread = 3 if kind in ("runs", "top") else 60
    keys = np.full((c, w), ck.INT32_MAX, np.int32)
    live = rng.integers(-spread, spread, (n, w)).astype(np.int32)
    keys[:n] = live[np.lexsort(live.T[::-1])]
    if kind == "top" and n > 2:
        keys[n - 2:n] = ck.INT32_MAX  # +inf rows inside the live prefix
    if kind == "tiles":
        nq = int(rng.choice([3, 4, 5, 8, 9, 15, 16, 17, 127, 128, 129]))
    q = rng.integers(-spread - 1, spread + 1, (nq, w)).astype(np.int32)
    if n:
        pick = rng.random(nq) < 0.4
        q[pick] = keys[rng.integers(0, n, int(pick.sum()))]
    q[rng.random(nq) < (0.3 if kind == "top" else 0.03)] = ck.INT32_MAX
    if kind != "unsorted":
        q = q[np.lexsort(q.T[::-1])]
    return keys, n, q


def k12_k5_adversarial() -> None:
    """K12's search and K5 on the card against their plain versions on
    adversarial inputs: K12 given live counts (n = 0, n = C, +inf rows
    inside the live prefix), runs of equal rows, all-INT32_MAX queries,
    sorted and unsorted queries, query counts around the tiles, W = 1, 4,
    9, 24, the one- and two-history forms, at its own plan and at plans
    that force each branch, and a tile whose span is one row over the
    shared budget (one staged and one global block); every branch must
    run. K5 on B not a multiple of 32, rows with no live write, R wide
    enough to shrink its tile, every interval equal, live empty intervals
    (begin = end) and few candidates. Each K12 and K5 call launches one
    CUDA kernel, as its entry counts it at the launch."""
    import torch

    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.ops.lex import searchsorted_words_2sided_fp

    rng = np.random.default_rng(14)
    seen = torch.zeros(3, dtype=torch.int32, device="cuda")

    def check(label, keys, q, live, plan, keys1=None, live1=None):
        hists = [keys] + ([] if keys1 is None else [keys1])
        lives = [live, live1]
        got = K.word_search(
            *(torch.from_numpy(x).cuda() if x is not None else None
              for x in (keys, q, keys1)),
            *(None if x is None else torch.tensor(x, dtype=torch.int32,
                                                  device="cuda")
              for x in lives), seen, plan)
        if K.WORD_SEARCH_KERNELS["last"] != 1:
            fail(f"K12 {label}: {K.WORD_SEARCH_KERNELS['last']} CUDA "
                 "kernels counted at launch, want 1")
        for h, rows in enumerate(hists):
            want = searchsorted_words_2sided_fp(torch.from_numpy(rows),
                                                torch.from_numpy(q))
            assert_equal(f"word_probe.adversarial_{label}_{h}",
                         [x.cpu() for x in got[2 * h:2 * h + 2]], list(want))

    for w in (1, 4, 9, 24):
        for kind in ("runs", "top", "n0", "full", "unsorted", "tiles"):
            keys, n, q = _search_case(rng, kind, w)
            for plan in (None, (16, 0), (128, 0), (16, 160 * w),
                         (128, 200 * 1024)):
                check(f"{kind}_w{w}", keys, q, n, plan)
            keys2 = keys.copy()
            keys2[n // 3:] = ck.INT32_MAX
            for plan in (None, (64, 4096), (128, 1 << 16)):
                check(f"{kind}_w{w}_two", keys, q, n, plan, keys2, n // 3)
    w, budget = 4, 40
    keys = np.stack([np.arange(320, dtype=np.int32)] * w, 1)
    q = keys[np.concatenate([np.linspace(10, 10 + budget - 1, 16),
                             np.linspace(100, 100 + budget, 16)]).astype(int)]
    before = seen.clone()
    # The shared bytes hold the tile's 16 rows, then the budget's rows.
    check("over_budget", keys, q, None, (16, (16 + budget) * 4 * w))
    if (seen - before).tolist() != [0, 1, 1]:
        fail(f"K12: a span at and one row over the budget gave branches "
             f"{(seen - before).tolist()}, want [0, 1, 1]")
    if not bool((seen > 0).all()):
        fail(f"K12's adversarial cases left a branch unused: {seen.tolist()}")
    for kind in ("random", "b_not_32", "no_live_write", "wide", "dense",
                 "empty_live", "noncand"):
        b, r, qn, space = {"b_not_32": (161, 3, 2, 90),
                           "wide": (700, 40, 1, 900),
                           "dense": (130, 2, 2, 1)}.get(kind, (300, 2, 1, 200))
        rb = rng.integers(0, space, (b, r)).astype(np.int32)
        re_ = rb + rng.integers(0, 4, (b, r)).astype(np.int32)
        wb = rng.integers(0, space, (b, qn)).astype(np.int32)
        we = wb + rng.integers(0, 4, (b, qn)).astype(np.int32)
        rl = (rng.random((b, r)) < 0.9) & (rb < re_)
        wl = (rng.random((b, qn)) < 0.7) & (wb < we)
        cand = rng.random(b) < 0.85
        if kind == "no_live_write":
            wl &= rng.random((b, qn)) < 0.4
        elif kind == "dense":
            rb[:], re_[:], wb[:], we[:] = 0, 5, 0, 5
            rl[:], wl[:] = True, True
        elif kind == "empty_live":
            re_ = rb.copy()
            rl = rng.random((b, r)) < 0.9
        elif kind == "noncand":
            cand = rng.random(b) < 0.05
        ranks = tuple(torch.from_numpy(x).cuda()
                      for x in (rb, re_, rl, wb, we, wl))
        cand_t = torch.from_numpy(cand).cuda()
        assert_equal(f"wave_pred.adversarial_{kind}",
                     ck.wave_pred_matrix(cand_t, ranks),
                     ck.wave_pred_matrix_plain(cand_t, ranks))
        if K.WAVE_PRED_KERNELS["last"] != 1:
            fail(f"K5 {kind}: {K.WAVE_PRED_KERNELS['last']} CUDA kernels "
                 "counted at launch, want 1")
    torch.cuda.synchronize()
    print(f"k12_k5_adversarial: K12 blocks by branch "
          f"{dict(zip(K.WP_BRANCHES, seen.tolist()))}, K5 on 7 kinds; all "
          "equal their plain versions, one CUDA kernel a call each (counted "
          "at launch)")


def check_replay(wk: dict) -> None:
    """Check (c)'s host half: K6's levels equal the host replay."""
    levels, seconds = wk["replay"].get()
    if wk["levels"] != levels:
        fail("wave_level: K6 levels differ from the host replay "
             "(wavemesh.level_wave_graph) of the K5 matrix")
    print(f"wave batch {wk['index']}: K6 levels equal the host replay "
          f"({seconds:.1f} s in a worker process)")


def k6_phase_clocks(clk) -> dict:
    """K6's stats-build counters (``kernels.WAVE_CLOCKS``) as ms and
    counts: the level kernel's clock64 cycles convert at its own
    globaltimer span."""
    from foundationdb_tpu_torch import kernels as K

    c = dict(zip(K.WAVE_CLOCKS, (int(x) for x in clk.cpu())))
    level_ns = c["level_t1"] - c["level_t0"]
    per_ms = c["cycles"] / (level_ns / 1e6)
    out = {"prologue_and_first_wave_ms": (c["prologue_t1"]
                                          - c["prologue_t0"]) / 1e6,
           "level_ms": level_ns / 1e6, "cycles_per_ns": per_ms / 1e6}
    for k in ("init", "wave_rounds", "stall_rounds", "stall_prefix",
              "stall_walk", "stall_rescan", "stall_release"):
        out[f"{k}_ms"] = c[k] / per_ms
    for k in ("walk_steps", "prefix_reused", "rescans", "rescan_words",
              "decrements"):
        out[k] = c[k]
    return out


def replay_edges(bp: int, b: int, cand: list, rows, words, vals):
    """Check (g)'s host half, in a worker: the levels of one batch by
    ``wavemesh.level_wave_edges`` over the set bits of the nonzero words
    (row, word, value) of its K5 matrix."""
    from foundationdb_tpu_torch.core import wavemesh

    t0 = time.perf_counter()
    bits = np.unpackbits(vals.view(np.uint8).reshape(-1, 4), axis=1,
                         bitorder="little")
    k, bit = np.nonzero(bits)
    levels = wavemesh.level_wave_edges(
        bp, cand, rows[k], words[k].astype(np.int64) * 32 + bit)
    return levels[:b], time.perf_counter() - t0


def big_wave_check(stream, pool, card: str) -> dict:
    """Check (g) of phase 3c: the stream's first BIG_WAVE_BATCHES batches
    of BIG_WAVE_BATCH txns through a cuda wave engine on the object path.
    Every batch's K5 matrix (its nonzero words) goes to a worker for the
    host replay, checked by ``check_big_replay``; the last batch's K6 output
    and stats are held against ``wave_level_plain`` and K6 is timed on
    it."""
    import dataclasses

    import torch

    from foundationdb_tpu_torch.loadgen.ycsb import (
        MODES,
        batch_versions,
        build_txns,
    )
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    mode = dataclasses.replace(MODES["ycsb"], batch=BIG_WAVE_BATCH)
    n = min(BIG_WAVE_BATCHES, len(stream[0]) // mode.batch)
    cs = make_engine(mode, "cuda", wave=True)
    real, seen = ck.wave_level, []

    def capturing(cand, p, *args, **kw):
        out = real(cand, p, *args, **kw)
        seen.append((cand, p, args, out[1]))
        return out

    jobs, last, capture_s = [], None, 0.0
    ck.wave_level = capturing
    t0 = time.perf_counter()
    try:
        for i in range(n):
            cv, old = batch_versions(i)
            cs.resolve(build_txns(*stream, i, mode), cv, old)
            if len(seen) != 1:
                fail(f"big wave batch {i}: K6 ran {len(seen)} times")
            t1 = time.perf_counter()
            cand, p, args, levels = seen.pop()
            nz = torch.nonzero(p)
            vals = p[nz[:, 0], nz[:, 1]]
            b = cand.shape[0]
            jobs.append((levels.cpu().numpy().tolist(), pool.apply_async(
                replay_edges, (p.shape[0], b,
                               np.nonzero(cand.cpu().numpy())[0].tolist(),
                               nz[:, 0].cpu().numpy(), nz[:, 1].cpu().numpy(),
                               vals.cpu().numpy()))))
            if i == n - 1:
                last = (cand, p, args)
            capture_s += time.perf_counter() - t1
    finally:
        ck.wave_level = real
    wall = time.perf_counter() - t0
    if cs.overflowed:
        fail("big wave batches: the history overflowed")
    cand, p, (too_old, tm) = last[0], last[1], last[2][:2]
    st = [torch.zeros(5, dtype=torch.int64, device="cuda") for _ in range(2)]
    t1 = time.perf_counter()
    want = ck.wave_level_plain(cand, p, too_old, tm, stats=st[1])
    plain_s = time.perf_counter() - t1
    assert_equal("wave_level.big", ck.wave_level(cand, p, too_old, tm,
                                                 stats=st[0]), want)
    assert_equal("wave_level.big.stats", st[0], st[1])
    k6_ms = time_ms(lambda: ck.wave_level(cand, p, too_old, tm))
    _, rounds, victims, _, _ = (int(x) for x in st[0].cpu())
    ws = cs.wave_stats
    print(json.dumps({
        "check": "3c(g) big wave batches", "batch_size": mode.batch,
        "batches": n, "txns": n * mode.batch,
        "txns_per_s_with_capture": n * mode.batch / wall,
        "capture_s": capture_s,
        "k6_rounds_per_batch_mean": ws["rounds"] / ws["batches"],
        "k6_victims_per_batch_mean": ws["victims"] / ws["batches"],
        "last_batch": {"candidates": int(cand.sum()), "rounds": rounds,
                       "victims": victims, "k6_ms": k6_ms,
                       "plain_s": plain_s},
        "card": card}))
    return {"jobs": jobs, "batch": mode.batch}


def check_big_replay(gk: dict) -> None:
    """Check (g)'s host half: every batch's K6 levels equal the replay."""
    seconds = 0.0
    for i, (levels, job) in enumerate(gk["jobs"]):
        want, s = job.get()
        seconds += s
        if levels != want:
            fail(f"big wave batch {i}: K6 levels differ from the host "
                 "replay (wavemesh.level_wave_edges)")
    print(f"big wave batches: {len(gk['jobs'])} batches of {gk['batch']}: "
          f"K6 levels equal the host replay ({seconds:.1f} s in workers)")


def wave_phase(blob, ends, mode, n_batches: int, seed: int, card: str,
               stream, seq_rec: dict, wk: dict, pool) -> dict:
    """Phase 3c: the wave-commit engine on the window path, counted, then
    checks (a), (b), (d), (e), K6's phase counters on phase 2's captured
    batch, and check (g). Returns the wave rows' launch counts and check
    (g)'s replay jobs."""
    import torch

    from foundationdb_tpu_torch import bench, convert
    from foundationdb_tpu_torch.core import wavemesh
    from foundationdb_tpu_torch.loadgen.ycsb import (
        MODES,
        batch_versions,
        build_txns,
        build_wire_stream,
        gen_workload,
    )

    b = mode.batch
    n_windows = n_batches // WINDOW_K
    t0 = time.perf_counter()
    seconds = {}

    def lap(label: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        seconds[label] = now - t0
        t0 = now

    rec, verdicts, levels, cs, launches, per_window = counted_run(
        blob, ends, mode, n_batches, wave=True)
    lap("window_path")
    # (f) K5 and K6 on every batch, K3 never.
    for i, pw in enumerate(per_window):
        if (pw.get("wv_pred", 0) != WINDOW_K
                or pw.get("wv_level", 0) != WINDOW_K
                or pw.get("ac_accept", 0) or pw.get("di_insert", 0) > 1):
            fail(f"wave window {i}: K5 {pw.get('wv_pred', 0)}, K6 "
                 f"{pw.get('wv_level', 0)} launches (want {WINDOW_K} each),"
                 f" K3 {pw.get('ac_accept', 0)} (want 0), K1 insert "
                 f"{pw.get('di_insert', 0)} (want <= 1)")
    if launches["accept"]:
        fail("K3 was launched on the wave path")
    entries = {k: sum(pw.get(k, 0) for pw in per_window)
               for k in ("wv_pred", "wv_level")}
    st = cs.wave_stats

    # (a) Per-batch resolve_wire on a wave engine at the same versions.
    one = bench.make_engine(mode, CAP, "cuda", wave=True)
    rows, lrows = [], []
    t0 = time.perf_counter()
    for i in range(n_batches):
        lo, hi = int(ends[i * b]), int(ends[(i + 1) * b])
        rows.append(one.resolve_wire_async(blob[lo:hi], i + 1, count=b,
                                           as_array=True)())
        lrows.append(np.asarray(one.last_wave, np.int32))
    per_batch_s = time.perf_counter() - t0
    per_batch_sha = hashlib.sha256(np.concatenate(rows).tobytes()).hexdigest()
    if per_batch_sha != rec["verdicts_sha256"]:
        fail("wave window path and per-batch resolve_wire verdicts differ")
    if not np.array_equal(np.stack(lrows).reshape(levels.shape), levels):
        fail("wave window path and per-batch resolve_wire levels differ")
    print(json.dumps({
        "phase": "wave", "stream": "ycsb-a", "wave_commit": True,
        "txns": rec["txns"], "batches": rec["batches"],
        "window": rec["window"], "pipeline_depth": rec["pipeline_depth"],
        "threaded": rec["threaded"], "txns_per_s": rec["txns_per_s"],
        "window_ms_p50": rec["window_ms_p50"],
        "window_ms_p99": rec["window_ms_p99"],
        "committed": rec["committed"], "conflict": rec["conflict"],
        "too_old": rec["too_old"], "reordered": rec["reordered"],
        "cycle_aborted": rec["cycle_aborted"],
        "k6_rounds_per_batch_mean": st["rounds"] / st["batches"],
        "k6_rounds_per_batch_max": st["max_rounds"],
        "k6_victims_per_batch_mean": st["victims"] / st["batches"],
        "k6_victims_per_batch_max": st["max_victims"],
        "k5_launches_per_window": entries["wv_pred"] / n_windows,
        "k6_launches_per_window": entries["wv_level"] / n_windows,
        "host_syncs_per_window": rec["host_syncs_per_window"],
        "host_pack_ms_per_window": rec["host_pack_ms_per_window"],
        "pack_gate_wait_s": rec["pack_gate_wait_s"],
        "dict_stats": rec["dict_stats"],
        "verdicts_sha256": rec["verdicts_sha256"],
        "levels_sha256": rec["levels_sha256"],
        "per_batch_wire_txns_per_s": n_batches * b / per_batch_s,
        "sequential_committed": seq_rec["committed"],
        "card": card}))
    lap("a_per_batch")

    # (b) Window 0 on the CPU plain path: verdicts, levels, every leaf.
    got = {}
    for dev in ("cuda", "cpu"):
        e = bench.make_engine(mode, CAP, dev, wave=True)
        v = e.resolve_wire_window(
            *bench.window_wire(blob, ends, mode, WINDOW_K, 0), b)
        got[dev] = (v, e.last_wave_window, convert.snapshot(e)["state"])
    if not (np.array_equal(got["cpu"][0], verdicts[0])
            and np.array_equal(got["cuda"][0], verdicts[0])
            and np.array_equal(got["cpu"][1], levels[0])
            and np.array_equal(got["cuda"][1], levels[0])):
        fail("wave window 0: cuda and cpu verdicts or levels differ")
    for k, v in got["cpu"][2].items():
        if got["cuda"][2][k].tobytes() != v.tobytes():
            fail(f"wave window 0: state leaf {k} differs on cuda and cpu")
    print(f"cross-check wave window 0: {verdicts[0].size} txns, levels and "
          "every state leaf equal on cuda and cpu")
    lap("b_window0_cpu")

    # (d) mako and tpcc through the wave window path on cuda and the CPU.
    for mname in ("mako", "tpcc"):
        m = MODES[mname]
        n_cross = WAVE_CROSS_BATCHES
        mb, me = build_wire_stream(
            *gen_workload(n_cross * m.batch, N_KEYS, seed, m), n_cross, m)
        out = {dev: bench.run_wire(mb, me, m, n_cross, CAP, dev, window=4,
                                   pipeline_depth=WINDOW_DEPTH, repeats=1,
                                   warmup=False, wave=True)
               for dev in ("cuda", "cpu")}
        if (not np.array_equal(out["cuda"][1], out["cpu"][1])
                or not np.array_equal(out["cuda"][2], out["cpu"][2])
                or out["cuda"][0]["overflowed"]):
            fail(f"{mname} wave window path: cuda and cpu differ")
        r = out["cuda"][0]
        print(f"cross-check {mname} wave window path: {r['txns']} txns and "
              f"levels equal on cuda and cpu (committed {r['committed']}, "
              f"reordered {r['reordered']}, cycle-aborted "
              f"{r['cycle_aborted']}, K6 rounds per batch "
              f"{r['k6_rounds_per_batch']})")
    lap("d_mako_tpcc")

    # (e) Two shards on the card through the two-phase protocol against
    # the single wave engine, on the clipped halves of WAVE_CROSS_BATCHES
    # batches.
    n_two = min(WAVE_CROSS_BATCHES, n_batches)
    single = make_engine(mode, "cuda", wave=True)
    shards = [make_engine(mode, "cuda", wave=True) for _ in range(2)]
    mid = (N_KEYS // 2).to_bytes(8, "big")
    bounds = [(b"", mid), (mid, b"\xff" * 9)]
    for i in range(n_two):
        txns = build_txns(*stream, i, mode)
        cv, old = batch_versions(i)
        want = [int(v) for v in single.resolve(txns, cv, old)]
        edges = [s.resolve_edges(wavemesh.clip_txns(txns, lo, hi), cv, old)
                 for s, (lo, hi) in zip(shards, bounds)]
        graph = wavemesh.combine_edges(edges)
        for s in shards:
            if ([int(v) for v in s.resolve_apply(graph)] != want
                    or s.last_wave != single.last_wave):
                fail(f"two-phase batch {i}: a shard's verdicts or levels "
                     "differ from the single wave engine's")
    torch.cuda.synchronize()
    print(f"cross-check two-phase: {n_two} batches through 2 shards equal "
          "the single wave engine (verdicts and last_wave)")
    lap("e_two_phase")

    # K6's phase counters: its stats build on phase 2's captured batch.
    from foundationdb_tpu_torch import kernels as K

    cand, p, too_old, tm = wk["tensors"]
    clk = torch.zeros(len(K.WAVE_CLOCKS), dtype=torch.int64, device="cuda")
    got = K.wave_level(cand, p, too_old, tm, clocks=clk)
    if got[1].cpu().numpy().tolist() != wk["levels"]:
        fail("wave_level: the stats build's levels differ from K6's")
    print(json.dumps({"k6_phase_clocks": k6_phase_clocks(clk),
                      "wave_batch": wk["index"], "card": card}))

    lap("k6_clocks")

    # (g) 16 batches of 32,768 txns through a cuda wave engine.
    big = big_wave_check(stream, pool, card)
    lap("g_big_batches")
    print(json.dumps({"phase 3c seconds": seconds}))
    return {"launches": entries, "verdicts": verdicts, "levels": levels,
            "big": big}


def revoke_first(seq, verdicts):
    """Check (c)'s confirmation hook: the upper layer revokes the first
    accepted txn of every window."""
    conf = np.ones_like(verdicts, dtype=bool)
    acc = np.argwhere(verdicts == 0)
    if len(acc):
        conf[tuple(acc[0])] = False
    return conf


def spec_run(seed: int, device: str, depth: int, wave: bool,
             resident: bool = True, design: dict | None = None):
    """Check (c): SPEC_BATCHES batches of a YCSB-A stream over TIER_KEYS
    keys, windows of SPEC_K, through an unthreaded runner (every window
    submitted, then collected: one dispatch and reconcile order on every
    device) on a tiered speculative engine under ``revoke_first`` (with
    ``resident=False`` a non-resident speculative engine: phase 3g(c);
    ``design`` other constructor arguments in place of either: phase
    3i(d)).
    Returns (verdicts, levels or None, spec_metrics, state leaves as
    numpy, paint-only windows launched, seconds, [younger windows the
    dependency probe found clean, dependent], dict_stats); also run in a
    worker process for the CPU."""
    import torch

    from foundationdb_tpu_torch import bench, convert
    from foundationdb_tpu_torch.loadgen.ycsb import (
        MODES,
        build_wire_stream,
        gen_workload,
    )
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.sched.packing import PipelinedWindowRunner

    if device == "cpu":
        torch.set_num_threads(2)  # beside the cross-checks of phase 4
    t0 = time.perf_counter()
    mode = MODES["ycsb"]
    blob, ends = build_wire_stream(
        *gen_workload(SPEC_BATCHES * mode.batch, TIER_KEYS, seed, mode),
        SPEC_BATCHES, mode)
    if design is None:
        design = TIER if resident else {"resident": False}
    cs = bench.make_engine(mode, CAP, device, wave, spec_resolve=True,
                           spec_depth=depth, **design)
    cs.spec_confirm_hook = revoke_first
    deps = [0, 0]  # the dependency probe's answers: clean, dependent
    probe = cs._spec_dep_windows

    def counted_probe(*a):
        got = probe(*a)
        for d in got:
            deps[d] += 1
        return got

    cs._spec_dep_windows = counted_probe
    ck.reset_launches()
    runner = PipelinedWindowRunner(cs, threaded=False)
    out, levels = [], []
    try:
        for wi in range(SPEC_BATCHES // SPEC_K):
            runner.submit(*bench.window_wire(blob, ends, mode, SPEC_K, wi),
                          mode.batch)
        for _ in range(SPEC_BATCHES // SPEC_K):
            out.append(runner.collect_next())
            levels.append(cs.last_wave_window)
    finally:
        runner.close()
    state = convert.snapshot(cs)["state"]  # reconciles the ring first
    return (np.stack(out), np.stack(levels) if wave else None,
            cs.spec_metrics(), state, ck.LAUNCHES["paint_many"],
            time.perf_counter() - t0, deps, cs.dict_stats)


def same_spec(got, other, wave: bool, name: str, metrics: bool,
              stats: bool = False) -> None:
    """Check (c): two spec_run results agree in verdicts, levels, every
    state leaf and (with ``metrics``) spec_metrics; without, all but
    spec_flipped (depth 1 has no younger window to flip). With ``stats``
    (check (c′)) also in dict_stats."""
    label = "wave" if wave else "sequential"
    if not np.array_equal(got[0], other[0]) or (
            wave and not np.array_equal(got[1], other[1])):
        fail(f"adversarial {label}: verdicts or levels differ from {name}")
    keys = got[2].keys() - (set() if metrics else {"spec_flipped"})
    if any(got[2][k] != other[2][k] for k in keys):
        fail(f"adversarial {label}: spec_metrics {got[2]} vs {name} "
             f"{other[2]}")
    for k, v in other[3].items():
        if got[3][k].tobytes() != v.tobytes():
            fail(f"adversarial {label}: state leaf {k} differs from {name}")
    if stats and got[7] != other[7]:
        fail(f"adversarial {label}: dict_stats {got[7]} vs {name} "
             f"{other[7]}")


def check_spec_cpu(td: dict, cpu_spec: dict, label: str = "",
                   key: str = "spec_cuda") -> None:
    """Check (c)'s CPU half: depth 3 on the CPU (worker processes, beside
    phase 4) equals depth 3 on cuda (``td[key]``; check (c′):
    ``spec_tier_cuda``, dict_stats too)."""
    for wave, job in cpu_spec.items():
        cpu = job.get()
        same_spec(td[key][wave], cpu, wave, "depth 3 on the cpu",
                  metrics=True, stats=key == "spec_tier_cuda")
        if cpu[6] != td[key][wave][6]:
            fail(f"adversarial{label}: the dependency probe answered "
                 f"{cpu[6]} on the cpu, {td[key][wave][6]} on cuda")
        print(f"cross-check adversarial{label} "
              f"{'wave' if wave else 'sequential'}: depth 3 on cuda equals "
              f"depth 3 on the cpu ({cpu[5]:.1f} s in a worker process)")


def spec_tier(seed: int) -> dict:
    """Check (c′)'s engine: a tiered speculative engine over check (c)'s
    stream (SPEC_BATCHES batches over TIER_KEYS keys, windows of SPEC_K),
    sized from the stream's own ``dictionary_counts``: an MVCC window of
    SPEC_K versions (keys of older windows may demote), delta slots that
    hold the largest window's new keys, a hot tier of the keys touched by
    the end of window 1 plus one delta (windows 2 and 3 must demote), and
    evict chunks of a quarter delta (an event spans several)."""
    from foundationdb_tpu_torch.loadgen.ycsb import (
        MODES,
        dictionary_counts,
        gen_workload,
    )

    mode = MODES["ycsb"]
    stream = gen_workload(SPEC_BATCHES * mode.batch, TIER_KEYS, seed, mode)
    counts = dictionary_counts(*stream[:3], mode.batch, SPEC_K)
    delta = (max(counts["new"]) + 1024) // 1024 * 1024
    return {"dict_hot_capacity": counts["touched"][1] + delta,
            "dict_delta_slots": delta, "dict_demote_batch": delta // 4,
            "window_versions": SPEC_K}


def evict_capturer(apply_evict, out: list):
    """``apply_evict`` that appends (state before, evict vector, n_ev,
    n_live, state after, (K7, K1 rewrite) entries it made) to ``out``."""
    from foundationdb_tpu_torch import kernels as K

    def capturing(res, ev, n_ev=None, n_live=None):
        before = clone(res)
        was = (K.ENTRY_LAUNCHES.get("de_evict", 0),
               K.ENTRY_LAUNCHES.get("di_rewrite", 0))
        after = apply_evict(res, ev, n_ev, n_live)
        made = (K.ENTRY_LAUNCHES.get("de_evict", 0) - was[0],
                K.ENTRY_LAUNCHES.get("di_rewrite", 0) - was[1])
        out.append((before, ev.clone(), n_ev, n_live, clone(after), made))
        return after

    return capturing


def check_evict_captures(captures, label: str = "") -> None:
    """Every captured ``apply_evict`` call made one K7 launch and one K1
    rank rewrite, and equals the plain version (the dictionary, n_keys
    and every rank leaf after the rewrite); its K7 output equals K7's tile
    twin (the dictionary, n_keys and the shift)."""
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    for before, ev, n_ev, n_live, after, made in captures:
        if made != (1, 1):
            fail(f"dict_evict{label}: (K7, K1 rewrite) entries of one "
                 f"demotion {made}, want (1, 1)")
        plain = ck._dict_evict_plain(before.dict_keys, before.n_keys, ev)
        nd, nn, shift = plain
        h = before.hist
        bk, dk, lo, hi = ck._rewrite_ranks_plain(
            [h.base.keys, h.delta.keys, before.shard_lo, before.shard_hi],
            shift, False)
        assert_equal(f"dict_evict{label}", after, ck.ResState(
            nd, nn, ck.HistState(h.base._replace(keys=bk), h.base_st,
                                 h.delta._replace(keys=dk)), lo, hi))
        twin = ck.dict_evict_tiles_plain(before.dict_keys, before.n_keys, ev,
                                         n_ev, n_live)
        assert_equal(f"dict_evict.tile_twin{label}", twin, plain)


def tiered_phase(args, card: str) -> dict:
    """Phase 3d: the tiered speculative engine on the window path, and its
    checks (a), (b), (d) and the card's half of (c). Returns the K7 and
    paint-only rows' measurements and check (c)'s cuda runs, which
    ``check_spec_cpu`` holds against the CPU after phase 4."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.loadgen.ycsb import (
        MODES,
        build_wire_stream,
        dictionary_counts,
        gen_workload,
    )
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import upload

    mode = MODES["ycsb"]
    b = mode.batch
    t0 = time.perf_counter()
    seconds = {}

    def lap(label: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        seconds[label] = now - t0
        t0 = now

    stream = gen_workload(args.batches * b, TIER_KEYS, args.seed, mode)
    counts = dictionary_counts(*stream[:3], b, WINDOW_K)
    in_window, touched = max(counts["in_window"]), counts["touched"][-1]
    largest = max(counts["new"])
    print(json.dumps({"phase": "tiered dictionary counts (host)",
                      "keys": TIER_KEYS, **counts}))
    if not (in_window + TIER_DELTA < TIER_HOT < touched + TIER_DELTA
            and TIER_DELTA > largest):
        fail(f"tiered stream does not exercise the tier: in-window "
             f"{in_window} + M {TIER_DELTA} < H {TIER_HOT} < touched "
             f"{touched} + M, and M > largest delta {largest}, must hold")
    blob, ends, n_batches = wire_stream(stream, mode, args.batches)
    lap("stream")

    # (a) + (b): every K7 launch of the run is captured (state before and
    # after, the kernel entries it made) and checked against the plain
    # version and K7's tile twin once the run is over.
    captures = []
    apply_evict = ck.apply_evict
    ck.apply_evict = evict_capturer(apply_evict, captures)
    try:
        rec, _, _, cs, launches, per_window = counted_run(
            blob, ends, mode, n_batches, wave=False, label="tiered",
            engine={**TIER, "spec_resolve": True, "spec_depth": 2})
    finally:
        ck.apply_evict = apply_evict
    st, sm = rec["dict_stats"], rec["spec_metrics"]
    for i, pw in enumerate(per_window):
        if pw.get("ac_accept", 0) != WINDOW_K:
            fail(f"tiered window {i}: K3 launched {pw.get('ac_accept', 0)} "
                 f"times (want {WINDOW_K})")
    if (st["demotions"] <= 0 or st["demotion_events"] < 3
            or st["full_repacks"] or sm["spec_repaired"]
            or launches["dict_evict"] <= 0):
        fail(f"tiered run: demotions {st['demotions']}, events "
             f"{st['demotion_events']} (want >= 3), full repacks "
             f"{st['full_repacks']} (want 0), spec_repaired "
             f"{sm['spec_repaired']} (want 0), K7 launches "
             f"{launches['dict_evict']}")
    if not len(captures) == st["demotion_events"] == launches["dict_evict"]:
        fail(f"tiered run: {st['demotion_events']} demotion events, "
             f"{len(captures)} apply_evict calls, {launches['dict_evict']} "
             "K7 launches (want one of each an event)")
    plain = bench.run_wire(blob, ends, mode, n_batches, CAP, "cuda",
                           window=WINDOW_K, pipeline_depth=WINDOW_DEPTH,
                           repeats=1, warmup=False,
                           engine={"dict_delta_slots": TIER_DELTA})[0]
    if plain["verdicts_sha256"] != rec["verdicts_sha256"]:
        fail("tiered speculative engine and untiered engine verdicts differ")
    lap("a")
    print(json.dumps({
        "phase": "tiered", "stream": "ycsb-a", "keys": TIER_KEYS,
        "dict_hot_capacity": TIER_HOT, "dict_delta_slots": TIER_DELTA,
        "spec_depth": 2, "txns": rec["txns"], "batches": rec["batches"],
        "window": rec["window"], "pipeline_depth": rec["pipeline_depth"],
        "txns_per_s": rec["txns_per_s"],
        "window_ms_p50": rec["window_ms_p50"],
        "window_ms_p99": rec["window_ms_p99"],
        "committed": rec["committed"], "conflict": rec["conflict"],
        "too_old": rec["too_old"],
        **{k: st[k] for k in ("demotions", "promotions", "demotion_events",
                              "demotion_stalls", "demotion_bytes",
                              "cold_tier_keys", "resident_keys",
                              "full_repacks", "repack_stalls")},
        "k7_launches": launches["dict_evict"],
        "pack_gate_wait_s": rec["pack_gate_wait_s"],
        "host_syncs_per_window": rec["host_syncs_per_window"],
        "host_pack_ms_per_window": rec["host_pack_ms_per_window"],
        "spec_metrics": sm, "verdicts_sha256": rec["verdicts_sha256"],
        "untiered_txns_per_s": plain["txns_per_s"],
        "untiered_window_ms_p99": plain["window_ms_p99"],
        "untiered_full_repacks": plain["dict_stats"]["full_repacks"],
        "card": card}))

    # (b) Every K7 launch of (a) against the plain version and K7's tile
    # twin: the dictionary, n_keys and every rank leaf after the rewrite.
    check_evict_captures(captures)
    before, ev, n_ev, n_live, _, _ = captures[0]
    d1, w = before.dict_keys.shape
    e = ev.shape[0]
    k7 = (time_ms(lambda: K.dict_evict(before.dict_keys, before.n_keys, ev,
                                       n_ev, n_live)),
          time_ms(lambda: ck._dict_evict_plain(before.dict_keys,
                                               before.n_keys, ev), reps=3))
    keep = torch.ones(d1, dtype=torch.bool, device="cuda")
    keep[ev[:n_ev].long()] = False
    keep[int(before.n_keys):] = False
    library = time_ms(lambda: before.dict_keys[keep])
    whole = time_ms(lambda r: ck.apply_evict(r, ev, n_ev, n_live),
                    lambda: (clone(before),), reps=5)
    print(f"kernel dict_evict ({len(captures)} launches checked, D+1 {d1}, "
          f"E {e}, {n_ev} evicted): {k7[0]:.4f} ms (plain {k7[1]:.4f} ms; "
          f"dict_keys[keep_mask], the compaction only, {library:.4f} ms; "
          f"with K1's rank rewrite {whole:.4f} ms)")
    lap("b")

    # (d) One captured paint-only window (forced mask) against its plain
    # version: the second window of check (c)'s stream, K1 inserting.
    mb, me = build_wire_stream(
        *gen_workload(SPEC_BATCHES * b, TIER_KEYS, args.seed, mode),
        SPEC_BATCHES, mode)
    cs = bench.make_engine(mode, CAP, "cuda", **TIER)
    cs.resolve_wire_window(*bench.window_wire(mb, me, mode, SPEC_K, 0), b)
    prepared = cs.pack_wire_window(*bench.window_wire(mb, me, mode, SPEC_K, 1),
                                   b)
    hb = prepared.batch
    if not hb.n_new:
        fail("the paint-only capture has no dictionary delta")
    state = clone(cs.state)
    verdicts = cs.dispatch_window(prepared)()
    acc = np.zeros((SPEC_K, b), bool)
    acc[:, : prepared.count] = (verdicts == 0) & hb.ranks[7][:, : prepared.count]
    acc[np.arange(SPEC_K), acc.argmax(1)] = False  # revoke one per batch
    rb = upload(hb, cs.device)
    acc_t = torch.from_numpy(acc).cuda()
    cvs, olds = prepared.cvs_rel, prepared.olds_rel

    def paint(res):
        return ck.paint_many_res(res, rb, acc_t, cvs, olds, hb.n_new,
                                 hb.demand)

    def paint_plain(res):
        return ck.paint_many_res_plain(res, rb, acc_t, cvs, olds)

    assert_equal("paint_many", paint(clone(state)), paint_plain(clone(state)))
    pm = (time_ms(paint, lambda: (clone(state),), reps=5),
          time_ms(paint_plain, lambda: (clone(state),), reps=2))
    print(f"kernel paint_many (window of {SPEC_K}, n_new {hb.n_new}): "
          f"{pm[0]:.4f} ms (plain {pm[1]:.4f} ms)")
    torch.cuda.synchronize()
    lap("d")

    # (c) The adversarial hook at depth 3 on cuda against depth 1 on cuda
    # (here) and depth 3 on the CPU (check_spec_cpu), sequential and wave.
    spec_cuda = {}
    for wave in (False, True):
        got = spec_cuda[wave] = spec_run(args.seed, "cuda", 3, wave)
        same_spec(got, spec_run(args.seed, "cuda", 1, wave), wave,
                  "depth 1 on cuda", metrics=False)
        if got[2]["spec_repaired"] <= 0:
            fail(f"adversarial {'wave' if wave else 'sequential'}: no "
                 "window was repaired")
        print(f"cross-check adversarial {'wave' if wave else 'sequential'}: "
              f"{got[0].size} txns, depth 3 equals depth 1 on cuda "
              f"(spec_metrics {got[2]})")
    paint_launches = spec_cuda[False][4]
    if paint_launches <= 0:
        fail("the paint-only window was not launched under the adversary")
    lap("c")

    # (c′) The adversary across demotions: check (c)'s stream on a tiered
    # engine sized from its own dictionary counts to demote (spec_tier),
    # every K7 launch of its cuda runs captured and checked.
    tier = spec_tier(args.seed)
    tier_captures = []
    spec_tier_cuda = {}
    ck.apply_evict = evict_capturer(apply_evict, tier_captures)
    try:
        for wave in (False, True):
            k7_before = K.LAUNCHES["dict_evict"]
            got = spec_tier_cuda[wave] = spec_run(args.seed, "cuda", 3, wave,
                                                  design=tier)
            k7_launches = K.LAUNCHES["dict_evict"] - k7_before
            same_spec(got, spec_run(args.seed, "cuda", 1, wave, design=tier),
                      wave, "depth 1 on cuda", metrics=False, stats=True)
            label = "wave" if wave else "sequential"
            st = got[7]
            if (st["demotion_events"] < 2 or st["full_repacks"]
                    or got[2]["spec_repaired"] < 1):
                fail(f"adversarial across demotions {label}: demotion "
                     f"events {st['demotion_events']} (want >= 2), full "
                     f"repacks {st['full_repacks']} (want 0), spec_repaired "
                     f"{got[2]['spec_repaired']} (want >= 1)")
            if k7_launches != st["demotion_events"]:
                fail(f"adversarial across demotions {label}: {k7_launches} "
                     f"K7 launches for {st['demotion_events']} events")
            print(json.dumps({
                "check": "c′ adversary across demotions", "wave": wave,
                "txns": int(got[0].size), "depth_3_equals_depth_1": True,
                "k7_launches_depth_3": k7_launches,
                "demotion_chunks": st["demotion_bytes"]
                // (4 * tier["dict_demote_batch"]),
                **{k: st[k] for k in ("demotions", "demotion_events",
                                      "demotion_stalls", "demotion_bytes",
                                      "promotions", "full_repacks")},
                "spec_metrics": got[2], "engine": tier}))
    finally:
        ck.apply_evict = apply_evict
    check_evict_captures(tier_captures, ".across_demotions")
    lap("c′")
    print(json.dumps({"phase 3d seconds": seconds}))

    # Bounds of the timed captures. K7: the kept source rows
    # (n_keys - n_ev) and the evict vector's real ranks read, the [D+1, W]
    # output and the shift table written, n_keys read and written. The
    # paint-only window: K1's insert and rewrite once (as the K1 row's
    # basis) plus k paints (the K4 row's basis) at this window's shapes.
    kept = int(before.n_keys) - n_ev
    c = state.hist.base.keys.shape[0]
    cd = state.hist.delta.keys.shape[0]
    q = rb.ranks.write_begin.shape[-1]
    bytes_k4 = cd * 8 * 2 + b * q * 9 + b + 2 * b * q * 4
    paint_bytes = SPEC_K * bytes_k4 + k1_bytes(
        int(state.n_keys), hb.n_new, *state.dict_keys.shape, c, cd)
    return {"spec_cuda": spec_cuda, "spec_tier_cuda": spec_tier_cuda,
            "spec_tier": tier,
            "dict_evict": {"launches": launches["dict_evict"], "ms": k7[0],
                           "plain_ms": k7[1], "partial_library_ms": library,
                           "bound": bound(4 * (kept * w + d1 * w + d1 + n_ev)
                                          + 8)},
            "paint_many": {"launches": paint_launches, "ms": pm[0],
                           "plain_ms": pm[1], "bound": bound(paint_bytes)}}


def first_difference(got: np.ndarray, want: np.ndarray, batch: int) -> str:
    """The first txn at which two verdict streams (batch order) differ:
    its index, batch and both verdicts."""
    i = int(np.flatnonzero(got.reshape(-1) != want.reshape(-1))[0])
    return (f"txn {i} (batch {i // batch}, row {i % batch}): "
            f"{int(got.reshape(-1)[i])} vs {int(want.reshape(-1)[i])}")


def baseline_phase(stream, mode, n_batches: int, window_rec: dict,
                   card: str) -> None:
    """Phase 3l: (a) the pinned baseline (``bench.CPU_BASELINE_PIN``)
    through the port's CPU SkipList engine, one batch a call, and the same
    stream through the window path on the card (the bench's runner,
    window WINDOW_K, best of 3): txns/s, p50 and p99 of each with their
    units, ``vs_baseline`` and the verdict parity; (b) the skiplist over
    3b's stream, its verdict hash equal to 3b's. A verdict that differs
    fails the phase, naming the first differing txn."""
    from foundationdb_tpu_torch import bench

    pmode, pn, pstream = bench.pinned_stream()
    t0 = time.perf_counter()
    cpu_batches = bench.marshal_cpu_batches(pn, *pstream, pmode)
    marshal_s = time.perf_counter() - t0
    dt, conf, lat, cpu_v = bench.run_cpu(cpu_batches, pmode)
    cpu = {"config": dict(bench.CPU_BASELINE_PIN),
           **bench.cpu_record(pn * pmode.batch, dt, conf, lat, cpu_v)}
    blob, ends, _ = wire_stream(pstream, pmode, pn)
    rec, verdicts, _, _ = bench.run_wire(
        blob, ends, pmode, pn, CAP, "cuda", window=WINDOW_K,
        pipeline_depth=WINDOW_DEPTH, repeats=3)
    if rec["verdicts_sha256"] != cpu["verdicts_sha256"]:
        fail("baseline (a): the skiplist's and the card's verdicts differ "
             "at " + first_difference(cpu_v, verdicts, pmode.batch))
    print(json.dumps({
        "phase": "baseline (a) pinned", "config": cpu["config"],
        "cpu_skiplist": {k: cpu[k] for k in (
            "txns_per_sec", "elapsed_s", "p50_ms", "p99_ms",
            "latency_samples", "conflicts")},
        "cpu_latency_unit": "ms a batch of 8192 txns",
        "cpu_marshal_s_untimed": marshal_s,
        "card_window_path": {k: rec[k] for k in (
            "txns_per_s", "seconds", "window_ms_p50", "window_ms_p99",
            "window", "pipeline_depth", "conflict")},
        "card_latency_unit": f"ms a window of {rec['window']} batches "
                             f"of 8192 txns",
        **bench.baseline_fields(rec, cpu),
        "verdicts_sha256": rec["verdicts_sha256"], "card": card}))
    t0 = time.perf_counter()
    cpu_batches = bench.marshal_cpu_batches(n_batches, *stream, mode)
    marshal_s = time.perf_counter() - t0
    dt, conf, lat, cpu_v = bench.run_cpu(cpu_batches, mode)
    big = bench.cpu_record(n_batches * mode.batch, dt, conf, lat, cpu_v)
    if big["verdicts_sha256"] != window_rec["verdicts_sha256"]:
        fail("baseline (b): the skiplist's verdicts differ from 3b's hash "
             f"({big['verdicts_sha256']} vs "
             f"{window_rec['verdicts_sha256']})")
    print(json.dumps({
        "phase": "baseline (b) 3b stream", "keys": N_KEYS,
        "txns": n_batches * mode.batch,
        "cpu_skiplist": {k: big[k] for k in (
            "txns_per_sec", "elapsed_s", "p50_ms", "p99_ms",
            "latency_samples", "conflicts", "machine_state")},
        "cpu_latency_unit": "ms a batch of 8192 txns",
        "cpu_marshal_s_untimed": marshal_s,
        **bench.baseline_fields(window_rec, big),
        "verdicts_sha256": big["verdicts_sha256"], "card": card}))


def sharded_engine(stream, mode, uniform: bool = False) -> dict:
    """Constructor arguments of phase 3e's engine: SHARDS shards split at
    the density quantiles of the stream's sample (``uniform``: first-byte
    prefixes), auto-reshard off, as the bench makes it."""
    from foundationdb_tpu_torch import bench

    return bench.sharded_engine(
        SHARDS, None if uniform else bench.density_sample(stream[1], mode))


def sharded_window0(seed: int, n_batches: int, device: str,
                    resident: bool = True):
    """Check (e) of phase 3e (and, with ``resident`` False, of 3h): window
    0 of the YCSB-A stream through a sharded engine on ``device``. Returns
    (verdicts [k, B], state leaves as numpy, seconds); run in a worker
    process for the CPU."""
    import torch

    from foundationdb_tpu_torch import bench, convert
    from foundationdb_tpu_torch.loadgen.ycsb import MODES, gen_workload

    if device == "cpu":
        torch.set_num_threads(2)  # beside the cross-checks of phase 4
    t0 = time.perf_counter()
    mode = MODES["ycsb"]
    stream = gen_workload(n_batches * mode.batch, N_KEYS, seed, mode)
    blob, ends, _ = wire_stream(stream, mode, WINDOW_K)
    engine = sharded_engine(stream, mode)
    if not resident:
        engine["resident"] = False
    cs = bench.make_engine(mode, CAP, device, **engine)
    v = cs.resolve_wire_window(
        *bench.window_wire(blob, ends, mode, WINDOW_K, 0), mode.batch)
    return v, convert.snapshot(cs)["state"], time.perf_counter() - t0


def check_sharded_cpu(sh: dict, job, label: str = "sharded") -> None:
    """Check (e)'s CPU half: window 0 on the CPU (a worker process, beside
    phase 4) equals the card's in verdicts and every state leaf."""
    v, state, seconds = job.get()
    cv, cstate, _ = sh["window0_cuda"]
    if not np.array_equal(v, cv):
        fail(f"{label} window 0: cuda and cpu verdicts differ")
    for k, a in state.items():
        if cstate[k].tobytes() != a.tobytes():
            fail(f"{label} window 0: state leaf {k} differs on cuda and cpu")
    print(f"cross-check {label} window 0: {v.size} txns and every state "
          f"leaf equal on cuda and cpu ({seconds:.1f} s in a worker process)")


def sharded_phase(blob, ends, mode, n_batches: int, stream, seed: int,
                  card: str, seq_rec: dict, wave_out: dict) -> dict:
    """Phase 3e: the sharded engine (SHARDS shards on the card) on the
    window path, counted, and checks (a)-(d) and the card's half of (e).
    Returns the K8, K9, K10 and sharded window program rows'
    measurements."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import _RepackPlan, upload

    b = mode.batch
    n_windows = n_batches // WINDOW_K
    t0 = time.perf_counter()
    seconds = {}

    def lap(label: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        seconds[label] = now - t0
        t0 = now

    engine = sharded_engine(stream, mode)
    # (a) The window path, counted: per window K8 and K3 k times, K4's
    # paint S·k times, K1's insert at most once, K2's table never (K8
    # builds its own over the shards' live rows).
    rec, _, _, cs, launches, per_window = counted_run(
        blob, ends, mode, n_batches, wave=False, engine=engine,
        label="sharded", program="sharded_many", sources=SHARD_SEQ)
    for i, pw in enumerate(per_window):
        want = {"sh_probe": WINDOW_K, "sh_clip": WINDOW_K,
                "ac_accept": WINDOW_K, "sc_paint": SHARDS * WINDOW_K}
        if (any(pw.get(e, 0) != n for e, n in want.items())
                or pw.get("di_insert", 0) > 1 or pw.get("hp_table", 0)):
            fail(f"sharded window {i}: launches {pw} (want {want}, K1 "
                 "insert <= 1, no K2 table)")
    if rec["verdicts_sha256"] != seq_rec["verdicts_sha256"]:
        fail("sharded window path and the single engine's (phase 3b) "
             "verdicts differ")
    entries = {e: sum(pw.get(e, 0) for pw in per_window)
               for e in ("sh_probe", "sh_clip")}
    print(json.dumps({
        "phase": "sharded", "stream": "ycsb-a", "shards": SHARDS,
        "splits": [x.hex() for x in engine["splits"]],
        **{k: rec[k] for k in (
            "txns", "batches", "window", "pipeline_depth", "threaded",
            "txns_per_s", "window_ms_p50", "window_ms_p99", "committed",
            "conflict", "too_old", "verdicts_sha256", "shard_occupancy",
            "host_syncs_per_window", "host_pack_ms_per_window",
            "pack_gate_wait_s", "dict_stats")},
        "launches_per_window": {**{k: launches[k] / n_windows
                                   for k in (*SHARD_SEQ, "shard")},
                                **{e: n / n_windows
                                   for e, n in entries.items()}},
        "single_engine_sha_equal": True, "card": card}))
    lap("a")

    # (b) Uniform splits (every key below 2^20 lies in shard 0), then a
    # reshard to the density splits at the middle of the stream.
    mid = n_windows // 2
    rb_rec = bench.run_wire(
        blob, ends, mode, n_batches, CAP, "cuda", window=WINDOW_K,
        pipeline_depth=WINDOW_DEPTH, repeats=1, warmup=False,
        engine=sharded_engine(stream, mode, uniform=True),
        reshard=(mid, engine["splits"]))[0]
    if rb_rec["verdicts_sha256"] != seq_rec["verdicts_sha256"]:
        fail("resharded sharded run and the single engine's verdicts differ")
    if rb_rec["reshard"]["moved_shards"] <= 0 or rb_rec["overflowed"]:
        fail(f"reshard: {rb_rec['reshard']} (want moved shards > 0), "
             f"overflowed {rb_rec['overflowed']}")
    print(json.dumps({
        "phase": "sharded reshard", "reshard": rb_rec["reshard"],
        "shard_occupancy": rb_rec["shard_occupancy"],
        "txns_per_s": rb_rec["txns_per_s"],
        "verdicts_sha256": rb_rec["verdicts_sha256"], "card": card}))
    lap("b")

    # (c) A wave engine of SHARDS shards on the first two windows against
    # phase 3c's single wave engine: verdicts and levels; the exchange is
    # K5's OR mode, S launches a batch (never K10's old sh_exchange), each
    # fused exchange held against the plain twin after the run.
    n_wave = 2 * WINDOW_K
    wb, we = blob[: int(ends[n_wave * b])], ends[: n_wave * b + 1]
    caps, restore = capture_launches()
    try:
        wrec, wv, wl, _, _, wpw = counted_run(
            wb, we, mode, n_wave, wave=True, engine=engine,
            label="sharded wave", program="sharded_many", sources=SHARD_WAVE)
    finally:
        restore()
    checked = check_launches(caps, "3e_c")
    if not (np.array_equal(wv, wave_out["verdicts"][:2])
            and np.array_equal(wl, wave_out["levels"][:2])):
        fail("sharded wave engine: verdicts or levels differ from the "
             "single wave engine's (phase 3c)")
    for i, pw in enumerate(wpw):
        if (pw.get("sh_exchange", 0) or pw.get("wv_pred", 0)
                or pw.get("wv_pred_or", 0) != SHARDS * WINDOW_K
                or pw.get("wv_level", 0) != WINDOW_K or pw.get("ac_accept")
                or pw.get("hp_table", 0)):
            fail(f"sharded wave window {i}: launches {pw}")
    if checked["exchange"] < n_wave:
        fail(f"sharded wave: {checked['exchange']} fused exchanges checked "
             f"for {n_wave} batches")
    xs = wrec["exchange_stats"]
    if not 0 < xs["tiles_occupied"] <= xs["tiles_total"]:
        fail(f"exchange_stats {xs}")
    k10_launches = sum(pw.get("wv_pred_or", 0) for pw in wpw)
    print(json.dumps({"phase": "sharded wave", "txns": wrec["txns"],
                      "committed": wrec["committed"],
                      "reordered": wrec["reordered"],
                      "cycle_aborted": wrec["cycle_aborted"],
                      "exchange_stats": xs,
                      "k5_or_mode_launches": k10_launches,
                      "exchanges_checked": checked["exchange"],
                      "levels_equal_phase_3c": True, "card": card}))
    lap("c")

    # (d) One captured step launch by launch, and one captured window
    # program, against the plain versions: the first window after window
    # 0 that brings a dictionary delta.
    cs = bench.make_engine(mode, CAP, "cuda", **engine)
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, WINDOW_K, 0),
                           b)
    for wi in range(1, n_windows):
        prepared = cs.pack_wire_window(
            *bench.window_wire(blob, ends, mode, WINDOW_K, wi), b)
        hb = prepared.batch
        if not isinstance(hb, _RepackPlan) and hb.n_new:
            break
        cs.dispatch_window(prepared)()
    else:
        fail("no window of the stream brings a dictionary delta")
    rb = upload(hb, cs.device)
    cvs, olds = prepared.cvs_rel, prepared.olds_rel
    state = cs.state
    res1 = ck.apply_delta(clone(state), rb.delta_keys, hb.n_new)
    rbk = ck._step(rb.ranks, 0)
    h, lo, hi = res1.hist, res1.shard_lo, res1.shard_hi
    floor = torch.maximum(h.oldest, torch.full(
        (), int(olds[0]), dtype=torch.int32, device="cuda"))
    # K9 through its checked entry and as the window program launches it
    # (buffers and checks once a window, ck.WindowClip).
    wclips = {reads: ck.WindowClip.of(rb.ranks, lo, hi, reads)
              for reads in (False, True)}
    for reads in (False, True):
        want = [x for x in ck.shard_clip_plain(rbk, lo, hi, reads)
                if x is not None]
        assert_equal("shard_clip",
                     [x for x in ck.shard_clip(rbk, lo, hi, reads)
                      if x is not None], want)
        assert_equal("shard_clip.window",
                     [x for x in wclips[reads].step(rbk) if x is not None],
                     want)
    assert_equal("shard_probe", ck.shard_probe(h, rbk, lo, hi, floor[0]),
                 ck.shard_probe_plain(h, rbk, lo, hi, floor[0]))
    assert_equal("shard_probe.live_twin",
                 ck.shard_probe(h, rbk, lo, hi, floor[0]),
                 ck.shard_probe_live_plain(h, rbk, lo, hi, floor[0]))
    # K8 at full shards (n_used = C, ranges up to a whole shard) against
    # its plain version: every search and the live table's top at scale.
    fh, frb, fre, fm, frv, ftm, flo, fhi = full_shards(
        SHARDS, h.keys.shape[1], 0, b, rbk.read_begin.shape[1], seed)
    frbk = rbk._replace(read_begin=frb, read_end=fre, read_mask=fm,
                        read_version=frv, txn_mask=ftm)
    assert_equal("shard_probe.full", ck.shard_probe(fh, frbk, flo, fhi,
                                                    floor[0]),
                 ck.shard_probe_plain(fh, frbk, flo, fhi, floor[0]))
    too_old, _, cand = ck.shard_probe(h, rbk, lo, hi, floor[0])
    clip_w = ck.shard_clip(rbk, lo, hi, True)
    xranks = [ck._clip_live(clip_w, s) for s in range(SHARDS)]
    ps = torch.stack([ck.wave_pred_matrix_plain(cand, x) for x in xranks])
    for s, x in enumerate(xranks):  # the two-phase payload's plain store
        assert_equal("wave_pred.sharded", ck.wave_pred_matrix(cand, x), ps[s])
    assert_equal("wave_exchange", ck.shard_pred_exchange(cand, clip_w),
                 ck.wave_exchange_plain(ps))

    def many(res):
        v, _, _, r = ck.sharded_resolve_res_many(res, rb, cvs, olds, hb.n_new)
        return v, r

    def many_plain(res):
        v, _, _, r = ck.sharded_resolve_res_many_plain(res, rb, cvs, olds)
        return v, r

    assert_equal("sharded_many", many(clone(state)), many_plain(clone(state)))
    torch.cuda.synchronize()

    pairs = torch.stack([rbk.write_begin, rbk.write_end])
    lo4, hi4 = lo[:, None, None, None], hi[:, None, None, None]
    f0 = floor[0]  # shard 0's floor (0-dim), made once outside the timing
    t = {
        "shard_clip": (time_ms(lambda: wclips[False].step(rbk)),
                       time_ms(lambda: ck.shard_clip_plain(rbk, lo, hi,
                                                           False))),
        "shard_probe": (
            time_ms(lambda: ck.shard_probe(h, rbk, lo, hi, f0)),
            time_ms(lambda: ck.shard_probe_plain(h, rbk, lo, hi, f0),
                    reps=3)),
        "wave_exchange": (
            time_ms(lambda: ck.shard_pred_exchange(cand, clip_w)),
            time_ms(lambda: ck.shard_pred_exchange(cand, clip_w, plain=True),
                    reps=2)),
        "sharded_many": (time_ms(many, lambda: (clone(state),), reps=5),
                         time_ms(many_plain, lambda: (clone(state),), reps=2)),
    }
    clamp_ms = time_ms(lambda: torch.clamp(pairs[None], lo4, hi4))
    entry_ms = time_ms(lambda: ck.shard_clip(rbk, lo, hi, False))
    c = h.keys.shape[1]
    n_used = [int(x) for x in h.n_used.cpu()]
    k8 = live_probe_report(lambda: ck.shard_probe(h, rbk, lo, hi, f0),
                           SHARDS, c, n_used)
    k8["full_shard_ms"] = time_ms(lambda: ck.shard_probe(fh, frbk, flo, fhi,
                                                         f0))
    k8["full_shard_device_ms"] = cuda_kernels(lambda: ck.shard_probe(
        fh, frbk, flo, fhi, f0))["device_ms"] or None
    for name, (ms, plain) in t.items():
        print(f"kernel {name}: {ms:.4f} ms (plain {plain:.4f} ms)")
    check_live_probe("shard_probe", k8)
    print_live_probe("shard_probe", k8, c)
    print(f"kernel shard_clip: the window program's launch "
          f"{t['shard_clip'][0]:.4f} ms, the checked entry (allocating) "
          f"{entry_ms:.4f} ms, torch.clamp over the stacked write ranks "
          f"{clamp_ms:.4f} ms")

    # Bounds at the capture's shapes. K9 (writes only, the main path): the
    # write ranks and masks read once, S clipped copies written. K8: the
    # shards' live keys and versions, the read slots, read versions and
    # txn mask read once, three [B] outputs written. K10, the fused
    # exchange (exchange_bound): each shard's clipped ranks read once, the
    # one matrix and the stats written. The window program: K1 once,
    # then per step K9, K8, K3 and S flat paints (each shard's live rows
    # read, its [C] arrays written, the clipped writes read).
    r = rbk.read_begin.shape[1]
    q = rbk.write_begin.shape[1]
    d1, w = state.dict_keys.shape
    bytes_k9 = b * q * 9 + SHARDS * b * q * 9 + 8 * SHARDS
    bytes_k8 = 8 * sum(n_used) + b * r * 9 + 5 * b + 8 * SHARDS + 4 + 3 * b
    bytes_k10, ops_k10 = exchange_bound(cand, xranks)
    idx = torch.nonzero(cand).flatten().double()
    ops_k3 = float(3 * r * q * idx.sum())
    bytes_k3 = 3 * b + b * r * 9 + b * q * 9 + 2 * b
    bytes_k4 = sum(8 * n + 8 * c + b * q * 9 + b + 2 * b * q * 4
                   for n in n_used)
    bytes_k1 = 4 * ((int(state.n_keys) + hb.n_new) * w + d1 * w
                    + 2 * SHARDS * c)
    step = {"bytes": 0.0, "operations": 0.0}
    for nbytes, ops, times in ((bytes_k1, 0.0, 1),
                               (bytes_k9 + bytes_k8 + bytes_k4, 0.0,
                                WINDOW_K),
                               (bytes_k3, ops_k3, WINDOW_K)):
        lo_ms, by = bound(nbytes, ops)
        step[by] += lo_ms * times
    lap("d")
    # (e) The card's half: window 0 on cuda (the CPU half runs in a worker
    # beside phase 4, checked by check_sharded_cpu).
    window0 = sharded_window0(seed, len(stream[0]) // b, "cuda")
    lap("e")
    print(json.dumps({"phase 3e seconds": seconds}))
    return {
        "window0_cuda": window0,
        "shard_probe": {"launches": entries["sh_probe"],
                        "timing": t["shard_probe"],
                        "bound": bound(bytes_k8), **k8},
        "shard_clip": {"launches": entries["sh_clip"],
                       "timing": t["shard_clip"], "bound": bound(bytes_k9),
                       "library_ms": clamp_ms, "entry_ms": entry_ms},
        "wave_exchange": {"launches": k10_launches,
                          "timing": t["wave_exchange"],
                          "bound": bound(bytes_k10, ops_k10)},
        "sharded_many": {"launches": launches["sharded_many"],
                         "timing": t["sharded_many"],
                         "bound": (sum(step.values()),
                                   max(step, key=step.get))},
    }


def admission_filter(device):
    """Phase 3f's device filter: ADM's geometry, the stream's MVCC window
    (WINDOW versions over 4 banks: the banks rotate every 16 batches)."""
    from foundationdb_tpu_torch.admission import RecentWritesFilter
    from foundationdb_tpu_torch.loadgen.ycsb import WINDOW

    return RecentWritesFilter(window_versions=WINDOW, backend="device",
                              device=device, **ADM)


def tiered_admission_run(seed: int, device: str):
    """Phase 3f(c): the first ADM_TIER_BATCHES batches of the YCSB-A
    stream on the object path through a tiered resident engine with a
    device filter attached, its MVCC window ADM_TIER_WINDOW versions, its
    hot tier sized from ``ycsb.dictionary_counts`` so that it fills at
    the middle of the run and must demote (the filter's recent writes
    held back). Returns (verdicts, dict_stats, the filter's banks as
    bool numpy, admission launches, seconds); also run in a worker
    process for the CPU."""
    import torch

    from foundationdb_tpu_torch import TorchConflictSet
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.loadgen.ycsb import (
        KEY_BYTES,
        MODES,
        batch_versions,
        build_txns,
        dictionary_counts,
        gen_workload,
    )

    if device == "cpu":
        torch.set_num_threads(2)  # beside the cross-checks of phase 4
    t0 = time.perf_counter()
    mode = MODES["ycsb"]
    b = mode.batch
    n = ADM_TIER_BATCHES
    stream = gen_workload(n * b, N_KEYS, seed, mode)
    counts = dictionary_counts(*stream[:3], b, 1)
    delta = (max(counts["new"]) + 1024) // 1024 * 1024
    hot = counts["touched"][n // 2] + delta
    cs = TorchConflictSet(
        capacity=CAP, batch_size=b, max_read_ranges=mode.n_reads,
        max_write_ranges=mode.n_writes, max_key_bytes=KEY_BYTES,
        window_versions=ADM_TIER_WINDOW, dict_hot_capacity=hot,
        dict_delta_slots=delta, device=device)
    f = admission_filter(device)
    cs.attach_admission_filter(f)
    K.reset_launches()
    out = []
    for i in range(n):
        cv, old = batch_versions(i)
        out.append(np.asarray([int(v) for v in cs.resolve(
            build_txns(*stream, i, mode), cv, old)], np.int8))
    bits = f._bits.bool_banks().cpu().numpy()
    return (np.concatenate(out), cs.dict_stats, bits,
            K.LAUNCHES["admission"], time.perf_counter() - t0)


def admission_phase(stream, mode, verdicts, seed: int, card: str) -> dict:
    """Phase 3f: (a) the first ADM_BATCHES batches of the stream on the
    object path through a resident cuda engine with a device filter
    attached: phase 3's verdicts, K11 launched, the banks rotated, the
    saturation printed; (b) the banks equal a numpy filter fed the same
    fingerprints and versions, and the captured batch's K11 launches
    (clear, set) and a probe and count of its banks equal the plain
    versions; (c) the card's half of the tiered run (its CPU half runs
    in a worker beside phase 4). Returns K11's row measurements."""
    import torch

    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.admission import RecentWritesFilter
    from foundationdb_tpu_torch.admission import filter as af
    from foundationdb_tpu_torch.loadgen.ycsb import (
        WINDOW,
        batch_versions,
        build_txns,
    )

    b = mode.batch
    t0 = time.perf_counter()
    cs = make_engine(mode, "cuda")
    f = admission_filter("cuda")
    cs.attach_admission_filter(f)
    calls, cap = [], {}
    record, advance = f.record_u64, f.advance

    def recording(fps, version):
        calls.append(("record", np.array(fps, copy=True), version))
        if len(calls) != ADM_CAPTURE:
            return record(fps, version)
        cap.update(before=f._bits.bits.clone(), cur=f._cur,
                   rotations=f.rotations)
        record(fps, version)
        cap.update(after=f._bits.bits.clone(), bank=f._cur,
                   cleared=f.rotations - cap["rotations"],
                   idx=f._idx(fps).reshape(-1), bank_max=f.bank_max.copy(),
                   version=version)

    def advancing(version):
        calls.append(("advance", None, version))
        advance(version)

    f.record_u64, f.advance = recording, advancing
    K.reset_launches()
    got = []
    for i in range(ADM_BATCHES):
        cv, old = batch_versions(i)
        got.append(np.asarray([int(v) for v in cs.resolve(
            build_txns(*stream, i, mode), cv, old)], np.int8))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = K.LAUNCHES["admission"]
    entries = {e: K.ENTRY_LAUNCHES.get(e, 0) for e in ("ad_set", "ad_clear")}
    if not np.array_equal(np.concatenate(got), verdicts[: ADM_BATCHES * b]):
        fail("admission: the filtered engine's verdicts differ from phase 3")
    if not (launches > 0 and f.rotations > 0 and cap):
        fail(f"admission: {launches} K11 launches, {f.rotations} rotations, "
             f"captured {bool(cap)}")
    sat = f.saturation()
    print(json.dumps({"phase": "admission", "batches": ADM_BATCHES,
                      "txns_per_s": ADM_BATCHES * b / run_s,
                      "filter": f.metrics(), "saturation": sat,
                      "k11_launches": launches, **entries, "card": card}))

    # (b) the banks against a numpy filter fed the same calls ...
    ref = RecentWritesFilter(window_versions=WINDOW, backend="numpy", **ADM)
    for kind, fps, v in calls:
        (ref.record_u64(fps, v) if kind == "record" else ref.advance(v))
    if f._bits.bool_banks().cpu().numpy().tobytes() != ref._bits.bits.tobytes():
        fail("admission: the device banks differ from the numpy filter's")
    for k in ("bank_min", "bank_max", "_cur", "_cur_from", "rotations",
              "recorded"):
        if not np.array_equal(getattr(f, k), getattr(ref, k)):
            fail(f"admission: {k} differs from the numpy filter's")
    if ref.saturation() != sat:
        fail(f"admission: saturation {sat} vs numpy {ref.saturation()}")
    # ... and the captured batch's launches against the plain versions.
    nbits = f.nbits
    bits = af.unpack_banks(cap["before"], nbits)
    for j in range(cap["cleared"]):
        bits[(cap["cur"] + 1 + j) % f.banks] = False
    idx = torch.from_numpy(cap["idx"]).cuda()
    af.banks_set_plain(bits, cap["bank"], idx)
    assert_equal("admission.set", af.unpack_banks(cap["after"], nbits), bits)
    probe_fps = np.concatenate([c[1] for c in calls[ADM_CAPTURE:]
                                if c[0] == "record"])
    pidx = torch.from_numpy(f._idx(probe_fps)).cuda()
    mask = torch.from_numpy(cap["bank_max"] > cap["version"] - 8).cuda()
    words = cap["after"]
    assert_equal("admission.probe",
                 K.admission_probe(words, pidx, mask, nbits),
                 af.banks_probe_plain(bits, pidx, mask))
    assert_equal("admission.count", K.admission_count(words).long(),
                 af.banks_count_plain(bits))
    bank = cap["bank"]
    scratch = [words.clone() for _ in range(12)]
    ms = time_ms(lambda w: K.admission_set(w, bank, idx, nbits),
                 lambda: (scratch.pop(),))
    plain = time_ms(lambda x: af.banks_set_plain(x, bank, idx),
                    lambda: (bits.clone(),))
    library = time_ms(lambda x: x[bank].index_fill_(0, idx, True),
                      lambda: (bits.clone(),))
    probe_ms = time_ms(lambda: K.admission_probe(words, pidx, mask, nbits))
    count_ms = time_ms(lambda: K.admission_count(words))
    touched = int(torch.unique(idx >> 5).numel())
    print(f"kernel admission set (m*k {idx.numel()}, bank {bank}): "
          f"{ms:.4f} ms (plain {plain:.4f} ms, index_fill_ on bool banks "
          f"{library:.4f} ms); probe of {pidx.shape[0]} rows {probe_ms:.4f} "
          f"ms, count {count_ms:.4f} ms")
    return {"launches": launches, "ms": ms, "plain_ms": plain,
            "library_ms": library,
            "bound": bound(8 * idx.numel() + 8 * touched),
            "tiered": tiered_admission_run(seed, "cuda")}


def check_tiered_admission(ad: dict, job) -> None:
    """Phase 3f(c): the tiered engine with a filter on the CPU (a worker,
    beside phase 4) equals the card's run: verdicts, dict_stats, banks."""
    v, st, bits, _, seconds = job.get()
    cv, cst, cbits, launches, _ = ad["tiered"]
    if cst["demotion_events"] < 1:
        fail(f"tiered admission run: no demotion ({cst})")
    if launches <= 0:
        fail("tiered admission run: K11 was not launched")
    if not np.array_equal(v, cv) or st != cst:
        fail(f"tiered admission run: cuda and cpu differ ({cst} vs {st})")
    if bits.tobytes() != cbits.tobytes():
        fail("tiered admission run: the banks differ on cuda and cpu")
    print(f"cross-check tiered admission: {v.size} txns, dict_stats "
          f"(demotions {st['demotions']}, events {st['demotion_events']}, "
          f"full repacks {st['full_repacks']}) and banks equal on cuda and "
          f"cpu ({seconds:.1f} s in a worker process)")


def nonresident_phase(blob, ends, mode, n_batches: int, seed: int, card: str,
                      seq_rec: dict, wave_out: dict) -> dict:
    """Phase 3g: the packed non-resident engine. (a) The stream of 3b
    through the same runner: 3b's hash, no overflow, per window K12's
    search and probe, K13's paint and K3 k times, never K1 or K4. (b) A
    wave engine over the first 16 batches equals 3c's verdicts and
    levels. (c) Check (c)'s adversary at depth 3 equals depth 1 on cuda
    (and depth 3 on the CPU, in a worker beside phase 4); the dependency
    probe's answers are printed. (d) ``kp_pack_window`` equals
    ``_pack_dict`` on one window. (e) One captured step launch by launch
    and one captured window program equal their plain versions. Returns
    the K12, K13 and window program rows' measurements."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import HostBatch, upload
    from foundationdb_tpu_torch import native

    b = mode.batch
    n_windows = n_batches // WINDOW_K
    nr = {"resident": False}
    t0 = time.perf_counter()
    seconds = {}

    def lap(label: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        seconds[label] = now - t0
        t0 = now

    # (a)
    rec, _, _, _, launches, per_window = counted_run(
        blob, ends, mode, n_batches, wave=False, engine=nr,
        label="non-resident", program="packed_many", sources=NR_SEQ)
    for i, pw in enumerate(per_window):
        want = {e: WINDOW_K for e in ("wp_search", "wp_probe", "wc_paint",
                                      "wc_fold_step", "hp_table",
                                      "ac_accept")}
        if (any(pw.get(e, 0) != n for e, n in want.items())
                or any(pw.get(e, 0) for e in NR_NEVER)):
            fail(f"non-resident window {i}: launches {pw} (want {want}, "
                 f"never {NR_NEVER})")
    if rec["verdicts_sha256"] != seq_rec["verdicts_sha256"]:
        fail("non-resident window path and the resident engine's (phase 3b) "
             "verdicts differ")
    entries = {e: sum(pw.get(e, 0) for pw in per_window)
               for e in ("wp_search", "wp_probe", "wc_paint", "wc_fold_step",
                         "hp_table")}
    print(json.dumps({
        "phase": "non-resident", "stream": "ycsb-a",
        **{k: rec[k] for k in (
            "txns", "batches", "window", "pipeline_depth", "threaded",
            "txns_per_s", "window_ms_p50", "window_ms_p99", "committed",
            "conflict", "too_old", "verdicts_sha256", "host_syncs_per_window",
            "host_pack_ms_per_window", "pack_gate_wait_s")},
        "launches_per_window": {**{k: launches[k] / n_windows
                                   for k in NR_SEQ},
                                **{e: n / n_windows
                                   for e, n in entries.items()}},
        "resident_sha_equal": True, "card": card}))
    lap("a")

    # (b)
    n_wave = 2 * WINDOW_K
    wb, we = blob[: int(ends[n_wave * b])], ends[: n_wave * b + 1]
    _, wv, wl, _, _, _ = counted_run(
        wb, we, mode, n_wave, wave=True, engine=nr,
        label="non-resident wave", program="packed_many", sources=NR_WAVE)
    if not (np.array_equal(wv, wave_out["verdicts"][:2])
            and np.array_equal(wl, wave_out["levels"][:2])):
        fail("non-resident wave engine: verdicts or levels differ from "
             "phase 3c's")
    print(f"cross-check non-resident wave: {wv.size} txns, verdicts and "
          "levels equal the resident wave engine's (phase 3c)")
    lap("b")

    # (c)
    spec_cuda = spec_run(seed, "cuda", 3, False, resident=False)
    same_spec(spec_cuda, spec_run(seed, "cuda", 1, False, resident=False),
              False, "depth 1 on cuda (non-resident)", metrics=False)
    clean, dependent = spec_cuda[6]
    if spec_cuda[2]["spec_repaired"] <= 0 or clean + dependent <= 0:
        fail(f"non-resident adversary: spec_metrics {spec_cuda[2]}, "
             f"probe answers {spec_cuda[6]}")
    print(f"cross-check adversarial non-resident: {spec_cuda[0].size} txns, "
          f"depth 3 equals depth 1 on cuda (spec_metrics {spec_cuda[2]}); "
          f"the dependency probe found {clean} younger windows clean "
          f"(repaired paint-only) and {dependent} dependent (re-resolved)")
    lap("c")

    # (d) + (e): the first window after window 0, on a speculative engine
    # (whose pack is kp_pack_window) and a plain one.
    spec = bench.make_engine(mode, CAP, "cuda", spec_resolve=True, **nr)
    cs = bench.make_engine(mode, CAP, "cuda", **nr)
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, WINDOW_K, 0),
                           b)
    spec.base_version = cs.base_version
    wire, cvs_abs = bench.window_wire(blob, ends, mode, WINDOW_K, 1)
    buf = native.as_wire(wire)
    got = spec._pack_window_native(buf, spec._empty_batch(WINDOW_K), b)
    ref = spec._empty_batch(WINDOW_K)
    off = 0
    for i in range(WINDOW_K):
        off = native.pack_batch(buf, off, b, spec.codec.n_words,
                                spec.base_version,
                                HostBatch(*(a[i] for a in ref)))
    want = spec._pack_dict(ref)
    for name, x, y in zip(("dict_keys", *ck.RankBatch._fields),
                          (got.delta_keys, *got.ranks),
                          (want.delta_keys, *want.ranks)):
        if x.dtype != y.dtype or x.tobytes() != y.tobytes():
            fail(f"kp_pack_window: {name} differs from _pack_dict's")
    if got.demand != want.demand:
        fail("kp_pack_window: the write demands differ from _pack_dict's")
    print(f"cross-check kp_pack_window: a window of {WINDOW_K} x {b} txns "
          f"({got.delta_keys.shape[1]} dictionary rows per batch) equals "
          "_pack_dict leaf for leaf")
    prepared = cs.pack_wire_window(wire, cvs_abs, b)
    hb = prepared.batch
    rb = upload(hb, cs.device, packed=True)
    cvs, olds = prepared.cvs_rel, prepared.olds_rel
    state = cs.state
    pb = ck._step_packed(rb, 0)
    floor, _ = ck.too_old_mask_packed(state.delta, pb.ranks, int(olds[0]))
    cd, c = state.delta.keys.shape[0], state.base.keys.shape[0]
    kernels = {}  # CUDA kernels of the captured step, counted at launch
    # K13's gated fold step (K4's decision, the tiles, the finish): needed
    # and not, then the step's fold as the engine ran it.
    for label, dem in (("needed", cd), ("step", int(hb.demand[0]))):
        got = ck._maybe_merge(clone(state), dem, floor)
        if K.WORD_COMPACT_KERNELS["wc_fold_step"] != 3:
            fail(f"K13 gated fold step: {K.WORD_COMPACT_KERNELS} (want 3 "
                 "CUDA kernels, counted at launch)")
        assert_equal(f"word_compact_fold_step.{label}", got,
                     ck._maybe_merge_plain(clone(state), dem, floor))
    kernels["fold_step"] = K.WORD_COMPACT_KERNELS["wc_fold_step"]
    kernels["base_table"] = K.TABLE_KERNELS["last"]
    step_need = bool(ck.fold_need_plain(state, int(hb.demand[0]), floor))
    hist = ck._maybe_merge(clone(state), hb.demand[0], floor)
    s = ck.dict_history_search(hist.base.keys, pb.dict_keys, hist.delta.keys,
                               live_b=hist.base.n_used,
                               live_d=hist.delta.n_used)
    kernels["search"] = K.WORD_SEARCH_KERNELS["last"]
    assert_equal("word_probe.search", list(s), list(ck.dict_history_search(
        hist.base.keys, pb.dict_keys, hist.delta.keys, plain=True)))
    probe = ck.packed_probe(pb.ranks, floor, s, hist.base_st,
                            hist.delta.versions, hist.delta.n_used)
    kernels["probe"] = K.WORD_PROBE_KERNELS["last"]
    if kernels["probe"] != 2:
        fail(f"K12 probe: {kernels['probe']} CUDA kernels (want 2: the live "
             "table and the probe)")
    want_probe = ck.packed_probe(pb.ranks, floor, s, hist.base_st,
                                 hist.delta.versions, hist.delta.n_used,
                                 plain=True)
    assert_equal("word_probe_probe.probe", probe, want_probe)
    assert_equal("word_probe_probe.twin", probe, ck.level_probe_live_plain(
        pb.ranks, floor, s, hist.base_st, hist.delta.versions,
        hist.delta.n_used))
    # The probe of one flat level (the dependency probe's form: the scratch
    # or a flat history, searched over all its rows) and the dependency
    # probe itself over the window, with the delta as its scratch.
    sf = ck.dict_history_search(hist.delta.keys, pb.dict_keys)
    assert_equal("word_probe_probe.flat", ck.packed_probe(
        pb.ranks, floor, sf, None, hist.delta.versions, hist.delta.n_used),
        ck.packed_probe(pb.ranks, floor, sf, None, hist.delta.versions,
                        hist.delta.n_used, plain=True))
    before = K.ENTRY_LAUNCHES.get("wp_probe", 0)
    dep = ck.spec_dep_window(hist.delta, rb)
    if K.ENTRY_LAUNCHES.get("wp_probe", 0) - before != WINDOW_K:
        fail("the dependency probe did not run K12's probe once a step")
    assert_equal("word_probe_probe.dependency", dep,
                 ck.spec_dep_window(hist.delta, rb, plain=True))
    too_old, _, cand = probe
    ranks = ck.endpoint_ranks_live_packed(pb.ranks)
    accepted, _ = ck.accept(cand, too_old, pb.ranks.txn_mask, ranks)
    cv0 = int(cvs[0])

    def paint(delta):
        return ck._paint_and_compact_packed(delta, pb.dict_keys, pb.ranks,
                                            accepted, cv0, floor, s.rs_d)

    def paint_plain(delta):
        return ck._paint_and_compact_packed(delta, pb.dict_keys, pb.ranks,
                                            accepted, cv0, floor, s.rs_d,
                                            plain=True)

    assert_equal("word_compact.paint", paint(clone(hist.delta)),
                 paint_plain(clone(hist.delta)))
    kernels["paint"] = K.WORD_COMPACT_KERNELS["wc_paint"]
    if kernels["paint"] != 3:
        fail(f"K13 packed paint: {kernels['paint']} CUDA kernels (want 3)")
    assert_equal("word_compact.paint_twin", paint(clone(hist.delta)),
                 ck.packed_paint_tiles_plain(clone(hist.delta), pb.dict_keys,
                                             pb.ranks, accepted, cv0, floor,
                                             s.rs_d))

    def fold(h):
        return ck.advance_hist(h, cv0, int(olds[0]))

    def fold_plain(h):
        f = torch.maximum(h.delta.oldest, torch.full_like(h.delta.oldest,
                                                          int(olds[0])))
        nb = ck._merge_delta_plain(h.base, h.delta, f)
        return ck.HistState(nb, ck.sparse_table(nb.versions),
                            ck._reset_delta(h.delta, f))

    assert_equal("word_compact_fold_forced.fold", fold(clone(hist)),
                 fold_plain(clone(hist)))
    if K.WORD_COMPACT_KERNELS["wc_fold"] != 2:
        fail(f"K13 forced fold: {K.WORD_COMPACT_KERNELS} (want 2)")
    # The forced fold over a full base (n_used = C = 2^20, W = 4): the
    # delta's rows and C - n_delta rows between them.
    full = full_base(hist, c)
    assert_equal("word_compact_fold_forced.full", fold(clone(full)),
                 fold_plain(clone(full)))
    if not bool(full.base.n_used == c):
        fail("the full base is not full")
    rows = torch.cat([hist.base.keys, hist.delta.keys])
    order = np.lexsort(rows.cpu().numpy().T[::-1])
    skeys = rows[torch.from_numpy(order).cuda()].contiguous()
    newv = torch.from_numpy(np.random.default_rng(1).integers(
        0, 4, skeys.shape[0]).astype(np.int32)).cuda()
    prior = torch.zeros((), dtype=torch.bool, device="cuda")
    assert_equal("word_compact.compact",
                 ck._dedup_compact(skeys, newv, c, prior),
                 ck._dedup_compact_plain(skeys, newv, c, prior))
    if K.WORD_COMPACT_KERNELS["wc_compact"] != 2:
        fail(f"K13 compaction: {K.WORD_COMPACT_KERNELS} (want 2)")

    def many(h):
        return ck.resolve_many_hist_packed(h, rb, cvs, olds,
                                           demands=hb.demand)

    def many_plain(h):
        return ck.resolve_many_hist_packed_plain(h, rb, cvs, olds)

    assert_equal("packed_many", many(clone(state)), many_plain(clone(state)))
    torch.cuda.synchronize()

    def k12():
        return K.word_search(hist.base.keys, pb.dict_keys, hist.delta.keys,
                             hist.base.n_used, hist.delta.n_used)

    def k12_plain():
        return ck.dict_history_search(hist.base.keys, pb.dict_keys,
                                      hist.delta.keys, plain=True)

    def probe_only():
        return ck.packed_probe(pb.ranks, floor, s, hist.base_st,
                               hist.delta.versions, hist.delta.n_used)

    def probe_plain():
        return ck.packed_probe(pb.ranks, floor, s, hist.base_st,
                               hist.delta.versions, hist.delta.n_used,
                               plain=True)

    def step(h, dem):
        return ck._maybe_merge(h, dem, floor)

    def fold_step_plain(h, dem):
        return ck._maybe_merge_plain(h, dem, floor)

    t = {
        "word_probe": (time_ms(k12), time_ms(k12_plain, reps=3)),
        "word_probe_probe": (time_ms(probe_only),
                             time_ms(probe_plain, reps=3)),
        "word_compact": (time_ms(paint, lambda: (clone(hist.delta),)),
                         time_ms(paint_plain, lambda: (clone(hist.delta),),
                                 reps=3)),
        "word_compact_fold_step": (
            time_ms(step, lambda: (clone(state), 0)),
            time_ms(fold_step_plain, lambda: (clone(state), 0), reps=3)),
        "word_compact_fold_forced": (
            time_ms(fold, lambda: (clone(full),), reps=5),
            time_ms(fold_plain, lambda: (clone(full),), reps=2)),
        "packed_many": (time_ms(many, lambda: (clone(state),), reps=5),
                        time_ms(many_plain, lambda: (clone(state),), reps=2)),
    }
    if bool(ck.fold_need_plain(state, 0, floor)):
        fail("the timed gated fold step's fold is needed")
    needed_ms = (time_ms(step, lambda: (clone(state), cd), reps=5),
                 time_ms(fold_step_plain, lambda: (clone(state), cd), reps=2))
    fold_ms = (time_ms(fold, lambda: (clone(hist),), reps=5),
               time_ms(fold_plain, lambda: (clone(hist),), reps=2))
    for name, (ms, plain) in t.items():
        print(f"kernel {name}: {ms:.4f} ms (plain {plain:.4f} ms)")
    print(f"kernel word_compact_fold_step needed: {needed_ms[0]:.4f} ms "
          f"(plain {needed_ms[1]:.4f} ms); forced fold of the step's "
          f"history ({int(hist.base.n_used)} live base rows of {c}): "
          f"{fold_ms[0]:.4f} ms (plain {fold_ms[1]:.4f} ms)")
    print(json.dumps({"k12_k13_cuda_kernels_per_step": kernels,
                      "outside_k3": sum(kernels.values()),
                      "step_fold_needed": step_need}))

    # Bounds at the capture's shapes (K12's row: its search alone; its
    # probe with the table it builds has a row of its own). K12's search:
    # the live base and
    # delta rows read once (a merge of the sorted dictionary with each
    # history reads no more), the dictionary read, four rank vectors
    # written. Its probe: the four rank vectors and the delta's live
    # versions read, two base-table entries a read slot, the read slots,
    # masks and versions read, the slot mask and two [B] outputs written.
    # K13's paint: the live delta rows read and written (and the rows up
    # to the old n_used cleared), the write slots and the paint order
    # read, the endpoints' dictionary rows and cross ranks gathered. The
    # gated step (its fold not needed): the base versions read once (K4's
    # row counts the same). The forced fold at a full base: the live rows
    # of base and delta read, the base written, the delta reset. The
    # window program: k x (K12 + K3 + K13).
    n1, w = pb.dict_keys.shape
    r = pb.ranks.read_begin.shape[1]
    q = pb.ranks.write_begin.shape[1]
    nb_, nd_, nn_ = (int(x) for x in torch.stack(
        [hist.base.n_used, hist.delta.n_used,
         paint(clone(hist.delta)).n_used]).cpu())
    bytes_search = 4 * (w + 1) * (nb_ + nd_) + 4 * w * n1 + 16 * n1
    bytes_probe = 16 * n1 + 4 * nd_ + 8 * b * r + 9 * b * r + 5 * b \
        + b * r + 2 * b
    bytes_k13 = (4 * (w + 1) * (nd_ + max(nd_, nn_)) + 9 * b * q + b
                 + 8 * b * q + 2 * b * q * 4 * (w + 1))
    whole_k13 = (4 * (w + 1) * nd_ + 4 * (w + 1) * cd + 9 * b * q + b
                 + 8 * b * q + 2 * b * q * 4 * (w + 1))
    bytes_step = 4 * c + 4 + 1
    fd = int(full.delta.n_used)
    bytes_forced = 4 * (w + 1) * (2 * c + 2 * fd)
    idx = torch.nonzero(cand).flatten().double()
    ops_k3 = float(3 * r * q * idx.sum())
    bytes_k3 = 3 * b + b * r * 9 + b * q * 9 + 2 * b
    step_b = {"bytes": 0.0, "operations": 0.0}
    for nbytes, ops in ((bytes_search + bytes_probe + bytes_k13, 0.0),
                        (bytes_k3, ops_k3)):
        lo_ms, by = bound(nbytes, ops)
        step_b[by] += lo_ms * WINDOW_K
    lap("d, e")
    print(json.dumps({"phase 3g seconds": seconds}))
    return {
        "spec_cuda": {False: spec_cuda},
        "word_probe": {"launches": entries["wp_search"],
                       "timing": t["word_probe"],
                       "bound": bound(bytes_search)},
        "word_probe_probe": {"launches": entries["wp_probe"],
                             "timing": t["word_probe_probe"],
                             "bound": bound(bytes_probe),
                             "cuda_kernels": kernels["probe"],
                             "delta_live": nd_},
        "word_compact": {"launches": entries["wc_paint"],
                         "timing": t["word_compact"],
                         "bound": bound(bytes_k13),
                         "whole_cd_bound_ms": bound(whole_k13)[0],
                         "cuda_kernels": kernels["paint"]},
        "word_compact_fold_step": {
            "launches": entries["wc_fold_step"],
            "timing": t["word_compact_fold_step"], "bound": bound(bytes_step),
            "needed_ms": needed_ms[0], "needed_plain_ms": needed_ms[1],
            "cuda_kernels": kernels["fold_step"]},
        "word_compact_fold_forced": {
            "launches": 0, "timing": t["word_compact_fold_forced"],
            "bound": bound(bytes_forced), "step_history_ms": fold_ms[0],
            "base_rows": c},
        "packed_many": {"launches": launches["packed_many"],
                        "timing": t["packed_many"],
                        "bound": (sum(step_b.values()),
                                  max(step_b, key=step_b.get)),
                        "cuda_kernels_per_step_outside_k3":
                            sum(kernels.values())},
    }


def full_base(hist, c: int):
    """``hist`` with a full base (n_used = C): row 0 the base's own
    minimum key, then C - 1 rows that share the first W - 1 words of the
    delta's live rows, with random last words (so the delta's rows fall
    among them), sorted and unique; versions in [0, 1000). The forced
    fold's full-size input."""
    import torch

    from foundationdb_tpu_torch.models import conflict_kernel as ck

    rng = np.random.default_rng(5)
    nd = int(hist.delta.n_used)
    dk = hist.delta.keys[1:max(nd, 2)].cpu().numpy()
    row0 = hist.base.keys[0].cpu().numpy()
    rows = np.repeat(dk, -(-2 * c // len(dk)), 0)
    rows[:, -1] = rng.integers(-2**31, 2**31 - 1, len(rows), dtype=np.int64)
    rows = np.unique(rows, axis=0)
    above = np.lexsort(np.stack([rows[:, -1], *(rows[:, :-1].T[::-1])]))
    rows = rows[above]
    gt = np.zeros(len(rows), bool)  # rows above row 0, lexicographically
    eq = np.ones(len(rows), bool)
    for j in range(rows.shape[1]):
        gt |= eq & (rows[:, j] > row0[j])
        eq &= rows[:, j] == row0[j]
    rows = rows[gt][:c - 1]
    if len(rows) < c - 1:
        fail("could not make a full base")
    keys = np.concatenate([row0[None], rows]).astype(np.int32)
    vers = rng.integers(0, 1000, c).astype(np.int32)
    dev = hist.base.keys.device
    base = ck.ConflictState(
        torch.from_numpy(keys).to(dev), torch.from_numpy(vers).to(dev),
        torch.tensor(c, dtype=torch.int32, device=dev),
        hist.base.oldest.clone(), hist.base.overflow.clone())
    return ck.HistState(base, ck.build_table(base.versions),
                        clone(hist.delta))


def nr_sharded_phase(blob, ends, mode, n_batches: int, stream, seed: int,
                     card: str, seq_rec: dict, wave_out: dict) -> dict:
    """Phase 3h: the non-resident sharded engine (SHARDS flat full-key
    shard histories on the card) on the window path, counted, and checks
    (a)-(d) and the card's half of (e). Returns the K14, K15, K16, K13
    sorted paint and window program rows' measurements."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import upload_keys
    from foundationdb_tpu_torch.ops.lex import (
        searchsorted_words,
        sort_keys_with_payload,
    )

    b = mode.batch
    s_n = SHARDS
    n_windows = n_batches // WINDOW_K
    t0 = time.perf_counter()
    seconds = {}

    def lap(label: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        seconds[label] = now - t0
        t0 = now

    engine = {**sharded_engine(stream, mode), "resident": False}
    # (a) The window path, counted; every K15 launch (into the window's
    # buffers) held against the plain version after the run.
    caps, restore = capture_launches()
    try:
        rec, _, _, _, launches, per_window = counted_run(
            blob, ends, mode, n_batches, wave=False, engine=engine,
            label="non-resident sharded", program="nr_sharded_many",
            sources=NRS_SEQ)
    finally:
        restore()
    checked = check_launches(caps, "3h_a")
    if checked["clip"] < n_batches:
        fail(f"non-resident sharded: {checked['clip']} K15 launches checked "
             f"for {n_batches} steps")
    want = {"wsh_probe": WINDOW_K,
            "wsh_clip": WINDOW_K, "wso_ranks": WINDOW_K,
            "ac_accept": WINDOW_K, **{e: s_n * WINDOW_K for e in (
                "wc_paint_keys", "wp_search", "wso_sort", "wc_paint_sorted")}}
    never = ("di_insert", "sc_paint", "sh_probe", "wp_probe", "wc_paint",
             "hp_probe", "hp_table")
    for i, pw in enumerate(per_window):
        if (any(pw.get(e, 0) != n for e, n in want.items())
                or any(pw.get(e, 0) for e in never)):
            fail(f"non-resident sharded window {i}: launches {pw} (want "
                 f"{want}, none of {never})")
    if rec["verdicts_sha256"] != seq_rec["verdicts_sha256"]:
        fail("non-resident sharded window path and the single engine's "
             "(phase 3b) verdicts differ")
    entries = {e: sum(pw.get(e, 0) for pw in per_window)
               for e in (*want, "wso_ranks")}
    print(json.dumps({
        "phase": "non-resident sharded", "stream": "ycsb-a",
        "shards": s_n, "splits": [x.hex() for x in engine["splits"]],
        **{k: rec[k] for k in (
            "txns", "batches", "window", "pipeline_depth", "threaded",
            "txns_per_s", "window_ms_p50", "window_ms_p99", "committed",
            "conflict", "too_old", "verdicts_sha256", "shard_occupancy",
            "host_syncs_per_window", "host_pack_ms_per_window",
            "host_pack_ms_warm", "pack_gate_wait_s")},
        "launches_per_window": {**{k: launches[k] / n_windows
                                   for k in NRS_SEQ},
                                **{e: n / n_windows
                                   for e, n in entries.items()}},
        "k15_launches_checked": checked["clip"],
        "single_engine_sha_equal": True, "card": card}))
    lap("a")

    # (b) Uniform splits (every key below 2^20 lies in shard 0), then a
    # reshard to the density splits at the middle of the stream.
    mid = n_windows // 2
    rb_rec = bench.run_wire(
        blob, ends, mode, n_batches, CAP, "cuda", window=WINDOW_K,
        pipeline_depth=WINDOW_DEPTH, repeats=1, warmup=False,
        engine={**sharded_engine(stream, mode, uniform=True),
                "resident": False},
        reshard=(mid, engine["splits"]))[0]
    before, after = rb_rec["reshard"]["occupancy_before"], \
        rb_rec["shard_occupancy"]
    if rb_rec["verdicts_sha256"] != seq_rec["verdicts_sha256"]:
        fail("resharded non-resident sharded run and the single engine's "
             "verdicts differ")
    if rb_rec["overflowed"] or before == after or min(after) <= 1:
        fail(f"non-resident reshard: occupancy {before} -> {after}, "
             f"overflowed {rb_rec['overflowed']}")
    print(json.dumps({
        "phase": "non-resident sharded reshard",
        "reshard": rb_rec["reshard"], "shard_occupancy": after,
        "txns_per_s": rb_rec["txns_per_s"],
        "verdicts_sha256": rb_rec["verdicts_sha256"], "card": card}))
    lap("b")

    # (c) A wave engine of SHARDS shards on the first two windows against
    # phase 3c's single wave engine: verdicts and levels.
    n_wave = 2 * WINDOW_K
    wb, we = blob[: int(ends[n_wave * b])], ends[: n_wave * b + 1]
    caps, restore = capture_launches()
    try:
        wrec, wv, wl, _, _, wpw = counted_run(
            wb, we, mode, n_wave, wave=True, engine=engine,
            label="non-resident sharded wave", program="nr_sharded_many",
            sources=NRS_WAVE)
    finally:
        restore()
    checked = check_launches(caps, "3h_c")
    if not (np.array_equal(wv, wave_out["verdicts"][:2])
            and np.array_equal(wl, wave_out["levels"][:2])):
        fail("non-resident sharded wave engine: verdicts or levels differ "
             "from the single wave engine's (phase 3c)")
    for i, pw in enumerate(wpw):
        if (pw.get("sh_exchange", 0) or pw.get("wv_pred", 0)
                or pw.get("wv_pred_or", 0) != s_n * WINDOW_K
                or pw.get("wso_ranks", 0) != s_n * WINDOW_K
                or pw.get("wsh_clip", 0) != WINDOW_K
                or pw.get("wv_level", 0) != WINDOW_K or pw.get("ac_accept")):
            fail(f"non-resident sharded wave window {i}: launches {pw}")
    if min(checked.values()) < n_wave:
        fail(f"non-resident sharded wave: launches checked {checked} for "
             f"{n_wave} batches")
    xs = wrec["exchange_stats"]
    if not 0 < xs["tiles_occupied"] <= xs["tiles_total"]:
        fail(f"exchange_stats {xs}")
    print(json.dumps({"phase": "non-resident sharded wave",
                      "txns": wrec["txns"], "committed": wrec["committed"],
                      "reordered": wrec["reordered"],
                      "cycle_aborted": wrec["cycle_aborted"],
                      "exchange_stats": xs, "launches_checked": checked,
                      "levels_equal_phase_3c": True, "card": card}))
    lap("c")

    # (d) One captured step launch by launch, and one captured window
    # program, against the plain versions: window 1 after window 0.
    cs = bench.make_engine(mode, CAP, "cuda", **engine)
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, WINDOW_K, 0),
                           b)
    prepared = cs.pack_wire_window(
        *bench.window_wire(blob, ends, mode, WINDOW_K, 1), b)
    if prepared.rebase_delta:
        fail("unexpected rebase in the captured window")
    bt = upload_keys(prepared.batch, cs.device)
    cvs, olds = prepared.cvs_rel, prepared.olds_rel
    state, lo, hi = cs.state, cs._lo_dev, cs._hi_dev
    step = ck._step_batch(bt, 0)
    floor = torch.maximum(state.oldest, torch.full(
        (), int(olds[0]), dtype=torch.int32, device="cuda"))
    assert_equal("word_shard_probe",
                 ck.word_shard_probe(state, step, lo, hi, floor[0]),
                 ck.word_shard_probe_plain(state, step, lo, hi, floor[0]))
    assert_equal("word_shard_probe.live_twin",
                 ck.word_shard_probe(state, step, lo, hi, floor[0]),
                 ck.word_shard_probe_live_plain(state, step, lo, hi,
                                                floor[0]))
    # K16 at full shards (n_used = C, ranges up to a whole shard) against
    # its plain version.
    fh, frb, fre, fm, frv, ftm, flo, fhi = full_shards(
        s_n, state.keys.shape[1], state.keys.shape[2], b,
        step.read_begin.shape[1], seed)
    fstep = step._replace(read_begin=frb, read_end=fre, read_mask=fm,
                          read_version=frv, txn_mask=ftm)
    assert_equal("word_shard_probe.full",
                 ck.word_shard_probe(fh, fstep, flo, fhi, floor[0]),
                 ck.word_shard_probe_plain(fh, fstep, flo, fhi, floor[0]))
    # K15 through its checked entry and as the window program launches it
    # (buffers and checks once a window, ck.WordWindowClip).
    wclips = {reads: ck.WordWindowClip.of(bt, lo, hi, reads)
              for reads in (False, True)}
    for reads in (False, True):
        want = [x for x in ck.word_clip_plain(step, lo, hi, reads)
                if x is not None]
        assert_equal("word_clip",
                     [x for x in ck.word_clip(step, lo, hi, reads)
                      if x is not None], want)
        assert_equal("word_clip.window",
                     [x for x in wclips[reads].step(step) if x is not None],
                     want)
    assert_equal("word_sort.ranks", ck.endpoint_ranks_live(step),
                 ck.endpoint_ranks_live_plain(step))
    too_old, _, _, cand = ck.word_shard_probe(state, step, lo, hi, floor[0])
    ranks = ck.endpoint_ranks_live(step)
    accepted, _ = ck.accept(cand, too_old, step.txn_mask, ranks)
    clip = ck.word_clip(step, lo, hi, False)
    cv0 = int(cvs[0])
    n_used = [int(x) for x in state.n_used.cpu()]
    big = int(np.argmax(n_used))  # the shard timed below
    paint_in = {}
    for s in range(s_n):
        view = ck.clip_view(step, clip, s)
        hs = ck._shard_hist(state, s)
        keys, delta = K.word_paint_keys(view.write_begin, view.write_end,
                                        view.write_mask, accepted)
        cross = K.word_search(hs.keys, keys, live0=hs.n_used)[1]
        assert_equal("word_probe.paint_cross", cross, searchsorted_words(
            hs.keys, keys, "right").to(torch.int32))
        snew, (sdelta, scross) = K.word_sort(keys, (delta, cross))
        assert_equal("word_sort_paint", [snew, sdelta, scross],
                     list(sort_keys_with_payload(keys, delta, cross)))
        got = clone(hs)
        K.word_paint_sorted(got, snew, sdelta, scross, cv0, floor[s])
        soldv = hs.versions[(scross - 1).clamp(min=0).long()]
        assert_equal("word_paint_sorted", got, ck._paint_tail(
            hs, snew, sdelta, soldv, scross, cv0, floor[s]))
        assert_equal("word_paint_sorted.composed", ck._paint_and_compact(
            clone(hs), view, accepted, cv0, floor[s]),
            ck._paint_and_compact_plain(hs, view, accepted, cv0, floor[s]))
        if s == big:
            paint_in = dict(hs=hs, keys=keys, delta=delta, cross=cross,
                            snew=snew, sdelta=sdelta, scross=scross,
                            soldv=soldv, floor=floor[s], view=view,
                            n_used_after=int(got.n_used))

    def many(st):
        v, _, _, h = ck.sharded_resolve_many(st, bt, cvs, olds, lo, hi)
        return v, h

    def many_plain(st):
        v, _, _, h = ck.sharded_resolve_many(st, bt, cvs, olds, lo, hi,
                                             plain=True)
        return v, h

    assert_equal("nr_sharded_many", many(clone(state)),
                 many_plain(clone(state)))
    torch.cuda.synchronize()

    pi = paint_in
    flat = torch.cat([step.read_begin.reshape(-1, step.read_begin.shape[-1]),
                      step.read_end.reshape(-1, step.read_end.shape[-1]),
                      step.write_begin.reshape(-1, step.write_begin.shape[-1]),
                      step.write_end.reshape(-1, step.write_end.shape[-1])])
    f0 = floor[0]  # shard 0's floor (0-dim), made once outside the timing
    t = {
        "word_sort": (time_ms(lambda: ck.endpoint_ranks_live(step)),
                      time_ms(lambda: ck.endpoint_ranks_live_plain(step),
                              reps=3)),
        "word_clip": (time_ms(lambda: wclips[False].step(step)),
                      time_ms(lambda: ck.word_clip_plain(step, lo, hi,
                                                         False), reps=3)),
        "word_shard_probe": (
            time_ms(lambda: ck.word_shard_probe(state, step, lo, hi, f0)),
            time_ms(lambda: ck.word_shard_probe_plain(state, step, lo, hi,
                                                      f0), reps=2)),
        "word_paint_sorted": (
            time_ms(lambda h: K.word_paint_sorted(
                h, pi["snew"], pi["sdelta"], pi["scross"], cv0, pi["floor"]),
                lambda: (clone(pi["hs"]),)),
            time_ms(lambda: ck._paint_tail(
                pi["hs"], pi["snew"], pi["sdelta"], pi["soldv"],
                pi["scross"], cv0, pi["floor"]), reps=3)),
        "nr_sharded_many": (time_ms(many, lambda: (clone(state),), reps=3),
                            time_ms(many_plain, lambda: (clone(state),),
                                    reps=1)),
    }
    torch_sort_ms = time_ms(lambda: sort_keys_with_payload(flat))
    clip_entry_ms = time_ms(lambda: ck.word_clip(step, lo, hi, False))
    clip_device = cuda_kernels(lambda: wclips[False].step(step))
    paint_sort_ms = time_ms(lambda: K.word_sort(pi["keys"], (pi["delta"],
                                                             pi["cross"])))
    paint_sort_plain_ms = time_ms(lambda: sort_keys_with_payload(
        pi["keys"], pi["delta"], pi["cross"]), reps=3)
    # K13's sorted paint works over the live rows only: the same shard cut
    # to C = 2^18 (the same live rows, its own cross ranks) takes about the
    # same time.
    c18 = 1 << 18
    h18 = ck.ConflictState(pi["hs"].keys[:c18].clone(),
                           pi["hs"].versions[:c18].clone(), *pi["hs"][2:])
    x18 = K.word_search(h18.keys, pi["keys"], live0=h18.n_used)[1]
    s18, (d18, x18) = K.word_sort(pi["keys"], (pi["delta"], x18))
    got18 = clone(h18)
    K.word_paint_sorted(got18, s18, d18, x18, cv0, pi["floor"])
    assert_equal("word_paint_sorted.c18", got18, ck._paint_tail(
        h18, s18, d18, h18.versions[(x18 - 1).clamp(min=0).long()], x18, cv0,
        pi["floor"]))
    paint_c18_ms = time_ms(lambda h: K.word_paint_sorted(
        h, s18, d18, x18, cv0, pi["floor"]), lambda: (clone(h18),))
    paint_ms = time_ms(lambda h: ck._paint_and_compact(
        h, pi["view"], accepted, cv0, pi["floor"]),
        lambda: (clone(pi["hs"]),))
    k16 = live_probe_report(lambda: ck.word_shard_probe(
        state, step, lo, hi, f0), s_n, state.keys.shape[1], n_used)
    k16["full_shard_ms"] = time_ms(lambda: ck.word_shard_probe(
        fh, fstep, flo, fhi, f0))
    k16["full_shard_device_ms"] = cuda_kernels(lambda: ck.word_shard_probe(
        fh, fstep, flo, fhi, f0))["device_ms"] or None
    for name, (ms, plain) in t.items():
        print(f"kernel {name}: {ms:.4f} ms (plain {plain:.4f} ms)")
    print(f"kernel word_clip: the window program's launch "
          f"{t['word_clip'][0]:.4f} ms ({clip_device['launches']} CUDA "
          f"kernels, {clip_device['device_ms']:.5f} device ms), the checked "
          f"entry (allocating) {clip_entry_ms:.4f} ms")
    print(f"kernel word_sort: {flat.shape[0]} rows ranked in "
          f"{t['word_sort'][0]:.4f} ms; {flat.shape[1]} stable torch.sort "
          f"passes over them {torch_sort_ms:.4f} ms; one shard's paint sort "
          f"({pi['keys'].shape[0]} rows, 2 payloads) {paint_sort_ms:.4f} ms;"
          f" K13's sorted paint at C = 2^18 {paint_c18_ms:.4f} ms and 2^20 "
          f"{t['word_paint_sorted'][0]:.4f} ms ({pi['hs'].n_used.item()} "
          f"live rows);"
          f" one shard's whole unpacked paint {paint_ms:.4f} ms")
    check_live_probe("word_shard_probe", k16)
    print_live_probe("word_shard_probe", k16, state.keys.shape[1])

    # Bounds at the capture's shapes. K14 (the ranks): the endpoint rows
    # and masks read once, the ranks and live masks written; its operations
    # a comparison sort's n·log2(n) row compares of W words. K15 (writes
    # only, the main path): the write rows and masks read once, S clipped
    # copies written. K16: the shards' live keys and versions, the read
    # slots, read versions and txn mask read once, the [B, R] mask and
    # three [B] outputs written. K13's sorted paint (the timed shard): its
    # live rows and the sorted new rows (keys, deltas, cross ranks) read,
    # the live rows after the paint written and the rows it frees cleared
    # (the whole-C count, every [C, W] row written, kept beside it). K14's
    # paint sort: the rows and two payloads read and written once, n·log2(n)
    # row compares. The window program: k x (K16 + K14 + K3 + K15 +
    # S paints, each K13's keys, K12's search, K14's sort and the sorted
    # paint).
    r, w = step.read_begin.shape[1], step.read_begin.shape[2]
    q = step.write_begin.shape[1]
    c = state.keys.shape[1]
    n = flat.shape[0]
    n2 = 2 * b * q
    bytes_k14 = n * w * 4 + b * (r + q) + n * 4 + b * (r + q)
    ops_k14 = float(n * math.ceil(math.log2(n)) * w)
    bytes_k15 = b * q * (8 * w + 1) + s_n * b * q * (8 * w + 1) + 8 * s_n * w
    bytes_k16 = (4 * (w + 1) * sum(n_used) + b * r * (8 * w + 1) + 5 * b
                 + b * r + 3 * b + 8 * s_n * w + 4)
    bytes_paint = (4 * (w + 1) * n_used[big] + n2 * (w + 2) * 4
                   + 4 * (w + 1) * max(n_used[big], pi["n_used_after"]) + 4)
    bytes_paint_whole_c = (4 * (w + 1) * n_used[big] + 4 * (w + 1) * c
                           + n2 * (w + 2) * 4 + 4)
    bytes_sort = n2 * (w + 2) * 4 * 2
    ops_sort = float(n2 * math.ceil(math.log2(n2)) * w)
    idx = torch.nonzero(cand).flatten().double()
    ops_k3 = float(3 * r * q * idx.sum())
    bytes_k3 = 3 * b + b * r * 9 + b * q * 9 + 2 * b
    bytes_keys = b * q * (8 * w + 1) + b + n2 * (w + 1) * 4
    bytes_search = n2 * w * 4 + 4 * (w + 1) * n_used[big] + 8 * n2
    step_b = {"bytes": 0.0, "operations": 0.0}
    for nbytes, ops, times in (
            (bytes_k16, 0.0, 1), (bytes_k14, ops_k14, 1),
            (bytes_k3, ops_k3, 1), (bytes_k15, 0.0, 1),
            (bytes_keys + bytes_search + bytes_paint, 0.0, s_n),
            (bytes_sort, ops_sort, s_n)):
        lo_ms, by = bound(nbytes, ops)
        step_b[by] += lo_ms * times * WINDOW_K
    lap("d")
    # (e) The card's half: window 0 on cuda (the CPU half runs in a worker
    # beside phase 4, checked by check_sharded_cpu).
    window0 = sharded_window0(seed, len(stream[0]) // b, "cuda",
                              resident=False)
    lap("e")
    print(json.dumps({"phase 3h seconds": seconds}))
    return {
        "window0_cuda": window0,
        "word_sort": {"launches": entries["wso_ranks"],
                      "timing": t["word_sort"],
                      "bound": bound(bytes_k14, ops_k14),
                      "torch_sort_passes_ms": torch_sort_ms},
        "word_sort_paint": {"launches": entries["wso_sort"],
                            "timing": (paint_sort_ms, paint_sort_plain_ms),
                            "bound": bound(bytes_sort, ops_sort),
                            "rows": pi["keys"].shape[0]},
        "word_clip": {"launches": entries["wsh_clip"],
                      "timing": t["word_clip"], "bound": bound(bytes_k15),
                      "entry_ms": clip_entry_ms,
                      "device_ms": clip_device["device_ms"] or None,
                      "cuda_kernels": clip_device["launches"]},
        "word_shard_probe": {"launches": entries["wsh_probe"],
                             "timing": t["word_shard_probe"],
                             "bound": bound(bytes_k16), **k16},
        "word_paint_sorted": {"launches": entries["wc_paint_sorted"],
                              "timing": t["word_paint_sorted"],
                              "bound": bound(bytes_paint),
                              "whole_c_bound_ms": bound(
                                  bytes_paint_whole_c)[0],
                              "c18_ms": paint_c18_ms,
                              "live_rows": n_used[big],
                              "whole_paint_ms": paint_ms},
        "nr_sharded_many": {"launches": launches["nr_sharded_many"],
                            "timing": t["nr_sharded_many"],
                            "bound": (sum(step_b.values()),
                                      max(step_b, key=step_b.get))},
    }


# Phase 3i: the design arms (the JAX FDB_TPU_* knobs as constructor
# arguments): each arm's window path over the stream of 3b, counted; the
# kernel entries each arm's window must launch (k per window) and never.
# The JAX line each arm's window program replaces (``:`` lines of
# foundationdb_tpu/models/conflict_kernel.py).
ARM_REPLACES = {
    "a_history_batch": 2291, "b_rmq_blocked": 2176,
    "b_rmq_blocked_history_batch": 2143, "c_unpacked": 1386,
    "c_unpacked_history_batch": 1156, "d_nonresident_history_batch": 1579,
    "e_accept_seq": 607}
ARMS = {
    "a_history_batch": (
        {"history": "batch"}, "resolve_many", SEQ_SOURCES,
        {"hp_table": WINDOW_K, "hp_probe": WINDOW_K, "ac_accept": WINDOW_K,
         "sc_paint": WINDOW_K}, ("sc_fold", "sc_fold_step", "rb_build")),
    "b_rmq_blocked": (
        {"rmq": "blocked"}, "resolve_many",
        (*SEQ_SOURCES, "rmq_blocked", "word_probe"),
        {"rb_build": WINDOW_K, "rb_probe": WINDOW_K,
         "wp_search": 2 * WINDOW_K, "ac_accept": WINDOW_K,
         "sc_paint": WINDOW_K}, ("hp_probe",)),
    "b_rmq_blocked_history_batch": (
        {"rmq": "blocked", "history": "batch"}, "resolve_many",
        ("dict_insert", "accept", "step_compact", "rmq_blocked",
         "word_probe"),
        {"rb_build": WINDOW_K, "rb_probe": WINDOW_K,
         "wp_search": 2 * WINDOW_K, "sc_paint": WINDOW_K},
        ("hp_probe", "hp_table", "sc_fold", "sc_fold_step")),
    "c_unpacked": (
        {"packed": False}, "unpacked_many",
        ("history_probe", "accept", "word_probe", "word_compact",
         "word_sort", "word_shard"),
        {"wsh_probe": 2 * WINDOW_K, "wso_ranks": WINDOW_K,
         "ac_accept": WINDOW_K, "wc_fold_step": WINDOW_K,
         "wc_paint_keys": WINDOW_K, "wp_search": WINDOW_K,
         "wso_sort": WINDOW_K, "wc_paint_sorted": WINDOW_K},
        ("di_insert", "sc_paint", "wp_probe", "wc_paint", "hp_probe",
         "sc_need", "wc_fold")),
    "c_unpacked_history_batch": (
        {"packed": False, "history": "batch"}, "unpacked_many",
        ("accept", "word_probe", "word_compact", "word_sort", "word_shard"),
        {"wsh_probe": WINDOW_K,
         "wso_ranks": WINDOW_K, "ac_accept": WINDOW_K,
         "wc_paint_sorted": WINDOW_K},
        ("di_insert", "sc_paint", "wp_probe", "wc_paint", "wc_fold",
         "wc_fold_step", "hp_table")),
    "d_nonresident_history_batch": (
        {"resident": False, "history": "batch"}, "packed_many",
        ("accept", "word_probe", "word_compact"),
        {"wp_search": WINDOW_K, "wp_probe": WINDOW_K,
         "ac_accept": WINDOW_K, "wc_paint": WINDOW_K},
        ("di_insert", "sc_paint", "wc_fold", "wc_fold_step", "hp_probe",
         "hp_table")),
    "e_accept_seq": (
        {"accept": "seq"}, "resolve_many", SEQ_SOURCES,
        {"ac_accept": WINDOW_K, "hp_probe": WINDOW_K}, ("wv_level",)),
}


def arm_program(blob, ends, mode, engine: dict, wave: bool = False):
    """A warm window program of an arm on the card and its plain version:
    window 1 packed after window 0, uploaded. Returns (run, run_plain,
    state, hb, rb, the engine)."""
    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import (
        _DemotePlan,
        _RepackPlan,
    )

    b = mode.batch
    cs = bench.make_engine(mode, CAP, "cuda", wave, **engine)
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, WINDOW_K, 0),
                           b)
    prepared = cs.pack_wire_window(
        *bench.window_wire(blob, ends, mode, WINDOW_K, 1), b)
    if prepared.rebase_delta:
        fail("unexpected rebase in the captured window")
    hb = prepared.batch
    if isinstance(hb, (_RepackPlan, _DemotePlan)):
        hb = cs._run_plan(hb)
    rb = cs._upload(hb)
    cvs, olds = prepared.cvs_rel, prepared.olds_rel
    kw = cs._program_kw(hb)
    stats = None

    def run(st):
        got = cs._many_fn(st, rb, cvs, olds, demands=hb.demand,
                          **{**kw, "stats": stats})
        return got[:-1], got[-1]

    def run_plain(st):
        rmq = cs.rmq
        if cs.resident:
            got = ck.resolve_many_res_plain(st, rb, cvs, olds, wave, None,
                                            rmq)
        elif cs.packed:
            got = ck.resolve_many_hist_packed_plain(st, rb, cvs, olds, wave,
                                                    None, rmq)
        else:
            got = ck.resolve_many(st, rb, cvs, olds, hb.demand, wave,
                                  plain=True, rmq=rmq)
        return tuple(got[:-1]), got[-1]

    return run, run_plain, cs.state, hb, rb, cs


def program_bound(state, rb, k: int, b: int) -> tuple[float, str]:
    """The least time of a window program: its batch read once, every
    live row of its history (keys and versions) read once per step, the
    verdicts written once."""
    import torch

    from foundationdb_tpu_torch.models import conflict_kernel as ck

    hist = state.hist if isinstance(state, ck.ResState) else state
    levels = ([hist.base, hist.delta] if isinstance(hist, ck.HistState)
              else [hist])
    live = sum(int(x.n_used) * (x.keys.shape[-1] + 1) * 4 for x in levels)
    batch = sum(x.numel() * x.element_size() for x in leaves(rb).values()
                if isinstance(x, torch.Tensor))
    return bound(batch + k * (live + b))


def k17_step_plain(v, n_used, rs, ls, rbk, floor):
    """The flat blocked arm's probe of a step from its K12 bounds, plain:
    (too_old [B], hist_mask [B, R], cand [B]) with each slot's newest
    write the blocked range max over the live rows of ``v``
    (``range_max_blocked_live_plain``)."""
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    b, r = rbk.read_mask.shape
    newest = ck.range_max_blocked_live_plain(
        v, int(n_used), (rs - 1).clamp(min=0), ls).reshape(b, r)
    live = rbk.read_mask & (rbk.read_begin < rbk.read_end)
    hist_mask = live & (newest > rbk.read_version[:, None])
    too_old = rbk.txn_mask & live.any(1) & (rbk.read_version < floor)
    return too_old, hist_mask, rbk.txn_mask & ~too_old & ~hist_mask.any(1)


def k17_live_checks(label: str, level, rng) -> None:
    """K17's live build over ``level``'s rows [0, n_used) (one kernel)
    bit for bit against the plain twin (``block_table_live``: its live
    blocks and the top's levels over them), and its live queries (random,
    at or past n_used, ending at C, empty, whole prefixes) against the
    twin and against the full-array ``range_max_blocked``."""
    import torch

    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.ops.rmq import (
        block_table,
        block_table_live,
        range_max_blocked,
        range_max_blocked_live,
    )

    neg = ck.NEG_VERSION
    v, n_used = level.versions, level.n_used
    c, n = v.shape[0], int(n_used)
    K.reset_launches()
    table = K.blocked_build(v, n_used)
    if dict(K.ENTRY_LAUNCHES) != {"rb_build": 1}:
        fail(f"rmq_blocked.live_{label}: launches {K.ENTRY_LAUNCHES}")
    twin = block_table_live(v, n, neg)
    nb = -(-n // 256)
    assert_equal(f"rmq_blocked.live_build_{label}",
                 [table[0][:nb], table[1][:nb],
                  table[2][:K.table_levels(nb), :nb]],
                 [twin.prefix, twin.suffix, twin.top])
    nq = 1 << 16
    lo = rng.integers(0, c + 1, nq)
    hi = np.minimum(lo + rng.integers(-2, 1 << 12, nq), c)
    lo[:1024] = rng.integers(min(n, c), c + 1, 1024)
    hi[1024:2048] = c
    hi[2048:3072] = lo[2048:3072]
    lo[3072:4096] = 0
    lo_t, hi_t = (torch.from_numpy(x.astype(np.int32)).cuda()
                  for x in (lo, hi))
    got = K.blocked_query(v, table, lo_t, hi_t, n_used)
    assert_equal(f"rmq_blocked.live_query_{label}", got,
                 range_max_blocked_live(twin, lo_t, hi_t, n, neg))
    assert_equal(f"rmq_blocked.live_query_full_{label}", got,
                 range_max_blocked(block_table(v, neg), lo_t, hi_t, neg))


def k17_checks(flat_state, rbk, res_hist, res_rbk) -> dict:
    """K17 at phase 3i's captured steps. The full build (no n_used) and
    query at N = Cd and N = 2^20 bit for bit against ``block_table`` /
    ``range_max_blocked`` (random bounds with empty, one-block and
    out-of-range queries); the live build and queries over the flat
    arm's history (C = 2^20, its n_used) and the resident two-level arm's
    delta (``k17_live_checks``); the resident blocked probe, flat and
    two-level, against its plain version; the flat step (live build +
    probe of the step's K12 bounds) against ``k17_step_plain``. Then the
    row's timings at 2^20: that flat step, as the arm runs it per step;
    beside it the parent design's figure (the full build + query of the
    slots' bounds), the plain version, one ``torch.cummax`` over the live
    [NB, 256] block rows (the prefix scan alone: no one call computes the
    structure) and the least bytes the step's inputs need."""
    import torch

    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.ops.rmq import block_table, range_max_blocked

    neg = ck.NEG_VERSION
    rng = np.random.default_rng(17)
    delta = res_hist.delta
    for label, v in (("cd", delta.versions), ("c", flat_state.versions)):
        n = v.shape[0]
        table = K.blocked_build(v)
        want = block_table(v, neg)
        assert_equal(f"rmq_blocked.build_{label}", list(table),
                     [want.prefix, want.suffix, want.top])
        nq = 1 << 16
        lo = rng.integers(-300, n + 600, nq)
        hi = rng.integers(-300, n + 600, nq)
        lo[: nq // 2] = rng.integers(0, n, nq // 2)
        hi[: nq // 2] = np.minimum(lo[: nq // 2]
                                   + rng.integers(-2, 700, nq // 2), n)
        lo_t, hi_t = (torch.from_numpy(x.astype(np.int32)).cuda()
                      for x in (lo, hi))
        assert_equal(f"rmq_blocked.query_{label}",
                     K.blocked_query(v, table, lo_t, hi_t),
                     range_max_blocked(want, lo_t, hi_t, neg))
    k17_live_checks("delta", delta, rng)
    k17_live_checks("flat", flat_state, rng)
    floor = flat_state.oldest
    assert_equal("rmq_blocked.probe_c",
                 ck.history_probe(flat_state, rbk, floor, "blocked"),
                 ck.history_probe_plain(flat_state, rbk, floor, "blocked"))
    assert_equal("rmq_blocked.probe_two_level",
                 ck.history_probe(res_hist, res_rbk, delta.oldest, "blocked"),
                 ck.history_probe_plain(res_hist, res_rbk, delta.oldest,
                                        "blocked"))
    _, rs, _, _ = ck._rank_bounds(flat_state.keys, rbk.read_begin)
    ls, _, _, _ = ck._rank_bounds(flat_state.keys, rbk.read_end)
    lo_s, hi_s = (rs - 1).clamp(min=0), ls
    v, n_used = flat_state.versions, flat_state.n_used
    tail = (rbk.read_mask, rbk.read_version, rbk.txn_mask, floor)
    torch.cuda.synchronize()

    def kernel():
        return K.blocked_probe(v, K.blocked_build(v, n_used), rs, ls,
                               rbk.read_begin, rbk.read_end, *tail,
                               n_used=n_used)

    def plain():
        return k17_step_plain(v, n_used, rs, ls, rbk, floor)

    def build_query():  # the parent design's figure
        return K.blocked_query(v, K.blocked_build(v), lo_s, hi_s)

    assert_equal("rmq_blocked.step_c", kernel(), plain())
    assert_equal("rmq_blocked.slots_c", build_query(), range_max_blocked(
        block_table(v, neg), lo_s, hi_s, neg))
    n = int(n_used)
    nb = -(-n // 256)
    rows = torch.cat([v[:n], v.new_full((nb * 256 - n,), neg)]).view(nb, 256)
    prof = cuda_kernels(kernel)
    t = {"ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=3),
         "library_ms": time_ms(lambda: torch.cummax(rows, 1)),
         "build_query_ms": time_ms(build_query),
         "live_build_ms": time_ms(lambda: K.blocked_build(v, n_used)),
         "probe_ms": time_ms(lambda: ck.history_probe(flat_state, rbk, floor,
                                                      "blocked")),
         "device_ms": prof["device_ms"] or None,
         "cuda_kernels": prof["launches"] if prof["device_ms"] else None}
    # Bytes: the live versions read once, their prefix, suffix and top
    # written once; per slot its two bounds, two ranks and mask read, the
    # words this data needs (the block's rows for a one-block range, else
    # two scan words and two top words) and its mask bit written; per
    # transaction its read version and mask read, two outputs written.
    lo_h, hi_h = lo_s.cpu().numpy(), np.minimum(hi_s.cpu().numpy(), n)
    live = (hi_h > lo_h) & rbk.read_mask.reshape(-1).cpu().numpy()
    one = live & (lo_h // 256 == (hi_h - 1) // 256)
    words = int((hi_h - lo_h)[one].sum()) + 4 * int((live & ~one).sum())
    b = rbk.read_mask.shape[0]
    nbytes = (4 * (n + 2 * nb * 256 + K.table_levels(nb) * nb)
              + 18 * len(lo_h) + 4 * words + 7 * b)
    t["bound"] = bound(nbytes)
    t["n"], t["live"], t["queries"] = v.shape[0], n, len(lo_h)
    return t


def k12_w1_row(flat_state, rbk) -> dict:
    """K12 at W = 1 as the flat blocked resident arm runs it: the step's
    slot begin ranks and end ranks searched into the [C, 1] rank keys
    (``_rank_bounds``, two launches), held against the plain two-sided
    search; its time, the plain version's and that of torch.searchsorted
    left and right of both rank sets in the flattened keys (which it must
    also equal); the bound: the ranks read and the four bounds written
    once, and the rows any exact search must read."""
    import torch

    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.ops.lex import searchsorted_words_2sided_fp

    keys = flat_state.keys
    flat = keys.reshape(-1)
    qs = (rbk.read_begin, rbk.read_end)

    def kernel():
        return [ck._rank_bounds(keys, q)[:2] for q in qs]

    def plain():
        return [searchsorted_words_2sided_fp(keys, q.reshape(-1, 1))
                for q in qs]

    def library():
        return [(torch.searchsorted(flat, q.reshape(-1), side="left"),
                 torch.searchsorted(flat, q.reshape(-1), side="right"))
                for q in qs]

    got, want = kernel(), plain()
    assert_equal("word_search_w1", got, want)
    lib = library()
    for g, x in zip(got, lib):
        for a, b in zip(g, x):
            if not torch.equal(a.long(), b):
                fail("K12 at W = 1 differs from torch.searchsorted")
    n = int(keys.shape[0])
    nq = sum(q.numel() for q in qs)
    needed = sum(search_rows_needed(*(x.cpu().numpy() for x in g), n)
                 for g in got)
    return {"ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=3),
            "library_ms": time_ms(library),
            "bound": bound(4 * (nq + 2 * nq + needed)), "queries": nq,
            "rows_needed": needed}


def design_phase(blob, ends, mode, n_batches: int, stream, seed: int,
                 card: str, seq_rec: dict, wave_out: dict) -> dict:
    """Phase 3i: the design arms on the window path, counted, with checks
    (a)-(f) and K17's checks. Returns K17's row measurements."""
    import torch

    from foundationdb_tpu_torch.core import wavemesh
    from foundationdb_tpu_torch.loadgen.ycsb import batch_versions, build_txns
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    n_windows = n_batches // WINDOW_K
    seconds = {}
    t0 = time.perf_counter()
    k17_launches = 0
    w1_launches = 0  # K12 at W = 1 in the flat blocked arm
    programs = {}
    for name, (engine, program, sources, want, never) in ARMS.items():
        rec, _, _, _, launches, per_window = counted_run(
            blob, ends, mode, n_batches, wave=False, engine=engine,
            label=name, program=program, sources=sources)
        k17_launches += launches["rmq_blocked"]
        if name == "b_rmq_blocked_history_batch":
            w1_launches = sum(pw.get("wp_search", 0) for pw in per_window)
        for i, pw in enumerate(per_window):
            if (any(pw.get(e, 0) != n for e, n in want.items())
                    or any(pw.get(e, 0) for e in never)):
                fail(f"{name} window {i}: launches {pw} (want {want}, none "
                     f"of {never})")
        if rec["verdicts_sha256"] != seq_rec["verdicts_sha256"]:
            fail(f"{name}: verdicts differ from the default engine's "
                 "(phase 3b)")
        run, run_plain, state, _, rb, _ = arm_program(blob, ends, mode,
                                                      engine)
        assert_equal(f"design_{name}", run(clone(state)),
                     run_plain(clone(state)))
        torch.cuda.synchronize()
        programs[name] = {
            "launches": launches[program],
            "ms": time_ms(run, lambda: (clone(state),), reps=3),
            "plain_ms": time_ms(run_plain, lambda: (clone(state),), reps=1),
            "bound": program_bound(state, rb, WINDOW_K, mode.batch)}
        print(json.dumps({
            "phase": f"design arm {name}", "engine": engine,
            **{k: rec[k] for k in (
                "txns", "batches", "window", "txns_per_s", "window_ms_p50",
                "window_ms_p99", "committed", "conflict", "too_old",
                "verdicts_sha256", "host_syncs_per_window",
                "host_pack_ms_per_window")},
            "window_program_ms": programs[name]["ms"],
            "launches_per_window": {k: launches[k] / n_windows
                                    for k in (*sources, program)},
            "default_engine_sha_equal": True, "card": card}))
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # K17's checks on the flat blocked arm's captured step (N = 2^20) and
    # the default resident blocked arm's delta (N = Cd).
    _, _, flat, _, rb, _ = arm_program(
        blob, ends, mode, {"rmq": "blocked", "history": "batch"})
    _, _, res, rhb, rrb, _ = arm_program(blob, ends, mode,
                                         {"rmq": "blocked"})
    rbk = ck._step(rb.ranks, 0)
    res1 = ck.apply_delta(clone(res), rrb.delta_keys, rhb.n_new)
    k17 = k17_checks(flat.hist, rbk, res1.hist, ck._step(rrb.ranks, 0))

    def ms(x):
        return "not measured" if x is None else f"{x:.4f}"

    print(f"kernel rmq_blocked (C {k17['n']}, {k17['live']} live rows, "
          f"{k17['queries']} slot queries): the flat step (live build + "
          f"probe) {k17['ms']:.4f} ms ({ms(k17['device_ms'])} ms of device,"
          f" {k17['cuda_kernels']} CUDA kernels by the profiler; plain "
          f"{k17['plain_ms']:.4f} ms, torch.cummax of the live block rows "
          f"{k17['library_ms']:.4f} ms), live build {k17['live_build_ms']:.4f}"
          f" ms, the parent design's build over all rows + query "
          f"{k17['build_query_ms']:.4f} ms, blocked probe with its build "
          f"and K12's rank search {k17['probe_ms']:.4f} ms, bound "
          f"{k17['bound'][0]:.6f} ms")
    k17["launches"] = k17_launches
    k17["w1"] = k12_w1_row(flat.hist, rbk)
    k17["w1"]["launches"] = w1_launches
    w1 = k17["w1"]
    print(f"kernel word_search_w1 (C {flat.hist.keys.shape[0]}, "
          f"{w1['queries']} slot ranks, begin and end): {w1['ms']:.4f} ms "
          f"(plain {w1['plain_ms']:.4f} ms, torch.searchsorted left and "
          f"right {w1['library_ms']:.4f} ms), bound {w1['bound'][0]:.6f} ms")

    # K14 at W = 1 with payloads (sort_ranks_with_payload): the paint
    # endpoints of the captured step's writes, their rank and index.
    from foundationdb_tpu_torch.ops.lex import (
        sort_ranks_with_payload,
        sort_ranks_with_payload_plain,
    )
    r1 = torch.cat([rbk.write_begin.reshape(-1), rbk.write_end.reshape(-1)])
    idx = torch.arange(r1.shape[0], dtype=torch.int32, device=r1.device)
    assert_equal("word_sort.w1", sort_ranks_with_payload(r1, idx, r1),
                 sort_ranks_with_payload_plain(r1, idx, r1))
    seconds["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (d) The packed flat arm speculating: check (c)'s adversary at window
    # 4, depth 3 against depth 1 on cuda; the dependency probe must find a
    # clean younger window (repaired paint-only).
    design = {"resident": False, "history": "batch"}
    spec3 = spec_run(seed, "cuda", 3, False, design=design)
    same_spec(spec3, spec_run(seed, "cuda", 1, False, design=design), False,
              "depth 1", metrics=False)
    if spec3[2]["spec_repaired"] == 0 or spec3[6][0] == 0:
        fail(f"packed flat speculation: metrics {spec3[2]}, dependency "
             f"probe (clean, dependent) {spec3[6]}")
    print(json.dumps({"phase": "design arm d speculative", "engine": design,
                      "spec_metrics": spec3[2],
                      "dependency_probe_clean_dependent": spec3[6],
                      "seconds": spec3[5], "card": card}))
    seconds["d_spec"] = time.perf_counter() - t0
    t0 = time.perf_counter()

    # (f) Wave twins on 16 batches against phase 3c: the unpacked wave
    # engine on the window path, and the packed flat engine through the
    # two-phase protocol on two shards.
    n_wave = 2 * WINDOW_K
    wb, we = blob[: int(ends[n_wave * mode.batch])], \
        ends[: n_wave * mode.batch + 1]
    wrec, wv, wl, _, _, wpw = counted_run(
        wb, we, mode, n_wave, wave=True, engine={"packed": False},
        label="unpacked wave", program="unpacked_many",
        sources=("history_probe", "wave", "word_probe", "word_compact",
                 "word_sort", "word_shard"))
    if not (np.array_equal(wv, wave_out["verdicts"][:2])
            and np.array_equal(wl, wave_out["levels"][:2])):
        fail("unpacked wave engine: verdicts or levels differ from phase 3c")
    for i, pw in enumerate(wpw):
        if (pw.get("wv_pred", 0) != WINDOW_K or pw.get("wv_level", 0)
                != WINDOW_K or pw.get("ac_accept")):
            fail(f"unpacked wave window {i}: launches {pw}")
    single = make_engine(mode, "cuda", wave=True)
    shards = [bench_engine(mode, True, design) for _ in range(2)]
    mid = (N_KEYS // 2).to_bytes(8, "big")
    bounds = [(b"", mid), (mid, b"\xff" * 9)]
    for i in range(n_wave):
        txns = build_txns(*stream, i, mode)
        cv, old = batch_versions(i)
        want = [int(v) for v in single.resolve(txns, cv, old)]
        edges = [s.resolve_edges(wavemesh.clip_txns(txns, lo, hi), cv, old)
                 for s, (lo, hi) in zip(shards, bounds)]
        graph = wavemesh.combine_edges(edges)
        for s in shards:
            if ([int(v) for v in s.resolve_apply(graph)] != want
                    or s.last_wave != single.last_wave):
                fail(f"packed flat two-phase batch {i}: verdicts or levels "
                     "differ from the single wave engine's")
        if (list(wave_out["verdicts"].reshape(-1, mode.batch)[i]) != want
                or single.last_wave != wave_out["levels"].reshape(
                    -1, mode.batch)[i].tolist()):
            fail(f"two-phase batch {i}: verdicts or levels differ from "
                 "phase 3c")
    torch.cuda.synchronize()
    print(json.dumps({"phase": "design arm f wave twins",
                      "unpacked_wave": {k: wrec[k] for k in (
                          "txns", "committed", "reordered", "cycle_aborted",
                          "txns_per_s")},
                      "packed_flat_two_phase_batches": n_wave,
                      "levels_equal_phase_3c": True, "card": card}))
    seconds["f_wave"] = time.perf_counter() - t0
    print(json.dumps({"phase 3i seconds": seconds}))
    k17["programs"] = programs
    return k17


# Phase 3j: the read plane (YCSB-B/C reads over a 2^20-key versioned map).
READ_KEYS = 1 << 20
READ_VERSIONS = 64  # committed versions of Zipf-skewed value updates
READ_CLIENTS, READ_OPS, READ_BATCH = 24, 16_000, 16
READ_SCAN_FRACTION = 0.05
WATCHES, WATCH_VERSIONS, WATCH_WRITES = 1_000_000, 64, 64


def read_key(i: int) -> bytes:
    return b"ycsb/%08d" % i


def read_store(rng):
    """The port's VersionedMap in the shape of the JAX reads/bench.py
    ``_build_store``: READ_KEYS keys at version 1, then READ_VERSIONS
    versions of 32 Pareto-hot value updates each (the key set never
    changes, so the mirror packs once)."""
    from foundationdb_tpu_torch.runtime.storage import VersionedMap

    vm = VersionedMap()
    for i in range(READ_KEYS):  # in key order: each insert appends
        vm.write(read_key(i), 1, b"init%08d" % i)
    for v in range(2, 2 + READ_VERSIONS):
        for i in sorted({min(int(rng.paretovariate(1.5)) - 1, READ_KEYS - 1)
                         for _ in range(32)}):
            vm.write(read_key(i), v, b"u%08d.%08d" % (v, i))
    return vm


def read_stream(rng) -> list:
    """The JAX reads/bench.py ``_build_stream`` op shapes: 95% multi-gets
    of READ_BATCH keys with a log-uniform hot head, 5% scans of 1-16 rows,
    at read versions spread over the map's versions."""
    ops = []
    for _ in range(READ_OPS):
        ver = rng.randrange(1, 2 + READ_VERSIONS)
        if rng.random() < READ_SCAN_FRACTION:
            lo = min(int(rng.paretovariate(1.5)) - 1, READ_KEYS - 1)
            span = 1 + rng.randrange(16)
            ops.append(("range", read_key(lo), read_key(lo + span), span,
                        ver))
        else:
            picks = sorted({int(READ_KEYS ** rng.random()) - 1
                            for _ in range(READ_BATCH)})
            ops.append(("points", [read_key(i) for i in picks], ver))
    return ops


def search_rows_needed(left, right, n: int) -> int:
    """Distinct rows any exact two-sided search must read to certify these
    answers: each bound's row and the row before it (left - 1, left,
    right - 1, right), those of the n rows that exist. A search that
    reads fewer leaves some bound unproved."""
    import numpy as np

    idx = np.concatenate([left - 1, left, right - 1, right]).astype(np.int64)
    return len(np.unique(idx[(idx >= 0) & (idx < n)]))


def read_plane_phase(seed: int, card: str) -> dict:
    """Phase 3j: (a) READ_CLIENTS closed-loop clients through the port's
    ``ReadCoalescer`` and ``TorchReadSet`` on cuda over a READ_KEYS-key
    map, (b) a WATCHES-watch ``WatchIndex`` on the card against arms "1"
    and "0", (c) captured K12 searches against the plain version. Returns
    K12's read-plane row measurements."""
    import random

    import torch

    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.core.keypack import KeyCodec
    from foundationdb_tpu_torch.ops.lex import searchsorted_words_2sided_fp
    from foundationdb_tpu_torch.reads import (
        ReadCoalescer,
        TorchReadSet,
        WatchIndex,
    )
    from foundationdb_tpu_torch.reads.read_set import search2
    from foundationdb_tpu_torch.runtime.flow import Loop, all_of

    seconds = {}
    t0 = time.perf_counter()

    def lap(label: str) -> None:
        nonlocal t0
        now = time.perf_counter()
        seconds[label] = now - t0
        t0 = now

    rng = random.Random(seed)
    vm = read_store(rng)
    stream = read_stream(rng)
    rs = TorchReadSet(vm, arm="device", device="cuda")
    rs._sync()  # the mirror's pack and upload: set-up
    torch.cuda.synchronize()
    lap("store")

    # (a) The coalesced closed loop, counted.
    loop = Loop(seed=seed)
    rc = ReadCoalescer(loop, rs)
    dispatch_ms: list[float] = []
    dispatch = rc._dispatch

    def timed(batch, oldest_ms):
        s = time.perf_counter()
        dispatch(batch, oldest_ms)
        dispatch_ms.append((time.perf_counter() - s) * 1e3)

    rc._dispatch = timed
    answers = [None] * len(stream)
    nxt = [0]

    async def client():
        while nxt[0] < len(stream):
            i = nxt[0]
            nxt[0] += 1
            op = stream[i]
            if op[0] == "points":
                answers[i] = await rc.submit_points(op[1], op[2])
            else:
                answers[i] = await rc.submit_range(*op[1:4], False, op[4])

    K.reset_launches()
    probes0 = rs.stats["probes"]
    t = time.perf_counter()
    loop.run(all_of([loop.spawn(client(), name=f"reads.c{i}")
                     for i in range(READ_CLIENTS)]), timeout=1e9)
    wall = time.perf_counter() - t
    launches = K.ENTRY_LAUNCHES.get("wp_search", 0)
    probes = rs.stats["probes"] - probes0
    n_disp = rc.stats["dispatches"]
    if launches != probes or not n_disp <= launches <= 2 * n_disp:
        fail(f"read plane: {launches} K12 launches for {probes} searches "
             f"in {n_disp} dispatches (want one per search, one or two "
             "per dispatch)")
    if rs.stats["uploads"] != 1 or rs.stats["rebuilds"] != 1:
        fail(f"read plane: mirror uploads {rs.stats['uploads']}, rebuilds "
             f"{rs.stats['rebuilds']} (want 1)")
    host = TorchReadSet(vm, arm="host")
    n_reads = 0
    for op, got in zip(stream, answers):
        if op[0] == "points":
            want = [rs.oracle_get(k, op[2]) for k in op[1]]
            hgot = host.get_points(op[1], op[2])
            n_reads += len(op[1])
        else:
            want = rs.oracle_range(*op[1:4], False, op[4])
            hgot = host.get_ranges([(*op[1:4], False, op[4])])[0]
            n_reads += 1
        if got != want or hgot != want:
            fail(f"read plane: op {op[:1]} differs from the oracle or the "
                 "host arm")
    lat = np.array(dispatch_ms)
    rec = {
        "phase": "read plane", "keys": READ_KEYS, "versions": READ_VERSIONS,
        "clients": READ_CLIENTS, "ops": len(stream), "reads": n_reads,
        "reads_per_s": n_reads / wall, "dispatches": n_disp,
        "reads_per_dispatch": rc.reads_per_dispatch,
        "dispatch_ms_p50": float(np.percentile(lat, 50)),
        "dispatch_ms_p99": float(np.percentile(lat, 99)),
        "k12_launches": launches, "mirror_uploads": rs.stats["uploads"],
        "mirror_mb": READ_KEYS * rs.codec.width * 4 / 1e6,
        "oracle_and_host_arm_equal": True, "card": card}
    print(json.dumps(rec))
    lap("a")

    # (b) WATCHES armed watches on the card and on arms "1" and "0": 64
    # versions of 64 written keys (armed ones at their expected value,
    # some changed, some never armed), a cancel of a quarter of the keys
    # half-way; fire sets, the cancelled entries and the counters equal.
    class Fire:
        __slots__ = ("key", "log")

        def __init__(self, key, log):
            self.key, self.log = key, log

        def send(self, v):
            self.log.append((self.key, v))

    wkeys = [b"w/%08d" % i for i in range(WATCHES)]
    wrng = random.Random(seed + 1)
    versions = []
    for v in range(1, WATCH_VERSIONS + 1):
        written = []
        for _ in range(WATCH_WRITES):
            r = wrng.random()
            k = (b"x/%08d" % wrng.randrange(WATCHES) if r < 0.1
                 else wkeys[wrng.randrange(WATCHES)])
            written.append((k, b"changed%d" % v if r > 0.85 else b"expect"))
        versions.append((v, written))
    half = WATCH_VERSIONS // 2
    cancel = (b"w/%08d" % (WATCHES // 4), b"w/%08d" % (WATCHES // 2))
    arms = {}
    for arm in ("device", "1", "0"):
        idx = WatchIndex(arm=arm, device="cuda" if arm == "device" else None)
        log: list = []
        for k in wkeys:
            idx.add(k, b"expect", Fire(k, log))
        sweep_ms, fired = [], []
        cancelled = None
        K.reset_launches()
        for v, written in versions:
            if v == half:
                cancelled = sorted(k for k, _, _ in idx.cancel_range(*cancel))
            s = time.perf_counter()
            fired.append(idx.sweep(v, written))
            sweep_ms.append((time.perf_counter() - s) * 1e3)
        arms[arm] = {"log": sorted(log), "fired": fired,
                     "cancelled": cancelled, "stats": dict(idx.stats),
                     "sweep_ms": sweep_ms,
                     "k12": K.ENTRY_LAUNCHES.get("wp_search", 0)}
        del idx
    dev = arms["device"]
    for arm in ("1", "0"):
        other = arms[arm]
        if (dev["log"] != other["log"] or dev["fired"] != other["fired"]
                or dev["cancelled"] != other["cancelled"]):
            fail(f"watches: the device arm's fire set differs from arm {arm}")
        # Arm "0" searches no packed rows (no probed count); only the
        # device arm uploads.
        skip = ("uploads", "probed") if arm == "0" else ("uploads",)
        if any(dev["stats"][k] != other["stats"][k]
               for k in dev["stats"] if k not in skip):
            fail(f"watches: stats {dev['stats']} vs arm {arm} "
                 f"{other['stats']}")
    if dev["k12"] != WATCH_VERSIONS or not dev["log"]:
        fail(f"watches: {dev['k12']} K12 launches for {WATCH_VERSIONS} "
             f"sweeps, {len(dev['log'])} fires")
    print(json.dumps({
        "phase": "read plane watches", "watches": WATCHES,
        "versions": WATCH_VERSIONS, "writes_per_version": WATCH_WRITES,
        "fired": len(dev["log"]), "cancelled": len(dev["cancelled"]),
        "sweep_ms_p50": {a: float(np.median(r["sweep_ms"][1:]))
                         for a, r in arms.items()},
        "first_sweep_ms": {a: r["sweep_ms"][0] for a, r in arms.items()},
        "stats": dev["stats"], "arms_equal": True, "card": card}))
    del arms
    lap("b")

    # (c) Captured K12 read-plane searches against the plain version: one
    # dispatch's query rows (timed), random rows, truncated equal-prefix
    # keys, k = 1, a query above every row, an empty mirror.
    codec = rs.codec
    first = [k for op in stream[:READ_CLIENTS] if op[0] == "points"
             for k in op[1]]
    q = torch.from_numpy(codec.pack(first)).cuda()
    mirror = rs._dev_rows

    def kernel():
        return search2(mirror, q)

    def plain():
        return searchsorted_words_2sided_fp(mirror, q)

    assert_equal("word_search_reads", [x.cpu() for x in kernel()],
                 [x.cpu() for x in plain()])
    qrand = torch.from_numpy(codec.pack(
        [read_key(rng.randrange(2 * READ_KEYS)) for _ in range(777)]
        + [b"\xff" * 40])).cuda()
    cases = [("random", mirror, qrand), ("k1", mirror, qrand[:1]),
             ("above", mirror, qrand[-1:])]
    tcodec = KeyCodec(8)
    tkeys = sorted({b"prefix%02d" % (i % 5) + b"-%d" % i for i in range(300)})
    trows = torch.from_numpy(tcodec.pack(tkeys)).cuda()
    cases.append(("truncated", trows, torch.from_numpy(tcodec.pack(
        tkeys[::7] + [b"prefix03", b"prefix03\xff"])).cuda()))
    cases.append(("empty", trows[:0], trows[:9]))
    for label, rows, qq in cases:
        assert_equal(f"word_search_reads.{label}",
                     [x.cpu() for x in search2(rows, qq)],
                     list(searchsorted_words_2sided_fp(rows.cpu(), qq.cpu())))
    torch.cuda.synchronize()
    left, right = (x.cpu().numpy() for x in kernel())
    k, w = q.shape
    needed = search_rows_needed(left, right, mirror.shape[0])
    t = {"ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=3),
         "bound": bound(4 * (k * w + 2 * k + needed * w)),
         "launches": launches, "queries": k, "rows_needed": needed}
    print(f"kernel word_search_reads (mirror {mirror.shape[0]} x {w}, {k} "
          f"query rows of one dispatch): {t['ms']:.4f} ms (plain "
          f"{t['plain_ms']:.4f} ms), {needed} mirror rows any exact search "
          f"reads, bound {t['bound'][0]:.6f} ms")
    lap("c")
    print(json.dumps({"phase 3j seconds": seconds}))
    return t


# Phase 3k: the sharded engines' design arms (name: (engine arguments,
# window program, kernel sources, entry launches per window as multiples
# of (k, S·k), entries never launched)). A blocked arm launches K17's
# sharded probe (its live build and its probe in one entry) once a step:
# no separate build, no K2 table.
_NRS_PAINT = ("wc_paint_keys", "wp_search", "wso_sort", "wc_paint_sorted")
SHARD_ARMS = {
    "sharded_blocked": (
        {"rmq": "blocked"}, "sharded_many",
        (*SHARD_SEQ, "rmq_blocked"),
        {"rb_shard_probe": (1, 0), "sh_clip": (1, 0), "ac_accept": (1, 0),
         "sc_paint": (0, 1)},
        ("sh_probe", "wsh_probe", "hp_probe", "wp_probe", "rb_build",
         "hp_table", "sh_exchange")),
    "nr_sharded_blocked": (
        {"resident": False, "rmq": "blocked"}, "nr_sharded_many",
        (*NRS_SEQ, "rmq_blocked"),
        {"rb_shard_probe": (1, 0), "wsh_clip": (1, 0), "wso_ranks": (1, 0),
         "ac_accept": (1, 0), **{e: (0, 1) for e in _NRS_PAINT}},
        ("wsh_probe", "sh_probe", "di_insert", "sc_paint", "wp_probe",
         "wc_paint", "hp_probe", "rb_build", "hp_table", "sh_exchange")),
    "sharded_unpacked": (
        {"packed": False}, "nr_sharded_many", NRS_SEQ,
        {"wsh_probe": (1, 0), "wsh_clip": (1, 0),
         "wso_ranks": (1, 0), "ac_accept": (1, 0),
         **{e: (0, 1) for e in _NRS_PAINT}},
        ("di_insert", "sc_paint", "sh_probe", "wp_probe", "wc_paint",
         "hp_probe", "hp_table", "rb_build", "rb_shard_probe",
         "sh_exchange")),
}
SHARD_ARM_REPLACES = {
    "sharded_blocked": "foundationdb_tpu/parallel/sharded_resolver.py:249",
    "nr_sharded_blocked": "foundationdb_tpu/parallel/sharded_resolver.py:551",
    "sharded_unpacked": "foundationdb_tpu/parallel/sharded_resolver.py:551",
}


def sharded_arm_program(blob, ends, mode, engine: dict):
    """A warm window program of a sharded arm on the card and its plain
    version: the first window after window 0 that needs no full repack
    (and, resident, brings a dictionary delta), uploaded. Returns (run,
    run_plain, state, rb, hb, the engine, its first step's probe inputs:
    (hist, step batch, lo, hi, floor))."""
    import torch

    from foundationdb_tpu_torch import bench
    from foundationdb_tpu_torch.models import conflict_kernel as ck
    from foundationdb_tpu_torch.models.conflict_set import _RepackPlan

    b = mode.batch
    cs = bench.make_engine(mode, CAP, "cuda", **engine)
    cs.resolve_wire_window(*bench.window_wire(blob, ends, mode, WINDOW_K, 0),
                           b)
    n_windows = (len(ends) - 1) // (WINDOW_K * b)
    for wi in range(1, n_windows):
        prepared = cs.pack_wire_window(
            *bench.window_wire(blob, ends, mode, WINDOW_K, wi), b)
        hb = prepared.batch
        if not cs.resident or (not isinstance(hb, _RepackPlan) and hb.n_new):
            break
        cs.dispatch_window(prepared)()
    else:
        fail("no window of the stream brings a dictionary delta")
    rb = cs._upload(hb)
    cvs, olds = prepared.cvs_rel, prepared.olds_rel
    state, rmq = cs.state, cs.rmq
    if cs.resident:
        def run(st):
            v, _, _, r = ck.sharded_resolve_res_many(st, rb, cvs, olds,
                                                     hb.n_new, rmq=rmq)
            return v, r

        def run_plain(st):
            v, _, _, r = ck.sharded_resolve_res_many_plain(st, rb, cvs, olds,
                                                           rmq=rmq)
            return v, r

        res1 = ck.apply_delta(clone(state), rb.delta_keys, hb.n_new)
        hist, lo, hi = res1.hist, res1.shard_lo, res1.shard_hi
        step = ck._step(rb.ranks, 0)
    else:
        lo, hi = cs._lo_dev, cs._hi_dev

        def run(st):
            v, _, _, h = ck.sharded_resolve_many(st, rb, cvs, olds, lo, hi,
                                                 rmq=rmq)
            return v, h

        def run_plain(st):
            v, _, _, h = ck.sharded_resolve_many(st, rb, cvs, olds, lo, hi,
                                                 plain=True, rmq=rmq)
            return v, h

        hist, step = state, ck._step_batch(rb, 0)
    floor = torch.maximum(hist.oldest, torch.full(
        (), int(olds[0]), dtype=torch.int32, device="cuda"))[0]
    return run, run_plain, state, rb, cs, (hist, step, lo, hi, floor)


def sharded_probe_bytes(hist, step) -> int:
    """K8's and K16's bound basis: the shards' live keys and versions, the
    read slots, read versions and txn mask read once, the [B, R] mask and
    three [B] outputs written."""
    s, _, w = hist.keys.shape
    b, r = step.read_mask.shape
    live = int(hist.n_used.sum())
    return (4 * (w + 1) * live + b * r * (8 * w + 1) + 5 * b + b * r + 3 * b
            + 8 * s * w + 4)


def blocked_shard_twin(resident: bool, h, step, lo, hi, floor):
    """The plain twin of K17's sharded probe's algorithm (live_probe.cuh's
    searches over each shard's live rows, the blocked structure over
    them): ``shard_probe_live_plain`` or ``word_shard_probe_live_plain``
    with ``rmq="blocked"``."""
    from foundationdb_tpu_torch.models import conflict_kernel as ck

    if resident:
        return ck.shard_probe_live_plain(h, step, lo, hi, floor,
                                         rmq="blocked")
    return ck.word_shard_probe_live_plain(h, step, lo, hi, floor,
                                          rmq="blocked")


def blocked_probe_report(fn, h) -> dict:
    """K17's sharded call ``fn`` on the card: the device ms of its build
    (``k_build``) and of its probe (``lp_probe``) by the profiler, the
    CUDA kernels a call launches (by the profiler, and as
    ``rb_shard_probe`` counts its launches), the shards' live rows, the
    int32 words of the structure (``blocked_words``) and the bytes of the
    workspace scratch that holds it, read after the call."""
    import torch
    from foundationdb_tpu_torch import kernels as K

    prof = cuda_kernels(fn)
    counted = K.BLOCKED_PROBE_KERNELS["last"]
    held = K._workspace(torch.device("cuda"), 0)[1].numel() * 4

    def device(part):  # None: the profiler saw no kernel (not measured)
        if not prof["device_ms"]:
            return None
        return sum(ms for name, ms in prof["kernels"].items() if part in name)

    s, c = h.keys.shape[0], h.keys.shape[1]
    return {"build_ms": device("k_build"), "probe_only_ms": device(
        "lp_probe"), "device_ms": device(""),
        "cuda_kernels": prof["launches"] if prof["device_ms"] else None,
        "kernels_counted": counted, "live_rows": h.n_used.tolist(),
        "table_words": K.blocked_words(s, c), "workspace_bytes": held}


def blocked_full_shards(resident: bool, h, step, floor) -> dict:
    """K17's sharded probe at full shards (every n_used = C, from
    ``full_shards`` at the captured step's shapes) against its plain
    version and its algorithm's twin: its card ms and device ms."""
    import torch

    from foundationdb_tpu_torch.models import conflict_kernel as ck

    s, c, w = h.keys.shape
    b, r = step.read_mask.shape
    fh, rb, re_, m, rv, tm, lo, hi = full_shards(s, c, 0 if resident else w,
                                                 b, r, 0)
    if resident:
        fb = step._replace(read_begin=rb, read_end=re_, read_mask=m,
                           read_version=rv, txn_mask=tm)

        def fn():
            return ck.shard_probe(fh, fb, lo, hi, floor, "blocked")

        plain = ck.shard_probe_plain(fh, fb, lo, hi, floor, "blocked")
    else:
        fb = step._replace(read_begin=rb, read_end=re_, read_mask=m,
                           read_version=rv, txn_mask=tm)

        def fn():
            return ck.word_shard_probe(fh, fb, lo, hi, floor, rmq="blocked")

        plain = ck.word_shard_probe_plain(fh, fb, lo, hi, floor, "blocked")
    assert_equal("rmq_blocked.full_shards", fn(), plain)
    assert_equal("rmq_blocked.full_shards_twin", fn(),
                 blocked_shard_twin(resident, fh, fb, lo, hi, floor))
    torch.cuda.synchronize()
    prof = cuda_kernels(fn)
    return {"full_shard_ms": time_ms(fn),
            "full_shard_device_ms": prof["device_ms"] or None}


def check_blocked_probe(name: str, r: dict) -> None:
    """K17's sharded call launches its build and its probe, two CUDA
    kernels, as ``rb_shard_probe`` counts them at their launches and,
    where it saw them, as the profiler does; and the workspace holds the
    structure."""
    seen = r["cuda_kernels"]
    if r["kernels_counted"] != 2 or (seen is not None and seen > 2):
        fail(f"{name}: {r['kernels_counted']} CUDA kernels a call counted "
             f"at launch (profiler: {seen}), want 2")
    if r["workspace_bytes"] < 4 * r["table_words"]:
        fail(f"{name}: workspace {r['workspace_bytes']} bytes, the blocked "
             f"structure needs {4 * r['table_words']}")


def print_blocked_probe(name: str, r: dict, h) -> None:
    def ms(x):
        return "not measured" if x is None else f"{x:.4f}"

    print(f"kernel {name} (S = {h.keys.shape[0]}, C = {h.keys.shape[1]}, W "
          f"= {h.keys.shape[-1]}; live rows {r['live_rows']}): build + probe"
          f" {r['ms']:.4f} ms (plain {r['plain_ms']:.4f} ms; the sparse "
          f"arm's {r['sparse_ms']:.4f} ms); device ms: build "
          f"{ms(r['build_ms'])}, probe {ms(r['probe_only_ms'])} "
          f"({r['kernels_counted']} CUDA kernels a call counted at launch, "
          f"{r['cuda_kernels']} by the profiler); the structure "
          f"{4 * r['table_words']} bytes in a workspace scratch of "
          f"{r['workspace_bytes']} bytes; full shards (n_used = C) "
          f"{r['full_shard_ms']:.4f} ms ({ms(r['full_shard_device_ms'])} ms "
          f"of device); bound {r['bound'][0]:.6f} ms")


def sharded_arms_phase(blob, ends, mode, n_batches: int, stream, card: str,
                       seq_rec: dict, wave_out: dict) -> dict:
    """Phase 3k: each sharded design arm on the window path, counted, with
    its captured window program and (blocked) K17's sharded probe held
    against the plain versions; the unpacked sharded wave twin against 3c.
    Returns the rows' measurements."""
    import torch

    from foundationdb_tpu_torch.models import conflict_kernel as ck

    n_windows = n_batches // WINDOW_K
    seconds, programs, probes = {}, {}, {}
    t0 = time.perf_counter()
    for name, (arm, program, sources, want, never) in SHARD_ARMS.items():
        engine = {**sharded_engine(stream, mode), **arm}
        caps, restore = capture_launches()
        try:
            rec, _, _, cs, launches, per_window = counted_run(
                blob, ends, mode, n_batches, wave=False, engine=engine,
                label=name, program=program, sources=sources)
        finally:
            restore()
        checked = check_launches(caps, name)
        if program == "nr_sharded_many" and checked["clip"] < n_batches:
            fail(f"{name}: {checked['clip']} K15 launches checked for "
                 f"{n_batches} steps")
        want_n = {e: k * WINDOW_K + s * SHARDS * WINDOW_K
                  for e, (k, s) in want.items()}
        for i, pw in enumerate(per_window):
            if (any(pw.get(e, 0) != n for e, n in want_n.items())
                    or any(pw.get(e, 0) for e in never)):
                fail(f"{name} window {i}: launches {pw} (want {want_n}, "
                     f"none of {never})")
        if rec["verdicts_sha256"] != seq_rec["verdicts_sha256"]:
            fail(f"{name}: verdicts differ from the default engine's "
                 "(phase 3b)")
        run, run_plain, state, rb, arm_cs, probe_in = sharded_arm_program(
            blob, ends, mode, engine)
        assert_equal(f"design_{name}", run(clone(state)),
                     run_plain(clone(state)))
        torch.cuda.synchronize()
        hist = probe_in[0]
        live = int(hist.n_used.sum()) * (hist.keys.shape[-1] + 1) * 4
        batch = sum(x.numel() * x.element_size()
                    for x in leaves(rb).values()
                    if isinstance(x, torch.Tensor))
        programs[name] = {
            "launches": launches[program],
            "ms": time_ms(run, lambda: (clone(state),), reps=3),
            "plain_ms": time_ms(run_plain, lambda: (clone(state),), reps=1),
            "bound": bound(batch + WINDOW_K * (live + mode.batch))}
        entries = {e: sum(pw.get(e, 0) for pw in per_window) for e in want}
        print(json.dumps({
            "phase": f"sharded arm {name}", "engine": {
                k: v for k, v in engine.items() if k != "splits"},
            **{k: rec[k] for k in (
                "txns", "batches", "window", "txns_per_s", "window_ms_p50",
                "window_ms_p99", "committed", "conflict", "too_old",
                "verdicts_sha256", "shard_occupancy",
                "host_syncs_per_window", "host_pack_ms_per_window")},
            "window_program_ms": programs[name]["ms"],
            "launches_per_window": {e: n / n_windows
                                    for e, n in entries.items()},
            "default_engine_sha_equal": True, "card": card}))
        if arm.get("rmq") == "blocked":
            # K17's sharded probe at the captured step, with its build,
            # against its plain version (and K8's or K16's sparse answer).
            h, step, lo, hi, floor = probe_in
            if arm_cs.resident:
                def k17(rmq="blocked"):
                    return ck.shard_probe(h, step, lo, hi, floor, rmq)

                def k17_plain():
                    return ck.shard_probe_plain(h, step, lo, hi, floor,
                                                "blocked")
            else:
                def k17(rmq="blocked"):
                    return ck.word_shard_probe(h, step, lo, hi, floor,
                                               rmq=rmq)

                def k17_plain():
                    return ck.word_shard_probe_plain(h, step, lo, hi, floor,
                                                     "blocked")
            label = ("rmq_blocked_shard" if arm_cs.resident
                     else "rmq_blocked_word_shard")
            assert_equal(label, k17(), k17_plain())
            assert_equal(f"{label}.sparse", k17(), k17("sparse"))
            assert_equal(f"{label}.live_twin", k17(),
                         blocked_shard_twin(arm_cs.resident, h, step, lo,
                                            hi, floor))
            torch.cuda.synchronize()
            probes[label] = {
                "launches": entries["rb_shard_probe"],
                "ms": time_ms(k17), "plain_ms": time_ms(k17_plain, reps=2),
                "sparse_ms": time_ms(lambda: k17("sparse")),
                "bound": bound(sharded_probe_bytes(h, step)),
                "replaces": "foundationdb_tpu/models/conflict_kernel.py:"
                            + ("2143" if arm_cs.resident else "237"),
                **blocked_probe_report(k17, h),
                **blocked_full_shards(arm_cs.resident, h, step, floor)}
            p = probes[label]
            check_blocked_probe(label, p)
            print_blocked_probe(label, p, h)
        seconds[name] = time.perf_counter() - t0
        t0 = time.perf_counter()

    # The unpacked sharded wave twin on 16 batches against phase 3c.
    n_wave = 2 * WINDOW_K
    wb, we = blob[: int(ends[n_wave * mode.batch])], \
        ends[: n_wave * mode.batch + 1]
    caps, restore = capture_launches()
    try:
        wrec, wv, wl, _, _, wpw = counted_run(
            wb, we, mode, n_wave, wave=True,
            engine={**sharded_engine(stream, mode), "packed": False},
            label="sharded unpacked wave", program="nr_sharded_many",
            sources=NRS_WAVE)
    finally:
        restore()
    checked = check_launches(caps, "3k_wave")
    if not (np.array_equal(wv, wave_out["verdicts"][:2])
            and np.array_equal(wl, wave_out["levels"][:2])):
        fail("sharded unpacked wave engine: verdicts or levels differ from "
             "phase 3c")
    for i, pw in enumerate(wpw):
        if (pw.get("wv_level", 0) != WINDOW_K or pw.get("ac_accept")
                or pw.get("sh_exchange", 0) or pw.get("wv_pred", 0)
                or pw.get("wv_pred_or", 0) != SHARDS * WINDOW_K
                or pw.get("wsh_clip", 0) != WINDOW_K):
            fail(f"sharded unpacked wave window {i}: launches {pw}")
    if min(checked.values()) < n_wave:
        fail(f"sharded unpacked wave: launches checked {checked} for "
             f"{n_wave} batches")
    print(json.dumps({"phase": "sharded arm unpacked wave",
                      **{k: wrec[k] for k in (
                          "txns", "committed", "reordered", "cycle_aborted",
                          "txns_per_s")},
                      "levels_equal_phase_3c": True, "card": card}))
    seconds["wave"] = time.perf_counter() - t0
    print(json.dumps({"phase 3k seconds": seconds}))
    return {"programs": programs, "probes": probes}


# Phase 3m: one generation of the commit path (sim/commit_path.py: the
# sequencer, R resolvers, the commit and GRV proxies, a tlog, two storage
# servers and the ratekeeper on one loop) under 512 closed-loop YCSB-A
# clients over 2^20 keys, the resolvers over the deployed engine
# (server.make_conflict_set: capacity 2^16, batch 512). Runs: (resolvers,
# wave commit, speculation (spec_depth 2), the resolver queue's budget in
# s, commits).
COMMIT_RUNS = {"a": (1, False, False, None, 65_536),
               "b": (2, False, False, None, 16_384),
               "c": (2, True, False, None, 16_384),
               "d": (1, False, True, 0.005, 16_384)}
COMMIT_CLIENTS = 512
COMMIT_KEY_BITS = 20


def commit_path_run(run: str, engine: str, seed: int) -> dict:
    """Run ``run`` of phase 3m over ``engine``: ``"cuda"`` (the card
    engine, the storage servers' read plane on the card), ``"cpu"`` (the
    same engines and read plane on the CPU: the plain versions) or
    ``"oracle"`` (``IndexedOracleConflictSet``, the read plane on the
    CPU); the last two also in worker processes beside phase 4. Returns
    the run's summary, whether every acknowledged write read back through
    the owning storage server's read plane equal to the host replay, the
    roles' metrics, each engine's state leaves hashed (the mirror's too),
    and on cuda the wall ms of every resolver dispatch and the launches."""
    import torch

    from foundationdb_tpu_torch import convert, server
    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.models.conflict_set import TorchConflictSet
    from foundationdb_tpu_torch.sim.commit_path import CommitPath
    from foundationdb_tpu_torch.sim.oracle import IndexedOracleConflictSet

    n_res, wave, spec, budget, n = COMMIT_RUNS[run]
    if engine == "cpu":
        torch.set_num_threads(2)  # beside the cross-checks of phase 4
    device = None if engine == "cuda" else "cpu"

    def make():
        if engine == "oracle":
            return IndexedOracleConflictSet(wave_commit=wave)
        if spec:
            return TorchConflictSet(spec_resolve=True, spec_depth=2,
                                    device=device)
        return server.make_conflict_set("torch", n_resolvers=n_res,
                                        wave_commit=wave, device=device)

    engines = [make() for _ in range(n_res)]
    times: list = []
    cp = CommitPath(engines, seed=seed, wave_commit=wave, budget_s=budget,
                    storage_kw={"device": device},
                    dispatch_times=times if engine == "cuda" else None)
    K.reset_launches()
    summary = cp.run_ycsb(n, COMMIT_CLIENTS, COMMIT_KEY_BITS, seed=seed)
    version = cp.settle()
    final = cp.replay()
    before = K.ENTRY_LAUNCHES.get("wp_search", 0)
    got = cp.read_back(version, sorted(final))
    out = {
        "summary": summary, "version": version, "written_keys": len(final),
        "read_back_equal": got == final,
        "read_back_k12": K.ENTRY_LAUNCHES.get("wp_search", 0) - before,
        "launches": dict(K.LAUNCHES), "entries": dict(K.ENTRY_LAUNCHES),
        "metrics": json.loads(json.dumps(cp.metrics(), default=repr)),
        "dispatch_ms": [t * 1e3 for t in times], "leaves": None,
        "overflowed": [bool(getattr(cs, "overflowed", False))
                       for cs in engines]}
    if engine != "oracle":
        leaves = []
        for cs in engines:
            snap = convert.snapshot(cs)
            arrays = {**snap["state"], **{f"mirror.{k}": v for k, v in
                                          (snap.get("mirror") or {}).items()
                                          if k != "stats"}}
            leaves.append({k: hashlib.sha256(np.ascontiguousarray(
                v).tobytes()).hexdigest() for k, v in arrays.items()})
        out["leaves"] = leaves
    return out


def commit_path_phase(seed: int, card: str) -> dict:
    """Phase 3m's card half: runs (a)-(d) over the card engine, each
    fatal on failure (no unknown outcome, every acknowledged write read
    back, no fail-safe, no overflow, K1-K4 launched on the sequential
    runs, K5 and K6 and never K3 on the wave run, the speculative group
    path taken on (d), K12's search by the storage servers' read plane);
    the CPU and oracle halves are checked after phase 4."""
    out = {}
    for run, (n_res, wave, spec, budget, n) in COMMIT_RUNS.items():
        r = commit_path_run(run, "cuda", seed)
        s, L, E = r["summary"], r["launches"], r["entries"]
        label = f"commit path ({run})"
        if s["other"] or s["committed"] + s["conflict"] + s["too_old"] != n:
            fail(f"{label}: {s['other']} outcomes neither committed, "
                 "conflict nor too old")
        if not r["read_back_equal"] or not r["written_keys"]:
            fail(f"{label}: an acknowledged write did not read back "
                 "through the storage servers' read plane")
        for i, m in enumerate(r["metrics"]["resolvers"]):
            if m["txns_rejected_fail_safe"] or m["overflow_events"] or \
                    r["overflowed"][i]:
                fail(f"{label}: resolver {i} took its fail-safe "
                     f"({m['txns_rejected_fail_safe']} txns) or overflowed")
        want = (("wv_pred", "wv_level") if wave else ())
        if wave and (any(E.get(e, 0) <= 0 for e in want) or L["accept"]):
            fail(f"{label}: K5/K6 not launched or K3 launched: {E}")
        if not wave and any(L[k] <= 0 for k in SEQ_SOURCES):
            fail(f"{label}: a kernel of K1-K4 was not launched: {L}")
        if r["read_back_k12"] < 1:
            fail(f"{label}: the read plane launched no K12 search")
        if spec and r["metrics"]["resolvers"][0]["spec_dispatched"] <= 0:
            fail(f"{label}: the speculative group path never ran")
        if wave and r["metrics"]["commit_proxy"]["wave_exchanges"] <= 0:
            fail(f"{label}: no batch went through the global wave protocol")
        d = np.asarray(r["dispatch_ms"])
        if not len(d):
            fail(f"{label}: no resolver dispatch was timed")
        print(json.dumps({
            "phase": "commit path", "run": run, "resolvers": n_res,
            "wave_commit": wave, "spec_resolve": spec, "budget_s": budget,
            "commits": n, "clients": COMMIT_CLIENTS,
            "wall_s": s["wall_s"], "commits_per_s": n / s["wall_s"],
            "committed_share": s["committed"] / n,
            "conflict": s["conflict"], "too_old": s["too_old"],
            "virtual_s": s["virtual_s"], "batches": s["batches"],
            "dispatches": len(d),
            "dispatch_ms_p50": float(np.percentile(d, 50)),
            "dispatch_ms_p99": float(np.percentile(d, 99)),
            "dispatch_ms_max5": sorted(d.tolist())[-5:],
            "engine": [m["engine"] for m in r["metrics"]["resolvers"]],
            "launches": {k: v for k, v in L.items() if v},
            "entries": E, "read_back_keys": r["written_keys"],
            "read_back_k12": r["read_back_k12"],
            "spec_dispatched": r["metrics"]["resolvers"][0][
                "spec_dispatched"],
            "commit_outcomes_sha256": s["commit_outcomes_sha256"],
            "card": card}))
        out[run] = r
    return out


def check_commit_path(cm: dict, jobs: dict) -> None:
    """Phase 3m's CPU halves (workers beside phase 4): each run over the
    plain versions on the CPU gives the card's outcomes, reads, roles'
    metrics and every engine leaf; over the oracle, the card's outcomes
    and reads."""
    for run, r in cm.items():
        s = r["summary"]
        cpu, orc = jobs[run]["cpu"].get(), jobs[run]["oracle"].get()
        for name, o in (("the cpu", cpu), ("the oracle", orc)):
            for k in ("commit_outcomes_sha256", "reads_sha256"):
                if o["summary"][k] != s[k]:
                    fail(f"commit path ({run}): {k} {s[k]} on cuda, "
                         f"{o['summary'][k]} over {name}")
            if not o["read_back_equal"]:
                fail(f"commit path ({run}): a write did not read back over "
                     f"{name}")
        if cpu["leaves"] != r["leaves"]:
            fail(f"commit path ({run}): an engine leaf differs on the cpu")
        if cpu["metrics"] != r["metrics"]:
            fail(f"commit path ({run}): the roles' metrics differ on the cpu")
        print(json.dumps({
            "cross-check": f"commit path ({run})",
            "commit_outcomes_sha256": {
                "cuda": s["commit_outcomes_sha256"],
                "cpu": cpu["summary"]["commit_outcomes_sha256"],
                "oracle": orc["summary"]["commit_outcomes_sha256"]},
            "leaves_equal": True, "metrics_equal": True,
            "cpu_wall_s": cpu["summary"]["wall_s"],
            "oracle_wall_s": orc["summary"]["wall_s"]}))


# Phase 3n: one simulated cluster (sim/cluster.py SimCluster: coordinators,
# an elected cluster controller, the commit path's roles on a SimNetwork,
# two tlogs, two storage servers in one team of two) under 256 closed-loop
# YCSB-A clients over 2^20 keys, each transaction through the client
# library (open_database(c).run: tr.get_multi, tr.set, the commit), with
# kills at counts of finished transactions. The engines are the sim's
# (new_conflict_set("torch"): capacity 2^14, batch 256), recruited afresh
# on the card at every recovery. Runs: (resolvers, wave commit,
# transactions, {fraction of the run: role to kill}).
CLUSTER_RUNS = {"a": (1, False, 8_192, {1 / 3: "resolver0",
                                         2 / 3: "tlog0"}),
                "b": (2, True, 4_096, {1 / 2: "resolver1"})}
CLUSTER_CLIENTS = 256
CLUSTER_KEY_BITS = 20


class Generations:
    """Watches the generations of one ``SimCluster`` for phases 3n and 3o
    and changes none of its events. Each generation's record: its epoch
    and recovery version, the virtual and wall time it opened, and, at its
    close (the next recruitment, or ``close``), the kernel launches since
    the last close (``kernels.LAUNCHES`` and ``ENTRY_LAUNCHES``, reset
    then) and its resolvers' resolved, fail-safe and overflow counts.
    ``on_open`` is called with each generation's resolvers. Off the card
    each storage server reads through the read plane's host arm (numpy's
    search of the mirror's memcmp view, the device arm's answers byte for
    byte; K12's plain twin, a torch search step by step, would take most
    of a CPU run's time)."""

    def __init__(self, c, on_card: bool, on_open=None):
        self.c, self.gens, self._on_open = c, [], on_open
        if not on_card:
            from foundationdb_tpu_torch.reads.read_set import TorchReadSet

            for s in c.storages:
                s.read_set = s._reads.read_set = TorchReadSet(s.map,
                                                              arm="host")
        recruit = c.recruit_generation

        def recruit_and_watch(epoch, recovery_version, seed_entries):
            self.close()
            gen = recruit(epoch=epoch, recovery_version=recovery_version,
                          seed_entries=seed_entries)
            self._open(epoch, recovery_version)
            return gen

        c.recruit_generation = recruit_and_watch
        g = c.controller.generation
        self._open(g.epoch, g.recovery_version)

    def _open(self, epoch: int, recovery_version: int) -> None:
        c = self.c
        if self._on_open is not None:
            self._on_open(c.resolvers)
        self.gens.append({
            "epoch": epoch, "recovery_version": recovery_version,
            "virtual": c.loop.now, "wall": time.perf_counter(),
            "resolvers": list(c.resolvers)})

    def close(self) -> None:
        """Close the open generation, if one is open."""
        from foundationdb_tpu_torch import kernels as K

        if not self.gens or "launches" in self.gens[-1]:
            return
        g = self.gens[-1]
        resolvers = g.pop("resolvers")
        m = [settled(r.get_metrics()) for r in resolvers]
        g.update(launches=dict(K.LAUNCHES), entries=dict(K.ENTRY_LAUNCHES),
                 txns_resolved=[x["txns_resolved"] for x in m],
                 fail_safe=[x["txns_rejected_fail_safe"] for x in m],
                 overflow_events=[x["overflow_events"] for x in m],
                 overflowed=[bool(getattr(r.cs, "overflowed", False))
                             for r in resolvers])
        K.reset_launches()


def check_generation(label: str, g: dict, kernels=(), entries=()) -> None:
    """Fatal unless the closed generation ``g`` (a ``Generations`` record)
    shows no resolver fail-safe or overflow, and launched each of
    ``kernels`` (by source) and ``entries`` (by entry point)."""
    if any(g["fail_safe"]) or any(g["overflow_events"]) or \
            any(g["overflowed"]):
        fail(f"{label} epoch {g['epoch']}: a resolver took its fail-safe or "
             f"overflowed: {g}")
    missing = [k for k in kernels if g["launches"].get(k, 0) <= 0] + \
        [e for e in entries if g["entries"].get(e, 0) <= 0]
    if missing:
        fail(f"{label} epoch {g['epoch']}: {missing} not launched "
             f"({sum(g['txns_resolved'])} txns resolved): launches "
             f"{g['launches']}, entries {g['entries']}")


def cluster_run(run: str, engine: str, seed: int) -> dict:
    """Run ``run`` of phase 3n over ``engine``: ``"cuda"`` (the card
    engines and read plane, ``SimCluster``'s default), ``"cpu"`` (the
    engines' plain versions on the CPU) or ``"oracle"`` (the oracle); the
    last two, in worker processes beside phases 3m-4, read through the
    read plane's host arm. Returns the run's summary, the recoveries, each
    generation's ``Generations`` record (launches: cuda), whether every
    acknowledged write read back equal to the host replay, and the K12
    searches of the read-back."""
    import gc

    import torch

    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.client.ryw import open_database
    from foundationdb_tpu_torch.runtime.sequencer import EPOCH_VERSION_JUMP
    from foundationdb_tpu_torch.sim.cluster import SimCluster
    from foundationdb_tpu_torch.sim.cluster_load import ClusterLoad

    n_res, wave, n, kills = CLUSTER_RUNS[run]
    if engine != "cuda":
        torch.set_num_threads(1)  # beside the measured phases 3-3n
    c = SimCluster(seed=seed, engine="oracle" if engine == "oracle"
                   else "torch", device=None if engine == "cuda" else "cpu",
                   n_storages=2, n_replicas=2, n_tlogs=2, n_coordinators=3,
                   n_resolvers=n_res, wave_commit=wave)
    on_card = engine == "cuda"

    def probe() -> dict:
        if not on_card:
            return {}
        held = torch.cuda.memory_allocated()
        gc.collect()
        return {"memory_allocated": held,
                "memory_allocated_after_gc": torch.cuda.memory_allocated()}

    load = ClusterLoad(c, open_database(c), probe=probe,
                       kills={round(f * n): role for f, role in kills.items()})
    gens = Generations(c, on_card)
    memory0 = torch.cuda.memory_allocated() if on_card else None
    K.reset_launches()
    summary = load.run_ycsb(n, CLUSTER_CLIENTS, CLUSTER_KEY_BITS, seed=seed)
    gens.close()
    final = load.replay()
    got = load.read_back(sorted(final))
    firsts = load.epoch_firsts()
    d = np.asarray(load.dispatch_s) * 1e3
    return {
        "summary": summary, "recoveries": load.recoveries,
        "generations": gens.gens, "written_keys": len(final),
        "read_back_equal": got == final,
        "read_back_k12": K.ENTRY_LAUNCHES.get("wp_search", 0),
        "epochs_ok": all(
            firsts[e] is not None and firsts[e] >= rv + EPOCH_VERSION_JUMP
            for e, rv in load.generations[1:]),
        "epoch_firsts": firsts,
        "first_dispatches": {e: load.first_dispatches_ms(e)
                             for e in load.gen_dispatch_s},
        "dispatches": len(d),
        "dispatch_ms_p50": float(np.percentile(d, 50)) if len(d) else None,
        "dispatch_ms_p99": float(np.percentile(d, 99)) if len(d) else None,
        "memory_start": memory0,
        "memory_end": torch.cuda.memory_allocated() if on_card else None}


def settled(coro):
    """The value of a coroutine that never waits (a role's metrics RPC),
    taken without the loop: recruitment runs inside a loop task."""
    try:
        coro.send(None)
    except StopIteration as e:
        return e.value
    coro.close()
    raise RuntimeError("the coroutine waited")


def cluster_phase(seed: int, card: str) -> dict:
    """Phase 3n's card half: runs (a) and (b) over the card engines, each
    fatal on failure (epochs 1 -> 3 and 1 -> 2, each recovered epoch's
    first commit at least EPOCH_VERSION_JUMP past its recovery version, no
    transaction given up, every acknowledged write read back through
    ``tr.get_multi`` (K12) equal to the host replay, K1-K4 launched in
    each generation of (a), K5 and K6 and never K3 in each of (b), no
    fail-safe and no overflow); the CPU and oracle halves are checked
    after phase 4."""
    out = {}
    for run, (n_res, wave, n, kills) in CLUSTER_RUNS.items():
        t0 = time.perf_counter()
        r = cluster_run(run, "cuda", seed)
        wall = time.perf_counter() - t0
        s = r["summary"]
        label = f"cluster ({run})"
        want_epochs = list(range(1, len(kills) + 2))
        if s["epochs"] != want_epochs or not r["epochs_ok"]:
            fail(f"{label}: epochs {s['epochs']} (want {want_epochs}), "
                 f"firsts {r['epoch_firsts']}, recovery versions "
                 f"{s['recovery_versions']}")
        if s["failed"] or s["committed"] != n:
            fail(f"{label}: {s['failed']} transactions given up "
                 f"({s['error_codes']})")
        if not r["read_back_equal"] or not r["written_keys"]:
            fail(f"{label}: an acknowledged write did not read back through "
                 "tr.get_multi")
        if r["read_back_k12"] < 1:
            fail(f"{label}: the read-back launched no K12 search")
        if len(r["generations"]) != len(want_epochs):
            fail(f"{label}: {len(r['generations'])} generations recruited")
        for g in r["generations"]:
            if wave:
                check_generation(label, g, entries=("wv_pred", "wv_level",
                                                    "wp_search"))
                if g["launches"].get("accept", 0):
                    fail(f"{label} epoch {g['epoch']}: K3 launched on the "
                         f"wave path: {g['launches']}")
            else:
                check_generation(label, g, SEQ_SOURCES, ("wp_search",))
        print(json.dumps({
            "phase": "cluster", "run": run, "resolvers": n_res,
            "wave_commit": wave, "txns": n, "clients": CLUSTER_CLIENTS,
            "keys": 1 << CLUSTER_KEY_BITS, "wall_s": s["wall_s"],
            "run_and_checks_wall_s": wall,
            "commits_per_s": s["committed"] / s["wall_s"],
            "write_commits_per_s": s["write_commits"] / s["wall_s"],
            "committed_share": s["committed_share"],
            "retries": s["retries"], "error_codes": s["error_codes"],
            "virtual_s": s["virtual_s"], "epochs": s["epochs"],
            "recovery_versions": s["recovery_versions"],
            "epoch_firsts": r["epoch_firsts"],
            "recoveries": r["recoveries"],
            "first_dispatches": r["first_dispatches"],
            "dispatches": r["dispatches"],
            "dispatch_ms_p50": r["dispatch_ms_p50"],
            "dispatch_ms_p99": r["dispatch_ms_p99"],
            "memory_start": r["memory_start"],
            "memory_end": r["memory_end"],
            "launches_by_generation": [
                {"epoch": g["epoch"],
                 "launches": {k: v for k, v in g["launches"].items() if v},
                 "entries": g["entries"]} for g in r["generations"]],
            "read_back_keys": r["written_keys"],
            "read_back_k12": r["read_back_k12"],
            "cluster_outcomes_sha256": s["cluster_outcomes_sha256"],
            "card": card}))
        out[run] = r
    return out


def check_cluster(cl: dict, jobs: dict) -> None:
    """Phase 3n's CPU halves (workers beside phase 4): each run over the
    plain versions on the CPU and over the oracle gives the card's
    ``cluster_outcomes_sha256`` (every transaction's attempts, error
    codes and outcome, the epochs and their recovery versions) and reads
    every acknowledged write back."""
    for run, r in cl.items():
        s = r["summary"]
        cpu, orc = jobs[run]["cpu"].get(), jobs[run]["oracle"].get()
        for name, o in (("the cpu", cpu), ("the oracle", orc)):
            if o["summary"]["cluster_outcomes_sha256"] != \
                    s["cluster_outcomes_sha256"]:
                fail(f"cluster ({run}): cluster_outcomes_sha256 "
                     f"{s['cluster_outcomes_sha256']} on cuda, "
                     f"{o['summary']['cluster_outcomes_sha256']} over {name}")
            if not o["read_back_equal"]:
                fail(f"cluster ({run}): a write did not read back over "
                     f"{name}")
        print(json.dumps({
            "cross-check": f"cluster ({run})",
            "cluster_outcomes_sha256": {
                "cuda": s["cluster_outcomes_sha256"],
                "cpu": cpu["summary"]["cluster_outcomes_sha256"],
                "oracle": orc["summary"]["cluster_outcomes_sha256"]},
            "cpu_wall_s": cpu["summary"]["wall_s"],
            "oracle_wall_s": orc["summary"]["wall_s"]}))


# Phase 3o: the repository's TOML simulation specs through the port's
# runner (``sim/specs.py``, ``sim/workloads.py``, ``sim/run.py``).
#: The [[test]]s of tests/specs the port cannot run yet, each with the
#: module its NotImplementedError names.
SPEC_REFUSED = {
    "AuthzClean": "runtime/authz.py", "AuthzUnderFaults": "runtime/authz.py",
    "BackupRestoreClean": "runtime/backup.py",
    "BackupRestoreBuggify": "runtime/backup.py",
    "ChaosDDMoves": "runtime/data_distribution.py",
    "ConsistencyAuditReplicated": "consistency/checker.py",
    "DDBalance": "runtime/data_distribution.py",
    "AuthzAcrossRegionFailover": "runtime/authz.py",
    "TenantsClean": "client/tenant.py", "TenantsUnderFaults": "client/tenant.py",
    "ZipfRepairContention": "repair/engine.py",
    "ZipfNaiveBaseline": "repair/engine.py",
    "ZipfRepairMultiResolver": "repair/engine.py"}
#: Run (b): the fault knobs and cluster table of Chaos.toml's
#: ChaosMultiResolver, four workloads at once: mako's 90/10 mix, YCSB core
#: workload B (its reads through get_multi, K12), TPC-C new-order (ten
#: districts a warehouse) and Cycle.
SPEC_B = """
[[test]]
testTitle = 'ChaosAtScale'
killInterval = 0.7
partitionInterval = 0.9
maxKills = 3
killController = true
buggify = true
clogInterval = 0.06

[test.cluster]
tlogs = 3
storages = 3
replicas = 2
coordinators = 3
resolvers = 2
proxies = 2

[[test.workload]]
testName = 'Mako'
rows = %(mako_rows)d
transactionCount = %(mako_txns)d
clientCount = %(mako_clients)d
readsPerTransaction = 9
writesPerTransaction = 1

[[test.workload]]
testName = 'YCSB'
variant = 'B'
keyCount = %(ycsb_keys)d
transactionCount = %(ycsb_txns)d
clientCount = 64
batchSize = 8

[[test.workload]]
testName = 'TpccNewOrder'
warehouses = 4
districts = 10
items = %(tpcc_items)d
transactionCount = %(tpcc_txns)d
clientCount = 32

[[test.workload]]
testName = 'Cycle'
nodeCount = %(cycle_nodes)d
transactionCount = %(cycle_txns)d
clientCount = 32
"""
SPEC_B_SIZES = {"mako_rows": 16_384, "mako_txns": 1_024, "mako_clients": 64,
                "ycsb_keys": 2_048, "ycsb_txns": 1_024,
                "tpcc_items": 2_048, "tpcc_txns": 512,
                "cycle_nodes": 1_024, "cycle_txns": 512}
#: Run (b)'s cuts, each from the size here, found by rehearsing the run on
#: the CPU over the oracle given the engine's ranges (``engine_range_oracle``,
#: whose verdicts are the engine's). YCSB's keys and TPC-C's items: their
#: checks read every key (every stock item) with its own get in one
#: transaction, which at 4,096 outlasts the 5 virtual s MVCC window and
#: retries to the client's limit, so each was halved until it fits. The
#: transaction counts, a quarter each, for time: the resolvers dispatch
#: about 60 small batches a virtual second whatever the load (after a
#: recovery the new ratekeeper holds the clients to 100 txns/s and raises
#: the ceiling 5% a poll), about 10,000 dispatches at these counts and
#: 37,000 at the full ones, and the run over the plain versions on the CPU
#: takes about 40 ms of host time a dispatch, past the smoke's time limit
#: at the full counts. At larger counts the run meets a known fault of the
#: engine (ROADMAP Queue 3): its pack widens each of mako's 9 point reads
#: into 5 ranges, and a mako transaction can hit the client's 100-retry
#: limit; ``tests/test_torch_specs_scale.py`` runs the full counts and
#: holds that give-up.
SPEC_B_CUT_FROM = {"ycsb_keys": 16_384, "tpcc_items": 16_384,
                   "mako_txns": 4_096, "ycsb_txns": 4_096,
                   "tpcc_txns": 2_048, "cycle_txns": 2_048}


def engine_range_oracle(probe, widen: bool):
    """The oracle for phase 3o's oracle halves, counting into the probe's
    current test the transactions with more read or write ranges than the
    sim engine takes (its pack widens them to that many, conservatively:
    ``models/conflict_set._coalesce``). ``widen``: the oracle over the
    ranges the engine resolves, each such transaction's reads and writes
    coalesced as the engine's pack does; else the oracle on the exact
    ranges, as ``engine="oracle"`` builds it."""
    import dataclasses
    import inspect

    from foundationdb_tpu_torch.models.conflict_set import (
        TorchConflictSet,
        _coalesce,
    )
    from foundationdb_tpu_torch.sim.oracle import OracleConflictSet

    args = inspect.signature(TorchConflictSet.__init__).parameters
    r, q = (args["max_read_ranges"].default, args["max_write_ranges"].default)

    class EngineRanges(OracleConflictSet):
        def resolve(self, txns, commit_version, oldest_version=None):
            over = [t for t in txns if len(t.read_ranges) > r
                    or len(t.write_ranges) > q]
            if over and probe.cur:
                probe.cur["widened"] = probe.cur.get("widened", 0) + len(over)
            if widen:
                txns = [dataclasses.replace(
                    t, read_ranges=_coalesce(t.read_ranges, r),
                    write_ranges=_coalesce(t.write_ranges, q))
                    for t in txns]
            return super().resolve(txns, commit_version, oldest_version)

    return EngineRanges


def spec_b_text(div: int = 1, sizes: dict | None = None) -> str:
    """Run (b)'s TOML: ``SPEC_B_SIZES`` with ``sizes`` over them, each
    divided by ``div``."""
    return SPEC_B % {k: max(1, v // div)
                     for k, v in {**SPEC_B_SIZES, **(sizes or {})}.items()}


class SpecProbe:
    """Watches the port's simulation in this process for phase 3o and
    changes none of its events: every ``SimCluster`` built (each
    generation's epoch and recovery version, its launches and its
    resolvers' metrics; the kills with their virtual and wall times; the
    acknowledged commits; each resolver dispatch's wall time), each test's
    ``FaultInjector`` and result, and the retries by error code; each
    cluster's generations through ``Generations``."""

    def __init__(self, on_card: bool, oracle: str | None = None):
        self.on_card = on_card
        self.oracle = oracle
        self.tests: list[dict] = []
        self.retries: dict[int, int] = {}
        self.dispatch_s: list[float] = []
        self._undo: list = []
        self.cur: dict = {}

    def _patch(self, obj, name: str, value) -> None:
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def __enter__(self):
        from foundationdb_tpu_torch.client import transaction
        from foundationdb_tpu_torch.sim import cluster, specs

        probe = self

        class Probed(cluster.SimCluster):
            def __init__(self, *a, **kw):
                probe._begin()
                super().__init__(*a, **kw)
                probe._built(self)

        class Faults(specs.FaultInjector):
            def __init__(self, *a, **kw):
                super().__init__(*a, **kw)
                probe.cur["faults"] = self

        run_test = specs.run_spec_test

        async def run_spec_test(spec, c, db):
            probe.cur["workload_wall"] = {}
            for w in spec.workloads:
                probe._time_workload(w)
            try:
                r = await run_test(spec, c, db)
                probe.cur["result"] = r
                return r
            finally:
                probe._end()

        commit, on_error = (transaction.Transaction.commit,
                            transaction.Transaction.on_error)

        async def acked_commit(tr):
            read_only = tr.is_read_only
            v = await commit(tr)
            if not read_only and probe.cur:
                probe.cur["commits"].append(
                    (v, probe.cur["cluster"].loop.now, time.perf_counter()))
            return v

        async def counted_on_error(tr, e):
            code = getattr(e, "code", None)
            probe.retries[code] = probe.retries.get(code, 0) + 1
            return await on_error(tr, e)

        if self.oracle is not None:
            seam = cluster.new_conflict_set
            Oracle = engine_range_oracle(self, self.oracle == "oracle")

            def new_conflict_set(engine, wave_commit=None, device=None):
                if engine != "oracle":
                    return seam(engine, wave_commit, device)
                return Oracle(wave_commit=bool(wave_commit))

            self._patch(cluster, "new_conflict_set", new_conflict_set)
        self._patch(cluster, "SimCluster", Probed)
        self._patch(specs, "FaultInjector", Faults)
        self._patch(specs, "run_spec_test", run_spec_test)
        self._patch(transaction.Transaction, "commit", acked_commit)
        self._patch(transaction.Transaction, "on_error", counted_on_error)
        return self

    def __exit__(self, *exc):
        for obj, name, value in reversed(self._undo):
            setattr(obj, name, value)
        self._undo.clear()
        return False

    # -- one test ------------------------------------------------------------

    def _begin(self) -> None:
        from foundationdb_tpu_torch import kernels as K

        self.cur = {"kills": [], "commits": [], "faults": None,
                    "result": None, "t0": time.perf_counter()}
        K.reset_launches()

    def _built(self, c) -> None:
        from foundationdb_tpu_torch.sim.commit_path import time_dispatches

        def time_all(resolvers) -> None:
            for r in resolvers:
                time_dispatches(r, self.dispatch_s)

        self.cur["cluster"] = c
        self.cur["watch"] = Generations(c, self.on_card, time_all)
        self.cur["gens"] = self.cur["watch"].gens
        kill = c.net.kill

        def timed_kill(victim):
            self.cur["kills"].append({
                "victim": victim, "epoch": c.controller.generation.epoch,
                "virtual": c.loop.now, "wall": time.perf_counter()})
            return kill(victim)

        c.net.kill = timed_kill

    def _time_workload(self, w) -> None:
        run = w.run

        async def timed(db, cluster):
            await run(db, cluster)
            self.cur["workload_wall"][w.name] = (
                time.perf_counter() - self.cur["t0"],
                w.metrics.txns_committed)

        w.run = timed

    def _end(self) -> None:
        if "watch" in self.cur:
            self.cur["watch"].close()
        self.cur["wall"] = time.perf_counter() - self.cur["t0"]
        self.tests.append(self.cur)
        self.cur = {}


def spec_record(title: str, ok: bool, detail: str, t: dict | None) -> dict:
    """What ``spec_outcomes_sha256`` covers of one test: its title and
    verdict, each workload's metrics, the kills, partitions and clogs, the
    epochs and their recovery versions, every storage server's key-value
    pairs at its last version, and the loop's clock."""
    if t is None:
        return {"title": title, "ok": ok, "refused": detail}
    c, f, r = t["cluster"], t["faults"], t["result"]
    stores = []
    for s in c.storages:
        h = hashlib.sha256()
        for k in s.map._keys:
            v = s.map.at(k, s._version)
            if v is not None:
                h.update(len(k).to_bytes(4, "little") + k
                         + len(v).to_bytes(4, "little") + v)
        stores.append([s._version, h.hexdigest()])
    return {
        "title": title, "ok": ok, "detail": detail if ok else "failed",
        "metrics": None if r is None else {
            n: [m.txns_committed, m.txns_retried, m.txns_failed, m.ops,
                m.extra] for n, m in r.metrics.items()},
        "kills": list(f.kills) if f else [],
        "partitions": f.partitions if f else 0,
        "clogs": f.clogs if f else 0,
        "generations": [[g["epoch"], g["recovery_version"]]
                        for g in t["gens"]],
        "storages": stores, "now": c.loop.now}


def spec_recoveries(t: dict) -> list[dict]:
    """Each kill with the virtual and wall s to the first acknowledged
    commit of the first epoch recruited after it."""
    out = []
    for k in t["kills"]:
        later = [g for g in t["gens"] if g["virtual"] >= k["virtual"]
                 and g["epoch"] > k["epoch"]]
        row = {"victim": k["victim"], "epoch": k["epoch"],
               "kill_virtual": k["virtual"], "new_epoch": None}
        if later:
            g = later[0]
            first = next((x for x in t["commits"]
                          if x[0] > g["recovery_version"]), None)
            row["new_epoch"] = g["epoch"]
            if first is not None:
                row.update(to_first_commit_virtual_s=first[1] - k["virtual"],
                           to_first_commit_wall_s=first[2] - k["wall"])
        out.append(row)
    return out


def specs_run(run: str, engine: str, seed: int, files=None,
              div: int = 1, sizes: dict | None = None) -> dict:
    """Run ``run`` of phase 3o over ``engine``: ``"cuda"`` (``SimCluster``'s
    defaults: the card engines and read plane), ``"cpu"`` (the plain
    versions), ``"oracle"`` (the oracle over the ranges the engine
    resolves, ``engine_range_oracle``) or ``"oracle-exact"`` (the oracle
    on each transaction's own ranges); all but the first read through the
    read plane's host arm. (a) every [[test]] of ``files`` (default every
    file of tests/specs) through the port's ``sim.run.run_one``; (b) run
    (b)'s spec (``spec_b_text(div, sizes)``) on a fresh cluster as
    ``run_one`` builds it. Returns each test's record and
    ``spec_outcomes_sha256`` over them, and what the card half checks and
    prints."""
    import os

    import torch

    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.client.ryw import open_database
    from foundationdb_tpu_torch.sim import cluster, specs
    from foundationdb_tpu_torch.sim.run import run_one

    on_card = engine == "cuda"
    if not on_card:
        torch.set_num_threads(1)  # beside the measured phases
    kw = {} if on_card else {"engine": "torch" if engine == "cpu"
                             else "oracle", "device": "cpu"}
    memory0 = torch.cuda.memory_allocated() if on_card else None
    K.reset_launches()
    outcomes = []
    t0 = time.perf_counter()
    with SpecProbe(on_card, engine if "oracle" in engine else None) as probe:
        if run == "a":
            spec_dir = os.path.join(os.path.dirname(os.path.abspath(
                __file__)), "tests", "specs")
            for f in files or sorted(x for x in os.listdir(spec_dir)
                                     if x.endswith(".toml")):
                _, _, out = run_one(os.path.join(spec_dir, f), seed,
                                    False, None, **kw)
                outcomes += out
        else:
            (spec,) = specs.load_spec(spec_b_text(div, sizes))
            c = cluster.SimCluster(seed=seed,
                                   **{**kw, **specs.cluster_kwargs(spec)})
            try:
                r = c.loop.run(specs.run_spec_test(spec, c, open_database(c)),
                               timeout=3000)
                outcomes.append((spec.title, True, ", ".join(
                    f"{n}={m.txns_committed}tx"
                    for n, m in r.metrics.items())))
            except Exception as e:
                outcomes.append((spec.title, False,
                                 f"{type(e).__name__}: {e}"))
                print(f"specs (b) {engine}: {type(e).__name__}: {e}",
                      file=sys.stderr)
    wall = time.perf_counter() - t0
    ran = iter(probe.tests)
    records, tests = [], []
    for title, ok, detail in outcomes:
        t = None if detail.startswith("NotImplementedError") else next(ran)
        records.append(spec_record(title, ok, detail, t))
        tests.append(t)
    d = np.asarray(probe.dispatch_s) * 1e3
    launches: dict[str, int] = {}
    for t in tests:
        for g in (t or {}).get("gens", []):
            for k, v in {**g["launches"], **g["entries"]}.items():
                launches[k] = launches.get(k, 0) + v
    return {
        "run": run, "engine": engine, "wall_s": wall,
        "records": records,
        "spec_outcomes_sha256": hashlib.sha256(json.dumps(
            records, sort_keys=True, default=repr).encode()).hexdigest(),
        "tests": [None if t is None else {
            "wall_s": t["wall"], "workload_wall": t["workload_wall"],
            "generations": [{k: v for k, v in g.items()
                             if k not in ("virtual", "wall")}
                            for g in t["gens"]],
            "recoveries": spec_recoveries(t),
            "widened_txns": t.get("widened", 0)} for t in tests],
        "retries": {str(k): v for k, v in sorted(probe.retries.items(),
                                                 key=lambda x: str(x[0]))},
        "dispatches": len(d),
        "dispatch_ms_p50": float(np.percentile(d, 50)) if len(d) else None,
        "dispatch_ms_p99": float(np.percentile(d, 99)) if len(d) else None,
        "launches": launches, "memory_start": memory0,
        "memory_end": torch.cuda.memory_allocated() if on_card else None}


def check_spec_run(label: str, r: dict) -> None:
    """Phase 3o's checks of one run on the card, each fatal: every ported
    test passed its workloads' checks; every other test raised
    NotImplementedError naming its module; no transaction given up; no
    fail-safe or overflow; K1-K4 in every generation whose resolvers
    resolved a transaction."""
    for rec, t in zip(r["records"], r["tests"]):
        title = rec["title"]
        if t is None:
            want = SPEC_REFUSED.get(title)
            if want is None or want not in rec["refused"]:
                fail(f"specs ({label}) {title}: refused ({rec['refused']}), "
                     f"want it to run or to name {want}")
            continue
        if title in SPEC_REFUSED:
            fail(f"specs ({label}) {title}: ran, but the port lacks "
                 f"{SPEC_REFUSED[title]}")
        if not rec["ok"] or not rec["metrics"]:
            fail(f"specs ({label}) {title}: a workload's check failed: "
                 f"{rec['detail']}")
        for name, m in rec["metrics"].items():
            if m[2] or not m[0]:
                fail(f"specs ({label}) {title}/{name}: {m[2]} transactions "
                     f"given up, {m[0]} committed")
        for g in t["generations"]:
            check_generation(f"specs ({label}) {title}", g,
                             SEQ_SOURCES if sum(g["txns_resolved"]) else ())


def specs_phase(seed: int, card: str) -> dict:
    """Phase 3o's card half: run (a), every [[test]] of tests/specs through
    the port's ``run_one``, and run (b), each fatal on failure (the checks
    of ``check_spec_run``; in (b) at least one kill and a recovery to a
    higher epoch after it, and K12 by the read plane); the CPU and oracle
    halves are checked after phase 4."""
    out = {}
    for run in ("a", "b"):
        r = specs_run(run, "cuda", seed)
        check_spec_run(run, r)
        label = f"specs ({run})"
        if run == "b":
            (t,) = r["tests"]
            kills = t["recoveries"]
            if not kills or not any(k["new_epoch"] for k in kills):
                fail(f"{label}: no kill, or no recovery after one: {kills}")
            if r["launches"].get("wp_search", 0) <= 0:
                fail(f"{label}: the read plane launched no K12 search")
        ran = [(rec, t) for rec, t in zip(r["records"], r["tests"])
               if t is not None]
        print(json.dumps({
            "phase": "specs", "run": run, "seed": seed,
            "tests": len(ran), "refused": {
                rec["title"]: rec["refused"] for rec, t in
                zip(r["records"], r["tests"]) if t is None},
            "wall_s": r["wall_s"],
            "committed": sum(m[0] for rec, _ in ran
                             for m in rec["metrics"].values()),
            "committed_per_s": sum(m[0] for rec, _ in ran for m in
                                   rec["metrics"].values()) / r["wall_s"],
            "per_test": [{
                "title": rec["title"], "wall_s": t["wall_s"],
                "workloads": {n: {"committed": rec["metrics"][n][0],
                                  "retried": rec["metrics"][n][1],
                                  "ops": rec["metrics"][n][3],
                                  "wall_s": w,
                                  "committed_per_s": n_c / w}
                              for n, (w, n_c) in t["workload_wall"].items()},
                "kills": rec["kills"], "partitions": rec["partitions"],
                "clogs": rec["clogs"], "epochs": rec["generations"],
                "recoveries": t["recoveries"], "virtual_s": rec["now"]}
                for rec, t in ran],
            "retries_by_code": r["retries"],
            "dispatches": r["dispatches"],
            "dispatch_ms_p50": r["dispatch_ms_p50"],
            "dispatch_ms_p99": r["dispatch_ms_p99"],
            "launches": {k: v for k, v in r["launches"].items() if v},
            "memory_start": r["memory_start"], "memory_end": r["memory_end"],
            "spec_outcomes_sha256": r["spec_outcomes_sha256"],
            "card": card}))
        out[run] = r
    return out


def check_specs(sp: dict, jobs: dict) -> None:
    """Phase 3o's CPU halves (workers beside phases 3m-4, (b)'s on the CPU
    beside phases 3-4): each run over the plain versions on the CPU and
    over the oracle given the engine's ranges gives the card's
    ``spec_outcomes_sha256``; over the oracle on the exact ranges, every
    test none of whose transactions the engine widened gives the card's
    record (the others are printed with their widened count)."""
    for run, r in sp.items():
        got, walls = {"cuda": r["spec_outcomes_sha256"]}, {}
        for e in ("cpu", "oracle", "oracle-exact"):
            o = jobs[run][e].get()
            got[e], walls[f"{e}_wall_s"] = (o["spec_outcomes_sha256"],
                                            o["wall_s"])
            diff = [x["title"] for x, y in zip(r["records"], o["records"])
                    if x != y]
            if e == "oracle-exact":
                widened = {x["title"]: t["widened_txns"] for x, t in
                           zip(o["records"], o["tests"])
                           if t is not None and t["widened_txns"]}
                if set(diff) - set(widened):
                    fail(f"specs ({run}): over the exact oracle tests "
                         f"{sorted(set(diff) - set(widened))} differ from "
                         "the card's, none of their transactions widened")
                walls["exact_oracle_differs"] = diff
                walls["widened_txns"] = widened
            elif got[e] != got["cuda"]:
                fail(f"specs ({run}): spec_outcomes_sha256 {got['cuda']} on "
                     f"cuda, {got[e]} over the {e}; tests differing: {diff}")
        print(json.dumps({"cross-check": f"specs ({run})",
                          "spec_outcomes_sha256": got, **walls}))


def bench_engine(mode, wave: bool, engine: dict):
    from foundationdb_tpu_torch.bench import make_engine as make

    return make(mode, CAP, "cuda", wave, **engine)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batches", type=int, default=128)
    args = ap.parse_args()
    # A crash in native code (a kernel library, the CUDA runtime) prints
    # every thread's Python stack before the process dies.
    faulthandler.enable()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA card available", file=sys.stderr)
        return 2
    try:
        import foundationdb_tpu_torch.bench  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the repository is missing ({e})", file=sys.stderr)
        return 2

    # The host replay of check (c) of phase 3c and 3o(b)'s run over the
    # plain versions (beside phases 3-4), the CPU runs of checks (c) and
    # (c′) of phase 3d, the CPU half of check (e) of phases 3e and 3h, of
    # the tiered run of 3f, of the adversary of 3g and the CPU and oracle
    # runs of 3m, 3n and 3o (beside phases 3m-4) run in six worker
    # processes; the workers are stopped however the run ends.
    pool = multiprocessing.get_context("spawn").Pool(6)
    try:
        return smoke(args, pool)
    finally:
        pool.terminate()
        pool.join()


def smoke(args, pool) -> int:
    import torch

    from foundationdb_tpu_torch import kernels as K
    from foundationdb_tpu_torch.bench import card_line
    from foundationdb_tpu_torch.loadgen.ycsb import MODES, gen_workload

    phase_s: dict[str, float] = {}
    t_phase = time.perf_counter()

    def lap(label: str) -> None:
        nonlocal t_phase
        now = time.perf_counter()
        phase_s[label] = now - t_phase
        t_phase = now

    # 1. Device.
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"device: {name} | nvidia-smi: {card}")
    t0 = time.perf_counter()
    K.ensure_built()
    print(f"kernel build: {time.perf_counter() - t0:.3f} s")

    ycsb = MODES["ycsb"]
    stream = gen_workload(args.batches * ycsb.batch, N_KEYS, args.seed, ycsb)

    lap("1 device")

    # 2. Per kernel.
    kp = kernel_phase(stream, ycsb)
    wk = wave_kernel_phase(stream, ycsb, pool)
    k12_k5_adversarial()
    lap("2 kernels")

    # Phase 3o(b)'s run over the plain versions on the CPU, the longest of
    # the CPU halves (minutes), starts here in a worker (one torch thread)
    # beside phases 3-4; until the end of 3l only it and 3c's host replays
    # run beside the card, so that phases 3-3l are not timed beside six
    # busy workers.
    cpu_specs = {"b": {"cpu": pool.apply_async(specs_run,
                                               ("b", "cpu", args.seed))}}

    # 3. End to end, counting launches of this run only.
    K.reset_launches()
    t0 = time.perf_counter()
    verdicts, lat, cs = run_stream(stream, ycsb, args.batches, "cuda",
                                   "ycsb cuda")
    wall = time.perf_counter() - t0
    launches = dict(K.LAUNCHES)
    entry_launches = dict(K.ENTRY_LAUNCHES)
    if cs.overflowed:
        fail("history overflowed on the YCSB-A stream")
    if entry_launches.get("sc_fold_step", 0) <= 0:
        fail("K4's gated fold step was not launched on the main path")
    for k in SEQ_SOURCES:
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched on the main path")
    if launches["wave"]:
        fail("K5/K6 were launched on the sequential-order path")
    counts = np.bincount(verdicts, minlength=3)
    n_txns = len(verdicts)
    object_sha = hashlib.sha256(verdicts.tobytes()).hexdigest()
    print(json.dumps({
        "stream": "ycsb-a", "txns": n_txns, "batches": args.batches,
        "txns_per_s": n_txns / wall,
        "batch_ms_p50": float(np.percentile(lat, 50)),
        "batch_ms_p99": float(np.percentile(lat, 99)),
        "committed": int(counts[0]), "conflict": int(counts[1]),
        "too_old": int(counts[2]),
        "verdicts_sha256": object_sha,
        "host_syncs_per_batch": cs.host_syncs / args.batches,
        "launches_per_batch": {k: launches[k] / args.batches
                               for k in SEQ_SOURCES},
        "dict_stats": cs.dict_stats, "card": card}))

    lap("3 object path")

    # 3b. The window path, counted on its own, and its cross-checks.
    blob, ends, n_wire = wire_stream(stream, ycsb, args.batches)
    wp = window_phase(blob, ends, ycsb, n_wire, args.seed, card, object_sha)

    lap("3b window path")

    # 3c. The wave-commit engine on the window path, and its checks.
    wv = wave_phase(blob, ends, ycsb, n_wire, args.seed, card, stream,
                    wp["record"], wk, pool)
    lap("3c wave path")

    # 3d. The tiered speculative engine on the window path, and its checks.
    td = tiered_phase(args, card)
    lap("3d tiered path")

    # 3e. The sharded engine on the window path, and its checks.
    sh = sharded_phase(blob, ends, ycsb, n_wire, stream, args.seed, card,
                       wp["record"], wv)
    lap("3e sharded path")

    # 3f. The admission filter on the resident engine, and its checks.
    ad = admission_phase(stream, ycsb, verdicts, args.seed, card)
    lap("3f admission")

    # 3g. The packed non-resident engine on the window path, and its checks.
    nr = nonresident_phase(blob, ends, ycsb, n_wire, args.seed, card,
                           wp["record"], wv)
    lap("3g non-resident path")

    # 3h. The non-resident sharded engine on the window path, and its
    # checks.
    nrs = nr_sharded_phase(blob, ends, ycsb, n_wire, stream, args.seed, card,
                           wp["record"], wv)
    lap("3h non-resident sharded path")

    # 3i. The design arms on the window path, and their checks.
    k17 = design_phase(blob, ends, ycsb, n_wire, stream, args.seed, card,
                       wp["record"], wv)
    lap("3i design arms")

    # 3j. The read plane: coalesced reads, watches, K12's searches.
    rp = read_plane_phase(args.seed, card)
    lap("3j read plane")

    # 3k. The sharded engines' design arms on the window path.
    sa = sharded_arms_phase(blob, ends, ycsb, n_wire, stream, card,
                            wp["record"], wv)
    lap("3k sharded arms")

    # 3l. The north-star baseline: the CPU SkipList engine on this host
    # (before the workers of phase 4 start).
    baseline_phase(stream, ycsb, n_wire, wp["record"], card)
    lap("3l baseline")

    # Phase 3m over the CPU and the oracle, checks (c) and (c′) of phase
    # 3d, check (e) of phase 3e, the tiered run of 3f, the adversary of 3g
    # on the CPU, and 3n's and 3o's other CPU and oracle runs, in the
    # workers beside phases 3m-4.
    cpu_commit = {run: {e: pool.apply_async(commit_path_run,
                                            (run, e, args.seed))
                        for e in ("cpu", "oracle")}
                  for run in COMMIT_RUNS}
    cpu_spec = {wave: pool.apply_async(spec_run, (args.seed, "cpu", 3, wave))
                for wave in (False, True)}
    cpu_tier_spec = {wave: pool.apply_async(
        spec_run, (args.seed, "cpu", 3, wave, True, td["spec_tier"]))
        for wave in (False, True)}
    cpu_sharded = pool.apply_async(sharded_window0,
                                   (args.seed, args.batches, "cpu"))
    cpu_tiered_adm = pool.apply_async(tiered_admission_run,
                                      (args.seed, "cpu"))
    cpu_nr_spec = {False: pool.apply_async(
        spec_run, (args.seed, "cpu", 3, False, False))}
    cpu_nr_sharded = pool.apply_async(sharded_window0,
                                      (args.seed, args.batches, "cpu", False))
    cpu_cluster = {run: {e: pool.apply_async(cluster_run,
                                             (run, e, args.seed))
                         for e in ("cpu", "oracle")}
                   for run in CLUSTER_RUNS}
    for run in ("a", "b"):
        for e in ("cpu", "oracle", "oracle-exact"):
            if e not in cpu_specs.setdefault(run, {}):
                cpu_specs[run][e] = pool.apply_async(specs_run,
                                                     (run, e, args.seed))

    # 3m. The commit path's roles on one loop over the card engine.
    cm = commit_path_phase(args.seed, card)
    lap("3m commit path")

    # 3n. One simulated cluster with its control plane and client, the
    # engines recruited on the card at every recovery.
    cl = cluster_phase(args.seed, card)
    lap("3n cluster")

    # 3o. The repository's simulation specs and one at scale through the
    # port's runner, under kills, partitions, clogs and BUGGIFY.
    sp = specs_phase(args.seed, card)
    lap("3o specs")

    # 4. Cross-checks against the plain versions on the CPU.
    n_cross = min(16, args.batches)
    cpu_v, _, _ = run_stream(stream, ycsb, n_cross, "cpu", "ycsb cpu")
    if not np.array_equal(cpu_v, verdicts[: len(cpu_v)]):
        fail("ycsb: cuda and cpu verdicts differ")
    print(f"cross-check ycsb: {len(cpu_v)} txns equal on cuda and cpu")
    for mname in ("mako", "tpcc"):
        mode = MODES[mname]
        s = gen_workload(n_cross * mode.batch, N_KEYS, args.seed, mode)
        gv, _, gcs = run_stream(s, mode, n_cross, "cuda", f"{mname} cuda")
        cvv, _, _ = run_stream(s, mode, n_cross, "cpu", f"{mname} cpu")
        if not np.array_equal(gv, cvv) or gcs.overflowed:
            fail(f"{mname}: cuda and cpu verdicts differ")
        c = np.bincount(gv, minlength=3)
        print(f"cross-check {mname}: {len(gv)} txns equal on cuda and cpu "
              f"(committed {c[0]}, conflict {c[1]}, too_old {c[2]})")

    check_replay(wk)
    check_big_replay(wv["big"])
    check_spec_cpu(td, cpu_spec)
    check_spec_cpu(td, cpu_tier_spec, " across demotions", "spec_tier_cuda")
    check_sharded_cpu(sh, cpu_sharded)
    check_tiered_admission(ad, cpu_tiered_adm)
    check_spec_cpu(nr, cpu_nr_spec, " non-resident")
    check_sharded_cpu(nrs, cpu_nr_sharded, "non-resident sharded")
    check_commit_path(cm, cpu_commit)
    check_cluster(cl, cpu_cluster)
    check_specs(sp, cpu_specs)
    lap("4 cross-checks")
    print(json.dumps({"phase_seconds": phase_s}))

    # 5. The kernels line, the card line, the result line.
    rows = []
    for k in SEQ_SOURCES:
        ms, plain = kp["timings"][k]
        lo, by = bound(*kp["bounds"][k])
        rows.append({
            "name": k, "route": "cuda",
            "source": f"foundationdb_tpu_torch/kernels/csrc/{k}.cu",
            "replaces": REPLACES[k], "launches": launches[k],
            "max_abs_err": MAX_ABS_ERR[k], "ms": ms, "plain_ms": plain,
            "bound_ms": lo, "bound_by": by,
            "library_ms": None})
    rows[2].update(kp["accept_more"])
    rows[1].update(kp["table_more"])
    rows[0].update(kp["k1_parts"])
    rows[3].update(gated_needed_ms=kp["fold"]["gated_needed"][0],
                   gated_needed_plain_ms=kp["fold"]["gated_needed"][1])
    # K4's fold rows: the gated step of every batch (the decision, the
    # gated fold with its reset, K2's gated table; timed when the fold is
    # not needed, as on most steps) and the forced fold of advance_hist.
    for k, (ms, plain), (lo, by), n_l, where in (
            ("step_compact_gated_fold", *kp["fold"]["gated"],
             entry_launches.get("sc_fold_step", 0), "1290"),
            ("step_compact_fold_forced", *kp["fold"]["forced"],
             entry_launches.get("sc_fold", 0), "1404")):
        rows.append({
            "name": k, "route": "cuda",
            "source": "foundationdb_tpu_torch/kernels/csrc/step_compact.cu",
            "replaces": f"foundationdb_tpu/models/conflict_kernel.py:{where}",
            "launches": n_l, "max_abs_err": MAX_ABS_ERR["step_compact"],
            "ms": ms, "plain_ms": plain, "bound_ms": lo, "bound_by": by,
            "library_ms": None})
    rows[-2]["in_place_ms"] = kp["fold"]["gated_in_place_ms"]
    # The window program's bound: K1 once plus k steps of K2, K3, K4's
    # gated fold step and its paint, each at the per-batch bound above;
    # bound by what most of it is.
    share = {"bytes": 0.0, "operations": 0.0}
    for r in rows:
        if r["name"] != "step_compact_fold_forced":
            share[r["bound_by"]] += r["bound_ms"] * (
                1 if r["name"] == "dict_insert" else wp["k"])
    rows.append({
        "name": "resolve_many", "route": "cuda",
        "source": "foundationdb_tpu_torch/models/conflict_kernel.py",
        "replaces": REPLACES["resolve_many"], "launches": wp["launches"],
        "max_abs_err": MAX_ABS_ERR["resolve_many"], "ms": wp["ms"],
        "plain_ms": wp["plain_ms"],
        "bound_ms": sum(share.values()),
        "bound_by": max(share, key=share.get), "library_ms": None})
    for k, entry in (("wave_pred", "wv_pred"), ("wave_level", "wv_level")):
        ms, plain = wk["timings"][k]
        lo, by = bound(*wk["bounds"][k])
        rows.append({
            "name": k, "route": "cuda",
            "source": "foundationdb_tpu_torch/kernels/csrc/wave.cu",
            "replaces": REPLACES[k], "launches": wv["launches"][entry],
            "max_abs_err": MAX_ABS_ERR[k], "ms": ms, "plain_ms": plain,
            "bound_ms": lo, "bound_by": by, "library_ms": None})
    for k, source in (
            ("dict_evict", "foundationdb_tpu_torch/kernels/csrc/dict_evict.cu"),
            ("paint_many", "foundationdb_tpu_torch/models/conflict_kernel.py")):
        r = td[k]
        lo, by = r["bound"]
        rows.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": REPLACES[k], "launches": r["launches"],
            "max_abs_err": MAX_ABS_ERR[k], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": lo, "bound_by": by,
            "library_ms": None})
    # No one PyTorch call computes K7 (compaction, +inf padding and the
    # shift table); boolean-mask indexing is the compaction alone.
    rows[-2].update(partial_library_ms=td["dict_evict"]["partial_library_ms"],
                    partial_library_call="dict_keys[keep_mask]: the "
                                         "compaction only")
    # K8 is timed with the live table it builds (the shard_probe call; the
    # row also carries its build's and probe's device ms, its CUDA kernels
    # a call, the live rows, the table's bytes and its full-shard times);
    # K9's yardstick is one torch.clamp over the stacked write ranks with
    # per-shard bound tensors (no masks).
    for k, source in (
            ("shard_probe", "foundationdb_tpu_torch/kernels/csrc/shard.cu"),
            ("shard_clip", "foundationdb_tpu_torch/kernels/csrc/shard.cu"),
            ("wave_exchange", "foundationdb_tpu_torch/kernels/csrc/wave.cu"),
            ("sharded_many",
             "foundationdb_tpu_torch/models/conflict_kernel.py")):
        r = sh[k]
        lo, by = r["bound"]
        rows.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": REPLACES[k], "launches": r["launches"],
            "max_abs_err": MAX_ABS_ERR[k], "ms": r["timing"][0],
            "plain_ms": r["timing"][1], "bound_ms": lo, "bound_by": by,
            "library_ms": r.get("library_ms")})
    rows[-4].update({k: sh["shard_probe"][k] for k in LIVE_PROBE_KEYS})
    rows[-3].update(checked_entry_ms=sh["shard_clip"]["entry_ms"])
    # K10 is K5's OR mode: its launches are the OR-mode K5 launches of 3e(c)
    # (S a batch), its time one step's fused exchange.
    rows[-2].update(fused_into="K5's OR mode, wave.cu wv_pred_or",
                    launches_are="K5 OR-mode launches, S a batch")
    # K11 is timed by its set launch (the per-batch feed), with
    # ``index_fill_`` on bool banks (the same sets, 32x the bytes) as its
    # yardstick; no one PyTorch call searches word rows (K12), paints or
    # compacts a step function (K13) or runs the window program.
    lo, by = ad["bound"]
    rows.append({
        "name": "admission", "route": "cuda",
        "source": "foundationdb_tpu_torch/kernels/csrc/admission.cu",
        "replaces": REPLACES["admission"], "launches": ad["launches"],
        "max_abs_err": MAX_ABS_ERR["admission"], "ms": ad["ms"],
        "plain_ms": ad["plain_ms"], "bound_ms": lo, "bound_by": by,
        "library_ms": ad["library_ms"]})
    # K12's search, and its probe with the live table it builds; K13's
    # packed paint, its gated fold step (timed when the fold
    # is not needed, as on most steps; the needed step's ms beside it) and
    # its forced fold over a full base (C = 2^20, W = 4); the window
    # program. Each new row carries its CUDA kernels a call, counted at
    # launch.
    extra = {
        "word_probe_probe": ("cuda_kernels", "delta_live"),
        "word_compact": ("cuda_kernels", "whole_cd_bound_ms"),
        "word_compact_fold_step": ("cuda_kernels", "needed_ms",
                                   "needed_plain_ms"),
        "word_compact_fold_forced": ("step_history_ms", "base_rows"),
        "packed_many": ("cuda_kernels_per_step_outside_k3",),
    }
    for k, source in (
            ("word_probe", "foundationdb_tpu_torch/kernels/csrc/word_probe.cu"),
            ("word_probe_probe",
             "foundationdb_tpu_torch/kernels/csrc/word_probe.cu"),
            ("word_compact",
             "foundationdb_tpu_torch/kernels/csrc/word_compact.cu"),
            ("word_compact_fold_step",
             "foundationdb_tpu_torch/kernels/csrc/word_compact.cu"),
            ("word_compact_fold_forced",
             "foundationdb_tpu_torch/kernels/csrc/word_compact.cu"),
            ("packed_many",
             "foundationdb_tpu_torch/models/conflict_kernel.py")):
        r = nr[k]
        lo, by = r["bound"]
        rows.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": REPLACES[k], "launches": r["launches"],
            "max_abs_err": MAX_ABS_ERR[k], "ms": r["timing"][0],
            "plain_ms": r["timing"][1], "bound_ms": lo, "bound_by": by,
            "library_ms": None, **{x: r[x] for x in extra.get(k, ())}})
    # K14 has two rows: its rank launch on the unclipped endpoint rows (the
    # sequential path's use), with W stable torch.sort passes over the
    # same rows beside it (no one PyTorch call sorts W-word rows), and one
    # shard's paint sort (2BQ rows, 2 payloads); K16 with the live table it
    # builds (the keys K8's row has); K13's sorted paint on the fullest
    # shard.
    for k, source in (
            ("word_sort", "foundationdb_tpu_torch/kernels/csrc/word_sort.cu"),
            ("word_sort_paint",
             "foundationdb_tpu_torch/kernels/csrc/word_sort.cu"),
            ("word_clip", "foundationdb_tpu_torch/kernels/csrc/word_shard.cu"),
            ("word_shard_probe",
             "foundationdb_tpu_torch/kernels/csrc/word_shard.cu"),
            ("word_paint_sorted",
             "foundationdb_tpu_torch/kernels/csrc/word_compact.cu"),
            ("nr_sharded_many",
             "foundationdb_tpu_torch/models/conflict_kernel.py")):
        r = nrs[k]
        lo, by = r["bound"]
        rows.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": REPLACES[k], "launches": r["launches"],
            "max_abs_err": MAX_ABS_ERR[k], "ms": r["timing"][0],
            "plain_ms": r["timing"][1], "bound_ms": lo, "bound_by": by,
            "library_ms": None})
    rows[-6].update(torch_sort_passes_ms=nrs["word_sort"][
        "torch_sort_passes_ms"])
    rows[-5].update(rows_sorted=nrs["word_sort_paint"]["rows"])
    rows[-3].update({k: nrs["word_shard_probe"][k]
                     for k in LIVE_PROBE_KEYS})
    rows[-2].update({k: nrs["word_paint_sorted"][k] for k in (
        "whole_paint_ms", "whole_c_bound_ms", "c18_ms", "live_rows")})
    rows[-4].update(checked_entry_ms=nrs["word_clip"]["entry_ms"],
                    device_ms=nrs["word_clip"]["device_ms"],
                    cuda_kernels=nrs["word_clip"]["cuda_kernels"])
    # K17 is timed by the flat blocked arm's per-step work at C = 2^20: its
    # live build and its probe of the captured step's slot bounds, beside
    # the parent design's build over all rows + query; its yardstick is
    # one torch.cummax over the live block rows, the prefix scan alone (no
    # one PyTorch call computes the structure or its queries).
    lo, by = k17["bound"]
    rows.append({
        "name": "rmq_blocked", "route": "cuda",
        "source": "foundationdb_tpu_torch/kernels/csrc/rmq_blocked.cu",
        "replaces": REPLACES["rmq_blocked"], "launches": k17["launches"],
        "max_abs_err": MAX_ABS_ERR["rmq_blocked"], "ms": k17["ms"],
        "plain_ms": k17["plain_ms"], "bound_ms": lo, "bound_by": by,
        "library_ms": k17["library_ms"],
        "library_call": "torch.cummax(live block rows, 1): the prefix scan "
                        "only",
        **{k: k17[k] for k in ("device_ms", "cuda_kernels", "live_build_ms",
                               "build_query_ms", "probe_ms", "live")}})
    # Each design arm's window program (k = WINDOW_K), as the window
    # programs above: a launch sequence with no source of its own.
    for arm, r in k17["programs"].items():
        lo, by = r["bound"]
        rows.append({
            "name": f"design_{arm}", "route": "cuda",
            "source": "foundationdb_tpu_torch/models/conflict_kernel.py",
            "replaces": "foundationdb_tpu/models/conflict_kernel.py:"
                        f"{ARM_REPLACES[arm]}",
            "launches": r["launches"],
            "max_abs_err": MAX_ABS_ERR[f"design_{arm}"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": lo, "bound_by": by,
            "library_ms": None})
    # K12's read-plane search (3j), timed on one dispatch's query rows
    # against the 2^20-row mirror; no one PyTorch call searches W-word rows.
    lo, by = rp["bound"]
    rows.append({
        "name": "word_search_reads", "route": "cuda",
        "source": "foundationdb_tpu_torch/kernels/csrc/word_probe.cu",
        "replaces": "foundationdb_tpu/reads/read_set.py:102",
        "launches": rp["launches"],
        "max_abs_err": MAX_ABS_ERR["word_search_reads"], "ms": rp["ms"],
        "plain_ms": rp["plain_ms"], "bound_ms": lo, "bound_by": by,
        "library_ms": None, "queries": rp["queries"],
        "rows_needed": rp["rows_needed"]})
    # K12 at W = 1 (3i): the flat blocked arm's rank search of a step's
    # slot begin and end ranks, beside torch.searchsorted left and right of
    # the same ranks in the flattened rank keys.
    w1 = k17["w1"]
    lo, by = w1["bound"]
    rows.append({
        "name": "word_search_w1", "route": "cuda",
        "source": "foundationdb_tpu_torch/kernels/csrc/word_probe.cu",
        "replaces": "foundationdb_tpu/models/conflict_kernel.py:2129",
        "launches": w1["launches"],
        "max_abs_err": MAX_ABS_ERR["word_search_w1"], "ms": w1["ms"],
        "plain_ms": w1["plain_ms"], "bound_ms": lo, "bound_by": by,
        "library_ms": w1["library_ms"],
        "library_call": "torch.searchsorted(keys, q, side=left and right), "
                        "begin and end ranks",
        "queries": w1["queries"], "rows_needed": w1["rows_needed"]})
    # K17's sharded probes (3k), each timed with its build over the
    # shards' live rows, then each sharded arm's window program.
    for k, r in sa["probes"].items():
        lo, by = r["bound"]
        rows.append({
            "name": k, "route": "cuda",
            "source": "foundationdb_tpu_torch/kernels/csrc/rmq_blocked.cu",
            "replaces": r["replaces"], "launches": r["launches"],
            "max_abs_err": MAX_ABS_ERR[k], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": lo, "bound_by": by,
            "library_ms": None, "sparse_arm_ms": r["sparse_ms"],
            **{x: r[x] for x in (
                "build_ms", "probe_only_ms", "device_ms", "cuda_kernels",
                "kernels_counted", "live_rows", "full_shard_ms",
                "full_shard_device_ms")}})
    for arm, r in sa["programs"].items():
        lo, by = r["bound"]
        rows.append({
            "name": f"design_{arm}", "route": "cuda",
            "source": "foundationdb_tpu_torch/models/conflict_kernel.py",
            "replaces": SHARD_ARM_REPLACES[arm], "launches": r["launches"],
            "max_abs_err": MAX_ABS_ERR[f"design_{arm}"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": lo, "bound_by": by,
            "library_ms": None})
    print(json.dumps({"kernels": rows}))
    print(f"card: {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
