"""YCSB-A / mako / TPC-C shaped resolver streams (numpy only).

A copy of the workload part of the repository's ``bench.py``: the run
configurations, the scrambled bounded Zipf sampler and the shifting
hotspot, the stream generator and its version bookkeeping (one commit
version per batch, MVCC window WINDOW versions, read versions lagging by
at most MAX_LAG), plus the per-batch ``TxnConflictInfo`` lists
(``build_txns``), the wire-blob assembler of the resolve stream
(``build_wire_stream``) and the dictionary counts a tiered engine is
sized by (``dictionary_counts``).
Keys are 8-byte big-endian ids; a point range is [key, key + b"\\x00").
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from foundationdb_tpu_torch.core.types import KeyRange, TxnConflictInfo

BATCH = 8192
WINDOW = 64  # MVCC window in commit versions (batches)
MAX_LAG = 8  # read-version staleness in versions (<< WINDOW: no TOO_OLD)
KEY_BYTES = 12  # codec width: 8-byte keys + point-range end fits exactly


@dataclass(frozen=True)
class ModeConfig:
    """One benchmark configuration (reference: mako run configs)."""

    n_reads: int  # point reads per txn
    n_writes: int  # point writes per txn (all-or-none via write_frac)
    write_frac: float
    theta: float  # Zipf skew (0 = uniform)
    batch: int


MODES = {
    # YCSB-A hot-key contention: 2 reads + 50% single write, Zipf 0.99.
    "ycsb": ModeConfig(2, 1, 0.5, 0.99, BATCH),
    # mako 90/10 op mix: 9 reads + 1 write every txn.
    "mako": ModeConfig(9, 1, 1.0, 0.99, 4096),
    # TPC-C new-order shape: wide txns (12 reads, 8 writes), uniform items.
    "tpcc": ModeConfig(12, 8, 1.0, 0.0, 2048),
}


def zipf_sampler(rng: np.random.Generator, n_keys: int, theta: float = 0.99):
    """Bounded scrambled Zipf: rank r picked with p ∝ (r+1)^-theta, then
    mapped through a fixed permutation (YCSB's ScrambledZipfianGenerator)."""
    w = (np.arange(1, n_keys + 1, dtype=np.float64)) ** (-theta)
    cdf = np.cumsum(w / w.sum())
    perm = rng.permutation(n_keys).astype(np.int64)

    def sample(shape) -> np.ndarray:
        u = rng.random(shape)
        return perm[np.minimum(np.searchsorted(cdf, u), n_keys - 1)]

    return sample


def gen_workload(n_txns: int, n_keys: int, seed: int,
                 mode: ModeConfig = MODES["ycsb"],
                 shifting_hotspot: bool = False):
    """Returns (read_ids [N, R], write_ids [N, Q], write_mask [N], lag [N]).

    ``shifting_hotspot`` replaces the Zipf draw by a walking hotspot: every
    ``period`` txns the center of a window of ``span`` keys advances half
    a span, so hot keys cool off and leave the MVCC window while the set
    of keys ever touched grows with the stream (a tiered dictionary's
    regime). With keys = 100x a hot capacity H the span is H/16 and the
    walk takes 1/32 of the stream per step."""
    rng = np.random.default_rng(seed)
    if shifting_hotspot:
        span = max(64, n_keys // 1600)
        period = max(mode.batch, n_txns // 32)
        center = (np.arange(n_txns, dtype=np.int64) // period) \
            * (span // 2) % n_keys

        def draw(k):
            off = rng.integers(0, span, (n_txns, k), dtype=np.int64)
            return (center[:, None] + off) % n_keys

        read_ids, write_ids = draw(mode.n_reads), draw(mode.n_writes)
    else:
        sample = zipf_sampler(rng, n_keys, mode.theta)
        read_ids = sample((n_txns, mode.n_reads))
        write_ids = sample((n_txns, mode.n_writes))
    write_mask = rng.random(n_txns) < mode.write_frac
    lag = np.minimum(rng.geometric(0.6, n_txns) - 1, MAX_LAG).astype(np.int64)
    return read_ids, write_ids, write_mask, lag


def batch_versions(batch_index: int) -> tuple[int, int]:
    """(commit version, oldest version) of batch ``batch_index`` (0-based):
    cv = index + 1, oldest = max(0, cv - WINDOW)."""
    cv = batch_index + 1
    return cv, max(0, cv - WINDOW)


def build_txns(read_ids, write_ids, write_mask, lag, batch_index: int,
               mode: ModeConfig = MODES["ycsb"]) -> list[TxnConflictInfo]:
    """The TxnConflictInfo list of one batch; read version
    max(cv - 1 - lag, 0)."""
    b = mode.batch
    s = slice(batch_index * b, (batch_index + 1) * b)
    cv, _ = batch_versions(batch_index)
    rv = np.maximum(cv - 1 - lag[s], 0)

    def pt(k) -> KeyRange:
        key = int(k).to_bytes(8, "big")
        return KeyRange(key, key + b"\x00")

    out = []
    for r_ids, w_ids, wm, v in zip(read_ids[s], write_ids[s], write_mask[s],
                                   rv):
        out.append(TxnConflictInfo(
            int(v), [pt(k) for k in r_ids],
            [pt(k) for k in w_ids] if wm else []))
    return out


# Wire-blob assembly (vectorized; not resolver work: a proxy emits these
# bytes as its RPC payload). The with-writes record layout is fixed
# (little-endian); a record without writes is a strict prefix of it, so a
# masked ragged flatten assembles the stream in numpy.
_REC_RANGE = 8 + 17  # (bl, el) + 8B begin + 9B end
_REC_HDR = 16


def build_wire_stream(read_ids, write_ids, write_mask, lag, n_batches,
                      mode: ModeConfig = MODES["ycsb"]):
    """The stream in the resolver wire format, one commit version per
    batch (read version max(cv - 1 - lag, 0)). Returns (blob uint8 [...],
    txn_ends int64 [n_txns + 1]): txn i is blob[txn_ends[i]:txn_ends[i+1]]."""
    n, n_reads = read_ids.shape
    n_writes = write_ids.shape[1]
    rec_full = _REC_HDR + (n_reads + n_writes) * _REC_RANGE
    rec_nowrite = _REC_HDR + n_reads * _REC_RANGE
    be = read_ids.astype(">u8").view(np.uint8).reshape(n, n_reads, 8)
    wbe = write_ids.astype(">u8").view(np.uint8).reshape(n, n_writes, 8)
    cvs = np.repeat(np.arange(1, n_batches + 1, dtype=np.int64), mode.batch)
    rv = np.maximum(cvs - 1 - lag, 0)

    rec = np.zeros((n, rec_full), np.uint8)
    rec[:, 0:8] = rv.astype("<i8").view(np.uint8).reshape(n, 8)
    rec[:, 8:12] = np.frombuffer(
        np.int32(n_reads).astype("<i4").tobytes(), np.uint8)
    rec[:, 12:16] = (write_mask * n_writes).astype("<i4").view(
        np.uint8).reshape(n, 4)
    lens = np.frombuffer(np.array([8, 9], "<i4").tobytes(), np.uint8)

    def put_range(slot: int, keys_be: np.ndarray) -> None:
        off = _REC_HDR + slot * _REC_RANGE
        rec[:, off : off + 8] = lens
        rec[:, off + 8 : off + 16] = keys_be
        rec[:, off + 16 : off + 24] = keys_be
        rec[:, off + 24] = 0  # end = key + b"\x00"

    for r in range(n_reads):
        put_range(r, be[:, r])
    for q in range(n_writes):
        put_range(n_reads + q, wbe[:, q])

    rec_len = np.where(write_mask, rec_full, rec_nowrite)
    col = np.arange(rec_full)
    blob = rec[col[None, :] < rec_len[:, None]]  # ragged flatten

    ends = np.zeros(n + 1, np.int64)
    np.cumsum(rec_len, out=ends[1:])
    return blob, ends


def dictionary_counts(read_ids, write_ids, write_mask, batch: int,
                      window: int) -> dict:
    """Dictionary keys of the stream, per window of ``window`` batches (a
    point key brings two: the key and key + b"\\x00"): ``new`` (keys
    never seen before: an untiered engine's delta), ``in_window`` (keys
    used by this window or the WINDOW // window before it: the set a
    tiered engine may not demote at this window's pack) and ``touched``
    (every key seen so far). Host counts only, no engine."""
    per = batch * window
    n_windows = read_ids.shape[0] // per
    last = np.full(int(max(read_ids.max(), write_ids.max())) + 1, -1,
                   np.int64)
    out = {"new": [], "in_window": [], "touched": []}
    for w in range(n_windows):
        s = slice(w * per, (w + 1) * per)
        ids = np.unique(np.concatenate([read_ids[s].ravel(),
                                        write_ids[s][write_mask[s]].ravel()]))
        out["new"].append(2 * int((last[ids] < 0).sum()))
        last[ids] = w
        floor = max(0, w - WINDOW // window)
        out["in_window"].append(2 * int((last >= floor).sum()))
        out["touched"].append(2 * int((last >= 0).sum()))
    return out
