"""TorchReadSet: a resident key-universe mirror and one search per dispatch.

The port of ``foundationdb_tpu/reads/read_set.py``'s ``TPUReadSet``. The
versioned map's sorted key universe is packed ONCE into ``[n, W]`` int32
rows (core/keypack.py) and stays resident across dispatches: on the card
in the device arm (``arm="device"``), as the memcmp-order host view in the
host arm (``arm="host"``). A dispatch packs only its queries and runs one
two-sided search that answers every point lookup and range boundary of the
batch at once:

- device arm on a CUDA device: K12's search (kernels/csrc/word_probe.cu
  ``wp_search``: a dispatch's few hundred query rows get a warp each, 32
  pivots a step, the right bound galloping from the left), one launch
  per search, every mirror row live;
- device arm with ``device="cpu"``: its plain twin,
  ``ops/lex.searchsorted_words_2sided_fp``;
- host arm: numpy ``searchsorted`` over ``row_sort_keys``, as in JAX.

Values then gather on the host from the per-key version chains, which
keeps every arm byte-identical to the scalar ``VersionedMap.at`` oracle:

- point hit: the run of equal packed rows the search gives is confirmed
  by exact bytes (packed rows truncate at ``max_key_bytes``), then the
  chain resolves at the read version exactly as ``at()`` does;
- range: the conservative packed bounds are tightened by an advance-only
  byte compare at the run edges (truncation rounds down, so packed bounds
  can only be LOW), then the keys in [lo, hi) resolve per chain.

The mirror is rebuilt (and on the card re-uploaded) only when the map's
``struct_seq`` moves (inserts, purges, rollback and GC removals); value
updates mutate the referenced chains in place and cost the mirror nothing.
The JAX device arm pads the mirror to a power of two with INT32_MAX rows
and the queries to at least 8 slots (its compile buckets) and clamps the
bounds to n; the port has no compile buckets, so it pads nothing, and its
bounds lie in [0, n] by construction.
"""

from __future__ import annotations

import bisect
from time import perf_counter

import numpy as np
import torch

from foundationdb_tpu_torch.core.keypack import KeyCodec, row_sort_keys
from foundationdb_tpu_torch.models.conflict_set import resolve_device
from foundationdb_tpu_torch.ops.lex import searchsorted_words_2sided_fp

_ARMS = ("device", "host")


def search2(rows: torch.Tensor, q: torch.Tensor):
    """(left, right) int32 [k]: the insertion points of the query rows
    ``q`` [k, W] in the sorted mirror ``rows`` [n, W]. K12's search on a
    CUDA tensor (never a fallback), its plain twin on a CPU one."""
    if rows.device.type == "cuda":
        from foundationdb_tpu_torch import kernels as K

        left, right, _, _ = K.word_search(rows, q)
        return left, right
    if rows.device.type != "cpu":
        raise ValueError(f"unsupported device {rows.device}")
    return searchsorted_words_2sided_fp(rows, q)


class TorchReadSet:
    """Batched point and range reads over a versioned map.

    ``vmap`` duck-types ``runtime.storage.VersionedMap``: sorted ``_keys``,
    ``_chains`` (key -> ascending ``(version, value)`` chain) and a
    ``struct_seq`` counter bumped whenever the KEY SET changes. ``arm`` is
    ``"device"`` (the default: the mirror on ``device``, ``cuda`` unless
    the caller asks for the CPU) or ``"host"`` (``device`` unused)."""

    def __init__(self, vmap, codec: KeyCodec | None = None,
                 arm: str = "device", device=None):
        if arm not in _ARMS:
            raise ValueError(f"read arm {arm!r}: want one of {_ARMS}")
        self.vmap = vmap
        self.codec = codec or KeyCodec()
        self.arm = arm
        self.device = resolve_device(device) if arm == "device" else None
        self._seq = None  # mirror generation (vmap.struct_seq at build)
        self._keys: list[bytes] = []
        self._chains: list[list[tuple[int, bytes | None]]] = []
        self._void = row_sort_keys(
            np.zeros((0, self.codec.width), np.int32))
        self._dev_rows: torch.Tensor | None = None
        self.stats = {
            "rebuilds": 0, "uploads": 0, "probes": 0,
            "point_reads": 0, "range_reads": 0, "pack_s": 0.0,
        }

    # -- mirror maintenance ---------------------------------------------------

    def _sync(self) -> None:
        seq = getattr(self.vmap, "struct_seq", 0)
        if self._seq == seq:
            return
        self._keys = list(self.vmap._keys)
        self._chains = [self.vmap._chains[k] for k in self._keys]
        rows = (self.codec.pack(self._keys, mode="begin") if self._keys
                else np.zeros((0, self.codec.width), np.int32))
        # memcmp-order void view: one native np.searchsorted call answers
        # a whole dispatch on the host arm.
        self._void = row_sort_keys(rows)
        self._seq = seq
        self.stats["rebuilds"] += 1
        if self.arm == "device":
            self._dev_rows = torch.from_numpy(rows).to(self.device)
            self.stats["uploads"] += 1

    def _search2(self, q_rows: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(left, right) bounds of each query row in the resident mirror:
        the one search a dispatch pays."""
        self.stats["probes"] += 1
        if self.arm == "device":
            q = torch.from_numpy(np.ascontiguousarray(q_rows)).to(self.device)
            lo, hi = search2(self._dev_rows, q)
            return lo.cpu().numpy(), hi.cpu().numpy()
        qv = row_sort_keys(np.ascontiguousarray(q_rows))
        return (np.searchsorted(self._void, qv, side="left"),
                np.searchsorted(self._void, qv, side="right"))

    # -- value resolution (host gather; identical to VersionedMap.at) --------

    def _value_at(self, idx: int, version: int) -> bytes | None:
        chain = self._chains[idx]
        last_v, last_val = chain[-1]
        if last_v <= version:
            return last_val
        i = bisect.bisect_right(chain, version, key=lambda e: e[0]) - 1
        return None if i < 0 else chain[i][1]

    # -- batched reads --------------------------------------------------------

    def get_points(self, keys: list[bytes], versions) -> list[bytes | None]:
        """One batched lookup: values of ``keys`` at ``versions`` (an int,
        or one per key: the coalescer merges requests at different read
        versions into one search, which is version-independent)."""
        self._sync()
        out: list[bytes | None] = [None] * len(keys)
        self.stats["point_reads"] += len(keys)
        if not keys or not self._keys:
            return out
        if isinstance(versions, int):
            versions = [versions] * len(keys)
        t0 = perf_counter()
        q = self.codec.pack(keys, mode="begin")
        self.stats["pack_s"] += perf_counter() - t0
        lo, hi = self._search2(q)
        for j, key in enumerate(keys):
            for i in range(int(lo[j]), int(hi[j])):
                if self._keys[i] == key:
                    out[j] = self._value_at(i, versions[j])
                    break
        return out

    def get_ranges(self, reqs) -> list[list[tuple[bytes, bytes]]]:
        """Batched range reads. ``reqs`` is a list of
        ``(begin, end, limit, reverse, version)``; every boundary rides
        one search."""
        self._sync()
        self.stats["range_reads"] += len(reqs)
        if not reqs or not self._keys:
            return [[] for _ in reqs]
        t0 = perf_counter()
        bounds = [r[0] for r in reqs] + [r[1] for r in reqs]
        q = self.codec.pack(bounds, mode="begin")
        self.stats["pack_s"] += perf_counter() - t0
        lo, _hi = self._search2(q)
        n, m = len(self._keys), len(reqs)
        out = []
        for j, (begin, end, limit, reverse, version) in enumerate(reqs):
            a, b = int(lo[j]), int(lo[m + j])
            # Truncated packed bounds are conservative-LOW: advance by
            # exact bytes (bounded by the shared-prefix collision run).
            while a < n and self._keys[a] < begin:
                a += 1
            while b < n and self._keys[b] < end:
                b += 1
            idxs = range(b - 1, a - 1, -1) if reverse else range(a, b)
            rows: list[tuple[bytes, bytes]] = []
            for i in idxs:
                v = self._value_at(i, version)
                if v is not None:
                    rows.append((self._keys[i], v))
                    if len(rows) >= limit:
                        break
            out.append(rows)
        return out

    # -- the sequential oracle ------------------------------------------------

    def oracle_get(self, key: bytes, version: int) -> bytes | None:
        """Scalar reference read (``VersionedMap.at`` semantics, no
        mirror): the baseline every batched arm must match byte for byte."""
        chain = self.vmap._chains.get(key)
        if not chain:
            return None
        i = bisect.bisect_right(chain, version, key=lambda e: e[0]) - 1
        return None if i < 0 else chain[i][1]

    def oracle_range(self, begin: bytes, end: bytes, limit: int,
                     reverse: bool, version: int) -> list[tuple[bytes, bytes]]:
        keys = self.vmap._keys
        a = bisect.bisect_left(keys, begin)
        b = bisect.bisect_left(keys, end)
        idxs = range(b - 1, a - 1, -1) if reverse else range(a, b)
        rows: list[tuple[bytes, bytes]] = []
        for i in idxs:
            v = self.oracle_get(keys[i], version)
            if v is not None:
                rows.append((keys[i], v))
                if len(rows) >= limit:
                    break
        return rows
