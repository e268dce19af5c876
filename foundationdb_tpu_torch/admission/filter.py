"""Recent-writes fingerprint filter: the admission subsystem's memory.

The port of ``foundationdb_tpu/admission/filter.py``; its docstrings
explain the design. A banked Bloom-style filter over uint64 key
fingerprints (the resident dictionary mirror's u64 column encoding, so
an engine feeds it from columns each dispatch already computed), aged by
version window: ``banks`` bit banks each cover ``window_versions / banks``
commit versions, the oldest is cleared when the stream moves past it,
and a probe at read version ``rv`` consults only the banks whose newest
recorded version exceeds ``rv``. The exact shadow (per-bank dicts of key
bytes -> newest write version) is the only evidence a pre-abort may rest
on; the delta log feeds peer filters.

Two backends answer bit for bit alike. ``numpy`` (the default, as in the
JAX package: the roles use the filter host-side) keeps bool banks in
numpy. ``device`` keeps the banks as a torch tensor on the engine's
device (``device=None`` means ``cuda`` and raises without a card): on the
card they are bit-packed ``[banks, ceil(nbits/32)]`` words that K11
(``kernels/csrc/admission.cu``) sets, clears, probes and counts; on the
CPU they are bool ``[banks, nbits]`` and the plain torch versions below
(``*_plain``) run. Neither falls back to the other.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from foundationdb_tpu_torch import kernels as K

#: The cluster-wide MVCC window (the JAX package's runtime/sequencer.py
#: MVCC_WINDOW_VERSIONS: 5 s at 10^6 versions per second).
MVCC_WINDOW_VERSIONS = 5_000_000

_HASH_C1 = np.uint64(0x9E3779B97F4A7C15)
_HASH_C2 = np.uint64(0xFF51AFD7ED558CCD)

#: Bounded delta log: a consumer further behind re-syncs from the recent
#: tail only (it can only under-detect, never wrongly pre-abort).
DELTA_LOG_CAP = 4096


def _env_int(name: str, default: int) -> int:
    """Loud env parsing: an unusable value raises with what is accepted."""
    raw = os.environ.get(name, "")
    if not raw:
        return default
    try:
        return int(raw)
    except ValueError:
        raise ValueError(
            f"{name}={raw!r} is not a valid setting; expected an integer"
        ) from None


_FNV_OFFSET = np.uint64(0xCBF29CE484222325)
_FNV_PRIME = np.uint64(0x100000001B3)


def fingerprints(keys: list[bytes]) -> np.ndarray:
    """uint64 fingerprints of raw keys: FNV-1a, vectorized across keys one
    byte column at a time, then a splitmix finisher."""
    n = len(keys)
    if not n:
        return np.zeros(0, np.uint64)
    lens = np.fromiter((len(k) for k in keys), np.int64, count=n)
    width = int(lens.max(initial=0))
    buf = np.zeros((n, max(width, 1)), np.uint8)
    for i, k in enumerate(keys):
        buf[i, : len(k)] = np.frombuffer(k, np.uint8)
    h = np.full(n, _FNV_OFFSET, np.uint64)
    for j in range(width):
        h = np.where(j < lens, (h ^ buf[:, j]) * _FNV_PRIME, h)
    h = h * _HASH_C1
    return h ^ (h >> np.uint64(33))


def key_fingerprint(key: bytes) -> np.uint64:
    return fingerprints([key])[0]


def u64_cols_fingerprint(cols: np.ndarray) -> np.ndarray:
    """[n, C] uint64 key columns (the resident mirror's encoding) -> [n]
    uint64, by the mirror hash table's multiplicative mix."""
    cols = np.asarray(cols, np.uint64)
    h = cols[:, 0] * _HASH_C1
    for j in range(1, cols.shape[1]):
        h = (h ^ cols[:, j]) * _HASH_C2
    return h ^ (h >> np.uint64(33))


class _NumpyBanks:
    """Host backend: bool bit banks in numpy."""

    def __init__(self, banks: int, nbits: int):
        self.bits = np.zeros((banks, nbits), bool)

    def set(self, bank: int, idx: np.ndarray) -> None:
        self.bits[bank, idx] = True

    def clear(self, bank: int) -> None:
        self.bits[bank] = False

    def any_all_hashes(self, idx: np.ndarray,
                       bank_mask: np.ndarray) -> np.ndarray:
        """[n, k] slot indices -> [n] hit (all k bits set in SOME unmasked
        bank)."""
        hits = self.bits[:, idx].all(axis=2)  # [banks, n]
        return (hits & bank_mask[:, None]).any(axis=0)

    def fill(self, bank: int) -> float:
        return float(self.bits[bank].mean())

    def fill_max(self) -> float:
        return float(self.bits.mean(axis=1).max())


# ---------------------------------------------------------------------------
# K11: the device banks' four programs (the JAX _JaxBanks _set, _clear,
# _probe and the fill means), each with its plain version over bool banks.
# ---------------------------------------------------------------------------


def banks_set_plain(bits: torch.Tensor, bank: int, idx: torch.Tensor) -> None:
    """In place: bit ``idx[i]`` of bank ``bank`` set (bool [banks, nbits])."""
    bits[bank, idx] = True


def banks_probe_plain(bits: torch.Tensor, idx: torch.Tensor,
                      bank_mask: torch.Tensor) -> torch.Tensor:
    """bool [n]: all k bits of row i set in some bank of ``bank_mask``."""
    hits = bits[:, idx].all(dim=2)  # [banks, n]
    return (hits & bank_mask[:, None]).any(dim=0)


def banks_count_plain(bits: torch.Tensor) -> torch.Tensor:
    """int64 [banks]: the set bits of each bank."""
    return bits.sum(dim=1)


def unpack_banks(words: torch.Tensor, nbits: int) -> torch.Tensor:
    """bool [banks, nbits] from K11's packed int32 words (bit j of word w
    is slot 32w + j)."""
    shifts = torch.arange(32, dtype=torch.int32, device=words.device)
    bits = ((words[:, :, None] >> shifts) & 1).bool()
    return bits.reshape(words.shape[0], -1)[:, :nbits]


def pack_banks(bits: torch.Tensor) -> torch.Tensor:
    """int32 [banks, ceil(nbits/32)] words from bool [banks, nbits] banks
    (the inverse of :func:`unpack_banks`)."""
    banks, nbits = bits.shape
    nw = (nbits + 31) // 32
    padded = torch.zeros((banks, nw * 32), dtype=torch.int64,
                         device=bits.device)
    padded[:, :nbits] = bits.long()
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    words = (padded.reshape(banks, nw, 32) << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def _device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "the device admission banks run on a CUDA card and none is "
            "available; pass device='cpu' to run the plain torch versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


class _DeviceBanks:
    """Device backend: the banks persist as one torch tensor on ``device``
    across calls. On the card: int32 words [banks, ceil(nbits/32)] and the
    K11 launches; on the CPU: bool [banks, nbits] and the plain versions.
    Operands are not padded (JAX pads to bound its retracing)."""

    def __init__(self, banks: int, nbits: int, device=None):
        self.device = _device(device)
        self.nbits = nbits
        self.on_card = self.device.type == "cuda"
        if self.on_card:
            self.bits = torch.zeros((banks, (nbits + 31) // 32),
                                    dtype=torch.int32, device=self.device)
        else:
            self.bits = torch.zeros((banks, nbits), dtype=torch.bool)

    def _t(self, a: np.ndarray, dtype) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device, dtype)

    def set(self, bank: int, idx: np.ndarray) -> None:
        t = self._t(idx, torch.int64)
        if self.on_card:
            K.admission_set(self.bits, bank, t, self.nbits)
        else:
            banks_set_plain(self.bits, bank, t)

    def clear(self, bank: int) -> None:
        if self.on_card:
            K.admission_clear(self.bits, bank)
        else:
            self.bits[bank] = False

    def any_all_hashes(self, idx: np.ndarray,
                       bank_mask: np.ndarray) -> np.ndarray:
        t = self._t(idx, torch.int64)
        mask = self._t(bank_mask, torch.bool)
        if self.on_card:
            out = K.admission_probe(self.bits, t, mask, self.nbits)
        else:
            out = banks_probe_plain(self.bits, t, mask)
        return out.cpu().numpy()

    def counts(self) -> np.ndarray:
        """int64 [banks]: set bits per bank (one device read)."""
        if self.on_card:
            return K.admission_count(self.bits).cpu().numpy().astype(np.int64)
        return banks_count_plain(self.bits).numpy()

    def bool_banks(self) -> torch.Tensor:
        """bool [banks, nbits] on the banks' device."""
        return unpack_banks(self.bits, self.nbits) if self.on_card \
            else self.bits

    def load(self, bits: np.ndarray) -> None:
        """Replace the banks by bool [banks, nbits] host banks."""
        t = torch.from_numpy(np.array(bits, bool, copy=True))
        self.bits = (pack_banks(t).to(self.device) if self.on_card
                     else t.clone())

    # A power-of-two nbits below 2^24 makes count / nbits exact in float32
    # (the JAX mean) and float64 (numpy's) alike.
    def fill(self, bank: int) -> float:
        return float(self.counts()[bank]) / self.nbits

    def fill_max(self) -> float:
        return float(self.counts().max()) / self.nbits


class RecentWritesFilter:
    """Banked recent-writes filter with version-window aging.

    ``backend``: ``"numpy"`` (host; the roles' default) or ``"device"``
    (banks on ``device``, the engine's; K11 on the card). Both answer bit
    for bit alike."""

    def __init__(
        self,
        bits_log2: int | None = None,
        banks: int | None = None,
        hashes: int = 2,
        window_versions: int | None = None,
        exact_shadow: bool = True,
        backend: str = "numpy",
        device=None,
    ):
        if backend not in ("numpy", "device"):
            raise ValueError(f"backend {backend!r}: expected 'numpy' or "
                             "'device'")
        self.nbits = 1 << (bits_log2
                           or _env_int("FDB_TPU_ADMISSION_BITS_LOG2", 16))
        self.banks = banks or _env_int("FDB_TPU_ADMISSION_BANKS", 4)
        self.hashes = max(1, hashes)
        self.window_versions = (window_versions
                                or _env_int("FDB_TPU_ADMISSION_WINDOW",
                                            MVCC_WINDOW_VERSIONS))
        self.slice_versions = max(1, self.window_versions // self.banks)
        self.backend = backend
        self._bits = (_DeviceBanks(self.banks, self.nbits, device)
                      if backend == "device"
                      else _NumpyBanks(self.banks, self.nbits))
        self._cur = 0
        # Per-bank recorded-version bounds: [min, max] per bank, -1 = empty.
        self.bank_min = np.full(self.banks, -1, np.int64)
        self.bank_max = np.full(self.banks, -1, np.int64)
        self._cur_from = -1  # version at which the current bank opened
        self.exact_shadow = exact_shadow
        self._shadow: list[dict[bytes, int]] = [dict()
                                                for _ in range(self.banks)]
        self._delta_log: list[tuple[bytes, int]] = []
        self.delta_seq = 0
        self.recorded = 0
        self.rotations = 0

    # -- aging ---------------------------------------------------------------

    def _rotate_to(self, version: int) -> None:
        if self._cur_from < 0:
            self._cur_from = version
            return
        while version - self._cur_from >= self.slice_versions:
            self._cur_from += self.slice_versions
            self._cur = (self._cur + 1) % self.banks
            self._bits.clear(self._cur)
            self.bank_min[self._cur] = -1
            self.bank_max[self._cur] = -1
            self._shadow[self._cur] = {}
            self.rotations += 1

    def advance(self, version: int) -> None:
        """Age banks forward without recording (GC-only dispatches)."""
        self._rotate_to(version)

    # -- recording -----------------------------------------------------------

    def _idx(self, fps: np.ndarray) -> np.ndarray:
        """[n] fingerprints -> [n, hashes] slot indices (h1 + i·h2)."""
        fps = np.asarray(fps, np.uint64)
        h2 = (fps >> np.uint64(32)) | np.uint64(1)
        mult = np.arange(self.hashes, dtype=np.uint64)
        return ((fps[:, None] + mult[None, :] * h2[:, None])
                % np.uint64(self.nbits)).astype(np.int64)

    def record_u64(self, fps: np.ndarray, version: int) -> None:
        """Record write fingerprints at a commit version (Bloom tier only:
        the engine feed, where key bytes never exist host-side)."""
        fps = np.asarray(fps, np.uint64).reshape(-1)
        self._rotate_to(version)
        if not fps.size:
            return
        b = self._cur
        self._bits.set(b, self._idx(fps).reshape(-1))
        self.bank_min[b] = version if self.bank_min[b] < 0 else min(
            int(self.bank_min[b]), version)
        self.bank_max[b] = max(int(self.bank_max[b]), version)
        self.recorded += int(fps.size)

    def record(self, keys: list[bytes], version: int,
               log_delta: bool = True) -> None:
        """Record raw write keys at a commit version (both tiers, and the
        delta log unless ``log_delta=False``: a replayed peer delta)."""
        if not keys:
            self._rotate_to(version)
            return
        self.record_u64(fingerprints(keys), version)
        if self.exact_shadow:
            shadow = self._shadow[self._cur]
            for k in keys:
                prev = shadow.get(k)
                if prev is None or prev < version:
                    shadow[k] = version
        if not log_delta:
            return
        for k in keys:
            self._delta_log.append((bytes(k), version))
        self.delta_seq += len(keys)
        if len(self._delta_log) > DELTA_LOG_CAP:
            del self._delta_log[: len(self._delta_log) - DELTA_LOG_CAP]

    # -- cross-role delta feed ------------------------------------------------

    def delta_since(self, since_seq: int
                    ) -> tuple[int, list[tuple[bytes, int]]]:
        """Entries recorded after ``since_seq`` (bounded by the log cap)."""
        behind = self.delta_seq - since_seq
        if behind <= 0:
            return self.delta_seq, []
        return self.delta_seq, list(
            self._delta_log[-min(behind, len(self._delta_log)):])

    def apply_delta(self, entries: list[tuple[bytes, int]]) -> None:
        """Merge a peer's delta (idempotent), one record call per
        same-version run, none of it re-logged."""
        i, n = 0, len(entries)
        while i < n:
            version = int(entries[i][1])
            j = i
            while j < n and int(entries[j][1]) == version:
                j += 1
            self.record([bytes(k) for k, _v in entries[i:j]], version,
                        log_delta=False)
            i = j

    # -- probing -------------------------------------------------------------

    def _bank_mask(self, read_version: int) -> np.ndarray:
        """Banks that can hold a write NEWER than the read version."""
        return self.bank_max > read_version

    def probe_u64(self, fps: np.ndarray, read_version: int) -> np.ndarray:
        """[n] fingerprints -> [n] bool likely-newer-write hits."""
        fps = np.asarray(fps, np.uint64).reshape(-1)
        if not fps.size:
            return np.zeros(0, bool)
        mask = self._bank_mask(read_version)
        if not mask.any():
            return np.zeros(len(fps), bool)
        return self._bits.any_all_hashes(self._idx(fps), mask)

    def probe_keys(self, keys: list[bytes], read_version: int) -> np.ndarray:
        if not keys:
            return np.zeros(0, bool)
        return self.probe_u64(fingerprints(keys), read_version)

    def probe_exact(self, key: bytes, read_version: int) -> int | None:
        """Exact tier: the newest recorded write version of ``key`` above
        ``read_version`` (None: no confirmation)."""
        best = None
        for shadow in self._shadow:
            v = shadow.get(key)
            if v is not None and v > read_version and (best is None
                                                        or v > best):
                best = v
        return best

    # -- signals -------------------------------------------------------------

    def saturation(self) -> float:
        """Worst fill fraction over all banks (the ratekeeper's signal)."""
        return self._bits.fill_max()

    def metrics(self) -> dict:
        return {
            "backend": self.backend,
            "bits": self.nbits,
            "banks": self.banks,
            "recorded": self.recorded,
            "rotations": self.rotations,
            "saturation": round(self.saturation(), 4),
            "delta_seq": self.delta_seq,
            "shadow_entries": sum(len(s) for s in self._shadow),
        }
