"""Admission-time early conflict detection: the recent-writes filter.

The port of ``foundationdb_tpu/admission`` without its policy
(``AdmissionPolicy``, which only the commit-proxy role uses): the banked
recent-writes fingerprint filter a resident ``TorchConflictSet`` feeds
(``attach_admission_filter``), with its device banks on K11.
"""

from foundationdb_tpu_torch.admission.filter import (
    RecentWritesFilter,
    fingerprints,
    key_fingerprint,
    u64_cols_fingerprint,
)

__all__ = [
    "RecentWritesFilter",
    "fingerprints",
    "key_fingerprint",
    "u64_cols_fingerprint",
]
