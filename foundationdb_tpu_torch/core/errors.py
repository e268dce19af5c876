"""Error types the port raises, with the reference's fdb error codes.

A copy of the two classes of ``foundationdb_tpu/core/errors.py`` that the
conflict engine's value types need.
"""

from __future__ import annotations


class FdbError(Exception):
    """Base error with an fdb-compatible numeric code."""

    code: int = 1500  # internal_error

    def __init__(self, message: str = "", code: int | None = None):
        super().__init__(message or type(self).__name__)
        if code is not None:
            self.code = code


class InvertedRange(FdbError):
    code = 2005
