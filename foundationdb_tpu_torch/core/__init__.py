from foundationdb_tpu_torch.core.keypack import INT32_MAX, KeyCodec  # noqa: F401
from foundationdb_tpu_torch.core.types import (  # noqa: F401
    KeyRange,
    TxnConflictInfo,
    Verdict,
)
