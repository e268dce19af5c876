from foundationdb_tpu_torch.ops.lex import (  # noqa: F401
    searchsorted_words,
    searchsorted_words_fp,
)
from foundationdb_tpu_torch.ops.rmq import range_max, sparse_table  # noqa: F401
