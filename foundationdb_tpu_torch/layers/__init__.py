"""Layers: the tuple encoding and subspaces (reference: fdbclient/Tuple.cpp,
bindings/python/fdb/subspace_impl.py).

The port's copy of ``foundationdb_tpu/layers/``, so far its tuple layer
alone (``tuple_layer.py``), whose names are exported here. The JAX
package's directory layer (``layers/directory.py``) and task bucket
(``layers/taskbucket.py``) are not ported yet; the JAX ``__init__`` also
exports the directory layer's names.
"""

from foundationdb_tpu_torch.layers.tuple_layer import (
    SingleFloat,
    Subspace,
    TupleError,
    Versionstamp,
    pack,
    pack_with_versionstamp,
    range_of,
    strinc,
    unpack,
)

__all__ = [
    "SingleFloat", "Subspace", "TupleError", "Versionstamp", "pack",
    "pack_with_versionstamp", "range_of", "strinc", "unpack",
]
