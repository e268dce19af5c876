"""PyTorch + CUDA port of foundationdb_tpu's conflict engine.

``TorchConflictSet`` (models/conflict_set.py) is the Resolver's MVCC
conflict engine on an NVIDIA H100, over four hand-written CUDA kernels
(kernels/csrc/). It imports torch and numpy, never JAX or the JAX package.
"""

from foundationdb_tpu_torch.models.conflict_set import TorchConflictSet  # noqa: F401
