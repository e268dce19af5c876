"""PyTorch + CUDA port of foundationdb_tpu's conflict engine.

``TorchConflictSet`` (models/conflict_set.py) is the Resolver's MVCC
conflict engine on an NVIDIA H100, over hand-written CUDA kernels
(kernels/csrc/); ``admission`` holds the recent-writes filter it feeds;
``reads`` is the storage server's read plane (batched reads and watches
over a resident key mirror, K12's search on the card) on ``runtime``'s
Flow loop and versioned map; ``runtime`` also holds the commit path's
roles (sequencer, resolver, commit and GRV proxies, tlog, storage server,
ratekeeper), which ``server.make_conflict_set`` and
``sim.cluster.new_conflict_set`` hand their engines and
``sim/commit_path.py`` wires on one loop, and the control plane;
``sim.cluster.SimCluster`` runs a whole cluster on ``sim/network.py``
under its cluster controller, and ``client`` is the client library
(``open_database``). It imports torch and numpy, never JAX or the JAX
package.
"""

from foundationdb_tpu_torch.models.conflict_set import TorchConflictSet  # noqa: F401
