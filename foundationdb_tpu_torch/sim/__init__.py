"""The port's simulation pieces: the brute-force conflict oracle
(``oracle.py``) that every engine is held to, the simulated network
(``network.py``), the whole simulated cluster with its engine factory
(``cluster.py``: ``SimCluster``, ``new_conflict_set``), one generation of
the commit path on one loop (``commit_path.py``) and closed-loop YCSB-A
clients over a cluster with role kills (``cluster_load.py``)."""
