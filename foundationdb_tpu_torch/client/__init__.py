"""The client library: ``Database`` and ``Transaction``
(``transaction.py``) and read-your-writes with ``open_database``
(``ryw.py``), copies of ``foundationdb_tpu/client/``'s modules of the same
names."""
