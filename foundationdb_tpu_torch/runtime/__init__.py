"""The roles on the Flow loop: sequencer, resolver, commit and GRV
proxies, tlog, storage server (with the read plane) and ratekeeper, and
the control plane (cluster controller, recovery, coordination, status,
TimeKeeper), copies of ``foundationdb_tpu/runtime/``'s modules of the
same names."""
