"""Multi-resolver conflict detection: keyspace shards of one card."""
