"""Partition rules of the port's parameters (the weight plane's shard plans)."""
