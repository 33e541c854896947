"""Datasets, partitions and client shards (numpy, host side)."""
