"""Token data for the port's trainers: memory-mapped token files read
as disjoint, deterministic shards of each global batch (``loader.py``)."""
