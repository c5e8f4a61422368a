"""Parallelism layer: device meshes over a ``torch.distributed`` gang
(``mesh.py``) and the DTensor placements the sharded trainer and
generator lay parameters, batches and the KV cache out by."""
