"""All-reduce microbenchmark over one dim of a device mesh.

The port of ``k8s_dra_driver_gpu_tpu/ops/collectives.py``: the in-tree
proof that a prepared fabric moves bytes, an all-reduce over the mesh
dim's process group (``mesh.get_group(axis)``: NCCL between cards, gloo
on the host), reporting achieved GB/s by the reference's formula.
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist


def allreduce_fn(mesh, axis: str):
    """A sum over ``axis`` of ``mesh`` for [N] fp32 buffers. It reduces
    in place (no copy enters the timing) and returns the buffer."""
    group = mesh.get_group(axis)

    def _allreduce(x: torch.Tensor) -> torch.Tensor:
        dist.all_reduce(x, group=group)
        return x

    return _allreduce


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def bench_allreduce(mesh, axis: str, nbytes: int = 64 << 20,
                    iters: int = 10) -> dict:
    """Time ``iters`` all-reduces of an ``nbytes`` fp32 buffer on the
    mesh's device; returns achieved GB/s.

    Algorithmic bytes moved per device for a ring all-reduce of size S
    over n participants: 2*S*(n-1)/n, so a one-rank axis moves none and
    reports 0 GB/s.
    """
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    device = torch.device(mesh.device_type, torch.cuda.current_device()
                          if mesh.device_type == "cuda" else None)
    x = torch.ones((nbytes // 4,), dtype=torch.float32, device=device)
    fn = allreduce_fn(mesh, axis)
    fn(x)  # warm up: the communicator's set-up
    _sync(device)
    start = time.perf_counter()
    for _ in range(iters):
        x = fn(x)
    _sync(device)
    elapsed = time.perf_counter() - start
    algo_bytes = 2 * nbytes * (n - 1) / max(n, 1)
    return {
        "participants": n,
        "bytes": nbytes,
        "iters": iters,
        "seconds": elapsed,
        "gbps": (algo_bytes * iters / elapsed) / 1e9 if elapsed > 0 else 0.0,
    }
