"""Collectives over one dim of a device mesh: an all-reduce
microbenchmark, and the differentiable collectives of the manual-SPMD
trainers.

``allreduce_fn`` and ``bench_allreduce`` port
``k8s_dra_driver_gpu_tpu/ops/collectives.py``: the in-tree proof that a
prepared fabric moves bytes, an all-reduce over the mesh dim's process
group (``mesh.get_group(axis)``: NCCL between cards, gloo on the host),
reporting achieved GB/s by the reference's formula.

``all_reduce_sum``, ``ring_shift`` and ``all_to_all`` are what the
reference's ``shard_map`` bodies call as ``psum``, ``ppermute`` around a
ring and ``all_to_all(tiled=True)``: collectives on each rank's plain
local tensors over one ``MeshAxis``, each a ``torch.autograd.Function``
whose backward is the transpose ``shard_map(check_vma=False)`` takes (a
sum all-reduce for the sum, the inverse rotation, the inverse
all-to-all). On an axis of size one, or one the mesh does not have
(``parallel.mesh.compute_mesh`` drops those), each is the identity and
issues no collective.
"""

from __future__ import annotations

import time
from dataclasses import dataclass

import torch
import torch.distributed as dist

from ..parallel.mesh import axis_size


@dataclass(frozen=True)
class MeshAxis:
    """One named dim of a ``DeviceMesh``, as a ``shard_map`` body sees its
    axis: ``size`` ranks (1 when the mesh has no such dim), this rank's
    ``index`` along it (``lax.axis_index``) and its process ``group``."""

    mesh: object
    name: str

    @property
    def size(self) -> int:
        return axis_size(self.mesh, self.name)

    @property
    def index(self) -> int:
        return (self.mesh.get_local_rank(self.name) if self.size > 1
                else 0)

    @property
    def group(self):
        return self.mesh.get_group(self.name)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, grad):
        # psum's transpose under check_vma=False: a sum of the cotangents.
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.axis.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum of ``x`` over ``axis`` (``lax.psum``); its backward sums
    the cotangents over the axis too, so a loss that every rank of the
    axis computes alike hands each input ``axis.size`` times its
    gradient, as the reference's does."""
    if axis.size == 1:
        return x
    return _AllReduceSum.apply(x, axis)


def _rotate(x: torch.Tensor, axis: MeshAxis, shift: int) -> torch.Tensor:
    """``x`` sent to the rank ``shift`` places on along the axis, and the
    tensor of the rank ``shift`` places back received in its place."""
    n, me, group = axis.size, axis.index, axis.group
    x = x.contiguous()
    out = torch.empty_like(x)

    def peer(i: int) -> int:
        return dist.get_global_rank(group, (me + i) % n)

    ops = [dist.P2POp(dist.isend, x, peer(shift), group),
           dist.P2POp(dist.irecv, out, peer(-shift), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _rotate(x, axis, 1)

    @staticmethod
    def backward(ctx, grad):
        return _rotate(grad, ctx.axis, -1), None


def ring_shift(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """``lax.ppermute`` with ``perm = [(i, (i + 1) % n)]``: each rank sends
    ``x`` to the next rank of the axis and returns the previous rank's.
    Its backward rotates the cotangent the other way."""
    if axis.size == 1:
        return x
    return _RingShift.apply(x, axis)


def _all_to_all(x: torch.Tensor, axis: MeshAxis, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = axis.size
    if x.shape[split_dim] % n:
        raise ValueError(f"dim {split_dim} of size {x.shape[split_dim]} "
                         f"does not split over {axis.name}={n}")
    send = torch.stack(x.chunk(n, dim=split_dim)).contiguous()
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=axis.group)
    return torch.cat(recv.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = axis, split_dim, concat_dim
        return _all_to_all(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        axis, split_dim, concat_dim = ctx.args
        return _all_to_all(grad, axis, concat_dim, split_dim), None, None, None


def all_to_all(x: torch.Tensor, axis: MeshAxis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)``:
    chunk j of ``split_dim`` goes to rank j of the axis, and the chunks
    received are concatenated along ``concat_dim`` in rank order. Its
    backward is the inverse all-to-all."""
    if axis.size == 1:
        return x
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


def mean_over(tensors: list[torch.Tensor], axes: list[MeshAxis]) -> None:
    """``lax.pmean`` over ``axes``, in place on each tensor: summed over
    each axis of more than one rank, then divided by the product of the
    axes' sizes. Not differentiable (the trainers average gradients and
    losses with it)."""
    live = [axis for axis in axes if axis.size > 1]
    if not live:
        return
    count = 1
    for axis in live:
        count *= axis.size
        for t in tensors:
            dist.all_reduce(t, group=axis.group)
    for t in tensors:
        t.div_(count)


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
