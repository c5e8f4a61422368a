"""Device meshes over the ranks of a ``torch.distributed`` gang.

The port of ``k8s_dra_driver_gpu_tpu/parallel/mesh.py``. The reference
turns a slice topology ("2x2x4") into a ``jax.sharding.Mesh`` of devices;
here a mesh is a ``torch.distributed.device_mesh.DeviceMesh`` over the
ranks of the default process group, one process per card, so a JAX
device is a rank. Rank order is row-major over the plan's shape and the
mesh dims carry the reference's axis names, tp innermost (its
collectives are the most frequent, so they go to the nearest ranks) and
dp outermost.

``placements`` turns a reference-style spec (one axis name, a tuple of
names, or None per tensor dim) into DTensor placements on a given mesh:
``Shard(dim)`` on the mesh dims the spec names, ``Replicate()`` on the
others; ``distribute_tree`` places a nested dict of tensors by such
placements. ``compute_mesh`` is the sub-mesh of the dims larger than
one, which the sharded trainer and generator place their tensors on.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

# Canonical logical axis names used across the workload stack.
DATA_AXIS = "dp"
FSDP_AXIS = "fsdp"
TENSOR_AXIS = "tp"
SEQUENCE_AXIS = "sp"
EXPERT_AXIS = "ep"
PIPELINE_AXIS = "pp"
DCN_AXIS = "dcn"


@dataclass(frozen=True)
class MeshPlan:
    """A factorization of the device count over logical axes."""

    dp: int = 1
    fsdp: int = 1
    tp: int = 1
    sp: int = 1

    @property
    def size(self) -> int:
        return self.dp * self.fsdp * self.tp * self.sp

    def axis_names(self) -> tuple[str, ...]:
        # tp is the innermost (fastest-varying) axis, sp just outside it.
        return (DATA_AXIS, FSDP_AXIS, SEQUENCE_AXIS, TENSOR_AXIS)

    def shape(self) -> tuple[int, ...]:
        return (self.dp, self.fsdp, self.sp, self.tp)


def _factor(n: int, max_tp: int) -> MeshPlan:
    """Default factorization: tp = largest power of two <= max_tp dividing
    n, fsdp takes the next factor up to 8, dp absorbs the rest."""
    tp = 1
    while tp * 2 <= max_tp and n % (tp * 2) == 0:
        tp *= 2
    rem = n // tp
    fsdp = 1
    while fsdp * 2 <= 8 and rem % (fsdp * 2) == 0:
        fsdp *= 2
    dp = rem // fsdp
    return MeshPlan(dp=dp, fsdp=fsdp, tp=tp)


def plan_for(n_devices: int, tp: int | None = None, sp: int = 1) -> MeshPlan:
    """Pick a MeshPlan for n_devices, honoring an explicit tp if given."""
    if tp is None:
        plan = _factor(n_devices // sp, max_tp=4)
        return MeshPlan(dp=plan.dp, fsdp=plan.fsdp, tp=plan.tp, sp=sp)
    if n_devices % (tp * sp):
        raise ValueError(
            f"{n_devices} devices not divisible by tp={tp}*sp={sp}")
    plan = _factor(n_devices // (tp * sp), max_tp=1)
    return MeshPlan(dp=plan.dp * plan.fsdp, fsdp=1, tp=tp, sp=sp)


def _ranks(ranks: Sequence[int] | None) -> list[int]:
    return list(range(dist.get_world_size()) if ranks is None else ranks)


def _device_type() -> str:
    """The gang's device: the cards under NCCL, the host under gloo."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _mesh(ranks: list[int], shape: tuple[int, ...],
          names: tuple[str, ...]) -> DeviceMesh:
    if math.prod(shape) != len(ranks):
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} "
                         f"ranks, have {len(ranks)}")
    return DeviceMesh(_device_type(), torch.tensor(ranks).reshape(shape),
                      mesh_dim_names=names)


def build_mesh(plan: MeshPlan | None = None,
               ranks: Sequence[int] | None = None) -> DeviceMesh:
    """A (dp, fsdp, sp, tp) mesh over ``ranks`` (default: every rank of
    the default process group), shaped by ``plan`` (default:
    ``plan_for`` the rank count), row-major. Every rank of the group
    calls it."""
    ranks = _ranks(ranks)
    if plan is None:
        plan = plan_for(len(ranks))
    if plan.size != len(ranks):
        raise ValueError(
            f"mesh plan {plan.shape()} needs {plan.size} devices, have "
            f"{len(ranks)}")
    return _mesh(ranks, plan.shape(), plan.axis_names())


def build_multislice_mesh(num_slices: int, plan: MeshPlan | None = None,
                          ranks: Sequence[int] | None = None) -> DeviceMesh:
    """Multislice: a leading "dcn" dim over slices, each slice a
    contiguous block of ranks shaped by ``plan``. Only gradient data
    parallelism belongs on "dcn" (it crosses the data-center network)."""
    ranks = _ranks(ranks)
    if len(ranks) % num_slices:
        raise ValueError(
            f"{len(ranks)} devices not divisible by {num_slices} slices")
    per_slice = len(ranks) // num_slices
    if plan is None:
        plan = plan_for(per_slice)
    if plan.size != per_slice:
        raise ValueError(
            f"plan {plan.shape()} needs {plan.size} devices/slice, "
            f"have {per_slice}")
    return _mesh(ranks, (num_slices,) + plan.shape(),
                 (DCN_AXIS,) + plan.axis_names())


def build_pipeline_mesh(pp: int, dp: int | None = None,
                        ranks: Sequence[int] | None = None) -> DeviceMesh:
    """A ("pp", "dp") mesh for pipeline-parallel training, pp outermost:
    stage-to-stage activations tolerate the longer hops, while the dp
    replicas of one stage stay adjacent for the gradient all-reduce."""
    ranks = _ranks(ranks)
    if dp is None:
        if len(ranks) % pp:
            raise ValueError(f"{len(ranks)} devices not divisible by pp={pp}")
        dp = len(ranks) // pp
    if pp * dp != len(ranks):
        raise ValueError(
            f"pp={pp} x dp={dp} needs {pp * dp} devices, have {len(ranks)}")
    return _mesh(ranks, (pp, dp), (PIPELINE_AXIS, DATA_AXIS))


def build_expert_mesh(ep: int, dp: int | None = None,
                      ranks: Sequence[int] | None = None) -> DeviceMesh:
    """A ("dp", "ep") mesh for expert-parallel training, ep innermost: the
    per-layer all-reduce of the expert mixture stays among adjacent
    ranks, and each dp row is one whole set of experts."""
    ranks = _ranks(ranks)
    if dp is None:
        if len(ranks) % ep:
            raise ValueError(f"{len(ranks)} devices not divisible by ep={ep}")
        dp = len(ranks) // ep
    if dp * ep != len(ranks):
        raise ValueError(
            f"dp={dp} x ep={ep} needs {dp * ep} devices, have {len(ranks)}")
    return _mesh(ranks, (dp, ep), (DATA_AXIS, EXPERT_AXIS))


def mesh_from_topology(topology: str, tp: int | None = None) -> DeviceMesh:
    """A mesh for a topology string ("2x2x4") over the first ranks."""
    n = math.prod(int(d) for d in topology.split("x"))
    return build_mesh(plan_for(n, tp=tp), ranks=range(n))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """The size of the mesh dim named ``axis``; 1 when there is none."""
    names = mesh.mesh_dim_names or ()
    return mesh.size(names.index(axis)) if axis in names else 1


def compute_mesh(mesh: DeviceMesh) -> DeviceMesh:
    """The sub-mesh of ``mesh``'s dims larger than one (its first dim when
    none is). A dim of size one shards nothing, but DTensor's sharding
    propagation enumerates strategies over every mesh dim, so its cost
    grows fast with their number; the placements on the sub-mesh are
    the same layout."""
    names = tuple(n for n, size in zip(mesh.mesh_dim_names, mesh.shape)
                  if size > 1)
    return mesh[names or mesh.mesh_dim_names[:1]]


def batch_axes(batch: int, mesh: DeviceMesh) -> tuple:
    """The mesh axes a [batch, ...] tensor's dim 0 is split over: dp then
    fsdp, or none (the rows replicated) when the batch is one row or does
    not divide by their sizes. DTensor maps a size-1 dim to no dim of a
    view, so a sharded one-row batch cannot be reshaped (its matmuls
    flatten the batch); an uneven split would leave ranks without rows."""
    shards = axis_size(mesh, DATA_AXIS) * axis_size(mesh, FSDP_AXIS)
    return () if batch == 1 or batch % shards else (DATA_AXIS, FSDP_AXIS)


def placements(spec: Sequence, mesh: DeviceMesh) -> tuple:
    """DTensor placements on ``mesh`` of a reference-style spec: entry
    ``d`` names the mesh axis (or a tuple of axes, outer first) that
    tensor dim ``d`` is sharded over, or is None. Mesh dims the spec
    does not name are ``Replicate()``; axes the mesh lacks (``compute_mesh``
    drops those of size 1) shard nothing. DTensor lays a dim sharded over
    several mesh dims out in the mesh's dim order, so a tuple in another
    order raises rather than be silently reordered."""
    names = list(mesh.mesh_dim_names)
    by_axis = {}
    for dim, axes in enumerate(spec):
        present = [axis for axis in (axes if isinstance(axes, tuple)
                                     else (axes,)) if axis in names]
        if present != sorted(present, key=names.index):
            raise ValueError(
                f"tensor dim {dim} sharded over {tuple(present)}, outer "
                f"first: the mesh orders these axes "
                f"{tuple(sorted(present, key=names.index))}, and DTensor "
                "shards in the mesh's order")
        for axis in present:
            by_axis[axis] = Shard(dim)
    return tuple(by_axis.get(name, Replicate()) for name in names)


def distribute_tree(tree: dict, specs: dict, mesh: DeviceMesh) -> dict:
    """Every leaf of a nested dict of tensors (the same on every rank) as
    a DTensor on ``mesh`` with its placements from ``specs`` (the same
    keys): a copy, each rank keeping its own shard. Leaves that already
    are DTensors are kept."""
    def place(leaf, leaf_placements):
        if isinstance(leaf, DTensor):
            return leaf
        return distribute_tensor(leaf.detach().clone(), mesh,
                                 leaf_placements, src_data_rank=None)

    return {name: (distribute_tree(value, specs[name], mesh)
                   if isinstance(value, dict) else place(value, specs[name]))
            for name, value in tree.items()}
