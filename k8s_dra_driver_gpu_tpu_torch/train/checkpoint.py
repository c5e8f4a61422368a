"""Training checkpoint and resume over ``torch.distributed.checkpoint``.

The port of ``k8s_dra_driver_gpu_tpu/train/checkpoint.py`` (orbax): a
gang-scheduled job saves on a cadence and restores on restart, each rank
writing and reading only its own shards. One directory a step,
``<directory>/<step>``, complete once DCP has written its ``.metadata``
there (the last file of a save); after each save, rank 0 prunes all but
the newest ``max_to_keep`` steps.

Orbax saves global arrays. DCP saves a DTensor as the global tensor it
is, but takes a plain tensor for one replicated on every rank and writes
one rank's copy. The manual-SPMD trainers hold *different* plain tensors
on different ranks: a pipeline stage's layer rows, an expert rank's
expert blocks. Given the mesh and the family's spec tree
(``pp_train.pp_param_specs``, ``llama_moe.param_specs``; the Adam
moments share the parameters' specs), the checkpointer wraps each such
leaf as ``DTensor.from_local`` with its placements, for the save and for
the load: the files hold the global ``[L, ...]`` and ``[L, E, ...]``
arrays, and a restore hands each rank its block again. The DTensor state
of ``make_sharded_train`` needs no specs.

A replicated leaf is not always the same on every rank. The MoE trainer
clips each ep rank's update by the norm of that rank's own gradients, as
the reference does inside its ``shard_map``, so from the second step its
replicated leaves and their moments drift apart across ep in the last
bits; saved once, a restore would hand every rank one rank's copy, and
the resumed run would leave the uninterrupted one. ``per_rank_axes``
names such mesh axes: each replicated leaf is then saved as the stack of
the ranks' copies along them (a leading dim of their size), so a restore
gives each rank its own copy back.
"""

from __future__ import annotations

import math
import os
import shutil

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import DTensor

from ..parallel.mesh import placements
from .train import TrainState

_COMPLETE = ".metadata"  # DCP writes it once every rank's data is down


class TrainCheckpointer:
    """Save and restore a ``TrainState`` under ``directory``.

    ``mesh`` and ``specs`` (given together) describe the plain local
    leaves of a manual-SPMD state: the spec of each parameter leaf, in
    the form ``parallel.mesh.placements`` reads (one axis name or None a
    dim; an empty spec for a replicated leaf); ``per_rank_axes``, the
    mesh axes over which the replicated leaves may differ (see above).
    Every rank of the default process group, when there is one, makes
    each call.
    """

    def __init__(self, directory: str, max_to_keep: int = 3, mesh=None,
                 specs: dict | None = None,
                 per_rank_axes: tuple[str, ...] = ()):
        if (mesh is None) != (specs is None):
            raise ValueError("mesh and specs describe the local leaves "
                             "together: give both or neither")
        if per_rank_axes and mesh is None:
            raise ValueError("per_rank_axes name axes of the mesh")
        self.directory = os.path.abspath(directory)
        self.max_to_keep = max_to_keep
        self._mesh, self._specs = mesh, specs
        # A replicated leaf's copies, stacked along a leading dim sharded
        # over these axes.
        self._stack = [] if mesh is None else [
            axis for axis in per_rank_axes
            if axis in mesh.mesh_dim_names
            and mesh.size(mesh.mesh_dim_names.index(axis)) > 1]
        os.makedirs(self.directory, exist_ok=True)

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def all_steps(self) -> list[int]:
        """The complete steps on disk, oldest first."""
        return sorted(int(name) for name in os.listdir(self.directory)
                      if name.isdigit() and os.path.exists(os.path.join(
                          self.directory, name, _COMPLETE)))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def nbytes(self, step: int) -> int:
        """The bytes step ``step`` takes on disk."""
        path = self._step_dir(step)
        return sum(os.path.getsize(os.path.join(path, name))
                   for name in os.listdir(path))

    def _wrap(self, leaf: torch.Tensor, spec) -> torch.Tensor:
        """A view of ``leaf`` that DCP saves and loads as its global
        tensor: a DTensor as it is, a plain leaf sharded by ``spec`` as a
        DTensor over this rank's block, a replicated one as the stack of
        the ranks' copies over the per-rank axes or, without such axes,
        as it is."""
        leaf = leaf.detach()
        if isinstance(leaf, DTensor) or spec is None:
            return leaf
        places = placements(spec, self._mesh)
        if not any(p.is_shard() for p in places):
            if not self._stack:
                return leaf
            # One copy a rank of the per-rank axes: [1, ...] locally.
            leaf = leaf.unsqueeze(0)
            places = placements(((*self._stack,),), self._mesh)
        shape = list(leaf.shape)
        for mesh_dim, place in enumerate(places):
            if place.is_shard():
                shape[place.dim] *= self._mesh.size(mesh_dim)
        if not leaf.is_contiguous():
            raise ValueError("a sharded leaf must be contiguous: the load "
                             "writes into its storage")
        stride = [math.prod(shape[d + 1:]) for d in range(len(shape))]
        return DTensor.from_local(leaf, self._mesh, places,
                                  run_check=False, shape=torch.Size(shape),
                                  stride=tuple(stride))

    def _tree(self, tree: dict, specs: dict | None) -> dict:
        return {name: (self._tree(value, None if specs is None
                                  else specs[name])
                       if isinstance(value, dict)
                       else self._wrap(value, None if specs is None
                                       else specs[name]))
                for name, value in tree.items()}

    def _state_dict(self, state: TrainState) -> dict:
        """Views of the state's tensors (the counters as int64 tensors),
        nested as DCP flattens them."""
        return {
            "params": self._tree(state.params, self._specs),
            "opt_state": {
                "count": torch.tensor(state.opt_state["count"],
                                      dtype=torch.int64),
                "mu": self._tree(state.opt_state["mu"], self._specs),
                "nu": self._tree(state.opt_state["nu"], self._specs),
            },
            "step": torch.tensor(state.step, dtype=torch.int64),
        }

    def save(self, step: int, state: TrainState, wait: bool = True) -> bool:
        """Write ``state`` as step ``step``; False (and nothing written)
        when that step is already on disk. Saves are synchronous: the
        call returns once the step is complete, whatever ``wait`` (the
        reference's argument) says."""
        del wait
        if step in self.all_steps():
            return False
        with torch.no_grad():
            dcp.save(self._state_dict(state),
                     checkpoint_id=self._step_dir(step))
        if dist.is_initialized():
            dist.barrier()
        if not dist.is_initialized() or dist.get_rank() == 0:
            for old in self.all_steps()[:-self.max_to_keep]:
                shutil.rmtree(self._step_dir(old), ignore_errors=True)
        return True

    def restore(self, state_like: TrainState,
                step: int | None = None) -> TrainState:
        """Load step ``step`` (default: the latest) into the tensors of
        ``state_like`` (a TrainState of the same trainer, mesh and
        shapes: from its ``init_fn``) and return it with the saved
        counters. Raises FileNotFoundError when there is no checkpoint."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint to restore")
        state_dict = self._state_dict(state_like)
        with torch.no_grad():
            dcp.load(state_dict, checkpoint_id=self._step_dir(step))
        opt_state = dict(state_like.opt_state,
                         count=int(state_dict["opt_state"]["count"]))
        return TrainState(state_like.params, opt_state,
                          int(state_dict["step"]))

    def close(self) -> None:
        """Nothing to release (saves are synchronous); kept for the
        reference's interface."""
