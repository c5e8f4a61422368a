"""Llama training step, on one device or sharded over a mesh.

The port of ``k8s_dra_driver_gpu_tpu/train/train.py``: ``TrainState``,
``make_optimizer``, ``loss_fn``, ``train_step``, ``scanned_train_step``
(K steps a call), ``make_sharded_train`` and
``make_scanned_sharded_train``. The parameters are
the model's nested dict of fp32 master tensors; the optimizer is
``optax.chain(clip_by_global_norm(1.0), adamw(...))`` written out with
optax's arithmetic (stock ``torch.optim.AdamW`` differs: it decays the
weights before the Adam step, and keeps no bf16 first moment). Unlike
the JAX step, which returns new arrays, the update runs in place on the
parameter and moment tensors: a flagship state is ~10 GB, and a second
copy of it buys nothing in eager PyTorch.

Sharded training places every leaf as a DTensor by
``llama.param_specs`` and the batch by ``llama.batch_spec`` (or over the
mesh axes ``batch_axes`` names, as the reference's builders take them:
multislice passes ("dcn", "dp", "fsdp")); the same
``train_step`` then runs on DTensors, whose sharding propagation plays
the part of XLA's and inserts the collectives. Its gradients come back
with placements of DTensor's choosing (often ``Partial``) and are
redistributed to their parameter's before the optimizer, so the Adam
moments stay sharded like their parameter.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import NamedTuple

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from ..models import llama
from ..ops.collectives import MeshAxis
from ..ops.xent import chunked_cross_entropy
from ..parallel.mesh import (DATA_AXIS, FSDP_AXIS, axis_size, compute_mesh,
                             distribute_tree, placements)

# The mesh axes the batch dim shards over unless ``batch_axes`` says
# otherwise (``llama.batch_spec``).
DEFAULT_BATCH_AXES = (DATA_AXIS, FSDP_AXIS)


class TrainState(NamedTuple):
    params: dict
    opt_state: dict
    step: int


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a nested dict, depth first in insertion order."""
    if isinstance(tree, dict):
        return [leaf for value in tree.values() for leaf in tree_leaves(value)]
    return [tree]


def tree_map(fn, tree):
    """A nested dict of the same keys with ``fn`` applied to each tensor."""
    if isinstance(tree, dict):
        return {name: tree_map(fn, value) for name, value in tree.items()}
    return fn(tree)


# optax.chain(clip_by_global_norm(1.0), adamw(lr, b1=0.9, b2=0.95,
# weight_decay=0.1)) with optax's eps=1e-8, eps_root=0.
MAX_NORM, B1, B2, EPS, WEIGHT_DECAY = 1.0, 0.9, 0.95, 1e-8, 0.1


@dataclass(frozen=True)
class AdamW:
    """Global-norm clipping then AdamW, with optax's arithmetic.

    Per leaf, with g the (clipped) gradient and t the step count:
    mu = (1 - b1) g + b1 mu, nu = (1 - b2) g^2 + b2 nu,
    u = (mu / (1 - b1^t)) / (sqrt(nu / (1 - b2^t)) + eps),
    p += -lr (u + weight_decay p) on every leaf. A bf16 ``mu_dtype``
    stores the first moment rounded after the step, which uses it in
    fp32, as ``optax.scale_by_adam`` does under ``jit``; there b1 meets
    the bf16 moment as a weakly typed scalar and is rounded to bf16
    (0.8984375), so it is here too.
    """

    lr: float = 3e-4
    mu_dtype: torch.dtype | None = None

    def init(self, params: dict) -> dict:
        return {
            "count": 0,
            "mu": tree_map(lambda p: torch.zeros_like(
                p, dtype=self.mu_dtype or p.dtype), params),
            "nu": tree_map(torch.zeros_like, params),
        }

    @torch.no_grad()
    def update(self, grads: list[torch.Tensor], opt_state: dict,
               params: dict) -> dict:
        """Apply one step in place to ``params`` and the moments of
        ``opt_state``; ``grads`` are in ``tree_leaves(params)`` order
        and are overwritten. Returns the new optimizer state."""
        leaves = tree_leaves(params)
        if len(grads) != len(leaves):
            raise ValueError(f"{len(grads)} gradients for {len(leaves)} "
                             "parameters")
        norm = torch.stack([g.float().square().sum() for g in grads]).sum()
        norm = norm.sqrt()
        # Clip as optax does, g / norm * max_norm, and only when
        # norm >= max_norm; chosen on the device, with no host sync.
        keep = norm < MAX_NORM
        div = torch.where(keep, 1.0, norm)
        mul = torch.where(keep, 1.0, MAX_NORM)
        count = opt_state["count"] + 1
        # 1 - decay^count in fp32, as optax computes it.
        bc1, bc2 = ((1 - torch.tensor(decay, dtype=torch.float32) ** count)
                    .item() for decay in (B1, B2))
        mus, nus = tree_leaves(opt_state["mu"]), tree_leaves(opt_state["nu"])
        for p, g, mu, nu in zip(leaves, grads, mus, nus):
            g.div_(div).mul_(mul)
            b1 = torch.tensor(B1, dtype=mu.dtype).item()
            m = g.mul(1 - B1).add_(mu.float().mul_(b1))
            nu.mul_(B2).add_(g.square_().mul_(1 - B2))
            u = m.div(bc1)
            u.div_(nu.div(bc2).sqrt_().add_(EPS))
            u.add_(p.mul(WEIGHT_DECAY)).mul_(-self.lr)
            p.add_(u)
            mu.copy_(m)
        return {"count": count, "mu": opt_state["mu"],
                "nu": opt_state["nu"]}


def make_optimizer(lr: float = 3e-4,
                   mu_dtype: torch.dtype | None = None) -> AdamW:
    """AdamW with global-norm clipping at 1.0 (b1 .9, b2 .95, eps 1e-8,
    weight decay .1 on every leaf). ``mu_dtype=torch.bfloat16`` stores
    the first moment in bf16, freeing 2 bytes a parameter."""
    return AdamW(lr=lr, mu_dtype=mu_dtype)


def loss_fn(params: dict, tokens: torch.Tensor,
            cfg: llama.LlamaConfig) -> torch.Tensor:
    """Next-token cross-entropy over [B, S] token ids.

    ``cfg.loss_chunk > 0`` takes the chunked loss (ops/xent.py): the
    [B, S, V] logits never materialize.
    """
    targets = tokens[:, 1:].long()
    if cfg.loss_chunk:
        hidden = llama.forward_hidden(params, tokens[:, :-1], cfg)
        return chunked_cross_entropy(
            hidden, params["lm_head"], targets, chunk=cfg.loss_chunk)
    logits = llama.forward(params, tokens[:, :-1], cfg)
    return F.cross_entropy(logits.flatten(0, 1), targets.flatten())


def train_step(state: TrainState, tokens: torch.Tensor, *,
               cfg: llama.LlamaConfig, optimizer: AdamW
               ) -> tuple[TrainState, torch.Tensor]:
    """One optimizer step on ``tokens`` [B, S + 1]. The parameters and
    moments are updated in place; returns the state and the loss
    (detached, not synchronised; a plain tensor on sharded parameters
    too)."""
    leaves = tree_leaves(state.params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    sharded = isinstance(leaves[0], DTensor)
    # On DTensor parameters, plain tensors made inside the model
    # (positions, masks, rope tables) count as replicated, which they
    # are: every rank builds the same ones.
    with implicit_replication() if sharded else contextlib.nullcontext():
        loss = loss_fn(state.params, tokens, cfg)
        grads = list(torch.autograd.grad(loss, leaves))
        if sharded:
            grads = [g.redistribute(p.device_mesh, p.placements)
                     for g, p in zip(grads, leaves)]
            loss = loss.full_tensor()
        opt_state = optimizer.update(grads, state.opt_state, state.params)
    return TrainState(state.params, opt_state, state.step + 1), loss.detach()


def scanned_train_step(state: TrainState, tokens_kbs: torch.Tensor, *,
                       cfg: llama.LlamaConfig, optimizer: AdamW
                       ) -> tuple[TrainState, torch.Tensor]:
    """K optimizer steps in one call: ``tokens_kbs`` is [K, B, S + 1];
    returns the state and the K losses stacked. Nothing waits for the
    device between steps (the reference runs them under one
    ``lax.scan``)."""
    losses = []
    for k in range(tokens_kbs.shape[0]):
        state, loss = train_step(state, tokens_kbs[k], cfg=cfg,
                                 optimizer=optimizer)
        losses.append(loss)
    return state, torch.stack(losses)


def _batch_layout(mesh, batch_axes: tuple[str, ...], batch_dim: int):
    """Each process's local rows -> the global batch as a DTensor: the
    rows of every rank of the default group, concatenated in rank order
    along ``batch_dim`` (as ``make_array_from_process_local_data`` takes
    each process's rows), then sharded along ``batch_dim`` over the mesh
    axes ``batch_axes``, in that order (axes the mesh dropped for being
    of size 1 shard nothing), and replicated over the others."""
    spec = [None] * (batch_dim + 1)
    spec[batch_dim] = tuple(batch_axes)
    batch_placements = placements(spec, mesh)
    shards = math.prod(axis_size(mesh, axis) for axis in batch_axes)
    device = torch.device(mesh.device_type, torch.cuda.current_device()
                          if mesh.device_type == "cuda" else None)

    def layout(local) -> DTensor:
        local = torch.as_tensor(local).to(device)
        gathered = [torch.empty_like(local)
                    for _ in range(dist.get_world_size())]
        dist.all_gather(gathered, local.contiguous())
        rows = torch.cat(gathered, dim=batch_dim)
        if rows.shape[batch_dim] % shards:
            raise ValueError(
                f"global batch {rows.shape[batch_dim]} not divisible by "
                f"{' * '.join(batch_axes)} = {shards}")
        return distribute_tensor(rows, mesh, batch_placements,
                                 src_data_rank=None)

    return layout


def dp_shard_layout(mesh, dp: MeshAxis):
    """The batch layout of the manual-SPMD trainers: each process's local
    rows -> this rank's plain rows of the global batch, which is the rows
    of every rank of the default group concatenated in rank order (as
    ``_batch_layout`` lays it; nothing is gathered in a gang of one),
    split over the ``dp`` axis and replicated over the others."""
    device = torch.device(mesh.device_type, torch.cuda.current_device()
                          if mesh.device_type == "cuda" else None)

    def layout(local) -> torch.Tensor:
        local = torch.as_tensor(local).to(device).contiguous()
        rows = local
        if dist.get_world_size() > 1:
            gathered = [torch.empty_like(local)
                        for _ in range(dist.get_world_size())]
            dist.all_gather(gathered, local)
            rows = torch.cat(gathered)
        if rows.shape[0] % dp.size:
            raise ValueError(f"global batch {rows.shape[0]} not divisible "
                             f"by {dp.name}={dp.size}")
        return rows.chunk(dp.size)[dp.index].contiguous()

    return layout


def make_sharded_train(mesh, cfg: llama.LlamaConfig,
                       optimizer: AdamW | None = None,
                       batch_axes: tuple[str, ...] | None = None):
    """Returns ``(init_fn, step_fn, batch_layout, place_params)`` over
    ``mesh`` (a ``parallel.mesh`` DeviceMesh).

    ``batch_axes`` overrides the mesh axes the batch dim shards over, in
    order (None: dp then fsdp): a multislice mesh passes ("dcn", "dp",
    "fsdp"), so only gradient data parallelism crosses the slices. An
    order that is not the mesh's raises (DTensor lays a dim sharded over
    several mesh dims out in mesh order).

    ``place_params(params)``: the parameters (the same on every rank) as
    DTensors placed by ``llama.param_specs``. ``init_fn(params)``: a
    TrainState of placed parameters and Adam moments of the same
    placements. ``batch_layout(local_rows)``: each process's [b, S + 1]
    rows -> the global [b * processes, S + 1] batch, sharded over the
    batch axes. ``step_fn(state, tokens) -> (state, loss)``: ``train_step`` on
    the placed state. Over a mesh of more than one device "auto"
    attention becomes einsum (``llama.pin_auto_attn_for_pjit``); on one
    device the flash kernels run on the local tensors."""
    optimizer = optimizer or make_optimizer()
    missing = [axis for axis in batch_axes or ()
               if axis not in mesh.mesh_dim_names]
    if missing:
        raise ValueError(f"batch_axes {tuple(batch_axes)}: mesh has no axis "
                         f"{', '.join(missing)} (axes "
                         f"{tuple(mesh.mesh_dim_names)})")
    cfg = llama.pin_auto_attn_for_pjit(cfg, mesh)
    cmesh = compute_mesh(mesh)
    specs = llama.param_specs(cfg, cmesh)

    def place_params(params: dict) -> dict:
        return distribute_tree(params, specs, cmesh)

    def init_fn(params: dict) -> TrainState:
        params = place_params(params)
        return TrainState(params, optimizer.init(params), 0)

    def step_fn(state: TrainState, tokens: DTensor):
        return train_step(state, tokens, cfg=cfg, optimizer=optimizer)

    return (init_fn, step_fn,
            _batch_layout(cmesh, batch_axes or DEFAULT_BATCH_AXES,
                          batch_dim=0),
            place_params)


def make_scanned_sharded_train(mesh, cfg: llama.LlamaConfig,
                               optimizer: AdamW | None = None,
                               batch_axes: tuple[str, ...] | None = None):
    """``make_sharded_train`` with K steps a call (``scanned_train_step``):
    ``step_fn(state, tokens[K, B, S + 1]) -> (state, losses[K])``. The
    batch layout takes each process's [K, b, S + 1] rows; the leading K
    dim is not sharded and each step's batch shards as in the unscanned
    path (over ``batch_axes``)."""
    optimizer = optimizer or make_optimizer()
    cfg = llama.pin_auto_attn_for_pjit(cfg, mesh)
    init_fn, _, _, place_params = make_sharded_train(mesh, cfg, optimizer,
                                                     batch_axes)
    cmesh = compute_mesh(mesh)

    def step_fn(state: TrainState, tokens_kbs: DTensor):
        return scanned_train_step(state, tokens_kbs, cfg=cfg,
                                  optimizer=optimizer)

    return (init_fn, step_fn,
            _batch_layout(cmesh, batch_axes or DEFAULT_BATCH_AXES,
                          batch_dim=1),
            place_params)
