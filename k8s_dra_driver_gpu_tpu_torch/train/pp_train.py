"""Pipeline-parallel (GPipe schedule) Llama training step.

The port of ``k8s_dra_driver_gpu_tpu/train/pp_train.py``: manual-SPMD over
a ("pp", "dp") mesh (``parallel.mesh.build_pipeline_mesh``, pp outermost),
as the reference's ``shard_map`` step is. Each rank holds plain local
tensors: stage i of pp keeps rows [i L / pp, (i + 1) L / pp) of every
stacked ``[L, ...]`` layer leaf, and every other leaf (``embed``,
``final_norm``, ``lm_head``) whole. Microbatches stream through M + pp - 1
ticks; after each tick but the last the activation block moves one stage
on with ``ring_shift`` (the reference's ``ppermute`` around the pp ring),
whose backward rotates the cotangent back, so the backward streams stage
pp - 1 -> 0 through the same ranks: GPipe's forward-then-backward schedule
with bubble fraction (pp - 1) / (M + pp - 1). ``cfg.remat`` wraps each
layer, and autograd holds every tick's activations (GPipe's memory).

The update equals a plain synchronous step on the concatenated M * B
batch: GPipe is exact data parallelism over microbatches. The reference
runs the optimizer outside its ``shard_map``, on global arrays, so its
clip norm is that of the whole model's gradient; here each rank sums its
stage's squared layer gradients over pp and adds the replicated leaves'
once (``AdamW.update``'s ``sq_norm``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models import llama
from ..ops.collectives import MeshAxis, mean_over, ring_shift
from ..parallel.mesh import DATA_AXIS, PIPELINE_AXIS
from .train import (AdamW, TrainState, make_optimizer, squared_norm,
                    tree_leaves, tree_map)


def pp_param_specs(cfg: llama.LlamaConfig,
                   pp_axis: str = PIPELINE_AXIS) -> dict:
    """The reference's specs in the port's form (one mesh axis or None per
    tensor dim, read by ``parallel.mesh.placements``): the stacked layer
    leaves shard their leading (layer) dim over ``pp_axis``; every other
    leaf is replicated (an empty spec). The Adam moments share them."""
    del cfg
    return {name: ({leaf: (pp_axis,) for leaf in spec} if name == "layers"
                   else ())
            for name, spec in llama._PARAM_SPECS.items()}


def make_pp_train(mesh, cfg: llama.LlamaConfig, n_microbatches: int,
                  optimizer: AdamW | None = None,
                  pp_axis: str = PIPELINE_AXIS, dp_axis: str = DATA_AXIS):
    """Returns ``(init_fn, step_fn, batch_layout, place_params)``.

    ``place_params(params)``: of whole parameters (the same on every
    rank), this stage's ``[L / pp, ...]`` rows of the layer leaves and a
    copy of the others. ``init_fn(params)``: a TrainState of the placed
    parameters and AdamW moments shaped like them. ``batch_layout``: the
    global microbatches ``[M, B, S + 1]`` (the same on every rank, as the
    reference's batch is replicated over pp) -> this rank's dp column
    ``[M, B / dp, S + 1]``. ``step_fn(state, tokens) -> (state, loss)``,
    the loss of the whole M * B batch on every rank.

    Each tick, stage 0 takes microbatch ``min(t, M - 1)``'s embedding and
    the others the activation rotated in; the last stage adds the
    full-logit fp32 loss of microbatch ``m = t - (pp - 1)`` when ``0 <= m
    < M`` (not the chunked loss, even where ``cfg.loss_chunk`` is set, as
    in the reference). Gradients are averaged over dp, the replicated
    leaves' then summed over pp (only the stages that use them have a
    nonzero one), the loss summed over pp and averaged over dp.
    """
    pp, dp = MeshAxis(mesh, pp_axis), MeshAxis(mesh, dp_axis)
    M = n_microbatches
    if cfg.n_layers % pp.size:
        raise ValueError(f"n_layers={cfg.n_layers} not divisible by "
                         f"pp={pp.size}")
    if M < 1:
        raise ValueError("need at least one microbatch")
    optimizer = optimizer or make_optimizer()
    per_stage = cfg.n_layers // pp.size
    stage, last = pp.index, pp.size - 1
    first_layer = stage * per_stage
    device = torch.device(mesh.device_type, torch.cuda.current_device()
                          if mesh.device_type == "cuda" else None)
    dt = cfg.dtype

    def place_params(params: dict) -> dict:
        layers = {name: leaf[first_layer:first_layer + per_stage]
                  .detach().clone() for name, leaf in params["layers"].items()}
        return {name: layers if name == "layers" else leaf.detach().clone()
                for name, leaf in params.items()}

    def init_fn(params: dict) -> TrainState:
        params = place_params(params)
        return TrainState(params, optimizer.init(params), 0)

    def head_loss(params: dict, x: torch.Tensor,
                  targets: torch.Tensor) -> torch.Tensor:
        h = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = (h @ params["lm_head"].to(dt)).float()
        return F.cross_entropy(logits.flatten(0, 1), targets.flatten())

    def local_loss(params: dict, tokens: torch.Tensor):
        """(this rank's share of the mean loss, or None on a stage that
        scores none; the last tick's activation)."""
        inputs, targets = tokens[..., :-1], tokens[..., 1:].long()
        mb, S = inputs.shape[1], inputs.shape[2]
        positions = torch.arange(S, device=tokens.device)[None]
        body = llama.apply_remat(
            lambda h, p: llama._layer(cfg, h, p, positions), cfg.remat)
        # A tensor flag, not a Python branch: stage 0 drops the rotated-in
        # activation through torch.where, which keeps it in the graph, so
        # its backward sends a zero cotangent back as every other stage's
        # does (see step_fn).
        is_first = torch.tensor(stage == 0, device=tokens.device)
        x = torch.zeros((mb, S, cfg.d_model), dtype=dt, device=tokens.device)
        loss = None
        ticks = M + pp.size - 1
        for t in range(ticks):
            fresh = params["embed"].to(dt)[inputs[min(t, M - 1)]]
            x = torch.where(is_first, fresh, x)
            for i in range(per_stage):
                x = body(x, llama.layer_params(params, i))
            m = t - last
            if stage == last and 0 <= m < M:
                term = head_loss(params, x, targets[m])
                loss = term if loss is None else loss + term
            # The last tick's rotation would feed nothing: no rank makes it.
            if t < ticks - 1:
                x = ring_shift(x, pp)
        return (None if loss is None else loss / M), x

    def step_fn(state: TrainState, tokens: torch.Tensor):
        if tokens.ndim != 3 or tokens.shape[0] != M:
            raise ValueError(f"tokens must be [M={M}, B, S+1], got "
                             f"{list(tokens.shape)}")
        leaves = tree_leaves(state.params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        replicated = _replicated_flags(state.params)
        loss, x = local_loss(state.params, tokens)
        # Every rank must run the backward of every rotation, in the same
        # order, or a stage waits forever for a cotangent. The last tick's
        # activation is an output on every rank, with a zero cotangent, so
        # the backward of a stage that scores no loss still walks back
        # through its ticks, receiving each cotangent from the next stage.
        outputs, cotangents = [x], [torch.zeros_like(x)]
        if loss is not None:
            outputs.append(loss)
            cotangents.append(torch.ones_like(loss))
        grads = torch.autograd.grad(outputs, leaves, cotangents,
                                    allow_unused=True)
        # A stage that never reads a leaf (lm_head before the last stage)
        # has a zero gradient for it.
        grads = [torch.zeros_like(p) if g is None else g
                 for g, p in zip(grads, leaves)]
        loss = (torch.zeros((), dtype=torch.float32, device=x.device)
                if loss is None else loss.detach())
        with torch.no_grad():
            mean_over(grads, [dp])
            if pp.size > 1:
                for g, r in zip(grads, replicated):
                    if r:
                        dist.all_reduce(g, group=pp.group)
                dist.all_reduce(loss, group=pp.group)
            mean_over([loss], [dp])
            # The whole model's norm: every stage's layers, the replicated
            # leaves once.
            sq_layers = squared_norm([g for g, r in zip(grads, replicated)
                                      if not r])
            if pp.size > 1:
                dist.all_reduce(sq_layers, group=pp.group)
            sq_norm = sq_layers + squared_norm(
                [g for g, r in zip(grads, replicated) if r])
        opt_state = optimizer.update(grads, state.opt_state, state.params,
                                     sq_norm=sq_norm)
        return TrainState(state.params, opt_state, state.step + 1), loss

    def batch_layout(tokens) -> torch.Tensor:
        tokens = torch.as_tensor(tokens).to(device)
        if tokens.ndim != 3 or tokens.shape[1] % dp.size:
            raise ValueError(f"microbatches {list(tokens.shape)}: want [M, B, "
                             f"S+1] with B divisible by {dp.name}={dp.size}")
        return tokens.chunk(dp.size, dim=1)[dp.index].contiguous()

    return init_fn, step_fn, batch_layout, place_params


def _replicated_flags(params: dict) -> list[bool]:
    """For each leaf of ``params``, in ``tree_leaves`` order: is it
    replicated over pp (not a layer leaf)."""
    marks = tree_map(lambda _: True, params)
    marks["layers"] = tree_map(lambda _: False, params["layers"])
    return tree_leaves(marks)
