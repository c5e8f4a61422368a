"""Sequence-parallel (long-context) Llama training step.

The port of ``k8s_dra_driver_gpu_tpu/train/sp_train.py``: manual-SPMD
over a (dp, sp) mesh, as the reference's ``shard_map`` step is. Every
rank holds the parameters whole as plain tensors and trains on its batch
shard (dp) and its sequence chunk (sp); attention is ring attention (K/V
chunks rotating around the sp ranks) or Ulysses (two all-to-alls
re-sharding seq <-> heads), both from ``parallel/``. Everything else
(norms, MLPs, rope with GLOBAL positions) is local to the chunk.
Gradients and the loss are averaged over (dp, sp), so the update is the
same on every rank and the parameters stay replicated.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from ..models import llama
from ..ops.collectives import MeshAxis, mean_over
from ..parallel.mesh import DATA_AXIS, SEQUENCE_AXIS
from ..parallel.ring_attention import ring_attention
from ..parallel.ulysses import ulysses_attention
from .train import (AdamW, TrainState, dp_shard_layout, make_optimizer,
                    tree_leaves, tree_map)

ATTN_IMPLS = {
    "ring": ring_attention,
    "ulysses": ulysses_attention,
}


def make_sp_train(mesh, cfg: llama.LlamaConfig, attn: str = "ring",
                  optimizer: AdamW | None = None, dp_axis: str = DATA_AXIS,
                  sp_axis: str = SEQUENCE_AXIS):
    """Returns ``(init_fn, step_fn, batch_layout, place_params)``.

    Tokens are [B, n_sp * S_local + 1] (the +1 is the next-token target
    of the last position of the last chunk), split over ``dp_axis`` on
    the batch and replicated over ``sp_axis``: each rank slices its own
    chunk of inputs and targets, with rope positions
    ``sp_index * S_local + arange(S_local)``. The loss is over the full
    logits of the chunk (``llama.forward``), not the chunked loss, even
    when ``cfg.loss_chunk`` is set, as in the reference.

    ``place_params(params)``: a copy of the parameters (replicated).
    ``init_fn(params)``: a TrainState of the placed parameters and AdamW
    moments. ``batch_layout``: each process's [b, S + 1] rows -> this
    rank's dp shard of the global batch. ``step_fn(state, tokens) ->
    (state, loss)``, loss averaged over (dp, sp)."""
    if attn not in ATTN_IMPLS:
        raise ValueError(f"attn must be one of {sorted(ATTN_IMPLS)}")
    optimizer = optimizer or make_optimizer()
    dp, sp = MeshAxis(mesh, dp_axis), MeshAxis(mesh, sp_axis)
    attn_core = functools.partial(ATTN_IMPLS[attn], axis=sp, causal=True)

    def local_loss(params: dict, tokens: torch.Tensor) -> torch.Tensor:
        """The loss of this rank's (batch shard, sequence chunk) block."""
        s_local = (tokens.shape[1] - 1) // sp.size
        start = sp.index * s_local
        inputs = tokens[:, start:start + s_local]
        targets = tokens[:, start + 1:start + 1 + s_local].long()
        positions = start + torch.arange(s_local, device=tokens.device)[None]
        logits = llama.forward(params, inputs, cfg, attn_fn=attn_core,
                               positions=positions)
        return F.cross_entropy(logits.flatten(0, 1), targets.flatten())

    def place_params(params: dict) -> dict:
        return tree_map(lambda leaf: leaf.detach().clone(), params)

    def init_fn(params: dict) -> TrainState:
        params = place_params(params)
        return TrainState(params, optimizer.init(params), 0)

    def step_fn(state: TrainState, tokens: torch.Tensor):
        leaves = tree_leaves(state.params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = local_loss(state.params, tokens)
        grads = list(torch.autograd.grad(loss, leaves))
        # Equal shard sizes: the mean of the local gradients is the
        # gradient of the global mean loss.
        loss = loss.detach()
        mean_over([*grads, loss], [dp, sp])
        opt_state = optimizer.update(grads, state.opt_state, state.params)
        return TrainState(state.params, opt_state, state.step + 1), loss

    return init_fn, step_fn, dp_shard_layout(mesh, dp), place_params
