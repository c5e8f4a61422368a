"""MoE-Llama: the Llama architecture with a mixture-of-experts FFN.

The port of ``k8s_dra_driver_gpu_tpu/models/llama_moe.py``. The
attention half of every layer is the dense model's
(``llama.attention_block``); the SwiGLU FFN is replaced by the
dense-dispatch MoE layer (``models/moe.py``) with a replicated router
and expert weights shardable over an "ep" mesh dim.

Training is manual-SPMD over a (dp, ep) mesh, as the reference's
``shard_map`` step is: every rank holds plain local tensors (the
replicated leaves whole, its own ``[L, E/ep, ...]`` expert blocks) and
runs the whole model on its dp shard of the tokens with its expert
block; ``all_reduce_sum`` over ep completes each layer's mixture before
the residual add. Gradients are averaged by hand, as the reference
averages them (see ``make_moe_train``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

from ..ops import resolve_device
from ..ops.collectives import MeshAxis, all_reduce_sum, mean_over
from ..parallel.mesh import DATA_AXIS, EXPERT_AXIS
from ..train.train import (AdamW, TrainState, dp_shard_layout, make_optimizer,
                           tree_leaves, tree_map)
from . import llama
from .moe import moe_ffn

# The expert-sharded leaves of ``params["layers"]``: dim 1 is the expert.
EXPERT_LEAVES = ("w_in", "w_out")


@dataclass(frozen=True)
class LlamaMoEConfig:
    vocab_size: int = 32_768
    d_model: int = 1024
    n_layers: int = 8
    n_heads: int = 16
    n_kv_heads: int = 8
    d_ff: int = 2048  # per expert
    n_experts: int = 8
    top_k: int = 2
    aux_coef: float = 0.01  # load-balancing loss weight
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def tiny() -> "LlamaMoEConfig":
        return LlamaMoEConfig(
            vocab_size=256, d_model=64, n_layers=2, n_heads=4,
            n_kv_heads=2, d_ff=96, n_experts=4, top_k=2,
        )

    def as_llama(self) -> llama.LlamaConfig:
        """The dense view of the shared attention stack."""
        return llama.LlamaConfig(
            vocab_size=self.vocab_size, d_model=self.d_model,
            n_layers=self.n_layers, n_heads=self.n_heads,
            n_kv_heads=self.n_kv_heads, d_ff=self.d_ff,
            rope_theta=self.rope_theta, norm_eps=self.norm_eps,
            dtype=self.dtype, attn_impl=self.attn_impl,
        )


def init(cfg: LlamaMoEConfig, generator: torch.Generator,
         device: torch.device | str | None = None) -> dict:
    """Random fp32 parameters, N(0, 1) / sqrt(fan_in) matrices and unit
    norm scales, on ``device`` (the card unless "cpu" is asked for; the
    generator must live there). The draws differ from JAX's ``init``."""
    device = resolve_device(device)
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    f, E, L = cfg.d_ff, cfg.n_experts, cfg.n_layers

    def dense(*shape):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.div_(fan_in ** 0.5)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=torch.float32)

    return {
        "embed": dense(cfg.vocab_size, d),
        "layers": {
            "attn_norm": ones(L, d),
            "wq": dense(L, d, h * hd),
            "wk": dense(L, d, kv * hd),
            "wv": dense(L, d, kv * hd),
            "wo": dense(L, h * hd, d),
            "mlp_norm": ones(L, d),
            "router": dense(L, d, E),
            "w_in": dense(L, E, d, f),
            "w_out": dense(L, E, f, d),
        },
        "final_norm": ones(d),
        "lm_head": dense(d, cfg.vocab_size),
    }


def param_specs(cfg: LlamaMoEConfig, ep_axis: str = EXPERT_AXIS) -> dict:
    """The reference's specs: the expert leaves shard their E dim over
    ``ep_axis``, every other leaf is replicated."""
    del cfg
    layers = {name: () for name in ("attn_norm", "wq", "wk", "wv", "wo",
                                    "mlp_norm", "router")}
    layers.update({name: (None, ep_axis, None, None)
                   for name in EXPERT_LEAVES})
    return {"embed": (), "layers": layers, "final_norm": (), "lm_head": ()}


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaMoEConfig,
            expert_offset: int = 0, attn_fn=None,
            positions: torch.Tensor | None = None,
            ep_axis: MeshAxis | None = None
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Token ids [B, S] -> (logits [B, S, V] fp32, aux scalar).

    With expert-sharded weights, ``expert_offset`` marks the local block
    and ``ep_axis`` is the axis it is sharded over: each layer's mixture
    is then partial, and ``all_reduce_sum`` over the axis completes it
    before the residual add. Every layer is recomputed in the backward
    (full remat, the reference's ``jax.checkpoint`` of the scan body);
    aux is averaged over the layers."""
    x = llama.embed_tokens(params["embed"].to(cfg.dtype), tokens)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]

    def body(x, lp):
        # The attention half is the dense model's.
        x = llama.attention_block(cfg, x, lp, positions, attn_fn)
        m = llama.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        moe_params = {"router": lp["router"], "w_in": lp["w_in"],
                      "w_out": lp["w_out"]}
        out, aux = moe_ffn(moe_params, m, top_k=cfg.top_k, dtype=cfg.dtype,
                           expert_offset=expert_offset)
        if ep_axis is not None:
            # A partial mixture over the local expert block: complete it
            # before the residual add.
            out = all_reduce_sum(out, ep_axis)
        return x + out, aux

    body = llama.apply_remat(body, "full")
    aux_sum = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        x, aux = body(x, llama.layer_params(params, i))
        aux_sum = aux_sum + aux
    x = llama.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(cfg.dtype)).float()
    return logits, aux_sum / cfg.n_layers


def loss_fn(params: dict, tokens: torch.Tensor, cfg: LlamaMoEConfig,
            expert_offset: int = 0,
            ep_axis: MeshAxis | None = None) -> torch.Tensor:
    """Mean next-token cross-entropy over the full fp32 logits of
    ``tokens`` [B, S + 1], plus ``aux_coef`` times the aux loss."""
    logits, aux = forward(params, tokens[:, :-1], cfg,
                          expert_offset=expert_offset, ep_axis=ep_axis)
    targets = tokens[:, 1:].long().flatten()
    xent = F.cross_entropy(logits.flatten(0, 1), targets)
    return xent + cfg.aux_coef * aux


def _expert_flags(params: dict) -> list[bool]:
    """For each leaf of ``params``, in ``tree_leaves`` order: is it an
    expert-sharded leaf."""
    marks = tree_map(lambda _: False, params)
    marks["layers"] = {name: name in EXPERT_LEAVES
                       for name in params["layers"]}
    return tree_leaves(marks)


def make_moe_train(mesh, cfg: LlamaMoEConfig, optimizer: AdamW | None = None,
                   dp_axis: str = DATA_AXIS, ep_axis: str = EXPERT_AXIS):
    """Returns ``(init_fn, step_fn, batch_layout, place_params)`` over a
    (dp, ep) mesh (``parallel.mesh.build_expert_mesh``), manual-SPMD like
    ``train/sp_train.py``.

    ``place_params(params)``: of whole parameters (the same on every
    rank), the replicated leaves and this rank's ``[L, E/ep, ...]``
    expert blocks. ``init_fn(params)``: a TrainState of the placed
    parameters and AdamW moments shaped like them. ``batch_layout``:
    each process's [b, S + 1] rows -> this rank's dp shard of the global
    batch (replicated over ep). ``step_fn(state, tokens) -> (state,
    loss)``, loss averaged over (dp, ep).

    Gradients, as the reference averages them: every ep rank computes
    the same loss (the in-layer all-reduce replicates the mixture), and
    the all-reduce's backward sums the ep ranks' equal cotangents, so
    each expert block gets ``n_ep`` times its gradient: it is averaged
    over dp and divided by ``n_ep``. The replicated leaves are averaged
    over (dp, ep), so their update is the same on every rank. The aux
    loss is each dp shard's own, as in the reference.

    The optimizer runs on the rank's local leaves: its clip norm is the
    norm of the rank's own gradients (the replicated leaves and its
    expert blocks), which is what ``optax.clip_by_global_norm`` computes
    inside the reference's ``shard_map``, not the norm over every
    expert."""
    optimizer = optimizer or make_optimizer()
    dp, ep = MeshAxis(mesh, dp_axis), MeshAxis(mesh, ep_axis)
    if cfg.n_experts % ep.size:
        raise ValueError(f"{cfg.n_experts} experts do not split over "
                         f"{ep_axis}={ep.size}")
    e_local = cfg.n_experts // ep.size
    offset = ep.index * e_local

    def place_params(params: dict) -> dict:
        layers = {name: (leaf[:, offset:offset + e_local].clone()
                         if name in EXPERT_LEAVES else leaf.clone())
                  for name, leaf in params["layers"].items()}
        return {name: layers if name == "layers" else leaf.clone()
                for name, leaf in params.items()}

    def init_fn(params: dict) -> TrainState:
        params = place_params(params)
        return TrainState(params, optimizer.init(params), 0)

    def step_fn(state: TrainState, tokens: torch.Tensor):
        leaves = tree_leaves(state.params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = loss_fn(state.params, tokens, cfg, offset, ep)
        grads = list(torch.autograd.grad(loss, leaves))
        experts = _expert_flags(state.params)
        mean_over([g for g, e in zip(grads, experts) if e], [dp])
        for g, e in zip(grads, experts):
            if e:
                g.div_(ep.size)
        mean_over([g for g, e in zip(grads, experts) if not e], [dp, ep])
        loss = loss.detach()
        mean_over([loss], [dp, ep])
        opt_state = optimizer.update(grads, state.opt_state, state.params)
        return TrainState(state.params, opt_state, state.step + 1), loss

    return init_fn, step_fn, dp_shard_layout(mesh, dp), place_params
