"""Llama-3 in PyTorch: the JAX reference model, for inference and
training.

Parameters are a plain nested dict of tensors with the reference's
layer-stacked ``[L, ...]`` leaves, so one set of weights (``convert.py``)
drives both packages. The layer ``scan`` is a Python loop over the
stacked leaves, each layer wrapped in the ``cfg.remat`` checkpointing
policy; every matmul runs in ``cfg.dtype``, with the weights cast at use
as the reference does.
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import local_map
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

from ..ops import resolve_device
from ..ops.attention import attention
from ..parallel.mesh import (DATA_AXIS, FSDP_AXIS, TENSOR_AXIS, axis_size,
                             placements)


@dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 128_256
    d_model: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 8
    d_ff: int = 14_336
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    # "auto": the flash kernel on long CUDA shapes, einsum elsewhere.
    attn_impl: str = "auto"
    # Training loss over loss_chunk-position chunks without the [B, S, V]
    # logits (ops/xent.py); 0 = dense loss. Must divide the train S.
    loss_chunk: int = 0
    # Checkpointing of each layer in training (apply_remat): "full"
    # recomputes the layer in the backward, "dots" keeps the matmul
    # outputs and recomputes the rest, "none" keeps every activation.
    remat: str = "full"

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @staticmethod
    def llama3_8b() -> "LlamaConfig":
        return LlamaConfig()

    @staticmethod
    def flagship() -> "LlamaConfig":
        """The reference's flagship shape: head_dim 128, 2:1 GQA, SwiGLU
        ratio 3, 12 layers, d_model 2048."""
        return LlamaConfig(
            vocab_size=32_768,
            d_model=2048,
            n_layers=12,
            n_heads=16,
            n_kv_heads=8,
            d_ff=6144,
            loss_chunk=128,
        )

    @staticmethod
    def tiny() -> "LlamaConfig":
        """Test config: same structure, toy sizes."""
        return LlamaConfig(
            vocab_size=256,
            d_model=64,
            n_layers=2,
            n_heads=4,
            n_kv_heads=2,
            d_ff=128,
        )


def pin_auto_attn_for_pjit(cfg: LlamaConfig, mesh) -> LlamaConfig:
    """attn_impl "auto" -> "einsum" over a mesh of more than one device.

    The reference's rule, kept under its name: a Pallas call inside a jit
    with sharded operands does not partition, so over a multi-device mesh
    "auto" would gather whole arrays on every device at exactly the long
    sequences where it picks the kernel; sharded long context belongs to
    the sequence-parallel trainers. A one-device mesh keeps "auto" (there
    the kernel runs on the local tensors) and an explicit "flash" is the
    caller's choice."""
    if cfg.attn_impl == "auto" and mesh.size() > 1:
        return dataclasses.replace(cfg, attn_impl="einsum")
    return cfg


# Per-leaf specs, the reference's PartitionSpecs: one mesh axis (or None)
# per tensor dim; layer-stacked leaves lead with None for the layer dim.
# fsdp shards the long matmul dim, tp the head/ff dim.
_PARAM_SPECS = {
    "embed": (TENSOR_AXIS, FSDP_AXIS),
    "layers": {
        "attn_norm": (None, None),
        "wq": (None, FSDP_AXIS, TENSOR_AXIS),
        "wk": (None, FSDP_AXIS, TENSOR_AXIS),
        "wv": (None, FSDP_AXIS, TENSOR_AXIS),
        "wo": (None, TENSOR_AXIS, FSDP_AXIS),
        "mlp_norm": (None, None),
        "w_gate": (None, FSDP_AXIS, TENSOR_AXIS),
        "w_up": (None, FSDP_AXIS, TENSOR_AXIS),
        "w_down": (None, TENSOR_AXIS, FSDP_AXIS),
    },
    "final_norm": (None,),
    "lm_head": (FSDP_AXIS, TENSOR_AXIS),
}


def param_specs(cfg: LlamaConfig, mesh) -> dict:
    """DTensor placements of every parameter leaf on ``mesh``:
    ``Shard(dim)`` on the fsdp and tp mesh dims for the dim the reference
    shards over them, ``Replicate()`` on every other mesh dim."""
    del cfg

    def walk(spec):
        if isinstance(spec, dict):
            return {name: walk(value) for name, value in spec.items()}
        return placements(spec, mesh)

    return walk(_PARAM_SPECS)


def batch_spec(mesh) -> tuple:
    """Placements of a [B, ...] batch on ``mesh``: dim 0 sharded over dp
    then fsdp, replicated over the other mesh dims."""
    return placements(((DATA_AXIS, FSDP_AXIS),), mesh)


def init(cfg: LlamaConfig, generator: torch.Generator,
         device: torch.device | str | None = None,
         dtype: torch.dtype = torch.float32) -> dict:
    """Random parameters: N(0, 1) / sqrt(fan_in) matrices and unit norm
    scales, drawn in fp32 on ``device`` (the card unless "cpu" is asked
    for; the generator must live there) and cast to ``dtype`` leaf by
    leaf, so the peak is one fp32 leaf above the result. The draws
    differ from JAX's ``init`` for the same seed."""
    device = resolve_device(device)
    d, h, kv, hd, f = (
        cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
    )
    L = cfg.n_layers

    def dense(*shape):
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.div_(fan_in ** 0.5).to(dtype)

    def ones(*shape):
        return torch.ones(shape, device=device, dtype=dtype)

    return {
        "embed": dense(cfg.vocab_size, d),
        "layers": {
            "attn_norm": ones(L, d),
            "wq": dense(L, d, h * hd),
            "wk": dense(L, d, kv * hd),
            "wv": dense(L, d, kv * hd),
            "wo": dense(L, h * hd, d),
            "mlp_norm": ones(L, d),
            "w_gate": dense(L, d, f),
            "w_up": dense(L, d, f),
            "w_down": dense(L, f, d),
        },
        "final_norm": ones(d),
        "lm_head": dense(d, cfg.vocab_size),
    }


def layer_params(params: dict, i: int) -> dict:
    """Layer ``i``'s slice of the stacked ``[L, ...]`` leaves (views)."""
    return {name: leaf[i] for name, leaf in params["layers"].items()}


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float
             ) -> torch.Tensor:
    # Normalize in fp32, cast to the compute dtype, then scale in it.
    xf = x.float()
    rms = torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (xf * rms).to(x.dtype) * scale.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float
         ) -> torch.Tensor:
    """Rotary embeddings over the last dim of [..., S, H, hd]:
    split-half rotation with fp32 angles."""
    hd = x.shape[-1]
    freqs = theta ** (-torch.arange(0, hd // 2, dtype=torch.float32,
                                    device=x.device) / (hd // 2))
    angles = positions[..., :, None].float() * freqs  # [.., S, hd/2]
    cos = torch.cos(angles)[..., :, None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x.chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def attention_block(cfg: LlamaConfig, x: torch.Tensor, p: dict,
                    positions: torch.Tensor, attn_fn=None) -> torch.Tensor:
    """rms-norm -> q/k/v -> rope -> attention -> wo residual.

    ``attn_fn(q, k, v)`` overrides the attention core (the seam a
    sequence-parallel caller swaps ring or Ulysses attention into).
    """
    dt = cfg.dtype
    B, S, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    a = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    q = (a @ p["wq"].to(dt)).reshape(B, S, h, hd)
    k = a @ p["wk"].to(dt)
    v = a @ p["wv"].to(dt)
    split = _tp_splits_kv_heads(k, kv)
    if split:
        k, v = (_over_tp(t, Replicate()) for t in (k, v))
    k, v = k.reshape(B, S, kv, hd), v.reshape(B, S, kv, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    if split:
        k, v = (_as_q_heads(t, h) for t in (k, v))
    if attn_fn is not None:
        attn = attn_fn(q, k, v)
    else:
        attn = attention(q, k, v, causal=True, impl=cfg.attn_impl)
    return x + attn.reshape(B, S, h * hd) @ p["wo"].to(dt)


def _tp_splits_kv_heads(t: torch.Tensor, kv: int) -> bool:
    """Whether ``t``, a DTensor of [B, S, kv * hd] k or v columns, has
    them sharded over more tp ranks than there are kv heads (or over a tp
    that does not divide them): then a rank holds part of a head, which
    DTensor cannot view as [B, S, kv, hd] (XLA pads instead)."""
    return (isinstance(t, DTensor)
            and kv % axis_size(t.device_mesh, TENSOR_AXIS) != 0)


def _over_tp(t: DTensor, placement) -> DTensor:
    """``t`` redistributed to ``placement`` on the tp mesh dim, its other
    placements kept."""
    tp = t.device_mesh.mesh_dim_names.index(TENSOR_AXIS)
    return t.redistribute(t.device_mesh, [
        placement if dim == tp else kept
        for dim, kept in enumerate(t.placements)])


def _as_q_heads(t: DTensor, h: int) -> DTensor:
    """Whole kv heads [B, S, kv, hd], replicated over tp, repeated to one
    a q head [B, S, h, hd] and split by heads over tp: each tp rank keeps
    the kv head of each of its own q heads (a local slice, no
    collective)."""
    B, S, kv, hd = t.shape
    t = t.unsqueeze(3).expand(B, S, kv, h // kv, hd).reshape(B, S, h, hd)
    return _over_tp(t, Shard(2))


def _mlp(cfg: LlamaConfig, x: torch.Tensor, p: dict) -> torch.Tensor:
    """SwiGLU on the rms-normed input; returns the residual update."""
    dt = cfg.dtype
    m = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    gate = F.silu(m @ p["w_gate"].to(dt))
    up = m @ p["w_up"].to(dt)
    return (gate * up) @ p["w_down"].to(dt)


def _layer(cfg: LlamaConfig, x: torch.Tensor, p: dict,
           positions: torch.Tensor, attn_fn=None) -> torch.Tensor:
    """One transformer block: [B, S, D] -> [B, S, D]."""
    x = attention_block(cfg, x, p, positions, attn_fn)
    return x + _mlp(cfg, x, p)


_MATMULS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.bmm.default})


def _save_matmuls(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of "dots": keep matmul outputs."""
    del ctx, args, kwargs
    return (CheckpointPolicy.MUST_SAVE if op in _MATMULS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _dots_contexts():
    return create_selective_checkpoint_contexts(_save_matmuls)


def apply_remat(body, remat: str):
    """Wrap a layer body per the ``cfg.remat`` policy (see LlamaConfig).

    "full" and "dots" checkpoint the body (non-reentrant
    ``torch.utils.checkpoint``); they take effect only where autograd
    records, so inference runs the body as is.
    """
    if remat == "none":
        return body
    if remat == "full":
        context_fn = None
    elif remat == "dots":
        context_fn = _dots_contexts
    else:
        raise ValueError(f"unknown remat policy {remat!r}")

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return body(*args)
        if context_fn is None:
            return checkpoint(body, *args, use_reentrant=False)
        return checkpoint(body, *args, use_reentrant=False,
                          context_fn=context_fn)

    return wrapped


def vocab_shard_lookup(table: torch.Tensor, ids: torch.Tensor,
                       vocab_start: int) -> torch.Tensor:
    """Rows of ``ids`` from one shard of an embedding table, the shard
    holding vocab rows ``vocab_start`` .. ``+ table.shape[0] - 1``: ids
    outside it give zero rows, so summing the shards' rows gives
    ``full_table[ids]``, and each shard's gradient is its own rows'."""
    local = ids - vocab_start
    inside = (local >= 0) & (local < table.shape[0])
    rows = table[local.clamp(0, table.shape[0] - 1)]
    return rows.masked_fill(~inside[..., None], 0)


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """``table[tokens]``; vocab-parallel on a DTensor table.

    As the reference communicates for its ``P(tp, fsdp)`` table: the
    fsdp-sharded D columns are gathered, as every fsdp weight is before
    use, and the vocab rows stay sharded over tp. Each rank looks up the
    ids in its own vocab shard (``vocab_shard_lookup`` through
    ``local_map``); the rows are partial sums over tp, and one all-reduce
    over tp lays them out like the ids. No rank holds the whole vocab, and
    the backward is local too: each rank gets its own shard's gradient
    (partial over the mesh dims the ids are split over). Without a tp
    axis (``compute_mesh`` drops size-1 dims) no all-reduce is issued. A
    vocab that does not divide by tp is refused."""
    if not isinstance(table, DTensor):
        return table[tokens]
    mesh = table.device_mesh
    names = list(mesh.mesh_dim_names)
    tp = names.index(TENSOR_AXIS) if TENSOR_AXIS in names else None
    shards = axis_size(mesh, TENSOR_AXIS)
    if table.shape[0] % shards:
        raise ValueError(f"vocab {table.shape[0]} not divisible by "
                         f"tp={shards}: the vocab-parallel lookup needs "
                         "equal shards")
    vocab_start = (0 if tp is None else mesh.get_local_rank(TENSOR_AXIS)
                   * (table.shape[0] // shards))
    # Ids and rows split like the tokens on every dim but tp, where the
    # ids are whole and the rows partial; the table's gradient is partial
    # over the dims that split the ids.
    ids_in = [Replicate() if d == tp or not p.is_shard() else p
              for d, p in enumerate(tokens.placements)]
    rows_out = [Partial() if d == tp else p for d, p in enumerate(ids_in)]
    table_in = placements((TENSOR_AXIS, None), mesh)
    table_grad = [p if d == tp else (Partial() if ids_in[d].is_shard()
                                     else Replicate())
                  for d, p in enumerate(table_in)]
    lookup = local_map(
        functools.partial(vocab_shard_lookup, vocab_start=vocab_start),
        out_placements=rows_out, in_placements=(table_in, ids_in),
        in_grad_placements=(table_grad, ids_in), device_mesh=mesh,
        redistribute_inputs=True)
    return lookup(table, tokens).redistribute(mesh, tokens.placements)


def forward_hidden(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
                   attn_fn=None, positions: torch.Tensor | None = None
                   ) -> torch.Tensor:
    """Token ids [B, S] -> final-normed hidden states [B, S, D].

    The lm_head projection is split out so the training loss can run it
    chunked (``ops/xent.chunked_cross_entropy``); ``forward`` composes
    the two. ``positions`` overrides the rope positions ([1, S] or
    [B, S]).
    """
    x = embed_tokens(params["embed"].to(cfg.dtype), tokens)
    if positions is None:
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
    body = apply_remat(
        lambda h, p: _layer(cfg, h, p, positions, attn_fn), cfg.remat)
    for i in range(cfg.n_layers):
        x = body(x, layer_params(params, i))
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def forward(params: dict, tokens: torch.Tensor, cfg: LlamaConfig,
            attn_fn=None, positions: torch.Tensor | None = None
            ) -> torch.Tensor:
    """Token ids [B, S] -> logits [B, S, V] (fp32 logits)."""
    x = forward_hidden(params, tokens, cfg, attn_fn, positions)
    return (x @ params["lm_head"].to(cfg.dtype)).float()
