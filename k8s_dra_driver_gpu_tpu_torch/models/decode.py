"""Autoregressive decoding with a KV cache (the serving path).

- The cache is a pair of [L, B, max_len, K, hd] stacked tensors, as in
  the reference. Unlike the reference, whose arrays are immutable, it is
  written IN PLACE: ``prefill`` fills it layer by layer and
  ``decode_step`` writes one position per layer and advances ``length``.
  An in-place index write past ``max_len`` must never happen, so
  ``generate`` checks the budget first (``_check_budget``) and
  ``decode_step`` refuses a full cache.
- The layer ``scan`` is a Python loop over the stacked leaves.
- Prompt attention goes through ``ops.attention.attention`` (the flash
  kernel on long CUDA shapes); cached decode attention is plain tensor
  code, as it is plain einsum in the reference.
- Sampling: greedy, or temperature through a ``torch.Generator``; on
  DTensors the draw is made from the global batch (``_sample``).
- ``make_sharded_generate`` runs the same code on DTensors over a mesh:
  parameters placed by ``llama.param_specs``; the prompt, the cache and
  the tokens batch-sharded over dp and fsdp where the batch splits
  (``parallel.mesh.batch_axes``: not one row, a multiple of dp * fsdp),
  else replicated; the cache kv-head-sharded over tp; prefill and decode
  look tokens up through ``llama.embed_tokens``, vocab-parallel over
  tp.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch
import torch.distributed.tensor as dtensor
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import (implicit_replication,
                                                  local_map)

from ..ops.attention import attention
from ..parallel.mesh import (TENSOR_AXIS, axis_size, batch_axes,
                             compute_mesh, distribute_tree, placements)
from . import llama
from .llama import LlamaConfig, _mlp, layer_params, rms_norm, rope


@dataclass
class KVCache:
    k: torch.Tensor  # [L, B, max_len, K, hd] (cfg.dtype, or int8 codes)
    v: torch.Tensor  # [L, B, max_len, K, hd]
    length: int  # filled positions
    # int8 mode only: per-vector scales [L, B, max_len, K, 1] (bf16).
    k_scale: torch.Tensor | None = None
    v_scale: torch.Tensor | None = None

    @classmethod
    def empty(cls, cfg: LlamaConfig, batch: int, max_len: int,
              device: torch.device | str, quantized: bool = False,
              mesh=None) -> "KVCache":
        """A zero cache on ``device``; with a ``mesh``, DTensors on it
        laid out by ``cache_placements``."""
        shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)

        def zeros(shape, dtype):
            if mesh is None:
                return torch.zeros(shape, dtype=dtype, device=device)
            return dtensor.zeros(shape, dtype=dtype, device_mesh=mesh,
                                 placements=cache_placements(mesh, batch))

        if quantized:
            sshape = shape[:-1] + (1,)
            return cls(
                k=zeros(shape, torch.int8), v=zeros(shape, torch.int8),
                length=0,
                k_scale=zeros(sshape, torch.bfloat16),
                v_scale=zeros(sshape, torch.bfloat16),
            )
        return cls(k=zeros(shape, cfg.dtype), v=zeros(shape, cfg.dtype),
                   length=0)

    @property
    def max_len(self) -> int:
        return self.k.shape[2]

    @property
    def quantized(self) -> bool:
        return self.k_scale is not None


def _kv_spec(batch: int, mesh) -> tuple:
    """The spec of one layer's k/v [B, positions, K, ...]: batch over dp
    then fsdp where it splits (``batch_axes``), kv heads over tp (whole
    heads a shard)."""
    return (batch_axes(batch, mesh), None, TENSOR_AXIS)


def cache_placements(mesh, batch: int) -> tuple:
    """Placements of a [L, batch, max_len, K, ...] cache leaf on
    ``mesh``."""
    return placements((None,) + _kv_spec(batch, mesh), mesh)


def _quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-vector symmetric int8: x [..., hd] -> (int8 codes, scale
    [..., 1] bf16). Rounds half to even; codes are taken against the fp32
    scale, which is then stored in bf16."""
    xf = x.float()
    amax = xf.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax / 127.0, 1e-8)
    q = torch.clamp(torch.round(xf / scale), -127, 127)
    return q.to(torch.int8), scale.to(torch.bfloat16)


def _dequantize(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype
                ) -> torch.Tensor:
    return q.to(dtype) * scale.to(dtype)


def _project_qkv(cfg: LlamaConfig, x, lp, positions):
    B, S, _ = x.shape
    a = rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    q = (a @ lp["wq"].to(cfg.dtype)).reshape(
        B, S, cfg.n_heads, cfg.head_dim)
    k = (a @ lp["wk"].to(cfg.dtype)).reshape(
        B, S, cfg.n_kv_heads, cfg.head_dim)
    v = (a @ lp["wv"].to(cfg.dtype)).reshape(
        B, S, cfg.n_kv_heads, cfg.head_dim)
    return rope(q, positions, cfg.rope_theta), \
        rope(k, positions, cfg.rope_theta), v


def _attend_cached(cfg: LlamaConfig, q, ck, cv, valid_len: int,
                   k_scale=None, v_scale=None):
    """q [B,S,H,hd] vs cache ck/cv [B,max_len,K,hd]; positions >=
    valid_len are masked. int8 caches pass their scales and are
    dequantized here. On DTensors each rank attends with its local
    tensors (batch over dp and fsdp, whole kv heads over tp), as
    ``ops.attention`` does: DTensor cannot flatten the tp-sharded head
    dim into the einsum's batched product on every torch release."""
    del cfg
    if isinstance(q, DTensor):
        layout = list(placements(_kv_spec(q.shape[0], q.device_mesh),
                                 q.device_mesh))
        tensors = [t for t in (q, ck, cv, k_scale, v_scale) if t is not None]

        def local(*tensors):
            return _attend_cached(None, *tensors[:3], valid_len, *tensors[3:])

        return local_map(local, out_placements=layout,
                         in_placements=(layout,) * len(tensors),
                         device_mesh=q.device_mesh,
                         redistribute_inputs=True)(*tensors)
    if k_scale is not None:
        ck = _dequantize(ck, k_scale, q.dtype)
        cv = _dequantize(cv, v_scale, q.dtype)
    B, S, H, hd = q.shape
    K = ck.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    sqrt_hd = torch.tensor(float(hd)).sqrt().to(q.dtype).item()
    s = (torch.einsum("bqkgh,bskh->bkgqs", qg, ck) / sqrt_hd).float()
    max_len = ck.shape[1]
    mask = torch.arange(max_len, device=q.device) < valid_len
    s = s.masked_fill(~mask, float("-inf"))
    w = torch.softmax(s, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", w, cv)
    return out.reshape(B, S, H, hd)


def _write_kv(cache: KVCache, layer: int, pos: int, k, v):
    """Write k/v [B, S, K, hd] at positions [pos, pos + S) of ``layer``,
    quantizing for an int8 cache."""
    end = pos + k.shape[1]
    if end > cache.max_len:
        raise ValueError(f"KV write to positions [{pos}, {end}) exceeds "
                         f"max_len ({cache.max_len})")
    if isinstance(cache.k, DTensor):
        # Lay k/v out as the cache's layer slice and write each rank's
        # shard into its local cache.
        mesh = cache.k.device_mesh
        layout = placements(_kv_spec(k.shape[0], mesh), mesh)
        k, v = (t.redistribute(mesh, layout).to_local() for t in (k, v))
        cache = dataclasses.replace(cache, **{
            name: getattr(cache, name).to_local()
            for name in ("k", "v", "k_scale", "v_scale")
            if getattr(cache, name) is not None})
    if cache.quantized:
        k, ks = _quantize_kv(k)
        v, vs = _quantize_kv(v)
        cache.k_scale[layer, :, pos:end] = ks
        cache.v_scale[layer, :, pos:end] = vs
    cache.k[layer, :, pos:end] = k
    cache.v[layer, :, pos:end] = v


@torch.no_grad()
def prefill(
    params: dict, tokens: torch.Tensor, cfg: LlamaConfig, max_len: int,
    quantized: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """Process the prompt; returns (logits for the LAST position [B, V]
    fp32, a new cache filled up to tokens.shape[1]).

    Prompt attention uses the unquantized k/v, as in the reference; an
    int8 cache only changes what later decode steps read."""
    B, S = tokens.shape
    cache = KVCache.empty(cfg, B, max_len, tokens.device, quantized,
                          mesh=getattr(tokens, "device_mesh", None))
    x = llama.embed_tokens(params["embed"].to(cfg.dtype), tokens)
    positions = torch.arange(S, device=tokens.device)[None]
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        q, k, v = _project_qkv(cfg, x, lp, positions)
        _write_kv(cache, i, 0, k, v)
        attn = attention(q, k, v, causal=True, impl=cfg.attn_impl).reshape(
            B, S, cfg.n_heads * cfg.head_dim)
        x = x + attn @ lp["wo"].to(cfg.dtype)
        x = x + _mlp(cfg, x, lp)
    cache.length = S
    x = rms_norm(x[:, -1:], params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(cfg.dtype)).float()
    return logits[:, 0], cache


@torch.no_grad()
def decode_step(
    params: dict, cache: KVCache, token: torch.Tensor, cfg: LlamaConfig
) -> tuple[torch.Tensor, KVCache]:
    """One token [B] in -> next-token logits [B, V]; writes the token's
    k/v into ``cache`` in place, advances its length and returns it."""
    B = token.shape[0]
    pos = cache.length
    x = llama.embed_tokens(params["embed"].to(cfg.dtype),
                           token[:, None])  # [B, 1, D]
    positions = torch.full((B, 1), pos, dtype=torch.int32,
                           device=token.device)
    for i in range(cfg.n_layers):
        lp = layer_params(params, i)
        q, k, v = _project_qkv(cfg, x, lp, positions)
        _write_kv(cache, i, pos, k, v)
        sk = sv = None
        if cache.quantized:
            sk, sv = cache.k_scale[i], cache.v_scale[i]
        attn = _attend_cached(cfg, q, cache.k[i], cache.v[i], pos + 1,
                              k_scale=sk, v_scale=sv)
        attn = attn.reshape(B, 1, cfg.n_heads * cfg.head_dim)
        x = x + attn @ lp["wo"].to(cfg.dtype)
        x = x + _mlp(cfg, x, lp)
    cache.length = pos + 1
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ params["lm_head"].to(cfg.dtype)).float()
    return logits[:, 0], cache


def _check_budget(prompt_len: int, max_new_tokens: int, max_len: int):
    if prompt_len + max_new_tokens > max_len:
        # The cache is written in place: an overflow must be refused
        # before the first write, not found halfway through generation.
        raise ValueError(
            f"prompt ({prompt_len}) + max_new_tokens "
            f"({max_new_tokens}) exceeds max_len ({max_len})"
        )


def _sample(logits: torch.Tensor, temperature: float,
            generator: torch.Generator | None) -> torch.Tensor:
    """Next tokens [B] of logits [B, V]: argmax, or a draw at
    ``temperature`` from ``generator``.

    On DTensor logits the tokens are picked from the global batch: the
    logits are replicated on the mesh (all of them, whether they came
    sharded over the batch or the vocab, or as partial sums), every rank
    picks the same B tokens, its generator advancing alike on every rank,
    and keeps its own rows, batch-sharded over dp and fsdp. So the tokens
    are the plain path's for the same generator, and no two rows share
    their random numbers. A batch that does not split (``batch_axes``)
    stays replicated. (DTensor's own argmax over a vocab-sharded dim
    leaves the tokens ``Partial`` on some torch releases, 2.11 among
    them.)"""
    if isinstance(logits, DTensor):
        mesh = logits.device_mesh
        whole = logits.redistribute(
            mesh, [Replicate()] * mesh.ndim).to_local()
        tokens = _sample(whole, temperature, generator)
        return DTensor.from_local(
            tokens, mesh, [Replicate()] * mesh.ndim, run_check=False
        ).redistribute(mesh, placements(
            (batch_axes(tokens.shape[0], mesh),), mesh))
    if temperature <= 0:
        return torch.argmax(logits, dim=-1)
    probs = torch.softmax(logits / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


@torch.no_grad()
def generate(
    params: dict,
    prompt: torch.Tensor,  # [B, S] token ids
    cfg: LlamaConfig,
    max_new_tokens: int,
    max_len: int,
    temperature: float = 0.0,
    generator: torch.Generator | None = None,
    kv_quant: bool = False,
) -> torch.Tensor:
    """Greedy (temperature=0) or sampled generation; returns [B,
    max_new_tokens] int32 on the prompt's device.

    ``kv_quant=True`` stores the KV cache int8 with per-vector scales.
    Sampling draws from ``generator`` (on the prompt's device); its
    numbers differ from the reference's ``jax.random`` stream. The last
    sampled token is not fed back, so the cache holds
    ``S + max_new_tokens - 1`` positions at the end."""
    _check_budget(prompt.shape[1], max_new_tokens, max_len)
    logits, cache = prefill(params, prompt, cfg, max_len,
                            quantized=kv_quant)
    tokens = []
    for step in range(max_new_tokens):
        tokens.append(_sample(logits, temperature, generator).int())
        if step + 1 < max_new_tokens:
            logits, cache = decode_step(params, cache, tokens[-1], cfg)
    return torch.stack(tokens, dim=1)


def make_sharded_generate(
    mesh,
    cfg: LlamaConfig,
    max_new_tokens: int,
    max_len: int,
    temperature: float = 0.0,
    kv_quant: bool = False,
):
    """Serving over a (dp, fsdp, sp, tp) mesh: ``generate`` on DTensors.

    Returns ``(generate_fn(params, prompt, generator=None) -> [B, new],
    prompt_layout, place_params)``. ``place_params`` places the
    parameters (the same on every rank) by the training placements
    (``llama.param_specs``: fsdp over the long matmul dim, tp over
    heads/ff); ``prompt_layout`` places the global prompt (the same on
    every rank) batch-sharded over dp and fsdp, or replicated over them
    when it is one row or does not divide by dp * fsdp
    (``parallel.mesh.batch_axes``; the reference's dry run serves one row
    a device). The KV cache is laid out like the prompt's batch and
    kv-head-sharded over tp; each rank looks tokens up in its own vocab
    shard of the table (``llama.embed_tokens``), and DTensor inserts the
    tp reductions after wo and w_down. The tokens come back laid out like
    the prompt. Requires cfg.n_kv_heads % tp == 0 (each tp shard owns
    whole kv heads)."""
    tp = axis_size(mesh, TENSOR_AXIS)
    if cfg.n_kv_heads % tp:
        raise ValueError(
            f"n_kv_heads={cfg.n_kv_heads} not divisible by tp={tp}")
    cfg = llama.pin_auto_attn_for_pjit(cfg, mesh)
    cmesh = compute_mesh(mesh)
    specs = llama.param_specs(cfg, cmesh)

    def place_params(params: dict) -> dict:
        return distribute_tree(params, specs, cmesh)

    def prompt_layout(prompt: torch.Tensor) -> DTensor:
        layout = placements((batch_axes(prompt.shape[0], cmesh),), cmesh)
        return dtensor.distribute_tensor(prompt, cmesh, layout,
                                         src_data_rank=None)

    def generate_fn(params: dict, prompt: DTensor,
                    generator: torch.Generator | None = None) -> DTensor:
        _check_budget(prompt.shape[1], max_new_tokens, max_len)
        with implicit_replication():
            tokens = generate(params, prompt, cfg, max_new_tokens, max_len,
                              temperature, generator, kv_quant)
        return tokens.redistribute(cmesh, prompt.placements)

    return generate_fn, prompt_layout, place_params
