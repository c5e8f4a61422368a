"""Ulysses-style all-to-all sequence parallelism.

The port of ``k8s_dra_driver_gpu_tpu/parallel/ulysses.py``, the
complement to ring attention: instead of rotating K/V chunks, two
all-to-alls re-shard the activations between sequence-sharded and
head-sharded layouts around the attention core, so each rank computes
full-sequence attention for a subset of heads.

Layout (n ranks on the "sp" axis):
  in:  q/k/v [B, S/n, H, hd]  (sequence-sharded)
  mid: q/k/v [B, S, H/n, hd]  (head-sharded, after the all-to-all)
  out:       [B, S/n, H, hd]  (sequence-sharded, after the inverse)

q's H heads and k/v's K heads are split separately, so each rank's q
heads keep their GQA group's kv head.
"""

from __future__ import annotations

import torch

from ..ops.attention import attention
from ..ops.collectives import MeshAxis, all_to_all


def _seq_to_heads(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """[B, S/n, H, hd] -> [B, S, H/n, hd]: split the heads over the axis,
    gather the sequence."""
    return all_to_all(x, axis, split_dim=2, concat_dim=1)


def _heads_to_seq(x: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """[B, S, H/n, hd] -> [B, S/n, H, hd] (the inverse all-to-all)."""
    return all_to_all(x, axis, split_dim=1, concat_dim=2)


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      axis: MeshAxis, causal: bool = True,
                      impl: str = "auto") -> torch.Tensor:
    """q [B, S/n, H, hd], k and v [B, S/n, K, hd], this rank's sequence
    shard; returns its rows of the attention over the whole sequence.
    Between the all-to-alls each rank holds full-sequence q/k/v for its
    heads, the regime where ``attention``'s "auto" takes the flash kernel
    on the card (S >= FLASH_MIN_SEQ). Refuses a head count that the axis
    does not divide."""
    n, H, K = axis.size, q.shape[2], k.shape[2]
    if H % n or K % n:
        raise ValueError(
            f"Ulysses needs heads divisible by the sp size: H={H} K={K} n={n}")
    qh, kh, vh = (_seq_to_heads(t, axis) for t in (q, k, v))
    out = attention(qh, kh, vh, causal=causal, impl=impl)
    return _heads_to_seq(out, axis)


def make_ulysses_attention(mesh, axis_name: str = "sp", causal: bool = True,
                           impl: str = "auto"):
    """[B, S, H, hd] attention with S sharded over ``axis_name`` of
    ``mesh`` (the same surface as ``make_ring_attention``)."""
    axis = MeshAxis(mesh, axis_name)

    def fn(q, k, v):
        return ulysses_attention(q, k, v, axis, causal=causal, impl=impl)

    def place(x: torch.Tensor) -> torch.Tensor:
        return x.chunk(axis.size, dim=1)[axis.index].contiguous()

    return fn, place
