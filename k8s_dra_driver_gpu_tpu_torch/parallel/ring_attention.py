"""Ring attention: sequence-parallel causal attention.

The port of ``k8s_dra_driver_gpu_tpu/parallel/ring_attention.py``. The
sequence dim is sharded over an "sp" mesh dim: each rank holds a local
q/k/v shard, the K/V chunks rotate around the ring (``ring_shift``, the
reference's ``ppermute``), and every rank accumulates its local queries'
attention with online log-sum-exp merging. Causality across shards:
chunk c (sequence offset c * S_local) is attended under a full, partial
or empty mask, computed from its position relative to the local q shard.

Plain tensor code in fp32 (einsum and an lse merge), as the reference
writes it outside any Pallas kernel.
"""

from __future__ import annotations

import math

import torch

from ..ops.collectives import MeshAxis, ring_shift

NEG_INF = -1e30


def _chunk_attention(q, k, v, q_offset: int, k_offset: int, causal: bool):
    """fp32 partial attention of a local q shard against one k/v chunk.

    Returns (o unnormalised [B,S,H,hd], m [B,S,H,1], l [B,S,H,1]).
    """
    B, Sq, H, hd = q.shape
    Sk, K = k.shape[1], k.shape[2]
    qg = q.reshape(B, Sq, K, H // K, hd).float()
    s = torch.einsum("bqkgh,bskh->bkgqs", qg, k.float()) / math.sqrt(hd)
    if causal:
        q_pos = q_offset + torch.arange(Sq, device=q.device)[:, None]
        k_pos = k_offset + torch.arange(Sk, device=q.device)[None, :]
        s = torch.where(q_pos >= k_pos, s, NEG_INF)
    # m and l are scaling factors that cancel exactly in the final o / l,
    # so they carry NO gradient: m is detached whole. (Detaching it only
    # inside exp(s - m) while _merge differentiates its alphas through
    # the raw m leaves a spurious term that corrupts dq and dk.) The
    # clamp keeps exp() finite on fully masked rows.
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF / 2).detach()
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, v.float())
    o = o.reshape(B, H, Sq, hd).transpose(1, 2)
    m = m.reshape(B, H, Sq, 1).transpose(1, 2)
    l = l.reshape(B, H, Sq, 1).transpose(1, 2)
    return o, m, l


def _merge(acc, new):
    """Online log-sum-exp merge of two partial attention results."""
    o_a, m_a, l_a = acc
    o_n, m_n, l_n = new
    m = torch.maximum(m_a, m_n)
    alpha_a = torch.exp(m_a - m)
    alpha_n = torch.exp(m_n - m)
    return o_a * alpha_a + o_n * alpha_n, m, l_a * alpha_a + l_n * alpha_n


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   axis: MeshAxis, causal: bool = True) -> torch.Tensor:
    """q [B, S_local, H, hd], k and v [B, S_local, K, hd]: this rank's
    sequence shard along ``axis``; returns its rows of the attention over
    the whole sequence, in q's dtype.

    n steps of chunk attention and merge: after i rotations the rank
    holds the chunk of rank (my - i) mod n. The accumulator starts from
    the first chunk, which is what the reference's merge into
    (0, NEG_INF, 0) gives, and the rotation after the last chunk, whose
    result the reference drops, is not made."""
    n, my = axis.size, axis.index
    S = q.shape[1]
    kv = torch.stack([k, v])
    acc = None
    for i in range(n):
        if i:
            kv = ring_shift(kv, axis)
        src = (my - i) % n
        new = _chunk_attention(q, kv[0], kv[1], my * S, src * S, causal)
        acc = new if acc is None else _merge(acc, new)
    o, _, l = acc
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def make_ring_attention(mesh, axis_name: str = "sp", causal: bool = True):
    """[B, S, H, hd] attention with S sharded over ``axis_name`` of
    ``mesh``. Returns ``(fn, place)``: ``place(x)`` keeps the rank's
    sequence shard of a whole [B, S, ., hd] tensor, ``fn(q, k, v)`` takes
    and returns local shards."""
    axis = MeshAxis(mesh, axis_name)

    def fn(q, k, v):
        return ring_attention(q, k, v, axis, causal=causal)

    def place(x: torch.Tensor) -> torch.Tensor:
        return x.chunk(axis.size, dim=1)[axis.index].contiguous()

    return fn, place
