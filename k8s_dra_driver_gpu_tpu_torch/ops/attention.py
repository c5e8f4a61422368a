"""Attention ops, GQA-aware, causal.

``dot_product_attention`` is the plain formulation (the whole score
matrix at once); ``flash_attention`` is the hand-written Hopper kernel
behind the same signature. ``attention`` picks between them.
"""

from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.experimental import local_map

from ..parallel.mesh import TENSOR_AXIS, batch_axes, placements
from .flash_attention import HEAD_DIMS, flash_attention

# Sequence length at which "auto" switches from the plain einsum path to
# the flash kernel. This is the JAX reference's threshold, carried over
# unchanged; it has not yet been measured on this card.
FLASH_MIN_SEQ = 1024


def attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,  # [B, S, K, hd]
    causal: bool = True,
    impl: str = "auto",
) -> torch.Tensor:
    """Dispatch: the flash kernel on long CUDA shapes, einsum elsewhere.

    impl: "auto" | "flash" | "einsum". "flash" on CPU tensors computes
    the kernel's plain version.
    """
    if impl == "auto":
        # The kernel takes the head dims in HEAD_DIMS; small-head models
        # (tests, toy configs) and short sequences take einsum.
        impl = (
            "flash"
            if q.is_cuda and q.shape[-1] in HEAD_DIMS
            and q.shape[1] >= FLASH_MIN_SEQ
            else "einsum"
        )
    if impl not in ("flash", "einsum"):
        # A typo ("Flash", "pallas") must not silently take the einsum
        # path: at long S that materializes the O(S^2) scores the flash
        # kernel exists to avoid.
        raise ValueError(f"unknown attention impl {impl!r}: "
                         "want auto | flash | einsum")
    fn = flash_attention if impl == "flash" else dot_product_attention
    if isinstance(q, DTensor):
        return _local_attention(fn, q, k, v, causal)
    return fn(q, k, v, causal=causal)


def _local_attention(fn, q: DTensor, k: DTensor, v: DTensor,
                     causal: bool) -> DTensor:
    """``fn`` (the flash kernels or the einsum) on each rank's local q, k,
    v: batch sharded over dp and fsdp where it splits (``batch_axes``),
    heads over tp (whole kv heads a shard, or k and v split by q heads, so
    each rank's GQA groups are complete and the result is exact). Not
    DTensor's propagation through the einsum: it cannot flatten the
    tp-sharded head dim into the batched product on every torch release
    (2.11 refuses it)."""
    mesh = q.device_mesh
    # A list: local_map reads a tuple as one placement list per output.
    layout = list(placements((batch_axes(q.shape[0], mesh), None,
                              TENSOR_AXIS), mesh))
    def local(q, k, v):
        q, k, v = (_ContiguousGrad.apply(t) for t in (q, k, v))
        return fn(q, k, v, causal=causal)

    return local_map(local, out_placements=layout,
                     in_placements=(layout,) * 3, device_mesh=mesh,
                     redistribute_inputs=True)(q, k, v)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, with its gradient made contiguous. The einsum's
    gradients come out strided; leaving ``local_map`` as DTensors they
    meet the backward of the reshapes around attention, which DTensor
    runs as views of the local tensor, and a strided one cannot be
    viewed."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return grad.contiguous()


def dot_product_attention(
    q: torch.Tensor,  # [B, S, H, hd]
    k: torch.Tensor,  # [B, S, K, hd]
    v: torch.Tensor,  # [B, S, K, hd]
    causal: bool = True,
) -> torch.Tensor:
    """GQA attention: q-heads H grouped over kv-heads K (H % K == 0).

    Scores are computed in the input dtype, the softmax runs in fp32, and
    both matmuls stay in the input dtype.
    """
    B, S, H, hd = q.shape
    K = k.shape[2]
    qg = q.reshape(B, S, K, H // K, hd)
    # sqrt(hd) rounded to the input dtype, as the scores are divided in it.
    sqrt_hd = torch.tensor(float(hd)).sqrt().to(q.dtype).item()
    scores = (torch.einsum("bqkgh,bskh->bkgqs", qg, k) / sqrt_hd).float()
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        scores = scores.masked_fill(~mask, float("-inf"))
    weights = torch.softmax(scores, dim=-1).to(q.dtype)
    out = torch.einsum("bkgqs,bskh->bqkgh", weights, v)
    return out.reshape(B, S, H, hd)
