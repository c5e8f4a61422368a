"""Chunked next-token cross-entropy: the logits never materialize.

The port of ``k8s_dra_driver_gpu_tpu/ops/xent.py``. The dense loss
computes fp32 logits ``[B, S, V]`` before the softmax, the largest buffer
of a training step at flagship shapes (B=4, S=4096, V=32k: 2.1 GB, and
as much again for its gradient). Here the sequence is walked in
``chunk``-position slices; each slice's logits are reduced to a summed
loss at once, and ``torch.utils.checkpoint`` drops them, so the backward
recomputes one slice's logits at a time. Peak logits memory is
``B * chunk * V`` for one extra lm_head matmul per chunk in the backward.

No kernel: the matmul and the logsumexp are plain PyTorch.
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint


def _chunk_loss(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor
                ) -> torch.Tensor:
    """Summed cross-entropy of one chunk: [B, C, D] x [D, V] -> scalar."""
    logits = (x @ w).float()  # [B, C, V]
    logz = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets[..., None]).squeeze(-1)
    return (logz - picked).sum()


def chunked_cross_entropy(
    hidden: torch.Tensor,
    lm_head: torch.Tensor,
    targets: torch.Tensor,
    *,
    chunk: int,
) -> torch.Tensor:
    """Mean cross-entropy of ``hidden @ lm_head`` against ``targets``.

    hidden:  [B, S, D] final (normed) hidden states, compute dtype.
    lm_head: [D, V] master weights (cast to hidden's dtype for the
             matmul; logits in fp32, as the dense path's
             ``(x @ lm_head).float()``).
    targets: [B, S] integer token ids.
    chunk:   sequence positions per chunk; must divide S.
    """
    B, S, _ = hidden.shape
    if S % chunk:
        raise ValueError(f"loss chunk {chunk} does not divide S={S}")
    w = lm_head.to(hidden.dtype)
    targets = targets.long()
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s0 in range(0, S, chunk):
        total = total + checkpoint(
            _chunk_loss, hidden[:, s0:s0 + chunk], w,
            targets[:, s0:s0 + chunk], use_reentrant=False)
    return total / (B * S)
