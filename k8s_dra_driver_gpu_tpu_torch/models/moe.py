"""Mixture-of-Experts FFN with expert parallelism over a mesh axis.

The port of ``k8s_dra_driver_gpu_tpu/models/moe.py``: the reference's
"dense dispatch", in which every rank runs its local experts over ALL the
tokens it holds and a capacity-free weighted combine mixes them. The
router and the combine run in fp32 (softmax stability), the expert
matmuls in the model dtype. Each expert is a non-gated FFN,
``silu(x W_in) W_out``, not the dense model's SwiGLU.

With the expert dim sharded over an "ep" axis, each rank's output is the
partial mixture of its expert block; ``all_reduce_sum`` over the axis
completes it (the reference's ``psum``; no all-to-all dispatch).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops import resolve_device
from ..ops.collectives import MeshAxis, all_reduce_sum


def init_moe(generator: torch.Generator, d_model: int, d_ff: int,
             n_experts: int, device: torch.device | str | None = None
             ) -> dict:
    """Random fp32 router and expert weights, N(0, 1) / sqrt(fan_in), on
    ``device`` (the card unless "cpu" is asked for; the generator must
    live there). The draws differ from JAX's ``init_moe``."""
    device = resolve_device(device)

    def randn(*shape):
        return torch.randn(shape, generator=generator, device=device,
                           dtype=torch.float32)

    return {
        "router": randn(d_model, n_experts).div_(d_model ** 0.5),
        "w_in": randn(n_experts, d_model, d_ff).div_(d_model ** 0.5),
        "w_out": randn(n_experts, d_ff, d_model).div_(d_ff ** 0.5),
    }


def moe_param_specs(axis_name: str = "ep") -> dict:
    """The reference's specs: the router replicated, the expert weights
    sharded on their expert dim over ``axis_name``."""
    return {
        "router": (None, None),
        "w_in": (axis_name, None, None),
        "w_out": (axis_name, None, None),
    }


def moe_ffn(params: dict, x: torch.Tensor, top_k: int = 2,
            dtype: torch.dtype = torch.bfloat16,
            expert_offset: int = 0) -> tuple[torch.Tensor, torch.Tensor]:
    """Dense-dispatch MoE: x [B, S, D] -> (out [B, S, D] in x's dtype,
    aux scalar fp32).

    Routing is over the GLOBAL expert count (the replicated router);
    ``params["w_in"]`` / ``["w_out"]`` may hold only a block of
    ``E_local`` experts starting at ``expert_offset``: the combine
    weights are sliced to that block, so summing the blocks' outputs
    gives the whole mixture.

    aux is the switch-transformer load-balancing loss,
    ``E * sum(load * importance) / top_k``, from the replicated router:
    the same on every block, so it is never summed over them. Only the
    SET of top-k experts matters (the combine sums over the k), so
    ``torch.topk``'s order among ties is as good as ``lax.top_k``'s.
    """
    n_experts = params["router"].shape[1]
    e_local = params["w_in"].shape[0]
    B, S, D = x.shape
    probs = torch.softmax(x.float() @ params["router"], dim=-1)  # [B,S,E]
    top_p, top_idx = torch.topk(probs, top_k, dim=-1)
    # Renormalised combine weights as a dense [B, S, E] mask.
    weights = top_p / top_p.sum(-1, keepdim=True)
    combine = torch.zeros_like(probs).scatter(-1, top_idx, weights)
    combine = combine[..., expert_offset:expert_offset + e_local]
    # Every local expert over every token: one [B*S, D] x [D, E_local*F]
    # product in, one batched product out to y [E_local, B*S, D].
    w_in = params["w_in"].to(dtype)
    xd = x.to(dtype).reshape(B * S, D)
    h = F.silu(xd @ w_in.permute(1, 0, 2).reshape(D, -1))
    h = h.view(B * S, e_local, -1).transpose(0, 1)
    y = torch.bmm(h, params["w_out"].to(dtype))
    out = torch.einsum("etd,te->td", y.float(), combine.reshape(B * S, -1))

    top_mask = F.one_hot(top_idx, n_experts).float()  # [B,S,k,E]
    load = top_mask.sum(2).mean((0, 1))  # fraction of tokens (x top_k)
    importance = probs.mean((0, 1))
    aux = n_experts * (load * importance).sum() / top_k
    return out.reshape(B, S, D).to(x.dtype), aux


def make_sharded_moe(mesh, axis_name: str = "ep", top_k: int = 2,
                     dtype: torch.dtype = torch.bfloat16):
    """Expert-parallel MoE over the ``axis_name`` dim of ``mesh``: each
    rank runs its expert block over all its tokens and ``all_reduce_sum``
    completes the mixture. Returns ``(fn, place)``: ``place(params)``
    keeps the rank's expert block of whole parameters (the same on every
    rank); ``fn(placed, x)`` takes the tokens whole on every rank of the
    axis and returns ``(out, aux)``, both the same on every rank."""
    axis = MeshAxis(mesh, axis_name)

    def place(params: dict) -> dict:
        e_local = params["w_in"].shape[0] // axis.size
        lo = axis.index * e_local
        return {name: (leaf if name == "router"
                       else leaf[lo:lo + e_local].clone())
                for name, leaf in params.items()}

    def fn(params: dict, x: torch.Tensor):
        offset = axis.index * params["w_in"].shape[0]
        out, aux = moe_ffn(params, x, top_k=top_k, dtype=dtype,
                           expert_offset=offset)
        return all_reduce_sum(out, axis), aux

    return fn, place
