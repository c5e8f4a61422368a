"""Parity of the port's flash-attention backward (its plain version,
which CPU tensors take, behind the same autograd.Function the card runs)
with the JAX Pallas backward kernels in interpret mode."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.ops import flash_attention as jax_flash
from k8s_dra_driver_gpu_tpu_torch.ops import attention as pt_attention
from k8s_dra_driver_gpu_tpu_torch.ops import flash_attention as pt_flash

# fp32 on both sides; the two differ only in summation order.
TOL = 1e-5


def _inputs(B, S, H, K, hd, seed=0):
    """q, k, v and an output cotangent w, standard normal fp32."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, n, hd), dtype=np.float32)
                 for n in (H, K, K, H))


def _block(S):
    return 32 if S % 32 == 0 else 16


def _jax_grads(q, k, v, w, causal, dtype=jnp.float32):
    def loss(q, k, v):
        out = jax_flash.flash_attention(
            q, k, v, causal=causal, block_q=_block(q.shape[1]),
            block_k=_block(q.shape[1]), interpret=True, bwd_impl="flash")
        return jnp.sum(out.astype(jnp.float32) * w)

    grads = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a, dtype) for a in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32)) for g in grads]


def _pt_grads(q, k, v, w, causal, dtype=torch.float32):
    leaves = [torch.from_numpy(a).to(dtype).requires_grad_()
              for a in (q, k, v)]
    out = pt_flash.flash_attention(*leaves, causal=causal)
    (out.float() * torch.from_numpy(w)).sum().backward()
    return [leaf.grad for leaf in leaves]


CASES = [
    # (B, S, H, K, hd, causal)
    (2, 40, 4, 2, 16, True),    # group 2, ragged S (not a block multiple)
    (2, 40, 4, 2, 16, False),
    (1, 96, 4, 4, 32, True),    # group 1, S a block multiple
    (1, 96, 4, 4, 32, False),
    (1, 40, 8, 2, 16, True),    # group 4
    (1, 96, 8, 2, 32, False),
    (2, 96, 4, 2, 32, True),
    (1, 40, 4, 4, 16, False),
]


@pytest.mark.parametrize("B,S,H,K,hd,causal", CASES)
def test_grads_match_pallas_backward(B, S, H, K, hd, causal):
    q, k, v, w = _inputs(B, S, H, K, hd)
    want = _jax_grads(q, k, v, w, causal)
    got = _pt_grads(q, k, v, w, causal)
    for name, g, ref in zip("qkv", got, want):
        assert g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), ref, atol=TOL, rtol=TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("causal,H,K", [(True, 4, 2), (False, 4, 2),
                                        (True, 8, 2)])
def test_bwd_reference_matches_bwd_impl(causal, H, K):
    B, S, hd = 2, 40, 16
    q, k, v, g = _inputs(B, S, H, K, hd, seed=1)
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    out, lse = jax_flash._flash_attention_fwd_impl(
        jq, jk, jv, causal=causal, block_q=16, block_k=16, interpret=True)
    want = jax_flash._flash_attention_bwd_impl(
        jq, jk, jv, out, lse, jg, causal=causal, block_q=16, block_k=16,
        interpret=True)
    # The Pallas lse is [B*H, S_qpad, 1]; rows >= S are padding.
    pt_lse = torch.from_numpy(
        np.asarray(lse)[:, :S, 0].reshape(B, H, S).copy())
    args = [torch.from_numpy(np.array(a)) for a in (q, k, v, out)]
    got = pt_flash.flash_attention_bwd_reference(
        *args, pt_lse, torch.from_numpy(g), causal)
    for name, a, ref in zip("qkv", got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL, err_msg=f"d{name}")
    # flash_attention_bwd on CPU tensors is the same function.
    direct = pt_flash.flash_attention_bwd(*args, pt_lse,
                                          torch.from_numpy(g), causal)
    for a, b in zip(direct, got):
        torch.testing.assert_close(a, b, atol=0, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_grads_match_pallas_backward(causal):
    # bf16 inputs on both sides, fp32 scores, p and dS rounded to bf16 at
    # the same places; the two differ in summation order and exp, which
    # can move a bf16 rounding of p or dS by one ulp. The tolerance is a
    # few bf16 ulps (2^-8 relative) of the largest gradient entry.
    B, S, H, K, hd = 1, 40, 4, 2, 16
    q, k, v, w = _inputs(B, S, H, K, hd, seed=2)
    want = _jax_grads(q, k, v, w, causal, dtype=jnp.bfloat16)
    got = _pt_grads(q, k, v, w, causal, dtype=torch.bfloat16)
    for name, g, ref in zip("qkv", got, want):
        assert g.dtype == torch.bfloat16, name
        scale = np.abs(ref).max()
        np.testing.assert_allclose(g.float().numpy(), ref,
                                   atol=4 * 2.0 ** -8 * scale, rtol=2e-2,
                                   err_msg=f"d{name}")


def test_attention_flash_passes_gradient():
    # The flash path of the dispatcher is differentiable in q, k and v and
    # gives the einsum path's gradients.
    q, k, v, w = _inputs(1, 24, 4, 2, 16, seed=3)
    grads = {}
    for impl in ("flash", "einsum"):
        leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
        out = pt_attention.attention(*leaves, impl=impl)
        (out * torch.from_numpy(w)).sum().backward()
        grads[impl] = [leaf.grad for leaf in leaves]
        assert all(g is not None and g.abs().sum() > 0 for g in grads[impl])
    for got, want in zip(grads["flash"], grads["einsum"]):
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


def test_function_saves_only_when_a_gradient_is_needed():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 2, 16))
    plain = pt_flash.flash_attention(q, k, v)
    assert plain.grad_fn is None
    q.requires_grad_()
    with torch.no_grad():
        assert pt_flash.flash_attention(q, k, v).grad_fn is None
    out = pt_flash.flash_attention(q, k, v)
    assert type(out.grad_fn).__name__ == "_FlashAttentionBackward"
    torch.testing.assert_close(out.detach(), plain, atol=0, rtol=0)
    # with_lse returns the forward's residuals, outside autograd.
    _, lse = pt_flash.flash_attention(q, k, v, with_lse=True)
    assert lse.shape == (1, 4, 16) and lse.grad_fn is None


def test_cpu_backward_launches_nothing():
    before = (pt_flash.flash_attention.launches,
              pt_flash.flash_attention.lse_launches,
              pt_flash.flash_attention_bwd.dq_launches,
              pt_flash.flash_attention_bwd.dkv_launches)
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 2, 16))
    q.requires_grad_()
    pt_flash.flash_attention(q, k, v).sum().backward()
    assert q.grad is not None
    assert before == (pt_flash.flash_attention.launches,
                      pt_flash.flash_attention.lse_launches,
                      pt_flash.flash_attention_bwd.dq_launches,
                      pt_flash.flash_attention_bwd.dkv_launches)


def test_backward_input_checks():
    q, k, v, w = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 2, 128))
    # The backward kernels take bf16 and fp32 (with out and dO as further
    # operands); anything else is refused before a launch.
    pt_flash._check_cuda(q, k, v, w, w)
    pt_flash._check_cuda(*(t.bfloat16() for t in (q, k, v, w, w)))
    for dtype in (torch.float16, torch.float64):
        with pytest.raises(ValueError, match="bf16 or fp32"):
            pt_flash._check_cuda(*(t.to(dtype) for t in (q, k, v, w, w)))
    with pytest.raises(ValueError, match="bf16 or fp32"):
        pt_flash._check_cuda(q, k, v, w.bfloat16(), w)
    q32, k32, v32 = (t[..., :32].contiguous() for t in (q, k, v))
    with pytest.raises(ValueError, match="head dims"):
        pt_flash._check_cuda(q32, k32, v32, q32, q32)
    lse = torch.zeros(1, 4, 16)
    with pytest.raises(ValueError, match="must match q"):
        pt_flash.flash_attention_bwd(q, k, v, w[:, :8], lse, w)


def test_fp32_needing_grad_off_cpu_refused_before_launch():
    # Off the CPU an fp32 forward that needs a gradient passes the
    # kernels' checks (the backward has fp32 entries), and the fp32
    # backward plan reads q, k, v and dO through their strides. A dtype
    # the kernels do not take is refused before the forward launches.
    q, k, v = (torch.empty(1, 16, n, 128, device="meta") for n in (4, 2, 2))
    pt_flash._check_cuda(q, k, v, q, q)
    plan = pt_flash.bwd_plan(q, k, v, q)
    assert plan.maps == () and len(plan.strides) == 12
    assert plan.dq_threads == pt_flash.BWD_DQ_F32_THREADS
    assert plan.dkv_threads == pt_flash.BWD_DKV_F32_THREADS
    assert plan.dq_grid == (4, 1) and plan.dkv_grid == (2, 1)
    assert (plan.dq_smem, plan.dkv_smem) == pt_flash.bwd_smem_bytes(
        128, torch.float32)
    assert len(plan.packed()) == 8 + 12
    launches = pt_flash.flash_attention.launches
    half = [t.half() for t in (q, k, v)]
    with pytest.raises(ValueError, match="bf16 or fp32"):
        pt_flash.flash_attention(half[0].requires_grad_(), *half[1:])
    assert pt_flash.flash_attention.launches == launches


CHUNKED_CASES = [
    # (B, S, H, K, hd, causal, block_q)
    (2, 40, 4, 2, 16, True, 16),    # ragged S: the last chunk is short
    (2, 40, 4, 2, 16, False, 16),
    (1, 48, 8, 2, 16, True, 16),    # group 4
    (1, 48, 4, 4, 32, False, 512),  # group 1, one chunk
]


@pytest.mark.parametrize("B,S,H,K,hd,causal,block_q", CHUNKED_CASES)
def test_chunked_bwd_matches_jax_chunked(B, S, H, K, hd, causal, block_q):
    q, k, v, w = _inputs(B, S, H, K, hd, seed=4)

    def loss(q, k, v):
        out = jax_flash.flash_attention(
            q, k, v, causal=causal, block_q=block_q, block_k=16,
            interpret=True, bwd_impl="chunked")
        return jnp.sum(out * w)

    want = jax.grad(loss, argnums=(0, 1, 2))(
        *(jnp.asarray(a) for a in (q, k, v)))
    leaves = [torch.from_numpy(a).requires_grad_() for a in (q, k, v)]
    out = pt_flash.flash_attention(*leaves, causal=causal,
                                   bwd_impl="chunked")
    (out * torch.from_numpy(w)).sum().backward()
    direct = pt_flash.chunked_attention_bwd(
        *(torch.from_numpy(a) for a in (q, k, v, w)), causal,
        block_q=block_q)
    for name, leaf, d, ref in zip("qkv", leaves, direct, want):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref),
                                   atol=TOL, rtol=TOL, err_msg=f"d{name}")
        np.testing.assert_allclose(d.numpy(), np.asarray(ref), atol=TOL,
                                   rtol=TOL, err_msg=f"direct d{name}")


def test_unknown_bwd_impl_refused():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 16, 4, 2, 16))
    with pytest.raises(ValueError, match="unknown bwd_impl"):
        pt_flash.flash_attention(q, k, v, bwd_impl="pallas")
