"""Parity of the port's flash attention (its plain version, which CPU
tensors take) with the JAX Pallas kernel in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.ops import attention as jax_attention
from k8s_dra_driver_gpu_tpu.ops import flash_attention as jax_flash
from k8s_dra_driver_gpu_tpu_torch.ops import attention as pt_attention
from k8s_dra_driver_gpu_tpu_torch.ops import flash_attention as pt_flash

# fp32 on both sides; the two differ only in summation order.
TOL = 1e-5


def _inputs(B, S, H, K, hd, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((B, S, n, hd), dtype=np.float32)
                 for n in (H, K, K))


def _pt(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


CASES = [
    # (B, S, H, K, hd, causal)
    (2, 40, 4, 2, 16, True),    # GQA group 2, ragged S (not a block multiple)
    (2, 40, 4, 2, 16, False),
    (1, 32, 4, 4, 32, True),    # group 1, S a block multiple
    (1, 24, 8, 2, 16, False),   # group 4
]


@pytest.mark.parametrize("B,S,H,K,hd,causal", CASES)
def test_flash_matches_pallas_interpret(B, S, H, K, hd, causal):
    q, k, v = _inputs(B, S, H, K, hd)
    want = jax_flash.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=16, block_k=16, interpret=True)
    got = pt_flash.flash_attention(*_pt(q, k, v), causal=causal)
    assert got.shape == (B, S, H, hd) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_lse_matches_pallas_with_lse(causal):
    B, S, H, K, hd = 2, 40, 4, 2, 16
    q, k, v = _inputs(B, S, H, K, hd, seed=1)
    want_out, want_lse = jax_flash._flash_attention_fwd_impl(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        block_q=16, block_k=16, interpret=True, with_lse=True)
    out, lse = pt_flash.flash_attention(*_pt(q, k, v), causal=causal,
                                        with_lse=True)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    # The Pallas lse is [B*H, S_qpad, 1]; rows >= S are padding.
    want_lse = np.asarray(want_lse)[:, :S, 0].reshape(B, H, S)
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_and_einsum_match_jax_dot_product(causal):
    q, k, v = _inputs(2, 40, 4, 2, 16, seed=2)
    want = np.asarray(jax_attention.dot_product_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    flash = pt_flash.flash_attention(*_pt(q, k, v), causal=causal)
    einsum = pt_attention.dot_product_attention(*_pt(q, k, v), causal=causal)
    np.testing.assert_allclose(flash.numpy(), want, atol=TOL, rtol=TOL)
    np.testing.assert_allclose(einsum.numpy(), want, atol=TOL, rtol=TOL)


def test_bf16_einsum_matches_jax_dot_product():
    # bf16 rounds the scores and weights at the same places on both
    # sides; the tolerance is a few bf16 ulps of outputs of size ~1.
    q, k, v = _inputs(1, 24, 4, 2, 16, seed=3)
    want = jax_attention.dot_product_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    got = pt_attention.dot_product_attention(
        *(t.to(torch.bfloat16) for t in _pt(q, k, v)))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=2e-2, rtol=2e-2)


def test_attention_dispatch():
    q, k, v = _pt(*_inputs(1, 16, 4, 2, 16, seed=4))
    want = pt_attention.dot_product_attention(q, k, v)
    for impl in ("auto", "flash", "einsum"):
        torch.testing.assert_close(
            pt_attention.attention(q, k, v, impl=impl), want,
            atol=TOL, rtol=TOL)
    with pytest.raises(ValueError, match="unknown attention impl"):
        pt_attention.attention(q, k, v, impl="pallas")


def test_kernel_input_checks():
    q, k, v = _pt(*_inputs(1, 16, 4, 2, 128, seed=5))
    pt_flash._check_cuda(q, k, v)  # fp32, hd 128: taken
    with pytest.raises(ValueError, match="bf16 or fp32"):
        pt_flash._check_cuda(q.half(), k.half(), v.half())
    q96, k96, v96 = _pt(*_inputs(1, 16, 4, 2, 96, seed=5))
    with pytest.raises(ValueError, match="head dims"):
        pt_flash._check_cuda(q96, k96, v96)
    def head_dim_strided(t):
        return t.permute(3, 2, 1, 0).contiguous().permute(3, 2, 1, 0)

    with pytest.raises(ValueError, match="contiguous head dim"):
        pt_flash._check_cuda(*map(head_dim_strided, (q, k, v)))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        pt_flash.flash_attention(q[:, :, :3], k, v)
