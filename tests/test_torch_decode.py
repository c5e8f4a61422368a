"""Parity of the port's KV-cache serving path with the JAX reference on
the tiny config in fp32: prefill, decode steps, greedy generation (fp
and int8 caches) and the int8 quantizer."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.models import decode as jax_decode
from k8s_dra_driver_gpu_tpu.models import llama as jax_llama
from k8s_dra_driver_gpu_tpu_torch.convert import params_from_jax
from k8s_dra_driver_gpu_tpu_torch.models import decode as pt_decode
from k8s_dra_driver_gpu_tpu_torch.models import llama as pt_llama
from k8s_dra_driver_gpu_tpu_torch.ops import flash_attention as pt_flash

# fp32 on both sides; matches tests/test_decode.py.
TOL = 1e-4

JAX_CFG = dataclasses.replace(jax_llama.LlamaConfig.tiny(), dtype=jnp.float32)
PT_CFG = dataclasses.replace(pt_llama.LlamaConfig.tiny(), dtype=torch.float32)
MAX_LEN = 24


@pytest.fixture(scope="module")
def params():
    jp = jax_llama.init(jax.random.PRNGKey(0), JAX_CFG)
    return jp, params_from_jax(jp)


def _prompt(B=2, S=12, seed=1):
    return np.random.default_rng(seed).integers(
        0, JAX_CFG.vocab_size, (B, S), dtype=np.int32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_prefill_logits_and_cache_match(params, attn_impl):
    jp, tp = params
    prompt = _prompt()
    # flash: the Pallas kernel in interpret mode against the port's plain
    # version of its CUDA kernel.
    want_logits, want_cache = jax_decode.prefill(
        jp, jnp.asarray(prompt),
        dataclasses.replace(JAX_CFG, attn_impl=attn_impl), MAX_LEN)
    got_logits, got_cache = pt_decode.prefill(
        tp, torch.from_numpy(prompt),
        dataclasses.replace(PT_CFG, attn_impl=attn_impl), MAX_LEN)
    _close(got_logits, want_logits)
    assert got_cache.length == int(want_cache.length) == 12
    assert got_cache.k.shape == want_cache.k.shape == (2, 2, MAX_LEN, 2, 16)
    _close(got_cache.k, want_cache.k)
    _close(got_cache.v, want_cache.v)


def test_decode_steps_match(params):
    jp, tp = params
    prompt = _prompt(B=1, S=8)
    _, jc = jax_decode.prefill(jp, jnp.asarray(prompt), JAX_CFG, MAX_LEN)
    _, pc = pt_decode.prefill(tp, torch.from_numpy(prompt), PT_CFG, MAX_LEN)
    for tok in (7, 200, 3):
        want, jc = jax_decode.decode_step(
            jp, jc, jnp.array([tok], jnp.int32), JAX_CFG)
        got, pc = pt_decode.decode_step(
            tp, pc, torch.tensor([tok], dtype=torch.int32), PT_CFG)
        _close(got, want)
    assert pc.length == int(jc.length) == 11
    _close(pc.k, jc.k)
    _close(pc.v, jc.v)


@pytest.mark.parametrize("kv_quant", [False, True])
def test_greedy_generate_identical(params, kv_quant):
    jp, tp = params
    prompt = _prompt()
    want = jax_decode.generate(jp, jnp.asarray(prompt), JAX_CFG,
                               max_new_tokens=8, max_len=MAX_LEN,
                               kv_quant=kv_quant)
    got = pt_decode.generate(tp, torch.from_numpy(prompt), PT_CFG,
                             max_new_tokens=8, max_len=MAX_LEN,
                             kv_quant=kv_quant)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_quantize_kv_matches():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 2, 16), dtype=np.float32)
    x[0, 0, 0] = 0.0  # an all-zero vector takes the 1e-8 scale floor
    # Exact halves exercise round-half-to-even: codes +-0.5 / +-1.5 of
    # the scale that an amax of 127 gives.
    x[1, 0, 0, :5] = [127.0, 0.5, 1.5, -0.5, -2.5]
    want_q, want_s = jax_decode._quantize_kv(jnp.asarray(x))
    got_q, got_s = pt_decode._quantize_kv(torch.from_numpy(x))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.bfloat16
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    assert got_q[1, 0, 0, :5].tolist() == [127, 0, 2, 0, -2]
    # Scales are stored in bf16 on both sides: equal up to bf16 rounding.
    np.testing.assert_allclose(got_s.float().numpy(),
                               np.asarray(want_s.astype(jnp.float32)),
                               rtol=2 ** -8, atol=0)
    deq = pt_decode._dequantize(got_q, got_s, torch.float32)
    want_deq = jax_decode._dequantize(want_q, want_s, jnp.float32)
    _close(deq, want_deq, tol=1e-6)


def test_int8_prefill_cache_matches(params):
    jp, tp = params
    prompt = _prompt()
    _, jc = jax_decode.prefill(jp, jnp.asarray(prompt), JAX_CFG, MAX_LEN,
                               quantized=True)
    _, pc = pt_decode.prefill(tp, torch.from_numpy(prompt), PT_CFG, MAX_LEN,
                              quantized=True)
    assert pc.k.dtype == torch.int8 and pc.k_scale.dtype == torch.bfloat16
    # k/v themselves agree to ~1e-6, so a code may differ by one where a
    # value sits on a rounding boundary; none does for this seed.
    np.testing.assert_array_equal(pc.k.numpy(), np.asarray(jc.k))
    np.testing.assert_array_equal(pc.v.numpy(), np.asarray(jc.v))
    np.testing.assert_allclose(pc.k_scale.float().numpy(),
                               np.asarray(jc.k_scale.astype(jnp.float32)),
                               rtol=2 ** -8, atol=0)


def test_check_budget_and_full_cache_raise(params):
    _, tp = params
    prompt = torch.from_numpy(_prompt(B=1, S=20))
    with pytest.raises(ValueError, match="exceeds max_len"):
        pt_decode.generate(tp, prompt, PT_CFG, max_new_tokens=5, max_len=24)
    _, cache = pt_decode.prefill(tp, prompt, PT_CFG, max_len=20)
    with pytest.raises(ValueError, match="exceeds max_len"):
        pt_decode.decode_step(tp, cache, torch.tensor([1]), PT_CFG)
    assert cache.length == 20


def test_unknown_attn_impl_raises(params):
    _, tp = params
    cfg = dataclasses.replace(PT_CFG, attn_impl="Flash")
    with pytest.raises(ValueError, match="unknown attention impl"):
        pt_decode.prefill(tp, torch.from_numpy(_prompt()), cfg, MAX_LEN)


def test_sampled_generate_follows_generator(params):
    _, tp = params
    prompt = torch.from_numpy(_prompt())

    def run(seed):
        g = torch.Generator().manual_seed(seed)
        return pt_decode.generate(tp, prompt, PT_CFG, max_new_tokens=6,
                                  max_len=MAX_LEN, temperature=1.0,
                                  generator=g)

    a, b = run(5), run(5)
    torch.testing.assert_close(a, b)
    assert a.shape == (2, 6)
    assert int(a.min()) >= 0 and int(a.max()) < PT_CFG.vocab_size


def test_cpu_path_launches_no_kernel(params):
    _, tp = params
    before = pt_flash.flash_attention.launches
    pt_decode.generate(tp, torch.from_numpy(_prompt()),
                       dataclasses.replace(PT_CFG, attn_impl="flash"),
                       max_new_tokens=2, max_len=MAX_LEN)
    assert pt_flash.flash_attention.launches == before
