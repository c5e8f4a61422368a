"""Parity of the port's Llama layers and forward pass with the JAX
reference on the tiny config in fp32, weights carried over from JAX's
``init``."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.models import llama as jax_llama
from k8s_dra_driver_gpu_tpu_torch.convert import params_from_jax
from k8s_dra_driver_gpu_tpu_torch.models import llama as pt_llama

# fp32 on both sides; matches tests/test_decode.py.
TOL = 1e-4

JAX_CFG = dataclasses.replace(jax_llama.LlamaConfig.tiny(), dtype=jnp.float32)
PT_CFG = dataclasses.replace(pt_llama.LlamaConfig.tiny(), dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    jp = jax_llama.init(jax.random.PRNGKey(0), JAX_CFG)
    return jp, params_from_jax(jp)


def _tokens(B, S, seed=1):
    return np.random.default_rng(seed).integers(
        0, JAX_CFG.vocab_size, (B, S), dtype=np.int32)


def test_configs_match_reference():
    for name in ("tiny", "flagship", "llama3_8b"):
        want, got = getattr(jax_llama.LlamaConfig, name)(), \
            getattr(pt_llama.LlamaConfig, name)()
        for field in ("vocab_size", "d_model", "n_layers", "n_heads",
                      "n_kv_heads", "d_ff", "rope_theta", "norm_eps",
                      "head_dim", "loss_chunk", "remat"):
            assert getattr(got, field) == getattr(want, field), (name, field)
    assert pt_llama.LlamaConfig.llama3_8b().dtype == torch.bfloat16


def test_params_from_jax_keeps_tree(params):
    jp, tp = params
    assert tp.keys() == jp.keys()
    assert tp["layers"].keys() == jp["layers"].keys()
    assert tp["layers"]["wq"].shape == (2, 64, 64)
    np.testing.assert_array_equal(tp["embed"].numpy(), np.asarray(jp["embed"]))


@pytest.mark.parametrize("dtype", [jnp.bfloat16, jnp.float32, jnp.int32])
def test_params_from_jax_carries_dtype_bit_for_bit(dtype):
    # bf16 leaves arrive from JAX as ml_dtypes' bfloat16, which numpy and
    # torch.from_numpy do not know.
    x = jnp.asarray(np.random.default_rng(4).standard_normal((3, 5)) * 100,
                    dtype)
    got = params_from_jax({"m": {"x": x}})["m"]["x"]
    assert got.dtype == {jnp.bfloat16: torch.bfloat16,
                         jnp.float32: torch.float32,
                         jnp.int32: torch.int32}[dtype]
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(x.astype(jnp.float32)))


def test_init_shapes_and_scale():
    cfg = pt_llama.LlamaConfig.tiny()
    g = torch.Generator().manual_seed(0)
    tp = pt_llama.init(cfg, g, "cpu", dtype=torch.bfloat16)
    jp = jax_llama.init(jax.random.PRNGKey(0), jax_llama.LlamaConfig.tiny())
    for path, leaf in jax.tree_util.tree_leaves_with_path(jp):
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert node.dtype == torch.bfloat16
    # N(0, 1) / sqrt(fan_in): w_down's fan-in is d_ff.
    std = tp["layers"]["w_down"].float().std().item()
    assert abs(std * cfg.d_ff ** 0.5 - 1.0) < 0.05


def test_rms_norm_matches():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 64), dtype=np.float32)
    scale = rng.standard_normal((64,), dtype=np.float32)
    want = jax_llama.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5)
    got = pt_llama.rms_norm(torch.from_numpy(x), torch.from_numpy(scale), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)
    # bf16: normalise in fp32, cast, then scale in bf16 -- same rounding
    # points on both sides.
    want = jax_llama.rms_norm(jnp.asarray(x, jnp.bfloat16),
                              jnp.asarray(scale), 1e-5)
    got = pt_llama.rms_norm(torch.from_numpy(x).bfloat16(),
                            torch.from_numpy(scale), 1e-5)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               atol=1e-2, rtol=1e-2)


@pytest.mark.parametrize("pos_shape", [(1, 6), (2, 6)])
def test_rope_matches(pos_shape):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 4, 16), dtype=np.float32)
    pos = rng.integers(0, 4096, pos_shape, dtype=np.int32)
    want = jax_llama.rope(jnp.asarray(x), jnp.asarray(pos), 500_000.0)
    got = pt_llama.rope(torch.from_numpy(x), torch.from_numpy(pos), 500_000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


@pytest.mark.parametrize("attn_impl", ["einsum", "flash"])
def test_forward_logits_match(params, attn_impl):
    jp, tp = params
    tokens = _tokens(2, 12)
    want = jax_llama.forward(jp, jnp.asarray(tokens), JAX_CFG)
    got = pt_llama.forward(
        tp, torch.from_numpy(tokens),
        dataclasses.replace(PT_CFG, attn_impl=attn_impl))
    assert got.dtype == torch.float32 and got.shape == (2, 12, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=TOL, rtol=TOL)


def test_attn_fn_seam(params):
    _, tp = params
    tokens = torch.from_numpy(_tokens(1, 8))
    calls = []

    def attn_fn(q, k, v):
        calls.append(q.shape)
        return pt_llama.attention(q, k, v, impl="einsum")

    want = pt_llama.forward(tp, tokens, PT_CFG)
    got = pt_llama.forward(tp, tokens, PT_CFG, attn_fn=attn_fn)
    assert calls == [(1, 8, 4, 16)] * PT_CFG.n_layers
    torch.testing.assert_close(got, want)
