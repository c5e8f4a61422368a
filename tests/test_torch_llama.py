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


def _boundary_ids(kind, T, V, rng):
    """[2, 6] ids: on each side of every shard boundary of a vocab of V in
    T shards, at the ends of the vocab, or random with repeats."""
    if kind == "shard boundaries":
        edges = [i * V // T + d for i in range(T + 1) for d in (-1, 0)]
        ids = [min(max(e, 0), V - 1) for e in edges * 6][:12]
    elif kind == "vocab ends":
        ids = [0, V - 1] * 6
    else:
        ids = list(rng.integers(0, 4, 6)) + list(rng.integers(0, V, 6))
    return np.asarray(ids, dtype=np.int32).reshape(2, 6)


@pytest.mark.parametrize("kind", ["shard boundaries", "vocab ends", "repeats"])
@pytest.mark.parametrize("T", [1, 2, 4])
def test_vocab_shard_lookups_sum_to_the_table_lookup(params, T, kind):
    # T simulated tp ranks, each looking up the ids in its own V / T rows:
    # the rows sum to the reference's table[ids] (each id is inside one
    # shard, the others give zeros), and the shards' gradients, stacked,
    # to its gradient.
    jp, pp = params
    table_j = jp["embed"]
    V = table_j.shape[0]
    rng = np.random.default_rng(T)
    ids = _boundary_ids(kind, T, V, rng)
    cotangent = rng.standard_normal((*ids.shape, table_j.shape[1])).astype(
        np.float32)
    want, vjp = jax.vjp(lambda t: t[jnp.asarray(ids)], table_j)
    (want_grad,) = vjp(jnp.asarray(cotangent))

    rows = 0
    grads = []
    for r in range(T):
        shard = pp["embed"][r * V // T:(r + 1) * V // T].clone()
        shard.requires_grad_(True)
        out = pt_llama.vocab_shard_lookup(shard, torch.from_numpy(ids),
                                          r * V // T)
        out.backward(torch.from_numpy(cotangent))
        rows = rows + out.detach()
        grads.append(shard.grad)
    np.testing.assert_array_equal(rows.numpy(), np.asarray(want))
    np.testing.assert_allclose(torch.cat(grads).numpy(),
                               np.asarray(want_grad), rtol=1e-6, atol=1e-6)


def test_embed_tokens_on_plain_tensors_is_the_table_lookup(params):
    jp, pp = params
    ids = _tokens(2, 6)
    np.testing.assert_array_equal(
        pt_llama.embed_tokens(pp["embed"], torch.from_numpy(ids)).numpy(),
        np.asarray(jp["embed"][jnp.asarray(ids)]))


def test_embed_tokens_without_tp_issues_no_all_reduce(params):
    # A one-rank mesh has no tp axis: the lookup runs on the whole table,
    # its rows come back laid out like the ids, and the forward issues no
    # collective.
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.debug import CommDebugMode

    from k8s_dra_driver_gpu_tpu_torch.parallel import mesh as pt_mesh

    _, pp = params
    ids = torch.from_numpy(_tokens(2, 6))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = pt_mesh.build_mesh()
        specs = pt_llama.param_specs(PT_CFG, mesh)
        table = distribute_tensor(pp["embed"], mesh, specs["embed"])
        tokens = distribute_tensor(ids, mesh, pt_llama.batch_spec(mesh))
        with CommDebugMode() as comms:
            rows = pt_llama.embed_tokens(table, tokens)
        assert comms.get_total_counts() == 0
        assert rows.placements == tokens.placements
        assert torch.equal(rows.full_tensor(), pp["embed"][ids])
    finally:
        dist.destroy_process_group()
