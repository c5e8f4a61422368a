"""Parity of the port's MoE layer and MoE-Llama with the JAX reference on
the tiny config in fp32, weights carried over from JAX's ``init``; and
the differentiable collectives' identity on an axis of one rank.

Routing picks a discrete top-k set: where two probabilities tie, a last
ulp decides the experts and the two sides may pick differently. Each
routing comparison first asserts, from the JAX side, that the k-th and
(k+1)-th probabilities of every token differ by more than ``ROUTE_GAP``,
so a flipped expert fails with that cause named."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.models import llama as jax_llama
from k8s_dra_driver_gpu_tpu.models import llama_moe as jax_llama_moe
from k8s_dra_driver_gpu_tpu.models import moe as jax_moe
from k8s_dra_driver_gpu_tpu_torch.convert import params_from_jax
from k8s_dra_driver_gpu_tpu_torch.models import llama_moe as pt_llama_moe
from k8s_dra_driver_gpu_tpu_torch.models import moe as pt_moe
from k8s_dra_driver_gpu_tpu_torch.ops import collectives

# fp32 on both sides.
TOL = 1e-5
ROUTE_GAP = 1e-4

JAX_CFG = dataclasses.replace(jax_llama_moe.LlamaMoEConfig.tiny(),
                              dtype=jnp.float32)
PT_CFG = dataclasses.replace(pt_llama_moe.LlamaMoEConfig.tiny(),
                             dtype=torch.float32)


@pytest.fixture(scope="module")
def params():
    jp = jax_llama_moe.init(jax.random.PRNGKey(0), JAX_CFG)
    return jp, params_from_jax(jp)


def _layer0(tree):
    return {name: tree["layers"][name][0]
            for name in ("router", "w_in", "w_out")}


def _x(B=2, S=8, seed=2):
    return np.random.default_rng(seed).standard_normal(
        (B, S, JAX_CFG.d_model)).astype(np.float32)


def _tokens(B=2, S=9, seed=1):
    return np.random.default_rng(seed).integers(
        0, JAX_CFG.vocab_size, (B, S), dtype=np.int32)


def assert_routing_separated(probs, top_k):
    """Every token's k-th and (k+1)-th router probabilities differ by
    more than ``ROUTE_GAP``."""
    ranked = np.sort(np.asarray(probs, np.float64), axis=-1)[..., ::-1]
    gap = (ranked[..., top_k - 1] - ranked[..., top_k]).min()
    assert gap > ROUTE_GAP, (
        f"near-tie in routing: the k-th and (k+1)-th probabilities differ "
        f"by {gap:.3g}, so the two sides may pick different experts")


def _jax_router_probs(jp, x):
    return jax.nn.softmax(jnp.asarray(x, jnp.float32) @ jp["router"], -1)


def _jax_layer_router_probs(jp, tokens, cfg=JAX_CFG):
    """The router probabilities of every layer of JAX's MoE-Llama forward
    on ``tokens``, the layers run as ``llama_moe.forward`` runs them."""
    x = jp["embed"].astype(cfg.dtype)[tokens]
    positions = jnp.arange(tokens.shape[1])[None, :]
    probs = []
    for i in range(cfg.n_layers):
        lp = jax.tree_util.tree_map(lambda leaf, i=i: leaf[i], jp["layers"])
        x = jax_llama.attention_block(cfg, x, lp, positions, None)
        m = jax_llama.rms_norm(x, lp["mlp_norm"], cfg.norm_eps)
        probs.append(_jax_router_probs(lp, m))
        out, _ = jax_moe.moe_ffn(lp, m, top_k=cfg.top_k, dtype=cfg.dtype)
        x = x + out
    return probs


def test_config_matches_reference():
    for name in ("__init__", "tiny"):
        want = (jax_llama_moe.LlamaMoEConfig() if name == "__init__"
                else jax_llama_moe.LlamaMoEConfig.tiny())
        got = (pt_llama_moe.LlamaMoEConfig() if name == "__init__"
               else pt_llama_moe.LlamaMoEConfig.tiny())
        for field in ("vocab_size", "d_model", "n_layers", "n_heads",
                      "n_kv_heads", "d_ff", "n_experts", "top_k",
                      "aux_coef", "rope_theta", "norm_eps", "attn_impl",
                      "head_dim"):
            assert getattr(got, field) == getattr(want, field), (name, field)
    assert pt_llama_moe.LlamaMoEConfig().dtype == torch.bfloat16
    dense = pt_llama_moe.LlamaMoEConfig().as_llama()
    assert (dense.d_model, dense.n_heads, dense.head_dim) == (1024, 16, 64)


def test_init_tree_matches_reference(params):
    jp, _ = params
    got = pt_llama_moe.init(PT_CFG, torch.Generator().manual_seed(0), "cpu")
    assert got.keys() == jp.keys()
    assert list(got["layers"]) == list(jp["layers"])
    for name, leaf in [*got.items(), *got["layers"].items()]:
        if name == "layers":
            continue
        want = jp[name] if name in jp else jp["layers"][name]
        assert tuple(leaf.shape) == want.shape, name
        assert leaf.dtype == torch.float32, name
    moe = pt_moe.init_moe(torch.Generator().manual_seed(0), 64, 96, 4, "cpu")
    want = jax_moe.init_moe(jax.random.PRNGKey(0), 64, 96, 4)
    assert {k: tuple(v.shape) for k, v in moe.items()} == \
        {k: v.shape for k, v in want.items()}
    assert pt_moe.moe_param_specs() == {
        "router": (None, None), "w_in": ("ep", None, None),
        "w_out": ("ep", None, None)}
    specs = pt_llama_moe.param_specs(PT_CFG)
    assert specs["layers"]["w_in"] == (None, "ep", None, None)
    assert specs["layers"]["wq"] == () and specs["embed"] == ()


@pytest.mark.parametrize("top_k", [1, 2])
def test_moe_ffn_matches_reference(params, top_k):
    jp, tp = params
    x = _x()
    assert_routing_separated(_jax_router_probs(_layer0(jp), x), top_k)
    want, want_aux = jax_moe.moe_ffn(_layer0(jp), jnp.asarray(x), top_k=top_k,
                                     dtype=jnp.float32)
    got, aux = pt_moe.moe_ffn(_layer0(tp), torch.from_numpy(x), top_k=top_k,
                              dtype=torch.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("shards", [2, 4])
def test_expert_shards_sum_to_full_mixture(params, shards):
    # The invariant the ep all-reduce relies on: each expert block at its
    # offset, summed, is the whole mixture; aux is every block's alike.
    _, tp = params
    lp = _layer0(tp)
    x = torch.from_numpy(_x())
    whole, whole_aux = pt_moe.moe_ffn(lp, x, dtype=torch.float32)
    per = PT_CFG.n_experts // shards
    total = torch.zeros_like(whole)
    for off in range(0, PT_CFG.n_experts, per):
        block = dict(lp, w_in=lp["w_in"][off:off + per],
                     w_out=lp["w_out"][off:off + per])
        part, aux = pt_moe.moe_ffn(block, x, dtype=torch.float32,
                                   expert_offset=off)
        assert aux.item() == whole_aux.item()
        total += part
    np.testing.assert_allclose(total.numpy(), whole.numpy(), rtol=TOL,
                               atol=TOL)


def test_moe_ffn_gradients_match_jax_grad(params):
    jp, tp = params
    x = _x(seed=3)
    assert_routing_separated(_jax_router_probs(_layer0(jp), x), 2)
    cot = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)

    def jax_obj(p, xx):
        out, aux = jax_moe.moe_ffn(p, xx, dtype=jnp.float32)
        return jnp.sum(out * cot) + 3.0 * aux

    want_p, want_x = jax.grad(jax_obj, argnums=(0, 1))(_layer0(jp),
                                                        jnp.asarray(x))
    lp = {k: v.clone().requires_grad_() for k, v in _layer0(tp).items()}
    xt = torch.from_numpy(x).requires_grad_()
    out, aux = pt_moe.moe_ffn(lp, xt, dtype=torch.float32)
    ((out * torch.from_numpy(cot)).sum() + 3.0 * aux).backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_x), rtol=TOL,
                               atol=TOL)
    for name, leaf in lp.items():
        np.testing.assert_allclose(leaf.grad.numpy(),
                                   np.asarray(want_p[name]), rtol=TOL,
                                   atol=TOL, err_msg=name)


def test_forward_matches_reference(params):
    jp, tp = params
    tokens = _tokens()[:, :-1]
    for probs in _jax_layer_router_probs(jp, jnp.asarray(tokens)):
        assert_routing_separated(probs, JAX_CFG.top_k)
    want, want_aux = jax_llama_moe.forward(jp, jnp.asarray(tokens), JAX_CFG)
    got, aux = pt_llama_moe.forward(tp, torch.from_numpy(tokens), PT_CFG)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(aux.item(), float(want_aux), rtol=TOL,
                               atol=TOL)


def _flat(tree, prefix=""):
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{name}/"))
        else:
            out[prefix + name] = value
    return out


def test_loss_and_gradients_match_reference(params):
    jp, tp = params
    tokens = _tokens()
    for probs in _jax_layer_router_probs(jp, jnp.asarray(tokens[:, :-1])):
        assert_routing_separated(probs, JAX_CFG.top_k)
    want, want_grads = jax.value_and_grad(jax_llama_moe.loss_fn)(
        jp, jnp.asarray(tokens), JAX_CFG)
    leaves = {k: v.clone().requires_grad_() for k, v in _flat(tp).items()}
    tree = {"layers": {}}
    for name, leaf in leaves.items():
        if name.startswith("layers/"):
            tree["layers"][name[7:]] = leaf
        else:
            tree[name] = leaf
    loss = pt_llama_moe.loss_fn(tree, torch.from_numpy(tokens), PT_CFG)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want), rtol=TOL, atol=TOL)
    for name, ref in _flat(want_grads).items():
        np.testing.assert_allclose(leaves[name].grad.numpy(), np.asarray(ref),
                                   rtol=TOL, atol=TOL, err_msg=name)


class _NoGroupMesh:
    """A mesh whose only dim is "dp" of one rank and which has no process
    group: a collective that reached for one would raise."""

    mesh_dim_names = ("dp",)

    def size(self, dim):
        del dim
        return 1

    def get_group(self, name):
        raise AssertionError(f"a collective over {name} was issued")


@pytest.mark.parametrize("axis", ["dp", "ep"])
def test_collectives_are_the_identity_on_one_rank(axis):
    # "dp" has one rank; "ep" is a dim compute_mesh dropped.
    mesh_axis = collectives.MeshAxis(_NoGroupMesh(), axis)
    assert (mesh_axis.size, mesh_axis.index) == (1, 0)
    x = torch.randn(2, 6, 4, 3, requires_grad=True)
    for out in (collectives.all_reduce_sum(x, mesh_axis),
                collectives.ring_shift(x, mesh_axis),
                collectives.all_to_all(x, mesh_axis, 2, 1)):
        assert out is x
    grad = torch.ones(3)
    collectives.mean_over([grad], [mesh_axis])
    assert torch.equal(grad, torch.ones(3))
