"""The port's expert-parallel MoE-Llama training against the JAX reference:
one 4-rank gloo gang (``tests/torch_gang.py``, worker ``moe_train``)
trains the tiny config in fp32 for 2 steps on the meshes (dp=2, ep=2) and
(dp=1, ep=4) and runs ``make_sharded_moe`` at ep=4; JAX's own
``make_moe_train`` on meshes of the same shape over 4 of the CPU devices
(with JAX's ``make_optimizer``) and its whole ``moe_ffn`` are the
reference."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from k8s_dra_driver_gpu_tpu.models import llama_moe as jax_llama_moe
from k8s_dra_driver_gpu_tpu.models import moe as jax_moe
from k8s_dra_driver_gpu_tpu.train import train as jax_train
from tests import torch_gang
from tests.test_torch_moe import (_jax_layer_router_probs, _jax_router_probs,
                                  assert_routing_separated)

WORLD, STEPS, BATCH, SEQ = 4, 2, 4, 16
MESHES = {"dp2_ep2": (2, 2), "dp1_ep4": (1, 4)}
# fp32 on both sides; the ranks sum the mixture and average the
# gradients in another order than XLA does.
TOL = 1e-5
# Adam's first steps move a weight by lr * g / (|g| + 1e-8): where a
# gradient is within a few orders of its eps, its last bits, which are
# the rounding of a sum of much larger terms, decide the step. Weights
# whose reference gradient is under ILL_GRAD at some step (and not
# exactly zero, as an unused embedding row's is on both sides) are held
# to the most two updates can differ, and must be few.
ILL_GRAD, ILL_SHARE, LR = 1e-6, 1e-2, 3e-4
JAX_CFG = dataclasses.replace(jax_llama_moe.LlamaMoEConfig.tiny(),
                              dtype=jnp.float32)
EXPERT = ("layers/w_in", "layers/w_out")


def _flat(tree, prefix=""):
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{name}/"))
        else:
            out[prefix + name] = np.asarray(value)
    return out


def _layer0(params):
    return {name: params["layers"][name][0]
            for name in ("router", "w_in", "w_out")}


@jax.jit
def _shard_mean_grad(params, shards):
    """The gradient the trainer applies, on one device: of the mean of
    the dp shards' losses (each shard keeps its own aux)."""
    def loss(p):
        return sum(jax_llama_moe.loss_fn(p, rows, JAX_CFG)
                   for rows in shards) / shards.shape[0]
    return jax.grad(loss)(params)


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Runs the gang once; returns (per-rank results, {mesh: (JAX losses,
    JAX final params by "/" name, masks of the weights whose reference
    gradient was under ILL_GRAD at some step)}, JAX's whole (out, aux) of
    layer 0, the tokens)."""
    out = tmp_path_factory.mktemp("moe_train")
    params = jax_llama_moe.init(jax.random.PRNGKey(0), JAX_CFG)
    np.savez(out / "params.npz", **_flat(params))
    tokens = np.random.RandomState(8).randint(
        0, JAX_CFG.vocab_size, (STEPS, BATCH, SEQ + 1)).astype(np.int32)
    np.savez(out / "tokens.npz", tokens=tokens)
    x = np.random.default_rng(3).standard_normal(
        (2, 8, JAX_CFG.d_model)).astype(np.float32)
    np.savez(out / "moe_x.npz", x=x)
    torch_gang.run_gang("moe_train", WORLD, out)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]

    for half in (tokens[0, :BATCH // 2], tokens[0, BATCH // 2:], tokens[0]):
        for probs in _jax_layer_router_probs(params,
                                             jnp.asarray(half[:, :-1])):
            assert_routing_separated(probs, JAX_CFG.top_k)
    assert_routing_separated(_jax_router_probs(_layer0(params), x),
                             JAX_CFG.top_k)
    want = {}
    for label, (dp, ep) in MESHES.items():
        mesh = Mesh(np.asarray(jax.devices()[:WORLD]).reshape(dp, ep),
                    ("dp", "ep"))
        init_fn, step_fn, batch_shard, place = jax_llama_moe.make_moe_train(
            mesh, JAX_CFG, optimizer=jax_train.make_optimizer())
        state = init_fn(place(params))
        losses, small = [], None
        for step in range(STEPS):
            grads = _flat(_shard_mean_grad(
                jax.tree_util.tree_map(np.asarray, state.params),
                jnp.asarray(tokens[step]).reshape(dp, BATCH // dp, -1)))
            tiny = {k: (g != 0) & (np.abs(g) < ILL_GRAD)
                    for k, g in grads.items()}
            small = tiny if small is None else {
                k: small[k] | tiny[k] for k in tiny}
            state, loss = step_fn(state, jax.device_put(tokens[step],
                                                        batch_shard))
            losses.append(float(loss))
        want[label] = losses, _flat(state.params), small
    whole = jax_moe.moe_ffn(_layer0(params), jnp.asarray(x),
                            top_k=JAX_CFG.top_k, dtype=jnp.float32)
    return ranks, want, whole, tokens


@pytest.mark.parametrize("mesh", MESHES)
def test_losses_match_jax_make_moe_train(gang, mesh):
    ranks, want, _, _ = gang
    for rank in ranks:
        assert rank[f"{mesh}/step"] == STEPS
        np.testing.assert_allclose(rank[f"{mesh}/losses"], want[mesh][0],
                                   rtol=TOL, atol=TOL)


def assert_adam_close(got, want, ill, name):
    """``got`` within TOL of ``want`` wherever the reference gradient was
    well above Adam's eps; where it was not (``ill``), within the most
    ``STEPS`` updates can differ, on at most ILL_SHARE of the weights."""
    good = ~ill
    np.testing.assert_allclose(got[good], want[good], rtol=TOL, atol=TOL,
                               err_msg=name)
    assert ill.mean() <= ILL_SHARE, (name, ill.sum())
    assert np.all(np.abs(got[ill] - want[ill]) <= 2 * LR * STEPS), name


@pytest.mark.parametrize("mesh", MESHES)
def test_every_parameter_matches_jax_make_moe_train(gang, mesh):
    ranks, want, _, _ = gang
    dp, ep = MESHES[mesh]
    _, final, ill = want[mesh]
    for name, ref in final.items():
        for r, rank in enumerate(ranks):
            got = rank[f"{mesh}/param/{name}"].numpy()
            if name in EXPERT:
                # This rank's block of the expert dim.
                e = ref.shape[1] // ep
                lo = rank[f"{mesh}/coords"][1] * e
                block = np.s_[:, lo:lo + e]
            else:
                block = np.s_[:]
            assert_adam_close(got, ref[block], ill[name][block],
                              f"{name} rank {r}")


@pytest.mark.parametrize("mesh", MESHES)
def test_ranks_hold_their_mesh_coordinates_and_dp_shard(gang, mesh):
    ranks, _, _, tokens = gang
    dp, ep = MESHES[mesh]
    for r, rank in enumerate(ranks):
        assert rank[f"{mesh}/coords"] == (r // ep, r % ep)
        rows = BATCH // dp
        want = tokens[-1, (r // ep) * rows:(r // ep + 1) * rows]
        np.testing.assert_array_equal(rank[f"{mesh}/local_batch"].numpy(),
                                      want)


@pytest.mark.parametrize("moment", ["mu", "nu"])
@pytest.mark.parametrize("mesh", MESHES)
def test_expert_moments_hold_their_block(gang, mesh, moment):
    ranks, want, _, _ = gang
    ep = MESHES[mesh][1]
    for name, ref in want[mesh][1].items():
        shape = list(ref.shape)
        if name in EXPERT:
            shape[1] = JAX_CFG.n_experts // ep
        for rank in ranks:
            assert rank[f"{mesh}/{moment}/{name}"] == tuple(shape), name


def test_sharded_moe_matches_whole_moe_ffn(gang):
    ranks, _, (out, aux), _ = gang
    for rank in ranks:
        assert rank["sharded_moe/local_experts"] == JAX_CFG.n_experts // 4
        np.testing.assert_allclose(rank["sharded_moe/out"].numpy(),
                                   np.asarray(out), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(rank["sharded_moe/aux"].item(),
                                   float(aux), rtol=TOL, atol=TOL)
