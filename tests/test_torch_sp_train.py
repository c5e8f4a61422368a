"""The port's sequence-parallel training against the JAX reference: one
4-rank gloo gang (``tests/torch_gang.py``, worker ``sp_train``) trains
the tiny config in fp32 for 2 steps with ring attention on (dp=1, sp=4)
and (dp=2, sp=2) and with Ulysses on (dp=2, sp=2), and runs ring
attention at sp=4 forward and backward; JAX's own ``make_sp_train`` and
``make_ring_attention`` on meshes of the same shape over 4 of the CPU
devices (with JAX's ``make_optimizer``) are the reference."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.models import llama as jax_llama
from k8s_dra_driver_gpu_tpu.parallel import mesh as jax_mesh
from k8s_dra_driver_gpu_tpu.parallel import ring_attention as jax_ring
from k8s_dra_driver_gpu_tpu.train import sp_train as jax_sp
from k8s_dra_driver_gpu_tpu.train import train as jax_train
from tests import torch_gang
from tests.test_torch_moe_train import ILL_GRAD, assert_adam_close

WORLD, STEPS, BATCH, SEQ = 4, 2, 4, 16
RUNS = {"ring_dp1_sp4": ("ring", 1, 4), "ring_dp2_sp2": ("ring", 2, 2),
        "ulysses_dp2_sp2": ("ulysses", 2, 2)}
# fp32 on both sides; ring attention merges its chunks and the ranks
# average the gradients in another order than XLA does.
TOL = 1e-5
JAX_CFG = dataclasses.replace(jax_llama.LlamaConfig.tiny(), dtype=jnp.float32)
RING_SHAPE = (2, SEQ, 4, 16), (2, SEQ, 2, 16)  # q, and k / v


def _flat(tree, prefix=""):
    out = {}
    for name, value in tree.items():
        if isinstance(value, dict):
            out.update(_flat(value, f"{prefix}{name}/"))
        else:
            out[prefix + name] = np.asarray(value)
    return out


_loss_grad = jax.jit(jax.grad(
    lambda p, t: jax_train.loss_fn(p, t, JAX_CFG)))


def _sp_reference(params, tokens, attn, dp, sp):
    """JAX's ``make_sp_train`` on a (dp, sp) mesh of 4 CPU devices:
    (losses, final params by "/" name, masks of the weights whose
    gradient was under ILL_GRAD at some step)."""
    mesh = jax_mesh.build_mesh(jax_mesh.MeshPlan(dp=dp, sp=sp),
                               devices=jax.devices()[:WORLD])
    init_fn, step_fn, batch_shard, place = jax_sp.make_sp_train(
        mesh, JAX_CFG, attn=attn, optimizer=jax_train.make_optimizer())
    state = init_fn(place(params))
    losses, small = [], None
    for step in range(STEPS):
        # The step's gradient on one device: the mean loss of the batch.
        grads = _flat(_loss_grad(
            jax.tree_util.tree_map(np.asarray, state.params),
            jnp.asarray(tokens[step])))
        tiny = {k: (g != 0) & (np.abs(g) < ILL_GRAD)
                for k, g in grads.items()}
        small = tiny if small is None else {k: small[k] | tiny[k]
                                            for k in tiny}
        state, loss = step_fn(state, jax.device_put(tokens[step],
                                                    batch_shard))
        losses.append(float(loss))
    return losses, _flat(state.params), small


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """Runs the gang once; returns (per-rank results, {run: JAX
    reference}, JAX ring attention's (out, (dq, dk, dv)))."""
    out = tmp_path_factory.mktemp("sp_train")
    params = jax_llama.init(jax.random.PRNGKey(0), JAX_CFG)
    np.savez(out / "params.npz", **_flat(params))
    tokens = np.random.RandomState(7).randint(
        0, JAX_CFG.vocab_size, (STEPS, BATCH, SEQ + 1)).astype(np.int32)
    np.savez(out / "tokens.npz", tokens=tokens)
    rng = np.random.default_rng(11)
    q, k, v, cot = (rng.standard_normal(shape).astype(np.float32)
                    for shape in (RING_SHAPE[0], RING_SHAPE[1],
                                  RING_SHAPE[1], RING_SHAPE[0]))
    np.savez(out / "ring.npz", q=q, k=k, v=v, cot=cot)
    torch_gang.run_gang("sp_train", WORLD, out)
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False)
             for r in range(WORLD)]

    want = {label: _sp_reference(params, tokens, *run)
            for label, run in RUNS.items()}
    mesh = jax_mesh.build_mesh(jax_mesh.MeshPlan(sp=4),
                               devices=jax.devices()[:WORLD])
    fn, place = jax_ring.make_ring_attention(mesh)
    ring_out, vjp = jax.vjp(fn, *(place(jnp.asarray(t)) for t in (q, k, v)))
    ring = (np.asarray(ring_out),
            [np.asarray(g) for g in vjp(place(jnp.asarray(cot)))])
    return ranks, want, ring


@pytest.mark.parametrize("run", RUNS)
def test_losses_match_jax_make_sp_train(gang, run):
    ranks, want, _ = gang
    for rank in ranks:
        assert rank[f"{run}/step"] == STEPS
        np.testing.assert_allclose(rank[f"{run}/losses"], want[run][0],
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("run", RUNS)
def test_every_parameter_matches_jax_make_sp_train(gang, run):
    ranks, want, _ = gang
    _, final, ill = want[run]
    for name, ref in final.items():
        assert_adam_close(ranks[0][f"{run}/param/{name}"].numpy(), ref,
                          ill[name], name)


@pytest.mark.parametrize("run", RUNS)
def test_parameters_stay_replicated(gang, run):
    ranks, want, _ = gang
    for name in want[run][1]:
        for rank in ranks[1:]:
            assert torch.equal(rank[f"{run}/param/{name}"],
                               ranks[0][f"{run}/param/{name}"]), name


@pytest.mark.parametrize("what", ["out", "dq", "dk", "dv"])
def test_ring_attention_matches_jax_at_sp4(gang, what):
    ranks, _, (out, grads) = gang
    want = out if what == "out" else grads[("dq", "dk", "dv").index(what)]
    # Rank r holds sequence chunk r (dp=1).
    got = np.concatenate([rank[f"ring/{what}"].numpy() for rank in ranks],
                         axis=1)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_ulysses_refuses_kv_heads_the_axis_does_not_divide(gang):
    ranks, _, _ = gang
    for rank in ranks:
        assert rank["ulysses/refusal"] == (
            "Ulysses needs heads divisible by the sp size: H=4 K=2 n=4")


def test_unknown_attention_raises(gang):
    ranks, _, _ = gang
    for rank in ranks:
        assert "attn must be one of ['ring', 'ulysses']" in \
            rank["unknown_attn"]
