"""Parity of the port's training step with the JAX reference on the tiny
config: the optimizer against optax, the loss against JAX's ``loss_fn``,
the remat policies against each other, a short loss trajectory against
JAX's ``train_step``, and the launcher."""

import dataclasses
import logging
import math
import re

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from k8s_dra_driver_gpu_tpu.models import llama as jax_llama
from k8s_dra_driver_gpu_tpu.train import train as jax_train
from k8s_dra_driver_gpu_tpu_torch.convert import params_from_jax
from k8s_dra_driver_gpu_tpu_torch.models import llama as pt_llama
from k8s_dra_driver_gpu_tpu_torch.train import main as pt_main
from k8s_dra_driver_gpu_tpu_torch.train import train as pt_train

# fp32 on both sides; matches tests/test_torch_llama.py.
TOL = 1e-4

JAX_CFG = dataclasses.replace(jax_llama.LlamaConfig.tiny(), dtype=jnp.float32,
                              attn_impl="einsum")
PT_CFG = dataclasses.replace(pt_llama.LlamaConfig.tiny(), dtype=torch.float32,
                             attn_impl="einsum")
B, S = 2, 16


@pytest.fixture(scope="module")
def jax_params():
    return jax_llama.init(jax.random.PRNGKey(0), JAX_CFG)


def _batch(step):
    return pt_main.synthetic_batch(step, B, S, JAX_CFG.vocab_size)


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        for name, value in tree.items():
            yield from _paths(value, prefix + (name,))
    else:
        yield prefix, tree


def _get(tree, path):
    for name in path:
        tree = tree[name]
    return tree


# ------------------------------------------------------------ optimizer


def _opt_inputs(grad_scale, seed=0):
    rng = np.random.default_rng(seed)
    params = {"a": rng.standard_normal((4, 3), dtype=np.float32),
              "b": {"c": rng.standard_normal((5,), dtype=np.float32),
                    "d": rng.standard_normal((2, 2, 2), dtype=np.float32)}}
    grads = [jax.tree.map(lambda p: grad_scale * rng.standard_normal(
        p.shape, dtype=np.float32) / 5, params) for _ in range(2)]
    return params, grads


@pytest.mark.parametrize("mu_dtype", [None, "bf16"])
@pytest.mark.parametrize("grad_scale,clipped", [(0.5, False), (10.0, True)])
def test_optimizer_matches_optax(mu_dtype, grad_scale, clipped):
    params, grads = _opt_inputs(grad_scale)
    norms = [math.sqrt(sum(float(np.sum(g ** 2))
                           for g in jax.tree.leaves(step)))
             for step in grads]
    assert all((n >= 1.0) == clipped for n in norms)

    jopt = jax_train.make_optimizer(
        mu_dtype=jnp.bfloat16 if mu_dtype else None)
    # Jitted, as the reference's train_step runs it: XLA keeps b1 * mu in
    # fp32 there, where eager JAX would round the product to bf16.
    jupdate = jax.jit(jopt.update)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jopt.init(jp)
    popt = pt_train.make_optimizer(
        mu_dtype=torch.bfloat16 if mu_dtype else None)
    pp = params_from_jax(params)
    pstate = popt.init(pp)
    for step in grads:
        updates, jstate = jupdate(jax.tree.map(jnp.asarray, step),
                                  jstate, jp)
        jp = optax.apply_updates(jp, updates)
        pstate = popt.update(
            [torch.from_numpy(g.copy()) for g in jax.tree.leaves(step)],
            pstate, pp)
    adam = jstate[1][0]
    assert pstate["count"] == int(adam.count) == 2
    for path, leaf in _paths(pp):
        np.testing.assert_allclose(leaf.numpy(), np.asarray(_get(jp, path)),
                                   atol=1e-6, rtol=1e-6)
        mu, want_mu = _get(pstate["mu"], path), _get(adam.mu, path)
        assert mu.dtype == (torch.bfloat16 if mu_dtype else torch.float32)
        np.testing.assert_allclose(
            mu.float().numpy(), np.asarray(want_mu.astype(jnp.float32)),
            atol=1e-9, rtol=1e-6)
        np.testing.assert_allclose(_get(pstate["nu"], path).numpy(),
                                   np.asarray(_get(adam.nu, path)),
                                   atol=1e-9, rtol=1e-6)


def test_optimizer_rejects_wrong_gradient_count():
    params = {"a": torch.zeros(2), "b": torch.zeros(3)}
    opt = pt_train.make_optimizer()
    with pytest.raises(ValueError, match="1 gradients for 2"):
        opt.update([torch.zeros(2)], opt.init(params), params)


# ----------------------------------------------------------------- loss


@pytest.mark.parametrize("loss_chunk", [0, 8])
def test_loss_and_grads_match_reference(jax_params, loss_chunk):
    tokens = _batch(0)
    jcfg = dataclasses.replace(JAX_CFG, loss_chunk=loss_chunk)
    want_loss, want_grads = jax.value_and_grad(jax_train.loss_fn)(
        jax_params, jnp.asarray(tokens), jcfg)
    params = params_from_jax(jax_params)
    leaves = pt_train.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = pt_train.loss_fn(params, torch.from_numpy(tokens),
                            dataclasses.replace(PT_CFG,
                                                loss_chunk=loss_chunk))
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(loss.item(), float(want_loss), atol=TOL,
                               rtol=TOL)
    for (path, _), grad in zip(_paths(params), grads):
        np.testing.assert_allclose(
            grad.numpy(), np.asarray(_get(want_grads, path)), atol=TOL,
            rtol=TOL, err_msg=str(path))


def _grads(params, tokens, cfg):
    leaves = pt_train.tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    return torch.autograd.grad(pt_train.loss_fn(params, tokens, cfg), leaves)


@pytest.mark.parametrize("remat", ["dots", "none"])
def test_remat_policies_give_equal_grads(jax_params, remat):
    params = params_from_jax(jax_params)
    tokens = torch.from_numpy(_batch(1))
    cfg = dataclasses.replace(PT_CFG, attn_impl="flash", loss_chunk=8)
    want = _grads(params, tokens, cfg)
    got = _grads(params, tokens, dataclasses.replace(cfg, remat=remat))
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-6)


def test_bad_remat_policy_raises(jax_params):
    params = params_from_jax(jax_params)
    with pytest.raises(ValueError, match="unknown remat policy"):
        pt_train.loss_fn(params, torch.from_numpy(_batch(0)),
                         dataclasses.replace(PT_CFG, remat="offload"))


# ----------------------------------------------------------- trajectory


def _jax_trajectory(jax_params, jcfg, steps, mu_dtype=None):
    opt = jax_train.make_optimizer(mu_dtype=mu_dtype)
    state = jax_train.TrainState(jax_params, opt.init(jax_params),
                                 jnp.zeros((), jnp.int32))
    step = jax.jit(lambda st, t: jax_train.train_step(
        st, t, cfg=jcfg, optimizer=opt))
    losses = []
    for i in range(steps):
        state, loss = step(state, jnp.asarray(_batch(i)))
        losses.append(float(loss))
    return losses


def _pt_trajectory(jax_params, cfg, steps, mu_dtype=None):
    opt = pt_train.make_optimizer(mu_dtype=mu_dtype)
    params = params_from_jax(jax_params)
    state = pt_train.TrainState(params, opt.init(params), 0)
    losses = []
    for i in range(steps):
        state, loss = pt_train.train_step(
            state, torch.from_numpy(_batch(i)), cfg=cfg, optimizer=opt)
        losses.append(loss.item())
    assert state.step == steps and state.opt_state["count"] == steps
    return losses


@pytest.mark.parametrize("attn_impl,steps,mu", [
    ("einsum", 5, None), ("einsum", 5, "bf16"), ("flash", 2, None)])
def test_loss_trajectory_matches_train_step(jax_params, attn_impl, steps,
                                            mu):
    # The same converted params and batches through both steps; every
    # loss agrees to fp32 rounding carried through the Adam updates.
    jcfg = dataclasses.replace(JAX_CFG, attn_impl=attn_impl)
    cfg = dataclasses.replace(PT_CFG, attn_impl=attn_impl)
    want = _jax_trajectory(jax_params, jcfg, steps,
                           jnp.bfloat16 if mu else None)
    got = _pt_trajectory(jax_params, cfg, steps,
                         torch.bfloat16 if mu else None)
    assert want[-1] < want[0]
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


# ------------------------------------------------------------- launcher


def test_main_runs_on_cpu(caplog):
    with caplog.at_level(logging.INFO, logger=pt_main.logger.name):
        rc = pt_main.run(["--model", "tiny", "--steps", "3",
                          "--batch-size", "2", "--seq-len", "16",
                          "--device", "cpu"])
    assert rc == 0
    lines = re.findall(r"step (\d+) loss (\S+) \((\d+) tok/s\)", caplog.text)
    assert lines and lines[-1][0] == "3"
    assert all(math.isfinite(float(loss)) for _, loss, _ in lines)


def test_main_rejects_flagship_seq_len():
    with pytest.raises(SystemExit):
        pt_main.run(["--model", "flagship", "--seq-len", "1000",
                     "--device", "cpu"])


def test_synthetic_batch_is_seeded_per_step():
    a, b = pt_main.synthetic_batch(3, 2, 8, 100), \
        pt_main.synthetic_batch(3, 2, 8, 100)
    assert a.shape == (2, 9) and a.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, pt_main.synthetic_batch(4, 2, 8, 100))
    assert 0 <= a.min() and a.max() < 100
