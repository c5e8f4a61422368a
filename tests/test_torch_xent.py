"""Parity of the port's chunked cross-entropy with the JAX reference and
with the dense loss."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from k8s_dra_driver_gpu_tpu.ops import xent as jax_xent
from k8s_dra_driver_gpu_tpu_torch.ops import xent as pt_xent

# fp32 on both sides; the loss and gradients differ in summation order.
TOL = 1e-5
B, S, D, V = 2, 32, 16, 64


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((B, S, D), dtype=np.float32)
    lm_head = rng.standard_normal((D, V), dtype=np.float32) / D ** 0.5
    targets = rng.integers(0, V, (B, S), dtype=np.int32)
    return hidden, lm_head, targets


def _pt_loss_and_grads(loss_fn, hidden, lm_head, targets):
    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(lm_head).requires_grad_()
    loss = loss_fn(h, w, torch.from_numpy(targets))
    loss.backward()
    return loss.item(), h.grad.numpy(), w.grad.numpy()


def _dense(h, w, targets):
    logits = (h @ w).float()
    return F.cross_entropy(logits.flatten(0, 1), targets.long().flatten())


def _jax_reference(hidden, lm_head, targets, chunk):
    def loss(h, w):
        return jax_xent.chunked_cross_entropy(
            h, w, jnp.asarray(targets), chunk=chunk)

    value, (gh, gw) = jax.value_and_grad(loss, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(lm_head))
    return float(value), np.asarray(gh), np.asarray(gw)


@pytest.mark.parametrize("chunk", [4, 8, 16])
@pytest.mark.parametrize("reference", ["jax", "dense"])
def test_chunked_matches(chunk, reference):
    hidden, lm_head, targets = _inputs()
    got = _pt_loss_and_grads(
        lambda h, w, t: pt_xent.chunked_cross_entropy(h, w, t, chunk=chunk),
        hidden, lm_head, targets)
    if reference == "jax":
        want = _jax_reference(hidden, lm_head, targets, chunk)
    else:
        want = _pt_loss_and_grads(_dense, hidden, lm_head, targets)
    np.testing.assert_allclose(got[0], want[0], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[1], want[1], atol=TOL, rtol=TOL)
    np.testing.assert_allclose(got[2], want[2], atol=TOL, rtol=TOL)


def test_bf16_loss_close():
    # bf16 hidden and lm_head cast to bf16 on both sides, logits rounded
    # to bf16 by the matmul and reduced in fp32: the losses agree to the
    # rounding of a few logits (the loss is ~log V = 4.2).
    hidden, lm_head, targets = _inputs(seed=1)
    want = jax_xent.chunked_cross_entropy(
        jnp.asarray(hidden, jnp.bfloat16), jnp.asarray(lm_head),
        jnp.asarray(targets), chunk=8)
    got = pt_xent.chunked_cross_entropy(
        torch.from_numpy(hidden).bfloat16(), torch.from_numpy(lm_head),
        torch.from_numpy(targets), chunk=8)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), atol=1e-3, rtol=1e-3)


def test_indivisible_chunk_raises():
    hidden, lm_head, targets = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="does not divide"):
        pt_xent.chunked_cross_entropy(hidden, lm_head, targets, chunk=5)


def test_no_grad_loss_equals_recorded_loss():
    hidden, lm_head, targets = (torch.from_numpy(a) for a in _inputs(seed=2))
    with torch.no_grad():
        plain = pt_xent.chunked_cross_entropy(hidden, lm_head, targets,
                                              chunk=8)
    recorded = pt_xent.chunked_cross_entropy(
        hidden.requires_grad_(), lm_head, targets, chunk=8)
    assert plain.grad_fn is None and recorded.grad_fn is not None
    torch.testing.assert_close(recorded.detach(), plain, atol=0, rtol=0)
