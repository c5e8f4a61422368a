"""Parity of the port's ring-attention pieces with the JAX reference, in
one process, fp32: ``_chunk_attention`` on a diagonal, a whole, a fully
masked and a non-causal chunk, ``_merge``, and ring attention's result
over two chunks merged on one rank with its q/k/v gradients. The
distributed trainers run on the 4-rank gangs of
``tests/test_torch_sp_train.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu.parallel import ring_attention as jax_ring
from k8s_dra_driver_gpu_tpu_torch.parallel import ring_attention as pt_ring

TOL = 1e-5
B, S, H, K, HD = 2, 8, 4, 2, 16


def _qkv(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, S, H, HD)).astype(np.float32),
            rng.standard_normal((B, S, K, HD)).astype(np.float32),
            rng.standard_normal((B, S, K, HD)).astype(np.float32))


def _assert_close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=TOL, atol=TOL)


# (q_offset, k_offset, causal): the diagonal chunk, a whole earlier chunk,
# a fully masked later chunk, and a chunk without the causal mask.
CHUNKS = [(0, 0, True), (S, 0, True), (0, S, True), (0, S, False)]


@pytest.mark.parametrize("q_offset,k_offset,causal", CHUNKS)
def test_chunk_attention_matches_reference(q_offset, k_offset, causal):
    q, k, v = _qkv()
    want = jax_ring._chunk_attention(*map(jnp.asarray, (q, k, v)), q_offset,
                                     k_offset, causal)
    got = pt_ring._chunk_attention(*map(torch.from_numpy, (q, k, v)),
                                   q_offset, k_offset, causal)
    _assert_close(got, want)
    if k_offset > q_offset and causal:
        # Fully masked: nothing attended, m held at NEG_INF / 2.
        assert not got[0].any() and not got[2].any()
        assert (got[1] == pt_ring.NEG_INF / 2).all()


@pytest.mark.parametrize("masked_second", [False, True])
def test_merge_matches_reference(masked_second):
    q, k, v = _qkv()
    k2, v2 = _qkv(seed=1)[1:]
    offsets = [(S, 0), (S, 2 * S if masked_second else S)]
    parts_jax = [jax_ring._chunk_attention(
        *map(jnp.asarray, (q, kk, vv)), qo, ko, True)
        for (qo, ko), kk, vv in zip(offsets, (k, k2), (v, v2))]
    parts_pt = [pt_ring._chunk_attention(
        *map(torch.from_numpy, (q, kk, vv)), qo, ko, True)
        for (qo, ko), kk, vv in zip(offsets, (k, k2), (v, v2))]
    _assert_close(pt_ring._merge(*parts_pt), jax_ring._merge(*parts_jax))


def _two_chunk_attention(ring, q, k, v, clamp):
    """Rank 1 of a 2-rank ring, its chunks merged in place: its q rows
    [S, 2S) against chunks 1 (its own) then 0, then normalised."""
    acc = ring._chunk_attention(q, k[:, S:], v[:, S:], S, S, True)
    acc = ring._merge(acc, ring._chunk_attention(q, k[:, :S], v[:, :S], S,
                                                 0, True))
    o, _, l = acc
    return o / clamp(l)


def test_merged_chunks_and_gradients_match_reference():
    q = _qkv(seed=2)[0]
    k = np.concatenate(_qkv(seed=3)[1:2] + _qkv(seed=4)[1:2], axis=1)
    v = np.concatenate(_qkv(seed=5)[2:3] + _qkv(seed=6)[2:3], axis=1)
    cot = np.random.default_rng(7).standard_normal(q.shape).astype(np.float32)

    def jax_obj(qq, kk, vv):
        out = _two_chunk_attention(jax_ring, qq, kk, vv,
                                   lambda l: jnp.maximum(l, 1e-30))
        return jnp.sum(out * cot), out

    (_, want), want_grads = jax.value_and_grad(
        jax_obj, argnums=(0, 1, 2), has_aux=True)(
        *map(jnp.asarray, (q, k, v)))
    leaves = [torch.from_numpy(t).requires_grad_() for t in (q, k, v)]
    out = _two_chunk_attention(pt_ring, *leaves,
                               lambda l: l.clamp_min(1e-30))
    (out * torch.from_numpy(cot)).sum().backward()
    _assert_close([out], [want])
    _assert_close([t.grad for t in leaves], want_grads)
