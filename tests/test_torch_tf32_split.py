"""Why the fp32 flash kernels run their products in 3xTF32: an emulation in
torch on the CPU, at the fp32 edge shapes the card check uses, of every
product of the forward and the backward with its operands rounded to TF32
the way ``cvt.rna.tf32.f32`` and the kernels' ``tf32_rna`` round them (to
nearest, ties away from zero, 10 mantissa bits). With one TF32 product
(``1x``) the results miss the fp32 tolerance (1e-4, 1e-4) against
``flash_attention_reference`` / ``flash_attention_bwd_reference``; with
the split x = hi + lo, a.b ~ hi.hi + hi.lo + lo.hi (``3x``), they meet
it. The dQ kernel's own order of summation (16-key sums from zero, added
in fp32) is emulated too. The emulation lives here only: it is not on any
path of the port."""

import functools

import numpy as np
import pytest
import torch

from k8s_dra_driver_gpu_tpu_torch.ops import flash_attention as pt_flash

# The card check's tolerances for fp32 (chip_smoke.TOLERANCES, LSE_TOLERANCE).
ATOL = RTOL = 1e-4
LSE_TOL = 1e-3

# The card check's fp32 edge cases (label, B, S, H, K, hd, causal), but for
# the training shape (S=4096), whose whole score matrix is too large for a
# CPU test; the layouts (sliced heads, transposed view) do not change the
# arithmetic and are covered by the shapes they share.
CASES = [
    ("under one tile", 1, 100, 16, 8, 128, True),
    ("one tile", 1, 128, 16, 8, 128, True),
    ("ragged S", 2, 1000, 16, 8, 128, True),
    ("non-causal", 2, 1000, 16, 8, 128, False),
    ("gqa group 1", 2, 1000, 8, 8, 64, True),
    ("hd 64 under one tile", 1, 100, 8, 2, 64, True),
    ("gqa group 4", 1, 1000, 16, 4, 128, True),
]


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 -> the nearest TF32 value, ties away from zero: add half a
    TF32 ulp to the magnitude's bits and clear the 13 low ones."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul(a: torch.Tensor, b: torch.Tensor, mode: str) -> torch.Tensor:
    """a @ b as the tensor cores would compute it from fp32 operands:
    one TF32 product ("1x") or three ("3x"); products of TF32 values are
    exact in fp32, the sums are fp32."""
    a_hi, b_hi = tf32_rna(a), tf32_rna(b)
    if mode == "1x":
        return a_hi @ b_hi
    a_lo, b_lo = tf32_rna(a - a_hi), tf32_rna(b - b_hi)
    return (a_hi @ b_lo + a_lo @ b_hi) + a_hi @ b_hi


def emulated(q, k, v, do, causal, mode):
    """Forward (out, lse) and backward (dq, dk, dv) of one (b, kv-head)
    slice, q and dO [S, G, hd], k and v [S, hd], every product through
    ``matmul``; the rest is the kernels' fp32 arithmetic."""
    S, G, hd = q.shape
    scale = 1.0 / hd ** 0.5
    qh, doh = q.transpose(0, 1), do.transpose(0, 1)  # [G, S, hd]
    s = matmul(qh, k.T, mode) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, pt_flash.NEG_INF)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    l_safe = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = matmul(p, v, mode) / l_safe
    lse = m + torch.log(l_safe)
    p = torch.exp(s - lse)
    dp = matmul(doh, v.T, mode)
    ds = p * (dp - (doh * out).sum(-1, keepdim=True))
    dq = matmul(ds, k, mode) * scale
    dk = sum(matmul(ds[i].T, qh[i], mode) for i in range(G)) * scale
    dv = sum(matmul(p[i].T, doh[i], mode) for i in range(G))
    return (out.transpose(0, 1), lse[..., 0], dq.transpose(0, 1), dk, dv)


@functools.lru_cache(maxsize=None)
def _inputs_and_reference(label):
    """Seeded inputs of a case and the plain versions' results, one
    (b, kv-head) slice at a time: [(q, k, v, do, (out, lse, dq, dk,
    dv))]."""
    _, B, S, H, K, hd, causal = next(c for c in CASES if c[0] == label)
    rng = np.random.RandomState(CASES.index(
        next(c for c in CASES if c[0] == label)))
    G = H // K
    slices = []
    for _ in range(B * K):
        q, do = (torch.from_numpy(rng.standard_normal(
            (1, S, G, hd)).astype(np.float32)) for _ in range(2))
        k, v = (torch.from_numpy(rng.standard_normal(
            (1, S, 1, hd)).astype(np.float32)) for _ in range(2))
        out, lse = pt_flash.flash_attention_reference(q, k, v, causal, True)
        dq, dk, dv = pt_flash.flash_attention_bwd_reference(
            q, k, v, out, lse, do, causal)
        slices.append((q[0], k[0, :, 0], v[0, :, 0], do[0],
                       (out[0], lse[0], dq[0], dk[0, :, 0], dv[0, :, 0])))
    return causal, slices


def _worst(label, mode):
    """Over every slice: the largest excess of |got - want| over
    atol + rtol |want| among out, dq, dk, dv (<= 0: within), and the
    largest lse error."""
    causal, slices = _inputs_and_reference(label)
    excess, lse_err = -np.inf, 0.0
    for q, k, v, do, want in slices:
        got = emulated(q, k, v, do, causal, mode)
        for i, (a, b) in enumerate(zip(got, want)):
            if i == 1:
                lse_err = max(lse_err, (a - b).abs().max().item())
                continue
            excess = max(excess, ((a - b).abs() - ATOL
                                  - RTOL * b.abs()).max().item())
    return excess, lse_err


def test_tf32_rna_rounds_to_nearest_ties_away():
    ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits: the ulp of [1, 2)
    x = torch.tensor([1.0, 1 + ulp / 2, 1 + ulp / 4, 1 + 3 * ulp / 4,
                      -(1 + ulp / 2), 1 + ulp + ulp / 2, 3.14159265])
    want = torch.tensor([1.0, 1 + ulp, 1.0, 1 + ulp, -(1 + ulp),
                         1 + 2 * ulp, 3.140625])
    assert torch.equal(tf32_rna(x), want)
    # The low part is exact and below half an ulp of the high part.
    y = torch.from_numpy(np.random.RandomState(0).standard_normal(
        1000).astype(np.float32))
    hi = tf32_rna(y)
    assert torch.equal(hi + (y - hi), y)
    assert ((y - hi).abs() <= hi.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_one_tf32_product_misses_the_fp32_tolerance(label):
    excess, _ = _worst(label, "1x")
    assert excess > 0, excess


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_three_tf32_products_meet_the_fp32_tolerance(label):
    excess, lse_err = _worst(label, "3x")
    assert excess <= 0 and lse_err <= LSE_TOL, (excess, lse_err)


# The fp32 dQ kernel's order of summation (csrc/flash_bwd.cu,
# flash_bwd_dq_f32 through accumulate_tile): each 16 keys' dS.K products
# are summed from zero on the tensor cores, and the sums are added to dQ in
# fp32, in key order.
DQ_SUM_KEYS = 16


def emulated_dq(q, k, v, do, out, lse, causal, mode, tiled):
    """dQ of one (b, kv-head) slice (q, dO, out [S, G, hd], k, v [S, hd],
    lse [G, S]) from the forward's out and lse, every product through
    ``matmul``: S and dP, then dS.K summed as the kernel sums it
    (``tiled``: per ``DQ_SUM_KEYS`` keys from zero, then fp32 adds) or as
    one product over every key. P, D and dS are fp32; ``scale`` is applied
    once, at the end."""
    S, G, hd = q.shape
    scale = 1.0 / hd ** 0.5
    qh, doh, oh = (t.transpose(0, 1) for t in (q, do, out))  # [G, S, hd]
    s = matmul(qh, k.T, mode) * scale
    if causal:
        keep = torch.ones(S, S, dtype=torch.bool).tril()
        s = s.masked_fill(~keep, pt_flash.NEG_INF)
    p = torch.exp(s - lse[..., None])
    ds = p * (matmul(doh, v.T, mode) - (doh * oh).sum(-1, keepdim=True))
    if not tiled:
        return (matmul(ds, k, mode) * scale).transpose(0, 1)
    dq = torch.zeros(G, S, hd)
    for k0 in range(0, S, DQ_SUM_KEYS):
        dq = dq + matmul(ds[..., k0:k0 + DQ_SUM_KEYS],
                         k[k0:k0 + DQ_SUM_KEYS], mode)
    return (dq * scale).transpose(0, 1)


def _worst_dq(label, mode, tiled):
    """Over every slice: the largest excess of dQ's |got - want| over
    atol + rtol |want| (<= 0: within)."""
    causal, slices = _inputs_and_reference(label)
    excess = -np.inf
    for q, k, v, do, (out, lse, want, _, _) in slices:
        got = emulated_dq(q, k, v, do, out, lse, causal, mode, tiled)
        excess = max(excess, ((got - want).abs() - ATOL
                              - RTOL * want.abs()).max().item())
    return excess


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_dq_kernel_sums_meet_the_fp32_tolerance(label):
    # 3xTF32 products, 16-key sums from zero, fp32 adds: within (1e-4,
    # 1e-4) of flash_attention_bwd_reference's dQ.
    excess = _worst_dq(label, "3x", tiled=True)
    assert excess <= 0, excess


@pytest.mark.parametrize("label", [c[0] for c in CASES])
def test_dq_in_one_tf32_chain_misses_the_fp32_tolerance(label):
    # One TF32 product for each of S, dP and dS.K over every key misses it.
    excess = _worst_dq(label, "1x", tiled=False)
    assert excess > 0, excess
