#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and power limit; TF32 off for fp32 matmuls.
2. build: compile every kernel from ``csrc/`` (one nvcc per source, all
   started together), with ptxas's register and spill lines and its
   performance warnings; fails if a bf16 Hopper kernel (the forward, dQ,
   dK/dV) spills or ptxas serialises its wgmma or ignores its setmaxnreg.
3. kernels: hold each kernel against its plain PyTorch version on the
   card at the shapes of the main paths and at edge shapes; time the
   kernel, the plain version and one PyTorch library call computing the
   same function (timed only, never used by the port), beside the
   kernel's bound. The forward at the serving shape (forward-only) and
   at the training shape (with lse), each with its share of the bound
   and its factor over the library call; its edge cases (under one q
   tile, exactly one, ragged, non-causal, head dim 64, GQA groups 1 and
   4, sliced-heads and transposed-view layouts); the dQ and dK/dV
   backward kernels at the training shape and at edge shapes (under one
   tile, exactly one, ragged, non-causal, head dim 64, GQA groups 1 and
   4, sliced-heads and transposed-view layouts).
4. serving: Llama-3-8B at full width and depth with random weights from
   the seed, bf16: ``generate`` for B=4 prompts of 2048 tokens and 32
   greedy new tokens. Counts the kernel launches of that run, checks the
   prefill logits against the einsum attention path, runs a short int8
   KV-cache generation, and times prefill and decode.
5. training: the 738M flagship (``LlamaConfig.flagship()``) at full
   width and depth, fp32 master weights from the seed, bf16 compute,
   bf16 Adam first moment, B=4, S=4096. Holds ``loss_fn``'s gradients
   through the flash kernels against the einsum attention path, counts
   the kernel launches of one ``train_step``, checks that the loss falls
   over six steps on one batch, times the steps (median ms, tok/s, MFU,
   peak memory) and traces one.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it is the kernels' JSON record.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_BYTES_PER_S = 3.35e12

# Kernel vs plain tolerances (max |kernel - plain| <= atol + rtol * |plain|).
# bf16: both sides read the same bf16 inputs and compute scores in fp32;
# they differ in where p is rounded to bf16 (against the running max in
# the kernel, the final max in the plain version), in summation order, and
# in the final bf16 rounding of outputs of size ~1 (half an ulp is 2^-9).
# fp32: summation order only.
TOLERANCES = {torch.bfloat16: (2e-2, 2e-2), torch.float32: (1e-4, 1e-4)}
LSE_TOLERANCE = 1e-3  # fp32 lse from fp32 scores; order of summation only
# The with-lse forward on the training path, against its plain version:
# relative L2 error of each output row (all heads), worst row. Late rows
# at S=4096 average thousands of values and are near 2e-2 in size, so an
# absolute bound would not see them; per row, the bf16 rounding of p and
# of the output is a few parts in 1e3 (half an ulp is 2^-9).
FWD_ROW_REL_TOL = 1e-2

# Backward kernels vs their plain version: relative L2 error of each of
# dq, dk, dv. Both read the same bf16 inputs and out/lse and accumulate in
# fp32; they differ in summation order, in exp, where that moves the bf16
# rounding of p or dS by one ulp, and in the final bf16 rounding.
BWD_REL_TOL = 2e-2

SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
SERVE_MAX_LEN = SERVE_PROMPT + 64
# Prefill logits of the flash path against the einsum path: relative L2
# error. The einsum path rounds Q.K^T to bf16 before the softmax and the
# kernel keeps it in fp32, and that difference passes through 32 bf16
# layers of random weights.
LOGITS_REL_TOL = 5e-2

TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 4096, 6
# Flagship gradients through the flash kernels against the einsum path,
# relative L2 per parameter leaf. The einsum path rounds Q.K^T/sqrt(hd)
# and the softmax weights to bf16 and differentiates bf16 einsums; the
# kernels keep scores and P in fp32 until the products. The difference
# passes through 12 bf16 layers both ways.
GRAD_REL_TOL = 5e-2
LOSS_REL_TOL = 1e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def profile(fn, label: str, top: int = 4) -> list:
    """One traced run of ``fn``: host wall time, the device time of its
    kernels (torch.profiler), their ratio, and the costliest kernels.
    Prints "not measured" where the trace holds no device time. Returns
    the kernels' averages, costliest first."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as trace

    with trace(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if device_ms <= 0:
        log(f"trace {label}: wall {wall_ms:.1f} ms, device time not measured")
        return []
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    names = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms"
                      f" x{e.count}" for e in kernels[:top])
    log(f"trace {label}: wall {wall_ms:.1f} ms, device {device_ms:.1f} ms, "
        f"busy share {device_ms / wall_ms:.2f}; top: {names}")
    return kernels


def attention_bound_ms(B, S, H, K, hd, dtype, causal, with_lse=False):
    """Least time for one call: QK^T and PV over the unmasked pairs at
    the dtype's peak, against reading Q/K/V once and writing O (and lse)
    once at the memory rate. Returns (ms, "operations" | "bytes")."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * hd * pairs
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * B * S * hd * (2 * H + 2 * K) + (4 * B * H * S
                                                    if with_lse else 0)
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_bwd_bound_ms(B, S, H, K, hd, causal, kernel):
    """Least time for one backward kernel call in bf16: its products over
    the unmasked pairs at the bf16 peak (dQ: Q.K^T, dO.V^T, dS.K, 6*hd
    FLOP a pair; dK/dV: K.Q^T, V.dO^T, P^T.dO, dS^T.Q, 8*hd), against
    reading q, k, v, dO, lse and D once and writing its outputs once.
    Returns (ms, "operations" | "bytes")."""
    pairs = S * (S + 1) // 2 if causal else S * S
    per_pair = {"dq": 6, "dkv": 8}[kernel] * hd
    flops = per_pair * B * H * pairs
    written = B * S * hd * (H if kernel == "dq" else 2 * K)
    nbytes = 2 * (B * S * hd * (2 * H + 2 * K) + written) + 8 * B * H * S
    t_ops = flops / PEAK_FLOPS[torch.bfloat16]
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def kernel_kind(name: str) -> str:
    """A trace's kernel name -> the layer it belongs to."""
    name = name.lower()
    for kind, words in (("flash_bwd", ("flash_bwd",)),
                        ("flash_fwd", ("flash_fwd",)),
                        ("gemm", ("gemm", "nvjet", "cutlass", "xmma")),
                        ("elementwise", ("elementwise",)),
                        ("reduce", ("reduce",))):
        if any(w in name for w in words):
            return kind
    return "other"


def leaf_names(tree: dict, prefix: str = ""):
    """Dotted names of a nested dict's tensors, in ``tree_leaves`` order."""
    for name, value in tree.items():
        if isinstance(value, dict):
            yield from leaf_names(value, f"{prefix}{name}.")
        else:
            yield prefix + name


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float(), want.float()
    return ((got - want).norm() / want.norm().clamp_min(1e-30)).item()


def phase_device() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    log(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"capability {torch.cuda.get_device_capability(0)}")


KERNEL_SOURCES = ("flash_fwd", "flash_bwd")
# The Hopper kernels (TMA, wgmma, setmaxnreg) whose ptxas report must show
# no spill and no performance warning.
HOPPER_KERNELS = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")


def ptxas_spills(build_log: str) -> dict:
    """Spill stores + loads in bytes of each entry function, by mangled
    name, from ``ptxas -v`` output."""
    spills, entry = {}, None
    for line in build_log.splitlines():
        if "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "spill stores" in line and entry is not None:
            nums = [int(w) for w in line.replace(",", " ").split()
                    if w.isdigit()]
            spills[entry] = nums[1] + nums[2]  # stack, stores, loads
    return spills


def phase_build() -> None:
    from k8s_dra_driver_gpu_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNEL_SOURCES)) as pool:
        libs = list(pool.map(_build.load, KERNEL_SOURCES))
    for name, lib in zip(KERNEL_SOURCES, libs):
        log(f"build: {name}.cu in {lib.build_seconds:.1f} s -> "
            f"{lib.path.name}")
        for line in lib.log.splitlines():
            if any(w in line for w in ("Compiling entry", "registers",
                                       "spill", "Performance Loss")):
                log(f"  ptxas: {line.strip()}")
        # No spill, and no wgmma serialised or setmaxnreg ignored (ptxas's
        # C7508-C7515 performance warnings).
        bad = [e for e, n in ptxas_spills(lib.log).items()
               if n and any(k in e for k in HOPPER_KERNELS)]
        bad += [line for line in lib.log.splitlines()
                if "Performance Loss" in line
                and any(k in line for k in HOPPER_KERNELS)]
        if bad:
            raise AssertionError(f"{name}.cu Hopper kernels: {bad}")
    log(f"build: all kernels in {time.perf_counter() - t0:.1f} s")


def attention_inputs(gen, label, B, S, H, K, hd, dtype):
    """q [B,S,H,hd], k and v [B,S,K,hd] on the card. "sliced heads" cuts
    them from one packed [B,S,H+2K,hd] tensor (a fused QKV projection);
    "transposed view" reads them from head-major [B,n,S,hd] tensors."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda",
                           dtype=torch.float32).to(dtype)

    if label == "sliced heads":
        packed = randn(B, S, H + 2 * K, hd)
        return packed[:, :, :H], packed[:, :, H:H + K], packed[:, :, H + K:]
    if label == "transposed view":
        return tuple(randn(B, n, S, hd).transpose(1, 2) for n in (H, K, K))
    return tuple(randn(B, S, n, hd) for n in (H, K, K))


def phase_kernels(gen: torch.Generator) -> dict:
    from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    bf16 = torch.bfloat16
    # (label, B, S, H, K, hd, dtype, causal, with_lse)
    cases = [
        ("serving", 4, 2048, 32, 8, 128, bf16, True, False),
        ("under one q tile", 1, 100, 32, 8, 128, bf16, True, False),
        ("one q tile", 1, 128, 32, 8, 128, bf16, True, False),
        ("ragged S", 2, 1000, 32, 8, 128, bf16, True, False),
        ("non-causal", 2, 1000, 32, 8, 128, bf16, False, False),
        ("gqa group 1", 2, 1000, 8, 8, 64, bf16, True, False),
        ("hd 64 under one q tile", 1, 100, 8, 2, 64, bf16, True, False),
        ("gqa group 4", 2, 1000, 16, 4, 128, bf16, True, False),
        ("training shape", 1, 4096, 16, 8, 128, bf16, True, False),
        ("with lse", 2, 1000, 16, 4, 128, bf16, True, True),
        ("sliced heads", 2, 1000, 32, 8, 128, bf16, True, False),
        ("transposed view", 2, 1000, 32, 8, 128, bf16, True, True),
        ("fp32", 1, 1000, 8, 2, 128, torch.float32, True, True),
        ("fp32 non-causal", 1, 520, 8, 8, 64, torch.float32, False, False),
    ]
    record = None
    for label, B, S, H, K, hd, dtype, causal, with_lse in cases:
        q, k, v = attention_inputs(gen, label, B, S, H, K, hd, dtype)
        got = flash_attention(q, k, v, causal=causal, with_lse=with_lse)
        want = flash_attention_reference(q, k, v, causal=causal,
                                         with_lse=with_lse)
        torch.cuda.synchronize()
        if with_lse:
            (got, got_lse), (want, want_lse) = got, want
            lse_err = (got_lse - want_lse).abs().max().item()
            if not lse_err <= LSE_TOLERANCE:
                raise AssertionError(f"{label}: lse max err {lse_err}")
        atol, rtol = TOLERANCES[dtype]
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        excess = (diff - atol - rtol * want.float().abs()).max().item()
        if not (torch.isfinite(got).all() and excess <= 0):
            raise AssertionError(
                f"{label}: max err {err} over atol {atol} rtol {rtol}")
        bound, bound_by = attention_bound_ms(B, S, H, K, hd, dtype, causal,
                                             with_lse)
        line = (f"kernel {label}: B={B} S={S} H={H} K={K} hd={hd} "
                f"{str(dtype)[6:]} causal={causal} lse={with_lse} "
                f"max_abs_err={err:.3g} (atol {atol}, rtol {rtol})")
        if label == "serving":
            ms = time_ms(lambda: flash_attention(q, k, v, causal=causal), 20)
            plain_ms = time_ms(
                lambda: flash_attention_reference(q, k, v, causal=causal), 5)
            lse_ms = time_ms(lambda: flash_attention(
                q, k, v, causal=causal, with_lse=True), 20)
            lse_bound, _ = attention_bound_ms(B, S, H, K, hd, dtype, causal,
                                              with_lse=True)
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = time_ms(
                lambda: F.scaled_dot_product_attention(
                    qt, kt, vt, is_causal=causal, enable_gqa=True), 20)
            line += (f" ms={ms:.4f} plain_ms={plain_ms:.4f} "
                     f"sdpa_ms={library_ms:.4f} bound_ms={bound:.4f} "
                     f"({bound_by}) roofline_share={bound / ms:.3f} "
                     f"factor_over_library={ms / library_ms:.2f} "
                     f"with_lse_ms={lse_ms:.4f} "
                     f"with_lse_bound_ms={lse_bound:.4f}")
            record = {
                "name": "flash_attention", "route": "cuda",
                "source": "k8s_dra_driver_gpu_tpu_torch/csrc/flash_fwd.cu",
                "replaces": "k8s_dra_driver_gpu_tpu/ops/flash_attention.py:40",
                "launches": None, "max_abs_err": err, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": library_ms,
            }
        log(line)
        del q, k, v, got, want
    torch.cuda.empty_cache()
    return record


def sdpa_backward_ms(q, k, v, do) -> tuple[float, str]:
    """Device time of the backward of ``F.scaled_dot_product_attention``
    (causal) through ``torch.autograd.grad``, the forward outside the
    timer, on PyTorch's flash backend: with ``enable_gqa`` where that
    backend takes it, else with K/V expanded to every q-head beforehand
    (its dK/dV then come per q-head, without the group sum)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[2] // k.shape[2]
    for expand in (False, True):
        kv = [t.repeat_interleave(group, dim=2) if expand else t
              for t in (k, v)]
        leaves = [t.detach().requires_grad_() for t in (q, *kv)]
        try:
            with sdpa_kernel(SDPBackend.FLASH_ATTENTION):
                out = F.scaled_dot_product_attention(
                    *(t.transpose(1, 2) for t in leaves), is_causal=True,
                    enable_gqa=not expand)
        except RuntimeError as err:
            log(f"sdpa flash backend refused enable_gqa: "
                f"{str(err).splitlines()[0][:120]}")
            continue
        grad_out = do.transpose(1, 2)
        ms = time_ms(lambda: torch.autograd.grad(
            out, leaves, grad_out, retain_graph=True), 10)
        return ms, ("flash backend, K/V expanded" if expand
                    else "flash backend, enable_gqa")
    raise RuntimeError("no SDPA flash backward to time")


def phase_training_kernels(gen: torch.Generator) -> tuple[dict, dict, dict]:
    """The kernels of the training path: the with-lse forward and the dQ
    and dK/dV backward kernels, held against their plain versions at the
    training shape (B=1 on the plain side) and at edge shapes, then timed
    at B=4. Returns (with-lse forward numbers, dQ record, dK/dV record)."""
    from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
        _bwd_launchers, flash_attention, flash_attention_bwd,
        flash_attention_bwd_reference, flash_attention_reference)

    def inputs(B, S, H, K, hd, dtype=torch.bfloat16, label=""):
        """q, k, v in the case's layout (``attention_inputs``) and a
        contiguous dO."""
        q, k, v = attention_inputs(gen, label, B, S, H, K, hd, dtype)
        do = torch.randn((B, S, H, hd), generator=gen, device="cuda",
                         dtype=torch.float32).to(dtype)
        return q, k, v, do

    # (label, B, S, H, K, hd, causal)
    cases = [
        ("training", 1, TRAIN_SEQ, 16, 8, 128, True),
        ("under one tile", 1, 100, 16, 8, 128, True),
        ("one tile", 1, 128, 16, 8, 128, True),
        ("ragged S", 2, 1000, 16, 8, 128, True),
        ("non-causal", 2, 1000, 16, 8, 128, False),
        ("gqa group 1", 2, 1000, 8, 8, 64, True),
        ("hd 64 under one tile", 1, 100, 8, 2, 64, True),
        ("gqa group 4", 1, 1000, 16, 4, 128, True),
        ("sliced heads", 2, 1000, 16, 8, 128, True),
        ("transposed view", 2, 1000, 16, 8, 128, True),
    ]
    max_err = {"dq": 0.0, "dkv": 0.0, "forward": 0.0}
    for label, B, S, H, K, hd, causal in cases:
        q, k, v, do = inputs(B, S, H, K, hd, label=label)
        out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
        want_out, want_lse = flash_attention_reference(q, k, v, causal, True)
        torch.cuda.synchronize()
        diff = (out.float() - want_out.float()).flatten(2)
        row_rel = (diff.norm(dim=-1) / want_out.float().flatten(2).norm(
            dim=-1).clamp_min(1e-30)).max().item()
        out_err = diff.abs().max().item()
        lse_err = (lse - want_lse).abs().max().item()
        log(f"kernel with-lse forward {label}: B={B} S={S} H={H} K={K} "
            f"hd={hd} bf16 causal={causal}: out worst-row rel L2 "
            f"{row_rel:.3g} max_abs_err={out_err:.3g} (tol row rel L2 "
            f"{FWD_ROW_REL_TOL}); lse max_abs_err={lse_err:.3g} (tol "
            f"{LSE_TOLERANCE})")
        if not (torch.isfinite(out).all() and torch.isfinite(lse).all()
                and row_rel <= FWD_ROW_REL_TOL and lse_err <= LSE_TOLERANCE):
            raise AssertionError(f"with-lse forward {label} disagrees with "
                                 "its plain version")
        if label == "training":
            max_err["forward"] = out_err
        del want_out, want_lse, diff
        got = flash_attention_bwd(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        want = flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
        errs = []
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            rel = rel_l2(a, b)
            err = (a.float() - b.float()).abs().max().item()
            errs.append(f"{name} rel_l2={rel:.3g} max_abs_err={err:.3g}")
            if not (torch.isfinite(a).all() and rel <= BWD_REL_TOL):
                raise AssertionError(f"backward {label}: {name} rel L2 "
                                     f"{rel} over {BWD_REL_TOL}")
            kernel = "dq" if name == "dq" else "dkv"
            if label == "training":
                max_err[kernel] = max(max_err[kernel], err)
        log(f"kernel backward {label}: B={B} S={S} H={H} K={K} hd={hd} bf16 "
            f"causal={causal}: {'; '.join(errs)} (tol rel L2 {BWD_REL_TOL})")
        del q, k, v, do, out, lse, got, want
    q, k, v, do = inputs(1, 64, 4, 2, 128, dtype=torch.float32)
    try:
        flash_attention_bwd(q, k, v, q, torch.zeros(1, 4, 64, device="cuda"),
                            do)
    except ValueError as err:
        log(f"kernel backward fp32: refused as intended ({err})")
    else:
        raise AssertionError("fp32 backward on the card did not raise")
    launched = flash_attention.launches
    try:
        flash_attention(q.requires_grad_(), k, v)
    except ValueError as err:
        log(f"kernel fp32 forward needing a gradient: refused before any "
            f"launch ({err})")
    else:
        raise AssertionError("fp32 flash attention needing a gradient on "
                             "the card did not raise")
    if flash_attention.launches != launched:
        raise AssertionError("fp32 forward launched before it was refused")
    del q, k, v, do
    torch.cuda.empty_cache()

    # Timing at the training shape.
    B, S, H, K, hd = TRAIN_BATCH, TRAIN_SEQ, 16, 8, 128
    q, k, v, do = inputs(B, S, H, K, hd)
    fwd = {"max_abs_err": max_err["forward"],
           "ms": time_ms(lambda: flash_attention(q, k, v, with_lse=True), 20),
           "plain_ms": time_ms(lambda: flash_attention_reference(
               q, k, v, True, True), 3, warmup=1)}
    fwd["bound_ms"], fwd["bound_by"] = attention_bound_ms(
        B, S, H, K, hd, torch.bfloat16, True, with_lse=True)
    qt, kx, vx = (t.transpose(1, 2) for t in (
        q, k.repeat_interleave(H // K, 2), v.repeat_interleave(H // K, 2)))
    fwd["library_ms"] = time_ms(
        lambda: torch.ops.aten._scaled_dot_product_flash_attention(
            qt, kx, vx, 0.0, True), 20)
    del qt, kx, vx
    log(f"kernel with-lse forward at training shape B={B} S={S} H={H} K={K} "
        f"hd={hd}: ms={fwd['ms']:.4f} plain_ms={fwd['plain_ms']:.4f} "
        f"library_ms={fwd['library_ms']:.4f} (aten flash, K/V expanded, "
        f"returns lse) bound_ms={fwd['bound_ms']:.4f} ({fwd['bound_by']}) "
        f"roofline_share={fwd['bound_ms'] / fwd['ms']:.3f} "
        f"factor_over_library={fwd['ms'] / fwd['library_ms']:.2f}")

    out, lse = flash_attention(q, k, v, with_lse=True)
    launch_dq, launch_dkv, _ = _bwd_launchers(q, k, v, out, lse, do, True)
    dq_ms = time_ms(launch_dq, 20)
    dkv_ms = time_ms(launch_dkv, 20)
    bwd_ms = time_ms(
        lambda: flash_attention_bwd(q, k, v, out, lse, do, True), 10)
    plain_ms = time_ms(lambda: flash_attention_bwd_reference(
        q, k, v, out, lse, do, True), 2, warmup=1)
    library_ms, library_how = sdpa_backward_ms(q, k, v, do)
    log(f"kernel backward at training shape B={B} S={S} H={H} K={K} hd={hd}: "
        f"dq_ms={dq_ms:.4f} dkv_ms={dkv_ms:.4f} whole backward (D, dQ, "
        f"dK/dV) ms={bwd_ms:.4f}; plain backward ms={plain_ms:.4f}; SDPA "
        f"backward ms={library_ms:.4f} ({library_how})")
    records = []
    for kernel, ms, line in (("dq", dq_ms, 104), ("dkv", dkv_ms, 157)):
        bound, bound_by = attention_bwd_bound_ms(B, S, H, K, hd, True, kernel)
        log(f"kernel {kernel}: ms={ms:.4f} bound_ms={bound:.4f} ({bound_by}) "
            f"roofline_share={bound / ms:.3f}")
        records.append({
            "name": f"flash_attention_bwd_{kernel}", "route": "cuda",
            "source": "k8s_dra_driver_gpu_tpu_torch/csrc/flash_bwd.cu",
            "replaces": f"k8s_dra_driver_gpu_tpu/ops/flash_attention.py:{line}",
            "launches": None, "max_abs_err": max_err[kernel], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms,
        })
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()
    return fwd, records[0], records[1]


def phase_serving(seed: int) -> int:
    from k8s_dra_driver_gpu_tpu_torch.models import decode, llama
    from k8s_dra_driver_gpu_tpu_torch.ops import resolve_device
    from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
        flash_attention)

    device = resolve_device()
    cfg = llama.LlamaConfig.llama3_8b()
    gen = torch.Generator(device=device).manual_seed(seed)
    t0 = time.perf_counter()
    params = llama.init(cfg, gen, device, dtype=cfg.dtype)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in [params["embed"], params["lm_head"],
                                      *params["layers"].values()])
    log(f"serving: Llama-3-8B {n_params / 1e9:.2f}B params bf16 on "
        f"{device}, init {time.perf_counter() - t0:.1f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.1f} GiB")
    prompt = torch.randint(0, cfg.vocab_size, (SERVE_BATCH, SERVE_PROMPT),
                           generator=gen, device=device, dtype=torch.int32)

    # The main path, counted: one generate call.
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention.lse_launches = 0
    t0 = time.perf_counter()
    tokens = decode.generate(params, prompt, cfg, SERVE_NEW, SERVE_MAX_LEN)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = flash_attention.launches
    if launches != cfg.n_layers or flash_attention.lse_launches:
        raise AssertionError(
            f"flash kernel launched {launches} times in generate "
            f"({flash_attention.lse_launches} with lse), want {cfg.n_layers}"
            " forward-only (one a layer)")
    if tokens.shape != (SERVE_BATCH, SERVE_NEW) or \
            not ((tokens >= 0) & (tokens < cfg.vocab_size)).all():
        raise AssertionError(f"bad tokens {tokens.shape}")
    log(f"serving: generate B={SERVE_BATCH} S={SERVE_PROMPT} "
        f"new={SERVE_NEW} in {gen_s:.3f} s (first call), flash launches "
        f"{launches}, peak {torch.cuda.max_memory_allocated() / 2**30:.1f} "
        f"GiB")

    # Prefill and decode timed after the first call.
    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    (logits, cache), pre_s = timed(
        lambda: decode.prefill(params, prompt, cfg, SERVE_MAX_LEN))
    n_steps = 16
    step_s = []
    token = tokens[:, 0]
    for _ in range(n_steps):
        (_, cache), s = timed(
            lambda: decode.decode_step(params, cache, token, cfg))
        step_s.append(s)
    step_s.sort()
    log(f"serving: prefill {pre_s * 1e3:.1f} ms = "
        f"{SERVE_BATCH * SERVE_PROMPT / pre_s:.0f} tok/s; decode median "
        f"{step_s[n_steps // 2] * 1e3:.2f} ms/step (B={SERVE_BATCH}, "
        f"{SERVE_BATCH / step_s[n_steps // 2]:.0f} tok/s), min "
        f"{step_s[0] * 1e3:.2f} ms")
    profile(lambda: decode.prefill(params, prompt, cfg, SERVE_MAX_LEN),
            "prefill")
    profile(lambda: [decode.decode_step(params, cache, token, cfg)
                     for _ in range(4)], "4 decode steps")
    del cache

    # Correctness: flash prefill against the einsum attention path.
    ref_logits, ref_cache = decode.prefill(
        params, prompt, dataclasses.replace(cfg, attn_impl="einsum"),
        SERVE_MAX_LEN)
    del ref_cache
    if not (torch.isfinite(logits).all() and torch.isfinite(ref_logits).all()):
        raise AssertionError("non-finite prefill logits")
    rel = ((logits - ref_logits).norm() / ref_logits.norm()).item()
    agree = (logits.argmax(-1) == ref_logits.argmax(-1)).float().mean().item()
    log(f"serving: prefill logits flash vs einsum rel L2 err {rel:.3g} "
        f"(tol {LOGITS_REL_TOL}), argmax agreement {agree:.2f}, "
        f"logits std {ref_logits.std().item():.3g}")
    if not rel <= LOGITS_REL_TOL:
        raise AssertionError(f"prefill logits rel err {rel}")
    if not torch.equal(logits.argmax(-1).int(), tokens[:, 0]):
        raise AssertionError("timed prefill disagrees with generate's first "
                             "token")

    # int8 KV cache: prefill attention reads unquantized k/v, so the
    # first token must equal the fp cache's.
    q_tokens = decode.generate(params, prompt, cfg, 8, SERVE_MAX_LEN,
                               kv_quant=True)
    torch.cuda.synchronize()
    if not torch.equal(q_tokens[:, 0], tokens[:, 0]):
        raise AssertionError("int8-cache first token differs from fp cache")
    same = (q_tokens == tokens[:, :8]).float().mean().item()
    log(f"serving: int8 KV generate 8 tokens ok, agreement with fp cache "
        f"{same:.2f}")
    return launches


def phase_training(seed: int) -> dict:
    """Flagship training at full width and depth; returns the kernel
    launch counts of one ``train_step``."""
    from k8s_dra_driver_gpu_tpu_torch.models import llama
    from k8s_dra_driver_gpu_tpu_torch.ops import resolve_device
    from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd)
    from k8s_dra_driver_gpu_tpu_torch.train.train import (
        TrainState, loss_fn, make_optimizer, train_step, tree_leaves)

    device = resolve_device()
    cfg = llama.LlamaConfig.flagship()
    gen = torch.Generator(device=device).manual_seed(seed)
    params = llama.init(cfg, gen, device, dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device=device, dtype=torch.int32)
    names = list(leaf_names(params))
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"training: flagship {n_params / 1e6:.1f}M params fp32 master, "
        f"{str(cfg.dtype)[6:]} compute, loss_chunk={cfg.loss_chunk}, "
        f"remat={cfg.remat}, B={TRAIN_BATCH} S={TRAIN_SEQ}")

    # Gradients through the flash kernels against the einsum path, from
    # the same initial parameters.
    def grads(attn_impl):
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = loss_fn(params, tokens,
                       dataclasses.replace(cfg, attn_impl=attn_impl))
        return loss.detach(), torch.autograd.grad(loss, leaves)

    loss_flash, g_flash = grads("flash")
    loss_einsum, g_einsum = grads("einsum")
    errs = [rel_l2(a, b) for a, b in zip(g_flash, g_einsum)]
    loss_rel = abs((loss_flash - loss_einsum) / loss_einsum).item()
    finite = all(torch.isfinite(g).all() for g in g_flash)
    log("training: grads flash vs einsum rel L2 per leaf: " + ", ".join(
        f"{n} {e:.3g}" for n, e in zip(names, errs))
        + f" (tol {GRAD_REL_TOL}); loss flash {loss_flash.item():.6f} einsum "
        f"{loss_einsum.item():.6f} rel {loss_rel:.3g} (tol {LOSS_REL_TOL})")
    if not (finite and max(errs) <= GRAD_REL_TOL and loss_rel <= LOSS_REL_TOL):
        raise AssertionError("flagship gradients through the flash kernels "
                             "disagree with the einsum path")
    del g_flash, g_einsum
    torch.cuda.empty_cache()

    optimizer = make_optimizer(mu_dtype=torch.bfloat16)
    state = TrainState(params, optimizer.init(params), 0)

    # The main path, counted: one train_step.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention.lse_launches = 0
    flash_attention_bwd.dq_launches = flash_attention_bwd.dkv_launches = 0
    t0 = time.perf_counter()
    state, loss = train_step(state, tokens, cfg=cfg, optimizer=optimizer)
    losses = [loss.item()]
    first_s = time.perf_counter() - t0
    counts = {"forward_lse": flash_attention.lse_launches,
              "forward_only": (flash_attention.launches
                               - flash_attention.lse_launches),
              "dq": flash_attention_bwd.dq_launches,
              "dkv": flash_attention_bwd.dkv_launches}
    want = {"forward_lse": 2 * cfg.n_layers, "forward_only": 0,
            "dq": cfg.n_layers, "dkv": cfg.n_layers}
    log(f"training: one train_step launched {counts} (want {want}; "
        f"{first_s * 1e3:.1f} ms, first step)")
    if counts != want:
        raise AssertionError(f"train_step kernel launches {counts}, "
                             f"want {want}")

    # Learning and time: more steps on the same batch.
    step_s = []
    for _ in range(TRAIN_STEPS - 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = train_step(state, tokens, cfg=cfg, optimizer=optimizer)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log("training: losses on one batch " + " ".join(
        f"{x:.4f}" for x in losses))
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"flagship loss did not fall: {losses}")
    step = statistics.median(step_s)
    tok_s = TRAIN_BATCH * TRAIN_SEQ / step
    mfu = 6 * n_params * TRAIN_BATCH * TRAIN_SEQ / step / PEAK_FLOPS[
        torch.bfloat16]
    log(f"training: step median {step * 1e3:.1f} ms over {len(step_s)} "
        f"steps (min {min(step_s) * 1e3:.1f}, max {max(step_s) * 1e3:.1f}), "
        f"{tok_s:.0f} tok/s, MFU {mfu:.3f} (6*N*tokens at 989 TFLOP/s, "
        f"attention uncounted), peak {peak_gib:.1f} GiB")

    def traced_step():
        nonlocal state
        state, loss = train_step(state, tokens, cfg=cfg, optimizer=optimizer)
        loss.item()

    kernels = profile(traced_step, "train step", top=12)
    total = sum(e.self_device_time_total for e in kernels)
    if total > 0:
        shares = {}
        for e in kernels:
            shares[kernel_kind(e.key)] = (shares.get(kernel_kind(e.key), 0)
                                          + e.self_device_time_total)
        log("trace train step: device time by kind " + ", ".join(
            f"{kind} {us / 1e3:.1f} ms ({us / total:.2f})"
            for kind, us in sorted(shares.items(), key=lambda kv: -kv[1])))
    del state
    torch.cuda.empty_cache()
    return counts


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_device()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    forward = phase_kernels(gen)
    with_lse, dq, dkv = phase_training_kernels(gen)
    serving_launches = phase_serving(args.seed)
    torch.cuda.empty_cache()
    training = phase_training(args.seed)
    forward["launches"] = serving_launches + training["forward_lse"]
    forward["launches_by_path"] = {
        "serving_generate": serving_launches,
        "training_step": training["forward_lse"]}
    forward.update({f"with_lse_{key}": value
                    for key, value in with_lse.items()})
    dq["launches"] = training["dq"]
    dkv["launches"] = training["dkv"]
    log(f"kernels: flash_attention launches={forward['launches']} "
        f"{forward['launches_by_path']}, dq {dq['launches']}, dk/dv "
        f"{dkv['launches']} (total {time.perf_counter() - t_start:.1f} s)")
    print(json.dumps({"kernels": [forward, dq, dkv]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
