#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and power limit; TF32 off for fp32 matmuls.
2. build: compile every kernel of the serving path from ``csrc/``.
3. kernels: hold each kernel against its plain PyTorch version on the
   card at the serving shape and at edge shapes; time the kernel, the
   plain version and one PyTorch library call computing the same
   function (timed only, never used by the port), beside the kernel's
   bound.
4. serving: Llama-3-8B at full width and depth with random weights from
   the seed, bf16: ``generate`` for B=4 prompts of 2048 tokens and 32
   greedy new tokens. Counts the kernel launches of that run, checks the
   prefill logits against the einsum attention path, runs a short int8
   KV-cache generation, and times prefill and decode.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it is the kernels' JSON record.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time

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

SERVE_BATCH, SERVE_PROMPT, SERVE_NEW = 4, 2048, 32
SERVE_MAX_LEN = SERVE_PROMPT + 64
# Prefill logits of the flash path against the einsum path: relative L2
# error. The einsum path rounds Q.K^T to bf16 before the softmax and the
# kernel keeps it in fp32, and that difference passes through 32 bf16
# layers of random weights.
LOGITS_REL_TOL = 5e-2


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


def profile(fn, label: str) -> None:
    """One traced run of ``fn``: host wall time, the device time of its
    kernels (torch.profiler), their ratio, and the costliest kernels.
    Prints "not measured" where the trace holds no device time."""
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
        return
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    top = ", ".join(f"{e.key[:40]} {e.self_device_time_total / 1e3:.1f} ms"
                    f" x{e.count}" for e in kernels[:4])
    log(f"trace {label}: wall {wall_ms:.1f} ms, device {device_ms:.1f} ms, "
        f"busy share {device_ms / wall_ms:.2f}; top: {top}")


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


def phase_build() -> None:
    from k8s_dra_driver_gpu_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib = _build.load("flash_fwd")
    log(f"build: flash_fwd.cu in {lib.build_seconds:.1f} s "
        f"(load {time.perf_counter() - t0:.1f} s) -> {lib.path.name}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"  ptxas: {line.strip()}")


def phase_kernels(gen: torch.Generator) -> dict:
    from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_reference)

    # (label, B, S, H, K, hd, dtype, causal, with_lse)
    cases = [
        ("serving", 4, 2048, 32, 8, 128, torch.bfloat16, True, False),
        ("ragged S", 2, 1000, 32, 8, 128, torch.bfloat16, True, False),
        ("non-causal", 2, 1000, 32, 8, 128, torch.bfloat16, False, False),
        ("gqa group 1", 2, 1000, 8, 8, 64, torch.bfloat16, True, False),
        ("with lse", 2, 1000, 16, 4, 128, torch.bfloat16, True, True),
        ("fp32", 1, 1000, 8, 2, 128, torch.float32, True, True),
        ("fp32 non-causal", 1, 520, 8, 8, 64, torch.float32, False, False),
    ]
    record = None
    for label, B, S, H, K, hd, dtype, causal, with_lse in cases:
        q, k, v = (torch.randn((B, S, n, hd), generator=gen, device="cuda",
                               dtype=torch.float32).to(dtype)
                   for n in (H, K, K))
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
    flash_attention.launches = 0
    t0 = time.perf_counter()
    tokens = decode.generate(params, prompt, cfg, SERVE_NEW, SERVE_MAX_LEN)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = flash_attention.launches
    if launches != cfg.n_layers:
        raise AssertionError(f"flash kernel launched {launches} times in "
                             f"generate, want {cfg.n_layers} (one a layer)")
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
    record = phase_kernels(gen)
    record["launches"] = phase_serving(args.seed)
    log(f"kernels: flash_attention launches={record['launches']} "
        f"(total {time.perf_counter() - t_start:.1f} s)")
    print(json.dumps({"kernels": [record]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
