#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and power limit; TF32 off for fp32 matmuls.
1b. device layer: ``tpulib.load()`` must give ``NvmlLib`` (NVML over
   ctypes). Its structs' ctypes layout against the toolkit's ``nvml.h``
   (a C probe built with the host compiler); every GPU against
   ``nvidia-smi --query-gpu=index,uuid,name,memory.total,power.limit,
   pci.bus_id``, field by field; the devfs backend on the same host
   against NVML (minors, bus ids, NUMA nodes); ``cuda:0`` matched by
   UUID, memory as an inequality; one ``health()`` poll of the idle card
   and whether NVML took the event registration; a ``chip_telemetry``
   sample idle and during ~2 s of bf16 products (the window's mean power
   at or under the limit, its peak logged; memory used up by at least the
   bytes allocated; duty > 0); the
   NVLink error fields (``nvmlDeviceGetFieldValues``, the legacy counters
   in place of a refused field) link by link, what NVML gave and refused,
   ``ici_link_errors`` held to the sum of what it gave and the field
   values to ``nvidia-smi nvlink -e``'s counters where it prints them
   (the probe also holds ``nvmlFieldValue_t`` and the ``NVML_FI_*`` ids
   to ``nvml.h``); the
   MIG mode and profile count, the CLI's JSON, what NVML refused, and the
   host milliseconds of ``enumerate()`` and of one ``health()`` poll.
2. build: compile every kernel from ``csrc/`` (one nvcc per source, all
   started together), with ptxas's register and spill lines and its
   performance warnings; fails if a Hopper kernel (the bf16 and the fp32
   forward, dQ and dK/dV) spills or ptxas warns of lost performance (a
   serialised wgmma, an ignored setmaxnreg).
3. kernels: hold each kernel against its plain PyTorch version on the
   card at the shapes of the main paths and at edge shapes; time the
   kernel, the plain version and one PyTorch library call computing the
   same function (timed only, never used by the port), beside the
   kernel's bound. The forward at the serving shape (forward-only) and
   at the training shape (with lse), each with its share of the bound
   and its factor over the library call; its edge cases (under one q
   tile, exactly one, ragged, non-causal, head dim 64, GQA groups 1 and
   4, sliced-heads and transposed-view layouts); the dQ and dK/dV
   backward kernels at the flagship's and the MoE-Llama's (head dim 64)
   training shapes and at edge shapes (under one tile, exactly one,
   ragged, non-causal, head dim 64, GQA groups 1 and 4, sliced-heads and
   transposed-view layouts), the three timed at both training shapes.
   The fp32 entries of all three at the backward's edge shapes,
   elementwise within ``TOLERANCES[torch.float32]``, timed at the
   training shape against
   SDPA's memory-efficient backend, each with its share of the bound of
   its route (3xTF32 on the tensor cores) and the FMA bound beside, and
   one fp32 gradient of a 2-layer
   flagship-width model through ``attention(impl="auto")`` against the
   einsum path, with its launch counts.
4. serving: Llama-3-8B at full width and depth with random weights from
   the seed, bf16: ``generate`` for B=4 prompts of 2048 tokens and 32
   greedy new tokens. Counts the kernel launches of that run, checks the
   prefill logits against the einsum attention path, runs a short int8
   KV-cache generation, times prefill and decode, and samples 8 tokens
   at temperature 1.0 from a generator seeded with the seed.
5. training: the 738M flagship (``LlamaConfig.flagship()``) at full
   width and depth, fp32 master weights from the seed, bf16 compute,
   bf16 Adam first moment, B=4, S=4096. Holds ``loss_fn``'s gradients
   through the flash kernels against the einsum path, counts the kernel
   launches of one ``train_step``, checks that the loss falls over six
   steps on one batch, times the steps (median ms, tok/s, MFU, peak
   memory) and traces one.
6. gang: a gang of one over NCCL, joined by the launcher's
   ``initialize_distributed`` from the ComputeDomain env, and a mesh over
   it. ``make_sharded_train`` (DTensor parameters and moments) on phase
   5's flagship, parameters and batch: step 1's loss against
   ``train_step``'s, steps 2-3, launch counts, step median, MFU, peak
   memory and a trace; ``make_scanned_sharded_train`` with K=3 against
   three single steps; ``make_sharded_generate`` on phase 4's Llama-3-8B
   weights (drawn again from the seed): tokens and prefill logits
   against ``generate``'s, launch count, prefill and decode times, then
   phase 4's sampled draw (tokens equal, launches counted); a one-row
   prompt (phase 4's first row, laid out replicated) through the sharded
   generate against the plain ``generate`` on that row, run here too
   (tokens equal, launches counted, time); ``bench_allreduce`` over the
   mesh.
7. moe (on the same gang of one): MoE-Llama at full width and depth
   (``LlamaMoEConfig()``: 8 experts, top-2, head dim 64), fp32 master
   weights from the seed, bf16 compute, B=4, S=4096, through
   ``make_moe_train`` on a (dp=1, ep=1) mesh: step 1's loss against the
   plain ``loss_fn`` without a mesh, its kernel launches (the hd-64
   instantiations) and collectives (none), a lower loss at step 2, the
   median of 5 timed steps (tok/s, MFU, peak memory) and a trace.
8. sp (on the same gang): the flagship (phase 5's parameters and batch)
   through ``make_sp_train`` on the (dp=1, sp=1) mesh with Ulysses and
   with ring attention: step 1's loss against the plain full-logit
   loss, launch counts (Ulysses the three kernels, the ring none), no
   collective, 2 timed steps and peak memory.
9. pp (on the same gang): the flagship (phase 5's parameters and its
   B=4, S=4096 batch as M=4 microbatches of one row, bf16 Adam first
   moment) through ``make_pp_train`` on the (pp=1, dp=1) mesh: steps 1
   and 2's losses against ``train_step``'s (phase 5), the launches of one
   step (M times the plain step's) and its collectives (none), the median
   of 3 timed steps (tok/s, MFU, peak memory) and a trace by kind.
10. launcher (after the gang is left): ``train.verify --require-gang`` as
   a gang of one from a ComputeDomain env (its JSON line); then
   ``train.main --model flagship --batch-size 4 --seq-len 1024`` on a
   token file written from the seed: (a) 2 steps saving a checkpoint at
   step 2 and tracing, (b) 3 steps resumed from it, (c) 3 steps
   uninterrupted. (b)'s step-3 loss against (c)'s, the checkpoint's bytes
   and save and restore seconds, and a trace that names the flash
   kernels. The checkpoint and the trace are deleted after.
11. entry: ``entry.entry()``'s forward on the card (finite logits);
   ``entry.dryrun_multichip`` over every visible card, which starts its
   own NCCL ranks, and meanwhile over 4 gloo ranks on the host, where
   every family runs on this machine's torch (each family's seconds, or
   its skip), each serving the reference's prompt of a row a rank; and
   ``entry.dryrun_multichip_multiprocess`` as one node process from a
   bootstrap.json and members.json written here in the ComputeDomain
   daemon's format.
12. kubelet plugin: "a prepared claim runs the workload". The port's
   ``kubeletplugin.DeviceState`` over the real NVML, its state and CDI
   roots in a temporary directory, deleted after: the
   published devices against ``nvidia-smi`` (count and names) and each
   ``memory`` against NVML's total, the attributes left out as refused,
   the host ms of construction; a whole-GPU claim for ``gpu-0`` prepared
   (checkpoint PrepareCompleted, the spec's device node exists) and
   prepared again (the same CDI ids), host ms of each; a child
   ``python3`` with the spec's env applied (device edits, then common
   edits, then the claim's lines) that sees one device of the claim's
   product name and launches the flash forward kernel once at the
   serving shape on phase 3's inputs, against its plain version; then
   unprepare (spec and checkpoint record gone, a second unprepare a
   no-op), host ms.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it is the kernels' JSON record (with the hd-64 instantiations'
records after the others).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
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

# H100 SXM published dense peaks (NVIDIA data sheet) at the 700 W limit:
# bf16 and TF32 on the tensor cores, fp32 FMA outside them.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
PEAK_TF32_FLOPS = 495e12
# The fp32 kernels run each product as three TF32 products (3xTF32):
# their least time is three times the work at the TF32 rate (the route's
# bound); the same work at the FMA rate is logged beside.
TF32X3_PRODUCTS = 3
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
SAMPLED_NEW = 8  # new tokens of the sampled generate (phases 4 and 6)
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


def attention_bound_ms(B, S, H, K, hd, dtype, causal, with_lse=False,
                       tf32x3=False):
    """Least time for one call: QK^T and PV over the unmasked pairs at
    the dtype's peak (``tf32x3``: three TF32 products each at the TF32
    peak), against reading Q/K/V once and writing O (and lse) once at the
    memory rate. Returns (ms, "operations" | "bytes")."""
    pairs = S * (S + 1) // 2 if causal else S * S
    flops = 4 * B * H * hd * pairs
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * B * S * hd * (2 * H + 2 * K) + (4 * B * H * S
                                                    if with_lse else 0)
    t_ops = (TF32X3_PRODUCTS * flops / PEAK_TF32_FLOPS if tf32x3
             else flops / PEAK_FLOPS[dtype])
    t_bytes = nbytes / PEAK_BYTES_PER_S
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_bwd_bound_ms(B, S, H, K, hd, causal, kernel,
                           dtype=torch.bfloat16, tf32x3=False):
    """Least time for one backward kernel call: its products over the
    unmasked pairs at the dtype's peak (dQ: Q.K^T, dO.V^T, dS.K, 6*hd
    FLOP a pair; dK/dV: K.Q^T, V.dO^T, P^T.dO, dS^T.Q, 8*hd; ``tf32x3``:
    three TF32 products each at the TF32 peak), against reading q, k, v,
    dO, lse and D once and writing its outputs once. Returns (ms,
    "operations" | "bytes")."""
    pairs = S * (S + 1) // 2 if causal else S * S
    per_pair = {"dq": 6, "dkv": 8}[kernel] * hd
    flops = per_pair * B * H * pairs
    written = B * S * hd * (H if kernel == "dq" else 2 * K)
    elem = torch.tensor([], dtype=dtype).element_size()
    nbytes = elem * (B * S * hd * (2 * H + 2 * K) + written) + 8 * B * H * S
    t_ops = (TF32X3_PRODUCTS * flops / PEAK_TF32_FLOPS if tf32x3
             else flops / PEAK_FLOPS[dtype])
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


def log_kinds(kernels: list, label: str) -> None:
    """A trace's device time summed by ``kernel_kind``, with shares, and
    the two costliest kernels of each kind."""
    total = sum(e.self_device_time_total for e in kernels)
    if total <= 0:
        return
    shares, top = {}, {}
    for e in kernels:  # costliest first
        kind = kernel_kind(e.key)
        shares[kind] = shares.get(kind, 0) + e.self_device_time_total
        top.setdefault(kind, []).append(e)
    def names(kind):
        return " / ".join(f"{e.key[:110]} {e.self_device_time_total / 1e3:.1f}"
                          f" ms x{e.count}" for e in top[kind][:2])

    log(f"trace {label}: device time by kind " + ", ".join(
        f"{kind} {us / 1e3:.1f} ms ({us / total:.2f}; {names(kind)})"
        for kind, us in sorted(shares.items(), key=lambda kv: -kv[1])))


def reset_launches() -> None:
    from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd)

    flash_attention.launches = flash_attention.lse_launches = 0
    flash_attention_bwd.dq_launches = flash_attention_bwd.dkv_launches = 0


def read_launches() -> dict:
    from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd)

    return {"forward_lse": flash_attention.lse_launches,
            "forward_only": (flash_attention.launches
                             - flash_attention.lse_launches),
            "dq": flash_attention_bwd.dq_launches,
            "dkv": flash_attention_bwd.dkv_launches}


# The torch.distributed calls a port module can make.
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_to_all_single", "batch_isend_irecv", "broadcast",
               "reduce_scatter_tensor", "send", "recv", "isend", "irecv")


@contextlib.contextmanager
def counting_collectives():
    """Yields a list that gets the name of every ``torch.distributed``
    collective or point-to-point call made inside the block."""
    import torch.distributed as dist

    calls, saved = [], {name: getattr(dist, name) for name in COLLECTIVES}

    def counted(name, fn):
        def call(*args, **kwargs):
            calls.append(name)
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, counted(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


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


# nvidia-smi's view of each GPU, held field by field against NVML's.
SMI_FIELDS = "index,uuid,name,memory.total,power.limit,pci.bus_id"
# The loaded telemetry sample: ~2 s of bf16 products of this size, with
# this many bytes allocated beside them.
LOAD_SECONDS, LOAD_DIM, LOAD_BYTES = 2.0, 8192, 4 << 30
# A real NVML UUID; a sandbox may hand out a redacted one instead.
GPU_UUID = r"GPU-[0-9a-f]{8}(-[0-9a-f]{4}){3}-[0-9a-f]{12}"


def _smi_chips() -> list[dict]:
    from k8s_dra_driver_gpu_tpu_torch.tpulib.binding import normalize_bdf

    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={SMI_FIELDS}",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    rows = []
    for line in out.strip().splitlines():
        index, uuid, name, mem, power, bus = (f.strip()
                                              for f in line.split(","))
        # "[N/A]": nvidia-smi could not read it either.
        rows.append({"index": int(index), "uuid": uuid, "name": name,
                     "memory.total": int(mem), "power.limit": float(power),
                     "pci.bus_id": "" if "N/A" in bus
                     else normalize_bdf(bus)})
    return rows


def _layout_against_nvml_h() -> dict:
    """``struct_layout_probe`` built with the host C compiler against the
    toolkit's ``nvml.h``: the C layout of every struct the binding reads."""
    import os
    import tempfile

    from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as gpulib

    include = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "include")
    with tempfile.TemporaryDirectory() as tmp:
        src, exe = os.path.join(tmp, "probe.c"), os.path.join(tmp, "probe")
        with open(src, "w", encoding="utf-8") as f:
            f.write(gpulib.struct_layout_probe())
        subprocess.run(["cc", "-I", include, "-o", exe, src], check=True,
                       capture_output=True, text=True, timeout=120)
        out = subprocess.run([exe], check=True, capture_output=True,
                             text=True, timeout=60).stdout
    return gpulib.parse_struct_layout(out)


def _telemetry_under_load(lib, chip: int) -> tuple[list, int]:
    """NVML samples of ``chip`` every 0.1 s while ~LOAD_SECONDS of bf16
    products run with LOAD_BYTES allocated beside them; and the bytes the
    allocator took from the card for them."""
    import threading

    reserved = torch.cuda.memory_reserved()
    a = torch.randn(LOAD_DIM, LOAD_DIM, device="cuda", dtype=torch.bfloat16)
    b = torch.randn_like(a)
    ballast = torch.ones(LOAD_BYTES, device="cuda", dtype=torch.uint8)
    matmul_ms = time_ms(lambda: a @ b, iters=5)
    taken = torch.cuda.memory_reserved() - reserved
    samples, stop = [], threading.Event()

    def sample():
        while not stop.is_set():
            samples.append(lib.chip_telemetry()[chip])
            stop.wait(0.1)

    sampler = threading.Thread(target=sample)
    sampler.start()
    try:
        for _ in range(int(LOAD_SECONDS * 1e3 / matmul_ms)):
            a @ b
        torch.cuda.synchronize()
    finally:
        stop.set()
        sampler.join(timeout=30)
    del a, b, ballast
    torch.cuda.empty_cache()
    return samples, taken


# nvidia-smi's names of the NVLink error counters, by NVML field.
SMI_NVLINK_ERRORS = {"Replay": "NVML_FI_DEV_NVLINK_ERROR_DL_REPLAY",
                     "Recovery": "NVML_FI_DEV_NVLINK_ERROR_DL_RECOVERY",
                     "CRC": "NVML_FI_DEV_NVLINK_ERROR_DL_CRC"}


def _nvlink_errors(lib, chip: int) -> None:
    """The NVLink error fields of ``chip``, link by link: what NVML gave
    (field values, or the legacy counters in place of a refused field)
    and refused; ``ici_link_errors`` must be the sum of what it gave, and
    the field values must equal ``nvidia-smi nvlink -e``'s counters where
    it prints them. A container that refuses everything is logged."""
    import re

    readings = lib.nvlink_errors(chip)
    # Link by link, the links that read alike grouped.
    alike = collections.defaultdict(list)
    for r in readings:
        alike[(r.field.rsplit("_", 1)[-1], r.source or "refused", r.value,
               r.refused)].append(r.link)
    log(f"device layer: NVLink error fields of GPU {chip}: "
        f"{len(readings)} (link, field) readings: " + "; ".join(
            f"{field} on links {links}: {source} {value}"
            + (f" ({refused})" if refused else "")
            for (field, source, value, refused), links in alike.items()))
    given = sum(r.value for r in readings if r.source)
    total = lib.chip_telemetry()[chip].ici_link_errors
    sources = collections.Counter(r.source or "refused" for r in readings)
    log(f"device layer: ici_link_errors {total}, the sum of the accepted "
        f"values {given}; by source {dict(sources)}")
    if total != given:
        raise AssertionError("ici_link_errors is not the sum of the "
                             "accepted NVLink error values")
    smi = subprocess.run(["nvidia-smi", "nvlink", "-e", "-i", str(chip)],
                         capture_output=True, text=True, timeout=60,
                         check=False)
    printed = {(int(link), SMI_NVLINK_ERRORS[kind]): int(value)
               for link, kind, value in re.findall(
                   r"Link (\d+): (Replay|Recovery|CRC) Errors?: (\d+)",
                   smi.stdout)}
    fields = {(r.link, r.field): r.value for r in readings
              if r.source == "field"}
    both = sorted(printed.keys() & fields.keys())
    log(f"device layer: nvidia-smi nvlink -e exit {smi.returncode}, "
        f"{len(printed)} counters printed, {len(both)} held against the "
        f"field values" + ("" if printed else
                           f"; it printed {smi.stdout.strip()[:160]!r}"))
    bad = {key: (printed[key], fields[key]) for key in both
           if printed[key] != fields[key]}
    if bad:
        raise AssertionError(f"nvidia-smi's NVLink counters against NVML's "
                             f"fields: {bad}")


def phase_device_layer() -> None:
    """1b. The device layer (``tpulib``) on this host's NVML."""
    import os
    import re

    from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as gpulib

    lib = gpulib.load()
    if not isinstance(lib, gpulib.NvmlLib):
        raise AssertionError(f"load() gave {type(lib).__name__}, not NvmlLib")
    try:
        layout, want_layout = gpulib.struct_layout(), _layout_against_nvml_h()
        log(f"device layer: ctypes struct layouts and constants equal "
            f"nvml.h's {layout == want_layout} ({len(gpulib.NVML_STRUCTS)} "
            f"structs, {len(layout) - len(gpulib.NVML_STRUCTS)} constants: "
            + ", ".join(f"{name} {layout[name]}" for name in
                        ("nvmlFieldValue_t", *gpulib.NVML_FIELD_IDS)) + ")")
        if layout != want_layout:
            raise AssertionError(f"struct layouts: ctypes {layout}, "
                                 f"nvml.h {want_layout}")
        t0 = time.perf_counter()
        host = lib.enumerate()
        enumerate_ms = (time.perf_counter() - t0) * 1e3
        log(f"device layer: NVML {host.driver_version}, {host.product_name}, "
            f"{len(host.chips)} GPU(s), MIG {host.mig_mode}, power limit "
            f"{host.power_limit_watts} W: "
            + "; ".join(f"{c.index}: {c.uuid} minor {c.minor} bdf "
                        f"{c.pci_bdf or '-'} numa {c.numa_node} "
                        f"{c.memory_bytes} B" for c in host.chips))
        # Field by field against nvidia-smi (which reads the same NVML).
        smi = _smi_chips()
        if len(smi) != len(host.chips):
            raise AssertionError(f"nvidia-smi lists {len(smi)} GPUs, NVML "
                                 f"{len(host.chips)}")
        for row, chip in zip(smi, host.chips):
            got = {"index": chip.index, "uuid": chip.uuid, "name": chip.name,
                   "memory.total": chip.memory_bytes >> 20,
                   "power.limit": host.power_limit_watts,
                   "pci.bus_id": chip.pci_bdf}
            bad = {k: (got[k], row[k]) for k in row if got[k] != row[k]}
            if bad:
                raise AssertionError(f"NVML against nvidia-smi: {bad}")
        if any(not row["pci.bus_id"] for row in smi) and \
                "nvmlDeviceGetPciInfo_v3" not in lib.refusals:
            raise AssertionError("nvidia-smi has no bus id, NVML gave one")
        log(f"device layer: nvidia-smi's {SMI_FIELDS} equal NVML's for "
            f"{len(smi)} GPU(s)")

        # devfs on the same host: the node of each NVML minor, with NVML's
        # address and NUMA node.
        devfs = gpulib.PyGpuLib().enumerate(gpulib.EnumerateOptions())
        by_minor = {c.minor: c for c in devfs.chips}
        for chip in host.chips:
            node = by_minor.get(chip.minor)
            if node is None or (node.pci_bdf, node.numa_node) != (
                    chip.pci_bdf, chip.numa_node):
                raise AssertionError(f"devfs {node} against NVML {chip}")
        extra = sorted(set(by_minor) - {c.minor for c in host.chips})
        proc = os.path.isdir("/proc/driver/nvidia/gpus")
        log(f"device layer: devfs ({devfs.source}) has NVML's minors "
            f"{[c.minor for c in host.chips]} with the same bdf and numa; "
            f"nodes NVML does not list: {extra}; /proc/driver/nvidia/gpus "
            f"{'present' if proc else 'absent'}")

        # cuda:0 by UUID (torch prints it without "GPU-"); memory as an
        # inequality: torch's total leaves out what the driver reserves.
        props = torch.cuda.get_device_properties(0)
        want_uuid = f"GPU-{props.uuid}"
        match = [c for c in host.chips if c.uuid == want_uuid]
        if not match:
            if len(host.chips) == 1 and not re.fullmatch(
                    GPU_UUID, host.chips[0].uuid):
                log(f"device layer: NVML's UUID is {host.chips[0].uuid!r} "
                    f"(redacted on this host), torch's {want_uuid}: cuda:0 is "
                    "NVML's only GPU")
                match = host.chips
            else:
                raise AssertionError(f"no NVML GPU has cuda:0's {want_uuid}")
        (chip,) = match
        if props.total_memory > chip.memory_bytes:
            raise AssertionError("torch's memory above NVML's")
        log(f"device layer: cuda:0 is NVML GPU {chip.index}; memory NVML "
            f"{chip.memory_bytes} B >= torch {props.total_memory} B (gap "
            f"{(chip.memory_bytes - props.total_memory) / 2**20:.0f} MiB)")

        t0 = time.perf_counter()
        events = lib.health()
        health_ms = (time.perf_counter() - t0) * 1e3
        log(f"device layer: idle health poll {list(events)}; events "
            f"supported {lib.health_events_supported}, refused "
            f"{lib.events_refused}")

        idle = lib.chip_telemetry()[chip.index]
        samples, taken = _telemetry_under_load(lib, chip.index)
        busiest = max(samples, key=lambda s: (s.duty_cycle, s.power_watts))
        rise = max(s.hbm_used_bytes for s in samples) - idle.hbm_used_bytes
        # The card holds its power to the limit over time, not in every
        # reading: a 1 s reading may pass it while the controller reacts,
        # so the window's mean is held to the limit and its peak logged.
        watts = [s.power_watts for s in samples]
        mean_w = statistics.fmean(watts)
        log(f"device layer: telemetry idle {idle.to_dict()}; under load "
            f"({len(samples)} samples) busiest {busiest.to_dict()}, power "
            f"mean {mean_w:.1f} W, peak {max(watts)} W of "
            f"{host.power_limit_watts} W, memory used +{rise} B for {taken} B "
            f"allocated")
        if not (mean_w <= host.power_limit_watts and rise >= taken
                and busiest.duty_cycle > 0):
            raise AssertionError("telemetry under load")

        _nvlink_errors(lib, chip.index)
        profiles = lib.subslice_profiles()
        cli = subprocess.run(
            [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.tpulib"],
            capture_output=True, text=True, timeout=120, check=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        doc = json.loads(cli.stdout)
        log(f"device layer: MIG {host.mig_mode}, {len(profiles)} profile(s); "
            f"CLI {json.dumps(doc, separators=(',', ':'))}")
        if doc["backend"] != "nvml" or len(doc["chips"]) != len(host.chips):
            raise AssertionError("the CLI's enumeration")
        log(f"device layer: NVML refused {lib.refusals}; host ms: "
            f"enumerate {enumerate_ms:.2f}, health poll {health_ms:.2f}")
    finally:
        lib.close()


KERNEL_SOURCES = ("flash_fwd", "flash_bwd")
# The Hopper kernels whose ptxas report must show no spill and no
# performance warning: the bf16 ones (TMA, wgmma, setmaxnreg) and the
# fp32 ones (3xTF32 mma.sync, cp.async).
HOPPER_KERNELS = ("flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16",
                  "flash_fwd_f32", "flash_bwd_dq_f32", "flash_bwd_dkv_f32")


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


def phase_training_kernels(gen: torch.Generator) -> tuple[dict, dict, dict,
                                                         list]:
    """The kernels of the training paths: the with-lse forward and the dQ
    and dK/dV backward kernels, held against their plain versions at the
    flagship's training shape (hd 128) and the MoE-Llama's (hd 64), B=1
    on the plain side, and at edge shapes, then timed at B=4 at both.
    Returns (with-lse forward numbers, dQ record, dK/dV record) at hd 128
    and the three kernel records at hd 64."""
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

    # (label, B, S, H, K, hd, causal); the first two are the flagship's
    # and the MoE-Llama's training shapes.
    cases = [
        ("training", 1, TRAIN_SEQ, 16, 8, 128, True),
        ("moe training", 1, TRAIN_SEQ, 16, 8, 64, True),
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
    # Max abs error of each kernel at the two training shapes, by hd.
    max_err = {hd: {"dq": 0.0, "dkv": 0.0, "forward": 0.0}
               for hd in (128, 64)}
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
        training = label in ("training", "moe training")
        if training:
            max_err[hd]["forward"] = out_err
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
            if training:
                max_err[hd][kernel] = max(max_err[hd][kernel], err)
        log(f"kernel backward {label}: B={B} S={S} H={H} K={K} hd={hd} bf16 "
            f"causal={causal}: {'; '.join(errs)} (tol rel L2 {BWD_REL_TOL})")
        del q, k, v, do, out, lse, got, want

    def timed(hd: int, suffix: str) -> tuple[dict, dict, dict]:
        """The three kernels timed at the training shape of head dim
        ``hd``: with-lse forward numbers, dQ and dK/dV records."""
        B, S, H, K = TRAIN_BATCH, TRAIN_SEQ, 16, 8
        q, k, v, do = inputs(B, S, H, K, hd)
        fwd = {"max_abs_err": max_err[hd]["forward"],
               "ms": time_ms(lambda: flash_attention(q, k, v, with_lse=True),
                             20),
               "plain_ms": time_ms(lambda: flash_attention_reference(
                   q, k, v, True, True), 3, warmup=1)}
        fwd["bound_ms"], fwd["bound_by"] = attention_bound_ms(
            B, S, H, K, hd, torch.bfloat16, True, with_lse=True)
        qt, kx, vx = (t.transpose(1, 2) for t in (
            q, k.repeat_interleave(H // K, 2),
            v.repeat_interleave(H // K, 2)))
        fwd["library_ms"] = time_ms(
            lambda: torch.ops.aten._scaled_dot_product_flash_attention(
                qt, kx, vx, 0.0, True), 20)
        del qt, kx, vx
        log(f"kernel with-lse forward at training shape B={B} S={S} H={H} "
            f"K={K} hd={hd}: ms={fwd['ms']:.4f} "
            f"plain_ms={fwd['plain_ms']:.4f} "
            f"library_ms={fwd['library_ms']:.4f} (aten flash, K/V expanded, "
            f"returns lse) bound_ms={fwd['bound_ms']:.4f} ({fwd['bound_by']})"
            f" roofline_share={fwd['bound_ms'] / fwd['ms']:.3f} "
            f"factor_over_library={fwd['ms'] / fwd['library_ms']:.2f}")

        out, lse = flash_attention(q, k, v, with_lse=True)
        launch_dq, launch_dkv, _ = _bwd_launchers(q, k, v, out, lse, do,
                                                  True)
        dq_ms = time_ms(launch_dq, 20)
        dkv_ms = time_ms(launch_dkv, 20)
        bwd_ms = time_ms(
            lambda: flash_attention_bwd(q, k, v, out, lse, do, True), 10)
        plain_ms = time_ms(lambda: flash_attention_bwd_reference(
            q, k, v, out, lse, do, True), 2, warmup=1)
        library_ms, library_how = sdpa_backward_ms(q, k, v, do)
        log(f"kernel backward at training shape B={B} S={S} H={H} K={K} "
            f"hd={hd}: dq_ms={dq_ms:.4f} dkv_ms={dkv_ms:.4f} whole backward "
            f"(D, dQ, dK/dV) ms={bwd_ms:.4f}; plain backward "
            f"ms={plain_ms:.4f}; SDPA backward ms={library_ms:.4f} "
            f"({library_how})")
        records = []
        for kernel, ms, line in (("dq", dq_ms, 104), ("dkv", dkv_ms, 157)):
            bound, bound_by = attention_bwd_bound_ms(B, S, H, K, hd, True,
                                                     kernel)
            log(f"kernel {kernel} hd={hd}: ms={ms:.4f} bound_ms={bound:.4f} "
                f"({bound_by}) roofline_share={bound / ms:.3f} "
                f"factor_over_library={ms / library_ms:.3f}")
            records.append({
                "name": f"flash_attention_bwd_{kernel}{suffix}",
                "route": "cuda",
                "source": "k8s_dra_driver_gpu_tpu_torch/csrc/flash_bwd.cu",
                "replaces": ("k8s_dra_driver_gpu_tpu/ops/flash_attention.py:"
                             f"{line}"),
                "launches": None, "max_abs_err": max_err[hd][kernel],
                "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
                "bound_by": bound_by, "library_ms": library_ms,
            })
        del q, k, v, do, out, lse
        torch.cuda.empty_cache()
        return fwd, records[0], records[1]

    fwd, dq, dkv = timed(128, "")
    fwd64, dq64, dkv64 = timed(64, "_hd64")
    fwd64.update({
        "name": "flash_attention_lse_hd64", "route": "cuda",
        "source": "k8s_dra_driver_gpu_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "k8s_dra_driver_gpu_tpu/ops/flash_attention.py:40",
        "launches": None})
    shape = f"B={TRAIN_BATCH} S={TRAIN_SEQ} H=16 K=8 hd=64"
    for record in (fwd64, dq64, dkv64):
        record["shape"] = shape
    return fwd, dq, dkv, [fwd64, dq64, dkv64]


FP32_GRAD_REL_TOL = 1e-3
# The fp32 kernels that run their products in 3xTF32 on the tensor cores:
# all three.
TF32X3_KERNELS = ("forward", "dq", "dkv")
FP32_CHECK_LAYERS, FP32_CHECK_SEQ = 2, 1024


def within(got: torch.Tensor, want: torch.Tensor, dtype) -> tuple[bool, float]:
    """Elementwise ``|got - want| <= atol + rtol * |want|`` at the
    dtype's ``TOLERANCES``, all finite; and the max abs error."""
    atol, rtol = TOLERANCES[dtype]
    diff = (got.float() - want.float()).abs()
    ok = bool(torch.isfinite(got).all()) and (
        diff - atol - rtol * want.float().abs()).max().item() <= 0
    return ok, diff.max().item()


def sdpa_efficient_ms(q, k, v, do) -> tuple[float, float]:
    """Device ms of SDPA's forward with lse and of its backward on the
    memory-efficient backend (which takes fp32), causal, K/V expanded to
    every q-head outside the timer."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    group = q.shape[2] // k.shape[2]
    leaves = [t.detach().transpose(1, 2).requires_grad_() for t in (
        q, k.repeat_interleave(group, 2), v.repeat_interleave(group, 2))]
    with sdpa_kernel(SDPBackend.EFFICIENT_ATTENTION):
        fwd_ms = time_ms(
            lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
                *(t.detach() for t in leaves), None, True, is_causal=True),
            10)
        out = F.scaled_dot_product_attention(*leaves, is_causal=True)
    grad_out = do.transpose(1, 2)
    bwd_ms = time_ms(lambda: torch.autograd.grad(
        out, leaves, grad_out, retain_graph=True), 5)
    return fwd_ms, bwd_ms


def phase_fp32_kernels(gen: torch.Generator) -> list:
    """The fp32 entries of the three kernels: the with-lse forward and the
    dQ and dK/dV kernels held against their plain versions elementwise at
    ``TOLERANCES[torch.float32]`` at the backward's edge shapes, timed at
    the training shape, then one gradient of a 2-layer flagship-width fp32
    model through ``attention(impl="auto")`` held against the einsum path.
    Returns the three fp32 kernel records."""
    from k8s_dra_driver_gpu_tpu_torch.models import llama
    from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
        _bwd_launchers, flash_attention, flash_attention_bwd,
        flash_attention_bwd_reference, flash_attention_reference)
    from k8s_dra_driver_gpu_tpu_torch.train.train import loss_fn, tree_leaves

    f32 = torch.float32

    def inputs(B, S, H, K, hd, label=""):
        q, k, v = attention_inputs(gen, label, B, S, H, K, hd, f32)
        do = torch.randn((B, S, H, hd), generator=gen, device="cuda")
        return q, k, v, do

    # (label, B, S, H, K, hd, causal): the bf16 backward's edge cases.
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
    max_err = {"forward": 0.0, "dq": 0.0, "dkv": 0.0}
    for label, B, S, H, K, hd, causal in cases:
        q, k, v, do = inputs(B, S, H, K, hd, label)
        out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
        want_out, want_lse = flash_attention_reference(q, k, v, causal, True)
        ok, out_err = within(out, want_out, f32)
        lse_err = (lse - want_lse).abs().max().item()
        got = flash_attention_bwd(q, k, v, out, lse, do, causal)
        want = flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
        torch.cuda.synchronize()
        errs = [f"out max_abs_err={out_err:.3g}", f"lse {lse_err:.3g}"]
        ok = ok and lse_err <= LSE_TOLERANCE
        max_err["forward"] = max(max_err["forward"], out_err)
        for name, a, b in zip(("dq", "dk", "dv"), got, want):
            good, err = within(a, b, f32)
            ok = ok and good
            kernel = "dq" if name == "dq" else "dkv"
            max_err[kernel] = max(max_err[kernel], err)
            errs.append(f"{name} max_abs_err={err:.3g}")
        log(f"kernel fp32 {label}: B={B} S={S} H={H} K={K} hd={hd} "
            f"causal={causal}: {', '.join(errs)} (atol, rtol "
            f"{TOLERANCES[f32]})")
        if not ok:
            raise AssertionError(f"fp32 kernels {label} disagree with their "
                                 "plain versions")
        del q, k, v, do, out, lse, got, want, want_out, want_lse
    torch.cuda.empty_cache()

    # Timing at the training shape.
    B, S, H, K, hd = TRAIN_BATCH, TRAIN_SEQ, 16, 8, 128
    q, k, v, do = inputs(B, S, H, K, hd)
    fwd_ms = time_ms(lambda: flash_attention(q, k, v, with_lse=True), 5)
    fwd_plain_ms = time_ms(lambda: flash_attention_reference(
        q, k, v, True, True), 2, warmup=1)
    out, lse = flash_attention(q, k, v, with_lse=True)
    launch_dq, launch_dkv, _ = _bwd_launchers(q, k, v, out, lse, do, True)
    dq_ms = time_ms(launch_dq, 5)
    dkv_ms = time_ms(launch_dkv, 5)
    bwd_plain_ms = time_ms(lambda: flash_attention_bwd_reference(
        q, k, v, out, lse, do, True), 2, warmup=1)
    lib_fwd_ms, lib_bwd_ms = sdpa_efficient_ms(q, k, v, do)
    log(f"kernel fp32 at training shape B={B} S={S} H={H} K={K} hd={hd}: "
        f"forward with lse ms={fwd_ms:.4f} (plain {fwd_plain_ms:.4f}, SDPA "
        f"efficient forward with lse {lib_fwd_ms:.4f}); dq_ms={dq_ms:.4f} "
        f"dkv_ms={dkv_ms:.4f} (plain backward {bwd_plain_ms:.4f}, SDPA "
        f"efficient backward {lib_bwd_ms:.4f}, K/V expanded)")
    records = []
    for name, kernel, ms, plain_ms, library_ms, line, source in (
            ("flash_attention_fp32", "forward", fwd_ms, fwd_plain_ms,
             lib_fwd_ms, 40, "flash_fwd"),
            ("flash_attention_bwd_dq_fp32", "dq", dq_ms, bwd_plain_ms,
             lib_bwd_ms, 104, "flash_bwd"),
            ("flash_attention_bwd_dkv_fp32", "dkv", dkv_ms, bwd_plain_ms,
             lib_bwd_ms, 157, "flash_bwd")):
        # The route's bound, 3xTF32; the FMA bound of the same work beside.
        tf32x3 = kernel in TF32X3_KERNELS
        if kernel == "forward":
            bound, bound_by = attention_bound_ms(B, S, H, K, hd, f32, True,
                                                 True, tf32x3)
            fma_bound, _ = attention_bound_ms(B, S, H, K, hd, f32, True, True)
        else:
            bound, bound_by = attention_bwd_bound_ms(B, S, H, K, hd, True,
                                                     kernel, f32, tf32x3)
            fma_bound, _ = attention_bwd_bound_ms(B, S, H, K, hd, True,
                                                  kernel, f32)
        log(f"kernel {name}: ms={ms:.4f} bound_ms={bound:.4f} ({bound_by}, "
            f"{'3xTF32 at 495' if tf32x3 else 'FMA at 67'} TFLOP/s) "
            f"roofline_share={bound / ms:.3f} fma_bound_ms={fma_bound:.4f} "
            f"factor_over_library={ms / library_ms:.2f}")
        records.append({
            "name": name, "route": "cuda",
            "source": f"k8s_dra_driver_gpu_tpu_torch/csrc/{source}.cu",
            "replaces": f"k8s_dra_driver_gpu_tpu/ops/flash_attention.py:{line}",
            "launches": None, "max_abs_err": max_err[kernel], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound, "bound_by": bound_by,
            "library_ms": library_ms,
        })
    del q, k, v, do, out, lse
    torch.cuda.empty_cache()

    # A 2-layer fp32 model at flagship width: its gradient through
    # attention(impl="auto"), which must take the fp32 kernels, against
    # the einsum path.
    cfg = dataclasses.replace(llama.LlamaConfig.flagship(),
                              n_layers=FP32_CHECK_LAYERS, dtype=f32)
    params = llama.init(cfg, gen, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (1, FP32_CHECK_SEQ + 1),
                           generator=gen, device="cuda")

    def grads(attn_impl):
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = loss_fn(params, tokens,
                       dataclasses.replace(cfg, attn_impl=attn_impl))
        return loss.detach(), torch.autograd.grad(loss, leaves)

    flash_attention.launches = flash_attention.lse_launches = 0
    flash_attention_bwd.dq_launches = flash_attention_bwd.dkv_launches = 0
    loss_auto, g_auto = grads("auto")
    counts = {"forward_lse": flash_attention.lse_launches,
              "forward_only": (flash_attention.launches
                               - flash_attention.lse_launches),
              "dq": flash_attention_bwd.dq_launches,
              "dkv": flash_attention_bwd.dkv_launches}
    loss_einsum, g_einsum = grads("einsum")
    errs = [rel_l2(a, b) for a, b in zip(g_auto, g_einsum)]
    want_counts = {"forward_lse": 2 * cfg.n_layers, "forward_only": 0,
                   "dq": cfg.n_layers, "dkv": cfg.n_layers}
    loss_rel = abs((loss_auto - loss_einsum) / loss_einsum).item()
    log(f"fp32 gradient check ({cfg.n_layers} layers at flagship width, "
        f"B=1 S={FP32_CHECK_SEQ}): attention auto launched {counts} (want "
        f"{want_counts}); loss auto {loss_auto.item():.6f} einsum "
        f"{loss_einsum.item():.6f}; grads max rel L2 over leaves "
        f"{max(errs):.3g} (tol {FP32_GRAD_REL_TOL})")
    if counts != want_counts:
        raise AssertionError(f"fp32 auto attention launched {counts}")
    if not (all(torch.isfinite(g).all() for g in g_auto)
            and max(errs) <= FP32_GRAD_REL_TOL
            and loss_rel <= FP32_GRAD_REL_TOL):
        raise AssertionError("fp32 gradients through the kernels disagree "
                             "with the einsum path")
    for record, key in zip(records, ("forward_lse", "dq", "dkv")):
        record["launches"] = counts[key]
    del params, g_auto, g_einsum
    torch.cuda.empty_cache()
    return records


def phase_serving(seed: int) -> dict:
    """Llama-3-8B serving; returns the launch count of one ``generate``
    and what the gang phase compares with: the prompt, ``generate``'s
    tokens, the timed prefill's logits, prefill ms and decode ms a
    step."""
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
    decode_ms = step_s[n_steps // 2] * 1e3
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

    # Sampled at temperature 1.0 from a generator seeded with the seed:
    # phase 6 draws the same tokens through the sharded path.
    sampled = decode.generate(
        params, prompt, cfg, SAMPLED_NEW, SERVE_MAX_LEN, temperature=1.0,
        generator=torch.Generator(device=device).manual_seed(seed))
    torch.cuda.synchronize()
    if sampled.shape != (SERVE_BATCH, SAMPLED_NEW) or \
            not ((sampled >= 0) & (sampled < cfg.vocab_size)).all():
        raise AssertionError(f"bad sampled tokens {sampled.shape}")
    log(f"serving: sampled generate (temperature 1.0, seed {seed}) "
        f"{SAMPLED_NEW} tokens, agreement with greedy "
        f"{(sampled == tokens[:, :SAMPLED_NEW]).float().mean().item():.2f}, "
        f"first row {sampled[0].tolist()}")
    return {"launches": launches, "prompt": prompt, "tokens": tokens,
            "logits": logits, "prefill_ms": pre_s * 1e3,
            "decode_ms": decode_ms, "sampled": sampled}


def phase_training(seed: int) -> tuple[dict, dict]:
    """Flagship training at full width and depth; returns the kernel
    launch counts of one ``train_step`` and its step median ms, MFU, peak
    GiB and the losses of its steps on one batch."""
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

    log_kinds(profile(traced_step, "train step", top=12), "train step")
    del state
    torch.cuda.empty_cache()
    return counts, {"step_ms": step * 1e3, "mfu": mfu, "peak_gib": peak_gib,
                    "losses": losses}


GANG_STEPS = 3          # sharded steps held against train_step
GANG_TIMED_STEPS = 4    # further sharded steps timed
# Step 1 of the sharded step against train_step on the same parameters
# and batch: the same kernels on the same local tensors, so only
# DTensor's own reductions may differ (loss, relative).
GANG_STEP1_REL_TOL = 1e-5
SHARDED_LOGITS_REL_TOL = 1e-3


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@contextlib.contextmanager
def gang_of_one():
    """A gang of one over NCCL, joined by the launcher's
    ``initialize_distributed`` from the ComputeDomain env; yields a mesh
    over the one rank and leaves the gang on exit."""
    import torch.distributed as dist

    from k8s_dra_driver_gpu_tpu_torch.parallel.mesh import build_mesh
    from k8s_dra_driver_gpu_tpu_torch.train.main import initialize_distributed

    env = {"TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
           "TPU_PROCESS_ID": "0", "TPU_NUM_PROCESSES": "1"}
    if not initialize_distributed(env, device="cuda"):
        raise AssertionError("initialize_distributed joined no gang")
    try:
        mesh = build_mesh()
        log(f"gang: {dist.get_backend()} world {dist.get_world_size()} via "
            f"{env['TPU_COORDINATOR_ADDRESS']}, mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        yield mesh
    finally:
        dist.destroy_process_group()


def phase_gang(seed: int, mesh, serving: dict, training: dict) -> dict:
    """The sharded paths on the gang of one: (i) ``make_sharded_train`` on
    the flagship at full width and depth against ``train_step``, (ii) the
    scanned step against single steps, (iii) ``make_sharded_generate`` on
    Llama-3-8B against ``generate`` (phase 4's seed, prompt, tokens,
    logits, sampled tokens), (iv) ``bench_allreduce`` over the mesh.
    Returns the kernel launches of one sharded step and of one sharded
    generate, greedy and sampled."""
    from k8s_dra_driver_gpu_tpu_torch.ops.collectives import bench_allreduce

    counts = {"train": _gang_train(seed, mesh, training),
              **_gang_generate(seed, mesh, serving)}
    stats = bench_allreduce(mesh, "dp")
    log(f"gang: bench_allreduce over dp: participants "
        f"{stats['participants']}, {stats['bytes']} bytes x "
        f"{stats['iters']} in {stats['seconds'] * 1e3:.2f} ms, "
        f"{stats['gbps']} GB/s (2*S*(n-1)/n algorithm bytes: 0 at n=1)")
    if stats["participants"] != 1 or stats["gbps"] != 0.0:
        raise AssertionError(f"bench_allreduce at world 1: {stats}")
    return counts


def _gang_train(seed: int, mesh, training: dict) -> dict:
    """(i) and (ii) of ``phase_gang``; returns the launch counts of one
    sharded step."""
    from k8s_dra_driver_gpu_tpu_torch.models import llama
    from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd)
    from k8s_dra_driver_gpu_tpu_torch.train.train import (
        TrainState, make_optimizer, make_scanned_sharded_train,
        make_sharded_train, train_step, tree_leaves)

    cfg = llama.LlamaConfig.flagship()
    optimizer = make_optimizer(mu_dtype=torch.bfloat16)
    # Phase 5's parameters and batch: the same seed and draws.
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init(cfg, gen, "cuda", dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda", dtype=torch.int32)
    n_params = sum(t.numel() for t in tree_leaves(params))
    init_fn, step_fn, layout, _ = make_sharded_train(mesh, cfg, optimizer)
    sharded = init_fn(params)  # placed copies
    plain = TrainState(params, optimizer.init(params), 0)
    want = []
    for _ in range(GANG_STEPS):
        plain, loss = train_step(plain, tokens, cfg=cfg, optimizer=optimizer)
        want.append(loss.item())
    del plain, params
    torch.cuda.empty_cache()

    # The main path, counted: one sharded step.
    batch = layout(tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = flash_attention.lse_launches = 0
    flash_attention_bwd.dq_launches = flash_attention_bwd.dkv_launches = 0
    t0 = time.perf_counter()
    sharded, loss = step_fn(sharded, batch)
    got = [loss.item()]
    first_s = time.perf_counter() - t0
    counts = {"forward_lse": flash_attention.lse_launches,
              "forward_only": (flash_attention.launches
                               - flash_attention.lse_launches),
              "dq": flash_attention_bwd.dq_launches,
              "dkv": flash_attention_bwd.dkv_launches}
    wanted = {"forward_lse": 2 * cfg.n_layers, "forward_only": 0,
              "dq": cfg.n_layers, "dkv": cfg.n_layers}
    log(f"gang: one sharded step launched {counts} (want {wanted}; "
        f"{first_s * 1e3:.1f} ms, first call); placements of wq "
        f"{sharded.params['layers']['wq'].placements}")
    if counts != wanted:
        raise AssertionError(f"sharded step kernel launches {counts}")
    step_s = []
    for i in range(GANG_STEPS - 1 + GANG_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded, loss = step_fn(sharded, batch)
        value = loss.item()
        step_s.append(time.perf_counter() - t0)
        if i < GANG_STEPS - 1:
            got.append(value)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    rel = [abs(a - b) / abs(b) for a, b in zip(got, want)]
    log(f"gang: sharded losses {' '.join(f'{x:.6f}' for x in got)} against "
        f"train_step's {' '.join(f'{x:.6f}' for x in want)}: rel "
        f"{' '.join(f'{x:.3g}' for x in rel)} (tol step 1 "
        f"{GANG_STEP1_REL_TOL}, steps 2-{GANG_STEPS} {LOSS_REL_TOL})")
    if not (rel[0] <= GANG_STEP1_REL_TOL and max(rel) <= LOSS_REL_TOL):
        raise AssertionError("sharded step disagrees with train_step")
    step = statistics.median(step_s)
    mfu = 6 * n_params * TRAIN_BATCH * TRAIN_SEQ / step / PEAK_FLOPS[
        torch.bfloat16]
    log(f"gang: sharded step median {step * 1e3:.1f} ms over {len(step_s)} "
        f"(min {min(step_s) * 1e3:.1f}, max {max(step_s) * 1e3:.1f}), MFU "
        f"{mfu:.3f}, peak {peak_gib:.1f} GiB; plain train_step (phase 5) "
        f"{training['step_ms']:.1f} ms, MFU {training['mfu']:.3f}, peak "
        f"{training['peak_gib']:.1f} GiB; DTensor host overhead "
        f"{step * 1e3 - training['step_ms']:.1f} ms a step")

    def traced_step():
        nonlocal sharded
        sharded, loss = step_fn(sharded, batch)
        loss.item()

    profile(traced_step, "sharded train step", top=6)
    del sharded, batch
    torch.cuda.empty_cache()

    # K = 3 steps in one call against the single sharded steps above.
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init(cfg, gen, "cuda", dtype=torch.float32)
    _, scan_fn, scan_layout, _ = make_scanned_sharded_train(mesh, cfg,
                                                            optimizer)
    state = init_fn(params)
    del params
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state, losses = scan_fn(state, scan_layout(
        tokens[None].expand(GANG_STEPS, -1, -1)))
    scanned = losses.tolist()
    scan_s = time.perf_counter() - t0
    rel = [abs(a - b) / abs(b) for a, b in zip(scanned, got)]
    log(f"gang: scanned K={GANG_STEPS} losses "
        f"{' '.join(f'{x:.6f}' for x in scanned)} in {scan_s * 1e3:.1f} ms "
        f"(first call); rel to single sharded steps "
        f"{' '.join(f'{x:.3g}' for x in rel)} (tol {LOSS_REL_TOL})")
    if state.step != GANG_STEPS or max(rel) > LOSS_REL_TOL:
        raise AssertionError("scanned steps disagree with single steps")
    del state
    torch.cuda.empty_cache()
    return counts


def _gang_generate(seed: int, mesh, serving: dict) -> dict:
    """(iii) of ``phase_gang``; returns the flash launches of one sharded
    generate, greedy and sampled."""
    from torch.distributed.tensor.experimental import implicit_replication

    from k8s_dra_driver_gpu_tpu_torch.models import decode, llama
    from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
        flash_attention)

    cfg = llama.LlamaConfig.llama3_8b()
    generate_fn, prompt_layout, place = decode.make_sharded_generate(
        mesh, cfg, SERVE_NEW, SERVE_MAX_LEN)
    # Phase 4's weights: the same seed and draws.
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = place(llama.init(cfg, gen, "cuda", dtype=cfg.dtype))
    torch.cuda.empty_cache()
    prompt = prompt_layout(serving["prompt"])

    # The main path, counted: one sharded generate.
    torch.cuda.synchronize()
    flash_attention.launches = flash_attention.lse_launches = 0
    t0 = time.perf_counter()
    tokens = generate_fn(params, prompt)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t0
    launches = flash_attention.launches
    same = torch.equal(tokens.full_tensor(), serving["tokens"])
    log(f"gang: sharded generate B={SERVE_BATCH} S={SERVE_PROMPT} "
        f"new={SERVE_NEW} in {gen_s:.3f} s (first call), flash launches "
        f"{launches} ({flash_attention.lse_launches} with lse), tokens "
        f"placed {tokens.placements}, all equal to generate's: {same}")
    if launches != cfg.n_layers or flash_attention.lse_launches or not same:
        raise AssertionError("sharded generate disagrees with generate")

    def timed(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    with implicit_replication():
        (logits, cache), pre_s = timed(
            lambda: decode.prefill(params, prompt, cfg, SERVE_MAX_LEN))
        rel = rel_l2(logits.full_tensor(), serving["logits"])
        token = tokens[:, 0]
        step_s = []
        for _ in range(16):
            (_, cache), s = timed(
                lambda: decode.decode_step(params, cache, token, cfg))
            step_s.append(s)
        step_s.sort()
        decode_ms = step_s[len(step_s) // 2] * 1e3
        profile(lambda: [decode.decode_step(params, cache, token, cfg)
                         for _ in range(4)], "4 sharded decode steps")
    log(f"gang: sharded prefill logits rel L2 to generate's {rel:.3g} (tol "
        f"{SHARDED_LOGITS_REL_TOL}); prefill {pre_s * 1e3:.1f} ms (plain "
        f"{serving['prefill_ms']:.1f}); decode median {decode_ms:.2f} ms/step "
        f"(plain {serving['decode_ms']:.2f}), DTensor host overhead "
        f"{decode_ms - serving['decode_ms']:.2f} ms a decode step")
    if not rel <= SHARDED_LOGITS_REL_TOL:
        raise AssertionError(f"sharded prefill logits rel err {rel}")
    del cache, logits

    # Sampled, counted: phase 4's draw (temperature 1.0, the seed), made
    # from the global batch on the sharded path.
    sample_fn, _, _ = decode.make_sharded_generate(
        mesh, cfg, SAMPLED_NEW, SERVE_MAX_LEN, temperature=1.0)
    torch.cuda.synchronize()
    flash_attention.launches = flash_attention.lse_launches = 0
    t0 = time.perf_counter()
    sampled = sample_fn(params, prompt,
                        torch.Generator(device="cuda").manual_seed(seed))
    torch.cuda.synchronize()
    sample_s = time.perf_counter() - t0
    sampled_launches = flash_attention.launches
    same = torch.equal(sampled.full_tensor(), serving["sampled"])
    log(f"gang: sampled sharded generate new={SAMPLED_NEW} in "
        f"{sample_s:.3f} s, flash launches {sampled_launches} "
        f"({flash_attention.lse_launches} with lse), tokens placed "
        f"{sampled.placements}, all equal to phase 4's sampled tokens: "
        f"{same}")
    if sampled_launches != cfg.n_layers or flash_attention.lse_launches \
            or not same:
        raise AssertionError("sampled sharded generate disagrees with "
                             "generate")
    one_row_launches = _gang_generate_one_row(cfg, generate_fn, prompt_layout,
                                              params, serving["prompt"][:1])
    del params
    torch.cuda.empty_cache()
    return {"generate": launches, "sampled_generate": sampled_launches,
            "one_row_generate": one_row_launches}


def _local_tree(tree: dict) -> dict:
    """Each DTensor leaf's local tensor: at world 1 the whole tensor."""
    return {name: (_local_tree(leaf) if isinstance(leaf, dict)
                   else leaf.to_local()) for name, leaf in tree.items()}


def _gang_generate_one_row(cfg, generate_fn, prompt_layout, params,
                           one_row) -> int:
    """A one-row prompt (the reference's dry run serves a row a device)
    through the sharded generate, laid out replicated, against the plain
    ``generate`` on the same row and weights, run here: a batch of 4 may
    round its bf16 products differently. Returns the flash launches of the
    sharded run."""
    from k8s_dra_driver_gpu_tpu_torch.models import decode
    from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
        flash_attention)

    plain = decode.generate(_local_tree(params), one_row, cfg, SERVE_NEW,
                            SERVE_MAX_LEN)
    sharded_prompt = prompt_layout(one_row)
    torch.cuda.synchronize()
    flash_attention.launches = flash_attention.lse_launches = 0
    t0 = time.perf_counter()
    tokens = generate_fn(params, sharded_prompt)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = flash_attention.launches
    same = torch.equal(tokens.full_tensor(), plain)
    log(f"gang: one-row sharded generate S={SERVE_PROMPT} new={SERVE_NEW} "
        f"in {seconds:.3f} s (first call at one row), prompt placed "
        f"{sharded_prompt.placements}, flash launches {launches} "
        f"({flash_attention.lse_launches} with lse), tokens placed "
        f"{tokens.placements}, equal to the plain generate's on that row: "
        f"{same}")
    if launches != cfg.n_layers or flash_attention.lse_launches or not same:
        raise AssertionError("one-row sharded generate disagrees with "
                             "generate")
    return launches


MOE_BATCH, MOE_SEQ, MOE_TIMED_STEPS = 4, 4096, 5
# Step 1's loss of the MoE and Ulysses trainers on one rank against the
# plain loss without a mesh, relative: the same bf16 computation through
# the same kernels, except that the step runs the with-lse forward under
# remat where the plain call, without autograd, runs the forward-only one.
# (The ring's fp32 einsum against the kernel's bf16 P takes LOSS_REL_TOL.)
SAME_PATH_LOSS_REL_TOL = 1e-3
SP_TIMED_STEPS = 2


def phase_moe(seed: int) -> dict:
    """MoE-Llama at full width and depth (``LlamaMoEConfig()``, 8 experts,
    top-2, bf16 compute, fp32 master weights from the seed) through
    ``make_moe_train`` on a (dp=1, ep=1) mesh of the gang of one, B=4,
    S=4096 (the gang of one is its process group): step 1's loss
    against the plain ``loss_fn`` without a mesh,
    its kernel launches and collectives, a lower loss on the same batch
    at step 2, the median of 5 timed steps (tok/s, MFU, peak memory) and
    a trace. Returns the launch counts of one step."""
    from k8s_dra_driver_gpu_tpu_torch.models import llama_moe
    from k8s_dra_driver_gpu_tpu_torch.parallel.mesh import build_expert_mesh
    from k8s_dra_driver_gpu_tpu_torch.train.train import tree_leaves

    cfg = llama_moe.LlamaMoEConfig()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama_moe.init(cfg, gen, "cuda")
    tokens = torch.randint(0, cfg.vocab_size, (MOE_BATCH, MOE_SEQ + 1),
                           generator=gen, device="cuda", dtype=torch.int32)
    n_params = sum(t.numel() for t in tree_leaves(params))
    with torch.no_grad():
        plain = llama_moe.loss_fn(params, tokens, cfg).item()
    mesh = build_expert_mesh(ep=1, dp=1)
    init_fn, step_fn, layout, _ = llama_moe.make_moe_train(mesh, cfg)
    state = init_fn(params)
    del params
    torch.cuda.empty_cache()
    log(f"moe: LlamaMoEConfig() {n_params / 1e6:.1f}M params fp32 master, "
        f"{str(cfg.dtype)[6:]} compute, {cfg.n_experts} experts top-"
        f"{cfg.top_k}, head_dim {cfg.head_dim}, B={MOE_BATCH} S={MOE_SEQ}, "
        f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")

    # The main path, counted: one step.
    batch = layout(tokens)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with counting_collectives() as calls:
        state, loss = step_fn(state, batch)
        losses = [loss.item()]
    first_s = time.perf_counter() - t0
    counts = read_launches()
    want = {"forward_lse": 2 * cfg.n_layers, "forward_only": 0,
            "dq": cfg.n_layers, "dkv": cfg.n_layers}
    rel = abs(losses[0] - plain) / abs(plain)
    log(f"moe: one step launched {counts} (want {want}; {first_s * 1e3:.1f}"
        f" ms, first step), collectives {len(calls)}; loss {losses[0]:.6f}"
        f" against the plain loss_fn's {plain:.6f}: rel {rel:.3g} (tol "
        f"{SAME_PATH_LOSS_REL_TOL})")
    if counts != want or calls or not rel <= SAME_PATH_LOSS_REL_TOL:
        raise AssertionError("MoE step disagrees with the plain loss or "
                             "its launches")
    step_s = []
    for _ in range(MOE_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log("moe: losses on one batch " + " ".join(f"{x:.4f}" for x in losses))
    if not (all(map(math.isfinite, losses)) and losses[1] < losses[0]):
        raise AssertionError(f"MoE loss did not fall: {losses}")
    step = statistics.median(step_s)
    tok_s = MOE_BATCH * MOE_SEQ / step
    mfu = 6 * n_params * MOE_BATCH * MOE_SEQ / step / PEAK_FLOPS[
        torch.bfloat16]
    if not all(map(math.isfinite, (step, tok_s, mfu, peak_gib))):
        raise AssertionError("non-finite MoE numbers")
    log(f"moe: step median {step * 1e3:.1f} ms over {len(step_s)} steps "
        f"(min {min(step_s) * 1e3:.1f}, max {max(step_s) * 1e3:.1f}), "
        f"{tok_s:.0f} tok/s, MFU {mfu:.3f} (6*N*tokens at 989 TFLOP/s, N "
        f"every expert's parameters, attention uncounted), peak "
        f"{peak_gib:.1f} GiB")

    def traced_step():
        nonlocal state
        state, loss = step_fn(state, batch)
        loss.item()

    log_kinds(profile(traced_step, "moe train step", top=10),
              "moe train step")
    del state, batch
    torch.cuda.empty_cache()
    return counts


def phase_sp(seed: int, mesh) -> dict:
    """Sequence-parallel training of the flagship (phase 5's parameters
    and batch, B=4, S=4096) through ``make_sp_train`` on the gang's
    (dp=1, sp=1) mesh, with Ulysses and with ring attention: step 1's
    loss against the plain full-logit loss, its kernel launches (Ulysses
    runs the flash kernels, the ring its fp32 einsum) and collectives
    (none at size 1), then timed steps and peak memory. Returns the
    launch counts of one step of each."""
    import torch.nn.functional as F

    from k8s_dra_driver_gpu_tpu_torch.models import llama
    from k8s_dra_driver_gpu_tpu_torch.train.sp_train import make_sp_train

    cfg = llama.LlamaConfig.flagship()
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init(cfg, gen, "cuda", dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda", dtype=torch.int32)
    with torch.no_grad():
        logits = llama.forward(params, tokens[:, :-1], cfg)
        plain = F.cross_entropy(logits.flatten(0, 1),
                                tokens[:, 1:].long().flatten()).item()
        del logits
    result = {}
    for attn, want, tol in (
            ("ulysses", {"forward_lse": 2 * cfg.n_layers, "forward_only": 0,
                         "dq": cfg.n_layers, "dkv": cfg.n_layers},
             SAME_PATH_LOSS_REL_TOL),
            ("ring", {"forward_lse": 0, "forward_only": 0, "dq": 0,
                      "dkv": 0}, LOSS_REL_TOL)):
        init_fn, step_fn, layout, _ = make_sp_train(mesh, cfg, attn)
        state = init_fn(params)
        batch = layout(tokens)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        with counting_collectives() as calls:
            state, loss = step_fn(state, batch)
            losses = [loss.item()]
        first_s = time.perf_counter() - t0
        counts = read_launches()
        rel = abs(losses[0] - plain) / abs(plain)
        log(f"sp {attn}: one step launched {counts} (want {want}; "
            f"{first_s * 1e3:.1f} ms, first step), collectives {len(calls)}"
            f"; loss {losses[0]:.6f} against the plain full-logit loss "
            f"{plain:.6f}: rel {rel:.3g} (tol {tol})")
        if counts != want or calls or not rel <= tol:
            raise AssertionError(f"sequence-parallel {attn} step disagrees")
        step_s = []
        for _ in range(SP_TIMED_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, loss = step_fn(state, batch)
            losses.append(loss.item())
            step_s.append(time.perf_counter() - t0)
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
            raise AssertionError(f"sp {attn} loss did not fall: {losses}")
        step = statistics.median(step_s)
        log(f"sp {attn}: losses {' '.join(f'{x:.4f}' for x in losses)}; step "
            f"median {step * 1e3:.1f} ms over {len(step_s)} (min "
            f"{min(step_s) * 1e3:.1f}, max {max(step_s) * 1e3:.1f}), "
            f"{TRAIN_BATCH * TRAIN_SEQ / step:.0f} tok/s, peak "
            f"{peak_gib:.1f} GiB")
        result[attn] = counts
        del state, batch
        torch.cuda.empty_cache()
    return result


PP_MICROBATCHES, PP_TIMED_STEPS = 4, 3
# Step 1 of the pipeline step against train_step's step 1 on the same 4
# rows (phase 5): the full-logit and the chunked loss are the same mean of
# the same bf16 logits, and the kernels treat each row alone, so what may
# differ is cuBLAS's tiling of [4096, ...] against [16384, ...] rows.
PP_STEP1_REL_TOL = 1e-3
# Step 2 follows one AdamW update from the two steps' gradients. Adam's
# first step moves a weight by lr g / (|g| + eps), about +-lr, so a weight
# whose gradient is within rounding of zero can move 2 lr the other way;
# the loss is held as the sharded step's steps 2-3 are (LOSS_REL_TOL).
PP_STEP2_REL_TOL = LOSS_REL_TOL


def phase_pp(seed: int, training: dict) -> dict:
    """Pipeline training of the flagship at full width and depth through
    ``make_pp_train`` on the gang's (pp=1, dp=1) mesh: phase 5's
    parameters and B=4, S=4096 batch as M=4 microbatches of one row, the
    bf16 Adam first moment. Steps 1 and 2's losses against
    ``train_step``'s, the launches of one step (M times the plain step's)
    and its collectives (none), 3 timed steps (tok/s, MFU, peak memory)
    and a trace by kind. Returns the launch counts of one step."""
    from k8s_dra_driver_gpu_tpu_torch.models import llama
    from k8s_dra_driver_gpu_tpu_torch.parallel.mesh import build_pipeline_mesh
    from k8s_dra_driver_gpu_tpu_torch.train.pp_train import make_pp_train
    from k8s_dra_driver_gpu_tpu_torch.train.train import (make_optimizer,
                                                          tree_leaves)

    cfg = llama.LlamaConfig.flagship()
    M = PP_MICROBATCHES
    gen = torch.Generator(device="cuda").manual_seed(seed)
    params = llama.init(cfg, gen, "cuda", dtype=torch.float32)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ + 1),
                           generator=gen, device="cuda", dtype=torch.int32)
    n_params = sum(t.numel() for t in tree_leaves(params))
    mesh = build_pipeline_mesh(1, 1)
    init_fn, step_fn, layout, _ = make_pp_train(
        mesh, cfg, M, make_optimizer(mu_dtype=torch.bfloat16))
    state = init_fn(params)
    del params
    batch = layout(tokens.reshape(M, TRAIN_BATCH // M, TRAIN_SEQ + 1))
    torch.cuda.empty_cache()
    log(f"pp: flagship {n_params / 1e6:.1f}M params through make_pp_train "
        f"on mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}, M={M} "
        f"microbatches of {list(batch.shape[1:])} tokens, remat={cfg.remat},"
        f" full-logit loss, bf16 Adam first moment")

    # The main path, counted: one step.
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with counting_collectives() as calls:
        state, loss = step_fn(state, batch)
        losses = [loss.item()]
    first_s = time.perf_counter() - t0
    counts = read_launches()
    want = {"forward_lse": 2 * cfg.n_layers * M, "forward_only": 0,
            "dq": cfg.n_layers * M, "dkv": cfg.n_layers * M}
    state, loss = step_fn(state, batch)
    losses.append(loss.item())
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, training["losses"])]
    log(f"pp: one step launched {counts} (want {want}; {first_s * 1e3:.1f} "
        f"ms, first step), collectives {len(calls)}; losses "
        f"{' '.join(f'{x:.6f}' for x in losses)} against train_step's "
        f"{' '.join(f'{x:.6f}' for x in training['losses'][:2])}: rel "
        f"{' '.join(f'{x:.3g}' for x in rel)} (tol step 1 "
        f"{PP_STEP1_REL_TOL}, step 2 {PP_STEP2_REL_TOL})")
    if counts != want or calls or not (rel[0] <= PP_STEP1_REL_TOL
                                       and rel[1] <= PP_STEP2_REL_TOL):
        raise AssertionError("pipeline step disagrees with train_step or "
                             "its launches")
    step_s = []
    for _ in range(PP_TIMED_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch)
        losses.append(loss.item())
        step_s.append(time.perf_counter() - t0)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if not (all(map(math.isfinite, losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"pp loss did not fall: {losses}")
    step = statistics.median(step_s)
    tokens_per_step = TRAIN_BATCH * TRAIN_SEQ
    mfu = 6 * n_params * tokens_per_step / step / PEAK_FLOPS[torch.bfloat16]
    log(f"pp: losses {' '.join(f'{x:.4f}' for x in losses)}; step median "
        f"{step * 1e3:.1f} ms over {len(step_s)} (min {min(step_s) * 1e3:.1f}"
        f", max {max(step_s) * 1e3:.1f}), {tokens_per_step / step:.0f} tok/s,"
        f" MFU {mfu:.3f} (6*N*M*1*S at 989 TFLOP/s, attention uncounted), "
        f"peak {peak_gib:.1f} GiB; plain train_step (phase 5) "
        f"{training['step_ms']:.1f} ms, peak {training['peak_gib']:.1f} GiB")

    def traced_step():
        nonlocal state
        state, loss = step_fn(state, batch)
        loss.item()

    log_kinds(profile(traced_step, "pp train step", top=10), "pp train step")
    del state, batch
    torch.cuda.empty_cache()
    return counts


LAUNCH_BATCH, LAUNCH_SEQ, LAUNCH_SEQUENCES = 4, 1024, 64
# (b)'s step 3 after the resume against (c)'s uninterrupted step 3: the
# same computation on the same state and batches, unless an op differs
# from run to run.
RESUME_REL_TOL = 1e-4


def _launch(args: list, env: dict, label: str, timeout: float = 900
            ) -> str:
    """Run a module of the port as a subprocess; its log (stdout then
    stderr); raises with its tail if it fails."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, "-m", *args], cwd=root,
                          env={**env, "PYTHONPATH": root}, capture_output=True,
                          text=True, timeout=timeout, check=False)
    out = proc.stdout + proc.stderr
    if proc.returncode:
        raise AssertionError(f"{label} exited with {proc.returncode}:\n"
                             f"{out[-4000:]}")
    return out


def phase_launcher(seed: int) -> None:
    """The port's entry points as a user starts them, each in its own
    process: ``train.verify --require-gang`` as a gang of one, then
    ``train.main`` on the flagship at S=1024 over a token file from the
    seed: (a) 2 steps, a checkpoint at step 2 and a trace, (b) 3 steps
    resumed from it, (c) 3 steps uninterrupted."""
    import os
    import re
    import shutil

    import numpy as np

    from k8s_dra_driver_gpu_tpu_torch.data.loader import write_token_file
    from k8s_dra_driver_gpu_tpu_torch.models import llama

    root = os.path.dirname(os.path.abspath(__file__))
    # A git-ignored directory of the checkout: the token file, ~7.4 GB of
    # checkpoint a step and the trace, all deleted at the end.
    work = os.path.join(root, "k8s_dra_driver_gpu_tpu_torch", "build",
                        "launcher_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("TPU_", "CHECKPOINT_DIR", "PROFILE_DIR",
                                "DATA_"))}
    try:
        out = _launch(["k8s_dra_driver_gpu_tpu_torch.train.verify",
                       "--require-gang"],
                      {**env, "TPU_COORDINATOR_ADDRESS":
                       f"127.0.0.1:{free_port()}", "TPU_PROCESS_ID": "0",
                       "TPU_NUM_PROCESSES": "1"}, "verify")
        lines = [line for line in out.splitlines() if line.startswith("{")]
        doc = json.loads(lines[0]) if len(lines) == 1 else {}
        log(f"launcher: verify printed {len(lines)} JSON line(s): "
            f"{json.dumps({k: v for k, v in doc.items() if k != 'env'})}")
        if not (len(lines) == 1 and doc["devSum"] == 1.0
                and doc["rankSum"] == 1.0 and doc["steps"] == 1
                and math.isfinite(float(doc["loss"])) and doc["gang"] is True):
            raise AssertionError(f"verify's proof failed: {lines}")

        vocab = llama.LlamaConfig.flagship().vocab_size
        data = os.path.join(work, "tokens.bin")
        write_token_file(data, np.random.RandomState(seed).randint(
            0, vocab, LAUNCH_SEQUENCES * LAUNCH_SEQ + 1))
        ckpt, trace = os.path.join(work, "ckpt"), os.path.join(work, "trace")
        common = ["k8s_dra_driver_gpu_tpu_torch.train.main", "--model",
                  "flagship", "--batch-size", str(LAUNCH_BATCH), "--seq-len",
                  str(LAUNCH_SEQ), "--data-file", data]
        logs = {}
        for label, extra in (
                ("a", ["--steps", "2", "--checkpoint-dir", ckpt,
                       "--checkpoint-every", "2", "--profile-dir", trace]),
                ("b", ["--steps", "3", "--checkpoint-dir", ckpt]),
                ("c", ["--steps", "3"])):
            t0 = time.perf_counter()
            logs[label] = _launch(common + extra, env, f"train.main ({label})")
            log(f"launcher: ({label}) "
                f"{' '.join(extra).replace(work + os.sep, '')}: "
                f"{time.perf_counter() - t0:.1f} s of process; "
                + "; ".join(line.split(" INFO ")[-1] for line in
                            logs[label].splitlines()
                            if re.search(r" INFO (step|checkpoint|resumed|"
                                         r"profile)", line)))
        step3 = {label: float(re.findall(r"step 3 loss (\S+) ",
                                         logs[label])[-1])
                 for label in ("b", "c")}
        if "resumed from step 2" not in logs["b"]:
            raise AssertionError("(b) did not resume from step 2")
        rel = abs(step3["b"] - step3["c"]) / abs(step3["c"])
        log(f"launcher: step 3 resumed {step3['b']!r} against uninterrupted "
            f"{step3['c']!r}: bitwise equal {step3['b'] == step3['c']}, rel "
            f"{rel:.3g} (tol {RESUME_REL_TOL}); disk free "
            f"{shutil.disk_usage(work).free / 2**30:.0f} GiB")
        if not (math.isfinite(step3["b"]) and rel <= RESUME_REL_TOL):
            raise AssertionError("the resumed run left the uninterrupted one")
        files = os.listdir(trace)
        text = "".join(open(os.path.join(trace, name), encoding="utf-8").read()
                       for name in files)
        names = {kernel: text.count(kernel) for kernel in (
            "flash_fwd_bf16", "flash_bwd_dq_bf16", "flash_bwd_dkv_bf16")}
        log(f"launcher: trace {files} ({len(text) / 2**20:.1f} MiB), kernel "
            f"names in it {names}")
        if not any(names.values()):
            raise AssertionError("the trace names no flash kernel")
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _daemon_domain_dir(directory: str, port: int) -> str:
    """A ComputeDomain daemon's bootstrap.json and members.json for a
    domain of one node, in the daemon's format (the daemon's stable DNS
    names, resolved through members.json); returns the bootstrap.json."""
    import os

    from k8s_dra_driver_gpu_tpu_torch.entry import daemon_dns_name

    name = daemon_dns_name(0)
    files = {
        "members.json": {"computeDomain": "chip-smoke", "cliqueID": "0",
                         "numWorkers": 1, "workers": [{
                             "name": "node-0", "ipAddress": "127.0.0.1",
                             "cliqueID": "0", "index": 0,
                             "status": "Ready"}]},
        "bootstrap.json": {"coordinatorAddress": f"{name}:{port}",
                           "numProcesses": 1, "processId": 0,
                           "workerHostnames": [name], "scope": "clique",
                           "cliqueID": "0"}}
    for file, doc in files.items():
        with open(os.path.join(directory, file), "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
    return os.path.join(directory, "bootstrap.json")


# Ranks of the dry run on this host's CPU (gloo), beside the card's: the
# families' DTensor paths at tp > 1 under this machine's torch, which a
# one-card machine cannot give NCCL ranks for.
ENTRY_CPU_RANKS = 4


def _check_dryrun(report: dict, label: str) -> None:
    """Every family that ran has finite losses; the dense step and
    serving ran."""
    for key, rep in report.items():
        values = rep.get("losses", [rep["loss"]] if "loss" in rep else [])
        if "skipped" not in rep and not all(map(math.isfinite, values)):
            raise AssertionError(f"dry run {label} {key}: {rep}")
    if "skipped" in report["train"] or len(report["serve"]["tokens"]) != \
            report["serve"]["batch"][0]:
        raise AssertionError(f"dry run {label}: {report}")


def _check_serve_rows(report: dict, n: int, label: str) -> None:
    """The dry run served the reference's prompt: a row a rank."""
    serve = report["serve"]
    log(f"entry: dryrun_multichip {label} served batch {serve['batch']} on "
        f"mesh {serve['mesh']}: {len(serve['tokens'])} rows of "
        f"{len(serve['tokens'][0])} tokens")
    if serve["batch"] != [n, 8]:
        raise AssertionError(f"dry run {label} served {serve['batch']}, "
                             f"not the reference's [{n}, 8]")


def _log_dryrun(report: dict, label: str, seconds: float) -> None:
    log(f"entry: dryrun_multichip {label} in {seconds:.1f} s of process: "
        + "; ".join(f"{key} skipped ({rep['skipped']})" if "skipped" in rep
                    else f"{key} {rep['seconds']:.2f} s"
                    for key, rep in report.items()))


def phase_entry() -> None:
    """11. The port's entry (``entry.py``): ``entry()``'s forward on the
    card; ``dryrun_multichip`` over every visible card (its own NCCL
    ranks) and, at the same time, over ``ENTRY_CPU_RANKS`` gloo ranks on
    the host, each family's seconds or skip; and
    ``dryrun_multichip_multiprocess`` as one node process from a
    daemon-format bootstrap.json."""
    import tempfile

    from k8s_dra_driver_gpu_tpu_torch import entry as pt_entry

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        return fn(*args, **kwargs), time.perf_counter() - t0

    with ThreadPoolExecutor(max_workers=1) as pool:
        on_host = pool.submit(timed, pt_entry.dryrun_multichip,
                              ENTRY_CPU_RANKS, device="cpu")
        t0 = time.perf_counter()
        fn, args = pt_entry.entry()
        logits = fn(*args)
        torch.cuda.synchronize()
        finite = bool(torch.isfinite(logits).all())
        log(f"entry: forward {tuple(logits.shape)} {logits.dtype} on "
            f"{logits.device}, finite {finite}, "
            f"{time.perf_counter() - t0:.2f} s")
        if logits.shape != (2, 32, 256) or not finite:
            raise AssertionError("entry forward")

        cards = torch.cuda.device_count()
        report, seconds = timed(pt_entry.dryrun_multichip, cards)
        _log_dryrun(report, f"({cards}) over NCCL", seconds)
        _check_dryrun(report, "on the card")
        _check_serve_rows(report, cards, f"({cards}) over NCCL")

        with tempfile.TemporaryDirectory() as tmp:
            reports, seconds = timed(
                pt_entry.dryrun_multichip_multiprocess, n_procs=1,
                local_devices=cards, timeout=300,
                bootstrap_file=_daemon_domain_dir(tmp, free_port()))
        log(f"entry: dryrun_multichip_multiprocess from a daemon-format "
            f"bootstrap.json in {seconds:.1f} s: "
            + json.dumps({k: v for k, v in reports[0].items() if k != "env"})
            + f", coordinator {reports[0]['env']['TPU_COORDINATOR_ADDRESS']}")

        report, seconds = on_host.result()
        _log_dryrun(report, f"({ENTRY_CPU_RANKS}) over gloo on the host "
                            f"(torch {torch.__version__})", seconds)
        _check_dryrun(report, "on the host")
        _check_serve_rows(report, ENTRY_CPU_RANKS, "over gloo on the host")
        if [key for key, rep in report.items() if "skipped" in rep]:
            raise AssertionError(f"a family skipped at n = "
                                 f"{ENTRY_CPU_RANKS}: {report}")


# Phase 12's child: the claim's env applied, it must see the claimed GPU
# alone, under the claim's product name, and run the flash forward
# kernel at the serving shape on phase 3's inputs (the first draw of a
# generator seeded with the seed), against its plain version within the
# bf16 tolerance and within row 1's measured error (one bf16 ulp at 0.5).
CLAIM_CHILD_MAX_ERR = 0.00391
CLAIM_CHILD = """
import json, sys
import torch
import chip_smoke as c
from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)

seed, product = int(sys.argv[1]), sys.argv[2]
count, name = torch.cuda.device_count(), torch.cuda.get_device_name(0)
if count != 1 or name != product:
    raise SystemExit(f"claim child sees {count} devices, {name!r}")
gen = torch.Generator(device="cuda").manual_seed(seed)
q, k, v = c.attention_inputs(gen, "serving", 4, 2048, 32, 8, 128,
                             torch.bfloat16)
flash_attention.launches = 0
got = flash_attention(q, k, v, causal=True)
launches = flash_attention.launches
want = flash_attention_reference(q, k, v, causal=True)
torch.cuda.synchronize()
atol, rtol = c.TOLERANCES[torch.bfloat16]
diff = (got.float() - want.float()).abs()
excess = (diff - atol - rtol * want.float().abs()).max().item()
print(json.dumps({"device_count": count, "name": name,
                  "launches": launches, "max_abs_err": diff.max().item(),
                  "excess": excess,
                  "finite": bool(torch.isfinite(got).all())}))
"""


def phase_kubelet_plugin(seed: int) -> int:
    """12. The port's kubelet plugin prepares a whole-GPU claim over the
    real NVML, and a child process run under the claim's CDI env runs the
    flash forward kernel. Returns the child's flash launches."""
    import os
    import re
    import shutil
    import tempfile

    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import (
        ResourceClaim)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.device_state import (
        Config, DeviceState)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.deviceinfo import (
        parse_gpu_name)
    from k8s_dra_driver_gpu_tpu_torch.tpulib import NvmlLib, load

    def ms_since(t0):
        return (time.perf_counter() - t0) * 1e3

    tmp = tempfile.mkdtemp(prefix="kp")
    try:
        t0 = time.perf_counter()
        state = DeviceState(Config(root=f"{tmp}/state",
                                   cdi_root=f"{tmp}/cdi"))
        construct_ms = ms_since(t0)
        devices = state.dra_devices()
        smi = _smi_chips()
        lib = load()
        if not isinstance(lib, NvmlLib):
            raise AssertionError(f"tpulib.load() gave {type(lib).__name__}")
        nvml = {gpu.index: gpu for gpu in lib.enumerate().chips}
        lib.close()
        refused = {name: dev.chip.refused_attributes()
                   for name, dev in state.allocatable.items()}
        log(f"kubelet plugin: DeviceState over {state.host.source} in "
            f"{construct_ms:.2f} ms of host time: "
            f"{[d['name'] for d in devices]}; attributes of gpu-0 "
            f"{json.dumps(devices[0]['attributes'])}, capacity "
            f"{devices[0]['capacity']}; left out as refused by NVML "
            f"{refused}")
        names = [d["attributes"]["productName"]["string"] for d in devices]
        memory = [int(d["capacity"]["memory"]["value"]) for d in devices]
        if names != [row["name"] for row in smi] or memory != [
                nvml[parse_gpu_name(d["name"])].memory_bytes
                for d in devices]:
            raise AssertionError(
                f"published {names} {memory}, nvidia-smi "
                f"{[row['name'] for row in smi]}, NVML "
                f"{[gpu.memory_bytes for gpu in nvml.values()]}")
        # A published UUID names its GPU: NVML's form, and nvidia-smi's.
        smi_uuid = {row["index"]: row["uuid"] for row in smi}
        uuids = {d["name"]: d["attributes"].get("uuid", {}).get("string")
                 for d in devices}
        for name, uuid in uuids.items():
            if uuid is not None and (
                    not re.fullmatch(GPU_UUID, uuid)
                    or uuid != smi_uuid[parse_gpu_name(name)]):
                raise AssertionError(f"{name} publishes uuid {uuid!r}")
        log(f"kubelet plugin: uuid published for "
            f"{[name for name, uuid in uuids.items() if uuid]} (each "
            f"{sorted({len(u) for u in uuids.values() if u})} chars, in "
            "NVML's form and equal to nvidia-smi's), left out for "
            f"{[name for name, uuid in uuids.items() if not uuid]}")

        claim = ResourceClaim.from_dict({
            "metadata": {"uid": "smoke-claim", "namespace": "default",
                         "name": "smoke-claim"},
            "status": {"allocation": {"devices": {"results": [
                {"request": "gpu", "driver": DRIVER_NAME, "pool": "node",
                 "device": "gpu-0"}], "config": []}}}})
        t0 = time.perf_counter()
        ids = state.prepare(claim)
        prepare_ms = ms_since(t0)
        segments = {k: round(v * 1e3, 3)
                    for k, v in state.last_segments.items()}
        t0 = time.perf_counter()
        again = state.prepare(claim)
        repeat_ms = ms_since(t0)
        record = state.prepared_claims()[claim.uid]
        spec = state._cdi.read_spec(claim.uid)
        nodes = [n["path"] for d in spec["devices"]
                 for n in d["containerEdits"]["deviceNodes"]]
        gpu0 = state.allocatable["gpu-0"].chip.chip
        log(f"kubelet plugin: prepared {ids} in {prepare_ms:.2f} ms of host "
            f"time (segments ms {segments}), again {again} in "
            f"{repeat_ms:.2f} ms; checkpoint {record.state}; spec device "
            f"nodes {nodes} (exists: {[os.path.exists(n) for n in nodes]}), "
            f"common {json.dumps(spec['containerEdits'])}")
        if (ids != ["nvidia.com/gpu=gpu-0"] or again != ids
                or record.state != "PrepareCompleted"
                or nodes != [f"/dev/nvidia{gpu0.minor}"]
                or not os.path.exists(nodes[0])):
            raise AssertionError("kubelet plugin prepare")

        env = dict(os.environ)
        edits = [d["containerEdits"] for d in spec["devices"]] + [
            spec["containerEdits"]]
        for entry in (e for edit in edits for e in edit.get("env", [])):
            key, _, value = entry.partition("=")
            env[key] = value
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", CLAIM_CHILD, str(seed), gpu0.name],
            env=env, capture_output=True, text=True, timeout=300,
            check=False)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError(f"claim child exited {child.returncode}: "
                                 f"{child.stderr[-4000:]}")
        result = json.loads(child.stdout.strip().splitlines()[-1])
        log(f"kubelet plugin: child under CUDA_DEVICE_ORDER="
            f"{env['CUDA_DEVICE_ORDER']} in {child_s:.2f} s of process: "
            f"{json.dumps(result)} (flash forward at B=4 S=2048 H=32 K=8 "
            f"hd=128 bf16, max_abs_err bound {CLAIM_CHILD_MAX_ERR})")
        if (result["device_count"] != 1 or result["launches"] != 1
                or not result["finite"] or result["excess"] > 0
                or result["max_abs_err"] > CLAIM_CHILD_MAX_ERR):
            raise AssertionError(f"claim child: {result}")

        t0 = time.perf_counter()
        state.unprepare(claim.uid)
        unprepare_ms = ms_since(t0)
        t0 = time.perf_counter()
        state.unprepare(claim.uid)
        repeat_unprepare_ms = ms_since(t0)
        left = (state._cdi.spec_exists(claim.uid),
                claim.uid in state.prepared_claims())
        log(f"kubelet plugin: unprepared in {unprepare_ms:.2f} ms of host "
            f"time, again (no-op) in {repeat_unprepare_ms:.2f} ms; spec "
            f"left {left[0]}, checkpoint record left {left[1]}")
        if any(left):
            raise AssertionError("kubelet plugin unprepare left state")
        return result["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    phase_device()
    phase_device_layer()
    phase_build()
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    forward = phase_kernels(gen)
    with_lse, dq, dkv, hd64_records = phase_training_kernels(gen)
    fp32_records = phase_fp32_kernels(gen)
    serving = phase_serving(args.seed)
    serving_launches = serving["launches"]
    torch.cuda.empty_cache()
    training, train_numbers = phase_training(args.seed)
    with gang_of_one() as mesh:
        gang = phase_gang(args.seed, mesh, serving, train_numbers)
        del serving
        torch.cuda.empty_cache()
        moe = phase_moe(args.seed)
        sp = phase_sp(args.seed, mesh)
        pp = phase_pp(args.seed, train_numbers)
    torch.cuda.empty_cache()
    phase_launcher(args.seed)
    phase_entry()
    t_plugin = time.perf_counter()
    claim_child = phase_kubelet_plugin(args.seed)
    log(f"kubelet plugin: phase 12 in "
        f"{time.perf_counter() - t_plugin:.1f} s")
    forward["launches_by_path"] = {
        "serving_generate": serving_launches,
        "training_step": training["forward_lse"],
        "sharded_generate": gang["generate"],
        "sampled_sharded_generate": gang["sampled_generate"],
        "one_row_sharded_generate": gang["one_row_generate"],
        "prepared_claim_child": claim_child,
        "sharded_training_step": gang["train"]["forward_lse"],
        "moe_training_step": moe["forward_lse"],
        "sp_ulysses_training_step": sp["ulysses"]["forward_lse"],
        "sp_ring_training_step": sp["ring"]["forward_lse"],
        "pp_training_step": pp["forward_lse"]}
    forward["launches"] = sum(forward["launches_by_path"].values())
    forward.update({f"with_lse_{key}": value
                    for key, value in with_lse.items()})
    for record, kernel in ((dq, "dq"), (dkv, "dkv")):
        record["launches_by_path"] = {
            "training_step": training[kernel],
            "sharded_training_step": gang["train"][kernel],
            "moe_training_step": moe[kernel],
            "sp_ulysses_training_step": sp["ulysses"][kernel],
            "sp_ring_training_step": sp["ring"][kernel],
            "pp_training_step": pp[kernel]}
        record["launches"] = sum(record["launches_by_path"].values())
    # The hd-64 instantiations: the MoE step's launches.
    for record, kernel in zip(hd64_records, ("forward_lse", "dq", "dkv")):
        record["launches_by_path"] = {"moe_training_step": moe[kernel]}
        record["launches"] = moe[kernel]
    log(f"kernels: flash_attention launches={forward['launches']} "
        f"{forward['launches_by_path']}, dq {dq['launches_by_path']}, dk/dv "
        f"{dkv['launches_by_path']}, hd 64 "
        f"{[r['launches'] for r in hd64_records]}, fp32 "
        f"{[r['launches'] for r in fp32_records]} (total "
        f"{time.perf_counter() - t_start:.1f} s)")
    print(json.dumps({"kernels": [forward, dq, dkv, *fp32_records,
                                  *hd64_records]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
