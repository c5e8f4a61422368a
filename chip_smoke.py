#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Phases, each of which raises on failure (the script then exits non-zero
and prints no result line):

1. device: the card's name and power limit; TF32 off for fp32 matmuls.
1b. device layer: ``tpulib.load()`` must give ``NvmlLib`` (NVML over
   ctypes), read in a process of its own that never initialises CUDA
   (``NVML_READER``), as the plugin's. Its structs' ctypes layout
   against the toolkit's ``nvml.h`` (a C probe built with the host
   compiler); every GPU against
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
13. node driver: the kubelet plugin's node service (``kubeletplugin.
   driver.Driver``) over the real NVML and the port's ``FakeApiServer``
   on 127.0.0.1, through the real ``KubeClient``: its ResourceSlice read
   back over HTTP equals ``generate_resource_slices()`` (the devices of
   ``DeviceState`` with their counters and the health-off taint) at
   generation 1, a republish writes nothing; one ``ChipHealthMonitor``
   poll of a fresh NVML handle (closed at ``stop()``) replaces the
   taints with its own; a synthetic fatal ``chip_lost`` taint on
   ``gpu-0`` and its clearing cost one PUT each at generation 1, an
   unchanged taint set no request; a ``resource.k8s.io/v1`` claim for
   ``gpu-0`` prepared through the API lookup, its spec mounting the
   driver's libraries at NVML's version (each an existing file, libcuda
   and libnvidia-ml among them); phase 12's child under that spec's env,
   whose mapped ``libcuda`` and ``libnvidia-ml`` must be among the
   mounts' host paths; unprepare; a second prepare, the claim deleted
   from the server, and the sweep reaping it (``stale_claim`` 1, spec
   and record gone); the server stopped and its threads joined. Host ms
   of each step.
14. sharing: ``DeviceState`` over the real NVML with the gates
   ``TimeSlicingSettings`` and ``MultiTenancySupport`` on, in a
   temporary directory. It logs where ``nvidia-cuda-mps-control`` and
   ``-server`` are and ``gpu-0``'s timeslice (``nvidia-smi compute-policy
   -l``). ``gpu-0`` prepared at the Long interval: it reads Long and,
   after unprepare, Default; or the machine refuses ("Insufficient
   Permissions" or "Not Supported"), the ``PrepareError`` quotes it, and
   no record, spec or other level is left. ``gpu-0`` prepared with MPS
   (``maxClients`` 2, ``hbmLimit`` 8Gi): its daemon answers with an 8G
   limit for device 0 and the spec points at its pipe directory; two
   concurrent ``python3`` clients under the spec's env (the pipe dir's
   container path mapped back to its host path) each see one GPU, run
   the flash forward kernel once against its plain version, allocate 4
   GiB and get ``torch.OutOfMemoryError`` for 12 GiB, and
   ``get_server_list`` names a server; or, where the machine will not run
   MPS's server, each client fails with CUDA's "MPS client failed to
   connect" and the server's log says why. Where there is no MPS binary
   or its daemon does not start, the prepare's ``PrepareError`` and
   rollback are checked instead. Unprepare quits the daemon: no
   ``nvidia-cuda-mps-*`` process is left. A ``finally`` quits any daemon
   the phase started and restores ``gpu-0``'s timeslice. Host ms of each
   step. It runs without tenancy agents (``tenancy_agents=False``), as
   before they were ported: phase 17 runs them.
15. mig: MIG devices through the node service, run in a child process
   that never initialises CUDA (``MIG_PLUGIN``): ``Driver`` over the real
   NVML with ``DynamicSubSlice`` on, ``split`` publication over the
   port's fake API server, temporary roots. It logs ``nvidia-smi``'s MIG
   mode, NVML's ``mig_mode`` and refusals, and whether
   ``/proc/driver/nvidia-caps/mig-minors`` and ``/dev/nvidia-caps/``
   exist. Exactly one of three outcomes must hold: (a) MIG off (or its
   mode refused): no MIG device published, one slice whose GPUs carry
   their per-GPU counter sets, a claim for ``gpu-0-mig-1g10gb-0`` refused
   as an unknown device with no record, spec or registry entry left, and
   a ``static_subslices`` entry failing construction with ``ValueError``;
   (b) MIG on and creation allowed: the claim's 1g.10gb instance at slot 0
   listed by NVML's walk, a ``python3`` child under its spec's env plus
   ``CUDA_VISIBLE_DEVICES=<its MIG UUID>`` that sees one device with the
   profile's SMs and runs the flash forward at the serving shape against
   its plain version within phase 12's tolerance, and unprepare
   destroying it; (c) MIG on and creation refused: the ``PrepareError``
   quotes NVML's return code and the rollback leaves nothing. The sweep
   follows; a ``finally`` (and a cleanup child if the first one failed)
   destroys whatever the registry still names. It never changes the MIG
   mode. Host ms of construction, publication, prepare (with its
   ``prep_create_subslice`` segment), unprepare and the sweep.
16. partitions: tenant partitions over MIG instances, in a child that
   never initialises CUDA (``PARTITION_PLUGIN``). ``DeviceState`` over
   the real NVML with ``DynamicSubSlice``, ``TenantPartitioning`` and
   both sharing gates, and a ``PartitionSet`` of two profiles over
   ``1g.10gb``: ``x1`` (one tenant) and ``s2`` (two, ``hbmFraction``
   0.9). Exactly one of three outcomes must hold: (a) MIG off:
   construction refuses the set with ``PartitionSpecError`` naming
   ``1g.10gb`` as no carve-out of this host, nothing left behind; (b) MIG
   on and MPS served: two tenant claims on ``pt-s2-0`` give one MIG
   instance and one MPS daemon, each tenant's ``python3`` child runs
   phase 15's flash forward under its spec's env (the daemon's pipe
   directory and pinned memory limit) against its plain version, and
   unpreparing both destroys the instance and quits the daemon; (c) MIG
   on and the create or MPS refused: the ``PrepareError`` is logged and
   the rollback leaves nothing. On every outcome, the watch over HTTP: a
   ``Driver`` over the port's fake API server on 127.0.0.1 with a
   bootstrap set whose pool glob matches no node (0 partition devices),
   then a PartitionSet CRD for this pool naming ``1g.10gb`` (under (a)
   refused fail-closed: ``last_error`` set, ``failed_total`` 1, no slice
   written), then its delete (the bootstrap plan again, no write under
   (a)); the ms from each CRD write to the watcher's decision, the
   requests by method, and one sweep. A ``finally`` (and a cleanup child
   if the first one failed) destroys whatever the registries still name
   and kills any MPS process whose pipe directory lies under the phase's
   temporary root. It never changes the MIG mode. Host ms of
   construction, prepare (with ``prep_attach_partition``), unprepare and
   the sweep, beside the card's name and power limit.
17. tenancy: admission through the tenancy agents, in this process,
   over the real NVML with both sharing gates on and agents on
   (``Config.tenancy_agents``, the production default; phase 14 runs
   with them off). The native preflight hook is built from
   ``csrc/tenancy_preflight.cc`` (the compiler, its flags and whether the
   binary is static, by its ELF program headers, are logged). An MPS
   prepare and unprepare of ``gpu-0`` without agents (a second state
   root) is timed beside the same with agents. With agents: a claim with
   no client cap and a ``48Gi`` limit admits one container through the
   spec's own ``createContainer`` hook and denies a second, whose 48 GiB
   would pass the GPU's memory ("HBM budget exceeded", the bytes left
   quoted); unprepared. Then ``gpu-0`` with ``maxClients: 1`` and
   ``8Gi``: the hooks run as a runtime runs them (the OCI state on
   stdin): ``ctr-a`` admitted, ``ctr-b`` denied ("max clients (1)
   reached"), ``ctr-a``'s poststop, ``ctr-b`` admitted; one round trip
   of the native hook and of the Python one (``tenancy_preflight``, a
   ``python3`` process) timed. ``ctr-b``'s client, a ``python3`` child
   under the spec's env as in phase 14, runs the flash forward once
   where MPS serves, or fails with the MPS refusal phase 14 checks. The
   agent is SIGKILLed: its watchdog starts it again and ``MEMBERS`` still
   lists ``ctr-b``. A second ``DeviceState`` over the same root (the
   plugin restarted after ``close()``) re-owns it, ``ctr-b`` kept.
   Unprepare: no agent process (by its pidfile and a ``/proc`` scan), no
   agent directory, no socket and no MPS process of the phase is left.
   Host ms of the build, each prepare and unprepare, the hook round
   trips, the respawn and the re-own, beside the card's name and power
   limit.
18. compute domain: a ComputeDomain gang of one through the port's
   stack over its ``FakeApiServer`` on 127.0.0.1 (the controller, the CD
   plugin and the daemon each over HTTP). A domain of ``numNodes: 1``:
   the controller's reconcile (finalizer, DaemonSet, both claim
   templates); a daemon claim prepared by ``CDDriver``; ``python -m
   ...computedomain.daemon.main run`` under that claim's CDI env (its
   ``DOMAIN_STATE_DIR`` the host side of the spec's mount) with free
   rendezvous and coordinator ports; within a bound, its service READY,
   its clique member Ready and the controller's ``status: Ready``; a
   channel claim prepared (its retries counted). A ``python3`` child
   under that spec's env merged with a ``gpu-0`` claim's spec (the GPU
   plugin's, as CDI merges two claims of one pod) runs ``train.verify
   --require-gang --steps 2`` as a gang of one over NCCL from the
   injected ``TPU_*`` env alone, then the flash forward at the serving
   shape against its plain version (phase 12's child and tolerance).
   ``entry.dryrun_multichip_multiprocess`` runs from the daemon's own
   ``bootstrap.json`` (its coordinator's DNS name resolved through its
   ``members.json``) and must reach the channel env's coordinator. A
   second domain of ``numNodes: 2``, whose second node never comes, on a
   second node: its channel prepare aborts twice at a 1 s deadline and
   unwinds (no spec, no record, one ``GangPrepareAborted`` Event; the
   label kept while the domain lives, and gone after its deletion).
   Teardown in a cluster's order: the channel claim unprepared (the label
   goes), the daemon SIGTERMed (it deregisters, its rendezvous child
   exits), the daemon and GPU claims unprepared, the first domain deleted
   (as an API server does: ``deletionTimestamp``, the controller's
   teardown, then the object), the stale domain dir removed; no process,
   spec, domain dir or registration is left. Host ms of each step beside
   the card's name and power limit, and the span split (``span_tree``,
   from the phase's own exporter) of the reconcile (each ``cd.reconcile``
   pass, from the domain's create) and of the channel prepare (its
   ``cd_prepare`` span and segments; its retries from the
   ``cd_prepare_done`` flight event).
19. observability (``phase_observability``): the kubelet plugin's
   ``Driver`` over NVML (phase 13's construction: no health monitor)
   with ``DRARequestMetrics`` and a loopback ``MetricsServer``; one
   ``gpu-0`` claim carrying a traceparent annotation (ids from the seed)
   prepared and unprepared: ``/metrics`` shows one
   ``NodePrepareResources`` and no error, the prepared-devices gauge 1
   then 0; ``/debug/traces/<trace id>`` holds the ``prepare`` span under
   the annotation's span, with its segment spans; ``/debug/claims/<uid>``
   and ``/debug/claims/<ns>/<name>`` give the same ``prepare_done``
   event. Then two ``computedomain.controller.main --leader-election``
   processes over the fake server (default 30/10/2 s timings): one holds
   the Lease and reconciles a domain (finalizer, DaemonSet, templates;
   its status gauge and ``cd.reconcile`` spans on its listener, nothing
   on the standby's); SIGTERM makes it exit 0 and release; the standby
   takes over and reconciles a second domain; SIGTERM, exit 0, the Lease
   released. Then the webhook: with ``openssl``, ``certbootstrap.run``
   against a ValidatingWebhookConfiguration and ``webhook.main`` on the
   secret's cert, three AdmissionReviews over TLS verified as the
   service's name against the patched caBundle (a valid GPU config
   allowed, an unknown field refused 422, a domain whose nodes do not
   split over its slices refused); without ``openssl`` it says so on a
   line of its own and posts them over plain HTTP. Every child is reaped
   and every server stopped; host ms of each step beside the card.
20. scheduler (``phase_scheduler``, host clock): (a) the kubelet
   plugin's ``Driver`` publishes the card from NVML to the port's
   ``FakeApiServer`` on 127.0.0.1, the port's five DeviceClasses are
   created, and the scheduler binary (``python -m
   k8s_dra_driver_gpu_tpu_torch.pkg.scheduler --interval 0.1
   --metrics-port N``) runs as a process. A ResourceClaimTemplate (class
   ``gpu.nvidia.com``, CEL on NVML's ``productName`` and on
   ``capacity.memory`` against ``quantity("40Gi")``) and a pod using it:
   the binary generates the claim, allocates ``gpu-0`` on the node,
   reserves it for the pod and binds the pod; the ``Driver`` prepares it
   through the API lookup and a child under its CDI spec runs the flash
   forward against its plain version (phase 12's child). The claim's
   traceparent is the binary's ``sched.commit`` span (its
   ``/debug/traces``), the prepare's parent, with the segment spans
   below. A second ``gpu.nvidia.com`` claim (after one claim a further
   GPU, none on one card) waits three passes while the GPU is held and a
   ``mig.nvidia.com`` claim finds no MIG device; once the first claim is
   unprepared and deleted, the second is allocated within two passes.
   ``/metrics`` shows the passes and the fit, commit and patch phases;
   SIGTERM gives exit 0. (b) The node's published slice cloned onto 128
   nodes of 8 GPUs (fresh UUIDs) in the port's in-process
   ``FakeKubeClient``: 16 eight-GPU claims (``matchAttribute`` on
   ``acceleratorType``), 768 one-GPU claims and 2 that cannot fit (9 GPUs;
   a product no device has), ``sync_once`` until a pass allocates
   nothing: each pass's ms, claims a second, no device twice, every
   claim that fits allocated, each 8-GPU claim on one node, the two
   pending; under 90 s. Host ms beside the card's name and power limit.

The last line of stdout is ``{"ok": true, "device": {...}}``; the line
before it is the kernels' JSON record (with the hd-64 instantiations'
records after the others).
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import functools
import inspect
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


# Phase 1b's NVML reader, a process of its own that never initialises
# CUDA, as the plugin never does. On an H100 host (driver 580.159.03) some
# processes that had initialised CUDA through torch and then read the
# NVLink error fields through NVML aborted with a corrupted heap ("double
# free or corruption (!prev)", "free(): invalid next size"); processes
# without CUDA did not (``python -m k8s_dra_driver_gpu_tpu_torch.tpulib.
# heap_probe`` counts both; PERF.md has its counts). It writes one JSON
# line after the enumeration, the health poll and an idle sample; waits
# for a line on stdin; samples the GPUs every 0.1 s until the next one;
# and writes the samples, the NVLink fields and what NVML refused.
NVML_READER = """
import dataclasses, json, select, sys, time
from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as gpulib

def emit(**doc):
    print(json.dumps(doc), flush=True)

def telemetry():
    return [s.to_dict() for s in lib.chip_telemetry()]

lib = gpulib.load()
try:
    t0 = time.perf_counter()
    host = lib.enumerate()
    enumerate_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    events = lib.health()
    health_ms = (time.perf_counter() - t0) * 1e3
    emit(backend=type(lib).__name__, host=dataclasses.asdict(host),
         enumerate_ms=enumerate_ms, health=[dataclasses.asdict(e)
                                            for e in events],
         health_ms=health_ms, events_supported=lib.health_events_supported,
         events_refused=lib.events_refused, refusals=lib.refusals,
         idle=telemetry())
    sys.stdin.readline()
    samples = []
    while not select.select([sys.stdin], [], [], 0.1)[0]:
        samples.append(telemetry())
    sys.stdin.readline()
    nvlink = [[dataclasses.asdict(r) for r in lib.nvlink_errors(chip.index)]
              for chip in host.chips]
    emit(samples=samples, nvlink=nvlink, telemetry=telemetry(),
         profiles=len(lib.subslice_profiles()), refusals=lib.refusals)
finally:
    lib.close()
"""


class NvmlReader:
    """``NVML_READER`` run from the repo's root: ``reply()`` reads its next
    JSON line, ``tell()`` writes it a line."""

    def __init__(self):
        import os

        self.proc = subprocess.Popen(
            [sys.executable, "-c", NVML_READER], stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))

    def reply(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise AssertionError(f"the NVML reader exited "
                                 f"{self.proc.wait(timeout=60)}")
        return json.loads(line)

    def tell(self) -> None:
        self.proc.stdin.write("\n")
        self.proc.stdin.flush()

    def close(self) -> None:
        """Ends the reader's input and waits for its exit (it then reads
        the NVLink fields and writes its last line, unread); kills it if
        it is still running after a minute."""
        try:
            self.proc.stdin.close()
            rc = self.proc.wait(timeout=60)
        finally:
            if self.proc.poll() is None:
                self.proc.kill()
                self.proc.wait()
        if rc:
            raise AssertionError(f"the NVML reader exited {rc}")


def _telemetry_under_load(reader: NvmlReader, chip: int
                          ) -> tuple[list, int, dict]:
    """The reader's samples of ``chip`` every 0.1 s while ~LOAD_SECONDS of
    bf16 products run with LOAD_BYTES allocated beside them; the bytes the
    allocator took from the card for them; and the reader's last reply."""
    from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as gpulib

    reserved = torch.cuda.memory_reserved()
    a = torch.randn(LOAD_DIM, LOAD_DIM, device="cuda", dtype=torch.bfloat16)
    b = torch.randn_like(a)
    ballast = torch.ones(LOAD_BYTES, device="cuda", dtype=torch.uint8)
    matmul_ms = time_ms(lambda: a @ b, iters=5)
    taken = torch.cuda.memory_reserved() - reserved
    reader.tell()
    try:
        for _ in range(int(LOAD_SECONDS * 1e3 / matmul_ms)):
            a @ b
        torch.cuda.synchronize()
    finally:
        reader.tell()
    done = reader.reply()
    del a, b, ballast
    torch.cuda.empty_cache()
    samples = [gpulib.ChipTelemetry(**sample[chip])
               for sample in done["samples"]]
    return samples, taken, done


# nvidia-smi's names of the NVLink error counters, by NVML field.
SMI_NVLINK_ERRORS = {"Replay": "NVML_FI_DEV_NVLINK_ERROR_DL_REPLAY",
                     "Recovery": "NVML_FI_DEV_NVLINK_ERROR_DL_RECOVERY",
                     "CRC": "NVML_FI_DEV_NVLINK_ERROR_DL_CRC"}


def _nvlink_errors(done: dict, chip: int) -> None:
    """The NVLink error fields of ``chip``, link by link, from the NVML
    reader's last reply: what NVML gave (field values, or the legacy
    counters in place of a refused field) and refused; ``ici_link_errors``
    must be the sum of what it gave, and the field values must equal
    ``nvidia-smi nvlink -e``'s counters where it prints them. A container
    that refuses everything is logged."""
    import re

    from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as gpulib

    readings = [gpulib.NvLinkErrorReading(**r) for r in done["nvlink"][chip]]
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
    total = done["telemetry"][chip]["ici_link_errors"]
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
    """1b. The device layer (``tpulib``) on this host's NVML, read by
    ``NVML_READER`` in a process without CUDA."""
    import os
    import re

    from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as gpulib

    reader = NvmlReader()
    try:
        first = reader.reply()
        if first["backend"] != "NvmlLib":
            raise AssertionError(f"load() gave {first['backend']}, not "
                                 f"NvmlLib")
        layout, want_layout = gpulib.struct_layout(), _layout_against_nvml_h()
        log(f"device layer: ctypes struct layouts and constants equal "
            f"nvml.h's {layout == want_layout} ({len(gpulib.NVML_STRUCTS)} "
            f"structs, {len(layout) - len(gpulib.NVML_STRUCTS)} constants: "
            + ", ".join(f"{name} {layout[name]}" for name in
                        ("nvmlFieldValue_t", *gpulib.NVML_FIELD_IDS)) + ")")
        if layout != want_layout:
            raise AssertionError(f"struct layouts: ctypes {layout}, "
                                 f"nvml.h {want_layout}")
        host = gpulib.GpuHostInfo(**{**first["host"], "chips": tuple(
            gpulib.GpuChip(**c) for c in first["host"]["chips"])})
        enumerate_ms = first["enumerate_ms"]
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
                "nvmlDeviceGetPciInfo_v3" not in first["refusals"]:
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

        health_ms = first["health_ms"]
        log(f"device layer: idle health poll {first['health']}; events "
            f"supported {first['events_supported']}, refused "
            f"{first['events_refused']}")

        idle = gpulib.ChipTelemetry(**first["idle"][chip.index])
        samples, taken, done = _telemetry_under_load(reader, chip.index)
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

        _nvlink_errors(done, chip.index)
        cli = subprocess.run(
            [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.tpulib"],
            capture_output=True, text=True, timeout=120, check=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        doc = json.loads(cli.stdout)
        log(f"device layer: MIG {host.mig_mode}, {done['profiles']} "
            f"profile(s); "
            f"CLI {json.dumps(doc, separators=(',', ':'))}")
        if doc["backend"] != "nvml" or len(doc["chips"]) != len(host.chips):
            raise AssertionError("the CLI's enumeration")
        log(f"device layer: NVML refused {done['refusals']}; host ms: "
            f"enumerate {enumerate_ms:.2f}, health poll {health_ms:.2f}")
    finally:
        reader.close()


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
import ctypes, json, os, sys
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
# The driver libraries this process really runs on (phase 13).
ctypes.CDLL("libnvidia-ml.so.1")
mapped = sorted({os.path.realpath(f[5]) for f in (
    line.split() for line in open("/proc/self/maps")) if len(f) >= 6
    and os.path.basename(f[5]).startswith(("libcuda.so",
                                           "libnvidia-ml.so"))})
print(json.dumps({"device_count": count, "name": name,
                  "launches": launches, "max_abs_err": diff.max().item(),
                  "excess": excess, "mapped": mapped,
                  "finite": bool(torch.isfinite(got).all())}))
"""


def run_claim_child(spec: dict, seed: int, product: str, label: str,
                    also: tuple = (), script: str = CLAIM_CHILD) -> dict:
    """Run ``script`` (``CLAIM_CHILD`` by default) with the env of the
    spec and then of each spec of ``also`` applied (device edits, then
    common edits), as CDI merges the claims of one pod; its last JSON
    line, checked: one device, one launch, finite, within
    ``CLAIM_CHILD_MAX_ERR``. ``stdout`` holds the child's whole output."""
    import os

    env = dict(os.environ)
    edits = [edit for one in (spec, *also) for edit in
             [d["containerEdits"] for d in one["devices"]]
             + [one.get("containerEdits", {})]]
    for entry in (e for edit in edits for e in edit.get("env", [])):
        key, _, value = entry.partition("=")
        env[key] = value
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", script, str(seed), product],
        env=env, capture_output=True, text=True, timeout=300, check=False)
    child_s = time.perf_counter() - t0
    if child.returncode != 0:
        raise AssertionError(f"claim child exited {child.returncode}: "
                             f"{child.stderr[-4000:]}")
    result = json.loads(child.stdout.strip().splitlines()[-1])
    result["seconds"] = child_s
    result["stdout"] = child.stdout
    log(f"{label}: child under CUDA_DEVICE_ORDER="
        f"{env['CUDA_DEVICE_ORDER']} in {child_s:.2f} s of process: "
        f"{json.dumps({k: v for k, v in result.items() if k != 'stdout'})} "
        f"(flash forward at B=4 S=2048 H=32 K=8 "
        f"hd=128 bf16, max_abs_err bound {CLAIM_CHILD_MAX_ERR})")
    if (result["device_count"] != 1 or result["launches"] != 1
            or not result["finite"] or result["excess"] > 0
            or result["max_abs_err"] > CLAIM_CHILD_MAX_ERR):
        raise AssertionError(f"claim child: {result}")
    return result


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

        result = run_claim_child(spec, seed, gpu0.name, "kubelet plugin")

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


NODE = "smoke-node"
RESOURCE_SLICES = ("resource.k8s.io", "v1", "resourceslices")
RESOURCE_CLAIMS = ("resource.k8s.io", "v1", "resourceclaims")


def phase_node_driver(seed: int) -> int:
    """13. The kubelet plugin as a node service over NVML, against the
    port's fake API server on 127.0.0.1 through the real ``KubeClient``:
    publication, health taints, a claim prepared through the API lookup
    with the driver's libraries mounted, the child under its env, and the
    sweep. Returns the child's flash launches."""
    import os
    import shutil
    import tempfile
    import threading

    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.cdi import (
        driver_mounts, mapped_library_dirs)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.device_state import (
        Config)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.deviceinfo import (
        parse_gpu_name)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.driver import Driver
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.health import (
        ChipHealthMonitor, DeviceTaint)
    from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
    from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import KubeClient
    from k8s_dra_driver_gpu_tpu_torch.tpulib import (EnumerateOptions,
                                                     NvmlLib, load)

    ms = {}

    def timed(label, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        ms[label] = round((time.perf_counter() - t0) * 1e3, 3)
        return out

    def check(ok, what):
        if not ok:
            raise AssertionError(f"node driver: {what}")

    def published():
        items = kube.list(*RESOURCE_SLICES)
        check(len(items) == 1, f"{len(items)} slices")
        return items[0]

    tmp = tempfile.mkdtemp(prefix="nd")
    server = FakeApiServer().start()
    try:
        kube = KubeClient(host=server.url)
        driver = timed("construct", Driver, Config(
            root=f"{tmp}/state", cdi_root=f"{tmp}/cdi"), kube, NODE, False)
        host = driver.state.host
        timed("find_libraries", driver_mounts, "/", host.driver_version)
        check(host.source == "nvml" and host.driver_version,
              f"DeviceState over {host.source}, driver "
              f"{host.driver_version!r}")
        log(f"node driver: this process maps libnvidia-ml from "
            f"{mapped_library_dirs('/')} under /")

        # Publication: read back over HTTP, then a converged republish.
        stats = timed("publish", driver.publish_resources)
        got = published()
        want = driver.generate_resource_slices()
        # Each GPU consumes all of its own counter set: its 8 MIG memory
        # slots and its memory (and its SMs, with MIG on).
        sets = {s["name"]: s["counters"]
                for s in got["spec"]["sharedCounters"]}
        devices = [dict(dev, taints=[{"key": "tpu.dra.dev/unmonitored",
                                      "value": "true"}],
                        consumesCounters=[{
                            "counterSet": f"gpu-{i}-counter-set",
                            "counters": sets[f"gpu-{i}-counter-set"]}])
                   for dev in driver.state.dra_devices()
                   for i in [parse_gpu_name(dev["name"])]]
        check(all({f"memory-slice-{k}" for k in range(8)} | {"memory"}
                  <= set(c) for c in sets.values())
              and [sets[f"gpu-{parse_gpu_name(d['name'])}-counter-set"][
                  "memory"] for d in devices] == [
                  d["capacity"]["memory"] for d in devices],
              f"counter sets {sets}")
        log(f"node driver: publication over "
            f"{server.url}: {stats}, slice {got['metadata']['name']} "
            f"generation {got['spec']['pool']['generation']}, devices "
            f"{[d['name'] for d in got['spec']['devices']]}, counters "
            f"{json.dumps(got['spec']['sharedCounters'])}")
        check(stats["writes"] == 1 and stats["generation"] == 1
              and [(got["metadata"]["name"], got["spec"])] == [
                  (w["metadata"]["name"], w["spec"]) for w in want]
              and got["spec"]["devices"] == devices, "published slices")
        again = timed("republish", driver.publish_resources)
        check(again["writes"] == 0 and again["deletes"] == 0
              and again["generation"] == 1, f"republish {again}")

        # Health: one NVML poll's taints replace the unmonitored ones.
        lib = load()
        check(isinstance(lib, NvmlLib), f"tpulib.load() gave {lib!r}")
        monitor = ChipHealthMonitor(lib, EnumerateOptions(),
                                    driver._on_health_taints)
        taints = timed("poll", monitor.poll_and_reconcile)
        monitor.stop()
        check(lib._lib is None, "the monitor left NVML open")
        if taints:
            log(f"node driver: the card reports health events {taints}")
        timed("taints", driver._on_health_taints, taints)

        def published_taints():
            return {d["name"]: d.get("taints", [])
                    for d in published()["spec"]["devices"]}

        poll = {name: [t.to_dict() for t in taints if t.device == name]
                for name in driver.state.allocatable}
        check(published_taints() == poll, f"taints {published_taints()}")

        # A fatal taint and its clearing: one PUT each, no new generation;
        # an unchanged set: no request at all.
        fatal = [DeviceTaint("gpu-0", "tpu.dra.dev/chip_lost", "true",
                             "NoExecute")]
        requests = dict(server.requests)
        timed("fatal_taint", driver._on_health_taints, taints + fatal)
        raised = published()
        puts = server.requests["PUT"] - requests.get("PUT", 0)
        count = server.request_count()
        for _ in range(5):
            driver._on_health_taints(taints + fatal)
        steady = server.request_count() - count
        requests = dict(server.requests)
        timed("clear_taint", driver._on_health_taints, taints)
        cleared = server.requests["PUT"] - requests.get("PUT", 0)
        log(f"node driver: fatal taint on gpu-0 {puts} PUT at generation "
            f"{raised['spec']['pool']['generation']}, unchanged x5 "
            f"{steady} requests, cleared {cleared} PUT; requests "
            f"{dict(server.requests)}")
        check(puts == 1 and cleared == 1 and steady == 0
              and raised["spec"]["pool"]["generation"] == 1
              and fatal[0].to_dict() in raised["spec"]["devices"][0]["taints"]
              and published_taints() == poll, "taint flip")

        # A claim for gpu-0, prepared through the API lookup.
        claim = {"metadata": {"uid": "smoke-node-claim", "namespace":
                              "default", "name": "smoke-node-claim"},
                 "status": {"allocation": {
                     "devices": {"results": [
                         {"request": "gpu", "driver": DRIVER_NAME,
                          "pool": NODE, "device": "gpu-0"}], "config": []},
                     "nodeSelector": {"nodeSelectorTerms": [{"matchFields": [
                         {"key": "metadata.name", "operator": "In",
                          "values": [NODE]}]}]}}}}
        kube.create(*RESOURCE_CLAIMS, claim, namespace="default")
        ref = {key: claim["metadata"][key]
               for key in ("uid", "namespace", "name")}
        uid = ref["uid"]
        out = timed("prepare", driver.prepare_resource_claims, [ref])
        check(out == {uid: ([{"request_names": ["gpu"], "pool_name": NODE,
                              "device_name": "gpu-0",
                              "cdi_device_ids": ["nvidia.com/gpu=gpu-0"]}],
                            "")}, f"prepare {out}")
        spec = driver.state._cdi.read_spec(uid)
        mounts = spec["containerEdits"]["mounts"]
        hosts = {os.path.realpath(m["hostPath"]) for m in mounts}
        names = {os.path.basename(m["hostPath"]) for m in mounts}
        log(f"node driver: NVML driver {host.driver_version}; spec mounts "
            + json.dumps([[m["hostPath"], m["containerPath"]]
                          for m in mounts]))
        check(all(os.path.isfile(m["hostPath"]) for m in mounts)
              and {f"libcuda.so.{host.driver_version}",
                   f"libnvidia-ml.so.{host.driver_version}"} <= names,
              "the spec's mounts")

        # The child under the spec's env maps the mounted libraries.
        result = run_claim_child(spec, seed, driver.state.allocatable[
            "gpu-0"].chip.chip.name, "node driver")
        ms["child"] = round(result["seconds"] * 1e3, 3)
        mapped = result["mapped"]
        check(any("libcuda.so" in p for p in mapped)
              and any("libnvidia-ml.so" in p for p in mapped)
              and set(mapped) <= hosts,
              f"the child maps {mapped}, the spec mounts {sorted(hosts)}")

        out = timed("unprepare", driver.unprepare_resource_claims,
                    [{"uid": uid}])
        check(out == {uid: ""} and not driver.state._cdi.spec_exists(uid)
              and uid not in driver.state.prepared_claims(), "unprepare")

        # The sweep reaps a claim the API server no longer has.
        timed("prepare_again", driver.prepare_resource_claims, [ref])
        kube.delete(*RESOURCE_CLAIMS, "smoke-node-claim",
                    namespace="default")
        counts = timed("sweep", driver.reconciler.reconcile_once)
        log(f"node driver: sweep {counts}")
        check(counts["stale_claim"] == 1 and sum(counts.values()) == 1
              and not driver.state._cdi.spec_exists(uid)
              and driver.state.prepared_claims() == {}, "sweep")
        driver.stop()
    finally:
        server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    check(server._thread is None and not any(
        t.name == "fake-apiserver" for t in threading.enumerate()),
        "the server's thread outlived it")
    log(f"node driver: host ms {json.dumps(ms)} (server stopped, its "
        "threads joined)")
    return result["launches"]


# Phase 14's MPS clients: the claim's env applied, each must see one GPU
# of the claim's product name, run the flash forward kernel at the
# serving shape on phase 3's inputs against its plain version (a batch
# row at a time, so the reference's scores fit the memory limit), then
# allocate 4 GiB, which the 8 GiB limit allows, and 12 GiB, which MPS's
# pinned limit refuses.
MPS_CHILD = """
import json, sys
import torch
import chip_smoke as c
from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)

seed, product = int(sys.argv[1]), sys.argv[2]
count, name = torch.cuda.device_count(), torch.cuda.get_device_name(0)
if count != 1 or name != product:
    raise SystemExit(f"MPS child sees {count} devices, {name!r}")
gen = torch.Generator(device="cuda").manual_seed(seed)
q, k, v = c.attention_inputs(gen, "serving", 4, 2048, 32, 8, 128,
                             torch.bfloat16)
flash_attention.launches = 0
got = flash_attention(q, k, v, causal=True)
launches = flash_attention.launches
want = torch.cat([flash_attention_reference(q[i:i + 1], k[i:i + 1],
                                            v[i:i + 1], causal=True)
                  for i in range(q.shape[0])])
atol, rtol = c.TOLERANCES[torch.bfloat16]
diff = (got.float() - want.float()).abs()
result = {"device_count": count, "name": name, "launches": launches,
          "max_abs_err": diff.max().item(),
          "excess": (diff - atol - rtol * want.float().abs()).max().item(),
          "finite": bool(torch.isfinite(got).all())}
del q, k, v, got, want, diff
torch.cuda.empty_cache()
small = torch.empty(4 << 30, dtype=torch.uint8, device="cuda")
small.fill_(1)
torch.cuda.synchronize()
result["alloc_4gib"] = "ok"
del small
torch.cuda.empty_cache()
try:
    big = torch.empty(12 << 30, dtype=torch.uint8, device="cuda")
    result["alloc_12gib"] = "ok"
except torch.OutOfMemoryError as err:
    result["alloc_12gib"] = "OutOfMemoryError: " + str(err).splitlines()[0]
print(json.dumps(result))
"""
# What a client prints when the machine will not run MPS's server.
MPS_CLIENT_REFUSED = "MPS client failed to connect"
# The only reason a server's start may fail for phase 14 to pass: the
# machine refuses MPS's server.
MPS_SERVER_REFUSED = "Failed to start : operation not supported"
PR_SET_CHILD_SUBREAPER = 36  # <linux/prctl.h>


def _timeslice_level(index: int) -> str:
    """GPU ``index``'s timeslice as ``nvidia-smi compute-policy -l``
    lists it (Default, Short, Medium or Long)."""
    import re

    out = subprocess.run(["nvidia-smi", "compute-policy", "-l"],
                         capture_output=True, text=True, timeout=60,
                         check=True).stdout
    for m in re.finditer(r"^\|\s*(\d+)\s+Timeslice\s+(\w+)", out, re.M):
        if int(m.group(1)) == index:
            return m.group(2)
    raise AssertionError(f"no timeslice of GPU {index} in {out!r}")


def phase_sharing(seed: int) -> int:
    """14. Time-slicing and MPS through the kubelet plugin over NVML with
    both sharing gates on: ``gpu-0`` at the Long interval (set and read
    back, or refused by the machine and rolled back), then ``gpu-0``
    under an MPS daemon with two concurrent clients (served, or refused by
    the machine). Returns the clients' flash launches."""
    import ctypes
    import os
    import shutil
    import signal
    import tempfile

    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.cdi import find_binary
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import (
        ResourceClaim)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.device_state import (
        Config, DeviceState, PrepareError)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.sharing import (
        MPS_CONTROL, MPS_SERVER, TIMESLICE_LEVELS, mps_pids)
    from k8s_dra_driver_gpu_tpu_torch.pkg.featuregates import FeatureGates

    ms = {}
    timed = functools.partial(_timed, ms)

    def check(ok, what):
        if not ok:
            raise AssertionError(f"sharing: {what}")

    def claim(uid, sharing):
        return ResourceClaim.from_dict({
            "metadata": {"uid": uid, "namespace": "default", "name": uid},
            "status": {"allocation": {"devices": {
                "results": [{"request": "gpu", "driver": DRIVER_NAME,
                             "pool": "node", "device": "gpu-0"}],
                "config": [{"source": "FromClaim", "requests": [],
                            "opaque": {"driver": DRIVER_NAME, "parameters": {
                                "apiVersion": "resource.nvidia.com/v1beta1",
                                "kind": "GpuConfig",
                                "sharing": sharing}}}]}}}})

    def rolled_back(uid):
        return (uid not in state.prepared_claims()
                and not state._cdi.spec_exists(uid)
                and not state._tenancy._dirs_of(uid))

    def reap_zombies():
        """Reap the dead MPS processes whose parent is this process; the
        pids reaped, and the others' (pid, parent)."""
        reaped, left = [], []
        for pid in filter(str.isdigit, os.listdir("/proc")):
            try:
                with open(f"/proc/{pid}/stat", encoding="utf-8") as f:
                    head, _, tail = f.read().rpartition(")")
            except OSError:
                continue
            state_, ppid = tail.split()[:2]
            if state_ != "Z" or "nvidia-cuda-mps" not in head:
                continue
            if int(ppid) == os.getpid():
                os.waitpid(int(pid), os.WNOHANG)
                reaped.append(int(pid))
            else:
                left.append((int(pid), int(ppid)))
        return reaped, left

    control = find_binary("/", MPS_CONTROL)
    server = find_binary("/", MPS_SERVER)
    level0 = timed("read_level", _timeslice_level, 0)
    before = mps_pids()
    log(f"sharing: {MPS_CONTROL} {control or 'absent'}, {MPS_SERVER} "
        f"{server or 'absent'}; gpu-0's timeslice {level0}; MPS processes "
        f"running before {before}")
    check(not before, "an MPS daemon runs before the phase")
    tmp = tempfile.mkdtemp(prefix="sh")
    state = None
    launches = 0
    # The daemon that MPS's control binary forks off, and its servers,
    # come back to this process when their parent exits, so that it reaps
    # them once they quit.
    prctl = ctypes.CDLL(None, use_errno=True).prctl
    prctl(PR_SET_CHILD_SUBREAPER, 1, 0, 0, 0)
    try:
        state = timed("construct", DeviceState, Config(
            root=f"{tmp}/state", cdi_root=f"{tmp}/cdi",
            feature_gates=FeatureGates.parse(
                "TimeSlicingSettings=true,MultiTenancySupport=true"),
            tenancy_agents=False))

        # Time-slicing: Long, then back to Default; or the machine's
        # refusal, quoted, with nothing left behind.
        ts = claim("smoke-timeslice", {"strategy": "TimeSlicing",
                                       "timeSlicing": {"interval": "Long"}})
        try:
            timed("prepare_long", state.prepare, ts)
            refusal = None
        except PrepareError as err:
            refusal = str(err)
        level = _timeslice_level(0)
        log(f"sharing: prepare at Long: "
            f"{'refused: ' + refusal if refusal else 'set'}; gpu-0 reads "
            f"{level}; record {state._timeslicing.current(0)}")
        if refusal is None:
            check(level == "Long" and state._timeslicing.current(0)[
                "holders"] == {ts.uid: "Long"}, f"Long set, reads {level}")
            timed("unprepare_long", state.unprepare, ts.uid)
            level = _timeslice_level(0)
            check(level == "Default" and state._timeslicing.current(0)
                  is None and rolled_back(ts.uid),
                  f"after unprepare gpu-0 reads {level}")
            log(f"sharing: unprepared: gpu-0 reads {level}")
        else:
            check(("Insufficient Permissions" in refusal
                   or "Not Supported" in refusal)
                  and "compute-policy" in refusal, f"refusal {refusal!r}")
            check(level == level0 and state._timeslicing.current(0) is None
                  and rolled_back(ts.uid), "the refused claim left state")

        # MPS: one daemon for the claim, two clients at once.
        mps = claim("smoke-mps", {"strategy": "MultiTenancy",
                                  "multiTenancy": {"maxClients": 2,
                                                   "hbmLimit": "8Gi"}})
        try:
            timed("prepare_mps", state.prepare, mps)
        except PrepareError as err:
            log(f"sharing: MPS refused at prepare: {err}; "
                f"{state.last_segments}")
            check(MPS_CONTROL in str(err) or "MPS control daemon" in str(err),
                  f"prepare refused {err!r}")
            check(rolled_back(mps.uid) and not mps_pids(),
                  "the refused MPS claim left state")
            return 0
        segments = {k: round(v * 1e3, 3)
                    for k, v in state.last_segments.items()}
        spec = state._cdi.read_spec(mps.uid)
        common = spec["containerEdits"]
        (edits,) = [dd["containerEdits"] for dd in spec["devices"]]
        (d, owner), = state._tenancy._owners().items()
        pipe = state._tenancy.pipe_dir(d)
        daemons = mps_pids(pipe)
        limit = timed("read_limit", state._tenancy.command, mps.uid, "gpu",
                      "get_default_device_pinned_mem_limit 0").strip()
        log(f"sharing: MPS prepared (segments ms {segments}); daemon pids "
            f"{daemons}, {owner}, its limit of device 0 {limit!r}; gpu-0's "
            f"env {edits['env']}, mounts {edits['mounts']}")
        container = f"/var/run/nvidia-mps/{os.path.basename(d)}"
        check(daemons and limit == "8G" and owner["visibleDevices"] == "0"
              and edits["env"] == [
                  f"CUDA_MPS_PIPE_DIRECTORY={container}",
                  "CUDA_MPS_PINNED_DEVICE_MEM_LIMIT=0=8192M"]
              and [(m["hostPath"], m["containerPath"], "rw" in m["options"])
                   for m in edits["mounts"]] == [(pipe, container, True)]
              and not any("MPS" in e for e in common["env"]), "the MPS spec")

        env = dict(os.environ)
        for entry in (e for edit in [dd["containerEdits"]
                                     for dd in spec["devices"]] + [common]
                      for e in edit.get("env", [])):
            key, _, value = entry.partition("=")
            env[key] = value
        # No container: the pipe dir's container path is its host path.
        env["CUDA_MPS_PIPE_DIRECTORY"] = pipe
        product = state.allocatable["gpu-0"].chip.chip.name
        t0 = time.perf_counter()
        children = [subprocess.Popen(
            [sys.executable, "-c", MPS_CHILD, str(seed), product], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for _ in range(2)]
        outs = [child.communicate(timeout=300) for child in children]
        ms["children"] = round((time.perf_counter() - t0) * 1e3, 3)
        servers = timed("server_list", state._tenancy.command, mps.uid,
                        "gpu", "get_server_list").split()
        with open(os.path.join(d, "log", "server.log")) as f:
            server_log = f.read()
        codes = [child.returncode for child in children]
        log(f"sharing: MPS clients exited {codes} in {ms['children']} ms; "
            f"get_server_list {servers}")
        if all(code == 0 for code in codes):
            results = [json.loads(out.strip().splitlines()[-1])
                       for out, _ in outs]
            for result in results:
                log(f"sharing: MPS client {json.dumps(result)}")
                check(result["device_count"] == 1 and result["launches"] == 1
                      and result["finite"] and result["excess"] <= 0
                      and result["max_abs_err"] <= CLAIM_CHILD_MAX_ERR
                      and result["alloc_4gib"] == "ok"
                      and result["alloc_12gib"].startswith(
                          "OutOfMemoryError"), f"MPS client {result}")
            check(servers, "no MPS server served the clients")
            launches = sum(result["launches"] for result in results)
        else:
            # The machine's refusal, not a fault of the daemon's settings:
            # every start failed for its reason, on gpu-0's product.
            lines = server_log.splitlines()
            failed = [line for line in lines if "Failed to start" in line]
            devices = [line for line in lines
                       if "server context on device" in line]
            log(f"sharing: MPS clients refused: "
                f"{[err.strip().splitlines()[-1] for _, err in outs]}; the "
                f"server's log: {devices[:1]} {failed[:1]} ({len(failed)} "
                f"starts failed, {len(lines)} lines)")
            check(all(code != 0 and MPS_CLIENT_REFUSED in err
                      for code, (_, err) in zip(codes, outs)),
                  f"MPS clients {codes}: {[e[-2000:] for _, e in outs]}")
            check(failed and all(line.endswith(MPS_SERVER_REFUSED)
                                 for line in failed),
                  f"the server failed otherwise: {lines[-20:]}")
            check(devices and all(f"device 0 ({product})" in line
                                  for line in devices),
                  f"the server's device is not gpu-0 ({product}): {devices}")

        timed("unprepare_mps", state.unprepare, mps.uid)
        check(rolled_back(mps.uid) and not os.path.exists(d)
              and not mps_pids(), f"after unprepare MPS processes "
              f"{mps_pids()}")
        log(f"sharing: unprepared: no MPS process left, {d} removed")
        return launches
    finally:
        if state is not None:
            for uid in ("smoke-timeslice", "smoke-mps"):
                state._tenancy.stop(uid)
        for pid in _mps_pids_under(f"{tmp}/"):
            log(f"sharing: MPS process {pid} left: killed")
            os.kill(pid, signal.SIGKILL)
        reaped, zombies = reap_zombies()
        prctl(PR_SET_CHILD_SUBREAPER, 0, 0, 0, 0)
        log(f"sharing: MPS processes after the phase: {mps_pids()}; dead "
            f"ones reaped {reaped}, not this process's to reap (pid, "
            f"parent) {zombies}")
        if _timeslice_level(0) != level0:
            subprocess.run(["nvidia-smi", "compute-policy", "-i", "0",
                            f"--set-timeslice={TIMESLICE_LEVELS[level0]}"],
                           check=True, timeout=60)
        shutil.rmtree(tmp, ignore_errors=True)
        log(f"sharing: host ms {json.dumps(ms)}")


# -- helpers of phase 14 and of the plugin children of phases 15-16 ---------
# Those children run as `python -c` scripts; _CHILD_HELPERS hands them
# these functions' source, so each is written once.


def _mps_pids_under(root: str) -> list[int]:
    """The MPS processes whose pipe directory lies under ``root``."""
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.sharing import mps_pids
    found = []
    for pid in mps_pids():
        try:
            with open(f"/proc/{pid}/environ", "rb") as f:
                env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0")
                           if b"=" in kv)
        except OSError:
            continue
        if env.get(b"CUDA_MPS_PIPE_DIRECTORY", b"").startswith(
                root.encode()):
            found.append(pid)
    return found


def _destroy_recorded(lib, registries, pipe_root: str | None = None
                      ) -> list[str]:
    """Kill the MPS processes under ``pipe_root``; destroy every MIG
    instance that ``registries`` name and drop its entry. What went."""
    import os
    import signal
    gone = []
    for pid in _mps_pids_under(pipe_root) if pipe_root else ():
        try:
            os.kill(pid, signal.SIGKILL)
            gone.append(f"mps:{pid}")
        except ProcessLookupError:
            pass
    for registry in registries:
        for uuid, live in registry.list().items():
            lib.destroy_mig(live.instance())
            registry.drop(uuid)
            gone.append(uuid)
    return gone


def _timed(ms: dict, label: str, fn, *args, **kw):
    """``fn(*args, **kw)``, its host ms kept in ``ms[label]``."""
    t0 = time.perf_counter()
    try:
        return fn(*args, **kw)
    finally:
        ms[label] = round((time.perf_counter() - t0) * 1e3, 3)


def _walk(lib) -> list[dict]:
    """GPU 0's MIG instances as NVML walks them."""
    return [i.__dict__ for i in lib.mig_instances(0)]


_CHILD_HELPERS = "import functools, time\n\n" + "\n\n".join(
    inspect.getsource(f)
    for f in (_mps_pids_under, _destroy_recorded, _timed, _walk)) + "\n"


# Phase 15's plugin side, run in a process of its own that never
# initialises CUDA (as the kubelet plugin is; NVML's MIG calls beside
# CUDA are not proven safe, ROADMAP.md §3 item 9): the node service over
# the real NVML with DynamicSubSlice on, split publication over the
# port's fake API server, a claim for gpu-0's 1g.10gb MIG device at
# memory slot 0, and which of the three outcomes the GPU gave. With
# "cleanup" it only destroys what the registry under its root names.
# Writes one JSON line.
MIG_PLUGIN = _CHILD_HELPERS + r"""
import json, os, subprocess, sys
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.device_state import (
    Config, DeviceState, SubSliceRegistry)
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.driver import Driver
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.subslice import (
    parse_mig_name)
from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
from k8s_dra_driver_gpu_tpu_torch.pkg.featuregates import FeatureGates
from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import KubeClient
from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as gpulib

tmp, seed, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
RS = ("resource.k8s.io", "v1", "resourceslices")
RC = ("resource.k8s.io", "v1", "resourceclaims")
NODE, DEVICE, UID = "smoke-mig-node", "gpu-0-mig-1g10gb-0", "smoke-mig"
out = {"cuda_initialised_at_start": gpulib.cuda_initialised()}
lib = gpulib.NvmlLib()
registry = SubSliceRegistry(f"{tmp}/state")


def destroy_recorded():
    return _destroy_recorded(lib, [registry])

if mode == "cleanup":
    try:
        print(json.dumps({"destroyed": destroy_recorded()}))
    finally:
        lib.close()
    raise SystemExit(0)

ms = {}
timed = functools.partial(_timed, ms)
walk = functools.partial(_walk, lib)

server, driver = FakeApiServer().start(), None
try:
    host = lib.enumerate()
    out["mig_mode"] = host.mig_mode
    out["profiles"] = [p.__dict__ for p in lib.subslice_profiles()]
    out["refusals"] = dict(lib.refusals)
    out["caps"] = {
        "/proc/driver/nvidia-caps/mig-minors": os.path.exists(
            "/proc/driver/nvidia-caps/mig-minors"),
        "/dev/nvidia-caps": sorted(os.listdir("/dev/nvidia-caps"))
        if os.path.isdir("/dev/nvidia-caps") else None}
    before = walk()
    out["instances_before"] = before
    kube = KubeClient(host=server.url)
    driver = timed("construct", Driver, Config(
        root=f"{tmp}/state", cdi_root=f"{tmp}/cdi",
        feature_gates=FeatureGates.parse("DynamicSubSlice=true")), kube,
        NODE, enable_health_monitor=False, publication_mode="split")
    state = driver.state
    out["publish"] = timed("publish", driver.publish_resources)
    slices = kube.list(*RS)
    names = [d["name"] for s in slices for d in s["spec"]["devices"]]
    out["slices"] = sorted(s["metadata"]["name"] for s in slices)
    out["published"] = names
    out["mig_published"] = [n for n in names if parse_mig_name(n)]
    sets = {c["name"]: c["counters"] for s in slices
            for c in s["spec"]["sharedCounters"]}
    out["counter_sets"] = {k: sorted(v) for k, v in sets.items()}
    out["counters_whole"] = all(
        d["consumesCounters"] == [{"counterSet": f"{d['name']}-counter-set",
                                   "counters": sets[
                                       f"{d['name']}-counter-set"]}]
        for s in slices for d in s["spec"]["devices"]
        if not parse_mig_name(d["name"]))
    claim = {"metadata": {"uid": UID, "namespace": "default", "name": UID},
             "status": {"allocation": {
                 "devices": {"results": [
                     {"request": "mig", "driver": "gpu.nvidia.com",
                      "pool": NODE, "device": DEVICE}], "config": []},
                 "nodeSelector": {"nodeSelectorTerms": [{"matchFields": [
                     {"key": "metadata.name", "operator": "In",
                      "values": [NODE]}]}]}}}}
    kube.create(*RC, claim, namespace="default")
    ref = {"uid": UID, "namespace": "default", "name": UID}
    (devices, error), = timed("prepare", driver.prepare_resource_claims,
                              [ref]).values()
    out["prepare_error"] = error
    out["prepare_segments_ms"] = {k: round(v * 1e3, 3)
                                  for k, v in state.last_segments.items()}
    out["registry_after_prepare"] = sorted(state.mig_registry())
    out["record_after_prepare"] = UID in state.prepared_claims()
    out["spec_after_prepare"] = state._cdi.spec_exists(UID)
    out["instances_after_prepare"] = walk()
    if not error:
        spec = state._cdi.read_spec(UID)
        live = state.prepared_claims()[UID].devices[0].live
        out["device_nodes"] = [n["path"] for d in spec["devices"]
                               for n in d["containerEdits"]["deviceNodes"]]
        env = dict(os.environ)
        for edit in [d["containerEdits"] for d in spec["devices"]] + [
                spec["containerEdits"]]:
            env.update(e.partition("=")[::2] for e in edit.get("env", []))
        # No container here: the MIG device is named by its UUID.
        env["CUDA_VISIBLE_DEVICES"] = live["uuid"]
        sms = [p["cores"] for p in out["profiles"]
               if p["name"] == "1g.10gb"][0]
        child = subprocess.run(
            [sys.executable, "-c", sys.argv[4], str(seed), str(sms)],
            env=env, capture_output=True, text=True, timeout=600)
        out["child_rc"] = child.returncode
        out["child"] = json.loads(child.stdout.strip().splitlines()[-1]) \
            if child.returncode == 0 else child.stderr[-3000:]
    out["unprepare"] = timed("unprepare", driver.unprepare_resource_claims,
                             [{"uid": UID}])
    out["instances_after_unprepare"] = walk()
    kube.delete(*RC, UID, namespace="default")
    out["sweep"] = timed("sweep", driver.reconciler.reconcile_once)
    out["left"] = {"record": UID in state.prepared_claims(),
                   "spec": state._cdi.spec_exists(UID),
                   "registry": sorted(state.mig_registry()),
                   "instances": walk()}
    try:
        timed("static_construct", DeviceState, Config(
            root=f"{tmp}/static", cdi_root=f"{tmp}/static-cdi",
            static_subslices=(DEVICE,)))
        out["static"] = "constructed"
    except ValueError as err:
        out["static"] = f"ValueError: {err}"
finally:
    out["destroyed_in_finally"] = destroy_recorded()
    if driver is not None:
        driver.stop()
    server.stop()
    lib.close()
out["ms"] = ms
out["cuda_initialised_at_end"] = gpulib.cuda_initialised()
print(json.dumps(out))
"""
# Phase 15's CUDA child under outcome (b): the MIG device alone, with the
# profile's SMs, running the flash forward at the serving shape on phase
# 3's inputs against its plain version, a batch row at a time.
MIG_CUDA_CHILD = """
import json, sys
import torch
import chip_smoke as c
from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
    flash_attention, flash_attention_reference)

seed, sms = int(sys.argv[1]), int(sys.argv[2])
count = torch.cuda.device_count()
props = torch.cuda.get_device_properties(0)
if count != 1 or props.multi_processor_count != sms:
    raise SystemExit(f"MIG child sees {count} devices, "
                     f"{props.multi_processor_count} SMs, {props.name!r}")
gen = torch.Generator(device="cuda").manual_seed(seed)
q, k, v = c.attention_inputs(gen, "serving", 4, 2048, 32, 8, 128,
                             torch.bfloat16)
flash_attention.launches = 0
got = flash_attention(q, k, v, causal=True)
launches = flash_attention.launches
want = torch.cat([flash_attention_reference(q[i:i + 1], k[i:i + 1],
                                            v[i:i + 1], causal=True)
                  for i in range(q.shape[0])])
atol, rtol = c.TOLERANCES[torch.bfloat16]
diff = (got.float() - want.float()).abs()
print(json.dumps({
    "device_count": count, "name": props.name,
    "sms": props.multi_processor_count, "launches": launches,
    "max_abs_err": diff.max().item(),
    "excess": (diff - atol - rtol * want.float().abs()).max().item(),
    "finite": bool(torch.isfinite(got).all())}))
"""


def _mig_outcome(r: dict) -> str:
    """Which of phase 15's three outcomes ``r`` (``MIG_PLUGIN``'s line)
    shows, checked; AssertionError for anything else."""
    def check(ok, what):
        if not ok:
            raise AssertionError(f"mig: {what}: {json.dumps(r)[:4000]}")

    check(not r["cuda_initialised_at_start"]
          and not r["cuda_initialised_at_end"],
          "the plugin's process initialised CUDA")
    left = r["left"]
    check(not left["record"] and not left["spec"] and not left["registry"]
          and not r["destroyed_in_finally"]
          and left["instances"] == r["instances_before"],
          "the claim left state behind")
    check(r["unprepare"] == {"smoke-mig": ""} and r["counters_whole"]
          and r["sweep"]["carveout"] == 0, "unprepare, counters or sweep")
    if r["mig_mode"] != "enabled":
        # (a) MIG off (or its mode refused): nothing published or created
        # that the GPU cannot give.
        check(r["mig_published"] == [] and r["profiles"] == []
              and len(r["slices"]) == 1 and r["counter_sets"]
              and all({f"memory-slice-{k}" for k in range(8)} | {"memory"}
                      <= set(c) for c in r["counter_sets"].values())
              and "unknown device 'gpu-0-mig-1g10gb-0'" in r["prepare_error"]
              and not r["record_after_prepare"]
              and not r["spec_after_prepare"]
              and r["registry_after_prepare"] == []
              and "prep_create_subslice" not in r["prepare_segments_ms"]
              and r["static"].startswith("ValueError: static MIG device "
                                         "'gpu-0-mig-1g10gb-0'"),
              "outcome (a)")
        return "a"
    check("gpu-0-mig-1g10gb-0" in r["mig_published"]
          and len(r["slices"]) == 2, "MIG on: the MIG devices' slice")
    if r["prepare_error"]:
        # (c) MIG on, creation refused: NVML's return code quoted, the
        # rollback leaves nothing.
        check("NVML_ERROR_" in r["prepare_error"]
              and not r["record_after_prepare"]
              and not r["spec_after_prepare"]
              and r["registry_after_prepare"] == []
              and r["instances_after_prepare"] == r["instances_before"],
              "outcome (c)")
        return "c"
    # (b) MIG on, creation allowed.
    made = [i for i in r["instances_after_prepare"]
            if i not in r["instances_before"]]
    child = r["child"]
    check(len(made) == 1 and made[0]["profile"] == "1g.10gb"
          and made[0]["start"] == 0 and r["child_rc"] == 0
          and child["launches"] == 1 and child["finite"]
          and child["excess"] <= 0
          and child["max_abs_err"] <= CLAIM_CHILD_MAX_ERR
          and "prep_create_subslice" in r["prepare_segments_ms"]
          and r["instances_after_unprepare"] == r["instances_before"],
          "outcome (b)")
    return "b"


def phase_mig(seed: int) -> int:
    """15. MIG devices through the kubelet plugin over NVML, in a child
    that never initialises CUDA (``MIG_PLUGIN``). Checks which of three
    outcomes holds: (a) MIG off, (b) MIG on and a 1g.10gb instance
    created, run and destroyed, (c) MIG on and its creation refused.
    Never changes the MIG mode. Returns the flash launches of (b)'s
    child, 0 otherwise."""
    import os
    import shutil
    import tempfile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=index,mig.mode.current,mig.mode.pending",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    log(f"mig: nvidia-smi mig.mode.current,pending: "
        f"{(smi.stdout or smi.stderr).strip()!r} (rc {smi.returncode})")
    tmp = tempfile.mkdtemp(prefix="mig")
    root = os.path.dirname(os.path.abspath(__file__))
    r = None
    try:
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", MIG_PLUGIN, tmp, str(seed), "run",
             MIG_CUDA_CHILD], capture_output=True, text=True, timeout=900,
            cwd=root)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError(f"mig: the plugin child exited "
                                 f"{child.returncode}: "
                                 f"{child.stderr[-4000:]}")
        r = json.loads(child.stdout.strip().splitlines()[-1])
    finally:
        # A child that failed: whatever its registry still names is
        # destroyed by a child of its own (no MIG call in this CUDA
        # process).
        if r is None and os.path.exists(f"{tmp}/state/mig.json"):
            done = subprocess.run(
                [sys.executable, "-c", MIG_PLUGIN, tmp, str(seed),
                 "cleanup"], capture_output=True, text=True, timeout=300,
                cwd=root)
            log(f"mig: cleanup child rc {done.returncode}: "
                f"{(done.stdout + done.stderr).strip()[-2000:]}")
        shutil.rmtree(tmp, ignore_errors=True)
    outcome = _mig_outcome(r)
    log(f"mig: outcome ({outcome}); NVML mig_mode {r['mig_mode']!r}, "
        f"profiles {len(r['profiles'])}, refusals {r['refusals']}; caps "
        f"{json.dumps(r['caps'])}; slices {r['slices']}, MIG devices "
        f"published {len(r['mig_published'])}, counter sets "
        f"{json.dumps(r['counter_sets'])}; prepare of gpu-0-mig-1g10gb-0: "
        f"{r['prepare_error'] or 'prepared'} (segments ms "
        f"{r['prepare_segments_ms']}); static: {r['static']}; sweep "
        f"{r['sweep']}; child {r.get('child')}")
    log(f"mig: host ms {json.dumps(r['ms'])} (plugin child "
        f"{child_s:.2f} s of process)")
    return r["child"]["launches"] if outcome == "b" else 0


PARTITION_PLUGIN = _CHILD_HELPERS + r"""
import json, os, subprocess, sys, time
from k8s_dra_driver_gpu_tpu_torch.api.decode import API_VERSION
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import ResourceClaim
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.device_state import (
    Config, DeviceState, PrepareError, SubSliceRegistry)
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.driver import Driver
from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
from k8s_dra_driver_gpu_tpu_torch.pkg.featuregates import FeatureGates
from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import KubeClient
from k8s_dra_driver_gpu_tpu_torch.pkg.partition import (PartitionSet,
                                                        PartitionSpecError)
from k8s_dra_driver_gpu_tpu_torch.pkg.partition import watch as pwatch
from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as gpulib

tmp, seed, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
RS = ("resource.k8s.io", "v1", "resourceslices")
CRD = (pwatch.CRD_GROUP, pwatch.CRD_VERSION, pwatch.CRD_RESOURCE)
NODE, DEVICE = "smoke-partition-node", "pt-s2-0"
GATES = ("DynamicSubSlice=true,TenantPartitioning=true,"
         "TimeSlicingSettings=true,MultiTenancySupport=true")
PROFILES = [{"name": "x1", "subslice": "1g.10gb", "maxTenants": 1},
            {"name": "s2", "subslice": "1g.10gb", "maxTenants": 2,
             "hbmFraction": 0.9}]
out = {"cuda_initialised_at_start": gpulib.cuda_initialised()}
lib = gpulib.NvmlLib()
registries = [SubSliceRegistry(f"{tmp}/{sub}") for sub in ("state", "watch")]

def ours():
    return _mps_pids_under(f"{tmp}/")

def destroy_recorded():
    return _destroy_recorded(lib, registries, f"{tmp}/")

if mode == "cleanup":
    try:
        print(json.dumps({"destroyed": destroy_recorded()}))
    finally:
        lib.close()
    raise SystemExit(0)

ms = {}
timed = functools.partial(_timed, ms)
walk = functools.partial(_walk, lib)

def claim(uid):
    return ResourceClaim.from_dict({
        "metadata": {"uid": uid, "namespace": "default", "name": uid},
        "status": {"allocation": {"devices": {
            "results": [{"request": "tenant", "driver": "gpu.nvidia.com",
                         "pool": NODE, "device": DEVICE}],
            "config": [{"source": "FromClaim", "opaque": {
                "driver": "gpu.nvidia.com", "parameters": {
                    "apiVersion": API_VERSION, "kind": "MigDeviceConfig",
                    "oversubscribe": True}}}]}}}})

def writes(server):
    return sum(server.requests[m] for m in ("POST", "PUT", "PATCH",
                                            "DELETE"))

server, driver, state = None, None, None
try:
    host = lib.enumerate()
    out["mig_mode"] = host.mig_mode
    out["instances_before"] = walk()
    # -- the partition path on DeviceState --------------------------------
    try:
        state = timed("construct", DeviceState, Config(
            root=f"{tmp}/state", cdi_root=f"{tmp}/cdi",
            feature_gates=FeatureGates.parse(GATES),
            partition_set=PartitionSet.from_dict({"profiles": PROFILES})))
        out["construct_error"] = ""
    except PartitionSpecError as err:
        out["construct_error"] = str(err)
    if state is not None:
        out["partitions"] = sorted(n for n in state.allocatable
                                   if n.startswith("pt-"))
        info = state.allocatable[DEVICE].partition
        out["budget_bytes"] = info.tenant_memory_bytes
        out["prepare"], out["segments_ms"], out["children"] = {}, {}, {}
        for uid in ("tenant-1", "tenant-2"):
            try:
                timed(f"prepare_{uid}", state.prepare, claim(uid))
                out["prepare"][uid] = ""
            except PrepareError as err:
                out["prepare"][uid] = str(err)
            out["segments_ms"][uid] = {
                k: round(v * 1e3, 3) for k, v in state.last_segments.items()}
            if out["prepare"][uid]:
                break
        out["instances_prepared"] = walk()
        out["daemons_prepared"] = len(ours())
        out["records_prepared"] = {
            n: r.state for n, r in state.partition_engine.records().items()}
        if len(out["prepare"]) == 2 and all(
                not e for e in out["prepare"].values()):
            live = state.prepared_claims()["tenant-1"].devices[0].live
            for uid in ("tenant-1", "tenant-2"):
                spec = state._cdi.read_spec(uid)
                edits = spec["devices"][0]["containerEdits"]
                env = dict(os.environ)
                for e in edits.get("env", []) + spec.get(
                        "containerEdits", {}).get("env", []):
                    k, _, v = e.partition("=")
                    env[k] = v
                # No container here: the pipe directory at its host path,
                # the MIG device named by its UUID.
                for m in edits.get("mounts", []):
                    if m["containerPath"] == env["CUDA_MPS_PIPE_DIRECTORY"]:
                        env["CUDA_MPS_PIPE_DIRECTORY"] = m["hostPath"]
                env["CUDA_VISIBLE_DEVICES"] = live["uuid"]
                child = subprocess.run(
                    [sys.executable, "-c", sys.argv[4], str(seed),
                     str(info.mig.cores)], env=env, capture_output=True,
                    text=True, timeout=600)
                out["children"][uid] = json.loads(
                    child.stdout.strip().splitlines()[-1])                     if child.returncode == 0 else {
                        "rc": child.returncode,
                        "stderr": child.stderr[-3000:]}
                out.setdefault("pinned_limits", []).append(
                    env.get("CUDA_MPS_PINNED_DEVICE_MEM_LIMIT"))
        out["unprepare"] = {}
        for uid in ("tenant-1", "tenant-2"):
            try:
                timed(f"unprepare_{uid}", state.unprepare, uid)
                out["unprepare"][uid] = ""
            except PrepareError as err:
                out["unprepare"][uid] = str(err)
            out.setdefault("instances_unprepared", []).append(len(walk()))
        # A refused create leaves its Creating record to the sweep's
        # idle-partition pass, as the JAX plugin does.
        out["reaped"] = timed("reap_idle", state.partition_engine.reap_idle)
        out["daemons_left"] = len(ours())
        out["left"] = {"records": sorted(state.partition_engine.records()),
                       "claims": sorted(state.prepared_claims()),
                       "registry": sorted(state.mig_registry())}
    # -- the watch over HTTP ----------------------------------------------
    server = FakeApiServer(keepalive=0.5).start()
    kube = KubeClient(host=server.url)
    cfg = Config(root=f"{tmp}/watch", cdi_root=f"{tmp}/watch-cdi",
                 feature_gates=FeatureGates.parse(GATES),
                 partition_set=PartitionSet.from_dict({
                     "profiles": PROFILES, "pools": ["no-such-pool-*"]}),
                 pool_name=NODE)
    driver = timed("driver_construct", Driver, cfg, kube, NODE,
                   enable_health_monitor=False, publication_mode="split")
    timed("driver_start", driver.start)
    watcher = driver.partition_watcher
    def published():
        return sorted(d["name"] for s in kube.list(*RS)
                      for d in s["spec"]["devices"]
                      if d["name"].startswith("pt-"))
    w = {"published_before": published(), "requests_before":
         dict(server.requests)}
    base = writes(server)
    for step in ("create", "delete"):
        n, t0 = watcher.reconciles, time.perf_counter()
        if step == "create":
            server.store.create(*CRD, pwatch.crd_object(
                "smoke-partitions", PartitionSet.from_dict({
                    "profiles": PROFILES, "pools": [NODE]})))
        else:
            server.store.delete(*CRD, "smoke-partitions")
        decided = watcher.wait_for(lambda: watcher.reconciles > n, 30)
        ms[f"watch_{step}_to_decision"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        w[step] = {"decided": decided, "last_error": watcher.last_error,
                   "failed_total": watcher.failed_total,
                   "applied_total": watcher.applied_total,
                   "writes": writes(server) - base,
                   "published": published()}
        base = writes(server)
    w["sweep"] = timed("sweep", driver.reconciler.reconcile_once)
    w["requests"] = dict(server.requests)
    out["watch"] = w
finally:
    if driver is not None:
        driver.stop()
    if server is not None:
        server.stop()
    if state is not None:
        state.close()
    out["destroyed_in_finally"] = destroy_recorded()
    out["instances_after"] = walk()
    lib.close()
out["ms"] = ms
out["cuda_initialised_at_end"] = gpulib.cuda_initialised()
print(json.dumps(out))
"""


def _partition_outcome(r: dict) -> str:
    """Which of phase 16's three outcomes ``r`` (``PARTITION_PLUGIN``'s
    line) shows, checked; AssertionError for anything else."""
    def check(ok, what):
        if not ok:
            raise AssertionError(f"partitions: {what}: "
                                 f"{json.dumps(r)[:4000]}")

    check(not r["cuda_initialised_at_start"]
          and not r["cuda_initialised_at_end"],
          "the plugin's process initialised CUDA")
    check(not r["destroyed_in_finally"]
          and r["instances_after"] == r["instances_before"],
          "the phase left state behind")
    w = r["watch"]
    check(w["published_before"] == [] and w["create"]["decided"]
          and w["delete"]["decided"] and w["sweep"]["idle_partition"] == 0,
          "the watch")
    if r["construct_error"]:
        # (a) MIG off: the set and the CRD refused, nothing written.
        check(r["mig_mode"] != "enabled"
              and "'1g.10gb' is no carve-out of this host"
              in r["construct_error"], "outcome (a): construction")
        c, d = w["create"], w["delete"]
        check("'1g.10gb' is no carve-out of this host"
              in (c["last_error"] or "") and c["failed_total"] == 1
              and c["applied_total"] == 0 and c["writes"] == 0
              and c["published"] == [] and d["last_error"] is None
              and d["failed_total"] == 1 and d["applied_total"] == 0
              and d["writes"] == 0 and d["published"] == [],
              "outcome (a): the watch")
        return "a"
    check(r["mig_mode"] == "enabled" and r["partitions"]
          and r["left"] == {"records": [], "claims": [], "registry": []}
          and r["daemons_left"] == 0
          and all(not e for e in r["unprepare"].values()),
          "MIG on: the partitions and their teardown")
    c, d = w["create"], w["delete"]
    check(c["applied_total"] == 1 and c["writes"] >= 1 and c["published"]
          and d["applied_total"] == 2 and d["published"] == [],
          "MIG on: the watch")
    errors = [e for e in r["prepare"].values() if e]
    if errors:
        # (c) MIG on, the create or the MPS daemon refused: rolled back.
        check(r["instances_prepared"] == r["instances_before"]
              and r["daemons_prepared"] == 0
              and r["records_prepared"] in (
                  {}, {"pt-s2-0": "PartitionCreating"})
              and r["reaped"] == len(r["records_prepared"]),
              "outcome (c)")
        return "c"
    made = [i for i in r["instances_prepared"]
            if i not in r["instances_before"]]
    budget = r["budget_bytes"] >> 20
    check(len(made) == 1 and made[0]["profile"] == "1g.10gb"
          and made[0]["start"] == 0 and r["daemons_prepared"] == 1
          and r["pinned_limits"] == [f"0={budget}M"] * 2
          and all(ch.get("launches") == 1 and ch["finite"]
                  and ch["excess"] <= 0
                  and ch["max_abs_err"] <= CLAIM_CHILD_MAX_ERR
                  for ch in r["children"].values())
          and r["instances_unprepared"][0] == len(r["instances_before"]) + 1
          and r["instances_unprepared"][1] == len(r["instances_before"])
          and r["reaped"] == 0
          and all("prep_attach_partition" in s
                  for s in r["segments_ms"].values()), "outcome (b)")
    return "b"


def phase_partitions(seed: int) -> int:
    """16. Tenant partitions over MIG instances through the kubelet
    plugin over NVML, and the PartitionSet watch over HTTP, in a child
    that never initialises CUDA (``PARTITION_PLUGIN``). Checks which of
    three outcomes holds: (a) MIG off, (b) MIG on and MPS served, (c) MIG
    on and the create or MPS refused. Never changes the MIG mode.
    Returns the flash launches of (b)'s tenant children, 0 otherwise."""
    import os
    import shutil
    import tempfile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = (smi.stdout or smi.stderr).strip().splitlines()[0]
    # Short: the MPS pipe paths under it end within AF_UNIX's 108 bytes.
    tmp = tempfile.mkdtemp(prefix="pt")
    root = os.path.dirname(os.path.abspath(__file__))
    r = None
    try:
        t0 = time.perf_counter()
        child = subprocess.run(
            [sys.executable, "-c", PARTITION_PLUGIN, tmp, str(seed), "run",
             MIG_CUDA_CHILD], capture_output=True, text=True, timeout=900,
            cwd=root)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            raise AssertionError(f"partitions: the plugin child exited "
                                 f"{child.returncode}: "
                                 f"{child.stderr[-4000:]}")
        r = json.loads(child.stdout.strip().splitlines()[-1])
    finally:
        if r is None:
            done = subprocess.run(
                [sys.executable, "-c", PARTITION_PLUGIN, tmp, str(seed),
                 "cleanup"], capture_output=True, text=True, timeout=300,
                cwd=root)
            log(f"partitions: cleanup child rc {done.returncode}: "
                f"{(done.stdout + done.stderr).strip()[-2000:]}")
        shutil.rmtree(tmp, ignore_errors=True)
    outcome = _partition_outcome(r)
    w = r["watch"]
    for step in ("create", "delete"):
        w[step]["published"] = len(w[step]["published"])
    log(f"partitions: outcome ({outcome}); NVML mig_mode "
        f"{r['mig_mode']!r}; construction: "
        f"{r['construct_error'] or str(len(r['partitions'])) + ' partitions'}"
        f"; prepare {r.get('prepare')} (segments ms {r.get('segments_ms')})"
        f"; children {r.get('children')}; Creating records reaped "
        f"{r.get('reaped')}")
    log(f"partitions: watch over HTTP (partition devices published as "
        f"counts): CRD create -> {json.dumps(w['create'])}; delete -> "
        f"{json.dumps(w['delete'])}; requests {w['requests']}; sweep "
        f"{w['sweep']}")
    log(f"partitions: host ms {json.dumps(r['ms'])} (plugin child "
        f"{child_s:.2f} s of process) on {card}")
    return sum(ch.get("launches", 0) for ch in r["children"].values()) \
        if outcome == "b" else 0


def _elf_interpreter(path: str) -> str | None:
    """The program interpreter an ELF file asks for (its ``PT_INTERP``),
    None for a static binary."""
    import struct

    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"\x7fELF" or data[4] != 2:
        raise ValueError(f"{path} is no 64-bit ELF file")
    end = "<" if data[5] == 1 else ">"
    phoff, = struct.unpack_from(end + "Q", data, 32)
    phentsize, phnum = struct.unpack_from(end + "HH", data, 54)
    for i in range(phnum):
        base = phoff + i * phentsize
        p_type, = struct.unpack_from(end + "I", data, base)
        if p_type == 3:  # PT_INTERP
            offset, = struct.unpack_from(end + "Q", data, base + 8)
            size, = struct.unpack_from(end + "Q", data, base + 32)
            return data[offset:offset + size].rstrip(b"\0").decode()
    return None


def _agent_pids_under(root: str) -> list[int]:
    """The live tenancy agents whose directory lies under ``root``."""
    import os

    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.sharing import (
        AGENT_MODULE, _alive)
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().decode(errors="replace").split("\0")
        except OSError:
            continue
        if AGENT_MODULE in argv and any(a.startswith(root) for a in argv) \
                and _alive(int(pid)):
            found.append(int(pid))
    return found


def phase_tenancy(seed: int) -> int:
    """17. Tenancy admission through the kubelet plugin's agents and its
    native preflight hook, over NVML. Returns the flash launches of the
    admitted client's child (0 where the machine refuses MPS's server)."""
    import os
    import shutil
    import signal
    import tempfile

    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import (DRIVER_NAME,
                                                            native_hook)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import (
        ResourceClaim)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.device_state import (
        Config, DeviceState, PrepareError)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.sharing import (
        MPS_CONTROL, _alive, mps_pids)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.tenancy_agent import (
        query)
    from k8s_dra_driver_gpu_tpu_torch.pkg.featuregates import FeatureGates

    ms = {}
    timed = functools.partial(_timed, ms)

    def check(ok, what):
        if not ok:
            raise AssertionError(f"tenancy: {what}")

    def claim(uid, multi_tenancy):
        return ResourceClaim.from_dict({
            "metadata": {"uid": uid, "namespace": "default", "name": uid},
            "status": {"allocation": {"devices": {
                "results": [{"request": "gpu", "driver": DRIVER_NAME,
                             "pool": "node", "device": "gpu-0"}],
                "config": [{"source": "FromClaim", "requests": [],
                            "opaque": {"driver": DRIVER_NAME, "parameters": {
                                "apiVersion": "resource.nvidia.com/v1beta1",
                                "kind": "GpuConfig", "sharing": {
                                    "strategy": "MultiTenancy",
                                    "multiTenancy": multi_tenancy}}}}]}}}})

    def config(sub, agents=True):
        return Config(root=f"{tmp}/{sub}", cdi_root=f"{tmp}/{sub}-cdi",
                      feature_gates=FeatureGates.parse(
                          "TimeSlicingSettings=true,MultiTenancySupport=true"),
                      tenancy_agents=agents)

    def hooks(state, uid):
        spec = state._cdi.read_spec(uid)
        (edits,) = [d["containerEdits"] for d in spec["devices"]]
        return spec, edits, {h["hookName"]: h for h in edits["hooks"]}

    def run(hook, cid, label=None):
        """``hook`` as a runtime runs it, the OCI state on stdin."""
        t0 = time.perf_counter()
        out = subprocess.run(
            [hook["path"], *hook["args"][1:]], input=json.dumps({
                "ociVersion": "1.0.2", "id": cid, "status": "creating",
                "pid": os.getpid(), "bundle": tmp}),
            capture_output=True, text=True, timeout=hook["timeout"])
        if label:
            ms[label] = round((time.perf_counter() - t0) * 1e3, 3)
        return out.returncode, out.stderr.strip()

    def agent_pid(d):
        with open(os.path.join(d, "agent.pid")) as f:
            return int(f.read())

    def wait_ready(d, timeout=30.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                if query(d, "STATUS") == "READY":
                    return True
            except OSError:
                pass
            time.sleep(0.005)
        return False

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = (smi.stdout or smi.stderr).strip().splitlines()[0]
    # Short: the agents' sockets and the MPS pipes under it fit AF_UNIX.
    tmp = tempfile.mkdtemp(prefix="tn")
    states = []
    launches = 0
    try:
        built = timed("build", native_hook.build)
        interp = _elf_interpreter(built.path)
        log(f"tenancy: hook built by {built.compiler} "
            f"{' '.join(built.flags)} in {built.seconds:.3f} s: "
            f"{'static' if interp is None else 'dynamic, ' + interp}, "
            f"{os.path.getsize(built.path)} bytes"
            + (f"; the compiler said: {built.log.strip()}"
               if built.log.strip() else ""))
        check(interp is None, f"the hook is not static ({interp})")

        # Without agents: the MPS prepare as phase 14 runs it.
        plain = DeviceState(config("plain", agents=False))
        states.append(plain)
        mt = {"maxClients": 1, "hbmLimit": "8Gi"}
        try:
            timed("prepare_without_agent", plain.prepare,
                  claim("smoke-plain", mt))
        except PrepareError as err:
            # No MPS here: the refusal and its rollback, as phase 14.
            log(f"tenancy: MPS refused at prepare: {err}")
            check(MPS_CONTROL in str(err) or "MPS control daemon" in str(err),
                  f"prepare refused {err!r}")
            check(not _mps_pids_under(f"{tmp}/"),
                  "the refused claim left a daemon")
            return 0
        timed("unprepare_without_agent", plain.unprepare, "smoke-plain")
        plain.close()

        state = timed("construct", DeviceState, config("state"))
        states.append(state)
        check(state._tenancy._spawn, "the agents are off")
        # Memory: no client cap; a second 48 GiB client would pass the
        # GPU's memory.
        capacity = state.host.memory_bytes_per_chip
        limit = 48 << 30
        timed("prepare_memory_claim", state.prepare,
              claim("smoke-memory", {"hbmLimit": "48Gi"}))
        _, _, mem_hooks = hooks(state, "smoke-memory")
        first = run(mem_hooks["createContainer"], "ctr-m1")
        over = run(mem_hooks["createContainer"], "ctr-m2")
        want = (f"tenancy-preflight: DENIED HBM budget exceeded: {limit} "
                f"requested, {capacity - limit} available")
        log(f"tenancy: no client cap, 48Gi: ctr-m1 {first}, ctr-m2 {over} "
            f"(the GPU's memory {capacity} bytes)")
        check(first == (0, "") and over == (1, want), "the memory budget")
        timed("unprepare_memory_claim", state.unprepare, "smoke-memory")

        # The client cap.
        uid = "smoke-tenancy"
        timed("prepare_with_agent", state.prepare, claim(uid, mt))
        segments = {k: round(v * 1e3, 3)
                    for k, v in state.last_segments.items()}
        d = state._tenancy.agent_dir(uid, "gpu")
        spec, edits, h = hooks(state, uid)
        pid = agent_pid(d)
        log(f"tenancy: prepared with its agent (pid {pid}; segments ms "
            f"{segments}); hooks {json.dumps(edits['hooks'])}")
        check(_agent_pids_under(tmp) == [pid]
              and h["createContainer"]["args"][1:] == [
                  "--dir", d, "--hbm-bytes", str(8 << 30)]
              and h["poststop"]["args"][1:] == ["--dir", d, "--release"]
              and not any(m["hostPath"].startswith(os.path.dirname(d))
                          for m in edits["mounts"]), "the spec's hooks")
        steps = [("ctr-a", "createContainer", (0, "")),
                 ("ctr-b", "createContainer",
                  (1, "tenancy-preflight: DENIED max clients (1) reached")),
                 ("ctr-a", "poststop", (0, "")),
                 ("ctr-b", "createContainer", (0, ""))]
        for i, (cid, name, want) in enumerate(steps):
            got = run(h[name], cid, f"hook_{i}_{name}_{cid}")
            log(f"tenancy: {name} {cid}: exit {got[0]} {got[1]!r}")
            check(got == want, f"{name} {cid} gave {got}, not {want}")
        check(json.loads(query(d, "MEMBERS"))["clients"] == {
            "ctr-b": 8 << 30}, "the members after the steps")
        # One round trip each: a release of an id the agent does not hold.
        run(h["poststop"], "probe", "hook_round_trip_native")
        t0 = time.perf_counter()
        py = subprocess.run(
            [sys.executable, "-m",
             "k8s_dra_driver_gpu_tpu_torch.kubeletplugin.tenancy_preflight",
             "--dir", d, "--release", "--client-id", "probe"],
            capture_output=True, text=True, timeout=60,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        ms["hook_round_trip_python"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        check(py.returncode == 0, f"the Python hook: {py.stderr}")

        # ctr-b's client under the spec's env, as phase 14's.
        env = dict(os.environ)
        for entry in edits.get("env", []) + spec.get(
                "containerEdits", {}).get("env", []):
            key, _, value = entry.partition("=")
            env[key] = value
        pipe = edits["mounts"][0]["hostPath"]
        env["CUDA_MPS_PIPE_DIRECTORY"] = pipe
        product = state.allocatable["gpu-0"].chip.chip.name
        child = timed("client_child", subprocess.run,
                      [sys.executable, "-c", MPS_CHILD, str(seed), product],
                      env=env, capture_output=True, text=True, timeout=300)
        if child.returncode == 0:
            result = json.loads(child.stdout.strip().splitlines()[-1])
            log(f"tenancy: ctr-b's client {json.dumps(result)}")
            check(result["device_count"] == 1 and result["launches"] == 1
                  and result["finite"] and result["excess"] <= 0
                  and result["max_abs_err"] <= CLAIM_CHILD_MAX_ERR,
                  f"ctr-b's client {result}")
            launches = result["launches"]
        else:
            with open(os.path.join(os.path.dirname(pipe), "log",
                                   "server.log")) as f:
                failed = [line for line in f if "Failed to start" in line]
            log(f"tenancy: ctr-b's client refused by MPS: "
                f"{child.stderr.strip().splitlines()[-1]}; the server: "
                f"{failed[:1]} ({len(failed)} starts failed)")
            check(MPS_CLIENT_REFUSED in child.stderr and failed and all(
                line.rstrip().endswith(MPS_SERVER_REFUSED)
                for line in failed), f"the client: {child.stderr[-2000:]}")

        # The watchdog.
        t0 = time.perf_counter()
        os.kill(pid, signal.SIGKILL)
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and (
                _agent_pids_under(tmp) in ([], [pid])):
            time.sleep(0.005)
        check(wait_ready(d), "the agent was not respawned")
        ms["respawn"] = round((time.perf_counter() - t0) * 1e3, 3)
        respawned = agent_pid(d)
        members = json.loads(query(d, "MEMBERS"))["clients"]
        log(f"tenancy: SIGKILLed agent {pid}; respawned as {respawned}; "
            f"members {members}")
        check(respawned != pid and members == {"ctr-b": 8 << 30},
              "the respawn")

        # A plugin restart re-owns it.
        timed("close", state.close)
        check(not _agent_pids_under(tmp), "close() left an agent")
        state = timed("reown", DeviceState, config("state"))
        states.append(state)
        reowned = agent_pid(d)
        members = json.loads(query(d, "MEMBERS"))["clients"]
        log(f"tenancy: restarted plugin re-owned the agent as {reowned}; "
            f"members {members}")
        check(_agent_pids_under(tmp) == [reowned]
              and state._tenancy.agent_count() == 1
              and members == {"ctr-b": 8 << 30}, "the re-own")

        timed("unprepare_with_agent", state.unprepare, uid)
        left = {"agents": _agent_pids_under(tmp),
                "pidfile_pid_alive": _alive(reowned),
                "agent_dirs": os.listdir(f"{tmp}/state/tenancy"),
                "socket": os.path.exists(f"{d}/agent.sock"),
                "mps": _mps_pids_under(f"{tmp}/")}
        log(f"tenancy: unprepared; left {left}")
        check(left == {"agents": [], "pidfile_pid_alive": False,
                       "agent_dirs": [], "socket": False, "mps": []},
              "unprepare left state behind")
        return launches
    finally:
        for state in states:
            state.close()
        for pid in _agent_pids_under(tmp) + _mps_pids_under(f"{tmp}/"):
            log(f"tenancy: process {pid} left: killed")
            os.kill(pid, signal.SIGKILL)
        shutil.rmtree(tmp, ignore_errors=True)
        log(f"tenancy: host ms {json.dumps(ms)} on {card}; MPS processes "
            f"after the phase {mps_pids()}")


def span_tree(spans: list[dict], root: dict) -> list[str]:
    """``root`` and its descendants among ``spans`` (the exporter's
    dicts), one line a span: its name and ms, indented by depth, in start
    order."""
    children = collections.defaultdict(list)
    for sp in spans:
        children[sp["parent_id"]].append(sp)
    lines = []

    def walk(sp, depth):
        lines.append(f"{'  ' * depth}{sp['name']} {sp['duration_ms']} ms")
        for child in sorted(children[sp["span_id"]],
                            key=lambda c: c["start"]):
            walk(child, depth + 1)
    walk(root, 0)
    return lines


# Phase 18's child: ``train.verify`` as a gang of one from the channel
# claim's ``TPU_*`` env alone (it prints its own JSON line), then phase
# 12's flash forward check, whose JSON line comes last.
CD_CHILD = """
import sys
from k8s_dra_driver_gpu_tpu_torch.train import verify
rc = verify.run(["--require-gang", "--steps", "2"])
if rc:
    raise SystemExit(f"train.verify exited {rc}")
""" + CLAIM_CHILD
CD_NODE = "smoke-cd-node"
CD_NODE_B = "smoke-cd-node-b"
CD_READY_TIMEOUT_S = 60.0
# The gang deadline of the domain whose second node never comes.
CD_ABORT_DEADLINE_S = 1.0


def phase_compute_domain(seed: int) -> int:
    """18. A ComputeDomain gang of one through the port's controller,
    daemon and CD plugin. Returns the channel child's flash launches."""
    import os
    import shutil
    import signal
    import tempfile

    from k8s_dra_driver_gpu_tpu_torch import entry as pt_entry
    from k8s_dra_driver_gpu_tpu_torch.api.decode import API_VERSION
    from k8s_dra_driver_gpu_tpu_torch.computedomain import (
        API_GROUP, API_VERSION as CD_VERSION, COMPUTE_DOMAIN_DRIVER_NAME,
        FINALIZER, NODE_LABEL)
    from k8s_dra_driver_gpu_tpu_torch.computedomain.controller.controller import (
        ComputeDomainController)
    from k8s_dra_driver_gpu_tpu_torch.computedomain.daemon.process import _gone
    from k8s_dra_driver_gpu_tpu_torch.computedomain.daemon.rendezvous import (
        query)
    from k8s_dra_driver_gpu_tpu_torch.computedomain.plugin.device_state import (
        DOMAIN_STATE_ROOT, CDDeviceState)
    from k8s_dra_driver_gpu_tpu_torch.computedomain.plugin.driver import (
        CDDriver)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import (
        ResourceClaim)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.device_state import (
        Config, DeviceState)
    from k8s_dra_driver_gpu_tpu_torch.pkg import flightrecorder, tracing
    from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
    from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import KubeClient

    ms = {}
    timed = functools.partial(_timed, ms)
    root = os.path.dirname(os.path.abspath(__file__))
    # This phase's spans and flight events, apart from other phases'.
    exporter_before = tracing.exporter()
    recorder_before = flightrecorder.default()
    exporter = tracing.set_exporter(tracing.TraceExporter())
    recorder = flightrecorder.set_default(flightrecorder.FlightRecorder())
    cds = (API_GROUP, CD_VERSION, "computedomains")
    cliques = (API_GROUP, CD_VERSION, "computedomaincliques")
    claims = ("resource.k8s.io", "v1", "resourceclaims")

    def check(ok, what):
        if not ok:
            raise AssertionError(f"compute domain: {what}")

    def wait(fn, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            value = fn()
            if value:
                return value
            time.sleep(0.01)
        raise AssertionError(f"compute domain: timed out waiting for {what}")

    def answer(port):
        try:
            return query("127.0.0.1", port, "STATUS", timeout=2.0)
        except OSError:
            return ""

    def make_cd(name, num_nodes):
        return kube.create(*cds, {
            "apiVersion": f"{API_GROUP}/{CD_VERSION}",
            "kind": "ComputeDomain",
            "metadata": {"name": name, "namespace": "default"},
            "spec": {"numNodes": num_nodes, "channel": {
                "resourceClaimTemplate": {"name": f"{name}-channel"}}}},
            namespace="default")

    def put_claim(uid, namespace, device, kind, cd_uid):
        request = "daemon" if device == "daemon" else "channel"
        kube.create(*claims, {
            "metadata": {"uid": uid, "namespace": namespace, "name": uid},
            "status": {"allocation": {"devices": {
                "results": [{"request": request,
                             "driver": COMPUTE_DOMAIN_DRIVER_NAME,
                             "pool": CD_NODE, "device": device}],
                "config": [{"source": "FromClaim", "requests": [request],
                            "opaque": {
                                "driver": COMPUTE_DOMAIN_DRIVER_NAME,
                                "parameters": {"apiVersion": API_VERSION,
                                               "kind": kind,
                                               "domainID": cd_uid}}}]}}}},
            namespace=namespace)
        return {"uid": uid, "namespace": namespace, "name": uid}

    def delete_cd(name):
        """As an API server deletes an object with finalizers: a
        deletionTimestamp, the controller's teardown drops the
        finalizer, then the object goes."""
        cd = kube.get(*cds, name, namespace="default")
        cd["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
        kube.update(*cds, name, cd, namespace="default")
        wait(lambda: FINALIZER not in kube.get(*cds, name, namespace="default")
             ["metadata"].get("finalizers", []), 30, f"{name}'s teardown")
        kube.delete(*cds, name, namespace="default")

    def label(node):
        return kube.get("", "v1", "nodes", node)["metadata"].get(
            "labels", {}).get(NODE_LABEL)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = (smi.stdout or smi.stderr).strip().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix="cd")
    server = FakeApiServer().start()
    kube = KubeClient(server.url)
    for node in (CD_NODE, CD_NODE_B):
        kube.create("", "v1", "nodes", {"kind": "Node",
                                        "metadata": {"name": node}})
    controller = ComputeDomainController(kube)
    jax_port, rendezvous_port = free_port(), free_port()
    # The plugin's coordinator port, as a cluster's plugin reads it.
    port_before = os.environ.get("JAX_COORDINATOR_PORT")
    os.environ["JAX_COORDINATOR_PORT"] = str(jax_port)
    state = CDDeviceState(f"{tmp}/cd", kube, CD_NODE, cdi_root=f"{tmp}/cdi")
    state_b = CDDeviceState(f"{tmp}/cd-b", kube, CD_NODE_B,
                            cdi_root=f"{tmp}/cdi-b")
    driver = CDDriver(state, kube, CD_NODE, retry_timeout=30.0)
    gpu = None
    daemon = None
    daemon_log = open(f"{tmp}/daemon.log", "w+", encoding="utf-8")
    launches = 0
    try:
        # The controller's two watches and the plugins' two informers.
        controller.start(resync_interval=1.0)
        check(server.store.wait_for_streams(4, 30), "the watches")
        t0 = time.perf_counter()
        cd = make_cd("smoke-cd", 1)
        uid = cd["metadata"]["uid"]

        def made():
            cd = kube.get(*cds, "smoke-cd", namespace="default")
            objects = {
                "finalizers": cd["metadata"].get("finalizers"),
                "daemonsets": [o["metadata"]["name"] for o in kube.list(
                    "apps", "v1", "daemonsets")],
                "templates": sorted(o["metadata"]["name"] for o in kube.list(
                    "resource.k8s.io", "v1", "resourceclaimtemplates")),
                "status": cd.get("status", {}).get("status")}
            return objects if objects == {
                "finalizers": [FINALIZER],
                "daemonsets": [f"computedomain-daemon-{uid}"],
                "templates": ["smoke-cd-channel", "smoke-cd-daemon-claim"],
                "status": "NotReady"} else None
        t_created = time.time() - (time.perf_counter() - t0)
        objects = wait(made, 30, "the controller's objects")
        ms["reconcile"] = round((time.perf_counter() - t0) * 1e3, 3)
        log(f"compute domain: {uid} reconciled from its watch event in "
            f"{ms['reconcile']} ms: {objects}")
        # Where those ms went: each cd.reconcile pass of the domain until
        # its objects stood, from the create (the watch event and the
        # queue before it), and its own ms.
        passes = [sp for sp in exporter.spans()
                  if sp["name"] == "cd.reconcile"
                  and sp["attrs"].get("claim_uid") == uid]
        check(passes and all(sp["parent_id"] == "" for sp in passes),
              f"the reconcile spans {passes}")
        log("compute domain: span split of the reconcile: " + "; ".join(
            f"pass {i} at +{(sp['start'] - t_created) * 1e3:.3f} ms: "
            + " / ".join(span_tree(exporter.spans(), sp))
            for i, sp in enumerate(passes)))

        # The daemon: its claim, then its process under the claim's env.
        ref = put_claim("smoke-cd-daemon", "tpu-dra-driver", "daemon",
                        "ComputeDomainDaemonConfig", uid)
        out = timed("daemon_prepare", driver.prepare_resource_claims,
                    [ref])[ref["uid"]]
        check(out[1] == "", f"the daemon claim: {out[1]}")
        spec = state._cdi.read_spec(ref["uid"])
        (mount,) = spec["containerEdits"]["mounts"]
        check(mount["hostPath"] == state.domain_dir(uid)
              and mount["containerPath"] == DOMAIN_STATE_ROOT,
              f"the daemon's mount {mount}")
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("TPU_", "KUBERNETES_"))}
        env.update(entry.split("=", 1)
                   for entry in spec["containerEdits"]["env"])
        env.update({"KUBE_API": server.url, "POD_IP": "127.0.0.1",
                    "COORDINATION_PORT": str(rendezvous_port),
                    "JAX_COORDINATOR_PORT": str(jax_port),
                    "HOSTS_FILE": f"{tmp}/hosts",
                    # No container runtime: the host side of the mount is
                    # the path the process sees.
                    "DOMAIN_STATE_DIR": mount["hostPath"],
                    "PYTHONPATH": root})
        t0 = time.perf_counter()
        daemon = subprocess.Popen(
            [sys.executable, "-m",
             "k8s_dra_driver_gpu_tpu_torch.computedomain.daemon.main", "run"],
            env=env, cwd=root, stdin=subprocess.DEVNULL, stdout=daemon_log,
            stderr=subprocess.STDOUT)

        def ready():
            if daemon.poll() is not None:
                raise AssertionError(f"the daemon exited {daemon.returncode}")
            members = [m for c in kube.list(*cliques) for m in
                       c.get("status", {}).get("daemons", [])]
            got = kube.get(*cds, "smoke-cd", namespace="default")
            return (answer(rendezvous_port) == "READY"
                    and [m["status"] for m in members] == ["Ready"]
                    and got.get("status", {}).get("status") == "Ready"
                    and members)
        members = wait(ready, CD_READY_TIMEOUT_S, "the domain Ready")
        ms["daemon_start_to_ready"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        # The supervisor thread forked it: every task's children.
        rendezvous = [int(p) for task in os.listdir(f"/proc/{daemon.pid}/task")
                      for p in open(f"/proc/{daemon.pid}/task/{task}/children",
                                    encoding="ascii").read().split()]
        check(len(rendezvous) == 1, f"the daemon's children {rendezvous}")
        log(f"compute domain: daemon pid {daemon.pid} (rendezvous child "
            f"{rendezvous}) Ready in {ms['daemon_start_to_ready']:.1f} ms; "
            f"member {json.dumps(members)}")

        # The channel claim.
        ref = put_claim("smoke-cd-channel", "default", "channel-0",
                        "ComputeDomainChannelConfig", uid)
        out = timed("channel_prepare", driver.prepare_resource_claims,
                    [ref])[ref["uid"]]
        check(out[1] == "", f"the channel claim: {out[1]}")
        channel = state._cdi.read_spec(ref["uid"])
        channel_env = dict(entry.split("=", 1) for entry in
                           channel["containerEdits"]["env"])
        (done,) = [e for e in recorder.events(ref["uid"])
                   if e["event"] == "cd_prepare_done"]
        prepares = [sp for sp in exporter.spans()
                    if sp["name"] == "cd_prepare"
                    and sp["attrs"].get("claim_uid") == ref["uid"]]
        log("compute domain: span split of the channel prepare ("
            f"cd_prepare_done {done['ms']} ms, {done['retries']} retries): "
            + "; ".join(" / ".join(span_tree(exporter.spans(), sp))
                        for sp in prepares))
        # A try that failed in the claim's lookup has no cd_prepare span;
        # the last try's has its segments.
        check(1 <= len(prepares) <= done["retries"] + 1
              and span_tree(exporter.spans(), prepares[-1])[1:],
              f"the channel's spans {prepares}")
        log(f"compute domain: channel prepared in {ms['channel_prepare']} ms "
            f"after {done['retries']} retries (segments ms "
            f"{ {k: round(v * 1e3, 3) for k, v in state.last_segments.items()} }"
            f"): ids {out[0][0]['cdi_device_ids']}, env {channel_env}, "
            f"mounts {channel['containerEdits']['mounts']}; node label "
            f"{label(CD_NODE)}")
        check(channel_env["TPU_COORDINATOR_ADDRESS"] ==
              f"127.0.0.1:{jax_port}"
              and channel_env["TPU_PROCESS_ID"] == "0"
              and channel_env["TPU_NUM_PROCESSES"] == "1"
              and channel_env["TPU_WORKER_HOSTNAMES"] == "127.0.0.1"
              and channel["containerEdits"]["mounts"][0]["hostPath"]
              == state.domain_dir(uid) and label(CD_NODE) == uid,
              "the channel's spec")

        # The workload: the channel's env merged with a gpu-0 claim's.
        gpu = DeviceState(Config(root=f"{tmp}/gpu", cdi_root=f"{tmp}/gpu-cdi"))
        gpu.prepare(ResourceClaim.from_dict({
            "metadata": {"uid": "smoke-cd-gpu", "namespace": "default",
                         "name": "smoke-cd-gpu"},
            "status": {"allocation": {"devices": {"results": [
                {"request": "gpu", "driver": DRIVER_NAME, "pool": "node",
                 "device": "gpu-0"}], "config": []}}}}))
        gpu_spec = gpu._cdi.read_spec("smoke-cd-gpu")
        product = gpu.allocatable["gpu-0"].chip.chip.name
        result = timed("channel_child", run_claim_child, gpu_spec, seed,
                       product, "compute domain", also=(channel,),
                       script=CD_CHILD)
        lines = [line for line in result["stdout"].splitlines()
                 if line.startswith("{")]
        gang = json.loads(lines[0])
        log(f"compute domain: the child's train.verify "
            f"{json.dumps({k: v for k, v in gang.items() if k != 'env'})}")
        check(len(lines) == 2 and gang["devSum"] == 1.0
              and gang["rankSum"] == 1.0 and gang["gang"] is True
              and gang["steps"] == 2 and math.isfinite(float(gang["loss"]))
              and gang["env"]["TPU_COORDINATOR_ADDRESS"]
              == channel_env["TPU_COORDINATOR_ADDRESS"],
              f"the child's gang: {lines}")
        launches = result["launches"]

        # The daemon's own bootstrap.json.
        boot = os.path.join(state.domain_dir(uid), "bootstrap.json")
        with open(boot, encoding="utf-8") as f:
            boot_doc = json.load(f)
        reports = timed("dryrun_from_bootstrap",
                        pt_entry.dryrun_multichip_multiprocess, n_procs=1,
                        local_devices=torch.cuda.device_count(),
                        bootstrap_file=boot, timeout=300)
        log(f"compute domain: the daemon's bootstrap.json {boot_doc}; "
            "dryrun_multichip_multiprocess from it: "
            + json.dumps({k: v for k, v in reports[0].items() if k != "env"})
            + f", coordinator {reports[0]['env']['TPU_COORDINATOR_ADDRESS']}")
        check(boot_doc["coordinatorAddress"].endswith(f":{jax_port}")
              and reports[0]["env"]["TPU_COORDINATOR_ADDRESS"]
              == channel_env["TPU_COORDINATOR_ADDRESS"]
              and reports[0]["gang"] is True, "the dry run's gang")

        # A domain whose second node never comes, on the second node.
        cd2 = make_cd("smoke-cd2", 2)
        uid2 = cd2["metadata"]["uid"]
        driver_b = CDDriver(state_b, kube, CD_NODE_B,
                            retry_timeout=CD_ABORT_DEADLINE_S)
        ref2 = put_claim("smoke-cd2-channel", "default", "channel-0",
                         "ComputeDomainChannelConfig", uid2)
        errors = [timed(f"abort_{i}", driver_b.prepare_resource_claims,
                        [ref2])[ref2["uid"]][1] for i in range(2)]
        events = [e for e in kube.list("", "v1", "events", namespace="default")
                  if e["reason"] == "GangPrepareAborted"]
        left = {"spec": state_b._cdi.spec_exists(ref2["uid"]),
                "record": ref2["uid"] in state_b.prepared_claims(),
                "label_while_the_domain_lives": label(CD_NODE_B)}
        timed("delete_cd2", delete_cd, "smoke-cd2")
        left["label_after_its_deletion"] = label(CD_NODE_B)
        log(f"compute domain: the 2-node domain aborted "
            f"{driver_b.gang_aborts} times ({errors[0][:120]}...); "
            f"{len(events)} GangPrepareAborted Event(s): "
            f"{[e['message'][:80] for e in events]}; left {left}")
        check(driver_b.gang_aborts == 2 and len(events) == 1
              and all(e.startswith("gang prepare deadline") for e in errors)
              and left == {"spec": False, "record": False,
                           "label_while_the_domain_lives": uid2,
                           "label_after_its_deletion": None},
              "the abort and its unwind")

        # Teardown, in a cluster's order.
        t_down = time.perf_counter()
        out = timed("channel_unprepare", driver.unprepare_resource_claims,
                    [{"uid": "smoke-cd-channel"}])
        check(out == {"smoke-cd-channel": ""} and label(CD_NODE) is None,
              "the channel's unprepare")
        daemon.send_signal(signal.SIGTERM)
        rc = timed("daemon_stop", daemon.wait, 30)
        deregistered = [m for c in kube.list(*cliques) for m in
                        c.get("status", {}).get("daemons", [])]
        check(rc == 0 and deregistered == [] and all(
            _gone(p) for p in rendezvous), f"the daemon's stop (exit {rc}, "
              f"members {deregistered}, rendezvous {rendezvous})")
        out = timed("daemon_unprepare", driver.unprepare_resource_claims,
                    [{"uid": "smoke-cd-daemon"}])
        check(out == {"smoke-cd-daemon": ""}, "the daemon's unprepare")
        timed("gpu_unprepare", gpu.unprepare, "smoke-cd-gpu")
        timed("delete_cd", delete_cd, "smoke-cd")
        removed = timed("domain_dir_gc", state.cleanup_stale_domain_dirs)
        ms["teardown"] = round((time.perf_counter() - t_down) * 1e3, 3)
        left = {"cds": kube.list(*cds), "cliques": kube.list(*cliques),
                "daemonsets": kube.list("apps", "v1", "daemonsets"),
                "templates": kube.list("resource.k8s.io", "v1",
                                       "resourceclaimtemplates"),
                "specs": sorted(state._cdi.list_claim_uids()
                                + state_b._cdi.list_claim_uids()
                                + gpu._cdi.list_claim_uids()),
                "records": sorted(state.prepared_claims())
                + sorted(gpu.prepared_claims()),
                "domain_dirs": os.listdir(f"{tmp}/cd/domains"),
                "labels": [label(CD_NODE), label(CD_NODE_B)]}
        log(f"compute domain: torn down (domain dirs removed {removed}); "
            f"left {left}")
        check(removed == [uid] and left == {
            "cds": [], "cliques": [], "daemonsets": [], "templates": [],
            "specs": [], "records": [], "domain_dirs": [],
            "labels": [None, None]}, "the teardown left state")
        return launches
    finally:
        if daemon is not None and daemon.poll() is None:
            daemon.kill()
            daemon.wait()
        daemon_log.seek(0)
        tail = daemon_log.read()[-3000:]
        daemon_log.close()
        if daemon is not None and daemon.returncode:
            log(f"compute domain: the daemon's log: {tail}")
        if gpu is not None:
            gpu.close()
        controller.stop()
        driver.stop_background()
        state_b.stop()
        server.stop()
        shutil.rmtree(tmp, ignore_errors=True)
        if port_before is None:
            os.environ.pop("JAX_COORDINATOR_PORT", None)
        else:
            os.environ["JAX_COORDINATOR_PORT"] = port_before
        tracing.set_exporter(exporter_before)
        flightrecorder.set_default(recorder_before)
        log(f"compute domain: host ms {json.dumps(ms)} on {card}")


OBS_NODE = "smoke-obs-node"
CONTROLLER_MAIN = "k8s_dra_driver_gpu_tpu_torch.computedomain.controller.main"
WEBHOOK_MAIN = "k8s_dra_driver_gpu_tpu_torch.webhook.main"
WEBHOOK_SERVICE = "tpu-dra-webhook"
WEBHOOK_NAMESPACE = "tpu-dra-driver"
LEASE = ("coordination.k8s.io", "v1", "leases")
LEASE_NAME = "tpu-dra-cd-controller"  # the controller's --lease-name default


def metric_samples(text: str) -> dict:
    """A text exposition's samples: (name, sorted label pairs) -> value
    (the chip machine has no ``prometheus_client`` to parse it)."""
    import re

    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        head, value = line.rsplit(" ", 1)
        name, _, rest = head.partition("{")
        labels = tuple(sorted(re.findall(r'(\w+)="((?:[^"\\]|\\.)*)"',
                                         rest)))
        out[(name, labels)] = float(value)
    return out


def _http_get(url: str) -> str:
    import urllib.request

    with urllib.request.urlopen(url, timeout=10) as resp:
        return resp.read().decode()


def phase_observability(seed: int) -> dict:
    """19. The driver's observability and the two binaries that need no
    gRPC, on this machine's host: the kubelet plugin over NVML with its
    metrics listener, two controller processes with leader election, and
    the webhook with its TLS bootstrap. Returns the host ms."""
    import base64
    import http.client
    import os
    import random
    import shutil
    import signal
    import socket
    import ssl
    import tempfile
    import threading

    from k8s_dra_driver_gpu_tpu_torch.api.decode import API_VERSION
    from k8s_dra_driver_gpu_tpu_torch.computedomain import (
        API_GROUP, API_VERSION as CD_VERSION, FINALIZER)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.device_state import (
        Config)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.driver import Driver
    from k8s_dra_driver_gpu_tpu_torch.pkg import flightrecorder, tracing
    from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
    from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import (KubeClient,
                                                             NotFoundError)
    from k8s_dra_driver_gpu_tpu_torch.pkg.metrics import (DRARequestMetrics,
                                                          MetricsServer)
    from k8s_dra_driver_gpu_tpu_torch.pkg.retry import RetryingKubeClient
    from k8s_dra_driver_gpu_tpu_torch.webhook import certbootstrap
    from k8s_dra_driver_gpu_tpu_torch.webhook.main import VALIDATE_PATH

    ms = {}
    timed = functools.partial(_timed, ms)
    root = os.path.dirname(os.path.abspath(__file__))
    cds = (API_GROUP, CD_VERSION, "computedomains")

    def check(ok, what):
        if not ok:
            raise AssertionError(f"observability: {what}")

    def wait(fn, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            value = fn()
            if value:
                return value
            time.sleep(0.01)
        raise AssertionError(f"observability: timed out waiting for {what}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = (smi.stdout or smi.stderr).strip().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix="obs")
    exporter_before = tracing.exporter()
    recorder_before = flightrecorder.default()
    tracing.set_exporter(tracing.TraceExporter())
    flightrecorder.set_default(flightrecorder.FlightRecorder())
    threads_before = set(threading.enumerate())
    procs: dict = {}
    servers = []
    passed = False
    try:
        # -- 1. the node: the kubelet plugin over NVML, with its metrics
        # listener (phase 13's construction: no health monitor, so no
        # NVML read beside this process's CUDA).
        server = FakeApiServer().start()
        servers.append(server)
        kube = KubeClient(host=server.url)
        metrics = DRARequestMetrics()
        driver = timed("node_construct", Driver, Config(
            root=f"{tmp}/state", cdi_root=f"{tmp}/cdi"), kube, OBS_NODE,
            False, metrics=metrics)
        listener = MetricsServer(metrics.registry, host="127.0.0.1", port=0)
        listener.start()
        servers.append(listener)
        base = f"http://127.0.0.1:{listener.port}"
        driver.publish_resources()
        rng = random.Random(seed)
        parent = tracing.SpanContext(f"{rng.getrandbits(128) | 1:032x}",
                                     f"{rng.getrandbits(64) | 1:016x}")
        claim = {"metadata": {
            "uid": "smoke-obs-claim", "namespace": "default",
            "name": "smoke-obs-claim", "annotations": {
                tracing.TRACEPARENT_ANNOTATION: parent.to_traceparent()}},
            "status": {"allocation": {"devices": {"results": [
                {"request": "gpu", "driver": DRIVER_NAME, "pool": OBS_NODE,
                 "device": "gpu-0"}], "config": []}}}}
        kube.create("resource.k8s.io", "v1", "resourceclaims", claim,
                    namespace="default")
        ref = {k: claim["metadata"][k] for k in ("uid", "namespace", "name")}
        uid = ref["uid"]
        out = timed("node_prepare", driver.prepare_resource_claims, [ref])
        check(out[uid][1] == "" and out[uid][0][0]["cdi_device_ids"] ==
              ["nvidia.com/gpu=gpu-0"], f"the prepare {out}")
        samples = metric_samples(timed("scrape", _http_get,
                                       base + "/metrics"))
        prep = (("operation", "NodePrepareResources"),)
        errors = {k: v for k, v in samples.items()
                  if k[0] == "tpu_dra_request_errors_total"}
        check(samples.get(("tpu_dra_request_duration_seconds_count", prep))
              == 1.0 and errors == {}
              and samples[("tpu_dra_prepared_devices", ())] == 1.0
              and samples.get(("tpu_dra_claim_e2e_seconds_count",
                               (("phase", "prepare"),))) == 1.0,
              f"/metrics after the prepare: {samples}")
        doc = json.loads(_http_get(
            f"{base}/debug/traces/{parent.trace_id}"))
        spans = doc["spans"]
        (prepare,) = [sp for sp in spans if sp["name"] == "prepare"]
        tree = span_tree(spans, prepare)
        check(prepare["parent_id"] == parent.span_id and len(tree) > 1
              and prepare["attrs"]["claim_uid"] == uid,
              f"the prepare's trace {spans}")
        by_uid = json.loads(_http_get(f"{base}/debug/claims/{uid}"))
        by_name = json.loads(_http_get(
            f"{base}/debug/claims/default/{ref['name']}"))
        done = [e for e in by_uid["events"] if e["event"] == "prepare_done"]
        check(len(done) == 1 and done == [
            e for e in by_name["events"] if e["event"] == "prepare_done"]
              and done[0]["trace_id"] == parent.trace_id
              and done[0]["alias"] == f"default/{ref['name']}",
              f"/debug/claims: {by_uid} / {by_name}")
        out = timed("node_unprepare", driver.unprepare_resource_claims,
                    [{"uid": uid}])
        samples = metric_samples(_http_get(base + "/metrics"))
        check(out == {uid: ""}
              and samples[("tpu_dra_prepared_devices", ())] == 0.0
              and samples.get(("tpu_dra_request_duration_seconds_count",
                               (("operation", "NodeUnprepareResources"),)))
              == 1.0, f"/metrics after the unprepare: {samples}")
        log(f"observability: node prepare {ms['node_prepare']} ms, its "
            f"metrics served; trace {parent.trace_id}: " + " / ".join(tree)
            + f"; prepare_done {done[0]['ms']} ms; events "
            f"{[e['event'] for e in by_uid['events']]}")
        listener.stop()
        servers.remove(listener)
        driver.stop()

        # -- 2. the controller binary: two replicas, one Lease.
        ports = {ident: free_port() for ident in ("cd-a", "cd-b")}
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KUBE_API", "KUBERNETES_"))}
        env.update({"PYTHONPATH": root, "TPU_DRA_DEBUG_HTTP": "1"})

        def holder():
            try:
                return kube.get(*LEASE, LEASE_NAME, namespace=WEBHOOK_NAMESPACE
                                )["spec"]["holderIdentity"]
            except NotFoundError:
                return None

        def finalized(name):
            return FINALIZER in kube.get(*cds, name, namespace="default")[
                "metadata"].get("finalizers", [])

        def make_cd(name):
            return kube.create(*cds, {
                "apiVersion": f"{API_GROUP}/{CD_VERSION}",
                "kind": "ComputeDomain",
                "metadata": {"name": name, "namespace": "default"},
                "spec": {"numNodes": 1, "channel": {
                    "resourceClaimTemplate": {"name": f"{name}-channel"}}}},
                namespace="default")

        def spawn(name, args):
            with open(f"{tmp}/{name}.log", "w", encoding="utf-8") as out:
                procs[name] = subprocess.Popen(
                    [sys.executable, "-m", *args], env=env, cwd=root,
                    stdin=subprocess.DEVNULL, stdout=out,
                    stderr=subprocess.STDOUT)

        t0 = time.perf_counter()
        for ident, port in ports.items():
            spawn(ident, [CONTROLLER_MAIN, "--leader-election", "--kube-api",
                          server.url, "--metrics-port", str(port),
                          "--identity", ident, "--namespace",
                          WEBHOOK_NAMESPACE])
        leader = wait(holder, 60, "a leader")
        ms["controller_start_to_leader"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        standby = "cd-b" if leader == "cd-a" else "cd-a"
        t0 = time.perf_counter()
        cd_uid = make_cd("obs-cd")["metadata"]["uid"]

        def made():
            return (finalized("obs-cd")
                    and kube.list("apps", "v1", "daemonsets",
                                  namespace=WEBHOOK_NAMESPACE)
                    and len(kube.list("resource.k8s.io", "v1",
                                      "resourceclaimtemplates")) == 2)
        wait(made, 30, "the leader's objects")
        ms["leader_reconcile"] = round((time.perf_counter() - t0) * 1e3, 3)
        lead_url = f"http://127.0.0.1:{ports[leader]}"
        status = (("name", "obs-cd"), ("namespace", "default"))
        wait(lambda: ("tpu_compute_domain_status", status) in
             metric_samples(_http_get(lead_url + "/metrics")), 30,
             "the leader's status gauge")
        def reconciles():
            # A span is exported when it ends, after the gauge is set in it.
            traces = json.loads(_http_get(lead_url + "/debug/traces"))[
                "traces"]
            return [sp for spans_ in traces.values() for sp in spans_
                    if sp["name"] == "cd.reconcile"
                    and sp["attrs"]["claim_uid"] == cd_uid]
        reconciles = wait(reconciles, 30, "the leader's reconcile span")
        standby_url = f"http://127.0.0.1:{ports[standby]}"
        standby_spans = json.loads(_http_get(
            standby_url + "/debug/traces"))["traces"]
        check(not standby_spans
              and ("tpu_compute_domain_status", status) not in
              metric_samples(_http_get(standby_url + "/metrics")),
              f"the leader's spans {reconciles}, the standby's "
              f"{standby_spans}")
        t0 = time.perf_counter()
        procs[leader].send_signal(signal.SIGTERM)
        rc = procs[leader].wait(timeout=60)
        ms["leader_sigterm_to_exit"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        released = holder()
        t0 = time.perf_counter()
        check(rc == 0 and released in ("", standby),
              f"the leader's exit {rc}, the Lease's holder {released!r}")
        wait(lambda: holder() == standby, 30, "the standby's takeover")
        ms["takeover"] = round((time.perf_counter() - t0) * 1e3, 3)
        t0 = time.perf_counter()
        make_cd("obs-cd2")
        wait(lambda: finalized("obs-cd2"), 30, "the new leader's reconcile")
        ms["new_leader_reconcile"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        procs[standby].send_signal(signal.SIGTERM)
        rc = procs[standby].wait(timeout=60)
        check(rc == 0 and holder() == "",
              f"the second leader's exit {rc}, holder {holder()!r}")
        log(f"observability: controller binaries: {leader} led after "
            f"{ms['controller_start_to_leader']} ms and reconciled in "
            f"{ms['leader_reconcile']} ms ({len(reconciles)} cd.reconcile "
            f"spans, {[sp['duration_ms'] for sp in reconciles]} ms); "
            f"SIGTERM to exit 0 in {ms['leader_sigterm_to_exit']} ms, "
            f"Lease released ({released!r}); {standby} took over in "
            f"{ms['takeover']} ms and reconciled a second domain in "
            f"{ms['new_leader_reconcile']} ms; both exited 0")

        # -- 3. the webhook, with its TLS bootstrap where openssl runs.
        openssl = shutil.which("openssl")
        port = free_port()
        args = [WEBHOOK_MAIN, "--port", str(port)]
        service_dns = f"{WEBHOOK_SERVICE}.{WEBHOOK_NAMESPACE}.svc"
        transport = "plain HTTP"
        if openssl:
            transport = (f"TLS, verified as {service_dns} against the "
                         "patched caBundle")
            kube.create("admissionregistration.k8s.io", "v1",
                        "validatingwebhookconfigurations", {
                            "apiVersion": "admissionregistration.k8s.io/v1",
                            "kind": "ValidatingWebhookConfiguration",
                            "metadata": {"name": WEBHOOK_SERVICE},
                            "webhooks": [{"name": "validate.nvidia.com",
                                          "clientConfig": {"service": {
                                              "name": WEBHOOK_SERVICE,
                                              "namespace":
                                              WEBHOOK_NAMESPACE}}}]})
            rc = timed("cert_bootstrap", certbootstrap.run,
                       RetryingKubeClient(kube), WEBHOOK_SERVICE,
                       WEBHOOK_NAMESPACE, f"{WEBHOOK_SERVICE}-tls",
                       WEBHOOK_SERVICE)
            secret = kube.get("", "v1", "secrets", f"{WEBHOOK_SERVICE}-tls",
                              namespace=WEBHOOK_NAMESPACE)
            for key in ("tls.crt", "tls.key"):
                with open(f"{tmp}/{key}", "wb") as f:
                    f.write(base64.b64decode(secret["data"][key]))
            bundle = base64.b64decode(kube.get(
                "admissionregistration.k8s.io", "v1",
                "validatingwebhookconfigurations", WEBHOOK_SERVICE)[
                    "webhooks"][0]["clientConfig"]["caBundle"])
            check(rc == 0 and bundle == base64.b64decode(
                secret["data"]["tls.crt"]), "the bootstrap's secret and "
                "caBundle")
            args += ["--tls-cert", f"{tmp}/tls.crt",
                     "--tls-key", f"{tmp}/tls.key"]
            context = ssl.create_default_context(cadata=bundle.decode())

            class Connection(http.client.HTTPSConnection):
                """TLS to 127.0.0.1 verified as the service's name."""

                def connect(self):
                    sock = socket.create_connection((self.host, self.port),
                                                    self.timeout)
                    self.sock = context.wrap_socket(
                        sock, server_hostname=service_dns)
        else:
            log("webhook: TLS not run (no openssl on this machine)")

            class Connection(http.client.HTTPConnection):
                pass
        t0 = time.perf_counter()
        spawn("webhook", args)

        def listening():
            check(procs["webhook"].poll() is None, "the webhook exited")
            with socket.socket() as sock:
                return sock.connect_ex(("127.0.0.1", port)) == 0
        wait(listening, 60, "the webhook's port")
        ms["webhook_start"] = round((time.perf_counter() - t0) * 1e3, 3)

        def claim_review(body):
            return {"apiVersion": "admission.k8s.io/v1",
                    "kind": "AdmissionReview", "request": {
                        "uid": "r1", "object": {
                            "apiVersion": "resource.k8s.io/v1",
                            "kind": "ResourceClaim", "spec": {"devices": {
                                "requests": [{"name": "gpu"}],
                                "config": [{"opaque": {
                                    "driver": DRIVER_NAME, "parameters": {
                                        "apiVersion": API_VERSION,
                                        "kind": "GpuConfig", **body}}}]}}}}}

        good = {"sharing": {"strategy": "TimeSlicing",
                            "timeSlicing": {"interval": "Short"}}}
        reviews = {
            "valid": claim_review(good),
            "unknown_field": claim_review({**good, "bogus": 1}),
            "indivisible_domain": {
                "apiVersion": "admission.k8s.io/v1",
                "kind": "AdmissionReview", "request": {
                    "uid": "r3", "object": {
                        "apiVersion": f"{API_GROUP}/{CD_VERSION}",
                        "kind": "ComputeDomain",
                        "spec": {"numNodes": 3, "numSlices": 2}}}}}
        answers = {}
        for name, body in reviews.items():
            t0 = time.perf_counter()
            conn = Connection("127.0.0.1", port, timeout=30)
            conn.request("POST", VALIDATE_PATH, json.dumps(body),
                         {"Content-Type": "application/json"})
            resp = conn.getresponse()
            answer = json.loads(resp.read())["response"]
            conn.close()
            ms[f"review_{name}"] = round((time.perf_counter() - t0) * 1e3, 3)
            answers[name] = (resp.status, answer["allowed"],
                             answer.get("status", {}).get("code"),
                             answer.get("status", {}).get("message", ""))
        log(f"observability: webhook over {transport}: "
            f"{json.dumps(answers)}")
        check(answers["valid"][:3] == (200, True, None)
              and answers["unknown_field"][:3] == (200, False, 422)
              and "unknown field" in answers["unknown_field"][3]
              and answers["indivisible_domain"][:3] == (200, False, 422)
              and "split evenly" in answers["indivisible_domain"][3],
              f"the reviews {answers}")
        procs["webhook"].send_signal(signal.SIGTERM)
        rc = procs["webhook"].wait(timeout=60)
        check(rc == 0, f"the webhook exited {rc}")
        passed = True
        return ms
    finally:
        for name, proc in procs.items():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if proc.returncode:
                with open(f"{tmp}/{name}.log", encoding="utf-8") as f:
                    log(f"observability: {name} exited {proc.returncode}: "
                        f"{f.read()[-3000:]}")
        for srv in reversed(servers):
            srv.stop()
        tracing.set_exporter(exporter_before)
        flightrecorder.set_default(recorder_before)
        shutil.rmtree(tmp, ignore_errors=True)
        left = [t.name for t in threading.enumerate()
                if t not in threads_before and t.is_alive()]
        alive = [n for n, p in procs.items() if p.poll() is None]
        log(f"observability: host ms {json.dumps(ms)} on {card}; threads "
            f"left {left}; children alive {alive}")
        # Only when nothing else failed: do not hide the first error.
        if passed:
            check(not left and not alive, "a thread or a child outlived "
                  "the phase")


SCHED_NODE = "smoke-sched-node"
SCHEDULER_MAIN = "k8s_dra_driver_gpu_tpu_torch.pkg.scheduler"
# Phase 20 (b): an HGX-class fleet of FLEET_NODES nodes of FLEET_GPUS GPUs.
FLEET_NODES = 128
FLEET_GPUS = 8
FLEET_SINGLES = 768
FLEET_EIGHTS = 16
FLEET_BUDGET_S = 90.0
# Seeded orders in which the 8-GPU claims arrive at random places among
# the singles (after the ``--seed`` offset).
FLEET_SHUFFLES = 3


def _fleet_slices(real: dict, node_names: list[str]) -> list[dict]:
    """``real`` (a node's published slice) cloned onto ``node_names``, each
    with ``FLEET_GPUS`` GPUs: the slice's first GPU, its attributes and its
    counter set, once a GPU, with fresh UUIDs and its own index."""
    import copy
    import uuid

    spec = real["spec"]
    dev0 = spec["devices"][0]
    counters0 = spec["sharedCounters"][0]
    out = []
    for node in node_names:
        devices, sets = [], []
        for i in range(FLEET_GPUS):
            dev = copy.deepcopy(dev0)
            dev["name"] = f"gpu-{i}"
            dev["attributes"]["uuid"] = {"string": f"GPU-{uuid.uuid4()}"}
            dev["attributes"]["minor"] = {"int": i}
            dev["attributes"]["acceleratorType"] = {
                "string": f"h100-{FLEET_GPUS}"}
            dev["consumesCounters"] = [dict(
                dev0["consumesCounters"][0],
                counterSet=f"gpu-{i}-counter-set")]
            devices.append(dev)
            sets.append(dict(copy.deepcopy(counters0),
                             name=f"gpu-{i}-counter-set"))
        out.append({
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
            "metadata": {"name": f"{node}-gpu.nvidia.com"},
            "spec": dict(copy.deepcopy(spec), nodeName=node,
                         pool={"name": node, "generation": 1,
                               "resourceSliceCount": 1},
                         devices=devices, sharedCounters=sets)})
    return out


def _fleet_run(real: dict, product: str, shuffle: int | None = None) -> dict:
    """20 (b): the fleet in the port's in-process ``FakeKubeClient``,
    passes of the port's ``DraScheduler`` until one allocates nothing.
    The claims arrive 8-GPU first, or in the order ``shuffle`` seeds."""
    import random

    from k8s_dra_driver_gpu_tpu_torch.api import deviceclasses
    from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import FakeKubeClient
    from k8s_dra_driver_gpu_tpu_torch.pkg.scheduler import DraScheduler

    res = ("resource.k8s.io", "v1")
    kube = FakeKubeClient()
    deviceclasses.create_all(kube)
    nodes = [f"hgx-{n:03d}" for n in range(FLEET_NODES)]
    t0 = time.perf_counter()
    for s in _fleet_slices(real, nodes):
        kube.create(*res, "resourceslices", s)

    def claim(name, count=1, cel=None, constraint=None):
        exactly = {"deviceClassName": deviceclasses.GPU_CLASS}
        if count != 1:
            exactly["count"] = count
        if cel:
            exactly["selectors"] = [{"cel": {"expression": cel}}]
        devices = {"requests": [{"name": "gpu", "exactly": exactly}]}
        if constraint:
            devices["constraints"] = [{"matchAttribute": constraint}]
        kube.create(*res, "resourceclaims", {
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": name, "namespace": "fleet"},
            "spec": {"devices": devices}}, namespace="fleet")

    # A pass takes the claims in creation order and puts each on the
    # least-loaded node it fits, so the singles land on empty nodes while
    # there are any: 8-GPU claims first all fit, and one that comes after
    # (FLEET_NODES - the 8-GPU claims placed) singles finds no node free.
    kinds = [FLEET_GPUS] * FLEET_EIGHTS + [1] * FLEET_SINGLES
    if shuffle is not None:
        random.Random(shuffle).shuffle(kinds)
    made = collections.Counter()
    for count in kinds:
        if count == 1:
            claim(f"one-{made[count]:03d}")
        else:
            claim(f"eight-{made[count]:02d}", FLEET_GPUS,
                  constraint="gpu.nvidia.com/acceleratorType")
        made[count] += 1
    claim("unfit-nine", FLEET_GPUS + 1)
    claim("unfit-product", cel='device.attributes["gpu.nvidia.com"]'
          '.productName == "NVIDIA B200"')
    setup_ms = round((time.perf_counter() - t0) * 1e3, 3)
    sched = DraScheduler(kube)
    passes, allocated = [], 0
    while True:
        t0 = time.perf_counter()
        sched.sync_once()
        passes.append(round((time.perf_counter() - t0) * 1e3, 3))
        now = sum(1 for c in kube.list(*res, "resourceclaims")
                  if c.get("status", {}).get("allocation"))
        if now == allocated:
            break
        allocated = now
        if len(passes) > 10:
            raise AssertionError(f"scheduler fleet: {passes} passes")
    claims = kube.list(*res, "resourceclaims")
    held = [(r["pool"], r["device"]) for c in claims
            for r in (c.get("status", {}).get("allocation") or {}).get(
                "devices", {}).get("results", [])]
    pending = sorted(c["metadata"]["name"] for c in claims
                     if not c.get("status", {}).get("allocation"))
    eight_nodes = [{r["pool"] for r in c["status"]["allocation"]["devices"][
        "results"]} for c in claims if c["metadata"]["name"].startswith(
            "eight") and c.get("status", {}).get("allocation")]
    return {"setup_ms": setup_ms, "passes_ms": passes,
            "allocated": allocated, "held": held, "pending": pending,
            "eight_nodes": eight_nodes, "product": product,
            "eights_pending": sum(n.startswith("eight") for n in pending),
            "claims_per_s": allocated / (sum(passes[:-1]) / 1e3)
            if len(passes) > 1 else 0.0}


def phase_scheduler(seed: int) -> int:
    """20. The port's scheduler from a claim to the flash kernel, on this
    machine's host: (a) the binary over the fake API server on 127.0.0.1
    with the GPU published from NVML; (b) a 128-node fleet of 8 GPUs in
    process. Returns the child's flash launches."""
    import os
    import shutil
    import signal
    import tempfile
    import threading

    from k8s_dra_driver_gpu_tpu_torch.api import deviceclasses
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.device_state import (
        Config)
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.driver import Driver
    from k8s_dra_driver_gpu_tpu_torch.pkg import flightrecorder, tracing
    from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
    from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import KubeClient

    res = ("resource.k8s.io", "v1")
    ms = {}
    timed = functools.partial(_timed, ms)
    root = os.path.dirname(os.path.abspath(__file__))

    def check(ok, what):
        if not ok:
            raise AssertionError(f"scheduler: {what}")

    def wait(fn, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            value = fn()
            if value:
                return value
            time.sleep(0.005)
        raise AssertionError(f"scheduler: timed out waiting for {what}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = (smi.stdout or smi.stderr).strip().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix="sched")
    exporter_before = tracing.exporter()
    recorder_before = flightrecorder.default()
    tracing.set_exporter(tracing.TraceExporter())
    flightrecorder.set_default(flightrecorder.FlightRecorder())
    threads_before = set(threading.enumerate())
    proc = None
    server = None
    passed = False
    try:
        # -- (a) the binary over HTTP, from a template to the kernel.
        server = FakeApiServer().start()
        kube = KubeClient(host=server.url)
        # The store's writes, stamped as they land (host clock).
        stamps: dict = {}

        def on_write(group, resource, namespace, ev_type, obj):
            now = time.perf_counter()
            name = obj.get("metadata", {}).get("name", "")
            if resource == "resourceclaims":
                stamps.setdefault(("created", name), now)
                if obj.get("status", {}).get("allocation"):
                    stamps.setdefault(("allocated", name), now)
            elif resource == "pods" and obj.get("spec", {}).get("nodeName"):
                stamps.setdefault(("bound", name), now)
        server.store.add_resource_watcher(on_write)
        driver = timed("driver_construct", Driver, Config(
            root=f"{tmp}/state", cdi_root=f"{tmp}/cdi"), kube, SCHED_NODE,
            False)
        timed("publish", driver.publish_resources)
        gpus = sorted(driver.state.allocatable)
        product = driver.state.allocatable["gpu-0"].chip.chip.name
        deviceclasses.create_all(kube)
        port = free_port()
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KUBE_API", "KUBERNETES_", "TPU_DRA_"))}
        env.update({"PYTHONPATH": root, "TPU_DRA_DEBUG_HTTP": "1"})
        with open(f"{tmp}/scheduler.log", "w", encoding="utf-8") as out:
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", SCHEDULER_MAIN, "--kube-api",
                 server.url, "--interval", "0.1", "--metrics-port",
                 str(port)], env=env, cwd=root, stdin=subprocess.DEVNULL,
                stdout=out, stderr=subprocess.STDOUT)
        base = f"http://127.0.0.1:{port}"

        def metrics():
            try:
                return metric_samples(_http_get(base + "/metrics"))
            except OSError:
                return None

        def full_passes():
            return (metrics() or {}).get(
                ("tpu_dra_sched_sync_seconds_count", (("mode", "full"),)))
        wait(full_passes, 60, "the scheduler's first pass")
        ms["binary_start_to_first_pass"] = round(
            (time.perf_counter() - t0) * 1e3, 3)
        cel = (f'device.attributes["gpu.nvidia.com"].productName == '
               f'"{product}" && device.capacity["gpu.nvidia.com"].memory'
               f'.compareTo(quantity("40Gi")) >= 0')
        kube.create(*res, "resourceclaimtemplates", {
            "apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaimTemplate",
            "metadata": {"name": "smoke-gpu", "namespace": "default"},
            "spec": {"spec": {"devices": {"requests": [{
                "name": "gpu", "exactly": {
                    "deviceClassName": deviceclasses.GPU_CLASS,
                    "selectors": [{"cel": {"expression": cel}}]}}]}}}},
            namespace="default")
        kube.create("", "v1", "pods", {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "smoke-sched-pod", "namespace": "default"},
            "spec": {"containers": [{"name": "main"}],
                     "resourceClaims": [{
                         "name": "gpu",
                         "resourceClaimTemplateName": "smoke-gpu"}]}},
            namespace="default")
        pod = wait(lambda: (lambda p: p if p["spec"].get("nodeName")
                            else None)(kube.get("", "v1", "pods",
                                                "smoke-sched-pod",
                                                namespace="default")),
                   30, "the pod's binding")
        (status,) = pod["status"]["resourceClaimStatuses"]
        claim_name = status["resourceClaimName"]
        claim = kube.get(*res, "resourceclaims", claim_name,
                         namespace="default")
        alloc = claim["status"]["allocation"]
        results = alloc["devices"]["results"]
        check(pod["spec"]["nodeName"] == SCHED_NODE
              and [(r["driver"], r["pool"], r["device"]) for r in results]
              == [("gpu.nvidia.com", SCHED_NODE, "gpu-0")]
              and claim["status"]["reservedFor"] == [{
                  "resource": "pods", "name": "smoke-sched-pod",
                  "uid": pod["metadata"]["uid"]}]
              and claim["metadata"]["ownerReferences"][0]["name"] ==
              "smoke-sched-pod", f"the claim {claim} and the pod {pod}")
        ms["claim_created_to_allocated"] = round(
            (stamps[("allocated", claim_name)]
             - stamps[("created", claim_name)]) * 1e3, 3)
        ms["allocated_to_bound"] = round(
            (stamps[("bound", "smoke-sched-pod")]
             - stamps[("allocated", claim_name)]) * 1e3, 3)
        # The kubelet's turn: prepare through the API lookup.
        ref = {"uid": claim["metadata"]["uid"], "namespace": "default",
               "name": claim_name}
        uid = ref["uid"]
        out = timed("prepare", driver.prepare_resource_claims, [ref])
        prepared_at = time.perf_counter()
        ms["allocated_to_prepare_done"] = round(
            (prepared_at - stamps[("allocated", claim_name)]) * 1e3, 3)
        check(out[uid][1] == "" and out[uid][0][0]["cdi_device_ids"] ==
              ["nvidia.com/gpu=gpu-0"], f"the prepare {out}")
        spec = driver.state._cdi.read_spec(uid)
        result = run_claim_child(spec, seed, product, "scheduler")
        ms["child"] = round(result["seconds"] * 1e3, 3)

        # One trace: the scheduler's commit span (its listener), the
        # plugin's prepare and its segments (this process's exporter).
        header = claim["metadata"]["annotations"][
            tracing.TRACEPARENT_ANNOTATION]
        ctx = tracing.SpanContext.from_traceparent(header)
        remote = json.loads(_http_get(
            f"{base}/debug/traces/{ctx.trace_id}"))["spans"]
        local = tracing.exporter().trace(ctx.trace_id)
        (commit,) = [sp for sp in remote if sp["name"] == "sched.commit"]
        (prepare,) = [sp for sp in local if sp["name"] == "prepare"]
        segments = span_tree(local, prepare)
        check(ctx.sampled and commit["span_id"] == ctx.span_id
              and commit["attrs"]["claim_uid"] == uid
              and prepare["parent_id"] == commit["span_id"]
              and any(line.strip().startswith("prep_devices ")
                      for line in segments[1:]),
              f"the trace: scheduler {remote}, plugin {local}")
        tree = span_tree(remote, next(sp for sp in remote
                                      if not sp["parent_id"]))

        # A second GPU claim waits while the GPUs are held; a MIG claim
        # finds no MIG device (MIG off: none published).
        def gpu_claim(name, class_name=deviceclasses.GPU_CLASS):
            kube.create(*res, "resourceclaims", {
                "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
                "metadata": {"name": name, "namespace": "default"},
                "spec": {"devices": {"requests": [{
                    "name": "gpu", "exactly": {
                        "deviceClassName": class_name}}]}}},
                namespace="default")
        fillers = [f"smoke-filler-{g}" for g in gpus[1:]]
        for name in fillers:
            gpu_claim(name)
        gpu_claim("smoke-second")
        gpu_claim("smoke-mig", deviceclasses.MIG_CLASS)
        seen = full_passes()
        wait(lambda: (full_passes() or 0) >= seen + 3, 30, "three passes")
        held = [kube.get(*res, "resourceclaims", n, namespace="default")[
            "status"].get("allocation") for n in fillers]
        second = kube.get(*res, "resourceclaims", "smoke-second",
                          namespace="default")
        mig = kube.get(*res, "resourceclaims", "smoke-mig",
                       namespace="default")
        check(all(held) and not second.get("status", {}).get("allocation")
              and not mig.get("status", {}).get("allocation")
              and not any(d.startswith("gpu-0-mig")
                          for d in driver.state.allocatable),
              f"while the GPUs are held: second {second}, mig {mig}")
        # The first claim goes: unprepared, its pod and the claim deleted.
        out = timed("unprepare", driver.unprepare_resource_claims,
                    [{"uid": uid}])
        check(out == {uid: ""}, f"the unprepare {out}")
        kube.delete("", "v1", "pods", "smoke-sched-pod",
                    namespace="default")
        t_deleted = time.perf_counter()
        kube.delete(*res, "resourceclaims", claim_name, namespace="default")
        before = full_passes()
        wait(lambda: ("allocated", "smoke-second") in stamps, 30,
             "the second claim's allocation")
        after = full_passes()
        ms["first_deleted_to_second_allocated"] = round(
            (stamps[("allocated", "smoke-second")] - t_deleted) * 1e3, 3)
        second = kube.get(*res, "resourceclaims", "smoke-second",
                          namespace="default")
        check([r["device"] for r in second["status"]["allocation"][
            "devices"]["results"]] == ["gpu-0"] and after - before <= 2
              and not kube.get(*res, "resourceclaims", "smoke-mig",
                               namespace="default").get("status", {}).get(
                                   "allocation"),
              f"the second claim {second} after {after - before} passes")
        samples = metrics()
        phases = {dict(lb)["phase"]: v for (n, lb), v in samples.items()
                  if n == "tpu_dra_claim_e2e_seconds_count"}
        count = samples[("tpu_dra_sched_sync_seconds_count",
                         (("mode", "full"),))]
        ms["pass_mean"] = round(samples[(
            "tpu_dra_sched_sync_seconds_sum", (("mode", "full"),))]
            / count * 1e3, 3)
        check(count > 0 and phases.get("fit", 0) >= 2
              and phases.get("commit", 0) >= 2
              and phases.get("patch", 0) >= 2,
              f"/metrics: passes {count}, phases {phases}")
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        ms["sigterm_to_exit"] = round((time.perf_counter() - t0) * 1e3, 3)
        with open(f"{tmp}/scheduler.log", encoding="utf-8") as f:
            text = f.read()
        check(rc == 0 and "scheduler running" in text,
              f"the binary exited {rc}: {text[-2000:]}")
        slice_obj = kube.list(*res, "resourceslices")[0]
        driver.stop()
        log(f"scheduler: binary on {card}: a template's claim generated, "
            f"allocated {[r['device'] for r in results]} with CEL "
            f"productName == {product!r} && memory >= 40Gi, reserved for "
            f"and bound to its pod; claim created -> allocated "
            f"{ms['claim_created_to_allocated']} ms, allocated -> bound "
            f"{ms['allocated_to_bound']} ms, allocated -> prepare done "
            f"{ms['allocated_to_prepare_done']} ms; one pass "
            f"{ms['pass_mean']} ms (mean of {int(count)}); the flash "
            f"kernel in the claim's child: {result['launches']} launch, "
            f"max_abs_err {result['max_abs_err']}; trace {ctx.trace_id}: "
            + " / ".join(tree) + " -> " + " / ".join(segments)
            + f"; second claim waited, then allocated "
            f"{ms['first_deleted_to_second_allocated']} ms after the first "
            f"was deleted; the MIG claim stayed pending; /metrics phases "
            f"{phases}; SIGTERM -> exit 0 in {ms['sigterm_to_exit']} ms")

        # -- (b) the fleet, in process.
        t0 = time.perf_counter()
        fleet = _fleet_run(slice_obj, product)
        ms["fleet_phase"] = round((time.perf_counter() - t0) * 1e3, 3)
        held = fleet["held"]
        check(len(held) == len(set(held)) == FLEET_SINGLES
              + FLEET_EIGHTS * FLEET_GPUS
              and fleet["allocated"] == FLEET_SINGLES + FLEET_EIGHTS
              and fleet["pending"] == ["unfit-nine", "unfit-product"]
              and all(len(n) == 1 for n in fleet["eight_nodes"])
              and len(fleet["eight_nodes"]) == FLEET_EIGHTS,
              f"the fleet: {fleet['allocated']} allocated, pending "
              f"{fleet['pending']}, 8-GPU nodes {fleet['eight_nodes']}")
        check(ms["fleet_phase"] < FLEET_BUDGET_S * 1e3,
              f"the fleet took {ms['fleet_phase']} ms")
        log(f"scheduler: fleet of {FLEET_NODES} nodes x {FLEET_GPUS} GPUs "
            f"({FLEET_NODES * FLEET_GPUS} devices, {product!r} cloned from "
            f"this node's slice), {FLEET_SINGLES} one-GPU and "
            f"{FLEET_EIGHTS} eight-GPU claims (matchAttribute "
            f"acceleratorType) and 2 that cannot fit: passes "
            f"{fleet['passes_ms']} ms, {fleet['allocated']} allocated, "
            f"{fleet['claims_per_s']:.1f} claims/s, no device twice, each "
            f"8-GPU claim on one node, pending {fleet['pending']}; setup "
            f"{fleet['setup_ms']} ms, phase {ms['fleet_phase']} ms")
        # The same fleet with the 8-GPU claims at seeded places among the
        # singles: how many the least-loaded spreading strands.
        for shuffle in range(seed, seed + FLEET_SHUFFLES):
            t0 = time.perf_counter()
            mixed = _fleet_run(slice_obj, product, shuffle=shuffle)
            ms[f"fleet_shuffle_{shuffle}"] = round(
                (time.perf_counter() - t0) * 1e3, 3)
            held = mixed["held"]
            placed = FLEET_EIGHTS - mixed["eights_pending"]
            check(len(held) == len(set(held)) == FLEET_SINGLES
                  + placed * FLEET_GPUS
                  and mixed["allocated"] == FLEET_SINGLES + placed
                  and [n for n in mixed["pending"]
                       if not n.startswith("eight")]
                  == ["unfit-nine", "unfit-product"]
                  and all(len(n) == 1 for n in mixed["eight_nodes"])
                  and len(mixed["eight_nodes"]) == placed,
                  f"the fleet, order {shuffle}: {mixed['allocated']} "
                  f"allocated, pending {mixed['pending']}, 8-GPU nodes "
                  f"{mixed['eight_nodes']}")
            log(f"scheduler: the fleet with the 8-GPU claims in seeded "
                f"order {shuffle}: passes {mixed['passes_ms']} ms, "
                f"{mixed['allocated']} allocated, "
                f"{mixed['claims_per_s']:.1f} claims/s, 8-GPU claims "
                f"pending {mixed['eights_pending']} of {FLEET_EIGHTS}, "
                f"every single placed, no device twice; phase "
                f"{ms[f'fleet_shuffle_{shuffle}']} ms")
        passed = True
        return result["launches"]
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        if server is not None:
            server.stop()
        tracing.set_exporter(exporter_before)
        flightrecorder.set_default(recorder_before)
        shutil.rmtree(tmp, ignore_errors=True)
        left = [t.name for t in threading.enumerate()
                if t not in threads_before and t.is_alive()]
        log(f"scheduler: host ms {json.dumps(ms)} on {card}; threads left "
            f"{left}; child alive {proc is not None and proc.poll() is None}")
        if passed:
            check(not left, "a thread outlived the phase")


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
    t_node = time.perf_counter()
    node_child = phase_node_driver(args.seed)
    log(f"node driver: phase 13 in {time.perf_counter() - t_node:.1f} s")
    t_sharing = time.perf_counter()
    mps_children = phase_sharing(args.seed)
    log(f"sharing: phase 14 in {time.perf_counter() - t_sharing:.1f} s")
    t_mig = time.perf_counter()
    mig_child = phase_mig(args.seed)
    log(f"mig: phase 15 in {time.perf_counter() - t_mig:.1f} s")
    t_part = time.perf_counter()
    partition_children = phase_partitions(args.seed)
    log(f"partitions: phase 16 in {time.perf_counter() - t_part:.1f} s")
    t_tenancy = time.perf_counter()
    tenancy_child = phase_tenancy(args.seed)
    log(f"tenancy: phase 17 in {time.perf_counter() - t_tenancy:.1f} s")
    t_cd = time.perf_counter()
    cd_child = phase_compute_domain(args.seed)
    log(f"compute domain: phase 18 in {time.perf_counter() - t_cd:.1f} s")
    t_obs = time.perf_counter()
    phase_observability(args.seed)
    log(f"observability: phase 19 in {time.perf_counter() - t_obs:.1f} s")
    t_sched = time.perf_counter()
    sched_child = phase_scheduler(args.seed)
    log(f"scheduler: phase 20 in {time.perf_counter() - t_sched:.1f} s")
    forward["launches_by_path"] = {
        "serving_generate": serving_launches,
        "training_step": training["forward_lse"],
        "sharded_generate": gang["generate"],
        "sampled_sharded_generate": gang["sampled_generate"],
        "one_row_sharded_generate": gang["one_row_generate"],
        "prepared_claim_child": claim_child,
        "node_driver_claim_child": node_child,
        "mps_children": mps_children,
        "mig_child": mig_child,
        "partition_children": partition_children,
        "tenancy_child": tenancy_child,
        "cd_channel_child": cd_child,
        "scheduler_claim_child": sched_child,
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
