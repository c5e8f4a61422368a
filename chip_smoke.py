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
   a gang of one from a ComputeDomain env (its JSON line) and
   ``train.main --model flagship --batch-size 4 --seq-len 1024`` on a
   token file written from the seed: (a) 2 steps saving a checkpoint at
   step 2 and tracing and (c) 3 steps uninterrupted, these three
   processes at once on the card; then (b) 3 steps resumed from (a)'s
   checkpoint. (b)'s step-3 loss against (c)'s, the checkpoint's bytes
   and save and restore seconds, and a trace that names the flash
   kernels. The checkpoint and the trace are deleted after.
11. entry: ``entry.entry()``'s forward on the card (finite logits);
   ``entry.dryrun_multichip`` over every visible card, which starts its
   own NCCL ranks, and meanwhile over 4 gloo ranks on the host, where
   every family runs on this machine's torch (each family's seconds, or
   its skip), each serving the reference's prompt of a row a rank; and,
   beside those, ``entry.dryrun_multichip_multiprocess`` as one node
   process from a bootstrap.json and members.json written here in the
   ComputeDomain daemon's format.
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
   label kept while the domain lives, and gone after its deletion); with
   ``TPU_DRA_DOCTOR_DIR`` set around the two aborts, exactly one
   ``*-gang-abort.tar.gz`` (the doctor's rate limit) holding the plugin's
   own ``/debug/*`` dumps with the first abort's ``gang_abort`` event,
   its bytes and ms after that event.
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
   k8s_dra_driver_gpu_tpu_torch.pkg.scheduler --metrics-port N``) runs as
   a process in its default mode, events (informers, dirty keys, a full
   resync every ``SCHED_RESYNC_S``). A ResourceClaimTemplate (class
   ``gpu.nvidia.com``, CEL on NVML's ``productName`` and on
   ``capacity.memory`` against ``quantity("40Gi")``) and a pod using it:
   the binary generates the claim, allocates ``gpu-0`` on the node,
   reserves it for the pod and binds the pod; the ``Driver`` prepares it
   through the API lookup and a child under its CDI spec runs the flash
   forward against its plain version (phase 12's child). The claim's
   traceparent is the binary's ``sched.commit`` span (its
   ``/debug/traces``), the prepare's parent, with the segment spans
   below. A second ``gpu.nvidia.com`` claim (after one claim a further
   GPU, none on one card) waits two full passes while the GPU is held and
   a ``mig.nvidia.com`` claim finds no MIG device; once the first claim
   is unprepared and deleted, the second is allocated within two passes.
   ``/metrics`` shows ``tpu_dra_sched_sync_seconds`` for ``full`` and
   ``incremental``, the dirty queue's depth, each informer's relists and
   the queued, fit, commit and patch phases; SIGTERM gives exit 0. Then
   the binary with ``--sched-mode poll --interval 0.1`` claims, binds and
   prepares a second pod's claim from the template: the polled figures
   of the same run. (b) The node's published slice cloned onto 128 nodes
   of 8 GPUs (fresh UUIDs) in the port's in-process ``FakeKubeClient``:
   16 eight-GPU claims (``matchAttribute`` on ``acceleratorType``), 768
   one-GPU claims and 2 that cannot fit (9 GPUs; a product no device
   has), ``sync_once`` until a pass allocates nothing: each pass's ms,
   claims a second, no device twice, every claim that fits allocated,
   each 8-GPU claim on one node, the two pending; then the same with the
   8-GPU claims at seeded places. The same fleet through event mode, at
   one worker and at four with a claim batch of 8
   (``FLEET_EVENT_RUNS``): the 8-GPU claims written and drained, then
   the rest; claims a second from the first write to the last
   ``drain()``; no device twice, the 16 eight-GPU claims placed, the 2
   pending, as many allocated as the polled run. (c) Two event-mode
   schedulers in process as domains ``a`` and ``b`` of 64 of those nodes
   each: 600 one-GPU claims pinned to ``a`` (512 fit, 88 spill to its
   sibling ``b``), then 440 pinned to ``b`` (16 find no room and carry
   ``DomainExhausted``); the spilled and exhausted counters. Host ms
   beside the card's name and power limit.
21. recovery (``phase_recovery``, host clock): the card's telemetry, a
   node failure and a device failure over the port's ``FakeApiServer`` on
   127.0.0.1, with the scheduler binary run with ``--recovery-root``,
   ``--sched-mode poll --interval 0.1`` and short knobs (``TPU_DRA_RECOVERY_NOTREADY_S``,
   ``TPU_DRA_RECOVERY_DEADLINE_S``). One card, two nodes: two kubelet
   plugins, each in a process of its own that never initialises CUDA
   (``RECOVERY_PLUGIN``; NVML's ``chip_telemetry`` refuses beside CUDA),
   publish the same card as ``h100-a`` and ``h100-b`` from their own
   state and CDI roots, with the health monitor's telemetry on. (a) The
   card's quantized telemetry attributes on ``h100-a``'s slice, an idle
   sample and one under the flash kernel's load, the slice writes steady
   samples caused, ``/debug/telemetry`` of the plugin and ``/debug/fleet``
   of the binary, the anomaly kinds that fired. (b) A claim with a
   consumer pod allocated on ``h100-a``, prepared there, its child runs
   the flash kernel (checked against its plain version, then a few
   seconds of launches for load); ``h100-a`` goes NotReady: the binary's
   recovery controller declares the node failed, taints it, sets
   ``PermanentFailure`` on the claim, drains the pod and deallocates; the
   binary re-places the claim on ``h100-b``, whose plugin prepares it,
   and a second child runs the kernel under it; ``h100-a``'s reconcile
   sweep unprepares the claim it lost; the claim ends ``PermanentFailure``
   False ``Recovered``; the eviction record's stages are read from the
   recovery root as they land. (c) ``h100-b``'s monitor escalates
   ``gpu-0`` to the sticky ``failed`` taint (``QuarantineTracker.
   mark_failed``); with ``h100-a`` failed there is nowhere to go, and the
   claim retires cleanly at the deadline (``RecoveryDeadlineExceeded``,
   no allocation, no record), and the binary (``TPU_DRA_DOCTOR_DIR``,
   ``TPU_DRA_DOCTOR_ENDPOINTS`` naming both plugins) drops one
   ``*-eviction-deadline.tar.gz`` with both plugins' ``/metrics`` and
   ``/debug/*`` and no fetch error; then ``pkg.doctor.main`` in this
   process against the three binaries with ``--claim`` (exit 0, the
   claim's events from all three). (d) Phase 20's fleet (the 8-GPU claims
   first) with telemetry attributes on every device and a
   ``FleetAggregator`` folding each pass, then one
   ``EvictionController.sync_once`` with one of the 128 nodes NotReady.
   Host ms of each step beside the card.
22. migration (``phase_migration``, host clock): cooperative live
   migration and defragmentation through the port's ``DraScheduler``
   run in this process every 0.05 s with a ``MigrationController`` and a
   ``DefragController`` attached, over the port's ``FakeApiServer`` and
   phase 21's two plugin processes (the one card as ``h100-a`` and
   ``h100-b``). (a) A claim annotated ``resource.tpu.dra/migration-
   capable`` with a consumer pod, allocated on ``h100-a`` and prepared
   there; child A (``MIGRATION_CHILD``, under the claim's CDI env) holds
   the three training kernels against their plain versions, then trains
   the flagship at full width cut to 2 layers, B=1, S=4096, through
   ``train.cooperative`` for 8 seeded steps, reading its claim (its name
   and the API server's URL from argv) after each. After it logs step 3
   (where it waits for the intent: a step is shorter than the
   handshake) ``h100-a`` is annotated ``resource.tpu.dra/evacuate``: the
   controller reserves ``h100-b``'s GPU and signals; child A saves its
   state with ``TrainCheckpointer``, acks and exits; the switch drains
   the pod and deallocates, the scheduler re-places the claim on
   ``h100-b`` by the hint, ``h100-b``'s plugin prepares it, and child B
   restores and trains steps 4-8, then holds the kernels. Every loss against an uninterrupted
   8-step run in this process, bitwise (the kernels have no atomics;
   the relative difference is logged), the record's stages from the flight recorder, no contract
   annotation and no reservation left, the claim on ``h100-b`` and
   ``h100-a``'s sweep unpreparing it, the children's launches; host ms
   evacuate -> reserved -> intent -> ack -> switched -> allocated ->
   prepared -> restored -> B's first step, the checkpoint's bytes and
   save seconds, the downtime. (b) Two more capable claims pinned to
   ``h100-a`` whose workload never acks, each under a controller of its
   own: with a 0.5 s ack window the move falls back at the ack timeout
   (reservation released, contract cleared, the claim left running);
   with a 0.3 s whole-move deadline it falls back cold (drained,
   deallocated, re-placed). (c) Defrag: one pass over the two GPU pools
   (no ICI coordinates, so no grid and no window), then the checkerboard
   of ``tests/test_defrag.py`` on a 4x4 and a 12x12 coordinated pool in
   the in-process fakes, passes until converged: windows, moves, largest
   free shape before and after, each plan's ms.
23. autoscale (``phase_autoscale``, host clock): the serving autoscaler
   on the H100 node over the port's ``FakeApiServer`` on 127.0.0.1. (a) A
   kubelet plugin in a process that never initialises CUDA
   (``RECOVERY_PLUGIN``) publishes the card as ``h100-a`` with the
   ``DynamicSubSlice`` and ``TenantPartitioning`` gates, no layout file
   (the PartitionSet CRD watcher governs) and a 0.2 s health poll; the
   scheduler binary runs with ``--autoscale-root``, ``--sched-mode poll
   --interval 0.1`` and ``TPU_DRA_AUTOSCALE_SUSTAIN_S=0``, ``TPU_DRA_AUTOSCALE_COOLDOWN_S=0``.
   (b) A whole-GPU claim annotated ``resource.tpu.dra/tenant-profile:
   web`` is allocated by the binary and prepared by the plugin; its child
   (``LOAD_CHILD``, under the claim's CDI env) holds the flash forward
   against its plain version, frees the plain version's tensors and runs
   the kernel for a few seconds; the card's memory used (NVML, the
   plugin's telemetry ring) before the child and at the peak of its
   load gives the demand, beside the whole child's peak and the child's
   ``max_memory_reserved`` through the check and through the load. (c)
   The demand is written as the claim's
   ``resource.tpu.dra/tenant-demand-hbm``: the controller plans
   ``web-s<k>`` (the most slots k whose share of the ``memory`` counter
   still covers it) in one pass, creates the ``tpu-dra-autoscale`` CRD and
   confirms it the next; the watcher refuses it where MIG is off (the
   ``7g.80gb`` backing is no carve-out there: outcome (a), no write) or
   publishes ``pt-web-s<k>-*`` where MIG is on (outcome (b)). Host ms
   from the demand's write to the record planned, the CRD created, the
   rollout confirmed and the watcher's decision; the rollout histogram,
   ``/debug/fleet``'s ``tenant_demand`` and the requests by method. (d)
   Ten further passes write no CRD and no slice; a declared demand of
   3/4 of the ``memory`` counter re-plans at once to ``web-s1``
   (urgent, revision 2); with the CRD's managed flag flipped off the
   passes plan nothing and write nothing. To keep the script within half
   its time limit since this phase came, phase 20 (b) runs one seeded
   order (three before), phase 21 (d) its fleet with the 8-GPU claims
   first (the seeded order before) and phase 22 (c) a 12x12
   checkerboard (16x16 before): host-only depth.

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
import io
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


def bf16_ulp(ref: torch.Tensor) -> float:
    """The bf16 ulp at the largest magnitude of ``ref`` (8 significant
    bits: 2^(e-7) for values in [2^e, 2^(e+1)))."""
    return 2.0 ** (math.floor(math.log2(ref.float().abs().max().item()))
                   - 7)


def hold_with_lse(q, k, v, do, causal: bool) -> dict:
    """The with-lse forward, then the dQ and dK/dV kernels, on one input,
    each against its plain version (phase 3's check of each shape, and
    phase 22's children's). Returns, by output (``forward``, ``lse``,
    ``dq``, ``dk``, ``dv``): ``finite``, ``max_abs_err`` and ``ulps`` (the
    max abs error in bf16 ulps at the reference's largest magnitude);
    ``row_rel``, the forward's worst-row relative L2; and ``rel_l2`` of
    each gradient. The caller holds them to its bounds."""
    from k8s_dra_driver_gpu_tpu_torch.ops.flash_attention import (
        flash_attention, flash_attention_bwd, flash_attention_bwd_reference,
        flash_attention_reference)

    out, lse = flash_attention(q, k, v, causal=causal, with_lse=True)
    want_out, want_lse = flash_attention_reference(q, k, v, causal, True)
    torch.cuda.synchronize()
    diff = (out.float() - want_out.float()).flatten(2)
    r = {"row_rel": (diff.norm(dim=-1) / want_out.float().flatten(2).norm(
             dim=-1).clamp_min(1e-30)).max().item(),
         "finite": {"forward": bool(torch.isfinite(out).all()),
                    "lse": bool(torch.isfinite(lse).all())},
         "max_abs_err": {"forward": diff.abs().max().item(),
                         "lse": (lse - want_lse).abs().max().item()},
         "rel_l2": {}}
    r["ulps"] = {"forward": r["max_abs_err"]["forward"] / bf16_ulp(want_out)}
    del want_out, want_lse, diff
    got = flash_attention_bwd(q, k, v, out, lse, do, causal)
    torch.cuda.synchronize()
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, causal)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        r["finite"][name] = bool(torch.isfinite(a).all())
        r["rel_l2"][name] = rel_l2(a, b)
        r["max_abs_err"][name] = (a.float() - b.float()).abs().max().item()
        r["ulps"][name] = r["max_abs_err"][name] / bf16_ulp(b)
    return r


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
        r = hold_with_lse(q, k, v, do, causal)
        row_rel, errs = r["row_rel"], r["max_abs_err"]
        log(f"kernel with-lse forward {label}: B={B} S={S} H={H} K={K} "
            f"hd={hd} bf16 causal={causal}: out worst-row rel L2 "
            f"{row_rel:.3g} max_abs_err={errs['forward']:.3g} (tol row rel "
            f"L2 {FWD_ROW_REL_TOL}); lse max_abs_err={errs['lse']:.3g} (tol "
            f"{LSE_TOLERANCE})")
        if not (r["finite"]["forward"] and r["finite"]["lse"]
                and row_rel <= FWD_ROW_REL_TOL
                and errs["lse"] <= LSE_TOLERANCE):
            raise AssertionError(f"with-lse forward {label} disagrees with "
                                 "its plain version")
        training = label in ("training", "moe training")
        if training:
            max_err[hd]["forward"] = errs["forward"]
        for name in ("dq", "dk", "dv"):
            rel = r["rel_l2"][name]
            if not (r["finite"][name] and rel <= BWD_REL_TOL):
                raise AssertionError(f"backward {label}: {name} rel L2 "
                                     f"{rel} over {BWD_REL_TOL}")
            kernel = "dq" if name == "dq" else "dkv"
            if training:
                max_err[hd][kernel] = max(max_err[hd][kernel], errs[name])
        bwd = "; ".join(f"{name} rel_l2={r['rel_l2'][name]:.3g} "
                        f"max_abs_err={errs[name]:.3g}"
                        for name in ("dq", "dk", "dv"))
        log(f"kernel backward {label}: B={B} S={S} H={H} K={K} hd={hd} bf16 "
            f"causal={causal}: {bwd} (tol rel L2 {BWD_REL_TOL})")
        del q, k, v, do

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
    process: ``train.verify --require-gang`` as a gang of one, and
    ``train.main`` on the flagship at S=1024 over a token file from the
    seed: (a) 2 steps, a checkpoint at step 2 and a trace, (c) 3 steps
    uninterrupted, these three at once on the card; then (b) 3 steps
    resumed from (a)'s checkpoint."""
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
    def launch(args, extra_env, label):
        t0 = time.perf_counter()
        return (_launch(args, {**env, **extra_env}, label),
                time.perf_counter() - t0)

    try:
        vocab = llama.LlamaConfig.flagship().vocab_size
        data = os.path.join(work, "tokens.bin")
        write_token_file(data, np.random.RandomState(seed).randint(
            0, vocab, LAUNCH_SEQUENCES * LAUNCH_SEQ + 1))
        ckpt, trace = os.path.join(work, "ckpt"), os.path.join(work, "trace")
        common = ["k8s_dra_driver_gpu_tpu_torch.train.main", "--model",
                  "flagship", "--batch-size", str(LAUNCH_BATCH), "--seq-len",
                  str(LAUNCH_SEQ), "--data-file", data]
        runs = {"a": ["--steps", "2", "--checkpoint-dir", ckpt,
                      "--checkpoint-every", "2", "--profile-dir", trace],
                "b": ["--steps", "3", "--checkpoint-dir", ckpt],
                "c": ["--steps", "3"]}
        # verify, (a) and (c) need nothing of one another: one card runs
        # the three processes at once (their starts overlap); (b) resumes
        # from (a)'s checkpoint.
        t_together = time.perf_counter()
        with ThreadPoolExecutor(max_workers=3) as pool:
            verify = pool.submit(
                launch, ["k8s_dra_driver_gpu_tpu_torch.train.verify",
                         "--require-gang"],
                {"TPU_COORDINATOR_ADDRESS": f"127.0.0.1:{free_port()}",
                 "TPU_PROCESS_ID": "0", "TPU_NUM_PROCESSES": "1"}, "verify")
            started = {label: pool.submit(launch, common + runs[label], {},
                                          f"train.main ({label})")
                       for label in ("a", "c")}
            done = {label: f.result() for label, f in started.items()}
            out, verify_s = verify.result()
        together = time.perf_counter() - t_together
        done["b"] = launch(common + runs["b"], {}, "train.main (b)")
        lines = [line for line in out.splitlines() if line.startswith("{")]
        doc = json.loads(lines[0]) if len(lines) == 1 else {}
        log(f"launcher: verify, (a) and (c) at once in {together:.1f} s; "
            f"verify {verify_s:.1f} s of process, printed {len(lines)} JSON "
            f"line(s): "
            f"{json.dumps({k: v for k, v in doc.items() if k != 'env'})}")
        if not (len(lines) == 1 and doc["devSum"] == 1.0
                and doc["rankSum"] == 1.0 and doc["steps"] == 1
                and math.isfinite(float(doc["loss"])) and doc["gang"] is True):
            raise AssertionError(f"verify's proof failed: {lines}")
        logs = {}
        for label in ("a", "b", "c"):
            logs[label], seconds = done[label]
            log(f"launcher: ({label}) "
                f"{' '.join(runs[label]).replace(work + os.sep, '')}: "
                f"{seconds:.1f} s of process; "
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
    daemon-format bootstrap.json, beside the NCCL ranks."""
    import shutil
    import tempfile

    from k8s_dra_driver_gpu_tpu_torch import entry as pt_entry

    def timed(fn, *args, **kwargs):
        t0 = time.perf_counter()
        return fn(*args, **kwargs), time.perf_counter() - t0

    tmp = tempfile.mkdtemp(prefix="entry")
    with ThreadPoolExecutor(max_workers=2) as pool:
        on_host = pool.submit(timed, pt_entry.dryrun_multichip,
                              ENTRY_CPU_RANKS, device="cpu")
        # A node process of its own, beside the NCCL ranks below.
        from_bootstrap = pool.submit(
            timed, pt_entry.dryrun_multichip_multiprocess, n_procs=1,
            local_devices=torch.cuda.device_count(), timeout=300,
            bootstrap_file=_daemon_domain_dir(tmp, free_port()))
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

        try:
            reports, seconds = from_bootstrap.result()
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
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
from k8s_dra_driver_gpu_tpu_torch.pkg.autoscale import crd as pcrd
from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as gpulib

tmp, seed, mode = sys.argv[1], int(sys.argv[2]), sys.argv[3]
RS = ("resource.k8s.io", "v1", "resourceslices")
CRD = (pcrd.AUTOSCALE_CRD_GROUP, pcrd.AUTOSCALE_CRD_VERSION,
       pcrd.AUTOSCALE_CRD_RESOURCE)
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
            server.store.create(*CRD, pcrd.crd_object(
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


@contextlib.contextmanager
def scoped_env(**values):
    """Set each of ``values`` in this process's env (unset it for None)
    for the block, and restore what was there after."""
    import os

    before = {name: os.environ.get(name) for name in values}
    try:
        for name, value in values.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value
        yield
    finally:
        for name, value in before.items():
            if value is None:
                os.environ.pop(name, None)
            else:
                os.environ[name] = value


def doctor_bundle(directory: str, trigger: str, timeout: float,
                  what: str) -> tuple[str, dict, dict, dict, list]:
    """Wait for the incident bundle ``*-<trigger>.tar.gz`` in
    ``directory`` (renamed into place whole, so one that exists is
    complete) and for this process's ``doctor-bundle`` threads; its path,
    its members (name -> bytes), its report and manifest, and every
    bundle of the directory."""
    import glob
    import os
    import tarfile
    import threading

    pattern = os.path.join(directory, f"*-{trigger}.tar.gz")
    deadline = time.monotonic() + timeout
    while not glob.glob(pattern):
        if time.monotonic() > deadline:
            raise AssertionError(f"{what}: no {trigger} bundle in "
                                 f"{directory} after {timeout} s")
        time.sleep(0.01)
    for thread in threading.enumerate():
        if thread.name == "doctor-bundle":
            thread.join(timeout)
    found = sorted(glob.glob(os.path.join(directory, "*.tar.gz")))
    path = glob.glob(pattern)[0]
    with tarfile.open(path) as tar:
        members = {m.name: tar.extractfile(m).read() for m in tar
                   if m.isfile()}
    return (path, members, json.loads(members.get("report.json", b"{}")),
            json.loads(members.get("manifest.json", b"{}")), found)


# The members every automatic bundle holds: the calling binary's own
# surfaces, dumped without HTTP, and the report and manifest.
DOCTOR_LOCAL = ("local/debug/traces.json", "local/debug/claims.json",
                "local/debug/stacks.txt", "local/debug/telemetry.json",
                "local/debug/fleet.json", "report.json", "manifest.json")


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
    from k8s_dra_driver_gpu_tpu_torch.pkg import (doctor, flightrecorder,
                                                  tracing)
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

        # A domain whose second node never comes, on the second node,
        # with the incident bundles on: one for its two aborts (the
        # doctor's rate limit at its default).
        cd2 = make_cd("smoke-cd2", 2)
        uid2 = cd2["metadata"]["uid"]
        driver_b = CDDriver(state_b, kube, CD_NODE_B,
                            retry_timeout=CD_ABORT_DEADLINE_S)
        ref2 = put_claim("smoke-cd2-channel", "default", "channel-0",
                         "ComputeDomainChannelConfig", uid2)
        doctor.reset_rate_limit()
        with scoped_env(**{doctor.ENV_DOCTOR_DIR: f"{tmp}/doctor",
                           doctor.ENV_DOCTOR_ENDPOINTS: None,
                           doctor.ENV_DOCTOR_MIN_INTERVAL: None}):
            errors = [timed(f"abort_{i}", driver_b.prepare_resource_claims,
                            [ref2])[ref2["uid"]][1] for i in range(2)]
        path, members, report, manifest, found = doctor_bundle(
            f"{tmp}/doctor", "gang-abort", 30, "compute domain")
        aborts = [e for e in recorder.events(ref2["uid"])
                  if e["event"] == "gang_abort"]
        bundled = [e for e in json.loads(
            members.get("local/debug/claims.json", b"{}")).get("events", [])
            if e["key"] == ref2["uid"] and e["event"] == "gang_abort"]
        ms["abort_to_bundle"] = round(
            (os.stat(path).st_mtime - aborts[0]["ts"]) * 1e3, 3)
        log(f"compute domain: {len(found)} incident bundle(s) for "
            f"{len(aborts)} aborts: {os.path.basename(path)}, "
            f"{os.path.getsize(path)} bytes, "
            f"{ms['abort_to_bundle']} ms after the first abort's event; "
            f"members {sorted(members)}; its gang_abort events of "
            f"{ref2['uid']}: {len(bundled)}; trigger {manifest.get('trigger')}"
            f", focus {report.get('focus_claim')}, fetch errors "
            f"{manifest.get('errors')}")
        check(len(found) == 1 and len(aborts) == 2
              and set(DOCTOR_LOCAL) <= set(members) and len(bundled) == 1
              and manifest.get("trigger") == "gang-abort"
              and report.get("focus_claim") == ref2["uid"],
              "the gang abort's incident bundle")
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
# the singles (after the ``--seed`` offset); one since phase 23 came, to
# keep the script within half its time limit (three before).
FLEET_SHUFFLES = 1


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


def _fleet_store(real: dict, shuffle: int | None = None,
                 fleet_metrics=None):
    """20 (b)'s fleet in the port's in-process ``FakeKubeClient``: the
    DeviceClasses and ``real`` cloned onto ``FLEET_NODES`` nodes; with
    ``fleet_metrics`` every device also carries telemetry attributes
    drawn from the ``shuffle`` seed and each node is a Ready Node. The
    store and its setup ms."""
    import random

    from k8s_dra_driver_gpu_tpu_torch.api import deviceclasses
    from k8s_dra_driver_gpu_tpu_torch.pkg import fleetstate
    from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import FakeKubeClient

    kube = FakeKubeClient()
    deviceclasses.create_all(kube)
    nodes = [f"hgx-{n:03d}" for n in range(FLEET_NODES)]
    t0 = time.perf_counter()
    rng = random.Random(shuffle)
    for s in _fleet_slices(real, nodes):
        if fleet_metrics is not None:
            for dev in s["spec"]["devices"]:
                dev["attributes"].update({
                    fleetstate.ATTR_POWER: {"int": rng.randrange(7, 71) * 10},
                    fleetstate.ATTR_TEMP: {"int": rng.randrange(6, 17) * 5},
                    fleetstate.ATTR_DUTY: {"int": rng.randrange(0, 11) * 10},
                    fleetstate.ATTR_HBM: {"int": rng.randrange(0, 11) * 10},
                    fleetstate.ATTR_ICI_ERR: {"int": 0}})
            kube.create("", "v1", "nodes", {
                "metadata": {"name": s["spec"]["nodeName"]},
                "status": {"conditions": [{"type": "Ready",
                                           "status": "True"}]}})
        kube.create("resource.k8s.io", "v1", "resourceslices", s)
    return kube, round((time.perf_counter() - t0) * 1e3, 3)


def _fleet_claim(kube, name, count=1, cel=None, constraint=None,
                 namespace="fleet", annotations=None):
    from k8s_dra_driver_gpu_tpu_torch.api import deviceclasses

    exactly = {"deviceClassName": deviceclasses.GPU_CLASS}
    if count != 1:
        exactly["count"] = count
    if cel:
        exactly["selectors"] = [{"cel": {"expression": cel}}]
    devices = {"requests": [{"name": "gpu", "exactly": exactly}]}
    if constraint:
        devices["constraints"] = [{"matchAttribute": constraint}]
    md = {"name": name, "namespace": namespace}
    if annotations:
        md["annotations"] = dict(annotations)
    kube.create("resource.k8s.io", "v1", "resourceclaims", {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
        "metadata": md, "spec": {"devices": devices}}, namespace=namespace)


def _fleet_claims(kube, shuffle: int | None = None,
                  which=lambda count: True) -> None:
    """The fleet's claims, those whose GPU count ``which`` admits: the
    8-GPU ones first, or at the places the ``shuffle`` seed gives them
    among the singles, then the two that cannot fit (with the singles)."""
    import random

    # A pass takes the claims in creation order and puts each on the
    # least-loaded node it fits, so the singles land on empty nodes while
    # there are any: 8-GPU claims first all fit, and one that comes after
    # (FLEET_NODES - the 8-GPU claims placed) singles finds no node free.
    kinds = [FLEET_GPUS] * FLEET_EIGHTS + [1] * FLEET_SINGLES
    if shuffle is not None:
        random.Random(shuffle).shuffle(kinds)
    made = collections.Counter()
    for count in kinds:
        if which(count):
            if count == 1:
                _fleet_claim(kube, f"one-{made[count]:03d}")
            else:
                _fleet_claim(kube, f"eight-{made[count]:02d}", FLEET_GPUS,
                             constraint="gpu.nvidia.com/acceleratorType")
        made[count] += 1
    if which(1):
        _fleet_claim(kube, "unfit-nine", FLEET_GPUS + 1)
        _fleet_claim(kube, "unfit-product",
                     cel='device.attributes["gpu.nvidia.com"]'
                     '.productName == "NVIDIA B200"')


def _fleet_outcome(kube) -> dict:
    """What the fleet's checks read: the devices held, the pending
    claims, the nodes of each placed 8-GPU claim."""
    claims = kube.list("resource.k8s.io", "v1", "resourceclaims")
    held = [(r["pool"], r["device"]) for c in claims
            for r in (c.get("status", {}).get("allocation") or {}).get(
                "devices", {}).get("results", [])]
    pending = sorted(c["metadata"]["name"] for c in claims
                     if not c.get("status", {}).get("allocation"))
    eight_nodes = [{r["pool"] for r in c["status"]["allocation"]["devices"][
        "results"]} for c in claims if c["metadata"]["name"].startswith(
            "eight") and c.get("status", {}).get("allocation")]
    return {"allocated": len(claims) - len(pending), "held": held,
            "pending": pending, "eight_nodes": eight_nodes,
            "eights_pending": sum(n.startswith("eight") for n in pending)}


def _fleet_run(real: dict, product: str, shuffle: int | None = None,
               fleet_metrics=None) -> dict:
    """20 (b), polled: the fleet's store and claims, then passes of the
    port's ``DraScheduler`` until one allocates nothing. The claims arrive
    8-GPU first, or in the order ``shuffle`` seeds. With
    ``fleet_metrics`` (phase 21 (d)) the store carries telemetry and
    Ready Nodes and the scheduler folds its fleet into that sink; the
    result then holds the store and the scheduler."""
    from k8s_dra_driver_gpu_tpu_torch.pkg.scheduler import DraScheduler

    kube, setup_ms = _fleet_store(real, shuffle, fleet_metrics)
    _fleet_claims(kube, shuffle)
    sched = DraScheduler(kube, fleet_metrics=fleet_metrics)
    passes, allocated = [], 0
    while True:
        t0 = time.perf_counter()
        sched.sync_once()
        passes.append(round((time.perf_counter() - t0) * 1e3, 3))
        now = _fleet_outcome(kube)["allocated"]
        if now == allocated:
            break
        allocated = now
        if len(passes) > 10:
            raise AssertionError(f"scheduler fleet: {passes} passes")
    out = dict(_fleet_outcome(kube), setup_ms=setup_ms, passes_ms=passes,
               product=product,
               claims_per_s=allocated / (sum(passes[:-1]) / 1e3)
               if len(passes) > 1 else 0.0)
    if fleet_metrics is not None:
        out.update(kube=kube, sched=sched)
    return out


# 20 (b)'s event runs: (workers, claim batch).
FLEET_EVENT_RUNS = ((1, 8), (4, 8))


def _fleet_run_events(real: dict, workers: int, batch: int) -> dict:
    """20 (b) through event mode: the port's ``DraScheduler`` started
    event-driven on the fleet's store, then its claims written, the
    8-GPU ones first and drained (a pass takes them first too), then the
    singles and the two that cannot fit, drained. Claims a second run
    from the first claim's write to the last ``drain()``."""
    from k8s_dra_driver_gpu_tpu_torch.pkg.exposition import generate_latest
    from k8s_dra_driver_gpu_tpu_torch.pkg.metrics import SchedulerMetrics
    from k8s_dra_driver_gpu_tpu_torch.pkg.scheduler import DraScheduler

    kube, setup_ms = _fleet_store(real)
    metrics = SchedulerMetrics()
    sched = DraScheduler(kube, workers=workers, batch_max=batch,
                         sched_metrics=metrics)
    try:
        t0 = time.perf_counter()
        sched.start_event_driven()
        if not sched.drain(FLEET_BUDGET_S):
            raise AssertionError("scheduler fleet: the first pass did not "
                                 "drain")
        start_ms = round((time.perf_counter() - t0) * 1e3, 3)
        t0 = time.perf_counter()
        _fleet_claims(kube, which=lambda count: count > 1)
        drained = sched.drain(FLEET_BUDGET_S)
        eights_s = time.perf_counter() - t0
        _fleet_claims(kube, which=lambda count: count == 1)
        drained = drained and sched.drain(FLEET_BUDGET_S)
        seconds = time.perf_counter() - t0
    finally:
        sched.stop()
    if not drained:
        raise AssertionError(f"scheduler fleet: workers {workers} did not "
                             "drain")
    out = _fleet_outcome(kube)
    samples = metric_samples(generate_latest(metrics.registry).decode())
    out.update(setup_ms=setup_ms, start_ms=start_ms,
               eights_ms=round(eights_s * 1e3, 3),
               seconds=round(seconds, 6),
               claims_per_s=out["allocated"] / seconds,
               incremental=samples.get((
                   "tpu_dra_sched_sync_seconds_count",
                   (("mode", "incremental"),)), 0.0),
               steals=samples.get(("tpu_dra_workqueue_steals_total", ()),
                                  0.0),
               conflicts=samples.get((
                   "tpu_dra_sched_commit_conflicts_total", ()), 0.0))
    return out


# 20 (c): two domains of DOMAIN_NODES nodes each; claims pinned to the
# first beyond its GPUs spill to the second, claims pinned to the second
# beyond what is left of it stay pending, exhausted.
DOMAIN_NODES = FLEET_NODES // 2
DOMAIN_A_CLAIMS = DOMAIN_NODES * FLEET_GPUS + 88
DOMAIN_B_CLAIMS = DOMAIN_NODES * FLEET_GPUS - 88 + 16


def _domain_run(real: dict) -> dict:
    """20 (c), host only: the fleet's store split into domains ``a`` (the
    first ``DOMAIN_NODES`` pools, sibling ``b``) and ``b`` (the rest, the
    default domain), an event-mode ``DraScheduler`` for each in this
    process; ``DOMAIN_A_CLAIMS`` one-GPU claims pinned to ``a``, drained,
    then ``DOMAIN_B_CLAIMS`` pinned to ``b``, drained."""
    from k8s_dra_driver_gpu_tpu_torch.pkg.exposition import generate_latest
    from k8s_dra_driver_gpu_tpu_torch.pkg.metrics import SchedulerMetrics
    from k8s_dra_driver_gpu_tpu_torch.pkg.schedcache import (
        DOMAIN_ANNOTATION, SPILLED_FROM_ANNOTATION, SchedulingDomain)
    from k8s_dra_driver_gpu_tpu_torch.pkg.scheduler import DraScheduler

    kube, _ = _fleet_store(real)
    pools = {"a": [f"hgx-{n:03d}" for n in range(DOMAIN_NODES)],
             "b": [f"hgx-{n:03d}" for n in range(DOMAIN_NODES,
                                                   FLEET_NODES)]}
    doms = {"a": SchedulingDomain("a", pools=pools["a"], siblings=[
        SchedulingDomain("b", pools=pools["b"])]),
        "b": SchedulingDomain("b", pools=pools["b"], default=True)}
    metrics = {d: SchedulerMetrics() for d in doms}
    scheds = {d: DraScheduler(kube, domain=doms[d],
                              sched_metrics=metrics[d]) for d in doms}
    ms = {}
    try:
        for s in scheds.values():
            s.start_event_driven()
        for d, n in (("a", DOMAIN_A_CLAIMS), ("b", DOMAIN_B_CLAIMS)):
            t0 = time.perf_counter()
            for i in range(n):
                _fleet_claim(kube, f"{d}-{i:03d}", namespace="domains",
                             annotations={DOMAIN_ANNOTATION: d})
            if not all(s.drain(FLEET_BUDGET_S) for s in scheds.values()):
                raise AssertionError(f"domains: {d} did not drain")
            # A spill's own event may reach the sibling after its drain.
            if not all(s.drain(FLEET_BUDGET_S) for s in scheds.values()):
                raise AssertionError(f"domains: {d} did not drain")
            ms[d] = round((time.perf_counter() - t0) * 1e3, 3)
    finally:
        for s in scheds.values():
            s.stop()
    claims = kube.list("resource.k8s.io", "v1", "resourceclaims")
    out = {"ms": ms, "held": [], "placed": collections.Counter(),
           "pending": [], "exhausted_conditions": 0, "spilled_marked": 0}
    for c in claims:
        name = c["metadata"]["name"]
        ann = c["metadata"].get("annotations") or {}
        results = (c.get("status", {}).get("allocation") or {}).get(
            "devices", {}).get("results", [])
        out["held"] += [(r["pool"], r["device"]) for r in results]
        for r in results:
            side = "a" if r["pool"] in pools["a"] else "b"
            out["placed"][(name[0], side)] += 1
        if not results:
            out["pending"].append(name)
        out["spilled_marked"] += ann.get(SPILLED_FROM_ANNOTATION) == "a"
        out["exhausted_conditions"] += any(
            x.get("type") == "DomainExhausted" and x.get("status") == "True"
            for x in c.get("status", {}).get("conditions") or [])
    samples = {d: metric_samples(generate_latest(
        metrics[d].registry).decode()) for d in doms}
    out["spilled"] = samples["a"].get((
        "tpu_dra_sched_domain_spilled_total",
        (("from_domain", "a"), ("to_domain", "b"))), 0.0)
    out["exhausted"] = {d: sum(v for (n, _), v in samples[d].items()
                               if n == "tpu_dra_sched_domain_exhausted_total")
                        for d in doms}
    out["placed"] = {f"{k[0]}->{k[1]}": v for k, v in
                     sorted(out["placed"].items())}
    return out


# Phase 20 (a): the event-mode binary's safety resync, seconds.
SCHED_RESYNC_S = 0.5


def _polled_binary_claim(kube, driver, url, env, root, tmp, stamps,
                         leftovers) -> dict:
    """20 (a)'s polled figures in the same run: the ``leftovers`` claims
    deleted, the binary started with ``--sched-mode poll --interval
    0.1``, a second pod from the template claimed, bound and its claim
    prepared (no child), then unprepared and deleted; SIGTERM, exit 0.
    Host ms created -> allocated -> bound, allocated -> prepare done."""
    import signal

    res = ("resource.k8s.io", "v1")
    for name in leftovers:
        with contextlib.suppress(Exception):
            kube.delete(*res, "resourceclaims", name, namespace="default")
    port = free_port()
    base = f"http://127.0.0.1:{port}"
    with open(f"{tmp}/scheduler-poll.log", "w", encoding="utf-8") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", SCHEDULER_MAIN, "--kube-api", url,
             "--sched-mode", "poll", "--interval", "0.1",
             "--metrics-port", str(port)], env=env, cwd=root,
            stdin=subprocess.DEVNULL, stdout=out, stderr=subprocess.STDOUT)
    try:
        def wait(fn, what):
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                with contextlib.suppress(OSError):
                    value = fn()
                    if value:
                        return value
                time.sleep(0.005)
            raise AssertionError(f"scheduler: timed out waiting for {what}")
        wait(lambda: metric_samples(_http_get(base + "/metrics")).get((
            "tpu_dra_sched_sync_seconds_count", (("mode", "full"),))),
            "the polled binary's first pass")
        kube.create("", "v1", "pods", {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "smoke-poll-pod", "namespace": "default"},
            "spec": {"containers": [{"name": "main"}],
                     "resourceClaims": [{
                         "name": "gpu",
                         "resourceClaimTemplateName": "smoke-gpu"}]}},
            namespace="default")
        pod = wait(lambda: (lambda p: p if p["spec"].get("nodeName")
                            else None)(kube.get("", "v1", "pods",
                                                "smoke-poll-pod",
                                                namespace="default")),
                   "the polled pod's binding")
        (status,) = pod["status"]["resourceClaimStatuses"]
        name = status["resourceClaimName"]
        claim = kube.get(*res, "resourceclaims", name, namespace="default")
        uid = claim["metadata"]["uid"]
        out = driver.prepare_resource_claims(
            [{"uid": uid, "namespace": "default", "name": name}])
        prepared_at = time.perf_counter()
        if out[uid][1] != "":
            raise AssertionError(f"scheduler: the polled prepare {out}")
        if driver.unprepare_resource_claims([{"uid": uid}]) != {uid: ""}:
            raise AssertionError("scheduler: the polled unprepare")
        kube.delete("", "v1", "pods", "smoke-poll-pod", namespace="default")
        kube.delete(*res, "resourceclaims", name, namespace="default")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        if rc != 0:
            raise AssertionError(f"scheduler: the polled binary exited {rc}")
        return {"claim_created_to_allocated": round(
                    (stamps[("allocated", name)] - stamps[("created", name)])
                    * 1e3, 3),
                "allocated_to_bound": round(
                    (stamps[("bound", "smoke-poll-pod")]
                     - stamps[("allocated", name)]) * 1e3, 3),
                "allocated_to_prepare_done": round(
                    (prepared_at - stamps[("allocated", name)]) * 1e3, 3)}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


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
        # The binary's default mode, events; its safety resync every
        # SCHED_RESYNC_S, so the waits below can count full passes.
        env.update({"PYTHONPATH": root, "TPU_DRA_DEBUG_HTTP": "1",
                    "TPU_DRA_SCHED_RESYNC": str(SCHED_RESYNC_S)})
        with open(f"{tmp}/scheduler.log", "w", encoding="utf-8") as out:
            t0 = time.perf_counter()
            proc = subprocess.Popen(
                [sys.executable, "-m", SCHEDULER_MAIN, "--kube-api",
                 server.url, "--metrics-port", str(port)], env=env,
                cwd=root, stdin=subprocess.DEVNULL, stdout=out,
                stderr=subprocess.STDOUT)
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
        # Two full passes after the writes: each claim has been tried.
        seen = full_passes()
        wait(lambda: (full_passes() or 0) >= seen + 2, 30, "two passes")
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
        sync = {mode: (samples.get(("tpu_dra_sched_sync_seconds_count",
                                    (("mode", mode),)), 0.0),
                       samples.get(("tpu_dra_sched_sync_seconds_sum",
                                    (("mode", mode),)), 0.0))
                for mode in ("full", "incremental")}
        count = sync["full"][0]
        ms["pass_mean"] = round(sync["full"][1] / count * 1e3, 3)
        ms["incremental_mean"] = round(
            sync["incremental"][1] / max(sync["incremental"][0], 1) * 1e3,
            3)
        relists = {dict(lb)["resource"]: v for (n, lb), v in samples.items()
                   if n == "tpu_dra_informer_relist_total"}
        depth = samples.get(("tpu_dra_sched_dirty_queue_depth", ()))
        check(count > 0 and sync["incremental"][0] > 0
              and phases.get("queued", 0) >= 1
              and phases.get("fit", 0) >= 2
              and phases.get("commit", 0) >= 2
              and phases.get("patch", 0) >= 2
              and len(relists) == 10 and depth is not None and depth <= 1,
              f"/metrics: sync {sync}, phases {phases}, relists {relists}, "
              f"dirty depth {depth}")
        t0 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        ms["sigterm_to_exit"] = round((time.perf_counter() - t0) * 1e3, 3)
        with open(f"{tmp}/scheduler.log", encoding="utf-8") as f:
            text = f.read()
        check(rc == 0 and "scheduler running" in text,
              f"the binary exited {rc}: {text[-2000:]}")
        log(f"scheduler: event-mode binary on {card}: "
            f"tpu_dra_sched_sync_seconds full {sync['full'][0]:.0f} passes "
            f"(mean {ms['pass_mean']} ms), incremental "
            f"{sync['incremental'][0]:.0f} dirty-key drains (mean "
            f"{ms['incremental_mean']} ms); dirty queue depth {depth}; "
            f"informer relists {relists}")
        polled = _polled_binary_claim(kube, driver, server.url, env, root,
                                      tmp, stamps, ["smoke-second",
                                                    "smoke-mig", *fillers])
        ms.update({f"polled_{k}": v for k, v in polled.items()})
        slice_obj = kube.list(*res, "resourceslices")[0]
        driver.stop()
        log(f"scheduler: binary on {card}: a template's claim generated, "
            f"allocated {[r['device'] for r in results]} with CEL "
            f"productName == {product!r} && memory >= 40Gi, reserved for "
            f"and bound to its pod; event mode (polled binary, "
            f"--interval 0.1, in this run): claim created -> allocated "
            f"{ms['claim_created_to_allocated']} "
            f"({ms['polled_claim_created_to_allocated']}) ms, allocated -> "
            f"bound {ms['allocated_to_bound']} "
            f"({ms['polled_allocated_to_bound']}) ms, allocated -> prepare "
            f"done {ms['allocated_to_prepare_done']} "
            f"({ms['polled_allocated_to_prepare_done']}) ms; one pass "
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
        # The same fleet fed through event mode.
        for workers, batch in FLEET_EVENT_RUNS:
            t0 = time.perf_counter()
            ev = _fleet_run_events(slice_obj, workers, batch)
            ms[f"fleet_events_w{workers}"] = round(
                (time.perf_counter() - t0) * 1e3, 3)
            held = ev["held"]
            check(len(held) == len(set(held)) == FLEET_SINGLES
                  + FLEET_EIGHTS * FLEET_GPUS
                  and ev["allocated"] == fleet["allocated"]
                  and ev["pending"] == ["unfit-nine", "unfit-product"]
                  and all(len(n) == 1 for n in ev["eight_nodes"])
                  and len(ev["eight_nodes"]) == FLEET_EIGHTS,
                  f"the fleet in event mode, workers {workers}: "
                  f"{ev['allocated']} allocated, pending {ev['pending']}, "
                  f"8-GPU nodes {ev['eight_nodes']}")
            log(f"scheduler: the fleet in event mode, workers {workers}, "
                f"batch {batch}: {ev['allocated']} allocated in "
                f"{ev['seconds']} s from the first claim's write to the "
                f"last drain (the 8-GPU claims drained in "
                f"{ev['eights_ms']} ms), {ev['claims_per_s']:.1f} claims/s "
                f"(polled 8-GPU-first: {fleet['claims_per_s']:.1f}); "
                f"{ev['incremental']:.0f} dirty-key drains, "
                f"{ev['steals']:.0f} keys stolen, {ev['conflicts']:.0f} "
                f"commit conflicts; every 8-GPU claim on one node, pending "
                f"{ev['pending']}, no device twice; start {ev['start_ms']} "
                f"ms, phase {ms[f'fleet_events_w{workers}']} ms on {card}")
        # -- (c) two domains with spillover, in process.
        t0 = time.perf_counter()
        dom = _domain_run(slice_obj)
        ms["domains_phase"] = round((time.perf_counter() - t0) * 1e3, 3)
        spill = DOMAIN_A_CLAIMS - DOMAIN_NODES * FLEET_GPUS
        short = DOMAIN_B_CLAIMS - (DOMAIN_NODES * FLEET_GPUS - spill)
        check(len(dom["held"]) == len(set(dom["held"]))
              and dom["placed"] == {"a->a": DOMAIN_NODES * FLEET_GPUS,
                                    "a->b": spill,
                                    "b->b": DOMAIN_B_CLAIMS - short}
              and len(dom["pending"]) == short
              and all(n.startswith("b-") for n in dom["pending"])
              and dom["spilled"] == spill
              and dom["spilled_marked"] == spill
              and dom["exhausted_conditions"] == short
              and dom["exhausted"]["b"] >= short
              and dom["exhausted"]["a"] == 0,
              f"the domains: {json.dumps({k: v for k, v in dom.items() if k != 'held'})}")
        log(f"scheduler: two domains of {DOMAIN_NODES} nodes x {FLEET_GPUS} "
            f"GPUs, an event-mode scheduler each in process: "
            f"{DOMAIN_A_CLAIMS} claims pinned to a, {DOMAIN_B_CLAIMS} to b; "
            f"placed {dom['placed']}; spilled a -> b {dom['spilled']:.0f} "
            f"(tpu_dra_sched_domain_spilled_total), exhausted "
            f"{ {d: int(v) for d, v in dom['exhausted'].items()} } "
            f"(tpu_dra_sched_domain_exhausted_total), "
            f"{len(dom['pending'])} pending with DomainExhausted, no device "
            f"twice; ms {dom['ms']}, phase {ms['domains_phase']} ms on "
            f"{card}")
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


# Phase 21's kubelet plugin, in a process of its own that never
# initialises CUDA (NVML's chip_telemetry refuses beside it): the node
# service over the real NVML with its health monitor and telemetry on,
# over the port's fake API server, its metrics and debug routes on a
# loopback port. A fifth argument names feature gates to turn on (phase
# 23's partition gates): the node then starts from an empty bootstrap
# plan, and the PartitionSet CRD watcher governs. It writes one JSON line
# when it has published, then answers one line on stdin with one JSON
# line on stdout: "prepare UID NAMESPACE NAME" (the result and the
# claim's CDI spec), "prepared" (the prepared uids and the last sweep),
# "fail DEVICE" (the quarantine tracker's permanent escalation, the
# sweep's path), "refusals" (what NVML refused the monitor's library),
# "watch" (with a watcher: each of its decisions and its counts), "stop".
RECOVERY_PLUGIN = r"""
import json, sys, time
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.device_state import Config
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.driver import Driver
from k8s_dra_driver_gpu_tpu_torch.pkg.featuregates import FeatureGates
from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import KubeClient
from k8s_dra_driver_gpu_tpu_torch.pkg.metrics import (
    DRARequestMetrics, MetricsServer, RecoveryMetrics, ResilienceMetrics)
from k8s_dra_driver_gpu_tpu_torch.pkg.partition import PartitionSet
from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as gpulib

url, node, root, port = sys.argv[1], sys.argv[2], sys.argv[3], int(sys.argv[4])
gates = sys.argv[5] if len(sys.argv) > 5 else ""


def emit(**doc):
    print(json.dumps(doc), flush=True)


partitions = {} if not gates else dict(
    feature_gates=FeatureGates.parse(gates), partition_set=PartitionSet(),
    pool_name=node)
metrics = DRARequestMetrics()
driver = Driver(Config(root=f"{root}/state", cdi_root=f"{root}/cdi",
                       **partitions), KubeClient(host=url), node,
                metrics=metrics,
                resilience=ResilienceMetrics(registry=metrics.registry),
                recovery_metrics=RecoveryMetrics(registry=metrics.registry))
server = MetricsServer(metrics.registry, port=port)
server.start()
driver.start()
watcher = driver.partition_watcher
decisions = []
if watcher is not None:
    _reconcile = watcher.reconcile

    def reconcile():
        applied = _reconcile()
        decisions.append({"ts": time.time(), "applied": applied,
                          "applied_total": watcher.applied_total,
                          "failed_total": watcher.failed_total,
                          "last_error": watcher.last_error})
        return applied

    watcher.reconcile = reconcile
emit(ready=True, cuda=gpulib.cuda_initialised(),
     mig_mode=driver.state.host.mig_mode,
     devices=sorted(driver.state.allocatable))
try:
    for line in sys.stdin:
        cmd, *args = line.split()
        if cmd == "prepare":
            uid, ns, name = args
            out = driver.prepare_resource_claims(
                [{"uid": uid, "namespace": ns, "name": name}])
            emit(result=out[uid], spec=driver.state._cdi.read_spec(uid))
        elif cmd == "prepared":
            emit(prepared=sorted(driver.state.prepared_claims()),
                 sweep=driver.reconciler.last_sweep)
        elif cmd == "fail":
            driver.health_monitor.quarantine.mark_failed(args[0])
            emit(failed=sorted(driver.health_monitor.quarantine.failed))
        elif cmd == "refusals":
            emit(refusals=driver.health_monitor._tpulib.refusals,
                 cuda=gpulib.cuda_initialised())
        elif cmd == "watch":
            emit(decisions=decisions, reconciles=watcher.reconciles,
                 applied_total=watcher.applied_total,
                 failed_total=watcher.failed_total,
                 last_error=watcher.last_error,
                 partitions=sorted(n for n in driver.state.allocatable
                                   if n.startswith("pt-")),
                 tenant_profiles=driver.tenant_profiles.tenants(),
                 cuda=gpulib.cuda_initialised())
        elif cmd == "stop":
            break
finally:
    driver.stop()
    server.stop()
"""

LOAD_S = 4.0
# Phase 12's claim child, then LOAD_S seconds of the same launches as
# load (phase 21's telemetry, phase 23's serving tenant). The plain
# version's tensors are freed and the allocator's peak reset before the
# load, so the load's memory is its own; the last line adds
# ``load_launches`` (``launches`` stays the one checked launch), the
# load's start on the host clock (``load_start``, time.time()) and the
# allocator's peak reservation through the check and through the load.
LOAD_CHILD = CLAIM_CHILD + f"""
import time
max_abs_err, finite = diff.max().item(), bool(torch.isfinite(got).all())
check_reserved = torch.cuda.max_memory_reserved()
del want, diff
torch.cuda.empty_cache()
torch.cuda.reset_peak_memory_stats()
flash_attention.launches = 0
load_start = time.time()
t_end = time.monotonic() + {LOAD_S}
while time.monotonic() < t_end:
    for _ in range(20):
        flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
print(json.dumps({{"device_count": count, "name": name,
                  "launches": launches, "max_abs_err": max_abs_err,
                  "excess": excess, "mapped": mapped, "finite": finite,
                  "load_launches": flash_attention.launches,
                  "load_start": load_start,
                  "check_memory_reserved": check_reserved,
                  "load_memory_reserved": torch.cuda.max_memory_reserved()}}))
"""

RECOVERY_NODES = ("h100-a", "h100-b")
RECOVERY_NOTREADY_S = 0.5
RECOVERY_DEADLINE_S = 3.0
RECOVERY_POLL_S = 0.25
RECOVERY_SWEEP_S = 0.5
RECOVERY_CLAIM = "smoke-recovery"


class RecoveryPlugin:
    """``RECOVERY_PLUGIN`` for one node, with ``gates`` turned on:
    ``ask(line)`` writes a command and reads its JSON answer."""

    def __init__(self, url: str, node: str, root: str, port: int,
                 env: dict, cwd: str, gates: str = ""):
        self.node, self.port = node, port
        self.log = open(f"{root}.log", "w", encoding="utf-8")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", RECOVERY_PLUGIN, url, node, root,
             str(port)] + ([gates] if gates else []), env=env, cwd=cwd,
            stdin=subprocess.PIPE,
            stdout=subprocess.PIPE, stderr=self.log, text=True)
        self.ready = self._read()

    def _read(self) -> dict:
        line = self.proc.stdout.readline()
        if not line:
            raise AssertionError(f"recovery: the plugin of {self.node} "
                                 f"exited {self.proc.wait(timeout=60)}")
        return json.loads(line)

    def ask(self, line: str) -> dict:
        self.proc.stdin.write(line + "\n")
        self.proc.stdin.flush()
        return self._read()

    def get(self, path: str):
        return _http_get(f"http://127.0.0.1:{self.port}{path}")

    def close(self) -> int | None:
        """Stop the plugin (its driver and listener) and reap it; kill it
        if it has not exited after 30 s. Its exit code."""
        try:
            if self.proc.poll() is None:
                try:
                    self.proc.stdin.write("stop\n")
                    self.proc.stdin.flush()
                    self.proc.wait(timeout=30)
                except (OSError, subprocess.TimeoutExpired):
                    self.proc.kill()
                    self.proc.wait()
            return self.proc.returncode
        finally:
            self.log.close()


def phase_recovery(seed: int) -> int:
    """21. The card's telemetry from NVML, a node failure and a device
    failure through the port's recovery controller, from a live claim to
    the flash kernel on the node that took it over. Returns the flash
    launches of the claim children (checked and load)."""
    import os
    import shutil
    import signal
    import tempfile
    import threading

    from k8s_dra_driver_gpu_tpu_torch.api import deviceclasses
    from k8s_dra_driver_gpu_tpu_torch.pkg import doctor, fleetstate
    from k8s_dra_driver_gpu_tpu_torch.pkg.exposition import generate_latest
    from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
    from k8s_dra_driver_gpu_tpu_torch.pkg.metrics import FleetMetrics
    from k8s_dra_driver_gpu_tpu_torch.pkg.recovery import (
        FAILED_TAINT_KEY, PERMANENT_FAILURE_CONDITION, EvictionController)

    res = ("resource.k8s.io", "v1")
    root = os.path.dirname(os.path.abspath(__file__))
    ms: dict = {}
    t_phase = time.perf_counter()

    def check(ok, what):
        if not ok:
            raise AssertionError(f"recovery: {what}")

    def wait(fn, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            value = fn()
            if value:
                return value
            time.sleep(0.005)
        raise AssertionError(f"recovery: timed out waiting for {what}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = (smi.stdout or smi.stderr).strip().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix="recov")
    threads_before = set(threading.enumerate())
    fleet_before = fleetstate.default_fleet()
    plugins: dict = {}
    proc = server = None
    stop_watch = threading.Event()
    watcher = None
    children = 0
    passed = False
    try:
        server = FakeApiServer().start()
        kube = server.store
        # The store's writes, stamped as they land (host clock; and the
        # wall clock, which a file's mtime is read on).
        stamps: dict = {}
        walls: dict = {}
        slice_writes: list = []

        def stamp(key, now):
            stamps.setdefault(key, now)
            walls.setdefault(key, time.time())

        def on_write(group, resource, namespace, ev_type, obj):
            now = time.perf_counter()
            md = obj.get("metadata", {})
            if resource == "resourceslices":
                slice_writes.append((now, obj.get("spec", {}).get(
                    "nodeName")))
            elif resource == "nodes":
                if any(t.get("key") == FAILED_TAINT_KEY for t in
                       obj.get("spec", {}).get("taints") or []):
                    stamp(("declared", md.get("name")), now)
            elif resource == "pods" and ev_type == "DELETED":
                stamp(("drained", md.get("name")), now)
            elif resource == "resourceclaims" and \
                    md.get("name") == RECOVERY_CLAIM:
                st = obj.get("status", {})
                alloc = st.get("allocation")
                node = None
                if alloc:
                    node = alloc["nodeSelector"]["nodeSelectorTerms"][0][
                        "matchFields"][0]["values"][0]
                    stamp(("allocated", node), now)
                for c in st.get("conditions") or []:
                    if c.get("type") == PERMANENT_FAILURE_CONDITION:
                        stamp((c["status"], c["reason"]), now)
                if not alloc and ("True", "NodeFailed") in stamps:
                    stamp(("deallocated", "node"), now)
                if not alloc and ("True", "DeviceFailed") in stamps:
                    stamp(("deallocated", "device"), now)
        kube.add_resource_watcher(on_write)
        deviceclasses.create_all(kube)
        for node in RECOVERY_NODES:
            kube.create("", "v1", "nodes", {
                "metadata": {"name": node},
                "status": {"conditions": [{"type": "Ready",
                                           "status": "True"}]}})
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KUBE_API", "KUBERNETES_", "TPU_DRA_"))}
        env["PYTHONPATH"] = root
        plugin_env = dict(env, TPU_DRA_HEALTH_POLL_S=str(RECOVERY_POLL_S),
                          TPU_DRA_RECOVERY_SWEEP_S=str(RECOVERY_SWEEP_S))
        # Each plugin's listener (metrics and debug routes), known before
        # the binary starts: its incident bundles crawl both.
        plugin_ports = {node: free_port() for node in RECOVERY_NODES}
        peers = {node: f"http://127.0.0.1:{port}"
                 for node, port in plugin_ports.items()}

        def start_plugin(node):
            t0 = time.perf_counter()
            plugins[node] = RecoveryPlugin(server.url, node,
                                           f"{tmp}/{node}",
                                           plugin_ports[node], plugin_env,
                                           root)
            check(plugins[node].ready["cuda"] is False
                  and plugins[node].ready["devices"],
                  f"the plugin of {node}: {plugins[node].ready}")
            ms[f"plugin_{node}_start"] = round(
                (time.perf_counter() - t0) * 1e3, 3)

        def device(node, name="gpu-0"):
            for s in kube.list(*res, "resourceslices"):
                if s["spec"].get("nodeName") == node:
                    for d in s["spec"]["devices"]:
                        if d["name"] == name:
                            return d
            return None

        def telemetry_attrs(node):
            d = device(node) or {}
            return {k: v["int"] for k, v in (d.get("attributes") or
                                              {}).items()
                    if k in fleetstate.TELEMETRY_ATTRS}

        # -- (a) h100-a's telemetry.
        start_plugin("h100-a")
        a = plugins["h100-a"]
        attrs = wait(lambda: telemetry_attrs("h100-a"), 30,
                     "h100-a's telemetry attributes")
        check(set(attrs) == set(fleetstate.TELEMETRY_ATTRS),
              f"h100-a's attributes {attrs}")

        def ring(node):
            return json.loads(plugins[node].get("/debug/telemetry"))

        idle = ring("h100-a")["chips"]["0"][-1]
        # Steady idle samples: the slice writes of two seconds of polls.
        t0 = time.perf_counter()
        time.sleep(2.0)
        steady_polls = 2.0 / RECOVERY_POLL_S
        steady_writes = sum(1 for t, n in slice_writes
                            if n == "h100-a" and t >= t0)
        # The scheduler binary with a recovery root.
        port = free_port()
        sched_env = dict(env, TPU_DRA_DEBUG_HTTP="1",
                         TPU_DRA_RECOVERY_NOTREADY_S=str(RECOVERY_NOTREADY_S),
                         TPU_DRA_RECOVERY_DEADLINE_S=str(
                             RECOVERY_DEADLINE_S),
                         TPU_DRA_DOCTOR_DIR=f"{tmp}/doctor",
                         TPU_DRA_DOCTOR_ENDPOINTS=",".join(
                             f"{node}={url}" for node, url in peers.items()))
        with open(f"{tmp}/scheduler.log", "w", encoding="utf-8") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", SCHEDULER_MAIN, "--kube-api",
                 server.url, "--sched-mode", "poll", "--interval", "0.1",
                 "--metrics-port", str(port), "--recovery-root",
                 f"{tmp}/recovery"],
                env=sched_env, cwd=root, stdin=subprocess.DEVNULL,
                stdout=out, stderr=subprocess.STDOUT)
        base = f"http://127.0.0.1:{port}"

        def metrics():
            try:
                return metric_samples(_http_get(base + "/metrics"))
            except OSError:
                return None
        wait(lambda: (metrics() or {}).get((
            "tpu_dra_sched_sync_seconds_count", (("mode", "full"),))),
            60, "the scheduler's first pass")

        # -- (b) a claim on h100-a, its pod, the kernel under load.
        kube.create(*res, "resourceclaims", {
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": RECOVERY_CLAIM, "namespace": "default"},
            "spec": {"devices": {"requests": [{"name": "gpu", "exactly": {
                "deviceClassName": deviceclasses.GPU_CLASS}}]}}},
            namespace="default")
        kube.create("", "v1", "pods", {
            "apiVersion": "v1", "kind": "Pod",
            "metadata": {"name": "smoke-recovery-pod",
                         "namespace": "default"},
            "spec": {"containers": [{"name": "main"}], "resourceClaims": [
                {"name": "gpu", "resourceClaimName": RECOVERY_CLAIM}]}},
            namespace="default")
        pod = wait(lambda: (lambda p: p if p["spec"].get("nodeName")
                            else None)(kube.get("", "v1", "pods",
                                                "smoke-recovery-pod",
                                                namespace="default")),
                   30, "the pod's binding")
        claim = kube.get(*res, "resourceclaims", RECOVERY_CLAIM,
                         namespace="default")
        uid = claim["metadata"]["uid"]
        check(pod["spec"]["nodeName"] == "h100-a"
              and ("allocated", "h100-a") in stamps,
              f"the claim {claim} on h100-a")
        product = device("h100-a")["attributes"]["productName"]["string"]
        got = a.ask(f"prepare {uid} default {RECOVERY_CLAIM}")
        check(got["result"][1] == "", f"h100-a's prepare {got}")
        t_load, t_load_pc = time.time(), time.perf_counter()
        first = run_claim_child(got["spec"], seed, product,
                                "recovery h100-a", script=LOAD_CHILD)
        t_load_end, t_load_end_pc = time.time(), time.perf_counter()
        children += first["launches"] + first["load_launches"]
        load_samples = [s for s in ring("h100-a")["chips"]["0"]
                        if t_load <= s["ts"] <= t_load_end]
        check(load_samples, "no telemetry sample under load")
        loaded = max(load_samples, key=lambda s: s["power_watts"])
        refusals = a.ask("refusals")
        check(refusals["cuda"] is False, f"h100-a's plugin {refusals}")
        # h100-b comes up while h100-a holds the claim.
        start_plugin("h100-b")
        b = plugins["h100-b"]
        wait(lambda: telemetry_attrs("h100-b"), 30,
             "h100-b's telemetry attributes")
        fleet = wait(lambda: (lambda f: f if set(f.get("nodes", {})) ==
                              set(RECOVERY_NODES) else None)(json.loads(
                                  _http_get(base + "/debug/fleet"))),
                     30, "both nodes in /debug/fleet")
        anomalies = {k: v for k, v in metric_samples(a.get(
            "/metrics")).items() if k[0] == "tpu_dra_anomaly_total"}
        keys = ("power_watts", "temp_celsius", "duty_cycle",
                "hbm_used_bytes", "ici_link_errors")
        load_writes = sum(1 for t, n in slice_writes if n == "h100-a"
                          and t_load_pc <= t <= t_load_end_pc)
        telemetry_doc = ring("h100-a")
        log(f"recovery: (a) telemetry on {card}, from NVML in h100-a's "
            f"plugin (a process without CUDA): attributes {attrs}; idle "
            f"sample {json.dumps({k: idle[k] for k in keys})}; under the "
            f"flash kernel's load (the peak-power one of "
            f"{len(load_samples)} samples of the child's "
            f"{t_load_end - t_load:.1f} s) "
            f"{json.dumps({k: loaded[k] for k in keys})}; slice writes in "
            f"{steady_polls:.0f} steady idle polls: {steady_writes}; "
            f"during the child (CUDA start and load): {load_writes}; NVML "
            f"refusals of the monitor's library {refusals['refusals']}; "
            f"/debug/telemetry of h100-a: "
            f"{telemetry_doc['recorded_total']} samples recorded, chips "
            f"{sorted(telemetry_doc['chips'])}; /debug/fleet of the "
            f"binary: passes {fleet['passes_total']}, pools "
            f"{sorted(fleet['pools'])}, nodes {json.dumps(fleet['nodes'])}; "
            f"anomalies fired: {anomalies or 'none'}")

        # -- (b) h100-a fails.
        t_notready = time.perf_counter()
        kube.patch("", "v1", "nodes", "h100-a", {"status": {"conditions": [
            {"type": "Ready", "status": "False"}]}})
        stages: list = []

        def watch_records():
            path = f"{tmp}/recovery/checkpoint.json"
            last = None
            while not stop_watch.is_set():
                try:
                    with open(path, encoding="utf-8") as f:
                        claims = json.load(f)["data"]["claims"]
                    state = (claims.get(uid) or {}).get("state")
                except (OSError, ValueError, KeyError):
                    state = last
                if state != last:
                    stages.append((state, round(
                        (time.perf_counter() - t_notready) * 1e3, 3)))
                    last = state
                time.sleep(0.002)
        watcher = threading.Thread(target=watch_records, name="records",
                                   daemon=True)
        watcher.start()
        wait(lambda: ("allocated", "h100-b") in stamps, 30,
             "the claim's re-placement on h100-b")
        got = b.ask(f"prepare {uid} default {RECOVERY_CLAIM}")
        t_prepared = time.perf_counter()
        check(got["result"][1] == "", f"h100-b's prepare {got}")
        second = run_claim_child(got["spec"], seed, product,
                                 "recovery h100-b")
        t_launched = time.perf_counter()
        children += second["launches"]
        wait(lambda: ("False", "Recovered") in stamps, 30,
             "the Recovered condition")
        wait(lambda: uid not in a.ask("prepared")["prepared"], 30,
             "h100-a's sweep of the lost claim")
        swept = {k: v for k, v in metric_samples(a.get("/metrics")).items()
                 if k[0] == "tpu_dra_recovery_orphans_repaired_total"}
        wait(lambda: stages and stages[-1][0] is None, 10,
             "the eviction record's retirement")

        def since(key, start):
            return round((stamps[key] - start) * 1e3, 3)
        steps = {
            "notready_to_declared": since(("declared", "h100-a"),
                                          t_notready),
            "to_condition": since(("True", "NodeFailed"),
                                  stamps[("declared", "h100-a")]),
            "to_drained": since(("drained", "smoke-recovery-pod"),
                                stamps[("True", "NodeFailed")]),
            "to_deallocated": since(("deallocated", "node"),
                                    stamps[("drained",
                                            "smoke-recovery-pod")]),
            "to_allocated_again": since(("allocated", "h100-b"),
                                        stamps[("deallocated", "node")]),
            "to_prepare_done": round((t_prepared - stamps[(
                "allocated", "h100-b")]) * 1e3, 3),
            "to_kernel_launched": round((t_launched - t_prepared) * 1e3, 3),
        }
        final = kube.get(*res, "resourceclaims", RECOVERY_CLAIM,
                         namespace="default")
        cond = [c for c in final["status"]["conditions"]
                if c["type"] == PERMANENT_FAILURE_CONDITION]
        check(cond and (cond[0]["status"], cond[0]["reason"]) ==
              ("False", "Recovered"), f"the final condition {cond}")
        # Every durable stage is an "eviction" flight event in the binary
        # (the file poll above may miss one written within 2 ms).
        flight = [e.get("state") for e in json.loads(_http_get(
            f"{base}/debug/claims/{uid}"))["events"]
            if e["event"] == "eviction"]
        check(flight == ["EvictionPlanned", "EvictionDraining",
                         "EvictionDeallocated", "Recovered"]
              and stages[-1][0] is None,
              f"the record's stages {stages}, flight {flight}")
        rec = {k: v for k, v in metrics().items()
               if k[0].startswith("tpu_dra_recovery_")}
        check(rec.get(("tpu_dra_recovery_replaced_total", ())) == 1.0
              and rec.get(("tpu_dra_recovery_permanent_failures_total",
                           (("source", "node"),))) == 1.0,
              f"the binary's recovery samples {rec}")
        log(f"recovery: (b) h100-a NotReady -> declared failed "
            f"{steps['notready_to_declared']} ms (grace "
            f"{RECOVERY_NOTREADY_S} s) -> PermanentFailure condition "
            f"{steps['to_condition']} ms -> pod drained "
            f"{steps['to_drained']} ms -> deallocated "
            f"{steps['to_deallocated']} ms -> allocated on h100-b "
            f"{steps['to_allocated_again']} ms -> h100-b's prepare done "
            f"{steps['to_prepare_done']} ms -> the kernel's child done "
            f"{steps['to_kernel_launched']} ms (its CUDA start included); "
            f"children: h100-a {first['launches']} checked launch + "
            f"{first['load_launches']} load, max_abs_err "
            f"{first['max_abs_err']}; h100-b {second['launches']} launch, "
            f"max_abs_err {second['max_abs_err']} (bound "
            f"{CLAIM_CHILD_MAX_ERR}); final condition {cond[0]['status']} "
            f"{cond[0]['reason']}; record stages from the recovery root "
            f"(ms after NotReady) {stages}, the binary's flight events "
            f"{flight}; h100-a's sweep repaired {swept}; one card: both "
            f"nodes publish the same H100 from their own state and CDI "
            f"roots; the binary's samples "
            f"{json.dumps({str(k): v for k, v in sorted(rec.items())})}")
        ms.update(steps)

        # -- (c) the device fails: nowhere to go. A host of more GPUs than
        # the card's one has the others filled first.
        fillers = [f"smoke-recovery-filler-{i}"
                   for i in range(len(b.ready["devices"]) - 1)]
        for name in fillers:
            kube.create(*res, "resourceclaims", {
                "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
                "metadata": {"name": name, "namespace": "default"},
                "spec": {"devices": {"requests": [{"name": "gpu", "exactly": {
                    "deviceClassName": deviceclasses.GPU_CLASS}}]}}},
                namespace="default")
        wait(lambda: all(kube.get(*res, "resourceclaims", n, namespace=
                                  "default").get("status", {}).get(
                                      "allocation") for n in fillers),
             30, "the filler claims")
        t_fail = time.perf_counter()
        b.ask("fail gpu-0")
        wait(lambda: ("True", "DeviceFailed") in stamps, 30,
             "the device failure's declaration")
        wait(lambda: ("True", "RecoveryDeadlineExceeded") in stamps,
             RECOVERY_DEADLINE_S + 30, "the deadline retirement")
        t_retired = stamps[("True", "RecoveryDeadlineExceeded")]

        def records():
            with open(f"{tmp}/recovery/checkpoint.json",
                      encoding="utf-8") as f:
                return json.load(f)["data"]["claims"]
        # The condition lands before the record goes (the same step).
        wait(lambda: records() == {}, 10, "the retired record's removal")
        ms["retired_to_record_gone"] = round(
            (time.perf_counter() - t_retired) * 1e3, 3)
        final = kube.get(*res, "resourceclaims", RECOVERY_CLAIM,
                         namespace="default")
        taints = device("h100-b").get("taints") or []
        check(not final["status"].get("allocation")
              and any(t["key"] == FAILED_TAINT_KEY
                      and t.get("effect") == "NoExecute" for t in taints),
              f"the retirement: claim {final['status']}, taints {taints}")
        ms["device_fail_to_declared"] = round(
            (stamps[("True", "DeviceFailed")] - t_fail) * 1e3, 3)
        ms["declared_to_retired"] = round(
            (stamps[("True", "RecoveryDeadlineExceeded")]
             - stamps[("True", "DeviceFailed")]) * 1e3, 3)
        log(f"recovery: (c) gpu-0 of h100-b escalated to the sticky failed "
            f"taint ({taints}); declared {ms['device_fail_to_declared']} "
            f"ms after the escalation, retired "
            f"{ms['declared_to_retired']} ms later (deadline "
            f"{RECOVERY_DEADLINE_S} s): RecoveryDeadlineExceeded, no "
            f"allocation, no record")
        # The binary's incident bundle of the blown deadline: its own
        # surfaces and both plugins', crawled over HTTP.
        path, members, report, manifest, found = doctor_bundle(
            f"{tmp}/doctor", "eviction-deadline", 30, "recovery")
        ms["condition_to_bundle"] = round((os.stat(path).st_mtime - walls[
            ("True", "RecoveryDeadlineExceeded")]) * 1e3, 3)
        peer_members = {f"{node}/{p}{'.txt' if p in ('metrics', 'debug/stacks') else '.json'}"
                        for node in peers for p in doctor.SURFACE_PATHS}
        peer_errors = {k: v for k, v in manifest.get("errors", {}).items()
                       if k.split("/")[0] in peers}
        log(f"recovery: (c) incident bundle {os.path.basename(path)}, "
            f"{os.path.getsize(path)} bytes, {ms['condition_to_bundle']} ms "
            f"after the condition; {len(members)} members, of them "
            f"{len(peer_members & set(members))}/{len(peer_members)} of the "
            f"peers' surfaces; focus {report.get('focus_claim')}; fetch "
            f"errors {manifest.get('errors')}")
        check(len(found) == 1 and set(DOCTOR_LOCAL) <= set(members)
              and peer_members <= set(members) and not peer_errors
              and manifest.get("trigger") == "eviction-deadline"
              and report.get("focus_claim") == uid,
              f"the eviction deadline's incident bundle {sorted(members)}")
        # The doctor's CLI, in this process, against the three binaries.
        cli = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(cli):
            rc = doctor.main([f"scheduler={base}"] + [
                f"{node}={url}" for node, url in peers.items()]
                + ["--out-dir", f"{tmp}/doctor-cli", "--claim", uid])
        ms["doctor_cli"] = round((time.perf_counter() - t0) * 1e3, 3)
        path, members, report, manifest, _ = doctor_bundle(
            f"{tmp}/doctor-cli", "manual", 5, "recovery")
        focus = report.get("focus_events", {}).get(uid, [])
        sources = sorted({e["source"] for e in focus})
        log(f"recovery: doctor CLI exit {rc} in {ms['doctor_cli']} ms: "
            f"{os.path.basename(cli.getvalue().strip())}, "
            f"{os.path.getsize(path)} bytes, {len(members)} members; "
            f"{len(focus)} events of {uid} from {sources}; fetch errors "
            f"{manifest.get('errors')}")
        check(rc == 0 and cli.getvalue().strip() == path
              and sources == sorted(["scheduler", *peers])
              and not manifest.get("errors"), "the doctor's CLI")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        check(rc == 0, f"the binary exited {rc}")
        for node in list(plugins):
            check(plugins.pop(node).close() == 0,
                  f"the plugin of {node} exited non-zero")

        # -- (d) the fleet, in process.
        fm = FleetMetrics()
        t0 = time.perf_counter()
        # The 8-GPU claims first (phase 20 (b)'s seeded order strands
        # some and takes ~4x as long; this fold needs only a full fleet).
        fleet_run = _fleet_run(kube.list(*res, "resourceslices")[0],
                               product, fleet_metrics=fm)
        ms["fleet_phase"] = round((time.perf_counter() - t0) * 1e3, 3)
        samples = metric_samples(generate_latest(fm.registry).decode())
        folds = samples[("tpu_dra_fleet_fold_seconds_count", ())]
        fold_ms = samples[("tpu_dra_fleet_fold_seconds_sum", ())] / folds * 1e3
        fkube = fleet_run["kube"]
        victim = "hgx-000"
        fkube.patch("", "v1", "nodes", victim, {"status": {"conditions": [
            {"type": "Ready", "status": "False"}]}})
        ctrl = EvictionController(fkube, f"{tmp}/fleet-recovery",
                                  notready_grace_s=0.0)
        fleet_run["sched"].attach_recovery(ctrl)
        t0 = time.perf_counter()
        counts = ctrl.sync_once()
        sync_ms = round((time.perf_counter() - t0) * 1e3, 3)
        on_victim = sum(1 for c in fkube.list(*res, "resourceclaims")
                        if victim in str((c.get("status", {}).get(
                            "allocation") or {}).get("nodeSelector")))
        check(counts["victims"] == on_victim > 0 and counts["planned"] ==
              min(on_victim, ctrl.max_concurrent),
              f"the fleet's recovery pass {counts}, {on_victim} on {victim}")
        log(f"recovery: (d) fleet of {FLEET_NODES} x {FLEET_GPUS} GPUs with "
            f"telemetry attributes on every device: passes "
            f"{fleet_run['passes_ms']} ms, the fleet fold "
            f"{fold_ms:.3f} ms a pass (mean of {int(folds)}); "
            f"{victim} NotReady: one EvictionController.sync_once "
            f"{sync_ms} ms, {counts} ({on_victim} claims on {victim}, "
            f"{ctrl.max_concurrent} admitted at once)")
        ms.update(fleet_fold_mean=round(fold_ms, 3), fleet_sync_once=sync_ms)
        passed = True
        return children
    finally:
        stop_watch.set()
        if watcher is not None:
            watcher.join(5)
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        for plugin in plugins.values():
            plugin.close()
        if server is not None:
            server.stop()
        fleetstate.set_default_fleet(fleet_before)
        left = [t.name for t in threading.enumerate()
                if t not in threads_before and t.is_alive()]
        ms["phase"] = round((time.perf_counter() - t_phase) * 1e3, 3)
        log(f"recovery: host ms {json.dumps(ms)} on {card}; threads left "
            f"{left}")
        shutil.rmtree(tmp, ignore_errors=True)
        if passed:
            check(not left, "a thread outlived the phase")


MIGRATION_NODES = ("h100-a", "h100-b")
# The flagship at full width, cut to 2 layers so that phase 22 stays
# within its time; B=1, S=4096, 8 steps of the launcher's seeded batches;
# node h100-a is evacuated once child A has logged step 3.
MIGRATION_LAYERS, MIGRATION_BATCH, MIGRATION_SEQ = 2, 1, 4096
MIGRATION_STEPS, MIGRATION_EVACUATE_AFTER = 8, 3
MIGRATION_CLAIM, MIGRATION_COLD_CLAIM = "smoke-migrate", "smoke-migrate-cold"
MIGRATION_INTERVAL_S = 0.05
# (b)'s controllers: a short ack window, then a whole-move deadline
# shorter than it.
MIGRATION_COLD_ACK_S, MIGRATION_COLD_DEADLINE_S = 0.5, 0.3
# Each child's one launch of each training kernel against its plain
# version at the step's shapes, held to phase 3's relative bounds and to
# the kernel table's max abs err (PERF.md §6, rows 2-4 at B=1 S=4096) as
# what it is there: one bf16 ulp at the output's largest magnitude (the
# two versions round their fp32 sums apart). A draw whose largest dV
# lies in [2, 4) has an ulp of 0.0156, not the table's 0.00781.
MIGRATION_KERNEL_MAX_ULPS = 1
# Defrag (c): the checkerboard of tests/test_defrag.py on coordinated
# pools of these sides.
# 12x12 converges as 16x16 did (13 passes, 4 windows) in a fifteenth of
# its host time; 16x16 until phase 23 came.
DEFRAG_SIDES = (4, 12)


def migration_config():
    from k8s_dra_driver_gpu_tpu_torch.models import llama

    return dataclasses.replace(llama.LlamaConfig.flagship(),
                               n_layers=MIGRATION_LAYERS)


def hold_training_kernels(seed: int) -> dict:
    """One launch each of the with-lse forward, dQ and dK/dV at the
    migration step's attention shape (B=1, S=4096, 16 heads over 8 kv
    heads, hd 128, bf16, causal) on inputs from a generator of its own,
    against their plain versions (``hold_with_lse``, phase 3's check with
    the ulp bound added). Returns the launches (not of the main path: a
    comparison) and the errors; raises when one is off."""
    gen = torch.Generator(device="cuda").manual_seed(seed + 22)
    B, S, H, K, hd = MIGRATION_BATCH, MIGRATION_SEQ, 16, 8, 128
    q, k, v = attention_inputs(gen, "training", B, S, H, K, hd,
                               torch.bfloat16)
    do = torch.randn((B, S, H, hd), generator=gen, device="cuda",
                     dtype=torch.float32).to(torch.bfloat16)
    reset_launches()
    r = hold_with_lse(q, k, v, do, True)
    r["launches"] = read_launches()
    ok = (r["launches"] == {"forward_lse": 1, "forward_only": 0, "dq": 1,
                            "dkv": 1}
          and all(r["finite"].values())
          and r["row_rel"] <= FWD_ROW_REL_TOL
          and r["max_abs_err"]["lse"] <= LSE_TOLERANCE
          and max(r["rel_l2"].values()) <= BWD_REL_TOL
          and max(r["ulps"].values()) <= MIGRATION_KERNEL_MAX_ULPS)
    if not ok:
        raise AssertionError(f"the training kernels against their plain "
                             f"versions: {r}")
    return r


# Phase 22's workload: a child under the claim's CDI env that trains the
# cut flagship through ``train.cooperative`` (reading its claim after
# every step), with the training kernels held against their plain
# versions first ("first": child A, which exits at the ack) or last
# ("last": child B). After step ``hold`` (0: none) it waits for the
# intent before it goes on, so that the scripted move lands mid-run
# whatever a step's time (a step takes less than the handshake). One
# JSON line when CUDA is up, one a step, then the run's result with the
# main path's launches (counted from 0 around the run alone) and the
# kernel checks.
MIGRATION_CHILD = """
import json, sys, time
t_start = time.time()
import torch
import chip_smoke as c
from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import KubeClient
from k8s_dra_driver_gpu_tpu_torch.train import cooperative

seed, product, url, claim, ckpt = (int(sys.argv[1]), sys.argv[2],
                                   sys.argv[3], sys.argv[4], sys.argv[5])
hold, checks_first = int(sys.argv[6]), sys.argv[7] == "first"
t_imported = time.time()
count, name = torch.cuda.device_count(), torch.cuda.get_device_name(0)
if count != 1 or name != product:
    raise SystemExit(f"migration child sees {count} devices, {name!r}")
torch.ones(1, device="cuda").sum().item()
print(json.dumps({"started": t_start, "imported": t_imported,
                  "cuda_up": time.time()}), flush=True)
checks = c.hold_training_kernels(seed) if checks_first else None
namespace, _, claim_name = claim.partition("/")
watch = cooperative.ClaimWatch(KubeClient(host=url), namespace, claim_name)


def on_step(step, loss):
    print(json.dumps({"step": step, "loss": loss, "t": time.time()}),
          flush=True)
    deadline = time.monotonic() + 120
    while step == hold and watch.intent() is None and \
            time.monotonic() < deadline:
        time.sleep(0.01)


c.reset_launches()
out = cooperative.run(c.migration_config(), c.MIGRATION_STEPS, ckpt,
                      device="cuda", seed=seed,
                      batch_size=c.MIGRATION_BATCH, seq_len=c.MIGRATION_SEQ,
                      watch=watch, on_step=on_step)
launches = c.read_launches()
if checks is None:
    checks = c.hold_training_kernels(seed)
out.pop("losses")
print(json.dumps({**out, "launches": launches, "checks": checks,
                  "device_count": count, "name": name}), flush=True)
"""


class MigrationChild:
    """``MIGRATION_CHILD`` under a claim's CDI spec env: its JSON lines as
    they come, each with the host time it was read."""

    def __init__(self, spec: dict, args: list, cwd: str, log_path: str):
        import os
        import queue
        import threading

        env = dict(os.environ, PYTHONPATH=cwd)
        edits = [d["containerEdits"] for d in spec["devices"]] + [
            spec.get("containerEdits", {})]
        for entry in (e for edit in edits for e in edit.get("env", [])):
            key, _, value = entry.partition("=")
            env[key] = value
        self.env, self.log_path = env, log_path
        self.lines: queue.Queue = queue.Queue()
        self.log = open(log_path, "w", encoding="utf-8")
        self.proc = subprocess.Popen(
            [sys.executable, "-c", MIGRATION_CHILD, *map(str, args)],
            env=env, cwd=cwd, stdin=subprocess.DEVNULL,
            stdout=subprocess.PIPE, stderr=self.log, text=True)
        self.reader = threading.Thread(target=self._read, daemon=True,
                                       name="migration-child")
        self.reader.start()
        self.docs: list = []
        self.eof_at = None

    def _read(self) -> None:
        for line in self.proc.stdout:
            if line.startswith("{"):
                self.lines.put((time.time(), json.loads(line)))
        self.eof_at = time.time()  # the child's exit, near enough
        self.lines.put((self.eof_at, None))

    def next(self, timeout: float) -> dict | None:
        """The next JSON line (with its read time as ``_read``), None at
        the end of its output."""
        read, doc = self.lines.get(timeout=timeout)
        if doc is not None:
            doc["_read"] = read
            self.docs.append(doc)
        return doc

    def until(self, pred, timeout: float) -> dict:
        deadline = time.monotonic() + timeout
        while True:
            doc = self.next(max(deadline - time.monotonic(), 0.01))
            if doc is None:
                rc = self.proc.wait(60)
                self.log.flush()
                with open(self.log_path, encoding="utf-8") as f:
                    tail = f.read()[-4000:]
                raise AssertionError(f"migration child exited {rc} before "
                                     f"its line; its stderr:\n{tail}")
            if pred(doc):
                return doc

    def result(self, timeout: float = 300) -> dict:
        return self.until(lambda d: "launches" in d, timeout)

    def finish(self, timeout: float = 300) -> dict:
        """The result line; the child must exit 0."""
        result = self.result(timeout)
        self.reap()
        return result

    def reap(self) -> None:
        rc = self.proc.wait(timeout=60)
        self.reader.join(10)
        if rc != 0:
            with open(self.log_path, encoding="utf-8") as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"migration child exited {rc}; its "
                                 f"stderr:\n{tail}")

    def close(self) -> None:
        if self.proc.poll() is None:
            self.proc.kill()
            self.proc.wait()
        self.reader.join(10)
        self.log.close()


def _checkerboard_run(side: int, ctrl_kw: dict) -> dict:
    """tests/test_defrag.py's checkerboard on a ``side`` x ``side``
    coordinated pool in the port's in-process fakes: every chip filled by
    a one-chip claim, the (x+y)-odd half deleted, then the scheduler's
    passes (first-fit placement, a ``DefragController`` attached) until
    the pool's fragmentation falls to the release level with no move in
    flight. Passes, windows, moves, largest free shape before and after,
    each plan's host ms."""
    from k8s_dra_driver_gpu_tpu_torch.pkg import sliceutil
    from k8s_dra_driver_gpu_tpu_torch.pkg.defrag import DefragController
    from k8s_dra_driver_gpu_tpu_torch.pkg.featuregates import FeatureGates
    from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import FakeKubeClient
    from k8s_dra_driver_gpu_tpu_torch.pkg.metrics import DefragMetrics
    from k8s_dra_driver_gpu_tpu_torch.pkg.scheduler import DraScheduler
    import tempfile

    res, driver, node = ("resource.k8s.io", "v1"), "tpu.dra.dev", "node-a"
    kube = FakeKubeClient()
    kube.create(*res, "deviceclasses", {
        "apiVersion": "resource.k8s.io/v1", "kind": "DeviceClass",
        "metadata": {"name": driver}, "spec": {"selectors": [{"cel": {
            "expression": f'device.driver == "{driver}"'}}]}})
    kube.create("", "v1", "nodes", {"metadata": {"name": node},
                                    "status": {"conditions": [
                                        {"type": "Ready", "status": "True"}]}})
    sliceutil.publish_resource_slices(kube, [{
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
        "metadata": {"name": f"{node}-{driver}"},
        "spec": {"driver": driver, "nodeName": node,
                 "pool": {"name": node, "generation": 1,
                          "resourceSliceCount": 1},
                 "devices": [{"name": f"chip-{y * side + x}", "attributes": {
                     "type": {"string": "tpu-chip"},
                     "platform": {"string": "v5e"},
                     "topology": {"string": f"{side}x{side}"},
                     "iciX": {"int": x}, "iciY": {"int": y}}}
                     for y in range(side) for x in range(side)]}}])
    sched = DraScheduler(kube, gates=FeatureGates.parse(
        "TopologyAwarePlacement=false"))
    metrics = DefragMetrics()
    root = tempfile.mkdtemp(prefix="defrag")
    ctrl = DefragController(kube, root, metrics=metrics, **ctrl_kw)
    sched.attach_defrag(ctrl)
    plans_ms: list = []
    plan_pool = ctrl._plan_pool

    def timed_plan(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return plan_pool(*args, **kwargs)
        finally:
            plans_ms.append(round((time.perf_counter() - t0) * 1e3, 3))
    ctrl._plan_pool = timed_plan
    try:
        for i in range(side * side):
            name = f"c{i}"
            kube.create(*res, "resourceclaims", {
                "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
                "metadata": {"name": name, "namespace": "default"},
                "spec": {"devices": {"requests": [{"name": "tpu", "exactly": {
                    "deviceClassName": driver}}]}}}, namespace="default")
            kube.patch(*res, "resourceclaims", name, {"status": {
                "allocation": {"devices": {"results": [{
                    "request": "tpu", "driver": driver, "pool": node,
                    "device": f"chip-{i}"}]},
                    "nodeSelector": {"nodeSelectorTerms": [{"matchFields": [
                        {"key": "metadata.name", "operator": "In",
                         "values": [node]}]}]}}}}, namespace="default")
        for i in range(side * side):
            if (i % side + i // side) % 2:
                kube.delete(*res, "resourceclaims", f"c{i}",
                            namespace="default")

        def point():
            pools = sched.fleet.snapshot().get("pools") or {}
            return (pools.get(f"{driver}/{node}") or {}).get("current") or {}
        t0 = time.perf_counter()
        sched.sync_once()
        before, passes = dict(point()), 1
        while passes < 100:
            now = point()
            if now.get("fragmentation_score", 1.0) <= ctrl.release and \
                    not ctrl.active_moves():
                break
            sched.sync_once()
            passes += 1
        seconds = time.perf_counter() - t0
        after = point()
        held = {}
        for claim in kube.list(*res, "resourceclaims"):
            alloc = claim.get("status", {}).get("allocation")
            if not alloc:
                raise AssertionError(f"defrag {side}x{side}: "
                                     f"{claim['metadata']['name']} pending")
            for r in alloc["devices"]["results"]:
                if r["device"] in held:
                    raise AssertionError(f"defrag {side}x{side}: "
                                         f"{r['device']} held twice")
                held[r["device"]] = claim["metadata"]["name"]

        def value(counter):
            return counter._own().value
        return {"passes": passes, "seconds": seconds,
                "windows": value(metrics.plans),
                "moves": value(metrics.moves),
                "aborted": value(metrics.aborted),
                "frag_recovered": value(metrics.frag_recovered),
                "before": before, "after": after, "plans_ms": plans_ms,
                "claims": len(held), "active": ctrl.active_moves(),
                "release": ctrl.release, "budget_pct": ctrl.budget_pct}
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)


def phase_migration(seed: int) -> dict:
    """22. Cooperative live migration and defragmentation through the
    port's scheduler, with a training claim that checkpoints, moves to
    another node and resumes its loss. Returns the training kernels'
    launches of the two claim children (the main path's)."""
    import os
    import shutil
    import tempfile
    import threading

    from k8s_dra_driver_gpu_tpu_torch.api import deviceclasses
    from k8s_dra_driver_gpu_tpu_torch.pkg import fleetstate, flightrecorder
    from k8s_dra_driver_gpu_tpu_torch.pkg.defrag import (
        DEFRAG_TARGET_ANNOTATION, DefragController)
    from k8s_dra_driver_gpu_tpu_torch.pkg.exposition import generate_latest
    from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
    from k8s_dra_driver_gpu_tpu_torch.pkg.metrics import (DefragMetrics,
                                                          MigrationMetrics)
    from k8s_dra_driver_gpu_tpu_torch.pkg.migration import (
        EVACUATE_ANNOTATION, MIGRATION_ACK_ANNOTATION,
        MIGRATION_INTENT_ANNOTATION, MigrationController)
    from k8s_dra_driver_gpu_tpu_torch.pkg.recovery import (
        MIGRATION_CAPABLE_ANNOTATION)
    from k8s_dra_driver_gpu_tpu_torch.pkg.scheduler import DraScheduler
    from k8s_dra_driver_gpu_tpu_torch.pkg.topology import TorusGrid
    from k8s_dra_driver_gpu_tpu_torch.train import cooperative

    res = ("resource.k8s.io", "v1")
    root = os.path.dirname(os.path.abspath(__file__))
    contract = (MIGRATION_INTENT_ANNOTATION, MIGRATION_ACK_ANNOTATION,
                DEFRAG_TARGET_ANNOTATION)
    ms: dict = {}
    t_phase = time.perf_counter()

    def check(ok, what):
        if not ok:
            raise AssertionError(f"migration: {what}")

    def wait(fn, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            value = fn()
            if value:
                return value
            time.sleep(0.005)
        raise AssertionError(f"migration: timed out waiting for {what}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = (smi.stdout or smi.stderr).strip().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix="migr")
    # The checkpoints (~2.8 GB a step) in a git-ignored directory of the
    # checkout, as phase 10's, deleted after.
    work = os.path.join(root, "k8s_dra_driver_gpu_tpu_torch", "build",
                        "migration_phase")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    threads_before = set(threading.enumerate())
    fleet_before = fleetstate.default_fleet()
    flight_before = flightrecorder.default()
    flight = flightrecorder.set_default(flightrecorder.FlightRecorder())
    plugins: dict = {}
    children: list = []
    server = sched = None
    launches = {"forward_lse": 0, "dq": 0, "dkv": 0}
    passed = False
    try:
        server = FakeApiServer().start()
        kube = server.store
        # The store's writes to the phase's claims, stamped as they land
        # (host wall clock, which the children's lines share).
        stamps: dict = {}
        # name -> [(host time, node)], a claim's allocations in order.
        placed: dict = collections.defaultdict(list)

        def on_write(group, resource, namespace, ev_type, obj):
            if resource != "resourceclaims" or ev_type == "DELETED":
                return
            now = time.time()
            md = obj.get("metadata", {})
            name, ann = md.get("name"), md.get("annotations") or {}
            alloc = obj.get("status", {}).get("allocation")
            for key, label in ((MIGRATION_INTENT_ANNOTATION, "intent"),
                               (MIGRATION_ACK_ANNOTATION, "ack")):
                if key in ann:
                    stamps.setdefault((name, label), now)
            node = None
            if alloc:
                node = alloc["nodeSelector"]["nodeSelectorTerms"][0][
                    "matchFields"][0]["values"][0]
            elif (name, "intent") in stamps:
                stamps.setdefault((name, "deallocated"), now)
            if (placed[name][-1][1] if placed[name] else None) != node:
                placed[name].append((now, node))
        kube.add_resource_watcher(on_write)
        deviceclasses.create_all(kube)
        for node in MIGRATION_NODES:
            kube.create("", "v1", "nodes", {
                "metadata": {"name": node},
                "status": {"conditions": [{"type": "Ready",
                                           "status": "True"}]}})
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KUBE_API", "KUBERNETES_", "TPU_DRA_"))}
        env["PYTHONPATH"] = root
        plugin_env = dict(env, TPU_DRA_RECOVERY_SWEEP_S=str(RECOVERY_SWEEP_S))

        def start_plugin(node):
            t0 = time.perf_counter()
            plugins[node] = RecoveryPlugin(server.url, node,
                                           f"{tmp}/{node}", free_port(),
                                           plugin_env, root)
            check(plugins[node].ready["cuda"] is False
                  and plugins[node].ready["devices"],
                  f"the plugin of {node}: {plugins[node].ready}")
            ms[f"plugin_{node}_start"] = round(
                (time.perf_counter() - t0) * 1e3, 3)

        def claim_of(name):
            return kube.get(*res, "resourceclaims", name,
                            namespace="default")

        def node_of(name):
            return placed[name][-1][1] if placed[name] else None

        def placed_on(name, node, after=0.0):
            return next((t for t, n in placed[name]
                         if n == node and t > after), None)

        def make_claim(name, pod_node=None):
            kube.create(*res, "resourceclaims", {
                "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
                "metadata": {"name": name, "namespace": "default",
                             "annotations": {
                                 MIGRATION_CAPABLE_ANNOTATION: "true"}},
                "spec": {"devices": {"requests": [{"name": "gpu", "exactly": {
                    "deviceClassName": deviceclasses.GPU_CLASS}}]}}},
                namespace="default")
            spec = {"containers": [{"name": "main"}], "resourceClaims": [
                {"name": "gpu", "resourceClaimName": name}]}
            if pod_node:
                spec["nodeName"] = pod_node
            kube.create("", "v1", "pods", {
                "apiVersion": "v1", "kind": "Pod",
                "metadata": {"name": f"{name}-pod", "namespace": "default"},
                "spec": spec}, namespace="default")

        def evacuate(node, on=True):
            kube.patch("", "v1", "nodes", node, {"metadata": {
                "annotations": {EVACUATE_ANNOTATION: "true" if on
                                else None}}})

        def pods():
            return {p["metadata"]["name"] for p in kube.list("", "v1",
                                                            "pods")}

        def stages(uid):
            return [(e.get("state"), e["ts"]) for e in flight.events(uid)
                    if e["event"] == "migration"]

        # The in-process scheduler with both controllers (as the binary's
        # --migration-root and --defrag-root attach them).
        mig_metrics = MigrationMetrics()
        defrag_metrics = DefragMetrics(registry=mig_metrics.registry)
        sched = DraScheduler(kube)
        mig = MigrationController(kube, f"{tmp}/migration",
                                  metrics=mig_metrics)
        defrag = DefragController(kube, f"{tmp}/defrag",
                                  metrics=defrag_metrics)
        sched.attach_migration(mig).attach_defrag(defrag)
        start_plugin("h100-a")
        a = plugins["h100-a"]
        sched.start(MIGRATION_INTERVAL_S)

        # -- (a) the warm move. The claim lands on h100-a (h100-b is not
        # published yet) and is prepared there.
        make_claim(MIGRATION_CLAIM)
        wait(lambda: node_of(MIGRATION_CLAIM) == "h100-a", 30,
             "the claim on h100-a")
        claim = claim_of(MIGRATION_CLAIM)
        uid = claim["metadata"]["uid"]
        got = a.ask(f"prepare {uid} default {MIGRATION_CLAIM}")
        check(got["result"][1] == "", f"h100-a's prepare {got}")
        product = None
        for s in kube.list(*res, "resourceslices"):
            product = s["spec"]["devices"][0]["attributes"]["productName"][
                "string"]
        start_plugin("h100-b")
        b = plugins["h100-b"]
        wait(lambda: len(kube.list(*res, "resourceslices")) == 2, 30,
             "h100-b's slice")
        # The uninterrupted run, here.
        cfg = migration_config()
        t0 = time.perf_counter()
        plain = cooperative.run(cfg, MIGRATION_STEPS, f"{work}/plain",
                                device="cuda", seed=seed,
                                batch_size=MIGRATION_BATCH,
                                seq_len=MIGRATION_SEQ)
        ms["uninterrupted_run"] = round((time.perf_counter() - t0) * 1e3, 3)
        torch.cuda.empty_cache()
        ckpt = f"{work}/ckpt"
        claim_arg = f"default/{MIGRATION_CLAIM}"
        child_a = MigrationChild(
            got["spec"], [seed, product, server.url, claim_arg, ckpt,
                          MIGRATION_EVACUATE_AFTER, "first"], root,
            f"{tmp}/child-a.log")
        children.append(child_a)
        up_a = child_a.until(lambda d: "cuda_up" in d, 300)
        step3 = child_a.until(
            lambda d: d.get("step") == MIGRATION_EVACUATE_AFTER, 300)
        t_evacuate = time.time()
        evacuate("h100-a")
        # Child A exits after its result line; the claim's new node does
        # not wait for that (its pod would run on another host).
        result_a = child_a.result()
        check(result_a.get("acked") == MIGRATION_EVACUATE_AFTER
              and "done" not in result_a,
              f"child A's run: {result_a}")
        t_b_alloc = wait(lambda: placed_on(MIGRATION_CLAIM, "h100-b"), 60,
                         "the claim's re-placement on h100-b")
        got_b = b.ask(f"prepare {uid} default {MIGRATION_CLAIM}")
        t_b_prepared = time.time()
        check(got_b["result"][1] == "", f"h100-b's prepare {got_b}")
        # The record retires (the contract annotations cleared) one pass
        # after the re-placement, well before child B's CUDA is up; wait
        # for it so that child B never reads the old intent.
        wait(lambda: mig.active_moves() == {} and not mig.reservations(),
             30, "the move record's retirement")
        child_b = MigrationChild(
            got_b["spec"], [seed, product, server.url, claim_arg, ckpt, 0,
                            "last"], root, f"{tmp}/child-b.log")
        children.append(child_b)
        child_a.reap()
        up_b = child_b.until(lambda d: "cuda_up" in d, 300)
        first_b = child_b.until(lambda d: "step" in d, 300)
        result_b = child_b.finish()
        check(result_b.get("restored_from") == MIGRATION_EVACUATE_AFTER
              and result_b.get("done") == MIGRATION_STEPS,
              f"child B's run: {result_b}")
        wait(lambda: uid not in a.ask("prepared")["prepared"], 30,
             "h100-a's sweep of the moved claim")
        # The losses: both children against the uninterrupted run.
        got_losses = {d["step"]: d["loss"] for d in
                      child_a.docs + child_b.docs if "step" in d}
        want_losses = plain["losses"]
        check(sorted(got_losses) == list(range(1, MIGRATION_STEPS + 1)),
              f"the children's steps {sorted(got_losses)}")
        rels = {step: abs(got_losses[step] - want) / abs(want)
                for step, want in want_losses.items()}
        bitwise = all(got_losses[s] == w for s, w in want_losses.items())
        # Bitwise: the training kernels have no atomics, so a restore
        # that lost any state (the AdamW moments, the step) shows even
        # where random weights move the loss by less than 1e-4 a step.
        check(all(math.isfinite(v) for v in got_losses.values()) and bitwise,
              f"the moved run's losses {got_losses} against the "
              f"uninterrupted {want_losses}: not bitwise equal")
        flight_stages = [s for s, _ in stages(uid)]
        check(flight_stages == ["MigrationDestReserved",
                                "MigrationIntentSignaled",
                                "MigrationWorkloadAcked",
                                "MigrationSwitching", "Migrated"],
              f"the move's stages {flight_stages}")
        final = claim_of(MIGRATION_CLAIM)
        left = [k for k in contract
                if k in (final["metadata"].get("annotations") or {})]
        check(not left and node_of(MIGRATION_CLAIM) == "h100-b"
              and f"{MIGRATION_CLAIM}-pod" not in pods(),
              f"after the move: annotations left {left}, on "
              f"{node_of(MIGRATION_CLAIM)}, pods {sorted(pods())}")
        for result in (result_a, result_b):
            for kernel in launches:
                launches[kernel] += result["launches"][kernel]
        want_launches = {"forward_lse": 2 * MIGRATION_LAYERS
                         * MIGRATION_STEPS,
                         "dq": MIGRATION_LAYERS * MIGRATION_STEPS,
                         "dkv": MIGRATION_LAYERS * MIGRATION_STEPS}
        check(launches == want_launches,
              f"the children's launches {launches}, want {want_launches}")
        at = {s: t for s, t in stages(uid)}

        def span(t1, t0):
            return round((t1 - t0) * 1e3, 3)
        steps = {
            "evacuate_to_reserved": span(at["MigrationDestReserved"],
                                         t_evacuate),
            "to_intent": span(stamps[(MIGRATION_CLAIM, "intent")],
                              at["MigrationDestReserved"]),
            "to_ack": span(stamps[(MIGRATION_CLAIM, "ack")],
                           stamps[(MIGRATION_CLAIM, "intent")]),
            "ack_to_switched": span(stamps[(MIGRATION_CLAIM,
                                            "deallocated")],
                                    stamps[(MIGRATION_CLAIM, "ack")]),
            "to_allocated_on_b": span(t_b_alloc, stamps[(
                MIGRATION_CLAIM, "deallocated")]),
            "to_prepared": span(t_b_prepared, t_b_alloc),
            "to_restored": span(result_b["restored_at"], t_b_prepared),
            "to_first_step_b": span(first_b["t"], result_b["restored_at"]),
            "downtime": span(first_b["t"], step3["t"]),
        }
        ms.update(steps)
        log(f"migration: (a) on {card}: the flagship at full width "
            f"(d_model {cfg.d_model}, {cfg.n_heads} heads over "
            f"{cfg.n_kv_heads}, hd {cfg.head_dim}, d_ff {cfg.d_ff}, vocab "
            f"{cfg.vocab_size}) cut to {cfg.n_layers} layers, B="
            f"{MIGRATION_BATCH} S={MIGRATION_SEQ}, {result_a['params']} "
            f"parameters, fp32 state and AdamW moments, bf16 compute; child "
            f"A's imports {span(up_a['imported'], up_a['started'])} ms, its "
            f"CUDA context {span(up_a['cuda_up'], up_a['imported'])} ms, "
            f"steps 1-{MIGRATION_EVACUATE_AFTER} on h100-a; host ms "
            f"evacuate -> reserved {steps['evacuate_to_reserved']} -> "
            f"intent {steps['to_intent']} -> ack {steps['to_ack']} "
            f"(checkpoint {result_a['checkpoint_bytes']} bytes saved in "
            f"{result_a['save_s']:.3f} s, "
            f"{result_a['checkpoint_bytes'] / result_a['save_s'] / 1e9:.3f} "
            f"GB/s) -> switched {steps['ack_to_switched']} -> allocated on "
            f"h100-b {steps['to_allocated_on_b']} -> prepared "
            f"{steps['to_prepared']} -> restored {steps['to_restored']} "
            f"(child B's imports {span(up_b['imported'], up_b['started'])} "
            f"ms, its CUDA context {span(up_b['cuda_up'], up_b['imported'])}"
            f" ms, the restore {result_b['restore_s']:.3f} s) -> "
            f"B's first step {steps['to_first_step_b']}; downtime (A's last "
            f"step to B's first) {steps['downtime']} ms; child A's output "
            f"closed {span(child_a.eof_at, stamps[(MIGRATION_CLAIM, 'ack')])}"
            f" ms after its ack")
        log(f"migration: (a) losses by step {json.dumps(got_losses)}; "
            f"uninterrupted {json.dumps(want_losses)}; bitwise equal "
            f"{bitwise} (required), max rel {max(rels.values()):.3g}; "
            f"stages {flight_stages}; kernels in A "
            f"{json.dumps(result_a['checks'])}, in B "
            f"{json.dumps(result_b['checks'])} (bounds: "
            f"{MIGRATION_KERNEL_MAX_ULPS} bf16 ulp at the largest "
            f"magnitude, row rel L2 {FWD_ROW_REL_TOL}, lse "
            f"{LSE_TOLERANCE}, rel L2 {BWD_REL_TOL}); main-path launches "
            f"{launches}; "
            f"the uninterrupted run {ms['uninterrupted_run']} ms in this "
            f"process")

        # -- (b) the cold fallback: a second claim on h100-a whose
        # workload never acks. The first claim goes, so h100-b's GPU is
        # a destination again.
        kube.delete(*res, "resourceclaims", MIGRATION_CLAIM,
                    namespace="default")
        wait(lambda: uid not in b.ask("prepared")["prepared"], 30,
             "h100-b's sweep of the deleted claim")
        evacuate("h100-a", on=False)
        cold_runs = {}
        for reason, ack_s, deadline_s in (
                ("ack-timeout", MIGRATION_COLD_ACK_S, 300.0),
                ("deadline", MIGRATION_COLD_ACK_S,
                 MIGRATION_COLD_DEADLINE_S)):
            cold = MigrationController(
                kube, f"{tmp}/migration-{reason}", metrics=MigrationMetrics(),
                ack_s=ack_s, deadline_s=deadline_s, cooldown_s=3600.0)
            sched.attach_migration(cold)
            name = f"{MIGRATION_COLD_CLAIM}-{reason}"
            make_claim(name, pod_node="h100-a")
            wait(lambda: node_of(name) == "h100-a", 30,
                 f"{name} on h100-a")
            cuid = claim_of(name)["metadata"]["uid"]
            t0 = time.time()
            evacuate("h100-a")
            wait(lambda: ("FellBack" in [s for s, _ in stages(cuid)]), 30,
                 f"{name}'s fallback")
            evacuate("h100-a", on=False)
            fell = [e for e in flight.events(cuid)
                    if e["event"] == "migration"
                    and e.get("state") == "FellBack"][-1]
            final = claim_of(name)
            left = [k for k in contract
                    if k in (final["metadata"].get("annotations") or {})]
            cold_stages = [s for s, _ in stages(cuid)]
            check(fell["reason"] == reason and not left
                  and not cold.reservations() and cold.active_moves() == {},
                  f"{name}: {fell}, annotations left {left}, reservations "
                  f"{cold.reservations()}")
            if reason == "ack-timeout":
                # Before the switch the workload never stopped: its
                # allocation and its pod stay.
                check(node_of(name) == "h100-a" and f"{name}-pod" in pods(),
                      f"{name} after its ack timeout: on {node_of(name)}")
            else:
                # The deadline finishes the move cold: drained,
                # deallocated, re-placed by the next pass (anywhere).
                wait(lambda: (name, "deallocated") in stamps
                     and placed[name][-1][1] is not None
                     and placed[name][-1][0] > stamps[(name, "deallocated")],
                     30, f"{name}'s re-placement")
                check(f"{name}-pod" not in pods(),
                      f"{name}'s pod after the cold drain")
            at = {s: t for s, t in stages(cuid)}
            cold_runs[reason] = {
                "stages": cold_stages,
                "evacuate_to_reserved": span(at["MigrationDestReserved"], t0),
                "to_intent": span(stamps[(name, "intent")],
                                  at["MigrationDestReserved"]),
                "to_fallback": span(fell["ts"], stamps[(name, "intent")]),
                "placed": [n for _, n in placed[name]],
                "deallocated_to_replaced": (span(
                    placed[name][-1][0], stamps[(name, "deallocated")])
                    if (name, "deallocated") in stamps else None)}
            if f"{name}-pod" in pods():
                kube.delete("", "v1", "pods", f"{name}-pod",
                            namespace="default")
            kube.delete(*res, "resourceclaims", name, namespace="default")
        sched.attach_migration(mig)
        log(f"migration: (b) cold fallbacks on {card} (ack_s "
            f"{MIGRATION_COLD_ACK_S} s; the second controller's deadline "
            f"{MIGRATION_COLD_DEADLINE_S} s): {json.dumps(cold_runs)}")
        ms.update({f"cold_{r}_{k}": v for r, run in cold_runs.items()
                   for k, v in run.items() if isinstance(v, float)})

        # -- (c) defrag: the port's GPU pools have no coordinates.
        sched.stop()
        slices = kube.list(*res, "resourceslices")
        claims = kube.list(*res, "resourceclaims")
        gpu_pools = []
        for s in slices:
            key = (s["spec"]["driver"], s["spec"]["pool"]["name"])
            grid = TorusGrid.from_devices(s["spec"]["devices"])
            gpu_pools.append({"pool": "/".join(key),
                              "coords": len(grid.coords),
                              "model": defrag._pool_model(key, slices,
                                                          claims),
                              "planned": defrag._plan_pool(
                                  key, claims, slices, [],
                                  {"planned": 0})})
        check(all(p["model"] is None and p["planned"] is False
                  and p["coords"] == 0 for p in gpu_pools),
              f"defrag on the GPU pools: {gpu_pools}")
        passes_defrag = defrag.last_sync
        samples = {str(k): v for k, v in sorted(metric_samples(
            generate_latest(mig_metrics.registry).decode()).items())
            if not k[0].endswith("_bucket")}
        log(f"migration: (c) defrag over the port's two GPU pools: "
            f"{[(p['pool'], p['coords']) for p in gpu_pools]} (pool, "
            f"devices with ICI coordinates): no grid, so no window "
            f"(_pool_model None, _plan_pool False); the attached "
            f"controller's last pass {passes_defrag}; the scheduler's "
            f"defrag and migration samples "
            f"{json.dumps(samples)}")
        for node in list(plugins):
            check(plugins.pop(node).close() == 0,
                  f"the plugin of {node} exited non-zero")
        for side in DEFRAG_SIDES:
            ctrl_kw = dict(trigger=0.25, release=0.15, sustain_s=0.0,
                           max_concurrent=side * side, deadline_s=600.0,
                           cooldown_s=0.0)
            if side <= 4:
                # tests/test_defrag.py's; on the larger pool the default
                # budget keeps each window's what-if sweep short.
                ctrl_kw["budget_pct"] = 100.0
            run = _checkerboard_run(side, ctrl_kw)
            check(run["after"].get("fragmentation_score", 1.0)
                  <= run["release"] and not run["active"]
                  and run["aborted"] == 0
                  and run["after"]["largest_free_shape"]
                  > run["before"]["largest_free_shape"],
                  f"the {side}x{side} checkerboard: {run}")
            log(f"migration: (c) defrag, {side}x{side} checkerboard "
                f"({run['claims']} one-chip claims, budget "
                f"{run['budget_pct']}% of them a window): "
                f"{run['passes']} passes in {run['seconds']:.3f} s, "
                f"{run['windows']:.0f} windows, {run['moves']:.0f} moves, "
                f"largest free shape {run['before']['largest_free_shape']}"
                f" -> {run['after']['largest_free_shape']} chips (frag "
                f"{run['before']['fragmentation_score']} -> "
                f"{run['after']['fragmentation_score']}), chips recovered "
                f"{run['frag_recovered']:.0f}, plans ms {run['plans_ms']}")
            ms[f"defrag_{side}_plan_ms"] = sum(run["plans_ms"])
        passed = True
        return launches
    finally:
        for child in children:
            child.close()
        if sched is not None:
            sched.stop()
        for plugin in plugins.values():
            plugin.close()
        if server is not None:
            server.stop()
        fleetstate.set_default_fleet(fleet_before)
        flightrecorder.set_default(flight_before)
        left = [t.name for t in threading.enumerate()
                if t not in threads_before and t.is_alive()]
        ms["phase"] = round((time.perf_counter() - t_phase) * 1e3, 3)
        log(f"migration: host ms {json.dumps(ms)} on {card}; threads left "
            f"{left}")
        shutil.rmtree(tmp, ignore_errors=True)
        shutil.rmtree(work, ignore_errors=True)
        if passed:
            check(not left, "a thread outlived the phase")


AUTOSCALE_NODE = "h100-a"
AUTOSCALE_CLAIM = "smoke-autoscale"
AUTOSCALE_TENANT = "web"
AUTOSCALE_POLL_S = 0.2
AUTOSCALE_INTERVAL_S = 0.1
# The CRD must be written, confirmed and decided within this of the
# demand's write, and the upsize planned within it of its own write.
AUTOSCALE_DEADLINE_S = 15.0
AUTOSCALE_STEADY_PASSES = 10


def phase_autoscale(seed: int) -> int:
    """23. The serving autoscaler on the H100 node: a tenant's claim runs
    the flash forward kernel (row 1) under its CDI env, the card's memory
    it took (NVML, the plugin's telemetry ring) is declared as its
    demand, and the scheduler binary's autoscale controller re-plans the
    PartitionSet CRD that the plugin's watcher decides; then steady
    passes, an urgent upsize and a manual override. Returns the child's
    flash launches (checked and load)."""
    import os
    import shutil
    import signal
    import tempfile
    import threading

    from k8s_dra_driver_gpu_tpu_torch.api import deviceclasses
    from k8s_dra_driver_gpu_tpu_torch.pkg import fleetstate
    from k8s_dra_driver_gpu_tpu_torch.pkg.autoscale import crd as as_crd
    from k8s_dra_driver_gpu_tpu_torch.pkg.autoscale.planner import \
        TENANT_DEMAND_HBM_ANNOTATION
    from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
    from k8s_dra_driver_gpu_tpu_torch.pkg.partition.profiles import \
        TENANT_PROFILE_ANNOTATION

    res = ("resource.k8s.io", "v1")
    crd_res = (as_crd.AUTOSCALE_CRD_GROUP, as_crd.AUTOSCALE_CRD_VERSION,
               as_crd.AUTOSCALE_CRD_RESOURCE)
    root = os.path.dirname(os.path.abspath(__file__))
    ms: dict = {}
    t_phase = time.perf_counter()

    def check(ok, what):
        if not ok:
            raise AssertionError(f"autoscale: {what}")

    def wait(fn, timeout, what):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            value = fn()
            if value:
                return value
            time.sleep(0.005)
        raise AssertionError(f"autoscale: timed out waiting for {what}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = (smi.stdout or smi.stderr).strip().splitlines()[0]
    tmp = tempfile.mkdtemp(prefix="autoscale")
    threads_before = set(threading.enumerate())
    fleet_before = fleetstate.default_fleet()
    plugin = proc = server = None
    passed = False
    try:
        server = FakeApiServer().start()
        kube = server.store
        # Each write as it lands (host clocks: perf_counter for spans in
        # this process, time.time against the other processes' stamps).
        crd_writes: list = []
        slice_writes: list = []

        def on_write(group, resource, namespace, ev_type, obj):
            now = (time.perf_counter(), time.time())
            if resource == "resourceslices":
                slice_writes.append(now)
            elif resource == as_crd.AUTOSCALE_CRD_RESOURCE:
                crd_writes.append((now, ev_type, json.loads(json.dumps(
                    obj))))
        kube.add_resource_watcher(on_write)
        deviceclasses.create_all(kube)
        kube.create("", "v1", "nodes", {
            "metadata": {"name": AUTOSCALE_NODE},
            "status": {"conditions": [{"type": "Ready",
                                       "status": "True"}]}})
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("KUBE_API", "KUBERNETES_", "TPU_DRA_"))}
        env["PYTHONPATH"] = root
        # No telemetry attributes and no anomaly episodes: the slice
        # writes counted below are the partition path's alone.
        plugin_env = dict(env, TPU_DRA_HEALTH_POLL_S=str(AUTOSCALE_POLL_S),
                          TPU_DRA_TELEMETRY_ATTRS="0",
                          TPU_DRA_ANOMALY_MIN_SAMPLES="1000000")
        t0 = time.perf_counter()
        plugin = RecoveryPlugin(server.url, AUTOSCALE_NODE,
                                f"{tmp}/{AUTOSCALE_NODE}", free_port(),
                                plugin_env, root,
                                gates="DynamicSubSlice=true,"
                                "TenantPartitioning=true")
        ms["plugin_start"] = round((time.perf_counter() - t0) * 1e3, 3)
        ready = plugin.ready
        check(ready["cuda"] is False and "gpu-0" in ready["devices"],
              f"the plugin: {ready}")

        def node_slice():
            for s in kube.list(*res, "resourceslices"):
                if s["spec"].get("nodeName") == AUTOSCALE_NODE:
                    return s
            return None
        wait(node_slice, 30, "the node's slice")
        counters = {c["name"]: c["counters"] for c in
                    node_slice()["spec"].get("sharedCounters") or []}
        memory = int(counters["gpu-0-counter-set"]["memory"]["value"])
        sms = counters["gpu-0-counter-set"].get("multiprocessors")
        product = [d for d in node_slice()["spec"]["devices"]
                   if d["name"] == "gpu-0"][0]["attributes"][
                       "productName"]["string"]
        port = free_port()
        sched_env = dict(env, TPU_DRA_DEBUG_HTTP="1",
                         TPU_DRA_AUTOSCALE_SUSTAIN_S="0",
                         TPU_DRA_AUTOSCALE_COOLDOWN_S="0")
        log_path = f"{tmp}/scheduler.log"
        with open(log_path, "w", encoding="utf-8") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", SCHEDULER_MAIN, "--kube-api",
                 server.url, "--sched-mode", "poll",
                 "--interval", str(AUTOSCALE_INTERVAL_S),
                 "--metrics-port", str(port), "--autoscale-root",
                 f"{tmp}/autoscale"],
                env=sched_env, cwd=root, stdin=subprocess.DEVNULL,
                stdout=out, stderr=subprocess.STDOUT)
        base = f"http://127.0.0.1:{port}"

        def metrics():
            try:
                return metric_samples(_http_get(base + "/metrics"))
            except OSError:
                return {}

        def passes():
            return metrics().get(("tpu_dra_sched_sync_seconds_count",
                                  (("mode", "full"),)), 0)

        def sample(name):
            return metrics().get((f"tpu_dra_autoscale_{name}", ()), 0)
        wait(passes, 60, "the scheduler's first pass")

        # -- (b) the tenant's claim, its child on the card.
        kube.create(*res, "resourceclaims", {
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": AUTOSCALE_CLAIM, "namespace": "default",
                         "annotations": {
                             TENANT_PROFILE_ANNOTATION: AUTOSCALE_TENANT}},
            "spec": {"devices": {"requests": [{"name": "gpu", "exactly": {
                "deviceClassName": deviceclasses.GPU_CLASS}}]}}},
            namespace="default")
        claim = wait(lambda: (lambda c: c if c.get("status", {}).get(
            "allocation") else None)(kube.get(
                *res, "resourceclaims", AUTOSCALE_CLAIM,
                namespace="default")), 30, "the claim's allocation")
        uid = claim["metadata"]["uid"]
        results = claim["status"]["allocation"]["devices"]["results"]
        check([(r["pool"], r["device"]) for r in results]
              == [(AUTOSCALE_NODE, "gpu-0")], f"the allocation {results}")
        got = plugin.ask(f"prepare {uid} default {AUTOSCALE_CLAIM}")
        check(got["result"][1] == "", f"the prepare {got}")

        def ring():
            return json.loads(plugin.get("/debug/telemetry"))["chips"]["0"]
        before = wait(lambda: ring()[-1:], 30, "a telemetry sample")[-1]
        t_child = time.time()
        child = run_claim_child(got["spec"], seed, product,
                                "autoscale tenant", script=LOAD_CHILD)
        t_child_end = time.time()
        # The demand is the serving load's alone: the samples from the
        # load's start, after the child freed its plain version's
        # tensors. The whole run's peak (the check's included) is logged.
        samples = ring()
        under = [s for s in samples if t_child <= s["ts"] <= t_child_end]
        load = [s for s in under if s["ts"] >= child["load_start"]]
        check(load, "no telemetry sample during the child's load")
        peak = max(load, key=lambda s: s["hbm_used_bytes"])
        demand = peak["hbm_used_bytes"] - before["hbm_used_bytes"]
        whole = max(s["hbm_used_bytes"] for s in under) \
            - before["hbm_used_bytes"]
        check(demand > 0, f"the child's memory: before {before}, peak "
              f"{peak}")
        log(f"autoscale: (b) tenant {AUTOSCALE_TENANT!r} on {card}: the "
            f"child's {child['launches']} checked launch (max_abs_err "
            f"{child['max_abs_err']}, bound {CLAIM_CHILD_MAX_ERR}) and "
            f"{child['load_launches']} load launches in {LOAD_S} s; "
            f"NVML's memory used (the plugin's ring) "
            f"{before['hbm_used_bytes']} B before, "
            f"{peak['hbm_used_bytes']} B at the load's peak ({len(load)} "
            f"samples from its start): demand {demand} B "
            f"({demand / 2**30:.3f} GiB); the whole child's peak "
            f"({len(under)} samples in {t_child_end - t_child:.2f} s, "
            f"the plain check's included) {whole} B "
            f"({whole / 2**30:.3f} GiB); the child's "
            f"torch.cuda.max_memory_reserved() "
            f"{child['load_memory_reserved']} B through the load, "
            f"{child['check_memory_reserved']} B through the check; the "
            f"card's memory counter {memory} B, multiprocessors "
            f"{sms['value'] if sms else 'not published (MIG off)'}")

        # -- (c) the demand declared; the rollout.
        def crd_events(ev_type):
            return [w for w in crd_writes if w[1] == ev_type]
        n_crd = len(crd_writes)
        t_write, t_write_wall = time.perf_counter(), time.time()
        kube.patch(*res, "resourceclaims", AUTOSCALE_CLAIM, {"metadata": {
            "annotations": {TENANT_DEMAND_HBM_ANNOTATION: str(demand)}}},
            namespace="default")
        created = wait(lambda: crd_events("ADDED"), AUTOSCALE_DEADLINE_S,
                       "the CRD's creation")[0]
        check(len(crd_writes) == n_crd + 1, f"CRD writes {crd_writes}")
        obj = created[2]
        profiles = obj["spec"]["profiles"]
        slots = memory // max(demand, 1)
        # The smallest budget that covers the demand: the most slots.
        want_k = max([k for k in (1, 2, 4, 8) if memory // k >= demand])
        check([(p["name"], p["maxTenants"]) for p in profiles]
              == [(f"{AUTOSCALE_TENANT}-s{want_k}", want_k)]
              and profiles[0]["subslice"] == "7g.80gb"
              and as_crd.revision_of(obj) == 1 and as_crd.is_managed(obj),
              f"the CRD {obj}")
        fp = as_crd.fingerprint(obj["spec"])

        def flight(fp):
            return [e for e in json.loads(_http_get(
                f"{base}/debug/claims/replan-{fp}"))["events"]
                if e["event"] == "autoscale"]
        events = wait(lambda: (lambda ev: ev if ev and ev[-1].get(
            "state") == "Completed" else None)(flight(fp)),
            AUTOSCALE_DEADLINE_S, "the rollout's confirmation")
        states = [e["state"] for e in events]
        check(states == ["AutoscalePlanned", "AutoscaleApplying",
                         "Completed"], f"the rollout's records {states}")
        w = wait(lambda: (lambda d: d if any(
            x["ts"] >= created[0][1] for x in d["decisions"]) else None)(
                plugin.ask("watch")), AUTOSCALE_DEADLINE_S,
            "the watcher's decision")
        decided = [x for x in w["decisions"] if x["ts"] >= created[0][1]][0]
        if ready["mig_mode"] == "enabled":
            # (b) MIG on: the plan's partitions published.
            outcome = "b"
            check(decided["applied"] and w["partitions"] == [
                f"pt-{AUTOSCALE_TENANT}-s{want_k}-0"],
                f"outcome (b): {w}")
        else:
            # (a) MIG off: the plan refused, nothing written.
            outcome = "a"
            check(not decided["applied"] and decided["failed_total"] == 1
                  and "'7g.80gb' is no carve-out of this host"
                  in (decided["last_error"] or "")
                  and w["partitions"] == [] and w["applied_total"] == 0,
                  f"outcome (a): {w}")
        at = {e["state"]: e["ts"] for e in events}
        steps = {
            "demand_to_planned": round((at["AutoscalePlanned"]
                                        - t_write_wall) * 1e3, 3),
            "demand_to_crd_created": round((created[0][0] - t_write)
                                           * 1e3, 3),
            "demand_to_confirmed": round((at["Completed"] - t_write_wall)
                                         * 1e3, 3),
            "crd_to_watcher_decision": round((decided["ts"]
                                              - created[0][1]) * 1e3, 3),
        }
        ms.update(steps)
        fleet = json.loads(_http_get(base + "/debug/fleet"))
        m = metrics()
        rollout = {k[0]: v for k, v in m.items() if k[0] in (
            "tpu_dra_autoscale_rollout_seconds_count",
            "tpu_dra_autoscale_rollout_seconds_sum")}
        check(rollout.get("tpu_dra_autoscale_rollout_seconds_count") == 1
              and m.get(("tpu_dra_autoscale_plans_total", ())) == 1
              and m.get(("tpu_dra_autoscale_applies_total", ())) == 1
              and m.get(("tpu_dra_autoscale_active_rollouts", ())) == 0,
              f"the binary's autoscale samples {m}")
        tenant = fleet["tenant_demand"][AUTOSCALE_TENANT]
        check(tenant["p95_hbm_bytes"] == demand,
              f"/debug/fleet's tenant_demand {fleet['tenant_demand']}")
        stages = [(e["state"], round((e["ts"] - t_write_wall) * 1e3, 3))
                  for e in events]
        log(f"autoscale: (c) demand {demand} B declared (measured) -> "
            f"record planned {steps['demand_to_planned']} ms -> CRD "
            f"created {steps['demand_to_crd_created']} ms "
            f"({AUTOSCALE_TENANT}-s{want_k}, {memory // want_k} B a slot "
            f"of {memory}; {slots} slots of the demand would fit) -> "
            f"confirmed {steps['demand_to_confirmed']} ms; the watcher "
            f"decided {steps['crd_to_watcher_decision']} ms after the "
            f"write: outcome ({outcome}), MIG {ready['mig_mode']}, "
            f"applied {w['applied_total']}, failed {w['failed_total']}, "
            f"last_error {w['last_error']!r}, partitions "
            f"{w['partitions']}; rollout_seconds {rollout}; /debug/fleet "
            f"tenant_demand[{AUTOSCALE_TENANT!r}] {tenant}; the binary's "
            f"flight events {stages}; "
            f"requests by method {dict(server.requests)}")

        # -- (d) steady state: no write in AUTOSCALE_STEADY_PASSES passes.
        p0, conv0 = passes(), sample("converged_passes_total")
        n_crd, n_slices = len(crd_writes), len(slice_writes)
        t0 = time.perf_counter()
        wait(lambda: passes() >= p0 + AUTOSCALE_STEADY_PASSES + 1, 30,
             "the steady passes")
        steady_ms = round((time.perf_counter() - t0) * 1e3, 3)
        steady = {"passes": passes() - p0,
                  "converged": sample("converged_passes_total") - conv0,
                  "crd_writes": len(crd_writes) - n_crd,
                  "slice_writes": len(slice_writes) - n_slices}
        check(steady["crd_writes"] == 0 and steady["slice_writes"] == 0
              and steady["converged"] >= AUTOSCALE_STEADY_PASSES,
              f"the steady passes {steady}")
        log(f"autoscale: (d) steady: {steady} in {steady_ms} ms")

        # The upsize: a declared demand of 3/4 of the memory counter.
        upsized = memory * 3 // 4
        n_crd, plans0, p0 = len(crd_writes), sample("plans_total"), passes()
        t_up, t_up_wall = time.perf_counter(), time.time()
        kube.patch(*res, "resourceclaims", AUTOSCALE_CLAIM, {"metadata": {
            "annotations": {TENANT_DEMAND_HBM_ANNOTATION: str(upsized)}}},
            namespace="default")
        patched = wait(lambda: [x for x in crd_writes[n_crd:]
                                if x[1] == "MODIFIED"],
                       AUTOSCALE_DEADLINE_S, "the upsize's CRD write")[0]
        up = patched[2]
        check([(p["name"], p["maxTenants"]) for p in up["spec"]["profiles"]]
              == [(f"{AUTOSCALE_TENANT}-s1", 1)]
              and as_crd.revision_of(up) == 2,
              f"the upsized CRD {up}")
        up_fp = as_crd.fingerprint(up["spec"])
        up_events = wait(lambda: (lambda ev: ev if ev and ev[-1].get(
            "state") == "Completed" else None)(flight(up_fp)),
            AUTOSCALE_DEADLINE_S, "the upsize's confirmation")
        with open(log_path, encoding="utf-8") as f:
            plan_lines = [ln for ln in f if f"autoscale re-plan {up_fp}"
                          in ln]
        check(plan_lines and "web:upsize" in plan_lines[0]
              and "(urgent)" in plan_lines[0],
              f"the upsize's plan line {plan_lines}")
        up_at = {e["state"]: e["ts"] for e in up_events}
        passes_to_plan = passes() - p0
        ms["upsize_to_planned"] = round((up_at["AutoscalePlanned"]
                                         - t_up_wall) * 1e3, 3)
        ms["upsize_to_crd"] = round((patched[0][0] - t_up) * 1e3, 3)
        w2 = wait(lambda: (lambda d: d if any(
            x["ts"] >= patched[0][1] for x in d["decisions"]) else None)(
                plugin.ask("watch")), AUTOSCALE_DEADLINE_S,
            "the watcher's decision on the upsize")
        check(sample("plans_total") == plans0 + 1,
              "more than one plan for the upsize")
        log(f"autoscale: (d) upsize: demand {upsized} B declared (3/4 of "
            f"the memory counter, not measured) -> planned "
            f"{ms['upsize_to_planned']} ms (urgent: "
            f"{plan_lines[0].split('autoscale re-plan ')[-1].strip()}) -> "
            f"CRD {AUTOSCALE_TENANT}-s1 revision 2 "
            f"{ms['upsize_to_crd']} ms, {passes_to_plan:.0f} passes seen "
            f"by the time it was confirmed (the window's p95 moves once "
            f"5% of its samples carry the new value); the watcher: "
            f"applied {w2['applied_total']}, failed {w2['failed_total']}, "
            f"last_error {w2['last_error']!r}")

        # The manual override: the managed flag flipped off.
        kube.patch(*crd_res, obj["metadata"]["name"], {"metadata": {
            "annotations": {as_crd.MANAGED_ANNOTATION: "false"}}})
        p0, conv0 = passes(), sample("converged_passes_total")
        plans0 = sample("plans_total")
        n_crd, n_slices = len(crd_writes), len(slice_writes)
        wait(lambda: passes() >= p0 + 4, 30, "the passes after the flip")
        override = {"passes": passes() - p0,
                    "converged": sample("converged_passes_total") - conv0,
                    "plans": sample("plans_total") - plans0,
                    "crd_writes": len(crd_writes) - n_crd,
                    "slice_writes": len(slice_writes) - n_slices}
        # A deferred pass plans nothing and never reaches convergence.
        check(override["converged"] <= 1 and override["plans"] == 0
              and override["crd_writes"] == 0
              and override["slice_writes"] == 0,
              f"the override {override}")
        log(f"autoscale: (d) override: managed flag off -> {override} "
            f"(deferred: no plan, no convergence, no write)")
        plugin_w = plugin.ask("watch")
        check(plugin_w["cuda"] is False, f"the plugin {plugin_w}")
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        check(rc == 0, f"the binary exited {rc}")
        check(plugin.close() == 0, "the plugin exited non-zero")
        plugin = None
        passed = True
        return child["launches"] + child["load_launches"]
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        if plugin is not None:
            plugin.close()
        if server is not None:
            log(f"autoscale: requests by method {dict(server.requests)}")
            server.stop()
        fleetstate.set_default_fleet(fleet_before)
        left = [t.name for t in threading.enumerate()
                if t not in threads_before and t.is_alive()]
        ms["phase"] = round((time.perf_counter() - t_phase) * 1e3, 3)
        log(f"autoscale: host ms {json.dumps(ms)} on {card}; threads left "
            f"{left}")
        if not passed:
            try:
                with open(f"{tmp}/scheduler.log", encoding="utf-8") as f:
                    log("autoscale: scheduler log tail: "
                        + f.read()[-3000:])
            except OSError:
                pass
        shutil.rmtree(tmp, ignore_errors=True)
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
    t_recovery = time.perf_counter()
    recovery_children = phase_recovery(args.seed)
    log(f"recovery: phase 21 in {time.perf_counter() - t_recovery:.1f} s")
    t_migration = time.perf_counter()
    migration = phase_migration(args.seed)
    log(f"migration: phase 22 in {time.perf_counter() - t_migration:.1f} s")
    t_autoscale = time.perf_counter()
    autoscale_child = phase_autoscale(args.seed)
    log(f"autoscale: phase 23 in {time.perf_counter() - t_autoscale:.1f} s")
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
        "recovery_claim_children": recovery_children,
        "migration_claim_children": migration["forward_lse"],
        "autoscale_tenant_child": autoscale_child,
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
            "pp_training_step": pp[kernel],
            "migration_claim_children": migration[kernel]}
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
