"""A DRA-aware scheduler and resourceclaim controller (the JAX package's
``pkg/scheduler.py``).

The upstream driver relies on kube-scheduler's DRA plugin and
kube-controller-manager's resourceclaim controller; a cluster of fakes
has neither, so this module does what they do, closely enough that the
port's kubelet plugins cannot tell:

1. **Claim generation**: a pod whose ``spec.resourceClaims[]`` entry
   names a ``resourceClaimTemplateName`` gets a ResourceClaim (owned by
   the pod) and a ``status.resourceClaimStatuses`` entry; a pod asking
   for an extended resource that a DeviceClass advertises
   (``spec.extendedResourceName``, KEP-5004) gets a claim against that
   class.
2. **Allocation** (structured parameters, KEP-4381): each unallocated
   claim is fitted on the published devices of each pool's newest
   generation, filtered by its DeviceClass's and its request's CEL
   selectors (``pkg/cel.py``), skipping devices allocated or tainted
   NoSchedule/NoExecute (unless tolerated), within the KEP-4815 shared
   counters and the node's power budget, with ``matchAttribute``
   constraints by a bounded backtracking search and the candidates of a
   request ordered by the ICI scorer (``pkg/topology``,
   ``TopologyAwarePlacement``; first-fit on devices without
   coordinates, as the port's GPUs). It writes ``status.allocation``
   (results, config, nodeSelector) with the ``sched.commit`` span's
   traceparent in the same patch, so the node's prepare joins the trace.
3. **Binding**: a pod whose claims are all allocated on one node is
   reserved on each (``reservedFor``) and gets ``spec.nodeName``.
4. The DaemonSet and Job controllers the ComputeDomain stack and the
   demo workloads need (one pod per matching node; one pod per Job).

5. **Permanent-failure recovery** (``attach_recovery``,
   ``pkg/recovery.EvictionController``): its pass runs first in every
   pass, over this scheduler's view, so the claims it deallocates
   re-place in the same pass; allocation never probes the nodes it has
   declared failed; a re-placement observes the SLO's ``evict`` phase.
6. **The fleet fold** (``pkg/fleetstate.FleetAggregator``): every pass
   ends by folding the inventory, the allocation state, the published
   telemetry attributes and the pending claims into the per-pool
   time-series (``/debug/fleet``, and ``FleetMetrics`` when
   ``fleet_metrics`` is given); the first fold makes this scheduler's
   aggregator the process default. A fold that raises is logged and
   never fails the pass.
7. **Cooperative migration** (``attach_migration``,
   ``pkg/migration.MigrationController``): its pass runs after
   recovery's and before allocation, so a claim it switches re-places
   onto its reserved window in the same pass.
8. **Active defragmentation** (``attach_defrag``,
   ``pkg/defrag.DefragController``): its pass runs after the fleet
   fold, whose fragmentation rings trigger it. Allocation honours both
   controllers: a claim's ``resource.tpu.dra/defrag-target`` hint puts
   its target node first and its target devices first in each
   request's order, and every device either controller has reserved is
   vetoed for every claim but the one it is reserved for.
9. **The serving autoscaler** (``attach_autoscaler``,
   ``pkg/autoscale.AutoscaleController``): its pass runs after the fleet
   fold, beside defrag's, so the pending-demand ring it reads is fresh;
   its reads come from this scheduler's view, and the fleet snapshot
   (``/debug/fleet``'s ``tenant_demand``) shows its store's percentiles.
10. **Scheduling domains** (``SchedulingDomain``, ``--sched-domain*``):
   a scheduler of a domain sees only its pools' devices and owns only
   the claims and pods annotated ``resource.tpu.dra/domain: <name>``
   (the default domain also the unannotated ones and the cluster-wide
   controllers); generated claims inherit their pod's domain. A pinned
   claim that fits nowhere in its domain spills to the cheapest sibling
   (``TPU_DRA_SPILLOVER``, ``..._MAX_HOPS``, ``..._ORDER_WEIGHT``,
   ``..._UTIL_WEIGHT``: the siblings' order and their utilization) with
   a ``DomainSpilled`` condition and Event, else carries
   ``DomainExhausted``.

Two modes run the same sync code. Polled: ``sync_once`` is one full
pass, ``run(interval)`` repeats it, every read lists through the API
server. Event mode (``start_event_driven``): ``schedcache.ClusterView``
puts an informer on every watched resource; each changed object becomes
a dirty key (``("claim", ns, name)``, ``("pod", ns, name)`` or a control
key such as ``("inventory",)``) on a ``pkg.workqueue.WorkQueue``, whose
worker allocates or binds that one object against the snapshot (rebuilt
per changed pool) and an allocation state retargeted, not rebuilt; a
full pass every ``TPU_DRA_SCHED_RESYNC`` seconds (30) is the safety net.
``workers`` > 1 (``TPU_DRA_SCHED_WORKERS``) shards claim and pod keys
over N-1 workers by namespace/name, with work stealing, beside one
worker for the control keys; a claim worker fits up to ``batch_max``
(``TPU_DRA_SCHED_BATCH``, 8) due claims against one snapshot. Disjoint
nodes commit in parallel under per-node locks; a commit refused at
reserve time re-fits (``COMMIT_RETRIES``). A commit log replays this
scheduler's own recent allocations into every rebuilt state, so an
informer that lags its own patch cannot hand the devices out twice.
Recovery, defrag and migration passes run on their dirty keys only
while their controller is ``busy()``; a PartitionSet event is the
autoscaler's key.

Run it as ``python -m k8s_dra_driver_gpu_tpu_torch.pkg.scheduler
--kube-api URL`` with the JAX binary's flags: ``--sched-mode
{events,poll}`` (``TPU_DRA_SCHED_MODE``, default ``events``),
``--interval S`` (poll mode), ``--sched-workers``, ``--sched-batch``,
``--sched-domain[-pools|-default|-siblings]``, ``--default-node``,
``--metrics-port``, ``--recovery-root``, ``--migration-root``,
``--defrag-root``, ``--autoscale-root`` (each root, else its
``TPU_DRA_*_ROOT``, attaches that controller over the directory's
records) and ``--leader-elect [--leader-elect-namespace NS]``. In event
mode the binary exits 1 if its informers have not listed within
``SYNC_TIMEOUT_S``; SIGTERM ends it with exit 0.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading
import time
import uuid

from . import fleetstate, flightrecorder, tracing
from .defrag import DEFRAG_TARGET_ANNOTATION, parse_target_hint
from .defrag import claim_device_demand as _defrag_claim_demand
from .events import emit_warning_event
from .featuregates import (
    TOPOLOGY_AWARE_PLACEMENT,
    FeatureGateError,
    FeatureGates,
)
from .kubeclient import ConflictError, KubeError, NotFoundError
from .schedcache import (DOMAIN_ANNOTATION, ORDER_MISS,
                         SPILLED_FROM_ANNOTATION, SPILLOVER_ANNOTATION,
                         SPILLOVER_HOPS_ANNOTATION, AllocationState,
                         Candidate, ClusterView, CompiledSelectors,
                         CounterLedger, InventorySnapshot,
                         NodeLockManager, SchedulingDomain, pool_key_of,
                         tolerates)
from .topology import TorusGrid, largest_free_shape
from .topology.score import frag_from_largest
from .topology import order_candidates as topo_order_candidates
from .topology import set_compactness

logger = logging.getLogger(__name__)

RESOURCE = ("resource.k8s.io", "v1")

# Safety-net full-resync period for the event-driven mode: dirty keys
# carry the steady state, this only catches watch gaps and software
# bugs. Override with TPU_DRA_SCHED_RESYNC (seconds).
DEFAULT_RESYNC_S = 30.0

# Sync-queue worker count (event mode). 1 = the historical serialized
# drain; N > 1 shards claim/pod keys over N-1 data workers plus one
# dedicated control-key worker (full resync, inventory, recovery --
# which therefore can never starve behind a claim flood). Override
# with --sched-workers / TPU_DRA_SCHED_WORKERS.
DEFAULT_SCHED_WORKERS = 1

# Max dirty claim keys drained against ONE inventory snapshot /
# device-class read (amortizes snapshot signature checks and static-CEL
# memo warmup across a burst). Override with TPU_DRA_SCHED_BATCH.
DEFAULT_SCHED_BATCH = 8

# Dirty-key kinds handled by the dedicated control worker (shard 0).
_CTL_KINDS = frozenset((
    "full", "pending", "inventory", "daemonsets", "jobs", "recovery",
    "defrag", "autoscale", "migration", "pods-rescan",
))


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, default))
    except ValueError:
        return default


def _meta(obj):
    return obj.get("metadata", {})


def _json_copy(obj):
    return json.loads(json.dumps(obj))


class _FitBudgetExceeded(Exception):
    """The bounded constraint DFS ran out of states (see MAX_FIT_STEPS)."""


class DraScheduler:
    """The scheduler: call ``sync_once()``, ``run()``/``start()`` (the
    polled loop) or ``start_event_driven()``."""

    def __init__(self, kube, default_node: str | None = None,
                 gates: FeatureGates | None = None, metrics=None,
                 sched_metrics=None, resync_period: float | None = None,
                 workers: int | None = None, batch_max: int | None = None,
                 domain: SchedulingDomain | None = None,
                 fleet_metrics=None):
        self.kube = kube
        self.default_node = default_node
        self._selectors = CompiledSelectors()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if workers is None:
            workers = _env_int("TPU_DRA_SCHED_WORKERS",
                               DEFAULT_SCHED_WORKERS)
        self.sched_workers = max(1, workers)
        if batch_max is None:
            batch_max = _env_int("TPU_DRA_SCHED_BATCH",
                                 DEFAULT_SCHED_BATCH)
        self.batch_max = max(1, batch_max)
        # Partitioned scheduling domain (scheduler-per-pool sharding):
        # None = this instance owns everything (the historical shape).
        self.domain = domain if domain is not None \
            else SchedulingDomain.from_env()
        # Cluster-wide controllers (DaemonSet/Job sync, recovery) run
        # in exactly one domain; non-default domain instances only
        # allocate/bind their own claims and pods.
        self._cluster_controllers = (self.domain is None
                                     or self.domain.default)
        if gates is None:
            try:
                gates = FeatureGates.parse(os.environ.get("FEATURE_GATES",
                                                          ""))
            except FeatureGateError:
                # A malformed FEATURE_GATES env must not kill the
                # control plane; defaults are the safe fallback.
                logger.exception("FEATURE_GATES unparseable; using defaults")
                gates = FeatureGates()
        self.gates = gates
        # ICI topology-aware device picking (pkg/topology). Off = the
        # historical first-fit order, which also remains the automatic
        # fallback whenever devices publish no usable coordinates.
        self._topology = gates.is_enabled(TOPOLOGY_AWARE_PLACEMENT)
        self.metrics = metrics  # PlacementMetrics or None
        self.sched_metrics = sched_metrics  # SchedulerMetrics or None
        if resync_period is None:
            try:
                resync_period = float(os.environ.get(
                    "TPU_DRA_SCHED_RESYNC", DEFAULT_RESYNC_S))
            except ValueError:
                resync_period = DEFAULT_RESYNC_S
        self.resync_period = resync_period
        # Cross-domain claim spillover (pkg/schedcache annotations):
        # enabled for pool-restricted domains with configured siblings
        # unless the master switch turns it off. Knobs:
        # TPU_DRA_SPILLOVER (default on), TPU_DRA_SPILLOVER_MAX_HOPS,
        # TPU_DRA_SPILLOVER_ORDER_WEIGHT / _UTIL_WEIGHT.
        self._spillover_enabled = os.environ.get(
            "TPU_DRA_SPILLOVER", "1") not in ("0", "false", "False")
        self._spillover_max_hops = _env_int(
            "TPU_DRA_SPILLOVER_MAX_HOPS", 1)
        # Migration-cost weights: the operator's sibling ORDER is the stated
        # preference, the sibling's current utilization is the
        # congestion cost of moving there.
        try:
            self._spill_order_weight = float(os.environ.get(
                "TPU_DRA_SPILLOVER_ORDER_WEIGHT", "1.0"))
        except ValueError:
            self._spill_order_weight = 1.0
        try:
            self._spill_util_weight = float(os.environ.get(
                "TPU_DRA_SPILLOVER_UTIL_WEIGHT", "10.0"))
        except ValueError:
            self._spill_util_weight = 10.0
        # Sibling-capacity memo: (expires, {sibling -> (free, total)}).
        # Spill decisions are rare (exhaustion events), but an
        # exhausted-domain claim FLOOD must not scan claims per claim.
        # The lock makes rank+debit atomic across sharded workers --
        # two workers spilling concurrently must not both judge the
        # same pre-debit free count and overshoot the sibling.
        self._spill_capacity_memo: tuple[float, dict] | None = None
        self._spill_lock = threading.Lock()
        # All reads in sync paths go through the view: informer caches
        # in event mode, list-through in direct mode.
        self.view = ClusterView(
            kube, on_event=self._on_informer_event,
            on_relist=self._on_informer_relist,
            default_node=default_node,
            pool_filter=(self.domain.owns_pool
                         if self.domain is not None and self.domain.pools
                         else None),
            on_snapshot_build=self._on_snapshot_build,
            on_snapshot_delta=self._on_snapshot_delta,
            on_relist_backoff=self._on_relist_backoff)
        # Inventory snapshot + incrementally-maintained allocation
        # state; rebuilt whenever the snapshot changes and on every
        # full pass (the safety property of the resync).
        self._snap: InventorySnapshot | None = None
        self._alloc: AllocationState | None = None
        # Registry lock: guards the snapshot/alloc-state IDENTITY, the
        # commit log, and the pod<->claim indexes. Held briefly only --
        # never across kube I/O or a fit. Fine-grained
        # allocation safety lives in the per-node locks + the
        # AllocationState's atomic try_commit instead, so disjoint
        # allocations commit in parallel. Documented hierarchy:
        # node locks -> _state_lock -> AllocationState._alloc_lock.
        self._state_lock = threading.RLock()
        # Per-node allocation locks: same-node contenders serialize,
        # gang/CD-window claims take their window as one sorted lock
        # set, commit kube I/O is sanctioned under these only.
        self._node_locks = NodeLockManager()
        # Allocations THIS scheduler committed recently, replayed into
        # every rebuilt AllocationState: with a real apiserver the
        # informer cache can lag our own allocation patch, and a
        # rebuild from that stale cache would otherwise see the devices
        # as free and double-allocate them. Entries retire when the
        # cache catches up (the claim's watch event carries the
        # allocation) or after the TTL.
        self._commit_log: dict[tuple[str, str], tuple[float, dict]] = {}
        # Event mode plumbing.
        self._queue = None  # WorkQueue, created by start_event_driven
        self._resync_thread: threading.Thread | None = None
        # pod <-> claim reverse index (event mode): which pods to
        # re-check when a claim changes, without scanning all pods.
        self._pods_of_claim: dict[tuple[str, str], set[str]] = {}
        self._claims_of_pod: dict[tuple[str, str], set[str]] = {}
        # Permanent-failure recovery (pkg/recovery.EvictionController):
        # attached controllers ride this scheduler's sync loop (node /
        # slice / claim events + the safety resync) and veto allocation
        # onto permanently failed nodes.
        self.recovery = None
        # Active defragmentation (pkg/defrag.DefragController): rides
        # the same loop (full passes + claim events while moves are in
        # flight); its device reservations veto allocation off carve
        # cells and move targets, and its placement hints steer the
        # re-placement of moving claims.
        self.defrag = None
        # Serving autoscaler (pkg/autoscale.AutoscaleController):
        # rides the same loop (full passes + PartitionSet CRD events)
        # and re-plans the fleet's partition layout from live tenant
        # demand; its rollouts land as CRD writes the node plugins'
        # watchers converge on.
        self.autoscaler = None
        # Cooperative migration (pkg/migration.MigrationController):
        # rides the same loop (full passes + claim events while
        # handshakes are in flight); its destination reservations veto
        # allocation exactly like defrag's, and its switch stage
        # stamps the defrag placement hint to steer the re-placement.
        self.migration = None
        # Claim-lifecycle flight recorder (pkg/flightrecorder): every
        # dirty-key enqueue / fit outcome / commit conflict / patch
        # lands in the bounded ring served at /debug/claims.
        self.flight = flightrecorder.default()
        # Fleet telemetry aggregator (pkg/fleetstate): every full pass
        # folds the inventory snapshot + allocation state + published
        # node-telemetry attributes into per-pool utilization /
        # fragmentation time-series (served at /debug/fleet, exported
        # through FleetMetrics when the registry is wired). The
        # process default (/debug/fleet, doctor bundles) is claimed
        # lazily on the FIRST fold -- a merely-constructed scheduler
        # (tests build several per process) never repoints the live
        # one's endpoint at an empty aggregator.
        self.fleet = fleetstate.FleetAggregator(metrics=fleet_metrics)
        self._fleet_installed = False
        # Per-worker fit-phase start time (SLO phase accounting).
        self._fit_tls = threading.local()

    @property
    def _slo(self):
        """The claim-lifecycle SLO histogram, or None without metrics."""
        return (self.sched_metrics.slo
                if self.sched_metrics is not None else None)

    def attach_recovery(self, controller) -> "DraScheduler":
        """Drive a ``pkg/recovery.EvictionController`` from this
        scheduler's pass: its reads come from this scheduler's view, its
        re-placements observe the SLO's ``evict`` phase on this
        scheduler's registry, and allocation excludes the nodes it has
        declared permanently failed."""
        controller.view = self.view
        if self.sched_metrics is not None:
            controller.slo = self.sched_metrics.slo
        self.recovery = controller
        return self

    def attach_defrag(self, controller) -> "DraScheduler":
        """Drive a ``pkg/defrag.DefragController`` from this scheduler's
        pass: its sync runs in every pass after the fleet fold, so the
        frag rings it triggers on are fresh; its reads come from this
        scheduler's view, and its trigger reads this scheduler's fleet
        unless it was given one; allocation honours its placement hints
        and vetoes its device reservations."""
        controller.view = self.view
        if controller.fleet is None:
            controller.fleet = self.fleet
        self.defrag = controller
        return self

    def attach_migration(self, controller) -> "DraScheduler":
        """Drive a ``pkg/migration.MigrationController`` from this
        scheduler's pass: its sync runs in every pass right after
        recovery's, so a claim switched in a pass re-places in the same
        pass; its reads come from this scheduler's view; allocation
        vetoes its destination reservations beside defrag's."""
        controller.view = self.view
        self.migration = controller
        return self

    def attach_autoscaler(self, controller) -> "DraScheduler":
        """Drive a pkg/autoscale.AutoscaleController from this
        scheduler's loop: its sync runs inside every full pass (after
        the fleet fold, so the pending-demand ring it consults is
        fresh) and on PartitionSet CRD dirty keys; its reads come from
        this scheduler's informer-backed view; its TenantProfileStore
        percentiles surface at /debug/fleet next to the rings."""
        controller.view = self.view
        if controller.fleet is None:
            controller.fleet = self.fleet
        if self.fleet is not None:
            self.fleet.attach_profile_store(controller.store)
        self.autoscaler = controller
        return self

    # -- sharding plumbing ----------------------------------------------------

    @property
    def _sharded(self) -> bool:
        """Multi-worker event mode: per-object work (claim allocation,
        pod generation/binding) must run on its key's shard, so full
        passes fan out dirty keys instead of doing that work inline."""
        return self._queue is not None and self.sched_workers > 1

    def _shard_of(self, key: tuple):
        """Control keys pin to worker 0 (the recovery/resync lane,
        immune to claim floods); claim/pod keys hash namespace/name
        over the remaining workers."""
        kind = key[0]
        if kind in _CTL_KINDS or self.sched_workers == 1:
            return 0
        from .workqueue import stable_shard_hash  # noqa: PLC0415

        h = stable_shard_hash(f"{key[1]}/{key[2]}" if len(key) >= 3
                              else kind)
        return 1 + h % (self.sched_workers - 1)

    @staticmethod
    def _stealable(key: tuple) -> bool:
        """Only per-object data keys (claim/pod) may migrate to an idle
        worker; control keys keep their dedicated worker-0 lane."""
        return isinstance(key, tuple) and bool(key) and \
            key[0] not in _CTL_KINDS

    def _on_snapshot_build(self, seconds: float) -> None:
        if self.sched_metrics is not None:
            self.sched_metrics.snapshot_build.observe(seconds)

    def _on_snapshot_delta(self, pool_label: str,
                           seconds: float) -> None:
        if self.sched_metrics is not None:
            self.sched_metrics.snapshot_delta.labels(
                pool_label).observe(seconds)

    def _on_relist_backoff(self, resource: str, seconds: float) -> None:
        if self.sched_metrics is not None:
            self.sched_metrics.relist_backoff.labels(
                resource).observe(seconds)

    def _owns(self, obj: dict) -> bool:
        """Domain routing for claims and pods; domainless schedulers
        own everything."""
        return self.domain is None or self.domain.owns_object(obj)

    # -- claim generation (kcm resourceclaim controller) ----------------------

    def _pods(self) -> list[dict]:
        try:
            return self.view.pods()
        except KubeError:
            return []

    def _generate_claims(self):
        for pod in self._pods():
            if not self._owns(pod):
                continue
            refs = pod.get("spec", {}).get("resourceClaims") or []
            have = {s["name"] for s in pod.get("status", {}).get(
                "resourceClaimStatuses") or []}
            if not any(r.get("resourceClaimTemplateName")
                       and r["name"] not in have for r in refs):
                continue
            if self._sharded:
                # Per-pod work belongs to the pod's shard: two workers
                # generating for one pod would double-create the
                # uuid-suffixed claims.
                self._enqueue(("pod", _meta(pod).get("namespace",
                                                     "default"),
                               _meta(pod)["name"]))
                continue
            if self.view.event_driven:
                # Generated claim names carry a uuid suffix, so a
                # ConflictError can never dedupe them: in event mode
                # the cached pod may lag our OWN status patch, and
                # generating off it would orphan the first claim.
                # Re-read the pod before deciding.
                try:
                    pod = self.kube.get(
                        "", "v1", "pods", _meta(pod)["name"],
                        namespace=_meta(pod).get("namespace", "default"))
                except NotFoundError:
                    continue
            self._generate_claims_for(pod)

    def _generate_claims_for(self, pod) -> bool:
        """Template-driven claim generation for one pod. Returns True
        when the pod's claim statuses were extended."""
        refs = pod.get("spec", {}).get("resourceClaims") or []
        statuses = pod.get("status", {}).get(
            "resourceClaimStatuses") or []
        have = {s["name"] for s in statuses}
        ns = _meta(pod).get("namespace", "default")
        new_statuses = []
        for ref in refs:
            tmpl = ref.get("resourceClaimTemplateName")
            if not tmpl or ref["name"] in have:
                continue
            try:
                template = self.view.get_template(tmpl, namespace=ns)
            except NotFoundError:
                continue  # template not applied yet; retry next pass
            claim_name = (f"{_meta(pod)['name']}-{ref['name']}-"
                          f"{uuid.uuid4().hex[:5]}")
            annotations = {
                "resource.kubernetes.io/pod-claim-name": ref["name"],
            }
            # Generated claims inherit the pod's scheduling domain so
            # the owning domain scheduler allocates them.
            pod_domain = (_meta(pod).get("annotations") or {}).get(
                DOMAIN_ANNOTATION)
            if pod_domain:
                annotations[DOMAIN_ANNOTATION] = pod_domain
            claim = {
                "apiVersion": "resource.k8s.io/v1",
                "kind": "ResourceClaim",
                "metadata": {
                    "name": claim_name,
                    "namespace": ns,
                    "uid": f"claim-{uuid.uuid4().hex[:12]}",
                    "annotations": annotations,
                    "ownerReferences": [{
                        "apiVersion": "v1", "kind": "Pod",
                        "name": _meta(pod)["name"],
                        "uid": _meta(pod).get("uid", ""),
                        "controller": True,
                    }],
                },
                "spec": template.get("spec", {}).get("spec", {}),
            }
            try:
                self.kube.create(*RESOURCE, "resourceclaims", claim,
                                 namespace=ns)
            except ConflictError:
                pass
            new_statuses.append(
                {"name": ref["name"], "resourceClaimName": claim_name})
        if new_statuses:
            self.kube.patch(
                "", "v1", "pods", _meta(pod)["name"],
                {"status": {"resourceClaimStatuses":
                            statuses + new_statuses}},
                namespace=ns)
            return True
        return False

    def _generate_extended_resource_claims(self):
        """KEP-5004: a pod asking for an extended resource that a
        DeviceClass advertises (``spec.extendedResourceName``) gets a
        claim against that class, recorded in the pod's
        ``status.extendedResourceClaimStatus``."""
        try:
            by_resource = self._extended_resource_classes()
        except KubeError:
            return
        if not by_resource:
            return
        for pod in self._pods():
            if not self._owns(pod):
                continue
            if self._sharded:
                if self._pod_wants_extended_claim(pod, by_resource):
                    self._enqueue(("pod",
                                   _meta(pod).get("namespace", "default"),
                                   _meta(pod)["name"]))
                continue
            self._generate_extended_resource_claims_for(pod, by_resource)

    @staticmethod
    def _pod_wants_extended_claim(pod, by_resource) -> bool:
        """Cheap pre-filter for the sharded fan-out: would
        _generate_extended_resource_claims_for even consider this pod?"""
        if pod.get("status", {}).get("extendedResourceClaimStatus"):
            return False
        if pod.get("spec", {}).get("nodeName"):
            return False
        if pod.get("status", {}).get("phase") not in (None, "", "Pending"):
            return False
        return any(
            rname in by_resource
            for c in pod.get("spec", {}).get("containers", [])
            for rname in ((c.get("resources") or {}).get("limits") or {})
        )

    def _generate_extended_resource_claims_for(self, pod,
                                               by_resource) -> bool:
        if pod.get("status", {}).get("extendedResourceClaimStatus"):
            return False
        # KEP-5004 generates claims only while a pod is still being
        # SCHEDULED: one already bound (spec.nodeName set -- e.g.
        # scheduled before the class advertised
        # extendedResourceName, or born bound like a DaemonSet pod)
        # or past Pending must not retroactively acquire devices
        # and double-count them under a running workload.
        if pod.get("spec", {}).get("nodeName"):
            return False
        if pod.get("status", {}).get("phase") not in (None, "",
                                                      "Pending"):
            return False
        if _meta(pod).get("deletionTimestamp"):
            return False
        requests, mappings = [], []
        bad_qty = None
        for c in pod.get("spec", {}).get("containers", []):
            limits = (c.get("resources") or {}).get("limits") or {}
            for rname, qty in limits.items():
                cls_name = by_resource.get(rname)
                if not cls_name:
                    continue
                # Extended-resource quantities must be whole
                # numbers; a malformed one must not wedge the
                # whole scheduling pass.
                try:
                    count = int(str(qty))
                except ValueError:
                    logger.warning(
                        "pod %s/%s: non-integer extended-resource "
                        "quantity %s=%r; skipping pod",
                        _meta(pod).get("namespace", "default"),
                        _meta(pod)["name"], rname, qty)
                    bad_qty = f"{rname}={qty!r}"
                    break
                req = f"request-{len(mappings)}"
                exactly: dict = {"deviceClassName": cls_name}
                if count != 1:
                    exactly["count"] = count
                requests.append({"name": req, "exactly": exactly})
                mappings.append({
                    "containerName": c.get("name", ""),
                    "resourceName": rname,
                    "requestName": req,
                })
            if bad_qty:
                break
        if bad_qty:
            # The pod can never schedule (the generation skip keeps
            # _pending_extended_resource blocking its bind forever):
            # surface that ON THE POD -- real k8s rejects
            # non-integer extended resources at admission, but this
            # control plane has no pod admission, so a condition +
            # event is the observable analog.
            self._flag_unschedulable_pod(
                pod, "InvalidExtendedResourceQuantity",
                f"extended-resource quantity {bad_qty} is not a "
                "whole number; the pod cannot be scheduled")
            return False
        if not requests:
            return False
        ns = _meta(pod).get("namespace", "default")
        # DETERMINISTIC name (pod uid, not uuid4): create + status
        # patch are not atomic, and a retried pass must converge on
        # the same claim instead of leaking allocated orphans.
        pod_uid = _meta(pod).get("uid", "") or _meta(pod)["name"]
        claim_name = (f"{_meta(pod)['name']}-extended-resources-"
                      f"{pod_uid[-5:]}")
        annotations = {}
        # Like template-generated claims: inherit the pod's scheduling
        # domain so the owning domain scheduler allocates it.
        pod_domain = (_meta(pod).get("annotations") or {}).get(
            DOMAIN_ANNOTATION)
        if pod_domain:
            annotations[DOMAIN_ANNOTATION] = pod_domain
        claim = {
            "apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaim",
            "metadata": {
                "name": claim_name,
                "namespace": ns,
                "uid": f"claim-{uuid.uuid4().hex[:12]}",
                "annotations": annotations,
                "ownerReferences": [{
                    "apiVersion": "v1", "kind": "Pod",
                    "name": _meta(pod)["name"],
                    "uid": _meta(pod).get("uid", ""),
                    "controller": True,
                }],
            },
            "spec": {"devices": {"requests": requests}},
        }
        try:
            self.kube.create(*RESOURCE, "resourceclaims", claim,
                             namespace=ns)
        except ConflictError:
            pass  # an earlier pass created it; converge on it
        self.kube.patch(
            "", "v1", "pods", _meta(pod)["name"],
            {"status": {"extendedResourceClaimStatus": {
                "resourceClaimName": claim_name,
                "requestMappings": mappings,
            }}},
            namespace=ns)
        logger.info(
            "generated extended-resource claim %s/%s for pod %s",
            ns, claim_name, _meta(pod)["name"])
        return True

    def _flag_unschedulable_pod(self, pod, reason: str,
                                message: str) -> None:
        """A PodScheduled=False condition and a Warning Event on a pod
        that cannot schedule; nothing when the condition already says
        this."""
        ns = _meta(pod).get("namespace", "default")
        name = _meta(pod)["name"]
        conditions = pod.get("status", {}).get("conditions") or []
        for c in conditions:
            if c.get("type") == "PodScheduled" and \
                    c.get("reason") == reason and \
                    c.get("message") == message:
                return
        kept = [c for c in conditions if c.get("type") != "PodScheduled"]
        kept.append({
            "type": "PodScheduled",
            "status": "False",
            "reason": reason,
            "message": message,
        })
        try:
            self.kube.patch("", "v1", "pods", name,
                            {"status": {"conditions": kept}},
                            namespace=ns)
        except (NotFoundError, ConflictError):
            return
        emit_warning_event(
            self.kube, event_name=f"{name}.{uuid.uuid4().hex[:10]}",
            namespace=ns, reason=reason, message=message,
            involved_kind="Pod", involved_name=name,
            involved_uid=_meta(pod).get("uid", ""),
            component="tpu-dra-scheduler")

    # -- allocation (kube-scheduler DRA plugin) -------------------------------

    # Commit-log retention: long enough to outlive any realistic watch
    # lag between our allocation patch and its event, short enough to
    # bound memory. Replay is idempotent, so erring long is safe.
    COMMIT_LOG_TTL_S = 120.0

    def _replay_commits_locked(self, claims: list[dict]) -> None:
        """Fold recently committed allocations into the (freshly
        rebuilt) allocation state. Caller holds _state_lock; ``claims``
        is the list the rebuild used.

        In direct mode that list is a FRESH kube list, so an entry for
        an absent claim means the claim was deleted -- and an entry
        for a PRESENT claim with no allocation means it was
        deallocated (e.g. the recovery controller's drain): drop both
        (their devices are free again). In event mode the cache may
        lag our own claim's create, so entries survive until the
        claim's allocation-bearing event retires them or the TTL."""
        now = time.monotonic()
        present = {(c.get("metadata", {}).get("namespace", "default"),
                    c.get("metadata", {}).get("name", "")): c
                   for c in claims}
        authoritative = not self.view.event_driven
        for key in list(self._commit_log):
            t, claim_like = self._commit_log[key]
            live = present.get(key)
            stale = authoritative and (
                live is None
                or not live.get("status", {}).get("allocation"))
            if now - t > self.COMMIT_LOG_TTL_S or stale:
                del self._commit_log[key]
            else:
                self._alloc.observe(claim_like)

    def _ensure_alloc_state(self) -> tuple[InventorySnapshot,
                                           AllocationState]:
        """Current snapshot + allocation state. The snapshot read
        happens OUTSIDE _state_lock (it has its own lock + event-mode
        fast path), so the hot path costs one brief identity check.

        When the view can answer WHICH pools changed between the state
        we hold and the new snapshot (the per-pool delta log), the
        allocation state RETARGETS in O(changed pools) -- a slice
        event no longer costs an O(claims) rebuild. A full rebuild
        survives as the fallback for unstamped snapshots, full
        resyncs, and log gaps."""
        snap = self.view.snapshot()
        with self._state_lock:
            if snap is self._snap and self._alloc is not None:
                return self._snap, self._alloc
            changed = None
            if self._alloc is not None and self._snap is not None:
                changed = self.view.changed_pools_between(
                    self._snap, snap)
            if changed is not None:
                self._alloc.retarget(snap, changed)
                self._snap = snap
            else:
                self._snap = snap
                self._alloc = AllocationState(snap)
                claims = self.view.claims()
                self._alloc.rebuild(claims)
                self._replay_commits_locked(claims)
            return self._snap, self._alloc

    def _rebuild_alloc_state(self) -> tuple[InventorySnapshot,
                                            AllocationState]:
        """Full defensive rebuild (every full pass does this, which is
        what makes the safety resync actually safe)."""
        snap = self.view.snapshot()
        with self._state_lock:
            self._snap = snap
            self._alloc = AllocationState(snap)
            claims = self.view.claims()
            self._alloc.rebuild(claims)
            self._replay_commits_locked(claims)
            return self._snap, self._alloc

    def _device_matches(self, snap: InventorySnapshot, cand: Candidate,
                        selectors: list[dict],
                        tolerations: list[dict]) -> bool:
        for taint in cand.blocking_taints:
            if not tolerates(taint, tolerations):
                return False
        for sel in selectors:
            expr = (sel.get("cel") or {}).get("expression", "")
            prog = self._selectors.get(expr)
            if prog is None or not snap.cel_match(expr, prog, cand):
                return False
        return True

    def _device_classes(self) -> dict[str, dict]:
        return {_meta(c)["name"]: c for c in self.view.device_classes()}

    # Optimistic-commit retry budget: a conflict means another worker
    # reserved a device/counter between our fit and our try_commit;
    # each retry re-fits against fresh state. Same-node contenders are
    # already serialized by the node lock, so conflicts only come from
    # cross-node counter races and are rare.
    COMMIT_RETRIES = 4

    def _candidate_nodes(self, claim, snap: InventorySnapshot,
                         alloc: AllocationState, window: set,
                         pinned_node: str | None) -> list[str]:
        """The node order for one claim: a ComputeDomain window first,
        then least-allocated (the spreading of a per-pod Filter/Score),
        and a moving claim's hinted target node before all. A claim
        whose consumer pod is bound probes that node alone."""
        if pinned_node is not None:
            nodes = [pinned_node] if pinned_node in snap.by_node else []
        else:
            nodes = alloc.ordered_nodes()
            if window:
                nodes = ([n for n in nodes if n in window]
                         + [n for n in nodes if n not in window])
            hint = self._defrag_hint(claim)
            if hint is not None and hint[0] in snap.by_node:
                # A preference only: every other node stays in the walk,
                # so a stale hint costs placement quality, never a fit.
                nodes = [hint[0]] + [n for n in nodes if n != hint[0]]
        if self.recovery is not None:
            # A dead node's slices may still be published (its kubelet
            # cannot retract them): never re-place a claim onto it.
            excluded = self.recovery.excluded_nodes()
            if excluded:
                nodes = [n for n in nodes if n not in excluded]
        return nodes

    def _allocate_one(self, claim, snap: InventorySnapshot,
                      alloc: AllocationState, classes,
                      pinned_node: str | None = None) -> str:
        """One claim through the sharded allocation protocol:

        1. **Fit** per candidate node under that node's lock (gang /
           CD-window claims take the whole window as one sorted
           multi-node lock set), reading allocation state optimistically.
        2. **Reserve** atomically (``AllocationState.try_commit``): the
           planned devices must still be free and the counter budgets
           must still fit; a conflict re-fits against fresh state.
        3. **Commit** the kube patch while still holding the node lock
           (same-node contenders serialize; disjoint nodes proceed in
           parallel); a failed patch releases the reservation so a
           write that never landed never leaks a debit
           (commit-then-observe).

        Returns the final outcome ("committed" | "unfit" | "failed" |
        "conflict" | "norequests"). ``pinned_node`` restricts placement
        to the node a consumer pod is already bound to (real DRA
        allocates during that pod's scheduling, so the choice is
        inherently per-node)."""
        requests = claim.get("spec", {}).get("devices", {}).get(
            "requests", [])
        if not requests:
            return "norequests"
        # ComputeDomain gangs first try the ICI-adjacent host window
        # the CD controller picked; load still spreads the gang's
        # members WITHIN the window, and non-window nodes remain as
        # overflow so a full window degrades instead of wedging.
        window = set(self._preferred_gang_nodes(claim) or ())
        ns = _meta(claim).get("namespace", "default")
        uid = _meta(claim).get("uid", "")
        with tracing.span("sched.claim", attrs={
                "claim": f"{ns}/{_meta(claim).get('name', '?')}",
                "claim_uid": uid}) as claim_span:
            # Fit-phase clock for the SLO breakdown: everything from
            # here until the winning try_commit is "fit" (candidate
            # walk, constraint DFS, conflict re-fits). Thread-local:
            # N workers allocate concurrently.
            self._fit_tls.t0 = time.monotonic()
            outcome = "unfit"
            for _attempt in range(self.COMMIT_RETRIES):
                if _attempt:
                    # A conflict means our captured state is stale --
                    # typically a safety-resync rebuild swapped in a
                    # fresh AllocationState mid-batch and the old
                    # object stopped receiving observes. Re-fit
                    # against the LIVE state or every retry keeps
                    # picking the same stolen devices.
                    with self._state_lock:
                        if self._alloc is not None:
                            alloc = self._alloc
                        if self._snap is not None:
                            snap = self._snap
                nodes = self._candidate_nodes(claim, snap, alloc,
                                              window, pinned_node)
                # One ledger copy per attempt, shared across every
                # probed node: the fit is optimistic anyway (try_commit
                # re-judges budgets at reserve time), so a pending
                # claim walking all 1000 nodes doesn't pay 1000 locked
                # copies. The power-debit view rides along the same
                # way (one copy per attempt, re-judged at reserve).
                ledger = alloc.ledger_snapshot()
                power = alloc.power_snapshot()
                outcome = self._try_nodes(claim, nodes, window, snap,
                                          alloc, ledger, classes,
                                          power)
                if outcome == "committed":
                    self._clear_domain_exhausted(claim)
                    break
                if outcome != "conflict":
                    break
                if self.sched_metrics is not None:
                    self.sched_metrics.commit_conflicts.inc()
            claim_span.set_attr("outcome", outcome)
        self.flight.record(
            uid or f"{ns}/{_meta(claim).get('name', '?')}", "fit",
            alias=f"{ns}/{_meta(claim).get('name', '?')}",
            trace_id=(claim_span.context.trace_id
                      if claim_span.recording else ""),
            outcome=outcome)
        if outcome == "committed":
            return outcome
        if outcome == "conflict":
            logger.warning(
                "claim %s/%s: %d consecutive commit conflicts; leaving "
                "pending for the next sync",
                _meta(claim).get("namespace", "default"),
                _meta(claim).get("name", "?"), self.COMMIT_RETRIES)
        elif outcome == "unfit" and pinned_node is None:
            # A domain-pinned claim that found no fit spills to a
            # sibling domain (annotating intent) instead of pending
            # forever; only when it cannot spill does it surface the
            # exhaustion condition.
            if not self._maybe_spill(claim):
                self._flag_domain_exhausted(claim)
        return outcome

    def _try_nodes(self, claim, nodes: list[str], window: set,
                   snap: InventorySnapshot, alloc: AllocationState,
                   ledger: CounterLedger, classes,
                   power: dict | None = None) -> str:
        """Walk the candidate nodes under per-node locks; window gangs
        take their whole (sorted) window lock set in ONE acquisition so
        two gangs overlapping on any node cannot deadlock. Returns
        "committed" | "conflict" | "failed" | "unfit"."""
        if window:
            win_nodes = [n for n in nodes if n in window]
            if win_nodes:
                with self._node_locks.hold(win_nodes):
                    out = self._fit_and_commit(claim, win_nodes, snap,
                                               alloc, ledger, classes,
                                               power)
                if out != "unfit":
                    return out
            rest = [n for n in nodes if n not in window]
        else:
            rest = nodes
        for node in rest:
            with self._node_locks.hold((node,)):
                out = self._fit_and_commit(claim, (node,), snap, alloc,
                                           ledger, classes, power)
            if out != "unfit":
                return out
        return "unfit"

    def _fit_and_commit(self, claim, nodes, snap: InventorySnapshot,
                        alloc: AllocationState, ledger: CounterLedger,
                        classes, power: dict | None = None) -> str:
        """Fit and commit on the first of ``nodes`` that takes the claim."""
        for node in nodes:
            picks = self._fit_on_node(claim, node, snap, alloc.allocated,
                                      ledger, classes, power=power)
            if picks is None:
                continue
            alloc_obj = self._build_alloc_obj(claim, node, picks, classes)
            return self._commit_allocation(claim, alloc_obj, snap, alloc)
        return "unfit"

    def _build_alloc_obj(self, claim, node, picks, classes) -> dict:
        results, configs = [], []
        seen_classes = []
        for req_name, cand, class_name in picks:
            results.append({
                "request": req_name,
                "driver": cand.driver,
                "pool": cand.pool,
                "device": cand.name,
            })
            if class_name not in seen_classes:
                seen_classes.append(class_name)
        for class_name in seen_classes:
            for cfg in classes.get(class_name, {}).get(
                    "spec", {}).get("config", []) or []:
                if "opaque" in cfg:
                    configs.append({
                        "opaque": cfg["opaque"],
                        "requests": [],
                        "source": "FromClass",
                    })
        for cfg in claim.get("spec", {}).get("devices", {}).get(
                "config", []) or []:
            if "opaque" in cfg:
                configs.append({
                    "opaque": cfg["opaque"],
                    "requests": cfg.get("requests", []),
                    "source": "FromClaim",
                })
        bind_node = node or self.default_node
        alloc_obj = {"devices": {"results": results, "config": configs}}
        if bind_node:
            alloc_obj["nodeSelector"] = {"nodeSelectorTerms": [{
                "matchFields": [{
                    "key": "metadata.name",
                    "operator": "In",
                    "values": [bind_node],
                }],
            }]}
        return alloc_obj

    # DFS budget for the constraint-aware fit: a claim that cannot be
    # decided within this many visited states is treated as unsatisfiable
    # on the node (and logged). Topology claims are tiny (a handful of
    # requests over tens of devices); the bound only guards pathological
    # specs.
    MAX_FIT_STEPS = 20_000

    @staticmethod
    def _attr_value(cand: Candidate, attr: str):
        """A typed attribute as a comparable (type, value), or None. A
        driver's own attributes may be named qualified ("<driver>/name")
        or plain (structured parameters)."""
        attrs = cand.device.get("attributes") or {}
        entry = attrs.get(attr)
        if entry is None and "/" in attr:
            domain, _, base = attr.partition("/")
            if domain == cand.driver:
                entry = attrs.get(base)
        if not isinstance(entry, dict):
            return None
        for kind in ("string", "int", "bool", "version"):
            if kind in entry:
                return (kind, entry[kind])
        return None

    # -- ICI topology-aware ordering (pkg/topology) ---------------------------

    @staticmethod
    def _grid_for(cands: list[Candidate]) -> TorusGrid:
        return TorusGrid.from_devices([c.device for c in cands])

    def _topology_order(self, snap: InventorySnapshot,
                        cands: list[Candidate],
                        want: int | None) -> list[Candidate]:
        """One request's candidates with the scorer's best sub-torus
        placements first. Only the order changes, so the fit decides as
        before; with no usable coordinates the first-fit order stays as
        it was. The orderings are memoized on the snapshot."""
        if want is None or want < 1 or len(cands) < 2:
            return cands
        by_pool: dict[tuple, list[Candidate]] = {}
        for c in cands:
            by_pool.setdefault((c.driver, c.pool), []).append(c)
        out: list[Candidate] = []
        any_signal = False
        for (driver, pool), group in by_pool.items():
            ordered = None
            if len(group) >= want:
                names = tuple(c.name for c in group)
                key = (driver, pool, names, want)
                hit = snap.order_memo_get(key)
                if hit is not ORDER_MISS:
                    ordered = hit
                else:
                    penalties = {c.name: c.headroom_penalty
                                 for c in group if c.headroom_penalty}
                    ordered = topo_order_candidates(
                        self._grid_for(group), list(names), want,
                        penalties=penalties or None)
                    snap.order_memo_put(key, ordered)
            if ordered is None:
                out.extend(group)
            else:
                any_signal = True
                by_name = {c.name: c for c in group}
                out.extend(by_name[n] for n in ordered)
        # No pool ranked anything: the original interleaved order.
        return out if any_signal else cands

    @staticmethod
    def _defrag_hint(claim) -> tuple[str, list[str]] | None:
        """A moving claim's placement hint, (target node, target device
        names), from the ``resource.tpu.dra/defrag-target`` annotation
        the defrag and migration controllers stamp before deallocating;
        None without one or for a malformed one."""
        raw = (_meta(claim).get("annotations") or {}).get(
            DEFRAG_TARGET_ANNOTATION)
        if not raw:
            return None
        return parse_target_hint(raw)

    def _preferred_gang_nodes(self, claim) -> list[str] | None:
        """A ComputeDomain channel claim prefers the host window its
        domain's preferred-nodes annotation names."""
        if not self._topology:
            return None
        for cfg in claim.get("spec", {}).get("devices", {}).get(
                "config", []) or []:
            params = (cfg.get("opaque") or {}).get("parameters") or {}
            if params.get("kind") != "ComputeDomainChannelConfig":
                continue
            uid = params.get("domainID")
            if not uid:
                continue
            return self.view.cd_windows().get(uid) or None
        return None

    def _observe_placement(self, alloc_obj, snap: InventorySnapshot,
                           alloc: AllocationState) -> None:
        """Placement quality of a fresh allocation: the compactness of
        the chosen set, and each pool's fragmentation and largest free
        shape after it (coordinated pools only)."""
        if self.metrics is None or not self._topology:
            return
        by_pool: dict[tuple, list[str]] = {}
        for res in alloc_obj.get("devices", {}).get("results", []):
            by_pool.setdefault((res.get("driver", ""), res.get("pool", "")),
                               []).append(res.get("device", ""))
        for (driver, pool), picked in by_pool.items():
            pool_snap = snap.pools.get((driver, pool))
            if pool_snap is None or not pool_snap.candidates:
                continue
            devs = pool_snap.candidates
            grid = self._grid_for(devs)
            cells = {grid.coords[n] for n in picked if n in grid.coords}
            if not cells:
                continue  # an uncoordinated pool: nothing to report
            label = f"{driver}/{pool}"
            hops, _ = set_compactness(grid, cells)
            self.metrics.compactness.labels(label).observe(hops)
            free = {grid.coords[c.name] for c in devs
                    if c.key not in alloc.allocated
                    and c.name in grid.coords}
            _, chips = largest_free_shape(grid, free)
            self.metrics.frag_score.labels(label).set(
                frag_from_largest(chips, len(free)))
            self.metrics.largest_shape.labels(label).set(chips)

    def _fit_on_node(self, claim, node, snap: InventorySnapshot,
                     allocated: set, ledger: CounterLedger, classes,
                     power: dict | None = None):
        """Every request of one claim on one node: [(request, candidate,
        class name)] or None. ``allocated`` is only probed and ``ledger``
        is a copy, so the fit takes no lock; ``try_commit`` judges both
        again. Counters are debited on a private copy as devices are
        picked, and on a power-capped node the picks' draw must fit the
        budget left (``power``: the node's debits).

        ``constraints[].matchAttribute`` (KEP-4381): every device of the
        constraint's requests (all, when it names none) must carry the
        same value of the attribute, and one lacking it never satisfies
        it. Choices interact across requests, so the fit backtracks (a
        bounded depth-first search) instead of picking greedily."""
        spec = claim.get("spec", {}).get("devices", {})
        node_cands = snap.by_node.get(node, ())
        reqs = []
        for req in spec.get("requests", []):
            exactly = req.get("exactly") or req  # v1 nests under exactly
            class_name = exactly.get("deviceClassName", "")
            cls = classes.get(class_name)
            if cls is None:
                return None
            selectors = list(cls.get("spec", {}).get("selectors") or [])
            selectors += list(exactly.get("selectors") or [])
            mode = exactly.get("allocationMode", "ExactCount")
            tolerations = list(exactly.get("tolerations") or [])
            reqs.append({
                "name": req.get("name", "r"),
                "class": class_name,
                "want": (int(exactly.get("count", 1))
                         if mode != "All" else None),
                "cands": [
                    cand for cand in node_cands
                    if cand.key not in allocated
                    and self._device_matches(snap, cand, selectors,
                                             tolerations)
                ],
            })
        if self.defrag is not None or self.migration is not None:
            # The veto: a device a defrag window (carve cell or move
            # target) or a migration's destination reserves goes only to
            # the claim it is reserved for while the move is in flight.
            reserved = {}
            if self.defrag is not None:
                reserved.update(self.defrag.reservations())
            if self.migration is not None:
                reserved.update(self.migration.reservations())
            if reserved:
                uid = _meta(claim).get("uid", "")
                for r in reqs:
                    r["cands"] = [
                        c for c in r["cands"]
                        if c.key not in reserved
                        or (uid and reserved[c.key] == uid)]
        if self._topology:
            for r in reqs:
                r["cands"] = self._topology_order(snap, r["cands"],
                                                 r["want"])
        # Devices short of headroom sort last, stably: the order above
        # holds within each tier, and a degraded device is still picked
        # when nothing else fits.
        for r in reqs:
            if any(c.headroom_penalty for c in r["cands"]):
                r["cands"] = sorted(r["cands"],
                                    key=lambda c: c.headroom_penalty)
        hint = self._defrag_hint(claim)
        if hint is not None and hint[0] == node:
            # The placement hint's devices lead each request's order,
            # after the topology and headroom orders (the hint is the
            # stronger, claim-specific signal) and whatever the topology
            # gate says; the fit still decides.
            hinted = set(hint[1])
            for r in reqs:
                r["cands"] = (
                    [c for c in r["cands"] if c.name in hinted]
                    + [c for c in r["cands"] if c.name not in hinted])
        constraints = []
        for c in spec.get("constraints") or []:
            attr = c.get("matchAttribute")
            if not attr:
                # An unknown constraint type fails closed, as upstream.
                return None
            constraints.append({
                "requests": set(c.get("requests") or []) or None,
                "attr": attr,
            })

        # A private copy: an abandoned search must leave the caller's
        # ledger as it was.
        spent = ledger.copy()
        cvals: list = [None] * len(constraints)
        state = {"steps": 0}
        # The node's power budget left (None = uncapped), a one-cell
        # list the pick and undo closures share.
        power_cap = snap.power_cap_of(node)
        power_left = ([power_cap - (power or {}).get(node, 0)]
                      if power_cap > 0 else None)

        def applies(ci, req_name):
            want = constraints[ci]["requests"]
            return want is None or req_name in want

        def try_pick(req, cand, taken):
            """Constraint, counter and power checks for one candidate;
            an undo closure, or None."""
            consumes = cand.device.get("consumesCounters")
            if not spent.fits(cand.driver, cand.pool, consumes):
                return None
            if power_left is not None and cand.power_watts > 0 and \
                    cand.power_watts > power_left[0]:
                return None
            set_cis = []
            for ci, c in enumerate(constraints):
                if not applies(ci, req["name"]):
                    continue
                val = self._attr_value(cand, c["attr"])
                if val is None:
                    return None
                if cvals[ci] is None:
                    set_cis.append(ci)
                elif cvals[ci] != val:
                    return None
            for ci in set_cis:
                cvals[ci] = self._attr_value(cand, constraints[ci]["attr"])
            spent.debit(cand.driver, cand.pool, consumes)
            if power_left is not None:
                power_left[0] -= cand.power_watts
            taken.add(cand.key)

            def undo():
                taken.discard(cand.key)
                spent.credit(cand.driver, cand.pool, consumes)
                if power_left is not None:
                    power_left[0] += cand.power_watts
                for ci in set_cis:
                    cvals[ci] = None
            return undo

        def fit(ri, slot_start, got, taken):
            state["steps"] += 1
            if state["steps"] > self.MAX_FIT_STEPS:
                raise _FitBudgetExceeded
            if ri == len(reqs):
                return []
            req = reqs[ri]
            if req["want"] is None:
                # All mode: every eligible device, each satisfying the
                # constraints.
                picks, undos = [], []
                for cand in req["cands"]:
                    if cand.key in taken:
                        continue
                    undo = try_pick(req, cand, taken)
                    if undo is None:
                        for u in reversed(undos):
                            u()
                        return None
                    undos.append(undo)
                    picks.append((req["name"], cand, req["class"]))
                if not picks:
                    return None
                rest = fit(ri + 1, 0, 0, taken)
                if rest is None:
                    for u in reversed(undos):
                        u()
                    return None
                return picks + rest
            if got == req["want"]:
                return fit(ri + 1, 0, 0, taken)
            for i in range(slot_start, len(req["cands"])):
                cand = req["cands"][i]
                if cand.key in taken:
                    continue
                undo = try_pick(req, cand, taken)
                if undo is None:
                    continue
                rest = fit(ri, i + 1, got + 1, taken)
                if rest is not None:
                    return [(req["name"], cand, req["class"])] + rest
                undo()
            return None

        try:
            return fit(0, 0, 0, set())
        except _FitBudgetExceeded:
            logger.warning(
                "claim %s/%s: constraint fit exceeded %d states on node "
                "%s; treating as unsatisfiable there",
                _meta(claim).get("namespace", "default"),
                _meta(claim).get("name", "?"), self.MAX_FIT_STEPS, node)
            return None

    # -- domain-exhaustion surfacing (scheduler-per-pool sharding) ------------

    DOMAIN_EXHAUSTED_CONDITION = "DomainExhausted"
    DOMAIN_SPILLED_CONDITION = "DomainSpilled"

    def _flag_domain_exhausted(self, claim) -> None:
        """A claim PINNED into this scheduling domain found no fit in
        the domain's (pool-restricted) inventory. Without this it sits
        silently Pending forever -- the domain annotation stops it from
        spilling to other pools by design. Surface the wedge: a
        ``DomainExhausted`` condition on the claim plus a deduped
        Warning Event, and count it
        (tpu_dra_sched_domain_exhausted_total) so operators can alert
        on a full domain."""
        if self.domain is None or not self.domain.pools:
            return  # unrestricted inventory: not a domain wedge
        ann = (_meta(claim).get("annotations") or {}).get(
            DOMAIN_ANNOTATION, "")
        if not ann:
            return  # default-domain traffic is not pinned
        if self.sched_metrics is not None:
            self.sched_metrics.domain_exhausted.labels(ann).inc()
        ns = _meta(claim).get("namespace", "default")
        name = _meta(claim)["name"]
        message = (
            f"no device fit in scheduling domain {ann!r} (pools "
            f"{sorted(self.domain.pools)}); the claim stays pending "
            "until domain capacity frees or the annotation moves it"
        )
        conditions = claim.get("status", {}).get("conditions") or []
        for c in conditions:
            if c.get("type") == self.DOMAIN_EXHAUSTED_CONDITION and \
                    c.get("status") == "True" and \
                    c.get("message") == message:
                return  # already surfaced: deduped, no churn
        kept = [c for c in conditions
                if c.get("type") != self.DOMAIN_EXHAUSTED_CONDITION]
        kept.append({
            "type": self.DOMAIN_EXHAUSTED_CONDITION,
            "status": "True",
            "reason": "DomainExhausted",
            "message": message,
        })
        try:
            self.kube.patch(*RESOURCE, "resourceclaims", name,
                            {"status": {"conditions": kept}},
                            namespace=ns)
        except KubeError:
            # Cosmetic surfacing write: a flaky apiserver here must
            # never abort the sync pass that real allocations ride on.
            return
        # Deterministic name = create-once dedupe: repeat passes hit
        # ConflictError instead of spamming.
        emit_warning_event(
            self.kube, event_name=f"{name}.domain-exhausted",
            namespace=ns, reason="DomainExhausted", message=message,
            involved_kind="ResourceClaim", involved_name=name,
            involved_uid=_meta(claim).get("uid", ""),
            component="tpu-dra-scheduler")

    def _clear_domain_exhausted(self, claim) -> None:
        """An allocation landed for a claim that carried the
        exhaustion (or in-flight spill) condition: retire it (status
        False) so observers see the recovery."""
        conditions = claim.get("status", {}).get("conditions") or []
        retire = {self.DOMAIN_EXHAUSTED_CONDITION:
                  "domain capacity freed; claim allocated",
                  self.DOMAIN_SPILLED_CONDITION:
                  "claim allocated in the spill target domain"}
        live = {c.get("type") for c in conditions
                if c.get("type") in retire and c.get("status") == "True"}
        if not live:
            return
        kept = [c for c in conditions if c.get("type") not in live]
        for cond_type in sorted(live):
            kept.append({
                "type": cond_type,
                "status": "False",
                "reason": "Allocated",
                "message": retire[cond_type],
            })
        try:
            self.kube.patch(
                *RESOURCE, "resourceclaims", _meta(claim)["name"],
                {"status": {"conditions": kept}},
                namespace=_meta(claim).get("namespace", "default"))
        except (NotFoundError, ConflictError, KubeError):
            pass  # cosmetic: the allocation itself already landed

    # -- cross-domain claim spillover -----------------------------------------

    # Sibling-capacity memo TTL: bounds the claims+slices scan rate
    # under an exhausted-domain claim flood.
    SPILL_MEMO_TTL_S = 2.0

    @staticmethod
    def _claim_device_demand(claim) -> int:
        """Rough device count one claim needs (All-mode counts 1):
        a sibling with less free capacity than this can be skipped
        without a fit. ONE rule, shared with the defrag demand
        signal (pkg/defrag.claim_device_demand) so the two readers
        of 'how many chips does this claim want' can never drift."""
        return _defrag_claim_demand(claim)

    def _sibling_capacity(self) -> dict[str, tuple[int, int]]:
        """sibling name -> (free devices, total devices) across the
        sibling's pools, computed from the UNfiltered informer caches
        (this domain's snapshot is pool-restricted by design, so the
        spill decision is the one read that must see past the fence).
        Memoized briefly: spills are rare but arrive in floods when a
        domain fills."""
        memo = self._spill_capacity_memo
        now = time.monotonic()
        if memo is not None and memo[0] > now:
            return memo[1]
        try:
            slices = self.view.slices()
            claims = self.view.claims()
        except KubeError:
            return {}
        siblings = self.domain.siblings if self.domain else []
        # Newest-generation device keys per sibling.
        newest: dict[tuple, int] = {}
        for s in slices:
            pk = pool_key_of(s)
            gen = s.get("spec", {}).get("pool", {}).get("generation", 0)
            newest[pk] = max(newest.get(pk, 0), gen)
        totals: dict[str, set] = {sib.name: set() for sib in siblings}
        for s in slices:
            spec = s.get("spec", {})
            pk = pool_key_of(s)
            if spec.get("pool", {}).get("generation", 0) != newest[pk]:
                continue
            node = spec.get("nodeName", "")
            for sib in siblings:
                if sib.owns_pool(pk[1], node):
                    for dev in spec.get("devices", []):
                        totals[sib.name].add(
                            (pk[0], pk[1], dev.get("name", "")))
        allocated: set = set()
        for claim in claims:
            alloc = claim.get("status", {}).get("allocation") or {}
            for r in alloc.get("devices", {}).get("results", []):
                allocated.add((r.get("driver", ""), r.get("pool", ""),
                               r.get("device", "")))
        out = {
            name: (len(keys - allocated), len(keys))
            for name, keys in totals.items()
        }
        self._spill_capacity_memo = (now + self.SPILL_MEMO_TTL_S, out)
        return out

    def _rank_spill_target(self, claim) -> "SchedulingDomain | None":
        """Cheapest sibling by migration-cost score: configured order
        (weighted) + current utilization (weighted), siblings without
        enough free devices for the claim's rough demand skipped."""
        demand = self._claim_device_demand(claim)
        capacity = self._sibling_capacity()
        best, best_cost = None, None
        for idx, sib in enumerate(self.domain.siblings):
            free, total = capacity.get(sib.name, (0, 0))
            if total <= 0 or free < demand:
                continue
            util = 1.0 - free / total
            cost = (self._spill_order_weight * idx
                    + self._spill_util_weight * util)
            if best_cost is None or cost < best_cost:
                best, best_cost = sib, cost
        return best

    def _maybe_spill(self, claim) -> bool:
        """Re-home a domain-pinned, domain-exhausted claim to the
        cheapest sibling domain: ONE annotation patch moves the
        domain pin, records the original domain
        (``spilled-from``) and the hop count, and the sibling's
        scheduler picks the claim up off the resulting watch event.
        Deduped ``DomainSpilled`` Warning Event; claims annotated
        ``resource.tpu.dra/spillover: "false"`` never move. Returns
        True when the claim was spilled."""
        domain = self.domain
        if (not self._spillover_enabled or domain is None
                or not domain.pools or not domain.siblings):
            return False
        ann = _meta(claim).get("annotations") or {}
        if ann.get(DOMAIN_ANNOTATION, "") != domain.name:
            return False  # not pinned here: not ours to move
        if ann.get(SPILLOVER_ANNOTATION, "").lower() in (
                "false", "0", "off", "disabled"):
            return False  # operator opt-out
        try:
            hops = int(ann.get(SPILLOVER_HOPS_ANNOTATION, "0") or 0)
        except ValueError:
            hops = self._spillover_max_hops  # malformed: stop moving
        if hops >= self._spillover_max_hops:
            return False
        with self._spill_lock:
            # Rank + capacity debit are ATOMIC: concurrent workers
            # spilling a flood each consume their demand from the
            # memoized free count before the next one judges it. The
            # debit is conservative (a failed patch below leaves it
            # spent until the memo's 2s TTL) -- under-spilling briefly
            # beats overshooting the sibling.
            target = self._rank_spill_target(claim)
            if target is None:
                return False  # every sibling full too: stay + surface
            memo = self._spill_capacity_memo
            if memo is not None and target.name in memo[1]:
                free, total = memo[1][target.name]
                memo[1][target.name] = (
                    free - self._claim_device_demand(claim), total)
        ns = _meta(claim).get("namespace", "default")
        name = _meta(claim)["name"]
        origin = ann.get(SPILLED_FROM_ANNOTATION) or domain.name
        # The condition rides the SAME patch as the re-home: if the
        # target domain name is misconfigured (no scheduler owns it),
        # the claim still SHOWS what happened to it -- pre-spillover
        # it at least pended with a visible DomainExhausted.
        conditions = [c for c in claim.get("status", {}).get(
            "conditions") or []
            if c.get("type") != self.DOMAIN_SPILLED_CONDITION]
        conditions.append({
            "type": self.DOMAIN_SPILLED_CONDITION,
            "status": "True",
            "reason": "DomainSpilled",
            "message": (f"spilled from domain {origin!r} to sibling "
                        f"{target.name!r} (hop {hops + 1}); pending "
                        "here means no scheduler owns that domain"),
        })
        patch = {
            "metadata": {"annotations": {
                DOMAIN_ANNOTATION: target.name,
                SPILLED_FROM_ANNOTATION: origin,
                SPILLOVER_HOPS_ANNOTATION: str(hops + 1),
            }},
            "status": {"conditions": conditions},
        }
        try:
            self.kube.patch(*RESOURCE, "resourceclaims", name, patch,
                            namespace=ns)
        except KubeError:
            return False  # claim gone / conflicted: retry next pass
        if self.sched_metrics is not None:
            self.sched_metrics.domain_spilled.labels(
                domain.name, target.name).inc()
        self.flight.record(
            _meta(claim).get("uid", "") or f"{ns}/{name}", "spilled",
            alias=f"{ns}/{name}", src=domain.name, dst=target.name)
        message = (
            f"domain {domain.name!r} exhausted; claim spilled to "
            f"sibling domain {target.name!r} (hop {hops + 1}, origin "
            f"{origin!r}); annotate "
            f"{SPILLOVER_ANNOTATION}=false to opt out")
        # Deterministic name = create-once dedupe, like DomainExhausted.
        emit_warning_event(
            self.kube, event_name=f"{name}.domain-spilled",
            namespace=ns, reason="DomainSpilled", message=message,
            involved_kind="ResourceClaim", involved_name=name,
            involved_uid=_meta(claim).get("uid", ""),
            component="tpu-dra-scheduler")
        logger.info("claim %s/%s spilled: domain %s -> %s", ns, name,
                    domain.name, target.name)
        return True

    def _claim_pins(self) -> dict[tuple[str, str], str]:
        """(namespace, claim name) -> node, for claims whose consumer pod
        is bound (a DaemonSet's pods are born bound)."""
        pins: dict[tuple[str, str], str] = {}
        for pod in self._pods():
            node = pod.get("spec", {}).get("nodeName")
            if not node:
                continue
            ns = _meta(pod).get("namespace", "default")
            for claim_name in self._claim_names(pod):
                if claim_name:
                    pins[(ns, claim_name)] = node
        return pins

    @staticmethod
    def _claim_names(pod) -> list[str | None]:
        """The claim names a pod's entries resolve to (None for a
        template entry not generated yet), then its extended-resource
        claim."""
        statuses = {
            s["name"]: s.get("resourceClaimName")
            for s in pod.get("status", {}).get(
                "resourceClaimStatuses") or []
        }
        names = [ref.get("resourceClaimName") or statuses.get(ref["name"])
                 for ref in pod.get("spec", {}).get("resourceClaims") or []]
        ext = pod.get("status", {}).get(
            "extendedResourceClaimStatus") or {}
        if ext.get("resourceClaimName"):
            names.append(ext["resourceClaimName"])
        return names

    def _commit_allocation(self, claim, alloc_obj,
                           snap: InventorySnapshot,
                           alloc: AllocationState) -> str:
        """Reserve atomically, then patch. The reservation makes the
        devices visible to every other worker BEFORE the kube write, so
        nobody can plan against them in the patch window; a failed
        patch releases it (commit-then-observe: the incremental state
        only ever keeps allocations that landed). Returns
        "committed" | "conflict" | "failed"."""
        ns = _meta(claim).get("namespace", "default")
        claim_like = {
            "metadata": _meta(claim),
            "status": {"allocation": alloc_obj},
        }
        # Reserve against the LIVE state, atomically with the
        # commit-log insert, under _state_lock: state installs
        # (_ensure/_rebuild) take the same lock, so a rebuild that ran
        # after the caller captured ``alloc`` is the state we reserve
        # on, and any LATER rebuild replays the log entry -- either
        # way the reservation is visible before the patch is in
        # flight, so no worker can fit against a state that never saw
        # it (the double-allocation window). The fit itself stays
        # optimistic (it may have read a superseded state); try_commit
        # re-judges everything here.
        log_key = (ns, _meta(claim)["name"])
        uid = _meta(claim).get("uid", "")
        fit_t0 = getattr(self._fit_tls, "t0", None)
        t_commit0 = time.monotonic()
        with tracing.span("sched.commit", attrs={
                "claim_uid": uid}) as commit_sp:
            with self._state_lock:
                live = self._alloc if self._alloc is not None else alloc
                if not live.try_commit(claim_like):
                    commit_sp.set_attr("conflict", True)
                    self.flight.record(
                        uid or log_key[1], "commit_conflict",
                        alias=f"{ns}/{log_key[1]}",
                        trace_id=(commit_sp.context.trace_id
                                  if commit_sp.recording else ""))
                    return "conflict"
                self._commit_log[log_key] = (time.monotonic(), claim_like)
            trace_id = (commit_sp.context.trace_id
                        if commit_sp.recording else "")
            self._fit_tls.trace_id = trace_id
            # Cross-binary propagation: the traceparent annotation
            # rides the SAME patch as the allocation, so the kubelet
            # plugins' prepare spans become children of THIS commit
            # span -- one trace id, pod admission to carve-out.
            patch = {"status": {"allocation": alloc_obj}}
            # The patch rides the resourceVersion the fit READ: the
            # apiserver 409s if anything touched the claim since, which
            # is the only arbiter that stops a second active-active
            # scheduler (own informer, own ledger) from stamping a
            # conflicting allocation over this one. The ConflictError
            # path below releases the reservation and the claim comes
            # back through resync against the post-write state.
            rv = _meta(claim).get("resourceVersion")
            if rv is not None:
                patch["metadata"] = {"resourceVersion": rv}
            if commit_sp.recording:
                patch.setdefault("metadata", {})["annotations"] = (
                    tracing.inject(commit_sp, {}))
            elif tracing.TRACEPARENT_ANNOTATION in (
                    _meta(claim).get("annotations") or {}):
                # Unsampled re-allocation of a claim that still carries
                # a PREVIOUS allocation's traceparent (eviction ->
                # migration): clear it (merge-patch null), or the node
                # plugin would parent this prepare under the dead
                # first trace.
                patch.setdefault("metadata", {})["annotations"] = {
                    tracing.TRACEPARENT_ANNOTATION: None}
            t_patch0 = time.monotonic()
            try:
                # No dedicated patch span: the commit span carries
                # patch_ms instead (one fewer span on the hot path;
                # the SLO histogram still splits the phases).
                self.kube.patch(
                    *RESOURCE, "resourceclaims",
                    _meta(claim)["name"], patch, namespace=ns)
            except (NotFoundError, ConflictError):
                with self._state_lock:
                    self._commit_log.pop(log_key, None)
                    current = self._alloc
                live.forget(claim_like)
                if current is not None and current is not live:
                    # A rebuild swapped states mid-patch and replayed
                    # the now-dead reservation; release it there too.
                    current.forget(claim_like)
                return "failed"
            t_end = time.monotonic()
            if commit_sp.recording:
                # Set while the span is still open so the JSONL sink
                # (which dict-ifies at export) sees it too, not just
                # the read-time /debug/traces ring.
                commit_sp.set_attr("patch_ms",
                                   round((t_end - t_patch0) * 1e3, 3))
        if self._slo is not None:
            if fit_t0 is not None:
                self._slo.observe("fit", t_commit0 - fit_t0, trace_id)
            self._slo.observe("commit", t_patch0 - t_commit0, trace_id)
            self._slo.observe("patch", t_end - t_patch0, trace_id)
        self.flight.record(
            uid or log_key[1], "alloc_patched",
            alias=f"{ns}/{log_key[1]}", trace_id=trace_id,
            devices=[r["device"]
                     for r in alloc_obj["devices"]["results"]])
        self._observe_placement(alloc_obj, snap, alloc)
        logger.info(
            "allocated claim %s/%s -> %s", ns, _meta(claim)["name"],
            [r["device"] for r in alloc_obj["devices"]["results"]])
        return "committed"

    def _allocate_claims(self):
        snap, alloc = self._rebuild_alloc_state()
        if self._sharded:
            # Claim work belongs to its shard: fan the pending claims
            # out as dirty keys so allocation for one claim always runs
            # serialized on one worker (the full pass stays O(pending)).
            for claim in self.view.claims():
                if claim.get("status", {}).get("allocation"):
                    continue
                if _meta(claim).get("deletionTimestamp"):
                    continue
                if not self._owns(claim):
                    continue
                self._enqueue(("claim",
                               _meta(claim).get("namespace", "default"),
                               _meta(claim)["name"]))
            return
        classes = self._device_classes()
        pins = self._claim_pins()
        for claim in self.view.claims():
            if claim.get("status", {}).get("allocation"):
                continue
            if _meta(claim).get("deletionTimestamp"):
                continue
            if not self._owns(claim):
                continue
            pin = pins.get((_meta(claim).get("namespace", "default"),
                            _meta(claim)["name"]))
            self._allocate_one(claim, snap, alloc, classes,
                               pinned_node=pin)

    # -- binding --------------------------------------------------------------

    def _claims_for_pod(self, pod) -> list[tuple[str, dict | None]]:
        ns = _meta(pod).get("namespace", "default")
        refs = pod.get("spec", {}).get("resourceClaims") or []
        out = []
        for i, claim_name in enumerate(self._claim_names(pod)):
            if not claim_name:
                out.append((refs[i]["name"], None))
                continue
            try:
                out.append((claim_name, self.view.get_claim(
                    claim_name, namespace=ns)))
            except NotFoundError:
                out.append((claim_name, None))
        return out

    def _reserve(self, claim, pod):
        reserved = claim.get("status", {}).get("reservedFor") or []
        entry = {
            "resource": "pods",
            "name": _meta(pod)["name"],
            "uid": _meta(pod).get("uid", ""),
        }
        if entry not in reserved:
            self.kube.patch(
                *RESOURCE, "resourceclaims", _meta(claim)["name"],
                {"status": {"reservedFor": reserved + [entry]}},
                namespace=_meta(claim).get("namespace", "default"))

    def _extended_resource_classes(self) -> dict[str, str]:
        """Extended resource name -> DeviceClass name (KEP-5004)."""
        return {
            cls["spec"]["extendedResourceName"]: name
            for name, cls in self._device_classes().items()
            if cls.get("spec", {}).get("extendedResourceName")
        }

    @staticmethod
    def _pending_extended_resource(pod, names: set[str] | None) -> bool:
        """True while a pod asks for a DRA-served extended resource and
        its claim is not recorded yet (binding would run it deviceless).
        ``names`` None (the lookup failed): closed for every
        domain-prefixed limit."""
        if pod.get("status", {}).get("extendedResourceClaimStatus"):
            return False
        limits = [
            rname
            for c in pod.get("spec", {}).get("containers", [])
            for rname in ((c.get("resources") or {}).get("limits") or {})
        ]
        if names is None:
            return any("/" in rname for rname in limits)
        return any(rname in names for rname in limits)

    def _bind_pods(self):
        try:
            ext_names: set[str] | None = set(
                self._extended_resource_classes())
        except KubeError:
            ext_names = None  # fail closed per-pod, retry next pass
        for pod in self._pods():
            if not self._owns(pod):
                continue
            if self._sharded:
                # Reservation + bind for one pod must run serialized on
                # the pod's shard (a racing duplicate would double-add
                # reservedFor entries).
                if not pod.get("spec", {}).get("nodeName") and \
                        pod.get("status", {}).get("phase") in (
                            None, "", "Pending"):
                    self._enqueue(("pod",
                                   _meta(pod).get("namespace", "default"),
                                   _meta(pod)["name"]))
                continue
            self._bind_pod(pod, ext_names)

    def _bind_pod(self, pod, ext_names: set[str] | None) -> bool:
        if pod.get("spec", {}).get("nodeName"):
            return False
        if pod.get("status", {}).get("phase") not in (None, "", "Pending"):
            return False
        if self._pending_extended_resource(pod, ext_names):
            return False
        nodes = set()
        claim_objs = []
        for _, claim in self._claims_for_pod(pod):
            alloc = (claim or {}).get("status", {}).get("allocation")
            if not alloc:
                return False
            claim_objs.append(claim)
            for term in alloc.get("nodeSelector", {}).get(
                    "nodeSelectorTerms", []):
                for mf in term.get("matchFields", []):
                    if mf.get("key") == "metadata.name":
                        nodes.add(mf["values"][0])
        ns = _meta(pod).get("namespace", "default")
        if len(nodes) > 1:
            # Claims allocated apart landed on different nodes: binding
            # anywhere would strand a device.
            logger.warning("pod %s/%s claims span nodes %s; not binding",
                           ns, _meta(pod)["name"], sorted(nodes))
            return False
        node = next(iter(nodes)) if nodes else self.default_node
        if node is None:
            return False
        for claim in claim_objs:
            self._reserve(claim, pod)
        self.kube.patch("", "v1", "pods", _meta(pod)["name"],
                        {"spec": {"nodeName": node}}, namespace=ns)
        logger.info("bound pod %s/%s -> %s", ns, _meta(pod)["name"], node)
        return True

    # -- DaemonSet controller (kcm daemonset controller) ----------------------

    def _sync_daemonsets(self):
        """One pod per matching node per DaemonSet, named from (ds, node)
        so a pass is idempotent; pods on nodes that no longer match, and
        pods whose DaemonSet is gone, are deleted."""
        try:
            daemonsets = self.view.daemonsets()
        except KubeError:
            return
        try:
            nodes = self.view.nodes()
        except KubeError:
            nodes = []
        pods = self._pods()
        live = {(_meta(d).get("namespace", "default"), _meta(d)["name"])
                for d in daemonsets}
        for pod in pods:
            ns = _meta(pod).get("namespace", "default")
            for o in _meta(pod).get("ownerReferences") or []:
                if o.get("kind") == "DaemonSet" and \
                        (ns, o.get("name")) not in live:
                    try:
                        self.kube.delete("", "v1", "pods",
                                         _meta(pod)["name"], namespace=ns)
                    except NotFoundError:
                        pass
        for ds in daemonsets:
            ns = _meta(ds).get("namespace", "default")
            ds_name = _meta(ds)["name"]
            tmpl = ds.get("spec", {}).get("template", {})
            selector = tmpl.get("spec", {}).get("nodeSelector") or {}
            want = {
                _meta(n)["name"] for n in nodes
                if all((_meta(n).get("labels") or {}).get(k) == v
                       for k, v in selector.items())
            }
            existing: dict[str, dict] = {}
            for pod in pods:
                if _meta(pod).get("namespace", "default") != ns:
                    continue
                if any(o.get("kind") == "DaemonSet"
                       and o.get("name") == ds_name
                       for o in _meta(pod).get("ownerReferences") or []):
                    existing[pod.get("spec", {}).get("nodeName", "")] = pod
            for node in sorted(want - set(existing)):
                pod = {
                    "apiVersion": "v1", "kind": "Pod",
                    "metadata": {
                        "name": f"{ds_name}-{node}",
                        "namespace": ns,
                        "labels": dict(tmpl.get("metadata", {}).get(
                            "labels") or {}),
                        "ownerReferences": [{
                            "apiVersion": "apps/v1", "kind": "DaemonSet",
                            "name": ds_name,
                            "uid": _meta(ds).get("uid", ""),
                            "controller": True,
                        }],
                    },
                    "spec": {**_json_copy(tmpl.get("spec", {})),
                             "nodeName": node},
                }
                try:
                    self.kube.create("", "v1", "pods", pod, namespace=ns)
                    logger.info("daemonset %s/%s -> pod on %s", ns,
                                ds_name, node)
                except ConflictError:
                    pass
            for node in sorted(set(existing) - want):
                try:
                    self.kube.delete("", "v1", "pods",
                                     _meta(existing[node])["name"],
                                     namespace=ns)
                except NotFoundError:
                    pass

    # -- Job controller (kcm job controller, completions=1 subset) ------------

    def _sync_jobs(self):
        """One pod per Job; the pod's phase feeds the Job's status."""
        try:
            jobs = self.view.jobs()
        except KubeError:
            return
        for job in jobs:
            ns = _meta(job).get("namespace", "default")
            name = _meta(job)["name"]
            pod_name = f"{name}-0"
            try:
                pod = self.kube.get("", "v1", "pods", pod_name,
                                    namespace=ns)
            except NotFoundError:
                status = job.get("status", {})
                if status.get("succeeded") or status.get("failed"):
                    continue  # a finished Job never runs its pod again
                tmpl = job.get("spec", {}).get("template", {})
                try:
                    self.kube.create("", "v1", "pods", {
                        "apiVersion": "v1", "kind": "Pod",
                        "metadata": {
                            "name": pod_name, "namespace": ns,
                            "labels": dict(tmpl.get("metadata", {}).get(
                                "labels") or {}),
                            "ownerReferences": [{
                                "apiVersion": "batch/v1", "kind": "Job",
                                "name": name,
                                "uid": _meta(job).get("uid", ""),
                                "controller": True,
                            }],
                        },
                        "spec": _json_copy(tmpl.get("spec", {})),
                    }, namespace=ns)
                except ConflictError:
                    pass
                continue
            phase = pod.get("status", {}).get("phase", "")
            if phase == "Succeeded" and not job.get("status", {}).get(
                    "succeeded"):
                self.kube.patch("batch", "v1", "jobs", name, {
                    "status": {"succeeded": 1, "conditions": [
                        {"type": "Complete", "status": "True"}]},
                }, namespace=ns)
            elif phase == "Failed" and not job.get("status", {}).get(
                    "failed"):
                self.kube.patch("batch", "v1", "jobs", name, {
                    "status": {"failed": 1, "conditions": [
                        {"type": "Failed", "status": "True"}]},
                }, namespace=ns)

    # -- full pass ------------------------------------------------------------

    def sync_once(self):
        t0 = time.monotonic()
        self.view.begin_pass()
        if self._cluster_controllers:
            # Non-default domain instances only allocate/bind their
            # own objects; exactly one instance runs the cluster-wide
            # controllers.
            self._sync_recovery()
            # After recovery, before allocation: a claim the migration
            # controller switches this pass re-places (onto its
            # reserved window) in the SAME pass.
            self._sync_migration()
            self._sync_daemonsets()
            self._sync_jobs()
        self._generate_claims()
        self._generate_extended_resource_claims()
        self._allocate_claims()
        self._bind_pods()
        self._observe_fleet()
        if self._cluster_controllers:
            # After the fleet fold: the defrag trigger reads the frag
            # rings THIS pass just refreshed, and the autoscaler the
            # pending-demand ring.
            self._sync_defrag()
            self._sync_autoscale()
        if self.sched_metrics is not None:
            self.sched_metrics.sync_seconds.labels("full").observe(
                time.monotonic() - t0)

    def _observe_fleet(self) -> None:
        """Fold one pass's inventory + allocation state + pending
        demand into the fleet aggregator (pkg/fleetstate). Full-pass
        cadence only (the safety resync in event mode): fleet
        time-series want seconds-to-minutes resolution, not per-claim.
        Never lets a telemetry failure fail a sync."""
        if self.fleet is None:
            return
        try:
            if not self._fleet_installed:
                fleetstate.set_default_fleet(self.fleet)
                self._fleet_installed = True
            snap, alloc = self._ensure_alloc_state()
            pending = sum(
                1 for c in self.view.claims()
                if self._owns(c)
                and not c.get("status", {}).get("allocation")
                and not _meta(c).get("deletionTimestamp"))
            self.fleet.observe_pass(snap, alloc, pending,
                                    grid_fn=self._grid_for)
        except Exception:  # noqa: BLE001 - observability must not
            logger.exception("fleet telemetry fold failed")  # fail sync

    def _sync_recovery(self) -> None:
        """One recovery pass, ahead of allocation, so the failed-node
        exclusion and the claims it deallocated are seen by the same
        pass. An ``InjectedCrash`` (a BaseException) goes through, as a
        process death would."""
        if self.recovery is None:
            return
        try:
            self.recovery.sync_once()
        except Exception:  # noqa: BLE001 - control loop
            logger.exception("recovery sync failed")

    def _sync_defrag(self) -> None:
        """One defrag pass; an ``InjectedCrash`` goes through, as a
        process death would."""
        if self.defrag is None:
            return
        try:
            self.defrag.sync_once()
        except Exception:  # noqa: BLE001 - control loop
            logger.exception("defrag sync failed")

    def _sync_autoscale(self) -> None:
        """One autoscale pass; an ``InjectedCrash`` goes through, as a
        process death would."""
        if self.autoscaler is None:
            return
        try:
            self.autoscaler.sync_once()
        except Exception:  # noqa: BLE001 - control loop
            logger.exception("autoscale sync failed")

    def _sync_migration(self) -> None:
        """One migration pass; an ``InjectedCrash`` goes through, as a
        process death would."""
        if self.migration is None:
            return
        try:
            self.migration.sync_once()
        except Exception:  # noqa: BLE001 - control loop
            logger.exception("migration sync failed")

    # -- event-driven incremental sync ----------------------------------------

    def start_event_driven(self) -> "DraScheduler":
        """Informer-fed dirty-set mode: per-object events enqueue keyed
        work; the periodic FULL resync survives only as the safety net
        (``resync_period``, default 30s / TPU_DRA_SCHED_RESYNC).
        ``sched_workers`` > 1 shards claim/pod keys over N-1 data
        workers (disjoint-node allocations commit in parallel) with
        control keys pinned to a dedicated worker."""
        from .workqueue import RateLimiter, WorkQueue  # noqa: PLC0415

        if self._queue is not None:
            return self
        self._queue = WorkQueue(
            limiter=RateLimiter(base_delay=0.05, max_delay=2.0),
            workers=self.sched_workers, name="sched-sync",
            shard_of=self._shard_of,
            metrics=(self.sched_metrics.workqueue
                     if self.sched_metrics is not None else None),
            # Work stealing between idle data workers: a pathological
            # single-namespace claim flood (every key hashing to one
            # shard) drains across the pool. Control keys stay pinned
            # to worker 0 -- the recovery/resync lane must never
            # migrate behind a claim flood.
            steal=(self._stealable if self.sched_workers > 1 else None),
            may_steal=lambda idx: idx != 0,
        )
        self.view.start()
        self._enqueue(("full",))
        self._resync_thread = threading.Thread(
            target=self._resync_loop, name="sched-resync", daemon=True)
        self._resync_thread.start()
        return self

    def _resync_loop(self) -> None:
        while not self._stop.wait(self.resync_period):
            self._enqueue(("full",))

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until the dirty set is fully processed (at most
        ``timeout`` seconds); whether it was."""
        if self._queue is None:
            return True
        return self._queue.wait_idle(timeout)

    def _enqueue(self, key: tuple) -> None:
        if self._queue is None or self._stop.is_set():
            return
        self._queue.enqueue(key, self._sync_key)
        if len(key) >= 3 and key[0] == "claim":
            # Flight-record the dirty-key enqueue under ns/name (the
            # UID is not known here; later events alias the two).
            self.flight.record(f"{key[1]}/{key[2]}", "enqueue")
        if self.sched_metrics is not None:
            self.sched_metrics.dirty_depth.set(self._queue.len())

    def _on_informer_relist(self, resource: str) -> None:
        if self.sched_metrics is not None:
            self.sched_metrics.informer_relists.labels(resource).inc()

    def _on_informer_event(self, resource: str, ev_type: str,
                           obj: dict) -> None:
        """Informer event -> dirty keys. Runs on watch/notify threads;
        does index + allocation-state bookkeeping inline (cheap, lock
        guarded) and defers all kube I/O to the queue worker."""
        md = _meta(obj)
        ns = md.get("namespace", "default")
        name = md.get("name", "")
        if resource == "pods":
            self._index_pod(ev_type, ns, name, obj)
            if self._owns(obj):
                self._enqueue(("pod", ns, name))
            owners = md.get("ownerReferences") or []
            if self._cluster_controllers:
                if any(o.get("kind") == "Job" for o in owners):
                    self._enqueue(("jobs",))
                if ev_type == "DELETED" and any(
                        o.get("kind") == "DaemonSet" for o in owners):
                    self._enqueue(("daemonsets",))
        elif resource == "resourceclaims":
            with self._state_lock:
                if self._alloc is not None:
                    if ev_type == "DELETED":
                        self._alloc.forget(obj)
                    else:
                        self._alloc.observe(obj)
                if ev_type == "DELETED" or obj.get("status", {}).get(
                        "allocation"):
                    # The cache caught up with (or outlived) our own
                    # committed allocation: the replay record retires.
                    self._commit_log.pop((ns, name), None)
            if ev_type == "DELETED":
                # Freed devices may unblock any pending claim.
                self._pods_of_claim.pop((ns, name), None)
                self._enqueue(("pending",))
            elif self._owns(obj):
                self._enqueue(("claim", ns, name))
            if self.recovery is not None and self.recovery.busy():
                # Allocation changes advance IN-FLIGHT evictions
                # (replaced claims retire; deleted claims cancel);
                # ordinary claim churn with nothing in flight never
                # pays a recovery pass. New victims only appear via
                # node/slice failures, which enqueue unconditionally.
                self._enqueue(("recovery",))
            if self.defrag is not None and self.defrag.busy():
                # Same gating for in-flight defrag moves: a moving
                # claim's re-allocation (or deletion) advances its
                # record without waiting for the safety resync; quiet
                # fleets never pay a defrag pass per claim event.
                self._enqueue(("defrag",))
            if self.migration is not None and self.migration.busy():
                # And for in-flight cooperative handshakes: the
                # workload's ack lands as a claim annotation patch, so
                # the claim event IS the handshake's forward edge.
                self._enqueue(("migration",))
            for pod_name in self._dependent_pods(ns, name, obj):
                self._enqueue(("pod", ns, pod_name))
        elif resource == "resourceslices":
            self._enqueue(("inventory",))
            if self.recovery is not None:
                # Fatal device taints arrive as slice writes.
                self._enqueue(("recovery",))
            if self.migration is not None and self.migration.busy():
                # A retired slice may take an in-flight handshake's
                # reserved destination with it (destination lost).
                self._enqueue(("migration",))
        elif resource == "deviceclasses":
            self._enqueue(("pending",))
        elif resource == "computedomains":
            self._enqueue(("pending",))
        elif resource == "partitionsets":
            # A layout CRD moved: the autoscaler may have a rollout to
            # confirm (or an operator edit to defer to), and pending
            # tenants get their retry once the nodes republish.
            if self.autoscaler is not None:
                self._enqueue(("autoscale",))
            self._enqueue(("pending",))
        elif resource in ("daemonsets", "nodes"):
            self._enqueue(("daemonsets",))
            if resource == "nodes" and self.recovery is not None:
                # NotReady transitions / node deletion feed escalation.
                self._enqueue(("recovery",))
            if resource == "nodes" and self.migration is not None:
                # The cooperative-evacuation annotation arrives as a
                # node write.
                self._enqueue(("migration",))
        elif resource == "jobs":
            self._enqueue(("jobs",))
        elif resource == "resourceclaimtemplates":
            self._enqueue(("pods-rescan",))

    def _index_pod(self, ev_type: str, ns: str, name: str,
                   pod: dict) -> None:
        pod_key = (ns, name)
        with self._state_lock:
            for claim_name in self._claims_of_pod.pop(pod_key, ()):
                peers = self._pods_of_claim.get((ns, claim_name))
                if peers is not None:
                    peers.discard(name)
            if ev_type == "DELETED":
                return
            claims = {n for n in self._claim_names(pod) if n}
            if claims:
                self._claims_of_pod[pod_key] = claims
                for claim_name in claims:
                    self._pods_of_claim.setdefault(
                        (ns, claim_name), set()).add(name)

    def _dependent_pods(self, ns: str, claim_name: str,
                        claim: dict) -> set[str]:
        with self._state_lock:
            pods = set(self._pods_of_claim.get((ns, claim_name), ()))
        for o in _meta(claim).get("ownerReferences") or []:
            if o.get("kind") == "Pod" and o.get("name"):
                pods.add(o["name"])
        return pods

    def _sync_key(self, key: tuple) -> None:
        t0 = time.monotonic()
        kind = key[0]
        try:
            if kind in ("daemonsets", "jobs", "recovery", "defrag",
                        "autoscale", "migration") and \
                    not self._cluster_controllers:
                return  # another domain owns the cluster controllers
            if kind == "full":
                self.sync_once()
                return  # sync_once observed itself as a full pass
            if kind == "pod":
                self._sync_pod_key(key[1], key[2])
            elif kind == "claim":
                self._sync_claim_keys_batched(key)
            elif kind == "pending":
                self._retry_pending_claims()
            elif kind == "inventory":
                # Slice events already marked their pools dirty in the
                # view (per-pool delta tracking): the next snapshot()
                # read rebuilds exactly those pools and the allocation
                # state retargets in O(changed pools). The old global
                # invalidate here forced an O(slices) full rebuild +
                # O(claims) state rebuild per slice event -- the
                # 10k-node hotspot this PR removes.
                self._retry_pending_claims()
            elif kind == "daemonsets":
                self._sync_daemonsets()
            elif kind == "jobs":
                self._sync_jobs()
            elif kind == "recovery":
                self._sync_recovery()
                # A recovery pass may have deallocated claims; give
                # them their re-placement attempt without waiting for
                # the safety resync.
                self._retry_pending_claims()
            elif kind == "defrag":
                self._sync_defrag()
                # A defrag pass deallocates moving claims; re-place
                # them (onto their hinted targets) immediately.
                self._retry_pending_claims()
            elif kind == "migration":
                self._sync_migration()
                # A switch deallocates the moving claim; re-place it
                # (onto its reserved window) immediately.
                self._retry_pending_claims()
            elif kind == "autoscale":
                self._sync_autoscale()
            elif kind == "pods-rescan":
                for pod in self._pods():
                    refs = pod.get("spec", {}).get("resourceClaims") or []
                    have = {s["name"] for s in pod.get("status", {}).get(
                        "resourceClaimStatuses") or []}
                    if any(r.get("resourceClaimTemplateName")
                           and r["name"] not in have for r in refs):
                        self._enqueue(("pod",
                                       _meta(pod).get("namespace",
                                                      "default"),
                                       _meta(pod)["name"]))
        finally:
            if self.sched_metrics is not None:
                if kind != "full":
                    self.sched_metrics.sync_seconds.labels(
                        "incremental").observe(time.monotonic() - t0)
                if self._queue is not None:
                    self.sched_metrics.dirty_depth.set(self._queue.len())

    def _sync_pod_key(self, ns: str, name: str) -> None:
        """Claim generation + binding for ONE pod. The pod is re-read
        from the apiserver (a GET, not a list): claim generation must
        never double-create off a stale cache."""
        try:
            pod = self.kube.get("", "v1", "pods", name, namespace=ns)
        except NotFoundError:
            return
        if not self._owns(pod):
            return
        try:
            by_resource = self._extended_resource_classes()
            ext_names: set[str] | None = set(by_resource)
        except KubeError:
            by_resource, ext_names = {}, None
        changed = self._generate_claims_for(pod)
        if by_resource:
            changed |= self._generate_extended_resource_claims_for(
                pod, by_resource)
        if changed:
            try:
                pod = self.kube.get("", "v1", "pods", name, namespace=ns)
            except NotFoundError:
                return
        self._bind_pod(pod, ext_names)

    def _sync_claim_keys_batched(self, key: tuple) -> None:
        """Batched multi-claim allocation: drain up to ``batch_max``
        due claim keys from this worker's heap (its home shard plus
        any work-stolen keys; per-key exclusion is the queue's
        running-set, not shard residency) against ONE
        inventory snapshot + device-class read, amortizing the
        signature check and the static-CEL memo warmup over the whole
        burst. Extra keys report their outcomes back to the queue via
        ``finish`` (per-key retry discipline preserved)."""
        extras: list[tuple] = []
        if self._queue is not None and self.batch_max > 1:
            extras = self._queue.take_ready(
                lambda k: isinstance(k, tuple) and k and k[0] == "claim",
                self.batch_max - 1)
        if not extras:
            self._sync_claim_key(key[1], key[2])
            return
        try:
            snap, alloc = self._ensure_alloc_state()
            classes = self._device_classes()
        except BaseException as e:
            # The taken extras are marked running in the queue; if the
            # shared setup dies they MUST still be reported or they
            # stay wedged (enqueues for a running key only set the
            # dirty flag). Hand each its own retry.
            for extra in extras:
                self._queue.finish(extra, e)
            raise
        primary_err: BaseException | None = None
        try:
            self._sync_claim_one(key[1], key[2], snap, alloc, classes)
        except Exception as e:  # noqa: BLE001 - re-raised after finishes
            primary_err = e
        for extra in extras:
            err: BaseException | None = None
            try:
                self._sync_claim_one(extra[1], extra[2], snap, alloc,
                                     classes)
            except Exception as e:  # noqa: BLE001 - per-key retry
                err = e
            self._queue.finish(extra, err)
        if primary_err is not None:
            raise primary_err

    def _sync_claim_key(self, ns: str, name: str) -> None:
        """Allocation attempt for ONE claim, re-read fresh so a stale
        cache can never double-allocate."""
        snap, alloc = self._ensure_alloc_state()
        self._sync_claim_one(ns, name, snap, alloc,
                             self._device_classes())

    def _sync_claim_one(self, ns: str, name: str,
                        snap: InventorySnapshot, alloc: AllocationState,
                        classes) -> None:
        try:
            claim = self.kube.get(*RESOURCE, "resourceclaims", name,
                                  namespace=ns)
        except NotFoundError:
            return
        if _meta(claim).get("deletionTimestamp"):
            return
        if claim.get("status", {}).get("allocation"):
            alloc.observe(claim)
            return
        if not self._owns(claim):
            return
        pin = self._pin_for_claim(ns, name)
        qwait = (self._queue.current_wait()
                 if self._queue is not None else None)
        outcome = self._allocate_one(claim, snap, alloc, classes,
                                     pinned_node=pin)
        if outcome == "conflict":
            # Retries exhausted against contended/stale state: hand
            # the claim back to the queue (dirty-flag requeue with the
            # normal backoff) so it re-fits against a FRESH
            # _ensure_alloc_state instead of pending until the next
            # full resync -- at a 10k-node resync cadence that wait
            # would be minutes.
            self._enqueue(("claim", ns, name))
        if outcome == "committed" and qwait is not None and \
                self._slo is not None:
            # The queued phase of THIS claim's winning attempt: dirty-
            # key enqueue -> sync start, including retry/hot backoff.
            # The trace id is the commit span's (stashed by
            # _commit_allocation on this worker thread).
            self._slo.observe("queued", qwait,
                              getattr(self._fit_tls, "trace_id", ""))

    def _pin_for_claim(self, ns: str, claim_name: str) -> str | None:
        """Bound-consumer pin for one claim via the reverse index (no
        full pod scan). Cache read: a lagging bind event only means an
        unpinned placement preference for one attempt, never a
        double-allocation, so the fresh-GET discipline of the claim
        itself does not apply here."""
        with self._state_lock:
            pod_names = set(self._pods_of_claim.get((ns, claim_name), ()))
        for pod_name in pod_names:
            try:
                pod = self.view.get_pod(pod_name, namespace=ns)
            except NotFoundError:
                continue
            node = pod.get("spec", {}).get("nodeName")
            if node:
                return node
        return None

    def _retry_pending_claims(self) -> None:
        """Re-try every still-pending claim (cache scan, then a fresh
        GET per pending claim inside _sync_claim_key). O(pending), and
        pending claims are exactly the ones worth O(1 GET) each. In
        sharded mode the retries fan out to their shards so claim work
        stays serialized per key."""
        for claim in self.view.claims():
            if claim.get("status", {}).get("allocation"):
                continue
            if _meta(claim).get("deletionTimestamp"):
                continue
            if not self._owns(claim):
                continue
            ns = _meta(claim).get("namespace", "default")
            name = _meta(claim)["name"]
            if self._sharded:
                self._enqueue(("claim", ns, name))
            else:
                self._sync_claim_key(ns, name)

    # -- loop -----------------------------------------------------------------

    def run(self, interval: float = 0.25):
        while not self._stop.is_set():
            try:
                self.sync_once()
            except Exception:  # noqa: BLE001 - control loop
                logger.exception("scheduler sync failed")
            self._stop.wait(interval)

    def start(self, interval: float = 0.25) -> "DraScheduler":
        self._thread = threading.Thread(
            target=self.run, args=(interval,), name="dra-scheduler",
            daemon=True)
        self._thread.start()
        return self

    def stop(self):
        """End the polled loop or event mode: the resync thread, the
        queue's workers and the informers, each joined."""
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None
        if self._resync_thread is not None:
            self._resync_thread.join(timeout=5)
            self._resync_thread = None
        if self._queue is not None:
            self._queue.shutdown(wait=True)
            self._queue = None
        self.view.stop()


def run_leader_elected(sched: DraScheduler, namespace: str = "kube-system",
                       identity: str | None = None,
                       stop: threading.Event | None = None,
                       lease_name: str | None = None,
                       interval: float | None = None,
                       **lease_kwargs) -> None:
    """Run ``sched`` while holding its Lease: ``tpu-dra-scheduler``, or
    ``tpu-dra-scheduler-<domain>`` for a scheduler of a domain. A
    standby waits for it; leading runs event mode (the polled loop every
    ``interval`` seconds where one is given) and ends when the Lease is
    lost or ``stop`` is set (the Lease is then released)."""
    from .leaderelection import LeaderElector  # noqa: PLC0415

    stop = stop if stop is not None else threading.Event()
    if lease_name is None:
        lease_name = (sched.domain.lease_name if sched.domain is not None
                      else "tpu-dra-scheduler")
    if identity is None:
        identity = f"sched-{uuid.uuid4().hex[:8]}"
    elector = LeaderElector(sched.kube, lease_name, namespace, identity,
                            **lease_kwargs)

    def lead():
        if interval is None:
            sched.start_event_driven()
        else:
            sched.start(interval)
        stop.wait()

    elector.run(lead, stop, on_stopped_leading=sched.stop)
    sched.stop()


def build_parser() -> argparse.ArgumentParser:
    """The JAX scheduler binary's flags, with its defaults and env."""
    env = os.environ.get
    p = argparse.ArgumentParser(prog="tpu-dra-scheduler")
    p.add_argument("--kube-api", required=True)
    p.add_argument("--default-node", default=None)
    p.add_argument("--interval", type=float, default=0.25,
                   help="seconds between two passes in poll mode")
    p.add_argument("--sched-mode", choices=("events", "poll"),
                   default=env("TPU_DRA_SCHED_MODE", "events"),
                   help="'events' (default): informer-fed dirty keys with "
                        "a full resync every TPU_DRA_SCHED_RESYNC seconds; "
                        "'poll': a full pass every --interval "
                        "[TPU_DRA_SCHED_MODE]")
    p.add_argument("--sched-workers", type=int,
                   default=_env_int("TPU_DRA_SCHED_WORKERS",
                                    DEFAULT_SCHED_WORKERS),
                   help="event-mode workers: 1 drains in order; N > 1 "
                        "shards claim and pod keys over N-1 workers beside "
                        "one for the control keys [TPU_DRA_SCHED_WORKERS]")
    p.add_argument("--sched-batch", type=int,
                   default=_env_int("TPU_DRA_SCHED_BATCH",
                                    DEFAULT_SCHED_BATCH),
                   help="most dirty claim keys fitted against one "
                        "inventory snapshot [TPU_DRA_SCHED_BATCH]")
    p.add_argument("--sched-domain",
                   default=env("TPU_DRA_SCHED_DOMAIN", ""),
                   help="this scheduler's domain; empty: it owns "
                        "everything [TPU_DRA_SCHED_DOMAIN]")
    p.add_argument("--sched-domain-pools",
                   default=env("TPU_DRA_SCHED_DOMAIN_POOLS", ""),
                   help="comma-separated pool names or fnmatch globs the "
                        "domain's inventory is held to "
                        "[TPU_DRA_SCHED_DOMAIN_POOLS]")
    p.add_argument("--sched-domain-default", action="store_true",
                   default=env("TPU_DRA_SCHED_DOMAIN_DEFAULT", "") in (
                       "1", "true", "True"),
                   help="the domain owns unannotated objects and runs the "
                        "cluster-wide controllers "
                        "[TPU_DRA_SCHED_DOMAIN_DEFAULT]")
    p.add_argument("--sched-domain-siblings",
                   default=env("TPU_DRA_SCHED_DOMAIN_SIBLINGS", ""),
                   help="spillover siblings, 'name=glob|glob;name2=glob' "
                        "in order of preference: a claim pinned here that "
                        "does not fit moves to the cheapest of them "
                        "[TPU_DRA_SCHED_DOMAIN_SIBLINGS]")
    p.add_argument("--leader-elect", action="store_true",
                   default=env("TPU_DRA_SCHED_LEADER_ELECT", "") in (
                       "1", "true", "True"),
                   help="run only while holding the (per-domain) Lease "
                        "(hot standby) [TPU_DRA_SCHED_LEADER_ELECT]")
    p.add_argument("--leader-elect-namespace",
                   default=env("TPU_DRA_SCHED_LEASE_NAMESPACE",
                               "kube-system"),
                   help="namespace of the Lease "
                        "[TPU_DRA_SCHED_LEASE_NAMESPACE]")
    p.add_argument("--metrics-port", type=int,
                   default=int(env("METRICS_PORT", "0")),
                   help="serve /metrics on this port; 0 = off "
                        "[METRICS_PORT]")
    p.add_argument("--recovery-root",
                   default=env("TPU_DRA_RECOVERY_ROOT", ""),
                   help="state root of the permanent-failure eviction "
                        "controller's durable records; empty = recovery "
                        "off [TPU_DRA_RECOVERY_ROOT]")
    p.add_argument("--defrag-root",
                   default=env("TPU_DRA_DEFRAG_ROOT", ""),
                   help="state root of the active-defragmentation "
                        "controller's durable move records; empty = "
                        "defrag off [TPU_DRA_DEFRAG_ROOT]")
    p.add_argument("--migration-root",
                   default=env("TPU_DRA_MIGRATION_ROOT", ""),
                   help="state root of the cooperative migration "
                        "controller's durable move records "
                        "(checkpoint-then-switch handshakes); empty = "
                        "cooperative migration off "
                        "[TPU_DRA_MIGRATION_ROOT]")
    p.add_argument("--autoscale-root",
                   default=env("TPU_DRA_AUTOSCALE_ROOT", ""),
                   help="state root of the serving autoscaler's durable "
                        "re-plan records (the demand-driven PartitionSet "
                        "controller); empty = autoscaler off "
                        "[TPU_DRA_AUTOSCALE_ROOT]")
    return p


def domain_from_args(args) -> SchedulingDomain | None:
    """The binary's ``--sched-domain*`` flags as a domain (None without
    a name)."""
    if not args.sched_domain:
        return None
    return SchedulingDomain(
        args.sched_domain,
        pools=[p.strip() for p in args.sched_domain_pools.split(",")
               if p.strip()],
        default=args.sched_domain_default,
        siblings=SchedulingDomain.parse_siblings(args.sched_domain_siblings))


# Seconds the binary in event mode waits for its informers' first lists.
SYNC_TIMEOUT_S = 60.0


def main(argv: list[str] | None = None) -> int:
    from .kubeclient import KubeClient  # noqa: PLC0415
    from . import logsetup  # noqa: PLC0415
    from .. import __version__  # noqa: PLC0415
    from .autoscale import AutoscaleController  # noqa: PLC0415
    from .defrag import DefragController  # noqa: PLC0415
    from .metrics import (AutoscaleMetrics, DefragMetrics,  # noqa: PLC0415
                          FleetMetrics, MetricsServer, MigrationMetrics,
                          PlacementMetrics, RecoveryMetrics,
                          ResilienceMetrics, SchedulerMetrics,
                          register_build_info)
    from .migration import MigrationController  # noqa: PLC0415
    from .recovery import EvictionController  # noqa: PLC0415
    from .retry import RetryingKubeClient  # noqa: PLC0415

    args = build_parser().parse_args(argv)
    # The trace-id log filter: one grep follows a claim across binaries.
    logsetup.setup(_env_int("V", 4))
    logsetup.log_startup(__name__, "tpu-dra-scheduler", __version__, args)
    metrics = sched_metrics = resilience = server = None
    fleet_metrics = recovery_metrics = None
    if args.metrics_port:
        metrics = PlacementMetrics()
        sched_metrics = SchedulerMetrics(registry=metrics.registry)
        resilience = ResilienceMetrics(registry=metrics.registry)
        fleet_metrics = FleetMetrics(registry=metrics.registry)
        register_build_info(metrics.registry)
    sched = DraScheduler(RetryingKubeClient(KubeClient(host=args.kube_api),
                                            metrics=resilience),
                         default_node=args.default_node, metrics=metrics,
                         sched_metrics=sched_metrics,
                         workers=args.sched_workers,
                         batch_max=args.sched_batch,
                         domain=domain_from_args(args),
                         fleet_metrics=fleet_metrics)
    if args.recovery_root:
        if metrics is not None:
            recovery_metrics = RecoveryMetrics(registry=metrics.registry)
        sched.attach_recovery(EvictionController(
            sched.kube, args.recovery_root, metrics=recovery_metrics))
    if args.defrag_root:
        sched.attach_defrag(DefragController(
            sched.kube, args.defrag_root, metrics=(
                DefragMetrics(registry=metrics.registry)
                if metrics is not None else None)))
    if args.migration_root:
        sched.attach_migration(MigrationController(
            sched.kube, args.migration_root, metrics=(
                MigrationMetrics(registry=metrics.registry)
                if metrics is not None else None)))
    if args.autoscale_root:
        sched.attach_autoscaler(AutoscaleController(
            sched.kube, args.autoscale_root, metrics=(
                AutoscaleMetrics(registry=metrics.registry)
                if metrics is not None else None)))
    if metrics is not None:
        server = MetricsServer(metrics.registry, host="0.0.0.0",
                               port=args.metrics_port)
        server.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    print("scheduler running", flush=True)
    events = args.sched_mode == "events"
    try:
        if args.leader_elect:
            run_leader_elected(sched, namespace=args.leader_elect_namespace,
                               stop=stop,
                               interval=None if events else args.interval)
        elif events:
            sched.start_event_driven()
            if not sched.view.wait_for_sync(SYNC_TIMEOUT_S):
                # No fallback to polling: a scheduler that cannot read
                # the cluster ends, for its supervisor to restart.
                logger.error("informers did not sync within %g s",
                             SYNC_TIMEOUT_S)
                return 1
            stop.wait()
        else:
            sched.start(args.interval)
            stop.wait()
    finally:
        sched.stop()
        if server is not None:
            server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
