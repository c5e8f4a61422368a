"""A DRA-aware scheduler and resourceclaim controller (the JAX package's
``pkg/scheduler.py``, its polled pass).

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

One pass is ``sync_once``; ``run(interval)`` repeats it (the JAX
scheduler's polled mode). Every read lists through the API server
(``schedcache.ClusterView`` in direct mode), so the JAX scheduler's
commit log, which covers an informer's lag behind its own patch, has
nothing to cover here and is left out.

What waits, each refused with ``NotPortedError`` naming its ROADMAP.md
item (§1c): event mode (``start_event_driven``,
``--sched-mode events``), workers > 1 and the claim batch, scheduling
domains and spillover, the recovery, defrag, migration and autoscale
controllers (``attach_*``), and the fleet fold (``fleet_metrics``). The
annotations only those controllers write (the defrag target, the domain
and spillover keys) are not read.

Run it as ``python -m k8s_dra_driver_gpu_tpu_torch.pkg.scheduler
--kube-api URL [--default-node N] [--interval S] [--metrics-port N]
[--leader-elect [--leader-elect-namespace NS]]``; SIGTERM ends it with
exit 0.
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

from . import flightrecorder, tracing
from .events import emit_warning_event
from .featuregates import (TOPOLOGY_AWARE_PLACEMENT, FeatureGateError,
                           FeatureGates)
from .kubeclient import ConflictError, KubeError, NotFoundError
from .schedcache import (DOMAINS, EVENT_MODE, ORDER_MISS, WORKERS,
                         AllocationState, Candidate, ClusterView,
                         CompiledSelectors, CounterLedger,
                         InventorySnapshot, NotPortedError, tolerates)
from .topology import TorusGrid, largest_free_shape, set_compactness
from .topology import order_candidates as topo_order_candidates
from .topology.score import frag_from_largest

logger = logging.getLogger(__name__)

RESOURCE = ("resource.k8s.io", "v1")

# What the JAX scheduler attaches to its loop and the port does not run
# yet, by the ROADMAP.md §1c item that ports it.
CONTROLLERS = {
    "recovery": "the permanent-failure recovery controller (ROADMAP.md "
                "§1c item 4, recovery)",
    "defrag": "the defragmentation controller (ROADMAP.md §1c item 5, "
              "defrag)",
    "migration": "the cooperative migration controller (ROADMAP.md §1c "
                 "item 6, migration)",
    "autoscaler": "the serving autoscaler (ROADMAP.md §1c item 7, "
                  "autoscale)",
}
FLEET = "the fleet telemetry fold (ROADMAP.md §1c item 2, fleetstate)"
# Binary flags of the JAX scheduler for what waits, refused when set.
UNPORTED_FLAGS = {
    "sched_domain": DOMAINS, "sched_domain_pools": DOMAINS,
    "sched_domain_siblings": DOMAINS, "sched_domain_default": DOMAINS,
    "sched_batch": WORKERS,
    "recovery_root": CONTROLLERS["recovery"],
    "defrag_root": CONTROLLERS["defrag"],
    "migration_root": CONTROLLERS["migration"],
    "autoscale_root": CONTROLLERS["autoscaler"],
}
# The JAX scheduler's env knobs for what waits, refused when set (its
# binary reads each as the default of the flag above of the same name).
UNPORTED_ENV = {
    "TPU_DRA_SCHED_BATCH": WORKERS,
    "TPU_DRA_SCHED_DOMAIN": DOMAINS, "TPU_DRA_SCHED_DOMAIN_POOLS": DOMAINS,
    "TPU_DRA_SCHED_DOMAIN_SIBLINGS": DOMAINS,
    "TPU_DRA_SCHED_DOMAIN_DEFAULT": DOMAINS,
    "TPU_DRA_RECOVERY_ROOT": CONTROLLERS["recovery"],
    "TPU_DRA_DEFRAG_ROOT": CONTROLLERS["defrag"],
    "TPU_DRA_MIGRATION_ROOT": CONTROLLERS["migration"],
    "TPU_DRA_AUTOSCALE_ROOT": CONTROLLERS["autoscaler"],
}


def _meta(obj):
    return obj.get("metadata", {})


def _json_copy(obj):
    return json.loads(json.dumps(obj))


def _refuse_env(env) -> None:
    """The JAX scheduler's env knobs for what waits, set."""
    workers = env.get("TPU_DRA_SCHED_WORKERS", "")
    if workers.strip() not in ("", "1"):
        raise NotPortedError(f"TPU_DRA_SCHED_WORKERS={workers}: {WORKERS} "
                             "is not ported yet")
    for name, what in UNPORTED_ENV.items():
        if env.get(name, ""):
            raise NotPortedError(f"{name}: {what} is not ported yet")


class _FitBudgetExceeded(Exception):
    """The bounded constraint search ran out of states (MAX_FIT_STEPS)."""


class DraScheduler:
    """The scheduler of one worker in polled mode: call ``sync_once()``,
    ``run()`` or ``start()``."""

    def __init__(self, kube, default_node: str | None = None,
                 gates: FeatureGates | None = None, metrics=None,
                 sched_metrics=None, workers: int | None = None,
                 batch_max: int | None = None, domain=None,
                 fleet_metrics=None):
        if workers is not None and workers != 1:
            raise NotPortedError(f"workers={workers}: {WORKERS} is not "
                                 "ported yet")
        if batch_max is not None:
            raise NotPortedError(f"batch_max={batch_max}: {WORKERS} is "
                                 "not ported yet")
        if domain is not None:
            raise NotPortedError(f"{DOMAINS} is not ported yet")
        if fleet_metrics is not None:
            raise NotPortedError(f"{FLEET} is not ported yet")
        _refuse_env(os.environ)
        self.kube = kube
        self.default_node = default_node
        self._selectors = CompiledSelectors()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        if gates is None:
            try:
                gates = FeatureGates.parse(os.environ.get("FEATURE_GATES",
                                                          ""))
            except FeatureGateError:
                # A malformed FEATURE_GATES must not stop the control
                # plane; the defaults are the safe fallback.
                logger.exception("FEATURE_GATES unparseable; using defaults")
                gates = FeatureGates()
        self.gates = gates
        # ICI topology-aware ordering (pkg/topology); off, first-fit,
        # which is also the fallback wherever devices publish no usable
        # coordinates.
        self._topology = gates.is_enabled(TOPOLOGY_AWARE_PLACEMENT)
        self.metrics = metrics  # PlacementMetrics or None
        self.sched_metrics = sched_metrics  # SchedulerMetrics or None
        self.view = ClusterView(kube, default_node=default_node,
                                on_snapshot_build=self._on_snapshot_build)
        # The claim-lifecycle flight recorder (/debug/claims).
        self.flight = flightrecorder.default()
        # The fit phase's start, for the SLO breakdown (one worker, so
        # one claim is fitted at a time).
        self._fit_t0: float | None = None

    @property
    def _slo(self):
        """The claim-lifecycle SLO histogram, or None without metrics."""
        return (self.sched_metrics.slo
                if self.sched_metrics is not None else None)

    def _refuse_controller(self, which: str):
        raise NotPortedError(f"{CONTROLLERS[which]} is not ported yet")

    def attach_recovery(self, controller) -> "DraScheduler":
        self._refuse_controller("recovery")

    def attach_defrag(self, controller) -> "DraScheduler":
        self._refuse_controller("defrag")

    def attach_migration(self, controller) -> "DraScheduler":
        self._refuse_controller("migration")

    def attach_autoscaler(self, controller) -> "DraScheduler":
        self._refuse_controller("autoscaler")

    def start_event_driven(self) -> "DraScheduler":
        raise NotPortedError(f"{EVENT_MODE} is not ported yet")

    def _on_snapshot_build(self, seconds: float) -> None:
        if self.sched_metrics is not None:
            self.sched_metrics.snapshot_build.observe(seconds)

    # -- claim generation (the resourceclaim controller) ------------------------

    def _pods(self) -> list[dict]:
        try:
            return self.view.pods()
        except KubeError:
            return []

    def _generate_claims(self):
        for pod in self._pods():
            refs = pod.get("spec", {}).get("resourceClaims") or []
            have = {s["name"] for s in pod.get("status", {}).get(
                "resourceClaimStatuses") or []}
            if any(r.get("resourceClaimTemplateName")
                   and r["name"] not in have for r in refs):
                self._generate_claims_for(pod)

    def _generate_claims_for(self, pod) -> bool:
        """Template-driven claim generation for one pod; True when the
        pod's claim statuses were extended."""
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
                continue  # the template is not there yet: next pass
            claim_name = (f"{_meta(pod)['name']}-{ref['name']}-"
                          f"{uuid.uuid4().hex[:5]}")
            claim = {
                "apiVersion": "resource.k8s.io/v1",
                "kind": "ResourceClaim",
                "metadata": {
                    "name": claim_name,
                    "namespace": ns,
                    "uid": f"claim-{uuid.uuid4().hex[:12]}",
                    "annotations": {
                        "resource.kubernetes.io/pod-claim-name": ref["name"],
                    },
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
            self._generate_extended_resource_claims_for(pod, by_resource)

    def _generate_extended_resource_claims_for(self, pod,
                                               by_resource) -> bool:
        if pod.get("status", {}).get("extendedResourceClaimStatus"):
            return False
        # Only while the pod is being scheduled: one already bound or
        # past Pending must not acquire devices after the fact.
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
                # Whole numbers only; a malformed one must not wedge
                # the pass.
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
            # The pod can never schedule: say so on the pod (no
            # admission here rejects the quantity).
            self._flag_unschedulable_pod(
                pod, "InvalidExtendedResourceQuantity",
                f"extended-resource quantity {bad_qty} is not a "
                "whole number; the pod cannot be scheduled")
            return False
        if not requests:
            return False
        ns = _meta(pod).get("namespace", "default")
        # A name from the pod's uid: create and status patch are not
        # atomic, and a retried pass must find the same claim.
        pod_uid = _meta(pod).get("uid", "") or _meta(pod)["name"]
        claim_name = (f"{_meta(pod)['name']}-extended-resources-"
                      f"{pod_uid[-5:]}")
        claim = {
            "apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaim",
            "metadata": {
                "name": claim_name,
                "namespace": ns,
                "uid": f"claim-{uuid.uuid4().hex[:12]}",
                "annotations": {},
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
            pass  # an earlier pass created it
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

    # -- allocation (the DRA plugin of kube-scheduler) --------------------------

    def _rebuild_alloc_state(self) -> tuple[InventorySnapshot,
                                            AllocationState]:
        """The snapshot and an allocation state folded from a fresh list
        of the claims (every pass)."""
        snap = self.view.snapshot()
        alloc = AllocationState(snap)
        alloc.rebuild(self.view.claims())
        return snap, alloc

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

    def _candidate_nodes(self, snap: InventorySnapshot,
                         alloc: AllocationState, window: set,
                         pinned_node: str | None) -> list[str]:
        """The node order for one claim: a ComputeDomain window first,
        then least-allocated (the spreading of a per-pod Filter/Score).
        A claim whose consumer pod is bound probes that node alone."""
        if pinned_node is not None:
            return [pinned_node] if pinned_node in snap.by_node else []
        nodes = alloc.ordered_nodes()
        if window:
            nodes = ([n for n in nodes if n in window]
                     + [n for n in nodes if n not in window])
        return nodes

    def _allocate_one(self, claim, snap: InventorySnapshot,
                      alloc: AllocationState, classes,
                      pinned_node: str | None = None) -> str:
        """One claim: fit on each candidate node in turn (a ComputeDomain
        window's first), reserve (``try_commit``), then patch; a failed
        patch releases the reservation. Returns "committed", "unfit",
        "failed", "conflict" or "norequests"."""
        requests = claim.get("spec", {}).get("devices", {}).get(
            "requests", [])
        if not requests:
            return "norequests"
        window = set(self._preferred_gang_nodes(claim) or ())
        ns = _meta(claim).get("namespace", "default")
        uid = _meta(claim).get("uid", "")
        with tracing.span("sched.claim", attrs={
                "claim": f"{ns}/{_meta(claim).get('name', '?')}",
                "claim_uid": uid}) as claim_span:
            # The fit phase runs from here to try_commit.
            self._fit_t0 = time.monotonic()
            nodes = self._candidate_nodes(snap, alloc, window, pinned_node)
            # One ledger and power copy, shared by every probed node:
            # try_commit judges anew at reserve time.
            outcome = self._fit_and_commit(
                claim, nodes, snap, alloc, alloc.ledger_snapshot(), classes,
                alloc.power_snapshot())
            claim_span.set_attr("outcome", outcome)
        self.flight.record(
            uid or f"{ns}/{_meta(claim).get('name', '?')}", "fit",
            alias=f"{ns}/{_meta(claim).get('name', '?')}",
            trace_id=(claim_span.context.trace_id
                      if claim_span.recording else ""),
            outcome=outcome)
        if outcome == "conflict":
            # One worker fits and reserves against the same state, so
            # only a fit that disagrees with try_commit gets here.
            logger.warning(
                "claim %s/%s: refused at reserve time; leaving pending "
                "for the next sync", ns, _meta(claim).get("name", "?"))
        return outcome

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

    # States the constraint search may visit for one claim on one node
    # before the node counts as unable to take it (a guard against
    # pathological specs).
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

    # -- ICI topology-aware ordering (pkg/topology) ------------------------------

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
        """Reserve atomically, then patch: the reservation is visible
        before the write, and a failed write releases it. The patch
        carries the resourceVersion the fit read (the API server 409s a
        claim touched since) and the commit span's traceparent, so the
        node's prepare spans are its children. Returns "committed",
        "conflict" or "failed"."""
        ns = _meta(claim).get("namespace", "default")
        name = _meta(claim)["name"]
        claim_like = {"metadata": _meta(claim),
                      "status": {"allocation": alloc_obj}}
        uid = _meta(claim).get("uid", "")
        fit_t0 = self._fit_t0
        t_commit0 = time.monotonic()
        with tracing.span("sched.commit", attrs={
                "claim_uid": uid}) as commit_sp:
            if not alloc.try_commit(claim_like):
                commit_sp.set_attr("conflict", True)
                self.flight.record(
                    uid or name, "commit_conflict", alias=f"{ns}/{name}",
                    trace_id=(commit_sp.context.trace_id
                              if commit_sp.recording else ""))
                return "conflict"
            trace_id = (commit_sp.context.trace_id
                        if commit_sp.recording else "")
            patch = {"status": {"allocation": alloc_obj}}
            rv = _meta(claim).get("resourceVersion")
            if rv is not None:
                patch["metadata"] = {"resourceVersion": rv}
            if commit_sp.recording:
                patch.setdefault("metadata", {})["annotations"] = (
                    tracing.inject(commit_sp, {}))
            elif tracing.TRACEPARENT_ANNOTATION in (
                    _meta(claim).get("annotations") or {}):
                # An unsampled re-allocation clears an earlier
                # allocation's traceparent, or the prepare would join
                # the dead trace.
                patch.setdefault("metadata", {})["annotations"] = {
                    tracing.TRACEPARENT_ANNOTATION: None}
            t_patch0 = time.monotonic()
            try:
                self.kube.patch(*RESOURCE, "resourceclaims", name, patch,
                                namespace=ns)
            except (NotFoundError, ConflictError):
                alloc.forget(claim_like)
                return "failed"
            t_end = time.monotonic()
            if commit_sp.recording:
                commit_sp.set_attr("patch_ms",
                                   round((t_end - t_patch0) * 1e3, 3))
        if self._slo is not None:
            if fit_t0 is not None:
                self._slo.observe("fit", t_commit0 - fit_t0, trace_id)
            self._slo.observe("commit", t_patch0 - t_commit0, trace_id)
            self._slo.observe("patch", t_end - t_patch0, trace_id)
        devices = [r["device"] for r in alloc_obj["devices"]["results"]]
        self.flight.record(uid or name, "alloc_patched",
                           alias=f"{ns}/{name}", trace_id=trace_id,
                           devices=devices)
        self._observe_placement(alloc_obj, snap, alloc)
        logger.info("allocated claim %s/%s -> %s", ns, name, devices)
        return "committed"

    def _allocate_claims(self):
        snap, alloc = self._rebuild_alloc_state()
        classes = self._device_classes()
        pins = self._claim_pins()
        for claim in self.view.claims():
            if claim.get("status", {}).get("allocation"):
                continue
            if _meta(claim).get("deletionTimestamp"):
                continue
            pin = pins.get((_meta(claim).get("namespace", "default"),
                            _meta(claim)["name"]))
            self._allocate_one(claim, snap, alloc, classes,
                               pinned_node=pin)

    # -- binding ---------------------------------------------------------------

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
            ext_names = None
        for pod in self._pods():
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

    # -- the DaemonSet controller ------------------------------------------------

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

    # -- the Job controller (completions=1) --------------------------------------

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

    # -- the pass and its loop ---------------------------------------------------

    def sync_once(self):
        t0 = time.monotonic()
        self.view.begin_pass()
        self._sync_daemonsets()
        self._sync_jobs()
        self._generate_claims()
        self._generate_extended_resource_claims()
        self._allocate_claims()
        self._bind_pods()
        if self.sched_metrics is not None:
            self.sched_metrics.sync_seconds.labels("full").observe(
                time.monotonic() - t0)

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
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=5)
            self._thread = None


def run_leader_elected(sched: DraScheduler, namespace: str = "kube-system",
                       identity: str | None = None,
                       stop: threading.Event | None = None,
                       interval: float = 0.25) -> None:
    """Run the polled loop while holding the Lease ``tpu-dra-scheduler``
    (the JAX scheduler's per-domain lease names wait with domains): a
    standby waits for it, and leading ends when the Lease is lost or
    ``stop`` is set (the Lease is then released)."""
    from .leaderelection import LeaderElector  # noqa: PLC0415

    stop = stop if stop is not None else threading.Event()
    if identity is None:
        identity = f"sched-{uuid.uuid4().hex[:8]}"
    elector = LeaderElector(sched.kube, "tpu-dra-scheduler", namespace,
                            identity)

    def lead():
        sched.start(interval)
        stop.wait()

    elector.run(lead, stop, on_stopped_leading=sched.stop)
    sched.stop()


def build_parser() -> argparse.ArgumentParser:
    env = os.environ.get
    p = argparse.ArgumentParser(prog="tpu-dra-scheduler")
    p.add_argument("--kube-api", required=True)
    p.add_argument("--default-node", default=None)
    p.add_argument("--interval", type=float, default=0.25,
                   help="seconds between two passes")
    p.add_argument("--sched-mode", choices=("events", "poll"),
                   default=env("TPU_DRA_SCHED_MODE", "poll"),
                   help="'poll' (the port's only mode): a full pass every "
                        "--interval; 'events' is refused "
                        "[TPU_DRA_SCHED_MODE]")
    p.add_argument("--sched-workers", type=int, default=1,
                   help="1; more is refused [TPU_DRA_SCHED_WORKERS]")
    p.add_argument("--leader-elect", action="store_true",
                   default=env("TPU_DRA_SCHED_LEADER_ELECT", "") in (
                       "1", "true", "True"),
                   help="run only while holding the Lease "
                        "tpu-dra-scheduler (hot standby) "
                        "[TPU_DRA_SCHED_LEADER_ELECT]")
    p.add_argument("--leader-elect-namespace",
                   default=env("TPU_DRA_SCHED_LEASE_NAMESPACE",
                               "kube-system"),
                   help="namespace of the Lease "
                        "[TPU_DRA_SCHED_LEASE_NAMESPACE]")
    p.add_argument("--metrics-port", type=int,
                   default=int(env("METRICS_PORT", "0")),
                   help="serve /metrics on this port; 0 = off "
                        "[METRICS_PORT]")
    # The JAX scheduler's flags for what waits: refused when set.
    for flag in UNPORTED_FLAGS:
        if flag == "sched_domain_default":
            p.add_argument("--sched-domain-default", action="store_true",
                           help="refused: not ported")
        else:
            p.add_argument("--" + flag.replace("_", "-"), default="",
                           help="refused: not ported")
    return p


def main(argv: list[str] | None = None) -> int:
    from .kubeclient import KubeClient  # noqa: PLC0415
    from . import logsetup  # noqa: PLC0415
    from .. import __version__  # noqa: PLC0415
    from .metrics import (MetricsServer, PlacementMetrics,  # noqa: PLC0415
                          ResilienceMetrics, SchedulerMetrics,
                          register_build_info)
    from .retry import RetryingKubeClient  # noqa: PLC0415

    args = build_parser().parse_args(argv)
    for flag, what in UNPORTED_FLAGS.items():
        if getattr(args, flag):
            raise NotPortedError(f"--{flag.replace('_', '-')}: {what} is "
                                 "not ported yet")
    if args.sched_mode == "events":
        raise NotPortedError(f"--sched-mode events: {EVENT_MODE} is not "
                             "ported yet")
    try:
        verbosity = int(os.environ.get("V", "4"))
    except ValueError:
        verbosity = 4
    # The trace-id log filter: one grep follows a claim across binaries.
    logsetup.setup(verbosity)
    logsetup.log_startup(__name__, "tpu-dra-scheduler", __version__, args)
    metrics = sched_metrics = resilience = server = None
    if args.metrics_port:
        metrics = PlacementMetrics()
        sched_metrics = SchedulerMetrics(registry=metrics.registry)
        resilience = ResilienceMetrics(registry=metrics.registry)
        register_build_info(metrics.registry)
    sched = DraScheduler(RetryingKubeClient(KubeClient(host=args.kube_api),
                                            metrics=resilience),
                         default_node=args.default_node, metrics=metrics,
                         sched_metrics=sched_metrics,
                         workers=args.sched_workers)
    if metrics is not None:
        server = MetricsServer(metrics.registry, host="0.0.0.0",
                               port=args.metrics_port)
        server.start()
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    print("scheduler running", flush=True)
    try:
        if args.leader_elect:
            run_leader_elected(sched, namespace=args.leader_elect_namespace,
                               stop=stop, interval=args.interval)
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
