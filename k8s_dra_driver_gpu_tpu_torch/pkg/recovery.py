"""Permanent-failure recovery: claim eviction & migration controller
(the JAX package's ``pkg/recovery.py``, the port's copy).

The retrying client, gang deadlines and quarantine taints make the
control plane survive *transient* faults. This module handles the
failures that never heal: a host that dies, a chip that fails fatally, a kubelet
plugin wiped mid-prepare. The reference driver's core promise is that
claims *converge* after any failure (gang-prepare + unwind semantics);
here that promise is extended past process death to hardware death.

Three cooperating pieces:

- :class:`FailureDetector` -- escalates transient badness to a declared
  **permanent failure**: a node ``NotReady`` past a grace deadline, a
  node deleted outright, or a device carrying a fatal taint
  (``tpu.dra.dev/failed`` from the health layer's quarantine
  escalation, or any fatal ``NoExecute`` health taint).
- :class:`EvictionController` -- for every allocated claim touched by a
  permanent failure: declare a ``PermanentFailure`` condition on the
  claim, taint the node ``tpu.dra.dev/failed``, then drive a staged
  eviction (drain consumer pods -> drop reservations -> deallocate) so
  the scheduler (pkg/scheduler, ``attach_recovery``) re-places the
  claim on surviving capacity. Gang claims (ComputeDomain channels sharing a
  ``domainID``) are evicted as a unit -- a gang with one dead member
  can never rendezvous, so its surviving nodes are drained too (their
  plugins unwind via the reconcile sweep, reusing
  ``CDDeviceState.unwind_failed_prepare`` semantics). Moves are
  *planned*: each eviction group is scored by migration cost vs. gang
  disruption (the MIG-aware VM placement framing, 2502.01909) and
  admitted under a bounded concurrency cap, cheapest recovery first.
- Durable progress -- every in-flight eviction is one record in a
  CheckpointManager (kubeletplugin/checkpoint.py; one controller thread
  writes them, so the JAX manager's group commit buys nothing here)
  under the ``eviction`` TransitionPolicy (pkg/statemachine.py), so
  a controller crash mid-eviction resumes idempotently from the
  durable state, and an illegal stage skip fails the commit loudly.

Per-claim recovery deadlines bound the tail: a claim that cannot be
re-placed within ``TPU_DRA_RECOVERY_DEADLINE_S`` retires as *cleanly
failed* -- ``PermanentFailure`` condition with reason
``RecoveryDeadlineExceeded``, no allocation, no in-flight record --
never stuck mid-eviction.

The node-plugin half of the story (the cross-layer reconciliation
sweep) lives in ``kubeletplugin/reconcile.py``; both export
``tpu_dra_recovery_*`` metrics (pkg/metrics.RecoveryMetrics). Every
stage transition is an ``eviction`` flight event under the claim's uid
(``/debug/claims``), and a re-placement observes the scheduler's SLO
``evict`` phase under the claim's trace id. A blown deadline dumps
the claim's flight record to the log and drops an incident bundle
(``pkg/doctor.auto_bundle``, trigger ``eviction-deadline``).
"""

from __future__ import annotations

import copy
import logging
import threading
import time

from . import doctor, faults, flightrecorder, positive_float_env, tracing
from .statemachine import (
    EVICTION_DEALLOCATED,
    EVICTION_DRAINING,
    EVICTION_PLANNED,
    EVICTION_POLICY,
)
from .kubeclient import ConflictError, KubeError, NotFoundError

logger = logging.getLogger(__name__)

RESOURCE = ("resource.k8s.io", "v1")

#: Node + device taint key of a DECLARED permanent failure. On a node:
#: NoExecute, applied by the controller at escalation. On a device:
#: published by the health layer's quarantine escalation
#: (kubeletplugin/health.py) and treated as fatal here.
FAILED_TAINT_KEY = "tpu.dra.dev/failed"

#: ResourceClaim condition type carrying the declared failure (and,
#: with status False / reason Recovered, the successful migration).
PERMANENT_FAILURE_CONDITION = "PermanentFailure"

#: Device-taint prefix whose NoExecute entries count as fatal chip
#: events (hbm_uncorrectable, chip_lost, ... -- health.py maps fatal
#: tpulib events to NoExecute taints under this prefix).
_HEALTH_TAINT_PREFIX = "tpu.dra.dev/"

# Operator knobs (docs/operations.md "Permanent-failure recovery").
NOTREADY_GRACE_S = positive_float_env(
    "TPU_DRA_RECOVERY_NOTREADY_S", default=60.0, floor=0.01)
RECOVERY_DEADLINE_S = positive_float_env(
    "TPU_DRA_RECOVERY_DEADLINE_S", default=300.0, floor=0.01)
MAX_CONCURRENT_EVICTIONS = int(positive_float_env(
    "TPU_DRA_RECOVERY_MAX_CONCURRENT", default=4, floor=1))
#: Weight of one disrupted healthy gang companion relative to one
#: migrated device in the move score (2502.01909: recovered capacity
#: is traded against disruption, not taken for free).
DISRUPTION_WEIGHT = positive_float_env(
    "TPU_DRA_RECOVERY_DISRUPTION_WEIGHT", default=4.0, floor=0.0)
#: Weight of one fully-aged claim (uptime >= AGE_SCALE_S) in the move
#: score: migrating a claim that has been running for hours throws
#: away hours of work (checkpoint distance, warmed caches), so the
#: planner prefers moving young claims over long-running training
#: gangs when either recovers the same capacity.
AGE_WEIGHT = positive_float_env(
    "TPU_DRA_RECOVERY_AGE_WEIGHT", default=2.0, floor=0.0)
#: Uptime at which a claim counts as fully aged (the age term
#: saturates there -- a week-old gang is not 50x costlier than a
#: 3-hour one, it is simply "old").
AGE_SCALE_S = positive_float_env(
    "TPU_DRA_RECOVERY_AGE_SCALE_S", default=3600.0, floor=1.0)

#: Claims carrying this annotation (any value but "false") declare the
#: cooperative checkpoint-then-switch contract (pkg/migration): the
#: workload checkpoints on demand when signaled, so moving it costs a
#: bounded checkpoint-restore instead of a cold restart.
MIGRATION_CAPABLE_ANNOTATION = "resource.tpu.dra/migration-capable"

#: The second price tier of the 2502.01909 migration-cost model: a
#: move group whose every member is migration-capable scores at this
#: fraction of its cold cost. 0.25 means a cooperative gang is four
#: times cheaper to displace -- recovery admission, defrag victim
#: selection, and the autoscaler's repack hysteresis all converge more
#: aggressively on workloads that promised to cooperate.
COOP_COST_FACTOR = positive_float_env(
    "TPU_DRA_COOP_COST_FACTOR", default=0.25, floor=0.0)


def claim_migration_capable(claim: dict) -> bool:
    raw = (_meta(claim).get("annotations") or {}).get(
        MIGRATION_CAPABLE_ANNOTATION)
    return raw is not None and raw not in ("false", "False", "0")


def coop_cost_multiplier(claims: list[dict],
                         factor: float | None = None) -> float:
    """Cooperative discount for one move group: ``factor`` when EVERY
    member declares the checkpoint-then-switch contract, 1.0
    otherwise. All-or-nothing on purpose: a gang with one cold-only
    member still pays a full cold rendezvous, so discounting it would
    misprice the move."""
    if not claims:
        return 1.0
    factor = COOP_COST_FACTOR if factor is None else factor
    if all(claim_migration_capable(c) for c in claims):
        return min(max(factor, 0.0), 1.0)
    return 1.0


def _meta(obj: dict) -> dict:
    return obj.get("metadata", {})


def _node_ready(node: dict) -> bool:
    """A node with no Ready condition at all reads as Ready: bare test
    environments (and freshly registered nodes) must not be mass-failed
    by an absent status block."""
    for cond in node.get("status", {}).get("conditions") or []:
        if cond.get("type") == "Ready":
            return cond.get("status") == "True"
    return True


def claim_gang_id(claim: dict) -> str | None:
    """The ComputeDomain uid a channel claim belongs to, or None.
    Gangs are the unit of eviction: one permanently failed member
    strands the whole rendezvous."""
    for cfg in claim.get("spec", {}).get("devices", {}).get(
            "config", []) or []:
        params = (cfg.get("opaque") or {}).get("parameters") or {}
        if params.get("kind") == "ComputeDomainChannelConfig" and \
                params.get("domainID"):
            return params["domainID"]
    return None


def allocation_nodes(claim: dict) -> set[str]:
    """Node names an allocation pins (from its nodeSelector)."""
    alloc = claim.get("status", {}).get("allocation") or {}
    nodes: set[str] = set()
    for term in alloc.get("nodeSelector", {}).get(
            "nodeSelectorTerms", []):
        for mf in term.get("matchFields", []):
            if mf.get("key") == "metadata.name":
                nodes.update(mf.get("values") or [])
    return nodes


def allocation_device_keys(claim: dict) -> set[tuple[str, str, str]]:
    alloc = claim.get("status", {}).get("allocation") or {}
    return {
        (r.get("driver", ""), r.get("pool", ""), r.get("device", ""))
        for r in alloc.get("devices", {}).get("results", [])
    }


def claim_age_s(claim: dict, now: float | None = None) -> float:
    """Claim uptime in seconds from ``metadata.creationTimestamp``
    (RFC3339); 0.0 when absent or unparseable -- an ageless claim is
    scored as brand new, i.e. cheap to move, which fails safe (the
    planner can only UNDER-protect a claim it cannot date)."""
    ts = _meta(claim).get("creationTimestamp")
    if not ts or not isinstance(ts, str):
        return 0.0
    import datetime  # noqa: PLC0415 - leaf helper, cold path

    try:
        created = datetime.datetime.fromisoformat(
            ts.replace("Z", "+00:00"))
    except ValueError:
        return 0.0
    if created.tzinfo is None:
        created = created.replace(tzinfo=datetime.timezone.utc)
    now = time.time() if now is None else now
    return max(now - created.timestamp(), 0.0)


def age_cost(claims: list[dict], age_weight: float = AGE_WEIGHT,
             age_scale_s: float = AGE_SCALE_S,
             now: float | None = None) -> float:
    """The uptime term of a migration-cost score, summed over a move
    group: each claim contributes ``age_weight x min(uptime /
    age_scale, 1)``. Shared by the eviction planner and the defrag
    planner (pkg/defrag) so 'prefer young victims' means the same
    thing in both."""
    now = time.time() if now is None else now
    return age_weight * sum(
        min(claim_age_s(c, now) / age_scale_s, 1.0) for c in claims)


def consumer_pods_of(claim: dict, pods: list[dict]) -> list[dict]:
    """Pods consuming a claim: reservedFor entries, resourceClaims
    refs/statuses, and the extended-resource claim status."""
    ns = _meta(claim).get("namespace", "default")
    name = _meta(claim).get("name", "")
    reserved = {
        (ns, r.get("name", ""))
        for r in claim.get("status", {}).get("reservedFor") or []
        if r.get("resource") == "pods"
    }
    out = []
    for pod in pods:
        pns = _meta(pod).get("namespace", "default")
        if pns != ns:
            continue
        if (pns, _meta(pod).get("name", "")) in reserved:
            out.append(pod)
            continue
        statuses = {s.get("resourceClaimName")
                    for s in pod.get("status", {}).get(
                        "resourceClaimStatuses") or []}
        refs = {r.get("resourceClaimName")
                for r in pod.get("spec", {}).get(
                    "resourceClaims") or []}
        ext = (pod.get("status", {}).get(
            "extendedResourceClaimStatus") or {}).get(
            "resourceClaimName")
        if name in statuses or name in refs or name == ext:
            out.append(pod)
    return out


def drain_claim(kube, claim: dict, pods: list[dict]) -> None:
    """The drain stage both migration controllers share (eviction +
    defrag): evict BOUND consumer pods and drop the reservations.
    Unbound pods survive -- they simply wait for the re-placement;
    deleted pods come back through their controllers (Jobs,
    DaemonSets) exactly like a real eviction."""
    ns = _meta(claim).get("namespace", "default")
    for pod in consumer_pods_of(claim, pods):
        if not pod.get("spec", {}).get("nodeName"):
            continue
        try:
            kube.delete("", "v1", "pods", _meta(pod)["name"],
                        namespace=ns)
            logger.warning("evicted pod %s/%s (consumer of migrating "
                           "claim %s)", ns, _meta(pod)["name"],
                           _meta(claim).get("uid", ""))
        except NotFoundError:
            pass
    if claim.get("status", {}).get("reservedFor"):
        try:
            kube.patch(*RESOURCE, "resourceclaims",
                       _meta(claim)["name"],
                       {"status": {"reservedFor": None}},
                       namespace=ns)
        except (NotFoundError, ConflictError):
            pass


def clear_allocation(kube, claim: dict) -> bool:
    """The deallocate stage both migration controllers share: clear
    the claim's allocation so the incremental scheduler owns
    re-placement. Returns False when the write was refused (NotFound /
    Conflict) -- the caller re-examines next pass."""
    try:
        kube.patch(*RESOURCE, "resourceclaims", _meta(claim)["name"],
                   {"status": {"allocation": None}},
                   namespace=_meta(claim).get("namespace", "default"))
    except (NotFoundError, ConflictError):
        return False
    return True


def set_permanent_failure_condition(kube, claim: dict, status: str,
                                    reason: str, message: str) -> bool:
    """Upsert the claim's PermanentFailure condition (deduped on
    status+reason). Shared by the eviction controller and the node
    plugins' reconcile sweep. Returns True when a patch was written."""
    ns = _meta(claim).get("namespace", "default")
    name = _meta(claim).get("name", "")
    conditions = claim.get("status", {}).get("conditions") or []
    for c in conditions:
        if c.get("type") == PERMANENT_FAILURE_CONDITION and \
                c.get("status") == status and \
                c.get("reason") == reason:
            return False  # already says exactly this
    kept = [c for c in conditions
            if c.get("type") != PERMANENT_FAILURE_CONDITION]
    kept.append({
        "type": PERMANENT_FAILURE_CONDITION,
        "status": status,
        "reason": reason,
        "message": message,
    })
    try:
        kube.patch(*RESOURCE, "resourceclaims", name,
                   {"status": {"conditions": kept}}, namespace=ns)
    except (NotFoundError, ConflictError):
        return False
    return True


class FailureDetector:
    """Escalates node/device badness to declared permanent failures.

    State is in-memory and re-derived every observation pass; the
    DURABLE failure markers are the node taint and the claim condition
    the controller writes, plus the deleted node's retired slices --
    so a restarted controller re-detects everything that still
    matters and nothing that healed."""

    def __init__(self, notready_grace_s: float = NOTREADY_GRACE_S,
                 clock=time.monotonic):
        self.notready_grace_s = notready_grace_s
        self._clock = clock
        self._known: set[str] = set()
        self._not_ready_since: dict[str, float] = {}
        #: Nodes declared permanently failed (NotReady past grace, or
        #: carrying the failed taint already -- the durable marker).
        self.failed_nodes: set[str] = set()
        #: Nodes that existed and were deleted (positive evidence: the
        #: node list that no longer contains them SUCCEEDED).
        self.deleted_nodes: set[str] = set()

    def observe_nodes(self, nodes: list[dict]) -> None:
        now = self._clock()
        present = {_meta(n)["name"] for n in nodes if _meta(n).get("name")}
        self.deleted_nodes |= self._known - present
        self.deleted_nodes -= present  # a re-registered node is alive
        self._known |= present
        failed: set[str] = set()
        for node in nodes:
            name = _meta(node).get("name")
            if not name:
                continue
            tainted = any(
                t.get("key") == FAILED_TAINT_KEY
                for t in node.get("spec", {}).get("taints") or [])
            if _node_ready(node) and not tainted:
                self._not_ready_since.pop(name, None)
                continue
            since = self._not_ready_since.setdefault(name, now)
            if tainted or now - since >= self.notready_grace_s:
                failed.add(name)
        self.failed_nodes = failed

    @property
    def permanently_failed(self) -> set[str]:
        return self.failed_nodes | self.deleted_nodes

    @staticmethod
    def fatal_device_keys(slices: list[dict]) -> set[tuple[str, str, str]]:
        """(driver, pool, device) keys carrying a declared-failed taint
        or any fatal (NoExecute) health taint."""
        fatal: set[tuple[str, str, str]] = set()
        for s in slices:
            spec = s.get("spec", {})
            driver = spec.get("driver", "")
            pool = spec.get("pool", {}).get("name", "")
            for dev in spec.get("devices", []) or []:
                for taint in dev.get("taints") or []:
                    key = taint.get("key", "")
                    if key == FAILED_TAINT_KEY or (
                            taint.get("effect") == "NoExecute"
                            and key.startswith(_HEALTH_TAINT_PREFIX)):
                        fatal.add((driver, pool, dev.get("name", "")))
                        break
        return fatal


class EvictionController:
    """Plans and drives permanent-failure evictions; designed to run
    inside the scheduler's pass (``attach_recovery``) or be driven
    directly (``sync_once``)."""

    #: Meta device name carrying the eviction record's plan payload
    #: (failed node, source, planned-at wall clock, score) in its
    #: ``live`` dict -- the checkpoint schema's one free-form slot.
    _META_DEVICE = "eviction"

    def __init__(self, kube, root: str, metrics=None,
                 notready_grace_s: float = NOTREADY_GRACE_S,
                 deadline_s: float = RECOVERY_DEADLINE_S,
                 max_concurrent: int = MAX_CONCURRENT_EVICTIONS,
                 disruption_weight: float = DISRUPTION_WEIGHT,
                 age_weight: float = AGE_WEIGHT,
                 clock=time.monotonic):
        # Imported here, not at module top: pkg -> kubeletplugin is a
        # one-way street everywhere else; keeping it function-local
        # preserves pkg's import-light surface for non-driver users.
        from ..kubeletplugin.checkpoint import (  # noqa: PLC0415
            CheckpointManager,
        )

        self.kube = kube
        self.metrics = metrics  # pkg.metrics.RecoveryMetrics | None
        self.deadline_s = deadline_s
        self.max_concurrent = max(1, int(max_concurrent))
        self.disruption_weight = disruption_weight
        self.age_weight = age_weight
        self.detector = FailureDetector(
            notready_grace_s=notready_grace_s, clock=clock)
        # Eviction lifecycle records, durable + transition-validated:
        # the idempotent-resume anchor (see module docstring).
        self._checkpoint = CheckpointManager(
            root, transition_policy=EVICTION_POLICY)
        self._lock = threading.Lock()
        self._excluded: frozenset[str] = frozenset()
        # Optional read surface (pkg/schedcache.ClusterView), set by
        # DraScheduler.attach_recovery: the reads share the pass's
        # lists; writes always go through the kube client.
        self.view = None
        # Resumed records count (cheap busy() signal for the
        # scheduler's claim-event gating).
        self._active_count = len(self._checkpoint.get().claims)
        self.last_sync: dict = {}
        # Claim-lifecycle SLO sink (pkg/metrics.ClaimSLOMetrics): set
        # by DraScheduler.attach_recovery so eviction e2e latency
        # (plan -> re-placement) reports as the "evict" phase on the
        # scheduler's registry. None = standalone controller, no SLO.
        self.slo = None
        # Per-claim flight recorder: every eviction stage transition
        # lands in the ring, and a deadline failure dumps the claim's
        # whole timeline into the log.
        self.flight = flightrecorder.default()

    # -- scheduler surface ----------------------------------------------------

    def excluded_nodes(self) -> frozenset[str]:
        """Nodes allocation must avoid; cheap cached read for the
        scheduler's per-claim fit."""
        with self._lock:
            return self._excluded

    def busy(self) -> bool:
        """True while any eviction record is in flight -- the
        scheduler gates per-claim-event recovery enqueues on this so
        ordinary claim churn never triggers recovery passes."""
        with self._lock:
            return self._active_count > 0

    def active_evictions(self) -> dict[str, str]:
        """uid -> eviction state of every in-flight record."""
        return {uid: rec.state
                for uid, rec in self._checkpoint.get().claims.items()}

    # -- reads ----------------------------------------------------------------
    # Through the scheduler's ClusterView when attached (the pass's
    # lists, the same KubeError semantics); straight off the kube
    # client otherwise. Every advance step is an idempotent patch, so a
    # read a step behind is re-driven by the next pass.

    def _list_nodes(self) -> list[dict]:
        if self.view is not None:
            return self.view.nodes()
        return self.kube.list("", "v1", "nodes")

    def _list_slices(self) -> list[dict]:
        if self.view is not None:
            return self.view.slices()
        return self.kube.list(*RESOURCE, "resourceslices")

    def _list_claims(self) -> list[dict]:
        if self.view is not None:
            return self.view.claims()
        return self.kube.list(*RESOURCE, "resourceclaims")

    # -- sync -----------------------------------------------------------------

    def sync_once(self) -> dict:
        """One full detect -> plan -> advance pass. Every stage is
        idempotent; a crash anywhere resumes from the durable records.
        Returns a counts summary (also kept as ``last_sync``)."""
        faults.fault_point("recovery.sync")
        counts = {"victims": 0, "planned": 0, "drained": 0,
                  "deallocated": 0, "replaced": 0, "failed": 0,
                  "canceled": 0}
        try:
            nodes = self._list_nodes()
        except KubeError:
            nodes = None
        try:
            slices = self._list_slices()
            claims = self._list_claims()
        except KubeError:
            logger.warning("recovery sync: inventory list failed; "
                           "retrying next pass")
            return counts
        if nodes is not None:
            self.detector.observe_nodes(nodes)
        failed_nodes = self.detector.permanently_failed
        fatal_devices = self.detector.fatal_device_keys(slices)
        with self._lock:
            self._excluded = frozenset(failed_nodes)

        if nodes is not None:
            self._taint_failed_nodes(nodes)
        self._retire_deleted_node_slices(slices)

        victims = self._find_victims(claims, failed_nodes, fatal_devices)
        counts["victims"] = len(victims)
        self._plan(victims, claims, counts)
        self._advance(claims, failed_nodes, fatal_devices, counts)

        active = len(self._checkpoint.get().claims)
        with self._lock:
            self._active_count = active
        if self.metrics is not None:
            self.metrics.active_evictions.set(active)
        self.last_sync = counts
        return counts

    # -- escalation -----------------------------------------------------------

    def _taint_failed_nodes(self, nodes: list[dict]) -> None:
        """Durably mark failed nodes (NoExecute): the taint is the
        restart-safe failure marker and the operator-visible signal."""
        for node in nodes:
            name = _meta(node).get("name")
            if not name or name not in self.detector.failed_nodes:
                continue
            taints = node.get("spec", {}).get("taints") or []
            if any(t.get("key") == FAILED_TAINT_KEY for t in taints):
                continue
            new_taints = copy.deepcopy(taints) + [{
                "key": FAILED_TAINT_KEY, "value": "true",
                "effect": "NoExecute",
            }]
            try:
                self.kube.patch("", "v1", "nodes", name,
                                {"spec": {"taints": new_taints}})
                logger.warning("node %s declared permanently failed "
                               "(%s taint applied)", name,
                               FAILED_TAINT_KEY)
            except (NotFoundError, ConflictError):
                pass

    def _retire_deleted_node_slices(self, slices: list[dict]) -> None:
        """A deleted node's ResourceSlices are orphans (a real cluster
        GCs them via ownerRefs): retire them so the inventory snapshot
        stops offering capacity that no longer exists."""
        for s in slices:
            node = s.get("spec", {}).get("nodeName")
            if node and node in self.detector.deleted_nodes:
                try:
                    self.kube.delete(*RESOURCE, "resourceslices",
                                     _meta(s)["name"])
                except NotFoundError:
                    continue
                if self.metrics is not None:
                    self.metrics.orphans_repaired.labels("slice").inc()
                logger.warning(
                    "retired orphan slice %s of deleted node %s",
                    _meta(s).get("name"), node)

    def _find_victims(self, claims, failed_nodes, fatal_devices
                      ) -> dict[str, str]:
        """uid -> failure source for every allocated claim touched by a
        permanent failure, expanded to whole gangs."""
        by_gang: dict[str, list[dict]] = {}
        victims: dict[str, str] = {}
        direct: dict[str, dict] = {}
        for claim in claims:
            if not claim.get("status", {}).get("allocation"):
                continue
            if _meta(claim).get("deletionTimestamp"):
                continue
            gang = claim_gang_id(claim)
            if gang:
                by_gang.setdefault(gang, []).append(claim)
            uid = _meta(claim).get("uid", "")
            if not uid:
                continue
            if allocation_nodes(claim) & failed_nodes:
                victims[uid] = "node"
                direct[uid] = claim
            elif allocation_device_keys(claim) & fatal_devices:
                victims[uid] = "device"
                direct[uid] = claim
        # Gang expansion: every allocated companion of a failed member
        # must drain too (surviving nodes unwind via their plugins'
        # reconcile sweep).
        for gang, members in by_gang.items():
            if not any(_meta(m).get("uid") in victims for m in members):
                continue
            for m in members:
                uid = _meta(m).get("uid", "")
                if uid and uid not in victims:
                    victims[uid] = "gang"
        return victims

    # -- planning -------------------------------------------------------------

    def _plan(self, victims: dict[str, str], claims: list[dict],
              counts: dict) -> None:
        """Score and admit new evictions under the concurrency cap.
        Groups (whole gangs / singletons) are admitted atomically,
        cheapest recovery first: score = devices to migrate +
        disruption_weight x healthy companions disturbed."""
        if not victims:
            return
        records = self._checkpoint.get().claims
        new = {uid: src for uid, src in victims.items()
               if uid not in records}
        if not new:
            return
        with self._lock:
            # Eager busy(): the condition/record writes below fire
            # synchronous informer events whose recovery enqueues are
            # gated on it -- the count proper lands at end of sync.
            self._active_count = max(self._active_count, 1)
        by_uid = {_meta(c).get("uid", ""): c for c in claims}
        groups: dict[str, list[str]] = {}
        for uid in new:
            claim = by_uid.get(uid)
            gang = claim_gang_id(claim) if claim else None
            groups.setdefault(gang or f"solo-{uid}", []).append(uid)
        scored = []
        now = time.time()
        for gid, uids in groups.items():
            cost = sum(len(allocation_device_keys(by_uid[u]))
                       for u in uids if u in by_uid)
            disruption = sum(1 for u in uids if new.get(u) == "gang")
            # Uptime term: admission order prefers young claims, so a
            # long-running training gang waits behind a fresh
            # singleton when the concurrency cap forces a choice.
            aged = age_cost([by_uid[u] for u in uids if u in by_uid],
                            self.age_weight, now=now)
            # Cooperative tier: a group that checkpoints on demand
            # loses a bounded restore, not its uptime -- its recovery
            # is admitted ahead of equally-sized cold groups.
            coop = coop_cost_multiplier(
                [by_uid[u] for u in uids if u in by_uid])
            score = (cost + self.disruption_weight * disruption
                     + aged) * coop
            scored.append((score, gid, uids, cost, disruption))
        scored.sort(key=lambda t: (t[0], t[1]))
        faults.fault_point("recovery.plan")
        active = len(records)
        for score, gid, uids, cost, disruption in scored:
            if active + len(uids) > self.max_concurrent and active > 0:
                logger.info(
                    "deferring eviction group %s (%d claims, score "
                    "%.1f): %d eviction(s) already in flight", gid,
                    len(uids), score, active)
                continue
            for uid in uids:
                claim = by_uid.get(uid)
                if claim is None:
                    continue
                self._declare_failure(claim, new[uid])
                self._write_record(
                    claim, EVICTION_PLANNED, source=new[uid],
                    score=score, cost=cost, disruption=disruption)
                active += 1
                counts["planned"] += 1
                if self.metrics is not None:
                    self.metrics.evictions.inc()
                    self.metrics.permanent_failures.labels(
                        new[uid]).inc()
                logger.warning(
                    "eviction planned for claim %s/%s (uid %s, source "
                    "%s, score %.1f: %d device(s) to migrate, %d "
                    "healthy companion(s) disturbed)",
                    _meta(claim).get("namespace", "default"),
                    _meta(claim).get("name"), uid, new[uid], score,
                    cost, disruption)

    def _declare_failure(self, claim: dict, source: str) -> None:
        reason = {"node": "NodeFailed", "device": "DeviceFailed",
                  "gang": "GangCompanionFailed"}.get(source, "Failed")
        self._set_condition(
            claim, "True", reason,
            f"permanent failure declared (source: {source}); claim "
            "queued for eviction and migration")

    def _set_condition(self, claim: dict, status: str, reason: str,
                       message: str) -> None:
        set_permanent_failure_condition(self.kube, claim, status,
                                        reason, message)

    def _write_record(self, claim: dict, state: str, source: str = "",
                      score: float = 0.0, cost: int = 0,
                      disruption: int = 0,
                      prev=None) -> None:
        from ..kubeletplugin.checkpoint import (  # noqa: PLC0415
            CheckpointedClaim,
            CheckpointedDevice,
        )

        uid = _meta(claim).get("uid", "")
        if prev is not None:
            live = dict(prev.devices[0].live or {}) if prev.devices else {}
        else:
            live = {"plannedAt": time.time(), "source": source,
                    "score": score, "cost": cost,
                    "disruption": disruption,
                    "nodes": sorted(allocation_nodes(claim))}
        self._checkpoint.update_claim(uid, CheckpointedClaim(
            uid=uid,
            namespace=_meta(claim).get("namespace", "default"),
            name=_meta(claim).get("name", ""),
            state=state,
            devices=[CheckpointedDevice(
                canonical_name=self._META_DEVICE, kind=self._META_DEVICE,
                live=live)],
        ))
        # One flight-recorder event per durable stage transition: the
        # eviction ladder shows up in /debug/claims/<uid> next to the
        # claim's scheduling and prepare history.
        self.flight.record(
            uid, "eviction",
            alias=(f"{_meta(claim).get('namespace', 'default')}/"
                   f"{_meta(claim).get('name', '')}"),
            state=state, source=live.get("source", ""))

    # -- staged advance -------------------------------------------------------

    @staticmethod
    def _record_meta(rec) -> dict:
        return (rec.devices[0].live or {}) if rec.devices else {}

    def _advance(self, claims: list[dict], failed_nodes: set[str],
                 fatal_devices: set, counts: dict) -> None:
        by_uid = {_meta(c).get("uid", ""): c for c in claims}
        pods = None  # lazily listed, once, only if something drains
        for uid, rec in list(self._checkpoint.get().claims.items()):
            claim = by_uid.get(uid)
            if claim is None or _meta(claim).get("deletionTimestamp"):
                # The claim is gone: whatever stage we were at, the
                # eviction is moot. (A template claim deleted in the
                # drain stage retires here too.)
                self._checkpoint.update_claim(uid, None)
                counts["canceled"] += 1
                continue
            if rec.state == EVICTION_PLANNED:
                if pods is None:
                    pods = self._pods()
                self._drain(uid, rec, claim, pods)
                counts["drained"] += 1
            elif rec.state == EVICTION_DRAINING:
                if self._deallocate(uid, rec, claim):
                    counts["deallocated"] += 1
                else:
                    counts["canceled"] += 1
            elif rec.state == EVICTION_DEALLOCATED:
                self._try_retire(uid, rec, claim, failed_nodes,
                                 fatal_devices, counts)

    def _pods(self) -> list[dict]:
        try:
            if self.view is not None:
                return self.view.pods()
            return self.kube.list("", "v1", "pods")
        except KubeError:
            return []

    def _consumer_pods(self, claim: dict, pods: list[dict]) -> list[dict]:
        return consumer_pods_of(claim, pods)

    def _drain(self, uid: str, rec, claim: dict,
               pods: list[dict]) -> None:
        """Evict BOUND consumer pods (their node is dead, or their gang
        claim is being moved under them) and drop the reservations
        (the shared ``drain_claim`` stage)."""
        faults.fault_point("recovery.drain")
        drain_claim(self.kube, claim, pods)
        self._write_record(claim, EVICTION_DRAINING, prev=rec)

    def _deallocate(self, uid: str, rec, claim: dict) -> bool:
        """Clear the allocation (or GC a template claim whose owner pod
        is gone -- the recreated pod generates a fresh claim); from here
        the incremental scheduler owns re-placement. Returns False when
        the claim was deleted instead of deallocated."""
        faults.fault_point("recovery.dealloc")
        ns = _meta(claim).get("namespace", "default")
        owner_pod = next(
            (o for o in _meta(claim).get("ownerReferences") or []
             if o.get("kind") == "Pod" and o.get("controller")), None)
        if owner_pod is not None and self._pod_gone(
                ns, owner_pod.get("name", "")):
            try:
                self.kube.delete(*RESOURCE, "resourceclaims",
                                 _meta(claim)["name"], namespace=ns)
            except NotFoundError:
                pass
            self._checkpoint.update_claim(uid, None)
            logger.warning(
                "deleted orphaned generated claim %s/%s (uid %s); its "
                "recreated consumer pod generates a fresh claim",
                ns, _meta(claim).get("name"), uid)
            return False
        if not clear_allocation(self.kube, claim):
            return True  # re-examined (and retired) next pass
        self._write_record(claim, EVICTION_DEALLOCATED, prev=rec)
        logger.warning("deallocated failed claim %s/%s (uid %s); "
                       "awaiting re-placement", ns,
                       _meta(claim).get("name"), uid)
        return True

    def _pod_gone(self, ns: str, name: str) -> bool:
        if not name:
            return True
        try:
            self.kube.get("", "v1", "pods", name, namespace=ns)
            return False
        except NotFoundError:
            return True
        except KubeError:
            return False  # unknown: keep the claim, retry next pass

    def _try_retire(self, uid: str, rec, claim: dict,
                    failed_nodes: set[str], fatal_devices: set,
                    counts: dict) -> None:
        alloc = claim.get("status", {}).get("allocation")
        if alloc:
            nodes = allocation_nodes(claim)
            devices = allocation_device_keys(claim)
            if nodes & failed_nodes or devices & fatal_devices:
                # Re-placed straight back onto failed capacity: a
                # scheduler predating the exclusion (or a raced sync).
                # Re-run the eviction from the deallocate stage.
                logger.warning(
                    "claim %s re-placed onto failed capacity; "
                    "re-evicting", uid)
                self._deallocate(uid, rec, claim)
                return
            self._set_condition(
                claim, "False", "Recovered",
                "claim migrated to surviving capacity after a "
                "permanent failure")
            planned_at = float(self._record_meta(rec).get(
                "plannedAt", 0.0))
            self._checkpoint.update_claim(uid, None)
            counts["replaced"] += 1
            if self.metrics is not None:
                self.metrics.replaced.inc()
            if self.slo is not None and planned_at:
                # Eviction e2e: plan -> re-placement, the recovery
                # controller's slice of the claim-SLO histogram.
                self.slo.observe(
                    "evict", max(time.time() - planned_at, 0.0),
                    tracing.trace_id_of(
                        _meta(claim).get("annotations") or {}))
            self.flight.record(uid, "eviction", state="Recovered",
                               nodes=sorted(allocation_nodes(claim)))
            logger.warning("claim %s recovered: re-placed on %s", uid,
                           sorted(allocation_nodes(claim)))
            return
        planned_at = float(self._record_meta(rec).get("plannedAt", 0.0))
        if planned_at and time.time() - planned_at > self.deadline_s:
            self._set_condition(
                claim, "True", "RecoveryDeadlineExceeded",
                f"no surviving capacity re-placed this claim within "
                f"{self.deadline_s:.0f}s; eviction retired cleanly "
                "(the claim remains pending and schedulable)")
            self._checkpoint.update_claim(uid, None)
            counts["failed"] += 1
            if self.metrics is not None:
                self.metrics.failed.inc()
            self.flight.record(uid, "eviction",
                               state="DeadlineExceeded")
            # Eviction failure: dump the claim's whole flight-recorder
            # timeline so the operator sees the ladder (plan -> drain
            # -> deallocate -> the wait that never converged) in one
            # log block instead of reconstructing it by hand.
            logger.error(
                "claim %s failed recovery: deadline exceeded with no "
                "re-placement; flight record:\n%s", uid,
                self.flight.dump(uid))
            # Incident bundle (TPU_DRA_DOCTOR_DIR-gated, rate-limited): a
            # blown deadline means capacity or control-plane trouble, so
            # snapshot the rings now.
            doctor.auto_bundle("eviction-deadline", claim=uid)
