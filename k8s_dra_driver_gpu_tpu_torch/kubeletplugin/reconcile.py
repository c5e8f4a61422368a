"""The node's reconcile sweep (the JAX package's
``kubeletplugin/reconcile.py``, ``NodeStateReconciler``).

The checkpoint, the API server's claims and the CDI spec files describe
the same claims on a node and must agree. A crash can leave one of them
ahead of or behind the others; the sweep repairs that periodically, in
the JAX order (``reconcile_once``):

1. ``stale_claim``: records whose claim is gone are unprepared (the
   stale-claim GC, ``cleanup.py``);
2. ``moved_claim``: completed records whose live claim holds none of
   this node's devices any more, or is pinned to another node, are
   unprepared;
3. ``cdi_spec``: spec files with no checkpoint record are removed;
4. ``carveout``: MIG instances this plugin created that no checkpointed
   claim references are destroyed, and registry entries whose GPU
   instance is gone are dropped
   (``DeviceState.destroy_unknown_subslices``);
5. ``idle_partition``: partition records no tenant holds are torn down
   (``PartitionEngine.reap_idle``: a partition whose last tenant was
   GC'd rather than unprepared, an orphaned Creating or Destroying
   record), and partition devices a re-plan retired leave the
   allocatable set once their records are gone
   (``DeviceState.prune_retired_partitions``);
6. ``devices_gone``: a completed claim whose GPUs this host no longer
   has gets a ``PermanentFailure`` condition on the API server, so the
   control plane moves it.

The claim lookups are made once a sweep and shared by the passes. The
MIG instance of a claim that moved or was deleted is destroyed by its
unprepare (passes 1 and 2), with the rest of its teardown; pass 4 finds
what a crash left.

The JAX sweep's reservation-lease pass (the upgrade handover's leases,
not ported with ``DeviceState``) has nothing to repair here and reports
0.
``CDStateReconciler`` is the sweep of the ComputeDomain plugin
(``computedomain/plugin``). With ``metrics`` (a
``pkg/metrics.RecoveryMetrics``) both export ``tpu_dra_recovery_*``:
``orphans_repaired_total`` by kind, ``reconcile_drift`` (the last
sweep's counts, 0 on a healthy node), and a devices-gone declaration as
``permanent_failures{source="sweep"}``.
"""

from __future__ import annotations

import logging
import threading

from ..pkg import positive_float_env
from ..pkg.recovery import allocation_nodes, set_permanent_failure_condition
from .checkpoint import ClaimState
from .cleanup import DEFAULT_INTERVAL_S as _CLEANUP_INTERVAL_S
from .cleanup import cleanup_once, lookup_claim

logger = logging.getLogger(__name__)

# The sweep runs the stale-claim GC, so a tightened
# TPU_DRA_CLEANUP_INTERVAL_S tightens the whole sweep too.
SWEEP_INTERVAL_S = min(
    positive_float_env("TPU_DRA_RECOVERY_SWEEP_S", default=120.0,
                       floor=0.05),
    _CLEANUP_INTERVAL_S)


class NodeStateReconciler:
    """Periodic audit of the node's claim state."""

    def __init__(self, device_state, kube, node_name: str, metrics=None,
                 interval: float = SWEEP_INTERVAL_S):
        self._state = device_state
        self._kube = kube
        self._metrics = metrics  # pkg.metrics.RecoveryMetrics | None
        self._interval = interval
        # This node's name (its ResourceSlice pool): device names repeat
        # on every node, so only a node identity tells a claim re-placed
        # elsewhere from one still here.
        self._node = node_name
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="recovery-sweep", daemon=True)
        self.last_sweep: dict = {}

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread.ident is not None:
            self._thread.join(timeout=2.0)

    def _run(self) -> None:
        while not self._stop.wait(self._interval):
            try:
                self.reconcile_once()
            except Exception:  # noqa: BLE001 - sweep must survive
                logger.exception("recovery sweep failed")

    def reconcile_once(self) -> dict:
        """One sweep; the count of repairs and declarations by kind.
        Stale records go first: their unprepare removes their spec, so
        the orphan-spec pass sees only specs that truly have no
        record."""
        counts = {"stale_claim": 0, "moved_claim": 0, "cdi_spec": 0,
                  "carveout": 0, "lease": 0, "devices_gone": 0,
                  "idle_partition": 0}
        lookups = {
            uid: lookup_claim(self._kube, uid, rec.namespace, rec.name)
            for uid, rec in self._state.prepared_claims().items()}
        counts["stale_claim"] = len(
            cleanup_once(self._state, self._kube, lookups=lookups))
        counts["moved_claim"] = self._sweep_moved_claims(
            self._state.prepared_claims(), lookups)
        counts["cdi_spec"] = self._sweep_cdi_specs()
        counts["carveout"] = self._state.destroy_unknown_subslices()
        if self._state.partition_engine is not None:
            counts["idle_partition"] = \
                self._state.partition_engine.reap_idle() + \
                self._state.prune_retired_partitions()
        counts["devices_gone"] = self._declare_gone_devices(
            self._state.prepared_claims(), lookups)
        self._observe(counts)
        if any(counts.values()):
            logger.warning("recovery sweep repaired/declared: %s",
                           {k: v for k, v in counts.items() if v})
        self.last_sweep = counts
        return counts

    def _lookup(self, lookups, uid, rec):
        hit = lookups.get(uid)
        if hit is None:
            hit = lookup_claim(self._kube, uid, rec.namespace, rec.name)
        return hit

    def _sweep_moved_claims(self, claims, lookups) -> int:
        """Unprepare completed records whose live claim no longer holds
        this node's devices (deallocated, or re-placed on another
        node), as a kubelet unprepare would."""
        drained = 0
        for uid, claim in list(claims.items()):
            if claim.state != ClaimState.PREPARE_COMPLETED.value:
                continue
            status, obj = self._lookup(lookups, uid, claim)
            if status != "live":
                continue  # gone: the GC's; unknown: keep
            if self._still_local(obj, claim):
                continue
            try:
                self._state.unprepare(uid)
            except Exception:  # noqa: BLE001 - sweep must survive
                logger.exception("drain unprepare failed for moved claim "
                                 "%s", uid)
                continue
            drained += 1
            logger.warning("unprepared moved claim %s (%s/%s): its "
                           "allocation no longer references this node's "
                           "devices", uid, claim.namespace, claim.name)
        return drained

    def _still_local(self, obj: dict, claim) -> bool:
        alloc = obj.get("status", {}).get("allocation") or {}
        held = {r.get("device", "")
                for r in alloc.get("devices", {}).get("results", [])}
        mine = {d.canonical_name for d in claim.devices}
        if not held & mine:
            return False  # deallocated, or holding other devices
        nodes = allocation_nodes(obj)
        # Pinned here, or no node evidence at all: keep.
        return not nodes or self._node in nodes

    def _sweep_cdi_specs(self) -> int:
        """Remove spec files with no checkpoint record. The records are
        read after the files are listed: a prepare writes its record
        before its spec, so a spec listed here has its record in the
        later read unless it is an orphan."""
        cdi = self._state._cdi
        uids = cdi.list_claim_uids()
        claims = self._state.prepared_claims()
        repaired = 0
        for uid in uids:
            if uid not in claims:
                cdi.delete_claim_spec_file(uid)
                repaired += 1
                logger.warning("destroyed orphan CDI spec for %s", uid)
        return repaired

    def _declare_gone_devices(self, claims, lookups) -> int:
        """Completed claims holding a GPU this host no longer has: the
        node cannot repair missing hardware, only say so on the claim."""
        declared = 0
        allocatable = self._state.allocatable
        for uid, claim in claims.items():
            if claim.state != ClaimState.PREPARE_COMPLETED.value:
                continue
            gone = [d.canonical_name for d in claim.devices
                    if d.canonical_name not in allocatable]
            if not gone:
                continue
            status, obj = self._lookup(lookups, uid, claim)
            if status != "live":
                continue
            if set_permanent_failure_condition(
                    self._kube, obj, "True", "DevicesGone",
                    f"device(s) {sorted(gone)} no longer exist on this "
                    "host; claim needs migration"):
                declared += 1
                if self._metrics is not None:
                    self._metrics.permanent_failures.labels("sweep").inc()
                logger.error("claim %s references vanished device(s) %s: "
                             "declared PermanentFailure", uid, sorted(gone))
        return declared

    def _observe(self, counts: dict) -> None:
        if self._metrics is None:
            return
        for kind in ("stale_claim", "moved_claim", "cdi_spec", "carveout",
                     "lease", "idle_partition"):
            if counts.get(kind):
                self._metrics.orphans_repaired.labels(kind).inc(
                    counts[kind])
        for kind, n in counts.items():
            self._metrics.reconcile_drift.labels(kind).set(n)


class CDStateReconciler:
    """The same audit over the ComputeDomain plugin's single-phase
    records (the JAX package's ``CDStateReconciler``): a record whose
    claim is gone is unprepared (which drops the node label with the last
    channel), and a spec with no record is unwound
    (``CDDeviceState.unwind_failed_prepare``, which drops the label too
    once its domain is positively gone). Its driver runs it from its
    background thread."""

    def __init__(self, cd_state, kube, metrics=None):
        self._state = cd_state
        self._kube = kube
        self._metrics = metrics  # pkg.metrics.RecoveryMetrics | None
        self.last_sweep: dict = {}

    def reconcile_once(self) -> dict:
        counts = {"cd_stale_claim": 0, "cd_cdi_spec": 0}
        for uid, rec in list(self._state.prepared_claims().items()):
            status, _ = lookup_claim(self._kube, uid, rec.namespace,
                                     rec.name)
            if status != "gone":
                continue
            try:
                self._state.unprepare(uid)
            except Exception:  # noqa: BLE001 - sweep must survive
                logger.exception("stale CD claim unprepare failed for %s",
                                 uid)
                continue
            counts["cd_stale_claim"] += 1
            logger.warning("unprepared stale CD claim %s (%s/%s)", uid,
                           rec.namespace, rec.name)
        claims = self._state.prepared_claims()
        for uid in self._state._cdi.list_claim_uids():
            if uid in claims:
                continue
            self._state.unwind_failed_prepare(uid)
            counts["cd_cdi_spec"] += 1
            logger.warning("unwound orphan CD CDI spec for %s", uid)
        if self._metrics is not None:
            for kind, n in counts.items():
                if n:
                    self._metrics.orphans_repaired.labels(kind).inc(n)
                self._metrics.reconcile_drift.labels(kind).set(n)
        self.last_sweep = counts
        return counts
