"""Cooperative live migration: checkpoint-then-switch claim moves (the
JAX package's ``pkg/migration.py``, the port's copy).

Every other migration (permanent-failure recovery, pkg/recovery; active
defrag, pkg/defrag) is evict -> re-place -> cold restart: correct, but
maximally disruptive -- the workload loses everything since its last
self-managed checkpoint and the gang pays a full cold rendezvous. This
controller adds the cooperative tier of the 2502.01909 migration-cost
model: when the WORKLOAD declares it can checkpoint on demand
(``resource.tpu.dra/migration-capable`` on the claim), a move becomes a
four-stage handshake with seconds of downtime instead of minutes:

1. **Reserve** -- the destination window is chosen and reserved FIRST,
   reusing the defrag reservation-veto machinery: the scheduler fits
   every other claim around the reserved devices, so the destination
   cannot be stolen while the workload checkpoints.
2. **Signal** -- the ``resource.tpu.dra/migration-intent`` annotation
   is stamped on the claim. The workload knows to watch for it via the
   CDI env contract every prepared container carries
   (``TPU_DRA_MIGRATION_INTENT_ANNOTATION`` /
   ``TPU_DRA_MIGRATION_ACK_ANNOTATION``, kubeletplugin/cdi.py), and
   each stage lands in the claim's flight-recorder timeline.
3. **Ack** -- the workload checkpoints (the port's trainer uses
   ``train/checkpoint.py``'s TrainCheckpointer; ``train/cooperative.py``
   is its side of the contract) and writes the
   ``resource.tpu.dra/migration-ack`` annotation. No ack within
   ``TPU_DRA_MIGRATION_ACK_S`` is an ack timeout; an ack of
   ``failed`` declares a checkpoint failure.
4. **Switch** -- only now does the gang drain (the shared
   ``pkg/recovery.drain_claim`` stage), the allocation clear, and the
   scheduler re-place the claim onto the reserved window (steered by
   the same ``resource.tpu.dra/defrag-target`` hint defrag uses). The
   workload restores warm from its own checkpoint; a CD gang's
   rendezvous re-forms on the new window because every member switches
   behind the same all-acked barrier.

Progress is durable: one record per in-flight move in a
CheckpointManager under the ``migration`` TransitionPolicy
(pkg/statemachine) -- absent -> MigrationDestReserved ->
MigrationIntentSignaled -> MigrationWorkloadAcked -> MigrationSwitching
-> absent -- so a controller crash at any fault seam
(``migration.sync`` / ``reserve`` / ``signal`` / ``switch``) resumes
idempotently from the durable stage.

**The guaranteed cold path.** EVERY failure mode degrades to the cold
eviction semantics of pkg/recovery, never a stuck claim: ack timeout,
checkpoint failure, destination lost mid-handshake, racing claim
delete, controller crash. Fallback releases the reservation, clears
the contract annotations, and (when the claim still holds its old
allocation) drains and deallocates it cold -- the scheduler re-places
it anywhere, exactly as if the recovery controller had evicted it.

Operator surface: pausing via ``TPU_DRA_MIGRATION_PAUSE``,
``tpu_dra_migration_*`` metrics (pkg/metrics.MigrationMetrics),
per-move flight-recorder entries. The scheduler runs it polled, every
pass after recovery and before allocation
(``DraScheduler.attach_migration``).
"""

from __future__ import annotations

import logging
import threading
import time

from . import faults, flightrecorder, positive_float_env
from .defrag import DEFRAG_TARGET_ANNOTATION
from .kubeclient import ConflictError, KubeError, NotFoundError
from .recovery import (
    allocation_device_keys,
    allocation_nodes,
    claim_gang_id,
    claim_migration_capable,
    clear_allocation,
    drain_claim,
)
from .statemachine import (
    MIGRATION_DEST_RESERVED,
    MIGRATION_INTENT_SIGNALED,
    MIGRATION_POLICY,
    MIGRATION_SWITCHING,
    MIGRATION_WORKLOAD_ACKED,
)

logger = logging.getLogger(__name__)

RESOURCE = ("resource.k8s.io", "v1")

#: Controller -> workload signal: stamped when the destination is
#: reserved, value ``<node>|<dev1>,<dev2>;ack-by=<unix seconds>``. The
#: workload checkpoints and acks; it keeps serving/training until the
#: drain actually lands.
MIGRATION_INTENT_ANNOTATION = "resource.tpu.dra/migration-intent"
#: Workload -> controller ack: any value acknowledges "checkpoint
#: durable, safe to switch" (conventionally the checkpoint id/step);
#: the reserved value ``failed`` declares a checkpoint failure and
#: triggers the immediate cold fallback.
MIGRATION_ACK_ANNOTATION = "resource.tpu.dra/migration-ack"
#: Ack value declaring the workload could NOT checkpoint.
ACK_FAILED = "failed"
#: Node annotation requesting cooperative evacuation: the controller
#: plans moves for every migration-capable claim allocated on an
#: annotated node (the "failing host" drain signal -- softer than the
#: recovery controller's permanent-failure taint).
EVACUATE_ANNOTATION = "resource.tpu.dra/evacuate"

# Operator knobs.
#: Workload ack window: signal -> ack. Expired = ack timeout = cold
#: fallback. Size it to checkpoint time, not restore time.
MIGRATION_ACK_S = positive_float_env(
    "TPU_DRA_MIGRATION_ACK_S", default=60.0, floor=0.01)
#: Whole-move deadline (plan -> re-placed). Expired at ANY stage =
#: cold fallback with the reservation released.
MIGRATION_DEADLINE_S = positive_float_env(
    "TPU_DRA_MIGRATION_DEADLINE_S", default=300.0, floor=0.01)
MIGRATION_MAX_CONCURRENT = int(positive_float_env(
    "TPU_DRA_MIGRATION_MAX_CONCURRENT", default=2, floor=1))
#: Post-fallback quarantine: a claim whose cooperative move just fell
#: back cold is not re-planned for this long, so a persistent cause
#: (workload that never acks, checkpoint that always fails) cannot
#: spin reserve->signal->fallback forever against an evacuating node.
#: In-memory on purpose: a restarted controller may retry immediately
#: (the durable records only promise in-FLIGHT moves survive crashes).
MIGRATION_COOLDOWN_S = positive_float_env(
    "TPU_DRA_MIGRATION_COOLDOWN_S", default=30.0, floor=0.0)
#: Pause switch: "1"/"true" stops NEW moves; in-flight handshakes
#: still advance to completion or fallback (never park a half-moved
#: claim).
PAUSE_ENV = "TPU_DRA_MIGRATION_PAUSE"


def _meta(obj: dict) -> dict:
    return obj.get("metadata", {})


def node_evacuating(node: dict) -> bool:
    raw = (_meta(node).get("annotations") or {}).get(
        EVACUATE_ANNOTATION)
    return raw is not None and raw not in ("false", "False", "0")


def claim_ack(claim: dict) -> str | None:
    return (_meta(claim).get("annotations") or {}).get(
        MIGRATION_ACK_ANNOTATION)


def intent_value(node: str, devices: list[str], ack_by: float) -> str:
    return f"{node}|{','.join(devices)};ack-by={ack_by:.0f}"


class MigrationController:
    """Plans and drives cooperative checkpoint-then-switch moves;
    designed to run inside the scheduler's pass (``attach_migration``)
    or be driven directly (``sync_once``)."""

    #: Meta device name carrying a move record's plan payload in its
    #: ``live`` dict (target node/devices, reason, gang, clocks).
    _META_DEVICE = "migration"

    def __init__(self, kube, root: str, metrics=None,
                 ack_s: float = MIGRATION_ACK_S,
                 deadline_s: float = MIGRATION_DEADLINE_S,
                 max_concurrent: int = MIGRATION_MAX_CONCURRENT,
                 cooldown_s: float = MIGRATION_COOLDOWN_S):
        # Function-local import like pkg/recovery and pkg/defrag: pkg
        # -> kubeletplugin stays a one-way street for non-driver users.
        from ..kubeletplugin.checkpoint import (  # noqa: PLC0415
            CheckpointManager,
        )

        self.kube = kube
        self.metrics = metrics  # pkg.metrics.MigrationMetrics | None
        self.ack_s = ack_s
        self.deadline_s = deadline_s
        self.max_concurrent = max(1, int(max_concurrent))
        self.cooldown_s = max(0.0, float(cooldown_s))
        # uid -> monotonic-ish wall clock of the last cold fallback;
        # see MIGRATION_COOLDOWN_S for why this is NOT durable.
        self._last_fallback: dict[str, float] = {}
        # Durable move records under the migration TransitionPolicy:
        # the idempotent-resume anchor (see module docstring).
        self._checkpoint = CheckpointManager(
            root, transition_policy=MIGRATION_POLICY)
        self._lock = threading.Lock()
        # Device reservations derived from the durable records
        # (destination devices, keyed exactly like defrag's): the
        # scheduler's fit vetoes every OTHER claim off them, so the
        # reserved window survives the whole handshake.
        self._reservations: dict[tuple[str, str, str], str] = {}
        # Explicit move requests (uid -> reason) from operators or
        # other controllers; in-memory on purpose -- an
        # unplanned request lost to a crash was never promised, while
        # every PLANNED move is durable.
        self._requests: dict[str, str] = {}
        # Optional read surface (pkg/schedcache.ClusterView), set by
        # attach_migration: the reads share the pass's lists.
        self.view = None
        self.flight = flightrecorder.default()
        self.last_sync: dict = {}
        with self._lock:
            self._rebuild_reservations_locked()
            self._active_count = len(self._checkpoint.get().claims)

    # -- scheduler surface ----------------------------------------------------

    def busy(self) -> bool:
        """True while any move record is in flight (the scheduler's
        event mode gates per-claim-event migration passes on this; a
        full pass runs one every time)."""
        with self._lock:
            return self._active_count > 0

    def active_moves(self) -> dict[str, str]:
        """uid -> move state of every in-flight record."""
        return {uid: rec.state
                for uid, rec in self._checkpoint.get().claims.items()}

    def reservations(self) -> dict[tuple[str, str, str], str]:
        """Device key -> moving-claim uid for every reserved
        destination device. Cheap cached read for the scheduler's
        per-claim fit (merged with the defrag controller's veto)."""
        with self._lock:
            return self._reservations

    @staticmethod
    def paused() -> bool:
        import os  # noqa: PLC0415 - env read on a cold path

        return os.environ.get(PAUSE_ENV, "") in ("1", "true", "True")

    # -- move requests --------------------------------------------------------

    def request_move(self, uid: str, reason: str = "request") -> None:
        """Queue a cooperative move for one claim (target chosen at
        plan time). Other controllers and operator tooling call this;
        gang expansion happens at plan time so the WHOLE rendezvous
        moves."""
        with self._lock:
            self._requests.setdefault(uid, reason)

    # -- reads ----------------------------------------------------------------

    def _list_claims(self) -> list[dict]:
        if self.view is not None:
            return self.view.claims()
        return self.kube.list(*RESOURCE, "resourceclaims")

    def _list_slices(self) -> list[dict]:
        if self.view is not None:
            return self.view.slices()
        return self.kube.list(*RESOURCE, "resourceslices")

    def _list_nodes(self) -> list[dict]:
        try:
            if self.view is not None:
                return self.view.nodes()
            return self.kube.list("", "v1", "nodes")
        except KubeError:
            return []

    def _pods(self) -> list[dict]:
        try:
            if self.view is not None:
                return self.view.pods()
            return self.kube.list("", "v1", "pods")
        except KubeError:
            return []

    # -- sync -----------------------------------------------------------------

    def sync_once(self) -> dict:
        """One advance -> plan pass. Every stage is idempotent; a
        crash anywhere resumes from the durable records."""
        faults.fault_point("migration.sync")
        counts = {"advanced": 0, "completed": 0, "fallbacks": 0,
                  "planned": 0, "canceled": 0}
        try:
            claims = self._list_claims()
            slices = self._list_slices()
        except KubeError:
            logger.warning("migration sync: inventory list failed; "
                           "retrying next pass")
            return counts
        self._advance(claims, slices, counts)
        if not self.paused():
            self._plan(claims, slices, counts)
        active = len(self._checkpoint.get().claims)
        with self._lock:
            self._active_count = active
        if self.metrics is not None:
            self.metrics.active_moves.set(active)
        self.last_sync = counts
        return counts

    # -- planning -------------------------------------------------------------

    def _evacuation_victims(self, claims: list[dict]) -> dict[str, str]:
        """uid -> reason for migration-capable claims allocated on
        nodes annotated for evacuation."""
        nodes = self._list_nodes()
        evacuating = {_meta(n).get("name", "") for n in nodes
                      if node_evacuating(n)}
        if not evacuating:
            return {}
        out: dict[str, str] = {}
        for claim in claims:
            if not claim.get("status", {}).get("allocation"):
                continue
            if _meta(claim).get("deletionTimestamp"):
                continue
            uid = _meta(claim).get("uid", "")
            if uid and allocation_nodes(claim) & evacuating:
                out[uid] = "evacuate"
        return out

    def _plan(self, claims: list[dict], slices: list[dict],
              counts: dict) -> None:
        """Admit queued requests + evacuation victims as durable
        reserve-first records, expanded to whole gangs, under the
        concurrency cap. A claim with no reservable destination is NOT
        admitted (nothing was disrupted yet, so deferral is free); an
        explicit request for it is dropped with a log."""
        with self._lock:
            wanted = dict(self._requests)
        wanted.update(self._evacuation_victims(claims))
        if not wanted:
            return
        records = self._checkpoint.get().claims
        by_uid = {_meta(c).get("uid", ""): c for c in claims}
        # Gang expansion: a CD rendezvous moves as a unit or not at
        # all -- one member switching alone would strand the ring.
        gangs: dict[str, list[str]] = {}
        for uid, claim in by_uid.items():
            gang = claim_gang_id(claim)
            if gang and claim.get("status", {}).get("allocation"):
                gangs.setdefault(gang, []).append(uid)
        groups: dict[str, tuple[str, list[str]]] = {}
        for uid, reason in wanted.items():
            if uid in records:
                continue
            claim = by_uid.get(uid)
            if claim is None or not claim.get("status", {}).get(
                    "allocation"):
                with self._lock:
                    self._requests.pop(uid, None)
                continue
            gang = claim_gang_id(claim)
            key = gang or f"solo-{uid}"
            members = gangs.get(gang, [uid]) if gang else [uid]
            groups.setdefault(key, (reason, members))
        if not groups:
            return
        active = len(records)
        now = time.time()
        for key, (reason, members) in sorted(groups.items()):
            if any(m in records for m in members):
                continue  # a member is already mid-move
            if any(now - self._last_fallback.get(m, -1e18)
                   < self.cooldown_s for m in members):
                continue  # quarantined after a recent cold fallback
            if active + len(members) > self.max_concurrent and \
                    active > 0:
                continue  # admitted next pass, once slots free up
            if not all(claim_migration_capable(by_uid[m])
                       for m in members if m in by_uid):
                # A gang with ONE cold-only member cannot handshake as
                # a unit: the cooperative tier refuses it (the cold
                # controllers still can).
                self._drop_requests(members, reason,
                                    why="not migration-capable")
                continue
            targets = self._select_targets(
                [by_uid[m] for m in members if m in by_uid],
                slices, claims)
            if targets is None:
                self._drop_requests(members, reason,
                                    why="no reservable destination")
                continue
            faults.fault_point("migration.reserve")
            gang = None if key.startswith("solo-") else key
            for uid in members:
                claim = by_uid.get(uid)
                if claim is None:
                    continue
                node, devices, driver, pool = targets[uid]
                self._write_record(claim, MIGRATION_DEST_RESERVED, live={
                    "plannedAt": now,
                    "reason": reason,
                    "gang": gang or "",
                    "node": node,
                    "target": sorted(devices),
                    "driver": driver,
                    "pool": pool,
                    "sourceNodes": sorted(allocation_nodes(claim)),
                })
                active += 1
                counts["planned"] += 1
                logger.warning(
                    "migration planned for claim %s/%s (uid %s, "
                    "reason %s): destination %s reserved [%s]",
                    _meta(claim).get("namespace", "default"),
                    _meta(claim).get("name"), uid, reason, node,
                    ",".join(sorted(devices)))
            with self._lock:
                for uid in members:
                    self._requests.pop(uid, None)
                self._active_count = max(self._active_count, 1)
                self._rebuild_reservations_locked()
            if self.metrics is not None:
                self.metrics.plans.inc()

    def _drop_requests(self, members: list[str], reason: str,
                       why: str) -> None:
        with self._lock:
            dropped = [m for m in members
                       if self._requests.pop(m, None) is not None]
        if dropped or reason != "evacuate":
            logger.warning(
                "migration: cannot plan cooperative move for %s "
                "(reason %s): %s; claim(s) left to the cold "
                "controllers", members, reason, why)

    def _select_targets(self, group: list[dict], slices: list[dict],
                        claims: list[dict]
                        ) -> dict[str, tuple] | None:
        """Choose a destination (node, devices, driver, pool) for
        every claim in the group, disjoint across the group and free
        of every live allocation and existing reservation. None when
        any member cannot be placed -- the gang reserves as a unit."""
        taken: set[tuple[str, str, str]] = set()
        for c in claims:
            taken |= allocation_device_keys(c)
        with self._lock:
            taken |= set(self._reservations)
        avoid = {n for c in group for n in allocation_nodes(c)}
        free_by_node: dict[tuple[str, str, str], list[str]] = {}
        for s in slices:
            spec = s.get("spec", {})
            node = spec.get("nodeName") or ""
            driver = spec.get("driver", "")
            pool = spec.get("pool", {}).get("name", "")
            if not node or node in avoid:
                continue
            for dev in spec.get("devices", []) or []:
                name = dev.get("name", "")
                if (driver, pool, name) in taken:
                    continue
                free_by_node.setdefault((node, driver, pool),
                                        []).append(name)
        out: dict[str, tuple] = {}
        for claim in group:
            uid = _meta(claim).get("uid", "")
            want = max(len(allocation_device_keys(claim)), 1)
            placed = False
            for (node, driver, pool), names in sorted(
                    free_by_node.items()):
                if len(names) < want:
                    continue
                chosen = sorted(names)[:want]
                free_by_node[(node, driver, pool)] = [
                    n for n in names if n not in chosen]
                out[uid] = (node, chosen, driver, pool)
                placed = True
                break
            if not placed:
                return None
        return out

    # -- durable records ------------------------------------------------------

    def _write_record(self, claim: dict, state: str,
                      live: dict | None = None, prev=None) -> None:
        from ..kubeletplugin.checkpoint import (  # noqa: PLC0415
            CheckpointedClaim,
            CheckpointedDevice,
        )

        uid = _meta(claim).get("uid", "")
        if prev is not None:
            live = dict(prev.devices[0].live or {}) \
                if prev.devices else {}
        self._checkpoint.update_claim(uid, CheckpointedClaim(
            uid=uid,
            namespace=_meta(claim).get("namespace", "default"),
            name=_meta(claim).get("name", ""),
            state=state,
            devices=[CheckpointedDevice(
                canonical_name=self._META_DEVICE,
                kind=self._META_DEVICE, live=live or {})],
        ))
        self.flight.record(
            uid, "migration",
            alias=(f"{_meta(claim).get('namespace', 'default')}/"
                   f"{_meta(claim).get('name', '')}"),
            state=state, node=(live or {}).get("node", ""))

    @staticmethod
    def _record_meta(rec) -> dict:
        return (rec.devices[0].live or {}) if rec.devices else {}

    def _retire_record(self, uid: str) -> None:
        self._checkpoint.update_claim(uid, None)
        with self._lock:
            self._rebuild_reservations_locked()

    def _rebuild_reservations_locked(self) -> None:
        """Reservations are a pure function of the durable records, so
        a restarted controller re-derives exactly the veto set its
        predecessor held -- the destination window survives the
        crash."""
        out: dict[tuple[str, str, str], str] = {}
        for uid, rec in self._checkpoint.get().claims.items():
            meta = self._record_meta(rec)
            driver = meta.get("driver", "")
            pool = meta.get("pool", "")
            for name in meta.get("target") or []:
                out[(driver, pool, name)] = uid
        self._reservations = out

    # -- staged advance -------------------------------------------------------

    def _advance(self, claims: list[dict], slices: list[dict],
                 counts: dict) -> None:
        records = self._checkpoint.get().claims
        if not records:
            return
        by_uid = {_meta(c).get("uid", ""): c for c in claims}
        live_devices: set[tuple[str, str, str]] = set()
        for s in slices:
            spec = s.get("spec", {})
            driver = spec.get("driver", "")
            pool = spec.get("pool", {}).get("name", "")
            for dev in spec.get("devices", []) or []:
                live_devices.add((driver, pool, dev.get("name", "")))
        # Gang ack barrier: a member switches only when EVERY member
        # has acked -- one worker draining before its peers finished
        # checkpointing would corrupt the rendezvous it is part of.
        acked_by_gang: dict[str, int] = {}
        size_by_gang: dict[str, int] = {}
        for uid, rec in records.items():
            gang = self._record_meta(rec).get("gang", "")
            if not gang:
                continue
            size_by_gang[gang] = size_by_gang.get(gang, 0) + 1
            if rec.state in (MIGRATION_WORKLOAD_ACKED,
                             MIGRATION_SWITCHING):
                acked_by_gang[gang] = acked_by_gang.get(gang, 0) + 1
        now = time.time()
        pods = None
        for uid, rec in sorted(records.items()):
            claim = by_uid.get(uid)
            if claim is None or _meta(claim).get("deletionTimestamp"):
                # Racing claim delete: the move is moot; reservation
                # released, nothing to clean on the claim itself.
                self._retire_record(uid)
                counts["canceled"] += 1
                self.flight.record(uid, "migration", state="Canceled",
                                   reason="gone")
                continue
            meta = self._record_meta(rec)
            if now - float(meta.get("plannedAt", 0.0) or now) > \
                    self.deadline_s:
                self._fallback(uid, rec, claim, counts,
                               reason="deadline")
                continue
            if rec.state != MIGRATION_SWITCHING and not all(
                    (meta.get("driver", ""), meta.get("pool", ""), d)
                    in live_devices for d in meta.get("target") or []):
                # Destination lost mid-handshake (node died, slices
                # retired): the reserved window no longer exists.
                self._fallback(uid, rec, claim, counts,
                               reason="destination-lost")
                continue
            if rec.state == MIGRATION_DEST_RESERVED:
                self._signal(uid, rec, claim, counts)
            elif rec.state == MIGRATION_INTENT_SIGNALED:
                ack = claim_ack(claim)
                if ack == ACK_FAILED:
                    self._fallback(uid, rec, claim, counts,
                                   reason="checkpoint-failed")
                elif ack:
                    meta = dict(meta)
                    meta["ackedAt"] = now
                    self._write_record(claim, MIGRATION_WORKLOAD_ACKED,
                                       live=meta)
                    counts["advanced"] += 1
                    gang = meta.get("gang", "")
                    if gang:
                        acked_by_gang[gang] = \
                            acked_by_gang.get(gang, 0) + 1
                    if self.metrics is not None:
                        signaled = float(meta.get("signaledAt",
                                                  0.0) or 0.0)
                        if signaled:
                            self.metrics.ack_seconds.observe(
                                max(now - signaled, 0.0))
                elif now > float(meta.get("ackBy", 0.0) or now):
                    self._fallback(uid, rec, claim, counts,
                                   reason="ack-timeout")
            elif rec.state == MIGRATION_WORKLOAD_ACKED:
                gang = meta.get("gang", "")
                if gang and acked_by_gang.get(gang, 0) < \
                        size_by_gang.get(gang, 0):
                    continue  # barrier: peers still checkpointing
                if pods is None:
                    pods = self._pods()
                self._switch(uid, rec, claim, pods)
                counts["advanced"] += 1
            elif rec.state == MIGRATION_SWITCHING:
                self._try_retire(uid, rec, claim, counts)

    def _signal(self, uid: str, rec, claim: dict,
                counts: dict) -> None:
        """Stamp the migration-intent annotation; the ack clock starts
        at the durable IntentSignaled write, not the patch -- a crash
        between the two re-signals idempotently."""
        faults.fault_point("migration.signal")
        meta = dict(self._record_meta(rec))
        ack_by = time.time() + self.ack_s
        value = intent_value(meta.get("node", ""),
                             meta.get("target") or [], ack_by)
        try:
            self.kube.patch(
                *RESOURCE, "resourceclaims", _meta(claim)["name"],
                {"metadata": {"annotations": {
                    MIGRATION_INTENT_ANNOTATION: value}}},
                namespace=_meta(claim).get("namespace", "default"))
        except (NotFoundError, ConflictError):
            return  # re-signaled next pass
        meta["ackBy"] = ack_by
        meta["signaledAt"] = time.time()
        self._write_record(claim, MIGRATION_INTENT_SIGNALED, live=meta)
        counts["advanced"] += 1

    def _switch(self, uid: str, rec, claim: dict,
                pods: list[dict]) -> None:
        """The point of no return for THIS claim: stamp the placement
        hint, drain, deallocate. The workload's checkpoint is already
        durable (it acked), so the only downtime is drain ->
        re-placement -> warm restore."""
        faults.fault_point("migration.switch")
        meta = dict(self._record_meta(rec))
        hint = f"{meta.get('node', '')}|" + ",".join(
            meta.get("target") or [])
        try:
            self.kube.patch(
                *RESOURCE, "resourceclaims", _meta(claim)["name"],
                {"metadata": {"annotations": {
                    DEFRAG_TARGET_ANNOTATION: hint}}},
                namespace=_meta(claim).get("namespace", "default"))
        except (NotFoundError, ConflictError):
            return  # re-examined next pass
        drain_claim(self.kube, claim, pods)
        if not clear_allocation(self.kube, claim):
            return  # re-examined next pass (record still Acked)
        meta["switchedAt"] = time.time()
        self._write_record(claim, MIGRATION_SWITCHING, live=meta)
        logger.warning(
            "migration: claim %s/%s (uid %s) switched; awaiting "
            "re-placement onto %s",
            _meta(claim).get("namespace", "default"),
            _meta(claim).get("name"), uid, meta.get("node"))

    def _try_retire(self, uid: str, rec, claim: dict,
                    counts: dict) -> None:
        if not claim.get("status", {}).get("allocation"):
            return  # not yet re-placed; deadline check bounds the wait
        meta = self._record_meta(rec)
        self._clear_contract(claim)
        self._retire_record(uid)
        counts["completed"] += 1
        now = time.time()
        if self.metrics is not None:
            self.metrics.coop_moves.inc()
            switched = float(meta.get("switchedAt", 0.0) or 0.0)
            planned = float(meta.get("plannedAt", 0.0) or 0.0)
            if switched:
                self.metrics.switch_seconds.observe(
                    max(now - switched, 0.0))
            if planned:
                self.metrics.move_seconds.observe(
                    max(now - planned, 0.0))
        self.flight.record(uid, "migration", state="Migrated",
                           nodes=sorted(allocation_nodes(claim)))
        logger.warning(
            "migration: claim %s cooperatively re-placed on %s "
            "(downtime: switch -> restore)", uid,
            sorted(allocation_nodes(claim)))

    # -- the guaranteed cold path ---------------------------------------------

    def _fallback(self, uid: str, rec, claim: dict, counts: dict,
                  reason: str) -> None:
        """Degrade to the cold eviction semantics: release the
        reservation, clear the contract annotations, and -- when the
        claim still holds its OLD allocation -- drain and deallocate
        it so the scheduler re-places it anywhere. The claim is never
        stuck: it ends allocated (pre-switch fallback keeps it
        running until the cold drain) or pending-and-schedulable."""
        state = rec.state
        if state in (MIGRATION_WORKLOAD_ACKED, MIGRATION_SWITCHING) \
                or reason in ("deadline",):
            # The workload may already have stopped for the switch:
            # finish the move COLD so it restarts somewhere rather
            # than waiting on a destination that will never form.
            if claim.get("status", {}).get("allocation"):
                drain_claim(self.kube, claim, self._pods())
                clear_allocation(self.kube, claim)
        self._clear_contract(claim)
        self._retire_record(uid)
        self._last_fallback[uid] = time.time()
        counts["fallbacks"] += 1
        if self.metrics is not None:
            self.metrics.fallbacks.labels(reason).inc()
        self.flight.record(uid, "migration", state="FellBack",
                           reason=reason, stage=state or "")
        logger.warning(
            "migration: cooperative move of claim %s fell back to the "
            "cold eviction path (%s, stage %s); reservation released",
            uid, reason, state)

    def _clear_contract(self, claim: dict) -> None:
        """Idempotent merge-null of every annotation the handshake
        stamped (intent, ack, placement hint): a stale contract must
        not re-trigger a workload checkpoint or steer a future
        re-placement."""
        try:
            self.kube.patch(
                *RESOURCE, "resourceclaims", _meta(claim)["name"],
                {"metadata": {"annotations": {
                    MIGRATION_INTENT_ANNOTATION: None,
                    MIGRATION_ACK_ANNOTATION: None,
                    DEFRAG_TARGET_ANNOTATION: None}}},
                namespace=_meta(claim).get("namespace", "default"))
        except (NotFoundError, ConflictError):
            pass
