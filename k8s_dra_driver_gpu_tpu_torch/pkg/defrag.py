"""Active defragmentation: the frag-drift-triggered migration
controller that converges churned fleets back to large free sub-tori
(the JAX package's ``pkg/defrag.py``, the port's copy).

The placement engine (pkg/topology + scheduler ordering) only
*prevents* fragmentation at allocation time; under sustained claim
churn the fleet still decays until large gangs pend behind scattered
free chips. This module closes the loop: it watches the per-pool
fragmentation time-series the FleetAggregator already keeps
(pkg/fleetstate), and when a pool's ``fragmentation_score`` crosses
``TPU_DRA_DEFRAG_TRIGGER`` -- with a pending large-shape demand signal,
or steadily for ``TPU_DRA_DEFRAG_SUSTAIN_S`` -- it plans claim moves
multi-objectively (the 2502.01909 framing):

- **frag recovered**: the largest-free-shape delta of a simulated
  re-pack (``pkg/topology/sim.plan_repack``) -- the biggest sub-torus
  that can be carved free by relocating squatting claims;
- **migration cost**: chips moved + claim uptime
  (``pkg/recovery.age_cost`` -- young claims move before long-running
  training gangs) -- greedy cheapest-first;
- **gang disruption**: healthy ComputeDomain companions disturbed per
  move, weighted like the eviction planner's disruption term.

Execution reuses the eviction pipeline stage for stage: drain (evict
bound consumer pods, drop reservations) -> deallocate -> the
scheduler re-places, steered by a ``resource.tpu.dra/defrag-target``
placement hint honored by the fit's ordering while the controller's
device reservations veto every OTHER claim off the carve and the move
targets. Each move is one durable record under the ``defrag``
TransitionPolicy (pkg/statemachine), so a controller crash at any fault
point (``defrag.sync``/``plan``/``drain``/``dealloc``) resumes
idempotently.

Priority classes fall out of the same plan/execute machinery: a claim
annotated ``resource.tpu.dra/priority`` is only ever displaced on
behalf of STRICTLY higher-priority pending demand, and claims
annotated ``resource.tpu.dra/defrag-opt-out`` are never moved at all.

The model is the pool's ICI grid (``TorusGrid.from_devices``): a pool
whose devices publish no ``iciX``/``iciY`` -- the port's own GPU slices
-- has none, and defrag plans nothing there, as the JAX controller
would on such slices.

Operator surface: pausing via ``TPU_DRA_DEFRAG_PAUSE``,
``tpu_dra_defrag_*`` metrics (pkg/metrics.DefragMetrics), per-move
flight-recorder entries. The scheduler runs it polled, every pass after
the fleet fold (``DraScheduler.attach_defrag``).
"""

from __future__ import annotations

import logging
import threading
import time

from . import faults, flightrecorder, positive_float_env
from .kubeclient import ConflictError, KubeError, NotFoundError
from .recovery import (
    AGE_WEIGHT,
    DISRUPTION_WEIGHT,
    age_cost,
    allocation_nodes,
    claim_gang_id,
    clear_allocation,
    coop_cost_multiplier,
    drain_claim,
)
from .statemachine import (
    DEFRAG_DEALLOCATED,
    DEFRAG_DRAINING,
    DEFRAG_PLANNED,
    DEFRAG_POLICY,
)
from .topology import TorusGrid
from .topology.score import largest_free_shape
from .topology.sim import plan_repack

logger = logging.getLogger(__name__)

RESOURCE = ("resource.k8s.io", "v1")

#: Placement hint the controller stamps on a moving claim:
#: ``<node>|<dev1>,<dev2>``. The scheduler's ``_fit_on_node`` orders
#: the hinted devices first (and ``_candidate_nodes`` probes the
#: hinted node first) -- pure preference, never a constraint, so a
#: stale hint can only cost placement quality.
DEFRAG_TARGET_ANNOTATION = "resource.tpu.dra/defrag-target"
#: Claims carrying this annotation (any value but "false") are
#: protected: the planner never selects them as move victims.
OPT_OUT_ANNOTATION = "resource.tpu.dra/defrag-opt-out"
#: Integer priority class. An annotated claim is only displaced on
#: behalf of pending demand with STRICTLY higher priority; an
#: unannotated claim belongs to the default (freely movable) tier.
PRIORITY_ANNOTATION = "resource.tpu.dra/priority"

# Operator knobs.
DEFRAG_TRIGGER = positive_float_env(
    "TPU_DRA_DEFRAG_TRIGGER", default=0.25, floor=0.0)
#: Hysteresis release: a triggered pool stays a defrag target until
#: its frag falls back here (must be < trigger to actually hysterese).
DEFRAG_RELEASE = positive_float_env(
    "TPU_DRA_DEFRAG_RELEASE", default=0.15, floor=0.0)
DEFRAG_SUSTAIN_S = positive_float_env(
    "TPU_DRA_DEFRAG_SUSTAIN_S", default=120.0, floor=0.0)
DEFRAG_MAX_CONCURRENT = int(positive_float_env(
    "TPU_DRA_DEFRAG_MAX_CONCURRENT", default=2, floor=1))
DEFRAG_DEADLINE_S = positive_float_env(
    "TPU_DRA_DEFRAG_DEADLINE_S", default=300.0, floor=0.01)
#: Per-window migration budget: at most this percentage of a pool's
#: LIVE claims may be planned into one defrag window.
DEFRAG_BUDGET_PCT = positive_float_env(
    "TPU_DRA_DEFRAG_BUDGET_PCT", default=15.0, floor=0.0)
#: Quiet period after a window completes before the pool is
#: re-planned (lets the fleet rings catch up with the moves).
DEFRAG_COOLDOWN_S = positive_float_env(
    "TPU_DRA_DEFRAG_COOLDOWN_S", default=60.0, floor=0.0)
#: Pause switch: "1"/"true" stops NEW plan windows; in-flight moves
#: still advance to completion (never park a half-moved claim).
PAUSE_ENV = "TPU_DRA_DEFRAG_PAUSE"


def _meta(obj: dict) -> dict:
    return obj.get("metadata", {})


def claim_priority(claim: dict) -> int | None:
    """The claim's priority class, or None when unannotated (the
    default, freely-movable tier). A malformed annotation fails
    CLOSED: the user clearly meant to protect the claim, so it gets
    an unbeatable priority instead of silently demoting to the
    movable tier."""
    raw = (_meta(claim).get("annotations") or {}).get(
        PRIORITY_ANNOTATION)
    if raw is None:
        return None
    try:
        return int(raw)
    except (TypeError, ValueError):
        logger.warning(
            "claim %s/%s: unparseable %s annotation %r; treating the "
            "claim as unmovable",
            _meta(claim).get("namespace", "default"),
            _meta(claim).get("name"), PRIORITY_ANNOTATION, raw)
        import sys  # noqa: PLC0415 - cold error path

        return sys.maxsize


def demand_priority_of(claim: dict) -> int:
    """Priority a PENDING claim wields as preemption power. The
    asymmetric twin of :func:`claim_priority`: here a malformed
    annotation fails closed to ZERO power (a typo must never let a
    pending claim displace protected workloads), while on the victim
    side the same typo fails closed to unmovable."""
    raw = (_meta(claim).get("annotations") or {}).get(
        PRIORITY_ANNOTATION)
    try:
        return int(raw) if raw is not None else 0
    except (TypeError, ValueError):
        return 0


def claim_opted_out(claim: dict) -> bool:
    raw = (_meta(claim).get("annotations") or {}).get(
        OPT_OUT_ANNOTATION)
    return raw is not None and raw not in ("false", "False", "0")


def claim_device_demand(claim: dict) -> int:
    """Chips one claim requests (All-mode counts 1) -- the pending
    large-shape demand signal's magnitude."""
    total = 0
    for req in claim.get("spec", {}).get("devices", {}).get(
            "requests", []):
        exactly = req.get("exactly") or req
        if exactly.get("allocationMode", "ExactCount") == "All":
            total += 1
        else:
            try:
                total += max(int(exactly.get("count", 1)), 1)
            except (TypeError, ValueError):
                total += 1
    return max(total, 1)


def parse_target_hint(value: str) -> tuple[str, list[str]] | None:
    """``"node-3|chip-1,chip-2"`` -> ("node-3", ["chip-1", "chip-2"]);
    None for anything malformed."""
    if not value or "|" not in value:
        return None
    node, _, names = value.partition("|")
    devices = [n for n in names.split(",") if n]
    if not node or not devices:
        return None
    return node, devices


class DefragController:
    """Plans and drives frag-recovery claim migrations; designed to
    run inside the scheduler's pass (``attach_defrag``) or be driven
    directly (``sync_once``)."""

    #: Meta device name carrying a move record's plan payload in its
    #: ``live`` dict (target devices, carve devices, window id, gain).
    _META_DEVICE = "defrag"

    def __init__(self, kube, root: str, fleet=None, metrics=None,
                 trigger: float = DEFRAG_TRIGGER,
                 release: float = DEFRAG_RELEASE,
                 sustain_s: float = DEFRAG_SUSTAIN_S,
                 max_concurrent: int = DEFRAG_MAX_CONCURRENT,
                 deadline_s: float = DEFRAG_DEADLINE_S,
                 budget_pct: float = DEFRAG_BUDGET_PCT,
                 cooldown_s: float = DEFRAG_COOLDOWN_S,
                 disruption_weight: float = DISRUPTION_WEIGHT,
                 age_weight: float = AGE_WEIGHT):
        # Function-local import like pkg/recovery: pkg -> kubeletplugin
        # stays a one-way street for non-driver users of pkg.
        from ..kubeletplugin.checkpoint import (  # noqa: PLC0415
            CheckpointManager,
        )

        self.kube = kube
        self.fleet = fleet  # pkg/fleetstate.FleetAggregator | None
        self.metrics = metrics  # pkg.metrics.DefragMetrics | None
        self.trigger = trigger
        self.release = min(release, trigger)
        self.sustain_s = sustain_s
        self.max_concurrent = max(1, int(max_concurrent))
        self.deadline_s = deadline_s
        self.budget_pct = budget_pct
        self.cooldown_s = cooldown_s
        self.disruption_weight = disruption_weight
        self.age_weight = age_weight
        # Durable move records under the defrag TransitionPolicy: the
        # idempotent-resume anchor (see module docstring).
        self._checkpoint = CheckpointManager(
            root, transition_policy=DEFRAG_POLICY)
        self._lock = threading.Lock()
        # Device reservations derived from the durable records: device
        # key -> moving claim uid (its planned target), or None (a
        # carve cell held free for the forming shape). The scheduler's
        # fit vetoes every OTHER claim off these devices.
        self._reservations: dict[tuple[str, str, str],
                                 str | None] = {}
        # (driver, pool) -> wall clock before which no new window may
        # be planned there (post-window cooldown).
        self._cooldown_until: dict[tuple[str, str], float] = {}
        # Windows with at least one aborted move: their projected gain
        # was not fully realized, so window close skips the
        # frag-recovered credit (the next pass re-measures reality).
        self._aborted_windows: set[str] = set()
        # Optional read surface (pkg/schedcache.ClusterView), set by
        # attach_defrag: the reads share the pass's lists.
        self.view = None
        self.flight = flightrecorder.default()
        self.last_sync: dict = {}
        with self._lock:
            self._rebuild_reservations_locked()
            self._active_count = len(self._checkpoint.get().claims)

    # -- scheduler surface ----------------------------------------------------

    def busy(self) -> bool:
        """True while any move record is in flight (the JAX
        scheduler's event mode gates per-claim-event defrag passes on
        this; the polled pass runs one every pass)."""
        with self._lock:
            return self._active_count > 0

    def active_moves(self) -> dict[str, str]:
        """uid -> move state of every in-flight record."""
        return {uid: rec.state
                for uid, rec in self._checkpoint.get().claims.items()}

    def reservations(self) -> dict[tuple[str, str, str], str | None]:
        """Device key -> reserved-for uid (None = carve cell, held
        free for the forming shape). Cheap cached read for the
        scheduler's per-claim fit."""
        with self._lock:
            return self._reservations

    @staticmethod
    def paused() -> bool:
        import os  # noqa: PLC0415 - env read on a cold path

        return os.environ.get(PAUSE_ENV, "") in ("1", "true", "True")

    # -- reads ----------------------------------------------------------------

    def _list_slices(self) -> list[dict]:
        if self.view is not None:
            return self.view.slices()
        return self.kube.list(*RESOURCE, "resourceslices")

    def _list_claims(self) -> list[dict]:
        if self.view is not None:
            return self.view.claims()
        return self.kube.list(*RESOURCE, "resourceclaims")

    def _pods(self) -> list[dict]:
        try:
            if self.view is not None:
                return self.view.pods()
            return self.kube.list("", "v1", "pods")
        except KubeError:
            return []

    # -- sync -----------------------------------------------------------------

    def sync_once(self) -> dict:
        """One advance -> detect -> plan pass. Every stage is
        idempotent; a crash anywhere resumes from the durable
        records."""
        faults.fault_point("defrag.sync")
        counts = {"advanced": 0, "completed": 0, "aborted": 0,
                  "planned": 0, "windows": 0}
        try:
            claims = self._list_claims()
            slices = self._list_slices()
        except KubeError:
            logger.warning("defrag sync: inventory list failed; "
                           "retrying next pass")
            return counts
        self._advance(claims, counts)
        if not self.paused():
            self._detect_and_plan(claims, slices, counts)
        active = len(self._checkpoint.get().claims)
        with self._lock:
            self._active_count = active
        if self.metrics is not None:
            self.metrics.active_moves.set(active)
        self.last_sync = counts
        return counts

    # -- trigger + planning ---------------------------------------------------

    def _detect_and_plan(self, claims: list[dict], slices: list[dict],
                         counts: dict) -> None:
        if self.fleet is None:
            return
        if self._checkpoint.get().claims:
            return  # one window at a time: finish the moves first
        pending = [c for c in claims
                   if not c.get("status", {}).get("allocation")
                   and not _meta(c).get("deletionTimestamp")]
        signal = self.fleet.frag_signal(
            self.trigger, self.release, self.sustain_s,
            demand=self._demand_pools(pending))
        now = time.time()
        fired = [(key, sig) for key, sig in signal.items()
                 if sig["fire"]
                 and now >= self._cooldown_until.get(key, 0.0)]
        # Worst pool first: one window at a time keeps the blast
        # radius (and the reservation set) small and inspectable.
        fired.sort(key=lambda t: (-t[1]["fragmentation_score"], t[0]))
        for key, sig in fired:
            if self._plan_pool(key, claims, slices, pending, counts):
                counts["windows"] += 1
                break
            # No feasible carve (everything protected, or no gain
            # inside the budget): cool the pool down rather than
            # re-running the full what-if sweep every pass until its
            # occupancy actually changes.
            self._cooldown_until[key] = now + self.cooldown_s

    def _demand_pools(self, pending: list[dict]) -> set:
        """Pools whose pending demand cannot fit their largest free
        shape RIGHT NOW (the fire-immediately signal). Pending claims
        are not pool-bound, so unsatisfiable demand lights up every
        armed pool -- whichever defragments first absorbs it."""
        if self.fleet is None or not pending:
            return set()
        demand = max((claim_device_demand(c) for c in pending),
                     default=0)
        out = set()
        snap = self.fleet.snapshot()
        for label, entry in (snap.get("pools") or {}).items():
            point = entry.get("current") or {}
            largest = point.get("largest_free_shape")
            if largest is not None and demand > largest:
                driver, _, pool = label.partition("/")
                out.add((driver, pool))
        return out

    def _demand_priority(self, pending: list[dict],
                         largest_chips: int) -> int | None:
        """Highest priority among pending claims too big for the
        pool's current largest free shape; None when no such demand
        (a sustained-frag window acts for fleet health, not on any
        claim's behalf)."""
        prios = [demand_priority_of(c) for c in pending
                 if claim_device_demand(c) > largest_chips]
        return max(prios) if prios else None

    def _pool_model(self, key: tuple[str, str], slices: list[dict],
                    claims: list[dict]):
        """Grid + occupancy of one pool: (grid, free cells, claim uid
        -> cells, uid -> claim, coord -> node, coord -> device name).
        Claims that cannot be modeled (devices outside the pool,
        uncoordinated devices) still occupy their cells but are never
        movable."""
        driver, pool = key
        mine = [s for s in slices
                if s.get("spec", {}).get("driver") == driver
                and s.get("spec", {}).get("pool", {}).get(
                    "name") == pool]
        if not mine:
            return None
        gen = max(s["spec"].get("pool", {}).get("generation", 0)
                  for s in mine)
        devices, node_of_name = [], {}
        for s in sorted(mine, key=lambda s: _meta(s).get("name", "")):
            spec = s.get("spec", {})
            if spec.get("pool", {}).get("generation", 0) != gen:
                continue
            for dev in spec.get("devices", []) or []:
                devices.append(dev)
                node_of_name[dev.get("name", "")] = spec.get(
                    "nodeName") or ""
        grid = TorusGrid.from_devices(devices)
        if not grid.coords:
            return None
        node_of = {c: node_of_name.get(n, "")
                   for n, c in grid.coords.items()}
        name_of = {c: n for n, c in grid.coords.items()}
        allocations: dict[str, set] = {}
        by_uid: dict[str, dict] = {}
        unmodelable: set[str] = set()
        taken: set = set()
        for claim in claims:
            alloc = claim.get("status", {}).get("allocation")
            uid = _meta(claim).get("uid", "")
            if not alloc or not uid:
                continue
            results = alloc.get("devices", {}).get("results", [])
            cells = set()
            foreign = False
            for r in results:
                if (r.get("driver", ""), r.get("pool", "")) != key:
                    foreign = True
                    continue
                coord = grid.coords.get(r.get("device", ""))
                if coord is None:
                    unmodelable.add(uid)
                else:
                    cells.add(coord)
            if not cells:
                continue
            if foreign or len(cells) != len(results):
                unmodelable.add(uid)
            allocations[uid] = cells
            by_uid[uid] = claim
            taken |= cells
        free = set(node_of) - taken
        return (grid, free, allocations, by_uid, unmodelable, node_of,
                name_of)

    def _plan_pool(self, key: tuple[str, str], claims: list[dict],
                   slices: list[dict], pending: list[dict],
                   counts: dict) -> bool:
        """Simulated re-pack of one triggered pool; admits the
        cheapest feasible carve as a window of durable move records.
        Returns True when a window was planned."""
        faults.fault_point("defrag.plan")
        if self.budget_pct <= 0:
            return False  # budget exhausted/disabled: no new windows
        model = self._pool_model(key, slices, claims)
        if model is None:
            return False
        (grid, free, allocations, by_uid, unmodelable, node_of,
         name_of) = model
        _, largest_now = largest_free_shape(grid, free)
        demand_priority = self._demand_priority(pending, largest_now)
        gangs: dict[str, list[str]] = {}
        for uid, claim in by_uid.items():
            gang = claim_gang_id(claim)
            if gang:
                gangs.setdefault(gang, []).append(uid)

        def movable(uid: str) -> bool:
            claim = by_uid.get(uid)
            if claim is None or uid in unmodelable:
                return False
            if claim_opted_out(claim):
                return False
            prio = claim_priority(claim)
            if prio is None:
                return True  # default tier: movable for fleet health
            # Priority-annotated claims are only displaced on behalf
            # of STRICTLY higher-priority pending demand.
            return demand_priority is not None and \
                demand_priority > prio

        def companions(uid: str) -> int:
            gang = claim_gang_id(by_uid[uid]) if uid in by_uid else None
            return len(gangs.get(gang, [uid])) - 1 if gang else 0

        now = time.time()

        def cost_fn(uids: tuple) -> float:
            chips = sum(len(allocations[u]) for u in uids)
            disruption = sum(companions(u) for u in uids)
            aged = age_cost([by_uid[u] for u in uids],
                            self.age_weight, now=now)
            # Cooperative tier (pkg/migration contract): victims that
            # checkpoint on demand are far cheaper to displace, so the
            # repack prefers them over cold-restart claims of equal
            # size and age.
            coop = coop_cost_multiplier([by_uid[u] for u in uids])
            return (chips + self.disruption_weight * disruption
                    + aged) * coop

        budget = max(1, int(len(allocations) * self.budget_pct / 100))
        plan = plan_repack(grid, free, allocations, movable=movable,
                           cost_fn=cost_fn, max_moves=budget,
                           node_of=node_of)
        if plan is None or plan.chips_after <= plan.chips_before:
            return False
        driver, pool = key
        window = f"{driver}/{pool}@{int(now * 1000)}"
        carve = sorted(name_of[c] for c in plan.goal_cells
                       if c in name_of)
        gain = plan.chips_after - plan.chips_before
        logger.warning(
            "defrag window %s: carving %s (%d chips, largest free "
            "%d -> %d) by moving %d claim(s) [budget %d of %d live]",
            window, "x".join(map(str, plan.goal_shape)),
            len(plan.goal_cells), plan.chips_before, plan.chips_after,
            len(plan.moves), budget, len(allocations))
        for move in plan.moves:
            target_names = [name_of[c] for c in move.target
                            if c in name_of]
            target_nodes = {node_of.get(c, "") for c in move.target}
            self._write_record(
                by_uid[move.claim], DEFRAG_PLANNED, live={
                    "plannedAt": now,
                    "window": window,
                    "driver": driver,
                    "pool": pool,
                    "node": next(iter(target_nodes), ""),
                    "target": sorted(target_names),
                    "carve": carve,
                    "gain": gain,
                    "cost": round(cost_fn((move.claim,)), 3),
                })
            counts["planned"] += 1
        with self._lock:
            self._active_count = max(self._active_count, 1)
            self._rebuild_reservations_locked()
        if self.metrics is not None:
            self.metrics.plans.inc()
        return True

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
            uid, "defrag",
            alias=(f"{_meta(claim).get('namespace', 'default')}/"
                   f"{_meta(claim).get('name', '')}"),
            state=state, window=(live or {}).get("window", ""))

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
        predecessor held."""
        out: dict[tuple[str, str, str], str | None] = {}
        for uid, rec in self._checkpoint.get().claims.items():
            meta = self._record_meta(rec)
            driver = meta.get("driver", "")
            pool = meta.get("pool", "")
            for name in meta.get("carve") or []:
                out.setdefault((driver, pool, name), None)
            for name in meta.get("target") or []:
                out[(driver, pool, name)] = uid
        self._reservations = out

    # -- staged advance -------------------------------------------------------

    def _advance(self, claims: list[dict], counts: dict) -> None:
        records = self._checkpoint.get().claims
        if not records:
            return
        by_uid = {_meta(c).get("uid", ""): c for c in claims}
        pods = None
        in_flight = sum(1 for rec in records.values()
                        if rec.state != DEFRAG_PLANNED)
        # Cheapest-first admission under the concurrency cap; records
        # beyond the cap stay durably Planned (their reservations
        # already protect the carve).
        ordered = sorted(
            records.items(),
            key=lambda kv: (self._record_meta(kv[1]).get("cost", 0.0),
                            kv[0]))
        now = time.time()
        for uid, rec in ordered:
            claim = by_uid.get(uid)
            if claim is None or _meta(claim).get("deletionTimestamp"):
                # The claim is gone: the move is moot.
                self._abort(uid, rec, claim, counts, reason="gone")
                continue
            # Deadline applies to EVERY stage, or a record wedged in
            # Planned/Draining (e.g. a perpetually conflicting patch)
            # would pin its reservations -- and block new windows --
            # forever. Planned records time out on the window's plan
            # clock (nothing was disrupted yet, so the abort is
            # free); admitted records on their admission clock.
            meta = self._record_meta(rec)
            clock = float(meta.get("startedAt")
                          or meta.get("plannedAt", 0.0))
            if clock and now - clock > self.deadline_s:
                self._abort(uid, rec, claim, counts,
                            reason="deadline")
                continue
            if rec.state == DEFRAG_PLANNED:
                if in_flight >= self.max_concurrent:
                    continue
                if pods is None:
                    pods = self._pods()
                if self._drain(uid, rec, claim, pods):
                    in_flight += 1
                    counts["advanced"] += 1
            elif rec.state == DEFRAG_DRAINING:
                self._deallocate(uid, rec, claim)
                counts["advanced"] += 1
            elif rec.state == DEFRAG_DEALLOCATED:
                self._try_retire(uid, rec, claim, counts)

    def _drain(self, uid: str, rec, claim: dict,
               pods: list[dict]) -> bool:
        """Stamp the placement hint, then the shared drain stage.
        Returns False when nothing was admitted (the hint patch was
        refused), so the caller's concurrency slot stays free."""
        faults.fault_point("defrag.drain")
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
            return False  # re-examined next pass
        drain_claim(self.kube, claim, pods)
        # The move-deadline clock starts at ADMISSION, not plan time:
        # a move queued behind max_concurrent must get its full
        # re-placement budget once drained, or a slow window's tail
        # would be disrupted only to abort immediately.
        meta.setdefault("startedAt", time.time())
        self._write_record(claim, DEFRAG_DRAINING, live=meta)
        return True

    def _deallocate(self, uid: str, rec, claim: dict) -> None:
        faults.fault_point("defrag.dealloc")
        if not clear_allocation(self.kube, claim):
            return  # re-examined next pass
        self._write_record(claim, DEFRAG_DEALLOCATED, prev=rec)
        logger.warning(
            "defrag: deallocated claim %s/%s (uid %s); awaiting "
            "re-placement onto %s",
            _meta(claim).get("namespace", "default"),
            _meta(claim).get("name"), uid,
            self._record_meta(rec).get("target"))

    def _try_retire(self, uid: str, rec, claim: dict,
                    counts: dict) -> None:
        meta = self._record_meta(rec)
        if claim.get("status", {}).get("allocation"):
            self._clear_hint(claim)
            self._retire_record(uid)
            counts["completed"] += 1
            planned_at = float(meta.get("plannedAt", 0.0))
            if self.metrics is not None:
                self.metrics.moves.inc()
                if planned_at:
                    self.metrics.move_seconds.observe(
                        max(time.time() - planned_at, 0.0))
            self.flight.record(uid, "defrag", state="Moved",
                               nodes=sorted(allocation_nodes(claim)))
            logger.warning("defrag: claim %s re-placed on %s", uid,
                           sorted(allocation_nodes(claim)))
            self._maybe_close_window(meta, counts)
        # Not yet re-placed: the caller's per-record deadline check
        # (top of _advance) aborts the move when the budget runs out.

    def _abort(self, uid: str, rec, claim: dict | None, counts: dict,
               reason: str) -> None:
        """Abandon a move cleanly: the claim (if it still exists)
        stays pending and schedulable with its hint cleared -- never
        parked mid-move."""
        if claim is not None:
            self._clear_hint(claim)
        meta = self._record_meta(rec)
        self._retire_record(uid)
        counts["aborted"] += 1
        if self.metrics is not None:
            self.metrics.aborted.inc()
        self.flight.record(uid, "defrag", state="Aborted",
                           reason=reason)
        logger.warning("defrag: move of claim %s aborted (%s)", uid,
                       reason)
        # An aborted window still cools the pool down -- re-planning
        # immediately would replay the same failure -- and forfeits
        # its frag-recovered credit (the carve did not fully form).
        self._aborted_windows.add(meta.get("window", ""))
        self._cooldown_until[(meta.get("driver", ""),
                              meta.get("pool", ""))] = \
            time.time() + self.cooldown_s
        # If this was the window's LAST record, close it here too --
        # the completed path's close never runs for a window whose
        # final move aborts, and the aborted-window marker must not
        # accumulate forever.
        self._maybe_close_window(meta, counts)

    def _clear_hint(self, claim: dict) -> None:
        # Unconditional idempotent merge-null: gating on the cached
        # claim copy could skip the clear when the informer view lags
        # our own _drain patch, leaving a stale hint to reorder every
        # future re-placement of this claim.
        try:
            self.kube.patch(
                *RESOURCE, "resourceclaims", _meta(claim)["name"],
                {"metadata": {"annotations": {
                    DEFRAG_TARGET_ANNOTATION: None}}},
                namespace=_meta(claim).get("namespace", "default"))
        except (NotFoundError, ConflictError):
            pass

    def _maybe_close_window(self, meta: dict, counts: dict) -> None:
        """The LAST move of a window retiring closes the window:
        credit the frag-recovered counter once and start the pool's
        cooldown."""
        window = meta.get("window", "")
        still_open = any(
            self._record_meta(rec).get("window") == window
            for rec in self._checkpoint.get().claims.values())
        if still_open:
            return
        key = (meta.get("driver", ""), meta.get("pool", ""))
        self._cooldown_until[key] = time.time() + self.cooldown_s
        gain = int(meta.get("gain", 0) or 0)
        if window in self._aborted_windows:
            self._aborted_windows.discard(window)
            gain = 0  # partially-executed carve: no credit claimed
        if self.metrics is not None and gain > 0:
            self.metrics.frag_recovered.inc(gain)
        logger.warning(
            "defrag window %s complete: %d chip(s) of largest-free-"
            "shape recovered in pool %s/%s", window, gain, *key)
