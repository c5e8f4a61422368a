"""The autoscale controller: continuous demand-driven re-planning of the
PartitionSet CRD (the JAX package's ``pkg/autoscale/controller.py``).

It rides the scheduler's polled pass (``DraScheduler.attach_autoscaler``,
after the fleet fold) or runs directly (``sync_once``). Each pass:

1. **Ingests** the demand the API server declares: the claim annotations
   ``resource.tpu.dra/tenant-demand-hbm`` and ``-cores`` of each claim
   annotated ``resource.tpu.dra/tenant-profile``, into the sliding
   window of a ``TenantProfileStore``, every pass, so live claims keep
   their demand fresh and retired ones age out
   (``TPU_DRA_PROFILE_WINDOW_S``).
2. **Advances** the rollout in flight (Planned -> Applying -> confirmed
   or superseded). Its record is durable (``CheckpointManager`` under
   ``AUTOSCALE_POLICY``) and pins the desired spec, so a crash at any
   fault point (``autoscale.sync``, ``plan``, ``apply``, ``confirm``)
   resumes onto the same plan.
3. **Plans**: the planner runs over the demand percentiles and the
   fleet's pending claims; drift past the hysteresis band writes a
   Planned record and applies it in the same pass (urgent drift at
   once, a repack after ``TPU_DRA_AUTOSCALE_SUSTAIN_S``). A converged
   pass writes nothing.

It owns one CRD (``crd_name``, ``tpu-dra-autoscale``) and one rollout at
a time, waits ``TPU_DRA_AUTOSCALE_COOLDOWN_S`` after each, and plans
nothing while ``TPU_DRA_AUTOSCALE_PAUSE`` is set (a rollout in flight
still completes). An operator who flips
``resource.tpu.dra/autoscale-managed`` to ``"false"`` takes manual
control: the controller plans nothing against that object, and a
rollout in flight retires without stomping the flip; a spec changed
under a rollout supersedes it. With ``TPU_DRA_PREWARM`` on (the default)
and a fleet attached, the forecaster's per-pool hint converges on the
CRD's pre-warm annotation with its per-pool hysteresis.

What differs from the JAX controller: its catalog's profiles are backed
by ``subslice`` (default ``7g.80gb``, the H100 80GB's whole-GPU MIG
profile; ``planner.py``), and the scheduler runs it in the polled pass
only (the event mode's ``partitionsets`` informer and dirty key wait
with ROADMAP.md §1c item 8).
"""

from __future__ import annotations

import json
import logging
import math
import os
import threading
import time

from .. import faults, flightrecorder, positive_float_env
from ..kubeclient import ConflictError, KubeError, NotFoundError
from ..partition.profiles import (TENANT_PROFILE_ANNOTATION,
                                  TenantProfileStore)
from ..partition.spec import PartitionSet, PartitionSpecError
from ..statemachine import (AUTOSCALE_APPLYING, AUTOSCALE_PLANNED,
                            AUTOSCALE_POLICY)
from . import crd
from .forecast import DemandForecaster
from .planner import (TENANT_DEMAND_CORES_ANNOTATION,
                      TENANT_DEMAND_HBM_ANNOTATION, WHOLE_GPU_SUBSLICE,
                      AutoscalePlanner, pool_chip_caps)

logger = logging.getLogger(__name__)

RESOURCE = ("resource.k8s.io", "v1")
CRD = (crd.AUTOSCALE_CRD_GROUP, crd.AUTOSCALE_CRD_VERSION,
       crd.AUTOSCALE_CRD_RESOURCE)

#: A repack (non-urgent drift) must persist this long before it rolls
#: out; urgent drift (upsizes, isolation, a pending tenant) fires now.
AUTOSCALE_SUSTAIN_S = positive_float_env(
    "TPU_DRA_AUTOSCALE_SUSTAIN_S", default=120.0, floor=0.0)
#: The hysteresis band: the headroom below a finer budget a repack
#: needs.
AUTOSCALE_BAND = positive_float_env(
    "TPU_DRA_AUTOSCALE_BAND", default=0.1, floor=0.0)
#: The quiet period after a completed rollout.
AUTOSCALE_COOLDOWN_S = positive_float_env(
    "TPU_DRA_AUTOSCALE_COOLDOWN_S", default=60.0, floor=0.0)
#: "1"/"true" stops new plans; a rollout in flight still completes.
PAUSE_ENV = "TPU_DRA_AUTOSCALE_PAUSE"


def _meta(obj: dict) -> dict:
    return obj.get("metadata", {})


class AutoscaleController:
    """Plans and rolls out PartitionSet re-plans; ``sync_once`` is one
    pass."""

    _META_DEVICE = "autoscale"

    def __init__(self, kube, root: str, store=None, fleet=None,
                 metrics=None, crd_name: str = "tpu-dra-autoscale",
                 percentile: float = 0.95,
                 band: float = AUTOSCALE_BAND,
                 sustain_s: float = AUTOSCALE_SUSTAIN_S,
                 cooldown_s: float = AUTOSCALE_COOLDOWN_S,
                 slot_counts: tuple[int, ...] = (1, 2, 4, 8),
                 subslice: str = WHOLE_GPU_SUBSLICE,
                 pools: tuple[str, ...] = ()):
        # Function-local import as in pkg/recovery and pkg/defrag: pkg
        # -> kubeletplugin stays one way for pkg's other users.
        from ...kubeletplugin.checkpoint import (  # noqa: PLC0415
            CheckpointManager,
        )

        self.kube = kube
        self.store = store if store is not None else TenantProfileStore(
            defaults={})
        self.fleet = fleet  # pkg/fleetstate.FleetAggregator | None
        self.metrics = metrics  # pkg.metrics.AutoscaleMetrics | None
        self.crd_name = crd_name
        self.planner = AutoscalePlanner(
            percentile=percentile, band=band, slot_counts=slot_counts,
            subslice=subslice)
        self.sustain_s = sustain_s
        self.cooldown_s = cooldown_s
        self.pools = tuple(pools)
        # The forecaster's per-pool hint lands as the CRD's pre-warm
        # annotation (advisory: no spec change, no rollout).
        self.forecaster = (DemandForecaster()
                           if os.environ.get("TPU_DRA_PREWARM", "1")
                           not in ("0", "false", "False") else None)
        # Per pool: the wall clock since its forecast read zero while
        # its hint stands; the hint clears after the forecaster's stale
        # window, so a wobbling forecast writes nothing per pass.
        self._prewarm_zero_since: dict[str, float] = {}
        self._checkpoint = CheckpointManager(
            root, transition_policy=AUTOSCALE_POLICY)
        self._lock = threading.Lock()
        self._active_count = len(self._checkpoint.get().claims)
        # The repack's sustain clock: (fingerprint of the drifted spec,
        # first seen); another drift restarts it.
        self._drift_since: tuple[str, float] | None = None
        self._cooldown_until = 0.0
        # The read surface (pkg/schedcache.ClusterView), set by
        # attach_autoscaler.
        self.view = None
        self.flight = flightrecorder.default()
        self.last_sync: dict = {}

    # -- the scheduler's surface ----------------------------------------------

    def busy(self) -> bool:
        """True while a rollout record is in flight."""
        with self._lock:
            return self._active_count > 0

    @staticmethod
    def paused() -> bool:
        return os.environ.get(PAUSE_ENV, "") in ("1", "true", "True")

    # -- reads ----------------------------------------------------------------

    def _list_claims(self) -> list[dict]:
        if self.view is not None:
            return self.view.claims()
        return self.kube.list(*RESOURCE, "resourceclaims")

    def _list_slices(self) -> list[dict]:
        if self.view is not None:
            return self.view.slices()
        return self.kube.list(*RESOURCE, "resourceslices")

    def _list_partition_sets(self) -> list[dict]:
        if self.view is not None:
            return self.view.partition_sets()
        return self.kube.list(*CRD)

    # -- the pass -------------------------------------------------------------

    def sync_once(self) -> dict:
        """One ingest -> advance -> plan pass; each stage is idempotent,
        and a crash anywhere resumes from the durable record."""
        faults.fault_point("autoscale.sync")
        counts = {"advanced": 0, "applied": 0, "completed": 0,
                  "superseded": 0, "planned": 0, "converged": 0,
                  "deferred": 0}
        try:
            claims = self._list_claims()
            crds = self._list_partition_sets()
        except KubeError:
            logger.warning("autoscale sync: list failed; retrying next "
                           "pass")
            return counts
        live, pending, coop = self._ingest_claim_demand(claims)
        self._advance(counts)
        if not self.paused():
            self._detect_and_plan(crds, live, pending, counts, coop=coop)
            self._plan_prewarm(crds, counts)
        if counts["planned"]:
            # The fresh plan's CRD write in the same pass (its record is
            # durable already); the next pass confirms it.
            self._advance(counts, apply_only=True)
        active = len(self._checkpoint.get().claims)
        with self._lock:
            self._active_count = active
        if self.metrics is not None:
            self.metrics.active_rollouts.set(active)
        self.last_sync = counts
        return counts

    def _ingest_claim_demand(self, claims: list[dict]
                             ) -> tuple[set[str], set[str], set[str]]:
        """Fold the declared demand into the store: (live tenant keys,
        pending ones, cooperative ones: every live claim of the tenant
        declares ``resource.tpu.dra/migration-capable``)."""
        from ..recovery import claim_migration_capable  # noqa: PLC0415

        live: set[str] = set()
        pending: set[str] = set()
        cold: set[str] = set()
        for claim in claims:
            md = _meta(claim)
            if md.get("deletionTimestamp"):
                continue
            ann = md.get("annotations") or {}
            tenant = ann.get(TENANT_PROFILE_ANNOTATION)
            if not tenant:
                continue
            live.add(tenant)
            if not claim_migration_capable(claim):
                cold.add(tenant)
            if not claim.get("status", {}).get("allocation"):
                pending.add(tenant)
            raw = ann.get(TENANT_DEMAND_HBM_ANNOTATION)
            if raw is None:
                continue
            try:
                hbm = int(raw)
                cores = int(ann.get(TENANT_DEMAND_CORES_ANNOTATION, 1))
            except (TypeError, ValueError):
                continue  # malformed demand: observe nothing
            self.store.observe(tenant, hbm, cores=cores)
        return live, pending, live - cold

    # -- planning -------------------------------------------------------------

    def _our_crd(self, crds: list[dict]) -> dict | None:
        for obj in crds:
            if _meta(obj).get("name") == self.crd_name:
                return obj
        return None

    def _detect_and_plan(self, crds: list[dict], live: set[str],
                         pending: set[str], counts: dict,
                         coop: set[str] | None = None) -> None:
        if self._checkpoint.get().claims:
            return  # one rollout at a time
        now = time.time()
        if now < self._cooldown_until:
            return
        our = self._our_crd(crds)
        rules: tuple = ()
        active = PartitionSet(pools=self.pools)
        if our is not None:
            if not crd.is_managed(our):
                counts["deferred"] += 1  # manual override
                return
            try:
                active, rules = crd.partition_set_from_crd(our)
            except PartitionSpecError as e:
                # Our CRD hand-edited into garbage: planning against an
                # unknown baseline could stampede the fleet.
                logger.error("autoscale: managed PartitionSet %s is "
                             "malformed (%s); deferring re-plans",
                             self.crd_name, e)
                counts["deferred"] += 1
                return
        try:
            slices = self._list_slices()
        except KubeError:
            return
        chip_hbm, cores_per_chip = pool_chip_caps(slices)
        plan = self.planner.plan(
            self.store, active, rules=rules, chip_hbm=chip_hbm,
            cores_per_chip=cores_per_chip, live_tenants=live,
            pending_tenants=pending, pools=self.pools, coop_tenants=coop)
        if not plan.changed:
            counts["converged"] += 1
            self._drift_since = None
            if self.metrics is not None:
                self.metrics.converged.inc()
            return
        desired_spec = crd.spec_dict(plan.desired, rules)
        fp = crd.fingerprint(desired_spec)
        # Pending claims of a waiting tenant while the fleet's pending
        # ring is non-zero: a repack adds slots, so it must not wait.
        starving = bool(pending) and self.fleet is not None and \
            self.fleet.pending_recent() > 0
        if not plan.urgent and not starving:
            if self._drift_since is None or self._drift_since[0] != fp:
                self._drift_since = (fp, now)
            if now - self._drift_since[1] < self.sustain_s:
                counts["deferred"] += 1
                return
        self._drift_since = None
        faults.fault_point("autoscale.plan")
        self._write_record(fp, AUTOSCALE_PLANNED, live={
            "spec": desired_spec,
            "fingerprint": fp,
            "crd": self.crd_name,
            "plannedAt": now,
            "urgent": plan.urgent,
            "decisions": {t: d.get("action", "")
                          for t, d in plan.decisions.items()},
            "baseRevision": crd.revision_of(our) if our else 0,
        })
        counts["planned"] += 1
        with self._lock:
            self._active_count = max(self._active_count, 1)
        if self.metrics is not None:
            self.metrics.plans.inc()
        logger.warning(
            "autoscale re-plan %s: %d profile(s) [%s]%s", fp,
            len(plan.desired.profiles),
            ", ".join(f"{t}:{d.get('action')}"
                      for t, d in sorted(plan.decisions.items())),
            " (urgent)" if plan.urgent else "")

    # -- pre-warming (forecast -> the CRD's hint) -----------------------------

    @staticmethod
    def _parse_prewarm(raw: str) -> tuple[dict, bool]:
        """The standing hint as ``{pool: {profile: int}}`` and whether
        any of it was malformed (which reads as absent, and is
        rewritten)."""
        if not raw:
            return {}, False
        try:
            parsed = json.loads(raw)
        except (TypeError, ValueError):
            return {}, True
        if not isinstance(parsed, dict):
            return {}, True
        out: dict[str, dict[str, int]] = {}
        garbage = False
        for pool, profs in parsed.items():
            if not isinstance(profs, dict):
                garbage = True
                continue
            entry: dict[str, int] = {}
            for prof, n in profs.items():
                try:
                    n = int(n)
                except (TypeError, ValueError):
                    garbage = True
                    continue
                if n > 0:
                    entry[str(prof)] = n
            if entry:
                out[str(pool)] = entry
        return out, garbage

    def _plan_prewarm(self, crds: list[dict], counts: dict) -> None:
        """Converge our CRD's pre-warm annotation on the forecast; a
        converged forecast (or none) writes nothing."""
        if self.forecaster is None or self.fleet is None:
            return
        live = self._our_crd(crds)
        if live is None or not crd.is_managed(live):
            return  # nothing to hint on, or a manual override
        try:
            ps, _rules = crd.partition_set_from_crd(live)
        except PartitionSpecError:
            return  # the plan stage defers already
        per_pool = self.forecaster.forecast(self.fleet.snapshot())
        cap = int(positive_float_env("TPU_DRA_PREWARM_MAX", default=8,
                                     floor=0))
        hints: dict[str, dict[str, int]] = {}
        if ps.profiles and cap > 0:
            # New tenants land on the finest profile: warm that shape.
            best = max(ps.profiles, key=lambda p: p.max_tenants)
            for label, slots in sorted(per_pool.items()):
                pool = label.split("/", 1)[-1]
                devices = min(math.ceil(slots / max(best.max_tenants, 1)),
                              cap)
                if devices > 0:
                    hints[pool] = {best.name: devices}
        raw = (live.get("metadata", {}).get("annotations")
               or {}).get(crd.PREWARM_ANNOTATION, "")
        cur, garbage = self._parse_prewarm(raw)
        # Per pool: growth writes at once and carries the other pools'
        # held hints along; a shrinking forecast holds the standing hint;
        # a pool whose forecast stays zero for the stale window drops.
        now = time.time()
        for pool in list(self._prewarm_zero_since):
            if pool in hints or pool not in cur:
                del self._prewarm_zero_since[pool]
        for pool in cur:
            if pool not in hints:
                self._prewarm_zero_since.setdefault(pool, now)
        expired = {pool for pool, ts in self._prewarm_zero_since.items()
                   if now - ts >= self.forecaster.stale_s}
        held = {pool: profs for pool, profs in cur.items()
                if pool not in hints and pool not in expired}
        merged = {**held, **hints}
        grown = any(n > (cur.get(pool) or {}).get(prof, 0)
                    for pool, profs in hints.items()
                    for prof, n in profs.items())
        if not garbage and not grown and set(merged) == set(cur):
            return  # converged or wobbling: no write
        if grown:
            value = crd.prewarm_value(merged)
        else:
            # Expiry or a repair: keep every live pool's standing counts.
            value = crd.prewarm_value({pool: profs for pool, profs
                                       in cur.items()
                                       if pool not in expired})
        try:
            self.kube.patch(*CRD, self.crd_name, {"metadata": {
                "annotations": {crd.PREWARM_ANNOTATION: value or None}}})
        except (ConflictError, NotFoundError, KubeError):
            return  # an advisory hint: the next pass retries
        for pool in expired:
            self._prewarm_zero_since.pop(pool, None)
        counts["prewarmed"] = counts.get("prewarmed", 0) + 1
        self.flight.record(self.crd_name, "autoscale", state="Prewarm",
                           hint=value or "(cleared)")
        logger.info("autoscale prewarm hint: %s", value or "cleared")

    # -- durable records ------------------------------------------------------

    def _write_record(self, uid_fp: str, state: str,
                      live: dict | None = None, prev=None) -> None:
        from ...kubeletplugin.checkpoint import (  # noqa: PLC0415
            CheckpointedClaim, CheckpointedDevice)

        uid = f"replan-{uid_fp}"
        if prev is not None:
            live = dict(prev.devices[0].live or {}) if prev.devices else {}
        self._checkpoint.update_claim(uid, CheckpointedClaim(
            uid=uid, state=state,
            devices=[CheckpointedDevice(canonical_name=self._META_DEVICE,
                                        kind=self._META_DEVICE,
                                        live=live or {})]))
        self.flight.record(uid, "autoscale", state=state,
                           fingerprint=uid_fp)

    @staticmethod
    def _record_meta(rec) -> dict:
        return (rec.devices[0].live or {}) if rec.devices else {}

    # -- the rollout ----------------------------------------------------------

    def _advance(self, counts: dict, apply_only: bool = False) -> None:
        records = self._checkpoint.get().claims
        for uid in sorted(records):
            rec = records[uid]
            meta = self._record_meta(rec)
            fp = meta.get("fingerprint", "")
            if rec.state == AUTOSCALE_PLANNED:
                if self._apply(uid, fp, meta, counts):
                    counts["advanced"] += 1
                    counts["applied"] += 1
            elif rec.state == AUTOSCALE_APPLYING and not apply_only:
                self._confirm(uid, fp, meta, counts)

    def _supersede(self, uid: str, counts: dict, why: str) -> None:
        self._checkpoint.update_claim(uid, None)
        counts["superseded"] += 1
        if self.metrics is not None:
            self.metrics.superseded.inc()
        self.flight.record(uid, "autoscale", state="Superseded")
        logger.warning("autoscale rollout %s superseded: %s; operator "
                       "content wins", uid, why)

    def _apply(self, uid: str, fp: str, meta: dict, counts: dict) -> bool:
        """Write the pinned spec (create, or merge-patch the spec and the
        revision), then mark the record Applying. A resume re-issues the
        same content. An operator's flip of the managed annotation wins:
        the rollout retires untouched (only a create stamps it)."""
        faults.fault_point("autoscale.apply")
        spec = meta.get("spec") or {}
        revision = int(meta.get("baseRevision", 0)) + 1
        try:
            live = self.kube.get(*CRD, self.crd_name)
        except NotFoundError:
            live = None
        except KubeError:
            return False  # the next pass retries
        if live is not None and not crd.is_managed(live):
            self._supersede(uid, counts,
                            "managed annotation flipped off mid-plan")
            return False
        try:
            if live is None:
                self.kube.create(*CRD, crd.crd_object_from_spec(
                    self.crd_name, spec, revision=revision))
            else:
                self.kube.patch(*CRD, self.crd_name, {
                    "metadata": {"annotations": {
                        crd.REVISION_ANNOTATION: str(revision)}},
                    "spec": spec})
        except ConflictError:
            return False  # re-examined next pass
        except KubeError:
            logger.warning("autoscale: CRD apply failed; retrying")
            return False
        rec = self._checkpoint.get().claims.get(uid)
        self._write_record(fp, AUTOSCALE_APPLYING, prev=rec)
        return True

    def _confirm(self, uid: str, fp: str, meta: dict,
                 counts: dict) -> None:
        """A fresh read of the CRD: our content standing completes the
        rollout; anything else supersedes it (the operator's content
        wins)."""
        faults.fault_point("autoscale.confirm")
        try:
            live = self.kube.get(*CRD, self.crd_name)
        except NotFoundError:
            live = None
        except KubeError:
            return  # the next pass retries
        counts["advanced"] += 1
        if live is not None and crd.fingerprint(live.get("spec", {})) == fp:
            self._checkpoint.update_claim(f"replan-{fp}", None)
            counts["completed"] += 1
            self._cooldown_until = time.time() + self.cooldown_s
            planned_at = float(meta.get("plannedAt", 0.0))
            if self.metrics is not None:
                self.metrics.applies.inc()
                if planned_at:
                    self.metrics.rollout_seconds.observe(
                        max(time.time() - planned_at, 0.0))
            self.flight.record(f"replan-{fp}", "autoscale",
                               state="Completed")
            logger.warning("autoscale rollout %s complete", fp)
        else:
            self._supersede(f"replan-{fp}", counts,
                            "concurrent PartitionSet edit")
