"""Demand -> desired PartitionSet (MISO sizing, a hysteresis band; the
JAX package's ``pkg/autoscale/planner.py``).

The planner is pure: demand percentiles in (``TenantProfileStore``), a
desired ``PartitionSet`` out. The controller owns the state (the sustain
clock, the durable rollout records, the API server).

- **Sizing** (MISO, 2207.11428): each tenant key gets the smallest slot
  count whose per-tenant budget covers its demand percentile, from a
  catalog of one-card profiles at ``slot_counts``, budgeted from the
  capacities the nodes publish as KEP-4815 shared counters
  (:func:`pool_chip_caps`), so a plan never promises a budget the
  counters refuse.
- **Hysteresis**: a tenant whose profile still covers its demand is
  repacked to a finer one only when its demand sits ``band`` below the
  finer budget; upsizes (demand above the active budget) always fire.
- **Priority** (``crd.PriorityRule``): a tenant matching a rule of
  priority > 0 is sized against one-slot profiles only, away from
  oversubscribed devices.
- **Names** are versioned by shape (``<tenant>-s<slots>``): a resize
  retires a name and adds another instead of re-shaping a live profile,
  so the node engine never re-shapes a held device, and the old name
  drains once its last tenant detaches.

Two parts differ on a GPU:

- :func:`pool_chip_caps` reads the port's counter sets (one a GPU,
  ``gpu-<i>-counter-set``, ``kubeletplugin/partitions.py``): ``memory``
  is the card's memory, ``multiprocessors`` (published only with MIG on)
  its core count, and a card without it counts one core, as the JAX
  function's ``max(cores, 1)`` does for a chip without core counters.
  (The JAX function reads ``hbm-<chip>`` and ``core-<chip>-<core>``.)
- A catalog profile is backed by one whole card, as the JAX planner's
  ``subslice="1x1"`` is by one whole chip. A profile's ``subslice`` here
  is a MIG profile name, so the default is the H100 80GB's whole-GPU
  MIG profile, ``7g.80gb``; pass ``subslice`` for another card. On a
  card whose MIG is off the node refuses such a plan and keeps its last
  good plan (``pkg/partition/watch.py``): the JAX fail-closed path.
"""

from __future__ import annotations

import logging
import re
from dataclasses import dataclass, field

from ..cel import Quantity
from ..partition.profiles import SizedChoice, SizingPolicy
from ..partition.spec import PartitionProfile, PartitionSet
from .crd import PriorityRule

logger = logging.getLogger(__name__)

#: Claim annotations declaring a tenant's demand to the controller's
#: store (the API server's twin of the node's usage feed): folded every
#: pass, so live claims keep their demand fresh in the window.
TENANT_DEMAND_HBM_ANNOTATION = "resource.tpu.dra/tenant-demand-hbm"
TENANT_DEMAND_CORES_ANNOTATION = "resource.tpu.dra/tenant-demand-cores"

#: The H100 80GB's whole-GPU MIG profile: a catalog profile's backing.
WHOLE_GPU_SUBSLICE = "7g.80gb"

_NAME_SANITIZE_RE = re.compile(r"[^a-z0-9-]+")
_PROFILE_NAME_RE = re.compile(r"^(.*)-s(\d+)$")


def profile_name_for(tenant: str, slots: int) -> str:
    """The shape-versioned profile name."""
    san = _NAME_SANITIZE_RE.sub("-", tenant.lower()).strip("-") or "t"
    return f"{san}-s{slots}"


def tenant_of_profile(name: str) -> tuple[str, int] | None:
    m = _PROFILE_NAME_RE.match(name)
    if not m:
        return None
    return m.group(1), int(m.group(2))


def _quantity(val) -> int | None:
    """A counter's value in units; None where parsing raises
    ``ValueError`` (the counter is skipped, as in the JAX function). A
    value that is no quantity raises ``CelEvalError`` out of the pass, as
    the JAX function's does: the scheduler logs it every pass, and a
    corrupt counter never reads as a converged fleet."""
    try:
        return Quantity.parse(str((val or {}).get("value", "0"))
                              ).milli // 1000
    except ValueError:
        return None


def pool_chip_caps(slices: list[dict]) -> tuple[int, int]:
    """(memory bytes, cores) of the fleet's largest card, from the
    published counter sets (a uniform fleet is assumed; a mixed one is
    sized against its largest card and checked per node by the engine's
    counters)."""
    hbm = cores = 0
    for s in slices:
        for cs in s.get("spec", {}).get("sharedCounters") or []:
            counters = cs.get("counters") or {}
            if "memory" in counters:
                hbm = max(hbm, _quantity(counters["memory"]) or 0)
            if "multiprocessors" in counters:
                cores = max(cores,
                            _quantity(counters["multiprocessors"]) or 0)
    return hbm, max(cores, 1)


@dataclass(frozen=True)
class CatalogEntry:
    """A sizing-catalog entry with the surface ``SizingPolicy.pick``
    reads (``PartitionInfo``'s), budgeted from the published counters
    instead of a node's host handle."""

    profile: PartitionProfile
    cores: int
    tenant_hbm_bytes: int
    tenant_core_milli: int


@dataclass
class PlanResult:
    """One planning pass: the desired set, whether it differs from the
    active one, and whether the difference is urgent (an upsize or a new
    pending tenant: fire now) or a repack (wait out the sustain clock)."""

    desired: PartitionSet
    changed: bool = False
    urgent: bool = False
    #: tenant -> {"slots", "budget", "demand", "action", "priority"}
    decisions: dict = field(default_factory=dict)


class AutoscalePlanner:
    def __init__(self, percentile: float = 0.95, band: float = 0.1,
                 slot_counts: tuple[int, ...] = (1, 2, 4, 8),
                 subslice: str = WHOLE_GPU_SUBSLICE):
        self.percentile = percentile
        self.band = max(0.0, min(float(band), 0.9))
        self.slot_counts = tuple(sorted(set(
            int(s) for s in slot_counts if int(s) >= 1)))
        self.subslice = subslice
        self._policy = SizingPolicy(percentile)

    def _catalog(self, tenant: str, chip_hbm: int, cores_per_chip: int,
                 slot_counts: tuple[int, ...]
                 ) -> list[tuple[PartitionProfile, CatalogEntry]]:
        out = []
        for slots in slot_counts:
            prof = PartitionProfile(name=profile_name_for(tenant, slots),
                                    subslice=self.subslice,
                                    max_tenants=slots)
            out.append((prof, CatalogEntry(
                profile=prof, cores=cores_per_chip,
                tenant_hbm_bytes=chip_hbm // slots,
                tenant_core_milli=1000 * cores_per_chip // slots)))
        return out

    @staticmethod
    def _priority_of(tenant: str, hbm: int, cores: int,
                     rules: tuple[PriorityRule, ...]) -> int:
        return max((r.priority for r in rules
                    if r.matches(tenant, hbm, cores)), default=0)

    def plan(self, store, active: PartitionSet,
             rules: tuple[PriorityRule, ...] = (),
             chip_hbm: int = 0, cores_per_chip: int = 1,
             live_tenants: set[str] | None = None,
             pending_tenants: set[str] | None = None,
             pools: tuple[str, ...] = (),
             now: float | None = None,
             coop_tenants: set[str] | None = None) -> PlanResult:
        """Size every fresh tenant key and diff the result against
        ``active``. ``live_tenants`` (keys with live claims) keep their
        profiles though every sample aged out; a missing or undersized
        profile of a ``pending_tenants`` key is urgent; the repack band
        of ``coop_tenants`` (every live claim migration-capable,
        ``pkg/migration``) shrinks by the cooperative cost factor, since
        resizing them costs a checkpoint-restore, not a cold restart."""
        from ..recovery import COOP_COST_FACTOR  # noqa: PLC0415

        live_tenants = live_tenants or set()
        pending_tenants = pending_tenants or set()
        coop_tenants = coop_tenants or set()
        active_by_name = {p.name: p for p in active.profiles}
        fresh = set(store.fresh_tenants(now=now)) | set(live_tenants)
        decisions: dict = {}
        profiles: dict[str, PartitionProfile] = {}
        urgent = False

        if chip_hbm <= 0:
            # No published counters to budget against: keep the layout.
            return PlanResult(desired=active)

        for tenant in sorted(fresh):
            demand = store.demand(tenant, self.percentile, now=now)
            if demand is None:
                # Live claims but no sample ever: keep its profiles.
                self._retain_active(tenant, active_by_name, profiles)
                continue
            prio = self._priority_of(tenant, demand.hbm_bytes,
                                     demand.cores, rules)
            slot_counts = (1,) if prio > 0 else self.slot_counts
            choice = self._policy.pick(demand, self._catalog(
                tenant, chip_hbm, cores_per_chip, slot_counts))
            if choice is None:
                # A whole-card demand: no profile; any active one
                # retires (urgent only for a pending tenant).
                decisions[tenant] = {"action": "no-fit",
                                     "demand": demand.hbm_bytes,
                                     "priority": prio}
                urgent = urgent or tenant in pending_tenants
                continue
            s_new = choice.profile.max_tenants
            cur = self._active_profile(tenant, active_by_name)
            action = "new"
            if cur is not None:
                s_old = cur.max_tenants
                budget_old = chip_hbm // max(s_old, 1)
                if prio > 0 and s_old > 1:
                    action = "isolate"  # latency-critical: off shared
                    urgent = True
                elif demand.hbm_bytes > budget_old:
                    action = "upsize"  # the active budget is blown
                    urgent = True
                elif s_new > s_old:
                    # A finer profile fits: repack only when the demand
                    # sits clearly below its budget (the band).
                    band = self.band
                    if tenant in coop_tenants:
                        band = self.band * min(max(COOP_COST_FACTOR, 0.0),
                                               1.0)
                    if demand.hbm_bytes > chip_hbm // s_new * (1 - band):
                        choice = self._keep(cur, chip_hbm, cores_per_chip)
                        action = "keep"
                    else:
                        action = "repack"
                else:
                    choice = self._keep(cur, chip_hbm, cores_per_chip)
                    action = "keep"
            else:
                urgent = urgent or tenant in pending_tenants
            profiles[choice.profile.name] = choice.profile
            decisions[tenant] = {"action": action,
                                 "slots": choice.profile.max_tenants,
                                 "budget": choice.per_tenant_hbm,
                                 "demand": demand.hbm_bytes,
                                 "priority": prio}

        desired = PartitionSet(
            profiles=tuple(profiles[name] for name in sorted(profiles)),
            pools=tuple(pools) or active.pools)
        changed = ({p.name for p in desired.profiles} != set(active_by_name)
                   or desired.pools != active.pools)
        # A retired profile (its tenant aged out) is never urgent.
        return PlanResult(desired=desired, changed=changed,
                          urgent=urgent and changed, decisions=decisions)

    @staticmethod
    def _active_profile(tenant: str, active_by_name: dict
                        ) -> PartitionProfile | None:
        """The tenant's profile in the active set; mid-drain, the finest
        (the newest sizing) of its shapes."""
        best = None
        for name, prof in active_by_name.items():
            parsed = tenant_of_profile(name)
            if parsed and parsed[0] == tenant and (
                    best is None or prof.max_tenants > best.max_tenants):
                best = prof
        return best

    @staticmethod
    def _retain_active(tenant: str, active_by_name: dict,
                       profiles: dict) -> None:
        for name, prof in active_by_name.items():
            parsed = tenant_of_profile(name)
            if parsed and parsed[0] == tenant:
                profiles[name] = prof

    @staticmethod
    def _keep(cur: PartitionProfile, chip_hbm: int,
              cores_per_chip: int) -> SizedChoice:
        """The kept profile as a choice, budgeted as the catalog's."""
        slots = max(cur.max_tenants, 1)
        return SizedChoice(profile=cur, per_tenant_hbm=chip_hbm // slots,
                           per_tenant_core_milli=1000 * cores_per_chip
                           // slots)
