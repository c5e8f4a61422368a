"""Demand-matched co-location of sized tenants (ParvaGPU; the JAX
package's ``pkg/partition/packing.py``).

ParvaGPU (2409.14447) meets inference SLOs by giving each tenant a
spatial share of a GPU and co-locating complementary tenants so cards
run full. :func:`pack_tenants` packs sized tenants (memory budgets from
``profiles.SizingPolicy``) onto cards best-fit-decreasing: large tenants
seed cards, small ones top them off, and the plan reports the memory it
leaves unused. Deterministic: the same demands give the same plan.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .spec import PartitionDemand


@dataclass
class ChipPlan:
    """Tenants co-located on one card."""

    index: int
    capacity_hbm: int
    used_hbm: int = 0
    tenants: list[PartitionDemand] = field(default_factory=list)

    @property
    def free_hbm(self) -> int:
        return self.capacity_hbm - self.used_hbm


@dataclass
class PackingPlan:
    chips: list[ChipPlan]
    unplaced: list[PartitionDemand]

    @property
    def chips_used(self) -> int:
        return sum(1 for c in self.chips if c.tenants)

    @property
    def tenants_placed(self) -> int:
        return sum(len(c.tenants) for c in self.chips)

    @property
    def tenants_per_chip(self) -> float:
        used = self.chips_used
        return self.tenants_placed / used if used else 0.0

    @property
    def waste_fraction(self) -> float:
        """Unused memory across the cards the plan touched (lower is
        tighter co-location)."""
        cap = sum(c.capacity_hbm for c in self.chips if c.tenants)
        if not cap:
            return 0.0
        used = sum(c.used_hbm for c in self.chips if c.tenants)
        return 1.0 - used / cap

    def to_dict(self) -> dict:
        return {"chipsUsed": self.chips_used,
                "tenantsPlaced": self.tenants_placed,
                "tenantsPerChip": round(self.tenants_per_chip, 2),
                "wasteFraction": round(self.waste_fraction, 4),
                "unplaced": len(self.unplaced)}


def pack_tenants(demands: list[PartitionDemand], chip_hbm: int,
                 chips: int, max_tenants_per_chip: int | None = None,
                 avoid: set[int] | None = None) -> PackingPlan:
    """Best-fit-decreasing co-location of tenants onto ``chips`` cards of
    ``chip_hbm`` bytes each.

    Tenants sort by demand descending (ties by key); each takes the card
    whose free memory fits it tightest, which pairs a large tenant with
    small ones instead of spreading the small ones over fresh cards.
    ``max_tenants_per_chip`` caps co-tenancy (None: memory-bound only).
    ``avoid`` names cards in an anomaly episode (``pkg/anomaly.py``): a
    tenant lands on one only when no clean card fits it."""
    expanded: list[PartitionDemand] = []
    for d in demands:
        for _ in range(max(d.count, 0)):
            expanded.append(PartitionDemand(
                hbm_bytes=d.hbm_bytes, cores=d.cores, count=1,
                tenant=d.tenant))
    expanded.sort(key=lambda d: (-d.hbm_bytes, d.tenant))
    plan = PackingPlan(chips=[ChipPlan(index=i, capacity_hbm=chip_hbm)
                              for i in range(chips)], unplaced=[])
    avoid = avoid or set()
    for demand in expanded:
        best: ChipPlan | None = None
        best_avoided = True
        for chip in plan.chips:
            if chip.free_hbm < demand.hbm_bytes:
                continue
            if max_tenants_per_chip is not None and \
                    len(chip.tenants) >= max_tenants_per_chip:
                continue
            avoided = chip.index in avoid
            # A clean card outranks an avoided one; within a tier the
            # tightest fit, then the lowest index.
            if best is None or (best_avoided and not avoided) or (
                    best_avoided == avoided
                    and (chip.free_hbm, chip.index)
                    < (best.free_hbm, best.index)):
                best = chip
                best_avoided = avoided
        if best is None:
            plan.unplaced.append(demand)
            continue
        best.tenants.append(demand)
        best.used_hbm += demand.hbm_bytes
    return plan
