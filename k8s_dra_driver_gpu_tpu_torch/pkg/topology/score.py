"""The placement scorer: compactness first, fragmentation cost second
(the JAX package's ``pkg/topology/score.py``, the port's copy).

Given a pool grid, its free chips, and a claim's chip count, the
scorer ranks candidate device sets by:

1. **Compactness**: max pairwise ICI hop distance (the collective's
   worst-case path -- the property the CLAIM's owner feels), then
   exposed surface area (fabric links crossing the allocation
   boundary). A 2x2 quad always beats a 4x1 line.
2. **Fragmentation cost** (best-fit): among equally-compact choices,
   how many future large-shape placements the pick destroys, weighted
   by shape volume -- the property the FLEET feels under churn. The
   protected-shape catalog is the power-of-two claim sizes (2, 4, 8,
   ... up to the slice) -- the sizes TPU sub-slices actually come in --
   which keeps scoring O(hundreds) of placement checks instead of the
   full shape lattice.
3. A deterministic name tiebreak, so equal-score rankings are stable
   across processes and test runs.

Exact sub-torus placements are preferred; when fragmentation (or a
non-factorizable count) leaves none, a greedy nearest-neighbor
fallback still produces compact -- just not box-shaped -- sets.
"""

from __future__ import annotations

import os
import threading
from functools import lru_cache

from .grid import Coord, TorusGrid
from .shapes import enumerate_shapes, placements, shapes_for_count


def attr_int(attrs: dict, name: str) -> int:
    """Quantized int device attribute (`{"int": N}` entries), 0 when
    absent/malformed — THE parse for the telemetry/power attribute
    contract, shared by the scorer, pkg/schedcache and
    pkg/fleetstate so the three readers can never drift."""
    entry = attrs.get(name)
    if isinstance(entry, dict) and "int" in entry:
        try:
            return int(entry["int"])
        except (TypeError, ValueError):
            return 0
    return 0


def set_compactness(grid: TorusGrid, cells: set[Coord]
                    ) -> tuple[int, int]:
    """(max ICI hops, exposed surface area) -- lower is tighter."""
    return (grid.max_hops(cells), grid.surface_area(cells))


# -- power / thermal headroom (2501.17752: telemetry as a placement
# signal). Chips in an active anomaly episode of these kinds carry a
# non-fatal ``tpu.dra.dev/<kind>`` device taint (pkg/anomaly.py via the
# health poll); the scorer treats them as last-resort picks. Pure
# PREFERENCE below the quarantine threshold: the fit semantics
# (selectors, counters, matchAttributes) never change -- a degraded
# chip is still used when no clean peer satisfies the claim.
AVOID_TAINT_KINDS = ("power_cap_throttle", "duty_cycle_straggler",
                     "thermal_drift")
#: Penalty weight of an active avoid-kind anomaly taint.
PENALTY_ANOMALY = 4
#: ...of low power headroom (telemetry draw near the node cap share).
PENALTY_POWER = 2
#: ...of low thermal headroom (die temp at/above the soft limit).
PENALTY_THERMAL = 1
#: Power-headroom threshold: telemetry draw >= this fraction of the
#: device's rated/cap share counts as "no headroom".
POWER_HEADROOM_FRACTION = 0.9


@lru_cache(maxsize=8)
def _parse_limit(raw: str) -> float:
    try:
        return max(float(raw), 0.0)
    except ValueError:
        return 0.0


def _soft_temp_limit_c() -> float:
    """``TPU_DRA_TEMP_SOFT_LIMIT_C``: die temperature above which a
    chip loses thermal-headroom preference (0 disables). Called per
    device per snapshot build: the env read stays live (tests flip
    it) but the parse is memoized on the raw string."""
    return _parse_limit(os.environ.get(
        "TPU_DRA_TEMP_SOFT_LIMIT_C", "0"))


def device_headroom_penalty(device: dict,
                            temp_limit_c: float | None = None) -> int:
    """Telemetry-derived placement penalty for one published device
    (0 = healthy). Summed per candidate placement by
    :func:`rank_placements` and used as a stable-sort key by the
    scheduler's fallback ordering -- higher sorts later, never out."""
    penalty = 0
    for taint in device.get("taints") or []:
        key = taint.get("key", "")
        if any(key.endswith("/" + kind) or key == kind
               for kind in AVOID_TAINT_KINDS):
            penalty += PENALTY_ANOMALY
            break  # one anomaly penalty per device, not per kind
    attrs = device.get("attributes") or {}
    power = attr_int(attrs, "telemetryPowerWatts")
    rated = attr_int(attrs, "powerRatedWatts")
    if power > 0 and rated > 0 and \
            power >= rated * POWER_HEADROOM_FRACTION:
        penalty += PENALTY_POWER
    temp = attr_int(attrs, "telemetryTempCelsius")
    limit = _soft_temp_limit_c() if temp_limit_c is None \
        else temp_limit_c
    if temp > 0 and limit > 0 and temp >= limit:
        penalty += PENALTY_THERMAL
    return penalty


def _protected_shapes(grid: TorusGrid) -> list[tuple[int, int, int]]:
    """The power-of-two shape catalog the frag scorer defends."""
    total = grid.dims[0] * grid.dims[1] * grid.dims[2]
    shapes: list[tuple[int, int, int]] = []
    size = 2
    while size <= total:
        shapes.extend(shapes_for_count(grid, size))
        size *= 2
    return shapes


def _free_placements(grid: TorusGrid, free: set[Coord],
                     shapes: list[tuple[int, int, int]]
                     ) -> list[tuple[int, frozenset[Coord]]]:
    """(volume, cells) for every protected placement currently fully
    free -- the standing inventory a pick can destroy."""
    out = []
    for shape in shapes:
        vol = shape[0] * shape[1] * shape[2]
        for cells in placements(grid, shape):
            if all(c in free for c in cells):
                out.append((vol, frozenset(cells)))
    return out


def frag_cost(pick: set[Coord],
              inventory: list[tuple[int, frozenset[Coord]]]) -> int:
    """Volume-weighted count of inventory placements the pick
    intersects (and therefore destroys)."""
    return sum(vol for vol, cells in inventory
               if not cells.isdisjoint(pick))


def grid_signature(grid: TorusGrid) -> tuple:
    """A hashable identity for a grid's geometry: dims, wraparound,
    and the coordinate map. A pure function of the published devices,
    so two grids built from the same slices share one memo row.

    Cached on the grid instance: TorusGrid is immutable after
    ``from_devices``, and the fleet fold + the defrag what-if loop
    query the same grid object many times per pass -- without the
    cache the O(n log n) coord sort would dominate every memo hit.
    (``object.__setattr__``: the dataclass is frozen, which blocks
    the normal spelling but not this deliberate one-shot memo.)"""
    sig = getattr(grid, "_signature_memo", None)
    if sig is None:
        sig = (grid.dims, grid.wrap,
               tuple(sorted(grid.coords.items())))
        try:
            object.__setattr__(grid, "_signature_memo", sig)
        except (AttributeError, TypeError):
            pass  # slotted/odd grid subclass: recompute per call
    return sig


# largest_free_shape memo: (grid signature, frozenset(free)) ->
# (shape, chips). The FleetAggregator fold recomputes every pool's
# frag each pass and the defrag what-if loop probes dozens of
# hypothetical free sets against ONE grid -- without the memo each
# probe pays the full O(shapes x placements) sweep. Bounded FIFO
# (oldest third dropped at the cap) so a long-lived scheduler can't
# grow it without bound.
_SHAPE_MEMO: dict[tuple, tuple[tuple[int, int, int], int]] = {}
_SHAPE_MEMO_MAX = 4096
_shape_memo_lock = threading.Lock()


def clear_shape_memo() -> None:
    """Drop the largest_free_shape memo (tests / bench isolation)."""
    with _shape_memo_lock:
        _SHAPE_MEMO.clear()


def largest_free_shape(grid: TorusGrid, free: set[Coord]
                       ) -> tuple[tuple[int, int, int], int]:
    """The biggest sub-torus shape still fully placeable in ``free``
    -> (shape, chips); ((0, 0, 0), 0) when nothing is free.

    Memoized on (grid signature, free set): the sweep is the most
    expensive topology operation, and both the fleet fold and the
    defrag planner call it repeatedly with recurring inputs."""
    key = (grid_signature(grid), frozenset(free))
    with _shape_memo_lock:
        hit = _SHAPE_MEMO.get(key)
    if hit is not None:
        return hit
    result: tuple[tuple[int, int, int], int] = ((0, 0, 0), 0)
    for shape in enumerate_shapes(grid, max_chips=len(free)):
        placed = False
        for cells in placements(grid, shape):
            if all(c in free for c in cells):
                result = (shape, shape[0] * shape[1] * shape[2])
                placed = True
                break
        if placed:
            break
    with _shape_memo_lock:
        if len(_SHAPE_MEMO) >= _SHAPE_MEMO_MAX:
            for old in list(_SHAPE_MEMO)[:_SHAPE_MEMO_MAX // 3]:
                del _SHAPE_MEMO[old]
        _SHAPE_MEMO[key] = result
    return result


def frag_from_largest(largest_chips: int, free_count: int) -> float:
    """THE fragmentation formula: 1 - largest-allocatable-shape /
    free-chips, in [0, 1). Exposed separately so callers that already
    paid the largest_free_shape sweep (the expensive half) don't
    re-derive -- or worse, re-implement -- the division."""
    if free_count <= 0:
        return 0.0
    return 1.0 - largest_chips / free_count


def fragmentation_score(grid: TorusGrid, free: set[Coord]) -> float:
    """0.0 means the free space is one perfect sub-torus (or there is
    none); rising values mean churn has shredded the big shapes."""
    _, chips = largest_free_shape(grid, free)
    return frag_from_largest(chips, len(free))


def _greedy_sets(grid: TorusGrid, free: set[Coord], count: int
                 ) -> list[tuple[Coord, ...]]:
    """Fallback candidate sets when no exact sub-torus placement is
    free: grow from each seed by nearest free chip (hop distance to
    the set, deterministic coord tiebreak)."""
    out: list[tuple[Coord, ...]] = []
    seen: set[frozenset[Coord]] = set()
    for seed in sorted(free):
        picked = [seed]
        pool = set(free)
        pool.discard(seed)
        while len(picked) < count and pool:
            best = min(
                pool,
                key=lambda c: (min(grid.hop_distance(c, p)
                                   for p in picked), c),
            )
            picked.append(best)
            pool.discard(best)
        if len(picked) == count:
            key = frozenset(picked)
            if key not in seen:
                seen.add(key)
                out.append(tuple(sorted(picked)))
    return out


def rank_placements(grid: TorusGrid, free_names: list[str], count: int,
                    penalties: dict[str, int] | None = None
                    ) -> list[list[str]]:
    """Candidate device sets for a ``count``-chip claim, best first.

    Only names with coordinates participate; an empty result means the
    caller should keep its first-fit order (no grid information, or
    count exceeds the coordinated free chips).

    ``penalties`` (device name -> headroom penalty,
    :func:`device_headroom_penalty`) is the power/thermal term: a
    placement touching a throttling / thermally-drifting / straggling
    chip ranks below every clean placement, but stays in the list --
    last resort, never excluded.
    """
    if count < 1:
        return []
    free = {grid.coords[n] for n in free_names if n in grid.coords}
    if len(free) < count:
        return []
    inventory = _free_placements(grid, free, _protected_shapes(grid))
    candidates: list[tuple[Coord, ...]] = []
    for shape in shapes_for_count(grid, count):
        for cells in placements(grid, shape):
            if all(c in free for c in cells):
                candidates.append(cells)
    if not candidates:
        candidates = _greedy_sets(grid, free, count)
    # One coord->name inversion for every candidate (cell_names would
    # rebuild it per placement).
    by_coord = {c: n for n, c in grid.coords.items()}
    penalties = penalties or {}
    scored = []
    for cells in candidates:
        cellset = set(cells)
        names = [by_coord.get(c) for c in cells]
        if None in names:
            continue  # a cell with no published device: not realizable
        max_hops, surface = set_compactness(grid, cellset)
        scored.append((
            sum(penalties.get(n, 0) for n in names),
            max_hops,
            frag_cost(cellset, inventory),
            surface,
            sorted(names),
            names,
        ))
    scored.sort(key=lambda t: t[:5])
    return [t[5] for t in scored]


def order_candidates(grid: TorusGrid, free_names: list[str], count: int,
                     penalties: dict[str, int] | None = None
                     ) -> list[str] | None:
    """A full preference ordering of ``free_names`` for a backtracking
    allocator: the best-ranked placement's devices first, then each
    next placement's unseen devices, then any remaining names in their
    original (first-fit) order. None = no topology signal; keep the
    caller's order. ``penalties`` biases the ranking away from
    degraded chips (see :func:`rank_placements`)."""
    ranked = rank_placements(grid, free_names, count,
                             penalties=penalties)
    if not ranked:
        return None
    ordered: list[str] = []
    seen: set[str] = set()
    for names in ranked:
        for name in names:
            if name not in seen:
                seen.add(name)
                ordered.append(name)
    for name in free_names:
        if name not in seen:
            seen.add(name)
            ordered.append(name)
    return ordered
