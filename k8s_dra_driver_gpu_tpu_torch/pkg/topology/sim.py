"""Placement simulator: claim churn against v5e/v5p-shaped grids (the
JAX package's ``pkg/topology/sim.py``, the port's copy), and the
simulated re-pack the defragmentation controller plans with.

Replays a randomized-but-deterministic claim arrival/departure trace
against a slice grid twice -- once with the scheduler's historical
first-fit policy, once with the topology scorer -- and reports
fragmentation over time: fragmentation score, allocatable largest
shape, allocation compactness. The SAME trace drives both policies
(sizes/lifetimes are pre-drawn from the seed), so the comparison is
paired, not statistical.

The grids are TPU slice shapes, named by accelerator type (``v5e-16``,
``v5p-32``): the port keeps its own copy of the JAX device layer's type
parser and slice-shape table here (``parse_tpu_type``,
``tpu_slice_shape``), apart from the port's ``tpulib``, whose
``_parse_type`` reads ``h100-<n>``.
"""

from __future__ import annotations

import random
import re
import statistics
from dataclasses import dataclass

from .grid import Coord, TorusGrid, default_wrap
from .score import (
    _greedy_sets,
    frag_from_largest,
    largest_free_shape,
    rank_placements,
    set_compactness,
)
from .shapes import enumerate_shapes, placements, shapes_for_count

# TPU generations: (ICI dims, whether the type string counts cores, and
# cores a chip), as the JAX device layer's ``_GENERATIONS`` has them.
_TPU_GENERATIONS = {"v4": (3, True, 2), "v5e": (2, False, 1),
                    "v5p": (3, True, 2), "v6e": (2, False, 1)}
_SHAPES_3D = {1: (1, 1, 1), 2: (1, 1, 2), 4: (2, 2, 1), 8: (2, 2, 2),
              16: (2, 2, 4), 32: (2, 4, 4), 64: (4, 4, 4), 128: (4, 4, 8),
              256: (4, 8, 8), 512: (8, 8, 8)}
_SHAPES_2D = {1: (1, 1, 1), 2: (1, 2, 1), 4: (2, 2, 1), 8: (2, 4, 1),
              16: (4, 4, 1), 32: (4, 8, 1), 64: (8, 8, 1), 128: (8, 16, 1),
              256: (16, 16, 1)}


def parse_tpu_type(accelerator_type: str) -> tuple[str, int] | None:
    """``"v5p-32"`` -> ("v5p", 16): the generation and its chip count
    (a v4/v5p type counts cores, two a chip); None for anything else."""
    m = re.fullmatch(r"(v\d+\w*)-(\d+)", accelerator_type)
    if not m or m.group(1) not in _TPU_GENERATIONS:
        return None
    _, counts_cores, cores = _TPU_GENERATIONS[m.group(1)]
    n = int(m.group(2))
    chips = n // cores if counts_cores else n
    return (m.group(1), chips) if chips > 0 else None


def tpu_slice_shape(generation: str, chips: int) -> tuple[int, int, int]:
    """The slice dims of ``chips`` chips of ``generation``."""
    table = _SHAPES_3D if _TPU_GENERATIONS[generation][0] == 3 \
        else _SHAPES_2D
    return table.get(chips, (1, chips, 1))


# Typical TPU claim sizes: single chips up to half-slice blocks.
DEFAULT_SIZES = (1, 1, 2, 4, 4, 8)


def grid_for_type(accelerator_type: str) -> TorusGrid:
    """A fully-populated TorusGrid for an accelerator type string
    (e.g. ``v5e-16``, ``v5p-32``), chips named ``chip-<i>`` in
    row-major publication order."""
    parsed = parse_tpu_type(accelerator_type)
    if parsed is None:
        raise ValueError(f"unknown accelerator type {accelerator_type!r}")
    gen, chips = parsed
    dims = tpu_slice_shape(gen, chips)
    coords = {}
    i = 0
    for z in range(dims[2]):
        for y in range(dims[1]):
            for x in range(dims[0]):
                coords[f"chip-{i}"] = (x, y, z)
                i += 1
    return TorusGrid(dims=dims, wrap=default_wrap(gen, dims),
                     coords=coords)


@dataclass(frozen=True)
class TraceEvent:
    """One simulator step: an optional arrival (size, lifetime)."""

    size: int  # 0 = no arrival this step
    lifetime: int


def make_trace(steps: int, seed: int, sizes=DEFAULT_SIZES,
               arrival_prob: float = 0.7, max_lifetime: int = 25
               ) -> list[TraceEvent]:
    """The deterministic churn trace both policies replay."""
    rng = random.Random(seed)
    out = []
    for _ in range(steps):
        if rng.random() < arrival_prob:
            out.append(TraceEvent(size=rng.choice(sizes),
                                  lifetime=rng.randint(1, max_lifetime)))
        else:
            out.append(TraceEvent(size=0, lifetime=0))
    return out


def _first_fit_pick(grid: TorusGrid, free_names: list[str], size: int
                    ) -> list[str] | None:
    """The pre-topology scheduler policy: first ``size`` free devices
    in publication order, scattered or not."""
    if len(free_names) < size:
        return None
    return free_names[:size]


def _scored_pick(grid: TorusGrid, free_names: list[str], size: int
                 ) -> list[str] | None:
    ranked = rank_placements(grid, free_names, size)
    if ranked:
        return ranked[0]
    return _first_fit_pick(grid, free_names, size)


_POLICIES = {"first_fit": _first_fit_pick, "scored": _scored_pick}


def simulate_churn(grid: TorusGrid, trace: list[TraceEvent],
                   policy: str = "scored", metrics=None,
                   pool: str = "sim") -> dict:
    """Replay ``trace`` under ``policy``; returns the fragmentation /
    compactness summary. ``metrics`` (a ``PlacementMetrics``) gets the
    per-step gauges + per-allocation compactness observations, proving
    the exporter wiring end to end."""
    pick = _POLICIES[policy]
    all_names = sorted(grid.coords, key=lambda n: (len(n), n))
    allocated: dict[int, tuple[list[str], int]] = {}  # id -> (devs, expiry)
    next_id = 0
    frag_series: list[float] = []
    largest_series: list[int] = []
    hops: list[int] = []
    failed = 0
    for step, ev in enumerate(trace):
        for cid in [c for c, (_, exp) in allocated.items() if exp <= step]:
            del allocated[cid]
        taken = {d for devs, _ in allocated.values() for d in devs}
        free_names = [n for n in all_names if n not in taken]
        if ev.size:
            devs = pick(grid, free_names, ev.size)
            if devs is None:
                failed += 1
            else:
                allocated[next_id] = (devs, step + ev.lifetime)
                next_id += 1
                cells = {grid.coords[d] for d in devs}
                max_hops, _ = set_compactness(grid, cells)
                hops.append(max_hops)
                if metrics is not None:
                    metrics.compactness.labels(pool).observe(max_hops)
                taken |= set(devs)
                free_names = [n for n in all_names if n not in taken]
        free = {grid.coords[n] for n in free_names}
        # One sweep per step: frag is derived from the same
        # largest-shape result instead of recomputing it.
        _, chips = largest_free_shape(grid, free)
        frag = frag_from_largest(chips, len(free))
        frag_series.append(frag)
        largest_series.append(chips)
        if metrics is not None:
            metrics.frag_score.labels(pool).set(frag)
            metrics.largest_shape.labels(pool).set(chips)
    return {
        "frag_mean": round(statistics.fmean(frag_series), 4),
        "frag_max": round(max(frag_series), 4),
        "frag_final": round(frag_series[-1], 4),
        "largest_shape_mean_chips": round(
            statistics.fmean(largest_series), 2),
        "largest_shape_min_chips": min(largest_series),
        "compactness_mean_hops": round(statistics.fmean(hops), 3)
        if hops else 0.0,
        "compactness_max_hops": max(hops) if hops else 0,
        "allocs": len(hops),
        "alloc_failures": failed,
    }


# -- simulated re-pack (the defrag controller's what-if engine) ---------------


@dataclass(frozen=True)
class RepackMove:
    """One planned relocation: ``claim`` vacates ``cells`` and re-lands
    on ``target`` (both in grid coordinates)."""

    claim: str
    cells: tuple[Coord, ...]
    target: tuple[Coord, ...]


@dataclass(frozen=True)
class RepackPlan:
    """A feasible carve: relocate ``moves`` and the ``goal_shape``
    sub-torus at ``goal_cells`` becomes fully free. ``chips_before`` /
    ``chips_after`` are the largest-free-shape sizes the plan trades
    between (the frag-recovered signal)."""

    moves: tuple[RepackMove, ...]
    goal_shape: tuple[int, int, int]
    goal_cells: frozenset[Coord]
    chips_before: int
    chips_after: int


def _same_node(cells, node_of) -> bool:
    """A relocated claim must land on ONE node: allocation fits per
    node (pkg/scheduler._fit_on_node), so a cross-node destination
    could never actually be committed."""
    if node_of is None:
        return True
    nodes = {node_of.get(c) for c in cells}
    return len(nodes) == 1 and None not in nodes


def _place_displaced(grid: TorusGrid, avail: set[Coord], size: int,
                     node_of=None) -> tuple[Coord, ...] | None:
    """Destination cells for one displaced claim: the most compact
    exact sub-torus placement fully inside ``avail``, falling back to
    a greedy nearest-neighbor set when no box fits."""
    for shape in shapes_for_count(grid, size):
        for cells in placements(grid, shape):
            if all(c in avail for c in cells) and \
                    _same_node(cells, node_of):
                return cells
    for cells in _greedy_sets(grid, avail, size):
        if _same_node(cells, node_of):
            return cells
    return None


def plan_repack(grid: TorusGrid, free: set[Coord],
                allocations: dict[str, set[Coord]],
                movable=None, cost_fn=None, max_moves: int | None = None,
                node_of: dict[Coord, str] | None = None
                ) -> RepackPlan | None:
    """Simulated re-pack: the largest sub-torus shape that can be made
    fully free by relocating at most ``max_moves`` movable claims into
    the remaining free space, and the cheapest way to do it.

    The search walks the protected-shape catalog largest volume first;
    for each placement of a shape it collects the claims squatting on
    it, verifies every one is ``movable`` and re-placeable in the
    space left over, and scores the displacement with ``cost_fn``
    (claim ids -> float; defaults to the claim count). Among feasible
    carves of the winning volume the cheapest (then fewest chips
    moved, then deterministic anchor order) wins -- the 2502.01909
    multi-objective trade: frag recovered vs. migration cost, with
    gang disruption and claim age folded in by the caller's cost_fn.

    Returns None when no shape larger than the current largest free
    shape can be carved within the move budget.
    """
    free = set(free)
    movable = movable if movable is not None else (lambda cid: True)
    cost_fn = cost_fn if cost_fn is not None else \
        (lambda cids: float(len(cids)))
    _, chips_before = largest_free_shape(grid, free)
    cell_owner: dict[Coord, str] = {}
    for cid, cells in allocations.items():
        for c in cells:
            cell_owner[c] = cid
    movable_chips = sum(len(cells) for cid, cells in allocations.items()
                        if movable(cid))
    best: tuple | None = None  # (volume, (cost, moved, cells), shape,
    #                             cells, targets)
    for shape in enumerate_shapes(
            grid, max_chips=len(free) + movable_chips):
        vol = shape[0] * shape[1] * shape[2]
        if vol <= chips_before:
            break  # volume-descending: no gain left below this
        if best is not None and vol < best[0]:
            break  # every shape of the winning volume already judged
        for cells in placements(grid, shape):
            cellset = set(cells)
            if not all(c in free or c in cell_owner for c in cellset):
                continue  # overlaps a device the planner can't model
            owners = sorted({cell_owner[c] for c in cellset
                             if c in cell_owner})
            if not owners or any(not movable(o) for o in owners):
                continue
            if max_moves is not None and len(owners) > max_moves:
                continue
            displaced = set().union(*(allocations[o] for o in owners))
            avail = (free | displaced) - cellset
            targets: dict[str, tuple[Coord, ...]] = {}
            ok = True
            # Relocate biggest claims first: they need the contiguous
            # space the smaller ones would otherwise shred.
            for o in sorted(owners,
                            key=lambda o: (-len(allocations[o]), o)):
                dest = _place_displaced(grid, avail,
                                        len(allocations[o]), node_of)
                if dest is None:
                    ok = False
                    break
                targets[o] = dest
                avail -= set(dest)
            if not ok:
                continue
            key = (cost_fn(tuple(owners)),
                   sum(len(allocations[o]) for o in owners), cells)
            if best is None or vol > best[0] or \
                    (vol == best[0] and key < best[1]):
                best = (vol, key, shape, cells, targets)
    if best is None:
        return None
    _vol, _key, shape, cells, targets = best
    moves = tuple(
        RepackMove(claim=o, cells=tuple(sorted(allocations[o])),
                   target=targets[o])
        for o in sorted(targets))
    projected = (free | set().union(*(allocations[o] for o in targets))
                 ) - set().union(*(set(t) for t in targets.values()))
    _, chips_after = largest_free_shape(grid, projected)
    return RepackPlan(moves=moves, goal_shape=shape,
                      goal_cells=frozenset(cells),
                      chips_before=chips_before,
                      chips_after=chips_after)


def run_placement_bench(topologies=("v5e-16", "v5p-32"), steps: int = 400,
                        seed: int = 20260802, metrics=None) -> dict:
    """First-fit vs. scored on the same trace per topology; the
    structure bench.py flattens into its extras."""
    out: dict = {}
    for topo in topologies:
        grid = grid_for_type(topo)
        trace = make_trace(steps, seed)
        out[topo] = {
            policy: simulate_churn(
                grid, trace, policy=policy, metrics=metrics,
                pool=f"{topo}/{policy}")
            for policy in ("first_fit", "scored")
        }
    return out
