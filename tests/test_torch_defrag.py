"""The port's active defragmentation (``pkg/defrag.py``, the simulator
and re-pack planner of ``pkg/topology/sim.py``, ``DefragMetrics``, the
``defrag`` policy of ``pkg/statemachine.py`` and the scheduler's hint
and veto) against the JAX package's, on the CPU.

- **Scenarios**: every case of ``tests/test_defrag.py`` but two, each
  run once on the JAX side (its ``FakeKubeClient``, ``DraScheduler``,
  ``DefragController``) and once on the port's, from the same hand-made
  coordinated slices and claims (that file's helpers). After every
  scheduler or controller pass each side records its state: each
  claim's allocation and annotations, the move records read back from
  the defrag root (their wall clocks and window ids aside), the
  reservations, the pass counts, the pool's fragmentation point and,
  where the case attaches them, the ``DefragMetrics`` samples (the
  latency histogram by its count). The two sides' records must be
  equal step by step, and the case's own assertions hold on each.
- **The planner**: ``plan_repack`` on the JAX file's grids and on
  seeded random grids gives the same moves, carve and gain on both
  sides; ``make_trace`` and ``simulate_churn`` agree on seeds;
  ``grid_for_type`` agrees on the TPU types the simulator takes.

Not here: ``TestDefragConverges::test_event_driven_convergence`` waits
for the scheduler's event mode (ROADMAP.md §1c item 8), and
``TestDefragInterleaveDFS`` for ``pkg/analysis``'s interleaving
explorer (§1c item 11).
"""

import random
import time

import pytest
from prometheus_client import generate_latest
from prometheus_client.parser import text_string_to_metric_families

from k8s_dra_driver_gpu_tpu.kubeletplugin import checkpoint as jax_ckpt
from k8s_dra_driver_gpu_tpu.pkg import defrag as jax_defrag
from k8s_dra_driver_gpu_tpu.pkg import faults as jax_faults
from k8s_dra_driver_gpu_tpu.pkg import featuregates as jax_fg
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg import metrics as jax_metrics
from k8s_dra_driver_gpu_tpu.pkg import scheduler as jax_sched
from k8s_dra_driver_gpu_tpu.pkg import sliceutil as jax_slices
from k8s_dra_driver_gpu_tpu.pkg.analysis import statemachine as jax_sm
from k8s_dra_driver_gpu_tpu.pkg.topology import grid as jax_grid
from k8s_dra_driver_gpu_tpu.pkg.topology import sim as jax_sim
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import checkpoint as pt_ckpt
from k8s_dra_driver_gpu_tpu_torch.pkg import defrag as pt_defrag
from k8s_dra_driver_gpu_tpu_torch.pkg import exposition
from k8s_dra_driver_gpu_tpu_torch.pkg import faults as pt_faults
from k8s_dra_driver_gpu_tpu_torch.pkg import featuregates as pt_fg
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import metrics as pt_metrics
from k8s_dra_driver_gpu_tpu_torch.pkg import scheduler as pt_sched
from k8s_dra_driver_gpu_tpu_torch.pkg import sliceutil as pt_slices
from k8s_dra_driver_gpu_tpu_torch.pkg import statemachine as pt_sm
from k8s_dra_driver_gpu_tpu_torch.pkg.topology import grid as pt_grid
from k8s_dra_driver_gpu_tpu_torch.pkg.topology import sim as pt_sim
from tests.test_defrag import (DRIVER, OLD_TS, RES, add_node, alloc_devs,
                               apply_class, checkerboard, claim_of,
                               make_claim, node_slices, occupy,
                               protected_rows_layout)

SIDES = ("jax", "pt")
M = {
    "jax": dict(kube=jax_kube, sched=jax_sched, defrag=jax_defrag,
                metrics=jax_metrics, faults=jax_faults, fg=jax_fg,
                slices=jax_slices, ckpt=jax_ckpt, sm=jax_sm,
                latest=generate_latest),
    "pt": dict(kube=pt_kube, sched=pt_sched, defrag=pt_defrag,
               metrics=pt_metrics, faults=pt_faults, fg=pt_fg,
               slices=pt_slices, ckpt=pt_ckpt, sm=pt_sm,
               latest=exposition.generate_latest),
}
# The controller of the JAX file's ``cluster`` fixture.
CTRL = dict(trigger=0.25, release=0.15, sustain_s=0.0, max_concurrent=4,
            deadline_s=60.0, budget_pct=100.0, cooldown_s=0.0)
# Its ``TestProtectionAndPriority._mk``.
PRIO_CTRL = dict(CTRL, trigger=0.2, release=0.1)
# Wall clocks and the window id (a wall clock in ms) differ per run.
CLOCKS = ("plannedAt", "startedAt", "window")


@pytest.fixture(autouse=True)
def clean_faults():
    for side in SIDES:
        M[side]["faults"].reset()
    yield
    for side in SIDES:
        M[side]["faults"].reset()


def test_constants_equal_the_references():
    for name in ("DEFRAG_TARGET_ANNOTATION", "OPT_OUT_ANNOTATION",
                 "PRIORITY_ANNOTATION", "DEFRAG_TRIGGER", "DEFRAG_RELEASE",
                 "DEFRAG_SUSTAIN_S", "DEFRAG_MAX_CONCURRENT",
                 "DEFRAG_DEADLINE_S", "DEFRAG_BUDGET_PCT",
                 "DEFRAG_COOLDOWN_S", "PAUSE_ENV"):
        assert getattr(pt_defrag, name) == getattr(jax_defrag, name), name
    for name in ("DEFRAG_PLANNED", "DEFRAG_DRAINING", "DEFRAG_DEALLOCATED"):
        assert getattr(pt_sm, name) == getattr(jax_sm, name)
    assert pt_sm.DEFRAG_POLICY.allowed == jax_sm.DEFRAG_POLICY.allowed
    assert pt_sim.DEFAULT_SIZES == jax_sim.DEFAULT_SIZES


@pytest.mark.parametrize("claim", [
    {},
    {"metadata": {"annotations": {"resource.tpu.dra/priority": "7"}}},
    {"metadata": {"annotations": {"resource.tpu.dra/priority": "high"}}},
    {"metadata": {"annotations": {"resource.tpu.dra/priority": None}}},
    {"metadata": {"annotations": {
        "resource.tpu.dra/defrag-opt-out": "false"}}},
    {"metadata": {"annotations": {
        "resource.tpu.dra/defrag-opt-out": "yes"}}},
    {"spec": {"devices": {"requests": [
        {"name": "a", "exactly": {"count": 4}},
        {"name": "b", "exactly": {"allocationMode": "All"}},
        {"name": "c", "count": "x"}, {"name": "d", "count": 0}]}}},
])
def test_claim_helpers_alike(claim):
    for fn in ("claim_priority", "demand_priority_of", "claim_opted_out",
               "claim_device_demand"):
        assert getattr(pt_defrag, fn)(claim) == \
            getattr(jax_defrag, fn)(claim), fn


@pytest.mark.parametrize("value", [
    "n1|chip-1,chip-2", "", "n1|", "chip-1,chip-2", "|chip-1",
    "n1|chip-1,,chip-3", "n|a|b"])
def test_parse_target_hint_alike(value):
    assert pt_defrag.parse_target_hint(value) == \
        jax_defrag.parse_target_hint(value)


# -- the planner (pkg/topology/sim.py) ----------------------------------------

def _grid(mod, dims=(4, 4)):
    coords, i = {}, 0
    for y in range(dims[1]):
        for x in range(dims[0]):
            coords[f"chip-{i}"] = (x, y, 0)
            i += 1
    return mod.TorusGrid(dims=(dims[0], dims[1], 1),
                         wrap=(False, False, False), coords=coords)


def _plan(side, dims, free, allocs, **kw):
    mod = jax_sim if side == "jax" else pt_sim
    grid = _grid(jax_grid if side == "jax" else pt_grid, dims)
    plan = mod.plan_repack(grid, set(free), {k: set(v) for k, v in
                                             allocs.items()}, **kw)
    if plan is None:
        return None
    return ([(m.claim, m.cells, m.target) for m in plan.moves],
            plan.goal_shape, sorted(plan.goal_cells), plan.chips_before,
            plan.chips_after)


def _checker(dims=(4, 4)):
    allocs, free = {}, set()
    for y in range(dims[1]):
        for x in range(dims[0]):
            if (x + y) % 2 == 0:
                allocs[f"u-{x}-{y}"] = {(x, y, 0)}
            else:
                free.add((x, y, 0))
    return free, allocs


def _rows_protected():
    allocs = {f"p-{x}-{y}": {(x, y, 0)} for y in (1, 3) for x in range(4)}
    allocs["m-a"] = {(0, 0, 0)}
    allocs["m-b"] = {(0, 2, 0)}
    taken = set().union(*allocs.values())
    free = {(x, y, 0) for y in range(4) for x in range(4)} - taken
    return free, allocs


def _plan_cases():
    """(name, dims, free, allocs, kwargs) of each planner case of the
    JAX file's ``TestPlanRepack``."""
    free, allocs = _checker()
    rows_free, rows = _rows_protected()
    cheap = {k: v for k, v in rows.items() if k.startswith("p-")}
    cheap.update(cheap={(0, 0, 0)}, dear={(0, 2, 0)})
    node_of = {(x, y, 0): ("n0" if y == 0 else "n1")
               for y in range(2) for x in range(4)}
    pair = {"m": {(0, 0, 0), (1, 0, 0)}}
    pair_free = {(2, 0, 0), (3, 0, 0), (0, 1, 0), (1, 1, 0), (2, 1, 0),
                 (3, 1, 0)}
    half = {f"u{y}{x}": {(x, y, 0)} for y in (0, 1) for x in range(4)}
    half_free = {(x, y, 0) for y in (2, 3) for x in range(4)}
    return [
        ("checkerboard_carve", (4, 4), free, allocs, {}),
        ("budget_shrinks_the_carve", (4, 4), free, allocs,
         {"max_moves": 2}),
        ("unmovable_claims_block_their_placements", (4, 4), rows_free,
         rows, {"movable": lambda u: not u.startswith("p-")}),
        ("cost_fn_picks_the_cheaper_victim", (4, 4), rows_free, cheap,
         {"movable": lambda u: u in ("cheap", "dear"),
          "cost_fn": lambda uids: sum(100.0 if u == "dear" else 1.0
                                      for u in uids)}),
        ("node_of_unconstrained", (4, 2), pair_free, pair, {}),
        ("node_of_restricts_targets_to_one_node", (4, 2), pair_free, pair,
         {"node_of": node_of}),
        ("no_gain_returns_none", (4, 4), half_free, half, {}),
    ]


@pytest.mark.parametrize("case", _plan_cases(), ids=lambda c: c[0])
def test_plan_repack_alike(case):
    _, dims, free, allocs, kw = case
    got = {side: _plan(side, dims, free, allocs, **kw) for side in SIDES}
    assert got["pt"] == got["jax"]
    name = case[0]
    if name == "checkerboard_carve":
        moves, _, goal, before, after = got["pt"]
        assert before == 1 and after >= 8
        used = set()
        for _, _, target in moves:
            assert not set(target) & set(goal) and not set(target) & used
            used |= set(target)
    elif name == "budget_shrinks_the_carve":
        assert len(got["pt"][0]) <= 2 and got["pt"][4] >= 4
    elif name == "unmovable_claims_block_their_placements":
        assert {m[0] for m in got["pt"][0]} in ({"m-a"}, {"m-b"})
    elif name == "cost_fn_picks_the_cheaper_victim":
        assert {m[0] for m in got["pt"][0]} == {"cheap"}
    elif name == "node_of_unconstrained":
        assert got["pt"] is not None
    elif name in ("node_of_restricts_targets_to_one_node",
                  "no_gain_returns_none"):
        assert got["pt"] is None


@pytest.mark.parametrize("seed", range(12))
def test_plan_repack_alike_on_random_grids(seed):
    """Random occupancy of a random pool: single and multi-chip claims,
    some unmovable, a budget, a cost over the ids and a node split."""
    rng = random.Random(seed)
    dims = rng.choice([(2, 2), (4, 2), (4, 4), (8, 4), (4, 8)])
    cells = [(x, y, 0) for y in range(dims[1]) for x in range(dims[0])]
    rng.shuffle(cells)
    allocs, i = {}, 0
    while cells and rng.random() < 0.8:
        size = min(rng.choice([1, 1, 1, 2]), len(cells))
        allocs[f"c{i}"] = {cells.pop() for _ in range(size)}
        i += 1
    free = set(cells)
    pinned = {k for k in allocs if rng.random() < 0.2}
    weights = {k: rng.uniform(0.5, 3.0) for k in allocs}
    node_of = ({c: f"n{c[1] // 2}" for y in range(dims[1])
                for x in range(dims[0]) for c in [(x, y, 0)]}
               if rng.random() < 0.5 else None)
    kw = {"movable": lambda u: u not in pinned,
          "cost_fn": lambda uids: round(sum(weights[u] for u in uids), 6),
          "max_moves": rng.choice([None, 1, 2, 4]), "node_of": node_of}
    assert _plan("pt", dims, free, allocs, **kw) == \
        _plan("jax", dims, free, allocs, **kw)


@pytest.mark.parametrize("seed", [0, 1, 20260802])
def test_make_trace_and_simulate_churn_alike(seed):
    trace = pt_sim.make_trace(150, seed)
    assert [(e.size, e.lifetime) for e in trace] == \
        [(e.size, e.lifetime) for e in jax_sim.make_trace(150, seed)]
    jtrace = jax_sim.make_trace(150, seed)
    for topo in ("v5e-16", "v5p-32"):
        for policy in ("first_fit", "scored"):
            sinks = {"jax": jax_metrics.PlacementMetrics(),
                     "pt": pt_metrics.PlacementMetrics()}
            got = {
                "jax": jax_sim.simulate_churn(
                    jax_sim.grid_for_type(topo), jtrace, policy=policy,
                    metrics=sinks["jax"], pool=topo),
                "pt": pt_sim.simulate_churn(
                    pt_sim.grid_for_type(topo), trace, policy=policy,
                    metrics=sinks["pt"], pool=topo)}
            assert got["pt"] == got["jax"], (topo, policy)
            assert samples("pt", sinks["pt"].registry) == \
                samples("jax", sinks["jax"].registry)


@pytest.mark.parametrize("topology", [
    "v5e-1", "v5e-4", "v5e-16", "v5e-256", "v5e-12", "v6e-8", "v4-8",
    "v5p-32", "v5p-1024", "v5p-6"])
def test_grid_for_type_alike(topology):
    a, b = pt_sim.grid_for_type(topology), jax_sim.grid_for_type(topology)
    assert (a.dims, a.wrap, a.coords) == (b.dims, b.wrap, b.coords)


@pytest.mark.parametrize("bad", ["h100-8", "v5e", "v7-4", "v5p-1", ""])
def test_grid_for_type_refuses_alike(bad):
    for mod in (pt_sim, jax_sim):
        with pytest.raises(ValueError, match="unknown accelerator type"):
            mod.grid_for_type(bad)


def test_placement_bench_alike():
    assert pt_sim.run_placement_bench(steps=80, seed=3) == \
        jax_sim.run_placement_bench(steps=80, seed=3)


# -- the controller, both sides -----------------------------------------------

def value(metric) -> float:
    """A counter's (or a labelled child's) value, on either registry."""
    if hasattr(metric, "_value"):
        return metric._value.get()
    return metric.value if hasattr(metric, "value") else \
        metric._own().value


def samples(side, registry):
    """The registry's samples, histograms by their count (the
    latencies differ from run to run)."""
    text = M[side]["latest"](registry).decode()
    out = []
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            if fam.type == "histogram" and not s.name.endswith("_count"):
                continue
            out.append((s.name, tuple(sorted(s.labels.items())), s.value))
    return sorted(out)


class Side:
    """One side's cluster: a 4x4 (or ``dims``) coordinated pool on
    ``node-a``, a scheduler with first-fit placement and a defrag
    controller attached, as the JAX file's ``cluster`` fixture builds
    them. ``snap(label)`` records the side's state."""

    def __init__(self, side, tmp_path, ctrl_kw=CTRL, dims=(4, 4),
                 metrics=False):
        self.side, self.m = side, M[side]
        self.root = str(tmp_path / f"defrag-{side}")
        self.ctrl_kw = dict(ctrl_kw)
        self.kube = self.m["kube"].FakeKubeClient()
        apply_class(self.kube)
        add_node(self.kube, "node-a")
        self.m["slices"].publish_resource_slices(
            self.kube, node_slices("node-a", dims))
        self.sched = self.m["sched"].DraScheduler(
            self.kube, gates=self.m["fg"].FeatureGates.parse(
                "TopologyAwarePlacement=false"))
        self.metrics = self.m["metrics"].DefragMetrics() if metrics \
            else None
        self.ctrl = self.controller()
        self.sched.attach_defrag(self.ctrl)
        self.trace = []

    def controller(self, **kw):
        return self.m["defrag"].DefragController(
            self.kube, self.root, metrics=self.metrics,
            **dict(self.ctrl_kw, **kw))

    def frag(self):
        snap = self.sched.fleet.snapshot()
        entry = snap["pools"].get(f"{DRIVER}/node-a") or {}
        return entry.get("current") or {}

    def state(self):
        claims = {}
        for c in self.kube.list(*RES, "resourceclaims"):
            md = c["metadata"]
            ann = {k: v for k, v in (md.get("annotations") or {}).items()
                   if k != "resource.tpu.dra/traceparent"}
            alloc = c.get("status", {}).get("allocation")
            claims[md["name"]] = (
                md.get("uid"), ann, None if not alloc else sorted(
                    (r["pool"], r["device"])
                    for r in alloc["devices"]["results"]))
        records = {}
        for uid, rec in self.ctrl._checkpoint.get().claims.items():
            live = {k: v for k, v in (rec.devices[0].live or {}).items()
                    if k not in CLOCKS}
            records[uid] = (rec.namespace, rec.name, rec.state, live)
        point = self.frag()
        return {
            "claims": claims, "records": records,
            "reservations": sorted(self.ctrl.reservations().items()),
            "active": self.ctrl.active_moves(),
            "busy": self.ctrl.busy(),
            "last_sync": self.ctrl.last_sync,
            "frag": (point.get("fragmentation_score"),
                     point.get("largest_free_shape")),
            "metrics": (samples(self.side, self.metrics.registry)
                        if self.metrics is not None else None),
        }

    def snap(self, label):
        self.trace.append((label, self.state()))

    def sync(self, passes=1):
        for i in range(passes):
            self.sched.sync_once()
            self.snap(f"pass {i}")

    def ctrl_sync(self, label="ctrl"):
        self.ctrl.sync_once()
        self.snap(label)


def run_both(scenario, tmp_path, **kw):
    """``scenario(side)`` on each side; their traces, asserted equal step
    by step; the port's Side."""
    sides = {}
    for name in SIDES:
        s = Side(name, tmp_path / name, **kw)
        scenario(s)
        sides[name] = s
    jt, pt = sides["jax"].trace, sides["pt"].trace
    assert [label for label, _ in pt] == [label for label, _ in jt]
    for (label, got), (_, want) in zip(pt, jt):
        for key in want:
            assert got[key] == want[key], (label, key)
    return sides["pt"]


def _claims_consistent(s, survivors):
    seen = []
    for name in survivors:
        devs = alloc_devs(s.kube, name)
        assert devs and len(devs) == 1
        seen += devs
        ann = claim_of(s.kube, name).get("metadata", {}).get(
            "annotations") or {}
        assert jax_defrag.DEFRAG_TARGET_ANNOTATION not in ann
    assert len(seen) == len(set(seen))


# TestDefragConverges ---------------------------------------------------------

def test_checkerboard_converges_to_large_free_shape(tmp_path):
    def sc(s):
        survivors = checkerboard(s.kube, s.sched)
        s.sync()
        assert s.frag()["fragmentation_score"] >= 0.25
        s.sync(10)
        point = s.frag()
        assert point["fragmentation_score"] <= 0.15
        assert point["largest_free_shape"] >= 8
        assert s.ctrl.active_moves() == {}
        assert s.ctrl.reservations() == {}
        _claims_consistent(s, survivors)
    run_both(sc, tmp_path)


def test_moved_claims_land_on_planned_targets(tmp_path):
    def sc(s):
        checkerboard(s.kube, s.sched)
        s.sync()
        records = s.ctrl._checkpoint.get().claims
        assert records
        targets = {rec.name: (rec.devices[0].live or {}).get("target")
                   for rec in records.values()}
        s.sync(10)
        for name, target in targets.items():
            assert alloc_devs(s.kube, name) == sorted(target)
    run_both(sc, tmp_path)


def test_quiet_pool_executes_zero_moves(tmp_path):
    def sc(s):
        occupy(s.kube, s.sched, {f"c{i}": {"chips": [i]} for i in range(8)})
        s.sync(6)
        assert s.frag()["fragmentation_score"] == 0.0
        assert s.ctrl.active_moves() == {}
        assert value(s.metrics.plans) == 0
        assert value(s.metrics.moves) == 0
    run_both(sc, tmp_path, metrics=True)


def test_sustain_defers_until_window_elapses(tmp_path):
    def sc(s):
        checkerboard(s.kube, s.sched)
        s.sync()
        assert s.ctrl.active_moves() == {}  # armed, not sustained
        time.sleep(0.45)
        s.sync()
        assert s.ctrl.active_moves() != {}
    run_both(sc, tmp_path, ctrl_kw=dict(CTRL, sustain_s=0.4))


def test_pause_stops_new_windows(tmp_path, monkeypatch):
    def sc(s):
        checkerboard(s.kube, s.sched)
        monkeypatch.setenv("TPU_DRA_DEFRAG_PAUSE", "1")
        s.sync(4)
        assert s.ctrl.active_moves() == {}
        monkeypatch.delenv("TPU_DRA_DEFRAG_PAUSE")
        s.sync(10)
        assert s.frag()["fragmentation_score"] <= 0.15
    run_both(sc, tmp_path)


def test_budget_caps_moves_per_window(tmp_path):
    def sc(s):
        checkerboard(s.kube, s.sched)
        s.sync()
        assert 0 < len(s.ctrl.active_moves()) <= 2
        for _ in range(20):
            assert len(s.ctrl.active_moves()) <= 2
            s.sync()
        assert s.ctrl.active_moves() == {}
        assert s.frag()["largest_free_shape"] >= 4
    run_both(sc, tmp_path, ctrl_kw=dict(CTRL, max_concurrent=8,
                                        budget_pct=30.0))


# TestProtectionAndPriority ---------------------------------------------------

def _protected(s, layout, passes=4):
    occupy(s.kube, s.sched, layout)
    s.sync(passes)


def test_opt_out_claims_are_never_moved(tmp_path):
    opt = {jax_defrag.OPT_OUT_ANNOTATION: "true"}

    def sc(s):
        layout = protected_rows_layout(extra_a=opt, extra_b=opt)
        _protected(s, layout)
        assert s.ctrl.active_moves() == {}
        for name in layout:
            assert alloc_devs(s.kube, name) is not None
    run_both(sc, tmp_path, ctrl_kw=PRIO_CTRL)


def test_infeasible_pool_cools_down_instead_of_resweeping(tmp_path):
    opt = {jax_defrag.OPT_OUT_ANNOTATION: "true"}

    def sc(s):
        s.ctrl.cooldown_s = 300.0
        occupy(s.kube, s.sched, protected_rows_layout(extra_a=opt,
                                                      extra_b=opt))
        s.sync()
        assert s.ctrl.active_moves() == {}
        assert s.ctrl._cooldown_until.get((DRIVER, "node-a"), 0) > \
            time.time()
        calls = []
        real = s.ctrl._plan_pool
        s.ctrl._plan_pool = lambda *a, **kw: calls.append(1) or real(
            *a, **kw)
        s.sync(3)
        assert calls == []
    run_both(sc, tmp_path, ctrl_kw=PRIO_CTRL)


def test_young_singleton_moves_before_old_claim(tmp_path):
    def sc(s):
        occupy(s.kube, s.sched, protected_rows_layout(created_a=OLD_TS))
        old_devs = alloc_devs(s.kube, "vic-a")
        s.sync()
        assert set(s.ctrl.active_moves()) != set()
        s.sync(8)
        assert s.ctrl.active_moves() == {}
        assert alloc_devs(s.kube, "vic-a") == old_devs
        assert alloc_devs(s.kube, "vic-b") != ["chip-8"]
    run_both(sc, tmp_path, ctrl_kw=PRIO_CTRL)


def test_old_gang_survives_young_singleton(tmp_path):
    def sc(s):
        layout = protected_rows_layout(created_a=OLD_TS, gang_a="gang-1")
        layout["vic-a2"] = {"chips": [2], "gang": "gang-1",
                            "created": OLD_TS}
        occupy(s.kube, s.sched, layout)
        old_devs = alloc_devs(s.kube, "vic-a")
        s.sync(8)
        assert s.ctrl.active_moves() == {}
        assert alloc_devs(s.kube, "vic-a") == old_devs
        assert alloc_devs(s.kube, "vic-b") != ["chip-8"]
    run_both(sc, tmp_path, ctrl_kw=PRIO_CTRL)


def _prio(value):
    return {jax_defrag.PRIORITY_ANNOTATION: value}


def test_priority_claims_immune_without_demand(tmp_path):
    def sc(s):
        _protected(s, protected_rows_layout(extra_a=_prio("5"),
                                            extra_b=_prio("5")))
        assert s.ctrl.active_moves() == {}
        assert alloc_devs(s.kube, "vic-a") == ["chip-0"]
        assert alloc_devs(s.kube, "vic-b") == ["chip-8"]
    run_both(sc, tmp_path, ctrl_kw=PRIO_CTRL)


def test_higher_priority_demand_preempts_lower(tmp_path):
    def sc(s):
        occupy(s.kube, s.sched, protected_rows_layout(
            extra_a=_prio("5"), extra_b=_prio("5")))
        make_claim(s.kube, "demand", count=4, same_row=True,
                   annotations=_prio("10"))
        s.sync()
        assert alloc_devs(s.kube, "demand") is None
        s.sync(10)
        assert s.ctrl.active_moves() == {}
        devs = alloc_devs(s.kube, "demand")
        assert devs and len(devs) == 4
        assert len({int(d.split("-")[1]) // 4 for d in devs}) == 1
    run_both(sc, tmp_path, ctrl_kw=PRIO_CTRL)


def test_malformed_priority_fails_closed(tmp_path):
    def sc(s):
        _protected(s, protected_rows_layout(extra_a=_prio("high"),
                                            extra_b=_prio("not-a-number")))
        assert s.ctrl.active_moves() == {}
        assert alloc_devs(s.kube, "vic-a") == ["chip-0"]
        assert alloc_devs(s.kube, "vic-b") == ["chip-8"]
    run_both(sc, tmp_path, ctrl_kw=PRIO_CTRL)


@pytest.mark.parametrize("demand", ["very-high", "5"],
                         ids=["malformed_demand_priority_has_no_power",
                              "equal_priority_demand_does_not_preempt"])
def test_demand_without_strictly_higher_priority_moves_nothing(
        tmp_path, demand):
    def sc(s):
        occupy(s.kube, s.sched, protected_rows_layout(
            extra_a=_prio("5"), extra_b=_prio("5")))
        make_claim(s.kube, "demand", count=4, same_row=True,
                   annotations=_prio(demand))
        s.sync(4)
        assert s.ctrl.active_moves() == {}
        assert alloc_devs(s.kube, "demand") is None
        assert alloc_devs(s.kube, "vic-a") == ["chip-0"]
        assert alloc_devs(s.kube, "vic-b") == ["chip-8"]
    run_both(sc, tmp_path, ctrl_kw=PRIO_CTRL)


# TestSchedulerIntegration ----------------------------------------------------

def test_reserved_devices_vetoed_for_other_claims(tmp_path):
    def sc(s):
        checkerboard(s.kube, s.sched)
        s.sync()
        assert s.ctrl.reservations()
        make_claim(s.kube, "intruder")
        s.sync()
        assert alloc_devs(s.kube, "intruder") is None
        s.sync(10)
        assert s.ctrl.active_moves() == {}
        assert alloc_devs(s.kube, "intruder") is not None
    run_both(sc, tmp_path)


def test_abort_clears_hint_and_claim_reschedules(tmp_path):
    def sc(s):
        checkerboard(s.kube, s.sched)
        s.ctrl.deadline_s = 0.05
        s.ctrl.cooldown_s = 30.0
        s.sync()            # plan
        s.ctrl_sync()       # drain
        s.ctrl_sync()       # dealloc
        assert s.ctrl.active_moves()
        time.sleep(0.06)
        s.ctrl_sync()       # deadline -> abort
        assert s.ctrl.active_moves() == {}
        assert s.ctrl.reservations() == {}
        for claim in s.kube.list(*RES, "resourceclaims"):
            assert jax_defrag.DEFRAG_TARGET_ANNOTATION not in (
                claim["metadata"].get("annotations") or {})
        s.sync(2)
        for claim in s.kube.list(*RES, "resourceclaims"):
            assert claim.get("status", {}).get("allocation")
        assert s.ctrl._aborted_windows == set()
    run_both(sc, tmp_path)


def _backdate(s, **clocks):
    for uid, rec in list(s.ctrl._checkpoint.get().claims.items()):
        meta = dict(rec.devices[0].live or {})
        for key, delta in clocks.items():
            meta[key] = (time.time() if key == "startedAt"
                         else meta[key]) - delta
        s.ctrl._write_record(
            {"metadata": {"uid": uid, "namespace": rec.namespace,
                          "name": rec.name}}, rec.state, live=meta)


def test_stuck_draining_move_aborts_at_deadline(tmp_path):
    def sc(s):
        checkerboard(s.kube, s.sched)
        s.ctrl.cooldown_s = 30.0
        s.sync()            # plan
        s.ctrl_sync()       # drain: Draining
        assert set(s.ctrl.active_moves().values()) == {"DefragDraining"}
        s.ctrl.deadline_s = 5.0
        _backdate(s, startedAt=60.0)
        s.ctrl_sync()
        assert s.ctrl.active_moves() == {}
        assert s.ctrl.reservations() == {}
        for claim in s.kube.list(*RES, "resourceclaims"):
            assert jax_defrag.DEFRAG_TARGET_ANNOTATION not in (
                claim["metadata"].get("annotations") or {})
    run_both(sc, tmp_path)


def test_deadline_runs_from_admission_not_plan_time(tmp_path):
    def sc(s):
        s.ctrl.deadline_s = 5.0
        checkerboard(s.kube, s.sched)
        s.sync()            # plan
        s.ctrl_sync()       # admit: Draining, startedAt now
        assert len(s.ctrl._checkpoint.get().claims) == 4
        _backdate(s, plannedAt=60.0)
        s.sync(10)
        assert s.ctrl.active_moves() == {}
        assert value(s.metrics.aborted) == 0
        assert value(s.metrics.moves) == 4
        assert s.frag()["fragmentation_score"] <= 0.15
    run_both(sc, tmp_path, metrics=True)


# TestDefragDurability --------------------------------------------------------

@pytest.mark.parametrize("point", ["defrag.sync", "defrag.plan",
                                   "defrag.drain", "defrag.dealloc"])
def test_controller_crash_resumes_idempotently(tmp_path, point):
    """An ``InjectedCrash`` at each fault point, then a fresh controller
    on the same root resumes the window from the durable records."""
    def sc(s):
        survivors = checkerboard(s.kube, s.sched)
        crash = s.m["faults"].InjectedCrash
        with s.m["faults"].inject(point, mode="crash", count=1):
            crashed = False
            for i in range(6):
                try:
                    s.sched.sync_once()
                except crash:
                    crashed = True
                    break
                s.snap(f"before crash {i}")
            assert crashed, f"{point} never fired"
        s.snap("crashed")
        resumed = s.controller()
        if resumed.active_moves():
            assert resumed.reservations()
        s.ctrl = resumed
        s.sched.attach_defrag(resumed)
        s.snap("resumed")
        s.sync(12)
        assert s.frag()["fragmentation_score"] <= 0.15
        assert resumed.active_moves() == {}
        _claims_consistent(s, survivors)
    run_both(sc, tmp_path)


def test_claim_deleted_mid_move_cancels(tmp_path):
    def sc(s):
        checkerboard(s.kube, s.sched)
        s.sync()
        moving = sorted(s.ctrl.active_moves())
        assert moving
        rec = s.ctrl._checkpoint.get().claims[moving[0]]
        s.kube.delete(*RES, "resourceclaims", rec.name, namespace="default")
        s.sync(8)
        assert s.ctrl.active_moves() == {}
    run_both(sc, tmp_path)


@pytest.mark.parametrize("side", SIDES)
def test_illegal_stage_skip_fails_the_commit(tmp_path, side):
    """absent -> Draining is refused by the defrag policy (the JAX
    group commit wraps the refusal in a RuntimeError; the port raises
    it), then every legal stage commits."""
    m = M[side]
    ctrl = m["defrag"].DefragController(m["kube"].FakeKubeClient(),
                                        str(tmp_path / "d"))
    dev = [m["ckpt"].CheckpointedDevice(canonical_name="defrag",
                                        kind="defrag", live={})]

    def rec(state):
        return m["ckpt"].CheckpointedClaim(uid="u1", namespace="default",
                                           name="c", state=state,
                                           devices=dev)
    with pytest.raises(RuntimeError) as err:
        ctrl._checkpoint.update_claim("u1", rec(m["sm"].DEFRAG_DRAINING))
    refusal = err.value if side == "pt" else err.value.__cause__
    assert isinstance(refusal, m["sm"].CheckpointTransitionError)
    for state in (m["sm"].DEFRAG_PLANNED, m["sm"].DEFRAG_DRAINING,
                  m["sm"].DEFRAG_DEALLOCATED):
        ctrl._checkpoint.update_claim("u1", rec(state))
    ctrl._checkpoint.update_claim("u1", None)
    assert ctrl._checkpoint.get().claims == {}


# TestDefragMetrics -----------------------------------------------------------

def test_exposition(tmp_path):
    def sc(s):
        checkerboard(s.kube, s.sched)
        s.sync(10)
        text = s.m["latest"](s.metrics.registry).decode()
        for line in ("tpu_dra_defrag_plans_total 1.0",
                     "tpu_dra_defrag_moves_total 4.0",
                     "tpu_dra_defrag_frag_recovered_chips_total 7.0",
                     "tpu_dra_defrag_aborted_total 0.0",
                     "tpu_dra_defrag_active_moves 0.0",
                     "tpu_dra_defrag_move_seconds_count 4.0"):
            assert line in text
    pt = run_both(sc, tmp_path, metrics=True)
    # Line by line, the latencies' buckets and sum aside.
    texts = {}
    for side in SIDES:
        metrics = M[side]["metrics"].DefragMetrics()
        metrics.plans.inc()
        metrics.moves.inc(4)
        metrics.frag_recovered.inc(7)
        metrics.move_seconds.observe(0.3)
        texts[side] = [line for line in M[side]["latest"](
            metrics.registry).decode().splitlines()
            if "_created" not in line]
    assert texts["pt"] == texts["jax"]
    assert pt.metrics is not None


# -- GPU pools: nothing to plan -----------------------------------------------

def test_uncoordinated_pool_plans_nothing(tmp_path):
    """The port's GPU slices publish no ICI coordinates: the pool has no
    grid, so a fired pool plans no window, on either side."""
    for side in SIDES:
        m = M[side]
        kube = m["kube"].FakeKubeClient()
        apply_class(kube)
        add_node(kube, "node-a")
        slices = node_slices("node-a")
        for dev in slices[0]["spec"]["devices"]:
            for key in ("iciX", "iciY", "topology"):
                dev["attributes"].pop(key)
        m["slices"].publish_resource_slices(kube, slices)
        ctrl = m["defrag"].DefragController(kube, str(tmp_path / side),
                                            **CTRL)
        claims = kube.list(*RES, "resourceclaims")
        assert ctrl._pool_model((DRIVER, "node-a"),
                                kube.list(*RES, "resourceslices"),
                                claims) is None
        assert ctrl._plan_pool((DRIVER, "node-a"), claims,
                               kube.list(*RES, "resourceslices"), [],
                               {"planned": 0}) is False
