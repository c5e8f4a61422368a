"""The port's fleet telemetry state (``pkg/fleetstate.py``) and its
metrics sink against the JAX package's, on the CPU.

The same ResourceSlices and claims go into each package's
``InventorySnapshot`` and ``AllocationState``, and each package's
``FleetAggregator`` folds them; the points a pass returns, the snapshot
(``/debug/fleet``'s JSON), ``frag_signal`` and ``pending_recent``, and
the ``FleetMetrics`` exposition (parsed; the fold-time histogram by its
count, its times being the host's) must be equal after every pass.
``time.time`` is one fixed clock on both sides, so the timestamps and
the power-carry TTL agree. The cases are ``tests/test_fleetstate.py``'s
(the tenant-demand case with a stub store: the port has no profile store
yet), plus seeded random fleets (numpy): nodes, grids, telemetry
attributes that come and go (the power carry), power caps, partition
slots, allocations and pending counts, pass after pass. The scheduler's
wiring: a full pass folds, the first fold installs the process default,
a failing fold never fails the pass, and the port scheduler over the
JAX fleet's store gives the JAX scheduler's fleet snapshot.
"""

import json
import time

import numpy as np
import pytest
from prometheus_client import generate_latest
from prometheus_client.parser import text_string_to_metric_families

from k8s_dra_driver_gpu_tpu.pkg import fleetstate as jax_fleet
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg import metrics as jax_metrics
from k8s_dra_driver_gpu_tpu.pkg import schedcache as jax_cache
from k8s_dra_driver_gpu_tpu.pkg import scheduler as jax_sched
from k8s_dra_driver_gpu_tpu_torch.pkg import exposition
from k8s_dra_driver_gpu_tpu_torch.pkg import fleetstate as pt_fleet
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import metrics as pt_metrics
from k8s_dra_driver_gpu_tpu_torch.pkg import schedcache as pt_cache
from k8s_dra_driver_gpu_tpu_torch.pkg import scheduler as pt_sched

RES = ("resource.k8s.io", "v1")
MOD = {"jax": (jax_fleet, jax_cache, jax_metrics, generate_latest),
       "pt": (pt_fleet, pt_cache, pt_metrics, exposition.generate_latest)}
SIDES = ("jax", "pt")


@pytest.fixture(autouse=True)
def fixed_clock(monkeypatch):
    """One wall clock for both folds; ``clock.now`` moves it."""
    class Clock:
        now = 1_000_000.0

        def __call__(self):
            return self.now
    clock = Clock()
    monkeypatch.setattr(time, "time", clock)
    saved = {s: MOD[s][0].default_fleet() for s in SIDES}
    yield clock
    for s in SIDES:
        MOD[s][0].set_default_fleet(saved[s])


def test_constants_equal_the_references():
    for name in ("ATTR_POWER", "ATTR_TEMP", "ATTR_DUTY", "ATTR_HBM",
                 "ATTR_ICI_ERR", "TELEMETRY_ATTRS", "DEFAULT_RING_SAMPLES",
                 "DEFAULT_FLEET_HISTORY", "POWER_SAMPLE_TTL_S"):
        assert getattr(pt_fleet, name) == getattr(jax_fleet, name), name


def make_slice(node="n0", chips=4, telemetry=True, gen=1, grid=(2, 2),
               driver="tpu.dra.dev", tele=None, cap=None, name=None):
    devices = []
    for i in range(chips):
        attrs = {
            "iciX": {"int": i % grid[0]},
            "iciY": {"int": (i // grid[0]) % grid[1]},
            "iciZ": {"int": 0},
            "topology": {"string": f"{grid[0]}x{grid[1]}"},
        }
        if telemetry:
            vals = (tele or {}).get(i, {
                jax_fleet.ATTR_POWER: 120, jax_fleet.ATTR_TEMP: 55,
                jax_fleet.ATTR_DUTY: 80, jax_fleet.ATTR_HBM: 10,
                jax_fleet.ATTR_ICI_ERR: 3})
            attrs.update({k: {"int": v} for k, v in vals.items()})
        if cap is not None:
            attrs["powerCapWatts"] = {"int": cap}
        devices.append({"name": f"chip-{i}", "attributes": attrs,
                        "capacity": {}})
    return {
        "metadata": {"name": name or f"{node}-slice"},
        "spec": {
            "driver": driver, "nodeName": node,
            "pool": {"name": node, "generation": gen,
                     "resourceSliceCount": 1},
            "devices": devices,
        },
    }


def allocated_claim(uid, devices, node="n0", driver="tpu.dra.dev"):
    return {
        "metadata": {"uid": uid, "namespace": "default", "name": uid},
        "status": {"allocation": {"devices": {"results": [
            {"request": "tpu", "driver": driver, "pool": node,
             "device": d} for d in devices]}}},
    }


def samples(side, registry):
    """A registry's samples, parsed; the fold-time histogram by count."""
    text = MOD[side][3](registry).decode()
    out = []
    for fam in text_string_to_metric_families(text):
        for s in fam.samples:
            if s.name.endswith("_created"):
                continue
            if s.name.startswith("tpu_dra_fleet_fold_seconds") and \
                    not s.name.endswith("_count"):
                continue
            out.append((s.name, tuple(sorted(s.labels.items())), s.value))
    return sorted(out)


def plain_json(doc):
    """A document as plain JSON (tuple keys joined by "/"), for the
    comparison; ``ts`` is the fixed clock on both sides, compared."""
    if isinstance(doc, dict):
        return {"/".join(k) if isinstance(k, tuple) else k: plain_json(v)
                for k, v in doc.items()}
    if isinstance(doc, (list, tuple)):
        return [plain_json(v) for v in doc]
    return doc


class Pair:
    """A FleetAggregator on each side over the same inputs."""

    def __init__(self, history=0):
        self.metrics = {s: MOD[s][2].FleetMetrics() for s in SIDES}
        self.fleets = {s: MOD[s][0].FleetAggregator(
            metrics=self.metrics[s], history=history) for s in SIDES}

    def fold(self, slices, claims=(), pending=0):
        points = {}
        for s in SIDES:
            cache = MOD[s][1]
            snap = cache.InventorySnapshot(json.loads(json.dumps(slices)))
            alloc = cache.AllocationState(snap)
            alloc.rebuild(json.loads(json.dumps(list(claims))))
            points[s] = self.fleets[s].observe_pass(snap, alloc, pending)
        assert plain_json(points["pt"]) == plain_json(points["jax"])
        self.check()
        return points["pt"]

    def check(self):
        a, b = (plain_json(self.fleets[s].snapshot()) for s in SIDES)
        assert b == a
        _, _, body_j = self.fleets["jax"].fleet_endpoint()
        status, ctype, body_p = self.fleets["pt"].fleet_endpoint()
        assert (status, ctype) == (200, "application/json")
        assert json.loads(body_p) == json.loads(body_j)
        for n in (1, 3, 5):
            assert self.fleets["pt"].pending_recent(n) == \
                self.fleets["jax"].pending_recent(n)
        assert samples("pt", self.metrics["pt"].registry) == \
            samples("jax", self.metrics["jax"].registry)

    def frag(self, *args, **kw):
        got = {s: self.fleets[s].frag_signal(*args, **kw) for s in SIDES}
        assert got["pt"] == got["jax"]
        return got["pt"]


KEY = ("tpu.dra.dev", "n0")


# -- tests/test_fleetstate.py's cases ------------------------------------------

def test_pool_utilization_and_frag():
    point = Pair().fold([make_slice()],
                        [allocated_claim("u1", ["chip-0", "chip-1"])], 3)
    p = point[KEY]
    assert (p["total_devices"], p["allocated_devices"], p["utilization"],
            p["largest_free_shape"], p["fragmentation_score"]) == \
        (4, 2, 0.5, 2, 0.0)


def test_node_telemetry_folded_from_attrs():
    pair = Pair()
    pair.fold([make_slice()])
    node = pair.fleets["pt"].snapshot()["nodes"]["n0"]
    assert (node["power_watts"], node["temp_celsius"],
            node["duty_pct_mean"], node["ici_link_errors"]) == \
        (480, 55, 80.0, 12)


def test_node_spanning_two_pools_folds_once():
    pair = Pair()
    pair.fold([make_slice(), make_slice(driver="alt.tpu.dra.dev",
                                        name="n0-slice-alt")])
    node = pair.fleets["pt"].snapshot()["nodes"]["n0"]
    assert (node["chips"], node["power_watts"]) == (8, 960)


def test_telemetry_less_pool_has_no_node_entry():
    pair = Pair()
    pair.fold([make_slice(telemetry=False)])
    assert pair.fleets["pt"].snapshot()["nodes"] == {}


def test_history_ring_bounded():
    pair = Pair(history=16)
    for _ in range(40):
        pair.fold([make_slice()])
    assert len(pair.fleets["pt"].snapshot()["pools"]["tpu.dra.dev/n0"][
        "history"]) == 16
    assert pair.fleets["pt"].passes_total == 40


def test_metrics_pruned_when_pool_and_node_vanish():
    pair = Pair()
    pair.fold([make_slice()], pending=2)
    text = exposition.generate_latest(pair.metrics["pt"].registry).decode()
    assert 'node="n0"' in text
    pair.fold([])
    text = exposition.generate_latest(pair.metrics["pt"].registry).decode()
    assert 'pool="tpu.dra.dev/n0"' not in text and 'node="n0"' not in text


def test_empty_fleet_endpoint():
    Pair().check()


def test_fold_seconds_histogram_observed():
    pair = Pair()
    pair.fold([make_slice()])
    text = exposition.generate_latest(pair.metrics["pt"].registry).decode()
    assert "tpu_dra_fleet_fold_seconds_count 1.0" in text


def _partition_slice():
    s = make_slice(telemetry=False)
    for k in range(2):
        s["spec"]["devices"].append({
            "name": f"pt-web-s4-{k}",
            "attributes": {"oversubscribeSlots": {"int": 4}},
            "capacity": {}})
    return s


def test_partition_slot_occupancy_folded():
    point = Pair().fold(
        [_partition_slice()],
        [allocated_claim(f"t{i}", ["pt-web-s4-0"]) for i in range(3)]
        + [allocated_claim("t9", ["pt-web-s4-1"])])
    assert point[KEY]["partition_slot_occupancy"] == 0.5


def test_chip_only_pool_has_no_occupancy():
    point = Pair().fold([make_slice(telemetry=False)])
    assert point[KEY]["partition_slot_occupancy"] is None


def test_pending_ring_and_recent():
    pair = Pair()
    for pending in (0, 7, 2):
        pair.fold([make_slice(telemetry=False)], pending=pending)
    assert pair.fleets["pt"].pending_recent() == 7


def test_tenant_demand_surfaces_when_store_attached():
    class Store:
        def percentiles(self):
            return {"web": {"p95_hbm_bytes": 10 << 30}}
    pair = Pair()
    for f in pair.fleets.values():
        f.attach_profile_store(Store())
    pair.check()
    assert pair.fleets["pt"].snapshot()["tenant_demand"]["web"][
        "p95_hbm_bytes"] == 10 << 30


def _diag_pair(allocated):
    pair = Pair()
    pair.fold([make_slice()], [allocated_claim(f"u{i}", [c])
                               for i, c in enumerate(allocated)])
    return pair


def test_frag_arms_then_fires_after_sustain():
    pair = _diag_pair(["chip-0", "chip-3"])
    assert not pair.frag(0.4, 0.1, sustain_s=60.0, now=1000.0)[KEY]["fire"]
    assert not pair.frag(0.4, 0.1, sustain_s=60.0, now=1059.0)[KEY]["fire"]
    assert pair.frag(0.4, 0.1, sustain_s=60.0, now=1061.0)[KEY]["fire"]


def test_frag_demand_fires_immediately():
    pair = _diag_pair(["chip-0", "chip-3"])
    assert pair.frag(0.4, 0.1, sustain_s=3600.0, demand={KEY},
                     now=1000.0)[KEY]["fire"]


def test_frag_below_trigger_never_arms():
    assert _diag_pair([]).frag(0.4, 0.1, sustain_s=0.0, now=1000.0) == {}


def test_frag_hysteresis_band_and_vanished_pool():
    pair = _diag_pair(["chip-0", "chip-3"])
    pair.frag(0.4, 0.1, sustain_s=0.0, now=1000.0)
    pair.fold([make_slice()], [allocated_claim("u1", ["chip-0"])])
    assert pair.frag(0.4, 0.1, sustain_s=0.0, now=1001.0)[KEY][
        "armed_since"] == 1000.0
    pair.fold([make_slice()])
    assert pair.frag(0.4, 0.1, sustain_s=0.0, now=1002.0) == {}
    pair.fold([])
    assert pair.frag(0.4, 0.1, sustain_s=60.0, now=2000.0) == {}
    pair.fold([make_slice()], [allocated_claim("u1", ["chip-0"]),
                               allocated_claim("u2", ["chip-3"])])
    assert pair.frag(0.4, 0.1, sustain_s=60.0, now=3000.0)[KEY][
        "armed_since"] == 3000.0


# -- seeded random fleets -------------------------------------------------------

def _random_fleet(rng, nodes):
    slices, claims = [], []
    for n in range(nodes):
        node = f"n{n}"
        gx, gy = [(2, 2), (4, 2), (2, 1)][int(rng.integers(0, 3))]
        chips = gx * gy
        tele = {}
        for i in range(chips):
            if rng.random() < 0.2:
                continue  # this chip's attributes dropped this poll
            tele[i] = {
                jax_fleet.ATTR_POWER: int(rng.choice([0, 110, 350, 700])),
                jax_fleet.ATTR_TEMP: int(rng.integers(3, 17)) * 5,
                jax_fleet.ATTR_DUTY: int(rng.integers(0, 11)) * 10,
                jax_fleet.ATTR_HBM: int(rng.integers(0, 11)) * 10,
                jax_fleet.ATTR_ICI_ERR: int(rng.integers(0, 3)) * 100,
            }
        cap = int(rng.choice([0, 0, 1400, 2800]))
        s = make_slice(node=node, chips=chips, grid=(gx, gy),
                       tele={i: tele.get(i, {}) for i in range(chips)},
                       cap=cap or None)
        slices.append(s)
        for i in range(chips):
            if rng.random() < 0.4:
                claims.append(allocated_claim(f"u{n}-{i}", [f"chip-{i}"],
                                              node=node))
    return slices, claims


@pytest.mark.parametrize("seed", range(6))
def test_random_fleets_fold_alike(seed, fixed_clock, monkeypatch):
    monkeypatch.setenv("TPU_DRA_POWER_CAP_W", str(500 * (seed % 2)))
    rng = np.random.default_rng(seed)
    pair = Pair(history=16)
    for step in range(8):
        fixed_clock.now += float(rng.choice([1.0, 30.0, 90.0]))
        slices, claims = _random_fleet(rng, int(rng.integers(1, 5)))
        pair.fold(slices, claims, pending=int(rng.integers(0, 5)))
        pair.frag(0.3, 0.1, sustain_s=60.0, now=fixed_clock.now)


# -- the scheduler's wiring ------------------------------------------------------

def _scheduler_store(kube):
    kube.create(*RES, "resourceslices", make_slice())
    kube.create(*RES, "resourceclaims", {
        "metadata": {"uid": "u-pending", "namespace": "default",
                     "name": "pending"},
        "spec": {"devices": {"requests": [{"name": "tpu", "exactly": {
            "deviceClassName": "missing.class", "count": 1}}]}},
    }, namespace="default")
    kube.create(*RES, "resourceclaims",
                allocated_claim("u-alloc", ["chip-0"]), namespace="default")


def test_full_pass_folds_fleet_state():
    scheds = {}
    for side, kubemod, sched in (("jax", jax_kube, jax_sched),
                                 ("pt", pt_kube, pt_sched)):
        kube = kubemod.FakeKubeClient()
        _scheduler_store(kube)
        scheds[side] = sched.DraScheduler(kube, default_node="n0")
        assert MOD[side][0].default_fleet() is not scheds[side].fleet
        scheds[side].sync_once()
        # The first fold installs this scheduler's aggregator as the
        # process default (/debug/fleet).
        assert MOD[side][0].default_fleet() is scheds[side].fleet
    a, b = (plain_json(scheds[s].fleet.snapshot()) for s in SIDES)
    assert b == a
    assert b["pending_claims"] == 1 and b["nodes"]["n0"]["power_watts"] \
        == 480


def test_fold_failure_never_fails_sync(monkeypatch):
    kube = pt_kube.FakeKubeClient()
    kube.create(*RES, "resourceslices", make_slice())
    sched = pt_sched.DraScheduler(kube, default_node="n0")
    monkeypatch.setattr(
        sched.fleet, "observe_pass",
        lambda *a, **kw: (_ for _ in ()).throw(RuntimeError("x")))
    sched.sync_once()  # must not raise


def test_scheduler_fleet_metrics_alike():
    """``fleet_metrics`` on each scheduler: the same exposition after a
    pass."""
    regs = {}
    for side, kubemod, sched in (("jax", jax_kube, jax_sched),
                                 ("pt", pt_kube, pt_sched)):
        kube = kubemod.FakeKubeClient()
        _scheduler_store(kube)
        fm = MOD[side][2].FleetMetrics()
        sched.DraScheduler(kube, default_node="n0",
                           fleet_metrics=fm).sync_once()
        regs[side] = samples(side, fm.registry)
    assert regs["pt"] == regs["jax"]
    assert ("tpu_dra_fleet_pending_claims", (), 1.0) in regs["pt"]
