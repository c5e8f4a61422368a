"""The port's serving autoscaler (``pkg/autoscale``: the CRD helpers, the
planner, the forecaster and the controller; ``AUTOSCALE_POLICY``; the
scheduler's ``attach_autoscaler``) against the JAX package's, on the CPU.

Every case of ``tests/test_autoscale.py`` runs once a side, step by step,
from the same input: the JAX side over its ``FakeKubeClient`` with the
``v5e-4`` chips its file publishes, the port's over its own with four
H100 counter sets whose ``memory`` is the same 16 GiB, one core a card
(no ``multiprocessors`` counter, MIG off), so both planners budget alike.
After each pass a side records the pass's counts, the CRDs (spec,
managed flag, revision, pre-warm hint), the durable records (state and
pinned spec, their wall clock and fingerprint aside), the kube writes and
whether a rollout is in flight; the two records must be equal. The one
difference is ``subslice``: the JAX planner backs a profile with one
whole chip (``1x1``), the port's with the H100's whole-GPU MIG profile
(``7g.80gb``), so specs are compared with it masked, and a fingerprint
(a hash over the spec) is compared within a side only. The modules'
``time.time`` is one clock, frozen unless a case moves it, on both sides.

Beyond the JAX file: a crash at every fault point of each side resumes to
the side's own uncrashed plan; both fakes' error types reach ``_apply``
(a create racing another, a 409) and ``_confirm`` (the CRD deleted under
it); the JAX controller writes, over HTTP, into the port's API server,
and the port's node watcher converges on its CRD; the forecaster and the
pre-warm hint on seeded rings.

``TestController::test_event_mode_rollout_needs_no_resync`` runs the
scheduler in event mode on both sides: the ``partitionsets`` informer's
event confirms the rollout without a resync.
"""

import dataclasses
import random
import time
import types

import pytest

from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
from k8s_dra_driver_gpu_tpu.kubeletplugin import driver as jax_driver
from k8s_dra_driver_gpu_tpu.kubeletplugin.deviceinfo import \
    DeviceKind as JaxKind
from k8s_dra_driver_gpu_tpu.pkg import faults as jax_faults
from k8s_dra_driver_gpu_tpu.pkg import fleetstate as jax_fleet
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg import metrics as jax_metrics
from k8s_dra_driver_gpu_tpu.pkg import scheduler as jax_sched
from k8s_dra_driver_gpu_tpu.pkg.analysis import statemachine as jax_sm
from k8s_dra_driver_gpu_tpu.pkg.autoscale import controller as jax_ctrl
from k8s_dra_driver_gpu_tpu.pkg.autoscale import crd as jax_crd
from k8s_dra_driver_gpu_tpu.pkg.autoscale import forecast as jax_forecast
from k8s_dra_driver_gpu_tpu.pkg.autoscale import planner as jax_planner
from k8s_dra_driver_gpu_tpu.pkg.partition import profiles as jax_profiles
from k8s_dra_driver_gpu_tpu.pkg.partition import spec as jax_spec
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import driver as pt_driver
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.deviceinfo import (
    AllocatableDevice, ChipInfo, DeviceKind)
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.partitions import (
    consumed_counters, shared_counter_sets)
from k8s_dra_driver_gpu_tpu_torch.pkg import autoscale as pt_autoscale
from k8s_dra_driver_gpu_tpu_torch.pkg import cel as pt_cel
from k8s_dra_driver_gpu_tpu_torch.pkg import faults as pt_faults
from k8s_dra_driver_gpu_tpu_torch.pkg import fleetstate as pt_fleet
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import metrics as pt_metrics
from k8s_dra_driver_gpu_tpu_torch.pkg import scheduler as pt_sched
from k8s_dra_driver_gpu_tpu_torch.pkg import statemachine as pt_sm
from k8s_dra_driver_gpu_tpu_torch.pkg.autoscale import controller as pt_ctrl
from k8s_dra_driver_gpu_tpu_torch.pkg.autoscale import crd as pt_crd
from k8s_dra_driver_gpu_tpu_torch.pkg.autoscale import forecast as pt_forecast
from k8s_dra_driver_gpu_tpu_torch.pkg.autoscale import planner as pt_planner
from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
from k8s_dra_driver_gpu_tpu_torch.pkg.partition import profiles as pt_profiles
from k8s_dra_driver_gpu_tpu_torch.pkg.partition import spec as pt_spec
from k8s_dra_driver_gpu_tpu_torch.pkg.partition.watch import \
    PartitionSetWatcher
from k8s_dra_driver_gpu_tpu_torch.tpulib.binding import (EnumerateOptions,
                                                         PyGpuLib)
from tests.fake_kube import CountingKube
from tests.test_autoscale import (CHIP_HBM, GATES, GIB, RES,
                                  publish_chip_fleet, tenant_claim)

SIDES = ("jax", "pt")
CRD = ("resource.tpu.dra", "v1beta1", "partitionsets")
M = {
    "jax": dict(ctrl=jax_ctrl, crd=jax_crd, planner=jax_planner,
                forecast=jax_forecast, profiles=jax_profiles, spec=jax_spec,
                kube=jax_kube, faults=jax_faults, fleet=jax_fleet,
                metrics=jax_metrics, sched=jax_sched),
    "pt": dict(ctrl=pt_ctrl, crd=pt_crd, planner=pt_planner,
               forecast=pt_forecast, profiles=pt_profiles, spec=pt_spec,
               kube=pt_kube, faults=pt_faults, fleet=pt_fleet,
               metrics=pt_metrics, sched=pt_sched),
}
# What backs one catalog profile: a whole chip, a whole H100 80GB.
SUBSLICE = {"jax": "1x1", "pt": "7g.80gb"}
MASK = "<whole device>"


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    """One ``time.time`` for the store, the controller and the forecaster
    of both packages: frozen at the case's start unless moved
    (``clock[0] += s``)."""
    now = [time.time()]
    fake = types.SimpleNamespace(time=lambda: now[0],
                                 monotonic=time.monotonic,
                                 perf_counter=time.perf_counter,
                                 sleep=time.sleep)
    for side in SIDES:
        for mod in ("ctrl", "forecast", "profiles"):
            monkeypatch.setattr(M[side][mod], "time", fake)
    return now


@pytest.fixture(autouse=True)
def clean_faults():
    for side in SIDES:
        M[side]["faults"].reset()
    yield
    for side in SIDES:
        M[side]["faults"].reset()


# -- the fleets ---------------------------------------------------------------

def gpu_host():
    """The mock ``h100-4`` with each card's memory set to the JAX file's
    chip (16 GiB): both planners see one chip memory."""
    host = PyGpuLib().enumerate(EnumerateOptions(mock_topology="h100-4"))
    chips = tuple(dataclasses.replace(c, memory_bytes=CHIP_HBM)
                  for c in host.chips)
    return dataclasses.replace(host, chips=chips,
                               memory_bytes_per_chip=CHIP_HBM)


def publish_gpu_fleet(fake, nodes: int = 1) -> None:
    """The port's counterpart of ``publish_chip_fleet``: whole-GPU slices
    with the port's per-GPU counter sets."""
    host = gpu_host()
    for i in range(nodes):
        devs = []
        for chip in host.chips:
            dev = AllocatableDevice(kind=DeviceKind.CHIP,
                                    chip=ChipInfo(chip=chip, host=host))
            entry = dev.to_dra_device()
            entry["consumesCounters"] = consumed_counters(dev)
            devs.append(entry)
        fake.create(*RES, "resourceslices", {
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
            "metadata": {"name": f"node-{i}-{DRIVER_NAME}"},
            "spec": {"driver": DRIVER_NAME, "nodeName": f"node-{i}",
                     "pool": {"name": f"node-{i}", "generation": 1,
                              "resourceSliceCount": 1},
                     "sharedCounters": shared_counter_sets(host),
                     "devices": devs}})


PUBLISH = {"jax": publish_chip_fleet, "pt": publish_gpu_fleet}


def pset(side, *profiles, pools=None):
    """The side's PartitionSet of ``(name, slots)`` profiles, each backed
    by the side's whole device."""
    doc = {"profiles": [{"name": n, "subslice": SUBSLICE[side],
                         "maxTenants": k} for n, k in profiles]}
    if pools is not None:
        doc["pools"] = pools
    return M[side]["spec"].PartitionSet.from_dict(doc)


def masked(spec: dict) -> dict:
    """A CRD spec with each profile's ``subslice`` masked."""
    out = dict(spec)
    if isinstance(out.get("profiles"), list):
        out["profiles"] = [dict(p, subslice=MASK) if isinstance(p, dict)
                           and "subslice" in p else p
                           for p in out["profiles"]]
    return out


def names(ps) -> list[str]:
    return [p.name for p in ps.profiles]


# -- the controller, both sides -----------------------------------------------

class Side:
    """One side's fleet (one node of four devices), its controller over
    a write-counting kube, and its trace: ``sync(label)`` runs a pass and
    records the side's state."""

    def __init__(self, side, root, counted=True, **kw):
        self.side, self.m = side, M[side]
        self.root = str(root)
        self.fake = self.m["kube"].FakeKubeClient()
        PUBLISH[side](self.fake)
        self.kube = CountingKube(self.fake) if counted else self.fake
        self.kw = dict(kw)
        self.ctrl = self.controller()
        self.trace = []

    def controller(self, **kw):
        kw = dict(self.kw, **kw)
        kw.setdefault("sustain_s", 0.0)
        kw.setdefault("cooldown_s", 0.0)
        kw.setdefault("subslice", SUBSLICE[self.side])
        return self.m["ctrl"].AutoscaleController(self.kube, self.root,
                                                  **kw)

    def observe(self, tenant, hbm, n=1):
        for _ in range(n):
            self.ctrl.store.observe(tenant, hbm)

    def create_crd(self, name, *profiles, managed=True, revision=1):
        self.fake.create(*CRD, self.m["crd"].crd_object(
            name, pset(self.side, *profiles), managed=managed,
            revision=revision))

    def crds(self):
        out = []
        for obj in sorted(self.fake.list(*CRD),
                          key=lambda o: o["metadata"]["name"]):
            ann = obj["metadata"].get("annotations") or {}
            out.append((obj["metadata"]["name"], masked(obj["spec"]),
                        {k: v for k, v in ann.items()
                         if k.startswith("resource.tpu.dra/")}))
        return out

    def records(self):
        out = []
        for rec in self.ctrl._checkpoint.get().claims.values():
            live = dict(rec.devices[0].live or {})
            live.pop("plannedAt", None)
            live.pop("fingerprint", None)
            live["spec"] = masked(live.get("spec") or {})
            out.append((rec.state, live))
        return sorted(out, key=repr)

    def state(self, counts):
        return {"counts": counts, "crds": self.crds(),
                "records": self.records(), "busy": self.ctrl.busy(),
                "writes": getattr(self.kube, "writes", None)}

    def sync(self, label="pass"):
        counts = self.ctrl.sync_once()
        self.trace.append((label, self.state(counts)))
        return counts

    def run_to_convergence(self, passes=6):
        last = {}
        for i in range(passes):
            last = self.sync(f"converge {i}")
            if not self.ctrl.busy() and (last["converged"]
                                         or last["deferred"]):
                break
        return last

    def crash_sync(self, label="crash"):
        """A pass that dies at an armed fault: the fault's type."""
        try:
            self.ctrl.sync_once()
        except Exception as e:  # noqa: BLE001 - injected
            self.trace.append((label, self.state(type(e).__name__)))
            return type(e).__name__
        self.trace.append((label, self.state(None)))
        return None

    def fingerprint(self):
        return self.m["crd"].fingerprint(self.fake.list(*CRD)[0]["spec"])

    def spec_names(self):
        ps, _ = self.m["crd"].partition_set_from_crd(
            self.fake.list(*CRD)[0])
        return names(ps)


def run_both(scenario, tmp_path, **kw):
    """``scenario(side)`` on each side; the traces asserted equal step by
    step; the sides."""
    sides = {}
    for name in SIDES:
        s = Side(name, tmp_path / f"as-{name}", **kw)
        scenario(s)
        sides[name] = s
    jt, pt = sides["jax"].trace, sides["pt"].trace
    assert [label for label, _ in pt] == [label for label, _ in jt]
    for (label, got), (_, want) in zip(pt, jt):
        assert got == want, label
    return sides


def test_constants_and_policy_are_the_references():
    for name in ("AUTOSCALE_SUSTAIN_S", "AUTOSCALE_BAND",
                 "AUTOSCALE_COOLDOWN_S", "PAUSE_ENV", "RESOURCE", "CRD"):
        assert getattr(pt_ctrl, name) == getattr(jax_ctrl, name), name
    for name in ("TENANT_DEMAND_HBM_ANNOTATION",
                 "TENANT_DEMAND_CORES_ANNOTATION"):
        assert getattr(pt_planner, name) == getattr(jax_planner, name)
    for name in ("AUTOSCALE_CRD_GROUP", "AUTOSCALE_CRD_VERSION",
                 "AUTOSCALE_CRD_RESOURCE", "AUTOSCALE_CRD_KIND",
                 "MANAGED_ANNOTATION", "REVISION_ANNOTATION",
                 "PREWARM_ANNOTATION"):
        assert getattr(pt_crd, name) == getattr(jax_crd, name), name
    assert pt_profiles.TENANT_PROFILE_ANNOTATION == \
        jax_profiles.TENANT_PROFILE_ANNOTATION
    assert pt_profiles.DEFAULT_TENANT_DEMANDS == {
        k: pt_spec.PartitionDemand(**vars(v))
        for k, v in jax_profiles.DEFAULT_TENANT_DEMANDS.items()}
    for name in ("FORECAST_HORIZON_S", "FORECAST_WINDOW_S",
                 "FORECAST_STALE_S", "FORECAST_MIN_POINTS"):
        assert getattr(pt_forecast, name) == getattr(jax_forecast, name)
    for name in ("AUTOSCALE_PLANNED", "AUTOSCALE_APPLYING"):
        assert getattr(pt_sm, name) == getattr(jax_sm, name)
    assert pt_sm.AUTOSCALE_POLICY.allowed == jax_sm.AUTOSCALE_POLICY.allowed
    assert set(pt_autoscale.__all__) == set(
        __import__("k8s_dra_driver_gpu_tpu.pkg.autoscale",
                   fromlist=["x"]).__all__)
    assert pt_autoscale.PartitionSetWatcher is PartitionSetWatcher


STATES = (None, "AutoscalePlanned", "AutoscaleApplying")


@pytest.mark.parametrize("old", STATES)
@pytest.mark.parametrize("new", STATES)
def test_autoscale_policy_as_the_reference(old, new):
    assert pt_sm.AUTOSCALE_POLICY.is_legal(old, new) == \
        jax_sm.AUTOSCALE_POLICY.is_legal(old, new)


# -- TestCrd ------------------------------------------------------------------

def both(fn):
    """``fn(side)`` on each side; the port's result, asserted equal to the
    JAX one."""
    got = {side: fn(side) for side in SIDES}
    assert got["pt"] == got["jax"]
    return got["pt"]


def test_crd_round_trip():
    def one(side):
        m = M[side]
        ps = pset(side, ("web-s8", 8), pools=["node-*"])
        obj = m["crd"].crd_object("tpu-dra-autoscale", ps,
                                  priority_rules=(m["crd"].PriorityRule(
                                      "tenant.key == 'interactive'", 100),))
        parsed, rules = m["crd"].partition_set_from_crd(obj)
        assert parsed == ps
        return (masked(obj["spec"]), obj["metadata"], rules[0].to_dict(),
                m["crd"].is_managed(obj), m["crd"].revision_of(obj))
    assert both(one)[3:] == (True, 1)


@pytest.mark.parametrize("obj", [
    {"metadata": {"name": "x"}},
    {"spec": {"profiles": [{"name": "BAD NAME", "subslice": "1x1"}]}},
    {"spec": {"profiles": [],
              "priorityRules": [{"selector": "tenant.key =="}]}},
    {"spec": {"profiles": [], "priorityRules": [{"priority": 3}]}},
    {"spec": {"profiles": [], "priorityRules": [
        {"selector": "tenant.cores > 1", "priority": "x"}]}},
], ids=["no spec", "bad profile name", "bad CEL", "no selector",
        "priority not an int"])
def test_crd_malformed_spec_and_rules_raise(obj):
    def one(side):
        with pytest.raises(M[side]["spec"].PartitionSpecError) as err:
            M[side]["crd"].partition_set_from_crd(obj)
        return str(err.value).split(":")[0]
    both(one)


@pytest.mark.parametrize("selector, tenant, hbm", [
    ("tenant.hbmBytes > 4000000000", "big", 6 * GIB),
    ("tenant.hbmBytes > 4000000000", "small", 1 * GIB),
    ("tenant.nope.deeper == 1", "x", 1),
    ("tenant.key == 'interactive'", "interactive", 1),
    ("tenant.cores >= 2 && tenant.key.startsWith('web')", "web-a", 1),
])
def test_crd_priority_rule_matching(selector, tenant, hbm):
    both(lambda side: M[side]["crd"].PriorityRule(selector, 10).matches(
        tenant, hbm, 1))


def test_crd_select_for_pool_orders_by_name():
    def one(side):
        m = M[side]
        ours = m["crd"].crd_object("tpu-dra-autoscale",
                                   pset(side, ("a-s8", 8)))
        manual = m["crd"].crd_object("00-manual", pset(side, ("b-s1", 1)),
                                     managed=False)
        outcome, payload, obj = m["crd"].select_for_pool([ours, manual],
                                                         "node-0")
        ps, rules, fp = payload
        assert fp == m["crd"].fingerprint(manual["spec"])
        return outcome, names(ps), rules, obj["metadata"]
    assert both(one)[:2] == ("ok", ["b-s1"])


@pytest.mark.parametrize("pool, want", [("pool-b7", "none"),
                                        ("pool-a3", "ok")])
def test_crd_select_respects_pool_globs(pool, want):
    def one(side):
        scoped = M[side]["crd"].crd_object("scoped", pset(
            side, pools=["pool-a*"]))
        return M[side]["crd"].select_for_pool([scoped], pool)[0]
    assert both(one) == want


def test_crd_select_malformed_winner_fails_closed():
    bad = {"apiVersion": "resource.tpu.dra/v1beta1",
           "kind": "PartitionSet", "metadata": {"name": "00-bad"},
           "spec": {"profiles": [{"name": "BAD NAME",
                                  "subslice": "1x1"}]}}

    def one(side):
        good = M[side]["crd"].crd_object("zz-good", pset(side))
        outcome, err, obj = M[side]["crd"].select_for_pool([good, bad],
                                                           "node-0")
        assert "BAD NAME" in err
        return outcome, obj["metadata"]["name"]
    assert both(one) == ("malformed", "00-bad")


@pytest.mark.parametrize("hints", [
    {}, {"node-*": {"web-s8": 2}}, {"a": {"x": 0}, "b": {"y": 3}},
    {"p": {}}, {"z": {"b": 1, "a": 2}, "a": {"c": 4}}])
def test_crd_prewarm_value_as_the_reference(hints):
    both(lambda side: M[side]["crd"].prewarm_value(hints))


# -- TestProfileWindow --------------------------------------------------------

def test_window_burst_then_decay_shrinks_sized_profile():
    def one(side):
        m = M[side]
        store = m["profiles"].TenantProfileStore(defaults={},
                                                 window_s=60.0)
        for _ in range(50):
            store.observe("web", 12 * GIB, now=1000.0)
        planner = m["planner"].AutoscalePlanner(subslice=SUBSLICE[side])
        cat = planner._catalog("web", CHIP_HBM, 1, (1, 2, 4, 8))
        big = m["profiles"].SizingPolicy().pick(
            store.demand("web", now=1010.0), cat)
        for _ in range(20):
            store.observe("web", int(1.5 * GIB), now=1100.0)
        small = m["profiles"].SizingPolicy().pick(
            store.demand("web", now=1105.0), cat)
        return (big.profile.max_tenants, big.per_tenant_hbm,
                small.profile.max_tenants, small.per_tenant_hbm)
    assert both(one)[::2] == (1, 8)


def test_window_all_aged_out_falls_back_to_last_sample():
    def one(side):
        store = M[side]["profiles"].TenantProfileStore(defaults={},
                                                       window_s=10.0)
        store.observe("web", 3 * GIB, now=0.0)
        return store.demand("web", now=1000.0).hbm_bytes
    assert both(one) == 3 * GIB


def test_window_zero_is_all_history():
    def one(side):
        store = M[side]["profiles"].TenantProfileStore(defaults={},
                                                       window_s=0.0)
        store.observe("web", 8 * GIB, now=0.0)
        store.observe("web", 1 * GIB, now=1e9)
        return store.demand("web", percentile=0.99, now=2e9).hbm_bytes
    assert both(one) == 8 * GIB


def test_window_fresh_tenants_excludes_aged_keys():
    def one(side):
        store = M[side]["profiles"].TenantProfileStore(defaults={},
                                                       window_s=60.0)
        store.observe("old", GIB, now=0.0)
        store.observe("new", GIB, now=1000.0)
        return store.fresh_tenants(now=1010.0), store.tenants()
    assert both(one)[0] == ["new"]


def test_window_percentiles_surface():
    def one(side):
        store = M[side]["profiles"].TenantProfileStore(defaults={},
                                                       window_s=0.0)
        for i in range(100):
            store.observe("web", i * GIB)
        return store.percentiles(), store.to_dict()
    pct, _ = both(one)
    assert pct["web"]["p50_hbm_bytes"] == 49 * GIB
    assert pct["web"]["p95_hbm_bytes"] == 94 * GIB


@pytest.mark.parametrize("seed", range(4))
def test_window_seeded_samples_as_the_reference(seed):
    """Seeded demand samples over a moving window: every percentile read,
    the fresh keys and the file form, equal."""
    rng = random.Random(seed)
    ops = [(rng.choice(["a", "b", "c"]), rng.randrange(0, 40) * GIB // 4,
            rng.randrange(1, 4), 1000.0 + 7.0 * i) for i in range(120)]

    def one(side):
        store = M[side]["profiles"].TenantProfileStore(window_s=90.0)
        reads = []
        for tenant, hbm, cores, now in ops:
            store.observe(tenant, hbm, cores=cores, now=now)
            d = store.demand(tenant, percentile=rng_pct(now), now=now)
            reads.append((d.hbm_bytes, d.cores, d.count))
            reads.append(store.fresh_tenants(now=now))
        return reads, store.percentiles(now=ops[-1][3]), store.to_dict()
    both(one)


def rng_pct(now: float) -> float:
    return (0.5, 0.9, 0.95, 1.0)[int(now) % 4]


# -- TestPlanner --------------------------------------------------------------

def store_of(side, tenant="web", hbm=int(1.5 * GIB), n=40):
    store = M[side]["profiles"].TenantProfileStore(defaults={})
    for _ in range(n):
        store.observe(tenant, hbm)
    return store


def plan_of(side, store, active, **kw):
    rules = tuple(M[side]["crd"].PriorityRule(s, p)
                  for s, p in kw.pop("rules", ()))
    band = kw.pop("band", 0.1)
    kw.setdefault("chip_hbm", CHIP_HBM)
    kw.setdefault("cores_per_chip", 1)
    plan = M[side]["planner"].AutoscalePlanner(
        band=band, subslice=SUBSLICE[side]).plan(store, active,
                                                 rules=rules, **kw)
    return (masked(plan.desired.to_dict()), plan.changed, plan.urgent,
            plan.decisions, plan.desired == active)


def test_planner_sizes_smallest_satisfying():
    got = both(lambda s: plan_of(s, store_of(s), pset(s)))
    assert got[1] and [p["name"] for p in got[0]["profiles"]] == ["web-s8"]


def test_planner_no_counters_keeps_active_verbatim():
    got = both(lambda s: plan_of(s, store_of(s), pset(s, ("web-s8", 8)),
                                 chip_hbm=0))
    assert not got[1] and got[4]


def test_planner_upsize_is_urgent():
    got = both(lambda s: plan_of(s, store_of(s, hbm=3 * GIB),
                                 pset(s, ("web-s8", 8))))
    assert got[1] and got[2] and got[3]["web"]["action"] == "upsize"
    assert [p["name"] for p in got[0]["profiles"]] == ["web-s4"]


def test_planner_hysteresis_band_blocks_boundary_repack():
    got = both(lambda s: plan_of(s, store_of(s, hbm=int(1.9 * GIB)),
                                 pset(s, ("web-s4", 4))))
    assert not got[1] and got[3]["web"]["action"] == "keep"


def test_planner_clear_headroom_repacks_non_urgent():
    got = both(lambda s: plan_of(s, store_of(s, hbm=int(1.2 * GIB)),
                                 pset(s, ("web-s4", 4))))
    assert got[1] and not got[2] and got[3]["web"]["action"] == "repack"
    assert [p["name"] for p in got[0]["profiles"]] == ["web-s8"]


def test_planner_cel_priority_packs_away_from_oversubscription():
    rules = (("tenant.key == 'interactive'", 100),)
    got = both(lambda s: plan_of(s, store_of(s, tenant="interactive"),
                                 pset(s), rules=rules))
    assert [p["name"] for p in got[0]["profiles"]] == ["interactive-s1"]
    assert got[3]["interactive"]["priority"] == 100


def test_planner_priority_isolation_off_shared_is_urgent():
    rules = (("tenant.key == 'interactive'", 100),)
    got = both(lambda s: plan_of(s, store_of(s, tenant="interactive"),
                                 pset(s, ("interactive-s8", 8)),
                                 rules=rules))
    assert got[1] and got[2]
    assert got[3]["interactive"]["action"] == "isolate"


def test_planner_aged_out_tenant_profile_retires():
    def one(side):
        store = M[side]["profiles"].TenantProfileStore(defaults={},
                                                       window_s=60.0)
        store.observe("gone", GIB, now=0.0)
        return plan_of(side, store, pset(side, ("gone-s8", 8)), now=1000.0)
    got = both(one)
    assert got[1] and not got[2] and got[0]["profiles"] == []


def test_planner_live_tenant_profile_retained_despite_aged_samples():
    def one(side):
        store = M[side]["profiles"].TenantProfileStore(defaults={},
                                                       window_s=60.0)
        store.observe("web", GIB, now=0.0)
        return plan_of(side, store, pset(side, ("web-s8", 8)),
                       live_tenants={"web"}, now=1000.0)
    assert not both(one)[1]


def test_planner_pool_chip_caps_reads_published_counters():
    def one(side):
        fake = M[side]["kube"].FakeKubeClient()
        PUBLISH[side](fake)
        return M[side]["planner"].pool_chip_caps(
            fake.list(*RES, "resourceslices"))
    assert both(one) == (CHIP_HBM, 1)


@pytest.mark.parametrize("counters, want", [
    ({"memory": {"value": "85520809984"}}, (85520809984, 1)),
    ({"memory": {"value": "80Gi"}, "multiprocessors": {"value": "132"}},
     (80 << 30, 132)),
    ({"memory": {"value": "junk"}, "memory-slice-0": {"value": "1"}},
     pt_cel.CelEvalError),
    ({}, (0, 1)),
])
def test_pool_chip_caps_reads_the_gpu_counter_set(counters, want):
    """The port's counter sets: ``memory`` is the card's memory,
    ``multiprocessors`` (MIG on) its cores, one core without it; the
    largest card of the fleet. A ``memory`` that is no quantity raises,
    as the JAX function's ``hbm-<chip>`` does."""
    slices = [{"spec": {"sharedCounters": [
        {"name": "gpu-0-counter-set", "counters": counters},
        {"name": "gpu-1-counter-set",
         "counters": {"memory": {"value": "1024"}}}]}}]
    if isinstance(want, type):
        with pytest.raises(want):
            pt_planner.pool_chip_caps(slices)
        return
    assert pt_planner.pool_chip_caps(slices) == (max(want[0], 1024),
                                                 want[1])


def corrupt_memory_counters(fake) -> None:
    """Every published chip memory counter (``hbm-<chip>`` on the JAX
    side, ``memory`` on the port's) set to a value that is no quantity."""
    for obj in fake.list(*RES, "resourceslices"):
        sets = [dict(cs, counters={
            n: ({"value": "junk"} if n.startswith("hbm-") or n == "memory"
                else v) for n, v in (cs.get("counters") or {}).items()})
            for cs in obj["spec"].get("sharedCounters") or []]
        fake.patch(*RES, "resourceslices", obj["metadata"]["name"],
                   {"spec": {"sharedCounters": sets}})


def test_controller_corrupt_counter_raises_out_of_the_pass(tmp_path):
    """A chip memory counter that does not parse fails the pass on both
    sides (the scheduler logs it each pass): no pass reads it as a
    converged fleet, and nothing is written."""
    def sc(s):
        s.observe("web", int(1.5 * GIB), 40)
        s.run_to_convergence()
        corrupt_memory_counters(s.fake)
        w0 = s.kube.writes
        for i in range(2):
            assert s.crash_sync(f"corrupt {i}") == "CelEvalError"
        assert s.kube.writes == w0 and not s.ctrl.busy()
    run_both(sc, tmp_path)


@pytest.mark.parametrize("seed", range(6))
def test_planner_seeded_fleets_as_the_reference(seed):
    """Seeded tenants, demands, active layouts, priority rules and bands:
    every PlanResult's urgent, changed and decisions, equal, and the
    desired names and slot counts."""
    rng = random.Random(seed)
    tenants = [f"t{i}" for i in range(rng.randrange(1, 6))]
    demands = {t: [rng.randrange(1, 80) * GIB // 8
                   for _ in range(rng.randrange(1, 30))] for t in tenants}
    active = [(f"{t}-s{k}", k) for t in tenants if rng.random() < 0.6
              for k in [rng.choice((1, 2, 4, 8))]]
    rules = [("tenant.hbmBytes > 6000000000", 5)] if rng.random() < 0.5 \
        else []
    band = rng.choice((0.0, 0.1, 0.3))
    pending = {t for t in tenants if rng.random() < 0.3}
    live = {t for t in tenants if rng.random() < 0.5}

    def one(side):
        store = M[side]["profiles"].TenantProfileStore(defaults={})
        for t, values in demands.items():
            for v in values:
                store.observe(t, v)
        return plan_of(side, store, pset(side, *active), rules=rules,
                       band=band, pending_tenants=pending,
                       live_tenants=live, coop_tenants=live & pending)
    both(one)


def test_profile_names_as_the_reference():
    for tenant in ("web", "Web App", "a_b.c", "", "--", "x9-s2"):
        for slots in (1, 8):
            name = pt_planner.profile_name_for(tenant, slots)
            assert name == jax_planner.profile_name_for(tenant, slots)
            assert pt_planner.tenant_of_profile(name) == \
                jax_planner.tenant_of_profile(name)
    assert pt_planner.tenant_of_profile("nope") is None


# -- TestController -----------------------------------------------------------

def test_controller_rollout_and_steady_state_zero_writes(tmp_path):
    def sc(s):
        s.observe("web", int(1.5 * GIB), 40)
        s.run_to_convergence()
        assert len(s.fake.list(*CRD)) == 1
        assert s.spec_names() == ["web-s8"] and not s.ctrl.busy()
        w0 = s.kube.writes
        for i in range(3):
            assert s.sync(f"steady {i}")["converged"] == 1
        assert s.kube.writes == w0
    run_both(sc, tmp_path)


def test_controller_replan_on_demand_shift(tmp_path):
    def sc(s):
        s.observe("web", int(1.5 * GIB), 40)
        s.run_to_convergence()
        s.observe("web", 6 * GIB, 200)
        s.run_to_convergence()
        assert s.spec_names() == ["web-s2"]
        assert s.m["crd"].revision_of(s.fake.list(*CRD)[0]) == 2
    run_both(sc, tmp_path)


def test_controller_sustain_defers_non_urgent_repack(tmp_path, clock):
    def sc(s):
        s.ctrl = s.controller(sustain_s=3600.0)
        s.create_crd("tpu-dra-autoscale", ("web-s4", 4))
        s.observe("web", int(1.2 * GIB), 40)
        out = s.sync("deferred")
        assert out["deferred"] == 1 and out["planned"] == 0
        clock[0] += 3599.0
        assert s.sync("still deferred")["deferred"] == 1
        s.observe("web", int(1.2 * GIB), 40)  # the drift stays fresh
        clock[0] += 2.0
        assert s.sync("sustained")["planned"] == 1
        clock[0] -= 3601.0
    run_both(sc, tmp_path)


def test_controller_urgent_upsize_skips_sustain(tmp_path):
    def sc(s):
        s.ctrl = s.controller(sustain_s=3600.0)
        s.create_crd("tpu-dra-autoscale", ("web-s8", 8))
        s.observe("web", 3 * GIB, 40)
        assert s.sync("urgent")["planned"] == 1
    run_both(sc, tmp_path)


def test_controller_fleet_pending_ring_skips_sustain(tmp_path):
    def sc(s):
        fleet = s.m["fleet"].FleetAggregator()
        empty_snap = type("S", (), {"candidates": []})()
        for _ in range(3):
            fleet.observe_pass(empty_snap, None, pending_claims=5)
        s.ctrl = s.controller(sustain_s=3600.0, fleet=fleet)
        s.create_crd("tpu-dra-autoscale", ("web-s4", 4))
        tenant_claim(s.fake, "c1", "web", int(1.2 * GIB), allocated=False)
        s.observe("web", int(1.2 * GIB), 40)
        assert s.sync("starving")["planned"] == 1
    run_both(sc, tmp_path)


def test_controller_manual_override_freezes_planning(tmp_path):
    def sc(s):
        s.observe("web", int(1.5 * GIB), 40)
        s.run_to_convergence()
        s.fake.patch(*CRD, "tpu-dra-autoscale", {"metadata": {
            "annotations": {s.m["crd"].MANAGED_ANNOTATION: "false"}}})
        s.observe("web", 6 * GIB, 200)
        w0 = s.kube.writes
        out = s.sync("override")
        assert out["deferred"] == 1 and out["planned"] == 0
        assert s.kube.writes == w0
    run_both(sc, tmp_path)


def test_controller_concurrent_operator_edit_supersedes(tmp_path):
    def sc(s):
        s.ctrl.metrics = s.m["metrics"].AutoscaleMetrics()
        s.observe("web", int(1.5 * GIB), 40)
        s.sync("planned and applied")
        assert s.ctrl.busy()
        s.fake.patch(*CRD, "tpu-dra-autoscale", {
            "metadata": {"annotations": {
                s.m["crd"].MANAGED_ANNOTATION: "false"}},
            "spec": {"profiles": [{"name": "manual-s2",
                                   "subslice": SUBSLICE[s.side],
                                   "maxTenants": 2}], "pools": []}})
        assert s.sync("superseded")["superseded"] == 1
        assert not s.ctrl.busy()
        assert s.spec_names() == ["manual-s2"]
        out = s.sync("frozen")
        assert out["deferred"] == 1 and out["planned"] == 0
        sup = s.ctrl.metrics.superseded
        assert (sup._value.get() if s.side == "jax"
                else sup._own().value) == 1
    run_both(sc, tmp_path)


def test_controller_managed_flip_mid_plan_never_stomped(tmp_path):
    def sc(s):
        s.observe("web", int(1.5 * GIB), 40)
        s.run_to_convergence()
        s.observe("web", 6 * GIB, 200)
        s.m["faults"].arm("autoscale.apply", mode="error", count=1)
        try:
            s.crash_sync("apply fails")
        finally:
            s.m["faults"].reset()
        assert s.ctrl.busy()
        s.fake.patch(*CRD, "tpu-dra-autoscale", {"metadata": {
            "annotations": {s.m["crd"].MANAGED_ANNOTATION: "false"}}})
        spec_before = s.fake.list(*CRD)[0]["spec"]
        out = s.sync("flip wins")
        assert out["superseded"] == 1 and out["applied"] == 0
        live = s.fake.list(*CRD)[0]
        assert not s.m["crd"].is_managed(live)
        assert live["spec"] == spec_before and not s.ctrl.busy()
    run_both(sc, tmp_path)


def test_controller_malformed_managed_crd_defers(tmp_path):
    def sc(s):
        s.observe("web", int(1.5 * GIB), 40)
        s.run_to_convergence()
        s.fake.patch(*CRD, "tpu-dra-autoscale", {"spec": {"profiles": [
            {"name": "BAD NAME", "subslice": "1x1"}]}})
        w0 = s.kube.writes
        assert s.sync("malformed")["deferred"] == 1
        assert s.kube.writes == w0
    run_both(sc, tmp_path)


def test_controller_claim_annotations_feed_store_and_age_out(tmp_path,
                                                             clock):
    def sc(s):
        s.ctrl.store.window_s = 60.0
        tenant_claim(s.fake, "c1", "api", 5 * GIB, allocated=True)
        s.sync("ingest")
        d = s.ctrl.store.demand("api")
        assert d is not None and d.hbm_bytes == 5 * GIB
        # The claim goes; its samples age out of the window (the last
        # one stays as the tenant's last known demand).
        s.fake.delete(*RES, "resourceclaims", "c1", namespace="default")
        clock[0] += 120.0
        s.sync("aged")
        assert s.ctrl.store.fresh_tenants() == []
        clock[0] -= 120.0
    run_both(sc, tmp_path)


def test_controller_pending_tenant_is_urgent(tmp_path):
    def sc(s):
        s.ctrl = s.controller(sustain_s=3600.0)
        tenant_claim(s.fake, "c1", "api", 2 * GIB, allocated=False)
        assert s.sync("pending")["planned"] == 1
    run_both(sc, tmp_path)


def test_controller_pause_stops_new_plans_not_rollouts(tmp_path,
                                                       monkeypatch):
    def sc(s):
        s.observe("web", int(1.5 * GIB), 40)
        s.sync("planned")
        monkeypatch.setenv("TPU_DRA_AUTOSCALE_PAUSE", "1")
        assert s.sync("paused, confirmed")["completed"] == 1
        s.observe("web", 6 * GIB, 200)
        assert s.sync("paused")["planned"] == 0
        monkeypatch.delenv("TPU_DRA_AUTOSCALE_PAUSE")
        assert s.sync("resumed")["planned"] == 1
    run_both(sc, tmp_path)


def test_controller_cooldown_holds_the_next_plan(tmp_path, clock):
    def sc(s):
        s.ctrl = s.controller(cooldown_s=60.0)
        s.observe("web", int(1.5 * GIB), 40)
        s.run_to_convergence()
        s.observe("web", 6 * GIB, 200)
        assert s.sync("cooling")["planned"] == 0
        clock[0] += 61.0
        assert s.sync("cooled")["planned"] == 1
        clock[0] -= 61.0
    run_both(sc, tmp_path)


FAULTS = ["autoscale.sync", "autoscale.plan", "autoscale.apply",
          "autoscale.confirm"]


@pytest.mark.parametrize("fault", FAULTS)
def test_controller_crash_at_every_fault_point_resumes_to_same_plan(
        tmp_path, fault):
    """A controller that dies at ``fault`` and a fresh one on the same
    root converge on the CRD an uncrashed run writes, on each side."""
    def sc(s):
        ref = Side(s.side, tmp_path / f"ref-{s.side}")
        ref.observe("web", int(1.5 * GIB), 40)
        ref.run_to_convergence()
        s.observe("web", int(1.5 * GIB), 40)
        s.m["faults"].arm(fault, mode="error", count=1)
        try:
            crashed = None
            for i in range(6):
                crashed = s.crash_sync(f"pass {i}")
                if crashed:
                    break
            assert crashed, f"{fault} never fired"
        finally:
            s.m["faults"].reset()
        s.ctrl = s.controller()
        s.observe("web", int(1.5 * GIB), 40)
        s.run_to_convergence()
        assert not s.ctrl.busy() and len(s.fake.list(*CRD)) == 1
        assert s.fingerprint() == ref.fingerprint()
    run_both(sc, tmp_path)


def test_controller_rides_scheduler_loop(tmp_path):
    def sc(s):
        sched = s.m["sched"].DraScheduler(s.fake)
        s.ctrl = s.controller()
        sched.attach_autoscaler(s.ctrl)
        assert s.ctrl.view is sched.view and s.ctrl.fleet is sched.fleet
        s.observe("web", int(1.5 * GIB), 40)
        for i in range(3):
            sched.sync_once()
            s.trace.append((f"sched {i}", s.state(s.ctrl.last_sync)))
        assert s.spec_names() == ["web-s8"]
        snap = sched.fleet.snapshot()
        assert "web" in snap["tenant_demand"]
        assert snap["pending_history"], "pending ring must be fed"
        s.trace.append(("demand", snap["tenant_demand"]))
    run_both(sc, tmp_path, counted=False)


# -- both fakes' error types through _apply and _confirm ----------------------

def test_apply_conflict_is_retried_next_pass(tmp_path):
    """A create that meets the CRD another writer made first (each
    fake's ConflictError): the record stays Planned and the next pass
    patches over it."""
    def sc(s):
        s.observe("web", int(1.5 * GIB), 40)
        ctrl, real_create = s.ctrl, s.kube.create
        raced = []

        def racing_create(*a, **kw):
            if a[:3] == CRD and not raced:
                raced.append(1)
                real_create(*a, **kw)  # the other writer, first
            return real_create(*a, **kw)
        s.kube.create = racing_create
        out = s.sync("conflict")
        assert out["planned"] == 1 and out["applied"] == 0 and ctrl.busy()
        s.run_to_convergence()
        assert not ctrl.busy() and s.spec_names() == ["web-s8"]
    run_both(sc, tmp_path)


def test_confirm_of_a_deleted_crd_supersedes(tmp_path):
    """The CRD deleted between the apply and the confirm (each fake's
    NotFoundError): the rollout is superseded, and the next plan
    creates it again."""
    def sc(s):
        s.observe("web", int(1.5 * GIB), 40)
        s.sync("applied")
        s.fake.delete(*CRD, "tpu-dra-autoscale")
        assert s.sync("gone")["superseded"] == 1
        s.run_to_convergence()
        assert s.spec_names() == ["web-s8"]
    run_both(sc, tmp_path)


def test_a_failed_list_skips_the_pass(tmp_path):
    def sc(s):
        s.observe("web", int(1.5 * GIB), 40)
        real = s.kube.list

        def failing(*a, **kw):
            raise s.m["kube"].KubeError(503, "apiserver down")
        s.kube.list = failing
        assert s.sync("down")["planned"] == 0
        s.kube.list = real
        assert s.sync("up")["planned"] == 1
    run_both(sc, tmp_path)


# -- the forecaster and the pre-warm hint -------------------------------------

def _ring(rng, now, n, rising=True):
    used, out = rng.randrange(0, 4), []
    for i in range(n):
        used += rng.randrange(0, 3) if rising else rng.randrange(-2, 3)
        out.append({"ts": now - (n - i) * rng.uniform(1, 20),
                    "partition_slots_used": max(used, 0)})
    return out


@pytest.mark.parametrize("seed", range(8))
def test_forecast_as_the_reference(seed, clock):
    rng = random.Random(seed)
    now = clock[0]
    snap = {"pending_history": [
        {"ts": now - rng.uniform(0, 400), "pending": rng.randrange(0, 5)}
        for _ in range(rng.randrange(0, 6))],
        "pools": {f"{DRIVER_NAME}/p{i}": {
            "history": _ring(rng, now, rng.randrange(0, 12),
                             rising=rng.random() < 0.7),
            "current": {"partition_slots_total": rng.choice((0, None, 8))}}
            for i in range(4)}}
    snap["pending_history"].sort(key=lambda p: p["ts"])
    got = both(lambda side: (
        M[side]["forecast"].DemandForecaster().forecast(snap),
        [M[side]["forecast"].DemandForecaster(min_points=2).forecast_slots(
            e["history"]) for e in snap["pools"].values()]))
    assert isinstance(got[0], dict)


def test_prewarm_hint_converges_and_holds(tmp_path, clock):
    """The forecast's hint lands on the managed CRD once, holds while
    the forecast wobbles down, and clears after the stale window."""
    class Fleet:
        def __init__(self):
            self.slots = 0

        def pending_recent(self):
            return 0

        def snapshot(self):
            now = clock[0]
            hist = [{"ts": now - 40 + 10 * i,
                     "partition_slots_used": i * self.slots}
                    for i in range(5)]
            return {"pending_history": [], "pools": {
                f"{DRIVER_NAME}/node-0": {
                    "history": hist,
                    "current": {"partition_slots_total": 32}}}}

    def sc(s):
        fleet = Fleet()
        s.ctrl = s.controller(fleet=fleet)
        s.observe("web", int(1.5 * GIB), 40)
        s.run_to_convergence()
        fleet.slots = 3
        assert s.sync("ramp").get("prewarmed") == 1
        w0 = s.kube.writes
        assert "prewarmed" not in s.sync("steady")
        fleet.slots = 0
        assert "prewarmed" not in s.sync("wobble")
        assert s.kube.writes == w0
        clock[0] += s.ctrl.forecaster.stale_s + 1
        assert s.sync("expired").get("prewarmed") == 1
        clock[0] -= s.ctrl.forecaster.stale_s + 1
    run_both(sc, tmp_path)


@pytest.mark.parametrize("raw", [
    "", "not json", '["a"]', '{"p": {"x": "bad"}}', '{"p": "no"}',
    '{"p": {"x": 2, "y": 0}, "q": {"z": 1}}'])
def test_parse_prewarm_as_the_reference(raw):
    assert pt_ctrl.AutoscaleController._parse_prewarm(raw) == \
        jax_ctrl.AutoscaleController._parse_prewarm(raw)


# -- TestNodeSeam -------------------------------------------------------------

def seam_config(side, root, bootstrap=None):
    """The JAX file's ``_node_config`` (v5e-4), and the port's on h100-4
    with MIG on, the partition gates, no layout file but ``bootstrap``."""
    if side == "jax":
        cfg = jax_ds.Config.mock(root=root, gates=GATES,
                                 partition_set=bootstrap
                                 or jax_spec.PartitionSet())
    else:
        cfg = pt_ds.Config.mock(root, "h100-4", GATES, mig_mode="enabled",
                                partition_set=bootstrap
                                or pt_spec.PartitionSet())
    cfg.pool_name = "node-0"
    return cfg


class Seam:
    """One node's Driver over its side's fake; its CRD objects are made
    by the OTHER package's ``crd_object_from_spec`` (with this node's
    subslice: each package's spec refuses the other's backing), so each
    watcher parses what the other control plane writes."""

    def __init__(self, side, root):
        self.side, self.root = side, root
        self.fake = M[side]["kube"].FakeKubeClient()
        self.drv = None

    def crd(self, slots=8, revision=1):
        other = "pt" if self.side == "jax" else "jax"
        spec = {"profiles": [{"name": f"web-s{slots}",
                              "subslice": SUBSLICE[self.side],
                              "maxTenants": slots}], "pools": []}
        return M[other]["crd"].crd_object_from_spec(
            "tpu-dra-autoscale", spec, revision=revision)

    def start(self, bootstrap=None):
        mod = jax_driver if self.side == "jax" else pt_driver
        self.drv = mod.Driver(seam_config(self.side, self.root, bootstrap),
                              self.fake, "node-0",
                              enable_health_monitor=False)
        self.drv.start()
        return self

    def stop(self):
        if self.drv is not None:
            self.drv.stop()
            self.drv = None

    def devices(self):
        kind = JaxKind.PARTITION if self.side == "jax" \
            else DeviceKind.PARTITION
        return sorted(n for n, d in self.drv.state.allocatable.items()
                      if d.kind == kind)

    def published(self):
        return sorted(d["name"] for s in self.fake.list(*RES,
                                                        "resourceslices")
                      for d in s["spec"]["devices"]
                      if d["name"].startswith("pt-"))


BAD = {"apiVersion": "resource.tpu.dra/v1beta1", "kind": "PartitionSet",
       "metadata": {"name": "tpu-dra-autoscale"},
       "spec": {"profiles": [{"name": "BAD NAME", "subslice": "nope"}]}}


def seam_both(scenario, tmp_path):
    got = {}
    for side in SIDES:
        node = Seam(side, str(tmp_path / f"n-{side}"))
        try:
            got[side] = scenario(node)
        finally:
            node.stop()
    assert got["pt"] == got["jax"]
    return got["pt"]


def webs(slots):
    return [f"pt-web-s{slots}-{k}" for k in range(4)]


def test_seam_live_driver_converges_on_crd_update(tmp_path):
    def sc(n):
        n.start()
        steps = [n.devices()]
        n.fake.create(*CRD, n.crd(8))
        steps += [n.devices(), n.published()]
        n.fake.update(*CRD, "tpu-dra-autoscale", n.crd(4, revision=2))
        return steps + [n.devices(), n.published()]
    assert seam_both(sc, tmp_path) == [[], webs(8), webs(8), webs(4),
                                       webs(4)]


def test_seam_restarted_driver_converges_to_same_set(tmp_path):
    def sc(n):
        n.fake.create(*CRD, n.crd(8))
        n.start()
        live = (n.devices(), n.published())
        n.stop()
        n.start()
        return live, (n.devices(), n.published())
    live, again = seam_both(sc, tmp_path)
    assert live == again == (webs(8), webs(8))


def test_seam_malformed_crd_keeps_last_good_plan(tmp_path):
    def sc(n):
        n.fake.create(*CRD, n.crd(8))
        n.start()
        good = n.devices()
        n.fake.update(*CRD, "tpu-dra-autoscale", BAD)
        w = n.drv.partition_watcher
        kept = (n.devices() == good, bool(w.last_error),
                w.failed_total >= 1)
        n.fake.update(*CRD, "tpu-dra-autoscale", n.crd(4, revision=3))
        return good, kept, n.devices(), w.last_error
    assert seam_both(sc, tmp_path) == (webs(8), (True, True, True),
                                       webs(4), None)


def test_seam_malformed_counter_dedupes_and_revert_clears_error(tmp_path):
    def sc(n):
        good = n.crd(8)
        n.fake.create(*CRD, good)
        n.start()
        w = n.drv.partition_watcher
        n.fake.update(*CRD, "tpu-dra-autoscale", BAD)
        first = w.failed_total
        for _ in range(3):
            w.reconcile()
        n.fake.update(*CRD, "tpu-dra-autoscale", good)
        return first, w.failed_total, w.last_error, n.devices()
    assert seam_both(sc, tmp_path) == (1, 1, None, webs(8))


def test_seam_crd_delete_reverts_to_bootstrap(tmp_path):
    def sc(n):
        boot = M[n.side]["spec"].PartitionSet.from_dict({"profiles": [
            {"name": "boot-s2", "subslice": SUBSLICE[n.side],
             "maxTenants": 2}]})
        n.start(bootstrap=boot)
        steps = [n.devices()]
        n.fake.create(*CRD, n.crd(8))
        steps.append(n.devices())
        n.fake.delete(*CRD, "tpu-dra-autoscale")
        return steps + [n.devices()]
    boots = [f"pt-boot-s2-{k}" for k in range(4)]
    assert seam_both(sc, tmp_path) == [boots, webs(8), boots]


def test_seam_watch_opt_out_restores_file_only_behavior(tmp_path,
                                                        monkeypatch):
    monkeypatch.setenv("TPU_DRA_PARTITION_WATCH", "0")

    def sc(n):
        n.fake.create(*CRD, n.crd(8))
        n.start()
        return n.drv.partition_watcher is None, n.devices()
    assert seam_both(sc, tmp_path) == (True, [])


def test_the_port_watcher_converges_on_the_jax_controllers_crd(tmp_path):
    """The cross case: the JAX controller (its ``KubeClient``, backing
    profiles with ``7g.80gb``) writes over HTTP into the port's API
    server, where the port's node (MIG on) watches; the node converges
    on the JAX controller's plan. The JAX spec parser knows only TPU
    carve-outs, so the JAX controller then reads its own CRD as
    malformed and defers, writing nothing."""
    server = FakeApiServer(keepalive=0.2).start()
    drv = None
    try:
        # The JAX controller budgets from the JAX counters (hbm-<chip>).
        publish_chip_fleet(server.store)
        kube = jax_kube.KubeClient(host=server.url)
        ctrl = jax_ctrl.AutoscaleController(
            kube, str(tmp_path / "jax-as"), sustain_s=0.0, cooldown_s=0.0,
            subslice="7g.80gb")
        drv = pt_driver.Driver(
            seam_config("pt", str(tmp_path / "node")),
            pt_kube.KubeClient(host=server.url), "node-0",
            enable_health_monitor=False)
        drv.start()
        watcher = drv.partition_watcher
        for _ in range(40):
            ctrl.store.observe("web", int(1.5 * GIB))
        assert ctrl.sync_once()["applied"] == 1
        assert ctrl.sync_once()["completed"] == 1 and not ctrl.busy()
        # The count rises after the plan's devices and their republish:
        # wait for both, or a wake between the two reads a half-done apply.
        assert watcher.wait_for(lambda: watcher.applied_total >= 1 and sorted(
            n for n, d in drv.state.allocatable.items()
            if d.kind == DeviceKind.PARTITION) == webs(8), 10.0)
        assert watcher.last_error is None and watcher.applied_total == 1
        before = dict(server.requests)
        assert ctrl.sync_once()["deferred"] == 1
        writes = {m: server.requests[m] - before.get(m, 0)
                  for m in ("POST", "PUT", "PATCH", "DELETE")}
        assert writes == {"POST": 0, "PUT": 0, "PATCH": 0, "DELETE": 0}
    finally:
        if drv is not None:
            drv.stop()
        server.stop()


def test_event_mode_rollout_needs_no_resync(tmp_path):
    """Event mode at one worker with an hour's resync: the first full
    pass plans and applies, and the CRD write's own ``partitionsets``
    event (the ``("autoscale",)`` dirty key) confirms, with no resync;
    the rollout's records and CRD equal on both sides."""
    def sc(s):
        sched = s.m["sched"].DraScheduler(s.fake, workers=1,
                                          resync_period=3600.0)
        s.ctrl = s.controller()
        sched.attach_autoscaler(s.ctrl)
        s.observe("web", int(1.5 * GIB), 40)
        sched.start_event_driven()
        try:
            for _ in range(20):
                assert sched.drain(10)
                if s.fake.list(*CRD) and not s.ctrl.busy():
                    break
            assert not s.ctrl.busy(), "rollout stalled waiting on resync"
            assert s.spec_names() == ["web-s8"]
            s.trace.append(("rollout", s.state(s.ctrl.last_sync)))
        finally:
            sched.stop()
    run_both(sc, tmp_path, counted=False)
