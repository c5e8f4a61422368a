"""The port's permanent-failure recovery (``pkg/recovery.py``: the
failure detector and the eviction controller, driven by the scheduler's
pass; the quarantine escalation of ``kubeletplugin/health.py``; the
recovery metrics of both reconcile sweeps) against the JAX package's, on
the CPU.

- **The cluster**: one store loaded into a JAX and a port
  ``FakeKubeClient`` (hand-made slices of ``tests/test_recovery.py``, its
  DeviceClass, Nodes with Ready conditions), a ``DraScheduler`` with an
  ``EvictionController`` attached on each side, driven by ``sync_once``.
  After every pass the two states must be equal: each claim's
  allocation, conditions and reservations, the nodes' taints, the pods,
  the slices, the Events, the eviction records read back from each
  recovery root (their ``plannedAt`` wall clocks aside), the
  controller's pass counts, its excluded nodes, and the
  ``RecoveryMetrics`` exposition. ``uuid.uuid4`` is seeded alike on
  each side. The scenarios are every case of ``TestFailureEscalation``,
  ``TestEvictionPlanning``, ``TestEvictionDurability`` (a fresh
  controller resuming after an ``InjectedCrash`` at each of recovery's
  points), ``TestRecoveryMetrics`` and the polled case of
  ``TestEventDrivenRecovery`` (``test_excluded_node_never_reallocated_onto``).
- **The quarantine escalation** (``TestQuarantineEscalation``): the same
  flap script through both trackers.
- **The node sweeps** (``TestNodeReconcileSweep``, ``TestCDSweep``): the
  kubelet ``Driver``s of ``tests/test_torch_kubeletplugin_driver.py``
  with ``recovery_metrics`` and the ComputeDomain drivers of
  ``tests/test_torch_computedomain.py``: the same counts, state and
  ``tpu_dra_recovery_*`` samples (the port's sweep always reports its
  partition pass, as 0 without an engine; the JAX sweep's ``lease`` pass
  has nothing to repair in the port and reports 0).
- **The binary**: ``python -m k8s_dra_driver_gpu_tpu_torch.pkg.scheduler
  --recovery-root`` (and ``TPU_DRA_RECOVERY_ROOT``) over the port's fake
  API server moves a claim off a NotReady node and serves the recovery
  and fleet families.

``TestEventDrivenRecovery``'s event-mode case waits for the scheduler's
event mode and ``TestEvictionInterleaveDFS`` for ``pkg/analysis``
(ROADMAP.md §1c).
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
import urllib.request
import uuid

import pytest
from prometheus_client import generate_latest
from prometheus_client.parser import text_string_to_metric_families

from k8s_dra_driver_gpu_tpu.kubeletplugin import checkpoint as jax_ckpt
from k8s_dra_driver_gpu_tpu.kubeletplugin import health as jax_health
from k8s_dra_driver_gpu_tpu.pkg import faults as jax_faults
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg import metrics as jax_metrics
from k8s_dra_driver_gpu_tpu.pkg import recovery as jax_recovery
from k8s_dra_driver_gpu_tpu.pkg import scheduler as jax_sched
from k8s_dra_driver_gpu_tpu.pkg import sliceutil as jax_sliceutil
from k8s_dra_driver_gpu_tpu.pkg.analysis import statemachine as jax_sm
from k8s_dra_driver_gpu_tpu_torch.api import deviceclasses as pt_classes
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import checkpoint as pt_ckpt
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import health as pt_health
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.driver import Driver as PtDriver
from k8s_dra_driver_gpu_tpu_torch.pkg import exposition
from k8s_dra_driver_gpu_tpu_torch.pkg import faults as pt_faults
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import metrics as pt_metrics
from k8s_dra_driver_gpu_tpu_torch.pkg import recovery as pt_recovery
from k8s_dra_driver_gpu_tpu_torch.pkg import scheduler as pt_sched
from k8s_dra_driver_gpu_tpu_torch.pkg import sliceutil as pt_sliceutil
from k8s_dra_driver_gpu_tpu_torch.pkg import statemachine as pt_sm
from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
from tests.test_recovery import (add_node, alloc_node, apply_class,
                                 condition, make_pending_claim, make_pod,
                                 node_slices, set_ready)
from tests.test_torch_computedomain import Side as CDSide
from tests.test_torch_computedomain import _ref as cd_ref
from tests.test_torch_kubeletplugin_driver import (  # noqa: F401 - fixtures
    RC, ref, same, servers, sides)
from tests.test_torch_scheduler import Uuids

RES = ("resource.k8s.io", "v1")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("jax", "pt")
M = {
    "jax": dict(kube=jax_kube, sched=jax_sched, rec=jax_recovery,
                metrics=jax_metrics, faults=jax_faults, ckpt=jax_ckpt,
                sm=jax_sm, slices=jax_sliceutil, health=jax_health,
                latest=generate_latest),
    "pt": dict(kube=pt_kube, sched=pt_sched, rec=pt_recovery,
               metrics=pt_metrics, faults=pt_faults, ckpt=pt_ckpt,
               sm=pt_sm, slices=pt_sliceutil, health=pt_health,
               latest=exposition.generate_latest),
}


@pytest.fixture(autouse=True)
def clean_registries():
    for side in SIDES:
        M[side]["faults"].reset()
    yield
    for side in SIDES:
        M[side]["faults"].reset()


def test_constants_equal_the_references():
    for name in ("FAILED_TAINT_KEY", "PERMANENT_FAILURE_CONDITION",
                 "NOTREADY_GRACE_S", "RECOVERY_DEADLINE_S",
                 "MAX_CONCURRENT_EVICTIONS", "DISRUPTION_WEIGHT",
                 "AGE_WEIGHT", "AGE_SCALE_S", "COOP_COST_FACTOR",
                 "MIGRATION_CAPABLE_ANNOTATION"):
        assert getattr(pt_recovery, name) == getattr(jax_recovery, name)
    for name in ("EVICTION_PLANNED", "EVICTION_DRAINING",
                 "EVICTION_DEALLOCATED"):
        assert getattr(pt_sm, name) == getattr(jax_sm, name)
    assert pt_sm.EVICTION_POLICY.allowed == jax_sm.EVICTION_POLICY.allowed


def samples(side, registry):
    text = M[side]["latest"](registry).decode()
    return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                  for f in text_string_to_metric_families(text)
                  for s in f.samples if not s.name.endswith("_created"))


class Cluster:
    """The same cluster on both sides, a scheduler with an eviction
    controller attached on each."""

    def __init__(self, tmp_path, monkeypatch, nodes=("node-a", "node-b"),
                 chips=4, **ctrl_kw):
        self.tmp = tmp_path
        self.uuids = Uuids()
        monkeypatch.setattr(uuid, "uuid4", self.uuids)
        self.ctrl_kw = dict(ctrl_kw)
        self.kubes = {s: M[s]["kube"].FakeKubeClient() for s in SIDES}
        self.metrics = {s: M[s]["metrics"].RecoveryMetrics() for s in SIDES}
        for s in SIDES:
            apply_class(self.kubes[s])
            for node in nodes:
                self.add_node(s, node, chips)
        self.scheds = {s: M[s]["sched"].DraScheduler(self.kubes[s])
                       for s in SIDES}
        self.ctrls = {}
        for s in SIDES:
            self.attach(s)

    def add_node(self, side, node, chips=4):
        add_node(self.kubes[side], node)
        M[side]["slices"].publish_resource_slices(
            self.kubes[side], node_slices(node, chips))

    def root(self, side):
        return str(self.tmp / f"recovery-{side}")

    def attach(self, side):
        ctrl = M[side]["rec"].EvictionController(
            self.kubes[side], self.root(side),
            metrics=self.metrics[side], **self.ctrl_kw)
        self.scheds[side].attach_recovery(ctrl)
        self.ctrls[side] = ctrl
        return ctrl

    def each(self, fn):
        for s in SIDES:
            self.uuids.side = s
            fn(self.kubes[s])

    def sync(self, passes=1):
        for _ in range(passes):
            for s in SIDES:
                self.uuids.side = s
                self.scheds[s].sync_once()
            self.check()

    def state(self, side):
        kube, ctrl = self.kubes[side], self.ctrls[side]
        claims = {}
        for c in kube.list(*RES, "resourceclaims"):
            st = c.get("status", {})
            alloc = st.get("allocation")
            claims[c["metadata"]["name"]] = {
                "allocation": None if not alloc else (
                    sorted(jax_recovery.allocation_nodes(c)),
                    sorted((r["pool"], r["device"]) for r in
                           alloc["devices"]["results"])),
                "conditions": st.get("conditions"),
                "reservedFor": st.get("reservedFor"),
                "uid": c["metadata"].get("uid")}
        nodes = {n["metadata"]["name"]: (n.get("spec", {}).get("taints"),
                                         n.get("status"))
                 for n in kube.list("", "v1", "nodes")}
        pods = {p["metadata"]["name"]: p.get("spec", {}).get("nodeName")
                for p in kube.list("", "v1", "pods")}
        slices = sorted(s["metadata"]["name"]
                        for s in kube.list(*RES, "resourceslices"))
        events = sorted((e["metadata"]["name"], e.get("reason"),
                         e.get("message"))
                        for e in kube.list("", "v1", "events"))
        records = {}
        for uid, rec in ctrl._checkpoint.get().claims.items():
            live = dict(rec.devices[0].live or {})
            live.pop("plannedAt", None)
            records[uid] = (rec.namespace, rec.name, rec.state, live)
        return {"claims": claims, "nodes": nodes, "pods": pods,
                "slices": slices, "events": events, "records": records,
                "last_sync": ctrl.last_sync,
                "excluded": sorted(ctrl.excluded_nodes()),
                "busy": ctrl.busy(),
                "metrics": samples(side, self.metrics[side].registry)}

    def check(self):
        got = {s: self.state(s) for s in SIDES}
        for key in got["jax"]:
            assert got["pt"][key] == got["jax"][key], key
        return got["pt"]

    def alloc(self, name):
        return alloc_node(self.kubes["pt"], name)

    def condition(self, name):
        return condition(self.kubes["pt"], name)


@pytest.fixture()
def cluster(tmp_path, monkeypatch):
    made = []

    def make(**kw):
        kw.setdefault("notready_grace_s", 0.0)
        kw.setdefault("deadline_s", 60.0)
        c = Cluster(tmp_path / f"c{len(made)}", monkeypatch, **kw)
        made.append(c)
        return c
    yield make


# -- TestFailureEscalation -------------------------------------------------------

def test_notready_past_deadline_migrates_claims(cluster):
    c = cluster()
    for i in range(3):
        c.each(lambda k, i=i: make_pending_claim(k, f"c{i}"))
        c.each(lambda k, i=i: make_pod(k, f"c{i}-pod", f"c{i}"))
    c.sync(2)
    victims = [f"c{i}" for i in range(3) if c.alloc(f"c{i}") == "node-b"]
    assert victims
    c.each(lambda k: set_ready(k, "node-b", False))
    c.sync(6)
    for name in victims:
        assert c.alloc(name) == "node-a"
        assert c.condition(name)["reason"] == "Recovered"
    assert c.ctrls["pt"].active_evictions() == {}


def test_notready_within_grace_is_not_escalated(cluster):
    c = cluster(notready_grace_s=3600.0)
    c.each(lambda k: make_pending_claim(k, "c0"))
    c.sync(2)
    node = c.alloc("c0")
    c.each(lambda k: set_ready(k, node, False))
    c.sync(3)
    assert c.ctrls["pt"].active_evictions() == {}
    assert c.condition("c0") is None


def test_node_deletion_retires_slices_and_migrates(cluster):
    c = cluster()
    c.each(lambda k: make_pending_claim(k, "c0", count=4))
    c.sync(2)
    victim = c.alloc("c0")
    c.each(lambda k: k.delete("", "v1", "nodes", victim))
    c.sync(6)
    assert c.alloc("c0") not in (None, victim)
    assert ("tpu_dra_recovery_orphans_repaired_total",
            (("kind", "slice"),), 1.0) in c.check()["metrics"]


def test_fatal_device_taint_evicts_only_its_claim(cluster):
    c = cluster()
    for i in range(2):
        c.each(lambda k, i=i: make_pending_claim(k, f"c{i}"))
    c.sync(2)
    claim = c.kubes["pt"].get(*RES, "resourceclaims", "c0",
                              namespace="default")
    result = claim["status"]["allocation"]["devices"]["results"][0]
    node, device = result["pool"], result["device"]
    chip = int(device.split("-")[1])
    for s in SIDES:
        M[s]["slices"].publish_resource_slices(
            c.kubes[s], node_slices(node, taints_by_chip={chip: [{
                "key": jax_recovery.FAILED_TAINT_KEY, "value": "true",
                "effect": "NoExecute"}]}))
    c.sync(6)
    assert c.condition("c0")["reason"] == "Recovered"
    assert c.condition("c1") is None


@pytest.mark.parametrize("nodes", [("node-a",), ("node-a", "node-b")])
def test_deadline_exceeded_fails_cleanly(cluster, nodes):
    """No surviving capacity (one node; or two with the other filled):
    the eviction retires as cleanly failed."""
    c = cluster(nodes=nodes, deadline_s=0.3)
    if len(nodes) == 2:
        c.each(lambda k: make_pending_claim(k, "filler", count=4))
        c.sync(1)
    c.each(lambda k: make_pending_claim(k, "c0"))
    c.sync(2)
    victim = c.alloc("c0")
    c.each(lambda k: set_ready(k, victim, False))
    c.sync(3)
    time.sleep(0.35)
    c.sync(2)
    cond = c.condition("c0")
    assert (cond["status"], cond["reason"]) == ("True",
                                                "RecoveryDeadlineExceeded")
    assert c.alloc("c0") is None
    assert c.check()["records"] == {}


@pytest.mark.parametrize("script", [
    [[{"metadata": {"name": "bare"}}], [], [{"metadata": {"name": "bare"}}]],
    [[{"metadata": {"name": "a"}, "status": {"conditions": [
        {"type": "Ready", "status": "False"}]}}],
     [{"metadata": {"name": "a"}, "spec": {"taints": [
         {"key": "tpu.dra.dev/failed"}]}}]],
    [[{"metadata": {"name": "a"}}, {"metadata": {"name": "b"}}],
     [{"metadata": {"name": "b"}}], [{"metadata": {"name": "b"}}]],
])
def test_detector_equals_the_references(script):
    dets = {s: M[s]["rec"].FailureDetector(notready_grace_s=0.0)
            for s in SIDES}
    for nodes in script:
        got = {}
        for s in SIDES:
            dets[s].observe_nodes(nodes)
            got[s] = (sorted(dets[s].permanently_failed),
                      sorted(dets[s].deleted_nodes))
        assert got["pt"] == got["jax"]


# -- TestQuarantineEscalation ----------------------------------------------------

def _flap(side, tracker, clock, device, cycles):
    taint = [M[side]["health"].DeviceTaint(
        device=device, key="tpu.dra.dev/thermal", value="true", effect="")]
    out = []
    for _ in range(cycles):
        for step in range(6):
            clock[0] += 5.0
            out.append(tracker.observe(taint if step % 2 == 0 else []))
        clock[0] += 1000.0
        out.append(tracker.observe([]))
    return out


def _taints(ts):
    return [(t.device.replace("chip-", "gpu-"), t.key, t.effect)
            for t in ts]


def test_repeated_quarantines_escalate_to_sticky_failure():
    got = {}
    for s in SIDES:
        clock, failed = [0.0], []
        tracker = M[s]["health"].QuarantineTracker(
            threshold=3, window_s=60.0, hysteresis_s=120.0, fatal_after=3,
            on_failed=failed.append, clock=lambda clock=clock: clock[0])
        dev = "chip-0" if s == "jax" else "gpu-0"
        polls = _flap(s, tracker, clock, dev, 3)
        clock[0] += 10_000.0
        polls.append(tracker.observe([]))
        got[s] = ([_taints(p) for p in polls], sorted(tracker.failed),
                  failed, tracker.total_quarantines, tracker.total_failures)
        got[s] = json.loads(json.dumps(got[s]).replace("chip-", "gpu-"))
    assert got["pt"] == got["jax"]
    assert got["pt"][0][-1] == [["gpu-0", "tpu.dra.dev/failed",
                                 "NoExecute"]]


def test_mark_failed_is_direct_and_idempotent():
    got = {}
    for s in SIDES:
        tracker = M[s]["health"].QuarantineTracker()
        dev = "chip-1" if s == "jax" else "gpu-1"
        tracker.mark_failed(dev)
        tracker.mark_failed(dev)
        out = tracker.observe([M[s]["health"].DeviceTaint(
            device=dev, key="tpu.dra.dev/thermal", value="true",
            effect="")])
        got[s] = (_taints(out), tracker.total_failures)
    assert got["pt"] == got["jax"] == ([("gpu-1", "tpu.dra.dev/failed",
                                         "NoExecute")], 1)


# -- TestEvictionPlanning --------------------------------------------------------

def test_gang_evicts_as_a_unit(cluster):
    c = cluster()
    for name in ("g0", "g1"):
        c.each(lambda k, name=name: make_pending_claim(k, name,
                                                       gang="cd-uid-1"))
    c.sync(2)
    nodes = {n: c.alloc(n) for n in ("g0", "g1")}
    assert set(nodes.values()) == {"node-a", "node-b"}
    dead = nodes["g0"]
    c.each(lambda k: set_ready(k, dead, False))
    c.sync(1)
    state = c.check()
    assert sorted(r[1] for r in state["records"].values()) == ["g0", "g1"]
    assert all(r[3]["disruption"] == 1 for r in state["records"].values())
    c.sync(6)
    survivor = "node-a" if dead == "node-b" else "node-b"
    assert c.alloc("g0") == c.alloc("g1") == survivor


def test_bounded_concurrent_evictions(cluster):
    c = cluster(nodes=("node-a", "node-b", "node-c"), max_concurrent=1)
    for i in range(4):
        c.each(lambda k, i=i: make_pending_claim(k, f"c{i}"))
    c.sync(2)
    victims = [f"c{i}" for i in range(4)
               if c.alloc(f"c{i}") in ("node-b", "node-c")]
    c.each(lambda k: set_ready(k, "node-b", False))
    c.each(lambda k: set_ready(k, "node-c", False))
    c.sync(1)
    assert len(c.ctrls["pt"].active_evictions()) == 1
    c.sync(14)
    assert all(c.alloc(v) == "node-a" for v in victims)


def test_young_claim_admitted_before_old_gang(cluster):
    c = cluster(nodes=("node-b",), max_concurrent=1)
    for name, created in (("old", "2020-01-01T00:00:00Z"), ("young", None)):
        meta = {"name": name, "namespace": "default"}
        if created:
            meta["creationTimestamp"] = created
        obj = {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
               "metadata": meta, "spec": {"devices": {"requests": [{
                   "name": "tpu",
                   "exactly": {"deviceClassName": "tpu.dra.dev"}}]}}}
        c.each(lambda k, obj=obj: k.create(*RES, "resourceclaims",
                                           json.loads(json.dumps(obj)),
                                           namespace="default"))
    c.sync(2)
    for s in SIDES:
        c.add_node(s, "node-a")
    c.each(lambda k: set_ready(k, "node-b", False))
    c.sync(1)
    young = c.kubes["pt"].get(*RES, "resourceclaims", "young",
                              namespace="default")["metadata"]["uid"]
    assert list(c.ctrls["pt"].active_evictions()) == [young]
    c.sync(14)
    assert c.alloc("old") == c.alloc("young") == "node-a"


@pytest.mark.parametrize("case", [
    [], [{"metadata": {"annotations": {
        "resource.tpu.dra/migration-capable": "true"}}}],
    [{"metadata": {"annotations": {
        "resource.tpu.dra/migration-capable": "true"}}},
     {"metadata": {"annotations": {
         "resource.tpu.dra/migration-capable": "false"}}}],
    [{"metadata": {"creationTimestamp": "2020-01-01T00:00:00Z"}},
     {"metadata": {"creationTimestamp": "not a time"}},
     {"metadata": {"creationTimestamp": "2026-10-18T00:00:00"}}],
])
def test_cost_terms_equal_the_references(case):
    now = 1_800_000_000.0
    got = {s: (M[s]["rec"].coop_cost_multiplier(case),
               M[s]["rec"].age_cost(case, now=now),
               [M[s]["rec"].claim_age_s(c, now=now) for c in case],
               [M[s]["rec"].claim_migration_capable(c) for c in case])
           for s in SIDES}
    assert got["pt"] == got["jax"]


# -- TestEvictionDurability ------------------------------------------------------

def _failed_cluster(cluster):
    c = cluster()
    c.each(lambda k: make_pending_claim(k, "c0"))
    c.each(lambda k: make_pod(k, "c0-pod", "c0"))
    c.sync(2)
    node = c.alloc("c0")
    c.each(lambda k: set_ready(k, node, False))
    return c


@pytest.mark.parametrize("point", ["recovery.sync", "recovery.plan",
                                   "recovery.drain", "recovery.dealloc"])
def test_controller_crash_resumes_idempotently(cluster, point):
    c = _failed_cluster(cluster)
    for s in SIDES:
        f = M[s]["faults"]
        with f.inject(point, mode="crash", count=1):
            for _ in range(4):
                try:
                    c.ctrls[s].sync_once()
                except f.InjectedCrash:
                    break
            else:
                pytest.fail(f"{point} never fired on {s}")
    c.check()
    # The dead controller's replacement resumes from the durable records.
    for s in SIDES:
        c.attach(s)
    c.check()
    c.sync(6)
    assert c.condition("c0")["reason"] == "Recovered"
    assert c.ctrls["pt"].active_evictions() == {}


def test_claim_deleted_mid_eviction_cancels(cluster):
    c = _failed_cluster(cluster)
    for s in SIDES:
        c.ctrls[s].sync_once()
    assert c.check()["records"]
    c.each(lambda k: k.delete(*RES, "resourceclaims", "c0",
                              namespace="default"))
    c.sync(2)
    assert c.check()["records"] == {}


def test_illegal_stage_skip_fails_the_commit(tmp_path):
    """absent -> Draining is refused on both; the JAX manager's group
    commit wraps the refusal in RuntimeError, the port's raises it."""
    got = {}
    for s in SIDES:
        ckpt, sm = M[s]["ckpt"], M[s]["sm"]
        ctrl = M[s]["rec"].EvictionController(M[s]["kube"].FakeKubeClient(),
                                              str(tmp_path / s))
        dev = [ckpt.CheckpointedDevice(canonical_name="eviction",
                                       kind="eviction", live={})]
        try:
            ctrl._checkpoint.update_claim("u1", ckpt.CheckpointedClaim(
                uid="u1", namespace="default", name="c",
                state=sm.EVICTION_DRAINING, devices=dev))
            err = None
        except Exception as e:  # noqa: BLE001 - compared
            err = e.__cause__ if s == "jax" else e
        for state in (sm.EVICTION_PLANNED, sm.EVICTION_DRAINING,
                      sm.EVICTION_DEALLOCATED):
            ctrl._checkpoint.update_claim("u1", ckpt.CheckpointedClaim(
                uid="u1", namespace="default", name="c", state=state,
                devices=dev))
        ctrl._checkpoint.update_claim("u1", None)
        got[s] = (type(err).__name__, str(err),
                  dict(ctrl._checkpoint.get().claims))
    assert got["pt"] == got["jax"]
    assert got["pt"][0] == "CheckpointTransitionError"


def test_generated_claim_with_dead_owner_is_gcd(cluster):
    c = cluster()
    c.each(lambda k: make_pending_claim(k, "gen-c"))
    c.each(lambda k: k.patch(*RES, "resourceclaims", "gen-c", {
        "metadata": {"ownerReferences": [{
            "apiVersion": "v1", "kind": "Pod", "name": "owner",
            "uid": "pod-uid", "controller": True}]}}, namespace="default"))
    c.sync(2)
    node = c.alloc("gen-c")
    c.each(lambda k: set_ready(k, node, False))
    c.sync(6)
    assert "gen-c" not in c.check()["claims"]


def test_excluded_node_never_reallocated_onto(cluster):
    c = cluster()
    c.each(lambda k: make_pending_claim(k, "c0", count=4))
    c.sync(2)
    victim = c.alloc("c0")
    c.each(lambda k: make_pending_claim(k, "blocker", count=4))
    c.sync(2)
    c.each(lambda k: set_ready(k, victim, False))
    c.sync(6)
    assert c.alloc("c0") is None
    assert c.condition("c0")["status"] == "True"
    assert c.check()["excluded"] == [victim]


# -- TestRecoveryMetrics and the SLO -------------------------------------------

def test_exposition(cluster):
    c = cluster()
    c.each(lambda k: make_pending_claim(k, "m0"))
    c.sync(2)
    node = c.alloc("m0")
    c.each(lambda k: set_ready(k, node, False))
    c.sync(6)
    got = c.check()["metrics"]
    for sample in (("tpu_dra_recovery_evictions_total", (), 1.0),
                   ("tpu_dra_recovery_replaced_total", (), 1.0),
                   ("tpu_dra_recovery_permanent_failures_total",
                    (("source", "node"),), 1.0),
                   ("tpu_dra_recovery_active_evictions", (), 0.0)):
        assert sample in got


def test_evict_phase_on_the_scheduler_slo(tmp_path, monkeypatch):
    """``attach_recovery`` points the controller at the scheduler's SLO:
    a re-placement observes one ``evict`` sample on each side."""
    monkeypatch.setattr(uuid, "uuid4", Uuids())
    got = {}
    for s in SIDES:
        kube = M[s]["kube"].FakeKubeClient()
        apply_class(kube)
        for node in ("node-a", "node-b"):
            add_node(kube, node)
            M[s]["slices"].publish_resource_slices(kube, node_slices(node))
        sm = M[s]["metrics"].SchedulerMetrics()
        sched = M[s]["sched"].DraScheduler(kube, sched_metrics=sm)
        ctrl = M[s]["rec"].EvictionController(
            kube, str(tmp_path / s), notready_grace_s=0.0)
        assert sched.attach_recovery(ctrl) is sched
        assert ctrl.view is sched.view and ctrl.slo is sm.slo
        make_pending_claim(kube, "c0")
        sched.sync_once()
        set_ready(kube, alloc_node(kube, "c0"), False)
        for _ in range(6):
            sched.sync_once()
        got[s] = [x for x in samples(s, sm.registry)
                  if x[0] == "tpu_dra_claim_e2e_seconds_count"
                  and ("phase", "evict") in x[1]]
    assert got["pt"] == got["jax"]
    assert got["pt"][0][2] == 1.0


# -- the node sweeps -------------------------------------------------------------

def _sweep_metrics(side, registry):
    """The sweep's samples; the port's always-reported partition pass
    (0 without an engine) aside."""
    return [x for x in samples(side.name, registry)
            if not (x[0] == "tpu_dra_recovery_reconcile_drift"
                    and x[1] == (("kind", "idle_partition"),)
                    and x[2] == 0.0)]


def _sweep_driver(side, **kw):
    rec = M[side.name]["metrics"].RecoveryMetrics()
    d = side.driver(recovery_metrics=rec, **kw)
    return d, rec


def _sweep(d):
    counts = dict(d.reconciler.reconcile_once())
    counts.setdefault("idle_partition", 0)
    return counts


def test_sweep_stale_and_devices_gone_metrics(sides):
    def run(side):
        d, rec = _sweep_driver(side)
        side.put_claim("stale", [0])
        assert d.prepare_resource_claims([ref("stale")])["stale"][1] == ""
        side.kube.delete(*RC, "stale", namespace="default")
        side.put_claim("gone", [3])
        assert d.prepare_resource_claims([ref("gone")])["gone"][1] == ""
        d2, rec2 = _sweep_driver(side, gpus=2)
        first = (_sweep(d), _sweep(d2))
        claim = side.kube.get(*RC, "gone", namespace="default")
        return (first, [(c["reason"], c["status"]) for c in
                        claim["status"]["conditions"]],
                _sweep_metrics(side, rec.registry),
                _sweep_metrics(side, rec2.registry))
    got = same(sides, run)
    assert "'DevicesGone'" in got and "'sweep'" in got
    assert "'stale_claim'" in got


def test_sweep_drains_moved_claims_with_metrics(sides):
    def run(side):
        d, rec = _sweep_driver(side)
        side.put_claim("moving", [0])
        assert d.prepare_resource_claims([ref("moving")])["moving"][1] == ""
        kept = _sweep(d)
        side.kube.patch(*RC, "moving", {"status": {"allocation": None}},
                        namespace="default")
        moved = _sweep(d)
        return (kept, moved, sorted(d.state.prepared_claims()),
                d.state._cdi.spec_exists("moving"),
                _sweep_metrics(side, rec.registry))
    got = same(sides, run)
    assert "'moved_claim': 1" in got and "'moved_claim'" in got


def test_sweep_orphan_spec_then_converged(sides):
    def run(side):
        d, rec = _sweep_driver(side)
        from tests.test_torch_kubeletplugin_reconcile import (
            jax_cdi, pt_cdi)
        mod = pt_cdi if side.name == "pt" else jax_cdi
        d.state._cdi.create_claim_spec_file(
            "ghost", {side.dev(1): mod.ContainerEdits(env=["A=1"])})
        return (_sweep(d), _sweep(d), _sweep_metrics(side, rec.registry))
    got = same(sides, run)
    assert "'cdi_spec': 1" in got


@pytest.mark.parametrize("point", ["ckpt.write", "ckpt.fsync"])
def test_crash_during_unprepare_then_sweep_restores(sides, point):
    """A crash in the unprepare of a claim the controller deleted, then
    a fresh plugin and two sweeps: nothing left on either side."""
    def run(side):
        d, _ = _sweep_driver(side, sub="crashy")
        side.put_claim("victim", [0])
        assert d.prepare_resource_claims([ref("victim")])["victim"][1] == ""
        side.kube.delete(*RC, "victim", namespace="default")
        f = M[side.name]["faults"]
        with f.inject(point, mode="crash", count=1):
            try:
                d.state.unprepare("victim")
                outcome = "ok"
            except BaseException as e:  # noqa: BLE001 - compared
                # The JAX group commit wraps the crash in RuntimeError.
                outcome = type(e.__cause__ or e).__name__
        fresh, rec = _sweep_driver(side, sub="crashy")
        sweeps = (_sweep(fresh), _sweep(fresh))
        return (outcome, sweeps, fresh.state.prepared_claims() == {},
                sorted(fresh.state._cdi.list_claim_uids()),
                _sweep_metrics(side, rec.registry))
    got = same(sides, run)
    assert "'InjectedCrash'" in got


def test_cd_sweep_metrics(tmp_path):
    """``TestCDSweep``: the ComputeDomain plugin's sweep with
    ``recovery_metrics``: a stale record and an orphan spec repaired and
    counted alike."""
    from k8s_dra_driver_gpu_tpu.kubeletplugin.cdi import \
        ContainerEdits as JaxEdits
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.cdi import \
        ContainerEdits as PtEdits
    got = {}
    for s in SIDES:
        side = CDSide(s, tmp_path)
        try:
            cd = side.make_cd()
            uid = cd["metadata"]["uid"]
            side.set_status(cd, [("node-0", "0", 0, "10.0.0.1")])
            st = side.state("node-0", "st")
            rec = M[s]["metrics"].RecoveryMetrics()
            drv = side.cdd.CDDriver(st, side.kube, "node-0",
                                    retry_timeout=2.0,
                                    recovery_metrics=rec)
            side.put_claim("gone", uid, device="channel-1")
            drv.prepare_resource_claims([cd_ref("gone")])
            side.kube.delete(*RES, "resourceclaims", "gone",
                             namespace="team-a")
            st._cdi.create_claim_spec_file(
                "orphan", {"channel-3": (PtEdits if s == "pt"
                                         else JaxEdits)()})
            sweeps = [drv.reconciler.reconcile_once() for _ in range(2)]
            got[s] = (sweeps, samples(s, rec.registry))
        finally:
            side.close()
    assert got["pt"] == got["jax"]
    assert ("tpu_dra_recovery_orphans_repaired_total",
            (("kind", "cd_stale_claim"),), 1.0) in got["pt"][1]


# -- the binary ------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _wait(fn, timeout=30.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        out = fn()
        if out:
            return out
        time.sleep(0.05)
    raise AssertionError("timed out")


@pytest.mark.parametrize("how", ["flag", "env"])
def test_binary_with_a_recovery_root_moves_a_claim(tmp_path, how):
    server = FakeApiServer().start()
    kube = server.store
    proc = None
    drivers = []
    try:
        pt_classes.create_all(kube)
        for node in ("node-a", "node-b"):
            kube.create("", "v1", "nodes", {"metadata": {"name": node},
                                            "status": {"conditions": [{
                                                "type": "Ready",
                                                "status": "True"}]}})
            d = PtDriver(pt_ds.Config.mock(str(tmp_path / node), "h100-4"),
                         kube, node, False)
            d.publish_resources()
            drivers.append(d)
        kube.create(*RES, "resourceclaims", {
            "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": "c", "namespace": "default"},
            "spec": {"devices": {"requests": [{"name": "gpu", "exactly": {
                "deviceClassName": pt_classes.GPU_CLASS}}]}}},
            namespace="default")
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=ROOT, V="2",
                   TPU_DRA_RECOVERY_NOTREADY_S="0.2",
                   TPU_DRA_DEBUG_HTTP="1")
        argv = [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.pkg."
                "scheduler", "--kube-api", server.url, "--interval", "0.1",
                "--metrics-port", str(port)]
        if how == "flag":
            argv += ["--recovery-root", str(tmp_path / "rec")]
        else:
            env["TPU_DRA_RECOVERY_ROOT"] = str(tmp_path / "rec")
        proc = subprocess.Popen(argv, env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)

        def placed():
            c = kube.get(*RES, "resourceclaims", "c", "default")
            alloc = c.get("status", {}).get("allocation")
            return alloc and alloc["nodeSelector"]["nodeSelectorTerms"][
                0]["matchFields"][0]["values"][0]
        first = _wait(placed)
        kube.patch("", "v1", "nodes", first, {"status": {"conditions": [{
            "type": "Ready", "status": "False"}]}})
        second = _wait(lambda: (lambda n: n if n and n != first
                                else None)(placed()))
        cond = _wait(lambda: [c for c in kube.get(
            *RES, "resourceclaims", "c", "default")["status"].get(
                "conditions") or [] if c["reason"] == "Recovered"])
        assert second != first and cond
        text = _wait(lambda: (lambda t: t if
                              "tpu_dra_recovery_replaced_total 1.0" in t
                              else None)(urllib.request.urlopen(
                                  f"http://127.0.0.1:{port}/metrics",
                                  timeout=5).read().decode()))
        assert 'tpu_dra_fleet_pool_utilization{pool="gpu.nvidia.com/' in text
        fleet = json.loads(urllib.request.urlopen(
            f"http://127.0.0.1:{port}/debug/fleet", timeout=5).read())
        assert fleet["passes_total"] > 0
        assert sorted(fleet["pools"]) == ["gpu.nvidia.com/node-a",
                                          "gpu.nvidia.com/node-b"]
        assert os.path.exists(tmp_path / "rec" / "checkpoint.json")
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, err[-2000:]
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        for d in drivers:
            d.stop()
        server.stop()


def test_scheduler_pass_order_matches(cluster):
    """Recovery runs first in the pass: a claim deallocated this pass
    re-places in the same pass on both sides (one pass from Draining to
    re-placed)."""
    c = cluster()
    c.each(lambda k: make_pending_claim(k, "c0"))
    c.sync(1)
    node = c.alloc("c0")
    c.each(lambda k: set_ready(k, node, False))
    c.sync(1)   # planned + drained
    c.sync(1)   # deallocated, then re-placed in the same pass
    assert c.alloc("c0") not in (None, node)
