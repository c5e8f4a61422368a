"""The port's scheduler (``pkg/scheduler.py``, ``pkg/schedcache.py``)
against the JAX package's, on the CPU.

- **Scenarios.** One store is loaded into a JAX ``FakeKubeClient`` and a
  port ``FakeKubeClient``: the slices the JAX ``Driver`` publishes over
  ``Config.mock(topology=...)`` (or hand-made slices, as the JAX tests
  make them), the JAX chart's DeviceClasses (rendered by the JAX
  ``chartrender``), and the claims, templates, pods, nodes, DaemonSets
  and Jobs of the scenario, applied to both alike. Each side's
  ``sync_once`` runs the scenario's passes, then until a pass changes
  nothing; the claims' spec, ``status.allocation``, ``reservedFor`` and
  conditions, the pods' ``nodeName``, claim statuses and conditions, the
  generated claims, the Jobs' status and the Events are equal (the
  traceparent's value aside: its ids are random; its presence is
  compared). ``uuid.uuid4`` is seeded alike on each side, so generated
  names agree. The scenarios are every case of ``tests/test_scheduler.py``,
  the scheduler cases of ``tests/test_powersched.py`` that need no fleet
  fold, topology order on ``v5e-16`` and ``v5p-32`` (gate on and off), a
  ComputeDomain window, and a DaemonSet and a Job materialised.
- **Allocation state.** Seeded random sequences of ``try_commit``,
  ``observe``, ``forget`` and ``rebuild`` on both ``AllocationState``\\ s
  and of debits and credits on both ``CounterLedger``\\ s are equal after
  every step: returns, the allocated set, slot counts, node loads, power
  debits, the ledger and the node order.
- **Tracing**: the port's ``sync_once`` and the port's
  ``DeviceState.prepare`` give one trace whose tree holds ``sched.commit``
  -> ``prepare`` -> ``prep_devices``.
- **Refusals**: each way into what is not ported raises
  ``NotPortedError`` naming its ROADMAP.md item; what the recovery and
  fleet slice brought in (``attach_recovery``, ``fleet_metrics``,
  ``--recovery-root``, ``TPU_DRA_RECOVERY_ROOT``) runs as the JAX
  scheduler's does, and so do the defrag and migration controllers'
  attach points (their placement hint and reservation veto, against the
  JAX scheduler with stand-in controllers) and roots (``--defrag-root``,
  ``--migration-root`` and their env); ``tests/test_torch_defrag.py``
  and ``tests/test_torch_migration.py`` hold the controllers
  themselves.
- **The binary** against the port's ``FakeApiServer``: it allocates,
  reserves, binds, serves ``/metrics`` and exits 0 on SIGTERM.
"""

import json
import os
import random
import signal
import socket
import subprocess
import sys
import threading
import time
import urllib.request
import uuid

import numpy as np
import pytest
from prometheus_client import generate_latest
from prometheus_client.parser import text_string_to_metric_families

from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
from k8s_dra_driver_gpu_tpu.kubeletplugin.driver import Driver as JaxDriver
from k8s_dra_driver_gpu_tpu.pkg import featuregates as jax_fg
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg import schedcache as jax_cache
from k8s_dra_driver_gpu_tpu.pkg import scheduler as jax_sched
from k8s_dra_driver_gpu_tpu_torch.api import deviceclasses as pt_classes
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import ResourceClaim
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.driver import Driver as PtDriver
from k8s_dra_driver_gpu_tpu_torch.pkg import exposition
from k8s_dra_driver_gpu_tpu_torch.pkg import featuregates as pt_fg
from k8s_dra_driver_gpu_tpu_torch.pkg import flightrecorder as pt_fr
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import metrics as pt_metrics
from k8s_dra_driver_gpu_tpu_torch.pkg import schedcache as pt_cache
from k8s_dra_driver_gpu_tpu_torch.pkg import scheduler as pt_sched
from k8s_dra_driver_gpu_tpu_torch.pkg import tracing as pt_tracing
from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
from tests.test_powersched import anomaly_taint, make_slice
from tests.test_scheduler import apply_device_classes, make_claim

RES = ("resource.k8s.io", "v1")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("jax", "pt")
TRACEPARENT = pt_tracing.TRACEPARENT_ANNOTATION


# -- the store ---------------------------------------------------------------

def _published(tmp, topology: str, nodes: int = 1, taints=None,
               gates: str | None = None) -> list[dict]:
    """The slices the JAX ``Driver`` publishes for ``nodes`` hosts of a
    mock ``topology`` (node ``node-a`` for one host, ``node-<w>`` for
    more), with ``taints`` (device -> taints) on the first."""
    src = jax_kube.FakeKubeClient()
    for w in range(nodes):
        kw = {} if gates is None else {"gates": gates}
        d = JaxDriver(jax_ds.Config.mock(root=str(tmp / f"{topology}-{w}"),
                                         topology=topology, worker_id=w,
                                         **kw),
                      src, node_name="node-a" if nodes == 1 else f"node-{w}",
                      enable_health_monitor=False,
                      publication_mode="combined")
        if w == 0 and taints:
            d._taints.update(taints)
        d.publish_resources()
    return src.list(*RES, "resourceslices")


def _chart_classes() -> list[dict]:
    src = jax_kube.FakeKubeClient()
    apply_device_classes(src)
    return src.list(*RES, "deviceclasses")


def _power_store() -> list[tuple[tuple, dict]]:
    return [(RES + ("deviceclasses",), {
        "apiVersion": "resource.k8s.io/v1", "kind": "DeviceClass",
        "metadata": {"name": "tpu"}, "spec": {}})]


def _strip(obj: dict) -> dict:
    obj = json.loads(json.dumps(obj))
    for key in ("uid", "resourceVersion", "creationTimestamp"):
        obj.get("metadata", {}).pop(key, None)
    return obj


class Uuids:
    """``uuid.uuid4`` from a seeded generator, one stream a side."""

    def __init__(self):
        self.rngs = {side: random.Random(7) for side in SIDES}
        self.side = "jax"

    def __call__(self):
        return uuid.UUID(int=self.rngs[self.side].getrandbits(128))


class World:
    """One store in both fakes, a scheduler over each."""

    def __init__(self, objects, monkeypatch, gates: str = ""):
        self.uuids = Uuids()
        monkeypatch.setattr(uuid, "uuid4", self.uuids)
        self.kubes = {"jax": jax_kube.FakeKubeClient(),
                      "pt": pt_kube.FakeKubeClient()}
        for kube in self.kubes.values():
            for gvr, obj in objects:
                ns = obj.get("metadata", {}).get("namespace")
                kube.create(*gvr, _strip(obj), namespace=ns)
        self.scheds = {
            "jax": jax_sched.DraScheduler(
                self.kubes["jax"], gates=jax_fg.FeatureGates.parse(gates)),
            "pt": pt_sched.DraScheduler(
                self.kubes["pt"], gates=pt_fg.FeatureGates.parse(gates)),
        }

    def each(self, fn):
        """Apply ``fn(kube)`` to both stores."""
        for side in SIDES:
            self.uuids.side = side
            fn(self.kubes[side])

    def sync(self, passes: int = 1, settle: bool = True) -> dict:
        """``passes`` passes a side, then (``settle``) passes until one
        changes nothing; the two states, asserted equal."""
        states = {}
        for side in SIDES:
            self.uuids.side = side
            sched = self.scheds[side]
            for _ in range(passes):
                sched.sync_once()
            state = self.state(side)
            for _ in range(6 if settle else 0):
                sched.sync_once()
                again = self.state(side)
                if again == state:
                    break
                state = again
            states[side] = state
        assert states["pt"] == states["jax"]
        return states["pt"]

    def state(self, side: str) -> dict:
        kube = self.kubes[side]
        claims = {}
        for c in kube.list(*RES, "resourceclaims"):
            md = c["metadata"]
            ann = dict(md.get("annotations") or {})
            traced = ann.pop(TRACEPARENT, None) is not None
            claims[(md.get("namespace"), md["name"])] = {
                "uid": md.get("uid") if md.get("ownerReferences") else None,
                "annotations": ann, "traced": traced,
                "owners": md.get("ownerReferences"),
                "spec": c.get("spec"),
                "allocation": c.get("status", {}).get("allocation"),
                "reservedFor": c.get("status", {}).get("reservedFor"),
                "conditions": c.get("status", {}).get("conditions"),
            }
        pods = {}
        for p in kube.list("", "v1", "pods"):
            md = p["metadata"]
            pods[(md.get("namespace"), md["name"])] = {
                "nodeName": p.get("spec", {}).get("nodeName"),
                "spec": p.get("spec"), "status": p.get("status"),
                "labels": md.get("labels"),
                "owners": md.get("ownerReferences"),
            }
        events = sorted(
            json.dumps({k: e.get(k) for k in (
                "type", "reason", "message", "involvedObject", "source")}
                | {"name": e["metadata"]["name"]}, sort_keys=True)
            for e in kube.list("", "v1", "events"))
        jobs = {j["metadata"]["name"]: j.get("status")
                for j in kube.list("batch", "v1", "jobs")}
        return {"claims": claims, "pods": pods, "events": events,
                "jobs": jobs}


def allocation(state, name, ns="default"):
    return state["claims"][(ns, name)]["allocation"]


def devices_of(state, name):
    alloc = allocation(state, name)
    return sorted(r["device"] for r in alloc["devices"]["results"])


def node_of(alloc):
    return alloc["nodeSelector"]["nodeSelectorTerms"][0]["matchFields"][
        0]["values"][0]


# -- scenarios ---------------------------------------------------------------

def _claim_obj(name, requests, constraints=None, ns="default", config=None):
    devices = {"requests": requests}
    if constraints is not None:
        devices["constraints"] = constraints
    if config is not None:
        devices["config"] = config
    return {"apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
            "metadata": {"name": name, "namespace": ns},
            "spec": {"devices": devices}}


def _create_claim(w, name, requests, **kw):
    w.each(lambda k: k.create(*RES, "resourceclaims",
                              _claim_obj(name, requests, **kw),
                              namespace=kw.get("ns", "default")))


def _pod(name, claim_entry=None, limits=None, node=None, phase=None,
         ns="default"):
    pod = {"apiVersion": "v1", "kind": "Pod",
           "metadata": {"name": name, "namespace": ns},
           "spec": {"containers": [{"name": "c", "command": ["true"]}]}}
    if claim_entry is not None:
        pod["spec"]["resourceClaims"] = [{"name": "tpu", **claim_entry}]
    if limits is not None:
        pod["spec"]["containers"][0]["resources"] = {"limits": limits}
    if node:
        pod["spec"]["nodeName"] = node
    if phase:
        pod["status"] = {"phase": phase}
    return pod


def _create_pod(w, *args, **kw):
    pod = _pod(*args, **kw)
    w.each(lambda k: k.create("", "v1", "pods", pod,
                              namespace=pod["metadata"]["namespace"]))


def _constrained(w, name, count, attr, requests=None):
    _create_claim(w, name, [{"name": "tpu", "exactly": {
        "deviceClassName": "tpu.dra.dev", "count": count}}],
        constraints=[{**({"requests": requests} if requests else {}),
                      "matchAttribute": attr}])


def sc_allocates_chip_and_pins_node(w):
    w.each(lambda k: make_claim(k, "c1"))
    s = w.sync()
    assert devices_of(s, "c1")[0].startswith("chip-")
    assert node_of(allocation(s, "c1")) == "node-a"
    assert s["claims"][("default", "c1")]["traced"]


def sc_device_exclusivity_across_claims(w):
    for i in range(4):
        w.each(lambda k, i=i: make_claim(k, f"c{i}"))
    w.each(lambda k: make_claim(k, "c-overflow"))
    s = w.sync()
    assert len({devices_of(s, f"c{i}")[0] for i in range(4)}) == 4
    assert allocation(s, "c-overflow") is None


def sc_request_cel_selector(w):
    w.each(lambda k: make_claim(k, "match", cel=(
        'device.attributes["tpu.dra.dev"].platform == "v5e"')))
    w.each(lambda k: make_claim(k, "nomatch", cel=(
        'device.attributes["tpu.dra.dev"].platform == "v99x"')))
    s = w.sync()
    assert allocation(s, "match") and allocation(s, "nomatch") is None


def sc_counters_block_partition_overlap(w):
    w.each(lambda k: make_claim(k, "all-chips", count=4))
    w.each(lambda k: make_claim(k, "carve",
                                device_class="subslice.tpu.dra.dev"))
    s = w.sync()
    assert allocation(s, "all-chips") and allocation(s, "carve") is None
    w.each(lambda k: k.delete(*RES, "resourceclaims", "all-chips",
                              "default"))
    assert allocation(w.sync(), "carve")


def sc_partition_blocks_parent_chip(w):
    w.each(lambda k: make_claim(k, "carve",
                                device_class="subslice.tpu.dra.dev"))
    assert allocation(w.sync(), "carve")
    w.each(lambda k: make_claim(k, "chips", count=4))
    assert allocation(w.sync(), "chips") is None


def sc_all_mode_takes_every_match(w):
    w.each(lambda k: make_claim(k, "everything", mode="All"))
    assert len(devices_of(w.sync(), "everything")) == 4


def sc_taint_noschedule_skips_device(w):
    w.each(lambda k: make_claim(k, "wants-chip0", cel=(
        'device.attributes["tpu.dra.dev"].uuid != ""'), count=4))
    assert allocation(w.sync(), "wants-chip0") is None
    w.each(lambda k: make_claim(k, "tolerant", count=4, tolerations=[{
        "key": "tpu.dra.dev/chip-lost", "operator": "Exists",
        "effect": "NoSchedule"}]))
    assert allocation(w.sync(), "tolerant")


def sc_class_config_propagates(w):
    w.each(lambda k: k.create(*RES, "deviceclasses", {
        "apiVersion": "resource.k8s.io/v1", "kind": "DeviceClass",
        "metadata": {"name": "tuned.tpu.dra.dev"},
        "spec": {"selectors": [{"cel": {"expression":
                                        'device.driver == "tpu.dra.dev"'}}],
                 "config": [{"opaque": {
                     "driver": "tpu.dra.dev",
                     "parameters": {"kind": "TpuConfig", "sharing": {
                         "strategy": "TimeSlicing"}}}}]}}))
    w.each(lambda k: make_claim(k, "tuned",
                                device_class="tuned.tpu.dra.dev"))
    cfg = allocation(w.sync(), "tuned")["devices"]["config"]
    assert cfg[0]["source"] == "FromClass"


def sc_stale_pool_generation_invisible(w):
    w.each(lambda k: k.create(*RES, "resourceslices", {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
        "metadata": {"name": "stale-slice"},
        "spec": {"driver": "tpu.dra.dev", "nodeName": "node-a",
                 "pool": {"name": "node-a", "generation": 0,
                          "resourceSliceCount": 1},
                 "devices": [{"name": "phantom-chip", "attributes": {
                     "platform": {"string": "v5e"}}}]}}))
    w.each(lambda k: make_claim(k, "phantom", cel=(
        'device.attributes["tpu.dra.dev"].platform == "v5e"'), count=5))
    assert allocation(w.sync(), "phantom") is None


def sc_template_to_claim_to_binding(w):
    w.each(lambda k: k.create(*RES, "resourceclaimtemplates", {
        "apiVersion": "resource.k8s.io/v1",
        "kind": "ResourceClaimTemplate",
        "metadata": {"name": "tpl", "namespace": "default"},
        "spec": {"spec": {"devices": {"requests": [
            {"name": "tpu",
             "exactly": {"deviceClassName": "tpu.dra.dev"}}]}}},
    }, namespace="default"))
    _create_pod(w, "worker", {"resourceClaimTemplateName": "tpl"})
    w.sync(passes=1, settle=False)  # generate
    s = w.sync()  # allocate, reserve, bind
    pod = s["pods"][("default", "worker")]
    (generated,) = pod["status"]["resourceClaimStatuses"]
    claim = s["claims"][("default", generated["resourceClaimName"])]
    assert claim["allocation"] and pod["nodeName"] == "node-a"
    assert claim["reservedFor"][0]["name"] == "worker"


def sc_shared_claim_two_pods_one_allocation(w):
    w.each(lambda k: make_claim(k, "shared"))
    for name in ("a", "b"):
        _create_pod(w, name, {"resourceClaimName": "shared"})
    s = w.sync()
    assert {r["name"] for r in s["claims"][("default", "shared")][
        "reservedFor"]} == {"a", "b"}


def sc_unsatisfied_pod_stays_unbound(w):
    w.each(lambda k: make_claim(k, "never", cel=(
        'device.attributes["tpu.dra.dev"].platform == "v99x"')))
    _create_pod(w, "stuck", {"resourceClaimName": "never"})
    assert not w.sync(passes=3)["pods"][("default", "stuck")]["nodeName"]


def _ext_class(w):
    w.each(lambda k: k.patch(*RES, "deviceclasses", "tpu.dra.dev", {
        "spec": {"extendedResourceName": "google.com/tpu"}}))


def sc_ext_pending_pod_gets_claim_and_binds(w):
    _ext_class(w)
    _create_pod(w, "legacy", limits={"google.com/tpu": "1"})
    s = w.sync(passes=2)
    assert s["pods"][("default", "legacy")]["nodeName"] == "node-a"


def sc_ext_already_bound_pod_is_skipped(w):
    _ext_class(w)
    _create_pod(w, "bound", limits={"google.com/tpu": "1"}, node="node-a")
    assert w.sync()["claims"] == {}


def sc_ext_pod_past_pending_is_skipped(w):
    _ext_class(w)
    _create_pod(w, "running", limits={"google.com/tpu": "1"},
                phase="Running")
    assert w.sync()["claims"] == {}


def sc_ext_malformed_quantity_surfaces_on_the_pod(w):
    _ext_class(w)
    _create_pod(w, "bad", limits={"google.com/tpu": "1.5"})
    s = w.sync(passes=1, settle=False)
    (cond,) = s["pods"][("default", "bad")]["status"]["conditions"]
    assert cond["reason"] == "InvalidExtendedResourceQuantity"
    assert len(s["events"]) == 1
    assert len(w.sync(passes=2)["events"]) == 1  # deduped


def sc_ext_malformed_pod_does_not_wedge_others(w):
    _ext_class(w)
    _create_pod(w, "bad", limits={"google.com/tpu": "1.5"})
    _create_pod(w, "good", limits={"google.com/tpu": "1"})
    s = w.sync(passes=2)
    assert s["pods"][("default", "good")]["nodeName"] == "node-a"


def sc_aligned_pair_lands_on_one_row(w):
    _constrained(w, "row", 2, "tpu.dra.dev/iciY")
    assert len(devices_of(w.sync(), "row")) == 2


def sc_unalignable_count_stays_pending(w):
    _constrained(w, "impossible", 3, "tpu.dra.dev/iciY")
    assert allocation(w.sync(passes=2), "impossible") is None


def sc_missing_attribute_stays_pending(w):
    _constrained(w, "noattr", 2, "tpu.dra.dev/noSuchAttr")
    assert allocation(w.sync(), "noattr") is None


def sc_unknown_constraint_type_fails_closed(w):
    _create_claim(w, "future", [{"name": "tpu", "exactly": {
        "deviceClassName": "tpu.dra.dev"}}],
        constraints=[{"someFutureField": {"x": 1}}])
    assert allocation(w.sync(), "future") is None


def sc_backtracking_escapes_greedy_trap(w):
    w.each(lambda k: k.create(*RES, "resourceslices", {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceSlice",
        "metadata": {"name": "trap-slice"},
        "spec": {"driver": "tpu.dra.dev", "nodeName": "node-a",
                 "pool": {"name": "trap", "generation": 1,
                          "resourceSliceCount": 1},
                 "devices": [
                     {"name": f"dev-{i}", "attributes": {
                         "ring": {"string": ring},
                         "type": {"string": "tpu-chip"}}}
                     for i, ring in enumerate("abb")]}}))
    _constrained(w, "trap", 2, "tpu.dra.dev/ring")
    assert devices_of(w.sync(), "trap") == ["dev-1", "dev-2"]


def sc_constraint_spans_requests(w):
    _create_claim(w, "pair", [
        {"name": "left", "exactly": {"deviceClassName": "tpu.dra.dev"}},
        {"name": "right", "exactly": {"deviceClassName": "tpu.dra.dev"}}],
        constraints=[{"matchAttribute": "tpu.dra.dev/iciX"}])
    assert len(devices_of(w.sync(), "pair")) == 2


def _power_claims(w, n, count=1):
    for i in range(n):
        w.each(lambda k, i=i: make_claim(k, f"c{i}", device_class="tpu",
                                         count=count))


def sc_power_sheds_load_to_uncapped_node(w):
    _power_claims(w, 4)
    s = w.sync()
    nodes = sorted(node_of(allocation(s, f"c{i}")) for i in range(4))
    assert nodes == ["n0", "n1", "n1", "n1"]


def sc_power_capped_pool_pends_overflow(w):
    _power_claims(w, 3)
    s = w.sync()
    assert sum(bool(allocation(s, f"c{i}")) for i in range(3)) == 2


def sc_power_env_cap_applies_to_attributeless_nodes(w):
    _power_claims(w, 2)
    s = w.sync()
    assert [bool(allocation(s, f"c{i}")) for i in range(2)] == [True, False]


def sc_throttling_chip_skipped_while_clean_peer_exists(w):
    _power_claims(w, 1)
    assert devices_of(w.sync(), "c0") != ["chip-0"]


def sc_throttling_chip_still_used_as_last_resort(w):
    _power_claims(w, 4)
    s = w.sync()
    assert sorted(devices_of(s, f"c{i}")[0] for i in range(4)) == [
        f"chip-{i}" for i in range(4)]


def sc_thermal_drift_taint_biases_too(w):
    _power_claims(w, 3)
    s = w.sync()
    assert "chip-1" not in {devices_of(s, f"c{i}")[0] for i in range(3)}


def sc_topology_order(w):
    """A mix of sizes over the hosts: the scorer picks the same sub-tori
    on both sides (and first-fit alike with the gate off)."""
    for name, count in (("q1", 4), ("p1", 2), ("s1", 1), ("p2", 2),
                        ("t1", 3), ("q2", 4), ("s2", 1), ("p3", 2)):
        w.each(lambda k, n=name, c=count: make_claim(k, n, count=c))
    s = w.sync()
    assert all(allocation(s, n) for n in ("q1", "p1", "s1"))
    w.each(lambda k: k.delete(*RES, "resourceclaims", "p1", "default"))
    w.each(lambda k: make_claim(k, "q3", count=4))
    w.sync()


def sc_cd_window_first(w):
    """A channel claim whose domain names a preferred window lands in it
    although another node sorts first."""
    w.each(lambda k: k.create("resource.tpu.dra", "v1beta1",
                              "computedomains", {
                                  "apiVersion": "resource.tpu.dra/v1beta1",
                                  "kind": "ComputeDomain",
                                  "metadata": {
                                      "name": "cd1", "namespace": "default",
                                      "uid": "cd-uid-1",
                                      "annotations": {
                                          "resource.tpu.dra/preferredNodes":
                                              "node-2,node-3"}}},
                              namespace="default"))
    config = [{"opaque": {"driver": "tpu.dra.dev", "parameters": {
        "kind": "ComputeDomainChannelConfig", "domainID": "cd-uid-1"}}}]
    for i in range(3):
        _create_claim(w, f"ch{i}", [{"name": "tpu", "exactly": {
            "deviceClassName": "tpu.dra.dev"}}], config=config)
    s = w.sync()
    assert {node_of(allocation(s, f"ch{i}")) for i in range(3)} <= {
        "node-2", "node-3"}


def sc_daemonset_and_job(w):
    for name, zone in (("node-a", "x"), ("node-b", "y"), ("node-c", "y")):
        w.each(lambda k, n=name, z=zone: k.create("", "v1", "nodes", {
            "apiVersion": "v1", "kind": "Node",
            "metadata": {"name": n, "labels": {"zone": z}}}))
    w.each(lambda k: make_claim(k, "ds-claim"))
    w.each(lambda k: k.create("apps", "v1", "daemonsets", {
        "apiVersion": "apps/v1", "kind": "DaemonSet",
        "metadata": {"name": "agent", "namespace": "default"},
        "spec": {"template": {
            "metadata": {"labels": {"app": "agent"}},
            "spec": {"nodeSelector": {"zone": "x"},
                     "containers": [{"name": "a"}],
                     "resourceClaims": [{"name": "tpu",
                                         "resourceClaimName": "ds-claim"}]},
        }}}, namespace="default"))
    w.each(lambda k: k.create("batch", "v1", "jobs", {
        "apiVersion": "batch/v1", "kind": "Job",
        "metadata": {"name": "train", "namespace": "default"},
        "spec": {"template": {"metadata": {"labels": {"job": "train"}},
                              "spec": {"containers": [{"name": "t"}]}}}},
        namespace="default"))
    s = w.sync()
    assert {n for (_, n) in s["pods"]} == {"agent-node-a", "train-0"}
    # The claim of the DaemonSet pod is pinned to the bound pod's node.
    assert node_of(allocation(s, "ds-claim")) == "node-a"
    w.each(lambda k: k.patch("", "v1", "pods", "train-0",
                             {"status": {"phase": "Succeeded"}},
                             namespace="default"))
    w.each(lambda k: k.patch("", "v1", "nodes", "node-c", {
        "metadata": {"labels": {"zone": "x"}}}))
    w.each(lambda k: k.patch("", "v1", "nodes", "node-a", {
        "metadata": {"labels": {"zone": "y"}}}))
    s = w.sync()
    assert s["jobs"]["train"]["succeeded"] == 1
    assert {n for (_, n) in s["pods"]} == {"agent-node-c", "train-0"}
    w.each(lambda k: k.delete("apps", "v1", "daemonsets", "agent",
                              "default"))
    assert {n for (_, n) in w.sync()["pods"]} == {"train-0"}


def _power(**kw):
    return lambda tmp: _power_store() + [
        (RES + ("resourceslices",), s) for s in kw["slices"]]


def _v5e4(tmp, taints=None):
    return ([(RES + ("resourceslices",), s)
             for s in _published(tmp, "v5e-4", taints=taints)]
            + [(RES + ("deviceclasses",), c) for c in _chart_classes()])


def _classes_only(tmp):
    return [(RES + ("deviceclasses",), c) for c in _chart_classes()]


def _hosts(topology, nodes):
    def build(tmp):
        return ([(RES + ("resourceslices",), s)
                 for s in _published(tmp, topology, nodes=nodes, gates="")]
                + [(RES + ("deviceclasses",), c) for c in _chart_classes()])
    return build


_CHIP_LOST = {"chip-0": [{"key": "tpu.dra.dev/chip-lost",
                          "effect": "NoSchedule", "value": "true"}]}

# name -> (the function making the store, scenario, gates, env)
SCENARIOS = {
    "allocates_chip_and_pins_node": (_v5e4, sc_allocates_chip_and_pins_node),
    "device_exclusivity_across_claims": (
        _v5e4, sc_device_exclusivity_across_claims),
    "request_cel_selector": (_v5e4, sc_request_cel_selector),
    "counters_block_partition_overlap": (
        _v5e4, sc_counters_block_partition_overlap),
    "partition_blocks_parent_chip": (_v5e4, sc_partition_blocks_parent_chip),
    "all_mode_takes_every_match": (_v5e4, sc_all_mode_takes_every_match),
    "taint_noschedule_skips_device": (
        lambda tmp: _v5e4(tmp, taints=_CHIP_LOST),
        sc_taint_noschedule_skips_device),
    "class_config_propagates": (_v5e4, sc_class_config_propagates),
    "stale_pool_generation_invisible": (
        _v5e4, sc_stale_pool_generation_invisible),
    "template_to_claim_to_binding": (_v5e4, sc_template_to_claim_to_binding),
    "shared_claim_two_pods_one_allocation": (
        _v5e4, sc_shared_claim_two_pods_one_allocation),
    "unsatisfied_pod_stays_unbound": (_v5e4, sc_unsatisfied_pod_stays_unbound),
    "ext_pending_pod_gets_claim_and_binds": (
        _v5e4, sc_ext_pending_pod_gets_claim_and_binds),
    "ext_already_bound_pod_is_skipped": (
        _v5e4, sc_ext_already_bound_pod_is_skipped),
    "ext_pod_past_pending_is_skipped": (
        _v5e4, sc_ext_pod_past_pending_is_skipped),
    "ext_malformed_quantity_surfaces_on_the_pod": (
        _v5e4, sc_ext_malformed_quantity_surfaces_on_the_pod),
    "ext_malformed_pod_does_not_wedge_others": (
        _v5e4, sc_ext_malformed_pod_does_not_wedge_others),
    "aligned_pair_lands_on_one_row": (_v5e4, sc_aligned_pair_lands_on_one_row),
    "unalignable_count_stays_pending": (
        _v5e4, sc_unalignable_count_stays_pending),
    "missing_attribute_stays_pending": (
        _v5e4, sc_missing_attribute_stays_pending),
    "unknown_constraint_type_fails_closed": (
        _v5e4, sc_unknown_constraint_type_fails_closed),
    "backtracking_escapes_greedy_trap": (
        _classes_only, sc_backtracking_escapes_greedy_trap),
    "constraint_spans_requests": (_v5e4, sc_constraint_spans_requests),
    "power_sheds_load_to_uncapped_node": (
        _power(slices=[make_slice(node="n0", cap_w=100, rated_w=100),
                       make_slice(node="n1", rated_w=100)]),
        sc_power_sheds_load_to_uncapped_node),
    "power_capped_pool_pends_overflow": (
        _power(slices=[make_slice(cap_w=200, rated_w=100)]),
        sc_power_capped_pool_pends_overflow),
    "power_env_cap_applies_to_attributeless_nodes": (
        _power(slices=[make_slice()]),
        sc_power_env_cap_applies_to_attributeless_nodes, "",
        {"TPU_DRA_POWER_CAP_W": "150", "TPU_DRA_CHIP_POWER_W": "100"}),
    "throttling_chip_skipped_while_clean_peer_exists": (
        _power(slices=[make_slice(taints={
            "chip-0": anomaly_taint("power_cap_throttle")})]),
        sc_throttling_chip_skipped_while_clean_peer_exists),
    "throttling_chip_still_used_as_last_resort": (
        _power(slices=[make_slice(taints={
            "chip-0": anomaly_taint("duty_cycle_straggler")})]),
        sc_throttling_chip_still_used_as_last_resort),
    "thermal_drift_taint_biases_too": (
        _power(slices=[make_slice(taints={
            "chip-1": anomaly_taint("thermal_drift")})]),
        sc_thermal_drift_taint_biases_too),
    "topology_order_v5e16": (_hosts("v5e-16", 4), sc_topology_order),
    "topology_order_v5p32": (_hosts("v5p-32", 4), sc_topology_order),
    "first_fit_v5e16_gate_off": (_hosts("v5e-16", 4), sc_topology_order,
                                 "TopologyAwarePlacement=false"),
    "first_fit_v5p32_gate_off": (_hosts("v5p-32", 4), sc_topology_order,
                                 "TopologyAwarePlacement=false"),
    "cd_window_first": (_hosts("v5e-16", 4), sc_cd_window_first),
    "daemonset_and_job": (_v5e4, sc_daemonset_and_job),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_same_outcome_as_the_jax_scheduler(name, tmp_path, monkeypatch):
    build, scenario, *rest = SCENARIOS[name]
    gates = rest[0] if rest else ""
    for key, value in (rest[1] if len(rest) > 1 else {}).items():
        monkeypatch.setenv(key, value)
    w = World(build(tmp_path), monkeypatch, gates=gates)
    scenario(w)


def test_topology_order_differs_from_first_fit(tmp_path, monkeypatch):
    """The scorer does move the picks on a coordinated slice (so the
    parity above is not first-fit agreeing with itself)."""
    picks = {}
    for gates in ("", "TopologyAwarePlacement=false"):
        w = World(_hosts("v5e-16", 4)(tmp_path / gates[:4]), monkeypatch,
                  gates=gates)
        sc_topology_order(w)
        s = w.state("pt")
        picks[gates] = {k: v["allocation"] and sorted(
            r["device"] for r in v["allocation"]["devices"]["results"])
            for k, v in s["claims"].items()}
    assert picks[""] != picks["TopologyAwarePlacement=false"]


# -- the allocation state ------------------------------------------------------

def _state_slices(tmp) -> list[dict]:
    shared = {
        "metadata": {"name": "shared-slice", "resourceVersion": "1"},
        "spec": {"driver": "tpu.dra.dev", "nodeName": "n2",
                 "pool": {"name": "n2", "generation": 1},
                 "devices": [{"name": f"pt-{i}", "attributes": {
                     "oversubscribeSlots": {"int": 3},
                     "partition": {"bool": True},
                     "powerRatedWatts": {"int": 40}}}
                     for i in range(2)]}}
    return (_published(tmp, "v5e-4")
            + [make_slice(node="n0", cap_w=350, rated_w=100),
               make_slice(node="n1", power_w=90), shared])


def _view(side, alloc):
    return {
        "allocated": sorted(alloc.allocated),
        "slots": sorted(alloc.slot_counts().items()),
        "load": sorted(alloc.node_load.items()),
        "power": sorted(alloc.power_snapshot().items()),
        "ledger": sorted((k, sorted(v.items()))
                         for k, v in alloc.ledger_snapshot()._avail.items()),
        "order": list(alloc.ordered_nodes()),
    }


@pytest.mark.parametrize("seed", range(6))
def test_allocation_states_replay_alike(seed, tmp_path, monkeypatch):
    monkeypatch.setenv("TPU_DRA_CHIP_POWER_W", "30" if seed % 2 else "0")
    slices = _state_slices(tmp_path)
    states = {"jax": jax_cache.AllocationState(
                  jax_cache.InventorySnapshot(slices)),
              "pt": pt_cache.AllocationState(
                  pt_cache.InventorySnapshot(slices))}
    keys = sorted(states["pt"].snapshot.by_key)
    assert keys == sorted(states["jax"].snapshot.by_key)
    rng = np.random.default_rng(seed)
    held: dict[str, dict] = {}
    for step in range(120):
        op = rng.choice(["try_commit", "try_commit", "observe", "forget",
                         "rebuild"])
        name = f"c{int(rng.integers(0, 12))}"
        picked = [tuple(keys[i]) for i in rng.choice(
            len(keys), size=int(rng.integers(1, 4)), replace=False)]
        claim = pt_cache.claim_like(name, picked, uid=f"u-{name}")
        assert claim == jax_cache.claim_like(name, picked, uid=f"u-{name}")
        if op == "forget" and held:
            claim = held.pop(sorted(held)[int(rng.integers(len(held)))])
        elif op == "rebuild":
            kept = [c for c in held.values() if rng.random() < 0.7]
            held = {c["metadata"]["name"]: c for c in kept}
        got = {}
        for side, st in states.items():
            if op == "rebuild":
                got[side] = st.rebuild(json.loads(json.dumps(kept)))
            else:
                got[side] = getattr(st, op)(json.loads(json.dumps(claim)))
        assert got["pt"] == got["jax"], (step, op)
        if op in ("try_commit", "observe") and got["pt"] is not False:
            held[name] = claim
        assert _view("pt", states["pt"]) == _view("jax", states["jax"]), \
            (step, op)


@pytest.mark.parametrize("seed", range(4))
def test_counter_ledgers_replay_alike(seed, tmp_path):
    slices = _published(tmp_path, "v5e-4")
    snaps = {"jax": jax_cache.InventorySnapshot(slices),
             "pt": pt_cache.InventorySnapshot(slices)}
    ledgers = {side: snap.make_ledger() for side, snap in snaps.items()}
    cands = snaps["pt"].candidates
    rng = np.random.default_rng(seed)
    for _ in range(200):
        cand = cands[int(rng.integers(len(cands)))]
        consumes = cand.device.get("consumesCounters")
        op = rng.choice(["fits", "debit", "credit"])
        got = {side: getattr(ledger, op)(cand.driver, cand.pool, consumes)
               for side, ledger in ledgers.items()}
        assert got["pt"] == got["jax"]
        assert ledgers["pt"]._avail == ledgers["jax"]._avail
    assert snaps["pt"].signature == snaps["jax"].signature
    assert {pk: p.generation for pk, p in snaps["pt"].pools.items()} == \
        snaps["jax"].pool_generations


def test_power_budget_and_env_cap_alike(monkeypatch):
    """The power cases of the JAX suite's allocation state, both sides."""
    def claim(uid, devices, node="n0"):
        return {"metadata": {"uid": uid, "namespace": "default",
                             "name": uid},
                "status": {"allocation": {"devices": {"results": [
                    {"request": "tpu", "driver": "tpu.dra.dev",
                     "pool": node, "device": d} for d in devices]}}}}
    for cache in (jax_cache, pt_cache):
        alloc = cache.AllocationState(cache.InventorySnapshot(
            [make_slice(cap_w=250, rated_w=100)]))
        assert alloc.try_commit(claim("u1", ["chip-0"]))
        assert alloc.try_commit(claim("u2", ["chip-1"]))
        assert not alloc.try_commit(claim("u3", ["chip-2"]))
        assert not alloc.try_commit(claim("u4", ["chip-2", "chip-3"]))
        assert alloc.power_snapshot() == {"n0": 200}
        alloc.forget(claim("u1", ["chip-0"]))
        assert alloc.power_snapshot() == {"n0": 100}
    monkeypatch.setenv("TPU_DRA_POWER_CAP_W", "150")
    monkeypatch.setenv("TPU_DRA_CHIP_POWER_W", "100")
    for cache in (jax_cache, pt_cache):
        alloc = cache.AllocationState(cache.InventorySnapshot(
            [make_slice()]))
        assert alloc.try_commit(claim("u1", ["chip-0"]))
        assert not alloc.try_commit(claim("u2", ["chip-1"]))
        assert cache.power_cap_env() == 150
        assert cache.chip_power_default_env() == 100


@pytest.mark.parametrize("taint, tolerations", [
    ({"key": "k", "effect": "NoSchedule"}, []),
    ({"key": "k", "effect": "NoSchedule"}, [{"operator": "Exists"}]),
    ({"key": "k", "effect": "NoSchedule"},
     [{"key": "k", "operator": "Exists", "effect": "NoExecute"}]),
    ({"key": "k", "value": "v", "effect": "NoExecute"},
     [{"key": "k", "value": "v"}]),
    ({"key": "k", "value": "v", "effect": "NoExecute"},
     [{"key": "k", "value": "w"}]),
    ({"key": "k", "effect": "NoSchedule"}, [{"key": "j",
                                             "operator": "Exists"}]),
])
def test_tolerations_alike(taint, tolerations):
    assert pt_cache.tolerates(taint, tolerations) == \
        jax_cache.tolerates(taint, tolerations)


# -- tracing -------------------------------------------------------------------

@pytest.fixture()
def fresh():
    exp, rec = pt_tracing.exporter(), pt_fr.default()
    pt_tracing.set_exporter(pt_tracing.TraceExporter())
    pt_fr.set_default(pt_fr.FlightRecorder())
    yield pt_tracing.exporter(), pt_fr.default()
    pt_tracing.set_exporter(exp)
    pt_fr.set_default(rec)


def _gpu_cluster(tmp_path, topology="h100-4"):
    kube = pt_kube.FakeKubeClient()
    pt_classes.create_all(kube)
    driver = PtDriver(pt_ds.Config.mock(str(tmp_path / "state"), topology),
                      kube, "node-a", False)
    driver.publish_resources()
    return kube, driver


def _gpu_claim(name, uid, cel=None):
    exactly = {"deviceClassName": pt_classes.GPU_CLASS}
    if cel:
        exactly["selectors"] = [{"cel": {"expression": cel}}]
    obj = _claim_obj(name, [{"name": "gpu", "exactly": exactly}])
    obj["metadata"]["uid"] = uid
    return obj


def test_one_trace_from_commit_to_prepare_segments(fresh, tmp_path):
    exporter, recorder = fresh
    kube, driver = _gpu_cluster(tmp_path)
    kube.create(*RES, "resourceclaims", _gpu_claim("c-e2e", "uid-e2e"),
                namespace="default")
    sm = pt_metrics.SchedulerMetrics()
    pt_sched.DraScheduler(kube, sched_metrics=sm).sync_once()
    claim = kube.get(*RES, "resourceclaims", "c-e2e", "default")
    header = claim["metadata"]["annotations"][TRACEPARENT]
    ctx = pt_tracing.SpanContext.from_traceparent(header)
    assert ctx is not None and ctx.sampled
    assert driver.state.prepare(ResourceClaim.from_dict(claim))
    by_name = {}
    for doc in exporter.traces()[ctx.trace_id]:
        by_name.setdefault(doc["name"], doc)
    assert by_name["sched.commit"]["span_id"] == ctx.span_id
    assert by_name["sched.commit"]["parent_id"] == \
        by_name["sched.claim"]["span_id"]
    assert by_name["prepare"]["parent_id"] == ctx.span_id
    assert by_name["prep_devices"]["parent_id"] == \
        by_name["prepare"]["span_id"]
    assert "patch_ms" in by_name["sched.commit"]["attrs"]
    text = exposition.generate_latest(sm.registry).decode()
    phases = {line.split('"')[1] for line in text.splitlines()
              if line.startswith("tpu_dra_claim_e2e_seconds_count")
              and float(line.split()[-1]) > 0}
    assert phases == {"fit", "commit", "patch"}
    events = {e["event"] for e in recorder.events("uid-e2e")}
    assert {"fit", "alloc_patched"} <= events
    driver.stop()


def test_unsampled_reallocation_clears_the_old_traceparent(
        fresh, tmp_path, monkeypatch):
    kube, driver = _gpu_cluster(tmp_path)
    obj = _gpu_claim("c", "uid-c")
    obj["metadata"]["annotations"] = {TRACEPARENT: "00-" + "1" * 32 + "-"
                                      + "2" * 16 + "-01"}
    kube.create(*RES, "resourceclaims", obj, namespace="default")
    monkeypatch.setenv(pt_tracing.ENV_SAMPLE, "0")
    pt_sched.DraScheduler(kube).sync_once()
    claim = kube.get(*RES, "resourceclaims", "c", "default")
    assert claim["status"]["allocation"]
    assert TRACEPARENT not in claim["metadata"].get("annotations", {})
    driver.stop()


def test_placement_metrics_on_a_coordinated_pool(tmp_path, monkeypatch):
    """Compactness, fragmentation and the largest free shape of the JAX
    scheduler's ``PlacementMetrics``, equal on the port's registry."""
    from prometheus_client import generate_latest
    from prometheus_client.parser import text_string_to_metric_families

    from k8s_dra_driver_gpu_tpu.pkg import metrics as jax_metrics

    w = World(_hosts("v5e-16", 1)(tmp_path), monkeypatch)
    jm, pm = jax_metrics.PlacementMetrics(), pt_metrics.PlacementMetrics()
    w.scheds["jax"].metrics, w.scheds["pt"].metrics = jm, pm
    for name, count in (("q", 4), ("p", 2), ("s", 1)):
        w.each(lambda k, n=name, c=count: make_claim(k, n, count=c))
    w.sync()

    def samples(text):
        return sorted((s.name, tuple(sorted(s.labels.items())), s.value)
                      for f in text_string_to_metric_families(text)
                      for s in f.samples if not s.name.endswith("_created"))
    got = samples(exposition.generate_latest(pm.registry).decode())
    assert got == samples(generate_latest(jm.registry).decode())
    assert any(n == "tpu_dra_placement_frag_score" for n, _, _ in got)


# -- what the JAX scheduler reads ------------------------------------------------

def _domain_view(dom):
    if dom is None:
        return None
    return (dom.name, list(dom.pools), dom.default,
            [(sib.name, list(sib.pools)) for sib in dom.siblings])


def _sched_view(sched) -> dict:
    """What a scheduler took from its arguments and its env."""
    return {
        "workers": sched.sched_workers, "batch": sched.batch_max,
        "resync": sched.resync_period, "domain": _domain_view(sched.domain),
        "cluster": sched._cluster_controllers,
        "filtered": sched.view._pool_filter is not None,
        "spill": (sched._spillover_enabled, sched._spillover_max_hops,
                  sched._spill_order_weight, sched._spill_util_weight),
    }


@pytest.mark.parametrize("case", [
    "workers", "batch", "domain", "start_event_driven", "view_start",
    "env_workers", "env_batch", "env_domain", "env_domain_pools",
    "env_domain_siblings", "env_domain_default", "env_resync",
    "env_spillover"])
def test_scheduler_reads_what_the_jax_scheduler_reads(case, monkeypatch):
    """Each constructor argument and env knob of the JAX ``DraScheduler``
    that the port refused before its event mode, read to the same value
    on both sides (exact); event mode and the view's informers start and
    stop on both."""
    env = {
        "env_workers": {"TPU_DRA_SCHED_WORKERS": "4"},
        "env_batch": {"TPU_DRA_SCHED_BATCH": "3"},
        "env_domain": {"TPU_DRA_SCHED_DOMAIN": "a"},
        "env_domain_pools": {"TPU_DRA_SCHED_DOMAIN": "a",
                             "TPU_DRA_SCHED_DOMAIN_POOLS": "p*, q"},
        "env_domain_siblings": {"TPU_DRA_SCHED_DOMAIN": "a",
                                "TPU_DRA_SCHED_DOMAIN_POOLS": "p*",
                                "TPU_DRA_SCHED_DOMAIN_SIBLINGS":
                                    "b=q*|r;bad;c=s"},
        "env_domain_default": {"TPU_DRA_SCHED_DOMAIN": "a",
                               "TPU_DRA_SCHED_DOMAIN_DEFAULT": "1"},
        "env_resync": {"TPU_DRA_SCHED_RESYNC": "2.5"},
        "env_spillover": {"TPU_DRA_SPILLOVER": "0",
                          "TPU_DRA_SPILLOVER_MAX_HOPS": "3",
                          "TPU_DRA_SPILLOVER_ORDER_WEIGHT": "2",
                          "TPU_DRA_SPILLOVER_UTIL_WEIGHT": "x"},
    }.get(case, {})
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = {}
    for side, sched_mod, cache_mod, kube_mod in (
            ("jax", jax_sched, jax_cache, jax_kube),
            ("pt", pt_sched, pt_cache, pt_kube)):
        kube = kube_mod.FakeKubeClient()
        kw = {"workers": {"workers": 2}, "batch": {"batch_max": 8},
              "domain": {"domain": cache_mod.SchedulingDomain(
                  "a", pools=["p*"], siblings=[
                      cache_mod.SchedulingDomain("b", pools=["q"])])},
              }.get(case, {})
        if case == "view_start":
            view = cache_mod.ClusterView(kube).start()
            got[side] = (view.event_driven, view.wait_for_sync(5),
                         sorted(view._informers))
            view.stop()
            continue
        sched = sched_mod.DraScheduler(kube, **kw)
        got[side] = _sched_view(sched)
        if case == "start_event_driven":
            assert sched.start_event_driven() is sched
            got[side]["drained"] = sched.drain(10)
            got[side]["event_driven"] = sched.view.event_driven
            sched.stop()
    assert got["pt"] == got["jax"]


class _Ran(Exception):
    """The stand-in scheduler of ``_binary_reads`` was started."""


def _binary_reads(mod, argv, monkeypatch) -> dict:
    """What the binary ``mod.main(argv)`` builds its scheduler with and
    how it runs it, the scheduler replaced by a recorder."""
    seen = {}

    class Recorder:
        def __init__(self, kube, **kw):
            seen.update(default_node=kw.get("default_node"),
                        workers=kw.get("workers"),
                        batch=kw.get("batch_max"),
                        domain=_domain_view(kw.get("domain")))
            self.kube = kube

        def start_event_driven(self):
            seen["mode"] = "events"
            raise _Ran

        def run(self, interval=0.25):
            seen["mode"], seen["interval"] = "poll", interval
            raise _Ran

        start = run

        def stop(self):
            pass

    monkeypatch.setattr(mod, "DraScheduler", Recorder)
    with pytest.raises(_Ran):
        mod.main(["--kube-api", "http://127.0.0.1:1"] + argv)
    return seen


@pytest.mark.parametrize("argv, env", [
    ([], {}),
    (["--sched-mode", "poll", "--interval", "0.5"], {}),
    ([], {"TPU_DRA_SCHED_MODE": "poll"}),
    (["--sched-workers", "4"], {}),
    ([], {"TPU_DRA_SCHED_WORKERS": "3"}),
    (["--sched-batch", "2"], {}),
    ([], {"TPU_DRA_SCHED_BATCH": "5"}),
    (["--sched-domain", "a", "--sched-domain-pools", "p*, q"], {}),
    ([], {"TPU_DRA_SCHED_DOMAIN": "a",
          "TPU_DRA_SCHED_DOMAIN_POOLS": "p*"}),
    (["--sched-domain", "a", "--sched-domain-default"], {}),
    (["--sched-domain", "a"], {"TPU_DRA_SCHED_DOMAIN_DEFAULT": "true"}),
    (["--sched-domain", "a", "--sched-domain-siblings", "b=q*|r;c=s"],
     {}),
    (["--sched-domain", "a"], {"TPU_DRA_SCHED_DOMAIN_SIBLINGS": "b=q"}),
    (["--default-node", "n1", "--sched-workers", "2", "--sched-batch",
      "1"], {}),
])
def test_binary_reads_flags_as_the_jax_binary(argv, env, monkeypatch):
    """The JAX scheduler binary's flags and their env, read by the port's
    ``main`` to the same scheduler arguments and the same mode (exact);
    the default mode is ``events`` on both."""
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got = {side: _binary_reads(mod, argv, monkeypatch)
           for side, mod in (("jax", jax_sched), ("pt", pt_sched))}
    assert got["pt"] == got["jax"]
    if not argv and not env:
        assert got["pt"]["mode"] == "events"


def test_event_mode_binary_exits_1_without_a_cluster(monkeypatch):
    """No fallback to polling: the binary in event mode whose informers
    cannot list (no API server) ends with 1 and leaves no thread."""
    monkeypatch.setattr(pt_sched, "SYNC_TIMEOUT_S", 0.5)
    handlers = {sig: signal.getsignal(sig)
                for sig in (signal.SIGTERM, signal.SIGINT)}
    try:
        assert pt_sched.main(["--kube-api", "http://127.0.0.1:1"]) == 1
    finally:
        for sig, handler in handlers.items():
            signal.signal(sig, handler)
    assert not [t for t in threading.enumerate()
                if t.name.startswith(("informer-", "sched-", "watch"))]


@pytest.mark.parametrize("flag", ["defrag_root", "migration_root",
                                  "autoscale_root"])
@pytest.mark.parametrize("source", ["flag", "env"])
def test_controller_roots_are_read(flag, source, monkeypatch):
    """The defrag, migration and autoscale roots, from the binary's flag
    or its env (``TPU_DRA_DEFRAG_ROOT``, ``TPU_DRA_MIGRATION_ROOT``,
    ``TPU_DRA_AUTOSCALE_ROOT``), as the JAX binary reads them; none is
    refused any more."""
    env = "TPU_DRA_" + flag.upper()
    argv = ["--kube-api", "x"]
    if source == "env":
        monkeypatch.setenv(env, "/r")
        pt_sched.DraScheduler(pt_kube.FakeKubeClient())  # no refusal
    else:
        argv += ["--" + flag.replace("_", "-"), "/r"]
    assert getattr(pt_sched.build_parser().parse_args(argv), flag) == "/r"


def _recovery_world(tmp_path, monkeypatch):
    """A claim allocated on one of two Ready nodes, in both stores."""
    from tests.test_recovery import (add_node, apply_class,
                                     make_pending_claim, node_slices)
    from k8s_dra_driver_gpu_tpu.pkg import sliceutil as jax_su
    from k8s_dra_driver_gpu_tpu_torch.pkg import sliceutil as pt_su

    w = World([], monkeypatch)
    for side, su in (("jax", jax_su), ("pt", pt_su)):
        kube = w.kubes[side]
        apply_class(kube)
        for node in ("node-a", "node-b"):
            add_node(kube, node)
            su.publish_resource_slices(kube, node_slices(node))
        make_pending_claim(kube, "c0")
    return w


@pytest.mark.parametrize("case", ["fleet", "attach_recovery", "env",
                                  "flag"])
def test_what_now_runs(case, tmp_path, monkeypatch):
    """What the scheduler refused before the recovery and fleet slice,
    against the JAX scheduler: a fleet sink, an attached eviction
    controller, the recovery root from the env and from the flag."""
    from k8s_dra_driver_gpu_tpu.pkg import metrics as jax_metrics
    from k8s_dra_driver_gpu_tpu.pkg import recovery as jax_recovery
    from k8s_dra_driver_gpu_tpu_torch.pkg import recovery as pt_recovery

    if case == "env":
        monkeypatch.setenv("TPU_DRA_RECOVERY_ROOT", str(tmp_path / "r"))
        pt_sched.DraScheduler(pt_kube.FakeKubeClient())  # no refusal
        args = pt_sched.build_parser().parse_args(["--kube-api", "x"])
        assert args.recovery_root == str(tmp_path / "r")
        return
    if case == "flag":
        args = pt_sched.build_parser().parse_args(
            ["--kube-api", "x", "--recovery-root", "/r"])
        assert args.recovery_root == "/r"
        return
    w = _recovery_world(tmp_path, monkeypatch)
    if case == "fleet":
        sinks = {"jax": jax_metrics.FleetMetrics(),
                 "pt": pt_metrics.FleetMetrics()}
        for side, mod in (("jax", jax_sched), ("pt", pt_sched)):
            w.scheds[side] = mod.DraScheduler(w.kubes[side],
                                              fleet_metrics=sinks[side])
        w.sync()
        texts = {s: sorted(
            (x.name, tuple(sorted(x.labels.items())), x.value)
            for f in text_string_to_metric_families(
                (generate_latest if s == "jax" else
                 exposition.generate_latest)(sinks[s].registry).decode())
            for x in f.samples if not x.name.startswith(
                "tpu_dra_fleet_fold_seconds")
            and not x.name.endswith("_created")) for s in SIDES}
        assert texts["pt"] == texts["jax"]
        assert ("tpu_dra_fleet_pending_claims", (), 0.0) in texts["pt"]
        return
    for side, mod in (("jax", jax_recovery), ("pt", pt_recovery)):
        ctrl = mod.EvictionController(w.kubes[side], str(tmp_path / side),
                                      notready_grace_s=0.0)
        assert w.scheds[side].attach_recovery(ctrl) is w.scheds[side]
    state = w.sync()
    node = node_of(allocation(state, "c0"))
    w.each(lambda k: k.patch("", "v1", "nodes", node, {"status": {
        "conditions": [{"type": "Ready", "status": "False"}]}}))
    state = w.sync(passes=6)
    assert node_of(allocation(state, "c0")) != node
    assert state["claims"][("default", "c0")]["conditions"][0][
        "reason"] == "Recovered"


def test_attach_autoscaler_is_accepted(tmp_path, monkeypatch):
    """What the scheduler refused before the autoscaler slice, against
    the JAX scheduler: an attached autoscale controller takes this
    scheduler's view and fleet, the fleet shows its store, and its pass
    (after the fleet fold) plans a declared tenant's partition set in the
    scheduler's own pass."""
    from k8s_dra_driver_gpu_tpu.pkg.autoscale import \
        controller as jax_as
    from k8s_dra_driver_gpu_tpu_torch.pkg.autoscale import \
        controller as pt_as
    from tests.test_autoscale import publish_chip_fleet, tenant_claim
    from tests.test_torch_autoscale import publish_gpu_fleet

    got = {}
    for side, sched_mod, as_mod, publish, kube_mod in (
            ("jax", jax_sched, jax_as, publish_chip_fleet, jax_kube),
            ("pt", pt_sched, pt_as, publish_gpu_fleet, pt_kube)):
        kube = kube_mod.FakeKubeClient()
        publish(kube)
        tenant_claim(kube, "c1", "web", 3 << 30, allocated=False)
        sched = sched_mod.DraScheduler(kube)
        ctrl = as_mod.AutoscaleController(
            kube, str(tmp_path / side), sustain_s=0.0, cooldown_s=0.0,
            subslice="1x1" if side == "jax" else "7g.80gb")
        assert sched.attach_autoscaler(ctrl) is sched
        assert ctrl.view is sched.view and ctrl.fleet is sched.fleet
        sched.sync_once()
        crds = kube.list("resource.tpu.dra", "v1beta1", "partitionsets")
        got[side] = (ctrl.last_sync,
                     [p["name"] for c in crds for p in c["spec"]["profiles"]],
                     sorted(sched.fleet.snapshot()["tenant_demand"]))
    assert got["pt"] == got["jax"]
    assert got["pt"][1] == ["web-s4"] and got["pt"][2] == ["web"]


def test_domain_annotations_are_not_read(tmp_path):
    """A claim carrying the annotations only scheduling domains write
    allocates as any claim (the JAX scheduler reads them)."""
    kube, driver = _gpu_cluster(tmp_path)
    obj = _gpu_claim("c", "uid-c")
    obj["metadata"]["annotations"] = {
        "resource.tpu.dra/domain": "elsewhere",
        "resource.tpu.dra/spillover": "false"}
    kube.create(*RES, "resourceclaims", obj, namespace="default")
    pt_sched.DraScheduler(kube).sync_once()
    claim = kube.get(*RES, "resourceclaims", "c", "default")
    assert [r["device"] for r in claim["status"]["allocation"]["devices"][
        "results"]] == ["gpu-0"]
    driver.stop()


class _Reserving:
    """A stand-in for the defrag or migration controller on either
    scheduler: its passes do nothing, its reservations are given."""

    def __init__(self, reserved):
        self.reserved, self.view, self.fleet = reserved, None, None
        self.passes = 0

    def sync_once(self):
        self.passes += 1
        return {}

    def reservations(self):
        return self.reserved


@pytest.mark.parametrize("attach", ["attach_defrag", "attach_migration"])
def test_defrag_hint_steers_and_reservations_veto(attach, tmp_path,
                                                  monkeypatch):
    """Two nodes of 4 chips, the same on both sides: a claim whose
    ``resource.tpu.dra/defrag-target`` names ``node-b|chip-2`` lands there
    (least-loaded would say ``node-a``); with a controller's reservations
    holding ``node-a`` and ``node-b``'s ``chip-0`` for one claim and
    ``chip-1`` as a carve cell, that claim allocates on its reserved
    devices, a claim with a stale hint falls back to the free ``chip-3``,
    and a fourth claim pends though ``node-a`` has free chips."""
    from k8s_dra_driver_gpu_tpu.pkg import sliceutil as jax_su
    from k8s_dra_driver_gpu_tpu_torch.pkg import sliceutil as pt_su
    from tests.test_migration import DRIVER, add_node, apply_class
    from tests.test_migration import node_slices as chips_of

    w = World([], monkeypatch)

    def claim(name, count=1, hint=None):
        obj = _claim_obj(name, [{"name": "tpu", "exactly": {
            "deviceClassName": DRIVER, "count": count}}])
        if hint:
            obj["metadata"]["annotations"] = {
                "resource.tpu.dra/defrag-target": hint}
        return obj
    for side, su in (("jax", jax_su), ("pt", pt_su)):
        kube = w.kubes[side]
        apply_class(kube)
        for node in ("node-a", "node-b"):
            add_node(kube, node)
            su.publish_resource_slices(kube, chips_of(node))
        for obj in (claim("moving", hint="node-b|chip-2"),
                    claim("stale", hint="node-z|chip-9"),
                    claim("owner", count=2), claim("other")):
            kube.create(*RES, "resourceclaims", obj, namespace="default")
    owner = w.kubes["pt"].get(*RES, "resourceclaims", "owner",
                              "default")["metadata"]["uid"]
    reserved = {(DRIVER, "node-a", f"chip-{i}"): owner for i in range(4)}
    reserved[(DRIVER, "node-b", "chip-0")] = owner
    reserved[(DRIVER, "node-b", "chip-1")] = None
    stubs = {side: _Reserving(reserved) for side in SIDES}
    for side in SIDES:
        assert getattr(w.scheds[side], attach)(stubs[side]) is \
            w.scheds[side]
        assert stubs[side].view is w.scheds[side].view
    state = w.sync()
    assert (node_of(allocation(state, "moving")),
            devices_of(state, "moving")) == ("node-b", ["chip-2"])
    assert (node_of(allocation(state, "stale")),
            devices_of(state, "stale")) == ("node-b", ["chip-3"])
    assert node_of(allocation(state, "owner")) == "node-a"
    assert allocation(state, "other") is None
    assert stubs["pt"].passes == stubs["jax"].passes > 0
    if attach == "attach_defrag":
        assert stubs["pt"].fleet is w.scheds["pt"].fleet


# -- the GPU classes over the port's own slices -------------------------------

def test_gpu_claims_on_a_port_node(tmp_path):
    """The port's classes over the port's published h100-4: CEL on
    productName and a quantity on capacity.memory, exclusivity, the MIG
    class finding no MIG device with MIG off, and a freed GPU reused."""
    kube, driver = _gpu_cluster(tmp_path)
    cel = ('device.attributes["gpu.nvidia.com"].productName == '
           '"NVIDIA H100 80GB HBM3" && device.capacity["gpu.nvidia.com"]'
           '.memory.compareTo(quantity("40Gi")) >= 0')
    for i in range(5):
        kube.create(*RES, "resourceclaims", _gpu_claim(f"g{i}", f"u{i}",
                                                       cel),
                    namespace="default")
    mig = _claim_obj("m", [{"name": "mig", "exactly": {
        "deviceClassName": pt_classes.MIG_CLASS}}])
    kube.create(*RES, "resourceclaims", mig, namespace="default")
    sched = pt_sched.DraScheduler(kube)
    sched.sync_once()

    def devices():
        return {c["metadata"]["name"]: [r["device"] for r in c["status"][
            "allocation"]["devices"]["results"]]
            for c in kube.list(*RES, "resourceclaims")
            if c.get("status", {}).get("allocation")}
    got = devices()
    assert got == {f"g{i}": [f"gpu-{i}"] for i in range(4)}
    kube.delete(*RES, "resourceclaims", "g1", "default")
    sched.sync_once()
    assert devices()["g4"] == ["gpu-1"] and "m" not in devices()
    driver.stop()


# -- the binary ----------------------------------------------------------------

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


def test_binary_allocates_binds_serves_metrics_and_stops(tmp_path):
    server = FakeApiServer().start()
    kube = server.store
    proc = None
    try:
        pt_classes.create_all(kube)
        driver = PtDriver(pt_ds.Config.mock(str(tmp_path / "s"), "h100-4"),
                          kube, "node-a", False)
        driver.publish_resources()
        kube.create(*RES, "resourceclaimtemplates", {
            "apiVersion": "resource.k8s.io/v1",
            "kind": "ResourceClaimTemplate",
            "metadata": {"name": "tpl", "namespace": "default"},
            "spec": {"spec": {"devices": {"requests": [{
                "name": "gpu", "exactly": {
                    "deviceClassName": pt_classes.GPU_CLASS}}]}}}},
            namespace="default")
        kube.create("", "v1", "pods", _pod(
            "w", {"resourceClaimTemplateName": "tpl"}), namespace="default")
        port = _free_port()
        env = dict(os.environ, PYTHONPATH=ROOT, V="2")
        proc = subprocess.Popen(
            [sys.executable, "-m", "k8s_dra_driver_gpu_tpu_torch.pkg."
             "scheduler", "--kube-api", server.url, "--interval", "0.1",
             "--metrics-port", str(port), "--defrag-root",
             str(tmp_path / "defrag"), "--migration-root",
             str(tmp_path / "migration")],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
        pod = _wait(lambda: (lambda p: p if p["spec"].get("nodeName")
                             else None)(kube.get("", "v1", "pods", "w",
                                                 "default")))
        (status,) = pod["status"]["resourceClaimStatuses"]
        claim = kube.get(*RES, "resourceclaims",
                         status["resourceClaimName"], "default")
        assert pod["spec"]["nodeName"] == "node-a"
        assert claim["status"]["reservedFor"][0]["name"] == "w"
        assert claim["status"]["allocation"]["devices"]["results"][0][
            "device"] == "gpu-0"
        text = _wait(lambda: (lambda t: t if 'phase="patch"' in t
                              else None)(urllib.request.urlopen(
                                  f"http://127.0.0.1:{port}/metrics",
                                  timeout=5).read().decode()))
        assert 'tpu_dra_sched_sync_seconds_count{mode="full"}' in text
        assert "tpu_dra_build_info" in text
        # Both controllers attached, their families on the registry.
        assert "tpu_dra_defrag_active_moves 0.0" in text
        assert "tpu_dra_migration_active_moves 0.0" in text
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=30)
        assert proc.returncode == 0, err[-2000:]
        assert "scheduler running" in out
        driver.stop()
    finally:
        if proc is not None and proc.poll() is None:
            proc.kill()
            proc.wait()
        server.stop()
    assert not [t for t in threading.enumerate()
                if t.name in ("fake-apiserver", "dra-scheduler")]


def test_leader_elected_loop_runs_and_releases(tmp_path):
    kube, driver = _gpu_cluster(tmp_path)
    kube.create(*RES, "resourceclaims", _gpu_claim("c", "uid-c"),
                namespace="default")
    sched = pt_sched.DraScheduler(kube)
    stop = threading.Event()
    t = threading.Thread(target=pt_sched.run_leader_elected, args=(sched,),
                         kwargs={"namespace": "ns", "identity": "a",
                                 "stop": stop, "interval": 0.05})
    t.start()
    try:
        _wait(lambda: kube.get(*RES, "resourceclaims", "c", "default").get(
            "status", {}).get("allocation"), timeout=20)
        lease = kube.get("coordination.k8s.io", "v1", "leases",
                         "tpu-dra-scheduler", "ns")
        assert lease["spec"]["holderIdentity"] == "a"
    finally:
        stop.set()
        t.join(timeout=20)
    assert not t.is_alive() and sched._thread is None
    lease = kube.get("coordination.k8s.io", "v1", "leases",
                     "tpu-dra-scheduler", "ns")
    assert not lease["spec"].get("holderIdentity")
    driver.stop()
