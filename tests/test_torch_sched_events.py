"""The port's scheduler event mode (``pkg/scheduler.py``,
``pkg/schedcache.py``, ``pkg/informer.py``) against the JAX package's,
on the CPU, over each package's ``FakeKubeClient``.

- **Event flow at one worker** (``tests/test_sched_incremental.py``): a
  claim event allocates and binds its pod, a template pod gets its claim,
  a deleted claim frees a pending one, a new slice retries pending
  claims. Each scenario runs once per side from the same writes, with
  ``uuid.uuid4`` seeded alike; after every ``drain()`` the claims (spec,
  annotations, allocation, ``reservedFor``, conditions), the pods
  (``nodeName``, claim statuses, conditions) and the Events are equal
  (exact; the traceparent's value aside).
- **No-op steady state**: ten forced full resyncs of a converged cluster
  make no kube write and no kube read on either side.
- **Incremental equals full**: the JAX churn trace gives the same final
  allocations polled and in event mode, on both sides (exact).
- **Snapshot lifecycle**, **delta snapshots** and **retarget**
  (``tests/test_sched_delta.py``): a slice event rebuilds only its pool
  and merges the others by identity; over a seeded churn trace the
  port's delta snapshot equals the port's full rebuild and the JAX delta
  snapshot at every step (a fingerprint of candidates, node index,
  generations, counter seeds and signature: exact); ``retarget`` equals
  a rebuild; the scheduler retargets its allocation state instead of
  rebuilding it; a ComputeDomain event updates only its own window; a
  commit conflict re-queues its claim and re-fits against the live state.
- **Metrics wiring**: after one claim in event mode both registries hold
  the same families and label sets, and equal sample counts.
- **RelistCoordinator** (``tests/test_informer.py``): backoff, the quiet
  window, priority order under the concurrency cap and the backoff hook,
  driven through ``time_fn``, ``sleep_fn`` and ``rng`` (no sleep decides
  an outcome); the informer routes its relists through it and the view
  starts its informers in priority order. The event gate parks events
  until ``flush_deferred``.
"""

import copy
import json
import random
import threading
import time
import uuid
from types import SimpleNamespace

import pytest
from prometheus_client import generate_latest
from prometheus_client.parser import text_string_to_metric_families

from k8s_dra_driver_gpu_tpu.computedomain import API_GROUP, API_VERSION
from k8s_dra_driver_gpu_tpu.pkg import informer as jax_inf
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg import metrics as jax_metrics
from k8s_dra_driver_gpu_tpu.pkg import schedcache as jax_cache
from k8s_dra_driver_gpu_tpu.pkg import scheduler as jax_sched
from k8s_dra_driver_gpu_tpu.pkg import sliceutil as jax_su
from k8s_dra_driver_gpu_tpu_torch.pkg import exposition
from k8s_dra_driver_gpu_tpu_torch.pkg import informer as pt_inf
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import metrics as pt_metrics
from k8s_dra_driver_gpu_tpu_torch.pkg import schedcache as pt_cache
from k8s_dra_driver_gpu_tpu_torch.pkg import scheduler as pt_sched
from k8s_dra_driver_gpu_tpu_torch.pkg import sliceutil as pt_su
from k8s_dra_driver_gpu_tpu_torch.pkg import tracing as pt_tracing
from tests.fake_kube import CountingKube
from tests.test_sched_delta import make_slice, snapshot_fingerprint
from tests import test_sched_incremental as jax_incremental
from tests.test_sched_incremental import (apply_class, make_claim, make_pod,
                                          node_slices)

RES = ("resource.k8s.io", "v1")
DRIVER = "tpu.dra.dev"
SIDES = {
    "jax": SimpleNamespace(kube=jax_kube, cache=jax_cache, sched=jax_sched,
                           metrics=jax_metrics, su=jax_su, inf=jax_inf,
                           text=lambda reg: generate_latest(reg).decode()),
    "pt": SimpleNamespace(kube=pt_kube, cache=pt_cache, sched=pt_sched,
                          metrics=pt_metrics, su=pt_su, inf=pt_inf,
                          text=lambda reg: exposition.generate_latest(
                              reg).decode()),
}
TRACEPARENT = pt_tracing.TRACEPARENT_ANNOTATION
DRAIN_S = 15.0


class Counting(CountingKube):
    """``CountingKube`` that also counts the port informer's list."""

    def list_with_version(self, *a, **kw):
        self.reads += 1
        return self._inner.list_with_version(*a, **kw)


@pytest.fixture(autouse=True)
def _no_thread_left():
    """Every test stops what it starts: no informer, queue worker,
    resync or loop thread outlives it."""
    yield
    names = ("sched-", "informer-", "dra-scheduler", "workqueue", "wq-")
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        left = [t.name for t in threading.enumerate()
                if t.name.startswith(names) and t.name != "MainThread"]
        if not left:
            return
        time.sleep(0.01)
    raise AssertionError(f"threads left: {left}")


def both(fn):
    """``fn(side_namespace, side_name)`` on each side; the two results,
    asserted equal; the port's."""
    got = {name: fn(m, name) for name, m in SIDES.items()}
    assert got["pt"] == got["jax"]
    return got["pt"]


def seed_uuids(monkeypatch):
    """``uuid.uuid4`` from a generator reset at each call of the returned
    function (one stream a side)."""
    rng = random.Random(0)
    monkeypatch.setattr(uuid, "uuid4",
                        lambda: uuid.UUID(int=rng.getrandbits(128)))
    return lambda: rng.seed(7)


def state(kube) -> dict:
    """What the comparisons read of one store (uids and resource
    versions aside: each fake numbers its own)."""
    claims = {}
    for c in kube.list(*RES, "resourceclaims"):
        md = c["metadata"]
        ann = dict(md.get("annotations") or {})
        traced = ann.pop(TRACEPARENT, None) is not None
        claims[(md.get("namespace"), md["name"])] = {
            "annotations": ann, "traced": traced, "spec": c.get("spec"),
            "owner": [o["name"] for o in md.get("ownerReferences") or []],
            "allocation": c.get("status", {}).get("allocation"),
            "reservedFor": [r.get("name") for r in c.get("status", {}).get(
                "reservedFor") or []],
            "conditions": c.get("status", {}).get("conditions"),
        }
    pods = {}
    for p in kube.list("", "v1", "pods"):
        md = p["metadata"]
        pods[(md.get("namespace"), md["name"])] = {
            "nodeName": p.get("spec", {}).get("nodeName"),
            "claims": p.get("status", {}).get("resourceClaimStatuses"),
            "conditions": p.get("status", {}).get("conditions"),
        }
    events = sorted(json.dumps(
        {k: e.get(k) for k in ("type", "reason", "message")}
        | {"name": e["metadata"]["name"],
           "object": e.get("involvedObject", {}).get("name")},
        sort_keys=True) for e in kube.list("", "v1", "events"))
    return {"claims": claims, "pods": pods, "events": events}


def samples(m, registry, name, **labels) -> float:
    """The sum of ``name``'s samples with ``labels`` in ``registry``'s
    exposition."""
    return sum(s.value for fam in text_string_to_metric_families(
        m.text(registry)) for s in fam.samples
        if s.name == name and labels.items() <= s.labels.items())


def alloc_of(st, name, ns="default"):
    return st["claims"][(ns, name)]["allocation"]


class EventRun:
    """One side's event-mode scheduler over a fresh fake."""

    def __init__(self, m, setup=None, counting=False, **kw):
        self.m = m
        self.fake = m.kube.FakeKubeClient()
        if setup is not None:
            setup(self.fake)
        self.kube = Counting(self.fake) if counting else self.fake
        self.sched = m.sched.DraScheduler(self.kube, **kw)

    def __enter__(self):
        self.sched.start_event_driven()
        assert self.sched.drain(DRAIN_S)
        return self

    def __exit__(self, *exc):
        self.sched.stop()

    def step(self, fn):
        fn(self.fake)
        assert self.sched.drain(DRAIN_S)
        return state(self.fake)


def two_nodes(fake):
    apply_class(fake)
    for node in ("node-a", "node-b"):
        fake_su = pt_su if isinstance(fake, pt_kube.FakeKubeClient) \
            else jax_su
        fake_su.publish_resource_slices(fake, node_slices(node))


def _template(fake):
    fake.create(*RES, "resourceclaimtemplates", {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaimTemplate",
        "metadata": {"name": "tpl", "namespace": "default"},
        "spec": {"spec": {"devices": {"requests": [
            {"name": "tpu", "exactly": {"deviceClassName": DRIVER}}]}}},
    }, namespace="default")
    fake.create("", "v1", "pods", {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "worker", "namespace": "default"},
        "spec": {"containers": [{"name": "c"}],
                 "resourceClaims": [{"name": "tpu",
                                     "resourceClaimTemplateName": "tpl"}]},
    }, namespace="default")


def _publish(fake, slices):
    su = pt_su if isinstance(fake, pt_kube.FakeKubeClient) else jax_su
    su.publish_resource_slices(fake, slices)


# Each flow: its steps (writes, a drain after each), then a check of the
# port's state after the last, as the JAX test checks the JAX one.
def _check_bound(states):
    st = states[-1]
    assert alloc_of(st, "c1")
    assert st["pods"][("default", "p1")]["nodeName"]
    assert st["claims"][("default", "c1")]["reservedFor"] == ["p1"]


def _check_template(states):
    st = states[-1]
    pod = st["pods"][("default", "worker")]
    assert pod["nodeName"]
    (status,) = pod["claims"]
    assert alloc_of(st, status["resourceClaimName"])


def _check_unblocked(states):
    before, after = states[-2], states[-1]
    assert alloc_of(before, "c-big-a") and alloc_of(before, "c-big-b")
    assert alloc_of(before, "c-wait") is None
    assert alloc_of(after, "c-wait")


def _check_retried(states):
    assert alloc_of(states[-2], "c-gpu") is None
    assert alloc_of(states[-1], "c-gpu")


FLOWS = {
    "claim_event_allocates_and_binds_pod": ([
        lambda f: (make_claim(f, "c1"), make_pod(f, "p1", "c1"))],
        _check_bound),
    "template_pod_generates_claim": ([_template], _check_template),
    "claim_delete_unblocks_pending_claim": ([
        lambda f: (make_claim(f, "c-big-a", count=4),
                   make_claim(f, "c-big-b", count=4),
                   make_claim(f, "c-wait")),
        lambda f: f.delete(*RES, "resourceclaims", "c-big-a", "default")],
        _check_unblocked),
    "slice_publish_retries_pending_claims": ([
        lambda f: make_claim(f, "c-gpu", cel=(
            'device.attributes["tpu.dra.dev"].index == 9')),
        lambda f: _publish(f, node_slices("node-c", chips=10))],
        _check_retried),
}


@pytest.mark.parametrize("flow", sorted(FLOWS))
def test_event_flow_matches_jax(flow, monkeypatch):
    steps, check = FLOWS[flow]
    reseed = seed_uuids(monkeypatch)

    def run(m, side):
        reseed()
        with EventRun(m, two_nodes,
                      sched_metrics=m.metrics.SchedulerMetrics()) as r:
            return [r.step(s) for s in steps]
    check(both(run))


def test_quiesced_cluster_costs_no_kube_traffic():
    """Ten forced full resyncs of a converged cluster: no write and no
    read on either side (event mode serves them from its caches)."""
    def run(m, side):
        with EventRun(m, two_nodes, counting=True) as r:
            def fill(f):
                for i in range(3):
                    make_claim(f, f"c{i}")
                    make_pod(f, f"p{i}", f"c{i}")
            st = r.step(fill)
            assert all(alloc_of(st, f"c{i}") for i in range(3))
            assert r.sched.drain(DRAIN_S)
            writes0, reads0 = r.kube.writes, r.kube.reads
            for _ in range(10):
                r.sched._enqueue(("full",))
                assert r.sched.drain(DRAIN_S)
            return r.kube.writes - writes0, r.kube.reads - reads0
    assert both(run) == (0, 0)


def test_incremental_equals_full_on_the_jax_trace():
    trace = jax_incremental.TestIncrementalFullEquivalence.TRACE
    final = jax_incremental.TestIncrementalFullEquivalence._final_allocations

    def apply(fake, op, name, kw):
        if op == "create":
            make_claim(fake, name, count=kw.get("count", 1),
                       cel=kw.get("cel"))
        else:
            fake.delete(*RES, "resourceclaims", name, "default")

    def run(m, side):
        polled = m.kube.FakeKubeClient()
        two_nodes(polled)
        sched = m.sched.DraScheduler(polled)
        for op, name, kw in trace:
            apply(polled, op, name, kw)
            sched.sync_once()
            sched.sync_once()
        with EventRun(m, two_nodes) as r:
            for op, name, kw in trace:
                r.step(lambda f: apply(f, op, name, kw))
            evented = final(r.fake)
        assert final(polled) == evented
        return evented
    got = both(run)
    assert got["g"] is None and all(got[n] for n in "cdef")


# -- the snapshot -------------------------------------------------------------

def _lifecycle(case, m):
    fake = m.kube.FakeKubeClient()
    if case == "cached_until_slice_change":
        _publish(fake, node_slices("node-a"))
        view = m.cache.ClusterView(fake)
        s1 = view.snapshot()
        names = sorted(c.name for c in s1.candidates)
        stats = m.su.publish_resource_slices(fake, node_slices("node-a"))
        return names, view.snapshot() is s1, stats["writes"]
    if case == "rebuilt_on_generation_bump":
        _publish(fake, node_slices("node-a"))
        view = m.cache.ClusterView(fake)
        s1 = view.snapshot()
        s1.order_cache[("sentinel",)] = ["stale"]
        _publish(fake, node_slices("node-a", chips=5))
        s2 = view.snapshot()
        return (s2 is not s1, ("sentinel",) in s2.order_cache,
                sorted(c.name for c in s2.candidates),
                s2.pool_generations[(DRIVER, "node-a")])
    if case == "stale_generation_filtered":
        _publish(fake, node_slices("node-a"))
        stale = node_slices("node-a")[0]
        stale["metadata"]["name"] = "stale"
        stale["spec"]["pool"]["generation"] = 0
        stale["spec"]["devices"] = [{"name": "phantom"}]
        fake.create(*RES, "resourceslices", stale)
        return sorted(c.name for c in m.cache.ClusterView(
            fake).snapshot().candidates)
    if case == "default_node_for_nodeless_slices":
        nodeless = node_slices("node-a")[0]
        del nodeless["spec"]["nodeName"]
        fake.create(*RES, "resourceslices", nodeless)
        return (sorted(m.cache.ClusterView(
            fake, default_node="node-dflt").snapshot().by_node),
            sorted(m.cache.ClusterView(fake).snapshot().by_node))
    snap = m.cache.InventorySnapshot(node_slices("node-a"))
    alloc = m.cache.AllocationState(snap)
    claim = {"metadata": {"uid": "u1", "namespace": "default",
                          "name": "c1"},
             "status": {"allocation": {"devices": {"results": [{
                 "driver": DRIVER, "pool": "node-a",
                 "device": "chip-0"}]}}}}
    return (alloc.observe(claim), alloc.observe(claim),
            sorted(alloc.allocated), alloc.forget(claim),
            sorted(alloc.allocated), alloc.forget(claim))


@pytest.mark.parametrize("case", [
    "cached_until_slice_change", "rebuilt_on_generation_bump",
    "stale_generation_filtered", "default_node_for_nodeless_slices",
    "observe_idempotent_and_forget"])
def test_snapshot_lifecycle_matches_jax(case):
    got = both(lambda m, side: _lifecycle(case, m))
    expected = {
        "cached_until_slice_change": (
            ["chip-0", "chip-1", "chip-2", "chip-3"], True, 0),
        "rebuilt_on_generation_bump": (
            True, False, [f"chip-{i}" for i in range(5)], 2),
        "stale_generation_filtered": [f"chip-{i}" for i in range(4)],
        "default_node_for_nodeless_slices": (["node-dflt"], [""]),
        "observe_idempotent_and_forget": (
            True, False, [(DRIVER, "node-a", "chip-0")], True, [], False),
    }
    assert got == expected[case]


def _started_view(m, pools, **slice_kw):
    fake = m.kube.FakeKubeClient()
    for pool in pools:
        _publish(fake, [make_slice(pool, **slice_kw)])
    view = m.cache.ClusterView(fake).start()
    assert view.wait_for_sync(10)
    return fake, view


def _isolation(case, m):
    key = (DRIVER,)
    if case == "untouched_pools_merge_by_identity":
        fake, view = _started_view(m, ("node-a", "node-b", "node-c"))
        s1 = view.snapshot()
        s1.pools[key + ("node-b",)].sel_cache[("expr", "chip-0")] = True
        _publish(fake, [make_slice("node-a", chips=6)])
        s2 = view.snapshot()
        out = (s2 is not s1, sorted(s2.delta_pools),
               s2.pools[key + ("node-a",)] is not s1.pools[
                   key + ("node-a",)],
               s2.pools[key + ("node-b",)] is s1.pools[key + ("node-b",)],
               s2.pools[key + ("node-b",)].sel_cache,
               s2.pools[key + ("node-c",)] is s1.pools[key + ("node-c",)],
               s2.by_node["node-b"] is s1.by_node["node-b"],
               len(s2.by_node["node-a"]))
    elif case == "order_memos_survive_for_untouched_pools":
        fake, view = _started_view(m, ("node-a", "node-b"))
        s1 = view.snapshot()
        key_b = (DRIVER, "node-b", ("chip-0", "chip-1"), 2)
        key_a = (DRIVER, "node-a", ("chip-0", "chip-1"), 2)
        s1.order_memo_put(key_b, ["chip-1", "chip-0"])
        s1.order_memo_put(key_a, ["chip-0", "chip-1"])
        _publish(fake, [make_slice("node-a", chips=5)])
        s2 = view.snapshot()
        miss = getattr(m.cache, "ORDER_MISS", None) or m.cache._ORDER_MISS
        out = (s2.order_memo_get(key_b), s2.order_memo_get(key_a) is miss)
    elif case == "noop_delta_returns_same_snapshot":
        fake, view = _started_view(m, ("node-a",))
        s1 = view.snapshot()
        with view._snapshot_lock:
            view._dirty_pools.add(key + ("node-a",))
            view._slice_gen += 1
        out = view.snapshot() is s1
    else:  # pool removal and addition
        fake, view = _started_view(m, ("node-a", "node-b"))
        s1 = view.snapshot()
        fake.delete(*RES, "resourceslices", "node-a-tpu.dra.dev")
        _publish(fake, [make_slice("node-c")])
        s2 = view.snapshot()
        out = (key + ("node-a",) in s2.pools, key + ("node-c",) in s2.pools,
               "node-a" in s2.by_node,
               sorted(c.name for c in s2.by_node["node-c"]),
               s2.pools[key + ("node-b",)] is s1.pools[key + ("node-b",)])
    view.stop()
    return out


@pytest.mark.parametrize("case", [
    "untouched_pools_merge_by_identity",
    "order_memos_survive_for_untouched_pools",
    "noop_delta_returns_same_snapshot", "pool_removal_and_addition"])
def test_delta_mutation_isolation_matches_jax(case):
    got = both(lambda m, side: _isolation(case, m))
    expected = {
        "untouched_pools_merge_by_identity": (
            True, [(DRIVER, "node-a")], True, True,
            {("expr", "chip-0"): True}, True, True, 6),
        "order_memos_survive_for_untouched_pools": (
            ["chip-1", "chip-0"], True),
        "noop_delta_returns_same_snapshot": True,
        "pool_removal_and_addition": (
            False, True, False, [f"chip-{i}" for i in range(4)], True),
    }
    assert got == expected[case]


def test_delta_equals_rebuild_and_jax_over_a_seeded_trace():
    """Seeded slice churn (bump, resize, add, delete, taint, split) on
    40 pools, 120 steps: at each step the port's delta snapshot's
    fingerprint equals the port's cold rebuild's and the JAX delta
    snapshot's (exact), and the delta path ran in at least half the
    steps."""
    pools, steps = 40, 120

    def run(m, side):
        rng = random.Random(0xC0FFEE)
        fake = m.kube.FakeKubeClient()
        live: dict[str, dict] = {}
        for i in range(pools):
            sl = make_slice(f"node-{i:03d}", counters=(i % 3 == 0))
            live[sl["metadata"]["name"]] = sl
            _publish(fake, [sl])
        view = m.cache.ClusterView(fake).start()
        assert view.wait_for_sync(10)
        view.snapshot()
        prints, deltas = [], 0
        for step in range(steps):
            op = rng.choice(("bump", "resize", "add", "delete", "taint",
                             "split"))
            if op == "add" or not live:
                sl = make_slice(f"node-{pools + step:03d}",
                                chips=rng.randrange(1, 6))
                live[sl["metadata"]["name"]] = sl
                fake.create(*RES, "resourceslices", copy.deepcopy(sl))
            elif op == "delete":
                name = rng.choice(sorted(live))
                live.pop(name)
                fake.delete(*RES, "resourceslices", name)
            else:
                name = rng.choice(sorted(live))
                sl = copy.deepcopy(live[name])
                sl["spec"]["pool"]["generation"] += 1
                if op == "resize":
                    sl["spec"]["devices"] = sl["spec"]["devices"][
                        :rng.randrange(1, 5)]
                elif op == "taint":
                    sl["spec"]["devices"][0]["taints"] = [{
                        "key": "k", "effect": "NoSchedule",
                        "value": f"v{step}"}]
                elif op == "split" and name + "-b" not in live:
                    extra = copy.deepcopy(sl)
                    extra["metadata"]["name"] = name + "-b"
                    extra["spec"]["devices"] = [{"name": f"xchip-{step}"}]
                    live[extra["metadata"]["name"]] = extra
                    fake.create(*RES, "resourceslices",
                                copy.deepcopy(extra))
                live[name] = sl
                fake.patch(*RES, "resourceslices", name,
                           {"spec": sl["spec"]})
            snap = view.snapshot()
            deltas += bool(snap.delta_pools)
            fp = snapshot_fingerprint(snap)
            assert fp == snapshot_fingerprint(
                m.cache.InventorySnapshot(view.slices())), step
            prints.append(fp)
        view.stop()
        assert deltas >= steps // 2
        return prints
    both(run)


def _alloc_claim(uid, pool, devices):
    return {"metadata": {"uid": uid, "namespace": "default", "name": uid},
            "status": {"allocation": {"devices": {"results": [
                {"driver": DRIVER, "pool": pool, "device": d}
                for d in devices]}}}}


def _alloc_view(alloc):
    return (sorted(alloc.allocated), sorted(alloc._counts.items()),
            sorted(alloc.node_load.items()),
            sorted((k, sorted(v.items()))
                   for k, v in alloc.ledger._avail.items()))


def _retarget(case, m):
    if case == "ordered_nodes_least_loaded_first":
        alloc = m.cache.AllocationState(m.cache.InventorySnapshot(
            [make_slice(f"node-{i}") for i in range(3)]))
        alloc.observe(_alloc_claim("c1", "node-0", ["chip-0"]))
        first = list(alloc.ordered_nodes())
        alloc.observe(_alloc_claim("c2", "node-1", ["chip-0"]))
        alloc.observe(_alloc_claim("c3", "node-1", ["chip-1"]))
        return first, list(alloc.ordered_nodes())
    if case == "matches_full_rebuild":
        slices = [make_slice("node-a", counters=True),
                  make_slice("node-b", counters=True), make_slice("node-c")]
        claims = [_alloc_claim("c1", "node-a", ["chip-0", "chip-1"]),
                  _alloc_claim("c2", "node-b", ["chip-0"]),
                  _alloc_claim("c3", "node-c", ["chip-3"])]
        slices2 = [make_slice("node-a", gen=2, chips=2, counters=True),
                   slices[1], slices[2]]
    else:  # pool removed
        slices = [make_slice("node-a", counters=True), make_slice("node-b")]
        claims = [_alloc_claim("c1", "node-a", ["chip-0"])]
        slices2 = [slices[1]]
    alloc = m.cache.AllocationState(m.cache.InventorySnapshot(slices))
    alloc.rebuild(claims)
    snap2 = m.cache.InventorySnapshot(slices2)
    alloc.retarget(snap2, {(DRIVER, "node-a")})
    fresh = m.cache.AllocationState(snap2)
    fresh.rebuild(claims)
    assert alloc.snapshot is snap2
    assert _alloc_view(alloc) == _alloc_view(fresh)
    return _alloc_view(alloc)


@pytest.mark.parametrize("case", ["matches_full_rebuild", "pool_removed",
                                  "ordered_nodes_least_loaded_first"])
def test_retarget_matches_rebuild_and_jax(case):
    got = both(lambda m, side: _retarget(case, m))
    if case == "ordered_nodes_least_loaded_first":
        assert got == (["node-1", "node-2", "node-0"],
                       ["node-2", "node-0", "node-1"])


def test_scheduler_retargets_instead_of_rebuilding():
    def run(m, side):
        def setup(fake):
            apply_class(fake)
            for i in range(4):
                _publish(fake, [make_slice(f"node-{i}")])
        sm = m.metrics.SchedulerMetrics()
        with EventRun(m, setup, sched_metrics=sm) as r:
            r.step(lambda f: make_claim(f, "c1"))
            alloc1 = r.sched._alloc
            st = r.step(lambda f: _publish(f, [make_slice("node-2",
                                                          chips=6)]))
            snap, alloc2 = r.sched._ensure_alloc_state()
            deltas = samples(m, sm.registry, "tpu_dra_sched_snapshot_delta"
                             "_seconds_count")
            return (alloc2 is alloc1, len(snap.by_node["node-2"]),
                    bool(alloc_of(st, "c1")), bool(alloc2.allocated),
                    deltas >= 1)
    assert both(run) == (True, 6, True, True, True)


def test_cd_event_updates_only_its_window():
    def cd(uid, nodes):
        return {"apiVersion": "resource.tpu.dra/v1beta1",
                "kind": "ComputeDomain",
                "metadata": {"name": f"cd-{uid}", "uid": uid, "annotations": {
                    pt_cache.PREFERRED_NODES_ANNOTATION: nodes}},
                "spec": {}}

    def run(m, side):
        fake = m.kube.FakeKubeClient()
        fake.create("resource.tpu.dra", "v1beta1", "computedomains",
                    cd("u1", "node-a,node-b"))
        fake.create("resource.tpu.dra", "v1beta1", "computedomains",
                    cd("u2", "node-c"))
        view = m.cache.ClusterView(fake).start()
        assert view.wait_for_sync(10)
        w1 = view.cd_windows()
        first = copy.deepcopy(w1)
        # The fake delivers each event on the writer's thread: the view
        # has it when the write returns.
        fake.patch("resource.tpu.dra", "v1beta1", "computedomains", "cd-u2",
                   {"metadata": {"annotations": {
                       pt_cache.PREFERRED_NODES_ANNOTATION: "node-d"}}})
        w2 = view.cd_windows()
        after_patch = (w2 is w1, copy.deepcopy(w2))
        fake.delete("resource.tpu.dra", "v1beta1", "computedomains",
                    "cd-u1")
        gone = "u1" not in view.cd_windows()
        view.stop()
        return first, after_patch, gone
    assert both(run) == (
        {"u1": ["node-a", "node-b"], "u2": ["node-c"]},
        (True, {"u1": ["node-a", "node-b"], "u2": ["node-d"]}), True)


def test_concurrent_snapshot_readers_see_consistent_views():
    """Three readers through 60 slice writes on 8 pools: every snapshot
    they read has ``by_key`` agree with ``by_node``, on both sides."""
    def run(m, side):
        fake, view = _started_view(m, [f"node-{i}" for i in range(8)])
        stop, errors = threading.Event(), []

        def reader():
            while not stop.is_set():
                snap = view.snapshot()
                for cands in list(snap.by_node.values()):
                    for c in cands:
                        if snap.by_key.get(c.key) is not c:
                            errors.append(c.key)
                            return
        threads = [threading.Thread(target=reader) for _ in range(3)]
        for t in threads:
            t.start()
        for step in range(60):
            _publish(fake, [make_slice(f"node-{step % 8}", gen=2 + step,
                                       chips=1 + step % 5)])
        stop.set()
        for t in threads:
            t.join(10)
        last = snapshot_fingerprint(view.snapshot())
        view.stop()
        return errors, last
    assert both(run)[0] == []


def _conflict_setup(fake):
    apply_class(fake)
    _publish(fake, [make_slice("node-a", chips=2)])


def test_conflict_requeues_its_claim():
    def run(m, side):
        with EventRun(m, _conflict_setup) as r:
            enqueued = []
            orig = r.sched._enqueue
            requeued = threading.Event()

            def spy(key):
                enqueued.append(key)
                if enqueued.count(("claim", "default", "c1")) >= 2:
                    requeued.set()
                orig(key)
            r.sched._enqueue = spy
            r.sched._allocate_one = lambda *a, **kw: "conflict"
            make_claim(r.fake, "c1")
            # The original event's enqueue and a requeue from the
            # conflict (then it keeps retrying under backoff).
            assert requeued.wait(DRAIN_S)
            return enqueued[:2]
    assert both(run) == [("claim", "default", "c1")] * 2


def test_refit_recaptures_the_live_state():
    def run(m, side):
        fake = m.kube.FakeKubeClient()
        _conflict_setup(fake)
        sched = m.sched.DraScheduler(fake)
        snap, live = sched._ensure_alloc_state()
        classes = sched._device_classes()
        live.observe(_alloc_claim("other", "node-a", ["chip-0"]))
        stale = m.cache.AllocationState(snap)
        stale.rebuild([])
        make_claim(fake, "c1")
        claim = fake.get(*RES, "resourceclaims", "c1", "default")
        outcome = sched._allocate_one(claim, snap, stale, classes)
        got = fake.get(*RES, "resourceclaims", "c1", "default")
        return outcome, [r["device"] for r in got["status"]["allocation"][
            "devices"]["results"]]
    assert both(run) == ("committed", ["chip-1"])


def test_metrics_wiring_matches_jax():
    """One claim in event mode: the same families, the same label sets
    and the same sample counts on both registries (times aside)."""
    def run(m, side):
        sm = m.metrics.SchedulerMetrics()
        with EventRun(m, two_nodes, sched_metrics=sm) as r:
            r.step(lambda f: make_claim(f, "c1"))
        text = m.text(sm.registry)
        got = {}
        for fam in text_string_to_metric_families(text):
            for s in fam.samples:
                if s.name.endswith("_created"):
                    continue
                key = (s.name, tuple(sorted(s.labels.items())))
                timed = fam.type == "histogram" and not s.name.endswith(
                    "_count")
                got[key] = None if timed or s.name.startswith(
                    "tpu_dra_workqueue_depth") else s.value
        return got
    got = both(run)
    assert got[("tpu_dra_sched_sync_seconds_count",
                (("mode", "full"),))] == 1.0
    assert got[("tpu_dra_sched_sync_seconds_count",
                (("mode", "incremental"),))] >= 1.0
    assert got[("tpu_dra_sched_dirty_queue_depth", ())] == 0.0
    assert got[("tpu_dra_informer_relist_total",
                (("resource", "resourceslices"),))] == 1.0


# -- the relist gate ----------------------------------------------------------

def _coord(m, **kw):
    kw.setdefault("rng", random.Random(7))
    return m.inf.RelistCoordinator(**kw)


def _coordinator_case(case, m):
    clock = [0.0]
    now = lambda: clock[0]  # noqa: E731
    if case == "first_relist_is_free":
        return _coord(m, time_fn=now).backoff_for("resourceslices")
    if case == "repeats_back_off_with_jitter":
        coord = _coord(m, base_delay=1.0, max_delay=8.0, quiet_period=60.0,
                       time_fn=now)
        coord._last["pods"] = 0.0
        delays = []
        for _ in range(5):
            clock[0] += 1.0
            delays.append(coord.backoff_for("pods"))
            coord._last["pods"] = clock[0]
        for d, base in zip(delays, (1.0, 2.0, 4.0, 8.0, 8.0)):
            assert base * 0.5 <= d <= base
        return delays
    if case == "quiet_period_resets_the_streak":
        coord = _coord(m, base_delay=1.0, quiet_period=10.0, time_fn=now)
        coord._last["pods"] = 0.0
        clock[0] = 1.0
        first = coord.backoff_for("pods")
        coord._last["pods"] = 1.0
        clock[0] = 100.0
        return first > 0, coord.backoff_for("pods")
    if case == "backoff_hook_and_sleep":
        observed, sleeps = [], []
        coord = _coord(m, base_delay=1.0, quiet_period=60.0,
                       on_backoff=lambda r, s: observed.append((r, s)),
                       time_fn=now, sleep_fn=sleeps.append)
        coord.run("pods", lambda: None)
        coord.run("pods", lambda: None)
        assert sleeps == [observed[0][1]]
        return observed
    # priority order under a cap of one, no backoff
    coord = _coord(m, concurrency=1, base_delay=0.0, quiet_period=0.0,
                   time_fn=now, sleep_fn=lambda s: None)
    order, gate, holding = [], threading.Event(), threading.Event()

    def job(resource):
        def fn():
            if resource == "warmup":
                holding.set()
                gate.wait(10)
            order.append(resource)
        coord.run(resource, fn)
    threads = [threading.Thread(target=job, args=("warmup",))]
    threads[0].start()
    assert holding.wait(10)
    for n, resource in enumerate(("daemonsets", "pods", "resourceclaims",
                                  "resourceslices"), start=1):
        threads.append(threading.Thread(target=job, args=(resource,)))
        threads[-1].start()
        # Wait for this waiter to be queued (a state, not a duration).
        deadline = time.monotonic() + 10
        while len(coord._waiting) < n and time.monotonic() < deadline:
            time.sleep(0.001)
        assert len(coord._waiting) == n
    gate.set()
    for t in threads:
        t.join(10)
    return order


@pytest.mark.parametrize("case", [
    "first_relist_is_free", "repeats_back_off_with_jitter",
    "quiet_period_resets_the_streak", "backoff_hook_and_sleep",
    "priority_order_under_the_cap"])
def test_relist_coordinator_matches_jax(case):
    got = both(lambda m, side: _coordinator_case(case, m))
    if case == "first_relist_is_free":
        assert got == 0.0
    elif case == "quiet_period_resets_the_streak":
        assert got == (True, 0.0)
    elif case == "priority_order_under_the_cap":
        assert got == ["warmup", "resourceslices", "resourceclaims",
                       "pods", "daemonsets"]


def _make_cd(kube, name, uid=None):
    return kube.create(API_GROUP, API_VERSION, "computedomains", {
        "apiVersion": f"{API_GROUP}/{API_VERSION}", "kind": "ComputeDomain",
        "metadata": {"name": name, "namespace": "default",
                     **({"uid": uid} if uid else {})},
        "spec": {"numNodes": 2}}, namespace="default")


def _kind(side):
    """The JAX informer's ``kind`` argument (its legacy fake surface; the
    port's informer has none)."""
    return {"kind": "ComputeDomain"} if side == "jax" else {}


def test_informer_routes_relists_through_the_coordinator():
    def run(m, side):
        ran = []

        class Spy:
            def run(self, resource, fn):
                ran.append(resource)
                return fn()
        kube = m.kube.FakeKubeClient()
        _make_cd(kube, "cd1")
        inf = m.inf.Informer(kube, API_GROUP, API_VERSION, "computedomains",
                             coordinator=Spy(), **_kind(side))
        inf.start()
        inf.relist()
        found = inf.get("cd1", "default") is not None
        inf.stop()
        return ran, found
    assert both(run) == (["computedomains", "computedomains"], True)


def test_view_lists_in_relist_priority_order():
    def run(m, side):
        kube = m.kube.FakeKubeClient()
        listed = []
        name = "list" if side == "jax" else "list_with_version"
        orig = getattr(kube, name)

        def spy(group, version, resource, **kw):
            listed.append(resource)
            return orig(group, version, resource, **kw)
        setattr(kube, name, spy)
        view = m.cache.ClusterView(kube).start()
        assert view.wait_for_sync(10)
        view.stop()
        return listed
    listed = both(run)
    prios = [pt_inf.RELIST_PRIORITY.get(r, 9) for r in listed]
    assert prios == sorted(prios) and listed[0] == "resourceslices"


def test_event_gate_parks_until_flush():
    def run(m, side):
        kube = m.kube.FakeKubeClient()
        inf = m.inf.Informer(kube, API_GROUP, API_VERSION, "computedomains",
                             **_kind(side)).start()
        assert inf.wait_for_sync(5.0)
        inf.event_gate = lambda ev_type, obj: False
        _make_cd(kube, "cd1", uid="u1")
        kube.patch(API_GROUP, API_VERSION, "computedomains", "cd1",
                   {"status": {"status": "Ready"}}, namespace="default")
        parked = inf.get_by_uid("u1")
        inf.event_gate = None
        flushed = inf.flush_deferred()
        status = inf.get_by_uid("u1")["status"]["status"]
        inf.stop()
        return parked, flushed, status, inf.flush_deferred()
    assert both(run) == (None, 2, "Ready", 0)
