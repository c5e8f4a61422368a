"""The port's sharded scheduler, its claim batch, its work queue and its
scheduling domains with spillover against the JAX package's, on the CPU
(``tests/test_sched_scaleout.py``, ``tests/test_spillover.py``).

- **Shard routing**: control keys on worker 0, claim and pod keys spread
  over the data workers by namespace/name, to the same worker as JAX's.
- **Workers > 1**: placements depend on interleaving, so both sides are
  held to the same invariants (exact): the same set of allocated claims,
  no device held twice, the allocation state's devices, counters, node
  loads and power debits equal to a fresh ``AllocationState.rebuild``,
  and each allocation fitting its request (its count of devices of its
  class). A pinned trace gives the same allocations at one worker and at
  four; a state rebuild inside a commit's patch keeps the reservation; a
  commit against a superseded state reserves in the live one; a batch
  whose setup fails hands its taken keys back; a conflict re-fits and
  counts ``tpu_dra_sched_commit_conflicts_total``.
- **The batch**: a parked worker's burst of ten claims drains in batches
  of more than one, all allocated, none twice.
- **Snapshot race**: a listing older than a concurrent invalidation is
  never installed; one build serves eight concurrent readers.
- **Domains**: pools and claims partitioned, the snapshot held to the
  domain's pools, globs, the generated claim inheriting its pod's domain,
  ``DomainExhausted`` (condition, one Event, the counter, cleared once
  allocated; never on an unpinned claim), and the per-domain Lease.
- **Spillover**: an exhausted domain's claim moves to its sibling and
  allocates there (annotations, one ``DomainSpilled`` Event, the counter,
  the condition retired), the opt-out, the hop cap, the ranking by
  order and utilization, the capacity memo's debit, the master switch
  and the siblings' grammar: each equal to the JAX scheduler's outcome.
- **Interleavings** (the JAX package's ``pkg/analysis/interleave``
  explorer over the port's classes): two workers racing one free device,
  a gang's window against a single-node claim; no deadlock, no device
  twice, over every explored schedule.
- **The work queue** (``pkg/workqueue.py``): ``stable_shard_hash`` and
  ``worker_of``, batch takes, work stealing, the hot-key escalation and
  the global token bucket, driven by an injected clock where a delay
  decides; its exposition on the scheduler's registry.
"""

import threading
import time
from contextlib import contextmanager

import pytest

from k8s_dra_driver_gpu_tpu.pkg import workqueue as jax_wq
from k8s_dra_driver_gpu_tpu.pkg.analysis.interleave import explore
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import schedcache as pt_cache
from k8s_dra_driver_gpu_tpu_torch.pkg import scheduler as pt_sched
from k8s_dra_driver_gpu_tpu_torch.pkg import workqueue as pt_wq
from tests.test_sched_scaleout import allocated_keys, make_claim, node_slices
from tests.test_spillover import make_claim as make_pinned
from tests.test_spillover import setup_class_and_slices
from tests.test_torch_sched_events import (  # noqa: F401 - the fixture
    DRAIN_S, RES, EventRun, _no_thread_left, _publish, apply_class, both,
    samples)

DRIVER = "tpu.dra.dev"
ANN = pt_cache.DOMAIN_ANNOTATION


def nodes(n, chips=4):
    def setup(fake):
        apply_class(fake)
        for i in range(n):
            _publish(fake, node_slices(f"node-{i}", chips=chips))
    return setup


def invariants(sched, kube) -> dict:
    """What workers > 1 must give whatever the interleaving: the set of
    allocated claims, no device twice, the live allocation state equal
    to a rebuild from the claims, and each allocation its request's
    count of devices of its class."""
    allocs, doubles = allocated_keys(kube)
    snap, alloc = sched._ensure_alloc_state()
    fresh = type(alloc)(snap)
    claims = kube.list(*RES, "resourceclaims")
    fresh.rebuild(claims)

    def view(a):
        return (sorted(a.allocated), sorted(a._counts.items()),
                sorted(a.node_load.items()), sorted(a.power_used.items()),
                sorted((k, sorted(v.items()))
                       for k, v in a.ledger._avail.items()))
    fits = True
    for c in claims:
        results = (c.get("status", {}).get("allocation") or {}).get(
            "devices", {}).get("results", [])
        if not results:
            continue
        (req,) = c["spec"]["devices"]["requests"]
        fits &= len(results) == req["exactly"].get("count", 1) and all(
            r["driver"] == req["exactly"]["deviceClassName"]
            for r in results)
    return {"allocated": sorted(n for n, v in allocs.items() if v),
            "pending": sorted(n for n, v in allocs.items() if not v),
            "doubles": doubles, "state_is_rebuild": view(alloc) == view(
                fresh), "fits": fits}


# -- routing -------------------------------------------------------------------

def test_shard_routing_matches_jax():
    def run(m, side):
        sched = m.sched.DraScheduler(m.kube.FakeKubeClient(), workers=4)
        ctl = [sched._shard_of((k,)) for k in (
            "full", "pending", "inventory", "daemonsets", "jobs",
            "recovery", "defrag", "autoscale", "migration", "pods-rescan")]
        data = [sched._shard_of(("claim", "default", f"c-{i}"))
                for i in range(64)]
        pods = [sched._shard_of(("pod", "ns", f"p-{i}")) for i in range(16)]
        one = m.sched.DraScheduler(m.kube.FakeKubeClient(), workers=1)
        return (ctl, data, pods, sched._stealable(("claim", "a", "b")),
                sched._stealable(("full",)),
                one._shard_of(("claim", "default", "c")))
    ctl, data, _, steal_claim, steal_full, one = both(run)
    assert set(ctl) == {0} and set(data) == {1, 2, 3}
    assert steal_claim and not steal_full and one == 0


# -- workers > 1 ---------------------------------------------------------------

@pytest.mark.parametrize("workers, batch", [(4, 4), (4, 1), (2, 8)])
def test_racing_workers_meet_the_invariants(workers, batch):
    """12 claims of one device against 8 devices: 8 allocate, 4 pend, no
    device twice, on both sides."""
    def run(m, side):
        with EventRun(m, nodes(2), workers=workers, batch_max=batch,
                      sched_metrics=m.metrics.SchedulerMetrics()) as r:
            r.step(lambda f: [make_claim(f, f"c-{i}") for i in range(12)])
            got = invariants(r.sched, r.fake)
        return (len(got["allocated"]), got["doubles"],
                got["state_is_rebuild"], got["fits"])
    assert both(run) == (8, 0, True, True)


def test_pinned_trace_same_at_one_and_four_workers():
    """Pods born bound and chip-pinning selectors: the same allocations
    at workers 1 and 4, on both sides (exact)."""
    def run(m, side):
        out = {}
        for workers in (1, 4):
            with EventRun(m, nodes(4, chips=2), workers=workers,
                          batch_max=4) as r:
                def fill(f):
                    for idx in range(8):
                        name = f"c-{idx}"
                        f.create("", "v1", "pods", {
                            "apiVersion": "v1", "kind": "Pod",
                            "metadata": {"name": f"{name}-pod",
                                         "namespace": "default"},
                            "spec": {"containers": [{"name": "c"}],
                                     "nodeName": f"node-{idx % 4}",
                                     "resourceClaims": [{
                                         "name": "tpu",
                                         "resourceClaimName": name}]},
                        }, namespace="default")
                        make_claim(f, name, cel=(
                            'device.attributes["tpu.dra.dev"].index == '
                            f'{idx // 4}'))
                r.step(fill)
                out[workers] = allocated_keys(r.fake)
        assert out[1] == out[4]
        return out[1]
    allocs, doubles = both(run)
    assert doubles == 0 and all(allocs[f"c-{i}"] for i in range(8))


def test_rebuild_inside_the_patch_keeps_the_reservation():
    def run(m, side):
        with EventRun(m, nodes(1, chips=1)) as r:
            real_patch, raced = r.fake.patch, {}

            def racing_patch(group, version, resource, name, patch,
                             namespace=None, **kw):
                if resource == "resourceclaims" and (patch.get(
                        "status") or {}).get("allocation") and not raced:
                    _, raced["alloc"] = r.sched._rebuild_alloc_state()
                return real_patch(group, version, resource, name, patch,
                                  namespace=namespace, **kw)
            r.fake.patch = racing_patch
            st = r.step(lambda f: make_claim(f, "c1"))
            r.fake.patch = real_patch
        return (bool(st["claims"][("default", "c1")]["allocation"]),
                (DRIVER, "node-0", "chip-0") in raced["alloc"].allocated)
    assert both(run) == (True, True)


def test_commit_reserves_in_the_live_state_after_a_swap():
    def run(m, side):
        fake = m.kube.FakeKubeClient()
        nodes(1, chips=1)(fake)
        sched = m.sched.DraScheduler(fake)
        make_claim(fake, "c1")
        claim = fake.get(*RES, "resourceclaims", "c1", "default")
        snap, alloc1 = sched._ensure_alloc_state()
        classes = sched._device_classes()
        _, alloc2 = sched._rebuild_alloc_state()
        return (alloc2 is not alloc1,
                sched._allocate_one(claim, snap, alloc1, classes),
                (DRIVER, "node-0", "chip-0") in alloc2.allocated)
    assert both(run) == (True, "committed", True)


def _park(r):
    """Park the one worker on a blocking key; the release."""
    block, started = threading.Event(), threading.Event()
    r.sched._queue.enqueue(("block",),
                           lambda k: (started.set(), block.wait(DRAIN_S)))
    assert started.wait(DRAIN_S)
    return block.set


def test_batch_setup_failure_hands_back_its_keys():
    def run(m, side):
        with EventRun(m, nodes(1, chips=8), workers=1, batch_max=8) as r:
            orig, failed = r.sched._device_classes, []

            def flaky():
                if not failed:
                    failed.append(1)
                    raise m.kube.KubeError(503, "transient")
                return orig()
            r.sched._device_classes = flaky
            release = _park(r)
            for i in range(5):
                make_claim(r.fake, f"f-{i}")
            release()
            # The taken keys retry under the queue's backoff.
            deadline = time.monotonic() + DRAIN_S
            while not all(allocated_keys(r.fake)[0].get(f"f-{i}")
                          for i in range(5)) and \
                    time.monotonic() < deadline:
                assert r.sched.drain(DRAIN_S)
            return sorted(n for n, v in allocated_keys(r.fake)[0].items()
                          if v), bool(failed)
    assert both(run) == ([f"f-{i}" for i in range(5)], True)


def test_burst_drains_in_batches():
    def run(m, side):
        with EventRun(m, nodes(3), workers=1, batch_max=8,
                      sched_metrics=m.metrics.SchedulerMetrics()) as r:
            batches, orig = [], r.sched._queue.take_ready

            def spy(pred, limit):
                got = orig(pred, limit)
                if got:
                    batches.append(len(got))
                return got
            r.sched._queue.take_ready = spy
            release = _park(r)
            for i in range(10):
                make_claim(r.fake, f"b-{i}")
            release()
            assert r.sched.drain(DRAIN_S)
            allocs, doubles = allocated_keys(r.fake)
        return batches, sorted(n for n, v in allocs.items() if v), doubles
    batches, allocated, doubles = both(run)
    assert max(batches) >= 2 and len(allocated) == 10 and doubles == 0


def test_conflict_refits_and_counts():
    def run(m, side):
        fake = m.kube.FakeKubeClient()
        nodes(1, chips=2)(fake)
        sm = m.metrics.SchedulerMetrics()
        sched = m.sched.DraScheduler(fake, sched_metrics=sm)
        snap, alloc = sched._ensure_alloc_state()
        classes = sched._device_classes()
        make_claim(fake, "victim")
        claim = fake.get(*RES, "resourceclaims", "victim", "default")
        orig, stolen = alloc.try_commit, []

        def stealing(claim_like):
            if not stolen:
                dev = claim_like["status"]["allocation"]["devices"][
                    "results"][0]["device"]
                stolen.append(dev)
                orig({"metadata": {"uid": "thief", "name": "thief",
                                   "namespace": "default"},
                      "status": {"allocation": {"devices": {"results": [{
                          "driver": DRIVER, "pool": "node-0",
                          "device": dev}]}}}})
            return orig(claim_like)
        alloc.try_commit = stealing
        outcome = sched._allocate_one(claim, snap, alloc, classes)
        got = fake.get(*RES, "resourceclaims", "victim", "default")
        dev = got["status"]["allocation"]["devices"]["results"][0]["device"]
        return (outcome, dev != stolen[0], samples(
            m, sm.registry, "tpu_dra_sched_commit_conflicts_total"))
    assert both(run) == ("committed", True, 1.0)


# -- the snapshot race ---------------------------------------------------------

def test_stale_listing_never_installed():
    def run(m, side):
        fake = m.kube.FakeKubeClient()
        _publish(fake, node_slices("node-a", chips=4))
        view = m.cache.ClusterView(fake)
        stale = [dict(s) for s in fake.list(*RES, "resourceslices")]
        _publish(fake, node_slices("node-a", chips=6))
        orig, raced = fake.list, []

        def racy_list(group, version, resource, namespace=None, **kw):
            if resource == "resourceslices" and not raced:
                raced.append(1)
                view.invalidate_snapshot()
                return stale
            return orig(group, version, resource, namespace=namespace,
                        **kw)
        fake.list = racy_list
        names = sorted(c.name for c in view.snapshot().candidates)
        return names, bool(raced)
    assert both(run) == ([f"chip-{i}" for i in range(6)], True)


def test_concurrent_readers_share_one_build():
    def run(m, side):
        fake = m.kube.FakeKubeClient()
        _publish(fake, node_slices("node-a"))
        builds, snaps = [], []
        view = m.cache.ClusterView(fake, on_snapshot_build=builds.append)
        threads = [threading.Thread(target=lambda: snaps.append(
            view.snapshot())) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(10)
        return len({id(s) for s in snaps}), len(builds)
    assert both(run) == (1, 1)


# -- domains -------------------------------------------------------------------

def _domains(case, m):
    fake = m.kube.FakeKubeClient()
    apply_class(fake)
    dom = m.cache.SchedulingDomain
    if case == "partition_pools_and_claims":
        for n in ("node-a", "node-b"):
            _publish(fake, node_slices(n))
        sa = m.sched.DraScheduler(fake, domain=dom("a", pools=["node-a"],
                                                   default=True))
        sb = m.sched.DraScheduler(fake, domain=dom("b", pools=["node-b"]))
        make_claim(fake, "c-plain")
        make_claim(fake, "c-b", annotations={ANN: "b"})
        sb.sync_once()
        first = allocated_keys(fake)[0]
        sa.sync_once()
        return first, allocated_keys(fake)[0]
    if case == "snapshot_held_to_own_pools":
        for n in ("node-a", "node-b"):
            _publish(fake, node_slices(n))
        return sorted(m.sched.DraScheduler(fake, domain=dom(
            "b", pools=["node-b"])).view.snapshot().by_node)
    if case == "pool_globs":
        d = dom("edge", pools=["edge-*"])
        return d.owns_pool("edge-7", "edge-7"), d.owns_pool("core-1",
                                                           "core-1")
    _publish(fake, node_slices("node-b"))
    fake.create(*RES, "resourceclaimtemplates", {
        "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaimTemplate",
        "metadata": {"name": "tpl", "namespace": "default"},
        "spec": {"spec": {"devices": {"requests": [
            {"name": "tpu", "exactly": {"deviceClassName": DRIVER}}]}}},
    }, namespace="default")
    fake.create("", "v1", "pods", {
        "apiVersion": "v1", "kind": "Pod",
        "metadata": {"name": "worker", "namespace": "default",
                     "annotations": {ANN: "b"}},
        "spec": {"containers": [{"name": "c"}], "resourceClaims": [{
            "name": "tpu", "resourceClaimTemplateName": "tpl"}]},
    }, namespace="default")
    sched = m.sched.DraScheduler(fake, domain=dom("b", pools=["node-b"]))
    sched.sync_once()
    sched.sync_once()
    pod = fake.get("", "v1", "pods", "worker", "default")
    claim = fake.get(*RES, "resourceclaims", pod["status"][
        "resourceClaimStatuses"][0]["resourceClaimName"], "default")
    return (claim["metadata"]["annotations"][ANN],
            bool(claim["status"]["allocation"]), pod["spec"]["nodeName"])


@pytest.mark.parametrize("case", [
    "partition_pools_and_claims", "snapshot_held_to_own_pools",
    "pool_globs", "generated_claim_inherits_the_pod_domain"])
def test_domains_match_jax(case):
    got = both(lambda m, side: _domains(case, m))
    if case == "partition_pools_and_claims":
        first, last = got
        assert first["c-plain"] is None and first["c-b"][0][1] == "node-b"
        assert last["c-plain"][0][1] == "node-a"
    elif case == "snapshot_held_to_own_pools":
        assert got == ["node-b"]
    elif case == "pool_globs":
        assert got == (True, False)
    else:
        assert got == ("b", True, "node-b")


def _exhausted(m):
    fake = m.kube.FakeKubeClient()
    apply_class(fake)
    _publish(fake, node_slices("node-b", chips=1))
    sm = m.metrics.SchedulerMetrics()
    sched = m.sched.DraScheduler(fake, domain=m.cache.SchedulingDomain(
        "b", pools=["node-b"]), sched_metrics=sm)
    make_claim(fake, "fill", annotations={ANN: "b"})
    sched.sync_once()
    make_claim(fake, "wedged", annotations={ANN: "b"})
    sched.sync_once()
    return fake, sched, sm


def _conds(fake, name, kind):
    c = fake.get(*RES, "resourceclaims", name, "default")
    return [(x["status"], x["reason"]) for x in c.get("status", {}).get(
        "conditions") or [] if x["type"] == kind]


def _events(fake, reason):
    return [(e["type"], e["involvedObject"]["name"])
            for e in fake.list("", "v1", "events")
            if e.get("reason") == reason]


def _exhaustion(case, m):
    if case == "unpinned_claim_not_flagged":
        fake = m.kube.FakeKubeClient()
        apply_class(fake)
        _publish(fake, node_slices("node-a", chips=1))
        sched = m.sched.DraScheduler(fake, domain=m.cache.SchedulingDomain(
            "a", pools=["node-a"], default=True))
        make_claim(fake, "fill")
        sched.sync_once()
        make_claim(fake, "overflow")
        sched.sync_once()
        return (_conds(fake, "overflow", "DomainExhausted"),
                _events(fake, "DomainExhausted"))
    fake, sched, sm = _exhausted(m)
    if case == "deduped_across_passes":
        for _ in range(3):
            sched.sync_once()
    if case == "cleared_once_allocated":
        fake.delete(*RES, "resourceclaims", "fill", namespace="default")
        sched.sync_once()
    return (_conds(fake, "wedged", "DomainExhausted"),
            _events(fake, "DomainExhausted"),
            samples(m, sm.registry, "tpu_dra_sched_domain_exhausted_total",
                    domain="b"))


@pytest.mark.parametrize("case", [
    "condition_event_and_metric", "deduped_across_passes",
    "cleared_once_allocated", "unpinned_claim_not_flagged"])
def test_domain_exhausted_matches_jax(case):
    got = both(lambda m, side: _exhaustion(case, m))
    if case == "unpinned_claim_not_flagged":
        assert got == ([], [])
        return
    conds, events, count = got
    assert events == [("Warning", "wedged")]
    assert conds == ([("False", "Allocated")]
                     if case == "cleared_once_allocated"
                     else [("True", "DomainExhausted")])
    assert count >= (4 if case == "deduped_across_passes" else 1)


def test_leader_election_per_domain():
    """Two schedulers of one domain behind its Lease: the standby runs
    nothing until the leader steps down, then allocates."""
    def run(m, side):
        fake = m.kube.FakeKubeClient()
        nodes(1)(fake)
        kw = dict(lease_duration=1.0, renew_period=0.1, retry_period=0.05)
        dom = m.cache.SchedulingDomain("a", pools=["node-0"], default=True)
        s1 = m.sched.DraScheduler(fake, domain=dom)
        s2 = m.sched.DraScheduler(fake, domain=dom)
        stops = threading.Event(), threading.Event()
        threads = [threading.Thread(
            target=m.sched.run_leader_elected, args=(s,),
            kwargs=dict(identity=f"i{i}", stop=stops[i], **kw))
            for i, s in enumerate((s1, s2))]

        def until(pred):
            deadline = time.monotonic() + DRAIN_S
            while not pred() and time.monotonic() < deadline:
                time.sleep(0.01)
            return pred()
        threads[0].start()
        assert until(lambda: s1._queue is not None)
        threads[1].start()
        make_claim(fake, "c1")
        first = until(lambda: allocated_keys(fake)[0].get("c1"))
        standby_idle = s2._queue is None
        lease = fake.get("coordination.k8s.io", "v1", "leases",
                         "tpu-dra-scheduler-a", "kube-system")
        stops[0].set()
        threads[0].join(DRAIN_S)
        assert until(lambda: s2._queue is not None)
        make_claim(fake, "c2")
        second = until(lambda: allocated_keys(fake)[0].get("c2"))
        stops[1].set()
        threads[1].join(DRAIN_S)
        return (bool(first), standby_idle, lease["spec"]["holderIdentity"],
                bool(second))
    assert both(run) == (True, True, "i0", True)


# -- spillover -----------------------------------------------------------------

def _pair(m, sm, siblings_of_b=False):
    dom = m.cache.SchedulingDomain
    fake = m.kube.FakeKubeClient()
    setup_class_and_slices(fake, {"pool-a-0": 1, "pool-b-0": 1 if siblings_of_b
                        else 4})
    sa = m.sched.DraScheduler(fake, sched_metrics=sm, domain=dom(
        "a", pools=["pool-a*"], siblings=[dom("b", pools=["pool-b*"])]))
    sb = m.sched.DraScheduler(fake, domain=dom(
        "b", pools=["pool-b*"], default=True,
        siblings=[dom("a", pools=["pool-a*"])] if siblings_of_b else []))
    return fake, sa, sb


def _drain_pair(sa, sb):
    for _ in range(3):
        assert sa.drain(DRAIN_S) and sb.drain(DRAIN_S)


@pytest.mark.parametrize("case", ["spills_and_allocates", "opt_out",
                                  "hop_cap"])
def test_spillover_end_to_end_matches_jax(case):
    """Two event-mode schedulers of domains ``a`` and ``b`` on one fake:
    claim and annotation state, Events and the spill counter after the
    pair drains, equal on both sides."""
    def run(m, side):
        sm = m.metrics.SchedulerMetrics()
        fake, sa, sb = _pair(m, sm, siblings_of_b=case == "hop_cap")
        sa.start_event_driven()
        sb.start_event_driven()
        try:
            _drain_pair(sa, sb)
            make_pinned(fake, "c1")
            _drain_pair(sa, sb)
            if case == "spills_and_allocates":
                make_pinned(fake, "c2")
            elif case == "opt_out":
                make_pinned(fake, "c2", extra_ann={
                    pt_cache.SPILLOVER_ANNOTATION: "false"})
            else:
                make_pinned(fake, "cb1", domain="b")
                _drain_pair(sa, sb)
                make_pinned(fake, "c2")
            _drain_pair(sa, sb)
        finally:
            sa.stop()
            sb.stop()
        out = {}
        for c in fake.list(*RES, "resourceclaims"):
            ann = dict(c["metadata"].get("annotations") or {})
            ann.pop(pt_sched.tracing.TRACEPARENT_ANNOTATION, None)
            alloc = (c.get("status", {}).get("allocation") or {}).get(
                "devices", {}).get("results", [])
            out[c["metadata"]["name"]] = (
                ann, sorted(r["pool"] for r in alloc),
                sorted((x["type"], x["status"]) for x in c.get(
                    "status", {}).get("conditions") or []))
        return (out, _events(fake, "DomainSpilled"),
                samples(m, sm.registry,
                        "tpu_dra_sched_domain_spilled_total",
                        from_domain="a", to_domain="b"))
    claims, events, spilled = both(run)
    if case == "spills_and_allocates":
        ann, pools, conds = claims["c2"]
        assert ann[ANN] == "b" and ann[
            pt_cache.SPILLED_FROM_ANNOTATION] == "a"
        assert ann[pt_cache.SPILLOVER_HOPS_ANNOTATION] == "1"
        assert pools == ["pool-b-0"] and claims["c1"][1] == ["pool-a-0"]
        assert conds == [("DomainSpilled", "False")]
        assert events == [("Warning", "c2")] and spilled == 1.0
    elif case == "opt_out":
        ann, pools, conds = claims["c2"]
        assert ann[ANN] == "a" and not pools
        assert ("DomainExhausted", "True") in conds and spilled == 0.0
    else:
        ann, pools, _ = claims["c2"]
        assert int(ann.get(pt_cache.SPILLOVER_HOPS_ANNOTATION, "0")) <= 1
        assert not pools


def _ranking(case, m):
    dom = m.cache.SchedulingDomain
    fake = m.kube.FakeKubeClient()
    pools = {"pool-a-0": 0, "pool-b-0": 2}
    if case == "cheapest_sibling":
        pools = {"pool-a-0": 0, "pool-b-0": 4, "pool-c-0": 4}
    setup_class_and_slices(fake, pools)
    sibs = [dom("b", pools=["pool-b*"])]
    if case == "cheapest_sibling":
        sibs.append(dom("c", pools=["pool-c*"]))
    sched = m.sched.DraScheduler(fake, domain=dom("a", pools=["pool-a*"],
                                                  siblings=sibs))

    def claim(count=1, pinned=True):
        md = {"name": "x", "namespace": "default"}
        if pinned:
            md["annotations"] = {ANN: "a"}
        return {"metadata": md, "spec": {"devices": {"requests": [{
            "name": "r", "exactly": {"deviceClassName": DRIVER,
                                     "count": count}}]}}}
    if case == "cheapest_sibling":
        for j in range(3):
            fake.create(*RES, "resourceclaims", {
                "apiVersion": "resource.k8s.io/v1", "kind": "ResourceClaim",
                "metadata": {"name": f"pre-{j}", "namespace": "default"},
                "spec": {"devices": {"requests": []}},
                "status": {"allocation": {"devices": {"results": [{
                    "driver": DRIVER, "pool": "pool-b-0",
                    "device": f"chip-{j}"}]}}}}, namespace="default")
        return sched._rank_spill_target(claim()).name
    if case == "spill_debits_the_memo":
        for i in range(4):
            make_pinned(fake, f"flood-{i}")
        return sum(sched._maybe_spill(fake.get(
            *RES, "resourceclaims", f"flood-{i}", "default"))
            for i in range(4))
    if case == "sibling_without_capacity_skipped":
        return sched._rank_spill_target(claim(count=3))
    if case == "unpinned_or_domainless_never_spills":
        return (sched._maybe_spill(claim(pinned=False)),
                m.sched.DraScheduler(fake)._maybe_spill(claim()))
    return None


@pytest.mark.parametrize("case", [
    "cheapest_sibling", "spill_debits_the_memo",
    "sibling_without_capacity_skipped",
    "unpinned_or_domainless_never_spills"])
def test_spill_ranking_matches_jax(case):
    got = both(lambda m, side: _ranking(case, m))
    assert got == {"cheapest_sibling": "c", "spill_debits_the_memo": 2,
                   "sibling_without_capacity_skipped": None,
                   "unpinned_or_domainless_never_spills": (False, False),
                   }[case]


def test_spillover_master_switch(monkeypatch):
    monkeypatch.setenv("TPU_DRA_SPILLOVER", "0")

    def run(m, side):
        fake = m.kube.FakeKubeClient()
        setup_class_and_slices(fake, {"pool-a-0": 0, "pool-b-0": 2})
        dom = m.cache.SchedulingDomain
        sched = m.sched.DraScheduler(fake, domain=dom(
            "a", pools=["pool-a*"], siblings=[dom("b", pools=["pool-b*"])]))
        make_pinned(fake, "x")
        return sched._maybe_spill(fake.get(*RES, "resourceclaims", "x",
                                           "default"))
    assert both(run) is False


def test_sibling_grammar_and_env(monkeypatch):
    monkeypatch.setenv("TPU_DRA_SCHED_DOMAIN", "a")
    monkeypatch.setenv("TPU_DRA_SCHED_DOMAIN_POOLS", "pool-a*")
    monkeypatch.setenv("TPU_DRA_SCHED_DOMAIN_SIBLINGS", "b=pool-b*")

    def run(m, side):
        sibs = m.cache.SchedulingDomain.parse_siblings(
            "b=pool-b*|pool-b2*; c=pool-c* ;; =bad; d")
        dom = m.cache.SchedulingDomain.from_env()
        return ([(s.name, s.pools) for s in sibs],
                [(s.name, s.pools) for s in dom.siblings], dom.lease_name)
    assert both(run) == ([("b", ["pool-b*", "pool-b2*"]),
                          ("c", ["pool-c*"])], [("b", ["pool-b*"])],
                         "tpu-dra-scheduler-a")


# -- interleavings -------------------------------------------------------------

@contextmanager
def _instrumented(current):
    """The port's node locks, commit entry and fake patch as choice
    points of the explorer in ``current["sched"]``."""
    orig_hold = pt_cache.NodeLockManager.hold
    orig_commit = pt_sched.DraScheduler._commit_allocation
    orig_patch = pt_kube.FakeKubeClient.patch

    @contextmanager
    def vhold(self, held):
        vs = current["sched"]
        if vs is None or vs._current() is None:
            with orig_hold(self, held):
                yield
            return
        ids = sorted(set(held))
        for n in ids:
            vs.lock_acquire(("node", n), reentrant_error=False)
        try:
            yield
        finally:
            for n in reversed(ids):
                vs.lock_release(("node", n))

    def vcommit(self, *a):
        if current["sched"] is not None:
            current["sched"].yield_point("commit")
        return orig_commit(self, *a)

    def vpatch(self, *a, **kw):
        if current["sched"] is not None:
            current["sched"].yield_point("kube.patch")
        return orig_patch(self, *a, **kw)
    pt_cache.NodeLockManager.hold = vhold
    pt_sched.DraScheduler._commit_allocation = vcommit
    pt_kube.FakeKubeClient.patch = vpatch
    try:
        yield
    finally:
        pt_cache.NodeLockManager.hold = orig_hold
        pt_sched.DraScheduler._commit_allocation = orig_commit
        pt_kube.FakeKubeClient.patch = orig_patch


@pytest.mark.parametrize("case", ["two_workers_one_node",
                                  "gang_window_vs_single_node"])
def test_interleavings_of_the_port(case):
    current = {"sched": None}

    def build(vsched):
        current["sched"] = vsched
        fake = pt_kube.FakeKubeClient()
        apply_class(fake)
        if case == "two_workers_one_node":
            _publish(fake, node_slices("node-a", chips=1))
            names = ("r1", "r2")
        else:
            _publish(fake, node_slices("node-a", chips=1))
            _publish(fake, node_slices("node-b", chips=2))
            names = ("gang-1", "solo")
        for n in names:
            make_claim(fake, n)
        dra = pt_sched.DraScheduler(fake)
        if case != "two_workers_one_node":
            orig = dra._preferred_gang_nodes
            dra._preferred_gang_nodes = lambda claim: (
                ["node-a", "node-b"]
                if claim["metadata"]["name"].startswith("gang")
                else orig(claim))
        dra._ensure_alloc_state()
        vsched.fake = fake
        for n in names:
            vsched.spawn(lambda n=n: dra._sync_claim_key("default", n),
                         name=n)

    def invariant(vsched):
        allocs, doubles = allocated_keys(vsched.fake)
        assert doubles == 0
        winners = sorted(n for n, v in allocs.items() if v)
        if case == "two_workers_one_node":
            assert len(winners) == 1, allocs
        else:
            assert winners == ["gang-1", "solo"], allocs

    with _instrumented(current):
        result = explore(build, invariant, max_schedules=300)
    assert result.ok, "\n".join(str(f) for f in result.failures)
    assert result.schedules_run > 1


# -- the work queue ------------------------------------------------------------

WQ = {"jax": jax_wq, "pt": pt_wq}


def test_shard_hash_and_worker_of_match_jax():
    keys = [("claim", "ns", f"c{i}") for i in range(32)] + [7, -3, "x"]

    def run(mod):
        q = mod.WorkQueue(workers=3, shard_of=lambda k: k)
        try:
            return ([mod.stable_shard_hash(k) for k in keys],
                    [q.worker_of(k) for k in keys])
        finally:
            q.shutdown()
    assert run(pt_wq) == run(jax_wq)


class Clock:
    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


def test_batch_take_and_finish():
    """Inside a callback, ``take_ready`` claims up to ``limit`` due keys
    its predicate admits, and ``finish`` retires or re-queues each."""
    def run(mod):
        taken, seen = [], []
        q = mod.WorkQueue(name="wq-batch")
        release = threading.Event()

        def primary(key):
            release.wait(DRAIN_S)
            got = q.take_ready(lambda k: k.startswith("b"), 2)
            taken.extend(got)
            for k in got:
                q.finish(k, RuntimeError("once") if k == got[0] and
                         not seen else None)
                seen.append(k)

        def plain(key):
            seen.append(key)
        try:
            q.enqueue("a", primary)
            for k in ("b1", "b2", "b3", "c1"):
                q.enqueue(k, plain)
            release.set()
            assert q.wait_idle(DRAIN_S)
        finally:
            q.shutdown()
        return taken, sorted(seen)
    got = {side: run(WQ[side]) for side in WQ}
    assert got["pt"] == got["jax"]
    taken, seen = got["pt"]
    assert len(taken) == 2 and all(k.startswith("b") for k in taken)
    assert seen.count(taken[0]) == 2 and seen.count(taken[1]) == 1


def test_work_stealing_moves_keys_not_runs():
    """Four workers, every key routed to worker 1 while it is parked:
    idle thieves take them, each key runs once, none concurrently."""
    runs, running, overlap = [], set(), []
    lock = threading.Lock()
    gate = threading.Event()

    def fn(key):
        with lock:
            if key in running:
                overlap.append(key)
            running.add(key)
        if key == "park":
            gate.wait(DRAIN_S)
        with lock:
            running.discard(key)
            runs.append(key)

    q = pt_wq.WorkQueue(workers=4, shard_of=lambda k: 1,
                        steal=lambda k: k != "park",
                        may_steal=lambda idx: idx != 0)
    try:
        q.enqueue("park", fn)
        deadline = time.monotonic() + DRAIN_S
        while "park" not in running and time.monotonic() < deadline:
            time.sleep(0.001)
        for i in range(12):
            q.enqueue(f"k{i}", fn)
        # Keys drain while their owner is still parked: stolen.
        while len(runs) < 12 and time.monotonic() < deadline:
            time.sleep(0.001)
        stolen = len(runs)
        gate.set()
        assert q.wait_idle(DRAIN_S)
    finally:
        gate.set()
        q.shutdown()
    assert stolen == 12 and not overlap
    assert sorted(runs) == sorted(["park"] + [f"k{i}" for i in range(12)])


def test_hot_key_escalation_on_an_injected_clock():
    """A key re-dirtied from inside its own callback runs again at once
    ``HOT_THRESHOLD`` times, then waits ``HOT_BASE_DELAY`` doubling: its
    due times read from the queue's clock (the JAX queue's delays)."""
    clock = Clock()
    dues, runs = [], []
    q = pt_wq.WorkQueue(time_fn=clock)
    orig_push = q._push

    def push(key, delay):
        dues.append(delay)
        orig_push(key, delay)
    q._push = push

    def fn(key):
        runs.append(clock())
        if len(runs) < 6:
            q.enqueue(key, fn)
    try:
        q.enqueue("hot", fn)
        deadline = time.monotonic() + DRAIN_S
        while len(runs) < 6 and time.monotonic() < deadline:
            clock.now += 1.0  # every due time passes
            time.sleep(0.001)
        assert q.wait_idle(DRAIN_S)
    finally:
        q.shutdown()
    base = jax_wq.WorkQueue.HOT_BASE_DELAY
    assert pt_wq.WorkQueue.HOT_THRESHOLD == jax_wq.WorkQueue.HOT_THRESHOLD
    assert dues == [0.0, 0.0, 0.0, 0.0, base, 2 * base]


def test_global_token_bucket_on_an_injected_clock():
    """``global_rps`` 2 with a burst of 1: at a frozen clock the first
    key runs, the second waits for the clock to give half a second."""
    clock = Clock()
    runs = []
    limiter = pt_wq.RateLimiter(global_rps=2.0, global_burst=1)
    q = pt_wq.WorkQueue(limiter=limiter, time_fn=clock)
    try:
        q.enqueue("a", lambda k: runs.append((k, clock())))
        q.enqueue("b", lambda k: runs.append((k, clock())))
        deadline = time.monotonic() + DRAIN_S
        while not runs and time.monotonic() < deadline:
            time.sleep(0.001)
        first = list(runs)
        clock.now += 0.5
        assert q.wait_idle(DRAIN_S)
    finally:
        q.shutdown()
    assert first == [("a", 1000.0)]
    assert runs[1][0] == "b" and runs[1][1] >= 1000.5
    assert pt_wq.PREP_UNPREP_LIMITER == pt_wq.RateLimiter(
        **jax_wq.PREP_UNPREP_LIMITER.__dict__)


def test_workqueue_families_on_the_scheduler_registry():
    def run(m, side):
        sm = m.metrics.SchedulerMetrics()
        with EventRun(m, nodes(1), workers=2, sched_metrics=sm) as r:
            r.step(lambda f: make_claim(f, "c1"))
        text = m.text(sm.registry)
        return sorted(name for name in (
            'tpu_dra_workqueue_depth{shard=',
            "tpu_dra_workqueue_wait_seconds_count",
            "tpu_dra_workqueue_retries_total",
            "tpu_dra_workqueue_hot_backoff_total",
            "tpu_dra_workqueue_steals_total",
            "tpu_dra_workqueue_drops_total",
            "tpu_dra_sched_snapshot_build_seconds",
            "tpu_dra_sched_commit_conflicts_total") if name in text)
    assert len(both(run)) == 8
