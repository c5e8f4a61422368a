"""The port's streamed watch, its informer and the PartitionSet CRD
watcher against the JAX package's.

``KubeClient.watch`` runs against the port's ``FakeApiServer`` over real
HTTP: its events, a resume from a resourceVersion (the server replays
the writes after it), a 410 Gone that ends in ``on_gap`` and a relist,
and a stop that returns at once with its thread joined; the JAX client
over the same server sees the same events. The informer lists, follows
and relists over HTTP and over the in-memory fake. Then the JAX node
seam (``tests/test_autoscale.py:672-830``), scenario by scenario: the
JAX ``Driver`` on ``v5e-4`` over its in-memory fake, and the port's on
``h100-4`` with MIG on, over its in-memory fake and over HTTP, converge
on the same partition devices after every CRD write; plus the port's
fail-closed refusal of a MIG profile a host without MIG cannot place,
and the cost in writes of a converged re-apply.

Every wait is bounded and ends on an event (a watcher's reconcile, an
informer's relist, a callback); every thread started here is joined.
"""

import threading
import time

import pytest

from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
from k8s_dra_driver_gpu_tpu.kubeletplugin import driver as jax_driver
from k8s_dra_driver_gpu_tpu.kubeletplugin.deviceinfo import \
    DeviceKind as JaxKind
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg.autoscale import crd as jax_crd
from k8s_dra_driver_gpu_tpu.pkg.partition import PartitionSet as JaxSet
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import driver as pt_driver
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.deviceinfo import DeviceKind
from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
from k8s_dra_driver_gpu_tpu_torch.pkg.informer import Informer
from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import (FakeKubeClient,
                                                         KubeClient)
from k8s_dra_driver_gpu_tpu_torch.pkg.partition import PartitionSet
from k8s_dra_driver_gpu_tpu_torch.pkg.autoscale import crd as pt_crd
from k8s_dra_driver_gpu_tpu_torch.pkg.partition import watch as pt_watch

CRD = ("resource.tpu.dra", "v1beta1", "partitionsets")
RES = ("resource.k8s.io", "v1", "resourceslices")
GATES = ("DynamicSubSlice=true,TimeSlicingSettings=true,"
         "MultiTenancySupport=true,TenantPartitioning=true")
WAIT = 10.0


@pytest.fixture()
def server():
    srv = FakeApiServer(keepalive=0.2).start()
    yield srv
    srv.stop()


@pytest.fixture(autouse=True)
def no_thread_left():
    before = set(threading.enumerate())
    yield
    left = [t for t in threading.enumerate()
            if t not in before and t.is_alive()]
    assert left == [], f"threads left running: {left}"


class Events:
    """A watch callback recording events; ``wait(n)`` blocks until n
    have come."""

    def __init__(self):
        self.seen: list[tuple[str, str]] = []
        self._cond = threading.Condition()

    def __call__(self, ev_type: str, obj: dict) -> None:
        with self._cond:
            self.seen.append((ev_type, obj["metadata"]["name"]))
            self._cond.notify_all()

    def wait(self, n: int) -> list[tuple[str, str]]:
        with self._cond:
            assert self._cond.wait_for(lambda: len(self.seen) >= n, WAIT), \
                self.seen
            return list(self.seen)


def _obj(name, **spec):
    return {"metadata": {"name": name}, "spec": spec}


# -- KubeClient.watch over HTTP -----------------------------------------------


def test_watch_streams_events_in_order(server):
    client = KubeClient(host=server.url)
    got = Events()
    w = client.watch(*CRD, got, reconnect_delay=0.05,
                     resource_version=client.list_with_version(*CRD)[1])
    try:
        client.create(*CRD, _obj("a", x=1))
        client.patch(*CRD, "a", {"spec": {"x": 2}})
        client.create(*CRD, _obj("b"))
        client.delete(*CRD, "a")
        # Another resource's writes are not this watch's.
        client.create(*RES, _obj("s"))
        assert got.wait(4) == [("ADDED", "a"), ("MODIFIED", "a"),
                               ("ADDED", "b"), ("DELETED", "a")]
    finally:
        w.stop()
    assert not w.alive()


def test_the_jax_client_sees_the_same_events(server):
    stop = threading.Event()
    jax_got, pt_got = Events(), Events()
    client = KubeClient(host=server.url)
    rv = client.list_with_version(*CRD)[1]
    w = client.watch(*CRD, pt_got, resource_version=rv)
    jax_thread = jax_kube.KubeClient(host=server.url).watch(
        *CRD, jax_got, stop=stop, reconnect_delay=0.05)
    try:
        # The JAX client watches from now: wait until its stream is up.
        assert server.store.wait_for_streams(2, WAIT)
        for i in range(3):
            client.create(*CRD, _obj(f"o{i}"))
        client.delete(*CRD, "o1")
        assert jax_got.wait(4) == pt_got.wait(4)
    finally:
        stop.set()
        w.stop()
        server.close_watches()
        jax_thread.join(WAIT)


def test_watch_resumes_from_a_resource_version(server):
    client = KubeClient(host=server.url)
    client.create(*CRD, _obj("a"))
    _, after_a = client.list_with_version(*CRD)
    client.create(*CRD, _obj("b"))
    client.patch(*CRD, "b", {"spec": {"y": 1}})
    got = Events()
    w = client.watch(*CRD, got, resource_version=after_a,
                     reconnect_delay=0.05)
    try:
        # The writes after ``after_a`` are replayed, not "a".
        assert got.wait(2) == [("ADDED", "b"), ("MODIFIED", "b")]
        # The server drops every stream: the client resumes from what it
        # saw, and what was written meanwhile still comes, once.
        server.close_watches(hold=True)
        client.create(*CRD, _obj("c"))
        client.delete(*CRD, "a")
        server.release_watches()
        assert got.wait(4)[2:] == [("ADDED", "c"), ("DELETED", "a")]
        client.create(*CRD, _obj("d"))
        assert got.wait(5)[4:] == [("ADDED", "d")]
    finally:
        w.stop()
    assert server.requests["GET"] >= 3  # the list and two watches


def test_a_410_calls_on_gap_and_the_watch_goes_on():
    srv = FakeApiServer(store=FakeKubeClient(event_log=2),
                        keepalive=0.2).start()
    gap = threading.Event()
    got = Events()
    try:
        client = KubeClient(host=srv.url)
        for i in range(5):
            client.create(*CRD, _obj(f"o{i}"))
        # Write 1 fell out of the two-write log: 410 Gone.
        w = client.watch(*CRD, got, resource_version="1",
                         reconnect_delay=0.05, on_gap=gap.set)
        try:
            assert gap.wait(WAIT)
            # From now on (once the stream is up again): the next write.
            assert srv.store.wait_for_streams(1, WAIT)
            client.create(*CRD, _obj("late"))
            assert got.wait(1) == [("ADDED", "late")]
        finally:
            w.stop()
    finally:
        srv.stop()


def test_stop_returns_at_once_and_joins(server):
    client = KubeClient(host=server.url)
    w = client.watch(*CRD, Events())
    assert server.store.wait_for_streams(1, WAIT)
    t0 = time.monotonic()
    w.stop()
    assert time.monotonic() - t0 < 1.0
    assert not w.alive()


# -- the informer -------------------------------------------------------------


def test_informer_lists_follows_and_relists_over_http():
    srv = FakeApiServer(store=FakeKubeClient(event_log=2),
                        keepalive=0.2).start()
    relisted = threading.Condition()
    got = Events()

    def relists_past(n):
        with relisted:
            return relisted.wait_for(lambda: inf.relist_total > n, WAIT)
    try:
        client = KubeClient(host=srv.url)
        client.create(*CRD, _obj("a"))
        inf = Informer(client, *CRD, resync_period=0.5,
                       reconnect_delay=0.05)
        relist = inf.relist

        def notified_relist():
            version = relist()
            with relisted:
                relisted.notify_all()
            return version
        inf.relist = notified_relist
        inf.add_event_hook(got)
        inf.start()
        try:
            assert inf.wait_for_sync(WAIT)
            assert inf.relist_total >= 1  # the first list
            assert got.wait(1) == [("ADDED", "a")]
            assert inf.get("a")["spec"] == {}
            client.create(*CRD, _obj("b", x=1))
            assert got.wait(2)[1] == ("ADDED", "b")
            assert sorted(o["metadata"]["name"] for o in inf.list()) == \
                ["a", "b"]
            # A gap: writes pass while no one watches, past the log.
            srv.close_watches(hold=True)
            client.delete(*CRD, "a")
            for i in range(3):
                client.create(*CRD, _obj(f"g{i}"))
            srv.release_watches()
            # The 410 relists; the relist's differences are events.
            seen = got.wait(6)
            assert set(seen[2:]) == {("DELETED", "a"), ("ADDED", "g0"),
                                     ("ADDED", "g1"), ("ADDED", "g2")}
            assert inf.get("a") is None
            # The periodic resync relists too (and finds nothing new).
            assert relists_past(inf.relist_total)
            assert len(got.seen) == 6
        finally:
            inf.stop()
    finally:
        srv.stop()


def test_the_watch_resumes_from_the_gap_relist():
    """After a 410 the watch resumes from the relist's resourceVersion: a
    write made between the relist and the reconnect still comes, with no
    resync (an hour away) to find it."""
    srv = FakeApiServer(store=FakeKubeClient(event_log=2),
                        keepalive=0.2).start()
    got = Events()
    try:
        client = KubeClient(host=srv.url)
        client.create(*CRD, _obj("a"))
        inf = Informer(client, *CRD, resync_period=3600.0,
                       reconnect_delay=0.05)
        relist = inf.relist
        write_after_relist = threading.Event()

        def relist_then_write():
            version = relist()
            if write_after_relist.is_set():
                write_after_relist.clear()
                client.create(*CRD, _obj("late"))
            return version
        inf.relist = relist_then_write
        inf.add_event_hook(got)
        inf.start()
        try:
            assert inf.wait_for_sync(WAIT)
            assert got.wait(1) == [("ADDED", "a")]
            # Writes past the two-write log while no stream is up: 410.
            srv.close_watches(hold=True)
            for i in range(3):
                client.create(*CRD, _obj(f"g{i}"))
            write_after_relist.set()
            srv.release_watches()
            seen = got.wait(5)
            assert set(seen[1:4]) == {("ADDED", "g0"), ("ADDED", "g1"),
                                      ("ADDED", "g2")}
            assert seen[4:] == [("ADDED", "late")]
            assert inf.relist_total == 2 and inf.get("late") is not None
        finally:
            inf.stop()
    finally:
        srv.stop()


def test_informer_over_the_in_memory_fake():
    kube = FakeKubeClient()
    kube.create(*CRD, _obj("a"))
    got = Events()
    inf = Informer(kube, *CRD)
    inf.add_event_hook(got)
    inf.start()
    try:
        assert inf.wait_for_sync(0)
        kube.create(*CRD, _obj("b"))
        kube.update(*CRD, "a", _obj("a", x=1))
        kube.create(*RES, _obj("other"))
        kube.delete(*CRD, "b")
        assert got.seen == [("ADDED", "a"), ("ADDED", "b"),
                            ("MODIFIED", "a"), ("DELETED", "b")]
        assert inf.get("a")["spec"] == {"x": 1}
    finally:
        inf.stop()
    kube.create(*CRD, _obj("after-stop"))
    assert len(got.seen) == 4


# -- the node seam, as the JAX plugin's ---------------------------------------

SUBSLICE = {"jax": "1x1", "pt": "7g.80gb"}


def crd(side, slots=8, name="tpu-dra-autoscale", revision=1, prof=None):
    spec = {"profiles": [{"name": prof or f"web-s{slots}",
                          "subslice": SUBSLICE[side],
                          "maxTenants": slots}]}
    if side == "jax":
        return jax_crd.crd_object(name, JaxSet.from_dict(spec),
                                  revision=revision)
    return pt_crd.crd_object(name, PartitionSet.from_dict(spec),
                             revision=revision)


MALFORMED = {"apiVersion": "resource.tpu.dra/v1beta1",
             "kind": "PartitionSet", "metadata": {"name": "tpu-dra-autoscale"},
             "spec": {"profiles": [{"name": "BAD NAME", "subslice": "nope"}]}}


class Node:
    """One plugin's Driver over one kube surface: ``jax`` (its in-memory
    fake), ``pt`` (the port's in-memory fake) or ``http`` (the port's
    KubeClient over a FakeApiServer)."""

    def __init__(self, wiring, root, bootstrap=None):
        self.wiring = wiring
        self.side = "jax" if wiring == "jax" else "pt"
        self.root = root
        self.bootstrap = bootstrap
        self.server = None
        if wiring == "jax":
            self.kube = jax_kube.FakeKubeClient()
        elif wiring == "pt":
            self.kube = FakeKubeClient()
        else:
            self.server = FakeApiServer(keepalive=0.2).start()
            self.kube = KubeClient(host=self.server.url)
        self.driver = None

    def config(self):
        if self.side == "jax":
            ps = JaxSet.from_dict(self.bootstrap or {})
            cfg = jax_ds.Config.mock(root=self.root, gates=GATES,
                                     partition_set=ps)
        else:
            ps = PartitionSet.from_dict(self.bootstrap or {})
            cfg = pt_ds.Config.mock(self.root, "h100-4", GATES,
                                    mig_mode="enabled", partition_set=ps)
        cfg.pool_name = "node-0"
        return cfg

    def start(self):
        mod = jax_driver if self.side == "jax" else pt_driver
        self.driver = mod.Driver(self.config(), self.kube, "node-0",
                                 enable_health_monitor=False)
        self.driver.start()
        return self

    def stop(self):
        if self.driver is not None:
            self.driver.stop()
            self.driver = None

    def close(self):
        self.stop()
        if self.server is not None:
            self.server.stop()

    def write(self, verb, *args):
        """A CRD write through the store the driver watches."""
        store = self.server.store if self.server else self.kube
        getattr(store, verb)(*CRD, *args)

    def devices(self):
        kind = JaxKind.PARTITION if self.side == "jax" \
            else DeviceKind.PARTITION
        return sorted(n for n, d in self.driver.state.allocatable.items()
                      if d.kind == kind)

    def published(self):
        store = self.server.store if self.server else self.kube
        return sorted(d["name"] for s in store.list(*RES)
                      for d in s["spec"]["devices"]
                      if d["name"].startswith("pt-"))

    def wait(self, predicate) -> bool:
        """Wait (on the watcher's reconciles) until ``predicate()``; over
        the in-memory fakes a write has reconciled when it returns."""
        watcher = self.driver.partition_watcher
        if self.wiring == "http" and watcher is not None:
            return watcher.wait_for(predicate, WAIT)
        return predicate()

    def settle(self, want):
        self.wait(lambda: self.devices() == want
                  and self.published() == want)
        return self.devices()


@pytest.fixture()
def nodes(tmp_path):
    made = []

    def make(bootstrap=None):
        trio = {w: Node(w, str(tmp_path / f"{w}{len(made)}"), bootstrap)
                for w in ("jax", "pt", "http")}
        made.extend(trio.values())
        return trio
    yield make
    for node in made:
        node.close()


def converge(trio, verb=None, *args):
    """One step on every wiring (the JAX one first); the partition
    devices after it, the same on all."""
    if verb is not None:
        for node in trio.values():
            node.write(verb, *[a(node.side) if callable(a) else a
                               for a in args])
    want, slices = trio["jax"].devices(), trio["jax"].published()
    for wiring in ("pt", "http"):
        node = trio[wiring]
        # The devices swap before their republish ends: wait for both.
        node.wait(lambda: node.devices() == want
                  and node.published() == slices)
        assert node.devices() == want, wiring
        assert node.published() == slices, wiring
    return want


def test_live_driver_converges_on_crd_update(nodes):
    trio = nodes()
    for node in trio.values():
        node.start()
    assert converge(trio) == []
    assert converge(trio, "create", lambda s: crd(s, 8)) == [
        f"pt-web-s8-{k}" for k in range(4)]
    assert "pt-web-s8-0" in trio["http"].published()
    assert converge(trio, "update", "tpu-dra-autoscale",
                    lambda s: crd(s, 4, revision=2)) == [
        f"pt-web-s4-{k}" for k in range(4)]


def test_restarted_driver_converges_to_the_same_set(nodes):
    trio = nodes()
    for node in trio.values():
        node.write("create", crd(node.side, 8))
        node.start()
    live = converge(trio)
    assert live
    slices = {w: n.published() for w, n in trio.items()}
    for node in trio.values():
        node.stop()
        node.start()
    assert converge(trio) == live
    assert {w: n.published() for w, n in trio.items()} == slices


def test_a_malformed_crd_keeps_the_last_good_plan(nodes):
    trio = nodes()
    for node in trio.values():
        node.write("create", crd(node.side, 8))
        node.start()
    good = converge(trio)
    for node in trio.values():
        node.write("update", "tpu-dra-autoscale", MALFORMED)
    for node in trio.values():
        watcher = node.driver.partition_watcher
        assert node.wait(lambda: watcher.failed_total >= 1)
        assert node.devices() == good
        assert watcher.last_error and watcher.failed_total >= 1
    assert converge(trio, "update", "tpu-dra-autoscale",
                    lambda s: crd(s, 4, revision=3)) == [
        f"pt-web-s4-{k}" for k in range(4)]
    for node in trio.values():
        assert node.driver.partition_watcher.last_error is None


def test_the_failure_counter_dedupes_and_a_revert_clears_it(nodes):
    trio = nodes()
    for node in trio.values():
        node.write("create", crd(node.side, 8))
        node.start()
    good = converge(trio)
    for node in trio.values():
        watcher = node.driver.partition_watcher
        node.write("update", "tpu-dra-autoscale", MALFORMED)
        assert node.wait(lambda: watcher.failed_total == 1)
        for _ in range(3):
            watcher.reconcile()
        assert watcher.failed_total == 1
        node.write("update", "tpu-dra-autoscale", crd(node.side, 8))
        assert node.wait(lambda: watcher.last_error is None)
        assert node.devices() == good


def test_a_crd_delete_reverts_to_the_bootstrap(nodes):
    boot = {"jax": {"profiles": [{"name": "boot-s2", "subslice": "1x1",
                                  "maxTenants": 2}]},
            "pt": {"profiles": [{"name": "boot-s2", "subslice": "7g.80gb",
                                 "maxTenants": 2}]}}
    trio = nodes()
    for node in trio.values():
        node.bootstrap = boot[node.side]
        node.start()
    assert converge(trio) == [f"pt-boot-s2-{k}" for k in range(4)]
    assert converge(trio, "create", lambda s: crd(s, 8)) == [
        f"pt-web-s8-{k}" for k in range(4)]
    assert converge(trio, "delete", "tpu-dra-autoscale") == [
        f"pt-boot-s2-{k}" for k in range(4)]


def test_the_watch_opt_out_keeps_the_bootstrap(nodes, monkeypatch):
    monkeypatch.setenv("TPU_DRA_PARTITION_WATCH", "0")
    trio = nodes()
    for node in trio.values():
        node.write("create", crd(node.side, 8))
        node.start()
        assert node.driver.partition_watcher is None
        assert node.devices() == []


def _writes(server) -> int:
    return sum(server.requests[m] for m in ("POST", "PUT", "PATCH",
                                            "DELETE"))


def test_a_converged_reapply_writes_nothing_over_http(tmp_path):
    node = Node("http", str(tmp_path / "n"))
    try:
        node.start()
        node.write("create", crd("pt", 8))
        assert node.settle([f"pt-web-s8-{k}" for k in range(4)])
        watcher = node.driver.partition_watcher
        before, applied = _writes(node.server), watcher.applied_total
        # The same spec under a new revision annotation: no re-apply; a
        # direct re-apply of the same plan: a publish of no write.
        node.write("update", "tpu-dra-autoscale", crd("pt", 8, revision=2))
        n = watcher.reconciles
        assert watcher.wait_for(lambda: watcher.reconciles > n, WAIT)
        stats = node.driver.apply_partition_set(
            pt_crd.partition_set_from_crd(crd("pt", 8))[0])
        assert stats["writes"] == 0
        assert watcher.applied_total == applied
        assert _writes(node.server) == before
    finally:
        node.close()


def test_mig_off_fails_closed_with_no_write(tmp_path):
    """The card's case: MIG off, a bootstrap set for other pools, and a
    CRD for this pool naming 1g.10gb."""
    srv = FakeApiServer(keepalive=0.2).start()
    try:
        cfg = pt_ds.Config.mock(str(tmp_path / "n"), "h100-1", GATES,
                                partition_set=PartitionSet.from_dict({
                                    "profiles": [{"name": "s2",
                                                  "subslice": "1g.10gb",
                                                  "maxTenants": 2}],
                                    "pools": ["no-such-pool-*"]}))
        cfg.pool_name = "node-0"
        drv = pt_driver.Driver(cfg, KubeClient(host=srv.url), "node-0",
                               enable_health_monitor=False)
        drv.start()
        try:
            watcher = drv.partition_watcher
            before = _writes(srv)
            srv.store.create(*CRD, pt_crd.crd_object(
                "tpu-dra-autoscale", PartitionSet.from_dict({"profiles": [
                    {"name": "s2", "subslice": "1g.10gb", "maxTenants": 2,
                     "hbmFraction": 0.9}]})))
            assert watcher.wait_for(lambda: watcher.failed_total == 1, WAIT)
            assert "'1g.10gb' is no carve-out of this host" in \
                watcher.last_error
            srv.store.delete(*CRD, "tpu-dra-autoscale")
            assert watcher.wait_for(lambda: watcher.last_error is None, WAIT)
            assert watcher.failed_total == 1 and watcher.applied_total == 0
            assert _writes(srv) == before
            assert not any(d.kind == DeviceKind.PARTITION
                           for d in drv.state.allocatable.values())
        finally:
            drv.stop()
    finally:
        srv.stop()


# -- the CRD helpers, as the JAX ones -----------------------------------------


@pytest.mark.parametrize("objs, pool", [
    ([], "node-0"),
    ([{"metadata": {"name": "b"}, "spec": {"pools": ["node-*"]}},
      {"metadata": {"name": "a"}, "spec": {"pools": ["other"]}}], "node-0"),
    ([{"metadata": {"name": "b"}, "spec": {}},
      {"metadata": {"name": "00-manual"}, "spec": {"profiles": [
          {"name": "BAD NAME"}]}}], "node-0"),
    ([{"metadata": {"name": "r"}, "spec": {"priorityRules": "no"}}], "n"),
    ([{"metadata": {"name": "r"}, "spec": {"priorityRules": [
        {"selector": "tenant.cores > 1", "priority": "x"}]}}], "n"),
], ids=["none", "glob", "malformed winner", "rules not a list",
        "priority not an int"])
def test_select_for_pool_as_the_reference(objs, pool):
    got = pt_crd.select_for_pool(objs, pool)
    want = jax_crd.select_for_pool(objs, pool)
    assert got[0] == want[0]
    assert got[2] == want[2]
    if got[0] == "ok":
        assert got[1][2] == want[1][2]  # the fingerprint


def test_a_spec_that_is_no_object_is_malformed():
    # (The JAX selection raises on it: it reads ``spec.pools`` first.)
    obj = {"metadata": {"name": "x"}, "spec": "not a dict"}
    assert pt_crd.select_for_pool([obj], "node-0")[0] == "malformed"


@pytest.mark.parametrize("raw", [
    None, "", "not json", '["a"]', '{"node-*": {"serv": 2}}',
    '{"node-*": {"serv": 2, "x": "bad"}, "node-0": {"serv": 3}}',
    '{"other": {"serv": 2}}', '{"node-*": "bad"}'])
def test_prewarm_hints_as_the_reference(raw):
    obj = {"metadata": {"annotations": {} if raw is None else {
        pt_crd.PREWARM_ANNOTATION: raw}}}
    assert pt_crd.prewarm_hints_of(obj, "node-0") == \
        jax_crd.prewarm_hints_of(obj, "node-0")
    assert pt_crd.PREWARM_ANNOTATION == jax_crd.PREWARM_ANNOTATION


def test_the_crd_keys_are_the_jax_ones():
    assert (pt_crd.AUTOSCALE_CRD_GROUP, pt_crd.AUTOSCALE_CRD_VERSION,
            pt_crd.AUTOSCALE_CRD_RESOURCE, pt_crd.AUTOSCALE_CRD_KIND) == (
        jax_crd.AUTOSCALE_CRD_GROUP, jax_crd.AUTOSCALE_CRD_VERSION,
        jax_crd.AUTOSCALE_CRD_RESOURCE, jax_crd.AUTOSCALE_CRD_KIND)
    spec = {"profiles": [{"name": "a", "subslice": "1x1"}], "pools": []}
    assert pt_crd.fingerprint(spec) == jax_crd.fingerprint(spec)


def test_a_transient_apply_failure_is_retried():
    """An apply that fails for another reason than the plan (the node
    lock's time limit, a refused republish) is not memoized: the next
    reconcile applies the plan again."""
    kube = FakeKubeClient()
    calls = []

    def apply_fn(plan):
        calls.append(plan)
        if len(calls) == 1:
            raise TimeoutError("node lock")
    watcher = pt_watch.PartitionSetWatcher(kube, "node-0", apply_fn,
                                           bootstrap=PartitionSet())
    watcher.start()
    try:
        kube.create(*CRD, crd("pt", 8))
        assert len(calls) == 1 and watcher.applied_total == 0
        assert watcher.last_error is None and watcher.failed_total == 0
        assert watcher.reconcile() is True
        assert len(calls) == 2 and watcher.applied_total == 1
        assert watcher.reconcile() is False and len(calls) == 2
    finally:
        watcher.stop()


def test_the_prewarm_hint_reaches_the_engine_as_the_jax_one(nodes):
    """The winning CRD's pre-warm annotation warms instances on the
    node; a CRD without it releases them to the sweep."""
    trio = nodes()
    hint = {"node-*": {"web-s8": 2}}
    for node in trio.values():
        node.start()
    for node in trio.values():
        obj = crd(node.side, 8)
        obj["metadata"]["annotations"][pt_crd.PREWARM_ANNOTATION] = \
            pt_crd.prewarm_value(hint)
        node.write("create", obj)
    want = [f"pt-web-s8-{k}" for k in range(4)]
    for node in trio.values():
        engine = node.driver.state.partition_engine
        assert node.wait(lambda: engine.active_partitions() == 2)
        assert node.devices() == want
        assert engine.prewarm_state()[0] == {"pt-web-s8-0", "pt-web-s8-1"}
    for node in trio.values():
        node.write("update", "tpu-dra-autoscale",
                   crd(node.side, 8, revision=2))
    for node in trio.values():
        engine = node.driver.state.partition_engine
        assert node.wait(lambda: engine.prewarm_state()[0] == set())
        assert engine.reap_idle() == 2 and engine.active_partitions() == 0
