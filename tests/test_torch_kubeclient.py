"""The port's kube client and fake API server against the JAX package's.

Each scenario is a script of API calls. Its transcript (every object
returned, with its uid and resourceVersion, and the class of every
error) is taken on the JAX package's in-memory ``FakeKubeClient``, then
over HTTP in all four wirings: each package's ``KubeClient`` against
each package's ``FakeApiServer``. All must equal. Then the port's
in-memory fake against the JAX one, the client's connection setup, the
server's own surface, and that no thread outlives a server.
"""

import copy
import threading
import urllib.error
import urllib.request

import pytest

from k8s_dra_driver_gpu_tpu.pkg import fakeapiserver as jax_server
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import fakeapiserver as pt_server
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube

RC = ("resource.k8s.io", "v1", "resourceclaims")
RS = ("resource.k8s.io", "v1", "resourceslices")
PODS = ("", "v1", "pods")
NODES = ("", "v1", "nodes")
PACKAGES = {"pt": (pt_kube, pt_server), "jax": (jax_kube, jax_server)}


def _claim(name, labels=None, **spec):
    return {"metadata": {"name": name, "labels": labels or {}},
            "spec": spec}


def _slice(name, driver, node, devices=()):
    return {"metadata": {"name": name},
            "spec": {"driver": driver, "nodeName": node,
                     "pool": {"name": node, "generation": 1},
                     "devices": [{"name": d} for d in devices]}}


def _crud(k, out):
    out(k.create(*RC, _claim("a", x=1), namespace="ns1"))
    out(k.get(*RC, "a", namespace="ns1"))
    out(k.create(*RC, _claim("a"), namespace="ns1"))  # 409
    out(k.create(*RC, _claim("a"), namespace="ns2"))  # another namespace
    obj = k.get(*RC, "a", namespace="ns1")
    obj["spec"]["x"] = 2
    out(k.update(*RC, "a", obj, namespace="ns1"))
    out(k.update(*RC, "a", obj, namespace="ns1"))  # stale rv: 409
    del obj["metadata"]["resourceVersion"]
    out(k.update(*RC, "a", obj, namespace="ns1"))  # rv-less: last wins
    out(k.update(*RC, "zz", obj, namespace="ns1"))  # 404
    out(k.get(*RC, "zz", namespace="ns1"))  # 404
    out(k.delete(*RC, "a", namespace="ns1"))
    out(k.delete(*RC, "a", namespace="ns1"))  # absent: not an error
    out(k.get(*RC, "a", namespace="ns1"))  # 404
    out(k.list(*RC))


def _label_selectors(k, out):
    for i, (app, tier) in enumerate([("web", "a"), ("web", "b"),
                                     ("db", "a"), ("db", "b")]):
        out(k.create(*RC, _claim(f"c{i}", {"app": app, "tier": tier}),
                     namespace="ns1" if i % 2 else "ns2"))
    for sel in ("app=web", "app=db,tier=b", "tier=a", "app=none", None):
        out(k.list(*RC, label_selector=sel))
        out(k.list(*RC, namespace="ns1", label_selector=sel))


def _field_selectors(k, out):
    for i, (drv, node) in enumerate([("d1", "n1"), ("d1", "n2"),
                                     ("d2", "n1"), ("d1", "n1")]):
        out(k.create(*RS, _slice(f"s{i}", drv, node, [f"dev-{i}"])))
    for sel in ("spec.driver=d1", "spec.driver=d1,spec.nodeName=n1",
                "spec.nodeName=n2", "spec.driver=d9",
                "spec.pool.name=n1", "metadata.name=s2"):
        out(k.list(*RS, field_selector=sel))
    out(k.list(*RS, label_selector="a=b", field_selector="spec.driver=d1"))


def _merge_patch(k, out):
    out(k.create(*RC, {"metadata": {"name": "p", "labels": {"a": "1"}},
                       "spec": {"keep": 1, "drop": 2,
                                "nested": {"x": 1, "y": 2}}},
                 namespace="ns"))
    out(k.patch(*RC, "p", {"spec": {"drop": None, "nested": {"y": 3},
                                    "new": [1, 2]}}, namespace="ns"))
    out(k.patch(*RC, "p", {"status": {"conditions": [
        {"type": "PermanentFailure", "status": "True"}]}}, namespace="ns"))
    out(k.patch(*RC, "p", {"metadata": {"labels": {"a": None, "b": "2"}}},
                namespace="ns"))
    out(k.patch(*RC, "p", {"metadata": {"resourceVersion": "1"},
                           "spec": {"keep": 9}}, namespace="ns"))  # 409
    rv = k.get(*RC, "p", namespace="ns")["metadata"]["resourceVersion"]
    out(k.patch(*RC, "p", {"metadata": {"resourceVersion": rv},
                           "spec": {"keep": 9}}, namespace="ns"))
    out(k.patch(*RC, "nope", {"spec": {}}, namespace="ns"))  # 404
    out(k.get(*RC, "p", namespace="ns"))


def _cluster_and_core(k, out):
    out(k.create(*NODES, {"metadata": {"name": "n1",
                                       "labels": {"zone": "z"}}}))
    out(k.create(*PODS, {"metadata": {"name": "pod", "annotations": {
        "a": "b"}}}, namespace="ns"))
    out(k.get(*NODES, "n1"))
    out(k.list(*NODES, label_selector="zone=z"))
    out(k.list(*PODS))
    out(k.get(*PODS, "missing", namespace="ns"))  # 404
    out(k.server_version())


def _namespace_cascade(k, out):
    out(k.create(*("", "v1", "namespaces"), {"metadata": {"name": "ns"}}))
    out(k.create(*RC, _claim("a"), namespace="ns"))
    out(k.create(*RC, _claim("b"), namespace="other"))
    out(k.delete(*("", "v1", "namespaces"), "ns"))
    out(k.list(*RC))


def _uids_and_versions(k, out):
    for i in range(3):
        out(k.create(*RC, {"metadata": {"name": f"u{i}",
                                        "uid": "given" if i == 1 else ""}},
                     namespace="ns"))
    for _ in range(3):
        obj = k.get(*RC, "u0", namespace="ns")
        out(k.update(*RC, "u0", obj, namespace="ns"))
    out(k.patch(*RC, "u0", {"metadata": {"annotations": {"k": "v"}}},
                namespace="ns"))


SCENARIOS = {"crud": _crud, "label_selectors": _label_selectors,
             "field_selectors": _field_selectors,
             "merge_patch": _merge_patch,
             "cluster_and_core": _cluster_and_core,
             "namespace_cascade": _namespace_cascade,
             "uids_and_versions": _uids_and_versions}


def transcript(client, scenario) -> list:
    """Each call's result, or the class name and status of its error."""
    record = []

    class Recorder:
        def __getattr__(self, verb):
            def call(*a, **kw):
                try:
                    record.append(("ok", copy.deepcopy(
                        getattr(client, verb)(*a, **kw))))
                except Exception as e:  # noqa: BLE001 - the class is data
                    record.append((type(e).__name__,
                                   getattr(e, "status", None)))
                    return {"metadata": {}, "spec": {}}
                return copy.deepcopy(record[-1][1])
            return call

    rec = Recorder()
    SCENARIOS[scenario](rec, lambda _value: None)
    return record


def _reference(scenario):
    return transcript(jax_kube.FakeKubeClient(), scenario)


@pytest.fixture(scope="module")
def servers():
    """One server of each package for the module; each test empties its
    store (and its uid counter) first."""
    running = {side: mod.FakeApiServer().start()
               for side, (_, mod) in PACKAGES.items()}
    yield running
    for server in running.values():
        server.stop()


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("client_side,server_side",
                         [("pt", "jax"), ("jax", "pt"), ("pt", "pt"),
                          ("jax", "jax")])
def test_client_over_http_gives_the_in_memory_transcript(
        servers, scenario, client_side, server_side):
    server = servers[server_side]
    with server.store._lock:
        server.store._store.clear()
        server.store._uid = 0
    client = PACKAGES[client_side][0].KubeClient(host=server.url)
    assert transcript(client, scenario) == _reference(scenario)


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_port_fake_equals_the_jax_fake(scenario):
    assert transcript(pt_kube.FakeKubeClient(), scenario) == \
        _reference(scenario)


def test_error_classes_and_statuses():
    assert issubclass(pt_kube.NotFoundError, pt_kube.KubeError)
    assert issubclass(pt_kube.ConflictError, pt_kube.KubeError)
    for mod in (pt_kube, jax_kube):
        assert mod.NotFoundError().status == 404
        assert mod.ConflictError().status == 409
        assert str(mod.KubeError(500, "x")) == "500: x"


@pytest.mark.parametrize("args", [
    ("resource.k8s.io", "v1", "resourceclaims", "ns", "c"),
    ("resource.k8s.io", "v1", "resourceslices", None, None),
    ("", "v1", "pods", "ns", None), ("", "v1", "nodes", None, "n1"),
    ("", "v1", "namespaces", None, "ns")])
def test_resource_path_equals_the_references(args):
    assert pt_kube._resource_path(*args) == jax_kube._resource_path(*args)


def _client_setup(mod, monkeypatch, tmp_path, env, token=None):
    for var in ("KUBE_API", "KUBERNETES_SERVICE_HOST",
                "KUBERNETES_SERVICE_PORT"):
        monkeypatch.delenv(var, raising=False)
    for var, value in env.items():
        monkeypatch.setenv(var, value)
    sa = tmp_path / mod.__name__
    sa.mkdir()
    if token is not None:
        (sa / "token").write_text(token + "\n")
    monkeypatch.setattr(mod, "SERVICE_ACCOUNT_DIR", str(sa))
    try:
        client = mod.KubeClient()
    except mod.KubeError as e:
        return ("KubeError", e.status)
    return (client._host, client._token, client._ssl is not None)


@pytest.mark.parametrize("env,token", [
    ({"KUBE_API": "http://127.0.0.1:1/"}, None),
    ({"KUBE_API": "http://127.0.0.1:1"}, "tok"),
    ({"KUBERNETES_SERVICE_HOST": "10.0.0.1"}, "tok"),
    ({"KUBERNETES_SERVICE_HOST": "10.0.0.1",
      "KUBERNETES_SERVICE_PORT": "6443"}, None),
    ({"KUBE_API": "http://a:1", "KUBERNETES_SERVICE_HOST": "b"}, None),
    ({}, None)])
def test_connection_setup_equals_the_references(monkeypatch, tmp_path, env,
                                                token):
    got = _client_setup(pt_kube, monkeypatch, tmp_path, env, token)
    want = _client_setup(jax_kube, monkeypatch, tmp_path, env, token)
    assert got == want


def test_token_is_sent_as_bearer():
    seen = []
    server = pt_server.FakeApiServer().start()
    try:
        handler = server._httpd.RequestHandlerClass
        original = handler.do_GET

        def spy(self):
            seen.append(self.headers.get("Authorization"))
            return original(self)

        handler.do_GET = spy
        try:
            pt_kube.KubeClient(host=server.url, token="t0k").server_version()
        finally:
            handler.do_GET = original
    finally:
        server.stop()
    assert seen == ["Bearer t0k"]


def test_server_counts_requests_and_refuses_what_it_does_not_serve():
    server = pt_server.FakeApiServer().start()
    try:
        client = pt_kube.KubeClient(host=server.url)
        client.create(*RC, _claim("a"), namespace="ns")
        client.get(*RC, "a", namespace="ns")
        client.patch(*RC, "a", {"spec": {"x": 1}}, namespace="ns")
        client.delete(*RC, "a", namespace="ns")
        client.delete(*RC, "a", namespace="ns")
        assert server.requests == {"POST": 1, "GET": 1, "PATCH": 1,
                                   "DELETE": 2}
        assert server.request_count() == 5
        codes = {}
        for path in ("/healthz", "/not/a/kube/path",
                     "/api/v1/namespaces/ns/pods/pod/log",
                     # A watch from a resourceVersion that is none of
                     # the store's writes: 410 Gone.
                     "/apis/resource.k8s.io/v1/resourceclaims?watch=true"
                     "&resourceVersion=x"):
            with pytest.raises(urllib.error.HTTPError) as err:
                urllib.request.urlopen(server.url + path, timeout=10)
            codes[path.split("?")[0].rsplit("/", 1)[-1]] = err.value.code
            err.value.close()
        assert codes == {"healthz": 404, "path": 404, "log": 404,
                         "resourceclaims": 410}
        assert server.store.objects() == []
    finally:
        server.stop()


def test_a_server_leaves_no_thread_behind():
    before = set(threading.enumerate())
    for _ in range(3):
        with pt_server.FakeApiServer() as server:
            client = pt_kube.KubeClient(host=server.url)
            for i in range(5):
                client.create(*RC, _claim(f"c{i}"), namespace="ns")
            assert len(client.list(*RC)) == 5
    assert set(threading.enumerate()) == before


def test_unreachable_server_raises_os_error():
    server = pt_server.FakeApiServer()
    url = server.url
    server.stop()  # never started: the port is closed again
    with pytest.raises(OSError):
        pt_kube.KubeClient(host=url).get(*RC, "a", namespace="ns",
                                         timeout=2)


# -- watch --------------------------------------------------------------------

def _watch_script(k):
    k.create(*RC, _claim("a"), namespace="ns")
    k.patch(*RC, "a", {"spec": {"x": 1}}, namespace="ns")
    obj = k.get(*RC, "a", namespace="ns")
    obj["spec"]["x"] = 2
    k.update(*RC, "a", obj, namespace="ns")
    k.create(*RS, _slice("s", "d", "n"))
    k.create(*("", "v1", "namespaces"), {"metadata": {"name": "ns"}})
    k.create(*RC, _claim("b"), namespace="ns")
    k.delete(*RC, "zz", namespace="ns")  # absent: no event
    k.delete(*("", "v1", "namespaces"), "ns")  # cascades to a and b


def test_resource_watchers_see_the_references_events():
    """The in-memory fakes' resource watchers: the same events, in the
    same order, with the same objects as they were at the write (the
    namespace cascade included)."""
    seen = {}
    for side, module in (("jax", jax_kube), ("pt", pt_kube)):
        k = module.FakeKubeClient()
        events = []

        def record(g, r, ns, t, o, events=events):
            events.append((g, r, ns, t, copy.deepcopy(o)))
        k.add_resource_watcher(record)
        _watch_script(k)
        seen[side] = events
    assert seen["pt"] == seen["jax"]


@pytest.mark.parametrize("server_pkg", ["pt", "jax"])
def test_the_port_client_watches_either_server(server_pkg):
    """``KubeClient.watch`` over HTTP against each package's server: the
    writes come as events, in order, and stop() ends the stream at
    once."""
    server = PACKAGES[server_pkg][1].FakeApiServer().start()
    got, cond = [], threading.Condition()

    def on_event(ev_type, obj):
        with cond:
            got.append((ev_type, obj["metadata"]["name"]))
            cond.notify_all()
    try:
        client = pt_kube.KubeClient(host=server.url)
        rv = client.list_with_version(*RC)[1] if server_pkg == "pt" else ""
        w = client.watch(*RC, on_event, resource_version=rv,
                         reconnect_delay=0.05)
        try:
            if server_pkg == "jax":
                # Its streams start from now: write once one is up (the
                # JAX store has no event to wait on; at most 10 s).
                tick = threading.Event()
                for _ in range(1000):
                    if server.store._resource_watchers:
                        break
                    tick.wait(0.01)
            client.create(*RC, _claim("a"), namespace="ns")
            client.patch(*RC, "a", {"spec": {"x": 1}}, namespace="ns")
            client.delete(*RC, "a", namespace="ns")
            with cond:
                assert cond.wait_for(lambda: len(got) >= 3, 10), got
            assert got == [("ADDED", "a"), ("MODIFIED", "a"),
                           ("DELETED", "a")]
        finally:
            w.stop()
        assert not w.alive()
    finally:
        server.stop()
