"""The port's ComputeDomain stack against the JAX package's.

The scenarios of ``tests/test_computedomain.py``: each runs the JAX stack
over the JAX package's ``FakeKubeClient`` and the port's over its own,
through the same calls on the same inputs, and compares what comes out
as JSON: the objects in the store (resourceVersions left out), the
domains' status, the claims' CDI specs (env and mounts), the daemons'
``members.json``, ``bootstrap.json`` and hosts files, the results and
errors of each call. ``neutral`` maps the names that differ by design:
the driver's name and device classes, the config apiVersion, the CDI
kind, the daemon's module and each side's temporary root.

The daemons here run their rendezvous service as a real child process
on a free port and are driven by ``sync_once``, as the JAX tests drive
them; ``tests/test_torch_computedomain_gang.py`` runs whole daemon
processes.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import pytest

from k8s_dra_driver_gpu_tpu import computedomain as jax_cd
from k8s_dra_driver_gpu_tpu.api import decode as jax_decode
from k8s_dra_driver_gpu_tpu.computedomain.controller import (
    controller as jax_controller)
from k8s_dra_driver_gpu_tpu.computedomain.daemon import clique as jax_clique
from k8s_dra_driver_gpu_tpu.computedomain.daemon import dnsnames as jax_dns
from k8s_dra_driver_gpu_tpu.computedomain.daemon import main as jax_daemon
from k8s_dra_driver_gpu_tpu.computedomain.daemon import (
    rendezvous as jax_rendezvous)
from k8s_dra_driver_gpu_tpu.computedomain.plugin import (
    device_state as jax_cds)
from k8s_dra_driver_gpu_tpu.computedomain.plugin import driver as jax_cdd
from k8s_dra_driver_gpu_tpu.kubeletplugin import CDI_CLASS as JAX_CDI_CLASS
from k8s_dra_driver_gpu_tpu.kubeletplugin import CDI_VENDOR as JAX_CDI_VENDOR
from k8s_dra_driver_gpu_tpu.kubeletplugin import reconcile as jax_reconcile
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu_torch import computedomain as pt_cd
from k8s_dra_driver_gpu_tpu_torch.api import computedomain as pt_api
from k8s_dra_driver_gpu_tpu_torch.api import configs as pt_configs
from k8s_dra_driver_gpu_tpu_torch.api import decode as pt_decode
from k8s_dra_driver_gpu_tpu_torch.computedomain.controller import (
    controller as pt_controller)
from k8s_dra_driver_gpu_tpu_torch.computedomain.daemon import (
    clique as pt_clique)
from k8s_dra_driver_gpu_tpu_torch.computedomain.daemon import (
    dnsnames as pt_dns)
from k8s_dra_driver_gpu_tpu_torch.computedomain.daemon import main as pt_daemon
from k8s_dra_driver_gpu_tpu_torch.computedomain.daemon import (
    rendezvous as pt_rendezvous)
from k8s_dra_driver_gpu_tpu_torch.computedomain.plugin import (
    device_state as pt_cds)
from k8s_dra_driver_gpu_tpu_torch.computedomain.plugin import driver as pt_cdd
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import (
    reconcile as pt_reconcile)
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.cdi import ContainerEdits
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import statemachine as pt_sm
from k8s_dra_driver_gpu_tpu_torch.pkg import workqueue as pt_wq
from tests.fake_kube import make_claim_dict

ROOT = pathlib.Path(__file__).resolve().parents[1]
GROUP, VERSION = jax_cd.API_GROUP, jax_cd.API_VERSION
SIDES = ("jax", "pt")


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def wait_for_service(rendezvous, port: int, timeout: float = 30.0) -> None:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        try:
            rendezvous.query("127.0.0.1", port, "STATUS")
            return
        except OSError:
            time.sleep(0.1)
    raise TimeoutError(f"no rendezvous service on :{port}")


class Side:
    """One package's ComputeDomain stack over its own fake API server,
    with nodes node-0 and node-1."""

    def __init__(self, name: str, tmp_path):
        self.name = name
        self.root = tmp_path / name
        self.root.mkdir()
        jax = name == "jax"
        self.cd = jax_cd if jax else pt_cd
        self.controller_mod = jax_controller if jax else pt_controller
        self.clique = jax_clique if jax else pt_clique
        self.dns = jax_dns if jax else pt_dns
        self.daemon = jax_daemon if jax else pt_daemon
        self.rendezvous = jax_rendezvous if jax else pt_rendezvous
        self.cds = jax_cds if jax else pt_cds
        self.cdd = jax_cdd if jax else pt_cdd
        self.reconcile = jax_reconcile if jax else pt_reconcile
        self.config_api = jax_decode.API_VERSION if jax \
            else pt_decode.API_VERSION
        self.kube = (jax_kube if jax else pt_kube).FakeKubeClient()
        for node in ("node-0", "node-1"):
            self.kube.create("", "v1", "nodes",
                             {"kind": "Node", "metadata": {"name": node}})
        self._stops = []

    @property
    def driver(self) -> str:
        return self.cd.COMPUTE_DOMAIN_DRIVER_NAME

    def controller(self):
        ctl = self.controller_mod.ComputeDomainController(self.kube)
        self._stops.append(lambda: ctl.queue.shutdown(wait=True)
                           if self.name == "jax" else ctl.stop())
        return ctl

    def state(self, node: str, sub: str, **kw):
        st = self.cds.CDDeviceState(str(self.root / sub), self.kube, node,
                                    **kw)
        self._stops.append(st.stop)
        return st

    def make_cd(self, name="cd1", namespace="team-a", topology="2x2x2",
                **spec) -> dict:
        body = {"topology": topology, "channel": {
            "resourceClaimTemplate": {"name": f"{name}-channel"},
            "allocationMode": "Single"}} if topology else {"channel": {
                "resourceClaimTemplate": {"name": f"{name}-channel"},
                "allocationMode": "Single"}}
        body.update(spec)
        return self.kube.create(GROUP, VERSION, "computedomains", {
            "apiVersion": f"{GROUP}/{VERSION}", "kind": "ComputeDomain",
            "metadata": {"name": name, "namespace": namespace},
            "spec": body}, namespace=namespace)

    def put_claim(self, uid: str, cd_uid: str, namespace="team-a",
                  device="channel-0", kind="ComputeDomainChannelConfig"):
        request = "daemon" if device == "daemon" else "channel"
        params = {"apiVersion": self.config_api, "kind": kind,
                  "domainID": cd_uid}
        if kind == "ComputeDomainChannelConfig":
            params["allocationMode"] = "Single"
        obj = make_claim_dict(uid, [device], namespace=namespace,
                              request=request, driver=self.driver,
                              configs=[{"parameters": params,
                                        "requests": [request]}])
        self.kube.create("resource.k8s.io", "v1", "resourceclaims", obj,
                         namespace=namespace)

    def get_cd(self, name="cd1", namespace="team-a") -> dict:
        return self.kube.get(GROUP, VERSION, "computedomains", name,
                             namespace=namespace)

    def set_status(self, cd: dict, entries, status="Ready") -> None:
        """entries: [(node, cliqueID, index, ip)]."""
        self.kube.patch(GROUP, VERSION, "computedomains",
                        cd["metadata"]["name"], {"status": {
                            "status": status,
                            "nodes": [{"name": n, "cliqueID": c, "index": i,
                                       "ipAddress": ip, "status": "Ready"}
                                      for n, c, i, ip in entries]}},
                        namespace=cd["metadata"]["namespace"])

    def make_daemon(self, cd_uid, node, port, num_workers=2, **env):
        base = {"COMPUTE_DOMAIN_UUID": cd_uid, "COMPUTE_DOMAIN_NAME": "cd1",
                "COMPUTE_DOMAIN_NAMESPACE": "team-a", "CLIQUE_ID": "0",
                "NODE_NAME": node, "POD_IP": "127.0.0.1",
                "COMPUTE_DOMAIN_NUM_WORKERS": str(num_workers),
                "DOMAIN_STATE_DIR": str(self.root / node),
                "HOSTS_FILE": str(self.root / node / "hosts"),
                "COORDINATION_PORT": str(port)}
        d = self.daemon.Daemon(self.daemon.DaemonConfig(env={**base, **env}),
                               kube=self.kube)
        self._stops.append(d.process.stop)
        return d

    def objects(self) -> list:
        """Every object of the store, neutral, sorted."""
        return sorted((neutral(self, o) for o in self.kube.objects()),
                      key=lambda o: json.dumps(o, sort_keys=True))

    def close(self) -> None:
        for stop in reversed(self._stops):
            stop()


def _strip(obj):
    if isinstance(obj, dict):
        return {k: _strip(v) for k, v in obj.items()
                if k != "resourceVersion"}
    if isinstance(obj, list):
        return [_strip(v) for v in obj]
    return obj


def neutral(side: Side, obj):
    """``obj`` as JSON with the names that differ by design mapped to the
    JAX package's, its temporary root to "<root>" and without
    resourceVersions."""
    text = json.dumps(_strip(obj), sort_keys=True)
    text = text.replace(str(side.root), "<root>")
    if side.name == "pt":
        for pt, jax in (
                (f"{pt_cd.CDI_VENDOR}/{pt_cd.CDI_CLASS}",
                 f"{JAX_CDI_VENDOR}/{JAX_CDI_CLASS}"),
                (pt_cd.CHANNEL_DEVICE_CLASS, jax_cd.CHANNEL_DEVICE_CLASS),
                (pt_cd.DAEMON_DEVICE_CLASS, jax_cd.DAEMON_DEVICE_CLASS),
                (pt_cd.COMPUTE_DOMAIN_DRIVER_NAME,
                 jax_cd.COMPUTE_DOMAIN_DRIVER_NAME),
                (pt_decode.API_VERSION, jax_decode.API_VERSION),
                ("k8s_dra_driver_gpu_tpu_torch.", "k8s_dra_driver_gpu_tpu.")):
            text = text.replace(pt, jax)
    return json.loads(text)


def child_pids() -> set[int]:
    pids = set()
    for task in os.listdir("/proc/self/task"):
        try:
            with open(f"/proc/self/task/{task}/children",
                      encoding="ascii") as f:
                pids.update(int(p) for p in f.read().split())
        except OSError:
            pass
    return pids


@pytest.fixture(autouse=True)
def nothing_left_behind():
    """Each test joins every thread and reaps every child it starts."""
    import threading
    threads, children = set(threading.enumerate()), child_pids()
    yield
    deadline = time.monotonic() + 5
    while time.monotonic() < deadline:
        left = [t for t in threading.enumerate()
                if t not in threads and t.is_alive()]
        if not left and child_pids() <= children:
            break
        time.sleep(0.05)
    assert not left, f"threads left: {[t.name for t in left]}"
    assert child_pids() <= children, "child processes left"


@pytest.fixture()
def sides(tmp_path):
    made = {name: Side(name, tmp_path) for name in SIDES}
    yield made
    for side in made.values():
        side.close()


def on_both(sides, fn):
    """fn(side) on each side, neutral; asserts they agree; the value."""
    got = {name: neutral(side, fn(side)) for name, side in sides.items()}
    assert got["pt"] == got["jax"]
    return got["pt"]


def _ref(uid, namespace="team-a"):
    return {"uid": uid, "namespace": namespace, "name": uid}


def _spec(state, uid) -> dict:
    spec = state._cdi.read_spec(uid)
    return None if spec is None else {
        "kind": spec["kind"], "devices": spec["devices"],
        "containerEdits": spec.get("containerEdits")}


# ---------------------------------------------------------------------------
# the shared contract
# ---------------------------------------------------------------------------

def test_the_names_both_stacks_share():
    for name in ("NODE_LABEL", "CLIQUE_POD_LABEL", "FINALIZER",
                 "DOMAIN_DAEMON_PORT", "JAX_COORDINATOR_PORT",
                 "MEGASCALE_PORT", "API_GROUP", "API_VERSION",
                 "DAEMON_DNS_PATTERN"):
        assert getattr(pt_cd, name) == getattr(jax_cd, name), name
    assert pt_cds.DOMAIN_STATE_ROOT == jax_cds.DOMAIN_STATE_ROOT
    assert pt_cds.MAX_CHANNELS == jax_cds.MAX_CHANNELS
    assert pt_cdd.ERROR_RETRY_MAX_TIMEOUT_S == \
        jax_cdd.ERROR_RETRY_MAX_TIMEOUT_S
    assert pt_daemon.RESYNC_INTERVAL_S == jax_daemon.RESYNC_INTERVAL_S
    assert pt_rendezvous.MAX_WAIT_S == jax_rendezvous.MAX_WAIT_S
    # The CDI kind is not the GPU plugin's: each sweep owns its specs.
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import (CDI_CLASS,
                                                            CDI_VENDOR)
    assert (pt_cd.CDI_VENDOR, pt_cd.CDI_CLASS) != (CDI_VENDOR, CDI_CLASS)


@pytest.mark.parametrize("spec", [
    {}, {"numNodes": 3}, {"topology": "2x2x2"}, {"topology": "4x4x4"},
    {"topology": "2x2", "chipsPerHost": 8}, {"numNodes": 4, "numSlices": 2},
    {"numNodes": 3, "numSlices": 2}, {"numSlices": 0}, {"numSlices": None},
])
def test_gang_sizing_matches(spec):
    def run(cd):
        try:
            per_slice = cd.per_slice_workers(spec)
        except ValueError as e:
            per_slice = str(e)
        return (cd.expected_workers(spec), cd.expected_slices(spec),
                per_slice, cd.daemon_dns_name(3), cd.daemon_dns_name(3, "u"))
    assert run(pt_cd) == run(jax_cd)


def test_the_status_values_match():
    from k8s_dra_driver_gpu_tpu.api import computedomain as jax_api
    for name in ("READY", "NOT_READY"):
        assert getattr(pt_api.ComputeDomainStatusValue, name) == \
            getattr(jax_api.ComputeDomainStatusValue, name)


@pytest.mark.parametrize("params", [
    {"kind": "ComputeDomainChannelConfig", "domainID": "u1"},
    {"kind": "ComputeDomainChannelConfig", "domainID": "u1",
     "allocationMode": "All"},
    {"kind": "ComputeDomainChannelConfig", "domainID": "u1",
     "allocationMode": ""},
    {"kind": "ComputeDomainChannelConfig", "domainID": "u1",
     "allocationMode": "Some"},
    {"kind": "ComputeDomainChannelConfig"},
    {"kind": "ComputeDomainChannelConfig", "domainID": "u1", "extra": 1},
    {"kind": "ComputeDomainDaemonConfig", "domainID": "u1"},
    {"kind": "ComputeDomainDaemonConfig", "domainID": ""},
    {"kind": "ComputeDomainDaemonConfig", "domainID": "u1",
     "allocationMode": "Single"},
])
def test_config_decode_and_validate_match(params):
    def run(decode, api):
        try:
            cfg = decode.strict_decode({"apiVersion": api, **params})
            cfg.normalize()
            cfg.validate()
        except Exception as e:  # noqa: BLE001 - compared across
            return type(e).__name__, str(e)
        return type(cfg).__name__, vars(cfg)
    got = run(pt_decode, pt_decode.API_VERSION)
    want = run(jax_decode, jax_decode.API_VERSION)
    assert got[0] == want[0] and got[1] == want[1]


def test_single_phase_policy_is_the_references():
    from k8s_dra_driver_gpu_tpu.pkg.analysis import statemachine as jax_sm
    assert pt_sm.SINGLE_PHASE_POLICY.allowed == \
        jax_sm.SINGLE_PHASE_POLICY.allowed
    with pytest.raises(pt_sm.CheckpointTransitionError):
        pt_sm.SINGLE_PHASE_POLICY.validate("c", None, pt_sm.PREPARE_STARTED)


@pytest.mark.parametrize("gates", [
    "", "ComputeDomainCliques=false", "DomainDaemonsWithDNSNames=false",
    "ComputeDomainCliques=false,DomainDaemonsWithDNSNames=false",
    "ComputeDomainCliques=true,DomainDaemonsWithDNSNames=true",
])
def test_daemon_reads_its_gates_as_the_reference(sides, gates):
    def run(side):
        cd = side.make_cd()
        d = side.daemon.Daemon(side.daemon.DaemonConfig(env={
            "COMPUTE_DOMAIN_UUID": cd["metadata"]["uid"],
            "COMPUTE_DOMAIN_NAME": "cd1",
            "COMPUTE_DOMAIN_NAMESPACE": "team-a", "FEATURE_GATES": gates,
            "NODE_NAME": "node-0", "POD_IP": "10.0.0.1",
            "DOMAIN_STATE_DIR": str(side.root / "st"),
            "HOSTS_FILE": str(side.root / "hosts")}), kube=side.kube)
        with open(d.members_file, encoding="utf-8") as f:
            members = json.load(f)
        return (d.cfg.use_cliques, d.cfg.dns_names,
                type(d.registrar).__name__, members)
    on_both(sides, run)


# ---------------------------------------------------------------------------
# the controller
# ---------------------------------------------------------------------------

def test_reconcile_materializes_the_same_objects(sides):
    def run(side):
        ctl = side.controller()
        cd = side.make_cd()
        ctl.reconcile(cd)
        assert ctl.queue.wait_idle(10)
        return side.objects()
    objects = on_both(sides, run)
    kinds = sorted(o.get("kind", "") for o in objects)
    assert kinds == ["ComputeDomain", "DaemonSet", "Node", "Node",
                     "ResourceClaimTemplate", "ResourceClaimTemplate"]


def test_status_aggregates_the_cliques_alike(sides):
    def run(side):
        ctl = side.controller()
        cd = side.make_cd(topology="2x2x2")  # 2 hosts
        ctl.reconcile(cd)
        uid = cd["metadata"]["uid"]
        statuses = []
        for node, ip in (("node-0", "10.0.0.1"), ("node-1", "10.0.0.2")):
            side.clique.CliqueRegistrar(side.kube, uid, "0", node,
                                        ip).register(status="Ready")
            ctl.update_global_status(side.get_cd())
            statuses.append(side.get_cd()["status"])
        assert ctl.queue.wait_idle(10)
        statuses.append(side.get_cd()["status"])
        return statuses
    statuses = on_both(sides, run)
    assert [s["status"] for s in statuses] == ["NotReady", "Ready", "Ready"]
    assert [n["index"] for n in statuses[-1]["nodes"]] == [0, 1]


def test_teardown_cascade_matches(sides):
    def run(side):
        ctl = side.controller()
        cd = side.make_cd()
        uid = cd["metadata"]["uid"]
        ctl.reconcile(cd)
        side.clique.CliqueRegistrar(side.kube, uid, "0", "node-0",
                                    "10.0.0.1").register(status="Ready")
        side.kube.patch("", "v1", "nodes", "node-0", {"metadata": {
            "labels": {side.cd.NODE_LABEL: uid}}})
        assert ctl.queue.wait_idle(10)
        cd = side.get_cd()
        cd["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
        side.kube.update(GROUP, VERSION, "computedomains", "cd1", cd,
                         namespace="team-a")
        ctl.reconcile(cd)
        # The JAX controller patches the finalizer on every pass, and the
        # fakes keep a deleted object with its deletionTimestamp, so its
        # queue never goes idle here; the objects are settled.
        return side.objects()
    objects = on_both(sides, run)
    assert sorted(o["kind"] for o in objects) == ["ComputeDomain", "Node",
                                                  "Node"]
    cd = next(o for o in objects if o["kind"] == "ComputeDomain")
    assert not cd["metadata"].get("finalizers")
    assert all(not o["metadata"].get("labels") for o in objects
               if o["kind"] == "Node")


def test_orphan_gc_matches(sides):
    def run(side):
        ctl = side.controller()
        ctl.reconcile(side.make_cd())
        ctl.reconcile(side.make_cd(name="cd2"))
        assert ctl.queue.wait_idle(10)
        side.kube.delete(GROUP, VERSION, "computedomains", "cd1",
                         namespace="team-a")
        ctl.cleanup_orphans()
        assert ctl.queue.wait_idle(10)
        return side.objects()
    objects = on_both(sides, run)
    cd2 = next(o for o in objects if o["kind"] == "ComputeDomain")
    assert sorted(o["metadata"]["name"] for o in objects
                  if o["kind"] != "Node") == [
        "cd2", "cd2-channel", "cd2-daemon-claim",
        f"computedomain-daemon-{cd2['metadata']['uid']}"]


def test_controller_follows_events_over_http(tmp_path):
    """The port's controller over ``KubeClient``'s streamed watch: a
    domain's creation alone makes its objects, a registration its
    status."""
    from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
    server = FakeApiServer().start()
    kube = pt_kube.KubeClient(server.url)
    ctl = pt_controller.ComputeDomainController(kube)
    try:
        ctl.start(resync_interval=60.0)
        assert server.store.wait_for_streams(2, 10)
        cd = kube.create(GROUP, VERSION, "computedomains", {
            "apiVersion": f"{GROUP}/{VERSION}", "kind": "ComputeDomain",
            "metadata": {"name": "cd1", "namespace": "team-a"},
            "spec": {"numNodes": 1}}, namespace="team-a")
        pt_clique.CliqueRegistrar(kube, cd["metadata"]["uid"], "0", "n0",
                                  "10.0.0.1").register(status="Ready")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            got = kube.get(GROUP, VERSION, "computedomains", "cd1",
                           namespace="team-a")
            if got.get("status", {}).get("status") == "Ready":
                break
            time.sleep(0.05)
        assert got["metadata"]["finalizers"] == [pt_cd.FINALIZER]
        assert got["status"]["nodes"][0]["name"] == "n0"
        assert kube.list("apps", "v1", "daemonsets")
    finally:
        ctl.stop()
        server.stop()


# ---------------------------------------------------------------------------
# the daemon's registration, the hosts file and legacy mode
# ---------------------------------------------------------------------------

def test_clique_registrar_takes_the_first_free_index(sides):
    def run(side):
        reg = side.clique.CliqueRegistrar
        r0 = reg(side.kube, "u1", "0", "node-0", "10.0.0.1")
        r1 = reg(side.kube, "u1", "0", "node-1", "10.0.0.2")
        out = [r0.register(), r1.register(), r0.register(status="Ready")]
        r0.deregister()
        out.append(reg(side.kube, "u1", "0", "node-2",
                       "10.0.0.3").register())
        return out, r1.members(), side.objects()
    (indices, members, _) = on_both(sides, run)
    assert indices == [0, 1, 0, 0]
    assert [m["name"] for m in members] == ["node-2", "node-1"]


def test_members_sorted_by_index(sides):
    def run(side):
        reg = side.clique.CliqueRegistrar
        r0 = reg(side.kube, "u1", "0", "node-0", "10.0.0.1")
        r1 = reg(side.kube, "u1", "0", "node-1", "10.0.0.2")
        r1.register()
        r0.register()
        return r0.members()
    assert [m["index"] for m in on_both(sides, run)] == [0, 1]


def test_legacy_status_mode_matches(sides):
    def run(side):
        ctl = side.controller()
        cd = side.make_cd(topology="2x2x2")
        uid = cd["metadata"]["uid"]
        reg = side.clique.LegacyStatusRegistrar
        r0 = reg(side.kube, uid, "cd1", "team-a", "0", "node-0", "10.0.0.1")
        r1 = reg(side.kube, uid, "cd1", "team-a", "0", "node-1", "10.0.0.2")
        out = [r0.register(status="Ready"), r1.register(status="Ready")]
        ctl.update_global_status(side.get_cd())
        verdict = side.get_cd()["status"]["status"]
        r0.deregister()
        return out, verdict, r1.members()
    indices, verdict, members = on_both(sides, run)
    assert indices == [0, 1] and verdict == "Ready"
    assert [m["name"] for m in members] == ["node-1"]


def test_hosts_file_rewrite_matches(sides):
    def run(side):
        hosts = side.root / "hosts"
        hosts.write_text("127.0.0.1 localhost")
        nodes = [{"index": 0, "ipAddress": "10.0.0.1"},
                 {"index": 1, "ipAddress": "10.0.0.2"},
                 {"index": -1, "ipAddress": "10.0.0.3"},
                 {"index": 2, "ipAddress": ""}]
        out = [side.dns.update_hosts_file(
            str(hosts), side.dns.dns_name_mappings(nodes))]
        out.append(side.dns.update_hosts_file(
            str(hosts), side.dns.dns_name_mappings(nodes)))
        nodes[1]["ipAddress"] = "10.0.0.9"
        out.append(side.dns.update_hosts_file(
            str(hosts), side.dns.dns_name_mappings(nodes)))
        out.append(side.dns.update_hosts_file(str(side.root / "new"), {}))
        return out, hosts.read_text(), (side.root / "new").read_text()
    changed, text, _ = on_both(sides, run)
    assert changed == [True, False, True, True]
    assert text.count("BEGIN tpu-compute-domain") == 1 and "10.0.0.9" in text


# ---------------------------------------------------------------------------
# the gang, in one process: two daemons with real rendezvous children
# ---------------------------------------------------------------------------

# The JAX supervisor forks its children with a ``preexec_fn``, which can
# deadlock in a pytest worker that holds other threads' locks (gloo's:
# ROADMAP.md); so the scenarios that start rendezvous children run each
# side in a fresh process of its own.
ISOLATED = {}


def isolated(fn):
    ISOLATED[fn.__name__] = fn
    return fn


def run_isolated(name: str, side: str, tmp_path, **kw):
    """``ISOLATED[name](Side(side, tmp_path), **kw)`` in a new process;
    its neutral result."""
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from tests.test_torch_computedomain import isolated_main; "
            "isolated_main(*sys.argv[2:])")
    proc = subprocess.run(
        [sys.executable, "-c", code, str(ROOT), name, side, str(tmp_path),
         json.dumps(kw)], cwd=str(ROOT), capture_output=True, text=True,
        timeout=120, check=False)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def isolated_main(name: str, side_name: str, root: str, kw: str) -> None:
    side = Side(side_name, pathlib.Path(root))
    try:
        out = neutral(side, ISOLATED[name](side, **json.loads(kw)))
    finally:
        side.close()
    print(json.dumps(out))


def on_both_isolated(tmp_path, name: str, **kw):
    got = {side: run_isolated(name, side, tmp_path, **kw) for side in SIDES}
    assert got["pt"] == got["jax"]
    return got["pt"]


@isolated
def gang_prepare(side, port):
    # Both plugins read the coordinator's port from their env.
    os.environ["JAX_COORDINATOR_PORT"] = str(port)
    ctl = side.controller()
    cd = side.make_cd(topology="2x2x2")
    uid = cd["metadata"]["uid"]
    ctl.reconcile(cd)
    side.put_claim("w0", uid)
    st = side.state("node-0", "st0")
    drv = side.cdd.CDDriver(st, side.kube, "node-0", retry_timeout=0.3)
    early = drv.prepare_resource_claims([_ref("w0")])["w0"][1]
    label = side.kube.get("", "v1", "nodes", "node-0")["metadata"][
        "labels"][side.cd.NODE_LABEL]
    events = [(e["reason"], e["involvedObject"]["name"])
              for e in side.kube.list("", "v1", "events")]
    ports = (free_port(), free_port())
    daemons = [side.make_daemon(uid, node, p, JAX_COORDINATOR_PORT=str(port))
               for node, p in zip(("node-0", "node-1"), ports)]
    for i, d in enumerate(daemons):
        assert d.registrar.register() == i
        d.process.ensure_started()
    for p in ports:
        wait_for_service(side.rendezvous, p)
    for d in daemons:
        d.sync_once()
    for d in daemons:
        d.registrar.set_status("Ready")
    for d in daemons:
        d._last_members = None
        d.sync_once()
    status = side.rendezvous.query("127.0.0.1", ports[0], "STATUS")
    members = json.loads(side.rendezvous.query("127.0.0.1", ports[0],
                                               "MEMBERS"))
    ctl.update_global_status(side.get_cd())
    assert ctl.queue.wait_idle(10)
    drv.retry_timeout = 5.0
    out = drv.prepare_resource_claims([_ref("w0")])
    files = {}
    for d in daemons:
        for f in (d.members_file, d.bootstrap_file, d.cfg.hosts_file):
            with open(f, encoding="utf-8") as fh:
                files[os.path.relpath(f, side.root)] = fh.read()
    return {"early": early.split(":")[0], "label": label, "events": events,
            "status": status, "members": members,
            "cd": side.get_cd()["status"], "prepare": out,
            "spec": _spec(st, "w0"), "files": files}


def test_full_gang_prepare_matches(tmp_path):
    """Controller, the channel prepare before the daemons (the deadline,
    the label kept, one Event), two daemons to quorum, then the channel
    prepare's spec and the daemons' files."""
    port = free_port()
    got = on_both_isolated(tmp_path, "gang_prepare", port=port)
    assert got["early"].startswith("gang prepare deadline")
    assert got["events"] == [["GangPrepareAborted", "w0"]]
    assert got["status"] == "READY" and got["cd"]["status"] == "Ready"
    env = got["spec"]["containerEdits"]["env"]
    assert f"TPU_COORDINATOR_ADDRESS=127.0.0.1:{port}" in env
    boot = json.loads(got["files"]["node-1/bootstrap.json"])
    assert boot["processId"] == 1 and boot["numProcesses"] == 2


@isolated
def legacy_ip_mode(side):
    cd = side.make_cd()
    uid = cd["metadata"]["uid"]
    port = free_port()
    d = side.make_daemon(uid, "n0", port,
                         FEATURE_GATES="DomainDaemonsWithDNSNames=false")
    d.registrar.register()
    d.process.ensure_started()
    wait_for_service(side.rendezvous, port)
    pid = d.process.pid
    side.clique.CliqueRegistrar(side.kube, uid, "0", "n1",
                                "10.0.0.2").register()
    d.sync_once()
    restarted = d.process.pid != pid
    wait_for_service(side.rendezvous, port)
    answer = json.loads(side.rendezvous.query("127.0.0.1", port, "MEMBERS"))
    return d.cfg.dns_names, restarted, answer


def test_legacy_ip_mode_restarts_on_a_member_change(tmp_path):
    dns_names, restarted, members = on_both_isolated(tmp_path,
                                                     "legacy_ip_mode")
    assert not dns_names and restarted
    assert [w["name"] for w in members["workers"]] == ["n0", "n1"]


@pytest.mark.parametrize("command", ["STATUS", "MEMBERS", "WAIT 0.2",
                                     "WAIT x", "NOPE"])
def test_rendezvous_answers_as_the_reference(sides, command):
    def run(side):
        members = side.root / "members.json"
        members.write_text(json.dumps({"numWorkers": 2, "workers": [
            {"name": "a", "status": "Ready"}]}))
        state = side.rendezvous.MembershipState(str(members))
        server = side.rendezvous.CoordinationService("127.0.0.1", 0, state)
        import threading
        thread = threading.Thread(target=server.serve_forever,
                                  kwargs={"poll_interval": 0.05})
        thread.start()
        try:
            port = server.server_address[1]
            answer = side.rendezvous.query("127.0.0.1", port, command)
            barrier = side.rendezvous.wait_for_quorum("127.0.0.1", port, 0.3)
        finally:
            server.shutdown()
            server.server_close()
            thread.join()
        return answer, barrier
    on_both(sides, run)


# ---------------------------------------------------------------------------
# the plugin
# ---------------------------------------------------------------------------

def test_namespace_spoof_guard_matches(sides):
    def run(side):
        uid = side.make_cd(namespace="team-a")["metadata"]["uid"]
        side.put_claim("evil", uid, namespace="team-b")
        st = side.state("node-0", "st")
        drv = side.cdd.CDDriver(st, side.kube, "node-0", retry_timeout=2.0)
        out = drv.prepare_resource_claims([_ref("evil", "team-b")])
        return out, _spec(st, "evil"), side.objects()
    out, spec, _ = on_both(sides, run)
    assert "does not match claim namespace" in out["evil"][1]
    assert spec is None


def test_channel_double_allocation_guard_matches(sides):
    def run(side):
        cd = side.make_cd()
        uid = cd["metadata"]["uid"]
        st = side.state("node-0", "st")
        side.set_status(cd, [("node-0", "", 0, "")])
        side.put_claim("c1", uid)
        side.put_claim("c2", uid)
        drv = side.cdd.CDDriver(st, side.kube, "node-0", retry_timeout=2.0)
        steps = [drv.prepare_resource_claims([_ref("c1")]),
                 drv.prepare_resource_claims([_ref("c2")]),
                 drv.unprepare_resource_claims([{"uid": "c1"}])]
        label = side.kube.get("", "v1", "nodes", "node-0")["metadata"].get(
            "labels")
        steps.append(drv.prepare_resource_claims([_ref("c2")]))
        steps.append(drv.prepare_resource_claims([_ref("c2")]))
        return (steps, label, _spec(st, "c2"),
                {u: c.state for u, c in st.prepared_claims().items()})
    steps, label, spec, records = on_both(sides, run)
    assert steps[0]["c1"][1] == "" and "already allocated" in steps[1]["c2"][1]
    assert not label  # the last channel's unprepare dropped it
    assert steps[3] == steps[4] and records == {"c2": "PrepareCompleted"}
    # The spec carries the env and the mount alone, as the JAX plugin's.
    assert set(spec["containerEdits"]) == {"env", "mounts"}


def test_unprepare_cleans_an_orphan_spec(sides):
    def run(side):
        st = side.state("node-0", "st")
        edits = ContainerEdits if side.name == "pt" else \
            __import__("k8s_dra_driver_gpu_tpu.kubeletplugin.cdi",
                       fromlist=["ContainerEdits"]).ContainerEdits
        st._cdi.create_claim_spec_file("orphan", {"channel-0": edits()})
        before = st._cdi.spec_exists("orphan")
        st.unprepare("orphan")
        return before, st._cdi.spec_exists("orphan")
    assert on_both(sides, run) == [True, False]


def test_stale_domain_dir_gc_matches(sides):
    def run(side):
        uid = side.make_cd()["metadata"]["uid"]
        st = side.state("node-0", "st")
        for d in (uid, "ghost-uid"):
            os.makedirs(os.path.join(st.root, "domains", d))
        removed = st.cleanup_stale_domain_dirs()
        return removed, sorted(os.listdir(os.path.join(st.root, "domains")))
    assert on_both(sides, run) == [["ghost-uid"], ["uid-3"]]


@pytest.mark.parametrize("clique_id, topology", [("slice-a", "2x2x2"),
                                                 ("0", "4x4x4")])
def test_daemon_claim_injects_its_identity(sides, clique_id, topology):
    def run(side):
        uid = side.make_cd(topology=topology)["metadata"]["uid"]
        side.put_claim("d0", uid, namespace="tpu-dra-driver",
                       device="daemon", kind="ComputeDomainDaemonConfig")
        st = side.state("node-0", "st", clique_id=clique_id)
        drv = side.cdd.CDDriver(st, side.kube, "node-0", retry_timeout=2.0)
        out = drv.prepare_resource_claims([_ref("d0", "tpu-dra-driver")])
        return out, _spec(st, "d0"), sorted(os.listdir(
            os.path.join(st.root, "domains")))
    out, spec, dirs = on_both(sides, run)
    assert out["d0"][1] == ""
    assert f"CLIQUE_ID={clique_id}" in spec["containerEdits"]["env"]
    assert spec["containerEdits"]["mounts"][0]["options"][0] == "rw"


def test_gang_abort_unwinds_and_reports_once(sides):
    """A domain whose second node never comes: the prepare aborts at its
    deadline, leaves no spec, no record, keeps the label while the domain
    lives, and creates one Event however often it aborts; once the
    domain is gone the unwind drops the label."""
    def run(side):
        cd = side.make_cd(topology="", numNodes=2)
        uid = cd["metadata"]["uid"]
        side.set_status(cd, [("node-0", "0", 0, "127.0.0.1")],
                        status="NotReady")
        side.put_claim("w0", uid)
        st = side.state("node-0", "st")
        drv = side.cdd.CDDriver(st, side.kube, "node-0", retry_timeout=0.4)
        errors = [drv.prepare_resource_claims([_ref("w0")])["w0"][1]
                  for _ in range(2)]
        labels = [side.kube.get("", "v1", "nodes", "node-0")["metadata"].get(
            "labels")]
        side.kube.delete(GROUP, VERSION, "computedomains", "cd1",
                         namespace="team-a")
        st.unwind_failed_prepare("w0")
        labels.append(side.kube.get("", "v1", "nodes",
                                    "node-0")["metadata"].get("labels"))
        events = [(e["reason"], e["involvedObject"]["name"],
                   e["involvedObject"]["uid"])
                  for e in side.kube.list("", "v1", "events")]
        return ([e.split(":")[0] for e in errors], drv.gang_aborts, labels,
                events, _spec(st, "w0"), sorted(st.prepared_claims()))
    errors, aborts, labels, events, spec, records = on_both(sides, run)
    assert aborts == 2 and len(events) == 1
    assert labels[0] == {jax_cd.NODE_LABEL: "uid-3"} and not labels[1]
    assert spec is None and records == []


def test_a_permanent_api_error_is_not_retried(sides):
    """A 403 on the claim's read fails at once; a 404 is retried to the
    deadline."""
    def run(side):
        kube_mod = jax_kube if side.name == "jax" else pt_kube
        st = side.state("node-0", "st")
        out = []
        for status in (403, 404):
            calls = []

            class Refusing:
                def __getattr__(self, name):
                    return getattr(side.kube, name)

                def get(self, *a, **kw):
                    calls.append(a[2])
                    if a[2] == "resourceclaims":
                        raise (kube_mod.NotFoundError("gone")
                               if status == 404 else
                               kube_mod.KubeError(status, "forbidden"))
                    return side.kube.get(*a, **kw)
            drv = side.cdd.CDDriver(st, Refusing(), "node-0",
                                    retry_timeout=0.3)
            err = drv.prepare_resource_claims([_ref("w0")])["w0"][1]
            out.append((err.split(":")[0], calls.count("resourceclaims") > 1,
                        drv.gang_aborts))
        return out
    got = on_both(sides, run)
    assert got[0] == ["403", False, 0] and got[1][2] == 1


# ---------------------------------------------------------------------------
# multislice
# ---------------------------------------------------------------------------

def _multislice(side, num_nodes=4, num_slices=2):
    return side.make_cd(name="ms", topology="", numNodes=num_nodes,
                        numSlices=num_slices)


def _channel_env(side, cd, node):
    uid = f"w-{node}"
    side.put_claim(uid, cd["metadata"]["uid"])
    st = side.state(node, node)
    drv = side.cdd.CDDriver(st, side.kube, node, retry_timeout=2.0)
    err = drv.prepare_resource_claims([_ref(uid)])[uid][1]
    spec = _spec(st, uid)
    return err, spec and dict(e.split("=", 1)
                              for e in spec["containerEdits"]["env"])


@pytest.mark.parametrize("nodes, slices, entries, ask", [
    # Slice-major global ids over two cliques ("s0" < "s1").
    (4, 2, [("node-a", "s0", 0, "10.0.0.1"), ("node-b", "s0", 1, "10.0.0.2"),
            ("node-c", "s1", 0, "10.0.1.1"), ("node-d", "s1", 1, "10.0.1.2")],
     ("node-a", "node-d")),
    # One slice: no MEGASCALE_* and no slice ids.
    (2, 1, [("node-a", "0", 0, "10.0.0.1"), ("node-b", "0", 1, "10.0.0.2")],
     ("node-a", "node-b")),
    # An unregistered slot falls back to its stable name.
    (3, 1, [("node-a", "0", 0, "10.0.0.1"), ("node-c", "0", 2, "10.0.0.3")],
     ("node-c",)),
    # Indivisible: a permanent error.
    (3, 2, [("node-a", "s0", 0, "10.0.0.1"), ("node-b", "s0", 1, "10.0.0.2"),
            ("node-c", "s1", 0, "10.0.1.1")], ("node-a",)),
    # Two cliques registered on one slice: refused (colliding ids).
    (2, 1, [("node-a", "s0", 0, "10.0.0.1"), ("node-b", "s1", 0, "10.0.1.1")],
     ("node-a",)),
])
def test_multislice_channel_env_matches(sides, nodes, slices, entries, ask):
    def run(side):
        cd = _multislice(side, nodes, slices)
        side.set_status(cd, entries)
        return [_channel_env(side, side.get_cd("ms"), node) for node in ask]
    got = on_both(sides, run)
    if (nodes, slices) == (4, 2):
        (_, env_a), (_, env_d) = got
        assert (env_a["TPU_PROCESS_ID"], env_d["TPU_PROCESS_ID"]) == ("0", "3")
        assert env_d["MEGASCALE_COORDINATOR_ADDRESS"] == "10.0.0.1:8080"
        assert env_d["TPU_SLICE_ID"] == "1"
    elif (nodes, slices) == (2, 1) and len(ask) == 2:
        assert all("MEGASCALE_NUM_SLICES" not in env and
                   "TPU_NUM_SLICES" not in env for _, env in got)
    elif (nodes, slices) == (3, 2):
        assert "does not split evenly" in got[0][0]


def test_daemon_quorum_is_clique_local(sides):
    def run(side):
        cd = _multislice(side)
        side.put_claim("d0", cd["metadata"]["uid"], device="daemon",
                       kind="ComputeDomainDaemonConfig")
        st = side.state("node-a", "dq")
        drv = side.cdd.CDDriver(st, side.kube, "node-a", retry_timeout=5.0)
        return drv.prepare_resource_claims([_ref("d0")]), _spec(st, "d0")
    out, spec = on_both(sides, run)
    assert "COMPUTE_DOMAIN_NUM_WORKERS=2" in spec["containerEdits"]["env"]


@pytest.mark.parametrize("clique_id", ["0", "s1"])
def test_devices_carry_the_clique_attribute(sides, clique_id):
    def run(side):
        st = side.state("node-a", "attr", clique_id=clique_id)
        drv = side.cdd.CDDriver(st, side.kube, "node-a")
        drv.publish_resources()
        return st.allocatable_devices(), side.kube.list(
            "resource.k8s.io", "v1", "resourceslices")
    devices, slices = on_both(sides, run)
    assert len(devices) == 129 and all(
        d["attributes"]["cliqueId"] == {"string": clique_id} for d in devices)
    assert len(slices) == 1


# ---------------------------------------------------------------------------
# the reconcile sweep
# ---------------------------------------------------------------------------

def test_cd_state_reconciler_matches(sides):
    """A completed record whose claim is gone is unprepared (and the node
    label goes with the last channel); a spec with no record is unwound;
    a live claim's record stays."""
    def run(side):
        cd = side.make_cd()
        uid = cd["metadata"]["uid"]
        side.set_status(cd, [("node-0", "0", 0, "10.0.0.1")])
        st = side.state("node-0", "st")
        drv = side.cdd.CDDriver(st, side.kube, "node-0", retry_timeout=2.0)
        side.put_claim("gone", uid, device="channel-1")
        side.put_claim("live", uid, device="channel-2")
        drv.prepare_resource_claims([_ref("gone"), _ref("live")])
        side.kube.delete("resource.k8s.io", "v1", "resourceclaims", "gone",
                         namespace="team-a")
        edits = ContainerEdits if side.name == "pt" else \
            __import__("k8s_dra_driver_gpu_tpu.kubeletplugin.cdi",
                       fromlist=["ContainerEdits"]).ContainerEdits
        st._cdi.create_claim_spec_file("orphan", {"channel-3": edits()})
        sweeps = [drv.reconciler.reconcile_once()]
        label = side.kube.get("", "v1", "nodes", "node-0")["metadata"].get(
            "labels")
        side.kube.delete("resource.k8s.io", "v1", "resourceclaims", "live",
                         namespace="team-a")
        sweeps.append(drv.reconciler.reconcile_once())
        sweeps.append(drv.reconciler.reconcile_once())
        return (sweeps, label, sorted(st._cdi.list_claim_uids()),
                sorted(st.prepared_claims()),
                side.kube.get("", "v1", "nodes", "node-0")["metadata"].get(
                    "labels"))
    sweeps, label, specs, records, label_after = on_both(sides, run)
    assert sweeps == [{"cd_stale_claim": 1, "cd_cdi_spec": 1},
                      {"cd_stale_claim": 1, "cd_cdi_spec": 0},
                      {"cd_stale_claim": 0, "cd_cdi_spec": 0}]
    assert label == {jax_cd.NODE_LABEL: "uid-3"} and not label_after
    assert specs == [] and records == []


def test_the_driver_runs_and_stops_its_background(tmp_path):
    kube = pt_kube.FakeKubeClient()
    st = pt_cds.CDDeviceState(str(tmp_path), kube, "node-0")
    drv = pt_cdd.CDDriver(st, kube, "node-0")
    drv.start_background()
    drv.stop_background()
    assert not drv._gc_thread.is_alive()


# ---------------------------------------------------------------------------
# the work queue
# ---------------------------------------------------------------------------

def test_work_queue_dedupes_retries_and_drops_permanent_errors():
    seen, fails = [], {"k": 2}

    def fn(key):
        seen.append(key)
        if fails.get(key):
            fails[key] -= 1
            raise RuntimeError("again")
        if key == "p":
            raise pt_wq.PermanentError("never")

    q = pt_wq.WorkQueue(limiter=pt_wq.RateLimiter(base_delay=0.001,
                                                  max_delay=0.01))
    try:
        for key in ("k", "k", "p", "x"):
            q.enqueue(key, fn)
        assert q.wait_idle(5)
    finally:
        q.shutdown()
    assert seen.count("k") == 3 and seen.count("p") == 1 and \
        seen.count("x") == 1
    assert not q._thread.is_alive()
    limiter = pt_wq.CONTROLLER_DEFAULT_LIMITER
    from k8s_dra_driver_gpu_tpu.pkg import workqueue as jax_wq
    assert [limiter.delay_for(n) for n in range(1, 12)] == [
        jax_wq.CONTROLLER_DEFAULT_LIMITER.delay_for(n) for n in range(1, 12)]
    assert pt_cdd.RETRY_LIMITER.base_delay == jax_cdd.RETRY_LIMITER.base_delay


def test_work_queue_reruns_a_key_enqueued_while_it_runs():
    import threading
    started, release, runs = threading.Event(), threading.Event(), []

    def fn(key):
        runs.append(key)
        if len(runs) == 1:
            started.set()
            release.wait(5)

    q = pt_wq.WorkQueue()
    try:
        q.enqueue("k", fn)
        assert started.wait(5)
        q.enqueue("k", fn)
        release.set()
        assert q.wait_idle(5)
    finally:
        q.shutdown()
    assert runs == ["k", "k"]


def test_the_gpu_plugin_refuses_a_channel_config(tmp_path):
    """The CD config kinds decode in the port's shared decoder; the GPU
    plugin refuses one on a GPU claim and leaves nothing behind."""
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import (
        ResourceClaim)
    cfg = pt_decode.strict_decode({
        "apiVersion": pt_decode.API_VERSION,
        "kind": "ComputeDomainChannelConfig", "domainID": "u1"})
    assert isinstance(cfg, pt_configs.ComputeDomainChannelConfig)
    state = device_state.DeviceState(
        device_state.Config.mock(str(tmp_path), "h100-4"))
    claim = ResourceClaim.from_dict(make_claim_dict(
        "c1", ["gpu-0"], driver=DRIVER_NAME, request="gpu",
        configs=[{"parameters": {"apiVersion": pt_decode.API_VERSION,
                                 "kind": "ComputeDomainChannelConfig",
                                 "domainID": "u1"}}]))
    with pytest.raises(device_state.PrepareError,
                       match="ComputeDomainChannelConfig cannot apply"):
        state.prepare(claim)
    assert state.prepared_claims() == {}
    assert not state._cdi.spec_exists("c1")
