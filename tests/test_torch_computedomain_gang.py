"""The port's ComputeDomain daemons as real processes (the counterpart of
``tests/test_computedomain.py``'s ``TestGangFlow``,
``TestFourDaemonFailover`` and ``TestSixDaemonRollingChurn``).

Each daemon is ``python -m
k8s_dra_driver_gpu_tpu_torch.computedomain.daemon.main run`` over the
port's ``FakeApiServer`` (HTTP), with its rendezvous service on a free
port; the port's controller runs in this process over the server's store.
One gang of three scenarios:

- two daemons register, go Ready and reach quorum, and the controller
  calls the domain Ready;
- a SIGKILLed rendezvous child is started again by its daemon's
  watchdog and the quorum comes back, no other child restarting;
- a daemon stopped with SIGTERM deregisters, and its replacement (a new
  address) takes the old slot; the survivor rewrites its hosts file
  without restarting its service;

then a JAX daemon and a port daemon join one clique of a second domain
over the same server and write the same ``bootstrap.json``; and
``entry.dryrun_multichip_multiprocess`` runs a 2-node CPU gang from the
port daemon's file. Every daemon is stopped with SIGTERM at the end, and
no daemon, rendezvous child or thread is left.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time

import pytest

from k8s_dra_driver_gpu_tpu_torch import entry as pt_entry
from k8s_dra_driver_gpu_tpu_torch.computedomain import (API_GROUP,
                                                        API_VERSION,
                                                        daemon_dns_name)
from k8s_dra_driver_gpu_tpu_torch.computedomain.controller.controller import (
    ComputeDomainController)
from k8s_dra_driver_gpu_tpu_torch.computedomain.daemon.rendezvous import (
    query, wait_for_quorum)
from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PT_DAEMON = "k8s_dra_driver_gpu_tpu_torch.computedomain.daemon.main"
JAX_DAEMON = "k8s_dra_driver_gpu_tpu.computedomain.daemon.main"


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def wait_until(fn, timeout: float = 30.0, what: str = ""):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = fn()
        if value:
            return value
        time.sleep(0.05)
    raise TimeoutError(f"timed out waiting for {what or fn}")


def children(pid: int) -> list[int]:
    out = []
    try:
        for task in os.listdir(f"/proc/{pid}/task"):
            with open(f"/proc/{pid}/task/{task}/children",
                      encoding="ascii") as f:
                out += [int(p) for p in f.read().split()]
    except OSError:
        pass
    return out


def alive(pid: int) -> bool:
    try:
        with open(f"/proc/{pid}/stat", encoding="ascii") as f:
            return f.read().rsplit(")", 1)[1].split()[0] != "Z"
    except (OSError, IndexError):
        return False


def answer(port: int, command: str = "STATUS") -> str:
    try:
        return query("127.0.0.1", port, command, timeout=2.0)
    except OSError:
        return ""


class DaemonProc:
    """One daemon process of a domain."""

    def __init__(self, server, tmp, cd_uid, node, module=PT_DAEMON,
                 ip="127.0.0.1", num_workers=2, jax_port=0, gen=0):
        self.node, self.port = node, free_port()
        self.dir = os.path.join(tmp, f"{node}-{gen}")
        os.makedirs(self.dir)
        env = {k: v for k, v in os.environ.items()
               if not k.startswith(("TPU_", "KUBERNETES_"))}
        env.update({
            "PYTHONPATH": ROOT, "KUBE_API": server.url,
            "COMPUTE_DOMAIN_UUID": cd_uid, "COMPUTE_DOMAIN_NAME": "cd",
            "COMPUTE_DOMAIN_NAMESPACE": "team-a", "CLIQUE_ID": "0",
            "NODE_NAME": node, "POD_IP": ip,
            "COMPUTE_DOMAIN_NUM_WORKERS": str(num_workers),
            "DOMAIN_STATE_DIR": os.path.join(self.dir, "domain"),
            "HOSTS_FILE": os.path.join(self.dir, "hosts"),
            "COORDINATION_PORT": str(self.port),
            "JAX_COORDINATOR_PORT": str(jax_port or free_port()),
            "JAX_PLATFORMS": "cpu"})
        self.log = open(os.path.join(self.dir, "log"), "w",  # noqa: SIM115
                        encoding="utf-8")
        self.proc = subprocess.Popen(
            [sys.executable, "-m", module, "run"], env=env, cwd=ROOT,
            stdin=subprocess.DEVNULL, stdout=self.log,
            stderr=subprocess.STDOUT)

    def file(self, name: str) -> dict:
        with open(os.path.join(self.dir, "domain", name),
                  encoding="utf-8") as f:
            return json.load(f)

    def hosts(self) -> str:
        with open(os.path.join(self.dir, "hosts"), encoding="utf-8") as f:
            return f.read()

    def child(self) -> int | None:
        kids = children(self.proc.pid)
        return kids[0] if len(kids) == 1 else None

    def ready(self) -> bool:
        return answer(self.port) == "READY"

    def stop(self, timeout: float = 15.0) -> int:
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGTERM)
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait()
        finally:
            self.log.close()

    def tail(self) -> str:
        with open(os.path.join(self.dir, "log"), encoding="utf-8") as f:
            return f.read()[-3000:]


def make_cd(kube, name: str, num_nodes: int) -> dict:
    return kube.create(API_GROUP, API_VERSION, "computedomains", {
        "apiVersion": f"{API_GROUP}/{API_VERSION}", "kind": "ComputeDomain",
        "metadata": {"name": name, "namespace": "team-a"},
        "spec": {"numNodes": num_nodes, "channel": {
            "resourceClaimTemplate": {"name": f"{name}-channel"}}}},
        namespace="team-a")


def members_of(kube, cd_uid: str) -> list[dict]:
    try:
        clique = kube.get(API_GROUP, API_VERSION, "computedomaincliques",
                          f"{cd_uid}.0", namespace="tpu-dra-driver")
    except Exception:  # noqa: BLE001 - not made yet
        return []
    return sorted(clique.get("status", {}).get("daemons", []),
                  key=lambda e: e["index"])


@pytest.fixture(scope="module")
def gang(tmp_path_factory):
    """The server, the controller and the daemons of the file; torn down
    (SIGTERM, deregistration, every child gone) at its end."""
    threads = set(threading.enumerate())
    tmp = str(tmp_path_factory.mktemp("cdgang"))
    server = FakeApiServer().start()
    store = server.store
    controller = ComputeDomainController(store)
    controller.start(resync_interval=1.0)
    state = {"server": server, "store": store, "tmp": tmp, "daemons": [],
             "controller": controller, "rendezvous": set()}
    try:
        # Domain cd1: two daemons, started one at a time so that node-0
        # takes index 0.
        uid = make_cd(store, "cd1", 2)["metadata"]["uid"]
        jax_port = free_port()
        state["cd1"] = (uid, jax_port)
        daemons = []
        for i, node in enumerate(("node-0", "node-1")):
            daemons.append(start(state, uid, node, jax_port=jax_port))
            wait_until(lambda i=i: len(members_of(store, uid)) == i + 1, 60,
                       f"{node}'s registration")
        converge(state, uid, daemons, 2)
        state["cd1_daemons"] = daemons
        yield state
    finally:
        codes = [d.stop() for d in state["daemons"]]
        registered = [m for clique in store.list(
            API_GROUP, API_VERSION, "computedomaincliques")
            for m in clique.get("status", {}).get("daemons", [])]
        controller.stop()
        server.stop()
        # Each daemon exits 0 and leaves neither its rendezvous child
        # nor a registration; no thread of this process is left.
        logs = "\n".join(d.tail() for d in state["daemons"]
                         if d.proc.returncode)
        assert codes == [0] * len(codes), logs
        assert registered == []
        assert not [p for p in state["rendezvous"] if alive(p)]
        wait_until(lambda: not [t for t in threading.enumerate()
                                if t not in threads and t.is_alive()],
                   10, "the gang's threads to end")


def start(gang, cd_uid, node, **kw) -> DaemonProc:
    d = DaemonProc(gang["server"], gang["tmp"], cd_uid, node, **kw)
    gang["daemons"].append(d)
    return d


def converge(gang, cd_uid, daemons, n):
    """Every daemon's service READY with n Ready members; returns the
    rendezvous children."""
    store = gang["store"]
    for d in daemons:
        wait_until(d.ready, 60, f"{d.node}'s service READY:\n{d.tail()}")
    wait_until(lambda: len(members_of(store, cd_uid)) == n and all(
        m["status"] == "Ready" for m in members_of(store, cd_uid)), 30,
        "the clique's members")
    kids = [wait_until(d.child, 10, f"{d.node}'s child") for d in daemons]
    gang["rendezvous"].update(kids)
    return kids


def test_two_daemons_converge_and_the_domain_goes_ready(gang):
    store = gang["store"]
    uid, jax_port = gang["cd1"]
    daemons = gang["cd1_daemons"][:2]
    wait_until(lambda: store.get(API_GROUP, API_VERSION, "computedomains",
                                 "cd1", namespace="team-a").get(
        "status", {}).get("status") == "Ready", 30, "the domain Ready")
    assert wait_for_quorum("127.0.0.1", daemons[0].port, 5.0)
    members = json.loads(answer(daemons[1].port, "MEMBERS"))
    assert members["numWorkers"] == 2 and len(members["workers"]) == 2
    for i, d in enumerate(daemons):
        boot = wait_until(lambda d=d: d.file("bootstrap.json"), 10)
        assert boot == {
            "coordinatorAddress": f"{daemon_dns_name(0)}:{jax_port}",
            "numProcesses": 2, "processId": i,
            "workerHostnames": [daemon_dns_name(0), daemon_dns_name(1)],
            "scope": "clique", "cliqueID": "0"}
        assert wait_until(lambda d=d: daemon_dns_name(1) in d.hosts(), 10)
    assert store.list("apps", "v1", "daemonsets")


def test_a_killed_rendezvous_child_comes_back(gang):
    uid, _ = gang["cd1"]
    daemons = gang["cd1_daemons"]
    before = [d.child() for d in daemons]
    os.kill(before[1], signal.SIGKILL)
    wait_until(lambda: not alive(before[1]), 10, "the child to die")
    after = wait_until(lambda: (daemons[1].child() not in (None, before[1])
                                and daemons[1].child()), 20,
                       f"a new child:\n{daemons[1].tail()}")
    gang["rendezvous"].add(after)
    converge(gang, uid, daemons, 2)
    assert daemons[0].child() == before[0]
    assert wait_for_quorum("127.0.0.1", daemons[1].port, 5.0)


def test_a_replaced_daemon_takes_its_old_slot(gang):
    uid, jax_port = gang["cd1"]
    store = gang["store"]
    survivor, victim = gang["cd1_daemons"]
    survivor_child = survivor.child()
    assert victim.stop() == 0  # SIGTERM: it deregisters
    wait_until(lambda: [m["name"] for m in members_of(store, uid)]
               == ["node-0"], 15, "the deregistration")
    wait_until(lambda: answer(survivor.port) == "NOT_READY", 15,
               "the survivor to lose quorum")
    replacement = start(gang, uid, "node-1", ip="127.0.0.2",
                        jax_port=jax_port, gen=1)
    converge(gang, uid, [survivor, replacement], 2)
    assert [(m["name"], m["index"], m["ipAddress"])
            for m in members_of(store, uid)] == [
        ("node-0", 0, "127.0.0.1"), ("node-1", 1, "127.0.0.2")]
    wait_until(lambda: f"127.0.0.2\t{daemon_dns_name(1)}" in survivor.hosts(),
               15, "the survivor's hosts file")
    # DNS mode: the survivor's service was nudged, never restarted.
    assert survivor.child() == survivor_child
    assert replacement.file("bootstrap.json")["processId"] == 1
    gang["cd1_daemons"] = [survivor, replacement]


def test_a_jax_daemon_and_a_port_daemon_share_a_clique(gang):
    """Both stacks' daemons as the two members of one clique over the
    port's server: the same registrations, the same bootstrap.json but
    for each one's process id, the same members.json."""
    store = gang["store"]
    cd = make_cd(store, "mixed", 2)
    uid = cd["metadata"]["uid"]
    jax_port = free_port()
    jax_d = start(gang, uid, "node-j", module=JAX_DAEMON, jax_port=jax_port)
    wait_until(lambda: members_of(store, uid), 60,
               f"the JAX daemon's registration:\n{jax_d.tail()}")
    pt_d = start(gang, uid, "node-p", jax_port=jax_port)
    converge(gang, uid, [jax_d, pt_d], 2)
    assert [(m["name"], m["index"]) for m in members_of(store, uid)] == [
        ("node-j", 0), ("node-p", 1)]

    def settled(d):
        members = d.file("members.json")
        return len(members["workers"]) == 2 and all(
            w["status"] == "Ready" for w in members["workers"]) and members
    members = [wait_until(lambda d=d: settled(d), 30, "members.json")
               for d in (jax_d, pt_d)]
    assert members[0] == members[1]
    boots = [d.file("bootstrap.json") for d in (jax_d, pt_d)]
    assert set(pt_entry.BOOTSTRAP_KEYS) <= set(boots[1])
    assert [b.pop("processId") for b in boots] == [0, 1]
    assert boots[0] == boots[1]
    assert jax_d.hosts() == pt_d.hosts()
    # The JAX daemon deregisters at SIGTERM as the port's does.
    assert jax_d.stop() == 0
    wait_until(lambda: [m["name"] for m in members_of(store, uid)]
               == ["node-p"], 15, "the JAX daemon's deregistration")


def test_a_gang_runs_from_the_port_daemons_bootstrap(gang):
    """``dryrun_multichip_multiprocess`` from the daemon's own
    bootstrap.json: the coordinator's name resolved through its
    members.json, two node processes of one gloo rank each."""
    _, jax_port = gang["cd1"]
    daemon = gang["cd1_daemons"][0]
    boot = os.path.join(daemon.dir, "domain", "bootstrap.json")
    addresses = ",".join(w["ipAddress"] for w in sorted(
        daemon.file("members.json")["workers"], key=lambda w: w["index"]))
    reports = pt_entry.dryrun_multichip_multiprocess(
        local_devices=1, bootstrap_file=boot, timeout=300, device="cpu")
    assert sorted(r["processId"] for r in reports) == [0, 1]
    for rep in reports:
        assert rep["devSum"] == 2.0 and rep["rankSum"] == 3.0
        assert rep["steps"] == 2 and rep["gang"] is True
        assert rep["env"]["TPU_COORDINATOR_ADDRESS"] == \
            f"127.0.0.1:{jax_port}"
        assert rep["env"]["TPU_WORKER_HOSTNAMES"] == addresses
    assert len({rep["loss"] for rep in reports}) == 1
