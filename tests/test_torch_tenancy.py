"""The port's tenancy admission against the JAX plugin's.

- **The agent.** The JAX ``TenancyState``/``_handle_line`` and the
  port's, in this process, fed the same seeded request sequences
  (``REGISTER``, ``RELEASE``, re-``REGISTER``, tombstones, bad ids and
  lines, a restart from ``clients.json``): each answer is the same
  string, and ``clients.json`` the same bytes after each step.
- **The hooks.** The JAX ``tenancy_preflight.main``, the port's, and the
  port's native hook (built from ``csrc/tenancy_preflight.cc``; skipped,
  naming it, where no C++ compiler is) over the same cases: exit codes
  and what each leaves on disk. Their agents serve from a thread of this
  process, over the JAX and the port's state: no JAX agent is spawned
  (its supervisor forks with ``preexec_fn``).
- **End to end, the port only.** ``DeviceState`` over the mock GPU and
  the fake ``nvidia-cuda-mps-control`` of
  ``test_torch_kubeletplugin_sharing.py`` with agents on: the ready agent
  and both hooks in the spec, admission through the spec's own hook
  commands, the control plane outside every mount, restart, SIGKILL,
  teardown, orphans, a boot id change, a partition tenant, the
  supervisor's threads and parent-death signal.

Every root is short (``tempfile.mkdtemp(dir="/tmp")``): an agent's
socket path must fit AF_UNIX's 107 bytes. Every fixture stops what it
started and checks that no agent process or supervisor thread is left.
"""

import io
import json
import os
import pathlib
import random
import shutil
import signal
import socketserver
import subprocess
import sys
import tempfile
import threading
import time

import pytest

from k8s_dra_driver_gpu_tpu.kubeletplugin import tenancy_agent as jax_agent
from k8s_dra_driver_gpu_tpu.kubeletplugin import \
    tenancy_preflight as jax_preflight
from k8s_dra_driver_gpu_tpu_torch.api.decode import API_VERSION as PT_API
from k8s_dra_driver_gpu_tpu_torch.computedomain.daemon import process
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import native_hook, sharing
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import \
    tenancy_agent as pt_agent
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import \
    tenancy_preflight as pt_preflight
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import ResourceClaim
from k8s_dra_driver_gpu_tpu_torch.pkg import partition as pt_partition
from tests.fake_kube import make_claim_dict
from tests.test_torch_kubeletplugin_device_state import write_mig_caps
from tests.test_torch_kubeletplugin_sharing import (kill_fake_daemons,
                                                    write_fake_binaries)

ROOT = pathlib.Path(__file__).resolve().parents[1]
GIB = 1 << 30
GATES = "TimeSlicingSettings=true,MultiTenancySupport=true"
PARTITION_GATES = ("DynamicSubSlice=true,TenantPartitioning=true,"
                   + GATES)
BOOT = "boot-0"


def short_root() -> str:
    return tempfile.mkdtemp(prefix="tn", dir="/tmp")


def read(path: str):
    try:
        with open(path, "rb") as f:
            return f.read()
    except FileNotFoundError:
        return None


# -- the agent: the JAX state and the port's over the same sequences -------

def write_manifest(d: str, max_clients, capacity) -> None:
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "tenancy.json"), "w") as f:
        json.dump({"chips": [0], "maxClients": max_clients,
                   "hbmCapacityBytes": capacity, "hbmLimits": {}}, f)


def random_steps(seed: int) -> tuple[dict, list]:
    rng = random.Random(seed)
    manifest = {"max_clients": rng.choice([None, 1, 2, 3]),
                "capacity": rng.choice([None, 10 * GIB, 24 * GIB])}
    ids = ["ctr-a", "ctr-b", "ctr-c", "ctr-d"]
    sizes = [0, GIB, 4 * GIB, 8 * GIB, 12 * GIB]
    steps = []
    for _ in range(40):
        kind = rng.choices(
            ["register", "release", "members", "tombstone", "restart",
             "bad"], weights=[8, 3, 1, 2, 1, 2])[0]
        if kind == "register":
            steps.append(("line", f"REGISTER {rng.choice(ids)} "
                                  f"{rng.choice(sizes)}"))
        elif kind == "release":
            steps.append(("line", f"RELEASE {rng.choice(ids)}"))
        elif kind == "members":
            steps.append(("line", rng.choice(["MEMBERS", "STATUS",
                                              "status"])))
        elif kind == "tombstone":
            steps.append(("tombstone", rng.choice(ids)))
        elif kind == "restart":
            steps.append(("restart", None))
        else:
            steps.append(("line", rng.choice([
                "", "REGISTER ctr-a", "REGISTER ctr-a lots",
                "REGISTER a/b 1", "REGISTER . 1", "REGISTER .. 1",
                "RELEASE", "EVICT ctr-a", "register ctr-b 5"])))
    return manifest, steps


@pytest.mark.parametrize("seed", range(8))
def test_agent_answers_and_grants_equal_the_reference(seed):
    manifest, steps = random_steps(seed)
    root = short_root()
    try:
        dirs = {side: os.path.join(root, side) for side in ("jax", "pt")}
        mods = {"jax": jax_agent, "pt": pt_agent}
        states = {}
        for side, d in dirs.items():
            write_manifest(d, manifest["max_clients"], manifest["capacity"])
            states[side] = mods[side].TenancyState(d)
        for i, (kind, arg) in enumerate(steps):
            answers = {}
            for side, d in dirs.items():
                if kind == "line":
                    answers[side] = mods[side]._handle_line(states[side],
                                                            arg)
                elif kind == "tombstone":
                    os.makedirs(os.path.join(d, "released.d"),
                                exist_ok=True)
                    open(os.path.join(d, "released.d", arg), "w").close()
                else:
                    states[side] = mods[side].TenancyState(d)
            assert answers.get("pt") == answers.get("jax"), (i, kind, arg)
            assert read(os.path.join(dirs["pt"], "clients.json")) == read(
                os.path.join(dirs["jax"], "clients.json")), (i, kind, arg)
            assert sorted(os.listdir(dirs["pt"])) == \
                sorted(os.listdir(dirs["jax"]))
    finally:
        shutil.rmtree(root)


@pytest.mark.parametrize("max_clients, line, answer", [
    (1, "REGISTER ctr-a 4096", "OK 4096"),
    (1, "REGISTER ctr-b 1", "DENIED max clients (1) reached"),
    (None, "REGISTER ctr-b 8000",
     "DENIED HBM budget exceeded: 8000 requested, 7168 available"),
    (None, "RELEASE ctr-a", "OK released"),
    (None, "STATUS", "READY"),
    (None, "MEMBERS", '{"clients": {"ctr-a": 1024}, "maxClients": null, '
     '"hbmCapacityBytes": 8192}'),
])
def test_agent_answers_letter_for_letter(max_clients, line, answer):
    root = short_root()
    try:
        write_manifest(root, max_clients, 8192)
        state = pt_agent.TenancyState(root)
        assert pt_agent._handle_line(state, "REGISTER ctr-a 1024") == \
            "OK 1024"
        assert pt_agent._handle_line(state, line) == answer
    finally:
        shutil.rmtree(root)


def test_the_agent_module_loads_no_torch():
    code = ("import sys, k8s_dra_driver_gpu_tpu_torch.kubeletplugin."
            "tenancy_agent, k8s_dra_driver_gpu_tpu_torch.kubeletplugin."
            "tenancy_preflight; sys.exit('torch' in sys.modules)")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=str(ROOT)),
                          capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0, proc.stderr


def test_nothing_in_the_port_uses_preexec_fn():
    users = [str(p.relative_to(ROOT))
             for p in sorted((ROOT / "k8s_dra_driver_gpu_tpu_torch").rglob(
                 "*.py")) + [ROOT / "chip_smoke.py"]
             if "preexec_fn=" in p.read_text()]
    assert users == []


# -- the hooks: the JAX hook, the port's and the native one ----------------

class ThreadAgent:
    """An agent of ``module`` (the JAX or the port's) serving ``d`` from a
    thread of this process."""

    def __init__(self, module, d: str):
        self.state = module.TenancyState(d)
        state = self.state

        class Handler(socketserver.StreamRequestHandler):
            def handle(self):
                line = self.rfile.readline().decode(errors="replace")
                self.wfile.write(
                    (module._handle_line(state, line) + "\n").encode())

        self.server = socketserver.UnixStreamServer(
            os.path.join(d, "agent.sock"), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       kwargs={"poll_interval": 0.01})
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)
        assert not self.thread.is_alive()
        os.unlink(self.server.server_address)


@pytest.fixture(scope="module")
def native():
    """The native hook's path; the test skips, naming the compiler,
    where none is."""
    try:
        return native_hook.build().path
    except native_hook.HookBuildError as e:
        pytest.skip(f"native hook not built: {e}")


def run_hook(variant: str, args: list[str], stdin: str, monkeypatch,
             native_path=None) -> int:
    if variant == "native":
        return subprocess.run([native_path, *args], input=stdin,
                              capture_output=True, text=True,
                              timeout=30).returncode
    monkeypatch.setattr(sys, "stdin", io.StringIO(stdin))
    main = {"jax": jax_preflight.main, "pt": pt_preflight.main}[variant]
    try:
        return main(args)
    finally:
        monkeypatch.undo()


def snapshot(d: str) -> dict:
    """What a hook may leave: the grants, the tombstones, the dir."""
    if not os.path.isdir(d):
        return {"dir": False}
    rd = os.path.join(d, "released.d")
    return {"dir": True, "clients": read(os.path.join(d, "clients.json")),
            "tombstones": sorted(os.listdir(rd)) if os.path.isdir(rd)
            else None}


STATE = lambda cid: json.dumps({"ociVersion": "1.0.2", "id": cid,  # noqa
                                "status": "creating", "pid": 1,
                                "bundle": "/b"})

# name -> (agent serving?, pre-registered ids, hook args after --dir,
# stdin, then: start the agent and admit this id afterwards, or None)
HOOK_CASES = {
    "admitted": (True, [], ["--hbm-bytes", "1024"], STATE("ctr-a"), None),
    "denied": (True, ["ctr-a"], ["--hbm-bytes", "1024"], STATE("ctr-b"),
               None),
    "released": (True, ["ctr-a"], ["--release"], STATE("ctr-a"), None),
    "unreachable": (False, [], ["--hbm-bytes", "1024"], STATE("ctr-a"),
                    None),
    "tombstone": (False, ["ctr-a"], ["--release"], STATE("ctr-a"), "ctr-b"),
    "dir gone": (False, [], ["--release"], STATE("ctr-a"), None),
    "bad id": (True, [], ["--hbm-bytes", "1"], STATE("../ctr"), None),
    "no id": (True, [], ["--release"], "{}", None),
}


def hook_outcome(variant, case, monkeypatch, native_path=None) -> list:
    serving, registered, args, stdin, then = HOOK_CASES[case]
    module = jax_agent if variant == "jax" else pt_agent
    root = short_root()
    d = os.path.join(root, "agent")
    agent = None
    try:
        write_manifest(d, 1, 10 * GIB)
        state = module.TenancyState(d)
        for cid in registered:
            state.register(cid, 1024)
        if case == "dir gone":
            shutil.rmtree(d)
        if serving:
            agent = ThreadAgent(module, d)
        out = [run_hook(variant, ["--dir", d, *args], stdin, monkeypatch,
                        native_path), snapshot(d)]
        if agent is not None:
            agent.close()
            agent = None
        if then is not None:
            # The next agent applies the tombstone; the slot is free.
            agent = ThreadAgent(module, d)
            out += [snapshot(d), run_hook(
                variant, ["--dir", d, "--hbm-bytes", "1"], STATE(then),
                monkeypatch, native_path), snapshot(d)]
        return out
    finally:
        if agent is not None:
            agent.close()
        shutil.rmtree(root)


EXPECTED_CODES = {"admitted": 0, "denied": 1, "released": 0,
                  "unreachable": 1, "tombstone": 0, "dir gone": 0,
                  "bad id": 1, "no id": 0}


@pytest.mark.parametrize("variant", ["pt", "native"])
@pytest.mark.parametrize("case", sorted(HOOK_CASES))
def test_hooks_agree_with_the_reference(case, variant, monkeypatch,
                                        request):
    native_path = request.getfixturevalue("native") \
        if variant == "native" else None
    want = hook_outcome("jax", case, monkeypatch)
    got = hook_outcome(variant, case, monkeypatch, native_path)
    assert got == want
    assert got[0] == EXPECTED_CODES[case]
    if case == "tombstone":
        assert want[1]["tombstones"] == ["ctr-a"]
        assert want[2]["tombstones"] == [] and want[3] == 0
    if case == "dir gone":
        assert want[1] == {"dir": False}


def test_the_native_hook_refuses_a_path_past_sun_path(native):
    d = "/tmp/" + "x" * 110
    proc = subprocess.run([native, "--dir", d, "--hbm-bytes", "1"],
                          input=STATE("ctr-a"), capture_output=True,
                          text=True, timeout=30)
    assert proc.returncode == 1 and "agent unreachable" in proc.stderr


def test_a_failed_build_raises_with_the_compilers_words(monkeypatch,
                                                         tmp_path):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'cxx: no such luck' >&2\nexit 3\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(native_hook.HookBuildError,
                       match="(?s)exit 3.*cxx: no such luck"):
        native_hook.build()
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    monkeypatch.delenv("CXX")
    with pytest.raises(native_hook.HookBuildError, match="no C\\+\\+"):
        native_hook.find_compiler()


# -- end to end over the mock GPU and the fake MPS daemon ------------------

def agent_pids(root: str) -> list[int]:
    """The live agents whose directory lies under ``root``."""
    pids = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().decode(errors="replace").split("\0")
        except OSError:
            continue
        if sharing.AGENT_MODULE in argv and any(
                a.startswith(root) for a in argv) and \
                not process._gone(int(pid)):
            pids.append(int(pid))
    return pids


def supervisors() -> list[threading.Thread]:
    return [t for t in threading.enumerate()
            if t.name.startswith("supervisor-")]


def mps_claim_dict(uid, max_clients=1, limit="8Gi", device="gpu-0"):
    mt = {"hbmLimit": limit}
    if max_clients is not None:
        mt["maxClients"] = max_clients
    return make_claim_dict(
        uid, [device], driver=DRIVER_NAME, request="gpu",
        configs=[{"parameters": {
            "apiVersion": PT_API, "kind": "GpuConfig",
            "sharing": {"strategy": "MultiTenancy", "multiTenancy": mt}}}])


def mps_claim(*args, **kw) -> ResourceClaim:
    return ResourceClaim.from_dict(mps_claim_dict(*args, **kw))


class Plugin:
    """A port plugin with agents on over a short root."""

    def __init__(self):
        self.root = short_root()
        self.driver_root = write_fake_binaries(
            pathlib.Path(self.root) / "driver")
        self.states: list = []
        self.state = self.new()

    def config(self, gates=GATES, boot_id=BOOT, **kw):
        cfg = pt_ds.Config.mock(os.path.join(self.root, "s"), "h100-4",
                                gates, tenancy_agents=True, **kw)
        cfg.boot_id = boot_id
        cfg.driver_root = self.driver_root
        return cfg

    def new(self, cfg=None):
        state = pt_ds.DeviceState(cfg or self.config())
        self.states.append(state)
        return state

    def restart(self, cfg=None):
        self.state.close()
        self.state = self.new(cfg)
        return self.state

    def hooks(self, uid: str, device: str = "gpu-0") -> dict:
        spec = self.state._cdi.read_spec(uid)
        (edits,) = [d["containerEdits"] for d in spec["devices"]
                    if d["name"].startswith(device)]
        return {h["hookName"]: h for h in edits["hooks"]}

    def run(self, hook: dict, cid: str) -> subprocess.CompletedProcess:
        """``hook`` as a runtime runs it: its path, its args after
        argv[0], the OCI state on stdin."""
        return subprocess.run([hook["path"], *hook["args"][1:]],
                              input=STATE(cid), capture_output=True,
                              text=True, timeout=hook["timeout"])

    def close(self):
        for state in self.states:
            state.close()
        kill_fake_daemons(self.driver_root)
        left = agent_pids(self.root)
        for pid in left:
            os.kill(pid, signal.SIGKILL)
        shutil.rmtree(self.root, ignore_errors=True)
        assert left == [], "an agent was left running"
        assert supervisors() == [], "a supervisor thread was left"


@pytest.fixture()
def plugin(native):
    p = Plugin()
    yield p
    p.close()


def members(d: str) -> dict:
    return json.loads(pt_agent.query(d, "MEMBERS"))["clients"]


def test_prepare_starts_a_ready_agent_and_puts_both_hooks(plugin):
    st = plugin.state
    st.prepare(mps_claim("c1", max_clients=1, limit="8Gi"))
    d = st._tenancy.agent_dir("c1", "gpu")
    assert pt_agent.query(d, "STATUS") == "READY"
    assert agent_pids(plugin.root) == [int(read(f"{d}/agent.pid"))]
    assert st._tenancy.agent_count() == 1 and st._tenancy.active("c1")
    hooks = plugin.hooks("c1")
    binary = os.path.join(plugin.root, "s", "bin", "tenancy-preflight")
    assert hooks == {
        "createContainer": {"hookName": "createContainer", "path": binary,
                            "args": [binary, "--dir", d, "--hbm-bytes",
                                     str(8 * GIB)], "timeout": 10},
        "poststop": {"hookName": "poststop", "path": binary,
                     "args": [binary, "--dir", d, "--release"],
                     "timeout": 10}}
    with open(os.path.join(d, "tenancy.json")) as f:
        assert json.load(f) == {
            "claim": "c1", "request": "gpu", "chips": [0], "maxClients": 1,
            "hbmCapacityBytes": st.host.memory_bytes_per_chip,
            "hbmLimits": {"gpu-0": 8 * GIB}}
    assert len(d.encode()) + len("/agent.sock") == \
        len(os.path.join(plugin.root, "s")) + 32


def test_admit_deny_release_through_the_specs_hooks(plugin):
    plugin.state.prepare(mps_claim("c1", max_clients=1))
    hooks = plugin.hooks("c1")
    d = plugin.state._tenancy.agent_dir("c1", "gpu")
    assert plugin.run(hooks["createContainer"], "ctr-a").returncode == 0
    denied = plugin.run(hooks["createContainer"], "ctr-b")
    assert denied.returncode == 1
    assert "DENIED max clients (1) reached" in denied.stderr
    assert plugin.run(hooks["poststop"], "ctr-a").returncode == 0
    assert plugin.run(hooks["createContainer"], "ctr-b").returncode == 0
    assert members(d) == {"ctr-b": 8 * GIB}
    with open(os.path.join(d, "clients.json")) as f:
        assert json.load(f) == {"ctr-b": 8 * GIB}


def test_memory_past_the_gpus_is_denied(plugin):
    st = plugin.state
    st.prepare(mps_claim("c2", max_clients=None, limit="40Gi",
                         device="gpu-1"))
    hook = plugin.hooks("c2", "gpu-1")["createContainer"]
    assert hook["args"][-1] == str(40 * GIB)
    assert plugin.run(hook, "ctr-a").returncode == 0
    assert plugin.run(hook, "ctr-b").returncode == 0
    over = plugin.run(hook, "ctr-c")
    free = st.host.memory_bytes_per_chip - 80 * GIB
    assert over.returncode == 1 and over.stderr.strip() == (
        f"tenancy-preflight: DENIED HBM budget exceeded: {40 * GIB} "
        f"requested, {free} available")


def test_no_control_plane_file_lies_under_a_mount(plugin):
    st = plugin.state
    st.prepare(mps_claim("c1"))
    plugin.run(plugin.hooks("c1")["createContainer"], "ctr-a")
    d = st._tenancy.agent_dir("c1", "gpu")
    spec = st._cdi.read_spec("c1")
    mounts = [m["hostPath"] for e in [spec.get("containerEdits", {})]
              + [dd["containerEdits"] for dd in spec["devices"]]
              for m in e.get("mounts", [])]
    control = [os.path.join(d, n) for n in os.listdir(d)] + [d]
    assert {"agent.sock", "clients.json", "tenancy.json", "agent.pid"} <= \
        set(os.listdir(d))
    for path in control:
        real = os.path.realpath(path)
        assert not any(real == os.path.realpath(m) or real.startswith(
            os.path.realpath(m) + os.sep) for m in mounts), (path, mounts)


def test_a_restarted_plugin_reowns_the_agent_with_its_grants(plugin):
    plugin.state.prepare(mps_claim("c1", max_clients=2))
    d = plugin.state._tenancy.agent_dir("c1", "gpu")
    plugin.run(plugin.hooks("c1")["createContainer"], "ctr-a")
    before = int(read(f"{d}/agent.pid"))
    st = plugin.restart()
    assert process._gone(before)
    (pid,) = agent_pids(plugin.root)
    assert pid != before and int(read(f"{d}/agent.pid")) == pid
    assert st._tenancy.agent_count() == 1
    assert members(d) == {"ctr-a": 8 * GIB}
    # The spec survived, so prepare returns without touching the agent.
    assert st.prepare(mps_claim("c1", max_clients=2)) == [
        "nvidia.com/gpu=gpu-0"]
    assert agent_pids(plugin.root) == [pid]


def test_a_stale_agent_is_killed_before_the_respawn(plugin):
    plugin.state.prepare(mps_claim("c1"))
    d = plugin.state._tenancy.agent_dir("c1", "gpu")
    plugin.state.close()
    # A survivor the pidfile names (a missed parent-death signal).
    survivor = subprocess.Popen(
        sharing.MultiTenancyManager._agent_identity(d)
        + ["--parent-pid", str(os.getpid())],
        env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        deadline = time.monotonic() + 10
        while not os.path.exists(f"{d}/agent.sock") and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        with open(f"{d}/agent.pid", "w") as f:
            f.write(str(survivor.pid))
        plugin.state = plugin.new()
        assert survivor.wait(timeout=10) in (0, -signal.SIGTERM)
        (pid,) = agent_pids(plugin.root)
        assert pid != survivor.pid
    finally:
        if survivor.poll() is None:
            survivor.kill()
            survivor.wait()


def test_a_killed_agent_is_respawned_with_its_grants(plugin):
    plugin.state.prepare(mps_claim("c1", max_clients=1))
    hooks = plugin.hooks("c1")
    d = plugin.state._tenancy.agent_dir("c1", "gpu")
    assert plugin.run(hooks["createContainer"], "ctr-a").returncode == 0
    killed = int(read(f"{d}/agent.pid"))
    os.kill(killed, signal.SIGKILL)
    deadline = time.monotonic() + 10
    while True:
        pids = agent_pids(plugin.root)
        if pids and pids != [killed]:
            break
        assert time.monotonic() < deadline, "the agent was not respawned"
        time.sleep(0.02)
    deadline = time.monotonic() + 10
    while True:
        try:
            if pt_agent.query(d, "STATUS") == "READY":
                break
        except OSError:
            pass
        assert time.monotonic() < deadline
        time.sleep(0.02)
    assert members(d) == {"ctr-a": 8 * GIB}
    assert plugin.run(hooks["createContainer"], "ctr-b").returncode == 1


def test_an_unreachable_agent_fails_closed_and_a_tombstone_frees_the_slot(
        plugin):
    st = plugin.state
    st.prepare(mps_claim("c1", max_clients=1))
    hooks = plugin.hooks("c1")
    d = st._tenancy.agent_dir("c1", "gpu")
    assert plugin.run(hooks["createContainer"], "ctr-a").returncode == 0
    st.close()  # the plugin is down, and its agents with it
    assert plugin.run(hooks["createContainer"], "ctr-b").returncode == 1
    assert plugin.run(hooks["poststop"], "ctr-a").returncode == 0
    assert os.listdir(os.path.join(d, "released.d")) == ["ctr-a"]
    plugin.state = plugin.new()
    assert plugin.run(hooks["createContainer"], "ctr-b").returncode == 0
    assert members(d) == {"ctr-b": 8 * GIB}
    assert os.listdir(os.path.join(d, "released.d")) == []


def test_unprepare_leaves_no_agent_dir_or_socket(plugin):
    st = plugin.state
    st.prepare(mps_claim("c1"))
    d = st._tenancy.agent_dir("c1", "gpu")
    pid = int(read(f"{d}/agent.pid"))
    st.unprepare("c1")
    assert process._gone(pid) and agent_pids(plugin.root) == []
    assert not os.path.exists(d) and os.listdir(
        os.path.join(plugin.root, "s", "tenancy")) == []
    assert st._tenancy.agent_count() == 0 and not st._tenancy.active("c1")
    assert supervisors() == []


def test_a_failed_prepare_stops_the_agent_before_the_daemon(plugin,
                                                            monkeypatch):
    st = plugin.state
    order = []
    stop_agents, quit_ = st._tenancy.stop_agents, st._tenancy._quit
    monkeypatch.setattr(st._tenancy, "stop_agents", lambda uid: (
        order.append("agent"), stop_agents(uid)))
    monkeypatch.setattr(st._tenancy, "_quit", lambda d: (
        order.append("daemon"), quit_(d)))

    def fail(*a, **kw):
        raise OSError("disk full")
    monkeypatch.setattr(st._cdi, "create_claim_spec_file", fail)
    with pytest.raises(OSError, match="disk full"):
        st.prepare(mps_claim("c1"))
    assert order[:2] == ["agent", "daemon"]
    assert agent_pids(plugin.root) == [] and st.prepared_claims() == {}
    assert os.listdir(os.path.join(plugin.root, "s", "tenancy")) == []
    assert os.listdir(os.path.join(plugin.root, "s", "mps")) == []


def test_a_refused_daemon_starts_no_agent(plugin):
    open(os.path.join(plugin.driver_root, "mps.refuse"), "w").close()
    with pytest.raises(pt_ds.PrepareError, match="cannot start the daemon"):
        plugin.state.prepare(mps_claim("c1"))
    assert agent_pids(plugin.root) == []
    assert os.listdir(os.path.join(plugin.root, "s", "tenancy")) == []


def test_a_failed_hook_build_fails_the_prepare(plugin, monkeypatch,
                                               tmp_path):
    cxx = tmp_path / "cxx"
    cxx.write_text("#!/bin/sh\necho 'cxx: cannot link' >&2\nexit 1\n")
    cxx.chmod(0o755)
    monkeypatch.setenv("CXX", str(cxx))
    with pytest.raises(pt_ds.PrepareError, match="cxx: cannot link"):
        plugin.state.prepare(mps_claim("c1"))
    assert agent_pids(plugin.root) == [] and \
        plugin.state.prepared_claims() == {}
    assert not os.path.exists(os.path.join(plugin.root, "s", "bin",
                                           "tenancy-preflight"))


def test_a_lost_spec_under_a_live_agent_is_not_prepared_again(plugin):
    st = plugin.state
    st.prepare(mps_claim("c1"))
    pid = agent_pids(plugin.root)
    kill_fake_daemons(plugin.driver_root)  # only the agent runs now
    st._cdi.delete_claim_spec_file("c1")
    with pytest.raises(pt_ds.PrepareError, match="tenancy agent runs"):
        st.prepare(mps_claim("c1"))
    assert agent_pids(plugin.root) == pid
    st.unprepare("c1")
    assert agent_pids(plugin.root) == []


def test_orphan_agent_dirs_are_dropped_at_construction(plugin):
    st = plugin.state
    st.prepare(mps_claim("c1"))
    st.prepare(mps_claim("c2", device="gpu-1"))
    tenancy = os.path.join(plugin.root, "s", "tenancy")
    os.makedirs(os.path.join(tenancy, "no-manifest"))
    d2 = st._tenancy.agent_dir("c2", "gpu")
    # c2's record goes as if a crash lost it; its agent dir is an orphan.
    st._checkpoint.update_claim("c2", None)
    st = plugin.restart()
    assert sorted(os.listdir(tenancy)) == [os.path.basename(
        st._tenancy.agent_dir("c1", "gpu"))]
    assert not os.path.exists(d2) and len(agent_pids(plugin.root)) == 1


def test_a_boot_id_change_drops_every_agent_dir(plugin):
    plugin.state.prepare(mps_claim("c1"))
    st = plugin.restart(plugin.config(boot_id="boot-1"))
    assert st.prepared_claims() == {}
    assert os.listdir(os.path.join(plugin.root, "s", "tenancy")) == []
    assert agent_pids(plugin.root) == [] and st._tenancy.agent_count() == 0


def test_an_agent_started_from_a_thread_that_ends_lives_on(plugin):
    errors = []

    def prepare():
        try:
            plugin.state.prepare(mps_claim("c1"))
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)
    t = threading.Thread(target=prepare)
    t.start()
    t.join(timeout=30)
    assert not t.is_alive() and errors == []
    d = plugin.state._tenancy.agent_dir("c1", "gpu")
    time.sleep(0.3)  # a parent-death signal would have landed by now
    assert pt_agent.query(d, "STATUS") == "READY"
    assert len(agent_pids(plugin.root)) == 1


PLUGIN_CHILD = r"""
import json, sys, time
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import ResourceClaim
cfg = ds.Config.mock(sys.argv[1], "h100-4", sys.argv[2],
                     tenancy_agents=True)
cfg.driver_root = sys.argv[3]
st = ds.DeviceState(cfg)
st.prepare(ResourceClaim.from_dict(json.loads(sys.argv[4])))
print(open(st._tenancy.agent_dir("c1", "gpu") + "/agent.pid").read(),
      flush=True)
time.sleep(60)
"""


def test_the_agents_die_with_the_plugin(plugin):
    child = subprocess.Popen(
        [sys.executable, "-c", PLUGIN_CHILD,
         os.path.join(plugin.root, "child"), GATES, plugin.driver_root,
         json.dumps(mps_claim_dict("c1"))],
        cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT)),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        pid = int(child.stdout.readline() or 0)
        assert pid, child.stderr.read()
        assert not process._gone(pid)
    finally:
        child.kill()
        child.wait()
        child.stdout.close()
        child.stderr.close()
    deadline = time.monotonic() + 10
    while not process._gone(pid):
        assert time.monotonic() < deadline, "the agent outlived the plugin"
        time.sleep(0.02)


def test_a_root_too_long_for_the_sockets_fails_construction():
    root = os.path.join(short_root(), "r" * 80)
    try:
        cfg = pt_ds.Config.mock(root, "h100-4", GATES, tenancy_agents=True)
        with pytest.raises(ValueError, match="too long for the tenancy "
                           "agents' sockets"):
            pt_ds.DeviceState(cfg)
        # Without agents, or with MPS off, the same root constructs.
        pt_ds.DeviceState(pt_ds.Config.mock(root, "h100-4", GATES)).close()
        pt_ds.DeviceState(pt_ds.Config.mock(
            root, "h100-4", "", tenancy_agents=True)).close()
    finally:
        shutil.rmtree(os.path.dirname(root))


def test_an_oversubscribed_partition_tenant_gets_its_agent(plugin):
    ps = pt_partition.PartitionSet(profiles=(
        pt_partition.PartitionProfile("s2", "1g.10gb", 2, 0.9),))
    write_mig_caps(os.path.join(plugin.root, "s"), gpus=4)
    st = plugin.restart(plugin.config(PARTITION_GATES, mig_mode="enabled",
                                      partition_set=ps))
    claims = [ResourceClaim.from_dict(make_claim_dict(
        uid, ["pt-s2-0"], driver=DRIVER_NAME, request="gpu",
        configs=[{"parameters": {"apiVersion": PT_API,
                                 "kind": "MigDeviceConfig",
                                 "oversubscribe": True}}]))
        for uid in ("t1", "t2")]
    for claim in claims:
        st.prepare(claim)
    budget = st.allocatable["pt-s2-0"].partition.tenant_memory_bytes
    dirs = [st._tenancy.agent_dir(uid, "gpu") for uid in ("t1", "t2")]
    assert len(set(dirs)) == 2 and len(agent_pids(plugin.root)) == 2
    for uid, d in zip(("t1", "t2"), dirs):
        hooks = plugin.hooks(uid, "pt-s2-0")
        assert hooks["createContainer"]["args"][1:] == [
            "--dir", d, "--hbm-bytes", str(budget)]
        assert hooks["poststop"]["args"][1:] == ["--dir", d, "--release"]
        with open(os.path.join(d, "tenancy.json")) as f:
            assert json.load(f) == {
                "claim": uid, "request": "gpu", "chips": [0],
                "maxClients": None,
                "hbmCapacityBytes": st.host.memory_bytes_per_chip,
                "hbmLimits": {"pt-s2-0": budget}}
        # No client cap: two containers of one tenant are admitted.
        for cid in ("ctr-a", "ctr-b"):
            assert plugin.run(hooks["createContainer"],
                              f"{uid}-{cid}").returncode == 0
    st.unprepare("t1")
    assert not os.path.exists(dirs[0]) and os.path.exists(dirs[1])
    st.unprepare("t2")
    assert agent_pids(plugin.root) == []
    assert os.listdir(os.path.join(plugin.root, "s", "tenancy")) == []
    assert st.mig_registry() == {}
