"""The port's sharing managers against the JAX plugin's, over a fake
``nvidia-smi`` and a fake ``nvidia-cuda-mps-control``.

The fakes are scripts under a tmp driver root's ``usr/bin``, found as
the plugin finds the real ones (``cdi.find_binary``). The fake
``nvidia-smi`` logs each call to ``<root>/smi.log`` and refuses the GPUs
listed in ``<root>/smi.refuse`` as the H100 machine's container does
("Not Supported", exit 3). The fake control daemon (``-d``) forks into
its own session, logs its env and commands to
``$CUDA_MPS_LOG_DIRECTORY/control.log`` and answers on
``$CUDA_MPS_PIPE_DIRECTORY/control`` (bound by a relative path, so a long
tmp path does not matter); ``<root>/mps.refuse`` makes ``-d`` fail and
``<root>/mps.mute`` starts a daemon that never answers. Every fake daemon
is killed when its test ends.
"""

import json
import os
import random
import signal
import sys
import time

import pytest

from k8s_dra_driver_gpu_tpu.api.configs import \
    MultiTenancyConfig as JaxMultiTenancyConfig
from k8s_dra_driver_gpu_tpu.api.configs import \
    TimeSlicingConfig as JaxTimeSlicingConfig
from k8s_dra_driver_gpu_tpu.kubeletplugin import sharing as jax_sharing
from k8s_dra_driver_gpu_tpu_torch.api.configs import (MultiTenancyConfig,
                                                      TimeSlicingConfig)
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import sharing
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.cdi import find_binary

GIB = 1 << 30

# A shell script: the time-slicing tests call it hundreds of times.
FAKE_SMI = r'''#!/bin/sh
root=$(cd "$(dirname "$0")/../.." && pwd)
gpu=""; prev=""
for a in "$@"; do [ "$prev" = "-i" ] && gpu=$a; prev=$a; done
refused=false
if [ -f "$root/smi.refuse" ] && grep -qw -- "$gpu" "$root/smi.refuse"; then
    refused=true
fi
printf '{"argv": ["%s", "%s", "%s", "%s"], "refused": %s}\n' \
    "$1" "$2" "$3" "$4" $refused >> "$root/smi.log"
if $refused; then
    echo "Failed to set timeslice policy for GPU $gpu : Not Supported"
    echo "Failed to set timeslice for requested devices : Not Supported"
    exit 3
fi
'''

FAKE_MPS_CONTROL = r'''
import json, os, socket, sys, time
root = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
pipe = os.environ.get("CUDA_MPS_PIPE_DIRECTORY", "/tmp/nvidia-mps")
if sys.argv[1:] == ["-d"]:
    if os.path.exists(os.path.join(root, "mps.refuse")):
        print("fake: cannot start the daemon", file=sys.stderr)
        sys.exit(1)
    if os.fork():
        sys.exit(0)
    os.setsid()
    if os.fork():
        os._exit(0)
    null = os.open(os.devnull, os.O_RDWR)
    for fd in (0, 1, 2):
        os.dup2(null, fd)
    log = open(os.path.join(os.environ["CUDA_MPS_LOG_DIRECTORY"],
                            "control.log"), "a", buffering=1)
    log.write(json.dumps({"pid": os.getpid(), "env": {
        k: os.environ.get(k) for k in (
            "CUDA_VISIBLE_DEVICES", "CUDA_DEVICE_ORDER",
            "CUDA_MPS_PIPE_DIRECTORY", "CUDA_MPS_LOG_DIRECTORY")}}) + "\n")
    if os.path.exists(os.path.join(root, "mps.mute")):
        time.sleep(600)
        os._exit(0)
    os.chdir(pipe)
    server = socket.socket(socket.AF_UNIX)
    server.bind("control")
    server.listen(8)
    limits = {}
    while True:
        conn, _ = server.accept()
        command = conn.makefile().readline().strip()
        log.write(json.dumps({"command": command}) + "\n")
        name, *args = command.split() or [""]
        reply = ""
        if name == "get_default_active_thread_percentage":
            reply = "100.0"
        elif name == "set_default_device_pinned_mem_limit":
            limits[args[0]] = args[1]
        elif name == "get_default_device_pinned_mem_limit":
            reply = limits.get(args[0], "0")
        elif name not in ("get_server_list", "quit"):
            reply = f'Unknown command "{command}"'
        conn.sendall((reply + "\n" if reply else "").encode())
        conn.close()
        if name == "quit":
            os.unlink("control")
            os._exit(0)
else:
    for line in sys.stdin:
        try:
            os.chdir(pipe)
            conn = socket.socket(socket.AF_UNIX)
            conn.connect("control")
        except OSError:
            print("Cannot find MPS control daemon process", file=sys.stderr)
            sys.exit(1)
        conn.sendall(line.encode())
        sys.stdout.write(conn.makefile().read())
'''


def write_fake_binaries(root) -> str:
    """``nvidia-smi`` and ``nvidia-cuda-mps-control`` under
    ``root/usr/bin``; the root, as a string."""
    bin_dir = root / "usr" / "bin"
    bin_dir.mkdir(parents=True, exist_ok=True)
    for name, body in (("nvidia-smi", FAKE_SMI),
                       ("nvidia-cuda-mps-control",
                        f"#!{sys.executable}{FAKE_MPS_CONTROL}"),
                       ("nvidia-cuda-mps-server", "#!/bin/sh\n")):
        path = bin_dir / name
        path.write_text(body)
        path.chmod(0o755)
    return str(root)


def fake_daemon_pids(root: str) -> list[int]:
    """The live fake daemons started from ``root``'s binaries."""
    prefix = os.path.join(root, "usr", "bin")
    pids = []
    for pid in sharing.mps_pids():
        try:
            argv = sharing._proc_argv(str(pid))
        except OSError:
            continue
        if any(a.startswith(prefix) for a in argv[:2]) and sharing._alive(
                pid):
            pids.append(pid)
    return pids


def kill_fake_daemons(root: str) -> list[int]:
    """Kill what ``root``'s fakes left running; their pids."""
    left = fake_daemon_pids(root)
    for pid in left:
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    deadline = time.monotonic() + 5
    while fake_daemon_pids(root) and time.monotonic() < deadline:
        time.sleep(0.02)
    return left


@pytest.fixture()
def driver_root(tmp_path):
    root = write_fake_binaries(tmp_path / "driver")
    yield root
    kill_fake_daemons(root)


def smi_calls(root: str, refused: bool = False) -> list[list[str]]:
    """The argv of each nvidia-smi call that set a level, and of each
    refused one too with ``refused``."""
    try:
        with open(os.path.join(root, "smi.log")) as f:
            calls = [json.loads(line) for line in f]
    except FileNotFoundError:
        return []
    return [c["argv"] for c in calls if refused or not c["refused"]]


def daemon_log(d: str) -> list[dict]:
    with open(os.path.join(d, "log", "control.log")) as f:
        return [json.loads(line) for line in f]


# -- time-slicing ---------------------------------------------------------------

class TimeSlicing:
    """The two managers side by side."""

    def __init__(self, tmp_path, driver_root):
        self.root = driver_root
        self.jax = jax_sharing.TimeSlicingManager(str(tmp_path / "jax"))
        self.pt = sharing.TimeSlicingManager(
            str(tmp_path / "pt"), find_binary(driver_root, "nvidia-smi"))

    def set(self, uid, gpus, interval):
        self.jax.set_time_slice(uid, gpus,
                                JaxTimeSlicingConfig(interval=interval))
        return self.pt.set_time_slice(uid, gpus,
                                      TimeSlicingConfig(interval=interval))

    def release(self, uid, gpus):
        self.jax.release(uid, gpus)
        self.pt.release(uid, gpus)

    def records(self, gpus=range(4)):
        """Each GPU's (interval, holders) on both sides."""
        out = []
        for side in (self.jax, self.pt):
            docs = [side.current(i) for i in gpus]
            out.append([doc and (doc["interval"], doc["holders"])
                        for doc in docs])
        return out

    def levels(self, gpus=range(4)) -> list[int]:
        """Each GPU's level as the fake nvidia-smi last set it."""
        level = dict.fromkeys(gpus, 0)
        for argv in smi_calls(self.root):
            level[int(argv[argv.index("-i") + 1])] = int(
                argv[-1].split("=")[1])
        return [level[i] for i in gpus]


def expected_level(doc) -> int:
    """The level the JAX record asks of its GPU: its interval's while a
    holder asks for a non-default one."""
    if not doc or all(v == "Default" for v in doc["holders"].values()):
        return 0
    return sharing.TIMESLICE_LEVELS[doc["interval"]]


SEQUENCE = [
    ("set", "c1", [0, 1], "Default"),
    ("set", "c2", [1], "Long"),
    ("set", "c3", [1, 2], "Short"),
    ("release", "c3", [1, 2]),
    ("set", "c4", [1], "Default"),
    ("release", "c2", [1]),
    ("release", "c1", [0, 1]),
    ("release", "c4", [1]),
    ("set", "c5", [3], "Medium"),
    ("set", "c5", [3], "Medium"),
    ("release", "c5", [3]),
    ("release", "c5", [3]),
    ("release", "nope", [0]),
]


def _random_sequence(seed: int) -> list[tuple]:
    rng = random.Random(seed)
    ops = []
    for _ in range(14):
        uid = f"c{rng.randrange(4)}"
        gpus = sorted(rng.sample(range(4), rng.randint(1, 3)))
        if rng.random() < 0.6:
            ops.append(("set", uid, gpus, rng.choice(
                list(sharing.TIMESLICE_LEVELS))))
        else:
            ops.append(("release", uid, gpus))
    return ops


@pytest.mark.parametrize("ops", [SEQUENCE] + [
    _random_sequence(seed) for seed in range(8)],
    ids=["fixed"] + [f"seed{seed}" for seed in range(8)])
def test_records_and_levels_match_the_references(tmp_path, driver_root,
                                                 ops):
    ts = TimeSlicing(tmp_path, driver_root)
    for op in ops:
        before = len(smi_calls(driver_root))
        levels_before = ts.levels()
        if op[0] == "set":
            assert ts.set(*op[1:]).to_dict() == {}  # no env: the GPU's own
        else:
            ts.release(*op[1:])
        jax_records, pt_records = ts.records()
        assert pt_records == jax_records, op
        # nvidia-smi ran once for each GPU whose level changed, and only
        # then; the level is the one the JAX record asks for.
        want = [expected_level(ts.jax.current(i)) for i in range(4)]
        assert ts.levels() == want, op
        changed = sum(a != b for a, b in zip(levels_before, want))
        assert len(smi_calls(driver_root)) - before == changed, op
    for argv in smi_calls(driver_root):
        assert argv[:3] == ["compute-policy", "-i", argv[2]]
        assert argv[3] in {f"--set-timeslice={v}" for v in range(4)}


def test_a_plain_claim_spawns_no_process(tmp_path, driver_root):
    ts = TimeSlicing(tmp_path, driver_root)
    ts.set("c1", [0, 1, 2, 3], "Default")
    ts.release("c1", [0, 1, 2, 3])
    assert smi_calls(driver_root) == []
    # Without nvidia-smi too.
    bare = sharing.TimeSlicingManager(str(tmp_path / "bare"), None)
    bare.set_time_slice("c1", [0], TimeSlicingConfig())
    assert bare.current(0) == {"interval": "Default",
                               "holders": {"c1": "Default"}}


def test_a_refused_gpu_restores_the_others(tmp_path, driver_root):
    ts = TimeSlicing(tmp_path, driver_root)
    ts.pt.set_time_slice("c1", [0, 1], TimeSlicingConfig(interval="Long"))
    with open(os.path.join(driver_root, "smi.refuse"), "w") as f:
        f.write("2")
    before = [ts.pt.current(i) for i in range(4)]
    with pytest.raises(sharing.SharingError,
                       match="exited 3: .*GPU 2 : Not Supported"):
        ts.pt.set_time_slice("c2", [1, 3, 2],
                             TimeSlicingConfig(interval="Short"))
    assert [ts.pt.current(i) for i in range(4)] == before
    assert ts.levels() == [3, 3, 0, 0]
    # GPU 1 went to Short and back to Long, GPU 3 to Short and back.
    assert [argv[2:] for argv in smi_calls(driver_root, refused=True)][2:] \
        == [
        ["1", "--set-timeslice=1"], ["3", "--set-timeslice=1"],
        ["2", "--set-timeslice=1"], ["3", "--set-timeslice=0"],
        ["1", "--set-timeslice=3"]]


def test_without_nvidia_smi_a_level_is_refused(tmp_path):
    ts = sharing.TimeSlicingManager(str(tmp_path), None)
    with pytest.raises(sharing.SharingError, match="nvidia-smi not found"):
        ts.set_time_slice("c1", [0], TimeSlicingConfig(interval="Short"))
    assert ts.current(0) is None


def test_a_refused_reset_is_logged_and_the_record_goes(tmp_path,
                                                       driver_root, caplog):
    ts = TimeSlicing(tmp_path, driver_root)
    ts.pt.set_time_slice("c1", [0], TimeSlicingConfig(interval="Long"))
    with open(os.path.join(driver_root, "smi.refuse"), "w") as f:
        f.write("0")
    ts.pt.release("c1", [0])
    assert ts.pt.current(0) is None
    assert "GPU 0: timeslice not reset" in caplog.text


# -- MPS ------------------------------------------------------------------------

def _cfg(cls, max_clients=2, hbm_limit="8Gi", per_device=None):
    cfg = cls(max_clients=max_clients, hbm_limit=hbm_limit,
              per_device_hbm_limits=dict(per_device or {}))
    cfg.normalize()
    return cfg


def manager(tmp_path, driver_root, **kwargs) -> sharing.MultiTenancyManager:
    return sharing.MultiTenancyManager(
        str(tmp_path / "pt"), hbm_capacity_bytes=80 * GIB,
        control_binary=find_binary(driver_root, sharing.MPS_CONTROL),
        **kwargs)


def request_dir(mt, uid, request) -> str:
    return os.path.join(mt._root, mt.dir_name(uid, request))


@pytest.mark.parametrize("max_clients, hbm_limit, per_device", [
    (2, "8Gi", None),
    (None, None, None),
    (3, "8Gi", {"gpu-0": "2Gi"}),
    (1, None, {"gpu-1": "512Mi"}),
    (4, "1048576", None),
])
def test_manifest_equals_the_references(tmp_path, driver_root, max_clients,
                                        hbm_limit, per_device):
    names = ["gpu-0", "gpu-1"]
    jax_mt = jax_sharing.MultiTenancyManager(
        str(tmp_path / "jax"), hbm_capacity_bytes=80 * GIB,
        spawn_agents=False)
    jax_mt.start("c1", "gpu", [0, 1], _cfg(JaxMultiTenancyConfig,
                                           max_clients, hbm_limit,
                                           per_device), names)
    with open(tmp_path / "jax" / "tenancy" / "c1" / "gpu"
              / "tenancy.json") as f:
        want = json.load(f)
    mt = manager(tmp_path, driver_root)
    edits = mt.start("c1", "gpu", [0, 1], _cfg(MultiTenancyConfig,
                                               max_clients, hbm_limit,
                                               per_device), names)
    d = request_dir(mt, "c1", "gpu")
    # One manifest: the JAX one's fields, the owner and the daemon's
    # settings.
    with open(os.path.join(d, "claim.json")) as f:
        got = json.load(f)
    assert {k: got[k] for k in want} == want
    assert got.keys() - want.keys() == {"claim", "request", "visibleDevices",
                                        "pinnedMemLimits"}
    assert sorted(os.listdir(d)) == ["claim.json", "log", "pipe"]
    # The daemon: the request's GPUs, its own dirs, a limit a device.
    first, *commands = daemon_log(d)
    assert first["env"] == {
        "CUDA_VISIBLE_DEVICES": "0,1", "CUDA_DEVICE_ORDER": "PCI_BUS_ID",
        "CUDA_MPS_PIPE_DIRECTORY": os.path.join(d, "pipe"),
        "CUDA_MPS_LOG_DIRECTORY": os.path.join(d, "log")}
    limits = {i: want["hbmLimits"][name] for i, name in enumerate(names)
              if want["hbmLimits"][name] is not None}
    assert [c["command"] for c in commands] == [
        "get_default_active_thread_percentage"] + [
        f"set_default_device_pinned_mem_limit {i} {b >> 20}M"
        for i, b in limits.items()]
    # The container: the pipe dir, read-write, and the same limits.
    container = f"/var/run/nvidia-mps/{os.path.basename(d)}"
    env = [f"CUDA_MPS_PIPE_DIRECTORY={container}"]
    if limits:
        env.append("CUDA_MPS_PINNED_DEVICE_MEM_LIMIT=" + ",".join(
            f"{i}={b >> 20}M" for i, b in limits.items()))
    assert edits.env == env
    assert edits.mounts == [(os.path.join(d, "pipe"), container, False)]
    assert mt.command("c1", "gpu", "get_default_device_pinned_mem_limit 0") \
        == (f"{limits[0] >> 20}M\n" if 0 in limits else "0\n")
    mt.stop("c1")


def test_the_limits_are_in_the_daemons_numbering(tmp_path, driver_root):
    # Request "b" holds GPUs 3 and 1: the daemon sees them as 0, 1 (GPU 1,
    # GPU 3), and so do its clients.
    mt = manager(tmp_path, driver_root)
    cfg = _cfg(MultiTenancyConfig, per_device={"gpu-3": "2Gi"})
    edits = mt.start("c1", "b", [3, 1], cfg, ["gpu-3", "gpu-1"])
    assert edits.env[1] == "CUDA_MPS_PINNED_DEVICE_MEM_LIMIT=0=8192M,1=2048M"
    first, *commands = daemon_log(request_dir(mt, "c1", "b"))
    assert first["env"]["CUDA_VISIBLE_DEVICES"] == "1,3"
    assert [c["command"] for c in commands][1:] == [
        "set_default_device_pinned_mem_limit 0 8192M",
        "set_default_device_pinned_mem_limit 1 2048M"]
    mt.stop("c1")


def test_stop_quits_the_daemon_and_removes_the_dir(tmp_path, driver_root):
    mt = manager(tmp_path, driver_root)
    mt.start("c1", "gpu", [0], _cfg(MultiTenancyConfig), ["gpu-0"])
    d = request_dir(mt, "c1", "gpu")
    pids = sharing.mps_pids(os.path.join(d, "pipe"))
    assert len(pids) == 1 and mt.active("c1")
    mt.stop("c1")
    assert not any(map(sharing._alive, pids))
    assert not os.path.exists(d) and not mt.active("c1")
    mt.stop("c1")  # idempotent


def test_stop_is_per_claim(tmp_path, driver_root):
    mt = manager(tmp_path, driver_root)
    for uid in ("c1", "c2"):
        mt.start(uid, "gpu", [0], _cfg(MultiTenancyConfig), ["gpu-0"])
    mt.stop("c1")
    assert not mt.active("c1") and mt.active("c2")
    assert os.path.isdir(request_dir(mt, "c2", "gpu"))
    assert len(fake_daemon_pids(driver_root)) == 1
    mt.stop("c2")
    assert fake_daemon_pids(driver_root) == []


def test_reconcile_drops_orphans_and_reowns_live_ones(tmp_path, driver_root):
    mt = manager(tmp_path, driver_root)
    for uid in ("live", "dead", "orphan"):
        mt.start(uid, "gpu", [0], _cfg(MultiTenancyConfig), ["gpu-0"])
    live = sharing.mps_pids(os.path.join(request_dir(mt, "live", "gpu"),
                                         "pipe"))
    dead = sharing.mps_pids(os.path.join(request_dir(mt, "dead", "gpu"),
                                         "pipe"))
    os.kill(dead[0], signal.SIGKILL)
    while sharing._alive(dead[0]):
        time.sleep(0.01)
    # A directory a crashed start left without its owner is an orphan.
    os.makedirs(os.path.join(mt._root, "0123456789ab", "pipe"))
    # The plugin restarts: a new manager over the same root.
    again = manager(tmp_path, driver_root)
    again.reconcile({"live", "dead"})
    assert sorted(os.listdir(mt._root)) == sorted(
        os.path.basename(request_dir(mt, uid, "gpu"))
        for uid in ("live", "dead"))
    # The live daemon is left alone; the dead one runs again with its
    # limits; the orphan's is gone.
    assert sharing.mps_pids(os.path.join(request_dir(mt, "live", "gpu"),
                                         "pipe")) == live
    assert daemon_log(request_dir(mt, "live", "gpu"))[1:] == [
        {"command": "get_default_active_thread_percentage"},
        {"command": "set_default_device_pinned_mem_limit 0 8192M"}]
    assert again.active("dead") and not again.active("orphan")
    assert again.command("dead", "gpu",
                         "get_default_device_pinned_mem_limit 0") == "8192M\n"
    assert len(fake_daemon_pids(driver_root)) == 2
    again.reconcile(set())
    assert os.listdir(mt._root) == [] and fake_daemon_pids(driver_root) == []


def test_several_requests_of_one_claim(tmp_path, driver_root):
    mt = manager(tmp_path, driver_root)
    mt.start("c1", "r0", [0], _cfg(MultiTenancyConfig), ["gpu-0"])
    mt.start("c1", "r1", [1], _cfg(MultiTenancyConfig), ["gpu-1"])
    dirs = [request_dir(mt, "c1", r) for r in ("r0", "r1")]
    assert dirs[0] != dirs[1] and all(map(os.path.isdir, dirs))
    assert len(fake_daemon_pids(driver_root)) == 2
    assert [daemon_log(d)[0]["env"]["CUDA_VISIBLE_DEVICES"]
            for d in dirs] == ["0", "1"]
    mt.stop("c1")
    assert not any(map(os.path.exists, dirs))
    assert fake_daemon_pids(driver_root) == []


@pytest.mark.parametrize("knob, match", [
    ("mps.refuse", "-d exited 1: fake: cannot start the daemon"),
    ("mps.mute", "not ready after 0.5 s: Cannot find MPS control daemon"),
])
def test_a_daemon_that_does_not_start_raises(tmp_path, driver_root, knob,
                                             match):
    open(os.path.join(driver_root, knob), "w").close()
    mt = manager(tmp_path, driver_root, timeout=0.5)
    with pytest.raises(sharing.SharingError, match=match):
        mt.start("c1", "gpu", [0], _cfg(MultiTenancyConfig), ["gpu-0"])
    # The caller's rollback.
    mt.stop("c1")
    assert os.listdir(mt._root) == [] and fake_daemon_pids(driver_root) == []


def test_without_the_control_binary_mps_is_refused(tmp_path):
    mt = sharing.MultiTenancyManager(str(tmp_path), 80 * GIB, None)
    with pytest.raises(sharing.SharingError,
                       match="nvidia-cuda-mps-control not found"):
        mt.start("c1", "gpu", [0], _cfg(MultiTenancyConfig), ["gpu-0"])
    assert os.listdir(mt._root) == []


@pytest.mark.parametrize("uid, req", [
    ("c1", "gpu"),
    ("0b5a3c6e-1f2d-4e8a-9c7b-123456789abc", "r" * 63),
    ("x" * 253, "gpu-" * 15),
])
def test_pipe_paths_stay_short(tmp_path, uid, req):
    # The pipe dir's sockets are len(root) + 31 bytes whatever the names:
    # under AF_UNIX's 108 for a plugin root up to 76 bytes, such as the
    # upstream's /var/lib/kubelet/plugins/gpu.nvidia.com (39).
    for root in (str(tmp_path), "/var/lib/kubelet/plugins/gpu.nvidia.com"):
        mt = sharing.MultiTenancyManager.__new__(sharing.MultiTenancyManager)
        mt._root = os.path.join(root, "mps")
        d = mt._dir(uid, req)
        for sock in ("control", "control_privileged"):
            path = os.path.join(mt.pipe_dir(d), sock)
            assert len(path) <= len(root) + 31 + len(sock) - len("control")
        if len(root) <= 76:
            assert len(os.path.join(mt.pipe_dir(d), "control")) < 108
    container = f"{sharing.MPS_CONTAINER_ROOT}/{mt.dir_name(uid, req)}"
    assert len(container + "/control_privileged") < 108


# -- memory limits in whole MiB (ROADMAP.md §3 item 10) -------------------------


@pytest.mark.parametrize("hbm_limit, per_device", [
    ("1000000", None), ("0", None), ("1572865", None),
    ("8Gi", {"gpu-1": "1572865"}), (None, {"gpu-0": "0Mi"})])
def test_a_limit_that_is_no_whole_mib_is_refused(tmp_path, driver_root,
                                                 hbm_limit, per_device):
    # A prepare through the plugin: refused, naming the request and the
    # value, with no manifest, daemon or spec left behind.
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import \
        ResourceClaim
    from tests.fake_kube import make_claim_dict

    cfg = device_state.Config.mock(
        str(tmp_path / "state"), topology="h100-4",
        gates="TimeSlicingSettings=true,MultiTenancySupport=true")
    cfg.driver_root = driver_root
    state = device_state.DeviceState(cfg)
    multi = {"maxClients": 2}
    if hbm_limit is not None:
        multi["hbmLimit"] = hbm_limit
    if per_device:
        multi["perDeviceHbmLimits"] = per_device
    claim = ResourceClaim.from_dict(make_claim_dict(
        "c1", ["gpu-0", "gpu-1"], driver="gpu.nvidia.com", request="gpu",
        configs=[{"parameters": {
            "apiVersion": "resource.nvidia.com/v1beta1", "kind": "GpuConfig",
            "sharing": {"strategy": "MultiTenancy",
                        "multiTenancy": multi}}}]))
    bad = [v for v in [hbm_limit, *(per_device or {}).values()]
           if v not in ("8Gi", None)][0]
    with pytest.raises(device_state.PrepareError,
                       match=f"request 'gpu': hbmLimit '{bad}' of gpu-.* "
                             "whole MiB"):
        state.prepare(claim)
    assert state.prepared_claims() == {}
    assert not state._cdi.spec_exists("c1")
    assert os.listdir(state._tenancy._root) == []
    assert fake_daemon_pids(driver_root) == []


@pytest.mark.parametrize("hbm_limit, pinned", [("8Gi", "8192M"),
                                               ("512Mi", "512M"),
                                               ("1048576", "1M")])
def test_a_whole_mib_limit_is_pinned_unchanged(tmp_path, driver_root,
                                               hbm_limit, pinned):
    mt = manager(tmp_path, driver_root)
    edits = mt.start("c1", "gpu", [0], _cfg(MultiTenancyConfig,
                                            hbm_limit=hbm_limit), ["gpu-0"])
    assert edits.env[-1] == f"CUDA_MPS_PINNED_DEVICE_MEM_LIMIT=0={pinned}"
    with open(os.path.join(request_dir(mt, "c1", "gpu"),
                           "claim.json")) as f:
        owner = json.load(f)
    assert owner["pinnedMemLimits"] == {"0": pinned}
    assert owner["hbmLimits"]["gpu-0"] == int(pinned[:-1]) << 20
    mt.stop("c1")
