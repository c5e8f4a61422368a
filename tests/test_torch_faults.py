"""The port's fault injection (``pkg/faults.py`` and its seams) against
the JAX package's, on the CPU.

- **The registry**, after ``tests/test_faults.py``'s ``TestRegistry``:
  each case runs on both modules and must give the same outcome (what
  raised, its type's name and message, the snapshot), and seeded
  probabilities fire in the same sequence (both draw from
  ``random.Random(seed)``), over numpy-seeded random schedules of arm,
  fire and disarm too.
- **The seams**, one case each: the same point armed on both sides gives
  the same exception (type name in each package's terms and message) and
  leaves the same state. The device library's points on the mock (JAX
  ``PyTpuLib`` and the port's ``PyGpuLib``) and on the port's NVML over
  the fake ``libnvidia-ml.so.1``; the checkpoint (the JAX manager's
  group commit wraps the fault in ``RuntimeError("checkpoint group
  commit failed")``; the port has no group commit, so its write raises
  the fault itself: the fault, the JAX error's cause, is compared); the
  health poll; the flock; ``kube.request`` through the retrying client
  and ``classify``; ``kube.watch`` against the port's fake API server;
  the segment timer (the fault point and the crash and stall env knobs);
  the partition engine's create and destroy in the crash scenarios of
  ``tests/test_torch_partition.py``, armed now through the port's own
  registry; and the rendezvous handler.
"""

import os
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from k8s_dra_driver_gpu_tpu.computedomain.daemon import \
    rendezvous as jax_rendezvous
from k8s_dra_driver_gpu_tpu.kubeletplugin import checkpoint as jax_ckpt
from k8s_dra_driver_gpu_tpu.kubeletplugin import health as jax_health
from k8s_dra_driver_gpu_tpu.pkg import faults as jax_faults
from k8s_dra_driver_gpu_tpu.pkg import flock as jax_flock
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg import retry as jax_retry
from k8s_dra_driver_gpu_tpu.pkg import timing as jax_timing
from k8s_dra_driver_gpu_tpu.tpulib import binding as jax_tpulib
from k8s_dra_driver_gpu_tpu_torch.computedomain.daemon import \
    rendezvous as pt_rendezvous
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import checkpoint as pt_ckpt
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import health as pt_health
from k8s_dra_driver_gpu_tpu_torch.pkg import faults as pt_faults
from k8s_dra_driver_gpu_tpu_torch.pkg import flock as pt_flock
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import retry as pt_retry
from k8s_dra_driver_gpu_tpu_torch.pkg import timing as pt_timing
from k8s_dra_driver_gpu_tpu_torch.pkg.fakeapiserver import FakeApiServer
from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as pt_tpulib
from tests.test_torch_computedomain import \
    nothing_left_behind  # noqa: F401 - autouse: no thread or child left
from tests.test_torch_kubeletplugin_health import build_fake_nvml
from tests.test_torch_partition import SCENARIOS, Side, run_steps
from tests.test_torch_partition import sides  # noqa: F401 - the fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAULTS = {"jax": jax_faults, "pt": pt_faults}
# The exception types of the two device libraries, in the port's terms.
NEUTRAL_TYPES = {"TpuLibError": "GpuLibError"}


@pytest.fixture(autouse=True)
def clean_registries():
    for f in FAULTS.values():
        f.reset()
    yield
    for f in FAULTS.values():
        f.reset()


def outcome(fn):
    """What ``fn()`` did: ("ok", result) or ("raised", type name in the
    port's terms, message)."""
    try:
        return ("ok", fn())
    except BaseException as e:  # noqa: BLE001 - the outcome compared
        name = type(e).__name__
        return ("raised", NEUTRAL_TYPES.get(name, name), str(e))


def both(fn):
    """``fn(side, faults_module)`` on each side: the two outcomes."""
    return {side: outcome(lambda side=side: fn(side, FAULTS[side]))
            for side in FAULTS}


def same(fn):
    got = both(fn)
    assert got["pt"] == got["jax"], got
    return got["pt"]


# -- the registry --------------------------------------------------------------

def test_constants_equal_the_references():
    assert pt_faults.ENV_FAULTS == jax_faults.ENV_FAULTS
    assert pt_faults.ENV_FAULTS_SEED == jax_faults.ENV_FAULTS_SEED
    assert pt_faults._MODES == jax_faults._MODES
    assert issubclass(pt_faults.InjectedCrash, BaseException)
    assert not issubclass(pt_faults.InjectedCrash, Exception)
    assert issubclass(pt_faults.InjectedFault, RuntimeError)


def _crash_not_swallowed(f):
    f.arm("p1", mode="crash")
    try:
        f.fault_point("p1")
    except Exception:  # noqa: BLE001 - must not catch it
        return "swallowed"
    return "no fire"


REGISTRY_CASES = {
    "unarmed point is a no-op": lambda f: f.fault_point("nothing.armed"),
    "error mode's default exception": lambda f: (
        f.arm("p1", mode="error"), f.fault_point("p1")),
    "error mode's call-site factory": lambda f: (
        f.arm("p1", mode="error"),
        f.fault_point("p1", error=lambda m: OSError(m))),
    "crash mode is a BaseException": _crash_not_swallowed,
    "exit mode's spec parses": lambda f: f.FaultSpec.parse(
        "p:exit:count=1").mode,
    "message override": lambda f: (
        f.arm("p1", message="boom"), f.fault_point("p1")),
    "unknown mode rejected": lambda f: f.FaultSpec(point="p",
                                                   mode="teleport"),
    "empty spec rejected": lambda f: f.FaultSpec.parse(" : "),
    "bad key rejected": lambda f: f.FaultSpec.parse("p:error:bogus=1"),
}


@pytest.mark.parametrize("case", sorted(REGISTRY_CASES))
def test_registry_outcome_equals_the_references(case):
    same(lambda side, f: (REGISTRY_CASES[case](f), f.snapshot()))


def test_count_caps_fires():
    def run(side, f):
        f.arm("p1", mode="error", count=2)
        got = [outcome(lambda: f.fault_point("p1"))[0] for _ in range(3)]
        return got, f.snapshot()
    assert same(run)[1][0] == ["raised", "raised", "ok"]


def test_after_skips_first_evaluations():
    def run(side, f):
        f.arm("p1", mode="error", after=2)
        return ([outcome(lambda: f.fault_point("p1"))[0]
                 for _ in range(4)], f.snapshot())
    assert same(run)[1][0] == ["ok", "ok", "raised", "raised"]


def test_latency_mode_sleeps_and_continues():
    def run(side, f):
        f.arm("p1", mode="latency", latency=0.05)
        t0 = time.monotonic()
        f.fault_point("p1")
        return time.monotonic() - t0 >= 0.04, f.snapshot()
    assert same(run)[1][0] is True


def test_inject_context_manager_disarms():
    def run(side, f):
        with f.inject("p1", mode="error"):
            inside = outcome(lambda: f.fault_point("p1"))
        return inside, outcome(lambda: f.fault_point("p1")), f.snapshot()
    got = same(run)[1]
    assert got[0][0] == "raised" and got[1] == ("ok", None)


@pytest.mark.parametrize("seed", [0, 7, 8, 20260803])
@pytest.mark.parametrize("p", [0.1, 0.5, 0.9])
def test_seeded_probability_fires_in_the_same_sequence(seed, p):
    def schedule(side, f):
        reg = f.FaultRegistry(seed=seed)
        reg.arm(f.FaultSpec(point="p", probability=p))
        return [outcome(lambda: reg.fire("p"))[0] for _ in range(64)]
    fired = same(schedule)[1]
    if p == 0.5:
        assert 0 < fired.count("raised") < 64  # really probabilistic


def test_reseed_restarts_the_sequence():
    def run(side, f):
        f.arm("p", probability=0.5)
        f.reseed(3)
        a = [outcome(lambda: f.fault_point("p"))[0] for _ in range(16)]
        f.reseed(3)
        b = [outcome(lambda: f.fault_point("p"))[0] for _ in range(16)]
        return a, b
    a, b = same(run)[1]
    assert a == b


@pytest.mark.parametrize("env, armed", [
    ({"TPU_DRA_FAULTS": "kube.request:error:p=0.3:count=5;"
      "ckpt.fsync:crash:count=1;flock.acquire:latency:latency=0.01",
      "TPU_DRA_FAULTS_SEED": "42"}, 3),
    ({"TPU_DRA_FAULTS": "p:badmode;q:error:bogus=1;ok:error"}, 1),
    ({"TPU_DRA_FAULTS": "a;b:crash:after=2;;c:latency:latency=0",
      "TPU_DRA_FAULTS_SEED": "x"}, 3),
    ({}, 0),
])
def test_env_grammar_equals_the_references(env, armed):
    def run(side, f):
        reg = f.FaultRegistry()
        n = reg.configure_from_env(env)
        specs = {k: vars(v) for k, v in reg._specs.items()}
        return n, reg.snapshot(), specs
    assert same(run)[1][0] == armed


@pytest.mark.parametrize("seed", range(4))
def test_random_schedules_replay_alike(seed):
    """Seeded random sequences of arm, fire and disarm over a few
    points give the same outcome and snapshot after every step."""
    rng = np.random.default_rng(seed)
    points = ["a", "b", "c"]
    steps = []
    for _ in range(60):
        op = rng.choice(["arm", "fire", "fire", "fire", "disarm"])
        pt = str(rng.choice(points))
        if op == "arm":
            steps.append(("arm", pt, str(rng.choice(
                ["error", "crash", "latency"])), float(rng.choice(
                    [1.0, 0.5, 0.25])), int(rng.integers(0, 4)) or None,
                int(rng.integers(0, 3))))
        else:
            steps.append((op, pt))
    regs = {side: f.FaultRegistry(seed=seed) for side, f in FAULTS.items()}
    for i, step in enumerate(steps):
        got = {}
        for side, f in FAULTS.items():
            reg = regs[side]
            if step[0] == "arm":
                _, pt, mode, p, count, after = step
                got[side] = outcome(lambda: reg.arm(f.FaultSpec(
                    point=pt, mode=mode, probability=p, count=count,
                    after=after)))
            elif step[0] == "fire":
                got[side] = outcome(lambda: reg.fire(step[1]))
            else:
                got[side] = outcome(lambda: reg.disarm(step[1]))
            got[side] = (got[side], reg.snapshot())
        assert got["pt"] == got["jax"], (i, step)


def test_env_arms_the_port_at_import(tmp_path):
    """``TPU_DRA_FAULTS`` in a process's env arms its registry at import,
    and a seam of the port fires from it."""
    code = ("from k8s_dra_driver_gpu_tpu_torch.pkg import faults\n"
            "from k8s_dra_driver_gpu_tpu_torch.tpulib import binding\n"
            "print(faults.snapshot()['armed'])\n"
            "try:\n"
            "    binding.PyGpuLib().health(binding.EnumerateOptions("
            "mock_topology='h100-4'))\n"
            "except binding.GpuLibError as e:\n"
            "    print('raised', e)\n")
    env = dict(os.environ, PYTHONPATH=ROOT,
               TPU_DRA_FAULTS="tpulib.health:error:count=1;x:latency")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stderr
    assert out.stdout.splitlines() == [
        "['tpulib.health', 'x']",
        "raised injected fault at tpulib.health"]


# -- the seams: the device library ---------------------------------------------

def _lib(side):
    if side == "jax":
        return (jax_tpulib.PyTpuLib(),
                jax_tpulib.EnumerateOptions(mock_topology="v5e-4"))
    return (pt_tpulib.PyGpuLib(),
            pt_tpulib.EnumerateOptions(mock_topology="h100-4"))


@pytest.mark.parametrize("point, call", [
    ("tpulib.enumerate", lambda lib, o: len(lib.enumerate(o).chips)),
    ("tpulib.health", lambda lib, o: lib.health(o)),
    ("tpulib.telemetry", lambda lib, o: lib.chip_telemetry(o)),
    ("tpulib.tenant_usage", lambda lib, o: lib.tenant_usage(o)),
])
def test_device_library_seams_on_the_mock(point, call):
    def run(side, f):
        lib, opts = _lib(side)
        with f.inject(point, mode="error"):
            armed = outcome(lambda: call(lib, opts))
        return armed, outcome(lambda: call(lib, opts)), f.snapshot()
    got = same(run)[1]
    assert got[0] == ("raised", "GpuLibError", f"injected fault at {point}")
    assert got[1][0] == "ok"


@pytest.fixture(scope="module")
def fake_nvml(tmp_path_factory):
    return build_fake_nvml(tmp_path_factory.mktemp("faults_nvml"))


@pytest.mark.parametrize("point, call", [
    ("tpulib.enumerate", lambda lib: len(lib.enumerate().chips)),
    ("tpulib.health", lambda lib: lib.health()),
    ("tpulib.telemetry", lambda lib: len(lib.chip_telemetry())),
])
def test_device_library_seams_on_nvml(point, call, fake_nvml, monkeypatch):
    """The port's NVML backend has the points too, with the message and
    type the JAX mock gives."""
    import ctypes

    for var in ("FAKE_NVML_LOST", "FAKE_NVML_NO_PCI", "FAKE_NVML_INIT_RC"):
        monkeypatch.delenv(var, raising=False)
    ctypes.CDLL(fake_nvml).fake_reset()
    lib = pt_tpulib.NvmlLib(fake_nvml)
    lib.allow_beside_cuda = True  # the test process may hold CUDA
    try:
        with pt_faults.inject(point, mode="error"):
            armed = outcome(lambda: call(lib))
        after = outcome(lambda: call(lib))
    finally:
        lib.close()
    jax_lib, opts = _lib("jax")
    with jax_faults.inject(point, mode="error"):
        ref = outcome(lambda: jax_lib.health(opts) if point ==
                      "tpulib.health" else jax_lib.chip_telemetry(opts)
                      if point == "tpulib.telemetry"
                      else jax_lib.enumerate(opts))
    assert armed == ref == ("raised", "GpuLibError",
                            f"injected fault at {point}")
    assert after[0] == "ok"


# -- the seams: checkpoint, health, flock, segments -----------------------------

CKPT = {"jax": jax_ckpt, "pt": pt_ckpt}


@pytest.mark.parametrize("point", ["ckpt.write", "ckpt.fsync"])
def test_checkpoint_seams_fail_the_write_cleanly(point, tmp_path):
    def run(side, f):
        mod = CKPT[side]
        cm = mod.CheckpointManager(str(tmp_path / side), boot_id="b1")
        cm.update_claim("keep", mod.CheckpointedClaim(
            uid="keep", state="PrepareStarted"))
        with f.inject(point, mode="error"):
            try:
                cm.update_claim("lost", mod.CheckpointedClaim(
                    uid="lost", state="PrepareStarted"))
                fault = None
            except BaseException as e:  # noqa: BLE001 - compared
                # The JAX group commit's RuntimeError carries the fault
                # as its cause; the port raises the fault itself.
                fault = e.__cause__ if side == "jax" else e
        survivors = set(cm.get().claims)
        fresh = set(mod.CheckpointManager(str(tmp_path / side),
                                          boot_id="b1").get().claims)
        return (type(fault).__name__, str(fault), survivors, fresh,
                f.snapshot())
    got = same(run)[1]
    assert got[:4] == ("OSError", f"injected fault at {point}", {"keep"},
                       {"keep"})


def test_health_poll_seam():
    def run(side, f):
        if side == "jax":
            mon = jax_health.ChipHealthMonitor(
                jax_tpulib.PyTpuLib(),
                jax_tpulib.EnumerateOptions(mock_topology="v5e-4"),
                lambda t: None)
        else:
            mon = pt_health.ChipHealthMonitor(
                pt_tpulib.PyGpuLib(),
                pt_tpulib.EnumerateOptions(mock_topology="h100-4"),
                lambda t: None)
        with f.inject("health.poll", mode="error", count=1):
            armed = outcome(mon.poll_and_reconcile)
        return armed, outcome(mon.poll_and_reconcile), f.snapshot()
    got = same(run)[1]
    assert got[0] == ("raised", "InjectedFault",
                      "injected fault at health.poll")
    assert got[1] == ("ok", [])


def test_health_poll_seam_never_kills_the_thread():
    """``error`` at the poll backs the thread off; disarmed, it polls
    again (both monitors' ``_run``)."""
    def run(side, f):
        mon = (jax_health.ChipHealthMonitor(
            jax_tpulib.PyTpuLib(),
            jax_tpulib.EnumerateOptions(mock_topology="v5e-4"),
            lambda t: None, poll_interval=0.01) if side == "jax" else
            pt_health.ChipHealthMonitor(
                pt_tpulib.PyGpuLib(),
                pt_tpulib.EnumerateOptions(mock_topology="h100-4"),
                lambda t: None, poll_interval=0.01))
        f.arm("health.poll", mode="error", count=2)
        mon.start()
        deadline = time.monotonic() + 10
        while f.snapshot()["evaluations"].get("health.poll", 0) < 3 and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        alive = mon._thread.is_alive()
        mon.stop()
        return alive, f.snapshot()["fires"]
    assert same(run)[1] == (True, {"health.poll": 2})


FLOCK = {"jax": jax_flock, "pt": pt_flock}


def test_flock_seam(tmp_path):
    def run(side, f):
        lock = FLOCK[side].Flock(str(tmp_path / "l.lock"))
        with f.inject("flock.acquire", mode="error"):
            armed = outcome(lambda: lock.acquire(timeout=0.5))
        with lock.acquire(timeout=0.5):
            pass  # disarmed: the lock was never leaked
        return armed, f.snapshot()
    got = same(run)[1]
    assert got[0] == ("raised", "FlockTimeoutError",
                      "injected fault at flock.acquire "
                      f"({tmp_path / 'l.lock'})")


TIMING = {"jax": jax_timing, "pt": pt_timing}


def test_segment_seam():
    def run(side, f):
        timer = TIMING[side].SegmentTimer("op")
        with f.inject("segment:prep_devices", mode="error"):
            def seg(name):
                with timer.segment(name):
                    return name
            armed = outcome(lambda: seg("prep_devices"))
            other = outcome(lambda: seg("other_segment"))
        return armed, other, sorted(timer.segments), f.snapshot()
    got = same(run)[1]
    assert got[0][0] == "raised" and got[1] == ("ok", "other_segment")


@pytest.mark.parametrize("knob", ["crash", "stall"])
def test_segment_env_knobs(knob):
    """``TPU_DRA_CRASH_AT_SEGMENT`` exits with 86 at the segment's start;
    ``TPU_DRA_STALL_AT_SEGMENT`` sleeps there; both packages alike."""
    got = {}
    for side, pkg in (("jax", "k8s_dra_driver_gpu_tpu"),
                      ("pt", "k8s_dra_driver_gpu_tpu_torch")):
        code = (f"import time\nfrom {pkg}.pkg.timing import SegmentTimer\n"
                "t = SegmentTimer('op')\nt0 = time.monotonic()\n"
                "with t.segment('other'):\n    pass\n"
                "with t.segment('prep_cdi'):\n    pass\n"
                "print(round(time.monotonic() - t0, 1))\n")
        env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu")
        if knob == "crash":
            env["TPU_DRA_CRASH_AT_SEGMENT"] = "prep_cdi"
        else:
            env["TPU_DRA_STALL_AT_SEGMENT"] = "prep_cdi"
            env["TPU_DRA_STALL_SECONDS"] = "0.3"
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, text=True, timeout=120)
        got[side] = (out.returncode, out.stdout.strip())
    assert got["pt"] == got["jax"]
    assert got["pt"] == ((86, "") if knob == "crash" else (0, "0.3"))


# -- the seams: the kube client --------------------------------------------------

RETRY = {"jax": jax_retry, "pt": pt_retry}
KUBE = {"jax": jax_kube, "pt": pt_kube}


@pytest.mark.parametrize("mode", ["error", "crash"])
def test_kube_request_seam_via_retrying_client(mode):
    def run(side, f):
        rk = RETRY[side].RetryingKubeClient(
            KUBE[side].FakeKubeClient(),
            policy=RETRY[side].RetryPolicy(base_delay=0.001,
                                           max_delay=0.002,
                                           deadline_s=0.01))
        with f.inject("kube.request", mode=mode):
            armed = outcome(rk.server_version)
        return armed, rk.retry_count > 0
    got = same(run)[1]
    if mode == "error":
        assert got[0] == ("raised", "KubeError",
                          "503: injected fault at kube.request")
        assert got[1] is True
    else:
        assert got[0] == ("raised", "InjectedCrash",
                          "injected fault at kube.request")
        assert got[1] is False  # a crash is never absorbed


@pytest.mark.parametrize("exc", ["InjectedCrash", "InjectedFault"])
def test_classify_injected_faults(exc):
    def run(side, f):
        return RETRY[side].classify(getattr(f, exc)("x"),
                                    RETRY[side].RetryPolicy())
    assert same(run)[1] == ("permanent" if exc == "InjectedCrash"
                            else "retriable")


def test_kube_watch_seam_reconnects():
    """``kube.watch`` armed once breaks each client's first stream; each
    reconnects and still delivers the object (both clients against the
    port's fake API server)."""
    server = FakeApiServer().start()
    try:
        got = {}
        for side, f in FAULTS.items():
            f.arm("kube.watch", mode="error", count=1)
            kube = KUBE[side].KubeClient(host=server.url)
            seen = threading.Event()
            stop = threading.Event()
            name = f"cm-{side}"

            def on_event(kind, obj, name=name, seen=seen):
                if obj["metadata"]["name"] == name:
                    seen.set()
            handle = kube.watch("", "v1", "configmaps", on_event,
                                stop=stop, reconnect_delay=0.2)
            deadline = time.monotonic() + 10
            while f.snapshot()["fires"].get("kube.watch", 0) < 1 and \
                    time.monotonic() < deadline:
                time.sleep(0.02)
            time.sleep(0.3)
            server.store.create("", "v1", "configmaps", {
                "apiVersion": "v1", "kind": "ConfigMap",
                "metadata": {"name": name, "namespace": "default"}},
                namespace="default")
            got[side] = (seen.wait(15), f.snapshot()["fires"])
            stop.set()
            if hasattr(handle, "stop"):
                handle.stop()
            f.reset()
        assert got["pt"] == got["jax"] == (True, {"kube.watch": 1})
    finally:
        server.stop()


# -- the seams: the partition engine and the rendezvous ------------------------

class SeamSide(Side):
    """A partition plugin whose crash is the fault point on both sides
    (the port's own registry now has ``partition.create`` and
    ``partition.destroy``)."""

    def arm(self, point: str) -> None:
        FAULTS[self.name].arm(f"partition.{point}", mode="error", count=1)

    def disarm(self) -> None:
        FAULTS[self.name].reset()


@pytest.mark.parametrize("name", [
    "crash mid-create resumes", "crash mid-destroy resumes",
    "an orphan Creating record is reaped at restart",
    "crash mid-destroy settled by a restart"])
def test_partition_seams(name, sides, monkeypatch):  # noqa: F811
    import tests.test_torch_partition as tp

    monkeypatch.setattr(tp, "Side", SeamSide)
    slots, fraction, steps = SCENARIOS[name]
    pair = sides(slots, fraction)
    run_steps(pair, steps)
    assert pair["pt"].snapshot() == pair["jax"].snapshot()


RENDEZVOUS = {"jax": jax_rendezvous, "pt": pt_rendezvous}


def test_rendezvous_seam(tmp_path):
    def run(side, f):
        mod = RENDEZVOUS[side]
        members = tmp_path / f"{side}.json"
        members.write_text('{"expected": 1, "members": {"a": '
                           '{"ready": true}}}')
        svc = mod.CoordinationService("127.0.0.1", 0,
                                      mod.MembershipState(str(members)))
        port = svc.server_address[1]
        t = threading.Thread(target=svc.serve_forever, daemon=True)
        t.start()
        try:
            with f.inject("rendezvous.handle", mode="error", count=1):
                armed = outcome(lambda: mod.query("127.0.0.1", port,
                                                  "STATUS"))
            return armed[0], outcome(lambda: mod.query(
                "127.0.0.1", port, "STATUS")), f.snapshot()["fires"]
        finally:
            svc.shutdown()
            svc.server_close()
            t.join(5)
    got = same(run)[1]
    assert got[2] == {"rendezvous.handle": 1}
    assert got[1][0] == "ok"
