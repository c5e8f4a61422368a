"""The port's health layer against the JAX package's: events to taints,
the quarantine tracker's escalations on a scripted clock, the monitor's
polls over the mocks' injection strings and over a scripted library,
its backoff; then what only the port's monitor does (it owns its device
library) and its thread, and NVML's events over the fake
``libnvidia-ml.so.1``."""

import random
import re
import threading

import pytest

from k8s_dra_driver_gpu_tpu.kubeletplugin import health as jax_health
from k8s_dra_driver_gpu_tpu.tpulib import binding as jax_tpulib
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import health as pt_health
from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as pt_tpulib

SIDES = {"jax": (jax_health, jax_tpulib), "pt": (pt_health, pt_tpulib)}
KINDS = ("hbm_uncorrectable", "chip_lost", "ici_link_down", "thermal",
         "thermal_notice", "clock_throttle", "xid_94", "pcie_aer_fatal",
         "pcie_aer_nonfatal")


def neutral(value) -> str:
    return re.sub(r"\b(?:chip|gpu)-(-?\d+)", r"#\1", repr(value))


def dev(side: str, i: int) -> str:
    return f"chip-{i}" if side == "jax" else f"gpu-{i}"


def on_both(fn):
    got = {side: neutral(fn(side, *SIDES[side])) for side in SIDES}
    assert got["pt"] == got["jax"]
    return got["pt"]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("fatal", [False, True])
@pytest.mark.parametrize("ignored", [None, frozenset({"xid_94", "thermal"})])
def test_event_to_taints_equals_the_references(kind, fatal, ignored):
    def run(side, health, lib):
        ev = lib.HealthEvent(chip=2, kind=kind, fatal=fatal)
        args = () if ignored is None else (ignored,)
        return [(t, t.to_dict())
                for t in health.health_event_to_taints(ev, *args)]
    on_both(run)


def test_constants_equal_the_references():
    for name in ("TAINT_KEY_PREFIX", "QUARANTINE_KIND", "FAILED_KIND",
                 "DEFAULT_IGNORED_KINDS", "POLL_INTERVAL_S",
                 "POLL_BACKOFF_MAX_S", "QUARANTINE_EVENTS",
                 "QUARANTINE_WINDOW_S", "QUARANTINE_HYSTERESIS_S",
                 "QUARANTINE_FATAL_ESCALATIONS"):
        assert getattr(pt_health, name) == getattr(jax_health, name), name


class Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _script(seed: int):
    """Steps of (seconds to advance, [(device, kind, effect)])."""
    rng = random.Random(seed)
    steps = []
    for _ in range(60):
        taints = []
        for i in range(4):
            r = rng.random()
            if r < 0.3 + 0.4 * (i == 1):  # GPU 1 flaps most
                taints.append((i, "thermal", ""))
            elif r < 0.75:
                continue
            elif r < 0.8:
                taints.append((i, "chip_lost", "NoExecute"))
            elif r < 0.85:
                taints.append((i, "degraded", "NoSchedule"))
        steps.append((rng.choice([0.5, 1.0, 2.0, 5.0]), taints))
    return steps


@pytest.mark.parametrize("seed", range(10))
@pytest.mark.parametrize("threshold,window,hysteresis,fatal_after", [
    (3, 10.0, 6.0, 2), (2, 4.0, 20.0, 3), (1, 100.0, 1.0, 1)])
def test_quarantine_tracker_equals_the_references(seed, threshold, window,
                                                  hysteresis, fatal_after):
    def run(side, health, lib):
        clock = Clock()
        tracker = health.QuarantineTracker(
            threshold=threshold, window_s=window, hysteresis_s=hysteresis,
            fatal_after=fatal_after, clock=clock)
        out = []
        for dt, taints in _script(seed):
            clock.now += dt
            out.append(tracker.observe([
                health.DeviceTaint(dev(side, i),
                                   f"{health.TAINT_KEY_PREFIX}/{kind}",
                                   "true", effect)
                for i, kind, effect in taints]))
            out.append((sorted(tracker.quarantined),
                        sorted(tracker.failed)))
        tracker.mark_failed(dev(side, 3))
        return out, sorted(tracker.quarantined), sorted(tracker.failed)
    on_both(run)


class ScriptedLib:
    """A device library whose polls return scripted events (or raise)."""

    def __init__(self, lib, script):
        self._lib = lib
        self._script = list(script)
        self.polls = 0
        self.closed = 0

    def health(self, opts=None):
        self.polls += 1
        step = self._script.pop(0) if self._script else []
        if isinstance(step, Exception):
            raise step
        return tuple(self._lib.HealthEvent(chip=c, kind=k, fatal=f)
                     for c, k, f in step)

    def close(self):
        self.closed += 1


FLAPS = [[(1, "thermal", False)], [], [(1, "thermal", False)], [],
         [(1, "thermal", False), (0, "chip_lost", True)], [],
         [(1, "thermal", False), (2, "thermal_notice", False)], [], []]


def test_poll_and_reconcile_equals_the_references():
    def run(side, health, lib):
        clock = Clock()
        mon = health.ChipHealthMonitor(
            ScriptedLib(lib, FLAPS), lib.EnumerateOptions(), lambda t: None)
        mon.quarantine = health.QuarantineTracker(
            threshold=2, window_s=60.0, hysteresis_s=3.0, clock=clock)
        out = []
        for _ in FLAPS:
            clock.now += 1.0
            out.append(mon.poll_and_reconcile())
        return out
    assert "'NoSchedule'" in on_both(run)


@pytest.mark.parametrize("events", [
    "chip=1,kind=ici_link_down|chip=2,kind=thermal",
    "chip=0,kind=hbm_uncorrectable|chip=0,kind=thermal_notice",
    "chip=3,kind=chip_lost",
    "chip=1,kind=xid_94|chip=2,kind=clock_throttle|chip=3,kind=pcie_aer_fatal",
    "chip=x,kind=thermal|garbage", ""])
@pytest.mark.parametrize("extra", [(), ("thermal", "xid_94")])
def test_poll_once_over_the_mock_equals_the_references(events, extra):
    def run(side, health, lib):
        opts = lib.EnumerateOptions(
            mock_topology="v5e-4" if side == "jax" else "h100-4",
            health_events=events)
        lib_ = (lib.PyTpuLib if side == "jax" else lib.PyGpuLib)()
        return health.ChipHealthMonitor(lib_, opts, lambda t: None,
                                        additional_ignored=extra).poll_once()
    on_both(run)


@pytest.mark.parametrize("interval", [0.05, 5.0, 100.0])
def test_backoff_equals_the_references(interval):
    def run(side, health, lib):
        mon = health.ChipHealthMonitor(ScriptedLib(lib, []),
                                       lib.EnumerateOptions(),
                                       lambda t: None, poll_interval=interval)
        out = []
        for n in range(20):
            mon.consecutive_failures = n
            out.append(mon._backoff())
        return out
    on_both(run)


# -- the port's monitor: its thread, its library ---------------------------


def test_monitor_survives_failing_polls_and_closes_its_library():
    before = set(threading.enumerate())
    delivered = []
    got = threading.Event()
    lib = ScriptedLib(pt_tpulib, [RuntimeError("nvml gone"),
                                  RuntimeError("again"),
                                  [(2, "chip_lost", True)]])

    def on_taints(taints):
        delivered.append(taints)
        got.set()

    mon = pt_health.ChipHealthMonitor(lib, pt_tpulib.EnumerateOptions(),
                                      on_taints, poll_interval=0.001)
    mon.start()
    assert got.wait(10)
    mon.stop()
    assert delivered[0] == [pt_health.DeviceTaint(
        "gpu-2", "tpu.dra.dev/chip_lost", "true", "NoExecute")]
    assert lib.polls >= 3 and lib.closed == 1
    assert mon.consecutive_failures == 0
    assert set(threading.enumerate()) == before


def test_callback_failure_is_delivered_again():
    calls = []
    done = threading.Event()

    def on_taints(taints):
        calls.append(taints)
        if len(calls) == 1:
            raise RuntimeError("consumer bug")
        done.set()

    lib = ScriptedLib(pt_tpulib, [[(0, "thermal", False)]] * 4)
    mon = pt_health.ChipHealthMonitor(lib, pt_tpulib.EnumerateOptions(),
                                      on_taints, poll_interval=0.001)
    mon.start()
    assert done.wait(10)
    mon.stop()
    assert calls[0] == calls[1]


def test_stop_of_an_unstarted_monitor_closes_the_library():
    lib = ScriptedLib(pt_tpulib, [])
    mon = pt_health.ChipHealthMonitor(lib, pt_tpulib.EnumerateOptions(),
                                      lambda t: None)
    mon.stop()
    assert lib.closed == 1
    # A library without close() (the Python backend) is fine too.
    pt_health.ChipHealthMonitor(pt_tpulib.PyGpuLib(),
                                pt_tpulib.EnumerateOptions(),
                                lambda t: None).stop()


def build_fake_nvml(d) -> str:
    """Build the fake ``libnvidia-ml.so.1`` of ``test_torch_tpulib.py``
    into the directory ``d``; its path."""
    from tests.test_torch_tpulib import FAKE_NVML_C, _cc

    d.mkdir(parents=True, exist_ok=True)
    (d / "fake_nvml.c").write_text(FAKE_NVML_C)
    _cc("-shared", "-fPIC", "-O1", "-o", str(d / "libnvidia-ml.so.1"),
        str(d / "fake_nvml.c"))
    return str(d / "libnvidia-ml.so.1")


@pytest.fixture(scope="module")
def fake_nvml(tmp_path_factory):
    return build_fake_nvml(tmp_path_factory.mktemp("fake_nvml"))


def test_nvml_events_become_taints(fake_nvml, monkeypatch):
    import ctypes

    for var in ("FAKE_NVML_LOST", "FAKE_NVML_NO_PCI", "FAKE_NVML_INIT_RC"):
        monkeypatch.delenv(var, raising=False)
    ctypes.CDLL(fake_nvml).fake_reset()
    lib = pt_tpulib.NvmlLib(fake_nvml)
    mon = pt_health.ChipHealthMonitor(lib, pt_tpulib.EnumerateOptions(),
                                      lambda t: None)
    assert [t.to_dict() | {"device": t.device} for t in mon.poll_once()] == [
        {"device": "gpu-0", "key": "tpu.dra.dev/hbm_uncorrectable",
         "value": "true", "effect": "NoExecute"},
        {"device": "gpu-3", "key": "tpu.dra.dev/hbm_uncorrectable",
         "value": "true", "effect": "NoExecute"},
        {"device": "gpu-3", "key": "tpu.dra.dev/xid_94", "value": "true"}]
    assert mon.poll_and_reconcile() == []  # the set drained
    mon.stop()
    assert lib._lib is None  # NVML shut down by the monitor
