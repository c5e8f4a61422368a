"""The port's node-side telemetry (the device library's
``chip_telemetry``, ``pkg/fleetstate.TelemetryRing``, ``pkg/anomaly``,
the health monitor's sampling station and the kubelet ``Driver``'s
wiring) against the JAX package's, on the CPU.

After ``tests/test_telemetry.py``, case by case, each run on both
packages with the same inputs:

- **The seam**: the mock telemetry grammar (the JAX mock reads
  ``TPULIB_MOCK_TELEMETRY``, the port's ``GPULIB_MOCK_TELEMETRY``; both
  are set alike), its control file, malformed entries, the fault point.
- **The ring**: the same samples give the same snapshot (``time.time``
  fixed).
- **The detector**: the JAX cases, then seeded random streams (numpy)
  with regime changes (warm-up, heat, power at the cap, NVLink error
  bursts, stragglers) through both detectors: the same detections,
  active set and taints after every poll (``chip-<i>`` <-> ``gpu-<i>``),
  and the same EWMA baselines.
- **The monitor**: samples land in the ring and the callback, a library
  without the seam or ``TPU_DRA_TELEMETRY=0`` samples nothing, anomaly
  taints merge into the poll before the quarantine pass, and a sample
  that raises (the port's NVML refusing ``chip_telemetry`` beside CUDA
  too) loses only its samples: the poll's taints are whole and the
  refusal is logged.
- **The driver**: the JAX ``Driver`` on ``v5e-4`` and the port's on
  ``h100-4`` get the same feed (HBM as the same share of each chip's
  memory): the same quantized attributes, zero writes and zero reads in
  a steady state, the same gauges, a trickle of NVLink errors that
  writes nothing, a vanished GPU's attributes and gauges dropped, the
  attributes knob, the power-cap attribute, and a flapping thermal
  anomaly: one Warning Event, the flight events, the quarantine taint
  and its counter.
"""

import json
import logging
import re
import time

import numpy as np
import pytest
from prometheus_client import generate_latest
from prometheus_client.parser import text_string_to_metric_families

from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
from k8s_dra_driver_gpu_tpu.kubeletplugin import driver as jax_driver
from k8s_dra_driver_gpu_tpu.kubeletplugin import health as jax_health
from k8s_dra_driver_gpu_tpu.pkg import anomaly as jax_anomaly
from k8s_dra_driver_gpu_tpu.pkg import faults as jax_faults
from k8s_dra_driver_gpu_tpu.pkg import fleetstate as jax_fleet
from k8s_dra_driver_gpu_tpu.pkg import flightrecorder as jax_fr
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg import metrics as jax_metrics
from k8s_dra_driver_gpu_tpu.tpulib import binding as jax_tpulib
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import driver as pt_driver
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import health as pt_health
from k8s_dra_driver_gpu_tpu_torch.pkg import anomaly as pt_anomaly
from k8s_dra_driver_gpu_tpu_torch.pkg import exposition
from k8s_dra_driver_gpu_tpu_torch.pkg import faults as pt_faults
from k8s_dra_driver_gpu_tpu_torch.pkg import fleetstate as pt_fleet
from k8s_dra_driver_gpu_tpu_torch.pkg import flightrecorder as pt_fr
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import metrics as pt_metrics
from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as pt_tpulib
from tests.fake_kube import CountingKube

SIDES = ("jax", "pt")
M = {
    "jax": dict(ds=jax_ds, driver=jax_driver, health=jax_health,
                anomaly=jax_anomaly, faults=jax_faults, fleet=jax_fleet,
                fr=jax_fr, kube=jax_kube, metrics=jax_metrics,
                lib=jax_tpulib, latest=generate_latest, dev="chip-"),
    "pt": dict(ds=pt_ds, driver=pt_driver, health=pt_health,
               anomaly=pt_anomaly, faults=pt_faults, fleet=pt_fleet,
               fr=pt_fr, kube=pt_kube, metrics=pt_metrics, lib=pt_tpulib,
               latest=exposition.generate_latest, dev="gpu-"),
}
ENV = {"jax": jax_tpulib.ENV_MOCK_TELEMETRY,
       "pt": pt_tpulib.ENV_MOCK_TELEMETRY}
# Each mock chip's memory: a v5e chip and an H100.
HBM = {"jax": 16 << 30, "pt": 80 << 30}


def neutral(value):
    """A value with device names in the port's terms."""
    text = json.dumps(value, sort_keys=True, default=repr)
    return json.loads(re.sub(r"\bchip-(\d+)", r"gpu-\1", text))


def sample(side, chip, power=100.0, temp=45.0, hbm=1 << 30, duty=0.9,
           ici=0):
    return M[side]["lib"].ChipTelemetry(
        chip=chip, power_watts=power, temp_celsius=temp,
        hbm_used_bytes=hbm, duty_cycle=duty, ici_link_errors=ici)


def setfeed(monkeypatch, spec):
    """The same mock telemetry on both sides: ``spec(side)`` or a
    string."""
    for side in SIDES:
        monkeypatch.setenv(ENV[side], spec(side) if callable(spec)
                           else spec)


def test_constants_equal_the_references():
    for name in ("ANOMALY_Z", "ANOMALY_ALPHA", "ANOMALY_MIN_SAMPLES",
                 "ANOMALY_ICI_BURST", "ANOMALY_STRAGGLER_PEERS_DUTY",
                 "ANOMALY_STRAGGLER_GAP", "KINDS"):
        assert getattr(pt_anomaly, name) == getattr(jax_anomaly, name)
    for name in ("TELEMETRY_POWER_STEP_W", "TELEMETRY_TEMP_STEP_C",
                 "TELEMETRY_DUTY_STEP_PCT", "TELEMETRY_HBM_STEP_PCT",
                 "TELEMETRY_ICI_STEP"):
        assert getattr(pt_driver, name) == getattr(jax_driver, name)


# -- the seam ------------------------------------------------------------------

def _lib(side):
    if side == "jax":
        return jax_tpulib.load(prefer_native=False)
    return pt_tpulib.PyGpuLib()


def _both_samples():
    return {side: tuple(s.to_dict() for s in _lib(side).chip_telemetry(
        M[side]["lib"].EnumerateOptions())) for side in SIDES}


@pytest.mark.parametrize("spec", [
    "chip=0,power=120.5,temp=55,hbm=1073741824,duty=0.85,ici_err=3|"
    "chip=1,power=118,temp=52",
    "power=9|chip=1,power=x,temp=50.x|garbage",
    "chip=3,ici_err=12abc,duty=.5|chip=-1,power=3|chip=2",
    "",
])
def test_mock_grammar_equals_the_references(spec, monkeypatch):
    setfeed(monkeypatch, spec)
    got = _both_samples()
    assert got["pt"] == got["jax"]


def test_control_file_reread_each_poll(tmp_path, monkeypatch):
    ctl = tmp_path / "tele.ctl"
    setfeed(monkeypatch, f"@{ctl}")
    for text in ("chip=2,power=99.5,temp=40\n", "", "chip=0,duty=1\n"):
        ctl.write_text(text)
        got = _both_samples()
        assert got["pt"] == got["jax"]
    ctl.unlink()
    assert _both_samples() == {"jax": (), "pt": ()}


def test_telemetry_fault_point(monkeypatch):
    setfeed(monkeypatch, "chip=0,power=1")
    got = {}
    for side in SIDES:
        with M[side]["faults"].inject("tpulib.telemetry", mode="error"):
            try:
                _lib(side).chip_telemetry(M[side]["lib"].EnumerateOptions())
            except Exception as e:  # noqa: BLE001 - compared
                got[side] = str(e)
    assert got["pt"] == got["jax"] == "injected fault at tpulib.telemetry"


# -- the ring --------------------------------------------------------------------

def test_ring_bounded_and_endpoint(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1234.5)
    docs = {}
    for side in SIDES:
        ring = M[side]["fleet"].TelemetryRing(samples_per_chip=16)
        for i in range(50):
            ring.record_sample(sample(side, i % 3, power=float(i)))
        assert len(ring.series(0)) == 16
        status, ctype, body = ring.telemetry_endpoint()
        docs[side] = (status, ctype, json.loads(body), ring.latest(),
                      ring.recorded_total)
    assert docs["pt"] == docs["jax"]


# -- the detector ----------------------------------------------------------------

def _det(side, **kw):
    kw.setdefault("min_samples", 3)
    return M[side]["anomaly"].AnomalyDetector(**kw)


def _observe_both(dets, polls):
    """Feed each poll (a list of sample kwargs) to both detectors; the
    detections, active set and taints after each, asserted equal."""
    out = []
    for poll in polls:
        got = {}
        for side in SIDES:
            d = dets[side]
            new = d.observe([sample(side, **kw) for kw in poll])
            taints = d.taints(M[side]["health"].DeviceTaint,
                              M[side]["health"].TAINT_KEY_PREFIX)
            got[side] = neutral((
                [(a.device, a.kind, a.detail) for a in new],
                sorted(d.active()),
                [(t.device, t.key, t.value, t.effect) for t in taints],
                d.detections_total))
        assert got["pt"] == got["jax"], poll
        out.append(got["pt"])
    return out


def _pair(**kw):
    return {side: _det(side, **kw) for side in SIDES}


@pytest.mark.parametrize("case", [
    "warmup", "one_episode", "steady_hot", "power_cap", "power_idle",
    "power_default_off", "ici_delta", "straggler", "idle_gang", "level"])
def test_detector_cases_equal_the_references(case):
    c45, c90 = {"chip": 0, "temp": 45.0}, {"chip": 0, "temp": 90.0}
    cases = {
        "warmup": ({}, [[{"chip": 0, "temp": 50.0}], [c90]]),
        "one_episode": ({}, [[c45]] * 5 + [[c90], [c90], [c45], [c90]]),
        "steady_hot": ({}, [[{"chip": 0, "temp": 85.0}]] * 10),
        "power_cap": ({"power_cap_w": 200.0},
                      [[{"chip": 0, "power": 199.0, "duty": 0.95}]]),
        "power_idle": ({"power_cap_w": 200.0},
                       [[{"chip": 0, "power": 199.0, "duty": 0.1}]]),
        "power_default_off": ({}, [[{"chip": 0, "power": 9999.0,
                                     "duty": 1.0}]]),
        "ici_delta": ({"ici_burst": 5}, [[{"chip": 0, "ici": 100}],
                                         [{"chip": 0, "ici": 102}],
                                         [{"chip": 0, "ici": 110}]]),
        "straggler": ({}, [[{"chip": i, "duty": 0.9} for i in range(3)]
                           + [{"chip": 3, "duty": 0.1}]]),
        "idle_gang": ({}, [[{"chip": i, "duty": 0.05} for i in range(4)]]),
        "level": ({"power_cap_w": 100.0},
                  [[{"chip": 0, "power": 100.0, "duty": 1.0}],
                   [{"chip": 0, "power": 10.0, "duty": 1.0}]]),
    }
    kw, polls = cases[case]
    if kw.get("power_cap_w") is None and case == "power_default_off":
        kw = {}
    _observe_both(_pair(**kw), polls)


def _random_polls(rng, chips, polls):
    """A stream with regimes: a warm baseline, then heat, power at the
    cap, NVLink error bursts and a straggler, each on and off."""
    temp = rng.uniform(40, 60, chips)
    ici = rng.integers(0, 50, chips)
    out = []
    for p in range(polls):
        regime = rng.choice(["calm", "hot", "cap", "burst", "straggle"]) \
            if p >= 10 else "calm"
        poll = []
        victim = int(rng.integers(0, chips))
        for c in range(chips):
            t = float(temp[c] + rng.normal(0, 0.8))
            power = float(rng.uniform(300, 650))
            duty = float(rng.uniform(0.75, 1.0))
            ici[c] += int(rng.integers(0, 3))
            if c == victim:
                if regime == "hot":
                    t += float(rng.uniform(8, 30))
                elif regime == "cap":
                    power, duty = 700.0, 0.97
                elif regime == "burst":
                    ici[c] += int(rng.integers(5, 40))
                elif regime == "straggle":
                    duty = float(rng.uniform(0.0, 0.3))
            poll.append({"chip": c, "temp": round(t, 2),
                         "power": round(power, 1), "duty": round(duty, 3),
                         "ici": int(ici[c])})
        if rng.random() < 0.1:
            poll.pop(int(rng.integers(0, len(poll))))  # a sample lost
        out.append(poll)
    return out


@pytest.mark.parametrize("seed", range(8))
def test_random_streams_detect_alike(seed):
    rng = np.random.default_rng(seed)
    chips = int(rng.integers(1, 9))
    dets = _pair(power_cap_w=700.0 if seed % 2 else None,
                 z_threshold=float(rng.choice([2.0, 3.0])),
                 alpha=float(rng.choice([0.1, 0.2, 0.5])))
    got = _observe_both(dets, _random_polls(rng, chips, 60))
    if seed == 0:
        assert any(step[0] for step in got)  # the stream does detect
    for chip in dets["jax"]._temp:
        a, b = dets["jax"]._temp[chip], dets["pt"]._temp[chip]
        assert (b.mean, b.var, b.n) == (a.mean, a.var, a.n)


@pytest.mark.parametrize("seed", range(4))
def test_ewma_equals_the_references(seed):
    rng = np.random.default_rng(seed)
    e = {side: M[side]["anomaly"].Ewma(0.3) for side in SIDES}
    for x in rng.normal(50, 5, 40):
        got = {side: (e[side].zscore(x), e[side].update(x), e[side].mean,
                      e[side].var, e[side].n) for side in SIDES}
        assert got["pt"] == got["jax"]


# -- the monitor -----------------------------------------------------------------

class _FakeLib:
    """A library with a scripted telemetry feed, one side's samples."""

    def __init__(self, side, feed):
        self.side, self.feed = side, list(feed)

    def health(self, opts):
        return ()

    def chip_telemetry(self, opts):
        poll = self.feed.pop(0) if self.feed else []
        return tuple(sample(self.side, **kw) for kw in poll)


class _Legacy:
    def health(self, opts):
        return ()


def _monitor(side, lib, **kw):
    kw.setdefault("telemetry_ring", M[side]["fleet"].TelemetryRing())
    opts = (jax_tpulib.EnumerateOptions(mock_topology="v5e-4")
            if side == "jax" else
            pt_tpulib.EnumerateOptions(mock_topology="h100-4"))
    return M[side]["health"].ChipHealthMonitor(lib, opts, lambda t: None,
                                               **kw)


def test_samples_land_in_ring_and_callback():
    got = {}
    for side in SIDES:
        seen = []
        mon = _monitor(side, _FakeLib(side, [[{"chip": 0}],
                                             [{"chip": 0}, {"chip": 1}]]),
                       on_chip_telemetry=seen.extend)
        n = [len(mon.sample_chip_telemetry()) for _ in range(3)]
        got[side] = (n, mon.telemetry_ring.recorded_total,
                     [s.chip for s in seen])
    assert got["pt"] == got["jax"] == ([1, 2, 0], 3, [0, 0, 1])


def test_library_without_the_seam_samples_nothing():
    assert [_monitor(s, _Legacy()).sample_chip_telemetry()
            for s in SIDES] == [(), ()]


def test_master_switch_disables(monkeypatch):
    monkeypatch.setenv("TPU_DRA_TELEMETRY", "0")
    for side in SIDES:
        lib = _FakeLib(side, [[{"chip": 0}]])
        mon = _monitor(side, lib)
        assert mon.sample_chip_telemetry() == () and lib.feed
        assert mon.telemetry_ring.recorded_total == 0 and mon.anomaly is None


def test_anomaly_taints_merge_into_the_poll():
    feed = [[{"chip": 0, "temp": 45.0}]] * 5 + [[{"chip": 0,
                                                  "temp": 95.0}]] * 2
    got = {}
    for side in SIDES:
        mon = _monitor(side, _FakeLib(side, feed),
                       anomaly_detector=_det(side))
        got[side] = neutral([[(t.device, t.key, t.effect)
                              for t in mon.poll_and_reconcile()]
                             for _ in range(7)])
    assert got["pt"] == got["jax"]
    assert got["pt"][5] == [["gpu-0", "tpu.dra.dev/thermal_drift", ""]]


def test_flapping_anomaly_quarantines_through_the_tracker():
    """A thermal anomaly that comes and goes is counted by the
    quarantine tracker as a flapping event is."""
    base = [{"chip": 0, "temp": 45.0}, {"chip": 1, "temp": 46.0}]
    hot = [{"chip": 0, "temp": 45.0}, {"chip": 1, "temp": 95.0}]
    feed = [base] * 8 + [hot, base] * 4
    got = {}
    for side in SIDES:
        quarantined = []
        mon = _monitor(side, _FakeLib(side, feed),
                       anomaly_detector=_det(side),
                       on_quarantine=quarantined.append)
        polls = [[(t.device, t.key, t.effect)
                  for t in mon.poll_and_reconcile()]
                 for _ in range(len(feed))]
        got[side] = neutral((polls, quarantined,
                             mon.quarantine.total_quarantines))
    assert got["pt"] == got["jax"]
    assert got["pt"][1] == ["gpu-1"]


def test_a_sample_that_raises_never_poisons_the_poll(caplog):
    class Sick(_Legacy):
        def chip_telemetry(self, opts):
            raise RuntimeError("boom")
    got = {}
    for side in SIDES:
        caplog.clear()
        with caplog.at_level(logging.ERROR):
            got[side] = _monitor(side, Sick()).poll_and_reconcile()
        assert "chip-telemetry sample failed" in caplog.text
    assert got == {"jax": [], "pt": []}


def test_nvml_refusal_beside_cuda_loses_only_its_samples(monkeypatch,
                                                        caplog):
    """The port's NVML refuses ``chip_telemetry`` in a process that has
    initialised CUDA; the monitor logs it, its health events still
    become taints, and nothing is sampled."""
    class NvmlBesideCuda:
        allow_beside_cuda = False

        def health(self, opts):
            return (pt_tpulib.HealthEvent(chip=1, kind="xid_94",
                                          fatal=False),)

        chip_telemetry = pt_tpulib.NvmlLib.chip_telemetry
        _refuse_beside_cuda = pt_tpulib.NvmlLib._refuse_beside_cuda

    monkeypatch.setattr(pt_tpulib, "cuda_initialised", lambda: True)
    seen = []
    mon = _monitor("pt", NvmlBesideCuda(), on_chip_telemetry=seen.append)
    with caplog.at_level(logging.ERROR):
        taints = mon.poll_and_reconcile()
    assert [(t.device, t.key) for t in taints] == [
        ("gpu-1", "tpu.dra.dev/xid_94")]
    assert "chip_telemetry refused" in caplog.text
    assert seen == [] and mon.telemetry_ring.recorded_total == 0


# -- the driver ------------------------------------------------------------------

class Node:
    """A driver with its health monitor on each side, over a counting
    fake, fed the same telemetry."""

    def __init__(self, tmp_path, monkeypatch, **driver_kw):
        self.mp = monkeypatch
        self.recorders = {s: M[s]["fr"].set_default(M[s]["fr"]
                                                    .FlightRecorder())
                          for s in SIDES}
        for s in SIDES:
            M[s]["fleet"].set_default_ring(M[s]["fleet"].TelemetryRing())
        self.kubes, self.drivers = {}, {}
        for s in SIDES:
            root = str(tmp_path / s)
            cfg = (jax_ds.Config.mock(root=root, topology="v5e-4", gates="")
                   if s == "jax" else pt_ds.Config.mock(root, "h100-4"))
            self.kubes[s] = CountingKube(M[s]["kube"].FakeKubeClient())
            kw = dict(driver_kw)
            if "resilience" in kw:
                kw["resilience"] = kw["resilience"][s]
            if "recovery_metrics" in kw:
                kw["recovery_metrics"] = kw["recovery_metrics"][s]
            self.drivers[s] = M[s]["driver"].Driver(
                cfg, self.kubes[s], node_name="n0",
                publication_mode="combined", **kw)
            self.drivers[s].publish_resources()

    def feed(self, polls):
        """``polls``: a list of per-chip kwargs (hbm as a share)."""
        def spec(side):
            return "|".join(
                ",".join([f"chip={kw['chip']}"] + [
                    f"{k}={v}" for k, v in (
                        ("power", kw.get("power")),
                        ("temp", kw.get("temp")),
                        ("hbm", int(kw["hbm"] * HBM[side])
                         if "hbm" in kw else None),
                        ("duty", kw.get("duty")),
                        ("ici_err", kw.get("ici"))) if v is not None])
                for kw in polls)
        setfeed(self.mp, spec)

    def poll(self):
        for s in SIDES:
            d = self.drivers[s]
            d._on_health_taints(d.health_monitor.poll_and_reconcile())

    def devices(self):
        out = {}
        for s in SIDES:
            slices = self.kubes[s]._inner.list("resource.k8s.io", "v1",
                                               "resourceslices")
            out[s] = neutral({
                dev["name"]: {
                    "telemetry": {k: v for k, v in (dev.get(
                        "attributes") or {}).items()
                        if k.startswith("telemetry") or k ==
                        "powerCapWatts"},
                    "taints": [(t["key"].rsplit("/", 1)[-1],
                                t.get("effect", ""))
                               for t in dev.get("taints") or []]}
                for sl in slices for dev in sl["spec"]["devices"]})
        assert out["pt"] == out["jax"]
        return out["pt"]

    def gauges(self, prefix="tpu_dra_chip_"):
        got = {}
        for s in SIDES:
            text = M[s]["latest"](self.drivers[s].metrics.registry).decode()
            # HBM bytes as a share of each chip's memory.
            got[s] = sorted(
                (x.name, tuple(sorted(x.labels.items())),
                 x.value / HBM[s] if x.name == "tpu_dra_chip_hbm_used_bytes"
                 else x.value)
                for f in text_string_to_metric_families(text)
                for x in f.samples
                if x.name.startswith(prefix)
                and not x.name.endswith("_created"))
        assert got["pt"] == got["jax"]
        return got["pt"]

    def counts(self):
        return {s: (self.kubes[s].reads, self.kubes[s].writes)
                for s in SIDES}

    def close(self):
        for s in SIDES:
            self.drivers[s].stop()
            M[s]["fleet"].set_default_ring(M[s]["fleet"].TelemetryRing())
            M[s]["fr"].set_default(M[s]["fr"].FlightRecorder())


STEADY = [{"chip": i, "power": 117, "temp": 48, "hbm": 0.125,
           "duty": 0.93} for i in range(4)]


@pytest.fixture
def node(tmp_path, monkeypatch):
    made = []

    def make(**kw):
        n = Node(tmp_path / f"n{len(made)}", monkeypatch, **kw)
        made.append(n)
        return n
    yield make
    for n in made:
        n.close()


def test_quantized_attrs_published(node):
    n = node()
    n.feed(STEADY)
    n.poll()
    dev = n.devices()["gpu-0"]["telemetry"]
    assert dev == {"telemetryPowerWatts": {"int": 120},
                   "telemetryTempCelsius": {"int": 50},
                   "telemetryDutyPct": {"int": 90},
                   "telemetryHbmUsedPct": {"int": 10},
                   "telemetryIciErrors": {"int": 0}}


def test_steady_state_costs_no_api_call(node):
    n = node()
    n.feed(STEADY)
    n.poll()
    before = n.counts()
    for step in range(5):
        # Wiggles inside one quantization step.
        n.feed([dict(kw, power=117 + step % 3, temp=48 + step % 2)
                for kw in STEADY])
        n.poll()
    assert n.counts() == before
    n.devices()


def test_gauges_exported(node):
    n = node()
    n.feed(STEADY)
    for s in SIDES:
        n.drivers[s].health_monitor.poll_and_reconcile()
    got = n.gauges()
    assert ("tpu_dra_chip_power_watts", (("chip", "0"),), 117.0) in got


def test_nvlink_error_trickle_writes_nothing(node):
    n = node()
    n.feed([dict(kw, ici=i) for i, kw in enumerate(STEADY)])
    n.poll()
    writes = n.counts()
    for step in range(1, 6):
        n.feed([dict(kw, ici=step + i) for i, kw in enumerate(STEADY)])
        n.poll()
    assert n.counts() == writes
    assert ("tpu_dra_chip_ici_link_errors_total", (("chip", "0"),),
            5.0) in n.gauges()


def test_vanished_gpu_drops_its_gauges_and_attrs(node):
    n = node()
    n.feed(STEADY)
    n.poll()
    n.feed(STEADY[:3])
    n.poll()
    devs = n.devices()
    assert devs["gpu-0"]["telemetry"] and not devs["gpu-3"]["telemetry"]
    assert not any(lbl == (("chip", "3"),) for _, lbl, _ in n.gauges(
        "tpu_dra_chip_power"))
    n.feed([])
    n.poll()
    assert not any(d["telemetry"] for d in n.devices().values())


def test_attrs_knob_off(node, monkeypatch):
    monkeypatch.setenv("TPU_DRA_TELEMETRY_ATTRS", "0")
    n = node()
    n.feed(STEADY)
    n.poll()
    assert not any(d["telemetry"] for d in n.devices().values())
    assert n.gauges()  # the gauges stay


def test_power_cap_attribute(node, monkeypatch):
    monkeypatch.setenv("TPU_DRA_POWER_CAP_W", "700")
    n = node()
    assert n.devices()["gpu-1"]["telemetry"] == {
        "powerCapWatts": {"int": 700}}


def test_flapping_anomaly_event_flight_and_quarantine(node):
    """Four thermal episodes on one GPU: one Warning Event (created
    once), one flight event an episode, the quarantine taint published
    and counted, on both sides alike."""
    res = {s: M[s]["metrics"].ResilienceMetrics() for s in SIDES}
    n = node(resilience=res)
    base = [{"chip": i, "power": 117, "temp": 48, "duty": 0.93}
            for i in range(4)]
    hot = [dict(kw, temp=95) if kw["chip"] == 1 else kw for kw in base]
    for _ in range(10):
        n.feed(base)
        n.poll()
    for _ in range(4):
        n.feed(hot)
        n.poll()
        n.feed(base)
        n.poll()
    devs = n.devices()
    assert ["degraded", "NoSchedule"] in devs["gpu-1"]["taints"]
    events = {}
    for s in SIDES:
        evs = [e for e in n.kubes[s]._inner.list("", "v1", "events",
                                                 namespace="default")
               if e["reason"] == "TelemetryAnomaly"]
        flights = [(ev["event"], ev["kind"]) for ev in
                   n.recorders[s].events(f"{M[s]['dev']}1")
                   if ev["event"] == "anomaly"]
        events[s] = neutral((
            [(e["metadata"]["name"], e["type"], e["involvedObject"],
              e["source"], e["message"].split("; time-series")[0])
             for e in evs], flights))
        text = M[s]["latest"](res[s].registry).decode()
        assert 'tpu_dra_quarantine_total{device="' + M[s]["dev"] + \
            '1"} 1.0' in text
    assert events["pt"] == events["jax"]
    assert len(events["pt"][0]) == 1 and len(events["pt"][1]) == 4
    assert n.gauges("tpu_dra_anomaly_total") == [
        ("tpu_dra_anomaly_total", (("kind", "thermal_drift"),), 4.0)]


def test_device_failure_hook_counts(node):
    rec = {s: M[s]["metrics"].RecoveryMetrics() for s in SIDES}
    n = node(recovery_metrics=rec)
    texts = {}
    for s in SIDES:
        n.drivers[s].health_monitor.quarantine.mark_failed(
            f"{M[s]['dev']}2")
        n.drivers[s]._on_health_taints(
            n.drivers[s].health_monitor.poll_and_reconcile())
        texts[s] = M[s]["latest"](rec[s].registry).decode()
        assert 'tpu_dra_recovery_permanent_failures_total{source=' \
            '"device"} 1.0' in texts[s]
    assert ["failed", "NoExecute"] in n.devices()["gpu-2"]["taints"]
