"""The port's metrics against the JAX package's ``pkg/metrics.py``.

- The registry (``pkg/exposition.py``) against ``prometheus_client``:
  the same operations, made from seeds, write the same text (the
  ``_created`` samples, timestamps the port does not keep, left out).
- The same prepare/unprepare sequence on the JAX and the port kubelet
  ``Driver``, over each package's fakes, gives equal parsed expositions;
  so do both ComputeDomain controllers reconciling and deleting the same
  domain, both CD drivers preparing the same channel, both retrying
  clients over the same failures, and both partition engines through the
  same tenant steps. Durations are wall time, so the clock
  (``time.monotonic``) advances 1 us a call during the runs: every
  observation falls in the first bucket on both sides.
- ``MetricsServer``'s routes, and when the debug routes are on.

The kubelet plugins export every JAX family. The kubelet plugins'
prepare segments that only one package has are ``SEGMENTS_ONLY``.

- The telemetry, fleet and recovery families (``TelemetryMetrics``
  through each kubelet ``Driver``'s health monitor over the same mock
  telemetry, ``FleetMetrics`` through each ``FleetAggregator`` over the
  same slices, ``RecoveryMetrics`` through each eviction controller and
  node sweep, ``ResilienceMetrics.quarantines`` through each quarantine
  tracker) give equal parsed expositions, and ``/debug/telemetry`` and
  ``/debug/fleet`` the same documents.
"""

import json
import random
import socket
import time
import urllib.error
import urllib.request

import prometheus_client as pc
import pytest
from prometheus_client.parser import text_string_to_metric_families

from k8s_dra_driver_gpu_tpu.kubeletplugin import DRIVER_NAME as JAX_DRV
from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
from k8s_dra_driver_gpu_tpu.kubeletplugin import driver as jax_driver
from k8s_dra_driver_gpu_tpu.pkg import fleetstate as jax_fleet
from k8s_dra_driver_gpu_tpu.pkg import flightrecorder as jax_fr
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg import metrics as jax_metrics
from k8s_dra_driver_gpu_tpu.pkg import retry as jax_retry
from k8s_dra_driver_gpu_tpu.pkg import tracing as jax_tracing
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME as PT_DRV
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import driver as pt_driver
from k8s_dra_driver_gpu_tpu_torch.pkg import exposition
from k8s_dra_driver_gpu_tpu_torch.pkg import fleetstate as pt_fleet
from k8s_dra_driver_gpu_tpu_torch.pkg import flightrecorder as pt_fr
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import metrics as pt_metrics
from k8s_dra_driver_gpu_tpu_torch.pkg import retry as pt_retry
from k8s_dra_driver_gpu_tpu_torch.pkg import tracing as pt_tracing
from tests.fake_kube import make_claim_dict
from tests.test_torch_computedomain import Side as CDSide
from tests.test_torch_computedomain import _ref, nothing_left_behind  # noqa: F401
from tests.test_torch_partition import Side as PartitionSide
from tests.test_torch_kubeletplugin_sharing import (kill_fake_daemons,
                                                    write_fake_binaries)

SIDES = ("jax", "pt")
RC = ("resource.k8s.io", "v1", "resourceclaims")
METRICS = {"jax": jax_metrics, "pt": pt_metrics}
GENERATE = {"jax": pc.generate_latest, "pt": exposition.generate_latest}
# Prepare segments of one package only: the JAX plugin's
# group-committed checkpoint writer and shard-lock reservation; the
# port's sharing setup and unprepare rollback.
SEGMENTS_ONLY = {"jax": {"ckpt_fsync_wait", "prep_reserved"},
                 "pt": {"prep_sharing", "unprep_rollback"}}


def parse(text: bytes) -> dict:
    """family -> (type, help, sorted samples); the ``_created`` samples
    and the gauge families prometheus_client writes them into left out
    (a family that only ends in ``_created``, as
    ``tpu_dra_prewarm_created``, stays)."""
    fams = list(text_string_to_metric_families(text.decode()))
    names = {fam.name for fam in fams}
    out = {}
    for fam in fams:
        if fam.type == "gauge" and fam.name.endswith("_created") and \
                fam.name[:-len("_created")] in names:
            continue
        out[fam.name] = (fam.type, fam.documentation, sorted(
            (s.name, tuple(sorted(s.labels.items())), s.value)
            for s in fam.samples if s.name != f"{fam.name}_created"))
    return out


def timeless(fams: dict) -> dict:
    """``fams`` with the ``_sum`` of each ``*_seconds`` histogram rounded
    to the ms: under the 1 us clock each side's sum is its count of clock
    reads, well under a ms."""
    out = {}
    for name, (kind, doc, samples) in fams.items():
        if name.endswith("_seconds"):
            samples = [(n, lb, round(v, 3) if n.endswith("_sum") else v)
                       for n, lb, v in samples]
        out[name] = (kind, doc, samples)
    return out


def neutral(text: str) -> str:
    return text.replace(JAX_DRV, "DRV").replace(PT_DRV, "DRV").replace(
        "chip-", "#").replace("gpu-", "#")


@pytest.fixture()
def slow_clock(monkeypatch):
    """``time.monotonic`` advancing 1 us a call."""
    state = {"t": 1000.0}

    def tick():
        state["t"] += 1e-6
        return state["t"]
    monkeypatch.setattr(time, "monotonic", tick)


@pytest.fixture()
def fresh():
    saved = [(m, m.exporter()) for m in (jax_tracing, pt_tracing)]
    recs = [(m, m.default()) for m in (jax_fr, pt_fr)]
    rings = [(m, m.default_ring(), m.default_fleet())
             for m in (jax_fleet, pt_fleet)]
    for m, _ in saved:
        m.set_exporter(m.TraceExporter())
    for m, _ in recs:
        m.set_default(m.FlightRecorder())
    for m, _, _ in rings:
        m.set_default_ring(m.TelemetryRing())
        m.set_default_fleet(m.FleetAggregator())
    yield
    for m, exp in saved:
        m.set_exporter(exp)
    for m, rec in recs:
        m.set_default(rec)
    for m, ring, fleet in rings:
        m.set_default_ring(ring)
        m.set_default_fleet(fleet)


# -- the registry ---------------------------------------------------------

LABEL_VALUES = ["a", "b c", 'q"uote', "back\\slash", "new\nline", "ü", "",
                "1.5"]


def _ops(mod, seed: int) -> "object":
    """A registry with families made and driven from ``seed``."""
    rng = random.Random(seed)
    reg = mod.CollectorRegistry()
    fams = []
    for i in range(6):
        kind = rng.choice(["counter", "gauge", "histogram"])
        labels = rng.sample(["operation", "kind", "pool", "zone"],
                            rng.randrange(0, 3))
        name = f"m{i}_{kind}" + ("_total" if kind == "counter"
                                 and rng.random() < 0.5 else "")
        doc = rng.choice(["plain", "with \\ backslash", "two\nlines"])
        if kind == "counter":
            fams.append((kind, mod.Counter(name, doc, labels, registry=reg)))
        elif kind == "gauge":
            fams.append((kind, mod.Gauge(name, doc, labels, registry=reg)))
        else:
            buckets = sorted(rng.sample([0.001, 0.01, 0.1, 1, 2.5, 10, 60,
                                         1e6, 12345678.0], 4))
            fams.append((kind, mod.Histogram(name, doc, labels,
                                             buckets=buckets, registry=reg)))
    for _ in range(60):
        kind, fam = rng.choice(fams)
        values = [rng.choice(LABEL_VALUES) for _ in fam._labelnames]
        target = fam.labels(*values) if values else fam
        x = rng.choice([0, 1, 2.5, 1e-4, 7e5, 0.1])
        if kind == "counter":
            target.inc(x)
        elif kind == "gauge":
            rng.choice([target.inc, target.dec, target.set])(x)
        else:
            target.observe(x)
    return reg


@pytest.mark.parametrize("seed", range(8))
def test_exposition_is_prometheus_clients(seed):
    ours = exposition.generate_latest(_ops(exposition, seed))
    theirs = pc.generate_latest(_ops(pc, seed))
    lines = theirs.decode().splitlines(keepends=True)
    # prometheus_client's _created samples sit in gauge families of their
    # own: each HELP, TYPE and sample line names the family.
    kept = "".join(line for line in lines if "_created" not in line)
    assert ours.decode() == kept
    assert parse(ours) == parse(theirs)


@pytest.mark.parametrize("value, text", [
    (1, "1.0"), (0.5, "0.5"), (1e6, "1e+06"), (12345678.0, "1.2345678e+07"),
    (float("inf"), "+Inf"), (float("-inf"), "-Inf"), (float("nan"), "NaN"),
    (-3.0, "-3.0"), (1e-4, "0.0001")])
def test_floats_as_go_writes_them(value, text):
    from prometheus_client.utils import floatToGoString
    assert exposition.float_to_go_string(value) == floatToGoString(value) \
        == text


def test_registry_refusals_match():
    for mod in (pc, exposition):
        reg = mod.CollectorRegistry()
        c = mod.Counter("x_total", "h", ["a"], registry=reg)
        for bad in (lambda: mod.Gauge("x", "h", registry=reg),
                    lambda: mod.Counter("x", "h", registry=reg),
                    lambda: c.labels("a", "b"),
                    lambda: c.labels("a").inc(-1),
                    lambda: mod.Histogram("h", "h", ["le"]),
                    lambda: mod.Histogram("h2", "h", buckets=[2, 1])):
            with pytest.raises(ValueError):
                bad()
        c.labels(a="v").inc()
        for value in ("v", "a"):
            c.remove(value)
        c.remove("never")  # no error, as prometheus_client 0.25
        assert b"x_total{" not in mod.generate_latest(reg)
        h = mod.Histogram("lat", "h", registry=reg)
        h.observe(0.2, {"trace_id": "t" * 32})
        with pytest.raises(ValueError):
            h.observe(0.2, {"trace_id": "t" * 129})


def test_build_info_matches(monkeypatch):
    monkeypatch.setenv("FEATURE_GATES", "TimeSlicingSettings=true")
    got = {}
    for side in SIDES:
        reg = METRICS[side].CollectorRegistry() if side == "pt" \
            else pc.CollectorRegistry()
        METRICS[side].register_build_info(reg)
        got[side] = parse(GENERATE[side](reg))
    assert got["pt"] == got["jax"]
    (_, _, samples), = got["pt"].values()
    labels = dict(samples[0][1])
    assert "TimeSlicingSettings" in labels["feature_gates"].split(",")
    assert samples[0][2] == 1.0


# -- the kubelet plugin ---------------------------------------------------

def _kubelet_run(side: str, root: str) -> tuple:
    if side == "jax":
        cfg = jax_ds.Config.mock(root=root, topology="v5e-4", gates="")
        kube, mod, dev, drv = (jax_kube.FakeKubeClient(), jax_driver, "chip",
                               JAX_DRV)
    else:
        cfg = pt_ds.Config.mock(root=root, topology="h100-4")
        kube, mod, dev, drv = (pt_kube.FakeKubeClient(), pt_driver, "gpu",
                               PT_DRV)
    metrics = METRICS[side].DRARequestMetrics()
    d = mod.Driver(cfg, kube, node_name="n", metrics=metrics,
                   enable_health_monitor=False, publication_mode="combined")
    gauge = []
    try:
        d.publish_resources()
        d.publish_resources()  # converged: one skipped write
        for uid, devs in (("u1", [0]), ("u2", [1, 2])):
            kube.create(*RC, make_claim_dict(
                uid, [f"{dev}-{i}" for i in devs], driver=drv),
                namespace="default")
        out = d.prepare_resource_claims([
            {"uid": u, "namespace": "default", "name": u}
            for u in ("u1", "u2", "missing")])
        gauge.append(metrics.prepared_devices._value.get()
                     if side == "jax" else
                     metrics.prepared_devices._self_child.value)
        d.unprepare_resource_claims([{"uid": "u1"}, {"uid": "u2"}])
        health = __import__(mod.__name__.rsplit(".", 1)[0] + ".health",
                            fromlist=["DeviceTaint"])
        d._on_health_taints([health.DeviceTaint(
            device=f"{dev}-3", key="tpu.dra.dev/xid", value="1",
            effect="NoSchedule")])
        d._on_health_taints([])
    finally:
        d.stop()
    errors = sorted((u, bool(e)) for u, (_, e) in out.items())
    return (timeless(parse(GENERATE[side](metrics.registry))), errors,
            gauge)


def _drop_segments(fams: dict, side: str) -> dict:
    name = "tpu_dra_prepare_segment_seconds"
    kind, doc, samples = fams[name]
    segs = {dict(labels)["segment"] for _, labels, _ in samples}
    assert SEGMENTS_ONLY[side] <= segs, segs
    fams = dict(fams)
    fams[name] = (kind, doc, [s for s in samples if dict(s[1])["segment"]
                              not in SEGMENTS_ONLY[side]])
    return fams


def test_kubelet_driver_expositions_match(tmp_path, slow_clock, fresh):
    got = {side: _kubelet_run(side, str(tmp_path / side)) for side in SIDES}
    jax_fams, pt_fams = (_drop_segments(got[s][0], s) for s in SIDES)
    assert set(pt_fams) == set(jax_fams)
    for name in pt_fams:
        assert neutral(json.dumps(pt_fams[name])) == \
            neutral(json.dumps(jax_fams[name])), name
    assert got["pt"][1:] == got["jax"][1:]
    assert got["pt"][1] == [("missing", True), ("u1", False),
                            ("u2", False)]
    assert got["pt"][2] == [3.0]
    _, _, requests = pt_fams["tpu_dra_request_duration_seconds"]
    counts = {dict(lb)["operation"]: v for n, lb, v in requests
              if n.endswith("_count")}
    assert counts == {"NodePrepareResources": 3.0,
                      "NodeUnprepareResources": 2.0}
    (_, errors), = [(n, v) for n, _, v in
                    pt_fams["tpu_dra_request_errors"][2]]
    assert errors == 1.0
    taints = {dict(lb)["kind"]: v
              for _, lb, v in pt_fams["tpu_dra_device_taints"][2]}
    assert taints == {"xid": 0.0}


# -- the scheduler --------------------------------------------------------

def test_scheduler_expositions_match(tmp_path, slow_clock, fresh,
                                     monkeypatch):
    """Both schedulers over one coordinated store (a v5e-16 host, the
    JAX chart's classes), each with ``PlacementMetrics`` and
    ``SchedulerMetrics`` on one registry: the same families, types,
    labels and samples (sync passes, snapshot builds, the fit, commit
    and patch SLO phases, compactness, fragmentation, largest shape, and
    the event-mode, workqueue and domain families, empty in a polled
    pass)."""
    from tests.test_scheduler import make_claim
    from tests.test_torch_scheduler import World, _hosts

    w = World(_hosts("v5e-16", 1)(tmp_path), monkeypatch)
    regs = {}
    for side in SIDES:
        placement = METRICS[side].PlacementMetrics(
            registry=pc.CollectorRegistry() if side == "jax" else None)
        sched = METRICS[side].SchedulerMetrics(registry=placement.registry)
        w.scheds[side].metrics = placement
        w.scheds[side].sched_metrics = sched
        regs[side] = placement.registry
    # The host has 4 chips: the pair and the single fit, the quad and
    # the 9-chip claim do not.
    for name, count in (("p", 2), ("s", 1), ("q", 4), ("big", 9)):
        w.each(lambda k, n=name, c=count: make_claim(k, n, count=c))
    w.sync(passes=2, settle=False)
    fams = {side: timeless(parse(GENERATE[side](regs[side])))
            for side in SIDES}
    assert set(fams["pt"]) == set(fams["jax"])
    for name in fams["pt"]:
        assert fams["pt"][name] == fams["jax"][name], name
    counts = {dict(lb)["phase"]: v for n, lb, v in fams["pt"][
        "tpu_dra_claim_e2e_seconds"][2] if n.endswith("_count")}
    assert counts == {"fit": 2.0, "commit": 2.0, "patch": 2.0}
    (passes,) = [v for n, lb, v in fams["pt"]["tpu_dra_sched_sync_seconds"][
        2] if n.endswith("_count")]
    assert passes == 2.0
    assert fams["pt"]["tpu_dra_placement_frag_score"][2]


# -- the ComputeDomain controller and CD plugin --------------------------

@pytest.fixture()
def cd_sides(tmp_path):
    made = {name: CDSide(name, tmp_path) for name in SIDES}
    yield made
    for side in made.values():
        side.close()


def test_cd_controller_gauges_match(cd_sides, fresh):
    got = {}
    for name, side in cd_sides.items():
        metrics = METRICS[name].ComputeDomainMetrics()
        ctl = side.controller_mod.ComputeDomainController(side.kube,
                                                          metrics=metrics)
        side._stops.append(lambda c=ctl, n=name: c.queue.shutdown(wait=True)
                           if n == "jax" else c.stop())
        # Only the direct reconciles below drive the controller: its
        # watches, which would reconcile the same domains on the queue's
        # thread at the same time, are stopped first on both sides.
        if name == "jax":
            side.kube._watchers.remove(ctl._on_event)
        else:
            side.kube.remove_resource_watcher(ctl._on_resource_event)
        cd = side.make_cd(numNodes=1)
        other = side.make_cd(name="cd2")
        for c in (cd, other):
            ctl.reconcile(c)
        side.set_status(side.get_cd(), [("node-0", "", 0, "")])
        ctl.reconcile(side.get_cd())
        steps = [parse(GENERATE[name](metrics.registry))]
        gone = side.get_cd()
        gone["metadata"]["deletionTimestamp"] = "2026-01-01T00:00:00Z"
        ctl.reconcile(gone)
        steps.append(parse(GENERATE[name](metrics.registry)))
        got[name] = steps
    assert got["pt"] == got["jax"]
    status = {dict(lb)["name"]: v for _, lb, v in
              got["pt"][0]["tpu_compute_domain_status"][2]}
    assert status == {"cd1": 1.0, "cd2": 0.0}
    assert [dict(lb)["name"] for _, lb, _ in
            got["pt"][1]["tpu_compute_domain_nodes"][2]] == ["cd2"]


def test_cd_driver_metrics_match(cd_sides, slow_clock, fresh):
    got = {}
    for name, side in cd_sides.items():
        metrics = METRICS[name].DRARequestMetrics()
        resilience = METRICS[name].ResilienceMetrics(
            registry=metrics.registry)
        cd = side.make_cd()
        side.set_status(cd, [("node-0", "", 0, "")])
        side.put_claim("c1", cd["metadata"]["uid"])
        st = side.state("node-0", "st")
        # The first retry's delay (0.25 s) is past the budget: a missing
        # claim is a gang abort at once.
        drv = side.cdd.CDDriver(st, side.kube, "node-0", metrics=metrics,
                                retry_timeout=0.2, resilience=resilience)
        out = [drv.prepare_resource_claims([_ref("c1")])["c1"][1],
               drv.prepare_resource_claims([_ref("nope")])["nope"][1] != "",
               drv.unprepare_resource_claims([{"uid": "c1"}])]
        fams = timeless(parse(GENERATE[name](metrics.registry)))
        got[name] = (fams, out)
    assert got["pt"] == got["jax"]
    assert got["pt"][1] == ["", True, {"c1": ""}]
    assert got["pt"][0]["tpu_dra_gang_abort"][2] == [
        ("tpu_dra_gang_abort_total", (), 1.0)]


# -- the retrying client --------------------------------------------------

class _Failing:
    """A client whose verbs fail with the queued exceptions first."""

    def __init__(self, errors):
        self.errors = list(errors)
        self.calls = []

    def _verb(self, verb, *a, **kw):
        self.calls.append((verb, kw.get("timeout")))
        if self.errors:
            raise self.errors.pop(0)
        return {"verb": verb}

    def get(self, *a, **kw):
        return self._verb("get", *a, **kw)

    def update(self, *a, **kw):
        return self._verb("update", *a, **kw)


@pytest.mark.parametrize("case", ["retried then ok", "conflict surfaced",
                                  "not found surfaced", "budget spent",
                                  "breaker opens"])
def test_retrying_client_matches(case):
    def errors(mod):
        kube = mod.__name__.replace("retry", "kubeclient")
        k = __import__(kube, fromlist=["KubeError"])
        return {"retried then ok": [k.KubeError(503, "x"),
                                    ConnectionResetError("reset"),
                                    k.KubeError(429, "slow")],
                "conflict surfaced": [k.ConflictError("c")],
                "not found surfaced": [k.NotFoundError("n")],
                "budget spent": [k.KubeError(500, "x")] * 50,
                "breaker opens": [k.KubeError(502, "x")] * 50}[case]

    got = {}
    for side, mod in (("jax", jax_retry), ("pt", pt_retry)):
        metrics = METRICS[side].ResilienceMetrics()
        clock = {"t": 0.0}
        inner = _Failing(errors(mod))
        client = mod.RetryingKubeClient(
            inner, policy=mod.RetryPolicy(deadline_s=5.0, jitter=0.0),
            breaker=mod.CircuitBreaker(threshold=4, reset_s=60,
                                       clock=lambda: clock["t"]),
            metrics=metrics, seed=0,
            sleep=lambda d: clock.__setitem__("t", clock["t"] + d),
            clock=lambda: clock["t"])
        outcomes = []
        for verb in ("get", "update"):
            try:
                outcomes.append(getattr(client, verb)("g", "v", "r", "n"))
            except Exception as e:  # noqa: BLE001 - the outcome compared
                outcomes.append([type(e).__name__, getattr(e, "status",
                                                           None)])
        got[side] = (outcomes, inner.calls, client.retry_count,
                     client.retries_by_verb, client.breaker.trips,
                     mod.classify(TimeoutError(), mod.RetryPolicy()),
                     parse(GENERATE[side](metrics.registry)))
    assert got["pt"] == got["jax"]


# -- the partition engine -------------------------------------------------

def test_partition_engine_metrics_and_spans_match(tmp_path, fresh):
    driver_root = write_fake_binaries(tmp_path / "driver")
    pair = {name: PartitionSide(name, str(tmp_path / name),
                                driver_root if name == "pt" else None)
            for name in SIDES}
    try:
        got = {}
        for name, side in pair.items():
            metrics = METRICS[name].PartitionMetrics()
            engine = side.state.partition_engine
            engine.metrics = metrics
            tracing = jax_tracing if name == "jax" else pt_tracing
            fr = jax_fr if name == "jax" else pt_fr
            steps = [side.step("prewarm", {"serv": 1}),
                     side.step("prepare", "t1", ("pt-serv-0",), True),
                     side.step("prepare", "t2", ("pt-serv-1",), True),
                     side.step("unprepare", "t1"),
                     side.step("unprepare", "t2"),
                     side.step("reap"), side.step("prewarm", {}),
                     side.step("reap")]
            spans = tracing.exporter().spans()
            ids = {s["span_id"]: s["name"] for s in spans}
            # The port's unprepare times its rollback as a segment
            # (SEGMENTS_ONLY), the JAX plugin's does not: the detach's
            # parent is that segment or the root.
            tree = sorted((s["name"], ids.get(s["parent_id"], "").replace(
                "unprep_rollback", ""), s["attrs"].get("device", ""))
                for s in spans if s["name"].startswith("partition"))
            events = [(e["event"], e.get("device"), e.get("destroyed"),
                       e.get("kept_warm"))
                      for e in fr.default().events()
                      if e["event"].startswith("partition_")]
            got[name] = (steps, parse(GENERATE[name](metrics.registry)),
                         tree, events)
        assert got["pt"] == got["jax"]
        fams = got["pt"][1]
        values = {n: s[0][2] for n, (_, _, s) in fams.items()}
        assert values == {"tpu_dra_partitions_active": 0.0,
                          "tpu_dra_partition_creates": 2.0,
                          "tpu_dra_partition_destroys": 2.0,
                          "tpu_dra_prewarm_created": 1.0,
                          "tpu_dra_prewarm_hit": 1.0,
                          "tpu_dra_prewarm_reaped": 1.0}
    finally:
        for side in pair.values():
            side.state.close() if side.name == "pt" else side.state.stop()
        assert kill_fake_daemons(driver_root) == []


# -- the server -----------------------------------------------------------

def _get(port: int, path: str) -> tuple[int, bytes]:
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                    timeout=10) as resp:
            return resp.status, resp.read()
    except urllib.error.HTTPError as e:
        return e.code, b""


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.mark.parametrize("host", ["127.0.0.1", "0.0.0.0"])
def test_metrics_server_routes_match(host, fresh, monkeypatch):
    monkeypatch.delenv("TPU_DRA_DEBUG_HTTP", raising=False)
    got = {}
    for side in SIDES:
        metrics = METRICS[side].ComputeDomainMetrics()
        metrics.status.labels("ns", "cd").set(1)
        tracing = jax_tracing if side == "jax" else pt_tracing
        fr = jax_fr if side == "jax" else pt_fr
        with tracing.span("op") as sp:
            trace = sp.context.trace_id
        fr.default().record("u1", "ev", alias="ns/c1")
        server = METRICS[side].MetricsServer(metrics.registry, host=host,
                                             port=_free_port())
        server.start()
        try:
            out = {}
            for path in ("/metrics", "/", "/debug/stacks", "/debug/traces",
                         f"/debug/traces/{trace}", "/debug/traces/nope",
                         "/debug/claims", "/debug/claims/u1",
                         "/debug/claims/ns/c1", "/debug/claims/none",
                         "/nope"):
                status, body = _get(server.port, path)
                if status == 200 and path.startswith("/debug/claims/"):
                    body = [e["event"] for e in json.loads(body)["events"]]
                elif status == 200 and path.startswith("/debug/traces/"):
                    body = [s["name"] for s in json.loads(body)["spans"]]
                elif status == 200 and path == "/debug/claims":
                    body = json.loads(body)
                elif status == 200 and path in ("/metrics", "/"):
                    body = parse(body)
                else:
                    body = None
                out[path.replace(trace, "<trace>")] = [status, body]
            for path in ("/debug/telemetry", "/debug/fleet"):
                status, body = _get(server.port, path)
                out[path] = [status, json.loads(body) if status == 200
                             else None]
        finally:
            server.stop()
        got[side] = out
    assert got["pt"]["/debug/fleet"][0] == (200 if host == "127.0.0.1"
                                            else 404)
    assert json.loads(json.dumps(got["pt"])) == \
        json.loads(json.dumps(got["jax"]))
    debug = got["pt"]["/debug/traces/<trace>"][0]
    assert debug == (200 if host == "127.0.0.1" else 404)


# -- telemetry, fleet, recovery and quarantine families --------------------

@pytest.mark.parametrize("seed", range(3))
def test_telemetry_metrics_expositions_match(seed):
    """A seeded stream of samples (GPUs coming and going, NVLink error
    counters rising and reset), and anomaly counts, through both
    ``TelemetryMetrics``."""
    import numpy as np

    from k8s_dra_driver_gpu_tpu.tpulib import binding as jax_lib
    from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as pt_lib

    rng = np.random.default_rng(seed)
    mets = {s: METRICS[s].TelemetryMetrics() for s in SIDES}
    errors = [0] * 4
    for _ in range(20):
        chips = sorted(rng.choice(4, size=int(rng.integers(0, 5)),
                                  replace=False).tolist())
        stream = []
        for c in chips:
            errors[c] += int(rng.integers(0, 4))
            if rng.random() < 0.05:
                errors[c] = 0  # a driver reload resets the counter
            stream.append(dict(chip=c, power_watts=float(rng.uniform(0, 700)),
                               temp_celsius=float(rng.integers(30, 90)),
                               hbm_used_bytes=int(rng.integers(0, 1 << 36)),
                               duty_cycle=float(rng.uniform(0, 1)),
                               ici_link_errors=errors[c]))
        kind = str(rng.choice(["thermal_drift", "power_cap_throttle",
                               "duty_cycle_straggler",
                               "ici_link_error_burst"]))
        anomaly = rng.random() < 0.3
        for s, lib in (("jax", jax_lib), ("pt", pt_lib)):
            mets[s].prune_absent(chips)
            for kw in stream:
                mets[s].observe_sample(lib.ChipTelemetry(**kw))
            if anomaly:
                mets[s].inc_anomaly(kind)
        fams = {s: parse(GENERATE[s](mets[s].registry)) for s in SIDES}
        assert fams["pt"] == fams["jax"]


@pytest.mark.parametrize("seed", range(3))
def test_fleet_metrics_expositions_match(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    mets = {s: METRICS[s].FleetMetrics() for s in SIDES}
    for _ in range(30):
        op = str(rng.choice(["pool", "pending", "node", "power",
                             "rm_power", "rm_pool", "rm_node", "fold"]))
        pool, node = f"drv/p{rng.integers(0, 3)}", f"n{rng.integers(0, 3)}"
        args = {"pool": (pool, float(rng.uniform()), int(rng.integers(9))),
                "pending": (int(rng.integers(0, 9)),),
                "node": (node, float(rng.integers(0, 2000)),
                         float(rng.integers(20, 90))),
                "power": (pool, float(rng.integers(0, 5000))),
                "rm_power": (pool,), "rm_pool": (pool,), "rm_node": (node,),
                "fold": (float(rng.uniform(0, 0.01)),)}[op]
        for s in SIDES:
            m = mets[s]
            {"pool": m.set_pool, "pending": m.set_pending,
             "node": m.set_node, "power": m.set_pool_power,
             "rm_power": m.remove_pool_power, "rm_pool": m.remove_pool,
             "rm_node": m.remove_node,
             "fold": m.fold_seconds.observe}[op](*args)
        fams = {s: parse(GENERATE[s](mets[s].registry)) for s in SIDES}
        assert fams["pt"] == fams["jax"]


@pytest.mark.parametrize("seed", range(3))
def test_recovery_metrics_expositions_match(seed):
    import numpy as np

    rng = np.random.default_rng(seed)
    mets = {s: METRICS[s].RecoveryMetrics() for s in SIDES}
    for _ in range(30):
        op = int(rng.integers(0, 7))
        label = str(rng.choice(["node", "device", "gang", "sweep",
                                "slice", "cdi_spec", "stale_claim"]))
        n = int(rng.integers(0, 5))
        for s in SIDES:
            m = mets[s]
            (lambda: m.permanent_failures.labels(label).inc(),
             m.evictions.inc, m.replaced.inc, m.failed.inc,
             lambda: m.active_evictions.set(n),
             lambda: m.orphans_repaired.labels(label).inc(n),
             lambda: m.reconcile_drift.labels(label).set(n))[op]()
        fams = {s: parse(GENERATE[s](mets[s].registry)) for s in SIDES}
        assert fams["pt"] == fams["jax"]


def test_quarantine_counter_matches():
    """Three flapping episodes on each side's tracker, its
    ``on_quarantine`` hook on ``ResilienceMetrics.quarantines`` as the
    kubelet ``Driver`` wires it."""
    from k8s_dra_driver_gpu_tpu.kubeletplugin import health as jax_health
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import health as pt_health

    got = {}
    for s, health, dev in (("jax", jax_health, "chip-2"),
                           ("pt", pt_health, "gpu-2")):
        res = METRICS[s].ResilienceMetrics()
        clock = [0.0]
        tracker = health.QuarantineTracker(
            threshold=2, window_s=60.0, hysteresis_s=30.0,
            on_quarantine=lambda d, r=res: r.quarantines.labels(d).inc(),
            clock=lambda: clock[0])
        taint = [health.DeviceTaint(device=dev, key="tpu.dra.dev/x",
                                    value="true", effect="")]
        for _ in range(3):
            for step in range(4):
                clock[0] += 1.0
                tracker.observe(taint if step % 2 == 0 else [])
            clock[0] += 100.0
            tracker.observe([])
        got[s] = neutral(json.dumps(parse(GENERATE[s](res.registry)),
                                    sort_keys=True))
    assert got["pt"] == got["jax"]
    assert '"tpu_dra_quarantine_total", [["device", "#2"]], 3.0' in got["pt"]


@pytest.mark.parametrize("seed", range(3))
def test_autoscale_metrics_expositions_match(seed):
    """``AutoscaleMetrics`` on each side's registry, driven by the same
    seeded operations (the controller's counters, its gauge and the
    rollout histogram over its buckets): the same exposition."""
    import numpy as np

    rng = np.random.default_rng(seed)
    mets = {s: METRICS[s].AutoscaleMetrics() for s in SIDES}
    for _ in range(40):
        op = int(rng.integers(0, 6))
        x = float(rng.choice([0.01, 0.07, 0.3, 1.7, 9.0, 45.0, 400.0]))
        n = int(rng.integers(0, 3))
        for s in SIDES:
            m = mets[s]
            (m.plans.inc, m.applies.inc, m.superseded.inc, m.converged.inc,
             lambda: m.active_rollouts.set(n),
             lambda: m.rollout_seconds.observe(x))[op]()
    fams = {s: parse(GENERATE[s](mets[s].registry)) for s in SIDES}
    assert fams["pt"] == fams["jax"]
    assert "tpu_dra_autoscale_rollout_seconds" in fams["pt"]
