"""The port's incident bundles (``pkg/doctor.py``) against the JAX
package's: the correlated report from the same crawls, the same members
and manifest from the same surfaces (a live port ``MetricsServer`` on
127.0.0.1), the automatic bundle (nothing without a directory, one an
interval, never an exception), the CLI with an unreachable target, and
the two callers: the eviction controller at a blown deadline and the
ComputeDomain plugin at a gang abort.

Both packages read ``TPU_DRA_DOCTOR_DIR``; where both run in one test,
each writes into its own directory in turn. Every test joins the
``doctor-bundle`` threads it started before it returns.
"""

import json
import os
import tarfile
import threading
import time

import pytest

from k8s_dra_driver_gpu_tpu.pkg import doctor as jax_doctor
from k8s_dra_driver_gpu_tpu.pkg import fleetstate as jax_fleet
from k8s_dra_driver_gpu_tpu.pkg import flightrecorder as jax_fr
from k8s_dra_driver_gpu_tpu.pkg import tracing as jax_tracing
from k8s_dra_driver_gpu_tpu_torch.pkg import doctor as pt_doctor
from k8s_dra_driver_gpu_tpu_torch.pkg import fleetstate as pt_fleet
from k8s_dra_driver_gpu_tpu_torch.pkg import flightrecorder as pt_fr
from k8s_dra_driver_gpu_tpu_torch.pkg import metrics as pt_metrics
from k8s_dra_driver_gpu_tpu_torch.pkg import tracing as pt_tracing

DOCTORS = {"jax": jax_doctor, "pt": pt_doctor}
LOCAL = {f"local/debug/{name}" for name in (
    "traces.json", "claims.json", "stacks.txt", "telemetry.json",
    "fleet.json")}


def join_bundles():
    for t in threading.enumerate():
        if t.name == "doctor-bundle":
            t.join(timeout=30)
            assert not t.is_alive()


@pytest.fixture(autouse=True)
def fresh(monkeypatch):
    """Fresh rings in both packages, no doctor env, the rate limits
    reset; the bundle threads joined after."""
    for var in (pt_doctor.ENV_DOCTOR_DIR, pt_doctor.ENV_DOCTOR_ENDPOINTS,
                pt_doctor.ENV_DOCTOR_MIN_INTERVAL):
        monkeypatch.delenv(var, raising=False)
    saved = []
    for fr, tr, fleet in ((pt_fr, pt_tracing, pt_fleet),
                          (jax_fr, jax_tracing, jax_fleet)):
        saved.append((fr, tr, fleet, fr.default(), tr.exporter(),
                      fleet.default_ring()))
        fr.set_default(fr.FlightRecorder())
        tr.set_exporter(tr.TraceExporter())
        fleet.set_default_ring(fleet.TelemetryRing())
    for doc in DOCTORS.values():
        doc.reset_rate_limit()
    yield
    join_bundles()
    for doc in DOCTORS.values():
        doc.reset_rate_limit()
    for fr, tr, fleet, recorder, exporter, ring in saved:
        fr.set_default(recorder)
        tr.set_exporter(exporter)
        fleet.set_default_ring(ring)


@pytest.fixture()
def server():
    """A live port MetricsServer with the debug routes, one claim's story
    in the flight recorder and one trace in the exporter."""
    pt_fr.default().record("u-probe", "prepare_done", alias="default/probe",
                           ms=4.2)
    pt_fr.default().record("u-probe", "unprepare_segments", ms=1.0)
    with pt_tracing.span("prepare"):
        pass
    metrics = pt_metrics.DRARequestMetrics()
    srv = pt_metrics.MetricsServer(metrics.registry)
    srv.start()
    yield f"http://127.0.0.1:{srv.port}"
    srv.stop()


def members(path):
    with tarfile.open(path) as tar:
        names = set(tar.getnames())
        docs = {n: json.load(tar.extractfile(n))
                for n in names if n.endswith(".json")}
    return names, docs


def bundles(d):
    if not os.path.isdir(d):
        return []
    return sorted(f for f in os.listdir(d) if f.endswith(".tar.gz"))


# -- the report -------------------------------------------------------------------

def _body(doc) -> dict:
    return {"body": json.dumps(doc).encode()}


CRAWLS = {
    "full": {
        "scheduler": {
            "metrics": {"body": b'tpu_dra_anomaly_total{kind="hot"} 2\n'
                                b'other_total 1\n'},
            "debug/traces": _body({"traces": {"t1": [{}, {}], "t2": [{}]}}),
            "debug/claims": _body({"claims": ["u1"]}),
            "debug/claims/u1": _body({"key": "u1", "events": [
                {"ts": 2.0, "event": "bound"},
                {"ts": 1.0, "event": "enqueued"}]}),
            "debug/stacks": {"error": "URLError: refused"},
        },
        "plugin": {
            "metrics": {"body": b'tpu_dra_anomaly_total{kind="hot"} 1.5\n'
                                b'tpu_dra_anomaly_total{kind="x"} bad\n'},
            "debug/traces": _body({"traces": {"t1": [{}]}}),
            # No key: the path's tail names the claim.
            "debug/claims/u1": _body({"events": [
                {"ts": 1.5, "event": "prepare_done"}]}),
            "debug/claims/default/u2": {"body": b"{not json"},
        },
    },
    "nothing but errors": {
        "gone": {p: {"error": "URLError"} for p in pt_doctor.SURFACE_PATHS},
    },
    "no targets": {},
}


@pytest.mark.parametrize("name", sorted(CRAWLS))
def test_the_report_matches_the_reference(name):
    got = pt_doctor._correlate(CRAWLS[name])
    assert got == jax_doctor._correlate(CRAWLS[name])
    if name == "full":
        assert [e["event"] for e in got["claims"]["u1"]] == [
            "enqueued", "prepare_done", "bound"]
        assert got["trace_span_counts"] == {"t1": 3, "t2": 1}
        assert got["anomaly_counters"] == {
            'tpu_dra_anomaly_total{kind="hot"}': 3.5}


def test_the_constants_match_the_reference():
    for name in ("SURFACE_PATHS", "MAX_CLAIM_FETCH", "_FETCH_TIMEOUT_S",
                 "ENV_DOCTOR_DIR", "ENV_DOCTOR_ENDPOINTS",
                 "ENV_DOCTOR_MIN_INTERVAL"):
        assert getattr(pt_doctor, name) == getattr(jax_doctor, name)
    assert pt_doctor.bundle_path("/d", "gang-abort", 0.0) == \
        jax_doctor.bundle_path("/d", "gang-abort", 0.0)


# -- the bundle -------------------------------------------------------------------

def test_the_same_members_from_the_same_surfaces(tmp_path, server):
    extra = {"local/debug/claims.json": b'{"events": []}',
             "notes/extra.txt": b"x"}
    got = {}
    for side, doc in DOCTORS.items():
        path = doc.collect_bundle({"plugin": server}, str(tmp_path / side),
                                  claim="u-probe", trigger="manual",
                                  extra_members=extra)
        assert os.listdir(tmp_path / side) == [os.path.basename(path)]
        names, docs = members(path)
        manifest, report = docs["manifest.json"], docs["report.json"]
        got[side] = (names, sorted(manifest), manifest["errors"],
                     manifest["targets"], manifest["surface_paths"],
                     manifest["trigger"], report)
    assert got["pt"] == got["jax"]
    names, _, errors, _, _, _, report = got["pt"]
    assert {f"plugin/{p}{'.txt' if p in ('metrics', 'debug/stacks') else '.json'}"
            for p in pt_doctor.SURFACE_PATHS} <= names
    assert "plugin/debug/claims/u-probe.json" in names
    assert errors == {}
    assert [e["event"] for e in report["focus_events"]["u-probe"]] == [
        "prepare_done", "unprepare_segments"]
    assert sum(report["trace_span_counts"].values()) == 1


def test_a_bundle_is_renamed_into_place_whole(tmp_path, monkeypatch):
    # The tar is written under a hidden name: while it is written, no
    # *.tar.gz exists; a write that fails leaves nothing.
    seen = []
    real = pt_doctor._member

    def member(tar, name, body, mtime):
        seen.append(bundles(tmp_path))
        if name == "manifest.json":
            raise OSError("disk full")
        real(tar, name, body, mtime)
    monkeypatch.setattr(pt_doctor, "_member", member)
    with pytest.raises(OSError, match="disk full"):
        pt_doctor.collect_bundle({}, str(tmp_path),
                                 extra_members={"a.txt": b"a"})
    assert seen and all(s == [] for s in seen)
    assert os.listdir(tmp_path) == []


# -- automatic bundles ------------------------------------------------------------

def test_no_bundle_without_a_directory():
    for doc in DOCTORS.values():
        assert doc.auto_bundle("gang-abort", claim="u1") is None


def test_one_bundle_an_interval_with_the_local_rings_and_peers(
        tmp_path, monkeypatch, server):
    monkeypatch.setenv(pt_doctor.ENV_DOCTOR_MIN_INTERVAL, "3600")
    monkeypatch.setenv(pt_doctor.ENV_DOCTOR_ENDPOINTS,
                       f"plugin={server}, gone=http://127.0.0.1:9,bad")
    jax_fr.default().record("u-gang", "gang_abort", error="deadline")
    pt_fr.default().record("u-gang", "gang_abort", error="deadline")
    got = {}
    for side, doc in DOCTORS.items():
        monkeypatch.setenv(pt_doctor.ENV_DOCTOR_DIR, str(tmp_path / side))
        path = doc.auto_bundle("gang-abort", claim="u-gang")
        assert os.path.basename(path).endswith("-gang-abort.tar.gz")
        # Rate-limited: a second trigger is swallowed.
        assert doc.auto_bundle("gang-abort", claim="u-gang") is None
        join_bundles()
        assert bundles(tmp_path / side) == [os.path.basename(path)]
        names, docs = members(path)
        manifest = docs["manifest.json"]
        local = docs["local/debug/claims.json"]
        assert any(e["key"] == "u-gang" and e["event"] == "gang_abort"
                   for e in local["events"])
        got[side] = (names - {n for n in names
                              if n.startswith("plugin/debug/claims/")},
                     sorted(manifest["errors"]), manifest["targets"],
                     manifest["trigger"])
    assert got["pt"] == got["jax"]
    names, errors, targets, trigger = got["pt"]
    assert LOCAL | {"report.json", "manifest.json", "plugin/metrics.txt",
                    "plugin/debug/stacks.txt"} <= names
    assert errors and all(e.startswith("gone/") for e in errors)
    assert sorted(targets) == ["gone", "plugin"] and trigger == "gang-abort"


def test_a_doctor_failure_never_raises(tmp_path, monkeypatch):
    for doc in DOCTORS.values():
        monkeypatch.setenv(pt_doctor.ENV_DOCTOR_DIR, "/proc/no-such-dir/x")
        doc.reset_rate_limit()
        assert doc.auto_bundle("eviction-deadline") is None
    # A failure on the thread is logged: the path was handed out, no file
    # lands and nothing raises.
    monkeypatch.setenv(pt_doctor.ENV_DOCTOR_DIR, str(tmp_path))
    pt_doctor.reset_rate_limit()

    def broken(*a, **kw):
        raise RuntimeError("tar failed")
    monkeypatch.setattr(pt_doctor, "collect_bundle", broken)
    assert pt_doctor.auto_bundle("eviction-deadline", claim="u1")
    join_bundles()
    assert os.listdir(tmp_path) == []


# -- the CLI ----------------------------------------------------------------------

def test_the_cli_records_an_unreachable_target(tmp_path, capsys):
    got = {}
    for side, doc in DOCTORS.items():
        assert doc.main(["gone=http://127.0.0.1:9",
                         "--out-dir", str(tmp_path / side)]) == 0
        path = capsys.readouterr().out.strip()
        _, docs = members(path)
        got[side] = sorted(docs["manifest.json"]["errors"])
    assert got["pt"] == got["jax"] == sorted(
        f"gone/{p}" for p in pt_doctor.SURFACE_PATHS)


def test_the_cli_focuses_a_claim(tmp_path, capsys, server):
    assert pt_doctor.main([f"plugin={server}", "--out-dir", str(tmp_path),
                           "--claim", "u-probe"]) == 0
    _, docs = members(capsys.readouterr().out.strip())
    report = docs["report.json"]
    assert report["focus_claim"] == "u-probe"
    assert {e["source"] for e in report["focus_events"]["u-probe"]} == {
        "plugin"}
    with pytest.raises(SystemExit):
        pt_doctor.main(["no-url", "--out-dir", str(tmp_path)])


# -- the callers ------------------------------------------------------------------

def test_a_blown_eviction_deadline_drops_a_bundle(tmp_path, monkeypatch):
    from tests.test_recovery import make_pending_claim, set_ready
    from tests.test_torch_recovery import Cluster

    # The JAX controller runs in the same passes: its doctor is held at
    # its rate limit, so only the port's writes here.
    monkeypatch.setenv(pt_doctor.ENV_DOCTOR_DIR, str(tmp_path / "bundles"))
    monkeypatch.setenv(pt_doctor.ENV_DOCTOR_MIN_INTERVAL, "3600")
    jax_doctor._auto_last = time.monotonic()
    c = Cluster(tmp_path / "c", monkeypatch, nodes=("node-a",),
                notready_grace_s=0.0, deadline_s=0.3)
    c.each(lambda k: make_pending_claim(k, "c0"))
    c.sync(2)
    victim = c.alloc("c0")
    uid = c.kubes["pt"].get("resource.k8s.io", "v1", "resourceclaims",
                            "c0", "default")["metadata"]["uid"]
    c.each(lambda k: set_ready(k, victim, False))
    c.sync(3)
    assert bundles(tmp_path / "bundles") == []
    time.sleep(0.35)
    c.sync(2)
    assert c.condition("c0")["reason"] == "RecoveryDeadlineExceeded"
    join_bundles()
    (name,) = bundles(tmp_path / "bundles")
    assert name.endswith("-eviction-deadline.tar.gz")
    names, docs = members(str(tmp_path / "bundles" / name))
    assert LOCAL <= names
    assert any(e["key"] == uid and e["event"] == "eviction"
               and e.get("state") == "DeadlineExceeded"
               for e in docs["local/debug/claims.json"]["events"])


def test_a_gang_abort_drops_one_bundle_for_two_aborts(tmp_path, monkeypatch):
    from tests.test_torch_computedomain import Side, _ref

    got = {}
    for name, doc in DOCTORS.items():
        out = tmp_path / f"bundles-{name}"
        monkeypatch.setenv(pt_doctor.ENV_DOCTOR_DIR, str(out))
        doc.reset_rate_limit()
        side = Side(name, tmp_path)
        try:
            cd = side.make_cd(topology="", numNodes=2)
            side.set_status(cd, [("node-0", "0", 0, "127.0.0.1")],
                            status="NotReady")
            side.put_claim("w0", cd["metadata"]["uid"])
            drv = side.cdd.CDDriver(side.state("node-0", "st"), side.kube,
                                    "node-0", retry_timeout=0.3)
            for _ in range(2):
                assert drv.prepare_resource_claims([_ref("w0")])["w0"][1]
            assert drv.gang_aborts == 2
            join_bundles()
        finally:
            side.close()
        (bundle,) = bundles(out)
        assert bundle.endswith("-gang-abort.tar.gz")
        names, docs = members(str(out / bundle))
        assert [e["event"] for e in docs["local/debug/claims.json"]["events"]
                if e["key"] == "w0" and e["event"] == "gang_abort"] == [
            "gang_abort"]
        got[name] = (names, docs["manifest.json"]["trigger"],
                     docs["report.json"]["focus_claim"])
    assert got["pt"] == got["jax"]
    assert LOCAL | {"report.json", "manifest.json"} == got["pt"][0]
