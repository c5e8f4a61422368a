"""The port's tracing, flight recorder, segment timer and log filter
against the JAX package's (``pkg/{tracing,flightrecorder,timing,
logsetup}.py``), and the hook points that carry them: the kubelet
plugin's prepare span parented by the claim's traceparent annotation,
the CD plugin's channel prepare and its ``cd_prepare_done`` event, and
the CD controller's ``cd.reconcile``.

Each scenario runs on both packages with the same inputs (ids made from
seeds) and an exporter and recorder of its own; span trees are compared
by name and parent name, events with their timestamps left out.
"""

import json
import logging
import random
import threading

import pytest

from k8s_dra_driver_gpu_tpu.pkg import flightrecorder as jax_fr
from k8s_dra_driver_gpu_tpu.pkg import logsetup as jax_logsetup
from k8s_dra_driver_gpu_tpu.pkg import timing as jax_timing
from k8s_dra_driver_gpu_tpu.pkg import tracing as jax_tracing
from k8s_dra_driver_gpu_tpu_torch.pkg import flightrecorder as pt_fr
from k8s_dra_driver_gpu_tpu_torch.pkg import logsetup as pt_logsetup
from k8s_dra_driver_gpu_tpu_torch.pkg import timing as pt_timing
from k8s_dra_driver_gpu_tpu_torch.pkg import tracing as pt_tracing
from tests.fake_kube import make_claim_dict
from tests.test_torch_computedomain import Side as CDSide
from tests.test_torch_computedomain import _ref, nothing_left_behind  # noqa: F401

MODS = {"jax": (jax_tracing, jax_fr, jax_timing, jax_logsetup),
        "pt": (pt_tracing, pt_fr, pt_timing, pt_logsetup)}
SIDES = ("jax", "pt")
RC = ("resource.k8s.io", "v1", "resourceclaims")


@pytest.fixture()
def fresh(monkeypatch):
    """A new exporter and recorder in both packages, sampling on."""
    monkeypatch.delenv("TPU_DRA_TRACE_SAMPLE", raising=False)
    monkeypatch.delenv("TPU_DRA_TRACE_FILE", raising=False)
    saved = {}
    for name, (tracing, fr, _, _) in MODS.items():
        saved[name] = (tracing.exporter(), fr.default())
        tracing.set_exporter(tracing.TraceExporter())
        fr.set_default(fr.FlightRecorder())
    yield
    for name, (tracing, fr, _, _) in MODS.items():
        tracing.set_exporter(saved[name][0])
        fr.set_default(saved[name][1])


def tree(tracing) -> list:
    """The exported spans as (name, parent's name or the remote id),
    sorted; ids replaced by names so both packages compare."""
    spans = tracing.exporter().spans()
    names = {s["span_id"]: s["name"] for s in spans}
    return sorted((s["name"], names.get(s["parent_id"], s["parent_id"]))
                  for s in spans)


def on_both(fn):
    """fn(tracing, flightrecorder, timing, logsetup) of each package, as
    JSON; asserts they agree; the value."""
    got = {side: json.loads(json.dumps(fn(*MODS[side]), default=str))
           for side in SIDES}
    assert got["pt"] == got["jax"]
    return got["pt"]


# -- span contexts --------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_traceparent_round_trip_matches(seed):
    rng = random.Random(seed)
    trace_id = f"{rng.getrandbits(128) or 1:032x}"
    span_id = f"{rng.getrandbits(64) or 1:016x}"
    sampled = bool(seed % 2)

    def run(tracing, *_):
        ctx = tracing.SpanContext(trace_id, span_id, sampled)
        header = ctx.to_traceparent()
        back = tracing.SpanContext.from_traceparent(header.upper()
                                                    .replace("X", "x"))
        return header, tuple(back)
    header, back = on_both(run)
    assert header == f"00-{trace_id}-{span_id}-{'01' if sampled else '00'}"
    assert back == [trace_id, span_id, sampled]


MALFORMED = [
    "", "garbage", None, 42, "00-abc-def-01",
    "00-" + "0" * 32 + "-" + "1" * 16 + "-01",        # zero trace id
    "00-" + "1" * 32 + "-" + "0" * 16 + "-01",        # zero span id
    "00-" + "g" * 32 + "-" + "1" * 16 + "-01",        # not hex
    "0-" + "1" * 32 + "-" + "1" * 16 + "-01",         # short version
    "00-" + "1" * 32 + "-" + "1" * 16 + "-1",         # short flags
    "00-" + "1" * 31 + "-" + "1" * 16 + "-01",        # short trace id
    "00-" + "1" * 32 + "-" + "1" * 16 + "-01-extra",  # five fields
]


@pytest.mark.parametrize("header", MALFORMED, ids=repr)
def test_malformed_traceparent_is_none_in_both(header):
    for side in SIDES:
        tracing = MODS[side][0]
        assert tracing.SpanContext.from_traceparent(header) is None
        assert tracing.extract({tracing.TRACEPARENT_ANNOTATION: header}) \
            is None


def test_inject_extract_and_trace_id_of_match(fresh):
    def run(tracing, *_):
        with tracing.span("root") as sp:
            carrier = tracing.inject(sp, {"other": "x"})
        ctx = tracing.extract(carrier)
        unsampled = {tracing.TRACEPARENT_ANNOTATION:
                     ctx._replace(sampled=False).to_traceparent()}
        return (sorted(carrier), ctx.trace_id == sp.context.trace_id,
                ctx.span_id == sp.context.span_id,
                tracing.trace_id_of(carrier) == sp.context.trace_id,
                tracing.trace_id_of(unsampled), tracing.trace_id_of(None),
                tracing.extract({}))
    got = on_both(run)
    assert got[0] == ["other", "resource.tpu.dra/traceparent"]
    assert got[1:4] == [True, True, True] and got[4:] == ["", "", None]


# -- spans ----------------------------------------------------------------

def test_nesting_and_remote_parent_match(fresh):
    remote = "00-" + "ab" * 16 + "-" + "cd" * 8 + "-01"

    def run(tracing, *_):
        with tracing.span("a", attrs={"k": 1}) as a:
            with tracing.span("b"):
                with tracing.span("c") as c:
                    c.event("ev", x=1)
                    current = tracing.current_span().name
            with tracing.span("d"):
                pass
        assert tracing.current_span() is None
        parent = tracing.extract({tracing.TRACEPARENT_ANNOTATION: remote})
        with tracing.span("child", parent=parent) as ch:
            pass
        try:
            with tracing.span("boom"):
                raise ValueError("bad")
        except ValueError:
            pass
        spans = {s["name"]: s for s in tracing.exporter().spans()}
        return (tree(tracing), current, a.context.trace_id ==
                spans["b"]["trace_id"], ch.context.trace_id == "ab" * 16,
                spans["a"]["attrs"], spans["c"]["events"][0]["name"],
                spans["boom"]["error"], sorted(spans["a"]))
    got = on_both(run)
    assert got[0] == [["a", ""], ["b", "a"], ["boom", ""], ["c", "b"],
                      ["child", "cd" * 8], ["d", "a"]]
    assert got[1:4] == ["c", True, True]
    assert got[6] == "ValueError: bad"


def test_sampling_off_and_inherited_match(fresh, monkeypatch):
    def run(tracing, *_):
        monkeypatch.setenv("TPU_DRA_TRACE_SAMPLE", "0")
        with tracing.span("root") as root:
            monkeypatch.setenv("TPU_DRA_TRACE_SAMPLE", "1")
            # The unsampled root's decision is inherited: no re-roll.
            with tracing.span("child") as child:
                inner = tracing.current_span() is child
        unsampled = tracing.SpanContext("1" * 32, "2" * 16, sampled=False)
        with tracing.span("remote-child", parent=unsampled) as rc:
            pass
        monkeypatch.setenv("TPU_DRA_TRACE_SAMPLE", "nonsense")
        rate = tracing.sample_rate()
        return (root is tracing.NOOP_SPAN, child is tracing.NOOP_SPAN,
                rc is tracing.NOOP_SPAN, root.recording, inner,
                tracing.exporter().spans(), rate)
    assert on_both(run) == [True, True, True, False, True, [], 1.0]


def test_per_thread_stacks_match(fresh):
    def run(tracing, *_):
        seen = {}
        inside = threading.Event()
        done = threading.Event()

        def other():
            inside.wait(5)
            seen["other_current"] = tracing.current_span()
            with tracing.span("t2-root"):
                seen["t2"] = tracing.current_span().name
            done.set()

        t = threading.Thread(target=other)
        t.start()
        with tracing.span("t1-root"):
            inside.set()
            done.wait(5)
            seen["t1"] = tracing.current_span().name
        t.join(5)
        return seen, tree(tracing)
    seen, spans = on_both(run)
    assert seen == {"other_current": None, "t1": "t1-root",
                    "t2": "t2-root"}
    assert spans == [["t1-root", ""], ["t2-root", ""]]


# -- the exporter ---------------------------------------------------------

def _fixed_span(tracing, i: int):
    """A finished span with fixed ids and times, so its JSON line is the
    same in both packages."""
    ctx = tracing.SpanContext(f"{i + 1:032x}", f"{i + 1:016x}")
    sp = tracing.Span(f"s{i}", ctx, parent_id="", attrs={"i": i})
    sp.start_ts, sp.end_ts = 1000.0 + i, 1000.5 + i
    return sp


def test_ring_bound_and_traces_endpoint_match():
    def run(tracing, *_):
        exp = tracing.TraceExporter(max_spans=16)
        for i in range(40):
            exp.export(_fixed_span(tracing, i))
        status, ctype, body = exp.traces_endpoint()
        one = exp.trace_endpoint(f"{39 + 1:032x}")
        missing = exp.trace_endpoint("f" * 32)
        return (len(exp.spans()), exp.exported_total,
                [s["name"] for s in exp.spans()][:2], status, ctype,
                sorted(json.loads(body)["traces"])[:1], one[0],
                json.loads(one[2])["spans"][0]["name"], missing[0])
    got = on_both(run)
    assert got[:3] == [16, 40, ["s24", "s25"]]
    assert got[3] == 200 and got[6:] == [200, "s39", 404]


def test_jsonl_sink_and_rotation_match(tmp_path):
    def run(tracing, *_):
        d = tmp_path / tracing.__name__.split(".")[0]
        d.mkdir()
        path = d / "spans.jsonl"
        exp = tracing.TraceExporter(path=str(path), max_file_bytes=600,
                                    keep_files=2)
        for i in range(12):
            exp.export(_fixed_span(tracing, i))
        files = sorted(p.name for p in d.iterdir())
        lines = {p.name: [json.loads(x)["name"] for x in
                          p.read_text().splitlines()] for p in d.iterdir()}
        return files, lines
    files, lines = on_both(run)
    assert files == ["spans.jsonl", "spans.jsonl.1", "spans.jsonl.2"]
    assert lines["spans.jsonl"][-1] == "s11"


def test_broken_sink_disables_itself_in_both(tmp_path):
    def run(tracing, *_):
        exp = tracing.TraceExporter(path=str(tmp_path / "no" / "dir.jsonl"))
        exp.export(_fixed_span(tracing, 0))
        exp.export(_fixed_span(tracing, 1))
        return exp._file_broken, len(exp.spans())
    logging.disable(logging.CRITICAL)
    try:
        assert on_both(run) == [True, 2]
    finally:
        logging.disable(logging.NOTSET)


# -- the segment timer ----------------------------------------------------

def test_segment_timer_segments_are_child_spans(fresh):
    remote = "00-" + "12" * 16 + "-" + "34" * 8 + "-01"

    def run(tracing, fr, timing, _):
        parent = tracing.extract({tracing.TRACEPARENT_ANNOTATION: remote})
        timer = timing.SegmentTimer("prepare", "uid-1", parent=parent)
        with timer.segment("a"):
            with timer.segment("b"):
                pass
        with timer.segment("a"):
            pass
        total = timer.done()
        spans = {s["name"]: s for s in tracing.exporter().spans()}
        root = spans["prepare"]
        bare = timing.SegmentTimer("unprepare")
        bare.done()
        return (tree(tracing), timer.trace_id, sorted(root["attrs"]),
                root["attrs"]["claim_uid"], sorted(timer.segments),
                total >= timer.segments["a"], bare.trace_id != "")
    got = on_both(run)
    # A segment is the operation's child even inside another segment.
    assert got[0] == [["a", "prepare"], ["a", "prepare"], ["b", "prepare"],
                      ["prepare", "34" * 8], ["unprepare", ""]]
    assert got[1] == "12" * 16
    assert got[2] == ["claim_uid", "t_a_ms", "t_b_ms", "total_ms"]
    assert got[3:] == ["uid-1", ["a", "b"], True, True]


# -- the flight recorder --------------------------------------------------

def _strip_ts(events):
    return [{k: v for k, v in ev.items() if k != "ts"} for ev in events]


def test_flight_recorder_keys_aliases_and_ring_match():
    def run(tracing, fr, *_):
        rec = fr.FlightRecorder(capacity=16)
        rec.record("ns/c1", "enqueued")           # before the uid
        rec.record("u1", "prepare_done", alias="ns/c1", trace_id="t" * 32,
                   ms=1.5)
        rec.record("u1", "prepare_segments", prep_devices_ms=0.2)
        rec.record("u2", "other")
        rec.record("", "dropped")                  # no key: not kept
        by_uid = _strip_ts(rec.events("u1"))
        by_name = _strip_ts(rec.events("ns/c1"))
        index = rec.index_endpoint()
        one = rec.claims_endpoint("ns/c1")
        none = rec.claims_endpoint("nobody")
        for i in range(40):
            rec.record(f"k{i}", "fill")
        dump = rec.dump("u1")
        return (by_uid, by_name, json.loads(index[2]), one[0],
                _strip_ts(json.loads(one[2])["events"]), none[0],
                len(rec.events()), rec.recorded_total, rec.keys()[:2], dump)
    got = on_both(run)
    assert got[0] == got[1] and len(got[0]) == 3
    assert got[0][1] == {"key": "u1", "event": "prepare_done",
                         "alias": "ns/c1", "trace_id": "t" * 32, "ms": 1.5}
    assert got[2] == {"claims": ["ns/c1", "u1", "u2"]}
    assert got[3] == 200 and got[5] == 404
    assert got[6:9] == [16, 44, ["k24", "k25"]]
    assert got[9] == "(no flight-recorder events for 'u1')"


# -- the log filter -------------------------------------------------------

def test_trace_context_filter_matches(fresh):
    def run(tracing, fr, timing, logsetup):
        filt = logsetup.TraceContextFilter()
        out = []
        for active in (False, True):
            record = logging.LogRecord("x", logging.INFO, "f", 1, "m", (),
                                       None)
            if active:
                with tracing.span("op", attrs={"claim_uid": "u9"}) as sp:
                    filt.filter(record)
                    out.append((record.trace_id == sp.context.trace_id,
                                record.claim_uid))
            else:
                filt.filter(record)
                out.append((record.trace_id, record.claim_uid))
        return (out, logsetup.FORMAT, [logsetup.level_for(v)
                                       for v in (0, 2, 4, 6)])
    got = on_both(run)
    assert got[0] == [["", ""], [True, "u9"]]
    assert "[trace=%(trace_id)s]" in got[1]


# -- the hook points ------------------------------------------------------

TRACEPARENT = "00-" + "5e" * 16 + "-" + "7a" * 8 + "-01"


def test_kubelet_prepare_span_is_parented_by_the_annotation(fresh, tmp_path):
    """The kubelet plugin's prepare: a ``prepare`` span whose parent is
    the annotation's span, its segments as children, and the
    ``prepare_done`` / ``prepare_segments`` events under the uid. The
    segment names the two packages do not share are by design: the JAX
    plugin's group-committed checkpoint writer (``ckpt_fsync_wait``) and
    shard-lock reservation (``prep_reserved``); the port's sharing setup
    (``prep_sharing``)."""
    from k8s_dra_driver_gpu_tpu.kubeletplugin import DRIVER_NAME as JAX_DRV
    from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
    from k8s_dra_driver_gpu_tpu.kubeletplugin import driver as jax_driver
    from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import \
        DRIVER_NAME as PT_DRV
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import \
        device_state as pt_ds
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import driver as pt_driver
    from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
    only = {"jax": {"ckpt_fsync_wait", "prep_reserved"},
            "pt": {"prep_sharing"}}
    got = {}
    for side in SIDES:
        tracing, fr = MODS[side][:2]
        root = str(tmp_path / side)
        if side == "jax":
            cfg = jax_ds.Config.mock(root=root, topology="v5e-4", gates="")
            kube, mod, dev, drv = (jax_kube.FakeKubeClient(), jax_driver,
                                   "chip-0", JAX_DRV)
        else:
            cfg = pt_ds.Config.mock(root=root, topology="h100-4")
            kube, mod, dev, drv = (pt_kube.FakeKubeClient(), pt_driver,
                                   "gpu-0", PT_DRV)
        d = mod.Driver(cfg, kube, node_name="n", enable_health_monitor=False,
                       publication_mode="combined")
        try:
            obj = make_claim_dict("u1", [dev], namespace="ns", name="c1",
                                  driver=drv)
            obj["metadata"]["annotations"] = {
                tracing.TRACEPARENT_ANNOTATION: TRACEPARENT}
            kube.create(*RC, obj, namespace="ns")
            out = d.prepare_resource_claims(
                [{"uid": "u1", "namespace": "ns", "name": "c1"}])
            assert out["u1"][1] == ""
            d.unprepare_resource_claims([{"uid": "u1"}])
        finally:
            d.stop()
        spans = tracing.exporter().spans()
        prep = [s for s in spans if s["name"] == "prepare"]
        assert len(prep) == 1 and prep[0]["parent_id"] == "7a" * 8
        assert prep[0]["trace_id"] == "5e" * 16
        children = {s["name"] for s in spans
                    if s["parent_id"] == prep[0]["span_id"]}
        # ckpt_fsync_wait is a segment the JAX timer sets, not a span.
        assert only[side] - {"ckpt_fsync_wait"} <= children
        events = _strip_ts(fr.default().events("ns/c1"))
        names = [e["event"] for e in events]
        done = events[names.index("prepare_done")]
        got[side] = (sorted(children - only[side]), names,
                     sorted(done), done["trace_id"], done["alias"],
                     sorted(events[names.index("prepare_segments")]))
    assert got["pt"][:5] == got["jax"][:5]
    assert got["pt"][3] == "5e" * 16
    seg_keys = {side: set(got[side][5]) - {f"{s}_ms" for s in only[side]}
                for side in SIDES}
    assert seg_keys["pt"] == seg_keys["jax"]


@pytest.fixture()
def cd_sides(tmp_path):
    made = {name: CDSide(name, tmp_path) for name in SIDES}
    yield made
    for side in made.values():
        side.close()


class _FlakyClaimGets:
    """The client, whose first ``n`` gets of a ResourceClaim answer 404
    (a claim not visible yet): the CD driver retries them."""

    def __init__(self, kube, not_found, n: int):
        self.kube, self.not_found, self.left = kube, not_found, n

    def __getattr__(self, name):
        return getattr(self.kube, name)

    def get(self, group, version, resource, *a, **kw):
        if resource == "resourceclaims" and self.left > 0:
            self.left -= 1
            raise self.not_found(f"{resource}/{a[0]}")
        return self.kube.get(group, version, resource, *a, **kw)


def test_cd_prepare_done_carries_the_retries_and_nothing_stays(
        fresh, cd_sides):
    """§3 item 11: the port's ``CDDriver`` keeps no per-claim map; the
    retries of a prepare go into the claim's ``cd_prepare_done`` event,
    with the JAX event's keys and count. After the unprepare nothing of
    the claim is left in the driver or its state."""
    got = {}
    for name, side in cd_sides.items():
        tracing, fr = MODS[name][:2]
        cd = side.make_cd()
        side.set_status(cd, [("node-0", "", 0, "")])
        side.put_claim("c1", cd["metadata"]["uid"])
        claim = side.kube.get(*RC, "c1", namespace="team-a")
        claim["metadata"]["annotations"] = {
            tracing.TRACEPARENT_ANNOTATION: TRACEPARENT}
        side.kube.update(*RC, "c1", claim, namespace="team-a")
        st = side.state("node-0", "st")
        not_found = __import__(side.cdd.__name__, fromlist=["NotFoundError"]
                               ).NotFoundError
        drv = side.cdd.CDDriver(st, _FlakyClaimGets(side.kube, not_found, 2),
                                "node-0", retry_timeout=10.0)
        out = drv.prepare_resource_claims([_ref("c1")])
        assert out["c1"][1] == ""
        assert drv.unprepare_resource_claims([{"uid": "c1"}]) == {"c1": ""}
        assert st.prepared_claims() == {}
        events = _strip_ts(fr.default().events("c1"))
        done = [e for e in events if e["event"] == "cd_prepare_done"]
        assert len(done) == 1
        spans = tracing.exporter().spans()
        got[name] = ({k: v for k, v in done[0].items() if k != "ms"},
                     sorted(done[0]), [e["event"] for e in events],
                     tree(tracing))
        if name == "pt":
            for attr, value in vars(drv).items():
                if isinstance(value, (dict, set, list, tuple)):
                    assert "c1" not in repr(value), attr
            assert not hasattr(drv, "retries")
        prep = [s for s in spans if s["name"] == "cd_prepare"]
        assert prep and all(s["parent_id"] == "7a" * 8 for s in prep)
    assert got["pt"] == got["jax"]
    assert got["pt"][0] == {"key": "c1", "event": "cd_prepare_done",
                            "alias": "team-a/c1", "trace_id": "5e" * 16,
                            "retries": 2}
    assert got["pt"][1] == ["alias", "event", "key", "ms", "retries",
                            "trace_id"]


def test_cd_reconcile_span_and_event_match(fresh, cd_sides):
    got = {}
    for name, side in cd_sides.items():
        tracing, fr = MODS[name][:2]
        ctl = side.controller()
        cd = side.make_cd()
        ctl.reconcile(cd)
        spans = [s for s in tracing.exporter().spans()
                 if s["name"] == "cd.reconcile"]
        events = _strip_ts(fr.default().events(cd["metadata"]["uid"]))
        assert events == _strip_ts(fr.default().events("team-a/cd1"))
        got[name] = ([[s["parent_id"], sorted(s["attrs"]),
                       s["attrs"]["domain"]] for s in spans],
                     [{k: v for k, v in e.items() if k not in
                       ("key", "trace_id")} for e in events],
                     all(e["trace_id"] == spans[0]["trace_id"]
                         for e in events))
    assert got["pt"] == got["jax"]
    assert got["pt"][0] == [["", ["claim_uid", "domain"], "team-a/cd1"]]
    assert got["pt"][1] == [{"event": "cd_reconcile", "alias": "team-a/cd1",
                             "deleting": False}]
