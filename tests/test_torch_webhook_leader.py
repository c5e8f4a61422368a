"""The port's admission webhook, its TLS bootstrap and the Lease leader
election against the JAX package's (``webhook/{main,certbootstrap}.py``,
``pkg/leaderelection.py``), after the JAX package's
``tests/test_webhook_leader.py``; and the port's controller binary,
two replicas with leader election over the fake API server, with a
takeover after SIGTERM.

The webhook's table runs on both packages: each side's review carries
its own driver name, config kind and apiVersion (``TpuConfig`` of
``tpu.dra.dev`` <-> ``GpuConfig`` of ``gpu.nvidia.com``), and the
responses are compared with those names mapped (``neutral``).
"""

import base64
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import pytest

from k8s_dra_driver_gpu_tpu.api import decode as jax_decode
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg import leaderelection as jax_le
from k8s_dra_driver_gpu_tpu.pkg import retry as jax_retry
from k8s_dra_driver_gpu_tpu.webhook import certbootstrap as jax_cb
from k8s_dra_driver_gpu_tpu.webhook import main as jax_webhook
from k8s_dra_driver_gpu_tpu_torch.api import decode as pt_decode
from k8s_dra_driver_gpu_tpu_torch.computedomain import (API_GROUP,
                                                        API_VERSION,
                                                        FINALIZER)
from k8s_dra_driver_gpu_tpu_torch.pkg import fakeapiserver as pt_server
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import leaderelection as pt_le
from k8s_dra_driver_gpu_tpu_torch.pkg import retry as pt_retry
from k8s_dra_driver_gpu_tpu_torch.webhook import certbootstrap as pt_cb
from k8s_dra_driver_gpu_tpu_torch.webhook import main as pt_webhook
from tests.test_torch_computedomain import child_pids, free_port
from tests.test_torch_computedomain import nothing_left_behind  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIDES = ("jax", "pt")
NAMES = {"jax": {"driver": "tpu.dra.dev", "kind": "TpuConfig",
                 "api": jax_decode.API_VERSION},
         "pt": {"driver": "gpu.nvidia.com", "kind": "GpuConfig",
                "api": pt_decode.API_VERSION}}
WEBHOOK = {"jax": jax_webhook, "pt": pt_webhook}
CERTS = {"jax": jax_cb, "pt": pt_cb}
KUBE = {"jax": jax_kube, "pt": pt_kube}
LE = {"jax": jax_le, "pt": pt_le}
LEASE = ("coordination.k8s.io", "v1", "leases")


def neutral(side: str, obj):
    text = json.dumps(obj, sort_keys=True)
    for key in ("driver", "kind", "api"):
        text = text.replace(NAMES[side][key], f"<{key}>")
    return json.loads(text)


def review(obj, uid="r1"):
    return {"apiVersion": "admission.k8s.io/v1", "kind": "AdmissionReview",
            "request": {"uid": uid, "object": obj}}


def claim_with_config(side, body, kind="ResourceClaim",
                      api="resource.k8s.io/v1", driver=None, params=None):
    if params is None:
        params = {"apiVersion": NAMES[side]["api"],
                  "kind": NAMES[side]["kind"], **body}
    spec = {"devices": {"requests": [{"name": "dev"}], "config": [{
        "opaque": {"driver": driver or NAMES[side]["driver"],
                   "parameters": params}}]}}
    if kind == "ResourceClaimTemplate":
        return {"apiVersion": api, "kind": kind, "spec": {"spec": spec}}
    return {"apiVersion": api, "kind": kind, "spec": spec}


GOOD = {"sharing": {"strategy": "TimeSlicing",
                    "timeSlicing": {"interval": "Short"}}}
BAD_FIELD = {**GOOD, "bogus": 1}
BAD_VALUE = {"sharing": {"strategy": "TimeSlicing",
                         "timeSlicing": {"interval": "Turbo"}}}

# name -> side -> AdmissionReview (the JAX tests' matrix, one review a
# row: tests/test_webhook_leader.py:61-124).
REVIEWS = {
    "valid config allowed": lambda s: review(claim_with_config(s, GOOD)),
    "unknown field refused": lambda s: review(
        claim_with_config(s, BAD_FIELD)),
    "invalid value refused": lambda s: review(
        claim_with_config(s, BAD_VALUE)),
    "template nested spec": lambda s: review(claim_with_config(
        s, BAD_VALUE, kind="ResourceClaimTemplate")),
    "valid template allowed": lambda s: review(claim_with_config(
        s, GOOD, kind="ResourceClaimTemplate")),
    "other driver ignored": lambda s: review(claim_with_config(
        s, None, driver="other.dev", params={"kind": "Whatever"})),
    "v1beta1 checked": lambda s: review(claim_with_config(
        s, BAD_VALUE, api="resource.k8s.io/v1beta1")),
    "v1beta2 checked": lambda s: review(claim_with_config(
        s, BAD_VALUE, api="resource.k8s.io/v1beta2")),
    "unsupported version ignored": lambda s: review(claim_with_config(
        s, BAD_VALUE, api="resource.k8s.io/v1alpha3")),
    "non-claim kind allowed": lambda s: review(
        {"apiVersion": "v1", "kind": "Pod"}),
    "uid echoed": lambda s: review(claim_with_config(s, GOOD), uid="xyz"),
    "wrong apiVersion refused": lambda s: review(claim_with_config(
        s, None, params={"apiVersion": "wrong/v1",
                         "kind": NAMES[s]["kind"]})),
    "unknown kind refused": lambda s: review(claim_with_config(
        s, None, params={"apiVersion": NAMES[s]["api"], "kind": "Nope"})),
    "empty request allowed": lambda s: {"apiVersion": "admission.k8s.io/v1",
                                        "kind": "AdmissionReview"},
    "computedomain indivisible slices refused": lambda s: review({
        "apiVersion": "resource.tpu.dra/v1beta1", "kind": "ComputeDomain",
        "spec": {"numNodes": 3, "numSlices": 2}}),
    "computedomain even slices allowed": lambda s: review({
        "apiVersion": "resource.tpu.dra/v1beta1", "kind": "ComputeDomain",
        "spec": {"numNodes": 4, "numSlices": 2}}),
}


@pytest.mark.parametrize("name", sorted(REVIEWS))
def test_admission_reviews_get_the_jax_responses(name):
    got = {side: neutral(side, WEBHOOK[side].validate_admission_review(
        REVIEWS[name](side))) for side in SIDES}
    assert got["pt"] == got["jax"]
    allowed = got["pt"]["response"]["allowed"]
    assert allowed == (not any(w in name for w in ("refused", "checked",
                                                   "nested")))
    if not allowed:
        assert got["pt"]["response"]["status"]["code"] == 422


def test_the_port_checks_both_of_its_drivers():
    assert set(pt_webhook.OUR_DRIVERS) == {"gpu.nvidia.com",
                                           "compute-domain.nvidia.com"}
    cd_claim = claim_with_config("pt", None,
                                 driver="compute-domain.nvidia.com",
                                 params={"apiVersion": pt_decode.API_VERSION,
                                         "kind": "ComputeDomainChannelConfig",
                                         "domainID": "u", "bogus": 1})
    out = pt_webhook.validate_admission_review(review(cd_claim))
    assert not out["response"]["allowed"]
    assert "unknown field" in out["response"]["status"]["message"]


def _post(url, body, context=None, timeout=10):
    req = urllib.request.Request(url, data=body, headers={
        "Content-Type": "application/json"})
    with urllib.request.urlopen(req, context=context, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def test_http_end_to_end_matches():
    got = {}
    for side in SIDES:
        server = WEBHOOK[side].WebhookServer(host="127.0.0.1", port=0)
        server.start()
        try:
            base = f"http://127.0.0.1:{server.port}"
            outs = [neutral(side, _post(
                base + WEBHOOK[side].VALIDATE_PATH,
                json.dumps(REVIEWS[name](side)).encode()))
                for name in ("unknown field refused", "valid config allowed")]
            codes = []
            for path, body in (("/nope", b"{}"),
                               (WEBHOOK[side].VALIDATE_PATH, b"not json")):
                with pytest.raises(urllib.error.HTTPError) as e:
                    _post(base + path, body)
                codes.append(e.value.code)
            got[side] = (outs, codes)
        finally:
            server.stop()
    assert got["pt"] == got["jax"]
    assert got["pt"][1] == [404, 400]


def test_https_with_the_bootstrap_cert(tmp_path):
    """The port's bootstrap cert serves its webhook over HTTPS, and a
    client that trusts that cert (as the API server does through the
    patched caBundle) and checks the SAN gets the JAX response."""
    import ssl
    cert_pem, key_pem = pt_cb.generate_self_signed("tpu-dra-webhook", "ns1")
    (tmp_path / "tls.crt").write_bytes(cert_pem)
    (tmp_path / "tls.key").write_bytes(key_pem)
    server = pt_webhook.WebhookServer(host="127.0.0.1", port=0,
                                      tls_cert=str(tmp_path / "tls.crt"),
                                      tls_key=str(tmp_path / "tls.key"))
    server.start()
    try:
        ctx = ssl.create_default_context(cadata=cert_pem.decode())
        ctx.check_hostname = False  # the SANs name the service
        url = f"https://127.0.0.1:{server.port}{pt_webhook.VALIDATE_PATH}"
        body = REVIEWS["unknown field refused"]("pt")
        status, out = _post(url, json.dumps(body).encode(), context=ctx)
        assert status == 200
        want = jax_webhook.validate_admission_review(
            REVIEWS["unknown field refused"]("jax"))
        assert neutral("pt", out) == neutral("jax", want)
        # A client that does not trust the cert is refused.
        with pytest.raises(urllib.error.URLError):
            _post(url, json.dumps(body).encode(),
                  context=ssl.create_default_context())
    finally:
        server.stop()


# -- the TLS bootstrap ----------------------------------------------------

def _webhook_config(kube):
    kube.create("admissionregistration.k8s.io", "v1",
                "validatingwebhookconfigurations", {
                    "apiVersion": "admissionregistration.k8s.io/v1",
                    "kind": "ValidatingWebhookConfiguration",
                    "metadata": {"name": "tpu-dra-webhook"},
                    "webhooks": [{"name": "validate.dra", "clientConfig": {}},
                                 {"name": "second"}]})


@pytest.mark.parametrize("mode", ["both", "create", "patch-after-create"])
def test_bootstrap_matches(mode):
    got = {}
    for side in SIDES:
        kube = KUBE[side].FakeKubeClient()
        _webhook_config(kube)
        run = CERTS[side].run
        if mode == "patch-after-create":
            run(kube, "svc", "ns1", "tls", "tpu-dra-webhook", mode="create")
            rc = run(kube, "svc", "ns1", "tls", "tpu-dra-webhook",
                     mode="patch")
        else:
            rc = run(kube, "svc", "ns1", "tls", "tpu-dra-webhook", mode=mode)
        secret = kube.get("", "v1", "secrets", "tls", namespace="ns1")
        cert = base64.b64decode(secret["data"]["tls.crt"])
        whc = kube.get("admissionregistration.k8s.io", "v1",
                       "validatingwebhookconfigurations", "tpu-dra-webhook")
        bundles = [base64.b64decode(w.get("clientConfig", {}).get(
            "caBundle", "")) == cert for w in whc["webhooks"]]
        got[side] = (rc, sorted(secret["data"]), secret["type"], bundles,
                     b"BEGIN PRIVATE KEY" in base64.b64decode(
                         secret["data"]["tls.key"]),
                     CERTS[side].cert_valid(cert, "svc", "ns1"))
    assert got["pt"] == got["jax"]
    assert got["pt"][3] == ([False, False] if mode == "create"
                            else [True, True])


def test_bootstrap_keeps_a_valid_secret_and_replaces_a_cn_only_one(tmp_path):
    kube = pt_kube.FakeKubeClient()
    _webhook_config(kube)
    pt_cb.run(kube, "svc", "ns1", "tls", "tpu-dra-webhook")
    first = kube.get("", "v1", "secrets", "tls", namespace="ns1")
    pt_cb.run(kube, "svc", "ns1", "tls", "tpu-dra-webhook")
    assert kube.get("", "v1", "secrets", "tls",
                    namespace="ns1")["data"] == first["data"]
    # A CN-only cert (API servers ignore the CN) is regenerated.
    crt, key = tmp_path / "c.pem", tmp_path / "k.pem"
    subprocess.run(["openssl", "req", "-x509", "-newkey", "rsa:2048",
                    "-keyout", str(key), "-out", str(crt), "-days", "3650",
                    "-nodes", "-subj", "/CN=svc.ns1.svc"], check=True,
                   capture_output=True)
    cn_only = crt.read_bytes()
    for side in SIDES:
        assert not CERTS[side].cert_valid(cn_only, "svc", "ns1")
        good, _ = CERTS[side].generate_self_signed("svc", "ns1")
        assert CERTS[side].cert_valid(good, "svc", "ns1")
        assert not CERTS[side].cert_valid(good, "other", "ns1")
    secret = kube.get("", "v1", "secrets", "tls", namespace="ns1")
    secret["data"]["tls.crt"] = base64.b64encode(cn_only).decode()
    kube.update("", "v1", "secrets", "tls", secret, namespace="ns1")
    pt_cb.run(kube, "svc", "ns1", "tls", "tpu-dra-webhook")
    fixed = base64.b64decode(kube.get("", "v1", "secrets", "tls",
                                      namespace="ns1")["data"]["tls.crt"])
    assert fixed != cn_only and pt_cb.cert_valid(fixed, "svc", "ns1")
    out = subprocess.run(["openssl", "x509", "-noout", "-text"], input=fixed,
                         capture_output=True, check=True).stdout.decode()
    assert "svc.ns1.svc.cluster.local" in out and "svc.ns1" in out


# -- leader election ------------------------------------------------------

def on_both(fn):
    got = {side: json.loads(json.dumps(fn(side))) for side in SIDES}
    assert got["pt"] == got["jax"]
    return got["pt"]


def test_single_leader_and_takeover_after_release():
    def run(side):
        kube = KUBE[side].FakeKubeClient()
        a = LE[side].LeaderElector(kube, "lease1", "ns", "pod-a")
        b = LE[side].LeaderElector(kube, "lease1", "ns", "pod-b")
        steps = [a.try_acquire_or_renew(), b.try_acquire_or_renew(),
                 a.try_acquire_or_renew()]
        a.release()
        steps.append(b.try_acquire_or_renew())
        lease = kube.get(*LEASE, "lease1", namespace="ns")
        return steps, lease["spec"]["holderIdentity"], sorted(lease["spec"])
    assert on_both(run) == [[True, False, True, True], "pod-b",
                            ["acquireTime", "holderIdentity",
                             "leaseDurationSeconds", "renewTime"]]


def test_takeover_after_expiry():
    def run(side):
        kube = KUBE[side].FakeKubeClient()
        a = LE[side].LeaderElector(kube, "lease1", "ns", "pod-a",
                                   lease_duration=0.05)
        b = LE[side].LeaderElector(kube, "lease1", "ns", "pod-b",
                                   lease_duration=0.05)
        # b's first look only starts its local expiry clock.
        steps = [a.try_acquire_or_renew(), b.try_acquire_or_renew()]
        time.sleep(0.1)
        steps.append(b.try_acquire_or_renew())
        return steps
    assert on_both(run) == [True, False, True]


def test_clock_skew_does_not_allow_seizure():
    def run(side):
        kube = KUBE[side].FakeKubeClient()
        a = LE[side].LeaderElector(kube, "lease1", "ns", "pod-a",
                                   lease_duration=0.08)
        b = LE[side].LeaderElector(kube, "lease1", "ns", "pod-b",
                                   lease_duration=0.08)
        steps = [a.try_acquire_or_renew(), b.try_acquire_or_renew()]
        # A leader with a skewed clock: renewTime is ancient, but the
        # record keeps changing.
        for i in range(3):
            time.sleep(0.04)
            lease = kube.get(*LEASE, "lease1", namespace="ns")
            lease["spec"]["renewTime"] = f"1999-01-01T00:00:0{i}.000000Z"
            kube.update(*LEASE, "lease1", lease, namespace="ns")
            steps.append(b.try_acquire_or_renew())
        return steps
    assert on_both(run) == [True, False, False, False, False]


def test_run_calls_lead_and_releases():
    def run(side):
        kube = KUBE[side].FakeKubeClient()
        a = LE[side].LeaderElector(kube, "lease1", "ns", "pod-a")
        stop = threading.Event()
        led = []

        def lead():
            led.append(a.is_leader)
            stop.set()
        a.run(lead, stop)
        lease = kube.get(*LEASE, "lease1", namespace="ns")
        return led, a.is_leader, lease["spec"]["holderIdentity"]
    assert on_both(run) == [[True], False, ""]


def test_lease_client_deadline_bounded_by_renew_period():
    for side, retry in (("jax", jax_retry), ("pt", pt_retry)):
        wrapped = retry.RetryingKubeClient(
            KUBE[side].FakeKubeClient(),
            policy=retry.RetryPolicy(deadline_s=30.0))
        elector = LE[side].LeaderElector(wrapped, "lease1", "ns", "pod-a",
                                         renew_period=10.0)
        assert elector.kube.policy.deadline_s == 8.0  # 0.8 * renew
        assert elector.kube.policy.attempt_timeout_s <= 8.0
        assert elector.kube.breaker is wrapped.breaker
        assert elector.try_acquire_or_renew()
        plain = KUBE[side].FakeKubeClient()
        assert LE[side].LeaderElector(plain, "l2", "ns", "x").kube is plain


class _ErrorInjectingKube:
    """The fake client, whose verbs raise while ``failing`` is set (an
    API server outage)."""

    def __init__(self, kube_mod):
        self.inner = kube_mod.FakeKubeClient()
        self.failing = False

    def __getattr__(self, name):
        fn = getattr(self.inner, name)

        def wrapped(*a, **kw):
            if self.failing and name in ("get", "list", "create",
                                         "update", "patch", "delete"):
                raise OSError("apiserver down")
            return fn(*a, **kw)
        return wrapped


def _run_leader(elector, stop, stopped):
    t = threading.Thread(target=lambda: elector.run(
        stop.wait, stop, on_stopped_leading=lambda: stopped.append(1)),
        daemon=True)
    t.start()
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and not elector.is_leader:
        time.sleep(0.005)
    assert elector.is_leader
    return t


@pytest.mark.parametrize("case", ["persistent errors step down once",
                                  "a blip keeps leadership",
                                  "a lost lease steps down at once"])
def test_step_down_policy_matches(case):
    def run(side):
        kube = _ErrorInjectingKube(KUBE[side])
        elector = LE[side].LeaderElector(
            kube, "lease1", "ns", "pod-a",
            lease_duration=0.2 if case.startswith("persistent") else 5.0,
            renew_period=0.02, retry_period=0.02)
        logging_off = __import__("logging")
        logging_off.disable(logging_off.CRITICAL)
        stop, stopped = threading.Event(), []
        try:
            t = _run_leader(elector, stop, stopped)
            if case.startswith("persistent"):
                kube.failing = True  # the outage never ends
                t.join(timeout=10)
            elif case.startswith("a blip"):
                kube.failing = True
                time.sleep(0.1)
                kube.failing = False
                time.sleep(0.1)
                during = elector.is_leader
                stop.set()
                t.join(timeout=10)
                return (during, stopped, kube.get(*LEASE, "lease1",
                        namespace="ns")["spec"]["holderIdentity"])
            else:
                lease = kube.get(*LEASE, "lease1", namespace="ns")
                lease["spec"]["holderIdentity"] = "pod-b"
                lease["spec"]["renewTime"] = "2099-01-01T00:00:00.000000Z"
                kube.update(*LEASE, "lease1", lease, namespace="ns")
                t.join(timeout=10)
        finally:
            logging_off.disable(logging_off.NOTSET)
            stop.set()
        return (t.is_alive(), stopped, elector.is_leader, stop.is_set())
    got = on_both(run)
    if case.startswith("a blip"):
        assert got == [True, [], ""]
    else:
        assert got == [False, [1], False, True]


# -- the controller binary ------------------------------------------------

def _get_json(url: str):
    with urllib.request.urlopen(url, timeout=5) as r:
        return r.read().decode()


def _wait(pred, timeout: float, what: str):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        value = pred()
        if value:
            return value
        time.sleep(0.05)
    raise AssertionError(f"timed out waiting for {what}")


def _holder(store):
    try:
        return store.get(*LEASE, "tpu-dra-cd-controller",
                         namespace="ns")["spec"]["holderIdentity"]
    except pt_kube.NotFoundError:
        return None


def _finalized(store, name):
    cd = store.get(API_GROUP, API_VERSION, "computedomains", name,
                   namespace="team-a")
    return FINALIZER in cd["metadata"].get("finalizers", [])


def _make_cd(store, name):
    return store.create(API_GROUP, API_VERSION, "computedomains", {
        "apiVersion": f"{API_GROUP}/{API_VERSION}", "kind": "ComputeDomain",
        "metadata": {"name": name, "namespace": "team-a"},
        "spec": {"numNodes": 1, "channel": {
            "resourceClaimTemplate": {"name": f"{name}-channel"}}}},
        namespace="team-a")


def test_two_controller_binaries_hand_over_the_lease(tmp_path):
    """Two ``computedomain.controller.main --leader-election`` processes
    on the default 30/10/2 s timings: one holds the Lease and reconciles
    (finalizer, DaemonSet, templates; its gauge and its cd.reconcile span
    on its listener); SIGTERM makes it exit 0 and release, and the other
    takes over within a retry period and reconciles a second domain."""
    server = pt_server.FakeApiServer().start()
    procs = {}
    ports = {ident: free_port() for ident in ("cd-a", "cd-b")}
    env = {**os.environ, "PYTHONPATH": ROOT, "TPU_DRA_DEBUG_HTTP": "1"}
    try:
        for ident, port in ports.items():
            log = open(tmp_path / f"{ident}.log", "w")
            procs[ident] = subprocess.Popen(
                [sys.executable, "-m",
                 "k8s_dra_driver_gpu_tpu_torch.computedomain.controller.main",
                 "--leader-election", "--kube-api", server.url,
                 "--metrics-port", str(port), "--identity", ident,
                 "--namespace", "ns", "-v", "4"],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
            log.close()
        store = server.store
        leader = _wait(lambda: _holder(store), 15, "a leader")
        standby = "cd-b" if leader == "cd-a" else "cd-a"
        uid = _make_cd(store, "cd1")["metadata"]["uid"]
        _wait(lambda: _finalized(store, "cd1"), 10, "cd1's finalizer")
        _wait(lambda: store.list("apps", "v1", "daemonsets", namespace="ns"),
              10, "the DaemonSet")
        base = f"http://127.0.0.1:{ports[leader]}"
        _wait(lambda: 'tpu_compute_domain_status{name="cd1"' in
              _get_json(base + "/metrics"), 10, "the status gauge")
        # A span is exported when it ends, after the gauge is set in it.
        _wait(lambda: any(
            s["name"] == "cd.reconcile" and s["attrs"]["claim_uid"] == uid
            for spans in json.loads(_get_json(base + "/debug/traces"))[
                "traces"].values() for s in spans), 10, "the reconcile span")
        assert "tpu_dra_build_info{" in _get_json(base + "/metrics")
        assert _holder(store) == leader
        procs[leader].send_signal(signal.SIGTERM)
        assert procs[leader].wait(timeout=15) == 0
        t0 = time.monotonic()
        _wait(lambda: _holder(store) == standby, 10, "the takeover")
        took = time.monotonic() - t0
        assert took < 5.0, took
        _make_cd(store, "cd2")
        _wait(lambda: _finalized(store, "cd2"), 10, "cd2's finalizer")
        procs[standby].send_signal(signal.SIGTERM)
        assert procs[standby].wait(timeout=15) == 0
        assert _holder(store) == ""
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)
        server.stop()
    assert not child_pids() & {p.pid for p in procs.values()}
