"""The port's live tenant-demand feed (the device library's
``tenant_usage`` -> ``ChipHealthMonitor.sample_telemetry`` -> the kubelet
``Driver``'s ``TenantProfileStore``) against the JAX package's: the
seven cases of ``tests/test_tenant_telemetry.py``, each run once a side
from the same samples, their results compared. The JAX side's mock env
is ``TPULIB_MOCK_TENANT_USAGE``, the port's ``GPULIB_MOCK_TENANT_USAGE``
(the same grammar); the port's second backend is ``NvmlLib`` over the
fake ``libnvidia-ml.so.1`` (NVML has no notion of a tenant, so it reads
the same env source), where the JAX one is its native library.
"""

import ctypes
import time

import pytest

from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
from k8s_dra_driver_gpu_tpu.kubeletplugin import driver as jax_driver
from k8s_dra_driver_gpu_tpu.kubeletplugin import health as jax_health
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg.partition import profiles as jax_profiles
from k8s_dra_driver_gpu_tpu.tpulib import binding as jax_binding
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import driver as pt_driver
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import health as pt_health
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg.partition import profiles as pt_profiles
from k8s_dra_driver_gpu_tpu_torch.tpulib import binding as pt_binding
from tests.test_torch_kubeletplugin_health import build_fake_nvml

SIDES = ("jax", "pt")
M = {"jax": dict(health=jax_health, profiles=jax_profiles,
                 binding=jax_binding, opts=dict(mock_topology="v5e-4")),
     "pt": dict(health=pt_health, profiles=pt_profiles, binding=pt_binding,
                opts=dict(mock_topology="h100-4"))}


class _FakeLib:
    """A device library with a scripted usage feed."""

    def __init__(self, binding, feed):
        self.feed = [[binding.TenantUsage(*u) for u in poll]
                     for poll in feed]

    def health(self, opts):
        return ()

    def tenant_usage(self, opts):
        return tuple(self.feed.pop(0)) if self.feed else ()


class _LegacyLib:
    """A device library without the usage seam."""

    def health(self, opts):
        return ()


def _monitor(side, lib, on_usage):
    m = M[side]
    return m["health"].ChipHealthMonitor(
        lib, m["binding"].EnumerateOptions(**m["opts"]), lambda t: None,
        on_tenant_usage=on_usage)


def both(fn):
    got = {side: fn(side) for side in SIDES}
    assert got["pt"] == got["jax"]
    return got["pt"]


def _usage(samples):
    return [(u.tenant, u.hbm_bytes, u.cores) for u in samples]


# -- TestMonitorSampling ------------------------------------------------------

def test_samples_flow_to_consumer():
    feed = [[("svc-a", 2 << 30, 1)],
            [("svc-a", 3 << 30, 2), ("svc-b", 1 << 30, 1)]]

    def one(side):
        got = []
        mon = _monitor(side, _FakeLib(M[side]["binding"], feed), got.extend)
        counts = [len(mon.sample_telemetry()), len(mon.sample_telemetry())]
        return counts, _usage(got)
    assert both(one)[0] == [1, 2]


def test_legacy_library_degrades_to_no_samples():
    def one(side):
        got = []
        return _monitor(side, _LegacyLib(), got.append).sample_telemetry(), \
            got
    assert both(one) == ((), [])


def test_no_consumer_is_noop():
    def one(side):
        lib = _FakeLib(M[side]["binding"], [[("svc-a", 1, 1)]])
        return _monitor(side, lib, None).sample_telemetry(), len(lib.feed)
    # The feed is not consumed: telemetry is pulled on demand.
    assert both(one) == ((), 1)


def test_a_failing_seam_never_breaks_the_poll():
    """The poll thread survives a usage seam that raises: taints still
    reach the consumer (the JAX monitor's ``_run``, one iteration)."""
    class Broken(_LegacyLib):
        def tenant_usage(self, opts):
            raise RuntimeError("usage seam down")

    def one(side):
        delivered = []
        mon = M[side]["health"].ChipHealthMonitor(
            Broken(), M[side]["binding"].EnumerateOptions(**M[side]["opts"]),
            delivered.append, poll_interval=0.05,
            on_tenant_usage=lambda u: None)
        mon.start()
        try:
            deadline = time.monotonic() + 5
            while not delivered and time.monotonic() < deadline:
                time.sleep(0.01)
        finally:
            mon._stop.set()
            mon._thread.join(timeout=5)
        return delivered[:1], mon.consecutive_failures
    assert both(one) == ([[]], 0)


# -- TestStoreFeed ------------------------------------------------------------

def test_record_moves_percentiles():
    def one(side):
        store = M[side]["profiles"].TenantProfileStore(defaults={})
        store.record("svc-a", 2 << 30, cores=1)
        before = store.demand("svc-a").hbm_bytes
        lib = _FakeLib(M[side]["binding"], [[("svc-a", 6 << 30, 2)]] * 20)
        mon = _monitor(side, lib, lambda usage: [
            store.record(u.tenant, u.hbm_bytes, cores=u.cores)
            for u in usage])
        for _ in range(20):
            mon.sample_telemetry()
        d = store.demand("svc-a", percentile=0.95)
        return before, d.hbm_bytes, d.cores
    assert both(one) == (2 << 30, 6 << 30, 2)


def test_driver_wires_health_poll_to_store(tmp_path, monkeypatch):
    """Through each package's real Driver: the mock env feed lands in
    ``Driver.tenant_profiles`` through the monitor's sampling."""
    spec = ("tenant=svc-live,hbm=4294967296,cores=2|"
            "tenant=svc-small,hbm=1073741824")
    monkeypatch.setenv(jax_binding.ENV_MOCK_TENANT_USAGE, spec)
    monkeypatch.setenv(pt_binding.ENV_MOCK_TENANT_USAGE, spec)

    def one(side):
        if side == "jax":
            driver = jax_driver.Driver(
                jax_ds.Config.mock(root=str(tmp_path / "jax")),
                jax_kube.FakeKubeClient(), node_name="n0",
                enable_health_monitor=True)
        else:
            driver = pt_driver.Driver(
                pt_ds.Config.mock(str(tmp_path / "pt"), "h100-4"),
                pt_kube.FakeKubeClient(), "n0", enable_health_monitor=True)
        try:
            usage = driver.health_monitor.sample_telemetry()
            live = driver.tenant_profiles.demand("svc-live")
            return (sorted(u.tenant for u in usage), live.hbm_bytes,
                    live.cores,
                    driver.tenant_profiles.demand("svc-small").hbm_bytes)
        finally:
            driver.stop()
    assert both(one) == (["svc-live", "svc-small"], 4 << 30, 2, 1 << 30)


# -- TestMockSeamParity -------------------------------------------------------

def test_env_spec_and_control_file(tmp_path, monkeypatch):
    def one(side):
        b = M[side]["binding"]
        lib = b.load(prefer_native=False) if side == "jax" \
            else b.load("python")
        reads = []
        monkeypatch.setenv(b.ENV_MOCK_TENANT_USAGE,
                           "tenant=a,hbm=100,cores=3|tenant=b,hbm=7")
        reads.append(_usage(lib.tenant_usage(b.EnumerateOptions())))
        ctl = tmp_path / f"usage-{side}.ctl"
        ctl.write_text("tenant=c,hbm=9\n")
        monkeypatch.setenv(b.ENV_MOCK_TENANT_USAGE, f"@{ctl}")
        reads.append(_usage(lib.tenant_usage(b.EnumerateOptions())))
        ctl.write_text("")  # re-read each poll: an empty file, no feed
        reads.append(_usage(lib.tenant_usage(b.EnumerateOptions())))
        monkeypatch.delenv(b.ENV_MOCK_TENANT_USAGE)
        reads.append(_usage(lib.tenant_usage(b.EnumerateOptions())))
        return reads
    assert both(one) == [[("a", 100, 3), ("b", 7, 1)], [("c", 9, 1)], [],
                         []]


@pytest.fixture(scope="module")
def fake_nvml(tmp_path_factory):
    return build_fake_nvml(tmp_path_factory.mktemp("fake_nvml"))


def test_the_second_backend_shares_the_env_source(fake_nvml, monkeypatch):
    """The JAX native library and the port's NvmlLib (over the fake NVML)
    read the env grammar as the Python backends do."""
    for var in ("FAKE_NVML_LOST", "FAKE_NVML_NO_PCI", "FAKE_NVML_INIT_RC"):
        monkeypatch.delenv(var, raising=False)
    ctypes.CDLL(fake_nvml).fake_reset()
    monkeypatch.setenv(jax_binding.ENV_MOCK_TENANT_USAGE, "tenant=x,hbm=5")
    monkeypatch.setenv(pt_binding.ENV_MOCK_TENANT_USAGE, "tenant=x,hbm=5")
    lib = pt_binding.NvmlLib(fake_nvml)
    try:
        got = _usage(lib.tenant_usage(pt_binding.EnumerateOptions()))
    finally:
        lib.close()
    assert got == [("x", 5, 1)]
    try:
        native = jax_binding.load(prefer_native=True,
                                  build_if_missing=False)
    except Exception:  # noqa: BLE001 - the JAX native library is optional
        native = None
    if native is not None and native.name == "native":
        assert _usage(native.tenant_usage(
            jax_binding.EnumerateOptions())) == got
