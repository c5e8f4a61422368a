"""The port's reconcile sweep and stale-claim lookup against the JAX
package's: the same claims, checkpoints, spec files and API objects give
the same sweep counts and leave the same state, in both wirings of
``test_torch_kubeletplugin_driver.py`` (in memory, and each package's
client over the other's server). The JAX sweep reports its partition
pass only with a partition engine (none at ``gates=""``); the port's
always reports it, as 0 without one. With the engine on both sides the
pass reaps and prunes the same partitions.
"""

import json
import os
import subprocess
import sys
import threading

import pytest

from k8s_dra_driver_gpu_tpu.kubeletplugin import cdi as jax_cdi
from k8s_dra_driver_gpu_tpu.kubeletplugin import cleanup as jax_cleanup
from k8s_dra_driver_gpu_tpu.pkg import kubeclient as jax_kube
from k8s_dra_driver_gpu_tpu.pkg import recovery as jax_recovery
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import cdi as pt_cdi
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import cleanup as pt_cleanup
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import \
    device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import driver as pt_driver
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import \
    reconcile as pt_reconcile
from k8s_dra_driver_gpu_tpu_torch.pkg import fakeapiserver as pt_server
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.pkg import recovery as pt_recovery
from tests.fake_kube import make_claim_dict
from tests.test_torch_kubeletplugin_driver import (  # noqa: F401 - fixtures
    RC, ref, same, servers, sides)


def sweep(d) -> dict:
    counts = dict(d.reconciler.reconcile_once())
    counts.setdefault("idle_partition", 0)
    return counts


def prepared(side, uid, indices, **kw):
    d = side.driver(**{k: kw.pop(k) for k in ("gpus", "node")
                       if k in kw})
    side.put_claim(uid, indices, **kw)
    out = d.prepare_resource_claims([ref(uid, kw.get("namespace",
                                                     "default"))])
    assert out[uid][1] == "", out
    return d


def layers(side, d, uid):
    return (sorted(d.state.prepared_claims()),
            d.state._cdi.spec_exists(uid))


def test_nothing_to_repair(sides):
    def run(side):
        d = prepared(side, "u1", [0, 1])
        return sweep(d), layers(side, d, "u1")
    got = same(sides, run)
    assert "'stale_claim': 0" in got and "True" in got


def test_stale_claim(sides):
    def run(side):
        d = prepared(side, "u1", [0])
        side.kube.delete(*RC, "u1", namespace="default")
        return sweep(d), layers(side, d, "u1"), sweep(d)
    assert "'stale_claim': 1" in same(sides, run)


def test_recreated_claim_is_stale(sides):
    def run(side):
        d = prepared(side, "u1", [0])
        side.kube.delete(*RC, "u1", namespace="default")
        side.put_claim("u1-again", [0], name="u1")
        return sweep(d), layers(side, d, "u1")
    assert "'stale_claim': 1" in same(sides, run)


def test_deallocated_claim_is_moved(sides):
    def run(side):
        d = prepared(side, "u1", [2])
        side.kube.patch(*RC, "u1", {"status": {"allocation": None}},
                        namespace="default")
        return sweep(d), layers(side, d, "u1")
    assert "'moved_claim': 1" in same(sides, run)


@pytest.mark.parametrize("pinned,moved", [(["node-z"], 1), (["node-a"], 0),
                                          (None, 0),
                                          (["node-a", "node-z"], 0)])
def test_claim_pinned_elsewhere_is_moved(sides, pinned, moved):
    def run(side):
        d = prepared(side, "u1", [1])
        if pinned is not None:
            side.kube.patch(*RC, "u1", {"status": {"allocation": {
                "nodeSelector": {"nodeSelectorTerms": [{"matchFields": [
                    {"key": "metadata.name", "operator": "In",
                     "values": pinned}]}]}}}}, namespace="default")
        return sweep(d), layers(side, d, "u1")
    assert f"'moved_claim': {moved}" in same(sides, run)


def _mig_driver(side):
    """A driver over sub-devices: the JAX plugin's sub-slices on a v5p-8,
    the port's MIG devices on an h100-4 with MIG on."""
    from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
    from tests.test_torch_kubeletplugin_device_state import write_mig_caps

    root = f"{side.root}/mig"
    if side.name == "jax":
        cfg = jax_ds.Config.mock(root=root, topology="v5p-8",
                                 gates="DynamicSubSlice=true")
    else:
        write_mig_caps(root)
        cfg = pt_ds.Config.mock(root, topology="h100-4",
                                gates="DynamicSubSlice=true",
                                mig_mode="enabled")
    return side.driver(config=cfg)


def test_carveout_pass_destroys_what_no_claim_references(sides):
    """A claim's sub-device is destroyed with the rest of its teardown
    when the claim goes; an instance no claim references (a crash after
    its create) is destroyed by the carve-out pass."""
    def run(side):
        jax = side.name == "jax"
        d = _mig_driver(side)
        device = "chip-0-ss-1c-0" if jax else "gpu-0-mig-1g10gb-0"
        obj = make_claim_dict("u1", [device], request="req",
                              driver=side.driver_name)
        side.kube.create(*RC, obj, namespace="default")
        out = d.prepare_resource_claims([ref("u1")])
        assert out["u1"][1] == "", out
        state = d.state
        if jax:
            from k8s_dra_driver_gpu_tpu.kubeletplugin import subslice
            state._registry.create(subslice.SubSliceLiveTuple(
                spec=subslice.SubSliceSpecTuple.from_canonical_name(
                    "chip-1-ss-1c-1"), uuid="tpu-ss-orphan"))

            def live():
                return len(state._registry.list())
        else:
            state._create_mig(state.allocatable[
                "gpu-1-mig-1g10gb-1"].subslice.spec)

            def live():
                return len(state.mig_registry())
        counts = [live()]
        counts.append(sweep(d))
        counts.append(live())
        side.kube.delete(*RC, "u1", namespace="default")
        counts.append(sweep(d))
        counts.append(live())
        return counts
    got = same(sides, run)
    assert "2, {'stale_claim': 0" in got and "'carveout': 1" in got
    assert "'stale_claim': 1" in got and got.endswith(", 0]")


def test_orphan_cdi_spec(sides):
    def run(side):
        d = prepared(side, "u1", [0])
        mod = pt_cdi if side.name == "pt" else jax_cdi
        d.state._cdi.create_claim_spec_file(
            "orphan", {side.dev(3): mod.ContainerEdits(env=["A=1"])})
        listed = sorted(d.state._cdi.list_claim_uids())
        return listed, sweep(d), sorted(d.state._cdi.list_claim_uids())
    assert "'cdi_spec': 1" in same(sides, run)


def test_devices_gone_declares_permanent_failure(sides):
    """A restart on a host with two GPUs, with a claim on the fourth."""
    def run(side):
        prepared(side, "u1", [3])
        d = side.driver(gpus=2)
        first = sweep(d)
        claim = side.kube.get(*RC, "u1", namespace="default")
        conditions = [(c["type"], c["status"], c["reason"])
                      for c in claim["status"]["conditions"]]
        return first, conditions, sweep(d), sorted(
            d.state.prepared_claims())
    got = same(sides, run)
    assert "'devices_gone': 1" in got and "'DevicesGone'" in got
    assert "'devices_gone': 0" in got  # declared once


def test_unreachable_api_server_keeps_everything(sides):
    def run(side):
        d = prepared(side, "u1", [0])
        side.kube.delete(*RC, "u1", namespace="default")
        server = pt_server.FakeApiServer()
        url = server.url
        server.stop()
        mod = pt_kube if side.name == "pt" else jax_kube
        d.reconciler._kube = mod.KubeClient(host=url)
        if side.name == "jax":  # the port's sweep has no GC object
            d.cleanup._kube = d.reconciler._kube
        return sweep(d), layers(side, d, "u1")
    assert "'stale_claim': 0" in same(sides, run)


@pytest.mark.parametrize("case", ["live", "gone", "reborn", "no-identity",
                                  "down"])
def test_lookup_claim_equals_the_references(sides, case):
    def run(side):
        side.put_claim("u1", [0], namespace="ns")
        kube, ns, name = side.kube, "ns", "u1"
        if case == "gone":
            kube.delete(*RC, "u1", namespace="ns")
        elif case == "reborn":
            kube.delete(*RC, "u1", namespace="ns")
            side.put_claim("u2", [0], namespace="ns", name="u1")
        elif case == "no-identity":
            ns = ""
        elif case == "down":
            server = pt_server.FakeApiServer()
            url = server.url
            server.stop()
            mod = pt_kube if side.name == "pt" else jax_kube
            kube = mod.KubeClient(host=url)
        mod = pt_cleanup if side.name == "pt" else jax_cleanup
        status, obj = mod.lookup_claim(kube, "u1", ns, name)
        return status, obj is not None
    same(sides, run)


CLAIMS = [
    {},
    {"status": {"conditions": [{"type": "PermanentFailure",
                                "status": "True", "reason": "DevicesGone"}]}},
    {"status": {"conditions": [{"type": "PermanentFailure",
                                "status": "False", "reason": "DevicesGone"},
                               {"type": "Other", "status": "True"}]}},
    {"status": {"allocation": {"nodeSelector": {"nodeSelectorTerms": [
        {"matchFields": [{"key": "metadata.name", "values": ["a", "b"]}]},
        {"matchFields": [{"key": "other", "values": ["c"]},
                         {"key": "metadata.name", "values": ["d"]}]}]}}}},
]


@pytest.mark.parametrize("claim", CLAIMS)
def test_recovery_helpers_equal_the_references(claim):
    written = {}
    for name, mod, kube_mod in (("pt", pt_recovery, pt_kube),
                                ("jax", jax_recovery, jax_kube)):
        kube = kube_mod.FakeKubeClient()
        obj = dict(make_claim_dict("u1", ["gpu-0"]), **claim)
        obj = kube.create(*RC, obj, namespace="default")
        wrote = mod.set_permanent_failure_condition(
            kube, obj, "True", "DevicesGone", "gone")
        written[name] = (mod.allocation_nodes(obj), wrote,
                         kube.get(*RC, "u1", namespace="default"))
    assert written["pt"] == written["jax"]
    assert pt_recovery.PERMANENT_FAILURE_CONDITION == \
        jax_recovery.PERMANENT_FAILURE_CONDITION


def test_sweep_thread_reaps_and_stops(tmp_path):
    before = set(threading.enumerate())
    kube = pt_kube.FakeKubeClient()
    d = pt_driver.Driver(pt_ds.Config.mock(str(tmp_path), topology="h100-2"),
                         kube, node_name="node-a",
                         enable_health_monitor=False)
    kube.create(*RC, make_claim_dict("u1", ["gpu-1"], driver="gpu.nvidia.com"),
                namespace="default")
    assert d.prepare_resource_claims([ref("u1")])["u1"][1] == ""
    kube.delete(*RC, "u1", namespace="default")
    d.reconciler = pt_reconcile.NodeStateReconciler(
        d.state, kube, "node-a", interval=0.01)
    d.start()
    for _ in range(500):
        if not d.state.prepared_claims():
            break
        threading.Event().wait(0.01)
    d.stop()
    assert d.state.prepared_claims() == {}
    assert d.reconciler.last_sweep["stale_claim"] in (0, 1)
    assert set(threading.enumerate()) == before


PARTITION_GATES = ("DynamicSubSlice=true,TimeSlicingSettings=true,"
                   "MultiTenancySupport=true,TenantPartitioning=true")


def _partition_driver(side, driver_root, name="serv"):
    """A driver with the partition engine: the JAX plugin's partitions
    over one-chip carve-outs of a v5e-4, the port's over the one-GPU
    7g.80gb MIG profile of an h100-4 with MIG on."""
    from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
    from k8s_dra_driver_gpu_tpu.pkg import partition as jax_partition
    from k8s_dra_driver_gpu_tpu_torch.pkg import partition as pt_partition
    from tests.test_torch_kubeletplugin_device_state import write_mig_caps

    root = f"{side.root}/partitions"
    if side.name == "jax":
        ps = jax_partition.PartitionSet(profiles=(
            jax_partition.PartitionProfile(name, "1x1", max_tenants=2),))
        cfg = jax_ds.Config.mock(root=root, topology="v5e-4",
                                 gates=PARTITION_GATES, partition_set=ps)
    else:
        write_mig_caps(root, gpus=4)
        ps = pt_partition.PartitionSet(profiles=(
            pt_partition.PartitionProfile(name, "7g.80gb", max_tenants=2),))
        cfg = pt_ds.Config.mock(root, "h100-4", PARTITION_GATES,
                                mig_mode="enabled", partition_set=ps)
        cfg.driver_root = driver_root
    return side.driver(config=cfg), type(ps), type(ps.profiles[0])


def test_idle_partition_pass_reaps_and_prunes(sides, tmp_path):
    """A tenant holds a partition a re-plan retires; its claim goes: the
    stale-claim pass unprepares it (the last tenant: the instance goes),
    and the partition pass drops the retired device. A warm instance
    the hint no longer wants is reaped by the same pass."""
    from tests.test_torch_kubeletplugin_sharing import (kill_fake_daemons,
                                                        write_fake_binaries)
    driver_root = write_fake_binaries(tmp_path / "driver")

    def run(side):
        d, pset, prof = _partition_driver(side, driver_root)
        config = {"apiVersion": "resource.tpu.dra/v1beta1",
                  "kind": "SubSliceConfig", "oversubscribe": True} \
            if side.name == "jax" else {
                "apiVersion": "resource.nvidia.com/v1beta1",
                "kind": "MigDeviceConfig", "oversubscribe": True}
        obj = make_claim_dict("u1", ["pt-serv-0"], request="req",
                              driver=side.driver_name,
                              configs=[{"parameters": config}])
        side.kube.create(*RC, obj, namespace="default")
        out = d.prepare_resource_claims([ref("u1")])
        assert out["u1"][1] == "", out
        engine = d.state.partition_engine
        counts = [sweep(d)]
        d.apply_partition_set(pset(profiles=(prof(
            "dense", "1x1" if side.name == "jax" else "7g.80gb",
            max_tenants=4),)))
        side.kube.delete(*RC, "u1", namespace="default")
        counts.append(sweep(d))
        counts.append(sorted(n for n in d.state.allocatable
                             if n.startswith("pt-")))
        counts.append(engine.set_prewarm({"dense": 1}))
        engine.set_prewarm({})
        counts.append(sweep(d))
        counts.append(engine.active_partitions())
        return counts
    try:
        got = same(sides, run)
    finally:
        assert kill_fake_daemons(driver_root) == []
    assert "'idle_partition': 0" in got
    assert "'stale_claim': 1" in got and "'idle_partition': 1" in got
    assert "pt-serv-0" not in got and got.endswith(", 0]")


# The sweep's interval, read at import: (TPU_DRA_RECOVERY_SWEEP_S,
# TPU_DRA_CLEANUP_INTERVAL_S) -> SWEEP_INTERVAL_S. None leaves a knob
# unset; the cleanup floor (0.5 s) takes the place of a value that is not
# positive, and a value that is not a number gives the default.
SWEEP_ROWS = [
    ((None, None), 120.0),
    ((None, "1"), 1.0),
    (("0.2", "1"), 0.2),
    ((None, "0.1"), 0.1),
    ((None, "0"), 0.5),
    ((None, "soon"), 120.0),
]

_SWEEP_TABLE = """
import importlib, json, os, sys
rows = json.loads(sys.argv[2])
out = []
for sweep, cleanup in rows:
    for var, val in (("TPU_DRA_RECOVERY_SWEEP_S", sweep),
                     ("TPU_DRA_CLEANUP_INTERVAL_S", cleanup)):
        os.environ.pop(var, None)
        if val is not None:
            os.environ[var] = val
    for mod in ("cleanup", "reconcile"):
        sys.modules.pop(sys.argv[1] + ".kubeletplugin." + mod, None)
    out.append(importlib.import_module(
        sys.argv[1] + ".kubeletplugin.reconcile").SWEEP_INTERVAL_S)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def sweep_tables():
    """One subprocess a package imports its reconcile module under each
    row's env and prints the intervals."""
    rows = json.dumps([list(r) for r, _ in SWEEP_ROWS])
    env = {k: v for k, v in os.environ.items()
           if k not in ("TPU_DRA_RECOVERY_SWEEP_S",
                        "TPU_DRA_CLEANUP_INTERVAL_S")}
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return {pkg: json.loads(subprocess.run(
        [sys.executable, "-c", _SWEEP_TABLE, pkg, rows], env=env,
        cwd=root, check=True, capture_output=True, text=True,
        timeout=120).stdout.splitlines()[-1])
        for pkg in ("k8s_dra_driver_gpu_tpu",
                    "k8s_dra_driver_gpu_tpu_torch")}


@pytest.mark.parametrize("i", range(len(SWEEP_ROWS)),
                         ids=[f"sweep={s}-cleanup={c}"
                              for (s, c), _ in SWEEP_ROWS])
def test_sweep_interval_follows_the_cleanup_interval(sweep_tables, i):
    want = SWEEP_ROWS[i][1]
    assert sweep_tables["k8s_dra_driver_gpu_tpu_torch"][i] == want
    assert sweep_tables["k8s_dra_driver_gpu_tpu"][i] == want


def test_reconciler_takes_its_interval():
    st = object()
    assert pt_reconcile.NodeStateReconciler(
        st, None, "n")._interval == pt_reconcile.SWEEP_INTERVAL_S
    assert pt_reconcile.NodeStateReconciler(
        st, None, "n", interval=0.25)._interval == 0.25
