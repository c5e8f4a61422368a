"""The port's MIG devices on their own: names, counters, the spec of a
MIG device, what a MIG device refuses, and the NVML path over the fake
``libnvidia-ml.so.1`` of ``test_torch_tpulib.py`` with MIG on (create,
walk and destroy through ``DeviceState``, a refused create rolled back,
an admin's GPU instance never destroyed). The claim sequences held
against the JAX plugin's sub-slices are ``SCENARIOS["MIG …"]`` of
``test_torch_kubeletplugin_device_state.py``.
"""

import ctypes
import json
import os
import re

import pytest

from k8s_dra_driver_gpu_tpu_torch.api.decode import API_VERSION as PT_API
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import ResourceClaim
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.deviceinfo import DeviceKind
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.partitions import (
    consumed_counters, shared_counter_sets)
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.subslice import (
    SubSliceSpecTuple, parse_mig_name)
from k8s_dra_driver_gpu_tpu_torch.tpulib.binding import (MigInstance,
                                                         NvmlLib, PyGpuLib)
from tests.fake_kube import make_claim_dict
from tests.test_torch_kubeletplugin_device_state import (  # noqa: F401
    BOOT, MIG_GATES, container_gpus, driver_root, fake_driver,
    write_mig_caps)
from tests.test_torch_kubeletplugin_sharing import fake_daemon_pids

RFC1123_LABEL = re.compile(r"^[a-z0-9]([a-z0-9-]{0,61}[a-z0-9])?$")


def mig_state(root, topology="h100-4", gates=MIG_GATES, caps=True,
              **config):
    if caps:
        write_mig_caps(str(root))
    cfg = pt_ds.Config.mock(str(root), topology=topology, gates=gates,
                            mig_mode="enabled")
    cfg.boot_id = config.pop("boot_id", BOOT)
    for key, value in config.items():
        setattr(cfg, key, value)
    return pt_ds.DeviceState(cfg)


def claim(uid, names, kind=None, body=None, request="gpu"):
    configs = [] if kind is None else [{"parameters": {
        "apiVersion": PT_API, "kind": kind, **(body or {})}}]
    return ResourceClaim.from_dict(make_claim_dict(
        uid, names, driver=DRIVER_NAME, request=request, configs=configs))


def walk(state) -> list[MigInstance]:
    lib = PyGpuLib()
    lib.enumerate(state._config.gpulib_opts)
    return [i for gpu in range(len(state.host.chips))
            for i in lib.mig_instances(gpu)]


def left_nothing(state, uid) -> bool:
    return (uid not in state.prepared_claims()
            and not state._cdi.spec_exists(uid)
            and state.mig_registry() == {} and walk(state) == [])


# -- names and counters ----------------------------------------------------------


def test_every_published_name_is_an_rfc1123_label(tmp_path):
    state = mig_state(tmp_path, topology="h100-8")
    names = [d["name"] for d in state.dra_devices()]
    # 8 GPUs, each with 7 + 4 + 3 + 2 + 1 + 1 MIG devices.
    assert len(names) == 8 * (1 + 18)
    assert all(RFC1123_LABEL.match(n) for n in names), names
    profiles = state.subslice_profiles
    for name in names:
        if (parsed := parse_mig_name(name)) is None:
            continue
        spec = SubSliceSpecTuple.from_canonical_name(name, profiles)
        assert (spec.gpu, spec.profile, spec.start) == parsed
        assert spec.canonical_name() == name
    dev = state.allocatable["gpu-3-mig-3g40gb-4"].to_dra_device()
    assert dev == {"name": "gpu-3-mig-3g40gb-4", "attributes": {
        "profile": {"string": "3g.40gb"}, "parentIndex": {"int": 3},
        "placement": {"int": 4},
        "productName": {"string": "NVIDIA H100 80GB HBM3"}},
        "capacity": {"multiprocessors": {"value": "60"},
                     "memory": {"value": str(40 << 30)}}}


@pytest.mark.parametrize("name", ["gpu-0-mig-1g.10gb-0", "gpu-0-mig-1g10gb",
                                  "gpu-0", "gpu-0-mig-1g10gb-7",
                                  "gpu-0-mig-5g50gb-0"])
def test_names_that_are_no_mig_device(tmp_path, name):
    state = mig_state(tmp_path)
    assert SubSliceSpecTuple.from_canonical_name(
        name, state.subslice_profiles) is None


def _used(dev, profiles) -> dict[str, int]:
    (block,) = consumed_counters(dev, profiles)
    return {k: int(v["value"]) for k, v in block["counters"].items()}


def test_overlapping_devices_exceed_their_gpus_counters(tmp_path):
    # Every pair of devices of GPU 0: their counters together exceed the
    # GPU's set exactly when their memory slots overlap.
    state = mig_state(tmp_path)
    profiles = state.subslice_profiles
    (gpu0,) = [s for s in shared_counter_sets(state.host, profiles)
               if s["name"] == "gpu-0-counter-set"]
    have = {k: int(v["value"]) for k, v in gpu0["counters"].items()}
    assert sorted(have) == ["memory"] + [
        f"memory-slice-{k}" for k in range(8)] + ["multiprocessors"]
    assert have["multiprocessors"] == 132
    devs = [d for d in state.allocatable.values() if d.gpu.index == 0]
    assert len(devs) == 19
    # A whole GPU takes all of its counters.
    assert _used(state.allocatable["gpu-0"], profiles) == have
    for a in devs:
        for b in devs:
            if a is b:
                continue
            ua, ub = _used(a, profiles), _used(b, profiles)
            exceed = any(ua.get(k, 0) + ub.get(k, 0) > v
                         for k, v in have.items())
            overlap = bool(a.memory_slices() & b.memory_slices())
            assert exceed == overlap, (a.canonical_name, b.canonical_name)


def test_mig_off_publishes_the_counter_sets_and_no_mig_device(tmp_path):
    state = pt_ds.DeviceState(pt_ds.Config.mock(
        str(tmp_path), topology="h100-4", gates=MIG_GATES))
    assert state.subslice_profiles == ()
    assert sorted(state.allocatable) == [f"gpu-{i}" for i in range(4)]
    sets = shared_counter_sets(state.host, ())
    assert [s["name"] for s in sets] == [
        f"gpu-{i}-counter-set" for i in range(4)]
    assert "multiprocessors" not in sets[0]["counters"]
    assert _used(state.allocatable["gpu-2"], ()) == {
        k: int(v["value"]) for k, v in sets[2]["counters"].items()}
    with pytest.raises(pt_ds.PrepareError, match="unknown device"):
        state.prepare(claim("c1", ["gpu-0-mig-1g10gb-0"]))
    cfg = pt_ds.Config.mock(str(tmp_path), topology="h100-4",
                            gates=MIG_GATES)
    cfg.static_subslices = ("gpu-0-mig-1g10gb-0",)
    with pytest.raises(ValueError, match="gpu-0-mig-1g10gb-0.*MIG disabled"):
        pt_ds.DeviceState(cfg)


# -- the spec of a MIG device, and what it refuses ------------------------------


def test_a_mig_devices_spec(tmp_path):
    state = mig_state(tmp_path)
    state.prepare(claim("c1", ["gpu-2-mig-2g20gb-4"]))
    (inst,) = walk(state)
    assert (inst.gpu, inst.profile, inst.start, inst.size) == (
        2, "2g.20gb", 4, 2)
    spec = state._cdi.read_spec("c1")
    (dev,) = spec["devices"]
    with open(tmp_path / "proc" / "driver" / "nvidia-caps"
              / "mig-minors") as f:
        minors = dict(line.split() for line in f)
    caps = [str(tmp_path / "dev" / "nvidia-caps" / f"nvidia-cap{minors[k]}")
            for k in (f"gpu2/gi{inst.gi_id}/access",
                      f"gpu2/gi{inst.gi_id}/ci{inst.ci_id}/access")]
    assert [n["path"] for n in dev["containerEdits"]["deviceNodes"]] == [
        "/dev/nvidia2"] + caps
    env = spec["containerEdits"]["env"]
    assert env[-1] == "CUDA_DEVICE_ORDER=PCI_BUS_ID"
    assert not [e for e in env if e.startswith("CUDA_VISIBLE_DEVICES=")]
    assert container_gpus(state, [spec]) == [2]
    record = state.prepared_claims()["c1"]
    (cdev,) = record.devices
    assert (cdev.kind, cdev.live["uuid"]) == ("subslice-dynamic", inst.uuid)
    assert "prep_create_subslice" in state.last_segments
    state.unprepare("c1")
    assert left_nothing(state, "c1")


@pytest.mark.parametrize("missing", ["mig-minors", "cap"])
def test_missing_caps_fail_prepare_and_leave_nothing(tmp_path, missing):
    state = mig_state(tmp_path)
    if missing == "mig-minors":
        path = tmp_path / "proc" / "driver" / "nvidia-caps" / "mig-minors"
    else:
        # The first GPU instance of GPU 0 gets id 1.
        with open(tmp_path / "proc" / "driver" / "nvidia-caps"
                  / "mig-minors") as f:
            minor = dict(line.split() for line in f)["gpu0/gi1/access"]
        path = tmp_path / "dev" / "nvidia-caps" / f"nvidia-cap{minor}"
    os.unlink(path)
    with pytest.raises(pt_ds.PrepareError, match=re.escape(str(path))):
        state.prepare(claim("c1", ["gpu-0-mig-1g10gb-0"]))
    assert left_nothing(state, "c1")


TIMESLICE = {"sharing": {"strategy": "TimeSlicing",
                         "timeSlicing": {"interval": "Long"}}}
MPS = {"sharing": {"strategy": "MultiTenancy",
                   "multiTenancy": {"hbmLimit": "4Gi"}}}


SHARED_MIG_GATES = MIG_GATES + ",TimeSlicingSettings=true," \
    "MultiTenancySupport=true"


def daemon_env(pid: int) -> dict[str, str]:
    with open(f"/proc/{pid}/environ", "rb") as f:
        return dict(kv.decode().split("=", 1)
                    for kv in f.read().split(b"\0") if kv)


@pytest.mark.parametrize("kind, body, error, match", [
    ("MigDeviceConfig", TIMESLICE, pt_ds.PrepareError,
     "timeslice on a MIG device"),
    # MPS is served (no error): one daemon over the MIG device alone.
    ("MigDeviceConfig", MPS, None, None),
    ("GpuConfig", None, pt_ds.PrepareError,
     "GpuConfig cannot apply to gpu-1-mig-1g10gb-3 \\(a MIG device\\)"),
])
def test_what_a_mig_device_refuses(tmp_path, fake_driver, kind, body, error,
                                   match):
    state = mig_state(tmp_path, gates=SHARED_MIG_GATES,
                      driver_root=fake_driver)
    if error is None:
        state.prepare(claim("c1", ["gpu-1-mig-1g10gb-3"], kind, body))
        (inst,) = walk(state)
        (pid,) = fake_daemon_pids(fake_driver)
        assert daemon_env(pid)["CUDA_VISIBLE_DEVICES"] == inst.uuid
        env = state._cdi.read_spec("c1")["devices"][0]["containerEdits"][
            "env"]
        assert "CUDA_MPS_PINNED_DEVICE_MEM_LIMIT=0=4096M" in env
        state.unprepare("c1")
        assert fake_daemon_pids(fake_driver) == []
    else:
        with pytest.raises(error, match=match):
            state.prepare(claim("c1", ["gpu-1-mig-1g10gb-3"], kind, body))
    assert left_nothing(state, "c1")
    # The default MigDeviceConfig prepares; a MigDeviceConfig is no
    # whole GPU's.
    state.prepare(claim("c2", ["gpu-1-mig-1g10gb-3"], "MigDeviceConfig"))
    with pytest.raises(pt_ds.PrepareError, match="cannot apply to gpu-0"):
        state.prepare(claim("c3", ["gpu-0"], "MigDeviceConfig"))


def test_mps_on_a_mig_device_survives_a_restart(tmp_path, fake_driver):
    state = mig_state(tmp_path, gates=SHARED_MIG_GATES,
                      driver_root=fake_driver)
    state.prepare(claim("c1", ["gpu-0-mig-2g20gb-2"], "MigDeviceConfig",
                        {"sharing": {"strategy": "MultiTenancy",
                                     "multiTenancy": {"maxClients": 3}}}))
    (pid,) = fake_daemon_pids(fake_driver)
    owner = json.load(open(os.path.join(
        state._tenancy._partition_dir("gpu-0-mig-2g20gb-2"), "claim.json")))
    # No hbmLimit: the instance's memory, in MiB; the claim's maxClients.
    size = state.allocatable["gpu-0-mig-2g20gb-2"].subslice.profile.hbm_bytes
    assert (owner["maxClients"], owner["pinnedMemLimits"]) == (
        3, {"0": f"{size >> 20}M"})
    # A restart re-owns the live daemon; a lost spec is not prepared
    # again under its clients.
    again = mig_state(tmp_path, gates=SHARED_MIG_GATES, caps=False,
                      driver_root=fake_driver)
    assert fake_daemon_pids(fake_driver) == [pid]
    again._cdi.delete_claim_spec_file("c1")
    with pytest.raises(pt_ds.PrepareError, match="MPS daemon"):
        again.prepare(claim("c1", ["gpu-0-mig-2g20gb-2"], "MigDeviceConfig",
                            {"sharing": {"strategy": "MultiTenancy"}}))
    again.unprepare("c1")
    assert fake_daemon_pids(fake_driver) == []
    assert left_nothing(again, "c1")
    # One daemon serves one MIG instance: an MPS request holds one device.
    with pytest.raises(pt_ds.PrepareError, match="only device"):
        again.prepare(claim("c2", ["gpu-0-mig-1g10gb-0", "gpu-1-mig-1g10gb-0"],
                            "MigDeviceConfig", MPS))
    assert left_nothing(again, "c2")


def test_a_boot_id_change_drops_the_registry_without_destroying(tmp_path):
    state = mig_state(tmp_path)
    state.prepare(claim("c1", ["gpu-0-mig-1g10gb-0"]))
    (inst,) = walk(state)
    again = mig_state(tmp_path, boot_id="boot-1",
                      static_subslices=("gpu-0-mig-1g10gb-0",))
    assert again.prepared_claims() == {} and again.mig_registry() == {}
    # Not destroyed: what the walk finds now is no instance of this
    # plugin's, and a static device may name it.
    assert walk(again) == [inst]
    assert again.allocatable["gpu-0-mig-1g10gb-0"].kind == \
        DeviceKind.SUBSLICE_STATIC
    assert again.destroy_unknown_subslices() == 0 and walk(again) == [inst]


def test_a_registry_entry_whose_instance_is_gone_is_dropped(tmp_path):
    state = mig_state(tmp_path)
    state.prepare(claim("c1", ["gpu-1-mig-4g40gb-0"]))
    (inst,) = walk(state)
    lib = PyGpuLib()
    lib.enumerate(state._config.gpulib_opts)
    lib.destroy_mig(inst)
    assert state.destroy_unknown_subslices() == 1
    assert state.mig_registry() == {}
    state.unprepare("c1")  # the instance is gone: nothing to destroy
    assert left_nothing(state, "c1")


# -- the NVML path, over a fake libnvidia-ml.so.1 with MIG on -------------------


@pytest.fixture(scope="module")
def fake_nvml(tmp_path_factory):
    from tests.test_torch_kubeletplugin_health import build_fake_nvml

    return build_fake_nvml(tmp_path_factory.mktemp("fake_nvml_mig"))


@pytest.fixture()
def nvml_host(tmp_path, monkeypatch, fake_nvml):
    """A DeviceState factory over the fake NVML with MIG on, the
    driver's MIG caps under the test's proc and dev roots."""
    for var in ("FAKE_NVML_GI_REFUSE", "FAKE_NVML_CI_REFUSE",
                "FAKE_NVML_LOST", "FAKE_NVML_NO_PCI", "FAKE_NVML_INIT_RC"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setenv("FAKE_NVML_MIG", "1")
    ctypes.CDLL(fake_nvml).fake_reset()
    write_mig_caps(str(tmp_path))
    libs = []

    def lib(backend=None):
        libs.append(NvmlLib(fake_nvml))
        return libs[-1]

    monkeypatch.setattr(pt_ds, "load", lib)
    root = driver_root(tmp_path)

    def make(**config):
        from k8s_dra_driver_gpu_tpu_torch.pkg.featuregates import \
            FeatureGates
        from k8s_dra_driver_gpu_tpu_torch.tpulib.binding import \
            EnumerateOptions

        cfg = pt_ds.Config(
            root=str(tmp_path / "state"), boot_id=BOOT, driver_root=root,
            gpulib_opts=EnumerateOptions(dev_root=str(tmp_path / "dev"),
                                         proc_root=str(tmp_path / "proc")),
            feature_gates=FeatureGates.parse(MIG_GATES), **config)
        return pt_ds.DeviceState(cfg)

    yield make, lib
    for opened in libs:
        opened.close()


def test_nvml_mig_create_walk_destroy(nvml_host):
    make, lib = nvml_host
    state = make()
    assert state.host.mig_mode == "enabled"
    names = [d["name"] for d in state.dra_devices()]
    assert "gpu-3-mig-7g80gb-0" in names and len(names) == 4 * 19
    ids = state.prepare(claim("c1", ["gpu-1-mig-1g10gb-2",
                                     "gpu-1-mig-3g40gb-4"]))
    assert ids == ["nvidia.com/gpu=gpu-1-mig-1g10gb-2",
                   "nvidia.com/gpu=gpu-1-mig-3g40gb-4"]
    nvml = lib()
    found = nvml.mig_instances(1)
    assert [(i.profile, i.start, i.ci_id) for i in found] == [
        ("1g.10gb", 2, 0), ("3g.40gb", 4, 0)]
    assert sorted(state.mig_registry()) == sorted(i.uuid for i in found)
    # The fake GPU 1's minor is 0: its caps are gpu0's.
    spec = state._cdi.read_spec("c1")
    assert spec["devices"][0]["containerEdits"]["deviceNodes"][0] == {
        "path": "/dev/nvidia0"}
    state.unprepare("c1")
    assert nvml.mig_instances(1) == () and state.mig_registry() == {}


@pytest.mark.parametrize("knob, call", [
    ("FAKE_NVML_GI_REFUSE", "nvmlDeviceCreateGpuInstanceWithPlacement"),
    ("FAKE_NVML_CI_REFUSE", "nvmlGpuInstanceCreateComputeInstance")])
def test_nvml_refused_create_rolls_the_claim_back(nvml_host, monkeypatch,
                                                  knob, call):
    make, lib = nvml_host
    state = make()
    # The second device's create is refused: the first is destroyed.
    real = state._lib.create_mig

    def second_refused(gpu, profile, start):
        if gpu == 2:
            monkeypatch.setenv(knob, "4")
        return real(gpu, profile, start)

    monkeypatch.setattr(state._lib, "create_mig", second_refused)
    with pytest.raises(pt_ds.PrepareError,
                       match=f"gpu-2-mig-1g20gb-6: {call} failed: "
                             r"NVML_ERROR_NO_PERMISSION \(4\)"):
        state.prepare(claim("c1", ["gpu-0-mig-1g10gb-0",
                                   "gpu-2-mig-1g20gb-6"]))
    nvml = lib()
    assert [nvml.mig_instances(g) for g in range(4)] == [()] * 4
    assert state.prepared_claims() == {} and state.mig_registry() == {}
    assert not state._cdi.spec_exists("c1")


def test_nvml_sweep_never_destroys_an_admins_instance(nvml_host):
    make, lib = nvml_host
    admin = lib().create_mig(3, "2g.20gb", 0)
    state = make(static_subslices=("gpu-3-mig-2g20gb-0",))
    static = state.allocatable["gpu-3-mig-2g20gb-0"]
    assert static.kind == DeviceKind.SUBSLICE_STATIC
    assert static.to_dra_device()["attributes"]["uuid"] == {
        "string": admin.uuid}
    # An orphan of this plugin's, and a prepared static device.
    state._create_mig(state.allocatable["gpu-0-mig-1g10gb-5"].subslice.spec)
    state.prepare(claim("c1", ["gpu-3-mig-2g20gb-0"]))
    assert state.prepared_claims()["c1"].devices[0].live is None
    assert state.destroy_unknown_subslices() == 1
    again = make(static_subslices=("gpu-3-mig-2g20gb-0",))
    assert again.destroy_unknown_subslices() == 0
    again.unprepare("c1")
    nvml = lib()
    assert nvml.mig_instances(0) == () and nvml.mig_instances(3) == (admin,)
    # A static name that NVML's walk does not find fails startup.
    with pytest.raises(ValueError, match="gpu-3-mig-2g20gb-2"):
        make(static_subslices=("gpu-3-mig-2g20gb-2",))


def test_a_gpus_taints_reach_its_mig_devices(tmp_path):
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import driver as pt_driver
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.health import DeviceTaint
    from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import FakeKubeClient

    write_mig_caps(str(tmp_path))
    cfg = pt_ds.Config.mock(str(tmp_path), topology="h100-2",
                            gates=MIG_GATES, mig_mode="enabled")
    d = pt_driver.Driver(cfg, FakeKubeClient(), "node-a",
                         enable_health_monitor=False,
                         publication_mode="split")
    try:
        lost = DeviceTaint("gpu-1", "tpu.dra.dev/chip_lost", "true",
                           "NoExecute")
        d._on_health_taints([lost])
        slices = d.kube.list("resource.k8s.io", "v1", "resourceslices")
        tainted = {dev["name"] for s in slices for dev in s["spec"]["devices"]
                   if dev.get("taints") == [lost.to_dict()]}
        assert tainted == {"gpu-1"} | {
            name for name in d.state.allocatable
            if name.startswith("gpu-1-mig-")}
        assert len(tainted) == 19
    finally:
        d.stop()
