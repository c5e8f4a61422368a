"""The port's whole-GPU ``DeviceState`` against the JAX plugin's.

The JAX side runs ``Config.mock(topology="v5e-4", gates="")`` (whole
chips, no sharing gates), the port ``Config.mock(topology="h100-4")``;
both are fed the same claim sequences (``chip-i`` <-> ``gpu-i``) and give
the same results or the same error class, the same visible devices (the
JAX plugin's ``TPU_VISIBLE_DEVICES`` against the GPUs a container made
from the port's spec sees) and the same checkpoint states after every
step. Then what such a container sees, the device list's structure, what
NVML refused (left out or unpublished), the refusals of what is not
ported, and the NVML path over a fake ``libnvidia-ml.so.1``.
"""

import json
import os

import pytest

from k8s_dra_driver_gpu_tpu.api.decode import API_VERSION as JAX_API
from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
from k8s_dra_driver_gpu_tpu.kubeletplugin.checkpoint import \
    CheckpointedClaim as JaxCheckpointedClaim
from k8s_dra_driver_gpu_tpu_torch.api.decode import API_VERSION as PT_API
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.checkpoint import \
    CheckpointedClaim
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import ResourceClaim
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.deviceinfo import (
    ChipInfo, gpu_name, parse_gpu_name)
from k8s_dra_driver_gpu_tpu_torch.tpulib.binding import (GpuChip,
                                                         GpuHostInfo,
                                                         NvmlLib)
from tests.fake_kube import make_claim, make_claim_dict

BOOT = "boot-0"


class Side:
    """One plugin under test: the JAX one or the port."""

    def __init__(self, name: str, root: str):
        self.name = name
        self.root = root
        self.module = jax_ds if name == "jax" else pt_ds
        self.state = self.new_state()

    def new_state(self):
        if self.name == "jax":
            cfg = jax_ds.Config.mock(root=self.root, topology="v5e-4",
                                     gates="")
        else:
            cfg = pt_ds.Config.mock(root=self.root, topology="h100-4")
        cfg.boot_id = BOOT
        return self.module.DeviceState(cfg)

    def device(self, index: int) -> str:
        return f"chip-{index}" if self.name == "jax" else gpu_name(index)

    def claim(self, uid, indices, configs=()):
        devices = [self.device(i) for i in indices]
        cfgs = [{"parameters": self.params(body), "source": source}
                for source, body in configs]
        if self.name == "jax":
            return make_claim(uid, devices, configs=cfgs)
        return ResourceClaim.from_dict(make_claim_dict(
            uid, devices, configs=cfgs, request="gpu", driver=DRIVER_NAME))

    def params(self, body):
        if self.name == "jax":
            return {"apiVersion": JAX_API, "kind": "TpuConfig", **body}
        return {"apiVersion": PT_API, "kind": "GpuConfig", **body}

    def visible(self, uid):
        """The host indices the claim's container sees: the JAX
        plugin's visible-devices line, the GPUs of the port's spec."""
        spec = self.state._cdi.read_spec(uid)
        if self.name == "pt":
            return [",".join(map(str, container_gpus(self.state, [spec])))]
        key = "TPU_VISIBLE_DEVICES="
        return [e[len(key):] for e in spec["containerEdits"]["env"]
                if e.startswith(key)]

    def states(self):
        return {uid: (c.state, [_neutral(d.canonical_name)
                                for d in c.devices])
                for uid, c in self.state.prepared_claims().items()}


def container_gpus(state, specs) -> list[int]:
    """The host GPUs (NVML indices) that a container made from ``specs``
    sees, by the CUDA ordinal it gives them. The container holds only the
    GPU nodes the specs inject, and CUDA numbers those from 0 in PCI bus
    order (NVML's index order), then narrows them by
    ``CUDA_VISIBLE_DEVICES`` where it is set: an ordinal the container
    does not have ends the list. Same-named env merges last wins, as CDI
    merges it."""
    env, nodes = {}, []
    for spec in specs:
        for edits in [d["containerEdits"] for d in spec["devices"]] + [
                spec.get("containerEdits", {})]:
            nodes += [n["path"] for n in edits.get("deviceNodes", [])]
            env.update(e.partition("=")[::2] for e in edits.get("env", []))
    assert env["CUDA_DEVICE_ORDER"] == "PCI_BUS_ID"
    by_node = {dev.chip.chip.devpath: dev.chip.chip.index
               for dev in state.allocatable.values()}
    gpus = sorted({by_node[n] for n in nodes if n in by_node})
    if "CUDA_VISIBLE_DEVICES" not in env:
        return gpus
    seen = []
    for ordinal in map(int, env["CUDA_VISIBLE_DEVICES"].split(",")):
        if ordinal >= len(gpus):
            break
        seen.append(gpus[ordinal])
    return seen


def _neutral(name: str) -> str:
    return name.replace("chip-", "#").replace("gpu-", "#")


def _shared(state: str) -> dict:
    return {"sharing": {"strategy": "TimeSlicing",
                        "timeSlicing": {"interval": state}}}


def _run(side: Side, op: tuple, monkeypatch):
    kind, uid = op[0], op[1]
    try:
        if kind == "prepare":
            ids = side.state.prepare(side.claim(uid, *op[2:]))
            return "ok", [_neutral(i.split("=")[1]) for i in ids], \
                side.visible(uid)
        if kind == "fail_prepare":
            def boom(*args, **kwargs):
                raise OSError("disk full")
            with monkeypatch.context() as m:
                m.setattr(side.state._cdi, "create_claim_spec_file", boom)
                side.state.prepare(side.claim(uid, *op[2:]))
        if kind == "unprepare":
            side.state.unprepare(uid)
        if kind == "lose_spec":
            os.unlink(side.state._cdi._spec_path(uid) if side.name == "jax"
                      else side.state._cdi.spec_path(uid))
        if kind == "stale_reservation":
            cls = JaxCheckpointedClaim if side.name == "jax" \
                else CheckpointedClaim
            side.state._checkpoint.update_claim(
                uid, cls(uid=uid, state="PrepareStarted"))
        if kind == "restart":
            side.state = side.new_state()
    except Exception as err:  # noqa: BLE001 - the class is compared
        if isinstance(err, side.module.PrepareError):
            return "error", "PrepareError"
        return "error", type(err).__name__
    return ("ok",)


SCENARIOS = {
    "whole host": [("prepare", "c1", [0, 1, 2, 3])],
    "single and repeated": [("prepare", "c1", [0]), ("prepare", "c1", [0]),
                            ("prepare", "c2", [2, 1])],
    "overlap": [("prepare", "c1", [0, 1]), ("prepare", "c2", [1]),
                ("prepare", "c3", [2])],
    "unknown device": [("prepare", "c1", [9]), ("prepare", "c1", [3])],
    "class then claim": [
        ("prepare", "c1", [0], [("FromClass", _shared("Long")),
                                ("FromClaim", _shared("Default"))]),
        ("prepare", "c2", [1], [("FromClass", _shared("Default")),
                                ("FromClaim", _shared("Long"))]),
        ("prepare", "c3", [2], [("FromClaim", _shared("Long")),
                                ("FromClass", _shared("Default"))]),
        ("prepare", "c4", [3], [("FromClaim", _shared("Short")),
                                ("FromClaim", {})])],
    "unprepare known and unknown": [
        ("prepare", "c1", [0]), ("unprepare", "c1"), ("unprepare", "nope"),
        ("unprepare", "c1"), ("prepare", "c2", [0])],
    "failure midway rolls back": [
        ("prepare", "c0", [3]), ("fail_prepare", "c1", [0, 1]),
        ("prepare", "c2", [1]), ("prepare", "c1", [0])],
    "bad config": [("prepare", "c1", [0], [("FromClaim", {"bogus": 1})]),
                   ("prepare", "c1", [0], [("FromClaim",
                                            _shared("Weekly"))])],
    "stale reservation rolled back": [
        ("stale_reservation", "c1"), ("prepare", "c1", [0, 2])],
    "completed with a lost spec": [
        ("prepare", "c1", [1]), ("lose_spec", "c1"), ("prepare", "c1", [1]),
        ("unprepare", "c1")],
    "restart keeps the claims": [
        ("prepare", "c1", [0, 1]), ("restart", "-"), ("prepare", "c1", [0, 1]),
        ("prepare", "c2", [1]), ("unprepare", "c1"), ("prepare", "c2", [1])],
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_claim_sequence_matches_the_references(tmp_path, monkeypatch, name):
    sides = [Side(side, str(tmp_path / side)) for side in ("jax", "pt")]
    for op in SCENARIOS[name]:
        got = [_run(side, op, monkeypatch) for side in sides]
        assert got[1] == got[0], op
        assert sides[1].states() == sides[0].states(), op
        if op[0] in ("prepare", "unprepare") and got[0][0] == "ok":
            assert sides[1].state._cdi.spec_exists(op[1]) == \
                sides[0].state._cdi.spec_exists(op[1])


@pytest.fixture()
def state(tmp_path):
    return pt_ds.DeviceState(pt_ds.Config.mock(str(tmp_path),
                                               topology="h100-4"))


@pytest.mark.parametrize("index", range(4))
def test_dra_device_has_the_references_structure(tmp_path, index):
    jax_dev = Side("jax", str(tmp_path / "jax")).state.allocatable[
        f"chip-{index}"].to_dra_device()
    dev = Side("pt", str(tmp_path / "pt")).state.dra_devices()[index]
    assert set(dev) == set(jax_dev) == {"name", "attributes", "capacity"}
    assert dev["name"] == gpu_name(index)
    assert parse_gpu_name(dev["name"]) == index
    for attrs in (dev["attributes"], jax_dev["attributes"]):
        for value in attrs.values():
            assert len(value) == 1 and next(iter(value)) in (
                "int", "string", "bool")
    # The attributes both publish, with the same types.
    shared = set(dev["attributes"]) & set(jax_dev["attributes"])
    assert shared == {"uuid", "platform", "acceleratorType", "numaNode",
                      "pciBdf", "workerId", "numHosts"}
    for key in shared:
        assert dev["attributes"][key].keys() == \
            jax_dev["attributes"][key].keys()
    assert dev["attributes"]["minor"] == {"int": index}
    assert dev["attributes"]["productName"] == {
        "string": "NVIDIA H100 80GB HBM3"}
    assert dev["capacity"] == {"memory": {"value": str(80 << 30)}}


def test_prepared_spec_and_checkpoint(state):
    ids = state.prepare(ResourceClaim.from_dict(make_claim_dict(
        "c1", ["gpu-2", "gpu-0"], request="gpu", driver=DRIVER_NAME)))
    # In the claim's order, as the JAX plugin returns them.
    assert ids == ["nvidia.com/gpu=gpu-2", "nvidia.com/gpu=gpu-0"]
    spec = state._cdi.read_spec("c1")
    assert [d["containerEdits"]["deviceNodes"] for d in spec["devices"]] \
        == [[{"path": "/dev/nvidia0"}], [{"path": "/dev/nvidia2"}]]
    env = spec["containerEdits"]["env"]
    assert env[-1] == "CUDA_DEVICE_ORDER=PCI_BUS_ID"
    assert not [e for e in env if e.startswith("CUDA_VISIBLE_DEVICES=")]
    assert state.prepared_claims()["c1"].state == "PrepareCompleted"
    assert {"prep_lock_wait", "checkpoint_write_started", "prep_devices",
            "gen_write_cdi_spec", "checkpoint_write_completed"} <= set(
                state.last_segments)
    with open(state._checkpoint.path) as f:
        assert json.load(f)["data"]["claims"]["c1"]["devices"][0] == {
            "canonicalName": "gpu-2", "kind": "chip",
            "cdiDeviceIDs": ["nvidia.com/gpu=gpu-2"]}



# -- what a container made from the spec sees -----------------------------------

@pytest.fixture()
def dev_state(tmp_path):
    """A mock host of four GPUs whose device root holds the control
    nodes, as files that cannot be opened."""
    dev = tmp_path / "dev"
    dev.mkdir()
    for name in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools"):
        (dev / name).write_text("")
        os.chmod(dev / name, 0)
    return pt_ds.DeviceState(pt_ds.Config.mock(str(tmp_path),
                                               topology="h100-4"))


@pytest.mark.parametrize("indices", [[3], [2], [1, 3], [3, 0], [0, 2, 3],
                                     [3, 2, 1, 0]])
def test_container_sees_exactly_the_claimed_gpus(dev_state, tmp_path,
                                                 indices):
    dev_state.prepare(ResourceClaim.from_dict(make_claim_dict(
        "c1", [gpu_name(i) for i in indices], driver=DRIVER_NAME)))
    spec = dev_state._cdi.read_spec("c1")
    assert [n["path"] for n in spec["containerEdits"]["deviceNodes"]] == [
        str(tmp_path / "dev" / name)
        for name in ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")]
    # Ordinal i is the claim's i-th GPU by NVML index.
    assert container_gpus(dev_state, [spec]) == sorted(indices)


def test_a_pod_with_two_claims_sees_both(dev_state):
    specs = []
    for uid, index in (("c1", 3), ("c2", 1)):
        dev_state.prepare(ResourceClaim.from_dict(make_claim_dict(
            uid, [gpu_name(index)], driver=DRIVER_NAME)))
        specs.append(dev_state._cdi.read_spec(uid))
    assert container_gpus(dev_state, specs) == [1, 3]


# -- what NVML refused --------------------------------------------------------

def _chip(index, **refused) -> GpuChip:
    fields = dict(index=index, uuid=f"GPU-{index}",
                  devpath=f"/dev/nvidia{index}", minor=index, numa_node=0,
                  pci_bdf=f"0000:1{index}:00.0", name="NVIDIA H100 80GB HBM3",
                  memory_bytes=80 << 30)
    fields.update(refused)
    return GpuChip(**fields)


def _host(chips, **fields) -> GpuHostInfo:
    values = dict(platform="h100", product_name="NVIDIA H100 80GB HBM3",
                  driver_version="550.54.15", accelerator_type="h100-2",
                  num_slice_chips=len(chips), num_hosts=1, worker_id=0,
                  chips_per_host=len(chips), memory_bytes_per_chip=80 << 30,
                  power_limit_watts=700.0, mig_mode="disabled",
                  chips=tuple(chips), source="nvml")
    values.update(fields)
    return GpuHostInfo(**values)


@pytest.mark.parametrize("refused, left_out", [
    ({}, []),
    ({"pci_bdf": ""}, ["pciBdf"]),
    ({"numa_node": -1}, ["numaNode"]),
    ({"pci_bdf": "", "numa_node": -1}, ["numaNode", "pciBdf"]),
    ({"uuid": ""}, ["uuid"]),
    ({"uuid": "GPU-REDACTED"}, ["uuid"]),
    ({"uuid": "GPU-REDACTED", "pci_bdf": "", "numa_node": -1},
     ["numaNode", "pciBdf", "uuid"]),
    ({"minor": -1}, ["minor"]),
])
def test_refused_chip_values_are_left_out(refused, left_out):
    info = ChipInfo(chip=_chip(0, **refused), host=_host([_chip(0)]))
    assert sorted(info.refused_attributes()) == left_out
    assert not set(left_out) & set(info.attributes())
    assert "" not in info.attributes().values()


@pytest.mark.parametrize("host_fields, left_out", [
    ({"mig_mode": "unknown: NOT_SUPPORTED"}, ["migMode"]),
    ({"driver_version": "", "accelerator_type": "", "platform": ""},
     ["acceleratorType", "driverVersion", "platform"]),
])
def test_refused_host_values_are_left_out(host_fields, left_out):
    info = ChipInfo(chip=_chip(0), host=_host([_chip(0)], **host_fields))
    assert sorted(info.refused_attributes()) == left_out


class _FakeLib:
    def __init__(self, host):
        self.host = host
        self.closed = False

    def enumerate(self, opts=None):
        return self.host

    def close(self):
        self.closed = True


def test_gpu_without_device_node_is_not_published(tmp_path, monkeypatch,
                                                   caplog):
    lib = _FakeLib(_host([_chip(0, devpath="", minor=-1), _chip(1)]))
    monkeypatch.setattr(pt_ds, "load", lambda backend: lib)
    state = pt_ds.DeviceState(pt_ds.Config(root=str(tmp_path)))
    assert lib.closed  # enumerated once, then closed
    assert list(state.allocatable) == ["gpu-1"]
    assert "GPU 0 (GPU-0) has no device node" in caplog.text
    with pytest.raises(pt_ds.PrepareError, match="unknown device"):
        state.prepare(ResourceClaim.from_dict(make_claim_dict(
            "c1", ["gpu-0"], driver=DRIVER_NAME)))


@pytest.mark.parametrize("shared", [(0, 1), (0, 1, 2)])
def test_a_uuid_that_gpus_share_is_left_out(shared):
    # A container's NVML may answer one placeholder for every GPU: a
    # selector on it would match any of them.
    chips = [_chip(i, uuid="GPU-same" if i in shared else f"GPU-{i}")
             for i in range(4)]
    host = _host(chips)
    for chip in chips:
        info = ChipInfo(chip=chip, host=host)
        assert ("uuid" in info.refused_attributes()) == (chip.index in shared)
        assert ("uuid" in info.attributes()) == (chip.index not in shared)


# -- what is not ported --------------------------------------------------------

@pytest.mark.parametrize("parameters, item", [
    ({"apiVersion": PT_API, "kind": "MigDeviceConfig"}, 5),
    ({"apiVersion": PT_API, "kind": "VfioDeviceConfig"}, 6),
    ({"apiVersion": PT_API, "kind": "GpuConfig", **_shared("Short")}, 4),
    ({"apiVersion": PT_API, "kind": "GpuConfig",
      "sharing": {"strategy": "MultiTenancy", "multiTenancy": {}}}, 4),
])
def test_configs_of_unported_features_are_refused(state, parameters, item):
    claim = ResourceClaim.from_dict(make_claim_dict(
        "c1", ["gpu-0"], driver=DRIVER_NAME,
        configs=[{"parameters": parameters}]))
    with pytest.raises(pt_ds.NotPortedError,
                       match=f"ROADMAP.md §1b item {item}"):
        state.prepare(claim)
    assert state.prepared_claims() == {}
    assert not state._cdi.spec_exists("c1")


# -- the NVML path, over a fake libnvidia-ml.so.1 -------------------------------

@pytest.fixture(scope="module")
def fake_nvml(tmp_path_factory):
    from tests.test_torch_tpulib import FAKE_NVML_C, _cc

    d = tmp_path_factory.mktemp("fake_nvml")
    (d / "fake_nvml.c").write_text(FAKE_NVML_C)
    _cc("-shared", "-fPIC", "-O1", "-o", str(d / "libnvidia-ml.so.1"),
        str(d / "fake_nvml.c"))
    return str(d / "libnvidia-ml.so.1")


@pytest.mark.parametrize("no_pci", [False, True])
def test_nvml_host_prepares_a_whole_gpu(tmp_path, monkeypatch, fake_nvml,
                                        no_pci):
    # With the PCI info refused (as in the H100's container), pciBdf and
    # numaNode are left out and the GPU still prepares.
    import ctypes

    from tests.test_torch_tpulib import BUS_IDS

    ctypes.CDLL(fake_nvml).fake_reset()
    if no_pci:
        monkeypatch.setenv("FAKE_NVML_NO_PCI", "1")
    sys_root = tmp_path / "sys"
    for i, bdf in enumerate(BUS_IDS):
        pci = sys_root / "bus" / "pci" / "devices" / bdf
        pci.mkdir(parents=True)
        (pci / "numa_node").write_text(f"{i // 2}\n")
    monkeypatch.setattr(pt_ds, "load", lambda backend: NvmlLib(
        fake_nvml, sys_root=str(sys_root)))
    state = pt_ds.DeviceState(pt_ds.Config(root=str(tmp_path / "state"),
                                           boot_id=BOOT))
    devices = state.dra_devices()
    assert [d["name"] for d in devices] == [f"gpu-{i}" for i in range(4)]
    attrs = devices[2]["attributes"]
    assert ("pciBdf" in attrs, "numaNode" in attrs) == (not no_pci,) * 2
    if not no_pci:
        assert attrs["pciBdf"] == {"string": BUS_IDS[2]}
        assert attrs["numaNode"] == {"int": 1}
    assert devices[2]["capacity"] == {"memory": {"value": str(85520809986)}}
    ids = state.prepare(ResourceClaim.from_dict(make_claim_dict(
        "c1", ["gpu-2"], driver=DRIVER_NAME)))
    assert ids == ["nvidia.com/gpu=gpu-2"]
    assert container_gpus(state, [state._cdi.read_spec("c1")]) == [2]
    state.unprepare("c1")
    assert state.prepared_claims() == {}
