"""The port's whole-GPU ``DeviceState`` against the JAX plugin's.

The JAX side runs ``Config.mock(topology="v5e-4", gates=...)`` (whole
chips), the port ``Config.mock(topology="h100-4", gates=...)``, with the
sharing gates off (``SCENARIOS``) or on (``SHARING_SCENARIOS``, the port
over the fake ``nvidia-smi`` and MPS control daemon of
``test_torch_kubeletplugin_sharing.py``); both are fed the same claim
sequences (``chip-i`` <-> ``gpu-i``) and give the same results or the
same error class, the same visible devices (the JAX plugin's
``TPU_VISIBLE_DEVICES`` against the GPUs a container made from the port's
spec sees), the same checkpoint states and the same sharing records
after every step. Then what such a container sees, the device list's
structure, what NVML refused (left out or unpublished), the refusals of
what is not ported, and the NVML path over a fake ``libnvidia-ml.so.1``.
"""

import contextlib
import dataclasses
import json
import os
import re
from unittest import mock

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
from k8s_dra_driver_gpu_tpu_torch.pkg import featuregates as pt_fg
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.deviceinfo import (
    ChipInfo, gpu_name, parse_gpu_name)
from k8s_dra_driver_gpu_tpu_torch.tpulib.binding import (GpuChip,
                                                         GpuHostInfo,
                                                         NvmlLib)
from tests.fake_kube import make_claim, make_claim_dict
from tests.test_torch_kubeletplugin_sharing import (expected_level,
                                                    fake_daemon_pids,
                                                    kill_fake_daemons,
                                                    smi_calls,
                                                    write_fake_binaries)

BOOT = "boot-0"
SHARING_GATES = "TimeSlicingSettings=true,MultiTenancySupport=true"
MIG_GATES = "DynamicSubSlice=true"


def write_mig_caps(root: str, gpus: int = 8) -> None:
    """The driver's MIG capability files under a mock host's ``root``:
    ``proc/driver/nvidia-caps/mig-minors`` in the driver's format (every
    GPU instance 0-14 and compute instance 0-7 of GPUs 0 .. gpus - 1),
    and each minor's ``dev/nvidia-caps/nvidia-cap<N>`` as an empty
    file."""
    lines, minor = ["config 1", "monitor 2"], 2
    for gpu in range(gpus):
        for gi in range(15):
            minor += 1
            lines.append(f"gpu{gpu}/gi{gi}/access {minor}")
            for ci in range(8):
                minor += 1
                lines.append(f"gpu{gpu}/gi{gi}/ci{ci}/access {minor}")
    proc = os.path.join(root, "proc", "driver", "nvidia-caps")
    caps = os.path.join(root, "dev", "nvidia-caps")
    os.makedirs(proc, exist_ok=True)
    os.makedirs(caps, exist_ok=True)
    with open(os.path.join(proc, "mig-minors"), "w") as f:
        f.write("\n".join(lines) + "\n")
    for n in range(1, minor + 1):
        open(os.path.join(caps, f"nvidia-cap{n}"), "w").close()


class _Degraded:
    """A device library whose host lacks its last chip (the JAX mock) or
    cannot publish its last GPU (the port's: no device node)."""

    def __init__(self, lib, jax: bool):
        self._lib, self._jax = lib, jax

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def enumerate(self, opts=None):
        host = self._lib.enumerate(opts)
        last = host.chips[-1]
        if self._jax:
            return dataclasses.replace(host, chips=host.chips[:-1])
        return dataclasses.replace(host, chips=host.chips[:-1] + (
            dataclasses.replace(last, devpath="", minor=-1),))


class Side:
    """One plugin under test: the JAX one or the port (over the fake
    binaries under ``driver_root``, where given). With ``mig`` the JAX
    plugin runs a ``v5p-8`` host (four chips of two TensorCores, with
    their sub-slices) and the port an ``h100-4`` host with MIG on and the
    driver's MIG capability files."""

    def __init__(self, name: str, root: str, gates: str = "",
                 driver_root: str | None = None, mig: bool = False):
        self.name = name
        self.root = root
        self.gates = gates
        self.driver_root = driver_root
        self.mig = mig
        self.statics: tuple = ()
        self.degraded = False
        self.admin = 0  # GPU instances an admin made (the port's)
        self.module = jax_ds if name == "jax" else pt_ds
        if mig and name == "pt":
            write_mig_caps(root)
        self.state = self.new_state()

    def new_state(self):
        if self.name == "jax":
            cfg = jax_ds.Config.mock(root=self.root, topology="v5p-8"
                                     if self.mig else "v5e-4",
                                     gates=self.gates)
            real = jax_ds.load_tpulib
            patch = mock.patch.object(jax_ds, "load_tpulib", lambda: _Degraded(
                real(), True)) if self.degraded else contextlib.nullcontext()
        else:
            cfg = pt_ds.Config.mock(root=self.root, topology="h100-4",
                                    gates=self.gates, mig_mode="enabled"
                                    if self.mig else "disabled")
            if self.driver_root:
                cfg.driver_root = self.driver_root
            real = pt_ds.load
            patch = mock.patch.object(pt_ds, "load", lambda backend: _Degraded(
                real(backend), False)) if self.degraded \
                else contextlib.nullcontext()
        cfg.static_subslices = tuple(map(self.device, self.statics))
        cfg.boot_id = BOOT
        with patch:
            return self.module.DeviceState(cfg)

    def registry(self) -> int:
        """The live instances the plugin's registry names."""
        if self.name == "jax":
            return len(self.state._registry.list())
        return len(self.state.mig_registry())

    def sharing(self):
        """Each GPU's timeslice record (interval, holders), and each MPS
        request's manifest by claim (the devices named neutrally, the
        capacity left out: a v5e's and an H100's differ)."""
        records = [doc and (doc["interval"], doc["holders"])
                   for doc in map(self.state._timeslicing.current,
                                  range(4))]
        manifests = []
        if self.name == "jax":
            root = os.path.join(self.root, "tenancy")
            found = [(uid, os.path.join(root, uid, req, "tenancy.json"))
                     for uid in sorted(os.listdir(root))
                     for req in sorted(os.listdir(os.path.join(root, uid)))]
        else:
            found = [(owner["claim"], os.path.join(d, "claim.json"))
                     for d, owner in self.state._tenancy._owners().items()]
        for uid, path in sorted(found):
            with open(path) as f:
                doc = json.load(f)
            manifests.append((uid, doc["chips"], doc["maxClients"], {
                _neutral(k): v for k, v in doc["hbmLimits"].items()}))
        return records, manifests

    def device(self, token) -> str:
        """A whole chip or GPU by index; ("mig", i, k) the JAX plugin's
        TensorCore k of chip i and the port's 1g.10gb MIG device at
        memory slot k of GPU i; ("full", i) a sub-slice of all chip i and
        the 7g.80gb MIG device of GPU i; ("bad",) a name of neither."""
        jax = self.name == "jax"
        if isinstance(token, int):
            return f"chip-{token}" if jax else gpu_name(token)
        kind, *at = token
        if kind == "mig":
            return f"chip-{at[0]}-ss-1c-{at[1]}" if jax \
                else f"gpu-{at[0]}-mig-1g10gb-{at[1]}"
        if kind == "full":
            return f"ss-1x1x1-{at[0]}" if jax \
                else f"gpu-{at[0]}-mig-7g80gb-0"
        return "chip-0-ss-9c-0" if jax else "gpu-0-mig-9g90gb-0"

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
    by_node = {dev.gpu.devpath: dev.gpu.index
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
    name = re.sub(r"chip-(\d+)-ss-1c-(\d+)|gpu-(\d+)-mig-1g10gb-(\d+)",
                  lambda m: f"#{m[1] or m[3]}.m{m[2] or m[4]}", name)
    name = re.sub(r"ss-1x1x1-(\d+)|gpu-(\d+)-mig-7g80gb-0",
                  lambda m: f"#{m[1] or m[2]}.full", name)
    return name.replace("chip-", "#").replace("gpu-", "#")


# The devices whose publication the MIG scenarios compare.
MIG_TOKENS = [("mig", i, k) for i in range(4) for k in range(2)] + [
    ("full", i) for i in range(4)] + list(range(4))


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
        if kind == "degrade":
            side.degraded = True
            side.state = side.new_state()
        if kind == "restart_static":
            side.statics = tuple(op[2])
            side.state = side.new_state()
        if kind == "published":
            kinds = {name: dev.kind.value
                     for name, dev in side.state.allocatable.items()}
            return "ok", [(_neutral(side.device(t)),
                           kinds.get(side.device(t))) for t in MIG_TOKENS]
        if kind == "admin" and side.name == "pt":
            # An admin's GPU instance, made before the plugin starts.
            from k8s_dra_driver_gpu_tpu_torch.tpulib import PyGpuLib
            from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.subslice import \
                parse_mig_name

            lib = PyGpuLib()
            lib.enumerate(side.state._config.gpulib_opts)
            lib.create_mig(*parse_mig_name(side.device(op[2])))
            side.admin += 1
        if kind == "orphan":
            # What a crash after the create leaves: a live instance in
            # the registry that no claim names.
            name = side.device(op[2])
            if side.name == "jax":
                from k8s_dra_driver_gpu_tpu.kubeletplugin import subslice
                side.state._registry.create(subslice.SubSliceLiveTuple(
                    spec=subslice.SubSliceSpecTuple.from_canonical_name(
                        name), uuid="tpu-ss-orphan"))
            else:
                side.state._create_mig(
                    side.state.allocatable[name].subslice.spec)
        if kind == "prepare_under_live_mps":
            # Neither plugin prepares such a claim again: the JAX one
            # returns its ids, the port raises (unprepare recovers it).
            try:
                side.state.prepare(side.claim(uid, *op[2:]))
                how = "returned"
            except side.module.PrepareError:
                how = "raised"
            return ("not prepared again",
                    how == ("returned" if side.name == "jax" else "raised"),
                    side.state._cdi.spec_exists(uid))
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


# MIG devices against the JAX plugin's sub-slices (tests/
# test_device_state.py:37-226): the same outcome class and the same count
# of live instances in the registry after every step.
_M00, _M01, _M10, _M11 = (("mig", 0, 0), ("mig", 0, 1), ("mig", 1, 0),
                          ("mig", 1, 1))
SCENARIOS.update({
    "MIG dynamic devices published": [("published", "-")],
    "MIG gate off publishes none": [
        ("published", "-"), ("prepare", "c1", [_M00]),
        ("prepare", "c2", [0])],
    "MIG overlap with a whole GPU refused": [
        ("prepare", "c1", [_M00]), ("prepare", "c2", [0]),
        ("prepare", "c3", [1]), ("prepare", "c4", [_M11]),
        ("prepare", "c5", [("full", 2)]), ("prepare", "c6", [("mig", 2, 1)]),
        ("prepare", "c7", [2]), ("prepare", "c8", [3, ("mig", 3, 0)])],
    "MIG disjoint devices allowed": [
        ("prepare", "c1", [_M00]), ("prepare", "c2", [_M01]),
        ("prepare", "c3", [_M00]), ("prepare", "c4", [0]),
        ("prepare", "c5", [("full", 0)]), ("prepare", "c6", [_M10, _M11]),
        ("prepare", "c7", [2, ("mig", 3, 1)])],
    "MIG dynamic lifecycle": [
        ("prepare", "c1", [_M00]), ("prepare", "c1", [_M00]),
        ("unprepare", "c1"), ("prepare", "c2", [("full", 3)]),
        ("restart", "-"), ("prepare", "c2", [("full", 3)]),
        ("unprepare", "c2"), ("unprepare", "c2"), ("prepare", "c3", [3])],
    "MIG static device prepared and not destroyed": [
        ("admin", "-", _M00), ("restart_static", "-", [_M00]),
        ("published", "-"), ("prepare", "c1", [_M00]), ("unprepare", "c1"),
        ("published", "-"), ("prepare", "c2", [_M00, _M01]),
        ("unprepare", "c2")],
    "MIG degraded host publishes none": [
        ("degrade", "-"), ("published", "-"), ("prepare", "c1", [_M00]),
        ("prepare", "c2", [0])],
    "MIG invalid static name fails startup": [
        ("restart_static", "-", [("bad",)]),
        ("restart_static", "-", [("mig", 9, 0)]), ("prepare", "c1", [_M00])],
    "MIG failure midway rolls back": [
        ("prepare", "c0", [3]), ("fail_prepare", "c1", [_M00, _M11]),
        ("prepare", "c2", [_M00]), ("prepare", "c1", [_M11]),
        ("unprepare", "c2")],
    "MIG restart sweeps an orphan": [
        ("prepare", "c1", [_M00]), ("orphan", "-", _M10),
        ("restart", "-"), ("prepare", "c2", [_M10]), ("unprepare", "c1"),
        ("orphan", "-", _M01), ("restart", "-")],
})


def _mps(max_clients=2, hbm_limit="8Gi") -> dict:
    return {"sharing": {"strategy": "MultiTenancy", "multiTenancy": {
        "maxClients": max_clients, "hbmLimit": hbm_limit}}}


SCENARIOS["sharing refused with its gates off"] = [
    ("prepare", "c1", [0], [("FromClaim", _shared("Short"))]),
    ("prepare", "c1", [0], [("FromClaim", _mps())]),
    ("prepare", "c1", [0], [("FromClaim", _shared("Default"))]),
    ("prepare", "c2", [1], [("FromClass", _shared("Long"))])]

SHARING_SCENARIOS = {
    "short and long": [
        ("prepare", "c1", [0], [("FromClaim", _shared("Short"))]),
        ("prepare", "c2", [1, 2], [("FromClass", _shared("Long"))]),
        ("prepare", "c3", [3], [("FromClaim", _shared("Default"))]),
        ("prepare", "c1", [0], [("FromClaim", _shared("Short"))]),
        ("unprepare", "c1"), ("prepare", "c1", [0]),
        ("unprepare", "c2"), ("unprepare", "c1"), ("unprepare", "c3")],
    "multi-tenancy": [
        ("prepare", "c1", [0, 1], [("FromClaim", _mps())]),
        ("prepare", "c2", [2], [("FromClaim", _mps(None, None))]),
        ("prepare", "c3", [3], [("FromClaim", _shared("Medium"))]),
        ("prepare", "c1", [0, 1], [("FromClaim", _mps())]),
        ("unprepare", "c1"), ("prepare", "c4", [1, 0],
                              [("FromClaim", _mps(1, "1Gi"))]),
        ("unprepare", "c2"), ("unprepare", "c4")],
    "failure midway": [
        ("prepare", "c0", [3], [("FromClaim", _shared("Long"))]),
        ("fail_prepare", "c1", [0, 1], [("FromClaim", _shared("Short"))]),
        ("fail_prepare", "c2", [2], [("FromClaim", _mps())]),
        ("prepare", "c2", [2], [("FromClaim", _mps())]),
        ("prepare", "c1", [0, 1], [("FromClaim", _shared("Short"))])],
    "restart": [
        ("prepare", "c1", [0], [("FromClaim", _mps())]),
        ("prepare", "c2", [1], [("FromClaim", _shared("Long"))]),
        ("restart", "-"),
        ("prepare", "c1", [0], [("FromClaim", _mps())]),
        ("prepare", "c3", [2], [("FromClaim", _mps(3, "4Gi"))]),
        ("unprepare", "c1"), ("restart", "-"), ("unprepare", "c2"),
        ("unprepare", "c3")],
    "lost spec with MPS live": [
        ("prepare", "c1", [0], [("FromClaim", _mps())]),
        ("lose_spec", "c1"),
        ("prepare_under_live_mps", "c1", [0], [("FromClaim", _mps())]),
        ("unprepare", "c1"),
        ("prepare", "c1", [0], [("FromClaim", _mps())]),
        ("unprepare", "c1")],
}


def _check_the_port_on_its_card(side: Side) -> None:
    """The fake nvidia-smi's last level of each GPU is what its record
    asks for, and an MPS daemon runs for each request directory."""
    level = dict.fromkeys(range(4), 0)
    for argv in smi_calls(side.driver_root):
        level[int(argv[2])] = int(argv[3].split("=")[1])
    assert [level[i] for i in range(4)] == [
        expected_level(side.state._timeslicing.current(i))
        for i in range(4)]
    assert len(fake_daemon_pids(side.driver_root)) == len(
        side.state._tenancy._owners())


def _check_the_port_on_its_gpus(side: Side) -> None:
    """The instances on the mock GPUs are the registry's and the
    admin's, and every prepared MIG device of the registry exists."""
    from k8s_dra_driver_gpu_tpu_torch.tpulib import PyGpuLib

    lib = PyGpuLib()
    lib.enumerate(side.state._config.gpulib_opts)
    walk = {i.uuid for gpu in range(4) for i in lib.mig_instances(gpu)}
    registry = side.state.mig_registry()
    assert set(registry) <= walk
    assert len(walk) == len(registry) + side.admin


def _compare(sides, ops, monkeypatch):
    for op in ops:
        got = [_run(side, op, monkeypatch) for side in sides]
        assert got[1] == got[0], op
        assert sides[1].states() == sides[0].states(), op
        assert sides[1].sharing() == sides[0].sharing(), op
        if op[0] in ("prepare", "unprepare") and got[0][0] == "ok":
            assert sides[1].state._cdi.spec_exists(op[1]) == \
                sides[0].state._cdi.spec_exists(op[1])
        if sides[1].driver_root:
            _check_the_port_on_its_card(sides[1])
        if sides[1].mig:
            assert sides[1].registry() == sides[0].registry(), op
            _check_the_port_on_its_gpus(sides[1])


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_claim_sequence_matches_the_references(tmp_path, monkeypatch, name):
    mig = name.startswith("MIG")
    gates = MIG_GATES if mig and "gate off" not in name else ""
    sides = [Side(side, str(tmp_path / side), gates, mig=mig)
             for side in ("jax", "pt")]
    _compare(sides, SCENARIOS[name], monkeypatch)


@pytest.fixture()
def fake_driver(tmp_path):
    root = write_fake_binaries(tmp_path / "driver")
    yield root
    kill_fake_daemons(root)


@pytest.mark.parametrize("name", sorted(SHARING_SCENARIOS))
def test_shared_claims_match_the_references(tmp_path, monkeypatch,
                                            fake_driver, name):
    sides = [Side("jax", str(tmp_path / "jax"), SHARING_GATES),
             Side("pt", str(tmp_path / "pt"), SHARING_GATES, fake_driver)]
    _compare(sides, SHARING_SCENARIOS[name], monkeypatch)
    for side in sides:
        for uid in list(side.state.prepared_claims()):
            side.state.unprepare(uid)
    assert fake_daemon_pids(fake_driver) == []
    assert [level for level in sides[1].sharing()[0]] == [None] * 4


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


def driver_root(tmp_path, version="550.54.15") -> str:
    """A driver root holding the two libraries a spec cannot go without,
    at ``version`` (the fake hosts' and the fake NVML's)."""
    lib = tmp_path / "driver" / "usr" / "lib64"
    lib.mkdir(parents=True)
    for name in ("libcuda", "libnvidia-ml"):
        (lib / f"{name}.so.{version}").write_text(version)
    return str(tmp_path / "driver")


def test_gpu_without_device_node_is_not_published(tmp_path, monkeypatch,
                                                   caplog):
    lib = _FakeLib(_host([_chip(0, devpath="", minor=-1), _chip(1)]))
    monkeypatch.setattr(pt_ds, "load", lambda backend: lib)
    state = pt_ds.DeviceState(pt_ds.Config(
        root=str(tmp_path / "state"), driver_root=driver_root(tmp_path)))
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
    ({"apiVersion": PT_API, "kind": "VfioDeviceConfig"}, 6),
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
                                           boot_id=BOOT,
                                           driver_root=driver_root(tmp_path)))
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


# -- sharing on the port alone ---------------------------------------------------

def _sharing_state(tmp_path, driver, gates=SHARING_GATES, boot=BOOT):
    cfg = pt_ds.Config.mock(str(tmp_path / "state"), topology="h100-4",
                            gates=gates)
    cfg.driver_root, cfg.boot_id = driver, boot
    return pt_ds.DeviceState(cfg)


def _claim(uid, indices, body=None):
    configs = [] if body is None else [{"parameters": {
        "apiVersion": PT_API, "kind": "GpuConfig", **body}}]
    return ResourceClaim.from_dict(make_claim_dict(
        uid, [gpu_name(i) for i in indices], driver=DRIVER_NAME,
        request="gpu", configs=configs))


@pytest.mark.parametrize("gates, match", [
    ("PassthroughSupport=true", "ROADMAP.md §1b item 6"),
    ("ChipHealthCheck=false", "ROADMAP.md §1b item 8"),
    ("CrashOnICIFabricErrors=false", "reads this gate"),
    ("DeviceMetadata=true", "reads this gate"),
])
def test_gates_of_unported_features_are_refused(tmp_path, gates, match):
    # Every gate the port does not read, set away from its default.
    with pytest.raises(pt_ds.NotPortedError,
                       match=f"feature gate {gates.split(',')[0]}.*{match}"):
        pt_ds.DeviceState(pt_ds.Config.mock(str(tmp_path), "h100-4", gates))


def test_every_gate_is_read_or_refused(tmp_path):
    assert pt_ds.NOT_PORTED_GATES.keys() == set(
        pt_fg.DEFAULTS) - set(pt_fg.READ)
    # At its default a gate is no refusal, and the sharing and MIG gates
    # are read.
    spec = ",".join(f"{name}={str(value).lower()}"
                    for name, value in pt_fg.DEFAULTS.items())
    pt_ds.DeviceState(pt_ds.Config.mock(str(tmp_path), "h100-4", spec))
    pt_ds.DeviceState(pt_ds.Config.mock(str(tmp_path), "h100-4",
                                        SHARING_GATES))
    pt_ds.DeviceState(pt_ds.Config.mock(str(tmp_path), "h100-4",
                                        "DynamicSubSlice=true"))
    # The scheduler's gate is read (pkg/scheduler.py): the GPU plugin
    # takes it, off too, as the JAX plugin does.
    pt_ds.DeviceState(pt_ds.Config.mock(
        str(tmp_path), "h100-4", "TopologyAwarePlacement=false"))
    # TenantPartitioning is read (pkg/partition): no refusal.
    pt_ds.DeviceState(pt_ds.Config.mock(
        str(tmp_path), "h100-4", "DynamicSubSlice=true,TenantPartitioning=true"))
    # The ComputeDomain daemon's gates: one FEATURE_GATES string reaches
    # every binary, and the GPU plugin takes them as the JAX plugin does.
    pt_ds.DeviceState(pt_ds.Config.mock(
        str(tmp_path), "h100-4",
        "ComputeDomainCliques=false,DomainDaemonsWithDNSNames=false"))


def test_an_mps_claims_spec(tmp_path, fake_driver):
    state = _sharing_state(tmp_path, fake_driver)
    state.prepare(_claim("c1", [3, 1], {
        "sharing": {"strategy": "MultiTenancy", "multiTenancy": {
            "hbmLimit": "8Gi", "perDeviceHbmLimits": {"gpu-3": "2Gi"}}}}))
    spec = state._cdi.read_spec("c1")
    common = spec["containerEdits"]
    (d, owner), = state._tenancy._owners().items()
    container = f"/var/run/nvidia-mps/{os.path.basename(d)}"
    assert (owner["visibleDevices"], owner["pinnedMemLimits"]) == (
        "1,3", {"0": "8192M", "1": "2048M"})
    # The MPS edits are the request's GPUs' own, in the daemon's
    # numbering: GPU 1 is its 0, GPU 3 its 1.
    assert common["env"][-1] == "CUDA_DEVICE_ORDER=PCI_BUS_ID"
    assert not any("MPS" in e for e in common["env"])
    assert not any(m["containerPath"] == container
                   for m in common.get("mounts", []))
    for device in spec["devices"]:
        edits = device["containerEdits"]
        assert edits["env"] == [
            f"CUDA_MPS_PIPE_DIRECTORY={container}",
            "CUDA_MPS_PINNED_DEVICE_MEM_LIMIT=0=8192M,1=2048M"]
        assert edits["mounts"] == [{
            "hostPath": os.path.join(d, "pipe"), "containerPath": container,
            "options": ["rw", "nosuid", "nodev", "bind"]}]
    assert container_gpus(state, [spec]) == [1, 3]
    assert "prep_sharing" in state.last_segments
    state.unprepare("c1")
    assert fake_daemon_pids(fake_driver) == [] and not os.listdir(
        state._tenancy._root)


def _two_requests(uid, first, second):
    # Request "a" on GPU 0 and "b" on GPU 1, each with its own config.
    claim = make_claim_dict(uid, [gpu_name(0), gpu_name(1)],
                            driver=DRIVER_NAME, request="a")
    devices = claim["status"]["allocation"]["devices"]
    devices["results"][1]["request"] = "b"
    devices["config"] = [
        {"source": "FromClaim", "requests": [request], "opaque": {
            "driver": DRIVER_NAME, "parameters": {
                "apiVersion": PT_API, "kind": "GpuConfig", **body}}}
        for request, body in (("a", first), ("b", second))]
    return ResourceClaim.from_dict(claim)


@pytest.mark.parametrize("first, second", [
    (_mps(), _mps()),
    (_mps(), _shared("Default")),
    (_shared("Long"), _mps(1, "1Gi")),
], ids=["two MPS requests", "MPS and a plain request",
        "a timesliced request and MPS"])
def test_an_mps_request_must_be_its_claims_only_one(tmp_path, fake_driver,
                                                     first, second):
    state = _sharing_state(tmp_path, fake_driver)
    with pytest.raises(pt_ds.NotPortedError,
                       match="its claim's only one .*MPS beside other "
                       "requests"):
        state.prepare(_two_requests("c1", first, second))
    assert state.prepared_claims() == {}
    assert not state._cdi.spec_exists("c1")
    assert os.listdir(state._tenancy._root) == []
    assert [state._timeslicing.current(i) for i in range(4)] == [None] * 4
    assert fake_daemon_pids(fake_driver) == [] and smi_calls(fake_driver) \
        == []
    # Two requests without MPS still prepare, each its own timeslice.
    state.prepare(_two_requests("c2", _shared("Long"), _shared("Short")))
    assert [state._timeslicing.current(i)["interval"] for i in (0, 1)] == [
        "Long", "Short"]


def test_a_refused_timeslice_rolls_the_claim_back(tmp_path, fake_driver):
    # As on the H100 machine's container: nvidia-smi "Not Supported".
    with open(os.path.join(fake_driver, "smi.refuse"), "w") as f:
        f.write("0 1 2 3")
    state = _sharing_state(tmp_path, fake_driver)
    with pytest.raises(pt_ds.PrepareError, match="exited 3: .*Not Supported"):
        state.prepare(_claim("c1", [0, 2], _shared("Long")))
    assert state.prepared_claims() == {}
    assert not state._cdi.spec_exists("c1")
    assert [state._timeslicing.current(i) for i in range(4)] == [None] * 4
    # A plain claim still prepares: its Default level calls nothing.
    state.prepare(_claim("c2", [0]))
    assert smi_calls(fake_driver) == []


@pytest.mark.parametrize("knob", ["mps.refuse", None])
def test_mps_that_does_not_start_rolls_the_claim_back(tmp_path, fake_driver,
                                                      knob):
    if knob:
        open(os.path.join(fake_driver, knob), "w").close()
    else:
        os.unlink(os.path.join(fake_driver, "usr", "bin",
                               "nvidia-cuda-mps-control"))
    state = _sharing_state(tmp_path, fake_driver)
    with pytest.raises(pt_ds.PrepareError, match="nvidia-cuda-mps-control"):
        state.prepare(_claim("c1", [1], _mps()))
    assert state.prepared_claims() == {}
    assert not state._cdi.spec_exists("c1")
    assert os.listdir(state._tenancy._root) == []
    assert fake_daemon_pids(fake_driver) == []


def test_construction_restarts_dead_daemons_and_quits_orphans(tmp_path,
                                                              fake_driver):
    state = _sharing_state(tmp_path, fake_driver)
    for uid, index in (("live", 0), ("dead", 1), ("crashed", 2)):
        state.prepare(_claim(uid, [index], _mps()))
    live, dead = sharing_pids(state, "live"), sharing_pids(state, "dead")
    os.kill(dead[0], 9)
    # "crashed" is left PrepareStarted, as by a prepare that died.
    state._checkpoint.update_claim("crashed", None)
    state._checkpoint.update_claim("crashed", CheckpointedClaim(
        uid="crashed", state="PrepareStarted"))
    again = _sharing_state(tmp_path, fake_driver)
    assert sharing_pids(again, "live") == live
    assert sharing_pids(again, "dead") not in ([], dead)
    assert not again._tenancy._dirs_of("crashed")
    assert len(fake_daemon_pids(fake_driver)) == 2
    for uid in ("live", "dead", "crashed"):
        again.unprepare(uid)
    assert fake_daemon_pids(fake_driver) == []


def sharing_pids(state, uid) -> list[int]:
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.sharing import mps_pids

    return [pid for d in state._tenancy._dirs_of(uid)
            for pid in mps_pids(state._tenancy.pipe_dir(d))]


def test_a_boot_id_change_clears_the_sharing_state(tmp_path, fake_driver):
    state = _sharing_state(tmp_path, fake_driver)
    state.prepare(_claim("c1", [0], _shared("Long")))
    state.prepare(_claim("c2", [1], _mps()))
    # The reboot: every daemon and level is gone with it.
    kill_fake_daemons(fake_driver)
    again = _sharing_state(tmp_path, fake_driver, boot="boot-1")
    assert again.prepared_claims() == {}
    assert again._timeslicing.current(0) is None
    assert os.listdir(again._tenancy._root) == []
    assert fake_daemon_pids(fake_driver) == []
