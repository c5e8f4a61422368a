"""The port's tenant partitions against the JAX plugin's.

The JAX plugin runs ``Config.mock(topology="v5e-4")`` (four chips; its
``1x1`` carve-out is one chip), the port ``Config.mock("h100-4",
mig_mode="enabled")`` over the mock NVML with MIG on (its ``7g.80gb``
MIG profile is one GPU: one placement a GPU), the fake ``nvidia-smi``
and MPS control daemon of ``test_torch_kubeletplugin_sharing.py`` and
the driver's MIG capability files. Both get the same partition sets and
claim sequences (``chip-i`` <-> ``gpu-i``, ``ss-1x1-i`` <->
``gpu-i-mig-7g80gb-0``, ``pt-<profile>-<k>`` on both), step by step,
after the scenarios of the JAX package's ``tests/test_partition.py``
and its pre-warm cases (``tests/test_powersched.py``), and each step's
outcome must be the same: prepared or refused and why, the MIG
instances (carve-outs) live, the partition records' states, the holders,
the partitions whose tenants are capped (the JAX tenancy dirs, the
port's MPS daemon), the timeslice records and the prepared claims. A
crash is the JAX fault seam on one side and an exception from the mock
NVML's create or destroy on the other, followed by a fresh
``DeviceState``.

Then what only the port has: an instance the registry does not name is
never adopted, every durable state a crash can leave settles at
construction, a re-plan racing prepares on two threads never creates
twice or outside the node lock, the tenant budget is whole MiB, the
per-slot counters never sum past the instance, one MPS daemon a
partition, over its MIG UUID, and a refused daemon rolls back.
"""

import json
import os
import threading
from unittest import mock

import pytest

from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
from k8s_dra_driver_gpu_tpu.kubeletplugin import driver as jax_driver
from k8s_dra_driver_gpu_tpu.kubeletplugin.deviceinfo import \
    DeviceKind as JaxKind
from k8s_dra_driver_gpu_tpu.kubeletplugin.partitions import \
    consumed_counters as jax_consumed
from k8s_dra_driver_gpu_tpu.pkg import faults
from k8s_dra_driver_gpu_tpu.pkg import partition as jax_partition
from k8s_dra_driver_gpu_tpu.pkg.analysis import statemachine as jax_sm
from k8s_dra_driver_gpu_tpu.pkg.kubeclient import \
    FakeKubeClient as JaxFakeKube
from k8s_dra_driver_gpu_tpu.pkg.partition import engine as jax_engine
from k8s_dra_driver_gpu_tpu.tpulib.binding import (
    EnumerateOptions as JaxOpts, PyTpuLib)
from k8s_dra_driver_gpu_tpu_torch.api.decode import API_VERSION as PT_API
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import driver as pt_driver
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.checkpoint import (
    CheckpointedClaim, CheckpointedDevice)
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import ResourceClaim
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.deviceinfo import (
    MIB, AllocatableDevice, DeviceKind, SubSliceInfo)
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.partitions import \
    consumed_counters
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.subslice import \
    SubSliceLiveTuple
from k8s_dra_driver_gpu_tpu_torch.pkg import partition as pt_partition
from k8s_dra_driver_gpu_tpu_torch.pkg import statemachine as pt_sm
from k8s_dra_driver_gpu_tpu_torch.pkg.kubeclient import FakeKubeClient
from k8s_dra_driver_gpu_tpu_torch.pkg.partition import engine as pt_engine
from k8s_dra_driver_gpu_tpu_torch.tpulib.binding import (EnumerateOptions,
                                                         NvmlError, PyGpuLib)
from tests.fake_kube import make_claim, make_claim_dict, opaque
from tests.test_torch_kubeletplugin_device_state import write_mig_caps
from tests.test_torch_kubeletplugin_sharing import (fake_daemon_pids,
                                                    kill_fake_daemons,
                                                    write_fake_binaries)

GATES = ("DynamicSubSlice=true,TimeSlicingSettings=true,"
         "MultiTenancySupport=true,TenantPartitioning=true")
# The gates of a plugin restarted with TenantPartitioning off.
NO_ENGINE = {"jax": "DynamicSubSlice=true,TimeSlicingSettings=true,"
             "MultiTenancySupport=true",
             "pt": "DynamicSubSlice=true,TimeSlicingSettings=true,"
             "MultiTenancySupport=true"}
BOOT = "boot-0"
# A JAX carve-out of one chip <-> an H100 MIG profile of one GPU.
SUBSLICE = {"jax": "1x1", "pt": "7g.80gb"}
PKG = {"jax": jax_partition, "pt": pt_partition}


def pset(side: str, slots: int = 2, fraction: float = 1.0,
         name: str = "serv", subslice: str | None = None, pools=()):
    pkg = PKG[side]
    return pkg.PartitionSet(profiles=(pkg.PartitionProfile(
        name=name, subslice=subslice or SUBSLICE[side], max_tenants=slots,
        hbm_fraction=fraction),), pools=tuple(pools))


def neutral(name: str) -> str:
    """A JAX device name in the port's terms."""
    if name.startswith("chip-"):
        return "gpu-" + name[len("chip-"):]
    if name.startswith("ss-1x1-"):
        return f"gpu-{name[len('ss-1x1-'):]}-mig-7g80gb-0"
    return name


def reason(err: Exception) -> str:
    """Why a step was refused, in words both plugins' messages share."""
    msg = str(err)
    for key, token in (("no free tenant slot", "slot-cap"),
                       ("overlaps", "overlap"),
                       ("mixes oversubscribed", "mixed"),
                       ("oversubscribe", "opt-in"),
                       ("unknown partition", "retired"),
                       ("partition engine not enabled", "no-engine"),
                       ("partition.create", "create-failed"),
                       ("nvmlDeviceCreateGpuInstance", "create-failed"),
                       ("partition.destroy", "destroy-failed"),
                       ("destroying MIG instance", "destroy-failed"),
                       ("re-plan changes", "reshape")):
        if key in msg:
            return token
    return f"{type(err).__name__}: {msg}"


class Side:
    """One plugin under test with its partition set."""

    def __init__(self, name: str, root: str, driver_root: str | None,
                 slots: int = 2, fraction: float = 1.0):
        self.name, self.root, self.driver_root = name, root, driver_root
        self.set = pset(name, slots, fraction)
        self.gates = GATES
        if name == "pt":
            write_mig_caps(root, gpus=4)
        self.state = self.new_state()
        self.gced = False

    def new_state(self):
        if self.name == "jax":
            cfg = jax_ds.Config.mock(root=self.root, topology="v5e-4",
                                     gates=self.gates,
                                     partition_set=self.set)
            cfg.boot_id = BOOT
            return jax_ds.DeviceState(cfg)
        cfg = pt_ds.Config.mock(self.root, "h100-4", self.gates,
                                mig_mode="enabled", partition_set=self.set)
        cfg.boot_id = BOOT
        cfg.driver_root = self.driver_root
        return pt_ds.DeviceState(cfg)

    def claim(self, uid: str, devices, over: bool = False):
        if self.name == "jax":
            configs = [{"parameters": opaque("SubSliceConfig",
                                             oversubscribe=True)}] \
                if over else None
            return make_claim(uid, devices, configs=configs)
        configs = [{"parameters": {"apiVersion": PT_API,
                                   "kind": "MigDeviceConfig",
                                   "oversubscribe": True}}] if over else None
        return ResourceClaim.from_dict(make_claim_dict(
            uid, [neutral(d) for d in devices], driver=DRIVER_NAME,
            request="gpu", configs=configs))

    # -- the faults -------------------------------------------------------

    def arm(self, point: str) -> None:
        """Fail the next MIG create or destroy once."""
        if self.name == "jax":
            faults.arm(f"partition.{point}", mode="error", count=1)
            return
        lib = self.state._lib
        real = getattr(lib, f"{point}_mig")

        def once(*args, **kw):
            setattr(lib, f"{point}_mig", real)
            raise NvmlError(
                "nvmlDeviceCreateGpuInstanceWithPlacement failed: Insufficient "
                "Resources" if point == "create" else
                "nvmlGpuInstanceDestroy failed: In use by another client", 23)
        setattr(lib, f"{point}_mig", once)

    def disarm(self) -> None:
        if self.name == "jax":
            faults.reset()

    # -- the steps ----------------------------------------------------------

    def step(self, op, *args):
        try:
            return ("ok", getattr(self, "do_" + op)(*args))
        except Exception as e:  # noqa: BLE001 - the outcome compared
            return ("refused", reason(e))
        finally:
            self.disarm()

    def do_prepare(self, uid, devices, over=False):
        return len(set(self.state.prepare(self.claim(uid, devices, over))))

    def do_unprepare(self, uid):
        self.state.unprepare(uid)

    def do_crash_create(self, uid, devices, over=False):
        self.arm("create")
        return self.do_prepare(uid, devices, over)

    def do_crash_destroy(self, uid):
        self.arm("destroy")
        self.do_unprepare(uid)

    def do_restart(self, gates=None):
        self.gates = NO_ENGINE[self.name] if gates == "no-engine" else GATES
        self.state = self.new_state()

    def do_apply(self, slots, fraction=1.0, name="serv"):
        self.set = pset(self.name, slots, fraction, name)
        self.state.apply_partition_set(self.set)
        return self.partitions()

    def do_prune(self):
        return self.state.prune_retired_partitions()

    def do_reap(self):
        return self.state.partition_engine.reap_idle()

    def do_gc(self, uid):
        """The claim's record goes without an unprepare (the stale-claim
        GC of a node whose unprepare never came)."""
        self.state._checkpoint.update_claim(uid, None)
        self.gced = True

    def do_prewarm(self, counts, max_total=None):
        engine = self.state.partition_engine
        created = engine.set_prewarm(counts, max_total=max_total)
        desired, idle = engine.prewarm_state()
        return created, sorted(desired), sorted(idle)

    # -- what is compared ---------------------------------------------------

    def partitions(self) -> list[str]:
        kind = JaxKind.PARTITION if self.name == "jax" \
            else DeviceKind.PARTITION
        return sorted(n for n, d in self.state.allocatable.items()
                      if d.kind == kind)

    def instances(self) -> int:
        st = self.state
        if self.name == "jax":
            return len(st.subslice_registry.list())
        ours = st.mig_registry()
        lib = PyGpuLib()
        lib.enumerate(st._config.gpulib_opts)
        walked = {i.uuid for g in range(4) for i in lib.mig_instances(g)}
        # What the registry names is what NVML holds.
        assert set(ours) == walked
        return len(ours)

    def snapshot(self) -> dict:
        st = self.state
        engine = st.partition_engine
        claims = st.prepared_claims()
        holders: dict[str, int] = {}
        for c in claims.values():
            for d in c.devices:
                if d.canonical_name.startswith("pt-"):
                    holders[d.canonical_name] = \
                        holders.get(d.canonical_name, 0) + 1
        if self.name == "jax":
            capped = {d.canonical_name for uid, c in claims.items()
                      for d in c.devices
                      if d.canonical_name.startswith("pt-")
                      and st._tenancy.active(uid)}
        else:
            capped = {name for name in holders
                      if st._tenancy.partition_active(name)}
        if engine is not None:
            # Caps count where the instance is live (a Ready record): the
            # port's MPS daemon quits before NVML destroys the instance it
            # holds, the JAX tenancy dirs go with the claims' unprepare.
            capped &= {name for name, rec in engine._checkpoint.get()
                       .claims.items() if rec.state == "PartitionReady"}
        slices = {}
        for i in range(4):
            doc = st._timeslicing.current(i)
            if doc is None:
                continue
            if self.name == "pt" and not self.gced:
                # The port leaves no holder behind.
                assert set(doc["holders"]) <= set(claims), doc
            # With the engine gone, the JAX plugin finds no chip for a
            # partition that is no longer allocatable and keeps its
            # tenant's holder: compare the holders still claimed.
            held = sorted(h for h in doc["holders"] if h in claims)
            if held:
                slices[i] = held
        return {
            "claims": {uid: c.state for uid, c in claims.items()},
            "instances": self.instances(),
            "records": None if engine is None else {
                name: rec.state
                for name, rec in engine._checkpoint.get().claims.items()},
            "active": None if engine is None else engine.active_partitions(),
            "holders": holders,
            "capped": sorted(capped),
            "timeslice": slices,
            "partitions": self.partitions(),
        }


@pytest.fixture()
def sides(tmp_path):
    """make(slots, fraction) -> {"jax": Side, "pt": Side}."""
    made = []
    driver_root = write_fake_binaries(tmp_path / "driver")

    def make(slots=2, fraction=1.0):
        n = len(made)
        pair = {name: Side(name, str(tmp_path / f"{name}{n}"),
                           driver_root if name == "pt" else None,
                           slots, fraction)
                for name in ("jax", "pt")}
        made.append(pair)
        return pair
    yield make
    faults.reset()
    assert kill_fake_daemons(driver_root) == [], "an MPS daemon was left"


def run_steps(pair, steps):
    for i, step in enumerate(steps):
        got = {name: side.step(*step) for name, side in pair.items()}
        assert got["pt"] == got["jax"], (i, step, got)
        snaps = {name: side.snapshot() for name, side in pair.items()}
        assert snaps["pt"] == snaps["jax"], (i, step, snaps)
    return got


T = ("pt-serv-0",)
SCENARIOS = {
    # TestDeviceStateLifecycle, tests/test_partition.py:360-620.
    "co-tenants share one instance": (2, 1.0, [
        ("prepare", "t1", T, True), ("prepare", "t2", T, True),
        ("unprepare", "t1"), ("unprepare", "t2")]),
    "the slot cap": (2, 1.0, [
        ("prepare", "t1", T, True), ("prepare", "t2", T, True),
        ("prepare", "t3", T, True), ("unprepare", "t1"),
        ("prepare", "t3", T, True), ("unprepare", "t2"),
        ("unprepare", "t3")]),
    "a partition excludes other devices on its slots": (2, 1.0, [
        ("prepare", "t1", T, True), ("prepare", "c0", ("chip-0",)),
        ("prepare", "c1", ("chip-1",)),
        ("prepare", "t2", ("pt-serv-1",), True),
        ("prepare", "s0", ("ss-1x1-0",)), ("unprepare", "t1"),
        ("prepare", "c0", ("chip-0",)), ("unprepare", "c0"),
        ("unprepare", "c1")]),
    "oversubscribe needs the opt-in": (2, 1.0, [
        ("prepare", "t1", T), ("prepare", "t1", T, True),
        ("unprepare", "t1")]),
    "an exclusive partition needs no opt-in": (1, 0.5, [
        ("prepare", "t1", T), ("prepare", "t2", T), ("unprepare", "t1"),
        ("prepare", "t2", T), ("unprepare", "t2")]),
    "restart resumes holders and reaps idle": (2, 1.0, [
        ("prepare", "t1", T, True), ("restart",), ("unprepare", "t1"),
        ("restart",)]),
    "crash mid-create resumes": (2, 1.0, [
        ("crash_create", "t1", T, True), ("prepare", "t1", T, True),
        ("restart",), ("unprepare", "t1")]),
    "crash mid-destroy resumes": (2, 1.0, [
        ("prepare", "t1", T, True), ("crash_destroy", "t1"),
        ("unprepare", "t1"), ("restart",)]),
    "an orphan Creating record is reaped at restart": (2, 1.0, [
        ("crash_create", "t1", T, True), ("restart",)]),
    "crash mid-destroy settled by a restart": (2, 1.0, [
        ("prepare", "t1", T, True), ("crash_destroy", "t1"),
        ("restart",), ("unprepare", "t1")]),
    "a re-plan": (2, 1.0, [
        ("apply", 4, 1.0, "dense"), ("prepare", "t1", ("pt-dense-0",), True),
        ("apply", 4, 1.0, "dense"), ("unprepare", "t1")]),
    "a re-plan keeps held devices visible": (2, 1.0, [
        ("prepare", "t1", T, True), ("apply", 4, 1.0, "dense"),
        ("prepare", "c0", ("chip-0",)), ("prepare", "t2", T, True),
        ("prune",), ("unprepare", "t1"), ("prune",),
        ("prepare", "c0", ("chip-0",)), ("unprepare", "c0")]),
    "a mixed request is refused": (2, 1.0, [
        ("prepare", "mix", ("pt-serv-0", "ss-1x1-1"), True),
        ("prepare", "t1", T, True), ("unprepare", "t1")]),
    "the engine gone, rollback is holder-counted": (2, 1.0, [
        ("prepare", "t1", T, True), ("prepare", "t2", T, True),
        ("restart", "no-engine"), ("unprepare", "t1"), ("unprepare", "t2"),
        ("restart",)]),
    "the sweep reaps what a GC left": (2, 1.0, [
        ("prepare", "t1", T, True), ("reap",), ("gc", "t1"), ("reap",)]),
    # Pre-warming, tests/test_powersched.py:486-520.
    "prewarm: set, and skipped by the reap": (2, 1.0, [
        ("prewarm", {"serv": 2}), ("reap",),
        ("prepare", "t1", T, True), ("unprepare", "t1"), ("reap",),
        ("prewarm", {}), ("reap",)]),
    "prewarm: idempotent and bounded": (2, 1.0, [
        ("prewarm", {"serv": 3}, 2), ("prewarm", {"serv": 3}, 2),
        ("prewarm", {"serv": 1}, 2), ("reap",), ("prewarm", {}),
        ("reap",)]),
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_scenario_step_by_step_as_the_jax_plugin(sides, scenario):
    slots, fraction, steps = SCENARIOS[scenario]
    pair = sides(slots, fraction)
    run_steps(pair, steps)
    # Every scenario ends with nothing but warm instances held.
    for side in pair.values():
        if side.state.partition_engine is not None:
            side.state.partition_engine.set_prewarm({})
            side.state.partition_engine.reap_idle()
        for uid in list(side.state.prepared_claims()):
            side.state.unprepare(uid)
        assert side.instances() == 0


def test_devices_enumerated_behind_the_gate(sides):
    pair = sides()
    assert pair["pt"].partitions() == pair["jax"].partitions() == [
        f"pt-serv-{k}" for k in range(4)]
    for side in pair.values():
        side.gates = NO_ENGINE[side.name]
        side.state = side.new_state()
        assert side.state.partition_engine is None
        assert side.partitions() == []


def test_env_and_sharing_contract(sides):
    """Each tenant's spec names its partition and budget; the JAX
    tenancy ceiling is the port's MPS pinned limit; the GPU's timeslice
    record is holder-counted across co-tenants."""
    pair = sides()
    budgets = {}
    for name, side in pair.items():
        side.state.prepare(side.claim("t1", T, True))
        spec = side.state._cdi.read_spec("t1")
        env = spec["devices"][0]["containerEdits"]["env"]
        assert "TPU_PARTITION=serv" in env
        dev = side.state.allocatable["pt-serv-0"]
        cap = dev.to_dra_device()["capacity"]
        budget = int(cap["hbmBytes" if name == "jax" else "memory"]["value"])
        assert f"TPU_PARTITION_HBM_BYTES={budget}" in env
        budgets[name] = budget
        if name == "jax":
            assert f"TPU_HBM_LIMIT_BYTES={budget}" in \
                spec["containerEdits"]["env"]
        else:
            assert budget % MIB == 0
            assert f"CUDA_MPS_PINNED_DEVICE_MEM_LIMIT=0={budget // MIB}M" \
                in env
            assert any(e.startswith("CUDA_MPS_PIPE_DIRECTORY=") for e in env)
    # Same share of the instance: half of it, on both.
    assert budgets["jax"] == 16 * (1 << 30) // 2
    mig = pair["pt"].state.allocatable["pt-serv-0"].partition.mig
    assert budgets["pt"] == mig.hbm_bytes // 2 // MIB * MIB
    run_steps(pair, [("prepare", "t2", T, True), ("unprepare", "t1"),
                     ("unprepare", "t2")])


def test_cdi_ids_are_claim_scoped_for_shared_devices(sides):
    pair = sides()
    for side in pair.values():
        i1 = side.state.prepare(side.claim("t1", T, True))
        i2 = side.state.prepare(side.claim("t2", T, True))
        assert i1 != i2 and len(set(i1 + i2)) == 2
        side.state.unprepare("t1")
        side.state.unprepare("t2")


# -- the spec -----------------------------------------------------------------


@pytest.mark.parametrize("fields", [
    dict(name="Bad Name"), dict(subslice="banana"), dict(max_tenants=0),
    dict(hbm_fraction=1.5), dict(hbm_fraction=0.0),
    dict(name="serv-8", max_tenants=8, hbm_fraction=0.5),
    dict(name="p"),
], ids=["name", "subslice", "tenants", "fraction>1", "fraction0", "ok",
        "ok-short"])
def test_profile_validation_as_the_reference(fields):
    outcomes = {}
    for side, pkg in PKG.items():
        kw = dict(name="p", subslice=SUBSLICE[side])
        kw.update(fields)
        try:
            pkg.PartitionProfile(**kw).validate()
            outcomes[side] = "ok"
        except pkg.PartitionSpecError:
            outcomes[side] = "refused"
    assert outcomes["pt"] == outcomes["jax"]


def test_a_profile_names_a_mig_profile_not_a_tpu_carve_out():
    with pytest.raises(pt_partition.PartitionSpecError, match="MIG"):
        pt_partition.PartitionProfile(name="p", subslice="1x1").validate()
    pt_partition.PartitionProfile(name="p", subslice="1g.10gb").validate()


def test_duplicate_profile_names_refused():
    for side, pkg in PKG.items():
        ps = pkg.PartitionSet(profiles=(
            pkg.PartitionProfile(name="a", subslice=SUBSLICE[side]),
            pkg.PartitionProfile(name="a", subslice=SUBSLICE[side])))
        with pytest.raises(pkg.PartitionSpecError):
            ps.validate()


def test_file_round_trip_and_pool_globs(tmp_path):
    for side, pkg in PKG.items():
        path = str(tmp_path / f"{side}.json")
        ps = pset(side, slots=4, fraction=0.5, pools=("pool-*",))
        with open(path, "w", encoding="utf-8") as f:
            json.dump(ps.to_dict(), f)
        loaded = pkg.PartitionSet.from_file(path)
        assert loaded == ps
        assert loaded.applies_to_pool("pool-7")
        assert not loaded.applies_to_pool("edge-1")
        with pytest.raises(pkg.PartitionSpecError):
            pkg.PartitionSet.from_file(str(tmp_path / "missing.json"))
    # The file form is the JAX one, key for key.
    assert set(pset("pt").to_dict()) == set(pset("jax").to_dict())
    assert set(pset("pt").to_dict()["profiles"][0]) == \
        set(pset("jax").to_dict()["profiles"][0])


def test_device_name_round_trip_as_the_reference():
    for pkg in PKG.values():
        name = pkg.partition_device_name("serv-small", 3)
        assert name == "pt-serv-small-3"
        assert pkg.parse_partition_device_name(name) == ("serv-small", 3)
        assert pkg.parse_partition_device_name("chip-0") is None
        assert pkg.parse_partition_device_name("gpu-0") is None


# -- the projection -----------------------------------------------------------


def hosts():
    jlib, jopts = PyTpuLib(), JaxOpts(mock_topology="v5e-4")
    plib = PyGpuLib()
    popts = EnumerateOptions(mock_topology="h100-4", mock_mig_mode="enabled")
    return {"jax": (jlib.enumerate(jopts), jlib.subslice_profiles(jopts)),
            "pt": (plib.enumerate(popts), plib.subslice_profiles(popts))}


ENGINES = {"jax": jax_engine, "pt": pt_engine}


def test_projection_names_attributes_and_counters():
    h = hosts()
    devs = {side: ENGINES[side].partition_devices(
        *h[side], pset(side, slots=4, fraction=0.5)) for side in h}
    assert sorted(devs["pt"]) == sorted(devs["jax"]) == [
        f"pt-serv-{k}" for k in range(4)]
    entries = {side: devs[side]["pt-serv-0"].to_dra_device() for side in h}
    for key in ("oversubscribeSlots", "partition", "profile", "subslice",
                "placement"):
        assert key in entries["pt"]["attributes"]
    assert entries["pt"]["attributes"]["oversubscribeSlots"] == \
        entries["jax"]["attributes"]["oversubscribeSlots"] == {"int": 4}
    assert entries["pt"]["attributes"]["partition"] == {"bool": True}
    # Per-tenant budget: the instance x 0.5 / 4, whole MiB.
    prof = {p.name: p for p in h["pt"][1]}["7g.80gb"]
    assert entries["pt"]["capacity"]["memory"] == {
        "value": str(int(prof.hbm_bytes * 0.5) // 4 // MIB * MIB)}
    assert entries["pt"]["capacity"]["multiprocessors"] == {
        "value": str(prof.cores // 4)}
    jax_counters = jax_consumed(devs["jax"]["pt-serv-0"],
                                h["jax"][0])[0]["counters"]
    pt_counters = consumed_counters(devs["pt"]["pt-serv-0"],
                                    h["pt"][1])[0]["counters"]
    # A tenant slot's share of each slot of the placement: 250m on both.
    assert jax_counters["core-0-0"] == {"value": "250m"}
    assert {pt_counters[f"memory-slice-{k}"]["value"]
            for k in range(8)} == {"250m"}
    assert pt_counters["memory"] == entries["pt"]["capacity"]["memory"]


@pytest.mark.parametrize("fraction", [1.0, 0.9, 0.5])
def test_an_exclusive_partition_consumes_what_its_mig_device_does(fraction):
    h = hosts()
    dev = pt_engine.partition_devices(*h["pt"], pset("pt", slots=1,
                                                     fraction=fraction))
    info = dev["pt-serv-0"].partition
    as_mig = AllocatableDevice(kind=DeviceKind.SUBSLICE_DYNAMIC,
                               subslice=SubSliceInfo(
                                   spec=info.spec, profile=info.mig,
                                   chip=info.chip, dynamic=True))
    assert consumed_counters(dev["pt-serv-0"], h["pt"][1]) == \
        consumed_counters(as_mig, h["pt"][1])


@pytest.mark.parametrize("slots", [1, 2, 3, 4, 7, 8])
@pytest.mark.parametrize("profile", ["1g.10gb", "3g.40gb", "7g.80gb"])
def test_slot_counters_never_sum_past_the_instance(slots, profile):
    host, profiles = hosts()["pt"]
    mig = {p.name: p for p in profiles}[profile]
    for fraction in (1.0, 0.9, 0.5, 0.33):
        devs = pt_engine.partition_devices(
            host, profiles, pset("pt", slots, fraction, subslice=profile))
        counters = consumed_counters(devs["pt-serv-0"],
                                     profiles)[0]["counters"]
        for k in devs["pt-serv-0"].partition.spec.memory_slices:
            value = counters[f"memory-slice-{k}"]["value"]
            milli = int(value[:-1]) if value.endswith("m") \
                else int(value) * 1000
            assert milli * slots <= 1000
        memory = int(counters["memory"]["value"])
        assert memory % MIB == 0
        assert memory * slots <= mig.hbm_bytes
        if slots > 1:  # a tenant's budget; an exclusive one holds it all
            assert memory * slots <= mig.hbm_bytes * fraction
        assert int(counters["multiprocessors"]["value"]) * slots <= mig.cores


@pytest.mark.parametrize("fraction", [1.0, 0.9, 0.75, 0.5, 0.3, 0.01])
@pytest.mark.parametrize("slots", [1, 2, 3, 5, 7])
def test_the_tenant_budget_is_whole_mib(fraction, slots):
    host, profiles = hosts()["pt"]
    for mig in profiles:
        devs = pt_engine.partition_devices(
            host, profiles, pset("pt", slots, fraction, subslice=mig.name))
        budget = devs["pt-serv-0"].partition.tenant_memory_bytes
        assert budget % MIB == 0 and budget > 0
        exact = int(mig.hbm_bytes * fraction) // slots
        assert exact - MIB < budget <= exact


def test_pool_globs_filter_as_the_reference():
    h = hosts()
    for side in h:
        ps = pset(side, pools=("serving-*",))
        assert ENGINES[side].partition_devices(*h[side], ps,
                                               pool="batch-1") == {}
        assert len(ENGINES[side].partition_devices(
            *h[side], ps, pool="serving-1")) == 4


def test_an_unknown_backing_profile_fails_loudly():
    h = hosts()
    for side, sub in (("jax", "9x9"), ("pt", "9g.90gb")):
        with pytest.raises(PKG[side].PartitionSpecError):
            ENGINES[side].resolve_partition_set(
                *h[side], pset(side, subslice=sub))
    # MIG off offers no profile: construction names it.
    popts = EnumerateOptions(mock_topology="h100-4")
    lib = PyGpuLib()
    with pytest.raises(pt_partition.PartitionSpecError,
                       match=r"'1g.10gb' is no carve-out of this host"):
        pt_engine.resolve_partition_set(lib.enumerate(popts), (),
                                        pset("pt", subslice="1g.10gb"))


def test_mig_off_refuses_the_set_at_construction(tmp_path):
    cfg = pt_ds.Config.mock(str(tmp_path), "h100-1", GATES,
                            partition_set=pset("pt", subslice="1g.10gb"))
    with pytest.raises(pt_partition.PartitionSpecError, match="1g.10gb"):
        pt_ds.DeviceState(cfg)
    # A set whose pools match no node publishes nothing, MIG off or on.
    cfg = pt_ds.Config.mock(str(tmp_path), "h100-1", GATES,
                            partition_set=pset("pt", subslice="1g.10gb",
                                               pools=("no-such-*",)))
    cfg.pool_name = "node-0"
    st = pt_ds.DeviceState(cfg)
    assert not any(d.kind == DeviceKind.PARTITION
                   for d in st.allocatable.values())


def test_catalog_is_the_published_budget():
    host, profiles = hosts()["pt"]
    ps = pt_partition.PartitionSet(profiles=(
        pt_partition.PartitionProfile("a", "1g.10gb", 2, 0.9),
        pt_partition.PartitionProfile("b", "3g.40gb")))
    cat = pt_engine.catalog_for(host, profiles, ps)
    assert [p.name for p, _ in cat] == ["a", "b"]
    devs = pt_engine.partition_devices(host, profiles, ps)
    assert cat[0][1] == devs["pt-a-0"].partition


# -- the policy ---------------------------------------------------------------

STATES = (None, "PartitionCreating", "PartitionReady", "PartitionDestroying")


@pytest.mark.parametrize("old", STATES)
@pytest.mark.parametrize("new", STATES)
def test_partition_policy_as_the_reference(old, new):
    assert pt_sm.PARTITION_POLICY.is_legal(old, new) == \
        jax_sm.PARTITION_POLICY.is_legal(old, new)


def test_ready_cannot_vanish_without_destroy_intent():
    with pytest.raises(pt_sm.CheckpointTransitionError):
        pt_sm.PARTITION_POLICY.validate("p", pt_sm.PARTITION_READY, None)
    with pytest.raises(pt_sm.CheckpointTransitionError):
        pt_sm.PARTITION_POLICY.validate("p", None, pt_sm.PARTITION_READY)


# -- publishing ---------------------------------------------------------------


@pytest.fixture()
def drivers(tmp_path):
    driver_root = write_fake_binaries(tmp_path / "driver")
    jcfg = jax_ds.Config.mock(root=str(tmp_path / "jax"), topology="v5e-4",
                              gates=GATES, partition_set=pset("jax"))
    write_mig_caps(str(tmp_path / "pt"), gpus=4)
    pcfg = pt_ds.Config.mock(str(tmp_path / "pt"), "h100-4", GATES,
                             mig_mode="enabled", partition_set=pset("pt"))
    pcfg.driver_root = driver_root
    out = {"jax": jax_driver.Driver(jcfg, JaxFakeKube(), node_name="node-a",
                                    enable_health_monitor=False,
                                    publication_mode="split"),
           "pt": pt_driver.Driver(pcfg, FakeKubeClient(), node_name="node-a",
                                  enable_health_monitor=False,
                                  publication_mode="split")}
    for d in out.values():
        d.publish_resources()
    yield out
    for d in out.values():
        d.stop()
    kill_fake_daemons(driver_root)


def _partition_slice(driver):
    slices = driver.kube.list("resource.k8s.io", "v1", "resourceslices")
    return {s["metadata"]["name"].rsplit("-", 1)[-1]: s for s in slices}


def test_partitions_published_in_their_slice(drivers):
    by = {side: _partition_slice(d) for side, d in drivers.items()}
    names = {side: sorted(e["name"] for e in s["partitions"]["spec"]
                          ["devices"] if e["name"].startswith("pt-"))
             for side, s in by.items()}
    assert names["pt"] == names["jax"] == [f"pt-serv-{k}" for k in range(4)]
    # The port's partition slice holds partitions only.
    assert {e["name"][:3] for e in by["pt"]["partitions"]["spec"]
            ["devices"]} == {"pt-"}
    entry = next(e for e in by["pt"]["partitions"]["spec"]["devices"]
                 if e["name"] == "pt-serv-0")
    counters = entry["consumesCounters"][0]["counters"]
    assert counters["memory-slice-0"] == {"value": "500m"}
    jentry = next(e for e in by["jax"]["partitions"]["spec"]["devices"]
                  if e["name"] == "pt-serv-0")
    assert jentry["consumesCounters"][0]["counters"]["core-0-0"] == \
        {"value": "500m"}
    # Every slice of the pool counts all of them.
    counts = {s["spec"]["pool"]["resourceSliceCount"]
              for s in by["pt"].values()}
    assert counts == {len(by["pt"])} == {3}


def test_converged_republish_writes_nothing(drivers):
    for d in drivers.values():
        stats = d.publish_resources()
        assert stats["writes"] == 0 and stats["skipped"] >= 1


def test_replan_republishes_only_changed_inventory(drivers):
    for side, d in drivers.items():
        stats = d.apply_partition_set(pset(side, slots=4, name="dense"))
        assert stats["writes"] >= 1
        assert d.apply_partition_set(
            pset(side, slots=4, name="dense"))["writes"] == 0
        slices = d.kube.list("resource.k8s.io", "v1", "resourceslices")
        names = [e["name"] for s in slices for e in s["spec"]["devices"]]
        assert "pt-dense-0" in names and "pt-serv-0" not in names


# -- what only the port has ---------------------------------------------------


def port_state(tmp_path, ps=None, gates=GATES, topology="h100-2"):
    root = tmp_path / "pt"
    driver_root = write_fake_binaries(tmp_path / "driver")
    write_mig_caps(str(root), gpus=4)
    cfg = pt_ds.Config.mock(str(root), topology, gates, mig_mode="enabled",
                            partition_set=ps or pt_partition.PartitionSet(
                                profiles=(pt_partition.PartitionProfile(
                                    "x1", "1g.10gb"),
                                          pt_partition.PartitionProfile(
                                              "s2", "1g.10gb", 2, 0.9))))
    cfg.boot_id = BOOT
    cfg.driver_root = driver_root
    return cfg, pt_ds.DeviceState(cfg)


@pytest.fixture()
def port(tmp_path):
    made = []

    def make(**kw):
        cfg, st = port_state(tmp_path, **kw)
        made.append(cfg.driver_root)
        return cfg, st
    yield make
    for root in made:
        assert kill_fake_daemons(root) == [], "an MPS daemon was left"


def pclaim(uid, devices, over=False):
    configs = [{"parameters": {"apiVersion": PT_API,
                               "kind": "MigDeviceConfig",
                               "oversubscribe": True}}] if over else None
    return ResourceClaim.from_dict(make_claim_dict(
        uid, list(devices), driver=DRIVER_NAME, request="gpu",
        configs=configs))


def walk(st):
    lib = PyGpuLib()
    lib.enumerate(st._config.gpulib_opts)
    return [i for g in range(len(st.host.chips))
            for i in lib.mig_instances(g)]


def test_one_mps_daemon_a_partition_over_its_mig_uuid(port):
    cfg, st = port()
    st.prepare(pclaim("t1", ["pt-s2-3"], True))
    st.prepare(pclaim("t2", ["pt-s2-3"], True))
    (inst,) = walk(st)
    assert (inst.gpu, inst.profile, inst.start) == (0, "1g.10gb", 3)
    pids = fake_daemon_pids(cfg.driver_root)
    assert len(pids) == 1
    with open(f"/proc/{pids[0]}/environ", "rb") as f:
        env = dict(kv.split(b"=", 1) for kv in f.read().split(b"\0") if kv)
    assert env[b"CUDA_VISIBLE_DEVICES"].decode() == inst.uuid
    budget = st.allocatable["pt-s2-3"].partition.tenant_memory_bytes
    assert budget == int(10240 * MIB * 0.9) // 2 // MIB * MIB
    for uid in ("t1", "t2"):
        env = st._cdi.read_spec(uid)["devices"][0]["containerEdits"]["env"]
        assert f"CUDA_MPS_PINNED_DEVICE_MEM_LIMIT=0={budget // MIB}M" in env
    # The daemon's default limit is the same budget.
    owner = json.load(open(os.path.join(
        st._tenancy._partition_dir("pt-s2-3"), "claim.json")))
    assert owner["pinnedMemLimits"] == {"0": f"{budget // MIB}M"}
    st.unprepare("t1")
    assert st._tenancy.partition_active("pt-s2-3") and len(walk(st)) == 1
    st.unprepare("t2")
    assert not st._tenancy.partition_active("pt-s2-3")
    assert walk(st) == [] and st.mig_registry() == {}
    assert fake_daemon_pids(cfg.driver_root) == []


def test_a_refused_mps_daemon_rolls_back(port):
    cfg, st = port()
    open(os.path.join(cfg.driver_root, "mps.refuse"), "w").close()
    with pytest.raises(pt_ds.PrepareError, match="cannot start the daemon"):
        st.prepare(pclaim("t1", ["pt-s2-0"], True))
    assert walk(st) == [] and st.mig_registry() == {}
    assert st.partition_engine.records() == {}
    assert st.prepared_claims() == {}


def test_an_exclusive_partition_has_no_daemon(port):
    cfg, st = port()
    st.prepare(pclaim("x", ["pt-x1-0"]))
    env = st._cdi.read_spec("x")["devices"][0]["containerEdits"]["env"]
    assert "TPU_PARTITION=x1" in env
    assert not any(e.startswith("CUDA_MPS") for e in env)
    assert fake_daemon_pids(cfg.driver_root) == []
    # MPS on it runs a daemon over its instance, as on a MIG device
    # (test_torch_kubeletplugin_mig.py); a timeslice is refused.
    st.unprepare("x")


@pytest.mark.parametrize("case", ["two devices", "timeslice", "gates"])
def test_oversubscribed_refusals(port, case):
    gates = "DynamicSubSlice=true,TenantPartitioning=true" \
        if case == "gates" else GATES
    cfg, st = port(gates=gates)
    if case == "two devices":
        doc = make_claim_dict(
            "t1", ["pt-s2-0", "gpu-1"], driver=DRIVER_NAME, request="gpu",
            configs=[{"requests": ["gpu"], "parameters": {
                "apiVersion": PT_API, "kind": "MigDeviceConfig",
                "oversubscribe": True}}])
        doc["status"]["allocation"]["devices"]["results"][1][
            "request"] = "other"
        claim = ResourceClaim.from_dict(doc)
        match = "only device"
    elif case == "timeslice":
        claim = ResourceClaim.from_dict(make_claim_dict(
            "t1", ["pt-s2-0"], driver=DRIVER_NAME, request="gpu",
            configs=[{"parameters": {
                "apiVersion": PT_API, "kind": "MigDeviceConfig",
                "oversubscribe": True, "sharing": {
                    "strategy": "TimeSlicing",
                    "timeSlicing": {"interval": "Long"}}}}]))
        match = "timeslice"
    else:
        claim = pclaim("t1", ["pt-s2-0"], True)
        match = "TimeSlicingSettings and MultiTenancySupport"
    with pytest.raises(pt_ds.PrepareError, match=match):
        st.prepare(claim)
    assert walk(st) == [] and st.partition_engine.records() == {}


def test_oversubscribe_with_mps_sharing_is_invalid_as_the_reference():
    from k8s_dra_driver_gpu_tpu_torch.api.decode import strict_decode
    body = {"apiVersion": PT_API, "kind": "MigDeviceConfig",
            "oversubscribe": True, "sharing": {
                "strategy": "MultiTenancy",
                "multiTenancy": {"hbmLimit": "1Gi"}}}
    cfg = strict_decode(body)
    cfg.normalize()
    with pytest.raises(ValueError, match="oversubscribe"):
        cfg.validate()


def test_an_unnamed_instance_at_the_placement_is_never_adopted(port):
    """A crash between NVML's create and the registry write leaves an
    instance the registry does not name: the attach fails naming the
    placement, and the instance stays its admin's."""
    cfg, st = port()
    admin = st._lib.create_mig(0, "1g.10gb", 2)
    with pytest.raises(pt_ds.PrepareError,
                       match=r"gpu-0-mig-1g10gb-2 .*did not create"):
        st.prepare(pclaim("t1", ["pt-s2-2"], True))
    assert [i.uuid for i in walk(st)] == [admin.uuid]
    assert st.partition_engine.records() == {}
    assert st.prepared_claims() == {}
    # Neither resume nor the sweep touches it.
    st2 = pt_ds.DeviceState(cfg)
    assert st2.destroy_unknown_subslices() == 0
    assert [i.uuid for i in walk(st2)] == [admin.uuid]
    # Another placement is free.
    st2.prepare(pclaim("t1", ["pt-s2-3"], True))
    st2.unprepare("t1")
    assert [i.uuid for i in walk(st2)] == [admin.uuid]


def _reserve(st, uid, device):
    st._checkpoint.update_claim(uid, CheckpointedClaim(
        uid=uid, state="PrepareStarted",
        devices=[CheckpointedDevice(canonical_name=device,
                                    kind="partition")]))


def _record(st, name, state, live):
    engine = st.partition_engine
    if state == "PartitionReady":
        engine._checkpoint.update_claim(name, CheckpointedClaim(
            uid=name, state="PartitionCreating", devices=[
                CheckpointedDevice(canonical_name=name, kind="partition",
                                   live=live)]))
    if state == "PartitionDestroying":
        _record(st, name, "PartitionReady", live)
    engine._checkpoint.update_claim(name, CheckpointedClaim(
        uid=name, state=state, devices=[CheckpointedDevice(
            canonical_name=name, kind="partition", live=live)]))


@pytest.mark.parametrize("point", [
    "creating, before the create",
    "creating, instance unnamed",
    "creating, instance named",
    "creating, no tenant",
    "ready, no tenant",
    "destroying, instance live",
    "destroying, instance gone",
])
def test_every_crash_point_settles_at_construction(port, point):
    """The durable state a crash leaves at each point of the lifecycle,
    and what a fresh DeviceState makes of it."""
    cfg, st = port()
    name = "pt-s2-1"
    spec = st.allocatable[name].partition.spec
    pin = {"partition": name, "spec": spec.canonical_name()}
    if "no tenant" not in point:
        _reserve(st, "t1", name)
    inst = None
    if point == "creating, instance unnamed":
        inst = st._lib.create_mig(0, "1g.10gb", 1)
    if point in ("creating, instance named", "ready, no tenant",
                 "destroying, instance live", "destroying, instance gone"):
        inst = st._create_mig(spec, owner=name)
    state = point.split(",")[0]
    state = {"creating": "PartitionCreating", "ready": "PartitionReady",
             "destroying": "PartitionDestroying"}[state]
    live = pin if state == "PartitionCreating" else dict(
        SubSliceLiveTuple.from_dict(inst.to_dict()).to_dict(), **pin)
    _record(st, name, state, live)
    if point == "destroying, instance gone":
        st._lib.destroy_mig(inst.instance())
    st2 = pt_ds.DeviceState(cfg)
    records = st2.partition_engine.records()
    walked = walk(st2)
    if point == "creating, before the create":
        # A tenant waits on it: the create completes.
        assert records[name].state == "PartitionReady"
        (made,) = walked
        assert records[name].devices[0].live["uuid"] == made.uuid
        assert st2.mig_registry().keys() == {made.uuid}
    elif point == "creating, instance named":
        # Adopted: the same instance.
        assert records[name].state == "PartitionReady"
        assert records[name].devices[0].live["uuid"] == inst.uuid
        assert [i.uuid for i in walked] == [inst.uuid]
    elif point == "creating, instance unnamed":
        # Never adopted: the record goes, the instance stays.
        assert records == {}
        assert [i.uuid for i in walked] == [inst.uuid]
        assert st2.mig_registry() == {}
    else:
        assert records == {} and walked == [] and st2.mig_registry() == {}
    # The tenant's retry (its reservation rolled back) ends clean.
    if "no tenant" not in point:
        if point == "creating, instance unnamed":
            with pytest.raises(pt_ds.PrepareError, match="did not create"):
                st2.prepare(pclaim("t1", [name], True))
        else:
            st2.prepare(pclaim("t1", [name], True))
            st2.unprepare("t1")
    st2.unprepare("t1")
    left = [i.uuid for i in walk(st2)]
    assert left == ([inst.uuid] if point == "creating, instance unnamed"
                    else [])


def test_a_failed_registry_write_leaves_no_instance(port):
    cfg, st = port()
    with mock.patch.object(pt_ds.SubSliceRegistry, "record",
                           side_effect=OSError("disk full")):
        with pytest.raises(pt_ds.PrepareError, match="disk full"):
            st.prepare(pclaim("t1", ["pt-s2-0"], True))
    assert walk(st) == [] and st.prepared_claims() == {}
    # The Creating record waits for the sweep, as the JAX plugin's.
    assert {n: r.state for n, r in st.partition_engine.records().items()} \
        == {"pt-s2-0": "PartitionCreating"}
    assert st.partition_engine.reap_idle() == 1
    assert st.partition_engine.records() == {}


def test_the_orphan_sweep_spares_a_partition_mid_lifecycle(port):
    cfg, st = port()
    st.prepare(pclaim("t1", ["pt-s2-0"], True))
    assert st.destroy_unknown_subslices() == 0
    # A warm instance (no tenant) is its record's too.
    st.unprepare("t1")
    assert st.partition_engine.set_prewarm({"s2": 1}) == 1
    assert st.destroy_unknown_subslices() == 0 and len(walk(st)) == 1
    st.partition_engine.set_prewarm({})
    assert st.partition_engine.reap_idle() == 1 and walk(st) == []


def test_a_reshape_of_a_held_device_is_refused(port):
    cfg, st = port()
    st.prepare(pclaim("t1", ["pt-s2-0"], True))
    moved = pt_partition.PartitionSet(profiles=(
        pt_partition.PartitionProfile("s2", "1g.20gb", 2, 0.9),))
    with pytest.raises(pt_partition.PartitionSpecError, match="re-plan"):
        st.apply_partition_set(moved)
    assert "pt-x1-0" in st.allocatable  # the old plan stays
    st.unprepare("t1")
    st.apply_partition_set(moved)
    assert "pt-x1-0" not in st.allocatable
    assert st.allocatable["pt-s2-0"].partition.spec.profile == "1g.20gb"


def test_engine_ops_take_the_node_lock_and_never_race_a_prepare(port):
    """The watcher's thread re-plans, pre-warms and reaps while another
    prepares and unprepares tenants: every NVML create and destroy runs
    with the node lock held by its own thread, no placement is created
    twice, and the end state is consistent."""
    cfg, st = port()
    lib = st._lib
    seen = {"create": 0, "destroy": 0}
    live: set[tuple] = set()
    errors: list[str] = []
    real_create, real_destroy = lib.create_mig, lib.destroy_mig

    def held():
        return st.pu_lock._owner == threading.get_ident()

    def create(gpu, profile, start):
        if not held():
            errors.append("create without the node lock")
        if (gpu, start) in live:
            errors.append(f"double create at {(gpu, start)}")
        inst = real_create(gpu, profile, start)
        live.add((gpu, start))
        seen["create"] += 1
        return inst

    def destroy(inst):
        if not held():
            errors.append("destroy without the node lock")
        live.discard((inst.gpu, inst.start))
        seen["destroy"] += 1
        return real_destroy(inst)

    lib.create_mig, lib.destroy_mig = create, destroy
    plans = [pt_partition.PartitionSet(profiles=(
        pt_partition.PartitionProfile("s2", "1g.10gb", 2, 0.9),
        pt_partition.PartitionProfile(name, "1g.10gb"))) for name in
        ("x1", "y1")]
    stop = threading.Event()

    def watcher():
        k = 0
        while not stop.is_set():
            st.apply_partition_set(plans[k % 2])
            st.partition_engine.set_prewarm({"s2": 1 + k % 2})
            st.partition_engine.reap_idle()
            st.prune_retired_partitions()
            k += 1

    t = threading.Thread(target=watcher)
    t.start()
    try:
        for i in range(12):
            uid = f"t{i}"
            st.prepare(pclaim(uid, ["pt-s2-0"], True))
            st.prepare(pclaim(uid + "b", ["pt-s2-0"], True))
            st.unprepare(uid)
            st.unprepare(uid + "b")
    finally:
        stop.set()
        t.join()
    assert errors == []
    assert seen["create"] >= 1
    st.partition_engine.set_prewarm({})
    st.partition_engine.reap_idle()
    assert walk(st) == [] and st.mig_registry() == {}
    assert st.partition_engine.records() == {}


def test_the_sweep_pass_reports_idle_partitions(port):
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.reconcile import \
        NodeStateReconciler
    cfg, st = port()
    st.prepare(pclaim("t1", ["pt-s2-0"], True))
    # The tenant's record goes without an unprepare (a GC'd claim).
    st._checkpoint.update_claim("t1", None)
    kube = FakeKubeClient()
    counts = NodeStateReconciler(st, kube, "node-0").reconcile_once()
    assert counts["idle_partition"] == 1
    assert walk(st) == [] and not st._tenancy.partition_active("pt-s2-0")


# -- MISO sizing (the JAX file's TestProfileGuidedSizing) ----------------------

GIB = 1 << 30
PROFILES_MOD = {"jax": jax_partition.profiles, "pt": pt_partition.profiles}


def _both(fn):
    got = {side: fn(side) for side in ("jax", "pt")}
    assert got["pt"] == got["jax"]
    return got["pt"]


def test_store_percentiles_and_defaults():
    def one(side):
        store = PKG[side].TenantProfileStore()
        default = store.demand("serving-small").hbm_bytes
        for mb in (100, 200, 300, 400, 1000):
            store.observe("t", mb << 20)
        return (default, store.demand("t", percentile=0.5).hbm_bytes,
                store.demand("t", percentile=1.0).hbm_bytes,
                store.demand("unknown"), store.tenants())
    assert _both(one)[:4] == (2 * GIB, 300 << 20, 1000 << 20, None)


def test_window_evicts_by_arrival_so_demand_can_shrink(monkeypatch):
    def one(side):
        monkeypatch.setattr(PROFILES_MOD[side], "_MAX_SAMPLES", 8)
        store = PKG[side].TenantProfileStore(defaults={})
        for _ in range(8):
            store.observe("t", 12 * GIB)
        high = store.demand("t", percentile=0.95).hbm_bytes
        for _ in range(8):
            store.observe("t", 2 * GIB)
        return high, store.demand("t", percentile=0.95).hbm_bytes
    assert _both(one) == (12 * GIB, 2 * GIB)


def test_demand_count_is_tenant_multiplicity_not_samples():
    def one(side):
        store = PKG[side].TenantProfileStore(defaults={})
        for mb in (100, 200, 300):
            store.observe("t", mb << 20)
        return store.demand("t").count
    assert _both(one) == 1


def test_static_profile_file(tmp_path):
    path = str(tmp_path / "tenants.json")
    with open(path, "w", encoding="utf-8") as f:
        json.dump({"tenants": {"svc-a": {"hbmBytes": 3 * GIB, "cores": 2},
                               "svc-b": {"hbmBytes": GIB}}}, f)

    def one(side):
        store = PKG[side].TenantProfileStore(defaults={})
        n = store.load_file(path)
        with pytest.raises(PKG[side].PartitionSpecError):
            store.load_file(str(tmp_path / "missing.json"))
        d = store.demand("svc-a")
        return n, d.hbm_bytes, d.cores, store.to_dict()
    assert _both(one)[:3] == (2, 3 * GIB, 2)


# The same sizing question on each node: the JAX v5e chip (16 GiB, one
# core) and the port's 7g.80gb instance (80 GiB, 132 SMs), demands scaled
# to each.
SCALE = {"jax": 1, "pt": 5}
CORES = {"jax": 1, "pt": 132}


def test_sizing_picks_smallest_satisfying():
    def one(side):
        host, profiles = hosts()[side]
        sub, pt_ = SUBSLICE[side], PKG[side]
        cat = ENGINES[side].catalog_for(host, profiles, pt_.PartitionSet(
            profiles=tuple(pt_.PartitionProfile(name=f"s{n}", subslice=sub,
                                                max_tenants=n)
                           for n in (1, 2, 4, 8))))
        pick = pt_.SizingPolicy().pick
        choice = pick(pt_.PartitionDemand(hbm_bytes=3 * GIB * SCALE[side]),
                      cat)
        return (choice.profile.name,
                choice.per_tenant_hbm == 4 * GIB * SCALE[side],
                choice.per_tenant_core_milli,
                pick(pt_.PartitionDemand(hbm_bytes=64 * GIB * SCALE[side]),
                     cat),
                # Cores are a physical span: one more than the backing
                # instance has never fits, whatever the memory headroom.
                pick(pt_.PartitionDemand(hbm_bytes=GIB,
                                         cores=CORES[side] + 1), cat),
                pick(pt_.PartitionDemand(hbm_bytes=GIB, cores=CORES[side]),
                     cat).profile.name)
    assert _both(one) == ("s4", True, 250, None, None, "s8")


# -- ParvaGPU packing (the JAX file's TestPacking) -----------------------------

def _plan(side, demands, *args, **kw):
    pt_ = PKG[side]
    plan = pt_.pack_tenants([pt_.PartitionDemand(**d) for d in demands],
                            *args, **kw)
    return ([(c.index, c.capacity_hbm, c.used_hbm, c.free_hbm,
              [(t.tenant, t.hbm_bytes, t.count) for t in c.tenants])
             for c in plan.chips],
            [(t.tenant, t.hbm_bytes) for t in plan.unplaced],
            plan.chips_used, plan.tenants_placed, plan.tenants_per_chip,
            plan.waste_fraction, plan.to_dict())


def test_complementary_tenants_co_locate():
    demands = [dict(hbm_bytes=12 * GIB, tenant="big"),
               dict(hbm_bytes=4 * GIB, tenant="small"),
               dict(hbm_bytes=8 * GIB, tenant="mid")]
    chips, _, used, placed, *_ = _both(
        lambda s: _plan(s, demands, chip_hbm=16 * GIB, chips=4))
    assert (used, placed) == (2, 3)
    assert ["big", "small"] in [sorted(t[0] for t in c[4]) for c in chips]


def test_capacity_and_slot_caps_respected():
    chips, unplaced, *_ = _both(lambda s: _plan(
        s, [dict(hbm_bytes=2 * GIB, count=20, tenant="small")],
        chip_hbm=16 * GIB, chips=2, max_tenants_per_chip=4))
    assert all(c[2] <= c[1] and len(c[4]) <= 4 for c in chips)
    assert sum(len(c[4]) for c in chips) == 8 and len(unplaced) == 12


def test_packing_deterministic():
    demands = [dict(hbm_bytes=(i % 5 + 1) * GIB, count=2, tenant=f"t{i}")
               for i in range(6)]
    a = _both(lambda s: _plan(s, demands, 16 * GIB, 4))
    assert a == _plan("pt", demands, 16 * GIB, 4)


@pytest.mark.parametrize("seed", range(6))
def test_packing_seeded_as_the_reference(seed):
    """Seeded demands, caps and anomaly-avoided cards."""
    import random

    rng = random.Random(seed)
    demands = [dict(hbm_bytes=rng.randrange(1, 40) * GIB // 4,
                    count=rng.randrange(0, 4), cores=rng.randrange(1, 3),
                    tenant=f"t{rng.randrange(0, 5)}")
               for _ in range(rng.randrange(1, 12))]
    cap = rng.choice((None, 1, 3))
    avoid = set(rng.sample(range(6), rng.randrange(0, 3)))
    _both(lambda s: _plan(s, demands, 16 * GIB, 6,
                          max_tenants_per_chip=cap, avoid=avoid))
