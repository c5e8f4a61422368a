"""vfio passthrough in the port (``kubeletplugin/vfio.py`` and its use in
``DeviceState``) against the JAX plugin's, over one fake sysfs tree: the
same writes to ``driver_override``, ``unbind`` and ``bind`` in the same
order, the same registry file, the same CDI edits, the same devices
published (none without an IOMMU group, and on the port none without a
PCI bus id), and the same lifecycle, restart, crash-orphan sweep and
wrong config kind. The fake tree moves each function's ``driver`` link
on a bind or an unbind, as the kernel does.

Where the two differ by design: the port's devices are
``gpu-<i>-passthrough`` on H100 PCI addresses, its config kind is
``VfioDeviceConfig`` (the JAX ``PassthroughConfig``), its capacity is
``memory`` (``hbmBytes``), a function with no recorded driver goes back
to ``nvidia`` (``tpu``), and a completed claim whose spec is lost while
its GPU is bound to vfio-pci raises at prepare (the JAX plugin logs and
returns the old ids).
"""

import ctypes
import dataclasses
import json
import os

import pytest

from k8s_dra_driver_gpu_tpu.api.configs import PassthroughConfig
from k8s_dra_driver_gpu_tpu.kubeletplugin import device_state as jax_ds
from k8s_dra_driver_gpu_tpu.kubeletplugin import vfio as jax_vfio
from k8s_dra_driver_gpu_tpu.kubeletplugin.partitions import \
    consumed_counters as jax_counters
from k8s_dra_driver_gpu_tpu.pkg.featuregates import FeatureGates
from k8s_dra_driver_gpu_tpu.tpulib.binding import EnumerateOptions, PyTpuLib
from k8s_dra_driver_gpu_tpu_torch.api.configs import VfioDeviceConfig
from k8s_dra_driver_gpu_tpu_torch.api.decode import API_VERSION as PT_API
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import device_state as pt_ds
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import driver as pt_driver
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import vfio as pt_vfio
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import ResourceClaim
from k8s_dra_driver_gpu_tpu_torch.pkg import kubeclient as pt_kube
from k8s_dra_driver_gpu_tpu_torch.tpulib.binding import NvmlLib
from tests.fake_kube import make_claim, make_claim_dict, opaque
from tests.test_torch_kubeletplugin_device_state import (  # noqa: F401
    BOOT, driver_root, fake_nvml)
from tests.test_torch_tpulib import BUS_IDS

JAX_BDFS = tuple(c.pci_bdf for c in PyTpuLib().enumerate(
    EnumerateOptions(mock_topology="v5e-4")).chips)
PT_BDFS = BUS_IDS  # the h100-4 mock's and the fake NVML's addresses
NATIVE = "nvidia"


class FakeSysfs:
    """A sysfs tree of PCI functions bound to ``NATIVE``, those of
    ``grouped`` in IOMMU group ``10 + i`` for the i-th function of its
    package's mock. Every write of either package's ``VfioPciManager``
    goes through it (a bind or an unbind moves the function's ``driver``
    link) and is recorded as (path from the root, value), each address
    written as ``<i>``, so the two packages' writes compare."""

    def __init__(self, root, grouped, ungrouped=(), monkeypatch=None):
        self.root = str(root)
        self.writes: list[tuple[str, str]] = []
        self._names = {}
        for lst in (JAX_BDFS, PT_BDFS):
            self._names.update({bdf: f"<{i}>" for i, bdf in enumerate(lst)})
        for cls in (jax_vfio.VfioPciManager, pt_vfio.VfioPciManager):
            monkeypatch.setattr(cls, "_write", self._hooked(cls._write))
        for drv in (NATIVE, pt_vfio.VFIO_DRIVER, "tpu"):
            d = os.path.join(self.root, "bus", "pci", "drivers", drv)
            os.makedirs(d, exist_ok=True)
            for f in ("bind", "unbind"):
                open(os.path.join(d, f), "w").close()
        for i, bdf in enumerate(list(grouped) + list(ungrouped)):
            dev = self._dev(bdf)
            os.makedirs(dev)
            open(os.path.join(dev, "driver_override"), "w").close()
            self._link(bdf, NATIVE)
            if i < len(grouped):
                group = os.path.join(self.root, "kernel", "iommu_groups",
                                     str(10 + int(self._names[bdf][1:-1])))
                os.makedirs(group, exist_ok=True)
                os.symlink(group, os.path.join(dev, "iommu_group"))

    def _dev(self, bdf):
        return os.path.join(self.root, "bus", "pci", "devices", bdf)

    def _link(self, bdf, driver):
        link = os.path.join(self._dev(bdf), "driver")
        if os.path.lexists(link):
            os.unlink(link)
        if driver:
            os.symlink(os.path.join(self.root, "bus", "pci", "drivers",
                                    driver), link)

    def driver(self, bdf):
        link = os.path.join(self._dev(bdf), "driver")
        return os.path.basename(os.readlink(link)) \
            if os.path.lexists(link) else None

    def override(self, bdf):
        with open(os.path.join(self._dev(bdf), "driver_override")) as f:
            return f.read()

    def _hooked(self, write):
        def recorded(manager, path, value):
            write(manager, path, value)
            rel = os.path.relpath(path, self.root)
            parts = rel.split(os.sep)
            if parts[:3] == ["bus", "pci", "drivers"]:
                if parts[4] == "bind":
                    self._link(value, parts[3])
                elif parts[4] == "unbind":
                    self._link(value, None)
            for bdf, name in self._names.items():
                rel, value = rel.replace(bdf, name), value.replace(bdf, name)
            self.writes.append((rel, value))
        return recorded


def managers(tmp_path, monkeypatch, registry=True):
    """Both managers over one tree, each function grouped; the tree."""
    tree = FakeSysfs(tmp_path / "sys", (JAX_BDFS[0], PT_BDFS[0]),
                     monkeypatch=monkeypatch)
    dev = str(tmp_path / "dev")
    jax = jax_vfio.VfioPciManager(
        tree.root, dev, jax_vfio.VfioRegistry(str(tmp_path / "jax"))
        if registry else None)
    pt = pt_vfio.VfioPciManager(
        tree.root, dev, pt_vfio.VfioRegistry(str(tmp_path / "pt"))
        if registry else None)
    return tree, jax, pt


# -- the manager ------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["legacy", "iommufd"])
def test_the_same_writes_edits_and_registry(tmp_path, monkeypatch, mode):
    tree, jax, pt = managers(tmp_path, monkeypatch)
    got = {}
    for side, mgr, bdf, cfg in (
            ("jax", jax, JAX_BDFS[0], PassthroughConfig(iommu_mode=mode)),
            ("pt", pt, PT_BDFS[0], VfioDeviceConfig(iommu_mode=mode))):
        tree.writes.clear()
        edits = mgr.configure(bdf, cfg)
        assert tree.driver(bdf) == pt_vfio.VFIO_DRIVER
        assert tree.override(bdf) == "vfio-pci"
        with open(os.path.join(tmp_path, side, "vfio.json")) as f:
            registry = f.read().replace(bdf, "<0>")
        configure = list(tree.writes)
        # Configuring again rebinds nothing.
        mgr.configure(bdf, cfg)
        assert tree.writes == configure
        mgr.unconfigure(bdf)
        assert tree.driver(bdf) == NATIVE and tree.override(bdf) == "\n"
        assert mgr.registry.list() == {}
        got[side] = (configure, tree.writes[len(configure):], registry,
                     edits.env, edits.device_nodes)
    assert got["pt"] == got["jax"]
    configure, unconfigure, registry, env, nodes = got["pt"]
    assert configure == [
        ("bus/pci/drivers/nvidia/unbind", "<0>"),
        ("bus/pci/devices/<0>/driver_override", "vfio-pci"),
        ("bus/pci/drivers/vfio-pci/bind", "<0>")]
    assert unconfigure == [
        ("bus/pci/drivers/vfio-pci/unbind", "<0>"),
        ("bus/pci/devices/<0>/driver_override", "\n"),
        ("bus/pci/drivers/nvidia/bind", "<0>")]
    assert json.loads(registry) == {"<0>": {"nativeDriver": "nvidia"}}
    assert env == ["TPU_VFIO_GROUP=10", f"TPU_VFIO_MODE={mode}"]
    node = "devices/vfio10" if mode == "iommufd" else "10"
    assert nodes == [str(tmp_path / "dev" / "vfio" / "vfio"),
                     str(tmp_path / "dev" / "vfio" / node)]


def test_no_iommu_group_is_refused_before_any_write(tmp_path, monkeypatch):
    tree = FakeSysfs(tmp_path / "sys", (), (JAX_BDFS[0], PT_BDFS[0]),
                     monkeypatch=monkeypatch)
    for mgr, bdf, cfg in (
            (jax_vfio.VfioPciManager(tree.root), JAX_BDFS[0],
             PassthroughConfig()),
            (pt_vfio.VfioPciManager(tree.root), PT_BDFS[0],
             VfioDeviceConfig())):
        assert mgr.iommu_group(bdf) == -1
        with pytest.raises(RuntimeError, match="no iommu group"):
            mgr.configure(bdf, cfg)
    assert tree.writes == []


def test_without_a_record_the_function_goes_back_to_its_driver(
        tmp_path, monkeypatch):
    tree, jax, pt = managers(tmp_path, monkeypatch, registry=False)
    for mgr, bdf, cfg in ((jax, JAX_BDFS[0], PassthroughConfig()),
                          (pt, PT_BDFS[0], VfioDeviceConfig())):
        mgr.configure(bdf, cfg)
        mgr.unconfigure(bdf)
    # No registry: each goes back to its package's driver.
    assert [w for w in tree.writes if w[0].endswith("/bind")
            and "vfio" not in w[0]] == [
        ("bus/pci/drivers/tpu/bind", "<0>"),
        ("bus/pci/drivers/nvidia/bind", "<0>")]


# -- DeviceState --------------------------------------------------------------------

class Sides:
    """The JAX plugin on a v5e-4 mock and the port on an h100-4 mock, both
    with ``PassthroughSupport`` over one tree (the first two functions of
    each grouped, the others not)."""

    def __init__(self, tmp_path, monkeypatch):
        self.tmp = tmp_path
        self.tree = FakeSysfs(tmp_path / "sys",
                              JAX_BDFS[:2] + PT_BDFS[:2],
                              JAX_BDFS[2:] + PT_BDFS[2:], monkeypatch)
        self.jax, self.pt = self.jax_state(), self.pt_state()

    def jax_state(self):
        st = jax_ds.DeviceState(jax_ds.Config(
            root=str(self.tmp / "jax"),
            tpulib_opts=EnumerateOptions(
                mock_topology="v5e-4", sys_root=self.tree.root,
                dev_root=str(self.tmp / "dev")),
            feature_gates=FeatureGates.parse("PassthroughSupport=true"),
            cdi_root=str(self.tmp / "jax" / "cdi"), boot_id=BOOT))
        return st

    def pt_state(self):
        cfg = pt_ds.Config.mock(str(self.tmp / "pt"), "h100-4",
                                "PassthroughSupport=true")
        cfg.gpulib_opts = dataclasses.replace(
            cfg.gpulib_opts, sys_root=self.tree.root,
            dev_root=str(self.tmp / "dev"))
        cfg.boot_id = BOOT
        return pt_ds.DeviceState(cfg)

    @staticmethod
    def claim(side, uid, index, passthrough=True, kind=None):
        if side == "jax":
            name = f"chip-{index}" + ("-passthrough" if passthrough else "")
            kind = kind or "PassthroughConfig"
            configs = [{"parameters": opaque(kind)}] if passthrough else None
            return make_claim(uid, [name], configs=configs)
        name = f"gpu-{index}" + ("-passthrough" if passthrough else "")
        kind = kind or "VfioDeviceConfig"
        configs = [{"parameters": {"apiVersion": PT_API, "kind": kind}}] \
            if passthrough else None
        return ResourceClaim.from_dict(make_claim_dict(
            uid, [name], driver=DRIVER_NAME, configs=configs))

    def both(self):
        return (("jax", self.jax, JAX_BDFS, jax_ds.PrepareError),
                ("pt", self.pt, PT_BDFS, pt_ds.PrepareError))


@pytest.fixture()
def sides(tmp_path, monkeypatch):
    return Sides(tmp_path, monkeypatch)


def test_published_only_with_an_iommu_group(sides):
    got = {}
    for side, st, _, _ in sides.both():
        devs = {n: d for n, d in st.allocatable.items()
                if n.endswith("-passthrough")}
        got[side] = [(n.split("-")[1], sorted(d.to_dra_device()[
            "attributes"])) for n, d in sorted(devs.items())]
    assert got["pt"] == got["jax"]
    assert [i for i, _ in got["pt"]] == ["0", "1"]
    attrs = sides.pt.allocatable["gpu-1-passthrough"].to_dra_device()
    assert attrs["attributes"]["pciBdf"] == {"string": PT_BDFS[1]}
    assert attrs["attributes"]["iommuGroup"] == {"int": 11}
    assert attrs["capacity"] == {"memory": {"value": str(
        sides.pt.host.chips[1].memory_bytes)}}


def test_published_without_counters(sides):
    dev = sides.jax.allocatable["chip-0-passthrough"]
    assert jax_counters(dev, sides.jax.host) == []
    d = pt_driver.Driver(sides.pt._config, pt_kube.FakeKubeClient(),
                         node_name="node-a", enable_health_monitor=False,
                         publication_mode="split")
    try:
        (only,) = d.generate_resource_slices()
        entries = {e["name"]: e for e in only["spec"]["devices"]}
        assert "consumesCounters" not in entries["gpu-0-passthrough"]
        assert entries["gpu-0"]["consumesCounters"]
    finally:
        d.state.close()


def test_lifecycle_matches(sides):
    got = {}
    for side, st, bdfs, error in sides.both():
        sides.tree.writes.clear()
        (cdi_id,) = st.prepare(sides.claim(side, "c1", 0))
        spec = st._cdi.read_spec("c1")
        (dev,) = [d for d in spec["devices"] if cdi_id.endswith(d["name"])]
        edits = dev["containerEdits"]
        prepared = list(sides.tree.writes)
        assert sides.tree.driver(bdfs[0]) == pt_vfio.VFIO_DRIVER
        # The passthrough GPU holds its whole GPU.
        with pytest.raises(error):
            st.prepare(sides.claim(side, "c2", 0, passthrough=False))
        st.unprepare("c1")
        assert sides.tree.driver(bdfs[0]) == NATIVE
        assert st._vfio.registry.list() == {}
        st.prepare(sides.claim(side, "c2", 0, passthrough=False))
        got[side] = (prepared, sides.tree.writes[len(prepared):],
                     sorted(e for e in edits["env"] if "VFIO" in e),
                     [n["path"] for n in edits["deviceNodes"]])
    assert got["pt"] == got["jax"]
    assert got["pt"][3] == [str(sides.tmp / "dev" / "vfio" / p)
                            for p in ("vfio", "10")]


def test_a_claim_survives_a_restart_and_an_orphan_is_bound_back(sides):
    for side, st, _, _ in sides.both():
        st.prepare(sides.claim(side, "c1", 0))
        # A crash between the rebind and PrepareCompleted: a registry
        # entry no claim record holds.
        cfg = PassthroughConfig() if side == "jax" else VfioDeviceConfig()
        st._vfio.configure(st.host.chips[1].pci_bdf, cfg)
    # A restart binds the orphan back and keeps the claim's rebind.
    got = {}
    for side, start in (("jax", sides.jax_state), ("pt", sides.pt_state)):
        sides.tree.writes.clear()
        st = start()
        setattr(sides, side, st)
        bdfs = JAX_BDFS if side == "jax" else PT_BDFS
        assert list(st._vfio.registry.list()) == [bdfs[0]]
        assert sides.tree.driver(bdfs[0]) == pt_vfio.VFIO_DRIVER
        assert sides.tree.driver(bdfs[1]) == NATIVE
        assert sides.tree.override(bdfs[1]) == "\n"
        assert st.destroy_unknown_subslices() == 0
        got[side] = list(sides.tree.writes)
    assert got["pt"] == got["jax"] == [
        ("bus/pci/drivers/vfio-pci/unbind", "<1>"),
        ("bus/pci/devices/<1>/driver_override", "\n"),
        ("bus/pci/drivers/nvidia/bind", "<1>")]
    # A lost spec is not prepared again under a bound GPU (the port).
    sides.pt._cdi.delete_claim_spec_file("c1")
    with pytest.raises(pt_ds.PrepareError, match="vfio-pci"):
        sides.pt.prepare(sides.claim("pt", "c1", 0))
    sides.pt.unprepare("c1")
    assert sides.pt._vfio.registry.list() == {}


@pytest.mark.parametrize("kind", ["whole-GPU config", "unknown iommu mode"])
def test_a_wrong_config_is_refused_with_nothing_left(sides, kind):
    for side, st, bdfs, error in sides.both():
        if kind == "whole-GPU config":
            claim = sides.claim(side, "c1", 0, kind={
                "jax": "TpuConfig", "pt": "GpuConfig"}[side])
        elif side == "jax":
            claim = make_claim("c1", ["chip-0-passthrough"], configs=[
                {"parameters": opaque("PassthroughConfig",
                                      iommuMode="nope")}])
        else:
            claim = ResourceClaim.from_dict(make_claim_dict(
                "c1", ["gpu-0-passthrough"], driver=DRIVER_NAME,
                configs=[{"parameters": {"apiVersion": PT_API,
                                         "kind": "VfioDeviceConfig",
                                         "iommuMode": "nope"}}]))
        sides.tree.writes.clear()
        with pytest.raises((error, ValueError)):
            st.prepare(claim)
        assert sides.tree.writes == [] and st.prepared_claims() == {}


def test_a_failed_rebind_is_bound_back(sides):
    got = {}
    for side, st, bdfs, error in sides.both():
        # The bind into vfio-pci fails (its bind file is a directory).
        bind = os.path.join(sides.tree.root, "bus", "pci", "drivers",
                            "vfio-pci", "bind")
        os.rename(bind, bind + ".off")
        os.mkdir(bind)
        sides.tree.writes.clear()
        try:
            with pytest.raises((error, OSError)):
                st.prepare(sides.claim(side, "c1", 1))
        finally:
            os.rmdir(bind)
            os.rename(bind + ".off", bind)
        assert st.prepared_claims() == {}
        assert st._vfio.registry.list() == {}
        assert sides.tree.driver(bdfs[1]) == NATIVE
        got[side] = list(sides.tree.writes)
    assert got["pt"] == got["jax"]


@pytest.mark.parametrize("no_pci", [False, True])
def test_nvml_publishes_none_without_a_pci_bus_id(tmp_path, monkeypatch,
                                                   fake_nvml, no_pci):
    # The chip machine's container refuses NVML's PCI info: with no bus id
    # there is nothing to rebind.
    ctypes.CDLL(fake_nvml).fake_reset()
    if no_pci:
        monkeypatch.setenv("FAKE_NVML_NO_PCI", "1")
    tree = FakeSysfs(tmp_path / "sys", PT_BDFS, monkeypatch=monkeypatch)
    monkeypatch.setattr(pt_ds, "load", lambda backend: NvmlLib(
        fake_nvml, sys_root=tree.root))
    st = pt_ds.DeviceState(pt_ds.Config(
        root=str(tmp_path / "state"), boot_id=BOOT,
        gpulib_opts=pt_ds.EnumerateOptions(sys_root=tree.root),
        feature_gates=pt_ds.FeatureGates.parse("PassthroughSupport=true"),
        driver_root=driver_root(tmp_path)))
    passthrough = sorted(n for n in st.allocatable if "passthrough" in n)
    assert passthrough == ([] if no_pci else
                           [f"gpu-{i}-passthrough" for i in range(4)])
