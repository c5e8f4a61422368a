"""The port's CDI edits and spec files against the JAX plugin's:
``ContainerEdits.to_dict`` and ``merge`` on the same edits, the spec's
structure, and the common edits of an H100 host (the control nodes that
exist under the device root, never opened; the host env)."""

import os
import random
import re

import pytest

from k8s_dra_driver_gpu_tpu.kubeletplugin import cdi as jax_cdi
from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import cdi as pt_cdi
from k8s_dra_driver_gpu_tpu_torch.tpulib import PyGpuLib
from k8s_dra_driver_gpu_tpu_torch.tpulib.binding import EnumerateOptions


def _random_edits(rng: random.Random, module):
    return module.ContainerEdits(
        env=[f"K{rng.randrange(9)}={rng.randrange(99)}"
             for _ in range(rng.randrange(4))],
        device_nodes=[f"/dev/nvidia{rng.randrange(8)}"
                      for _ in range(rng.randrange(3))])


@pytest.mark.parametrize("seed", range(8))
def test_edits_to_dict_and_merge_equal_the_references(seed):
    got, want = [], []
    for module, out in ((pt_cdi, got), (jax_cdi, want)):
        rng = random.Random(seed)
        a, b = _random_edits(rng, module), _random_edits(rng, module)
        out += [a.to_dict(), b.to_dict(), a.merge(b).to_dict(),
                b.merge(a).to_dict()]
    assert got == want


@pytest.mark.parametrize("seed", range(4))
def test_spec_file_has_the_references_structure(tmp_path, seed):
    specs, ids = {}, {}
    for side, module in (("pt", pt_cdi), ("jax", jax_cdi)):
        rng = random.Random(seed)
        handler = module.CDIHandler(cdi_root=str(tmp_path / side))
        edits = {f"dev-{i}": _random_edits(rng, module)
                 for i in range(rng.randrange(1, 4))}
        common = _random_edits(rng, module)
        ids[side] = handler.create_claim_spec_file("c1", edits, common)
        specs[side] = handler.read_spec("c1")
    jax_kind = f"{jax_cdi.CDI_VENDOR}/{jax_cdi.CDI_CLASS}"
    assert specs["pt"]["kind"] == "nvidia.com/gpu"
    assert specs["pt"] == dict(specs["jax"], kind="nvidia.com/gpu")
    assert ids["pt"] == [i.replace(jax_kind, "nvidia.com/gpu")
                         for i in ids["jax"]]


def test_spec_removed_and_truncated_spec_refused(tmp_path):
    handler = pt_cdi.CDIHandler(cdi_root=str(tmp_path))
    handler.create_claim_spec_file("c1", {"gpu-0": pt_cdi.ContainerEdits()})
    assert handler.spec_exists("c1")
    with open(handler.spec_path("c1"), "w") as f:
        f.write("{trunc")
    with pytest.raises(ValueError, match="corrupt CDI spec"):
        handler.read_spec("c1")
    handler.delete_claim_spec_file("c1")
    handler.delete_claim_spec_file("c1")
    assert handler.read_spec("c1") is None


@pytest.mark.parametrize("present", [
    (), ("nvidiactl",), ("nvidia-uvm",),
    ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")])
def test_common_edits_name_the_control_nodes_that_exist(tmp_path, present):
    dev = tmp_path / "dev"
    dev.mkdir()
    for name in present:
        # A file that cannot be opened: the handler only checks it exists.
        (dev / name).write_text("")
        os.chmod(dev / name, 0)
    host = PyGpuLib().enumerate(EnumerateOptions(mock_topology="h100-8",
                                                 worker_id=0))
    edits = pt_cdi.CDIHandler(cdi_root=str(tmp_path / "cdi"),
                              dev_root=str(dev)).common_edits(host)
    assert edits.device_nodes == [str(dev / name) for name in
                                  pt_cdi.COMMON_DEVICE_NODES
                                  if name in present]
    # The JAX plugin's host env under the same names, without its GCE
    # metadata switch; no libtpu mount.
    assert edits.env == [
        "TPU_ACCELERATOR_TYPE=h100-8", "TPU_WORKER_ID=0",
        "TPU_DRA_MIGRATION_INTENT_ANNOTATION=resource.tpu.dra/"
        "migration-intent",
        "TPU_DRA_MIGRATION_ACK_ANNOTATION=resource.tpu.dra/migration-ack"]
    assert set(edits.to_dict()) <= {"env", "deviceNodes"}


# -- the driver's libraries -------------------------------------------------

def _random_mount_edits(rng: random.Random, module):
    edits = _random_edits(rng, module)
    edits.mounts = [(f"/h/lib{rng.randrange(9)}.so", f"/c/lib{i}.so",
                     rng.random() < 0.7) for i in range(rng.randrange(4))]
    return edits


@pytest.mark.parametrize("seed", range(6))
def test_mounts_to_dict_and_merge_equal_the_references(seed):
    got, want = [], []
    for module, out in ((pt_cdi, got), (jax_cdi, want)):
        rng = random.Random(seed)
        a = _random_mount_edits(rng, module)
        b = _random_mount_edits(rng, module)
        out += [a.to_dict(), b.to_dict(), a.merge(b).to_dict()]
    assert got == want


NEW, OLD = "580.159.03", "575.57.08"


def _driver_root(tmp_path):
    """A host's driver files: the driver's version NEW in the first
    library directory with its soname links, a CUDA compat copy of OLD
    beside it (as on the H100 machine), a copy of NEW in a later
    directory, a libcuda of OLD alone in usr/lib64, and nvidia-smi."""
    root = tmp_path / "driver"
    lib = root / "usr" / "lib" / "x86_64-linux-gnu"
    later = root / "lib64"
    for d in (lib, later, root / "usr" / "lib64", root / "usr" / "bin"):
        d.mkdir(parents=True)
    links = {"libcuda": ["libcuda.so.1", "libcuda.so"],
             "libnvidia-ml": ["libnvidia-ml.so.1", "libnvidia-ml.so"],
             "libnvidia-nvvm": ["libnvidia-nvvm.so.4"],
             "libcudadebugger": ["libcudadebugger.so.1"]}
    for name in ("libcuda", "libnvidia-ml", "libnvidia-nvvm",
                 "libcudadebugger", "libnvidia-ptxjitcompiler"):
        (lib / f"{name}.so.{NEW}").write_text(NEW)
        (lib / f"{name}.so.{OLD}").write_text(OLD)
        (later / f"{name}.so.{NEW}").write_text(NEW)
        for link in links.get(name, []):
            (lib / link).symlink_to(f"{name}.so.{NEW}")
    # A soname link to the OLD version, and an unrelated library.
    (lib / "libnvidia-ptxjitcompiler.so.1").symlink_to(
        f"libnvidia-ptxjitcompiler.so.{OLD}")
    (lib / "libnvidia-gpucomp.so.1").symlink_to("missing")
    (root / "usr" / "lib64" / f"libnvidia-gpucomp.so.{OLD}").write_text(OLD)
    (root / "usr" / "bin" / "nvidia-smi").write_text("#!/bin/sh\n")
    return root


def test_only_the_drivers_version_is_mounted_with_its_sonames(tmp_path):
    root = _driver_root(tmp_path)
    mounts = pt_cdi.driver_mounts(str(root), NEW)
    lib = f"{root}/usr/lib/x86_64-linux-gnu"
    rel = "/usr/lib/x86_64-linux-gnu"

    def binds(name, *links):
        host = f"{lib}/{name}.so.{NEW}"
        return [(host, f"{rel}/{name}.so.{NEW}", True)] + [
            (host, f"{rel}/{link}", True) for link in sorted(links)]

    assert mounts == (
        binds("libcuda", "libcuda.so", "libcuda.so.1")
        + binds("libcudadebugger", "libcudadebugger.so.1")
        + binds("libnvidia-ml", "libnvidia-ml.so", "libnvidia-ml.so.1")
        # Its .so.1 names the OLD version: no second bind.
        + binds("libnvidia-ptxjitcompiler")
        + binds("libnvidia-nvvm", "libnvidia-nvvm.so.4")
        + [(f"{root}/usr/bin/nvidia-smi", "/usr/bin/nvidia-smi", True)])
    assert not any(OLD in host or OLD in container
                   for host, container, _ in mounts)
    # Each bind names an existing host file of NEW.
    assert all(open(host).read() == NEW for host, _, _ in mounts[:-1])


def test_the_other_version_mounts_no_soname(tmp_path):
    root = _driver_root(tmp_path)
    mounts = pt_cdi.driver_mounts(str(root), OLD)
    assert [c for _, c, _ in mounts] == [
        f"/usr/lib/x86_64-linux-gnu/libcuda.so.{OLD}",
        f"/usr/lib/x86_64-linux-gnu/libcudadebugger.so.{OLD}",
        f"/usr/lib/x86_64-linux-gnu/libnvidia-ml.so.{OLD}",
        f"/usr/lib/x86_64-linux-gnu/libnvidia-ptxjitcompiler.so.{OLD}",
        "/usr/lib/x86_64-linux-gnu/libnvidia-ptxjitcompiler.so.1",
        f"/usr/lib/x86_64-linux-gnu/libnvidia-nvvm.so.{OLD}",
        f"/usr/lib64/libnvidia-gpucomp.so.{OLD}",
        "/usr/bin/nvidia-smi"]


@pytest.mark.parametrize("found", [(), ("nvidia-cuda-mps-control",),
                                   ("nvidia-cuda-mps-control",
                                    "nvidia-cuda-mps-server")])
def test_the_mps_binaries_are_mounted_where_found(tmp_path, found):
    # As on the H100 machine: nvidia-smi in usr/local/bin, MPS in usr/bin.
    root = _driver_root(tmp_path)
    (root / "usr" / "local" / "bin").mkdir(parents=True)
    os.replace(root / "usr" / "bin" / "nvidia-smi",
               root / "usr" / "local" / "bin" / "nvidia-smi")
    for name in found:
        (root / "usr" / "bin" / name).write_text("#!/bin/sh\n")
    mounts = pt_cdi.driver_mounts(str(root), NEW)
    binaries = [("nvidia-smi", "usr/local/bin")] + [
        (name, "usr/bin") for name in found]
    assert mounts[-len(binaries):] == [
        (f"{root}/{d}/{name}", f"/{d}/{name}", True)
        for name, d in binaries]
    for name in pt_cdi.DRIVER_BINARIES:
        where = dict(binaries).get(name)
        assert pt_cdi.find_binary(str(root), name) == (
            where and f"{root}/{where}/{name}")


@pytest.mark.parametrize("version", ["", "999.1", NEW + ".0"])
def test_no_library_without_the_version(tmp_path, version, caplog):
    """No version: nothing mounted, and why is logged. A version whose
    libcuda and libnvidia-ml are not there is refused."""
    root = _driver_root(tmp_path)
    handler = pt_cdi.CDIHandler(cdi_root=str(tmp_path / "cdi"),
                                driver_root=str(root))
    if not version:
        assert handler.driver_mounts(version) == []
        assert "no driver version" in caplog.text
        return
    with pytest.raises(FileNotFoundError,
                       match=f"driver {re.escape(version)}: no libcuda, "
                             "libnvidia-ml of that version"):
        handler.driver_mounts(version)


@pytest.mark.parametrize("present", ["libcuda", "libnvidia-ml"])
def test_a_required_library_alone_is_refused(tmp_path, present):
    """Either of libcuda and libnvidia-ml without the other: refused,
    naming the missing one."""
    lib = tmp_path / "driver" / "usr" / "lib64"
    lib.mkdir(parents=True)
    (lib / f"{present}.so.{NEW}").write_text(NEW)
    missing = ({"libcuda", "libnvidia-ml"} - {present}).pop()
    with pytest.raises(FileNotFoundError, match=f"no {missing} of"):
        pt_cdi.driver_mounts(str(tmp_path / "driver"), NEW)


@pytest.mark.parametrize("version,refused", [(NEW, False), (OLD, False),
                                              ("999.1", True)])
def test_a_state_over_a_driver_without_its_libraries_is_refused(
        tmp_path, monkeypatch, version, refused):
    """The refusal reaches ``DeviceState``'s construction: no claim is
    prepared with a spec that cannot start CUDA."""
    import dataclasses

    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import \
        device_state as pt_ds

    class VersionedLib(PyGpuLib):
        def enumerate(self, opts=None):
            return dataclasses.replace(super().enumerate(opts),
                                       driver_version=version)

    monkeypatch.setattr(pt_ds, "load", lambda backend=None: VersionedLib())
    cfg = pt_ds.Config.mock(str(tmp_path / "state"), topology="h100-2")
    cfg.driver_root = str(_driver_root(tmp_path))
    if refused:
        with pytest.raises(FileNotFoundError, match="driver 999.1"):
            pt_ds.DeviceState(cfg)
    else:
        mounts = pt_ds.DeviceState(cfg)._cdi.driver_mounts(version)
        assert {os.path.basename(h) for h, _, _ in mounts} >= {
            f"libcuda.so.{version}", f"libnvidia-ml.so.{version}"}


@pytest.mark.parametrize("first", pt_cdi.LIBRARY_DIRS)
def test_the_first_library_directory_wins(tmp_path, first):
    root = tmp_path / "driver"
    for d in pt_cdi.LIBRARY_DIRS[pt_cdi.LIBRARY_DIRS.index(first):]:
        (root / d).mkdir(parents=True, exist_ok=True)
        for lib in pt_cdi.REQUIRED_LIBRARIES:
            (root / d / f"{lib}.so.{NEW}").write_text(d)
    mounts = pt_cdi.driver_mounts(str(root), NEW)
    assert mounts == [(f"{root}/{first}/{lib}.so.{NEW}",
                       f"/{first}/{lib}.so.{NEW}", True)
                      for lib in pt_cdi.REQUIRED_LIBRARIES]


def test_the_directory_this_process_maps_nvml_from_comes_first(tmp_path):
    """A driver kept outside ``LIBRARY_DIRS`` (here ``opt/nvidia/lib``)
    is found where this process's own NVML is mapped from, before a copy
    in the usual directories; a root that does not hold the mapped file
    does not see it."""
    import ctypes

    from tests.test_torch_kubeletplugin_health import build_fake_nvml

    root = _driver_root(tmp_path)
    mapped = root / "opt" / "nvidia" / "lib"
    ctypes.CDLL(build_fake_nvml(mapped))
    for lib in ("libcuda", "libnvidia-ml"):
        (mapped / f"{lib}.so.{NEW}").write_text("mapped")
    (mapped / "libcuda.so.1").symlink_to(f"libcuda.so.{NEW}")
    assert pt_cdi.mapped_library_dirs(str(root)) == ("opt/nvidia/lib",)
    assert pt_cdi.mapped_library_dirs(str(tmp_path / "elsewhere")) == ()
    mounts = pt_cdi.driver_mounts(str(root), NEW)
    assert mounts[:3] == [
        (f"{mapped}/libcuda.so.{NEW}", f"/opt/nvidia/lib/libcuda.so.{NEW}",
         True),
        (f"{mapped}/libcuda.so.{NEW}", "/opt/nvidia/lib/libcuda.so.1", True),
        # The next library not in the mapped directory comes from the
        # first usual one.
        (f"{root}/usr/lib/x86_64-linux-gnu/libcudadebugger.so.{NEW}",
         f"/usr/lib/x86_64-linux-gnu/libcudadebugger.so.{NEW}", True)]
    assert (f"{mapped}/libnvidia-ml.so.{NEW}",
            f"/opt/nvidia/lib/libnvidia-ml.so.{NEW}", True) in mounts
    # The mapped libnvidia-ml.so.1 is the fake NVML, not a link to NEW:
    # no second bind.
    assert not any(c.endswith("libnvidia-ml.so.1") for _, c, _ in mounts)


def test_a_prepared_claims_spec_mounts_the_driver(tmp_path):
    import dataclasses

    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import DRIVER_NAME
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin import \
        device_state as pt_ds
    from k8s_dra_driver_gpu_tpu_torch.kubeletplugin.claim import \
        ResourceClaim
    from tests.fake_kube import make_claim_dict

    root = _driver_root(tmp_path)
    cfg = pt_ds.Config.mock(str(tmp_path / "state"), topology="h100-2")
    cfg.driver_root = str(root)
    state = pt_ds.DeviceState(cfg)
    state.host = dataclasses.replace(state.host, driver_version=NEW)
    state.prepare(ResourceClaim.from_dict(make_claim_dict(
        "c1", ["gpu-1"], driver=DRIVER_NAME)))
    spec = state._cdi.read_spec("c1")
    mounts = spec["containerEdits"]["mounts"]
    assert mounts[0] == {
        "hostPath": f"{root}/usr/lib/x86_64-linux-gnu/libcuda.so.{NEW}",
        "containerPath": f"/usr/lib/x86_64-linux-gnu/libcuda.so.{NEW}",
        "options": ["ro", "nosuid", "nodev", "bind"]}
    assert {m["containerPath"].rsplit("/", 1)[1] for m in mounts} >= {
        "libcuda.so.1", "libnvidia-ml.so.1", f"libnvidia-ml.so.{NEW}",
        "nvidia-smi"}
    assert all(os.path.isfile(m["hostPath"]) for m in mounts)
    assert spec["devices"][0]["containerEdits"] == {
        "deviceNodes": [{"path": "/dev/nvidia1"}]}
