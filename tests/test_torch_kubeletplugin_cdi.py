"""The port's CDI edits and spec files against the JAX plugin's:
``ContainerEdits.to_dict`` and ``merge`` on the same edits, the spec's
structure, and the common edits of an H100 host (the control nodes that
exist under the device root, never opened; the host env)."""

import os
import random

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
