"""CDI specs: inject a claim's GPUs and their env into its containers
(the JAX package's ``kubeletplugin/cdi.py``; the upstream driver's
``cmd/gpu-kubelet-plugin/cdi.go``).

One transient spec a claim, of kind ``nvidia.com/gpu``:

- each GPU's device entry holds its node ``/dev/nvidia<minor>``;
- the spec's common edits hold ``/dev/nvidiactl``, ``/dev/nvidia-uvm``
  and ``/dev/nvidia-uvm-tools``, each only where it exists under the
  device root (checked with ``os.path.exists``: a device node is never
  opened), and the host env: ``TPU_ACCELERATOR_TYPE`` and
  ``TPU_WORKER_ID`` (the names of the launcher's ``TPU_*`` contract,
  which the port's launcher reads) and the two migration annotations;
- the claim's own line follows (``device_state``):
  ``CUDA_DEVICE_ORDER=PCI_BUS_ID``.

The JAX package's libtpu mount has no counterpart yet: the spec mounts
none of the NVIDIA driver's user-space libraries (``libcuda.so.1``,
``libnvidia-ml.so.1``), so a container run from this spec alone needs
them in its image. Mounting them, as the upstream driver's CDI library
discovery does, is queued in ROADMAP.md §1b. Nor has the spec the JAX
package's ``TPU_SKIP_MDS_QUERY`` (a GCE metadata switch).
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field

from ..pkg.fsutil import write_json_atomic
from . import CDI_CLASS, CDI_VENDOR

CDI_VERSION = "0.6.0"
DEFAULT_CDI_ROOT = "/var/run/cdi"
# The control nodes every CUDA process opens besides its GPU's own.
COMMON_DEVICE_NODES = ("nvidiactl", "nvidia-uvm", "nvidia-uvm-tools")


@dataclass
class ContainerEdits:
    env: list[str] = field(default_factory=list)
    device_nodes: list[str] = field(default_factory=list)

    def to_dict(self) -> dict:
        out: dict = {}
        if self.env:
            out["env"] = self.env
        if self.device_nodes:
            out["deviceNodes"] = [{"path": p} for p in self.device_nodes]
        return out

    def merge(self, other: "ContainerEdits") -> "ContainerEdits":
        return ContainerEdits(env=self.env + other.env,
                              device_nodes=self.device_nodes
                              + other.device_nodes)


def qualified_device_id(name: str) -> str:
    return f"{CDI_VENDOR}/{CDI_CLASS}={name}"


class CDIHandler:
    """Writes and removes the per-claim spec files under the CDI root."""

    def __init__(self, cdi_root: str = DEFAULT_CDI_ROOT,
                 dev_root: str = "/dev"):
        self._root = cdi_root
        self._dev_root = dev_root
        os.makedirs(self._root, exist_ok=True)

    def spec_path(self, claim_uid: str) -> str:
        return os.path.join(self._root,
                            f"{CDI_VENDOR}-{CDI_CLASS}_{claim_uid}.json")

    def common_edits(self, host) -> ContainerEdits:
        """The edits every claim on this host shares (upstream
        ``GetCommonEditsCached``, cdi.go:112)."""
        nodes = [path for name in COMMON_DEVICE_NODES
                 if os.path.exists(path := os.path.join(self._dev_root,
                                                        name))]
        return ContainerEdits(
            env=[f"TPU_ACCELERATOR_TYPE={host.accelerator_type}",
                 f"TPU_WORKER_ID={host.worker_id}",
                 ("TPU_DRA_MIGRATION_INTENT_ANNOTATION="
                  "resource.tpu.dra/migration-intent"),
                 ("TPU_DRA_MIGRATION_ACK_ANNOTATION="
                  "resource.tpu.dra/migration-ack")],
            device_nodes=nodes)

    def create_claim_spec_file(self, claim_uid: str,
                               device_edits: dict[str, ContainerEdits],
                               common: ContainerEdits | None = None
                               ) -> list[str]:
        """Write a claim's spec durably, before the checkpoint calls the
        claim PrepareCompleted; returns its qualified CDI device ids
        (upstream ``CreateClaimSpecFile``, cdi.go:181)."""
        devices = [{"name": name, "containerEdits": edits.to_dict()}
                   for name, edits in sorted(device_edits.items())]
        spec = {"cdiVersion": CDI_VERSION,
                "kind": f"{CDI_VENDOR}/{CDI_CLASS}", "devices": devices}
        if common and common.to_dict():
            spec["containerEdits"] = common.to_dict()
        write_json_atomic(self.spec_path(claim_uid), json.dumps(spec))
        return [qualified_device_id(d["name"]) for d in devices]

    def delete_claim_spec_file(self, claim_uid: str) -> None:
        try:
            os.unlink(self.spec_path(claim_uid))
        except FileNotFoundError:
            pass

    def spec_exists(self, claim_uid: str) -> bool:
        return os.path.exists(self.spec_path(claim_uid))

    def read_spec(self, claim_uid: str) -> dict | None:
        """The spec, None when absent; ValueError when it is not JSON (a
        truncated spec)."""
        try:
            with open(self.spec_path(claim_uid), encoding="utf-8") as f:
                return json.load(f)
        except FileNotFoundError:
            return None
        except json.JSONDecodeError as e:
            raise ValueError(f"corrupt CDI spec for {claim_uid}: {e}") from e
