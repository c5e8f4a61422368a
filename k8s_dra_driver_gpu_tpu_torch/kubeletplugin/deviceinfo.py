"""The device model: each allocatable GPU as a DRA ResourceSlice device
(the JAX package's ``kubeletplugin/deviceinfo.py`` and ``subslice.py``'s
names; the upstream driver's ``deviceinfo.go`` and ``allocatable.go``).

A whole GPU is named ``gpu-<index>`` (NVML's index, PCI bus order), as
the upstream driver names it. Its attributes come from ``GpuChip`` and
``GpuHostInfo`` alone: ``uuid``, ``platform``, ``productName``,
``acceleratorType``, ``driverVersion``, ``numaNode``, ``pciBdf``,
``workerId``, ``numHosts``, ``migMode`` and ``minor``; its capacity is
``memory`` (bytes). A value NVML refused ("" for a string, -1 for
``numaNode`` and ``minor``, "unknown: …" for ``migMode``) is left out,
not published: a scheduler's selector must not match on a refusal. So
is a UUID that names no one GPU: NVML's placeholder ``GPU-REDACTED``, or
one that two GPUs of the host share. (An H100 container may refuse the
PCI info, and then ``pciBdf`` and ``numaNode`` go, and may answer the
placeholder for the UUID.)
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from enum import Enum

from ..tpulib.binding import GpuChip, GpuHostInfo

_GPU_RE = re.compile(r"^gpu-(\d+)$")


def gpu_name(index: int) -> str:
    return f"gpu-{index}"


def parse_gpu_name(name: str) -> int | None:
    m = _GPU_RE.match(name)
    return int(m.group(1)) if m else None


class DeviceKind(str, Enum):
    """Every kind the JAX plugin allocates, under its names; the port
    builds CHIP (a whole GPU) only."""

    CHIP = "chip"
    SUBSLICE_STATIC = "subslice-static"
    SUBSLICE_DYNAMIC = "subslice-dynamic"
    PASSTHROUGH = "passthrough"
    PARTITION = "partition"


REDACTED_UUID = "GPU-REDACTED"


def _refused(key: str, value) -> bool:
    if key == "uuid":
        return value in ("", REDACTED_UUID)
    if key in ("numaNode", "minor"):
        return value < 0
    if key == "migMode":
        return value.startswith("unknown")
    return value == ""


@dataclass(frozen=True)
class ChipInfo:
    chip: GpuChip
    host: GpuHostInfo

    @property
    def canonical_name(self) -> str:
        return gpu_name(self.chip.index)

    def _all_attributes(self) -> dict:
        chip, host = self.chip, self.host
        return {
            "uuid": chip.uuid,
            "platform": host.platform,
            "productName": chip.name,
            "acceleratorType": host.accelerator_type,
            "driverVersion": host.driver_version,
            "numaNode": chip.numa_node,
            "pciBdf": chip.pci_bdf,
            "workerId": host.worker_id,
            "numHosts": host.num_hosts,
            "migMode": host.mig_mode,
            "minor": chip.minor,
        }

    def _is_refused(self, key: str, value) -> bool:
        if key == "uuid" and sum(chip.uuid == value
                                 for chip in self.host.chips) > 1:
            return True
        return _refused(key, value)

    def attributes(self) -> dict:
        return {key: value for key, value in self._all_attributes().items()
                if not self._is_refused(key, value)}

    def refused_attributes(self) -> list[str]:
        """The attributes left out because NVML refused their value."""
        return [key for key, value in self._all_attributes().items()
                if self._is_refused(key, value)]

    def capacities(self) -> dict:
        return {"memory": self.chip.memory_bytes}


@dataclass
class AllocatableDevice:
    """One device this node can allocate (upstream ``allocatable.go:48``,
    a union over the kinds; here a whole GPU)."""

    kind: DeviceKind
    chip: ChipInfo

    @property
    def canonical_name(self) -> str:
        return self.chip.canonical_name

    def to_dra_device(self) -> dict:
        """A resource.k8s.io Device entry of a ResourceSlice."""
        attrs = {}
        for key, val in self.chip.attributes().items():
            if isinstance(val, bool):
                attrs[key] = {"bool": val}
            elif isinstance(val, int):
                attrs[key] = {"int": val}
            else:
                attrs[key] = {"string": str(val)}
        return {
            "name": self.canonical_name,
            "attributes": attrs,
            "capacity": {key: {"value": str(val)}
                         for key, val in self.chip.capacities().items()},
        }
