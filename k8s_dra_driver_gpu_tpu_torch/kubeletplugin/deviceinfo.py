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

A MIG device (``SubSliceInfo``) is named ``gpu-<index>-mig-<profile>-
<start>`` (``subslice.py``). Its attributes: ``profile`` (NVML's name,
``1g.10gb``), ``parentIndex``, ``placement`` (its first memory slot),
``productName`` and, for a static device (one that exists before any
claim), its MIG ``uuid``; its capacities are the profile's
``multiprocessors`` and ``memory`` (bytes).

A tenant partition (``PartitionInfo``, ``pkg/partition``) is a
PartitionSet profile over one placement of its MIG profile, named
``pt-<profile>-<k>`` (``k`` counts the profile's placements over the
host's GPUs). Its attributes are the JAX ones with GPU names:
``profile``, ``subslice`` (the MIG profile), ``placement`` (``k``),
``parentIndex``, ``migStart`` (the placement's first memory slot),
``productName``, ``partition`` and ``oversubscribeSlots``
(``maxTenants``). Its capacities are a tenant slot's: ``memory``, the
MIG profile's bytes x ``hbmFraction`` / ``maxTenants`` rounded down to
whole MiB (MPS pins memory in MiB), and ``multiprocessors``, the
profile's SMs / ``maxTenants``.

A GPU published for vfio passthrough (``PassthroughInfo``, with the
``PassthroughSupport`` gate on) is named ``gpu-<index>-passthrough``.
Its attributes are the JAX ones: ``uuid``, ``platform``, ``pciBdf``,
``iommuGroup`` and ``passthrough`` (true); its capacity is ``memory``.
It holds all of its GPU's memory slots, as the whole GPU does.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from enum import Enum

from ..pkg.partition.spec import PartitionProfile, partition_device_name
from ..tpulib.binding import GpuChip, GpuHostInfo, SubSliceProfile
from .subslice import SubSliceSpecTuple

_GPU_RE = re.compile(r"^gpu-(\d+)$")


def gpu_name(index: int) -> str:
    return f"gpu-{index}"


def parse_gpu_name(name: str) -> int | None:
    m = _GPU_RE.match(name)
    return int(m.group(1)) if m else None


class DeviceKind(str, Enum):
    """Every kind the JAX plugin allocates, under its names: CHIP (a
    whole GPU), the two MIG kinds: SUBSLICE_STATIC (a MIG device that
    exists before the claim) and SUBSLICE_DYNAMIC (one created at
    prepare), PASSTHROUGH (a whole GPU bound to vfio-pci at prepare) and
    PARTITION (a tenant partition over a MIG instance)."""

    CHIP = "chip"
    SUBSLICE_STATIC = "subslice-static"
    SUBSLICE_DYNAMIC = "subslice-dynamic"
    PASSTHROUGH = "passthrough"
    PARTITION = "partition"


REDACTED_UUID = "GPU-REDACTED"
# An H100's MIG memory slots: every placement is a run of them.
MIG_MEMORY_SLICES = 8
MIB = 1 << 20


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


@dataclass(frozen=True)
class SubSliceInfo:
    """A MIG device of GPU ``chip``: ``dynamic`` when prepare creates it,
    else static with the UUID of the MIG device that exists."""

    spec: SubSliceSpecTuple
    profile: SubSliceProfile
    chip: GpuChip
    dynamic: bool
    uuid: str = ""

    @property
    def canonical_name(self) -> str:
        return self.spec.canonical_name()

    def attributes(self) -> dict:
        attrs = {"profile": self.spec.profile,
                 "parentIndex": self.chip.index,
                 "placement": self.spec.start,
                 "productName": self.chip.name}
        if self.uuid:
            attrs["uuid"] = self.uuid
        return {k: v for k, v in attrs.items() if v != ""}

    def capacities(self) -> dict:
        return {"multiprocessors": self.profile.cores,
                "memory": self.profile.hbm_bytes}


@dataclass(frozen=True)
class PartitionInfo:
    """A tenant partition: ``profile`` over the MIG placement ``spec`` of
    GPU ``chip`` (its MIG profile ``mig``), the ``placement``-th of the
    profile's placements on this host."""

    profile: PartitionProfile
    spec: SubSliceSpecTuple
    mig: SubSliceProfile
    chip: GpuChip
    placement: int

    @property
    def canonical_name(self) -> str:
        return partition_device_name(self.profile.name, self.placement)

    @property
    def oversubscribed(self) -> bool:
        return self.profile.max_tenants > 1

    @property
    def tenant_memory_bytes(self) -> int:
        """A tenant's memory budget and MPS ceiling: whole MiB."""
        budget = int(self.mig.hbm_bytes * self.profile.hbm_fraction) \
            // self.profile.max_tenants
        return budget // MIB * MIB

    @property
    def tenant_multiprocessors(self) -> int:
        return self.mig.cores // self.profile.max_tenants

    @property
    def tenant_slice_milli(self) -> int:
        """A tenant's share of each memory slot of the placement, in
        thousandths."""
        return 1000 // self.profile.max_tenants

    # The surface the sizing policy reads (``pkg/partition/profiles.py``,
    # the JAX PartitionInfo's names): a tenant's memory budget, its time
    # share of each core in thousandths, and the instance's cores (SMs).
    @property
    def tenant_hbm_bytes(self) -> int:
        return self.tenant_memory_bytes

    @property
    def tenant_core_milli(self) -> int:
        return self.tenant_slice_milli

    @property
    def cores(self) -> int:
        return self.mig.cores

    def attributes(self) -> dict:
        return {"profile": self.profile.name,
                "subslice": self.profile.subslice,
                "placement": self.placement,
                "parentIndex": self.chip.index,
                "migStart": self.spec.start,
                "productName": self.chip.name,
                "partition": True,
                # > 1 marks a device a scheduler may allocate to several
                # tenant claims.
                "oversubscribeSlots": self.profile.max_tenants}

    def capacities(self) -> dict:
        return {"multiprocessors": self.tenant_multiprocessors,
                "memory": self.tenant_memory_bytes}


@dataclass(frozen=True)
class PassthroughInfo:
    """A GPU published for vfio passthrough (upstream ``VfioDeviceInfo``,
    ``deviceinfo.go:152-199``)."""

    chip: GpuChip
    host: GpuHostInfo
    iommu_group: int = -1

    @property
    def canonical_name(self) -> str:
        return f"{gpu_name(self.chip.index)}-passthrough"

    def attributes(self) -> dict:
        attrs = {"uuid": self.chip.uuid,
                 "platform": self.host.platform,
                 "pciBdf": self.chip.pci_bdf,
                 "iommuGroup": self.iommu_group,
                 "passthrough": True}
        return {k: v for k, v in attrs.items() if not _refused(k, v)}

    def capacities(self) -> dict:
        return {"memory": self.chip.memory_bytes}


@dataclass
class AllocatableDevice:
    """One device this node can allocate (upstream ``allocatable.go:48``,
    a union over the kinds): a whole GPU (``chip``), a MIG device
    (``subslice``), a passthrough GPU (``passthrough``) or a tenant
    partition (``partition``)."""

    kind: DeviceKind
    chip: ChipInfo | None = None
    subslice: SubSliceInfo | None = None
    partition: PartitionInfo | None = None
    passthrough: PassthroughInfo | None = None

    @property
    def _info(self):
        return self.chip or self.subslice or self.partition \
            or self.passthrough

    @property
    def canonical_name(self) -> str:
        return self._info.canonical_name

    @property
    def gpu(self) -> GpuChip:
        """The GPU this device is or lies on."""
        if self.chip is not None:
            return self.chip.chip
        return (self.subslice or self.partition or self.passthrough).chip

    def memory_slices(self) -> set[tuple[int, int]]:
        """(GPU index, memory slot) of each MIG memory slot this device
        takes: all of its GPU's for a whole GPU, its placement's for a
        partition."""
        ss = self.subslice or self.partition
        if ss is not None:
            return {(self.gpu.index, k) for k in ss.spec.memory_slices}
        return {(self.gpu.index, k) for k in range(MIG_MEMORY_SLICES)}

    def sort_key(self) -> tuple:
        """Publication order: by GPU, the whole GPU first, then its
        passthrough device, its MIG devices by profile and start, then its
        partitions by profile and placement."""
        if self.subslice is not None:
            return (self.gpu.index, 1, self.subslice.spec.profile,
                    self.subslice.spec.start)
        if self.partition is not None:
            return (self.gpu.index, 2, self.partition.profile.name,
                    self.partition.placement)
        if self.passthrough is not None:
            return (self.gpu.index, 0, "passthrough", 0)
        return (self.gpu.index, 0, "", 0)

    def to_dra_device(self) -> dict:
        """A resource.k8s.io Device entry of a ResourceSlice."""
        attrs = {}
        for key, val in self._info.attributes().items():
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
                         for key, val in self._info.capacities().items()},
        }
