"""Opaque device-config types with normalize/validate (the JAX package's
``api/configs.py``; the upstream driver's
``api/nvidia.com/resource/v1beta1/{gpuconfig.go,sharing.go}``).

``GpuConfig`` is the config of a whole-GPU claim (the JAX package's
``TpuConfig``), ``MigDeviceConfig`` that of a MIG device claim (the
upstream's kind, ``migconfig.go:28``; the JAX package's
``SubSliceConfig``, its partition-only ``oversubscribe`` too). Their
``Sharing`` union decodes and validates as there; the kubelet plugin
runs it through ``kubeletplugin/sharing.py`` (time-slicing at an
interval, MPS with per-device memory limits). ``VfioDeviceConfig`` is
that of a passthrough claim (the upstream's kind,
``vfiodeviceconfig.go:29``; the JAX package's ``PassthroughConfig``),
run by ``kubeletplugin/vfio.py``. ``ComputeDomainChannelConfig``
and ``ComputeDomainDaemonConfig`` are the ComputeDomain plugin's
(``computedomain/plugin``; upstream ``computedomainconfig.go``).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from enum import Enum


class ValidationError(ValueError):
    pass


class TimeSlicingInterval(str, Enum):
    DEFAULT = "Default"
    SHORT = "Short"
    MEDIUM = "Medium"
    LONG = "Long"


_MEMORY_RE = re.compile(r"^(\d+)(Gi|Mi)?$")


def _parse_memory(limit: str) -> int:
    """A memory limit like "8Gi", "512Mi" or "1024" (bytes), in bytes."""
    m = _MEMORY_RE.match(limit)
    if not m:
        raise ValidationError(f"invalid HBM limit {limit!r}")
    n, unit = int(m.group(1)), m.group(2)
    return n << {"Gi": 30, "Mi": 20}.get(unit, 0)


@dataclass
class TimeSlicingConfig:
    """Temporal sharing: the time-slice interval (sharing.go:33-39)."""

    interval: str = TimeSlicingInterval.DEFAULT.value

    def normalize(self) -> None:
        if not self.interval:
            self.interval = TimeSlicingInterval.DEFAULT.value

    def validate(self) -> None:
        values = [i.value for i in TimeSlicingInterval]
        if self.interval not in values:
            raise ValidationError(
                f"unknown time-slicing interval {self.interval!r}; "
                f"must be one of {values}")


@dataclass
class MultiTenancyConfig:
    """Spatial sharing of one GPU (MPS): a bounded client count with
    per-client memory limits, the default folded into a "*" entry
    (sharing.go:190-220)."""

    max_clients: int | None = None
    hbm_limit: str | None = None
    per_device_hbm_limits: dict[str, str] = field(default_factory=dict)

    def normalize(self) -> None:
        if self.hbm_limit and "*" not in self.per_device_hbm_limits:
            self.per_device_hbm_limits["*"] = self.hbm_limit

    def validate(self) -> None:
        if self.max_clients is not None and self.max_clients < 1:
            raise ValidationError("maxClients must be >= 1")
        for dev, lim in self.per_device_hbm_limits.items():
            _parse_memory(lim)
            if dev != "*" and not dev:
                raise ValidationError("empty device key in hbm limits")

    def hbm_limit_bytes_for(self, device: str) -> int | None:
        """The memory limit of ``device`` in bytes: its own entry, else
        the "*" entry, else None."""
        lim = self.per_device_hbm_limits.get(
            device, self.per_device_hbm_limits.get("*"))
        return _parse_memory(lim) if lim else None


@dataclass
class Sharing:
    """The sharing strategy: exactly one member set after validate."""

    strategy: str = "TimeSlicing"  # TimeSlicing | MultiTenancy
    time_slicing: TimeSlicingConfig | None = None
    multi_tenancy: MultiTenancyConfig | None = None

    def normalize(self) -> None:
        if self.strategy == "TimeSlicing" and self.time_slicing is None:
            self.time_slicing = TimeSlicingConfig()
        if self.time_slicing:
            self.time_slicing.normalize()
        if self.multi_tenancy:
            self.multi_tenancy.normalize()

    def validate(self) -> None:
        if self.strategy == "TimeSlicing":
            if self.multi_tenancy is not None:
                raise ValidationError(
                    "multiTenancy config set with TimeSlicing strategy")
            if self.time_slicing:
                self.time_slicing.validate()
        elif self.strategy == "MultiTenancy":
            if self.time_slicing is not None:
                raise ValidationError(
                    "timeSlicing config set with MultiTenancy strategy")
            if self.multi_tenancy is None:
                raise ValidationError("multiTenancy config missing")
            self.multi_tenancy.validate()
        else:
            raise ValidationError(
                f"unknown sharing strategy {self.strategy!r}")

    @property
    def is_time_slicing(self) -> bool:
        return self.strategy == "TimeSlicing"

    @property
    def is_default(self) -> bool:
        """Time-slicing at the default interval (after normalize): what a
        GPU does with no sharing configured."""
        return (self.is_time_slicing and self.time_slicing is not None
                and self.time_slicing.interval
                == TimeSlicingInterval.DEFAULT.value)


@dataclass
class GpuConfig:
    """The config of a whole-GPU claim (gpuconfig.go:29)."""

    KIND = "GpuConfig"

    sharing: Sharing | None = None

    def normalize(self) -> None:
        if self.sharing is None:
            self.sharing = Sharing()
        self.sharing.normalize()

    def validate(self) -> None:
        if self.sharing:
            self.sharing.validate()


@dataclass
class MigDeviceConfig:
    """The config of a MIG device claim (migconfig.go:28), and of a
    tenant partition device (``pkg/partition``): a claim on an
    oversubscribed partition (one that publishes ``oversubscribeSlots``
    > 1) must set ``oversubscribe: true``, the opt-in to sharing its MIG
    instance with up to N-1 other tenants under one MPS daemon."""

    KIND = "MigDeviceConfig"

    sharing: Sharing | None = None
    oversubscribe: bool = False

    def normalize(self) -> None:
        if self.sharing is None:
            self.sharing = Sharing()
        self.sharing.normalize()

    def validate(self) -> None:
        if self.sharing:
            self.sharing.validate()
        if not isinstance(self.oversubscribe, bool):
            raise ValidationError("oversubscribe must be a boolean")
        if self.oversubscribe and self.sharing and \
                not self.sharing.is_time_slicing:
            raise ValidationError(
                "oversubscribe provisions its own per-tenant MPS limit; a "
                "MultiTenancy sharing config cannot be combined with it")


@dataclass
class VfioDeviceConfig:
    """The config of a passthrough claim (vfiodeviceconfig.go:29)."""

    KIND = "VfioDeviceConfig"

    # "legacy" (/dev/vfio/<group>) or "iommufd" (/dev/vfio/devices/*).
    iommu_mode: str = "legacy"

    def normalize(self) -> None:
        if not self.iommu_mode:
            self.iommu_mode = "legacy"

    def validate(self) -> None:
        if self.iommu_mode not in ("legacy", "iommufd"):
            raise ValidationError(f"unknown iommu mode {self.iommu_mode!r}")


class AllocationMode(str, Enum):
    SINGLE = "Single"
    ALL = "All"


@dataclass
class ComputeDomainChannelConfig:
    """A workload's channel claim on a ComputeDomain
    (computedomainconfig.go:28-56)."""

    KIND = "ComputeDomainChannelConfig"

    domain_id: str = ""
    allocation_mode: str = AllocationMode.SINGLE.value

    def normalize(self) -> None:
        if not self.allocation_mode:
            self.allocation_mode = AllocationMode.SINGLE.value

    def validate(self) -> None:
        if not self.domain_id:
            raise ValidationError("domainID must be set")
        modes = [m.value for m in AllocationMode]
        if self.allocation_mode not in modes:
            raise ValidationError(
                f"unknown allocationMode {self.allocation_mode!r}")


@dataclass
class ComputeDomainDaemonConfig:
    """The daemon's claim on its ComputeDomain
    (computedomainconfig.go:58-86)."""

    KIND = "ComputeDomainDaemonConfig"

    domain_id: str = ""

    def normalize(self) -> None:
        pass

    def validate(self) -> None:
        if not self.domain_id:
            raise ValidationError("domainID must be set")
