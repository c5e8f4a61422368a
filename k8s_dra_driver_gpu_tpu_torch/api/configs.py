"""Opaque device-config types with normalize/validate (the JAX package's
``api/configs.py``; the upstream driver's
``api/nvidia.com/resource/v1beta1/{gpuconfig.go,sharing.go}``).

``GpuConfig`` is the config of a whole-GPU claim (the JAX package's
``TpuConfig``). Its ``Sharing`` union decodes and validates as there; the
kubelet plugin then runs only the default (time-slicing at the default
interval, which is what a GPU does unconfigured) and refuses any other
sharing with the ROADMAP item that ports it. The MIG and vfio configs
are not ported (``device_state.NOT_PORTED_KINDS``).
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
