"""PartitionSet: the declarative layout of tenant partitions for a pool
(the JAX package's ``pkg/partition/spec.py``).

A profile names a backing MIG profile as NVML names it (``subslice``,
e.g. ``1g.10gb``), the share of that instance's memory budgeted to its
tenants (``hbmFraction``) and the tenant slots (``maxTenants``). A
profile with more than one slot makes an oversubscribed device: its
published counters are divided by the slot count, so N tenant
allocations together consume at most what the MIG instance holds, and
the kubelet plugin caps each tenant's memory through the instance's MPS
daemon. The node-side engine (``engine.py``) creates a partition's MIG
instance at its first tenant's prepare and destroys it at its last
tenant's unprepare.

What differs from the JAX spec: ``subslice`` is a MIG profile name
(``<compute slices>g.<memory>gb``) where the JAX one names a TPU
carve-out (``1c`` or a chip grid). The file, the CRD and the device
names keep the JAX forms (``maxTenants``, ``hbmFraction``,
``pt-<profile>-<k>``), since one control plane writes them for the
cluster.
"""

from __future__ import annotations

import json
import re
from dataclasses import dataclass
from fnmatch import fnmatch

_PROFILE_NAME_RE = re.compile(r"^[a-z0-9]([a-z0-9-]*[a-z0-9])?$")
_MIG_PROFILE_RE = re.compile(r"^\d+g\.\d+gb$")


class PartitionSpecError(ValueError):
    """A PartitionSet that can never be realized (a config error)."""


@dataclass(frozen=True)
class PartitionProfile:
    """One desired partition shape. A tenant's memory ceiling is the MIG
    profile's memory x ``hbm_fraction`` / ``max_tenants`` (rounded down
    to whole MiB by the device, MPS's grain)."""

    name: str
    subslice: str  # the backing MIG profile, e.g. "1g.10gb"
    max_tenants: int = 1
    hbm_fraction: float = 1.0

    def validate(self) -> None:
        if not _PROFILE_NAME_RE.match(self.name):
            raise PartitionSpecError(
                f"invalid partition profile name {self.name!r} "
                "(lowercase alphanumerics and dashes)")
        if not _MIG_PROFILE_RE.match(self.subslice):
            raise PartitionSpecError(
                f"profile {self.name!r}: invalid backing MIG profile "
                f"{self.subslice!r} (want NVML's name, like '1g.10gb')")
        if self.max_tenants < 1:
            raise PartitionSpecError(
                f"profile {self.name!r}: maxTenants must be >= 1")
        if not 0.0 < self.hbm_fraction <= 1.0:
            raise PartitionSpecError(
                f"profile {self.name!r}: hbmFraction must be in (0, 1]")

    @property
    def oversubscribed(self) -> bool:
        return self.max_tenants > 1

    def to_dict(self) -> dict:
        return {"name": self.name, "subslice": self.subslice,
                "maxTenants": self.max_tenants,
                "hbmFraction": self.hbm_fraction}

    @classmethod
    def from_dict(cls, d: dict) -> "PartitionProfile":
        if not isinstance(d, dict):
            raise PartitionSpecError(
                f"partition profile {d!r}: expected an object")
        try:
            prof = cls(name=d.get("name", ""),
                       subslice=d.get("subslice", ""),
                       max_tenants=int(d.get("maxTenants", 1)),
                       hbm_fraction=float(d.get("hbmFraction", 1.0)))
        except (TypeError, ValueError) as e:
            raise PartitionSpecError(
                f"partition profile {d.get('name', '')!r}: {e}") from e
        prof.validate()
        return prof


@dataclass(frozen=True)
class PartitionSet:
    """Desired partition profiles for the pools matching ``pools``
    (fnmatch globs over pool names; empty matches every pool)."""

    profiles: tuple[PartitionProfile, ...] = ()
    pools: tuple[str, ...] = ()

    def validate(self) -> None:
        seen: set[str] = set()
        for prof in self.profiles:
            prof.validate()
            if prof.name in seen:
                raise PartitionSpecError(
                    f"duplicate partition profile name {prof.name!r}")
            seen.add(prof.name)

    def applies_to_pool(self, pool: str) -> bool:
        return not self.pools or any(fnmatch(pool, pat)
                                     for pat in self.pools)

    def to_dict(self) -> dict:
        return {"profiles": [p.to_dict() for p in self.profiles],
                "pools": list(self.pools)}

    @classmethod
    def from_dict(cls, d: dict) -> "PartitionSet":
        if not isinstance(d, dict):
            raise PartitionSpecError("partition set: expected an object")
        profiles, pools = d.get("profiles", []), d.get("pools", [])
        if not isinstance(profiles, list) or not isinstance(pools, list):
            raise PartitionSpecError(
                "partition set: profiles and pools must be lists")
        ps = cls(profiles=tuple(PartitionProfile.from_dict(p)
                                for p in profiles),
                 pools=tuple(str(p) for p in pools))
        ps.validate()
        return ps

    @classmethod
    def from_file(cls, path: str) -> "PartitionSet":
        """The operator's layout file (JSON, the ``to_dict`` form)."""
        try:
            with open(path, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            raise PartitionSpecError(
                f"unreadable partition set {path!r}: {e}") from e
        if not isinstance(doc, dict):
            raise PartitionSpecError(
                f"partition set {path!r}: expected a JSON object")
        return cls.from_dict(doc)


@dataclass
class PartitionDemand:
    """Observed or declared demand of one tenant (the sizing input of
    ``profiles.SizingPolicy`` and ``packing.pack_tenants``)."""

    hbm_bytes: int = 0
    cores: int = 1
    count: int = 1
    tenant: str = ""

    def to_dict(self) -> dict:
        return {"hbmBytes": self.hbm_bytes, "cores": self.cores,
                "count": self.count, "tenant": self.tenant}


def partition_device_name(profile: str, placement: int) -> str:
    """A partition device's name: ``pt-<profile>-<k>``, apart from the
    ``gpu-`` names of whole GPUs and MIG devices."""
    return f"pt-{profile}-{placement}"


_PT_RE = re.compile(r"^pt-([a-z0-9](?:[a-z0-9-]*[a-z0-9])?)-(\d+)$")


def parse_partition_device_name(name: str) -> tuple[str, int] | None:
    m = _PT_RE.match(name)
    if not m:
        return None
    return m.group(1), int(m.group(2))
