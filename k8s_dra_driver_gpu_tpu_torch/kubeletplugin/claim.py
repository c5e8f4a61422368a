"""The slice of a resource.k8s.io ResourceClaim the plugin reads (the JAX
package's ``kubeletplugin/claim.py``): uid, namespace and name, the
allocation results for this driver, and its opaque configs with their
request scoping and source (upstream ``device_state.go:689-776``)."""

from __future__ import annotations

from dataclasses import dataclass, field

from . import DRIVER_NAME


@dataclass(frozen=True)
class DeviceResult:
    """One allocated device (status.allocation.devices.results[i])."""

    request: str
    driver: str
    pool: str
    device: str  # the device's name in the ResourceSlice


@dataclass(frozen=True)
class OpaqueConfig:
    """One opaque config entry with its request scoping and source."""

    parameters: dict
    requests: tuple[str, ...]  # empty: every request
    source: str  # "FromClass" | "FromClaim"

    def applies_to(self, request: str) -> bool:
        return not self.requests or request in self.requests


@dataclass
class ResourceClaim:
    uid: str
    namespace: str = "default"
    name: str = ""
    results: list[DeviceResult] = field(default_factory=list)
    configs: list[OpaqueConfig] = field(default_factory=list)
    annotations: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, obj: dict, driver: str = DRIVER_NAME
                  ) -> "ResourceClaim":
        """The claim of a ResourceClaim object; results and configs of
        other drivers are dropped (an entry without a driver is ours)."""
        meta = obj.get("metadata", {})
        alloc = (obj.get("status") or {}).get("allocation") or {}
        devices = alloc.get("devices") or {}
        results = [
            DeviceResult(request=r.get("request", ""),
                         driver=r.get("driver", ""), pool=r.get("pool", ""),
                         device=r.get("device", ""))
            for r in devices.get("results", [])
            if r.get("driver", driver) == driver
        ]
        configs = []
        for c in devices.get("config", []):
            opaque = c.get("opaque") or {}
            if opaque.get("driver", driver) != driver:
                continue
            configs.append(OpaqueConfig(
                parameters=opaque.get("parameters", {}),
                requests=tuple(c.get("requests", [])),
                source=c.get("source", "FromClaim")))
        return cls(uid=meta.get("uid", ""),
                   namespace=meta.get("namespace", "default"),
                   name=meta.get("name", ""), results=results,
                   configs=configs,
                   annotations=dict(meta.get("annotations") or {}))
