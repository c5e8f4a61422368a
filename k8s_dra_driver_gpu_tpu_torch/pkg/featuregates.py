"""Feature gates of the driver: the JAX package's gate names and
defaults (its ``pkg/featuregates.py``; the upstream driver's
``pkg/featuregates/featuregates.go``), so one ``FEATURE_GATES`` string
means the same to every binary of both packages.

The GPU plugin reads five: ``TimeSlicingSettings`` and
``MultiTenancySupport`` (the upstream's ``MPSSupport``), which needs the
first, as in both; ``DynamicSubSlice`` (the upstream's ``DynamicMIG``):
MIG devices created at prepare; ``TenantPartitioning``: tenant
partitions over MIG instances (``pkg/partition``), which needs
``DynamicSubSlice``, as in the JAX package; and ``PassthroughSupport``:
GPUs published for vfio passthrough (``kubeletplugin/vfio.py``). The ComputeDomain daemon
reads two: ``ComputeDomainCliques`` (registration in clique objects, or
in the domain's status when off) and ``DomainDaemonsWithDNSNames`` (the
upstream's ``IMEXDaemonsWithDNSNames``: a peer change rewrites the hosts
file and nudges the rendezvous service, or restarts it when off). The
scheduler reads one: ``TopologyAwarePlacement`` (the ICI scorer orders
each request's candidates; off, first-fit). Any other gate set away from its default names a feature the port does not
run: ``unported()`` lists it and the GPU plugin's ``DeviceState`` refuses
it (``NotPortedError``). Upstream counterparts of the others:
``ChipHealthCheck`` is ``NVMLDeviceHealthCheck``,
``CrashOnICIFabricErrors`` is ``CrashOnNVLinkFabricErrors``;
``PassthroughSupport`` and ``DeviceMetadata`` keep their names;
``TenantPartitioning`` and ``TopologyAwarePlacement`` have none.
"""

from __future__ import annotations

from dataclasses import dataclass, field

TIME_SLICING_SETTINGS = "TimeSlicingSettings"
MULTI_TENANCY_SUPPORT = "MultiTenancySupport"
DYNAMIC_SUB_SLICE = "DynamicSubSlice"
TENANT_PARTITIONING = "TenantPartitioning"
COMPUTE_DOMAIN_CLIQUES = "ComputeDomainCliques"
DOMAIN_DAEMONS_WITH_DNS_NAMES = "DomainDaemonsWithDNSNames"
TOPOLOGY_AWARE_PLACEMENT = "TopologyAwarePlacement"
PASSTHROUGH_SUPPORT = "PassthroughSupport"
# The gates the port reads: the GPU plugin's five, the ComputeDomain
# daemon's two, the scheduler's one.
READ = (TIME_SLICING_SETTINGS, MULTI_TENANCY_SUPPORT, DYNAMIC_SUB_SLICE,
        TENANT_PARTITIONING, PASSTHROUGH_SUPPORT, COMPUTE_DOMAIN_CLIQUES,
        DOMAIN_DAEMONS_WITH_DNS_NAMES, TOPOLOGY_AWARE_PLACEMENT)
# gate -> the gate it needs on.
REQUIRES = {MULTI_TENANCY_SUPPORT: TIME_SLICING_SETTINGS,
            TENANT_PARTITIONING: DYNAMIC_SUB_SLICE}
# gate -> the gate it cannot be on with: a GPU bound to vfio-pci cannot
# be carved into MIG devices by this driver at the same time.
CONFLICTS = {PASSTHROUGH_SUPPORT: DYNAMIC_SUB_SLICE}

# Every gate of the JAX plugin, by its default.
DEFAULTS: dict[str, bool] = {
    TIME_SLICING_SETTINGS: False,
    MULTI_TENANCY_SUPPORT: False,
    DOMAIN_DAEMONS_WITH_DNS_NAMES: True,
    PASSTHROUGH_SUPPORT: False,
    "ChipHealthCheck": True,
    DYNAMIC_SUB_SLICE: False,
    TENANT_PARTITIONING: False,
    COMPUTE_DOMAIN_CLIQUES: True,
    "CrashOnICIFabricErrors": True,
    "DeviceMetadata": False,
    TOPOLOGY_AWARE_PLACEMENT: True,
}


class FeatureGateError(ValueError):
    pass


@dataclass(frozen=True)
class FeatureGates:
    """The gates a spec set; the others keep their defaults."""

    enabled: dict[str, bool] = field(default_factory=dict)

    def is_enabled(self, name: str) -> bool:
        if name not in DEFAULTS:
            raise FeatureGateError(f"unknown feature gate {name!r}")
        return self.enabled.get(name, DEFAULTS[name])

    def unported(self) -> list[str]:
        """The gates set away from their default that the port does not
        read."""
        return [name for name, value in self.enabled.items()
                if name not in READ and value != DEFAULTS[name]]

    @classmethod
    def parse(cls, spec: str) -> "FeatureGates":
        """Parse "Gate1=true,Gate2=false" (k8s-style; the later entry of a
        gate wins). The empty string gives the defaults."""
        enabled: dict[str, bool] = {}
        for item in filter(None, (p.strip() for p in spec.split(","))):
            if "=" not in item:
                raise FeatureGateError(
                    f"invalid feature gate spec {item!r}: expected Name=bool"
                )
            name, _, val = item.partition("=")
            name, val = name.strip(), val.strip().lower()
            if val not in ("true", "false"):
                raise FeatureGateError(
                    f"invalid value {val!r} for feature gate {name!r}"
                )
            enabled[name] = val == "true"
        for name in enabled:
            if name not in DEFAULTS:
                raise FeatureGateError(f"unknown feature gate {name!r}")
        gates = cls(enabled=enabled)
        for gate, needed in REQUIRES.items():
            if gates.is_enabled(gate) and not gates.is_enabled(needed):
                raise FeatureGateError(
                    f"feature gate {gate} requires {needed} to be enabled")
        for gate, other in CONFLICTS.items():
            if gates.is_enabled(gate) and gates.is_enabled(other):
                raise FeatureGateError(
                    f"feature gates {gate} and {other} are mutually "
                    "exclusive")
        return gates
