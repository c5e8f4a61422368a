"""Tenant partitions over MIG instances (the JAX package's
``pkg/partition``): ``spec`` (the PartitionSet layout), ``profiles``
(the MISO tenant-profile store and sizing policy), ``packing`` (ParvaGPU
co-location), ``engine`` (the node-side MIG instance lifecycle and the
publishable devices) and ``watch`` (the PartitionSet CRD watcher)."""

from .packing import PackingPlan, pack_tenants
from .profiles import (DEFAULT_TENANT_DEMANDS, TENANT_PROFILE_ANNOTATION,
                       SizingPolicy, TenantProfileStore)
from .spec import (PartitionDemand, PartitionProfile, PartitionSet,
                   PartitionSpecError, parse_partition_device_name,
                   partition_device_name)

__all__ = [
    "DEFAULT_TENANT_DEMANDS",
    "TENANT_PROFILE_ANNOTATION",
    "PackingPlan",
    "PartitionDemand",
    "PartitionProfile",
    "PartitionSet",
    "PartitionSpecError",
    "SizingPolicy",
    "TenantProfileStore",
    "pack_tenants",
    "parse_partition_device_name",
    "partition_device_name",
]
