"""Tenant partitions over MIG instances (the JAX package's
``pkg/partition``): ``spec`` (the PartitionSet layout), ``engine`` (the
node-side MIG instance lifecycle and the publishable devices) and
``watch`` (the PartitionSet CRD watcher). The JAX planner's
``profiles`` (sizing) and ``packing`` wait for tenant telemetry
(ROADMAP.md §1b)."""

from .spec import (PartitionDemand, PartitionProfile, PartitionSet,
                   PartitionSpecError, parse_partition_device_name,
                   partition_device_name)

__all__ = [
    "PartitionDemand",
    "PartitionProfile",
    "PartitionSet",
    "PartitionSpecError",
    "parse_partition_device_name",
    "partition_device_name",
]
