"""The serving autoscaler: the demand-driven PartitionSet control plane
(the JAX package's ``pkg/autoscale``).

- ``crd.py``: the cluster-scoped ``partitionsets.resource.tpu.dra``
  CRD, the fleet-wide desired partition layout, with its priority rules
  and its managed, revision and pre-warm annotations.
- ``planner.py``: MISO sizing (2207.11428) over the demand percentiles
  with a hysteresis band and CEL-selected priority isolation.
- ``forecast.py``: the per-pool pre-warm forecast from the fleet rings.
- ``controller.py``: the re-planning controller the scheduler's pass
  drives (``DraScheduler.attach_autoscaler``), its rollouts durable
  under the ``autoscale`` TransitionPolicy.
- ``PartitionSetWatcher``: the node's CRD watcher, which lives in
  ``pkg/partition/watch.py`` and is re-exported here as the JAX package
  exports its ``nodewatch.py``.
"""

from .controller import AutoscaleController
from .crd import (AUTOSCALE_CRD_GROUP, AUTOSCALE_CRD_KIND,
                  AUTOSCALE_CRD_RESOURCE, AUTOSCALE_CRD_VERSION,
                  MANAGED_ANNOTATION, PriorityRule, crd_object, fingerprint,
                  partition_set_from_crd, select_for_pool)
from .planner import AutoscalePlanner, PlanResult, pool_chip_caps

__all__ = [
    "AUTOSCALE_CRD_GROUP",
    "AUTOSCALE_CRD_KIND",
    "AUTOSCALE_CRD_RESOURCE",
    "AUTOSCALE_CRD_VERSION",
    "MANAGED_ANNOTATION",
    "AutoscaleController",
    "AutoscalePlanner",
    "PartitionSetWatcher",
    "PlanResult",
    "PriorityRule",
    "crd_object",
    "fingerprint",
    "partition_set_from_crd",
    "pool_chip_caps",
    "select_for_pool",
]


def __getattr__(name: str):
    # Read at first use: ``pkg/partition/watch.py`` imports ``crd`` from
    # this package, so an eager import here would be circular.
    if name == "PartitionSetWatcher":
        from ..partition.watch import PartitionSetWatcher  # noqa: PLC0415
        return PartitionSetWatcher
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
