"""Helpers of the kubelet plugin (the counterparts of the JAX package's
``pkg/`` modules that the node service needs): atomic JSON writes, a
file lock with a timeout, the node's boot id, the checkpoint's
claim-state machine and the prepare timer; the feature gates
(``featuregates``); the kube client with its streamed watch and its fake
API server (``kubeclient``, ``fakeapiserver``), a list-and-watch cache
(``informer``), ResourceSlice publication by content hash
(``sliceutil``), the permanent-failure recovery controller and the
claim helpers of the reconcile sweep (``recovery``, its records under
``statemachine.EVICTION_POLICY``), fault injection (``faults``), the
fleet telemetry ring and aggregator (``fleetstate``), telemetry anomaly
detection (``anomaly``), tenant partitions (``partition``: the PartitionSet
spec, the tenant-profile store and sizing, packing, the engine, the CRD
watcher) and the serving autoscaler (``autoscale``: the CRD, the
forecaster, the planner and the controller); for the ComputeDomain stack a keyed
retrying work queue (``workqueue``) and Warning Events (``events``).
Observability: claim-lifecycle spans (``tracing``), the per-claim
flight recorder (``flightrecorder``), the Prometheus metrics
(``metrics``) on the port's own registry and text format
(``exposition``), served with the debug routes by ``httpserver`` and
``debug``, and the logging contract (``logsetup``). For the binaries:
the retrying kube client with its circuit breaker (``retry``) and the
Lease leader election (``leaderelection``). Standard library only."""

from __future__ import annotations

import logging
import os


def positive_float_env(var: str, default: float, floor: float) -> float:
    """An operator knob from the env (the JAX package's ``pkg``): a value
    that is not a number gives ``default``, one that is not positive
    (NaN too) gives ``floor``, so no loop that waits on it busy-spins."""
    raw = os.environ.get(var, "")
    try:
        val = float(raw)
    except ValueError:
        if raw:
            logging.getLogger(__name__).warning(
                "ignoring non-numeric %s=%r", var, raw)
        return default
    if not val > 0:
        logging.getLogger(__name__).warning(
            "clamping %s=%s to %s", var, raw, floor)
        return floor
    return val
