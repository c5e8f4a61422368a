"""Helpers of the kubelet plugin (the counterparts of the JAX package's
``pkg/`` modules that the node service needs): atomic JSON writes, a
file lock with a timeout, the node's boot id, the checkpoint's
claim-state machine and the prepare timer; the feature gates
(``featuregates``); the kube client with its streamed watch and its fake
API server (``kubeclient``, ``fakeapiserver``), a list-and-watch cache
(``informer``), ResourceSlice publication by content hash
(``sliceutil``), the two claim helpers of the reconcile sweep
(``recovery``), and tenant partitions (``partition``: the PartitionSet
spec, the engine, the CRD watcher); for the ComputeDomain stack a keyed
retrying work queue (``workqueue``) and Warning Events (``events``).
Standard library only."""

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
