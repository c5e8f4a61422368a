"""Stale-claim GC: unprepare the checkpointed claims that the API
server no longer has (the JAX package's ``kubeletplugin/cleanup.py``;
the upstream driver's ``cleanup.go``).

``cleanup_once`` is one pass; the reconcile sweep runs it first, so the
sweep's thread is the only periodic one (the JAX package's
``CheckpointCleanupManager`` keeps a thread of its own, which its driver
does not start either). ``DEFAULT_INTERVAL_S`` is the GC's interval,
``TPU_DRA_CLEANUP_INTERVAL_S`` (the upstream's 10 minutes, floor 0.5 s):
the sweep runs at least that often.

Each checkpointed claim is looked up by namespace, name and uid (one
GET, not a list; ``cleanup.go:149-190``); one that is gone, or that was
recreated under another uid, is unprepared through ``DeviceState``. An
API server that does not answer keeps every claim.
"""

from __future__ import annotations

import logging

from ..pkg import positive_float_env
from ..pkg.kubeclient import NotFoundError
from .checkpoint import ClaimState

logger = logging.getLogger(__name__)

DEFAULT_INTERVAL_S = positive_float_env(
    "TPU_DRA_CLEANUP_INTERVAL_S", default=600.0, floor=0.5)


def lookup_claim(kube, uid: str, namespace: str, name: str
                 ) -> tuple[str, dict | None]:
    """A checkpointed claim's identity against the API server:

    - ``("live", obj)``: the object exists with the same uid;
    - ``("gone", None)``: deleted, or recreated under another uid;
    - ``("unknown", None)``: no identity recorded, or the API server did
      not answer; the caller keeps its state.

    The GC and the reconcile sweep share it, so their idea of stale is
    one."""
    if not namespace or not name:
        return "unknown", None
    try:
        obj = kube.get("resource.k8s.io", "v1", "resourceclaims", name,
                       namespace=namespace)
    except NotFoundError:
        return "gone", None
    except Exception:  # noqa: BLE001 - API server unavailable: keep
        logger.exception("claim staleness check failed for %s/%s (%s)",
                         namespace, name, uid)
        return "unknown", None
    if obj.get("metadata", {}).get("uid") != uid:
        return "gone", None
    return "live", obj


def cleanup_once(device_state, kube, lookups=None) -> list[str]:
    """Unprepare the checkpointed claims that are gone; their uids.
    ``lookups`` holds ``lookup_claim`` results by uid that the caller
    already has (the reconcile sweep); a uid missing from it is looked
    up here."""
    removed = []
    for uid, claim in list(device_state.prepared_claims().items()):
        if not _is_stale(kube, uid, claim, lookups):
            continue
        logger.warning("unpreparing stale claim %s (%s/%s)", uid,
                       claim.namespace, claim.name)
        try:
            device_state.unprepare(uid)
            removed.append(uid)
        except Exception:  # noqa: BLE001 - GC must survive
            logger.exception("stale-claim unprepare failed for %s", uid)
    return removed


def _is_stale(kube, uid: str, claim, lookups) -> bool:
    if not claim.namespace or not claim.name:
        # No identity recorded: only a crashed prepare's record is safe
        # to reap.
        return claim.state == ClaimState.PREPARE_STARTED.value
    hit = lookups.get(uid) if lookups else None
    if hit is None:
        hit = lookup_claim(kube, uid, claim.namespace, claim.name)
    return hit[0] == "gone"
