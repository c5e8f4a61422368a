"""The two claim helpers of the node's reconcile sweep (the JAX
package's ``pkg/recovery.py``, ``allocation_nodes`` ``:171`` and
``set_permanent_failure_condition`` ``:299``).

The rest of that module (the failure detector, the eviction and
migration controller and its durable records) is the control plane's,
and is not ported.
"""

from __future__ import annotations

from .kubeclient import ConflictError, NotFoundError

RESOURCE = ("resource.k8s.io", "v1")
# The claim condition a node or the eviction controller declares when a
# claim's hardware is gone for good.
PERMANENT_FAILURE_CONDITION = "PermanentFailure"


def _meta(obj: dict) -> dict:
    return obj.get("metadata") or {}


def allocation_nodes(claim: dict) -> set[str]:
    """The node names an allocation pins (its nodeSelector's
    ``metadata.name`` match fields)."""
    alloc = claim.get("status", {}).get("allocation") or {}
    nodes: set[str] = set()
    for term in alloc.get("nodeSelector", {}).get("nodeSelectorTerms", []):
        for mf in term.get("matchFields", []):
            if mf.get("key") == "metadata.name":
                nodes.update(mf.get("values") or [])
    return nodes


def set_permanent_failure_condition(kube, claim: dict, status: str,
                                    reason: str, message: str) -> bool:
    """Set the claim's PermanentFailure condition, unless it already
    says this status and reason. Returns True when a patch was written;
    False too when the claim is gone or the write conflicted (the next
    sweep looks again)."""
    ns = _meta(claim).get("namespace", "default")
    name = _meta(claim).get("name", "")
    conditions = claim.get("status", {}).get("conditions") or []
    for c in conditions:
        if c.get("type") == PERMANENT_FAILURE_CONDITION and \
                c.get("status") == status and c.get("reason") == reason:
            return False
    kept = [c for c in conditions
            if c.get("type") != PERMANENT_FAILURE_CONDITION]
    kept.append({"type": PERMANENT_FAILURE_CONDITION, "status": status,
                 "reason": reason, "message": message})
    try:
        kube.patch(*RESOURCE, "resourceclaims", name,
                   {"status": {"conditions": kept}}, namespace=ns)
    except (NotFoundError, ConflictError):
        return False
    return True
