"""ResourceSlice publication for one (driver, node) pool, by content
hash (the JAX package's ``pkg/sliceutil.py``, whole; the upstream
kubeletplugin helper's PublishResources, ``driver.go:455``).

One publish stamps one pool generation on every slice of the pool and
deletes this driver's slices of the node that are no longer wanted
(after a publication-mode change, say), so no stale slice shadows the
pool at a higher generation.

The desired specs are compared with the live ones by a hash of the spec
with the pool generation masked out (``slice_content_hash``):

- a converged set costs zero writes;
- a content-only change on the same inventory (a taint, an attribute)
  rewrites only the changed slices, at the current generation: the
  scheduler reads a generation bump as inventory churn and re-evaluates
  the whole pool;
- a change of inventory (a device or slice added, removed or moved)
  writes the whole set at the next generation and deletes stale slices.
"""

from __future__ import annotations

import hashlib
import json

from .kubeclient import NotFoundError

RESOURCE_GROUP = "resource.k8s.io"
RESOURCE_VERSION = "v1"


def slice_content_hash(obj: dict) -> str:
    """Canonical content hash of a ResourceSlice's spec with the pool
    generation masked out: two slices that differ only by generation
    (or metadata bookkeeping) hash identically."""
    spec = dict(obj.get("spec", {}))
    pool = dict(spec.get("pool") or {})
    pool.pop("generation", None)
    spec["pool"] = pool
    blob = json.dumps(spec, sort_keys=True, separators=(",", ":"))
    return hashlib.sha256(blob.encode()).hexdigest()


def _device_names(obj: dict) -> list[str]:
    return [d.get("name", "") for d in obj.get("spec", {}).get(
        "devices", [])]


def _existing_pool_slices(kube, driver: str, node_name: str) -> list[dict]:
    # ResourceSlice supports spec.driver/spec.nodeName field selectors;
    # scope the list server-side so an N-node rollout doesn't make every
    # node fetch the whole cluster's slices. Client-side filter retained
    # as a belt for clients that ignore the selector.
    items = kube.list(
        RESOURCE_GROUP, RESOURCE_VERSION, "resourceslices",
        field_selector=f"spec.driver={driver},spec.nodeName={node_name}",
    )
    return [
        s for s in items
        if s.get("spec", {}).get("driver") == driver
        and s.get("spec", {}).get("nodeName") == node_name
    ]


def publish_resource_slices(kube, slices: list[dict], on_skip=None) -> dict:
    """Publish the desired slice set for one (driver, node) pool.

    All slices must belong to the same driver/node. An empty set is a
    no-op (the pool identity would be unknown): a driver with zero
    devices still publishes one slice with an empty device list rather
    than an empty set, which is what both in-tree drivers do.

    The desired set is compared against the live set by content hash:

    - identical -> zero writes (``skipped`` counts the no-op PUTs
      avoided; ``on_skip(n)`` is called with them, for the metrics).
    - same slice names AND same per-slice device-name inventory at one
      shared generation -> only the changed slices are rewritten, at
      the CURRENT generation (no bump: taint/attribute updates are not
      inventory churn).
    - anything else (slices added/removed, devices added/removed/moved,
      or a previously inconsistent pool) -> the whole set is written at
      max(existing)+1 and stale slices are deleted.

    Returns ``{"writes", "deletes", "skipped", "generation",
    "changed"}``.
    """
    stats = {"writes": 0, "deletes": 0, "skipped": 0,
             "generation": None, "changed": False}
    if not slices:
        return stats
    driver = slices[0]["spec"]["driver"]
    node_name = slices[0]["spec"]["nodeName"]
    existing = _existing_pool_slices(kube, driver, node_name)
    existing_by_name = {s["metadata"]["name"]: s for s in existing}
    desired_names = {obj["metadata"]["name"] for obj in slices}
    existing_gens = {
        s["spec"].get("pool", {}).get("generation", 0) for s in existing
    }

    if desired_names == set(existing_by_name) and \
            len(existing_gens) == 1:
        unchanged = {
            name for name in desired_names
            if slice_content_hash(existing_by_name[name])
            == slice_content_hash(next(
                o for o in slices if o["metadata"]["name"] == name))
        }
        generation = next(iter(existing_gens))
        if len(unchanged) == len(desired_names):
            # Fully converged: zero kube writes, generation untouched.
            stats["skipped"] = len(slices)
            stats["generation"] = generation
            if on_skip is not None:
                on_skip(len(slices))
            return stats
        same_inventory = all(
            _device_names(obj)
            == _device_names(existing_by_name[obj["metadata"]["name"]])
            for obj in slices
        )
        if same_inventory:
            # Content-only change (taints, attributes): rewrite just
            # the changed slices at the CURRENT generation -- device
            # inventory did not change, so consumers must not see a
            # pool-generation bump.
            for obj in slices:
                name = obj["metadata"]["name"]
                obj["spec"]["pool"]["generation"] = generation
                if name in unchanged:
                    stats["skipped"] += 1
                    continue
                try:
                    kube.update(RESOURCE_GROUP, RESOURCE_VERSION,
                                "resourceslices", name, obj)
                except NotFoundError:
                    kube.create(RESOURCE_GROUP, RESOURCE_VERSION,
                                "resourceslices", obj)
                stats["writes"] += 1
            stats["generation"] = generation
            stats["changed"] = True
            if on_skip is not None and stats["skipped"]:
                on_skip(stats["skipped"])
            return stats

    # Inventory change: one new shared pool
    # generation over the whole desired set; stale slices deleted so
    # they can never shadow the pool at a higher generation.
    generation = 1 + max(existing_gens, default=0)
    for obj in slices:
        name = obj["metadata"]["name"]
        obj["spec"]["pool"]["generation"] = generation
        if name in existing_by_name:
            try:
                kube.update(
                    RESOURCE_GROUP, RESOURCE_VERSION, "resourceslices",
                    name, obj
                )
            except NotFoundError:
                kube.create(
                    RESOURCE_GROUP, RESOURCE_VERSION, "resourceslices", obj
                )
        else:
            kube.create(
                RESOURCE_GROUP, RESOURCE_VERSION, "resourceslices", obj
            )
        stats["writes"] += 1
    for name in existing_by_name:
        if name not in desired_names:
            kube.delete(RESOURCE_GROUP, RESOURCE_VERSION,
                        "resourceslices", name)
            stats["deletes"] += 1
    stats["generation"] = generation
    stats["changed"] = True
    return stats
