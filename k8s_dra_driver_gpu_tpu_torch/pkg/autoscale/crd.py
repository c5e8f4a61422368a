"""The PartitionSet CRD: the fleet-wide desired partition layout (the
JAX package's ``pkg/autoscale/crd.py``).

Cluster-scoped ``partitionsets.resource.tpu.dra/v1beta1`` objects (kind
``PartitionSet``; the JAX group, version, kind and annotation keys, since
one control plane writes them for the cluster) carry the spec of the
node-local layout file (``profiles`` and ``pools``) and the autoscaler's
operator inputs:

- ``spec.priorityRules``: ``{"selector": <CEL>, "priority": <int>}``
  entries, compiled by ``pkg/cel.py``; the expression sees ``tenant``
  (``{"key", "hbmBytes", "cores"}``). A tenant matching a rule of
  priority > 0 is latency-critical: the planner sizes it against
  profiles of one tenant slot only.
- ``metadata.annotations["resource.tpu.dra/autoscale-managed"]``:
  ``"true"`` on CRDs the controller owns; an operator flips it to
  ``"false"`` to take manual control. The controller never rewrites a
  CRD it did not create.
- ``resource.tpu.dra/autoscale-revision``: bumped by each applied
  re-plan (observability; the spec's fingerprint is the identity).
- ``resource.tpu.dra/prewarm``: the forecaster's advisory hint, JSON
  ``{"<pool glob>": {"<profile>": count}}``; an annotation, so it moves
  neither the fingerprint nor the layout.

A node picks the CRD that governs its pool: the lexicographically first
by name among those whose ``spec.pools`` globs match it, so an
operator's ``00-manual-override`` outranks ``tpu-dra-autoscale``. A
malformed winner fails closed (the watcher keeps its last good plan).
What differs from the JAX module: ``spec.pools`` is read leniently even
where ``spec`` is no object (the winner is then found, and malformed),
and a ``priorityRules`` that is no list is refused by name.
"""

from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass
from fnmatch import fnmatch
from functools import lru_cache

from ..cel import CelEvalError, CelParseError, compile_expression
from ..partition.spec import PartitionSet, PartitionSpecError

AUTOSCALE_CRD_GROUP = "resource.tpu.dra"
AUTOSCALE_CRD_VERSION = "v1beta1"
AUTOSCALE_CRD_RESOURCE = "partitionsets"
AUTOSCALE_CRD_KIND = "PartitionSet"

MANAGED_ANNOTATION = "resource.tpu.dra/autoscale-managed"
REVISION_ANNOTATION = "resource.tpu.dra/autoscale-revision"
PREWARM_ANNOTATION = "resource.tpu.dra/prewarm"


@lru_cache(maxsize=256)
def _compiled_selector(selector: str):
    """One program per distinct rule source: ``matches`` runs per tenant
    per rule per pass over expressions that never change."""
    return compile_expression(selector)


@dataclass(frozen=True)
class PriorityRule:
    """One CEL-selected tenant priority class."""

    selector: str
    priority: int

    def to_dict(self) -> dict:
        return {"selector": self.selector, "priority": self.priority}

    def matches(self, tenant: str, hbm_bytes: int, cores: int) -> bool:
        """The selector on one tenant; an error reads as no match, so a
        broken rule never grants or denies priority by a crash."""
        try:
            result = _compiled_selector(self.selector).evaluate(
                {"tenant": {"key": tenant, "hbmBytes": hbm_bytes,
                            "cores": cores}})
        except (CelParseError, CelEvalError):
            return False
        return result is True


def parse_priority_rules(raw) -> tuple[PriorityRule, ...]:
    """Strict parse of ``spec.priorityRules``; PartitionSpecError on a
    malformed rule (the whole CRD then fails closed)."""
    if raw is not None and not isinstance(raw, list):
        raise PartitionSpecError("priorityRules: want a list")
    rules = []
    for i, entry in enumerate(raw or []):
        if not isinstance(entry, dict) or not entry.get("selector"):
            raise PartitionSpecError(
                f"priorityRules[{i}]: want {{selector, priority}}")
        selector = str(entry["selector"])
        try:
            compile_expression(selector)
        except CelParseError as e:
            raise PartitionSpecError(
                f"priorityRules[{i}]: bad CEL selector "
                f"{selector!r}: {e}") from e
        try:
            priority = int(entry.get("priority", 0))
        except (TypeError, ValueError) as e:
            raise PartitionSpecError(
                f"priorityRules[{i}]: priority must be an int") from e
        rules.append(PriorityRule(selector=selector, priority=priority))
    return tuple(rules)


def partition_set_from_crd(obj: dict) -> tuple[PartitionSet,
                                               tuple[PriorityRule, ...]]:
    """Strict parse of one CRD: its PartitionSet and priority rules.
    PartitionSpecError on anything malformed (the caller fails closed)."""
    spec = obj.get("spec")
    if not isinstance(spec, dict):
        raise PartitionSpecError(
            f"PartitionSet {obj.get('metadata', {}).get('name')!r}: "
            "missing spec")
    ps = PartitionSet.from_dict(spec)
    return ps, parse_priority_rules(spec.get("priorityRules"))


def fingerprint(spec: dict) -> str:
    """The content identity of a CRD spec (key order does not count):
    the rollout's confirmation and the steady state's no-write check
    both compare it."""
    return hashlib.sha256(
        json.dumps(spec, sort_keys=True).encode()).hexdigest()[:16]


def spec_dict(partition_set: PartitionSet,
              priority_rules: tuple[PriorityRule, ...] = ()) -> dict:
    out = partition_set.to_dict()
    if priority_rules:
        out["priorityRules"] = [r.to_dict() for r in priority_rules]
    return out


def crd_object_from_spec(name: str, spec: dict, revision: int = 1,
                         managed: bool = True) -> dict:
    """The managed CRD object: the one place its apiVersion, kind and
    metadata are written (``crd_object`` and the controller's create)."""
    return {
        "apiVersion": f"{AUTOSCALE_CRD_GROUP}/{AUTOSCALE_CRD_VERSION}",
        "kind": AUTOSCALE_CRD_KIND,
        "metadata": {"name": name, "annotations": {
            MANAGED_ANNOTATION: "true" if managed else "false",
            REVISION_ANNOTATION: str(revision)}},
        "spec": spec,
    }


def crd_object(name: str, partition_set: PartitionSet,
               priority_rules: tuple[PriorityRule, ...] = (),
               revision: int = 1, managed: bool = True) -> dict:
    return crd_object_from_spec(
        name, spec_dict(partition_set, priority_rules),
        revision=revision, managed=managed)


def is_managed(obj: dict) -> bool:
    ann = obj.get("metadata", {}).get("annotations") or {}
    return ann.get(MANAGED_ANNOTATION) == "true"


def prewarm_value(hints: dict[str, dict[str, int]]) -> str:
    """The annotation's canonical (sorted) form of pool -> profile ->
    count hints; "" means no annotation."""
    cleaned = {
        pool: {prof: int(n) for prof, n in profs.items() if int(n) > 0}
        for pool, profs in (hints or {}).items()}
    cleaned = {pool: profs for pool, profs in cleaned.items() if profs}
    return json.dumps(cleaned, sort_keys=True) if cleaned else ""


def prewarm_hints_of(obj: dict | None, pool: str) -> dict[str, int]:
    """``{profile: count}`` this pool should keep warm, from the CRD's
    pre-warm annotation (pool keys are globs); a malformed annotation
    reads as no hint."""
    raw = ((obj or {}).get("metadata", {}).get("annotations")
           or {}).get(PREWARM_ANNOTATION)
    if not raw:
        return {}
    try:
        parsed = json.loads(raw)
    except (TypeError, ValueError):
        return {}
    if not isinstance(parsed, dict):
        return {}
    out: dict[str, int] = {}
    for pat, profs in parsed.items():
        if not isinstance(profs, dict) or not fnmatch(pool, str(pat)):
            continue
        for prof, count in profs.items():
            try:
                n = int(count)
            except (TypeError, ValueError):
                continue
            if n > 0:
                out[str(prof)] = max(out.get(str(prof), 0), n)
    return out


def revision_of(obj: dict) -> int:
    ann = obj.get("metadata", {}).get("annotations") or {}
    try:
        return int(ann.get(REVISION_ANNOTATION, 0))
    except (TypeError, ValueError):
        return 0


def applies_to_pool(obj: dict, pool: str) -> bool:
    """Whether ``obj``'s ``spec.pools`` globs match ``pool`` (no globs:
    every pool), read leniently so that a winner malformed elsewhere is
    found, and fails closed, instead of being passed over."""
    spec = obj.get("spec")
    pools = spec.get("pools") if isinstance(spec, dict) else None
    if not isinstance(pools, list) or not pools:
        return True
    return any(fnmatch(pool, str(pat)) for pat in pools)


def select_for_pool(objs: list[dict], pool: str
                    ) -> tuple[str, object, dict | None]:
    """The CRD governing ``pool``, the first by name of those that apply:
    ``("ok", (partition_set, rules, fingerprint), obj)``,
    ``("malformed", error, obj)`` (keep the last good plan) or
    ``("none", None, None)`` (the bootstrap plan)."""
    matching = sorted((o for o in objs if applies_to_pool(o, pool)),
                      key=lambda o: o.get("metadata", {}).get("name", ""))
    if not matching:
        return "none", None, None
    winner = matching[0]
    try:
        ps, rules = partition_set_from_crd(winner)
    except PartitionSpecError as e:
        return "malformed", str(e), winner
    return "ok", (ps, rules, fingerprint(winner.get("spec", {}))), winner
