"""The node's PartitionSet CRD watcher: CRD changes -> engine re-plan
(the JAX package's ``pkg/autoscale/nodewatch.py``).

An informer follows the cluster-scoped ``partitionsets.resource.tpu.dra``
(the CRD of ``pkg/autoscale/crd.py``, whose selection, fingerprint and
pre-warm hint this module uses). On every change it selects the CRD that
governs this node's pool (the lexicographically first by name among
those whose ``spec.pools`` globs match it), fingerprints its spec, and
converges the node onto it through ``apply_fn``
(``Driver.apply_partition_set``, which republishes through the
content-hash diff, so a converged re-apply costs no write). The
bootstrap plan (``Config.partition_set``) is the plan while no CRD
governs the pool, and the one the node reverts to when the governing CRD
is deleted.

It fails closed: a malformed winning CRD (a bad CEL selector in its
``spec.priorityRules`` too), or a plan the engine refuses
(``PartitionSpecError``: a MIG profile this host does not offer, a
re-shape of a held device), keeps the last good plan; ``last_error``
names why, and ``failed_total`` counts each distinct error once. Any
other failure of an apply (the node lock's time limit, a republish the
API server refused) is not memoized, where the JAX watcher counts the
plan as applied: the next event or resync applies it again. The
winning CRD's pre-warm annotation (``resource.tpu.dra/prewarm``) goes to
``prewarm_fn`` (``Driver.apply_prewarm``) after the plan. The
``autoscale`` package re-exports this class, as the JAX package does.

Not ported: the watcher's metrics.
"""

from __future__ import annotations

import logging
import threading

from ..autoscale.crd import (AUTOSCALE_CRD_GROUP, AUTOSCALE_CRD_RESOURCE,
                             AUTOSCALE_CRD_VERSION, fingerprint,
                             prewarm_hints_of, select_for_pool)
from ..informer import Informer
from .spec import PartitionSet, PartitionSpecError

logger = logging.getLogger(__name__)

# The informer's full relist, which converges a node that missed an
# event (the JAX watcher's period).
RESYNC_PERIOD_S = 300.0


class PartitionSetWatcher:
    """Follows the PartitionSet CRDs and applies the winning plan for one
    pool through ``apply_fn``."""

    def __init__(self, kube, pool: str, apply_fn,
                 bootstrap: PartitionSet | None = None, prewarm_fn=None):
        self.pool = pool
        self._apply_fn = apply_fn
        self._prewarm_fn = prewarm_fn
        self._applied_prewarm: dict[str, int] | None = None
        self._bootstrap = bootstrap
        self._bootstrap_fp = fingerprint(bootstrap.to_dict()) \
            if bootstrap is not None else None
        # The applied plan's fingerprint: the bootstrap's (applied by
        # DeviceState's construction) until a CRD's.
        self._applied_fp: str | None = self._bootstrap_fp
        self._lock = threading.Lock()
        # One reconcile at a time, from its selection on: the informer's
        # watch and resync threads both reconcile, and a selection read
        # before another thread's apply must not undo it.
        self._reconcile_lock = threading.Lock()
        # Notified after every reconcile (wait_for).
        self._cond = threading.Condition()
        self.last_error: str | None = None
        self.applied_total = 0
        self.failed_total = 0
        self.reconciles = 0
        self._informer = Informer(kube, AUTOSCALE_CRD_GROUP,
                                  AUTOSCALE_CRD_VERSION,
                                  AUTOSCALE_CRD_RESOURCE,
                                  resync_period=RESYNC_PERIOD_S)
        self._informer.add_event_hook(self._on_event)
        self._started = False

    def start(self) -> "PartitionSetWatcher":
        """List, follow, and converge onto the cluster's current plan
        before returning (a restarted plugin reaches the same plan as a
        live one)."""
        self._started = True
        self._informer.start()
        self.reconcile()
        return self

    def stop(self) -> None:
        """End the watch; join its threads."""
        self._informer.stop()

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return self._informer.wait_for_sync(timeout)

    def wait_for(self, predicate, timeout: float = 10.0) -> bool:
        """Wait until ``predicate()`` holds, re-checked after each
        reconcile; False at the timeout."""
        with self._cond:
            return self._cond.wait_for(predicate, timeout)

    @property
    def applied_fingerprint(self) -> str | None:
        with self._lock:
            return self._applied_fp

    def _fail(self, msg: str) -> None:
        """Fail closed (the caller holds the lock): log and count each
        distinct error once."""
        if msg != self.last_error:
            logger.error("partition watch: %s; keeping the last good plan "
                         "(fail closed)", msg)
            self.failed_total += 1
        self.last_error = msg

    def _on_event(self, _ev_type: str, _obj: dict) -> None:
        # Selection is global (the winner may change with any object),
        # so every event reconciles all of it.
        if self._started:
            self.reconcile()

    def reconcile(self) -> bool:
        """Converge onto the winning plan, then its pre-warm hint.
        Returns True when a plan was (re-)applied."""
        try:
            with self._reconcile_lock:
                outcome, payload, obj = select_for_pool(
                    self._informer.list(), self.pool)
                applied = self._reconcile_plan(outcome, payload, obj)
                if outcome != "malformed":
                    self._converge_prewarm(
                        prewarm_hints_of(obj, self.pool), force=applied)
                return applied
        finally:
            with self._cond:
                self.reconciles += 1
                self._cond.notify_all()

    def _converge_prewarm(self, hints: dict[str, int],
                          force: bool = False) -> None:
        if self._prewarm_fn is None:
            return
        with self._lock:
            if not force and hints == self._applied_prewarm:
                return
        try:
            self._prewarm_fn(hints)
        except Exception:  # noqa: BLE001 - an advisory hint
            logger.exception("partition watch: prewarm hint not fully "
                             "applied; retried at the next reconcile")
            return
        with self._lock:
            self._applied_prewarm = dict(hints)

    def _reconcile_plan(self, outcome: str, payload, obj) -> bool:
        with self._lock:
            if outcome == "malformed":
                name = (obj or {}).get("metadata", {}).get("name", "?")
                self._fail(f"PartitionSet {name}: {payload}")
                return False
            if outcome == "none":
                if self._bootstrap is None or \
                        self._applied_fp == self._bootstrap_fp:
                    self.last_error = None
                    return False
                plan, fp = self._bootstrap, self._bootstrap_fp
                source = "the bootstrap plan"
            else:
                plan, _rules, fp = payload
                if fp == self._applied_fp:
                    self.last_error = None
                    return False
                source = (obj or {}).get("metadata", {}).get("name", "?")
            try:
                self._apply_fn(plan)
            except PartitionSpecError as e:
                self._fail(f"plan from {source} rejected: {e}")
                return False
            except Exception as e:  # noqa: BLE001 - the node goes on
                # A transient failure (the node lock's time limit, an API
                # error of the republish): not memoized, so the next
                # event or resync applies the plan again (idempotent).
                logger.warning("partition watch: applying the plan of %s "
                               "failed (%s); retried at the next event",
                               source, e)
                return False
            self._applied_fp = fp
            self.last_error = None
            self.applied_total += 1
            logger.info("partition watch: applied the plan of %s (%d "
                        "profile(s)) on pool %s", source,
                        len(plan.profiles), self.pool)
            return True
