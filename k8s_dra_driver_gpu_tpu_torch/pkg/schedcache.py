"""Inventory snapshot, allocation state and the scheduler's read surface
(the JAX package's ``pkg/schedcache.py``).

- ``InventorySnapshot``: the device inventory (candidates, a per-node
  index, KEP-4815 counter seeds, static CEL selector evaluations, the
  topology scorer's ordering memos) over per-pool ``PoolSnapshot``\\ s,
  built once per ResourceSlice change and shared across claims and
  passes. Its signature covers every slice's (name, resourceVersion,
  pool generation): any slice write, a pool-generation bump included,
  rebuilds it. Devices of a slice at an older generation than its pool's
  newest are invisible. ``delta`` re-projects only the pools a slice
  event dirtied and merges every other pool by identity.
- ``AllocationState``: the allocated-device set, the debited counter
  ledger, the per-node power debits and the holders of each shared
  device, folded from ResourceClaim allocations (``observe``/
  ``forget``), reserved atomically (``try_commit``) and moved to a newer
  snapshot in O(changed pools) (``retarget``).
- ``NodeLockManager``: per-node allocation locks; a set of nodes is
  taken in sorted order, so two windows that overlap cannot deadlock.
- ``SchedulingDomain``: one scheduler's share of the pools (fnmatch
  globs) and of the claims and pods (``resource.tpu.dra/domain``), with
  its spillover siblings.
- ``ClusterView``: one read surface for the scheduler. In direct mode
  every read lists through the kube client. ``start()`` puts an informer
  on every watched resource, all relisting through one
  ``RelistCoordinator``: reads come from their caches, ``on_event``
  hears each changed object, slice events dirty their pools for the
  next ``snapshot()``'s delta, and ComputeDomain events update their own
  preferred-node window.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from collections import deque
from contextlib import contextmanager
from functools import lru_cache
from typing import Callable

from . import tracing
from .cel import CelProgram, Quantity, compile_expression
from .informer import RELIST_PRIORITY, Informer, RelistCoordinator
from .kubeclient import KubeError, NotFoundError
from .topology.score import attr_int as _attr_int, \
    device_headroom_penalty

logger = logging.getLogger(__name__)

RESOURCE = ("resource.k8s.io", "v1")

# -- power as a budgeted resource (2501.17752) --------------------------------
#
# Per-host power is modeled like a KEP-4815 counter: every node has a
# power cap (the slice attribute below, stamped by the node plugin from
# its TPU_DRA_POWER_CAP_W, or the scheduler-side env default) and every
# allocated device debits its expected draw -- the published rated
# draw, falling back to the live telemetry attribute, falling back to
# the TPU_DRA_CHIP_POWER_W default. ``AllocationState.try_commit``
# judges the node budget atomically alongside the chip counters, so a
# power-capped rack structurally cannot over-commit even under racing
# workers. Caps/draws of 0 (the default) disable the model entirely --
# the historical behavior.
ATTR_POWER_CAP = "powerCapWatts"
ATTR_POWER_RATED = "powerRatedWatts"
# Mirror of pkg/fleetstate.ATTR_POWER (kept literal like CD_GROUP: the
# attribute contract, not an import edge).
ATTR_POWER_TELEMETRY = "telemetryPowerWatts"


@lru_cache(maxsize=8)
def _parse_watts(raw: str) -> int:
    try:
        return max(int(float(raw)), 0)
    except ValueError:
        return 0


def power_cap_env(env=None) -> int:
    """Scheduler-side default per-node power cap in watts
    (``TPU_DRA_POWER_CAP_W``); 0 = no cap (model off) for nodes that
    publish no ``powerCapWatts`` attribute. Called per node on the
    fit/commit paths: the env read stays live (tests flip it), the
    parse is memoized on the raw string."""
    return _parse_watts((env or os.environ).get(
        "TPU_DRA_POWER_CAP_W", "0"))


def chip_power_default_env(env=None) -> int:
    """Default expected draw in watts for a non-partition device that
    publishes neither ``powerRatedWatts`` nor live telemetry
    (``TPU_DRA_CHIP_POWER_W``); 0 = such devices debit nothing.
    Same live-read/memoized-parse discipline as ``power_cap_env``
    (called per device at snapshot build)."""
    return _parse_watts((env or os.environ).get(
        "TPU_DRA_CHIP_POWER_W", "0"))

# ComputeDomain CRD coordinates (kept literal: importing the
# computedomain package here would cycle through the plugin stack).
CD_GROUP = "resource.tpu.dra"
CD_VERSION = "v1beta1"
PREFERRED_NODES_ANNOTATION = "resource.tpu.dra/preferredNodes"


def tolerates(taint: dict, tolerations: list[dict]) -> bool:
    for tol in tolerations or []:
        if tol.get("effect") and tol["effect"] != taint.get("effect"):
            continue
        op = tol.get("operator", "Equal")
        if op == "Exists":
            if not tol.get("key") or tol["key"] == taint.get("key"):
                return True
        elif tol.get("key") == taint.get("key") and \
                tol.get("value", "") == taint.get("value", ""):
            return True
    return False


class CompiledSelectors:
    """Expression -> CelProgram cache; a selector that fails to compile
    permanently matches nothing (and is logged once), like a CEL
    compile error surfaced in the scheduler.

    The cache is shared process-wide (class-level, lock-guarded) and
    keyed by source text: a scheduler instantiated per sync pass still
    reuses every previously compiled selector. cel.compile_expression
    additionally memoizes the parsed AST, so even a fresh cache entry
    skips the lex+parse for text seen anywhere else in the process."""

    _shared: dict[str, CelProgram | None] = {}
    _shared_lock = threading.Lock()
    _MAX = 4096  # selectors are operator-authored; this is a leak bound

    def __init__(self):
        self._cache = self._shared

    def get(self, expression: str) -> CelProgram | None:
        with self._shared_lock:
            if expression in self._cache:
                return self._cache[expression]
        try:
            prog = compile_expression(expression)
        except Exception as e:  # noqa: BLE001 - compile boundary
            logger.error("selector does not compile (%s): %s",
                         e, expression)
            prog = None
        with self._shared_lock:
            if len(self._cache) >= self._MAX:
                self._cache.clear()
            self._cache[expression] = prog
        return prog


class CounterLedger:
    """Available KEP-4815 counters per (driver, pool, counterSet),
    seeded from sharedCounters and debited by consumesCounters."""

    def __init__(self):
        self._avail: dict[tuple, dict[str, int]] = {}

    def seed(self, driver: str, pool: str, counter_sets: list[dict]):
        for cs in counter_sets or []:
            key = (driver, pool, cs.get("name", ""))
            if key in self._avail:
                continue
            self._avail[key] = {
                name: Quantity.parse(val.get("value", "0")).milli
                for name, val in (cs.get("counters") or {}).items()
            }

    def _iter_demand(self, driver, pool, consumes):
        for block in consumes or []:
            key = (driver, pool, block.get("counterSet", ""))
            for name, val in (block.get("counters") or {}).items():
                yield key, name, Quantity.parse(
                    val.get("value", "0")).milli

    def fits(self, driver: str, pool: str, consumes: list[dict]) -> bool:
        for key, name, milli in self._iter_demand(driver, pool, consumes):
            have = self._avail.get(key, {}).get(name)
            if have is None or have < milli:
                return False
        return True

    def debit(self, driver: str, pool: str, consumes: list[dict]):
        for key, name, milli in self._iter_demand(driver, pool, consumes):
            if key in self._avail and name in self._avail[key]:
                self._avail[key][name] -= milli

    def credit(self, driver: str, pool: str, consumes: list[dict]):
        """Undo a debit (the backtracking fit un-picks devices)."""
        for key, name, milli in self._iter_demand(driver, pool, consumes):
            if key in self._avail and name in self._avail[key]:
                self._avail[key][name] += milli

    def copy(self) -> "CounterLedger":
        out = CounterLedger()
        out._avail = {k: dict(v) for k, v in self._avail.items()}
        return out


class Candidate:
    __slots__ = ("driver", "pool", "node", "device", "blocking_taints",
                 "slots", "is_partition", "power_watts",
                 "headroom_penalty")

    def __init__(self, driver, pool, node, device):
        self.driver = driver
        self.pool = pool
        self.node = node
        self.device = device
        self.blocking_taints = [
            t for t in device.get("taints") or []
            if t.get("effect") in ("NoSchedule", "NoExecute")
        ]
        attrs = device.get("attributes") or {}
        # A shared device (an oversubscribed partition) publishes
        # ``oversubscribeSlots`` > 1: that many claims may hold it at
        # once; every other device is exclusive. Its consumesCounters
        # are per slot.
        entry = attrs.get("oversubscribeSlots")
        slots = entry.get("int", 1) if isinstance(entry, dict) else 1
        try:
            self.slots = max(int(slots), 1)
        except (TypeError, ValueError):
            self.slots = 1
        part = attrs.get("partition")
        self.is_partition = bool(
            isinstance(part, dict) and part.get("bool"))
        # Watts debited from the node's budget when allocated: the
        # rating, else the telemetry, else (whole devices only: a
        # partition shares its parent's power) the env default.
        self.power_watts = _attr_int(attrs, ATTR_POWER_RATED)
        if self.power_watts <= 0:
            self.power_watts = _attr_int(attrs, ATTR_POWER_TELEMETRY)
        if self.power_watts <= 0 and not self.is_partition:
            self.power_watts = chip_power_default_env()
        # Devices in an anomaly episode or out of headroom sort last in
        # every ordering (preference, never exclusion).
        self.headroom_penalty = device_headroom_penalty(device)

    @property
    def name(self):
        return self.device["name"]

    @property
    def key(self):
        return (self.driver, self.pool, self.name)


def pool_key_of(slice_obj: dict) -> tuple[str, str]:
    """(driver, pool name) of one ResourceSlice."""
    spec = slice_obj.get("spec", {})
    return (spec.get("driver", ""),
            spec.get("pool", {}).get("name", ""))


class PoolSnapshot:
    """The allocation-relevant projection of ONE (driver, pool)'s
    ResourceSlices: newest-generation candidates with a per-node
    split, KEP-4815 counter seeds, the pool-scoped static-CEL memo,
    and the slice signature triples the incremental rebuild diffs on.

    Immutable after construction and shared BY IDENTITY across
    snapshot generations: a slice event rebuilds only the affected
    pool's PoolSnapshot, every untouched pool -- candidates, CEL
    memos, everything -- rides into the next merged view untouched
    (mutation isolation)."""

    __slots__ = ("driver", "pool", "generation", "slice_sigs",
                 "candidates", "by_node", "nodes", "counter_seeds",
                 "sel_cache", "node_power_caps")

    def __init__(self, driver: str, pool: str, slices: list[dict],
                 default_node: str | None = None):
        self.driver = driver
        self.pool = pool
        # By name, so the build is a function of the set of slices.
        ordered = sorted(slices, key=lambda s: s.get(
            "metadata", {}).get("name", ""))
        self.slice_sigs = tuple(
            (s.get("metadata", {}).get("name", ""),
             s.get("metadata", {}).get("resourceVersion", ""),
             s.get("spec", {}).get("pool", {}).get("generation", 0))
            for s in ordered)
        gen = 0
        for s in ordered:
            gen = max(gen, s.get("spec", {}).get("pool", {}).get(
                "generation", 0))
        self.generation = gen
        self.candidates: list[Candidate] = []
        self.counter_seeds: list[list[dict]] = []
        for s in ordered:
            spec = s.get("spec", {})
            if spec.get("pool", {}).get("generation", 0) != gen:
                continue  # an older generation: invisible to allocation
            node = spec.get("nodeName") or default_node or ""
            if spec.get("sharedCounters"):
                self.counter_seeds.append(spec["sharedCounters"])
            for dev in spec.get("devices", []):
                self.candidates.append(
                    Candidate(driver, pool, node, dev))
        self.by_node: dict[str, list[Candidate]] = {}
        for c in self.candidates:
            self.by_node.setdefault(c.node, []).append(c)
        self.nodes = frozenset(self.by_node)
        # The node's cap, stamped alike on each of its devices (max()
        # takes a mix mid-upgrade).
        self.node_power_caps: dict[str, int] = {}
        for c in self.candidates:
            cap = _attr_int(c.device.get("attributes") or {},
                            ATTR_POWER_CAP)
            if cap > 0:
                self.node_power_caps[c.node] = max(
                    self.node_power_caps.get(c.node, 0), cap)
        # (expression, device name) -> bool, for the pool's lifetime.
        self.sel_cache: dict[tuple[str, str], bool] = {}


class InventorySnapshot:
    """The merged allocation view over per-pool sub-snapshots
    (:class:`PoolSnapshot`), built once per slice change:

    - ``candidates`` / ``by_key`` / ``by_node``: newest-generation
      devices, indexed for the per-node fit.
    - counter seeds for a fresh :class:`CounterLedger`.
    - ``cel_match``: memoized static-selector evaluation -- one CEL
      run per (expression, device) for the owning POOL sub-snapshot's
      lifetime (which spans merged-view generations for untouched
      pools), not per claim per pass.
    - ``order_cache``: the topology scorer's candidate-ordering memos,
      keyed ``(driver, pool, names, want)`` -- pure functions of one
      pool's inventory, so delta rebuilds carry untouched pools'
      entries forward and drop exactly the changed pools'.

    Two build paths share the result shape: the cold ``__init__``
    (O(slices), direct mode / first build) and :meth:`delta`
    (O(changes): only the dirtied pools re-project; untouched
    :class:`PoolSnapshot` objects merge by IDENTITY and the top-level
    indexes are pointer-copied, never content-copied)."""

    @staticmethod
    def signature_of(slices: list[dict]) -> tuple:
        return tuple(sorted(
            (s.get("metadata", {}).get("name", ""),
             s.get("metadata", {}).get("resourceVersion", ""),
             s.get("spec", {}).get("pool", {}).get("generation", 0))
            for s in slices
        ))

    def __init__(self, slices: list[dict], signature: tuple | None = None,
                 default_node: str | None = None):
        self._signature = (self.signature_of(slices)
                           if signature is None else signature)
        self.default_node = default_node
        # Build seq / delta lineage: stamped by the owning ClusterView
        # so consumers (AllocationState.retarget) can learn WHICH pools
        # changed between two snapshots they hold.
        self.build_seq: int | None = None
        self.delta_pools: frozenset = frozenset()
        buckets: dict[tuple[str, str], list[dict]] = {}
        for s in slices:
            buckets.setdefault(pool_key_of(s), []).append(s)
        self.pools: dict[tuple[str, str], PoolSnapshot] = {
            pk: PoolSnapshot(pk[0], pk[1], group, default_node)
            for pk, group in buckets.items()
        }
        self.order_cache: dict[tuple, list[str] | None] = {}
        self._sel_cache: dict[tuple, bool] = {}
        self._candidates: list[Candidate] | None = None
        self._index_pools()

    def _index_pools(self) -> None:
        """(Re)build the merged indexes from scratch for a cold build:
        deterministic pool-key order so cold and delta builds agree."""
        self.pool_generations = {
            pk: p.generation for pk, p in self.pools.items()}
        self.by_key: dict[tuple, Candidate] = {}
        self.by_node: dict[str, list[Candidate]] = {}
        self._pools_of_node: dict[str, frozenset] = {}
        pools_of_node: dict[str, set] = {}
        for pk in sorted(self.pools):
            for c in self.pools[pk].candidates:
                self.by_key[c.key] = c
            for node in self.pools[pk].nodes:
                pools_of_node.setdefault(node, set()).add(pk)
        for node, pks in pools_of_node.items():
            self._pools_of_node[node] = frozenset(pks)
            self.by_node[node] = self._merge_node(node, pks)

    def _merge_node(self, node: str, pks) -> list[Candidate]:
        """One node's merged candidate list. A single-pool node (the
        common node-local-pool case) SHARES the pool's list by
        identity -- delta rebuilds then copy only pointers."""
        if len(pks) == 1:
            (only,) = pks
            return self.pools[only].by_node[node]
        return [c for pk in sorted(pks)
                for c in self.pools[pk].by_node.get(node, ())]

    @property
    def signature(self) -> tuple:
        """Sorted per-slice (name, resourceVersion, generation)
        triples. Delta builds compute it LAZILY from the per-pool
        signature shards -- the event-mode fast path never needs it."""
        if self._signature is None:
            self._signature = tuple(sorted(
                t for p in self.pools.values() for t in p.slice_sigs))
        return self._signature

    @property
    def candidates(self) -> list[Candidate]:
        if self._candidates is None:
            self._candidates = [
                c for pk in sorted(self.pools)
                for c in self.pools[pk].candidates]
        return self._candidates

    @classmethod
    def delta(cls, prev: "InventorySnapshot",
              dirty_buckets: dict[tuple[str, str], list[dict]],
              default_node: str | None = None,
              on_pool_build: Callable | None = None
              ) -> "InventorySnapshot":
        """O(changes) rebuild: re-project ONLY the pools named in
        ``dirty_buckets`` (pool key -> that pool's current slices;
        empty list = pool gone) and merge with every other pool of
        ``prev`` by identity. Pools whose slice signature turns out
        unchanged are dropped from the delta (spurious dirtying);
        if nothing really changed, ``prev`` itself is returned.

        The merged indexes are pointer-copies of ``prev``'s with only
        the changed pools' entries spliced -- untouched pools' sub-
        snapshots (candidates, CEL memos, order memos) are NEVER
        copied, which is what keeps maintenance sublinear in fleet
        size."""
        pools = dict(prev.pools)
        rebuilt: dict[tuple[str, str], PoolSnapshot | None] = {}
        for pk, slices in dirty_buckets.items():
            old = pools.get(pk)
            if not slices:
                if old is None:
                    continue  # never existed: nothing to drop
                pools.pop(pk)
                rebuilt[pk] = None
                continue
            t0 = time.monotonic()
            new = PoolSnapshot(pk[0], pk[1], slices, default_node)
            built_s = time.monotonic() - t0
            if old is not None and old.slice_sigs == new.slice_sigs:
                continue  # spuriously dirtied: content unchanged
            if on_pool_build is not None:
                on_pool_build(pk, built_s)
            pools[pk] = new
            rebuilt[pk] = new
        if not rebuilt:
            return prev
        changed = frozenset(rebuilt)
        snap = cls.__new__(cls)
        snap.default_node = default_node
        snap.pools = pools
        snap.build_seq = None
        snap.delta_pools = changed
        snap._signature = None  # lazy: merged from per-pool shards
        snap._candidates = None
        snap._sel_cache = {}
        # Untouched pools keep their topology-order memos; changed
        # pools' (and legacy-shaped keys') entries drop.
        snap.order_cache = {
            k: v for k, v in prev.order_cache.items()
            if isinstance(k, tuple) and len(k) >= 2
            and (k[0], k[1]) in pools and (k[0], k[1]) not in changed}
        snap.pool_generations = dict(prev.pool_generations)
        snap.by_key = dict(prev.by_key)
        snap.by_node = dict(prev.by_node)
        snap._pools_of_node = dict(prev._pools_of_node)
        affected_nodes: set[str] = set()
        for pk, new in rebuilt.items():
            old = prev.pools.get(pk)
            if old is not None:
                for c in old.candidates:
                    snap.by_key.pop(c.key, None)
                affected_nodes |= old.nodes
            if new is not None:
                for c in new.candidates:
                    snap.by_key[c.key] = c
                affected_nodes |= new.nodes
                snap.pool_generations[pk] = new.generation
            else:
                snap.pool_generations.pop(pk, None)
        for node in affected_nodes:
            pks = {pk for pk in prev._pools_of_node.get(node, ())
                   if pk not in changed}
            pks |= {pk for pk in changed
                    if pk in pools and node in pools[pk].nodes}
            if not pks:
                snap.by_node.pop(node, None)
                snap._pools_of_node.pop(node, None)
            else:
                snap._pools_of_node[node] = frozenset(pks)
                snap.by_node[node] = snap._merge_node(node, pks)
        return snap

    def make_ledger(self) -> CounterLedger:
        ledger = CounterLedger()
        for pk in sorted(self.pools):
            for sets in self.pools[pk].counter_seeds:
                ledger.seed(pk[0], pk[1], sets)
        return ledger

    def power_cap_of(self, node: str) -> int:
        """The node's power budget in watts (the published
        ``powerCapWatts`` attribute, else the scheduler-side
        TPU_DRA_POWER_CAP_W default); 0 = uncapped. Computed from the
        per-pool shards on demand so the delta path maintains no extra
        merged index."""
        cap = 0
        for pk in self._pools_of_node.get(node, ()):
            pool = self.pools.get(pk)
            if pool is not None:
                cap = max(cap, pool.node_power_caps.get(node, 0))
        return cap if cap > 0 else power_cap_env()

    def cel_match(self, expression: str, prog: CelProgram,
                  cand: Candidate) -> bool:
        pool = self.pools.get((cand.driver, cand.pool))
        cache = pool.sel_cache if pool is not None else self._sel_cache
        key = (expression, cand.name)
        hit = cache.get(key)
        if hit is None:
            try:
                hit = bool(prog.matches_device(cand.device, cand.driver))
            except Exception:  # noqa: BLE001 - CEL eval boundary
                hit = False
            cache[key] = hit
        return hit

    # -- topology order memo (the mutation-fenced accessor pair) --------------

    def order_memo_get(self, key: tuple):
        """A cached topology ordering, or ``ORDER_MISS`` (a cached None
        is an answer: no usable coordinates)."""
        return self.order_cache.get(key, ORDER_MISS)

    def order_memo_put(self, key: tuple,
                       ordered: list[str] | None) -> None:
        self.order_cache[key] = ordered


ORDER_MISS = object()


class NodeLockManager:
    """Per-node allocation locks for the sharded scheduler: disjoint
    nodes commit in parallel, same-node contenders serialize, and a
    gang claim spanning several hosts takes its whole lock set in one
    ordered acquisition (sorted node names) so two gangs overlapping on
    any node can never deadlock. Sits ABOVE the scheduler's state lock
    and the allocation-state lock; a commit's kube write happens under
    node locks only."""

    def __init__(self):
        self._locks: dict[str, threading.Lock] = {}
        self._mu = threading.Lock()

    def _lock_for(self, node: str) -> threading.Lock:
        with self._mu:
            lock = self._locks.get(node)
            if lock is None:
                lock = self._locks[node] = threading.Lock()
            return lock

    @contextmanager
    def hold(self, nodes):
        """Acquire the locks for ``nodes`` in sorted order (what
        keeps two overlapping sets from deadlocking)."""
        ordered = sorted(set(nodes))
        held = []
        try:
            for node in ordered:
                lock = self._lock_for(node)
                lock.acquire()
                held.append(lock)
            yield
        finally:
            for lock in reversed(held):
                lock.release()


def claim_like(name: str, devices: list[tuple[str, str, str]],
               namespace: str = "default", uid: str = "") -> dict:
    """The least ResourceClaim-shaped dict ``AllocationState`` reads:
    ``devices`` are (driver, pool, device) keys."""
    return {
        "metadata": {"name": name, "namespace": namespace,
                     **({"uid": uid} if uid else {})},
        "status": {"allocation": {"devices": {"results": [
            {"driver": d, "pool": p, "device": dev}
            for d, p, dev in devices
        ]}}},
    }


class AllocationState:
    """Allocated-device keys + debited counter budgets, incrementally
    maintained from ResourceClaim allocations.

    ``observe`` is idempotent per claim (keyed by uid, falling back to
    namespace/name): replaying the same allocation -- e.g. the watch
    event for a patch the scheduler itself just wrote -- is a no-op,
    and a changed allocation releases the previous devices first.

    Thread safety (scheduler scale-out): every mutation happens under
    the internal ``_alloc_lock`` so informer event threads and N sync
    workers can share one state. ``try_commit`` is the atomic
    check-and-reserve the optimistic commit-then-observe protocol pins
    on: a fit computed against (possibly stale) reads either reserves
    its devices atomically or reports a conflict for a re-fit, so two
    workers can never double-allocate a device or over-spend a counter
    budget. ``node_load`` is maintained incrementally so the per-claim
    node ordering no longer scans the whole allocated set.
    """

    # Node-ordering memo staleness bound: the least-loaded-first node
    # order re-sorts after ceil(nodes / REORDER_NODES_PER_STEP) load
    # mutations (or any snapshot change) -- EXACT per-commit spreading
    # on small fleets (threshold 1 below 256 nodes, the historical
    # behavior), amortized at scale where the per-claim O(n log n)
    # sort was the top 10k-node allocation hotspot. Pure placement
    # PREFERENCE: a stale order can only pick a slightly-more-loaded
    # node first, never misallocate.
    REORDER_NODES_PER_STEP = 256

    def __init__(self, snapshot: InventorySnapshot):
        self.snapshot = snapshot
        self.ledger = snapshot.make_ledger()
        # Keys at full capacity: an exclusive device at one holder, a
        # shared one at ``Candidate.slots`` (counted in _counts).
        self.allocated: set[tuple] = set()
        self._counts: dict[tuple, int] = {}
        self.node_load: dict[str, int] = {}
        self.power_used: dict[str, int] = {}
        self._claims: dict[str, frozenset] = {}
        self._alloc_lock = threading.Lock()
        self._node_order: list[str] | None = None
        self._node_order_drift = 0

    def _slots_of(self, key: tuple) -> int:
        cand = self.snapshot.by_key.get(key)
        return cand.slots if cand is not None else 1

    @staticmethod
    def claim_id(claim: dict) -> str:
        md = claim.get("metadata", {})
        return md.get("uid") or f"{md.get('namespace', 'default')}/" \
                                f"{md.get('name', '')}"

    @staticmethod
    def _alloc_keys(claim: dict) -> frozenset:
        alloc = claim.get("status", {}).get("allocation") or {}
        return frozenset(
            (r.get("driver", ""), r.get("pool", ""), r.get("device", ""))
            for r in alloc.get("devices", {}).get("results", [])
        )

    def rebuild(self, claims: list[dict]) -> None:
        with self._alloc_lock:
            self.ledger = self.snapshot.make_ledger()
            self.allocated = set()
            self._counts = {}
            self.node_load = {}
            self.power_used = {}
            self._claims = {}
            self._node_order = None
            for claim in claims:
                self._observe_locked(claim)

    # -- power budget -----------------------------------------------------------

    def power_debit(self, node: str, watts: int) -> None:
        """Debit one device's expected draw (caller holds the lock)."""
        if watts > 0 and node:
            self.power_used[node] = self.power_used.get(node, 0) + watts

    def power_credit(self, node: str, watts: int) -> None:
        """Undo a debit (caller holds the lock)."""
        if watts > 0 and node:
            left = self.power_used.get(node, 0) - watts
            if left > 0:
                self.power_used[node] = left
            else:
                self.power_used.pop(node, None)

    def power_snapshot(self) -> dict[str, int]:
        with self._alloc_lock:
            return dict(self.power_used)

    def retarget(self, snapshot: InventorySnapshot,
                 changed_pools) -> None:
        """Re-point this state at a DELTA-built snapshot: only the
        ``changed_pools`` (driver, pool) keys differ from the current
        snapshot, so the O(claims) rebuild collapses to re-deriving
        exactly those pools' ledger seeds, node-load contributions and
        at-capacity memberships from the held allocations. Untouched
        pools' Candidate objects are IDENTICAL between the two
        snapshots, so every other piece of state is already right.
        Equivalent to ``rebuild`` over the same claim set."""
        changed = set(changed_pools)
        with self._alloc_lock:
            old_snap = self.snapshot
            self.snapshot = snapshot
            self._node_order = None
            if not changed:
                return
            # Reseed the changed pools' counter budgets...
            for lkey in [k for k in self.ledger._avail
                         if (k[0], k[1]) in changed]:
                del self.ledger._avail[lkey]
            for pk in changed:
                pool = snapshot.pools.get(pk)
                if pool is not None:
                    for sets in pool.counter_seeds:
                        self.ledger.seed(pk[0], pk[1], sets)
            # ...then re-apply the held allocations that touch them.
            for key, count in self._counts.items():
                pk = (key[0], key[1])
                if pk not in changed:
                    continue
                old_cand = old_snap.by_key.get(key)
                new_cand = snapshot.by_key.get(key)
                if old_cand is not None:
                    left = self.node_load.get(old_cand.node, 0) - count
                    if left > 0:
                        self.node_load[old_cand.node] = left
                    else:
                        self.node_load.pop(old_cand.node, None)
                    # Power draw re-derives from the NEW candidate's
                    # attributes below: a telemetry/rating attribute
                    # change is exactly the event that dirtied this
                    # pool, so any debit/credit drift heals here.
                    self.power_credit(old_cand.node,
                                      old_cand.power_watts * count)
                if new_cand is not None:
                    consumes = new_cand.device.get("consumesCounters")
                    for _ in range(count):
                        self.ledger.debit(new_cand.driver, new_cand.pool,
                                          consumes)
                    self.node_load[new_cand.node] = \
                        self.node_load.get(new_cand.node, 0) + count
                    self.power_debit(new_cand.node,
                                     new_cand.power_watts * count)
                slots = new_cand.slots if new_cand is not None else 1
                if count >= slots:
                    self.allocated.add(key)
                else:
                    self.allocated.discard(key)

    def ordered_nodes(self) -> list[str]:
        """Every node with published candidates, least-loaded first
        (name tiebreak), memoized until ``max(1, nodes //
        REORDER_NODES_PER_STEP)`` load mutations accumulate or the
        snapshot changes. Callers must treat the returned list as
        read-only (it is shared across workers)."""
        with self._alloc_lock:
            order = self._node_order
            threshold = max(
                1, len(self.snapshot.by_node) //
                self.REORDER_NODES_PER_STEP)
            if order is None or self._node_order_drift >= threshold:
                load = self.node_load
                order = sorted(self.snapshot.by_node,
                               key=lambda n: (load.get(n, 0), n))
                self._node_order = order
                self._node_order_drift = 0
            return order

    def observe(self, claim: dict) -> bool:
        """Fold one claim's current allocation in; True if it changed the
        state."""
        with self._alloc_lock:
            return self._observe_locked(claim)

    def _observe_locked(self, claim: dict) -> bool:
        cid = self.claim_id(claim)
        keys = self._alloc_keys(claim)
        old = self._claims.get(cid, frozenset())
        if keys == old:
            return False
        self._release_locked(old)
        self._apply_locked(cid, keys)
        return True

    def _apply_locked(self, cid: str, keys: frozenset) -> None:
        for key in keys:
            count = self._counts.get(key, 0) + 1
            self._counts[key] = count
            if count >= self._slots_of(key):
                self.allocated.add(key)
            cand = self.snapshot.by_key.get(key)
            if cand is not None:
                self.ledger.debit(cand.driver, cand.pool,
                                  cand.device.get("consumesCounters"))
                self.node_load[cand.node] = \
                    self.node_load.get(cand.node, 0) + 1
                self.power_debit(cand.node, cand.power_watts)
                self._node_order_drift += 1
        if keys:
            self._claims[cid] = keys
        else:
            self._claims.pop(cid, None)

    def forget(self, claim: dict) -> bool:
        """Drop a deleted claim; its devices return to the free pool."""
        with self._alloc_lock:
            cid = self.claim_id(claim)
            old = self._claims.pop(cid, None)
            if not old:
                return False
            self._release_locked(old)
            return True

    def try_commit(self, claim: dict) -> bool:
        """Atomically reserve one claim's planned allocation: every
        device key must still have a free slot (exclusive devices: not
        allocated at all; shared partition devices: fewer than
        ``slots`` holders) and every counter budget must still fit,
        judged and applied under one lock. Returns False on conflict
        (the caller re-fits against fresh state); replaying a claim's
        own reservation returns True (idempotent). A reserve whose
        kube patch subsequently fails is undone via ``forget``, so a
        failed write never leaks a debit (commit-then-observe)."""
        cid = self.claim_id(claim)
        keys = self._alloc_keys(claim)
        with self._alloc_lock:
            prior = self._claims.get(cid)
            if prior == keys:
                return True  # idempotent replay of our own reservation
            if prior is not None:
                # The claim was freshly read as unallocated, so a prior
                # entry is stale (a deallocated claim's ghost from the
                # commit-log replay): release it and re-judge. The work
                # queue runs each key on at most one worker at a time
                # (its running-set -- true even with work stealing), so
                # this can never drop another worker's in-flight
                # reservation.
                self._release_locked(prior)
                self._claims.pop(cid, None)
            debited: list[Candidate] = []
            power_want: dict[str, int] = {}
            ok = True
            for key in keys:
                if key in self.allocated:
                    ok = False
                    break
                cand = self.snapshot.by_key.get(key)
                if cand is None:
                    continue
                consumes = cand.device.get("consumesCounters")
                if consumes and not self.ledger.fits(
                        cand.driver, cand.pool, consumes):
                    ok = False
                    break
                # Power budget (2501.17752): the claim's summed draw
                # per node must fit under the node cap on top of what
                # is already debited -- judged cumulatively so a
                # multi-device claim can't pass N individual checks
                # that together blow the rack budget.
                if cand.power_watts > 0:
                    want = power_want.get(cand.node, 0) + \
                        cand.power_watts
                    cap = self.snapshot.power_cap_of(cand.node)
                    if cap > 0 and \
                            self.power_used.get(cand.node, 0) + want \
                            > cap:
                        ok = False
                        break
                    power_want[cand.node] = want
                # Debit as we go so multi-device claims can't pass N
                # individual fits that overspend one shared counter.
                self.ledger.debit(cand.driver, cand.pool, consumes)
                debited.append(cand)
            if not ok:
                for cand in debited:
                    self.ledger.credit(cand.driver, cand.pool,
                                       cand.device.get("consumesCounters"))
                return False
            for cand in debited:
                # _apply_locked re-debits; restore balance first.
                self.ledger.credit(cand.driver, cand.pool,
                                   cand.device.get("consumesCounters"))
            self._apply_locked(cid, keys)
            return True

    def ledger_snapshot(self) -> "CounterLedger":
        """Consistent copy of the counter ledger for a lock-free fit."""
        with self._alloc_lock:
            return self.ledger.copy()

    def load_view(self) -> dict[str, int]:
        """Consistent copy of the per-node allocated-device counts."""
        with self._alloc_lock:
            return dict(self.node_load)

    def slot_counts(self) -> dict[tuple, int]:
        """Holders of each device key (every co-tenant of a shared one)."""
        with self._alloc_lock:
            return dict(self._counts)

    def _release_locked(self, keys: frozenset) -> None:
        for key in keys:
            count = self._counts.get(key, 0) - 1
            if count > 0:
                self._counts[key] = count
            else:
                self._counts.pop(key, None)
            if count < self._slots_of(key):
                self.allocated.discard(key)
            cand = self.snapshot.by_key.get(key)
            if cand is not None:
                self.ledger.credit(cand.driver, cand.pool,
                                   cand.device.get("consumesCounters"))
                self.power_credit(cand.node, cand.power_watts)
                self._node_order_drift += 1
                left = self.node_load.get(cand.node, 0) - 1
                if left > 0:
                    self.node_load[cand.node] = left
                else:
                    self.node_load.pop(cand.node, None)


# Objects (claims / pods) opt into a scheduling domain with this
# annotation; unannotated objects belong to the default domain.
DOMAIN_ANNOTATION = "resource.tpu.dra/domain"
# Cross-domain claim spillover (pkg/scheduler._maybe_spill): a claim
# pinned into an exhausted domain re-homes to a sibling domain instead
# of pending forever. The move annotates INTENT so operators (and the
# claim's eventual return path) can see it was displaced:
#   spilled-from: the ORIGINAL domain (first hop wins; stable across
#                 multi-hop spills),
#   spillover-hops: hop count, capped by TPU_DRA_SPILLOVER_MAX_HOPS,
#   spillover: "false" on a claim opts it out entirely.
SPILLOVER_ANNOTATION = "resource.tpu.dra/spillover"
SPILLED_FROM_ANNOTATION = "resource.tpu.dra/spilled-from"
SPILLOVER_HOPS_ANNOTATION = "resource.tpu.dra/spillover-hops"


class SchedulingDomain:
    """A partitioned scheduling domain (scheduler-per-pool sharding).

    Operators scale the control plane horizontally by running one
    scheduler instance per domain: each instance leader-elects on its
    own per-domain Lease (``lease_name``), restricts its inventory
    snapshot to the pools matching ``pools`` (exact names or
    ``fnmatch`` globs), and consumes only the dirty keys of claims /
    pods annotated ``resource.tpu.dra/domain: <name>``. Exactly one
    domain should be ``default=True`` (or one scheduler run with no
    domain at all): it owns unannotated objects plus the cluster-wide
    controllers (DaemonSet/Job sync, recovery), which must not run in
    every domain."""

    def __init__(self, name: str, pools=(), default: bool = False,
                 siblings: "list[SchedulingDomain] | None" = None):
        self.name = name
        self.pools = [p for p in pools if p]
        self.default = default
        # Spillover targets, in operator preference order: sibling
        # domains a pinned claim may re-home to when THIS domain's
        # pools are exhausted (pkg/scheduler._maybe_spill ranks them
        # by migration-cost score; order is the tiebreak prior).
        self.siblings: list[SchedulingDomain] = list(siblings or ())

    @property
    def lease_name(self) -> str:
        return f"tpu-dra-scheduler-{self.name}"

    def owns_pool(self, pool: str, node: str) -> bool:
        """POOL names only (node-local pools are named after their
        node, so that already covers the common case); matching node
        names too would let one slice silently satisfy two domains'
        globs and overlap their snapshots -- nothing validates domain
        disjointness, so the contract stays narrow."""
        if not self.pools:
            return True
        from fnmatch import fnmatch  # noqa: PLC0415

        return any(fnmatch(pool, pat) for pat in self.pools)

    def owns_object(self, obj: dict) -> bool:
        """Claim/pod routing: the domain annotation wins; unannotated
        objects belong to the default domain."""
        ann = (obj.get("metadata", {}).get("annotations") or {}).get(
            DOMAIN_ANNOTATION, "")
        if ann:
            return ann == self.name
        return self.default

    @classmethod
    def parse_siblings(cls, spec: str) -> "list[SchedulingDomain]":
        """``name=glob|glob;name2=glob`` -> sibling domains, in the
        operator's preference order. Malformed entries are skipped
        (a bad sibling must not take the scheduler down) -- including
        entries WITHOUT pool globs: an empty pool list means
        match-everything in owns_pool, which would count the whole
        cluster (the exhausted origin included) as the sibling's spill
        capacity."""
        siblings = []
        for entry in (spec or "").split(";"):
            entry = entry.strip()
            if not entry:
                continue
            name, _, globs = entry.partition("=")
            name = name.strip()
            pools = [g.strip() for g in globs.split("|") if g.strip()]
            if not name or not pools:
                logger.warning(
                    "skipping malformed spillover sibling entry %r "
                    "(want name=poolglob[|glob...])", entry)
                continue
            siblings.append(cls(name, pools=pools))
        return siblings

    @classmethod
    def from_env(cls, env=None) -> "SchedulingDomain | None":
        import os  # noqa: PLC0415

        env = env if env is not None else os.environ
        name = env.get("TPU_DRA_SCHED_DOMAIN", "")
        if not name:
            return None
        pools = [p.strip() for p in env.get(
            "TPU_DRA_SCHED_DOMAIN_POOLS", "").split(",") if p.strip()]
        default = env.get("TPU_DRA_SCHED_DOMAIN_DEFAULT", "") in (
            "1", "true", "True")
        siblings = cls.parse_siblings(env.get(
            "TPU_DRA_SCHED_DOMAIN_SIBLINGS", ""))
        return cls(name, pools=pools, default=default,
                   siblings=siblings)


# (group, version, resource) of every resource the scheduler's
# sync paths read; pkg/scheduler.py reads them through this view.
WATCHED_RESOURCES: tuple[tuple[str, str, str], ...] = (
    ("", "v1", "pods"),
    ("", "v1", "nodes"),
    ("apps", "v1", "daemonsets"),
    ("batch", "v1", "jobs"),
    ("resource.k8s.io", "v1", "resourceclaims"),
    ("resource.k8s.io", "v1", "resourceslices"),
    ("resource.k8s.io", "v1", "deviceclasses"),
    ("resource.k8s.io", "v1", "resourceclaimtemplates"),
    (CD_GROUP, CD_VERSION, "computedomains"),
    # The serving autoscaler's desired-layout CRD (pkg/autoscale):
    # cluster-scoped, watched so re-plans reach the controller's
    # confirm stage (and pending tenants their retry) without polling.
    (CD_GROUP, CD_VERSION, "partitionsets"),
)


class ClusterView:
    """One read surface for scheduler sync paths.

    Direct mode (default): every accessor falls through to the kube
    client, preserving the one-shot ``sync_once()`` semantics unit
    tests rely on (KubeErrors propagate so fail-closed call sites keep
    failing closed). Event mode (``start()``): every watched resource
    gets an informer; accessors become pure cache reads and
    ``on_event(resource, ev_type, obj)`` fires per object change so
    the scheduler can maintain its dirty set.

    The inventory snapshot is cached in BOTH modes and rebuilt only
    when the slice signature changes (any slice create/update/delete,
    including pool-generation bumps)."""

    def __init__(self, kube, on_event: Callable | None = None,
                 on_relist: Callable[[str], None] | None = None,
                 resync_period: float = 300.0,
                 default_node: str | None = None,
                 pool_filter: Callable[[str, str], bool] | None = None,
                 on_snapshot_build: Callable[[float], None] | None = None,
                 on_snapshot_delta: Callable | None = None,
                 on_relist_backoff: Callable | None = None):
        self.kube = kube
        self._on_event = on_event
        self._on_relist = on_relist
        self._resync_period = resync_period
        self._default_node = default_node
        # Scheduling-domain partitioning: pool_filter(pool, node) False
        # makes a slice invisible to this scheduler's snapshot (the
        # per-pool domain sharding surface).
        self._pool_filter = pool_filter
        self._on_snapshot_build = on_snapshot_build
        # on_snapshot_delta(pool_label, seconds): one observation per
        # per-pool sub-snapshot rebuilt by the delta path
        # (tpu_dra_sched_snapshot_delta_seconds{pool}).
        self._on_snapshot_delta = on_snapshot_delta
        self._on_relist_backoff = on_relist_backoff
        self._informers: dict[str, Informer] = {}
        self._relist_coord = None
        self._snapshot: InventorySnapshot | None = None
        self._snapshot_lock = threading.Lock()
        # Bumped on EVERY slice event/invalidation; snapshot() rereads
        # until its listing is provably not older than the latest bump,
        # so a rebuild racing an event-thread generation bump can never
        # install (and serve to a commit) a stale-generation snapshot.
        # In event mode it also powers the O(1) snapshot fast path: a
        # cached snapshot built at the current generation is returned
        # without relisting or recomputing the signature.
        self._slice_gen = 0
        self._snapshot_gen = -1
        # Per-pool slice buckets, maintained INCREMENTALLY from slice
        # events (and re-anchored at every full build): the delta
        # rebuild reads exactly the dirty pools' slices from here --
        # zero listing, zero grouping of the other 9,999 pools.
        # _dirty_pools None = tracking lost (unusable event payload);
        # the next snapshot() falls back to a full build.
        self._slices_by_pool: dict[tuple[str, str], dict[str, dict]] = {}
        self._pool_of_slice: dict[str, tuple[str, str]] = {}
        self._dirty_pools: set[tuple[str, str]] | None = set()
        # Delta lineage: every installed snapshot gets a build seq and
        # the log records which pools each build changed (None = full
        # rebuild, unknown delta), so AllocationState holders can
        # retarget in O(changed pools) instead of rebuilding O(claims).
        self._build_seq = 0
        self._delta_log: deque = deque(maxlen=512)
        self._cd_windows: dict[str, list[str]] | None = None
        # Bumped on every ComputeDomain event (single informer watch
        # thread writes it): cd_windows() builds that raced an event
        # serve their listing but never install it.
        self._cd_gen = 0
        self._started = False

    # -- lifecycle ------------------------------------------------------------

    @property
    def event_driven(self) -> bool:
        return self._started

    def start(self) -> "ClusterView":
        if self._started:
            return self
        self._started = True
        # One relist coordinator for all nine informers: a restart
        # storm's simultaneous relists drain priority-ordered
        # (slices/claims first -- the allocation-critical state) under
        # a concurrency cap with per-resource jittered backoff, instead
        # of thundering-herding the apiserver. Startup itself lists in
        # the same priority order.
        self._relist_coord = RelistCoordinator(
            on_backoff=self._on_relist_backoff)
        ordered = sorted(WATCHED_RESOURCES,
                         key=lambda e: RELIST_PRIORITY.get(e[2], 9))
        for group, version, resource in ordered:
            inf = Informer(self.kube, group, version, resource,
                           resync_period=self._resync_period,
                           on_relist=self._relist_hook(resource),
                           coordinator=self._relist_coord)
            # The LOCAL hook (slice buckets, CD windows) always runs;
            # the external on_event feed is optional.
            inf.add_event_hook(self._event_hook(resource))
            self._informers[resource] = inf
            inf.start()
        return self

    def stop(self) -> None:
        for inf in self._informers.values():
            inf.stop()

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        deadline = timeout
        return all(inf.wait_for_sync(deadline)
                   for inf in self._informers.values())

    def _event_hook(self, resource: str):
        def hook(ev_type: str, obj: dict, _r=resource):
            self._on_local_event(_r, ev_type, obj)
            if self._on_event is not None:
                self._on_event(_r, ev_type, obj)
        return hook

    def _relist_hook(self, resource: str):
        def hook(_r=resource):
            if self._on_relist is not None:
                self._on_relist(_r)
        return hook

    def _on_local_event(self, resource: str, ev_type: str,
                        obj: dict) -> None:
        if resource == "computedomains":
            self._on_cd_event(ev_type, obj)
        elif resource == "resourceslices":
            # The informer applied the change to its cache BEFORE
            # firing this hook, so any slice listing taken after this
            # bump observes it.
            self._on_slice_event(ev_type, obj)

    def _on_cd_event(self, ev_type: str, obj: dict) -> None:
        """SCOPED CD-window maintenance: one ComputeDomain's event
        updates exactly its own uid's entry, so the N-1 unrelated
        domains' window memos (and the pools their gangs target)
        survive -- the cache used to be nuked wholesale on any CD
        event, costing a relist per pending channel claim across every
        pool. ``_cd_gen`` always advances so a cd_windows() build
        racing this event discards its (possibly pre-event) result
        instead of caching it -- with per-uid maintenance there is no
        later global invalidation to heal a stale install."""
        self._cd_gen += 1
        cached = self._cd_windows
        if cached is None:
            return  # never built: the next cd_windows() builds fresh
        md = obj.get("metadata", {})
        uid = md.get("uid")
        if not uid:
            self._cd_windows = None  # unusable payload: full refresh
            return
        if ev_type == "DELETED":
            cached.pop(uid, None)
        else:
            ann = (md.get("annotations") or {}).get(
                PREFERRED_NODES_ANNOTATION, "")
            cached[uid] = [n for n in ann.split(",") if n]

    def _on_slice_event(self, ev_type: str, obj: dict) -> None:
        """Incremental per-pool slice bucket + dirty-pool upkeep (the
        delta rebuild's feed). Slices a domain's pool_filter excludes
        never dirty this view at all -- other domains' slice churn no
        longer costs this scheduler a rebuild."""
        md = obj.get("metadata", {})
        name = md.get("name", "")
        pk = pool_key_of(obj)
        visible = self._pool_filter is None or self._pool_filter(
            pk[1], obj.get("spec", {}).get("nodeName", ""))
        with self._snapshot_lock:
            if not name:
                # No identity to track: fall back to a full rebuild.
                self._slice_gen += 1
                self._dirty_pools = None
                return
            prev_pk = self._pool_of_slice.get(name)
            if prev_pk is None and not visible:
                return  # filtered and never seen: invisible churn
            self._slice_gen += 1
            if prev_pk is not None and prev_pk != pk:
                # Pool (or driver) rename: retire the old residency.
                bucket = self._slices_by_pool.get(prev_pk)
                if bucket is not None:
                    bucket.pop(name, None)
                    if not bucket:
                        self._slices_by_pool.pop(prev_pk, None)
                if self._dirty_pools is not None:
                    self._dirty_pools.add(prev_pk)
            if ev_type == "DELETED" or not visible:
                self._pool_of_slice.pop(name, None)
                bucket = self._slices_by_pool.get(pk)
                if bucket is not None:
                    bucket.pop(name, None)
                    if not bucket:
                        self._slices_by_pool.pop(pk, None)
            else:
                self._pool_of_slice[name] = pk
                self._slices_by_pool.setdefault(pk, {})[name] = obj
            if self._dirty_pools is not None and (
                    visible or prev_pk is not None):
                self._dirty_pools.add(pk)

    # -- per-pass bookkeeping -------------------------------------------------

    def begin_pass(self) -> None:
        """Reset per-pass memos that event mode invalidates by event
        (direct mode has no events, so a full pass starts fresh)."""
        if not self._started:
            self._cd_windows = None

    # -- reads ----------------------------------------------------------------

    def _list(self, group: str, version: str, resource: str) -> list[dict]:
        inf = self._informers.get(resource)
        if inf is not None:
            return inf.list()
        return self.kube.list(group, version, resource)

    def pods(self) -> list[dict]:
        return self._list("", "v1", "pods")

    def nodes(self) -> list[dict]:
        return self._list("", "v1", "nodes")

    def daemonsets(self) -> list[dict]:
        return self._list("apps", "v1", "daemonsets")

    def jobs(self) -> list[dict]:
        return self._list("batch", "v1", "jobs")

    def claims(self) -> list[dict]:
        return self._list(*RESOURCE, "resourceclaims")

    def slices(self) -> list[dict]:
        return self._list(*RESOURCE, "resourceslices")

    def device_classes(self) -> list[dict]:
        return self._list(*RESOURCE, "deviceclasses")

    def partition_sets(self) -> list[dict]:
        return self._list(CD_GROUP, CD_VERSION, "partitionsets")

    def get_pod(self, name: str, namespace: str = "default") -> dict:
        inf = self._informers.get("pods")
        if inf is not None:
            obj = inf.get(name, namespace)
            if obj is None:
                raise NotFoundError(f"pods/{name}")
            return obj
        return self.kube.get("", "v1", "pods", name, namespace=namespace)

    def get_claim(self, name: str, namespace: str = "default") -> dict:
        inf = self._informers.get("resourceclaims")
        if inf is not None:
            obj = inf.get(name, namespace)
            if obj is None:
                raise NotFoundError(f"resourceclaims/{name}")
            return obj
        return self.kube.get(*RESOURCE, "resourceclaims", name,
                             namespace=namespace)

    def get_template(self, name: str, namespace: str = "default") -> dict:
        inf = self._informers.get("resourceclaimtemplates")
        if inf is not None:
            obj = inf.get(name, namespace)
            if obj is None:
                raise NotFoundError(f"resourceclaimtemplates/{name}")
            return obj
        return self.kube.get(*RESOURCE, "resourceclaimtemplates", name,
                             namespace=namespace)

    # -- indexed snapshot -----------------------------------------------------

    def _filtered_slices(self) -> list[dict]:
        slices = self.slices()
        if self._pool_filter is None:
            return slices
        return [
            s for s in slices
            if self._pool_filter(
                s.get("spec", {}).get("pool", {}).get("name", ""),
                s.get("spec", {}).get("nodeName", ""))
        ]

    # Bounded retries for the list-vs-event race below: a cluster
    # churning slices faster than we can list is pathological; after
    # this many laps the freshest listing we have wins (still at least
    # as new as every bump observed before the first lap).
    _SNAPSHOT_RACE_RETRIES = 10

    def snapshot(self) -> InventorySnapshot:
        """The current inventory snapshot, rebuilt only when any slice
        changed (tracked via (name, resourceVersion, generation)).

        Rebuilds are race-checked against ``_slice_gen``: a worker
        whose listing predates a concurrent slice event (generation
        bump) re-lists instead of installing -- and handing a commit --
        a stale-generation snapshot that could clobber a newer one.

        Event mode gets an O(1) fast path off the same counter: slice
        events are the only thing that can change the listing, so a
        snapshot built at the current generation is returned without
        relisting or recomputing the O(slices) signature -- at 1000
        nodes that check used to dominate every allocation batch.

        Between the fast path and the full rebuild sits the DELTA
        path: with per-pool dirty tracking intact, only the dirtied
        pools' sub-snapshots rebuild and merge into the served view
        (O(changes), the 10k-node maintenance contract)."""
        if self._started:
            with self._snapshot_lock:
                if self._snapshot is not None and \
                        self._snapshot_gen == self._slice_gen:
                    return self._snapshot
                if self._snapshot is not None and \
                        self._snapshot_gen >= 0 and \
                        self._dirty_pools is not None:
                    return self._snapshot_delta_locked()
        for _ in range(self._SNAPSHOT_RACE_RETRIES):
            with self._snapshot_lock:
                gen0 = self._slice_gen
            slices = self._filtered_slices()
            sig = InventorySnapshot.signature_of(slices)
            with self._snapshot_lock:
                if self._snapshot is not None and \
                        self._snapshot.signature == sig:
                    # The listing provably covers every event up to
                    # gen0 (read before the list); never stamp newer.
                    self._snapshot_gen = max(self._snapshot_gen, gen0)
                    return self._snapshot
                if self._slice_gen != gen0:
                    continue  # raced a slice event: our listing may be stale
                t0 = time.monotonic()
                with tracing.span("sched.snapshot_build",
                                  attrs={"slices": len(slices)}):
                    self._snapshot = InventorySnapshot(
                        slices, signature=sig,
                        default_node=self._default_node)
                self._install_full_locked(self._snapshot, slices)
                self._snapshot_gen = gen0
                snap = self._snapshot
            if self._on_snapshot_build is not None:
                self._on_snapshot_build(time.monotonic() - t0)
            return snap
        # Persistent churn: accept the freshest listing we can get
        # (and force the next call to re-verify).
        slices = self._filtered_slices()
        sig = InventorySnapshot.signature_of(slices)
        with self._snapshot_lock:
            if self._snapshot is None or self._snapshot.signature != sig:
                self._snapshot = InventorySnapshot(
                    slices, signature=sig, default_node=self._default_node)
                self._install_full_locked(self._snapshot, slices)
            self._snapshot_gen = -1
            return self._snapshot

    def _install_full_locked(self, snap: InventorySnapshot,
                             slices: list[dict]) -> None:
        """Bookkeeping for a freshly built FULL snapshot (caller holds
        the lock and has verified the listing's generation): stamp the
        build seq, log it as an everything-may-have-changed build, and
        re-anchor the per-pool buckets + dirty tracking off the
        authoritative listing."""
        self._build_seq += 1
        snap.build_seq = self._build_seq
        self._delta_log.append((self._build_seq, None))
        if not self._started:
            return
        self._slices_by_pool = {}
        self._pool_of_slice = {}
        for s in slices:
            name = s.get("metadata", {}).get("name", "")
            if not name:
                continue
            pk = pool_key_of(s)
            self._pool_of_slice[name] = pk
            self._slices_by_pool.setdefault(pk, {})[name] = s
        self._dirty_pools = set()

    def _snapshot_delta_locked(self) -> InventorySnapshot:
        """Delta rebuild under the snapshot lock: O(dirty pools), the
        event threads that would mutate the buckets are excluded by
        the same lock. Spuriously dirtied pools (content unchanged)
        fall out inside InventorySnapshot.delta; a no-op delta keeps
        the previous snapshot object (and its identity-based
        consumers) entirely."""
        gen0 = self._slice_gen
        dirty = self._dirty_pools
        self._dirty_pools = set()
        buckets = {
            pk: list(self._slices_by_pool.get(pk, {}).values())
            for pk in dirty
        }
        new = InventorySnapshot.delta(
            self._snapshot, buckets, default_node=self._default_node,
            on_pool_build=self._pool_build_hook)
        if new is not self._snapshot:
            self._build_seq += 1
            new.build_seq = self._build_seq
            self._delta_log.append((self._build_seq, new.delta_pools))
            self._snapshot = new
        self._snapshot_gen = gen0
        return self._snapshot

    def _pool_build_hook(self, pk: tuple[str, str],
                         seconds: float) -> None:
        if self._on_snapshot_delta is not None:
            try:
                self._on_snapshot_delta(f"{pk[0]}/{pk[1]}", seconds)
            except Exception:  # noqa: BLE001 - metrics hook
                logger.exception("snapshot delta hook failed")

    def changed_pools_between(self, old: InventorySnapshot | None,
                              new: InventorySnapshot | None
                              ) -> set | None:
        """The pool keys that changed between two snapshots this view
        installed, or None when that cannot be answered from the delta
        log (either snapshot unstamped, a full rebuild in the window,
        or the log aged past ``old``) -- the caller then falls back to
        a full state rebuild."""
        if old is new:
            return set()
        old_seq = getattr(old, "build_seq", None) if old else None
        new_seq = getattr(new, "build_seq", None) if new else None
        if old_seq is None or new_seq is None or new_seq < old_seq:
            return None
        out: set = set()
        with self._snapshot_lock:
            if self._delta_log and self._delta_log[0][0] > old_seq + 1:
                return None  # log no longer covers the window
            for seq, pools in self._delta_log:
                if old_seq < seq <= new_seq:
                    if pools is None:
                        return None  # a full rebuild: unknown delta
                    out |= pools
        return out

    def invalidate_snapshot(self) -> None:
        with self._snapshot_lock:
            self._slice_gen += 1
            self._snapshot = None

    # -- ComputeDomain windows ------------------------------------------------

    def cd_windows(self) -> dict[str, list[str]]:
        """uid -> preferred-node window for every ComputeDomain.
        Cached until a CD event (event mode) / the next pass (direct
        mode); a transient list failure caches the empty answer so N
        pending channel claims never mean N failing lists."""
        cached = self._cd_windows
        if cached is not None:
            return cached
        gen0 = self._cd_gen
        try:
            cds = self._list(CD_GROUP, CD_VERSION, "computedomains")
        except KubeError:
            if self._cd_gen == gen0:
                self._cd_windows = {}
            return {}
        windows: dict[str, list[str]] = {}
        for cd in cds:
            md = cd.get("metadata", {})
            uid = md.get("uid")
            ann = (md.get("annotations") or {}).get(
                PREFERRED_NODES_ANNOTATION, "")
            if uid:
                windows[uid] = [n for n in ann.split(",") if n]
        if self._cd_gen == gen0:
            # No event raced the build: safe to install. A raced
            # build serves its listing uncached; the next call
            # re-lists and sees the event's effect (per-uid
            # maintenance has no later global heal, so a stale
            # install would live forever).
            self._cd_windows = windows
        return windows
