"""Inventory snapshot, allocation state and the scheduler's read surface
(the JAX package's ``pkg/schedcache.py``, its direct mode).

- ``InventorySnapshot``: the device inventory (candidates, a per-node
  index, KEP-4815 counter seeds, static CEL selector evaluations, the
  topology scorer's ordering memos) built once per ResourceSlice change
  and shared across claims and passes. Its signature covers every
  slice's (name, resourceVersion, pool generation): any slice write,
  a pool-generation bump included, rebuilds it. Devices of a slice at
  an older generation than its pool's newest are invisible.
- ``AllocationState``: the allocated-device set, the debited counter
  ledger, the per-node power debits and the holders of each shared
  device, folded from ResourceClaim allocations (``observe``/
  ``forget``) and reserved atomically (``try_commit``).
- ``ClusterView``: one read surface for the scheduler's pass. In direct
  mode, the only one ported, every read lists through the kube client,
  so a pass sees the API server as it is.

What waits (ROADMAP.md §1c item 8, the scheduler's event mode): the
informers behind ``ClusterView.start`` and their event hooks, which need
the JAX informer's ``RelistCoordinator`` (ROADMAP.md §1b item 5b); the
snapshot's per-pool ``delta`` rebuild and ``AllocationState.retarget``
that only event mode drives; and ``SchedulingDomain`` (domains and
spillover). ``ClusterView.start`` raises ``NotPortedError``.
"""

from __future__ import annotations

import logging
import os
import threading
import time
from functools import lru_cache
from typing import Callable

from . import tracing
from .cel import CelProgram, Quantity, compile_expression
from .kubeclient import KubeError
from .topology.score import attr_int as _attr_int
from .topology.score import device_headroom_penalty

logger = logging.getLogger(__name__)

RESOURCE = ("resource.k8s.io", "v1")

# The ROADMAP.md items that port what the scheduler does not run yet.
EVENT_MODE = ("the scheduler's event mode (ROADMAP.md §1c item 8, "
              "scheduler: informers, dirty keys and their workqueue; needs "
              "§1b item 5b's RelistCoordinator)")
WORKERS = ("sharded scheduler workers and the claim batch (ROADMAP.md "
           "§1c item 8, scheduler: workers > 1)")
DOMAINS = ("scheduling domains and spillover (ROADMAP.md §1c item 8, "
           "scheduler: SchedulingDomain)")


class NotPortedError(RuntimeError):
    """A caller asks the scheduler for what the port does not run yet;
    the message names the ROADMAP.md item that ports it."""


# -- power as a budgeted resource ----------------------------------------------
#
# Per-host power is modelled like a KEP-4815 counter: every node has a
# power cap (the slice attribute below, else the scheduler-side env
# default) and every allocated device debits its expected draw: the
# published rating, else the live telemetry attribute, else the
# TPU_DRA_CHIP_POWER_W default. ``AllocationState.try_commit`` judges the
# node budget with the counters. Caps and draws of 0 (the default) turn
# the model off.
ATTR_POWER_CAP = "powerCapWatts"
ATTR_POWER_RATED = "powerRatedWatts"
ATTR_POWER_TELEMETRY = "telemetryPowerWatts"


@lru_cache(maxsize=8)
def _parse_watts(raw: str) -> int:
    try:
        return max(int(float(raw)), 0)
    except ValueError:
        return 0


def power_cap_env() -> int:
    """The default per-node power cap in watts (``TPU_DRA_POWER_CAP_W``)
    for nodes that publish no ``powerCapWatts``; 0 = no cap. Read live
    (tests flip it), parsed once per raw string."""
    return _parse_watts(os.environ.get("TPU_DRA_POWER_CAP_W", "0"))


def chip_power_default_env() -> int:
    """The default expected draw in watts of a whole device that
    publishes neither ``powerRatedWatts`` nor live telemetry
    (``TPU_DRA_CHIP_POWER_W``); 0 = such devices debit nothing."""
    return _parse_watts(os.environ.get("TPU_DRA_CHIP_POWER_W", "0"))


# ComputeDomain coordinates (the JAX package's group, as the port's CD
# stack keeps them).
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
    """Expression -> CelProgram cache, shared by the process and keyed by
    the source text; a selector that does not compile matches nothing
    (and is logged once), as a CEL compile error in a scheduler."""

    _shared: dict[str, CelProgram | None] = {}
    _shared_lock = threading.Lock()
    _MAX = 4096  # selectors are written by operators: a leak bound

    def get(self, expression: str) -> CelProgram | None:
        with self._shared_lock:
            if expression in self._shared:
                return self._shared[expression]
        try:
            prog = compile_expression(expression)
        except Exception as e:  # noqa: BLE001 - compile boundary
            logger.error("selector does not compile (%s): %s",
                         e, expression)
            prog = None
        with self._shared_lock:
            if len(self._shared) >= self._MAX:
                self._shared.clear()
            self._shared[expression] = prog
        return prog


class CounterLedger:
    """Available KEP-4815 counters per (driver, pool, counterSet), seeded
    from sharedCounters and debited by consumesCounters (milli-units)."""

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
    """One published device of the snapshot, with what the fit reads of
    it extracted once: the taints that can block it, its tenant slots,
    whether it is a partition, its expected power draw and its headroom
    penalty."""

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
    """The allocation view of one (driver, pool)'s ResourceSlices: the
    candidates of its newest generation, split by node, its counter
    seeds, its node power caps and the memo of static CEL results."""

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
    """The merged allocation view over the pools' ``PoolSnapshot``\\ s,
    built once per slice change: ``candidates``, ``by_key`` and
    ``by_node``; the counter seeds of a fresh ``CounterLedger``;
    ``cel_match``, one CEL run per (expression, device) for the pool's
    lifetime; and ``order_cache``, the topology scorer's orderings keyed
    ``(driver, pool, names, want)``."""

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
        self.signature = (self.signature_of(slices)
                          if signature is None else signature)
        self.default_node = default_node
        buckets: dict[tuple[str, str], list[dict]] = {}
        for s in slices:
            buckets.setdefault(pool_key_of(s), []).append(s)
        self.pools: dict[tuple[str, str], PoolSnapshot] = {
            pk: PoolSnapshot(pk[0], pk[1], group, default_node)
            for pk, group in buckets.items()
        }
        self.order_cache: dict[tuple, list[str] | None] = {}
        self.candidates: list[Candidate] = [
            c for pk in sorted(self.pools)
            for c in self.pools[pk].candidates]
        self.by_key: dict[tuple, Candidate] = {
            c.key: c for c in self.candidates}
        pools_of_node: dict[str, set] = {}
        for pk in sorted(self.pools):
            for node in self.pools[pk].nodes:
                pools_of_node.setdefault(node, set()).add(pk)
        self._pools_of_node = {node: frozenset(pks)
                               for node, pks in pools_of_node.items()}
        # A node of one pool (the node-local pool) shares its list.
        self.by_node: dict[str, list[Candidate]] = {
            node: (self.pools[next(iter(pks))].by_node[node]
                   if len(pks) == 1 else
                   [c for pk in sorted(pks)
                    for c in self.pools[pk].by_node.get(node, ())])
            for node, pks in self._pools_of_node.items()}

    def make_ledger(self) -> CounterLedger:
        ledger = CounterLedger()
        for pk in sorted(self.pools):
            for sets in self.pools[pk].counter_seeds:
                ledger.seed(pk[0], pk[1], sets)
        return ledger

    def power_cap_of(self, node: str) -> int:
        """The node's power budget in watts (its published
        ``powerCapWatts``, else ``TPU_DRA_POWER_CAP_W``); 0 = uncapped."""
        cap = 0
        for pk in self._pools_of_node.get(node, ()):
            cap = max(cap, self.pools[pk].node_power_caps.get(node, 0))
        return cap if cap > 0 else power_cap_env()

    def cel_match(self, expression: str, prog: CelProgram,
                  cand: Candidate) -> bool:
        cache = self.pools[(cand.driver, cand.pool)].sel_cache
        key = (expression, cand.name)
        hit = cache.get(key)
        if hit is None:
            try:
                hit = bool(prog.matches_device(cand.device, cand.driver))
            except Exception:  # noqa: BLE001 - CEL eval boundary
                hit = False
            cache[key] = hit
        return hit

    def order_memo_get(self, key: tuple):
        """A cached topology ordering, or ``ORDER_MISS`` (a cached None
        is an answer: no usable coordinates)."""
        return self.order_cache.get(key, ORDER_MISS)

    def order_memo_put(self, key: tuple,
                       ordered: list[str] | None) -> None:
        self.order_cache[key] = ordered


ORDER_MISS = object()


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
    """Allocated-device keys, debited counters and power, folded from
    ResourceClaim allocations.

    ``observe`` is idempotent per claim (by uid, else namespace/name): a
    replayed allocation changes nothing, a changed one releases the old
    devices first. ``try_commit`` is the atomic check-and-reserve: the
    planned devices must still have a free slot and every counter and
    power budget must still fit, or it reports a conflict. Every
    mutation holds ``_alloc_lock``."""

    # The least-loaded-first node order re-sorts after max(1, nodes //
    # REORDER_NODES_PER_STEP) load changes: exact below 256 nodes.
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

    def ordered_nodes(self) -> list[str]:
        """Every node with candidates, least-loaded first (name tiebreak);
        read-only to the caller."""
        with self._alloc_lock:
            threshold = max(1, len(self.snapshot.by_node)
                            // self.REORDER_NODES_PER_STEP)
            if self._node_order is None or \
                    self._node_order_drift >= threshold:
                load = self.node_load
                self._node_order = sorted(
                    self.snapshot.by_node, key=lambda n: (load.get(n, 0), n))
                self._node_order_drift = 0
            return self._node_order

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
        """Drop a deleted claim; its devices are free again."""
        with self._alloc_lock:
            old = self._claims.pop(self.claim_id(claim), None)
            if not old:
                return False
            self._release_locked(old)
            return True

    def try_commit(self, claim: dict) -> bool:
        """Reserve one claim's planned allocation atomically; False on a
        conflict (the caller re-fits), True on a replay of the claim's
        own reservation. A reservation whose patch then fails is undone
        with ``forget``."""
        cid = self.claim_id(claim)
        keys = self._alloc_keys(claim)
        with self._alloc_lock:
            prior = self._claims.get(cid)
            if prior == keys:
                return True
            if prior is not None:
                # The claim was read unallocated, so a prior entry is a
                # deallocated claim's ghost: release it and judge anew.
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
                # The claim's summed draw on a node must fit under its
                # cap on top of what is debited.
                if cand.power_watts > 0:
                    want = power_want.get(cand.node, 0) + cand.power_watts
                    cap = self.snapshot.power_cap_of(cand.node)
                    if cap > 0 and \
                            self.power_used.get(cand.node, 0) + want > cap:
                        ok = False
                        break
                    power_want[cand.node] = want
                # Debit as it goes: N devices must not each fit alone
                # and overspend one counter together.
                self.ledger.debit(cand.driver, cand.pool, consumes)
                debited.append(cand)
            for cand in debited:
                self.ledger.credit(cand.driver, cand.pool,
                                   cand.device.get("consumesCounters"))
            if not ok:
                return False
            self._apply_locked(cid, keys)
            return True

    def ledger_snapshot(self) -> CounterLedger:
        """A copy of the counter ledger for a lock-free fit."""
        with self._alloc_lock:
            return self.ledger.copy()

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


class ClusterView:
    """The scheduler pass's read surface, in direct mode: every read
    lists (or gets) through the kube client, and KubeErrors reach the
    caller, so the call sites that fail closed keep failing closed. The
    inventory snapshot is cached and rebuilt only when the slices'
    signature changes."""

    def __init__(self, kube, default_node: str | None = None,
                 on_snapshot_build: Callable[[float], None] | None = None):
        self.kube = kube
        self._default_node = default_node
        self._on_snapshot_build = on_snapshot_build
        self._snapshot: InventorySnapshot | None = None
        self._snapshot_lock = threading.Lock()
        self._cd_windows: dict[str, list[str]] | None = None

    def start(self) -> "ClusterView":
        raise NotPortedError(f"{EVENT_MODE} is not ported yet")

    def begin_pass(self) -> None:
        """A pass starts with no memo of the ComputeDomain windows."""
        self._cd_windows = None

    def _list(self, group: str, version: str, resource: str) -> list[dict]:
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
        return self.kube.get("", "v1", "pods", name, namespace=namespace)

    def get_claim(self, name: str, namespace: str = "default") -> dict:
        return self.kube.get(*RESOURCE, "resourceclaims", name,
                             namespace=namespace)

    def get_template(self, name: str, namespace: str = "default") -> dict:
        return self.kube.get(*RESOURCE, "resourceclaimtemplates", name,
                             namespace=namespace)

    def snapshot(self) -> InventorySnapshot:
        """The inventory snapshot of the slices as listed now: the cached
        one while their (name, resourceVersion, generation) signature
        holds, else a fresh build."""
        slices = self.slices()
        sig = InventorySnapshot.signature_of(slices)
        with self._snapshot_lock:
            if self._snapshot is not None and \
                    self._snapshot.signature == sig:
                return self._snapshot
            t0 = time.monotonic()
            with tracing.span("sched.snapshot_build",
                              attrs={"slices": len(slices)}):
                snap = InventorySnapshot(slices, signature=sig,
                                         default_node=self._default_node)
            self._snapshot = snap
        if self._on_snapshot_build is not None:
            self._on_snapshot_build(time.monotonic() - t0)
        return snap

    def cd_windows(self) -> dict[str, list[str]]:
        """uid -> the preferred-node window of every ComputeDomain, for
        the pass; a list that fails gives no windows (cached, so N
        pending channel claims never mean N failing lists)."""
        if self._cd_windows is not None:
            return self._cd_windows
        try:
            cds = self._list(CD_GROUP, CD_VERSION, "computedomains")
        except KubeError:
            self._cd_windows = {}
            return {}
        windows: dict[str, list[str]] = {}
        for cd in cds:
            md = cd.get("metadata", {})
            ann = (md.get("annotations") or {}).get(
                PREFERRED_NODES_ANNOTATION, "")
            if md.get("uid"):
                windows[md["uid"]] = [n for n in ann.split(",") if n]
        self._cd_windows = windows
        return windows

