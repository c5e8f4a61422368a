"""Fleet telemetry state: the per-chip telemetry ring (node side) and
the fleet aggregator (scheduler side) -- the JAX package's
``pkg/fleetstate.py``, the port's copy. On a GPU node a "chip" is a GPU
(``gpu-<i>``) and ``ici_link_errors`` is the sum of NVLink error counters
(``tpulib.NvmlLib.chip_telemetry``).

The telemetry plane has three stations; this module owns the state at
both ends:

- **TelemetryRing** (every node plugin): a compact rolling in-memory
  ring of per-chip power/thermal/HBM/duty-cycle samples fed by the
  health-poll loop (kubeletplugin/health.py sampling the
  ``tpulib.chip_telemetry`` seam) and served at ``/debug/telemetry``
  on the plugin's metrics listener. Bounded (``TPU_DRA_TELEMETRY_RING``
  samples per chip), no external store to deploy.
- **FleetAggregator** (the scheduler): folds per-node telemetry --
  published as quantized ResourceSlice device attributes riding the
  existing content-hash-diffed publish path, so a converged republish
  stays ZERO kube writes -- together with the scheduler's own
  ``AllocationState`` and ``pkg/topology`` into fleet time-series:
  per-pool utilization, ``fragmentation_score`` /
  ``largest_free_shape`` history, and pending-claim demand vs. free
  capacity. Exported as ``tpu_dra_fleet_*`` gauges and served as a
  JSON snapshot at ``/debug/fleet``.

Mutation discipline: ring / aggregator state mutations
(``record_sample``, ``fold_*``) happen ONLY inside this module,
pkg/anomaly.py, and kubeletplugin/health.py -- every other caller goes
through the read surface (``latest``/``series``/``snapshot``) or the
public fold entry (``observe_pass``), so the time-series can never be
corrupted from a random call site. (The JAX package checks this with its
lint rule TPUDRA013; the port has no linter.)

The defrag trigger signal (``frag_signal``) is read by the defrag
controller (``pkg/defrag.py``); the tenant-demand surface
(``attach_profile_store``) shows the autoscale controller's store
(``DraScheduler.attach_autoscaler``).
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections import deque

from . import positive_float_env
from .partition.spec import parse_partition_device_name
from .schedcache import ATTR_POWER_CAP, power_cap_env
from .topology import TorusGrid
from .topology.score import (
    attr_int,
    frag_from_largest,
    largest_free_shape,
)

#: Samples kept per chip in the node ring (at the default 5s health
#: poll cadence, 360 samples = 30 minutes of history).
DEFAULT_RING_SAMPLES = int(positive_float_env(
    "TPU_DRA_TELEMETRY_RING", default=360, floor=16))
#: Fleet time-series points kept per pool by the scheduler aggregator.
DEFAULT_FLEET_HISTORY = int(positive_float_env(
    "TPU_DRA_FLEET_HISTORY", default=512, floor=16))
#: How long a chip's last known power reading is carried when a fold
#: sees no (or a zero) power attribute for it -- the last-known-demand
#: fallback of the tenant store, applied to power: a single dropped
#: poll must not fake instant power headroom and let the scorer pile
#: claims onto a hot host. Past the TTL the chip reads as no data.
POWER_SAMPLE_TTL_S = positive_float_env(
    "TPU_DRA_POWER_SAMPLE_TTL_S", default=60.0, floor=1.0)

#: ResourceSlice attribute names the node plugin publishes (quantized;
#: see kubeletplugin/driver.py) and the aggregator folds.
ATTR_POWER = "telemetryPowerWatts"
ATTR_TEMP = "telemetryTempCelsius"
ATTR_DUTY = "telemetryDutyPct"
ATTR_HBM = "telemetryHbmUsedPct"
ATTR_ICI_ERR = "telemetryIciErrors"
TELEMETRY_ATTRS = (ATTR_POWER, ATTR_TEMP, ATTR_DUTY, ATTR_HBM,
                   ATTR_ICI_ERR)


class TelemetryRing:
    """Bounded per-chip ring of telemetry samples (the
    ``/debug/telemetry`` source on every node plugin)."""

    def __init__(self, samples_per_chip: int = 0):
        self._lock = threading.Lock()
        self._maxlen = max(16, int(samples_per_chip
                                   or DEFAULT_RING_SAMPLES))
        self._series: dict[int, deque] = {}
        self.recorded_total = 0

    def record_sample(self, sample) -> None:
        """Append one ChipTelemetry sample (mutations stay in the
        telemetry layer)."""
        doc = sample.to_dict() if hasattr(sample, "to_dict") else dict(
            sample)
        doc["ts"] = time.time()
        chip = int(doc.get("chip", -1))
        with self._lock:
            ring = self._series.get(chip)
            if ring is None:
                ring = self._series[chip] = deque(maxlen=self._maxlen)
            ring.append(doc)
            self.recorded_total += 1

    def latest(self) -> dict[int, dict]:
        """Most recent sample per chip."""
        with self._lock:
            return {chip: ring[-1] for chip, ring in
                    self._series.items() if ring}

    def series(self, chip: int) -> list[dict]:
        """Full retained history for one chip, oldest first."""
        with self._lock:
            ring = self._series.get(int(chip))
            return list(ring) if ring else []

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "samples_per_chip": self._maxlen,
                "recorded_total": self.recorded_total,
                "chips": {str(chip): list(ring)
                          for chip, ring in self._series.items()},
            }

    def clear(self) -> None:
        with self._lock:
            self._series.clear()

    # -- /debug/telemetry endpoint (pkg/httpserver handler signature) ---------

    def telemetry_endpoint(self) -> tuple[int, str, bytes]:
        body = json.dumps(self.snapshot(), sort_keys=True).encode()
        return 200, "application/json", body


class FleetAggregator:
    """Scheduler-side fleet state: per-pool utilization / fragmentation
    time-series plus per-node telemetry folded from published slice
    attributes.

    ``observe_pass`` is the one public entry (called from the
    scheduler's full sync pass); everything it learns lands in bounded
    history rings and the optional duck-typed ``metrics`` sink
    (pkg.metrics.FleetMetrics). Reads never block a sync: the JSON
    snapshot is rebuilt from the rings under a short lock.
    """

    def __init__(self, metrics=None, history: int = 0):
        self._lock = threading.Lock()
        self._history = max(16, int(history or DEFAULT_FLEET_HISTORY))
        self.metrics = metrics
        # (driver, pool) -> deque of per-pass points
        self._pools: dict[tuple[str, str], deque] = {}
        # node -> latest folded telemetry aggregate
        self._nodes: dict[str, dict] = {}
        self._pending = 0
        self._last_pass_ts = 0.0
        self.passes_total = 0
        # Labels currently exported through the metrics sink (pruned
        # when a pool/node leaves the snapshot; the power-headroom set
        # additionally prunes when a still-present pool's caps vanish
        # -- a gauge must never freeze at a stale headroom for a pool
        # whose power model turned off).
        self._metric_pools: set[str] = set()
        self._metric_nodes: set[str] = set()
        self._metric_power_pools: set[str] = set()
        # Defrag trigger hysteresis (pkg/defrag): pool key -> wall
        # clock its fragmentation first crossed the trigger threshold.
        # Armed pools stay armed until frag falls to the RELEASE
        # threshold, so a pool oscillating just under the trigger
        # cannot flap the controller on and off.
        self._frag_armed: dict[tuple[str, str], float] = {}
        # Pools present in the LAST fold: the trigger signal only
        # considers these -- a vanished pool's ring keeps its history
        # for /debug/fleet, but a frozen last reading must neither
        # keep firing the controller nor hold a stale armed clock
        # that would skip the sustain window on return.
        self._live_pools: set[tuple[str, str]] = set()
        # Pending-demand ring: (ts, pending claims) per pass. The
        # autoscaler's starvation signal and the /debug/fleet history
        # next to the per-pool frag/utilization rings.
        self._pending_ring: deque = deque(maxlen=self._history)
        # Optional TenantProfileStore (pkg/partition/profiles): when
        # attached, /debug/fleet surfaces the per-tenant demand
        # percentiles the autoscale planner sizes against -- operators
        # see what the controller sees.
        self._profile_store = None
        # Last known per-device power reading, (ts, watts) keyed by
        # candidate key: the carry source when a fold sees a device
        # with a missing/zero power attribute (POWER_SAMPLE_TTL_S).
        self._last_dev_power: dict[tuple, tuple[float, int]] = {}

    def attach_profile_store(self, store) -> None:
        """Surface a TenantProfileStore's windowed percentiles in the
        fleet snapshot (read-only: the aggregator never mutates the
        store)."""
        self._profile_store = store

    # -- the fold (mutations; only observe_pass calls in) -----------------------

    def observe_pass(self, snapshot, alloc, pending_claims: int,
                     grid_fn=None) -> dict:
        """Fold one scheduler pass: ``snapshot`` is the
        InventorySnapshot, ``alloc`` the AllocationState, and
        ``pending_claims`` the claims still waiting for capacity.
        ``grid_fn(candidates) -> TorusGrid`` injects the scheduler's
        grid builder (defaults to TorusGrid.from_devices). Returns the
        per-pool points folded (tests / the debug endpoint)."""
        t0 = time.monotonic()
        now = time.time()
        by_pool: dict[tuple[str, str], list] = {}
        for cand in snapshot.candidates:
            by_pool.setdefault((cand.driver, cand.pool), []).append(cand)
        allocated = alloc.allocated if alloc is not None else frozenset()
        holder_counts = (alloc.slot_counts()
                         if alloc is not None
                         and hasattr(alloc, "slot_counts") else {})
        points = {}
        nodes: dict[str, dict] = {}
        env_cap = power_cap_env()
        for key, cands in by_pool.items():
            total = len(cands)
            used = sum(1 for c in cands if c.key in allocated)
            free = [c for c in cands if c.key not in allocated]
            frag, largest = self._fold_frag(cands, free, grid_fn)
            # Partition-slot occupancy (the autoscaler's input next to
            # frag/utilization): pt- devices' tenant slots vs holders.
            pt = [c for c in cands
                  if parse_partition_device_name(c.name) is not None]
            slots_total = sum(c.slots for c in pt)
            slots_used = sum(min(holder_counts.get(c.key, 0), c.slots)
                             for c in pt)
            pool_power, pool_caps = self._fold_node_telemetry(
                cands, nodes, now)
            cap_total = sum(
                (cap if cap > 0 else env_cap)
                for cap in pool_caps.values()) if pool_caps else 0
            points[key] = {
                "ts": round(now, 3),
                "total_devices": total,
                "allocated_devices": used,
                "free_devices": total - used,
                "utilization": round(used / total, 4) if total else 0.0,
                "fragmentation_score": frag,
                "largest_free_shape": largest,
                "partition_slots_total": slots_total,
                "partition_slots_used": slots_used,
                "partition_slot_occupancy": (
                    round(slots_used / slots_total, 4)
                    if slots_total else None),
                # Power envelope (2501.17752 scheduling input): summed
                # device draw vs the summed node caps of this pool.
                # None when no cap is known (model off).
                "power_watts": pool_power,
                "power_cap_watts": cap_total or None,
                "power_headroom_watts": (
                    max(cap_total - pool_power, 0)
                    if cap_total else None),
            }
        self._finalize_nodes(nodes)
        # Age the carry map: a device gone past the TTL reads as no
        # data everywhere instead of a frozen plausible wattage.
        for dkey in [k for k, (ts, _w) in self._last_dev_power.items()
                     if now - ts > POWER_SAMPLE_TTL_S]:
            del self._last_dev_power[dkey]
        with self._lock:
            for key, point in points.items():
                ring = self._pools.get(key)
                if ring is None:
                    ring = self._pools[key] = deque(maxlen=self._history)
                ring.append(point)
            # Pools that vanished from the snapshot keep their history
            # (the ring is the record of what happened); nodes reflect
            # the CURRENT inventory only.
            self._nodes = nodes
            self._pending = int(pending_claims)
            self._pending_ring.append(
                {"ts": round(now, 3), "pending": int(pending_claims)})
            self._last_pass_ts = now
            self.passes_total += 1
            self._live_pools = set(points)
            for key in [k for k in self._frag_armed
                        if k not in self._live_pools]:
                del self._frag_armed[key]
        if self.metrics is not None:
            try:
                # The fold-cost histogram the score-memo satellite is
                # judged against: largest_free_shape memoization
                # (pkg/topology/score.py) is what keeps this flat as
                # pools multiply. getattr: the sink is duck-typed and
                # older test doubles may not carry the histogram.
                fold_hist = getattr(self.metrics, "fold_seconds", None)
                if fold_hist is not None:
                    fold_hist.observe(time.monotonic() - t0)
                self.metrics.set_pending(int(pending_claims))
                pool_labels = {f"{driver}/{pool}"
                               for driver, pool in points}
                # getattr: the sink is duck-typed and older test
                # doubles may not carry the power gauge.
                pool_power_fn = getattr(self.metrics, "set_pool_power",
                                        None)
                power_pools: set[str] = set()
                for (driver, pool), point in points.items():
                    self.metrics.set_pool(
                        f"{driver}/{pool}", point["utilization"],
                        point["free_devices"])
                    if pool_power_fn is not None and \
                            point.get("power_headroom_watts") \
                            is not None:
                        pool_power_fn(f"{driver}/{pool}",
                                      point["power_headroom_watts"])
                        power_pools.add(f"{driver}/{pool}")
                # A pool whose caps vanished this pass (model turned
                # off) drops its headroom gauge instead of freezing.
                power_prune_fn = getattr(self.metrics,
                                         "remove_pool_power", None)
                if power_prune_fn is not None:
                    for label in self._metric_power_pools - power_pools:
                        power_prune_fn(label)
                self._metric_power_pools = power_pools
                for node, agg in nodes.items():
                    self.metrics.set_node(
                        node, agg.get("power_watts", 0.0),
                        agg.get("temp_celsius", 0.0))
                # Pools/nodes gone from THIS pass stop exporting: a
                # retired pool or dead node must not freeze its last
                # reading into fleet sums.
                for label in self._metric_pools - pool_labels:
                    self.metrics.remove_pool(label)
                for node in self._metric_nodes - set(nodes):
                    self.metrics.remove_node(node)
                self._metric_pools = pool_labels
                self._metric_nodes = set(nodes)
            except Exception:  # noqa: BLE001 - metrics sink best-effort
                pass
        return points

    @staticmethod
    def _fold_frag(cands, free, grid_fn) -> tuple[float | None,
                                                  int | None]:
        """Fragmentation of a pool's free chips via pkg/topology; None
        when the pool publishes no usable ICI coordinates."""
        try:
            grid = (grid_fn or
                    (lambda cs: TorusGrid.from_devices(
                        [c.device for c in cs])))(cands)
            free_cells = {grid.coords[c.name] for c in free
                          if c.name in grid.coords}
            if not grid.coords:
                return None, None
            _, chips = largest_free_shape(grid, free_cells)
            return (round(frag_from_largest(chips, len(free_cells)), 4),
                    chips)
        except Exception:  # noqa: BLE001 - uncoordinated pools
            return None, None

    def _fold_node_telemetry(self, cands, nodes: dict[str, dict],
                             now: float) -> tuple[int, dict[str, int]]:
        """Aggregate the quantized per-device telemetry attributes the
        node plugins publish into one per-node view (sum of power,
        max temp, mean duty, max HBM-used fraction, sum of ICI error
        counters). Returns ``(pool power watts, {node: published power
        cap})`` for this candidate group's pool point.

        A device with a MISSING or ZERO power attribute carries its
        last windowed reading (``POWER_SAMPLE_TTL_S``) instead of
        folding as 0 W -- one dropped poll must not fake instant power
        headroom under a pile of claims; past the TTL it genuinely
        reads as no data (the replace-semantics contract)."""
        pool_power = 0
        pool_caps: dict[str, int] = {}
        for cand in cands:
            attrs = cand.device.get("attributes") or {}
            vals = {}
            for name in TELEMETRY_ATTRS:
                entry = attrs.get(name)
                if isinstance(entry, dict) and "int" in entry:
                    try:
                        vals[name] = int(entry["int"])
                    except (TypeError, ValueError):
                        pass
            cap = max(attr_int(attrs, ATTR_POWER_CAP), 0)
            if cap > 0 or vals:
                pool_caps[cand.node] = max(
                    pool_caps.get(cand.node, 0), cap)
            power = vals.get(ATTR_POWER, 0)
            if power > 0:
                self._last_dev_power[cand.key] = (now, power)
            else:
                carried = self._last_dev_power.get(cand.key)
                if carried is not None and \
                        now - carried[0] <= POWER_SAMPLE_TTL_S:
                    power = carried[1]
                    vals[ATTR_POWER] = power
            if not vals:
                continue
            pool_power += power
            agg = nodes.setdefault(cand.node, {
                "chips": 0, "power_watts": 0, "temp_celsius": 0,
                "duty_pct_sum": 0, "hbm_used_pct": 0,
                "ici_link_errors": 0,
            })
            agg["chips"] += 1
            agg["power_watts"] += vals.get(ATTR_POWER, 0)
            agg["temp_celsius"] = max(agg["temp_celsius"],
                                      vals.get(ATTR_TEMP, 0))
            agg["duty_pct_sum"] += vals.get(ATTR_DUTY, 0)
            agg["hbm_used_pct"] = max(agg["hbm_used_pct"],
                                      vals.get(ATTR_HBM, 0))
            agg["ici_link_errors"] += vals.get(ATTR_ICI_ERR, 0)
        return pool_power, pool_caps

    @staticmethod
    def _finalize_nodes(nodes: dict[str, dict]) -> None:
        """One-shot finalize AFTER every pool folded: a node's devices
        may span several (driver, pool) groups, so the running sum
        must survive across _fold_node_telemetry calls."""
        for agg in nodes.values():
            if agg["chips"]:
                agg["duty_pct_mean"] = round(
                    agg.pop("duty_pct_sum") / agg["chips"], 1)

    # -- defrag trigger signal (pkg/defrag.DefragController) ------------------

    def frag_signal(self, trigger: float, release: float,
                    sustain_s: float,
                    demand: set | None = None,
                    now: float | None = None) -> dict:
        """Per-pool defrag trigger evaluation over the fragmentation
        rings, with hysteresis.

        A pool ARMS when its latest ``fragmentation_score`` crosses
        ``trigger`` and stays armed until the score falls back to
        ``release`` (values between the two keep the armed state --
        the anti-flap band). An armed pool FIRES when ``demand``
        contains its key (a pending large-shape claim is starving
        NOW) or when it has stayed armed for ``sustain_s`` seconds.

        Returns ``{(driver, pool): {"fragmentation_score",
        "largest_free_shape", "armed_since", "fire"}}`` for every
        armed pool. Read-only apart from the hysteresis bookkeeping;
        the controller owns everything downstream (planning, budgets,
        cooldown)."""
        now = time.time() if now is None else now
        demand = demand or set()
        out: dict[tuple[str, str], dict] = {}
        with self._lock:
            for key in sorted(self._live_pools):
                ring = self._pools.get(key)
                point = ring[-1] if ring else None
                frag = (point or {}).get("fragmentation_score")
                if frag is None or frag <= release:
                    # Healed (or uncoordinated): disarm.
                    self._frag_armed.pop(key, None)
                    continue
                if frag < trigger and key not in self._frag_armed:
                    continue  # in the hysteresis band, never armed
                armed_since = self._frag_armed.setdefault(key, now)
                out[key] = {
                    "fragmentation_score": frag,
                    "largest_free_shape": point.get(
                        "largest_free_shape"),
                    "armed_since": armed_since,
                    "fire": (key in demand
                             or now - armed_since >= sustain_s),
                }
        return out

    # -- read surface ---------------------------------------------------------

    def pending_recent(self, points: int = 5) -> int:
        """Max pending-claim count over the last ``points`` passes:
        the autoscaler's sustained-starvation signal (one noisy pass
        neither fires nor masks it)."""
        with self._lock:
            tail = list(self._pending_ring)[-max(points, 1):]
            return max((p["pending"] for p in tail), default=0)

    def snapshot(self) -> dict:
        tenants = (self._profile_store.percentiles()
                   if self._profile_store is not None else None)
        with self._lock:
            out = {
                "ts": self._last_pass_ts,
                "passes_total": self.passes_total,
                "pending_claims": self._pending,
                "pending_history": list(self._pending_ring),
                "pools": {
                    f"{driver}/{pool}": {
                        "current": ring[-1] if ring else None,
                        "history": list(ring),
                    }
                    for (driver, pool), ring in self._pools.items()
                },
                "nodes": dict(self._nodes),
            }
            if tenants is not None:
                # What the autoscale planner sees: windowed per-tenant
                # demand percentiles (pkg/autoscale reads the same
                # store).
                out["tenant_demand"] = tenants
            return out

    # -- /debug/fleet endpoint (pkg/httpserver handler signature) -------------

    def fleet_endpoint(self) -> tuple[int, str, bytes]:
        body = json.dumps(self.snapshot(), sort_keys=True).encode()
        return 200, "application/json", body


# -- process-wide defaults (what the MetricsServer debug routes serve) --------

_default_ring: TelemetryRing | None = None
_default_fleet: FleetAggregator | None = None
_default_lock = threading.Lock()


def default_ring() -> TelemetryRing:
    """The process-wide telemetry ring (served at /debug/telemetry)."""
    global _default_ring
    if _default_ring is None:
        with _default_lock:
            if _default_ring is None:
                _default_ring = TelemetryRing()
    return _default_ring


def set_default_ring(ring: TelemetryRing) -> TelemetryRing:
    """Swap the process ring (tests / bench isolation)."""
    global _default_ring
    with _default_lock:
        _default_ring = ring
    return ring


def default_fleet() -> FleetAggregator:
    """The process-wide fleet aggregator (served at /debug/fleet)."""
    global _default_fleet
    if _default_fleet is None:
        with _default_lock:
            if _default_fleet is None:
                _default_fleet = FleetAggregator()
    return _default_fleet


def set_default_fleet(fleet: FleetAggregator) -> FleetAggregator:
    """Swap the process aggregator (the scheduler installs its own)."""
    global _default_fleet
    with _default_lock:
        _default_fleet = fleet
    return fleet


def telemetry_enabled(env=os.environ) -> bool:
    """The master telemetry switch (``TPU_DRA_TELEMETRY``, default on):
    off disables sampling, ring, anomaly detection, and slice-attribute
    publication in one place (the bench overhead gate's off side)."""
    return env.get("TPU_DRA_TELEMETRY", "1") not in ("0", "false",
                                                     "False")
