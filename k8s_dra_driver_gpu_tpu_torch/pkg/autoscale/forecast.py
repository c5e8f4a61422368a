"""Demand forecasting over the fleet rings (the JAX package's
``pkg/autoscale/forecast.py``).

The fleet aggregator (``pkg/fleetstate``) records each pool's partition
slot occupancy and the pending claims every scheduler pass; this module
projects near-term partition demand per pool from those rings, so the
autoscale controller can ask the nodes to realize partitions before a
burst's first attaches arrive (``PartitionEngine.set_prewarm`` consumes
the hint on the node):

- **Trend**: a least-squares slope over the recent
  ``partition_slots_used`` points, projected ``horizon_s`` ahead; only a
  rising trend forecasts anything (pre-warming only adds).
- **Freshness**: points older than ``window_s`` are ignored, and a ring
  whose newest point is older than ``stale_s`` forecasts zero, so a burst
  that came and went ages out.
- **Starvation**: claims pending now (the ``pending_history`` ring) add
  to a pool whose own ring is rising.

Pure and stateless: rings in, ``{pool: additional slots}`` out. The knobs
are the JAX package's ``TPU_DRA_FORECAST_*``.
"""

from __future__ import annotations

import math
import time

from .. import positive_float_env

#: How far ahead the trend is projected (seconds).
FORECAST_HORIZON_S = positive_float_env(
    "TPU_DRA_FORECAST_HORIZON_S", default=120.0, floor=1.0)
#: Ring points older than this never enter the regression.
FORECAST_WINDOW_S = positive_float_env(
    "TPU_DRA_FORECAST_WINDOW_S", default=600.0, floor=5.0)
#: A pool whose newest point is older than this forecasts zero.
FORECAST_STALE_S = positive_float_env(
    "TPU_DRA_FORECAST_STALE_S", default=180.0, floor=1.0)
#: The fewest ring points a trend is trusted from.
FORECAST_MIN_POINTS = int(positive_float_env(
    "TPU_DRA_FORECAST_MIN_POINTS", default=4, floor=2))


class DemandForecaster:
    """Projects per-pool partition-slot demand from the fleet
    aggregator's rings."""

    def __init__(self, horizon_s: float = 0.0, window_s: float = 0.0,
                 stale_s: float = 0.0, min_points: int = 0):
        self.horizon_s = horizon_s or FORECAST_HORIZON_S
        self.window_s = window_s or FORECAST_WINDOW_S
        self.stale_s = stale_s or FORECAST_STALE_S
        self.min_points = min_points or FORECAST_MIN_POINTS

    def forecast_slots(self, history: list[dict],
                       now: float | None = None) -> int:
        """The additional slots one pool's ring projects at
        ``now + horizon_s``: 0 unless a fresh ramp is still rising."""
        now = time.time() if now is None else now
        pts = [(float(p["ts"]), int(p["partition_slots_used"]))
               for p in history or []
               if p.get("partition_slots_used") is not None
               and p.get("ts") is not None]
        recent = [(t, v) for t, v in pts if now - t <= self.window_s]
        if len(recent) < self.min_points:
            return 0
        last_t, last_v = recent[-1]
        if now - last_t > self.stale_s:
            return 0  # the ring stopped moving: the ramp decayed
        if last_v <= recent[-2][1]:
            # A step that landed and plateaued is served capacity, not
            # demand in flight: projecting its slope would churn writes.
            return 0
        slope = self._slope(recent)
        if slope <= 0:
            return 0
        return max(int(math.ceil(slope * self.horizon_s)), 0)

    @staticmethod
    def _slope(points: list[tuple[float, int]]) -> float:
        """Least-squares slope (slots a second) of (ts, used)."""
        n = len(points)
        mean_t = sum(t for t, _ in points) / n
        mean_v = sum(v for _, v in points) / n
        denom = sum((t - mean_t) ** 2 for t, _ in points)
        if denom <= 0:
            return 0.0
        return sum((t - mean_t) * (v - mean_v)
                   for t, v in points) / denom

    def forecast(self, fleet_snapshot: dict,
                 now: float | None = None) -> dict[str, int]:
        """``{pool label: additional slots}`` over a fleet snapshot's
        pools (zero forecasts left out). The sustained pending count (the
        fleet's, unattributed to a pool) boosts only pools whose own ring
        is rising, so starvation never fans out over flat pools."""
        now = time.time() if now is None else now
        pending = 0
        tail = (fleet_snapshot.get("pending_history") or [])[-5:]
        if tail:
            pending = max(int(p.get("pending", 0)) for p in tail)
            if now - float(tail[-1].get("ts", 0)) > self.stale_s:
                pending = 0
        out: dict[str, int] = {}
        for label, entry in (fleet_snapshot.get("pools") or {}).items():
            history = entry.get("history") or []
            current = entry.get("current") or {}
            if current.get("partition_slots_total") in (None, 0):
                continue  # the pool publishes no partition slots
            add = self.forecast_slots(history, now=now)
            if add > 0:
                out[label] = add + pending
        return out
