"""Prometheus metrics of the drivers (the JAX package's
``pkg/metrics.py``; upstream pkg/metrics: DRA request duration
histograms, in-flight and error counters, the prepared-devices gauge --
dra_requests.go:27-151; the ComputeDomain status gauge --
computedomain_cluster.go; the exposition server --
prometheus_httpserver.go).

The families, their help strings, label names and buckets are the JAX
package's, on the port's own registry (``pkg/exposition.py``; the port
does not import ``prometheus_client``). Ported: ``register_build_info``,
``ClaimSLOMetrics``, ``DRARequestMetrics`` (with its ``telemetry``
member, ``TelemetryMetrics``), ``ResilienceMetrics``,
``RecoveryMetrics``, ``PartitionMetrics``, ``TelemetryMetrics``,
``FleetMetrics``, ``ComputeDomainMetrics``, ``PlacementMetrics``,
``WorkQueueMetrics``, ``SchedulerMetrics``, ``DefragMetrics``,
``MigrationMetrics``, ``AutoscaleMetrics`` and ``MetricsServer``: every
family of the JAX module.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

from . import fleetstate, flightrecorder, tracing
from .debug import debug_stacks_endpoint
from .exposition import (CONTENT_TYPE_LATEST, CollectorRegistry, Counter,
                         Gauge, Histogram, generate_latest)
from .httpserver import SimpleHTTPEndpoint

_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1, 2.5, 5, 10, 30, 60)


def register_build_info(registry: CollectorRegistry) -> Gauge:
    """The ``tpu_dra_build_info`` info-gauge every binary exposes:
    value 1, labels carrying the VERSION-file version and the feature
    gates that ``FEATURE_GATES`` enables. Call once per registry."""
    from .. import __version__  # noqa: PLC0415
    from .featuregates import (  # noqa: PLC0415
        DEFAULTS,
        FeatureGateError,
        FeatureGates,
    )

    try:
        gates = FeatureGates.parse(os.environ.get("FEATURE_GATES", ""))
    except FeatureGateError:
        gates = FeatureGates()
    active = ",".join(sorted(
        name for name in DEFAULTS if gates.is_enabled(name)))
    g = Gauge(
        "tpu_dra_build_info",
        "Build/version identity (value is always 1; the labels carry "
        "the information).",
        ["version", "feature_gates"],
        registry=registry,
    )
    g.labels(version=__version__, feature_gates=active).set(1)
    return g


class ClaimSLOMetrics:
    """Claim-lifecycle SLO accounting (pkg/tracing.py's metric half).

    One histogram, ``tpu_dra_claim_e2e_seconds``, labeled by lifecycle
    phase so the end-to-end latency a user feels decomposes into WHO
    owes it: ``queued`` (dirty-key enqueue -> sync start, the
    scheduler's backlog), ``fit`` (candidate walk + constraint DFS),
    ``commit`` (atomic reserve), ``patch`` (the allocation kube write),
    ``prepare`` (node-side NodePrepareResources, reported by both
    kubelet plugins), and ``evict`` (recovery-controller eviction to
    re-placement). In the port the scheduler observes ``queued`` (event
    mode), ``fit``, ``commit`` and ``patch``, the node plugins
    ``prepare``, the recovery controller attached to a scheduler
    ``evict``. Observations carry the
    claim's trace id as an exemplar when one is active (kept on the
    bucket; the text format 0.0.4 does not print it)."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.e2e = Histogram(
            "tpu_dra_claim_e2e_seconds",
            "Per-phase claim-lifecycle latency (queued/fit/commit/"
            "patch/prepare on the hot path; evict for recovery), with "
            "trace-id exemplars linking outliers to /debug/traces.",
            ["phase"],
            buckets=_BUCKETS,
            registry=self.registry,
        )
        # labels() is ~4us of dict/validation per call; the phase set
        # is tiny and this sits on the per-allocation hot path.
        self._children: dict = {}

    def observe(self, phase: str, seconds: float,
                trace_id: str = "") -> None:
        h = self._children.get(phase)
        if h is None:
            h = self._children[phase] = self.e2e.labels(phase)
        amount = max(float(seconds), 0.0)
        if trace_id:
            try:
                h.observe(amount, {"trace_id": trace_id[:32]})
                return
            except (TypeError, ValueError):
                pass  # an oversized exemplar
        h.observe(amount)


class DRARequestMetrics:
    """Per-operation DRA request metrics (reference dra_requests.go)."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.duration = Histogram(
            "tpu_dra_request_duration_seconds",
            "Duration of DRA plugin requests by operation.",
            ["operation"],
            buckets=_BUCKETS,
            registry=self.registry,
        )
        self.in_flight = Gauge(
            "tpu_dra_requests_in_flight",
            "Number of DRA plugin requests currently being served.",
            ["operation"],
            registry=self.registry,
        )
        self.errors = Counter(
            "tpu_dra_request_errors_total",
            "Total DRA plugin request errors by operation.",
            ["operation"],
            registry=self.registry,
        )
        self.prepared_devices = Gauge(
            "tpu_dra_prepared_devices",
            "Number of devices currently prepared for claims.",
            registry=self.registry,
        )
        self.device_taints = Gauge(
            "tpu_dra_device_taints",
            "Current DRA device taints by health kind.",
            ["kind"],
            registry=self.registry,
        )
        self.tenancy_agents = Gauge(
            "tpu_dra_tenancy_agents",
            "Supervised multi-tenancy enforcement agents running.",
            registry=self.registry,
        )
        # Per-segment breakdown of the prepare/unprepare pipeline
        # (prep_lock_wait, ckpt_fsync_wait, prep_devices, ...): the
        # observability half of the sharded-lock work -- lock-wait
        # regressions show up here before they move the p99.
        # Publish-diff effectiveness (pkg/sliceutil): slice writes
        # avoided because the live spec already matched by content
        # hash. A health-republish storm that stays write-free shows
        # up here instead of as apiserver load.
        self.slice_publish_skipped = Counter(
            "tpu_dra_slice_publish_skipped_total",
            "ResourceSlice writes skipped by the content-hash publish "
            "diff (unchanged spec, no PUT issued).",
            registry=self.registry,
        )
        self.prepare_segment = Histogram(
            "tpu_dra_prepare_segment_seconds",
            "Wall time of instrumented prepare/unprepare segments "
            "(lock waits, checkpoint fsync waits, device setup).",
            ["operation", "segment"],
            buckets=_BUCKETS,
            registry=self.registry,
        )
        # The node plugin's slice of the claim-lifecycle SLO histogram
        # (phase="prepare"); the scheduler exports the control-plane
        # phases from its own registry (SchedulerMetrics.slo).
        self.slo = ClaimSLOMetrics(registry=self.registry)
        # Per-chip power/thermal/utilization telemetry + anomaly
        # episode counts (the fleet telemetry plane's node half; fed
        # by the health-poll loop through kubeletplugin/driver.py).
        # Labeled families export nothing until a chip reports.
        self.telemetry = TelemetryMetrics(registry=self.registry)

    def observe_segments(self, operation: str, segments: dict) -> None:
        """DeviceState.segment_observer hook: one histogram sample per
        timed segment of a prepare/unprepare."""
        for name, dt in segments.items():
            self.prepare_segment.labels(operation, name).observe(dt)

    def set_taints(self, taints) -> None:
        """Reconcile the taint gauge from the full current taint list
        (clears kinds that no longer apply)."""
        counts: dict[str, int] = {}
        for t in taints:
            kind = t.key.rsplit("/", 1)[-1]
            counts[kind] = counts.get(kind, 0) + 1
        seen = getattr(self, "_taint_kinds", set())
        for kind in seen - set(counts):
            self.device_taints.labels(kind).set(0)
        for kind, n in counts.items():
            self.device_taints.labels(kind).set(n)
        self._taint_kinds = seen | set(counts)

    @contextmanager
    def observe(self, operation: str):
        self.in_flight.labels(operation).inc()
        start = time.monotonic()
        try:
            yield
        except BaseException:
            self.errors.labels(operation).inc()
            raise
        finally:
            self.duration.labels(operation).observe(time.monotonic() - start)
            self.in_flight.labels(operation).dec()


class ResilienceMetrics:
    """Retry / circuit-breaker / gang-abort / quarantine observability
    (pkg/retry.py, kubeletplugin/health.py through the kubelet driver's
    ``resilience`` hook, computedomain/plugin/driver.py).

    Every self-healing decision the stack takes under failure shows up
    here: a rising ``retry_total`` is an apiserver (or network) getting
    sick, ``circuit_open_total`` is it being DOWN, ``gang_abort_total``
    is straggler nodes blowing multi-host prepare deadlines, and
    ``quarantine_total`` is chips flapping their way out of the
    schedulable pool."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.retries = Counter(
            "tpu_dra_retry_total",
            "Retried kube API attempts by verb (RetryingKubeClient).",
            ["verb"],
            registry=self.registry,
        )
        self.circuit_open = Counter(
            "tpu_dra_circuit_open_total",
            "Times the kube circuit breaker tripped open.",
            registry=self.registry,
        )
        self.gang_aborts = Counter(
            "tpu_dra_gang_abort_total",
            "Gang prepares aborted at the rendezvous deadline (own "
            "node's state unwound, failure reported retriable).",
            registry=self.registry,
        )
        self.quarantines = Counter(
            "tpu_dra_quarantine_total",
            "Chips escalated to NoSchedule quarantine after repeated "
            "non-fatal health events.",
            ["device"],
            registry=self.registry,
        )


class RecoveryMetrics:
    """Permanent-failure recovery observability (pkg/recovery.py +
    kubeletplugin/reconcile.py).

    Two producers share this family: the scheduler-side eviction &
    migration controller (evictions, replacements, deadline failures,
    declared permanent failures) and the per-node reconciliation sweep
    (orphans repaired, cross-layer drift). A healthy fleet shows
    ``permanent_failures_total`` rising only with real hardware events,
    every eviction paired with a ``replaced``/``failed`` retirement,
    ``active_evictions`` returning to zero, and a sweep that finds
    nothing (``reconcile_drift`` at 0) -- persistent drift means some
    layer is leaking state faster than the sweep repairs it."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.permanent_failures = Counter(
            "tpu_dra_recovery_permanent_failures_total",
            "Claims declared permanently failed, by failure source "
            "(node = NotReady past deadline / deleted; device = fatal "
            "chip taint; gang = healthy companion of a failed gang "
            "member; sweep = node sweep found devices gone).",
            ["source"],
            registry=self.registry,
        )
        self.evictions = Counter(
            "tpu_dra_recovery_evictions_total",
            "Claim evictions started by the recovery controller "
            "(drain + deallocate of a permanently failed claim).",
            registry=self.registry,
        )
        self.replaced = Counter(
            "tpu_dra_recovery_replaced_total",
            "Evicted claims that converged to a fresh allocation on "
            "surviving capacity.",
            registry=self.registry,
        )
        self.failed = Counter(
            "tpu_dra_recovery_failed_total",
            "Evicted claims that blew the per-claim recovery deadline "
            "and were retired as cleanly Failed (no allocation, no "
            "in-flight eviction record).",
            registry=self.registry,
        )
        self.active_evictions = Gauge(
            "tpu_dra_recovery_active_evictions",
            "Eviction records currently in flight (bounded by "
            "TPU_DRA_RECOVERY_MAX_CONCURRENT).",
            registry=self.registry,
        )
        self.orphans_repaired = Counter(
            "tpu_dra_recovery_orphans_repaired_total",
            "Orphaned node-local artifacts repaired by the reconcile "
            "sweep, by kind (carveout, cdi_spec, lease, stale_claim, "
            "cd_stale_claim, cd_cdi_spec, slice).",
            ["kind"],
            registry=self.registry,
        )
        self.reconcile_drift = Gauge(
            "tpu_dra_recovery_reconcile_drift",
            "Cross-layer divergences observed by the LAST reconcile "
            "sweep, by kind (devices_gone counts claims whose "
            "checkpointed devices no longer exist on the host).",
            ["kind"],
            registry=self.registry,
        )


class PartitionMetrics:
    """Partition-engine observability (pkg/partition/engine.py).

    A healthy serving node shows ``partitions_active`` tracking tenant
    load (carve-outs realized on demand, reaped when idle) and the
    create/destroy counters moving together; ``creates`` racing ahead
    of ``destroys`` without ``partitions_active`` rising means crashed
    teardowns are being resumed (check the node plugin logs)."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.partitions_active = Gauge(
            "tpu_dra_partitions_active",
            "Partition carve-outs currently realized (PartitionReady "
            "records) on this node.",
            registry=self.registry,
        )
        self.creates = Counter(
            "tpu_dra_partition_creates_total",
            "Partition carve-outs created (first tenant attach).",
            registry=self.registry,
        )
        self.destroys = Counter(
            "tpu_dra_partition_destroys_total",
            "Partition carve-outs destroyed (last tenant detach, idle "
            "reap, or crash-resumed teardown).",
            registry=self.registry,
        )
        # Predictive pre-warming (pkg/partition/engine.set_prewarm,
        # fed by the autoscale forecaster's CRD hint): created counts
        # carve-outs realized AHEAD of demand, hit counts first
        # attaches that found a warm carve-out (skipping the
        # partition.create fsyncs on the claim path), reaped counts
        # warm-but-never-attached carve-outs returned by the idle
        # sweep after the forecast decayed. hit/created is the
        # forecaster's precision.
        self.prewarm_created = Counter(
            "tpu_dra_prewarm_created_total",
            "Partition carve-outs pre-realized ahead of forecast "
            "demand.",
            registry=self.registry,
        )
        self.prewarm_hits = Counter(
            "tpu_dra_prewarm_hit_total",
            "Tenant attaches that landed on a pre-warmed carve-out "
            "(no partition.create on the claim path).",
            registry=self.registry,
        )
        self.prewarm_reaped = Counter(
            "tpu_dra_prewarm_reaped_total",
            "Pre-warmed carve-outs reaped un-attached after the "
            "forecast decayed.",
            registry=self.registry,
        )

    # -- the sink pkg/partition/engine.py calls ----------------------------

    def inc_create(self) -> None:
        self.creates.inc()

    def inc_destroy(self) -> None:
        self.destroys.inc()

    def set_active(self, n: int) -> None:
        self.partitions_active.set(n)

    def inc_prewarm_created(self) -> None:
        self.prewarm_created.inc()

    def inc_prewarm_hit(self) -> None:
        self.prewarm_hits.inc()

    def inc_prewarm_reaped(self) -> None:
        self.prewarm_reaped.inc()


class TelemetryMetrics:
    """Per-chip telemetry exposition (the node collector's metric
    half; kubeletplugin/health.py feeds it on the health-poll cadence
    from the ``tpulib.chip_telemetry`` seam, kubeletplugin/driver.py
    wires it onto the plugin registry).

    The gauges are instantaneous per-chip signals; ``ici_link_errors``
    re-exports tpulib's CUMULATIVE counter as deltas so Prometheus
    ``rate()`` works across plugin restarts. ``anomaly_total`` counts
    detection EPISODES (pkg/anomaly.py rising edges), not per-poll
    presence -- a sustained thermal drift is one anomaly, not one per
    5s."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.power = Gauge(
            "tpu_dra_chip_power_watts",
            "Instantaneous per-chip power draw (tpulib telemetry).",
            ["chip"],
            registry=self.registry,
        )
        self.temp = Gauge(
            "tpu_dra_chip_temp_celsius",
            "Per-chip die temperature (tpulib telemetry).",
            ["chip"],
            registry=self.registry,
        )
        self.hbm_used = Gauge(
            "tpu_dra_chip_hbm_used_bytes",
            "Per-chip HBM bytes in use (tpulib telemetry).",
            ["chip"],
            registry=self.registry,
        )
        self.duty = Gauge(
            "tpu_dra_chip_duty_cycle",
            "Per-chip TensorCore duty cycle, 0.0-1.0 (tpulib "
            "telemetry).",
            ["chip"],
            registry=self.registry,
        )
        self.ici_errors = Counter(
            "tpu_dra_chip_ici_link_errors_total",
            "ICI link errors observed per chip (delta of tpulib's "
            "cumulative counter).",
            ["chip"],
            registry=self.registry,
        )
        self.anomalies = Counter(
            "tpu_dra_anomaly_total",
            "Telemetry anomaly episodes detected, by kind "
            "(thermal_drift, power_cap_throttle, duty_cycle_straggler, "
            "ici_link_error_burst; pkg/anomaly.py).",
            ["kind"],
            registry=self.registry,
        )
        self._ici_last: dict[str, int] = {}

    # -- the sinks kubeletplugin/{health,driver}.py call ----------------------

    def observe_sample(self, sample) -> None:
        """One ChipTelemetry sample -> gauge updates + the ICI error
        delta."""
        chip = str(sample.chip)
        self.power.labels(chip).set(float(sample.power_watts))
        self.temp.labels(chip).set(float(sample.temp_celsius))
        self.hbm_used.labels(chip).set(int(sample.hbm_used_bytes))
        self.duty.labels(chip).set(float(sample.duty_cycle))
        cum = int(sample.ici_link_errors)
        last = self._ici_last.get(chip)
        self._ici_last[chip] = cum
        if last is not None and cum > last:
            self.ici_errors.labels(chip).inc(cum - last)

    def prune_absent(self, present_chips) -> None:
        """Remove gauge children for chips absent from the current
        sample set: a dead sensor must read as NO data, not a
        frozen-but-plausible last value summed into dashboards
        (mirrors the slice-attribute replace semantics)."""
        present = {str(c) for c in present_chips}
        for chip in set(self._ici_last) - present:
            for gauge in (self.power, self.temp, self.hbm_used,
                          self.duty):
                gauge.remove(chip)
            # The error counter keeps its history (it is a counter),
            # but the delta baseline resets so a returning chip
            # re-baselines instead of double-counting.
            self._ici_last.pop(chip, None)

    def inc_anomaly(self, kind: str) -> None:
        self.anomalies.labels(kind).inc()


class FleetMetrics:
    """Fleet-aggregator exposition (pkg/fleetstate.FleetAggregator's
    duck-typed sink, on the scheduler registry).

    ``pool_utilization`` near 1.0 with ``pending_claims`` above zero is
    the capacity-starvation signal; ``node_power_watts`` /
    ``node_temp_celsius`` are the scheduler-visible per-node power and
    thermal envelope folded from the slice attributes the node plugins
    publish (the 2501.17752 power-as-scheduler-signal input). Frag
    history lives in PlacementMetrics + /debug/fleet."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.pool_utilization = Gauge(
            "tpu_dra_fleet_pool_utilization",
            "Allocated fraction of a pool's devices (0.0-1.0), from "
            "the scheduler's AllocationState.",
            ["pool"],
            registry=self.registry,
        )
        self.pool_free = Gauge(
            "tpu_dra_fleet_pool_free_devices",
            "Devices currently unallocated in a pool.",
            ["pool"],
            registry=self.registry,
        )
        self.pending = Gauge(
            "tpu_dra_fleet_pending_claims",
            "Claims waiting for capacity (demand the free pools are "
            "not absorbing).",
            registry=self.registry,
        )
        self.node_power = Gauge(
            "tpu_dra_fleet_node_power_watts",
            "Per-node power draw summed from the telemetry slice "
            "attributes the node plugins publish (quantized).",
            ["node"],
            registry=self.registry,
        )
        self.node_temp = Gauge(
            "tpu_dra_fleet_node_temp_celsius",
            "Per-node hottest-chip temperature from the telemetry "
            "slice attributes (quantized).",
            ["node"],
            registry=self.registry,
        )
        self.power_headroom = Gauge(
            "tpu_dra_fleet_power_headroom_watts",
            "Per-pool power headroom: summed node power caps "
            "(powerCapWatts attributes / TPU_DRA_POWER_CAP_W) minus "
            "the summed telemetry draw, with dropped power samples "
            "carried for TPU_DRA_POWER_SAMPLE_TTL_S. Absent when no "
            "cap is configured (power model off).",
            ["pool"],
            registry=self.registry,
        )
        self.fold_seconds = Histogram(
            "tpu_dra_fleet_fold_seconds",
            "Wall time of one FleetAggregator fold (per-pool "
            "utilization + fragmentation over the whole inventory). "
            "Kept flat by the largest_free_shape memo in "
            "pkg/topology/score.py -- a rising p99 here means the "
            "memo stopped hitting (pool geometry churning every "
            "pass).",
            buckets=(0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                     0.1, 0.25, 0.5, 1.0, 2.5),
            registry=self.registry,
        )

    # -- the duck-typed sink pkg/fleetstate.py calls --------------------------

    def set_pool(self, pool: str, utilization: float,
                 free: int) -> None:
        self.pool_utilization.labels(pool).set(utilization)
        self.pool_free.labels(pool).set(free)

    def set_pending(self, n: int) -> None:
        self.pending.set(n)

    def set_node(self, node: str, power_w: float, temp_c: float) -> None:
        self.node_power.labels(node).set(power_w)
        self.node_temp.labels(node).set(temp_c)

    def set_pool_power(self, pool: str, headroom_w: float) -> None:
        self.power_headroom.labels(pool).set(headroom_w)

    def remove_pool_power(self, pool: str) -> None:
        """A still-present pool stopped publishing power caps: its
        headroom gauge disappears rather than freezing (the power
        model is off, not at its last value)."""
        self.power_headroom.remove(pool)

    def remove_pool(self, pool: str) -> None:
        """A pool left the snapshot: its gauges must disappear rather
        than freeze at the last value."""
        for gauge in (self.pool_utilization, self.pool_free,
                      self.power_headroom):
            gauge.remove(pool)

    def remove_node(self, node: str) -> None:
        for gauge in (self.node_power, self.node_temp):
            gauge.remove(node)


class PlacementMetrics:
    """Topology-aware placement (pkg/topology): ``pool`` labels carry
    ``<driver>/<pool>``. Only coordinated pools report; the port's GPU
    slices publish no ICI coordinates, so on them these stay empty."""

    # Max-hop distances are small integers.
    _HOP_BUCKETS = (0, 1, 2, 3, 4, 6, 8, 12, 16)

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.frag_score = Gauge(
            "tpu_dra_placement_frag_score",
            "Fragmentation of a pool's free chips: 1 - largest "
            "allocatable sub-torus / free chips (0 = one perfect "
            "contiguous block).",
            ["pool"],
            registry=self.registry,
        )
        self.largest_shape = Gauge(
            "tpu_dra_placement_largest_free_shape_chips",
            "Chips in the largest sub-torus shape still allocatable "
            "from a pool's free chips.",
            ["pool"],
            registry=self.registry,
        )
        self.compactness = Histogram(
            "tpu_dra_placement_compactness",
            "Max ICI hop distance inside each allocated device set "
            "(0 = single chip; lower = tighter collective).",
            ["pool"],
            buckets=self._HOP_BUCKETS,
            registry=self.registry,
        )


class WorkQueueMetrics:
    """The keyed work queue's sink (``pkg/workqueue``'s ``metrics``):
    ``shard`` is the worker that owns the shard, so one hot shard shows
    as one deep gauge; the wait runs from enqueue to the callback's
    start, retry and hot-key backoff included; ``hot_backoff_total``
    counts the escalations of keys re-dirtied in a tight loop."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.depth = Gauge(
            "tpu_dra_workqueue_depth",
            "Keys queued per workqueue shard (worker index).",
            ["shard"],
            registry=self.registry,
        )
        self.wait = Histogram(
            "tpu_dra_workqueue_wait_seconds",
            "Queue latency from enqueue to callback start, including "
            "retry/hot-key backoff.",
            buckets=_BUCKETS,
            registry=self.registry,
        )
        self.retries = Counter(
            "tpu_dra_workqueue_retries_total",
            "Callbacks re-enqueued with backoff after an error.",
            registry=self.registry,
        )
        self.drops = Counter(
            "tpu_dra_workqueue_drops_total",
            "Keys dropped (PermanentError or retry budget exhausted).",
            registry=self.registry,
        )
        self.hot_backoffs = Counter(
            "tpu_dra_workqueue_hot_backoff_total",
            "Fairness escalations applied to keys re-dirtied in a "
            "tight loop (pkg/workqueue hot-key damping).",
            registry=self.registry,
        )
        self.steals = Counter(
            "tpu_dra_workqueue_steals_total",
            "Ready keys stolen by idle workers from a backlogged "
            "sibling's heap (pkg/workqueue work stealing); a rising "
            "rate means one shard is hot enough to flood its owner.",
            registry=self.registry,
        )

    def set_depth(self, shard: str, n: int) -> None:
        self.depth.labels(shard).set(n)

    def observe_wait(self, seconds: float) -> None:
        self.wait.observe(max(seconds, 0.0))

    def inc_retry(self) -> None:
        self.retries.inc()

    def inc_drop(self) -> None:
        self.drops.inc()

    def inc_hot_backoff(self) -> None:
        self.hot_backoffs.inc()

    def inc_steal(self, n: int = 1) -> None:
        self.steals.inc(n)


class SchedulerMetrics:
    """The scheduler (pkg/scheduler, pkg/schedcache, pkg/informer):
    ``sync_seconds`` by mode (``full`` passes, ``incremental`` dirty-key
    drains) beside the dirty queue's depth; the informers' relists and
    the coordinator's backoff before them; the inventory snapshot's full
    builds and per-pool delta builds; commits refused at reserve time;
    the domains' spills and exhaustions; the work queue
    (``workqueue``); and the control plane's SLO phases (``slo``:
    queued, fit, commit, patch). ``tpu_dra_slice_publish_skipped_total``
    moves only for a publisher on this registry (none in the scheduler
    binary)."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.sync_seconds = Histogram(
            "tpu_dra_sched_sync_seconds",
            "Scheduler sync work duration by mode (full resync pass "
            "vs. one incremental dirty-key drain).",
            ["mode"],
            buckets=_BUCKETS,
            registry=self.registry,
        )
        self.dirty_depth = Gauge(
            "tpu_dra_sched_dirty_queue_depth",
            "Dirty keys currently queued for incremental sync.",
            registry=self.registry,
        )
        self.publish_skipped = Counter(
            "tpu_dra_slice_publish_skipped_total",
            "ResourceSlice writes skipped because the desired spec "
            "matched the live spec by canonical content hash.",
            registry=self.registry,
        )
        self.informer_relists = Counter(
            "tpu_dra_informer_relist_total",
            "Full informer relists by resource (the expensive fallback "
            "path; incremental watch events do not count).",
            ["resource"],
            registry=self.registry,
        )
        self.snapshot_build = Histogram(
            "tpu_dra_sched_snapshot_build_seconds",
            "Wall time to (re)build the indexed inventory snapshot "
            "from the published ResourceSlices (pkg/schedcache); one "
            "sample per actual rebuild, cache hits cost nothing.",
            buckets=_BUCKETS,
            registry=self.registry,
        )
        self.snapshot_delta = Histogram(
            "tpu_dra_sched_snapshot_delta_seconds",
            "Per-pool incremental sub-snapshot rebuild time on the "
            "delta path (pkg/schedcache PoolSnapshot): one sample per "
            "pool actually re-projected by a slice event; untouched "
            "pools merge by identity and cost nothing. A healthy "
            "10k-node fleet shows this replacing snapshot_build "
            "entirely outside full resyncs.",
            ["pool"],
            buckets=_BUCKETS,
            registry=self.registry,
        )
        self.relist_backoff = Histogram(
            "tpu_dra_informer_relist_backoff_seconds",
            "Jittered backoff the relist coordinator applied before "
            "an informer's full relist (pkg/informer "
            "RelistCoordinator): repeated relists of one resource "
            "inside the quiet window back off exponentially so a "
            "restart storm drains without thundering-herding the "
            "apiserver. Quiet resources relist with zero delay and "
            "record nothing here.",
            ["resource"],
            buckets=_BUCKETS,
            registry=self.registry,
        )
        self.domain_spilled = Counter(
            "tpu_dra_sched_domain_spilled_total",
            "Claims re-homed by cross-domain spillover: a claim "
            "pinned to an exhausted scheduling domain was annotated "
            "over to a sibling domain (migration-cost ranked) instead "
            "of pending forever.",
            ["from_domain", "to_domain"],
            registry=self.registry,
        )
        self.domain_exhausted = Counter(
            "tpu_dra_sched_domain_exhausted_total",
            "Allocation attempts for domain-pinned claims that found "
            "no fit inside their scheduling domain's pools (the claim "
            "gets a DomainExhausted condition + Warning Event instead "
            "of waiting silently).",
            ["domain"],
            registry=self.registry,
        )
        self.commit_conflicts = Counter(
            "tpu_dra_sched_commit_conflicts_total",
            "Optimistic allocation commits rejected at reserve time "
            "(another worker took a device/counter between fit and "
            "commit); each conflict re-fits against fresh state.",
            registry=self.registry,
        )
        self.workqueue = WorkQueueMetrics(registry=self.registry)
        self.slo = ClaimSLOMetrics(registry=self.registry)


class DefragMetrics:
    """Active-defragmentation observability (pkg/defrag.py, on the
    scheduler registry).

    A healthy controller shows ``plans_total`` rising only when churn
    has genuinely shredded a pool (the hysteresis proof: a quiet fleet
    shows zero), every planned move retiring through ``moves_total``
    (``aborted_total`` staying flat), ``frag_recovered_chips_total``
    tracking the largest-free-shape growth each completed plan bought,
    and move latency (plan -> re-placement) bounded by the scheduler's
    re-placement path. ``active_moves`` returning to zero after every
    window is the no-stuck-claims invariant."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.plans = Counter(
            "tpu_dra_defrag_plans_total",
            "Defrag plan windows started (a triggered pool with a "
            "feasible re-pack admitted for execution).",
            registry=self.registry,
        )
        self.moves = Counter(
            "tpu_dra_defrag_moves_total",
            "Claim migrations completed by the defrag controller "
            "(drain -> deallocate -> re-placement retired).",
            registry=self.registry,
        )
        self.frag_recovered = Counter(
            "tpu_dra_defrag_frag_recovered_chips_total",
            "Chips of largest-free-sub-torus growth recovered by "
            "completed defrag plans (chips_after - chips_before, "
            "summed per plan window).",
            registry=self.registry,
        )
        self.aborted = Counter(
            "tpu_dra_defrag_aborted_total",
            "Defrag moves abandoned (move deadline exceeded, claim "
            "deleted mid-move, or pool healed mid-plan).",
            registry=self.registry,
        )
        self.active_moves = Gauge(
            "tpu_dra_defrag_active_moves",
            "Defrag move records currently in flight (bounded by "
            "TPU_DRA_DEFRAG_MAX_CONCURRENT).",
            registry=self.registry,
        )
        self.move_seconds = Histogram(
            "tpu_dra_defrag_move_seconds",
            "End-to-end latency of one completed defrag move: plan "
            "record written -> claim re-placed on surviving capacity.",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0, 300.0),
            registry=self.registry,
        )


class MigrationMetrics:
    """Cooperative-migration observability (pkg/migration.py, on the
    scheduler registry).

    A healthy controller shows every ``plans_total`` retiring through
    ``coop_moves_total`` with ``fallbacks_total`` flat -- a rising
    fallback rate means workloads stopped honoring the ack contract
    (read the ``reason`` label: ack-timeout means the ack window is
    undersized for real checkpoint time, checkpoint-failed means the
    workload's own save path is broken, destination-lost means the
    fleet is losing capacity mid-handshake). ``ack_seconds`` is the
    workload's checkpoint time (size TPU_DRA_MIGRATION_ACK_S from its
    p99); ``switch_seconds`` is the actual downtime (drain ->
    re-placed); ``move_seconds`` the whole handshake. ``active_moves``
    returning to zero after every handshake is the no-stuck-claims
    invariant the chaos suite pins."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.plans = Counter(
            "tpu_dra_migration_plans_total",
            "Cooperative move groups planned (destination reserved, "
            "durable records written).",
            registry=self.registry,
        )
        self.coop_moves = Counter(
            "tpu_dra_migration_coop_moves_total",
            "Cooperative migrations completed warm (workload acked "
            "its checkpoint, claim re-placed on the reserved window).",
            registry=self.registry,
        )
        self.fallbacks = Counter(
            "tpu_dra_migration_fallbacks_total",
            "Cooperative moves degraded to the cold eviction path, by "
            "reason (ack-timeout, checkpoint-failed, "
            "destination-lost, deadline). The claim is never stuck: "
            "fallback releases the reservation and drains cold.",
            ["reason"],
            registry=self.registry,
        )
        self.active_moves = Gauge(
            "tpu_dra_migration_active_moves",
            "Migration handshake records currently in flight (bounded "
            "by TPU_DRA_MIGRATION_MAX_CONCURRENT).",
            registry=self.registry,
        )
        self.ack_seconds = Histogram(
            "tpu_dra_migration_ack_seconds",
            "Workload checkpoint time: intent signaled -> ack "
            "annotation observed. Size TPU_DRA_MIGRATION_ACK_S from "
            "this histogram's p99.",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0, 300.0),
            registry=self.registry,
        )
        self.switch_seconds = Histogram(
            "tpu_dra_migration_switch_seconds",
            "The actual workload downtime of a cooperative move: "
            "drain/deallocate -> claim re-placed on the reserved "
            "window (the workload restores warm from its own "
            "checkpoint from there).",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0, 300.0),
            registry=self.registry,
        )
        self.move_seconds = Histogram(
            "tpu_dra_migration_move_seconds",
            "End-to-end latency of one completed cooperative move: "
            "plan record written -> claim re-placed.",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0, 300.0),
            registry=self.registry,
        )


class AutoscaleMetrics:
    """Serving-autoscaler observability (pkg/autoscale, on the scheduler
    registry).

    A healthy controller shows ``plans_total`` rising only when demand
    drifted past the hysteresis band (a steady fleet shows
    ``converged_passes_total`` climbing with plans flat), every plan
    retiring through ``applies_total`` (``superseded_total`` counts
    operator edits winning a race), and ``active_rollouts`` back at zero
    after every re-plan."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.plans = Counter(
            "tpu_dra_autoscale_plans_total",
            "PartitionSet re-plans started (observed demand drifted "
            "past the hysteresis band; a durable rollout record was "
            "written).",
            registry=self.registry,
        )
        self.applies = Counter(
            "tpu_dra_autoscale_applies_total",
            "Re-plans confirmed on the apiserver (the PartitionSet "
            "CRD now carries the planned content).",
            registry=self.registry,
        )
        self.superseded = Counter(
            "tpu_dra_autoscale_superseded_total",
            "Rollouts retired because a concurrent PartitionSet edit "
            "won (operator content always wins).",
            registry=self.registry,
        )
        self.converged = Counter(
            "tpu_dra_autoscale_converged_passes_total",
            "Planning passes whose desired layout already matched the "
            "active CRD (the steady state: ZERO apiserver writes).",
            registry=self.registry,
        )
        self.active_rollouts = Gauge(
            "tpu_dra_autoscale_active_rollouts",
            "Re-plan records currently in flight (0 or 1: one rollout "
            "at a time).",
            registry=self.registry,
        )
        self.rollout_seconds = Histogram(
            "tpu_dra_autoscale_rollout_seconds",
            "End-to-end latency of one confirmed re-plan: durable "
            "plan record written -> CRD content confirmed.",
            buckets=(0.05, 0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
                     60.0, 120.0, 300.0),
            registry=self.registry,
        )


class ComputeDomainMetrics:
    """Cluster-level ComputeDomain status gauge (computedomain_cluster.go)."""

    def __init__(self, registry: CollectorRegistry | None = None):
        self.registry = registry or CollectorRegistry()
        self.status = Gauge(
            "tpu_compute_domain_status",
            "ComputeDomain readiness (1=Ready, 0=NotReady) by domain.",
            ["namespace", "name"],
            registry=self.registry,
        )
        self.nodes = Gauge(
            "tpu_compute_domain_nodes",
            "Number of nodes registered in a ComputeDomain.",
            ["namespace", "name"],
            registry=self.registry,
        )


class MetricsServer(SimpleHTTPEndpoint):
    """Prometheus exposition server (upstream prometheus_httpserver.go)
    and the diagnostics routes the upstream mounts on the same mux
    (controller main.go:383-390): ``/debug/stacks`` (every thread's
    traceback), ``/debug/traces[/<trace-id>]`` (the span ring,
    pkg/tracing.py) and ``/debug/claims[/<uid-or-ns/name>]`` (the flight
    recorder, pkg/flightrecorder.py), ``/debug/telemetry`` (the
    per-chip telemetry ring) and ``/debug/fleet`` (the scheduler's fleet
    snapshot, both pkg/fleetstate.py; an unused one answers an empty
    document).

    Stacks and spans disclose internal state, so the debug routes are
    served only when the listener is loopback-bound or
    ``TPU_DRA_DEBUG_HTTP=1``; a listener on 0.0.0.0 serves ``/metrics``
    alone."""

    def __init__(self, registry: CollectorRegistry, host: str = "127.0.0.1",
                 port: int = 0):
        extra = None
        if (host in ("127.0.0.1", "localhost", "::1")
                or os.environ.get("TPU_DRA_DEBUG_HTTP") == "1"):
            # Late-bound: the process exporter and recorder may be
            # swapped after the server starts (tests).
            extra = {
                "/debug/stacks": debug_stacks_endpoint,
                "/debug/traces":
                    lambda: tracing.exporter().traces_endpoint(),
                "/debug/traces/*":
                    lambda rest: tracing.exporter().trace_endpoint(rest),
                "/debug/claims":
                    lambda: flightrecorder.default().index_endpoint(),
                "/debug/claims/*":
                    lambda rest: flightrecorder.default()
                    .claims_endpoint(rest),
                "/debug/telemetry":
                    lambda: fleetstate.default_ring()
                    .telemetry_endpoint(),
                "/debug/fleet":
                    lambda: fleetstate.default_fleet().fleet_endpoint(),
            }
        super().__init__(
            "/metrics",
            lambda: (200, CONTENT_TYPE_LATEST, generate_latest(registry)),
            host=host, port=port, thread_name="metrics-http",
            extra=extra,
        )
