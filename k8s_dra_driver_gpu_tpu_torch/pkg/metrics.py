"""Prometheus metrics of the drivers (the JAX package's
``pkg/metrics.py``; upstream pkg/metrics: DRA request duration
histograms, in-flight and error counters, the prepared-devices gauge --
dra_requests.go:27-151; the ComputeDomain status gauge --
computedomain_cluster.go; the exposition server --
prometheus_httpserver.go).

The families, their help strings, label names and buckets are the JAX
package's, on the port's own registry (``pkg/exposition.py``; the port
does not import ``prometheus_client``). Ported: ``register_build_info``,
``ClaimSLOMetrics``, ``DRARequestMetrics`` (without its ``telemetry``
member), ``ResilienceMetrics``, ``PartitionMetrics``,
``ComputeDomainMetrics`` and ``MetricsServer``. The others wait for
their producers (ROADMAP.md §1c): ``RecoveryMetrics`` for the health
monitor's quarantine and failure hooks and the recovery controller,
``TelemetryMetrics`` and ``FleetMetrics`` for the telemetry plane
(``fleetstate``), ``PlacementMetrics``, ``WorkQueueMetrics`` and
``SchedulerMetrics`` for the scheduler, ``DefragMetrics``,
``MigrationMetrics`` and ``AutoscaleMetrics`` for their controllers.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager

from . import flightrecorder, tracing
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
    re-placement). In the port only the node plugins observe (the
    ``prepare`` phase); the others wait for the scheduler and the
    recovery controller (ROADMAP.md §1c). Observations carry the
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
        # The JAX class's ``telemetry`` member (TelemetryMetrics) waits
        # for the telemetry plane (ROADMAP.md §1c, fleetstate).

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
    (pkg/retry.py, computedomain/plugin/driver.py; the port's health
    monitor has no quarantine hook yet, so ``quarantines`` stays empty:
    ROADMAP.md §1c).

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
    recorder, pkg/flightrecorder.py). The JAX server's
    ``/debug/telemetry`` and ``/debug/fleet`` wait for ``fleetstate``
    (ROADMAP.md §1c).

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
            }
        super().__init__(
            "/metrics",
            lambda: (200, CONTENT_TYPE_LATEST, generate_latest(registry)),
            host=host, port=port, thread_name="metrics-http",
            extra=extra,
        )
