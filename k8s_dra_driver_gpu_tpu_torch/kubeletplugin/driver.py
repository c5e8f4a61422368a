"""The node service of the kubelet plugin: DRA callbacks, ResourceSlice
publication, health taints and the reconcile sweep (the JAX package's
``kubeletplugin/driver.py``; the upstream driver's
``cmd/gpu-kubelet-plugin/driver.go``).

``Driver`` owns the node's ``DeviceState`` and talks to the API server
through any object with ``KubeClient``'s surface:

- **Publication.** The node's devices go out with the per-GPU shared
  counters (``partitions``) through ``sliceutil``'s content-hash diff,
  which also deletes this driver's other slices of the node, in one of
  the reference's modes (``driver.py:102-113``, ``:380-440``):
  ``combined``, one slice of every device; or ``split`` (KEP-4815, an
  API server from 1.35), whole GPUs in ``<node>-gpu.nvidia.com-gpus``
  (with the passthrough GPUs, which consume no counters), MIG devices in ``<node>-gpu.nvidia.com-mig`` and tenant partitions in
  ``<node>-gpu.nvidia.com-partitions``, each slice with the counters, all
  counted in ``resourceSliceCount`` (a slice only where it has devices;
  one slice, as ``combined``, while there are only whole GPUs). Without a
  ``publication_mode`` the server's ``/version`` chooses, as the
  reference's ``_server_supports_split`` does: one request at
  construction. The reference's ``legacy`` mode (no counters, no MIG)
  comes with the entry point (ROADMAP.md §1b item 8).
- **Prepare.** Each claim is fetched from the API server by namespace
  and name; a uid that differs from the kubelet's is refused. Its CDI
  ids come back grouped by request, and errors come back per claim.
  Claims are prepared one after another: every prepare runs under the
  node lock (the port has no per-GPU shard locks), so the reference's
  thread pool (``MAX_PARALLEL_PREPARES``) would buy nothing.
- **Health.** ``ChipHealthMonitor`` polls its own ``tpulib`` handle
  (``DeviceState`` closes the one it enumerated with); its taints land
  on the published devices, and a GPU's on its MIG devices too (the JAX
  driver leaves its sub-slices untainted). An unchanged taint set costs
  no API call at all (the published hashes are remembered), except that
  every ``TPU_DRA_PUBLISH_RECHECK_S`` the live pool is read again, so a
  slice deleted or changed behind the driver's back comes back. With the
  monitor off, every device carries an observe-only ``unmonitored``
  taint, as the upstream's ``device_health.go:36-40``.
- **Telemetry** (the JAX driver's fleet station). The monitor's
  telemetry samples land in the process ring
  (``fleetstate.default_ring()``, ``/debug/telemetry``), set the
  ``tpu_dra_chip_*`` gauges, and are published as quantized device
  attributes (``telemetryPowerWatts`` in steps of
  ``TELEMETRY_POWER_STEP_W``, ``telemetryTempCelsius``,
  ``telemetryDutyPct``, ``telemetryHbmUsedPct``, ``telemetryIciErrors``):
  steady samples quantize alike, so they cost no slice write. REPLACE
  semantics: a GPU absent from a sample set loses its attributes, and
  its gauges go. ``TPU_DRA_TELEMETRY_ATTRS=0`` keeps the attributes off
  (the ring, gauges and anomalies stay); ``TPU_DRA_TELEMETRY=0`` turns
  the whole station off. ``TPU_DRA_POWER_CAP_W`` publishes
  ``powerCapWatts`` on every whole GPU. An anomaly's rising edge counts
  in ``tpu_dra_anomaly_total``, records an ``anomaly`` flight event under
  the device, and creates one Warning Event on the Node (its name is
  fixed by node, device and kind, so a repeat is a 409 and dropped).
- **Sweep.** ``NodeStateReconciler`` runs the stale-claim GC and the
  orphan passes on its own thread; with ``recovery_metrics`` (a
  ``pkg/metrics.RecoveryMetrics``) it exports what it repairs, and the
  quarantine tracker's failure hook counts a failed GPU there
  (``permanent_failures{source="device"}``); with ``resilience`` (a
  ``ResilienceMetrics``) a quarantine counts in ``tpu_dra_quarantine_total``.
- **Partitions.** With the partition engine on, a
  ``PartitionSetWatcher`` (``pkg/partition/watch.py``) follows the
  cluster's PartitionSet CRDs for this node's pool (``Config.pool_name``,
  else the node's name): started after the bootstrap publish, it
  re-plans through ``apply_partition_set`` (which republishes through the
  diff: a converged re-apply costs no write) and passes the pre-warm hint
  to ``apply_prewarm``; ``stop()`` joins it. ``TPU_DRA_PARTITION_WATCH=0``
  turns it off (the bootstrap plan stays).
- **Tenancy agents** (``sharing.py``). ``stop()`` stops them through
  ``DeviceState.close()``, and a ``Driver`` constructed again over the
  same root re-owns those of the claims still prepared (the JAX
  driver's restart path), their grants kept.

- **Metrics, traces, flight records** (``pkg/metrics.py``,
  ``pkg/tracing.py``, ``pkg/flightrecorder.py``), at the JAX driver's
  hook points: each callback a claim runs under ``metrics.observe``
  (``tpu_dra_request_*``); the prepared-devices and tenancy-agents
  gauges after each callback and at ``start()``; a prepare observes the
  SLO's ``prepare`` phase with the claim's trace id and records
  ``prepare_done`` (or ``prepare_failed``) under its uid, aliased by
  ``namespace/name``; ``DeviceState.segment_observer`` feeds
  ``tpu_dra_prepare_segment_seconds``; the taint gauge follows the
  monitor's taints; publishes count the slice writes the diff skipped.
  With the partition engine on, ``PartitionMetrics`` share the registry.
  Serve the registry with ``MetricsServer(driver.metrics.registry)``.

- **Tenant usage.** ``tenant_profiles`` (a
  ``pkg/partition/profiles.TenantProfileStore``) takes the health
  monitor's per-tenant usage samples (``_on_tenant_usage``), the MISO
  sizing input measured on the node.

Not ported: the gRPC transport (ROADMAP.md §1b item 8).
"""

from __future__ import annotations

import dataclasses
import logging
import os
import threading
import time

from ..pkg import fleetstate, flightrecorder, tracing
from ..pkg.events import emit_warning_event
from ..pkg.kubeclient import NotFoundError
from ..pkg.metrics import DRARequestMetrics, PartitionMetrics
from ..pkg.partition.profiles import TenantProfileStore
from ..pkg.partition.watch import PartitionSetWatcher
from ..pkg.schedcache import ATTR_POWER_CAP, power_cap_env
from ..pkg.sliceutil import publish_resource_slices, slice_content_hash
from ..tpulib.binding import load
from . import DRIVER_NAME
from .claim import ResourceClaim
from .device_state import Config, DeviceState
from .deviceinfo import AllocatableDevice, DeviceKind, gpu_name
from .health import (TAINT_KEY_PREFIX, ChipHealthMonitor, DeviceTaint,
                     QuarantineTracker)
from .partitions import consumed_counters, shared_counter_sets
from .reconcile import NodeStateReconciler

logger = logging.getLogger(__name__)

RESOURCE_GROUP = "resource.k8s.io"
RESOURCE_VERSION = "v1"
PUBLICATION_MODES = ("combined", "split")
# The first API server version that serves the split layout (KEP-4815).
SPLIT_SERVER_VERSION = (1, 35)

# Telemetry attribute quantization: raw power and temperature wiggle
# every poll; in these steps a steady GPU hashes alike and the publish
# costs nothing, while a real shift (5 C, 10 W) lands within one poll.
TELEMETRY_POWER_STEP_W = 10
TELEMETRY_TEMP_STEP_C = 5
TELEMETRY_DUTY_STEP_PCT = 10
TELEMETRY_HBM_STEP_PCT = 10
# The cumulative NVLink error count too: a trickle below the anomaly
# burst threshold must not become one slice write a poll.
TELEMETRY_ICI_STEP = 100


class Driver:
    """The kubelet plugin's node service over this host's GPUs."""

    def __init__(self, config: Config, kube_client, node_name: str,
                 enable_health_monitor: bool = True,
                 additional_ignored_health_kinds: tuple[str, ...] = (),
                 publication_mode: str | None = None,
                 metrics: DRARequestMetrics | None = None,
                 resilience=None, recovery_metrics=None):
        self.kube = kube_client
        self.node_name = node_name
        if publication_mode is None:
            publication_mode = "split" if self._server_supports_split() \
                else "combined"
        if publication_mode not in PUBLICATION_MODES:
            raise ValueError(
                f"unknown publication mode {publication_mode!r}: want one "
                f"of {PUBLICATION_MODES} (legacy comes with the entry "
                "point, ROADMAP.md §1b item 8)")
        self.publication_mode = publication_mode
        self.state = DeviceState(config)
        self.metrics = metrics or DRARequestMetrics()
        if self.state.partition_engine is not None:
            self.state.partition_engine.metrics = PartitionMetrics(
                registry=self.metrics.registry)
            self.state.partition_engine.metrics.set_active(
                self.state.partition_engine.active_partitions())
        # The segment breakdown of each prepare and unprepare, into the
        # request metrics' histogram.
        self.state.segment_observer = self.metrics.observe_segments
        self._taints: dict[str, list[dict]] = {}
        # Quantized telemetry attributes by device, merged into the
        # published devices (the scheduler's fleet fold reads them).
        self._telemetry_attrs: dict[str, dict] = {}
        self._telemetry_attrs_enabled = (
            fleetstate.telemetry_enabled()
            and os.environ.get("TPU_DRA_TELEMETRY_ATTRS", "1")
            not in ("0", "false", "False"))
        # This node's power cap in watts (TPU_DRA_POWER_CAP_W, 0 = none).
        self._power_cap_w = power_cap_env()
        # One publish at a time, each generating its slices under the
        # lock: a health poll's republish racing start()'s first publish
        # would otherwise lose its create (409) while start()'s slices,
        # generated before the taints, become the published hashes.
        self._publish_lock = threading.Lock()
        # The hashes of the last slice set published, and when the live
        # pool was last read.
        self._published_hashes: tuple | None = None
        self._published_verified_at = 0.0
        try:
            self._publish_recheck_s = float(os.environ.get(
                "TPU_DRA_PUBLISH_RECHECK_S", "300"))
        except ValueError:
            self._publish_recheck_s = 300.0
        self.reconciler = NodeStateReconciler(
            self.state, kube_client, node_name, metrics=recovery_metrics)
        # The live tenant-demand store, fed by the health poll's
        # per-tenant usage samples.
        self.tenant_profiles = TenantProfileStore()
        self.partition_watcher: PartitionSetWatcher | None = None
        if self.state.partition_engine is not None and os.environ.get(
                "TPU_DRA_PARTITION_WATCH", "1") not in ("0", "false",
                                                        "False"):
            self.partition_watcher = PartitionSetWatcher(
                kube_client, pool=config.pool_name or node_name,
                apply_fn=self.apply_partition_set,
                bootstrap=self.state.partition_engine.partition_set,
                prewarm_fn=self.apply_prewarm)
        self.health_monitor: ChipHealthMonitor | None = None
        if enable_health_monitor:
            # The startup enumeration is the baseline of the devfs
            # backend's health: a node that vanishes is chip_lost, and
            # the AER counters are read at the GPUs' PCI addresses.
            gpus = sorted((d.gpu for d in self.state.allocatable.values()
                           if d.kind == DeviceKind.CHIP),
                          key=lambda c: c.index)
            opts = dataclasses.replace(
                config.gpulib_opts,
                expected_chips=",".join(str(c.minor) for c in gpus),
                expected_bdfs=",".join(c.pci_bdf for c in gpus))
            on_quarantine = on_failed = None
            if resilience is not None:
                on_quarantine = (lambda device: resilience.quarantines
                                 .labels(device).inc())
            if recovery_metrics is not None:
                on_failed = (lambda device: recovery_metrics
                             .permanent_failures.labels("device").inc())
            self.health_monitor = ChipHealthMonitor(
                load(config.backend), opts, self._on_health_taints,
                additional_ignored=additional_ignored_health_kinds,
                quarantine=QuarantineTracker(on_quarantine=on_quarantine,
                                             on_failed=on_failed),
                on_tenant_usage=self._on_tenant_usage,
                telemetry_ring=fleetstate.default_ring(),
                on_chip_telemetry=self._on_chip_telemetry,
                on_anomaly=self._on_anomaly)
        else:
            self._taints = {
                name: [DeviceTaint(device=name,
                                   key=f"{TAINT_KEY_PREFIX}/unmonitored",
                                   value="true", effect="").to_dict()]
                for name in self.state.allocatable}

    def start(self) -> None:
        """Start the sweep (the stale-claim GC is its first pass) and the
        health monitor, then publish."""
        self.reconciler.start()
        if self.health_monitor:
            self.health_monitor.start()
        # Construction may have re-owned prepared claims and their
        # agents: the gauges start from them, not from 0.
        self._set_gauges()
        self.publish_resources()
        # After the bootstrap publish: the watcher's first reconcile
        # converges onto the governing CRD, if any.
        if self.partition_watcher is not None:
            self.partition_watcher.start()

    def stop(self) -> None:
        """Stop and join every thread this driver started; the monitor
        closes its device library, and the device state stops its
        tenancy agents and closes the library it kept for MIG. A
        ``Driver`` constructed again over the same root re-owns the
        agents of the claims still prepared."""
        if self.partition_watcher is not None:
            self.partition_watcher.stop()
        self.reconciler.stop()
        if self.health_monitor:
            self.health_monitor.stop()
        self.state.close()

    def _server_supports_split(self) -> bool:
        try:
            v = self.kube.server_version()
            return (int(v.get("major", "0")),
                    int(v.get("minor", "0").rstrip("+"))) \
                >= SPLIT_SERVER_VERSION
        except Exception:  # noqa: BLE001 - an unknown server: combined
            return False

    # -- DRA callbacks ---------------------------------------------------

    def _set_gauges(self) -> None:
        self.metrics.prepared_devices.set(self.state.prepared_device_count())
        self.metrics.tenancy_agents.set(self.state.tenancy_agent_count())

    def prepare_resource_claims(self, claim_refs: list) -> dict:
        """``claim_refs``: dicts with uid, namespace and name. Returns
        uid -> (devices, error), error "" on success."""
        out = {}
        for ref in claim_refs:
            uid = ref["uid"]
            try:
                with self.metrics.observe("NodePrepareResources"):
                    out[uid] = (self._prepare_one(ref), "")
            except Exception as e:  # noqa: BLE001 - wire boundary
                logger.exception("prepare failed for claim %s", uid)
                flightrecorder.default().record(
                    uid, "prepare_failed", error=str(e)[:200])
                out[uid] = ([], str(e))
        self._set_gauges()
        return out

    def _prepare_one(self, ref) -> list[dict]:
        uid, namespace, name = ref["uid"], ref["namespace"], ref["name"]
        t0 = time.monotonic()
        obj = self.kube.get(RESOURCE_GROUP, RESOURCE_VERSION,
                            "resourceclaims", name, namespace=namespace)
        if obj.get("metadata", {}).get("uid") != uid:
            raise NotFoundError(f"claim {namespace}/{name} UID mismatch")
        claim = ResourceClaim.from_dict(obj)
        # A scheduler's commit span rides the claim's traceparent
        # annotation: the prepare records under the same trace id.
        trace_id = tracing.trace_id_of(claim.annotations)
        self.state.prepare(claim)
        self.metrics.slo.observe("prepare", time.monotonic() - t0, trace_id)
        flightrecorder.default().record(
            uid, "prepare_done", alias=f"{namespace}/{name}",
            trace_id=trace_id, ms=round((time.monotonic() - t0) * 1e3, 2))
        # The CDI ids, grouped by request for the kubelet's answer.
        record = self.state.prepared_claims()[uid]
        request_of = {r.device: r.request for r in claim.results}
        by_request: dict[str, list] = {}
        for dev in record.devices:
            by_request.setdefault(request_of.get(dev.canonical_name, ""),
                                  []).append(dev)
        devices = [{"request_names": [request] if request else [],
                    "pool_name": self.node_name,
                    "device_name": dev.canonical_name,
                    "cdi_device_ids": dev.cdi_device_ids}
                   for request, devs in by_request.items() for dev in devs]
        logger.info("prepared claim %s (%d devices) in %.1fms", uid,
                    len(devices), (time.monotonic() - t0) * 1e3)
        return devices

    def unprepare_resource_claims(self, claim_refs: list) -> dict:
        """``claim_refs``: dicts with uid. Returns uid -> error, "" on
        success."""
        out = {}
        for ref in claim_refs:
            uid = ref["uid"]
            try:
                with self.metrics.observe("NodeUnprepareResources"):
                    self.state.unprepare(uid)
                out[uid] = ""
            except Exception as e:  # noqa: BLE001 - wire boundary
                logger.exception("unprepare failed for claim %s", uid)
                out[uid] = str(e)
        self._set_gauges()
        return out

    # -- ResourceSlice publication ---------------------------------------

    def generate_resource_slices(self) -> list[dict]:
        """The node's ResourceSlices in the publication mode, each device
        with its taints and its counters, each slice with the counter
        sets; ``resourceSliceCount`` is the number of slices built."""
        profiles = self.state.subslice_profiles
        gpus, migs, parts = [], [], []
        for dev in sorted(self.state.allocatable.values(),
                          key=AllocatableDevice.sort_key):
            entry = dev.to_dra_device()
            # A MIG device carries its GPU's health taints.
            taints = self._taints.get(dev.canonical_name) or \
                self._taints.get(gpu_name(dev.gpu.index))
            if taints:
                entry["taints"] = taints
            tele = self._telemetry_attrs.get(dev.canonical_name)
            if tele:
                entry.setdefault("attributes", {}).update(tele)
            if self._power_cap_w > 0 and dev.kind == DeviceKind.CHIP:
                entry.setdefault("attributes", {})[ATTR_POWER_CAP] = {
                    "int": self._power_cap_w}
            counters = consumed_counters(dev, profiles)
            if counters:
                entry["consumesCounters"] = counters
            (gpus if dev.kind in (DeviceKind.CHIP, DeviceKind.PASSTHROUGH)
             else parts
             if dev.kind == DeviceKind.PARTITION else migs).append(entry)

        def slice_obj(suffix: str, devices: list[dict]) -> dict:
            spec = {"driver": DRIVER_NAME, "nodeName": self.node_name,
                    "pool": {"name": self.node_name,
                             "resourceSliceCount": 1, "generation": 1},
                    "perDeviceNodeSelection": False, "devices": devices,
                    "sharedCounters": shared_counter_sets(self.state.host,
                                                          profiles)}
            return {"apiVersion": f"{RESOURCE_GROUP}/{RESOURCE_VERSION}",
                    "kind": "ResourceSlice",
                    "metadata": {"name":
                                 f"{self.node_name}-{DRIVER_NAME}{suffix}"},
                    "spec": spec}

        if self.publication_mode == "split" and (migs or parts):
            slices = [slice_obj("-gpus", gpus)] + [
                slice_obj(suffix, devs) for suffix, devs in (
                    ("-mig", migs), ("-partitions", parts)) if devs]
        else:
            slices = [slice_obj("", gpus + migs + parts)]
        for s in slices:
            s["spec"]["pool"]["resourceSliceCount"] = len(slices)
        return slices

    @staticmethod
    def _slice_hashes(slices: list[dict]) -> tuple:
        return tuple(sorted((s["metadata"]["name"], slice_content_hash(s))
                            for s in slices))

    def publish_resources(self) -> dict:
        """Publish through the content-hash diff: an unchanged pool
        costs one list and no write; the generation moves only with the
        inventory. Returns ``publish_resource_slices``'s stats."""
        with self._publish_lock:
            slices = self.generate_resource_slices()
            hashes = self._slice_hashes(slices)
            stats = publish_resource_slices(
                self.kube, slices,
                on_skip=self.metrics.slice_publish_skipped.inc)
            self._published_hashes = hashes
            self._published_verified_at = time.monotonic()
            return stats

    # -- partitions ------------------------------------------------------

    def apply_partition_set(self, partition_set) -> dict:
        """Re-plan the partitions and republish through the diff: only
        slices whose devices changed are written, and a converged
        re-apply writes nothing. Returns the publish's stats."""
        self.state.apply_partition_set(partition_set)
        return self.publish_resources()

    def apply_prewarm(self, hints: dict) -> int:
        """Converge the engine's warm MIG instances onto the watcher's
        hint; no republish (a warm instance changes no published device).
        Returns the instances created."""
        if self.state.partition_engine is None:
            return 0
        return self.state.partition_engine.set_prewarm(hints or {})

    # -- health ----------------------------------------------------------

    def _on_health_taints(self, taints: list[DeviceTaint]) -> None:
        """Take the monitor's full taint list and republish
        (``driver.go:496-566``)."""
        new: dict[str, list[dict]] = {}
        for t in taints:
            new.setdefault(t.device, []).append(t.to_dict())
        self._taints = new
        self.metrics.set_taints(taints)
        self._republish_reconciled()

    def _republish_reconciled(self) -> None:
        """No API call when the slices hash to what was last published
        and the live pool was read within the recheck period; else a
        publish through the diff (which writes only what differs)."""
        with self._publish_lock:
            slices = self.generate_resource_slices()
            hashes = self._slice_hashes(slices)
            fresh = (time.monotonic() - self._published_verified_at
                     < self._publish_recheck_s)
            if hashes == self._published_hashes and fresh:
                self.metrics.slice_publish_skipped.inc(len(slices))
                return
            try:
                publish_resource_slices(
                    self.kube, slices,
                    on_skip=self.metrics.slice_publish_skipped.inc)
                self._published_hashes = hashes
                self._published_verified_at = time.monotonic()
            except Exception:  # noqa: BLE001 - the next poll publishes again
                logger.exception("republish after health event failed")

    # -- fleet telemetry -------------------------------------------------

    def _on_tenant_usage(self, usage) -> None:
        """The health poll's per-tenant usage samples -> the live
        tenant-demand store the sizing policy reads."""
        for u in usage:
            self.tenant_profiles.record(u.tenant, u.hbm_bytes,
                                        cores=u.cores)

    def _on_chip_telemetry(self, samples) -> None:
        """The monitor's samples -> per-GPU gauges and quantized slice
        attributes, republished only when a value moved a step."""
        hbm_cap = max(self.state.host.memory_bytes_per_chip, 1)
        attrs: dict[str, dict] = {}
        self.metrics.telemetry.prune_absent(s.chip for s in samples)

        def q(val: float, step: int) -> int:
            return int(round(float(val) / step) * step)

        for s in samples:
            self.metrics.telemetry.observe_sample(s)
            name = gpu_name(s.chip)
            if name not in self.state.allocatable:
                continue
            attrs[name] = {
                fleetstate.ATTR_POWER: {
                    "int": q(s.power_watts, TELEMETRY_POWER_STEP_W)},
                fleetstate.ATTR_TEMP: {
                    "int": q(s.temp_celsius, TELEMETRY_TEMP_STEP_C)},
                fleetstate.ATTR_DUTY: {
                    "int": q(s.duty_cycle * 100, TELEMETRY_DUTY_STEP_PCT)},
                fleetstate.ATTR_HBM: {
                    "int": q(s.hbm_used_bytes * 100 / hbm_cap,
                             TELEMETRY_HBM_STEP_PCT)},
                fleetstate.ATTR_ICI_ERR: {
                    "int": q(s.ici_link_errors, TELEMETRY_ICI_STEP)},
            }
        if not self._telemetry_attrs_enabled:
            return
        # REPLACE semantics: a GPU absent from this sample set drops its
        # attributes rather than publish a frozen last reading.
        if attrs == self._telemetry_attrs:
            # Nothing moved a step: the slices cannot have changed
            # (the taint path's periodic recheck still repairs slices
            # changed behind the driver's back).
            return
        self._telemetry_attrs = attrs
        self._republish_reconciled()

    def _on_anomaly(self, detections) -> None:
        """Anomaly rising edges -> counter, flight event, and one Warning
        Event on the Node. The quarantine needs no wiring: the
        detector's taints ride the poll's list into the tracker."""
        for det in detections:
            self.metrics.telemetry.inc_anomaly(det.kind)
            flightrecorder.default().record(
                det.device, "anomaly", kind=det.kind, node=self.node_name,
                **det.detail)
            logger.warning("telemetry anomaly on %s/%s: %s %s",
                           self.node_name, det.device, det.kind, det.detail)
            emit_warning_event(
                self.kube,
                # Fixed by (node, device, kind): a repeat episode of the
                # same anomaly is a 409, dropped.
                event_name=(f"{self.node_name}.{det.device}."
                            f"{det.kind.replace('_', '-')}"),
                namespace="default", reason="TelemetryAnomaly",
                message=(f"{det.kind} detected on {det.device} (node "
                         f"{self.node_name}): {det.detail}; time-series "
                         "at /debug/telemetry on the node plugin, bundle "
                         "via python -m "
                         "k8s_dra_driver_gpu_tpu_torch.pkg.doctor"),
                involved_kind="Node", involved_name=self.node_name,
                component="tpu-dra-kubelet-plugin")
