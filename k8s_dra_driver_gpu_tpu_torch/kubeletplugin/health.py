"""GPU health: the device layer's health events become DRA device
taints (the JAX package's ``kubeletplugin/health.py``; the upstream
driver's ``device_health.go``).

``ChipHealthMonitor`` polls the port's ``tpulib`` ``health()``: NVML's
Xid and double-bit ECC events, a GPU NVML reports lost and the PCIe AER
counters (``NvmlLib``), or the mock's ``chip=<i>,kind=<kind>`` injection
(``PyGpuLib``). Each event becomes a taint on ``gpu-<i>`` under
``tpu.dra.dev/<kind>`` (the JAX control plane reads these keys, as the
launcher reads the ``TPU_*`` env): ``NoExecute`` for a fatal kind, no
effect (observe only) for the rest; benign kinds are skipped
(``DEFAULT_IGNORED_KINDS`` and the operator's additions, the upstream
skip list ``device_health.go:394-443``). The monitor hands the whole
current taint list to its callback every poll, so the consumer
reconciles instead of accumulating.

``QuarantineTracker`` escalates a flapping GPU (non-fatal events that
come and go) to a ``degraded`` NoSchedule taint, releases it after a
clean hysteresis period, and after repeated quarantines declares it
``failed`` (NoExecute, sticky; ``pkg/recovery.py`` evicts its claims).
``on_quarantine`` and ``on_failed`` fire once an escalation (the kubelet
driver's metrics hooks).

Fleet telemetry rides the same poll (``sample_chip_telemetry``, the JAX
monitor's): each GPU's power, temperature, memory and utilization
sample (``tpulib.chip_telemetry``) lands in the telemetry ring
(``pkg/fleetstate``, served at ``/debug/telemetry``), runs through the
anomaly detector (``pkg/anomaly``), and reaches the driver through
``on_chip_telemetry`` (gauges and quantized slice attributes) and
``on_anomaly`` (rising edges: counter, flight event, Warning Event).
The detector's observe-only taints merge into the poll's list BEFORE the
quarantine pass, so a flapping anomaly escalates as a flapping event
does. A sample that raises (NVML refuses ``chip_telemetry`` in a process
that has initialised CUDA) is logged and loses only its samples, never
the health poll. ``TPU_DRA_TELEMETRY=0`` turns the station off.

The monitor owns the device library it is given: ``stop()`` closes it.
A failing poll backs off exponentially and never kills the thread; the
fault point ``health.poll`` (``pkg/faults.py``) acts at each poll.

The per-tenant usage feed rides the same cadence too
(``sample_telemetry``, the JAX monitor's): the device library's
``tenant_usage`` samples (the ``GPULIB_MOCK_TENANT_USAGE`` grammar on
both backends, since NVML has no notion of a tenant) go to
``on_tenant_usage``, the kubelet driver's ``TenantProfileStore``. A
sample that raises is logged and never breaks the poll.
"""

from __future__ import annotations

import logging
import threading
import time
from dataclasses import dataclass
from typing import Callable

from ..pkg import anomaly as anomaly_mod
from ..pkg import faults, fleetstate, positive_float_env
from ..tpulib.binding import EnumerateOptions, HealthEvent
from .deviceinfo import gpu_name

logger = logging.getLogger(__name__)

TAINT_KEY_PREFIX = "tpu.dra.dev"
QUARANTINE_KIND = "degraded"
FAILED_KIND = "failed"

# Benign kinds: never a taint.
DEFAULT_IGNORED_KINDS = frozenset({"thermal_notice", "clock_throttle"})

POLL_INTERVAL_S = positive_float_env(
    "TPU_DRA_HEALTH_POLL_S", default=5.0, floor=0.05)
# A failing poll backs off up to this cap.
POLL_BACKOFF_MAX_S = positive_float_env(
    "TPU_DRA_HEALTH_BACKOFF_MAX_S", default=60.0, floor=0.05)

# N non-fatal transitions within the window quarantine a GPU; it must
# then stay clean for the hysteresis period to be released.
QUARANTINE_EVENTS = int(positive_float_env(
    "TPU_DRA_QUARANTINE_EVENTS", default=3, floor=1))
QUARANTINE_WINDOW_S = positive_float_env(
    "TPU_DRA_QUARANTINE_WINDOW_S", default=300.0, floor=0.05)
QUARANTINE_HYSTERESIS_S = positive_float_env(
    "TPU_DRA_QUARANTINE_HYSTERESIS_S", default=600.0, floor=0.05)
# A GPU quarantined this many separate times is declared failed.
QUARANTINE_FATAL_ESCALATIONS = int(positive_float_env(
    "TPU_DRA_RECOVERY_FATAL_QUARANTINES", default=3, floor=1))


@dataclass(frozen=True)
class DeviceTaint:
    device: str  # canonical device name, gpu-<i>
    key: str
    value: str
    effect: str  # NoSchedule | NoExecute | "" (observe only)

    def to_dict(self) -> dict:
        d = {"key": self.key, "value": self.value}
        if self.effect:
            d["effect"] = self.effect
        return d


def health_event_to_taints(
        event: HealthEvent,
        ignored_kinds: frozenset[str] = DEFAULT_IGNORED_KINDS,
) -> list[DeviceTaint]:
    """The taints of one event on its GPU."""
    if event.kind in ignored_kinds:
        return []
    return [DeviceTaint(device=gpu_name(event.chip),
                        key=f"{TAINT_KEY_PREFIX}/{event.kind}",
                        value="true",
                        effect="NoExecute" if event.fatal else "")]


class QuarantineTracker:
    """Escalates flapping chips to NoSchedule quarantine, with
    hysteresis on the way back.

    State machine per device:
      healthy --(>= threshold non-fatal events inside window)--> quarantined
      quarantined --(clean for >= hysteresis)--> healthy
      quarantined --(earned quarantine >= fatal_after times)--> FAILED

    FAILED is terminal and sticky (``tpu.dra.dev/failed`` NoExecute):
    a chip that keeps cycling healthy -> quarantined -> "healed" ->
    quarantined has proven the hysteresis release wrong repeatedly --
    that is hardware dying, and the control plane escalates its claims
    to PermanentFailure + eviction off the published taint.

    ``observe(taints)`` is called once per poll with the RAW taint list
    and returns the quarantine + failure taints to merge in.
    ``on_quarantine`` / ``on_failed`` fire once per escalation
    (metrics hooks)."""

    def __init__(
        self,
        threshold: int = QUARANTINE_EVENTS,
        window_s: float = QUARANTINE_WINDOW_S,
        hysteresis_s: float = QUARANTINE_HYSTERESIS_S,
        on_quarantine: Callable[[str], None] | None = None,
        fatal_after: int = QUARANTINE_FATAL_ESCALATIONS,
        on_failed: Callable[[str], None] | None = None,
        clock=time.monotonic,
    ):
        self.threshold = max(1, int(threshold))
        self.window_s = window_s
        self.hysteresis_s = hysteresis_s
        self.on_quarantine = on_quarantine
        self.fatal_after = max(1, int(fatal_after))
        self.on_failed = on_failed
        self._clock = clock
        # device -> recent healthy->sick TRANSITION timestamps
        # (window-pruned). Transitions, not per-poll presence: tpulib
        # reports a chip's CURRENT condition every poll, so a single
        # steady non-fatal warning would otherwise hit the threshold in
        # `threshold` polls (~15s) -- but a steady condition is exactly
        # the "observability without eviction" case; only FLAPPING
        # earns quarantine.
        self._events: dict[str, list[float]] = {}
        # Previous poll's sick set (the edge detector).
        self._prev_flapping: set[str] = set()
        # device -> timestamp of the LAST observed event while
        # quarantined (hysteresis restarts on every flap)
        self._quarantined: dict[str, float] = {}
        # device -> how many SEPARATE times it earned quarantine; at
        # fatal_after it escalates to the sticky failed set.
        self._escalations: dict[str, int] = {}
        self._failed: set[str] = set()
        self.total_quarantines = 0
        self.total_failures = 0

    @property
    def quarantined(self) -> frozenset[str]:
        return frozenset(self._quarantined)

    @property
    def failed(self) -> frozenset[str]:
        """Devices escalated to sticky permanent failure."""
        return frozenset(self._failed)

    def mark_failed(self, device: str) -> None:
        """Declare a device permanently failed directly (the fatal-
        event and reconcile-sweep escalation path: bypasses the
        quarantine counting entirely)."""
        if device in self._failed:
            return
        self._failed.add(device)
        self._quarantined.pop(device, None)
        self._events.pop(device, None)
        self.total_failures += 1
        logger.error(
            "chip %s declared PERMANENTLY FAILED (sticky %s/%s "
            "NoExecute taint; claims on it will be evicted)",
            device, TAINT_KEY_PREFIX, FAILED_KIND,
        )
        if self.on_failed is not None:
            try:
                self.on_failed(device)
            except Exception:  # noqa: BLE001 - metrics hook
                logger.exception("failure hook failed")

    def observe(self, taints: list[DeviceTaint]) -> list[DeviceTaint]:
        now = self._clock()
        flapping = {
            t.device for t in taints
            # Non-fatal, non-quarantine signals only: fatal events carry
            # their own NoExecute taint, and our own degraded taint must
            # not feed back into the event count. A permanently failed
            # device is past all of this bookkeeping.
            if not t.effect and t.device not in self._failed
            and t.key != f"{TAINT_KEY_PREFIX}/{QUARANTINE_KIND}"
        }
        for device in flapping:
            if device in self._quarantined:
                # ANY presence (steady or edge) restarts hysteresis: a
                # chip must be fully clean to earn release.
                self._quarantined[device] = now
                continue
            if device in self._prev_flapping:
                continue  # steady condition, not a new flap
            events = self._events.setdefault(device, [])
            events.append(now)
        self._prev_flapping = flapping
        # Window prune + escalation.
        for device, events in list(self._events.items()):
            events[:] = [t for t in events if now - t <= self.window_s]
            if not events:
                del self._events[device]
                continue
            if len(events) >= self.threshold and \
                    device not in self._quarantined:
                self._quarantined[device] = now
                del self._events[device]
                self.total_quarantines += 1
                logger.warning(
                    "quarantining %s: %d non-fatal health events within "
                    "%.0fs (NoSchedule until clean for %.0fs)",
                    device, self.threshold, self.window_s,
                    self.hysteresis_s,
                )
                if self.on_quarantine is not None:
                    try:
                        self.on_quarantine(device)
                    except Exception:  # noqa: BLE001 - metrics hook
                        logger.exception("quarantine hook failed")
                # A chip earning quarantine for the Nth time has blown
                # through the hysteresis release N-1 times: escalate
                # from quarantine to declared permanent failure.
                n = self._escalations.get(device, 0) + 1
                self._escalations[device] = n
                if n >= self.fatal_after:
                    self.mark_failed(device)
        # Hysteresis release: clean for the full period.
        for device, last_event in list(self._quarantined.items()):
            if device not in flapping and \
                    now - last_event >= self.hysteresis_s:
                del self._quarantined[device]
                logger.warning(
                    "releasing %s from quarantine (clean for %.0fs)",
                    device, now - last_event,
                )
        return [
            DeviceTaint(
                device=device,
                key=f"{TAINT_KEY_PREFIX}/{QUARANTINE_KIND}",
                value="true",
                effect="NoSchedule",
            )
            for device in sorted(self._quarantined)
        ] + [
            # Sticky: a failed chip stays NoExecute-tainted every poll
            # until the plugin restarts after physical repair.
            DeviceTaint(
                device=device,
                key=f"{TAINT_KEY_PREFIX}/{FAILED_KIND}",
                value="true",
                effect="NoExecute",
            )
            for device in sorted(self._failed)
        ]


class ChipHealthMonitor:
    """Polls ``tpulib.health(opts)`` and hands the full current taint
    list (event and anomaly taints, then quarantine and failure taints)
    to ``on_taints`` whenever it changed; samples the GPUs' telemetry on
    the same cadence."""

    def __init__(
        self,
        tpulib,
        opts: EnumerateOptions,
        on_taints: Callable[[list[DeviceTaint]], None],
        ignored_kinds: frozenset[str] = DEFAULT_IGNORED_KINDS,
        additional_ignored: tuple[str, ...] = (),
        poll_interval: float = POLL_INTERVAL_S,
        quarantine: QuarantineTracker | None = None,
        on_quarantine: Callable[[str], None] | None = None,
        on_tenant_usage: Callable[[tuple], None] | None = None,
        telemetry_ring=None,  # pkg.fleetstate.TelemetryRing | None
        anomaly_detector=None,  # pkg.anomaly.AnomalyDetector | None
        on_chip_telemetry: Callable[[tuple], None] | None = None,
        on_anomaly: Callable[[list], None] | None = None,
    ):
        self._tpulib = tpulib
        self._opts = opts
        self._on_taints = on_taints
        # Per-tenant usage (tpulib.tenant_usage) for the consumer's
        # TenantProfileStore; None turns the feed off.
        self._on_tenant_usage = on_tenant_usage
        self._telemetry_enabled = fleetstate.telemetry_enabled()
        self.telemetry_ring = telemetry_ring
        self.anomaly = anomaly_detector
        if self._telemetry_enabled and self.anomaly is None and \
                (on_anomaly is not None or telemetry_ring is not None):
            self.anomaly = anomaly_mod.AnomalyDetector(chip_name=gpu_name)
        self._on_chip_telemetry = on_chip_telemetry
        self._on_anomaly = on_anomaly
        self._ignored = frozenset(ignored_kinds) | frozenset(
            additional_ignored)
        self._interval = poll_interval
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run,
                                        name="gpu-health", daemon=True)
        self._last: list[DeviceTaint] | None = None
        self.quarantine = quarantine or QuarantineTracker(
            on_quarantine=on_quarantine)
        self.consecutive_failures = 0

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Stop and join the poll thread, then close the device
        library."""
        self._stop.set()
        if self._thread.ident is not None:  # join only a started thread
            self._thread.join(timeout=self._interval + 1)
            if self._thread.is_alive():
                logger.error("health poll thread did not stop; the device "
                             "library stays open")
                return
        close = getattr(self._tpulib, "close", None)
        if close is not None:
            close()

    def poll_once(self) -> list[DeviceTaint]:
        # ``error`` here must not kill the poll thread (_run backs off).
        faults.fault_point("health.poll")
        taints: list[DeviceTaint] = []
        for ev in self._tpulib.health(self._opts):
            taints.extend(health_event_to_taints(ev, self._ignored))
        return taints

    def poll_and_reconcile(self) -> list[DeviceTaint]:
        """One poll, one telemetry sample and one quarantine pass: the
        list the callback sees (also the entry for driving the monitor
        by hand). Anomaly taints merge before the quarantine pass."""
        taints = self.poll_once()
        try:
            # Telemetry never poisons the health poll: a broken seam
            # loses its samples (and their anomaly taints) only.
            self.sample_chip_telemetry()
        except Exception:  # noqa: BLE001 - telemetry best-effort
            logger.exception("chip-telemetry sample failed")
        if self.anomaly is not None:
            taints = taints + self.anomaly.taints(
                DeviceTaint, TAINT_KEY_PREFIX)
        return taints + self.quarantine.observe(taints)

    def sample_chip_telemetry(self) -> tuple:
        """One telemetry sample through the device library: ring
        append, anomaly fold, the callbacks. Returns the samples (also
        the entry for driving it by hand). A no-op with
        ``TPU_DRA_TELEMETRY=0``, a library without the seam, or nothing
        wired."""
        if not self._telemetry_enabled:
            return ()
        fn = getattr(self._tpulib, "chip_telemetry", None)
        if fn is None:
            return ()
        if self.telemetry_ring is None and self.anomaly is None and \
                self._on_chip_telemetry is None:
            return ()
        samples = tuple(fn(self._opts) or ())
        if self.telemetry_ring is not None:
            for s in samples:
                self.telemetry_ring.record_sample(s)
        if self.anomaly is not None:
            detections = self.anomaly.observe(samples)
            if detections and self._on_anomaly is not None:
                try:
                    self._on_anomaly(detections)
                except Exception:  # noqa: BLE001 - consumer hook
                    logger.exception("anomaly hook failed")
        if self._on_chip_telemetry is not None:
            # Delivered even when EMPTY: the consumer drops the slice
            # attributes of GPUs that stopped reporting.
            self._on_chip_telemetry(samples)
        return samples

    def sample_telemetry(self) -> tuple:
        """One per-tenant usage sample through the device library,
        handed to ``on_tenant_usage``; the samples (also the entry for
        driving it by hand). A no-op without a consumer or a library
        without the seam."""
        if self._on_tenant_usage is None:
            return ()
        fn = getattr(self._tpulib, "tenant_usage", None)
        if fn is None:
            return ()
        usage = tuple(fn(self._opts) or ())
        if usage:
            self._on_tenant_usage(usage)
        return usage

    def _backoff(self) -> float:
        """The base interval, doubled for each consecutive failure up to
        the cap."""
        if self.consecutive_failures == 0:
            return self._interval
        return min(
            self._interval * (2 ** min(self.consecutive_failures, 16)),
            max(POLL_BACKOFF_MAX_S, self._interval))

    def _run(self) -> None:
        while not self._stop.wait(self._backoff()):
            # Everything is guarded: a dead monitor would read as "all
            # healthy" forever.
            try:
                taints = self.poll_and_reconcile()
            except Exception:  # noqa: BLE001 - monitor must survive
                self.consecutive_failures += 1
                logger.exception(
                    "health poll failed (%d consecutive; next attempt "
                    "in %.1fs)", self.consecutive_failures, self._backoff())
                continue
            self.consecutive_failures = 0
            try:
                # A broken usage seam loses its samples, never the poll.
                self.sample_telemetry()
            except Exception:  # noqa: BLE001 - telemetry best-effort
                logger.exception("tenant-usage sample failed")
            if taints != self._last:
                self._last = taints
                try:
                    self._on_taints(taints)
                except Exception:  # noqa: BLE001 - consumer bug
                    # Deliver again on the next poll.
                    self._last = None
                    self.consecutive_failures += 1
                    logger.exception("health taint callback failed")
