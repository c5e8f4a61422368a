"""Telemetry anomaly detection: EWMA/z-score detectors over the
per-chip telemetry stream (the JAX package's ``pkg/anomaly.py``, the
port's copy; a chip is a GPU, ``gpu-<i>``, and the ICI error counter is
the GPU's NVLink error sum).

The node collector (kubeletplugin/health.py) feeds every health-poll
telemetry sample through one :class:`AnomalyDetector`; detections are
surfaced four ways by the driver wiring:

- a deduped Warning Event on the Node (create-once per episode),
- ``tpu_dra_anomaly_total{kind}`` on the plugin registry,
- a flight-recorder entry keyed by the device name, and
- a NON-FATAL device taint (``tpu.dra.dev/<kind>``, empty effect)
  merged into the poll's taint list -- which is exactly what the
  QuarantineTracker counts, so a chip whose anomaly FLAPS (drifts hot,
  recovers, drifts again) escalates to NoSchedule quarantine through
  the existing machinery, while a steady condition stays observe-only.

Detection is deliberately boring and cheap -- one EWMA mean/variance
pair per (chip, signal) plus plain thresholds:

``thermal_drift``
    temperature z-score above ``TPU_DRA_ANOMALY_Z`` vs the chip's OWN
    EWMA baseline (one-sided: only drift UP), after a minimum-sample
    warmup -- a chip that always ran hot is baseline, a chip that is
    GETTING hot is an anomaly.
``power_cap_throttle``
    power pinned at/above ``TPU_DRA_ANOMALY_POWER_CAP_W`` while the
    duty cycle is high: the chip is being clock-throttled by its power
    cap (2501.17752's scheduler-visible power signal). 0 disables.
``duty_cycle_straggler``
    this chip's duty cycle far below its same-poll peers' mean while
    the peers are busy -- the straggler profile that silently drags a
    whole gang's step time.
``ici_link_error_burst``
    the CUMULATIVE link-error counter jumped by more than
    ``TPU_DRA_ANOMALY_ICI_BURST`` within one poll interval.

Episode semantics: :meth:`AnomalyDetector.observe` returns NEW
detections (rising edges) for event/metric/flight emission, while
:meth:`taints` reflects the CURRENT level for the quarantine feed --
an anomaly that persists is one episode (one Warning Event, one
counter increment) but taints every poll until it clears.

State mutations live in this module + pkg/fleetstate.py + health.py
only.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass, field

from . import positive_float_env

#: z-score threshold for the EWMA drift detectors.
ANOMALY_Z = positive_float_env("TPU_DRA_ANOMALY_Z", default=3.0,
                               floor=0.5)
#: EWMA smoothing factor (weight of the newest sample).
ANOMALY_ALPHA = positive_float_env("TPU_DRA_ANOMALY_ALPHA", default=0.2,
                                   floor=0.01)
#: Samples a chip's baseline must see before drift can fire.
ANOMALY_MIN_SAMPLES = int(positive_float_env(
    "TPU_DRA_ANOMALY_MIN_SAMPLES", default=8, floor=2))
#: ICI link-error delta per poll that counts as a burst.
ANOMALY_ICI_BURST = int(positive_float_env(
    "TPU_DRA_ANOMALY_ICI_BURST", default=5, floor=1))
#: Straggler: peers' mean duty must exceed this...
ANOMALY_STRAGGLER_PEERS_DUTY = positive_float_env(
    "TPU_DRA_ANOMALY_STRAGGLER_PEERS_DUTY", default=0.7, floor=0.05)
#: ...while this chip trails the mean by at least this much.
ANOMALY_STRAGGLER_GAP = positive_float_env(
    "TPU_DRA_ANOMALY_STRAGGLER_GAP", default=0.4, floor=0.05)

KIND_THERMAL = "thermal_drift"
KIND_POWER = "power_cap_throttle"
KIND_STRAGGLER = "duty_cycle_straggler"
KIND_ICI = "ici_link_error_burst"
KINDS = (KIND_THERMAL, KIND_POWER, KIND_STRAGGLER, KIND_ICI)


def _power_cap_env() -> float:
    """``TPU_DRA_ANOMALY_POWER_CAP_W``: the platform's per-chip power
    cap in watts for throttle detection; 0 (the default) disables --
    the cap is platform-specific and must be configured, never
    guessed."""
    import os  # noqa: PLC0415

    try:
        return max(float(os.environ.get(
            "TPU_DRA_ANOMALY_POWER_CAP_W", "0")), 0.0)
    except ValueError:
        return 0.0


@dataclass(frozen=True)
class Anomaly:
    """One detection episode's rising edge."""

    device: str  # canonical device name (gpu-N)
    kind: str
    detail: dict = field(default_factory=dict)


class Ewma:
    """Exponentially-weighted mean/variance pair (one per chip+signal);
    ``update`` returns the z-score of the sample against the PRIOR
    baseline, then folds it in."""

    __slots__ = ("alpha", "mean", "var", "n")

    def __init__(self, alpha: float = 0.0):
        self.alpha = alpha or ANOMALY_ALPHA
        self.mean = 0.0
        self.var = 0.0
        self.n = 0

    def zscore(self, x: float) -> float:
        """z of ``x`` against the current baseline (no fold)."""
        if self.n == 0:
            return 0.0
        sd = self.var ** 0.5
        if sd <= 1e-9:
            # A flat baseline: any real move is "infinite" sigma; use
            # a minimum scale of 1% of the mean (or 1.0) so the first
            # wiggle of a perfectly-flat series doesn't page.
            sd = max(abs(self.mean) * 0.01, 1.0)
        return (float(x) - self.mean) / sd

    def update(self, x: float) -> float:
        """Fold ``x`` into the baseline; returns its prior z-score.
        Callers detecting drift fold only NON-anomalous samples
        (baseline freeze), so an excursion cannot normalize itself
        into the baseline and mute every following episode."""
        z = self.zscore(x)
        if self.n == 0:
            self.mean, self.var, self.n = float(x), 0.0, 1
            return 0.0
        delta = float(x) - self.mean
        self.mean = self.mean + self.alpha * delta
        # West-style EWM variance: stable, no sample window to keep.
        self.var = (1 - self.alpha) * (self.var
                                       + self.alpha * delta * delta)
        self.n += 1
        return z


class AnomalyDetector:
    """Per-node detector over the health-poll telemetry stream."""

    def __init__(self, z_threshold: float = 0.0,
                 min_samples: int = 0, power_cap_w: float | None = None,
                 ici_burst: int = 0, straggler_peers_duty: float = 0.0,
                 straggler_gap: float = 0.0, alpha: float = 0.0,
                 chip_name=None):
        self.z = z_threshold or ANOMALY_Z
        self.min_samples = min_samples or ANOMALY_MIN_SAMPLES
        self.power_cap_w = (_power_cap_env() if power_cap_w is None
                            else power_cap_w)
        self.ici_burst = ici_burst or ANOMALY_ICI_BURST
        self.straggler_peers_duty = (straggler_peers_duty
                                     or ANOMALY_STRAGGLER_PEERS_DUTY)
        self.straggler_gap = straggler_gap or ANOMALY_STRAGGLER_GAP
        self._alpha = alpha or ANOMALY_ALPHA
        # Canonical device naming (kubeletplugin.deviceinfo.gpu_name);
        # injectable so pkg/ has no import edge into kubeletplugin/.
        self._chip_name = chip_name or (lambda i: f"gpu-{i}")
        self._lock = threading.Lock()
        self._temp: dict[int, Ewma] = {}
        self._ici_last: dict[int, int] = {}
        # (device, kind) currently active -- the level the taint feed
        # reflects; observe() returns only rising edges.
        self._active: set[tuple[str, str]] = set()
        self.detections_total = 0

    def observe(self, samples) -> list[Anomaly]:
        """Fold one poll's ChipTelemetry samples; returns the NEW
        detections (episode rising edges)."""
        samples = list(samples or ())
        with self._lock:
            return self._fold_samples(samples)

    def _fold_samples(self, samples) -> list[Anomaly]:
        new: list[Anomaly] = []
        now_active: set[tuple[str, str]] = set()
        duties = [float(getattr(s, "duty_cycle", 0.0)) for s in samples]
        for i, s in enumerate(samples):
            device = self._chip_name(int(s.chip))
            # thermal drift (one-sided EWMA z-score). Anomalous
            # samples are NOT folded into the baseline: a drifting
            # chip must not normalize its own excursion and mute the
            # next episode (the flapping the quarantine feed counts).
            ewma = self._temp.get(s.chip)
            if ewma is None:
                ewma = self._temp[s.chip] = Ewma(self._alpha)
            warmed = ewma.n >= self.min_samples
            zscore = ewma.zscore(float(s.temp_celsius))
            if warmed and zscore >= self.z:
                now_active.add((device, KIND_THERMAL))
                self._edge(new, device, KIND_THERMAL,
                           temp_c=float(s.temp_celsius),
                           z=round(zscore, 2))
            else:
                ewma.update(float(s.temp_celsius))
            # power-cap throttling
            if self.power_cap_w > 0 and \
                    float(s.power_watts) >= self.power_cap_w * 0.98 \
                    and float(s.duty_cycle) >= 0.5:
                now_active.add((device, KIND_POWER))
                self._edge(new, device, KIND_POWER,
                           power_w=float(s.power_watts),
                           cap_w=self.power_cap_w)
            # ICI link-error burst (cumulative counter delta per poll)
            last = self._ici_last.get(s.chip)
            self._ici_last[s.chip] = int(s.ici_link_errors)
            if last is not None:
                delta = int(s.ici_link_errors) - last
                if delta >= self.ici_burst:
                    now_active.add((device, KIND_ICI))
                    self._edge(new, device, KIND_ICI, delta=delta)
            # duty-cycle straggler vs same-poll peers (the gang's other
            # members on this host run the same program; one chip idling
            # while its peers are pegged is the straggler profile)
            if len(samples) >= 2:
                peers = duties[:i] + duties[i + 1:]
                peers_mean = sum(peers) / len(peers)
                if peers_mean >= self.straggler_peers_duty and \
                        duties[i] <= peers_mean - self.straggler_gap:
                    now_active.add((device, KIND_STRAGGLER))
                    self._edge(new, device, KIND_STRAGGLER,
                               duty=duties[i],
                               peers_mean=round(peers_mean, 3))
        # Episodes end when the condition clears: drop inactive pairs
        # so the next occurrence is a fresh edge (and the taint feed
        # reflects the current level).
        self._active = now_active
        return new

    def _edge(self, out: list[Anomaly], device: str, kind: str,
              **detail) -> None:
        if (device, kind) not in self._active:
            self.detections_total += 1
            out.append(Anomaly(device=device, kind=kind, detail=detail))

    def active(self) -> frozenset[tuple[str, str]]:
        """(device, kind) pairs currently in an anomaly episode."""
        with self._lock:
            return frozenset(self._active)

    def taints(self, taint_cls, key_prefix: str):
        """The CURRENT anomaly level as non-fatal device taints (empty
        effect = observe-only) -- the QuarantineTracker feed. The
        taint class + prefix are injected so pkg/ has no import edge
        into kubeletplugin/health.py."""
        with self._lock:
            active = sorted(self._active)
        return [
            taint_cls(device=device, key=f"{key_prefix}/{kind}",
                      value="true", effect="")
            for device, kind in active
        ]
