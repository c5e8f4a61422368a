"""Deterministic fault injection for the driver stack (the JAX package's
``pkg/faults.py``).

Reference analog: the bats robustness sweep (test_gpu_robustness.bats)
kills and restarts components at fixed points; mock-NVML injects health
events through a control file. This module generalizes both into NAMED
FAULT POINTS compiled into every external-interaction seam of the
runtime -- kube API calls (pkg/retry.py), watch streams
(pkg/kubeclient.py), tpulib enumeration/health (tpulib/binding.py,
kubeletplugin/health.py), flock acquisition (pkg/flock.py), checkpoint
write/fsync (kubeletplugin/checkpoint.py), every SegmentTimer segment of
the prepare/unprepare pipeline (pkg/timing.py), the CD daemon's
rendezvous service (computedomain/daemon/rendezvous.py), the partition
engine's create and destroy (pkg/partition/engine.py) and the eviction
controller's stages (pkg/recovery.py). The port's device library seams
are on both backends, NVML and the mock (tpulib/binding.py).

A fault point is a cheap no-op until armed. Arming happens through the
API (tests: ``with inject("kube.request", mode="error"): ...``) or the
environment (chaos bench / e2e):

    TPU_DRA_FAULTS="kube.request:error:p=0.3:count=5;ckpt.fsync:crash:count=1"
    TPU_DRA_FAULTS_SEED=20260803

Modes:
  error    raise (the call site's default exception, usually the one its
           retry machinery classifies as retriable, else InjectedFault)
  crash    raise InjectedCrash -- a BaseException, so ``except
           Exception`` wire boundaries cannot swallow it; simulates
           process death at the seam for checkpoint-recovery tests
  exit     os._exit(86) (the SIGKILL analog; subprocess harnesses)
  latency  sleep ``latency`` seconds, then continue

Spec keys: ``p=<0..1>`` fire probability (seeded RNG -> deterministic
schedules), ``count=<n>`` max fires, ``after=<n>`` skip the first n
evaluations, ``latency=<s>``.

The registry is process-wide and keeps per-point evaluation/fire
counters (``snapshot()``) so the chaos bench can report what the
schedule actually did.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass

logger = logging.getLogger(__name__)

ENV_FAULTS = "TPU_DRA_FAULTS"
ENV_FAULTS_SEED = "TPU_DRA_FAULTS_SEED"

_MODES = ("error", "crash", "exit", "latency")


class InjectedFault(RuntimeError):
    """Default exception of an ``error``-mode fault point."""


class InjectedCrash(BaseException):
    """A ``crash``-mode firing. Deliberately NOT an Exception: the
    driver's wire boundaries catch Exception to keep serving, and a
    simulated process death must sail through them exactly like a
    SIGKILL would -- only the checkpoint/lease recovery machinery may
    observe the aftermath."""


@dataclass
class FaultSpec:
    """One armed fault point."""

    point: str
    mode: str = "error"
    probability: float = 1.0
    count: int | None = None  # max fires; None = unlimited
    after: int = 0  # skip the first N evaluations
    latency: float = 0.0
    message: str = ""

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}")

    @classmethod
    def parse(cls, token: str) -> "FaultSpec":
        """``point:mode[:k=v...]`` -- the TPU_DRA_FAULTS grammar."""
        parts = [p for p in token.strip().split(":") if p]
        if not parts:
            raise ValueError("empty fault spec")
        point = parts[0]
        mode = parts[1] if len(parts) > 1 else "error"
        spec = cls(point=point, mode=mode)
        for kv in parts[2:]:
            key, _, val = kv.partition("=")
            if key in ("p", "probability"):
                spec.probability = float(val)
            elif key == "count":
                spec.count = int(val)
            elif key == "after":
                spec.after = int(val)
            elif key == "latency":
                spec.latency = float(val)
            else:
                raise ValueError(f"unknown fault spec key {key!r}")
        return spec


class FaultRegistry:
    """Process-wide registry of armed fault points (seeded RNG)."""

    def __init__(self, seed: int | None = None):
        self._lock = threading.Lock()
        self._specs: dict[str, FaultSpec] = {}
        self._rng = random.Random(seed)
        self.evaluations: dict[str, int] = {}
        self.fires: dict[str, int] = {}

    @property
    def active(self) -> bool:
        return bool(self._specs)

    def reseed(self, seed: int | None) -> None:
        with self._lock:
            self._rng = random.Random(seed)

    def arm(self, spec: FaultSpec) -> None:
        with self._lock:
            self._specs[spec.point] = spec

    def disarm(self, point: str) -> None:
        with self._lock:
            self._specs.pop(point, None)

    def reset(self) -> None:
        with self._lock:
            self._specs.clear()
            self.evaluations.clear()
            self.fires.clear()

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "armed": sorted(self._specs),
                "evaluations": dict(self.evaluations),
                "fires": dict(self.fires),
            }

    def configure_from_env(self, env=os.environ) -> int:
        """Arm every spec in TPU_DRA_FAULTS; returns how many."""
        raw = env.get(ENV_FAULTS, "")
        seed = env.get(ENV_FAULTS_SEED)
        if seed:
            try:
                self.reseed(int(seed))
            except ValueError:
                logger.warning("bad %s=%r ignored", ENV_FAULTS_SEED, seed)
        n = 0
        for token in filter(None, (t.strip() for t in raw.split(";"))):
            try:
                self.arm(FaultSpec.parse(token))
                n += 1
            except ValueError:
                logger.warning("bad fault spec %r ignored", token)
        return n

    def fire(self, point: str, error=None) -> None:
        """Evaluate ``point``; raise/sleep per its armed spec (no-op when
        unarmed). ``error`` is the call site's exception factory
        (``error(message) -> BaseException``) for ``error`` mode."""
        with self._lock:
            spec = self._specs.get(point)
            if spec is None:
                return
            seen = self.evaluations.get(point, 0) + 1
            self.evaluations[point] = seen
            if seen <= spec.after:
                return
            if spec.count is not None and \
                    self.fires.get(point, 0) >= spec.count:
                return
            if spec.probability < 1.0 and \
                    self._rng.random() >= spec.probability:
                return
            self.fires[point] = self.fires.get(point, 0) + 1
            mode, latency = spec.mode, spec.latency
            message = spec.message or f"injected fault at {point}"
        if mode == "latency":
            time.sleep(latency)
            return
        logger.warning("fault injection: %s at %s", mode, point)
        if mode == "exit":
            os._exit(86)
        if mode == "crash":
            raise InjectedCrash(message)
        raise (error(message) if error is not None
               else InjectedFault(message))


# The process-wide registry. Env arming happens on first import so any
# entrypoint launched with TPU_DRA_FAULTS set participates.
_REGISTRY = FaultRegistry()
_REGISTRY.configure_from_env()


def registry() -> FaultRegistry:
    return _REGISTRY


def active() -> bool:
    return _REGISTRY.active


def fault_point(point: str, error=None) -> None:
    """The seam call compiled into external-interaction layers. Cheap
    when nothing is armed (one attribute read + bool check)."""
    if _REGISTRY.active:
        _REGISTRY.fire(point, error=error)


def arm(point: str, mode: str = "error", probability: float = 1.0,
        count: int | None = None, after: int = 0, latency: float = 0.0,
        message: str = "") -> FaultSpec:
    spec = FaultSpec(point=point, mode=mode, probability=probability,
                     count=count, after=after, latency=latency,
                     message=message)
    _REGISTRY.arm(spec)
    return spec


def disarm(point: str) -> None:
    _REGISTRY.disarm(point)


def reset() -> None:
    _REGISTRY.reset()


def reseed(seed: int | None) -> None:
    _REGISTRY.reseed(seed)


def snapshot() -> dict:
    return _REGISTRY.snapshot()


@contextmanager
def inject(point: str, mode: str = "error", probability: float = 1.0,
           count: int | None = None, after: int = 0, latency: float = 0.0,
           message: str = ""):
    """Test fixture: arm one point for the duration of the block."""
    arm(point, mode=mode, probability=probability, count=count,
        after=after, latency=latency, message=message)
    try:
        yield _REGISTRY
    finally:
        disarm(point)
