"""Retrying kube client: jittered backoff, deadlines, a circuit breaker
(the JAX package's ``pkg/retry.py``; client-go's rest client retries on
429/5xx and the upstream driver's workqueue rate limiters).

- **Per-call deadline.** Every verb gets ``policy.deadline_s`` of total
  budget; each attempt carries a per-attempt server timeout
  (``policy.attempt_timeout_s``), so one dead TCP peer cannot eat the
  whole budget.
- **Retriable classification.** 429 and 5xx statuses and connection
  resets, refusals and timeouts (the ``OSError`` family, ``URLError``
  included) retry with jittered exponential backoff. 404 is a result,
  not a failure. 409 Conflict is ``conflict``: surfaced at once, since
  replaying the same stale write cannot succeed and the caller owns the
  fetch-modify-update loop (``policy.retry_conflicts=True`` retries it).
- **Circuit breaker.** ``threshold`` consecutive failures open the
  circuit for ``reset_s``: calls fail fast with ``CircuitOpenError`` (a
  retriable 503 for outer loops) instead of piling timed-out sockets
  onto a down API server. One half-open probe closes it again.

Counters (``tpu_dra_retry_total`` by verb, ``tpu_dra_circuit_open_total``)
export through ``pkg.metrics.ResilienceMetrics`` when one is wired; the
integer counters on the wrapper are always kept.

The fault point ``kube.request`` (``pkg/faults.py``) fires once an
attempt, before the call: ``error`` is a retriable 503. ``classify``
never absorbs an ``InjectedCrash`` (simulated process death) and retries
an ``InjectedFault``.
"""

from __future__ import annotations

import logging
import os
import random
import threading
import time
from dataclasses import dataclass

from . import faults
from .kubeclient import ConflictError, KubeError, NotFoundError

logger = logging.getLogger(__name__)

RETRIABLE_STATUSES = frozenset({429, 500, 502, 503, 504})


@dataclass(frozen=True)
class RetryPolicy:
    """Backoff/deadline knobs (env-tunable, see ``from_env``)."""

    base_delay: float = 0.1
    max_delay: float = 2.0
    jitter: float = 0.2  # fraction of the delay added uniformly at random
    deadline_s: float = 30.0  # total per-call budget
    attempt_timeout_s: float = 10.0  # per-attempt server timeout
    retry_conflicts: bool = False  # 409: caller-owned refetch by default

    @classmethod
    def from_env(cls, env=os.environ) -> "RetryPolicy":
        def f(name: str, default: float) -> float:
            try:
                return float(env.get(name, default))
            except ValueError:
                return default

        return cls(
            base_delay=f("TPU_DRA_KUBE_RETRY_BASE_S", cls.base_delay),
            max_delay=f("TPU_DRA_KUBE_RETRY_MAX_S", cls.max_delay),
            jitter=f("TPU_DRA_KUBE_RETRY_JITTER", cls.jitter),
            deadline_s=f("TPU_DRA_KUBE_DEADLINE_S", cls.deadline_s),
            attempt_timeout_s=f("TPU_DRA_KUBE_ATTEMPT_TIMEOUT_S",
                                cls.attempt_timeout_s),
        )

    def delay_for(self, attempt: int, rng: random.Random) -> float:
        exp = min(max(attempt - 1, 0), 32)
        d = min(self.base_delay * (2 ** exp), self.max_delay)
        if self.jitter:
            d += d * self.jitter * rng.random()
        return d


def classify(exc: BaseException, policy: RetryPolicy) -> str:
    """``retriable`` | ``conflict`` | ``permanent``."""
    if isinstance(exc, faults.InjectedCrash):
        return "permanent"  # simulated process death, never absorbed
    if isinstance(exc, NotFoundError):
        return "permanent"
    if isinstance(exc, ConflictError):
        return "retriable" if policy.retry_conflicts else "conflict"
    if isinstance(exc, KubeError):
        return ("retriable" if exc.status in RETRIABLE_STATUSES
                else "permanent")
    if isinstance(exc, faults.InjectedFault):
        return "retriable"
    # URLError / ConnectionResetError / socket timeouts are OSError
    # subclasses; TimeoutError covers socket.timeout on 3.10+.
    if isinstance(exc, (OSError, TimeoutError)):
        return "retriable"
    return "permanent"


class CircuitOpenError(KubeError):
    """Fail-fast while the breaker is open. A 503 so outer retry loops
    (kubelet, workqueues) treat it as the transient condition it is."""

    def __init__(self, message: str = "kube circuit breaker open"):
        super().__init__(503, message)


class CircuitBreaker:
    """Consecutive-failure breaker with a half-open probe."""

    def __init__(self, threshold: int = 5, reset_s: float = 15.0,
                 clock=time.monotonic):
        self.threshold = threshold
        self.reset_s = reset_s
        self._clock = clock
        self._lock = threading.Lock()
        self._failures = 0
        self._opened_at: float | None = None
        self._probing = False
        self.trips = 0  # lifetime open transitions

    @property
    def open(self) -> bool:
        with self._lock:
            return self._opened_at is not None

    def allow(self) -> bool:
        """True when a call may proceed (closed, or the one half-open
        probe after the reset window)."""
        with self._lock:
            if self._opened_at is None:
                return True
            if self._clock() - self._opened_at < self.reset_s:
                return False
            if self._probing:
                return False  # someone else holds the probe slot
            self._probing = True
            return True

    def record_success(self) -> None:
        with self._lock:
            self._failures = 0
            self._opened_at = None
            self._probing = False

    def record_failure(self) -> bool:
        """Returns True when THIS failure tripped the breaker open."""
        with self._lock:
            self._failures += 1
            if self._probing:
                # Failed half-open probe: re-open the window.
                self._opened_at = self._clock()
                self._probing = False
                return False
            if self._opened_at is None and self._failures >= self.threshold:
                self._opened_at = self._clock()
                self.trips += 1
                return True
            return False


class RetryingKubeClient:
    """Wraps any object with the KubeClient surface (real or fake).

    Non-verb attributes (watch, add_resource_watcher, objects, ...)
    delegate to the inner client untouched: the watch has its own
    reconnect and resume in KubeClient.watch. The JAX wrapper's
    ``read_raw`` has no counterpart in the port's clients.
    """

    def __init__(self, kube, policy: RetryPolicy | None = None,
                 breaker: CircuitBreaker | None = None,
                 metrics=None, seed: int | None = None,
                 sleep=time.sleep, clock=time.monotonic):
        self.kube = kube
        self.policy = policy or RetryPolicy.from_env()
        self.breaker = breaker or CircuitBreaker()
        self.metrics = metrics  # pkg.metrics.ResilienceMetrics | None
        self._rng = random.Random(seed)
        self._sleep = sleep
        self._clock = clock
        # Always-on integer counters.
        self.retry_count = 0
        self.retries_by_verb: dict[str, int] = {}

    def __getattr__(self, name):
        # Only reached for names not defined on the wrapper: delegate
        # watch/add_watcher/objects/... to the inner client.
        return getattr(self.kube, name)

    # -- wrapped verbs --------------------------------------------------------

    def get(self, *a, **kw):
        return self._call("get", a, kw)

    def list(self, *a, **kw):
        return self._call("list", a, kw)

    def create(self, *a, **kw):
        return self._call("create", a, kw)

    def update(self, *a, **kw):
        return self._call("update", a, kw)

    def patch(self, *a, **kw):
        return self._call("patch", a, kw)

    def delete(self, *a, **kw):
        return self._call("delete", a, kw)

    def server_version(self, *a, **kw):
        return self._call("server_version", a, kw)

    # -- engine ---------------------------------------------------------------

    def _record_retry(self, verb: str) -> None:
        self.retry_count += 1
        self.retries_by_verb[verb] = self.retries_by_verb.get(verb, 0) + 1
        if self.metrics is not None:
            self.metrics.retries.labels(verb).inc()

    def _call(self, verb: str, args: tuple, kwargs: dict):
        fn = getattr(self.kube, verb)
        kwargs = dict(kwargs)
        kwargs.setdefault("timeout", self.policy.attempt_timeout_s)
        deadline = self._clock() + self.policy.deadline_s
        attempt = 0
        while True:
            if not self.breaker.allow():
                raise CircuitOpenError(
                    f"circuit open; refusing kube {verb} for up to "
                    f"{self.breaker.reset_s}s")
            attempt += 1
            try:
                # One seam for every client type, once an attempt, so a
                # retry schedule sees independent trials.
                faults.fault_point("kube.request",
                                   error=lambda m: KubeError(503, m))
                result = fn(*args, **kwargs)
            except BaseException as e:
                kind = classify(e, self.policy)
                if kind != "retriable":
                    # A 404/409/422-class outcome means the apiserver
                    # ANSWERED: close the circuit (this also releases a
                    # half-open probe slot) before surfacing the result.
                    # Any OTHER permanent exception (malformed response
                    # body, a client bug) must still
                    # release the probe slot or the breaker wedges open
                    # forever -- it counts as a failure, not a success.
                    if isinstance(e, KubeError):
                        self.breaker.record_success()
                    elif self.breaker.record_failure():
                        logger.warning(
                            "kube circuit breaker OPEN after %d "
                            "consecutive failures (last: %s)",
                            self.breaker.threshold, e)
                        if self.metrics is not None:
                            self.metrics.circuit_open.inc()
                    raise
                tripped = self.breaker.record_failure()
                if tripped:
                    logger.warning(
                        "kube circuit breaker OPEN after %d consecutive "
                        "failures (last: %s)", self.breaker.threshold, e)
                    if self.metrics is not None:
                        self.metrics.circuit_open.inc()
                delay = self.policy.delay_for(attempt, self._rng)
                if self._clock() + delay >= deadline:
                    logger.warning(
                        "kube %s: retry budget (%.1fs) exhausted after "
                        "%d attempt(s): %s",
                        verb, self.policy.deadline_s, attempt, e)
                    raise
                self._record_retry(verb)
                logger.info("kube %s failed (attempt %d), retrying in "
                            "%.2fs: %s", verb, attempt, delay, e)
                self._sleep(delay)
            else:
                self.breaker.record_success()
                return result
