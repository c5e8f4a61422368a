"""A keyed, retrying work queue (the part of the JAX package's
``pkg/workqueue.py`` that the ComputeDomain stack uses; the upstream
driver's ``pkg/workqueue/workqueue.go``).

``enqueue(key, fn)`` runs ``fn(key)`` on the queue's one worker thread.
A key queued twice runs once, with the later ``fn``; a key enqueued
while its callback runs is run again after it (the k8s workqueue's
"dirty" rule, so an event that races a reconcile is not lost). A
callback that raises is retried after the limiter's per-key backoff; a
``PermanentError`` is not retried.

Not ported: the JAX queue's shards and work stealing, its batch takes,
its hot-key escalation, its global token bucket and its metrics.
"""

from __future__ import annotations

import heapq
import logging
import random
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable

logger = logging.getLogger(__name__)


class PermanentError(Exception):
    """An error that retrying cannot cure (upstream CD plugin
    ``permanentError``, driver.go:56-60)."""

    def __init__(self, cause: BaseException | str):
        super().__init__(str(cause))
        self.cause = cause if isinstance(cause, BaseException) else None


@dataclass(frozen=True)
class RateLimiter:
    """Per-key exponential backoff, with jitter as a fraction of it."""

    base_delay: float = 0.25
    max_delay: float = 3.0
    jitter: float = 0.0

    def delay_for(self, failures: int) -> float:
        exp = min(max(failures - 1, 0), 62)
        d = min(self.base_delay * (2 ** exp), self.max_delay)
        if self.jitter:
            d += d * self.jitter * random.random()
        return d


# The upstream's controller default (workqueue.go:40-58).
CONTROLLER_DEFAULT_LIMITER = RateLimiter(base_delay=0.005, max_delay=1.0)


class WorkQueue:
    def __init__(self, limiter: RateLimiter = CONTROLLER_DEFAULT_LIMITER,
                 name: str = "workqueue"):
        self._limiter = limiter
        self._name = name
        self._cv = threading.Condition()
        self._heap: list[tuple[float, int, Any]] = []
        self._seq = 0
        self._fn: dict[Any, Callable[[Any], None]] = {}
        self._pending: set[Any] = set()  # queued or running
        self._running: set[Any] = set()
        self._dirty: set[Any] = set()
        self._failures: dict[Any, int] = {}
        self._shutdown = False
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def enqueue(self, key: Any, fn: Callable[[Any], None]) -> None:
        with self._cv:
            if self._shutdown:
                return
            self._fn[key] = fn
            if key in self._running:
                self._dirty.add(key)
            elif key not in self._pending:
                self._pending.add(key)
                self._push(key, 0.0)

    def shutdown(self, wait: bool = True) -> None:
        with self._cv:
            self._shutdown = True
            self._cv.notify_all()
        if wait:
            self._thread.join(timeout=5.0)

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Whether nothing is queued or running within ``timeout``."""
        with self._cv:
            return self._cv.wait_for(lambda: not self._pending, timeout)

    def _push(self, key: Any, delay: float) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (time.monotonic() + delay, self._seq,
                                    key))
        self._cv.notify_all()

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._shutdown and (
                        not self._heap
                        or self._heap[0][0] > time.monotonic()):
                    self._cv.wait(None if not self._heap else
                                  max(self._heap[0][0] - time.monotonic(), 0))
                if self._shutdown:
                    return
                _, _, key = heapq.heappop(self._heap)
                self._running.add(key)
                fn = self._fn.get(key)
            err: BaseException | None = None
            try:
                if fn is not None:
                    fn(key)
            except Exception as e:  # noqa: BLE001 - the retry boundary
                err = e
            self._after_run(key, err)

    def _after_run(self, key: Any, err: BaseException | None) -> None:
        with self._cv:
            self._running.discard(key)
            if err is not None and not isinstance(err, PermanentError):
                n = self._failures.get(key, 0) + 1
                self._failures[key] = n
                self._dirty.discard(key)
                self._push(key, self._limiter.delay_for(n))
                logger.warning("%s: %r failed (attempt %d), retrying: %s",
                               self._name, key, n, err)
                return
            if err is not None:
                logger.error("%s: dropping %r: %s", self._name, key, err)
            self._failures.pop(key, None)
            if key in self._dirty and not self._shutdown:
                self._dirty.discard(key)
                self._push(key, 0.0)
            else:
                self._dirty.discard(key)
                self._pending.discard(key)
                self._fn.pop(key, None)
                self._cv.notify_all()
