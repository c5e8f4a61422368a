"""A keyed, retrying work queue (the JAX package's ``pkg/workqueue.py``;
the upstream driver's ``pkg/workqueue/workqueue.go``).

``enqueue(key, fn)`` runs ``fn(key)`` on a worker thread. A key queued
twice runs once, with the later ``fn``; a key enqueued while its callback
runs is run again after it (the k8s workqueue's "dirty" rule, so an event
that races a reconcile is not lost). A callback that raises is retried
after the limiter's per-key backoff (within ``retry_timeout`` where the
limiter sets one); a ``PermanentError`` is not retried. A limiter with
``global_rps`` holds every worker to one token bucket.

Beyond the one worker of the ComputeDomain controller:

- **Shards** (``workers``, ``shard_of``): every key maps to a shard and
  every shard to one worker (``worker_of``: ``stable_shard_hash(shard)
  % workers``, an int shard taken modulo directly), so keys of one shard
  run in order and disjoint shards in parallel.
- **Batch takes** (``take_ready``/``finish``): a running callback may
  claim more due keys of its worker's heap and report each one's outcome.
- **Hot keys**: a key re-dirtied ``HOT_THRESHOLD`` times in a row is
  re-run after an escalating delay (``HOT_BASE_DELAY`` doubling, at most
  the limiter's ``max_delay``), so it cannot starve the other keys of its
  worker; the streak ends when the key retires clean.
- **Work stealing** (``steal``, ``may_steal``): an idle worker that
  ``may_steal`` takes about half of the ready keys ``steal`` admits from
  the deepest sibling heap. A key lives in one heap and a running key is
  never started again, so stealing moves keys, never runs one twice at
  once.
- **Metrics**: a sink with ``set_depth``, ``observe_wait``,
  ``inc_retry``, ``inc_drop``, ``inc_hot_backoff`` and ``inc_steal``
  (``pkg/metrics.WorkQueueMetrics``).

``time_fn`` is the queue's clock (``time.monotonic``): every delay, due
time and wait is read from it.
"""

from __future__ import annotations

import heapq
import logging
import random
import threading
import time
import zlib
from dataclasses import dataclass, field
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
    """Per-key exponential backoff, with jitter as a fraction of it, an
    optional global token bucket (``global_rps``, ``global_burst``) and
    an optional budget of seconds for one key's retries."""

    base_delay: float = 0.25
    max_delay: float = 3.0
    jitter: float = 0.0
    global_rps: float | None = None
    global_burst: int = 1
    retry_timeout: float | None = None

    def delay_for(self, failures: int) -> float:
        exp = min(max(failures - 1, 0), 62)
        d = min(self.base_delay * (2 ** exp), self.max_delay)
        if self.jitter:
            d += d * self.jitter * random.random()
        return d


# The upstream's limiter presets (workqueue.go:40-58).
PREP_UNPREP_LIMITER = RateLimiter(
    base_delay=0.25, max_delay=3.0, global_rps=5.0, global_burst=10,
    retry_timeout=45.0)
DOMAIN_DAEMON_LIMITER = RateLimiter(base_delay=0.005, max_delay=6.0,
                                    jitter=0.5)
CONTROLLER_DEFAULT_LIMITER = RateLimiter(base_delay=0.005, max_delay=1.0)


def stable_shard_hash(value: Any) -> int:
    """A hash of ``value`` that every process agrees on (``hash()`` is
    salted per process): an int's absolute value, else the CRC-32 of its
    repr."""
    if isinstance(value, int):
        return abs(value)
    return zlib.crc32(repr(value).encode("utf-8", "replace"))


@dataclass(order=True)
class _Scheduled:
    when: float
    seq: int
    key: Any = field(compare=False)
    # When the key was queued, for the wait histogram (any retry or hot
    # backoff included).
    born: float = field(compare=False, default=0.0)


class WorkQueue:
    # Re-dirties in a row a key may run at once before the escalation.
    HOT_THRESHOLD = 3
    HOT_BASE_DELAY = 0.02

    def __init__(self, limiter: RateLimiter = CONTROLLER_DEFAULT_LIMITER,
                 name: str = "workqueue", workers: int = 1,
                 on_drop: Callable[[Any, BaseException], None] | None = None,
                 shard_of: Callable[[Any], Any] | None = None,
                 metrics=None,
                 steal: Callable[[Any], bool] | None = None,
                 may_steal: Callable[[int], bool] | None = None,
                 time_fn: Callable[[], float] = time.monotonic):
        self._limiter = limiter
        self._name = name
        self._on_drop = on_drop
        self._shard_of = shard_of
        self._metrics = metrics
        self._steal = steal
        self._may_steal = may_steal
        self._time = time_fn
        self._idle: set[int] = set()
        self.workers = max(workers, 1)
        self._heaps: list[list[_Scheduled]] = [
            [] for _ in range(self.workers)]
        self._failures: dict[Any, int] = {}
        self._first_failure: dict[Any, float] = {}
        self._pending: set[Any] = set()  # queued or running
        self._running: set[Any] = set()
        # The latest callback of each pending key; the heaps hold keys.
        self._fn: dict[Any, Callable[[Any], None]] = {}
        self._dirty: set[Any] = set()
        self._hot: dict[Any, int] = {}
        # One lock; a condition a worker on it, so a push wakes only the
        # worker that owns the key.
        base = threading.RLock()
        self._cv = threading.Condition(base)
        self._worker_cv = [threading.Condition(base)
                           for _ in range(self.workers)]
        self._size = 0
        self._seq = 0
        self._shutdown = False
        self._tokens = float(limiter.global_burst)
        self._last_refill = self._time()
        self._tls = threading.local()
        self._threads = [
            threading.Thread(target=self._run, args=(i,),
                             name=name if self.workers == 1
                             else f"{name}-{i}", daemon=True)
            for i in range(self.workers)]
        self._thread = self._threads[0]
        for t in self._threads:
            t.start()

    # -- public ------------------------------------------------------------

    def worker_of(self, key: Any) -> int:
        """The worker that owns ``key``'s shard."""
        if self.workers == 1:
            return 0
        shard = self._shard_of(key) if self._shard_of is not None else key
        return stable_shard_hash(shard) % self.workers

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

    def forget(self, key: Any) -> None:
        """Reset ``key``'s failure count."""
        with self._cv:
            self._failures.pop(key, None)
            self._first_failure.pop(key, None)

    def len(self) -> int:
        """The queued keys, read without the lock."""
        return self._size

    def current_wait(self) -> float | None:
        """How long the calling worker's current key waited from its
        enqueue to its start (backoffs included); None outside a
        callback. Keys taken in a batch share their primary's."""
        return getattr(self._tls, "wait", None)

    def depth(self, worker: int) -> int:
        with self._cv:
            return len(self._heaps[worker])

    def take_ready(self, pred: Callable[[Any], bool],
                   limit: int) -> list[Any]:
        """Claim up to ``limit`` more due keys of the calling worker's
        heap that ``pred`` admits, marked running; only from inside a
        callback, and the caller reports each with ``finish``. Taken
        keys spend no token of the global bucket."""
        idx = getattr(self._tls, "worker", None)
        if idx is None or limit <= 0:
            return []
        taken: list[Any] = []
        now = self._time()
        with self._cv:
            heap = self._heaps[idx]
            keep: list[_Scheduled] = []
            for item in heap:
                if (len(taken) < limit and item.when <= now
                        and item.key not in self._running
                        and pred(item.key)):
                    taken.append(item.key)
                    self._running.add(item.key)
                    if self._metrics is not None:
                        self._metrics.observe_wait(now - item.born)
                else:
                    keep.append(item)
            if taken:
                heap[:] = keep  # in place: the worker holds this list
                heapq.heapify(heap)
                self._size -= len(taken)
                self._observe_depth_locked(idx)
        return taken

    def finish(self, key: Any, error: BaseException | None = None) -> None:
        """The outcome of a key claimed by ``take_ready``."""
        self._after_run(key, error)

    def shutdown(self, wait: bool = True) -> None:
        with self._cv:
            self._shutdown = True
            for cv in self._worker_cv:
                cv.notify_all()
            self._cv.notify_all()
        if wait:
            for t in self._threads:
                t.join(timeout=5.0)

    def wait_idle(self, timeout: float = 10.0) -> bool:
        """Whether nothing is queued or running within ``timeout``
        seconds of the wall clock."""
        with self._cv:
            return self._cv.wait_for(
                lambda: not self._pending and not any(self._heaps),
                timeout)

    # -- internals ---------------------------------------------------------

    def _push(self, key: Any, delay: float) -> None:
        self._seq += 1
        idx = self.worker_of(key)
        now = self._time()
        heapq.heappush(self._heaps[idx],
                       _Scheduled(now + delay, self._seq, key, born=now))
        self._size += 1
        self._observe_depth_locked(idx)
        self._worker_cv[idx].notify()
        if self._steal is not None and delay <= 0:
            # One idle sibling may steal while the owner is busy.
            self._wake_thief_locked(idx)

    def _wake_thief_locked(self, idx: int) -> None:
        for j in self._idle:
            if j != idx and (self._may_steal is None or self._may_steal(j)):
                self._worker_cv[j].notify()
                break

    def _observe_depth_locked(self, idx: int) -> None:
        if self._metrics is not None:
            self._metrics.set_depth(str(idx), len(self._heaps[idx]))

    def _take_token(self) -> float:
        """The global bucket: 0 if a token was free, else the seconds
        until one is."""
        if self._limiter.global_rps is None:
            return 0.0
        now = self._time()
        self._tokens = min(
            self._limiter.global_burst,
            self._tokens + (now - self._last_refill)
            * self._limiter.global_rps)
        self._last_refill = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return 0.0
        return (1.0 - self._tokens) / self._limiter.global_rps

    def _hot_delay_locked(self, key: Any) -> float:
        streak = self._hot.get(key, 0) + 1
        self._hot[key] = streak
        if streak <= self.HOT_THRESHOLD:
            return 0.0
        delay = min(
            self.HOT_BASE_DELAY * (2 ** min(streak - self.HOT_THRESHOLD - 1,
                                            30)),
            self._limiter.max_delay)
        if self._metrics is not None:
            self._metrics.inc_hot_backoff()
        return delay

    def _steal_into_locked(self, idx: int) -> bool:
        """Idle worker ``idx`` takes about half of the due, not running
        keys ``steal`` admits from the deepest sibling heap; whether it
        took any."""
        now = self._time()
        best_idx, best_ready = -1, []
        for j, heap in enumerate(self._heaps):
            if j == idx:
                continue
            ready = [item for item in heap
                     if item.when <= now and item.key not in self._running
                     and self._steal(item.key)]
            if len(ready) > len(best_ready):
                best_idx, best_ready = j, ready
        if best_idx < 0 or not best_ready:
            return False
        take = best_ready[-max(1, len(best_ready) // 2):]
        taken = {item.seq for item in take}
        src = self._heaps[best_idx]
        src[:] = [item for item in src if item.seq not in taken]
        heapq.heapify(src)
        for item in take:
            heapq.heappush(self._heaps[idx], item)
        self._observe_depth_locked(best_idx)
        self._observe_depth_locked(idx)
        if self._metrics is not None:
            self._metrics.inc_steal(len(take))
        if len(best_ready) - len(take) > 1:
            # Still backlogged: another idle sibling joins.
            self._wake_thief_locked(idx)
        return True

    def _run(self, idx: int) -> None:
        self._tls.worker = idx
        heap = self._heaps[idx]
        wcv = self._worker_cv[idx]
        while True:
            with self._cv:
                while not self._shutdown and (
                        not heap or heap[0].when > self._time()):
                    if self._steal is not None and (
                            self._may_steal is None
                            or self._may_steal(idx)) and \
                            self._steal_into_locked(idx):
                        continue
                    timeout = None
                    if heap:
                        timeout = max(heap[0].when - self._time(), 0)
                    self._idle.add(idx)
                    try:
                        wcv.wait(timeout=timeout)
                    finally:
                        self._idle.discard(idx)
                if self._shutdown:
                    return
                wait = self._take_token()
                if wait > 0:
                    item = heapq.heappop(heap)
                    item.when = self._time() + wait
                    heapq.heappush(heap, item)
                    continue
                item = heapq.heappop(heap)
                self._size -= 1
                self._running.add(item.key)
                fn = self._fn.get(item.key)
                self._observe_depth_locked(idx)
                self._tls.wait = self._time() - item.born
                if self._metrics is not None:
                    self._metrics.observe_wait(self._tls.wait)
            err: BaseException | None = None
            try:
                if fn is not None:
                    fn(item.key)
            except BaseException as e:  # noqa: BLE001 - the retry boundary
                err = e
            finally:
                self._tls.wait = None
            self._after_run(item.key, err)

    def _after_run(self, key: Any, err: BaseException | None) -> None:
        if err is None:
            with self._cv:
                self._failures.pop(key, None)
                self._first_failure.pop(key, None)
                self._running.discard(key)
                self._retire_or_requeue_locked(key)
            return
        if isinstance(err, PermanentError):
            self._drop(key, err)
            return
        now = self._time()
        with self._cv:
            first = self._first_failure.setdefault(key, now)
            exhausted = (self._limiter.retry_timeout is not None
                         and now - first >= self._limiter.retry_timeout)
            if not exhausted:
                n = self._failures.get(key, 0) + 1
                self._failures[key] = n
                self._running.discard(key)
                # The retry looks its callback up when it runs, so a
                # fresh ``fn`` enqueued meanwhile is the one it calls.
                self._dirty.discard(key)
                self._push(key, self._limiter.delay_for(n))
                if self._metrics is not None:
                    self._metrics.inc_retry()
        if exhausted:
            logger.warning("%s: retry budget (%.1fs) exhausted for %r",
                           self._name, self._limiter.retry_timeout, key)
            self._drop(key, err)
        else:
            logger.warning("%s: %r failed (attempt %d), retrying: %s",
                           self._name, key, n, err)

    def _retire_or_requeue_locked(self, key: Any) -> None:
        """Re-push a dirty key (after its hot delay), else retire it."""
        if key in self._dirty and not self._shutdown:
            self._dirty.discard(key)
            self._push(key, self._hot_delay_locked(key))
        else:
            self._dirty.discard(key)
            self._hot.pop(key, None)
            self._pending.discard(key)
            self._fn.pop(key, None)
            self._cv.notify_all()

    def _drop(self, key: Any, err: BaseException) -> None:
        with self._cv:
            self._failures.pop(key, None)
            self._first_failure.pop(key, None)
            self._running.discard(key)
            self._retire_or_requeue_locked(key)
            if self._metrics is not None:
                self._metrics.inc_drop()
        if self._on_drop:
            self._on_drop(key, err)
        else:
            logger.error("%s: dropping %r: %s", self._name, key, err)
