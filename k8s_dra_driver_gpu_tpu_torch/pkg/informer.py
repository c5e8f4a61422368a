"""A list-and-watch cache of one resource (the JAX package's
``pkg/informer.py``; the client-go informer's shape).

``start()`` lists the resource, then follows it:

- over ``KubeClient``, a streamed watch from the list's resourceVersion
  (so nothing written after the list is missed), a relist when the watch
  reports a gap (410 Gone: the events in between are lost) after which
  the watch resumes from the relist's resourceVersion, and a periodic
  relist every ``resync_period`` seconds;
- over ``FakeKubeClient``, its resource watcher hook, called after each
  write.

Every changed object fires the event hooks (``add_event_hook``) with its
type: watch events as they come, a relist's differences as ADDED,
MODIFIED or DELETED; the change hooks (``add_change_hook``) fire once
after any change, with no payload. ``wait_for_sync`` waits for the first
list; ``get``, ``list`` and ``get_by_uid`` (a uid index) read the cache.
``stop()`` ends the watch and the resync and joins their threads.

Relists coalesce: while one runs, any number of further requests fold
into one trailing relist; ``relist_total`` counts the full lists and
``on_relist`` hears of each. Given a ``RelistCoordinator``, shared by a
set of informers, every relist queues through its gate: at most
``TPU_DRA_SCHED_RELIST_CONCURRENCY`` (2) at once, the allocation-critical
resources first (``RELIST_PRIORITY``), and a resource that relists again
within ``TPU_DRA_SCHED_RELIST_QUIET_S`` (60 s) of its last waits a
jittered backoff from ``TPU_DRA_SCHED_RELIST_BASE_S`` (0.5 s) doubling
up to ``TPU_DRA_SCHED_RELIST_MAX_S`` (30 s), reported to ``on_backoff``.

``event_gate(ev_type, obj)``, when set, decides each watch event: True
applies it, False parks it until ``flush_deferred()``.
"""

from __future__ import annotations

import heapq
import json
import logging
import os
import random
import threading
import time
from typing import Callable

logger = logging.getLogger(__name__)

# Relist order (lower first): the inventory and the held allocations
# before anything is worth scheduling against; pods, DaemonSets and Jobs
# are derived work that bears a stale cache longest. Unlisted resources
# come last.
RELIST_PRIORITY: dict[str, int] = {
    "resourceslices": 0,
    "resourceclaims": 1,
    "deviceclasses": 2,
    "resourceclaimtemplates": 2,
    "computedomains": 2,
    "partitionsets": 2,
    "nodes": 3,
    "pods": 4,
    "daemonsets": 5,
    "jobs": 5,
}


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


class RelistCoordinator:
    """The gate every relist of a set of informers passes: a cap on the
    relists in flight, the waiters admitted by ``RELIST_PRIORITY`` (then
    in arrival order), and a per-resource backoff: a resource relisted
    again within ``quiet_period`` of its last relist waits
    ``base_delay * 2**(streak-1)`` (at most ``max_delay``) times a
    jitter in [0.5, 1), reported to ``on_backoff(resource, seconds)``.
    A quiet resource's first relist waits nothing. ``time_fn``,
    ``sleep_fn`` and ``rng`` are the clock, the wait and the jitter."""

    def __init__(self, concurrency: int | None = None,
                 base_delay: float | None = None,
                 max_delay: float | None = None,
                 quiet_period: float | None = None,
                 on_backoff: Callable[[str, float], None] | None = None,
                 rng: random.Random | None = None,
                 time_fn: Callable[[], float] = time.monotonic,
                 sleep_fn: Callable[[float], None] = time.sleep):
        if concurrency is None:
            concurrency = int(_env_float(
                "TPU_DRA_SCHED_RELIST_CONCURRENCY", 2))
        self.concurrency = max(1, concurrency)
        self.base_delay = (base_delay if base_delay is not None else
                           _env_float("TPU_DRA_SCHED_RELIST_BASE_S", 0.5))
        self.max_delay = (max_delay if max_delay is not None else
                          _env_float("TPU_DRA_SCHED_RELIST_MAX_S", 30.0))
        self.quiet_period = (quiet_period if quiet_period is not None else
                             _env_float("TPU_DRA_SCHED_RELIST_QUIET_S",
                                        60.0))
        self._on_backoff = on_backoff
        self._rng = rng if rng is not None else random.Random()
        self._time = time_fn
        self._sleep = sleep_fn
        self._cv = threading.Condition()
        self._active = 0
        self._seq = 0
        self._waiting: list[tuple[int, int, object]] = []
        self._streak: dict[str, int] = {}
        self._last: dict[str, float] = {}

    def backoff_for(self, resource: str) -> float:
        """Advance the resource's streak; the delay before its relist
        (0 for a quiet resource)."""
        with self._cv:
            now = self._time()
            last = self._last.get(resource)
            if last is not None and now - last < self.quiet_period:
                self._streak[resource] = self._streak.get(resource, 0) + 1
            else:
                self._streak[resource] = 0
            n = self._streak[resource]
            if n <= 0:
                return 0.0
            delay = min(self.base_delay * (2 ** (n - 1)), self.max_delay)
            return delay * (0.5 + self._rng.random() * 0.5)

    def run(self, resource: str, fn: Callable[[], object]):
        """Wait out the resource's backoff, then run ``fn`` inside the
        gate; ``fn``'s result."""
        delay = self.backoff_for(resource)
        if delay > 0:
            if self._on_backoff is not None:
                try:
                    self._on_backoff(resource, delay)
                except Exception:  # noqa: BLE001 - a metrics hook
                    logger.exception("relist backoff hook failed")
            self._sleep(delay)
        pri = RELIST_PRIORITY.get(resource, 9)
        token = object()
        with self._cv:
            self._seq += 1
            heapq.heappush(self._waiting, (pri, self._seq, token))
            while self._active >= self.concurrency or \
                    self._waiting[0][2] is not token:
                self._cv.wait(timeout=5.0)
            heapq.heappop(self._waiting)
            self._active += 1
            # The next head may run now, beside this one.
            self._cv.notify_all()
        try:
            return fn()
        finally:
            with self._cv:
                self._active -= 1
                self._last[resource] = self._time()
                self._cv.notify_all()


class Informer:
    def __init__(self, kube, group: str, version: str, resource: str,
                 namespace: str | None = None,
                 resync_period: float = 30.0,
                 reconnect_delay: float = 1.0,
                 on_relist: Callable[[], None] | None = None,
                 coordinator: RelistCoordinator | None = None):
        self.kube = kube
        self.group = group
        self.version = version
        self.resource = resource
        self.namespace = namespace
        self.resync_period = resync_period
        self.reconnect_delay = reconnect_delay
        self._lock = threading.Lock()
        # Serializes a relist against watch events (re-entrant: a hook
        # may write the resource it follows through the in-memory fake).
        self._apply_lock = threading.RLock()
        self._cache: dict[tuple[str, str], dict] = {}  # (ns, name) -> obj
        self._by_uid: dict[str, tuple[str, str]] = {}
        self._hooks: list[Callable[[], None]] = []
        self._event_hooks: list[Callable[[str, dict], None]] = []
        self._stop = threading.Event()
        self._synced = threading.Event()
        self._started = False
        self._watch = None
        self._resync: threading.Thread | None = None
        self._fake_hook = None
        self.relist_total = 0
        self._on_relist = on_relist
        self._coordinator = coordinator
        # While one relist runs, further requests only mark it pending:
        # one trailing relist covers the burst.
        self._relist_lock = threading.Lock()
        self._relist_active = False
        self._relist_pending = False
        self.event_gate: Callable[[str, dict], bool] | None = None
        self._deferred: list[tuple[str, dict]] = []

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Informer":
        if self._started:
            return self
        self._started = True
        if hasattr(self.kube, "add_resource_watcher"):  # FakeKubeClient
            self._fake_hook = self._on_fake_event
            self.kube.add_resource_watcher(self._fake_hook)
            self._relist_logged()
            return self
        version = self._relist_logged()
        self._watch = self.kube.watch(
            self.group, self.version, self.resource, self._on_watch_event,
            namespace=self.namespace, stop=self._stop,
            reconnect_delay=self.reconnect_delay,
            on_gap=self._relist_on_gap, resource_version=version or "")
        self._resync = threading.Thread(
            target=self._resync_loop, name=f"informer-resync-{self.resource}",
            daemon=True)
        self._resync.start()
        return self

    def stop(self) -> None:
        """End the watch and the resync; join their threads."""
        self._stop.set()
        if self._fake_hook is not None:
            self.kube.remove_resource_watcher(self._fake_hook)
            self._fake_hook = None
        if self._watch is not None:
            self._watch.stop()
        if self._resync is not None:
            self._resync.join(timeout=5.0)

    def wait_for_sync(self, timeout: float = 10.0) -> bool:
        return self._synced.wait(timeout)

    # -- events ------------------------------------------------------------

    def add_change_hook(self, fn: Callable[[], None]) -> None:
        """``fn()`` after any change of the cache (no payload: the
        consumer reads the cache)."""
        self._hooks.append(fn)

    def add_event_hook(self, fn: Callable[[str, dict], None]) -> None:
        """``fn(event_type, object)`` once for each changed object."""
        self._event_hooks.append(fn)

    def _fire(self, events: list[tuple[str, dict]]) -> None:
        for fn in list(self._event_hooks):
            for ev_type, obj in events:
                try:
                    fn(ev_type, obj)
                except Exception:  # noqa: BLE001 - a consumer bug
                    logger.exception("informer event hook failed")
        for fn in list(self._hooks):
            try:
                fn()
            except Exception:  # noqa: BLE001 - a consumer bug
                logger.exception("informer change hook failed")

    @staticmethod
    def _key(obj: dict) -> tuple[str, str]:
        md = obj.get("metadata", {})
        return (md.get("namespace", ""), md.get("name", ""))

    @staticmethod
    def _same(a: dict | None, b: dict | None) -> bool:
        """Equal but for the resourceVersion (the port's fake numbers a
        watch event's object by its place in the write sequence, a list's
        by the object's own writes)."""
        def strip(o):
            if o is None:
                return None
            md = dict(o.get("metadata", {}))
            md.pop("resourceVersion", None)
            return dict(o, metadata=md)
        return strip(a) == strip(b)

    def _on_watch_event(self, ev_type: str, obj: dict) -> None:
        if self._stop.is_set():
            return
        gate = self.event_gate
        if gate is not None:
            try:
                deliver = gate(ev_type, obj)
            except Exception:  # noqa: BLE001 - a gate bug loses nothing
                logger.exception("informer event gate failed; delivering")
                deliver = True
            if not deliver:
                with self._lock:
                    self._deferred.append((ev_type, obj))
                return
        self._apply_event(ev_type, obj)

    def flush_deferred(self) -> int:
        """Apply the events the gate parked, in arrival order; how many
        (0 without a gate)."""
        with self._lock:
            pending, self._deferred = self._deferred, []
        for ev_type, obj in pending:
            self._apply_event(ev_type, obj)
        return len(pending)

    def _apply_event(self, ev_type: str, obj: dict) -> None:
        with self._apply_lock:
            with self._lock:
                key = self._key(obj)
                uid = obj.get("metadata", {}).get("uid", "")
                if ev_type == "DELETED":
                    changed = self._cache.pop(key, None) is not None
                    if uid:
                        self._by_uid.pop(uid, None)
                else:
                    changed = not self._same(self._cache.get(key), obj)
                    self._cache[key] = obj
                    if uid:
                        self._by_uid[uid] = key
            if changed:
                self._fire([(ev_type, obj)])

    def _on_fake_event(self, group, resource, namespace, ev_type, obj):
        if (group, resource) != (self.group, self.resource):
            return
        if self.namespace and namespace != self.namespace:
            return
        if not obj.get("metadata", {}).get("name"):
            self._relist_logged()  # no identity: list it all
            return
        self._on_watch_event(ev_type, json.loads(json.dumps(obj)))

    def _relist_on_gap(self) -> str | None:
        """The watch's gap: relist; the list's resourceVersion, where the
        watch resumes (None for a relist folded into one in flight: the
        watch resumes from now, and the trailing relist covers the
        gap)."""
        if self._stop.is_set():
            return None
        return self._relist_logged()

    def _resync_loop(self) -> None:
        while not self._stop.wait(self.resync_period):
            self._relist_logged()

    def _relist_logged(self) -> str | None:
        try:
            return self.relist()
        except Exception:  # noqa: BLE001 - the next resync converges
            logger.exception("informer relist of %s failed", self.resource)
            return None

    def relist(self) -> str | None:
        """A full list swapped into the cache, its differences fired as
        events; the list's resourceVersion ("" where the client gives
        none). A request made while a relist runs folds into one
        trailing relist and returns None at once."""
        with self._relist_lock:
            if self._relist_active:
                self._relist_pending = True
                return None
            self._relist_active = True
        try:
            while True:
                if self._coordinator is not None:
                    version = self._coordinator.run(self.resource,
                                                    self._relist_once)
                else:
                    version = self._relist_once()
                with self._relist_lock:
                    if not self._relist_pending:
                        return version
                    self._relist_pending = False
        finally:
            with self._relist_lock:
                self._relist_active = False

    def _relist_once(self) -> str:
        with self._apply_lock:
            self.relist_total += 1
            if self._on_relist is not None:
                try:
                    self._on_relist()
                except Exception:  # noqa: BLE001 - a metrics hook
                    logger.exception("informer relist hook failed")
            items, version = self.kube.list_with_version(
                self.group, self.version, self.resource,
                namespace=self.namespace)
            with self._lock:
                old, self._cache = self._cache, {self._key(o): o
                                                 for o in items}
                self._by_uid = {o["metadata"]["uid"]: self._key(o)
                                for o in items
                                if o.get("metadata", {}).get("uid")}
                events = [("MODIFIED" if key in old else "ADDED", obj)
                          for key, obj in self._cache.items()
                          if not self._same(old.get(key), obj)]
                events += [("DELETED", obj) for key, obj in old.items()
                           if key not in self._cache]
            self._synced.set()
            if events:
                self._fire(events)
        return version

    # -- reads -------------------------------------------------------------

    def get(self, name: str, namespace: str = "") -> dict | None:
        with self._lock:
            return self._cache.get((namespace, name))

    def list(self) -> list[dict]:
        with self._lock:
            return list(self._cache.values())

    def get_by_uid(self, uid: str) -> dict | None:
        with self._lock:
            key = self._by_uid.get(uid)
            obj = self._cache.get(key) if key else None
            # A delete and re-create under one (ns, name) in a watch gap
            # leaves the old uid on the new object until the next relist:
            # never serve an object of another uid.
            if obj is not None and obj.get("metadata", {}).get("uid") != uid:
                return None
            return obj
