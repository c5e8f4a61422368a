"""A list-and-watch cache of one resource (the JAX package's
``pkg/informer.py``, the part of its ``Informer`` that the PartitionSet
watcher uses; the client-go informer's shape).

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
MODIFIED or DELETED; ``relist_total`` counts the full lists. ``wait_for_sync`` waits for the first list;
``get`` and ``list`` read the cache. ``stop()`` ends the watch and the
resync and joins their threads.

``get_by_uid`` scans the cache (the ComputeDomain plugin reads domains
by uid). Not ported: the JAX informer's uid index, change hooks, relist
coalescing and ``RelistCoordinator`` (its restart-storm gate), and the
model checker's delivery seam; they wait for a module that needs them.
"""

from __future__ import annotations

import json
import logging
import threading
from typing import Callable

logger = logging.getLogger(__name__)


class Informer:
    def __init__(self, kube, group: str, version: str, resource: str,
                 namespace: str | None = None,
                 resync_period: float = 30.0,
                 reconnect_delay: float = 1.0):
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
        self._event_hooks: list[Callable[[str, dict], None]] = []
        self._stop = threading.Event()
        self._synced = threading.Event()
        self._started = False
        self._watch = None
        self._resync: threading.Thread | None = None
        self._fake_hook = None
        self.relist_total = 0

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
        with self._apply_lock:
            with self._lock:
                key = self._key(obj)
                if ev_type == "DELETED":
                    changed = self._cache.pop(key, None) is not None
                else:
                    changed = not self._same(self._cache.get(key), obj)
                    self._cache[key] = obj
            if changed:
                self._fire([(ev_type, obj)])

    def _on_fake_event(self, group, resource, namespace, ev_type, obj):
        if (group, resource) != (self.group, self.resource):
            return
        if self.namespace and namespace != self.namespace:
            return
        self._on_watch_event(ev_type, json.loads(json.dumps(obj)))

    def _relist_on_gap(self) -> str | None:
        """The watch's gap: relist; the list's resourceVersion, where the
        watch resumes."""
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

    def relist(self) -> str:
        """A full list swapped into the cache, its differences fired as
        events; returns the list's resourceVersion ("" where the client
        gives none)."""
        with self._apply_lock:
            self.relist_total += 1
            items, version = self.kube.list_with_version(
                self.group, self.version, self.resource,
                namespace=self.namespace)
            with self._lock:
                old, self._cache = self._cache, {self._key(o): o
                                                 for o in items}
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
            return next((o for o in self._cache.values()
                         if o.get("metadata", {}).get("uid") == uid), None)
