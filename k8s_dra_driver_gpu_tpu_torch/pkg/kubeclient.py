"""A Kubernetes REST client over the standard library, and an in-memory
fake with the same surface (the JAX package's ``pkg/kubeclient.py``; the
upstream driver's ``pkg/flags/kubeclient.go`` builds client sets from
the in-cluster config).

``KubeClient`` speaks CRUD on any group/version/resource path, JSON
merge patch, label and field selectors and ``/version``, and
maps HTTP 404 and 409 to ``NotFoundError`` and ``ConflictError``.
``KubeClient.watch`` follows a streamed ``?watch=true`` (JSON lines,
chunked or read until close): it resumes from the last resourceVersion
it saw, reconnects when the stream ends, and on 410 Gone (or an ERROR
event) starts again from now and calls ``on_gap``, so its consumer
relists (``informer.Informer``). Its ``Watch`` handle stops it by
shutting the connection's socket down, so a stop never waits for the
server's next line.

``FakeKubeClient`` keeps the objects in memory with the API server's
resourceVersion conflicts, selectors and merge patch; ``fakeapiserver``
serves it over HTTP. Each object's resourceVersion is its own count of
writes (the JAX fake's, which the transcripts compare); the store also
numbers every write in one sequence, its event log (the last
``event_log`` writes, ``EVENT_LOG`` by default), which ``list_with_version`` returns and a watch
resumes from. Its watchers are called after each write, outside the
store's lock (``add_resource_watcher``), as the JAX fake's.

The watch loop's fault point is ``kube.watch`` (``pkg/faults.py``).
Not ported: ``from_kubeconfig`` (it needs PyYAML, which the card's
machine lacks; queued in ROADMAP.md §1b), its legacy global watchers
(``add_watcher``), and ``read_raw`` (pod logs), which no module of the
port reads.
"""

from __future__ import annotations

import collections
import http.client
import json
import logging
import os
import queue
import socket
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request
from typing import Callable

from . import faults

logger = logging.getLogger(__name__)

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"
# The writes a FakeKubeClient remembers for watches that resume.
EVENT_LOG = 1024
# A watch stream silent this long is reconnected (the server's bookmarks
# keep a live one talking).
WATCH_READ_TIMEOUT_S = 300.0


class KubeError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status


class NotFoundError(KubeError):
    def __init__(self, message: str = "not found"):
        super().__init__(404, message)


class ConflictError(KubeError):
    def __init__(self, message: str = "conflict"):
        super().__init__(409, message)


class GoneError(KubeError):
    """A watch asked for a resourceVersion older than the server keeps."""

    def __init__(self, message: str = "gone"):
        super().__init__(410, message)


class Watch:
    """A running ``KubeClient.watch``: its thread and how to end it."""

    def __init__(self, stop: threading.Event):
        self._stop = stop
        self._sock: socket.socket | None = None
        self._sock_lock = threading.Lock()
        self.thread: threading.Thread | None = None

    def _set_sock(self, sock) -> bool:
        """Record the live connection's socket (the response keeps it
        after ``HTTPConnection`` lets go); False when stopped already."""
        with self._sock_lock:
            self._sock = sock
            return not self._stop.is_set()

    def stop(self, timeout: float = 5.0) -> None:
        """End the watch: set its stop event, shut its socket down (a
        blocked read returns at once) and join its thread."""
        self._stop.set()
        with self._sock_lock:
            sock = self._sock
        if sock is not None:
            try:
                sock.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
        if self.thread is not None:
            self.thread.join(timeout)

    def alive(self) -> bool:
        return self.thread is not None and self.thread.is_alive()


def _resource_path(group: str, version: str, resource: str,
                   namespace: str | None, name: str | None) -> str:
    base = f"/api/{version}" if not group else f"/apis/{group}/{version}"
    if namespace:
        base += f"/namespaces/{namespace}"
    base += f"/{resource}"
    if name:
        base += f"/{name}"
    return base


class KubeClient:
    """REST client over the API server: ``host``, else ``KUBE_API`` (a
    full URL), else the in-cluster ``KUBERNETES_SERVICE_HOST`` and
    ``_PORT`` over https; ``token`` and ``ca_cert``, else the service
    account's where they exist. (The JAX client's client-certificate and
    inline-CA arguments serve its kubeconfig path, not ported.)"""

    def __init__(self, host: str | None = None, token: str | None = None,
                 ca_cert: str | None = None):
        if host is None:
            host = os.environ.get("KUBE_API")
        if host is None:
            h = os.environ.get("KUBERNETES_SERVICE_HOST")
            p = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not h:
                raise KubeError(0, "no API server host configured")
            host = f"https://{h}:{p}"
        self._host = host.rstrip("/")
        if token is None:
            token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
            if os.path.exists(token_path):
                with open(token_path, encoding="utf-8") as f:
                    token = f.read().strip()
        self._token = token
        ctx: ssl.SSLContext | None = None
        if self._host.startswith("https"):
            ctx = ssl.create_default_context()
            ca = ca_cert or os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
            if os.path.exists(ca):
                ctx.load_verify_locations(ca)
        self._ssl = ctx

    def _request(self, method: str, path: str, body: dict | None = None,
                 content_type: str = "application/json",
                 timeout: float = 30.0):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self._host + path, data=data,
                                     method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        try:
            with urllib.request.urlopen(req, timeout=timeout,
                                        context=self._ssl) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            msg = e.read().decode(errors="replace")
            if e.code == 404:
                raise NotFoundError(msg) from e
            if e.code == 409:
                raise ConflictError(msg) from e
            raise KubeError(e.code, msg) from e

    # Every verb takes a per-call ``timeout`` (seconds), so no call can
    # hold a thread for urllib's default.

    def get(self, group, version, resource, name, namespace=None,
            timeout: float = 30.0) -> dict:
        return self._request(
            "GET", _resource_path(group, version, resource, namespace, name),
            timeout=timeout)

    def list(self, group, version, resource, namespace=None,
             label_selector: str | None = None,
             field_selector: str | None = None,
             timeout: float = 30.0) -> list[dict]:
        path = _resource_path(group, version, resource, namespace, None)
        query = []
        if label_selector:
            query.append(
                f"labelSelector={urllib.parse.quote(label_selector)}")
        if field_selector:
            query.append(
                f"fieldSelector={urllib.parse.quote(field_selector)}")
        if query:
            path += "?" + "&".join(query)
        return self._request("GET", path, timeout=timeout).get("items", [])

    def create(self, group, version, resource, obj, namespace=None,
               timeout: float = 30.0) -> dict:
        return self._request(
            "POST", _resource_path(group, version, resource, namespace, None),
            body=obj, timeout=timeout)

    def update(self, group, version, resource, name, obj, namespace=None,
               timeout: float = 30.0) -> dict:
        return self._request(
            "PUT", _resource_path(group, version, resource, namespace, name),
            body=obj, timeout=timeout)

    def patch(self, group, version, resource, name, patch, namespace=None,
              timeout: float = 30.0) -> dict:
        """A JSON merge patch (RFC 7386): null deletes a key."""
        return self._request(
            "PATCH", _resource_path(group, version, resource, namespace,
                                    name),
            body=patch, content_type="application/merge-patch+json",
            timeout=timeout)

    def delete(self, group, version, resource, name, namespace=None,
               timeout: float = 30.0) -> None:
        """Deleting an absent object is not an error."""
        try:
            self._request(
                "DELETE",
                _resource_path(group, version, resource, namespace, name),
                timeout=timeout)
        except NotFoundError:
            pass

    def server_version(self, timeout: float = 30.0) -> dict:
        return self._request("GET", "/version", timeout=timeout)

    def list_with_version(self, group, version, resource, namespace=None,
                          timeout: float = 30.0) -> tuple[list[dict], str]:
        """The objects and the list's resourceVersion, where a watch
        that misses nothing after the list starts."""
        out = self._request(
            "GET", _resource_path(group, version, resource, namespace, None),
            timeout=timeout)
        return (out.get("items", []),
                str(out.get("metadata", {}).get("resourceVersion", "")))

    # -- watch -----------------------------------------------------------

    def _connection(self, timeout: float) -> http.client.HTTPConnection:
        url = urllib.parse.urlsplit(self._host)
        if url.scheme == "https":
            return http.client.HTTPSConnection(
                url.hostname, url.port or 443, timeout=timeout,
                context=self._ssl)
        return http.client.HTTPConnection(url.hostname, url.port or 80,
                                          timeout=timeout)

    def watch(self, group: str, version: str, resource: str,
              on_event: Callable[[str, dict], None],
              namespace: str | None = None,
              stop: threading.Event | None = None,
              reconnect_delay: float = 2.0,
              on_gap: Callable[[], str | None] | None = None,
              resource_version: str = "") -> Watch:
        """A streamed watch on its own thread: ``on_event(type, object)``
        for each ADDED, MODIFIED or DELETED event, from
        ``resource_version`` on (from now when it is ""). The stream is
        resumed from the last resourceVersion seen when it ends or
        stalls past ``WATCH_READ_TIMEOUT_S``. After a 410 Gone or an
        ERROR event the events in between are lost: ``on_gap()`` is
        called, relists, and returns the list's resourceVersion, from
        which the watch resumes (client-go's ListAndWatch), so nothing
        written after the relist is missed; without one it starts again
        from now. Returns the ``Watch``; ``Watch.stop()`` or ``stop``
        ends it."""
        handle = Watch(stop or threading.Event())
        stop = handle._stop
        path = _resource_path(group, version, resource, namespace, None)
        headers = {"Accept": "application/json"}
        if self._token:
            headers["Authorization"] = f"Bearer {self._token}"

        def gap() -> str:
            """The resourceVersion to resume from after a gap."""
            if on_gap is None:
                return ""
            try:
                return on_gap() or ""
            except Exception:  # noqa: BLE001 - the watch goes on
                logger.exception("watch gap callback failed for %s",
                                 resource)
                return ""

        # The last resourceVersion seen, kept across reconnects.
        pos = {"rv": resource_version}

        def stream(resp) -> None:
            while not stop.is_set():
                raw = resp.readline()
                if not raw:
                    return  # the server ended the stream
                try:
                    ev = json.loads(raw)
                except json.JSONDecodeError:
                    continue
                obj = ev.get("object") or {}
                ev_type = ev.get("type", "")
                if ev_type == "ERROR":
                    pos["rv"] = gap()
                    return
                pos["rv"] = obj.get("metadata", {}).get(
                    "resourceVersion") or pos["rv"]
                if ev_type == "BOOKMARK" or not obj.get("metadata"):
                    continue
                try:
                    on_event(ev_type, obj)
                except Exception:  # noqa: BLE001 - a callback bug
                    logger.exception("watch callback failed for %s %s",
                                     ev_type, resource)

        def run():
            while not stop.is_set():
                query = "?watch=true&allowWatchBookmarks=true"
                if pos["rv"]:
                    query += "&resourceVersion=" + urllib.parse.quote(
                        pos["rv"])
                conn = self._connection(WATCH_READ_TIMEOUT_S)
                try:
                    # A broken stream (``error``: OSError): the
                    # reconnect below is what it exercises.
                    faults.fault_point("kube.watch",
                                       error=lambda m: OSError(m))
                    conn.request("GET", path + query, headers=headers)
                    if not handle._set_sock(conn.sock):
                        return
                    resp = conn.getresponse()
                    if resp.status == 410:
                        pos["rv"] = gap()
                    elif resp.status != 200:
                        logger.warning("watch %s: HTTP %d: %s", resource,
                                       resp.status,
                                       resp.read(512).decode(
                                           errors="replace"))
                    else:
                        try:
                            stream(resp)
                        finally:
                            resp.close()
                        continue  # resume at once
                except (OSError, http.client.HTTPException):
                    pass
                finally:
                    handle._set_sock(None)
                    conn.close()
                stop.wait(reconnect_delay)

        handle.thread = threading.Thread(target=run, name=f"watch-{resource}",
                                         daemon=True)
        handle.thread.start()
        return handle


def _copy(obj):
    return json.loads(json.dumps(obj))


def _selector(text: str | None) -> dict[str, str]:
    """``a=b,c=d`` as a dict (equality terms only)."""
    out = {}
    for part in (text or "").split(","):
        if part:
            key, _, value = part.partition("=")
            out[key] = value
    return out


def _field(obj: dict, dotted: str):
    cur = obj
    for seg in dotted.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(seg)
    return cur


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if v is None:
            dst.pop(k, None)
        elif isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


class FakeKubeClient:
    """``KubeClient``'s surface over an in-memory store. ``version`` is
    what ``server_version()`` answers."""

    def __init__(self, event_log: int = EVENT_LOG):
        # (group, resource, namespace or "", name) -> object
        self._store: dict[tuple, dict] = {}
        self._lock = threading.Lock()
        self._uid = 0
        self.version = {"major": "1", "minor": "34"}
        # The write sequence and its last ``event_log`` events:
        # (seq, group, resource, namespace, type, object).
        self._seq = 0
        self._log: collections.deque = collections.deque(maxlen=event_log)
        # fn(group, resource, namespace, event_type, object), called
        # after each write outside the lock.
        self._resource_watchers: list[Callable] = []
        # Streams (fakeapiserver): (group, resource, namespace, queue),
        # fed under the lock in write order; the condition is notified
        # when one opens or closes.
        self._streams: list[tuple] = []
        self._streams_changed = threading.Condition(self._lock)

    @staticmethod
    def _key(group, resource, namespace, name):
        return (group, resource, namespace or "", name)

    # -- watch hooks -----------------------------------------------------

    def add_resource_watcher(self, fn: Callable) -> None:
        with self._lock:
            self._resource_watchers.append(fn)

    def remove_resource_watcher(self, fn: Callable) -> None:
        with self._lock:
            if fn in self._resource_watchers:
                self._resource_watchers.remove(fn)

    def _event_locked(self, group, resource, namespace, ev_type, obj) -> tuple:
        """Log a write (the caller holds the lock) and feed the streams;
        returns what ``_notify`` hands the watchers."""
        self._seq += 1
        ev = (self._seq, group, resource, namespace or "", ev_type,
              _copy(obj))
        self._log.append(ev)
        for g, r, ns, q in self._streams:
            if (g, r) == (group, resource) and (not ns or ns == ev[3]):
                q.put(ev)
        return ev

    def _notify(self, ev: tuple | None) -> None:
        if ev is None:
            return
        with self._lock:
            watchers = list(self._resource_watchers)
        for fn in watchers:
            fn(ev[1], ev[2], ev[3], ev[4], _copy(ev[5]))

    def current_version(self) -> str:
        """The store's write sequence number, as a resourceVersion."""
        with self._lock:
            return str(self._seq)

    def list_with_version(self, group, version, resource, namespace=None,
                          timeout: float = 30.0) -> tuple[list[dict], str]:
        seq = self.current_version()
        # Objects written after ``seq`` may show in the list too; a watch
        # from ``seq`` replays them, which a consumer applies again.
        return self.list(group, version, resource, namespace=namespace), seq

    def subscribe(self, group, resource, namespace=None, since: str = ""):
        """A stream of the writes to ``group/resource`` (in
        ``namespace``, or any), from write ``since`` on (from now when
        ""): (the logged events after ``since``, a queue of the later
        ones, the sequence number the replay reaches). GoneError when the
        log no longer holds the write after ``since``."""
        q: queue.Queue = queue.Queue()
        with self._lock:
            replay = []
            if since:
                try:
                    start = int(since)
                except ValueError:
                    raise GoneError(f"resourceVersion {since!r} is not one "
                                    "of this store's") from None
                oldest = self._log[0][0] if self._log else self._seq + 1
                if start < oldest - 1:
                    raise GoneError(f"resourceVersion {since} is older than "
                                    f"the oldest kept ({oldest})")
                replay = [ev for ev in self._log if ev[0] > start
                          and (ev[1], ev[2]) == (group, resource)
                          and (not namespace or ev[3] == namespace)]
            self._streams.append((group, resource, namespace, q))
            self._streams_changed.notify_all()
            return replay, q, self._seq

    def unsubscribe(self, q) -> None:
        with self._lock:
            self._streams = [s for s in self._streams if s[3] is not q]
            self._streams_changed.notify_all()

    def wait_for_streams(self, n: int, timeout: float) -> bool:
        """Wait until ``n`` streams are open; False at the timeout."""
        with self._lock:
            return self._streams_changed.wait_for(
                lambda: len(self._streams) >= n, timeout)

    def objects(self, group=None, resource=None) -> list[dict]:
        with self._lock:
            return [v for (g, r, _, _), v in self._store.items()
                    if (group is None or g == group)
                    and (resource is None or r == resource)]

    # ``timeout`` is the real client's and is ignored here.

    def get(self, group, version, resource, name, namespace=None,
            timeout: float = 30.0) -> dict:
        with self._lock:
            obj = self._store.get(self._key(group, resource, namespace,
                                            name))
            if obj is None:
                raise NotFoundError(f"{resource}/{name}")
            return _copy(obj)

    def list(self, group, version, resource, namespace=None,
             label_selector: str | None = None,
             field_selector: str | None = None,
             timeout: float = 30.0) -> list[dict]:
        labels_wanted = _selector(label_selector)
        fields_wanted = _selector(field_selector)
        with self._lock:
            out = []
            for (g, r, ns, _), obj in self._store.items():
                if g != group or r != resource:
                    continue
                if namespace and ns != namespace:
                    continue
                labels = obj.get("metadata", {}).get("labels", {})
                if not all(labels.get(k) == v
                           for k, v in labels_wanted.items()):
                    continue
                if all(_field(obj, k) == v
                       for k, v in fields_wanted.items()):
                    out.append(_copy(obj))
            return out

    def create(self, group, version, resource, obj, namespace=None,
               timeout: float = 30.0) -> dict:
        name = obj.get("metadata", {}).get("name", "")
        key = self._key(group, resource, namespace, name)
        with self._lock:
            if key in self._store:
                raise ConflictError(f"{resource}/{name} exists")
            obj = _copy(obj)
            meta = obj.setdefault("metadata", {})
            if namespace:
                meta.setdefault("namespace", namespace)
            if not meta.get("uid"):
                self._uid += 1
                meta["uid"] = f"uid-{self._uid}"
            meta["resourceVersion"] = "1"
            self._store[key] = obj
            ev = self._event_locked(group, resource, namespace, "ADDED", obj)
        self._notify(ev)
        return _copy(ev[5])

    def update(self, group, version, resource, name, obj, namespace=None,
               timeout: float = 30.0) -> dict:
        """An update that carries a resourceVersion must carry the stored
        one (409 otherwise); one without is last-write-wins."""
        key = self._key(group, resource, namespace, name)
        with self._lock:
            if key not in self._store:
                raise NotFoundError(f"{resource}/{name}")
            old = self._store[key]
            obj = _copy(obj)
            meta = obj.setdefault("metadata", {})
            meta.setdefault("uid", old.get("metadata", {}).get("uid"))
            old_rv = old.get("metadata", {}).get("resourceVersion", "1")
            rv_in = meta.get("resourceVersion")
            if rv_in and rv_in != old_rv:
                raise ConflictError(
                    f"{resource}/{name}: resourceVersion {rv_in} is "
                    f"stale (current {old_rv})")
            meta["resourceVersion"] = str(int(old_rv) + 1)
            self._store[key] = obj
            ev = self._event_locked(group, resource, namespace, "MODIFIED",
                                    obj)
        self._notify(ev)
        return _copy(ev[5])

    def patch(self, group, version, resource, name, patch, namespace=None,
              timeout: float = 30.0) -> dict:
        """A merge patch; a resourceVersion inside it is a precondition
        (409 on a mismatch) and never rewinds the stored one."""
        key = self._key(group, resource, namespace, name)
        with self._lock:
            if key not in self._store:
                raise NotFoundError(f"{resource}/{name}")
            obj = self._store[key]
            stored_rv = obj.get("metadata", {}).get("resourceVersion", "1")
            patch = _copy(patch)
            rv_in = patch.get("metadata", {}).pop("resourceVersion", None)
            if rv_in is not None and str(rv_in) != stored_rv:
                raise ConflictError(
                    f"{resource}/{name}: resourceVersion {rv_in} is "
                    f"stale (current {stored_rv})")
            _merge(obj, patch)
            obj.setdefault("metadata", {})["resourceVersion"] = str(
                int(stored_rv) + 1)
            ev = self._event_locked(group, resource, namespace, "MODIFIED",
                                    obj)
        self._notify(ev)
        return _copy(ev[5])

    def delete(self, group, version, resource, name, namespace=None,
               timeout: float = 30.0) -> None:
        """Deleting a namespace deletes every object in it, as the
        namespace controller does."""
        events = []
        with self._lock:
            obj = self._store.pop(self._key(group, resource, namespace,
                                            name), None)
            if obj is not None:
                events.append(self._event_locked(group, resource, namespace,
                                                 "DELETED", obj))
            if obj is not None and resource == "namespaces" \
                    and not namespace:
                for k in [k for k in self._store if k[2] == name]:
                    events.append(self._event_locked(
                        k[0], k[1], k[2], "DELETED", self._store.pop(k)))
        for ev in events:
            self._notify(ev)

    def server_version(self, timeout: float = 30.0) -> dict:
        return self.version

