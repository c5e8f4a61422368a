"""A fake Kubernetes API server: the REST subset ``KubeClient`` speaks,
served over real HTTP from a ``FakeKubeClient`` store (the JAX package's
``pkg/fakeapiserver.py``).

It serves CRUD, JSON merge patch, label and field selectors,
``/version`` and streamed watches, so the real ``KubeClient`` runs over
a socket: its paths, query strings, error mapping and watch framing are
what is tested. ``requests`` counts the requests served by HTTP method.

A watch (``?watch=true``) is streamed as JSON lines with HTTP/1.0
framing (no Content-Length: read until close), as the JAX server does.
With ``resourceVersion`` it first replays the store's logged writes
after it, and answers 410 Gone when the log no longer reaches back so
far; without, it starts from now. Each event's object carries the
event's place in the store's write sequence as its resourceVersion, so
a client resumes from what it saw (the stored objects keep their own
counts). A BOOKMARK line every ``keepalive`` seconds shows the stream
alive. ``close_watches()`` ends every open stream (a server restart as a
client sees it); with ``hold`` it also answers new watches 503 until
``release_watches()``, so writes can pass while no client watches.

Not ported: the admission webhook leg, the health endpoints, pod logs
and the command line. ``stop()`` ends the watch streams, then joins the
serving thread and every request thread, so no thread outlives the
server.
"""

from __future__ import annotations

import collections
import json
import logging
import queue
import re
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .kubeclient import (ConflictError, FakeKubeClient, GoneError, KubeError,
                         NotFoundError)

logger = logging.getLogger(__name__)

# /api/v1/... (core) or /apis/<group>/<version>/...; an optional namespace;
# the plural; an optional name. No client of the port asks for a
# subresource.
_PATH_RE = re.compile(
    r"^/(?:api/(?P<core_version>[^/]+)|apis/(?P<group>[^/]+)/"
    r"(?P<version>[^/]+))"
    r"(?:/namespaces/(?P<namespace>[^/]+))?"
    r"/(?P<resource>[^/]+)"
    r"(?:/(?P<name>[^/]+))?$")


def _status_body(code: int, reason: str, message: str) -> bytes:
    return json.dumps({"kind": "Status", "apiVersion": "v1",
                       "status": "Failure", "message": message,
                       "reason": reason, "code": code}).encode()


class _Handler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.0"
    server_version = "FakeKubeApiserver/1.0"

    @property
    def store(self) -> FakeKubeClient:
        return self.server.store  # type: ignore[attr-defined]

    def log_message(self, fmt, *args):  # noqa: A003 - quiet by default
        logger.debug("%s %s", self.address_string(), fmt % args)

    def _count(self) -> None:
        self.server.count(self.command)  # type: ignore[attr-defined]

    def _send(self, code: int, body: bytes) -> None:
        self.send_response(code)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_json(self, code: int, obj) -> None:
        self._send(code, json.dumps(obj).encode())

    def _send_error(self, exc: Exception) -> None:
        if isinstance(exc, NotFoundError):
            code, reason = 404, "NotFound"
        elif isinstance(exc, ConflictError):
            code, reason = 409, "AlreadyExists"
        elif isinstance(exc, GoneError):
            code, reason = 410, "Expired"
        elif isinstance(exc, KubeError):
            code, reason = exc.status or 500, "InternalError"
        else:
            code, reason = 500, "InternalError"
        self._send(code, _status_body(code, reason, str(exc)))

    def _read_body(self) -> dict:
        length = int(self.headers.get("Content-Length", "0"))
        raw = self.rfile.read(length) if length else b""
        return json.loads(raw) if raw else {}

    def _route(self):
        """(group, version, namespace, resource, name, query), or None
        after answering 404."""
        parsed = urlparse(self.path)
        m = _PATH_RE.match(parsed.path)
        if not m:
            self._send_error(NotFoundError(f"unroutable path {parsed.path}"))
            return None
        d = m.groupdict()
        return (d["group"] or "", d["core_version"] or d["version"],
                d["namespace"], d["resource"], d["name"],
                parse_qs(parsed.query))

    def do_GET(self):  # noqa: N802
        self._count()
        parsed = urlparse(self.path)
        if parsed.path == "/version":
            self._send_json(200, self.store.server_version())
            return
        route = self._route()
        if route is None:
            return
        group, version, namespace, resource, name, query = route
        try:
            if name is not None:
                self._send_json(200, self.store.get(
                    group, version, resource, name, namespace=namespace))
                return
            if query.get("watch", ["false"])[0] == "true":
                if self.server.watch_hold.is_set():
                    raise KubeError(503, "watches are held")
                self._serve_watch(group, resource, namespace, query.get(
                    "resourceVersion", [""])[0])
                return
            seq = self.store.current_version()
            items = self.store.list(
                group, version, resource, namespace=namespace,
                label_selector=query.get("labelSelector", [""])[0] or None,
                field_selector=query.get("fieldSelector", [""])[0] or None)
            self._send_json(200, {"kind": "List", "apiVersion": "v1",
                                  "metadata": {"resourceVersion": seq},
                                  "items": items})
        except Exception as e:  # noqa: BLE001 - wire boundary
            self._send_error(e)

    def _serve_watch(self, group: str, resource: str,
                     namespace: str | None, since: str) -> None:
        """Stream the writes to ``group/resource`` until the client hangs
        up or the server closes its watches."""
        server = self.server
        gen = server.watch_generation
        replay, events, last = self.store.subscribe(group, resource,
                                                    namespace, since)
        try:
            self.send_response(200)
            self.send_header("Content-Type", "application/json")
            self.end_headers()

            def send(ev_type: str, obj: dict, seq: int) -> None:
                obj = dict(obj, metadata=dict(obj.get("metadata", {}),
                                              resourceVersion=str(seq)))
                self.wfile.write((json.dumps({"type": ev_type,
                                              "object": obj}) + "\n"
                                  ).encode())

            for seq, _, _, _, ev_type, obj in replay:
                send(ev_type, obj, seq)
            self.wfile.flush()
            bookmark = time.monotonic() + server.keepalive
            while server.watch_generation == gen:
                try:
                    seq, _, _, _, ev_type, obj = events.get(timeout=0.05)
                    if server.watch_generation != gen:
                        break  # closed: the client's resume replays it
                    send(ev_type, obj, seq)
                    last = seq
                except queue.Empty:
                    if time.monotonic() < bookmark:
                        continue
                    send("BOOKMARK", {"metadata": {}}, last)
                bookmark = time.monotonic() + server.keepalive
                self.wfile.flush()
        except OSError:
            pass  # the client hung up
        finally:
            self.store.unsubscribe(events)

    def do_POST(self):  # noqa: N802
        self._count()
        route = self._route()
        if route is None:
            return
        group, version, namespace, resource, name, _ = route
        try:
            if name is not None:
                raise KubeError(405, "POST with name")
            self._send_json(201, self.store.create(
                group, version, resource, self._read_body(),
                namespace=namespace))
        except Exception as e:  # noqa: BLE001
            self._send_error(e)

    def do_PUT(self):  # noqa: N802
        self._count()
        route = self._route()
        if route is None:
            return
        group, version, namespace, resource, name, _ = route
        try:
            if name is None:
                raise KubeError(405, "PUT without name")
            self._send_json(200, self.store.update(
                group, version, resource, name, self._read_body(),
                namespace=namespace))
        except Exception as e:  # noqa: BLE001
            self._send_error(e)

    def do_PATCH(self):  # noqa: N802
        self._count()
        route = self._route()
        if route is None:
            return
        group, version, namespace, resource, name, _ = route
        try:
            if name is None:
                raise KubeError(405, "PATCH without name")
            self._send_json(200, self.store.patch(
                group, version, resource, name, self._read_body(),
                namespace=namespace))
        except Exception as e:  # noqa: BLE001
            self._send_error(e)

    def do_DELETE(self):  # noqa: N802
        self._count()
        route = self._route()
        if route is None:
            return
        group, version, namespace, resource, name, _ = route
        try:
            if name is None:
                raise KubeError(405, "DELETE without name")
            # A missing object is a 404, as on a real server (the client
            # swallows it).
            self.store.get(group, version, resource, name,
                           namespace=namespace)
            self.store.delete(group, version, resource, name,
                              namespace=namespace)
            self._send_json(200, {"kind": "Status", "status": "Success"})
        except Exception as e:  # noqa: BLE001
            self._send_error(e)


class _Server(ThreadingHTTPServer):
    # Request threads are joined at server_close(): none outlives stop().
    daemon_threads = False
    block_on_close = True

    def __init__(self, address, store: FakeKubeClient, keepalive: float):
        super().__init__(address, _Handler)
        self.store = store
        self.requests: collections.Counter = collections.Counter()
        self._count_lock = threading.Lock()
        # Streams end when this moves (close_watches, stop).
        self.watch_generation = 0
        self.watch_hold = threading.Event()
        self.keepalive = keepalive

    def count(self, method: str) -> None:
        with self._count_lock:
            self.requests[method] += 1


class FakeApiServer:
    """The fake API server (tests, ``chip_smoke.py``) over ``store`` (a
    new ``FakeKubeClient`` by default); ``keepalive``: the seconds
    between a watch stream's bookmarks."""

    def __init__(self, store: FakeKubeClient | None = None,
                 keepalive: float = 1.0):
        self.store = store if store is not None else FakeKubeClient()
        # Loopback only, on a free port.
        self._httpd = _Server(("127.0.0.1", 0), self.store, keepalive)
        self._thread: threading.Thread | None = None

    @property
    def requests(self) -> collections.Counter:
        """Requests served so far, by HTTP method."""
        return self._httpd.requests

    def request_count(self) -> int:
        return sum(self._httpd.requests.values())

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def url(self) -> str:
        return f"http://{self._httpd.server_address[0]}:{self.port}"

    def start(self) -> "FakeApiServer":
        # A short poll interval: stop() waits at most that long.
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, kwargs={"poll_interval": 0.05},
            name="fake-apiserver", daemon=True)
        self._thread.start()
        logger.info("fake apiserver on %s", self.url)
        return self

    def close_watches(self, hold: bool = False) -> None:
        """End every open watch stream (its client resumes); with
        ``hold``, refuse new ones until ``release_watches()``."""
        if hold:
            self._httpd.watch_hold.set()
        self._httpd.watch_generation += 1

    def release_watches(self) -> None:
        self._httpd.watch_hold.clear()

    def stop(self) -> None:
        """End the watch streams, stop serving, close the socket, join
        every thread."""
        self.close_watches()
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join()
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "FakeApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

