"""A fake Kubernetes API server: the REST subset ``KubeClient`` speaks,
served over real HTTP from a ``FakeKubeClient`` store (the JAX package's
``pkg/fakeapiserver.py``).

It serves CRUD, JSON merge patch, label and field selectors and
``/version``, so the real ``KubeClient`` runs over a socket: its paths,
query strings and error mapping are what is tested. ``requests`` counts
the requests served by HTTP method.

Not ported: watch streaming (no module of the port watches yet; a watch
request is answered 501), the admission webhook leg, the health
endpoints, pod logs and the command line. ``stop()`` joins the serving
thread and every request thread, so no thread outlives the server.
"""

from __future__ import annotations

import collections
import json
import logging
import re
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from urllib.parse import parse_qs, urlparse

from .kubeclient import ConflictError, FakeKubeClient, KubeError, NotFoundError

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
                raise KubeError(501, "watch is not served")
            items = self.store.list(
                group, version, resource, namespace=namespace,
                label_selector=query.get("labelSelector", [""])[0] or None,
                field_selector=query.get("fieldSelector", [""])[0] or None)
            self._send_json(200, {"kind": "List", "apiVersion": "v1",
                                  "metadata": {"resourceVersion": "1"},
                                  "items": items})
        except Exception as e:  # noqa: BLE001 - wire boundary
            self._send_error(e)

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

    def __init__(self, address, store: FakeKubeClient):
        super().__init__(address, _Handler)
        self.store = store
        self.requests: collections.Counter = collections.Counter()
        self._count_lock = threading.Lock()

    def count(self, method: str) -> None:
        with self._count_lock:
            self.requests[method] += 1


class FakeApiServer:
    """The fake API server (tests, ``chip_smoke.py``)."""

    def __init__(self):
        self.store = FakeKubeClient()
        # Loopback only, on a free port.
        self._httpd = _Server(("127.0.0.1", 0), self.store)
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

    def stop(self) -> None:
        """Stop serving, close the socket, join every thread."""
        if self._thread is not None:
            self._httpd.shutdown()
            self._thread.join()
            self._thread = None
        self._httpd.server_close()

    def __enter__(self) -> "FakeApiServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

