"""The small HTTP server of every binary's metrics and debug routes (the
JAX package's ``pkg/httpserver.py``)."""

from __future__ import annotations

import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable

# handler() -> (status_code, content_type, body_bytes)
EndpointFn = Callable[[], tuple[int, str, bytes]]


class SimpleHTTPEndpoint:
    """Serves GET <path> from ``fn``; ``extra`` adds more path->fn
    routes on the same listener (e.g. /metrics + /debug/stacks).
    A route key ending in ``/*`` is a PREFIX route: its handler takes
    the rest of the path as one argument (e.g. ``/debug/claims/*`` ->
    ``fn("<uid>")``). Anything else 404s."""

    def __init__(self, path: str, fn: EndpointFn, host: str = "127.0.0.1",
                 port: int = 0, thread_name: str = "http-endpoint",
                 extra: dict[str, EndpointFn] | None = None):
        routes = {path.rstrip("/"): fn}
        prefix_routes: dict[str, Callable[[str],
                                          tuple[int, str, bytes]]] = {}
        for p, f in (extra or {}).items():
            if p.endswith("/*"):
                prefix_routes[p[:-2].rstrip("/")] = f
            else:
                routes[p.rstrip("/")] = f
        default = path.rstrip("/")

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - http.server API
                got = self.path.split("?", 1)[0].rstrip("/")
                # Exact route first ("" can be a registered root route);
                # a bare "/" falls back to the primary endpoint.
                handler = routes.get(got, routes.get(default)
                                     if got == "" else None)
                if handler is None:
                    for prefix, pfn in prefix_routes.items():
                        if got.startswith(prefix + "/"):
                            handler = (lambda pfn=pfn, rest=got[
                                len(prefix) + 1:]: pfn(rest))
                            break
                if handler is None:
                    self.send_response(404)
                    self.end_headers()
                    return
                status, ctype, body = handler()
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):
                pass

        self._server = ThreadingHTTPServer((host, port), Handler)
        self._thread = threading.Thread(
            target=self._server.serve_forever, name=thread_name, daemon=True
        )

    @property
    def port(self) -> int:
        return self._server.server_address[1]

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Stop serving, close the socket and join the thread."""
        self._server.shutdown()
        self._server.server_close()
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)
