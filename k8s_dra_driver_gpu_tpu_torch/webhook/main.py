"""The admission webhook: strict validation of opaque configs at
admission time (the JAX package's ``webhook/main.py``; upstream
cmd/webhook/main.go).

A TLS HTTP server exposes ``/validate-resource-claim-parameters``
(upstream :100). From a ResourceClaim or ResourceClaimTemplate of
resource.k8s.io v1, v1beta1 or v1beta2 (resource.go:33-150) it takes the
opaque configs of this repository's drivers (the GPU plugin's
``gpu.nvidia.com`` and the CD plugin's ``compute-domain.nvidia.com``),
strict-decodes each (``api.decode.strict_decode``) and runs
``normalize()`` and ``validate()``; a ComputeDomain must split its nodes
evenly over its slices (``computedomain.per_slice_workers``). It is
optional: the plugins decode strictly again at prepare. The config kinds
are the port's (``GpuConfig``, ``MigDeviceConfig``, ``VfioDeviceConfig``
and the two CD configs).

Run it as ``python -m k8s_dra_driver_gpu_tpu_torch.webhook.main --port N
[--tls-cert F --tls-key F]`` (plain HTTP without the pair); SIGTERM or
SIGINT stops it.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import ssl
import sys
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

from .. import __version__
from ..api.configs import ValidationError
from ..api.decode import DecodeError, strict_decode
from ..computedomain import COMPUTE_DOMAIN_DRIVER_NAME, per_slice_workers
from ..kubeletplugin import DRIVER_NAME
from ..pkg import logsetup
from ..pkg.debug import wait_for_termination

logger = logging.getLogger(__name__)

VALIDATE_PATH = "/validate-resource-claim-parameters"
OUR_DRIVERS = (DRIVER_NAME, COMPUTE_DOMAIN_DRIVER_NAME)
SUPPORTED_VERSIONS = ("v1", "v1beta1", "v1beta2")


def extract_device_configs(obj: dict) -> list[dict]:
    """Opaque parameter objects owned by our drivers, from a
    ResourceClaim or ResourceClaimTemplate (resource.go:82-150)."""
    kind = obj.get("kind", "")
    if kind == "ResourceClaimTemplate":
        spec = obj.get("spec", {}).get("spec", {})
    else:
        spec = obj.get("spec", {})
    out = []
    for entry in spec.get("devices", {}).get("config", []):
        opaque = entry.get("opaque") or {}
        if opaque.get("driver") in OUR_DRIVERS:
            out.append(opaque.get("parameters", {}))
    return out


def validate_admission_review(review: dict) -> dict:
    """AdmissionReview in -> AdmissionReview out with allowed verdict."""
    request = review.get("request") or {}
    uid = request.get("uid", "")
    response: dict = {"uid": uid, "allowed": True}

    obj = request.get("object") or {}
    api_version = obj.get("apiVersion", "")
    group_version = api_version.rsplit("/", 1)[-1] if api_version else ""
    if (
        obj.get("kind") in ("ResourceClaim", "ResourceClaimTemplate")
        and group_version in SUPPORTED_VERSIONS
    ):
        for params in extract_device_configs(obj):
            try:
                cfg = strict_decode(params)
                cfg.normalize()
                cfg.validate()
            except (DecodeError, ValidationError) as e:
                response["allowed"] = False
                response["status"] = {
                    "message": f"invalid device config: {e}",
                    "code": 422,
                }
                break
    elif obj.get("kind") == "ComputeDomain":
        # Fail at admission what would otherwise be a PermanentError in
        # every node's channel prepare: a cross-slice domain must split
        # its hosts evenly over its slices.
        try:
            per_slice_workers(obj.get("spec") or {})
        except ValueError as e:
            response["allowed"] = False
            response["status"] = {"message": str(e), "code": 422}
    return {
        "apiVersion": review.get(
            "apiVersion", "admission.k8s.io/v1"
        ),
        "kind": "AdmissionReview",
        "response": response,
    }


class _Handler(BaseHTTPRequestHandler):
    def do_POST(self):  # noqa: N802 - http.server API
        if self.path.split("?", 1)[0] != VALIDATE_PATH:
            self.send_response(404)
            self.end_headers()
            return
        length = int(self.headers.get("Content-Length", "0"))
        try:
            review = json.loads(self.rfile.read(length))
            out = validate_admission_review(review)
        except (json.JSONDecodeError, AttributeError) as e:
            self.send_response(400)
            self.end_headers()
            self.wfile.write(str(e).encode())
            return
        body = json.dumps(out).encode()
        self.send_response(200)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def log_message(self, *args):
        pass


class WebhookServer:
    """The endpoint on a thread; TLS with ``tls_cert`` and ``tls_key``
    (PEM files), plain HTTP without."""

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 0,
        tls_cert: str | None = None,
        tls_key: str | None = None,
    ):
        self._server = ThreadingHTTPServer((host, port), _Handler)
        if tls_cert and tls_key:
            ctx = ssl.SSLContext(ssl.PROTOCOL_TLS_SERVER)
            ctx.load_cert_chain(tls_cert, tls_key)
            self._server.socket = ctx.wrap_socket(
                self._server.socket, server_side=True
            )
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="webhook", daemon=True
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


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="tpu-dra-webhook")
    p.add_argument("--port", type=int, default=8443)
    p.add_argument("--tls-cert")
    p.add_argument("--tls-key")
    p.add_argument("-v", "--verbosity", type=int,
                   default=int(os.environ.get("V", "4")),
                   help="log verbosity (see pkg/logsetup.py) [V]")
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logsetup.setup(args.verbosity)
    logsetup.log_startup(__name__, "tpu-dra-webhook", __version__, args)
    server = WebhookServer(port=args.port, tls_cert=args.tls_cert,
                           tls_key=args.tls_key)
    server.start()
    logsetup.startup_logger(__name__).info(
        "webhook serving on :%d%s (%s)", server.port, VALIDATE_PATH,
        "TLS" if args.tls_cert and args.tls_key else "plain HTTP")
    wait_for_termination()
    server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
