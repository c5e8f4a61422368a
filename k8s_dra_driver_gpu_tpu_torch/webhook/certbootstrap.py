"""Webhook TLS bootstrap: a self-signed cert, its Secret and the
caBundle patch (the JAX package's ``webhook/certbootstrap.py``; the
upstream chart's generated-secret path, deployments/helm/.../
webhook-cert-*.yaml, as a tool a post-install Job runs: no cert-manager,
no kubectl):

1. Generate a self-signed CA + server certificate for
   ``<service>.<namespace>.svc`` with openssl.
2. Create/update the TLS Secret the webhook Deployment mounts.
3. Patch the ValidatingWebhookConfiguration's clientConfig.caBundle so
   the API server trusts it.

Idempotent: an existing, still-valid Secret is kept (only the caBundle
patch is re-applied from it), so rollouts don't churn serving certs.
A cert is valid when it names ``<service>.<namespace>.svc`` as a
subjectAltName (API servers ignore the Subject CN) and does not expire
within 30 days.

Run it as ``python -m k8s_dra_driver_gpu_tpu_torch.webhook.certbootstrap
[--mode create|patch|both]``; it talks to the API server through the
in-cluster config, or ``KUBE_API``.
"""

from __future__ import annotations

import argparse
import base64
import copy
import logging
import os
import subprocess
import sys
import tempfile

from ..pkg.kubeclient import ConflictError, KubeClient, NotFoundError
from ..pkg.retry import RetryingKubeClient

logger = logging.getLogger(__name__)


def generate_self_signed(service: str, namespace: str,
                         days: int = 3650) -> tuple[bytes, bytes]:
    """(cert_pem, key_pem) for the service DNS names, via openssl."""
    cn = f"{service}.{namespace}.svc"
    sans = f"DNS:{cn},DNS:{cn}.cluster.local,DNS:{service}.{namespace}"
    with tempfile.TemporaryDirectory() as d:
        cert = os.path.join(d, "tls.crt")
        key = os.path.join(d, "tls.key")
        subprocess.run(
            [
                "openssl", "req", "-x509", "-newkey", "rsa:2048",
                "-keyout", key, "-out", cert,
                "-days", str(days), "-nodes",
                "-subj", f"/CN={cn}",
                "-addext", f"subjectAltName={sans}",
            ],
            check=True, capture_output=True,
        )
        with open(cert, "rb") as f:
            cert_pem = f.read()
        with open(key, "rb") as f:
            key_pem = f.read()
    return cert_pem, key_pem


def cert_valid(cert_pem: bytes, service: str, namespace: str,
               min_remaining_s: int = 30 * 24 * 3600) -> bool:
    """The cert must carry the service DNS name as a subjectAltName and
    not expire within ``min_remaining_s`` -- otherwise the bootstrap
    regenerates it instead of re-trusting a stale Secret forever.

    The SAN extension specifically: API servers ignore the Subject CN,
    so a CN-only cert (e.g. an externally created Secret) would keep the
    webhook broken forever if we accepted it."""
    try:
        check = subprocess.run(
            ["openssl", "x509", "-noout", "-checkend",
             str(min_remaining_s)],
            input=cert_pem, capture_output=True,
        )
        if check.returncode != 0:
            return False
        san = subprocess.run(
            ["openssl", "x509", "-noout", "-ext", "subjectAltName"],
            input=cert_pem, capture_output=True, check=True,
        ).stdout.decode()
    except (OSError, subprocess.SubprocessError):
        return False
    dns_names = {
        entry.strip()[len("DNS:"):]
        for entry in san.replace("\n", ",").split(",")
        if entry.strip().startswith("DNS:")
    }
    return f"{service}.{namespace}.svc" in dns_names


def ensure_secret(kube, name: str, namespace: str, service: str) -> bytes:
    """Create (or refresh) the TLS secret; returns the PEM cert (CA ==
    server cert for the self-signed case). An existing STILL-VALID
    secret is kept so rollouts don't churn serving certs; an expired or
    wrong-SAN one is replaced."""
    existing = None
    try:
        existing = kube.get("", "v1", "secrets", name, namespace=namespace)
        cert_b64 = existing.get("data", {}).get("tls.crt", "")
        if cert_b64:
            cert = base64.b64decode(cert_b64)
            if cert_valid(cert, service, namespace):
                logger.info("secret %s/%s valid; keeping it",
                            namespace, name)
                return cert
            logger.warning("secret %s/%s invalid/expiring; regenerating",
                           namespace, name)
    except NotFoundError:
        pass
    cert_pem, key_pem = generate_self_signed(service, namespace)
    secret = {
        "apiVersion": "v1",
        "kind": "Secret",
        "type": "kubernetes.io/tls",
        "metadata": {"name": name, "namespace": namespace},
        "data": {
            "tls.crt": base64.b64encode(cert_pem).decode(),
            "tls.key": base64.b64encode(key_pem).decode(),
            "ca.crt": base64.b64encode(cert_pem).decode(),
        },
    }
    if existing is not None:
        kube.update("", "v1", "secrets", name, secret, namespace=namespace)
        logger.info("replaced secret %s/%s", namespace, name)
        return cert_pem
    try:
        kube.create("", "v1", "secrets", secret, namespace=namespace)
        logger.info("created secret %s/%s", namespace, name)
    except ConflictError:  # racing replica created it first
        existing = kube.get("", "v1", "secrets", name, namespace=namespace)
        return base64.b64decode(existing["data"]["tls.crt"])
    return cert_pem


def patch_ca_bundle(kube, webhook_config: str, ca_pem: bytes) -> None:
    """Every webhook of the configuration trusts ``ca_pem``."""
    # A copy: never mutate the fetched object.
    obj = copy.deepcopy(kube.get("admissionregistration.k8s.io", "v1",
                                 "validatingwebhookconfigurations",
                                 webhook_config))
    for wh in obj.get("webhooks", []):
        wh.setdefault("clientConfig", {})["caBundle"] = base64.b64encode(
            ca_pem).decode()
    kube.update("admissionregistration.k8s.io", "v1",
                "validatingwebhookconfigurations", webhook_config, obj)
    logger.info("patched caBundle on %s", webhook_config)


def run(kube, service: str, namespace: str, secret_name: str,
        webhook_config: str, mode: str = "both") -> int:
    """mode: "create" (pre-install: Secret only -- the webhook config
    doesn't exist yet), "patch" (post-install: caBundle only), or
    "both" (manual/one-shot)."""
    ca_pem = ensure_secret(kube, secret_name, namespace, service)
    if mode != "create":
        patch_ca_bundle(kube, webhook_config, ca_pem)
    return 0


def build_parser() -> argparse.ArgumentParser:
    env = os.environ.get
    p = argparse.ArgumentParser(prog="tpu-dra-webhook-certbootstrap")
    p.add_argument("--service", default=env("WEBHOOK_SERVICE",
                                            "tpu-dra-webhook"))
    p.add_argument("--namespace", default=env("DRIVER_NAMESPACE",
                                              "tpu-dra-driver"))
    p.add_argument("--secret-name", default=env("TLS_SECRET_NAME",
                                                "tpu-dra-webhook-tls"))
    p.add_argument("--webhook-config", default=env("WEBHOOK_CONFIG",
                                                   "tpu-dra-webhook"))
    p.add_argument("--mode", choices=["create", "patch", "both"],
                   default=env("CERT_BOOTSTRAP_MODE", "both"))
    return p


def main(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s",
    )
    return run(RetryingKubeClient(KubeClient()), args.service,
               args.namespace, args.secret_name, args.webhook_config,
               mode=args.mode)


if __name__ == "__main__":
    sys.exit(main())
