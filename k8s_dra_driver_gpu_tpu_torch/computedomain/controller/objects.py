"""The objects the controller makes for each ComputeDomain (the JAX
package's ``computedomain/controller/objects.py``; upstream
``templates/compute-domain-daemon.tmpl.yaml`` rendered by
``daemonset.go:190-254``, and ``resourceclaimtemplate.go:304-398``).

Each carries the domain's uid under ``NODE_LABEL`` (the orphan GC reads
it) and an owner reference to the domain. The daemon's DaemonSet selects
the nodes that carry that label, which a channel prepare sets. The
daemon runs the port's module and the two templates carry the port's
config kinds (``api/decode.API_VERSION``) for its driver.
"""

from __future__ import annotations

import os

from ...api.decode import API_VERSION as CONFIG_API_VERSION
from .. import (API_GROUP, API_VERSION, CHANNEL_DEVICE_CLASS,
                COMPUTE_DOMAIN_DRIVER_NAME, DAEMON_DEVICE_CLASS,
                DOMAIN_DAEMON_PORT, NODE_LABEL)

DAEMON_IMAGE = "ghcr.io/tpu-dra-driver/compute-domain-daemon:latest"
DAEMON_MODULE = "k8s_dra_driver_gpu_tpu_torch.computedomain.daemon.main"


def daemonset_name(cd_uid: str) -> str:
    return f"computedomain-daemon-{cd_uid}"


def daemon_rct_name(cd_name: str) -> str:
    return f"{cd_name}-daemon-claim"


def build_daemon_daemonset(cd: dict, namespace: str) -> dict:
    """The domain's DaemonSet: a daemon on each node labeled with the
    domain's uid (upstream computedomain.go:312-364)."""
    uid = cd["metadata"]["uid"]
    return {
        "apiVersion": "apps/v1",
        "kind": "DaemonSet",
        "metadata": {
            "name": daemonset_name(uid),
            "namespace": namespace,
            "labels": {NODE_LABEL: uid},
            "ownerReferences": [_owner_ref(cd)],
        },
        "spec": {
            "selector": {"matchLabels": {NODE_LABEL: uid}},
            "template": {
                "metadata": {"labels": {NODE_LABEL: uid}},
                "spec": {
                    "nodeSelector": {NODE_LABEL: uid},
                    # The daemon registers the node's address, and the
                    # workload's process 0 binds the coordinator there.
                    "hostNetwork": True,
                    "dnsPolicy": "ClusterFirstWithHostNet",
                    "containers": [{
                        "name": "compute-domain-daemon",
                        "image": DAEMON_IMAGE,
                        "command": ["python", "-m", DAEMON_MODULE, "run"],
                        "env": [
                            {"name": "POD_IP", "valueFrom": {"fieldRef": {
                                "fieldPath": "status.podIP"}}},
                            {"name": "POD_NAME", "valueFrom": {"fieldRef": {
                                "fieldPath": "metadata.name"}}},
                            {"name": "NODE_NAME", "valueFrom": {"fieldRef": {
                                "fieldPath": "spec.nodeName"}}},
                            {"name": "DRIVER_NAMESPACE", "valueFrom": {
                                "fieldRef": {
                                    "fieldPath": "metadata.namespace"}}},
                            # The controller's own verbosity.
                            {"name": "V", "value": os.environ.get("V", "4")},
                        ],
                        "ports": [{"containerPort": DOMAIN_DAEMON_PORT,
                                   "name": "coordinator"}],
                        "startupProbe": _probe("startup"),
                        "readinessProbe": _probe("readiness"),
                        "livenessProbe": _probe("liveness"),
                        "resources": {"claims": [{"name": "daemon-claim"}]},
                    }],
                    "resourceClaims": [{
                        "name": "daemon-claim",
                        "resourceClaimTemplateName": daemon_rct_name(
                            cd["metadata"]["name"]),
                    }],
                },
            },
        },
    }


def _probe(kind: str) -> dict:
    """The upstream daemon's probe budgets
    (compute-domain-daemon.tmpl.yaml:74-100)."""
    exec_check = {"exec": {"command": ["python", "-m", DAEMON_MODULE,
                                       "check"]}}
    if kind == "startup":
        return {**exec_check, "periodSeconds": 1, "failureThreshold": 1200}
    if kind == "readiness":
        return {**exec_check, "periodSeconds": 10, "failureThreshold": 1}
    return {**exec_check, "periodSeconds": 60, "failureThreshold": 20}


def _claim_template(cd: dict, name: str, namespace: str, request: str,
                    device_class: str, parameters: dict) -> dict:
    return {
        "apiVersion": "resource.k8s.io/v1",
        "kind": "ResourceClaimTemplate",
        "metadata": {
            "name": name,
            "namespace": namespace,
            "labels": {NODE_LABEL: cd["metadata"]["uid"]},
            "ownerReferences": [_owner_ref(cd)],
        },
        "spec": {"spec": {"devices": {
            "requests": [{"name": request,
                          "exactly": {"deviceClassName": device_class}}],
            "config": [{
                "requests": [request],
                "opaque": {
                    "driver": COMPUTE_DOMAIN_DRIVER_NAME,
                    "parameters": {"apiVersion": CONFIG_API_VERSION,
                                   **parameters},
                },
            }],
        }}},
    }


def build_daemon_rct(cd: dict, namespace: str) -> dict:
    """The daemon's claim template: the daemon device class, a
    ComputeDomainDaemonConfig naming the domain."""
    return _claim_template(
        cd, daemon_rct_name(cd["metadata"]["name"]), namespace, "daemon",
        DAEMON_DEVICE_CLASS, {"kind": "ComputeDomainDaemonConfig",
                              "domainID": cd["metadata"]["uid"]})


def build_workload_rct(cd: dict) -> dict:
    """The workload's channel claim template, in the domain's own
    namespace under the name its spec gives (upstream
    resourceclaimtemplate.go:364-398)."""
    channel = cd.get("spec", {}).get("channel") or {}
    return _claim_template(
        cd, (channel.get("resourceClaimTemplate") or {}).get("name", ""),
        cd["metadata"].get("namespace", "default"), "channel",
        CHANNEL_DEVICE_CLASS, {
            "kind": "ComputeDomainChannelConfig",
            "domainID": cd["metadata"]["uid"],
            "allocationMode": channel.get("allocationMode", "Single")})


def _owner_ref(cd: dict) -> dict:
    return {
        "apiVersion": f"{API_GROUP}/{API_VERSION}",
        "kind": "ComputeDomain",
        "name": cd["metadata"]["name"],
        "uid": cd["metadata"]["uid"],
        "controller": True,
    }
