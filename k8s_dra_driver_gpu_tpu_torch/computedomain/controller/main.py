"""The compute-domain-controller binary, with leader election (the JAX
package's ``computedomain/controller/main.py``; upstream
cmd/compute-domain-controller/main.go: its flags, Lease leader
election with release on cancel runWithLeaderElection :277-377, and the
metrics and pprof mux :379).

``--max-nodes-per-domain`` (``MAX_NODES_PER_DOMAIN``) is accepted for
compatibility and not enforced: the JAX controller does not enforce it
either, and no domain is refused for its size (ROADMAP.md, "Left out").

Run it as ``python -m k8s_dra_driver_gpu_tpu_torch.computedomain.
controller.main [--leader-election] [--kube-api URL] [--metrics-port N]``.
Without ``--kube-api`` (or ``KUBE_API``) the port's ``KubeClient`` takes
the in-cluster config (``KUBERNETES_SERVICE_HOST``, the service
account's token and CA); there is no kubeconfig file reader.
``--standalone`` runs over an in-memory ``FakeKubeClient``.

The startup sequence is the JAX binary's: logging, the startup banner,
``V`` exported, the metrics registry (build info, the ComputeDomain
gauges, the resilience counters of the ``RetryingKubeClient``), the
metrics listener, SIGTERM and SIGINT handlers, then leading. One
difference: the controller is built inside ``lead()``. Its watches start
at construction, so the JAX binary's standby replica also reconciles
what they deliver; here a standby only waits for the Lease. SIGTERM
ends leading (the controller stops, the Lease is released) and the
process exits 0.
"""

from __future__ import annotations

import argparse
import logging
import os
import signal
import sys
import threading

from ... import __version__
from ...pkg import logsetup
from ...pkg.kubeclient import FakeKubeClient, KubeClient
from ...pkg.leaderelection import LeaderElector
from ...pkg.metrics import (ComputeDomainMetrics, MetricsServer,
                            ResilienceMetrics, register_build_info)
from ...pkg.retry import RetryingKubeClient
from .controller import ComputeDomainController

logger = logging.getLogger(__name__)


def build_parser() -> argparse.ArgumentParser:
    env = os.environ.get
    p = argparse.ArgumentParser(prog="compute-domain-controller")
    p.add_argument("--namespace", default=env("DRIVER_NAMESPACE",
                                              "tpu-dra-driver"))
    p.add_argument("--max-nodes-per-domain", type=int,
                   default=int(env("MAX_NODES_PER_DOMAIN", "64")),
                   help="accepted for compatibility, not enforced: "
                        "no domain is refused for its size "
                        "[MAX_NODES_PER_DOMAIN]")
    p.add_argument("--metrics-port", type=int,
                   default=int(env("METRICS_PORT", "0")))
    p.add_argument("--leader-election", action="store_true",
                   default=env("LEADER_ELECTION", "") == "true")
    p.add_argument("--lease-name", default="tpu-dra-cd-controller")
    p.add_argument("--identity", default=env("POD_NAME", os.uname().nodename))
    p.add_argument("-v", "--verbosity", type=int,
                   default=int(env("V", "4")),
                   help="log verbosity (see pkg/logsetup.py) [V]")
    p.add_argument("--kube-api", default=env("KUBE_API", ""),
                   help="API server URL override [KUBE_API]")
    p.add_argument("--standalone", action="store_true")
    return p


def run(argv: list[str] | None = None) -> int:
    args = build_parser().parse_args(argv)
    logsetup.setup(args.verbosity)
    logsetup.log_startup(__name__, "compute-domain-controller",
                         __version__, args)
    # What this process renders (the daemons' DaemonSet) inherits the
    # verbosity: a -v flag wins over an inherited V.
    os.environ["V"] = str(args.verbosity)

    metrics = ComputeDomainMetrics()
    register_build_info(metrics.registry)
    resilience = ResilienceMetrics(registry=metrics.registry)
    kube = RetryingKubeClient(
        FakeKubeClient() if args.standalone else KubeClient(
            host=args.kube_api or None),
        metrics=resilience,
    )
    metrics_server = None
    if args.metrics_port > 0:
        metrics_server = MetricsServer(metrics.registry, host="0.0.0.0",
                                       port=args.metrics_port)
        metrics_server.start()

    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())

    def lead():
        controller = ComputeDomainController(kube, args.namespace,
                                             metrics=metrics)
        controller.start()
        logsetup.startup_logger(__name__).info(
            "%s leading: controller started", args.identity)
        stop.wait()
        controller.stop()

    if args.leader_election:
        elector = LeaderElector(
            kube, lease_name=args.lease_name, namespace=args.namespace,
            identity=args.identity,
        )
        elector.run(lead, stop)
    else:
        lead()
    if metrics_server:
        metrics_server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(run())
