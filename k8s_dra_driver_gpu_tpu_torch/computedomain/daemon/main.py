"""The ComputeDomain daemon: ``run`` and ``check`` (the JAX package's
``computedomain/daemon/main.py``; upstream
``cmd/compute-domain-daemon/main.go``).

    python -m k8s_dra_driver_gpu_tpu_torch.computedomain.daemon.main run
    python -m k8s_dra_driver_gpu_tpu_torch.computedomain.daemon.main check

Its identity comes from the env the CD plugin's daemon claim injects
(``COMPUTE_DOMAIN_UUID``, ``CLIQUE_ID``, ``COMPUTE_DOMAIN_NUM_WORKERS``,
``DOMAIN_STATE_DIR``, ...) and the pod's own (``NODE_NAME``, ``POD_IP``,
``POD_NAME``); the API server from ``KUBE_API`` or the in-cluster env
(``CD_DAEMON_STANDALONE=1``: an in-memory fake).

``run`` registers the node in its clique (``clique.py``), starts the
rendezvous service (``rendezvous.py``) under ``process.ProcessManager``
with its watchdog, and follows the registrations through an informer.
On each change it rewrites ``members.json`` and ``bootstrap.json`` in the
state dir, and the managed block of the hosts file. With the
``DomainDaemonsWithDNSNames`` gate (the default) it then nudges the
running service with SIGUSR1, after it answers STATUS (a signal during
the child's interpreter start would kill it); with the gate off it
restarts the service (the upstream's legacy IP mode). It reports itself
Ready while its service lives. SIGTERM deregisters the node and stops
the service. ``check`` asks the service for STATUS: exit 0 on READY.

``bootstrap.json`` is what a workload reads (``entry._read_bootstrap``):
the coordinator at the stable DNS name of index 0 and the JAX
coordinator port, this node's process id, the positional worker names,
``scope: clique``. ``members.json`` resolves those names.

Not ported: the JAX daemon's retrying client, its logging setup and
startup banner.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import signal
import sys
import threading
import time

from ...pkg.featuregates import (COMPUTE_DOMAIN_CLIQUES,
                                 DOMAIN_DAEMONS_WITH_DNS_NAMES, FeatureGates)
from ...pkg.informer import Informer
from ...pkg.kubeclient import FakeKubeClient, KubeClient
from .. import (API_GROUP, API_VERSION, CLIQUE_POD_LABEL, DOMAIN_DAEMON_PORT,
                JAX_COORDINATOR_PORT, daemon_dns_name)
from .clique import CliqueRegistrar, LegacyStatusRegistrar
from .dnsnames import dns_name_mappings, update_hosts_file
from .process import ProcessManager
from .rendezvous import query

logger = logging.getLogger(__name__)

# Registrations arrive through the informer; the resync is the fallback
# for a watch gap. The liveness tick bounds how fast a dead service turns
# the daemon NotReady (a child's death is no watch event).
RESYNC_INTERVAL_S = 15.0
LIVENESS_INTERVAL_S = 2.0
RENDEZVOUS_MODULE = ("k8s_dra_driver_gpu_tpu_torch.computedomain.daemon."
                     "rendezvous")


class DaemonConfig:
    """Identity and paths from the env."""

    def __init__(self, env=os.environ):
        self.cd_uid = env.get("COMPUTE_DOMAIN_UUID", "")
        self.cd_name = env.get("COMPUTE_DOMAIN_NAME", "")
        self.cd_namespace = env.get("COMPUTE_DOMAIN_NAMESPACE", "default")
        self.clique_id = env.get("CLIQUE_ID", "0")
        self.node_name = env.get("NODE_NAME", os.uname().nodename)
        self.pod_ip = env.get("POD_IP", "127.0.0.1")
        self.pod_name = env.get("POD_NAME", "")
        self.num_workers = int(env.get("COMPUTE_DOMAIN_NUM_WORKERS", "1"))
        self.state_dir = env.get("DOMAIN_STATE_DIR", "/var/run/tpu-domain")
        self.hosts_file = env.get("HOSTS_FILE", "/etc/hosts")
        self.port = int(env.get("COORDINATION_PORT", str(DOMAIN_DAEMON_PORT)))
        # Advertised in bootstrap.json; bound by the workload's process 0.
        self.jax_port = int(env.get("JAX_COORDINATOR_PORT",
                                    str(JAX_COORDINATOR_PORT)))
        # The service's bind and probe address: all interfaces and
        # loopback by default; the pod IP where several daemons share a
        # network namespace.
        self.coordination_host = env.get("COORDINATION_HOST", "")
        self.driver_namespace = env.get("DRIVER_NAMESPACE", "tpu-dra-driver")
        self.standalone = env.get("CD_DAEMON_STANDALONE", "") == "1"
        gates = FeatureGates.parse(env.get("FEATURE_GATES", ""))
        self.use_cliques = gates.is_enabled(COMPUTE_DOMAIN_CLIQUES)
        self.dns_names = gates.is_enabled(DOMAIN_DAEMONS_WITH_DNS_NAMES)


class Daemon:
    def __init__(self, config: DaemonConfig, kube=None):
        self.cfg = config
        if kube is None:
            kube = FakeKubeClient() if config.standalone else KubeClient()
        self.kube = kube
        os.makedirs(config.state_dir, exist_ok=True)
        self.members_file = os.path.join(config.state_dir, "members.json")
        self.bootstrap_file = os.path.join(config.state_dir, "bootstrap.json")
        if config.use_cliques:
            self.registrar = CliqueRegistrar(
                self.kube, cd_uid=config.cd_uid, clique_id=config.clique_id,
                node_name=config.node_name, ip_address=config.pod_ip,
                namespace=config.driver_namespace)
            self._informer = Informer(
                self.kube, API_GROUP, API_VERSION, "computedomaincliques",
                namespace=config.driver_namespace,
                resync_period=RESYNC_INTERVAL_S)
        else:
            self.registrar = LegacyStatusRegistrar(
                self.kube, cd_uid=config.cd_uid, cd_name=config.cd_name,
                cd_namespace=config.cd_namespace,
                clique_id=config.clique_id, node_name=config.node_name,
                ip_address=config.pod_ip)
            self._informer = Informer(
                self.kube, API_GROUP, API_VERSION, "computedomains",
                namespace=config.cd_namespace,
                resync_period=RESYNC_INTERVAL_S)
        self._write_members([])  # there before the service starts
        repo = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__)))))
        child_env = dict(os.environ)
        child_env["PYTHONPATH"] = (
            repo + os.pathsep + child_env.get("PYTHONPATH", "")
        ).rstrip(os.pathsep)
        self.process = ProcessManager([
            sys.executable, "-m", RENDEZVOUS_MODULE,
            "--members-file", self.members_file,
            "--port", str(config.port),
            "--host", config.coordination_host or "0.0.0.0",
            "--parent-pid", str(os.getpid()),
        ], env=child_env)
        self._stop = threading.Event()
        self._kick = threading.Event()
        self._last_members: list[dict] | None = None
        self._informer.add_event_hook(lambda *_: self._kick.set())

    # -- the domain dir ----------------------------------------------------

    def _write_json(self, path: str, doc: dict) -> None:
        tmp = path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(doc, f, indent=1)
        os.replace(tmp, path)

    def _write_members(self, members: list[dict]) -> None:
        self._write_json(self.members_file, {
            "computeDomain": self.cfg.cd_uid,
            "cliqueID": self.cfg.clique_id,
            "numWorkers": self.cfg.num_workers,
            "workers": members,
        })

    def _write_bootstrap(self, my_index: int) -> None:
        """The gang's contract for the workload. ``workerHostnames`` is
        positional by process id and ``num_workers`` long whatever subset
        has registered. The file is the clique's (``scope``): on a
        multi-slice domain the channel env is the global contract."""
        self._write_json(self.bootstrap_file, {
            "coordinatorAddress": f"{daemon_dns_name(0)}:{self.cfg.jax_port}",
            "numProcesses": self.cfg.num_workers,
            "processId": my_index,
            "workerHostnames": [daemon_dns_name(i)
                                for i in range(self.cfg.num_workers)],
            "scope": "clique",
            "cliqueID": self.cfg.clique_id,
        })

    def _label_own_pod(self) -> None:
        if not self.cfg.pod_name:
            return
        try:
            self.kube.patch(
                "", "v1", "pods", self.cfg.pod_name,
                {"metadata": {"labels": {
                    CLIQUE_POD_LABEL: self.cfg.clique_id}}},
                namespace=self.cfg.driver_namespace)
        except Exception:  # noqa: BLE001 - the label is advisory
            logger.exception("labeling own pod failed")

    # -- the loops ---------------------------------------------------------

    def sync_once(self) -> None:
        """One pass of the update loop: the registrations into the
        members file, the bootstrap file and the hosts file; then the
        service is nudged (DNS mode) or restarted (legacy IP mode)."""
        members = self.registrar.members()
        if members == self._last_members:
            return
        self._last_members = members
        self._write_members(members)
        if self.registrar.index is not None:
            self._write_bootstrap(self.registrar.index)
        try:
            update_hosts_file(self.cfg.hosts_file, dns_name_mappings(members))
        except OSError:
            logger.exception("hosts file update failed")
        if not self.cfg.dns_names and self.process.alive():
            self.process.restart()
            return
        self.process.ensure_started()
        try:
            query(self.cfg.coordination_host or "127.0.0.1", self.cfg.port,
                  "STATUS", timeout=1.0)
        except OSError:
            logger.info("coordination service not answering yet; no nudge")
        else:
            self.process.signal(signal.SIGUSR1)
        logger.info("membership: %d/%d worker(s)", len(members),
                    self.cfg.num_workers)

    def run(self) -> int:
        logger.info("compute-domain-daemon starting: cd=%s clique=%s node=%s",
                    self.cfg.cd_uid, self.cfg.clique_id, self.cfg.node_name)
        self._label_own_pod()
        index = self.registrar.register(status="NotReady")
        logger.info("registered as worker index %d", index)
        self.process.ensure_started()
        self.process.start_watchdog()
        self._informer.start()

        def terminate(*_):
            self._stop.set()
            self._kick.set()

        signal.signal(signal.SIGTERM, terminate)
        signal.signal(signal.SIGINT, terminate)

        ready_reported = False
        last_sync = 0.0
        try:
            while not self._stop.is_set():
                kicked = self._kick.wait(LIVENESS_INTERVAL_S)
                self._kick.clear()
                if self._stop.is_set():
                    break
                now = time.monotonic()
                try:
                    if kicked or now - last_sync >= RESYNC_INTERVAL_S:
                        last_sync = now
                        self.sync_once()
                    if self.process.alive() and not ready_reported:
                        self.registrar.set_status("Ready")
                        ready_reported = True
                        self._last_members = None  # sync our own Ready
                    elif not self.process.alive() and ready_reported:
                        self.registrar.set_status("NotReady")
                        ready_reported = False
                except Exception:  # noqa: BLE001 - the daemon goes on
                    logger.exception("sync failed")
                    last_sync = 0.0
        finally:
            self._informer.stop()
            self.registrar.deregister()
            self.process.stop()
        return 0


def check(config: DaemonConfig) -> int:
    """Exit 0 when the rendezvous service answers READY (upstream
    ``check``, main.go:435-459)."""
    try:
        answer = query(config.coordination_host or "127.0.0.1", config.port,
                       "STATUS")
    except OSError as e:
        print(f"NOT_READY ({e})")
        return 1
    print(answer)
    return 0 if answer == "READY" else 1


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="compute-domain-daemon")
    p.add_argument("command", choices=["run", "check"])
    p.add_argument("-v", "--verbosity", type=int,
                   default=int(os.environ.get("V", "4")),
                   help="log verbosity: 0 warnings, 1-5 info, 6 debug [V]")
    args = p.parse_args(argv)
    logging.basicConfig(
        level=(logging.DEBUG if args.verbosity >= 6 else
               logging.INFO if args.verbosity >= 1 else logging.WARNING),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    config = DaemonConfig()
    if args.command == "check":
        return check(config)
    return Daemon(config).run()


if __name__ == "__main__":
    sys.exit(main())
