"""The ComputeDomain reconciler (the JAX package's
``computedomain/controller/controller.py``; upstream
``cmd/compute-domain-controller/computedomain.go``, ``cdstatus.go`` and
``cleanup.go``).

For a domain that is not being deleted, ``reconcile`` adds the finalizer,
makes the daemon's claim template, the DaemonSet and the workload's
channel claim template (``objects.py``; each made once, a 409 is "there
already"), and writes the status: the daemons of every clique of the
domain, sorted by index, and ``Ready`` once there are as many as the
domain's nodes and all are Ready (``calculateGlobalStatus``,
computedomain.go:257). Without cliques (legacy mode: the daemons write
``status.nodes`` themselves) only the verdict is patched. For a domain
being deleted it tears down the templates, the DaemonSet, the cliques
and the node labels, then drops the finalizer. Unlike the JAX
controller it writes nothing once the finalizer is gone, so an API
server that keeps the object does not feed it its own events.
``cleanup_orphans`` deletes the DaemonSets and templates whose domain is
gone.

Events come from the client's watch (``FakeKubeClient``'s resource
watcher, or ``KubeClient.watch`` on the domains and the cliques) into a
keyed work queue (``pkg/workqueue.py``): a domain's event queues its
key, a clique's one "every domain" key, so a storm of registrations is
one reconcile. ``start`` also resyncs every ``resync_interval`` seconds;
``stop`` ends the watches, the resync and the queue.

Left out: the ``TopologyAwarePlacement`` window (the JAX controller's
``_host_workers`` and ``_sync_preferred_nodes``). It reads a
``workerId`` attribute of the chip driver's ResourceSlices that the
port's GPU slices do not publish, and without one the JAX controller
stamps no window either; its only reader is the JAX scheduler, which is
not ported.

Observability, at the JAX controller's hook points: each ``reconcile`` is
a ``cd.reconcile`` span (a root unless a span is active) and a
``cd_reconcile`` flight event keyed by the domain's uid, aliased by
``namespace/name``; with ``metrics`` (a ``ComputeDomainMetrics``) the
status pass sets ``tpu_compute_domain_status`` and
``tpu_compute_domain_nodes`` for the domain, and the teardown removes
both.
"""

from __future__ import annotations

import copy
import logging
import threading

from ...api.computedomain import ComputeDomainStatusValue
from ...pkg import flightrecorder, tracing
from ...pkg.kubeclient import ConflictError, NotFoundError
from ...pkg.workqueue import CONTROLLER_DEFAULT_LIMITER, WorkQueue
from .. import API_GROUP, API_VERSION, FINALIZER, NODE_LABEL, expected_workers
from .objects import (build_daemon_daemonset, build_daemon_rct,
                      build_workload_rct, daemon_rct_name, daemonset_name)

logger = logging.getLogger(__name__)

CD_RESOURCE = "computedomains"
CLIQUE_RESOURCE = "computedomaincliques"


class ComputeDomainController:
    _ALL_KEY = ("*", "*")  # reconcile every domain

    def __init__(self, kube, driver_namespace: str = "tpu-dra-driver",
                 metrics=None):
        self.kube = kube
        self.ns = driver_namespace
        self.metrics = metrics  # ComputeDomainMetrics | None
        self.queue = WorkQueue(limiter=CONTROLLER_DEFAULT_LIMITER,
                               name="cd-controller")
        self._stop = threading.Event()
        self._resync_interval = 30.0
        self._resync_thread: threading.Thread | None = None
        self._watches = []
        if hasattr(kube, "add_resource_watcher"):  # FakeKubeClient
            kube.add_resource_watcher(self._on_resource_event)
        else:
            for resource in (CD_RESOURCE, CLIQUE_RESOURCE):
                self._watches.append(kube.watch(
                    API_GROUP, API_VERSION, resource,
                    lambda ev_type, obj, r=resource:
                        self._on_resource_event(API_GROUP, r, "", ev_type,
                                                obj),
                    stop=self._stop))

    # -- lifecycle ---------------------------------------------------------

    def start(self, resync_interval: float = 30.0) -> None:
        self._resync_interval = resync_interval
        self.sync_all()
        self._resync_thread = threading.Thread(
            target=self._resync_loop, name="cd-resync", daemon=True)
        self._resync_thread.start()

    def stop(self) -> None:
        """End the watches, the resync and the queue; join their
        threads."""
        self._stop.set()
        if hasattr(self.kube, "remove_resource_watcher"):
            self.kube.remove_resource_watcher(self._on_resource_event)
        for watch in self._watches:
            watch.stop()
        if self._resync_thread is not None:
            self._resync_thread.join(timeout=5.0)
        self.queue.shutdown()

    def _resync_loop(self) -> None:
        while not self._stop.wait(self._resync_interval):
            try:
                self.sync_all()
            except Exception:  # noqa: BLE001 - the next resync converges
                logger.exception("resync failed")

    def _on_resource_event(self, group: str, resource: str, namespace: str,
                           ev_type: str, obj: dict) -> None:
        if self._stop.is_set():
            return
        if (group, resource) == (API_GROUP, CD_RESOURCE):
            key = (obj["metadata"].get("namespace", "default"),
                   obj["metadata"]["name"])
            self.queue.enqueue(key, self._reconcile_key)
        elif (group, resource) == (API_GROUP, CLIQUE_RESOURCE):
            self.queue.enqueue(self._ALL_KEY, self._reconcile_key)

    def sync_all(self) -> None:
        for cd in self._list_cds():
            key = (cd["metadata"].get("namespace", "default"),
                   cd["metadata"]["name"])
            self.queue.enqueue(key, self._reconcile_key)
        self.cleanup_orphans()

    def _list_cds(self) -> list[dict]:
        try:
            return self.kube.list(API_GROUP, API_VERSION, CD_RESOURCE)
        except Exception:  # noqa: BLE001
            logger.exception("listing ComputeDomains failed")
            return []

    def _reconcile_key(self, key) -> None:
        if key == self._ALL_KEY:
            for cd in self._list_cds():
                self.reconcile(cd)
            return
        namespace, name = key
        try:
            cd = self.kube.get(API_GROUP, API_VERSION, CD_RESOURCE, name,
                               namespace=namespace)
        except NotFoundError:
            return
        self.reconcile(cd)

    # -- reconcile ---------------------------------------------------------

    def reconcile(self, cd: dict) -> None:
        """One span and one flight event a pass, keyed by the domain's
        uid (``/debug/claims/<uid>`` finds it, as a claim's)."""
        meta = cd["metadata"]
        domain = f"{meta.get('namespace', 'default')}/{meta.get('name', '?')}"
        with tracing.span("cd.reconcile", attrs={
                "domain": domain, "claim_uid": meta.get("uid", "")}) as sp:
            flightrecorder.default().record(
                meta.get("uid", "") or meta.get("name", "?"),
                "cd_reconcile", alias=domain,
                trace_id=sp.context.trace_id if sp.recording else "",
                deleting=bool(meta.get("deletionTimestamp")))
            self._reconcile_inner(cd)

    def _reconcile_inner(self, cd: dict) -> None:
        meta = cd["metadata"]
        if meta.get("deletionTimestamp"):
            self._teardown(cd)
            return
        if FINALIZER not in meta.get("finalizers", []):
            # The caller's object may be shared: write a copy.
            cd = copy.deepcopy(cd)
            cd["metadata"].setdefault("finalizers", []).append(FINALIZER)
            cd = self.kube.update(API_GROUP, API_VERSION, CD_RESOURCE,
                                  meta["name"], cd,
                                  namespace=meta.get("namespace", "default"))
        self._ensure(build_daemon_rct(cd, self.ns), "resourceclaimtemplates",
                     "resource.k8s.io", "v1", self.ns)
        self._ensure(build_daemon_daemonset(cd, self.ns), "daemonsets",
                     "apps", "v1", self.ns)
        workload_rct = build_workload_rct(cd)
        if workload_rct["metadata"]["name"]:
            self._ensure(workload_rct, "resourceclaimtemplates",
                         "resource.k8s.io", "v1",
                         workload_rct["metadata"]["namespace"])
        self.update_global_status(cd)

    def _ensure(self, obj, resource, group, version, namespace) -> None:
        try:
            self.kube.create(group, version, resource, obj,
                             namespace=namespace)
        except ConflictError:
            pass  # made already; a domain's objects do not change

    # -- status ------------------------------------------------------------

    def update_global_status(self, cd: dict) -> None:
        """The cliques' daemons into the domain's status, with its
        verdict."""
        uid = cd["metadata"]["uid"]
        nodes: list[dict] = []
        any_clique = False
        for clique in self.kube.list(API_GROUP, API_VERSION, CLIQUE_RESOURCE):
            if clique.get("spec", {}).get("computeDomainUID") != uid:
                continue
            any_clique = True
            nodes.extend(clique.get("status", {}).get("daemons", []))
        # Legacy mode is the absence of cliques. A clique drained to no
        # daemons is not legacy mode: the domain must not stay Ready on
        # its stale node list.
        legacy = not any_clique
        if legacy:
            nodes = list(cd.get("status", {}).get("nodes", []))
        expected = expected_workers(cd.get("spec", {}))
        ready = (expected > 0 and len(nodes) >= expected
                 and all(n.get("status") == ComputeDomainStatusValue.READY
                         for n in nodes))
        verdict = (ComputeDomainStatusValue.READY if ready
                   else ComputeDomainStatusValue.NOT_READY)
        if legacy:
            # The daemons own status.nodes: patch the verdict alone, or
            # this write would race their registrations.
            status_patch: dict = {"status": verdict}
            changed = cd.get("status", {}).get("status") != verdict
        else:
            status_patch = {
                "status": verdict,
                "nodes": sorted(nodes, key=lambda n: n.get("index", -1)),
            }
            changed = cd.get("status") != status_patch
        if self.metrics is not None:
            ns = cd["metadata"].get("namespace", "default")
            name = cd["metadata"]["name"]
            self.metrics.status.labels(ns, name).set(1 if ready else 0)
            self.metrics.nodes.labels(ns, name).set(len(nodes))
        if not changed:
            return
        try:
            self.kube.patch(API_GROUP, API_VERSION, CD_RESOURCE,
                            cd["metadata"]["name"], {"status": status_patch},
                            namespace=cd["metadata"].get("namespace",
                                                         "default"))
        except NotFoundError:
            pass

    # -- teardown and orphans ----------------------------------------------

    def _teardown(self, cd: dict) -> None:
        """The workload's template, the daemon's, the DaemonSet, the
        cliques, the node labels, then the finalizer."""
        meta = cd["metadata"]
        uid = meta["uid"]
        channel = cd.get("spec", {}).get("channel") or {}
        rct = (channel.get("resourceClaimTemplate") or {}).get("name")
        if rct:
            self.kube.delete("resource.k8s.io", "v1",
                             "resourceclaimtemplates", rct,
                             namespace=meta.get("namespace", "default"))
        self.kube.delete("resource.k8s.io", "v1", "resourceclaimtemplates",
                         daemon_rct_name(meta["name"]), namespace=self.ns)
        self.kube.delete("apps", "v1", "daemonsets", daemonset_name(uid),
                         namespace=self.ns)
        for clique in self.kube.list(API_GROUP, API_VERSION, CLIQUE_RESOURCE):
            if clique.get("spec", {}).get("computeDomainUID") == uid:
                self.kube.delete(
                    API_GROUP, API_VERSION, CLIQUE_RESOURCE,
                    clique["metadata"]["name"],
                    namespace=clique["metadata"].get("namespace"))
        self._remove_node_labels(uid)
        if self.metrics is not None:
            ns = meta.get("namespace", "default")
            for gauge in (self.metrics.status, self.metrics.nodes):
                gauge.remove(ns, meta["name"])
        if FINALIZER not in meta.get("finalizers", []):
            return  # done already: no write, so no event to loop on
        finalizers = [f for f in meta.get("finalizers", []) if f != FINALIZER]
        try:
            self.kube.patch(API_GROUP, API_VERSION, CD_RESOURCE, meta["name"],
                            {"metadata": {"finalizers": finalizers or None}},
                            namespace=meta.get("namespace", "default"))
        except NotFoundError:
            pass

    def _remove_node_labels(self, cd_uid: str) -> None:
        """Upstream node.go RemoveComputeDomainLabels."""
        try:
            nodes = self.kube.list("", "v1", "nodes",
                                   label_selector=f"{NODE_LABEL}={cd_uid}")
        except Exception:  # noqa: BLE001
            return
        for node in nodes:
            self.kube.patch("", "v1", "nodes", node["metadata"]["name"],
                            {"metadata": {"labels": {NODE_LABEL: None}}})

    def cleanup_orphans(self) -> None:
        """Delete the DaemonSets and claim templates labeled with a domain
        that no longer exists (upstream cleanup.go)."""
        live_uids = {cd["metadata"]["uid"] for cd in self._list_cds()}
        for group, version, resource, ns in (
                ("apps", "v1", "daemonsets", self.ns),
                ("resource.k8s.io", "v1", "resourceclaimtemplates", None)):
            try:
                objs = self.kube.list(group, version, resource, namespace=ns)
            except Exception:  # noqa: BLE001
                continue
            for obj in objs:
                uid = obj.get("metadata", {}).get("labels", {}).get(
                    NODE_LABEL)
                if uid and uid not in live_uids:
                    logger.warning("GC orphan %s/%s (CD %s gone)", resource,
                                   obj["metadata"]["name"], uid)
                    self.kube.delete(
                        group, version, resource, obj["metadata"]["name"],
                        namespace=obj["metadata"].get("namespace"))
