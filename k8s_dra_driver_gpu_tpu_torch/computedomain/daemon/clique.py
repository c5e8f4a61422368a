"""The daemon's registration through the API server (the JAX package's
``computedomain/daemon/clique.py``; upstream ``cdclique.go`` and
``cdstatus.go``).

Each daemon writes ``{name, ipAddress, cliqueID, index, status}`` into a
ComputeDomainClique named ``<domain uid>.<clique id>``. Its index is the
one it had, else the first free one (cdclique.go:350); a write that
loses a resourceVersion race is retried. With the ComputeDomainCliques
gate off (legacy mode) the same entries go into the domain's own
``status.nodes`` (cdstatus.go:223-293).
"""

from __future__ import annotations

import logging
import time

from ...pkg.kubeclient import ConflictError, NotFoundError
from .. import API_GROUP, API_VERSION

logger = logging.getLogger(__name__)

CLIQUE_RESOURCE = "computedomaincliques"


def clique_name(cd_uid: str, clique_id: str) -> str:
    return f"{cd_uid}.{clique_id}"


class _EntryRegistrar:
    """First-free-index registration in a list some object holds; a
    subclass says which object and which list."""

    clique_id: str
    node_name: str
    ip_address: str

    def __init__(self):
        self.index: int | None = None

    def _fetch(self) -> dict:
        raise NotImplementedError

    def _persist(self, obj: dict) -> None:
        raise NotImplementedError

    def _entries(self, obj: dict) -> list[dict]:
        raise NotImplementedError

    def register(self, status: str = "NotReady", retries: int = 10) -> int:
        """Upsert this node's entry; its index."""
        for attempt in range(retries):
            obj = self._fetch()
            entries = self._entries(obj)
            mine = next((e for e in entries
                         if e.get("name") == self.node_name), None)
            if mine is None:
                used = {e.get("index") for e in entries}
                index = next(i for i in range(len(entries) + 1)
                             if i not in used)
                entries.append({"name": self.node_name,
                                "ipAddress": self.ip_address,
                                "cliqueID": self.clique_id,
                                "index": index, "status": status})
            else:
                mine["ipAddress"] = self.ip_address
                mine["status"] = status
                index = mine["index"]
            try:
                self._persist(obj)
                self.index = index
                return index
            except ConflictError:
                logger.info("registrar write conflict (attempt %d)",
                            attempt + 1)
                time.sleep(0.05 * (attempt + 1))
        raise RuntimeError(
            f"could not register {self.node_name} after {retries} attempts")

    def set_status(self, status: str) -> None:
        self.register(status=status)

    def members(self) -> list[dict]:
        """The entries by index."""
        try:
            obj = self._fetch()
        except NotFoundError:
            return []
        return sorted(self._entries(obj), key=lambda e: e.get("index", -1))

    def deregister(self) -> None:
        try:
            obj = self._fetch()
        except NotFoundError:
            return
        entries = self._entries(obj)
        entries[:] = [e for e in entries if e.get("name") != self.node_name]
        try:
            self._persist(obj)
        except (ConflictError, NotFoundError):
            pass


class CliqueRegistrar(_EntryRegistrar):
    """Entries in ``ComputeDomainClique.status.daemons``; the clique is
    created on first use."""

    def __init__(self, kube, cd_uid: str, clique_id: str, node_name: str,
                 ip_address: str, namespace: str = "tpu-dra-driver"):
        super().__init__()
        self.kube = kube
        self.cd_uid = cd_uid
        self.clique_id = clique_id
        self.node_name = node_name
        self.ip_address = ip_address
        self.namespace = namespace

    @property
    def name(self) -> str:
        return clique_name(self.cd_uid, self.clique_id)

    def _fetch(self) -> dict:
        try:
            return self.kube.get(API_GROUP, API_VERSION, CLIQUE_RESOURCE,
                                 self.name, namespace=self.namespace)
        except NotFoundError:
            obj = {
                "apiVersion": f"{API_GROUP}/{API_VERSION}",
                "kind": "ComputeDomainClique",
                "metadata": {"name": self.name, "namespace": self.namespace},
                "spec": {"computeDomainUID": self.cd_uid,
                         "cliqueID": self.clique_id},
                "status": {"daemons": []},
            }
            try:
                return self.kube.create(API_GROUP, API_VERSION,
                                        CLIQUE_RESOURCE, obj,
                                        namespace=self.namespace)
            except ConflictError:
                return self.kube.get(API_GROUP, API_VERSION, CLIQUE_RESOURCE,
                                     self.name, namespace=self.namespace)

    def _persist(self, obj: dict) -> None:
        self.kube.update(API_GROUP, API_VERSION, CLIQUE_RESOURCE, self.name,
                         obj, namespace=self.namespace)

    def _entries(self, obj: dict) -> list[dict]:
        return obj.setdefault("status", {}).setdefault("daemons", [])


class LegacyStatusRegistrar(_EntryRegistrar):
    """Legacy mode: entries in ``ComputeDomain.status.nodes``, the domain
    found by name and namespace."""

    def __init__(self, kube, cd_uid: str, cd_name: str, cd_namespace: str,
                 clique_id: str, node_name: str, ip_address: str):
        super().__init__()
        del cd_uid
        self.kube = kube
        self.cd_name = cd_name
        self.cd_namespace = cd_namespace
        self.clique_id = clique_id
        self.node_name = node_name
        self.ip_address = ip_address

    def _fetch(self) -> dict:
        return self.kube.get(API_GROUP, API_VERSION, "computedomains",
                             self.cd_name, namespace=self.cd_namespace)

    def _persist(self, obj: dict) -> None:
        self.kube.update(API_GROUP, API_VERSION, "computedomains",
                         self.cd_name, obj, namespace=self.cd_namespace)

    def _entries(self, obj: dict) -> list[dict]:
        return obj.setdefault("status", {}).setdefault("nodes", [])
