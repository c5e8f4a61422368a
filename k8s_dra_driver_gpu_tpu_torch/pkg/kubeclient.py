"""A Kubernetes REST client over the standard library, and an in-memory
fake with the same surface (the JAX package's ``pkg/kubeclient.py``; the
upstream driver's ``pkg/flags/kubeclient.go`` builds client sets from
the in-cluster config).

``KubeClient`` speaks CRUD on any group/version/resource path, JSON
merge patch, label and field selectors and ``/version``, and
maps HTTP 404 and 409 to ``NotFoundError`` and ``ConflictError``.
``FakeKubeClient`` keeps the objects in memory with the API server's
resourceVersion conflicts, selectors and merge patch; ``fakeapiserver``
serves it over HTTP.

Not ported: ``from_kubeconfig`` (it needs PyYAML, which the card's
machine lacks) and ``watch`` with the fake's watcher hooks (no module of
the port watches yet); both are queued in ROADMAP.md §1b. Nor the
reference's fault-injection seam in the watch loop, nor ``read_raw``
(pod logs), which no module of the port reads.
"""

from __future__ import annotations

import json
import os
import ssl
import threading
import urllib.error
import urllib.parse
import urllib.request

SERVICE_ACCOUNT_DIR = "/var/run/secrets/kubernetes.io/serviceaccount"


class KubeError(RuntimeError):
    def __init__(self, status: int, message: str):
        super().__init__(f"{status}: {message}")
        self.status = status


class NotFoundError(KubeError):
    def __init__(self, message: str = "not found"):
        super().__init__(404, message)


class ConflictError(KubeError):
    def __init__(self, message: str = "conflict"):
        super().__init__(409, message)


def _resource_path(group: str, version: str, resource: str,
                   namespace: str | None, name: str | None) -> str:
    base = f"/api/{version}" if not group else f"/apis/{group}/{version}"
    if namespace:
        base += f"/namespaces/{namespace}"
    base += f"/{resource}"
    if name:
        base += f"/{name}"
    return base


class KubeClient:
    """REST client over the API server: ``host``, else ``KUBE_API`` (a
    full URL), else the in-cluster ``KUBERNETES_SERVICE_HOST`` and
    ``_PORT`` over https; ``token`` and ``ca_cert``, else the service
    account's where they exist. (The JAX client's client-certificate and
    inline-CA arguments serve its kubeconfig path, not ported.)"""

    def __init__(self, host: str | None = None, token: str | None = None,
                 ca_cert: str | None = None):
        if host is None:
            host = os.environ.get("KUBE_API")
        if host is None:
            h = os.environ.get("KUBERNETES_SERVICE_HOST")
            p = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
            if not h:
                raise KubeError(0, "no API server host configured")
            host = f"https://{h}:{p}"
        self._host = host.rstrip("/")
        if token is None:
            token_path = os.path.join(SERVICE_ACCOUNT_DIR, "token")
            if os.path.exists(token_path):
                with open(token_path, encoding="utf-8") as f:
                    token = f.read().strip()
        self._token = token
        ctx: ssl.SSLContext | None = None
        if self._host.startswith("https"):
            ctx = ssl.create_default_context()
            ca = ca_cert or os.path.join(SERVICE_ACCOUNT_DIR, "ca.crt")
            if os.path.exists(ca):
                ctx.load_verify_locations(ca)
        self._ssl = ctx

    def _request(self, method: str, path: str, body: dict | None = None,
                 content_type: str = "application/json",
                 timeout: float = 30.0):
        data = json.dumps(body).encode() if body is not None else None
        req = urllib.request.Request(self._host + path, data=data,
                                     method=method)
        req.add_header("Accept", "application/json")
        if data is not None:
            req.add_header("Content-Type", content_type)
        if self._token:
            req.add_header("Authorization", f"Bearer {self._token}")
        try:
            with urllib.request.urlopen(req, timeout=timeout,
                                        context=self._ssl) as resp:
                payload = resp.read()
                return json.loads(payload) if payload else {}
        except urllib.error.HTTPError as e:
            msg = e.read().decode(errors="replace")
            if e.code == 404:
                raise NotFoundError(msg) from e
            if e.code == 409:
                raise ConflictError(msg) from e
            raise KubeError(e.code, msg) from e

    # Every verb takes a per-call ``timeout`` (seconds), so no call can
    # hold a thread for urllib's default.

    def get(self, group, version, resource, name, namespace=None,
            timeout: float = 30.0) -> dict:
        return self._request(
            "GET", _resource_path(group, version, resource, namespace, name),
            timeout=timeout)

    def list(self, group, version, resource, namespace=None,
             label_selector: str | None = None,
             field_selector: str | None = None,
             timeout: float = 30.0) -> list[dict]:
        path = _resource_path(group, version, resource, namespace, None)
        query = []
        if label_selector:
            query.append(
                f"labelSelector={urllib.parse.quote(label_selector)}")
        if field_selector:
            query.append(
                f"fieldSelector={urllib.parse.quote(field_selector)}")
        if query:
            path += "?" + "&".join(query)
        return self._request("GET", path, timeout=timeout).get("items", [])

    def create(self, group, version, resource, obj, namespace=None,
               timeout: float = 30.0) -> dict:
        return self._request(
            "POST", _resource_path(group, version, resource, namespace, None),
            body=obj, timeout=timeout)

    def update(self, group, version, resource, name, obj, namespace=None,
               timeout: float = 30.0) -> dict:
        return self._request(
            "PUT", _resource_path(group, version, resource, namespace, name),
            body=obj, timeout=timeout)

    def patch(self, group, version, resource, name, patch, namespace=None,
              timeout: float = 30.0) -> dict:
        """A JSON merge patch (RFC 7386): null deletes a key."""
        return self._request(
            "PATCH", _resource_path(group, version, resource, namespace,
                                    name),
            body=patch, content_type="application/merge-patch+json",
            timeout=timeout)

    def delete(self, group, version, resource, name, namespace=None,
               timeout: float = 30.0) -> None:
        """Deleting an absent object is not an error."""
        try:
            self._request(
                "DELETE",
                _resource_path(group, version, resource, namespace, name),
                timeout=timeout)
        except NotFoundError:
            pass

    def server_version(self, timeout: float = 30.0) -> dict:
        return self._request("GET", "/version", timeout=timeout)


def _copy(obj):
    return json.loads(json.dumps(obj))


def _selector(text: str | None) -> dict[str, str]:
    """``a=b,c=d`` as a dict (equality terms only)."""
    out = {}
    for part in (text or "").split(","):
        if part:
            key, _, value = part.partition("=")
            out[key] = value
    return out


def _field(obj: dict, dotted: str):
    cur = obj
    for seg in dotted.split("."):
        if not isinstance(cur, dict):
            return None
        cur = cur.get(seg)
    return cur


def _merge(dst: dict, src: dict) -> None:
    for k, v in src.items():
        if v is None:
            dst.pop(k, None)
        elif isinstance(v, dict) and isinstance(dst.get(k), dict):
            _merge(dst[k], v)
        else:
            dst[k] = v


class FakeKubeClient:
    """``KubeClient``'s surface over an in-memory store. ``version`` is
    what ``server_version()`` answers."""

    def __init__(self):
        # (group, resource, namespace or "", name) -> object
        self._store: dict[tuple, dict] = {}
        self._lock = threading.Lock()
        self._uid = 0
        self.version = {"major": "1", "minor": "34"}

    @staticmethod
    def _key(group, resource, namespace, name):
        return (group, resource, namespace or "", name)

    def objects(self, group=None, resource=None) -> list[dict]:
        with self._lock:
            return [v for (g, r, _, _), v in self._store.items()
                    if (group is None or g == group)
                    and (resource is None or r == resource)]

    # ``timeout`` is the real client's and is ignored here.

    def get(self, group, version, resource, name, namespace=None,
            timeout: float = 30.0) -> dict:
        with self._lock:
            obj = self._store.get(self._key(group, resource, namespace,
                                            name))
            if obj is None:
                raise NotFoundError(f"{resource}/{name}")
            return _copy(obj)

    def list(self, group, version, resource, namespace=None,
             label_selector: str | None = None,
             field_selector: str | None = None,
             timeout: float = 30.0) -> list[dict]:
        labels_wanted = _selector(label_selector)
        fields_wanted = _selector(field_selector)
        with self._lock:
            out = []
            for (g, r, ns, _), obj in self._store.items():
                if g != group or r != resource:
                    continue
                if namespace and ns != namespace:
                    continue
                labels = obj.get("metadata", {}).get("labels", {})
                if not all(labels.get(k) == v
                           for k, v in labels_wanted.items()):
                    continue
                if all(_field(obj, k) == v
                       for k, v in fields_wanted.items()):
                    out.append(_copy(obj))
            return out

    def create(self, group, version, resource, obj, namespace=None,
               timeout: float = 30.0) -> dict:
        name = obj.get("metadata", {}).get("name", "")
        key = self._key(group, resource, namespace, name)
        with self._lock:
            if key in self._store:
                raise ConflictError(f"{resource}/{name} exists")
            obj = _copy(obj)
            meta = obj.setdefault("metadata", {})
            if namespace:
                meta.setdefault("namespace", namespace)
            if not meta.get("uid"):
                self._uid += 1
                meta["uid"] = f"uid-{self._uid}"
            meta["resourceVersion"] = "1"
            self._store[key] = obj
            return _copy(obj)

    def update(self, group, version, resource, name, obj, namespace=None,
               timeout: float = 30.0) -> dict:
        """An update that carries a resourceVersion must carry the stored
        one (409 otherwise); one without is last-write-wins."""
        key = self._key(group, resource, namespace, name)
        with self._lock:
            if key not in self._store:
                raise NotFoundError(f"{resource}/{name}")
            old = self._store[key]
            obj = _copy(obj)
            meta = obj.setdefault("metadata", {})
            meta.setdefault("uid", old.get("metadata", {}).get("uid"))
            old_rv = old.get("metadata", {}).get("resourceVersion", "1")
            rv_in = meta.get("resourceVersion")
            if rv_in and rv_in != old_rv:
                raise ConflictError(
                    f"{resource}/{name}: resourceVersion {rv_in} is "
                    f"stale (current {old_rv})")
            meta["resourceVersion"] = str(int(old_rv) + 1)
            self._store[key] = obj
            return _copy(obj)

    def patch(self, group, version, resource, name, patch, namespace=None,
              timeout: float = 30.0) -> dict:
        """A merge patch; a resourceVersion inside it is a precondition
        (409 on a mismatch) and never rewinds the stored one."""
        key = self._key(group, resource, namespace, name)
        with self._lock:
            if key not in self._store:
                raise NotFoundError(f"{resource}/{name}")
            obj = self._store[key]
            stored_rv = obj.get("metadata", {}).get("resourceVersion", "1")
            patch = _copy(patch)
            rv_in = patch.get("metadata", {}).pop("resourceVersion", None)
            if rv_in is not None and str(rv_in) != stored_rv:
                raise ConflictError(
                    f"{resource}/{name}: resourceVersion {rv_in} is "
                    f"stale (current {stored_rv})")
            _merge(obj, patch)
            obj.setdefault("metadata", {})["resourceVersion"] = str(
                int(stored_rv) + 1)
            return _copy(obj)

    def delete(self, group, version, resource, name, namespace=None,
               timeout: float = 30.0) -> None:
        """Deleting a namespace deletes every object in it, as the
        namespace controller does."""
        with self._lock:
            obj = self._store.pop(self._key(group, resource, namespace,
                                            name), None)
            if obj is not None and resource == "namespaces" \
                    and not namespace:
                for k in [k for k in self._store if k[2] == name]:
                    del self._store[k]

    def server_version(self, timeout: float = 30.0) -> dict:
        return self.version

