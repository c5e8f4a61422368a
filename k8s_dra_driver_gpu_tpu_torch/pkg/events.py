"""Warning Events (the JAX package's ``pkg/events.py``), and the HTTP
statuses a client retries (its ``pkg/retry.py``'s
``RETRIABLE_STATUSES``; the retrying client and its circuit breaker are
not ported).

A deterministic ``event_name`` makes the create the dedupe: a repeat
gets 409 and is dropped, so an Event is created once. Emission is best
effort: the state change it reports goes on when the API server is down.
"""

from __future__ import annotations

from .kubeclient import KubeError

# Throttled, and the server-side errors a retry may cure.
RETRIABLE_STATUSES = frozenset({429, 500, 502, 503, 504})


def emit_warning_event(kube, *, event_name: str, namespace: str,
                       reason: str, message: str, involved_kind: str,
                       involved_name: str, involved_uid: str = "",
                       component: str) -> None:
    event = {
        "apiVersion": "v1",
        "kind": "Event",
        "metadata": {"name": event_name, "namespace": namespace},
        "type": "Warning",
        "reason": reason,
        "message": message,
        "involvedObject": {"kind": involved_kind, "name": involved_name,
                           "namespace": namespace, "uid": involved_uid},
        "source": {"component": component},
    }
    try:
        kube.create("", "v1", "events", event, namespace=namespace)
    except KubeError:
        pass  # already created, or the API server is down
