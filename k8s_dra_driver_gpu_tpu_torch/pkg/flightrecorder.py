"""Per-claim flight recorder: a bounded ring of lifecycle events (the
JAX package's ``pkg/flightrecorder.py``).

Traces (``pkg/tracing.py``) say how long each hop took; the flight
recorder says what happened to one claim, in order: prepare segment
breakdowns, prepare outcomes, channel prepares with their retries,
partition attaches and detaches, domain reconciles. It is always on (no
sampling: the ring is fixed-size and an event is one small dict append
under a lock).

Keys: producers record under the claim uid when they have it and under
``namespace/name`` before; an ``alias`` ties the two, and a query
matches either, so ``/debug/claims/<uid>`` and
``/debug/claims/<ns>/<name>`` both return the whole story. The CD
controller keys by the domain's uid the same way. Make events only
through :meth:`FlightRecorder.record`.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from dataclasses import dataclass, field

DEFAULT_CAPACITY = 4096


@dataclass(frozen=True)
class FlightEvent:
    """One structured lifecycle event (made by FlightRecorder.record)."""

    ts: float
    key: str
    event: str
    alias: str = ""
    trace_id: str = ""
    fields: dict = field(default_factory=dict)

    def to_dict(self) -> dict:
        out = {"ts": self.ts, "key": self.key, "event": self.event}
        if self.alias:
            out["alias"] = self.alias
        if self.trace_id:
            out["trace_id"] = self.trace_id
        if self.fields:
            out.update(self.fields)
        return out


class FlightRecorder:
    """Fixed-size ring of FlightEvents with a per-key view."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = threading.Lock()
        self._ring: deque[FlightEvent] = deque(
            maxlen=max(16, int(capacity)))
        self.recorded_total = 0

    def record(self, key: str, event: str, *, alias: str = "",
               trace_id: str = "", **fields) -> None:
        """Append one event. ``key`` is the claim UID (or ns/name when
        the UID is not known yet); ``alias`` the other identity when
        both are known; extra keyword fields become event payload."""
        if not key:
            return
        ev = FlightEvent(ts=time.time(), key=str(key), event=str(event),
                         alias=str(alias or ""),
                         trace_id=str(trace_id or ""), fields=fields)
        with self._lock:
            self._ring.append(ev)
            self.recorded_total += 1

    def events(self, key: str = "") -> list[dict]:
        """Events for one key, oldest first; everything when ``key`` is
        empty. Matching is identity-closed over aliases: a uid query
        also returns events recorded under the claim's ``ns/name``
        before the uid was known, because a later event carrying both
        identities ties them together."""
        with self._lock:
            ring = list(self._ring)
        if not key:
            return [ev.to_dict() for ev in ring]
        ids = {key}
        # Two passes reach a fixpoint for the two-identity (uid <->
        # ns/name) chains producers record; aliased events seen in
        # pass one pull their other identity's alias-less events in
        # pass two.
        for _ in range(2):
            for ev in ring:
                if ev.key in ids or (ev.alias and ev.alias in ids):
                    ids.add(ev.key)
                    if ev.alias:
                        ids.add(ev.alias)
        return [ev.to_dict() for ev in ring
                if ev.key in ids or (ev.alias and ev.alias in ids)]

    def keys(self) -> list[str]:
        with self._lock:
            return sorted({ev.key for ev in self._ring})

    def dump(self, key: str) -> str:
        """Human-readable timeline for one claim (what the CD plugin's
        gang abort puts in the log)."""
        events = self.events(key)
        if not events:
            return f"(no flight-recorder events for {key!r})"
        lines = []
        for ev in events:
            extra = {k: v for k, v in ev.items()
                     if k not in ("ts", "key", "event")}
            detail = " ".join(f"{k}={v}" for k, v in sorted(extra.items()))
            lines.append(f"  {ev['ts']:.3f} {ev['event']:<20} {detail}")
        return "\n".join(lines)

    # -- /debug/claims endpoints (pkg/httpserver handler signatures) ----------

    def claims_endpoint(self, rest: str) -> tuple[int, str, bytes]:
        """GET /debug/claims/<uid-or-ns/name>."""
        key = rest.strip("/")
        if not key:
            body = json.dumps({"claims": self.keys()}).encode()
            return 200, "application/json", body
        events = self.events(key)
        if not events:
            return (404, "application/json",
                    b'{"error": "no events for key"}')
        body = json.dumps({"key": key, "events": events},
                          sort_keys=True).encode()
        return 200, "application/json", body

    def index_endpoint(self) -> tuple[int, str, bytes]:
        """GET /debug/claims -- the keys currently in the ring."""
        body = json.dumps({"claims": self.keys()}).encode()
        return 200, "application/json", body


_default: FlightRecorder | None = None
_default_lock = threading.Lock()


def default() -> FlightRecorder:
    """The process-wide recorder (served at /debug/claims)."""
    global _default
    if _default is None:
        with _default_lock:
            if _default is None:
                _default = FlightRecorder()
    return _default


def set_default(recorder: FlightRecorder) -> FlightRecorder:
    """Swap the process recorder (tests)."""
    global _default
    with _default_lock:
        _default = recorder
    return recorder
