"""Claim-lifecycle tracing (the JAX package's ``pkg/tracing.py``).

Every hop of a claim gets a span: the kubelet plugin's prepare and its
segments, the CD plugin's channel prepare, the CD controller's
reconcile, the partition engine's attach and detach.

- **Span contexts** are W3C-traceparent compatible
  (``00-<32 hex trace>-<16 hex span>-<flags>``), so the id that crosses
  a process boundary is the standard header form.
- **Propagation** rides the claim itself: a scheduler stamps
  :data:`TRACEPARENT_ANNOTATION` onto the claim with its allocation, and
  every consumer ``extract()``\\ s it, so a node's prepare segments
  become children of the scheduler's commit span: one trace id end to
  end. (The port's ``pkg/scheduler.py`` stamps it; a claim without the
  annotation starts its own trace.)
- **Export is in-process and bounded**: a fixed-size ring served as JSON
  at ``/debug/traces`` (``pkg/metrics.MetricsServer``) plus an optional
  append-only JSONL file (``TPU_DRA_TRACE_FILE``, rotated at
  ``TPU_DRA_TRACE_FILE_MAX_MB`` into ``TPU_DRA_TRACE_FILE_KEEP`` files).
- **Sampling** (``TPU_DRA_TRACE_SAMPLE``, 0.0-1.0, default 1.0) is
  decided once at the trace root and inherited by every child, local or
  remote (the traceparent flags byte); unsampled spans are one shared
  no-op object: no ids, no export.

The env variables are the JAX package's. Use::

    with tracing.span("cd.reconcile", attrs={"claim_uid": uid}) as sp:
        ...
        header = sp.context.to_traceparent()

``start_span()`` is for a holder that outlives a lexical scope
(``SegmentTimer``'s operation span); it must be closed with ``finish()``.
"""

from __future__ import annotations

import json
import logging
import os
import random
import threading
import time
from collections import deque
from typing import NamedTuple

logger = logging.getLogger(__name__)

#: Claim annotation carrying the allocating scheduler's commit-span
#: context (W3C traceparent form); read by both kubelet plugins.
TRACEPARENT_ANNOTATION = "resource.tpu.dra/traceparent"

ENV_SAMPLE = "TPU_DRA_TRACE_SAMPLE"
ENV_TRACE_FILE = "TPU_DRA_TRACE_FILE"
ENV_TRACE_RING = "TPU_DRA_TRACE_RING"
# JSONL sink rotation: at max-MB the file rotates to <path>.1 (shifting
# .1 -> .2 ... up to keep-N, oldest dropped), so a long-lived sampled
# binary can never fill the disk. 0 MB = unbounded (the historical
# behavior); rotation errors disable the sink like write errors --
# never fail a traced op.
ENV_TRACE_FILE_MAX_MB = "TPU_DRA_TRACE_FILE_MAX_MB"
ENV_TRACE_FILE_KEEP = "TPU_DRA_TRACE_FILE_KEEP"
DEFAULT_TRACE_FILE_MAX_MB = 64.0
DEFAULT_TRACE_FILE_KEEP = 3

_VERSION = "00"
DEFAULT_RING_SPANS = 4096


class SpanContext(NamedTuple):
    """W3C-traceparent-compatible trace identity. (A NamedTuple, not a
    frozen dataclass: one is constructed per span on the allocation
    hot path, and frozen-dataclass __init__ costs ~3x.)"""

    trace_id: str  # 32 lowercase hex chars, nonzero
    span_id: str   # 16 lowercase hex chars, nonzero
    sampled: bool = True

    def to_traceparent(self) -> str:
        return (f"{_VERSION}-{self.trace_id}-{self.span_id}-"
                f"{'01' if self.sampled else '00'}")

    @classmethod
    def from_traceparent(cls, header: str) -> "SpanContext | None":
        """Parse a traceparent header; None on anything malformed (a
        bad annotation must never break a prepare)."""
        if not isinstance(header, str):
            return None
        parts = header.strip().split("-")
        if len(parts) != 4:
            return None
        version, trace_id, span_id, flags = parts
        if len(version) != 2 or len(trace_id) != 32 or \
                len(span_id) != 16 or len(flags) != 2:
            return None
        try:
            int(version, 16)
            int(flags, 16)
            if int(trace_id, 16) == 0 or int(span_id, 16) == 0:
                return None
        except ValueError:
            return None
        return cls(trace_id=trace_id.lower(), span_id=span_id.lower(),
                   sampled=bool(int(flags, 16) & 0x01))


def _new_trace_id() -> str:
    return f"{random.getrandbits(128) or 1:032x}"


def _new_span_id() -> str:
    return f"{random.getrandbits(64) or 1:016x}"


class Span:
    """One timed operation. Context-manager entry pushes it onto the
    calling thread's span stack (so nested ``span()`` calls and the
    logging filter see it); exit records the end time and exports."""

    __slots__ = ("name", "context", "parent_id", "start_ts",
                 "start_mono", "end_ts", "attrs", "events", "error",
                 "_finished", "_entered")

    def __init__(self, name: str, context: SpanContext,
                 parent_id: str = "", attrs: dict | None = None):
        self.name = name
        self.context = context
        self.parent_id = parent_id
        self.start_ts = time.time()
        self.start_mono = time.monotonic()
        self.end_ts: float | None = None
        self.attrs: dict = attrs if attrs is not None else {}
        self.events: list[dict] | None = None  # lazy (hot-path cost)
        self.error: str = ""
        self._finished = False
        self._entered = False

    # -- recording -----------------------------------------------------------

    @property
    def recording(self) -> bool:
        return self.context.sampled

    def set_attr(self, key: str, value) -> None:
        self.attrs[key] = value

    def event(self, name: str, **fields) -> None:
        if self.events is None:
            self.events = []
        self.events.append({"ts": time.time(), "name": name, **fields})

    def finish(self) -> None:
        """Record the end time and export. Idempotent; the normal path
        is the context-manager exit, ``finish()`` is for holders that
        outlive a lexical scope (SegmentTimer.done)."""
        if self._finished:
            return
        self._finished = True
        self.end_ts = time.time()
        if self.recording:
            exporter().export(self)

    def to_dict(self) -> dict:
        end = self.end_ts if self.end_ts is not None else time.time()
        out = {
            "name": self.name,
            "trace_id": self.context.trace_id,
            "span_id": self.context.span_id,
            "parent_id": self.parent_id,
            "start": self.start_ts,
            "duration_ms": round((end - self.start_ts) * 1e3, 3),
        }
        if self.attrs:
            out["attrs"] = self.attrs
        if self.events:
            out["events"] = self.events
        if self.error:
            out["error"] = self.error
        return out

    # -- context manager -----------------------------------------------------

    def __enter__(self) -> "Span":
        _stack().append(self)
        self._entered = True
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._entered:
            stack = _stack()
            if stack and stack[-1] is self:
                stack.pop()
            else:  # misnested exit: remove wherever it sits
                try:
                    stack.remove(self)
                except ValueError:
                    pass
            self._entered = False
        if exc is not None and not self.error:
            self.error = f"{type(exc).__name__}: {exc}"
        self.finish()


class _NoopSpan(Span):
    """Shared no-op span for unsampled traces: no ids, no export, no
    per-call allocation -- what keeps the hot path allocation-bound
    with sampling off."""

    _CTX = SpanContext(trace_id="0" * 32, span_id="0" * 16,
                       sampled=False)

    def __init__(self):
        super().__init__("noop", self._CTX)

    @property
    def recording(self) -> bool:
        return False

    def set_attr(self, key: str, value) -> None:
        pass

    def event(self, name: str, **fields) -> None:
        pass

    def finish(self) -> None:
        pass

    def __enter__(self) -> "Span":
        # The unsampled root still occupies the thread stack: nested
        # span() calls must inherit the root's NO decision, not see an
        # empty stack and re-roll sampling (which would export orphan
        # child traces at fractional rates). The shared object is safe
        # to push from many threads/nestings -- entry/exit are
        # symmetric appends/pops of plain references.
        _stack().append(self)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        stack = _stack()
        if stack and stack[-1] is self:
            stack.pop()


NOOP_SPAN = _NoopSpan()

_tls = threading.local()


def _stack() -> list:
    stack = getattr(_tls, "stack", None)
    if stack is None:
        stack = _tls.stack = []
    return stack


def current_span() -> Span | None:
    """The innermost active span on the calling thread, or None."""
    stack = getattr(_tls, "stack", None)
    return stack[-1] if stack else None


def sample_rate() -> float:
    try:
        rate = float(os.environ.get(ENV_SAMPLE, "1"))
    except ValueError:
        return 1.0
    return min(max(rate, 0.0), 1.0)


def _root_sampled() -> bool:
    rate = sample_rate()
    if rate >= 1.0:
        return True
    if rate <= 0.0:
        return False
    return random.random() < rate


def start_span(name: str, parent: Span | SpanContext | None = None,
               attrs: dict | None = None) -> Span:
    """Create (and start) a span WITHOUT entering it on the thread
    stack. The caller owns its lifecycle: use it as a context manager,
    or call ``finish()``. ``parent`` may be a Span, a SpanContext
    extracted from a remote carrier, or None (inherit the thread's
    current span; with none active, start a new sampled-or-not root).
    Outside the tracing and timing layer, use :func:`span`."""
    if parent is None:
        parent = current_span()
    if parent is None:
        if not _root_sampled():
            return NOOP_SPAN
        ctx = SpanContext(trace_id=_new_trace_id(),
                          span_id=_new_span_id(), sampled=True)
        return Span(name, ctx, parent_id="", attrs=attrs)
    parent_ctx = parent.context if isinstance(parent, Span) else parent
    if not parent_ctx.sampled:
        return NOOP_SPAN
    ctx = SpanContext(trace_id=parent_ctx.trace_id,
                      span_id=_new_span_id(), sampled=True)
    return Span(name, ctx, parent_id=parent_ctx.span_id, attrs=attrs)


def span(name: str, parent: Span | SpanContext | None = None,
         attrs: dict | None = None) -> Span:
    """The public with-guarded span API: creates a child of ``parent``
    (default: the thread's current span; a new root when none is
    active); the Span IS the context manager -- entry pushes it for
    the scope, exit exports. (A plain function, not a @contextmanager
    generator: this sits on the allocation hot path and the generator
    frame would double the per-span cost.)"""
    return start_span(name, parent=parent, attrs=attrs)


# -- propagation ---------------------------------------------------------------


def inject(sp: Span | SpanContext, carrier: dict) -> dict:
    """Write the traceparent annotation into ``carrier`` (an
    annotations dict) and return it."""
    ctx = sp.context if isinstance(sp, Span) else sp
    carrier[TRACEPARENT_ANNOTATION] = ctx.to_traceparent()
    return carrier


def extract(annotations: dict | None) -> SpanContext | None:
    """Read the traceparent annotation out of an annotations dict (or
    any object-metadata-shaped mapping); None when absent/invalid."""
    if not annotations:
        return None
    return SpanContext.from_traceparent(
        annotations.get(TRACEPARENT_ANNOTATION, ""))


def trace_id_of(annotations: dict | None) -> str:
    """The sampled trace id carried by an annotations dict, or ''
    (the SLO-histogram exemplar form)."""
    ctx = extract(annotations)
    return ctx.trace_id if ctx is not None and ctx.sampled else ""


# -- export --------------------------------------------------------------------


class TraceExporter:
    """Bounded in-process span ring + optional JSONL file sink.

    The ring is the ``/debug/traces`` source: a fixed number of the
    most recent finished spans, grouped by trace id on read. The JSONL
    path (``TPU_DRA_TRACE_FILE``) appends one span object per line for
    offline analysis; file errors disable the sink rather than ever
    failing a traced operation."""

    def __init__(self, max_spans: int = DEFAULT_RING_SPANS,
                 path: str | None = None,
                 max_file_bytes: int | None = None,
                 keep_files: int | None = None):
        self._lock = threading.Lock()
        self._ring: deque = deque(maxlen=max(16, int(max_spans)))
        self._path = path or None
        self._file_broken = False
        if max_file_bytes is None:
            max_file_bytes = int(_env_float(
                ENV_TRACE_FILE_MAX_MB, DEFAULT_TRACE_FILE_MAX_MB)
                * 1024 * 1024)
        self._max_file_bytes = max(0, int(max_file_bytes))
        if keep_files is None:
            keep_files = int(_env_float(ENV_TRACE_FILE_KEEP,
                                        DEFAULT_TRACE_FILE_KEEP))
        self._keep_files = max(1, int(keep_files))
        # Size tracked incrementally (stat once at startup for an
        # existing file): the sink must not pay a per-span stat.
        self._file_size = 0
        if self._path:
            try:
                self._file_size = os.path.getsize(self._path)
            except OSError:
                self._file_size = 0
        self.exported_total = 0

    def _rotate_locked(self) -> None:
        """Size cap hit: shift <path>.N-1 -> <path>.N (oldest dropped)
        and move the live file to <path>.1. Any error disables the
        sink -- identical policy to write errors, a traced op never
        fails."""
        for i in range(self._keep_files - 1, 0, -1):
            src = f"{self._path}.{i}"
            if os.path.exists(src):
                os.replace(src, f"{self._path}.{i + 1}")
        os.replace(self._path, f"{self._path}.1")
        self._file_size = 0

    def export(self, sp: Span) -> None:
        # The ring stores the (terminal, finished) Span object and
        # dict-ifies at READ time: to_dict costs ~2us and export sits
        # on the allocation hot path, while /debug/traces reads are
        # rare and human-paced.
        with self._lock:
            self._ring.append(sp)
            self.exported_total += 1
        if self._path and not self._file_broken:
            line = json.dumps(sp.to_dict(), sort_keys=True) + "\n"
            try:
                with self._lock:
                    if self._max_file_bytes and \
                            self._file_size >= self._max_file_bytes:
                        self._rotate_locked()
                    with open(self._path, "a", encoding="utf-8") as f:
                        f.write(line)
                    self._file_size += len(line)
            except OSError:
                self._file_broken = True
                logger.exception(
                    "trace JSONL sink %s failed; disabling", self._path)

    def spans(self) -> list[dict]:
        with self._lock:
            ring = list(self._ring)
        return [sp.to_dict() for sp in ring]

    def traces(self) -> dict[str, list[dict]]:
        """trace id -> spans sorted by start time."""
        out: dict[str, list[dict]] = {}
        for doc in self.spans():
            out.setdefault(doc["trace_id"], []).append(doc)
        for spans_ in out.values():
            spans_.sort(key=lambda d: d["start"])
        return out

    def trace(self, trace_id: str) -> list[dict]:
        return self.traces().get(trace_id, [])

    # -- /debug/traces endpoints (pkg/httpserver handler signatures) ----------

    def traces_endpoint(self) -> tuple[int, str, bytes]:
        body = json.dumps({"traces": self.traces()},
                          sort_keys=True).encode()
        return 200, "application/json", body

    def trace_endpoint(self, trace_id: str) -> tuple[int, str, bytes]:
        spans_ = self.trace(trace_id.strip("/"))
        if not spans_:
            return 404, "application/json", b'{"error": "unknown trace"}'
        body = json.dumps({"trace_id": trace_id, "spans": spans_},
                          sort_keys=True).encode()
        return 200, "application/json", body


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except ValueError:
        return default


def _ring_size() -> int:
    try:
        return int(os.environ.get(ENV_TRACE_RING, DEFAULT_RING_SPANS))
    except ValueError:
        return DEFAULT_RING_SPANS


_exporter: TraceExporter | None = None
_exporter_lock = threading.Lock()


def exporter() -> TraceExporter:
    """The process-wide exporter (every binary serves it at
    /debug/traces)."""
    global _exporter
    if _exporter is None:
        with _exporter_lock:
            if _exporter is None:
                _exporter = TraceExporter(
                    max_spans=_ring_size(),
                    path=os.environ.get(ENV_TRACE_FILE) or None)
    return _exporter


def set_exporter(exp: TraceExporter) -> TraceExporter:
    """Swap the process exporter (tests)."""
    global _exporter
    with _exporter_lock:
        _exporter = exp
    return exp
