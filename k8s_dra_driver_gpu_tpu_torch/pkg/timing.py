"""Per-segment wall time of one prepare or unprepare (the JAX package's
``pkg/timing.py``; the upstream driver's ``t_prep_*`` log segments).

Tracing (``pkg/tracing.py``): a ``SegmentTimer`` opens an operation span,
parented under ``parent`` (a Span or a SpanContext, typically extracted
from the claim's traceparent annotation) or, without one, a root of its
own (sampling decides); every ``segment()`` is a child span of it, so
the instants of the debug log and the segment histogram also appear in
the trace. The operation span is exported at :meth:`done`.

The JAX timer's fault-injection seams are not ported: ``pkg/faults.py``
is queued in ROADMAP.md §1c.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

from . import tracing

logger = logging.getLogger(__name__)


class SegmentTimer:
    """Named wall-time segments (seconds) of one operation on one key
    (a claim uid)."""

    def __init__(self, operation: str, key: str = "", parent=None):
        self.operation = operation
        self.key = key
        self.segments: dict[str, float] = {}
        self._start = time.monotonic()
        self._span = tracing.start_span(
            operation, parent=parent,
            attrs={"claim_uid": key} if key else None)

    @property
    def trace_id(self) -> str:
        """The sampled trace id this operation records under, or ''."""
        return self._span.context.trace_id if self._span.recording else ""

    @contextmanager
    def segment(self, name: str):
        t0 = time.monotonic()
        try:
            with tracing.span(name, parent=self._span,
                              attrs={"claim_uid": self.key}
                              if self.key else None):
                yield
        finally:
            self.segments[name] = self.segments.get(name, 0.0) + (
                time.monotonic() - t0)

    def done(self) -> float:
        """Finish the operation span (with the segments' ms as
        attributes) and log the breakdown at debug level; returns the
        total seconds."""
        total = time.monotonic() - self._start
        if self._span.recording:
            self._span.set_attr("total_ms", round(total * 1e3, 3))
            for name, dt in self.segments.items():
                self._span.set_attr(f"t_{name}_ms", round(dt * 1e3, 3))
        self._span.finish()
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("%s %s total=%.2fms %s", self.operation, self.key,
                         total * 1e3,
                         " ".join(f"t_{name}={dt * 1e3:.2f}ms" for name, dt
                                  in sorted(self.segments.items())))
        return total
