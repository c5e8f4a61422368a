"""Per-segment wall time of one prepare or unprepare (the JAX package's
``pkg/timing.py``; the upstream driver's ``t_prep_*`` log segments).

Tracing (``pkg/tracing.py``): a ``SegmentTimer`` opens an operation span,
parented under ``parent`` (a Span or a SpanContext, typically extracted
from the claim's traceparent annotation) or, without one, a root of its
own (sampling decides); every ``segment()`` is a child span of it, so
the instants of the debug log and the segment histogram also appear in
the trace. The operation span is exported at :meth:`done`.

Fault seams, at the start of each segment and before its span exists
(so a crash at a segment never exports a half-open span), as the JAX
timer's: ``TPU_DRA_CRASH_AT_SEGMENT=<name>`` exits with 86 (the SIGKILL
analog), ``TPU_DRA_STALL_AT_SEGMENT=<name>`` sleeps
``TPU_DRA_STALL_SECONDS`` (default 5), and every segment is the fault
point ``segment:<name>`` of ``pkg/faults.py``.
"""

from __future__ import annotations

import logging
import os
import time
from contextlib import contextmanager

from . import faults, tracing

logger = logging.getLogger(__name__)

ENV_CRASH_AT = "TPU_DRA_CRASH_AT_SEGMENT"
ENV_STALL_AT = "TPU_DRA_STALL_AT_SEGMENT"
ENV_STALL_SECONDS = "TPU_DRA_STALL_SECONDS"


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
        if os.environ.get(ENV_CRASH_AT) == name:
            logger.warning("fault injection: crashing at segment %s", name)
            os._exit(86)
        if os.environ.get(ENV_STALL_AT) == name:
            time.sleep(float(os.environ.get(ENV_STALL_SECONDS, "5")))
        faults.fault_point(f"segment:{name}")
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
