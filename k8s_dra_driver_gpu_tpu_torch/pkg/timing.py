"""Per-segment wall time of one prepare or unprepare (the JAX package's
``pkg/timing.py``; the upstream driver's ``t_prep_*`` log segments).

The reference also opens a tracing span per segment and carries
fault-injection seams at each segment's start; neither is ported.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager

logger = logging.getLogger(__name__)


class SegmentTimer:
    """Named wall-time segments (seconds) of one operation on one key
    (a claim uid)."""

    def __init__(self, operation: str, key: str = ""):
        self.operation = operation
        self.key = key
        self.segments: dict[str, float] = {}
        self._start = time.monotonic()

    @contextmanager
    def segment(self, name: str):
        t0 = time.monotonic()
        try:
            yield
        finally:
            self.segments[name] = self.segments.get(name, 0.0) + (
                time.monotonic() - t0)

    def done(self) -> float:
        """Log the breakdown at debug level; returns the total seconds."""
        total = time.monotonic() - self._start
        if logger.isEnabledFor(logging.DEBUG):
            logger.debug("%s %s total=%.2fms %s", self.operation, self.key,
                         total * 1e3,
                         " ".join(f"t_{name}={dt * 1e3:.2f}ms" for name, dt
                                  in sorted(self.segments.items())))
        return total
