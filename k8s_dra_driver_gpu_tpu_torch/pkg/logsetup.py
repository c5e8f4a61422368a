"""The logging contract of every binary (the JAX package's
``pkg/logsetup.py``).

- the startup banner and config dump: always visible, even at verbosity
  0;
- 0: errors only; below 4: warnings;
- 4 (default): claim and domain lifecycle (INFO);
- 6: per-claim ``t_prep_*`` segment timings and other DEBUG detail.

Trace correlation (``pkg/tracing.py``): every record carries the active
span's ``trace_id`` and ``claim_uid`` (empty with no span), stamped by
:class:`TraceContextFilter`, so a trace id from ``/debug/traces`` finds
its log lines. ``FORMAT`` prints it as ``[trace=<id>]``.
"""

from __future__ import annotations

import logging

from . import tracing

FORMAT = ("%(asctime)s %(name)s %(levelname)s "
          "[trace=%(trace_id)s] %(message)s")


class TraceContextFilter(logging.Filter):
    """Stamps ``trace_id`` / ``claim_uid`` from the calling thread's
    active span onto every record (empty strings when none), so FORMAT
    can reference them and log lines correlate with traces for free.
    Attached to handlers by :func:`setup`; always passes the record."""

    def filter(self, record: logging.LogRecord) -> bool:
        sp = tracing.current_span()
        if sp is not None and sp.recording:
            record.trace_id = sp.context.trace_id
            record.claim_uid = str(sp.attrs.get("claim_uid", ""))
        else:
            record.trace_id = ""
            record.claim_uid = ""
        return True


def install_trace_filter() -> TraceContextFilter:
    """Attach the trace filter to every root-logger handler (idempotent
    per handler); returns the filter for callers wiring custom
    handlers."""
    filt = TraceContextFilter()
    for handler in logging.getLogger().handlers:
        if not any(isinstance(f, TraceContextFilter)
                   for f in handler.filters):
            handler.addFilter(filt)
    return filt


def level_for(verbosity: int) -> int:
    return (logging.ERROR if verbosity <= 0
            else logging.WARNING if verbosity < 4
            else logging.INFO if verbosity < 6
            else logging.DEBUG)


def setup(verbosity: int) -> None:
    logging.basicConfig(level=level_for(verbosity), format=FORMAT)
    install_trace_filter()


def startup_logger(name: str) -> logging.Logger:
    """A logger whose INFO records bypass the verbosity gate: records
    pass their ORIGINATING logger's level, and handlers default to
    NOTSET, so pinning this child to INFO keeps the startup config
    visible at verbosity 0."""
    lg = logging.getLogger(f"{name}.startup")
    lg.setLevel(logging.INFO)
    return lg


def log_startup(name: str, binary: str, version: str, args) -> None:
    """Banner and config dump (the upstream's pkg/flags/utils.go),
    visible at verbosity 0."""
    lg = startup_logger(name)
    lg.info("%s %s starting", binary, version)
    for key, val in sorted(vars(args).items()):
        lg.info("config %s=%r", key, val)
