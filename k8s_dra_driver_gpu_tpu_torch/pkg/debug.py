"""Every thread's stack at ``/debug/stacks``, and the wait for SIGTERM
of a binary (the JAX package's ``pkg/debug.py``; the upstream's
goroutine-stack dumps, internal/common/util.go:29-34). The JAX module's
SIGUSR1/SIGUSR2 dump handlers come with the entry points that install
them (ROADMAP.md §1b item 8)."""

from __future__ import annotations

import signal
import sys
import threading
import traceback


def format_thread_stacks() -> str:
    frames = sys._current_frames()
    out = []
    for thread in threading.enumerate():
        out.append(f"--- {thread.name} (ident {thread.ident}, "
                   f"daemon={thread.daemon}) ---\n")
        frame = frames.get(thread.ident)
        if frame is not None:
            out.append("".join(traceback.format_stack(frame)))
        out.append("\n")
    return "".join(out)


def debug_stacks_endpoint() -> tuple[int, str, bytes]:
    """Live thread stacks as text (the upstream mounts net/http/pprof on
    its diagnostics mux, compute-domain-controller main.go:383-390)."""
    return 200, "text/plain", format_thread_stacks().encode()


def wait_for_termination() -> None:
    """Block until SIGTERM or SIGINT. An Event set from the handler
    loses no signal that arrives between a check and a wait."""
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    stop.wait()
