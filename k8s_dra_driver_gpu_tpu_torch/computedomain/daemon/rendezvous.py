"""The rendezvous service the daemon supervises (the JAX package's
``computedomain/daemon/rendezvous.py``; in the upstream driver the IMEX
daemon holds this place).

A line protocol over TCP:

  STATUS\\n  -> READY\\n or NOT_READY\\n  (quorum: every expected worker
               registered and Ready; the daemon's ``check`` asks this)
  MEMBERS\\n -> the membership as one line of JSON
  WAIT <s>\\n -> READY\\n or TIMEOUT\\n  (a barrier with a deadline: it
               answers when quorum comes or after <s> seconds, at most
               ``MAX_WAIT_S``; a straggler gives TIMEOUT, never a hang)

The membership is the JSON file the daemon rewrites on a peer change;
SIGUSR1 reloads it without dropping a connection.

Run as a child of the daemon:

    python -m k8s_dra_driver_gpu_tpu_torch.computedomain.daemon.rendezvous \\
        --members-file F --port N [--host H] [--parent-pid P]

With ``--parent-pid`` the child arms its parent-death signal and exits at
once when its parent is no longer that process (the supervisor starts it
without ``preexec_fn``, ``process.py``). The JAX service's fault seam is
not ported.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import logging
import os
import signal
import socket
import socketserver
import sys
import threading
import time

logger = logging.getLogger(__name__)

# The longest a WAIT may ask for.
MAX_WAIT_S = 600.0
PR_SET_PDEATHSIG = 1  # <linux/prctl.h>


class MembershipState:
    def __init__(self, members_file: str):
        self._file = members_file
        self._lock = threading.Lock()
        self._doc: dict = {}
        # Notified on every reload, so a WAIT wakes on a change.
        self._changed = threading.Condition(self._lock)
        self.reload()

    def reload(self) -> None:
        try:
            with open(self._file, encoding="utf-8") as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError):
            doc = {}
        with self._lock:
            self._doc = doc
            self._changed.notify_all()
        logger.info("membership reloaded: %d/%s workers",
                    len(doc.get("workers", [])), doc.get("numWorkers", "?"))

    def snapshot(self) -> dict:
        with self._lock:
            return dict(self._doc)

    @staticmethod
    def _doc_ready(doc: dict) -> bool:
        expected = doc.get("numWorkers", 0)
        workers = doc.get("workers", [])
        return (expected > 0 and len(workers) >= expected
                and all(w.get("status") == "Ready" for w in workers))

    def ready(self) -> bool:
        return self._doc_ready(self.snapshot())

    def wait_ready(self, timeout: float) -> bool:
        """Block until quorum or the deadline; the state then."""
        deadline = time.monotonic() + min(max(timeout, 0.0), MAX_WAIT_S)
        with self._changed:
            while not self._doc_ready(self._doc):
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    return False
                self._changed.wait(min(remaining, 0.5))
            return True


class _Handler(socketserver.StreamRequestHandler):
    def handle(self) -> None:
        state: MembershipState = self.server.state  # type: ignore
        line = self.rfile.readline().decode(errors="replace").strip().upper()
        if line == "STATUS":
            self.wfile.write(b"READY\n" if state.ready() else b"NOT_READY\n")
        elif line == "MEMBERS":
            self.wfile.write((json.dumps(state.snapshot()) + "\n").encode())
        elif line.startswith("WAIT"):
            try:
                timeout = float(line.split(None, 1)[1])
            except (IndexError, ValueError):
                self.wfile.write(b"ERR bad WAIT timeout\n")
                return
            ok = state.wait_ready(timeout)
            self.wfile.write(b"READY\n" if ok else b"TIMEOUT\n")
        else:
            self.wfile.write(b"ERR unknown command\n")


class CoordinationService(socketserver.ThreadingTCPServer):
    allow_reuse_address = True
    daemon_threads = True

    def __init__(self, host: str, port: int, state: MembershipState):
        super().__init__((host, port), _Handler)
        self.state = state


def query(host: str, port: int, command: str, timeout: float = 3.0) -> str:
    """One command's answer line."""
    with socket.create_connection((host, port), timeout=timeout) as s:
        s.sendall(command.encode() + b"\n")
        data = s.makefile().readline()
    return data.strip()


def wait_for_quorum(host: str, port: int, deadline_s: float) -> bool:
    """True once the gang is READY, False when ``deadline_s`` passes
    first. A refused connection counts against the deadline and is
    retried: the service may still be starting."""
    deadline = time.monotonic() + deadline_s
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return False
        try:
            answer = query(host, port, f"WAIT {remaining:.3f}",
                           timeout=remaining + 2.0)
        except OSError:
            if time.monotonic() >= deadline:
                return False
            time.sleep(min(0.2, deadline_s / 10))
            continue
        if answer == "READY":
            return True
        if answer == "TIMEOUT":
            return False
        # A service without WAIT: poll STATUS for the rest of the budget.
        try:
            if query(host, port, "STATUS") == "READY":
                return True
        except OSError:
            pass
        time.sleep(min(0.2, deadline_s / 10))


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="coordination-service")
    p.add_argument("--members-file", required=True)
    p.add_argument("--port", type=int, default=7077)
    p.add_argument("--host", default="0.0.0.0")
    p.add_argument("--parent-pid", type=int, default=0,
                   help="the supervising daemon's pid: exit when that "
                   "process is no longer the parent")
    args = p.parse_args(argv)
    if args.parent_pid:
        # Armed before the check, so a parent that dies in between is
        # seen by one of the two.
        ctypes.CDLL(None, use_errno=True).prctl(
            PR_SET_PDEATHSIG, signal.SIGTERM, 0, 0, 0)
        if os.getppid() != args.parent_pid:
            return 0
    logging.basicConfig(level=logging.INFO)

    state = MembershipState(args.members_file)
    signal.signal(signal.SIGUSR1, lambda *a: state.reload())
    server = CoordinationService(args.host, args.port, state)
    # shutdown() blocks until serve_forever returns, so it runs on a
    # thread of its own, never on the serving one.
    signal.signal(signal.SIGTERM,
                  lambda *a: threading.Thread(target=server.shutdown).start())
    logger.info("coordination service on %s:%d", args.host, args.port)
    server.serve_forever(poll_interval=0.2)
    server.server_close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
