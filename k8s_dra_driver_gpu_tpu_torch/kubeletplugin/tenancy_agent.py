"""The per-claim-request tenancy agent (the JAX package's
``kubeletplugin/tenancy_agent.py``): the single admission point of an MPS
request's containers. A container that would pass the request's
``maxClients``, or whose memory would push the sum of the registered
clients' past ``hbmCapacityBytes`` (the GPU's memory), is DENIED; the
request's CDI ``createContainer`` hook (``tenancy_preflight``, the
native ``csrc/tenancy_preflight.cc``) then exits 1 and the runtime does
not start the container. MPS itself caps each client's memory, but
neither how many clients there are nor their sum.

Protocol, on the unix socket ``agent.sock`` in the agent's directory,
one newline-terminated request a connection::

  STATUS                          -> "READY"
  REGISTER <client> <hbm_bytes>   -> "OK <granted>" | "DENIED <reason>"
  RELEASE <client>                -> "OK released"
  MEMBERS                         -> JSON {clients: {id: hbm}, ...}

The manifest is ``tenancy.json``; the grants are kept in ``clients.json``
(written atomically), so an agent started again enforces the earlier
grants. A poststop hook that cannot reach the agent leaves a tombstone
in ``released.d/``, which the agent applies at start and before each
admission.

The agent is a process of its own (the plugin supervises it with
``computedomain.daemon.process.ProcessManager``) and arms its own
parent-death signal: ``--parent-pid`` is the plugin's pid, and the agent
exits at once if its parent is no longer that process. It imports
neither ``torch`` nor anything that does: its start is part of a
prepare.
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

from ..pkg.fsutil import write_json_atomic

logger = logging.getLogger(__name__)

SOCKET_NAME = "agent.sock"
MANIFEST_NAME = "tenancy.json"
CLIENTS_NAME = "clients.json"
RELEASED_DIR = "released.d"
PR_SET_PDEATHSIG = 1  # <linux/prctl.h>


class TenancyState:
    """Admission against the manifest, with the grants persisted."""

    def __init__(self, tenancy_dir: str):
        self.dir = tenancy_dir
        self._lock = threading.Lock()
        self.manifest: dict = {}
        self.clients: dict[str, int] = {}
        self.reload()
        self._load_clients()
        self._apply_tombstones_locked()

    def reload(self) -> None:
        with open(os.path.join(self.dir, MANIFEST_NAME),
                  encoding="utf-8") as f:
            self.manifest = json.load(f)

    def _load_clients(self) -> None:
        try:
            with open(os.path.join(self.dir, CLIENTS_NAME),
                      encoding="utf-8") as f:
                self.clients = {k: int(v) for k, v in json.load(f).items()}
        except (OSError, ValueError):
            self.clients = {}

    def _save_clients(self) -> None:
        write_json_atomic(os.path.join(self.dir, CLIENTS_NAME),
                          json.dumps(self.clients))

    def _apply_tombstones_locked(self) -> None:
        """Release the clients that hooks recorded in ``released.d``
        while the agent was unreachable."""
        rd = os.path.join(self.dir, RELEASED_DIR)
        try:
            names = os.listdir(rd)
        except FileNotFoundError:
            return
        changed = False
        for name in names:
            if self.clients.pop(name, None) is not None:
                changed = True
            try:
                os.unlink(os.path.join(rd, name))
            except OSError:
                pass
        if changed:
            self._save_clients()

    def register(self, client: str, hbm_bytes: int) -> tuple[bool, str]:
        with self._lock:
            self._apply_tombstones_locked()
            max_clients = self.manifest.get("maxClients")
            capacity = self.manifest.get("hbmCapacityBytes")
            others = {k: v for k, v in self.clients.items() if k != client}
            if max_clients is not None and len(others) + 1 > int(max_clients):
                return False, f"max clients ({max_clients}) reached"
            if capacity is not None and \
                    hbm_bytes + sum(others.values()) > int(capacity):
                return False, (
                    f"HBM budget exceeded: {hbm_bytes} requested, "
                    f"{int(capacity) - sum(others.values())} available")
            self.clients[client] = hbm_bytes
            self._save_clients()
            return True, str(hbm_bytes)

    def release(self, client: str) -> None:
        with self._lock:
            if self.clients.pop(client, None) is not None:
                self._save_clients()

    def members(self) -> dict:
        with self._lock:
            return {"clients": dict(self.clients),
                    "maxClients": self.manifest.get("maxClients"),
                    "hbmCapacityBytes": self.manifest.get("hbmCapacityBytes")}


def _handle_line(state: TenancyState, line: str) -> str:
    parts = line.strip().split()
    if not parts:
        return "ERROR empty request"
    cmd = parts[0].upper()
    if cmd == "STATUS":
        return "READY"
    if cmd == "MEMBERS":
        return json.dumps(state.members())
    if cmd == "REGISTER":
        if len(parts) < 3:
            return "ERROR usage: REGISTER <client> <hbm_bytes>"
        if "/" in parts[1] or parts[1] in (".", ".."):
            return "ERROR invalid client id"
        try:
            hbm = int(parts[2])
        except ValueError:
            return "ERROR hbm_bytes must be an integer"
        ok, detail = state.register(parts[1], hbm)
        return f"OK {detail}" if ok else f"DENIED {detail}"
    if cmd == "RELEASE":
        if len(parts) < 2:
            return "ERROR usage: RELEASE <client>"
        state.release(parts[1])
        return "OK released"
    return f"ERROR unknown command {cmd}"


def serve(tenancy_dir: str) -> int:
    """Answer on ``agent.sock`` until SIGTERM or SIGINT; SIGUSR1 reloads
    the manifest."""
    state = TenancyState(tenancy_dir)
    sock_path = os.path.join(tenancy_dir, SOCKET_NAME)
    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass

    class Handler(socketserver.StreamRequestHandler):
        def handle(self):
            line = self.rfile.readline().decode(errors="replace")
            self.wfile.write((_handle_line(state, line) + "\n").encode())

    class Server(socketserver.ThreadingUnixStreamServer):
        daemon_threads = True

    server = Server(sock_path, Handler)
    stop = threading.Event()
    signal.signal(signal.SIGTERM, lambda *a: stop.set())
    signal.signal(signal.SIGINT, lambda *a: stop.set())
    signal.signal(signal.SIGUSR1, lambda *a: state.reload())
    # A short poll: a stop (unprepare) waits for the loop to notice.
    t = threading.Thread(target=server.serve_forever, daemon=True,
                         kwargs={"poll_interval": 0.02})
    t.start()
    logger.info("tenancy agent serving on %s", sock_path)
    stop.wait()
    server.shutdown()
    server.server_close()
    try:
        os.unlink(sock_path)
    except FileNotFoundError:
        pass
    return 0


def query(tenancy_dir: str, request: str, timeout: float = 2.0) -> str:
    """One request to the agent of ``tenancy_dir``; its answer. OSError
    when the agent cannot be reached."""
    sock_path = os.path.join(tenancy_dir, SOCKET_NAME)
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(sock_path)
        s.sendall((request + "\n").encode())
        chunks = []
        while True:
            b = s.recv(4096)
            if not b:
                break
            chunks.append(b)
            if b.endswith(b"\n"):
                break
    return b"".join(chunks).decode().strip()


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="gpu-tenancy-agent")
    p.add_argument("--dir", required=True, help="the agent's directory")
    p.add_argument("--parent-pid", type=int, required=True,
                   help="the supervising plugin's pid: the agent exits "
                   "when that process is no longer its parent")
    args = p.parse_args(argv)
    # Armed before the check, so a parent that dies in between is seen by
    # one of the two.
    ctypes.CDLL(None, use_errno=True).prctl(
        PR_SET_PDEATHSIG, signal.SIGTERM, 0, 0, 0)
    if os.getppid() != args.parent_pid:
        return 0
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    return serve(args.dir)


if __name__ == "__main__":
    sys.exit(main())
