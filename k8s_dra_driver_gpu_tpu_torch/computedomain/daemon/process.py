"""Child-process supervisor (the JAX package's
``computedomain/daemon/process.py``; the upstream driver's
``cmd/compute-domain-daemon/process.go``): ``ProcessManager`` starts a
child, records its pid in a pidfile, kills a stale survivor of an earlier
supervisor before a start, stops it (SIGTERM, then SIGKILL after
``TERM_GRACE_S``) and, with its watchdog on, starts it again when it dies
unexpectedly, after ``RESTART_BACKOFF_S``. The ComputeDomain daemon runs
its rendezvous service under it (``main.py``), and the kubelet plugin its
tenancy agents (``kubeletplugin/sharing.py``).

What differs from the JAX package:

- **No ``preexec_fn``.** The JAX supervisor runs ``setsid`` and
  ``prctl(PR_SET_PDEATHSIG)`` in Python between fork and exec, and such a
  fork can deadlock in a process whose other threads hold locks (a
  pytest worker with gloo threads did). The child starts in a session of
  its own (``start_new_session=True``, which the C code of ``subprocess``
  does) and arms its parent-death signal itself at startup: the tenancy
  agent and the rendezvous service call ``prctl(PR_SET_PDEATHSIG,
  SIGTERM)`` and exit at once when their parent is no longer the pid on
  their command line.
- **One long-lived thread starts every child.** The kernel sends the
  parent-death signal when the *thread* that forked the child ends, not
  the process. A start made on a short-lived thread (a test's, a gRPC
  handler's) would have its child killed when that thread returns. So
  every start and restart of a manager runs on its supervisor thread,
  which lives from the first ``ensure_started`` to ``stop`` and is also
  the watchdog.
- **The stale child is recognised by ``identity``**, a prefix of its
  argv (the whole argv by default): an argv that carries the
  supervisor's own pid differs between two supervisors of one child.
"""

from __future__ import annotations

import logging
import os
import queue
import signal
import subprocess
import threading
import time
from concurrent.futures import Future

logger = logging.getLogger(__name__)

TERM_GRACE_S = 5.0
RESTART_BACKOFF_S = 1.0
# How often the watchdog looks at the child.
WATCH_INTERVAL_S = 0.1
_STOP = object()


def _gone(pid: int) -> bool:
    """Whether ``pid`` has exited. A zombie counts: it holds no socket or
    file, and it may be a child this process has not reaped."""
    try:
        with open(f"/proc/{pid}/stat", encoding="ascii",
                  errors="replace") as f:
            return f.read().rsplit(")", 1)[1].split()[0] == "Z"
    except (OSError, IndexError):
        return True


def kill_recorded(pidfile: str, identity: list[str],
                  spare: int | None = None) -> int | None:
    """Kill the process ``pidfile`` names if its argv starts with
    ``identity`` (a recycled pid is left alone) and it is not ``spare``:
    SIGTERM, SIGKILL after ``TERM_GRACE_S``, and return once it is gone.
    The pid killed, or None."""
    try:
        with open(pidfile, encoding="utf-8") as f:
            stale = int(f.read().strip())
    except (OSError, ValueError):
        return None
    if stale == spare:
        return None
    try:
        with open(f"/proc/{stale}/cmdline", "rb") as f:
            cmdline = f.read().split(b"\0")
    except OSError:
        return None
    want = [a.encode() for a in identity]
    if cmdline[:len(want)] != want:
        return None
    try:
        os.kill(stale, signal.SIGTERM)
    except OSError:
        return None
    logger.warning("terminating stale child pid %d from %s", stale, pidfile)
    deadline = time.monotonic() + TERM_GRACE_S
    while time.monotonic() < deadline:
        if _gone(stale):
            return stale
        time.sleep(0.01)
    try:
        os.kill(stale, signal.SIGKILL)
    except OSError:
        return stale
    logger.warning("stale child %d ignored SIGTERM; killed", stale)
    deadline = time.monotonic() + 1.0
    while time.monotonic() < deadline and not _gone(stale):
        time.sleep(0.01)
    return stale


class ProcessManager:
    def __init__(self, argv: list[str], env: dict | None = None,
                 pidfile: str | None = None,
                 identity: list[str] | None = None):
        self._argv = list(argv)
        self._env = env
        self._pidfile = pidfile
        self._identity = list(argv if identity is None else identity)
        self._proc: subprocess.Popen | None = None
        self._lock = threading.Lock()
        self._expected_exit = False
        self._watch = False
        # The supervisor thread, its request queue and its stop event.
        self._thread: threading.Thread | None = None
        self._requests: queue.SimpleQueue | None = None
        self._stopping: threading.Event | None = None

    # -- lifecycle ------------------------------------------------------------

    def ensure_started(self) -> None:
        """Start the child unless it runs. The start runs on the
        supervisor thread (started now if need be); what it raised is
        raised here."""
        with self._lock:
            if self._proc is not None and self._proc.poll() is None:
                return
            if self._thread is None:
                self._requests = queue.SimpleQueue()
                self._stopping = threading.Event()
                self._thread = threading.Thread(
                    target=self._supervise,
                    args=(self._requests, self._stopping),
                    name=f"supervisor-{os.path.basename(self._argv[0])}",
                    daemon=True)
                self._thread.start()
            requests = self._requests
        done: Future = Future()
        requests.put(done)
        done.result()

    def start_watchdog(self) -> None:
        """From now on, a child that exits unless ``stop`` ended it is
        started again."""
        self._watch = True

    def restart(self) -> None:
        """Stop the child and start it again (the start on the supervisor
        thread, as ever)."""
        with self._lock:
            self._expected_exit = True
            self._stop_locked()
        self.ensure_started()

    def signal(self, sig: int) -> None:
        """Send ``sig`` to the child if it runs."""
        with self._lock:
            if self._proc is not None and self._proc.poll() is None:
                self._proc.send_signal(sig)

    def stop(self) -> None:
        """Stop the child and the supervisor thread."""
        with self._lock:
            self._expected_exit = True
            self._watch = False
            self._stop_locked()
            thread, self._thread = self._thread, None
            requests, stopping = self._requests, self._stopping
        if thread is not None:
            stopping.set()
            requests.put(_STOP)
            thread.join(timeout=RESTART_BACKOFF_S + WATCH_INTERVAL_S + 5)

    def alive(self) -> bool:
        with self._lock:
            return self._proc is not None and self._proc.poll() is None

    @property
    def pid(self) -> int | None:
        with self._lock:
            return self._proc.pid if self._proc else None

    # -- internals ------------------------------------------------------------

    def _start_locked(self) -> None:
        self._expected_exit = False
        if self._pidfile:
            kill_recorded(self._pidfile, self._identity,
                          spare=self._proc.pid if self._proc else None)
        self._proc = subprocess.Popen(
            self._argv, env=self._env, stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, start_new_session=True)
        if self._pidfile:
            tmp = self._pidfile + ".tmp"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    f.write(str(self._proc.pid))
                os.replace(tmp, self._pidfile)
            except OSError:
                logger.warning("could not write pidfile %s", self._pidfile)
        logger.info("started %s (pid %d)", self._argv[0], self._proc.pid)

    def _stop_locked(self) -> None:
        proc = self._proc
        if proc is None or proc.poll() is not None:
            return
        proc.terminate()
        try:
            proc.wait(timeout=TERM_GRACE_S)
        except subprocess.TimeoutExpired:
            logger.warning("child %d ignored SIGTERM; killing", proc.pid)
            proc.kill()
            proc.wait()

    def _supervise(self, requests: queue.SimpleQueue,
                   stopping: threading.Event) -> None:
        """The supervisor thread: the starts ``ensure_started`` asks for,
        and the watchdog's restarts."""
        while True:
            try:
                request = requests.get(timeout=WATCH_INTERVAL_S)
            except queue.Empty:
                request = None
            if request is _STOP:
                return
            if request is not None:
                try:
                    with self._lock:
                        if self._proc is None or self._proc.poll() is not None:
                            self._start_locked()
                except Exception as e:  # noqa: BLE001 - raised by the caller
                    request.set_exception(e)
                else:
                    request.set_result(None)
                continue
            with self._lock:
                proc = self._proc
                dead = (self._watch and not self._expected_exit
                        and proc is not None and proc.poll() is not None)
            if not dead:
                continue
            logger.warning("%s (pid %d) exited %s unexpectedly; restarting",
                           self._argv[0], proc.pid, proc.returncode)
            if stopping.wait(RESTART_BACKOFF_S):
                return
            with self._lock:
                if self._expected_exit or self._proc is not proc:
                    continue
                try:
                    self._start_locked()
                except Exception:  # noqa: BLE001 - the watchdog goes on
                    logger.exception("restart of %s failed; trying again",
                                     self._argv[0])
