"""A file lock (flock(2)) whose every acquire has a time limit (the JAX
package's ``pkg/flock.py``; the upstream driver's ``pkg/flock``).

The lock is taken with ``LOCK_EX | LOCK_NB`` in a poll loop, so a wait
ends at its ``timeout`` with ``FlockTimeoutError``; the kernel releases it
when the descriptor closes, so a crashed holder never wedges the node.
The reference's fault-injection seam is not ported.
"""

from __future__ import annotations

import fcntl
import os
import threading
import time


class FlockTimeoutError(TimeoutError):
    """The lock was not acquired within the timeout."""


class FlockReentrantError(RuntimeError):
    """The holding thread tried to take its own lock again: a lock-order
    fault in the caller, named at once instead of spinning until the
    timeout."""


class Flock:
    """An advisory lock on the file ``path``, exclusive across processes
    and across threads of this process::

        with Flock(path).acquire(timeout=10.0):
            ...
    """

    def __init__(self, path: str):
        self._path = path
        self._fd: int | None = None
        # flock(2) excludes other processes' descriptors only; this
        # excludes the other threads of this one.
        self._thread_lock = threading.Lock()
        self._owner: int | None = None

    @property
    def held(self) -> bool:
        return self._fd is not None

    def acquire(self, timeout: float,
                poll_interval: float = 0.01) -> "_FlockGuard":
        """Take the lock within ``timeout`` seconds, else raise
        ``FlockTimeoutError``; ``FlockReentrantError`` when this thread
        holds it already."""
        if self._owner == threading.get_ident():
            raise FlockReentrantError(
                f"thread {self._owner} already holds {self._path}; "
                "Flock is not re-entrant")
        deadline = time.monotonic() + timeout
        if not self._thread_lock.acquire(timeout=max(0.0, timeout)):
            raise FlockTimeoutError(
                f"timed out after {timeout}s acquiring {self._path}")
        try:
            os.makedirs(os.path.dirname(self._path) or ".", exist_ok=True)
            fd = os.open(self._path, os.O_CREAT | os.O_RDWR, 0o644)
        except BaseException:
            self._thread_lock.release()
            raise
        while True:
            try:
                fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except BlockingIOError:
                if time.monotonic() >= deadline:
                    os.close(fd)
                    self._thread_lock.release()
                    raise FlockTimeoutError(
                        f"timed out after {timeout}s acquiring "
                        f"{self._path}") from None
                time.sleep(poll_interval)
                continue
            except BaseException:
                os.close(fd)
                self._thread_lock.release()
                raise
            self._fd = fd
            self._owner = threading.get_ident()
            return _FlockGuard(self)

    def release(self) -> None:
        if self._fd is None:
            return
        try:
            fcntl.flock(self._fd, fcntl.LOCK_UN)
        finally:
            os.close(self._fd)
            self._fd = None
            self._owner = None
            self._thread_lock.release()


class _FlockGuard:
    def __init__(self, lock: Flock):
        self._lock = lock

    def __enter__(self) -> Flock:
        return self._lock

    def __exit__(self, *exc) -> None:
        self._lock.release()
