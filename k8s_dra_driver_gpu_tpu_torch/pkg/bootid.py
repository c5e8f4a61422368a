"""The node's boot id, which invalidates a checkpoint written before a
reboot (the JAX package's ``pkg/bootid.py``; the upstream driver's
``pkg/bootid``)."""

from __future__ import annotations

BOOT_ID_PATH = "/proc/sys/kernel/random/boot_id"


def read_boot_id(path: str | None = None) -> str:
    """The boot id, or "" when it cannot be read: an empty id turns the
    reboot check off rather than failing start-up."""
    try:
        with open(path or BOOT_ID_PATH, encoding="utf-8") as f:
            return f.read().strip()
    except OSError:
        return ""
