"""Filesystem helpers (the JAX package's ``pkg/fsutil.py``)."""

from __future__ import annotations

import os


def write_json_atomic(path: str, text: str) -> None:
    """Write the JSON ``text`` to a temporary file, fdatasync it and
    rename it over ``path``: a crash never leaves truncated JSON behind,
    and the data is durable before the rename makes it the file."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(text)
        f.flush()
        os.fdatasync(f.fileno())
    os.replace(tmp, path)


def stat_signature(path: str) -> tuple[int, int, int] | None:
    """(mtime_ns, size, inode) of a file, or None when it is absent: the
    key of a parse cache. Every atomic write lands as a fresh inode, so a
    rewrite of the same size within one mtime tick still misses."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_mtime_ns, st.st_size, st.st_ino)
