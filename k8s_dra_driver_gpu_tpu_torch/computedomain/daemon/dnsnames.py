"""Stable daemon DNS names and the hosts-file rewrite (the JAX package's
``computedomain/daemon/dnsnames.py``; upstream ``dnsnames.go``).

Each clique index has a stable name (``compute-domain-daemon-%04d``); a
peer whose address changes only rewrites the managed block of the hosts
file, so replacing a node disrupts none of the others.
"""

from __future__ import annotations

import os

from .. import daemon_dns_name

HOSTS_MARKER_BEGIN = "# BEGIN tpu-compute-domain\n"
HOSTS_MARKER_END = "# END tpu-compute-domain\n"


def dns_name_mappings(nodes: list[dict]) -> dict[str, str]:
    """DNS name -> IP of every daemon of ``nodes`` (registrations, or a
    members.json's ``workers``) that has an index and an address."""
    out = {}
    for n in nodes:
        index = n.get("index", -1)
        ip = n.get("ipAddress", "")
        if index >= 0 and ip:
            out[daemon_dns_name(index)] = ip
    return out


def update_hosts_file(path: str, mappings: dict[str, str]) -> bool:
    """Rewrite the managed block of ``path`` to ``mappings``; whether the
    file changed."""
    try:
        with open(path, encoding="utf-8") as f:
            content = f.read()
    except FileNotFoundError:
        content = ""
    begin = content.find(HOSTS_MARKER_BEGIN)
    end = content.find(HOSTS_MARKER_END)
    if begin != -1 and end != -1:
        head = content[:begin]
        tail = content[end + len(HOSTS_MARKER_END):]
    else:
        head, tail = content, ""
        if head and not head.endswith("\n"):
            head += "\n"
    block = HOSTS_MARKER_BEGIN
    for name in sorted(mappings):
        block += f"{mappings[name]}\t{name}\n"
    block += HOSTS_MARKER_END
    new_content = head + block + tail
    if new_content == content:
        return False
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        f.write(new_content)
    os.replace(tmp, path)
    return True
