"""Multi-host gang support: rank hosts so gangs land ICI-adjacent (the
JAX package's ``pkg/topology/hosts.py``, the port's copy).

Hosts of one slice publish their position as the ``workerId`` device
attribute; ICI adjacency between hosts follows worker order (tpulib
assigns worker blocks along the slice grid, ``_chip_coords``). A gang
of N hosts therefore wants a run of N CONSECUTIVE worker ids -- the
host-level analog of a contiguous sub-torus.
"""

from __future__ import annotations


def rank_adjacent_hosts(host_workers: dict[str, int], gang_size: int
                        ) -> list[str]:
    """Order hosts so the best ICI-adjacent gang of ``gang_size`` comes
    first.

    Picks the window of ``gang_size`` hosts (in worker order) with the
    smallest worker-id span -- a tight window means physically adjacent
    hosts with no stranded worker inside the gang's ICI footprint.
    Remaining hosts follow in worker order, so a scheduler walking the
    list degrades gracefully when preferred hosts are full. Ties break
    toward the lowest worker id; a gang larger than the fleet just
    yields worker order.
    """
    hosts = sorted(host_workers, key=lambda h: (host_workers[h], h))
    if gang_size <= 1 or gang_size > len(hosts):
        return hosts
    best_start = 0
    best_span = None
    for start in range(len(hosts) - gang_size + 1):
        lo = host_workers[hosts[start]]
        hi = host_workers[hosts[start + gang_size - 1]]
        span = hi - lo
        if best_span is None or span < best_span:
            best_span = span
            best_start = start
    window = hosts[best_start:best_start + gang_size]
    rest = hosts[:best_start] + hosts[best_start + gang_size:]
    return window + rest
