"""Shared counters of a ResourceSlice (KEP-4815 partitionable devices)
for whole GPUs (the JAX package's ``kubeletplugin/partitions.py``; the
upstream driver's ``partitions.go``).

The JAX layout, kept: one counter set ``host-counters`` for the host,
and per GPU ``i`` a counter ``core-<i>-0`` of value 1 and ``hbm-<i>`` of
NVML's memory bytes. A whole GPU consumes its own two counters. With
whole GPUs only, the counters bound nothing yet; they are what a MIG
device will share with its GPU. The MIG slice (ROADMAP.md §1b item 5)
will redesign them along the upstream's per-GPU counter sets (memory
slices and per-capacity counters, ``partitions.go:300-326``).
"""

from __future__ import annotations

from ..tpulib.binding import GpuHostInfo
from .deviceinfo import AllocatableDevice

COUNTER_SET = "host-counters"


def _gpu_counters(index: int, memory_bytes: int) -> dict[str, dict]:
    return {f"core-{index}-0": {"value": "1"},
            f"hbm-{index}": {"value": str(memory_bytes)}}


def shared_counter_sets(host: GpuHostInfo) -> list[dict]:
    """The ``sharedCounters`` block of a ResourceSlice."""
    counters: dict[str, dict] = {}
    for chip in host.chips:
        counters.update(_gpu_counters(chip.index, chip.memory_bytes))
    return [{"name": COUNTER_SET, "counters": counters}]


def consumed_counters(dev: AllocatableDevice) -> list[dict]:
    """The ``consumesCounters`` block of one device: a whole GPU takes
    its core and all its memory."""
    chip = dev.chip.chip
    return [{"counterSet": COUNTER_SET,
             "counters": _gpu_counters(chip.index, chip.memory_bytes)}]
