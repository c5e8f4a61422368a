"""Shared counters of a ResourceSlice (KEP-4815 partitionable devices)
for whole GPUs and MIG devices (the JAX package's
``kubeletplugin/partitions.py``; the upstream driver's
``partitions.go``, its per-GPU counter sets, ``:300-326``).

One counter set a GPU, ``gpu-<index>-counter-set``, holds:

- ``memory-slice-0`` .. ``memory-slice-7``, of value 1 each: the GPU's
  MIG memory slots;
- ``memory``: NVML's memory bytes of the GPU;
- ``multiprocessors``: the GPU's SMs, the largest MIG profile's (NVML's
  profile info); only where NVML gives the profiles, that is with MIG on.

A whole GPU consumes every counter of its set. A MIG device consumes the
memory slots of its placement, ``[start, start + size)``, and its
profile's SMs and memory bytes. So the scheduler can never place a
whole-GPU claim and a MIG claim, or two MIG devices whose placements
overlap, on one GPU; and MIG devices whose slots are disjoint but whose
SMs or memory together exceed the GPU's are refused too.

How this differs from the JAX layout (one set ``host-counters`` with
``core-<chip>-<core>`` and ``hbm-<chip>`` counters): a TPU chip's
TensorCores are its allocation grain, and a sub-slice takes whole cores.
An H100 has no counterpart of a core counter: its MIG placements are
runs of memory slots, and a memory slot is the nearest grain, so the
counters are per GPU and per slot.
"""

from __future__ import annotations

from ..tpulib.binding import GpuChip, GpuHostInfo, SubSliceProfile
from .deviceinfo import MIG_MEMORY_SLICES, AllocatableDevice


def counter_set_name(index: int) -> str:
    return f"gpu-{index}-counter-set"


def _multiprocessors(profiles: tuple[SubSliceProfile, ...]) -> int:
    return max((p.cores for p in profiles), default=0)


def _gpu_counters(chip: GpuChip, profiles: tuple[SubSliceProfile, ...]
                  ) -> dict[str, dict]:
    counters = {f"memory-slice-{k}": {"value": "1"}
                for k in range(MIG_MEMORY_SLICES)}
    counters["memory"] = {"value": str(chip.memory_bytes)}
    sms = _multiprocessors(profiles)
    if sms:
        counters["multiprocessors"] = {"value": str(sms)}
    return counters


def shared_counter_sets(host: GpuHostInfo,
                        profiles: tuple[SubSliceProfile, ...] = ()
                        ) -> list[dict]:
    """The ``sharedCounters`` block of a ResourceSlice: one set a GPU
    with a device node."""
    return [{"name": counter_set_name(chip.index),
             "counters": _gpu_counters(chip, profiles)}
            for chip in host.chips if chip.devpath]


def consumed_counters(dev: AllocatableDevice,
                      profiles: tuple[SubSliceProfile, ...] = ()
                      ) -> list[dict]:
    """The ``consumesCounters`` block of one device."""
    chip = dev.gpu
    if dev.subslice is None:
        counters = _gpu_counters(chip, profiles)
    else:
        prof = dev.subslice.profile
        counters = {f"memory-slice-{k}": {"value": "1"}
                    for k in dev.subslice.spec.memory_slices}
        counters["memory"] = {"value": str(prof.hbm_bytes)}
        if _multiprocessors(profiles):
            counters["multiprocessors"] = {"value": str(prof.cores)}
    return [{"counterSet": counter_set_name(chip.index),
             "counters": counters}]
