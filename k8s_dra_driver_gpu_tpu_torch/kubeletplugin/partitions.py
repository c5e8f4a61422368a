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
profile's SMs and memory bytes. An oversubscribed tenant partition
(``pkg/partition``, ``maxTenants`` > 1) consumes a tenant slot's share:
each memory slot of its placement is debited ``1000 // maxTenants``
thousandths (``"500m"`` for two tenants), ``memory`` the tenant's budget
and ``multiprocessors`` its SM share; so ``maxTenants`` tenants together
never consume more than the MIG instance, and a whole-GPU claim or an
overlapping MIG device cannot land beside a live tenant. An exclusive
partition (one slot) holds its whole MIG instance and consumes exactly
what its MIG device does, whatever its ``hbmFraction`` (where the JAX
plugin debits the budget: the instance's memory past the budget is no
other claim's either). So the scheduler can never place a
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
    """The ``consumesCounters`` block of one device; none for a
    passthrough GPU, as in the JAX plugin (prepare refuses it beside its
    whole GPU)."""
    chip = dev.gpu
    part = dev.partition
    if dev.passthrough is not None:
        return []
    if part is not None and part.oversubscribed:
        counters = {f"memory-slice-{k}": {
            "value": f"{part.tenant_slice_milli}m"}
            for k in part.spec.memory_slices}
        counters["memory"] = {"value": str(part.tenant_memory_bytes)}
        if _multiprocessors(profiles):
            counters["multiprocessors"] = {
                "value": str(part.tenant_multiprocessors)}
    elif part is None and dev.subslice is None:
        counters = _gpu_counters(chip, profiles)
    else:
        # A MIG device, or an exclusive partition over one.
        spec, prof = (part.spec, part.mig) if part is not None else (
            dev.subslice.spec, dev.subslice.profile)
        counters = {f"memory-slice-{k}": {"value": "1"}
                    for k in spec.memory_slices}
        counters["memory"] = {"value": str(prof.hbm_bytes)}
        if _multiprocessors(profiles):
            counters["multiprocessors"] = {"value": str(prof.cores)}
    return [{"counterSet": counter_set_name(chip.index),
             "counters": counters}]
