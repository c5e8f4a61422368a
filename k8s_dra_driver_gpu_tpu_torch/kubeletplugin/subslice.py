"""MIG device names: spec tuples, live tuples and canonical names (the
JAX package's ``kubeletplugin/subslice.py``; the upstream driver's
``cmd/gpu-kubelet-plugin/mig.go``: ``MigSpecTuple`` (:37) is a parent,
profile and placement, ``MigLiveTuple`` (:68) adds the GPU- and
compute-instance ids and the UUID NVML handed back).

Names, in the upstream's style:

    gpu-<index>                            a whole GPU (``deviceinfo``)
    gpu-<index>-mig-<profile>-<start>      a MIG device, e.g.
                                           gpu-0-mig-1g10gb-0

A ResourceSlice device name is an RFC 1123 label (at most 63 characters
of ``[a-z0-9-]``), so the profile's ``.`` (``1g.10gb``) is dropped from
the name; the profile's own name is the device's ``profile`` attribute.
``start`` is the memory slot (of 8) the placement starts at, as NVML
numbers it. Every MIG profile nests under its parent GPU, so there are
no host-level names like the JAX plugin's ``ss-2x1x1-0``.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

from ..tpulib.binding import GpuHostInfo, MigInstance, SubSliceProfile

_MIG_RE = re.compile(r"^gpu-(\d+)-mig-(\d+)g(\d+)gb-(\d+)$")


@dataclass(frozen=True)
class SubSliceSpecTuple:
    """A MIG device as a placement: the parent GPU's index, the profile's
    name, the memory slot it starts at and the slots it takes."""

    gpu: int
    profile: str  # e.g. "1g.10gb"
    start: int
    size: int

    def canonical_name(self) -> str:
        return f"gpu-{self.gpu}-mig-{self.profile.replace('.', '')}-" \
               f"{self.start}"

    @property
    def memory_slices(self) -> range:
        return range(self.start, self.start + self.size)

    @classmethod
    def from_canonical_name(cls, name: str,
                            profiles: tuple[SubSliceProfile, ...]
                            ) -> "SubSliceSpecTuple | None":
        """The spec ``name`` names, its size from ``profiles``; None when
        it is no MIG name, or names a profile or start not offered."""
        parsed = parse_mig_name(name)
        if parsed is None:
            return None
        gpu, profile, start = parsed
        for prof in profiles:
            if prof.name == profile and start in prof.placements:
                return cls(gpu=gpu, profile=profile, start=start,
                           size=prof.memory_slices)
        return None


def parse_mig_name(name: str) -> tuple[int, str, int] | None:
    """(parent index, profile, start) of a MIG device name, or None."""
    m = _MIG_RE.match(name)
    if m is None:
        return None
    return int(m.group(1)), f"{m.group(2)}g.{m.group(3)}gb", int(m.group(4))


@dataclass(frozen=True)
class SubSliceLiveTuple:
    """A MIG device that exists: its spec and the instance ids and UUID
    NVML handed back."""

    spec: SubSliceSpecTuple
    gi_id: int
    ci_id: int
    uuid: str

    def to_dict(self) -> dict:
        return {"gpu": self.spec.gpu, "profile": self.spec.profile,
                "start": self.spec.start, "size": self.spec.size,
                "giId": self.gi_id, "ciId": self.ci_id, "uuid": self.uuid}

    @classmethod
    def from_dict(cls, d: dict) -> "SubSliceLiveTuple":
        return cls(spec=SubSliceSpecTuple(gpu=d["gpu"], profile=d["profile"],
                                          start=d["start"], size=d["size"]),
                   gi_id=d["giId"], ci_id=d["ciId"], uuid=d["uuid"])

    @classmethod
    def from_instance(cls, inst: MigInstance) -> "SubSliceLiveTuple":
        return cls(spec=SubSliceSpecTuple(gpu=inst.gpu, profile=inst.profile,
                                          start=inst.start, size=inst.size),
                   gi_id=inst.gi_id, ci_id=inst.ci_id, uuid=inst.uuid)

    def instance(self) -> MigInstance:
        return MigInstance(gpu=self.spec.gpu, profile=self.spec.profile,
                           start=self.spec.start, size=self.spec.size,
                           gi_id=self.gi_id, ci_id=self.ci_id, uuid=self.uuid)


def enumerate_subslice_devices(host: GpuHostInfo,
                               profiles: tuple[SubSliceProfile, ...]
                               ) -> list[SubSliceSpecTuple]:
    """Every MIG device this host could hold: each GPU with a device node
    x each profile x each of its placements (the upstream's
    ``inspectMigProfilesAndPlacements``, ``nvlib.go:1202``)."""
    return [SubSliceSpecTuple(gpu=chip.index, profile=prof.name,
                              start=start, size=prof.memory_slices)
            for chip in host.chips if chip.devpath
            for prof in profiles for start in prof.placements]
