"""DeviceState: the node's claim state machine for whole GPUs (the JAX
package's ``kubeletplugin/device_state.py``, its ``DeviceKind.CHIP``
path; the upstream driver's ``cmd/gpu-kubelet-plugin/device_state.go``).

Prepare is idempotent and two-phase: the durable PrepareStarted record
(the reservation, with the claim's device names) comes before any device
state, PrepareCompleted after the CDI spec; a failure in between rolls
both back (upstream ``:229-334``, ``:536``). Another claim's device is
refused (``:1212``); configs resolve class first, then claim, the later
winning (``:1138``).

What differs from the JAX plugin, on an H100 host:

- **Enumerate once.** ``__init__`` loads the port's ``tpulib`` (NVML; the
  mock or devfs backend with ``Config.backend="python"``), enumerates
  once and closes it. Prepare works from that snapshot and never asks
  NVML again, so it does not depend on what NVML answers later (a
  container's NVML may redact the UUID in some calls) and matches no GPU
  by UUID. A GPU whose minor number NVML refused has no device node to
  inject and is not published; a warning names it.
- **Whole GPUs only.** A claim config asking for sharing other than the
  default, sub-slices (MIG) or passthrough (vfio) raises
  ``NotPortedError`` at prepare, naming the ROADMAP.md item that ports
  it. There are no feature gates yet: they come with the first ported
  feature that reads one.
- **The claim's GPUs are its device nodes.** The spec injects each GPU's
  ``/dev/nvidia<minor>``; a container given only those nodes sees only
  those GPUs, numbered from 0. So the spec sets no
  ``CUDA_VISIBLE_DEVICES`` (the JAX plugin's ``TPU_VISIBLE_DEVICES``
  names host indices): host indices would name GPUs the container does
  not have, and the claim's own numbering would hide the GPUs of a
  second claim in the same pod, since CDI merges same-named env last
  wins. It sets ``CUDA_DEVICE_ORDER=PCI_BUS_ID``: CUDA numbers devices
  fastest first by default, and bus order is NVML's, so the container's
  GPU ``i`` is the claim's ``i``-th by NVML index.
- **One plugin process a node.** Every prepare and unprepare runs under
  the node lock (a ``Flock`` with a time limit), so a PrepareStarted
  record found by a prepare is a crashed prepare's and is rolled back.
  The JAX plugin's per-chip shard locks, reservation leases for an
  upgrade handover, fault-injection seams, tracing and flight recorder
  are not ported.
"""

from __future__ import annotations

import logging
import os
import time
from dataclasses import dataclass, field

from ..api.configs import GpuConfig
from ..api.decode import strict_decode
from ..pkg.flock import Flock
from ..pkg.timing import SegmentTimer
from ..tpulib.binding import EnumerateOptions, GpuHostInfo, load
from .cdi import CDIHandler, ContainerEdits
from .checkpoint import (CheckpointedClaim, CheckpointedDevice,
                         CheckpointManager, ClaimState)
from .claim import ResourceClaim
from .deviceinfo import AllocatableDevice, ChipInfo, DeviceKind

logger = logging.getLogger(__name__)

LOCK_TIMEOUT_S = 10.0

# What the JAX plugin runs and this one does not yet, by the ROADMAP.md
# §1b item that ports it.
_SHARING = "time-slicing and MPS sharing (ROADMAP.md §1b item 4, sharing.py)"
_MIG = "MIG devices (ROADMAP.md §1b item 5, sub-slices -> MIG)"
_VFIO = "vfio passthrough (ROADMAP.md §1b item 6, vfio.py)"
NOT_PORTED_KINDS = {"MigDeviceConfig": _MIG, "VfioDeviceConfig": _VFIO}


class PrepareError(RuntimeError):
    pass


class NotPortedError(PrepareError):
    """A claim asks for what the GPU plugin does not run yet."""


@dataclass
class Config:
    """Node plugin configuration. ``backend`` is ``tpulib.load``'s: None
    for NVML, "python" for the mock (``gpulib_opts.mock_topology``) or the
    devfs backend. The common device nodes are looked up under
    ``gpulib_opts.dev_root`` (default /dev)."""

    root: str  # state root: the checkpoint and the node lock
    gpulib_opts: EnumerateOptions = field(default_factory=EnumerateOptions)
    cdi_root: str | None = None
    boot_id: str | None = None
    backend: str | None = None

    @classmethod
    def mock(cls, root: str, topology: str = "h100-8") -> "Config":
        """A mock host of ``topology`` GPUs; its CDI specs under
        ``root/cdi`` and its device root ``root/dev`` (empty unless a
        test makes nodes there)."""
        return cls(root=root,
                   gpulib_opts=EnumerateOptions(
                       mock_topology=topology,
                       dev_root=os.path.join(root, "dev")),
                   cdi_root=os.path.join(root, "cdi"), backend="python")


class DeviceState:
    """Prepare and unprepare over this host's GPUs."""

    def __init__(self, config: Config):
        self._config = config
        os.makedirs(config.root, exist_ok=True)
        # The node lock: excludes other plugin processes and the other
        # threads of this one (upstream driver.go:46-47).
        self.pu_lock = Flock(os.path.join(config.root, "pu.lock"))
        lib = load(config.backend)
        try:
            self.host: GpuHostInfo = lib.enumerate(config.gpulib_opts)
        finally:
            close = getattr(lib, "close", None)
            if close is not None:
                close()
        self.allocatable = self._enumerate_allocatable()
        self._checkpoint = CheckpointManager(config.root,
                                             boot_id=config.boot_id)
        self._cdi = CDIHandler(
            cdi_root=config.cdi_root or os.path.join(config.root, "cdi"),
            dev_root=config.gpulib_opts.dev_root or "/dev")
        # The segments (seconds) of the last prepare or unprepare.
        self.last_segments: dict[str, float] = {}

    def _enumerate_allocatable(self) -> dict[str, AllocatableDevice]:
        out: dict[str, AllocatableDevice] = {}
        for chip in self.host.chips:
            if not chip.devpath:
                logger.warning(
                    "GPU %d (%s) has no device node (NVML refused its minor "
                    "number): not published", chip.index, chip.uuid)
                continue
            info = ChipInfo(chip=chip, host=self.host)
            out[info.canonical_name] = AllocatableDevice(
                kind=DeviceKind.CHIP, chip=info)
        return out

    def dra_devices(self) -> list[dict]:
        """The ResourceSlice devices of this node, in index order."""
        return [dev.to_dra_device() for dev in sorted(
            self.allocatable.values(), key=lambda d: d.chip.chip.index)]

    # -- prepare ---------------------------------------------------------

    def prepare(self, claim: ResourceClaim) -> list[str]:
        """Idempotent two-phase prepare; returns the claim's CDI device
        ids. A completed claim whose spec survived returns its ids; one
        whose spec is missing or truncated is prepared again."""
        timer = SegmentTimer("prepare", claim.uid)
        try:
            t0 = time.monotonic()
            with self.pu_lock.acquire(timeout=LOCK_TIMEOUT_S):
                timer.segments["prep_lock_wait"] = time.monotonic() - t0
                return self._prepare_locked(claim, timer)
        finally:
            self.last_segments = dict(timer.segments)
            timer.done()

    def _prepare_locked(self, claim: ResourceClaim,
                        timer: SegmentTimer) -> list[str]:
        with timer.segment("prep_get_checkpoint"):
            cp = self._checkpoint.get()
        existing = cp.claims.get(claim.uid)
        if existing is not None:
            if existing.state == ClaimState.PREPARE_COMPLETED.value:
                try:
                    spec_ok = self._cdi.read_spec(claim.uid) is not None
                except ValueError:
                    spec_ok = False
                if spec_ok:
                    return [i for d in existing.devices
                            for i in d.cdi_device_ids]
                logger.warning("claim %s completed but its CDI spec is "
                               "missing or corrupt; preparing again",
                               claim.uid)
            # A PrepareStarted record under the node lock is a crashed
            # prepare's: roll it back and start over.
            with timer.segment("prep_rollback_stale"):
                self._rollback(existing)
        self._validate_no_overlap(cp, claim)
        # Configs resolve before the PrepareStarted write: a bad config
        # fails without touching the checkpoint.
        self._resolve_configs(claim)
        reservation = CheckpointedClaim(
            uid=claim.uid, namespace=claim.namespace, name=claim.name,
            state=ClaimState.PREPARE_STARTED.value,
            devices=[CheckpointedDevice(canonical_name=r.device,
                                        kind=self._known_kind(r.device))
                     for r in claim.results])
        with timer.segment("checkpoint_write_started"):
            self._checkpoint.update_claim(claim.uid, reservation)
        try:
            with timer.segment("prep_devices"):
                prepared = self._prepare_devices(claim, timer)
        except BaseException:
            self._checkpoint.update_claim(claim.uid, None)
            raise
        completed = CheckpointedClaim(
            uid=claim.uid, namespace=claim.namespace, name=claim.name,
            state=ClaimState.PREPARE_COMPLETED.value, devices=prepared)
        with timer.segment("checkpoint_write_completed"):
            self._checkpoint.update_claim(claim.uid, completed)
        return [i for d in prepared for i in d.cdi_device_ids]

    def _known_kind(self, canonical_name: str) -> str:
        dev = self.allocatable.get(canonical_name)
        if dev is None:
            raise PrepareError(f"unknown device {canonical_name!r}")
        return dev.kind.value

    def _validate_no_overlap(self, cp, claim: ResourceClaim) -> None:
        """Refuse a device another claim holds, prepared or reserved
        (PrepareStarted): a scheduler race."""
        held = {dev.canonical_name: other.uid
                for other in cp.claims.values() if other.uid != claim.uid
                for dev in other.devices}
        for result in claim.results:
            if result.device in held:
                raise PrepareError(
                    f"device {result.device} overlaps with prepared claim "
                    f"{held[result.device]}")

    def _resolve_configs(self, claim: ResourceClaim) -> dict:
        """The config of each request: the last one that applies, class
        configs before claim configs; a default ``GpuConfig`` when none
        does. Normalized and validated; anything but the default sharing
        is refused (``NotPortedError``)."""
        ordered = [c for c in claim.configs if c.source == "FromClass"] + [
            c for c in claim.configs if c.source != "FromClass"]
        per_request: dict[str, GpuConfig] = {}
        for request in dict.fromkeys(r.request for r in claim.results):
            winner = None
            for oc in ordered:
                if oc.applies_to(request):
                    winner = oc
            if winner is None:
                cfg = GpuConfig()
            else:
                kind = winner.parameters.get("kind") \
                    if isinstance(winner.parameters, dict) else None
                if kind in NOT_PORTED_KINDS:
                    raise NotPortedError(
                        f"request {request!r}: config kind {kind}: "
                        f"{NOT_PORTED_KINDS[kind]} is not ported to the GPU "
                        "plugin yet")
                cfg = strict_decode(winner.parameters)
            cfg.normalize()
            cfg.validate()
            if not cfg.sharing.is_default:
                raise NotPortedError(
                    f"request {request!r}: sharing strategy "
                    f"{cfg.sharing.strategy} other than the default: "
                    f"{_SHARING} is not ported to the GPU plugin yet")
            per_request[request] = cfg
        return per_request

    def _prepare_devices(self, claim: ResourceClaim, timer: SegmentTimer
                         ) -> list[CheckpointedDevice]:
        """The CDI spec of the claim's GPUs; removed again if writing it
        fails."""
        prepared: list[CheckpointedDevice] = []
        device_edits: dict[str, ContainerEdits] = {}
        for result in claim.results:
            dev = self.allocatable[result.device]
            device_edits[result.device] = ContainerEdits(
                device_nodes=[dev.chip.chip.devpath])
            prepared.append(CheckpointedDevice(canonical_name=result.device,
                                               kind=dev.kind.value))
        common = self._cdi.common_edits(self.host)
        common.env.append("CUDA_DEVICE_ORDER=PCI_BUS_ID")
        try:
            with timer.segment("gen_write_cdi_spec"):
                ids = self._cdi.create_claim_spec_file(
                    claim.uid, device_edits, common)
        except BaseException:
            self._cdi.delete_claim_spec_file(claim.uid)
            raise
        by_name = dict(zip(sorted(device_edits), ids))
        for dev in prepared:
            dev.cdi_device_ids = [by_name[dev.canonical_name]]
        return prepared

    # -- unprepare -------------------------------------------------------

    def unprepare(self, claim_uid: str) -> None:
        """Idempotent: removes the claim's CDI spec and its checkpoint
        record; a claim never prepared (or already unprepared) is a
        no-op, apart from removing a stray spec."""
        timer = SegmentTimer("unprepare", claim_uid)
        try:
            t0 = time.monotonic()
            with self.pu_lock.acquire(timeout=LOCK_TIMEOUT_S):
                timer.segments["prep_lock_wait"] = time.monotonic() - t0
                existing = self._checkpoint.get().claims.get(claim_uid)
                if existing is None:
                    self._cdi.delete_claim_spec_file(claim_uid)
                    return
                with timer.segment("unprep_rollback"):
                    self._rollback(existing)
        finally:
            self.last_segments = dict(timer.segments)
            timer.done()

    def _rollback(self, checkpointed: CheckpointedClaim) -> None:
        """Remove what a claim holds: its CDI spec, then its record."""
        self._cdi.delete_claim_spec_file(checkpointed.uid)
        self._checkpoint.update_claim(checkpointed.uid, None)

    # -- introspection ---------------------------------------------------

    def prepared_claims(self) -> dict[str, CheckpointedClaim]:
        return self._checkpoint.get().claims
