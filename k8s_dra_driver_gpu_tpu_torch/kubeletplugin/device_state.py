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
- **Whole GPUs, shared or not.** A claim config may ask for
  time-slicing at an interval (``TimeSlicingSettings``) or MPS
  (``MultiTenancySupport``), run by ``sharing.py``: ``nvidia-smi`` sets
  the GPU's timeslice, an MPS control daemon a claim request runs the
  clients; a gate that is off refuses its feature at prepare, as in the
  JAX plugin. An MPS request must be its claim's only request (the
  ``NotPortedError`` below): CDI merges same-named env, so two daemons'
  pipe directories would reach a container as one, and the clients of
  one daemon see only its GPUs. Sub-slices (MIG) and passthrough (vfio)
  raise ``NotPortedError`` at prepare, naming the ROADMAP.md item that
  ports them; so does, at construction, every gate but the two sharing
  ones when set away from its default (``NOT_PORTED_GATES``). A
  completed claim whose spec is lost while its MPS daemon runs is not
  prepared again (that would kill the daemon's clients): its prepare
  raises, and unprepare recovers it.
  Construction starts again the dead MPS daemons of completed claims and
  quits the others'; a boot id change drops the sharing records with the
  claims.
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
import shutil
import time
from dataclasses import dataclass, field

from ..api.configs import GpuConfig, Sharing
from ..api.decode import strict_decode
from ..pkg.featuregates import (MULTI_TENANCY_SUPPORT,
                                TIME_SLICING_SETTINGS, FeatureGates)
from ..pkg.flock import Flock
from ..pkg.timing import SegmentTimer
from ..tpulib.binding import EnumerateOptions, GpuHostInfo, load
from .cdi import CDIHandler, ContainerEdits, find_binary
from .checkpoint import (CheckpointedClaim, CheckpointedDevice,
                         CheckpointManager, ClaimState)
from .claim import ResourceClaim
from .deviceinfo import (AllocatableDevice, ChipInfo, DeviceKind,
                         parse_gpu_name)
from .sharing import (MPS_CONTROL, MultiTenancyManager, SharingError,
                      TimeSlicingManager)

logger = logging.getLogger(__name__)

LOCK_TIMEOUT_S = 10.0

# What the JAX plugin runs and this one does not yet, by the ROADMAP.md
# §1b item that ports it.
_MIG = "MIG devices (ROADMAP.md §1b item 5, sub-slices -> MIG)"
_VFIO = "vfio passthrough (ROADMAP.md §1b item 6, vfio.py)"
_CD = "the ComputeDomain daemon (ROADMAP.md §1b item 9, computedomain/)"
NOT_PORTED_KINDS = {"MigDeviceConfig": _MIG, "VfioDeviceConfig": _VFIO}
# Every gate but TimeSlicingSettings and MultiTenancySupport: refused
# when set away from its default.
NOT_PORTED_GATES = {
    "DynamicSubSlice": _MIG, "TenantPartitioning": _MIG,
    "PassthroughSupport": _VFIO,
    "DomainDaemonsWithDNSNames": _CD, "ComputeDomainCliques": _CD,
    "TopologyAwarePlacement": "topology-aware placement (the JAX package's "
    "scheduler and ComputeDomain controller, ROADMAP.md §1b item 9)",
    "ChipHealthCheck": "switching the health monitor by gate (the entry "
    "point's, ROADMAP.md §1b item 8; Driver(enable_health_monitor=) now)",
    "CrashOnICIFabricErrors": _CD,
    "DeviceMetadata": "device metadata (no module of the JAX package reads "
    "this gate either)",
}


class PrepareError(RuntimeError):
    pass


class NotPortedError(PrepareError):
    """A claim asks for what the GPU plugin does not run yet."""


@dataclass
class Config:
    """Node plugin configuration. ``backend`` is ``tpulib.load``'s: None
    for NVML, "python" for the mock (``gpulib_opts.mock_topology``) or the
    devfs backend. The common device nodes are looked up under
    ``gpulib_opts.dev_root`` (default /dev), the driver's libraries under
    ``driver_root``, which must be the host's path of the driver root as
    the plugin sees it (``CDIHandler``); so are ``nvidia-smi`` and MPS's
    control daemon (``cdi.find_binary``)."""

    root: str  # state root: the checkpoint, the node lock, sharing state
    gpulib_opts: EnumerateOptions = field(default_factory=EnumerateOptions)
    feature_gates: FeatureGates = field(default_factory=FeatureGates)
    cdi_root: str | None = None
    boot_id: str | None = None
    backend: str | None = None
    driver_root: str = "/"

    @classmethod
    def mock(cls, root: str, topology: str = "h100-8",
             gates: str = "") -> "Config":
        """A mock host of ``topology`` GPUs; its CDI specs under
        ``root/cdi`` and its device root ``root/dev`` (empty unless a
        test makes nodes there); ``gates`` as ``FEATURE_GATES`` takes
        them."""
        return cls(root=root,
                   gpulib_opts=EnumerateOptions(
                       mock_topology=topology,
                       dev_root=os.path.join(root, "dev")),
                   feature_gates=FeatureGates.parse(gates),
                   cdi_root=os.path.join(root, "cdi"), backend="python")


class DeviceState:
    """Prepare and unprepare over this host's GPUs."""

    def __init__(self, config: Config):
        self._config = config
        for gate in config.feature_gates.unported():
            raise NotPortedError(
                f"feature gate {gate}="
                f"{str(config.feature_gates.enabled[gate]).lower()}: "
                f"{NOT_PORTED_GATES[gate]} is not ported to the GPU plugin "
                "yet")
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
            dev_root=config.gpulib_opts.dev_root or "/dev",
            driver_root=config.driver_root)
        # Find the driver's libraries now, not in the first prepare: a
        # driver whose libcuda or libnvidia-ml is missing fails here.
        self._cdi.driver_mounts(self.host.driver_version)
        if self._checkpoint.invalidated_on_boot:
            # A reboot reset every GPU's timeslice and ended every MPS
            # daemon: their records went with the claims.
            for sub in ("timeslice", "mps"):
                shutil.rmtree(os.path.join(config.root, sub),
                              ignore_errors=True)
            logger.warning("boot id changed: cleared the sharing state")
        self._timeslicing = TimeSlicingManager(
            config.root, find_binary(config.driver_root, "nvidia-smi"))
        self._tenancy = MultiTenancyManager(
            config.root, hbm_capacity_bytes=self.host.memory_bytes_per_chip,
            control_binary=find_binary(config.driver_root, MPS_CONTROL))
        # Re-own the MPS daemons of the claims that survived a restart,
        # quit the others'.
        self._tenancy.reconcile({
            uid for uid, c in self._checkpoint.get().claims.items()
            if c.state == ClaimState.PREPARE_COMPLETED.value})
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
                if self._tenancy.active(claim.uid):
                    raise PrepareError(
                        f"claim {claim.uid} completed but its CDI spec is "
                        "missing or corrupt, and its MPS daemon runs: not "
                        "prepared again under its clients; unprepare it to "
                        "recover")
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
        configs = self._resolve_configs(claim)
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
                prepared = self._prepare_devices(claim, configs, timer)
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

    def _resolve_configs(self, claim: ResourceClaim
                         ) -> dict[str, GpuConfig]:
        """The config of each request: the last one that applies, class
        configs before claim configs; a default ``GpuConfig`` when none
        does. Normalized and validated."""
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
            per_request[request] = cfg
        mps = [r for r, cfg in per_request.items()
               if not cfg.sharing.is_time_slicing]
        if mps and len(per_request) > 1:
            raise NotPortedError(
                f"requests {sorted(per_request)}: MPS ({mps}) for one "
                "request of a claim that has others: an MPS request must "
                "be its claim's only one (ROADMAP.md §1b item 4)")
        return per_request

    def _prepare_devices(self, claim: ResourceClaim,
                         configs: dict[str, GpuConfig], timer: SegmentTimer
                         ) -> list[CheckpointedDevice]:
        """Each request's sharing, then the CDI spec of the claim's GPUs;
        all of it undone if any part fails."""
        prepared: list[CheckpointedDevice] = []
        device_edits: dict[str, ContainerEdits] = {}
        # request -> its GPUs' indices and names: one sharing a request.
        groups: dict[str, tuple[list[int], list[str]]] = {}
        for result in claim.results:
            dev = self.allocatable[result.device]
            device_edits[result.device] = ContainerEdits(
                device_nodes=[dev.chip.chip.devpath])
            prepared.append(CheckpointedDevice(canonical_name=result.device,
                                               kind=dev.kind.value))
            indices, names = groups.setdefault(result.request, ([], []))
            indices.append(dev.chip.chip.index)
            names.append(result.device)
        claim_gpus = [i for indices, _ in groups.values() for i in indices]
        try:
            common = self._cdi.common_edits(self.host)
            common.env.append("CUDA_DEVICE_ORDER=PCI_BUS_ID")
            with timer.segment("prep_sharing"):
                for request, (indices, names) in groups.items():
                    # By index, as the JAX plugin lists a group's chips.
                    indices, names = map(list, zip(*sorted(zip(indices,
                                                               names))))
                    # A request's sharing reaches the containers bound to
                    # it: its GPUs' own edits.
                    edits = self._apply_sharing(
                        claim, request, configs[request].sharing, indices,
                        names)
                    for name in names:
                        device_edits[name] = device_edits[name].merge(edits)
            with timer.segment("gen_write_cdi_spec"):
                ids = self._cdi.create_claim_spec_file(
                    claim.uid, device_edits, common)
        except BaseException:
            self._release_sharing(claim.uid, claim_gpus)
            self._cdi.delete_claim_spec_file(claim.uid)
            raise
        by_name = dict(zip(sorted(device_edits), ids))
        for dev in prepared:
            dev.cdi_device_ids = [by_name[dev.canonical_name]]
        return prepared

    def _apply_sharing(self, claim: ResourceClaim, request: str,
                       sharing: Sharing, gpu_indices: list[int],
                       device_names: list[str]) -> ContainerEdits:
        """The request's time-slicing or MPS, if its gate is on (the JAX
        plugin's ``_apply_sharing``)."""
        gates = self._config.feature_gates
        try:
            if sharing.is_time_slicing:
                if not sharing.is_default and not gates.is_enabled(
                        TIME_SLICING_SETTINGS):
                    raise PrepareError(
                        "TimeSlicingSettings feature gate disabled")
                return self._timeslicing.set_time_slice(
                    claim.uid, gpu_indices, sharing.time_slicing)
            if not gates.is_enabled(MULTI_TENANCY_SUPPORT):
                raise PrepareError("MultiTenancySupport feature gate disabled")
            return self._tenancy.start(
                claim.uid, request, gpu_indices, sharing.multi_tenancy,
                device_names)
        except SharingError as e:
            raise PrepareError(f"request {request!r}: {e}") from e

    def _release_sharing(self, claim_uid: str, gpu_indices: list[int]
                         ) -> None:
        self._timeslicing.release(claim_uid, sorted(gpu_indices))
        self._tenancy.stop(claim_uid)

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
        """Remove what a claim holds: its sharing, its CDI spec, then its
        record."""
        indices = map(parse_gpu_name,
                      (d.canonical_name for d in checkpointed.devices))
        self._release_sharing(checkpointed.uid,
                              [i for i in indices if i is not None])
        self._cdi.delete_claim_spec_file(checkpointed.uid)
        self._checkpoint.update_claim(checkpointed.uid, None)

    # -- introspection ---------------------------------------------------

    def prepared_claims(self) -> dict[str, CheckpointedClaim]:
        return self._checkpoint.get().claims
