"""DeviceState: the node's claim state machine for whole GPUs, MIG
devices and tenant partitions (the JAX package's
``kubeletplugin/device_state.py``, its ``DeviceKind.CHIP``, sub-slice and
partition paths; the upstream driver's
``cmd/gpu-kubelet-plugin/device_state.go``).

Prepare is idempotent and two-phase: the durable PrepareStarted record
(the reservation, with the claim's device names) comes before any device
state, PrepareCompleted after the CDI spec; a failure in between rolls
both back (upstream ``:229-334``, ``:536``). A device whose GPU memory
slots another claim holds is refused (``:1212``); configs resolve class
first, then claim, the later winning (``:1138``).

What differs from the JAX plugin, on an H100 host:

- **Enumerate once.** ``__init__`` loads the port's ``tpulib`` (NVML; the
  mock or devfs backend with ``Config.backend="python"``) and enumerates
  once. Prepare works from that snapshot, so it does not depend on what
  NVML answers later (a container's NVML may redact the UUID in some
  calls) and matches no GPU by UUID. A GPU whose minor number NVML
  refused has no device node to inject and is not published; a warning
  names it. The library is closed after the enumeration unless MIG is
  on (``host.mig_mode == "enabled"``): then it stays open for the MIG
  creates, destroys and walks, and ``close()`` closes it.
- **Whole GPUs, shared or not.** A claim config may ask for
  time-slicing at an interval (``TimeSlicingSettings``) or MPS
  (``MultiTenancySupport``), run by ``sharing.py``: ``nvidia-smi`` sets
  the GPU's timeslice, an MPS control daemon a claim request runs the
  clients; a gate that is off refuses its feature at prepare, as in the
  JAX plugin. An MPS request must be its claim's only request (the
  ``NotPortedError`` below): CDI merges same-named env, so two daemons'
  pipe directories would reach a container as one, and the clients of
  one daemon see only its GPUs. Passthrough (vfio) raises
  ``NotPortedError`` at prepare, naming the ROADMAP.md item that ports
  it; so does, at construction, every gate the plugin does not read when
  set away from its default (``NOT_PORTED_GATES``). A completed claim
  whose spec is lost while its MPS daemon runs is not prepared again
  (that would kill the daemon's clients): its prepare raises, and
  unprepare recovers it. Construction starts again the dead MPS daemons
  of completed claims and quits the others'; a boot id change drops the
  sharing records with the claims.
- **Tenancy admission** (``Config.tenancy_agents``: on in production,
  off in ``Config.mock``, as in the JAX plugin; read with
  ``MultiTenancySupport`` on). Preparing an MPS request starts, after
  its daemon answers, one tenancy agent for it (``tenancy_agent.py``,
  supervised by ``computedomain.daemon.process``) and returns once the
  agent answers READY; the request's CDI edits carry the native preflight
  hook (``csrc/tenancy_preflight.cc``, built at first use) as a
  ``createContainer`` and a ``poststop`` hook. A container whose
  admission would pass ``maxClients`` or the GPU's memory does not
  start; an agent that cannot be reached fails admission closed. An
  oversubscribed partition tenant gets an agent and the hooks too, its
  limit the tenant budget. The agents die with the plugin: ``close()``
  stops them, and their parent-death signal ends them if the plugin
  dies. Construction re-owns the agents of completed claims and drops
  the other agent directories; unprepare and a failed prepare stop a
  claim's agents before anything else of it goes; a live agent, like a
  live daemon, keeps a completed claim whose spec is lost from being
  prepared again; a boot id change drops every agent directory with the
  claims. A state root too long for the agents' sockets (AF_UNIX's 107
  bytes) fails construction.
- **MIG devices** (the JAX plugin's sub-slices), named
  ``gpu-<i>-mig-<profile>-<start>`` (``subslice.py``). Dynamic ones, one
  for each placement of each profile NVML offers on each GPU, are
  published with the ``DynamicSubSlice`` gate on and MIG on; prepare
  creates the GPU instance and its compute instance through NVML
  (``create_mig``) between the PrepareStarted and PrepareCompleted
  records, and unprepare, a failed prepare and a rollback destroy it.
  Static ones are the GPU instances NVML's walk finds at construction
  that this plugin did not create and that ``Config.static_subslices``
  names; a name there that is not among them fails construction. Prepare
  neither creates nor destroys a static device. A host with a GPU it
  cannot publish publishes no MIG device, as the JAX plugin's degraded
  host. Two devices overlap when they share a memory slot of one GPU (a
  whole GPU holds all 8). The registry (``SubSliceRegistry``,
  ``<root>/mig.json``) names the instances this plugin created; it is
  the only thing the orphan sweep (``destroy_unknown_subslices``, at
  construction and in the reconcile sweep) destroys from, so an admin's
  GPU instance is never touched. A crash between NVML's create and the
  registry write leaves a GPU instance the registry does not name: it is
  then an admin's to remove. A boot id change drops the registry without
  destroying anything: MIG instances do not survive a reboot, and an
  admin's mig-parted may since have made instances under the same ids.
  The spec of a MIG device injects its GPU's ``/dev/nvidia<minor>`` and
  the GPU and compute instance's ``/dev/nvidia-caps/nvidia-cap<N>``, the
  minors from ``/proc/driver/nvidia-caps/mig-minors`` (what the NVIDIA
  container toolkit's CDI does); a missing file fails prepare, naming
  it. A MIG device takes no timeslice (``compute-policy`` sets the
  whole GPU's, and the upstream refuses it on MIG): a non-default one is
  refused with ``PrepareError``, and MPS on a MIG device raises
  ``NotPortedError`` (ROADMAP.md §1b item 5c).
- **Tenant partitions** (``TenantPartitioning``, which needs
  ``DynamicSubSlice``; ``pkg/partition``). ``Config.partition_set`` is
  projected onto the MIG placements as ``pt-<profile>-<k>`` devices
  (those of ``Config.pool_name``'s pools), which join the allocatable
  set; a profile naming a MIG profile the host does not offer (with MIG
  off, any) fails construction with ``PartitionSpecError``. The engine
  creates a partition's MIG instance at its first tenant's prepare (the
  ``prep_attach_partition`` segment) through ``_create_mig`` and the
  registry, which names the partition as the instance's owner; co-tenants
  attach to it, up to ``maxTenants`` claims on one device, while any
  other device on its memory slots is refused; the last tenant's
  unprepare destroys it. A claim on an oversubscribed partition must
  opt in (``MigDeviceConfig.oversubscribe``), needs both sharing gates,
  takes the default timeslice only, and must be its claim's only device
  (the MPS clients of a container reach one daemon); its MIG instance
  has one MPS control daemon (``sharing.start_partition``), and each
  tenant's spec carries the daemon's pipe directory and its whole-MiB
  pinned memory limit, the tenant budget. Every tenant's spec gets
  ``TPU_PARTITION`` and ``TPU_PARTITION_HBM_BYTES`` (the JAX contract's
  names) and the instance's device nodes; a shared device's CDI name is
  scoped to the claim (``<device>-t-<uid>``). A request that mixes
  oversubscribed partitions with other devices is refused. Unprepare and
  a failed prepare detach through the engine, holder-counted, and
  without an engine (the gate turned off across a restart) by the same
  derived count. ``apply_partition_set`` re-plans (the CRD watcher's
  path) and ``prune_retired_partitions`` drops retired devices once their
  records are gone.
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
- **One plugin process a node.** Every prepare, unprepare and orphan
  sweep runs under the node lock (a ``Flock`` with a time limit), so a
  PrepareStarted record found by a prepare is a crashed prepare's and is
  rolled back. The JAX plugin's per-chip shard locks, reservation leases
  for an upgrade handover and fault-injection seams are not ported.
- **Tracing and the flight recorder**, as in the JAX plugin: a prepare
  is one ``prepare`` span, parented by the claim's traceparent
  annotation (``pkg/tracing.extract``), with a child span a segment;
  every prepare and unprepare records ``<operation>_segments`` (each
  segment's ms) under the claim's uid and hands the segments to
  ``segment_observer`` (the driver's histogram), if one is set.
"""

from __future__ import annotations

import json
import logging
import os
import shutil
import threading
import time
from dataclasses import dataclass, field

from ..api.configs import GpuConfig, MigDeviceConfig, Sharing
from ..api.decode import strict_decode
from ..pkg import flightrecorder, tracing
from ..pkg.featuregates import (DYNAMIC_SUB_SLICE, MULTI_TENANCY_SUPPORT,
                                TENANT_PARTITIONING, TIME_SLICING_SETTINGS,
                                FeatureGates)
from ..pkg.flock import Flock
from ..pkg.partition.engine import (ForeignInstanceError, PartitionEngine,
                                    PartitionEngineError)
from ..pkg.partition.spec import PartitionSet
from ..pkg.statemachine import (PARTITION_DESTROYING, PARTITION_POLICY,
                                PARTITION_READY)
from ..pkg.timing import SegmentTimer
from ..tpulib.binding import (EnumerateOptions, GpuHostInfo, GpuLibError,
                              SubSliceProfile, load)
from .cdi import CDIHandler, ContainerEdits, find_binary
from .checkpoint import (CheckpointedClaim, CheckpointedDevice,
                         CheckpointManager, ClaimState)
from .claim import ResourceClaim
from .deviceinfo import (MIG_MEMORY_SLICES, AllocatableDevice, ChipInfo,
                         DeviceKind, SubSliceInfo, parse_gpu_name)
from .sharing import (MPS_CONTROL, MultiTenancyManager, SharingError,
                      TimeSlicingManager)
from .subslice import (SubSliceLiveTuple, SubSliceSpecTuple,
                       enumerate_subslice_devices)

logger = logging.getLogger(__name__)

LOCK_TIMEOUT_S = 10.0

# What the JAX plugin runs and this one does not yet, by the ROADMAP.md
# §1b item that ports it.
_VFIO = "vfio passthrough (ROADMAP.md §1b item 6, vfio.py)"
NOT_PORTED_KINDS = {"VfioDeviceConfig": _VFIO}
# Every gate the port does not read (featuregates.READ): refused when set
# away from its default. The ComputeDomain daemon's two gates and the
# scheduler's one are read (by those binaries), so the GPU plugin takes
# them, as the JAX plugin does.
NOT_PORTED_GATES = {
    "PassthroughSupport": _VFIO,
    "ChipHealthCheck": "switching the health monitor by gate (the entry "
    "point's, ROADMAP.md §1b item 8; Driver(enable_health_monitor=) now)",
    "CrashOnICIFabricErrors": "crashing on fabric errors (no module of the "
    "JAX package reads this gate either)",
    "DeviceMetadata": "device metadata (no module of the JAX package reads "
    "this gate either)",
}


_MIG_KINDS = (DeviceKind.SUBSLICE_STATIC, DeviceKind.SUBSLICE_DYNAMIC,
              DeviceKind.PARTITION)


class PrepareError(RuntimeError):
    pass


class NotPortedError(PrepareError):
    """A claim asks for what the GPU plugin does not run yet."""


class SubSliceRegistry:
    """The MIG instances this plugin created (the JAX plugin's
    ``SubSliceRegistry``): ``<root>/mig.json``, MIG UUID -> live tuple
    (with ``owner``, the partition device, for a partition's instance),
    read-modify-written under its own flock and fsync'd, as the
    checkpoint is."""

    def __init__(self, root: str):
        self.path = os.path.join(root, "mig.json")
        self._lock = Flock(self.path + ".lock")

    def _read(self) -> dict[str, dict]:
        try:
            with open(self.path, encoding="utf-8") as f:
                return json.load(f)
        except (FileNotFoundError, json.JSONDecodeError):
            return {}

    def list(self) -> dict[str, SubSliceLiveTuple]:
        return {uuid: SubSliceLiveTuple.from_dict(d)
                for uuid, d in self._read().items()}

    def owners(self) -> dict[str, str]:
        """MIG UUID -> the partition device that owns it ("" for none)."""
        return {uuid: d.get("owner", "") for uuid, d in self._read().items()}

    def _write(self, entries: dict[str, dict]) -> None:
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(entries, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.path)

    def record(self, live: SubSliceLiveTuple, owner: str = "") -> None:
        with self._lock.acquire(timeout=LOCK_TIMEOUT_S):
            entries = self._read()
            entries[live.uuid] = dict(live.to_dict(), **(
                {"owner": owner} if owner else {}))
            self._write(entries)

    def drop(self, uuid: str) -> None:
        with self._lock.acquire(timeout=LOCK_TIMEOUT_S):
            entries = self._read()
            if entries.pop(uuid, None) is not None:
                self._write(entries)

    def clear(self) -> None:
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


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
    # Static MIG devices by name (gpu-<i>-mig-<profile>-<start>): GPU
    # instances an admin made, published as they are (the JAX plugin's
    # static sub-slices, the upstream's static MIG).
    static_subslices: tuple[str, ...] = ()
    # The desired tenant partitions (pkg/partition); read with the
    # TenantPartitioning gate on, else no partition is published.
    partition_set: PartitionSet | None = None
    # This node's pool, matched against the PartitionSet's pool globs;
    # None: every PartitionSet applies.
    pool_name: str | None = None
    # Run a supervised tenancy agent for each MPS request and admit its
    # containers through the preflight hooks; off in ``mock`` configs,
    # whose tests would pay a process start a prepare.
    tenancy_agents: bool = True

    @classmethod
    def mock(cls, root: str, topology: str = "h100-8", gates: str = "",
             mig_mode: str = "disabled",
             partition_set: PartitionSet | None = None,
             tenancy_agents: bool = False) -> "Config":
        """A mock host of ``topology`` GPUs with MIG ``mig_mode``; its CDI
        specs under ``root/cdi``, its device root ``root/dev`` and its
        proc root ``root/proc`` (empty unless a test makes nodes and
        files there), its MIG instances in ``root/mock-mig.json``;
        ``gates`` as ``FEATURE_GATES`` takes them."""
        return cls(root=root, partition_set=partition_set,
                   tenancy_agents=tenancy_agents,
                   gpulib_opts=EnumerateOptions(
                       mock_topology=topology,
                       dev_root=os.path.join(root, "dev"),
                       proc_root=os.path.join(root, "proc"),
                       mock_mig_mode=mig_mode,
                       mock_mig_state=os.path.join(root, "mock-mig.json")),
                   feature_gates=FeatureGates.parse(gates),
                   cdi_root=os.path.join(root, "cdi"), backend="python")


class DeviceState:
    """Prepare and unprepare over this host's GPUs, MIG devices and
    tenant partitions."""

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
        # Guards swaps of the allocatable set (a re-plan on the watcher's
        # thread against readers on others).
        self._alloc_lock = threading.Lock()
        self.partition_engine: PartitionEngine | None = None
        lib = load(config.backend)
        self._lib = None
        try:
            self.host: GpuHostInfo = lib.enumerate(config.gpulib_opts)
            self.subslice_profiles: tuple[SubSliceProfile, ...] = ()
            if self.host.mig_mode == "enabled":
                self.subslice_profiles = lib.subslice_profiles(
                    config.gpulib_opts)
                self._lib = lib
        finally:
            close = getattr(lib, "close", None)
            if self._lib is None and close is not None:
                close()
        try:
            self._init_state()
        except BaseException:
            self.close()
            raise

    def _init_state(self) -> None:
        config = self._config
        self._checkpoint = CheckpointManager(config.root,
                                             boot_id=config.boot_id)
        self._registry = SubSliceRegistry(config.root)
        if self._checkpoint.invalidated_on_boot:
            # A reboot reset every GPU's timeslice, ended every MPS daemon
            # and tenancy agent and destroyed every MIG instance: their
            # records went with the claims. The registry is dropped, not
            # swept: an admin may have made instances under its ids since.
            for sub in ("timeslice", "mps", "tenancy"):
                shutil.rmtree(os.path.join(config.root, sub),
                              ignore_errors=True)
            self._registry.clear()
            logger.warning("boot id changed: cleared the sharing state and "
                           "the MIG registry")
        self.allocatable = self._enumerate_allocatable()
        if config.partition_set is not None and \
                config.feature_gates.is_enabled(TENANT_PARTITIONING):
            self.partition_engine = PartitionEngine(
                self, config.partition_set, pool=config.pool_name)
            self.allocatable.update(self.partition_engine.devices())
        self._cdi = CDIHandler(
            cdi_root=config.cdi_root or os.path.join(config.root, "cdi"),
            dev_root=config.gpulib_opts.dev_root or "/dev",
            driver_root=config.driver_root)
        # Find the driver's libraries now, not in the first prepare: a
        # driver whose libcuda or libnvidia-ml is missing fails here.
        self._cdi.driver_mounts(self.host.driver_version)
        self._timeslicing = TimeSlicingManager(
            config.root, find_binary(config.driver_root, "nvidia-smi"))
        self._tenancy = MultiTenancyManager(
            config.root, hbm_capacity_bytes=self.host.memory_bytes_per_chip,
            control_binary=find_binary(config.driver_root, MPS_CONTROL),
            spawn_agents=config.tenancy_agents
            and config.feature_gates.is_enabled(MULTI_TENANCY_SUPPORT))
        engine = self.partition_engine
        if engine is not None:
            # Crashed creates and destroys settle before the orphan
            # sweep, which spares the instances the records own.
            engine.resume()
        self.destroy_unknown_subslices()
        # Re-own the tenancy agents and MPS daemons of the claims and
        # partitions that survived a restart, stop the others'. A
        # partition's daemon lives while a completed claim holds it (with
        # the engine gone too) or its record is Ready.
        completed = {uid: c for uid, c in self._checkpoint.get().claims.items()
                     if c.state == ClaimState.PREPARE_COMPLETED.value}
        held = {d.canonical_name for c in completed.values()
                for d in c.devices if d.live and d.live.get("partition")}
        if engine is not None:
            held |= {name for name, rec in engine.records().items()
                     if rec.state == PARTITION_READY}
        self._tenancy.reconcile(set(completed), held)
        # The segments (seconds) of the last prepare or unprepare.
        self.last_segments: dict[str, float] = {}
        # callable(operation, segments) | None: the driver's metrics.
        self.segment_observer = None

    # -- the partition engine's surface ----------------------------------

    @property
    def partition_root(self) -> str:
        return os.path.join(self._config.root, "partition")

    @property
    def boot_id(self) -> str | None:
        return self._config.boot_id

    def partition_instance(self, name: str, spec: SubSliceSpecTuple
                           ) -> SubSliceLiveTuple | None:
        """The MIG instance the registry names as partition ``name``'s at
        placement ``spec`` and NVML's walk still finds; None if none."""
        owners = self._registry.owners()
        for uuid, live in self._registry.list().items():
            if owners.get(uuid) == name and live.spec == spec and \
                    self._lib is not None and any(
                        (i.gi_id, i.profile, i.start) == (
                            live.gi_id, spec.profile, spec.start)
                        for i in self._lib.mig_instances(spec.gpu)):
                return live
        return None

    def create_partition_instance(self, name: str, spec: SubSliceSpecTuple
                                  ) -> SubSliceLiveTuple:
        """Create partition ``name``'s MIG instance at ``spec``, named in
        the registry with ``name`` as owner. A GPU instance the registry
        does not name on the placement's slots is never adopted
        (``ForeignInstanceError``)."""
        if self._lib is None:
            raise PrepareError(f"{spec.canonical_name()}: MIG is off")
        ours = self._registry.list()
        for inst in self._lib.mig_instances(spec.gpu):
            if inst.uuid in ours:
                continue
            if set(range(inst.start, inst.start + inst.size)) & \
                    set(spec.memory_slices):
                raise ForeignInstanceError(
                    f"partition {name}: placement {spec.canonical_name()} "
                    f"(GPU {spec.gpu}, memory slots {spec.start}.."
                    f"{spec.start + spec.size - 1}) holds GPU instance "
                    f"{inst.gi_id} ({inst.profile}) that this plugin did "
                    "not create: it is left to its admin")
        return self._create_mig(spec, owner=name)

    def destroy_partition_instance(self, name: str, live: dict) -> None:
        """Quit partition ``name``'s MPS daemon, then destroy its MIG
        instance: the one its record names, else the registry's for it
        (a create that crashed before its Ready record)."""
        self._tenancy.stop_partition(name)
        if "uuid" in live:
            targets = [SubSliceLiveTuple.from_dict(live)]
        else:
            owners = self._registry.owners()
            targets = [inst for uuid, inst in self._registry.list().items()
                       if owners.get(uuid) == name]
        for inst in targets:
            self._destroy_mig(inst)

    def partition_registry_uuids(self, names: set[str]) -> set[str]:
        """The registry's MIG UUIDs whose owner is in ``names``."""
        return {uuid for uuid, owner in self._registry.owners().items()
                if owner and owner in names}

    def apply_partition_set(self, partition_set: PartitionSet) -> None:
        """Swap in a new desired partition layout (the JAX plugin's);
        the caller republishes. A retired partition that still has a
        record (tenants, or a teardown in flight) stays allocatable, so
        overlap validation still sees its memory slots; new attaches to
        it fail, and ``prune_retired_partitions`` drops it once its
        record is gone."""
        if self.partition_engine is None:
            raise PrepareError("partition engine not enabled")
        devices = self.partition_engine.apply(partition_set)
        held = self.partition_engine.recorded_devices()
        with self._alloc_lock:
            merged = {name: dev for name, dev in self.allocatable.items()
                      if dev.kind != DeviceKind.PARTITION
                      or (name in held and name not in devices)}
            merged.update(devices)
            self.allocatable = merged

    def prune_retired_partitions(self) -> int:
        """Drop the partition devices that are neither desired nor held
        by a record any more; returns how many."""
        if self.partition_engine is None:
            return 0
        desired = set(self.partition_engine.devices())
        held = self.partition_engine.recorded_devices()
        with self._alloc_lock:
            retired = [name for name, dev in self.allocatable.items()
                       if dev.kind == DeviceKind.PARTITION
                       and name not in desired and name not in held]
            if retired:
                self.allocatable = {
                    name: dev for name, dev in self.allocatable.items()
                    if name not in retired}
        return len(retired)

    def close(self) -> None:
        """Stop the tenancy agents (their directories stay, for the next
        plugin to re-own) and close the device library kept open for
        MIG."""
        tenancy = getattr(self, "_tenancy", None)
        if tenancy is not None:
            tenancy.shutdown()
        lib, self._lib = self._lib, None
        close = getattr(lib, "close", None)
        if close is not None:
            close()

    # -- enumeration -------------------------------------------------------

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
        degraded = len(out) < len(self.host.chips)
        if degraded:
            # As the JAX plugin's host missing chips: the whole GPUs it
            # can publish stay published, and it offers no MIG device.
            logger.warning("degraded host (%d/%d GPUs published): not "
                           "publishing MIG devices", len(out),
                           len(self.host.chips))
        profiles = self.subslice_profiles
        gpus = {chip.index: chip for chip in self.host.chips}
        by_name = {p.name: p for p in profiles}
        specs = enumerate_subslice_devices(self.host, profiles) \
            if not degraded else []
        if self._config.feature_gates.is_enabled(DYNAMIC_SUB_SLICE):
            for spec in specs:
                info = SubSliceInfo(spec=spec, profile=by_name[spec.profile],
                                    chip=gpus[spec.gpu], dynamic=True)
                out[info.canonical_name] = AllocatableDevice(
                    kind=DeviceKind.SUBSLICE_DYNAMIC, subslice=info)
        if self._config.static_subslices:
            if degraded:
                logger.warning("degraded host: not publishing static MIG "
                               "devices %s",
                               list(self._config.static_subslices))
                return out
            found = self._static_instances()
            for name in self._config.static_subslices:
                live = found.get(name)
                if live is None:
                    # A bad name is a config error on a healthy host:
                    # fail startup rather than publish less than declared.
                    raise ValueError(
                        f"static MIG device {name!r} is not a GPU instance "
                        "with a compute instance on this host (MIG "
                        f"{self.host.mig_mode}; found {sorted(found)})")
                info = SubSliceInfo(spec=live.spec,
                                    profile=by_name[live.spec.profile],
                                    chip=gpus[live.spec.gpu], dynamic=False,
                                    uuid=live.uuid)
                # Static wins over the dynamic device of the same name:
                # an admin made it, and unprepare must not destroy it.
                out[name] = AllocatableDevice(
                    kind=DeviceKind.SUBSLICE_STATIC, subslice=info)
        return out

    def _static_instances(self) -> dict[str, SubSliceLiveTuple]:
        """The MIG devices NVML's walk finds that this plugin did not
        create, by name."""
        if self._lib is None:
            return {}
        ours = self._registry.list()
        found = {}
        for chip in self.host.chips:
            for inst in self._lib.mig_instances(chip.index):
                if inst.ci_id >= 0 and inst.uuid not in ours:
                    live = SubSliceLiveTuple.from_instance(inst)
                    found[live.spec.canonical_name()] = live
        return found

    def dra_devices(self) -> list[dict]:
        """The ResourceSlice devices of this node: by GPU, each whole GPU
        before its MIG devices."""
        return [dev.to_dra_device() for dev in sorted(
            self.allocatable.values(), key=AllocatableDevice.sort_key)]

    # -- the MIG orphan sweep ----------------------------------------------

    def destroy_unknown_subslices(self) -> int:
        """Destroy the registry's MIG instances that no checkpointed
        claim references, and drop the entries whose GPU instance is gone
        (the JAX plugin's ``destroy_unknown_subslices``; upstream
        ``device_state.go:388``). Runs under the node lock, so no prepare
        is between its create and its PrepareCompleted record. Returns the
        entries removed."""
        if not self._registry.list():
            return 0
        with self.pu_lock.acquire(timeout=LOCK_TIMEOUT_S):
            entries = self._registry.list()
            if self._lib is None:
                # MIG is off: turning it off took every GPU instance.
                for uuid in entries:
                    self._registry.drop(uuid)
                logger.warning("MIG is off: dropped %d MIG registry "
                               "entries", len(entries))
                return len(entries)
            referenced = {dev.live["uuid"]
                          for c in self._checkpoint.get().claims.values()
                          for dev in c.devices
                          if dev.live and "uuid" in dev.live}
            if self.partition_engine is not None:
                # A partition's instance mid-lifecycle is its records'.
                referenced |= self.partition_engine.live_uuids()
            existing = {(i.gpu, i.gi_id, i.profile, i.start)
                        for gpu in {live.spec.gpu
                                    for live in entries.values()}
                        for i in self._lib.mig_instances(gpu)}
            removed = 0
            for uuid, live in entries.items():
                key = (live.spec.gpu, live.gi_id, live.spec.profile,
                       live.spec.start)
                if key not in existing:
                    logger.warning("MIG instance %s (%s) is gone: dropped "
                                   "from the registry", uuid,
                                   live.spec.canonical_name())
                elif uuid not in referenced:
                    try:
                        self._lib.destroy_mig(live.instance())
                    except GpuLibError:
                        logger.exception("could not destroy orphan MIG "
                                         "instance %s; the next sweep "
                                         "tries again", uuid)
                        continue
                    logger.warning("destroyed orphan MIG instance %s (%s)",
                                   uuid, live.spec.canonical_name())
                else:
                    continue
                self._registry.drop(uuid)
                removed += 1
            return removed

    # -- prepare ---------------------------------------------------------

    def prepare(self, claim: ResourceClaim) -> list[str]:
        """Idempotent two-phase prepare; returns the claim's CDI device
        ids. A completed claim whose spec survived returns its ids; one
        whose spec is missing or truncated is prepared again."""
        # The claim's traceparent annotation (a scheduler's commit span)
        # parents this prepare and its segments.
        timer = SegmentTimer("prepare", claim.uid,
                             parent=tracing.extract(claim.annotations))
        try:
            t0 = time.monotonic()
            with self.pu_lock.acquire(timeout=LOCK_TIMEOUT_S):
                timer.segments["prep_lock_wait"] = time.monotonic() - t0
                return self._prepare_locked(claim, timer)
        finally:
            self._record_segments(timer)
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
                        "missing or corrupt, and its MPS daemon or tenancy "
                        "agent runs: not prepared again under its clients; "
                        "unprepare it to recover")
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

    def _slices_of(self, name: str, live: dict | None = None
                   ) -> set[tuple[int, int]]:
        """(GPU, memory slot) of each slot device ``name`` takes: from the
        published device, else a MIG live tuple, else a whole GPU's name
        (a device no longer published still holds what it held)."""
        dev = self.allocatable.get(name)
        if dev is not None:
            return dev.memory_slices()
        if live and "size" in live:
            return {(live["gpu"], k) for k in range(
                live["start"], live["start"] + live["size"])}
        index = parse_gpu_name(name)
        if index is not None:
            return {(index, k) for k in range(MIG_MEMORY_SLICES)}
        return set()

    def _slots_of(self, name: str) -> int:
        """The tenant slots of a device: ``maxTenants`` for a partition,
        1 (exclusive) for everything else."""
        dev = self.allocatable.get(name)
        if dev is not None and dev.partition is not None:
            return dev.partition.profile.max_tenants
        return 1

    def _validate_no_overlap(self, cp, claim: ResourceClaim) -> None:
        """Refuse a device that shares a GPU memory slot with a device
        another claim holds, prepared or reserved (PrepareStarted): a
        scheduler race. A whole GPU holds all its slots. An
        oversubscribed partition is the one sanctioned overlap: up to
        ``maxTenants`` claims may hold the same device, whose slots still
        exclude every other device."""
        held: dict[tuple[int, int], tuple[str, str]] = {}
        holders: dict[str, set[str]] = {}
        for other in cp.claims.values():
            if other.uid == claim.uid:
                continue
            for dev in other.devices:
                holders.setdefault(dev.canonical_name, set()).add(other.uid)
                for cell in self._slices_of(dev.canonical_name, dev.live):
                    held[cell] = (dev.canonical_name, other.uid)
        for result in claim.results:
            slots = self._slots_of(result.device)
            already = holders.get(result.device, set())
            if slots > 1 and len(already) >= slots:
                raise PrepareError(
                    f"device {result.device} has no free tenant slot "
                    f"({len(already)}/{slots} held)")
            for cell in sorted(self._slices_of(result.device)):
                entry = held.get(cell)
                if entry is not None and (slots == 1
                                          or entry[0] != result.device):
                    device, uid = entry
                    raise PrepareError(
                        f"device {result.device} overlaps with prepared "
                        f"claim {uid} (device {device})")

    def _resolve_configs(self, claim: ResourceClaim) -> dict:
        """The config of each request: the last one that applies, class
        configs before claim configs; when none does, the default of its
        first device's kind (``GpuConfig`` or ``MigDeviceConfig``).
        Normalized and validated; a config of the other kind than a
        device of its request is refused (the JAX plugin's
        ``_check_config_kind``)."""
        ordered = [c for c in claim.configs if c.source == "FromClass"] + [
            c for c in claim.configs if c.source != "FromClass"]
        devices: dict[str, list[AllocatableDevice]] = {}
        for r in claim.results:
            dev = self.allocatable.get(r.device)
            devices.setdefault(r.request, [])
            if dev is not None:
                devices[r.request].append(dev)
        per_request: dict = {}
        for request, devs in devices.items():
            winner = None
            for oc in ordered:
                if oc.applies_to(request):
                    winner = oc
            if winner is None:
                cfg = MigDeviceConfig() if devs and devs[0].kind \
                    in _MIG_KINDS else GpuConfig()
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
            for dev in devs:
                want = MigDeviceConfig if dev.kind in _MIG_KINDS \
                    else GpuConfig
                if not isinstance(cfg, want):
                    raise PrepareError(
                        f"request {request!r}: config kind "
                        f"{type(cfg).__name__} cannot apply to "
                        f"{dev.canonical_name} (a "
                        f"{'MIG device' if want is MigDeviceConfig else 'whole GPU'})")
            per_request[request] = cfg
        mps = [r for r, cfg in per_request.items()
               if not cfg.sharing.is_time_slicing]
        if mps and len(per_request) > 1:
            raise NotPortedError(
                f"requests {sorted(per_request)}: MPS ({mps}) for one "
                "request of a claim that has others: an MPS request must "
                "be its claim's only one (ROADMAP.md, \"MPS beside other "
                "requests\")")
        self._check_partitions(claim, per_request)
        return per_request

    def _check_partitions(self, claim: ResourceClaim, configs: dict) -> None:
        """The partition rules that need no device state, checked before
        any is made: the engine; a request that mixes an oversubscribed
        partition with other devices; the opt-in, the gates and the
        default timeslice of an oversubscribed device, which must be its
        claim's only device."""
        names: dict[str, list[str]] = {}
        for r in claim.results:
            names.setdefault(r.request, []).append(r.device)
        gates = self._config.feature_gates
        for request, devices in names.items():
            if self.partition_engine is None and any(
                    n in self.allocatable
                    and self.allocatable[n].partition is not None
                    for n in devices):
                raise PrepareError("partition engine not enabled on this "
                                   "node")
            over = [n for n in devices if self._slots_of(n) > 1]
            if not over:
                continue
            if len(over) != len(devices):
                raise PrepareError(
                    f"request {request!r} mixes oversubscribed partition "
                    f"devices ({sorted(over)}) with exclusive devices "
                    f"({sorted(set(devices) - set(over))}); split them "
                    "into separate requests")
            cfg = configs[request]
            if not cfg.oversubscribe:
                raise PrepareError(
                    f"device {over[0]} is oversubscribed "
                    f"({self._slots_of(over[0])} tenant slots); the "
                    "claim's MigDeviceConfig must opt in with "
                    "oversubscribe: true")
            if not gates.is_enabled(TIME_SLICING_SETTINGS) or \
                    not gates.is_enabled(MULTI_TENANCY_SUPPORT):
                raise PrepareError(
                    "oversubscribed partitions need the TimeSlicingSettings "
                    "and MultiTenancySupport feature gates")
            if not cfg.sharing.is_default:
                raise PrepareError(
                    f"request {request!r}: a timeslice on an oversubscribed "
                    "partition: compute-policy sets the whole GPU's, so it "
                    "is refused on MIG")
            if len(claim.results) > 1:
                raise PrepareError(
                    f"claim {claim.uid}: oversubscribed partition "
                    f"{over[0]} must be its claim's only device: the MPS "
                    "clients of a container reach one daemon, which sees "
                    "only its MIG instance")

    def _mig_edits(self, chip, live: SubSliceLiveTuple) -> ContainerEdits:
        """The device nodes of a MIG device: its GPU's, and the caps of
        its GPU and compute instance (``/dev/nvidia-caps/nvidia-cap<N>``,
        N from the driver's ``mig-minors``)."""
        proc = self._config.gpulib_opts.proc_root or "/proc"
        dev = self._config.gpulib_opts.dev_root or "/dev"
        path = os.path.join(proc, "driver", "nvidia-caps", "mig-minors")
        try:
            with open(path, encoding="utf-8") as f:
                minors = dict(line.split()[:2] for line in f
                              if len(line.split()) >= 2)
        except OSError as e:
            raise PrepareError(f"{live.spec.canonical_name()}: cannot read "
                               f"{path}: {e}") from e
        prefix = f"gpu{chip.minor}/gi{live.gi_id}"
        nodes = [chip.devpath]
        for cap in (f"{prefix}/access", f"{prefix}/ci{live.ci_id}/access"):
            if cap not in minors:
                raise PrepareError(f"{live.spec.canonical_name()}: no {cap} "
                                   f"in {path}")
            node = os.path.join(dev, "nvidia-caps",
                                f"nvidia-cap{minors[cap]}")
            if not os.path.exists(node):
                raise PrepareError(f"{live.spec.canonical_name()}: "
                                   f"{node} does not exist")
            nodes.append(node)
        return ContainerEdits(device_nodes=nodes)

    def _create_mig(self, spec: SubSliceSpecTuple, owner: str = ""
                    ) -> SubSliceLiveTuple:
        """The HOT path's ``createMigDevice`` (``nvlib.go:926``): the
        instance, recorded in the registry (with its partition as
        ``owner``)."""
        try:
            inst = self._lib.create_mig(spec.gpu, spec.profile, spec.start)
        except GpuLibError as e:
            raise PrepareError(f"{spec.canonical_name()}: {e}") from e
        live = SubSliceLiveTuple.from_instance(inst)
        try:
            self._registry.record(live, owner=owner)
        except BaseException:
            self._destroy_mig(live, quiet=True)
            raise
        return live

    def _destroy_mig(self, live: SubSliceLiveTuple, quiet: bool = False
                     ) -> None:
        """Destroy a created instance and drop its registry entry. A
        failure raises, the entry kept for the sweep; with ``quiet`` it
        is logged instead (a failed prepare's cleanup, whose own error
        wins). With MIG off there is no instance left to destroy."""
        try:
            if self._lib is not None:
                self._lib.destroy_mig(live.instance())
        except GpuLibError as e:
            if not quiet:
                raise PrepareError(f"destroying MIG instance {live.uuid} "
                                   f"({live.spec.canonical_name()}): {e}"
                                   ) from e
            logger.exception("could not destroy MIG instance %s; the sweep "
                             "tries again", live.uuid)
            return
        self._registry.drop(live.uuid)

    def _prepare_devices(self, claim: ResourceClaim, configs: dict,
                         timer: SegmentTimer) -> list[CheckpointedDevice]:
        """Each MIG device created (a partition attached), each request's
        sharing, then the CDI spec of the claim's devices; all of it
        undone if any part fails."""
        prepared: list[CheckpointedDevice] = []
        device_edits: dict[str, ContainerEdits] = {}
        # A shared partition's CDI name is scoped to the claim: its
        # tenants hold one device, and qualified CDI ids must not clash.
        cdi_name_of: dict[str, str] = {}
        created: list[SubSliceLiveTuple] = []
        attached: list[str] = []
        # request -> the indices of its devices' GPUs and the devices'
        # names: one sharing a request (a MIG device holds its GPU's
        # default timeslice, as the JAX plugin's sub-slice its chip's).
        groups: dict[str, tuple[list[int], list[str]]] = {}
        claim_gpus: list[int] = []
        try:
            for result in claim.results:
                dev = self.allocatable[result.device]
                live = None
                indices, names = groups.setdefault(result.request, ([], []))
                indices.append(dev.gpu.index)
                names.append(result.device)
                claim_gpus.append(dev.gpu.index)
                if dev.kind == DeviceKind.CHIP:
                    edits = ContainerEdits(device_nodes=[dev.gpu.devpath])
                elif dev.kind == DeviceKind.PARTITION:
                    edits, live = self._prepare_partition(
                        claim, result, configs[result.request], timer,
                        attached)
                else:
                    self._check_mig_sharing(result.request,
                                            configs[result.request].sharing)
                    ss = dev.subslice
                    if dev.kind == DeviceKind.SUBSLICE_DYNAMIC:
                        with timer.segment("prep_create_subslice"):
                            made = self._create_mig(ss.spec)
                        created.append(made)
                        live = made.to_dict()
                    else:
                        made = SubSliceLiveTuple.from_instance(
                            self._static_instance(ss))
                    edits = self._mig_edits(dev.gpu, made)
                cdi_name = result.device
                if self._slots_of(result.device) > 1:
                    cdi_name = f"{result.device}-t-{claim.uid}"
                cdi_name_of[result.device] = cdi_name
                device_edits[cdi_name] = edits
                prepared.append(CheckpointedDevice(
                    canonical_name=result.device, kind=dev.kind.value,
                    live=live))
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
                    for name in map(cdi_name_of.get, names):
                        device_edits[name] = device_edits[name].merge(edits)
            with timer.segment("gen_write_cdi_spec"):
                ids = self._cdi.create_claim_spec_file(
                    claim.uid, device_edits, common)
        except BaseException:
            self._release_sharing(claim.uid, claim_gpus)
            self._cdi.delete_claim_spec_file(claim.uid)
            for live in created:
                self._destroy_mig(live, quiet=True)
            for name in attached:
                # Holder-counted: the instance stays while a co-tenant
                # holds it. A failed detach must not hide the error: its
                # durable Destroying record is finished by the sweep.
                try:
                    self.partition_engine.detach(claim.uid, name)
                except PartitionEngineError:
                    logger.exception("rollback: partition detach of %s "
                                     "failed; the sweep finishes it", name)
            raise
        by_name = dict(zip(sorted(device_edits), ids))
        for dev in prepared:
            dev.cdi_device_ids = [by_name[cdi_name_of[dev.canonical_name]]]
        return prepared

    def _prepare_partition(self, claim: ResourceClaim, result, cfg,
                           timer: SegmentTimer, attached: list[str]
                           ) -> tuple[ContainerEdits, dict]:
        """Attach a tenant to its partition (the first creates the MIG
        instance); the device's edits and its live record. An
        oversubscribed partition's tenant gets its MPS daemon's pipe
        directory and memory limit, and, with agents on, a tenancy agent
        of its own and the preflight hooks."""
        dev = self.allocatable[result.device]
        info = dev.partition
        if not info.oversubscribed:
            self._check_mig_sharing(result.request, cfg.sharing)
        try:
            with timer.segment("prep_attach_partition"):
                live = self.partition_engine.attach(claim.uid, result.device)
        except PartitionEngineError as e:
            raise PrepareError(str(e)) from e
        attached.append(result.device)
        made = SubSliceLiveTuple.from_dict(live)
        edits = self._mig_edits(dev.gpu, made)
        edits.env += [f"TPU_PARTITION={info.profile.name}",
                      f"TPU_PARTITION_HBM_BYTES={info.tenant_memory_bytes}"]
        if info.oversubscribed:
            try:
                with timer.segment("prep_partition_mps"):
                    edits = edits.merge(self._tenancy.start_partition(
                        result.device, dev.gpu.index, made.uuid,
                        info.mig.hbm_bytes, info.tenant_memory_bytes,
                        info.profile.max_tenants))
                with timer.segment("prep_tenant_agent"):
                    edits = edits.merge(self._tenancy.start_tenant_agent(
                        claim.uid, result.request, dev.gpu.index,
                        result.device, info.tenant_memory_bytes))
            except SharingError as e:
                raise PrepareError(f"request {result.request!r}: {e}"
                                   ) from e
        return edits, live

    def _static_instance(self, ss: SubSliceInfo):
        """The static device's instance as NVML's walk finds it now."""
        for inst in self._lib.mig_instances(ss.spec.gpu):
            if inst.uuid == ss.uuid:
                return inst
        raise PrepareError(f"static MIG device {ss.canonical_name} "
                           f"({ss.uuid}) is gone")

    def _check_mig_sharing(self, request: str, sharing: Sharing) -> None:
        """A MIG device takes the default timeslice only: the GPU's
        timeslice is the whole GPU's, and MPS on MIG is not ported."""
        if not sharing.is_time_slicing:
            raise NotPortedError(
                f"request {request!r}: MPS on a MIG device is not ported "
                "to the GPU plugin yet (ROADMAP.md §1b item 5c)")
        if not sharing.is_default:
            raise PrepareError(
                f"request {request!r}: a timeslice on a MIG device: "
                "compute-policy sets the whole GPU's, so it is refused on "
                "MIG, as by the upstream driver")

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
                    claim.uid, sorted(set(gpu_indices)),
                    sharing.time_slicing)
            if not gates.is_enabled(MULTI_TENANCY_SUPPORT):
                raise PrepareError("MultiTenancySupport feature gate disabled")
            return self._tenancy.start(
                claim.uid, request, gpu_indices, sharing.multi_tenancy,
                device_names)
        except SharingError as e:
            raise PrepareError(f"request {request!r}: {e}") from e

    def _release_sharing(self, claim_uid: str, gpu_indices: list[int]
                         ) -> None:
        self._timeslicing.release(claim_uid, sorted(set(gpu_indices)))
        self._tenancy.stop(claim_uid)

    # -- unprepare -------------------------------------------------------

    def unprepare(self, claim_uid: str) -> None:
        """Idempotent: destroys the claim's MIG instances, removes its
        sharing, its CDI spec and its checkpoint record; a claim never
        prepared (or already unprepared) is a no-op, apart from removing a
        stray spec."""
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
            self._record_segments(timer)
            timer.done()

    def _record_segments(self, timer: SegmentTimer) -> None:
        """The segments of one prepare or unprepare: ``last_segments``,
        the claim's flight record, tied to the trace, and the
        observer."""
        self.last_segments = dict(timer.segments)
        if timer.key:
            flightrecorder.default().record(
                timer.key, f"{timer.operation}_segments",
                trace_id=timer.trace_id,
                **{f"{name}_ms": round(dt * 1e3, 2)
                   for name, dt in sorted(timer.segments.items())})
        observer = self.segment_observer
        if observer is not None:
            try:
                observer(timer.operation, dict(timer.segments))
            except Exception:  # noqa: BLE001 - metrics must not fail it
                logger.exception("segment observer failed")

    def _rollback(self, checkpointed: CheckpointedClaim) -> None:
        """Remove what a claim holds: its tenancy agents first, then its
        MIG instances (a failure raises and keeps the record, so the
        kubelet's retry finds it), its partitions' holds, its sharing,
        its CDI spec, then its record. A reservation (no live state)
        holds no instance."""
        self._tenancy.stop_agents(checkpointed.uid)
        for dev in checkpointed.devices:
            if dev.live and dev.live.get("partition"):
                self._detach_partition(checkpointed.uid, dev)
            elif dev.live and "uuid" in dev.live:
                self._destroy_mig(SubSliceLiveTuple.from_dict(dev.live))
        indices = {gpu for d in checkpointed.devices
                   for gpu, _ in self._slices_of(d.canonical_name, d.live)}
        self._release_sharing(checkpointed.uid, sorted(indices))
        self._cdi.delete_claim_spec_file(checkpointed.uid)
        self._checkpoint.update_claim(checkpointed.uid, None)

    def _detach_partition(self, uid: str, dev: CheckpointedDevice) -> None:
        """Drop a tenant's hold through the engine; without one (the gate
        turned off across a restart), by the same derived count: the
        instance and its MPS daemon go only when no other claim record
        names the device."""
        if self.partition_engine is not None:
            try:
                self.partition_engine.detach(uid, dev.canonical_name)
            except PartitionEngineError as e:
                raise PrepareError(str(e)) from e
            return
        if any(other.uid != uid and any(
                d.canonical_name == dev.canonical_name
                for d in other.devices)
               for other in self._checkpoint.get().claims.values()):
            return
        self._tenancy.stop_partition(dev.canonical_name)
        self._destroy_mig(SubSliceLiveTuple.from_dict(dev.live))
        # Its record goes too: a later engine must not destroy what may
        # since stand under the same ids.
        if os.path.exists(os.path.join(self.partition_root,
                                       CheckpointManager.FILENAME)):
            records = CheckpointManager(self.partition_root,
                                        boot_id=self._config.boot_id,
                                        transition_policy=PARTITION_POLICY)
            rec = records.get().claims.get(dev.canonical_name)
            if rec is not None:
                if rec.state != PARTITION_DESTROYING:
                    records.update_claim(rec.uid, CheckpointedClaim(
                        uid=rec.uid, state=PARTITION_DESTROYING,
                        devices=rec.devices))
                records.update_claim(rec.uid, None)

    # -- introspection ---------------------------------------------------

    def prepared_claims(self) -> dict[str, CheckpointedClaim]:
        return self._checkpoint.get().claims

    def prepared_device_count(self) -> int:
        """Devices of the completed claims (the prepared-devices
        gauge)."""
        return sum(len(c.devices) for c in self._checkpoint.get()
                   .claims.values()
                   if c.state == ClaimState.PREPARE_COMPLETED.value)

    def tenancy_agent_count(self) -> int:
        """Tenancy agents running (the tenancy-agents gauge)."""
        return self._tenancy.agent_count()

    def mig_registry(self) -> dict[str, SubSliceLiveTuple]:
        """The MIG instances this plugin created and has not destroyed."""
        return self._registry.list()
