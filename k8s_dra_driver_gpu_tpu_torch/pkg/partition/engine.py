"""The node-side partition engine: the MIG instance of each tenant
partition, created at its first tenant's prepare and destroyed at its
last tenant's unprepare (the JAX package's ``pkg/partition/engine.py``).

- ``partition_devices`` projects a ``PartitionSet`` onto this host's MIG
  placements: each profile over each placement NVML offers for its MIG
  profile is a device ``pt-<profile>-<k>``, published with a tenant
  slot's counters (``kubeletplugin/partitions.py``).
- Every create and destroy is driven through a durable record in a
  ``CheckpointManager`` of its own under ``<root>/partition``, under
  ``PARTITION_POLICY``: absent -> PartitionCreating -> PartitionReady ->
  PartitionDestroying -> absent. A crash at any point is settled at
  construction (``resume``) or by the sweep (``reap_idle``).
- Holders are derived, never stored: the tenants of a partition are the
  node checkpoint's claims that name the device.

What differs from the JAX engine, on an H100 host:

- **Identity after the create.** The JAX engine pins a carve-out uuid in
  the Creating record before it creates; NVML hands out a MIG instance's
  GPU- and compute-instance ids and its ``MIG-…`` UUID only after the
  create. So the Creating record pins the placement (its ``spec``), and
  the Ready record the instance. The create goes through the
  ``DeviceState``'s MIG path and its registry, which names the instance
  with its partition as owner; a crashed create is completed only
  through an instance the registry names at that placement. An instance
  the registry does not name (an admin's, or one a crash left between
  NVML's create and the registry write) is never adopted: the record is
  torn down and the attach fails, naming the placement.
- **The node lock.** The port has one node lock and no shard locks.
  ``attach`` and ``detach`` run inside prepare and unprepare, which hold
  it; ``apply``, ``resume``, ``reap_idle`` and ``set_prewarm`` run on the
  watcher's and the sweep's threads and take it, so no create or destroy
  of the engine races a prepare's. The order is the JAX one: node lock
  -> partition device lock -> engine mutex; nothing that holds a device
  lock takes the node lock.
- **MPS.** The teardown of an oversubscribed partition quits its MPS
  daemon (``kubeletplugin/sharing.py``) before it destroys the instance.

Observability, at the JAX engine's hook points: ``attach`` and
``detach`` are ``partition.attach`` / ``partition.detach`` spans
(children of the prepare's segment span on the same thread) with a
``partition_attach`` / ``partition_detach`` flight event under the
tenant's claim uid; once the kubelet ``Driver`` sets ``metrics`` (a
``pkg/metrics.PartitionMetrics``), creates, destroys, the Ready count
and the pre-warm created, hit and reaped counts are exported. The JAX
engine's fault points ``partition.create`` (after the Creating record,
before the instance) and ``partition.destroy`` (after the Destroying
record, before the destroy) raise ``PartitionEngineError`` in ``error``
mode (``pkg/faults.py``).
"""

from __future__ import annotations

import contextlib
import logging
import threading
from dataclasses import dataclass

from ...kubeletplugin.checkpoint import (CheckpointedClaim,
                                         CheckpointedDevice,
                                         CheckpointManager)
from ...kubeletplugin.deviceinfo import (AllocatableDevice, DeviceKind,
                                         PartitionInfo)
from ...kubeletplugin.subslice import enumerate_subslice_devices
from .. import flightrecorder, positive_float_env, tracing
from ..faults import fault_point
from ..statemachine import (PARTITION_CREATING, PARTITION_DESTROYING,
                            PARTITION_POLICY, PARTITION_READY)
from .spec import (PartitionProfile, PartitionSet, PartitionSpecError,
                   parse_partition_device_name)

logger = logging.getLogger(__name__)

LOCK_TIMEOUT_S = 10.0


def prewarm_max() -> int:
    """The most MIG instances kept warm ahead of demand on a node
    (``TPU_DRA_PREWARM_MAX``, default 8; 0 turns pre-warming off)."""
    return int(positive_float_env("TPU_DRA_PREWARM_MAX", default=8,
                                  floor=0))


class PartitionEngineError(RuntimeError):
    """An attach or detach that cannot go on (the kubelet retries the
    claim)."""


class ForeignInstanceError(PartitionEngineError):
    """A MIG instance the registry does not name holds a partition's
    placement: it is an admin's (or a crash's, between NVML's create and
    the registry write) and is never adopted."""


@dataclass(frozen=True)
class ResolvedProfile:
    """A PartitionProfile over this host's placements of its MIG
    profile."""

    profile: PartitionProfile
    infos: tuple[PartitionInfo, ...]


def resolve_partition_set(host, mig_profiles, partition_set: PartitionSet,
                          pool: str | None = None) -> list[ResolvedProfile]:
    """Project a PartitionSet onto one host. Raises PartitionSpecError
    when a profile names a MIG profile this host does not offer (MIG off
    offers none): a config error, as a bad static MIG name."""
    if pool is not None and not partition_set.applies_to_pool(pool):
        return []
    by_name = {p.name: p for p in mig_profiles}
    gpus = {chip.index: chip for chip in host.chips}
    out: list[ResolvedProfile] = []
    for prof in partition_set.profiles:
        base = by_name.get(prof.subslice)
        if base is None:
            raise PartitionSpecError(
                f"partition profile {prof.name!r}: MIG profile "
                f"{prof.subslice!r} is no carve-out of this host "
                f"({host.accelerator_type or host.product_name or 'unknown'}"
                f", MIG {host.mig_mode}; offered: "
                f"{sorted(by_name) or 'none'})")
        specs = enumerate_subslice_devices(host, (base,))
        out.append(ResolvedProfile(profile=prof, infos=tuple(
            PartitionInfo(profile=prof, spec=spec, mig=base,
                          chip=gpus[spec.gpu], placement=k)
            for k, spec in enumerate(specs))))
    return out


def partition_devices(host, mig_profiles, partition_set: PartitionSet,
                      pool: str | None = None
                      ) -> dict[str, AllocatableDevice]:
    """name -> AllocatableDevice of every desired partition of this
    host."""
    return {info.canonical_name: AllocatableDevice(
                kind=DeviceKind.PARTITION, partition=info)
            for rp in resolve_partition_set(host, mig_profiles,
                                            partition_set, pool=pool)
            for info in rp.infos}


def catalog_for(host, mig_profiles, partition_set: PartitionSet
                ) -> list[tuple[PartitionProfile, PartitionInfo]]:
    """(profile, its first placement's PartitionInfo) of each profile
    this host can place: what a sizing policy chooses from, with the
    same per-slot budget the device publishes."""
    return [(rp.profile, rp.infos[0])
            for rp in resolve_partition_set(host, mig_profiles,
                                            partition_set)
            if rp.infos]


class PartitionEngine:
    """The partition lifecycle of one node, attached to a DeviceState
    (``state``), which creates and destroys the MIG instances."""

    def __init__(self, state, partition_set: PartitionSet,
                 pool: str | None = None):
        self._state = state
        self.partition_set = partition_set
        self._pool = pool
        # pkg.metrics.PartitionMetrics, set by the kubelet Driver.
        self.metrics = None
        self._checkpoint = CheckpointManager(
            state.partition_root, boot_id=state.boot_id,
            transition_policy=PARTITION_POLICY)
        self._mutex = threading.Lock()
        self._dev_locks: dict[str, threading.Lock] = {}
        # Pre-warming (set_prewarm): the names the current hint wants
        # warm (reap_idle leaves their holderless Ready records alone),
        # and those created ahead of demand that no tenant attached yet.
        # In memory: a restart settles the records (resume) and the
        # watcher applies the hint again.
        self._prewarm_desired: set[str] = set()
        self._prewarm_idle: set[str] = set()
        self._devices = self._project_devices(partition_set)

    # -- desired devices -------------------------------------------------

    def _project_devices(self, partition_set: PartitionSet
                         ) -> dict[str, AllocatableDevice]:
        host = self._state.host
        if any(not chip.devpath for chip in host.chips):
            # As the MIG devices of a degraded host: its placements
            # cannot be trusted.
            logger.warning("degraded host: not publishing partition "
                           "devices")
            return {}
        return partition_devices(host, self._state.subslice_profiles,
                                 partition_set, pool=self._pool)

    def devices(self) -> dict[str, AllocatableDevice]:
        """The desired (publishable) partition devices."""
        with self._mutex:
            return dict(self._devices)

    def _node_lock(self):
        return self._state.pu_lock.acquire(timeout=LOCK_TIMEOUT_S)

    def apply(self, partition_set: PartitionSet
              ) -> dict[str, AllocatableDevice]:
        """Swap in a new PartitionSet: the desired devices are
        recomputed, partitions no longer desired are reaped once idle,
        and the caller republishes. Returns the new device set. A
        re-plan that keeps a device name but changes its placement
        while tenants hold the old one raises PartitionSpecError, as
        does a profile this host cannot place: the old plan stays."""
        partition_set.validate()
        new_devices = self._project_devices(partition_set)
        with self._node_lock():
            with self._mutex:
                current = set(self._devices)
            names = sorted(current | set(new_devices)
                           | set(self._checkpoint.get().claims))
            with contextlib.ExitStack() as stack:
                for name in names:
                    stack.enter_context(self._dev_lock(name))
                for name, rec in self._checkpoint.get().claims.items():
                    dev = new_devices.get(name)
                    pinned = self._pinned_spec(rec)
                    if dev is None or pinned is None:
                        continue
                    want = dev.partition.spec.canonical_name()
                    if pinned != want and self._holders(name) > 0:
                        raise PartitionSpecError(
                            f"re-plan changes the MIG placement of {name!r}"
                            f" ({pinned} -> {want}) while tenants still "
                            "hold it; drain the tenants or retire the "
                            "profile name instead")
                with self._mutex:
                    self.partition_set = partition_set
                    self._devices = new_devices
                    devices = dict(new_devices)
            self._reap_idle_locked()
        return devices

    # -- records ---------------------------------------------------------

    def _dev_lock(self, name: str) -> threading.Lock:
        with self._mutex:
            lock = self._dev_locks.get(name)
            if lock is None:
                lock = self._dev_locks[name] = threading.Lock()
            return lock

    def _record(self, name: str) -> CheckpointedClaim | None:
        return self._checkpoint.get().claims.get(name)

    def records(self) -> dict[str, CheckpointedClaim]:
        """The lifecycle records by device name."""
        return self._checkpoint.get().claims

    @staticmethod
    def _pinned_spec(rec: CheckpointedClaim) -> str | None:
        """The MIG placement (its canonical name) pinned in a record."""
        if rec.devices and rec.devices[0].live:
            return rec.devices[0].live.get("spec")
        return None

    def _holders(self, name: str, exclude: frozenset = frozenset()) -> int:
        """The tenant claims holding ``name``, from the node checkpoint;
        a reservation counts (an in-flight prepare's tenant)."""
        return sum(1 for uid, claim in self._state.prepared_claims().items()
                   if uid not in exclude
                   and any(d.canonical_name == name for d in claim.devices))

    def live_uuids(self) -> set[str]:
        """The MIG UUIDs the records own in any state, and those the
        registry names for a recorded partition (a create that crashed
        before its Ready record): the orphan sweep must never destroy a
        partition's instance mid-lifecycle."""
        records = self._checkpoint.get().claims
        out = {dev.live["uuid"] for rec in records.values()
               for dev in rec.devices if dev.live and "uuid" in dev.live}
        return out | self._state.partition_registry_uuids(set(records))

    def recorded_devices(self) -> set[str]:
        """The partition devices with a record in any state: their MIG
        instances (and tenants) may still exist, so a re-plan keeps them
        visible to overlap validation until their last tenant leaves."""
        return set(self._checkpoint.get().claims)

    def active_partitions(self) -> int:
        return sum(1 for rec in self._checkpoint.get().claims.values()
                   if rec.state == PARTITION_READY)

    # -- attach and detach (inside prepare and unprepare) ----------------

    def attach(self, claim_uid: str, device_name: str) -> dict:
        """Make sure the MIG instance of ``device_name`` exists; its live
        identity for the tenant's checkpoint record. Runs under the node
        lock (the caller's prepare)."""
        with tracing.span("partition.attach", attrs={
                "device": device_name, "claim_uid": claim_uid}) as sp:
            live = self._attach_inner(device_name)
            flightrecorder.default().record(
                claim_uid, "partition_attach",
                trace_id=sp.context.trace_id if sp.recording else "",
                device=device_name, uuid=live.get("uuid", ""))
            return live

    def _attach_inner(self, device_name: str) -> dict:
        with self._dev_lock(device_name):
            with self._mutex:
                dev = self._devices.get(device_name)
            if dev is None:
                raise PartitionEngineError(
                    f"unknown partition device {device_name!r}")
            rec = self._record(device_name)
            if rec is not None and rec.state == PARTITION_DESTROYING:
                # A crashed teardown owns the old instance: finish it
                # before a fresh create.
                self._teardown_locked(device_name, rec)
                rec = None
            if rec is not None:
                pinned = self._pinned_spec(rec)
                want = dev.partition.spec.canonical_name()
                if pinned is not None and pinned != want:
                    raise PartitionEngineError(
                        f"partition {device_name!r}: its MIG placement "
                        f"changed ({pinned} -> {want}); the old instance "
                        "is still settling")
            # A pre-warm hit: the attach found a Ready record made ahead
            # of demand, and skipped the create.
            warm_hit = rec is not None and rec.state == PARTITION_READY
            live = self._realize_locked(device_name, dev, rec)
            with self._mutex:
                warm_hit = warm_hit and device_name in self._prewarm_idle
                self._prewarm_idle.discard(device_name)
            if warm_hit and self.metrics is not None:
                self.metrics.inc_prewarm_hit()
            return live

    def _realize_locked(self, name: str, dev: AllocatableDevice,
                        rec: CheckpointedClaim | None) -> dict:
        """Create or complete the MIG instance of a record (the caller
        holds the device lock and has settled a Destroying or re-shaped
        record); shared by attach and set_prewarm."""
        spec = dev.partition.spec
        if rec is None:
            rec = CheckpointedClaim(
                uid=name, state=PARTITION_CREATING,
                devices=[CheckpointedDevice(
                    canonical_name=name, kind=DeviceKind.PARTITION.value,
                    live={"partition": name,
                          "spec": spec.canonical_name()})])
            self._checkpoint.update_claim(name, rec)
        if rec.state == PARTITION_CREATING:
            fault_point("partition.create",
                        error=lambda m: PartitionEngineError(m))
            live = self._state.partition_instance(name, spec)
            if live is None:
                try:
                    live = self._state.create_partition_instance(name, spec)
                except ForeignInstanceError:
                    # Never adopted: the record goes, the attach fails
                    # naming the placement.
                    self._teardown_locked(name, rec)
                    raise
                except Exception as e:
                    raise PartitionEngineError(
                        f"partition {name}: {e}") from e
            record = dict(live.to_dict(), partition=name,
                          spec=spec.canonical_name())
            rec = CheckpointedClaim(
                uid=name, state=PARTITION_READY,
                devices=[CheckpointedDevice(
                    canonical_name=name, kind=DeviceKind.PARTITION.value,
                    live=record)])
            self._checkpoint.update_claim(name, rec)
            if self.metrics is not None:
                self.metrics.inc_create()
                self.metrics.set_active(self.active_partitions())
            logger.info("partition %s: MIG instance %s created", name,
                        live.uuid)
        return dict(rec.devices[0].live)

    def detach(self, claim_uid: str, device_name: str) -> None:
        """Drop one tenant's hold; the MIG instance goes with the last
        holder, unless the current pre-warm hint wants it warm. Runs
        under the node lock (the caller's unprepare or rollback)."""
        with tracing.span("partition.detach", attrs={
                "device": device_name, "claim_uid": claim_uid}) as sp:
            kept_warm = last = False
            with self._dev_lock(device_name):
                rec = self._record(device_name)
                if rec is None:
                    return
                last = self._holders(device_name,
                                     exclude=frozenset({claim_uid})) == 0
                if last:
                    with self._mutex:
                        kept_warm = (device_name in self._prewarm_desired
                                     and rec.state == PARTITION_READY)
                        if kept_warm:
                            self._prewarm_idle.add(device_name)
                    if not kept_warm:
                        self._teardown_locked(device_name, rec)
            flightrecorder.default().record(
                claim_uid, "partition_detach",
                trace_id=sp.context.trace_id if sp.recording else "",
                device=device_name, destroyed=last and not kept_warm,
                kept_warm=kept_warm)

    def _teardown_locked(self, name: str, rec: CheckpointedClaim) -> None:
        """Durable-intent destroy: the Destroying record first, so a
        crash mid-destroy resumes instead of leaking the instance. The
        caller holds the device lock (and the node lock)."""
        if rec.state != PARTITION_DESTROYING:
            rec = CheckpointedClaim(uid=name, state=PARTITION_DESTROYING,
                                    devices=rec.devices)
            self._checkpoint.update_claim(name, rec)
        fault_point("partition.destroy",
                    error=lambda m: PartitionEngineError(m))
        live = rec.devices[0].live if rec.devices else None
        try:
            self._state.destroy_partition_instance(name, live or {})
        except Exception as e:
            raise PartitionEngineError(f"partition {name}: {e}") from e
        self._checkpoint.update_claim(name, None)
        if self.metrics is not None:
            self.metrics.inc_destroy()
            self.metrics.set_active(self.active_partitions())
        logger.info("partition %s: MIG instance destroyed", name)

    # -- pre-warming -----------------------------------------------------

    def set_prewarm(self, counts: dict[str, int],
                    max_total: int | None = None) -> int:
        """Converge the warm set onto a hint (``{profile: devices to
        keep warm}``): create the MIG instances of up to that many
        record-less devices a profile, at most ``max_total``
        (``TPU_DRA_PREWARM_MAX``) in all, and release the names the hint
        no longer wants to the idle sweep. A device with a Ready record
        counts toward its profile's quota. Returns the instances
        created; raises PartitionEngineError when one could not be
        created (the rest of the warm set stays)."""
        cap = prewarm_max() if max_total is None else max(int(max_total), 0)
        want = {str(p): int(n) for p, n in (counts or {}).items()
                if int(n) > 0}
        with self._node_lock():
            recorded = self._checkpoint.get().claims
            with self._mutex:
                devices = dict(self._devices)
            by_profile: dict[str, list[str]] = {}
            for name in sorted(devices):
                parsed = parse_partition_device_name(name)
                if parsed is not None:
                    by_profile.setdefault(parsed[0], []).append(name)
            desired: set[str] = set()
            to_create: list[str] = []
            budget = cap
            for profile, quota in sorted(want.items()):
                for name in by_profile.get(profile, ())[:quota]:
                    if budget <= 0:
                        break
                    budget -= 1
                    desired.add(name)
                    rec = recorded.get(name)
                    if rec is None or rec.state != PARTITION_READY:
                        to_create.append(name)
            with self._mutex:
                self._prewarm_desired = set(desired)
            created = failed = 0
            for name in to_create:
                with self._dev_lock(name):
                    rec = self._record(name)
                    if rec is not None and (rec.state == PARTITION_READY
                                            or self._holders(name) > 0):
                        continue
                    with self._mutex:
                        dev = self._devices.get(name)
                    if dev is None:
                        desired.discard(name)
                        continue
                    try:
                        if rec is not None and (
                                rec.state == PARTITION_DESTROYING
                                or self._pinned_spec(rec)
                                != dev.partition.spec.canonical_name()):
                            self._teardown_locked(name, rec)
                            rec = None
                        self._realize_locked(name, dev, rec)
                    except PartitionEngineError:
                        logger.exception("prewarm of %s failed", name)
                        desired.discard(name)
                        failed += 1
                        continue
                    created += 1
                    with self._mutex:
                        self._prewarm_idle.add(name)
                    if self.metrics is not None:
                        self.metrics.inc_prewarm_created()
            with self._mutex:
                self._prewarm_desired = desired
        if created or want:
            logger.info("prewarm: %d MIG instance(s) created, %d desired "
                        "warm (cap %d)", created, len(desired), cap)
        if failed:
            raise PartitionEngineError(
                f"prewarm: {failed} MIG instance(s) failed to be created "
                f"({created} created); retried at the next hint")
        return created

    def prewarm_state(self) -> tuple[set[str], set[str]]:
        """(desired warm names, created-but-unattached names)."""
        with self._mutex:
            return set(self._prewarm_desired), set(self._prewarm_idle)

    # -- reconciliation --------------------------------------------------

    def resume(self) -> int:
        """Crash recovery at plugin start: every record goes to a settled
        state. Returns the records repaired."""
        repaired = 0
        with self._node_lock():
            for name in sorted(self._checkpoint.get().claims):
                with self._dev_lock(name):
                    rec = self._record(name)
                    if rec is None:
                        continue
                    holders = self._holders(name)
                    with self._mutex:
                        dev = self._devices.get(name)
                    if rec.state == PARTITION_DESTROYING:
                        self._teardown_locked(name, rec)
                        repaired += 1
                    elif rec.state == PARTITION_CREATING:
                        if holders and dev is not None and \
                                self._pinned_spec(rec) == \
                                dev.partition.spec.canonical_name():
                            # A tenant's reservation waits on it:
                            # complete the create (through the registry's
                            # instance at the placement, if any).
                            try:
                                self._realize_locked(name, dev, rec)
                            except PartitionEngineError:
                                logger.exception(
                                    "partition %s: crashed create not "
                                    "completed", name)
                        else:
                            self._teardown_locked(name, rec)
                        repaired += 1
                    elif holders == 0:
                        self._teardown_locked(name, rec)
                        repaired += 1
                    elif dev is not None and self._pinned_spec(rec) != \
                            dev.partition.spec.canonical_name():
                        logger.error(
                            "partition %s: its MIG placement changed "
                            "across the restart (%s -> %s) with %d "
                            "tenant(s); the held instance stays until "
                            "they leave", name, self._pinned_spec(rec),
                            dev.partition.spec.canonical_name(), holders)
        if self.metrics is not None:
            self.metrics.set_active(self.active_partitions())
        return repaired

    def reap_idle(self) -> int:
        """Settle the records no tenant holds: Ready partitions idle
        since their last detach (or retired by ``apply``), and orphaned
        Creating or Destroying records. The pre-warm hint's Ready
        records are left warm. Returns the partitions reaped."""
        with self._node_lock():
            return self._reap_idle_locked()

    def _reap_idle_locked(self) -> int:
        reaped = 0
        with self._mutex:
            keep_warm = set(self._prewarm_desired)
        for name in sorted(self._checkpoint.get().claims):
            with self._dev_lock(name):
                rec = self._record(name)
                if rec is None or self._holders(name) > 0:
                    continue
                if name in keep_warm and rec.state == PARTITION_READY:
                    continue
                self._teardown_locked(name, rec)
                reaped += 1
                with self._mutex:
                    was_idle_warm = name in self._prewarm_idle
                    self._prewarm_idle.discard(name)
                if was_idle_warm and self.metrics is not None:
                    # Made ahead of demand and never attached.
                    self.metrics.inc_prewarm_reaped()
        return reaped
