"""The checkpoint's state machines (the JAX package's
``pkg/analysis/statemachine.py``, its two-phase, single-phase,
partition and eviction policies).

The kubelet plugin's lifecycle (``TWO_PHASE_POLICY``): absent ->
PrepareStarted (the durable reservation) -> PrepareCompleted, torn down
from either state back to absent (rollback, unprepare). A claim never
appears PrepareCompleted without its PrepareStarted record having been
durable first.

The ComputeDomain plugin's claims (``SINGLE_PHASE_POLICY``) change no
device state, so their prepare is one step: absent -> PrepareCompleted
-> absent. A PrepareStarted record in its checkpoint is refused.

A tenant partition's MIG instance (``PARTITION_POLICY``,
``pkg/partition/engine.py``): absent -> PartitionCreating (the durable
intent, the placement pinned) -> PartitionReady (the instance exists,
its identity recorded) -> PartitionDestroying -> absent. A Creating
record may go to Destroying (a crashed create rolled back) or straight
to absent (a create that failed); a Ready record never vanishes without
its destroy intent having been durable first, so a crashed teardown
resumes instead of leaking the instance.

A permanent-failure eviction (``EVICTION_POLICY``, ``pkg/recovery.py``'s
records): absent -> EvictionPlanned (the failure declared) ->
EvictionDraining (consumer pods evicted) -> EvictionDeallocated (the
allocation cleared) -> absent (re-placed, or retired at the deadline).
A Planned or Draining record may also go straight to absent (the claim
was deleted); no stage is skipped.

A defragmentation move (``DEFRAG_POLICY``, ``pkg/defrag.py``'s records):
absent -> DefragPlanned (the carve and the claim's target reserved) ->
DefragDraining (the placement hint stamped, consumer pods evicted) ->
DefragDeallocated (the allocation cleared) -> absent (re-placed). A
Planned or Draining record may go straight to absent (aborted, or the
claim gone); a drain or deallocation without its durable plan is
refused.

A cooperative migration (``MIGRATION_POLICY``, ``pkg/migration.py``'s
records): absent -> MigrationDestReserved (the destination reserved) ->
MigrationIntentSignaled (the intent annotation stamped) ->
MigrationWorkloadAcked (the workload checkpointed and acked) ->
MigrationSwitching (drained, the allocation cleared) -> absent
(re-placed). Every state may go to absent: each failure falls back to
the cold path with the reservation released.

A serving-autoscaler rollout (``AUTOSCALE_POLICY``,
``pkg/autoscale/controller.py``'s records): absent -> AutoscalePlanned
(the desired spec pinned) -> AutoscaleApplying (the CRD write issued) ->
absent (confirmed, or superseded by an operator's edit). A Planned
record may go straight to absent (superseded before the write); no
write is issued without its durable plan.

The checkpoint manager validates every mutation against its policy. The
reference's model checker (``crash_closure``) and its registry of
policies are not ported.
"""

from __future__ import annotations

ABSENT = None
PREPARE_STARTED = "PrepareStarted"
PREPARE_COMPLETED = "PrepareCompleted"


class CheckpointTransitionError(RuntimeError):
    """A checkpoint mutation tried an illegal claim-state transition; the
    write is refused, so the illegal state never becomes durable."""


class TransitionPolicy:
    """A set of legal (old_state, new_state) transitions; None stands for
    a claim absent from the checkpoint. Identity transitions are always
    legal (an idempotent rewrite)."""

    def __init__(self, name: str,
                 allowed: frozenset[tuple[str | None, str | None]]):
        self.name = name
        self.allowed = frozenset(allowed)

    def __repr__(self) -> str:
        return f"TransitionPolicy({self.name!r})"

    def is_legal(self, old: str | None, new: str | None) -> bool:
        return old == new or (old, new) in self.allowed

    def validate(self, uid: str, old: str | None, new: str | None) -> None:
        if not self.is_legal(old, new):
            raise CheckpointTransitionError(
                f"claim {uid}: illegal checkpoint transition "
                f"{old or 'absent'} -> {new or 'absent'} under the "
                f"{self.name} policy (legal: "
                f"{sorted((o or 'absent', n or 'absent') for o, n in self.allowed)})"
            )

    def validate_states(self, old_states: dict[str, str],
                        new_states: dict[str, str], scope) -> None:
        """Validate every claim's change between two snapshots. ``scope``
        (uids) is what the mutation declared it touches; a change outside
        it is a fault too."""
        scoped = set(scope)
        for uid in set(old_states) | set(new_states):
            old, new = old_states.get(uid), new_states.get(uid)
            if old == new:
                continue
            if uid not in scoped:
                raise CheckpointTransitionError(
                    f"claim {uid}: checkpoint mutation changed state "
                    f"{old or 'absent'} -> {new or 'absent'} outside its "
                    f"declared dirty set {sorted(scoped)}")
            self.validate(uid, old, new)


TWO_PHASE_POLICY = TransitionPolicy(
    "two-phase",
    frozenset({
        (ABSENT, PREPARE_STARTED),             # durable reservation
        (PREPARE_STARTED, PREPARE_COMPLETED),  # the devices are ready
        (PREPARE_STARTED, ABSENT),             # rollback
        (PREPARE_COMPLETED, ABSENT),           # unprepare
    }),
)


SINGLE_PHASE_POLICY = TransitionPolicy(
    "single-phase",
    frozenset({
        (ABSENT, PREPARE_COMPLETED),  # one-step prepare
        (PREPARE_COMPLETED, ABSENT),  # unprepare
    }),
)


PARTITION_CREATING = "PartitionCreating"
PARTITION_READY = "PartitionReady"
PARTITION_DESTROYING = "PartitionDestroying"

PARTITION_POLICY = TransitionPolicy(
    "partition",
    frozenset({
        (ABSENT, PARTITION_CREATING),                # durable intent
        (PARTITION_CREATING, PARTITION_READY),       # instance live
        (PARTITION_CREATING, PARTITION_DESTROYING),  # crash rollback
        (PARTITION_CREATING, ABSENT),                # create failed
        (PARTITION_READY, PARTITION_DESTROYING),     # teardown intent
        (PARTITION_DESTROYING, ABSENT),              # destroy done
    }),
)


EVICTION_PLANNED = "EvictionPlanned"
EVICTION_DRAINING = "EvictionDraining"
EVICTION_DEALLOCATED = "EvictionDeallocated"

EVICTION_POLICY = TransitionPolicy(
    "eviction",
    frozenset({
        (ABSENT, EVICTION_PLANNED),                 # failure declared
        (EVICTION_PLANNED, EVICTION_DRAINING),      # pods evicted
        (EVICTION_DRAINING, EVICTION_DEALLOCATED),  # allocation cleared
        (EVICTION_PLANNED, ABSENT),                 # canceled (claim gone)
        (EVICTION_DRAINING, ABSENT),                # canceled (claim gone)
        (EVICTION_DEALLOCATED, ABSENT),             # re-placed / failed
    }),
)


DEFRAG_PLANNED = "DefragPlanned"
DEFRAG_DRAINING = "DefragDraining"
DEFRAG_DEALLOCATED = "DefragDeallocated"

DEFRAG_POLICY = TransitionPolicy(
    "defrag",
    frozenset({
        (ABSENT, DEFRAG_PLANNED),                 # move planned
        (DEFRAG_PLANNED, DEFRAG_DRAINING),        # pods evicted
        (DEFRAG_DRAINING, DEFRAG_DEALLOCATED),    # allocation cleared
        (DEFRAG_PLANNED, ABSENT),                 # canceled / aborted
        (DEFRAG_DRAINING, ABSENT),                # canceled / aborted
        (DEFRAG_DEALLOCATED, ABSENT),             # re-placed / aborted
    }),
)


MIGRATION_DEST_RESERVED = "MigrationDestReserved"
MIGRATION_INTENT_SIGNALED = "MigrationIntentSignaled"
MIGRATION_WORKLOAD_ACKED = "MigrationWorkloadAcked"
MIGRATION_SWITCHING = "MigrationSwitching"

MIGRATION_POLICY = TransitionPolicy(
    "migration",
    frozenset({
        (ABSENT, MIGRATION_DEST_RESERVED),        # window reserved
        (MIGRATION_DEST_RESERVED,
         MIGRATION_INTENT_SIGNALED),              # workload signaled
        (MIGRATION_INTENT_SIGNALED,
         MIGRATION_WORKLOAD_ACKED),               # checkpoint acked
        (MIGRATION_WORKLOAD_ACKED,
         MIGRATION_SWITCHING),                    # gang drained
        (MIGRATION_DEST_RESERVED, ABSENT),        # fallback / canceled
        (MIGRATION_INTENT_SIGNALED, ABSENT),      # ack timeout fallback
        (MIGRATION_WORKLOAD_ACKED, ABSENT),       # dest lost fallback
        (MIGRATION_SWITCHING, ABSENT),            # re-placed / fallback
    }),
)


AUTOSCALE_PLANNED = "AutoscalePlanned"
AUTOSCALE_APPLYING = "AutoscaleApplying"

AUTOSCALE_POLICY = TransitionPolicy(
    "autoscale",
    frozenset({
        (ABSENT, AUTOSCALE_PLANNED),              # durable re-plan intent
        (AUTOSCALE_PLANNED, AUTOSCALE_APPLYING),  # CRD write issued
        (AUTOSCALE_PLANNED, ABSENT),              # superseded pre-write
        (AUTOSCALE_APPLYING, ABSENT),             # confirmed / superseded
    }),
)
