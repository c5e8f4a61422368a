"""The checkpoint's state machines (the JAX package's
``pkg/analysis/statemachine.py``, its two-phase, single-phase and
partition policies).

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

The checkpoint manager validates every mutation against its policy. The
reference's model checker (``crash_closure``) and the policies of its
other controllers are not ported.
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
