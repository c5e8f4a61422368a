"""The versioned, checksummed, crash-safe claim checkpoint (the JAX
package's ``kubeletplugin/checkpoint.py``; the upstream driver's
``checkpoint.go`` and ``checkpointv.go``).

The on-disk format is the JAX plugin's, byte for byte for the same
claims, so each reads the other's file::

    {"version":"v2","data":{"claims":{...},"nodeBootID":"..."},
     "checksums":{"v1":<crc32>,"v2":<crc32>}}

Each checksum is the CRC-32 of the canonical JSON (sorted keys, compact)
of that version's projection of the data: v1 lacks the boot id and the
claims' namespace and name. A reader of version N checks checksum N, so
neither an upgrade nor a downgrade reads the other's file as corrupt. A
checkpoint written before the node's last reboot is dropped at start-up.

``CheckpointManager`` is simpler than the reference's: no group commit
and no fragment cache. Each mutation takes the file lock (with a time
limit), re-reads the file if another process changed it, validates the
claim-state transitions against the two-phase policy, and writes the
file durably (``pkg/fsutil.write_json_atomic``) before it returns.
"""

from __future__ import annotations

import difflib
import json
import logging
import os
import zlib
from dataclasses import dataclass, field
from enum import Enum

from ..pkg import bootid
from ..pkg.flock import Flock
from ..pkg.fsutil import stat_signature, write_json_atomic
from ..pkg.statemachine import TWO_PHASE_POLICY

logger = logging.getLogger(__name__)

LATEST_VERSION = "v2"
LOCK_TIMEOUT_S = 10.0


class ClaimState(str, Enum):
    PREPARE_STARTED = "PrepareStarted"
    PREPARE_COMPLETED = "PrepareCompleted"


@dataclass
class CheckpointedDevice:
    """One prepared device. Every field is written only when set, as the
    reference does since its issue 1080 (a schema change that dropped
    empty fields broke checksums across versions)."""

    canonical_name: str = ""
    kind: str = ""  # a DeviceKind value
    cdi_device_ids: list[str] = field(default_factory=list)
    live: dict | None = None

    def to_dict(self) -> dict:
        d: dict = {}
        if self.canonical_name:
            d["canonicalName"] = self.canonical_name
        if self.kind:
            d["kind"] = self.kind
        if self.cdi_device_ids:
            d["cdiDeviceIDs"] = self.cdi_device_ids
        if self.live is not None:
            d["live"] = self.live
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CheckpointedDevice":
        return cls(canonical_name=d.get("canonicalName", ""),
                   kind=d.get("kind", ""),
                   cdi_device_ids=list(d.get("cdiDeviceIDs", [])),
                   live=d.get("live"))


@dataclass
class CheckpointedClaim:
    uid: str = ""
    namespace: str = ""
    name: str = ""
    state: str = ClaimState.PREPARE_STARTED.value
    devices: list[CheckpointedDevice] = field(default_factory=list)

    def to_dict(self) -> dict:
        d: dict = {"uid": self.uid, "state": self.state}
        if self.namespace:
            d["namespace"] = self.namespace
        if self.name:
            d["name"] = self.name
        if self.devices:
            d["devices"] = [x.to_dict() for x in self.devices]
        return d

    def to_dict_v1(self) -> dict:
        d: dict = {"uid": self.uid, "state": self.state}
        if self.devices:
            d["devices"] = [x.to_dict() for x in self.devices]
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CheckpointedClaim":
        return cls(uid=d.get("uid", ""), namespace=d.get("namespace", ""),
                   name=d.get("name", ""),
                   state=d.get("state", ClaimState.PREPARE_STARTED.value),
                   devices=[CheckpointedDevice.from_dict(x)
                            for x in d.get("devices", [])])


def _canonical(payload: dict) -> str:
    return json.dumps(payload, sort_keys=True, separators=(",", ":"))


def _checksum(payload: dict) -> int:
    return zlib.crc32(_canonical(payload).encode())


class CheckpointCorruptError(RuntimeError):
    pass


@dataclass
class Checkpoint:
    """The checkpoint document in memory."""

    node_boot_id: str = ""
    claims: dict[str, CheckpointedClaim] = field(default_factory=dict)

    def _payload_v2(self) -> dict:
        return {"nodeBootID": self.node_boot_id,
                "claims": {uid: c.to_dict() for uid, c in self.claims.items()}}

    def _payload_v1(self) -> dict:
        return {"claims": {uid: c.to_dict_v1()
                           for uid, c in self.claims.items()}}

    def to_dict(self) -> dict:
        return {"version": LATEST_VERSION, "data": self._payload_v2(),
                "checksums": {"v1": _checksum(self._payload_v1()),
                              "v2": _checksum(self._payload_v2())}}

    def to_json(self) -> str:
        """The file's bytes: ``to_dict`` with the data in canonical
        JSON, as the JAX plugin writes it."""
        v1, v2 = (_canonical(p) for p in (self._payload_v1(),
                                          self._payload_v2()))
        return ('{"version":"' + LATEST_VERSION + '","data":' + v2
                + ',"checksums":{"v1":' + str(zlib.crc32(v1.encode()))
                + ',"v2":' + str(zlib.crc32(v2.encode())) + "}}")

    @classmethod
    def from_dict(cls, d: dict) -> "Checkpoint":
        """Parse a document of any version, checking its own version's
        checksum (CheckpointCorruptError with a diff on a mismatch)."""
        version = d.get("version", "v1")
        data = d.get("data", {})
        cp = cls(node_boot_id=data.get("nodeBootID", ""),
                 claims={uid: CheckpointedClaim.from_dict(c)
                         for uid, c in data.get("claims", {}).items()})
        want = d.get("checksums", {}).get("v2" if version == "v2" else "v1")
        if want is not None:
            payload = cp._payload_v2() if version == "v2" \
                else cp._payload_v1()
            if _checksum(payload) != want:
                raise CheckpointCorruptError(_diagnose(d, payload, version))
        return cp


def _diagnose(on_disk: dict, payload: dict, version: str) -> str:
    """The unified diff of the data on disk against its re-encoding
    (upstream ``device_state.go:618-646``)."""
    a = json.dumps(on_disk.get("data", {}), sort_keys=True, indent=1)
    b = json.dumps(payload, sort_keys=True, indent=1)
    diff = "\n".join(difflib.unified_diff(
        a.splitlines(), b.splitlines(), "on-disk", "re-marshaled",
        lineterm=""))
    return f"checkpoint checksum mismatch ({version}); diff:\n{diff}"


class CheckpointManager:
    """The file lock-guarded reader and writer of ``checkpoint.json``
    under ``root``; every mutation is validated against the two-phase
    policy."""

    FILENAME = "checkpoint.json"

    def __init__(self, root: str, boot_id: str | None = None):
        os.makedirs(root, exist_ok=True)
        self._path = os.path.join(root, self.FILENAME)
        self._lock = Flock(os.path.join(root, "checkpoint.lock"))
        self._boot_id = boot_id if boot_id is not None \
            else bootid.read_boot_id()
        # The parsed file and the stat signature it was read at.
        self._cp: Checkpoint | None = None
        self._sig: tuple[int, int, int] | None = None
        self.invalidated_on_boot = False
        with self._lock.acquire(timeout=LOCK_TIMEOUT_S):
            cp = self._read_locked()
            if cp.node_boot_id and self._boot_id \
                    and cp.node_boot_id != self._boot_id:
                logger.warning(
                    "node boot ID changed (%s -> %s): invalidating "
                    "checkpoint with %d claim(s)", cp.node_boot_id,
                    self._boot_id, len(cp.claims))
                self._write_locked(Checkpoint(node_boot_id=self._boot_id))
                self.invalidated_on_boot = True
            elif not cp.node_boot_id:
                cp.node_boot_id = self._boot_id
                self._write_locked(cp)

    @property
    def path(self) -> str:
        return self._path

    def _read_locked(self) -> Checkpoint:
        sig = stat_signature(self._path)
        if self._cp is not None and sig is not None and sig == self._sig:
            return self._cp
        if sig is None:
            cp = Checkpoint()
        else:
            with open(self._path, encoding="utf-8") as f:
                cp = Checkpoint.from_dict(json.load(f))
        self._cp, self._sig = cp, sig
        return cp

    def _write_locked(self, cp: Checkpoint) -> None:
        cp.node_boot_id = cp.node_boot_id or self._boot_id
        write_json_atomic(self._path, cp.to_json())
        self._cp, self._sig = cp, stat_signature(self._path)

    def get(self) -> Checkpoint:
        """A snapshot: a fresh claims mapping over shared, read-only
        claim records."""
        with self._lock.acquire(timeout=LOCK_TIMEOUT_S):
            cp = self._read_locked()
            return Checkpoint(node_boot_id=cp.node_boot_id,
                              claims=dict(cp.claims))

    def update(self, fn, dirty_uids) -> None:
        """Read-modify-write: ``fn(checkpoint)`` mutates a copy in place;
        its state changes, all within ``dirty_uids``, are validated and
        written durably before this returns. Nothing is written when
        ``fn`` or the validation raises."""
        with self._lock.acquire(timeout=LOCK_TIMEOUT_S):
            current = self._read_locked()
            cp = Checkpoint(node_boot_id=current.node_boot_id,
                            claims=dict(current.claims))
            fn(cp)
            TWO_PHASE_POLICY.validate_states(
                {uid: c.state for uid, c in current.claims.items()},
                {uid: c.state for uid, c in cp.claims.items()},
                scope=dirty_uids)
            self._write_locked(cp)

    def update_claim(self, uid: str,
                     claim: CheckpointedClaim | None) -> None:
        """Upsert one claim record, or remove it with None."""
        def fn(cp: Checkpoint) -> None:
            if claim is None:
                cp.claims.pop(uid, None)
            else:
                cp.claims[uid] = claim

        self.update(fn, {uid})
