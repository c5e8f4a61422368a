"""The ComputeDomain plugin's claims (the JAX package's
``computedomain/plugin/device_state.py``; upstream
``cmd/compute-domain-kubelet-plugin/device_state.go``).

The node publishes one ``daemon`` device and ``channel-0`` ..
``channel-127``, each with the node's ``cliqueId`` (nvlib.go:167-194).

A **channel** claim (``ComputeDomainChannelConfig``) joins a workload to
its domain. Its prepare refuses a domain of another namespace and a
channel another claim holds (both for good: ``PermanentError``), labels
the node with the domain's uid (which schedules the domain's daemon
there), and waits for the domain to be Ready with this node registered
(``RetryableError`` until then). Its CDI spec then carries the gang's
env: ``TPU_COORDINATOR_ADDRESS`` (global worker 0's registered address
at the JAX coordinator port, ``JAX_COORDINATOR_PORT`` of the plugin's
env or 8476), ``TPU_PROCESS_ID``, ``TPU_NUM_PROCESSES``,
``TPU_WORKER_HOSTNAMES`` (positional by global process id),
``TPU_DOMAIN_CHANNELS`` and, on a domain of several slices, the slice
ids and the ``MEGASCALE_*`` set; and it mounts the domain's directory
(``<root>/domains/<uid>``, where the daemon writes ``bootstrap.json``
and ``members.json``) read-only at ``DOMAIN_STATE_ROOT``. Process ids
are slice-major: slices in sorted clique order, a node's id its slice's
offset plus its clique index.

A **daemon** claim (``ComputeDomainDaemonConfig``) gives the daemon its
identity env (the domain, the clique, the node, its clique's worker
count) and mounts the same directory read-write.

The prepare is one step (``SINGLE_PHASE_POLICY``): the spec, then the
completed checkpoint record. The spec has only these edits: no device
nodes, no driver libraries and no hooks (``CDIHandler`` adds those only
where the GPU plugin asks), as the JAX plugin's spec has only its env
and mount. The last channel claim's unprepare drops the node label;
``unwind_failed_prepare`` undoes a prepare that never completed, and
drops the label only once the domain is positively gone.

Domains are read through an informer (``pkg/informer.py``) that
``stop()`` ends. The JAX plugin's tracing and flight recorder are not
ported.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading

from ...api.configs import (ComputeDomainChannelConfig,
                            ComputeDomainDaemonConfig)
from ...api.decode import strict_decode
from ...kubeletplugin.cdi import CDIHandler, ContainerEdits
from ...kubeletplugin.checkpoint import (CheckpointedClaim,
                                         CheckpointedDevice,
                                         CheckpointManager, ClaimState)
from ...kubeletplugin.claim import ResourceClaim
from ...pkg.informer import Informer
from ...pkg.kubeclient import KubeError, NotFoundError
from ...pkg.statemachine import SINGLE_PHASE_POLICY
from ...pkg.timing import SegmentTimer
from ...pkg.workqueue import PermanentError
from .. import (API_GROUP, API_VERSION, CDI_CLASS, CDI_VENDOR,
                JAX_COORDINATOR_PORT, MEGASCALE_PORT, NODE_LABEL,
                daemon_dns_name, expected_slices, expected_workers,
                per_slice_workers)

logger = logging.getLogger(__name__)

MAX_CHANNELS = 128
DAEMON_DEVICE = "daemon"
# Where a container sees its domain's directory.
DOMAIN_STATE_ROOT = "/var/run/tpu-domain"


class RetryableError(RuntimeError):
    """The prepare must be tried again (the domain is not Ready yet)."""


class CDDeviceState:
    def __init__(self, root: str, kube, node_name: str,
                 clique_id: str = "0", cdi_root: str | None = None,
                 driver_namespace: str = "tpu-dra-driver",
                 boot_id: str | None = None):
        os.makedirs(root, exist_ok=True)
        self.root = root
        self.kube = kube
        self.node_name = node_name
        self.clique_id = clique_id
        self.ns = driver_namespace
        self.last_segments: dict[str, float] = {}
        self._lock = threading.Lock()
        self._checkpoint = CheckpointManager(
            root, boot_id=boot_id, transition_policy=SINGLE_PHASE_POLICY)
        self._cdi = CDIHandler(cdi_root=cdi_root or os.path.join(root, "cdi"),
                               vendor=CDI_VENDOR, cdi_class=CDI_CLASS)
        # A prepare retries for up to the gang deadline; the cache spares
        # the API server a list each attempt.
        self._cd_informer = Informer(kube, API_GROUP, API_VERSION,
                                     "computedomains").start()

    def stop(self) -> None:
        """End the domain informer's watch and resync."""
        self._cd_informer.stop()

    # -- allocatable devices -----------------------------------------------

    def allocatable_devices(self) -> list[dict]:
        """The daemon device and the channels, each with the node's
        ``cliqueId`` (a selector on it pins claims to one slice)."""
        clique = {"cliqueId": {"string": self.clique_id}}
        devices = [{"name": DAEMON_DEVICE,
                    "attributes": {"type": {"string": "daemon"}, **clique},
                    "capacity": {}}]
        devices += [{"name": f"channel-{i}",
                     "attributes": {"type": {"string": "channel"},
                                    "channel": {"int": i}, **clique},
                     "capacity": {}} for i in range(MAX_CHANNELS)]
        return devices

    # -- prepare -----------------------------------------------------------

    def prepare(self, claim: ResourceClaim) -> list[str]:
        """The claim's qualified CDI device ids."""
        timer = SegmentTimer("cd_prepare", claim.uid)
        try:
            return self._prepare_locked(claim, timer)
        finally:
            timer.done()
            self.last_segments = dict(timer.segments)

    def _prepare_locked(self, claim: ResourceClaim,
                        timer: SegmentTimer) -> list[str]:
        with self._lock:
            with timer.segment("cd_get_checkpoint"):
                existing = self._checkpoint.get().claims.get(claim.uid)
            if existing and \
                    existing.state == ClaimState.PREPARE_COMPLETED.value:
                return [i for d in existing.devices for i in d.cdi_device_ids]
            cfg = self._decode_config(claim)
            if isinstance(cfg, ComputeDomainChannelConfig):
                with timer.segment("cd_prepare_channel"):
                    edits, devices = self._prepare_channel(claim, cfg)
            elif isinstance(cfg, ComputeDomainDaemonConfig):
                with timer.segment("cd_prepare_daemon"):
                    edits, devices = self._prepare_daemon(claim, cfg)
            else:
                raise PermanentError(
                    f"config kind {type(cfg).__name__} not valid for "
                    "compute-domain claims")
            with timer.segment("cd_write_cdi_spec"):
                cdi_ids = self._cdi.create_claim_spec_file(
                    claim.uid, {d: ContainerEdits() for d in devices}, edits)
            record = CheckpointedClaim(
                uid=claim.uid, namespace=claim.namespace, name=claim.name,
                state=ClaimState.PREPARE_COMPLETED.value,
                devices=[CheckpointedDevice(canonical_name=name, kind="cd",
                                            cdi_device_ids=[cid])
                         for name, cid in zip(sorted(devices), cdi_ids)])
            with timer.segment("cd_checkpoint_write"):
                self._checkpoint.update_claim(claim.uid, record)
            return cdi_ids

    def _decode_config(self, claim: ResourceClaim):
        for oc in claim.configs:
            try:
                cfg = strict_decode(oc.parameters)
            except Exception as e:
                raise PermanentError(e) from e
            cfg.normalize()
            cfg.validate()
            return cfg
        raise PermanentError("compute-domain claim carries no opaque config")

    def _get_cd(self, domain_id: str) -> dict:
        cd = self._cd_informer.get_by_uid(domain_id)
        if cd is not None:
            return cd
        raise RetryableError(f"ComputeDomain {domain_id} not found (yet)")

    def _prepare_channel(self, claim: ResourceClaim,
                         cfg: ComputeDomainChannelConfig):
        cd = self._get_cd(cfg.domain_id)
        # A claim joins only a domain of its own namespace
        # (device_state.go:577).
        if cd["metadata"].get("namespace", "default") != claim.namespace:
            raise PermanentError(
                f"ComputeDomain {cd['metadata']['name']} namespace "
                f"{cd['metadata'].get('namespace')!r} does not match claim "
                f"namespace {claim.namespace!r}")
        self._assert_channel_not_allocated(claim)
        self._add_node_label(cfg.domain_id)
        node = self._assert_cd_ready(cd)
        channels = [r.device for r in claim.results]
        # Read at each prepare, as the JAX plugin does.
        port = int(os.environ.get("JAX_COORDINATOR_PORT",
                                  str(JAX_COORDINATOR_PORT)))
        layout = self._slice_layout(cd, node)
        # By address: a workload cannot resolve the daemons' names (they
        # live in the daemons' hosts files); members.json maps them.
        coordinator_host = layout["hostnames"][0]
        env = [
            f"COMPUTE_DOMAIN_UUID={cfg.domain_id}",
            f"TPU_COORDINATOR_ADDRESS={coordinator_host}:{port}",
            f"TPU_PROCESS_ID={layout['process_id']}",
            f"TPU_NUM_PROCESSES={layout['num_processes']}",
            f"TPU_WORKER_HOSTNAMES={','.join(layout['hostnames'])}",
            "TPU_DOMAIN_CHANNELS=" + (
                "all" if cfg.allocation_mode == "All"
                else ",".join(sorted(channels))),
        ]
        if layout["num_slices"] > 1:
            # One gang over every slice; the cross-slice coordinator is
            # global worker 0's host.
            ms_port = int(os.environ.get("MEGASCALE_PORT_OVERRIDE",
                                         str(MEGASCALE_PORT)))
            env += [
                f"TPU_NUM_SLICES={layout['num_slices']}",
                f"TPU_SLICE_ID={layout['slice_id']}",
                f"MEGASCALE_NUM_SLICES={layout['num_slices']}",
                f"MEGASCALE_SLICE_ID={layout['slice_id']}",
                f"MEGASCALE_COORDINATOR_ADDRESS={coordinator_host}:{ms_port}",
                f"MEGASCALE_PORT={ms_port}",
            ]
        edits = ContainerEdits(env=env, mounts=[(
            self.domain_dir(cfg.domain_id), DOMAIN_STATE_ROOT, True)])
        return edits, channels

    def domain_dir(self, domain_id: str) -> str:
        """The host directory of a domain's daemon files."""
        return os.path.join(self.root, "domains", domain_id)

    def _slice_layout(self, cd: dict, node: dict) -> dict:
        """The global, slice-major worker layout. The addresses are
        positional by global process id and as many as the spec's gang,
        whatever subset has registered: a registered node's address, else
        its slot's stable DNS name. PermanentError when numNodes does not
        split over numSlices; RetryableError while the registered cliques
        do not match the slice count."""
        spec = cd.get("spec", {})
        expected = expected_workers(spec)
        num_slices = expected_slices(spec)
        try:
            per_slice = per_slice_workers(spec)
        except ValueError as e:
            raise PermanentError(
                f"ComputeDomain {cd['metadata']['name']}: {e}") from e
        nodes = cd.get("status", {}).get("nodes", [])
        cliques = sorted({n.get("cliqueID", "") or "0" for n in nodes})
        if num_slices > 1 and len(cliques) != num_slices:
            raise RetryableError(
                f"ComputeDomain {cd['metadata']['name']}: {len(cliques)}"
                f" clique(s) registered, want numSlices={num_slices}")
        if num_slices == 1:
            # Several cliques on one slice would give two nodes one
            # process id.
            if len(cliques) > 1:
                raise RetryableError(
                    f"ComputeDomain {cd['metadata']['name']}: numSlices=1"
                    f" but {len(cliques)} cliques registered ({cliques});"
                    " refusing to assign colliding process ids")
            cliques = cliques or ["0"]
            slice_of = dict.fromkeys(cliques, 0)
        else:
            slice_of = {c: i for i, c in enumerate(cliques)}
        by_gid: dict[int, dict] = {}
        for n in nodes:
            idx = n.get("index", -1)
            si = slice_of.get(n.get("cliqueID", "") or "0")
            if idx is None or idx < 0 or idx >= per_slice or si is None:
                continue
            by_gid[si * per_slice + idx] = n
        hostnames = []
        for gid in range(expected):
            entry = by_gid.get(gid)
            if entry and entry.get("ipAddress"):
                hostnames.append(entry["ipAddress"])
            else:
                si, idx = divmod(gid, per_slice)
                clique = cliques[si] if si < len(cliques) else str(si)
                hostnames.append(daemon_dns_name(idx) if num_slices == 1
                                 else f"{daemon_dns_name(idx)}.{clique}")
        my_slice = slice_of.get(node.get("cliqueID", "") or "0", 0)
        return {"num_processes": expected, "num_slices": num_slices,
                "per_slice": per_slice, "slice_id": my_slice,
                "process_id": my_slice * per_slice + node.get("index", 0),
                "hostnames": hostnames}

    def _assert_cd_ready(self, cd: dict) -> dict:
        """This node's registration, once the domain is Ready with it
        (upstream AssertComputeDomainReady, computedomain.go:238-295)."""
        status = cd.get("status", {})
        node = next((n for n in status.get("nodes", [])
                     if n.get("name") == self.node_name), None)
        if status.get("status") != "Ready" or node is None:
            raise RetryableError(
                f"ComputeDomain {cd['metadata']['name']} not ready on "
                f"{self.node_name} (status={status.get('status')})")
        return node

    def _assert_channel_not_allocated(self, claim: ResourceClaim) -> None:
        """No other claim of the checkpoint holds these channels
        (device_state.go:729)."""
        wanted = {r.device for r in claim.results}
        for other in self._checkpoint.get().claims.values():
            if other.uid == claim.uid:
                continue
            both = wanted & {d.canonical_name for d in other.devices}
            if both:
                raise PermanentError(
                    f"channel(s) {sorted(both)} already allocated to "
                    f"claim {other.uid}")

    def _add_node_label(self, cd_uid: str) -> None:
        """The label that schedules the domain's daemon on this node."""
        try:
            self.kube.patch("", "v1", "nodes", self.node_name,
                            {"metadata": {"labels": {NODE_LABEL: cd_uid}}})
        except NotFoundError:
            logger.warning("node %s not found for labeling", self.node_name)

    def _prepare_daemon(self, claim: ResourceClaim,
                        cfg: ComputeDomainDaemonConfig):
        cd = self._get_cd(cfg.domain_id)
        domain_dir = self.domain_dir(cfg.domain_id)
        os.makedirs(domain_dir, exist_ok=True)
        # The daemon's quorum is its clique's: a domain of several slices
        # gives each daemon numNodes / numSlices.
        try:
            expected = per_slice_workers(cd.get("spec", {}))
        except ValueError as e:
            raise PermanentError(
                f"ComputeDomain {cd['metadata']['name']}: {e}") from e
        namespace = cd["metadata"].get("namespace", "default")
        edits = ContainerEdits(
            env=[f"COMPUTE_DOMAIN_UUID={cfg.domain_id}",
                 f"COMPUTE_DOMAIN_NAME={cd['metadata']['name']}",
                 f"COMPUTE_DOMAIN_NAMESPACE={namespace}",
                 f"CLIQUE_ID={self.clique_id}",
                 f"NODE_NAME={self.node_name}",
                 f"COMPUTE_DOMAIN_NUM_WORKERS={expected}",
                 f"DOMAIN_STATE_DIR={DOMAIN_STATE_ROOT}"],
            mounts=[(domain_dir, DOMAIN_STATE_ROOT, False)])
        return edits, [DAEMON_DEVICE]

    # -- unprepare ---------------------------------------------------------

    def unprepare(self, claim_uid: str) -> None:
        """Remove the spec and the record; the last channel claim drops
        the node label. A spec without a record (a prepare that stopped
        between its two writes) is removed too."""
        with self._lock:
            had = claim_uid in self._checkpoint.get().claims
            self._cdi.delete_claim_spec_file(claim_uid)
            if not had:
                return
            self._checkpoint.update_claim(claim_uid, None)
            self._drop_node_label_if_unused()

    def unwind_failed_prepare(self, claim_uid: str) -> None:
        """Undo what a prepare that never completed left: its spec, a
        record, and the node label once its domain is positively gone.
        While the domain exists the label stays: it schedules the daemon
        that the next try needs. A completed record is never unwound: a
        prepare won the race, and only ``unprepare`` tears it down."""
        with self._lock:
            existing = self._checkpoint.get().claims.get(claim_uid)
            if existing is not None and \
                    existing.state == ClaimState.PREPARE_COMPLETED.value:
                logger.warning("unwind requested for COMPLETED claim %s; "
                               "refusing (a live prepare owns this state)",
                               claim_uid)
                return
            self._cdi.delete_claim_spec_file(claim_uid)
            if existing is not None:
                self._checkpoint.update_claim(claim_uid, None)
        # The API reads run outside the lock; the final check and drop
        # take it again, so a prepare that set the label for a live
        # domain meanwhile vetoes the drop.
        try:
            node = self.kube.get("", "v1", "nodes", self.node_name)
            labeled_cd = node.get("metadata", {}).get("labels", {}).get(
                NODE_LABEL)
        except (KubeError, OSError):
            return
        if labeled_cd and self._cd_definitely_gone(labeled_cd):
            with self._lock:
                try:
                    node = self.kube.get("", "v1", "nodes", self.node_name)
                except (KubeError, OSError):
                    return
                if node.get("metadata", {}).get("labels", {}).get(
                        NODE_LABEL) == labeled_cd:
                    self._drop_node_label_if_unused()

    def _cd_definitely_gone(self, cd_uid: str) -> bool:
        """A list of the domains that succeeded and lacks the uid. An
        informer miss is no such evidence; an API error reads as
        "unknown", and the label stays."""
        try:
            return not any(
                cd["metadata"].get("uid") == cd_uid
                for cd in self.kube.list(API_GROUP, API_VERSION,
                                         "computedomains"))
        except (KubeError, OSError):
            return False

    def _drop_node_label_if_unused(self) -> None:
        """Drop the label when no record holds a channel (the caller
        holds the lock)."""
        if not any(d.canonical_name.startswith("channel-")
                   for c in self._checkpoint.get().claims.values()
                   for d in c.devices):
            try:
                self.kube.patch("", "v1", "nodes", self.node_name,
                                {"metadata": {"labels": {NODE_LABEL: None}}})
            except NotFoundError:
                pass

    def prepared_claims(self):
        return self._checkpoint.get().claims

    # -- stale domain dirs -------------------------------------------------

    def cleanup_stale_domain_dirs(self) -> list[str]:
        """Remove ``domains/<uid>`` whose domain is gone (upstream
        computedomain.go:384); the uids removed."""
        domains_root = os.path.join(self.root, "domains")
        if not os.path.isdir(domains_root):
            return []
        # The dirs first, then the live set: a dir is made only for a
        # domain that exists, so the other order could remove the dir of
        # a domain made between the two reads.
        dirs = os.listdir(domains_root)
        live = {cd["metadata"].get("uid") for cd in self.kube.list(
            API_GROUP, API_VERSION, "computedomains")}
        removed = []
        for uid in dirs:
            if uid in live:
                continue
            path = os.path.join(domains_root, uid)
            try:
                shutil.rmtree(path)
            except OSError:
                logger.exception("removing stale domain dir %s failed", path)
                continue
            removed.append(uid)
        if removed:
            logger.warning("removed stale domain dir(s): %s", removed)
        return removed
